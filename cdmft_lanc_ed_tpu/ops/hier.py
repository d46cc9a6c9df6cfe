"""Hierarchical (A/B-half) Kronecker factorisation of a spin-hop factor.

The block-sparse tile kernel (ops/large.py) pays for the combinadic
ordering's scattered one-hop structure: 128x128 tiles on the Ns=16
factor are 0.45% occupied, so ~99.5% of the matmul work (and the per-tile
x DMA) is padding.  This module factors the SAME one-body operator
exactly, with dense GEMM-sized blocks and occupancy-proportional FLOPs:

split the Ns levels into half A (low ``ha`` bits) and half B; order the
sector states by (nA, rankA, rankB) so each particle-split block is the
full product [C(ha,nA) x C(ns-ha,n-nA)].  A one-body operator then
decomposes EXACTLY into

* A-internal hops:  block-diagonal  H_A^{(nA)} (x) I_B    (dense <=70x70)
* B-internal hops:  block-diagonal  I_A (x) H_B^{(nB)}
* cross hops a in A, b in B:  block-superdiagonal
      (-1)^{nA} . S+_A[a,nA] (x) S-_B[b,nB]   (nA -> nA+1)
  and the adjoint direction for a in B, b in A — the fermionic string
  splits into the in-half parities plus the (-1)^{nA} block scalar
  because every A level lies below every B level.

Applying the factor to the [dim, minor] sector view is then a chain of
SMALL DENSE matmuls over [CA, CB, minor] blocks.  Measured MAC
accounting at the Ns=16 half-filled factor (test_hier_factor.py): the
full dense chain is 21.0M MACs/minor — 1.16x leaner than the 128x128
tile kernel's padded 24.3M, NOT the naive nnz ratio, because the
hybridisation cross hops are permutation-sparse but dense-block in
this algebra.  The production device apply (ops/hier_dev.py) therefore
runs the within-half terms as dense matmuls (0.74M MACs/minor)
and the cross hops as flat signed row gathers over the hier-ordered
vector — occupancy-proportional traffic instead of padded FLOPs.

Reference analog: the stored-CSR factor this re-expresses is
ED_HAMILTONIAN/sparse/H_up.f90 (the reference never exploits the
product structure inside a spin factor).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..utils import fock


@dataclass
class HierFactor:
    """One spin factor in hierarchical block form (host arrays)."""
    ns: int
    n: int
    ha: int
    dim: int
    # block layout: for nA in valid range, states are
    # [offset[nA] : offset[nA] + CA[nA]*CB[nA]] viewed [CA, CB]
    n_a_vals: np.ndarray        # valid nA values (ascending)
    offsets: np.ndarray
    ca: np.ndarray
    cb: np.ndarray
    perm: np.ndarray            # combinadic rank -> hierarchical rank
    ha_ops: list                # per-block [CA, CA] (A-internal, or None)
    hb_ops: list                # per-block [CB, CB] (B-internal, or None)
    # cross transitions nA -> nA+1: list over blocks of lists of
    # (sa [CA', CA], sb [CB', CB], scale) with the (-1)^{nA} folded in
    up_cross: list
    # transitions nA -> nA-1 (adjoint direction, built independently)
    dn_cross: list


def _rank_map(states: np.ndarray):
    return {int(s): i for i, s in enumerate(states)}


def _create_op(states_from: np.ndarray, states_to: np.ndarray, lvl: int):
    """Dense matrix of c^+_lvl between sub-half sectors, with the
    IN-HALF fermionic parity."""
    out = np.zeros((len(states_to), len(states_from)))
    to_rank = _rank_map(states_to)
    for j, s in enumerate(states_from):
        s = int(s)
        if (s >> lvl) & 1:
            continue
        sgn = fock.parity_below(np.array([s], dtype=np.int64), lvl)[0]
        out[to_rank[s | (1 << lvl)], j] = float(sgn)
    return out


def _destroy_op(states_from: np.ndarray, states_to: np.ndarray, lvl: int):
    out = np.zeros((len(states_to), len(states_from)))
    to_rank = _rank_map(states_to)
    for j, s in enumerate(states_from):
        s = int(s)
        if not (s >> lvl) & 1:
            continue
        sgn = fock.parity_below(np.array([s], dtype=np.int64), lvl)[0]
        out[to_rank[s & ~(1 << lvl)], j] = float(sgn)
    return out


def _half_hop_op(states: np.ndarray, a: int, b: int, amp: complex):
    """Dense amp * c^+_a c_b within one half-sector (complex when the
    amplitude is)."""
    dt = np.float64 if abs(complex(amp).imag) < 1e-14 else np.complex128
    out = np.zeros((len(states), len(states)), dt)
    rows, cols, signs = fock.hop_entries(np.asarray(states, np.int64), a, b)
    out[rows, cols] = (amp.real if dt == np.float64 else amp) * signs
    return out


def build_hier_factor(ns: int, n: int,
                      terms: Sequence[Tuple[int, int, complex]],
                      ha: int = None) -> HierFactor:
    """Hierarchical factorisation of sum amp c^+_a c_b on the (ns, n)
    combinadic sector.  ``terms`` as produced by
    sector_ham._one_body_terms (REAL amplitudes for this prototype)."""
    if ha is None:
        ha = ns // 2
    hb = ns - ha
    mask_a = (1 << ha) - 1

    states = np.asarray(fock.sector_states(ns, n), np.int64)
    s_a = states & mask_a
    s_b = states >> ha
    n_a = fock.popcount(s_a).astype(np.int64)

    n_a_vals = np.array(sorted(set(int(x) for x in n_a)))
    states_a = {k: np.asarray(fock.sector_states(ha, k), np.int64)
                for k in range(max(n_a_vals) + 2) if k <= ha}
    states_b = {m: np.asarray(fock.sector_states(hb, m), np.int64)
                for m in range(n + 1) if m <= hb}

    ca = np.array([len(states_a[k]) for k in n_a_vals])
    cb = np.array([len(states_b[n - k]) for k in n_a_vals])
    offsets = np.concatenate([[0], np.cumsum(ca * cb)])[:-1]
    dim = int((ca * cb).sum())
    assert dim == len(states)

    # permutation: combinadic rank -> (nA, rankA, rankB) hierarchical
    # rank, vectorised per nA block
    perm = np.empty(len(states), np.int64)
    for bi, k in enumerate(n_a_vals):
        idx = np.nonzero(n_a == k)[0]
        ra = np.searchsorted(states_a[int(k)], s_a[idx])
        rb = np.searchsorted(states_b[int(n - k)], s_b[idx])
        perm[idx] = offsets[bi] + ra * cb[bi] + rb

    nblk = len(n_a_vals)
    ha_ops = [None] * nblk
    hb_ops = [None] * nblk
    up_cross = [[] for _ in range(nblk)]
    dn_cross = [[] for _ in range(nblk)]

    for (a, b, amp) in terms:
        amp = complex(amp)
        if a < ha and b < ha:
            for bi, k in enumerate(n_a_vals):
                op = _half_hop_op(states_a[k], a, b, amp)
                ha_ops[bi] = op if ha_ops[bi] is None else ha_ops[bi] + op
        elif a >= ha and b >= ha:
            for bi, k in enumerate(n_a_vals):
                m = n - k
                op = _half_hop_op(states_b[m], a - ha, b - ha, amp)
                hb_ops[bi] = op if hb_ops[bi] is None else hb_ops[bi] + op
        elif a < ha:                      # create in A, destroy in B
            for bi, k in enumerate(n_a_vals):
                if bi + 1 >= nblk or n_a_vals[bi + 1] != k + 1:
                    continue
                m = n - k
                if m == 0 or k + 1 > ha:
                    continue
                sa = _create_op(states_a[k], states_a[k + 1], a)
                sb = _destroy_op(states_b[m], states_b[m - 1], b - ha)
                up_cross[bi].append((sa, sb, amp * float((-1) ** k)))
        else:                             # destroy in A, create in B
            for bi, k in enumerate(n_a_vals):
                if bi == 0 or n_a_vals[bi - 1] != k - 1:
                    continue
                m = n - k
                if k == 0 or m + 1 > hb:
                    continue
                sa = _destroy_op(states_a[k], states_a[k - 1], b)
                sb = _create_op(states_b[m], states_b[m + 1], a - ha)
                # c^+_a c_b, a in B, b in A: string = (-1)^{pb_A} from
                # c_b, then (-1)^{(nA-1) + pa_B} from c^+_a on the
                # nA-1-particle A prefix
                dn_cross[bi].append((sa, sb, amp * float((-1) ** (k - 1))))
    return HierFactor(ns=ns, n=n, ha=ha, dim=dim, n_a_vals=n_a_vals,
                      offsets=offsets, ca=ca, cb=cb, perm=perm,
                      ha_ops=ha_ops, hb_ops=hb_ops, up_cross=up_cross,
                      dn_cross=dn_cross)


def matvec_hier_np(f: HierFactor, x: np.ndarray) -> np.ndarray:
    """y = H @ x in HIERARCHICAL ordering (x [dim] or [dim, minor]).
    NumPy reference implementation of the dense block chain."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    minor = x.shape[1]
    dt = x.dtype
    for o in f.ha_ops + f.hb_ops:
        if o is not None:
            dt = np.result_type(dt, o.dtype)
    for lst in list(f.up_cross) + list(f.dn_cross):
        for (_sa, _sb, sc) in lst:
            dt = np.result_type(dt, np.asarray(sc).dtype)
    y = np.zeros(x.shape, dt)

    def blk(i, arr):
        seg = arr[f.offsets[i]: f.offsets[i] + f.ca[i] * f.cb[i]]
        return seg.reshape(f.ca[i], f.cb[i], minor)

    for i in range(len(f.n_a_vals)):
        xb = blk(i, x)
        yb = blk(i, y)
        if f.ha_ops[i] is not None:
            yb += np.einsum("pa,abm->pbm", f.ha_ops[i], xb)
        if f.hb_ops[i] is not None:
            yb += np.einsum("qb,abm->aqm", f.hb_ops[i], xb)
        for (sa, sb, scale) in f.up_cross[i]:
            t = np.einsum("pa,abm->pbm", sa, xb)
            blk(i + 1, y)[...] += scale * np.einsum("qb,pbm->pqm", sb, t)
        for (sa, sb, scale) in f.dn_cross[i]:
            t = np.einsum("pa,abm->pbm", sa, xb)
            blk(i - 1, y)[...] += scale * np.einsum("qb,pbm->pqm", sb, t)
    return y[:, 0] if squeeze else y


def device_blocks(f: HierFactor):
    """Device (jnp) arrays for :func:`matvec_hier_jnp`: per-block dense
    ops + the padded cross lists.  Blocks stay ragged (a list per nA) —
    the chain is a handful of small matmuls, so per-block dispatch is
    fine for the prototype; the round-5 kernel fuses them."""
    import jax.numpy as jnp

    def dev(a):
        return None if a is None else jnp.asarray(a)

    return {
        "ha": [dev(o) for o in f.ha_ops],
        "hb": [dev(o) for o in f.hb_ops],
        "up": [[(dev(sa), dev(sb),
                 float(sc.real) if abs(complex(sc).imag) < 1e-14
                 else complex(sc)) for (sa, sb, sc) in lst]
               for lst in f.up_cross],
        "dn": [[(dev(sa), dev(sb),
                 float(sc.real) if abs(complex(sc).imag) < 1e-14
                 else complex(sc)) for (sa, sb, sc) in lst]
               for lst in f.dn_cross],
    }


def matvec_hier_jnp(f: HierFactor, dev_blocks, x):
    """y = H @ x on device, HIERARCHICAL ordering (x [dim] or
    [dim, minor]); jittable (static block structure, all-dense small
    matmuls — every op is GEMM-shaped when the minor axis is wide)."""
    import jax.numpy as jnp

    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    minor = x.shape[1]
    parts = []
    for i in range(len(f.n_a_vals)):
        seg = jnp.zeros((int(f.ca[i]), int(f.cb[i]), minor), x.dtype)
        parts.append(seg)

    def blk(i):
        lo = int(f.offsets[i])
        return x[lo: lo + int(f.ca[i] * f.cb[i])].reshape(
            int(f.ca[i]), int(f.cb[i]), minor)

    for i in range(len(f.n_a_vals)):
        xb = blk(i)
        if dev_blocks["ha"][i] is not None:
            parts[i] = parts[i] + jnp.einsum(
                "pa,abm->pbm", dev_blocks["ha"][i], xb)
        if dev_blocks["hb"][i] is not None:
            parts[i] = parts[i] + jnp.einsum(
                "qb,abm->aqm", dev_blocks["hb"][i], xb)
        for (sa, sb, sc) in dev_blocks["up"][i]:
            t = jnp.einsum("pa,abm->pbm", sa, xb)
            parts[i + 1] = parts[i + 1] + sc * jnp.einsum(
                "qb,pbm->pqm", sb, t)
        for (sa, sb, sc) in dev_blocks["dn"][i]:
            t = jnp.einsum("pa,abm->pbm", sa, xb)
            parts[i - 1] = parts[i - 1] + sc * jnp.einsum(
                "qb,pbm->pqm", sb, t)
    y = jnp.concatenate([p.reshape(-1, minor) for p in parts], axis=0)
    return y[:, 0] if squeeze else y


def terms_from_ell(states: np.ndarray, ell) -> list:
    """Recover the one-body term list sum amp c^+_a c_b from a stored
    ELL spin factor (inverse of sector_ham._spin_hop_ell): every entry
    of a one-hop factor is amp(a,b) * fermionic sign, and the (a, b)
    pair is identified by the two differing bits.  Returns None when
    the factor is not a pure one-body hop matrix (defensive: the hier
    kit then falls back to the tile kernels)."""
    states = np.asarray(states, np.int64)
    if len(states) == 0 or int(states.max()) == 0:
        return []
    ns = int(states.max()).bit_length()
    k = ell.cols.shape[1]
    rows = np.repeat(np.arange(ell.n, dtype=np.int64), k)
    cols = ell.cols.ravel().astype(np.int64)
    vals = ell.vals.ravel()
    nz = vals != 0
    rows, cols, vals = rows[nz], cols[nz], vals[nz]
    if len(rows) == 0:
        return []
    s_dst, s_src = states[rows], states[cols]
    diff = s_dst ^ s_src
    if (fock.popcount(diff) != 2).any():
        return None
    a_bit = diff & s_dst
    b_bit = diff & s_src
    a_lvl = np.round(np.log2(a_bit.astype(np.float64))).astype(np.int64)
    b_lvl = np.round(np.log2(b_bit.astype(np.float64))).astype(np.int64)
    # sign of c^+_a c_b |s_src>: parity below b in s_src, then parity
    # below a after the b level is emptied (ED_SETUP.f90:807-833)
    s1 = 1 - 2 * (fock.popcount(
        s_src & ((np.int64(1) << b_lvl) - 1)) & 1)
    s_mid = s_src & ~b_bit
    s2 = 1 - 2 * (fock.popcount(
        s_mid & ((np.int64(1) << a_lvl) - 1)) & 1)
    amp = vals / (s1 * s2).astype(np.float64)
    key = a_lvl * ns + b_lvl
    order = np.argsort(key, kind="stable")
    ks, amps = key[order], amp[order]
    uniq, first = np.unique(ks, return_index=True)
    ref = amps[first][np.searchsorted(uniq, ks)]
    if not np.allclose(amps, ref, rtol=1e-10, atol=1e-12):
        return None
    return [(int(u // ns), int(u % ns), complex(a))
            for u, a in zip(uniq, amps[first])]


def flat_cross_maps(f: HierFactor):
    """Cross hops of both directions flattened to signed row maps on the
    HIER-ordered vector: (dst [R], src [R], sgn [R] complex) with
    y[dst] += sgn * x[src] summing every cross term — the
    occupancy-proportional device form (each sa/sb factor is a
    sub-permutation, so the Kronecker product enumerates exactly the
    physical (source, target) state pairs)."""
    dsts, srcs, sgns = [], [], []

    def emit(bi_src, bi_dst, sa, sb, scale):
        p_idx, a_idx = np.nonzero(sa)
        q_idx, b_idx = np.nonzero(sb)
        if len(p_idx) == 0 or len(q_idx) == 0:
            return
        sa_sgn = sa[p_idx, a_idx]
        sb_sgn = sb[q_idx, b_idx]
        cb_s = int(f.cb[bi_src])
        cb_d = int(f.cb[bi_dst])
        off_s = int(f.offsets[bi_src])
        off_d = int(f.offsets[bi_dst])
        dst = (off_d + p_idx[:, None] * cb_d + q_idx[None, :]).ravel()
        src = (off_s + a_idx[:, None] * cb_s + b_idx[None, :]).ravel()
        sg = (scale * sa_sgn[:, None] * sb_sgn[None, :]).ravel()
        dsts.append(dst)
        srcs.append(src)
        sgns.append(sg)

    for i in range(len(f.n_a_vals)):
        for (sa, sb, sc) in f.up_cross[i]:
            emit(i, i + 1, sa, sb, sc)
        for (sa, sb, sc) in f.dn_cross[i]:
            emit(i, i - 1, sa, sb, sc)
    if not dsts:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.complex128)
    dst = np.concatenate(dsts)
    src = np.concatenate(srcs)
    sgn = np.concatenate(sgns).astype(np.complex128)
    order = np.argsort(dst, kind="stable")
    return dst[order], src[order], sgn[order]


def flops_per_minor(f: HierFactor) -> int:
    """MAC count of the dense block chain per minor column — the
    apples-to-apples comparison against the tile kernel's padded
    tiles * B^2 (the headline of this formulation)."""
    total = 0
    for i in range(len(f.n_a_vals)):
        if f.ha_ops[i] is not None:
            total += f.ca[i] * f.ca[i] * f.cb[i]
        if f.hb_ops[i] is not None:
            total += f.cb[i] * f.cb[i] * f.ca[i]
        for (sa, sb, _) in f.up_cross[i]:
            total += sa.shape[0] * sa.shape[1] * f.cb[i] \
                + sb.shape[0] * sb.shape[1] * sa.shape[0]
        for (sa, sb, _) in f.dn_cross[i]:
            total += sa.shape[0] * sa.shape[1] * f.cb[i] \
                + sb.shape[0] * sb.shape[1] * sa.shape[0]
    return int(total)
