"""Green's functions: batched GF-Lanczos, pole/weight spectra, self-energy.

JAX re-implementation of /root/reference/ED_GF_NORMAL.f90 +
ED_GREENS_FUNCTIONS.f90 + ED_GF_SHARED.f90.  Physics is identical (continued
fraction via Lanczos tridiagonalisation in the particle-added/removed sector,
2-channel symmetric or 4-channel general off-diagonal combination, Boltzmann
weights); the execution model is redesigned for the hardware:

* the base excitations ``c^+_a|psi>`` / ``c_a|psi>`` are built ONCE per
  (state, spin) as vectorised index-gathers (the reference rebuilds every
  mixed injection with explicit loops, ED_GF_NORMAL.f90:174-199,584-660);
  all pair combinations are linear combinations of the base vectors;
* every injection that targets the same (N_up, N_dw) sector runs in ONE
  batched Lanczos (ops/lanczos.lanczos_tridiag_batched): the H·v kernel
  becomes an SpMM with n_injections columns — GEMM-friendly — and H is
  built once per target sector per state (the reference rebuilds H per
  injection, ED_GF_NORMAL.f90:208,275);
* pole/weight accumulation into G(z) over the full frequency grids is one
  batched device contraction instead of the reference's Lmats+Lreal serial
  loop (ED_GF_NORMAL.f90:958-974);
* Sigma = G0^{-1} - G^{-1} uses batched matrix inversion over all
  frequencies at once (ED_GF_NORMAL.f90:987-1029 inverts serially).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .bath import BathBasis, DmftBath, basis_lso_of, invg0_bath_lso
from .config import EDConfig
from .diag import DiagState
from .ops import lanczos, sector_ham, spmv
from .utils import fock
from .utils.reshape import lso2nnn, nnn2lso


# ---------------------------------------------------------------------------
# frequency grids (allocate_grids, ED_GF_SHARED.f90:43-55)
# ---------------------------------------------------------------------------

def matsubara_grid(cfg: EDConfig) -> np.ndarray:
    return np.pi / cfg.beta * (2 * np.arange(cfg.lmats) + 1)


def realaxis_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(cfg.wini, cfg.wfin, cfg.lreal)


def tau_grid(cfg: EDConfig) -> np.ndarray:
    return np.linspace(0.0, cfg.beta, cfg.ltau)


# ---------------------------------------------------------------------------
# GFmatrix: pole/weight spectrum store (GFmatrix type, ED_VARS_GLOBAL.f90:76-100)
# ---------------------------------------------------------------------------

@dataclass
class GFChannel:
    poles: np.ndarray      # [Nexc] real
    weights: np.ndarray    # [Nexc] complex


class GFSpectrum:
    """impGmatrix equivalent: per component (ilat,jlat,ispin,iorb,jorb) a
    list over states of lists of channels.

    ``symmetric`` records which off-diagonal scheme built this spectrum
    (2-channel symmetric vs 4-channel); None means "use the config flag".
    It is persisted so a spectrum built with the auto-detected symmetric
    scheme recombines correctly in later evaluations (gf_cluster,
    custom observables)."""

    def __init__(self):
        self.data: Dict[Tuple[int, int, int, int, int],
                        List[List[GFChannel]]] = {}
        self.symmetric: bool | None = None

    def add_channel(self, key, istate: int, chan: GFChannel):
        comp = self.data.setdefault(key, [])
        while len(comp) <= istate:
            comp.append([])
        comp[istate].append(chan)

    def flat(self, key):
        """Concatenated (poles, weights) over all states/channels."""
        poles, weights = [], []
        for st in self.data.get(key, []):
            for ch in st:
                if len(ch.poles):
                    poles.append(ch.poles)
                    weights.append(ch.weights)
        if not poles:
            return np.zeros(0), np.zeros(0, np.complex128)
        return np.concatenate(poles), np.concatenate(weights)

    def evaluate(self, key, z: np.ndarray) -> np.ndarray:
        """G(z) = sum_k w_k / (z - p_k) (ed_gf_cluster rebuild,
        ED_IO/gf_cluster.f90:1-88).  Host numpy: the pole sums are tiny."""
        p, w = self.flat(key)
        if len(p) == 0:
            return np.zeros(len(z), np.complex128)
        zz = np.asarray(z)[:, None]
        return np.sum(w[None, :] / (zz - p[None, :]), axis=1)

    def evaluate_tau(self, key, tau: np.ndarray, beta: float) -> np.ndarray:
        """Imaginary-time G(tau), 0 <= tau <= beta, from the Lehmann poles:
        G(tau) = -sum_k w_k e^{-tau p_k} / (1 + e^{-beta p_k}),
        evaluated in the overflow-safe branch per pole sign."""
        p, w = self.flat(key)
        if len(p) == 0:
            return np.zeros(len(tau))
        tau = np.asarray(tau)[:, None]
        pp = p[None, :]
        pos = pp >= 0
        val = np.where(
            pos,
            np.exp(-tau * np.where(pos, pp, 0.0))
            / (1.0 + np.exp(-beta * np.where(pos, pp, 0.0))),
            np.exp((beta - tau) * np.where(pos, 0.0, pp))
            / (np.exp(beta * np.where(pos, 0.0, pp)) + 1.0))
        return -(val * w[None, :].real).sum(axis=1)


# ---------------------------------------------------------------------------
# excitation injections (vectorised; ED_GF_NORMAL.f90:174-199 redesigned)
# ---------------------------------------------------------------------------

def _apply_up(v2d: np.ndarray, tgt: np.ndarray, sgn: np.ndarray,
              jdim_up: int) -> np.ndarray:
    """(op acting on the up factor): out[idw, tgt[iup]] = sgn*v[idw, iup]."""
    out = np.zeros((v2d.shape[0], jdim_up), dtype=v2d.dtype)
    sel = tgt >= 0
    out[:, tgt[sel]] = v2d[:, sel] * sgn[sel]
    return out


def _apply_dw(v2d: np.ndarray, tgt: np.ndarray, sgn: np.ndarray,
              jdim_dw: int) -> np.ndarray:
    """(op acting on the dw factor): out[tgt[idw], iup] = sgn*v[idw, iup]."""
    out = np.zeros((jdim_dw, v2d.shape[1]), dtype=v2d.dtype)
    sel = tgt >= 0
    out[tgt[sel], :] = v2d[sel, :] * sgn[sel][:, None]
    return out


def base_excitations(cfg: EDConfig, v2d, nup: int, ndw: int,
                     ispin: int, create: bool):
    """All impurity-level excitations O_a|psi>, a=0..Nimp-1, as flattened
    vectors in the target sector; returns (vectors [Nimp, jdim] or None,
    (jnup, jndw)).  A DEVICE-resident ``v2d`` (large sectors) is excited
    on device via index scatters — no host round-trip of the state."""
    ns, nimp = cfg.ns, cfg.nimp
    dn = 1 if create else -1
    if ispin == 0:
        jnup, jndw = nup + dn, ndw
    else:
        jnup, jndw = nup, ndw + dn
    if not (0 <= jnup <= ns and 0 <= jndw <= ns):
        return None, (jnup, jndw)
    src_up = fock.sector_states(ns, nup)
    src_dw = fock.sector_states(ns, ndw)
    tgt_up = fock.sector_states(ns, jnup)
    tgt_dw = fock.sector_states(ns, jndw)
    import jax
    from .eigenspace import SplitVector
    if isinstance(v2d, (jax.Array, SplitVector)):
        planes = ((v2d,) if isinstance(v2d, jax.Array)
                  else (v2d.re, v2d.im))
        outs = [[] for _ in planes]
        for a in range(nimp):
            if ispin == 0:
                tgt, sgn = fock.op_map(src_up, tgt_up, a, create)
                sel = np.nonzero(tgt >= 0)[0]
                for p, pl in enumerate(planes):
                    o = jnp.zeros((pl.shape[0], len(tgt_up)), pl.dtype)
                    o = o.at[:, tgt[sel]].set(
                        pl[:, sel] * jnp.asarray(sgn[sel], pl.dtype))
                    outs[p].append(o.reshape(-1))
            else:
                tgt, sgn = fock.op_map(src_dw, tgt_dw, a, create)
                sel = np.nonzero(tgt >= 0)[0]
                for p, pl in enumerate(planes):
                    o = jnp.zeros((len(tgt_dw), pl.shape[1]), pl.dtype)
                    o = o.at[tgt[sel], :].set(
                        pl[sel, :]
                        * jnp.asarray(sgn[sel], pl.dtype)[:, None])
                    outs[p].append(o.reshape(-1))
        if isinstance(v2d, jax.Array):
            return jnp.stack(outs[0]), (jnup, jndw)
        return (SplitVector(jnp.stack(outs[0]), jnp.stack(outs[1])),
                (jnup, jndw))
    out = np.zeros((nimp, len(tgt_dw) * len(tgt_up)), dtype=v2d.dtype)
    for a in range(nimp):
        if ispin == 0:
            tgt, sgn = fock.op_map(src_up, tgt_up, a, create)
            out[a] = _apply_up(v2d, tgt, sgn, len(tgt_up)).ravel()
        else:
            tgt, sgn = fock.op_map(src_dw, tgt_dw, a, create)
            out[a] = _apply_dw(v2d, tgt, sgn, len(tgt_dw)).ravel()
    return out, (jnup, jndw)


# ---------------------------------------------------------------------------
# pole/weight extraction (add_to_lanczos_gf_normal, ED_GF_NORMAL.f90:915-975)
# ---------------------------------------------------------------------------

def _chain_to_poles(alphas: np.ndarray, betas: np.ndarray, norm0: float,
                    vfac: complex, ei: float, egs: float, isign: int,
                    cfg: EDConfig, zeta: float,
                    beta_floor: float = 1e-16) -> GFChannel:
    """One Lanczos chain -> (poles, weights).  ``vfac`` is the channel
    prefactor (1 or -i); total weight prefactor = vfac*norm0^2*wBoltz/Z.

    ``beta_floor`` is the invariant-subspace truncation threshold relative
    to the chain scale; it must track the tridiagonalisation dtype: an f32
    chain breaks down at beta ~ eps(f32)*scale ~ 1e-7, so the f64-calibrated
    1e-16 would never truncate and the chain would continue on rounding
    noise, producing ghost poles (ADVICE round 1)."""
    if norm0 == 0.0:
        return GFChannel(np.zeros(0), np.zeros(0, np.complex128))
    # truncate at first vanishing beta (invariant subspace)
    m = len(alphas)
    scale = max(1.0, float(np.abs(alphas).max(initial=1.0)))
    for j in range(len(betas)):
        if betas[j] < beta_floor * scale:
            m = j + 1
            break
    theta, z0 = lanczos.tridiag_eigh(alphas[:m], betas[:m - 1])
    if cfg.finite_temp:
        arg = cfg.beta * (ei - egs)
        pesobz = vfac * norm0 ** 2 * (np.exp(-arg) if arg < 200 else 0.0) / zeta
    else:
        pesobz = vfac * norm0 ** 2 / zeta
    de = theta - ei
    return GFChannel(poles=isign * de,
                     weights=pesobz * (z0 * z0.conj() if np.iscomplexobj(z0)
                                       else z0 ** 2))


# ---------------------------------------------------------------------------
# main GF build
# ---------------------------------------------------------------------------

@dataclass
class GFResult:
    spectrum: GFSpectrum
    # arrays shaped [Nlat,Nlat,Nspin,Nspin,Norb,Norb,L]
    gmats: np.ndarray
    greal: np.ndarray
    smats: np.ndarray
    sreal: np.ndarray
    g0mats: np.ndarray
    g0real: np.ndarray
    max_exc: float
    wm: np.ndarray
    wr: np.ndarray


SectorBuilder = Callable[[int, int], sector_ham.SectorOperator]


def build_gf_normal(cfg: EDConfig, state: DiagState, build: SectorBuilder,
                    log=lambda s: None,
                    force_symmetric: bool = False
                    ) -> Tuple[GFSpectrum, float]:
    """Fill the pole/weight spectrum for all (site,orb,spin) components
    (build_gf_normal, ED_GF_NORMAL.f90:38-104).

    ``force_symmetric`` selects the 2-channel scheme regardless of
    ``cfg.ed_gf_symmetric`` — used when the problem is detected real
    (real H, real eigenvectors ⇒ G_ij = G_ji exactly), where the
    4-channel mixed injections are redundant work: half the injections
    AND every injection real (one-plane kernel)."""
    ns, nimp, norb = cfg.ns, cfg.nimp, cfg.norb
    spec = GFSpectrum()
    egs = state.state_list.emin
    zeta = state.zeta_function
    max_exc = -np.inf
    chan4 = not (cfg.ed_gf_symmetric or force_symmetric)
    spec.symmetric = not chan4

    # device operator cache per target sector within this build
    op_cache: Dict[Tuple[int, int], object] = {}
    use_split = spmv.use_split_backend()
    # opt-in single-precision GF tridiagonalisation (ed_gf_precision):
    # alpha/beta at f32 give ~1e-6-relative GF accuracy at a higher
    # matvec throughput; pole weights and the continued-fraction
    # evaluation stay f64
    import jax.numpy as _jnp
    gf_single = cfg.ed_gf_precision == "single"
    gf_dtype = _jnp.float32 if gf_single else _jnp.float64
    # invariant-subspace truncation must track the chain dtype (ADVICE r1)
    beta_floor = 1e-6 if gf_single else 1e-16
    if gf_single and not use_split:
        log("gf: ed_gf_precision='single' only affects the split "
            "dense-factor backend; this backend runs f64 (knob ignored)")

    def matvec_for(jnup, jndw, want_real=False):
        """Device kernel kit for the target sector.  ``want_real`` selects
        the one-plane kernel for real injections on a real H (3x fewer
        matmuls); returns None if that sector is not real.  Kits are built
        lazily and cached per (sector, kind).  Split kits carry the
        operator as a pytree (passed as an argument to the jitted
        tridiagonalisation, so the compiled kernel is shared across
        sectors and bath updates) and are returned as
        ``(apply_fn, dev, dim_p, embed, extract)``; factors beyond
        DENSE_FACTOR_MAX dispatch to the block-sparse large-sector
        kernels (ops/large.py) instead of the legacy gather closure."""
        key = (jnup, jndw, bool(want_real) and use_split)
        if key not in op_cache:
            if use_split:
                from .ops import large as large_mod
                from .ops import split as split_mod
                op = build(jnup, jndw)
                is_large = max(op.dim_up, op.dim_dw) \
                    > split_mod.DENSE_FACTOR_MAX
                # mesh routing: large sectors run the GF matvec sharded
                # over the solver mesh (same all-to-all transpose kernel
                # as the diagonalization; the reference reuses its MPI
                # matvec here, ED_GF_NORMAL.f90:208-215 — for complex
                # sectors identically, ED_HAMILTONIAN_SPARSE_HxV.f90:
                # 230-315).  Injection batches are FOLDED into the SpMM
                # minor axis of the sharded kernel (one wide SpMM per
                # side per shard), matching the single-chip batched path.
                if is_large:
                    from .parallel import multichip
                    mesh = multichip.get_solver_mesh()
                    if mesh is not None and "dw" in mesh.shape:
                        from .parallel import sharded_large as sl
                        dim_ = op.dim_dw * op.dim_up
                        ident = lambda v: v   # noqa: E731
                        if key[2]:
                            # real injections on a real H: one-plane
                            # sharded kernel (only reachable when the
                            # sector is real — key[2] implies want_real)
                            if split_mod.op_is_real(op):
                                op_sh = sl.build_sharded_large_real(
                                    op, mesh, dtype=gf_dtype)
                                op_cache[key] = (
                                    sl.apply_sharded_large_real_flat_batched,
                                    op_sh, dim_, ident, ident, True)
                            else:
                                op_cache[key] = None
                        elif split_mod.op_is_real(op):
                            # complex injections, real H: planes never mix
                            op_sh = sl.build_sharded_large_real(
                                op, mesh, dtype=gf_dtype)
                            op_cache[key] = (
                                sl.apply_sharded_large_realpair_flat_batched,
                                op_sh, dim_, ident, ident, True)
                        else:
                            # complex H: sharded Karatsuba pair kernel
                            op_sh = sl.build_sharded_large_pair(
                                op, mesh, dtype=gf_dtype)
                            op_cache[key] = (
                                sl.apply_sharded_large_pair_flat_batched,
                                op_sh, dim_, ident, ident, True)
                        return op_cache[key]
                if key[2]:
                    if is_large:
                        # hierarchical kit first (pure one-body
                        # factors), tile kit otherwise
                        from .ops import hier_dev as hier_mod
                        kit = hier_mod.build_real_padded_hier(
                            op, dtype=gf_dtype)
                        apply_fn = \
                            hier_mod.apply_hier_real_flat_batched
                        if kit is None:
                            kit = large_mod.build_real_padded_large(
                                op, dtype=gf_dtype)
                            apply_fn = \
                                large_mod.apply_large_real_flat_batched
                    else:
                        kit = split_mod.build_real_padded(
                            op, dtype=gf_dtype)
                        apply_fn = split_mod.apply_real_flat
                    if kit is None:
                        op_cache[key] = None
                    else:
                        # large appliers are pre-batched (batch folded
                        # into the SpMM width)
                        op_cache[key] = (apply_fn,) + kit + (is_large,)
                else:
                    if is_large:
                        from .ops import hier_dev as hier_mod
                        pk = hier_mod.build_pair_padded_hier(
                            op, dtype=gf_dtype)
                        if pk is not None:
                            dev, realf, dim_p, embed, extract = pk
                            apply_fn = (
                                hier_mod.apply_hier_realpair_flat_batched
                                if realf
                                else hier_mod.apply_hier_pair_flat_batched)
                        else:
                            dev, realf, dim_p, embed, extract = \
                                large_mod.build_pair_padded_large(
                                    op, dtype=gf_dtype)
                            apply_fn = (
                                large_mod
                                .apply_large_realpair_flat_batched
                                if realf
                                else large_mod
                                .apply_large_pair_flat_batched)
                    else:
                        dev, realf, dim_p, embed, extract = \
                            split_mod.build_pair_padded(op,
                                                        dtype=gf_dtype)
                        apply_fn = (split_mod.apply_realpair_flat if realf
                                    else split_mod.apply_pair_flat)
                    op_cache[key] = (apply_fn, dev, dim_p, embed, extract,
                                     is_large)
            else:
                dev = spmv.to_device(build(jnup, jndw))
                op_cache[key] = spmv.make_matvec(dev)
        return op_cache[key]

    # --- assemble ALL injection batches, grouped by target sector --------
    # The reference runs one Lanczos per injection per state, rebuilding H
    # each time (ED_GF_NORMAL.f90:208).  Round 1 batched all injections of
    # one (state, spin, create); this batches across STATES too: every
    # injection that targets the same (jnup, jndw) sector — from any
    # retained state — runs in ONE batched tridiagonalisation, so the H·v
    # is an SpMM whose width is the TOTAL injection count for that sector
    # (round-1 VERDICT item 3).
    jobs: Dict[Tuple[int, int, bool], list] = {}
    for istate, st in enumerate(state.state_list):
        isector = st.isector
        nup, ndw = fock.get_quantum_numbers(isector, ns)
        ei = st.energy
        vec = st.get_vector(ns)
        dim_up = len(fock.sector_states(ns, nup))
        dim_dw = len(fock.sector_states(ns, ndw))
        from .eigenspace import SplitVector, vector_to_host
        if isinstance(vec, SplitVector):
            # device-resident split-pair state (complex-H large sector):
            # excitations AND the 4-channel complex combinations are
            # built on device, plane-wise
            v2d = SplitVector(vec.re.reshape(dim_dw, dim_up),
                              vec.im.reshape(dim_dw, dim_up))
        elif isinstance(vec, jax.Array) and not chan4:
            # device-resident large-sector state: excitations built on
            # device (complex combos of a REAL state would need a pair;
            # real problems auto-select 2-channel, see
            # build_gf_and_sigma)
            v2d = vec.reshape(dim_dw, dim_up)
        else:
            v2d = vector_to_host(vec).reshape(dim_dw, dim_up)

        for ispin in range(cfg.nspin):
            for create in (True, False):
                base, (jnup, jndw) = base_excitations(
                    cfg, v2d, nup, ndw, ispin, create)
                if base is None:
                    continue
                isign = +1 if create else -1
                # injection batch: Nimp diagonal vectors + pair
                # combinations (a+b) and optionally (a ± i b)
                vecs = [base[a] for a in range(nimp)]
                meta = [((a, a), 1.0 + 0j, istate, ei, isign, ispin)
                        for a in range(nimp)]
                for a in range(nimp):
                    for b in range(nimp):
                        if a == b:
                            continue
                        vecs.append(base[a] + base[b])
                        meta.append(((a, b), 1.0 + 0j, istate, ei, isign,
                                     ispin))
                        if chan4:
                            # reference: add c^+_a + i c^+_b ;
                            # del c_a - i c_b (ED_GF_NORMAL.f90:584-660)
                            ph = 1j if create else -1j
                            vecs.append(base[a] + ph * base[b])
                            meta.append(((a, b), -1j, istate, ei, isign,
                                         ispin))
                if isinstance(base, SplitVector):
                    stacked = SplitVector(
                        jnp.stack([v.re for v in vecs]),
                        jnp.stack([v.im for v in vecs]))
                    is_real = False
                elif isinstance(base, jax.Array):
                    stacked = jnp.stack(vecs)
                    is_real = not jnp.iscomplexobj(stacked)
                else:
                    stacked = np.stack(vecs)
                    is_real = not np.abs(stacked.imag).max() > 0.0
                jobs.setdefault((jnup, jndw, is_real), []).append(
                    (stacked, meta))

    # --- run one batched tridiagonalisation per target-sector group ------
    from .eigenspace import SplitVector as _SV
    for (jnup, jndw, is_real), entries in jobs.items():
        if any(isinstance(e[0], _SV) for e in entries):
            # split-pair device batch; host complex stacks in the same
            # group ride along as device planes
            def planes_of(x):
                if isinstance(x, _SV):
                    return x.re, x.im
                a = np.asarray(x)
                return (jnp.asarray(np.ascontiguousarray(a.real)),
                        jnp.asarray(np.ascontiguousarray(a.imag)))
            pl = [planes_of(e[0]) for e in entries]
            batch = _SV(jnp.concatenate([p[0] for p in pl]),
                        jnp.concatenate([p[1] for p in pl]))
        else:
            on_dev = all(isinstance(e[0], jax.Array) for e in entries)
            cat = jnp.concatenate if on_dev else np.concatenate
            batch = cat([e[0] for e in entries])
        meta = [m for e in entries for m in e[1]]
        # chunk so the Krylov working set stays bounded (large sectors:
        # 3 live planes per row of the batch)
        jdim = batch.shape[1]
        planes = 1 if (is_real and use_split) else 2
        from .utils.membudget import budget_bytes
        rows_max = max(nimp, int(
            budget_bytes(0.25,
                         log=(log if cfg.ed_verbose >= 3 else None),
                         what="gf-injection-batch")
            / max(jdim * 8 * 3 * planes, 1)))
        nlanc = min(jdim, cfg.lanc_ngfiter)
        for lo in range(0, len(meta), rows_max):
            sub = batch[lo:lo + rows_max]
            sub_meta = meta[lo:lo + rows_max]
            chain_floor = beta_floor
            if use_split:
                real_kit = (matvec_for(jnup, jndw, want_real=True)
                            if is_real else None)
                if real_kit is not None:
                    app, dev, dim_p, embed, extract, blarge = real_kit
                    alphas, betas, norms = \
                        lanczos.lanczos_tridiag_batched_real(
                            app, embed(sub.real), nlanc, op=dev,
                            dtype=gf_dtype, op_batched=blarge)
                else:
                    app, dev, dim_p, embed, extract, blarge = \
                        matvec_for(jnup, jndw)
                    sub_e = ((embed(sub.re), embed(sub.im))
                             if isinstance(sub, _SV) else embed(sub))
                    alphas, betas, norms = \
                        lanczos.lanczos_tridiag_batched_split(
                            app, sub_e, nlanc, op=dev,
                            dtype=gf_dtype, op_batched=blarge)
            else:
                mv = matvec_for(jnup, jndw)
                sub_h = sub.to_host() if isinstance(sub, _SV) else sub
                alphas, betas, norms = lanczos.lanczos_tridiag_batched(
                    mv, jnp.asarray(sub_h), nlanc)
                chain_floor = 1e-16
            for k, ((a, b), vfac, istate, ei, isign, ispin) in \
                    enumerate(sub_meta):
                ch = _chain_to_poles(alphas[k], betas[k],
                                     float(norms[k]), vfac, ei, egs,
                                     isign, cfg, zeta,
                                     beta_floor=chain_floor)
                if len(ch.poles):
                    d = ch.poles * isign   # = de >= 0 excitation energies
                    max_exc = max(max_exc, float(d.max()))
                ilat, iorb = divmod(a, norb)
                jlat, jorb = divmod(b, norb)
                spec.add_channel((ilat, jlat, ispin, iorb, jorb),
                                 istate, ch)
        log(f"gf: target sector ({jnup},{jndw}) "
            f"{len(meta)} injections done")
    return spec, max_exc


def evaluate_gf_nnn(spec: GFSpectrum, cfg: EDConfig,
                    z: np.ndarray) -> np.ndarray:
    """Rebuild the full cluster GF at arbitrary complex frequencies from the
    stored pole/weight spectrum, including the off-diagonal recombination
    (ed_gf_cluster, ED_IO/gf_cluster.f90:1-88)."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    out = np.zeros((nlat, nlat, nspin, nspin, norb, norb, len(z)),
                   np.complex128)
    sym = spec.symmetric if getattr(spec, "symmetric", None) is not None \
        else cfg.ed_gf_symmetric
    fac = 1.0 - (0.0 if sym else 1j)
    for ispin in range(nspin):
        for ilat in range(nlat):
            for iorb in range(norb):
                out[ilat, ilat, ispin, ispin, iorb, iorb] = \
                    spec.evaluate((ilat, ilat, ispin, iorb, iorb), z)
        for ilat in range(nlat):
            for jlat in range(nlat):
                for iorb in range(norb):
                    for jorb in range(norb):
                        if ilat == jlat and iorb == jorb:
                            continue
                        g = spec.evaluate((ilat, jlat, ispin, iorb, jorb), z)
                        gii = out[ilat, ilat, ispin, ispin, iorb, iorb]
                        gjj = out[jlat, jlat, ispin, ispin, jorb, jorb]
                        out[ilat, jlat, ispin, ispin, iorb, jorb] = \
                            0.5 * (g - fac * gii - fac * gjj)
    return out


def build_gf_and_sigma(cfg: EDConfig, hb: BathBasis, bath: DmftBath,
                       imp_hloc: np.ndarray, state: DiagState,
                       build: SectorBuilder, log=lambda s: None) -> GFResult:
    """buildgf_impurity equivalent (ED_GREENS_FUNCTIONS.f90:23-56):
    spectrum -> G(iw), G(w) -> off-diagonal recombination -> Sigma."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    wm = matsubara_grid(cfg)
    wr = realaxis_grid(cfg)
    zmats = 1j * wm
    zreal = wr + 1j * cfg.eps

    # Real problem ⇒ G_ij = G_ji exactly: the 4-channel scheme is
    # redundant, so auto-select the 2-channel symmetric path (half the
    # injections, all real → one-plane matmul kernel).  Requires real H
    # (Hloc + bath basis; V, U, Jx/Jp are real by construction) and real
    # retained eigenvectors.
    force_sym = False
    if not cfg.ed_gf_symmetric:
        real_h = (np.abs(np.asarray(imp_hloc).imag).max(initial=0) == 0
                  and np.abs(np.asarray(hb.basis).imag).max(initial=0) == 0)
        if real_h:
            def _vec_is_real(st):
                from .eigenspace import SplitVector
                v = st.get_vector(cfg.ns)
                if isinstance(v, SplitVector):
                    # device reduce of the imaginary plane only
                    return float(jnp.max(jnp.abs(v.im))) == 0.0
                if not np.iscomplexobj(v):   # real dtype: no transfer
                    return True
                return np.abs(np.asarray(v).imag).max(initial=0) == 0
            force_sym = all(_vec_is_real(st) for st in state.state_list)
        if force_sym:
            log("gf: real problem detected -> symmetric 2-channel scheme")

    spec, max_exc = build_gf_normal(cfg, state, build, log,
                                    force_symmetric=force_sym)
    gmats = evaluate_gf_nnn(spec, cfg, zmats)
    greal = evaluate_gf_nnn(spec, cfg, zreal)

    # ---- Sigma = G0^{-1} - G^{-1} (build_sigma_normal) ----
    def to_lso_freq(g):
        # [.,.,.,.,.,.,L] -> [L, Nlso, Nlso]
        return np.moveaxis(nnn2lso(g, nlat, nspin, norb), -1, 0)

    hloc_lso = jnp.asarray(nnn2lso(imp_hloc, nlat, nspin, norb))
    basis_lso = basis_lso_of(cfg, hb)
    v = jnp.asarray(bath.v)
    lam = jnp.asarray(bath.lam)
    invg0_m = invg0_bath_lso(jnp.asarray(zmats), hloc_lso, cfg.xmu, v,
                             lam, basis_lso)
    invg0_r = invg0_bath_lso(jnp.asarray(zreal), hloc_lso, cfg.xmu, v,
                             lam, basis_lso)
    invg_m = jnp.linalg.inv(jnp.asarray(to_lso_freq(gmats)))
    invg_r = jnp.linalg.inv(jnp.asarray(to_lso_freq(greal)))
    smats_lso = np.asarray(invg0_m - invg_m)
    sreal_lso = np.asarray(invg0_r - invg_r)
    g0m_lso = np.asarray(jnp.linalg.inv(invg0_m))
    g0r_lso = np.asarray(jnp.linalg.inv(invg0_r))

    def to_nnn(a_lso_freq):
        return lso2nnn(np.moveaxis(a_lso_freq, 0, -1), nlat, nspin, norb)

    return GFResult(
        spectrum=spec,
        gmats=gmats, greal=greal,
        smats=to_nnn(smats_lso), sreal=to_nnn(sreal_lso),
        g0mats=to_nnn(g0m_lso), g0real=to_nnn(g0r_lso),
        max_exc=max_exc, wm=wm, wr=wr)
