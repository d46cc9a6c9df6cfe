"""Device apply for the hierarchical A/B-half factorisation (ops/hier.py).

Production Ns>=16 kernel.  Each spin factor of the sector Hamiltonian
(the stored-CSR pieces of /root/reference/ED_HAMILTONIAN_SPARSE_HxV.f90:
96-110) is applied in the hierarchical (nA, rankA, rankB) ordering as

* within-half hops (cluster hops, near-replica hybridisation): the
  block-diagonal dense [CA,CA]/[CB,CB] chain — matmuls sized by the
  TRUE operator algebra (0.74M MACs/minor at the Ns=16 flagship vs the
  combinadic tile kernel's 24.3M padded MACs, ~60% of its tiles);
* cross hops (impurity <-> far-replica hybridisation): the flat signed
  Kronecker maps concentrate onto FEW dense 128x128 tiles in hier
  ordering (measured Ns=16: 574 tiles at 96 nnz/tile vs 1,483 tiles for
  the full factor), applied with the block-sparse SpMM of
  ops/large.py (a flat gather/scatter form serializes its scatters).

The operator data is small (dense blocks + 574 tiles = ~38 MB f32 per
factor vs 97 MB), and the XLA path's f64 temps shrink with the tile
count — the f64 Rayleigh refine of the Ns=16 flagship runs on this kit.

Layout contract: the sector vector lives in HIER ordering on both axes
for the whole solve, padded to 128-row multiples per axis with the
+1e6-decoupled-diagonal convention of ops/split.py; ``embed``/
``extract`` permute combinadic <-> hier once at the solve boundary.

Complex sector Hamiltonians (BHZ-family large sectors) run as split
re/im planes with the 3-plane Karatsuba product per side, mirroring
ops/large.LargePairOp.  Jx/Jp (nd) terms keep the tile kernels — the
one-body recovery below then returns None and callers fall back.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import hier
from . import large
from .sector_ham import SectorOperator
from .split import op_is_real, _PAD_DIAG

jax.config.update("jax_enable_x64", True)

B = large.B


# ---------------------------------------------------------------------------
# device factor pytree
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class HierFactorDev:
    """One spin factor, one plane: dense within-half blocks + cross-hop
    tiles.  Static block layout in aux (shapes drive the jit cache, so
    same-layout factors share compiled kernels)."""
    ha: tuple            # per-block [CA,CA] arrays (present blocks only)
    hb: tuple            # per-block [CB,CB] arrays (present blocks only)
    rb: jax.Array        # [T] i32 cross tile row-block ids (band-major)
    cb: jax.Array        # [T] i32 cross tile col-block ids
    tiles: jax.Array     # [T, B, B] cross tiles (plane dtype)
    layout: tuple        # STATIC: (ca, cb, offsets, dim, ha_idx, hb_idx)

    def tree_flatten(self):
        return (tuple(self.ha) + tuple(self.hb)
                + (self.rb, self.cb, self.tiles)), self.layout

    @classmethod
    def tree_unflatten(cls, layout, children):
        na = len(layout[4])
        nb = len(layout[5])
        return cls(ha=tuple(children[:na]),
                   hb=tuple(children[na:na + nb]),
                   rb=children[na + nb], cb=children[na + nb + 1],
                   tiles=children[na + nb + 2],
                   layout=layout)


def factor_dev_planes(f: hier.HierFactor, dtype=jnp.float32):
    """(plane_r, plane_i or None, plane_s or None): real factors get one
    plane; complex factors the 3 Karatsuba planes (r, i, r+i) sharing
    the static layout and the cross tile index arrays."""
    dst, src, sgn = hier.flat_cross_maps(f)
    ha_idx = tuple(i for i, o in enumerate(f.ha_ops) if o is not None)
    hb_idx = tuple(i for i, o in enumerate(f.hb_ops) if o is not None)
    layout = (tuple(int(x) for x in f.ca), tuple(int(x) for x in f.cb),
              tuple(int(x) for x in f.offsets), int(f.dim),
              ha_idx, hb_idx)
    ha = [f.ha_ops[i] for i in ha_idx]
    hb = [f.hb_ops[i] for i in hb_idx]
    is_real = (all(not np.iscomplexobj(o) or np.abs(o.imag).max() < 1e-14
                   for o in ha + hb)
               and (len(sgn) == 0 or np.abs(sgn.imag).max() < 1e-14))
    # within-half blocks stay f32 even for a bf16 build (tiny, and they
    # carry the cluster energy scale); tiles take the requested dtype
    bdt = jnp.float32 if dtype == jnp.bfloat16 else dtype
    fd = large.block_factor_of_coo(
        _hier_pad(f.dim), dst, src, sgn if not is_real else sgn.real,
        real=is_real, dtype=np.float64 if dtype == jnp.float64
        else np.float32)

    def plane(sel, tiles):
        return HierFactorDev(
            ha=tuple(jnp.asarray(sel(o), bdt) for o in ha),
            hb=tuple(jnp.asarray(sel(o), bdt) for o in hb),
            rb=jnp.asarray(fd.row_blk), cb=jnp.asarray(fd.col_blk),
            tiles=jnp.asarray(tiles, dtype), layout=layout)

    if is_real:
        return plane(np.real, fd.tiles), None, None
    return (plane(np.real, fd.tiles.real),
            plane(np.imag, fd.tiles.imag),
            plane(lambda a: np.real(a) + np.imag(a),
                  fd.tiles.real + fd.tiles.imag))


def _dot_f32x3(a: jax.Array, x: jax.Array, dims) -> jax.Array:
    """f32-fidelity dot via a MANUAL bf16x3 compensated product
    (a_hi@x_hi + a_hi@x_lo + a_lo@x_hi, f32 accumulation).

    Same arithmetic XLA's Precision.HIGHEST performs — but its
    excess-precision rewrite materialises the hi/lo splits of the big
    operand as stacked broadcast/remat temps (measured on the Ns=16
    within-half dots: three f32[8,70,931840] allocations, ~6 GB, which
    pushed the compiled program to 14.6 GB and OOMed the compile).
    Splitting by hand keeps the temps at two bf16 copies of each
    operand, which XLA fuses into the dot inputs."""
    ah = a.astype(jnp.bfloat16)
    al = (a - ah.astype(jnp.float32)).astype(jnp.bfloat16)
    xh = x.astype(jnp.bfloat16)
    xl = (x - xh.astype(jnp.float32)).astype(jnp.bfloat16)

    def d(u, v):
        return jax.lax.dot_general(u, v, dims,
                                   preferred_element_type=jnp.float32)

    return d(ah, xh) + d(ah, xl) + d(al, xh)


_ROWDOT = (((1,), (0,)), ((), ()))


def _within_dot(hmat: jax.Array, xb3: jax.Array) -> jax.Array:
    """[p, a] x [a, b, m] -> [p, b, m] at f32 fidelity (f32 inputs) or
    f64 (exact-emulation dot).  The f64 emulation materialises ~4x the
    operand in hi/lo split temps, so f64 blocks run in b-axis chunks
    that cap the temp at ~0.5 GB (the uncapped form needed 13.8 GB of
    compile-time temps at the Ns=16 flagship)."""
    if xb3.dtype == jnp.float32:
        return _dot_f32x3(hmat.astype(jnp.float32), xb3, _ROWDOT)
    h64 = hmat.astype(xb3.dtype)

    def dot(xc):
        return jax.lax.dot_general(
            h64, xc, _ROWDOT, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=xb3.dtype)

    a, b, m = xb3.shape
    bc = max(1, int(5e8 // max(a * m * 8 * 4, 1)))
    if b <= bc:
        return dot(xb3)
    parts = [dot(xb3[:, lo:lo + bc]) for lo in range(0, b, bc)]
    return jnp.concatenate(parts, axis=1)


def _apply_factor(fd: HierFactorDev, x: jax.Array) -> jax.Array:
    """y = F @ x with x [nb*B, minor] in padded hier ordering (one
    plane): dense within-half chain + band-kernel cross tiles."""
    ca, cbs, offsets, dim, ha_idx, hb_idx = fd.layout
    nbb = x.shape[0]
    m = x.shape[1]
    nblk = len(ca)
    ha_of = dict(zip(ha_idx, fd.ha))
    hb_of = dict(zip(hb_idx, fd.hb))
    # within-half dense chain assembled by CONCAT along the row axis (a
    # dynamic-update-slice chain does not alias on this backend —
    # measured 7 full-plane copies per side at Ns=16), then one add
    # with the cross-tile band-kernel output
    parts = []
    for i in range(nblk):
        sz = ca[i] * cbs[i]
        if i not in ha_of and i not in hb_of:
            parts.append(jnp.zeros((sz, m), x.dtype))
            continue
        xb = jax.lax.dynamic_slice_in_dim(x, offsets[i], sz, 0)
        acc = None
        if i in ha_of:
            if ca[i] == 1:
                # degenerate 1x1 block: scalar multiply, not a matmul
                acc = ha_of[i][0, 0].astype(x.dtype) * xb
            else:
                # [p,a] x [a,b,m] -> [p,b,m]: contract over a with b,m
                # as FREE dims — merging (b,m) into one axis looks the
                # same to the matmul but the (rows, minor)->(a, b*minor)
                # reshape is a tiled-layout repack that XLA materialised
                # as three ~2 GB broadcast/remat temps per block
                # (the round-5 compile-OOM root cause); splitting the
                # LEADING axis (rows -> a,b) is layout-free
                acc = _within_dot(
                    ha_of[i], xb.reshape(ca[i], cbs[i], m)
                ).reshape(sz, m)
        if i in hb_of:
            if cbs[i] == 1:
                yb = hb_of[i][0, 0].astype(x.dtype) * xb
            else:
                xb3 = xb.reshape(ca[i], cbs[i], m)
                # contract b: [q,b] x [a,b,m] -> [q,a,m] -> [a,q,m]
                dims = (((1,), (1,)), ((), ()))
                if x.dtype == jnp.float32:
                    yb = _dot_f32x3(hb_of[i].astype(jnp.float32), xb3,
                                    dims)
                else:
                    yb = jax.lax.dot_general(
                        hb_of[i].astype(x.dtype), xb3, dims,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=x.dtype)
                yb = yb.transpose(1, 0, 2).reshape(sz, m)
            acc = yb if acc is None else acc + yb
        parts.append(acc)
    if nbb > dim:
        parts.append(jnp.zeros((nbb - dim, m), x.dtype))
    return (jnp.concatenate(parts, axis=0)
            + large._blk_spmm(fd.rb, fd.cb, fd.tiles, x,
                              nbb // B))


# ---------------------------------------------------------------------------
# operator pytrees + matvecs
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class HierRealOp:
    """REAL sector Hamiltonian, hier ordering on both padded axes."""
    diag: jax.Array          # [Ddp, Dup]
    dw: HierFactorDev
    up: HierFactorDev

    def tree_flatten(self):
        return (self.diag, self.dw, self.up), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class HierPairOp:
    """Complex sector Hamiltonian on split planes (3-plane Karatsuba
    per side, mirroring ops/large.LargePairOp)."""
    diag: jax.Array
    dw_r: HierFactorDev
    dw_i: HierFactorDev
    dw_s: HierFactorDev
    up_r: HierFactorDev
    up_i: HierFactorDev
    up_s: HierFactorDev

    def tree_flatten(self):
        return (self.diag, self.dw_r, self.dw_i, self.dw_s,
                self.up_r, self.up_i, self.up_s), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _mat_t(x: jax.Array) -> jax.Array:
    """Materialised standard-layout transpose.  The within-half slices/
    reshapes/dots must NOT consume a lazy x.T: XLA then propagates the
    {0,1} layout into the block reshapes and lowers them as full-plane
    repack/select chains (measured at the Ns=16 flagship: three
    f32[8,70,931840] repack temps + four 676 MB layout copies — a
    14.6 GB program that OOMs the compile).  The barrier pins one clean
    transposed copy."""
    return jax.lax.optimization_barrier(x.T)


def matvec_hier_real(op: HierRealOp, x: jax.Array) -> jax.Array:
    """H·x, x [Ddp, Dup] hier-ordered: fused diagonal + dw factor in
    natural layout + up factor in transposed layout (same two-sided
    tensor-product scheme as the reference MPI matvec,
    ED_HAMILTONIAN_SPARSE_HxV.f90:230-315, minus the network)."""
    out = op.diag * x
    out = out + _apply_factor(op.dw, x)
    out = out + _apply_factor(op.up, _mat_t(x)).T
    return out


def matvec_hier_pair(op: HierPairOp, xr: jax.Array, xi: jax.Array):
    xs = xr + xi
    p1 = _apply_factor(op.dw_r, xr)
    p2 = _apply_factor(op.dw_i, xi)
    p3 = _apply_factor(op.dw_s, xs)
    q1 = _apply_factor(op.up_r, _mat_t(xr)).T
    q2 = _apply_factor(op.up_i, _mat_t(xi)).T
    q3 = _apply_factor(op.up_s, _mat_t(xs)).T
    out_r = op.diag * xr + (p1 - p2) + (q1 - q2)
    out_i = op.diag * xi + (p3 - p1 - p2) + (q3 - q1 - q2)
    return out_r, out_i


# -- flat + batched appliers (kit interface of ops/large.py) ---------------

def apply_hier_real_flat(dev: HierRealOp, x: jax.Array) -> jax.Array:
    return matvec_hier_real(dev, x.reshape(dev.diag.shape)).reshape(-1)


@functools.partial(jax.jit, static_argnames=("nch",))
def _matvec_hier_real_lowmem_jit(dev, x, nch: int):
    ddp, dup = x.shape
    cw = dup // nch
    rw = ddp // nch
    out = dev.diag * x

    def dw_body(i, acc):
        xc = jax.lax.dynamic_slice(x, (0, i * cw), (ddp, cw))
        yc = _apply_factor(dev.dw, xc)
        upd = jax.lax.dynamic_slice(acc, (0, i * cw), (ddp, cw)) + yc
        return jax.lax.dynamic_update_slice(acc, upd, (0, i * cw))

    out = jax.lax.fori_loop(0, nch, dw_body, out)

    def up_body(i, acc):
        xr = jax.lax.dynamic_slice(x, (i * rw, 0), (rw, dup))
        yr = _apply_factor(dev.up, jax.lax.optimization_barrier(xr.T)).T
        upd = jax.lax.dynamic_slice(acc, (i * rw, 0), (rw, dup)) + yr
        return jax.lax.dynamic_update_slice(acc, upd, (i * rw, 0))

    return jax.lax.fori_loop(0, nch, up_body, out)


def apply_hier_real_flat_lowmem(dev: HierRealOp, x: jax.Array,
                                nch: int = None) -> jax.Array:
    """Memory-lean H·x: the two factor sides run in column/row chunks
    inside one jit (the within-half chain and the cross tiles are both
    pure ROW operations, so the minor axis chunks freely) — peak extra
    HBM is O(dim/nch) instead of several full planes.  This is the f64
    REFINE matvec at the Ns=16 flagship: the full-plane f64 apply's
    transients (~8 GB) did not fit next to the refine state on one
    chip (same lever as large.matvec_large_real_lowmem, r4)."""
    x2 = x.reshape(dev.diag.shape)
    if nch is None:
        nch = 1
        # chunk so the per-chunk transients stay well under 1 GB
        itemsize = np.dtype(x2.dtype.name).itemsize
        while (x2.size // nch) * itemsize * 4 > 8e8 \
                and x2.shape[0] % (nch * 2) == 0 \
                and x2.shape[1] % (nch * 2) == 0:
            nch *= 2
    if nch == 1:
        return matvec_hier_real(dev, x2).reshape(-1)
    return _matvec_hier_real_lowmem_jit(dev, x2, nch).reshape(-1)


def apply_hier_pair_flat(dev: HierPairOp, xr, xi):
    sh = dev.diag.shape
    wr, wi = matvec_hier_pair(dev, xr.reshape(sh), xi.reshape(sh))
    return wr.reshape(-1), wi.reshape(-1)


def apply_hier_realpair_flat(dev: HierRealOp, xr, xi):
    return apply_hier_real_flat(dev, xr), apply_hier_real_flat(dev, xi)


def _batched_real(dev: HierRealOp, x3: jax.Array) -> jax.Array:
    """x3 [B, Ddp, Dup]: batch folded into the factor minor axis (one
    wide apply per side instead of B narrow ones)."""
    bb, ddp, dup = x3.shape
    out = dev.diag[None] * x3
    x_dw = jax.lax.optimization_barrier(
        jnp.moveaxis(x3, 0, -1).reshape(ddp, dup * bb))
    out = out + jnp.moveaxis(
        _apply_factor(dev.dw, x_dw).reshape(ddp, dup, bb), -1, 0)
    x_up = jax.lax.optimization_barrier(
        x3.transpose(2, 1, 0).reshape(dup, ddp * bb))
    out = out + _apply_factor(dev.up, x_up).reshape(dup, ddp, bb) \
        .transpose(2, 1, 0)
    return out


def apply_hier_real_flat_batched(dev: HierRealOp, x: jax.Array):
    bb = x.shape[0]
    ddp, dup = dev.diag.shape
    return _batched_real(dev, x.reshape(bb, ddp, dup)).reshape(bb, -1)


def apply_hier_realpair_flat_batched(dev: HierRealOp, xr, xi):
    return (apply_hier_real_flat_batched(dev, xr),
            apply_hier_real_flat_batched(dev, xi))


def apply_hier_pair_flat_batched(dev: HierPairOp, xr, xi):
    bb = xr.shape[0]
    ddp, dup = dev.diag.shape
    x3r = xr.reshape(bb, ddp, dup)
    x3i = xi.reshape(bb, ddp, dup)
    x3s = x3r + x3i

    def dw_side(fd, x3):
        xf = jnp.moveaxis(x3, 0, -1).reshape(ddp, dup * bb)
        return jnp.moveaxis(
            _apply_factor(fd, xf).reshape(ddp, dup, bb), -1, 0)

    def up_side(fd, x3):
        xf = x3.transpose(2, 1, 0).reshape(dup, ddp * bb)
        return _apply_factor(fd, xf).reshape(dup, ddp, bb) \
            .transpose(2, 1, 0)

    p1 = dw_side(dev.dw_r, x3r)
    p2 = dw_side(dev.dw_i, x3i)
    p3 = dw_side(dev.dw_s, x3s)
    q1 = up_side(dev.up_r, x3r)
    q2 = up_side(dev.up_i, x3i)
    q3 = up_side(dev.up_s, x3s)
    out_r = dev.diag[None] * x3r + (p1 - p2) + (q1 - q2)
    out_i = dev.diag[None] * x3i + (p3 - p1 - p2) + (q3 - q1 - q2)
    return out_r.reshape(bb, -1), out_i.reshape(bb, -1)


# ---------------------------------------------------------------------------
# kits
# ---------------------------------------------------------------------------

_factor_cache: dict = {}


def _hier_factor_of(states: np.ndarray, ell) -> hier.HierFactor:
    """HierFactor of a stored ELL spin factor, or None when it is not a
    pure one-body hop matrix.  Cached on the term list + sector shape
    (the DMFT loop rebuilds operators every bath update; the structure
    only depends on (ns, n, terms))."""
    states = np.asarray(states, np.int64)
    if len(states) < 2:
        return None
    terms = hier.terms_from_ell(states, ell)
    if terms is None or not terms:
        return None
    ns = int(states.max()).bit_length()
    n = int(bin(int(states[0])).count("1"))
    key = (ns, n, tuple((a, b, complex(c)) for a, b, c in terms))
    hit = _factor_cache.get(key)
    if hit is None:
        hit = hier.build_hier_factor(ns, n, terms)
        if len(_factor_cache) > 64:
            _factor_cache.clear()
        _factor_cache[key] = hit
    return hit


def _make_embed_extract(f_dw, f_up, ddp, dup):
    dd, du = f_dw.dim, f_up.dim
    pd, pu = f_dw.perm, f_up.perm
    inv_d = np.argsort(pd)
    inv_u = np.argsort(pu)
    inv_d_dev = jnp.asarray(inv_d.astype(np.int32))
    inv_u_dev = jnp.asarray(inv_u.astype(np.int32))
    pd_dev = jnp.asarray(pd.astype(np.int32))
    pu_dev = jnp.asarray(pu.astype(np.int32))

    def embed(v):
        """combinadic flat [*, dd*du] -> padded hier flat [*, ddp*dup]."""
        if isinstance(v, jax.Array):
            lead = v.shape[:-1]
            v2 = v.reshape(lead + (dd, du))
            v2 = jnp.take(jnp.take(v2, inv_d_dev, axis=-2),
                          inv_u_dev, axis=-1)
            pads = [(0, 0)] * len(lead) + [(0, ddp - dd), (0, dup - du)]
            return jnp.pad(v2, pads).reshape(lead + (ddp * dup,))
        v = np.asarray(v)
        lead = v.shape[:-1]
        out = np.zeros(lead + (ddp, dup), v.dtype)
        v2 = v.reshape(lead + (dd, du))
        out[..., :dd, :du] = v2[..., inv_d, :][..., inv_u]
        return out.reshape(lead + (ddp * dup,))

    def extract(v):
        if isinstance(v, jax.Array):
            lead = v.shape[:-1]
            v2 = v.reshape(lead + (ddp, dup))[..., :dd, :du]
            return jnp.take(jnp.take(v2, pd_dev, axis=-2),
                            pu_dev, axis=-1).reshape(lead + (dd * du,))
        v = np.asarray(v)
        lead = v.shape[:-1]
        v2 = v.reshape(lead + (ddp, dup))[..., :dd, :du]
        return v2[..., pd, :][..., pu].reshape(lead + (dd * du,))

    return embed, extract


def _diag_hier(op: SectorOperator, f_dw, f_up, ddp, dup, dtype):
    inv_d = np.argsort(f_dw.perm)
    inv_u = np.argsort(f_up.perm)
    d = np.full((ddp, dup), _PAD_DIAG)
    d[:f_dw.dim, :f_up.dim] = op.diag()[inv_d][:, inv_u]
    vdt = jnp.float32 if dtype == jnp.bfloat16 else dtype
    return jnp.asarray(d, vdt)


def _hier_pad(dim: int) -> int:
    """Padded row count of one hier axis: a whole number of tiles."""
    return -(-dim // B) * B


def _pad_dims(f_dw, f_up):
    return _hier_pad(f_dw.dim), _hier_pad(f_up.dim)


def build_real_padded_hier(op: SectorOperator, dtype=jnp.float32,
                           reuse=None):
    """(dev, dim_p, embed, extract) or None when the operator has Jx/Jp
    terms, is complex, or its factors are not pure one-body (callers
    fall back to the block-sparse tile kit of ops/large.py).  Same kit
    contract as large.build_real_padded_large.  ``reuse`` shares the
    diagonal and dense blocks of a same-shape build (bf16 coarse op)."""
    if not op_is_real(op) or op.nd_terms:
        return None
    f_up = _hier_factor_of(op.states_up, op.h_up)
    f_dw = _hier_factor_of(op.states_dw, op.h_dw)
    if f_up is None or f_dw is None:
        return None
    dw_r, dw_i, _ = factor_dev_planes(f_dw, dtype)
    up_r, up_i, _ = factor_dev_planes(f_up, dtype)
    if dw_i is not None or up_i is not None:
        return None
    ddp, dup = _pad_dims(f_dw, f_up)
    if reuse is not None:
        diag = reuse.diag
    else:
        diag = _diag_hier(op, f_dw, f_up, ddp, dup, dtype)
    dev = HierRealOp(diag=diag, dw=dw_r, up=up_r)
    embed, extract = _make_embed_extract(f_dw, f_up, ddp, dup)
    return dev, ddp * dup, embed, extract


def build_pair_padded_hier(op: SectorOperator, dtype=jnp.float32,
                           reuse=None):
    """(dev, real_flag, dim_p, embed, extract) mirroring
    large.build_pair_padded_large, or None when hier does not apply."""
    if op.nd_terms:
        return None
    f_up = _hier_factor_of(op.states_up, op.h_up)
    f_dw = _hier_factor_of(op.states_dw, op.h_dw)
    if f_up is None or f_dw is None:
        return None
    ddp, dup = _pad_dims(f_dw, f_up)
    embed, extract = _make_embed_extract(f_dw, f_up, ddp, dup)
    dim_p = ddp * dup
    real = op_is_real(op)
    if real:
        dw_r, dw_i, _ = factor_dev_planes(f_dw, dtype)
        up_r, up_i, _ = factor_dev_planes(f_up, dtype)
        if dw_i is not None or up_i is not None:
            return None
        diag = reuse.diag if reuse is not None else _diag_hier(
            op, f_dw, f_up, ddp, dup, dtype)
        dev = HierRealOp(diag=diag, dw=dw_r, up=up_r)
        return dev, True, dim_p, embed, extract
    dw_r, dw_i, dw_s = factor_dev_planes(f_dw, dtype)
    up_r, up_i, up_s = factor_dev_planes(f_up, dtype)
    if dw_i is None:
        z = jax.tree_util.tree_map(jnp.zeros_like, dw_r)
        dw_i, dw_s = z, dw_r
    if up_i is None:
        z = jax.tree_util.tree_map(jnp.zeros_like, up_r)
        up_i, up_s = z, up_r
    diag = reuse.diag if reuse is not None else _diag_hier(
        op, f_dw, f_up, ddp, dup, dtype)
    dev = HierPairOp(diag=diag, dw_r=dw_r, dw_i=dw_i, dw_s=dw_s,
                     up_r=up_r, up_i=up_i, up_s=up_s)
    return dev, False, dim_p, embed, extract
