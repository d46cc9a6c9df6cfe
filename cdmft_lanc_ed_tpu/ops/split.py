"""Split-complex (re/im planes) device kernels — the accelerator path.

The device kernels run on **split representation**: a complex vector is a
real array ``x[2, ...]`` with x[0]=Re, x[1]=Im, and complex arithmetic is
expanded into real matmuls (3-mult Karatsuba products), so the f32 Krylov
stage of the mixed-precision solver has a complex form too.

This module mirrors ops/spmv.py for the split representation.  The complex
path (ops/spmv.py) remains the CPU/test oracle.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .sector_ham import SectorOperator

jax.config.update("jax_enable_x64", True)


@jax.tree_util.register_pytree_node_class
@dataclass
class SplitSectorOp:
    """Sector Hamiltonian with complex data split into re/im f64 planes."""
    diag: jax.Array        # [DimDw, DimUp] f64 (H diagonal is real)
    up_cols: jax.Array     # [DimUp, Ku] i32
    up_vals: jax.Array     # [2, DimUp, Ku] f64
    dw_cols: jax.Array     # [DimDw, Kd] i32
    dw_vals: jax.Array     # [2, DimDw, Kd] f64
    nd_amp: jax.Array      # [2, T] f64
    nd_up_src: jax.Array   # [T, DimUp] i32
    nd_up_sgn: jax.Array   # [T, DimUp] i8
    nd_dw_src: jax.Array   # [T, DimDw] i32
    nd_dw_sgn: jax.Array   # [T, DimDw] i8

    def tree_flatten(self):
        return ((self.diag, self.up_cols, self.up_vals, self.dw_cols,
                 self.dw_vals, self.nd_amp, self.nd_up_src, self.nd_up_sgn,
                 self.nd_dw_src, self.nd_dw_sgn), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def dim(self):
        return self.diag.shape[0] * self.diag.shape[1]


def to_device_split(op: SectorOperator, f32: bool = False) -> SplitSectorOp:
    ftype = jnp.float32 if f32 else jnp.float64
    t = len(op.nd_terms)
    if t:
        amp = np.array([x.amp for x in op.nd_terms])
        nd_amp = np.stack([amp.real, amp.imag])
        nd_us = np.stack([x.up_src for x in op.nd_terms])
        nd_ug = np.stack([x.up_sgn for x in op.nd_terms])
        nd_ds = np.stack([x.dw_src for x in op.nd_terms])
        nd_dg = np.stack([x.dw_sgn for x in op.nd_terms])
    else:
        nd_amp = np.zeros((2, 0))
        nd_us = np.zeros((0, op.dim_up), np.int32)
        nd_ug = np.zeros((0, op.dim_up), np.int8)
        nd_ds = np.zeros((0, op.dim_dw), np.int32)
        nd_dg = np.zeros((0, op.dim_dw), np.int8)
    uv = op.h_up.vals
    dv = op.h_dw.vals
    return SplitSectorOp(
        diag=jnp.asarray(op.diag(), ftype),
        up_cols=jnp.asarray(op.h_up.cols, jnp.int32),
        up_vals=jnp.asarray(np.stack([uv.real, uv.imag]), ftype),
        dw_cols=jnp.asarray(op.h_dw.cols, jnp.int32),
        dw_vals=jnp.asarray(np.stack([dv.real, dv.imag]), ftype),
        nd_amp=jnp.asarray(nd_amp, ftype),
        nd_up_src=jnp.asarray(nd_us, jnp.int32),
        nd_up_sgn=jnp.asarray(nd_ug, jnp.int8),
        nd_dw_src=jnp.asarray(nd_ds, jnp.int32),
        nd_dw_sgn=jnp.asarray(nd_dg, jnp.int8),
    )


def _ell_split(cols, vr, vi, x):
    """Row-gather SpMM with complex (vr+i vi) matrix applied to x[2, R, C]
    along the leading row axis: out[2, R, C]."""
    g = x[:, cols, :]                       # [2, R, K, C]
    ar = jnp.einsum("rk,rkc->rc", vr, g[0], precision=_PREC) \
        - jnp.einsum("rk,rkc->rc", vi, g[1], precision=_PREC)
    ai = jnp.einsum("rk,rkc->rc", vr, g[1], precision=_PREC) \
        + jnp.einsum("rk,rkc->rc", vi, g[0], precision=_PREC)
    return jnp.stack([ar, ai])


def matvec_2d_split(op: SplitSectorOp, x: jax.Array) -> jax.Array:
    """H·x with x [2, DimDw, DimUp] f64 (re/im planes)."""
    out = op.diag[None] * x
    out = out + _ell_split(op.dw_cols, op.dw_vals[0], op.dw_vals[1], x)
    xt = x.transpose(0, 2, 1)
    yt = _ell_split(op.up_cols, op.up_vals[0], op.up_vals[1], xt)
    out = out + yt.transpose(0, 2, 1)
    if op.nd_amp.shape[1]:
        def one(ar, ai, usrc, usgn, dsrc, dsgn):
            g = x[:, jnp.maximum(dsrc, 0)][:, :, jnp.maximum(usrc, 0)]
            mask = (dsgn[:, None] * usgn[None, :]).astype(x.dtype)
            gr, gi = g[0] * mask, g[1] * mask
            return jnp.stack([ar * gr - ai * gi, ar * gi + ai * gr])
        contrib = jax.vmap(one)(op.nd_amp[0], op.nd_amp[1], op.nd_up_src,
                                op.nd_up_sgn, op.nd_dw_src, op.nd_dw_sgn)
        out = out + contrib.sum(axis=0)
    return out


def make_matvec_split(op: SplitSectorOp):
    """Flat split matvec: [2, dim] -> [2, dim] (jitted once per shape)."""
    dd, du = op.diag.shape

    @jax.jit
    def mv(x):
        return matvec_2d_split(op, x.reshape(2, dd, du)).reshape(2, -1)

    return mv


# ---------------------------------------------------------------------------
# dense-factor variant: tensor-product blocks as matmuls
# ---------------------------------------------------------------------------
#
# The spin factors H_up/H_dw are only [Dim_s x Dim_s] (Dim_s = C(Ns, n_s),
# ~1e3-1e4 for production sectors) at ~1% density, so a dense matmul per
# factor (a library GEMM) replaces the serialized ELL row-gather.  The full
# H is NEVER materialised — only its two small spin factors (the big
# Dim_up*Dim_dw object stays implicit in the tensor-product form), so
# memory is O(Dim_s^2) << O(Dim^2).
#
# Every product names its precision: f64 planes run true f64 GEMMs, and the
# f32 planes of the mixed-precision Krylov stage run at HIGHEST so they
# stay f32 (not TF32) on a GPU.  The mixed-precision eigensolver (f32
# Krylov + f64 Rayleigh-Ritz, residual-checked f64 fallback) is the
# throughput path.

_PREC = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclass
class DenseSplitOp:
    """Sector Hamiltonian with dense split spin factors.

    All complex data is held as SEPARATE contiguous arrays (not stacked
    [2, ...] planes), so every matmul takes a standalone operand."""
    diag: jax.Array        # [DimDw, DimUp] f64
    hdw_r: jax.Array       # [DimDw, DimDw] f64
    hdw_i: jax.Array
    hdw_s: jax.Array       # hdw_r + hdw_i (3-mult complex matmul)
    hupT_r: jax.Array      # [DimUp, DimUp] f64, PRE-TRANSPOSED (H_up^T)
    hupT_i: jax.Array
    hupT_s: jax.Array      # hupT_r + hupT_i
    nd_amp_r: jax.Array    # [T]
    nd_amp_i: jax.Array
    nd_upT: jax.Array      # [T, DimUp, DimUp] f64 (sign pattern^T, real)
    nd_dw: jax.Array       # [T, DimDw, DimDw] f64

    def tree_flatten(self):
        return ((self.diag, self.hdw_r, self.hdw_i, self.hdw_s,
                 self.hupT_r, self.hupT_i, self.hupT_s, self.nd_amp_r,
                 self.nd_amp_i, self.nd_upT, self.nd_dw), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# geometric shape ladder: a compile per distinct shape costs more than
# the <=1.7x FLOP padding waste, so sector dims snap to a
# coarse ladder and e.g. the (5,5)/(5,6)/(6,6) flagship sectors all share
# ONE compiled kernel (compile-cache bucketing, SURVEY.md 'sector
# heterogeneity')
_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
            6144, 8192)


def _bucket(n: int) -> int:
    if n <= 64:
        return n            # tiny dims: padding overhead dominates
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def to_device_dense_split(op: SectorOperator, pad_to: tuple = None,
                          dtype=jnp.float64) -> DenseSplitOp:
    """Device arrays for the dense-factor kernel.  ``pad_to=(ddp, dup)``
    zero-pads both factors to a shape bucket: padded modes get a +1e6
    diagonal (far above the physical spectrum) and are exactly decoupled
    (block-diagonal), so vectors that start zero in the padding stay zero
    through any Krylov iteration.  ``dtype=jnp.float32`` builds the
    reduced-precision operator used by the mixed-precision eigensolver."""
    hu = op.h_up.to_dense()
    hd = op.h_dw.to_dense()
    du, dd = op.dim_up, op.dim_dw
    diag = op.diag()
    if pad_to is not None:
        ddp, dup = pad_to
        diag_p = np.full((ddp, dup), 1e6)
        diag_p[:dd, :du] = diag
        diag = diag_p
        hu_p = np.zeros((dup, dup), np.complex128)
        hu_p[:du, :du] = hu
        hu = hu_p
        hd_p = np.zeros((ddp, ddp), np.complex128)
        hd_p[:dd, :dd] = hd
        hd = hd_p
        du, dd = dup, ddp
    t = len(op.nd_terms)
    if t:
        amp = np.array([x.amp for x in op.nd_terms])
        nd_upT = np.zeros((t, du, du))
        nd_dw = np.zeros((t, dd, dd))
        for i, term in enumerate(op.nd_terms):
            iu = np.nonzero(term.up_src >= 0)[0]
            nd_upT[i, term.up_src[iu], iu] = term.up_sgn[iu]
            idw = np.nonzero(term.dw_src >= 0)[0]
            nd_dw[i, idw, term.dw_src[idw]] = term.dw_sgn[idw]
        nd_amp_r, nd_amp_i = amp.real, amp.imag
    else:
        nd_amp_r = np.zeros(0)
        nd_amp_i = np.zeros(0)
        nd_upT = np.zeros((0, du, du))
        nd_dw = np.zeros((0, dd, dd))
    c = np.ascontiguousarray
    return DenseSplitOp(
        diag=jnp.asarray(diag, dtype),
        hdw_r=jnp.asarray(c(hd.real), dtype),
        hdw_i=jnp.asarray(c(hd.imag), dtype),
        hdw_s=jnp.asarray(c(hd.real + hd.imag), dtype),
        hupT_r=jnp.asarray(c(hu.real.T), dtype),
        hupT_i=jnp.asarray(c(hu.imag.T), dtype),
        hupT_s=jnp.asarray(c(hu.real.T + hu.imag.T), dtype),
        nd_amp_r=jnp.asarray(nd_amp_r, dtype),
        nd_amp_i=jnp.asarray(nd_amp_i, dtype),
        nd_upT=jnp.asarray(nd_upT, dtype),
        nd_dw=jnp.asarray(nd_dw, dtype),
    )


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def matvec_dense_pair(op: DenseSplitOp, xr: jax.Array, xi: jax.Array):
    """H·x on the pair representation: (xr, xi) [DimDw, DimUp] -> same.

    (H_dw ⊗ I)v = H_dw · X ;  (I ⊗ H_up)v = X · H_upᵀ  — the single-chip
    form of the reference's transpose scheme with zero data movement;
    every heavy op is a matmul at HIGHEST precision.
    Each complex product uses the 3-multiplication (Karatsuba) form:
      Re = P1 - P2,  Im = P3 - P1 - P2
    with P1 = Ar·Xr, P2 = Ai·Xi, P3 = (Ar+Ai)·(Xr+Xi) — 6 matmuls per
    matvec instead of 8 (25 % fewer matmuls for one guard bit)."""
    xs = xr + xi
    p1 = _mm(op.hdw_r, xr)
    p2 = _mm(op.hdw_i, xi)
    p3 = _mm(op.hdw_s, xs)
    q1 = _mm(xr, op.hupT_r)
    q2 = _mm(xi, op.hupT_i)
    q3 = _mm(xs, op.hupT_s)
    out_r = op.diag * xr + (p1 - p2) + (q1 - q2)
    out_i = op.diag * xi + (p3 - p1 - p2) + (q3 - q1 - q2)
    tcount = op.nd_amp_r.shape[0]
    for t in range(tcount):
        # amp * O_dw · X · O_upᵀ   (O real sign patterns; T is tiny)
        yr = _mm(op.nd_dw[t], _mm(xr, op.nd_upT[t]))
        yi = _mm(op.nd_dw[t], _mm(xi, op.nd_upT[t]))
        out_r = out_r + op.nd_amp_r[t] * yr - op.nd_amp_i[t] * yi
        out_i = out_i + op.nd_amp_r[t] * yi + op.nd_amp_i[t] * yr
    return out_r, out_i


def matvec_2d_dense_split(op: DenseSplitOp, x: jax.Array) -> jax.Array:
    """[2, DimDw, DimUp] wrapper over the pair kernel."""
    out_r, out_i = matvec_dense_pair(op, x[0], x[1])
    return jnp.stack([out_r, out_i])


# ---------------------------------------------------------------------------
# real-operator fast path
# ---------------------------------------------------------------------------
#
# Hubbard/SSH/kagome-type sectors have REAL symmetric Hamiltonians (real
# hoppings, real bath λ).  The split-complex kernel then wastes matmuls:
# a real H applied to a complex vector needs 4 matmuls (H·Xr, H·Xi per
# side / 2 sides shared as 2+2) instead of 6, and a purely real Krylov
# iteration (real v0, real H ⇒ the whole Lanczos stays real) needs only 2.
# The reference always runs complex(8) (ED_VARS_GLOBAL.f90 spH0 types);
# detecting realness and dropping the imaginary plane is a 1.5–3x win the
# Fortran code leaves on the table.

_PAD_DIAG = 1e6   # decoupled padding modes sit far above the spectrum


@jax.tree_util.register_pytree_node_class
@dataclass
class DenseRealOp:
    """Sector Hamiltonian with REAL dense spin factors (the hot path for
    real-Hamiltonian models)."""
    diag: jax.Array        # [DimDw, DimUp] f64
    hdw: jax.Array         # [DimDw, DimDw] f64
    hupT: jax.Array        # [DimUp, DimUp] f64 (pre-transposed)
    nd_amp: jax.Array      # [T] f64
    nd_upT: jax.Array      # [T, DimUp, DimUp] f64
    nd_dw: jax.Array       # [T, DimDw, DimDw] f64

    def tree_flatten(self):
        return ((self.diag, self.hdw, self.hupT, self.nd_amp,
                 self.nd_upT, self.nd_dw), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def op_is_real(op: SectorOperator) -> bool:
    """True when every term of the sector Hamiltonian is real (the diagonal
    always is): real spin factors and real Jx/Jp amplitudes."""
    if op.h_up.vals.size and np.abs(op.h_up.vals.imag).max() != 0.0:
        return False
    if op.h_dw.vals.size and np.abs(op.h_dw.vals.imag).max() != 0.0:
        return False
    return all(complex(t.amp).imag == 0.0 for t in op.nd_terms)


def to_device_dense_real(op: SectorOperator, pad_to: tuple = None,
                         dtype=jnp.float64) -> DenseRealOp:
    """Device arrays for the real dense-factor kernel (see
    :func:`to_device_dense_split` for the padding contract)."""
    hu = op.h_up.to_dense().real
    hd = op.h_dw.to_dense().real
    du, dd = op.dim_up, op.dim_dw
    diag = op.diag()
    if pad_to is not None:
        ddp, dup = pad_to
        diag_p = np.full((ddp, dup), _PAD_DIAG)
        diag_p[:dd, :du] = diag
        diag = diag_p
        hu_p = np.zeros((dup, dup))
        hu_p[:du, :du] = hu
        hu = hu_p
        hd_p = np.zeros((ddp, ddp))
        hd_p[:dd, :dd] = hd
        hd = hd_p
        du, dd = dup, ddp
    t = len(op.nd_terms)
    nd_amp = np.zeros(t)
    nd_upT = np.zeros((t, du, du))
    nd_dw = np.zeros((t, dd, dd))
    for i, term in enumerate(op.nd_terms):
        nd_amp[i] = complex(term.amp).real
        iu = np.nonzero(term.up_src >= 0)[0]
        nd_upT[i, term.up_src[iu], iu] = term.up_sgn[iu]
        idw = np.nonzero(term.dw_src >= 0)[0]
        nd_dw[i, idw, term.dw_src[idw]] = term.dw_sgn[idw]
    c = np.ascontiguousarray
    return DenseRealOp(
        diag=jnp.asarray(diag, dtype),
        hdw=jnp.asarray(c(hd), dtype),
        hupT=jnp.asarray(c(hu.T), dtype),
        nd_amp=jnp.asarray(nd_amp, dtype),
        nd_upT=jnp.asarray(nd_upT, dtype),
        nd_dw=jnp.asarray(nd_dw, dtype),
    )


def matvec_dense_real(op: DenseRealOp, x: jax.Array) -> jax.Array:
    """H·x for real H and a REAL plane x [DimDw, DimUp]: two matmuls
    (plus the tiny Jx/Jp sign-pattern products) instead of the complex
    kernel's six; XLA fuses the elementwise terms around the two GEMMs."""
    out = op.diag * x + _mm(op.hdw, x) + _mm(x, op.hupT)
    for t in range(op.nd_amp.shape[0]):
        out = out + op.nd_amp[t] * _mm(op.nd_dw[t], _mm(x, op.nd_upT[t]))
    return out


def matvec_dense_real_pair(op: DenseRealOp, xr: jax.Array, xi: jax.Array):
    """Real H applied to a complex pair: the planes never mix, so this is
    4 matmuls instead of the complex kernel's 6."""
    return matvec_dense_real(op, xr), matvec_dense_real(op, xi)


def make_matvec_real_batched(ops, pad: tuple, dtype=jnp.float64):
    """Batched real matvec over B same-bucket sectors: mv(x[B, dim_p]) ->
    [B, dim_p] (sector-parallel dispatch — the reference's serial sector
    loop ED_DIAG.f90:78 collapsed into one device stream).  All operators
    must be real and share the padded bucket ``pad=(ddp, dup)`` and the
    Jx/Jp term count."""
    ddp, dup = pad
    devs = [to_device_dense_real(
        op, pad_to=None if (op.dim_dw, op.dim_up) == (ddp, dup) else pad,
        dtype=dtype) for op in ops]
    fields = ("diag", "hdw", "hupT", "nd_amp", "nd_upT", "nd_dw")
    batched = DenseRealOp(**{
        f: jnp.stack([getattr(d, f) for d in devs]) for f in fields})

    def one(dev, x):
        return matvec_dense_real(dev, x.reshape(ddp, dup)).reshape(-1)

    mv1 = jax.vmap(one)

    def mv(x):
        return mv1(batched, x)

    return mv


# ---------------------------------------------------------------------------
# pure appliers: operator passed as a pytree ARGUMENT
# ---------------------------------------------------------------------------
#
# Closure-captured device arrays are baked into jitted HLO as constants, so
# a kernel closed over the operator recompiles for every sector AND every
# DMFT iteration (new bath -> new constants -> new HLO hash).  The hot
# eigensolvers therefore take (apply_fn, op) with apply_fn a module-level
# PURE function: the compiled executable is keyed only on shapes/dtypes and
# is shared across sectors in the same shape bucket and across bath updates.

def apply_real_flat(dev: DenseRealOp, x: jax.Array) -> jax.Array:
    """Flat one-plane matvec: x [dim_p] -> H·x [dim_p] (pure)."""
    return matvec_dense_real(dev, x.reshape(dev.diag.shape)).reshape(-1)


def apply_real_flat_batched(dev: DenseRealOp, x: jax.Array) -> jax.Array:
    """Batched flat one-plane matvec: dev leaves and x carry a leading
    batch axis (pure)."""
    return jax.vmap(apply_real_flat)(dev, x)


def apply_pair_flat(dev: DenseSplitOp, xr: jax.Array, xi: jax.Array):
    """Flat split-pair matvec (pure)."""
    sh = dev.diag.shape
    wr, wi = matvec_dense_pair(dev, xr.reshape(sh), xi.reshape(sh))
    return wr.reshape(-1), wi.reshape(-1)


def apply_realpair_flat(dev: DenseRealOp, xr: jax.Array, xi: jax.Array):
    """Flat pair matvec over a REAL operator (4 matmuls; pure)."""
    sh = dev.diag.shape
    wr, wi = matvec_dense_real_pair(dev, xr.reshape(sh), xi.reshape(sh))
    return wr.reshape(-1), wi.reshape(-1)


def apply_pair_flat_batched(dev: DenseSplitOp, xr, xi):
    return jax.vmap(apply_pair_flat)(dev, xr, xi)


def build_real_padded(op: SectorOperator, dtype=jnp.float64):
    """(dev, dim_p, embed, extract) for the pure-applier real path, or
    None when the operator is complex / too large for dense factors."""
    dd, du = op.dim_dw, op.dim_up
    if max(du, dd) > DENSE_FACTOR_MAX or not op_is_real(op):
        return None
    ddp, dup = _bucket(dd), _bucket(du)
    dev = to_device_dense_real(
        op, pad_to=(ddp, dup) if (ddp, dup) != (dd, du) else None,
        dtype=dtype)

    def embed(v):
        return embed_real(v, dd, du, ddp, dup)

    def extract(v):
        return extract_real(v, dd, du, ddp, dup)

    return dev, ddp * dup, embed, extract


def build_pair_padded(op: SectorOperator, dtype=jnp.float64):
    """(dev, real_flag, dim_p, embed, extract) for the pure-applier pair
    path (dev is DenseRealOp when the operator is real, else
    DenseSplitOp); None when too large for dense factors."""
    dd, du = op.dim_dw, op.dim_up
    if max(du, dd) > DENSE_FACTOR_MAX:
        return None
    ddp, dup = _bucket(dd), _bucket(du)
    pad = (ddp, dup) if (ddp, dup) != (dd, du) else None
    real = op_is_real(op)
    dev = (to_device_dense_real(op, pad_to=pad, dtype=dtype) if real
           else to_device_dense_split(op, pad_to=pad, dtype=dtype))

    def embed(v):
        return embed_real(v, dd, du, ddp, dup)

    def extract(v):
        return extract_real(v, dd, du, ddp, dup)

    return dev, real, ddp * dup, embed, extract


def stack_real_ops(ops, pad: tuple, dtype=jnp.float64) -> DenseRealOp:
    """Stacked DenseRealOp with a leading batch axis over same-bucket
    sectors (for :func:`apply_real_flat_batched`)."""
    ddp, dup = pad
    devs = [to_device_dense_real(
        op, pad_to=None if (op.dim_dw, op.dim_up) == (ddp, dup) else pad,
        dtype=dtype) for op in ops]
    fields = ("diag", "hdw", "hupT", "nd_amp", "nd_upT", "nd_dw")
    return DenseRealOp(**{
        f: jnp.stack([getattr(d, f) for d in devs]) for f in fields})


def stack_pair_ops(ops, pad: tuple, dtype=jnp.float64) -> DenseSplitOp:
    """Stacked DenseSplitOp over same-bucket complex sectors."""
    ddp, dup = pad
    devs = [to_device_dense_split(
        op, pad_to=None if (op.dim_dw, op.dim_up) == (ddp, dup) else pad,
        dtype=dtype) for op in ops]
    fields = ("diag", "hdw_r", "hdw_i", "hdw_s", "hupT_r", "hupT_i",
              "hupT_s", "nd_amp_r", "nd_amp_i", "nd_upT", "nd_dw")
    return DenseSplitOp(**{
        f: jnp.stack([getattr(d, f) for d in devs]) for f in fields})


def make_matvec_pair_batched(ops, pad: tuple, dtype=jnp.float64):
    """Batched split-pair matvec over B same-bucket COMPLEX sectors:
    mv(xr[B, dim_p], xi[B, dim_p]) -> (wr, wi) (sector-parallel dispatch
    for complex models; twin of :func:`make_matvec_real_batched`)."""
    ddp, dup = pad
    devs = [to_device_dense_split(
        op, pad_to=None if (op.dim_dw, op.dim_up) == (ddp, dup) else pad,
        dtype=dtype) for op in ops]
    fields = ("diag", "hdw_r", "hdw_i", "hdw_s", "hupT_r", "hupT_i",
              "hupT_s", "nd_amp_r", "nd_amp_i", "nd_upT", "nd_dw")
    batched = DenseSplitOp(**{
        f: jnp.stack([getattr(d, f) for d in devs]) for f in fields})

    def one(dev, xr, xi):
        wr, wi = matvec_dense_pair(dev, xr.reshape(ddp, dup),
                                   xi.reshape(ddp, dup))
        return wr.reshape(-1), wi.reshape(-1)

    mv1 = jax.vmap(one)

    def mv(xr, xi):
        return mv1(batched, xr, xi)

    return mv


def embed_real(v: np.ndarray, dd: int, du: int, ddp: int, dup: int
               ) -> np.ndarray:
    """Real host array [*, dd*du] -> padded [*, ddp*dup] (zeros in the
    decoupled padding modes)."""
    v = np.asarray(v)
    out = np.zeros(v.shape[:-1] + (ddp, dup), v.dtype)
    out[..., :dd, :du] = v.reshape(v.shape[:-1] + (dd, du))
    return out.reshape(v.shape[:-1] + (ddp * dup,))


def extract_real(v: np.ndarray, dd: int, du: int, ddp: int, dup: int
                 ) -> np.ndarray:
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (ddp, dup))[..., :dd, :du] \
        .reshape(v.shape[:-1] + (dd * du,))


def make_matvec_real_padded(op: SectorOperator, dtype=jnp.float64):
    """Bucketed-shape REAL matvec on the padded flat dim, or None when the
    sector Hamiltonian has imaginary parts (or needs the gather fallback).

    Returns (mv, dim_p, embed, extract): ``mv`` maps a flat f64 [dim_p]
    plane; ``embed``/``extract`` move real host arrays in/out of the padded
    2-D layout (same contract as :func:`make_matvec_pair_padded`)."""
    dd, du = op.dim_dw, op.dim_up
    if max(du, dd) > DENSE_FACTOR_MAX or not op_is_real(op):
        return None
    ddp, dup = _bucket(dd), _bucket(du)
    dev = to_device_dense_real(
        op, pad_to=(ddp, dup) if (ddp, dup) != (dd, du) else None,
        dtype=dtype)

    def mv(x):
        return matvec_dense_real(op=dev, x=x.reshape(ddp, dup)).reshape(-1)

    def embed(v):
        v = np.asarray(v)
        out = np.zeros(v.shape[:-1] + (ddp, dup), v.dtype)
        out[..., :dd, :du] = v.reshape(v.shape[:-1] + (dd, du))
        return out.reshape(v.shape[:-1] + (ddp * dup,))

    def extract(v):
        v = np.asarray(v)
        return v.reshape(v.shape[:-1] + (ddp, dup))[..., :dd, :du] \
            .reshape(v.shape[:-1] + (dd * du,))

    return mv, ddp * dup, embed, extract


# dense-path size threshold: factors up to this dimension are materialised
# dense (memory O(Dim_s^2) and a dense GEMM wins); beyond them the sector
# runs on the block-sparse kits (ops/large.py, ops/hier_dev.py)
DENSE_FACTOR_MAX = 8192


def make_matvec_pair(op: SectorOperator):
    """Best-available pair matvec (vr, vi) [dim] -> (wr, wi) [dim] for the
    current backend, plus its (dim_dw, dim_up) shape."""
    dd, du = op.dim_dw, op.dim_up
    if max(du, dd) <= DENSE_FACTOR_MAX:
        real = op_is_real(op)
        ddp, dup = _bucket(dd), _bucket(du)
        if (ddp, dup) == (dd, du):
            dev = (to_device_dense_real(op) if real
                   else to_device_dense_split(op))
            pair = matvec_dense_real_pair if real else matvec_dense_pair

            def mv(vr, vi):
                wr, wi = pair(dev, vr.reshape(dd, du), vi.reshape(dd, du))
                return wr.reshape(-1), wi.reshape(-1)

            return mv

        dev = (to_device_dense_real(op, pad_to=(ddp, dup)) if real
               else to_device_dense_split(op, pad_to=(ddp, dup)))
        pair = matvec_dense_real_pair if real else matvec_dense_pair

        def mv(vr, vi):
            pw = ((0, ddp - dd), (0, dup - du))
            xr = jnp.pad(vr.reshape(dd, du), pw)
            xi = jnp.pad(vi.reshape(dd, du), pw)
            wr, wi = pair(dev, xr, xi)
            return wr[:dd, :du].reshape(-1), wi[:dd, :du].reshape(-1)

        return mv
    dev = to_device_split(op)

    def mv(vr, vi):
        w = matvec_2d_split(dev, jnp.stack([vr, vi]).reshape(2, dd, du))
        return w[0].reshape(-1), w[1].reshape(-1)

    return mv


def make_matvec_pair_padded(op: SectorOperator, dtype=jnp.float64):
    """Bucketed-shape pair matvec operating on the PADDED flat dim.

    Returns (mv, dim_p, embed, extract): ``mv`` maps flat [dim_p] pairs;
    ``embed`` embeds a logical complex [*, dim] array into [*, dim_p]
    (zeros in the padding — exactly preserved by the operator, whose padded
    modes are decoupled at +1e6); ``extract`` inverts it.  Running the
    WHOLE Krylov iteration at the padded shape collapses the number of
    distinct compiled kernels across the sector sweep."""
    dd, du = op.dim_dw, op.dim_up
    ddp, dup = _bucket(dd), _bucket(du)
    if max(du, dd) <= DENSE_FACTOR_MAX:
        pad = (ddp, dup) if (ddp, dup) != (dd, du) else None
        if op_is_real(op):
            dev_r = to_device_dense_real(op, pad_to=pad, dtype=dtype)

            def mv(vr, vi):
                wr, wi = matvec_dense_real_pair(dev_r, vr.reshape(ddp, dup),
                                                vi.reshape(ddp, dup))
                return wr.reshape(-1), wi.reshape(-1)
        else:
            dev = to_device_dense_split(op, pad_to=pad, dtype=dtype)

            def mv(vr, vi):
                wr, wi = matvec_dense_pair(dev, vr.reshape(ddp, dup),
                                           vi.reshape(ddp, dup))
                return wr.reshape(-1), wi.reshape(-1)
    else:
        mv_l = make_matvec_pair(op)
        ddp, dup = dd, du
        mv = mv_l

    def embed(v):
        v = np.asarray(v)
        out = np.zeros(v.shape[:-1] + (ddp, dup), v.dtype)
        out[..., :dd, :du] = v.reshape(v.shape[:-1] + (dd, du))
        return out.reshape(v.shape[:-1] + (ddp * dup,))

    def extract(v):
        v = np.asarray(v)
        return v.reshape(v.shape[:-1] + (ddp, dup))[..., :dd, :du] \
            .reshape(v.shape[:-1] + (dd * du,))

    return mv, ddp * dup, embed, extract


def make_matvec_flat(op: SectorOperator):
    """Flat split matvec [2, dim] -> [2, dim] (compat wrapper)."""
    mv_pair = make_matvec_pair(op)

    @jax.jit
    def mv(x):
        wr, wi = mv_pair(x[0], x[1])
        return jnp.stack([wr, wi])

    return mv


# -- representation converters (host boundary only) -------------------------

def split_of(v: np.ndarray) -> np.ndarray:
    """complex [.., n] -> f64 [.., 2, n] with the split axis SECOND-TO-LAST
    is avoided: we use leading [2, ...] convention: complex [n] -> [2, n];
    complex [B, n] -> [B, 2, n]."""
    v = np.asarray(v)
    return np.stack([v.real, v.imag], axis=-2) if v.ndim > 1 \
        else np.stack([v.real, v.imag])


def unsplit(x: np.ndarray) -> np.ndarray:
    """f64 [..., 2, n] or [2, n] -> complex."""
    x = np.asarray(x)
    return x[..., 0, :] + 1j * x[..., 1, :]
