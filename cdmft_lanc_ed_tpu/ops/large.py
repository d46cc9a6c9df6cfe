"""Large-sector block-sparse SpMM kernels (Ns >= 14-16 regime).

The dense-factor path (ops/split.py) materialises the spin factors
H_up/H_dw as [Dim_s, Dim_s] matrices; beyond ``DENSE_FACTOR_MAX`` (8192)
that is both memory-hungry and FLOP-wasteful (the factors are <0.1% dense).
This is the regime the reference serves with its MPI stored-CSR matvec
(/root/reference/ED_HAMILTONIAN_SPARSE_HxV.f90:230-315) — e.g. the 2x2
plaquette + 3 replica baths: Ns=16, C(16,8)=12870 per spin factor, sector
dim 1.7e8 (ED_SETUP.f90:139-154).

Element-scattered gathers are slow, but the one-hop structure of the spin
factors clusters: in combinadic state ordering a single-bit hop is a
monotone rank map, so nonzeros concentrate in few 128x128 blocks (the
Ns=16 factor has 1,483 populated tiles of 10,201 — a 6.9x FLOP cut over
dense with 97 MB of f32 tiles).  The factors are therefore stored as a
flat list of dense 128x128 tiles sorted by row block, with their row-
and column-block indices, and applied as tile products: gather the source
row-blocks (contiguous [128, N] slices), one batched ``dot_general`` over
the tiles, and a one-hot contraction that sums them into their row blocks.
A hand-written Pallas (Triton) kernel of this SpMM was measured faster per
SpMM on an H100 but slower end to end in the Ns=16 solve, and removed.

Both sides of the tensor product use row-block form: ``H_dw @ X`` runs in
the natural [DimDw, DimUp] layout; ``X @ H_upT`` runs as ``H_up @ Xt`` in
the transposed layout (two cheap on-device transposes instead of a
minor-axis gather).

The sector vector layout, padding contract (+1e6 decoupled diagonal modes)
and the (dev, dim_p, embed, extract) kit interface match ops/split.py, so
the eigensolvers and the GF stage dispatch here transparently.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .sector_ham import EllMatrix, SectorOperator
from .split import op_is_real, _PAD_DIAG, embed_real, extract_real

jax.config.update("jax_enable_x64", True)

B = 128               # tile edge
_PREC = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# host-side block-ELL build
# ---------------------------------------------------------------------------

@dataclass
class BlockFactor:
    """One spin factor in block-sparse form (host arrays): a flat tile
    list sorted by (row block, column block), with its CSR row pointer."""
    nb: int                 # number of row/col blocks (square factor)
    row_blk: np.ndarray     # [T] i32 tile row-block index (sorted)
    col_blk: np.ndarray     # [T] i32 tile col-block index
    tiles: np.ndarray       # [T, B, B] factor dtype
    nnz: int


def block_factor_of(ell: EllMatrix, real: bool, dtype=np.float32
                    ) -> BlockFactor:
    """Block-sparse form of a (possibly complex) ELL factor.  ``real=True``
    keeps one plane; complex factors are built per-plane by the caller."""
    m = ell.n
    k = ell.cols.shape[1]
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = ell.cols.ravel().astype(np.int64)
    vals = ell.vals.ravel()
    nz = vals != 0
    return block_factor_of_coo(m, rows[nz], cols[nz], vals[nz], real,
                               dtype)


def block_factor_of_coo(m: int, rows, cols, vals, real: bool,
                        dtype=np.float32) -> BlockFactor:
    """Block-sparse factor from COO triplets (also the entry point for the
    hierarchical kit's cross-hop tiles, ops/hier_dev.py)."""
    nb = -(-m // B)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    rb, cb = rows // B, cols // B
    key = rb * nb + cb
    order = np.argsort(key, kind="stable")
    rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
    uniq = np.unique(key)
    t = len(uniq)
    row_blk = (uniq // nb).astype(np.int32)
    col_blk = (uniq % nb).astype(np.int32)
    tiles = np.zeros((t, B, B), dtype if real else np.complex128)
    tid = np.searchsorted(uniq, key)
    np.add.at(tiles, (tid, rows % B, cols % B),
              vals.real if real else vals)
    return BlockFactor(nb=nb, row_blk=row_blk, col_blk=col_blk,
                       tiles=tiles, nnz=int(len(rows)))


# ---------------------------------------------------------------------------
# device operator pytrees
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class LargeRealOp:
    """REAL sector Hamiltonian with block-sparse spin factors."""
    diag: jax.Array        # [Ddp, Dup]
    dw_rb: jax.Array       # [Td] i32
    dw_cb: jax.Array
    dw_tiles: jax.Array    # [Td, B, B]
    up_rb: jax.Array       # [Tu] i32 (H_up row blocks, applied to Xt)
    up_cb: jax.Array
    up_tiles: jax.Array
    nd_amp: jax.Array      # [T]
    nd_up_src: jax.Array   # [T, Dup] i32 (padded: -1)
    nd_up_sgn: jax.Array   # [T, Dup] i8
    nd_dw_src: jax.Array
    nd_dw_sgn: jax.Array

    def tree_flatten(self):
        return ((self.diag, self.dw_rb, self.dw_cb,
                 self.dw_tiles, self.up_rb, self.up_cb,
                 self.up_tiles, self.nd_amp, self.nd_up_src,
                 self.nd_up_sgn, self.nd_dw_src, self.nd_dw_sgn), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class LargePairOp:
    """Complex sector Hamiltonian, split tiles (re/im + Karatsuba sum)."""
    diag: jax.Array
    dw_rb: jax.Array
    dw_cb: jax.Array
    dw_tr: jax.Array
    dw_ti: jax.Array
    dw_ts: jax.Array       # tr + ti (3-mult complex product)
    up_rb: jax.Array
    up_cb: jax.Array
    up_tr: jax.Array
    up_ti: jax.Array
    up_ts: jax.Array
    nd_amp_r: jax.Array
    nd_amp_i: jax.Array
    nd_up_src: jax.Array
    nd_up_sgn: jax.Array
    nd_dw_src: jax.Array
    nd_dw_sgn: jax.Array

    def tree_flatten(self):
        return ((self.diag, self.dw_rb, self.dw_cb, self.dw_tr,
                 self.dw_ti, self.dw_ts, self.up_rb, self.up_cb,
                 self.up_tr, self.up_ti, self.up_ts, self.nd_amp_r,
                 self.nd_amp_i, self.nd_up_src, self.nd_up_sgn,
                 self.nd_dw_src, self.nd_dw_sgn), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _nd_maps(op: SectorOperator, dup: int, ddp: int):
    t = len(op.nd_terms)
    amp = np.array([x.amp for x in op.nd_terms]) if t else np.zeros(0)
    us = np.full((t, dup), -1, np.int32)
    ug = np.zeros((t, dup), np.int8)
    ds = np.full((t, ddp), -1, np.int32)
    dg = np.zeros((t, ddp), np.int8)
    for i, term in enumerate(op.nd_terms):
        us[i, :len(term.up_src)] = term.up_src
        ug[i, :len(term.up_sgn)] = term.up_sgn
        ds[i, :len(term.dw_src)] = term.dw_src
        dg[i, :len(term.dw_sgn)] = term.dw_sgn
    return amp, us, ug, ds, dg


def _padded_diag(op: SectorOperator, ddp: int, dup: int) -> np.ndarray:
    d = np.full((ddp, dup), _PAD_DIAG)
    d[:op.dim_dw, :op.dim_up] = op.diag()
    return d


def to_device_large_real(op: SectorOperator, dtype=jnp.float32,
                         reuse: "LargeRealOp" = None) -> LargeRealOp:
    """``dtype=jnp.bfloat16`` stores only the TILES in bf16 (tensor-core
    rate, f32 accumulation in the kernel); the diagonal and Jx/Jp
    amplitudes stay f32 — they are elementwise (cheap) and carry the
    dominant energy scale.  ``reuse`` shares the diagonal, index and
    nd arrays of an existing same-shape device op (the padded diagonal
    alone is 668 MB at Ns=16)."""
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    vdt = jnp.float32 if dtype == jnp.bfloat16 else dtype
    fu = block_factor_of(op.h_up, real=True, dtype=np_dtype)
    fd = block_factor_of(op.h_dw, real=True, dtype=np_dtype)
    dup, ddp = fu.nb * B, fd.nb * B
    if reuse is not None:
        return LargeRealOp(
            diag=reuse.diag,
            dw_rb=reuse.dw_rb, dw_cb=reuse.dw_cb,
            dw_tiles=jnp.asarray(fd.tiles, dtype),
            up_rb=reuse.up_rb, up_cb=reuse.up_cb,
            up_tiles=jnp.asarray(fu.tiles, dtype),
            nd_amp=reuse.nd_amp,
            nd_up_src=reuse.nd_up_src, nd_up_sgn=reuse.nd_up_sgn,
            nd_dw_src=reuse.nd_dw_src, nd_dw_sgn=reuse.nd_dw_sgn)
    amp, us, ug, ds, dg = _nd_maps(op, dup, ddp)
    return LargeRealOp(
        diag=jnp.asarray(_padded_diag(op, ddp, dup), vdt),
        dw_rb=jnp.asarray(fd.row_blk), dw_cb=jnp.asarray(fd.col_blk),
        dw_tiles=jnp.asarray(fd.tiles, dtype),
        up_rb=jnp.asarray(fu.row_blk), up_cb=jnp.asarray(fu.col_blk),
        up_tiles=jnp.asarray(fu.tiles, dtype),
        nd_amp=jnp.asarray(amp.real, vdt),
        nd_up_src=jnp.asarray(us), nd_up_sgn=jnp.asarray(ug),
        nd_dw_src=jnp.asarray(ds), nd_dw_sgn=jnp.asarray(dg))


def to_device_large_pair(op: SectorOperator, dtype=jnp.float32,
                         reuse: "LargePairOp" = None) -> LargePairOp:
    """``dtype=jnp.bfloat16``: bf16 tiles, f32 diagonal/amplitudes;
    ``reuse`` shares the non-tile arrays of an existing same-shape
    device op (see :func:`to_device_large_real`)."""
    fu = block_factor_of(op.h_up, real=False)
    fd = block_factor_of(op.h_dw, real=False)
    dup, ddp = fu.nb * B, fd.nb * B
    vdt = jnp.float32 if dtype == jnp.bfloat16 else dtype

    def planes(t):
        return (jnp.asarray(t.real, dtype), jnp.asarray(t.imag, dtype),
                jnp.asarray(t.real + t.imag, dtype))

    dw_tr, dw_ti, dw_ts = planes(fd.tiles)
    up_tr, up_ti, up_ts = planes(fu.tiles)
    if reuse is not None:
        return LargePairOp(
            diag=reuse.diag,
            dw_rb=reuse.dw_rb, dw_cb=reuse.dw_cb,
            dw_tr=dw_tr, dw_ti=dw_ti, dw_ts=dw_ts,
            up_rb=reuse.up_rb, up_cb=reuse.up_cb,
            up_tr=up_tr, up_ti=up_ti, up_ts=up_ts,
            nd_amp_r=reuse.nd_amp_r, nd_amp_i=reuse.nd_amp_i,
            nd_up_src=reuse.nd_up_src, nd_up_sgn=reuse.nd_up_sgn,
            nd_dw_src=reuse.nd_dw_src, nd_dw_sgn=reuse.nd_dw_sgn)
    amp, us, ug, ds, dg = _nd_maps(op, dup, ddp)
    return LargePairOp(
        diag=jnp.asarray(_padded_diag(op, ddp, dup), vdt),
        dw_rb=jnp.asarray(fd.row_blk), dw_cb=jnp.asarray(fd.col_blk),
        dw_tr=dw_tr, dw_ti=dw_ti, dw_ts=dw_ts,
        up_rb=jnp.asarray(fu.row_blk), up_cb=jnp.asarray(fu.col_blk),
        up_tr=up_tr, up_ti=up_ti, up_ts=up_ts,
        nd_amp_r=jnp.asarray(amp.real, vdt),
        nd_amp_i=jnp.asarray(amp.imag, vdt),
        nd_up_src=jnp.asarray(us), nd_up_sgn=jnp.asarray(ug),
        nd_dw_src=jnp.asarray(ds), nd_dw_sgn=jnp.asarray(dg))


# ---------------------------------------------------------------------------
# block-sparse SpMM
# ---------------------------------------------------------------------------

def _blk_spmm_xla(rb, cb, tiles, x, nb_out: int, chunk: int = None):
    """y[nb_out*B, N] = Sum_t scatter(rb[t]) tiles[t] @ x[cb[t]*B:..., :].

    Gather granularity is a full [B, chunk] row-block slice; the per-tile
    products are summed into their row blocks by a one-hot [T, nb_out]
    contraction (a GEMM; a scatter-add segment sum took minutes to compile
    at the Ns=16 shape on the GPU)."""
    m_src, n = x.shape
    nb_src = m_src // B
    if chunk is None:
        # the [T, B, chunk] product temp: halve the chunk for f64 so it
        # stays ~1 GB at the Ns=16 tile count
        chunk = 128 if tiles.dtype == jnp.float64 else 512
    seg = jax.nn.one_hot(rb, nb_out, dtype=tiles.dtype)   # [T, nb_out]

    def apply_chunk(xc):                                  # [m_src, c]
        g = xc.reshape(nb_src, B, -1)[cb]                 # [T, B, c]
        y = jax.lax.dot_general(
            tiles, g, (((2,), (1,)), ((0,), (0,))),
            precision=_PREC)                              # [T, B, c]
        return jnp.einsum("tr,tbc->rbc", seg, y,
                          precision=_PREC).reshape(nb_out * B, -1)

    if n <= chunk or m_src * n <= 1 << 22:
        return apply_chunk(x)
    nch = -(-n // chunk)
    npad = nch * chunk - n
    xp = jnp.pad(x, ((0, 0), (0, npad))) if npad else x

    def f(j):
        return apply_chunk(jax.lax.dynamic_slice(
            xp, (0, j * chunk), (m_src, chunk)))

    ys = jax.lax.map(f, jnp.arange(nch))                  # [nch, M, c]
    out = jnp.moveaxis(ys, 0, 1).reshape(nb_out * B, nch * chunk)
    return out[:, :n] if npad else out


def _blk_spmm(rb, cb, tiles, x, nb_out: int):
    """Block-sparse SpMM; bf16 tiles are upcast to the x dtype (f32 when x
    is bf16 too), so every product accumulates at f32 or better."""
    if tiles.dtype == jnp.bfloat16:
        acc = x.dtype if x.dtype != jnp.bfloat16 else jnp.float32
        return _blk_spmm_xla(rb, cb, tiles.astype(acc),
                             x.astype(acc), nb_out)
    return _blk_spmm_xla(rb, cb, tiles, x, nb_out)


# ---------------------------------------------------------------------------
# matvecs
# ---------------------------------------------------------------------------

def _nd_apply_real(x, xt, nd_amp, us, ug, ds, dg):
    """Jx/Jp Kronecker terms via row gathers in both layouts: the up factor
    is applied on xt (row gather over up), transposed back, then the dw
    factor as a row gather over dw."""
    out = jnp.zeros_like(x)
    tcount = nd_amp.shape[0]
    for ti in range(tcount):
        tu = xt[jnp.maximum(us[ti], 0)] * ug[ti][:, None].astype(x.dtype)
        tud = tu.T                                    # [Ddp, Dup]
        y = tud[jnp.maximum(ds[ti], 0)] * dg[ti][:, None].astype(x.dtype)
        out = out + nd_amp[ti] * y
    return out


def matvec_large_real(op: LargeRealOp, x: jax.Array) -> jax.Array:
    """H·x for a REAL large-sector H, x [Ddp, Dup]: two block-sparse SpMMs
    (dw in natural layout, up in transposed layout) + fused diagonal."""
    nb_d = op.diag.shape[0] // B
    nb_u = op.diag.shape[1] // B
    out = op.diag * x
    out = out + _blk_spmm(op.dw_rb, op.dw_cb, op.dw_tiles, x,
                          nb_d)
    xt = x.T
    yt = _blk_spmm(op.up_rb, op.up_cb, op.up_tiles, xt, nb_u)
    out = out + yt.T
    if op.nd_amp.shape[0]:
        out = out + _nd_apply_real(x, xt, op.nd_amp, op.nd_up_src,
                                   op.nd_up_sgn, op.nd_dw_src,
                                   op.nd_dw_sgn)
    return out


def matvec_large_pair(op: LargePairOp, xr: jax.Array, xi: jax.Array):
    """Complex H on the split pair: 3-mult (Karatsuba) block-sparse SpMMs
    per side — 6 SpMM passes per H·v, mirroring split.matvec_dense_pair."""
    nb_d = op.diag.shape[0] // B
    nb_u = op.diag.shape[1] // B
    xs = xr + xi
    p1 = _blk_spmm(op.dw_rb, op.dw_cb, op.dw_tr, xr, nb_d)
    p2 = _blk_spmm(op.dw_rb, op.dw_cb, op.dw_ti, xi, nb_d)
    p3 = _blk_spmm(op.dw_rb, op.dw_cb, op.dw_ts, xs, nb_d)
    xrt, xit, xst = xr.T, xi.T, xs.T
    q1 = _blk_spmm(op.up_rb, op.up_cb, op.up_tr, xrt, nb_u).T
    q2 = _blk_spmm(op.up_rb, op.up_cb, op.up_ti, xit, nb_u).T
    q3 = _blk_spmm(op.up_rb, op.up_cb, op.up_ts, xst, nb_u).T
    out_r = op.diag * xr + (p1 - p2) + (q1 - q2)
    out_i = op.diag * xi + (p3 - p1 - p2) + (q3 - q1 - q2)
    tcount = op.nd_amp_r.shape[0]
    if tcount:
        yr = _nd_apply_real(xr, xrt, op.nd_amp_r, op.nd_up_src,
                            op.nd_up_sgn, op.nd_dw_src, op.nd_dw_sgn)
        yi = _nd_apply_real(xi, xit, op.nd_amp_r, op.nd_up_src,
                            op.nd_up_sgn, op.nd_dw_src, op.nd_dw_sgn)
        # imag amplitude part
        zr = _nd_apply_real(xr, xrt, op.nd_amp_i, op.nd_up_src,
                            op.nd_up_sgn, op.nd_dw_src, op.nd_dw_sgn)
        zi = _nd_apply_real(xi, xit, op.nd_amp_i, op.nd_up_src,
                            op.nd_up_sgn, op.nd_dw_src, op.nd_dw_sgn)
        out_r = out_r + yr - zi
        out_i = out_i + yi + zr
    return out_r, out_i


@functools.partial(jax.jit, static_argnames=("nch",))
def _matvec_large_real_lowmem_jit(diag, dw_rb, dw_cb, dw_tiles, up_rb,
                                  up_cb, up_tiles, x, nch: int):
    ddp, dup = x.shape
    nb_d, nb_u = ddp // B, dup // B
    cw = dup // nch                   # dw-side column chunk
    rw = ddp // nch                   # up-side row chunk
    out = diag * x

    def dw_body(i, acc):
        xc = jax.lax.dynamic_slice(x, (0, i * cw), (ddp, cw))
        yc = _blk_spmm_xla(dw_rb, dw_cb, dw_tiles, xc, nb_d)
        upd = jax.lax.dynamic_slice(acc, (0, i * cw), (ddp, cw)) + yc
        return jax.lax.dynamic_update_slice(acc, upd, (0, i * cw))

    out = jax.lax.fori_loop(0, nch, dw_body, out)

    def up_body(i, acc):
        xr = jax.lax.dynamic_slice(x, (i * rw, 0), (rw, dup))
        yr = _blk_spmm_xla(up_rb, up_cb, up_tiles, xr.T, nb_u).T
        upd = jax.lax.dynamic_slice(acc, (i * rw, 0), (rw, dup)) + yr
        return jax.lax.dynamic_update_slice(acc, upd, (i * rw, 0))

    return jax.lax.fori_loop(0, nch, up_body, out)


def matvec_large_real_lowmem(op: LargeRealOp, x: jax.Array,
                             nch: int = None) -> jax.Array:
    """Memory-lean H·x for a REAL large-sector H (no Jx/Jp terms): the
    two block-sparse sides run in column/row chunks inside one jit, so
    peak extra memory is O(dim/nch) instead of several full-plane temps
    (each full f64 plane is 1.34 GB at Ns=16 and the eager formulation's
    transposes/stacked maps hold 4-6 of them)."""
    assert op.nd_amp.shape[0] == 0, "lowmem path: no Jx/Jp terms"
    ddp, dup = x.shape
    if nch is None:
        nch = 1
        # chunk so a [T, B, chunk] f64 gather temp stays ~0.5 GB
        t = max(op.dw_tiles.shape[0], op.up_tiles.shape[0])
        while (max(ddp, dup) // nch) * t * B * 8 > 5e8 \
                and max(ddp, dup) % (nch * 2) == 0:
            nch *= 2
    return _matvec_large_real_lowmem_jit(
        op.diag, op.dw_rb, op.dw_cb, op.dw_tiles, op.up_rb, op.up_cb,
        op.up_tiles, x, nch)


def apply_large_real_flat_lowmem(dev: LargeRealOp, x: jax.Array):
    return matvec_large_real_lowmem(dev, x.reshape(dev.diag.shape)) \
        .reshape(-1)


# -- flat pure appliers (operator passed as pytree argument) ---------------

def apply_large_real_flat(dev: LargeRealOp, x: jax.Array) -> jax.Array:
    return matvec_large_real(dev, x.reshape(dev.diag.shape)).reshape(-1)


def apply_large_pair_flat(dev: LargePairOp, xr: jax.Array, xi: jax.Array):
    sh = dev.diag.shape
    wr, wi = matvec_large_pair(dev, xr.reshape(sh), xi.reshape(sh))
    return wr.reshape(-1), wi.reshape(-1)


# ---------------------------------------------------------------------------
# kits (same interface as split.build_real_padded / build_pair_padded)
# ---------------------------------------------------------------------------

def _embed_any(v, dd, du, ddp, dup):
    """Pad a flat [*, dd*du] array to [*, ddp*dup]; device arrays stay on
    device (no host round-trip for large-sector vectors)."""
    if isinstance(v, jax.Array):
        lead = v.shape[:-1]
        v2 = v.reshape(lead + (dd, du))
        pads = [(0, 0)] * len(lead) + [(0, ddp - dd), (0, dup - du)]
        return jnp.pad(v2, pads).reshape(lead + (ddp * dup,))
    return embed_real(v, dd, du, ddp, dup)


def _extract_any(v, dd, du, ddp, dup):
    if isinstance(v, jax.Array):
        lead = v.shape[:-1]
        return v.reshape(lead + (ddp, dup))[..., :dd, :du] \
            .reshape(lead + (dd * du,))
    return extract_real(v, dd, du, ddp, dup)


def build_real_padded_large(op: SectorOperator, dtype=jnp.float32,
                            reuse=None):
    """(dev, dim_p, embed, extract) or None when the operator is complex."""
    if not op_is_real(op):
        return None
    dev = to_device_large_real(op, dtype=dtype, reuse=reuse)
    ddp, dup = dev.diag.shape
    dd, du = op.dim_dw, op.dim_up

    def embed(v):
        return _embed_any(v, dd, du, ddp, dup)

    def extract(v):
        return _extract_any(v, dd, du, ddp, dup)

    return dev, ddp * dup, embed, extract


def build_pair_padded_large(op: SectorOperator, dtype=jnp.float32,
                            reuse=None):
    """(dev, real_flag, dim_p, embed, extract): real_flag mirrors
    split.build_pair_padded (a real op still gets the pair applier via the
    one-plane kernel on each plane)."""
    real = op_is_real(op)
    if real:
        dev = to_device_large_real(op, dtype=dtype, reuse=reuse)
    else:
        dev = to_device_large_pair(op, dtype=dtype, reuse=reuse)
    ddp, dup = dev.diag.shape
    dd, du = op.dim_dw, op.dim_up

    def embed(v):
        return _embed_any(v, dd, du, ddp, dup)

    def extract(v):
        return _extract_any(v, dd, du, ddp, dup)

    return dev, real, ddp * dup, embed, extract


def apply_large_realpair_flat(dev: LargeRealOp, xr, xi):
    """Real large H on a complex pair: planes never mix."""
    return apply_large_real_flat(dev, xr), apply_large_real_flat(dev, xi)


# ---------------------------------------------------------------------------
# explicitly-batched appliers (GF injection batches)
#
# The batched GF tridiagonalisation would vmap the single-vector applier;
# for the block-sparse kernels the batch is instead FOLDED into the SpMM
# minor axis — one wider SpMM per side instead of B narrow ones.
# ---------------------------------------------------------------------------

def _batched_matvec_real(dev: LargeRealOp, x3: jax.Array) -> jax.Array:
    """x3 [Bb, Ddp, Dup] -> H·x per batch row."""
    bb, ddp, dup = x3.shape
    nb_d, nb_u = ddp // B, dup // B
    out = dev.diag[None] * x3
    # dw side: minor axis = (up, batch)
    x_dw = jnp.moveaxis(x3, 0, -1).reshape(ddp, dup * bb)
    y_dw = _blk_spmm(dev.dw_rb, dev.dw_cb, dev.dw_tiles, x_dw,
                     nb_d).reshape(ddp, dup, bb)
    out = out + jnp.moveaxis(y_dw, -1, 0)
    # up side: minor axis = (dw, batch)
    x_up = x3.transpose(2, 1, 0).reshape(dup, ddp * bb)
    y_up = _blk_spmm(dev.up_rb, dev.up_cb, dev.up_tiles, x_up,
                     nb_u).reshape(dup, ddp, bb)
    out = out + y_up.transpose(2, 1, 0)
    if dev.nd_amp.shape[0]:
        out = out + jax.vmap(
            lambda x: _nd_apply_real(x, x.T, dev.nd_amp, dev.nd_up_src,
                                     dev.nd_up_sgn, dev.nd_dw_src,
                                     dev.nd_dw_sgn))(x3)
    return out


def apply_large_real_flat_batched(dev: LargeRealOp, x: jax.Array):
    """x [Bb, dim_p] -> [Bb, dim_p]; batch folded into the SpMM width."""
    bb = x.shape[0]
    ddp, dup = dev.diag.shape
    return _batched_matvec_real(dev, x.reshape(bb, ddp, dup)) \
        .reshape(bb, -1)


def apply_large_realpair_flat_batched(dev: LargeRealOp, xr, xi):
    return (apply_large_real_flat_batched(dev, xr),
            apply_large_real_flat_batched(dev, xi))


def apply_large_pair_flat_batched(dev: LargePairOp, xr, xi):
    """Complex large H on batched split pairs (Karatsuba, batch folded
    into the SpMM width)."""
    bb = xr.shape[0]
    ddp, dup = dev.diag.shape
    nb_d, nb_u = ddp // B, dup // B
    x3r = xr.reshape(bb, ddp, dup)
    x3i = xi.reshape(bb, ddp, dup)
    x3s = x3r + x3i

    def dw_side(tiles, x3):
        xf = jnp.moveaxis(x3, 0, -1).reshape(ddp, dup * bb)
        y = _blk_spmm(dev.dw_rb, dev.dw_cb, tiles, xf,
                      nb_d).reshape(ddp, dup, bb)
        return jnp.moveaxis(y, -1, 0)

    def up_side(tiles, x3):
        xf = x3.transpose(2, 1, 0).reshape(dup, ddp * bb)
        y = _blk_spmm(dev.up_rb, dev.up_cb, tiles, xf,
                      nb_u).reshape(dup, ddp, bb)
        return y.transpose(2, 1, 0)

    p1 = dw_side(dev.dw_tr, x3r)
    p2 = dw_side(dev.dw_ti, x3i)
    p3 = dw_side(dev.dw_ts, x3s)
    q1 = up_side(dev.up_tr, x3r)
    q2 = up_side(dev.up_ti, x3i)
    q3 = up_side(dev.up_ts, x3s)
    out_r = dev.diag[None] * x3r + (p1 - p2) + (q1 - q2)
    out_i = dev.diag[None] * x3i + (p3 - p1 - p2) + (q3 - q1 - q2)
    if dev.nd_amp_r.shape[0]:
        def nd(amp, x3):
            return jax.vmap(
                lambda x: _nd_apply_real(x, x.T, amp, dev.nd_up_src,
                                         dev.nd_up_sgn, dev.nd_dw_src,
                                         dev.nd_dw_sgn))(x3)
        yr = nd(dev.nd_amp_r, x3r)
        yi = nd(dev.nd_amp_r, x3i)
        zr = nd(dev.nd_amp_i, x3r)
        zi = nd(dev.nd_amp_i, x3i)
        out_r = out_r + yr - zi
        out_i = out_i + yi + zr
    return out_r.reshape(bb, -1), out_i.reshape(bb, -1)
