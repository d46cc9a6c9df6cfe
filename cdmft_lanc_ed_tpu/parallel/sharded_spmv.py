"""Sharded sector H·v: the multi-chip hot kernel.

JAX re-design of the reference's MPI-parallel matvec
(/root/reference/ED_HAMILTONIAN_SPARSE_HxV.f90:230-315 and the AllToAllV
transpose ED_HAMILTONIAN_COMMON.f90:30-101): the sector vector, viewed as the
matrix ``v[DimDw, DimUp]``, is sharded along the dw axis over a 1-D device
mesh.  The tensor-product structure maps onto the mesh exactly like
Ulysses-style sequence parallelism (SURVEY.md section 5.7):

* ``I (x) H_up`` — row-gather along the **up** axis: local on every shard;
* ``H_dw (x) I`` — requires the dw axis: the vector is transposed with ONE
  ``jax.lax.all_to_all`` (ICI), the gather applied locally in transposed
  layout, and transposed back with a second all-to-all;
* the diagonal is elementwise-local;
* the Jx/Jp Kronecker-factor terms fold into the same two all-to-alls (the
  up factor is applied before the transpose, the dw factor while transposed)
  — the reference instead allgathers the FULL vector for these terms
  (ED_HAMILTONIAN_SPARSE_HxV.f90:299-313).

Shapes are padded to multiples of the mesh size on host so every shard is
static — no communicator shrinking (the reference's MPI_Group_Incl dance,
ED_HAMILTONIAN.f90:62-89): tiny sectors are solved on a single chip or
batched instead (see sector scheduler).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.sector_ham import SectorOperator
from ..ops.spmv import DeviceSectorOp

jax.config.update("jax_enable_x64", True)


def _pad_to(x: np.ndarray, axis: int, mult: int, fill=0):
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def pad_device_op(op: SectorOperator, ndev: int,
                  dtype=jnp.complex128) -> DeviceSectorOp:
    """Host-side padded device operator: DimDw and DimUp padded to multiples
    of ``ndev``.  Padded rows have zero diagonal/values so they contribute
    nothing; gather indices in the padded range point at row 0 (zero vals)."""
    rdtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    diag = _pad_to(_pad_to(op.diag(), 0, ndev), 1, ndev)
    up_cols = _pad_to(op.h_up.cols, 0, ndev)
    up_vals = _pad_to(op.h_up.vals, 0, ndev)
    dw_cols = _pad_to(op.h_dw.cols, 0, ndev)
    dw_vals = _pad_to(op.h_dw.vals, 0, ndev)
    t = len(op.nd_terms)
    if t:
        nd_amp = np.array([x.amp for x in op.nd_terms])
        nd_us = _pad_to(np.stack([x.up_src for x in op.nd_terms]), 1, ndev)
        nd_ug = _pad_to(np.stack([x.up_sgn for x in op.nd_terms]), 1, ndev)
        nd_ds = _pad_to(np.stack([x.dw_src for x in op.nd_terms]), 1, ndev)
        nd_dg = _pad_to(np.stack([x.dw_sgn for x in op.nd_terms]), 1, ndev)
    else:
        du = diag.shape[1]
        dd = diag.shape[0]
        nd_amp = np.zeros(0, np.complex128)
        nd_us = np.zeros((0, du), np.int32)
        nd_ug = np.zeros((0, du), np.int8)
        nd_ds = np.zeros((0, dd), np.int32)
        nd_dg = np.zeros((0, dd), np.int8)
    return DeviceSectorOp(
        diag=jnp.asarray(diag, rdtype),
        up_cols=jnp.asarray(up_cols, jnp.int32),
        up_vals=jnp.asarray(up_vals, dtype),
        dw_cols=jnp.asarray(dw_cols, jnp.int32),
        dw_vals=jnp.asarray(dw_vals, dtype),
        nd_amp=jnp.asarray(nd_amp, dtype),
        nd_up_src=jnp.asarray(nd_us, jnp.int32),
        nd_up_sgn=jnp.asarray(nd_ug, jnp.int8),
        nd_dw_src=jnp.asarray(nd_ds, jnp.int32),
        nd_dw_sgn=jnp.asarray(nd_dg, jnp.int8),
    )


def shard_local_kernel(axis: str):
    """Per-shard H·v body used by both the single-sector and the batched
    (sector-parallel) sharded matvecs.  v is the local [dw_loc, DimUp]
    block; collectives run over mesh axis ``axis``."""

    def kernel(diag, up_cols, up_vals, dw_cols, dw_vals, nd_amp,
               nd_up_src, nd_up_sgn, nd_dw_src, nd_dw_sgn, v):
        out = diag.astype(v.dtype) * v
        g = v[:, up_cols]                                 # [dw_loc, R, K]
        out = out + jnp.einsum("rk,drk->dr", up_vals, g)
        tcount = nd_amp.shape[0]
        if tcount:
            def up_fac(usrc, usgn):
                return v[:, jnp.maximum(usrc, 0)] \
                    * usgn[None, :].astype(v.dtype)
            t_up = jax.vmap(up_fac)(nd_up_src, nd_up_sgn)
            payload = jnp.concatenate([v[None], t_up], axis=0)
        else:
            payload = v[None]
        # all-to-all transpose (the MPI AllToAllV analog,
        # ED_HAMILTONIAN_COMMON.f90:30-101)
        pt = jax.lax.all_to_all(payload, axis, split_axis=2,
                                concat_axis=1, tiled=True)
        vt = pt[0]                                        # [DimDw, up_loc]
        gt = vt[dw_cols]                                  # [DimDw, K, up_loc]
        yt = jnp.einsum("rk,rkc->rc", dw_vals, gt)        # [DimDw, up_loc]
        if tcount:
            def dw_fac(t_i, dsrc, dsgn, amp):
                return amp * t_i[jnp.maximum(dsrc, 0)] \
                    * dsgn[:, None].astype(t_i.dtype)
            y_nd = jax.vmap(dw_fac)(pt[1:], nd_dw_src, nd_dw_sgn, nd_amp)
            yt = yt + y_nd.sum(axis=0)
        # transpose back
        y = jax.lax.all_to_all(yt[None], axis, split_axis=1,
                               concat_axis=2, tiled=True)[0]
        return out + y

    return kernel


def make_sharded_matvec(op: DeviceSectorOp, mesh: Mesh, axis: str = "dw"):
    """Returns (matvec, sharding): ``matvec`` maps v [DimDw_p, DimUp_p]
    (sharded ``P(axis, None)``) to H·v with the same sharding; compiled once
    per sector shape.  Implements the two-all-to-all transpose scheme."""
    ndev = mesh.shape[axis]
    dd, du = op.diag.shape
    assert dd % ndev == 0 and du % ndev == 0
    sh = NamedSharding(mesh, P(axis, None))

    # Operator data placement: the diagonal is sharded with the vector; the
    # H_up and H_dw ELL blocks are replicated on all shards (exactly like the
    # reference replicates spH0ups/spH0dws on every rank,
    # ED_HAMILTONIAN_SPARSE_HxV.f90:96-110 — they are O(Dim_s * K), tiny
    # relative to the vector).  H_dw must be replicated because it is applied
    # in the TRANSPOSED layout where every shard owns all dw rows.
    spec_of = {
        "diag": P(axis, None),
        "up_cols": P(None, None), "up_vals": P(None, None),
        "dw_cols": P(None, None), "dw_vals": P(None, None),
        "nd_amp": P(None), "nd_up_src": P(None, None),
        "nd_up_sgn": P(None, None),
        "nd_dw_src": P(None, None), "nd_dw_sgn": P(None, None),
    }

    op_sh = DeviceSectorOp(**{
        name: jax.device_put(getattr(op, name), NamedSharding(mesh, spec))
        for name, spec in spec_of.items()})

    kernel = shard_local_kernel(axis)

    # operands as explicit jit arguments: closure-captured device arrays
    # inline as HLO constants (overflows the remote compiler at scale)
    @jax.jit
    def matvec_args(*ops_and_v):
        return jax.shard_map(
            kernel, mesh=mesh,
            in_specs=tuple(spec_of[k] for k in
                           ("diag", "up_cols", "up_vals", "dw_cols",
                            "dw_vals", "nd_amp", "nd_up_src", "nd_up_sgn",
                            "nd_dw_src", "nd_dw_sgn")) + (P(axis, None),),
            out_specs=P(axis, None),
            check_vma=False,
        )(*ops_and_v)

    def matvec(v):
        return matvec_args(
            op_sh.diag, op_sh.up_cols, op_sh.up_vals, op_sh.dw_cols,
            op_sh.dw_vals, op_sh.nd_amp, op_sh.nd_up_src, op_sh.nd_up_sgn,
            op_sh.nd_dw_src, op_sh.nd_dw_sgn, v)

    return matvec, sh


def make_sharded_matvec_dense_pair(op: SectorOperator, mesh: Mesh,
                                   axis: str = "dw"):
    """Sharded dense-factor matvec on the split-pair representation — the
    multi-device matmul hot path (analog of split.matvec_dense_pair).

    The vector pair (xr, xi) [DimDw_p, DimUp] is sharded P(axis, None).
    Per shard: X_loc · H_upᵀ is local matmul; for H_dw · X one all-to-all
    transposes to [DimDw, up_loc], the dw matmul runs locally, and a second
    all-to-all transposes back (ED_HAMILTONIAN_COMMON.f90:30-101 scheme,
    with the gathers replaced by matmuls).  Jx/Jp terms fold in: the up
    factor is applied pre-transpose, the dw factor while transposed.

    Returns (matvec_pair, sharding, (dd_pad, du_pad))."""
    ndev = mesh.shape[axis]
    dd = -(-op.dim_dw // ndev) * ndev
    du = -(-op.dim_up // ndev) * ndev
    P_ = jax.lax.Precision.HIGHEST

    def padded(x, r, c):
        out = np.zeros((r, c), x.dtype)
        out[: x.shape[0], : x.shape[1]] = x
        return out

    hu = op.h_up.to_dense()
    hd = op.h_dw.to_dense()
    diag = padded(op.diag(), dd, du)
    hupT_r = jnp.asarray(padded(np.ascontiguousarray(hu.real.T), du, du))
    hupT_i = jnp.asarray(padded(np.ascontiguousarray(hu.imag.T), du, du))
    hdw_r = jnp.asarray(padded(np.ascontiguousarray(hd.real), dd, dd))
    hdw_i = jnp.asarray(padded(np.ascontiguousarray(hd.imag), dd, dd))
    t = len(op.nd_terms)
    nd_upT = np.zeros((t, du, du))
    nd_dw = np.zeros((t, dd, dd))
    amp_r = np.zeros(t)
    amp_i = np.zeros(t)
    for i, term in enumerate(op.nd_terms):
        iu = np.nonzero(term.up_src >= 0)[0]
        nd_upT[i, term.up_src[iu], iu] = term.up_sgn[iu]
        idw = np.nonzero(term.dw_src >= 0)[0]
        nd_dw[i, idw, term.dw_src[idw]] = term.dw_sgn[idw]
        amp_r[i] = term.amp.real
        amp_i[i] = term.amp.imag

    sh = NamedSharding(mesh, P(axis, None))
    rep2 = NamedSharding(mesh, P(None, None))
    diag_d = jax.device_put(jnp.asarray(diag), sh)
    hupT_r = jax.device_put(hupT_r, rep2)
    hupT_i = jax.device_put(hupT_i, rep2)
    hdw_r = jax.device_put(hdw_r, rep2)
    hdw_i = jax.device_put(hdw_i, rep2)
    nd_upT_d = jax.device_put(jnp.asarray(nd_upT),
                              NamedSharding(mesh, P(None, None, None)))
    nd_dw_d = jax.device_put(jnp.asarray(nd_dw),
                             NamedSharding(mesh, P(None, None, None)))

    def kernel(diag_l, hupT_r, hupT_i, hdw_r, hdw_i, nd_upT, nd_dw,
               xr, xi):
        # local up part + diagonal
        out_r = diag_l * xr + jnp.matmul(xr, hupT_r, precision=P_) \
            - jnp.matmul(xi, hupT_i, precision=P_)
        out_i = diag_l * xi + jnp.matmul(xi, hupT_r, precision=P_) \
            + jnp.matmul(xr, hupT_i, precision=P_)
        # payload: the vector (+ up-factored nd terms), both components
        pay = [xr, xi]
        for ti in range(t):
            pay.append(jnp.matmul(xr, nd_upT[ti], precision=P_))
            pay.append(jnp.matmul(xi, nd_upT[ti], precision=P_))
        payload = jnp.stack(pay)                     # [C, dw_loc, DimUp]
        pt = jax.lax.all_to_all(payload, axis, split_axis=2,
                                concat_axis=1, tiled=True)
        vtr, vti = pt[0], pt[1]                      # [DimDw, up_loc]
        ytr = jnp.matmul(hdw_r, vtr, precision=P_) \
            - jnp.matmul(hdw_i, vti, precision=P_)
        yti = jnp.matmul(hdw_r, vti, precision=P_) \
            + jnp.matmul(hdw_i, vtr, precision=P_)
        for ti in range(t):
            ur = pt[2 + 2 * ti]
            ui = pt[3 + 2 * ti]
            zr = jnp.matmul(nd_dw[ti], ur, precision=P_)
            zi = jnp.matmul(nd_dw[ti], ui, precision=P_)
            ytr = ytr + amp_r[ti] * zr - amp_i[ti] * zi
            yti = yti + amp_r[ti] * zi + amp_i[ti] * zr
        back = jax.lax.all_to_all(jnp.stack([ytr, yti]), axis,
                                  split_axis=1, concat_axis=2, tiled=True)
        return out_r + back[0], out_i + back[1]

    @jax.jit
    def matvec_args(*ops_and_x):
        return jax.shard_map(
            kernel, mesh=mesh,
            in_specs=(P(axis, None), P(None, None), P(None, None),
                      P(None, None), P(None, None), P(None, None, None),
                      P(None, None, None), P(axis, None), P(axis, None)),
            out_specs=(P(axis, None), P(axis, None)),
            check_vma=False,
        )(*ops_and_x)

    def matvec(xr, xi):
        return matvec_args(diag_d, hupT_r, hupT_i, hdw_r, hdw_i,
                           nd_upT_d, nd_dw_d, xr, xi)

    return matvec, sh, (dd, du)


def make_sharded_matvec_dense_real(op: SectorOperator, mesh: Mesh,
                                   axis: str = "dw",
                                   overlap: int = 0):
    """Sharded dense-factor matvec for a REAL sector Hamiltonian on a REAL
    vector plane (multi-chip twin of split.matvec_dense_real): 2
    matmuls per H·v instead of the complex kernel's 6, and the all-to-all
    payload is halved ([1+T] planes instead of [2+2T]).

    ``overlap > 1`` chunks the transpose payload along the up axis into
    that many independent all_to_all -> matmul -> all_to_all chains
    (BASELINE north-star: "halo exchange overlapped with on-chip SpMV").
    The chunks are data-independent, so XLA's async collective scheduler
    can run chunk i's dw-matmul while chunk i+1's all-to-all is on the
    wire — a software double-buffer with no extra memory beyond one chunk.
    Chunking composes with the local up-matmul (issued first, fully
    overlappable) but not with Jx/Jp payload stacking (falls back to the
    single-shot transpose when nd terms are present).
    Returns (matvec_real, sharding, (dd_pad, du_pad))."""
    ndev = mesh.shape[axis]
    dd = -(-op.dim_dw // ndev) * ndev
    du = -(-op.dim_up // ndev) * ndev
    P_ = jax.lax.Precision.HIGHEST

    def padded(x, r, c):
        out = np.zeros((r, c), x.dtype)
        out[: x.shape[0], : x.shape[1]] = x
        return out

    diag = padded(op.diag(), dd, du)
    hupT = jnp.asarray(padded(
        np.ascontiguousarray(op.h_up.to_dense().real.T), du, du))
    hdw = jnp.asarray(padded(
        np.ascontiguousarray(op.h_dw.to_dense().real), dd, dd))
    t = len(op.nd_terms)
    nd_upT = np.zeros((t, du, du))
    nd_dw = np.zeros((t, dd, dd))
    amp = np.zeros(t)
    for i, term in enumerate(op.nd_terms):
        iu = np.nonzero(term.up_src >= 0)[0]
        nd_upT[i, term.up_src[iu], iu] = term.up_sgn[iu]
        idw = np.nonzero(term.dw_src >= 0)[0]
        nd_dw[i, idw, term.dw_src[idw]] = term.dw_sgn[idw]
        amp[i] = complex(term.amp).real

    sh = NamedSharding(mesh, P(axis, None))
    rep2 = NamedSharding(mesh, P(None, None))
    diag_d = jax.device_put(jnp.asarray(diag), sh)
    hupT = jax.device_put(hupT, rep2)
    hdw = jax.device_put(hdw, rep2)
    nd_upT_d = jax.device_put(jnp.asarray(nd_upT),
                              NamedSharding(mesh, P(None, None, None)))
    nd_dw_d = jax.device_put(jnp.asarray(nd_dw),
                             NamedSharding(mesh, P(None, None, None)))

    up_loc = du // ndev
    # overlap is an interconnect lever: on a host-virtual (CPU) mesh the
    # chunked chains only add launches (there is no async collective
    # engine to hide them; overlap=4 ran 1.6x slower than overlap=0 at 8
    # virtual CPU devices), so it auto-disables there and stays opt-in
    # for real multi-device meshes.
    cpu_virtual = all(d.platform == "cpu" for d in mesh.devices.flat)
    nchunk = overlap if (overlap > 1 and t == 0 and not cpu_virtual
                         and up_loc % overlap == 0) else 1

    def kernel(diag_l, hupT, hdw, nd_upT, nd_dw, x):
        out = diag_l * x + jnp.matmul(x, hupT, precision=P_)
        if nchunk > 1:
            # chunked transpose: C independent a2a -> matmul -> a2a
            # chains; the up axis is viewed as [ndev, up_loc] so chunk c
            # carries columns [c0:c1) of EVERY device slice and lands
            # contiguous in the transposed layout.
            dw_loc = x.shape[0]
            w = up_loc // nchunk
            x3 = x.reshape(dw_loc, ndev, up_loc)
            parts = []
            for c in range(nchunk):
                xc = jax.lax.slice_in_dim(x3, c * w, (c + 1) * w, axis=2) \
                    .reshape(dw_loc, ndev * w)
                pt = jax.lax.all_to_all(xc[None], axis, split_axis=2,
                                        concat_axis=1, tiled=True)[0]
                yt = jnp.matmul(hdw, pt, precision=P_)     # [DimDw, w]
                bc = jax.lax.all_to_all(yt[None], axis, split_axis=1,
                                        concat_axis=2, tiled=True)[0]
                parts.append(bc.reshape(dw_loc, ndev, w))
            back = jnp.concatenate(parts, axis=2).reshape(dw_loc, du)
            return out + back
        pay = [x] + [jnp.matmul(x, nd_upT[ti], precision=P_)
                     for ti in range(t)]
        pt = jax.lax.all_to_all(jnp.stack(pay), axis, split_axis=2,
                                concat_axis=1, tiled=True)
        yt = jnp.matmul(hdw, pt[0], precision=P_)
        for ti in range(t):
            yt = yt + amp[ti] * jnp.matmul(nd_dw[ti], pt[1 + ti],
                                           precision=P_)
        back = jax.lax.all_to_all(yt[None], axis, split_axis=1,
                                  concat_axis=2, tiled=True)[0]
        return out + back

    @jax.jit
    def matvec_args(*ops_and_x):
        return jax.shard_map(
            kernel, mesh=mesh,
            in_specs=(P(axis, None), P(None, None), P(None, None),
                      P(None, None, None), P(None, None, None),
                      P(axis, None)),
            out_specs=P(axis, None),
            check_vma=False,
        )(*ops_and_x)

    def matvec(x):
        return matvec_args(diag_d, hupT, hdw, nd_upT_d, nd_dw_d, x)

    return matvec, sh, (dd, du)


def sharded_matvec_real_flat(op: SectorOperator, mesh: Mesh,
                             axis: str = "dw", overlap: int = 0):
    """Flat real matvec [dim] -> [dim] over the sharded real dense-factor
    kernel, or None when the sector Hamiltonian is not real — plugs into
    lanczos_eigh_real so the whole eigensolve runs sharded."""
    from ..ops.split import op_is_real
    if not op_is_real(op):
        return None
    mv2d, sh, (ddp, dup) = make_sharded_matvec_dense_real(
        op, mesh, axis, overlap=overlap)
    dd, du = op.dim_dw, op.dim_up

    def mv(v):
        x = jnp.pad(v.reshape(dd, du), ((0, ddp - dd), (0, dup - du)))
        x = jax.lax.with_sharding_constraint(x, sh)
        return mv2d(x)[:dd, :du].reshape(-1)

    return mv


def sharded_matvec_pair_flat(op: SectorOperator, mesh: Mesh,
                             axis: str = "dw"):
    """Flat pair matvec (vr, vi) [dim] -> (wr, wi) [dim] over the sharded
    dense-factor kernel — plugs straight into lanczos_eigh_split /
    lanczos_tridiag_batched_split so the whole eigensolve runs sharded."""
    mv2d, sh, (ddp, dup) = make_sharded_matvec_dense_pair(op, mesh, axis)
    dd, du = op.dim_dw, op.dim_up

    def mv(vr, vi):
        xr = jnp.pad(vr.reshape(dd, du), ((0, ddp - dd), (0, dup - du)))
        xi = jnp.pad(vi.reshape(dd, du), ((0, ddp - dd), (0, dup - du)))
        xr = jax.lax.with_sharding_constraint(xr, sh)
        xi = jax.lax.with_sharding_constraint(xi, sh)
        wr, wi = mv2d(xr, xi)
        return (wr[:dd, :du].reshape(-1), wi[:dd, :du].reshape(-1))

    return mv


def sharded_matvec_flat(op: DeviceSectorOp, mesh: Mesh, dim_dw: int,
                        dim_up: int, axis: str = "dw"):
    """Flat [dim] -> [dim] matvec closure over the padded 2-D kernel, for
    the eigensolvers.  Handles padding/unpadding on device."""
    mv2d, sh = make_sharded_matvec(op, mesh, axis)
    dd_p, du_p = op.diag.shape

    @jax.jit
    def mv(v):
        v2 = v.reshape(dim_dw, dim_up)
        v2 = jnp.pad(v2, ((0, dd_p - dim_dw), (0, du_p - dim_up)))
        v2 = jax.lax.with_sharding_constraint(v2, sh)
        out = mv2d(v2)
        return out[:dim_dw, :dim_up].reshape(-1)

    return mv
