"""Complex ELL-gather sector H·v: the CPU/test oracle path.

The sector vector lives as a 2-D array ``v[DimDw, DimUp]`` whose C-order
flattening matches the reference layout (ED_SETUP.f90:547-560).  The matvec
exploits the tensor-product split exactly as the reference MPI kernel
(ED_HAMILTONIAN_SPARSE_HxV.f90:230-315):

* ``H_dw ⊗ I``: ELL row-gather SpMM on the leading axis;
* ``I ⊗ H_up``: same kernel on the transposed vector (the single-device
  analog of the reference's MPI AllToAllV transpose,
  ED_HAMILTONIAN_COMMON.f90:30-101; under sharding the transpose becomes
  an all-to-all over the mesh);
* diagonal: fused elementwise multiply;
* Jx/Jp (``H_nd``): factored Kronecker one-hop gathers — replaces the
  reference's full-vector allgather (ED_HAMILTONIAN_SPARSE_HxV.f90:299-313).

On an accelerator the solver runs the device kits instead (dense-factor
ops/split.py, block-sparse ops/large.py, hierarchical ops/hier_dev.py);
:func:`use_split_backend` makes that choice.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .sector_ham import SectorOperator

jax.config.update("jax_enable_x64", True)


def use_split_backend() -> bool:
    """True when sectors run on the device kits (real/pair dense-factor,
    block-sparse and hierarchical kernels, mixed precision, sector-
    parallel batching): on any accelerator.  The CPU keeps the complex
    ELL oracle path.  ``CDMFT_SPLIT_BACKEND`` (0/1) overrides the choice,
    so the CPU tests reach both paths."""
    import os
    env = os.environ.get("CDMFT_SPLIT_BACKEND")
    if env is not None:
        return env not in ("0", "false", "False")
    return jax.default_backend() != "cpu"


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceSectorOp:
    """Device-resident sector Hamiltonian (pytree; static shapes per sector)."""
    diag: jax.Array        # [DimDw, DimUp] real
    up_cols: jax.Array     # [DimUp, Ku] int32
    up_vals: jax.Array     # [DimUp, Ku] complex
    dw_cols: jax.Array     # [DimDw, Kd] int32
    dw_vals: jax.Array     # [DimDw, Kd] complex
    # stacked nd terms ([T, ...]; T may be 0)
    nd_amp: jax.Array      # [T] complex
    nd_up_src: jax.Array   # [T, DimUp] int32 (−1 → masked)
    nd_up_sgn: jax.Array   # [T, DimUp] int8
    nd_dw_src: jax.Array   # [T, DimDw] int32
    nd_dw_sgn: jax.Array   # [T, DimDw] int8

    def tree_flatten(self):
        return ((self.diag, self.up_cols, self.up_vals, self.dw_cols,
                 self.dw_vals, self.nd_amp, self.nd_up_src, self.nd_up_sgn,
                 self.nd_dw_src, self.nd_dw_sgn), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def dim_dw(self):
        return self.diag.shape[0]

    @property
    def dim_up(self):
        return self.diag.shape[1]

    @property
    def dim(self):
        return self.diag.shape[0] * self.diag.shape[1]


def to_device(op: SectorOperator, dtype=jnp.complex128) -> DeviceSectorOp:
    rdtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    t = len(op.nd_terms)
    if t:
        nd_amp = np.array([x.amp for x in op.nd_terms])
        nd_us = np.stack([x.up_src for x in op.nd_terms])
        nd_ug = np.stack([x.up_sgn for x in op.nd_terms])
        nd_ds = np.stack([x.dw_src for x in op.nd_terms])
        nd_dg = np.stack([x.dw_sgn for x in op.nd_terms])
    else:
        nd_amp = np.zeros(0, np.complex128)
        nd_us = np.zeros((0, op.dim_up), np.int32)
        nd_ug = np.zeros((0, op.dim_up), np.int8)
        nd_ds = np.zeros((0, op.dim_dw), np.int32)
        nd_dg = np.zeros((0, op.dim_dw), np.int8)
    return DeviceSectorOp(
        diag=jnp.asarray(op.diag(), dtype=rdtype),
        up_cols=jnp.asarray(op.h_up.cols, jnp.int32),
        up_vals=jnp.asarray(op.h_up.vals, dtype),
        dw_cols=jnp.asarray(op.h_dw.cols, jnp.int32),
        dw_vals=jnp.asarray(op.h_dw.vals, dtype),
        nd_amp=jnp.asarray(nd_amp, dtype),
        nd_up_src=jnp.asarray(nd_us, jnp.int32),
        nd_up_sgn=jnp.asarray(nd_ug, jnp.int8),
        nd_dw_src=jnp.asarray(nd_ds, jnp.int32),
        nd_dw_sgn=jnp.asarray(nd_dg, jnp.int8),
    )


def ell_spmm(cols: jax.Array, vals: jax.Array, v: jax.Array) -> jax.Array:
    """out[r, :] = Σ_k vals[r,k] · v[cols[r,k], :] (row-gather SpMM)."""
    gathered = v[cols]                       # [R, K, C]
    return jnp.einsum("rk,rkc->rc", vals, gathered)


def _nd_apply(op: DeviceSectorOp, v: jax.Array) -> jax.Array:
    def one(amp, usrc, usgn, dsrc, dsgn):
        g = v[jnp.maximum(dsrc, 0)][:, jnp.maximum(usrc, 0)]
        mask = (dsgn[:, None].astype(v.dtype) * usgn[None, :].astype(v.dtype))
        return amp * mask * g
    contrib = jax.vmap(one)(op.nd_amp, op.nd_up_src, op.nd_up_sgn,
                            op.nd_dw_src, op.nd_dw_sgn)
    return contrib.sum(axis=0)


def matvec_2d(op: DeviceSectorOp, v: jax.Array) -> jax.Array:
    """H·v with v shaped [DimDw, DimUp]."""
    out = op.diag.astype(v.dtype) * v
    out = out + ell_spmm(op.dw_cols, op.dw_vals, v)
    out = out + ell_spmm(op.up_cols, op.up_vals, v.T).T
    if op.nd_amp.shape[0]:
        out = out + _nd_apply(op, v)
    return out


def make_matvec(op: DeviceSectorOp):
    """Flat matvec closure H·v for the eigensolvers (jit-compiled)."""
    dd, du = op.diag.shape

    @jax.jit
    def mv(v):
        return matvec_2d(op, v.reshape(dd, du)).reshape(-1)

    return mv
