"""Dense-factor H·v (ops/split.py) against NumPy at f32 and f64.

These are the shapes and oracles of the plain XLA kernel that serves the
flagship sectors: diag ⊙ X + H_dw·X + X·H_upᵀ (real) and its Karatsuba
pair form (complex)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cdmft_lanc_ed_tpu.ops import split


def _real_op(rng, d, u, dtype=np.float32, b=None):
    lead = () if b is None else (b,)
    diag = rng.normal(size=lead + (d, u)).astype(dtype)
    hdw = rng.normal(size=lead + (d, d)).astype(dtype)
    hdw = (hdw + np.swapaxes(hdw, -1, -2)) / 2
    hup = rng.normal(size=lead + (u, u)).astype(dtype)
    hup = (hup + np.swapaxes(hup, -1, -2)) / 2
    x = rng.normal(size=lead + (d, u)).astype(dtype)
    empty = np.zeros(lead + (0,), dtype)
    op = split.DenseRealOp(
        diag=jnp.asarray(diag), hdw=jnp.asarray(hdw), hupT=jnp.asarray(hup),
        nd_amp=jnp.asarray(empty),
        nd_upT=jnp.asarray(np.zeros(lead + (0, u, u), dtype)),
        nd_dw=jnp.asarray(np.zeros(lead + (0, d, d), dtype)))
    return op, diag, hdw, hup, x


@pytest.mark.parametrize("d,u", [(128, 128), (256, 128), (128, 256),
                                 (384, 256), (512, 512)])
def test_dense_real_matches_numpy(d, u):
    rng = np.random.default_rng(7)
    op, diag, hdw, hup, x = _real_op(rng, d, u)
    out = np.asarray(jax.jit(split.matvec_dense_real)(op, jnp.asarray(x)))
    ref = diag * x + hdw @ x + x @ hup
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_dense_real_vmap_batched():
    """vmap over the kernel = the sector-parallel batched dispatch path."""
    rng = np.random.default_rng(3)
    op, diag, hdw, hup, x = _real_op(rng, 128, 256, b=3)
    out = np.asarray(jax.vmap(split.matvec_dense_real)(op, jnp.asarray(x)))
    for i in range(3):
        ref = diag[i] * x[i] + hdw[i] @ x[i] + x[i] @ hup[i]
        np.testing.assert_allclose(out[i], ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d,u", [(128, 128), (256, 128), (128, 384)])
def test_dense_pair_matches_complex(d, u):
    rng = np.random.default_rng(11)
    f = np.float32
    diag = rng.normal(size=(d, u)).astype(f)
    hr, hi = (rng.normal(size=(d, d)).astype(f) for _ in range(2))
    ur, ui = (rng.normal(size=(u, u)).astype(f) for _ in range(2))
    xr, xi = (rng.normal(size=(d, u)).astype(f) for _ in range(2))
    op = split.DenseSplitOp(
        diag=jnp.asarray(diag), hdw_r=jnp.asarray(hr), hdw_i=jnp.asarray(hi),
        hdw_s=jnp.asarray(hr + hi), hupT_r=jnp.asarray(ur),
        hupT_i=jnp.asarray(ui), hupT_s=jnp.asarray(ur + ui),
        nd_amp_r=jnp.zeros(0, f), nd_amp_i=jnp.zeros(0, f),
        nd_upT=jnp.zeros((0, u, u), f), nd_dw=jnp.zeros((0, d, d), f))
    outr, outi = jax.jit(split.matvec_dense_pair)(op, jnp.asarray(xr),
                                                  jnp.asarray(xi))
    xc = xr + 1j * xi
    ref = diag * xc + (hr + 1j * hi) @ xc + xc @ (ur + 1j * ui)
    np.testing.assert_allclose(np.asarray(outr), ref.real, rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(outi), ref.imag, rtol=1e-3,
                               atol=1e-3)


def test_dense_real_on_physical_sector():
    """Against the sector operator itself: plaquette + 2 bath replicas,
    f32 and f64 planes padded to their buckets, vs ``op.matvec_np``."""
    import __graft_entry__ as ge
    _, op = ge._plaquette_bath_op(nbath=2, nup=3, ndw=4)
    assert split.op_is_real(op)
    ddp, dup = split._bucket(op.dim_dw), split._bucket(op.dim_up)
    rng = np.random.default_rng(0)
    v = rng.normal(size=op.dim)
    ref = op.matvec_np(v.astype(np.complex128)).real
    for dtype, tol in ((jnp.float32, 2e-4), (jnp.float64, 1e-12)):
        dev = split.to_device_dense_real(op, pad_to=(ddp, dup), dtype=dtype)
        x = split.embed_real(v, op.dim_dw, op.dim_up, ddp, dup)
        out = np.asarray(split.matvec_dense_real(
            dev, jnp.asarray(x.reshape(ddp, dup), dtype)))
        got = split.extract_real(out.reshape(-1), op.dim_dw, op.dim_up,
                                 ddp, dup)
        np.testing.assert_allclose(got, ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())
