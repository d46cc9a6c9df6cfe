"""Split re/im f64 device path (accelerator path) vs the complex oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from cdmft_lanc_ed_tpu import EDConfig
from cdmft_lanc_ed_tpu.ops import lanczos, sector_ham, split, spmv


def make_op(nup=3, ndw=2, jx=0.2, jp=0.1):
    cfg = EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                   uloc=[3.0, 2.0, 0, 0, 0], ust=0.5, jh=0.1, jx=jx, jp=jp,
                   ed_verbose=0)
    rng = np.random.default_rng(11)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn) + 1j * rng.normal(size=nn)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.4).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    return cfg, sector_ham.build_sector_operator(cfg, h, hrec, dhyb,
                                                 nup, ndw)


def test_split_matvec_matches_complex():
    cfg, op = make_op()
    dev = split.to_device_split(op)
    mv = split.make_matvec_split(dev)
    rng = np.random.default_rng(0)
    v = rng.normal(size=op.dim) + 1j * rng.normal(size=op.dim)
    want = op.matvec_np(v)
    got = split.unsplit(np.asarray(mv(jnp.asarray(split.split_of(v)))))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_split_lanczos_eigh_matches_dense():
    cfg, op = make_op()
    mv = split.make_matvec_pair(op)
    res = lanczos.lanczos_eigh_split(mv, op.dim, neigen=3, ncv=30,
                                     maxiter=600, tol=1e-13)
    w = np.linalg.eigvalsh(op.to_dense())
    np.testing.assert_allclose(res.eigenvalues, w[:3], atol=1e-8)
    # eigenvectors: residual check ||H v - w v||
    for i in range(3):
        vec = res.eigenvectors[i]
        hv = op.matvec_np(vec)
        assert np.linalg.norm(hv - w[i] * vec) < 1e-6


def test_split_batched_tridiag_matches_complex():
    cfg, op = make_op()
    dev_c = spmv.to_device(op)
    mv_c = spmv.make_matvec(dev_c)
    mv_s = split.make_matvec_pair(op)
    rng = np.random.default_rng(5)
    batch = rng.normal(size=(4, op.dim)) + 1j * rng.normal(size=(4, op.dim))
    a1, b1, n1 = lanczos.lanczos_tridiag_batched(mv_c, jnp.asarray(batch),
                                                 20)
    a2, b2, n2 = lanczos.lanczos_tridiag_batched_split(mv_s, batch, 20)
    np.testing.assert_allclose(a2, a1, atol=1e-9)
    np.testing.assert_allclose(b2, b1, atol=1e-9)
    np.testing.assert_allclose(n2, n1, atol=1e-12)


def test_full_solver_on_split_backend(tmp_path, monkeypatch):
    """End-to-end solve with the split backend forced (as on an accelerator)."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    from cdmft_lanc_ed_tpu import EDSolver
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0], lmats=16,
                   lreal=16, lanc_ngfiter=48, ed_verbose=0,
                   lanc_dim_threshold=8,   # force the Lanczos path
                   work_dir=str(tmp_path))
    s = EDSolver(cfg)
    s.init_solver()
    s.solve(np.zeros(0), h)
    assert s.egs == pytest.approx(-6.102748483462073, abs=1e-7)
    g = s.gf.gmats[0, 0, 0, 0, 0, 0]
    assert np.all(g.imag < 0)


def test_dense_split_matvec_matches_complex():
    """dense-factor kernel (accelerator hot path) vs the numpy oracle,
    including Jx/Jp Kronecker terms."""
    cfg, op = make_op(jx=0.3, jp=0.2)
    assert len(op.nd_terms) > 0
    mv = split.make_matvec_flat(op)
    rng = np.random.default_rng(9)
    v = rng.normal(size=op.dim) + 1j * rng.normal(size=op.dim)
    want = op.matvec_np(v)
    got = split.unsplit(np.asarray(mv(jnp.asarray(split.split_of(v)))))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_mixed_precision_eigensolver():
    """f32 Krylov + f64 Rayleigh refinement reaches f64-grade energies."""
    cfg, op = make_op()
    mv32, dim_p, embed, extract = split.make_matvec_pair_padded(
        op, dtype=jnp.float32)
    mv64, dim_p2, _, _ = split.make_matvec_pair_padded(op)
    assert dim_p == dim_p2
    rng = np.random.default_rng(0)
    v0 = embed(rng.normal(size=op.dim) + 1j * rng.normal(size=op.dim))
    res = lanczos.lanczos_eigh_mixed(mv32, mv64, dim_p, neigen=3, ncv=30,
                                     maxiter=600, tol=1e-12, v0=v0)
    w = np.linalg.eigvalsh(op.to_dense())
    np.testing.assert_allclose(res.eigenvalues, w[:3], atol=5e-9)
    vecs = extract(res.eigenvectors)
    for i in range(3):
        hv = op.matvec_np(vecs[i])
        nrm = np.linalg.norm(vecs[i])
        assert np.linalg.norm(hv - w[i] * vecs[i]) / nrm < 1e-4


def test_full_solver_mixed_precision(tmp_path, monkeypatch):
    """End-to-end solve with ed_precision='mixed' on the split backend."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    from cdmft_lanc_ed_tpu import EDSolver
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0],
                   gf_flag=False, ed_verbose=0, lanc_dim_threshold=8,
                   ed_precision="mixed", work_dir=str(tmp_path))
    s = EDSolver(cfg)
    s.init_solver()
    s.solve(np.zeros(0), h)
    assert s.egs == pytest.approx(-6.102748483462073, abs=1e-7)
