"""Sharded SpMV vs single-device matvec on the 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from cdmft_lanc_ed_tpu import EDConfig
from cdmft_lanc_ed_tpu.ops import sector_ham, spmv
from cdmft_lanc_ed_tpu.parallel import sharded_spmv


def make_op(nup=3, ndw=3, jx=0.0, jp=0.0, norb=1, nlat=2, nbath=2):
    cfg = EDConfig(nlat=nlat, norb=norb, nspin=1, nbath=nbath,
                   uloc=[3.0, 1.5, 0, 0, 0], ust=0.4, jh=0.1, jx=jx, jp=jp,
                   ed_verbose=0)
    rng = np.random.default_rng(7)
    nn = (cfg.nlat, cfg.nlat, cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)
    h = rng.normal(size=nn) + 1j * rng.normal(size=nn)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = rng.normal(size=(cfg.nbath,) + nn) * 0.5
    hrec = 0.5 * (hrec + hrec.transpose(0, 2, 1, 4, 3, 6, 5))
    hrec = hrec.astype(np.complex128)
    dhyb = rng.normal(size=(cfg.nlat, cfg.nspin, cfg.norb, cfg.nbath))
    return cfg, sector_ham.build_sector_operator(cfg, h, hrec, dhyb,
                                                 nup, ndw)


@pytest.fixture
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    return Mesh(np.array(devs[:8]), ("dw",))


def test_sharded_matvec_matches_local(mesh8):
    cfg, op = make_op()
    dev = sharded_spmv.pad_device_op(op, 8)
    mv = sharded_spmv.sharded_matvec_flat(dev, mesh8, op.dim_dw, op.dim_up)
    rng = np.random.default_rng(3)
    v = rng.normal(size=op.dim) + 1j * rng.normal(size=op.dim)
    want = op.matvec_np(v)
    got = np.asarray(mv(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_sharded_overlap_chunks_match_single_shot(mesh8):
    """Chunked (comm/compute-overlapped) transpose == single-shot kernel
    (round-1 VERDICT item 4: the chains must stay oracle-exact)."""
    cfg, op = make_op()
    # realify: zero imaginary parts so the real kernel applies
    op.h_up.vals = op.h_up.vals.real.astype(np.complex128)
    op.h_dw.vals = op.h_dw.vals.real.astype(np.complex128)
    mv1 = sharded_spmv.sharded_matvec_real_flat(op, mesh8)
    mv4 = sharded_spmv.sharded_matvec_real_flat(op, mesh8, overlap=4)
    rng = np.random.default_rng(11)
    v = rng.normal(size=op.dim)
    want = op.matvec_np(v.astype(np.complex128)).real
    got1 = np.asarray(mv1(jnp.asarray(v)))
    got4 = np.asarray(mv4(jnp.asarray(v)))
    np.testing.assert_allclose(got1, want, atol=1e-12)
    np.testing.assert_allclose(got4, want, atol=1e-12)


def test_sharded_matvec_with_jxjp(mesh8):
    """Non-factorable Jx/Jp terms through the folded all-to-all path."""
    cfg, op = make_op(norb=2, nlat=1, nbath=3, nup=3, ndw=2, jx=0.25,
                      jp=0.15)
    assert len(op.nd_terms) > 0
    dev = sharded_spmv.pad_device_op(op, 8)
    mv = sharded_spmv.sharded_matvec_flat(dev, mesh8, op.dim_dw, op.dim_up)
    rng = np.random.default_rng(4)
    v = rng.normal(size=op.dim) + 1j * rng.normal(size=op.dim)
    want = op.matvec_np(v)
    got = np.asarray(mv(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_sharded_lanczos_groundstate(mesh8):
    """Full Lanczos eigensolve through the sharded matvec: same GS energy
    as dense diagonalization."""
    from cdmft_lanc_ed_tpu.ops import lanczos
    cfg, op = make_op()
    dev = sharded_spmv.pad_device_op(op, 8)
    mv = sharded_spmv.sharded_matvec_flat(dev, mesh8, op.dim_dw, op.dim_up)
    res = lanczos.lanczos_eigh(mv, op.dim, neigen=2, ncv=24, maxiter=400,
                               tol=1e-12)
    w_dense = np.linalg.eigvalsh(op.to_dense())
    np.testing.assert_allclose(res.eigenvalues, w_dense[:2], atol=1e-8)


def test_sharded_dense_pair_matches_local(mesh8):
    """Multi-device dense-factor kernel vs the numpy oracle (incl Jx/Jp)."""
    import jax.numpy as jnp
    cfg, op = make_op(norb=2, nlat=1, nbath=3, nup=3, ndw=2, jx=0.25,
                      jp=0.15)
    mv, sh, (ddp, dup) = sharded_spmv.make_sharded_matvec_dense_pair(
        op, mesh8)
    rng = np.random.default_rng(12)
    v = rng.normal(size=(op.dim_dw, op.dim_up)) \
        + 1j * rng.normal(size=(op.dim_dw, op.dim_up))
    vr = np.zeros((ddp, dup)); vr[:op.dim_dw, :op.dim_up] = v.real
    vi = np.zeros((ddp, dup)); vi[:op.dim_dw, :op.dim_up] = v.imag
    wr, wi = mv(jax.device_put(jnp.asarray(vr), sh),
                jax.device_put(jnp.asarray(vi), sh))
    got = (np.asarray(wr) + 1j * np.asarray(wi))[:op.dim_dw, :op.dim_up]
    want = op.matvec_np(v.ravel()).reshape(op.dim_dw, op.dim_up)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_mesh_integrated_solve(mesh8, tmp_path, monkeypatch):
    """Full solver with an installed mesh: large sectors route through the
    sharded dense-factor Lanczos and reproduce the unsharded result."""
    import jax.numpy as jnp
    from cdmft_lanc_ed_tpu import EDConfig, EDSolver
    from cdmft_lanc_ed_tpu.parallel import multichip

    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    kw = dict(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0], gf_flag=False,
              ed_verbose=0, lanc_dim_threshold=1,
              work_dir=str(tmp_path))

    s_ref = EDSolver(EDConfig(**kw))
    s_ref.init_solver()
    s_ref.solve(np.zeros(0), h)

    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    try:
        multichip.set_solver_mesh(mesh8)
        s_sh = EDSolver(EDConfig(**kw))
        s_sh.init_solver()
        s_sh.solve(np.zeros(0), h)
    finally:
        multichip.set_solver_mesh(None)
    assert s_sh.egs == pytest.approx(s_ref.egs, abs=1e-8)
    np.testing.assert_allclose(s_sh.dens(), s_ref.dens(), atol=1e-7)


def make_real_op(jx=0.2, jp=0.1):
    cfg = EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                   uloc=[3.0, 1.5, 0, 0, 0], ust=0.4, jh=0.1, jx=jx, jp=jp,
                   ed_verbose=0)
    rng = np.random.default_rng(7)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn).astype(complex)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.5).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    return cfg, sector_ham.build_sector_operator(cfg, h, hrec, dhyb, 3, 2)


def test_sharded_real_matvec_matches_oracle(mesh8):
    """Real-H one-plane sharded kernel (incl. folded Jx/Jp) vs oracle."""
    cfg, op = make_real_op()
    assert len(op.nd_terms) > 0
    mv = sharded_spmv.sharded_matvec_real_flat(op, mesh8)
    assert mv is not None
    rng = np.random.default_rng(5)
    v = rng.normal(size=op.dim)
    want = op.matvec_np(v.astype(complex))
    got = np.asarray(mv(jnp.asarray(v)))
    np.testing.assert_allclose(got, want.real, atol=1e-12)
    # complex op -> no real kernel
    _, opc = make_op(norb=2, nlat=1, nbath=2, nup=3, ndw=2)
    assert sharded_spmv.sharded_matvec_real_flat(opc, mesh8) is None


def test_sharded_real_lanczos_groundstate(mesh8):
    from cdmft_lanc_ed_tpu.ops import lanczos
    cfg, op = make_real_op()
    mv = sharded_spmv.sharded_matvec_real_flat(op, mesh8)
    res = lanczos.lanczos_eigh_real(mv, op.dim, neigen=2, ncv=24,
                                    maxiter=400, tol=1e-12)
    w = np.linalg.eigvalsh(op.to_dense())
    np.testing.assert_allclose(res.eigenvalues, w[:2], atol=1e-8)
