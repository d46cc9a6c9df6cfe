"""Real-Hamiltonian fast path (one-plane matmul kernel + real Lanczos).

Hubbard-type sectors are real symmetric; the real path runs 2 matmuls per
matvec instead of the split-complex kernel's 6 (ops/split.py).  These tests
pin it against the complex oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cdmft_lanc_ed_tpu import EDConfig
from cdmft_lanc_ed_tpu.ops import lanczos, sector_ham, split


def make_real_op(nup=3, ndw=2, jx=0.2, jp=0.1):
    """Random REAL symmetric cluster+bath sector operator (incl. Jx/Jp)."""
    cfg = EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                   uloc=[3.0, 2.0, 0, 0, 0], ust=0.5, jh=0.1, jx=jx, jp=jp,
                   ed_verbose=0)
    rng = np.random.default_rng(11)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn).astype(complex)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.4).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    return cfg, sector_ham.build_sector_operator(cfg, h, hrec, dhyb,
                                                 nup, ndw)


def make_complex_op():
    rng = np.random.default_rng(3)
    cfg = EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                   uloc=[3.0, 2.0, 0, 0, 0], ed_verbose=0)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn) + 1j * rng.normal(size=nn)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.4).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    return sector_ham.build_sector_operator(cfg, h, hrec, dhyb, 3, 2)


def test_realness_detection():
    _, op = make_real_op()
    assert split.op_is_real(op)
    assert split.make_matvec_real_padded(op) is not None
    opc = make_complex_op()
    assert not split.op_is_real(opc)
    assert split.make_matvec_real_padded(opc) is None


def test_real_matvec_matches_oracle():
    _, op = make_real_op(jx=0.3, jp=0.2)
    assert len(op.nd_terms) > 0
    mv, dim_p, embed, extract = split.make_matvec_real_padded(op)
    rng = np.random.default_rng(0)
    v = rng.normal(size=op.dim)
    want = op.matvec_np(v.astype(complex))
    got = extract(np.asarray(mv(jnp.asarray(embed(v)))))
    np.testing.assert_allclose(got, want.real, atol=1e-12)
    assert np.abs(want.imag).max() < 1e-14


def test_real_pair_kernel_matches_oracle():
    """Complex vector on a real H via the 4-matmul pair route
    (make_matvec_pair_padded dispatches to the real kernel)."""
    _, op = make_real_op()
    mv, dim_p, embed, extract = split.make_matvec_pair_padded(op)
    rng = np.random.default_rng(1)
    v = rng.normal(size=op.dim) + 1j * rng.normal(size=op.dim)
    vp = embed(v)
    wr, wi = mv(jnp.asarray(vp.real), jnp.asarray(vp.imag))
    got = extract(np.asarray(wr) + 1j * np.asarray(wi))
    np.testing.assert_allclose(got, op.matvec_np(v), atol=1e-12)


def test_real_lanczos_eigh_matches_dense():
    _, op = make_real_op()
    mv, dim_p, embed, extract = split.make_matvec_real_padded(op)
    rng = np.random.default_rng(0)
    v0 = embed(rng.normal(size=op.dim))
    res = lanczos.lanczos_eigh_real(mv, dim_p, neigen=3, ncv=30,
                                    maxiter=600, tol=1e-13, v0=v0)
    w = np.linalg.eigvalsh(op.to_dense())
    np.testing.assert_allclose(res.eigenvalues, w[:3], atol=1e-8)
    vecs = extract(res.eigenvectors)
    for i in range(3):
        hv = op.matvec_np(vecs[i].astype(complex))
        assert np.linalg.norm(hv - w[i] * vecs[i]) < 1e-6


def test_real_batched_tridiag_matches_split():
    _, op = make_real_op()
    mv_r, dim_p, embed, extract = split.make_matvec_real_padded(op)
    mv_s, dim_p2, embed2, _ = split.make_matvec_pair_padded(op)
    assert dim_p == dim_p2
    rng = np.random.default_rng(5)
    batch = rng.normal(size=(4, op.dim))
    a1, b1, n1 = lanczos.lanczos_tridiag_batched_real(
        mv_r, embed(batch), 20)
    a2, b2, n2 = lanczos.lanczos_tridiag_batched_split(
        mv_s, embed2(batch.astype(complex)), 20)
    np.testing.assert_allclose(a1, a2, atol=1e-9)
    np.testing.assert_allclose(b1, b2, atol=1e-9)
    np.testing.assert_allclose(n1, n2, atol=1e-12)


def test_mixed_precision_real_eigensolver():
    _, op = make_real_op()
    mv32 = split.make_matvec_real_padded(op, dtype=jnp.float32)[0]
    mv64, dim_p, embed, extract = split.make_matvec_real_padded(op)
    rng = np.random.default_rng(0)
    v0 = embed(rng.normal(size=op.dim))
    res = lanczos.lanczos_eigh_mixed_real(mv32, mv64, dim_p, neigen=3,
                                          ncv=30, maxiter=600, tol=1e-12,
                                          v0=v0)
    w = np.linalg.eigvalsh(op.to_dense())
    np.testing.assert_allclose(res.eigenvalues, w[:3], atol=5e-9)


def test_full_solver_real_path_gf(tmp_path, monkeypatch):
    """End-to-end plaquette solve on the split backend: diag + GF now route
    through the real kernels (same golden energy as the complex path)."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    from cdmft_lanc_ed_tpu import EDSolver
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0], lmats=16,
                   lreal=16, lanc_ngfiter=48, ed_verbose=0,
                   ed_gf_symmetric=True,    # real injections -> real GF path
                   lanc_dim_threshold=8, work_dir=str(tmp_path))
    s = EDSolver(cfg)
    s.init_solver()
    s.solve(np.zeros(0), h)
    assert s.egs == pytest.approx(-6.102748483462073, abs=1e-7)
    g = s.gf.gmats[0, 0, 0, 0, 0, 0]
    assert np.all(g.imag < 0)


def test_auto_symmetric_matches_chan4(tmp_path, monkeypatch):
    """Real problem: the auto-selected 2-channel scheme must reproduce the
    4-channel off-diagonal GF exactly (G_ij = G_ji for real H).  Forcing
    complex arithmetic (complex-noise-free but flagged) runs chan4."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "0")
    from cdmft_lanc_ed_tpu import EDSolver
    import cdmft_lanc_ed_tpu.gf as gfmod
    h = np.zeros((2, 2, 1, 1, 1, 1), dtype=complex)
    h[0, 1, 0, 0, 0, 0] = h[1, 0, 0, 0, 0, 0] = -1.0
    cfg = EDConfig(nlat=2, norb=1, nspin=1, nbath=2, uloc=[2.5], lmats=16,
                   lreal=8, lanc_ngfiter=40, ed_verbose=0,
                   work_dir=str(tmp_path))
    basis = np.zeros((1, 2, 2, 1, 1, 1, 1), np.complex128)
    basis[0, 0, 0], basis[0, 1, 1] = 1.0, 1.0

    def run(force_chan4):
        s = EDSolver(cfg)
        s.set_hbath(basis, np.array([[0.4], [-0.4]]))
        b = s.init_solver()
        if force_chan4:
            # disable the auto-detection by faking a complex eigenvector
            orig = gfmod.build_gf_normal

            def wrapped(cfg_, state_, build_, log=lambda s: None,
                        force_symmetric=False):
                return orig(cfg_, state_, build_, log,
                            force_symmetric=False)
            monkeypatch.setattr(gfmod, "build_gf_normal", wrapped)
        s.solve(b, h)
        if force_chan4:
            monkeypatch.setattr(gfmod, "build_gf_normal", orig)
        return s.gf.gmats.copy(), s.gf.smats.copy()

    g4, s4 = run(True)
    g2, s2 = run(False)
    np.testing.assert_allclose(g2, g4, atol=1e-8)
    np.testing.assert_allclose(s2, s4, atol=1e-6)


def test_batched_sector_dispatch(tmp_path, monkeypatch, capsys):
    """Sector-parallel batched dispatch: same-bucket real sectors solve in
    one batched Lanczos stream with the golden plaquette ground state."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    from cdmft_lanc_ed_tpu import EDSolver
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0],
                   gf_flag=False, ed_verbose=3, lanc_dim_threshold=8,
                   work_dir=str(tmp_path))
    s = EDSolver(cfg)
    s.init_solver()
    s.solve(np.zeros(0), h)
    assert s.egs == pytest.approx(-6.102748483462073, abs=1e-7)


def test_batched_lanczos_matches_serial():
    """Batched thick-restart == per-sector thick-restart (same v0)."""
    ops = [make_real_op(nup=3, ndw=2)[1], make_real_op(nup=2, ndw=3)[1]]
    ddp = max(split._bucket(o.dim_dw) for o in ops)
    dup = max(split._bucket(o.dim_up) for o in ops)
    from cdmft_lanc_ed_tpu.ops.split import (embed_real, extract_real,
                                             make_matvec_real_batched)
    mv_b = make_matvec_real_batched(ops, (ddp, dup))
    rng = np.random.default_rng(0)
    v0 = np.stack([embed_real(rng.normal(size=o.dim), o.dim_dw, o.dim_up,
                              ddp, dup) for o in ops])
    res_b = lanczos.lanczos_eigh_real_batched(
        mv_b, 2, ddp * dup, neigen=2, ncv=24, maxiter=500, tol=1e-13,
        v0=v0)
    for o, r, v in zip(ops, res_b, v0):
        kit = split.make_matvec_real_padded(o)
        # same padded bucket only when the op's own bucket matches; compare
        # against the dense spectrum instead (robust)
        w = np.linalg.eigvalsh(o.to_dense())
        np.testing.assert_allclose(r.eigenvalues, w[:2], atol=1e-8)
        vecs = extract_real(np.asarray(r.eigenvectors), o.dim_dw, o.dim_up,
                            ddp, dup)
        for i in range(2):
            hv = o.matvec_np(vecs[i].astype(complex))
            assert np.linalg.norm(hv - w[i] * vecs[i]) < 1e-6
        assert r.converged


def test_batched_split_lanczos_matches_dense():
    """Complex-sector batched thick-restart vs dense oracle."""
    from tests.test_real_fastpath import make_complex_op
    op1 = make_complex_op()
    rng = np.random.default_rng(4)
    cfg = EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                   uloc=[2.0, 1.0, 0, 0, 0], ed_verbose=0)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn) + 1j * rng.normal(size=nn)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.4).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    op2 = sector_ham.build_sector_operator(cfg, h, hrec, dhyb, 2, 3)
    ops = [op1, op2]
    ddp = max(split._bucket(o.dim_dw) for o in ops)
    dup = max(split._bucket(o.dim_up) for o in ops)
    mv_b = split.make_matvec_pair_batched(ops, (ddp, dup))
    v0 = np.stack([split.embed_real(
        rng.normal(size=o.dim) + 1j * rng.normal(size=o.dim),
        o.dim_dw, o.dim_up, ddp, dup) for o in ops])
    res = lanczos.lanczos_eigh_split_batched(
        mv_b, 2, ddp * dup, neigen=2, ncv=26, maxiter=600, tol=1e-13,
        v0=v0)
    for o, r in zip(ops, res):
        w = np.linalg.eigvalsh(o.to_dense())
        np.testing.assert_allclose(r.eigenvalues, w[:2], atol=1e-8)
        vecs = split.extract_real(np.asarray(r.eigenvectors),
                                  o.dim_dw, o.dim_up, ddp, dup)
        for i in range(2):
            hv = o.matvec_np(vecs[i])
            assert np.linalg.norm(hv - w[i] * vecs[i]) < 1e-6
        assert r.converged


def test_batched_dispatch_complex_solver(tmp_path, monkeypatch):
    """End-to-end complex-Hamiltonian solve routes through the complex
    batched dispatch (BHZ-like 2-site cluster, imaginary hopping)."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    from cdmft_lanc_ed_tpu import EDSolver
    h = np.zeros((2, 2, 1, 1, 1, 1), dtype=complex)
    h[0, 1, 0, 0, 0, 0] = -1.0 + 0.3j
    h[1, 0, 0, 0, 0, 0] = -1.0 - 0.3j
    cfg = EDConfig(nlat=2, norb=1, nspin=1, nbath=2, uloc=[3.0],
                   gf_flag=False, ed_verbose=0, lanc_dim_threshold=8,
                   work_dir=str(tmp_path))
    basis = np.zeros((1, 2, 2, 1, 1, 1, 1), np.complex128)
    basis[0, 0, 0], basis[0, 1, 1] = 1.0, 1.0
    s = EDSolver(cfg)
    s.set_hbath(basis, np.array([[0.4], [-0.4]]))
    b = s.init_solver()
    s.solve(b, h)
    egs_split = s.egs
    # oracle: same solve on the complex CPU path
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "0")
    s2 = EDSolver(cfg)
    s2.set_hbath(basis, np.array([[0.4], [-0.4]]))
    b2 = s2.init_solver()
    s2.solve(b2, h)
    assert egs_split == pytest.approx(s2.egs, abs=1e-8)


def test_mixed_batched_lanczos_matches_dense():
    """Batched mixed-precision dispatch (f32 batched Krylov + batched f64
    Rayleigh-Ritz) reaches f64 accuracy on every batch member."""
    ops = [make_real_op(nup=3, ndw=2)[1], make_real_op(nup=2, ndw=3)[1]]
    ddp = max(split._bucket(o.dim_dw) for o in ops)
    dup = max(split._bucket(o.dim_up) for o in ops)
    from cdmft_lanc_ed_tpu.ops.split import (apply_real_flat,
                                             apply_real_flat_batched,
                                             build_real_padded, embed_real,
                                             extract_real, stack_real_ops)
    dev64 = stack_real_ops(ops, (ddp, dup))
    dev32 = stack_real_ops(ops, (ddp, dup), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    v0 = np.stack([embed_real(rng.normal(size=o.dim), o.dim_dw, o.dim_up,
                              ddp, dup) for o in ops])

    def fb64(i, v0_row):
        dev_i = build_real_padded(ops[i])[0]
        return lanczos.lanczos_eigh_real(
            apply_real_flat, ddp * dup, neigen=2, ncv=24, maxiter=500,
            tol=1e-13, v0=v0_row, op=dev_i)

    res_b = lanczos.lanczos_eigh_mixed_real_batched(
        apply_real_flat_batched, apply_real_flat_batched, 2, ddp * dup,
        neigen=2, ncv=24, maxiter=500, tol=1e-13, v0=v0,
        op32=dev32, op64=dev64, fallback64=fb64)
    for o, r in zip(ops, res_b):
        w = np.linalg.eigvalsh(o.to_dense())
        np.testing.assert_allclose(r.eigenvalues, w[:2], atol=5e-9)
        vecs = extract_real(np.asarray(r.eigenvectors), o.dim_dw, o.dim_up,
                            ddp, dup)
        for i in range(2):
            hv = o.matvec_np(vecs[i].astype(complex))
            # vectors carry f32-level residuals by design (energies are f64)
            assert np.linalg.norm(hv - w[i] * vecs[i]) < 5e-6
        assert r.converged


def test_mixed_batched_split_lanczos_matches_dense():
    """Complex-sector batched mixed-precision dispatch (f32 batched pair
    Krylov + batched f64 complex Rayleigh-Ritz) reaches f64 energies."""
    from cdmft_lanc_ed_tpu.ops.split import (apply_pair_flat,
                                             apply_pair_flat_batched,
                                             build_pair_padded, embed_real,
                                             stack_pair_ops)
    op1 = make_complex_op()
    rng = np.random.default_rng(4)
    cfg = EDConfig(nlat=1, norb=2, nspin=1, nbath=2,
                   uloc=[2.0, 1.0, 0, 0, 0], ed_verbose=0)
    nn = (1, 1, 1, 1, 2, 2)
    h = rng.normal(size=nn) + 1j * rng.normal(size=nn)
    h = 0.5 * (h + h.conj().transpose(1, 0, 3, 2, 5, 4))
    hrec = (rng.normal(size=(2,) + nn) * 0.4).astype(complex)
    hrec = 0.5 * (hrec + hrec.conj().transpose(0, 2, 1, 4, 3, 6, 5))
    dhyb = rng.normal(size=(1, 1, 2, 2))
    op2 = sector_ham.build_sector_operator(cfg, h, hrec, dhyb, 2, 3)
    ops = [op1, op2]
    ddp = max(split._bucket(o.dim_dw) for o in ops)
    dup = max(split._bucket(o.dim_up) for o in ops)
    dev64 = stack_pair_ops(ops, (ddp, dup))
    dev32 = stack_pair_ops(ops, (ddp, dup), dtype=jnp.float32)
    v0 = np.stack([embed_real(
        rng.normal(size=o.dim) + 1j * rng.normal(size=o.dim),
        o.dim_dw, o.dim_up, ddp, dup) for o in ops])

    def fb64(i, v0_row):
        dev_i = build_pair_padded(ops[i])[0]
        return lanczos.lanczos_eigh_split(
            apply_pair_flat, ddp * dup, neigen=2, ncv=26, maxiter=600,
            tol=1e-13, v0=v0_row, op=dev_i)

    res = lanczos.lanczos_eigh_mixed_split_batched(
        apply_pair_flat_batched, apply_pair_flat_batched, 2, ddp * dup,
        neigen=2, ncv=26, maxiter=600, tol=1e-13, v0=v0,
        op32=dev32, op64=dev64, fallback64=fb64)
    for o, r in zip(ops, res):
        w = np.linalg.eigvalsh(o.to_dense())
        np.testing.assert_allclose(r.eigenvalues, w[:2], atol=5e-9)
        assert r.converged


def test_gf_single_precision_close_to_double(tmp_path, monkeypatch):
    """ed_gf_precision='single' (f32 GF tridiag, the throughput lever)
    reproduces the f64 GF to ~1e-4 — poles/weights from f32 alpha/beta."""
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", "1")
    from cdmft_lanc_ed_tpu import EDSolver
    h = np.zeros((4, 4, 1, 1, 1, 1), dtype=complex)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        h[i, j, 0, 0, 0, 0] = h[j, i, 0, 0, 0, 0] = -1.0

    def run(prec, wd):
        cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=0, uloc=[4.0],
                       lmats=16, lreal=8, lanc_ngfiter=48, ed_verbose=0,
                       lanc_dim_threshold=8, ed_gf_precision=prec,
                       work_dir=str(wd))
        s = EDSolver(cfg)
        s.init_solver()
        s.solve(np.zeros(0), h)
        return s.gf.gmats.copy()

    d1 = tmp_path / "dbl"; d1.mkdir()
    d2 = tmp_path / "sgl"; d2.mkdir()
    g_dbl = run("double", d1)
    g_sgl = run("single", d2)
    assert np.max(np.abs(g_sgl - g_dbl)) < 1e-3
    np.testing.assert_allclose(g_sgl, g_dbl, atol=1e-3, rtol=1e-3)
