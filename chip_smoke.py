#!/usr/bin/env python
"""Smoke test of the CDMFT solver's main path on one NVIDIA GPU.

    python chip_smoke.py              # one card
    python chip_smoke.py --four-cards # the multi-device path, four cards

One process drives the card.  Phases, in order:

1. the card's name and power limit (``nvidia-smi``, from a child process
   that stays off JAX);
2. every device kernel of the main path at its real width, against its
   plain reference: the flagship dense-factor H·v (f32 at HIGHEST and
   f64) vs the host ``op.matvec_np``, and the Ns=16 block-sparse SpMM
   (f32 and bf16 tiles) vs a host CSR product, each with its time and
   ``memory_analysis()``;
3. the main path: the flagship 2x2 plaquette + 2 replica baths (Ns=12,
   U=4, beta=100, ``ed_precision="mixed"``) through ``EDSolver`` and
   ``run_dmft_loop``, cut from 20 iterations to ``--loops``.  The first
   iteration's ground energy is checked against host ``eigsh`` on the
   reported ground sector, and its G(iw) against the same solve on the
   card's complex128 path;
4. the Ns=16 ground state (plaquette + 3 baths, sector dim 1.66e8)
   through the ``diag.py`` kit dispatch (f32/bf16 Krylov + f64 refine),
   with its explicit f64 residual and the peak device memory.

Any failed phase fails the run: exit code 1 and no result line.  Without
a GPU it exits 2 before any phase.  The last line of a passing run is
``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# (bath replicas, N_up, N_dw) of the half-filled sectors
FLAGSHIP = (2, 6, 6)      # Ns=12, sector dim 924^2 = 853,776
LARGE = (3, 8, 8)         # Ns=16, sector dim 12870^2 = 1.66e8


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def say(*a):
    print(*a, flush=True)


def check(name, ok, detail):
    say(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def timed(fn, *args, reps=20):
    """(seconds per call, result, compiled) for a jitted fn; compile and
    warm-up stay outside the timed window."""
    import jax
    compiled = jax.jit(fn).lower(*args).compile()
    out = compiled(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out, compiled


def mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes / 1e6:.1f} MB, "
            f"out {m.output_size_in_bytes / 1e6:.1f} MB, "
            f"temp {m.temp_size_in_bytes / 1e6:.1f} MB")


def plaquette_op(nbath, nup, ndw):
    sys.path.insert(0, HERE)
    import __graft_entry__ as ge
    return ge._plaquette_bath_op(nbath=nbath, nup=nup, ndw=ndw)


# -- phase 2: kernels -----------------------------------------------------------

def phase_flagship_hv():
    import jax.numpy as jnp
    from cdmft_lanc_ed_tpu.ops import split
    _, op = plaquette_op(*FLAGSHIP)
    rng = np.random.default_rng(0)
    v = rng.normal(size=op.dim)
    ref = op.matvec_np(v.astype(np.complex128)).real
    scale = np.abs(ref).max()
    # f32: ~20 f32 roundings per entry of a sum of O(10)-term products;
    # f64: the same at double precision
    for dtype, prec, tol in ((jnp.float32, "f32 HIGHEST", 1e-5),
                             (jnp.float64, "f64", 1e-12)):
        dev = split.to_device_dense_real(op, dtype=dtype)
        x = jnp.asarray(v.reshape(op.dim_dw, op.dim_up), dtype)
        s, out, c = timed(split.matvec_dense_real, dev, x, reps=50)
        err = float(np.abs(np.asarray(out).reshape(-1) - ref).max() / scale)
        check(f"flagship H·v {prec} (dim {op.dim}) vs op.matvec_np",
              err <= tol, f"rel err {err:.2e} <= {tol:.0e}; "
              f"{s * 1e6:.1f} us/H·v; {mem(c)}")


def phase_ns16_spmm():
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from cdmft_lanc_ed_tpu.ops import large
    _, op = plaquette_op(*LARGE)
    f = large.block_factor_of(op.h_dw, real=True)
    nb, ddp = f.nb, f.nb * large.B
    rows = np.repeat(np.arange(op.dim_dw), op.h_dw.cols.shape[1])
    csr = sp.csr_matrix((op.h_dw.vals.real.ravel(),
                         (rows, op.h_dw.cols.ravel())),
                        shape=(ddp, ddp))
    rng = np.random.default_rng(1)
    x = np.zeros((ddp, ddp), np.float32)
    x[:op.dim_dw, :op.dim_up] = rng.normal(size=(op.dim_dw, op.dim_up))
    ref = csr @ x.astype(np.float64)
    scale = np.abs(ref).max()
    rb, cb = jnp.asarray(f.row_blk), jnp.asarray(f.col_blk)
    xd = jnp.asarray(x)
    say(f"  Ns=16 dw factor: {len(f.row_blk)} tiles of {large.B}x"
        f"{large.B} over {nb} row blocks; x [{ddp}, {ddp}] f32")
    # tiles are hopping amplitudes, exact in bf16; products accumulate at
    # f32 (HIGHEST), sums over <= 10 tiles x 128 terms
    for tdt in (jnp.float32, jnp.bfloat16):
        tiles = jnp.asarray(f.tiles, tdt)
        s, y, c = timed(lambda r, c_, t, v: large._blk_spmm(r, c_, t, v, nb),
                        rb, cb, tiles, xd)
        err = float(np.abs(np.asarray(y, np.float64) - ref).max() / scale)
        check(f"Ns=16 SpMM {jnp.dtype(tdt).name} tiles vs host CSR",
              err <= 1e-5, f"rel err {err:.2e} <= 1e-05; {s * 1e3:.3f} ms; "
              f"{mem(c)}")
    del xd, y
    jax.clear_caches()


# -- phase 3: the flagship DMFT loop ----------------------------------------------

def flagship_solver(work_dir, nloop):
    from cdmft_lanc_ed_tpu import EDConfig, EDSolver
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=FLAGSHIP[0], uloc=[4.0],
                   beta=100.0, lmats=256, lreal=32, lfit=128,
                   nloop=nloop, dmft_error=2e-5, nsuccess=1,
                   ed_precision="mixed", ed_verbose=3, work_dir=work_dir)
    solver = EDSolver(cfg)
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), complex)
    for i in range(4):
        basis[0, i, i, 0, 0, 0, 0] = 1.0
    solver.set_hbath(basis, np.linspace(-1.0, 1.0, cfg.nbath)[:, None])
    return solver, solver.init_solver()


def phase_dmft(loops, log_path):
    import scipy.sparse.linalg as sla
    from cdmft_lanc_ed_tpu.dmft_loop import run_dmft_loop
    from cdmft_lanc_ed_tpu.models.hubbard import square_cluster_hk
    from cdmft_lanc_ed_tpu.utils import fock
    hk, hloc = square_cluster_hk(2, 2, nk=10)
    solver, bath0 = flagship_solver(tempfile.mkdtemp(prefix="smoke_k_"),
                                    loops)
    flog = open(log_path, "w")
    marks, stages, first = [], [], {}

    def log(s):
        flog.write(f"{time.time():.3f} {s}\n")
        flog.flush()
        if not s.startswith("DMFT loop"):
            return
        marks.append(time.time())
        if len(marks) > 1:
            stages.append(dict(solver.timers.totals))
        if len(marks) == 2:
            # iteration 1 is done: keep what the checks below need
            gs = solver.diag_state.state_list[0]
            first.update(egs=solver.egs, gmats=solver.gimp_matsubara().copy(),
                         sector=fock.get_quantum_numbers(gs.isector,
                                                         solver.cfg.ns),
                         build=solver._sector_builder())

    res = run_dmft_loop(solver, hk, hloc, bath0, wmixing=0.6, log=log,
                        max_loops=loops)
    marks.append(time.time())
    stages.append(dict(solver.timers.totals))
    walls = np.diff(marks)
    for i, (w, st) in enumerate(zip(walls, stages), 1):
        say(f"  iteration {i}: {w:.2f} s wall; " + ", ".join(
            f"{k} {v:.2f} s" for k, v in st.items()))
    say(f"  set-up: iteration 1 includes compilation; compile share "
        f"~{walls[0] - np.median(walls[1:]):.1f} s (iteration 1 minus the "
        f"median of the warm ones)" if len(walls) > 1 else
        f"  set-up: iteration 1 (with compilation) {walls[0]:.2f} s")
    check("DMFT loop outputs finite", bool(
        np.isfinite(res.solver.egs) and np.isfinite(res.error)
        and np.isfinite(res.solver.sigma_matsubara()).all()),
        f"egs {res.solver.egs:.10f}, error {res.error:.3e} after "
        f"{res.iterations} iterations")

    # EGS of iteration 1 vs host eigsh on the reported ground sector
    nup, ndw = first["sector"]
    op = first["build"](nup, ndw)
    lo = sla.LinearOperator((op.dim, op.dim), dtype=np.complex128,
                            matvec=lambda v: op.matvec_np(
                                np.asarray(v, np.complex128).ravel()))
    t0 = time.time()
    e_host = float(sla.eigsh(lo, k=1, which="SA", tol=1e-12,
                             return_eigenvectors=False)[0])
    err = abs(first["egs"] - e_host)
    # mixed path: f64 Rayleigh quotient of a 1e-10-residual vector
    check(f"iteration-1 EGS vs host eigsh, sector ({nup},{ndw}) "
          f"dim {op.dim}", err <= 1e-8,
          f"{first['egs']:.12f} vs {e_host:.12f}, |diff| {err:.1e} <= "
          f"1e-08 (eigsh {time.time() - t0:.1f} s)")

    # G(iw) of iteration 1 vs the same solve on the complex128 path
    os.environ["CDMFT_SPLIT_BACKEND"] = "0"
    try:
        ref, bath_c = flagship_solver(tempfile.mkdtemp(prefix="smoke_c_"),
                                      1)
        t0 = time.time()
        ref.solve(bath_c, hloc)
    finally:
        del os.environ["CDMFT_SPLIT_BACKEND"]
    gk, gc = first["gmats"], ref.gimp_matsubara()
    err = float(np.abs(gk - gc).max() / np.abs(gc).max())
    # both GF chains are f64; the kit path's retained vectors carry the
    # mixed solver's 1e-10 residual
    check("iteration-1 G(iw) vs complex128 path", err <= 1e-6,
          f"max rel diff {err:.2e} <= 1e-06 (complex128 solve "
          f"{time.time() - t0:.1f} s)")


# -- phase 4: Ns=16 ground state ------------------------------------------------------

def phase_ns16_ground_state():
    import jax
    import jax.numpy as jnp
    from cdmft_lanc_ed_tpu import EDConfig
    from cdmft_lanc_ed_tpu.diag import DiagState, diagonalize_impurity
    from cdmft_lanc_ed_tpu.ops import large
    from cdmft_lanc_ed_tpu.utils import fock
    _, op = plaquette_op(*LARGE)
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=LARGE[0], uloc=[4.0],
                   ed_precision="mixed", lanc_nstates_sector=1,
                   ed_verbose=3, work_dir=tempfile.mkdtemp(prefix="ns16_"))
    state = DiagState(cfg)
    state.sectors_mask[:] = False
    state.sectors_mask[fock.get_sector(op.nup, op.ndw, cfg.ns) - 1] = True
    t0 = time.time()
    diagonalize_impurity(state, lambda nup, ndw: op,
                         log=lambda s: say(f"    {s}"))
    dt = time.time() - t0
    gs = state.state_list[0]
    e0 = float(gs.energy)
    x = jnp.asarray(gs.vector, jnp.float64).reshape(op.dim_dw, op.dim_up)
    dev = large.to_device_large_real(op, dtype=jnp.float64)
    ddp, dup = dev.diag.shape
    xp = jnp.pad(x, ((0, ddp - op.dim_dw), (0, dup - op.dim_up)))
    w = jax.jit(large.matvec_large_real)(dev, xp)
    resid = float(jnp.linalg.norm(w - e0 * xp) / jnp.linalg.norm(xp))
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", float("nan"))
    check(f"Ns=16 ground state (dim {op.dim}) finite, f64 residual",
          bool(np.isfinite(e0) and resid <= 1e-6),
          f"E0 {e0:.10f}, explicit f64 residual {resid:.2e} <= 1e-06; "
          f"solve {dt:.1f} s (with compilation); peak_bytes_in_use "
          f"{peak / 1e9:.2f} GB")


# -- --four-cards: the multi-device path -------------------------------------------

def phase_four_cards():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from cdmft_lanc_ed_tpu.ops import large, lanczos, split
    from cdmft_lanc_ed_tpu.parallel import multichip
    from cdmft_lanc_ed_tpu.parallel import sharded_large as sl
    from cdmft_lanc_ed_tpu.parallel.sharded_spmv import (
        sharded_matvec_pair_flat, sharded_matvec_real_flat)
    devs = jax.devices()
    check("four devices", len(devs) == 4, f"{len(devs)} x "
          f"{devs[0].device_kind}")
    mesh_dw = Mesh(np.asarray(devs), ("dw",))
    rng = np.random.default_rng(3)

    # dw-sharded dense-factor H·v at the flagship sector vs one card
    _, op = plaquette_op(*FLAGSHIP)
    v = rng.normal(size=op.dim)
    one = split.to_device_dense_real(op, dtype=jnp.float64)
    w1 = np.asarray(split.matvec_dense_real(
        one, jnp.asarray(v.reshape(op.dim_dw, op.dim_up)))).reshape(-1)
    mv = jax.jit(sharded_matvec_real_flat(op, mesh_dw))
    s, w4, _ = timed(mv, jnp.asarray(v), reps=20)
    err = float(np.abs(np.asarray(w4) - w1).max() / np.abs(w1).max())
    check("flagship real H·v, 4-card dw-sharded vs one card", err <= 1e-12,
          f"rel diff {err:.1e} <= 1e-12 (f64); {s * 1e6:.1f} us/H·v")
    vi = rng.normal(size=op.dim)
    mvp = jax.jit(sharded_matvec_pair_flat(op, mesh_dw))
    s, (wr, wi), _ = timed(mvp, jnp.asarray(v), jnp.asarray(vi), reps=20)
    w1i = np.asarray(split.matvec_dense_real(
        one, jnp.asarray(vi.reshape(op.dim_dw, op.dim_up)))).reshape(-1)
    err = float(max(np.abs(np.asarray(wr) - w1).max(),
                    np.abs(np.asarray(wi) - w1i).max()) / np.abs(w1).max())
    check("flagship pair H·v, 4-card dw-sharded vs one card", err <= 1e-12,
          f"rel diff {err:.1e} <= 1e-12 (f64); {s * 1e6:.1f} us/H·v")

    # block-sparse sharded kernel at the Ns=16 factors vs one card
    _, op16 = plaquette_op(*LARGE)
    x = rng.normal(size=op16.dim).astype(np.float32)
    dev1, _, embed, extract = large.build_real_padded_large(
        op16, dtype=jnp.float32)
    y1 = np.asarray(extract(jax.jit(large.apply_large_real_flat)(
        dev1, embed(jnp.asarray(x)))))
    del dev1
    op_sh = sl.build_sharded_large_real(op16, mesh_dw, dtype=jnp.float32)
    s, y4, _ = timed(sl.apply_sharded_large_real_flat, op_sh,
                     jnp.asarray(x), reps=5)
    err = float(np.abs(np.asarray(y4) - y1).max() / np.abs(y1).max())
    check("Ns=16 block-sparse H·v, 4-card sharded vs one card",
          err <= 1e-5, f"rel diff {err:.1e} <= 1e-05 (f32); "
          f"{s * 1e3:.2f} ms/H·v")
    del op_sh, y4

    # the sector-parallel batched mixed eigensolver at flagship sizes:
    # four same-bucket sectors, one per card, vs dense eigh per sector
    mesh = multichip.make_mesh(4, 4)
    nb, nh, _ = FLAGSHIP
    ops = [plaquette_op(nb, nh + du, nh + dd)[1]
           for du, dd in ((-1, 0), (0, -1), (0, 0), (1, 0))]
    ddp = max(split._bucket(o.dim_dw) for o in ops)
    dup = max(split._bucket(o.dim_up) for o in ops)
    v0 = np.stack([split.embed_real(rng.normal(size=o.dim), o.dim_dw,
                                    o.dim_up, ddp, dup) for o in ops])
    t0 = time.time()
    res = lanczos.lanczos_eigh_mixed_real_batched(
        split.apply_real_flat_batched, split.apply_real_flat_batched,
        len(ops), ddp * dup, neigen=1, ncv=20, maxiter=2000, tol=1e-10,
        v0=v0, op32=multichip.shard_batched_stack(
            split.stack_real_ops(ops, (ddp, dup), dtype=jnp.float32), mesh),
        op64=multichip.shard_batched_stack(
            split.stack_real_ops(ops, (ddp, dup)), mesh), batch_mesh=mesh)
    dt = time.time() - t0
    for o, r in zip(ops, res):
        e4 = float(r.eigenvalues[0])
        one = lanczos.lanczos_eigh_real(
            split.apply_real_flat, ddp * dup, neigen=1, ncv=20,
            maxiter=2000, tol=1e-12, op=split.to_device_dense_real(
                o, pad_to=(ddp, dup)),
            v0=split.embed_real(rng.normal(size=o.dim), o.dim_dw,
                                o.dim_up, ddp, dup))
        e1 = float(one.eigenvalues[0])
        check(f"sector-parallel mixed eigensolve, sector dims "
              f"{o.dim_dw}x{o.dim_up}, 4 cards vs one-card f64 solve",
              abs(e4 - e1) <= 1e-8, f"{e4:.12f} vs {e1:.12f}")
    say(f"  batched 4-sector solve {dt:.1f} s (with compilation)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path on four cards")
    ap.add_argument("--loops", type=int, default=3,
                    help="DMFT iterations of the main path (of 20)")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_enable_x64", True)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend '{jax.default_backend()}'); "
              f"refusing to run", file=sys.stderr)
        sys.exit(2)
    import cdmft_lanc_ed_tpu  # noqa: F401  (the program must be here)

    say(f"card: {card_line()}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    if args.four_cards:
        phases = [("multi-device path", phase_four_cards)]
    else:
        phases = [
            ("kernels: flagship dense-factor H·v", phase_flagship_hv),
            ("kernels: Ns=16 block-sparse SpMM", phase_ns16_spmm),
            (f"main path: flagship DMFT loop, {args.loops} of 20 "
             f"iterations", lambda: phase_dmft(
                 args.loops, os.path.join(HERE, "chiprun_out",
                                          "smoke_dmft.log"))),
            ("Ns=16 ground state", phase_ns16_ground_state),
        ]
    failed = []
    for name, fn in phases:
        say(f"== {name}")
        t0 = time.time()
        try:
            fn()
        except Exception as e:      # report every phase, then fail the run
            import traceback
            traceback.print_exc()
            failed.append(name)
            say(f"  phase FAILED: {type(e).__name__}: {e}")
        say(f"  ({time.time() - t0:.1f} s)")
    if failed:
        say(f"FAILED phases: {failed}")
        sys.exit(1)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
