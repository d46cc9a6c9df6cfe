#!/usr/bin/env python
"""Time-to-converged DMFT loop on the 2x2 plaquette (BASELINE metric 2).

Runs the full production CDMFT loop — mixed-precision diagonalization,
batched GF-Lanczos, k-summed G_loc, Weiss self-consistency, autodiff chi2
bath fit, bath mixing, convergence check — on the real attached chip and
prints one JSON line with the converged-loop wall time.

It also reports:
* per-stage SOLVER-ISSUED dispatch counts (utils/dispatch.py) — the meter
  for the fused-restart rounds (one device call per thick restart instead
  of three plus two blocking transfers);
* a warm per-loop stage breakdown (every loop after the first runs with
  hot compile caches — the amortized cost a production DMFT run pays).
The DMFT error and ground-state energy live in named fields.

Configuration: 2x2 Hubbard plaquette + 2 replica baths (Ns=12 — the
largest flagship served with dense factors; the 4-replica variant is the
Ns=20 regime).
"""
import faulthandler
import json
import sys
import time

import numpy as np



def main():
    faulthandler.dump_traceback_later(240, repeat=True, file=sys.stderr)
    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ".")
    from cdmft_lanc_ed_tpu import EDConfig, EDSolver
    from cdmft_lanc_ed_tpu.dmft_loop import run_dmft_loop
    from cdmft_lanc_ed_tpu.models.hubbard import square_cluster_hk
    from cdmft_lanc_ed_tpu.utils import dispatch

    import tempfile
    wd = tempfile.mkdtemp(prefix="bench_dmft_")
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=2, uloc=[4.0],
                   beta=100.0, lmats=256, lreal=32, lfit=128,
                   nloop=20, dmft_error=2e-5, nsuccess=1,
                   ed_precision="mixed", ed_verbose=3, work_dir=wd)
    hk, hloc = square_cluster_hk(2, 2, nk=10)
    solver = EDSolver(cfg)
    basis = np.zeros((1, 4, 4, 1, 1, 1, 1), complex)
    for i in range(4):
        basis[0, i, i, 0, 0, 0, 0] = 1.0
    solver.set_hbath(basis, np.linspace(-1.0, 1.0, cfg.nbath)[:, None])
    bath = solver.init_solver()

    dispatch.enable(True)
    stage_names = ("diagonalization", "greens_functions", "observables")
    stages_s = {n: [] for n in stage_names}
    disp_per_loop = []
    loop_wall = []
    snap = {"totals": {}, "disp": 0, "t": None}

    def _snapshot():
        tm = getattr(solver, "timers", None)
        if tm is None:
            return
        for n in stage_names:
            cur = tm.totals.get(n, 0.0)
            stages_s[n].append(round(cur - snap["totals"].get(n, 0.0), 2))
            snap["totals"][n] = cur
        cur_d = dispatch.total()
        disp_per_loop.append(cur_d - snap["disp"])
        snap["disp"] = cur_d
        if snap["t"] is not None:
            loop_wall.append(round(time.time() - snap["t"], 2))
        snap["t"] = time.time()

    def log(s):
        print("#", s, file=sys.stderr, flush=True)
        if s.startswith("DMFT loop") and snap["totals"]:
            _snapshot()
        elif s.startswith("DMFT loop") and snap["t"] is None:
            snap["t"] = time.time()

    t0 = time.time()
    res = run_dmft_loop(solver, hk, hloc, bath, wmixing=0.6, log=log)
    _snapshot()
    dt = time.time() - t0

    per_stage = dispatch.summary()
    warm_loops = loop_wall[1:] if len(loop_wall) > 1 else loop_wall
    out = {
        "metric": "dmft_loop_2x2_plaquette_s",
        "value": float(f"{dt:.4g}"),
        "unit": "s",
        "converged": bool(res.converged),
        "iterations": int(res.iterations),
        "final_error": float(f"{res.error:.4g}"),
        "egs": float(f"{res.solver.egs:.8f}"),
        "density": float(f"{float(np.sum(res.solver.dens())):.6f}"),
        "stages_s": stages_s,
        "loop_wall_s": loop_wall,
        "warm_loop_s_median": float(np.median(warm_loops)) if warm_loops
        else None,
        "dispatches_per_loop": disp_per_loop,
        "dispatch_sites": {st: cnt for st, cnt in
                           sorted((s, d.get("total", 0))
                                  for s, d in per_stage.items())},
    }
    print(json.dumps(out))
    print(f"# converged={res.converged} iters={res.iterations} "
          f"err={res.error:.3e} egs={res.solver.egs:.8f} "
          f"dispatches={dispatch.total()} "
          f"device={jax.devices()[0].device_kind} workdir={wd}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
