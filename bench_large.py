#!/usr/bin/env python
"""Large-sector benchmark: H·v + ground-state solve on the Ns=16
flagship (2x2 plaquette + 3 replica baths, half-filled sector
C(16,8)^2 = 1.66e8 states) on one chip.

Rows (one JSON line each, bench.py schema):
* hier/tile f32 H·v and tile bf16 H·v, as nnz/s and ms per H·v;
* mixed-precision ground-state solve (``--solve``) — f32/bf16 Krylov on
  the tile kit + f64 Rayleigh refine on the hierarchical kit, reporting
  the EXPLICIT f64 residual of the retained vector, plus a warm second
  solve (compile caches hot — the amortized DMFT-loop cost).

Energies and residuals live in named fields.
"""
import json
import sys
import time
from functools import partial

import numpy as np

from bench_common import per_step, run_validated


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--solve", action="store_true",
                    help="run the mixed-precision (f32 Krylov + f64 "
                         "refine) ground-state solve of the Ns=16 "
                         "sector on the hierarchical kit")
    ap.add_argument("--hv-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ncv", type=int, default=10,
                    help="Krylov basis size of the thick-restart solve")
    ap.add_argument("--maxiter", type=int, default=120)
    ap.add_argument("--vec-rtol", type=float, default=1e-8,
                    help="refined-eigenvector residual target (1e-8 "
                         "matches the recorded E0 tolerance; the "
                         "production Sigma-grade default is 1e-10)")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from cdmft_lanc_ed_tpu.ops import hier_dev, large

    t0 = time.time()
    _, op = ge._plaquette_bath_op(nbath=3, nup=8, ndw=8)   # Ns=16
    nnz = op.nnz

    if args.solve:
        from cdmft_lanc_ed_tpu.ops import lanczos
        # TWO-KIT solve: f32/bf16 Krylov on the combinadic tile kernels,
        # f64 Rayleigh refine on the hierarchical kit (its f64 operator
        # is ~150 MB of tiles + KB dense blocks);
        # layout converters only need the two kits' (cheap) index data;
        # the heavy operators are built INSIDE one_solve and dropped —
        # the f32 tile kit lives only through the Krylov stage and the
        # f64 hier kit is built lazily after it (never coexisting)
        _kit = large.build_real_padded_large(op, dtype=jnp.float32)
        dim_p, embed, extract = _kit[1], _kit[2], _kit[3]
        _kit = hier_dev.build_real_padded_hier(op, dtype=jnp.float32)
        dim64, emb_h, ext_h = _kit[1], _kit[2], _kit[3]
        del _kit      # the converter only needs the (tiny) index data
        conv = (lambda a: emb_h(extract(a)),
                lambda a: embed(ext_h(a)), dim64)
        rng = np.random.default_rng(0)
        v0 = embed(rng.normal(size=op.dim).astype(np.float64))

        def one_solve(v0v):
            box = [large.build_real_padded_large(op, dtype=jnp.float32)
                   [0]]
            box.append(large.build_real_padded_large(
                op, dtype=jnp.bfloat16, reuse=box[0])[0])
            return lanczos.lanczos_eigh_mixed_real(
                large.apply_large_real_flat,
                hier_dev.apply_hier_real_flat_lowmem,
                dim_p, neigen=1, ncv=args.ncv, maxiter=args.maxiter,
                tol=1e-8, v0=v0v, op32=box.pop(0), op16=box.pop(0),
                op64=lambda: hier_dev.build_real_padded_hier(
                    op, dtype=jnp.float64)[0],
                device_vectors=True, vec_rtol=args.vec_rtol,
                convert64=conv)

        t1 = time.time()
        res = one_solve(v0)
        dt = time.time() - t1
        # explicit f64 residual of the retained vector: ||Hx - E0 x||,
        # computed through the f64 hier apply in ITS layout
        dev64 = hier_dev.build_real_padded_hier(op, dtype=jnp.float64)[0]
        x = conv[0](res.eigenvectors)[0].astype(jnp.float64)
        w = hier_dev.apply_hier_real_flat_lowmem(dev64, x)
        e0 = float(res.eigenvalues[0])
        resid = float(np.asarray(jnp.linalg.norm(w - e0 * x)
                                 / jnp.linalg.norm(x)))
        del dev64, w, x
        # warm second solve: same shapes, compile caches hot — the
        # amortized cost inside a DMFT loop
        v0b = embed(rng.normal(size=op.dim).astype(np.float64))
        t2 = time.time()
        res2 = one_solve(v0b)
        dt_warm = time.time() - t2
        print(json.dumps({
            "metric": "large_sector_ns16_gs_solve_s",
            "value": float(f"{dt:.4g}"), "unit": "s",
            "warm_solve_s": float(f"{dt_warm:.4g}"),
            "e0": float(f"{e0:.10f}"),
            "e0_warm": float(f"{float(res2.eigenvalues[0]):.10f}"),
            "f64_residual": float(f"{resid:.3g}"),
            "nmv": int(res.iterations),
            "converged": bool(res.converged),
            "precision": "f32 Krylov + f64 Rayleigh refine (hier kit)",
        }))
        print(f"# Ns=16 dim={op.dim} E0={e0:.10f} resid={resid:.2e} "
              f"nmv={res.iterations} cold={dt:.1f}s warm={dt_warm:.1f}s "
              f"build={t1-t0:.0f}s", file=sys.stderr)
        return

    # ---- H·v rows -------------------------------------------------------
    @partial(jax.jit, static_argnums=(2, 3))
    def chain_op(d, x, steps, which):
        def body(x, _):
            w = (hier_dev.matvec_hier_real(d, x) if which == "hier"
                 else large.matvec_large_real(d, x))
            return w / jnp.linalg.norm(w), None
        c, _ = jax.lax.scan(body, x, None, length=steps)
        return c

    def row(name, dev, which, extra=None):
        ddp, dup = dev.diag.shape
        rng = np.random.default_rng(0)
        x0 = np.zeros((ddp, dup), np.float32)
        x0[:op.dim_dw, :op.dim_up] = (
            rng.normal(size=(op.dim_dw, op.dim_up))
            / np.sqrt(op.dim)).astype(np.float32)
        x = jnp.asarray(x0)
        dt, _ = per_step(lambda xx, s: chain_op(dev, xx, s, which), x,
                         span=40, s_small=2,
                         readback=lambda r: np.asarray(r[0, :8]),
                         label=name)
        out = {
            "metric": f"large_sector_ns16_spmv_{name}_nnz_per_s",
            "value": float(f"{nnz / dt:.4g}"), "unit": "nnz/s",
            "dt_ms_per_hv": float(f"{dt * 1e3:.4g}"),
        }
        if extra:
            out.update(extra)
        print(json.dumps(out))
        return dt

    kit = hier_dev.build_real_padded_hier(op, dtype=jnp.float32)
    devh = kit[0]
    print(f"# build {time.time()-t0:.1f}s dim={op.dim} nnz={nnz} "
          f"hier tiles dw={devh.dw.tiles.shape[0]} "
          f"up={devh.up.tiles.shape[0]}",
          file=sys.stderr, flush=True)
    row("hier_f32", devh, "hier")
    del devh, kit

    devt = large.to_device_large_real(op, dtype=jnp.float32)
    row("tile_f32", devt, "tile")
    devt16 = large.to_device_large_real(op, dtype=jnp.bfloat16)
    row("tile_bf16", devt16, "tile")


if __name__ == "__main__":
    run_validated(main, "bench_large")
