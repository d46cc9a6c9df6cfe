"""Self-validating difference-method timing for the round benchmarks.

A plain ``(t(big) - t(small))/span`` difference with few repetitions can
come out NEGATIVE when the signal is smaller than the run-to-run jitter,
and nothing would check the sign.  This harness validates its own output
and refuses to print nonsense.

Contract of :func:`per_step`:

* median over >= ``pairs`` (default 5) alternating (small, big) difference
  pairs — alternation cancels slow drift, the median kills latency spikes;
* every accepted measurement must satisfy ``t(big) > t(small)`` on a
  majority of pairs AND ``median dt > 0``;
* the step spread is auto-sized so the *signal* ``dt * (s_big - s_small)``
  is at least ``target_signal`` seconds (default 1.5 s — an order of
  magnitude above typical dispatch jitter); a violated attempt retries with
  a 10x larger spread;
* after ``max_retries`` failed attempts the process exits non-zero — a
  nonsense number is never emitted.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np


class BenchTimingError(RuntimeError):
    pass


def per_step(chain, v, *, readback=None, s_small=10, span=300,
             pairs=5, target_signal=1.5, max_retries=3, max_span=2_000_000,
             label="bench", verbose=True):
    """Seconds per step of ``chain(v, steps)``, validated.

    ``chain`` must be callable as ``chain(v, steps)`` where ``steps`` is a
    static step count; ``readback(result)`` forces device completion plus a
    host transfer (defaults to ``np.asarray`` of the full result).
    Returns ``(dt, stats)`` where ``stats`` carries the accepted attempt's
    raw pairs for the caller's stderr trail.
    """
    if readback is None:
        readback = np.asarray
    span = int(span)
    last_err = "no attempt run"
    for attempt in range(max_retries + 1):
        s_big = s_small + span
        # compile + warm both shapes (first call includes compile; second
        # warms any lazy caches)
        for s in (s_small, s_big):
            readback(chain(v, s))
            readback(chain(v, s))
        raw = []
        for _ in range(pairs):
            t0 = time.perf_counter()
            readback(chain(v, s_small))
            t_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            readback(chain(v, s_big))
            t_b = time.perf_counter() - t0
            raw.append((t_s, t_b))
        diffs = [(tb - ts) / span for ts, tb in raw]
        dt = statistics.median(diffs)
        n_ordered = sum(tb > ts for ts, tb in raw)
        signal = dt * span
        ok = dt > 0 and n_ordered >= (len(raw) // 2 + 1) \
            and signal >= target_signal
        if verbose:
            print(f"# {label}: attempt {attempt} span={span} "
                  f"dt={dt*1e6:.1f}us signal={max(signal, 0):.2f}s "
                  f"ordered={n_ordered}/{len(raw)} "
                  f"spread=[{min(diffs)*1e6:.1f},{max(diffs)*1e6:.1f}]us "
                  f"{'OK' if ok else 'RETRY'}",
                  file=sys.stderr, flush=True)
        if ok:
            return dt, {"span": span, "pairs": raw, "diffs": diffs,
                        "attempt": attempt}
        if dt > 0:
            # positive but under-resolved: size the spread from the
            # estimate so the next attempt lands ~2x the target signal
            want = int(np.ceil(2.0 * target_signal / dt))
            span = min(max(want, span * 2), max_span)
            last_err = f"signal {signal:.3f}s < {target_signal}s"
        else:
            span = min(span * 10, max_span)
            last_err = f"non-positive dt={dt:.3e}s ({n_ordered} ordered)"
    raise BenchTimingError(
        f"{label}: timing did not validate after {max_retries + 1} "
        f"attempts (last: {last_err}); refusing to emit a number")


def run_validated(fn, label="bench"):
    """Run ``fn`` and exit non-zero (without a JSON line) on timing
    nonsense, so the driver records the failure instead of a bad value."""
    try:
        fn()
    except BenchTimingError as e:
        print(f"# BENCH INVALID: {e}", file=sys.stderr)
        sys.exit(3)
