"""Solver-issued device-call accounting.

The C++ jit fastpath cannot be intercepted from Python (verified on
this jax: neither MeshExecutable.call nor the jit_p impl fire on cache
hits), so the solvers count at their OWN dispatch sites: every ``tick``
is one issued jitted call or one blocking device->host transfer.  The
DMFT benchmark (bench_dmft.py) wraps its stages in :func:`stage` and
reports per-stage counts — each call pays a fixed dispatch latency, so
the count is the regression meter for the fused-restart work.

Counting is off unless :func:`enable` was called: production runs pay
one boolean check per site.
"""
from __future__ import annotations

import contextlib
from collections import Counter

COUNTS: Counter = Counter()
_STAGE = ["-"]
_ON = [False]


def enable(flag: bool = True) -> None:
    _ON[0] = flag
    COUNTS.clear()


def tick(tag: str, n: int = 1) -> None:
    """One device dispatch (or blocking transfer) at site ``tag``."""
    if _ON[0]:
        COUNTS[(_STAGE[0], tag)] += n


@contextlib.contextmanager
def stage(name: str):
    old = _STAGE[0]
    _STAGE[0] = name
    try:
        yield
    finally:
        _STAGE[0] = old


def summary() -> dict:
    """{stage: {tag: n, ..., "total": n}} snapshot."""
    out: dict = {}
    for (st, tag), n in COUNTS.items():
        out.setdefault(st, {})[tag] = n
    for st in out:
        out[st]["total"] = sum(out[st].values())
    return out


def total() -> int:
    return sum(COUNTS.values())
