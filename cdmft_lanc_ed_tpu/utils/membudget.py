"""Device-derived memory budgets for the host-side chunkers.

The GF injection batcher, the diag group chunker, and the refine subspace
caps all bound their working sets by a byte budget: a FRACTION of the
actual per-device memory when the backend reports it, with a 2 GB
constant as the fallback (the CPU test mesh reports nothing) (reference analog: the MPI code simply divides the sector
over ranks and trusts the allocation to fit,
/root/reference/ED_HAMILTONIAN.f90:93-105).
"""
from __future__ import annotations

import os

_FALLBACK = int(2e9)
_cache = {}


def device_memory_bytes():
    """(bytes, measured) per device, queried once per process.  GPU
    backends report ``bytes_limit`` via memory_stats(); the CPU test mesh
    reports nothing and gets (2 GB, False) — host RAM is shared by 8
    virtual devices, and the legacy constants were tuned for that case."""
    if "total" in _cache:
        return _cache["total"]
    env = os.environ.get("CDMFT_DEVICE_MEM_BYTES")
    if env:
        _cache["total"] = (int(float(env)), True)
        return _cache["total"]
    total, measured = _FALLBACK, False
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats()
        if stats and int(stats.get("bytes_limit", 0)) > 0:
            total, measured = int(stats["bytes_limit"]), True
    except Exception:
        pass
    _cache["total"] = (total, measured)
    return _cache["total"]


def budget_bytes(fraction: float = 0.25, log=None, what: str = "") -> int:
    """``fraction`` of the measured device memory (floored at 256 MB);
    the legacy 2 GB constant when the backend reports no memory stats.
    ``log`` (optional callable) records the choice at ed_verbose>=3."""
    total, measured = device_memory_bytes()
    b = max(int(total * fraction), 256 << 20) if measured else _FALLBACK
    if log is not None:
        log(f"membudget: {what or 'chunker'} = {b / 1e9:.2f} GB "
            f"({f'{fraction:.0%} of {total / 1e9:.2f} GB' if measured else 'fallback'})")
    return b
