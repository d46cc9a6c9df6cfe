"""ctypes loader for the native table builders (with auto-build).

The shared library is compiled on first use with g++ -O3 (the image carries
the toolchain but no pybind11; the C ABI + ctypes keeps the binding layer
dependency-free).  It is built for the generic target of the host's
architecture (no ``-march=native``) into ``native/build/``, named by the
hash of its source, so a library built on one host loads on any other of
that architecture and a changed source always rebuilds.  All entry points
have NumPy fallbacks in utils/fock.py — the framework works without a
compiler, just slower on huge sectors.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tables.cpp")
_BUILD = os.path.join(_HERE, "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_log = logging.getLogger(__name__)


def _so_path() -> str:
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(
        _BUILD, f"libcdmft_tables-{platform.machine()}-{key}.so")


def _build(so: str) -> bool:
    """Compile to a private name, then rename: concurrent builders (test
    workers) never load a half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        _log.warning("native tables: build failed (%s); using the NumPy "
                     "fallback", e)
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("CDMFT_NO_NATIVE"):
            _log.info("native tables: CDMFT_NO_NATIVE set; using the NumPy "
                      "fallback")
            return None
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _log.warning("native tables: load failed (%s); using the NumPy "
                         "fallback", e)
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        lib.sector_states.restype = ctypes.c_int64
        lib.sector_states.argtypes = [ctypes.c_int32, ctypes.c_int32, i64p]
        lib.hop_entries_multi.restype = ctypes.c_int64
        lib.hop_entries_multi.argtypes = [
            i64p, ctypes.c_int64, i32p, i32p, ctypes.c_int32,
            i64p, i64p, i8p, i32p]
        lib.number_op.restype = None
        lib.number_op.argtypes = [i64p, ctypes.c_int64, i32p,
                                  ctypes.c_int32, f64p]
        lib.imp_bath_split.restype = None
        lib.imp_bath_split.argtypes = [i64p, ctypes.c_int64,
                                       ctypes.c_int32, i64p, i64p]
        _lib = lib
        return _lib


def native_sector_states(ns: int, n: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    from math import comb
    out = np.empty(comb(ns, n) if 0 <= n <= ns else 0, dtype=np.int64)
    if out.size == 0:
        return out
    cnt = lib.sector_states(ns, n, out)
    return out[:cnt]


def native_hop_entries_multi(states: np.ndarray, a: np.ndarray,
                             b: np.ndarray):
    """(rows, cols, signs, term_id) for all hop terms at once, or None."""
    lib = get_lib()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, np.int64)
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    cap = len(states) * len(a)
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    signs = np.empty(cap, np.int8)
    tid = np.empty(cap, np.int32)
    cnt = lib.hop_entries_multi(states, len(states), a, b, len(a),
                                rows, cols, signs, tid)
    return rows[:cnt], cols[:cnt], signs[:cnt], tid[:cnt]
