"""cdmft_lanc_ed_tpu — Cluster-DMFT Lanczos-ED framework in JAX.

JAX/XLA implementation with the capabilities of the reference
Fortran CDMFT-LANC-ED code: exact diagonalization of cluster-impurity+bath
Hamiltonians with conserved (N_up, N_dw), Lanczos Green's functions, chi^2
bath fitting, and the lattice self-consistency layer (static shapes,
batched device linear algebra, sharded SpMM Lanczos).

The public facade mirrors the reference's ``USE CDMFT_ED`` API
(/root/reference/CDMFT_ED.f90:4-52) with pythonic names.
"""
import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Persistent XLA compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself), else one fixed directory inside the
    checkout.  The path is part of the cache key, so it never moves."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# sector-shaped kernels recompile across runs otherwise
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import EDConfig, ed_read_input, read_input
from .bath import (BathBasis, DmftBath, get_bath_dimension,
                   pack_dmft_bath, unpack_dmft_bath, set_hbath,
                   hbath_basis_from_hloc, delta_bath, g0and_bath, invg0_bath)
from .solver import EDSolver
from .eigenspace import EigenState, StateList
from .utils.reshape import lso2nnn, nnn2lso, so2nn, nn2so

__version__ = "0.1.0"
