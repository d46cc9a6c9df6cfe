"""Multi-host initialisation and mesh construction.

Entry point for multi-host runs (SURVEY.md section 7 step 10): wraps
``jax.distributed.initialize`` and builds the (sector x dw) mesh over all
hosts' devices.  On a single host it only builds the local mesh.  The
reference's multi-node story is mpirun + MPI communicators; here every
process runs the same SPMD program and the collectives ride the mesh.

Typical usage (one process per host):

    from cdmft_lanc_ed_tpu.parallel.distributed import init_distributed
    mesh = init_distributed("host0:1234", num_processes=2, process_id=0,
                            n_sector=2)
    from cdmft_lanc_ed_tpu.parallel import multichip
    multichip.set_solver_mesh(mesh)
    ... EDSolver runs with large sectors sharded across all hosts ...
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     n_sector: int = 1):
    """Initialise multi-process JAX when ``num_processes > 1`` and return
    the global ("sector", "dw") mesh over all devices."""
    import jax
    from jax.sharding import Mesh

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)

    devices = jax.devices()
    n = len(devices)
    while n % n_sector != 0:
        n_sector -= 1
    arr = np.asarray(devices).reshape(n_sector, n // n_sector)
    return Mesh(arr, ("sector", "dw"))
