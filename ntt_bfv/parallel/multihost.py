"""Multi-process runtime setup.

The reference is single-process/single-GPU; this is the distributed
backend called for by SURVEY.md §2.2: the standard JAX multi-controller
runtime (`jax.distributed.initialize`) plus a helper that lays a
('rns', 'coef') mesh over every device of every process.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Start the JAX multi-controller runtime.  Pass the coordinator
    address (e.g. "localhost:<port>"), the process count and this
    process's id; nothing in a plain GPU host provides them.  Call
    exactly once per process before any other JAX API."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(rns: int | None = None, coef: int | None = None) -> Mesh:
    """('rns', 'coef') mesh over every device of the (multi-process)
    runtime.  By default every device goes on 'rns', the axis with the
    fewest collectives (BEHZ's reduction and the last-residue
    broadcast); pass `coef` to shard coefficients as well.  Device
    order: jax.devices() enumerates all processes' devices
    process-major, so each coef group stays within one process when coef
    <= the local device count."""
    devs = np.array(jax.devices())
    total = devs.size
    if coef is None:
        coef = 1
    if rns is None:
        rns = total // coef
    if rns * coef != total:
        raise ValueError(f"rns*coef = {rns}*{coef} != {total} devices")
    return Mesh(devs.reshape(rns, coef), ("rns", "coef"))


def is_coordinator() -> bool:
    return jax.process_index() == 0
