"""Device-mesh helpers for the (rns, coef) 2-D parallelism layout.

The reference is single-GPU; its intra-device parallel structure maps onto
a device mesh as (SURVEY.md §2.2):

* grid-y RNS-modulus batching (P3)  -> 'rns' mesh axis (embarrassingly
  parallel except the BEHZ reduce and the last-modulus broadcast),
* the hybrid stage schedule's kernel-launch boundary (P2) -> the 'coef'
  mesh axis boundary: butterfly stages whose stride crosses the
  coefficient shard become ppermute exchanges between devices.

The cards of one host reach each other all to all at one rate, so the
mesh follows the algorithm alone: 'rns' is the axis with the fewest
collectives and takes every device unless a caller asks for 'coef'.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RNS_AXIS = "rns"
COEF_AXIS = "coef"


def make_mesh(rns: int = 1, coef: int = 1, devices=None) -> Mesh:
    """A (rns, coef) mesh.  rns*coef must equal the device count used."""
    if devices is None:
        devices = jax.devices()[: rns * coef]
    arr = np.asarray(devices).reshape(rns, coef)
    return Mesh(arr, (RNS_AXIS, COEF_AXIS))


def residue_sharding(mesh: Mesh, ndim: int = 2, shard_coef: bool = False) -> NamedSharding:
    """Sharding for a (..., r, n) residue tensor: RNS axis over 'rns',
    coefficient axis over 'coef' (or replicated)."""
    spec = [None] * (ndim - 2) + [RNS_AXIS, COEF_AXIS if shard_coef else None]
    return NamedSharding(mesh, P(*spec))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """(r, n) twiddle tables: sharded over 'rns', replicated over 'coef'."""
    return NamedSharding(mesh, P(RNS_AXIS, None))


def const_sharding(mesh: Mesh) -> NamedSharding:
    """(r, 1) per-modulus constants."""
    return NamedSharding(mesh, P(RNS_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
