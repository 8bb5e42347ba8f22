"""Device-mesh sharding of the subdomain batch axis.

The reference's parallel model is domain decomposition over MPI ranks
(reference src/HYMLS_BasePartitioner.cpp:361-586 assigns subdomains to
ranks; Epetra_Import/Export move halo data).  Here every batched
per-subdomain array (interior inverses, Schur contributions, block
solves) carries a `NamedSharding` over the 'sd' mesh axis, and XLA
GSPMD inserts the equivalents of the reference's imports/exports
(all-gathers / reduce-scatters between devices) around the global
gather/scatter ops.  The devices of one host are joined all to all, so
the mesh takes `jax.devices()` in order.

This round: constraint-based GSPMD sharding (correct, compiles
multi-device); later rounds add shard_map halo pipelines for the hot
paths.
"""
from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_ACTIVE_MESH: Optional[Mesh] = None


def make_mesh(n_devices: Optional[int] = None, axis: str = "sd") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (axis,))


def set_mesh(mesh: Optional[Mesh]):
    """Activate (or deactivate with None) subdomain-axis sharding for
    subsequently traced compute/apply functions."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def shard_batch(x):
    """Constrain a batched (leading axis = subdomain/block) array to be
    sharded over the active mesh; no-op without a mesh or when the axis
    doesn't divide."""
    m = _ACTIVE_MESH
    if m is None or x.ndim < 1 or x.shape[0] % m.size != 0:
        return x
    spec = P(m.axis_names[0], *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(m, spec))
