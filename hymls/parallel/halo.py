"""Halo-exchange SpMV under shard_map.

The reference's operator apply communicates via Epetra_Import halo
exchanges between neighboring MPI ranks (reference
src/HYMLS_Preconditioner.cpp:973-980 and the Epetra Import plans).  The
device equivalent for the banded (DIA) stencil operator: shard the
vector over a 1D mesh, exchange fixed-width halos with the two ring
neighbors via `lax.ppermute` (neighbor traffic, no all-gather), and
apply the band stencil locally on each shard.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.spmv import DiaOperator


def dia_matvec_sharded(op: DiaOperator, mesh: Mesh, axis: str = "sd"):
    """Build y = A x with x/y sharded over `axis`; returns a function
    (bands, x) -> y usable under jit with the mesh active.

    bands: (k, n) prepared band array (op.prepare(vals)), sharded on
    the second axis; x: (n,) sharded.  Halo width = max |offset|; must
    be <= the local shard length."""
    from jax import shard_map

    n = op.n
    ndev = mesh.shape[axis]
    if n % ndev:
        raise ValueError(f"vector length {n} not divisible by {ndev}")
    local = n // ndev
    halo = op.pad
    if halo > local:
        raise ValueError("halo wider than shard")
    offsets = op.offsets.tolist()

    def kernel(bands_l, x_l):
        # bands_l: (k, local); x_l: (local,) on each shard
        right_edge = lax.ppermute(x_l[-halo:], axis,
                                  [(i, (i + 1) % ndev) for i in range(ndev)])
        left_edge = lax.ppermute(x_l[:halo], axis,
                                 [(i, (i - 1) % ndev) for i in range(ndev)])
        idx = lax.axis_index(axis)
        # non-periodic boundary: zero halos at the ends
        zero = jnp.zeros((halo,), dtype=x_l.dtype)
        lo = jnp.where(idx == 0, zero, right_edge)
        hi = jnp.where(idx == ndev - 1, zero, left_edge)
        x_pad = jnp.concatenate([lo, x_l, hi])
        y = jnp.zeros_like(x_l)
        for k, off in enumerate(offsets):
            y = y + bands_l[k] * lax.dynamic_slice(
                x_pad, (halo + off,), (local,))
        return y

    return shard_map(kernel, mesh=mesh,
                     in_specs=(P(None, axis), P(axis)),
                     out_specs=P(axis))
