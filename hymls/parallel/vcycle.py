"""Explicit shard_map V-cycle: per-shard subdomain elimination with
collective separator exchange.

This is the device equivalent of the reference's MPI data layout
(reference src/HYMLS_Preconditioner.cpp:930-1070 +
HYMLS_BasePartitioner.cpp:361-586): every rank owns a contiguous block
of subdomains and the full factor data for them; vectors are
exchanged.  Here each mesh device owns a block of the batched factor
arrays (A11inv / G / A21 and the per-subdomain index plans — the bulk
of the preconditioner's memory), the per-subdomain elimination and
back-substitution run shard-local as batched matmuls, and the (small)
separator/Schur stage runs replicated after one `all_gather` per
level — playing the role of the reference's Epetra_Export-with-Add
of separator contributions.  The coarse solve is replicated (the
reference deactivates ranks at coarse levels for the same reason).

GSPMD (`parallel/mesh.py:shard_batch`) already shards the compute
phase by constraint; this module makes the APPLY communication pattern
explicit and deterministic.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.preconditioner import _apply_ot, _bmm, _ext
from ..core.dense import dense_solve as _dense_solve


_SHARDED_FACTOR_KEYS = ("A11inv", "G", "A21")
_SHARDED_PLAN_KEYS = ("int_pos", "sd_sep_pos")


def _spec_trees(factors, aplans, ndev: int, axis: str):
    """(in_specs for factors, in_specs for plans, per-level sharded?)"""
    fspecs, pspecs, sharded = [], [], []
    for fac, dp in zip(factors["levels"], aplans):
        n_sd = fac["A11inv"].shape[0]
        sh = n_sd % ndev == 0
        sharded.append(sh)
        fspecs.append({k: (P(axis) if sh and k in _SHARDED_FACTOR_KEYS
                           else P()) for k in fac})
        pspecs.append({k: (P(axis) if sh and k in _SHARDED_PLAN_KEYS
                           else P()) for k in dp})
    return ({"levels": fspecs, "coarse": jax.tree.map(
        lambda _: P(), factors["coarse"])}, pspecs, sharded)


def make_sharded_apply(precond, mesh: Mesh) -> Callable:
    """Returns apply(factors, aplans, b) -> x running the V-cycle with
    the subdomain-batched factors sharded over `mesh` (explicit
    shard_map; falls back to replicated execution on levels whose
    subdomain count does not divide the mesh)."""
    axis = mesh.axis_names[0]
    ndev = mesh.size
    # the explicit shard_map V-cycle is built on the generic plan
    # arrays (the structured fast path has its own layout)
    factors = precond._prune_factors(precond.factors)
    aplans = precond._aplans_gen
    plans = precond.plans
    max_level = precond.max_level
    napply = [(p.n_nodes, p.n_sep) for p in plans]
    ots = [p.apply_ot for p in plans]
    fspecs, pspecs, sharded = _spec_trees(factors, aplans, ndev, axis)

    def level_fn(lev, b, factors, aplans, solve_next):
        fac = factors["levels"][lev]
        dp = aplans[lev]
        apply_ot = ots[lev]
        n_nodes, n_sep = napply[lev]
        dtype = b.dtype
        sh = sharded[lev]

        b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=dtype)])
        b1 = b_ext[dp["int_pos"]]                # shard-local block
        x1 = _bmm(fac["A11inv"], b1)
        y2c = _bmm(fac["A21"], x1)
        if sh:
            # Export-with-Add of separator contributions: gather all
            # shards' per-subdomain contributions, then sum (the sum
            # itself is cheap and runs replicated)
            y2c = jax.lax.all_gather(y2c, axis, tiled=True)
        y2 = jnp.sum(_ext(y2c.reshape(-1))[dp["sep_from_sd"]], axis=1)

        r2 = b[dp["sep_pos_in_nodes"]] - y2
        t = _apply_ot(r2, dp, apply_ot)

        t_ext = jnp.concatenate([t, jnp.zeros((1,), dtype=dtype)])
        yb = _bmm(fac["blkinv"], t_ext[dp["blk_pos"]])
        y = _ext(yb.reshape(-1))[dp["blk_inv_idx"]]

        x_next = solve_next(t[dp["vsum_pos"]])
        x_next_ext = jnp.concatenate(
            [x_next, jnp.zeros((1,), dtype=dtype)])
        n_vsum = dp["vsum_pos"].shape[0]
        y = jnp.where(dp["vsum_slot"] < n_vsum,
                      x_next_ext[dp["vsum_slot"]], y)
        x2 = _apply_ot(y, dp, apply_ot)

        x2_ext = jnp.concatenate([x2, jnp.zeros((1,), dtype=dtype)])
        x1 = x1 - _bmm(fac["G"], x2_ext[dp["sd_sep_pos"]])
        if sh:
            x1 = jax.lax.all_gather(x1, axis, tiled=True)
        src = jnp.concatenate([x1.reshape(-1), x2,
                               jnp.zeros((1,), dtype=dtype)])
        return src[dp["node_src"]]

    def local_fn(factors, aplans, b):
        def solve_at(lev, rhs):
            if lev == max_level:
                return _dense_solve(factors["coarse"], rhs)
            return level_fn(lev, rhs, factors, aplans,
                            partial(solve_at, lev + 1))
        return solve_at(0, b)

    fn = jax.shard_map(local_fn, mesh=mesh,
                       in_specs=(fspecs, pspecs, P()),
                       out_specs=P(), check_vma=False)
    return jax.jit(fn)


def shard_factors(precond, mesh: Mesh):
    """Place the factor/plan pytrees with the shardings
    make_sharded_apply expects (sharded batch axes live distributed,
    everything else replicated)."""
    axis = mesh.axis_names[0]
    # the explicit shard_map V-cycle is built on the generic plan
    # arrays (the structured fast path has its own layout)
    factors = precond._prune_factors(precond.factors)
    aplans = precond._aplans_gen
    fspecs, pspecs, _ = _spec_trees(factors, aplans, mesh.size, axis)

    def place(tree, specs):
        return jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            tree, specs)

    return place(factors, fspecs), [place(d, s)
                                    for d, s in zip(aplans, pspecs)]
