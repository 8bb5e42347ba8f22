"""Fully distributed Krylov solve: owner-sharded vectors end to end.

This is the production multichip path (reference: every Krylov
iteration communicates through Epetra_Import halo exchanges —
src/HYMLS_Preconditioner.cpp:973-1052 inside the preconditioner apply,
src/HYMLS_BaseSolver.cpp:309-359 around the Belos operator apply).

The design: the whole GMRES/CG state lives in the *owner
layout* of the halo V-cycle (`parallel/halo_vcycle.py`) — a flat
(ndev * max_owned,) vector whose shard s holds the interior nodes of
shard s's subdomains plus the separators it owns, zero-padded.  In that
layout

  * the preconditioner apply is the neighbor-halo V-cycle
    (ppermute-only level traffic, one small coarse all-gather),
  * the operator apply K·x is a per-shard ELL SpMV whose off-shard
    columns arrive by the same static-plan `lax.ppermute` exchange
    (built here), and
  * dots/axpys/norms are elementwise + psum — XLA GSPMD partitions
    them for free, and the zero padding makes them equal to the global
    quantities.

Nothing on the iteration path gathers the global vector; the only
all-gathers in the compiled program are the coarse-level rhs (one per
V-cycle, as in the reference's coarse-solve communicator restriction)
and the final solution readout.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .halo_vcycle import (HaloApply, UnshardableError, _Exchange,
                          _build_exchange, _finalize_sends,
                          _recv_offsets_table, _cat0, make_halo_apply)


def build_matvec_plan(K: sp.csr_matrix, gather_idx: np.ndarray,
                      L: int, ndev: int):
    """Static per-shard ELL + halo-exchange plan for y = K x in the
    owner layout.

    gather_idx[n] = owner(n) * L + local_slot(n) (from
    build_halo_plans' level-0 boundary maps).  Returns (plan_arrays,
    meta) where plan_arrays hold, per shard: the ELL column positions
    into [x_local ++ recv buffers ++ zero], the value-gather indices
    into the global CSR data array, and the ppermute send lists."""
    K = K.tocsr()
    K.sum_duplicates()
    K.sort_indices()
    n = K.shape[0]
    nnz = K.nnz
    own = gather_idx // L
    loc = gather_idx % L
    lens = np.diff(K.indptr)
    width = int(lens.max()) if nnz else 1
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    slots = np.arange(nnz, dtype=np.int64) - np.repeat(K.indptr[:-1],
                                                       lens)
    cols = K.indices.astype(np.int64)
    dsh = own[rows]                      # shard that computes the row
    ssh = own[cols]                      # shard that owns the column

    # one halo entry per distinct (column, needing shard) pair
    rem = np.nonzero(dsh != ssh)[0]
    if rem.size:
        pairs = np.unique(np.stack([cols[rem], dsh[rem]], axis=1),
                          axis=0)
        p_col, p_dst = pairs[:, 0], pairs[:, 1]
        ex, pos = _build_exchange(ndev, own[p_col], p_dst,
                                  loc[p_col], p_col)
    else:
        p_col = p_dst = np.zeros(0, dtype=np.int64)
        ex, pos = _Exchange(), {}
    _finalize_sends(ex, L)               # sender zero slot = cat0 tail
    rtab, zslot = _recv_offsets_table(ex, L)
    read_of = {}
    for i in range(p_col.size):
        d, rank = pos[int(i)]
        read_of[(int(p_col[i]), int(p_dst[i]))] = rtab[d] + rank

    colpos = np.empty(nnz, dtype=np.int64)
    loc_mask = dsh == ssh
    colpos[loc_mask] = loc[cols[loc_mask]]
    if rem.size:
        colpos[rem] = [read_of[(int(c), int(d))]
                       for c, d in zip(cols[rem], dsh[rem])]

    colidx = np.full((ndev, L, width), zslot, dtype=np.int64)
    vidx = np.full((ndev, L, width), nnz, dtype=np.int64)
    colidx[dsh, loc[rows], slots] = colpos
    vidx[dsh, loc[rows], slots] = np.arange(nnz)

    plan = {"mv_col": colidx, "mv_vidx": vidx}
    for d in ex.offsets:
        plan[f"mv_send_{d}"] = ex.send_idx[d]
    meta = {"offsets": ex.offsets, "width": width, "L": L}
    return plan, meta


class DistributedSolve:
    """Owner-sharded operator + preconditioner pair for a distributed
    Krylov solve over `mesh`.

    Exposes pure/shard_map callables designed to be embedded in a
    caller's jit (the Solver's GMRES program):

      scatter(b)            global (n,) -> flat owner (ndev*L,)
      gather(x_flat)        flat owner -> global (n,)
      prepare(vals)         CSR values -> per-shard ELL values
      matvec(pvals, x)      y = K x, ppermute halo exchange
      precond(factors, dplans, x)   halo V-cycle apply
      stack_factors(...)    generic factors -> sharded halo layout
    """

    def __init__(self, K: sp.csr_matrix, precond, mesh: Mesh):
        self.mesh = mesh
        self.axis = axis = mesh.axis_names[0]
        ndev = mesh.size
        self.app = make_halo_apply(precond, mesh)
        # distributed factorization (ppermute SC assembly, factors in
        # the halo layout) — when available the whole Newton step
        # (factor + Krylov solve) runs sharded; otherwise the factors
        # are computed replicated and stacked (stack_factors)
        try:
            from .dist_compute import DistributedCompute
            self.dcompute = DistributedCompute(precond, mesh)
        except UnshardableError:
            self.dcompute = None
        bm = self.app._bmaps
        L = bm["max_onod0"]
        self.L = L
        self.n = bm["n_nodes"]
        gidx = np.asarray(bm["gather_idx"], dtype=np.int64)
        plan, meta = build_matvec_plan(K, gidx, L, ndev)
        self.meta = meta
        self.mv_plan = {k: jnp.asarray(v, jnp.int32)
                        for k, v in plan.items()}
        self._scat = self.app._scatter       # (ndev, L) int32
        self._gath = self.app._gather        # (n,) int32
        self.dplans = self.app.dplans
        self.nnz = K.nnz

        self.prep_sm, self.mv_sm = self._mv_shard_maps(
            meta["offsets"], self.mv_plan)

    def _mv_shard_maps(self, offsets, plan):
        """shard_map (prepare, matvec) pair for one ELL+exchange plan
        (the primary K plan, or an extra operator from
        make_extra_matvec)."""
        mesh, axis, ndev = self.mesh, self.axis, self.mesh.size

        def shift(x, d):
            perm = [(i, i + d) for i in range(ndev)
                    if 0 <= i + d < ndev]
            return jax.lax.ppermute(x, axis, perm)

        def prep_local(vals, mvp):
            # vals replicated; per-shard ELL value block (L, width)
            return _cat0(vals)[mvp["mv_vidx"][0]]

        def mv_local(pv_l, mvp, x_l):
            x0 = _cat0(x_l)
            recvs = [shift(x0[mvp[f"mv_send_{d}"][0]], d)
                     for d in offsets]
            x_ext = jnp.concatenate(
                [x_l] + [r.reshape(-1) for r in recvs] +
                [jnp.zeros((1,), x_l.dtype)])
            return jnp.sum(pv_l * x_ext[mvp["mv_col"][0]], axis=1)

        mvspec = jax.tree.map(lambda _: P(axis), plan)
        prep_sm = jax.shard_map(
            prep_local, mesh=mesh, in_specs=(P(), mvspec),
            out_specs=P(axis), check_vma=False)
        mv_sm = jax.shard_map(
            mv_local, mesh=mesh,
            in_specs=(P(axis), mvspec, P(axis)),
            out_specs=P(axis), check_vma=False)
        return prep_sm, mv_sm

    def make_extra_matvec(self, K2: sp.csr_matrix):
        """Owner-layout SpMV plan for a SECOND operator on the same
        grid (the B part of a complex pencil A + iB, or a mass
        matrix): its own ELL + ppermute exchange plan over the same
        ownership.  Returns pure (prepare, matvec) callables
        (reference: ComplexOperator applies A and B as independent
        distributed Epetra operators, src/HYMLS_ComplexOperator.cpp)."""
        if K2.shape[0] != self.n:
            raise ValueError(
                f"extra operator size {K2.shape[0]} != grid {self.n}")
        gidx = np.asarray(self.app._bmaps["gather_idx"], np.int64)
        plan_np, meta = build_matvec_plan(K2.tocsr(), gidx, self.L,
                                          self.mesh.size)
        plan = {k: jnp.asarray(v, jnp.int32) for k, v in plan_np.items()}
        prep_sm, mv_sm = self._mv_shard_maps(meta["offsets"], plan)

        def prepare(vals):
            return prep_sm(vals, plan)

        def matvec(pvals, x_flat):
            return mv_sm(pvals, plan, x_flat)

        return prepare, matvec

    # --- pure building blocks (call inside jit) -------------------------
    def scatter(self, b):
        """Global (n,) -> flat owner (ndev*L,) with zero padding."""
        b_st = _cat0(b)[self._scat].reshape(-1)
        return jax.lax.with_sharding_constraint(
            b_st, NamedSharding(self.mesh, P(self.axis)))

    def gather(self, x_flat):
        """Flat owner -> global (n,)."""
        return x_flat[self._gath]

    def prepare(self, vals):
        return self.prep_sm(vals, self.mv_plan)

    def matvec(self, pvals, x_flat):
        return self.mv_sm(pvals, self.mv_plan, x_flat)

    def precond(self, factors_st, dplans, x_flat):
        return self.app.prec_sm_flat(factors_st, dplans, x_flat)

    def stack_factors(self, factors):
        """Generic pruned factors -> sharded halo layout (pure)."""
        st = self.app.stack_factors(factors)
        axis = self.axis

        def constrain(x):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(self.mesh, P(axis)))

        st["levels"] = jax.tree.map(constrain, st["levels"])
        return st

    def compute(self, vals):
        """Fully distributed factorization (pure; requires dcompute)."""
        return self.dcompute.compute(vals)

    # --- augmented (bordered) layout -------------------------------------
    # The bordered system [K V; W' C] iterates on flat vectors of shape
    # (ndev*(L+m),): each shard holds [x_l (L slots), s/sqrt(ndev) (m
    # slots)].  Replicating the tail scaled by 1/sqrt(ndev) makes the
    # global norm/dot of the flat vector equal the augmented one
    # (||z||^2 = ||x||^2 + ndev*(||s||^2/ndev)), so the unmodified
    # GMRES kernel runs the bordered iteration distributed (reference
    # BorderedVector MultiVecTraits, src/HYMLS_BorderedVector.hpp:23-80,
    # whose norms also fold the replicated border tail in once).
    def make_aug(self, m: int):
        """Build the split/join/scatter helpers for an m-column border;
        returns a small namespace object (pure fns, composable in jit)."""
        L = self.L
        ndev = self.mesh.size
        axis = self.axis
        mesh = self.mesh
        sq = float(np.sqrt(ndev))
        scatter = self.scatter
        gather = self.gather

        def split_local(z_l):
            return z_l[:L], z_l[L:]

        split_sm = jax.shard_map(
            split_local, mesh=mesh, in_specs=P(axis),
            out_specs=(P(axis), P(axis)), check_vma=False)

        def join_local(x_l, s):
            return jnp.concatenate([x_l, s / sq])

        join_sm = jax.shard_map(
            join_local, mesh=mesh, in_specs=(P(axis), P()),
            out_specs=P(axis), check_vma=False)

        class _Aug:
            @staticmethod
            def split(z):
                """z -> (x_flat (ndev*L,), s (m,) replicated)."""
                x_fl, t_fl = split_sm(z)
                s = jnp.sum(t_fl.reshape(ndev, m), axis=0) / sq
                return x_fl, s

            @staticmethod
            def join(x_fl, s):
                return join_sm(x_fl, s)

            @staticmethod
            def scatter_aug(b, t):
                return join_sm(scatter(b), t)

            @staticmethod
            def gather_aug(z):
                x_fl, s = _Aug.split(z)
                return gather(x_fl), s

            @staticmethod
            def scatter_cols(V):
                """(n, m) columns -> (ndev*L, m) owner layout."""
                return jax.vmap(scatter, in_axes=1, out_axes=1)(V)

        return _Aug


def make_distributed_solve(K, precond, mesh) -> DistributedSolve:
    """Build the distributed operator/preconditioner pair; raises
    UnshardableError when the group structure cannot be owner-sharded
    over this mesh (callers fall back to the replicated apply)."""
    return DistributedSolve(K, precond, mesh)
