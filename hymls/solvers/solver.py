"""Solver facade: Krylov method + preconditioner + variants.

Mirrors the reference's HYMLS::Solver / BaseSolver dispatch
(reference src/HYMLS_Solver.cpp:34-48, HYMLS_BaseSolver.cpp): the
'Solver' sublist selects the Krylov method, preconditioning side and
start vector; bordered/deflated/complex variants are layered on top.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.spmv import EllOperator, make_operator
from . import krylov
from . import deflation as _defl


class Solver:
    """Iterative solve of K x = b with the multilevel preconditioner."""

    def __init__(self, K: sp.csr_matrix, precond: Preconditioner,
                 params: Params, dtype=jnp.float64):
        self.params = params
        self.precond = precond
        self.dtype = dtype
        self.op = make_operator(K, dtype=dtype)

        slist = params.sublist("Solver")
        self.method = slist.get("Krylov Method", "GMRES")
        self.start_vec = slist.get("Initial Vector", "Zero")
        self.lor = slist.get("Left or Right Preconditioning", "Left")
        it = slist.sublist("Iterative Solver")
        self.maxiter = it.get("Maximum Iterations", 100)
        self.tol = it.get("Convergence Tolerance", 1e-6)
        # Belos 'Num Blocks': GMRES basis size (restart length)
        self.restart = it.get("Num Blocks", None)
        # 'Distributed Apply': run the whole Krylov iteration in the
        # owner-sharded halo layout over the active mesh (ppermute-only
        # level traffic — the production multichip path, reference
        # src/HYMLS_Preconditioner.cpp:973-1052).  Falls back to the
        # replicated apply when the structure is unshardable.
        self.distributed = slist.get("Distributed Apply", False)
        self._dist = None
        self._num_iter = 0
        self._solve_jit = None
        self._solve_proj_jit = None
        self._border = None
        self._deflation = None
        self._opT = None
        self._K = K
        self._mass = None
        self._prev_x = None
        self._rng = np.random.default_rng(42)

    def set_matrix(self, K: sp.csr_matrix):
        """New values, same pattern (Newton-step reuse)."""
        K = K.tocsr()
        K.sum_duplicates()
        K.sort_indices()
        self.op.set_values(K.data)
        self._K = K
        if self._opT is not None:
            # keep the transpose operator (deflation) in sync
            self._opT.set_values(K.T.tocsr().data)

    def set_mass_matrix(self, M: Optional[sp.spmatrix]):
        """Mass matrix for deflation/eigen use (reference
        BaseSolver::SetMassMatrix): deflation then targets dominant
        eigenmodes of P^{-1}M instead of P^{-1}."""
        self._mass = None if M is None else sp.csr_matrix(M)
        return self

    def set_border(self, V, W=None, C=None):
        """Solve the bordered system [K V; W' C][x;s]=[b;0] (reference
        BorderedSolver; used e.g. to pin a nullspace such as the
        constant pressure mode)."""
        self.precond.set_border(V, W, C)
        # the halo apply captures the bordered factors at build time:
        # force a rebuild so the distributed path picks up the border
        self._dist = None
        if V is None:
            self._border = None
        else:
            V = np.asarray(V)
            if V.ndim == 1:
                V = V[:, None]
            W = V if W is None else np.asarray(W)
            if W.ndim == 1:
                W = W[:, None]
            m = V.shape[1]
            C = np.zeros((m, m)) if C is None else np.asarray(C)
            new_border = (jnp.asarray(V, self.dtype),
                          jnp.asarray(W, self.dtype),
                          jnp.asarray(C, self.dtype))
            same_shape = (self._border is not None and
                          all(a.shape == b.shape for a, b in
                              zip(new_border, self._border)))
            self._border = new_border
            if same_shape:
                return self
        self._solve_jit = None
        return self

    def _build_solve(self):
        matvec = self.op.matvec_with
        method = self.method
        tol = self.tol
        maxiter = self.maxiter
        left = self.lor == "Left"
        restart = self.restart

        if self._border is not None:
            if self.precond._factors is None:
                self.precond.compute()
            bord_fn = self.precond._apply_bordered_pure
            n = self.op.n
            m = self._border[0].shape[1]

            if self.distributed:
                dist = self._make_dist()
                if dist is not None and \
                        getattr(dist.app, "prec_sm_flat_b", None) is not None:
                    self._build_solve_bordered_dist(dist, n, m)
                    return

            prepare = self.op.prepare

            def solve(vals, factors, dplans, border, b, tvec, x0):
                V, W, C = border
                pvals = prepare(vals)
                bz = jnp.concatenate([b, tvec])
                x0z = jnp.concatenate([x0, jnp.zeros((m,), dtype=b.dtype)])

                def op(z):
                    x, s = z[:n], z[n:]
                    y = self.op.matvec_prepared(pvals, x) + V @ s
                    t = W.T @ x + C @ s
                    return jnp.concatenate([y, t])

                def prec(z):
                    x, s = bord_fn(factors, dplans, z[:n], z[n:])
                    return jnp.concatenate([x, s])

                return krylov.gmres(op, bz, x0z, prec, tol=tol,
                                    maxiter=maxiter, left=left,
                                    restart=restart)

            self._solve_jit = jax.jit(solve)
            return

        if self.distributed and self.precond._structured_active:
            # production fast path, multichip: the SAME structured
            # gather-free V-cycle the single-chip solve runs, GSPMD-
            # sharded over the mesh (box-grid axis -> shards, rolls ->
            # collective-permutes).  The Krylov state stays a global
            # vector; XLA propagates the level shardings outward into
            # the DIA matvec and the orthogonalization.  Falls through
            # to the generic owner-sharded halo V-cycle below when no
            # structured program exists (reference: the one apply path
            # is distributed unconditionally,
            # src/HYMLS_Preconditioner.cpp:973-1052).
            from ..parallel.mesh import get_mesh
            mesh = get_mesh()
            if mesh is not None and mesh.size >= 2:
                if self.precond._factors is None:
                    self.precond.compute()
                sapply = self.precond.sharded_sapply_fn(mesh)
                self._dist_structured = mesh
                prepare = self.op.prepare

                def solve(vals, factors, dplans, b, x0):
                    pvals = prepare(vals)

                    def op(x):
                        return self.op.matvec_prepared(pvals, x)

                    def prec(x):
                        return sapply(factors, dplans, x)

                    if method == "CG":
                        return krylov.cg(op, b, x0, prec, tol=tol,
                                         maxiter=maxiter)
                    return krylov.gmres(op, b, x0, prec, tol=tol,
                                        maxiter=maxiter, left=left,
                                        restart=restart)

                self._solve_jit = jax.jit(solve)
                return

        if self.distributed:
            dist = self._make_dist()
            if dist is not None:
                dcompute = dist.dcompute is not None

                def solve(vals, factors, dplans, b, x0):
                    pv = dist.prepare(vals)
                    if dcompute:
                        # fully distributed Newton step: ppermute SC
                        # assembly inside the same program as the solve
                        fac_st = dist.compute(vals)
                    else:
                        fac_st = dist.stack_factors(factors)
                    b_st = dist.scatter(b)
                    x0_st = dist.scatter(x0)

                    def op(x):
                        return dist.matvec(pv, x)

                    def prec(x):
                        return dist.precond(fac_st, dplans, x)

                    if method == "CG":
                        res = krylov.cg(op, b_st, x0_st, prec, tol=tol,
                                        maxiter=maxiter)
                    else:
                        res = krylov.gmres(op, b_st, x0_st, prec,
                                           tol=tol, maxiter=maxiter,
                                           left=left, restart=restart)
                    return res._replace(x=dist.gather(res.x))

                self._solve_jit = jax.jit(solve)
                return

        apply_fn, _, _ = self.precond.apply_inverse_fn()
        prepare = self.op.prepare

        def solve(vals, factors, dplans, b, x0):
            pvals = prepare(vals)

            def op(x):
                return self.op.matvec_prepared(pvals, x)

            def prec(x):
                return apply_fn(factors, dplans, x)

            if method == "CG":
                return krylov.cg(op, b, x0, prec, tol=tol, maxiter=maxiter)
            return krylov.gmres(op, b, x0, prec, tol=tol, maxiter=maxiter,
                                left=left, restart=restart)

        self._solve_jit = jax.jit(solve)

    def _build_solve_bordered_dist(self, dist, n, m):
        """Bordered GMRES in the owner-sharded halo layout: augmented
        vectors ride the flat (ndev*(L+m),) layout (dist.make_aug), the
        x-part communicates by ppermute halo exchange and the m-tail by
        one psum per operator/preconditioner apply — matching the
        reference's distributed bordered solve where the border
        coefficients are reduced with SumAll
        (src/HYMLS_BorderedSolver.cpp:173-219,
        src/HYMLS_CoarseSolver.cpp:454-564)."""
        method = self.method
        tol = self.tol
        maxiter = self.maxiter
        left = self.lor == "Left"
        restart = self.restart
        aug = dist.make_aug(m)
        bord_sm = dist.app.prec_sm_flat_b
        dpl = dist.dplans

        def solve(vals, factors, dplans, border, b, tvec, x0):
            V, W, C = border
            pvals = dist.prepare(vals)
            fac_st = dist.stack_factors(factors)
            V_st = aug.scatter_cols(V)
            W_st = aug.scatter_cols(W)
            bz = aug.scatter_aug(b, tvec)
            x0z = aug.scatter_aug(x0, jnp.zeros((m,), dtype=b.dtype))

            def op(z):
                x_fl, s = aug.split(z)
                y_fl = dist.matvec(pvals, x_fl) + V_st @ s
                tau = W_st.T @ x_fl + C @ s
                return aug.join(y_fl, tau)

            def prec(z):
                x_fl, tau = aug.split(z)
                x_out, S = bord_sm(fac_st, dpl, x_fl, tau)
                return aug.join(x_out, S)

            if method == "CG":
                res = krylov.cg(op, bz, x0z, prec, tol=tol,
                                maxiter=maxiter)
            else:
                res = krylov.gmres(op, bz, x0z, prec, tol=tol,
                                   maxiter=maxiter, left=left,
                                   restart=restart)
            x, s = aug.gather_aug(res.x)
            return res._replace(x=jnp.concatenate([x, s]))

        self._solve_jit = jax.jit(solve)

    def _make_dist(self):
        """Build (once) the owner-sharded distributed operator/apply
        pair over the active mesh; returns None (with a warning) when
        no mesh is active or the structure is unshardable."""
        import warnings
        from ..parallel.mesh import get_mesh
        from ..parallel.dist import make_distributed_solve
        from ..parallel.halo_vcycle import UnshardableError

        if self._dist is not None:
            return self._dist
        mesh = get_mesh()
        if mesh is None or mesh.size < 2:
            warnings.warn("'Distributed Apply' requested but no device "
                          "mesh is active (parallel.set_mesh); using the "
                          "replicated apply")
            self.distributed = False
            return None
        if self.precond._factors is None:
            self.precond.compute()
        try:
            self._dist = make_distributed_solve(self._K, self.precond,
                                                mesh)
        except UnshardableError as e:
            warnings.warn(f"'Distributed Apply' unavailable ({e}); "
                          "using the replicated apply")
            self.distributed = False
            return None
        return self._dist

    def setup_deflation(self):
        """Compute the deflation space and correction system (reference
        DeflatedSolver::SetupDeflation; parameters 'Deflated Subspace
        Dimension' / 'Deflation Threshold' in the 'Solver' list).  With
        a border set, deflation runs on the augmented system (the
        BorderedDeflatedSolver combination)."""
        slist = self.params.sublist("Solver")
        k = slist.get("Deflated Subspace Dimension", 0)
        if k <= 0:
            return self
        if self.precond._factors is None:
            self.precond.compute()
        self._opT = make_operator(self._K.T.tocsr(), dtype=self.dtype)

        n = self.op.n
        m = self._border[0].shape[1] if self._border is not None else 0
        n_aug = n + m

        # host-side K/K' block products (scipy, free of device round
        # trips); columns or (n, k) blocks both work
        Knp = self._K.tocsr()
        if self._border is None:
            def mv(z):
                return Knp @ np.asarray(z)

            def mvT(z):
                return Knp.T @ np.asarray(z)
        else:
            V_b, W_b, C_b = (np.asarray(a) for a in self._border)

            def mv(z):
                z = np.asarray(z)
                zx, zs = z[:n], z[n:]
                y = Knp @ zx + V_b @ zs
                t = W_b.T @ zx + C_b @ zs
                return np.concatenate([y, t])

            def mvT(z):
                z = np.asarray(z)
                zx, zs = z[:n], z[n:]
                y = Knp.T @ zx + W_b @ zs
                t = V_b.T @ zx + C_b.T @ zs
                return np.concatenate([y, t])

        # pure apply column for the ONE-program subspace iteration
        # (a host ARPACK loop would round-trip per matvec)
        apply_fn, factors, dplans = self.precond.apply_inverse_fn()
        Mop = None
        if self._mass is not None:
            Mop = make_operator(self._mass.tocsr(), dtype=self.dtype)

        if self._border is None:
            def apply_col(z):
                if Mop is not None:
                    z = Mop(z)
                return apply_fn(factors, dplans, z)
        else:
            bord_fn = self.precond._apply_bordered_pure

            def apply_col(z):
                zx, zs = z[:n], z[n:]
                if Mop is not None:
                    zx = Mop(zx)
                x, sb = bord_fn(factors, dplans, zx, zs)
                return jnp.concatenate([x, sb])

        self._defl_info = {}
        V = _defl.compute_deflation_space_device(apply_col, n_aug, k,
                                                 self.dtype,
                                                 _info=self._defl_info)
        Vj = jnp.asarray(V, self.dtype)
        self._build_proj_solve(aug=self._border is not None)

        def proj_solve(r):
            args = [self.op.vals, factors, dplans, Vj,
                    jnp.asarray(r, self.dtype)]
            if self._border is not None:
                args.insert(3, self._border)
            res = self._solve_proj_jit(*args)
            self._last_res = res
            return res.x

        def multi_solve(Rhs):
            """All k projected columns in one batched program."""
            args = [self.op.vals, factors, dplans, Vj,
                    jnp.asarray(Rhs.T, self.dtype)]
            if self._border is not None:
                args.insert(3, self._border)
            res = self._solve_proj_multi_jit(*args)
            self._last_res = jax.tree.map(lambda a: a[-1], res)
            return np.asarray(res.x).T

        self._deflation = _defl.setup_deflation(V, mv, mvT, proj_solve,
                                                multi_solve=multi_solve)
        self._proj_solve = proj_solve
        self._defl_aug = self._border is not None
        return self

    def _build_proj_solve(self, aug: bool = False):
        apply_fn, _, _ = self.precond.apply_inverse_fn()
        tol, maxiter = self.tol, self.maxiter
        left = self.lor == "Left"
        prepare = self.op.prepare
        n = self.op.n

        if not aug:
            def solve(vals, factors, dplans, V, b):
                pvals = prepare(vals)

                def proj(x):
                    return x - V @ (V.T @ x)

                def op(x):
                    return proj(self.op.matvec_prepared(pvals, proj(x)))

                def prec(x):
                    return proj(apply_fn(factors, dplans, proj(x)))

                return krylov.gmres(op, b, jnp.zeros_like(b), prec,
                                    tol=tol, maxiter=maxiter, left=left)

            dist = self._make_dist() if self.distributed else None
            if dist is not None:
                # deflated iteration distributed: the deflation basis is
                # scattered into the owner layout once, the projectors
                # are sharded dots (GSPMD psum), and the operator/
                # preconditioner ride the halo plans (reference: the
                # DeflatedSolver's ProjectedOperator applies over
                # distributed multivectors, src/HYMLS_DeflatedSolver.cpp:159-245)
                dpl = dist.dplans

                def solve_dist(vals, factors, dplans, V, b):
                    pvals = dist.prepare(vals)
                    fac_st = dist.stack_factors(factors)
                    V_st = jax.vmap(dist.scatter, in_axes=1,
                                    out_axes=1)(V)
                    b_st = dist.scatter(b)

                    def proj(x):
                        return x - V_st @ (V_st.T @ x)

                    def op(x):
                        return proj(dist.matvec(pvals, proj(x)))

                    def prec(x):
                        return proj(dist.precond(fac_st, dpl, x))

                    res = krylov.gmres(op, b_st, jnp.zeros_like(b_st),
                                       prec, tol=tol, maxiter=maxiter,
                                       left=left)
                    return res._replace(x=dist.gather(res.x))

                self._solve_proj_jit = jax.jit(solve_dist)
            else:
                self._solve_proj_jit = jax.jit(solve)
            # all k deflation-setup columns in one program (vmap masks
            # the while_loop until every column converges); setup stays
            # replicated — it runs once, the projected solves per rhs
            # are the hot path
            self._solve_proj_multi_jit = jax.jit(jax.vmap(
                solve, in_axes=(None, None, None, None, 0)))
            return

        bord_fn = self.precond._apply_bordered_pure

        def solve(vals, factors, dplans, border, V, b):
            Vb, Wb, Cb = border
            pvals = prepare(vals)

            def proj(z):
                return z - V @ (V.T @ z)

            def op(z):
                z = proj(z)
                x, sb = z[:n], z[n:]
                y = self.op.matvec_prepared(pvals, x) + Vb @ sb
                t = Wb.T @ x + Cb @ sb
                return proj(jnp.concatenate([y, t]))

            def prec(z):
                z = proj(z)
                x, sb = bord_fn(factors, dplans, z[:n], z[n:])
                return proj(jnp.concatenate([x, sb]))

            return krylov.gmres(op, b, jnp.zeros_like(b), prec,
                                tol=tol, maxiter=maxiter, left=left)

        self._solve_proj_jit = jax.jit(solve)
        self._solve_proj_multi_jit = jax.jit(jax.vmap(
            solve, in_axes=(None, None, None, None, None, 0)))

    def apply_inverse(self, b, x0: Optional[np.ndarray] = None, t=None):
        """Solve K x = b (or the bordered system with border rhs `t`);
        returns (x, KrylovResult).  After a bordered solve the border
        coefficients are available as `self._border_coeffs`."""
        from ..utils.timings import prof
        with prof("Solver.apply_inverse", level=1):
            return self._apply_inverse(b, x0, t)

    def _apply_inverse(self, b, x0: Optional[np.ndarray] = None, t=None):
        if self._deflation is not None:
            bz = np.asarray(b)
            if getattr(self, "_defl_aug", False):
                m = self._border[0].shape[1]
                bz = np.concatenate([bz, np.zeros(m)])
            x = _defl.deflated_apply(self._deflation, bz,
                                     self._proj_solve)
            x = x[:self.op.n]
            return jnp.asarray(x, self.dtype), self._last_res
        if self._solve_jit is None:
            self._build_solve()
        b = jnp.asarray(b, dtype=self.dtype)
        if x0 is None:
            if self.start_vec == "Random":
                x0 = jnp.asarray(
                    self._rng.standard_normal(b.shape[0]), dtype=self.dtype)
            elif (self.start_vec == "Previous" and self._prev_x is not None
                  and self._prev_x.shape == b.shape):
                # reference BaseSolver start-vector option 'Previous':
                # warm-start from the last solution (continuation runs)
                x0 = self._prev_x.astype(self.dtype)
            else:
                x0 = jnp.zeros_like(b)
        if self._border is not None:
            factors = self.precond.apply_factors
            if t is None:
                t = jnp.zeros((self._border[0].shape[1],), dtype=self.dtype)
            res = self._solve_jit(self.op.vals, factors,
                                  self.precond._aplans, self._border, b,
                                  jnp.asarray(t, self.dtype), x0)
        elif self.distributed and self._dist is not None:
            # generic (unrepacked) factors: the distributed program
            # stacks them into the sharded halo layout itself
            factors = self.precond._prune_factors(self.precond.factors)
            res = self._solve_jit(self.op.vals, factors,
                                  self._dist.dplans, b, x0)
        else:
            factors = self.precond.apply_factors
            res = self._solve_jit(self.op.vals, factors,
                                  self.precond._aplans, b, x0)
        self._last_result = res   # iteration count read lazily: a device
        # scalar readback costs a host round trip
        x = res.x[:self.op.n] if self._border is not None else res.x
        self._border_coeffs = np.asarray(res.x[self.op.n:]) \
            if self._border is not None else None
        self._prev_x = x
        return x, res

    @property
    def num_iter(self) -> int:
        if getattr(self, "_last_result", None) is not None:
            return int(self._last_result.iters)
        return self._num_iter
