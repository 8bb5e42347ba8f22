"""Mixed-precision solves: f32 Krylov + preconditioner inside an f64
iterative-refinement loop.

f32 moves half the bytes of f64, and the solve is memory-bound, so the
production path is classical iterative refinement — all heavy work
(factorization, V-cycles, Krylov iterations, SpMV) runs in f32, while
residuals and the solution accumulate in f64.  Each pass contracts the residual
by roughly the inner tolerance, and a LOOSE inner tolerance wins:
asking f32 GMRES for 1e-6 makes it stagnate against the f32 noise
floor and burn its full iteration budget per pass, while ~1e-4
passes converge in a few dozen iterations each and the refinement
loop squares away the rest (measured on the Re1000 cavity Jacobian:
inner 1e-4 reaches 3e-15 in 0.08 s vs 1e-13 in 0.11 s at 5e-7).  (SURVEY.md notes this as the
sanctioned mitigation: "mixed f32 factorization + f64 iterative
refinement where targets allow".)
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.spmv import make_operator
from .solver import Solver
from .krylov import KrylovResult


class IterativeRefinementSolver:
    """Drop-in alternative to Solver with the same apply_inverse API."""

    def __init__(self, K: sp.csr_matrix, params: Params,
                 testvector: Optional[np.ndarray] = None,
                 inner_tol: float = 1e-4, max_passes: int = 16,
                 inner_maxiter: Optional[int] = None):
        self.params = params
        it = params.sublist("Solver").sublist("Iterative Solver")
        self.tol = it.get("Convergence Tolerance", 1e-6)
        self.inner_tol = max(inner_tol, self.tol)
        self.max_passes = max_passes
        if inner_maxiter is None:
            # The historical sensitivity to the basis size (768 inner
            # iters at m=48 vs 427 at m=96 on stokes128 L=2) was a
            # bf16-quality coarse inverse stagnating the inner solves
            # against their own restart; with precision-exact factors
            # m=48 and m=96 are within noise (108 vs 107 inner
            # iters).  Keep 96 for multilevel (headroom
            # for harder spectra; the masked orthogonalization pays
            # O(m n) per iteration, so much larger wastes bandwidth)
            # and the cheaper 64-slot basis for single-reduction
            # problems that converge in a few dozen iterations.
            n_levels = params.sublist("Preconditioner").get(
                "Number of Levels", 1)
            inner_maxiter = 96 if n_levels >= 2 else 64
        # Cap the inner Krylov basis independently of the user's
        # 'Maximum Iterations': the fused GMRES uses static-shape
        # masked orthogonalization, so every iteration pays O(basis
        # size) bandwidth whether slots are used or not.  A loose
        # inner tolerance converges in a few dozen iterations; an
        # unconverged pass simply continues in the next refinement
        # pass (restart semantics).  'Inner Maximum Iterations'
        # overrides the default cap for problems where the short
        # restarted basis stagnates.
        self.inner_maxiter = min(
            it.get("Inner Maximum Iterations", inner_maxiter),
            it.get("Maximum Iterations", 100))

        inner_params = params.copy()
        inner_params.sublist("Solver").sublist("Iterative Solver")[
            "Convergence Tolerance"] = self.inner_tol
        inner_params.sublist("Solver").sublist("Iterative Solver")[
            "Maximum Iterations"] = self.inner_maxiter
        # Factor assembly defaults to 'Same' (all-f32 factor chain).
        # The historical multilevel f32 blowups (skew 32^3 L=2
        # diverging, stokes 128^2 L=2 at 5x inner iterations) were NOT
        # f32 cancellation: they were f32 matmuls lowered to
        # single-pass bf16 (2^-8 rounding).  With every factor/apply
        # product pinned to precision=HIGHEST (true f32), iteration
        # parity with the f64-assembled chain holds everywhere
        # measured: cavity128 skew L=2 69 vs 68 inner iters; CPU
        # stokes128 L=2 148 vs 149; CPU skew 32^3 L=2 245 vs 243
        # (tools/f32_quality_cpu.py).  Opt back into the f64 assembly
        # with 'Factor Precision' = 'f64' for matrices that do cancel
        # beyond f32 range.
        fprec = params.sublist("Preconditioner").get(
            "Factor Precision", "Same")
        # the distributed factorization (parallel/dist_compute.py)
        # implements the full-f64 chain; pin the replicated build to
        # the same assembly so dist-vs-replicated iteration identity
        # holds (tests/test_dist_solve.py)
        if params.sublist("Solver").get("Distributed Apply", False) and \
                "Schur Assembly" not in params.sublist("Preconditioner"):
            inner_params.sublist("Preconditioner")[
                "Schur Assembly"] = "Full f64"
        self.precond = Preconditioner(
            K, inner_params, testvector=testvector, dtype=jnp.float32,
            factor_dtype=jnp.float64 if fprec == "f64" else jnp.float32)
        self.solver = Solver(K, self.precond, inner_params,
                             dtype=jnp.float32)
        self.op64 = make_operator(K, dtype=jnp.float64)
        self._num_iter = 0
        self._fused_jit = None

    def compute(self, K: Optional[sp.csr_matrix] = None):
        self.precond.compute(K)
        if K is not None:
            self.solver.set_matrix(K)
            self.op64.set_values(K.tocsr().data)
        return self

    def set_border(self, V, W=None, C=None):
        self.solver.set_border(V, W, C)
        return self

    def _build_fused(self):
        """One jitted program for the whole refinement loop: f64
        residual -> f32 Krylov correction -> f64 update, repeated under
        lax.while_loop.  No host round trips inside the loop."""
        from . import krylov
        import jax.lax as lax

        if self.precond._factors is None:
            self.precond.compute()
        # production fast path, multichip: GSPMD-shard the structured
        # apply inside the SAME fused program (global vectors, rolls ->
        # collective-permutes) instead of switching to the generic
        # owner-layout halo V-cycle — the reference's one apply path is
        # distributed unconditionally
        # (src/HYMLS_Preconditioner.cpp:973-1052)
        sh_mesh = None
        if self.solver.distributed and self.precond._structured_active:
            from ..parallel.mesh import get_mesh
            sh_mesh = get_mesh()
            if sh_mesh is not None and sh_mesh.size < 2:
                sh_mesh = None
        if sh_mesh is None and self.solver.distributed:
            dist = self.solver._make_dist()
            if dist is not None:
                self._build_fused_dist(dist)
                return
        self._dist = None
        self._dist_structured = sh_mesh
        if sh_mesh is not None:
            apply_fn = self.precond.sharded_sapply_fn(sh_mesh)
        else:
            apply_fn, _, _ = self.precond.apply_inverse_fn()
        slist = self.params.sublist("Solver")
        method = slist.get("Krylov Method", "GMRES")
        it = slist.sublist("Iterative Solver")
        maxiter = self.inner_maxiter
        inner_tol = self.inner_tol
        tol = self.tol
        max_passes = self.max_passes
        prep64 = self.op64.prepare
        mv64 = self.op64.matvec_prepared
        prep32 = self.solver.op.prepare
        mv32 = self.solver.op.matvec_prepared

        def fused(vals64, vals32, factors, dplans, b):
            pv64 = prep64(vals64)
            pv32 = prep32(vals32)
            nb = jnp.linalg.norm(b)
            nb = jnp.where(nb > 0, nb, 1.0)

            def inner(r32, tol_k):
                def op(x):
                    return mv32(pv32, x)

                def prec(x):
                    return apply_fn(factors, dplans, x)

                if method == "CG":
                    return krylov.cg(op, r32, jnp.zeros_like(r32), prec,
                                     tol=tol_k, maxiter=maxiter)
                return krylov.gmres(op, r32, jnp.zeros_like(r32), prec,
                                    tol=tol_k, maxiter=maxiter)

            def cond(state):
                x, r, rel, iters, np_ = state
                return (rel > tol) & (np_ < max_passes)

            def body(state):
                x, r, rel, iters, np_ = state
                # adaptive inner target: the LAST pass only needs the
                # reduction that carries rel to the outer tolerance —
                # running every pass to the static inner_tol over-solves
                # (measured: cavity64 landed at 3.6e-15 against a 1e-12
                # target, ~an extra half-pass of f32 iterations).  The
                # 0.3 safety covers implicit-vs-true residual slack; an
                # undershooting pass just continues in the next one.
                tol_k = jnp.clip(0.3 * tol / rel, inner_tol, 0.3
                                 ).astype(jnp.float32)
                res = inner(r.astype(jnp.float32), tol_k)
                x = x + res.x.astype(jnp.float64)
                r = b - mv64(pv64, x)
                rel = jnp.linalg.norm(r) / nb
                return (x, r, rel, iters + res.iters, np_ + 1)

            x0 = jnp.zeros_like(b)
            r0 = b
            rel0 = jnp.linalg.norm(r0) / nb
            x, r, rel, iters, np_ = lax.while_loop(
                cond, body, (x0, r0, rel0, jnp.asarray(0), 0))
            return KrylovResult(x=x, iters=iters, relres=rel,
                                converged=rel <= tol)

        self._fused_fn = fused          # pure; composable under jit
        self._fused_jit = jax.jit(fused)

    def _build_fused_dist(self, dist):
        """Distributed fused refinement loop: the ENTIRE production
        mixed-precision Newton iteration runs in the owner-sharded halo
        layout (parallel/dist.py) — f32 inner GMRES with ppermute-only
        level traffic, f64 residual via the same static-plan halo
        matvec, factors straight from the distributed factorization.
        The reference runs every solver variant distributed (setup
        src/HYMLS_MatrixBlock.cpp:74-134; iteration
        src/HYMLS_Preconditioner.cpp:973-1052); this is the device
        equivalent for the mixed-precision path.

        Vector norms/dots in the flat owner layout equal the global
        ones (zero padding), so the IR convergence logic is unchanged;
        the only gather in the program is the final solution readout."""
        from . import krylov
        import jax.lax as lax

        self._dist = dist
        slist = self.params.sublist("Solver")
        method = slist.get("Krylov Method", "GMRES")
        maxiter = self.inner_maxiter
        inner_tol = self.inner_tol
        tol = self.tol
        max_passes = self.max_passes
        dplans = dist.dplans

        def fused_core(vals64, vals32, fac_st, b):
            pv64 = dist.prepare(vals64)
            pv32 = dist.prepare(vals32)
            b_st = dist.scatter(b)
            nb = jnp.linalg.norm(b_st)
            nb = jnp.where(nb > 0, nb, 1.0)

            def inner(r32, tol_k):
                def op(x):
                    return dist.matvec(pv32, x)

                def prec(x):
                    return dist.precond(fac_st, dplans, x)

                if method == "CG":
                    return krylov.cg(op, r32, jnp.zeros_like(r32), prec,
                                     tol=tol_k, maxiter=maxiter)
                return krylov.gmres(op, r32, jnp.zeros_like(r32), prec,
                                    tol=tol_k, maxiter=maxiter)

            def cond(state):
                x, r, rel, iters, np_ = state
                return (rel > tol) & (np_ < max_passes)

            def body(state):
                x, r, rel, iters, np_ = state
                # adaptive inner target (see the replicated fused loop)
                tol_k = jnp.clip(0.3 * tol / rel, inner_tol, 0.3
                                 ).astype(jnp.float32)
                res = inner(r.astype(jnp.float32), tol_k)
                x = x + res.x.astype(jnp.float64)
                r = b_st - dist.matvec(pv64, x)
                rel = jnp.linalg.norm(r) / nb
                return (x, r, rel, iters + res.iters, np_ + 1)

            x0 = jnp.zeros_like(b_st)
            rel0 = jnp.linalg.norm(b_st) / nb
            x, r, rel, iters, np_ = lax.while_loop(
                cond, body, (x0, b_st, rel0, jnp.asarray(0), 0))
            return KrylovResult(x=dist.gather(x), iters=iters,
                                relres=rel, converged=rel <= tol)

        def fused(vals64, vals32, factors, _aplans, b):
            # same signature as the replicated fused fn; `factors` are
            # the generic pruned factors, stacked into the halo layout
            # inside the program
            return fused_core(vals64, vals32, dist.stack_factors(factors),
                              b)

        self._fused_core = fused_core
        self._fused_fn = fused
        self._fused_jit = jax.jit(fused)

    def newton_step_fn(self):
        """One jitted program for a full Newton step: f32
        re-factorization + structured repack + fused IR solve, one
        dispatch per step.  Returns (fn, dplans, extra, aplans):
        fn(vals64, vals32, dplans, extra, aplans, b) -> KrylovResult."""
        if self._fused_jit is None:
            self._build_fused()
        P = self.precond
        compute = P._compute_pure
        fused = self._fused_fn
        dist = getattr(self, "_dist", None)
        if dist is not None and dist.dcompute is not None:
            # fully distributed Newton step: ppermute SC assembly
            # (f64-assembly/f32-store chain inside dist_compute) feeds
            # halo-layout factors straight into the sharded IR loop —
            # no replicated factor tensor ever exists
            fused_core = self._fused_core

            def newton(vals64, vals32, dplans, extra, aplans, b):
                fac_st = dist.compute(vals64)
                return fused_core(vals64, vals32, fac_st, b)

            return (jax.jit(newton), P._dplans, P._extra_plan, P._aplans)

        def newton(vals64, vals32, dplans, extra, aplans, b):
            # factor from the FULL-precision values: compute is
            # dtype-normalizing (assembles in factor_dtype, returns
            # apply-dtype factors), so this costs nothing when factor
            # precision is 'Same' and avoids double rounding when f64
            factors = compute(vals64, dplans, extra)
            afac = P.apply_factors_from_pure(factors, aplans)
            return fused(vals64, vals32, afac, aplans, b)

        return (jax.jit(newton), P._dplans, P._extra_plan, P._aplans)

    def newton_step_warm_fn(self):
        """Warm-recompute Newton step: like newton_step_fn but
        threading the factor pytree through the Newton sequence —
        fn(vals64, vals32, dplans, extra, aplans, b, prev_factors) ->
        (KrylovResult, factors).  The dense inverses are Newton-Schulz
        polished from prev_factors with a per-inverse residual-gated
        fallback (Preconditioner.recompute semantics); seed
        prev_factors with a cold compute() output.  This is the
        continuation-loop fast path: the cold factor's LU/triangular
        inverses are replaced by a few batched matmuls when
        successive Jacobians differ modestly."""
        if self._fused_jit is None:
            self._build_fused()
        P = self.precond
        recompute = P._recompute_pure
        fused = self._fused_fn

        if getattr(self, "_dist", None) is not None:
            # distributed solve around a replicated warm recompute: the
            # polished factors are pruned and stacked inside fused
            def newton(vals64, vals32, dplans, extra, aplans, b, prev):
                factors = recompute(vals64, dplans, extra, prev)
                res = fused(vals64, vals32, P._prune_factors(factors),
                            aplans, b)
                return res, factors

            return (jax.jit(newton), P._dplans, P._extra_plan, P._aplans)

        def newton(vals64, vals32, dplans, extra, aplans, b, prev):
            factors = recompute(vals64, dplans, extra, prev)
            afac = P.apply_factors_from_pure(factors, aplans)
            res = fused(vals64, vals32, afac, aplans, b)
            return res, factors

        return (jax.jit(newton), P._dplans, P._extra_plan, P._aplans)

    def solve(self, b):
        """Fused on-device refinement solve; returns x (see
        apply_inverse for the host-loop variant with per-pass
        diagnostics)."""
        if self._fused_jit is None:
            self._build_fused()
        if getattr(self, "_dist", None) is not None:
            # distributed: generic pruned factors, stacked in-program
            factors = self.precond._prune_factors(self.precond.factors)
            aplans = self._dist.dplans
        else:
            factors = self.precond.apply_factors
            aplans = self.precond._aplans
        res = self._fused_jit(self.op64.vals, self.solver.op.vals,
                              factors, aplans,
                              jnp.asarray(b, jnp.float64))
        self._last_result = res
        return res.x

    def apply_inverse(self, b):
        b64 = jnp.asarray(b, jnp.float64)
        nb = float(jnp.linalg.norm(b64))
        x = jnp.zeros_like(b64)
        total_iters = 0
        relres = 1.0
        converged = False
        for _pass in range(self.max_passes):
            r = b64 - self.op64(x)
            relres = float(jnp.linalg.norm(r)) / nb
            if relres <= self.tol:
                converged = True
                break
            d, res = self.solver.apply_inverse(np.asarray(r, np.float32))
            total_iters += int(res.iters)
            x = x + jnp.asarray(d, jnp.float64)
        self._num_iter = total_iters
        return x, KrylovResult(x=x, iters=jnp.asarray(total_iters),
                               relres=jnp.asarray(relres),
                               converged=jnp.asarray(converged))

    @property
    def num_iter(self):
        return self._num_iter
