"""Dense inverses: batched small blocks and the single coarse system.

Subdomain interiors and separator blocks are inverted explicitly
(batched), so every V-cycle applies them as one batched matmul.  The
coarsest-level system (reference CoarseSolver, Amesos KLU —
src/HYMLS_CoarseSolver.cpp:131-248) is the one place a *single* large
dense factorization appears: up to `_LU_THRESHOLD` it is inverted
explicitly as well; above it the LU factors are kept.  An explicit
inverse + Newton polish of an n~10^4 coarse system costs ~9x more flops
than the factorization (CPU: 500 s vs tens of s for the stokes1 128^2
L=2 coarse system, n=12320), and on the cavity.xml coarse system
(f64, n=7876) it is not accurate enough: on an H100 80GB HBM3 (700 W)
the inverse took 0.53 s against 0.045 s for LU and left GMRES at 250
iterations (relres 0.78), where LU converges in 58.  The latency of one
LU triangular solve per V-cycle (1.9 ms against 0.17 ms for the
inverse's GEMV) does not change that.

Inverses run in the working dtype through XLA's LU (LAPACK on the CPU,
cuSOLVER/cuBLAS on the GPU).  f64 inverses get a residual-adaptive
Newton polish for ill-conditioned blocks.  On the H100 this native route
beat the one-hot Gauss-Jordan / f32-seed + Newton / chunked routes at
every block shape the 2-D and 3-D Newton steps produce (up to 10x at
f32[1296,82,82] and f32[140,171,171]) and made the 128^2 cavity Newton
step 15% faster (PERF.md).

`dense_factor` returns a pytree (dict) and `dense_solve` dispatches on
its static structure, so the choice is baked in at trace time.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# below this size the explicit inverse is cheap on any backend; keeping
# it avoids pytree-structure churn in the common (small-coarse) case
_LU_THRESHOLD = 2048

# TRUE-dtype products: every residual/refinement product here must be
# exact-f32 class, never TF32 (see hymls/__init__).
_HI = jax.lax.Precision.HIGHEST


def _newton_refine(A, X, max_steps: int, tol: float = 1e-13):
    """Residual-adaptive Newton iteration X <- X(2I - AX) = X + X(I-AX).

    Runs until max(|I - AX|) <= tol or max_steps, whichever first; the
    contraction is quadratic (rho_{k+1} = rho_k^2), so a f32-accurate
    seed (rho ~ cond*6e-8) reaches f64 residual level in 1 step for
    cond <~ 1e4 and in 2-3 steps for cond up to ~1e7; beyond that
    (rho0 >= 1) Newton cannot recover a f32 seed and the loop exits on
    the step cap without diverging further (the body is skipped once
    the residual stops improving)."""
    if A.size == 0:            # empty batch/level: nothing to refine
        return X
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)

    def resid(X):
        return jnp.max(jnp.abs(eye - jnp.matmul(A, X, precision=_HI)))

    def cond_fn(state):
        X, r, it = state
        return (r > tol) & (it < max_steps)

    def body_fn(state):
        X, r, it = state
        R = eye - jnp.matmul(A, X, precision=_HI)
        Xn = X + jnp.matmul(X, R, precision=_HI)
        rn = resid(Xn)
        # guard against divergence (rho0 >= 1): keep the better iterate
        keep = rn <= r
        Xn = jnp.where(keep, Xn, X)
        rn = jnp.where(keep, rn, r)
        return Xn, rn, it + 1

    X, r, _ = jax.lax.while_loop(
        cond_fn, body_fn, (X, resid(X), jnp.asarray(0, jnp.int32)))
    return X


def inv_newton(A, refine: int = 6):
    """(Batched) dense inverse in A's dtype.  f64 inverses of
    ill-conditioned blocks (e.g. periodic Schur complements) lose
    ~cond*eps; a residual-adaptive Newton polish of up to `refine`
    steps (early exit at residual 1e-13, so well-conditioned blocks pay
    one residual check) recovers residual-level accuracy."""
    X = jnp.linalg.inv(A)
    if A.dtype == jnp.float64 and refine:
        X = _newton_refine(A, X, max_steps=refine)
    return X


def warm_inv(A, X0, fresh_fn=None, accept=0.25, max_steps=4, tol=None):
    """Warm-started (batched) dense inverse for value-only recomputes
    (Newton / continuation sequences, the reference's SetMatrix-then-
    Compute pattern, src/HYMLS_Preconditioner.cpp:400-517 re-run).

    When the previous step's inverse X0 still contracts
    (max|I - A X0| < accept), polish it with residual-adaptive
    Newton-Schulz — 2 batched matmuls per step — instead of re-running
    the LU + triangular-inverse; quadratic convergence reaches the
    dtype residual floor in 1-3 steps for the modest per-step matrix
    changes of a Newton loop.  Otherwise fall back to `fresh_fn(A)`
    (both lax.cond branches compile, one executes).  Costs one extra
    matmul (the seed residual) relative to a cold factorization."""
    if fresh_fn is None:
        fresh_fn = inv_newton
    if A.size == 0:
        return fresh_fn(A)
    X0 = X0.astype(A.dtype)
    if tol is None:
        tol = 1e-13 if A.dtype == jnp.float64 else 1e-6
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    r0 = jnp.max(jnp.abs(eye - jnp.matmul(A, X0, precision=_HI)))
    return jax.lax.cond(
        r0 < accept,
        lambda: _newton_refine(A, X0, max_steps=max_steps, tol=tol),
        lambda: fresh_fn(A))


def dense_factor(A) -> dict:
    """Factor one (unbatched) dense system for repeated solves."""
    n = A.shape[-1]
    if n <= _LU_THRESHOLD or A.ndim != 2:
        return {"inv": inv_newton(A)}
    lu, piv = jax.scipy.linalg.lu_factor(A)
    return {"lu": lu, "piv": piv}


def dense_solve(fac: dict, rhs):
    """Solve against a `dense_factor` result; rhs (n,) or (n, k)."""
    if "inv" in fac:
        return jnp.matmul(fac["inv"], rhs, precision=_HI)
    return jax.scipy.linalg.lu_solve((fac["lu"], fac["piv"]), rhs)
