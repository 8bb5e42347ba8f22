"""Krylov solvers in pure JAX: preconditioned GMRES and CG.

Device replacement of the Belos layer used by the reference
(reference src/HYMLS_BaseSolver.cpp:74-94,309-359).  The solvers are
built as `lax.while_loop`s over static-shape state so a whole solve is
one XLA computation:

  * GMRES: no-restart Arnoldi with classical Gram-Schmidt with
    reorthogonalization (CGS2) — two batched (m,N)-matvec dots per
    iteration instead of sequential MGS axpys, which is the right
    shape for a matmul unit — plus Givens rotations for the implicit
    residual.
  * CG: standard preconditioned conjugate gradients.

Convergence matches Belos defaults (reference HYMLS_BaseSolver.cpp
passes the 'Iterative Solver' list to Belos untouched): the implicit
residual norm is scaled by the norm of the (preconditioned, if left)
INITIAL residual — Belos 'Implicit Residual Scaling' = 'Norm of
Preconditioned Initial Residual'.  scale_with_rhs=True selects 'Norm
of RHS' instead.  With a zero initial vector the two coincide; with a
random start the initial-residual scaling is what keeps iteration
counts aligned with the reference targets.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class KrylovResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray       # number of iterations performed
    relres: jnp.ndarray      # final implicit relative residual
    converged: jnp.ndarray


def gmres(op: Callable, b: jnp.ndarray, x0: jnp.ndarray,
          prec: Optional[Callable] = None, *, tol: float = 1e-8,
          maxiter: int = 100, left: bool = False,
          scale_with_rhs: bool = False,
          restart: Optional[int] = None,
          _scale=None) -> KrylovResult:
    """Preconditioned GMRES.

    op/prec: closures x -> A x and x -> M^{-1} x.
    left: left preconditioning (residual measured in preconditioned
    norm, like Belos); otherwise right preconditioning.
    restart: Krylov basis size (Belos 'Num Blocks'); None or
    >= maxiter runs full GMRES.  With a restart, up to
    ceil(maxiter/restart) cycles run under an outer lax.while_loop
    (Belos 'Maximum Restarts' semantics: total iterations still
    capped at maxiter)."""
    if restart is not None and restart < maxiter:
        return _gmres_restarted(op, b, x0, prec, tol=tol, maxiter=maxiter,
                                left=left, scale_with_rhs=scale_with_rhs,
                                restart=restart)
    n = b.shape[0]
    dtype = b.dtype
    m = maxiter
    if prec is None:
        prec = lambda x: x
        left = False

    def matop(v):
        return prec(op(v)) if left else op(prec(v))

    r0 = b - op(x0)
    if left:
        r0 = prec(r0)
    beta = jnp.linalg.norm(r0)
    if _scale is not None:
        # restart cycles measure convergence against the scale of the
        # WHOLE solve, not their own cycle-initial residual
        scale = _scale
    elif scale_with_rhs:
        b_for_scale = prec(b) if left else b
        scale = jnp.linalg.norm(b_for_scale)
    else:
        scale = beta
    scale = jnp.where(scale > 0, scale, 1.0)

    V = jnp.zeros((m + 1, n), dtype=dtype)
    V = V.at[0].set(jnp.where(beta > 0, r0 / beta, r0))
    R = jnp.zeros((m + 1, m), dtype=dtype)   # rotated Hessenberg (upper tri)
    g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
    # accumulated Givens product Q = G_{k-1}...G_0 kept as a dense
    # (m+1, m+1) unitary: applying all previous rotations to the new
    # Hessenberg column is then ONE small matvec instead of a k-step
    # sequential scalar loop, which would dominate the whole Krylov
    # iteration for subdomain-scale solves
    Q = jnp.eye(m + 1, dtype=dtype)

    is_complex = jnp.iscomplexobj(b)

    def ortho(w, V, k):
        """CGS2 against basis vectors 0..k (masked)."""
        mask = (jnp.arange(m + 1) <= k).astype(w.real.dtype)
        Vc = V.conj() if is_complex else V
        # TRUE-dtype dots: reduced-precision passes (bf16 or TF32)
        # round CGS2 at 2^-8 to 2^-11, skew the basis, and the f32
        # inner solves pay ~3x the iterations (stokes128 L=2: 427 vs
        # 148 with bf16-pass products).  These matvecs are
        # memory-bound on V either way, so full f32 is ~free.
        HI = lax.Precision.HIGHEST
        h1 = jnp.matmul(Vc, w, precision=HI) * mask
        w = w - jnp.matmul(V.T, h1, precision=HI)
        h2 = jnp.matmul(Vc, w, precision=HI) * mask
        w = w - jnp.matmul(V.T, h2, precision=HI)
        return w, h1 + h2

    def body(state):
        V, R, g, Q, k, res, done = state
        w = matop(V[k])
        w, h = ortho(w, V, k)
        hk1 = jnp.linalg.norm(w).astype(dtype)
        V = V.at[k + 1].set(jnp.where(jnp.abs(hk1) > 0, w / hk1, w))

        # apply previous Givens rotations to the new column h[0..k], hk1
        # (one matvec; rows/cols >= k+2 of Q are still exactly identity
        # and col is zero there, so the product matches the sequential
        # rotation sweep up to summation order)
        col = h.at[k + 1].set(hk1)
        col = jnp.matmul(Q, col, precision=lax.Precision.HIGHEST)

        # new rotation to zero col[k+1] (complex-safe Givens: c real,
        # s = sign(a) conj(b) / r)
        a, bb = col[k], col[k + 1]
        denom = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(bb) ** 2)
        absa = jnp.abs(a)
        ck = jnp.where(denom > 0, absa / denom, 1.0).astype(dtype)
        sgn = jnp.where(absa > 0, a / jnp.where(absa > 0, absa, 1.0),
                        jnp.ones((), dtype))
        sk = jnp.where(denom > 0, sgn * jnp.conj(bb) / denom,
                       jnp.zeros((), dtype))
        col = col.at[k].set((denom * sgn).astype(dtype)).at[k + 1].set(0.0)
        # fold G_k into Q: rows k and k+1 mix, all others unchanged
        qk, qk1 = Q[k], Q[k + 1]
        Q = Q.at[k].set(ck * qk + sk * qk1)
        Q = Q.at[k + 1].set(-jnp.conj(sk) * qk + ck * qk1)
        gk1 = -jnp.conj(sk) * g[k]
        g = g.at[k + 1].set(gk1).at[k].set(ck * g[k])

        R = R.at[:, k].set(col[:m + 1])
        res = jnp.abs(gk1) / scale
        done = res <= tol
        return V, R, g, Q, k + 1, res, done

    def cond(state):
        *_, k, res, done = state
        return jnp.logical_and(k < m, jnp.logical_not(done))

    init_res = beta / scale
    state = (V, R, g, Q, jnp.array(0, jnp.int32), init_res,
             init_res <= tol)
    V, R, g, Q, k, res, done = lax.while_loop(cond, body, state)

    # solve R[:k,:k] y = g[:k] with masking for the unused tail
    diag_fix = (jnp.arange(m) >= k).astype(dtype)
    Rm = R[:m, :] + jnp.diag(diag_fix)
    gm = g[:m] * (jnp.arange(m) < k).astype(dtype)
    y = jax.scipy.linalg.solve_triangular(Rm.T[:, :].T, gm, lower=False)
    # correction in the Krylov basis
    dx = jnp.matmul(V[:m].T, y, precision=lax.Precision.HIGHEST)
    x = x0 + (dx if left else prec(dx))
    return KrylovResult(x=x, iters=k, relres=res, converged=done)


def cg(op: Callable, b: jnp.ndarray, x0: jnp.ndarray,
       prec: Optional[Callable] = None, *, tol: float = 1e-8,
       maxiter: int = 100, scale_with_rhs: bool = False) -> KrylovResult:
    """Preconditioned conjugate gradients.  Works on negative-definite
    systems too (the reference's operators are negative definite by
    convention; CG formulas are invariant under simultaneous sign
    flip of the operator and preconditioner)."""
    if prec is None:
        prec = lambda x: x

    r0 = b - op(x0)
    z0 = prec(r0)
    scale = jnp.linalg.norm(b) if scale_with_rhs else jnp.linalg.norm(r0)
    scale = jnp.where(scale > 0, scale, 1.0)
    rz0 = jnp.vdot(r0, z0)

    def body(state):
        x, r, z, p, rz, k, res, done = state
        Ap = op(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        res = jnp.linalg.norm(r) / scale
        return x, r, z, p, rz_new, k + 1, res, res <= tol

    def cond(state):
        *_, k, res, done = state
        return jnp.logical_and(k < maxiter, jnp.logical_not(done))

    res0 = jnp.linalg.norm(r0) / scale
    state = (x0, r0, z0, z0, rz0, jnp.array(0, jnp.int32), res0,
             res0 <= tol)
    x, r, z, p, rz, k, res, done = lax.while_loop(cond, body, state)
    return KrylovResult(x=x, iters=k, relres=res, converged=done)


def _gmres_restarted(op, b, x0, prec, *, tol, maxiter, left,
                     scale_with_rhs, restart):
    """Outer restart loop around fixed-basis inner GMRES cycles."""
    # the convergence scale is fixed ONCE for the whole solve (Belos
    # scales by the initial residual / rhs of the solve, never by a
    # cycle's restart residual — otherwise every cycle would need the
    # full relative reduction on its own)
    r0 = b - op(x0)
    if left and prec is not None:
        r0 = prec(r0)
    if scale_with_rhs:
        b_for_scale = prec(b) if (left and prec is not None) else b
        scale0 = jnp.linalg.norm(b_for_scale)
    else:
        scale0 = jnp.linalg.norm(r0)
    scale0 = jnp.where(scale0 > 0, scale0, 1.0)

    def cycle(state):
        x, k, res, done = state
        inner = gmres(op, b, x, prec, tol=tol, maxiter=restart,
                      left=left, scale_with_rhs=scale_with_rhs,
                      _scale=scale0)
        x = jnp.where(done, x, inner.x)
        k = jnp.where(done, k, k + inner.iters)
        res = jnp.where(done, res, inner.relres)
        done = done | inner.converged
        return x, k, res, done

    def cond(state):
        _, k, _, done = state
        return (~done) & (k < maxiter)

    x, k, res, done = lax.while_loop(
        cond, cycle, (x0, jnp.asarray(0), jnp.asarray(jnp.inf, b.dtype),
                      jnp.asarray(False)))
    return KrylovResult(x=x, iters=k, relres=res, converged=done)
