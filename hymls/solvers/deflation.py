"""Deflated solves: remove slow eigenmodes of the preconditioned
operator from the Krylov iteration.

Behavioral equivalent of the reference's DeflatedSolver
(reference src/HYMLS_DeflatedSolver.cpp): the dominant eigenvectors of
P^{-1} (or P^{-1}M with a mass matrix) span the modes the
preconditioner handles worst; they are computed once per Compute
(Anasazi Block-Krylov-Schur there, ARPACK here — host-side setup), and
every solve then runs the projected system

    (I - VV')A(I - VV') y = (I - VV') b

plus a small dense correction system for the V-components
(reference SetupDeflation lines 87-157 / ApplyInverse 159-245).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp
from jax import lax


class Deflation:
    """Holds the deflation space and dense correction factors."""

    def __init__(self, V, AV, ATV, R, D):
        self.V = V                 # (n, k) orthonormal deflation space
        self.AV = AV               # K @ V
        self.ATV = ATV             # K' @ V
        self.R = R                 # solve of projected AV ("deflationRhs")
        self.D = D                 # dense correction matrix (k, k)
        self.D_inv = np.linalg.inv(D)

    @property
    def k(self):
        return self.V.shape[1]


def compute_deflation_space(apply_prec: Callable, n: int, num_eigs: int,
                            apply_mass: Optional[Callable] = None,
                            tol: float = 1e-8) -> np.ndarray:
    """Dominant eigenspace of P^{-1} (resp. P^{-1} M) as a real
    orthonormal basis (reference EigsPrec + SVQB normalize)."""

    def mv(x):
        x = np.asarray(x, dtype=np.float64)
        if apply_mass is not None:
            x = np.asarray(apply_mass(x))
        return np.asarray(apply_prec(x))

    op = spla.LinearOperator((n, n), matvec=mv, dtype=np.float64)
    k = min(num_eigs, n - 2)
    vals, vecs = spla.eigs(op, k=k, which="LM", tol=tol)
    # real basis from the (possibly complex) eigenvectors
    cols = []
    for j in range(vecs.shape[1]):
        cols.append(np.real(vecs[:, j]))
        if np.any(np.imag(vecs[:, j]) != 0):
            cols.append(np.imag(vecs[:, j]))
    Vr = np.column_stack(cols)
    Q, _ = np.linalg.qr(Vr)
    return Q[:, :num_eigs]


def compute_deflation_space_device(apply_col: Callable, n: int,
                                   num_eigs: int, dtype,
                                   iters: int = 60, oversample: int = 6,
                                   seed: int = 12345,
                                   rtol: Optional[float] = None,
                                   _info: Optional[dict] = None
                                   ) -> np.ndarray:
    """Dominant eigenspace of P^{-1}(M) by blocked subspace iteration
    with a Rayleigh-Ritz extraction — the whole Arnoldi-style loop is
    ONE compiled program (vmapped V-cycle applies inside lax.while_loop)
    instead of the reference's host-driven Anasazi loop, with no
    per-matvec host round trip.

    The loop is RESIDUAL-GATED (the reference's Anasazi BKS iterates to
    a convergence tolerance, src/HYMLS_DeflatedSolver.cpp:247-310, not
    a fixed count): each iteration measures the block-invariance
    residual ||Z - Q(Q'Z)||_F / ||Q'Z||_F over the leading `num_eigs`
    columns (subspace iteration orders columns by descending |λ|) and
    stops when it drops under `rtol` — easy spectra converge in a few
    applies, hard ones still get the full `iters` cap.  The deflation
    algebra is exact for ANY orthonormal V (R/D are recomputed from V),
    so rtol only controls how well V spans the slow modes.

    `apply_col` must be a pure jax (n,) -> (n,) function (the
    preconditioner apply, optionally pre-composed with the mass op).
    `_info`, when a dict, receives {'applies', 'rel'} diagnostics."""
    kp = int(min(num_eigs + oversample, max(n - 2, 1)))
    if rtol is None:
        rtol = 1e-5 if np.dtype(dtype) == np.float64 else 1e-4
    rng = np.random.default_rng(seed)
    Q0 = np.linalg.qr(rng.standard_normal((n, kp)))[0]

    apply_block = jax.vmap(apply_col, in_axes=1, out_axes=1)

    @jax.jit
    def run(Q):
        def cond(state):
            _, it, rel = state
            return (it < iters) & (rel > rtol)

        def body(state):
            Q, it, _ = state
            Z = apply_block(Q)
            H = Q.T @ Z                  # Rayleigh-Ritz (nonsymmetric)
            Rres = Z[:, :num_eigs] - Q @ H[:, :num_eigs]
            rel = jnp.linalg.norm(Rres) / jnp.maximum(
                jnp.linalg.norm(H[:, :num_eigs]), 1e-30)
            Qn, _r = jnp.linalg.qr(Z)
            return Qn, it + 1, rel

        big = jnp.asarray(jnp.inf, Q.dtype)
        Q, it, rel = lax.while_loop(
            cond, body, (Q, jnp.asarray(0, jnp.int32), big))
        Z = apply_block(Q)
        H = Q.T @ Z
        return Q, H, it, rel

    Q, H, it, rel = run(jnp.asarray(Q0, dtype))
    if _info is not None:
        # +1: the final Ritz extraction costs one more block apply
        _info["applies"] = (int(it) + 1) * kp
        _info["rel"] = float(rel)
    Q, H = np.asarray(Q, np.float64), np.asarray(H, np.float64)
    vals, vecs = np.linalg.eig(H)
    order = np.argsort(-np.abs(vals), kind="stable")
    vecs = vecs[:, order]
    # real basis from (possibly complex-pair) Ritz vectors, same
    # realification as the ARPACK path above
    cols = []
    for j in range(vecs.shape[1]):
        cols.append(np.real(vecs[:, j]))
        if np.any(np.imag(vecs[:, j]) != 0):
            cols.append(np.imag(vecs[:, j]))
    Vr = Q @ np.column_stack(cols)
    Qf, _ = np.linalg.qr(Vr)
    return Qf[:, :num_eigs]


def setup_deflation(V: np.ndarray, matvec: Callable, matvec_t: Callable,
                    projected_solve: Callable,
                    multi_solve: Optional[Callable] = None) -> Deflation:
    """Build the correction system (reference SetupDeflation):
      AV = K V;  R = solve((I-VV')AV);  D = V'AV - (K'V)' R.

    `matvec`/`matvec_t` may accept a 2-D block (host scipy K @ V costs
    nothing); `multi_solve`, when given, solves all k projected columns
    in ONE batched program (PAV (n, k) -> R (n, k)) instead of k
    host-dispatched solves."""
    n, k = V.shape
    try:
        AV = np.asarray(matvec(V))
        assert AV.shape == (n, k)
    except Exception:
        AV = np.column_stack([np.asarray(matvec(V[:, j]))
                              for j in range(k)])
    # orthogonal part of AV, solved as one multi-RHS program
    PAV = AV - V @ (V.T @ AV)
    if multi_solve is not None:
        R = np.asarray(multi_solve(PAV))
    else:
        R = np.column_stack([np.asarray(projected_solve(PAV[:, j]))
                             for j in range(k)])
    try:
        ATV = np.asarray(matvec_t(V))
        assert ATV.shape == (n, k)
    except Exception:
        ATV = np.column_stack([np.asarray(matvec_t(V[:, j]))
                               for j in range(k)])
    D = V.T @ AV - ATV.T @ R
    return Deflation(V=V, AV=AV, ATV=ATV, R=R, D=D)


def deflated_apply(defl: Deflation, b: np.ndarray,
                   projected_solve: Callable) -> np.ndarray:
    """One deflated solve (reference DeflatedSolver::ApplyInverse)."""
    V, R = defl.V, defl.R
    tmp = b - V @ (V.T @ b)
    Wb = np.asarray(projected_solve(tmp))
    w = defl.ATV.T @ Wb - V.T @ b
    v = defl.D_inv @ w
    return Wb + R @ v - V @ v
