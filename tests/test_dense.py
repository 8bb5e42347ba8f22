"""Dense inverse accuracy: the residual-adaptive Newton polish.

`_newton_refine` (X <- X + X(I - AX), early exit, divergence guard)
polishes f64 inverses in `inv_newton` and warm-started inverses in
`warm_inv`.  These tests seed it with an f32 inverse — the hardest
seed it meets — and check that it recovers f64 residual accuracy on
ill-conditioned blocks of the kind the multilevel method produces
(periodic Schur complements, reference
src/HYMLS_SchurPreconditioner.cpp:520-629 next-level matrices).
"""
import _cpu  # noqa: F401  (pin CPU backend before jax init)

import numpy as np
import pytest

import jax.numpy as jnp

from hymls.core.dense import _newton_refine, inv_newton


def _f32_seeded(A, refine=6):
    """f64 inverse from an f32 seed + `refine` adaptive Newton steps."""
    A = jnp.asarray(A)
    X = jnp.linalg.inv(A.astype(jnp.float32)).astype(A.dtype)
    return _newton_refine(A, X, max_steps=refine)


def _spd_with_cond(n, cond, rng, batch=None):
    """Random SPD matrix (or batch) with prescribed 2-norm condition."""
    def one():
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        d = np.logspace(0, -np.log10(cond), n)
        return (Q * d) @ Q.T
    if batch is None:
        return one()
    return np.stack([one() for _ in range(batch)])


def _resid(A, X):
    eye = np.eye(A.shape[-1])
    return float(np.max(np.abs(eye - A @ X)))


@pytest.mark.parametrize("cond", [1e2, 1e5, 1e7])
def test_mixed_inverse_ill_conditioned(cond):
    """The attainable Newton residual floor is ~cond*eps64 (the rounding
    of computing AX); parity with an exact f64 inverse, not an absolute
    tolerance, is the correct claim (measured: mixed 2.3e-10 vs numpy
    2.5e-10 at cond 1e7)."""
    rng = np.random.default_rng(42)
    A = _spd_with_cond(24, cond, rng, batch=8)
    X = np.asarray(_f32_seeded(A))
    r_ref = _resid(A, np.linalg.inv(A))
    assert _resid(A, X) < 10 * r_ref + 1e-13


def test_mixed_inverse_divergence_guard():
    """Beyond cond ~2e7 the f32 seed has residual >= 1 and Newton cannot
    converge; the guard must keep the best iterate (never blow up)."""
    rng = np.random.default_rng(7)
    A = _spd_with_cond(24, 1e10, rng)
    Af32seed = np.asarray(
        jnp.linalg.inv(jnp.asarray(A, jnp.float32)), np.float64)
    r0 = _resid(A, Af32seed)
    X = np.asarray(_f32_seeded(A))
    assert np.isfinite(X).all()
    assert _resid(A, X) <= r0 * (1 + 1e-9)


def test_mixed_inverse_early_exit_matches_full():
    """Well-conditioned blocks: the adaptive loop must reach the same
    accuracy as an exact f64 inverse (early exit, no wasted steps is a
    perf property; here we check accuracy parity)."""
    rng = np.random.default_rng(3)
    A = _spd_with_cond(16, 10.0, rng, batch=4)
    X = np.asarray(_f32_seeded(A))
    Xref = np.linalg.inv(A)
    assert np.max(np.abs(X - Xref)) < 1e-12


@pytest.mark.slow   # two full L=2 Stokes solve compiles (~100 s, 1 core)
def test_multilevel_f64_through_mixed_path():
    """Full multilevel f64 solve (Stokes-C 32^2, L=2 — the stokes2-class
    shape) with every batched/dense inverse forced through the
    f32-seed + Newton path: relative residual and iteration count must
    match the all-f64 method (the reference hits 1e-10-class tolerances
    with KLU in f64, src/HYMLS_SparseDirectSolver.cpp)."""
    import hymls.core.preconditioner as pc
    from hymls.config import Params
    from hymls.stencils import create_matrix, create_testvector
    from hymls import Preconditioner, Solver

    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    rng = np.random.default_rng(0)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= x_ex.mean()
    b = K @ x_ex

    orig = pc._inv
    pc._inv = _f32_seeded
    try:
        P = Preconditioner(K, params, testvector=tv, dtype=jnp.float64)
        S = Solver(K, P, params, dtype=jnp.float64)
        P.compute()
        x, res = S.apply_inverse(b)
        iters_mixed = int(res.iters)
        relres = float(np.linalg.norm(K @ np.asarray(x) - b)
                       / np.linalg.norm(b))
    finally:
        pc._inv = orig

    P2 = Preconditioner(K, params, testvector=tv, dtype=jnp.float64)
    S2 = Solver(K, P2, params, dtype=jnp.float64)
    P2.compute()
    _, res2 = S2.apply_inverse(b)
    iters_f64 = int(res2.iters)

    assert relres <= 1e-10
    assert iters_mixed <= iters_f64 + 2


def test_factor_precision_f64_assembly():
    """'Factor Precision'='f64' (f64 assembly, f32 factors): the f32
    multilevel Schur assembly cancels catastrophically (measured 2.1%
    apply error on Stokes-C 32^2 L=2 and 86% / outright divergence on
    skew 32^3 L=2), while f64-assembled values cast to f32 stay within
    f32 apply-arithmetic noise.  This is the analogue of the
    reference performing all setup in double
    (HYMLS_SchurPreconditioner.cpp AssembleTransformAndDrop)."""
    from hymls.config import Params
    from hymls.stencils import create_matrix, create_testvector
    from hymls import Preconditioner

    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "GMRES",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    rng = np.random.default_rng(0)
    r = rng.standard_normal(K.shape[0])

    P64 = Preconditioner(K, params, testvector=tv,
                         dtype=jnp.float64).compute()
    y_ref = np.asarray(P64.apply_inverse(jnp.asarray(r)), np.float64)
    nref = np.linalg.norm(y_ref)

    def err(P):
        y = np.asarray(P.apply_inverse(jnp.asarray(r, P.dtype)),
                       np.float64)
        return np.linalg.norm(y - y_ref) / nref

    P32u = Preconditioner(K, params, testvector=tv, dtype=jnp.float32,
                          factor_dtype=jnp.float64).compute()
    # factors must be stored in the APPLY dtype (f32) — setup-only cost
    assert P32u.factors["levels"][0]["A11inv"].dtype == jnp.float32
    co = P32u.factors["coarse"]
    assert (co["inv"] if "inv" in co else co["lu"]).dtype == jnp.float32

    e_up = err(P32u)
    e_same = err(Preconditioner(K, params, testvector=tv,
                                dtype=jnp.float32).compute())
    # both pipelines use native LU, so the f32 comparator is ~5e-5;
    # with blkinv/coarse inverted in the store dtype the upcast error
    # is ~1.5e-6 — require one order of magnitude plus the absolute
    # bound the f64 IR outer loop needs.
    assert e_up < 1e-4, e_up
    assert e_up < e_same / 10, (e_up, e_same)


def test_ir_solver_factor_precision_default_and_optin():
    """IterativeRefinementSolver defaults to the all-f32 true-precision
    factor chain (measured at iteration parity with f64 assembly once
    every product is precision=HIGHEST — round 4), converging a
    multilevel problem to f64 tolerance through the f32 inner path;
    'Factor Precision' = 'f64' opts back into the upcast chain."""
    from hymls.config import Params
    from hymls.stencils import create_matrix, create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver

    def make(fprec=None):
        prec = {"Separator Length": 4, "Number of Levels": 2}
        if fprec:
            prec["Factor Precision"] = fprec
        return Params({
            "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                        "nx": 32, "ny": 32},
            "Solver": {"Krylov Method": "GMRES",
                       "Iterative Solver": {"Maximum Iterations": 200,
                                            "Convergence Tolerance":
                                                1e-10}},
            "Preconditioner": prec,
        })

    params = make()
    K = create_matrix(params)
    tv = create_testvector(params, K)
    S = IterativeRefinementSolver(K, params, testvector=tv).compute()
    assert S.precond.factor_dtype == jnp.float32
    rng = np.random.default_rng(1)
    b = np.asarray(K @ rng.standard_normal(K.shape[0]))
    x = np.asarray(S.solve(b))
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert relres <= 1e-10, relres
    iters_f32 = int(S._last_result.iters)

    S64 = IterativeRefinementSolver(K, make("f64"), testvector=tv)
    assert S64.precond.factor_dtype == jnp.float64
    S64.compute()
    x64 = np.asarray(S64.solve(b))
    relres64 = np.linalg.norm(K @ x64 - b) / np.linalg.norm(b)
    assert relres64 <= 1e-10, relres64
    # iteration parity between the chains (the flip's justification)
    assert iters_f32 <= int(S64._last_result.iters * 1.15) + 2


def test_inv_chain_hybrid_accuracy():
    """ONE Newton step from an f32 seed must reach ~1e-9-class inverse
    residual on subdomain-interior-like conditioning (quadratic
    contraction: ~cond^2 * eps32^2), two orders below the f32 seed —
    enough for factor values that are cast to f32 (6e-8) anyway."""
    rng = np.random.default_rng(7)
    A = _spd_with_cond(47, 1e4, rng, batch=8)
    X = np.asarray(_f32_seeded(A, refine=1))
    r = max(_resid(A[i], X[i]) for i in range(8))
    # ~cond^2 * eps32^2 class; anything below the f32 cast noise (6e-8)
    # of the stored factors is equivalent downstream
    assert r < 3e-8, r
    # f32-only seed for comparison: ~cond * eps32 ~ 6e-4
    X32 = np.asarray(jnp.linalg.inv(jnp.asarray(A, jnp.float32)),
                     np.float64)
    r32 = max(_resid(A[i], X32[i]) for i in range(8))
    assert r < r32 / 100


def test_factor_upcast_hybrid_chain_apply_accuracy():
    """Factor-upcast mode (f64 assembly, f32 factors) with every f64
    inverse built from an f32 seed + one Newton step: the resulting f32
    factors still reproduce the f64 apply to ~1e-5 (the f32-pipeline
    error on the same problem is 2.1e-2)."""
    import hymls.core.preconditioner as pc
    from hymls.config import Params
    from hymls.stencils import create_matrix, create_testvector
    from hymls import Preconditioner

    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "GMRES",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    rng = np.random.default_rng(0)
    r = rng.standard_normal(K.shape[0])

    P64 = Preconditioner(K, params, testvector=tv,
                         dtype=jnp.float64).compute()
    y_ref = np.asarray(P64.apply_inverse(jnp.asarray(r)), np.float64)

    orig = pc._inv

    def seeded_one_step(A):
        if A.dtype != jnp.float64:
            return orig(A)
        return _f32_seeded(A, refine=1)

    pc._inv = seeded_one_step
    try:
        P = Preconditioner(K, params, testvector=tv, dtype=jnp.float32,
                           factor_dtype=jnp.float64).compute()
        y = np.asarray(P.apply_inverse(jnp.asarray(r, jnp.float32)),
                       np.float64)
    finally:
        pc._inv = orig
    err = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert err < 1e-5, err


def test_inv_newton_native_dtype():
    """inv_newton inverts in the input dtype: f32 stays f32 (no
    polish), f64 reaches LAPACK-parity residuals."""
    rng = np.random.default_rng(5)
    A = _spd_with_cond(20, 1e5, rng, batch=3)
    X32 = inv_newton(jnp.asarray(A, jnp.float32))
    assert X32.dtype == jnp.float32
    X64 = np.asarray(inv_newton(jnp.asarray(A)))
    r_ref = max(_resid(A[i], np.linalg.inv(A[i])) for i in range(3))
    assert max(_resid(A[i], X64[i]) for i in range(3)) < 10 * r_ref + 1e-13


def test_dense_factor_inverse_or_lu():
    """dense_factor keeps an explicit inverse up to _LU_THRESHOLD and LU
    factors above it; dense_solve gives the same solution either way."""
    from hymls.core import dense

    rng = np.random.default_rng(9)
    for n, key in ((64, "inv"), (dense._LU_THRESHOLD + 8, "lu")):
        A = rng.standard_normal((n, n)) + n * np.eye(n)
        fac = dense.dense_factor(jnp.asarray(A))
        assert key in fac
        b = rng.standard_normal(n)
        x = np.asarray(dense.dense_solve(fac, jnp.asarray(b)))
        assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)
