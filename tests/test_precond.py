import numpy as np
import pytest
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from hymls.config import Params
from hymls.stencils import laplace2d, laplace3d, create_matrix, \
    create_testvector
from hymls import Preconditioner, Solver


def _params(eqn, nx, levels, dim=2, krylov="GMRES", tol=1e-10, maxiter=100,
            lor="Left", sep=4, initial="Random"):
    prob = {"Equations": eqn, "Dimension": dim, "nx": nx, "ny": nx}
    if dim > 2:
        prob["nz"] = nx
    return Params({
        "Problem": prob,
        "Solver": {"Krylov Method": krylov, "Initial Vector": initial,
                   "Left or Right Preconditioning": lor,
                   "Iterative Solver": {"Maximum Iterations": maxiter,
                                        "Convergence Tolerance": tol}},
        "Preconditioner": {"Separator Length": sep,
                           "Number of Levels": levels},
    })


def _solve(params, K, tv=None):
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    return x, x_ex, relres, res


def test_direct_variant_is_exact():
    """Number of Levels == 0: interior elimination + direct SC solve
    must reproduce a sparse direct solve to machine precision."""
    params = _params("Laplace", 16, 0)
    K = laplace2d(16, 16)
    P = Preconditioner(K, params).compute()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(K.shape[0])
    x = np.asarray(P.apply_inverse(b))
    x_ref = spla.spsolve(K.tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-12


def test_laplace1_targets():
    """Reference integration test laplace1: 2-level method, CG, <=21
    iterations at 5e-10 relative residual, grid-independent
    (reference testSuite/integration_tests/laplace1.xml:20-24)."""
    for nx in (32, 64):
        params = _params("Laplace", nx, 1, krylov="CG")
        K = laplace2d(nx, nx)
        x, x_ex, relres, res = _solve(params, K)
        assert bool(res.converged)
        assert int(res.iters) <= 21, f"nx={nx}: {int(res.iters)} iters"
        assert relres < 5e-10


def test_laplace_gmres_right():
    params = _params("Laplace", 32, 1, krylov="GMRES", lor="Right")
    K = laplace2d(32, 32)
    x, x_ex, relres, res = _solve(params, K)
    assert bool(res.converged)
    assert relres < 5e-10
    assert int(res.iters) <= 21


def test_laplace2_multilevel():
    """Reference laplace2: 3 grids, Number of Levels=2, <=35 CG
    iterations at 1e-9 (testSuite/integration_tests/laplace2.xml)."""
    for nx in (64, 128):
        params = _params("Laplace", nx, 2, krylov="CG", tol=1e-10)
        K = laplace2d(nx, nx)
        x, x_ex, relres, res = _solve(params, K)
        assert bool(res.converged), f"nx={nx}"
        assert int(res.iters) <= 35, f"nx={nx}: {int(res.iters)} iters"
        assert relres < 1e-9


def test_threeD1():
    """Reference threeD1: 3D Laplace 32^3 (16^3 here for test speed),
    2 levels, CG, <=35 iterations at 1e-9."""
    params = _params("Laplace", 16, 1, dim=3, krylov="CG", tol=1e-10)
    K = laplace3d(16, 16, 16)
    x, x_ex, relres, res = _solve(params, K)
    assert bool(res.converged)
    assert int(res.iters) <= 35
    assert relres < 1e-9


def test_newton_reuse_same_pattern():
    """Preconditioner recompute with new values, same pattern
    (reference Preconditioner::SetMatrix semantics)."""
    params = _params("Laplace", 32, 1, krylov="CG")
    K = laplace2d(32, 32)
    P = Preconditioner(K, params).compute()
    K2 = K * 0.5
    P.compute(K2)
    S = Solver(K2, P, params)
    rng = np.random.default_rng(3)
    x_ex = rng.standard_normal(K.shape[0])
    b = K2 @ x_ex
    x, res = S.apply_inverse(b)
    relres = np.linalg.norm(K2 @ np.asarray(x) - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert relres < 5e-10


def test_int64_device_plans():
    """'Use 64-bit Indices' (the reference's HYMLS_LONG_LONG build
    option, HYMLS_config.h.in:42-46): forced-int64 device plans must
    produce the identical multilevel apply as the int32 default (auto
    promotion kicks in when a flat index exceeds the int32 range)."""
    K = laplace2d(16, 16)
    p32 = _params("Laplace", 16, 2)
    p64 = _params("Laplace", 16, 2)
    p64.sublist("Preconditioner")["Use 64-bit Indices"] = True
    P32 = Preconditioner(K, p32).compute()
    P64 = Preconditioner(K, p64).compute()
    assert P64._dplans[0]["int_pos"].dtype == jnp.int64
    assert P32._dplans[0]["int_pos"].dtype == jnp.int32
    rng = np.random.default_rng(9)
    b = rng.standard_normal(K.shape[0])
    y32 = np.asarray(P32.apply_inverse(b))
    y64 = np.asarray(P64.apply_inverse(b))
    assert np.array_equal(y32, y64)


@pytest.mark.parametrize("eqn,levels,part", [
    ("Stokes-C", 2, "Skew Cartesian"),
    ("Laplace", 1, "Cartesian"),
])
def test_factor_sort_perm_bit_identical(eqn, levels, part, monkeypatch):
    """The factor-path block-extraction gathers (A11/A12/A21/A22,
    sc11_gather, blk_idx) re-expressed as sort-permutations or as
    compact-sort+scatter (core/permute.py, chosen in _device_level)
    move values only — the factors and the preconditioner apply must
    agree BIT-FOR-BIT with the plain-gather strategy.  Non-injective
    maps (shared A22 entries) must silently fall back.  The apply
    plans must CARRY the strategy arrays (they are what makes the
    V-cycle gathers use the chosen strategy)."""
    import jax
    outs = {}
    for strat in ("gather", "sort", "scatter"):
        monkeypatch.setenv("HYMLS_PERM_STRATEGY", strat)
        params = _params(eqn, 16, levels, tol=1e-8)
        params.sublist("Preconditioner")["Partitioner"] = part
        params.sublist("Preconditioner")["Structured Apply"] = False
        K = create_matrix(params)
        P = Preconditioner(K, params,
                           testvector=create_testvector(params, K))
        nsk = sum(1 for d in P._dplans for f in d if f.endswith("_skeys"))
        assert (nsk > 0) == (strat == "sort")
        nsc = sum(1 for d in P._dplans for f in d if f.endswith("_spos"))
        assert (nsc > 0) == (strat == "scatter")
        if strat != "gather":
            # the pruned apply plans must keep the strategy arrays
            suf = "_skeys" if strat == "sort" else "_spos"
            assert any(f.endswith(suf) for d in P._aplans_gen for f in d)
        P.compute()
        b = np.random.default_rng(11).standard_normal(K.shape[0])
        outs[strat] = (P.factors, np.asarray(P.apply_inverse(b)))
    for other in ("sort", "scatter"):
        for a, c in zip(jax.tree.leaves(outs["gather"][0]),
                        jax.tree.leaves(outs[other][0])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        np.testing.assert_array_equal(outs["gather"][1], outs[other][1])


def test_warm_recompute_matches_fresh():
    """Preconditioner.recompute: the Newton-Schulz warm refactorization
    (dense.warm_inv) must match a cold compute() of the same matrix to
    solver precision for modest value changes, and fall back bit-
    identically to the cold factorization when the previous inverse no
    longer contracts (the residual-gated lax.cond branch).  This is the
    fast path for the reference's SetMatrix-then-Compute
    reuse in Newton/continuation loops
    (src/HYMLS_Preconditioner.cpp:400-517)."""
    params = _params("Stokes-C", 16, 2, tol=1e-8)
    params.sublist("Preconditioner")["Partitioner"] = "Skew Cartesian"
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    b = np.random.default_rng(3).standard_normal(K.shape[0])
    rng = np.random.default_rng(4)

    # modest perturbation: warm path, accuracy at the f64 Newton floor
    K2 = K.copy()
    K2.data = K.data * (1.0 + 1e-4 * rng.standard_normal(K.nnz))
    x2_fresh = np.asarray(
        Preconditioner(K2, params, testvector=tv).compute()
        .apply_inverse(b))
    P.recompute(K2)
    x2_warm = np.asarray(P.apply_inverse(b))
    rel = np.abs(x2_warm - x2_fresh).max() / np.abs(x2_fresh).max()
    assert rel < 1e-9, rel

    # large jump: per-inverse fallback reproduces the cold factors
    K3 = K.copy()
    K3.data = K.data * (1.0 + 0.9 * rng.standard_normal(K.nnz))
    x3_fresh = np.asarray(
        Preconditioner(K3, params, testvector=tv).compute()
        .apply_inverse(b))
    P.recompute(K3)
    x3_warm = np.asarray(P.apply_inverse(b))
    rel3 = np.abs(x3_warm - x3_fresh).max() / np.abs(x3_fresh).max()
    assert rel3 < 1e-9, rel3


def test_warm_newton_step_converges():
    """IterativeRefinementSolver.newton_step_warm_fn threads factors
    through a Newton sequence; every step must converge to the IR
    tolerance while the dense inverses are warm-polished."""
    import jax
    import jax.numpy as jnp
    from hymls.solvers.mixed import IterativeRefinementSolver

    params = _params("Stokes-C", 16, 2, tol=1e-10, maxiter=200,
                     lor="Right", initial="Zero")
    params.sublist("Preconditioner")["Partitioner"] = "Skew Cartesian"
    K = create_matrix(params)
    tv = create_testvector(params, K)
    S = IterativeRefinementSolver(K, params, testvector=tv)
    S.compute()
    b = K @ np.random.default_rng(5).standard_normal(K.shape[0])
    newton, dplans, extra, aplans = S.newton_step_warm_fn()
    vals64 = S.op64.vals
    vals32 = S.solver.op.vals
    bj = jnp.asarray(b, jnp.float64)
    factors = S.precond._factors
    for i in range(3):
        s = 1.0 + 1e-3 * i
        res, factors = newton(vals64 * s, vals32 * np.float32(s),
                              dplans, extra, aplans, bj, factors)
        assert float(res.relres) <= 1e-10, (i, float(res.relres))
