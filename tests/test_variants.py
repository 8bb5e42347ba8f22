"""Deflated and complex solver variants."""
import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from hymls.config import Params
from hymls.stencils import laplace2d, create_testvector
from hymls.stencils.generators import _cross2d
from hymls import Preconditioner, Solver
from hymls.solvers.complex_solver import ComplexSolver


def _params(nx, levels=2, maxiter=100, tol=1e-10, extra_solver=None):
    slv = {"Krylov Method": "GMRES", "Initial Vector": "Zero",
           "Iterative Solver": {"Maximum Iterations": maxiter,
                                "Convergence Tolerance": tol}}
    if extra_solver:
        slv.update(extra_solver)
    return Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": slv,
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": levels},
    })


def test_deflated_solver():
    """Anisotropic Laplace with deflation of the preconditioner's worst
    modes (reference DeflatedSolver / deflation1.xml)."""
    nx, eps = 32, 0.01
    K = -_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)
    params = _params(nx, extra_solver={"Deflated Subspace Dimension": 8})
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    S.setup_deflation()
    rng = np.random.default_rng(5)
    x_ex = rng.standard_normal(K.shape[0])
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert relres < 5e-9
    assert np.linalg.norm(x - x_ex) / np.linalg.norm(x_ex) < 1e-7
    # the subspace iteration is residual-gated: an easy anisotropic
    # Laplace spectrum must converge well before the 60-iteration cap
    # (the fixed-count version burned 61 block applies regardless)
    info = S._defl_info
    assert info["rel"] <= 1e-5
    assert info["applies"] < 40 * (8 + 6), \
        f"subspace iteration did not gate: {info}"


def test_complex_solver():
    """Complex-shifted Laplace (A + i sigma I) with the real multilevel
    preconditioner of A (reference ComplexSolver semantics)."""
    nx = 32
    A = laplace2d(nx, nx)
    B = sp.identity(A.shape[0], format="csr") * 0.5
    params = _params(nx, levels=1, tol=1e-10)
    tv = create_testvector(params, A)
    P = Preconditioner(A, params, testvector=tv).compute()
    CS = ComplexSolver(A, P, params, B=B)
    rng = np.random.default_rng(11)
    z_ex = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(
        A.shape[0])
    b = A @ z_ex + 1j * (B @ z_ex)
    z, res = CS.apply_inverse(b)
    z = np.asarray(z)
    rel = np.linalg.norm(z - z_ex) / np.linalg.norm(z_ex)
    assert bool(res.converged)
    assert rel < 1e-8


def test_gmres_complex_consistency():
    """Complex GMRES on a real system must match the real result."""
    nx = 16
    K = laplace2d(nx, nx)
    params = _params(nx, levels=1)
    P = Preconditioner(K, params).compute()
    S = Solver(K, P, params)
    CS = ComplexSolver(K, P, params)
    rng = np.random.default_rng(2)
    x_ex = rng.standard_normal(K.shape[0])
    b = K @ x_ex
    x_r, _ = S.apply_inverse(b)
    x_c, _ = CS.apply_inverse(b.astype(np.complex128))
    assert np.linalg.norm(np.asarray(x_c) - np.asarray(x_r)) \
        / np.linalg.norm(np.asarray(x_r)) < 1e-9


def test_mixed_precision_preconditioner():
    """f32 preconditioner inside an f64 Krylov iteration: iteration
    count must match the all-f64 solve (preconditioner quality is
    insensitive to factor precision) while the Krylov residual still
    reaches f64-level tolerance."""
    import jax.numpy as jnp
    from hymls.stencils import laplace2d
    K = laplace2d(32, 32)
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "CG", "Initial Vector": "Random",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1},
    })
    P32 = Preconditioner(K, params, dtype=jnp.float32).compute()
    S = Solver(K, P32, params, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x_ex = rng.standard_normal(K.shape[0])
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    relres = np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b)
    assert int(res.iters) == 21      # same as the all-f64 solve
    assert relres < 1e-9             # f64-level accuracy


def test_preconditioner_variants_equivalent():
    """'Lower Triangular' / 'Upper Triangular' / 'Domain Decomposition'
    must produce the same preconditioned vector as 'Block Diagonal':
    the reference's triangular sweeps operate on the transformed+dropped
    matrix whose inter-block couplings are dropped (see plan.py)."""
    from hymls.stencils import create_matrix
    nx = 16
    base = {
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4, "Number of Levels": 1},
    }
    params = Params(base)
    K = create_matrix(params)
    tv = create_testvector(params, K)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(K.shape[0])

    ref = None
    for variant in ["Block Diagonal", "Lower Triangular",
                    "Upper Triangular"]:
        p = Params(base)
        p.sublist("Preconditioner")["Preconditioner Variant"] = variant
        P = Preconditioner(K, p, testvector=tv).compute()
        y = np.asarray(P.apply_inverse(b))
        if ref is None:
            ref = y
        else:
            assert np.allclose(y, ref, rtol=0, atol=1e-12), variant


def test_domain_decomposition_variant():
    """'Domain Decomposition' is one exact solve over ALL non-Vsum rows
    including cross-linked-set couplings (reference
    InitializeSingleBlock, HYMLS_SchurPreconditioner.cpp:342-382) — a
    strictly stronger preconditioner than 'Block Diagonal', so it must
    (a) produce a different preconditioned vector and (b) converge in
    no more GMRES iterations on the same problem."""
    from hymls.stencils import create_matrix
    nx = 32
    base = {
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1},
    }
    params = Params(base)
    K = create_matrix(params)
    tv = create_testvector(params, K)
    rng = np.random.default_rng(7)
    b = K @ rng.standard_normal(K.shape[0])

    iters = {}
    ys = {}
    for variant in ["Block Diagonal", "Domain Decomposition"]:
        p = Params(base)
        p.sublist("Preconditioner")["Preconditioner Variant"] = variant
        P = Preconditioner(K, p, testvector=tv).compute()
        ys[variant] = np.asarray(P.apply_inverse(b))
        S = Solver(K, P, p)
        x, res = S.apply_inverse(b)
        assert bool(res.converged), variant
        iters[variant] = int(res.iters)
    assert not np.allclose(ys["Domain Decomposition"],
                           ys["Block Diagonal"], rtol=0, atol=1e-12)
    # laplace1's <=21-iteration gate holds for both; DD is stronger
    assert iters["Block Diagonal"] <= 21
    assert iters["Domain Decomposition"] <= iters["Block Diagonal"]


def test_fused_iterative_refinement():
    """Fused on-device IR solve (one jitted program, no host syncs)
    matches the host-loop variant and reaches f64 accuracy."""
    from hymls.stencils import create_matrix, create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver
    nx = 32
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "CG", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    S = IterativeRefinementSolver(K, params, testvector=tv).compute()
    rng = np.random.default_rng(2)
    b = K @ rng.standard_normal(K.shape[0])
    x = np.asarray(S.solve(b))
    res = S._last_result
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert relres < 1e-10
    x2, _ = S.apply_inverse(b)
    assert np.allclose(x, np.asarray(x2), atol=1e-12)


def _stokes_params(nx, levels, schur_assembly=None, tol=1e-8):
    prec = {"Separator Length": 4, "Number of Levels": levels,
            "Structured Apply": False}
    if schur_assembly:
        prec["Schur Assembly"] = schur_assembly
    return Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 300,
                                        "Convergence Tolerance": tol}},
        "Preconditioner": prec,
    })


def test_vsum_split_assembly_next_level_accuracy():
    """'Schur Assembly' = 'Vsum f64' (_compute_level_split): the
    vsum-restricted f64 chain must reproduce the full-f64 chain's
    next-level values to the (eps32*cond)^2 accuracy class of the
    inv_chain bound, and the f32 apply factors must agree to f32
    rounding.  (The two paths group the A11^{-1} refinement
    differently, so agreement is ~1e-9 relative, not bit-exact.)"""
    from hymls.stencils import create_matrix
    from hymls.core.preconditioner import _compute_level

    K = None
    outs = {}
    for mode in ("Full f64", "Vsum f64"):
        params = _stokes_params(32, 2, schur_assembly=mode)
        params.sublist("Preconditioner")["Factor Precision"] = "f64"
        if K is None:
            K = create_matrix(params)
        P = Preconditioner(K, params, dtype=jnp.float32,
                           testvector=create_testvector(params, K))
        dp = P._dplans[0]
        assert ("vsum_col" in dp) == (mode == "Vsum f64")
        vals = jnp.asarray(K.data, jnp.float64)
        fac, nxt = _compute_level(
            vals, dp, (P.plans[0].n_sep, P.plans[0].nnz_sc),
            apply_ot=P.plans[0].apply_ot, store_dtype=jnp.float32)
        outs[mode] = (fac, np.asarray(nxt))
    nf, ns_ = outs["Full f64"][1], outs["Vsum f64"][1]
    scale = np.abs(nf).max()
    assert np.abs(nf - ns_).max() / scale < 1e-8, \
        f"next-level mismatch {np.abs(nf - ns_).max() / scale:.2e}"
    for key in ("G", "A21", "blkinv"):
        a = np.asarray(outs["Full f64"][0][key], np.float64)
        b = np.asarray(outs["Vsum f64"][0][key], np.float64)
        s = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() / s < 1e-4, \
            f"{key} mismatch {np.abs(a - b).max() / s:.2e}"


def test_vsum_split_iteration_parity():
    """The mixed-precision IR solve with the vsum-split assembly (the
    default under factor upcast) must converge with the same inner
    Krylov work as the full-f64 assembly — the whole point of the f64
    chain is next-level accuracy, which the split preserves."""
    from hymls.stencils import create_matrix, create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver

    iters = {}
    K = None
    for mode in ("Full f64", "Vsum f64"):
        params = _stokes_params(32, 2, schur_assembly=mode)
        # the split is an upcast-chain feature; opt into f64 factors
        # (the production default is the all-f32 chain)
        params.sublist("Preconditioner")["Factor Precision"] = "f64"
        if K is None:
            K = create_matrix(params)
        tv = create_testvector(params, K)
        S = IterativeRefinementSolver(K, params, testvector=tv)
        assert S.precond._split_assembly == (mode == "Vsum f64")
        S.compute()
        rng = np.random.default_rng(3)
        b = K @ rng.standard_normal(K.shape[0])
        x = np.asarray(S.solve(b))
        res = S._last_result
        relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
        assert relres < 1e-8, f"{mode}: relres {relres}"
        iters[mode] = int(res.iters)
    assert iters["Vsum f64"] <= int(iters["Full f64"] * 1.1) + 2, \
        f"split assembly degraded convergence: {iters}"


def test_comparison_driver():
    """main_ifpack-equivalent comparison path (ILU / Jacobi / None)."""
    from hymls.driver import run_comparison
    base = {
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Iterative Solver": {"Maximum Iterations": 500,
                                        "Convergence Tolerance": 1e-8}},
        "Driver": {"Preconditioning Method": "ILU"},
    }
    rep = run_comparison(Params(base))
    assert rep.relres < 1e-7 and rep.iters > 0
    base["Driver"]["Preconditioning Method"] = "Jacobi"
    rep_j = run_comparison(Params(base))
    assert rep_j.relres < 1e-7
    assert rep_j.iters > rep.iters      # ILU beats Jacobi
