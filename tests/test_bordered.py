"""Bordered (nullspace-pinned) solves.

Mirrors the reference's bordering1.xml (Neumann Laplace + Constant
nullspace border, <=38 GMRES iterations at 5e-10) and the cavity.xml
setup (Stokes-C + Constant P border, Cartesian partitioner)."""
import numpy as np

from hymls.config import Params
from hymls.stencils import (laplace2d_neumann, create_matrix,
                                create_testvector, create_nullspace)
from hymls import Preconditioner, Solver


def test_bordering1_neumann_laplace():
    """Singular Neumann Laplace pinned by a constant-vector border."""
    nx = 32
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant"},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Random",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2},
    })
    K = laplace2d_neumann(nx, nx)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    P.compute()

    rng = np.random.default_rng(3)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    relerr = np.linalg.norm(x - x_ex) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 38
    assert relres < 5e-10
    assert relerr < 5e-10


def test_cavity_style_stokes_bordered():
    """Stokes-C with Cartesian partitioner + Constant-P border (the
    reference's cavity.xml benchmark configuration, ref
    testSuite/cavity.xml:18-26,60-80)."""
    nx = 32
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant P"},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Left",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 250,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": False,
                           "Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    P.compute()

    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 250
    assert relres < 1e-10


def test_skew_stokes_bordered():
    nx = 32
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant P"},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Fix Pressure Level": False,
                           "Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    P.compute()

    rng = np.random.default_rng(9)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert relres < 1e-8


def test_periodic_stokes_skew_bordered():
    """x/y-periodic Stokes (reference stokes4/5 family) with the
    Constant nullspace border."""
    from hymls.stencils import create_matrix, create_nullspace
    nx = 16
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx,
                    "x-periodic": True, "y-periodic": True},
        "Driver": {"Null Space Type": "Constant"},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Left",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 150,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Fix Pressure Level": False,
                           "Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    P.compute()
    rng = np.random.default_rng(3)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    relres = np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert relres < 1e-7


def test_restarted_gmres_num_blocks():
    """Belos 'Num Blocks' (GMRES restart length) parameter parity:
    restarted cycles converge to the same answer."""
    from hymls.stencils import laplace2d
    K = laplace2d(32, 32)
    base = {
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10,
                                        "Num Blocks": 8}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1},
    }
    params = Params(base)
    P = Preconditioner(K, params).compute()
    S = Solver(K, P, params)
    rng = np.random.default_rng(3)
    b = K @ rng.standard_normal(K.shape[0])
    x, res = S.apply_inverse(b)
    relres = np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert relres < 1e-9
    assert int(res.iters) <= 40   # a few extra iters from restarting
