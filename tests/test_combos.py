"""Solver combinations: bordered+deflated and complex+bordered
(reference BorderedDeflatedSolver / ComplexBorderedSolver)."""
import numpy as np
import scipy.sparse as sp

from hymls.config import Params
from hymls.stencils import (laplace2d_neumann, create_testvector,
                                create_nullspace)
from hymls import Preconditioner, Solver
from hymls.solvers.complex_solver import ComplexSolver


def _neumann_setup(nx=32, levels=2, extra_solver=None):
    slv = {"Krylov Method": "GMRES", "Initial Vector": "Zero",
           "Iterative Solver": {"Maximum Iterations": 100,
                                "Convergence Tolerance": 1e-10}}
    if extra_solver:
        slv.update(extra_solver)
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant"},
        "Solver": slv,
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": levels}})
    K = laplace2d_neumann(nx, nx)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    return params, K, tv, ns


def test_bordered_deflated():
    params, K, tv, ns = _neumann_setup(
        extra_solver={"Deflated Subspace Dimension": 6})
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    P.compute()
    S.setup_deflation()
    rng = np.random.default_rng(3)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    assert np.linalg.norm(K @ x - b) / np.linalg.norm(b) < 5e-9
    assert np.linalg.norm(x - x_ex) / np.linalg.norm(x_ex) < 5e-9


def test_complex_bordered():
    params, K, tv, ns = _neumann_setup(levels=1)
    B = sp.identity(K.shape[0], format="csr") * 0.3
    P = Preconditioner(K, params, testvector=tv)
    CS = ComplexSolver(K, P, params, B=B)
    CS.set_border(ns)
    P.compute()
    rng = np.random.default_rng(5)
    z_ex = rng.standard_normal(K.shape[0]) + 1j * rng.standard_normal(
        K.shape[0])
    z_ex -= ns @ (ns.T.conj() @ z_ex)
    b = K @ z_ex + 1j * (B @ z_ex)
    z, res = CS.apply_inverse(b)
    z = np.asarray(z)
    rel = np.linalg.norm(K @ z + 1j * (B @ z) - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert rel < 1e-8
