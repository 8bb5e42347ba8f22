"""Eigensolver tests (reference laplace1_eigs targets: 10 smallest
eigenvalues, tol 1e-8, <=70 JD iterations)."""
import numpy as np
import scipy.sparse.linalg as spla

from hymls.config import Params
from hymls.stencils import laplace2d
from hymls import Preconditioner, Solver
from hymls.solvers.eigen import JDQR, shift_invert_eigs


def _setup(nx=32):
    K = laplace2d(nx, nx)
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Eigenvalues": {
            "How Many": 10, "Which": "SM",
            "Convergence Tolerance": 1e-8,
            "Number of Iterations": 100,
            "Maximum Subspace Dimension": 40,
            "Restart Dimension": 20}},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1},
    })
    P = Preconditioner(K, params).compute()
    return K, params, P


def test_jdqr_laplace_eigs():
    K, params, P = _setup()
    jd = JDQR(K, None, P, params)
    res = jd.solve()
    assert res.converged == 10
    assert res.iterations <= 70
    ref = np.sort(np.abs(np.real(spla.eigs(
        K.asfptype(), k=10, sigma=0, which="LM",
        return_eigenvectors=False))))
    got = np.sort(np.abs(res.values))
    assert np.abs(got - ref).max() < 1e-8
    # residuals of the locked pairs
    for j in range(res.converged):
        u = res.vectors[:, j]
        lam = res.values[j]
        assert np.linalg.norm(K @ u - lam * u) < 1e-7


def test_shift_invert_eigs():
    K, params, P = _setup()
    S = Solver(K, P, params)
    res = shift_invert_eigs(K, None, S, k=10, target=0.0, tol=1e-10)
    ref = np.sort(np.abs(np.real(spla.eigs(
        K.asfptype(), k=10, sigma=0, which="LM",
        return_eigenvectors=False))))
    got = np.sort(np.abs(np.real(res.values)))
    assert np.abs(got - ref).max() < 1e-8


def test_jdqr_generalized():
    """Generalized eigenproblem K x = lambda M x with a (scaled
    lumped-mass) M; reference main_eigs path."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    K, params, P = _setup(nx=16)
    n = K.shape[0]
    rng = np.random.default_rng(4)
    M = sp.diags(1.0 + 0.5 * rng.random(n)).tocsr()
    jd = JDQR(K, M, P, params)
    jd.how_many = 6
    res = jd.solve()
    assert res.converged >= 6
    ref = spla.eigs(K.asfptype(), k=6, M=M.asfptype(), sigma=0,
                    which="LM", return_eigenvectors=False)
    ref = np.sort(np.abs(np.real(ref)))
    got = np.sort(np.abs(res.values))[:6]
    # M-orthogonal locking + oblique deflation: full accuracy
    assert np.abs(got - ref[:len(got)]).max() < 1e-8
    for j in range(6):
        u = res.vectors[:, j]
        lam = res.values[j]
        assert np.linalg.norm(K @ u - lam * (M @ u)) < 1e-7
