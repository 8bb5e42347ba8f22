"""3D Stokes with the skew partitioner (reference stokes1_3D)."""
import numpy as np
import pytest

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector
from hymls import Preconditioner, Solver


@pytest.mark.slow
def test_stokes3d_skew_two_level():
    nx = 16
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 3,
                    "nx": nx, "ny": nx, "nz": nx},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Random",
                   "Iterative Solver": {"Maximum Iterations": 150,
                                        "Convergence Tolerance": 1e-6}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    pm = (np.arange(K.shape[0]) % 4) == 3
    x_ex[pm] -= x_ex[pm].mean()
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    relres = np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert relres < 5e-6
    # div-free preservation in 3D
    bdf = rng.standard_normal(K.shape[0])
    bdf[pm] = 0.0
    xdf = np.asarray(P.apply_inverse(bdf))
    assert np.abs((K @ xdf)[pm]).max() < 1e-8


@pytest.mark.slow
def test_stokes2_3d_multilevel():
    """Reference stokes2_3D: 16^3 skew multilevel (L=2, coarsening 2),
    target <= 145 iterations; this framework needs ~83."""
    nx = 16
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 3,
                    "nx": nx, "ny": nx, "nz": nx},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Random",
                   "Iterative Solver": {"Maximum Iterations": 150,
                                        "Convergence Tolerance": 1e-6}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4,
                           "Coarsening Factor": 2,
                           "Number of Levels": 2},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    pm = (np.arange(K.shape[0]) % 4) == 3
    x_ex[pm] -= x_ex[pm].mean()
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    relres = np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 145
    assert relres < 5e-6
