"""Newton and pseudo-arclength continuation (NOX/LOCA role) on the 2D
Bratu problem -lap(u) = lam * exp(u), which has a fold at lam* ~ 6.81."""
import numpy as np
import scipy.sparse as sp
import pytest

from hymls.config import Params
from hymls.stencils import laplace2d
from hymls.nonlinear import NewtonSolver, Continuation


def _bratu(nx):
    L = -laplace2d(nx, nx)          # M-matrix form of -lap * h^2
    h2 = 1.0 / (nx + 1) ** 2

    def residual(x, lam):
        return L @ x - lam * h2 * np.exp(x)

    def jacobian(x, lam):
        J = (L - sp.diags(lam * h2 * np.exp(x))).tocsr()
        J.sum_duplicates()
        J.sort_indices()
        return J

    def dres_dlam(x, lam):
        return -h2 * np.exp(x)

    return residual, jacobian, dres_dlam


def _params(nx):
    return Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1},
    })


def test_newton_bratu():
    nx = 16
    residual, jacobian, dlam = _bratu(nx)
    lam = 3.0
    ns = NewtonSolver(lambda x: residual(x, lam),
                      lambda x: jacobian(x, lam), _params(nx))
    res = ns.solve(np.zeros(nx * nx))
    assert res.converged
    assert res.iterations <= 8
    assert np.linalg.norm(residual(res.x, lam)) < 1e-10
    assert res.x.max() > 0.1  # nontrivial solution


@pytest.mark.slow
def test_continuation_through_fold():
    """Arclength continuation must pass the Bratu fold (lam* ~ 6.81 on
    the continuum problem) onto the upper branch where lam decreases."""
    nx = 16
    residual, jacobian, dlam = _bratu(nx)
    ns = NewtonSolver(lambda x: residual(x, 0.5),
                      lambda x: jacobian(x, 0.5), _params(nx))
    start = ns.solve(np.zeros(nx * nx))
    assert start.converged

    cont = Continuation(residual, jacobian, dlam, _params(nx))
    branch = cont.trace(start.x, 0.5, ds=1.0, n_steps=22)
    lams = [p.lam for p in branch]
    umax = [p.x.max() for p in branch]
    # fold: lambda rises then falls while the amplitude keeps growing
    assert max(lams) > 6.0
    assert lams[-1] < max(lams) - 0.3, f"did not turn: {lams}"
    assert umax[-1] > umax[lams.index(max(lams))]
    # every corrector converged
    assert all(p.newton_iters < 12 for p in branch)


def test_continuation_restart(tmp_path):
    """Checkpoint/resume: an interrupted trace continued from its
    restart file must land on the same branch points as an
    uninterrupted run (the reference rev-test harness restart-file
    role, testSuite/rev_tests/runtest.py:40-47)."""
    nx = 8
    residual, jacobian, dlam = _bratu(nx)
    ns = NewtonSolver(lambda x: residual(x, 0.5),
                      lambda x: jacobian(x, 0.5), _params(nx))
    start = ns.solve(np.zeros(nx * nx))
    assert start.converged

    full = Continuation(residual, jacobian, dlam, _params(nx)).trace(
        start.x, 0.5, ds=1.0, n_steps=6)

    ckpt = str(tmp_path / "restart.npz")
    c1 = Continuation(residual, jacobian, dlam, _params(nx))
    c1.trace(start.x, 0.5, ds=1.0, n_steps=3,
             restart_file=ckpt, backup_interval=1)
    st = Continuation.load_state(ckpt)
    assert st["step"] == 3

    c2 = Continuation(residual, jacobian, dlam, _params(nx))
    resumed = c2.trace(start.x, 0.5, ds=1.0, n_steps=6,
                       restart_file=ckpt, backup_interval=2)
    # resumed branch continues from step 3 and reaches the same end
    # point as the uninterrupted run (same predictor/corrector path)
    assert abs(resumed[-1].lam - full[-1].lam) < 1e-8
    assert np.linalg.norm(resumed[-1].x - full[-1].x) < 1e-7
    assert Continuation.load_state(ckpt)["step"] == 6
