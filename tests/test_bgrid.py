"""B-grid Stokes (reference stokes_B.xml: Apply Dropping=false,
Cartesian, 2 levels, coarsening 2, <=60 iterations at 1e-9)."""
import numpy as np

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector, \
    create_nullspace


def test_stokes_b_no_dropping():
    from hymls import Preconditioner, Solver
    nx = 32
    params = Params({
        "Problem": {"Equations": "Stokes-B", "Dimension": 2,
                    "nx": nx, "ny": nx, "Degrees of Freedom": 3},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": True,
                           "Apply Dropping": False,
                           "Separator Length": 8,
                           "Coarsening Factor": 2,
                           "Number of Levels": 2},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    ns = create_nullspace(
        Params({"Problem": params.sublist("Problem").to_dict(),
                "Driver": {"Null Space Type": "Checkerboard"}}),
        K.shape[0])
    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (np.linalg.pinv(ns) @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.array(x)
    err = x - x_ex
    x -= ns @ (np.linalg.pinv(ns) @ err)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    relerr = np.linalg.norm(x - x_ex) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 60
    assert relres < 1e-9
    assert relerr < 1e-9


def test_stokes_b_checkerboard_testvector():
    params = Params({"Problem": {"Equations": "Stokes-B", "Dimension": 2,
                                 "nx": 8, "ny": 8,
                                 "Degrees of Freedom": 3}})
    K = create_matrix(params)
    tv = create_testvector(params, K)
    nx, dof = 8, 3
    # u testvector alternates with i, v with j (reference
    # MainUtils::create_testvector for B-grids)
    g_u = (2 + 2 * nx) * dof + 0
    g_u2 = (3 + 2 * nx) * dof + 0
    assert tv[g_u] * tv[g_u2] == -1.0


def _lt_params(lbl, nx=8):
    return Params({
        "Problem": {"Equations": "Stokes-L", "Dimension": 3,
                    "nx": nx, "ny": nx, "nz": nx,
                    "Degrees of Freedom": 4},
        "Driver": {"Galeri Label": lbl},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": True,
                           "Apply Dropping": False,
                           "Separator Length (x)": 4,
                           "Separator Length (y)": 4,
                           "Separator Length (z)": nx,
                           "Coarsening Factor": 2,
                           "Number of Levels": 2},
    })


def _run_lt(lbl):
    """Reference stokes_L / stokes_THCM: 3D L/T grids, column
    subdomains (full z), Apply Dropping=false, <=80 iters @1e-9."""
    from hymls import Preconditioner, Solver
    params = _lt_params(lbl)
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    ns = create_nullspace(
        Params({"Problem": params.sublist("Problem").to_dict(),
                "Driver": {"Null Space Type": "Checkerboard"}}),
        K.shape[0])
    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (np.linalg.pinv(ns) @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.array(x)
    err = x - x_ex
    x -= ns @ (np.linalg.pinv(ns) @ err)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 80
    assert relres < 1e-9


def test_stokes_l_3d():
    _run_lt("Stokes-L")


def test_stokes_thcm_3d():
    _run_lt("Stokes-T")


def test_stokes_l2_bgrid_transform():
    """Reference stokes_L2: 3D L-grid with the B-Grid velocity
    transform (M = T'KT) plus parity group splitting."""
    from hymls import Preconditioner, Solver
    params = _lt_params("Stokes-L")
    params.sublist("Preconditioner")["B-Grid Transform"] = True
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    S = Solver(K, P, params)
    ns = create_nullspace(
        Params({"Problem": params.sublist("Problem").to_dict(),
                "Driver": {"Null Space Type": "Checkerboard"}}),
        K.shape[0])
    rng = np.random.default_rng(7)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (np.linalg.pinv(ns) @ x_ex)
    b = K @ x_ex
    x, res = S.apply_inverse(b)
    x = np.array(x)
    err = x - x_ex
    x -= ns @ (np.linalg.pinv(ns) @ err)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 80
    assert relres < 1e-9
