"""Solve the reference's own driven-cavity Jacobian datasets (the
north-star benchmark: cavity.xml + testSuite/data/DrivenCavity).
Skipped when the reference data is not mounted."""
import os

import numpy as np
import pytest

from hymls.config import Params
from hymls.utils.io import read_linear_system
from hymls.stencils import create_testvector, create_nullspace
from hymls import Preconditioner, Solver

DATA = "/root/reference/testSuite/data/DrivenCavity"


@pytest.mark.skipif(not os.path.isdir(DATA), reason="reference data absent")
@pytest.mark.parametrize("size,re,nx", [("32x32", "Re0", 32),
                                        ("32x32", "Re1000", 32)])
def test_reference_cavity(size, re, nx):
    K, b, x_ex, ns, mass = read_linear_system(f"{DATA}/{size}/{re}")
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant P"},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 250,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": False,
                           "Separator Length": 4, "Number of Levels": 1}})
    if ns is None:
        ns = create_nullspace(params, K.shape[0])
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    P.compute()
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert bool(res.converged)
    assert int(res.iters) <= 250   # cavity.xml target
    assert relres < 1e-10


@pytest.mark.slow          # 16^3 structured compile dominates (~600 s
#                            on the 1-core CI host); the 2D cavity
#                            cases above keep the dataset path fast
@pytest.mark.skipif(not os.path.isdir(DATA), reason="reference data absent")
def test_reference_cavity3d():
    """cavity3D role (BASELINE.json configs): the 16^3 dataset on the
    structured 3D Cartesian path."""
    K, b, x_ex, ns, mass = read_linear_system(f"{DATA}/16x16x16/Re0")
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 3,
                    "nx": 16, "ny": 16, "nz": 16},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Left or Right Preconditioning": "Right",
                   "Iterative Solver": {"Maximum Iterations": 250,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Separator Length": 4, "Number of Levels": 1}})
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    assert P._structured is not None, \
        getattr(P, "_structured_reason", "")
    S = Solver(K, P, params)
    x, res = S.apply_inverse(b)
    x = np.asarray(x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert int(res.iters) <= 250   # cavity.xml iteration envelope
    assert relres < 1e-10
