"""Integration harness: run the repo configs through the driver and
check their Targets, mirroring the reference's integration_tests.cpp
refinement loop."""
import os

import pytest

from hymls.config import load_xml
from hymls.driver import run_with_refinements

CFG = os.path.join(os.path.dirname(__file__), "..", "configs")


def _run(name, max_refines=None):
    params = load_xml(os.path.join(CFG, name))
    reports = run_with_refinements(params, max_refines=max_refines)
    for i, r in enumerate(reports):
        assert r.passed, f"{name} refinement {i}: {r.failures} " \
            f"{[(s.iters, s.relres) for s in r.solves]}"
    return reports


# The named BASELINE.md gates run at the reference's full refinement
# depth (2 refinements = 3 grids, integration_tests.cpp:157-211):
# constant iteration targets under refinement are the executable form
# of the grid-independent-convergence claim.

def test_laplace1():
    _run("laplace1.xml")          # <=21 iters on 32^2 -> 64^2 -> 128^2


def test_laplace3():
    _run("laplace3.xml", max_refines=1)


def test_stokes1():
    _run("stokes1.xml")           # <=23 iters on 32^2 -> 64^2 -> 128^2


def test_stokes2():
    _run("stokes2.xml")           # multilevel flagship: <=48 iters @128^2


def test_bordering1():
    _run("bordering1.xml")


@pytest.mark.slow
def test_laplace2():
    _run("laplace2.xml")


@pytest.mark.slow
def test_threeD1():
    _run("threeD1.xml", max_refines=1)


def test_stokes2_data():
    """The reference's actual stokes2: read the DrivenCavity 128^2 Re0
    Jacobian from disk (reference integration_tests/stokes2.xml 'Read
    Linear System') and enforce <=48 iterations at 5e-6."""
    if not os.path.isdir(
            "/root/reference/testSuite/data/DrivenCavity/128x128/Re0"):
        pytest.skip("reference dataset not available")
    _run("stokes2_data.xml")
