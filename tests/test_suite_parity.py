"""Run every ported reference integration-test config through the
driver and enforce its Targets (reference
testSuite/integration_tests/*.xml via integration_tests.cpp)."""
import os

import pytest

from hymls.config import load_xml
from hymls.driver import run_case

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = "/root/reference/testSuite/data"


def _run(name):
    params = load_xml(os.path.join(HERE, "configs", f"{name}.xml"))
    if params.sublist("Driver").get("Read Linear System", False):
        if not os.path.isdir(
                params.sublist("Driver").get("Data Directory", "")):
            pytest.skip("reference data not available")
    rep = run_case(params)
    assert rep.passed, rep.failures
    return rep


# fast = one representative per family; deeper L/THCM refinements move
# to slow (the 1-core CI host pays 30-60 s of XLA compile each; the
# family's group rules are already covered by the fast member)
FAST = ["stokes3", "stokes4", "stokes5", "stokes4_3D",
        "stokes_L", "stokes_L2", "stokes_THCM",
        "laplace1_deflation", "deflation1_bordering",
        "laplace1_eigs", "laplace1_eigs_deflation", "laplace_eigs",
        "neumann"]
SLOW = ["stokes0", "stokes0_3D", "stokes1_3D", "stokes2_3D",
        "stokes6", "stokes_L3", "stokes_L4", "stokes_THCM3",
        "stokes_THCM4", "bordering2", "laplace2_eigs", "turing",
        "cavity3D_eigs", "darcy", "convdiff"]


@pytest.mark.parametrize("name", FAST)
def test_fast_config(name):
    _run(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_slow_config(name):
    _run(name)
