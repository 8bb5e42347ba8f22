"""Parity of the structured (gather-free) Cartesian apply vs the
generic gather path (core/structured.py vs core/preconditioner.py).

The structured engine is a pure re-expression of the same math, so the
two applies must agree to rounding on every supported configuration,
and unsupported configurations must fall back cleanly."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector
from hymls.core.preconditioner import Preconditioner


def _build(eq, prob, prec, dim=2):
    params = Params({
        "Problem": dict(Equations=eq, Dimension=dim, **prob),
        "Preconditioner": dict({"Separator Length": 4}, **prec),
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    return K, Preconditioner(K, params, testvector=tv)


CASES = [
    ("Laplace", {"nx": 16, "ny": 16}, {"Number of Levels": 1}),
    ("Laplace", {"nx": 32, "ny": 32}, {"Number of Levels": 2}),
    ("Laplace", {"nx": 64, "ny": 64}, {"Number of Levels": 3}),
    ("Laplace", {"nx": 32, "ny": 16}, {"Number of Levels": 1}),
    ("Laplace", {"nx": 64, "ny": 8},
     {"Number of Levels": 1, "Separator Length (x)": 16,
      "Separator Length (y)": 4}),
    ("Laplace", {"nx": 32, "ny": 32},
     {"Number of Levels": 2, "Retain Nodes": 2}),
    ("Laplace", {"nx": 48, "ny": 48},
     {"Number of Levels": 2, "Coarsening Factor": 3}),
    ("Stokes-C", {"nx": 16, "ny": 16}, {"Number of Levels": 1}),
    ("Stokes-C", {"nx": 32, "ny": 32}, {"Number of Levels": 2}),
    ("Stokes-C", {"nx": 32, "ny": 32},
     {"Number of Levels": 2, "Preconditioner Variant": "Lower Triangular"}),
    ("Darcy", {"nx": 32, "ny": 32}, {"Number of Levels": 2}),
    # periodic grids (contribution exchange wraps via jnp.roll)
    ("Laplace", {"nx": 16, "ny": 16, "x-periodic": True},
     {"Number of Levels": 1}),
    ("Laplace", {"nx": 32, "ny": 32, "x-periodic": True,
                 "y-periodic": True}, {"Number of Levels": 2}),
]

CASES_3D = [
    ("Laplace", {"nx": 8, "ny": 8, "nz": 8}, {"Number of Levels": 1}),
    ("Laplace", {"nx": 16, "ny": 16, "nz": 16}, {"Number of Levels": 2}),
    ("Stokes-C", {"nx": 8, "ny": 8, "nz": 8}, {"Number of Levels": 1}),
    ("Darcy", {"nx": 8, "ny": 8, "nz": 8}, {"Number of Levels": 1}),
    ("Laplace", {"nx": 8, "ny": 8, "nz": 8, "z-periodic": True},
     {"Number of Levels": 1}),
]


@pytest.mark.parametrize("eq,prob,prec,dim",
                         [c + (2,) for c in CASES]
                         + [c + (3,) for c in CASES_3D])
def test_structured_matches_generic(eq, prob, prec, dim):
    K, P = _build(eq, prob, prec, dim)
    assert P._structured is not None, \
        f"expected structured path, got fallback: " \
        f"{getattr(P, '_structured_reason', '')}"
    P.compute()
    rng = np.random.default_rng(42)
    b = rng.standard_normal(K.shape[0])
    x_s = np.asarray(P._sapply_jit(P._sfactors, P._structured.consts,
                                   jnp.asarray(b)))
    x_g = np.asarray(P._apply_jit(P._prune_factors(P._factors),
                                  P._aplans_gen, jnp.asarray(b)))
    scale = np.max(np.abs(x_g))
    assert np.max(np.abs(x_s - x_g)) <= 1e-12 * scale


def test_apply_factors_from_matches_compute():
    """The external-refactorization helper must produce the same
    structured factors as compute()."""
    K, P = _build("Laplace", {"nx": 32, "ny": 32}, {"Number of Levels": 2})
    P.compute()
    f2 = P.apply_factors_from(P._factors)
    for a, b in zip(jax.tree.leaves(P._sfactors), jax.tree.leaves(f2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


SKEW_CASES = [
    ("Laplace", {"nx": 16, "ny": 16}, {"Number of Levels": 1}),
    ("Laplace", {"nx": 32, "ny": 32}, {"Number of Levels": 2}),
    ("Stokes-C", {"nx": 16, "ny": 16}, {"Number of Levels": 1}),
    ("Darcy", {"nx": 32, "ny": 32}, {"Number of Levels": 2}),
]
# the deeper multilevel Stokes skew cases compile ~30 s each on the
# 1-core CI host; structurally covered by the fast members above
SKEW_CASES_SLOW = [
    ("Stokes-C", {"nx": 32, "ny": 32}, {"Number of Levels": 2}),
    ("Stokes-C", {"nx": 64, "ny": 64}, {"Number of Levels": 3}),
]


@pytest.mark.slow
@pytest.mark.parametrize("eq,prob,prec", SKEW_CASES_SLOW)
def test_skew_structured_matches_generic_slow(eq, prob, prec):
    test_skew_structured_matches_generic(eq, prob, prec)


@pytest.mark.parametrize("eq,prob,prec", SKEW_CASES)
def test_skew_structured_matches_generic(eq, prob, prec):
    """The skew (diamond) partitioner runs the structured path in
    perm mode (boxes = the rotated (A,B) diamond lattice)."""
    prec = dict({"Partitioner": "Skew Cartesian"}, **prec)
    K, P = _build(eq, prob, prec)
    assert P._structured is not None, \
        getattr(P, "_structured_reason", "")
    assert P._structured.levels[0].mode == "perm"
    P.compute()
    rng = np.random.default_rng(7)
    b = rng.standard_normal(K.shape[0])
    x_s = np.asarray(P._sapply_jit(P._sfactors, P._structured.consts,
                                   jnp.asarray(b)))
    x_g = np.asarray(P._apply_jit(P._prune_factors(P._factors),
                                  P._aplans_gen, jnp.asarray(b)))
    scale = np.max(np.abs(x_g))
    assert np.max(np.abs(x_s - x_g)) <= 1e-12 * scale


SKEW_CASES_3D = [
    ("Laplace", {"nx": 8, "ny": 8, "nz": 8}, {"Number of Levels": 1}),
    # 16^3 2-level skew Stokes also passes (2.5e-14) but its CPU
    # compile dominates suite wall-clock; exercised by chip_smoke.py
]
SKEW_CASES_3D_SLOW = [
    ("Stokes-C", {"nx": 8, "ny": 8, "nz": 8}, {"Number of Levels": 1}),
]


@pytest.mark.slow
@pytest.mark.parametrize("eq,prob,prec", SKEW_CASES_3D_SLOW)
def test_skew_3d_structured_matches_generic_slow(eq, prob, prec):
    test_skew_3d_structured_matches_generic(eq, prob, prec)


@pytest.mark.parametrize("eq,prob,prec", SKEW_CASES_3D)
def test_skew_3d_structured_matches_generic(eq, prob, prec):
    """3D skew (octahedral lattice = per-layer diamond lattices)."""
    prec = dict({"Partitioner": "Skew Cartesian"}, **prec)
    K, P = _build(eq, prob, prec, dim=3)
    assert P._structured is not None, \
        getattr(P, "_structured_reason", "")
    P.compute()
    rng = np.random.default_rng(11)
    b = rng.standard_normal(K.shape[0])
    x_s = np.asarray(P._sapply_jit(P._sfactors, P._structured.consts,
                                   jnp.asarray(b)))
    x_g = np.asarray(P._apply_jit(P._prune_factors(P._factors),
                                  P._aplans_gen, jnp.asarray(b)))
    scale = np.max(np.abs(x_g))
    assert np.max(np.abs(x_s - x_g)) <= 1e-12 * scale


SORT_PERM_CASES = [
    ("Laplace", {"nx": 32, "ny": 32}, {"Number of Levels": 2}, 2),
    ("Stokes-C", {"nx": 16, "ny": 16}, {"Number of Levels": 1}, 2),
    ("Laplace", {"nx": 8, "ny": 8, "nz": 8}, {"Number of Levels": 1}, 3),
]


@pytest.mark.parametrize("eq,prob,prec,dim", SORT_PERM_CASES)
def test_sort_perm_strategy_bit_identical(eq, prob, prec, dim,
                                          monkeypatch):
    """The sort-based static permutation (entry/exit/up maps as
    lax.sort_key_val over precomputed inverse-permutation keys,
    core/structured.py:_perm_sort_plan) is an exact re-expression of
    the gather: values only move, so the two strategies must agree
    BIT-FOR-BIT (tools/route_bench.py times the strategies)."""
    prec = dict({"Partitioner": "Skew Cartesian"}, **prec)
    outs = {}
    for strat in ("gather", "sort"):
        monkeypatch.setenv("HYMLS_PERM_STRATEGY", strat)
        K, P = _build(eq, prob, prec, dim)
        assert P._structured is not None, \
            getattr(P, "_structured_reason", "")
        keyed = any("_skeys" in k for c in P._structured.consts["levels"]
                    for k in c)
        assert keyed == (strat == "sort")
        P.compute()
        b = np.random.default_rng(3).standard_normal(K.shape[0])
        outs[strat] = np.asarray(P._sapply_jit(
            P._sfactors, P._structured.consts, jnp.asarray(b)))
    np.testing.assert_array_equal(outs["gather"], outs["sort"])


CONFIG_CASES = ["stokes_L2"]
CONFIG_CASES_SLOW = ["stokes_L3", "stokes_THCM3", "stokes_THCM4"]


@pytest.mark.slow
@pytest.mark.parametrize("cfg", CONFIG_CASES_SLOW)
def test_config_structured_matches_generic_slow(cfg):
    test_config_structured_matches_generic(cfg)


@pytest.mark.parametrize("cfg", CONFIG_CASES)
def test_config_structured_matches_generic(cfg):
    """Shipped ocean-grid configs (B-grid transform, non-divisible
    10x11x8 grids, whole-grid coarse boxes) on the structured path."""
    import os
    from hymls.config import load_xml
    params = load_xml(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", f"{cfg}.xml"))
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv)
    assert P._structured is not None, \
        getattr(P, "_structured_reason", "")
    P.compute()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(K.shape[0])
    x_s = np.asarray(P._sapply_jit(P._sfactors, P._structured.consts,
                                   jnp.asarray(b)))
    x_g = np.asarray(P._apply_jit(P._prune_factors(P._factors),
                                  P._aplans_gen, jnp.asarray(b)))
    scale = np.max(np.abs(x_g))
    assert np.max(np.abs(x_s - x_g)) <= 1e-12 * scale


def test_periodic_skew_falls_back():
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 16, "ny": 16, "x-periodic": True},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv)
    assert P._structured is None
    # the generic path still solves
    P.compute()
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    x = P.apply_inverse(b)
    assert np.all(np.isfinite(np.asarray(x)))


def test_disable_by_parameter():
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 16, "ny": 16},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1,
                           "Structured Apply": False},
    })
    K = create_matrix(params)
    P = Preconditioner(K, params, testvector=create_testvector(params, K))
    assert P._structured is None


def test_solver_iteration_counts_identical():
    """End-to-end: CG iteration counts with the structured apply must
    equal the generic path's (laplace1-style config)."""
    from hymls.solvers.solver import Solver

    def run(structured):
        params = Params({
            "Problem": {"Equations": "Laplace", "Dimension": 2,
                        "nx": 32, "ny": 32},
            "Solver": {"Krylov Method": "CG", "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": 100,
                                            "Convergence Tolerance": 1e-10}},
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": 2,
                               "Structured Apply": structured},
        })
        K = create_matrix(params)
        tv = create_testvector(params, K)
        P = Preconditioner(K, params, testvector=tv).compute()
        if structured:
            assert P._structured is not None
        S = Solver(K, P, params)
        rng = np.random.default_rng(3)
        x_ex = rng.standard_normal(K.shape[0])
        b = K @ x_ex
        x, res = S.apply_inverse(b)
        relerr = np.linalg.norm(np.asarray(x) - x_ex) / np.linalg.norm(x_ex)
        return int(res.iters), relerr

    it_s, err_s = run(True)
    it_g, err_g = run(False)
    assert it_s == it_g
    assert err_s <= 1e-9 and err_g <= 1e-9


def test_sharded_structured_apply_matches():
    """GSPMD-distributed structured V-cycle (StructuredProgram.
    sharded_apply_fn): box-grid axis sharded over an 8-device mesh —
    bit-identical output to the replicated structured apply, with the
    roll neighbor exchange partitioned into collective-permutes (the
    reference's Export-with-Add halo traffic,
    src/HYMLS_Preconditioner.cpp:973-1052)."""
    import re
    from hymls.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    K, P = _build("Stokes-C", {"nx": 64, "ny": 64},
                  {"Number of Levels": 2}, 2)
    assert P._structured is not None
    P.compute()
    rng = np.random.default_rng(7)
    b = rng.standard_normal(K.shape[0])
    x_ref = np.asarray(P._sapply_jit(P._sfactors, P._structured.consts,
                                     jnp.asarray(b)))

    mesh = make_mesh(8)
    apply_sh = P._structured.sharded_apply_fn(mesh)
    fn = jax.jit(lambda f, c, b: apply_sh(f, b, c))
    with mesh:
        x_sh = np.asarray(fn(P._sfactors, P._structured.consts,
                             jnp.asarray(b)))
        txt = fn.lower(P._sfactors, P._structured.consts,
                       jnp.asarray(b)).compile().as_text()
    scale = np.max(np.abs(x_ref))
    assert np.max(np.abs(x_sh - x_ref)) <= 1e-12 * scale
    # the level-0 box grid (16x16 boxes over 8 shards) must move its
    # roll wraparound point-to-point, not by gathering the grid
    assert re.search(r"collective-permute", txt), \
        "expected collective-permute traffic in the sharded apply"
