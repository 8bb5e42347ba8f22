"""Neighbor-halo distributed V-cycle (parallel/halo_vcycle.py):
point-to-point ppermute exchanges only on the level path, bit-identical
to the single-device apply (reference minimal-overlap imports,
src/HYMLS_HierarchicalMap.cpp:197-244)."""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector
from hymls import Preconditioner
from hymls.parallel.mesh import make_mesh

from _mesh import NDEV_SWEEP
from hymls.parallel.halo_vcycle import make_halo_apply


def _build(nx, levels, eq="Laplace", part="Cartesian", sx=4):
    prob = {"Equations": eq, "Dimension": 2, "nx": nx, "ny": nx}
    params = Params({
        "Problem": prob,
        "Preconditioner": {"Partitioner": part, "Separator Length": sx,
                           "Number of Levels": levels,
                           "Structured Apply": False},
    })
    K = create_matrix(params)
    P = Preconditioner(K, params,
                       testvector=create_testvector(params, K)).compute()
    return K, P


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("nx,levels", [(32, 1), (64, 2), (32, 2)])
def test_halo_vcycle_bitmatches_serial(nx, levels):
    # (32, 2): the coarse level has 4 subdomains on 8 devices — the
    # trailing shards deactivate (the analog of reference rank
    # deactivation, HYMLS_BasePartitioner.cpp:588-683).  That level's
    # per-shard batch is 1 and XLA's batch-1 matmul kernel rounds dot
    # products in a different order than the serial batch-4 kernel, so
    # this case is ULP-equal (<=1e-13), not bit-equal; the routing
    # itself is exact (ndev=2, batch 2, is bit-identical).
    K, P = _build(nx, levels)
    mesh = make_mesh(8)
    app = make_halo_apply(P, mesh).place()
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    x_serial = np.asarray(P.apply_inverse(b))
    x_halo = np.asarray(app(b))
    if levels == 2 and nx == 32:
        assert np.abs(x_serial - x_halo).max() < 1e-13
    else:
        assert np.array_equal(x_serial, x_halo), \
            f"max diff {np.abs(x_serial - x_halo).max()}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_halo_vcycle_stokes_bitmatches_serial():
    K, P = _build(32, 1, eq="Stokes-C")
    mesh = make_mesh(8)
    app = make_halo_apply(P, mesh).place()
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    x_serial = np.asarray(P.apply_inverse(b))
    x_halo = np.asarray(app(b))
    assert np.array_equal(x_serial, x_halo), \
        f"max diff {np.abs(x_serial - x_halo).max()}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_halo_vcycle_no_allgather_on_level_path():
    """The only all-gather in the compiled HLO is the one coarse-rhs
    gather — the level path is pure ppermute (collective-permute),
    regardless of the number of levels."""
    K, P = _build(64, 2)
    mesh = make_mesh(8)
    app = make_halo_apply(P, mesh).place()
    b = app.to_local(jnp.zeros(K.shape[0]))
    txt = jax.jit(app._fn.__wrapped__ if hasattr(app._fn, "__wrapped__")
                  else app._fn).lower(
        app.factors, app.dplans, b).compile().as_text()
    n_ag = len(re.findall(r"all-gather", txt))
    n_cp = len(re.findall(r"collective-permute", txt))
    assert n_ag <= 1, f"{n_ag} all-gathers on a 2-level apply"
    assert n_cp >= 2, "expected ppermute neighbor exchanges"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_halo_communication_volume():
    """Per-level exchanged words are O(boundary separators/device),
    far below the all_gather volume (= everything, every level)."""
    from hymls.parallel.halo_vcycle import build_halo_plans
    K, P = _build(64, 2)
    levels, coarse, meta, bmaps = build_halo_plans(P, 8)
    for lm, d in zip(meta, levels):
        sent = 0
        for pre in ("y2", "nx", "up", "x2"):
            for off in lm.get(f"{pre}_offsets", []):
                sent += d[f"{pre}_send_{off}"].shape[1]
        n_owned = lm["max_onod"]
        assert sent < n_owned, (
            f"level exchange volume {sent} not below owned nodes "
            f"{n_owned}")


# ---------------------------------------------------------------------------
# breadth: {Cartesian, Skew} x {Laplace, Stokes} x {2D, 3D} x L in {1,2}
# (reference gate: the full unit suite at 1..8 ranks,
#  testSuite/unit_tests/CMakeLists.txt:36-48)
# ---------------------------------------------------------------------------

def _build_any(eq, dim, part, nx, levels, dof=None, sx=4):
    prob = {"Equations": eq, "Dimension": dim, "nx": nx, "ny": nx}
    if dim == 3:
        prob["nz"] = nx
    if dof:
        prob["Degrees of Freedom"] = dof
    params = Params({
        "Problem": prob,
        "Preconditioner": {"Partitioner": part, "Separator Length": sx,
                           "Number of Levels": levels,
                           "Structured Apply": False},
    })
    K = create_matrix(params)
    P = Preconditioner(K, params,
                       testvector=create_testvector(params, K)).compute()
    return K, P


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("eq,dim,part,nx,levels,dof", [
    ("Laplace", 3, "Cartesian", 16, 1, None),
    ("Laplace", 3, "Cartesian", 16, 2, None),
    ("Stokes-C", 3, "Cartesian", 16, 1, 4),
    ("Stokes-C", 3, "Cartesian", 16, 2, 4),
    ("Laplace", 2, "Skew Cartesian", 32, 1, None),
    ("Laplace", 2, "Skew Cartesian", 32, 2, None),
    ("Stokes-C", 2, "Skew Cartesian", 32, 2, 3),
    ("Darcy", 2, "Skew Cartesian", 32, 2, 3),
    ("Laplace", 3, "Skew Cartesian", 16, 1, None),
    ("Stokes-C", 3, "Skew Cartesian", 16, 2, 4),
])
@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_halo_vcycle_breadth(eq, dim, part, nx, levels, dof, ndev):
    """Distributed halo apply == serial apply across partitioners,
    equations, dimensions, and level counts (bit-exact at the full
    mesh: the exchange preserves the serial summation order; at
    2/3/5 devices the ceil-block padding changes batch shapes, whose
    kernels may round in a different order -> ULP tolerance)."""
    K, P = _build_any(eq, dim, part, nx, levels, dof)
    mesh = make_mesh(ndev)
    app = make_halo_apply(P, mesh).place()
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    x_serial = np.asarray(P.apply_inverse(b))
    x_halo = np.asarray(app(b))
    scale = max(np.abs(x_serial).max(), 1e-300)
    assert np.abs(x_serial - x_halo).max() / scale < 1e-13, \
        f"rel diff {np.abs(x_serial - x_halo).max() / scale}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_halo_vcycle_bordered(ndev):
    """Bordered halo apply [x;s] = M^{-1}[b;t] == serial bordered apply
    (border reductions ride one psum per level; reference bordered
    ApplyInverse, src/HYMLS_SchurPreconditioner.cpp:1517-1619)."""
    from hymls.stencils import laplace2d_neumann, create_nullspace
    nx = 32
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant"},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2,
                           "Structured Apply": False},
    })
    K = laplace2d_neumann(nx, nx)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    P = Preconditioner(K, params, testvector=tv)
    P.set_border(jnp.asarray(ns))
    P.compute()

    mesh = make_mesh(ndev)
    app = make_halo_apply(P, mesh).place()
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    t = jnp.asarray(rng.standard_normal(ns.shape[1]))

    x_ref, s_ref = P._apply_bordered_jit(
        P._prune_factors(P.factors), P._aplans, b, t)
    x_h, s_h = app.apply_bordered(b, t)
    x_ref, s_ref = np.asarray(x_ref), np.asarray(s_ref)
    x_h, s_h = np.asarray(x_h), np.asarray(s_h)
    scale = max(np.abs(x_ref).max(), 1e-300)
    assert np.abs(x_ref - x_h).max() / scale < 1e-12
    assert np.abs(s_ref - s_h).max() < 1e-12 * max(np.abs(s_ref).max(), 1)
