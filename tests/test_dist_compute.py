"""Distributed factorization (parallel/dist_compute.py): per-shard
block extraction + ppermute Schur assembly, factors in the halo
layout (reference distributed setup: MatrixBlock per-rank extraction
src/HYMLS_MatrixBlock.cpp:74-134, GlobalAssemble off-proc sums
src/HYMLS_SchurPreconditioner.cpp:698-875)."""
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
from hymls.parallel.dist_compute import DistributedCompute

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")


def _build(eq, nx, levels, part="Cartesian", dim=2):
    prob = {"Equations": eq, "Dimension": dim, "nx": nx, "ny": nx}
    if dim == 3:
        prob["nz"] = nx
    params = Params({
        "Problem": prob,
        "Preconditioner": {"Partitioner": part, "Separator Length": 4,
                           "Number of Levels": levels,
                           "Structured Apply": False},
    })
    K = create_matrix(params)
    P = Preconditioner(K, params,
                       testvector=create_testvector(params, K)).compute()
    return K, P


@pytest.mark.parametrize("eq,nx,levels,part", [
    ("Laplace", 32, 1, "Cartesian"),
    ("Laplace", 64, 2, "Cartesian"),
    ("Stokes-C", 32, 2, "Cartesian"),
    ("Stokes-C", 32, 2, "Skew Cartesian"),
])
@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_dist_compute_matches_serial(eq, nx, levels, part, ndev):
    """Distributed factors == serially-computed factors stacked into
    the halo layout (assembly order is preserved, so agreement is to
    batched-kernel round-off).  Swept over mesh sizes incl.
    non-divisible ownership (reference 1..8-rank matrix)."""
    K, P = _build(eq, nx, levels, part)
    mesh = make_mesh(ndev)
    app = make_halo_apply(P, mesh)
    ref = app.stack_factors(P._prune_factors(P.factors))

    dc = DistributedCompute(P, mesh)
    got = dc.compute(jnp.asarray(K.data, P.dtype))

    for l in range(levels):
        for k in ("A11inv", "G", "A21", "blkinv"):
            a = np.asarray(ref["levels"][l][k])
            b = np.asarray(got["levels"][l][k])
            assert a.shape == b.shape, (l, k, a.shape, b.shape)
            if k == "blkinv":
                # padded block slots differ by construction (serial
                # stacking repeats block 0, distributed pads identity);
                # the apply reads neither — compare valid slots only
                valid = np.asarray(dc.fplans[l]["blk_mask"]).any(-1)
                a = a[valid]
                b = b[valid]
            scale = max(np.abs(a).max(), 1e-300)
            assert np.abs(a - b).max() / scale < 1e-11, \
                f"level {l} {k}: rel diff {np.abs(a - b).max() / scale}"
    for a, b in zip(jax.tree.leaves(ref["coarse"]),
                    jax.tree.leaves(got["coarse"])):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-300)
        assert np.abs(a - b).max() / scale < 1e-11


@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_dist_compute_apply_composes(ndev):
    """Halo apply with distributed factors == serial apply_inverse."""
    K, P = _build("Stokes-C", 32, 2, "Skew Cartesian")
    mesh = make_mesh(ndev)
    app = make_halo_apply(P, mesh)
    dc = DistributedCompute(P, mesh)
    app.factors = dc.compute(jnp.asarray(K.data, P.dtype))
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    x_serial = np.asarray(P.apply_inverse(b))
    x_halo = np.asarray(app(b))
    scale = max(np.abs(x_serial).max(), 1e-300)
    assert np.abs(x_serial - x_halo).max() / scale < 1e-11


def test_dist_compute_collectives():
    """The factor program's only all-gather is the (small) coarse
    assembly; the per-level Schur traffic is collective-permute, and
    nothing gathers an operator-scale (n_sd*ns^2) tensor."""
    K, P = _build("Laplace", 64, 2)
    mesh = make_mesh(8)
    dc = DistributedCompute(P, mesh)
    fn = jax.jit(lambda v: dc.compute(v))
    txt = fn.lower(jnp.asarray(K.data, P.dtype)).compile().as_text()
    ags = re.findall(r"= (\S+) all-gather\(", txt)
    assert len(ags) <= 1, f"{len(ags)} all-gathers in the factor program"
    for shape in ags:
        m = re.match(r"\w+\[([\d,]*)\]", shape)
        dims = [int(x) for x in m.group(1).split(",") if x]
        n_el = int(np.prod(dims)) if dims else 1
        # the coarse system is tiny relative to the operator
        assert n_el < K.nnz // 4, f"operator-scale all-gather {shape}"
    assert len(re.findall(r"collective-permute\(", txt)) >= 2
