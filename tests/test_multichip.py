"""Multi-chip sharding: the subdomain-axis mesh sharding must compile,
execute, and produce the same results as single-device execution
(run on the 8-virtual-device CPU mesh; the driver's dryrun_multichip
exercises the same path)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector
from hymls import Preconditioner, Solver
from hymls.parallel import make_mesh, set_mesh


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs >1 device")
def test_sharded_solve_matches_single_device():
    nx = 32   # 64 subdomains over the mesh
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 60,
                                        "Convergence Tolerance": 1e-8}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4, "Number of Levels": 1},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    rng = np.random.default_rng(1)
    x_ex = rng.standard_normal(K.shape[0])
    pm = (np.arange(K.shape[0]) % 3) == 2
    x_ex[pm] -= x_ex[pm].mean()
    b = K @ x_ex

    # single device
    P0 = Preconditioner(K, params, testvector=tv).compute()
    S0 = Solver(K, P0, params)
    x0, res0 = S0.apply_inverse(b)

    # sharded over the mesh
    mesh = make_mesh()
    set_mesh(mesh)
    try:
        with mesh:
            P1 = Preconditioner(K, params, testvector=tv).compute()
            S1 = Solver(K, P1, params)
            x1, res1 = S1.apply_inverse(b)
            jax.block_until_ready(x1)
    finally:
        set_mesh(None)

    assert int(res0.iters) == int(res1.iters)
    d = np.linalg.norm(np.asarray(x0) - np.asarray(x1)) / \
        np.linalg.norm(np.asarray(x0))
    # reduction order differs across shards; agreement to ~1e-10
    assert d < 1e-10, f"sharded result differs: {d}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_vcycle_matches_serial():
    """Explicit shard_map V-cycle (per-shard elimination + all_gather
    separator exchange) is bit-identical to the single-device apply."""
    import jax.numpy as jnp
    from hymls.parallel.mesh import make_mesh
    from hymls.parallel.vcycle import make_sharded_apply, shard_factors

    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 64, "ny": 64},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2},
    })
    K = create_matrix(params)
    P = Preconditioner(K, params,
                       testvector=create_testvector(params, K)).compute()
    mesh = make_mesh(8)
    apply_sh = make_sharded_apply(P, mesh)
    fac_sh, pl_sh = shard_factors(P, mesh)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    x_serial = np.asarray(P.apply_inverse(b))
    x_shard = np.asarray(apply_sh(fac_sh, pl_sh, b))
    assert np.abs(x_serial - x_shard).max() < 1e-12


def test_make_mesh_device_order():
    """make_mesh takes jax.devices() in order (the devices of one host
    are joined all to all, so no topology walk), truncated to the
    requested count, on one 'sd' axis."""
    import jax
    from hymls.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    assert mesh.axis_names == ("sd",)
    assert list(mesh.devices.ravel()) == jax.devices()[:4]
    assert make_mesh().size == len(jax.devices())
