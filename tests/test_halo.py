"""shard_map halo-exchange SpMV (the Epetra_Import halo role)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hymls.stencils import stokes2d, laplace2d
from hymls.ops.spmv import DiaOperator
from hymls.parallel.halo import dia_matvec_sharded


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs >1 device")
@pytest.mark.parametrize("mk", [lambda: laplace2d(64, 32),
                                lambda: stokes2d(32, 32)])
def test_halo_spmv_matches_dense(mk):
    K = mk()
    op = DiaOperator(K)
    mesh = Mesh(np.array(jax.devices()), ("sd",))
    f = jax.jit(dia_matvec_sharded(op, mesh))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(K.shape[0]))
    bands = op.prepare(op.vals)
    with mesh:
        y = f(bands, x)
    y_ref = K @ np.asarray(x)
    assert np.abs(np.asarray(y) - y_ref).max() < 1e-10
