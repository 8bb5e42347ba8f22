"""DIA / ELL stencil SpMV against scipy's CSR product."""
import _cpu  # noqa: F401  (pin CPU backend before jax init)

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from hymls.ops.spmv import DiaOperator, EllOperator, make_operator
from hymls.stencils import laplace2d, laplace3d, stokes2d


def _banded_577():
    """n = 577 (not a multiple of any tile): bands reach past both ends,
    so the shifted slices read the zero padding."""
    n = 577
    offsets = [-25, -1, 0, 1, 25]
    rng = np.random.default_rng(1)
    return sp.diags([rng.standard_normal(n - abs(o)) for o in offsets],
                    offsets, shape=(n, n), format="csr")


MATRICES = {
    "laplace2d": lambda: laplace2d(24, 24),
    "stokes2d": lambda: stokes2d(16, 16),
    "laplace3d": lambda: laplace3d(8, 8, 8),
    "banded577": _banded_577,
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_matvec_prepared_matches_scipy(name, dtype):
    K = MATRICES[name]().tocsr()
    op = DiaOperator(K, dtype=dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(op.n)
    bands = op.prepare(op.vals)
    y = np.asarray(op.matvec_prepared(bands, jnp.asarray(x, dtype)),
                   np.float64)
    ref = K @ np.asarray(jnp.asarray(x, dtype), np.float64)
    tol = 1e-5 if dtype == jnp.float32 else 1e-13
    assert np.abs(y - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def test_make_operator_picks_dia_for_stencils_ell_otherwise():
    K = stokes2d(8, 8).tocsr()
    assert isinstance(make_operator(K), DiaOperator)
    rng = np.random.default_rng(2)
    R = sp.random(200, 200, density=0.3, random_state=3, format="csr")
    R = R + sp.eye(200)
    op = make_operator(R.tocsr())
    assert isinstance(op, EllOperator)
    x = rng.standard_normal(200)
    assert np.allclose(np.asarray(op(jnp.asarray(x))), R @ x, atol=1e-12)
