"""Runtime invariants on assembled operators (reference Tester)."""
import numpy as np
import scipy.sparse as sp

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector
from hymls import Preconditioner
from hymls.utils import testing as T


def _stokes(nx=16, partitioner="Skew Cartesian", levels=1):
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Preconditioner": {"Partitioner": partitioner,
                           "Separator Length": 4,
                           "Number of Levels": levels},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv).compute()
    return K, P


def test_stokes_is_fmatrix():
    K, P = _stokes()
    assert T.is_fmatrix(K, dof=3, pvar=2)


def test_dd_correct():
    K, P = _stokes()
    assert T.is_dd_correct(K, P.hierarchies[0])


def test_reduced_matrix_is_fmatrix():
    """The Vsum-reduced matrix must stay an F-matrix (the invariant
    HYMLS_TEST checks after ComputeNextLevel in the reference)."""
    K, P = _stokes(nx=16, levels=1)
    plan = P.plans[0]
    import jax.numpy as jnp
    # reconstruct the next-level CSR from the computed factors
    sc = np.asarray(P.factors["levels"][0]["sc"])
    vals = sc[plan.next_idx]
    n = plan.next_nodes.size
    A = sp.coo_matrix((vals, (plan.next_rows, plan.next_cols)),
                      shape=(n, n)).tocsr()
    dof_map = plan.next_nodes % 3
    # map local rows to variable types via the original gids
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    is_p_row = dof_map[rows] == 2
    is_p_col = dof_map[A.indices] == 2
    m = (~is_p_row) & is_p_col & (np.abs(A.data) > 1e-10)
    cnt = np.bincount(rows[m], minlength=n)
    s = np.bincount(rows[m], weights=A.data[m], minlength=n)
    assert cnt.max(initial=0) <= 2, "V-row couples to >2 pressures"
    assert np.abs(s).max(initial=0.0) < 1e-8, "grad row sums not zero"


def test_div_free_invariant():
    K, P = _stokes(nx=16, levels=1)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(K.shape[0])
    pm = (np.arange(K.shape[0]) % 3) == 2
    b[pm] = 0.0
    x = np.asarray(P.apply_inverse(b))
    assert T.is_div_free(K, x, dof=3, pvar=2, tol=1e-8)


def test_no_p_couplings_dropped():
    K, P = _stokes(nx=16, levels=1)
    assert T.no_p_couplings_dropped(None, P.plans[0], P.hierarchies[0],
                                    dof=3, pvar=2)
