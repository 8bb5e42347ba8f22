import numpy as np
import pytest
import scipy.sparse as sp

from hymls.stencils import (laplace2d, laplace3d, laplace2d_neumann,
                                darcy2d, darcy3d, stokes2d, stokes3d,
                                create_testvector, create_matrix)
from hymls.config import Params
from hymls.grid import X_PERIO, Y_PERIO


def test_laplace2d_interior_row():
    nx = 8
    A = laplace2d(nx, nx).toarray()
    # interior node (3,3)
    g = 3 + 3 * nx
    assert A[g, g] == -4
    for nb in (g - 1, g + 1, g - nx, g + nx):
        assert A[g, nb] == 1
    assert np.count_nonzero(A[g]) == 5
    # corner node: only 2 neighbors, diagonal unchanged (Dirichlet)
    assert A[0, 0] == -4
    assert np.count_nonzero(A[0]) == 3
    # symmetric
    assert (A != A.T).sum() == 0


def test_laplace2d_neumann_rowsums():
    A = laplace2d_neumann(6, 6)
    assert np.allclose(np.asarray(A.sum(axis=1)).ravel(), 0.0)


def test_laplace3d_interior_row():
    A = laplace3d(4, 4, 4)
    g = 1 + 4 * (1 + 4 * 1)
    row = A.getrow(g).toarray().ravel()
    assert row[g] == -6
    assert np.count_nonzero(row) == 7


def test_laplace2d_periodic():
    A = laplace2d(4, 4, X_PERIO | Y_PERIO).toarray()
    # every row is the full 5-point stencil now
    assert np.allclose(np.asarray(A.sum(axis=1)).ravel(), 0.0)
    assert A[0, 3] == 1  # x wrap


def test_darcy2d_structure():
    nx = 4
    A = darcy2d(nx, nx)
    dof = 3
    # u node in interior: diag a=1, grad p entries -(-1), ...
    g = (1 + 1 * nx) * dof + 0
    row = A.getrow(g).toarray().ravel()
    assert row[g] == 1.0
    assert row[(1 + 1 * nx) * dof + 2] == 1.0     # -b with b=-1
    assert row[(2 + 1 * nx) * dof + 2] == -1.0    # +b
    # p row is the negative transpose of the gradient coupling
    p = (1 + 1 * nx) * dof + 2
    prow = A.getrow(p).toarray().ravel()
    assert prow[(1 + 1 * nx) * dof + 0] == -1.0
    assert prow[(0 + 1 * nx) * dof + 0] == 1.0


def test_stokes2d_fmatrix_structure():
    """K = [A B; B' 0] with B'-block == minus transpose of B-block and
    zero pressure diagonal — the F-matrix property the whole method
    relies on (reference HYMLS_Tester.hpp:56-86)."""
    nx = 8
    K = stokes2d(nx, nx).tocsr()
    dof = 3
    n = K.shape[0]
    gid = np.arange(n)
    is_p = gid % dof == 2
    Kd = K.toarray()
    App = Kd[np.ix_(is_p, is_p)]
    assert np.all(App == 0)
    B = Kd[np.ix_(~is_p, is_p)]
    BT = Kd[np.ix_(is_p, ~is_p)]
    assert np.allclose(B.T, -BT)
    # velocity block symmetric
    Avv = Kd[np.ix_(~is_p, ~is_p)]
    assert np.allclose(Avv, Avv.T)
    # pressure rows have at most 4 entries (divergence of 2D C-grid)
    pcounts = np.diff(K.indptr)[is_p]
    assert pcounts.max() <= 4
    # constant pressure is in the nullspace of the gradient
    assert np.allclose(B.sum(axis=1), 0.0, atol=1e-12)


def test_stokes2d_divergence_consistency():
    """div rows: interior p couples to 4 velocities with +-b."""
    nx = 8
    K = stokes2d(nx, nx)
    dof = 3
    g = (3 + 3 * nx) * dof + 2
    row = K.getrow(g).toarray().ravel()
    nz = np.nonzero(row)[0]
    assert len(nz) == 4
    assert sorted(row[nz]) == [-1.0, -1.0, 1.0, 1.0]


def test_stokes3d_fmatrix_structure():
    nx = 4
    K = stokes3d(nx, nx, nx).tocsr()
    dof = 4
    n = K.shape[0]
    gid = np.arange(n)
    is_p = gid % dof == 3
    Kd = K.toarray()
    assert np.all(Kd[np.ix_(is_p, is_p)] == 0)
    B = Kd[np.ix_(~is_p, is_p)]
    BT = Kd[np.ix_(is_p, ~is_p)]
    assert np.allclose(B.T, -BT)


def test_testvector_zeroes_dirichlet_rows():
    params = Params({"Problem": {"Equations": "Stokes-C", "Dimension": 2,
                                 "nx": 8, "ny": 8}})
    K = create_matrix(params)
    tv = create_testvector(params, K)
    nx, dof = 8, 3
    # u on the right wall is a Dirichlet row -> tv == 0
    g = (7 + 3 * nx) * dof + 0
    assert tv[g] == 0.0
    # interior u
    g = (3 + 3 * nx) * dof + 0
    assert tv[g] == 1.0


def test_star3d():
    """27-point stencil (reference GaleriExt_Star3D.h: center a,
    faces b, edges c, corners d; Dirichlet by omission)."""
    from hymls.stencils import star3d
    A = star3d(4, 4, 4, 26.0, -1.0, -1.0, -1.0)
    i = 1 + 4 * 1 + 16 * 1
    row = A[i].toarray().ravel()
    assert (row != 0).sum() == 27
    assert abs(row.sum()) < 1e-14       # zero row sum in the interior
    assert (A[0].toarray() != 0).sum() == 8   # corner: 7 nbrs + center
    assert abs(A - A.T).max() == 0.0


def test_stokes_2d_lt_grid_rejected():
    """2D L/T grids are undefined — the reference's Darcy2D throws
    'Unknown grid type' for anything but C/B in 2D
    (src/GaleriExt_Darcy2D.h:315-320); match with a clear error."""
    import pytest
    from hymls.config import Params
    from hymls.stencils import create_matrix
    for gt in ("L", "T"):
        params = Params({"Problem": {"Equations": f"Stokes-{gt}",
                                     "Dimension": 2, "nx": 8, "ny": 8,
                                     "Degrees of Freedom": 3}})
        with pytest.raises(ValueError, match="grid type"):
            create_matrix(params)
