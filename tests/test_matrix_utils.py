"""MatrixUtils parity: the seven DropByValue modes + PutDirichlet
(reference src/HYMLS_MatrixUtils.hpp:51-65, HYMLS_CoarseSolver.cpp:141)."""
import numpy as np
import scipy.sparse as sp
import pytest

from hymls.utils.matrix import drop_by_value, put_dirichlet, DROP_MODES


def _A():
    # diag: [2, 1e-16, 3, 0(absent)]; small off-diags relative + absolute
    rows = [0, 0, 1, 1, 2, 2, 0, 2]
    cols = [0, 1, 1, 0, 2, 3, 3, 0]
    vals = [2.0, 1e-16, 1e-16, 0.5, 3.0, 1e-16, 1.0, 1e-10]
    return sp.csr_matrix((vals, (rows, cols)), shape=(4, 4))


def test_absolute_modes():
    A = _A()
    B = drop_by_value(A, 1e-12, "Absolute")
    d = B.todok()
    assert (0, 1) not in d and (1, 1) not in d
    assert d[0, 0] == 2.0 and d[2, 0] == pytest.approx(1e-10)

    B = drop_by_value(A, 1e-12, "AbsZeroDiag")
    assert B[1, 1] == 0.0 and (1, 1) in B.todok()

    B = drop_by_value(A, 1e-12, "AbsFullDiag")
    dok = B.todok()
    assert (3, 3) in dok and B[3, 3] == 0.0   # row 3 had no diagonal


def test_relative_modes():
    A = _A()
    # relative: |a20|=1e-10 <= tol*max(|a22|,|a00|)=1e-12*3 -> keep
    # (1e-10 > 3e-12); with tol=1e-9 -> dropped
    B = drop_by_value(A, 1e-9, "Relative")
    d = B.todok()
    assert (2, 0) not in d
    assert (1, 1) in d            # Relative never drops the diagonal

    B = drop_by_value(A, 1e-9, "RelDropDiag")
    assert (1, 1) not in B.todok()

    B = drop_by_value(A, 1e-9, "RelZeroDiag")
    d = B.todok()
    assert (1, 1) in d and B[1, 1] == 0.0

    B = drop_by_value(A, 1e-9, "RelFullDiag")
    d = B.todok()
    assert (3, 3) in d and B[3, 3] == 0.0


def test_unknown_mode():
    with pytest.raises(ValueError):
        drop_by_value(_A(), mode="Bogus")
    assert len(DROP_MODES) == 7


def test_put_dirichlet():
    rng = np.random.default_rng(0)
    A = sp.random(8, 8, density=0.4, random_state=0, format="csr")
    A = A + sp.eye(8)
    B = put_dirichlet(A, [2, 5], factor=1.0)
    Bd = B.toarray()
    for g in (2, 5):
        e = np.zeros(8); e[g] = 1.0
        assert np.array_equal(Bd[g], e)
        assert np.array_equal(Bd[:, g], e)
    # untouched block preserved
    keep = [i for i in range(8) if i not in (2, 5)]
    assert np.allclose(Bd[np.ix_(keep, keep)], A.toarray()[np.ix_(keep, keep)])


def test_drop_by_value_all_seven_modes():
    """Every DropType of the reference (src/HYMLS_MatrixUtils.hpp:51-65)
    against hand-computed expectations on one small matrix."""
    import numpy as np
    import scipy.sparse as sp
    from hymls.utils.matrix import drop_by_value

    # rows: 0 has big diag + tiny off; 1 has tiny diag + big off;
    # 2 has NO diag entry + mixed offs; tol = 0.1
    #     [ 2.0   0.05   0    ]
    #     [ 0.5   0.01   0    ]
    #     [ 0.05  0      0.5p ]   (row 2: a20=0.05, a21... use col 1)
    A = sp.csr_matrix(np.array([[2.0, 0.05, 0.0],
                                [0.5, 0.01, 0.0],
                                [0.05, 0.3, 0.0]]))
    tol = 0.1

    def entries(B):
        B = B.tocoo()
        return {(int(r), int(c)): float(v)
                for r, c, v in zip(B.row, B.col, B.data)}

    # Absolute: drop |aij| <= 0.1 everywhere (diag included)
    e = entries(drop_by_value(A, tol, "Absolute"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (2, 1): 0.3}

    # AbsZeroDiag: like Absolute but small diagonals become explicit 0
    e = entries(drop_by_value(A, tol, "AbsZeroDiag"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (1, 1): 0.0, (2, 1): 0.3}

    # AbsFullDiag: additionally every row gets an explicit diagonal
    e = entries(drop_by_value(A, tol, "AbsFullDiag"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (1, 1): 0.0, (2, 1): 0.3,
                 (2, 2): 0.0}

    # Relative: drop |aij| <= tol*max(|aii|,|ajj|); diagonal never
    # dropped.  a01: 0.05 <= 0.1*max(2.0, 0.01)=0.2 -> drop;
    # a10: 0.5 > 0.2 -> keep; a20: 0.05 <= 0.1*max(0, 2.0) -> drop;
    # a21: 0.3 > 0.1*max(0, 0.01) -> keep.
    e = entries(drop_by_value(A, tol, "Relative"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (1, 1): 0.01, (2, 1): 0.3}

    # RelDropDiag: Relative off-diagonals, absolute rule deletes a11
    e = entries(drop_by_value(A, tol, "RelDropDiag"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (2, 1): 0.3}

    # RelZeroDiag: a11 kept as explicit 0.0
    e = entries(drop_by_value(A, tol, "RelZeroDiag"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (1, 1): 0.0, (2, 1): 0.3}

    # RelFullDiag: plus the missing (2,2) diagonal as explicit 0.0
    e = entries(drop_by_value(A, tol, "RelFullDiag"))
    assert e == {(0, 0): 2.0, (1, 0): 0.5, (1, 1): 0.0, (2, 1): 0.3,
                 (2, 2): 0.0}
