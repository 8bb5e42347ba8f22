"""Native MatrixMarket reader vs scipy (the reference's IO layer is
native C++; here a ctypes-loaded C++ reader with scipy fallback)."""
import numpy as np
import scipy.io as sio
import scipy.sparse as sp
import pytest

from hymls.native import read_matrix_market, lib


@pytest.mark.skipif(lib() is None, reason="no C++ toolchain")
def test_native_reader_matches_scipy(tmp_path):
    rng = np.random.default_rng(0)
    A = sp.random(200, 200, density=0.05, random_state=1, format="coo")
    p = str(tmp_path / "m.mtx")
    sio.mmwrite(p, A)
    B = read_matrix_market(p)
    C = sio.mmread(p).tocsr()
    assert (B != C).nnz == 0

    v = rng.standard_normal(150)
    pv = str(tmp_path / "v.mtx")
    sio.mmwrite(pv, v.reshape(-1, 1))
    w = read_matrix_market(pv)
    assert np.allclose(np.asarray(w).ravel(), v)


@pytest.mark.skipif(lib() is None, reason="no C++ toolchain")
def test_native_reader_symmetric(tmp_path):
    A = sp.random(80, 80, density=0.1, random_state=2, format="coo")
    A = A + A.T
    p = str(tmp_path / "s.mtx")
    sio.mmwrite(p, A, symmetry="symmetric")
    B = read_matrix_market(p)
    C = sio.mmread(p).tocsr()
    assert abs(B - C).max() < 1e-14


def test_hdf5_roundtrip(tmp_path):
    """HDF5 dump/read parity (reference MatrixUtils::Dump HDF5 path)."""
    import scipy.sparse as sp
    from hymls.utils.io import write_hdf5, read_hdf5
    rng = np.random.default_rng(0)
    A = sp.random(20, 20, density=0.3, random_state=1, format="csr")
    v = rng.standard_normal(20)
    p = str(tmp_path / "dump.h5")
    write_hdf5(p, matrix=A, rhs=v)
    out = read_hdf5(p)
    assert (out["matrix"] != A).nnz == 0
    assert np.allclose(out["rhs"], v)


def test_native_planner_primitives():
    """Native plan-builder primitives agree with the numpy fallbacks."""
    from hymls.native import (lookup_sorted, invert_to_padded,
                                  locate_sorted, planner)
    if planner() is None:
        import pytest
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 10**6, 5000))
    q = rng.integers(0, 10**6, 20000)
    pos = np.searchsorted(keys, q)
    ok = (pos < keys.size) & (keys[np.minimum(pos, keys.size - 1)] == q)
    ref = np.where(ok, pos, -1)
    assert np.array_equal(lookup_sorted(keys, q, -1), ref)

    t = rng.integers(0, 300, 5000)
    s = np.arange(5000)
    out = invert_to_padded(t, s, 300, -9)
    for tgt in range(300):
        mine = out[tgt][out[tgt] != -9]
        want = s[t == tgt]
        assert np.array_equal(np.sort(mine), np.sort(want))

    gids = keys[rng.integers(0, keys.size, 1000)]
    assert np.array_equal(locate_sorted(keys, gids),
                          np.searchsorted(keys, gids))


def test_csr_hash_matches_searchsorted():
    """The native CSR hash (plan-builder hot path) agrees with the
    numpy searchsorted fallback, including padded out-of-range ids."""
    from hymls.core.plan import CsrLookup
    from hymls import native

    rng = np.random.default_rng(3)
    A = sp.random(2000, 2000, density=0.004, format="csr", random_state=7)
    lu = CsrLookup(A)
    if native.planner() is None:
        pytest.skip("no C++ toolchain")
    assert lu._hash is not None

    fill = A.shape[0]
    R = rng.integers(0, fill + 1, (30, 40))
    C = rng.integers(0, fill + 1, (30, 24))
    got = lu.query_block(R, C, row_limit=fill, col_limit=A.shape[1])

    # numpy reference (the fallback branch of query)
    q = R[:, :, None].astype(np.int64) * A.shape[1] + C[:, None, :]
    pos = np.searchsorted(lu.keys, q)
    ok = (pos < lu.keys.size) & \
        (lu.keys[np.minimum(pos, lu.keys.size - 1)] == q)
    ref = np.where(ok, pos, lu.nnz)
    assert np.array_equal(got, ref)

    # flat query path
    rows = rng.integers(0, fill, 9000)
    cols = rng.integers(0, fill, 9000)
    got_flat = lu.query(rows, cols)
    q = rows.astype(np.int64) * A.shape[1] + cols
    pos = np.searchsorted(lu.keys, q)
    ok = (pos < lu.keys.size) & \
        (lu.keys[np.minimum(pos, lu.keys.size - 1)] == q)
    assert np.array_equal(got_flat, np.where(ok, pos, lu.nnz))
