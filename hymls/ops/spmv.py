"""Sparse matrix-vector products for structured stencil matrices.

Device replacement for Epetra_CrsMatrix::Multiply: the matrix is
converted once (host) to a fixed-width ELL layout — for stencil
operators the width is the stencil size (5/7/9), so the device op is a
dense gather + multiply + reduce over a tiny constant axis, which XLA
fuses into a single pass over HBM.  The value array is shared with the
CSR used by the preconditioner plans, so Newton-step value updates need
no re-indexing.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp


class EllOperator:
    """y = A @ x with A in padded row-major ELL form."""

    def __init__(self, A: sp.csr_matrix, dtype=jnp.float64):
        A = A.tocsr()
        A.sum_duplicates()
        A.sort_indices()
        n = A.shape[0]
        width = int(np.diff(A.indptr).max()) if A.nnz else 1
        cols = np.full((n, width), n, dtype=np.int64)
        vidx = np.full((n, width), A.nnz, dtype=np.int64)
        lens = np.diff(A.indptr)
        # vectorized fill
        rowrep = np.repeat(np.arange(n), lens)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
        cols[rowrep, offs] = A.indices
        vidx[rowrep, offs] = np.arange(A.nnz)

        self.n = n
        self.nnz = A.nnz
        self.width = width
        # host (numpy) constants, NOT device arrays: these are captured
        # in jit closures, and lowering a device-array constant reads it
        # back to the host and holds it in device memory twice
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vidx = np.asarray(vidx, dtype=np.int32)
        self.vals = jnp.asarray(A.data, dtype=dtype)
        self.dtype = dtype

    def set_values(self, vals):
        self.vals = jnp.asarray(vals, dtype=self.dtype)

    def prepare(self, vals):
        """Hoist the value gather out of iteration loops."""
        vals_ext = jnp.concatenate([vals, jnp.zeros((1,), dtype=vals.dtype)])
        return vals_ext[self.vidx]

    def matvec_prepared(self, pvals, x):
        x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        return jnp.sum(pvals * x_ext[self.cols], axis=1)

    def matvec_with(self, vals, x):
        """y = A(vals) @ x — pure function of (vals, x)."""
        return self.matvec_prepared(self.prepare(vals), x)

    def __call__(self, x):
        return self.matvec_with(self.vals, x)


class DiaOperator:
    """Offset-diagonal (DIA) SpMV for stencil matrices.

    For structured-grid operators the set of distinct column offsets
    (col - row) is tiny and static, so the matvec is a sum of
    elementwise products with statically shifted copies of x — no
    gather at all; XLA fuses the shifted-slice sum into one loop that
    reads each band once and x from cache.  Bands are stored as
    (n_offsets, n) with a gather map from the CSR value array so value
    updates need no re-indexing."""

    def __init__(self, A: sp.csr_matrix, dtype=jnp.float64):
        A = A.tocsr()
        A.sum_duplicates()
        A.sort_indices()
        n = A.shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        offs = A.indices.astype(np.int64) - rows
        uniq = np.unique(offs)
        self.offsets = uniq
        self.n = n
        self.nnz = A.nnz
        self.dtype = dtype
        # band k, row i stores A[i, i + offset_k]; vidx maps to CSR data
        off_of = np.searchsorted(uniq, offs)
        vidx = np.full((uniq.size, n), A.nnz, dtype=np.int64)
        vidx[off_of, rows] = np.arange(A.nnz)
        # host constant (see EllOperator.cols): jit-closure capture of a
        # device array forces a device->host readback at lowering
        self.vidx = np.asarray(vidx, dtype=np.int32)
        self.vals = jnp.asarray(A.data, dtype=dtype)
        self.pad = int(max(-uniq.min(initial=0), uniq.max(initial=0), 1))

    def set_values(self, vals):
        self.vals = jnp.asarray(vals, dtype=self.dtype)

    def prepare(self, vals):
        """Band extraction, hoisted out of iteration loops (a k x n
        gather per matvec otherwise costs more than the matvec)."""
        vals_ext = jnp.concatenate([vals, jnp.zeros((1,), dtype=vals.dtype)])
        return vals_ext[self.vidx]                   # (k, n)

    def matvec_prepared(self, bands, x):
        pad = self.pad
        x_pad = jnp.pad(x, (pad, pad))
        y = jnp.zeros_like(x)
        for k, off in enumerate(self.offsets.tolist()):
            y = y + bands[k, :self.n] * jax.lax.dynamic_slice(
                x_pad, (pad + off,), (self.n,))
        return y

    def matvec_with(self, vals, x):
        return self.matvec_prepared(self.prepare(vals), x)

    def __call__(self, x):
        return self.matvec_with(self.vals, x)


def make_operator(A: sp.csr_matrix, dtype=jnp.float64, max_bands: int = 48):
    """DIA for stencil-like matrices, ELL otherwise."""
    A = A.tocsr()
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    n_offsets = np.unique(A.indices.astype(np.int64) - rows).size
    if n_offsets <= max_bands:
        return DiaOperator(A, dtype=dtype)
    return EllOperator(A, dtype=dtype)
