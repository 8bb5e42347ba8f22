"""Alternative strategies for applying static gather maps.

Every static index map of this package (factor-path block extraction,
skew perm-mode entry/exit, V-cycle maps) is applied as a plain XLA
gather ``x[idx]`` by default.  Two other strategies move the same
values and give bit-for-bit equal results:

* sort: a gather whose valid entries are *injective* is a permutation
  in disguise; with ``keys`` the inverse permutation,
  ``lax.sort_key_val(keys, x)`` yields ``x[perm]`` in its values slot.
* scatter: for sentinel-heavy maps, a compact source-sized sort of the
  valid entries plus one unique-index scatter into a zero output.

``HYMLS_PERM_STRATEGY`` = "sort" or "scatter" selects one of them at
plan-build time for every map that qualifies; the default ("auto")
keeps the gather, which was the fastest of the three on the GPU at the
factor-path and skew entry/exit maps of the 128^2 cavity step (see
PERF.md).  The reference implements the corresponding data movement
with Epetra_Import plans (reference
src/HYMLS_HierarchicalMap.cpp:144-285).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp


def _strategy() -> str:
    return os.environ.get("HYMLS_PERM_STRATEGY", "auto")


def want_sort_perm(m: int, src: int) -> bool:
    """Should the (m out of src) static map use the sort strategy?"""
    return _strategy() == "sort"


def perm_sort_plan(g, src_size: int) -> Optional[np.ndarray]:
    """Re-express the static gather out[i] = src_ext[g[i]] (where
    sentinel g[i] >= src_size reads an appended zero) as one sorted
    permutation.  Returns int32 keys of size P >= max(len(g), src_size)
    such that sort_key_val(keys, pad(x, P))[1][:len(g)] == out, or None
    when g is not injective on its valid entries (overlapping reads
    cannot be a permutation) or P would overflow int32."""
    g = np.asarray(g, np.int64).ravel()
    m = g.size
    valid = g < src_size
    used = g[valid]
    if np.unique(used).size != used.size:
        return None
    n_sent = m - used.size
    P = max(m, src_size + n_sent)
    if P >= 2**31:
        return None
    perm = np.empty(P, np.int64)
    zero_slots = np.arange(src_size, P)
    perm[np.nonzero(valid)[0]] = used
    perm[np.nonzero(~valid)[0]] = zero_slots[:n_sent]
    if P > m:
        unused_src = np.setdiff1d(np.arange(src_size), used)
        perm[m:] = np.concatenate([unused_src, zero_slots[n_sent:]])
    keys = np.empty(P, np.int64)
    keys[perm] = np.arange(P)
    return keys.astype(np.int32)


def apply_sorted_perm(x, keys, m):
    """Apply a perm_sort_plan: pad x to len(keys) with zeros (these
    positions are what sentinel outputs read), sort, take the first m."""
    pad = keys.shape[0] - x.shape[0]
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
    _, s = jax.lax.sort_key_val(keys, x)
    return s[:m]


def want_scatter_perm(m: int, nval: int, src: int, itemsize: int) -> bool:
    """Should the (m out of src, nval valid) static map use the
    compact-sort + scatter strategy?"""
    return _strategy() == "scatter"


def perm_scatter_plan(g, src_size: int):
    """Sentinel-heavy variant of perm_sort_plan: when most of g's slots
    are sentinels (g[i] >= src_size -> 0.0), the sort strategy still
    pays an O(len(g))-sized sort moving ~90% zeros.  Re-express the map
    as (compact sorted permutation at SOURCE size) + (static scatter of
    the valid slots): out = zeros(m).at[pos].set(x[g[pos]]).  Returns
    (ckeys, pos) — ckeys a perm_sort_plan over the valid entries only,
    pos the int32 positions of the valid slots — or None when g is not
    injective on its valid entries.  Profitable when the valid count is
    well under len(g) (plan-build picks the strategy per map)."""
    g = np.asarray(g, np.int64).ravel()
    valid = g < src_size
    pos = np.nonzero(valid)[0]
    used = g[pos]
    if np.unique(used).size != used.size or pos.size >= 2**31:
        return None
    ckeys = perm_sort_plan(used, src_size)
    if ckeys is None:
        return None
    return ckeys, pos.astype(np.int32)


def apply_scatter_perm(x, ckeys, pos, m):
    """Apply a perm_scatter_plan: compact sorted gather of the valid
    values, then one static unique-index scatter into a zero output."""
    vals = apply_sorted_perm(x, ckeys, pos.shape[0])
    return jnp.zeros((m,), x.dtype).at[pos].set(
        vals, mode="drop", unique_indices=True)
