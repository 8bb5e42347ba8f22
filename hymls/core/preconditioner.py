"""The multilevel preconditioner: device-side numerics + orchestration.

A device re-design of the reference's Preconditioner /
SchurPreconditioner / SchurComplement / MatrixBlock / CoarseSolver stack
(reference src/HYMLS_Preconditioner.cpp, HYMLS_SchurPreconditioner.cpp,
HYMLS_SchurComplement.cpp, HYMLS_MatrixBlock.cpp,
HYMLS_CoarseSolver.cpp):

  * `compute(vals)` — one jitted function mapping the matrix value
    array to all factorizations of all levels: batched dense interior
    inverses (replacing thousands of per-subdomain KLU factorizations),
    batched transformed Schur assembly via two matmuls per subdomain
    (replacing sparse Householder SpMM), segment-sum assembly
    (replacing FECrsMatrix::GlobalAssemble), batched non-Vsum block
    inverses (replacing Ifpack_DenseContainer), and a dense LU on the
    coarsest level (replacing Amesos/KLU).
  * `apply_inverse(b)` — one jitted function: gathers + batched matvecs
    + scatter per level, unrolled over the static level pyramid.

Everything is dtype-parametric; the subdomain axis of every batched
array is the natural sharding axis for multi-chip execution.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..config import Params
from ..grid import GridInfo, grid_from_params
from ..partition.cartesian import CartesianPartitioner, PartitionParams
from ..partition.skew import SkewCartesianPartitioner
from ..partition.hierarchical import build_hierarchy
from .plan import (LevelPlan, CoarsePlan, build_level_plan,
                   build_coarse_plan, csr_entry_ids, SMALL_ENTRY)
from ..parallel.mesh import shard_batch
from .permute import (want_sort_perm, perm_sort_plan, apply_sorted_perm,
                      want_scatter_perm, perm_scatter_plan,
                      apply_scatter_perm)


# ---------------------------------------------------------------------------
# small device helpers
# ---------------------------------------------------------------------------

def _plan_cache_dir() -> str:
    import os
    from ..utils.compile_cache import checkout_dir
    return os.environ.get("HYMLS_PLAN_CACHE",
                          os.path.join(checkout_dir(), ".plan_cache"))


def structured_budget(bytes_limit: float) -> float:
    """Element budget of the structured ('Structured Apply' = Auto)
    program on a device with `bytes_limit` bytes of memory.  The folded
    A21/G tensors are NCH x NCH_child (larger than NCH^2) and their
    construction plus XLA's einsum temps cost far more than the tensors
    themselves: on an H100 80GB HBM3 (700 W) the 32^3 skew L=2 program
    (estimated 2.1e8 elements) raised the set-up peak from 3.4 GB
    (generic path) to 57 GB, ~260 bytes per estimated element, and its
    Newton step ran 10x slower than the generic one (2.17 s vs 0.21 s).
    The model charges 256 bytes per estimated element and lets them fill
    half the device, which keeps that case generic on an 80 GB card;
    128^2 L=2 (3.4e6) stays structured."""
    return 0.5 * bytes_limit / 256


@functools.lru_cache(maxsize=1)
def _plan_builder_salt() -> bytes:
    """Hash of the plan-building sources: any code change invalidates
    cached plans automatically."""
    import hashlib
    import os
    h = hashlib.sha256(b"hymls-plan-cache-v1")
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("core/plan.py", "partition/cartesian.py",
                "partition/skew.py", "partition/hierarchical.py",
                "grid.py"):
        try:
            with open(os.path.join(base, rel), "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(rel.encode())
    return h.digest()


def _plan_cache_load(key):
    import os
    import pickle
    if key is None:
        return None
    path = os.path.join(_plan_cache_dir(), key + ".pkl")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, pickle.PickleError, EOFError, AttributeError,
            ImportError):
        return None


def _plan_cache_store(key, payload) -> None:
    import os
    import pickle
    import tempfile
    if key is None:
        return
    d = _plan_cache_dir()
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(d, key + ".pkl"))
    except (OSError, pickle.PickleError):
        pass


def _ext(v):
    """Append the 0.0 sentinel slot."""
    return jnp.concatenate([v, jnp.zeros((1,), dtype=v.dtype)])


def _pgather(dp, field, src_flat):
    """Static gather ``_ext(src_flat)[dp[field]]`` via the strategy
    chosen at plan-build time (core/permute.py): a plain gather by
    default; when ``dp[field + "_skeys"]`` holds sort keys, one
    lax.sort_key_val; when it carries ``_spos``/``_ckeys``, a compact
    source-sized sort + one unique-index scatter."""
    g = dp[field]
    sp = dp.get(field + "_spos")
    if sp is not None:
        m = int(np.prod(g.shape))
        return apply_scatter_perm(src_flat, dp[field + "_ckeys"],
                                  sp, m).reshape(g.shape)
    k = dp.get(field + "_skeys")
    if k is None:
        return _ext(src_flat)[g]
    m = int(np.prod(g.shape))
    return apply_sorted_perm(src_flat, k, m).reshape(g.shape)


from .dense import (inv_newton as _inv, warm_inv as _warm_inv,
                    dense_factor as _dense_factor,
                    dense_solve as _dense_solve)


def _bmm(A, x):
    """Batched matrix-vector: (s,m,n) @ (s,n) -> (s,m).  TRUE-dtype
    product: a reduced-precision pass (bf16 or TF32) rounds to 2^-8 or
    2^-11 and degrades the V-cycle as a preconditioner (see
    solvers/krylov.ortho); memory-bound on A either way."""
    return jnp.einsum("smn,sn->sm", A, x,
                      precision=jax.lax.Precision.HIGHEST)


def _drop_rel_diag(vals, rows, cols, diag_entry, tol=SMALL_ENTRY):
    """RelDropDiag dropping as value-zeroing (pattern stays static):
    keep off-diagonal iff |v| > tol*max(|d_i|,|d_j|) and |v| > tol;
    diagonal uses the absolute criterion (reference
    HYMLS_MatrixUtils.cpp:1011-1151)."""
    diag = jnp.abs(vals[diag_entry])
    scal = jnp.maximum(diag[rows], diag[cols])
    av = jnp.abs(vals)
    keep_off = (av > tol * scal) & (av > tol)
    keep = jnp.where(rows == cols, av > tol, keep_off)
    return jnp.where(keep, vals, jnp.zeros_like(vals))


def _apply_ot_pg(t, dp, enabled=True):
    """_apply_ot with sort-permutation gathers (used by the level apply
    where the maps carry _skeys; the halo/bordered paths keep the plain
    gather form)."""
    if not enabled:
        return -t
    w_vals = dp["w_vals"]
    gath = _pgather(dp, "w_pos", t)                      # (r, gmax)
    dots = jnp.sum(w_vals * gath, axis=1)
    return 2.0 * _pgather(dp, "ot_inv_idx", w_vals.reshape(-1)) * \
        _pgather(dp, "ot_row_of", dots) - t


def _apply_ot(t, dp, enabled=True):
    """y = (2 W^T W - I) t — the global per-group Householder transform;
    groups without a reflector row get -I (reference
    HYMLS_Householder.cpp:353-363 with missing rows).  Fully
    gather-form: each node belongs to at most one reflector row.
    enabled=False (Apply Orthogonal Transformation off) is identity."""
    if not enabled:
        return t
    w_vals, w_pos = dp["w_vals"], dp["w_pos"]
    t_ext = jnp.concatenate([t, jnp.zeros((1,), dtype=t.dtype)])
    dots = jnp.sum(w_vals * t_ext[w_pos], axis=1)
    dots_ext = jnp.concatenate([dots, jnp.zeros((1,), dtype=t.dtype)])
    w_flat_ext = jnp.concatenate(
        [w_vals.reshape(-1), jnp.zeros((1,), dtype=t.dtype)])
    return 2.0 * w_flat_ext[dp["ot_inv_idx"]] * \
        dots_ext[dp["ot_row_of"]] - t


# ---------------------------------------------------------------------------
# device plan containers (plain dicts of jnp arrays — pytree friendly)
# ---------------------------------------------------------------------------

_LEVEL_FIELDS_I32 = ("int_pos", "sd_sep_pos", "sep_pos_in_nodes",
                     "A11_idx", "A12_idx", "A21_idx", "A22_idx",
                     "w_pos", "sc22_src", "sc11_gather",
                     "blk_idx", "blk_pos", "vsum_pos", "next_idx",
                     "next_diag_entry", "next_rows", "next_cols",
                     "sep_from_sd", "ot_inv_idx", "ot_row_of",
                     "blk_inv_idx", "vsum_slot", "node_src")
_LEVEL_FIELDS_BOOL = ("int_mask", "sd_sep_mask", "blk_mask")
_LEVEL_FIELDS_F = ("Q", "w_vals")

#: the subset of plan arrays the apply (V-cycle) path reads — see
#: Preconditioner._build_device_plans
_APPLY_FIELDS = ("int_pos", "sd_sep_pos", "sep_pos_in_nodes",
                 "sep_from_sd", "blk_inv_idx", "blk_pos", "vsum_pos",
                 "vsum_slot", "node_src", "w_vals", "w_pos",
                 "ot_inv_idx", "ot_row_of")


_INT32_MAX = 2**31 - 1


def _plan_index_dtype(plan, fields) -> "jnp.dtype":
    """int32 normally; int64 when any flat gather index exceeds the
    int32 range (64-bit global indices, the role of the reference's
    HYMLS_LONG_LONG build option, HYMLS_config.h.in:42-46 — here a
    per-plan runtime promotion instead of a compile-time flag)."""
    for f in fields:
        a = np.asarray(getattr(plan, f))
        if a.size and int(a.max()) >= _INT32_MAX:
            return jnp.int64
    return jnp.int32


#: plan maps whose gathers read FACTOR-dtype values (_compute_level);
#: the remaining maps in the strategy table read apply-dtype vectors in
#: the V-cycle.  The split matters because the scatter strategy wins
#: only on 4-byte values (want_scatter_perm).
_FACTOR_MAPS = ("A11_idx", "A12_idx", "A21_idx", "A22_idx",
                "sc11_gather", "sc22_src", "blk_idx")


def _vsum_split_arrays(plan: LevelPlan):
    """Host-side derived maps for the vsum-restricted f64 assembly
    (_compute_level_split): per-subdomain Vsum column picks and the
    next-level gathers composed down to the compressed (s, nv, nv)
    Vsum blocks.  Returns None when any next-level entry reads a
    non-Vsum T slot (never observed; the reduced matrix is the
    Vsum-Vsum block by construction, reference
    HYMLS_SchurPreconditioner.cpp:520-629)."""
    sp_ = np.asarray(plan.sd_sep_pos)
    n_sd, ns = sp_.shape
    n_sep = plan.n_sep
    isv = np.zeros(n_sep + 1, bool)
    isv[np.asarray(plan.vsum_pos)] = True
    valid = (sp_ < n_sep) & isv[np.minimum(sp_, n_sep)]
    counts = valid.sum(axis=1)
    nv = max(int(counts.max()) if counts.size else 0, 1)
    vc = np.full((n_sd, nv), ns, np.int64)
    loc = np.full((n_sd, ns), nv, np.int64)
    for s in range(n_sd):
        cols = np.nonzero(valid[s])[0]
        vc[s, :cols.size] = cols
        loc[s, cols] = np.arange(cols.size)

    t_size = n_sd * ns * ns
    v_size = n_sd * nv * nv

    def compose(f):
        f = np.asarray(f, np.int64)
        sent = f >= t_size
        fc = np.where(sent, 0, f)
        s_i, rem = np.divmod(fc, ns * ns)
        i, j = np.divmod(rem, ns)
        a, b = loc[s_i, i], loc[s_i, j]
        if np.any(~sent & ((a >= nv) | (b >= nv))):
            return None
        return np.where(sent, v_size, s_i * (nv * nv) + a * nv + b)

    n22 = compose(np.asarray(plan.sc22_src)[plan.next_idx])
    n11 = compose(np.asarray(plan.sc11_gather)[plan.next_idx])
    if n22 is None or n11 is None:
        return None
    return {"vsum_col": vc, "nxt22_v": n22, "nxt11_v": n11}


#: maps that read the f32 side chain under the vsum-split assembly
#: (sc/blk values are f32 there; the block gathers stay f64)
_SPLIT_F32_MAPS = ("sc11_gather", "sc22_src", "blk_idx")


def _device_level(plan: LevelPlan, dtype,
                  idx_dtype=None, apply_dtype=None,
                  split_maps=False) -> Dict[str, jnp.ndarray]:
    # dtype conversion happens in NUMPY before the device transfer:
    # jnp.asarray(x, dtype=...) on a mismatched-dtype host array
    # compiles one convert_element_type XLA program PER SHAPE — ~70 s
    # of setup compiles on a 16^3 skew problem whose plan arrays span
    # dozens of shapes (measured; host-side np.astype is memcpy-speed)
    if idx_dtype is None:
        idx_dtype = _plan_index_dtype(plan, _LEVEL_FIELDS_I32)
    np_idx = np.dtype(idx_dtype)
    np_f = np.dtype(dtype)
    d: Dict[str, jnp.ndarray] = {}
    for f in _LEVEL_FIELDS_I32:
        d[f] = jnp.asarray(np.asarray(getattr(plan, f), dtype=np_idx))
    for f in _LEVEL_FIELDS_BOOL:
        d[f] = jnp.asarray(getattr(plan, f))
    for f in _LEVEL_FIELDS_F:
        d[f] = jnp.asarray(np.asarray(getattr(plan, f), dtype=np_f))
    # gather strategy per map (core/permute.py): the block-extraction
    # maps are injective (each matrix entry lands in exactly one block
    # slot), so they can also run as sort-permutations or compact
    # sort + scatter when HYMLS_PERM_STRATEGY asks for it.
    # Non-injective maps (e.g. A22 entries shared between subdomains)
    # keep the gather.
    t11_size = int(np.prod(np.asarray(plan.A22_idx).shape))
    n_sd, ni = plan.int_pos.shape
    src_of = {"A11_idx": plan.nnz, "A12_idx": plan.nnz,
              "A21_idx": plan.nnz, "A22_idx": plan.nnz,
              "sc11_gather": t11_size, "blk_idx": plan.nnz_sc,
              "sc22_src": t11_size,
              # apply-path maps (one per V-cycle per Krylov
              # iteration); non-injective maps (sd_sep_pos:
              # separators read by every touching subdomain) return
              # None and keep the gather
              "int_pos": plan.n_nodes,
              "sep_from_sd": int(np.prod(plan.sd_sep_pos.shape)),
              "sep_pos_in_nodes": plan.n_nodes,
              "blk_pos": plan.n_sep,
              "blk_inv_idx": int(np.prod(plan.blk_pos.shape)),
              "vsum_pos": plan.n_sep,
              "vsum_slot": int(plan.vsum_pos.size),
              "node_src": n_sd * ni + plan.n_sep,
              "sd_sep_pos": plan.n_sep,
              "w_pos": plan.n_sep,
              "ot_row_of": int(plan.w_pos.shape[0]),
              "ot_inv_idx": int(np.prod(plan.w_vals.shape))}
    # sort keys are pattern-derived and expensive at 3D sizes (argsort
    # over GB-scale maps on a 1-core host) — memoize them on the plan
    # object so the persistent plan cache carries them across processes
    kcache = getattr(plan, "_skeys_cache", None)
    if kcache is None:
        kcache = {}
        plan._skeys_cache = kcache
    if apply_dtype is None:
        apply_dtype = dtype
    if split_maps:
        vs = kcache.get("::vsum_split", "miss")
        if vs == "miss":
            vs = _vsum_split_arrays(plan)
            kcache["::vsum_split"] = vs
        if vs is not None:
            vi = np.dtype(idx_dtype) if idx_dtype is not None else (
                jnp.int64 if max(v.max(initial=0) for v in vs.values())
                >= _INT32_MAX else jnp.int32)
            for k, v in vs.items():
                d[k] = jnp.asarray(np.asarray(v, dtype=np.dtype(vi)))
    for f, src in src_of.items():
        g = np.asarray(getattr(plan, f))
        if not g.size:
            continue
        vdt = apply_dtype if (f not in _FACTOR_MAPS or (
            split_maps and "vsum_col" in d and f in _SPLIT_F32_MAPS)) \
            else dtype
        itemsize = np.dtype(vdt).itemsize
        nval = int(np.count_nonzero(g.ravel() < src))
        if want_scatter_perm(g.size, nval, src, itemsize):
            sk = f + ":scatter"
            if sk in kcache:
                cp = kcache[sk]
            else:
                cp = perm_scatter_plan(g, src)
                kcache[sk] = cp
            if cp is not None:
                d[f + "_ckeys"] = jnp.asarray(cp[0])
                d[f + "_spos"] = jnp.asarray(cp[1])
                continue
        if want_sort_perm(g.size, src):
            if f in kcache:
                k = kcache[f]
            else:
                k = perm_sort_plan(g, src)
                kcache[f] = k
            if k is not None:
                d[f + "_skeys"] = jnp.asarray(k)
    return d


# ---------------------------------------------------------------------------
# per-level numeric kernels
# ---------------------------------------------------------------------------

def _compute_level_split(vals, dp, sizes, apply_ot=True,
                         store_dtype=None, prev=None):
    """Factor one level with the VSUM-RESTRICTED f64 assembly
    ('Schur Assembly' = 'Vsum f64').

    f64 matmuls cost more than f32 ones (twice the bytes, and a lower
    rate outside the tensor cores).  But the f64 arithmetic protects
    exactly ONE consumer: the next-level matrix values, where the
    recursive Schur cancellation amplifies rounding across levels
    (skew-32^3 L=2 diverges with f32 assembly).  Everything else the
    factorization produces — A11inv/G/A21 for the V-cycle, the
    non-Vsum block inverses — is cast to f32 for the apply anyway and
    is measured insensitive to assembly precision (~3e-6, see
    solvers/mixed.py).

    So: run the FULL chain in f32 for the apply factors,
    and a small exact-in-f64 side chain restricted to the Vsum columns
    (nv ~ #groups per subdomain << ns) for the next-level values:

        Qv   = Q E_v                 (s, ns, nv)   one-hot column pick
        Z    = A11^{-1} (A12 Qv)     via X32 + one f64 refinement step
        T11v = -(Qv' A21) Z          (s, nv, nv)
        T22v =  Qv' A22 Qv           (s, nv, nv)
        nxt  = drop(T22v[nxt22_v] + sum T11v[nxt11_v])

    ~4x less f64 matmul work at identical next-level accuracy class
    (the one refinement step gives an (eps32*cond)^2 error bound on the
    restricted solve).  The reference has no such split
    (src/HYMLS_SchurPreconditioner.cpp:698-875 assembles in double);
    this is the equivalent of its 'all setup in double'."""
    dtype = vals.dtype                       # f64 (upcast chain)
    f32 = store_dtype

    # --- f64 block gathers (shared by both chains; cast once) -----------
    A11 = shard_batch(_pgather(dp, "A11_idx", vals))
    ni = A11.shape[-1]
    A11 = A11 + jnp.eye(ni, dtype=dtype)[None] * \
        (~dp["int_mask"])[:, :, None]
    A12 = shard_batch(_pgather(dp, "A12_idx", vals))
    A21 = shard_batch(_pgather(dp, "A21_idx", vals))
    A22 = shard_batch(_pgather(dp, "A22_idx", vals))

    # --- f32 chain: everything the apply consumes ------------------------
    # TRUE f32 products (precision=HIGHEST): reduced-precision passes
    # (bf16 or TF32) in the assembly are what destroy multilevel
    # quality (cavity128 inner iterations doubled with bf16-pass
    # products, while the identical true-f32 chain holds full
    # iteration parity).
    HI = jax.lax.Precision.HIGHEST

    def mm(a, b):
        return jnp.matmul(a, b, precision=HI)

    A11s, A12s, A21s, A22s = (x.astype(f32) for x in (A11, A12, A21, A22))
    if prev is not None:
        A11inv = _warm_inv(A11s, prev["A11inv"])
    else:
        A11inv = _inv(A11s)
    G = mm(A11inv, A12s)
    T11s = -mm(A21s, G)
    if apply_ot:
        Qs = dp["Q"].astype(f32)
        T22q = mm(mm(Qs, A22s), Qs)
        T11q = mm(mm(Qs, T11s), Qs)
    else:
        T22q, T11q = A22s, T11s

    sc = _pgather(dp, "sc22_src", T22q.reshape(-1))
    sc = sc + jnp.sum(_pgather(dp, "sc11_gather", T11q.reshape(-1)),
                      axis=1)

    B = _pgather(dp, "blk_idx", sc)
    mb = B.shape[-1]
    B = B + jnp.eye(mb, dtype=f32)[None] * (~dp["blk_mask"])[:, :, None]
    zero_rows = jnp.sum(jnp.abs(B), axis=-1) == 0
    B = B + jnp.eye(mb, dtype=f32)[None] * zero_rows[:, :, None]
    blkinv = _inv(B) if prev is None else _warm_inv(B, prev["blkinv"])

    # --- f64 vsum-restricted chain: the next-level values ----------------
    vc = dp["vsum_col"]                       # (s, nv), sentinel = ns
    ns = A22.shape[-1]
    Ev = (vc[:, None, :] == jnp.arange(ns, dtype=vc.dtype)[None, :, None]
          ).astype(dtype)                     # (s, ns, nv) one-hot
    Qv = (dp["Q"] @ Ev) if apply_ot else Ev
    Mv = A12 @ Qv                             # (s, ni, nv)
    X64 = A11inv.astype(dtype)
    Z0 = X64 @ Mv
    Z = Z0 + X64 @ (Mv - A11 @ Z0)            # one f64 refinement step
    W = A21 @ Z                               # (s, ns, nv)
    T11v = -jnp.einsum("sna,snb->sab", Qv, W)
    T22v = jnp.einsum("sna,snb->sab", Qv, A22 @ Qv)

    T22v_ext = _ext(T22v.reshape(-1))
    T11v_ext = _ext(T11v.reshape(-1))
    nxt = T22v_ext[dp["nxt22_v"]] + \
        jnp.sum(T11v_ext[dp["nxt11_v"]], axis=1)
    nxt = _drop_rel_diag(nxt, dp["next_rows"], dp["next_cols"],
                         dp["next_diag_entry"])

    factors = {"A11inv": A11inv, "G": G, "A21": A21s, "blkinv": blkinv,
               "sc": sc}
    return factors, nxt


def _compute_level(vals, dp, sizes, apply_ot=True, store_dtype=None,
                   prev=None):
    """Factor one level: returns (factors dict, next-level values).

    `prev` (warm recompute): the previous factor dict of this level (in
    apply dtype) — the dense inverses are then Newton-Schulz-polished
    from their previous values instead of re-factored (see
    dense.warm_inv), the SetMatrix-then-Compute fast path for
    Newton/continuation loops.

    `store_dtype` (factor-upcast mode): the VALUES chain (A11inv -> G ->
    T11 -> sc -> next level) runs in vals.dtype (f64) because Schur
    cancellation amplifies rounding catastrophically, but the non-Vsum
    block inverse feeds only the APPLY — and measured (V2 isolation on
    skew 32^3) an f32 inverse of accurately-assembled values is within
    3e-6 of f64, while inv_newton on an f64 input pays f64 LU plus up
    to 6 Newton matmul steps.  So blkinv is inverted directly in the
    store dtype.  When the plan carries the vsum-split maps ('Schur
    Assembly' = 'Vsum f64'), the f64 chain is restricted to the
    next-level entries instead — see _compute_level_split."""
    if store_dtype is not None and "vsum_col" in dp:
        return _compute_level_split(vals, dp, sizes, apply_ot=apply_ot,
                                    store_dtype=store_dtype, prev=prev)
    n_sep, nnz_sc = sizes
    dtype = vals.dtype

    A11 = shard_batch(_pgather(dp, "A11_idx", vals))
    ni = A11.shape[-1]
    A11 = A11 + jnp.eye(ni, dtype=dtype)[None] * \
        (~dp["int_mask"])[:, :, None]
    if prev is not None:
        A11inv = _warm_inv(A11, prev["A11inv"])
    else:
        A11inv = _inv(A11)

    A12 = shard_batch(_pgather(dp, "A12_idx", vals))
    A21 = shard_batch(_pgather(dp, "A21_idx", vals))
    A22 = shard_batch(_pgather(dp, "A22_idx", vals))

    # TRUE-dtype products: reduced-precision passes (bf16 or TF32) in
    # the recursive Schur assembly are what destroy multilevel quality
    # (a true-f32 chain holds iteration parity — see
    # _compute_level_split).  HIGHEST is a no-op for f64 and on CPU.
    HI = jax.lax.Precision.HIGHEST
    G = jnp.matmul(A11inv, A12, precision=HI)   # (s, ni, ns)
    T11 = -jnp.matmul(A21, G, precision=HI)     # (s, ns, ns)

    if apply_ot:
        Q = dp["Q"]
        # Q symmetric: Q A Q^T == Q A Q
        T22q = jnp.matmul(jnp.matmul(Q, A22, precision=HI), Q,
                          precision=HI)
        T11q = jnp.matmul(jnp.matmul(Q, T11, precision=HI), Q,
                          precision=HI)
    else:
        T22q, T11q = A22, T11

    sc = _pgather(dp, "sc22_src", T22q.reshape(-1))
    sc = sc + jnp.sum(_pgather(dp, "sc11_gather", T11q.reshape(-1)),
                      axis=1)

    B = _pgather(dp, "blk_idx", sc)
    mb = B.shape[-1]
    B = B + jnp.eye(mb, dtype=dtype)[None] * (~dp["blk_mask"])[:, :, None]
    # exactly-zero rows (variables whose transformed couplings all
    # vanish, e.g. pure-Darcy velocity separators) get identity rows:
    # the block solve passes their residual through instead of
    # producing NaNs
    zero_rows = jnp.sum(jnp.abs(B), axis=-1) == 0
    B = B + jnp.eye(mb, dtype=dtype)[None] * zero_rows[:, :, None]
    if store_dtype is not None:
        B = B.astype(store_dtype)
    blkinv = _inv(B) if prev is None else _warm_inv(B, prev["blkinv"])

    nxt = sc[dp["next_idx"]]
    nxt = _drop_rel_diag(nxt, dp["next_rows"], dp["next_cols"],
                         dp["next_diag_entry"])

    factors = {"A11inv": A11inv, "G": G, "A21": A21, "blkinv": blkinv,
               "sc": sc}
    return factors, nxt


def _apply_ot_multi(t, dp):
    """OT applied to the columns of (n_sep, m) — gather form."""
    w_vals, w_pos = dp["w_vals"], dp["w_pos"]
    m = t.shape[1]
    t_ext = jnp.concatenate([t, jnp.zeros((1, m), dtype=t.dtype)])
    gath = t_ext[w_pos]                      # (r, gmax, m)
    dots = jnp.sum(w_vals[:, :, None] * gath, axis=1)   # (r, m)
    dots_ext = jnp.concatenate([dots, jnp.zeros((1, m), dtype=t.dtype)])
    w_flat_ext = jnp.concatenate(
        [w_vals.reshape(-1), jnp.zeros((1,), dtype=t.dtype)])
    return 2.0 * w_flat_ext[dp["ot_inv_idx"]][:, None] * \
        dots_ext[dp["ot_row_of"]] - t


def _compute_level_border(fac, dp, sizes, V, W, C):
    """Border propagation through one level (reference
    Preconditioner::ComputeBorder + SchurPreconditioner::ComputeBorder):
      Q1 = A11^{-1} V1;  SchurV = V2 - A21 Q1;
      SchurW = W2 - (A11^{-1}A12)^T W1;  C' = C - W1^T Q1;
    then the Householder transform of SchurV/SchurW, whose Vsum part is
    the next level's border."""
    n_sep, _ = sizes
    dtype = V.dtype
    m = V.shape[1]
    Vx = jnp.concatenate([V, jnp.zeros((1, m), dtype=dtype)])
    Wx = jnp.concatenate([W, jnp.zeros((1, m), dtype=dtype)])

    V1 = Vx[dp["int_pos"]]                   # (s, ni, m)
    W1 = Wx[dp["int_pos"]]
    Q1 = jnp.matmul(fac["A11inv"], V1,
                    precision=jax.lax.Precision.HIGHEST)   # (s, ni, m)

    def gather_sep(contrib):
        flat = jnp.concatenate([contrib.reshape(-1, m),
                                jnp.zeros((1, m), dtype=dtype)])
        return jnp.sum(flat[dp["sep_from_sd"]], axis=1)

    sV = -jnp.matmul(fac["A21"], Q1,
                     precision=jax.lax.Precision.HIGHEST)  # (s, ns, m)
    schurV = gather_sep(sV) + V[dp["sep_pos_in_nodes"]]

    sW = -jnp.einsum("sij,sim->sjm", fac["G"], W1,
                     precision=jax.lax.Precision.HIGHEST)
    schurW = gather_sep(sW) + W[dp["sep_pos_in_nodes"]]

    Cp = C - jnp.einsum("sim,sik->mk", W1, Q1,
                        precision=jax.lax.Precision.HIGHEST)

    bV = _apply_ot_multi(schurV, dp)
    bW = _apply_ot_multi(schurW, dp)

    bfac = {"Q1": Q1, "W1": W1, "bW": bW}
    V_next = bV[dp["vsum_pos"]]
    W_next = bW[dp["vsum_pos"]]
    return bfac, V_next, W_next, Cp


def _coarse_factor_aug(vals, rows, cols, diag_entry, fix_rows, n, V, W, C,
                       store_dtype=None):
    """Bordered coarse factorization: dense LU of [A V; W' C]
    (reference CoarseSolver::Compute + AugmentedMatrix).
    `store_dtype`: see _coarse_factor."""
    dtype = vals.dtype
    vals = _drop_rel_diag(vals, rows, cols, diag_entry)
    m = V.shape[1]
    A = jnp.zeros((n, n), dtype=dtype).at[rows, cols].add(vals)
    if fix_rows.size:
        keep = jnp.ones(n, dtype=dtype).at[fix_rows].set(0.0)
        A = A * keep[:, None] * keep[None, :]
        A = A.at[fix_rows, fix_rows].set(1.0)
    top = jnp.concatenate([A, V], axis=1)
    bot = jnp.concatenate([W.T, C], axis=1)
    Aug = jnp.concatenate([top, bot], axis=0)
    if store_dtype is not None:
        Aug = Aug.astype(store_dtype)
    return _dense_factor(Aug)


def _apply_level_bordered(b, T, fac, bfac, dp, sizes, solve_next):
    """Bordered variant of _apply_level (reference
    Preconditioner::ApplyInverse(B,T,X,S) +
    SchurPreconditioner bordered ApplyInverse, lines 1517-1619).
    Returns (x, S)."""
    n_nodes, n_sep = sizes
    dtype = b.dtype
    b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=dtype)])

    b1 = b_ext[dp["int_pos"]]
    x1 = _bmm(fac["A11inv"], b1)

    y2c = _bmm(fac["A21"], x1)
    y2 = jnp.sum(_ext(y2c.reshape(-1))[dp["sep_from_sd"]], axis=1)
    b2 = b[dp["sep_pos_in_nodes"]]
    r2 = b2 - y2

    # border rhs: q = T - W1' x1
    q = T - jnp.einsum("sim,si->m", bfac["W1"], x1,
                       precision=jax.lax.Precision.HIGHEST)

    t = _apply_ot(r2, dp)

    t_ext = jnp.concatenate([t, jnp.zeros((1,), dtype=dtype)])
    tb = t_ext[dp["blk_pos"]]
    yb = _bmm(fac["blkinv"], tb)
    y = _ext(yb.reshape(-1))[dp["blk_inv_idx"]]

    # border correction with the non-Vsum part (Vsum entries of y are 0)
    Tc = q - jnp.matmul(bfac["bW"].T, y,
                        precision=jax.lax.Precision.HIGHEST)

    x_next, S = solve_next(t[dp["vsum_pos"]], Tc)
    x_next_ext = jnp.concatenate([x_next, jnp.zeros((1,), dtype=dtype)])
    n_vsum = dp["vsum_pos"].shape[0]
    y = jnp.where(dp["vsum_slot"] < n_vsum,
                  x_next_ext[dp["vsum_slot"]], y)
    x2 = _apply_ot(y, dp)

    x2_ext = jnp.concatenate([x2, jnp.zeros((1,), dtype=dtype)])
    x2sd = x2_ext[dp["sd_sep_pos"]]
    x1 = x1 - _bmm(fac["G"], x2sd)
    x1 = x1 - jnp.einsum("sim,m->si", bfac["Q1"], S,
                         precision=jax.lax.Precision.HIGHEST)

    src = jnp.concatenate([x1.reshape(-1), x2,
                           jnp.zeros((1,), dtype=dtype)])
    return src[dp["node_src"]], S


def _coarse_factor(vals, rows, cols, diag_entry, fix_rows, n,
                   store_dtype=None, prev=None):
    """Dense coarse factorization (reference CoarseSolver::Compute:
    RelFullDiag drop + PutDirichlet + direct LU).

    In factor-upcast mode the matrix is ASSEMBLED (and dropped) in f64
    but inverted in the store dtype: the V2 isolation showed the f32
    inverse of f64-assembled coarse values is within 3e-6 of f64, while
    an f64 coarse inverse pays f64 LU plus up to 6 Newton matmuls of the
    full n^2 system — the single most expensive piece of the f64 factor
    pipeline."""
    dtype = vals.dtype
    vals = _drop_rel_diag(vals, rows, cols, diag_entry)
    A = jnp.zeros((n, n), dtype=dtype).at[rows, cols].add(vals)
    if fix_rows.size:
        keep = jnp.ones(n, dtype=dtype).at[fix_rows].set(0.0)
        A = A * keep[:, None] * keep[None, :]
        A = A.at[fix_rows, fix_rows].set(1.0)
    if store_dtype is not None:
        A = A.astype(store_dtype)
    if prev is not None and "inv" in prev:
        return {"inv": _warm_inv(A, prev["inv"])}
    return _dense_factor(A)


def _apply_level(b, fac, dp, sizes, solve_next, apply_ot=True):
    """One level of the preconditioner application (block-diagonal
    variant; reference Preconditioner::ApplyInverse +
    SchurPreconditioner::ApplyInverse).  All data movement is
    gather-form (deterministic, no scatter atomics), through the
    per-map strategy of _pgather (core/permute.py)."""
    n_nodes, n_sep = sizes
    dtype = b.dtype

    b1 = _pgather(dp, "int_pos", b)              # (s, ni)
    x1 = _bmm(fac["A11inv"], b1)

    y2c = _bmm(fac["A21"], x1)                   # (s, ns)
    y2 = jnp.sum(_pgather(dp, "sep_from_sd", y2c.reshape(-1)), axis=1)

    b2 = _pgather(dp, "sep_pos_in_nodes", b)
    r2 = b2 - y2

    # --- Schur preconditioner -------------------------------------------
    t = _apply_ot_pg(r2, dp, apply_ot)

    tb = _pgather(dp, "blk_pos", t)
    yb = _bmm(fac["blkinv"], tb)
    y = _pgather(dp, "blk_inv_idx", yb.reshape(-1))

    b_next = _pgather(dp, "vsum_pos", t)
    x_next = solve_next(b_next)
    n_vsum = dp["vsum_pos"].shape[0]
    y = jnp.where(dp["vsum_slot"] < n_vsum,
                  _pgather(dp, "vsum_slot", x_next), y)

    x2 = _apply_ot_pg(y, dp, apply_ot)

    # --- back substitution -------------------------------------------------
    x2sd = _pgather(dp, "sd_sep_pos", x2)
    x1 = x1 - _bmm(fac["G"], x2sd)

    src = jnp.concatenate([x1.reshape(-1), x2])
    return _pgather(dp, "node_src", src)


# ---------------------------------------------------------------------------
# L == 0: direct solve of the full (untransformed) Schur complement
# ---------------------------------------------------------------------------

@dataclass
class DirectSCPlan:
    """Level plan variant when 'Number of Levels' == 0: eliminate
    interiors, assemble the full SC densely, direct-solve it
    (reference Preconditioner::Compute at myLevel_>=maxLevel_,
    HYMLS_Preconditioner.cpp:485-500)."""

    a22_idx: np.ndarray      # (m,) entries of K in sep x sep
    a22_rows: np.ndarray     # (m,) sep-local
    a22_cols: np.ndarray
    s11_rows: np.ndarray     # flat (sd, i, j) -> target (r, c)
    s11_cols: np.ndarray
    s11_src: np.ndarray
    fix_rows: np.ndarray


def _direct_sc_matrix(vals, dsc, T11, n_sep):
    """Assemble the dense (pinned) Schur complement for L == 0."""
    dtype = vals.dtype
    S = jnp.zeros((n_sep, n_sep), dtype=dtype)
    S = S.at[dsc["a22_rows"], dsc["a22_cols"]].add(vals[dsc["a22_idx"]])
    S = S.at[dsc["s11_rows"], dsc["s11_cols"]].add(
        T11.reshape(-1)[dsc["s11_src"]])
    fix_rows = dsc["fix_rows"]
    if fix_rows.size:
        keep = jnp.ones(n_sep, dtype=dtype).at[fix_rows].set(0.0)
        S = S * keep[:, None] * keep[None, :]
        S = S.at[fix_rows, fix_rows].set(1.0)
    return S


def _build_bgrid_t(grid: GridInfo) -> sp.csr_matrix:
    """T rows: u -> (u - v)/sqrt(2), v -> (v + u)/sqrt(2); identity on
    all other variables (reference HYMLS_Preconditioner.cpp:1082-1112)."""
    n = grid.num_nodes
    dof = grid.dof
    val = np.sqrt(0.5)
    gid = np.arange(n, dtype=np.int64)
    var = gid % dof
    rows = [gid]
    cols = [gid]
    vals = [np.where(var <= 1, val, 1.0)]
    mu = var == 0
    rows.append(gid[mu])
    cols.append(gid[mu] + 1)
    vals.append(np.full(mu.sum(), -val))
    mv = var == 1
    rows.append(gid[mv])
    cols.append(gid[mv] - 1)
    vals.append(np.full(mv.sum(), val))
    T = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    T.sort_indices()
    return T


# ---------------------------------------------------------------------------
# Preconditioner
# ---------------------------------------------------------------------------

class Preconditioner:
    """Multilevel F-matrix preconditioner with the same math as the
    reference HYMLS::Preconditioner, rebuilt for device execution."""

    def __init__(self, K: sp.csr_matrix, params: Params,
                 testvector: Optional[np.ndarray] = None,
                 dtype=jnp.float64, factor_dtype=None):
        self.params = params
        self.dtype = dtype
        # Factor (assembly) precision may exceed the apply precision:
        # 'Factor Precision' = 'f64' runs the factor pipeline in f64
        # and casts the resulting factors to the apply dtype — the
        # analogue of the reference doing all setup in double
        # (HYMLS_SchurPreconditioner.cpp AssembleTransformAndDrop).
        # NOTE: with every assembly product pinned to true f32
        # (precision=HIGHEST — a reduced-precision bf16 pass, whose
        # 2^-8 rounding is what historically made f32 assembly
        # 'cancel', is never used), the all-f32 chain holds iteration
        # parity with f64 assembly on every measured multilevel case
        # (tools/f32_quality_cpu.py), so 'Same' is the default and
        # 'f64' the opt-in.
        fprec = params.sublist("Preconditioner").get(
            "Factor Precision", "Same")
        if factor_dtype is None and fprec == "f64" and \
                np.dtype(dtype) == np.float32:
            factor_dtype = jnp.float64
        self.factor_dtype = factor_dtype if factor_dtype is not None \
            else dtype
        self._upcast = np.dtype(self.factor_dtype) != np.dtype(self.dtype)
        self.grid: GridInfo = grid_from_params(params)

        # B-grid transform: M = T' K T with T the 45-degree rotation of
        # each (u,v) velocity pair (reference Preconditioner::
        # TransformMatrix, HYMLS_Preconditioner.cpp:1072-1156); the
        # preconditioner is built on M, vectors are transformed around
        # the multilevel apply.
        self._bgrid_T = None
        if params.sublist("Preconditioner").get("B-Grid Transform", False):
            self._bgrid_T = _build_bgrid_t(self.grid)
            K = self._transform_bgrid(K)

        K = K.tocsr().copy()
        K.sum_duplicates()
        K.sort_indices()
        self.K = K
        n = K.shape[0]
        if n != self.grid.num_nodes:
            raise ValueError(
                f"matrix size {n} != grid size {self.grid.num_nodes}")

        prec = params.sublist("Preconditioner")
        self.max_level = prec.get("Number of Levels", 1)
        self.variant = prec.get("Preconditioner Variant", "Block Diagonal")
        self.partitioner_type = prec.get("Partitioner", "Cartesian")
        self.apply_dropping = prec.get("Apply Dropping", True)
        # 'Schur Assembly': under factor upcast, 'Vsum f64' restricts
        # the f64 matmul chain to the next-level (Vsum) entries
        # (_compute_level_split).  Default is 'Full f64': on the
        # cavity128 skew flagship the split REGRESSED both time (skew
        # subdomains have nv=13 of ns=17 —
        # the 'restricted' chain nearly duplicates the full one) and
        # quality (the non-Vsum block inverses also need f64-assembled
        # Schur values there: inner iterations doubled).  The option
        # stays for structures where nv << ns and the blocks are
        # benign (Cartesian L=2 held iteration parity in tests).
        self._split_assembly = self._upcast and prec.get(
            "Schur Assembly", "Full f64") == "Vsum f64"
        # 'Vsum f64 Levels': comma-separated level list (or 'all') the
        # split applies to — per-level placement, since profitability
        # (nv vs ns) and block-assembly sensitivity both vary by level
        lv = str(prec.get("Vsum f64 Levels", "all"))
        self._split_levels = None if lv.strip().lower() == "all" else {
            int(t) for t in lv.split(",") if t.strip()}

        fix_gids: List[int] = []
        pos = 1
        while f"Fix GID {pos}" in prec:
            fix_gids.append(prec[f"Fix GID {pos}"])
            pos += 1
        self.fix_gids = fix_gids

        if testvector is None:
            testvector = np.ones(n)
        self.testvector = np.asarray(testvector, dtype=np.float64)

        self._initialized = False
        self._factors = None
        self._vals0 = None
        self._border = None
        self._apply_bordered_jit = None
        self.initialize()

    def _transform_bgrid(self, K: sp.csr_matrix) -> sp.csr_matrix:
        T = self._bgrid_T
        M = (T.T @ K.tocsr() @ T).tocsr()
        M.sum_duplicates()
        M.sort_indices()
        # zero (keep pattern static) instead of removing tiny entries
        M.data[np.abs(M.data) <= SMALL_ENTRY] = 0.0
        return M

    # -- symbolic setup ----------------------------------------------------
    def initialize(self):
        """Partition every level and build the static plans (host).

        Plans depend only on the matrix PATTERN, the test vector and
        the grid/preconditioner configuration — never on the values —
        so they are persisted to a disk cache (HYMLS_PLAN_CACHE,
        default <checkout>/.plan_cache) keyed by those inputs plus a
        hash of the plan-builder sources.  The analogue of the
        reference's SetMatrix ordering reuse, extended across
        processes: at 32^3-skew sizes a cold plan build costs minutes
        of single-core host time; a warm load is sub-second."""
        g = self.grid
        part = PartitionParams.from_params(self.params, g, level=0)

        # index CSR of the level-0 matrix
        pattern = self.K.copy()
        pattern.data = np.arange(pattern.nnz, dtype=np.int64)

        nodes = np.arange(g.num_nodes, dtype=np.int64)
        tv = self.testvector.copy()

        self.plans: List[LevelPlan] = []
        self.hierarchies = []
        self.coarse_plan: Optional[CoarsePlan] = None
        self.direct_plan: Optional[DirectSCPlan] = None
        self._dsc_level = None
        self._level_parts: List[PartitionParams] = []
        self._structured = None
        self._sfactors = None

        if self.max_level == 0:
            self._init_direct_sc(part, pattern, nodes)
            return

        import time as _time
        key = self._plan_cache_key()
        cached = _plan_cache_load(key)
        if cached is not None:
            (self.plans, self.hierarchies, self.coarse_plan,
             self._level_parts) = cached
        else:
            _t_build = _time.perf_counter()
            for lev in range(self.max_level):
                if lev > 0:
                    # re-resolve per-level parameters (e.g. 'Retain
                    # Nodes at Level k', reference BasePartitioner::
                    # SetParameters) and keep the geometric
                    # separator-length evolution
                    nxt = part.next_level()
                    part = PartitionParams.from_params(self.params, g,
                                                       level=lev)
                    part.sx, part.sy, part.sz = nxt.sx, nxt.sy, nxt.sz
                    part.cx, part.cy, part.cz = nxt.cx, nxt.cy, nxt.cz
                cart = self._make_partitioner(part)
                self._level_parts.append(part)
                sds = [cart.get_groups(sd)
                       for sd in cart.valid_subdomain_ids()]
                hier = build_hierarchy(sds,
                                       active=None if lev == 0 else nodes)
                plan, tv = build_level_plan(
                    lev, hier, pattern, nodes, tv,
                    apply_dropping=self.apply_dropping,
                    variant=self.variant)
                self.plans.append(plan)
                self.hierarchies.append(hier)
                nodes = plan.next_nodes
                pattern = plan.next_pattern

            self.coarse_plan = build_coarse_plan(pattern, nodes,
                                                 self.fix_gids)
        self._build_device_plans()
        self._init_structured()
        if cached is None and _time.perf_counter() - _t_build > 5.0:
            # persist AFTER the device-plan build so the memoized sort
            # keys (plan._skeys_cache, when a sort strategy is on) ride
            # the cache too; only expensive builds are stored — the
            # test suite's many tiny configs would otherwise litter
            # the cache for no gain
            _plan_cache_store(key, (self.plans, self.hierarchies,
                                    self.coarse_plan,
                                    self._level_parts))
        self._initialized = True

    def _plan_cache_key(self) -> Optional[str]:
        """Content hash of everything the plan build reads; None
        disables caching (HYMLS_PLAN_CACHE='')."""
        import hashlib
        if not _plan_cache_dir():
            return None
        h = hashlib.sha256()
        h.update(_plan_builder_salt())
        K = self.K
        h.update(np.asarray(K.indptr).tobytes())
        h.update(np.asarray(K.indices).tobytes())
        h.update(self.testvector.tobytes())
        # exactly the inputs the plan build reads: per-level partition
        # parameters (NOT the whole sublist — Teuchos-style get()
        # inserts defaults, which would make the key run-order
        # dependent), grouping flags, and the grid
        parts = [repr(PartitionParams.from_params(self.params, self.grid,
                                                  level=lev))
                 for lev in range(self.max_level)]
        cfg = (repr(self.grid), self.max_level, self.variant,
               self.partitioner_type, self.apply_dropping,
               list(self.fix_gids), parts)
        h.update(repr(cfg).encode())
        return h.hexdigest()

    def _init_structured(self):
        """Try to compile the gather-free structured apply
        (core/structured.py); keep the generic gather path on any
        detection failure.  'Structured Apply' accepts True/False or
        "Auto" (the default): Auto skips the structured program when
        its repacked factor tensors would be very large relative to
        the backend (the fold/repack compile and memory cost outweighs
        the per-iteration win — seen on CPU test runs of 32^3 skew
        Stokes)."""
        self._structured = None
        self._sapply_jit = None
        self._repack_jit = None
        mode = self.params.sublist("Preconditioner").get(
            "Structured Apply", "Auto")
        if mode is False:
            self._structured_reason = "disabled by parameter"
            return
        from .structured import build_structured_program
        if mode == "Auto":
            # The budget is enforced INSIDE the builder, between
            # detection and the (expensive) constant construction —
            # building first and discarding costs minutes of host time
            # on large skew-3D problems.  Hosts without device memory
            # stats (the CPU) keep a fixed 5e7 elements.
            stats = jax.devices()[0].memory_stats()
            budget = structured_budget(stats["bytes_limit"]) \
                if stats and "bytes_limit" in stats else 5e7
        else:
            budget = None
        prog = build_structured_program(self, max_elements=budget)
        if prog is None:
            return
        self._structured = prog

        if self._bgrid_T is not None:
            # same wrapping as the generic path: the plans/groups are
            # built on the transformed operator M = T' K T, so any
            # apply is conjugated by the Givens pre-transform
            from ..ops.spmv import DiaOperator
            Top = DiaOperator(self._bgrid_T, dtype=self.dtype)
            TopT = DiaOperator(self._bgrid_T.T.tocsr(), dtype=self.dtype)

            def sapply(factors, consts, b):
                return Top(prog.apply(factors, TopT(b), consts))
        else:
            def sapply(factors, consts, b):
                return prog.apply(factors, b, consts)

        self._sapply_pure = sapply
        self._sapply_jit = jax.jit(sapply)
        self._repack_jit = jax.jit(
            lambda factors, consts: prog.repack(factors, consts))

    def _make_partitioner(self, part: PartitionParams):
        if self.partitioner_type == "Skew Cartesian":
            return SkewCartesianPartitioner(self.grid, part)
        return CartesianPartitioner(self.grid, part)

    def _init_direct_sc(self, part, pattern, nodes):
        """Plans for the fully-direct variant (Number of Levels == 0)."""
        g = self.grid
        cart = self._make_partitioner(part)
        sds = [cart.get_groups(sd) for sd in cart.valid_subdomain_ids()]
        hier = build_hierarchy(sds, active=None)
        # reuse the level-plan machinery for the elimination part
        plan, _tv = build_level_plan(0, hier, pattern, nodes,
                                     self.testvector.copy())
        self.plans = [plan]
        self.hierarchies = [hier]

        sep_sorted = np.unique(hier.all_separator_nodes())
        n_sep = sep_sorted.size
        # A22 global entries within sep x sep
        is_sep = np.zeros(g.num_nodes, dtype=bool)
        is_sep[sep_sorted] = True
        coo = self.K.tocoo()
        m = is_sep[coo.row] & is_sep[coo.col]
        order = np.argsort(self.K.indptr.searchsorted(0))  # noop
        # entry index in CSR order == position in data (canonical CSR)
        entry_ids = np.arange(self.K.nnz, dtype=np.int64)
        csr_rows = np.repeat(np.arange(g.num_nodes),
                             np.diff(self.K.indptr))
        csr_cols = self.K.indices
        msk = is_sep[csr_rows] & is_sep[csr_cols]
        a22_idx = entry_ids[msk]
        a22_rows = np.searchsorted(sep_sorted, csr_rows[msk])
        a22_cols = np.searchsorted(sep_sorted, csr_cols[msk])

        # S11 contributions: all (i,j) pairs of each subdomain's seps
        ns = plan.sd_sep_pos.shape[1]
        rows_l, cols_l, src_l = [], [], []
        for sd in range(hier.num_subdomains):
            locs = plan.sd_sep_pos[sd][plan.sd_sep_mask[sd]]
            mloc = locs.size
            if mloc == 0:
                continue
            rr = np.repeat(locs, mloc)
            cc = np.tile(locs, mloc)
            il = np.repeat(np.arange(mloc), mloc)
            jl = np.tile(np.arange(mloc), mloc)
            rows_l.append(rr)
            cols_l.append(cc)
            src_l.append((sd * ns + il) * ns + jl)
        s11_rows = np.concatenate(rows_l) if rows_l else np.empty(0, int)
        s11_cols = np.concatenate(cols_l) if cols_l else np.empty(0, int)
        s11_src = np.concatenate(src_l) if src_l else np.empty(0, int)

        fix_local = []
        for gid in self.fix_gids:
            p = np.searchsorted(sep_sorted, gid)
            if p < n_sep and sep_sorted[p] == gid:
                fix_local.append(p)

        self.direct_plan = DirectSCPlan(
            a22_idx=a22_idx, a22_rows=a22_rows, a22_cols=a22_cols,
            s11_rows=s11_rows, s11_cols=s11_cols, s11_src=s11_src,
            fix_rows=np.array(fix_local, dtype=np.int64))
        self._build_device_plans()
        self._initialized = True

    def _build_device_plans(self):
        # 'Use 64-bit Indices' forces int64 device plans (testable on
        # small grids); otherwise plans auto-promote per level when a
        # flat index exceeds the int32 range
        force64 = self.params.sublist("Preconditioner").get(
            "Use 64-bit Indices", False)
        idx = jnp.int64 if force64 else None
        self._dplans = [
            _device_level(p, self.factor_dtype, idx_dtype=idx,
                          apply_dtype=self.dtype,
                          split_maps=self._split_assembly and
                          (self._split_levels is None or
                           lev in self._split_levels))
            for lev, p in enumerate(self.plans)]
        # the apply path reads only a small subset of the plan arrays;
        # passing the full plans into a Krylov-loop program re-streams
        # every captured buffer each iteration (linear in bytes) — so
        # solve programs get this pruned pytree instead, INCLUDING the
        # per-map gather strategy arrays (_skeys/_spos/_ckeys: without
        # them a sort or scatter strategy silently falls back to the
        # gather).  Under
        # factor upcast the plan float fields (Householder reflectors)
        # live in factor dtype for the compute side and are down-cast
        # here for the apply.
        self._aplans_gen = []
        for d in self._dplans:
            a = {}
            for k in _APPLY_FIELDS:
                if k in d:
                    a[k] = d[k]
                    for suf in ("_skeys", "_spos", "_ckeys"):
                        if k + suf in d:
                            a[k + suf] = d[k + suf]
            if self._upcast and "w_vals" in a:
                a["w_vals"] = a["w_vals"].astype(self.dtype)
            self._aplans_gen.append(a)
        if self.coarse_plan is not None:
            cp = self.coarse_plan
            ci = idx or _plan_index_dtype(
                cp, ("rows", "cols", "diag_entry", "fix_rows"))
            self._dcoarse = {
                "rows": jnp.asarray(cp.rows, dtype=ci),
                "cols": jnp.asarray(cp.cols, dtype=ci),
                "diag_entry": jnp.asarray(cp.diag_entry, dtype=ci),
                "fix_rows": jnp.asarray(cp.fix_rows, dtype=ci),
            }
        if self.direct_plan is not None:
            dp = self.direct_plan
            di = idx or _plan_index_dtype(
                dp, ("a22_idx", "a22_rows", "a22_cols", "s11_rows",
                     "s11_cols", "s11_src", "fix_rows"))
            self._ddirect = {
                "a22_idx": jnp.asarray(dp.a22_idx, dtype=di),
                "a22_rows": jnp.asarray(dp.a22_rows, dtype=di),
                "a22_cols": jnp.asarray(dp.a22_cols, dtype=di),
                "s11_rows": jnp.asarray(dp.s11_rows, dtype=di),
                "s11_cols": jnp.asarray(dp.s11_cols, dtype=di),
                "s11_src": jnp.asarray(dp.s11_src, dtype=di),
                "fix_rows": jnp.asarray(dp.fix_rows, dtype=di),
            }
        self._make_jitted()

    def _wrap_compute(self, compute_fn):
        """Dtype-normalizing wrapper around a compute function: the
        factor pipeline runs in `factor_dtype` (f64 assembly avoids the
        catastrophic f32 Schur-cancellation measured on multilevel
        problems — see the constructor comment) and the returned factor
        pytree is cast to the apply dtype.  Always normalizes the input
        values dtype, so callers may pass f64 values regardless of the
        factor precision (the cast is free when dtypes coincide)."""
        upcast = self._upcast
        fdt = np.dtype(self.factor_dtype)
        adt = self.dtype

        def wrapped(vals, dplans, extra, border_vals=None):
            v = vals.astype(fdt)
            if border_vals is None:
                fac = compute_fn(v, dplans, extra)
            else:
                bv = tuple(b.astype(fdt) for b in border_vals)
                fac = compute_fn(v, dplans, extra, bv)
            if not upcast:
                return fac
            return jax.tree.map(
                lambda x: x.astype(adt) if x.dtype == fdt else x, fac)

        return wrapped

    def _wrap_recompute(self, recompute_fn):
        """Dtype-normalizing wrapper for the warm recompute path (see
        _wrap_compute); `prev` is the previous compute()/recompute()
        output in apply dtype.  Bordered problems use the cold path."""
        upcast = self._upcast
        fdt = np.dtype(self.factor_dtype)
        adt = self.dtype

        def wrapped(vals, dplans, extra, prev):
            fac = recompute_fn(vals.astype(fdt), dplans, extra, prev)
            if not upcast:
                return fac
            return jax.tree.map(
                lambda x: x.astype(adt) if x.dtype == fdt else x, fac)

        return wrapped

    # -- jitted numeric functions -------------------------------------------
    # NOTE: the plan index arrays are passed as jit ARGUMENTS (not
    # captured) so they become XLA parameters rather than giant inline
    # constants — capturing them makes compiles pathologically slow.
    def _make_jitted(self):
        plans = self.plans
        max_level = self.max_level
        # factor-upcast mode: assemble values in f64, invert the blocks
        # that feed only the APPLY (blkinv, coarse) directly in the
        # store dtype — their precision is irrelevant (V2 isolation),
        # and skipping their f64 Newton refinement saves the dominant
        # f64 matmul cost of the upcast factor pipeline
        store = self.dtype if self._upcast else None

        if max_level == 0:
            P = plans[0]
            n_sep = P.n_sep

            def _gather_sum_sep(dp, contrib):
                """Sum per-subdomain separator contributions into the
                global separator vector/matrix (the Export-with-Add of
                the reference)."""
                flat = contrib.reshape((-1,) + contrib.shape[2:])
                zero = jnp.zeros((1,) + flat.shape[1:], dtype=flat.dtype)
                flat = jnp.concatenate([flat, zero])
                return jnp.sum(flat[dp["sep_from_sd"]], axis=1)

            def compute_fn(vals, dplans, ddirect, border_vals=None,
                           prev=None):
                dp = dplans[0]
                A11 = _pgather(dp, "A11_idx", vals)
                ni = A11.shape[-1]
                A11 = A11 + jnp.eye(ni, dtype=vals.dtype)[None] * \
                    (~dp["int_mask"])[:, :, None]
                if prev is not None:
                    A11inv = _warm_inv(A11, prev["levels"][0]["A11inv"])
                else:
                    A11inv = _inv(A11)
                A12 = _pgather(dp, "A12_idx", vals)
                A21 = _pgather(dp, "A21_idx", vals)
                HI = jax.lax.Precision.HIGHEST
                G = jnp.matmul(A11inv, A12, precision=HI)
                T11 = -jnp.matmul(A21, G, precision=HI)
                S = _direct_sc_matrix(vals, ddirect, T11, n_sep)
                fac = {"levels": [{"A11inv": A11inv, "G": G, "A21": A21}]}
                if border_vals is None:
                    Ss = S if store is None else S.astype(store)
                    if prev is not None and "inv" in prev["coarse"]:
                        fac["coarse"] = {"inv": _warm_inv(
                            Ss, prev["coarse"]["inv"])}
                    else:
                        fac["coarse"] = _dense_factor(Ss)
                    return fac
                # bordered direct solve: eliminate the interiors from
                # [K V; W' C] and invert the dense augmented SC
                # (reference CoarseSolver::SetBorder + AugmentedMatrix,
                # HYMLS_CoarseSolver.cpp:200-224)
                V, W, C = border_vals
                m = V.shape[1]
                zrow = jnp.zeros((1, m), dtype=V.dtype)
                V1 = jnp.concatenate([V, zrow])[dp["int_pos"]]
                W1 = jnp.concatenate([W, zrow])[dp["int_pos"]]
                Q1 = jnp.matmul(A11inv, V1, precision=HI)
                SchurV = V[dp["sep_pos_in_nodes"]] - \
                    _gather_sum_sep(dp, jnp.matmul(A21, Q1, precision=HI))
                Q1w = jnp.matmul(jnp.swapaxes(A11inv, -1, -2), W1,
                                 precision=HI)
                SchurW = W[dp["sep_pos_in_nodes"]] - \
                    _gather_sum_sep(dp, jnp.matmul(
                        jnp.swapaxes(A12, -1, -2), Q1w, precision=HI))
                Cs = C - jnp.einsum("sim,sin->mn", W1, Q1,
                                    precision=HI)
                Maug = jnp.block([[S, SchurV],
                                  [SchurW.T, Cs]])
                fac["coarse"] = _dense_factor(
                    Maug if store is None else Maug.astype(store))
                fac["border"] = {"Q1": Q1, "W1": W1}
                return fac

            def apply_fn(factors, dplans, b):
                dp = dplans[0]
                fac = factors["levels"][0]
                dtype = b.dtype
                b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=dtype)])
                b1 = b_ext[dp["int_pos"]]
                x1 = _bmm(fac["A11inv"], b1)
                y2c = _bmm(fac["A21"], x1)
                y2 = jnp.sum(_ext(y2c.reshape(-1))[dp["sep_from_sd"]],
                             axis=1)
                b2 = b[dp["sep_pos_in_nodes"]]
                r2 = b2 - y2
                x2 = _dense_solve(factors["coarse"], r2)
                x2_ext = jnp.concatenate([x2, jnp.zeros((1,), dtype=dtype)])
                x1 = x1 - _bmm(fac["G"], x2_ext[dp["sd_sep_pos"]])
                src = jnp.concatenate([x1.reshape(-1), x2,
                                       jnp.zeros((1,), dtype=dtype)])
                return src[dp["node_src"]]

            def apply_bordered_fn(factors, dplans, b, t):
                """[x; s] = [K V; W' C]^{-1} [b; t] via the augmented
                dense SC (reference CoarseSolver bordered ApplyInverse,
                HYMLS_CoarseSolver.cpp:454-564)."""
                dp = dplans[0]
                fac = factors["levels"][0]
                bb = factors["border"]
                dtype = b.dtype
                b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=dtype)])
                b1 = b_ext[dp["int_pos"]]
                x1 = _bmm(fac["A11inv"], b1)
                y2c = _bmm(fac["A21"], x1)
                y2 = jnp.sum(_ext(y2c.reshape(-1))[dp["sep_from_sd"]],
                             axis=1)
                r2 = b[dp["sep_pos_in_nodes"]] - y2
                rt = t - jnp.einsum("sim,si->m", bb["W1"], x1,
                                    precision=jax.lax.Precision.HIGHEST)
                sol = _dense_solve(factors["coarse"],
                                   jnp.concatenate([r2, rt]))
                x2, s = sol[:n_sep], sol[n_sep:]
                x2_ext = jnp.concatenate([x2, jnp.zeros((1,), dtype=dtype)])
                x1 = x1 - _bmm(fac["G"], x2_ext[dp["sd_sep_pos"]]) \
                    - jnp.matmul(bb["Q1"], s,
                                 precision=jax.lax.Precision.HIGHEST)
                src = jnp.concatenate([x1.reshape(-1), x2,
                                       jnp.zeros((1,), dtype=dtype)])
                return src[dp["node_src"]], s

            bordered = self._border is not None
            self._compute_pure = self._wrap_compute(compute_fn)
            self._recompute_pure = self._wrap_recompute(
                lambda vals, dplans, extra, prev:
                compute_fn(vals, dplans, extra, prev=prev))
            self._apply_pure_gen = apply_fn
            self._apply_bordered_pure = apply_bordered_fn if bordered \
                else None
            self._compute_jit = jax.jit(self._compute_pure)
            self._recompute_jit = None
            self._apply_jit = jax.jit(self._apply_pure_gen)
            self._apply_bordered_jit = jax.jit(apply_bordered_fn) \
                if bordered else None
            self._extra_plan = self._ddirect
            return

        sizes = [(p.n_sep, p.nnz_sc) for p in plans]
        napply = [(p.n_nodes, p.n_sep) for p in plans]
        ots = [p.apply_ot for p in plans]
        cp = self.coarse_plan
        border = self._border
        dtype = self.dtype

        def compute_fn(vals, dplans, dcoarse, border_vals=None):
            facs = []
            v = vals
            for lev in range(max_level):
                f, v = _compute_level(v, dplans[lev], sizes[lev],
                                      apply_ot=ots[lev],
                                      store_dtype=store)
                facs.append(f)
            if border_vals is None:
                coarse = _coarse_factor(v, dcoarse["rows"], dcoarse["cols"],
                                        dcoarse["diag_entry"],
                                        dcoarse["fix_rows"], cp.n,
                                        store_dtype=store)
            else:
                V, W, C = border_vals
                for lev in range(max_level):
                    bfac, V, W, C = _compute_level_border(
                        facs[lev], dplans[lev], sizes[lev], V, W, C)
                    facs[lev]["border"] = bfac
                coarse = _coarse_factor_aug(
                    v, dcoarse["rows"], dcoarse["cols"],
                    dcoarse["diag_entry"], dcoarse["fix_rows"],
                    cp.n, V, W, C, store_dtype=store)
            return {"levels": facs, "coarse": coarse}

        def recompute_fn(vals, dplans, dcoarse, prev):
            """Value-only warm recompute: same factor pytree as
            compute_fn, with every dense inverse Newton-Schulz-polished
            from the previous step's factors (dense.warm_inv; falls
            back per-inverse when the seed doesn't contract)."""
            facs = []
            v = vals
            for lev in range(max_level):
                f, v = _compute_level(v, dplans[lev], sizes[lev],
                                      apply_ot=ots[lev],
                                      store_dtype=store,
                                      prev=prev["levels"][lev])
                facs.append(f)
            coarse = _coarse_factor(v, dcoarse["rows"], dcoarse["cols"],
                                    dcoarse["diag_entry"],
                                    dcoarse["fix_rows"], cp.n,
                                    store_dtype=store,
                                    prev=prev["coarse"])
            return {"levels": facs, "coarse": coarse}

        def apply_fn(factors, dplans, b):
            def solve_at(lev, rhs):
                if lev == max_level:
                    return _dense_solve(factors["coarse"], rhs)
                return _apply_level(
                    rhs, factors["levels"][lev], dplans[lev], napply[lev],
                    lambda r: solve_at(lev + 1, r), apply_ot=ots[lev])
            return solve_at(0, b)

        def apply_bordered_fn(factors, dplans, b, T):
            def solve_at(lev, rhs, Tc):
                if lev == max_level:
                    aug = jnp.concatenate([rhs, Tc])
                    sol = _dense_solve(factors["coarse"], aug)
                    return sol[:rhs.shape[0]], sol[rhs.shape[0]:]
                return _apply_level_bordered(
                    rhs, Tc, factors["levels"][lev],
                    factors["levels"][lev]["border"], dplans[lev],
                    napply[lev], lambda r, t: solve_at(lev + 1, r, t))
            return solve_at(0, b, T)

        if self._bgrid_T is not None:
            from ..ops.spmv import DiaOperator
            Top = DiaOperator(self._bgrid_T, dtype=self.dtype)
            TopT = DiaOperator(self._bgrid_T.T.tocsr(), dtype=self.dtype)
            base_apply = apply_fn

            def apply_fn(factors, dplans, b):       # noqa: F811
                return Top(base_apply(factors, dplans, TopT(b)))

        self._compute_pure = self._wrap_compute(compute_fn)
        self._recompute_pure = self._wrap_recompute(recompute_fn)
        self._apply_pure_gen = apply_fn
        self._apply_bordered_pure = apply_bordered_fn \
            if border is not None else None
        self._compute_jit = jax.jit(self._compute_pure)
        self._recompute_jit = None
        self._apply_jit = jax.jit(apply_fn)
        self._apply_bordered_jit = jax.jit(apply_bordered_fn) \
            if border is not None else None
        self._extra_plan = self._dcoarse

    # -- public API ----------------------------------------------------------
    def compute(self, K: Optional[sp.csr_matrix] = None):
        """Numeric factorization.  If K is given it must have the same
        pattern as the constructor matrix (reference
        Preconditioner::SetMatrix reuse semantics)."""
        from ..utils.timings import prof
        with prof("Preconditioner.compute", level=1):
            return self._compute(K)

    def _compute(self, K: Optional[sp.csr_matrix] = None):
        if K is not None:
            if self._bgrid_T is not None:
                K = self._transform_bgrid(K)
            K = K.tocsr()
            K.sum_duplicates()
            K.sort_indices()
            if K.nnz != self.K.nnz:
                raise ValueError("matrix pattern changed")
            self.K = K
        self._vals0 = jnp.asarray(self.K.data, dtype=self.factor_dtype)
        if self._border is not None:
            bv = tuple(jnp.asarray(a, dtype=self.factor_dtype)
                       for a in self._border)
            self._factors = self._compute_jit(self._vals0, self._dplans,
                                              self._extra_plan, bv)
        else:
            self._factors = self._compute_jit(self._vals0, self._dplans,
                                              self._extra_plan)
        if self._structured is not None:
            self._sfactors = self._repack_jit(
                self._prune_factors(self._factors),
                self._structured.consts)
        return self

    def recompute(self, K: Optional[sp.csr_matrix] = None):
        """Warm value-only refactorization: like compute(K) with the
        same-pattern requirement, but every dense inverse is
        Newton-Schulz-polished from the current factors instead of
        re-factored (dense.warm_inv; per-inverse residual-gated
        fallback to the cold factorization).  The fast path for
        Newton/continuation loops where successive matrices differ
        modestly — the device acceleration of the reference's
        SetMatrix-then-Compute reuse (src/HYMLS_Preconditioner.cpp
        Compute() re-run after SetMatrix).  Bordered preconditioners
        recompute cold."""
        if self._factors is None or self._border is not None:
            return self._compute(K)
        from ..utils.timings import prof
        with prof("Preconditioner.recompute", level=1):
            prev = self._factors
            if K is not None:
                if self._bgrid_T is not None:
                    K = self._transform_bgrid(K)
                K = K.tocsr()
                K.sum_duplicates()
                K.sort_indices()
                if K.nnz != self.K.nnz:
                    raise ValueError("matrix pattern changed")
                self.K = K
            self._vals0 = jnp.asarray(self.K.data,
                                      dtype=self.factor_dtype)
            if self._recompute_jit is None:
                self._recompute_jit = jax.jit(self._recompute_pure)
            self._factors = self._recompute_jit(
                self._vals0, self._dplans, self._extra_plan, prev)
            if self._structured is not None:
                self._sfactors = self._repack_jit(
                    self._prune_factors(self._factors),
                    self._structured.consts)
            return self

    def set_border(self, V, W=None, C=None):
        """Add a border [K V; W' C] to the whole hierarchy (reference
        Preconditioner::SetBorder; W=None means W:=V, C=None means 0).
        Border values are jit arguments, so updating them (e.g. in a
        continuation loop) does not retrace — only the first call and
        border-shape changes compile."""
        if V is None:
            self._border = None
            self._apply_bordered_jit = None
            self._factors = None
            self._make_jitted()
            return self
        V = np.asarray(V)
        if V.ndim == 1:
            V = V[:, None]
        W = V if W is None else np.asarray(W)
        if W.ndim == 1:
            W = W[:, None]
        m = V.shape[1]
        C = np.zeros((m, m)) if C is None else np.asarray(C)
        had_border = self._border is not None
        self._border = (V, W, C)
        self._factors = None
        if not had_border:
            self._make_jitted()
        return self

    def apply_inverse(self, b):
        """x = P^{-1} b for a single vector (device array or numpy).
        With a border set this solves with zero border rhs (reference
        BorderedOperator ApplyInverse convention)."""
        if self._factors is None:
            self.compute()
        b = jnp.asarray(b, self.dtype)
        if self._border is not None:
            T = jnp.zeros((self._border[0].shape[1],), dtype=self.dtype)
            x, _s = self._apply_bordered_jit(
                self._prune_factors(self._factors), self._aplans_gen, b, T)
            return x
        if self._structured_active:
            return self._sapply_jit(self._sfactors,
                                    self._structured.consts, b)
        return self._apply_jit(self._prune_factors(self._factors),
                               self._aplans_gen, b)

    def apply_inverse_bordered(self, b, t):
        """[x; s] = [P V; W' C]^{-1} [b; t]."""
        if self._factors is None:
            self.compute()
        return self._apply_bordered_jit(
            self._prune_factors(self._factors), self._aplans_gen,
            jnp.asarray(b, self.dtype), jnp.asarray(t, self.dtype))

    @property
    def factors(self):
        if self._factors is None:
            self.compute()
        return self._factors

    def describe(self) -> dict:
        """The path this preconditioner runs: partitioner, levels, apply
        program (structured or generic) and the dense-inverse shapes
        the factorization produces (batched blocks per level, then the
        coarse system as an explicit inverse or LU factors)."""
        def sig(a):
            return f"{a.dtype}{list(a.shape)}"

        fac = self.factors
        blocks = [{k: sig(f[k]) for k in ("A11inv", "blkinv") if k in f}
                  for f in fac["levels"]]
        co = fac.get("coarse") or {}
        kind = next((k for k in ("inv", "lu") if k in co), None)
        return {"partitioner": self.partitioner_type,
                "levels": self.max_level,
                "apply": ("structured" if self._structured_active
                          else "generic"),
                "structured_reason": getattr(self, "_structured_reason",
                                             None),
                "blocks": blocks,
                "coarse": f"{kind} {sig(co[kind])}" if kind else None}

    @staticmethod
    def _prune_factors(factors):
        """Apply-side view of the factor pytree (same device buffers,
        no copies): the V-cycle reads only A11inv/G/A21/blkinv per
        level plus the coarse inverse — the assembled SC values (used
        to build the next level during compute) are dead weight that
        a Krylov-loop program would otherwise re-stream every
        iteration."""
        keep = ("A11inv", "G", "A21", "blkinv", "border")
        out = {"levels": [{k: f[k] for k in keep if k in f}
                          for f in factors["levels"]],
               "coarse": factors["coarse"]}
        if "border" in factors:
            out["border"] = factors["border"]
        return out

    @property
    def _structured_active(self) -> bool:
        """The structured (gather-free) fast path is used for the plain
        apply; bordered applies and the explicit shard_map V-cycle keep
        the generic plan path."""
        return self._structured is not None and self._border is None

    @property
    def apply_factors(self):
        """Factor pytree for the apply path: structured (repacked) when
        the Cartesian fast path is active, else the pruned generic."""
        if self._factors is None:
            self.compute()
        if self._structured_active:
            return self._sfactors
        return self._prune_factors(self.factors)

    @property
    def _aplans(self):
        """Plan pytree matching `apply_factors` / the `_apply_pure`
        signature (structured consts or pruned generic plans)."""
        if self._structured_active:
            return self._structured.consts
        return self._aplans_gen

    def apply_factors_from(self, factors):
        """Apply-side factor pytree for an externally computed factor
        set (e.g. a re-factorization driven by the caller): repacked
        into the structured layout when the fast path is active."""
        pruned = self._prune_factors(factors)
        if self._structured_active:
            return self._repack_jit(pruned, self._structured.consts)
        return pruned

    def apply_factors_from_pure(self, factors, aplans):
        """Pure (jit-composable) variant of `apply_factors_from`:
        aplans must be this preconditioner's `_aplans` pytree passed
        through the caller's jit arguments."""
        pruned = self._prune_factors(factors)
        if self._structured_active:
            return self._structured.repack(pruned, aplans)
        return pruned

    @property
    def _apply_pure(self):
        return self._sapply_pure if self._structured_active \
            else self._apply_pure_gen

    def sharded_sapply_fn(self, mesh):
        """Pure GSPMD-distributed structured apply with the same
        (factors, consts, b) signature as `_sapply_pure`: the box-grid
        axis of each roll-mode level is sharded over `mesh` and the
        roll neighbor exchange partitions into collective-permutes
        (StructuredProgram.sharded_apply_fn).  This is how the
        production fast path runs multichip — the reference's one
        apply path is distributed unconditionally
        (src/HYMLS_Preconditioner.cpp:973-1052); here the same
        structured program is partitioned by XLA instead of switching
        to the generic gather V-cycle.  Returns None when no
        structured program exists."""
        if self._structured is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec
        prog = self._structured
        apply_sh = prog.sharded_apply_fn(mesh)
        # the OUTPUT is pinned replicated: the level bodies (all the
        # V-cycle flops + the roll collective-permutes) shard over the
        # mesh, while the surrounding Krylov iteration — dots, axpys,
        # the DIA matvec — keeps the exact replicated reduction order,
        # so iteration counts are bitwise identical to the single-chip
        # solve (the reference's 1..8-rank identical-convergence gate).
        # The exit gather is one small vector per apply, the same
        # volume as the reference's Export at the end of ApplyInverse
        # (src/HYMLS_Preconditioner.cpp:1050-1052).
        rep = NamedSharding(mesh, PartitionSpec())

        def _rep(x):
            return jax.lax.with_sharding_constraint(x, rep)

        if self._bgrid_T is not None:
            from ..ops.spmv import DiaOperator
            Top = DiaOperator(self._bgrid_T, dtype=self.dtype)
            TopT = DiaOperator(self._bgrid_T.T.tocsr(), dtype=self.dtype)

            def sapply(factors, consts, b):
                return _rep(Top(apply_sh(factors, _rep(TopT(_rep(b))),
                                         consts)))
            return sapply

        def sapply(factors, consts, b):
            return _rep(apply_sh(factors, _rep(b), consts))
        return sapply

    def dump_levels(self, prefix: str = "level") -> list:
        """Dump every level's operator to MatrixMarket files (the
        reference's HYMLS_STORE_MATRICES debug mode, which writes each
        reduced Schur matrix per level).  Returns the written paths."""
        import scipy.sparse as sp
        from ..utils.io import write_matrix

        if self.max_level < 1:
            write_matrix(f"{prefix}0.mtx", self.K)
            return [f"{prefix}0.mtx"]
        paths = []
        write_matrix(f"{prefix}0.mtx", self.K)
        paths.append(f"{prefix}0.mtx")
        from .preconditioner import _compute_level as _cl
        v = self._vals0 if self._vals0 is not None else \
            jnp.asarray(self.K.data, dtype=self.dtype)
        sizes = [(p.n_sep, p.nnz_sc) for p in self.plans]
        for lev in range(self.max_level):
            _f, v = _cl(v, self._dplans[lev], sizes[lev],
                        apply_ot=self.plans[lev].apply_ot)
            pat = self.plans[lev].next_pattern
            M = sp.csr_matrix((np.asarray(v), pat.indices, pat.indptr),
                              shape=pat.shape)
            path = f"{prefix}{lev + 1}.mtx"
            write_matrix(path, M)
            paths.append(path)
        return paths

    def apply_inverse_fn(self):
        """Returns (pure_fn, factors, device_plans): pure_fn(factors,
        dplans, b) -> x.  Plans are passed as arguments so callers can
        embed the apply inside their own jit without constant bloat."""
        if self._factors is None:
            self.compute()
        return self._apply_pure, self.apply_factors, self._aplans
