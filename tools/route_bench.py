#!/usr/bin/env python
"""Times the alternative routes of the hot path on the device, at the
shapes of chip_smoke.py's phases, to decide between them.

  spmv    DiaOperator.matvec_prepared in f32 at phase B's (cavity 128^2)
          and phase C's (Stokes-C 32^3) n and band count: a chain of
          matvecs in one fori_loop, bytes/s against the
          (k+1)*n*4-byte read floor plus the n*4-byte write, and the
          top device ops of a traced run.
  perm    every static map of phase B's factor-path block extraction
          (level 0) and skew entry/exit applied as gather, sort and
          scatter; then the phase B Newton step under each
          HYMLS_PERM_STRATEGY (gather, sort, scatter, gather).
  coarse  dense_factor's explicit inverse against LU factors on phase
          A's coarse system: factor once, then one solve per Krylov
          iteration.
  dense   the batched inverse (inv_newton) at every block shape of
          phases A and B, plus any given with --shapes.

Usage:
    python tools/route_bench.py [spmv] [perm] [coarse] [dense]
        [--shapes f32:2112x17x17,f64:1024x47x47] [--trace-dir DIR]

Prints one JSON line per measurement; times are seconds on the host
clock, fenced with jax.block_until_ready.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402


def emit(bench, **fields):
    print(json.dumps({"bench": bench, **fields}), flush=True)


def call_time(fn, *args, reps=20):
    """Median host time of `reps` individually fenced calls of the
    jitted fn, after one compiling call."""
    jf = jax.jit(fn)
    jax.block_until_ready(jf(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def loop_time(body, init, n_iter=200):
    """Per-iteration time of lax.fori_loop(0, n_iter, body, init) in
    one dispatch, after a compiling call (median of 3)."""
    jf = jax.jit(lambda v: lax.fori_loop(0, n_iter, body, v))
    jax.block_until_ready(jf(init))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(init))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / n_iter, jf


def _phase_b_problem():
    from bench import _cavity128, _stokes_params
    K, b, _ = _cavity128()
    p = _stokes_params(128, 2, 3, "Skew Cartesian", maxiter=100, tol=1e-6)
    return K, b, p


def _phase_c_matrix():
    from bench import _stokes_params
    from hymls.stencils import create_matrix
    return create_matrix(_stokes_params(32, 3, 2, "Skew Cartesian"))


# ---------------------------------------------------------------------------

def bench_spmv(trace_dir=None, peak_gbps=3350.0):
    from hymls.ops.spmv import DiaOperator
    K_b, _, _ = _phase_b_problem()
    for name, K in (("B_cavity128", K_b), ("C_stokes32cube",
                                           _phase_c_matrix())):
        op = DiaOperator(K.tocsr(), dtype=jnp.float32)
        bands = op.prepare(op.vals)
        k, n = len(op.offsets), op.n
        scale = jnp.float32(1.0 / float(abs(K).sum(axis=1).max()))
        x0 = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                         jnp.float32)

        def body(i, y, bands=bands, op=op):
            return op.matvec_prepared(bands, y) * scale

        t, jf = loop_time(body, x0, n_iter=1000)
        floor = (k + 1) * n * 4 + n * 4
        row = {"case": name, "n": n, "bands": k,
               "floor_bytes": floor, "per_matvec_s": t,
               "achieved_gbps": floor / t / 1e9,
               "floor_time_s": floor / (peak_gbps * 1e9),
               "vs_floor": t / (floor / (peak_gbps * 1e9))}
        if trace_dir:
            from trace_ops import device_op_times
            d = os.path.join(trace_dir, f"spmv_{name}")
            jax.profiler.start_trace(d)
            jax.block_until_ready(jf(x0))
            jax.profiler.stop_trace()
            top = []
            for plane, agg in device_op_times(d).items():
                for (ln, op_name), (ns, cnt) in sorted(
                        agg.items(), key=lambda kv: -kv[1][0])[:6]:
                    top.append([plane, ln, op_name, ns / 1e9, cnt])
            row["trace_top_ops"] = top
        emit("spmv", **row)


# ---------------------------------------------------------------------------

def _strategy_fns(g, src_size, dtype):
    """{strategy: fn(x) -> out} for the static map out = ext(x)[g]."""
    from hymls.core.permute import (perm_sort_plan, apply_sorted_perm,
                                    perm_scatter_plan, apply_scatter_perm)
    g = np.asarray(g).ravel()
    m = g.size
    gd = jnp.asarray(g, jnp.int32)
    fns = {"gather": lambda x: jnp.concatenate(
        [x, jnp.zeros((1,), dtype)])[gd]}
    keys = perm_sort_plan(g, src_size)
    if keys is not None:
        kd = jnp.asarray(keys)
        fns["sort"] = lambda x: apply_sorted_perm(x, kd, m)
    sc = perm_scatter_plan(g, src_size)
    if sc is not None:
        ck, pos = jnp.asarray(sc[0]), jnp.asarray(sc[1])
        fns["scatter"] = lambda x: apply_scatter_perm(x, ck, pos, m)
    return fns


def bench_perm():
    from hymls.stencils import create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver
    K, b, p = _phase_b_problem()

    def build():
        S = IterativeRefinementSolver(K, p,
                                      testvector=create_testvector(p, K))
        S.compute()
        return S

    os.environ["HYMLS_PERM_STRATEGY"] = "gather"
    P = build().precond
    plan = P.plans[0]
    maps = []
    if plan is not None:
        t11 = int(np.prod(np.asarray(plan.A22_idx).shape))
        src_of = {"A11_idx": plan.nnz, "A12_idx": plan.nnz,
                  "A21_idx": plan.nnz, "A22_idx": plan.nnz,
                  "sc11_gather": t11, "sc22_src": t11,
                  "blk_idx": plan.nnz_sc}
        maps += [(f"factor.{f}", getattr(plan, f), src)
                 for f, src in src_of.items()]
    prog = P._structured
    if prog is not None and prog.levels and prog.levels[0].mode == "perm":
        L = prog.levels[0]
        maps.append(("skew.entry", L.entry, L.in_size))
        if L.exit is not None:
            maps.append(("skew.exit", L.exit,
                         L.nK * L.nJ * L.nI * L.NCH))
    for name, g, src in maps:
        row = {"map": name, "m": int(np.asarray(g).size), "src": int(src)}
        x = jnp.asarray(np.random.default_rng(1).standard_normal(src),
                        jnp.float32)
        for strat, f in _strategy_fns(g, src, jnp.float32).items():
            def body(i, acc, f=f):
                return acc + f(x + 1e-30 * i.astype(jnp.float32))
            t, _ = loop_time(body, jnp.zeros((row["m"],), jnp.float32),
                             n_iter=100)
            row[f"{strat}_s"] = t
        emit("perm_map", **row)

    for strat in ("gather", "sort", "scatter", "gather"):
        os.environ["HYMLS_PERM_STRATEGY"] = strat
        S = build()
        fn, dpl, ex, apl = S.newton_step_fn()
        args = (S.op64.vals, S.solver.op.vals, dpl, ex, apl,
                jnp.asarray(b, jnp.float64))
        step = fn.lower(*args).compile()
        jax.block_until_ready(step(*args))
        ts, iters = [], None
        for _ in range(5):
            t0 = time.perf_counter()
            r = jax.block_until_ready(step(*args))
            ts.append(time.perf_counter() - t0)
            iters = int(r.iters)
        n_sk = sum(1 for d in S.precond._dplans for f in d
                   if f.endswith(("_skeys", "_spos")))
        emit("perm_newton_step", strategy=strat, step_s=float(np.median(ts)),
             step_times_s=ts, inner_iters=iters, sort_or_scatter_maps=n_sk)
    os.environ.pop("HYMLS_PERM_STRATEGY")


# ---------------------------------------------------------------------------

def _phase_a_precond():
    from hymls import Preconditioner
    from hymls.config import load_xml
    from hymls.stencils import create_matrix, create_testvector
    p = load_xml(os.path.join(REPO, "configs", "cavity.xml"))
    K = create_matrix(p)
    P = Preconditioner(K, p, testvector=create_testvector(p, K),
                       dtype=jnp.float64)
    P.compute()
    return P


def bench_coarse(n=None, iters=250):
    from hymls.core import dense
    if n is None:
        co = _phase_a_precond().factors["coarse"]
        n = int((co["inv"] if "inv" in co else co["lu"]).shape[-1])
    rng = np.random.default_rng(3)
    A = jnp.asarray(rng.standard_normal((n, n)) + n ** 0.5 * np.eye(n))
    r = jnp.asarray(rng.standard_normal(n))
    fac_inv = jax.jit(lambda A: {"inv": dense.inv_newton(A)})
    fac_lu = jax.jit(lambda A: dict(zip(
        ("lu", "piv"), jax.scipy.linalg.lu_factor(A))))
    t_finv = call_time(fac_inv, A, reps=5)
    t_flu = call_time(fac_lu, A, reps=5)
    Fi, Fl = fac_inv(A), fac_lu(A)

    def solves(F):
        def body(i, y):
            return dense.dense_solve(F, y) * 1e-3 + r
        t, _ = loop_time(body, r, n_iter=iters)
        return t

    t_sinv, t_slu = solves(Fi), solves(Fl)
    emit("coarse", n=n, dtype="float64", iters=iters,
         inv_factor_s=t_finv, lu_factor_s=t_flu,
         inv_solve_s=t_sinv, lu_solve_s=t_slu,
         inv_total_s=t_finv + iters * t_sinv,
         lu_total_s=t_flu + iters * t_slu,
         lu_threshold=dense._LU_THRESHOLD)


# ---------------------------------------------------------------------------

_DTYPES = {"f32": "float32", "f64": "float64"}


def _parse_shapes(spec):
    """'f32:2112x17x17,f64:1024x47x47' -> [(dtype name, shape), ...]"""
    out = []
    for item in filter(None, (spec or "").split(",")):
        dt, dims = item.split(":")
        out.append((_DTYPES.get(dt, dt),
                    tuple(int(d) for d in dims.split("x"))))
    return out


def block_shapes():
    """(dtype, shape) of every dense inverse phases A and B produce."""
    from hymls.stencils import create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver
    K, _, p = _phase_b_problem()
    descs = [_phase_a_precond().describe(),
             IterativeRefinementSolver(
                 K, p, testvector=create_testvector(p, K)
             ).compute().precond.describe()]
    shapes = []
    for d in descs:
        sigs = [s for lev in d["blocks"] for s in lev.values()]
        if d["coarse"] and d["coarse"].startswith("inv"):
            sigs.append(d["coarse"].split(" ", 1)[1])
        for sig in sigs:
            dt, dims = sig.split("[")
            shapes.append((dt, tuple(json.loads("[" + dims))))
    return shapes


def random_blocks(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    A = rng.standard_normal(shape) + n * np.eye(n)
    return jnp.asarray(A, dtype)


def bench_dense(extra_shapes=()):
    from hymls.core.dense import inv_newton
    for dt, shape in list(dict.fromkeys(block_shapes()
                                        + list(extra_shapes))):
        if shape[-1] <= 1:
            continue
        A = random_blocks(dt, shape)
        emit("dense", dtype=dt, shape=list(shape),
             native_s=call_time(inv_newton, A))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="*",
                    default=["spmv", "perm", "coarse", "dense"])
    ap.add_argument("--shapes", default="")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from hymls.utils import compile_cache
    compile_cache.enable()
    d = jax.devices()[0]
    emit("device", platform=d.platform, kind=d.device_kind,
         count=len(jax.devices()))
    if "spmv" in args.what:
        bench_spmv(args.trace_dir)
    if "perm" in args.what:
        bench_perm()
    if "coarse" in args.what:
        bench_coarse()
    if "dense" in args.what:
        bench_dense(_parse_shapes(args.shapes))


if __name__ == "__main__":
    main()
