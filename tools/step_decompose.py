#!/usr/bin/env python
"""Decompose the fused Newton step on the device: factor-only vs
IR-solve-only vs full step, plus an inner-basis-size sweep.

It answers, with device-delta timings (fori_loop niter=1 vs niter=R+1,
cancelling the fixed per-dispatch cost):

  * where does the step time go (factor | solve)?
  * how do step time and total inner iterations move with the inner
    GMRES basis size?

Usage: python tools/step_decompose.py [case] [reps]
  case in {cavity128, stokes128, cavity64}; default stokes128.
"""
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

T0 = time.time()


def log(msg):
    print(f"[decomp +{time.time() - T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def build_case(name):
    from bench import _stokes_params, _cavity128, _cavity64
    if name == "stokes128":
        from hymls.stencils import create_matrix
        p = _stokes_params(128, 2, 2, "Cartesian")
        K = create_matrix(p)
        rng = np.random.default_rng(1)
        b = K @ rng.standard_normal(K.shape[0])
    elif name == "cavity128":
        K, b, _ = _cavity128()
        p = _stokes_params(128, 2, 3, "Skew Cartesian", maxiter=100,
                           tol=1e-6)
    elif name == "cavity64":
        K, b, _ = _cavity64()
        p = _stokes_params(64, 2, 1, "Cartesian")
    elif name == "stokes32cube":
        from hymls.stencils import create_matrix
        p = _stokes_params(32, 3, 2, "Skew Cartesian",
                           maxiter=500, tol=1e-8)
        p.sublist("Solver").sublist("Iterative Solver")["Num Blocks"] = 60
        K = create_matrix(p)
        rng = np.random.default_rng(2)
        b = K @ rng.standard_normal(K.shape[0])
    else:
        raise SystemExit(f"unknown case {name}")
    return p, K, b


def delta_time(fjit, reps, *args):
    """fjit(niter, *args) fori-looped; returns seconds/step."""
    jax.block_until_ready(fjit(1, *args))
    t = {}
    for nit in (1, reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(fjit(nit, *args))
        t[nit] = time.perf_counter() - t0
    return max((t[reps + 1] - t[1]) / reps, 1e-9)


def main():
    from hymls.utils import compile_cache
    compile_cache.enable()
    case = sys.argv[1] if len(sys.argv) > 1 else "stokes128"
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sweep_arg = [int(s) for s in sys.argv[3].split(",")] \
        if len(sys.argv) > 3 else None
    skip_factor = os.environ.get("DECOMP_SKIP_FACTOR", "") == "1"
    skip_newton = os.environ.get("DECOMP_SKIP_NEWTON", "") == "1"
    itol = float(os.environ.get("DECOMP_INNER_TOL", "0") or 0)
    p, K, b = build_case(case)
    from hymls.stencils import create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver

    # config overrides for precision experiments
    for env, key in (("DECOMP_FACTOR_PRECISION", "Factor Precision"),
                     ("DECOMP_SCHUR_ASSEMBLY", "Schur Assembly"),
                     ("DECOMP_VSUM_LEVELS", "Vsum f64 Levels"),
                     ("DECOMP_STRUCTURED", "Structured Apply")):
        v = os.environ.get(env)
        if v:
            if v in ("0", "False", "false"):
                v = False
            elif v in ("1", "True", "true"):
                v = True
            p.sublist("Preconditioner")[key] = v
            log(f"override {key} = {v}")

    tv = create_testvector(p, K)
    S = IterativeRefinementSolver(K, p, testvector=tv)
    log(f"case {case}: n={K.shape[0]}, computing factors ...")
    S.compute()
    P = S.precond
    vals64 = S.op64.vals
    vals32 = S.solver.op.vals
    bj = jnp.asarray(b, jnp.float64)
    dplans, extra, aplans = P._dplans, P._extra_plan, P._aplans
    compute = P._compute_pure

    out = {"case": case, "n": int(K.shape[0])}

    # ---- factor-only -------------------------------------------------
    def factor_steps(niter, s0, afac0):
        def fbody(i, carry):
            s64 = s0 + 1e-6 * i.astype(jnp.float64)
            factors = compute(vals64 * s64, dplans, extra)
            return P.apply_factors_from_pure(factors, aplans)
        return lax.fori_loop(0, niter, fbody, afac0)

    afac0 = P.apply_factors_from_pure(
        compute(vals64, dplans, extra), aplans)
    if not skip_factor:
        fjit = jax.jit(factor_steps)
        t_factor = delta_time(fjit, reps, jnp.float64(1.0), afac0)
        out["factor_s"] = round(t_factor, 5)
        log(f"factor-only: {t_factor:.4f} s/step")

    # ---- full newton + solve-only per inner basis size ---------------
    sweep = sweep_arg or {"cavity64": [16, 32, 48, 64],
                          }.get(case, [48, 64, 96, 128, 192])
    out["sweep"] = []
    for m in sweep:
        S.inner_maxiter = m
        if itol:
            S.inner_tol = itol
        S._fused_jit = None
        S._build_fused()
        fused = S._fused_fn
        if not skip_newton:
            newton_fn, *_ = S.newton_step_fn()

        def solve_steps(niter, afac):
            def fbody(i, carry):
                bb = bj * (1.0 + 1e-9 * i.astype(jnp.float64))
                r = fused(vals64, vals32, afac, aplans, bb)
                return r.x, jnp.asarray(r.iters, jnp.int64), r.relres
            return lax.fori_loop(
                0, niter, fbody,
                (jnp.zeros_like(bj), jnp.zeros((), jnp.int64),
                 jnp.float64(0)))

        def newton_steps(niter, s0):
            def fbody(i, carry):
                s64 = s0 + 1e-6 * i.astype(jnp.float64)
                r = newton_fn(vals64 * s64,
                              vals32 * s64.astype(jnp.float32),
                              dplans, extra, aplans, bj)
                return r.x, jnp.asarray(r.iters, jnp.int64), r.relres
            return lax.fori_loop(
                0, niter, fbody,
                (jnp.zeros_like(bj), jnp.zeros((), jnp.int64),
                 jnp.float64(0)))

        sj = jax.jit(solve_steps)
        t_solve = delta_time(sj, reps, afac0)
        x, iters, relres = jax.device_get(sj(1, afac0))
        if skip_newton:
            t_newton = float("nan")
        else:
            nj = jax.jit(newton_steps)
            t_newton = delta_time(nj, reps, jnp.float64(1.0))
        row = {"inner_maxiter": m,
               "inner_tol": S.inner_tol,
               "solve_s": round(float(t_solve), 5),
               "newton_s": round(float(t_newton), 5),
               "inner_iters": int(iters),
               "relres": float(relres)}
        out["sweep"].append(row)
        print(json.dumps(row), flush=True)     # crash-safe partials
        log(f"m={m}: solve {t_solve:.4f}s newton {t_newton:.4f}s "
            f"inner_iters={int(iters)} relres={float(relres):.2e}")

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
