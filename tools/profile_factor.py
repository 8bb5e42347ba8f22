#!/usr/bin/env python
"""Profile the fused factor / solve programs on the device: per-op
device time via jax.profiler + tools/trace_ops.py.

Usage: python tools/profile_factor.py [case] [what] [trace_dir]
  case in {stokes128, cavity128, cavity64}; what in {factor, solve};
  trace_dir defaults to .traces/<case>_<what> in the checkout.
"""
import os
import sys

import jax
import jax.numpy as jnp
from jax import lax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def main():
    from hymls.utils import compile_cache
    compile_cache.enable()
    case = sys.argv[1] if len(sys.argv) > 1 else "stokes128"
    what = sys.argv[2] if len(sys.argv) > 2 else "factor"
    from step_decompose import build_case, delta_time, log
    from hymls.stencils import create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver

    p, K, b = build_case(case)
    tv = create_testvector(p, K)
    S = IterativeRefinementSolver(K, p, testvector=tv)
    log(f"{case}/{what}: computing ...")
    S.compute()
    P = S.precond
    vals64 = S.op64.vals
    bj = jnp.asarray(b, jnp.float64)
    dplans, extra, aplans = P._dplans, P._extra_plan, P._aplans
    compute = P._compute_pure

    if what == "factor":
        def steps(niter, s0, afac0):
            def fbody(i, carry):
                s64 = s0 + 1e-6 * i.astype(jnp.float64)
                factors = compute(vals64 * s64, dplans, extra)
                return P.apply_factors_from_pure(factors, aplans)
            return lax.fori_loop(0, niter, fbody, afac0)

        afac0 = P.apply_factors_from_pure(
            compute(vals64, dplans, extra), aplans)
        fjit = jax.jit(steps)
        args = (jnp.float64(1.0), afac0)
    else:
        S._build_fused()
        fused = S._fused_fn
        vals32 = S.solver.op.vals
        afac0 = P.apply_factors_from_pure(
            compute(vals64, dplans, extra), aplans)

        def steps(niter, s0, afac0):
            def fbody(i, carry):
                bb = bj * (1.0 + 1e-9 * i.astype(jnp.float64))
                r = fused(vals64, vals32, afac0, aplans, bb)
                return r.x
            return lax.fori_loop(0, niter, fbody, jnp.zeros_like(bj))

        fjit = jax.jit(steps)
        args = (jnp.float64(1.0), afac0)

    jax.block_until_ready(fjit(1, *args))
    t = delta_time(fjit, 3, *args)
    log(f"{what}: {t:.4f} s/step; tracing 2 steps ...")
    trace_dir = sys.argv[3] if len(sys.argv) > 3 else os.path.join(
        os.path.dirname(HERE), ".traces", f"{case}_{what}")
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(fjit(2, *args))
    jax.profiler.stop_trace()
    log("trace done; parsing ...")
    import trace_ops
    trace_ops.main(trace_dir, 40)


if __name__ == "__main__":
    main()
