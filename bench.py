#!/usr/bin/env python
"""Benchmark: the BASELINE.json north star — driven-cavity Jacobian
(Re=1000) setup + solve wall-clock at reference iteration/accuracy
targets (cavity.xml: tol 1e-12, <= 250 GMRES iterations, reference
testSuite/cavity.xml:18-26,50-55).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline semantics: `vs_baseline` is a WALL-CLOCK RATIO —
baseline_seconds / our_seconds (>1 = we are faster) — where the
baseline is a live-measured serial CPU sparse-direct factor+solve
(scipy SuperLU) of the *same matrix* on the bench host.  That is the
same work a reference Newton step does per subdomain with KLU, done
globally: the strongest single-core CPU alternative available here
(Trilinos itself is not installed; scipy ILU is structurally singular
on these saddle-point matrices).  The reference's *achieved* iteration
parity is reported per case in extra.cases[*].iters_f64 against the
reference target cap — parity is a gate (ok flag), not the baseline.

Cases:
  * cavity64_Re1000       — 64^2 driven-cavity Jacobian, Cartesian L=1
                            structured path (the north-star config)
  * stokesB_64            — B-grid Stokes 64^2 (generic path by design)
  * cavity128_Re0         — 128^2 driven cavity (n=49k), skew L=3: the
                            stokes2 flagship
  * stokes128_L2          — 128^2 Stokes-C, Cartesian L=2 multilevel
  * stokes32cube_skew_L2  — 32^3 Stokes-C (n=131k), skew, L=2
  * structured_vs_generic — V-cycle apply: structured gather-free vs
                            generic gather path on the cavity64 matrix
                            (vs_baseline = generic/structured)

Each case also reports `vs_8rank_cpu_ideal` = measured-serial-seconds
/ 8 / ours — the ideal linear-scaling bound of an 8-rank CPU run (the
north star names 8-rank Trilinos), an upper bound on any real one.

Each case runs the production path: f32 factorization + Krylov inside
an f64 iterative-refinement loop, fused into a single XLA program per
Newton step (factor + repack + solve, one dispatch).

Measurement notes:
  * The primary `value` is device time per Newton step, measured by
    fusing the steps into one XLA program (`lax.fori_loop` over the
    step) and delta-timing niter=1 vs niter=REPS+1, which cancels the
    fixed per-dispatch cost.  The per-dispatch wall-clock (REPS async
    launches, one fence) is reported as extra.per_dispatch_s.
  * Every fence is jax.block_until_ready.
  * Every case runs in its own subprocess, one at a time, so a failure
    in one case cannot poison the rest.  The parent process never
    initializes a JAX backend (a GPU process reserves most of the
    card's memory, so a second one would run out); it takes the
    device from the children's result lines.
  * Roofline shares divide by the peaks in PEAKS, keyed by the exact
    `device_kind`; an unknown accelerator is an error, and a CPU run
    reports no roofline fields.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

_T0 = time.time()


def _progress(msg):
    """Timestamped progress on stderr (the JSON contract is stdout)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)

import jax
import jax.numpy as jnp

TARGET_ITERS = 250      # testSuite/cavity.xml "Maximum Iterations"
TOL = 1e-12             # testSuite/cavity.xml "Convergence Tolerance"

# Published peaks per device_kind, for the achieved-rate report.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
# without sparsity (f32 and f64 outside the tensor cores).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0,
                              "f32_gflops": 67_000.0,
                              "f64_gflops": 34_000.0},
}


def device_peaks(device_kind: str) -> dict:
    """Peaks of an accelerator; an unknown one is an error, not a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device_kind!r}; add it to bench.PEAKS") from None


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _peaks():
    """PEAKS entry of this run's device, or None on the CPU."""
    dev = _device()
    return None if dev["platform"] == "cpu" else device_peaks(dev["kind"])


def _cavity(nx, re, seed):
    """Generated driven-cavity Jacobian (stencils/navier_stokes.py) at
    Reynolds number `re`, with b = K @ x for a random x from `seed`."""
    from hymls.stencils.navier_stokes import cavity_jacobian
    K = cavity_jacobian(nx, nx, re=re).tocsr()
    rng = np.random.default_rng(seed)
    b = K @ rng.standard_normal(K.shape[0])
    return K, b, f"generated cavity_jacobian({nx}, {nx}, re={re:g})"


def _cavity64():
    return _cavity(64, 1000.0, 0)


def _cavity128(nx=128):
    """The stokes2 flagship problem (128^2 driven cavity at Re=0,
    n=49k)."""
    return _cavity(nx, 0.0, 4)


def _splu_worker(K, b, reps, q):
    import scipy.sparse.linalg as spla
    Kc = K.tocsc()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        lu = spla.splu(Kc)
        x = lu.solve(b)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    # min over reps: the CPU's best case — stable under host-load
    # spikes and conservative for the vs_baseline ratio
    relres = float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))
    q.put((best, relres))


# The serial-CPU SuperLU baseline for a given case is a property of the
# host class, not of one boot.  Caching it in artifacts/ lets a rerun on
# the same host skip the re-measurement, which otherwise contends with
# the device-program compile for CPU time.  Delete the file to force a
# live re-measurement; each entry records the seconds it used.
_BASELINE_CACHE = os.environ.get(
    "BENCH_BASELINE_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "artifacts", "bench_baselines.json"))
# new measurements land in an UNTRACKED sibling overlay so a running
# bench never dirties the tracked seed; reads merge seed <- overlay
_BASELINE_LOCAL = _BASELINE_CACHE.replace(".json", ".local.json")


def _host_id():
    """Coarse host identity for baseline-cache validity: the serial
    SuperLU seconds are a property of the CPU class, not the repo — a
    clone on different hardware must re-measure, not reuse this
    host's numbers."""
    import platform
    try:
        with open("/proc/cpuinfo") as f:
            model = next((l.split(":", 1)[1].strip() for l in f
                          if l.startswith("model name")), "")
    except OSError:
        model = platform.processor()
    return f"{model}/nproc={os.cpu_count()}"


def _cache_get(key):
    merged = {}
    for path in (_BASELINE_CACHE, _BASELINE_LOCAL):
        try:
            with open(path) as f:
                merged.update(json.load(f))
        except (OSError, ValueError):
            pass
    hit = merged.get(key)
    if hit is None:
        return None
    # entries recorded before the host field existed, or on another
    # host class, are not valid for this host
    if hit.get("host") != _host_id():
        return None
    return hit


def _cache_put(key, val):
    val = dict(val, host=_host_id())
    try:
        cache = {}
        if os.path.exists(_BASELINE_LOCAL):
            with open(_BASELINE_LOCAL) as f:
                cache = json.load(f)
        cache[key] = val
        with open(_BASELINE_LOCAL, "w") as f:
            json.dump(cache, f)
    except (OSError, ValueError):
        pass


class _SpluHandle:
    """In-flight SuperLU baseline; .result() joins (deadline-aware)."""

    def __init__(self, key, proc, queue, t0, timebox_total):
        self._key, self._p, self._q = key, proc, queue
        self._t0, self._box = t0, timebox_total
        self._done = None

    def result(self):
        if self._done is not None:
            return self._done
        remaining = max(self._box - (time.perf_counter() - self._t0), 0.0)
        self._p.join(timeout=remaining)
        if self._p.is_alive():
            self._p.terminate()
            self._p.join()
            _progress(f"  splu baseline exceeded {self._box:.0f}s box "
                      "-> reporting lower bound")
            secs, relres, timed_out = self._box, None, True
        else:
            secs, relres = self._q.get()
            timed_out = False
        # timed-out lower bounds are cached WITH their timebox: a rerun
        # with the same (or smaller) box would only reproduce the same
        # lower bound, so reuse it; a larger box re-measures (never
        # pin a lower bound a bigger budget could beat)
        _cache_put(self._key, {"secs": secs, "relres": relres,
                               "timed_out": timed_out,
                               "timebox": self._box})
        self._done = (secs, relres, timed_out)
        return self._done


class _SpluHit:
    def __init__(self, hit):
        self._done = (hit["secs"], hit["relres"], hit["timed_out"])

    def result(self):
        return self._done


def _splu_baseline_start(K, b, reps=3, timebox=300.0):
    """Start the serial CPU SuperLU factor+solve baseline of the same
    system in a subprocess and return a handle; call .result() for
    (seconds_per_factor_plus_solve, relres, timed_out).

    Started EARLY (before the device setup/compile) so the baseline's
    CPU time hides behind the compiles; callers must join BEFORE any
    device timing so the host stays idle during measurement.

    Time-boxed: one 3D factorization at n>100k runs for tens of
    minutes serially — if the box is exceeded the baseline is reported
    as a LOWER BOUND (timed_out=True) and vs_baseline becomes '>='.

    Measurements are cached on disk keyed by (n, nnz) — a same-host
    rerun (e.g. after warming the compile cache) reuses them instead
    of burning the case budget re-factoring."""
    key = f"splu_n{K.shape[0]}_nnz{K.nnz}"
    if K.shape[0] > 100_000:
        reps = 1
    hit = _cache_get(key)
    if hit is not None and not (hit["timed_out"] and
                                timebox * reps > hit.get("timebox", 0)):
        _progress(f"  splu baseline cache hit: {hit['secs']:.4f}s"
                  f"{' (lower bound)' if hit['timed_out'] else ''}")
        return _SpluHit(hit)
    import multiprocessing as mp
    # spawn, not fork: forking the multithreaded JAX process can
    # deadlock; the worker only needs scipy + the pickled matrix
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_splu_worker, args=(K, b, reps, q))
    t0 = time.perf_counter()
    p.start()
    return _SpluHandle(key, p, q, t0, timebox * reps)


def _stokes_params(nx, dim, levels, partitioner, sx=4,
                   maxiter=TARGET_ITERS, tol=TOL):
    from hymls.config import Params
    prob = {"Equations": "Stokes-C", "Dimension": dim, "nx": nx, "ny": nx}
    if dim == 3:
        prob["nz"] = nx
    return Params({
        "Problem": prob,
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": maxiter,
                                        "Convergence Tolerance": tol}},
        "Preconditioner": {"Partitioner": partitioner,
                           "Separator Length": sx,
                           "Number of Levels": levels},
    })


def _bench_newton(params, K, b, reps, target_iters=TARGET_ITERS,
                  relres_ok=1e-11, extra_fields=None,
                  measure_warm=False):
    """Time REPS fused Newton steps (f32 refactor + repack + IR solve,
    one dispatch each) and the CPU splu baseline on the same matrix.

    The separate f64 iteration-parity solve runs LAST, after a partial
    result line has already been printed, so a failure there costs the
    parity count, never the timing."""
    from hymls.stencils import create_testvector
    from hymls import Solver
    from hymls.solvers.mixed import IterativeRefinementSolver

    # start the CPU baseline NOW — it hides behind the device
    # setup/compiles below and is joined before any timing
    baseline_h = _splu_baseline_start(K, b)

    tv = create_testvector(params, K)
    S = IterativeRefinementSolver(K, params, testvector=tv)
    _progress(f"  setup n={K.shape[0]}: compute() ...")
    S.compute()
    # NOTE: no S.solve(b) warm-up here — it compiles a SEPARATE fused
    # program (solvers/mixed.py:_fused_jit) that the newton-step timing
    # below never reuses
    _progress("  compute() done; timing-program compile ...")

    vals64 = S.op64.vals
    vals32 = S.solver.op.vals
    bj = jnp.asarray(b, jnp.float64)
    newton_fn, dplans, extra, aplans = S.newton_step_fn()
    from jax import lax

    # the largest cases time individually dispatched steps of the
    # standalone newton program instead of a fori_loop-fused one
    big = K.shape[0] > 100_000

    def fused_steps(niter, s0):
        # ONE compile covers compile-warm, delta timing AND the
        # per-dispatch loop (niter is traced; s0 varies the matrix
        # values per dispatch like a Newton sequence would)
        def fbody(i, carry):
            s64 = s0 + 1e-6 * i.astype(jnp.float64)
            rr = newton_fn(vals64 * s64, vals32 * s64.astype(jnp.float32),
                           dplans, extra, aplans, bj)
            return rr.x, jnp.asarray(rr.iters, jnp.int64)
        return lax.fori_loop(0, niter, fbody,
                             (jnp.zeros_like(bj),
                              jnp.zeros((), jnp.int64)))

    elapsed = None
    one = jnp.float64(1.0)
    if big:
        timing = "per-dispatch minus measured launch overhead"
        r = newton_fn(vals64, vals32, dplans, extra, aplans, bj)
        jax.block_until_ready(r.x)                    # compile
        baseline = baseline_h.result()  # join BEFORE timing
        _progress(f"  newton compiled; per-dispatch timing {reps} reps ...")
        # MIN over individually fenced dispatches: the device time plus
        # one launch overhead
        times = []
        last = None
        for i in range(reps):
            scale32 = jnp.asarray(1.0 + 1e-6 * i, jnp.float32)
            t0 = time.perf_counter()
            r = newton_fn(vals64 * (1.0 + 1e-6 * i), vals32 * scale32,
                          dplans, extra, aplans, bj)
            last = r.x
            jax.block_until_ready(last)
            times.append(time.perf_counter() - t0)
        per_dispatch = min(times)
        # measure the fixed per-launch overhead with a trivial dispatch
        # and subtract it from the per-dispatch wall-clock
        tiny = jax.jit(lambda s: s + 1.0)
        z = jnp.float32(0.0)
        jax.block_until_ready(tiny(z))
        ovh = []
        for _ in range(10):
            t0 = time.perf_counter()
            jax.block_until_ready(tiny(z))
            ovh.append(time.perf_counter() - t0)
        overhead = min(ovh)
        elapsed = max(per_dispatch - overhead, 1e-9)
        _progress(f"  per-dispatch {per_dispatch:.4f}s - launch "
                  f"overhead {overhead:.4f}s -> {elapsed:.4f} s/step")
        xh = np.asarray(jax.device_get(last))
        final_scale = 1.0 + 1e-6 * (reps - 1)
        inner_iters = int(jax.device_get(r.iters))
    else:
        timing = "fused fori_loop delta (niter=1 vs niter=reps+1)"
        fjit = jax.jit(fused_steps)
        jax.block_until_ready(fjit(1, one))           # the ONE compile
        baseline = baseline_h.result()  # join BEFORE timing
        _progress(f"  compiled; timing {reps} fused reps ...")
        # measure each endpoint TWICE and keep the per-key MIN: an
        # inflated t[1] biases the delta low
        t = {}
        out = {}
        for nit in (1, reps + 1, 1, reps + 1):
            t0 = time.perf_counter()
            res = fjit(nit, one)
            jax.block_until_ready(res)
            dt = time.perf_counter() - t0
            t[nit] = min(t.get(nit, float("inf")), dt)
            out[nit] = res
        elapsed = max((t[reps + 1] - t[1]) / reps, 1e-9)
        _progress(f"  fused: {elapsed:.4f} s/step; dispatch timing ...")
        # secondary: per-dispatch wall-clock (includes launch costs)
        t0 = time.perf_counter()
        rs = [fjit(1, jnp.float64(1.0 + 1e-6 * i)) for i in range(reps)]
        jax.block_until_ready(rs[-1])
        per_dispatch = (time.perf_counter() - t0) / reps
        x_last, it_last = out[reps + 1]
        xh = np.asarray(jax.device_get(x_last))
        final_scale = 1.0 + 1e-6 * reps   # last fori index i = reps
        inner_iters = int(jax.device_get(it_last))

    Kp = K.copy()
    Kp.data = Kp.data * final_scale
    relres = float(np.linalg.norm(Kp @ xh - b) / np.linalg.norm(b))

    # parity has PRIORITY over the secondary timings:
    # reserve its budget up front unless a cached count exists — the
    # factor-only and warm timings are dropped first when tight
    pkey = f"parity_n{K.shape[0]}_nnz{K.nnz}_t{target_iters}"
    parity_reserve = 0.0 if _cache_get(pkey) is not None else 210.0
    budget_left = float(os.environ.get("BENCH_CASE_BUDGET_S", "1e9"))

    def _remaining():
        return budget_left - (time.time() - _T0) - parity_reserve

    base_secs, base_relres, base_timed_out = baseline
    baseline = {"method": "scipy SuperLU factor+solve (serial CPU)",
                "seconds": round(base_secs, 5),
                "relres": base_relres}
    if base_timed_out:
        baseline["note"] = ("time-boxed: seconds is a LOWER BOUND (the "
                            "factorization was still running); "
                            "vs_baseline is therefore '>='")

    # analytic cost model + achieved rates (reference flop counters,
    # src/HYMLS_Preconditioner.cpp:612-680); model flops per Newton
    # step = one factorization + inner_iters * (V-cycle apply + SpMV)
    from hymls.utils.flops import preconditioner_flops
    fm = preconditioner_flops(S.precond)
    step_flops = fm["compute_flops"] + max(inner_iters, 0) * (
        fm["apply_flops"] + 2.0 * K.nnz)
    achieved_gflops = step_flops / elapsed / 1e9
    cost_model = {
        "compute_gflop": round(fm["compute_flops"] / 1e9, 3),
        "apply_mflop": round(fm["apply_flops"] / 1e6, 3),
        "apply_mb": round(fm["apply_bytes"] / 1e6, 3),
        "model_step_gflop": round(step_flops / 1e9, 3),
        "achieved_gflops": round(achieved_gflops, 2),
    }
    peaks = _peaks()
    if peaks:
        cost_model["pct_f32_peak"] = round(
            100 * achieved_gflops / peaks["f32_gflops"], 2)
    result = {
        "value": round(elapsed, 5),
        "unit": "seconds/factor+solve",
        "vs_baseline": round(base_secs / elapsed, 3),
        # the IDEAL linear-scaling bound of the measured serial
        # baseline over 8 ranks — an upper bound on any real 8-rank run
        "vs_8rank_cpu_ideal": round(base_secs / 8.0 / elapsed, 3),
        "device": _device(),
        "ok": relres <= relres_ok,
        "baseline": baseline,
        "per_dispatch_s": round(per_dispatch, 5),
        "timing": timing,
        "iters_f64": -1,
        "target_iters": target_iters,
        "ir_inner_iters": inner_iters,
        "relres": relres,
        "cost_model": cost_model,
    }
    if extra_fields:
        result.update(extra_fields)

    def _emit_partial():
        # partial result (everything measured so far, no parity): the
        # line the parent falls back to if a later phase fails or the
        # per-case cap kills the child.  Emitted IMMEDIATELY after the
        # primary timing — before the optional factor-only/warm
        # timings — so a cap kill during those can never lose the case
        partial = dict(result)
        partial["parity"] = ("unavailable (killed/crashed before the "
                             "f64 parity solve)")
        if not partial["ok"]:
            partial["vs_baseline"] = 0.0
        print(json.dumps(partial), flush=True)

    _emit_partial()

    # factor-vs-solve decomposition: delta-time the factor-only program
    # when the case budget allows the extra compile; solve_s = step -
    # factor
    factor_s = None
    if not big and _remaining() > 260:
        try:
            P = S.precond
            compute = P._compute_pure
            dpl, ext, apl = P._dplans, P._extra_plan, P._aplans
            afac0 = P.apply_factors_from_pure(
                compute(vals64, dpl, ext), apl)

            def factor_steps(niter, s0, afac):
                def fbody(i, carry):
                    s64 = s0 + 1e-6 * i.astype(jnp.float64)
                    fac = compute(vals64 * s64, dpl, ext)
                    return P.apply_factors_from_pure(fac, apl)
                return lax.fori_loop(0, niter, fbody, afac)

            ffjit = jax.jit(factor_steps)
            jax.block_until_ready(ffjit(1, one, afac0))
            tf = {}
            for nit in (1, reps + 1, 1, reps + 1):   # min-of-2
                t0 = time.perf_counter()
                jax.block_until_ready(ffjit(nit, one, afac0))
                tf[nit] = min(tf.get(nit, float("inf")),
                              time.perf_counter() - t0)
            factor_s = max((tf[reps + 1] - tf[1]) / reps, 1e-9)
            _progress(f"  factor-only: {factor_s:.4f} s/step")
        except Exception as e:   # pragma: no cover - bench resilience
            _progress(f"  factor-only timing failed: {e!r}")

    # warm-recompute Newton step (the production continuation path:
    # the reference reuses its analysis via SetMatrix-then-Compute,
    # src/HYMLS_Preconditioner.hpp:246-254; here the dense inverses are
    # Newton-Schulz-polished from the previous step's factors, with a
    # residual-gated cold fallback compiled into the same program) —
    # reported SEPARATELY from the cold step; both are honest: cold =
    # first factorization, warm = every subsequent Newton step
    warm = {}
    if measure_warm and not big and _remaining() > 220:
        try:
            wfn, wdpl, wex, wapl = S.newton_step_warm_fn()
            fac0 = S.precond.factors

            def warm_steps(niter, s0, fac0):
                def wbody(i, carry):
                    _x, _it, fac = carry
                    s64 = s0 + 1e-6 * (i + 1).astype(jnp.float64)
                    rr, fac = wfn(vals64 * s64,
                                  vals32 * s64.astype(jnp.float32),
                                  wdpl, wex, wapl, bj, fac)
                    return rr.x, jnp.asarray(rr.iters, jnp.int64), fac
                return lax.fori_loop(
                    0, niter, wbody,
                    (jnp.zeros_like(bj), jnp.zeros((), jnp.int64), fac0))

            wjit = jax.jit(warm_steps)
            jax.block_until_ready(wjit(1, one, fac0))
            tw = {}
            outw = {}
            for nit in (1, reps + 1, 1, reps + 1):   # min-of-2
                t0 = time.perf_counter()
                res = wjit(nit, one, fac0)
                jax.block_until_ready(res)
                tw[nit] = min(tw.get(nit, float("inf")),
                              time.perf_counter() - t0)
                outw[nit] = res
            warm_s = max((tw[reps + 1] - tw[1]) / reps, 1e-9)
            xw, itw, _ = outw[reps + 1]
            xw = np.asarray(jax.device_get(xw))
            Kw = K.copy()
            Kw.data = Kw.data * (1.0 + 1e-6 * (reps + 1))
            wrel = float(np.linalg.norm(Kw @ xw - b) /
                         np.linalg.norm(b))
            warm = {"warm_step_s": round(warm_s, 5),
                    "warm_inner_iters": int(jax.device_get(itw)),
                    "warm_relres": wrel,
                    "warm_ok": wrel <= relres_ok}
            _progress(f"  warm-recompute step: {warm_s:.4f} s/step "
                      f"(relres {wrel:.2e})")
        except Exception as e:   # pragma: no cover - bench resilience
            _progress(f"  warm timing failed: {e!r}")

    if factor_s is not None:
        solve_s = max(elapsed - factor_s, 1e-9)
        # solve-phase HBM traffic model: per inner iteration one f32
        # V-cycle apply (apply_bytes/2) + one f32 SpMV (vals+idx+vec)
        spmv_bytes = 8.0 * K.nnz + 8.0 * K.shape[0]
        solve_gb = max(inner_iters, 1) * (fm["apply_bytes"] / 2 +
                                          spmv_bytes) / 1e9
        gbps = solve_gb / solve_s
        cost_model.update({
            "factor_s": round(factor_s, 5),
            "solve_s": round(solve_s, 5),
            "solve_est_gbps": round(gbps, 1),
        })
        if peaks:
            cost_model["solve_pct_hbm_roofline"] = round(
                100 * gbps / peaks["hbm_gbps"], 1)
        _emit_partial()

    if warm.get("warm_step_s"):
        result.update(warm)
        result["vs_8rank_cpu_ideal_warm"] = round(
            base_secs / 8.0 / warm["warm_step_s"], 3)
        _emit_partial()

    # parity count cache: the f64 parity solve is deterministic for a
    # fixed matrix + config (Zero start) — a same-host rerun reuses the
    # count instead of re-burning its budget (210 s on the cavity case)
    hit = _cache_get(pkey)
    if hit is not None:
        _progress(f"  f64 parity cache hit: {hit['iters']} iters")
        result["iters_f64"] = hit["iters"]
        result["parity"] = "cached (deterministic Zero-start solve)"
        result["ok"] = bool(relres <= relres_ok and
                            hit["iters"] <= target_iters)
        if not result["ok"]:
            result["vs_baseline"] = 0.0
        return result

    # attempt the parity solve whenever any budget remains: the
    # partial (pre-parity) line is already printed, so a cap kill
    # mid-parity costs nothing beyond the count itself (the secondary
    # timings above were dropped first to protect this slot)
    if budget_left - (time.time() - _T0) < 45:
        result["iters_f64"] = -1
        result["parity"] = "skipped (bench budget)"
        _progress("  budget low: skipping f64 parity solve")
        return result
    _progress("  timing done; f64 iteration-parity solve ...")

    # iteration parity vs the reference target: a mixed f64-GMRES solve
    # has the same count as the all-f64 method
    S64 = Solver(K, S.precond, params, dtype=jnp.float64)
    _, res64 = S64.apply_inverse(b)
    niter = int(res64.iters)
    _progress(f"  f64 parity solve done ({niter} iters)")
    _cache_put(pkey, {"iters": niter})
    result["iters_f64"] = niter
    result["ok"] = bool(relres <= relres_ok and niter <= target_iters)
    if not result["ok"]:
        result["vs_baseline"] = 0.0
    return result


def _bench_apply_modes(params, K, b, reps=400):
    """Structured gather-free apply vs generic gather apply — one
    V-cycle application each (the per-Krylov-iteration cost).

    Device time via the fused fori_loop delta, same as
    _bench_newton."""
    from jax import lax
    from hymls.core.preconditioner import Preconditioner
    from hymls.stencils import create_testvector

    tv = create_testvector(params, K)
    times = {}
    for mode in ("generic", "structured"):
        p = params.copy()
        p.sublist("Preconditioner")["Structured Apply"] = \
            (mode == "structured")
        P = Preconditioner(K, p, testvector=tv, dtype=jnp.float32)
        P.compute()
        r = jnp.asarray(b, jnp.float32)

        def loop(niter, y, P=P):
            return lax.fori_loop(0, niter,
                                 lambda i, z: P.apply_inverse(z), y)

        fjit = jax.jit(loop)
        jax.block_until_ready(fjit(1, r))     # compile + warm
        t = {}
        for nit in (1, reps + 1, 1, reps + 1):   # min-of-2
            t0 = time.perf_counter()
            jax.block_until_ready(fjit(nit, r))
            t[nit] = min(t.get(nit, float("inf")),
                         time.perf_counter() - t0)
        times[mode] = max((t[reps + 1] - t[1]) / reps, 1e-9)
        _progress(f"  {mode}: {times[mode] * 1e3:.3f} ms/apply")
        if mode == "structured":
            P_struct = P
    # HBM roofline of the V-cycle apply (bandwidth-bound: factor reads
    # + vector traffic, analytic byte count with f32 factors)
    from hymls.utils.flops import preconditioner_flops
    fm = preconditioner_flops(P_struct)
    gbps = fm["apply_bytes"] / 2 / times["structured"] / 1e9  # f32: /2
    cost_model = {
        "apply_mflop": round(fm["apply_flops"] / 1e6, 3),
        "apply_mb_f32": round(fm["apply_bytes"] / 2 / 1e6, 3),
        "achieved_gbps": round(gbps, 1),
    }
    peaks = _peaks()
    if peaks:
        cost_model["pct_hbm_roofline"] = round(
            100 * gbps / peaks["hbm_gbps"], 1)
    return {
        "value": round(times["structured"], 6),
        "unit": "seconds/apply",
        "vs_baseline": round(times["generic"] / times["structured"], 3),
        "baseline": {"method": "generic gather-path apply (same device)",
                     "seconds": round(times["generic"], 6)},
        "cost_model": cost_model,
        "device": _device(),
    }


def _run_case(name):
    """Run ONE case in this process; returns its result dict."""
    if name == "cavity64_Re1000":
        K, b, source = _cavity64()
        params = _stokes_params(64, 2, 1, "Cartesian")
        return _bench_newton(params, K, b, reps=10,
                             extra_fields={"source": source},
                             measure_warm=True)

    if name == "cavity128_Re0":
        # the stokes2 flagship at scale: 128^2 driven cavity (n=49k),
        # skew partitioner, 3 levels, reference targets <=48 iters at
        # 5e-6 (testSuite/integration_tests/stokes2.xml)
        K, b, source = _cavity128()
        p = _stokes_params(128, 2, 3, "Skew Cartesian",
                           maxiter=100, tol=1e-6)
        return _bench_newton(p, K, b, reps=5, target_iters=48,
                             relres_ok=5e-6,
                             extra_fields={"source": source},
                             measure_warm=True)

    if name == "stokes128_L2":
        from hymls.stencils import create_matrix
        p128 = _stokes_params(128, 2, 2, "Cartesian")
        K128 = create_matrix(p128)
        rng = np.random.default_rng(1)
        b128 = K128 @ rng.standard_normal(K128.shape[0])
        return _bench_newton(p128, K128, b128, reps=5)

    if name == "stokes32cube_skew_L2":
        from hymls.stencils import create_matrix
        # 3D convergence targets follow the reference's own 3D cases,
        # which are far looser than the 2D ones (stokes1_3D.xml: 130
        # iters at 1.5e-5 on a 16^3 grid): tol 1e-8, cap 500.
        # Num Blocks 60 keeps the f64 parity solve on a short restarted
        # basis
        p3d = _stokes_params(32, 3, 2, "Skew Cartesian",
                             maxiter=500, tol=1e-8)
        p3d.sublist("Solver").sublist("Iterative Solver")[
            "Num Blocks"] = 60
        K3d = create_matrix(p3d)
        rng = np.random.default_rng(2)
        b3d = K3d @ rng.standard_normal(K3d.shape[0])
        return _bench_newton(p3d, K3d, b3d, reps=3,
                             target_iters=500, relres_ok=1e-7)

    if name == "structured_vs_generic_apply":
        K, b, _source = _cavity64()
        params = _stokes_params(64, 2, 1, "Cartesian")
        return _bench_apply_modes(params, K, b)

    if name == "stokesB_64":
        # the B-grid flagship runs Apply Dropping=false through the
        # generic gather path (no structured fast path by design —
        # different math); this records its own wall-clock story.
        # 64^2 (n=12k): at the config's native 32^2 (n=3k) the whole
        # device program is launch-bound and a 20 ms CPU SuperLU
        # trivially wins — not a meaningful comparison
        from hymls.config import load_xml
        from hymls.stencils import create_matrix
        pb = load_xml(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "configs", "stokes_B.xml"))
        pb.sublist("Problem")["nx"] = 64
        pb.sublist("Problem")["ny"] = 64
        pb.sublist("Solver").sublist("Iterative Solver")[
            "Maximum Iterations"] = TARGET_ITERS
        pb.sublist("Solver").sublist("Iterative Solver")[
            "Convergence Tolerance"] = TOL
        Kb = create_matrix(pb)
        rngb = np.random.default_rng(3)
        bb = Kb @ rngb.standard_normal(Kb.shape[0])
        return _bench_newton(pb, Kb, bb, reps=5)

    raise ValueError(f"unknown case {name!r}")


# headline first; the 32^3 case second while the budget is fresh, the
# apply-mode micro-case third; the remaining cases run inside per-case
# caps so no one case can starve the rest
CASE_ORDER = ["cavity64_Re1000", "stokes32cube_skew_L2",
              "structured_vs_generic_apply",
              "cavity128_Re0", "stokes128_L2", "stokesB_64"]

# per-case wall-clock caps (seconds): bound each child so later cases
# always get a slot; the early-partial emit above means a cap kill
# during the optional secondary timings still keeps the case's primary
# result.  The 32^3 cap covers its host-side plan build.
CASE_CAP_S = {"cavity64_Re1000": 240, "stokes32cube_skew_L2": 420,
              "structured_vs_generic_apply": 100,
              "cavity128_Re0": 200, "stokes128_L2": 200,
              "stokesB_64": 150}


_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "BENCH.json")


def _assemble_result(cases, t_all, device):
    head = cases.get("cavity64_Re1000", {})
    return {
        "metric": "cavity64_Re1000_factor_plus_solve",
        "value": head.get("value", -1.0),
        "unit": "seconds",
        "vs_baseline": head.get("vs_baseline", 0.0),
        "extra": {
            "vs_baseline_semantics":
                "baseline_seconds / our_seconds (>1 = faster than the "
                "live-measured serial-CPU SuperLU direct factor+solve "
                "of the same system on this host); value = device "
                "seconds per fused Newton step (factor+repack+solve), "
                "extra.cases[*].per_dispatch_s = wall-clock including "
                "the launch overhead",
            "device": device,
            "path": "structured f32 factor + fused f32-Krylov/f64-IR",
            "bench_wall_s": round(time.time() - t_all, 1),
            "cases": cases,
        },
    }


def _write_artifact(cases, t_all, device, final):
    """Persist the full result to BENCH.json after every case: the
    stdout tail can truncate, the disk artifact cannot."""
    try:
        result = _assemble_result(cases, t_all, device)
        # self-describing status: driver_finished
        # means the case loop ran to its end, nothing more; the ok /
        # error counts say how many cases actually produced numbers
        result["extra"]["driver_finished"] = final
        result["extra"]["cases_ok"] = sum(
            1 for c in cases.values() if "error" not in c)
        result["extra"]["cases_error"] = sum(
            1 for c in cases.values() if "error" in c)
        with open(_ARTIFACT, "w") as f:
            json.dump(result, f, indent=1)
    except OSError:     # pragma: no cover - bench resilience
        pass


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--case":
        # child mode: one case, one JSON line on stdout
        from hymls.utils import compile_cache
        compile_cache.enable()
        name = sys.argv[2]
        _progress(f"case {name} ...")
        print(json.dumps(_run_case(name)))
        return

    # parent: never initializes a JAX backend (see the module notes)
    t_all = time.time()
    # later cases are skipped once the elapsed wall-clock passes this
    # budget so the headline JSON line is ALWAYS printed inside the
    # caller's timeout
    budget = float(os.environ.get("BENCH_BUDGET_S", "840"))
    _progress(f"budget {budget:.0f}s")
    cases = {}
    device = None
    here = os.path.abspath(__file__)

    # one retry per failed case, budget permitting
    queue = list(CASE_ORDER)
    retried = set()
    while queue:
        name = queue.pop(0)
        remaining = budget - (time.time() - t_all)
        if cases.get(name, {}).get("error") is None and name in cases:
            continue
        if cases and remaining < 60:
            cases[name] = {"error": "bench budget exhausted"}
            continue
        # per-case caps (CASE_CAP_S) bound every child so a slow early
        # case can never starve the later ones; the cap never exceeds
        # the remaining budget (+grace) so the total stays bounded
        case_budget = min(max(remaining, 120),
                          CASE_CAP_S.get(name, 240))
        try:
            env = dict(os.environ,
                       BENCH_CASE_BUDGET_S=str(case_budget))
            proc = subprocess.run(
                [sys.executable, here, "--case", name],
                stdout=subprocess.PIPE, stderr=None, env=env,
                timeout=case_budget + 30)
            lines = [l for l in proc.stdout.decode().splitlines()
                     if l.startswith("{")]
            if lines:
                # last parseable line: the full result, or the partial
                # (pre-parity) line if the f64 parity solve failed
                cases[name] = json.loads(lines[-1])
                if proc.returncode != 0:
                    cases[name]["subprocess_rc"] = proc.returncode
            else:
                cases[name] = {"error":
                               f"case subprocess rc={proc.returncode}"}
        except subprocess.TimeoutExpired as e:
            # the child may have printed its partial (pre-parity)
            # result line before the cap
            out = (e.stdout or b"").decode(errors="replace")
            lines = [l for l in out.splitlines() if l.startswith("{")]
            if lines:
                cases[name] = json.loads(lines[-1])
                cases[name]["subprocess_rc"] = "timeout"
            else:
                cases[name] = {"error": "case subprocess timeout"}
        except Exception as e:      # pragma: no cover - bench resilience
            cases[name] = {"error": repr(e)}
        device = device or cases[name].get("device")
        if "error" in cases.get(name, {}) and name not in retried \
                and budget - (time.time() - t_all) > 90:
            retried.add(name)
            _progress(f"  case {name} failed "
                      f"({cases[name]['error'][:60]}); retrying once")
            queue.append(name)
        _write_artifact(cases, t_all, device, final=False)

    _write_artifact(cases, t_all, device, final=True)
    result = _assemble_result(cases, t_all, device)
    result["extra"]["artifact"] = _ARTIFACT
    print(json.dumps(result))


if __name__ == "__main__":
    main()
