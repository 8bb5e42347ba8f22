#!/usr/bin/env python
"""Bring-up check: the main path on the GPU, through the public entry
points, at the problem sizes users run.

    python chip_smoke.py            # phases A-D on one GPU
    python chip_smoke.py --multi    # the two distributed Newton steps
                                    # on four GPUs, each against one GPU

Each phase prints one JSON line.  A phase that misses its target
raises, so the script exits non-zero and prints no result line.  The
last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or without the `hymls` package beside it, the script
exits non-zero at once; it never falls back to the CPU.

Phases on one GPU:
  A  the driver on configs/cavity.xml (Stokes-C 128^2, Cartesian, L=1,
     f64 GMRES to 1e-12) against the file's own Targets;
  B  the production mixed-precision Newton step
     (IterativeRefinementSolver.newton_step_fn) on the generated 128^2
     driven-cavity Jacobian (Re=0, skew, L=3, tol 1e-6): three cold
     steps and one warm-recompute step, checked against scipy's f64 LU;
  C  the same Newton step on Stokes-C 32^3 (skew, L=2, tol 1e-8, at
     most 500 iterations); its line says whether the structured
     program was built ("apply", "structured_reason");
  D  a precision probe: f32 products run in full f32, not TF32.

Iteration counts are checked against the reference targets, not
against exact CPU counts: on the GPU the Schur assembly's segment_sum
is a scatter-add with atomics whose summation order changes from run
to run, so counts may move by +-1 between runs.
"""
import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _mem():
    """[bytes_in_use, peak_bytes_in_use] of the first device."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return [stats.get("bytes_in_use"), stats.get("peak_bytes_in_use")]


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase A: the driver
# ---------------------------------------------------------------------------

_ITERS_RE = re.compile(
    r"refinement 0: iters=(\d+) relres=(\S+) relerr=(\S+) "
    r"\[setup (\S+)s compute (\S+)s solve (\S+)s\]")


def phase_a(cfg=os.path.join(HERE, "configs", "cavity.xml"),
            overrides=()):
    """hymls.driver.main on cavity.xml, twice: cold, then with the plan
    and compilation caches warm.  The driver checks the file's Targets
    (<= 250 iterations, relres <= 1e-10, relerr <= 1e-6)."""
    from hymls import driver
    from hymls.config import load_xml

    targets = load_xml(cfg).sublist("Targets")
    runs = {}
    for run in ("cold", "warm"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = driver.main([cfg, *overrides])
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        sys.stderr.write(out)
        _check(rc == 0, "driver run failed: " + "; ".join(
            ln for ln in out.splitlines() if "FAILED" in ln))
        m = _ITERS_RE.search(out)
        _check(m is not None, "driver printed no iteration line")
        path = json.loads(re.search(r"refinement 0: path (\{.*\})",
                                    out).group(1))
        runs[run] = {"iters": int(m.group(1)),
                     "relres": float(m.group(2)),
                     "relerr": float(m.group(3)),
                     "setup_s": float(m.group(4)),
                     "compute_s": float(m.group(5)),
                     "solve_s": float(m.group(6)),
                     "wall_s": wall}
    cold = runs["cold"]
    _emit("A_driver_cavity", config=os.path.relpath(cfg, HERE),
          **path,
          iters=cold["iters"],
          target_iters=targets.get("Number of Iterations"),
          relres=cold["relres"],
          target_relres=targets.get("Relative Residual 2-Norm"),
          relerr=cold["relerr"],
          target_relerr=targets.get("Relative Error 2-Norm"),
          cold=cold, warm_caches=runs["warm"],
          peak_bytes_in_use=_mem()[1])


# ---------------------------------------------------------------------------
# phases B and C: the production Newton step
# ---------------------------------------------------------------------------

def newton_phase(name, K, b, params, target_iters, relres_max,
                 reference=True, warm=True, n_cold=3):
    """Cold setup, AOT compile, `n_cold` cold Newton steps, optionally
    one warm-recompute step, and the f64 iteration-parity solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse.linalg as spla
    from hymls import Solver
    from hymls.stencils import create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver

    nb = np.linalg.norm(b)
    t0 = time.perf_counter()
    S = IterativeRefinementSolver(
        K, params, testvector=create_testvector(params, K))
    S.compute()
    jax.block_until_ready(S.precond.factors)
    setup_s = time.perf_counter() - t0
    # device memory [in use, peak] after each stage: the peak is
    # process-wide, so a rise between stages belongs to that stage
    mem = {"setup": _mem()}

    vals64, vals32 = S.op64.vals, S.solver.op.vals
    bj = jnp.asarray(b, jnp.float64)
    fn, dplans, extra, aplans = S.newton_step_fn()
    args = (vals64, vals32, dplans, extra, aplans, bj)
    t0 = time.perf_counter()
    step = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem["compile"] = _mem()

    times, inner = [], []
    for _ in range(n_cold):
        r, dt = _timed(step, *args)
        times.append(dt)
        inner.append(int(r.iters))
    mem["steps"] = _mem()
    x = np.asarray(r.x)
    relres = float(np.linalg.norm(K @ x - b) / nb)
    _check(max(inner) - min(inner) <= 1,
           f"{name}: cold steps disagree: {inner} inner iterations")
    _check(relres <= relres_max,
           f"{name}: host relres {relres:.3e} > {relres_max:g}")

    fields = {}
    if warm:
        # a Newton sequence: the next Jacobian differs modestly; the
        # warm step polishes the previous factors instead of refactoring
        s = 1.001
        wfn, *_ = S.newton_step_warm_fn()
        wargs = (vals64 * s, vals32 * jnp.float32(s), dplans, extra,
                 aplans, bj, S.precond.factors)
        t0 = time.perf_counter()
        wstep = wfn.lower(*wargs).compile()
        wcompile_s = time.perf_counter() - t0
        (rw, _), wdt = _timed(wstep, *wargs)
        wrel = float(np.linalg.norm((K * s) @ np.asarray(rw.x) - b) / nb)
        _check(wrel <= relres_max,
               f"{name}: warm step relres {wrel:.3e} > {relres_max:g}")
        fields["warm_step"] = {"compile_s": wcompile_s, "step_s": wdt,
                               "inner_iters": int(rw.iters),
                               "relres": wrel}
        mem["warm_step"] = _mem()

    # iteration parity with the reference target: f64 GMRES with the
    # same preconditioner
    S64 = Solver(K, S.precond, params, dtype=jnp.float64)
    t0 = time.perf_counter()
    _, res64 = S64.apply_inverse(b)
    parity_s = time.perf_counter() - t0
    mem["parity"] = _mem()
    iters64 = int(res64.iters)
    _check(iters64 <= target_iters,
           f"{name}: {iters64} f64 iterations > target {target_iters}")

    if reference:
        # the pressure is fixed only up to a constant (the driver's
        # 'Constant P' null space), so compare modulo that mode
        from hymls.stencils import create_nullspace
        pn = params.copy()
        pn.sublist("Driver")["Null Space Type"] = "Constant P"
        V = create_nullspace(pn, K.shape[0])
        t0 = time.perf_counter()
        x_lu = spla.spsolve(K.tocsc(), b)
        fields["lu_s"] = time.perf_counter() - t0
        err = x - x_lu
        fields["relerr_vs_lu"] = float(
            np.linalg.norm(err - V @ (V.T @ err))
            / np.linalg.norm(x_lu - V @ (V.T @ x_lu)))

    _emit(name, n=int(K.shape[0]), nnz=int(K.nnz), **S.precond.describe(),
          iters_f64=iters64, target_iters=target_iters,
          inner_iters=inner, relres=relres, target_relres=relres_max,
          cold={"setup_s": setup_s, "compile_s": compile_s,
                "first_step_s": times[0]},
          steady_step_s=min(times[1:]) if n_cold > 1 else None,
          step_times_s=times, parity_solve_s=parity_s,
          peak_bytes_in_use=_mem()[1], mem_bytes_by_stage=mem,
          **fields)


def phase_b(nx=128):
    from bench import _cavity128, _stokes_params
    K, b, _ = _cavity128(nx)
    p = _stokes_params(nx, 2, 3, "Skew Cartesian", maxiter=100, tol=1e-6)
    newton_phase("B_newton_cavity128_skew_L3", K, b, p, target_iters=48,
                 relres_max=5e-6)


def phase_c(nx=32):
    import numpy as np
    from bench import _stokes_params
    from hymls.stencils import create_matrix
    p = _stokes_params(nx, 3, 2, "Skew Cartesian", maxiter=500, tol=1e-8)
    p.sublist("Solver").sublist("Iterative Solver")["Num Blocks"] = 60
    K = create_matrix(p)
    b = K @ np.random.default_rng(2).standard_normal(K.shape[0])
    # no SuperLU reference here: it takes minutes on this matrix
    newton_phase(f"C_newton_stokes{nx}cube_skew_L2", K, b, p,
                 target_iters=500, relres_max=1e-7, reference=False,
                 warm=False)


# ---------------------------------------------------------------------------
# phase D: matmul precision
# ---------------------------------------------------------------------------

def phase_d(n=1024):
    """f32 products must run in full f32: TF32 would give a relative
    error of ~1e-3 against the f64 product, full f32 ~1e-6."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    prec = jax.config.jax_default_matmul_precision
    _check(prec == "highest", f"default matmul precision is {prec!r}")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    c = rng.standard_normal((n, n)).astype(np.float32)
    y = np.asarray(jax.jit(jnp.matmul)(a, c), np.float64)
    ref = a.astype(np.float64) @ c.astype(np.float64)
    err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    _check(err <= 1e-5, f"f32 matmul relative error {err:.2e} > 1e-5")
    _emit("D_precision", default_matmul_precision=prec, n=n,
          f32_matmul_relerr=err)


# ---------------------------------------------------------------------------
# --multi: the distributed Newton steps
# ---------------------------------------------------------------------------

def _collectives(txt):
    """(all-gathers inside the Krylov loop body, has collective-permute)
    of a compiled Newton step's HLO text.  The Krylov loop is the inner
    while loop of the refinement loop."""
    ag = [a for a in re.findall(
        r"= \S+ all-gather(?:-start)?\(.*op_name=\"([^\"]*)\"", txt)
        if "/while/body/while/body/" in a]
    return len(ag), "collective-permute" in txt


def multi_phase(name, nx, levels, structured, n_dev, tol=1e-10):
    """One Newton step distributed over `n_dev` devices against the
    same step on one device, in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench import _stokes_params
    from hymls.parallel import make_mesh, set_mesh
    from hymls.stencils import create_matrix, create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver

    def build(dist):
        p = _stokes_params(nx, 2, levels, "Cartesian", maxiter=250,
                           tol=tol)
        p.sublist("Solver")["Distributed Apply"] = dist
        p.sublist("Preconditioner")["Structured Apply"] = structured
        K = create_matrix(p)
        S = IterativeRefinementSolver(
            K, p, testvector=create_testvector(p, K)).compute()
        return K, S

    def run(S, bj):
        fn, dpl, ex, apl = S.newton_step_fn()
        args = (S.op64.vals, S.solver.op.vals, dpl, ex, apl, bj)
        t0 = time.perf_counter()
        step = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        r, first = _timed(step, *args)
        _, steady = _timed(step, *args)
        return r, step.as_text(), {"compile_s": compile_s,
                                   "first_step_s": first,
                                   "steady_step_s": steady}

    K, S1 = build(False)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    bj = jnp.asarray(b, jnp.float64)
    r1, _, t1 = run(S1, bj)
    mesh = make_mesh(n_dev)
    set_mesh(mesh)
    try:
        _, Sn = build(True)
        rn, txt, tn = run(Sn, bj)
        if structured:
            _check(getattr(Sn, "_dist_structured", None) is not None,
                   f"{name}: structured GSPMD path did not activate")
        else:
            _check(getattr(Sn, "_dist", None) is not None
                   and Sn._dist.dcompute is not None,
                   f"{name}: halo path did not activate")
    finally:
        set_mesh(None)
    it1, itn = int(r1.iters), int(rn.iters)
    rel1 = float(np.linalg.norm(K @ np.asarray(r1.x) - b)
                 / np.linalg.norm(b))
    reln = float(np.linalg.norm(K @ np.asarray(rn.x) - b)
                 / np.linalg.norm(b))
    n_ag, has_cp = _collectives(txt)
    _check(abs(itn - it1) <= max(2, 0.03 * it1),
           f"{name}: {itn} inner iterations on {n_dev} devices vs {it1}")
    _check(bool(rn.converged) and reln <= tol * 1.01 + 1e-15,
           f"{name}: relres {reln:.3e} > {tol:g}")
    _check(n_ag <= 1, f"{name}: {n_ag} all-gathers in the Krylov loop")
    _check(has_cp, f"{name}: no collective-permute in the sharded step")
    _emit(name, n=int(K.shape[0]), nnz=int(K.nnz), levels=levels,
          partitioner="Cartesian",
          apply="structured" if structured else "generic (halo)",
          devices=n_dev, inner_iters_1=it1, inner_iters_n=itn,
          relres_1=rel1, relres_n=reln, target_relres=tol,
          krylov_loop_all_gathers=n_ag, collective_permute=has_cp,
          one_device=t1, n_devices=tn, peak_bytes_in_use=_mem()[1])


def multi(nx=128, n_dev=4):
    import jax
    _check(len(jax.devices()) >= n_dev,
           f"--multi needs {n_dev} devices, found {len(jax.devices())}")
    multi_phase("M1_halo_newton_L2", nx, 2, False, n_dev)
    multi_phase("M2_gspmd_structured_newton_L1", nx, 1, True, n_dev)


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device distributed steps")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "hymls")):
        sys.exit("chip_smoke.py: the hymls package is not beside this "
                 "script; run it from a checkout of the repository")
    sys.path.insert(0, HERE)

    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {backend!r}")
    from hymls import native
    from hymls.utils import compile_cache
    cache_dir = compile_cache.enable()

    dev = jax.devices()[0]
    card = _card()
    print(card, flush=True)
    _emit("device", nvidia_smi=card, jax=jax.__version__,
          platform=dev.platform, device_kind=dev.device_kind,
          count=len(jax.devices()),
          native_planner=native.planner() is not None,
          compile_cache=cache_dir)

    if args.multi:
        multi()
    else:
        phase_d()
        phase_a()
        phase_b()
        phase_c()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
