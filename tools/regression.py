#!/usr/bin/env python
"""Regression / performance tracking harness.

The role of the reference's rev_tests suite
(reference testSuite/rev_tests/runtest.py, dataparser.py: build a
revision, run sequential+parallel cavity continuation, record
iteration counts and timings per revision): runs the benchmark series
— driven-cavity Jacobians at Re 0/100/1000 over grid sizes — records
one JSON line per case to a history file keyed by the git revision,
and prints a comparison against the previous recorded revision.

Usage:
    python tools/regression.py [--sizes 32,64,128]
        [--out artifacts/regression_history.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run_case(nx: int, re: float):
    import jax
    import jax.numpy as jnp
    from hymls.config import Params
    from hymls.stencils import create_testvector, create_nullspace
    from hymls.stencils.navier_stokes import cavity_jacobian
    from hymls import Preconditioner, Solver

    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Driver": {"Null Space Type": "Constant P"},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Left",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 250,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": False,
                           "Separator Length": 4,
                           "Number of Levels": 1 if nx <= 64 else 2},
    })
    K = cavity_jacobian(nx, nx, re)
    tv = create_testvector(params, K)
    ns = create_nullspace(params, K.shape[0])
    t0 = time.perf_counter()
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    S.set_border(ns)
    t_init = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex

    P.compute()
    x, _ = S.apply_inverse(b)           # warm-up/compile
    jax.block_until_ready(x)

    t0 = time.perf_counter()
    P.compute()
    jax.block_until_ready(P.factors)
    t_compute = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, res = S.apply_inverse(b)
    jax.block_until_ready(x)
    t_solve = time.perf_counter() - t0

    relres = float(np.linalg.norm(K @ np.asarray(x) - b)
                   / np.linalg.norm(b))
    return {"case": f"cavity_{nx}_Re{int(re)}", "nx": nx, "re": re,
            "iters": int(res.iters), "relres": relres,
            "init_s": round(t_init, 3), "compute_s": round(t_compute, 4),
            "solve_s": round(t_solve, 4),
            "device": str(__import__("jax").devices()[0])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="32,64,128")
    ap.add_argument("--reynolds", default="0,100,1000")
    ap.add_argument("--out",
                    default="artifacts/regression_history.jsonl")
    args = ap.parse_args()

    rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True).stdout.strip()
    results = []
    for nx in (int(s) for s in args.sizes.split(",")):
        for re in (float(r) for r in args.reynolds.split(",")):
            r = run_case(nx, re)
            r["rev"] = rev
            results.append(r)
            print(json.dumps(r))

    # compare against the last recorded revision
    if os.path.exists(args.out):
        prev = {}
        with open(args.out) as f:
            for line in f:
                d = json.loads(line)
                if d.get("rev") != rev:
                    prev[d["case"]] = d
        for r in results:
            p = prev.get(r["case"])
            if p:
                ds = r["solve_s"] / max(p["solve_s"], 1e-9)
                di = r["iters"] - p["iters"]
                print(f"# {r['case']}: solve {ds:.2f}x vs {p['rev']}, "
                      f"iters {di:+d}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
