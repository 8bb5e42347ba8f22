#!/usr/bin/env python
"""CPU ground-truth for factor-chain precision (round-4 task #2 / #1).

On CPU an f32 matmul is a TRUE f32 matmul, so this isolates the
numerics question from reduced-precision matmul passes: does a
fully-f32 factor chain ('Factor Precision' = 'Same') hold iteration
parity with the f64 chain on the MULTILEVEL cases that historically
diverged?  If parity holds here, f32 storage with precision=HIGHEST
matmuls (core/preconditioner.py) is safe on any device.

Usage: python tools/f32_quality_cpu.py [case ...]
  cases: stokes128, skew32cube, cavity128 (default: stokes128 skew32cube)
"""
import json
import sys
import time

_REPO = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, _REPO + "/tests")
import _cpu  # noqa: F401,E402  (pin CPU backend)

import numpy as np  # noqa: E402

T0 = time.time()


def log(msg):
    print(f"[f32q +{time.time() - T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def build(name):
    from bench import _stokes_params, _cavity128
    from hymls.stencils import create_matrix
    if name == "stokes128":
        p = _stokes_params(128, 2, 2, "Cartesian")
        K = create_matrix(p)
    elif name == "skew32cube":
        # same config as bench.py stokes32cube_skew_L2
        p = _stokes_params(32, 3, 2, "Skew Cartesian",
                           maxiter=500, tol=1e-8)
        K = create_matrix(p)
    elif name == "cavity128":
        K, _, _ = _cavity128()
        p = _stokes_params(128, 2, 3, "Skew Cartesian", maxiter=100,
                           tol=1e-6)
    else:
        raise SystemExit(f"unknown case {name}")
    rng = np.random.default_rng(1)
    b = K @ rng.standard_normal(K.shape[0])
    return p, K, b


def run(name, fprec):
    from hymls.stencils import create_testvector
    from hymls.solvers.mixed import IterativeRefinementSolver
    p, K, b = build(name)
    p = p.copy()
    p.sublist("Preconditioner")["Factor Precision"] = fprec
    tv = create_testvector(p, K)
    S = IterativeRefinementSolver(K, p, testvector=tv)
    S.compute()
    x, res = S.apply_inverse(b)
    relres = float(np.linalg.norm(K @ np.asarray(x) - b)
                   / np.linalg.norm(b))
    row = {"case": name, "factor_precision": fprec,
           "inner_iters": int(res.iters), "relres": relres}
    log(json.dumps(row))
    return row


def main():
    cases = sys.argv[1:] or ["stokes128", "skew32cube"]
    out = []
    for c in cases:
        for fp in ("f64", "Same"):
            try:
                out.append(run(c, fp))
            except Exception as e:  # keep partials on a diverging case
                out.append({"case": c, "factor_precision": fp,
                            "error": repr(e)})
                log(f"{c}/{fp} FAILED: {e!r}")
            print(json.dumps(out[-1]), flush=True)


if __name__ == "__main__":
    main()
