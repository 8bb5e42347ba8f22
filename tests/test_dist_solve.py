"""Distributed production solve (parallel/dist.py + Solver
'Distributed Apply'): the whole GMRES iteration runs in the
owner-sharded halo layout — ppermute halo matvec, ppermute V-cycle
preconditioner, GSPMD-partitioned dots — matching the reference's
per-iteration Import/Export communication pattern
(reference src/HYMLS_Preconditioner.cpp:973-1052,
src/HYMLS_BaseSolver.cpp:309-359)."""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hymls.config import Params
from hymls.stencils import create_matrix, create_testvector
from hymls import Preconditioner, Solver
from hymls.parallel.mesh import make_mesh, set_mesh

from _mesh import NDEV_SWEEP

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")


def _build(nx, levels, eq="Laplace", dist=False, maxiter=60, dim=2):
    prob = {"Equations": eq, "Dimension": dim, "nx": nx, "ny": nx}
    if dim == 3:
        prob["nz"] = nx
    params = Params({
        "Problem": prob,
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Distributed Apply": dist,
                   "Iterative Solver": {"Maximum Iterations": maxiter,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": levels,
                           "Structured Apply": False},
    })
    K = create_matrix(params)
    P = Preconditioner(K, params, testvector=create_testvector(params, K))
    S = Solver(K, P, params)
    return K, P, S


@pytest.mark.parametrize("eq,nx,levels", [
    ("Laplace", 32, 1),
    ("Laplace", 32, 2),
    ("Stokes-C", 32, 2),
])
def test_dist_solve_iteration_identity(eq, nx, levels):
    """Same iteration count and solution as the single-device solve
    (the reference's 1..8-rank identical-convergence gate)."""
    K, P0, S0 = _build(nx, levels, eq)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(K.shape[0])
    x_ref, res_ref = S0.apply_inverse(b)

    mesh = make_mesh(8)
    set_mesh(mesh)
    try:
        K2, P2, S = _build(nx, levels, eq, dist=True)
        x, res = S.apply_inverse(b)
    finally:
        set_mesh(None)
    assert S._dist is not None, "distributed path did not activate"
    assert int(res.iters) == int(res_ref.iters)
    # the distributed solve must reach the replicated solve's true
    # residual (Stokes has a constant-pressure null space, so a random
    # b is not in range(K) and the true residual stagnates — identical
    # stagnation level is the correct gate)
    xn = np.asarray(x)
    relres = np.linalg.norm(K @ xn - b) / np.linalg.norm(b)
    relres_ref = (np.linalg.norm(K @ np.asarray(x_ref) - b)
                  / np.linalg.norm(b))
    assert relres <= relres_ref * (1 + 1e-6) + 1e-12, \
        f"distributed relres {relres} vs replicated {relres_ref}"
    # ... and agree with the replicated solution elementwise up to the
    # Krylov tolerance (saddle-point cases carry a near-null pressure
    # component ~1e8 in magnitude, so exact match is not expected)
    scale = np.abs(np.asarray(x_ref)).max()
    assert np.abs(xn - np.asarray(x_ref)).max() / scale < 1e-6


def test_dist_solve_collectives():
    """The compiled distributed solve contains no all-gather beyond the
    coarse-solve gathers and the final solution readout; all level and
    matvec traffic is point-to-point collective-permute."""
    mesh = make_mesh(8)
    set_mesh(mesh)
    try:
        K, P, S = _build(64, 2, "Laplace", dist=True)
        S._build_solve()
        assert S._dist is not None
        b = jnp.zeros(K.shape[0])
        factors = P._prune_factors(P.factors)
        txt = S._solve_jit.lower(S.op.vals, factors, S._dist.dplans,
                                 b, b).compile().as_text()
    finally:
        set_mesh(None)
    # count collective *instructions* (definitions, not operand refs),
    # split by loop-body vs outside via the op_name metadata
    ag = re.findall(r"= \S+ all-gather\(.*op_name=\"([^\"]*)\"", txt)
    cp = re.findall(r"= \S+ collective-permute\(.*op_name=\"([^\"]*)\"",
                    txt)
    ag_body = [a for a in ag if "/while/body/" in a]
    cp_body = [c for c in cp if "/while/body/" in c]
    # hot path: exactly one small coarse-rhs gather per V-cycle apply,
    # everything else ppermute (reference: one restricted-communicator
    # coarse solve per apply, Import/Export elsewhere)
    assert len(ag_body) <= 1, \
        f"{len(ag_body)} all-gathers in the GMRES loop body: {ag_body}"
    assert len(cp_body) >= 3, "expected ppermute traffic in the loop body"
    # outside the loop: epilogue preconditioner coarse gather + the
    # final solution readout
    assert len(ag) <= 4, f"{len(ag)} all-gather instructions: {ag}"
    assert "while" in txt


def test_dist_matvec_matches_global():
    """Owner-layout halo SpMV == global SpMV, bit-exact per row."""
    from hymls.parallel.dist import make_distributed_solve

    K, P, S = _build(32, 1, "Stokes-C")
    P.compute()
    mesh = make_mesh(8)
    set_mesh(mesh)
    try:
        dist = make_distributed_solve(K, P, mesh)
        rng = np.random.default_rng(3)
        x = rng.standard_normal(K.shape[0])
        vals = jnp.asarray(K.data)

        @jax.jit
        def mv(vals, xg):
            pv = dist.prepare(vals)
            y = dist.matvec(pv, dist.scatter(xg))
            return dist.gather(y)

        y = np.asarray(mv(vals, jnp.asarray(x)))
    finally:
        set_mesh(None)
    y_ref = K @ x
    # reduction order differs from scipy's (ELL row sum vs CSR running
    # sum), so agreement is to f64 round-off, not bit-exact
    scale = np.abs(y_ref).max()
    assert np.abs(y - y_ref).max() / scale < 1e-13, \
        f"max rel diff {np.abs(y - y_ref).max() / scale}"


def _build_mixed(dist, fprec=None):
    from hymls.solvers.mixed import IterativeRefinementSolver

    prec = {"Separator Length": 4,
            "Number of Levels": 2,
            "Structured Apply": False,
            # pin the same assembly on BOTH builds: the
            # iteration-identity check needs bit-matching factors
            "Schur Assembly": "Full f64"}
    if fprec is not None:
        prec["Factor Precision"] = fprec
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Distributed Apply": dist,
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance":
                                            1e-10}},
        "Preconditioner": prec,
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    S = IterativeRefinementSolver(K, params, testvector=tv)
    S.compute()
    return K, S


@pytest.mark.parametrize("ndev", [2, 3, 5, 8])
def test_dist_mixed_newton_step(ndev):
    """The PRODUCTION path distributed: the fused mixed-precision
    Newton step (all-f32 true-precision distributed factorization +
    f32 halo GMRES inside the f64 IR loop) over meshes of 2/3/5/8
    devices — non-divisible subdomain counts exercise the ceil-block
    ownership padding (reference 1..8-rank unit-test matrix,
    testSuite/unit_tests/CMakeLists.txt:36-48)."""
    def build(dist):
        return _build_mixed(dist)

    K, S0 = build(False)
    assert not S0.precond._upcast, \
        "production default should be the all-f32 factor chain"
    rng = np.random.default_rng(0)
    b = K @ rng.standard_normal(K.shape[0])
    bj = jnp.asarray(b, jnp.float64)
    n0, dpl0, ex0, apl0 = S0.newton_step_fn()
    r0 = jax.device_get(n0(S0.op64.vals, S0.solver.op.vals, dpl0, ex0,
                           apl0, bj))

    mesh = make_mesh(ndev)
    set_mesh(mesh)
    try:
        K2, S = build(True)
        nfn, dpl, ex, apl = S.newton_step_fn()
        assert S._dist is not None, "distributed path did not activate"
        assert S._dist.dcompute is not None, \
            "distributed factorization did not activate (upcast chain)"
        r = jax.device_get(nfn(S.op64.vals, S.solver.op.vals, dpl, ex,
                               apl, bj))
    finally:
        set_mesh(None)
    assert bool(r.converged)
    x = np.asarray(r.x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    relres0 = (np.linalg.norm(K @ np.asarray(r0.x) - b)
               / np.linalg.norm(b))
    assert relres <= max(relres0 * 1.5, 1e-10), \
        f"distributed relres {relres} vs replicated {relres0}"
    # inner-iteration identity: the distributed assembly sums in the
    # exact serial order and the f32 V-cycle is the same math, so the
    # IR loop takes the same trajectory
    assert int(r.iters) == int(r0.iters), \
        f"inner iters {int(r.iters)} vs replicated {int(r0.iters)}"


def test_dist_mixed_newton_step_f64_factors():
    """The opt-in factor-upcast chain (f64 assembly, f32 store —
    'Factor Precision' = 'f64') distributed: same identity gate as
    the production all-f32 sweep above (reference does all setup in
    double, src/HYMLS_MatrixBlock.cpp:74-134)."""
    K, S0 = _build_mixed(False, fprec="f64")
    assert S0.precond._upcast
    rng = np.random.default_rng(0)
    b = K @ rng.standard_normal(K.shape[0])
    bj = jnp.asarray(b, jnp.float64)
    n0, dpl0, ex0, apl0 = S0.newton_step_fn()
    r0 = jax.device_get(n0(S0.op64.vals, S0.solver.op.vals, dpl0, ex0,
                           apl0, bj))

    mesh = make_mesh(8)
    set_mesh(mesh)
    try:
        K2, S = _build_mixed(True, fprec="f64")
        nfn, dpl, ex, apl = S.newton_step_fn()
        assert S._dist is not None, "distributed path did not activate"
        assert S._dist.dcompute is not None and S._dist.dcompute._upcast
        r = jax.device_get(nfn(S.op64.vals, S.solver.op.vals, dpl, ex,
                               apl, bj))
    finally:
        set_mesh(None)
    assert bool(r.converged)
    x = np.asarray(r.x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    relres0 = (np.linalg.norm(K @ np.asarray(r0.x) - b)
               / np.linalg.norm(b))
    assert relres <= max(relres0 * 1.5, 1e-10)
    assert int(r.iters) == int(r0.iters)


@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_dist_bordered_solve(ndev):
    """Distributed bordered GMRES: the augmented system [K V; W' C]
    iterates in the flat (ndev*(L+m),) owner layout with the m-tail
    replicated per shard (scaled 1/sqrt(ndev) so norms are exact) —
    iteration identity + solution parity vs the replicated bordered
    solve (reference src/HYMLS_BorderedSolver.cpp:173-219 runs the
    bordered iteration over distributed vectors)."""
    K, P0, S0 = _build(32, 2, "Stokes-C", maxiter=200)
    n = K.shape[0]
    # constant-pressure null space as the border (the reference's
    # standard bordered use, testSuite cavity configs)
    from hymls.stencils import create_matrix  # noqa: F401
    V = np.zeros((n, 1))
    V[2::3, 0] = 1.0
    V /= np.linalg.norm(V)
    rng = np.random.default_rng(7)
    b = K @ rng.standard_normal(n)
    S0.set_border(V)
    x_ref, res_ref = S0.apply_inverse(b)
    s_ref = S0._border_coeffs

    mesh = make_mesh(ndev)
    set_mesh(mesh)
    try:
        K2, P2, S = _build(32, 2, "Stokes-C", dist=True, maxiter=200)
        S.set_border(V)
        x, res = S.apply_inverse(b)
        assert S._dist is not None, "distributed path did not activate"
        assert getattr(S._dist.app, "prec_sm_flat_b", None) is not None
        s = S._border_coeffs
    finally:
        set_mesh(None)
    assert int(res.iters) == int(res_ref.iters)
    xn, xr = np.asarray(x), np.asarray(x_ref)
    scale = np.abs(xr).max()
    assert np.abs(xn - xr).max() / scale < 1e-6
    assert np.abs(np.asarray(s) - np.asarray(s_ref)).max() < 1e-6 * scale


@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_dist_deflated_solve(ndev):
    """Distributed deflated solve: the deflation projectors run as
    sharded dots (GSPMD psum) around the halo operator/V-cycle —
    same converged solution as the replicated deflated solve
    (reference src/HYMLS_DeflatedSolver.cpp:159-245)."""
    from hymls.stencils.generators import _cross2d

    nx, eps = 32, 0.01
    K = -_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)

    def build(dist):
        params = Params({
            "Problem": {"Equations": "Laplace", "Dimension": 2,
                        "nx": nx, "ny": nx},
            "Solver": {"Krylov Method": "GMRES",
                       "Initial Vector": "Zero",
                       "Distributed Apply": dist,
                       "Deflated Subspace Dimension": 8,
                       "Iterative Solver": {"Maximum Iterations": 100,
                                            "Convergence Tolerance":
                                                1e-10}},
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": 2,
                               "Structured Apply": False},
        })
        tv = create_testvector(params, K)
        P = Preconditioner(K, params, testvector=tv).compute()
        S = Solver(K, P, params)
        S.setup_deflation()
        return S

    rng = np.random.default_rng(5)
    x_ex = rng.standard_normal(K.shape[0])
    b = K @ x_ex
    S0 = build(False)
    x_ref, _ = S0.apply_inverse(b)

    mesh = make_mesh(ndev)
    set_mesh(mesh)
    try:
        S = build(True)
        assert S._dist is not None, "distributed path did not activate"
        x, _ = S.apply_inverse(b)
    finally:
        set_mesh(None)
    xn = np.asarray(x)
    assert np.linalg.norm(xn - x_ex) / np.linalg.norm(x_ex) < 1e-7
    assert np.abs(xn - np.asarray(x_ref)).max() / \
        np.abs(np.asarray(x_ref)).max() < 1e-6


@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_dist_complex_solve(ndev):
    """Distributed complex solve: complex128 GMRES in the flat owner
    layout, A and B on independent ppermute ELL plans, the real
    V-cycle applied to Re/Im — iteration identity + solution parity
    vs the replicated complex solve (reference ComplexSolver runs
    over distributed Epetra vectors, src/HYMLS_ComplexSolver.hpp:41-46)."""
    import scipy.sparse as sp
    from hymls.solvers.complex_solver import ComplexSolver
    from hymls.stencils import laplace2d

    nx = 32
    A = laplace2d(nx, nx)
    B = sp.identity(A.shape[0], format="csr") * 0.5
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "GMRES",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": 2,
                           "Structured Apply": False},
    })
    tv = create_testvector(params, A)
    P0 = Preconditioner(A, params, testvector=tv).compute()
    rng = np.random.default_rng(11)
    z_ex = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(
        A.shape[0])
    b = A @ z_ex + 1j * (B @ z_ex)
    CS0 = ComplexSolver(A, P0, params, B=B)
    z_ref, res_ref = CS0.apply_inverse(b)

    params2 = params.copy()
    params2.sublist("Solver")["Distributed Apply"] = True
    mesh = make_mesh(ndev)
    set_mesh(mesh)
    try:
        P2 = Preconditioner(A, params2, testvector=tv).compute()
        CS = ComplexSolver(A, P2, params2, B=B)
        z, res = CS.apply_inverse(b)
        assert CS._dist is not None, "distributed path did not activate"
    finally:
        set_mesh(None)
    assert int(res.iters) == int(res_ref.iters)
    zn, zr = np.asarray(z), np.asarray(z_ref)
    rel = np.linalg.norm(zn - z_ex) / np.linalg.norm(z_ex)
    assert rel < 1e-8, rel
    assert np.abs(zn - zr).max() / np.abs(zr).max() < 1e-8


@pytest.mark.parametrize("ndev", NDEV_SWEEP)
def test_dist_complex_bordered_solve(ndev):
    """Distributed complex BORDERED solve (the ComplexBorderedSolver
    combination): augmented complex vectors in the owner layout, the
    m-tail replicated/psum'd — parity vs the replicated bordered
    complex solve (reference src/HYMLS_ComplexBorderedSolver)."""
    import scipy.sparse as sp
    from hymls.solvers.complex_solver import ComplexSolver
    from hymls.stencils import laplace2d

    nx = 32
    A = laplace2d(nx, nx)
    B = sp.identity(A.shape[0], format="csr") * 0.25
    n = A.shape[0]
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": nx, "ny": nx},
        "Solver": {"Krylov Method": "GMRES",
                   "Iterative Solver": {"Maximum Iterations": 150,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": 2,
                           "Structured Apply": False},
    })
    tv = create_testvector(params, A)
    rng = np.random.default_rng(13)
    V = rng.standard_normal((n, 1))
    V /= np.linalg.norm(V)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n))

    P0 = Preconditioner(A, params, testvector=tv).compute()
    CS0 = ComplexSolver(A, P0, params, B=B).set_border(V)
    z_ref, res_ref = CS0.apply_inverse(b)

    params2 = params.copy()
    params2.sublist("Solver")["Distributed Apply"] = True
    mesh = make_mesh(ndev)
    set_mesh(mesh)
    try:
        P2 = Preconditioner(A, params2, testvector=tv).compute()
        CS = ComplexSolver(A, P2, params2, B=B).set_border(V)
        z, res = CS.apply_inverse(b)
        assert CS._dist is not None, "distributed path did not activate"
    finally:
        set_mesh(None)
    assert int(res.iters) == int(res_ref.iters)
    zn, zr = np.asarray(z), np.asarray(z_ref)
    assert np.abs(zn - zr).max() / np.abs(zr).max() < 1e-8


def test_dist_fallback_unshardable():
    """With no active mesh the solver warns and falls back."""
    K, P, S = _build(16, 1, "Laplace", dist=True)
    b = np.ones(K.shape[0])
    with pytest.warns(UserWarning, match="Distributed Apply"):
        x, res = S.apply_inverse(b)
    assert S._dist is None and not S.distributed
    assert float(res.relres) < 1e-8


def _build_structured(dist, levels=2):
    """Stokes-C 32^2 with the structured gather-free apply ACTIVE —
    the benchmarked production configuration (BENCH path)."""
    params = Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 32, "ny": 32},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Distributed Apply": dist,
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": levels,
                           "Structured Apply": True},
    })
    K = create_matrix(params)
    tv = create_testvector(params, K)
    P = Preconditioner(K, params, testvector=tv)
    S = Solver(K, P, params)
    return K, P, S


def test_dist_structured_solve():
    """The structured (gather-free) production apply runs DISTRIBUTED
    through the plain Solver: GSPMD-sharded V-cycle inside the global
    GMRES — same iterations and solution as the replicated structured
    solve, with collective-permute traffic in the compiled program
    (reference: the one apply path is distributed unconditionally,
    src/HYMLS_Preconditioner.cpp:973-1052)."""
    K, P0, S0 = _build_structured(False)
    assert P0._structured is not None, "structured program must build"
    rng = np.random.default_rng(5)
    # consistent rhs: K has a constant-pressure null space, so a raw
    # random b leaves a large stagnating true residual that makes the
    # cross-path comparison meaningless
    b = K @ rng.standard_normal(K.shape[0])
    x_ref, res_ref = S0.apply_inverse(b)

    mesh = make_mesh(8)
    set_mesh(mesh)
    try:
        K2, P2, S = _build_structured(True)
        x, res = S.apply_inverse(b)
        assert getattr(S, "_dist_structured", None) is not None, \
            "structured GSPMD path did not activate"
        assert S._dist is None, \
            "structured path must not fall back to the halo V-cycle"
        factors = P2.apply_factors
        txt = S._solve_jit.lower(
            S.op.vals, factors, P2._aplans,
            jnp.asarray(b, S.dtype), jnp.zeros_like(
                jnp.asarray(b, S.dtype))).compile().as_text()
    finally:
        set_mesh(None)
    # the sharded apply matches the replicated one to ~1 ULP (f64
    # relative ~1e-15: XLA partitions the level einsums and pads/folds
    # in a different association); over 100+ GMRES iterations that
    # drifts the count by at most a couple — the same slack the
    # reference has across MPI rank counts, where SumAll reassociates
    # and the targets are upper bounds
    assert abs(int(res.iters) - int(res_ref.iters)) <= \
        max(2, int(res_ref.iters) * 0.03)
    xn, xr = np.asarray(x), np.asarray(x_ref)
    relres = np.linalg.norm(K @ xn - b) / np.linalg.norm(b)
    relres_ref = np.linalg.norm(K @ xr - b) / np.linalg.norm(b)
    assert relres <= relres_ref * (1 + 1e-6) + 1e-12
    assert re.search(r"collective-permute", txt), \
        "expected collective-permute traffic in the sharded solve"


def test_dist_structured_mixed_newton_step():
    """The fused mixed-precision Newton step with the STRUCTURED apply
    distributed (factor + repack + GSPMD-sharded V-cycle + IR loop in
    one program) — inner-iteration identity vs the replicated fused
    step."""
    from hymls.solvers.mixed import IterativeRefinementSolver

    def build(dist):
        params = Params({
            "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                        "nx": 32, "ny": 32},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": "Right",
                       "Distributed Apply": dist,
                       "Iterative Solver": {"Maximum Iterations": 200,
                                            "Convergence Tolerance":
                                                1e-10}},
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": 1,
                               "Structured Apply": True},
        })
        K = create_matrix(params)
        tv = create_testvector(params, K)
        S = IterativeRefinementSolver(K, params, testvector=tv)
        S.compute()
        assert S.precond._structured is not None
        return K, S

    K, S0 = build(False)
    rng = np.random.default_rng(0)
    b = K @ rng.standard_normal(K.shape[0])
    bj = jnp.asarray(b, jnp.float64)
    n0, dpl0, ex0, apl0 = S0.newton_step_fn()
    r0 = jax.device_get(n0(S0.op64.vals, S0.solver.op.vals, dpl0, ex0,
                           apl0, bj))

    mesh = make_mesh(8)
    set_mesh(mesh)
    try:
        K2, S = build(True)
        nfn, dpl, ex, apl = S.newton_step_fn()
        assert getattr(S, "_dist_structured", None) is not None, \
            "structured GSPMD path did not activate"
        r = jax.device_get(nfn(S.op64.vals, S.solver.op.vals, dpl, ex,
                               apl, bj))
        txt = nfn.lower(S.op64.vals, S.solver.op.vals, dpl, ex, apl,
                        bj).compile().as_text()
    finally:
        set_mesh(None)
    assert bool(r.converged)
    x = np.asarray(r.x)
    relres = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert relres <= 1e-10
    # ULP-level reassociation slack, see test_dist_structured_solve
    assert abs(int(r.iters) - int(r0.iters)) <= \
        max(2, int(r0.iters) * 0.03), \
        f"inner iters {int(r.iters)} vs replicated {int(r0.iters)}"
    assert re.search(r"collective-permute", txt), \
        "expected collective-permute traffic in the sharded Newton step"
