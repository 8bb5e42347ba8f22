"""Skew-Cartesian partitioner ground-truth tests.

Ports the expectation arithmetic of the reference's unit tests
(reference testSuite/unit_tests/HYMLS_OverlappingPartitioner.cpp:
SkewLaplace2D 674-879, SkewStokes2D 882-1191) so the group structure
matches the reference exactly."""
import numpy as np
import pytest

from hymls.config import Params
from hymls.grid import grid_from_params
from hymls.partition.cartesian import PartitionParams
from hymls.partition.skew import SkewCartesianPartitioner
from hymls.partition.hierarchical import build_hierarchy


def _mk(nx, ny, eqn, sx):
    prob = {"Equations": eqn, "Dimension": 2, "nx": nx, "ny": ny}
    params = Params({"Problem": prob,
                     "Preconditioner": {"Separator Length": sx,
                                        "Coarsening Factor": 2,
                                        "Partitioner": "Skew Cartesian"}})
    g = grid_from_params(params)
    part = PartitionParams.from_params(params, g)
    return g, SkewCartesianPartitioner(g, part)


@pytest.mark.parametrize("nx,ny,sx", [(8, 8, 4), (16, 16, 4), (16, 8, 4),
                                      (16, 16, 8)])
def test_skew_partition_covers_grid(nx, ny, sx):
    for eqn in ("Laplace", "Stokes-C"):
        g, sk = _mk(nx, ny, eqn, sx)
        sds = [sk.get_groups(sd) for sd in range(sk.num_subdomains)]
        hier = build_hierarchy(sds)
        allg = np.concatenate([hier.all_interior_nodes(),
                               hier.all_separator_nodes()])
        assert allg.size == g.num_nodes, (eqn, allg.size, g.num_nodes)
        assert np.unique(allg).size == g.num_nodes


@pytest.mark.parametrize("nx,ny,sx", [(8, 8, 4), (16, 16, 4), (16, 16, 8)])
def test_skew_laplace_group_structure(nx, ny, sx):
    """Reference SkewLaplace2D expectations: separator groups are the
    45-degree diagonals of length osy-1 (stride nx+1 or nx-1) plus
    corner singletons; interior diamonds have the expected sizes."""
    g, sk = _mk(nx, ny, "Laplace", sx)
    osx = sx // 2
    osy = sx // 2
    nsx = nx // osx + 1
    nsy = ny // osy // 2
    nsl = nsx * nsy + nsx // 2
    npx = nx // sx
    per_row = 2 * npx + 1
    per_layer = 2 * npx * (ny // sx) + npx + ny // sx

    for gsd in range(sk.num_subdomains):
        Z = gsd // per_layer
        Y = ((gsd - Z * per_layer) // per_row) - 0.5
        X = float((gsd - Z * per_layer) % per_row)
        if X >= npx:
            X -= npx + 0.5
            Y += 0.5
        substart = int(sx * (X + Y * nx)) + (sx // 2 - 1)

        sg = sk.get_groups(gsd)
        # interior size
        right = gsd % nsx == nsx // 2 * 2
        bottom = gsd > (nsl - nsx // 2 - 1)
        left = gsd % nsx == nsx // 2
        top = gsd < nsx // 2
        n_int = len(sg.interior)
        if right:
            assert n_int == osx * osy, (gsd, n_int)
        elif bottom:
            assert n_int == osy * osx
        elif left or top:
            assert n_int == osy * osx - osx - (osx - 1)
        else:
            assert n_int == 2 * osx * osy - osx - (osx - 1)

        # separator groups: diagonals or corner singletons
        for s in sg.separators:
            n0 = int(s.nodes[0])
            if n0 in (substart + 1, substart + nx * osy - osy + 1):
                assert s.nodes.size == osy - 1
                assert np.all(np.diff(s.nodes) == nx + 1)
            elif n0 in (substart - 1, substart + nx * osy + osy - 1):
                assert s.nodes.size == osy - 1
                assert np.all(np.diff(s.nodes) == nx - 1)
            else:
                assert s.nodes.size == 1, (gsd, s.nodes.tolist())


@pytest.mark.parametrize("nx,ny,sx", [(8, 8, 4), (16, 16, 4)])
def test_skew_stokes_group_structure(nx, ny, sx):
    """Reference SkewStokes2D: velocity separator groups run along the
    45-degree diagonals (length osy or osy-1), pressures are retained
    singletons, total node count per subdomain matches."""
    g, sk = _mk(nx, ny, "Stokes-C", sx)
    dof = 3
    osx = sx // 2
    osy = sx // 2
    nsx = nx // osx + 1
    nsy = ny // osy // 2
    nsl = nsx * nsy + nsx // 2
    npx = nx // sx
    per_row = 2 * npx + 1
    per_layer = 2 * npx * (ny // sx) + npx + ny // sx

    for gsd in range(sk.num_subdomains):
        Z = gsd // per_layer
        Y = ((gsd - Z * per_layer) // per_row) - 0.5
        X = float((gsd - Z * per_layer) % per_row)
        if X >= npx:
            X -= npx + 0.5
            Y += 0.5
        substart = int(dof * sx * (X + Y * nx)) + dof * (sx // 2 - 1)
        somewhat_bottom = (gsd <= (nsl - nsx // 2 - 1)) and (gsd > nsl - nsx)

        sg = sk.get_groups(gsd)

        # number of groups (reference lines 958-975)
        num_groups = 8 + 4 + 1 + 1
        num_groups -= (gsd % nsx == nsx // 2 * 2) * 5
        num_groups -= (gsd > (nsl - nsx // 2 - 1)) * 7
        num_groups -= int(somewhat_bottom)
        num_groups -= (gsd % nsx == nsx // 2) * 7
        num_groups -= (gsd % nsx == 0)
        num_groups -= (gsd < nsx // 2) * 7
        num_groups -= (gsd >= nsx // 2 and gsd < nsx)
        if num_groups < 7:
            num_groups = 7
        assert len(sg.separators) == num_groups - 1, \
            (gsd, len(sg.separators), num_groups - 1)

        # interior sizes (reference lines 977-1099)
        n_int = len(sg.interior)
        if gsd % nsx == nsx // 2 * 2:
            assert n_int == osx * osy * 3 + osy + osy - 1 + somewhat_bottom
        elif gsd > (nsl - nsx // 2 - 1):
            assert n_int == osy * osx * 3 - 1 - osx
        elif gsd % nsx == nsx // 2:
            assert n_int == (osy * osx - osx - (osx - 1)) * 3 - 1
        elif gsd < nsx // 2:
            assert n_int == (osy * osx - osx - (osx - 1)) * 3 \
                + 2 * osx - 2 + osx - 1
        else:
            assert n_int == osy * osy * 2 * 3 - (osx + osx - 1) - 1 \
                - osx * 2 + somewhat_bottom

        # separator group shapes (reference lines 1102-1179)
        total = n_int
        for s in sg.separators:
            total += s.nodes.size
            n0 = int(s.nodes[0])
            d0 = n0 % dof
            if d0 != 0 and (abs(n0 - (substart + dof) - 0.5) < 1 or
                            abs(n0 - (substart + nx * osy * dof
                                      - osy * dof + dof) - 0.5) < 1):
                assert s.nodes.size == osy - 1
                assert np.all(np.diff(s.nodes) == dof * (nx + 1))
            elif d0 != 0 and (abs(n0 - (substart - dof) - 0.5) < 1 or
                              abs(n0 - (substart + nx * osy * dof
                                        + osy * dof - dof) - 0.5) < 1):
                assert s.nodes.size == osy - 1
                assert np.all(np.diff(s.nodes) == dof * (nx - 1))
            elif d0 == 0 and n0 in (
                    substart, substart + dof * (nx + 1),
                    substart + nx * osy * dof - osy * dof,
                    substart + nx * osy * dof - osy * dof + dof * (nx + 1)):
                if gsd % nsx == nsx // 2 * 2 and n0 == substart:
                    assert s.nodes.size == 1
                elif n0 in (substart + dof * (nx + 1),
                            substart + nx * osy * dof - osy * dof
                            + dof * (nx + 1)):
                    assert s.nodes.size == osy - 1
                else:
                    assert s.nodes.size == osy
                assert np.all(np.diff(s.nodes) == dof * (nx + 1)) \
                    or s.nodes.size <= 1
            elif d0 == 0 and n0 in (substart - dof,
                                    substart + nx * osy * dof
                                    + osy * dof - dof):
                if gsd % nsx == nsx // 2 or (gsd % nsx == 0
                                             and n0 == substart - dof):
                    assert s.nodes.size == osy - 1
                else:
                    assert s.nodes.size == osy
                assert np.all(np.diff(s.nodes) == dof * (nx - 1)) \
                    or s.nodes.size <= 1
            else:
                assert s.nodes.size == 1, (gsd, s.nodes.tolist())

        if num_groups == 14:
            assert total == osx * osy * 2 * 3 + (osx + osx + 1) + (osx + osx)


@pytest.mark.slow   # two full 64^2 skew solves (~38 s on 1 core)
def test_retain_nodes_improves_convergence():
    """stokes6-style: retaining extra nodes per separator at coarser
    levels improves multilevel convergence (reference 'Retain Nodes at
    Level k' parameters)."""
    import jax.numpy as jnp
    from hymls.stencils import create_matrix, create_testvector
    from hymls import Preconditioner, Solver
    nx = 64
    iters = {}
    for retain in (False, True):
        params = Params({
            "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                        "nx": nx, "ny": nx},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": "Right",
                       "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": 100,
                                            "Convergence Tolerance": 1e-6}},
            "Preconditioner": {"Partitioner": "Skew Cartesian",
                               "Separator Length": 4,
                               "Coarsening Factor": 2,
                               "Number of Levels": 3}})
        if retain:
            params.sublist("Preconditioner")["Retain Nodes at Level 1"] = 2
            params.sublist("Preconditioner")["Retain Nodes at Level 2"] = 4
        K = create_matrix(params)
        tv = create_testvector(params, K)
        P = Preconditioner(K, params, testvector=tv).compute()
        S = Solver(K, P, params)
        rng = np.random.default_rng(7)
        x_ex = rng.standard_normal(K.shape[0])
        pm = (np.arange(K.shape[0]) % 3) == 2
        x_ex[pm] -= x_ex[pm].mean()
        b = K @ x_ex
        x, res = S.apply_inverse(b)
        assert bool(res.converged)
        iters[retain] = int(res.iters)
    assert iters[True] < iters[False]


def test_skew_memoization_exact():
    """The translation-memoized get_groups must agree exactly with the
    direct computation for EVERY subdomain (2D and 3D grids)."""
    for dims, nx in [(2, 64), (3, 16)]:
        prob = {"Equations": "Stokes-C", "Dimension": dims,
                "nx": nx, "ny": nx}
        if dims == 3:
            prob["nz"] = nx
        params = Params({"Problem": prob,
                         "Preconditioner": {"Partitioner": "Skew Cartesian",
                                            "Separator Length": 4,
                                            "Number of Levels": 1}})
        grid = grid_from_params(params)
        part = PartitionParams.from_params(params, grid)
        sk = SkewCartesianPartitioner(grid, part)
        sk2 = SkewCartesianPartitioner(grid, part)
        for sd in sk.valid_subdomain_ids():
            a = sk.get_groups(sd)                 # memoized
            b = sk2._get_groups_impl(sd)          # direct
            assert np.array_equal(a.interior, b.interior), sd
            assert len(a.separators) == len(b.separators), sd
            for s1, s2 in zip(a.separators, b.separators):
                assert s1.type == s2.type, sd
                assert np.array_equal(s1.nodes, s2.nodes), sd
