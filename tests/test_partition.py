import numpy as np

from hymls.config import Params
from hymls.grid import grid_from_params, VarType
from hymls.partition.cartesian import CartesianPartitioner, PartitionParams
from hymls.partition.hierarchical import build_hierarchy


def _setup(nx, eqn="Laplace", dim=2, sx=4, extra=None):
    prob = {"Equations": eqn, "Dimension": dim, "nx": nx, "ny": nx}
    if dim > 2:
        prob["nz"] = nx
    d = {"Problem": prob, "Preconditioner": {"Separator Length": sx}}
    if extra:
        d["Preconditioner"].update(extra)
    params = Params(d)
    g = grid_from_params(params)
    part = PartitionParams.from_params(params, g)
    cart = CartesianPartitioner(g, part)
    return g, part, cart


def test_laplace_8x8_groups():
    """Ground truth for the 2x2 subdomain layout (cf. the reference's
    unit-test expectations for OverlappingPartitioner)."""
    g, part, cart = _setup(8)
    assert cart.num_subdomains == 4
    sg0 = cart.get_groups(0)
    assert sorted(sg0.interior.tolist()) == [0, 1, 2, 8, 9, 10, 16, 17, 18]
    node_sets = [sorted(s.nodes.tolist()) for s in sg0.separators]
    assert [3, 11, 19] in node_sets       # right face
    assert [24, 25, 26] in node_sets      # top face
    assert [27] in node_sets              # corner
    # subdomain 3 (bottom-right): extended interior to the boundary
    sg3 = cart.get_groups(3)
    assert len(sg3.interior) == 16


def test_partition_covers_grid():
    """Interiors + unique separators partition the grid exactly."""
    for eqn, dim, nx in (("Laplace", 2, 16), ("Stokes-C", 2, 16),
                         ("Laplace", 3, 8)):
        g, part, cart = _setup(nx, eqn, dim)
        sds = [cart.get_groups(sd) for sd in range(cart.num_subdomains)]
        hier = build_hierarchy(sds)
        ints = hier.all_interior_nodes()
        seps = hier.all_separator_nodes()
        allg = np.concatenate([ints, seps])
        assert allg.size == g.num_nodes, (eqn, dim, allg.size, g.num_nodes)
        assert np.unique(allg).size == g.num_nodes


def test_stokes_retained_pressure():
    """Each subdomain retains exactly one pressure as a singleton group
    located at the subdomain origin (F-matrix preservation)."""
    g, part, cart = _setup(16, "Stokes-C")
    dof = 3
    for sd in range(cart.num_subdomains):
        x, y, z = cart.position(sd)
        want = 2 + dof * (x + g.nx * y)
        sg = cart.get_groups(sd)
        singles = [s.nodes[0] for s in sg.separators if s.nodes.size == 1
                   and s.nodes[0] % dof == 2]
        assert want in singles


def test_stokes_pressure_interior_on_faces():
    """Pressures on subdomain faces are interior (not separators)."""
    g, part, cart = _setup(16, "Stokes-C")
    dof = 3
    sg = cart.get_groups(0)  # subdomain at (0,0), faces at i=3 / j=3
    for s in sg.separators:
        for gid in s.nodes:
            if gid % dof == 2 and s.nodes.size > 1:
                raise AssertionError(
                    "pressure in a multi-node separator group")
    # face pressure (3,1) must be interior
    want = 2 + dof * (3 + g.nx * 1)
    assert want in sg.interior


def test_velocity_linking():
    """u and v groups on the same face share a type tag (eliminated
    together); reference link_velocities_ semantics."""
    g, part, cart = _setup(16, "Stokes-C")
    sds = [cart.get_groups(sd) for sd in range(cart.num_subdomains)]
    hier = build_hierarchy(sds)
    dof = 3
    sizes = [len(s) for s in hier.linked_sets]
    # interior faces carry (u,v) linked pairs
    pairs = [s for s in hier.linked_sets if len(s) == 2]
    assert pairs, "expected linked u/v face groups"
    for s in pairs:
        vars_ = {int(hier.groups[gi].nodes[0] % dof) for gi in s}
        assert vars_ <= {0, 1}


def test_next_level_parameters():
    _, part, _ = _setup(16)
    nxt = part.next_level()
    assert nxt.sx == part.sx * part.cx


def test_group_dedup_consistency():
    """A face shared by two subdomains appears once in the unique list
    and in both subdomains' group lists."""
    g, part, cart = _setup(8)
    sds = [cart.get_groups(sd) for sd in range(cart.num_subdomains)]
    hier = build_hierarchy(sds)
    # face [3,11,19] between sd0 and sd1
    for gi, grp in enumerate(hier.groups):
        if sorted(grp.nodes.tolist()) == [3, 11, 19]:
            users = [sd for sd in range(4) if gi in hier.sd_groups[sd]]
            assert users == [0, 1]
            break
    else:
        raise AssertionError("face group not found")
