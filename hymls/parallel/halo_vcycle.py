"""Neighbor-halo V-cycle: fully distributed level vectors with
`lax.ppermute` exchanges — no all-gathers on the level path.

This is the pod-scale apply.  The plain shard_map V-cycle
(`parallel/vcycle.py`) all-gathers the per-subdomain separator
contributions and the interior solution every level — O(N)/device
traffic.  The reference's whole parallel value is minimally-overlapping
neighbor communication (reference src/HYMLS_HierarchicalMap.cpp:197-244
builds the minimal-overlap import; HYMLS_Preconditioner.cpp:973-980
applies it), because separators couple only *adjacent* subdomains.

Here every level vector is distributed: each shard owns the interiors
of its contiguous block of subdomains plus the separator nodes whose
first (lowest-id) touching subdomain is local — the exact ownership
rule of the reference's non-overlapping map.  All cross-shard traffic
is point-to-point `lax.ppermute` of statically-built send lists:

  * separator partial sums (Export-with-Add): each shard sends the
    per-subdomain contributions that land on a neighbor's separators;
    the owner sums all contributions *in the serial order*, so the
    distributed apply is bit-identical to the single-device one.
  * Vsum routing: the fine owner of a Vsum sends its value to the
    coarse-level owner of the corresponding next-level node (and the
    reverse on the way up).
  * x2 halo (Import): owners broadcast solved separator values to the
    neighboring shards whose subdomains touch them.

Per-level traffic is O(boundary separators / device).  The only
collective left is one small `all_gather` of the coarsest rhs (the
reference equally gathers the coarse system onto few ranks —
HYMLS_BasePartitioner.cpp:588-683 rank deactivation).

The shard offsets needed (usually ±1, occasionally ±2 when a shard
owns less than one subdomain row) are discovered at plan-build time;
one ppermute per distinct offset.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

# TRUE-dtype block applies: a reduced-precision matmul pass degrades
# the V-cycle as a preconditioner (see core/structured)
_HI = jax.lax.Precision.HIGHEST
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.dense import dense_solve as _dense_solve


class UnshardableError(ValueError):
    """The problem's group structure cannot be owner-sharded over this
    many devices (callers should fall back to the replicated apply)."""


# ---------------------------------------------------------------------------
# host-side plan construction
# ---------------------------------------------------------------------------

def _pad_lists(lists, fill):
    """Stack variable-length int lists to (len(lists), max_len)."""
    m = max((len(l) for l in lists), default=0)
    m = max(m, 1)
    out = np.full((len(lists), m), fill, dtype=np.int64)
    for i, l in enumerate(lists):
        out[i, :len(l)] = l
    return out


def _owner_of_seps(plan, own_sd):
    """Owner of each separator node = owner of its lowest touching
    subdomain (the reference's non-overlapping map rule)."""
    n_sep = plan.n_sep
    sd_ids, slot = np.nonzero(plan.sd_sep_mask)
    seps = plan.sd_sep_pos[sd_ids, slot]
    first = np.full(n_sep, own_sd.size, dtype=np.int64)
    np.minimum.at(first, seps, sd_ids)
    if np.any(first >= own_sd.size):
        raise UnshardableError("separator with no touching subdomain")
    return own_sd[first]


def _check_uniform(owner, pos, mask, what):
    """Every entity (reflector row / block) must live on one shard."""
    for i in range(pos.shape[0]):
        seps = pos[i][mask[i]]
        if seps.size and np.unique(owner[seps]).size > 1:
            raise UnshardableError(f"{what} {i} straddles shards")


@dataclass
class _Exchange:
    """One ppermute round per distinct shard offset."""
    offsets: List[int] = field(default_factory=list)
    send_idx: Dict[int, np.ndarray] = field(default_factory=dict)  # (ndev, L)


def _build_exchange(ndev, src_shard, dst_shard, local_idx, order_key):
    """Static send lists for value routing src_shard[i] -> dst_shard[i]
    of value local_idx[i] (index into the sender's local array).
    Receivers locate entries by their canonical rank within each
    (sender, offset) list, ordered by order_key.  Returns
    (_Exchange, pos_of(i) -> (offset, rank))."""
    d_all = dst_shard - src_shard
    offsets = sorted(set(int(d) for d in np.unique(d_all) if d != 0))
    ex = _Exchange(offsets=offsets)
    pos = {}
    for d in offsets:
        lists = [[] for _ in range(ndev)]
        sel = np.nonzero(d_all == d)[0]
        sel = sel[np.argsort(order_key[sel], kind="stable")]
        for i in sel:
            s = int(src_shard[i])
            pos[int(i)] = (d, len(lists[s]))
            lists[s].append(int(local_idx[i]))
        ex.send_idx[d] = _pad_lists(lists, -1)
    return ex, pos


def _finalize_sends(ex: _Exchange, sentinel: int):
    """Replace the -1 padding with the sender-side zero slot."""
    for d in ex.offsets:
        a = ex.send_idx[d]
        ex.send_idx[d] = np.where(a < 0, sentinel, a)
    return ex


def _recv_offsets_table(ex: _Exchange, base: int):
    """Start offset of each offset's recv buffer inside the concat
    [local (base), recv_{d0}, recv_{d1}, ..., zero]."""
    table, off = {}, base
    for d in ex.offsets:
        table[d] = off
        off += ex.send_idx[d].shape[1]
    return table, off          # off == position of the zero sentinel


def compute_ownership(plans, ndev: int):
    """Per-level ownership: (own_sd, own_sep, own_node, loc_of_node)
    lists — shared by the halo V-cycle and the distributed factor
    plans (parallel/dist_compute.py) so both sides agree on the
    owner-sharded layouts."""
    own_sd_l, own_sep_l, own_node_l, loc_of_node_l = [], [], [], []
    for l, plan in enumerate(plans):
        n_sd = plan.int_pos.shape[0]
        # ceil-blocked ownership: when a (coarse) level has fewer
        # subdomains than ndev*B, the trailing shards own nothing and
        # sit out the level — the analog of the reference's
        # coarse-level rank deactivation / communicator restriction
        # (HYMLS_BasePartitioner.cpp:588-683, SetDestinationPID;
        # EpetraExt_RestrictedCrsMatrixWrapper).  Under SPMD the idle
        # shards execute the same program on sentinel zeros; all
        # ppermute routes below are derived from own_sd and therefore
        # converge onto the active sub-mesh automatically.
        B = -(-n_sd // ndev)
        own_sd = np.arange(n_sd) // B
        own_sep = _owner_of_seps(plan, own_sd)
        own_node = np.empty(plan.n_nodes, dtype=np.int64)
        for sd in range(n_sd):
            ints = plan.int_pos[sd][plan.int_mask[sd]]
            own_node[ints] = own_sd[sd]
        own_node[plan.sep_pos_in_nodes] = own_sep
        # local position of each node within its owner's vector
        loc = np.empty(plan.n_nodes, dtype=np.int64)
        counts = np.zeros(ndev, dtype=np.int64)
        order = np.argsort(own_node, kind="stable")
        for n in order:
            loc[n] = counts[own_node[n]]
            counts[own_node[n]] += 1
        own_sd_l.append(own_sd)
        own_sep_l.append(own_sep)
        own_node_l.append(own_node)
        loc_of_node_l.append(loc)
    return own_sd_l, own_sep_l, own_node_l, loc_of_node_l


def build_halo_plans(precond, ndev: int):
    """Host-side construction of all per-shard static index plans.

    Returns (levels, coarse, meta): `levels` is a list of dicts of
    stacked (ndev, ...) numpy arrays (+ static offset lists in meta),
    `coarse` holds the coarse-stage maps, `meta` carries python-level
    statics (offsets per exchange, shapes)."""
    plans = precond.plans
    max_level = precond.max_level
    if max_level < 1:
        raise UnshardableError("halo V-cycle needs Number of Levels >= 1")
    cp = precond.coarse_plan

    levels = []
    meta = []

    # ownership per level (computed top-down; the coarse vector is the
    # last level's vsum set and stays with its fine owners)
    own_sd_l, own_sep_l, own_node_l, loc_of_node_l = \
        compute_ownership(plans, ndev)

    for l, plan in enumerate(plans):
        n_sd = plan.int_pos.shape[0]
        B = -(-n_sd // ndev)
        ni = plan.int_pos.shape[1]
        ns = plan.sd_sep_pos.shape[1]
        own_sd = own_sd_l[l]
        own_sep = own_sep_l[l]
        own_node = own_node_l[l]
        loc = loc_of_node_l[l]
        n_sep = plan.n_sep

        _check_uniform(own_sep, plan.w_pos,
                       plan.w_pos < n_sep, "reflector")
        _check_uniform(own_sep, plan.blk_pos, plan.blk_mask, "block")

        max_onod = int(np.bincount(own_node, minlength=ndev).max())
        sent_in = max_onod                       # zero slot of in_ext

        own_seps = [np.nonzero(own_sep == s)[0] for s in range(ndev)]
        max_osep = max(max(len(a) for a in own_seps), 1)
        o_of_sep = np.full(n_sep, -1, dtype=np.int64)
        for s in range(ndev):
            o_of_sep[own_seps[s]] = np.arange(len(own_seps[s]))

        d = {}
        # --- interiors -------------------------------------------------
        ip = np.full((ndev, B, ni), sent_in, dtype=np.int64)
        for sd in range(n_sd):
            s, j = own_sd[sd], sd % B
            m = plan.int_mask[sd]
            ip[s, j, m] = loc[plan.int_pos[sd][m]]
        d["int_pos_loc"] = ip

        osl = np.full((ndev, max_osep), sent_in, dtype=np.int64)
        for s in range(ndev):
            osl[s, :len(own_seps[s])] = \
                loc[plan.sep_pos_in_nodes[own_seps[s]]]
        d["own_sep_in_loc"] = osl

        # --- separator contribution exchange ---------------------------
        # sep_from_sd rows list flat (sd*ns+slot) sources ascending-sd;
        # keep exactly that order for a bit-identical padded sum.
        sfs = plan.sep_from_sd
        max_c = sfs.shape[1]
        valid = sfs < n_sd * ns
        rows, cols = np.nonzero(valid)
        srcs = sfs[rows, cols]
        src_sd = srcs // ns
        src_sh = own_sd[src_sd]
        dst_sh = own_sep[rows]
        local_flat = srcs - src_sh * (B * ns)
        # canonical receiver order: (sep id, contribution col)
        okey = rows * max_c + cols
        ex_y2, pos_y2 = _build_exchange(ndev, src_sh, dst_sh,
                                        local_flat, okey)
        _finalize_sends(ex_y2, B * ns)
        rtab, zslot = _recv_offsets_table(ex_y2, B * ns)
        sg = np.full((ndev, max_osep, max_c), zslot, dtype=np.int64)
        for i in range(rows.size):
            sep, c = rows[i], cols[i]
            s = dst_sh[i]
            p = o_of_sep[sep]
            if src_sh[i] == s:
                sg[s, p, c] = local_flat[i]
            else:
                dd, rank = pos_y2[int(i)]
                sg[s, p, c] = rtab[dd] + rank
        d["sep_gather"] = sg
        for dd in ex_y2.offsets:
            d[f"y2_send_{dd}"] = ex_y2.send_idx[dd]

        # --- orthogonal transform on owned reflectors -------------------
        n_refl, gmax = plan.w_pos.shape
        refl_owner = np.full(n_refl, -1, dtype=np.int64)
        for i in range(n_refl):
            seps = plan.w_pos[i][plan.w_pos[i] < n_sep]
            if seps.size:
                refl_owner[i] = own_sep[seps[0]]
        wrows = [np.nonzero(refl_owner == s)[0] for s in range(ndev)]
        max_refl = max(max(len(a) for a in wrows), 1)
        wv = np.zeros((ndev, max_refl, gmax))
        wp = np.full((ndev, max_refl, gmax), max_osep, dtype=np.int64)
        r_of = np.full(n_refl, -1, dtype=np.int64)
        for s in range(ndev):
            for k, i in enumerate(wrows[s]):
                r_of[i] = k
                wv[s, k] = plan.w_vals[i]
                m = plan.w_pos[i] < n_sep
                wp[s, k, m] = o_of_sep[plan.w_pos[i][m]]
        d["w_vals_loc"] = wv
        d["w_pos_loc"] = wp
        oi = np.full((ndev, max_osep), max_refl * gmax, dtype=np.int64)
        orw = np.full((ndev, max_osep), max_refl, dtype=np.int64)
        wr, wc = np.nonzero(plan.w_pos < n_sep)
        for i in range(wr.size):
            sep = plan.w_pos[wr[i], wc[i]]
            s, p = own_sep[sep], o_of_sep[sep]
            oi[s, p] = r_of[wr[i]] * gmax + wc[i]
            orw[s, p] = r_of[wr[i]]
        d["ot_inv_idx_loc"] = oi
        d["ot_row_of_loc"] = orw

        # --- non-Vsum blocks -------------------------------------------
        n_blk, mb = plan.blk_pos.shape
        bown = np.full(n_blk, -1, dtype=np.int64)
        for i in range(n_blk):
            seps = plan.blk_pos[i][plan.blk_mask[i]]
            if seps.size:
                bown[i] = own_sep[seps[0]]
        bsets = [np.nonzero(bown == s)[0] for s in range(ndev)]
        max_blk = max(max(len(a) for a in bsets), 1)
        bsel = np.zeros((ndev, max_blk), dtype=np.int64)
        b_of = np.full(n_blk, -1, dtype=np.int64)
        bp = np.full((ndev, max_blk, mb), max_osep, dtype=np.int64)
        for s in range(ndev):
            for k, i in enumerate(bsets[s]):
                bsel[s, k] = i
                b_of[i] = k
                m = plan.blk_mask[i]
                bp[s, k, m] = o_of_sep[plan.blk_pos[i][m]]
        d["blk_pos_loc"] = bp
        bii = np.full((ndev, max_osep), max_blk * mb, dtype=np.int64)
        br, bc = np.nonzero(plan.blk_mask)
        for i in range(br.size):
            sep = plan.blk_pos[br[i], bc[i]]
            s, p = own_sep[sep], o_of_sep[sep]
            bii[s, p] = b_of[br[i]] * mb + bc[i]
        d["blk_inv_idx_loc"] = bii

        # --- vsums ------------------------------------------------------
        vsum_pos = plan.vsum_pos
        n_vs = vsum_pos.size
        vs_owner = own_sep[vsum_pos]
        ovs = [np.nonzero(vs_owner == s)[0] for s in range(ndev)]
        max_ovs = max(max(len(a) for a in ovs), 1)
        j_of_g = np.full(n_vs, -1, dtype=np.int64)
        vpl = np.full((ndev, max_ovs), max_osep, dtype=np.int64)
        for s in range(ndev):
            for k, g in enumerate(ovs[s]):
                j_of_g[g] = k
                vpl[s, k] = o_of_sep[vsum_pos[g]]
        d["vsum_pos_loc"] = vpl
        ovslot = np.full((ndev, max_osep), max_ovs, dtype=np.int64)
        for g in range(n_vs):
            s, p = vs_owner[g], o_of_sep[vsum_pos[g]]
            ovslot[s, p] = j_of_g[g]
        d["own_vsum_slot"] = ovslot

        lm = {"B": B, "ni": ni, "ns": ns, "max_osep": max_osep,
              "max_onod": max_onod, "max_ovs": max_ovs,
              "max_refl": max_refl, "gmax": gmax,
              "max_blk": max_blk, "mb": mb, "max_c": max_c,
              "y2_offsets": ex_y2.offsets, "y2_rtab": rtab,
              "blk_sel": None}
        lm["blk_sel"] = bsel
        # owned-sep slot -> global sep id (sentinel n_sep = zero row);
        # used to stack the bordered bW factor into the owner layout
        bwsel = np.full((ndev, max_osep), n_sep, dtype=np.int64)
        for s in range(ndev):
            bwsel[s, :len(own_seps[s])] = own_seps[s]
        lm["bw_sel"] = bwsel

        # --- next-level routing (down) + reverse (up) -------------------
        if l + 1 < max_level:
            own_nx = own_node_l[l + 1]
            loc_nx = loc_of_node_l[l + 1]
            dst = own_nx[np.arange(n_vs)]
            ex_nx, pos_nx = _build_exchange(
                ndev, vs_owner, dst, j_of_g, np.arange(n_vs))
            _finalize_sends(ex_nx, max_ovs)
            ntab, nz = _recv_offsets_table(ex_nx, max_ovs)
            max_onod_nx = int(np.bincount(own_nx, minlength=ndev).max())
            nig = np.full((ndev, max_onod_nx), nz, dtype=np.int64)
            for g in range(n_vs):
                s2, q = dst[g], loc_nx[g]
                if vs_owner[g] == s2:
                    nig[s2, q] = j_of_g[g]
                else:
                    dd, rank = pos_nx[g]
                    nig[s2, q] = ntab[dd] + rank
            d["next_in_gather"] = nig
            for dd in ex_nx.offsets:
                d[f"nx_send_{dd}"] = ex_nx.send_idx[dd]
            lm["nx_offsets"] = ex_nx.offsets

            # up: coarse owners send solved next-node values back
            max_onod_nxs = max_onod_nx            # sentinel slot
            ex_up, pos_up = _build_exchange(
                ndev, dst, vs_owner, loc_nx[np.arange(n_vs)],
                np.arange(n_vs))
            _finalize_sends(ex_up, max_onod_nxs)
            utab, uz = _recv_offsets_table(ex_up, max_onod_nxs)
            ug = np.full((ndev, max_ovs), uz, dtype=np.int64)
            for g in range(n_vs):
                s, j = vs_owner[g], j_of_g[g]
                if dst[g] == s:
                    ug[s, j] = loc_nx[g]
                else:
                    dd, rank = pos_up[g]
                    ug[s, j] = utab[dd] + rank
            d["up_gather"] = ug
            for dd in ex_up.offsets:
                d[f"up_send_{dd}"] = ex_up.send_idx[dd]
            lm["up_offsets"] = ex_up.offsets
            lm["max_onod_next"] = max_onod_nx

        # --- x2 halo (owners -> touchers) -------------------------------
        sd_ids, slot = np.nonzero(plan.sd_sep_mask)
        seps = plan.sd_sep_pos[sd_ids, slot]
        t_sh = own_sd[sd_ids]                     # toucher shard
        o_sh = own_sep[seps]                      # owner shard
        need = {}                                 # (owner, toucher) -> seps
        for i in range(seps.size):
            if t_sh[i] != o_sh[i]:
                need.setdefault((int(o_sh[i]), int(t_sh[i])),
                                set()).add(int(seps[i]))
        # one entry per (sep, dest shard): canonical order by sep id
        o_list, t_list, p_list, sep_list = [], [], [], []
        for (o, t), ss in sorted(need.items()):
            for sep in sorted(ss):
                o_list.append(o)
                t_list.append(t)
                p_list.append(int(o_of_sep[sep]))
                sep_list.append(sep)
        o_arr = np.asarray(o_list, dtype=np.int64)
        t_arr = np.asarray(t_list, dtype=np.int64)
        p_arr = np.asarray(p_list, dtype=np.int64)
        sep_arr = np.asarray(sep_list, dtype=np.int64)
        ex_x2, pos_x2 = _build_exchange(
            ndev, o_arr, t_arr, p_arr,
            sep_arr) if o_arr.size else (_Exchange(), {})
        _finalize_sends(ex_x2, max_osep)
        xtab, xz = _recv_offsets_table(ex_x2, max_osep)
        # where each (sep, toucher-shard) pair reads from
        read_of = {}
        for i in range(o_arr.size):
            dd, rank = pos_x2[int(i)]
            read_of[(int(sep_arr[i]), int(t_arr[i]))] = xtab[dd] + rank
        ssl = np.full((ndev, B, ns), xz, dtype=np.int64)
        for i in range(seps.size):
            sd, m, sep = sd_ids[i], slot[i], seps[i]
            s, j = own_sd[sd], sd % B
            if own_sep[sep] == s:
                ssl[s, j, m] = o_of_sep[sep]
            else:
                ssl[s, j, m] = read_of[(int(sep), int(s))]
        d["sd_sep_loc"] = ssl
        for dd in ex_x2.offsets:
            d[f"x2_send_{dd}"] = ex_x2.send_idx[dd]
        lm["x2_offsets"] = ex_x2.offsets

        # --- output assembly -------------------------------------------
        nsl = np.full((ndev, max_onod), B * ni + max_osep, dtype=np.int64)
        for n in range(plan.n_nodes):
            s, i = own_node[n], loc[n]
            src = plan.node_src[n]
            if src < n_sd * ni:                   # interior of sd
                sd, k = src // ni, src % ni
                nsl[s, i] = (sd % B) * ni + k
            elif src < n_sd * ni + n_sep:         # separator
                sep = src - n_sd * ni
                nsl[s, i] = B * ni + o_of_sep[sep]
        d["node_src_loc"] = nsl

        levels.append(d)
        meta.append(lm)

    # --- coarse stage ---------------------------------------------------
    last = meta[-1]
    lastp = plans[-1]
    vs_owner = own_sep_l[-1][lastp.vsum_pos]
    n_vs = lastp.vsum_pos.size
    max_ovs = last["max_ovs"]
    stacked_src = np.full(cp.n, ndev * max_ovs, dtype=np.int64)
    own_g = np.full((ndev, max_ovs), cp.n, dtype=np.int64)
    counts = np.zeros(ndev, dtype=np.int64)
    for g in range(n_vs):
        s = vs_owner[g]
        j = counts[s]
        counts[s] += 1
        stacked_src[g] = s * max_ovs + j
        own_g[s, j] = g
    coarse = {"stacked_src": stacked_src, "own_g_idx": own_g}

    # --- level-0 boundary maps ------------------------------------------
    own0, loc0 = own_node_l[0], loc_of_node_l[0]
    n0 = plans[0].n_nodes
    max_onod0 = meta[0]["max_onod"]
    scatter_idx = np.full((ndev, max_onod0), n0, dtype=np.int64)
    gather_idx = np.empty(n0, dtype=np.int64)
    for n in range(n0):
        scatter_idx[own0[n], loc0[n]] = n
        gather_idx[n] = own0[n] * max_onod0 + loc0[n]
    bmaps = {"scatter_idx": scatter_idx, "gather_idx": gather_idx,
             "n_nodes": n0, "max_onod0": max_onod0}

    return levels, coarse, meta, bmaps


# ---------------------------------------------------------------------------
# device-side apply
# ---------------------------------------------------------------------------

def _cat0(*parts):
    dtype = parts[0].dtype
    return jnp.concatenate([p.reshape(-1) for p in parts] +
                           [jnp.zeros((1,), dtype=dtype)])


def _ot_local(t, dp):
    """Owner-local Householder transform (same math as
    core.preconditioner._apply_ot on the owned-separator vector)."""
    w_vals, w_pos = dp["w_vals_loc"], dp["w_pos_loc"]
    t_ext = _cat0(t)
    dots = jnp.sum(w_vals * t_ext[w_pos], axis=1)
    dots_ext = _cat0(dots)
    w_flat_ext = _cat0(w_vals)
    return 2.0 * w_flat_ext[dp["ot_inv_idx_loc"]] * \
        dots_ext[dp["ot_row_of_loc"]] - t


class HaloApply:
    """Compiled distributed V-cycle with scatter/gather boundary
    helpers.  `apply_local(factors, plans, b_stacked) -> x_stacked`
    runs under shard_map; `__call__(b)` handles global <-> local."""

    def __init__(self, precond, mesh: Mesh):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        ndev = mesh.size
        levels, coarse, meta, bmaps = build_halo_plans(precond, ndev)
        self.meta = meta
        self._bmaps = bmaps
        self._coarse_src = jnp.asarray(coarse["stacked_src"])
        dtype = precond.dtype

        # stacked device plans (leading ndev axis, sharded)
        self.dplans = []
        for d in levels:
            dd = {}
            for k, v in d.items():
                dd[k] = jnp.asarray(
                    v, dtype=dtype if k == "w_vals_loc" else jnp.int32)
            self.dplans.append(dd)
        self.dplans[-1]["own_g_idx"] = jnp.asarray(coarse["own_g_idx"],
                                                   jnp.int32)

        # per-level block-selection indices for factor stacking
        self._bsel = [jnp.asarray(m["blk_sel"], jnp.int32) for m in meta]
        self.factors = self.stack_factors(
            precond._prune_factors(precond.factors))

        axis = self.axis
        max_level = precond.max_level
        metas = meta
        coarse_src = self._coarse_src

        def shift(x, d):
            perm = [(i, i + d) for i in range(ndev)
                    if 0 <= i + d < ndev]
            return jax.lax.ppermute(x, axis, perm)

        def exchange(vals_ext, dp, prefix, offsets):
            """ppermute one buffer per static offset; returns list of
            received buffers in offset order."""
            out = []
            for d in offsets:
                send = vals_ext[dp[f"{prefix}_send_{d}"]]
                out.append(shift(send, d))
            return out

        def level_fn(lev, b_loc, factors, dplans):
            lm = metas[lev]
            dp = dplans[lev]
            fac = factors["levels"][lev]
            dtype = b_loc.dtype

            in_ext = _cat0(b_loc)
            b1 = in_ext[dp["int_pos_loc"]]
            x1 = jnp.einsum("smn,sn->sm", fac["A11inv"], b1, precision=_HI)
            y2c = jnp.einsum("smn,sn->sm", fac["A21"], x1, precision=_HI)
            y2c_ext = _cat0(y2c)
            recvs = exchange(y2c_ext, dp, "y2", lm["y2_offsets"])
            cat = _cat0(y2c, *recvs) if recvs else _cat0(y2c)
            y2 = jnp.sum(cat[dp["sep_gather"]], axis=1)

            b2 = in_ext[dp["own_sep_in_loc"]]
            r2 = b2 - y2
            t = _ot_local(r2, dp)

            t_ext = _cat0(t)
            tb = t_ext[dp["blk_pos_loc"]]
            yb = jnp.einsum("smn,sn->sm", fac["blkinv"], tb, precision=_HI)
            y_blk = _cat0(yb)[dp["blk_inv_idx_loc"]]

            t_vs = t_ext[dp["vsum_pos_loc"]]
            if lev + 1 == max_level:
                allv = jax.lax.all_gather(t_vs, axis, tiled=True)
                rhs = _cat0(allv)[coarse_src]
                xc = _dense_solve(factors["coarse"], rhs)
                y_vs = _cat0(xc)[dp["own_g_idx"]]
            else:
                tve = _cat0(t_vs)
                nrecv = exchange(tve, dp, "nx", lm["nx_offsets"])
                ncat = _cat0(t_vs, *nrecv) if nrecv else tve
                b_next = ncat[dp["next_in_gather"]]
                x_next = level_fn(lev + 1, b_next, factors, dplans)
                xne = _cat0(x_next)
                urecv = exchange(xne, dp, "up", lm["up_offsets"])
                ucat = _cat0(x_next, *urecv) if urecv else xne
                y_vs = ucat[dp["up_gather"]]

            y = jnp.where(dp["own_vsum_slot"] < lm["max_ovs"],
                          _cat0(y_vs)[dp["own_vsum_slot"]], y_blk)
            x2 = _ot_local(y, dp)

            x2_ext = _cat0(x2)
            xrecv = exchange(x2_ext, dp, "x2", lm["x2_offsets"])
            xcat = _cat0(x2, *xrecv) if xrecv else x2_ext
            x2sd = xcat[dp["sd_sep_loc"]]
            x1 = x1 - jnp.einsum("smn,sn->sm", fac["G"], x2sd, precision=_HI)

            return _cat0(x1, x2)[dp["node_src_loc"]]

        n_coarse = self._coarse_src.shape[0]

        def level_fn_b(lev, b_loc, T, factors, dplans):
            """Bordered V-cycle level (reference bordered ApplyInverse,
            HYMLS_SchurPreconditioner.cpp:1517-1619): the border tail T
            (m,) is replicated; its per-level reductions q = T - W1'x1
            and the non-Vsum correction bW'y are shard-partial sums
            combined in ONE psum of an m-vector per level (the
            reference's SumAll of border coefficients,
            HYMLS_CoarseSolver.cpp:454-564).  Returns (x_loc, S)."""
            lm = metas[lev]
            dp = dplans[lev]
            fac = factors["levels"][lev]
            bb = fac["border"]

            in_ext = _cat0(b_loc)
            b1 = in_ext[dp["int_pos_loc"]]
            x1 = jnp.einsum("smn,sn->sm", fac["A11inv"], b1, precision=_HI)
            y2c = jnp.einsum("smn,sn->sm", fac["A21"], x1, precision=_HI)
            y2c_ext = _cat0(y2c)
            recvs = exchange(y2c_ext, dp, "y2", lm["y2_offsets"])
            cat = _cat0(y2c, *recvs) if recvs else _cat0(y2c)
            y2 = jnp.sum(cat[dp["sep_gather"]], axis=1)

            b2 = in_ext[dp["own_sep_in_loc"]]
            r2 = b2 - y2
            t = _ot_local(r2, dp)

            t_ext = _cat0(t)
            tb = t_ext[dp["blk_pos_loc"]]
            yb = jnp.einsum("smn,sn->sm", fac["blkinv"], tb, precision=_HI)
            y_blk = _cat0(yb)[dp["blk_inv_idx_loc"]]

            # border tail: Tc = T - sum(W1'x1) - sum(bW'y_blk), one psum
            q_part = jnp.einsum("sim,si->m", bb["W1"], x1, precision=_HI)
            c_part = jnp.einsum("pm,p->m", bb["bW"], y_blk, precision=_HI)
            Tc = T - jax.lax.psum(q_part + c_part, axis)

            t_vs = t_ext[dp["vsum_pos_loc"]]
            if lev + 1 == max_level:
                allv = jax.lax.all_gather(t_vs, axis, tiled=True)
                rhs = _cat0(allv)[coarse_src]
                sol = _dense_solve(factors["coarse"],
                                   jnp.concatenate([rhs, Tc]))
                xc, S = sol[:n_coarse], sol[n_coarse:]
                y_vs = _cat0(xc)[dp["own_g_idx"]]
            else:
                tve = _cat0(t_vs)
                nrecv = exchange(tve, dp, "nx", lm["nx_offsets"])
                ncat = _cat0(t_vs, *nrecv) if nrecv else tve
                b_next = ncat[dp["next_in_gather"]]
                x_next, S = level_fn_b(lev + 1, b_next, Tc,
                                       factors, dplans)
                xne = _cat0(x_next)
                urecv = exchange(xne, dp, "up", lm["up_offsets"])
                ucat = _cat0(x_next, *urecv) if urecv else xne
                y_vs = ucat[dp["up_gather"]]

            y = jnp.where(dp["own_vsum_slot"] < lm["max_ovs"],
                          _cat0(y_vs)[dp["own_vsum_slot"]], y_blk)
            x2 = _ot_local(y, dp)

            x2_ext = _cat0(x2)
            xrecv = exchange(x2_ext, dp, "x2", lm["x2_offsets"])
            xcat = _cat0(x2, *xrecv) if xrecv else x2_ext
            x2sd = xcat[dp["sd_sep_loc"]]
            x1 = x1 - jnp.einsum("smn,sn->sm", fac["G"], x2sd, precision=_HI) \
                - jnp.einsum("sim,m->si", bb["Q1"], S, precision=_HI)

            return _cat0(x1, x2)[dp["node_src_loc"]], S

        def _strip(factors, dplans):
            facs = {"levels": [
                jax.tree.map(lambda a: a[0], f)
                for f in factors["levels"]],
                "coarse": factors["coarse"]}
            dps = [jax.tree.map(lambda a: a[0], d) for d in dplans]
            return facs, dps

        def local_fn(factors, dplans, b_st):
            facs, dps = _strip(factors, dplans)
            return level_fn(0, b_st[0], facs, dps)[None]

        def local_fn_flat(factors, dplans, b_l):
            # flat (ndev*max_onod0,) vectors: each shard's slice is its
            # owner-local vector directly — the layout the distributed
            # Krylov loop (parallel/dist.py) iterates in
            facs, dps = _strip(factors, dplans)
            return level_fn(0, b_l, facs, dps)

        fspec = {"levels": [jax.tree.map(lambda _: P(axis), f)
                            for f in self.factors["levels"]],
                 "coarse": jax.tree.map(lambda _: P(),
                                        self.factors["coarse"])}
        pspec = [jax.tree.map(lambda _: P(axis), d)
                 for d in self.dplans]
        self._fspec, self._pspec = fspec, pspec
        self._fn = jax.jit(jax.shard_map(
            local_fn, mesh=mesh, in_specs=(fspec, pspec, P(axis)),
            out_specs=P(axis), check_vma=False))
        # raw shard_map callable (not jitted): composes inside a caller
        # jit such as the distributed GMRES loop
        self.prec_sm_flat = jax.shard_map(
            local_fn_flat, mesh=mesh, in_specs=(fspec, pspec, P(axis)),
            out_specs=P(axis), check_vma=False)

        self._fn_b = None
        if "border" in self.factors["levels"][0]:
            def local_fn_b(factors, dplans, b_st, T):
                facs, dps = _strip(factors, dplans)
                x, S = level_fn_b(0, b_st[0], T, facs, dps)
                return x[None], S

            def local_fn_b_flat(factors, dplans, b_l, T):
                facs, dps = _strip(factors, dplans)
                return level_fn_b(0, b_l, T, facs, dps)

            self._fn_b = jax.jit(jax.shard_map(
                local_fn_b, mesh=mesh,
                in_specs=(fspec, pspec, P(axis), P()),
                out_specs=(P(axis), P()), check_vma=False))
            self.prec_sm_flat_b = jax.shard_map(
                local_fn_b_flat, mesh=mesh,
                in_specs=(fspec, pspec, P(axis), P()),
                out_specs=(P(axis), P()), check_vma=False)
        self._scatter = jnp.asarray(bmaps["scatter_idx"], jnp.int32)
        self._gather = jnp.asarray(bmaps["gather_idx"], jnp.int32)

    def stack_factors(self, factors):
        """Stack pruned generic factors into the sharded (ndev, B, ...)
        halo layout.  Pure jnp (reshape/pad/static-gather), so it can
        run inside a caller's jit; per-subdomain arrays are zero-padded
        to ndev*B when a coarse level deactivates trailing shards
        (padded subdomains then compute exact zeros)."""
        ndev = self.mesh.size

        def _stack_sd(a, B):
            pad = ndev * B - a.shape[0]
            if pad:
                a = jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
            return a.reshape((ndev, B) + a.shape[1:])

        out = {"levels": [], "coarse": factors["coarse"]}
        for l, fac in enumerate(factors["levels"]):
            B = self.meta[l]["B"]
            blkinv = fac["blkinv"]
            if blkinv.shape[0] == 0:
                # a level with no non-Vsum blocks (e.g. 3D/skew coarse
                # levels where every separator is a Vsum): the apply
                # reads only sentinel slots, so zero blocks suffice
                bsel = self._bsel[l]
                blkinv = jnp.zeros(bsel.shape + blkinv.shape[1:],
                                   blkinv.dtype)
            else:
                blkinv = blkinv[self._bsel[l]]
            lev = {
                "A11inv": _stack_sd(fac["A11inv"], B),
                "G": _stack_sd(fac["G"], B),
                "A21": _stack_sd(fac["A21"], B),
                "blkinv": blkinv,
            }
            if "border" in fac:
                # bordered factors (reference ComputeBorder products):
                # Q1/W1 per-subdomain like A11inv; bW owner-sharded over
                # owned separators (zero row at the sentinel slot)
                bb = fac["border"]
                bW = bb["bW"]
                bW_ext = jnp.concatenate(
                    [bW, jnp.zeros((1, bW.shape[1]), bW.dtype)])
                lev["border"] = {
                    "Q1": _stack_sd(bb["Q1"], B),
                    "W1": _stack_sd(bb["W1"], B),
                    "bW": bW_ext[jnp.asarray(self.meta[l]["bw_sel"],
                                             jnp.int32)],
                }
            out["levels"].append(lev)
        return out

    def refresh_factors(self, precond):
        """Restack after a precond.compute()/recompute() (Newton-step
        value refresh; same plans/pattern)."""
        self.factors = self.stack_factors(
            precond._prune_factors(precond.factors))
        return self

    def place(self):
        """Device-put factors/plans with their shard_map shardings."""
        axis = self.axis

        def put(tree, spec_fn):
            return jax.tree.map(
                lambda x: jax.device_put(
                    x, NamedSharding(self.mesh, spec_fn(x))), tree)

        self.factors["levels"] = put(self.factors["levels"],
                                     lambda _: P(axis))
        self.dplans = put(self.dplans, lambda _: P(axis))
        return self

    def to_local(self, b):
        """Global vector -> stacked (ndev, max_onod0) owner layout."""
        return _cat0(jnp.asarray(b))[self._scatter]

    def to_global(self, x_stacked):
        """Stacked owner layout -> global vector."""
        return x_stacked.reshape(-1)[self._gather]

    def apply_local(self, b_stacked):
        return self._fn(self.factors, self.dplans, b_stacked)

    def __call__(self, b):
        return self.to_global(self.apply_local(self.to_local(b)))

    def apply_bordered(self, b, t):
        """Bordered apply [x; s] = M^{-1} [b; t] through the halo path
        (requires the preconditioner to have been computed with a
        border).  Returns (x_global, s)."""
        if self._fn_b is None:
            raise ValueError("preconditioner factors carry no border")
        x_st, S = self._fn_b(self.factors, self.dplans,
                             self.to_local(b), jnp.asarray(t))
        return self.to_global(x_st), S


def make_halo_apply(precond, mesh: Mesh) -> HaloApply:
    """Build the neighbor-halo distributed V-cycle apply for `precond`
    over `mesh`.  Raises UnshardableError when the subdomain counts do
    not divide the mesh (callers fall back to parallel.vcycle)."""
    return HaloApply(precond, mesh)
