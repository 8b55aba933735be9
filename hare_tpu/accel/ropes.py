"""Stackless rope-based KD-tree traversal.

The lockstep KD machine (``accel/tree.py``) is a batched stack walk:
every pop pays K child slab tests plus push/pop selects over an (N, S)
packed register stack — and those stack selects are its dominant
elementwise cost (KD pops mean 43 / max 118 on the bench scene).  Ropes (Popov, Günther, Slusallek & Seidel 2007,
"Stackless KD-Tree Traversal for High Performance GPU Ray Tracing")
delete the stack entirely: each LEAF carries six face links ("ropes") to
the adjacent node across that face, so a ray walks leaf → exit face →
rope → short re-descent → next leaf, carrying only (node id, entry t,
position) as per-ray state.  The reference's own KD walk is the explicit
near/far stack this replaces (``KDTree.cs:204-361``).

Lockstep form (same collect-then-test architecture as ``voxel.py`` — one
16-32 lane row gather per step, window runs appended to a bounded buffer,
one big batched test per round, straggler compaction between rounds):

  - internal node step: one-level descent — compare the carried position
    against the split plane (ties broken by direction sign, so a position
    exactly ON the plane descends toward where the ray is headed);
  - leaf step: append the leaf's window run, compute the exit face by
    3-slab min, SNAP the exit-axis coordinate to the face plane exactly
    (the snapped point is bit-exactly on the neighbor's boundary, making
    the subsequent descent comparisons robust without epsilon nudges),
    follow the rope;
  - rope -1 = off the tree; ``t > best_t`` prunes resumed rays.

Rope targets are pushed down at build time to the deepest node fully
containing the shared face (the standard optimization), so re-descents
are short.  Straddling triangles are duplicated across leaves exactly as
the stack build does (``KDTree.cs:123-133``); duplicate tests stay
idempotent under the min-t reduction (no mailboxing, SURVEY.md §2).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..geom.intersect import MIN_T, ray_aabb
from ..geom.primitives import Ray
from ..mesh.scene import Scene
from ..mesh.topology import Topology
from .common import (
    finalize_hits,
    pack_windows,
    straggler_tiers,
    test_windows,
)
from .octree import _extract, auto_depth

__all__ = ["KDRopes", "build_kdtree_ropes", "shoot_kdtree_ropes"]

# Row lanes (32-wide; gather cost is per row, width-insensitive to 128):
#  0: (axis << 1) | is_leaf          (i32 bitcast)
#  1: split value                    (internal, f32)
#  2: child_lo   3: child_hi         (internal, i32 bitcast)
#  4-6: box min  7-9: box max        (leaf, f32)
# 10: win_start 11: n_wins           (leaf, i32 bitcast)
# 12-17: ropes[-x,+x,-y,+y,-z,+z]    (leaf, i32 bitcast; -1 = off tree)
ROW_W = 32
ENTRY_EPS = 1e-4


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("node_rows", "win_data", "root_min", "root_max"),
    meta_fields=("max_depth", "char_step", "max_leaf_wins", "n_tris"),
)
@dataclasses.dataclass(frozen=True)
class KDRopes:
    """Device KD-tree with per-leaf ropes.  Root is node 0; the LAST row
    (index -1) is the terminal row every finished ray parks on."""

    node_rows: jnp.ndarray  # (n_nodes + 1, ROW_W) f32
    win_data: jnp.ndarray  # (n_windows + 1, 12*win) f32 shared window rows
    root_min: jnp.ndarray  # (3,) f32
    root_max: jnp.ndarray  # (3,) f32
    max_depth: int
    char_step: float
    max_leaf_wins: int
    n_tris: int

    @property
    def n_nodes(self) -> int:
        return self.node_rows.shape[0] - 1


def build_kdtree_ropes(
    source: Union[Topology, Sequence[Topology], Scene],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 12,
    pad: float = 1e-3,
    win: Optional[int] = None,
    split: str = "sah",
) -> KDRopes:
    """KD build (same splitting semantics and ``split`` policies as
    ``build_kdtree`` — binned SAH by default, or the reference's
    depth%3 median-centroid splits with ``split="median"``; straddler
    duplication, ``KDTree.cs:90-139``) plus per-leaf rope assignment.
    ``max_depth=None`` right-sizes the depth (see build_kdtree)."""
    if split not in ("median", "sah"):
        raise ValueError(f"unknown split policy {split!r}")
    tri, tri_poly, tri_top = _extract(source)
    if max_depth is None:
        max_depth = auto_depth(len(tri), max_tris_per_node, 2, 2, 2, 22)
    lo = tri.min(axis=1)
    hi = tri.max(axis=1)
    centroid = tri.mean(axis=1)
    root_min = lo.min(axis=0) - pad
    root_max = hi.max(axis=0) + pad

    node_min, node_max = [root_min.copy()], [root_max.copy()]
    child_lo, child_hi = [-1], [-1]
    split_ax, split_val = [0], [0.0]
    leaf_lists: list = [np.zeros(0, np.int64)]

    stack = [(0, np.arange(len(tri)), 0)]
    while stack:
        nid, ids, depth = stack.pop()
        if depth >= max_depth or len(ids) <= max_tris_per_node:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        if split == "sah":
            from .kdtree import _sah_plane

            plane = _sah_plane(ids, lo, hi, node_min[nid], node_max[nid])
            if plane is None:
                leaf_lists[nid] = ids.astype(np.int64)
                continue
            ax, sv = plane
        else:
            ax = depth % 3
            sv = float(np.median(centroid[ids, ax]))
        go_left = lo[ids, ax] <= sv
        go_right = hi[ids, ax] >= sv
        lids, rids = ids[go_left], ids[go_right]
        if len(lids) == len(ids) and len(rids) == len(ids):
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        split_ax[nid], split_val[nid] = ax, sv
        for side, cids in ((0, lids), (1, rids)):
            cmin = node_min[nid].copy()
            cmax = node_max[nid].copy()
            (cmax if side == 0 else cmin)[ax] = sv
            cid = len(node_min)
            node_min.append(cmin)
            node_max.append(cmax)
            child_lo.append(-1)
            child_hi.append(-1)
            split_ax.append(0)
            split_val.append(0.0)
            leaf_lists.append(np.zeros(0, np.int64))
            if side == 0:
                child_lo[nid] = cid
            else:
                child_hi[nid] = cid
            stack.append((cid, cids, depth + 1))

    n = len(node_min)
    if n + 1 >= (1 << 23):
        raise ValueError("KD tree exceeds 2^23 nodes (packed-run i32 field)")
    c_lo = np.asarray(child_lo, np.int64)
    c_hi = np.asarray(child_hi, np.int64)
    s_ax = np.asarray(split_ax, np.int64)
    s_val = np.asarray(split_val, np.float32)
    is_leaf = c_lo < 0
    nmin = np.stack(node_min).astype(np.float32)
    nmax = np.stack(node_max).astype(np.float32)

    # ---- rope assignment: DFS handing each child its parent-side ropes,
    # with the split-plane sibling installed on the face it creates; at
    # leaves, each rope is pushed down to the deepest node fully
    # containing the shared face rectangle.
    def push_down(r: int, face_ax: int, face_side: int, fb_min, fb_max) -> int:
        while r >= 0 and not is_leaf[r]:
            ax, sv = int(s_ax[r]), float(s_val[r])
            if ax == face_ax:
                # Exiting through the leaf's HIGH face enters the target's
                # LOW side -> the lo child is face-adjacent (and vice versa).
                r = int(c_lo[r]) if face_side == 1 else int(c_hi[r])
            elif fb_max[ax] <= sv:
                r = int(c_lo[r])
            elif fb_min[ax] >= sv:
                r = int(c_hi[r])
            else:
                break
        return r

    ropes = np.full((n, 6), -1, np.int64)
    dfs = [(0, (-1, -1, -1, -1, -1, -1))]
    while dfs:
        nid, rp = dfs.pop()
        if is_leaf[nid]:
            for f in range(6):
                ropes[nid, f] = push_down(
                    rp[f], f // 2, f & 1, nmin[nid], nmax[nid]
                )
            continue
        ax = int(s_ax[nid])
        lo_rp = list(rp)
        hi_rp = list(rp)
        lo_rp[2 * ax + 1] = int(c_hi[nid])  # lo child's +ax neighbor
        hi_rp[2 * ax] = int(c_lo[nid])  # hi child's -ax neighbor
        dfs.append((int(c_lo[nid]), tuple(lo_rp)))
        dfs.append((int(c_hi[nid]), tuple(hi_rp)))

    # ---- pack leaf windows (groups = nodes; internal nodes count 0).
    counts = np.fromiter((len(l) for l in leaf_lists), np.int64, n)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    items = (
        np.concatenate([np.asarray(l, np.int64) for l in leaf_lists])
        if counts.sum()
        else np.zeros(0, np.int64)
    )
    win_data, win_start, n_wins = pack_windows(
        tri, tri_poly, tri_top, starts, counts, items,
        **({} if win is None else {"win": win}),
    )
    if n_wins.max(initial=0) >= (1 << 8):
        raise ValueError(
            "a KD leaf holds >=256 window rows — raise max_depth or lower "
            "max_tris_per_node (packed-run 8-bit width field)"
        )
    if len(win_data) - 1 >= (1 << 23):
        raise ValueError("window table exceeds 2^23 rows (packed-run field)")

    i32f = lambda a: np.asarray(a, np.int32).view(np.float32)
    rows = np.zeros((n + 1, ROW_W), np.float32)
    rows[:n, 0] = i32f((s_ax << 1) | is_leaf)
    rows[:n, 1] = s_val
    rows[:n, 2] = i32f(np.maximum(c_lo, -1))
    rows[:n, 3] = i32f(np.maximum(c_hi, -1))
    rows[:n, 4:7] = nmin
    rows[:n, 7:10] = nmax
    rows[:n, 10] = i32f(win_start)
    rows[:n, 11] = i32f(n_wins)
    rows[:n, 12:18] = i32f(ropes).reshape(n, 6)
    # Terminal row (index -1 wraps here): a leaf with no windows, an
    # unbounded box (t_exit = +inf) and all ropes -1 — finished rays park
    # on it and every masked step is the identity.
    rows[n, 0] = i32f(np.array(1))
    rows[n, 4:7] = -np.inf
    rows[n, 7:10] = np.inf
    rows[n, 10] = i32f(np.array(0))
    rows[n, 11] = i32f(np.array(0))
    rows[n, 12:18] = i32f(np.full(6, -1))

    ext = (root_max - root_min).min()
    return KDRopes(
        node_rows=jnp.asarray(rows),
        win_data=jnp.asarray(win_data),
        root_min=jnp.asarray(root_min, jnp.float32),
        root_max=jnp.asarray(root_max, jnp.float32),
        max_depth=max_depth,
        char_step=float(ext) / (2 ** min(max_depth, 16)),
        max_leaf_wins=int(n_wins.max(initial=0)),
        n_tris=len(tri),
    )


@partial(
    jax.jit,
    static_argnames=("kernel", "top_index", "with_stats", "cap", "march"),
)
def shoot_kdtree_ropes(
    scene: Scene,
    rays: Ray,
    tree: KDRopes,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
    cap: int = 16,
    march: int = 96,
):
    """Nearest-hit query: lockstep rope walk, collect-then-test.

    Same three-phase architecture as ``shoot_grid`` (see ``voxel.py`` for
    the memory-system rationale): phase 1 marches ALL rays in lockstep —
    ONE 32-lane node-row gather per step, leaf window runs appended as
    packed (start, width) i32s — phase 2 is one big batched window test,
    and unresolved rays (buffer overflow, march cap) resume through
    COMPACTED straggler rounds with ``best_t`` pruning.  ``march`` bounds
    phase-1 steps per round (a rope walk has no closed-form step bound;
    progress per round is guaranteed, so the round loop converges).

    With ``with_stats=True`` returns ``(HitRecord, iters, rounds, nrows)``.
    """
    null_row = tree.win_data.shape[0] - 1
    term = tree.n_nodes  # terminal node-row index
    C = max(int(cap), tree.max_leaf_wins, 1)
    K = max(C // 2, 1)
    UNROLL = 4
    p1_steps_max = -(-int(march) // UNROLL) * UNROLL
    max_rounds = 512

    dtype = tree.win_data.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    o = jax.lax.stop_gradient(rays.origin)
    d = jax.lax.stop_gradient(rays.direction)
    ex = rays.exclude_poly
    N = o.shape[0]

    inside = jnp.all((o >= tree.root_min) & (o <= tree.root_max), axis=-1)
    bhit, t_near, _ = ray_aabb(o, d, tree.root_min, tree.root_max)
    t0 = jnp.where(
        inside,
        0.0,
        jnp.where(
            bhit, jnp.maximum(t_near, 0.0) + ENTRY_EPS * tree.char_step, inf
        ),
    )
    valid_ray = jnp.isfinite(t0)

    ocmp = (o[:, 0], o[:, 1], o[:, 2])
    dcmp = (d[:, 0], d[:, 1], d[:, 2])
    safe_d = tuple(jnp.where(dc == 0, 1.0, dc) for dc in dcmp)
    inv_sd = tuple(1.0 / sd for sd in safe_d)
    rctx = (ocmp, dcmp, inv_sd, o, d, ex)

    t0c = jnp.where(valid_ray, t0, 0.0)
    pos0 = tuple(ocmp[c] + t0c * dcmp[c] for c in range(3))
    node0 = jnp.where(valid_ray, 0, term)

    vzero = jnp.sum(o, axis=-1) * 0.0
    izero_v = vzero.astype(jnp.int32)
    izero = jnp.sum(izero_v)
    lanes = jnp.arange(C, dtype=jnp.int32)[None, :]

    def collect(ctx, node, t_cur, pos, active, best_t, steps_cap,
                min_active=0):
        (ocmp, dcmp, inv_sd, _, _, _) = ctx
        izv = node * 0
        n = node.shape[0]

        def p1_cond(s):
            n_coll = jnp.sum(s[4].astype(jnp.int32))
            return (n_coll > min_active) & (s[9] < steps_cap)

        def p1_body(s):
            for _ in range(UNROLL):
                s = p1_step(s)
            return s

        def p1_step(s):
            (node, t_cur, pos, _, collecting, runs, cnt_c, cnt_w,
             iters, steps, paused) = s
            px, py, pz = pos
            row = tree.node_rows[node]  # the ONLY in-loop gather
            flags = jax.lax.bitcast_convert_type(row[:, 0], jnp.int32)
            leaf = (flags & 1) == 1
            ax = jax.lax.shift_right_logical(flags, 1)

            # ---- internal: one-level descent at the carried position.
            sv = row[:, 1]
            pa = jnp.where(ax == 0, px, jnp.where(ax == 1, py, pz))
            da = jnp.where(
                ax == 0, dcmp[0], jnp.where(ax == 1, dcmp[1], dcmp[2])
            )
            go_lo = (pa < sv) | ((pa == sv) & (da < 0))
            cl = jax.lax.bitcast_convert_type(row[:, 2], jnp.int32)
            ch = jax.lax.bitcast_convert_type(row[:, 3], jnp.int32)
            child = jnp.where(go_lo, cl, ch)

            # ---- leaf: window run append + rope exit.
            ws = jax.lax.bitcast_convert_type(row[:, 10], jnp.int32)
            w = jax.lax.bitcast_convert_type(row[:, 11], jnp.int32)
            need = leaf & (w > 0)
            # C >= max_leaf_wins, so an empty buffer always fits any one
            # leaf — no separate escape clause needed (unlike voxel.py's
            # collect, whose first clause uses the soft threshold < C).
            fits = (cnt_w + w <= C) & (cnt_c < K)
            take = collecting & need & fits
            packed = (ws << 8) | w
            runs = tuple(
                jnp.where(take & (cnt_c == k), packed, runs[k])
                for k in range(K)
            )
            cnt_c = cnt_c + take.astype(jnp.int32)
            cnt_w = cnt_w + jnp.where(take, w, 0)
            pause = collecting & need & ~fits
            paused = paused | pause

            # Exit slab: nearest forward boundary of the leaf box.
            t_ax, far_c = [], []
            for c, (pc_, dc) in enumerate(zip((px, py, pz), dcmp)):
                fc = jnp.where(dc > 0, row[:, 7 + c], row[:, 4 + c])
                t_c = jnp.where(
                    dc == 0, inf, (fc - ocmp[c]) * inv_sd[c]
                )
                far_c.append(fc)
                t_ax.append(t_c)
            t_exit = jnp.minimum(jnp.minimum(t_ax[0], t_ax[1]), t_ax[2])
            ex0 = t_ax[0] <= t_exit
            ex1 = ~ex0 & (t_ax[1] <= t_exit)
            ex2 = ~ex0 & ~ex1
            face = jnp.where(
                ex0,
                (dcmp[0] > 0).astype(jnp.int32),
                jnp.where(
                    ex1,
                    2 + (dcmp[1] > 0).astype(jnp.int32),
                    4 + (dcmp[2] > 0).astype(jnp.int32),
                ),
            )
            # 6-way rope select in the INT domain (an f32 select on bitcast
            # ids may canonicalize NaN payloads — see Scene.with_vertices).
            rope = jax.lax.bitcast_convert_type(row[:, 12], jnp.int32)
            for f in range(1, 6):
                rope = jnp.where(
                    face == f,
                    jax.lax.bitcast_convert_type(row[:, 12 + f], jnp.int32),
                    rope,
                )
            # New position: exact on the exit face (snapped), slab-t on the
            # other two axes.
            npx = jnp.where(ex0, far_c[0], ocmp[0] + t_exit * dcmp[0])
            npy = jnp.where(ex1, far_c[1], ocmp[1] + t_exit * dcmp[1])
            npz = jnp.where(ex2, far_c[2], ocmp[2] + t_exit * dcmp[2])

            move = collecting & ~pause
            adv = move & leaf  # t/pos advance only at leaf exits
            node = jnp.where(
                move, jnp.where(leaf, jnp.where(rope < 0, term, rope), child),
                node,
            )
            t_new = jnp.where(adv, t_exit, t_cur)
            pos = (
                jnp.where(adv, npx, px),
                jnp.where(adv, npy, py),
                jnp.where(adv, npz, pz),
            )
            off = move & leaf & (rope < 0)
            collecting = move & ~off & (t_new <= best_t)
            iters = iters + collecting.astype(jnp.int32)
            return (node, t_new, pos, t_cur, collecting, runs, cnt_c,
                    cnt_w, iters, steps + 1, paused)

        init = (
            node, t_cur, pos, t_cur, active,
            tuple(izv for _ in range(K)),
            izv, izv, izv, jnp.sum(izv), active & False,
        )
        out = jax.lax.while_loop(p1_cond, p1_body, init)
        (node, t_cur, pos, _, collecting, runs, _, _, iters, _, paused) = out
        paused = paused | collecting
        t_cap = jnp.where(paused, t_cur, jnp.inf)

        buf = jnp.full((n, C), null_row, jnp.int32) + izv[:, None]
        off = izv
        for k in range(K):
            wk = runs[k] & 0xFF
            wsk = jax.lax.shift_right_logical(runs[k], 8)
            sel = (lanes >= off[:, None]) & (lanes < (off + wk)[:, None])
            buf = jnp.where(sel, wsk[:, None] + (lanes - off[:, None]), buf)
            off = off + wk
        return node, t_cur, pos, buf, paused, t_cap, iters

    def test(ctx, buf, active, best_t, best_tri):
        o_, d_, ex_ = ctx[3], ctx[4], ctx[5]
        return test_windows(
            tree.win_data, buf, o_, d_, ex_, active, best_t, best_tri,
            min_t, top_index, kernel=kernel,
        )

    TIER = min(max(1, C // 2), C)
    NS = min(N, max(2048, -(-N // 8)))

    def run_round(ctx, node, t_cur, pos, active, best_t, best_tri,
                  min_active=0):
        node, t_cur, pos, buf, paused, t_cap, it1 = collect(
            ctx, node, t_cur, pos, active, best_t, p1_steps_max, min_active
        )
        nrows = jnp.sum((buf != null_row).astype(jnp.int32), axis=1)
        best_t, best_tri = test(ctx, buf[:, :TIER], active, best_t, best_tri)
        if C > TIER:
            best_t, best_tri = jax.lax.cond(
                jnp.any(buf[:, TIER] != null_row),
                lambda bt, btr: test(ctx, buf[:, TIER:], active, bt, btr),
                lambda bt, btr: (bt, btr),
                best_t,
                best_tri,
            )
        resolved = ~paused | (best_t <= t_cap)
        return node, t_cur, pos, resolved, best_t, best_tri, it1, nrows

    node, t_cur, pos = node0, t0c + vzero, pos0
    done = jnp.logical_not(valid_ray)
    best_t = jnp.full((N,), jnp.inf, dtype) + vzero
    best_tri = jnp.full((N,), -1, jnp.int32) + izero_v
    node, t_cur, pos, resolved, best_t, best_tri, iters, nrows = run_round(
        rctx, node, t_cur, pos, ~done, best_t, best_tri,
        NS if NS < N else 0,
    )
    done = done | resolved

    # Shared chained-compaction straggler machinery (accel/common.py).
    def round_s(ctx_s, st, msk, bt, btr):
        node_s, t_s, pos_s = st
        node_s, t_s, pos_s, res_s, bt, btr, it_s, nr_s = run_round(
            ctx_s, node_s, t_s, pos_s, msk, bt, btr
        )
        return (node_s, t_s, pos_s), res_s, bt, btr, (it_s, nr_s)

    _, done, best_t, best_tri, rounds, (iters, nrows) = straggler_tiers(
        round_s, rctx, (node, t_cur, pos), done, best_t, best_tri,
        (iters, nrows), NS, max_rounds,
    )
    hits = finalize_hits(scene, rays, best_t, best_tri, kernel)
    if with_stats:
        return hits, iters, rounds, nrows
    return hits
