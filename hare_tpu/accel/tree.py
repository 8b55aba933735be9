"""Shared batched tree traversal for octree and KD-tree (lockstep form).

The reference traverses both trees with per-ray recursion replaced by an
explicit ``Stack<(node,tmin,tmax)>`` (``Octree - alt.cs:196-274``,
``KDTree.cs:204-361``).  A vmapped per-ray stack machine becomes a sea of
scalar conds and dynamic-index scatters, so both trees share this batched
redesign, mirroring the voxel grid's collect-then-test split (see
``voxel.py``):

Layout: one gather-row per node packs ALL K children component-major —
lane ``c*K + k`` holds component c of child k, components being
[min.xyz | max.xyz | child node id | leaf window start | leaf window
count].  K = 8 (octree) or 2 (KD-tree).  Leaf triangle lists live in the
shared packed window rows (``accel/common.pack_windows``).

Traversal: ALL rays run in lockstep; each iteration pops one node per ray
(one-hot select from the per-ray register stack — no dynamic scatters),
gathers its child row (the ONE per-iteration gather), slab-tests the K
children vectorized, appends hit leaf-children's window ranges to the
candidate buffer and pushes hit internal children.  When a ray's buffer
cannot take a node's leaf windows, the node is re-pushed and the ray
pauses; the outer round loop then runs the shared batched window test and
resumes paused rays with ``best_t`` pruning (child boxes with
``tmin > best_t`` are never pushed).  Every reachable leaf is visited at
most once, duplicate triangle tests are idempotent under min-t — results
are exact, with no mailboxing (SURVEY.md §2) and no ordering requirement.

Cost shaping (tuned on the earlier accelerator, not yet measured on the
H100):
  - Stack entries are ONE i32 — ``node_id << 8 | quantized_tmin`` — so
    every push/pop touches a single (N, S) array.  A parallel f32 tmin
    stack would double the dominant traffic (the K sequential (N, S) push
    selects).
  - ``tmin`` is quantized to 8 bits against the ray's root-slab span for
    pop-time pruning: ``q(tmin) > q(best_t)`` implies ``tmin > best_t``
    (floor quantization), so the prune is conservative and exact.
  - The pop/expand body runs UNROLL sub-steps per ``while`` iteration —
    the loop-exit check is a reduction to a scalar read by the loop.
  - Round-level straggler compaction (as in ``voxel.py``): lockstep cost
    is per-lane-step and KD pop counts are long-tailed (mean 43 / max 118
    pops on the bench scene), so unresolved rays are compacted into an
    NS-wide state and marched there instead of dragging all N lanes along.

Differences from the reference, by design:
  - ``closestT`` pruning (``Octree - alt.cs:210-211``) appears as pop-time
    quantized-tmin pruning plus round-level ``best_t`` pruning; the
    KD-tree's missing prune (SURVEY.md §2, "full subtree visited") is
    thereby fixed for both.
  - multi-topology works (``top_index`` filter at test time) instead of the
    reference's per-topology root overwrite defect (``KDTree.cs:71-87``,
    ``Octree - alt.cs:63-88``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geom.intersect import MIN_T
from ..geom.primitives import HitRecord, Ray
from ..mesh.scene import Scene
from .common import (
    finalize_hits,
    pack_windows,
    straggler_tiers,
    test_windows,
)

__all__ = [
    "TreeTables", "build_tree_tables", "collapse_levels", "shoot_tree",
]

# Child-row component blocks: minx,miny,minz,maxx,maxy,maxz,id,ws,nw
N_COMP = 9


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("node_rows", "win_data", "root_min", "root_max"),
    meta_fields=("branch", "max_depth", "row_width", "max_node_need"),
)
@dataclasses.dataclass(frozen=True)
class TreeTables:
    """Device tables for a K-ary spatial tree (octree K=8, KD-tree K=2)."""

    node_rows: jnp.ndarray  # (n_nodes + 1, row_width) f32 child-packed rows
    win_data: jnp.ndarray  # (n_windows + 1, 12*win) f32 shared window rows
    root_min: jnp.ndarray  # (3,) f32
    root_max: jnp.ndarray  # (3,) f32
    branch: int  # K
    max_depth: int
    row_width: int
    max_node_need: int  # max total leaf windows under any single node row

    @property
    def n_nodes(self) -> int:
        return self.node_rows.shape[0] - 1


def collapse_levels(
    child_ids: np.ndarray, root: int, levels: int
) -> np.ndarray:
    """Collapse ``levels`` tree levels into one supernode layer (host side).

    A K-ary tree becomes a K^levels-ary tree whose supernode children are
    the depth-``levels`` frontier under each kept node (stopping early at
    leaves).  Rationale: lockstep traversal cost is per POP step — every
    pop pays the (N, S) stack selects and the loop-step overhead for all N
    lockstep lanes — so a binary KD-tree (reference ``KDTree.cs``, split
    axis depth%3) pops ~3x fewer nodes when walked 3 levels at a time, and
    its child rows become as lane-dense as the octree's.  The reference has
    no counterpart (its per-ray CPU stack pops are nearly free); this is a
    layout transform, not a semantic change — boxes, leaf membership, and
    results are identical.

    Args:
      child_ids: (n, K) i64, -1 = missing; leaves have all -1.
      root: the tree root; only rows reachable from it are rewritten (the
        absorbed interior rows are simply never referenced again).
    Returns: new_child_ids (n, K^levels).
    """
    from collections import deque

    n, K = child_ids.shape
    KK = K ** levels
    is_leaf = (child_ids < 0).all(axis=1)
    new_children = np.full((n, KK), -1, np.int64)
    seen = np.zeros(n, bool)
    q = deque()
    if n and not is_leaf[root]:
        q.append(int(root))
        seen[root] = True
    while q:
        u = q.popleft()
        frontier = [u]
        for _ in range(levels):
            nxt = []
            for v in frontier:
                if is_leaf[v]:
                    nxt.append(v)
                else:
                    nxt.extend(int(c) for c in child_ids[v] if c >= 0)
            frontier = nxt
        new_children[u, : len(frontier)] = frontier
        for v in frontier:
            if not is_leaf[v] and not seen[v]:
                seen[v] = True
                q.append(v)
    return new_children


def build_tree_tables(
    tri: np.ndarray,
    tri_poly: np.ndarray,
    tri_top: np.ndarray,
    child_ids: np.ndarray,  # (n_nodes, K) i64, -1 = no child
    node_min: np.ndarray,  # (n_nodes, 3)
    node_max: np.ndarray,  # (n_nodes, 3)
    leaf_lists: list,  # per node: np.ndarray of triangle ids ([] for inner)
    root: int,
    max_depth: int,
) -> TreeTables:
    """Pack a host-built tree into the gather-row device layout.

    A pseudo-root row is prepended whose only child is ``root`` so the
    traversal can treat every node uniformly (pop -> expand children).
    """
    K = child_ids.shape[1]
    n = len(node_min)
    if n + 2 >= (1 << 23):
        raise ValueError(
            "tree exceeds 2^23 nodes; the traversal packs (node, qtmin) "
            "stack entries into one i32 (23-bit node field)"
        )
    counts = np.fromiter((len(l) for l in leaf_lists), np.int64, n)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    items = (
        np.concatenate([np.asarray(l, np.int64) for l in leaf_lists])
        if counts.sum()
        else np.zeros(0, np.int64)
    )
    win_data, win_start, n_wins = pack_windows(
        tri, tri_poly, tri_top, starts, counts, items
    )

    row_width = 32 if N_COMP * K <= 32 else 128
    # rows[i] describes node i's children; extra pseudo-root at index n.
    rows = np.zeros((n + 2, row_width), np.float32)

    # default: nonexistent children get id -1, nw 0, and an inverted box.
    neg1 = np.asarray(np.int32(-1)).view(np.float32)
    for c in range(3):
        rows[:, (0 + c) * K : (0 + c) * K + K] = np.inf  # min = +inf
        rows[:, (3 + c) * K : (3 + c) * K + K] = -np.inf  # max = -inf
    rows[:, 6 * K : 7 * K] = neg1
    rows[:, 7 * K : 8 * K] = 0.0
    rows[:, 8 * K : 9 * K] = 0.0

    # Vectorized fill over all real (parent, slot, child) edges, plus the
    # pseudo-root edge (n, 0, root) appended at the end.
    is_inner = (child_ids >= 0).any(axis=1)  # (n,)
    p_idx, k_idx = np.nonzero(child_ids >= 0)
    cids = child_ids[p_idx, k_idx]
    p_idx = np.concatenate([p_idx, [n]])
    k_idx = np.concatenate([k_idx, [0]])
    cids = np.concatenate([cids, [root]]).astype(np.int64)
    for c in range(3):
        rows[p_idx, c * K + k_idx] = node_min[cids, c]
        rows[p_idx, (3 + c) * K + k_idx] = node_max[cids, c]
    # child id only for internal nodes (-1 for leaves: nothing to push)
    rows[p_idx, 6 * K + k_idx] = np.where(
        is_inner[cids], cids, -1
    ).astype(np.int32).view(np.float32)
    rows[p_idx, 7 * K + k_idx] = win_start[cids].astype(np.int32).view(
        np.float32
    )
    rows[p_idx, 8 * K + k_idx] = n_wins[cids].astype(np.int32).view(
        np.float32
    )
    # rows[n+1] is the null row (all nonexistent children).

    # Worst single expansion: sum of leaf-children windows of one node row.
    need = np.zeros(n + 1, np.int64)
    np.add.at(need, p_idx, np.where(is_inner[cids], 0, n_wins[cids]))

    return TreeTables(
        node_rows=jnp.asarray(rows),
        win_data=jnp.asarray(win_data),
        root_min=jnp.asarray(node_min[root], jnp.float32),
        root_max=jnp.asarray(node_max[root], jnp.float32),
        branch=K,
        max_depth=max_depth,
        row_width=row_width,
        max_node_need=int(need.max(initial=0)),
    )


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "top_index", "with_stats", "cap", "march", "ordered",
    ),
)
def shoot_tree(
    scene: Scene,
    rays: Ray,
    tree: TreeTables,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
    cap: int = 8,
    march: int = 64,
    ordered: bool = False,
):
    """Nearest-hit query via lockstep collect-then-test tree traversal."""
    K = tree.branch
    # A single node expansion must always fit the buffer, else no progress.
    C = max(int(cap), tree.max_node_need)
    null_row = tree.win_data.shape[0] - 1
    pseudo_root = tree.n_nodes - 1  # build appends it after real nodes
    # DFS stack bound: each pop adds at most K-1 net entries.
    S = (K - 1) * (tree.max_depth + 2) + 4
    # Round bound: every round pops at least one node per active ray or
    # pauses with a strictly fuller buffer; nodes are finite.
    max_rounds = tree.n_nodes
    # KD bodies are cheap (2-wide child ops on a 22-slot stack) but pop
    # counts are high — deeper unroll amortizes the loop-exit sync.
    UNROLL = 4

    dtype = tree.win_data.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    o = jax.lax.stop_gradient(rays.origin)
    d = jax.lax.stop_gradient(rays.direction)
    ex = rays.exclude_poly
    N = o.shape[0]

    inv_d = 1.0 / jnp.where(d == 0, jnp.asarray(1e-30, dtype), d)  # (N, 3)

    # ---- 8-bit tmin quantization frame from the root slab: q is monotone
    # (floor), so q(a) > q(b) implies a > b and pruning on q is exact-safe.
    t_lo = jnp.full((N,), -jnp.inf, dtype)
    t_hi = jnp.full((N,), jnp.inf, dtype)
    for c in range(3):
        t1 = (tree.root_min[c] - o[:, c]) * inv_d[:, c]
        t2 = (tree.root_max[c] - o[:, c]) * inv_d[:, c]
        t_lo = jnp.maximum(t_lo, jnp.minimum(t1, t2))
        t_hi = jnp.minimum(t_hi, jnp.maximum(t1, t2))
    tq0 = jnp.maximum(t_lo, 0.0)
    span = jnp.maximum(t_hi - tq0, jnp.asarray(1e-20, dtype))
    inv_qs = 253.0 / span  # q in [0, 254]; 254 also covers +inf

    vzero = jnp.sum(o, axis=-1) * 0.0
    izero_v = vzero.astype(jnp.int32)
    izero = jnp.sum(izero_v)

    # Stack/buffer layout is K-dependent (tuned on the earlier accelerator,
    # not yet measured on the H100): for wide nodes (octree K=8) the
    # hot-loop state is S (and C) separate (n,) arrays, so no select works
    # on a narrow (n, S) minor dimension.  For BINARY trees the op-count of
    # the per-slot select chains outweighs that layout's gain, so K < 4
    # keeps the dense (n, S) one-hot form.
    SOA = K >= 4
    lanesS = jnp.arange(S, dtype=jnp.int32)[None, :]
    lanesC = jnp.arange(C, dtype=jnp.int32)[None, :]

    # Per-ray context rows; bundled so straggler rounds can gather a
    # compacted copy (mirrors voxel.py).
    rctx = (o, d, inv_d, ex, tq0, inv_qs)

    def quant(ctx, t):
        """(n,)/(n,K) t -> clipped 8-bit bucket in this ray's frame."""
        tq0_, inv_qs_ = ctx[4], ctx[5]
        if t.ndim == 2:
            tq0_, inv_qs_ = tq0_[:, None], inv_qs_[:, None]
        return jnp.clip(
            jnp.floor((t - tq0_) * inv_qs_), 0.0, 254.0
        ).astype(jnp.int32)

    def collect(ctx, stack, sp, active, best_t, steps_cap, min_active=0):
        """Pop/expand until stacks empty, buffers full, or steps_cap."""
        o_, d_, inv_d_, _, _, _ = ctx
        n = sp.shape[0]
        izv = sp * 0
        q_best = quant(ctx, best_t)

        def cond(s):
            n_run = jnp.sum(s[2].astype(jnp.int32))
            return (n_run > min_active) & (s[6] < steps_cap)

        def body(s):
            for _ in range(UNROLL):
                s = step(s)
            return s

        def step(s):
            stack, sp, running, buf, cnt, iters, steps = s
            # ---- pop (layout-dependent, see SOA above).
            if SOA:
                ent = izv
                for s_i in range(S):
                    ent = jnp.where(sp - 1 == s_i, stack[s_i], ent)
            else:
                top_oh = lanesS == (sp - 1)[:, None]
                ent = jnp.sum(jnp.where(top_oh, stack, 0), axis=1)
            nid = jax.lax.shift_right_logical(ent, 8)
            q_node = ent & 0xFF
            # Pop-time prune: a node entered beyond the best hit is
            # discarded without expansion (row gather -> null row).
            pruned = running & (q_node > q_best)
            row = tree.node_rows[
                jnp.where(running & ~pruned, nid, tree.n_nodes)
            ]

            # ---- vectorized K-child slab test from component blocks.
            blk = [row[:, c * K : (c + 1) * K] for c in range(N_COMP)]
            bmin = blk[0:3]
            bmax = blk[3:6]
            cid = jax.lax.bitcast_convert_type(blk[6], jnp.int32)
            ws = jax.lax.bitcast_convert_type(blk[7], jnp.int32)
            nw = jax.lax.bitcast_convert_type(blk[8], jnp.int32)

            t_lo = jnp.full((n, K), -jnp.inf, dtype)
            t_hi = jnp.full((n, K), jnp.inf, dtype)
            for c in range(3):
                t1 = (bmin[c] - o_[:, c : c + 1]) * inv_d_[:, c : c + 1]
                t2 = (bmax[c] - o_[:, c : c + 1]) * inv_d_[:, c : c + 1]
                t_lo = jnp.maximum(t_lo, jnp.minimum(t1, t2))
                t_hi = jnp.minimum(t_hi, jnp.maximum(t1, t2))
            tmin = jnp.maximum(t_lo, 0.0)
            hit = (t_hi >= tmin) & (t_hi >= 0.0) & (tmin <= best_t[:, None])

            leaf_hit = hit & (nw > 0)
            push_hit = hit & (cid >= 0)

            # ---- buffer capacity check: whole node expands or none of it.
            need = jnp.sum(jnp.where(leaf_hit, nw, 0), axis=1)
            fits = cnt + need <= C
            # Pruned pops consume no buffer; they always "expand" (to pop).
            expand = running & (fits | pruned)

            # ---- append leaf-children window ranges (layout-dependent).
            off = cnt
            for k in range(K):
                take = expand & leaf_hit[:, k]
                w_k = nw[:, k]
                if SOA:
                    base = ws[:, k] - off
                    for c in range(C):
                        sel = take & (off <= c) & (c < off + w_k)
                        buf = buf[:c] + (
                            jnp.where(sel, base + c, buf[c]),
                        ) + buf[c + 1:]
                else:
                    sel = take[:, None] & (lanesC >= off[:, None]) & (
                        lanesC < (off + w_k)[:, None]
                    )
                    buf = jnp.where(
                        sel, ws[:, k : k + 1] + (lanesC - off[:, None]), buf
                    )
                off = off + jnp.where(take, w_k, 0)
            cnt = jnp.where(expand, off, cnt)

            # ---- pop the node and push internal hit children as single
            # packed i32 entries (node << 8 | qtmin).
            sp = jnp.where(expand, sp - 1, sp)
            entk = jax.lax.shift_left(cid, 8) | quant(ctx, tmin)
            if ordered and K > 1:
                # Front-to-back push ordering (``ComputeTraversalOrder``,
                # ``Octree - alt.cs:286-306``).  The in-loop sort/shuffle
                # lost to the pops it saves on the earlier accelerator —
                # pop-time qtmin pruning above already captures most of the
                # benefit — so ordering is OFF by default and kept as a knob
                # for extremely divergence-heavy scenes (not yet measured
                # on the H100).
                key = jnp.where(push_hit, tmin, -jnp.inf)
                order = jnp.argsort(-key, axis=1)
                entk = jnp.take_along_axis(entk, order, 1)
                push_p = jnp.take_along_axis(push_hit, order, 1)
            else:
                push_p = push_hit

            # A straight ray crosses at most 4 octants of an 8-way split
            # (it crosses each axis plane at most once inside the node), so
            # the first P compacted pushes cover every ray except the
            # measure-zero family riding exactly on split planes (e.g. an
            # axis-aligned ray through the center).  Those overflow slots
            # are handled in a lax.cond arm that almost never executes —
            # the (n, S) stack selects are the dominant elementwise cost of
            # the whole traversal, so halving the always-on count matters.
            P = min(K, 4)

            def push_one(stack, sp, ent_s, do):
                if SOA:
                    stack = tuple(
                        jnp.where(do & (sp == s_i), ent_s, stack[s_i])
                        for s_i in range(S)
                    )
                else:
                    slot = do[:, None] & (lanesS == sp[:, None])
                    stack = jnp.where(slot, ent_s[:, None], stack)
                return stack, sp + do.astype(jnp.int32)

            if K <= P:
                for k in range(K):
                    stack, sp = push_one(
                        stack, sp, entk[:, k], expand & push_p[:, k]
                    )
            else:
                pos = jnp.cumsum(push_p.astype(jnp.int32), axis=1) - 1

                def push_slots(stack, sp, lo, hi):
                    for s in range(lo, hi):
                        oh = push_p & (pos == s)
                        ent_s = jnp.sum(jnp.where(oh, entk, 0), axis=1)
                        do = expand & jnp.any(oh, axis=1)
                        stack, sp = push_one(stack, sp, ent_s, do)
                    return stack, sp

                stack, sp = push_slots(stack, sp, 0, P)
                n_push = jnp.sum(push_p.astype(jnp.int32), axis=1)
                stack, sp = jax.lax.cond(
                    jnp.any(expand & (n_push > P)),
                    lambda st_sp: push_slots(*st_sp, P, K),
                    lambda st_sp: st_sp,
                    (stack, sp),
                )

            running = running & expand & (sp > 0)
            iters = iters + running.astype(jnp.int32)
            return (stack, sp, running, buf, cnt, iters, steps + 1)

        buf0 = (
            tuple(izv + null_row for _ in range(C))
            if SOA
            else jnp.full((n, C), null_row, jnp.int32) + izv[:, None]
        )
        init = (
            stack, sp, active & (sp > 0),
            buf0,
            izv,  # cnt (buffer fill)
            izv,  # iters
            jnp.sum(izv),  # steps (scalar)
        )
        stack, sp, running, buf, cnt, iters, _ = jax.lax.while_loop(
            cond, body, init
        )
        return stack, sp, jnp.stack(buf, axis=1) if SOA else buf, iters

    def test(ctx, buf, active, best_t, best_tri):
        o_, d_, ex_ = ctx[0], ctx[1], ctx[3]
        return test_windows(
            tree.win_data, buf, o_, d_, ex_, active, best_t, best_tri,
            min_t, top_index, kernel=kernel,
        )

    # Always-tested low buffer slots; the rest go under a lax.cond that
    # fires only when some ray actually filled them (the grid's TIER
    # pattern, voxel.py — previously trees tested ALL C slots every round,
    # paying full gather+test price for null slots whenever one fat node
    # expansion forced C = max_node_need large).
    TIER = min(max(1, int(cap) // 2), C)

    def run_round(ctx, stack, sp, active, best_t, best_tri, min_active=0):
        stack, sp, buf, it1 = collect(
            ctx, stack, sp, active, best_t, march, min_active
        )
        best_t, best_tri = test(ctx, buf[:, :TIER], active, best_t, best_tri)
        if C > TIER:
            best_t, best_tri = jax.lax.cond(
                jnp.any(buf[:, TIER] != null_row),
                lambda bt, btr: test(ctx, buf[:, TIER:], active, bt, btr),
                lambda bt, btr: (bt, btr),
                best_t,
                best_tri,
            )
        return stack, sp, best_t, best_tri, it1

    # ======== round 1: full width =========================================
    NS = min(N, max(2048, -(-N // 8)))  # compacted straggler width
    if SOA:
        stack0 = (izero_v + (pseudo_root << 8),) + tuple(
            izero_v for _ in range(S - 1)
        )
    else:
        stack0 = jnp.full((N, S), 0, jnp.int32) + izero_v[:, None]
        stack0 = jnp.where(lanesS == 0, pseudo_root << 8, stack0)
    sp0 = izero_v + 1
    done0 = izero_v < 0
    best_t0 = jnp.full((N,), jnp.inf, dtype) + vzero
    best_tri0 = jnp.full((N,), -1, jnp.int32) + izero_v
    stack, sp, best_t, best_tri, iters = run_round(
        rctx, stack0, sp0, ~done0, best_t0, best_tri0,
        NS if NS < N else 0,
    )
    done = done0 | (sp == 0)

    # ======== straggler rounds: COMPACTED width (shared machinery) =========
    # Lockstep pays for the worst lane and tree pop counts are long-tailed
    # (KD measured mean 43 / max 118 pops on the bench scene): unresolved
    # rays — stack included — ride the shared chained-compaction tiers
    # (accel/common.straggler_tiers).
    def round_s(ctx_s, st, msk, bt, btr):
        stack_s, sp_s = st
        stack_s, sp_s, bt, btr, it_s = run_round(
            ctx_s, stack_s, sp_s, msk, bt, btr
        )
        return (stack_s, sp_s), sp_s == 0, bt, btr, (it_s,)

    _, done, best_t, best_tri, _, (iters,) = straggler_tiers(
        round_s, rctx, (stack, sp), done, best_t, best_tri, (iters,),
        NS, max_rounds,
    )
    hits = finalize_hits(scene, rays, best_t, best_tri, kernel)
    if with_stats:
        return hits, iters
    return hits
