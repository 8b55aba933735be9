"""Octree: host build + shared batched collect-then-test traversal.

A batched rebuild of the live octree (``Octree - alt.cs:22-308``):

Build (host NumPy, recursive but SAT-vectorized per node):
  - cubified padded root box (``:78-85``; without the ``max + min / 2``
    operator-precedence bug noted in SURVEY.md §2 — the center really is the
    center here),
  - 8-way split at the center, children padded by 0.1 % (``:91-138``),
  - triangles replicated into every overlapping child by the SAT test
    (``:118-130``), recursion stops at ``max_depth`` or
    ``max_tris_per_node`` (``:93``).
  - Child boxes/ids/leaf-window ranges are packed into the shared gather-row
    tree tables (``accel/tree.py``); leaf triangle lists into the shared
    packed window rows.

Traversal: :func:`hare_tpu.accel.tree.shoot_tree` — the batched lockstep
collect-then-test walk shared with the KD-tree; see that module for how the
reference's per-ray ``Stack<(node,tmin,tmax)>`` + ``closestT`` pruning
(``:196-274``) map onto whole-batch lockstep execution.  The reference's octree
mailbox is allocated but its stamp check is commented out
(``Octree - alt.cs:220-222``) — duplicate leaf tests are already idempotent
under the min-t reduction, which is exactly why mailboxing is dropped
everywhere (SURVEY.md §2).

Multi-topology: unlike the reference (which rebuilds and overwrites ``root``
per topology, serving only the last one — defect at ``:63-88``), all
topologies share one tree; ``top_index`` filters at test time.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import jax.numpy as jnp

from ..geom.intersect import MIN_T
from ..geom.tribox import tri_box_overlap
from ..mesh.scene import Scene
from ..mesh.topology import Topology
from .tree import TreeTables, build_tree_tables, shoot_tree

__all__ = ["Octree", "build_octree", "shoot_octree"]

# Alias: the octree device structure IS the shared tree-tables pytree.
Octree = TreeTables

CHILD_PAD = 1.001  # 0.1% child box padding (Octree - alt.cs:118-130)


def _extract(source):
    if isinstance(source, Scene):
        keep = np.asarray(source.tri_poly) != -2
        tri = np.asarray(jnp.stack(source.tri_vertices(), axis=1), np.float64)
        return (
            tri[keep],
            np.asarray(source.tri_poly)[keep],
            np.asarray(source.tri_top)[keep],
        )
    if isinstance(source, Topology):
        return (
            source.vertices[source.tri_v],
            source.tri_poly,
            np.zeros(source.n_tris, np.int32),
        )
    parts, pp, tt = [], [], []
    p_off = 0
    for ti, t in enumerate(source):
        parts.append(t.vertices[t.tri_v])
        pp.append(t.tri_poly + p_off)
        tt.append(np.full(t.n_tris, ti, np.int32))
        p_off += t.n_polys
    return np.concatenate(parts), np.concatenate(pp), np.concatenate(tt)


# Back-compat helper used by kdtree.py.
def _extract_tris(source) -> np.ndarray:
    return _extract(source)[0]


def auto_depth(
    n_tris: int, leaf: int, branch: int, slack: int, lo: int, hi: int
) -> int:
    """Right-size a tree depth to the scene: ``ceil(log_branch(ceil(n/leaf)))
    + slack``, clamped to [lo, hi].  Depth bounds the lockstep traversal's
    per-ray register stack S = (K-1)*(depth+2)+4, whose (N, S) selects are
    the dominant elementwise cost — an oversized fixed depth (8 on the
    1,608-tri concert hall) pays for stack slots no ray uses.  Shared by
    the octree and both KD builders so the heuristic cannot diverge."""
    full = max(1, -(-n_tris // max(leaf, 1)))
    return min(max(int(np.ceil(np.log(full) / np.log(branch))) + slack, lo), hi)


def build_octree(
    source: Union[Topology, Sequence[Topology], Scene],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 16,
    pad: float = 1e-3,
) -> Octree:
    """``max_depth=None`` right-sizes the depth to the scene via
    :func:`auto_depth` (depth 8 -> 4 on the concert hall leaves pops
    unchanged and shrinks the stack)."""
    tri, tri_poly, tri_top = _extract(source)
    if max_depth is None:
        max_depth = auto_depth(len(tri), max_tris_per_node, 8, 1, 2, 10)
    lo = tri.reshape(-1, 3).min(axis=0) - pad
    hi = tri.reshape(-1, 3).max(axis=0) + pad
    # Cubify on the max dimension (Octree - alt.cs:78-85), centered.
    c = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo).max()

    node_min, node_max = [c - half], [c + half]
    child_ids = [np.full(8, -1, np.int64)]
    leaf_lists: list = [np.zeros(0, np.int64)]

    stack = [(0, np.arange(len(tri)), 0)]
    while stack:
        nid, ids, depth = stack.pop()
        if depth >= max_depth or len(ids) <= max_tris_per_node:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        nmin, nmax = node_min[nid], node_max[nid]
        ctr = 0.5 * (nmin + nmax)
        for k in range(8):
            cmin = np.where([k & 4, k & 2, k & 1], ctr, nmin)
            cmax = np.where([k & 4, k & 2, k & 1], nmax, ctr)
            half_k = 0.5 * (cmax - cmin) * CHILD_PAD
            keep = tri_box_overlap(tri[ids], 0.5 * (cmin + cmax), half_k)
            cids = ids[keep]
            if len(cids) == 0:
                continue  # empty children do not exist in the tables
            cid = len(node_min)
            node_min.append(cmin)
            node_max.append(cmax)
            child_ids.append(np.full(8, -1, np.int64))
            leaf_lists.append(np.zeros(0, np.int64))
            child_ids[nid][k] = cid
            stack.append((cid, cids, depth + 1))
        if (child_ids[nid] < 0).all():
            leaf_lists[nid] = ids.astype(np.int64)  # nothing split out

    return build_tree_tables(
        tri,
        tri_poly,
        tri_top,
        np.stack(child_ids),
        np.stack(node_min),
        np.stack(node_max),
        leaf_lists,
        root=0,
        max_depth=max_depth,
    )


def shoot_octree(
    scene: Scene,
    rays,
    tree: Octree,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    **kw,
):
    """Nearest-hit via the shared batched tree traversal."""
    return shoot_tree(
        scene, rays, tree, kernel=kernel, min_t=min_t, top_index=top_index,
        **kw,
    )
