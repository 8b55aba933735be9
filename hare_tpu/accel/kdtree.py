"""KD-tree: host median-split build + shared batched traversal.

A batched rebuild of ``KDTree.cs:23-633``:

Build (host NumPy):
  - plane placement: binned SAH with free axis choice by default
    (``split="sah"``), or the reference's semantics — axis cycling with
    depth (axis = depth mod 3, ``KDTree.cs:95``) and split value = median
    of member triangle centroids along the axis (``:98-105``) — with
    ``split="median"``,
  - triangles straddling the plane are duplicated into both children
    (``:123-133``; membership by triangle AABB vs child halfspace),
  - recursion stops at ``max_depth`` or ``max_tris_per_node`` (``:92``).
  - Child boxes are the parent box clamped at the split plane; boxes, child
    ids, and leaf-window ranges pack into the shared gather-row tree tables
    (``accel/tree.py``, K = 2).

Traversal: :func:`hare_tpu.accel.tree.shoot_tree` — the batched lockstep
collect-then-test walk shared with the octree.  The reference's explicit
near/far node stack (``:204-361``) never prunes against the current best
hit (SURVEY.md C20: "full subtree visited — conservative, correct,
slower"); the shared traversal adds round-level ``best_t`` pruning, so this
rebuild visits strictly fewer nodes.  Mailboxing (``:46-49, 224-229``) is
dropped — min-t reduction makes duplicate tests idempotent.

Multi-topology: one tree serves all topologies with ``top_index`` filtering
(the reference rebuilds and overwrites ``root`` per topology and actually
serves only the last — defect at ``KDTree.cs:71-87``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..geom.intersect import MIN_T
from ..mesh.scene import Scene
from ..mesh.topology import Topology
from .octree import _extract, auto_depth
from .tree import TreeTables, build_tree_tables, collapse_levels, shoot_tree

__all__ = ["KDTree", "build_kdtree", "shoot_kdtree"]

# Alias: the KD-tree device structure IS the shared tree-tables pytree.
KDTree = TreeTables


def _sah_plane(
    ids: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    nmin: np.ndarray,
    nmax: np.ndarray,
    n_bins: int = 32,
    traversal_cost: float = 1.0,
    isect_cost: float = 1.5,
    empty_bonus: float = 0.8,
):
    """Best binned-SAH split plane for one node, or ``None`` if no plane
    beats the leaf cost.

    Surface-area heuristic over ``n_bins - 1`` uniformly spaced candidate
    planes per axis: ``cost = Ct + Ci * (SA_L*NL + SA_R*NR) / SA_parent``
    with straddlers counted on both sides (matching the actual membership
    rule ``lo <= sv`` / ``hi >= sv``) and the standard ``empty_bonus``
    discount when one side is empty (empty-space cut-off).  Axis is chosen
    freely by cost — unlike the reference's depth%3 cycling
    (``KDTree.cs:95``) this adapts to anisotropic nodes."""
    n = len(ids)
    ext = nmax - nmin
    sa_parent = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
    if sa_parent <= 0.0:
        return None
    leaf_cost = isect_cost * n
    best = (leaf_cost, -1, 0.0)
    for ax in range(3):
        if ext[ax] <= 1e-12:
            continue
        planes = nmin[ax] + ext[ax] * (np.arange(1, n_bins) / n_bins)
        lo_s = np.sort(lo[ids, ax])
        hi_s = np.sort(hi[ids, ax])
        nl = np.searchsorted(lo_s, planes, side="right")
        nr = n - np.searchsorted(hi_s, planes, side="left")
        o = (ax + 1) % 3, (ax + 2) % 3
        girth = ext[o[0]] * ext[o[1]]
        rim = ext[o[0]] + ext[o[1]]
        d_l = planes - nmin[ax]
        sa_l = 2.0 * (girth + rim * d_l)
        sa_r = 2.0 * (girth + rim * (ext[ax] - d_l))
        cost = traversal_cost + isect_cost * (sa_l * nl + sa_r * nr) / sa_parent
        cost = np.where((nl == 0) | (nr == 0), cost * empty_bonus, cost)
        j = int(np.argmin(cost))
        if cost[j] < best[0]:
            best = (float(cost[j]), ax, float(planes[j]))
    if best[1] < 0:
        return None
    return best[1], best[2]


def build_kdtree(
    source: Union[Topology, Sequence[Topology], Scene],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 12,
    pad: float = 1e-3,
    levels: int = 1,
    split: str = "sah",
) -> KDTree:
    """Build the KD-tree (binary splits, straddler duplication,
    ``KDTree.cs:90-139``; plane placement per ``split`` below).

    ``levels > 1`` collapses that many binary levels into one supernode
    layer (``collapse_levels``) so each lockstep pop walks several levels.
    On the bench scene pops DO drop (43 -> 21 -> 15 mean at levels 1/2/3)
    but unlike a true octree the collapsed children are a BSP arrangement
    with per-subtree plane offsets, so a ray legally crosses >4 of 8
    supernode cells and the traversal's rare-overflow push arm becomes the
    common case — levels 2/3 lost end-to-end to binary on the earlier
    accelerator (not yet measured on the H100).  Default stays 1; the knob
    remains for non-adversarial shapes.

    ``max_depth=None`` right-sizes the depth to the scene via
    :func:`hare_tpu.accel.octree.auto_depth` (a smaller per-ray stack).

    ``split`` selects the plane-placement policy:

    - ``"sah"`` (default): binned surface-area-heuristic planes with free
      axis choice and empty-space cut-off (:func:`_sah_plane`); SAH also
      terminates a branch early when no plane beats the leaf cost, so trees
      are leaner where geometry is dense (bench scene: 7.3x fewer nodes
      than median leaf 12 at SAH leaf 4).  SAH cuts straddler duplication
      sharply, so the build is also faster.
    - ``"median"``: the reference's median-centroid split with depth%3 axis
      cycling (``KDTree.cs:95-105``), kept for parity studies."""
    if split not in ("median", "sah"):
        raise ValueError(f"unknown split policy {split!r}")
    tri, tri_poly, tri_top = _extract(source)
    if max_depth is None:
        max_depth = auto_depth(len(tri), max_tris_per_node, 2, 2, 2, 22)
    lo = tri.min(axis=1)  # (T, 3) per-tri AABB
    hi = tri.max(axis=1)
    centroid = tri.mean(axis=1)
    root_min = lo.min(axis=0) - pad
    root_max = hi.max(axis=0) + pad

    node_min, node_max = [root_min.copy()], [root_max.copy()]
    child_ids = [np.full(2, -1, np.int64)]
    leaf_lists: list = [np.zeros(0, np.int64)]

    stack = [(0, np.arange(len(tri)), 0)]
    while stack:
        nid, ids, depth = stack.pop()
        if depth >= max_depth or len(ids) <= max_tris_per_node:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        if split == "sah":
            plane = _sah_plane(ids, lo, hi, node_min[nid], node_max[nid])
            if plane is None:  # no plane beats the leaf cost
                leaf_lists[nid] = ids.astype(np.int64)
                continue
            ax, sv = plane
        else:
            ax = depth % 3  # KDTree.cs:95
            sv = float(np.median(centroid[ids, ax]))  # median centroid split
        go_left = lo[ids, ax] <= sv  # straddlers -> both (:123-133)
        go_right = hi[ids, ax] >= sv
        lids, rids = ids[go_left], ids[go_right]
        if len(lids) == len(ids) and len(rids) == len(ids):
            # Degenerate split (all straddle): make a leaf.
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        for side, cids in ((0, lids), (1, rids)):
            cmin = node_min[nid].copy()
            cmax = node_max[nid].copy()
            if side == 0:
                cmax[ax] = sv
            else:
                cmin[ax] = sv
            cid = len(node_min)
            node_min.append(cmin)
            node_max.append(cmax)
            child_ids.append(np.full(2, -1, np.int64))
            leaf_lists.append(np.zeros(0, np.int64))
            child_ids[nid][side] = cid
            stack.append((cid, cids, depth + 1))

    ch = np.stack(child_ids)
    eff_depth = max_depth
    if levels > 1:
        ch = collapse_levels(ch, root=0, levels=levels)
        eff_depth = -(-max_depth // levels)
    return build_tree_tables(
        tri,
        tri_poly,
        tri_top,
        ch,
        np.stack(node_min),
        np.stack(node_max),
        leaf_lists,
        root=0,
        max_depth=eff_depth,
    )


def shoot_kdtree(
    scene: Scene,
    rays,
    tree: KDTree,
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
