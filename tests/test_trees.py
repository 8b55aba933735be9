"""Octree + KD-tree: build invariants and agreement with brute force."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hare_tpu.geom import Ray
from hare_tpu.accel import (
    build_kdtree,
    build_octree,
    shoot_brute,
    shoot_kdtree,
    shoot_octree,
)
from hare_tpu.mesh import Topology, build_scene, shapes


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def agree(sc, shoot_fn, o, d, ex=None, **kw):
    rays = Ray.make(
        jnp.asarray(o, jnp.float32),
        jnp.asarray(d, jnp.float32),
        None if ex is None else jnp.asarray(ex, jnp.int32),
    )
    hb = jax.tree.map(np.asarray, shoot_brute(sc, rays, **kw))
    ht = jax.tree.map(np.asarray, shoot_fn(sc, rays, **kw))
    np.testing.assert_array_equal(hb.hit, ht.hit)
    h = hb.hit
    np.testing.assert_allclose(hb.t[h], ht.t[h], rtol=1e-5, atol=1e-6)
    ties = np.abs(hb.t[h] - ht.t[h]) < 1e-5
    assert ((hb.tri_id[h] == ht.tri_id[h]) | ties).all()
    return hb, ht


# ------------------------------------------------------------------- builds
def _reachable_tris(tr):
    """All triangle ids reachable from the pseudo-root of a TreeTables."""
    K = tr.branch
    rows = np.asarray(tr.node_rows)
    wd = np.asarray(tr.win_data)
    from hare_tpu.accel.common import WIN
    tids = wd[:, 9 * WIN : 10 * WIN].view(np.int32)
    out = []
    stack = [tr.n_nodes - 1]  # pseudo-root row
    seen = set()
    while stack:
        nid = stack.pop()
        if nid in seen:
            continue
        seen.add(nid)
        row = rows[nid]
        cid = row[6 * K : 7 * K].view(np.int32)
        ws = row[7 * K : 8 * K].view(np.int32)
        nw = row[8 * K : 9 * K].view(np.int32)
        for k in range(K):
            if nw[k] > 0:
                ids = tids[ws[k] : ws[k] + nw[k]].ravel()
                out.extend(ids[ids >= 0].tolist())
            if cid[k] >= 0:
                stack.append(cid[k])
    return out


def test_octree_build():
    top = Topology.build(shapes.icosphere(2))
    tr = build_octree(top, max_depth=5, max_tris_per_node=8)
    assert tr.branch == 8
    assert tr.n_nodes >= 9  # root split at least once
    assert set(_reachable_tris(tr)) == set(range(top.n_tris))
    # child boxes lie inside the root box
    K = 8
    rows = np.asarray(tr.node_rows)
    rmin = np.asarray(tr.root_min)
    rmax = np.asarray(tr.root_max)
    mins = np.stack([rows[:, c * K : (c + 1) * K] for c in range(3)], -1)
    maxs = np.stack([rows[:, (3 + c) * K : (4 + c) * K] for c in range(3)], -1)
    real = np.isfinite(mins).all(-1)
    assert (mins[real] >= rmin - 1e-5).all() and (maxs[real] <= rmax + 1e-5).all()


def test_kdtree_build():
    top = Topology.build(shapes.concert_hall())
    # default: the reference's binary shape (level collapse loses for KD —
    # BSP supernode children break the <=4-crossed-cells push bound; see
    # build_kdtree docstring)
    tr = build_kdtree(top, max_depth=14, max_tris_per_node=12)
    assert tr.branch == 2
    assert set(_reachable_tris(tr)) == set(range(top.n_tris))
    assert tr.max_node_need >= 1
    # the collapsed variant stays available and covers the same triangles
    tr2 = build_kdtree(top, max_depth=14, max_tris_per_node=12, levels=3)
    assert tr2.branch == 8
    assert set(_reachable_tris(tr2)) == set(range(top.n_tris))
    # SAH (default) vs median (reference parity): both cover every triangle;
    # SAH's empty-space cut-off + cost-based termination yield fewer nodes.
    tr_m = build_kdtree(top, max_depth=14, max_tris_per_node=12, split="median")
    assert set(_reachable_tris(tr_m)) == set(range(top.n_tris))
    assert tr.n_nodes < tr_m.n_nodes


@pytest.mark.parametrize("split", ["median", "sah"])
@pytest.mark.parametrize("backend", ["kdtree", "kdtree_ropes"])
def test_kdtree_split_policies(rng, split, backend):
    """Both plane-placement policies x both KD traversals == brute force
    (the r5 SAH build must not change any hit, only the tree shape)."""
    from hare_tpu.accel.ropes import build_kdtree_ropes, shoot_kdtree_ropes

    top = Topology.build(shapes.random_soup(300, seed=17))
    sc = top.scene()
    if backend == "kdtree":
        tr = build_kdtree(top, max_tris_per_node=8, split=split)
        fn = lambda s, r, **kw: shoot_kdtree(s, r, tr, **kw)
    else:
        tr = build_kdtree_ropes(top, max_tris_per_node=8, split=split)
        fn = lambda s, r, **kw: shoot_kdtree_ropes(s, r, tr, **kw)
    o = rng.uniform(-1, 11, (300, 3))
    agree(sc, fn, o, rand_dirs(rng, 300))


# ---------------------------------------------------------------- agreement
@pytest.mark.parametrize("which", ["octree", "kdtree"])
def test_tree_agreement_room(rng, which):
    top = Topology.build(shapes.shoebox(4, 5, 3))
    sc = top.scene()
    if which == "octree":
        tr = build_octree(top, max_depth=4, max_tris_per_node=4)
        fn = lambda sc, rays, **kw: shoot_octree(sc, rays, tr, **kw)
    else:
        tr = build_kdtree(top, max_depth=8, max_tris_per_node=4)
        fn = lambda sc, rays, **kw: shoot_kdtree(sc, rays, tr, **kw)
    o = rng.uniform((0.2, 0.2, 0.2), (3.8, 4.8, 2.8), (300, 3))
    agree(sc, fn, o, rand_dirs(rng, 300))


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("which", ["octree", "kdtree"])
def test_tree_agreement_soup(rng, which, ordered):
    # ordered=True exercises the front-to-back argsort push path
    # (ComputeTraversalOrder analog, tree.py) — off by default but shipped
    # as a knob, so it must stay correct.
    top = Topology.build(shapes.random_soup(300, seed=17))
    sc = top.scene()
    if which == "octree":
        tr = build_octree(top, max_depth=6, max_tris_per_node=12)
        fn = lambda sc, rays, **kw: shoot_octree(
            sc, rays, tr, ordered=ordered, **kw
        )
    else:
        tr = build_kdtree(top, max_depth=12, max_tris_per_node=12)
        fn = lambda sc, rays, **kw: shoot_kdtree(
            sc, rays, tr, ordered=ordered, **kw
        )
    o = rng.uniform(-1, 11, (300, 3))
    agree(sc, fn, o, rand_dirs(rng, 300))


@pytest.mark.parametrize("which", ["octree", "kdtree"])
def test_tree_agreement_hall(rng, which):
    top = Topology.build(shapes.concert_hall())
    sc = top.scene()
    if which == "octree":
        tr = build_octree(top, max_depth=6, max_tris_per_node=16)
        fn = lambda sc, rays, **kw: shoot_octree(sc, rays, tr, **kw)
    else:
        tr = build_kdtree(top, max_depth=14, max_tris_per_node=16)
        fn = lambda sc, rays, **kw: shoot_kdtree(sc, rays, tr, **kw)
    o = rng.uniform((2, 2, 1), (28, 48, 16), (100, 3))
    agree(sc, fn, o, rand_dirs(rng, 100))


@pytest.mark.parametrize("scene_kind", ["room", "soup", "hall"])
def test_kdtree_ropes_agreement(rng, scene_kind):
    """Stackless rope traversal (accel/ropes.py) == brute force on every
    scene family; exercises leaf exits, rope re-descents, outside origins,
    and buffer-overflow resume rounds."""
    from hare_tpu.accel.ropes import build_kdtree_ropes, shoot_kdtree_ropes

    if scene_kind == "room":
        top = Topology.build(shapes.shoebox(4, 5, 3))
        o = rng.uniform((0.2, 0.2, 0.2), (3.8, 4.8, 2.8), (300, 3))
    elif scene_kind == "soup":
        top = Topology.build(shapes.random_soup(300, seed=17))
        o = rng.uniform(-1, 11, (300, 3))
    else:
        top = Topology.build(shapes.concert_hall())
        o = rng.uniform((2, 2, 1), (28, 48, 16), (200, 3))
    sc = top.scene()
    tr = build_kdtree_ropes(top, max_depth=12, max_tris_per_node=8)
    agree(sc, lambda s, r, **kw: shoot_kdtree_ropes(s, r, tr, **kw),
          o, rand_dirs(rng, len(o)))


def test_kdtree_ropes_exclusion_and_cap(rng):
    from hare_tpu.accel.ropes import build_kdtree_ropes, shoot_kdtree_ropes

    top = Topology.build(shapes.shoebox())
    sc = top.scene()
    tr = build_kdtree_ropes(top, max_depth=8, max_tris_per_node=4)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (50, 3)).astype(np.float32)
    d = rand_dirs(rng, 50).astype(np.float32)
    h0 = shoot_brute(sc, Ray.make(o, d))
    ex = np.stack([np.asarray(h0.poly_id), np.full(50, -1)], axis=1).astype(np.int32)
    h = shoot_kdtree_ropes(sc, Ray.make(o, d, ex), tr)
    hit = np.asarray(h.hit)
    assert (np.asarray(h.poly_id)[hit] != ex[hit, 0]).all()
    # tiny cap forces overflow-resume rounds; results must stay exact
    h2 = shoot_kdtree_ropes(sc, Ray.make(o, d), tr, cap=1, march=8)
    np.testing.assert_array_equal(np.asarray(h2.hit), np.asarray(h0.hit))
    m = np.asarray(h0.hit)
    np.testing.assert_allclose(
        np.asarray(h2.t)[m], np.asarray(h0.t)[m], rtol=1e-5
    )


def test_tree_exclusion(rng):
    top = Topology.build(shapes.shoebox())
    sc = top.scene()
    tr = build_octree(top, max_depth=4, max_tris_per_node=4)
    kd = build_kdtree(top, max_depth=8, max_tris_per_node=4)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (50, 3)).astype(np.float32)
    d = rand_dirs(rng, 50).astype(np.float32)
    h0 = shoot_brute(sc, Ray.make(o, d))
    ex = np.stack([np.asarray(h0.poly_id), np.full(50, -1)], axis=1).astype(np.int32)
    for fn in (
        lambda r: shoot_octree(sc, r, tr),
        lambda r: shoot_kdtree(sc, r, kd),
    ):
        h = fn(Ray.make(o, d, ex))
        hit = np.asarray(h.hit)
        assert (np.asarray(h.poly_id)[hit] != ex[hit, 0]).all()


def test_tree_multi_topology(rng):
    t1 = Topology.build(shapes.shoebox())
    t2 = Topology.build(shapes.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5)))
    sc = build_scene([t1, t2])
    tr = build_octree(sc, max_depth=5, max_tris_per_node=8)
    kd = build_kdtree(sc, max_depth=10, max_tris_per_node=8)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (80, 3))
    d = rand_dirs(rng, 80)
    agree(sc, lambda s, r, **kw: shoot_octree(s, r, tr, **kw), o, d)
    agree(sc, lambda s, r, **kw: shoot_kdtree(s, r, kd, **kw), o, d)
    agree(sc, lambda s, r, **kw: shoot_octree(s, r, tr, **kw), o, d, top_index=1)
    agree(sc, lambda s, r, **kw: shoot_kdtree(s, r, kd, **kw), o, d, top_index=1)
