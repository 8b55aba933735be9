"""Watertightness: rays through shared edges must never fall into cracks.

The reference gets away with classic Möller–Trumbore because it computes in
f64 (``Hare_Geometry_Polygons.cs:385-510``); the f32 device kernels use the
Woop/Benthin/Wald 2013 watertight test as the default — its 2-D edge
functions have consistent signs across a shared edge, so exactly one (or
both, tie at the same t) of two adjacent triangles accepts any edge ray.
These tests aim rays *exactly* at shared-edge midpoints and vertices of a
closed icosphere and require zero misses through every accel backend.
"""

import numpy as np
import jax
import pytest

from hare_tpu.geom import Ray
from hare_tpu.accel import SpatialPartition
from hare_tpu.mesh import Topology, shapes


def _edge_targets(top):
    """Midpoints of every welded edge (guaranteed shared by >= 2 polys)."""
    v = top.vertices
    shared = np.array([len(p) >= 2 for p in top.edge_polys])
    e = top.edges[shared]
    return 0.5 * (v[e[:, 0]] + v[e[:, 1]])


@pytest.mark.parametrize("accel", ["brute", "grid", "octree", "kdtree"])
def test_edge_rays_no_cracks(accel):
    top = Topology.build(shapes.icosphere(3, radius=2.0))
    sp = SpatialPartition(top, accel=accel, kernel="watertight")
    mid = _edge_targets(top).astype(np.float32)
    n = len(mid)
    o = np.zeros((n, 3), np.float32)  # sphere center
    d = mid / np.linalg.norm(mid, axis=1, keepdims=True)
    hr = jax.tree.map(np.asarray, sp.shoot(Ray.make(o, d)))
    assert hr.hit.all(), f"{accel}: {int((~hr.hit).sum())}/{n} edge rays missed"
    # The hit must be on the faceted surface: chord midpoints sit slightly
    # inside the circumscribed sphere, so t is a bit below the radius.
    assert (hr.t <= 2.0 + 1e-3).all() and (hr.t >= 2.0 * 0.98).all()


@pytest.mark.parametrize("accel", ["brute", "grid"])
def test_vertex_rays_no_cracks(accel):
    """Rays exactly through welded vertices (the hardest corner case)."""
    top = Topology.build(shapes.icosphere(2, radius=1.5))
    sp = SpatialPartition(top, accel=accel, kernel="watertight")
    v = top.vertices.astype(np.float32)
    o = np.zeros((len(v), 3), np.float32)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    hr = jax.tree.map(np.asarray, sp.shoot(Ray.make(o, d)))
    assert hr.hit.all(), f"{int((~hr.hit).sum())}/{len(v)} vertex rays missed"
    np.testing.assert_allclose(hr.t, 1.5, rtol=2e-3)


def test_watertight_matches_mt_generic(rng):
    """Away from edges the two kernels agree on nearest hits."""
    top = Topology.build(shapes.concert_hall())
    a = SpatialPartition(top, accel="grid", kernel="mt", domain=8)
    b = SpatialPartition(top, accel="grid", kernel="watertight", domain=8)
    o = rng.uniform((2, 2, 1), (28, 48, 16), (128, 3)).astype(np.float32)
    d = rng.normal(0, 1, (128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Ray.make(o, d)
    ha = jax.tree.map(np.asarray, a.shoot(rays))
    hb = jax.tree.map(np.asarray, b.shoot(rays))
    # Generic rays: identical hit sets and distances.
    assert (ha.hit == hb.hit).mean() > 0.99
    both = ha.hit & hb.hit
    np.testing.assert_allclose(ha.t[both], hb.t[both], rtol=1e-4, atol=1e-5)
