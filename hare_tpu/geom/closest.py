"""Closest-point and distance queries (branch-free, differentiable).

Batched re-expression of the reference's proximity utilities:

- :func:`closest_point_triangle` <- ``Polygon.triclosestpoint``
  (``Hare_Geometry_Polygons.cs:62-114``): Voronoi-region closest point on a
  triangle (Ericson, Real-Time Collision Detection §5.1.5).  The reference's
  7-branch cascade becomes a mask cascade selecting the first matching
  region, identical numerics.
- :func:`sq_distance_to_edges` <- ``Polygon.SqDistanceToEdges``
  (``:116-145``).  NOTE: the reference's edge enumeration is buggy — it
  wraps with ``% (Length-1)`` so for a triangle it tests edges (0,1), (1,0),
  (2,1), duplicating one edge and skipping (2,0).  We implement the correct
  cyclic enumeration (i, i+1 mod n) and document the deviation.
- :func:`dist_to_plane` / :func:`closest_point_plane` <-
  ``Polygon.DistToPlane`` / ``ClosestPtPointPlane``
  (``Hare_Geometry_Polygons.cs:575-617``): signed distance uses the
  ``Inv_Dot_Normal`` normalization (1/|n|^2 in the reference's plane basis;
  for unit normals this is the plain signed distance).
- :func:`ray_side` <- ``Polygon.Ray_Side`` (``:589-606``): sign of
  direction·normal (exposed for parity; the branch-free two-sided MT kernel
  subsumes it in the hot path).
- :func:`closest_point_aabb` <- ``AABB.ClosestPt`` (``AABB_Tri_Int.cs:265-288``):
  per-axis clamp.
- :func:`closest_point_segment` <- ``Edge.closestpoint``
  (``Hare_Geometry_Primitives.cs:301-314``): clamped projection onto the
  segment.

All functions broadcast over leading batch dimensions and are pure jnp.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .math import cross, dot, norm

__all__ = [
    "closest_point_triangle",
    "closest_point_segment",
    "closest_point_aabb",
    "closest_point_plane",
    "dist_to_plane",
    "ray_side",
    "sq_distance_to_edges",
]


def closest_point_triangle(
    p: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray
) -> jnp.ndarray:
    """Closest point on triangle (a, b, c) to p — ``triclosestpoint``.

    The branchy Voronoi-region cascade (``Hare_Geometry_Polygons.cs:62-114``)
    evaluated as a first-match select chain: all seven candidate points are
    computed, then chosen by the same region predicates in the same order.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    eps = jnp.asarray(1e-30, p.dtype)

    # Region predicates, in the reference's order.
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    on_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)

    def safe_div(x, y):
        y = jnp.where(jnp.abs(y) > eps, y, 1.0)
        return x / y

    q_ab = a + safe_div(d1, d1 - d3)[..., None] * ab
    q_ac = a + safe_div(d2, d2 - d6)[..., None] * ac
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    q_bc = b + w_bc[..., None] * (c - b)
    denom = safe_div(jnp.ones_like(va), va + vb + vc)
    q_in = a + (vb * denom)[..., None] * ab + (vc * denom)[..., None] * ac

    # First-match select: apply in reverse so earlier regions win.
    out = q_in
    out = jnp.where(on_bc[..., None], q_bc, out)
    out = jnp.where(on_ac[..., None], q_ac, out)
    out = jnp.where(in_c[..., None], jnp.broadcast_to(c, out.shape), out)
    out = jnp.where(on_ab[..., None], q_ab, out)
    out = jnp.where(in_b[..., None], jnp.broadcast_to(b, out.shape), out)
    out = jnp.where(in_a[..., None], jnp.broadcast_to(a, out.shape), out)
    return out


def closest_point_segment(
    p: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """Closest point on segment [a, b] to p — ``Edge.closestpoint``
    (``Hare_Geometry_Primitives.cs:301-314``): projection clamped to [0, 1]."""
    ab = b - a
    denom = dot(ab, ab)
    t = jnp.where(denom > 0, dot(p - a, ab) / jnp.where(denom > 0, denom, 1.0), 0.0)
    t = jnp.clip(t, 0.0, 1.0)
    return a + t[..., None] * ab


def closest_point_aabb(
    p: jnp.ndarray, box_min: jnp.ndarray, box_max: jnp.ndarray
) -> jnp.ndarray:
    """Closest point on/in an AABB — ``AABB.ClosestPt``
    (``AABB_Tri_Int.cs:265-288``): per-axis clamp."""
    return jnp.clip(p, box_min, box_max)


def dist_to_plane(
    q: jnp.ndarray, normal: jnp.ndarray, d: jnp.ndarray
) -> jnp.ndarray:
    """Signed distance from q to the plane n·x = d — ``Polygon.DistToPlane``
    (``Hare_Geometry_Polygons.cs:579-582``), with the reference's
    1/|n| scaling so non-unit normals still give metric distance."""
    n2 = dot(normal, normal)
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return (dot(normal, q) - d) * inv


def closest_point_plane(
    q: jnp.ndarray, normal: jnp.ndarray, d: jnp.ndarray
) -> jnp.ndarray:
    """Closest point on the plane n·x = d — ``Polygon.ClosestPtPointPlane``
    (``Hare_Geometry_Polygons.cs:613-617``); exact for unit normals like the
    reference (which stores unit polygon normals)."""
    n2 = dot(normal, normal)
    t = jnp.where(n2 > 0, (dot(normal, q) - d) / jnp.where(n2 > 0, n2, 1.0), 0.0)
    return q - t[..., None] * normal


def ray_side(direction: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """``Polygon.Ray_Side`` (``Hare_Geometry_Polygons.cs:589-606``): True when
    direction·normal >= 0 (the winding the reference would flip to)."""
    return dot(direction, normal) >= 0.0


def sq_distance_to_edges(p: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Min squared distance from p to the polygon's edge loop.

    ``Polygon.SqDistanceToEdges`` (``Hare_Geometry_Polygons.cs:116-145``) —
    with the corrected cyclic edge enumeration (i, i+1 mod n); the
    reference wraps with ``% (n-1)``, duplicating one edge and skipping the
    closing edge (documented defect, not replicated).

    Args:
      p: ``(..., 3)`` query points.
      pts: ``(..., K, 3)`` polygon corners.
    """
    a = pts
    b = jnp.roll(pts, -1, axis=-2)
    edge = b - a
    pea = p[..., None, :] - a
    peb = p[..., None, :] - b
    e = dot(pea, edge)
    f = dot(edge, edge)
    # Ericson's three cases: before a, after b, or projected interior.
    d_a = dot(pea, pea)
    d_b = dot(peb, peb)
    d_i = d_a - jnp.where(f > 0, e * e / jnp.where(f > 0, f, 1.0), 0.0)
    d_edge = jnp.where(e <= 0, d_a, jnp.where(e >= f, d_b, d_i))
    return jnp.min(d_edge, axis=-1)
