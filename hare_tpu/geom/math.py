"""Vector math over SoA ``(..., 3)`` arrays.

Batched re-expression of the reference's scalar math layer
(``Hare_Geometry_Math.cs:27-103``: Dot/Cross/ScalarTriple/Normalize and the
coplanarity check at ``:113-135``).  Everything here is pure ``jnp``, shape-
polymorphic over leading batch dimensions, and differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "dot",
    "cross",
    "scalar_triple",
    "norm",
    "normalize",
    "distance",
    "is_coplanar",
]


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (``Hare_math.Dot``)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3-vector cross product (``Hare_math.Cross``).

    Written out by component instead of ``jnp.cross`` so XLA fuses it freely
    with surrounding elementwise work.
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def scalar_triple(a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """a . (b x c)  (``Hare_math.ScalarTriple``)."""
    return dot(a, cross(b, c))


def norm(a: jnp.ndarray) -> jnp.ndarray:
    """Euclidean length over the trailing axis."""
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Unit vector; guards against zero length when ``eps > 0``.

    The reference normalizes in place and checks length against
    ``double.Epsilon`` (``Hare_Geometry_Primitives.cs:121-125``); here a soft
    epsilon keeps the op differentiable and NaN-free at zero length.
    """
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    if eps > 0.0:
        n2 = jnp.maximum(n2, eps * eps)
    return a * jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)


def distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Point-to-point distance (``Hare_math.distance``)."""
    return norm(a - b)


def is_coplanar(points: jnp.ndarray, tol: float = 1e-6) -> jnp.ndarray:
    """Whether a polygon's triangle fans share one normal.

    Reference: ``Corrective_Tools.IsCoPlanar`` (``Hare_Geometry_Math.cs:113-135``)
    fans (p0, p_i, p_{i+1}), normalizes each fan normal and requires pairwise
    dot == 1 exactly (strict ``x < 1`` — a documented defect).  We keep the
    semantics but add a tolerance so it is actually usable.

    Args:
      points: ``(..., K, 3)`` polygon corners, K >= 3.
    Returns:
      boolean ``(...)`` mask.
    """
    p0 = points[..., :1, :]
    e1 = points[..., 1:-1, :] - p0  # (..., K-2, 3)
    e2 = points[..., 2:, :] - p0
    normals = normalize(cross(e1, e2))
    ref = normals[..., :1, :]
    dots = jnp.abs(dot(normals, jnp.broadcast_to(ref, normals.shape)))
    return jnp.all(dots > 1.0 - tol, axis=-1)
