"""Core geometric record types as JAX pytrees (SoA, batch-first).

Batched, immutable equivalents of the reference's mutable scalar structs:

- ``Ray``       <- ``Hare_Geometry_Primitives.cs:393-429`` (origin, direction,
  ``poly_origin1/2`` self-intersection exclusion).  ``ThreadID``/``Ray_ID``
  (mailboxing keys) are dropped: duplicate tests are idempotent under the
  min-t reduction, so mailboxes are unnecessary (SURVEY.md §2).
- ``HitRecord`` <- ``X_Event`` (``Hare_Geometry_Primitives.cs:435-481``).
- ``AABB``      <- ``AABB_Main.cs:24-84`` (the box record; the slab test lives
  in ``hare_tpu.geom.intersect``).

All fields are arrays with an arbitrary shared batch prefix; a single ray is
just the batch-of-one special case.  NamedTuples register as pytrees
automatically, so these flow through jit/vmap/scan/shard_map unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = ["Ray", "HitRecord", "AABB", "NO_POLY"]

# Sentinel polygon id meaning "no exclusion" / "no hit".
NO_POLY = -1


class Ray(NamedTuple):
    """A batch of rays.

    ``exclude_poly`` carries the reference's ``poly_origin1/2`` pair
    (``Spatial_Partition.cs:33``): polygon ids the ray must not re-hit
    (the polygon(s) a reflected ray starts on).  Shape ``(..., 2)``,
    ``NO_POLY`` where unused.
    """

    origin: jnp.ndarray  # (..., 3) float
    direction: jnp.ndarray  # (..., 3) float
    exclude_poly: jnp.ndarray  # (..., 2) int32

    @classmethod
    def make(cls, origin, direction, exclude_poly=None) -> "Ray":
        origin = jnp.asarray(origin)
        direction = jnp.asarray(direction)
        if exclude_poly is None:
            exclude_poly = jnp.full(origin.shape[:-1] + (2,), NO_POLY, jnp.int32)
        else:
            exclude_poly = jnp.asarray(exclude_poly, jnp.int32)
        return cls(origin, direction, exclude_poly)

    def at(self, t: jnp.ndarray) -> jnp.ndarray:
        """Point along the ray: origin + t * direction."""
        return self.origin + t[..., None] * self.direction

    def reverse(self) -> "Ray":
        """Flipped-direction copy (``Ray.Reverse()``,
        ``Hare_Geometry_Primitives.cs:421-428`` — functional here: rays are
        immutable pytrees, so reversal returns a new batch)."""
        return self._replace(direction=-self.direction)


class HitRecord(NamedTuple):
    """A batch of intersection results (the ``X_Event`` analog).

    Unlike the reference grid fast path (which returns ``u=v=0``,
    ``Voxel_Grid.cs:481-498``), every accel structure here returns real
    barycentrics — resolving the API inconsistency noted in SURVEY.md §2.
    """

    hit: jnp.ndarray  # (...) bool
    t: jnp.ndarray  # (...) float — ray parameter of nearest accepted hit
    u: jnp.ndarray  # (...) float — barycentric
    v: jnp.ndarray  # (...) float — barycentric
    point: jnp.ndarray  # (..., 3) float — hit location
    poly_id: jnp.ndarray  # (...) int32 — polygon id (quad = one id, two tris)
    tri_id: jnp.ndarray  # (...) int32 — concrete triangle index in the Scene
    # Geometric (UN-normalized) normal of the hit triangle, cross(e1, e2) —
    # an API extension over X_Event (the reference's consumers re-derive
    # normals from Poly_id; here the hit pipeline already has the winning
    # triangle's geometry in hand and gradients flow to vertex positions).
    # JUNK on miss lanes (not zeroed: normalize(0) would emit NaNs into
    # backward passes) — mask with ``hit`` before use.
    normal: jnp.ndarray  # (..., 3) float

    @classmethod
    def miss(cls, batch_shape, dtype=jnp.float32) -> "HitRecord":
        """An all-miss record (t = +inf), the ``X_Event()`` empty ctor analog."""
        f = jnp.full(batch_shape, jnp.inf, dtype)
        z = jnp.zeros(batch_shape, dtype)
        return cls(
            hit=jnp.zeros(batch_shape, bool),
            t=f,
            u=z,
            v=z,
            point=jnp.zeros(batch_shape + (3,), dtype),
            poly_id=jnp.full(batch_shape, NO_POLY, jnp.int32),
            tri_id=jnp.full(batch_shape, NO_POLY, jnp.int32),
            normal=jnp.concatenate(
                [jnp.ones(batch_shape + (1,), dtype)]
                + [jnp.zeros(batch_shape + (1,), dtype)] * 2,
                axis=-1,
            ),
        )


class AABB(NamedTuple):
    """Axis-aligned box batch (``AABB_Main.cs:26-68``).

    Derived quantities (center, width, inverse width, half width) are
    computed on demand instead of stored — they fuse into consumers under jit.
    """

    min: jnp.ndarray  # (..., 3)
    max: jnp.ndarray  # (..., 3)

    @property
    def center(self) -> jnp.ndarray:
        return 0.5 * (self.min + self.max)

    @property
    def width(self) -> jnp.ndarray:
        return self.max - self.min

    @property
    def half_width(self) -> jnp.ndarray:
        return 0.5 * (self.max - self.min)

    def contains(self, p: jnp.ndarray) -> jnp.ndarray:
        """Point-in-box test (``AABB_Main.cs:75-84``, inclusive bounds)."""
        return jnp.all((p >= self.min) & (p <= self.max), axis=-1)
