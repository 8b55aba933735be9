"""Device-side scene representation: padded SoA arrays (a frozen pytree).

This is the array-program analog of the reference's pointer-rich ``Topology``
object graph (``Hare_Geometry_Topology.cs:27-698``): instead of ``Vertex``/
``Edge``/``Polygon`` objects with back-references, the scene is a handful of
flat index arrays.  Vertices stay a live, differentiable input — the
``Set_Vertex`` mutation hook (``Hare_Geometry_Topology.cs:506-511``) becomes
"rebuild the pytree with new vertex array", and all per-triangle quantities
(edges, normals, plane offsets) are derived inside the kernels so gradients
flow to vertex positions.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geom.math import cross, normalize

__all__ = ["Scene", "PAD_POLY"]

# Polygon id used for padding triangles: never matches a real poly nor the
# NO_POLY (-1) exclusion sentinel.
PAD_POLY = -2


class Scene(NamedTuple):
    """Flat triangle soup + topology metadata, ready for device kernels.

    Quadrilaterals are pre-split into two triangles (0,1,2)+(2,3,0) at mesh
    compile time — the exact decomposition ``Quadrilateral.Intersect`` tries
    in sequence (``Hare_Geometry_Polygons.cs:731-782``) — with both halves
    sharing one ``tri_poly`` id so hit records and origin-polygon exclusion
    keep the reference's polygon granularity.

    Triangle arrays are padded (degenerate all-zero triangles, poly id
    ``PAD_POLY``) so counts hit aligned multiples; padding never
    produces hits because degenerate triangles have ``det == 0``.
    """

    vertices: jnp.ndarray  # (V, 3) f32 — differentiable
    tri_v: jnp.ndarray  # (T, 3) i32 — vertex indices per triangle
    tri_poly: jnp.ndarray  # (T,) i32 — polygon id (quad halves share)
    tri_top: jnp.ndarray  # (T,) i32 — topology index (Spatial_Partition.Model)
    poly_plane: jnp.ndarray  # (P,) i32 — plane group id per polygon
    # Neighboring polygon across each triangle edge — edge k joins corners
    # (k, (k+1)%3); NO_POLY (-1) where boundary or same-poly (quad diagonal).
    # Backs the reference's second origin-exclusion slot (``poly_origin2``,
    # ``Spatial_Partition.cs:33``): a reflection starting on an edge shared
    # by two coplanar polygons must exclude both.
    tri_edge_poly: jnp.ndarray  # (T, 3) i32
    # Packed per-triangle static metadata — ONE gather row serves the whole
    # bounce step (instead of 5-6 separate narrow per-ray gathers):
    #   lane 0    tri_poly
    #   lanes 1-3 tri_edge_poly pre-filtered to COPLANAR neighbors only
    #             (poly_plane equality folded in at build time)
    #   lanes 4-6 tri_v
    #   lane 7    tri_top
    tri_meta: jnp.ndarray  # (T, 8) i32
    # Packed per-triangle GEOMETRY row — ONE 16-lane f32 gather serves the
    # whole hit-finalize + bounce step (instead of a tri_meta gather plus
    # THREE narrow per-vertex gathers):
    #   lanes 0-8   v0 | e1 | e2 (vertex positions, f32)
    #   lane  9     tri_poly              (i32 bitcast)
    #   lanes 10-12 coplanar edge nbrs    (i32 bitcast, = tri_meta lanes 1-3)
    #   lanes 13-15 tri_v                 (i32 bitcast)
    # The geometry lanes equal the CURRENT ``vertices`` at all times:
    # ``with_vertices`` recomputes them in-jit (one (T,3)-gather triple —
    # paid only inside fit loops; benches that never move vertices pay
    # nothing), so forward hit values from every accel backend respond to
    # live coordinates.  Gradients w.r.t. ``vertices`` are supplied by a
    # custom_vjp that gathers live vertices in the backward pass only
    # (accel/common._hit_vals).  What stays build-time is the TRAVERSAL
    # tables (grid cells / tree nodes / window rows): after a large vertex
    # move the candidate-triangle assignment is approximate until the accel
    # structure is rebuilt — the outer-loop contract (utils/checkpoint,
    # examples/fit_vertices.py).
    tri_geom: jnp.ndarray  # (T, 16) f32

    @property
    def n_tris(self) -> int:
        return self.tri_v.shape[0]

    @property
    def n_polys(self) -> int:
        return self.poly_plane.shape[0]

    def tri_vertices(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Gather per-triangle corners ``(v0, v1, v2)``, each ``(T, 3)``.

        Done lazily (inside jit) so ``d(hit)/d(vertices)`` flows through the
        gather's transpose (a scatter-add over shared vertices — exactly the
        right accumulation for welded meshes).
        """
        v = self.vertices
        return v[self.tri_v[:, 0]], v[self.tri_v[:, 1]], v[self.tri_v[:, 2]]

    def tri_normals(self, unit: bool = True) -> jnp.ndarray:
        """Per-triangle normals from current vertex positions, ``(T, 3)``.

        Matches ``Polygon`` ctor normal = cross(v1-v0, v2-v0), normalized
        (``Hare_Geometry_Polygons.cs:158-172``).
        """
        v0, v1, v2 = self.tri_vertices()
        n = cross(v1 - v0, v2 - v0)
        return normalize(n) if unit else n

    def with_vertices(self, vertices: jnp.ndarray) -> "Scene":
        """Functional ``Set_Vertex`` (``Hare_Geometry_Topology.cs:506-511``
        — the reference's entire shape-optimization hook): same topology,
        new coordinates.

        Also refreshes ``tri_geom``'s geometry lanes from the new vertices
        (in-jit, differentiable), so the FORWARD pass of every accel
        backend sees the live coordinates — without this, grid/octree/
        kdtree losses would be bit-identical under any vertex change and
        ``fit_vertices`` could not descend.  Traversal
        tables still hold build-time geometry; rebuild the accel structure
        after large moves (see ``tri_geom``'s field comment).
        """
        vertices = jnp.asarray(vertices)
        if self.tri_geom.shape[0] == 0 or vertices.shape[0] == 0:
            return self._replace(vertices=vertices)
        v = vertices.astype(self.tri_geom.dtype)
        v0 = v[self.tri_v[:, 0]]
        v1 = v[self.tri_v[:, 1]]
        v2 = v[self.tri_v[:, 2]]
        geom = jnp.concatenate([v0, v1 - v0, v2 - v0], axis=1)
        # Splice the refreshed geometry lanes with the (unchanged) id lanes
        # in the INT domain: the id lanes are int32 bitcast to f32, and a
        # backend may canonicalize NaN payloads in f32 data movement — an
        # f32 concatenate can rewrite every -1 sentinel (0xFFFFFFFF) to the
        # default NaN (0x7FC00000), silently corrupting poly/neighbor/vertex
        # ids.
        # stop_gradient: bitcast has no transpose rule, and gradients never
        # flow through the rows anyway — accel/common._hit_vals zeroes the
        # row cotangent and supplies d/d(vertices) from its live-vertex
        # backward, so the row path is dead weight for AD by construction.
        geom_i = jax.lax.bitcast_convert_type(
            jax.lax.stop_gradient(geom), jnp.int32
        )
        old_i = jax.lax.bitcast_convert_type(self.tri_geom, jnp.int32)
        tri_geom = jax.lax.bitcast_convert_type(
            jnp.concatenate([geom_i, old_i[:, 9:]], axis=1),
            self.tri_geom.dtype,
        )
        return self._replace(vertices=vertices, tri_geom=tri_geom)
