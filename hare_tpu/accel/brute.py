"""Brute-force ray casting: every ray against every triangle, tiled.

The "no acceleration structure" baseline (BASELINE.json config 1).  The MT
test is pure elementwise work over a dense (rays x tris) tile — perfectly
regular, no gathers, no divergence — so it is a fair choice for small
scenes and also serves as the reference
implementation every accel structure must agree with (the implicit
``Spatial_Partition`` contract: all structures return the same nearest hit).

Acceptance semantics (Voxel_Grid.cs:475-499):
  - nearest hit by t, with t > min_t (reference: 1e-10)
  - triangles whose polygon id matches either exclusion slot are skipped
    (the ``poly_origin1/2`` rule, Spatial_Partition.cs:33)
  - ties broken by lowest triangle index (the reference's sequential scan
    keeps the first strictly-smaller t, i.e. lowest index wins on ties).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..geom.intersect import MIN_T, ray_triangle_mt, ray_triangle_watertight
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..mesh.scene import Scene

__all__ = ["shoot_brute"]

_KERNELS = {
    "mt": ray_triangle_mt,
    "watertight": ray_triangle_watertight,
}


def _finalize(
    rays: Ray, best_t, best_u, best_v, best_tri, scene: Scene
) -> HitRecord:
    hit = jnp.isfinite(best_t)
    t = jnp.where(hit, best_t, jnp.inf)
    point = rays.at(jnp.where(hit, best_t, 0.0))
    tri = jnp.maximum(best_tri, 0)
    poly = jnp.where(hit, scene.tri_poly[tri], NO_POLY)
    # Live differentiable normal of the winner (brute differentiates end to
    # end; the accel backends supply this via finalize_hits' custom_vjp).
    iv = scene.tri_v[tri]
    v = scene.vertices
    normal = jnp.cross(v[iv[:, 1]] - v[iv[:, 0]], v[iv[:, 2]] - v[iv[:, 0]])
    return HitRecord(
        hit=hit,
        t=t,
        u=jnp.where(hit, best_u, 0.0),
        v=jnp.where(hit, best_v, 0.0),
        point=jnp.where(hit[..., None], point, 0.0),
        poly_id=poly.astype(jnp.int32),
        tri_id=jnp.where(hit, best_tri, NO_POLY).astype(jnp.int32),
        normal=normal,
    )


@partial(jax.jit, static_argnames=("kernel", "tri_tile", "top_index"))
def shoot_brute(
    scene: Scene,
    rays: Ray,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    tri_tile: int = 2048,
    top_index: Optional[int] = None,
) -> HitRecord:
    """Nearest-hit query over all triangles.  ``rays`` batch shape ``(N,)``.

    ``top_index`` statically restricts hits to one topology (the
    ``Shoot(R, top_index, ...)`` argument, ``Spatial_Partition.cs:32``);
    ``None`` queries all topologies at once.
    """
    ktest = _KERNELS[kernel]
    v0a, v1a, v2a = scene.tri_vertices()  # (T, 3) each
    T = scene.n_tris
    tile = min(tri_tile, T)
    n_tiles = (T + tile - 1) // tile
    Tp = n_tiles * tile

    def pad(x):
        return jnp.pad(x, ((0, Tp - T),) + ((0, 0),) * (x.ndim - 1))

    v0a, v1a, v2a = pad(v0a), pad(v1a), pad(v2a)
    tri_poly = jnp.pad(scene.tri_poly, (0, Tp - T), constant_values=-2)
    tri_top = jnp.pad(scene.tri_top, (0, Tp - T), constant_values=-1)

    N = rays.origin.shape[:-1]
    o = rays.origin[..., None, :]  # (N, 1, 3)
    d = rays.direction[..., None, :]
    ex = rays.exclude_poly  # (N, 2)

    def body(carry, tile_idx):
        best_t, best_u, best_v, best_tri = carry
        sl = tile_idx * tile
        v0 = jax.lax.dynamic_slice_in_dim(v0a, sl, tile, 0)
        v1 = jax.lax.dynamic_slice_in_dim(v1a, sl, tile, 0)
        v2 = jax.lax.dynamic_slice_in_dim(v2a, sl, tile, 0)
        tpoly = jax.lax.dynamic_slice_in_dim(tri_poly, sl, tile, 0)
        ttop = jax.lax.dynamic_slice_in_dim(tri_top, sl, tile, 0)

        valid, t, u, v = ktest(o, d, v0, v1, v2)  # (N, tile)
        accept = valid & (t > min_t)
        accept &= (tpoly != ex[..., 0:1]) & (tpoly != ex[..., 1:2])
        accept &= tpoly != -2
        if top_index is not None:
            accept &= ttop == top_index
        t = jnp.where(accept, t, jnp.inf)

        # Nearest within tile; lowest index wins ties via argmin's first-min.
        j = jnp.argmin(t, axis=-1)  # (N,)
        t_min = jnp.take_along_axis(t, j[..., None], -1)[..., 0]
        u_min = jnp.take_along_axis(u, j[..., None], -1)[..., 0]
        v_min = jnp.take_along_axis(v, j[..., None], -1)[..., 0]
        tri_min = sl + j

        better = t_min < best_t
        return (
            jnp.where(better, t_min, best_t),
            jnp.where(better, u_min, best_u),
            jnp.where(better, v_min, best_v),
            jnp.where(better, tri_min, best_tri),
        ), None

    init = (
        jnp.full(N, jnp.inf, v0a.dtype),
        jnp.zeros(N, v0a.dtype),
        jnp.zeros(N, v0a.dtype),
        jnp.full(N, -1, jnp.int32),
    )
    if n_tiles == 1:
        (best_t, best_u, best_v, best_tri), _ = body(init, 0)
    else:
        (best_t, best_u, best_v, best_tri), _ = jax.lax.scan(
            body, init, jnp.arange(n_tiles)
        )
    return _finalize(rays, best_t, best_u, best_v, best_tri, scene)
