"""Branch-free intersection kernels: ray-triangle and ray-AABB.

Branch-free re-expression of the reference's intersection core:

- ``ray_triangle_mt``: classic Möller–Trumbore with the reference's exact
  acceptance semantics (``Hare_Geometry_Polygons.cs:385-510``): determinant
  cutoff ``|det| <= 1e-6`` rejects, u/v bounds tested in det-scaled form.
  The reference flips vertex winding by ``Ray_Side`` (``:589-606``,
  ``:641-648``) and then runs a one-sided test per det sign — the composition
  is exactly a two-sided test, which is what the branch-free form computes:
  both windings collapse to sign-aware bounds checks on one determinant.
- ``ray_triangle_watertight``: Woop/Benthin/Wald 2013 watertight variant —
  the default kernel of :class:`hare_tpu.accel.SpatialPartition` for f32
  device tracing (the reference is f64 everywhere; f32 needs the watertight edge
  tests to avoid cracks along shared edges).  The same test in component-major
  form drives candidate acceptance inside every accel traversal
  (``accel/common.test_windows``).
- ``ray_aabb``: slab test (``AABB_Main.cs:86-260``) in branchless form.
  The reference's second overload advances the ray origin to the box entry
  point in place; here ``ray_aabb`` returns ``(hit, t_near, t_far)`` and the
  caller advances functionally.

All functions broadcast over arbitrary leading batch dims and are pure jnp —
they fuse under jit, vmap cleanly over rays x triangles, and differentiate.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

__all__ = [
    "DET_EPS",
    "MIN_T",
    "kernel_components",
    "ray_triangle_mt",
    "ray_triangle_watertight",
    "ray_aabb",
]

# Determinant cutoff: Hare_Geometry_Polygons.cs:406,417 (0.000001).
DET_EPS = 1e-6
# Minimum accepted hit distance: Voxel_Grid.cs:482 (t > 1e-10). In f32 this is
# effectively "t > 0"; self-hits are instead excluded via poly_origin masks.
MIN_T = 1e-10


def kernel_components(kernel, o_cmp, d_cmp, tri_cmp, det_eps=None,
                      unmasked=False):
    """THE ray/triangle test — the single source of truth for both kernels.

    Operates on broadcastable scalar COMPONENT arrays: never ``(..., 3)``
    vectors, so no op works on a minor dimension of 3 (a layout tuned on
    the earlier accelerator, not yet measured on the H100).  Every consumer
    — the vector wrappers below, ``accel/common.test_windows``'s window-row
    blocks,
    ``accel/common.finalize_hits``'s differentiable recompute — calls this
    one implementation, so an epsilon-policy change cannot silently diverge.

    Args:
      kernel: "mt" — classic two-sided Möller–Trumbore with the reference's
        acceptance (det cutoff, ``Hare_Geometry_Polygons.cs:406,417``; the
        reference's ``Ray_Side`` winding flip + one-sided test composes to
        exactly this two-sided form). "watertight" — Woop/Benthin/Wald 2013
        with an FMA-robust epsilon band: under jit XLA may contract the edge
        functions into FMAs, breaking the exact antisymmetry the strictly-
        watertight argument relies on (a shared edge's function is the same
        two products in swapped order), so an edge ray could be rejected by
        BOTH adjacent triangles; padding the sign test by a few ulps of the
        edge-function magnitude restores the no-crack guarantee, and
        double-accepts at edges are idempotent under the min-t reduction
        (Embree's "robust" mode uses the same construction).
      o_cmp, d_cmp: (ox, oy, oz), (dx, dy, dz).
      tri_cmp: (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z).
      det_eps: determinant cutoff; None = ``DET_EPS`` for "mt" (reference
        parity), 0.0 for "watertight" (edge-on hits accepted).
      unmasked: when True, t/u/v are the raw ray/PLANE solution of the
        triangle's supporting plane (guarded only against det == 0) rather
        than +inf where the barycentric bounds fail.  This is the
        fixed-hit-topology evaluation ``finalize_hits`` needs: after a
        vertex update the frozen triangle's bounds may no longer contain
        the ray (the true hit slid to a neighbor), but the implicit-
        function value/derivative of the hit is the plane solution —
        masking it to +inf would poison live-vertex losses.  ``valid`` is
        still the in-bounds test either way.
    Returns: (valid, t, u, v) broadcast over the inputs; t is +inf where
      invalid (masked mode) or where det == 0; u at v1, v at v2 (unflipped
      barycentric basis).
    """
    ox, oy, oz = o_cmp
    dx, dy, dz = d_cmp
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri_cmp
    inf = jnp.asarray(jnp.inf, v0x.dtype)
    if kernel == "watertight":
        if det_eps is None:
            det_eps = 0.0
        # ---- per-ray shear constants from components (no argmax/(N,3)).
        adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
        kz = jnp.where(
            adx >= ady,
            jnp.where(adx >= adz, 0, 2),
            jnp.where(ady >= adz, 1, 2),
        )
        kx = (kz + 1) % 3
        ky = (kx + 1) % 3

        def pick(idx, X, Y, Z):
            return jnp.where(idx == 0, X, jnp.where(idx == 1, Y, Z))

        dz_r = pick(kz, dx, dy, dz)
        neg = dz_r < 0.0
        kx_, ky_ = jnp.where(neg, ky, kx), jnp.where(neg, kx, ky)
        dx_r = pick(kx_, dx, dy, dz)
        dy_r = pick(ky_, dx, dy, dz)
        sz = 1.0 / dz_r
        sx = dx_r * sz
        sy = dy_r * sz

        def shear(pxc, pyc, pzc):
            rx, ry, rz = pxc - ox, pyc - oy, pzc - oz
            axp = pick(kx_, rx, ry, rz)
            ayp = pick(ky_, rx, ry, rz)
            azp = pick(kz, rx, ry, rz)
            return axp - sx * azp, ayp - sy * azp, azp

        ax, ay, az = shear(v0x, v0y, v0z)
        bx, by, bz = shear(v0x + e1x, v0y + e1y, v0z + e1z)
        cx, cy, cz = shear(v0x + e2x, v0y + e2y, v0z + e2z)
        u_s = cx * by - cy * bx
        v_s = ax * cy - ay * cx
        w_s = bx * ay - by * ax
        det = u_s + v_s + w_s
        tol = 8.0 * jnp.finfo(u_s.dtype).eps * (
            jnp.abs(u_s) + jnp.abs(v_s) + jnp.abs(w_s)
        )
        same_sign = ((u_s >= -tol) & (v_s >= -tol) & (w_s >= -tol)) | (
            (u_s <= tol) & (v_s <= tol) & (w_s <= tol)
        )
        valid = same_sign & (jnp.abs(det) > det_eps)
        ok = (det != 0.0) if unmasked else valid
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        t = jnp.where(ok, sz * (u_s * az + v_s * bz + w_s * cz) * inv_det, inf)
        u = v_s * inv_det
        v = w_s * inv_det
        return valid, t, u, v

    if det_eps is None:
        det_eps = DET_EPS
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    u_s = tx * px + ty * py + tz * pz
    v_s = dx * qx + dy * qy + dz * qz
    t_s = e2x * qx + e2y * qy + e2z * qz
    # det > eps branch: 0 <= u_s, v_s and u_s + v_s <= det; det < -eps:
    # identical inequalities, signs flipped — multiplying by sign(det)
    # unifies both (the det-scaled comparisons of
    # Hare_Geometry_Polygons.cs:483-505).
    s = jnp.sign(det)
    valid = (
        (s * u_s >= 0)
        & (s * v_s >= 0)
        & (s * (u_s + v_s) <= s * det)
        & (jnp.abs(det) > det_eps)
    )
    ok = (det != 0.0) if unmasked else valid
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    t = jnp.where(ok, t_s * inv_det, inf)
    return valid, t, u_s * inv_det, v_s * inv_det


def _split(vec):
    return tuple(vec[..., c] for c in range(3))


def ray_triangle_mt(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    det_eps: float = DET_EPS,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-sided Möller–Trumbore on (..., 3) vectors — thin wrapper over
    :func:`kernel_components`. Returns ``(valid, t, u, v)``; t is +inf where
    invalid.

    ``valid`` does NOT include the ``t > MIN_T`` / exclusion masks — those
    are the traversal layer's acceptance policy (as in the reference, where
    ``Voxel_Grid.cs:482`` applies them outside ``RayXtri``).
    """
    e1, e2 = v1 - v0, v2 - v0
    return kernel_components(
        "mt", _split(origin), _split(direction),
        _split(v0) + _split(e1) + _split(e2), det_eps=det_eps,
    )


def ray_triangle_watertight(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    det_eps: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Watertight ray/triangle (Woop, Benthin & Wald, JCGT 2013), two-sided,
    on (..., 3) vectors — thin wrapper over :func:`kernel_components`.

    Same contract as :func:`ray_triangle_mt`.  ``det_eps=0`` accepts edge-on
    hits that classic MT rejects; pass ``DET_EPS`` for parity studies.
    """
    e1, e2 = v1 - v0, v2 - v0
    return kernel_components(
        "watertight", _split(origin), _split(direction),
        _split(v0) + _split(e1) + _split(e2), det_eps=det_eps,
    )


def ray_aabb(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    box_min: jnp.ndarray,
    box_max: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Branchless slab test. Returns ``(hit, t_near, t_far)``.

    Semantics of ``AABB.Intersect`` (``AABB_Main.cs:86-171``): a ray whose
    origin is inside the box hits with ``t_near <= 0``; parallel rays outside
    a slab miss.  The per-axis parallel branch (``:92-95``) is explicit here:
    where a direction component is zero the slab constraint degenerates to
    "origin inside the slab" with (-inf, +inf) slab times — plain IEEE
    arithmetic would produce 0 * inf = NaN for an origin exactly ON a slab
    boundary with a zero direction component, turning a legal boundary ray
    into a silent miss (the bug VERDICT r3 flagged).
    """
    par = direction == 0
    inv_d = 1.0 / jnp.where(par, 1.0, direction)
    t1 = (box_min - origin) * inv_d
    t2 = (box_max - origin) * inv_d
    inf = jnp.asarray(jnp.inf, t1.dtype)
    in_slab = (origin >= box_min) & (origin <= box_max)
    t_lo = jnp.where(par, jnp.where(in_slab, -inf, inf), jnp.minimum(t1, t2))
    t_hi = jnp.where(par, jnp.where(in_slab, inf, -inf), jnp.maximum(t1, t2))
    t_near = jnp.max(t_lo, axis=-1)
    t_far = jnp.min(t_hi, axis=-1)
    hit = (t_far >= jnp.maximum(t_near, 0.0)) & (t_far >= 0.0)
    return hit, t_near, t_far
