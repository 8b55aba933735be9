"""Differentiable multi-bounce tracing (reference layer L4).

The reference has no bounce loop of its own — its consumer (Pachyderm) loops
``Shoot -> reflect about Normal(Poly_id) -> new Ray with poly_origin1 = hit
id -> Shoot`` (SURVEY.md §3.3; the ``poly_origin`` exclusion at
``Spatial_Partition.cs:33`` and ``Char_Step`` epsilon at ``:31`` exist
exactly for this loop).  Here that loop is a ``lax.scan`` over a fixed
maximum bounce count with live-lane masks: terminated rays keep riding with
zero energy, trading wasted lanes for the static shapes XLA needs.

Energy model: each ray starts with unit energy; at every hit the energy is
multiplied by ``(1 - absorption[poly])`` — the hook that makes
``jax.grad(histogram)`` w.r.t. absorption (and, through the hit geometry,
w.r.t. vertex positions) meaningful.  Per-bounce energies/times are scattered
into a time-binned impulse-response histogram.

Scattering (the consumer's surface-roughness model): each polygon carries a
scattering coefficient ``s`` in [0, 1] splitting reflected energy between the
specular direction (weight ``1 - s``) and a cosine-weighted diffuse lobe
(weight ``s``).  The single-ray estimator keeps gradients pathwise exact in
``s``: the branch is chosen by an *s-independent* fair coin (stateless
per-bounce fold-in RNG), and the energy is reweighted by ``2 s`` on the
diffuse branch / ``2 (1 - s)`` on the specular branch — unbiased
(``E[energy] = s·diffuse + (1-s)·specular``) and differentiable in ``s``
because the sampling distribution never depends on it.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..geom.math import dot, norm, normalize
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..mesh.scene import Scene

__all__ = [
    "TraceResult",
    "reflect",
    "cosine_lobe",
    "trace_rays",
    "energy_histogram",
]

SOUND_SPEED = 343.0  # m/s, for time binning
# Partial histograms in _binned_sum: at most HIST_BLOCKS of them, each over
# at least HIST_BLOCK consecutive entries.
HIST_BLOCK = 1024
HIST_BLOCKS = 4096
# Barycentric proximity below which a hit counts as "on an edge" for the
# second origin-exclusion slot (poly_origin2).
EDGE_EPS = 1e-4


def reflect(direction: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Specular reflection about a (not necessarily unit-consistent-sign)
    normal: invariant to the sign of ``normal``."""
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


def cosine_lobe(
    key: jax.Array, normal: jnp.ndarray, incoming: jnp.ndarray
) -> jnp.ndarray:
    """Cosine-weighted hemisphere sample about the surface normal.

    ``normal`` need not have a consistent sign; it is oriented against the
    incoming direction (the physical reflection side).  Lambert's cosine law
    is the standard acoustic diffuse-reflection model.
    """
    n = normal * -jnp.sign(dot(incoming, normal))[..., None]
    shape = normal.shape[:-1]
    k1, k2 = jax.random.split(key)
    r1 = jax.random.uniform(k1, shape, normal.dtype)
    r2 = jax.random.uniform(k2, shape, normal.dtype)
    cz = jnp.sqrt(r1)  # cos(theta) ~ sqrt(u): pdf = cos/pi
    rr = jnp.sqrt(jnp.maximum(0.0, 1.0 - r1))
    phi = 2.0 * jnp.pi * r2
    # Orthonormal tangent frame (branchless Duff et al. construction).
    nz = n[..., 2]
    sg = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sg + nz)
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack(
        [1.0 + sg * n[..., 0] ** 2 * a, sg * b, -sg * n[..., 0]], axis=-1
    )
    t2 = jnp.stack([b, sg + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return (
        (rr * jnp.cos(phi))[..., None] * t1
        + (rr * jnp.sin(phi))[..., None] * t2
        + cz[..., None] * n
    )


class TraceResult(NamedTuple):
    """Per-bounce trace record, all shaped ``(n_bounces, n_rays, ...)``."""

    hit: jnp.ndarray  # (B, N) bool — ray was alive and hit at this bounce
    energy: jnp.ndarray  # (B, N) energy AFTER this bounce's absorption
    time: jnp.ndarray  # (B, N) cumulative path time at the hit (seconds)
    poly_id: jnp.ndarray  # (B, N) i32
    point: jnp.ndarray  # (B, N, 3)
    t: jnp.ndarray  # (B, N) hit parameter of each bounce


@partial(
    jax.jit,
    static_argnames=("shoot_fn", "n_bounces", "sound_speed", "remat"),
)
def trace_rays(
    scene: Scene,
    rays: Ray,
    absorption: jnp.ndarray,
    n_bounces: int,
    shoot_fn: Callable[..., HitRecord],
    aux=None,
    scattering: Optional[jnp.ndarray] = None,
    key: Optional[jax.Array] = None,
    sound_speed: float = SOUND_SPEED,
    remat: bool = False,
) -> TraceResult:
    """Trace ``rays`` for up to ``n_bounces`` reflections.

    Args:
      scene: compiled Scene.
      rays: ray batch ``(N,)``; directions need not be unit (times use the
        true metric length).
      absorption: ``(P,)`` per-polygon energy absorption coefficients in
        [0, 1] — the differentiable material parameter.
      n_bounces: static max bounce count (the scan length).
      shoot_fn: any ``(scene, rays[, aux]) -> HitRecord`` backend (brute,
        grid, octree, KD — the ``Spatial_Partition`` polymorphism).
      aux: accel-structure pytree passed through to ``shoot_fn``.  MUST be
        used (rather than closing the structure into ``shoot_fn``) for
        non-trivial structures: closed-over device arrays become embedded
        jit constants, which XLA then constant-folds across the traversal
        loops — compile times and step times blow up by orders of magnitude.
      scattering: optional ``(P,)`` per-polygon scattering coefficients in
        [0, 1]: at each hit the reflection is specular or cosine-diffuse by
        a fair coin, with the energy reweighted ``2(1-s)`` / ``2s`` — an
        unbiased estimator differentiable in ``s`` (module docstring).
        ``None`` -> pure specular.
      key: PRNG key for the scattering branches/lobes (required when
        ``scattering`` is given); per-bounce keys are fold-ins, so the same
        key gives a bitwise-deterministic trace.
      remat: rematerialize each bounce in the backward pass
        (``jax.checkpoint``) — O(1) live activations in bounce depth, for
        the deep reverb tails room acoustics needs (SURVEY.md §5
        "long-context analog").
    """
    d0 = normalize(rays.direction)
    n = rays.origin.shape[0]
    if scattering is not None and key is None:
        raise ValueError("scattering requires a PRNG key")

    class _S(NamedTuple):
        origin: jnp.ndarray
        direction: jnp.ndarray
        exclude: jnp.ndarray
        energy: jnp.ndarray
        dist: jnp.ndarray
        alive: jnp.ndarray

    # Varying-zero seed: under shard_map the scan carries must carry the same
    # "varying over mesh axis" type as the per-ray updates, so the constant
    # inits are derived from the (possibly varying) ray batch.
    vzero = jnp.sum(rays.origin, axis=-1) * 0.0
    init = _S(
        origin=rays.origin,
        direction=d0,
        exclude=rays.exclude_poly,
        energy=1.0 + vzero,
        dist=vzero,
        alive=vzero < 1.0,
    )

    def body(s: _S, bounce_key):
        r = Ray(s.origin, s.direction, s.exclude)
        hr = shoot_fn(scene, r) if aux is None else shoot_fn(scene, r, aux)
        live_hit = hr.hit & s.alive

        # The hit triangle's geometric normal now rides in the HitRecord
        # (computed by finalize_hits from the packed tri_geom row, with the
        # live-vertex gradient path supplied by its custom_vjp), so the
        # bounce needs no tri_meta or vertex gathers of its own.  The
        # coplanar edge-neighbor lanes come from the SAME tri_geom row
        # finalize gathered (XLA CSE merges the two gathers).
        tri = jnp.maximum(hr.tri_id, 0)
        nbr_rows = jax.lax.bitcast_convert_type(
            scene.tri_geom[tri][:, 10:13], jnp.int32
        )
        n_hat = normalize(hr.normal)

        pid = jnp.maximum(hr.poly_id, 0)
        a = absorption[pid]
        energy = s.energy * (1.0 - a)

        new_dir = reflect(s.direction, n_hat)
        if scattering is not None:
            sc = scattering[pid]
            kb, kd = jax.random.split(bounce_key)
            # Fair coin (s-INDEPENDENT, so grads in s are pathwise exact);
            # importance weight 2s / 2(1-s) keeps the estimator unbiased.
            diffuse = jax.random.bernoulli(kb, 0.5, (n,))
            energy = energy * jnp.where(diffuse, 2.0 * sc, 2.0 * (1.0 - sc))
            diff_dir = cosine_lobe(kd, n_hat, s.direction)
            new_dir = jnp.where(diffuse[:, None], diff_dir, new_dir)

        energy = jnp.where(live_hit, energy, s.energy)
        dist = s.dist + jnp.where(live_hit, hr.t, 0.0)

        out = (
            live_hit,
            jnp.where(live_hit, energy, 0.0),
            dist / sound_speed,
            jnp.where(live_hit, hr.poly_id, NO_POLY),
            hr.point,
            jnp.where(live_hit, hr.t, jnp.inf),
        )

        # Second exclusion slot (poly_origin2, Spatial_Partition.cs:33):
        # when the reflection point lies on a triangle edge shared with a
        # COPLANAR polygon, that polygon must be excluded too (the f32
        # origin can round to its far side and re-hit it at tiny t).
        # Barycentric edge proximity: w = weight(v0), u = weight(v1),
        # v = weight(v2); edge k joins corners (k, k+1).  The coplanarity
        # filter is pre-baked into Scene.tri_geom lanes 10-12 (mirroring
        # tri_meta lanes 1-3), so the nearest-edge neighbor is a 3-way
        # select — no gathers.
        w_b = 1.0 - hr.u - hr.v
        b0, b1, b2 = hr.v, w_b, hr.u  # edge 0/1/2 distance
        n01 = jnp.where(b0 <= b1, nbr_rows[:, 0], nbr_rows[:, 1])
        d01 = jnp.minimum(b0, b1)
        nbr = jnp.where(d01 <= b2, n01, nbr_rows[:, 2])
        on_edge = jnp.minimum(d01, b2) < EDGE_EPS
        ex2 = jnp.where(live_hit & on_edge & (nbr >= 0), nbr, NO_POLY)
        exclude = jnp.stack(
            [jnp.where(live_hit, hr.poly_id, NO_POLY), ex2], axis=-1
        )
        nxt = _S(
            origin=jnp.where(live_hit[:, None], hr.point, s.origin),
            direction=jnp.where(live_hit[:, None], new_dir, s.direction),
            exclude=exclude,
            energy=energy,
            dist=dist,
            alive=live_hit,
        )
        return nxt, out

    if scattering is not None:
        xs = jax.random.split(key, n_bounces)
    else:
        xs = jnp.zeros((n_bounces, 2), jnp.uint32)  # unused placeholder
    body_fn = jax.checkpoint(body) if remat else body
    _, (hit, energy, time, poly, point, t) = jax.lax.scan(
        body_fn, init, xs, length=n_bounces
    )
    return TraceResult(hit, energy, time, poly, point, t)


@partial(jax.jit, static_argnames=("n_bins", "soft"))
def energy_histogram(
    result: TraceResult, n_bins: int, bin_dt: float = 1e-3, soft: bool = False
) -> jnp.ndarray:
    """Time-binned impulse-response energy histogram, ``(n_bins,)``.

    Scatter-add of every bounce's post-absorption energy into
    ``floor(time / bin_dt)``; energies beyond the window are clamped into the
    last bin so totals are conserved (tests rely on total == sum of bounce
    energies).  The scatter-add goes through per-block partial histograms
    (``_binned_sum``) so that the f32 totals stay accurate at millions of
    entries.

    ``soft=True``: linear-interpolation ("tent") binning — each energy is
    split between the two bins whose CENTERS bracket its arrival time, in
    proportion to proximity.  The hard histogram is piecewise-constant in
    the arrival times, so ``d(histogram)/d(vertices)`` is zero almost
    everywhere and vertex fitting through a histogram loss cannot descend;
    the soft form is differentiable in time (hence in vertex positions via
    the hit distances) while conserving totals exactly.  Absorption /
    scattering gradients work under either form.
    """
    if soft:
        pos = result.time / bin_dt - 0.5  # bin i's center at (i + 0.5) dt
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), -1, n_bins - 1)
        frac = jnp.clip(pos - i0.astype(result.time.dtype), 0.0, 1.0)
        # Clamp boundary halves into the edge bins so totals are conserved.
        b_lo = jnp.where(result.hit, jnp.maximum(i0, 0), n_bins)
        b_hi = jnp.where(result.hit, jnp.minimum(i0 + 1, n_bins - 1), n_bins)
        e_hi = result.energy * frac
        e_lo = result.energy - e_hi
        return _binned_sum(
            jnp.concatenate([e_lo.ravel(), e_hi.ravel()]),
            jnp.concatenate([b_lo.ravel(), b_hi.ravel()]),
            n_bins,
        )
    bins = jnp.clip((result.time / bin_dt).astype(jnp.int32), 0, n_bins - 1)
    flat_bins = jnp.where(result.hit, bins, n_bins)  # dead lanes -> dropped
    return _binned_sum(result.energy.ravel(), flat_bins.ravel(), n_bins)


def _binned_sum(
    values: jnp.ndarray, bins: jnp.ndarray, n_bins: int
) -> jnp.ndarray:
    """Sum ``values`` into ``bins`` (bin ``n_bins`` is dropped), ``(n_bins,)``.

    One f32 accumulator per bin would take every entry: adding the same
    small energy over and over to a large running sum rounds the same way
    each time, which loses ~1e-4 of the total at 1M rays x 3 bounces.  So
    consecutive blocks of entries scatter into partial histograms of their
    own, which are then reduced over the blocks.  With a single block this
    is exactly the plain ``segment_sum``.
    """
    m = values.shape[0]
    n_blk = max(1, min(HIST_BLOCKS, m // HIST_BLOCK))
    blk = -(-m // n_blk)
    idx = (jnp.arange(m, dtype=jnp.int32) // blk) * (n_bins + 1) + bins
    part = jax.ops.segment_sum(values, idx, num_segments=n_blk * (n_bins + 1))
    return part.reshape(n_blk, n_bins + 1)[:, :n_bins].sum(axis=0)
