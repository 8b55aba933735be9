"""Multi-chip execution: rays sharded, geometry replicated, psum reductions.

The reference is a single-process C# library whose only parallelism is a
thread-per-core voxel fill (SURVEY.md §2) — it has no distributed story at
all.  The design here: a 1-D device mesh
over a ``'rays'`` axis; ray batches shard ``P('rays')``, the Scene and
material parameters replicate, per-bounce energies scatter into local
histograms that ``psum`` over the mesh, and parameter gradients all-reduce
automatically through shard_map's AD transpose.  Ray-level data parallelism
is the one strategy that applies to a ray tracer — there is no tensor/
pipeline/expert analog to invent (SURVEY.md §2, parallelism table).

Across processes or hosts the same code runs under
``jax.distributed.initialize()`` with the global mesh spanning them; XLA
inserts the collectives (NCCL between GPUs) from the same specs.  The cards
of one host are joined all to all, so the mesh stays 1-D: its shape
follows the algorithm, not a topology.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, PartitionSpec as P

from ..geom.primitives import HitRecord, Ray
from ..mesh.scene import Scene
from ..trace.bounce import SOUND_SPEED, energy_histogram, trace_rays

__all__ = [
    "make_ray_mesh",
    "sharded_histogram",
    "make_train_step",
    "init_distributed",
]


def init_distributed(**kwargs) -> None:
    """Multi-process bring-up: ``jax.distributed.initialize`` passthrough.

    Call once per process before building meshes that span processes.
    No-op if already initialized; any other failure to initialize raises.
    """
    if not jax.distributed.is_initialized():
        jax.distributed.initialize(**kwargs)


def make_ray_mesh(n_devices: Optional[int] = None, axis: str = "rays") -> Mesh:
    """A 1-D mesh over all (or the first n) devices, axis name ``'rays'``.

    ``AxisType.Auto`` so shard_map takes the mesh explicitly — no
    process-global ``jax.set_mesh`` state, outputs are ordinary replicated
    arrays, and user-side ``jax.grad`` composes straight through."""
    n = n_devices or len(jax.devices())
    return jax.make_mesh(
        (n,), (axis,), devices=jax.devices()[:n], axis_types=(AxisType.Auto,)
    )


def sharded_histogram(
    mesh: Mesh,
    shoot_fn: Callable[[Scene, Ray], HitRecord],
    n_bounces: int,
    n_bins: int,
    bin_dt: float = 1e-3,
    sound_speed: float = SOUND_SPEED,
    axis: str = "rays",
    use_scattering: bool = False,
    soft: bool = False,
):
    """Build a jitted ``(scene, rays, absorption[, scattering, key]) ->
    histogram`` that shards rays over the mesh and psums the per-device
    histograms.  ``soft=True`` uses the tent-binned histogram (time- and
    hence vertex-differentiable; see :func:`energy_histogram`).

    Differentiable in ``absorption`` (and ``scattering``/``scene.vertices``):
    shard_map's transpose turns the replicated-in/psum-out structure into the
    gradient all-reduce — no hand-written collectives.

    With ``use_scattering`` the PRNG key is replicated and folded with the
    device's mesh position, so shards draw decorrelated scattering branches
    (an estimator property, not a value identity: the sharded histogram is a
    different — equally unbiased — Monte Carlo sample than single-device).
    """

    def local(scene, rays, absorption, aux, *rest):
        kw = {}
        if use_scattering:
            s, key = rest
            kw = dict(
                scattering=s,
                key=jax.random.fold_in(key, jax.lax.axis_index(axis)),
            )
        res = trace_rays(
            scene, rays, absorption, n_bounces, shoot_fn, aux=aux,
            sound_speed=sound_speed, **kw,
        )
        hist = energy_histogram(res, n_bins, bin_dt, soft=soft)
        return jax.lax.psum(hist, axis)

    extra = (P(), P()) if use_scattering else ()
    smap = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(), P()) + extra,
        out_specs=P(),
    )
    jfn = jax.jit(smap)

    def fn(scene, rays, absorption, aux=None, *rest):
        return jfn(scene, rays, absorption, aux, *rest)

    return fn


def make_train_step(
    mesh: Mesh,
    shoot_fn: Callable[[Scene, Ray], HitRecord],
    optimizer,
    n_bounces: int,
    n_bins: int,
    bin_dt: float = 1e-3,
    fit_vertices: bool = False,
    axis: str = "rays",
    use_scattering: bool = False,
    soft: Optional[bool] = None,
    materials: Optional[jnp.ndarray] = None,
):
    """A full sharded training step for inverse acoustic design.

    Fits per-polygon absorption (optionally scattering coefficients and
    vertex positions) so the simulated impulse-response histogram matches a
    target — the end-to-end use-case the differentiable tracer exists for.
    Returns ``step(params, opt_state, scene, rays, target, aux[, key]) ->
    (params, opt_state, loss)`` ready to jit over the mesh; gradients
    all-reduce inside.

    params: dict with 'absorption' (P,); optionally 'scattering' (P,) (pass
    ``use_scattering=True``) and 'vertices' (V, 3).

    ``materials``: optional ``(P,)`` int array mapping each polygon to a
    material; 'absorption' and 'scattering' are then ``(M,)``, one value
    per material.  One histogram has far fewer bins than a real scene has
    polygons, so per-polygon coefficients are underdetermined; rooms are
    built from a few materials, and fitting those is well posed.

    ``soft`` (histogram binning) defaults to ``fit_vertices``: vertex
    positions only reach the histogram through arrival TIMES, and the hard
    histogram is piecewise-constant in time — zero gradient almost
    everywhere — so vertex fitting requires the tent-binned form (see
    :func:`energy_histogram`).  Build the TARGET histogram with the same
    ``soft`` setting.  For large vertex moves, rebuild the accel structure
    every few steps in an outer loop (``examples/fit_vertices.py``).
    """
    soft_hist = fit_vertices if soft is None else soft

    def per_poly(x):
        return x if materials is None else x[materials]

    def local_loss(params, scene, rays, target, aux, *rest):
        a = per_poly(jax.nn.sigmoid(params["absorption"]))  # keep in (0, 1)
        if fit_vertices:
            scene = scene.with_vertices(params["vertices"])
        kw = {}
        if use_scattering:
            kw = dict(
                scattering=per_poly(jax.nn.sigmoid(params["scattering"])),
                key=jax.random.fold_in(rest[0], jax.lax.axis_index(axis)),
            )
        res = trace_rays(scene, rays, a, n_bounces, shoot_fn, aux=aux, **kw)
        hist = energy_histogram(res, n_bins, bin_dt, soft=soft_hist)
        hist = jax.lax.psum(hist, axis)
        return jnp.sum((hist - target) ** 2) / n_bins

    def local_step(params, opt_state, scene, rays, target, aux, *rest):
        loss, grads = jax.value_and_grad(local_loss)(
            params, scene, rays, target, aux, *rest
        )
        # shard_map gives per-device identical replicated grads for unmapped
        # params (its transpose psums the batched contributions).
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    extra = (P(),) if use_scattering else ()
    smap = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(), P()) + extra,
        out_specs=(P(), P(), P()),
    )
    jstep = jax.jit(smap)

    def step(params, opt_state, scene, rays, target, aux=None, *rest):
        return jstep(params, opt_state, scene, rays, target, aux, *rest)

    return step
