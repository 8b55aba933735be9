"""Inverse acoustic design, end to end: fit per-surface absorption to a
target impulse-response histogram.

This is the use-case the differentiable tracer exists for (SURVEY.md §7 L5):
the reference can only *evaluate* reflections (its consumer loops ``Shoot``
by hand); here the whole bounce loop is differentiable, so absorption
coefficients are recovered by gradient descent from the IR alone.

Exercises the full production surface in one script: HareConfig (CLI),
SpatialPartition (accel choice), sharded train step over a device mesh,
JSONL metrics, Orbax checkpoint/resume, and the timing helper.  Runs on a
GPU only, with the persistent compile cache of ``setup_compile_cache``.

Run:  python examples/fit_absorption.py --n-rays 8192 --steps 60
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a source checkout (mirrors benchmarks/).
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from hare_tpu import HareConfig, Ray, SpatialPartition, Topology
from hare_tpu.dist import make_ray_mesh, make_train_step, sharded_histogram
from hare_tpu.mesh import shapes
from hare_tpu.trace import uniform_sphere
from hare_tpu.utils import (
    MetricsLogger,
    latest_step,
    require_gpu,
    restore_state,
    save_state,
    setup_compile_cache,
    timed,
)


def main(argv=None):
    require_gpu()
    setup_compile_cache()
    p = HareConfig.parser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument(
        "--fit-scattering", action="store_true",
        help="jointly recover per-surface scattering coefficients",
    )
    ns = p.parse_args(argv)
    steps = ns.steps
    fit_scattering = ns.fit_scattering
    del ns.__dict__["steps"], ns.__dict__["fit_scattering"]
    cfg = HareConfig(**vars(ns))

    # --- scene: the concert hall with a hidden "true" absorption pattern.
    top = Topology.build(shapes.concert_hall())
    sp = SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel,
                          **cfg.accel_params())
    mesh = make_ray_mesh()
    print(f"scene: {top.n_tris} tris, accel={cfg.accel}, "
          f"mesh={mesh.devices.shape} devices")

    key = jax.random.PRNGKey(cfg.seed)
    n = (cfg.n_rays // mesh.size) * mesh.size
    d = uniform_sphere(key, n)
    o = jnp.tile(jnp.asarray([[15.0, 24.0, 8.0]], jnp.float32), (n, 1))
    rays = Ray.make(o, d)

    # Hidden truth: one absorption in [0.1, 0.7] per MATERIAL (and, with
    # --fit-scattering, one scattering in [0.2, 0.8]).  A surface's material
    # is the axis its normal is closest to: surfaces facing x, facing y,
    # and floors/ceilings.  One histogram has fewer bins than the hall has
    # polygons, so a per-polygon truth could not be recovered from it.
    materials = np.abs(top.poly_normal).argmax(axis=1)
    n_mat = 3
    rng = np.random.default_rng(cfg.seed)
    a_mat = jnp.asarray(rng.uniform(0.1, 0.7, n_mat), jnp.float32)
    a_true = a_mat[materials]
    hist_fn = sharded_histogram(mesh, sp.shoot_fn, cfg.n_bounces, cfg.n_bins,
                                cfg.bin_dt, use_scattering=fit_scattering)
    extra = ()
    if fit_scattering:
        s_true = jnp.asarray(rng.uniform(0.2, 0.8, n_mat), jnp.float32)[materials]
        extra = (s_true, key)
    target = hist_fn(sp.scene, rays, a_true, sp.aux, *extra)

    # --- optimizer state (resume from checkpoint when present).
    opt = optax.adam(0.1)
    params = {"absorption": jnp.zeros(n_mat, jnp.float32)}
    if fit_scattering:
        params["scattering"] = jnp.zeros(n_mat, jnp.float32)
    opt_state = opt.init(params)
    state = {"params": params, "opt_state": opt_state, "rng": key,
             "cursor": jnp.asarray(0)}
    start = 0
    if cfg.checkpoint_dir and latest_step(cfg.checkpoint_dir) is not None:
        state = restore_state(cfg.checkpoint_dir, state)
        start = int(state["cursor"])
        print(f"resumed from step {start}")

    step_fn = make_train_step(mesh, sp.shoot_fn, opt, cfg.n_bounces,
                              cfg.n_bins, cfg.bin_dt,
                              use_scattering=fit_scattering,
                              materials=jnp.asarray(materials))
    log = MetricsLogger(cfg.metrics_path)
    step_extra = (key,) if fit_scattering else ()

    # The step returns its state replicated over the mesh; placing the
    # initial state the same way keeps the first call from compiling a
    # second program for the later ones.
    params, opt_state = jax.device_put(
        (state["params"], state["opt_state"]), NamedSharding(mesh, P()))
    for i in range(start, steps):
        params, opt_state, loss = step_fn(
            params, opt_state, sp.scene, rays, target, sp.aux, *step_extra
        )
        if i % 10 == 0 or i == steps - 1:
            a_est = jax.nn.sigmoid(params["absorption"])[materials]
            err = float(jnp.abs(a_est - a_true).mean())
            extra_log = {}
            if fit_scattering:
                s_est = jax.nn.sigmoid(params["scattering"])[materials]
                extra_log["mean_abs_err_s"] = float(
                    jnp.abs(s_est - s_true).mean()
                )
            log.write(step=i, loss=float(loss), mean_abs_err=err,
                      rays=n, bounces=cfg.n_bounces, **extra_log)
            print(f"step {i:4d}  loss {float(loss):10.4f}  "
                  f"mean |a-a*| {err:.4f}"
                  + (f"  |s-s*| {extra_log['mean_abs_err_s']:.4f}"
                     if fit_scattering else ""))
            if cfg.checkpoint_dir:
                save_state(cfg.checkpoint_dir, i, {
                    "params": params, "opt_state": opt_state,
                    "rng": key, "cursor": jnp.asarray(i + 1),
                })

    dt, _ = timed(
        lambda: step_fn(params, opt_state, sp.scene, rays, target, sp.aux,
                        *step_extra),
        iters=5,
    )
    print(f"steady-state step: {dt*1e3:.1f} ms  "
          f"({n * cfg.n_bounces / dt / 1e6:.2f} Mrays/s fwd+bwd)")
    a_est = jax.nn.sigmoid(params["absorption"])[materials]
    err = float(jnp.abs(a_est - a_true).mean())
    print(f"final mean |a - a_true| = {err:.4f}")
    return err


if __name__ == "__main__":
    sys.exit(0 if main() < 0.1 else 1)
