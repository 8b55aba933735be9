"""Eval-config benchmark runner (BASELINE.json configs 1-5, plus deep).

One config per process, one process at a time on a card (a JAX process
reserves most of the card's memory, so two side by side fail or spoil each
other's times):

    python benchmarks/configs.py 1          # shoebox brute-force
    python benchmarks/configs.py 2          # hall, grid, 100k rays
    python benchmarks/configs.py 3          # hall, octree, 1M rays + grads
    python benchmarks/configs.py 4          # 650k tris, KD-tree, vertex grads
    python benchmarks/configs.py 5          # 5.24M tris, grid, 1M rays (one card)
    python benchmarks/configs.py deep       # 32-bounce reverb tail + remat

Each run prints one JSON line naming the device it ran on.  Runs on a GPU
only, with the persistent compile cache of ``setup_compile_cache``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def timeit(fn, iters=5):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn()
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters


def big_scene(n_target: str = "650k"):
    """Procedural large scenes: shoebox shell + icospheres.

    Returns stacked (F, 3, 3) chunks (one per shape) — the fast ingest path
    of ``Topology.build`` (per-face Python lists dominate 5M-face builds).
    """
    from hare_tpu.mesh import shapes

    faces = [np.stack(shapes.shoebox(40.0, 40.0, 40.0))]
    if n_target == "650k":
        specs = [((12, 12, 12), 6.0, 7), ((28, 12, 12), 5.0, 6),
                 ((12, 28, 12), 5.0, 6), ((12, 12, 28), 5.0, 6),
                 ((28, 28, 28), 5.0, 6)]
    elif n_target == "1.3M":
        specs = [((20, 20, 20), 8.0, 8)]
    else:  # "5M": 4 x subdiv-8 icospheres = 5.24M tris + shell
        specs = [((10, 10, 10), 6.0, 8), ((30, 10, 12), 6.0, 8),
                 ((10, 30, 14), 6.0, 8), ((28, 28, 28), 6.0, 8)]
    for c, r, sub in specs:
        faces.append(np.stack(shapes.icosphere(sub, radius=r, center=c)))
    return faces


def emit(cfg, metric, value, unit, detail):
    print(json.dumps({
        "config": cfg, "metric": metric, "value": round(value, 3),
        "unit": unit, "detail": detail,
    }), flush=True)


def main(which: str):
    import jax
    import jax.numpy as jnp

    from hare_tpu.geom import Ray
    from hare_tpu.accel import SpatialPartition
    from hare_tpu.mesh import Topology, shapes
    from hare_tpu.trace import energy_histogram, trace_rays, uniform_sphere
    from hare_tpu.utils import require_gpu, setup_compile_cache

    d0 = require_gpu()
    setup_compile_cache()
    dev = {"platform": d0.platform, "device_kind": d0.device_kind,
           "device_count": len(jax.devices())}

    if which == "1":
        top = Topology.build(shapes.shoebox(4, 5, 3))
        sp = SpatialPartition(top, accel="brute")
        # NB: property access creates a fresh closure; hoist ONCE so the
        # jitted trace is not retraced (recompiled!) per timing iteration.
        shoot_fn = sp.shoot_fn
        n, B = 10_000, 3
        d = uniform_sphere(jax.random.PRNGKey(0), n)
        o = jnp.tile(jnp.array([2.0, 2.5, 1.5], jnp.float32), (n, 1))
        rays = Ray.make(o, d)
        a = jnp.full(top.n_polys, 0.3, jnp.float32)

        def run():
            res = trace_rays(sp.scene, rays, a, B, shoot_fn)
            return energy_histogram(res, 256, 1e-3)

        dt = timeit(run)
        emit(1, "Mrays/s fwd", n * B / dt / 1e6, "Mrays/s",
             {"tris": top.n_tris, "rays": n, "bounces": B, "device": dev})

    elif which in ("2", "3"):
        accel = "grid" if which == "2" else "octree"
        top = Topology.build(shapes.concert_hall())
        sp = SpatialPartition(top, accel=accel)
        # NB: property access creates a fresh closure; hoist ONCE so the
        # jitted trace is not retraced (recompiled!) per timing iteration.
        shoot_fn = sp.shoot_fn
        n = 100_000 if which == "2" else 1_000_000
        B = 3
        d = uniform_sphere(jax.random.PRNGKey(0), n)
        o = jnp.tile(jnp.array([15.0, 24.0, 8.0], jnp.float32), (n, 1))
        rays = Ray.make(o, d)
        a = jnp.full(top.n_polys, 0.3, jnp.float32)

        if which == "2":
            def run():
                res = trace_rays(sp.scene, rays, a, B, shoot_fn, aux=sp.aux)
                return energy_histogram(res, 1024, 1e-3)
            dt = timeit(run)
            emit(2, "Mrays/s fwd", n * B / dt / 1e6, "Mrays/s",
                 {"tris": top.n_tris, "rays": n, "accel": accel,
                  "bounces": B, "device": dev})
        else:
            def loss(a_, rays_, aux):
                res = trace_rays(sp.scene, rays_, a_, B, shoot_fn, aux=aux)
                return jnp.sum(energy_histogram(res, 1024, 1e-3))
            vg = jax.jit(jax.value_and_grad(loss))
            dt = timeit(lambda: vg(a, rays, sp.aux)[1])
            emit(3, "Mrays/s fwd+bwd(absorption)", n * B / dt / 1e6, "Mrays/s",
                 {"tris": top.n_tris, "rays": n, "accel": accel,
                  "bounces": B, "device": dev})

    elif which == "4":
        t0 = time.time()
        top = Topology.build(big_scene("650k"))
        t_topo = time.time() - t0
        t0 = time.time()
        # Leaf size 8 under SAH splits: SAH's empty-space cut-off and free
        # axis choice remove most straddler duplication, so small leaves
        # pay (tuned on the earlier accelerator, not yet measured on the H100).
        sp = SpatialPartition(top, accel="kdtree", max_tris_per_node=8)
        # NB: property access creates a fresh closure; hoist ONCE so the
        # jitted trace is not retraced (recompiled!) per timing iteration.
        shoot_fn = sp.shoot_fn
        t_accel = time.time() - t0
        n, B = 1 << 15, 2
        d = uniform_sphere(jax.random.PRNGKey(0), n)
        o = jnp.tile(jnp.array([20.0, 20.0, 20.0], jnp.float32), (n, 1))
        rays = Ray.make(o, d)
        a = jnp.full(top.n_polys, 0.3, jnp.float32)

        def loss(verts, rays_, aux):
            sc = sp.scene.with_vertices(verts)
            res = trace_rays(sc, rays_, a, B, shoot_fn, aux=aux)
            return jnp.sum(energy_histogram(res, 512, 1e-3))

        vg = jax.jit(jax.value_and_grad(loss))
        dt = timeit(lambda: vg(sp.scene.vertices, rays, sp.aux)[1], iters=3)
        g = vg(sp.scene.vertices, rays, sp.aux)[1]
        emit(4, "Mrays/s fwd+bwd(vertices)", n * B / dt / 1e6, "Mrays/s",
             {"tris": top.n_tris, "rays": n, "accel": "kdtree", "bounces": B,
              "topo_build_s": round(t_topo, 1),
              "accel_build_s": round(t_accel, 1),
              "win_data_MB": round(sp.struct.win_data.nbytes / 1e6),
              "grad_finite": bool(np.isfinite(np.asarray(g)).all()),
              "device": dev})

    elif which == "5":
        # True config-5 scale: 5.24M tris on a 256^3 grid (BASELINE.json
        # configs[4] is 5M tris / 100M rays across hosts; this is the
        # one-card half).
        t0 = time.time()
        top = Topology.build(big_scene("5M"))
        t_topo = time.time() - t0
        t0 = time.time()
        # Default knobs: the deep-tail variants (tier, cap_s) cut resume
        # rounds here but did not pay on the earlier accelerator; not yet
        # measured on the H100.
        sp = SpatialPartition(top, accel="grid", domain=256)
        # NB: property access creates a fresh closure; hoist ONCE so the
        # jitted trace is not retraced (recompiled!) per timing iteration.
        shoot_fn = sp.shoot_fn
        t_accel = time.time() - t0
        n, B = 1 << 20, 2  # 1M rays x 2 bounces = 2M ray queries per pass
        d = uniform_sphere(jax.random.PRNGKey(0), n)
        o = jnp.tile(jnp.array([20.0, 20.0, 20.0], jnp.float32), (n, 1))
        rays = Ray.make(o, d)
        a = jnp.full(top.n_polys, 0.3, jnp.float32)

        def run():
            res = trace_rays(sp.scene, rays, a, B, shoot_fn, aux=sp.aux)
            return energy_histogram(res, 1024, 1e-3)

        dt = timeit(run, iters=3)
        g = sp.struct
        emit(5, "Mrays/s fwd (one-card half of config 5)",
             n * B / dt / 1e6, "Mrays/s",
             {"tris": top.n_tris, "rays": n, "accel": "grid",
              "grid_dims": g.dims, "bounces": B,
              "topo_build_s": round(t_topo, 1),
              "accel_build_s": round(t_accel, 1),
              "win_data_MB": round(g.win_data.nbytes / 1e6),
              "meta_MB": round(g.cell_meta.nbytes / 1e6),
              "dup_slots_per_tri": round(
                  (g.win_data.shape[0] - 1)
                  * (g.win_data.shape[1] // 12) / top.n_tris, 2),
              "max_cell_wins": g.max_cell_wins,
              "device": dev})

    elif which == "deep":
        top = Topology.build(shapes.concert_hall())
        sp = SpatialPartition(top, accel="grid")
        # NB: property access creates a fresh closure; hoist ONCE so the
        # jitted trace is not retraced (recompiled!) per timing iteration.
        shoot_fn = sp.shoot_fn
        n, B = 1 << 14, 32
        d = uniform_sphere(jax.random.PRNGKey(0), n)
        o = jnp.tile(jnp.array([15.0, 24.0, 8.0], jnp.float32), (n, 1))
        rays = Ray.make(o, d)
        a = jnp.full(top.n_polys, 0.1, jnp.float32)

        for remat in (False, True):
            def loss(a_, rays_, aux):
                res = trace_rays(sp.scene, rays_, a_, B, shoot_fn,
                                 aux=aux, remat=remat)
                return jnp.sum(energy_histogram(res, 2048, 1e-3))
            vg = jax.jit(jax.value_and_grad(loss))
            dt = timeit(lambda: vg(a, rays, sp.aux)[1], iters=3)
            emit("deep", f"Mrays/s fwd+bwd 32-bounce remat={remat}",
                 n * B / dt / 1e6, "Mrays/s",
                 {"tris": top.n_tris, "rays": n, "bounces": B,
                  "remat": remat, "device": dev})
    else:
        raise SystemExit(f"unknown config {which!r}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "1")
