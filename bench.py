"""Benchmark runner: prints ONE JSON line.

Metric: Mrays/s forward+backward on the 82k-tri bench scene through the
voxel-grid DDA backend, gradients w.r.t. absorption, 3 bounces.  The
reference publishes no numbers.  Runs on a GPU only (``require_gpu``), in
one process, with the persistent compile cache of ``setup_compile_cache``.

    python bench.py
"""

import json
import time

import jax
import jax.numpy as jnp

from hare_tpu.accel import SpatialPartition
from hare_tpu.geom import Ray
from hare_tpu.mesh import Topology, shapes
from hare_tpu.trace import energy_histogram, trace_rays, uniform_sphere
from hare_tpu.utils import require_gpu, setup_compile_cache

N_RAYS = 1 << 15
N_BOUNCES = 3
N_BINS = 1024
BIN_DT = 1e-3
CENTER = (10.0, 10.0, 10.0)


def bench_topology() -> Topology:
    """81,932 tris: a subdivided icosphere inside a 20 m shoebox shell."""
    faces = shapes.shoebox(20.0, 20.0, 20.0) + shapes.icosphere(
        6, radius=6.0, center=CENTER
    )
    return Topology.build(faces)


def bench_rays() -> Ray:
    """Rays leaving the sphere's surface outward, uniformly in direction."""
    d = uniform_sphere(jax.random.PRNGKey(0), N_RAYS)
    o = jnp.tile(jnp.array(CENTER, jnp.float32), (N_RAYS, 1))
    return Ray.make(o + 6.5 * d, d)


def main():
    dev = require_gpu()
    setup_compile_cache()

    top = bench_topology()
    sp = SpatialPartition(top, accel="grid", domain=48)
    rays = bench_rays()
    a = jnp.full(top.n_polys, 0.3, jnp.float32)
    shoot_fn = sp.shoot_fn

    # NB: scene and aux are ARGUMENTS, never closures — closed-over device
    # arrays become embedded jit constants and destroy compile/step time.
    def loss(scene, a_, rays_, aux):
        res = trace_rays(scene, rays_, a_, N_BOUNCES, shoot_fn, aux=aux)
        return jnp.sum(energy_histogram(res, N_BINS, BIN_DT))

    fwd_bwd = jax.jit(jax.value_and_grad(loss, argnums=1))
    fwd = jax.jit(loss)
    args = (sp.scene, a, rays, sp.aux)

    jax.block_until_ready(fwd_bwd(*args))  # compile
    jax.block_until_ready(fwd(*args))

    def timeit(fn, iters=10):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)  # one sync for the whole queue
        return (time.perf_counter() - t0) / iters

    dt = timeit(fwd_bwd)
    dt_f = timeit(fwd)

    total_rays = N_RAYS * N_BOUNCES  # each bounce is a full shoot
    print(
        json.dumps(
            {
                "metric": "Mrays/s fwd+bwd (82k-tri scene, grid DDA, 3-bounce)",
                "value": round(total_rays / dt / 1e6, 3),
                "unit": "Mrays/s",
                "detail": {
                    "fwd_mrays": round(total_rays / dt_f / 1e6, 3),
                    "fwd_ms": round(dt_f * 1e3, 2),
                    "bwd_over_fwd": round(dt / dt_f, 2),
                    "step_ms": round(dt * 1e3, 2),
                    "n_tris": top.n_tris,
                    "n_rays": N_RAYS,
                    "n_bounces": N_BOUNCES,
                    "grid_dims": sp.struct.dims,
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                    "device_count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
