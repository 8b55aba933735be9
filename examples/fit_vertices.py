"""Inverse shape design, end to end: fit vertex POSITIONS to a target
impulse-response histogram.

The reference's entire shape-optimization hook is ``Set_Vertex``
(``Hare_Geometry_Topology.cs:506-511``) — it can move a vertex but cannot
tell you where to move it.  Here the whole bounce loop is differentiable in
the vertex coordinates, so the room geometry itself is recovered by gradient
descent from the IR alone.

Two nested loops (the documented large-move contract, Scene.tri_geom):

  inner — ``make_train_step(fit_vertices=True)``: traversal tables stay
    frozen (the hit-triangle ASSIGNMENT is approximate under the move), but
    forward hit values and gradients come from the live vertices via the
    refreshed ``tri_geom`` rows.  Soft (tent-binned) histograms are
    required: vertex positions reach the histogram only through arrival
    times, and hard binning has zero time-gradient a.e.
  outer — every ``--inner`` steps the Topology and accel structure are
    REBUILT at the current estimate, re-freezing the traversal tables at
    the new geometry.  Rebuilding re-welds (vertex order may change), so
    each outer round continues from the rebuilt topology's own arrays.

Runs on a GPU only, with the persistent compile cache of
``setup_compile_cache``.

Run:  python examples/fit_vertices.py --n-rays 2048 --steps 100
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax.numpy as jnp
import optax

from hare_tpu import HareConfig, Ray, SpatialPartition, Topology
from hare_tpu.dist import make_ray_mesh, make_train_step, sharded_histogram
from hare_tpu.mesh import shapes
from hare_tpu.trace import uniform_sphere
from hare_tpu.utils import MetricsLogger, require_gpu, setup_compile_cache


def extents(v: np.ndarray) -> np.ndarray:
    return v.max(axis=0) - v.min(axis=0)


def main(argv=None):
    require_gpu()
    setup_compile_cache()
    p = HareConfig.parser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--inner", type=int, default=25,
                   help="train steps between accel/topology rebuilds")
    ns = p.parse_args(argv)
    steps, inner = ns.steps, ns.inner
    del ns.__dict__["steps"], ns.__dict__["inner"]
    cfg = HareConfig(**vars(ns))

    mesh = make_ray_mesh()
    faces0 = shapes.shoebox(4.0, 5.0, 3.0)

    # Hidden truth: the same room anisotropically scaled 4-8% — the target
    # IR is rendered from a FULLY REBUILT partition at the true geometry.
    scale = np.array([1.08, 0.96, 1.04], np.float32)
    top_true = Topology.build([f * scale for f in faces0])
    sp_true = SpatialPartition(top_true, accel=cfg.accel, kernel=cfg.kernel,
                               **cfg.accel_params())
    a_fixed = jnp.full(top_true.n_polys, 0.2, jnp.float32)

    import jax
    n = (cfg.n_rays // mesh.size) * mesh.size
    d = uniform_sphere(jax.random.PRNGKey(cfg.seed), n)
    o = jnp.tile(jnp.asarray([[2.0, 2.5, 1.5]], jnp.float32), (n, 1))
    rays = Ray.make(o, d)

    hist_kw = dict(n_bounces=cfg.n_bounces, n_bins=cfg.n_bins,
                   bin_dt=cfg.bin_dt, soft=True)
    target = sharded_histogram(mesh, sp_true.shoot_fn, **hist_kw)(
        sp_true.scene, rays, a_fixed, sp_true.aux
    )

    opt = optax.adam(2e-2)
    log = MetricsLogger(cfg.metrics_path)
    a_raw = jnp.full(top_true.n_polys, float(np.log(0.2 / 0.8)), jnp.float32)

    # Start from the unscaled room; each outer round rebuilds everything at
    # the current estimate (rebuilding re-welds, so the round continues
    # from the REBUILT topology's own vertex order and face list).
    top = Topology.build(faces0)
    loss = first_loss = None
    i = 0
    while i < steps:
        sp = SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel,
                              **cfg.accel_params())
        step_fn = make_train_step(mesh, sp.shoot_fn, opt, fit_vertices=True,
                                  n_bounces=cfg.n_bounces, n_bins=cfg.n_bins,
                                  bin_dt=cfg.bin_dt)
        params = {"absorption": a_raw, "vertices": sp.scene.vertices}
        opt_state = opt.init(params)
        for _ in range(min(inner, steps - i)):
            params, opt_state, loss = step_fn(
                params, opt_state, sp.scene, rays, target, sp.aux
            )
            if first_loss is None:
                first_loss = float(loss)
            i += 1
        # Carry absorption progress across the rebuild (vertices carry via
        # v_est below; optimizer moments restart — acceptable for adam).
        a_raw = params["absorption"]
        v_est = np.asarray(params["vertices"])
        ext_err = float(
            np.abs(extents(v_est) - extents(top_true.vertices)).max()
        )
        log.write(step=i, loss=float(loss), extent_err=ext_err, rays=n)
        print(f"step {i:4d}  loss {float(loss):12.6f}  "
              f"max extent err {ext_err:.4f} m  (rebuild)")
        # Rebuild the mesh at the estimate for the next outer round.
        top = Topology.from_indexed(v_est, top.poly_verts)

    ext_err = float(np.abs(extents(np.asarray(top.vertices))
                           - extents(top_true.vertices)).max())
    reduction = float(loss) / first_loss
    print(f"loss: {first_loss:.4f} -> {float(loss):.4f} "
          f"({1/reduction:.0f}x reduction); "
          f"final max extent error {ext_err:.4f} m (a diagnostic — the IR "
          f"constrains arrival-time combinations, not extents directly)")
    return reduction


if __name__ == "__main__":
    # Success = the IR match improved by >= 10x (the histogram is the
    # objective; extent recovery needs many more rays/bins than a demo run).
    sys.exit(0 if main() < 0.1 else 1)
