"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4 item 5)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from hare_tpu.geom import Ray
from hare_tpu.accel import SpatialPartition
from hare_tpu.dist import make_ray_mesh, make_train_step, sharded_histogram
from hare_tpu.mesh import Topology, shapes
from hare_tpu.trace import energy_histogram, trace_rays, uniform_sphere


def setup(n_rays=256, accel="grid"):
    # Parametrized over every non-brute backend so one backend bug cannot
    # zero out ALL multichip evidence (the r2 failure mode: a grid-only
    # regression took down every distribution test at once); r4 adds the
    # KD-tree (VERDICT r3 item 5 — its varying-zero carry pattern under
    # shard_map was the one untested backend x sharding interaction).
    top = Topology.build(shapes.shoebox(4, 5, 3))
    params = {"domain": 4} if accel == "grid" else {}
    sp = SpatialPartition(top, accel=accel, **params)
    a = jnp.asarray(
        np.random.default_rng(0).uniform(0.1, 0.5, top.n_polys), jnp.float32
    )
    d = uniform_sphere(jax.random.PRNGKey(0), n_rays)
    o = jnp.tile(jnp.array([2.0, 2.5, 1.5], jnp.float32), (n_rays, 1))
    return top, sp, a, Ray.make(o, d)


def test_eight_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("accel", ["grid", "octree", "kdtree"])
def test_sharded_matches_single(accel):
    """Sharded histogram == single-device histogram (bitwise-determinism
    analog of the reference-absent race tests, SURVEY.md §5)."""
    top, sp, a, rays = setup(accel=accel)
    mesh = make_ray_mesh(8)
    fn = sharded_histogram(mesh, sp.shoot_fn, n_bounces=3, n_bins=256)
    h_sharded = np.asarray(fn(sp.scene, rays, a, sp.aux))
    res = trace_rays(sp.scene, rays, a, 3, sp.shoot_fn, aux=sp.aux)
    h_single = np.asarray(energy_histogram(res, 256, 1e-3))
    np.testing.assert_allclose(h_sharded, h_single, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("accel", ["grid", "octree", "kdtree"])
def test_sharded_grad_matches_single(accel):
    top, sp, a, rays = setup(accel=accel)
    mesh = make_ray_mesh(8)
    fn = sharded_histogram(mesh, sp.shoot_fn, n_bounces=3, n_bins=256)

    def loss_sharded(a_):
        return jnp.sum(fn(sp.scene, rays, a_, sp.aux) ** 2)

    def loss_single(a_):
        res = trace_rays(sp.scene, rays, a_, 3, sp.shoot_fn, aux=sp.aux)
        return jnp.sum(energy_histogram(res, 256, 1e-3) ** 2)

    gs = np.asarray(jax.grad(loss_sharded)(a))
    g1 = np.asarray(jax.grad(loss_single)(a))
    np.testing.assert_allclose(gs, g1, rtol=1e-4, atol=1e-5)


def test_train_step_descends():
    """Full sharded inverse-design step: loss decreases over iterations."""
    top, sp, a_true, rays = setup(n_rays=512)
    mesh = make_ray_mesh(8)
    # Target histogram from the true absorption.
    fn = sharded_histogram(mesh, sp.shoot_fn, n_bounces=3, n_bins=128)
    target = fn(sp.scene, rays, a_true)

    opt = optax.adam(0.1)
    step = make_train_step(mesh, sp.shoot_fn, opt, n_bounces=3, n_bins=128)
    params = {"absorption": jnp.zeros(top.n_polys)}  # sigmoid -> 0.5 start
    opt_state = opt.init(params)
    losses = []
    for _ in range(20):
        params, opt_state, loss = step(params, opt_state, sp.scene, rays, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, losses


def test_train_step_materials():
    """``materials`` ties polygons to shared coefficients: the identity map
    is the per-polygon step exactly, and a 3-material truth is recovered."""
    top, sp, _, rays = setup(n_rays=512)
    mesh = make_ray_mesh(8)
    opt = optax.adam(0.1)
    fn = sharded_histogram(mesh, sp.shoot_fn, n_bounces=3, n_bins=128)
    mats = np.abs(top.poly_normal).argmax(axis=1)
    a_mat = jnp.asarray([0.15, 0.45, 0.3], jnp.float32)
    target = fn(sp.scene, rays, a_mat[mats])

    plain = make_train_step(mesh, sp.shoot_fn, opt, n_bounces=3, n_bins=128)
    ident = make_train_step(mesh, sp.shoot_fn, opt, n_bounces=3, n_bins=128,
                            materials=jnp.arange(top.n_polys))
    p0 = {"absorption": jnp.zeros(top.n_polys)}
    out_p = plain(p0, opt.init(p0), sp.scene, rays, target)
    out_i = ident(p0, opt.init(p0), sp.scene, rays, target)
    for x, y in zip(jax.tree.leaves(out_p), jax.tree.leaves(out_i)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    step = make_train_step(mesh, sp.shoot_fn, opt, n_bounces=3, n_bins=128,
                           materials=jnp.asarray(mats))
    params = {"absorption": jnp.zeros(3)}
    opt_state = opt.init(params)
    for _ in range(60):
        params, opt_state, _ = step(params, opt_state, sp.scene, rays, target)
    err = np.abs(np.asarray(jax.nn.sigmoid(params["absorption"])) - a_mat)
    assert err.max() < 0.05, err


def test_vertex_train_step_descends():
    """Sharded fit_vertices=True step actually reduces loss over iterations
    — the r4 API shipped this path but its loss was insensitive to the
    vertex parameters (forward read build-time geometry rows)."""
    top, sp, _, rays = setup(n_rays=256)
    mesh = make_ray_mesh(8)
    v_build = sp.scene.vertices
    v_true = v_build * 1.03
    a_raw = jnp.full(top.n_polys, 0.3, jnp.float32)
    # Target from the same pipeline (soft binning to match the train step).
    fn = sharded_histogram(
        mesh, sp.shoot_fn, n_bounces=2, n_bins=64, bin_dt=2e-3, soft=True
    )
    target = fn(sp.scene.with_vertices(v_true), rays, a_raw)

    opt = optax.adam(2e-2)
    step = make_train_step(
        mesh, sp.shoot_fn, opt, n_bounces=2, n_bins=64, bin_dt=2e-3,
        fit_vertices=True,
    )
    # Absorption initialized AT its true value (sigmoid(logit(0.3)) = 0.3)
    # so the loss isolates the vertex path.
    params = {
        "absorption": jnp.full(top.n_polys, float(np.log(0.3 / 0.7))),
        "vertices": v_build,
    }
    opt_state = opt.init(params)
    losses = []
    for _ in range(30):
        params, opt_state, loss = step(
            params, opt_state, sp.scene, rays, target
        )
        losses.append(float(loss))
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    # And the vertex parameters actually moved (the r4 bug left them with
    # zero gradient, so they would sit exactly at the init).
    assert float(jnp.abs(params["vertices"] - v_build).max()) > 1e-3
    # NB: max|v - v_true| is NOT asserted to shrink — a histogram only
    # constrains arrival-time combinations, not individual vertices.


def test_sharded_scattering_train_step():
    """Sharded joint (absorption, scattering) fit: decorrelated per-shard
    RNG, loss decreases, grads finite for both coefficient sets."""
    top, sp, a_true, rays = setup(n_rays=512)
    mesh = make_ray_mesh(8)
    s_true = jnp.full(top.n_polys, 0.6, jnp.float32)
    key = jax.random.PRNGKey(3)

    fn = sharded_histogram(
        mesh, sp.shoot_fn, n_bounces=3, n_bins=128, use_scattering=True
    )
    target = fn(sp.scene, rays, a_true, None, s_true, key)
    assert np.isfinite(np.asarray(target)).all()
    # Determinism: same key -> bitwise-same sharded histogram.
    np.testing.assert_array_equal(
        np.asarray(target),
        np.asarray(fn(sp.scene, rays, a_true, None, s_true, key)),
    )

    opt = optax.adam(0.1)
    step = make_train_step(
        mesh, sp.shoot_fn, opt, n_bounces=3, n_bins=128, use_scattering=True
    )
    params = {
        "absorption": jnp.zeros(top.n_polys),
        "scattering": jnp.zeros(top.n_polys),
    }
    opt_state = opt.init(params)
    losses = []
    for _ in range(15):
        params, opt_state, loss = step(
            params, opt_state, sp.scene, rays, target, None, key
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, losses
    assert np.isfinite(np.asarray(params["scattering"])).all()
