"""On-card smoke test: drive hare_tpu's main paths once on a GPU and check
each against the repo's plain references.

    python chip_smoke.py          # one card: device, shoot, trace, vertices, train
    python chip_smoke.py --four   # four cards: sharded histogram + train step
                                  # on a 4-card mesh against a 1-card mesh

Everything runs in this one process (a second JAX process could not open the
card while this one holds it), including the CPU references.  Each phase
prints its findings on lines that name the card and its power limit; the
last line is one JSON object, printed only when every phase passed.  There
is no CPU fallback: without a GPU the script exits non-zero at once.

Tolerances (all float32, no matrix product anywhere on these paths):

- accel shoot vs brute force on the same card: ``hit`` identical, ``t``
  within rtol 1e-5, ``tri_id`` identical except on shared-edge or duplicate
  ties (equal ``t``), and those on at most 1e-4 of the rays;
- device shoot vs the float64 oracle: ``hit`` identical, ``t`` within rtol
  1e-4, ``poly_id`` identical on hits;
- GPU vs CPU trace: histogram total within 1e-5 relative, every bin within
  1e-4 of the largest bin, gradient within 1e-4 relative L2.  The GPU adds
  a scatter (``segment_sum``, the gather transpose in the backward pass) in
  no fixed order, and XLA may contract multiply-adds into FMAs differently
  on the two backends, so the two are equal only to rounding.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp

import bench
from hare_tpu.accel import SpatialPartition
from hare_tpu.geom import Ray
from hare_tpu.mesh import Topology, shapes
from hare_tpu.oracle import oracle_shoot
from hare_tpu.trace import energy_histogram, trace_rays, uniform_sphere
from hare_tpu.utils import require_gpu, setup_compile_cache

N_SHOOT = 1 << 20  # rays per accel shoot on the bench scene
N_REF = 1 << 16  # of those, the ones compared with brute force
N_ORACLE = 256  # concert-hall rays compared with the float64 oracle
HALL_SOURCE = (15.0, 24.0, 8.0)
HALL_INTERIOR = ((2.0, 10.0, 2.0), (27.0, 40.0, 12.0))  # clear of fittings

CARD = "?"


def card_line() -> str:
    """The cards' ``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] ({CARD}) {msg}", flush=True)


# --------------------------------------------------------------- comparisons


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def compare_hits(ref, got, t_rtol: float = 1e-5,
                 max_tie_frac: float = 1e-4) -> int:
    """Check a shoot against brute force on the same rays; return the number
    of ``tri_id`` ties.  Raises AssertionError on any disagreement."""
    hit_r, hit_g = np.asarray(ref.hit), np.asarray(got.hit)
    n = hit_r.shape[0]
    bad = int(np.sum(hit_r != hit_g))
    if bad:
        raise AssertionError(f"hit differs on {bad} of {n} rays")
    t_r = np.asarray(ref.t)[hit_r]
    t_g = np.asarray(got.t)[hit_r]
    bad_t = ~(np.abs(t_g - t_r) <= t_rtol * np.abs(t_r))
    if bad_t.any():
        worst = float(np.max(np.abs(t_g - t_r) / np.abs(t_r)))
        raise AssertionError(
            f"t differs beyond rtol {t_rtol} on {int(bad_t.sum())} rays "
            f"(worst {worst:.3e})"
        )
    # Every hit's t already agrees within t_rtol, so a differing tri_id is a
    # tie between triangles at the same distance (shared edge, duplicate).
    ties = int(np.sum(np.asarray(ref.tri_id) != np.asarray(got.tri_id)))
    if ties > max_tie_frac * n:
        raise AssertionError(
            f"tri_id differs on {ties} of {n} rays (allowed {max_tie_frac:g})"
        )
    return ties


def compare_oracle(oracle_hits, got, t_rtol: float = 1e-4) -> None:
    """Check a shoot against ``oracle_shoot`` results (dict or None)."""
    hit_o = np.array([h is not None for h in oracle_hits])
    hit_g = np.asarray(got.hit)
    bad = int(np.sum(hit_o != hit_g))
    if bad:
        raise AssertionError(f"hit differs from the oracle on {bad} rays")
    idx = np.flatnonzero(hit_o)
    t_o = np.array([oracle_hits[i]["t"] for i in idx])
    p_o = np.array([oracle_hits[i]["poly_id"] for i in idx])
    t_g = np.asarray(got.t, np.float64)[idx]
    bad_t = ~(np.abs(t_g - t_o) <= t_rtol * np.abs(t_o))
    if bad_t.any():
        raise AssertionError(
            f"t differs from the oracle beyond rtol {t_rtol} on "
            f"{int(bad_t.sum())} rays"
        )
    bad_p = int(np.sum(np.asarray(got.poly_id)[idx] != p_o))
    if bad_p:
        raise AssertionError(f"poly_id differs from the oracle on {bad_p} rays")


def compare_trace(ref_hist, got_hist, ref_grad, got_grad,
                  total_rtol: float = 1e-5, bin_frac: float = 1e-4,
                  grad_rl2: float = 1e-4) -> dict:
    """Check a histogram and its gradient against a reference run."""
    h_r = np.asarray(ref_hist, np.float64)
    h_g = np.asarray(got_hist, np.float64)
    tot_err = abs(h_g.sum() - h_r.sum()) / abs(h_r.sum())
    if not tot_err <= total_rtol:
        raise AssertionError(f"histogram total off by {tot_err:.3e} relative")
    bin_err = float(np.max(np.abs(h_g - h_r)) / np.max(np.abs(h_r)))
    if not bin_err <= bin_frac:
        raise AssertionError(
            f"histogram bin off by {bin_err:.3e} of the largest bin"
        )
    g_err = rel_l2(ref_grad, got_grad)
    if not np.isfinite(np.asarray(got_grad)).all() or not g_err <= grad_rl2:
        raise AssertionError(f"gradient off by {g_err:.3e} relative L2")
    return {"total_rel": tot_err, "bin_rel_max": bin_err, "grad_rel_l2": g_err}


# ------------------------------------------------------------------ helpers


def to_host(tree):
    return jax.tree.map(np.asarray, tree)


def take(rays: Ray, n: int) -> Ray:
    return jax.tree.map(lambda x: x[:n], rays)


def interior_rays(n: int, lo, hi, seed: int, avoid=None) -> Ray:
    """``n`` rays from origins uniform in the box [lo, hi] (outside the
    ball ``avoid = (center, radius)``), directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    o = np.empty((0, 3), np.float32)
    while o.shape[0] < n:
        p = rng.uniform(lo, hi, (2 * n, 3)).astype(np.float32)
        if avoid is not None:
            c, r = avoid
            p = p[np.linalg.norm(p - np.asarray(c, np.float32), axis=1) > r]
        o = np.concatenate([o, p])
    d = uniform_sphere(jax.random.PRNGKey(seed), n)
    return Ray.make(jnp.asarray(o[:n]), d)


def source_rays(n: int, source=HALL_SOURCE) -> Ray:
    """``n`` rays from one point source, directions uniform on the sphere."""
    d = uniform_sphere(jax.random.PRNGKey(0), n)
    return Ray.make(jnp.tile(jnp.asarray(source, jnp.float32), (n, 1)), d)


def shoot_job(sp: SpatialPartition, rays: Ray):
    """A shoot through ``sp``'s own entry point: ``(jitted fn, args)``."""
    return jax.jit(sp.shoot_fn), (sp.scene, rays, sp.aux)


def trace_job(sp: SpatialPartition, rays: Ray, a, n_bounces: int,
              n_bins: int, bin_dt: float = 1e-3, device=None):
    """``(jitted fn, args)`` of a trace, on ``device`` when given; the fn
    returns ``((sum, histogram), d sum(histogram) / d absorption)``."""
    shoot_fn = sp.shoot_fn

    def loss(scene, a_, rays_, aux):
        res = trace_rays(scene, rays_, a_, n_bounces, shoot_fn, aux=aux)
        h = energy_histogram(res, n_bins, bin_dt)
        return jnp.sum(h), h

    args = (sp.scene, a, rays, sp.aux)
    if device is not None:
        args = jax.device_put(args, device)
    return jax.jit(jax.value_and_grad(loss, argnums=1, has_aux=True)), args


def weighted_arrival(hist: jnp.ndarray) -> jnp.ndarray:
    """Energy-weighted arrival bin of a soft histogram.

    The histogram's total depends on absorption alone, so its gradient in
    vertex positions is identically zero; the arrival times carry that
    dependence, and the tent-binned histogram is differentiable in them."""
    return jnp.sum(hist * jnp.arange(hist.shape[0], dtype=hist.dtype))


class Programs:
    """The phases' jitted programs, compiled together up front.

    Tracing and lowering hold the interpreter lock, so they run one after
    another; XLA's compiles release it, so each starts in a thread as soon
    as its program is lowered, overlapping the lowering of the next.  A tree
    traversal takes minutes to compile for the GPU, and one after another
    they would not fit the run's time limit.  Add the slowest first."""

    def __init__(self):
        self.jobs = {}
        self.compiled = {}

    def add(self, name: str, fn, args) -> None:
        self.jobs[name] = (fn, args)

    def compile(self) -> None:
        def build(low):
            c0 = time.perf_counter()
            return low.compile(), time.perf_counter() - c0

        t0 = time.perf_counter()
        futures, secs = {}, {}
        with ThreadPoolExecutor(max_workers=len(self.jobs)) as ex:
            for n, (fn, args) in self.jobs.items():
                futures[n] = ex.submit(build, fn.lower(*args))
            t1 = time.perf_counter()
            for n, fut in futures.items():
                self.compiled[n], secs[n] = fut.result()
        log("compile", f"{len(futures)} programs: lowered in {t1 - t0:.1f} s,"
            f" all compiled after {time.perf_counter() - t0:.1f} s; each "
            "compile (s): " + ", ".join(f"{n} {t:.1f}" for n, t in secs.items()))

    def run(self, name: str):
        return self.compiled[name](*self.jobs[name][1])

    def timed(self, name: str):
        """(host result, first-call seconds, second-call seconds)."""
        t0 = time.perf_counter()
        jax.block_until_ready(self.run(name))
        t1 = time.perf_counter()
        out = jax.block_until_ready(self.run(name))
        t2 = time.perf_counter()
        return to_host(out), t1 - t0, t2 - t1


# ------------------------------------------------------------------- phases


def phase_device() -> jax.Device:
    dev = require_gpu()
    cache = setup_compile_cache()
    global CARD
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    stats = dev.memory_stats() or {}
    log("device", f"jax {jax.__version__}; platform {dev.platform}; "
        f"device_kind {dev.device_kind}; count {len(jax.devices())}; "
        f"bytes_limit {stats.get('bytes_limit')}; compile cache {cache}")
    return dev


BACKENDS = {
    "grid": dict(accel="grid", domain=48),
    "octree": dict(accel="octree"),
    "kdtree": dict(accel="kdtree"),
    "kdtree_ropes": dict(accel="kdtree_ropes"),
}


def bench_partitions(top: Topology):
    """The bench scene under every accel backend, with build seconds."""
    sps, builds = {}, {}
    for name, kw in BACKENDS.items():
        t0 = time.perf_counter()
        sps[name] = SpatialPartition(top, **kw)
        builds[name] = time.perf_counter() - t0
    return sps, builds


def prepare_shoot(progs: Programs, top: Topology, sps: dict, builds: dict,
                  hall: Topology, hall_grid: SpatialPartition) -> dict:
    rays = interior_rays(N_SHOOT, (0.5,) * 3, (19.5,) * 3, seed=0,
                         avoid=(bench.CENTER, 6.1))
    progs.add("shoot brute", *shoot_job(SpatialPartition(top, accel="brute"),
                                        take(rays, N_REF)))
    for name, sp in sps.items():
        progs.add(f"shoot {name}", *shoot_job(sp, rays))
    o_rays = interior_rays(N_ORACLE, *HALL_INTERIOR, seed=1)
    progs.add("oracle brute",
              *shoot_job(SpatialPartition(hall, accel="brute"), o_rays))
    progs.add("oracle grid", *shoot_job(hall_grid, o_rays))
    return dict(top=top, builds=builds, hall=hall, o_rays=o_rays)


def check_shoot(progs: Programs, st: dict) -> None:
    top, hall = st["top"], st["hall"]
    ref, t_first, t_run = progs.timed("shoot brute")
    log("shoot", f"brute {N_REF} rays x {top.n_tris} tris: first call "
        f"{t_first:.4f} s, second {t_run:.4f} s; hit fraction "
        f"{ref.hit.mean():.6f}")
    for name in BACKENDS:
        hr, t_first, t_run = progs.timed(f"shoot {name}")
        ties = compare_hits(ref, take(hr, N_REF))
        log("shoot", f"{name}: {N_SHOOT} rays, build {st['builds'][name]:.2f}"
            f" s, first call {t_first:.4f} s, second {t_run:.4f} s "
            f"({N_SHOOT / t_run / 1e6:.2f} Mrays/s, observation); vs brute "
            f"on {N_REF} rays: hit/t agree, tri_id ties {ties}")

    o_host = to_host(st["o_rays"])
    oracle = [oracle_shoot(hall, o_host.origin[i], o_host.direction[i])
              for i in range(N_ORACLE)]
    for name in ("brute", "grid"):
        compare_oracle(oracle, to_host(progs.run(f"oracle {name}")))
        log("shoot", f"{name} vs float64 oracle, concert hall "
            f"({hall.n_tris} tris, {N_ORACLE} rays): hit, t, poly_id agree")


def prepare_trace(progs: Programs, top: Topology, grid: SpatialPartition,
                  hall: Topology, hall_grid: SpatialPartition) -> None:
    # Config 3 at full size: concert hall, octree, 1M rays, 3 bounces.
    sp3 = SpatialPartition(hall, accel="octree")
    shoot3 = sp3.shoot_fn

    def loss3(scene, a_, rays_, aux):
        res = trace_rays(scene, rays_, a_, 3, shoot3, aux=aux)
        h = energy_histogram(res, 1024, 1e-3)
        return jnp.sum(h), (h, res.energy, res.hit, res.poly_id)

    a3 = jnp.full(hall.n_polys, 0.3, jnp.float32)
    progs.add("config3", jax.jit(jax.value_and_grad(loss3, argnums=1,
                                                    has_aux=True)),
              (sp3.scene, a3, source_rays(1 << 20), sp3.aux))

    # Deep cell: 32 bounces, gradient with and without per-bounce remat.
    shootd = hall_grid.shoot_fn
    ad = jnp.full(hall.n_polys, 0.1, jnp.float32)
    raysd = source_rays(1 << 14)
    for remat in (False, True):
        def lossd(scene, a_, rays_, aux, remat=remat):
            res = trace_rays(scene, rays_, a_, 32, shootd, aux=aux,
                             remat=remat)
            return jnp.sum(energy_histogram(res, 2048, 1e-3))

        progs.add(f"deep remat={remat}", jax.jit(jax.grad(lossd, argnums=1)),
                  (hall_grid.scene, ad, raysd, hall_grid.aux))

    # The bench cell on the GPU and on the CPU.
    cpu = jax.devices("cpu")[0]
    rays = bench.bench_rays()
    a = jnp.full(top.n_polys, 0.3, jnp.float32)
    job = (grid, rays, a, bench.N_BOUNCES, bench.N_BINS, bench.BIN_DT)
    progs.add("bench trace gpu", *trace_job(*job))
    progs.add("bench trace cpu", *trace_job(*job, device=cpu))


def check_trace(progs: Programs) -> None:
    ((_, h_g), g_g), _, t_g = progs.timed("bench trace gpu")
    ((_, h_c), g_c), _, t_c = progs.timed("bench trace cpu")
    errs = compare_trace(h_c, h_g, g_c, g_g)
    log("trace", f"bench cell ({bench.N_RAYS} rays, {bench.N_BOUNCES} "
        f"bounces, grid domain 48) GPU vs CPU: {errs}; second call GPU "
        f"{t_g:.4f} s, CPU {t_c:.3f} s")

    ((_, (h, e, hit, pid)), g), t_first, t_run = progs.timed("config3")
    for nm, x in (("histogram", h), ("energy", e), ("gradient", g)):
        if not np.isfinite(x).all():
            raise AssertionError(f"config 3: non-finite {nm}")
    tot_h = h.astype(np.float64).sum()
    tot_e = e.astype(np.float64).sum()
    if not abs(tot_h - tot_e) <= 1e-5 * tot_e:
        raise AssertionError(
            f"config 3: histogram total {tot_h} != bounce energies {tot_e}")
    polys_hit = np.unique(pid[hit])
    if not (g[polys_hit] <= 0).all():
        raise AssertionError("config 3: positive absorption gradient on a "
                             "polygon that was hit")
    log("trace", f"config 3 ({1 << 20} rays, octree, 3 bounces, fwd+bwd): "
        f"finite; histogram total {tot_h:.6e} vs bounce energies "
        f"{tot_e:.6e} (rel {abs(tot_h - tot_e) / tot_e:.2e}); grad <= 0 on "
        f"all {polys_hit.size} polygons hit; first call {t_first:.3f} s, "
        f"second {t_run:.3f} s (observation)")

    grads = {}
    for remat in (False, True):
        grads[remat], _, t_run = progs.timed(f"deep remat={remat}")
        log("trace", f"deep ({1 << 14} rays, 32 bounces) remat={remat}: "
            f"second call {t_run:.3f} s")
    err = rel_l2(grads[False], grads[True])
    if not np.isfinite(grads[True]).all() or not err <= 1e-5:
        raise AssertionError(f"deep: remat gradient off by {err:.3e} rel L2")
    log("trace", f"deep: remat and plain gradients agree, rel L2 {err:.3e}")


def prepare_vertices(progs: Programs, hall: Topology,
                     hall_grid: SpatialPartition) -> dict:
    from benchmarks.configs import big_scene

    t0 = time.perf_counter()
    top4 = Topology.build(big_scene("650k"))
    t1 = time.perf_counter()
    sp4 = SpatialPartition(top4, accel="kdtree", max_tris_per_node=8)
    t2 = time.perf_counter()
    shoot4 = sp4.shoot_fn
    rays4 = source_rays(1 << 15, (20.0, 20.0, 20.0))
    a4 = jnp.full(top4.n_polys, 0.3, jnp.float32)

    def loss4(verts, scene, rays_, aux):
        res = trace_rays(scene.with_vertices(verts), rays_, a4, 2, shoot4,
                         aux=aux)
        return weighted_arrival(energy_histogram(res, 512, 1e-3, soft=True))

    progs.add("config4", jax.jit(jax.value_and_grad(loss4)),
              (sp4.scene.vertices, sp4.scene, rays4, sp4.aux))
    # Id lanes (int32 bitcast into f32; -1 is a NaN payload, small ids are
    # subnormals) must survive the vertex splice bit for bit.
    progs.add("splice", jax.jit(lambda scene, v: scene.with_vertices(v).tri_geom),
              (sp4.scene, sp4.scene.vertices * 1.001))
    # Observation, not a check: would a plain f32 concatenate (no int-domain
    # splice) also keep the NaN-payload ids on this backend?
    progs.add("f32 concat", jax.jit(lambda tg: jnp.concatenate(
        [tg[:, :9] * 1.001, tg[:, 9:]], axis=1)), (sp4.scene.tri_geom,))

    # Concert hall, grid, soft histogram: vertex gradient GPU vs CPU.
    shooth = hall_grid.shoot_fn

    def lossh(verts, scene, rays_, a_, aux):
        res = trace_rays(scene.with_vertices(verts), rays_, a_, 3, shooth,
                         aux=aux)
        return weighted_arrival(energy_histogram(res, 1024, 1e-3, soft=True))

    argsh = (hall_grid.scene.vertices, hall_grid.scene, source_rays(1 << 13),
             jnp.full(hall.n_polys, 0.3, jnp.float32), hall_grid.aux)
    progs.add("hall vertex grad gpu", jax.jit(jax.grad(lossh)), argsh)
    progs.add("hall vertex grad cpu", jax.jit(jax.grad(lossh)),
              jax.device_put(argsh, jax.devices("cpu")[0]))
    return dict(top4=top4, sp4=sp4, t_topo=t1 - t0, t_kd=t2 - t1)


def check_vertices(progs: Programs, st: dict) -> None:
    (v, g), t_first, t_run = progs.timed("config4")
    if not (np.isfinite(v) and np.isfinite(g).all()):
        raise AssertionError("config 4: non-finite vertex gradient")
    if not np.any(g != 0):
        raise AssertionError("config 4: vertex gradient is all zero")
    log("vertices", f"config 4 ({st['top4'].n_tris} tris, kdtree leaf 8, "
        f"{1 << 15} rays, 2 bounces): vertex grad finite, "
        f"{int(np.any(g != 0, axis=1).sum())} vertices non-zero; topology "
        f"{st['t_topo']:.1f} s, kd build {st['t_kd']:.1f} s, first call "
        f"{t_first:.3f} s, second {t_run:.3f} s (observation)")

    old = np.asarray(st["sp4"].scene.tri_geom).view(np.int32)[:, 9:]
    new = np.asarray(progs.run("splice")).view(np.int32)[:, 9:]
    if not np.array_equal(old, new):
        raise AssertionError(
            f"with_vertices changed {int(np.sum(old != new))} id lanes")
    log("vertices", f"with_vertices id lanes bitwise equal ({old.size} lanes,"
        f" {int(np.sum(old == -1))} of them -1)")
    plain = np.asarray(progs.run("f32 concat")).view(np.int32)[:, 9:]
    log("vertices", f"observation: an f32 concatenate changes "
        f"{int(np.sum(plain != old))} of {old.size} id lanes")

    g_gpu = np.asarray(progs.run("hall vertex grad gpu"))
    g_cpu = np.asarray(progs.run("hall vertex grad cpu"))
    err = rel_l2(g_cpu, g_gpu)
    if not np.isfinite(g_gpu).all() or not np.any(g_gpu != 0) or err > 1e-4:
        raise AssertionError(f"hall vertex gradient GPU vs CPU: rel L2 {err:.3e}")
    log("vertices", f"concert hall vertex grad ({1 << 13} rays, grid, soft "
        f"histogram) GPU vs CPU: rel L2 {err:.3e}")


def phase_train() -> None:
    from examples import fit_absorption

    t0 = time.perf_counter()
    err = fit_absorption.main(
        ["--n-rays", "65536", "--n-bounces", "8", "--steps", "60"])
    if not err < 0.1:
        raise AssertionError(f"fit_absorption: mean |a - a*| = {err:.4f}")
    log("train", f"fit_absorption (65536 rays, 8 bounces, 60 steps, "
        f"{len(jax.devices())}-device mesh): mean |a - a*| {err:.4f} < 0.1; "
        f"{time.perf_counter() - t0:.1f} s with compile")


def phase_four() -> None:
    """Sharded histogram and train step, 4-card mesh vs 1-card mesh."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hare_tpu.dist import make_ray_mesh, make_train_step, sharded_histogram

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(jax.devices())}")
    hall = Topology.build(shapes.concert_hall())
    sp = SpatialPartition(hall, accel="grid")
    n, nb, nbins, steps = 4 * (1 << 16), 8, 1024, 5
    rays = source_rays(n)
    a0 = jnp.full(hall.n_polys, 0.5, jnp.float32)  # absorption logits
    opt = optax.adam(0.1)
    meshes = {k: make_ray_mesh(k) for k in (4, 1)}

    # One compile stage for both meshes' programs.  The train step is
    # lowered with a zero target of the histogram's shape and later run with
    # the histogram of a0, fitting absorption logits from 0 back to a0.
    progs = Programs()
    p0 = {"absorption": jnp.zeros(hall.n_polys, jnp.float32)}
    for k, mesh in meshes.items():
        rays_k = jax.device_put(rays, NamedSharding(mesh, P("rays")))
        devs = rays_k.origin.sharding.device_set
        if len(devs) != k:
            raise AssertionError(f"rays on {len(devs)} devices, wanted {k}")
        log("four", f"{k}-card mesh: rays sharded over devices "
            f"{sorted(x.id for x in devs)}")
        hist_fn = sharded_histogram(mesh, sp.shoot_fn, nb, nbins)

        def loss(a_raw, scene, rays_, aux, hist_fn=hist_fn):
            h = hist_fn(scene, rays_, jax.nn.sigmoid(a_raw), aux)
            return weighted_arrival(h), h

        progs.add(f"histogram+grad {k}",
                  jax.jit(jax.value_and_grad(loss, has_aux=True)),
                  (a0, sp.scene, rays_k, sp.aux))
        state = jax.device_put((p0, opt.init(p0)), NamedSharding(mesh, P()))
        step = make_train_step(mesh, sp.shoot_fn, opt, nb, nbins)
        progs.add(f"train {k}", jax.jit(step),
                  (*state, sp.scene, rays_k, jnp.zeros(nbins, jnp.float32),
                   sp.aux))
    progs.compile()

    out = {}
    for k in meshes:
        (_, target), grad = progs.run(f"histogram+grad {k}")
        params, opt_state, scene, rays_k, _, aux = progs.jobs[f"train {k}"][1]
        step = progs.compiled[f"train {k}"]
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt_state, l = step(params, opt_state, scene, rays_k,
                                        target, aux)
        jax.block_until_ready(params)
        dt = time.perf_counter() - t0
        out[k] = (np.asarray(target), np.asarray(grad),
                  np.asarray(params["absorption"]))
        log("four", f"{k}-card mesh: {steps} train steps at {n} rays x {nb} "
            f"bounces, {dt:.3f} s after compile (observation); loss "
            f"{float(l):.6e}")

    (h4, g4, p4), (h1, g1, p1) = out[4], out[1]
    h_err = float(np.max(np.abs(h4 - h1)) / np.max(np.abs(h1)))
    tot_err = abs(h4.sum() - h1.sum()) / h1.sum()
    g_err, p_err = rel_l2(g1, g4), rel_l2(p1, p4)
    if not (h_err <= 1e-5 and tot_err <= 1e-5):
        raise AssertionError(f"4-card histogram off: bin {h_err:.3e}, "
                             f"total {tot_err:.3e}")
    if not (g_err <= 1e-4 and p_err <= 1e-4):
        raise AssertionError(f"4-card gradient/params off: {g_err:.3e} / "
                             f"{p_err:.3e} rel L2")
    log("four", f"4 vs 1 card: histogram bin {h_err:.3e} of max, total "
        f"{tot_err:.3e}; gradient rel L2 {g_err:.3e}; params after {steps} "
        f"steps rel L2 {p_err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharding phase")
    args = ap.parse_args(argv)

    dev = phase_device()
    if args.four:
        phase_four()
    else:
        # Jobs go in slowest compile first (config 3, config 4, the rest).
        progs = Programs()
        top = bench.bench_topology()
        sps, builds = bench_partitions(top)
        hall = Topology.build(shapes.concert_hall())
        hall_grid = SpatialPartition(hall, accel="grid")
        prepare_trace(progs, top, sps["grid"], hall, hall_grid)
        verts = prepare_vertices(progs, hall, hall_grid)
        shoot = prepare_shoot(progs, top, sps, builds, hall, hall_grid)
        progs.compile()
        check_shoot(progs, shoot)
        check_trace(progs)
        check_vertices(progs, verts)
        phase_train()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
