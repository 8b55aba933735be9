"""CPU checks of what the on-card smoke test (``chip_smoke.py``) relies on:
its refusal to run without a GPU, its comparison functions at tiny sizes,
the compile-cache set-up and the timing helper."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from hare_tpu.accel import SpatialPartition  # noqa: E402
from hare_tpu.mesh import Topology, shapes  # noqa: E402
from hare_tpu.oracle import oracle_shoot  # noqa: E402
from hare_tpu.utils import require_gpu, setup_compile_cache, timed  # noqa: E402
from hare_tpu.utils.runtime import REPO_CACHE_DIR  # noqa: E402

N = 256


@pytest.fixture(scope="module")
def box():
    top = Topology.build(shapes.shoebox(4.0, 5.0, 3.0))
    rays = chip_smoke.interior_rays(N, (0.5, 0.5, 0.5), (3.5, 4.5, 2.5), seed=0)
    return top, rays


def test_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "[shoot]" not in p.stdout  # exits before building any scene
    assert "GPU backend is required" in p.stderr


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="GPU backend is required"):
        require_gpu()


def shoot(sp, rays):
    fn, args = chip_smoke.shoot_job(sp, rays)
    return chip_smoke.to_host(fn(*args))


@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_compare_hits_tiny(box, accel):
    top, rays = box
    ref = shoot(SpatialPartition(top, accel="brute"), rays)
    kw = {"domain": 4} if accel == "grid" else {}
    got = shoot(SpatialPartition(top, accel=accel, **kw), rays)
    assert ref.hit.all()
    assert chip_smoke.compare_hits(ref, got) == 0
    bad_tri = got.tri_id.copy()
    bad_tri[7] = (bad_tri[7] + 1) % top.n_tris
    with pytest.raises(AssertionError, match="tri_id"):
        chip_smoke.compare_hits(ref, got._replace(tri_id=bad_tri))
    bad_t = got.t.copy()
    bad_t[3] *= 1.001
    with pytest.raises(AssertionError, match="t differs"):
        chip_smoke.compare_hits(ref, got._replace(t=bad_t))


def test_compare_oracle_tiny(box):
    top, rays = box
    host = chip_smoke.to_host(rays)
    oracle = [oracle_shoot(top, host.origin[i], host.direction[i]) for i in range(32)]
    got = shoot(SpatialPartition(top, accel="grid", domain=4),
                chip_smoke.take(rays, 32))
    chip_smoke.compare_oracle(oracle, got)
    bad = got.poly_id.copy()
    bad[5] = (bad[5] + 1) % top.n_polys
    with pytest.raises(AssertionError, match="poly_id"):
        chip_smoke.compare_oracle(oracle, got._replace(poly_id=bad))


def test_compare_trace_tiny(box):
    top, rays = box
    sp = SpatialPartition(top, accel="grid", domain=4)
    a = jnp.full(top.n_polys, 0.3, jnp.float32)
    cpu = jax.devices("cpu")[0]
    runs = []
    for device in (None, cpu):
        fn, args = chip_smoke.trace_job(sp, rays, a, 3, 64, device=device)
        (_, h), g = fn(*args)
        runs.append((np.asarray(h), np.asarray(g)))
    (h_ref, g_ref), (h, g) = runs
    assert (g_ref < 0).all()  # every wall of the closed box is hit
    errs = chip_smoke.compare_trace(h_ref, h, g_ref, g)
    assert errs["grad_rel_l2"] <= 1e-4

    moved = h.copy()
    j = int(np.argmax(moved))
    moved[j] -= 0.01 * moved[j]
    moved[j + 1] += 0.01 * moved[j]
    with pytest.raises(AssertionError, match="bin"):
        chip_smoke.compare_trace(h_ref, moved, g_ref, g)
    with pytest.raises(AssertionError, match="total"):
        chip_smoke.compare_trace(h_ref, h * 1.001, g_ref, g)
    bad_g = g.copy()
    bad_g[0] *= 1.5
    with pytest.raises(AssertionError, match="gradient"):
        chip_smoke.compare_trace(h_ref, h, g_ref, bad_g)


@pytest.mark.parametrize("env_set", [True, False])
def test_setup_compile_cache(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert setup_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; nothing else is set.
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert setup_compile_cache() == REPO_CACHE_DIR
            assert REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_programs_compile_in_parallel(box):
    top, rays = box
    progs = chip_smoke.Programs()
    for accel in ("brute", "grid"):
        kw = {"domain": 4} if accel == "grid" else {}
        progs.add(accel, *chip_smoke.shoot_job(
            SpatialPartition(top, accel=accel, **kw), rays))
    progs.compile()
    ref, _, _ = progs.timed("brute")
    got, t_first, t_run = progs.timed("grid")
    assert t_first > 0 and t_run > 0
    assert chip_smoke.compare_hits(ref, got) == 0


def test_timed_positive():
    f = jax.jit(lambda x: jnp.cumsum(x * 2.0))
    dt, out = timed(f, jnp.ones(4096), iters=3)
    assert dt > 0
    assert float(out[-1]) == 8192.0
