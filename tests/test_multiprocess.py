"""Two-process ``jax.distributed`` loopback smoke test (SURVEY.md §4 item 5).

Spawns two real OS processes that initialize a distributed JAX runtime over
localhost, build a global 4-device mesh (2 local CPU devices each), run the
sharded histogram fwd+bwd, and write their psum'd gradients; the parent
asserts both processes produced identical grads that match a single-process
reference.  This is the multi-host recipe (``jax.distributed.initialize`` +
the same shard_map code) minus the actual second host.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(
    coordinator_address=coord, num_processes=2, process_id=pid,
    local_device_ids=[0, 1],
)
import numpy as np
import jax.numpy as jnp
from hare_tpu.geom import Ray
from hare_tpu.accel import SpatialPartition
from hare_tpu.dist import make_ray_mesh, sharded_histogram
from hare_tpu.mesh import Topology, shapes
from hare_tpu.trace import uniform_sphere

assert jax.process_count() == 2
assert len(jax.devices()) == 4  # global devices across both processes

top = Topology.build(shapes.shoebox(4, 5, 3))
sp = SpatialPartition(top, accel="grid", domain=4)
mesh = make_ray_mesh(4)

n = 64
d = uniform_sphere(jax.random.PRNGKey(0), n)
o = jnp.tile(jnp.array([2.0, 2.5, 1.5], jnp.float32), (n, 1))
# Globally-sharded ray batch: each process materializes its addressable
# shards of the same global array.
from jax.sharding import NamedSharding, PartitionSpec as P
sh = NamedSharding(mesh, P("rays"))
def shard(x):
    return jax.make_array_from_callback(x.shape, sh, lambda idx: np.asarray(x)[idx])
rays = Ray(shard(o), shard(d),
           shard(jnp.full((n, 2), -1, jnp.int32)))

fn = sharded_histogram(mesh, sp.shoot_fn, n_bounces=3, n_bins=64)
a = jnp.full(top.n_polys, 0.3, jnp.float32)

def loss(a_):
    return jnp.sum(fn(sp.scene, rays, a_, sp.aux) ** 2)

g = jax.grad(loss)(a)
# fully-replicated output: every process sees the same values
out = np.asarray(jax.device_get(g))
print("GRADS " + json.dumps(out.tolist()))
"""


# No pytest-timeout in this environment; the communicate(timeout=240) below
# is the hang guard — a wedged coordinator fails the test, not the suite.
def test_two_process_loopback(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    # The workers pin their own platform and device count (WORKER above).
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, coord, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)

    grads = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("GRADS ")]
        assert line, out
        grads.append(np.asarray(json.loads(line[0][len("GRADS "):])))
    # Both processes hold identical replicated gradients.
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-7)

    # And they match the single-process value computed here (same math on
    # this process's own 8-device config — values are device-count
    # independent for the pure-specular path).
    import jax
    import jax.numpy as jnp
    from hare_tpu.geom import Ray
    from hare_tpu.accel import SpatialPartition
    from hare_tpu.mesh import Topology, shapes
    from hare_tpu.trace import energy_histogram, trace_rays, uniform_sphere

    top = Topology.build(shapes.shoebox(4, 5, 3))
    sp = SpatialPartition(top, accel="grid", domain=4)
    n = 64
    d = uniform_sphere(jax.random.PRNGKey(0), n)
    o = jnp.tile(jnp.array([2.0, 2.5, 1.5], jnp.float32), (n, 1))
    rays = Ray.make(o, d)
    a = jnp.full(top.n_polys, 0.3, jnp.float32)

    def loss(a_):
        res = trace_rays(sp.scene, rays, a_, 3, sp.shoot_fn, aux=sp.aux)
        return jnp.sum(energy_histogram(res, 64, 1e-3) ** 2)

    g_ref = np.asarray(jax.grad(loss)(a))
    np.testing.assert_allclose(grads[0], g_ref, rtol=1e-4, atol=1e-6)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
