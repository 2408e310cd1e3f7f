"""Two-process jax.distributed bring-up smoke (CPU backend).

Exercises the multi-host code path that single-process tests cannot reach:
initialize_distributed() + make_global_mesh() with jax.process_count() == 2
(parallel/mesh.py:87-124), then one psum over the global mesh.  This is the
CPU stand-in for the reference's multi-node MPI bring-up
(src/core/JCRuntime.jl:6-16), run on one machine.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import jax
from juliachem_jl_tpu.parallel import mesh as mesh_mod

active = mesh_mod.initialize_distributed()
assert active, "initialize_distributed() did not report a multi-process runtime"
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()

m = mesh_mod.make_global_mesh()
assert m.devices.size == 4

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

x = jax.device_put(
    jnp.ones((8, 4)),
    NamedSharding(m, P("q", None)))


@jax.jit
def total(v):
    return jnp.sum(v)


assert float(total(x)) == 32.0
print("MULTIPROC_OK", jax.process_index(), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_bringup():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{err[-1500:]}"
        assert "MULTIPROC_OK" in out
