"""Two-process jax.distributed smoke test (CPU backend).

Validates the multi-host bring-up path end-to-end on one machine — the
analog of running the reference under ``mpiexecjl -n 2`` (JCRuntime.jl:6-16
MPI.Init + the rank grid of GPUDF.jl:1011-1055):

  * ``initialize_distributed()`` (parallel/mesh.py) through its explicit
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID path,
  * ``make_global_mesh()`` building the host-major ("q" spans hosts,
    "k" within a host) layout on a backend without slice topology,
  * one cross-process collective (psum over both mesh axes) producing the
    same value on every process.

The parent (``run_smoke``) spawns N fresh interpreters pinned to the CPU
platform with ``xla_force_host_platform_device_count`` local devices each,
then parses one RESULT line per child.  Child entry is ``python -m
juliachem_jl_tpu.parallel.dist_smoke``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child() -> None:
    import numpy as np

    from juliachem_jl_tpu.parallel import mesh as mesh_mod
    from juliachem_jl_tpu.parallel.shard import P, shard_map

    active = mesh_mod.initialize_distributed()
    import jax
    import jax.numpy as jnp

    assert active, "initialize_distributed() did not activate multi-process"
    mesh = mesh_mod.make_global_mesh()
    nq, nk = mesh.shape["q"], mesh.shape["k"]

    x = np.arange(nq * 3 * nk * 5, dtype=np.float64).reshape(nq * 3, nk * 5)
    want = float(x.sum())
    xs = jax.device_put(
        jnp.asarray(x), jax.NamedSharding(mesh, P("q", "k")))
    total = jax.jit(shard_map(
        lambda t: jax.lax.psum(t.sum(), ("q", "k")),
        mesh=mesh, in_specs=P("q", "k"), out_specs=P()))(xs)
    print("RESULT:" + json.dumps({
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "mesh": [nq, nk],
        "psum": float(total),
        "want": want,
    }), flush=True)


def run_smoke(n_procs: int = 2, n_local: int = 2,
              timeout: float = 300.0) -> dict:
    """Spawn ``n_procs`` CPU processes with ``n_local`` devices each, run the
    distributed child, and assert every process agrees.  Returns the parsed
    per-process results (keyed by process id)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_base.update({
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": repo,
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_local}",
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(n_procs),
    })
    procs = []
    for pid in range(n_procs):
        env = dict(env_base, JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "juliachem_jl_tpu.parallel.dist_smoke"],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = {}
    errs = []
    for pid, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise RuntimeError(
                f"distributed smoke: process {pid} timed out after "
                f"{timeout}s (coordinator port {port})")
        for line in out.splitlines():
            if line.startswith("RESULT:"):
                results[pid] = json.loads(line[len("RESULT:"):])
        if pid not in results:
            errs.append(f"proc {pid} (rc={proc.returncode}): {err[-1500:]}")
    if errs:
        raise RuntimeError("distributed smoke failed:\n" + "\n".join(errs))

    want_dev = n_procs * n_local
    for pid, r in results.items():
        assert r["process_count"] == n_procs, r
        assert r["global_devices"] == want_dev, r
        assert r["mesh"][0] * r["mesh"][1] == want_dev, r
        assert abs(r["psum"] - r["want"]) < 1e-9, r
    psums = {r["psum"] for r in results.values()}
    assert len(psums) == 1, f"processes disagree: {psums}"
    return results


if __name__ == "__main__":
    _child()
