"""Multi-device DF Fock builder: the production sharded path.

Wires num_devices (SCF keyword, Constants.jl GPUAlgorithms.num_devices analog)
into rhf.energy: B is built with per-shard Q-row blocks
(parallel/build.py, GPUDF.jl:828-1008 analog) and every per-iteration Fock
runs as one shard_map over the mesh with psum-reduced J/K partials
(parallel/shard.py::make_packed_fock_step, the MPI.Allreduce! analog).

Each device holds A_pad/ndev rows of packed B — the memory axis that lets
the aux dimension scale with the mesh (the reference's whole reason for
GPUDF's device partition).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils import memory
from ..utils.timings import JCTC, Timings
from .scf import FockBuilder


class ShardedDFFockBuilder(FockBuilder):
    """Packed screened-pq DF Fock over a jax.sharding.Mesh."""

    def __init__(self, primary, auxiliary, opts=None,
                 timings: Timings | None = None):
        import jax

        from ..parallel import mesh as mesh_mod
        from ..parallel.build import build_B_packed_sharded
        from ..parallel.shard import make_packed_fock_step

        timings = timings or Timings()
        n = int(getattr(opts, "num_devices", 1) or 1)
        if n > len(jax.devices()):
            raise ValueError(
                f"num_devices={n} requested but only {len(jax.devices())} "
                f"devices visible (set XLA_FLAGS="
                f"--xla_force_host_platform_device_count for CPU testing)"
            )
        self.mesh = mesh_mod.make_mesh(n)
        self.nbf = primary.nbf
        B_sh, screen, A_pad, qc, n_chunks = build_B_packed_sharded(
            primary, auxiliary, self.mesh, opts, timings)
        self.B = B_sh
        self.screen = screen
        self._q_chunk, self._n_chunks = qc, n_chunks  # for JK subclass
        self._fock = make_packed_fock_step(
            self.mesh, A_pad, screen.npq + 1, self.nbf, qc, n_chunks)
        # mixed-precision phase: a B32 shard alongside B64 when the combined
        # per-device footprint fits (same f32/f64 ladder as df_screened)
        mixed = bool(getattr(opts, "mixed_precision", False))
        per_dev_bytes = (A_pad // n) * (screen.npq + 1) * 12
        self.B32 = None
        if mixed and per_dev_bytes <= memory.share_bytes("sharded_df_b"):
            self.B32 = self.B.astype(jnp.float32)  # sharding-preserving cast
            self._fock32 = make_packed_fock_step(
                self.mesh, A_pad, screen.npq + 1, self.nbf, qc, n_chunks,
                dtype=jnp.float32)
        self.supports_f32_phase = self.B32 is not None
        self.profile = bool(getattr(opts, "profile_fock", False))
        if self.profile:
            from ..parallel.shard import make_packed_fock_phases

            self._j_fn, self._k_fn = make_packed_fock_phases(
                self.mesh, A_pad, screen.npq + 1, self.nbf, qc, n_chunks)
        self._col_map = jnp.asarray(screen.col_map)
        self._pq_flat = jnp.asarray(screen.pq_flat)
        timings.non_timing_data[JCTC.gpu_num_devices] = str(n)
        # per-device telemetry (JCTiming GPU-key analog): each mesh device
        # owns A_pad/n rows of packed B
        rows = A_pad // n
        for dev in range(n):
            timings.non_timing_data[f"device_B_rows-DEVICE-{dev}"] = str(rows)
            timings.non_timing_data[f"device_B_bytes-DEVICE-{dev}"] = str(
                rows * (screen.npq + 1) * 8)

    def _signed_factor(self, D):
        w, U = np.linalg.eigh(np.asarray(D))
        keep = np.abs(w) > 1e-12
        wk, Uk = w[keep], U[:, keep]
        Cs = Uk * np.sqrt(0.5 * np.abs(wk))[None, :]
        s = np.sign(wk)
        k = Cs.shape[1]
        kp = -(-max(k, 1) // 32) * 32
        if kp != k:
            Cs = np.pad(Cs, ((0, 0), (0, kp - k)))
            s = np.pad(s, (0, kp - k))
        return jnp.asarray(Cs), jnp.asarray(s)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        if C_occ is None:
            Cs, s = self._signed_factor(D)
        else:
            Cs = jnp.asarray(C_occ)
            s = jnp.ones(Cs.shape[1])
        d = jnp.concatenate([
            jnp.asarray(D).reshape(-1)[self._pq_flat], jnp.zeros(1)])
        if precision == "f32" and self.supports_f32_phase:
            with timings.timed(JCTC.fock_time + "_device", iteration):
                G = self._fock32(
                    self.B32, d.astype(jnp.float32),
                    Cs.astype(jnp.float32), s.astype(jnp.float32),
                    self._col_map, self._pq_flat)
            return np.asarray(G)
        if self.profile:
            # per-phase telemetry (reference JCTiming J/K per-iteration keys)
            with timings.timed(JCTC.J_time, iteration):
                J = self._j_fn(self.B, d, self._pq_flat)
                J.block_until_ready()
            with timings.timed(JCTC.K_time, iteration):
                Khalf = self._k_fn(self.B, Cs, s, self._col_map)
                Khalf.block_until_ready()
            return np.asarray(J - Khalf)
        with timings.timed(JCTC.fock_time + "_device", iteration):
            G = self._fock(self.B, d, Cs, s, self._col_map, self._pq_flat)
        return np.asarray(G)

    def finalize(self):
        self.B = None
        self.B32 = None
