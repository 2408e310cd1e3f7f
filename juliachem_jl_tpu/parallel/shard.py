"""Sharded density-fitted SCF step (SPMD over the device mesh).

This module is where the reference's entire MPI layer collapses into a few
shard_map'd einsums (SURVEY.md §7 step 7):

  reference                                  here
  ---------                                  ----
  aux partition over ranks/GPUs              B sharded on mesh axis "q"
  (DynamicLoad.jl:160-203)
  per-rank W/K/J partials                    per-shard einsums
  MPI.Allreduce!(fock)                       jax.lax.psum over "q"
  (DensityFitting.jl:68-71)
  exchange block loops (ScreenedDF.jl)       K columns sharded over "k"
  MPI.Bcast! of C each iteration             implicit replication

XLA hands the collectives to NCCL; nothing here depends on the number of
devices at trace time except the static shard shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map


def make_df_fock_step(mesh: Mesh, A_pad: int, nbf: int, nbf_pad: int, nocc: int):
    """Jitted sharded G = J - K/2.

    Layout: B stored as [A_pad, nbf, nbf_pad] sharded P("q", None, "k"):
    every device holds a (A_pad/q, nbf, nbf_pad/k) block — both the aux axis
    and the second AO axis are distributed, so B memory scales with the full
    mesh size.  D must arrive padded to [nbf, nbf_pad].
    """
    nk = mesh.shape["k"]
    ncol = nbf_pad // nk

    def local_fock(B_blk, D, Cocc):
        # B_blk: [A_l, nbf, ncol]; D (padded to [nbf, nbf_pad]) and Cocc
        # replicated.
        k = jax.lax.axis_index("k")
        col0 = (k * ncol).astype(jnp.int32)
        Dcols = jax.lax.dynamic_slice(D, (jnp.int32(0), col0), (nbf, ncol))
        # --- J ---
        V = jnp.einsum("qmn,mn->q", B_blk, Dcols)          # local cols
        V = jax.lax.psum(V, "k")                            # full V_Q per shard row
        Jcols = jnp.einsum("qmn,q->mn", B_blk, V)           # [nbf, ncol]
        # --- K/2 ---
        W = jnp.einsum("qmn,mi->qin", B_blk, Cocc)          # [A_l, nocc, ncol]
        Wg = jax.lax.all_gather(W, "k", axis=2, tiled=True)  # [A_l, nocc, nbf_pad]
        Kcols = jnp.einsum("qim,qin->mn", Wg[:, :, :nbf], W)  # [nbf, ncol]
        Gcols = jax.lax.psum(Jcols - Kcols, "q")            # [nbf, ncol]
        G = jax.lax.all_gather(Gcols, "k", axis=1, tiled=True)  # [nbf, nbf_pad]
        return G[:, :nbf]

    # check_vma=False: the replication checker cannot statically infer that
    # psum("q") + all_gather("k") yields a fully replicated output, but it
    # does (validated numerically vs the dense kernel in tests).
    fock = shard_map(
        local_fock,
        mesh=mesh,
        in_specs=(P("q", None, "k"), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fock)


def make_scf_step(mesh: Mesh, A_pad: int, nbf: int, nbf_pad: int, nocc: int):
    """Full jitted SCF iteration over the mesh: sharded Fock build + Roothaan
    eigensolve + energy (the 'training step' of this framework)."""
    fock = make_df_fock_step(mesh, A_pad, nbf, nbf_pad, nocc)

    def step(B, H, X, D, Cocc):
        D_pad = jnp.pad(D, ((0, 0), (0, nbf_pad - nbf)))
        G = fock(B, D_pad, Cocc)
        F = H + G
        Fp = X.T @ F @ X
        eps, Cp = jnp.linalg.eigh(Fp)
        C = X @ Cp
        Cocc_new = C[:, :nocc]
        D_new = 2.0 * (Cocc_new @ Cocc_new.T)
        E_elec = 0.5 * jnp.sum(D_new * (H + F))
        return F, D_new, Cocc_new, eps, E_elec

    return jax.jit(step)


def shard_B(mesh: Mesh, B):
    """Place a [A_pad, nbf, nbf_pad] B tensor with the production sharding."""
    return jax.device_put(B, NamedSharding(mesh, P("q", None, "k")))


def make_packed_fock_step(mesh: Mesh, A_pad: int, npq1: int, nbf: int,
                          q_chunk: int, n_chunks: int, dtype=jnp.float64):
    """Jitted sharded G = J - K/2 on *packed* screened-pq B
    (the multi-device analog of models/df_screened.py; replaces the
    reference's GPUDF.jl per-device W/J/K with one shard_map).

    B layout: [A_pad, npq+1] sharded P(("q","k"), None) — every device owns
    n_chunks x q_chunk complete Q rows.  Per device, a lax.scan over Q-blocks
    expands each block to a dense tile (one gather on col_map), accumulating
    the J/K partials; one psum over the whole mesh finishes the reduction
    (MPI.Allreduce! analog, DensityFitting.jl:68-71).

    Signature: fock(B, d_packed [npq+1], Cs [nbf,k], s [k], col_map, pq_flat)
    with D = 2 sum_k s_k c_k c_k^T (s = +1 for ordinary occupied orbitals;
    ±1 for indefinite fdiff densities).

    dtype=float32 gives the mixed-precision early-SCF phase (same f32/f64
    ladder as the single-device df_screened path): contractions run as full
    f32 products (never TF32) against a B32 shard; G returns as f64 either
    way.
    """
    hi = jax.lax.Precision.HIGHEST
    axes = ("q", "k")

    def local_fock(B_blk, d, Cs, s, col_map, pq_flat):
        Br = B_blk.reshape(n_chunks, q_chunk, npq1)
        Khalf0 = jnp.zeros((nbf, nbf), dtype=dtype)
        Jp0 = jnp.zeros(npq1, dtype=dtype)

        def body(carry, Bc):
            Khalf, Jp = carry
            Vc = jnp.matmul(Bc, d, precision=hi)
            Jp = Jp + jnp.matmul(Vc, Bc, precision=hi)
            tile = Bc[:, col_map].reshape(q_chunk, nbf, nbf)
            W = jnp.einsum("qmn,mi->qin", tile, Cs, precision=hi)
            Ws = W * s[None, :, None]
            Khalf = Khalf + jnp.einsum("qim,qin->mn", Ws, W, precision=hi)
            return (Khalf, Jp), 0

        (Khalf, Jp), _ = jax.lax.scan(body, (Khalf0, Jp0), Br)
        Khalf = jax.lax.psum(Khalf, axes)
        Jp = jax.lax.psum(Jp, axes).astype(jnp.float64)
        J = jnp.zeros(nbf * nbf).at[pq_flat].set(Jp[:-1]).reshape(nbf, nbf)
        return J - Khalf.astype(jnp.float64)

    fock = shard_map(
        local_fock,
        mesh=mesh,
        in_specs=(P(("q", "k"), None), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fock)


def make_packed_fock_phases(mesh: Mesh, A_pad: int, npq1: int, nbf: int,
                            q_chunk: int, n_chunks: int):
    """Split variant of make_packed_fock_step for per-phase telemetry
    (the reference records J/W/K times per iteration and per device,
    JCTiming.jl:15-105): returns (j_fn, k_fn) jitted shard_maps so the
    driver can wall-time the Coulomb and exchange phases separately.
    Slightly slower than the fused step (two passes over B) — used only
    when profiling is requested."""
    axes = ("q", "k")

    def local_j(B_blk, d, pq_flat):
        Br = B_blk.reshape(n_chunks, q_chunk, npq1)

        def body(Jp, Bc):
            Vc = Bc @ d
            return Jp + Vc @ Bc, 0

        Jp, _ = jax.lax.scan(body, jnp.zeros(npq1), Br)
        Jp = jax.lax.psum(Jp, axes)
        return jnp.zeros(nbf * nbf).at[pq_flat].set(Jp[:-1]).reshape(nbf, nbf)

    def local_k(B_blk, Cs, s, col_map):
        Br = B_blk.reshape(n_chunks, q_chunk, npq1)

        def body(Khalf, Bc):
            tile = Bc[:, col_map].reshape(q_chunk, nbf, nbf)
            W = jnp.einsum("qmn,mi->qin", tile, Cs)
            Ws = W * s[None, :, None]
            return Khalf + jnp.einsum("qim,qin->mn", Ws, W), 0

        Khalf, _ = jax.lax.scan(body, jnp.zeros((nbf, nbf)), Br)
        return jax.lax.psum(Khalf, axes)

    j_fn = shard_map(local_j, mesh=mesh,
                     in_specs=(P(("q", "k"), None), P(), P()),
                     out_specs=P(), check_vma=False)
    k_fn = shard_map(local_k, mesh=mesh,
                     in_specs=(P(("q", "k"), None), P(), P(), P()),
                     out_specs=P(), check_vma=False)
    return jax.jit(j_fn), jax.jit(k_fn)
