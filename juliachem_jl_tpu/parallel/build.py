"""Sharded (multi-device) packed-B construction.

The reference distributes the 3-center + B work and memory across
ranks x GPUs with a static auxiliary partition (GPUDF.jl:828-1008,
DynamicLoad.jl:160-203).  Here each mesh device owns a contiguous block of
auxiliary *shells* (hence a contiguous block of B's Q rows); the per-block
3-center tensors are built independently; the blocks are built one after
another on the host process and the assembled B is device_put with the
production sharding, which gives each device a footprint of A/ndev rows.
"""

from __future__ import annotations

import copy

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..basis.structs import Basis, compile_basis
from ..utils import memory
from ..utils.timings import JCTC, Timings


def subset_basis(basis: Basis, shell_range: range) -> Basis:
    """A standalone Basis over a contiguous shell subset (local offsets)."""
    shells = [copy.copy(basis.shells[i]) for i in shell_range]
    return compile_basis(shells, nels=0, name=f"{basis.name}[{shell_range.start}:{shell_range.stop}]")


def partition_aux_shells(aux: Basis, ndev: int) -> list[tuple[int, int]]:
    """Contiguous aux-shell ranges with ~balanced function counts
    (static_load_rank_indicies analog, DynamicLoad.jl:160-203)."""
    nbf_cum = np.cumsum(aux.shell_nbf)
    bounds = [0]
    for g in range(1, ndev):
        target = g * aux.nbf / ndev
        i = int(np.searchsorted(nbf_cum, target))
        bounds.append(max(i, bounds[-1]))
    bounds.append(aux.nshell)
    return [(bounds[i], bounds[i + 1]) for i in range(ndev)]


def build_B_packed_sharded(primary: Basis, aux: Basis, mesh: Mesh,
                           opts=None, timings: Timings | None = None):
    """Build packed B with per-shard Q-row blocks and place it sharded.

    Returns (B_sharded [A_pad, npq+1] on P(("q","k"), None), screen,
    A_pad, q_chunk, n_chunks)."""
    from ..models.df import screened_pair_blocks
    from ..models.df_screened import build_packed_screen
    from ..ops import eri3c

    timings = timings or Timings()
    ndev = mesh.devices.size
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux)
    sigma = getattr(opts, "df_screening_sigma", 1e-5) if opts is not None else 1e-5
    with timings.timed(JCTC.screening_time):
        pair_blocks = screened_pair_blocks(
            primary, sigma, float(np.diag(metric).max()))
        screen = build_packed_screen(primary, pair_blocks)
    npq1 = screen.npq + 1

    # per-shard 3-center row blocks, built one after another
    with timings.timed(JCTC.three_center_time):
        parts = []
        for s0, s1 in partition_aux_shells(aux, ndev):
            if s0 == s1:
                parts.append(np.zeros((0, npq1)))
                continue
            sub = subset_basis(aux, range(s0, s1))
            parts.append(eri3c.three_center_tensor(
                primary, sub, pair_blocks, col_map=screen.col_map,
                packed_width=npq1, timings=timings))
        P3 = np.concatenate(parts, axis=0)  # rows in global aux order

    with timings.timed(JCTC.B_time):
        from ..basis.spherical import (aux_needs_sph, project_metric_sph,
                                       project_rows_sph)
        from ..models.linalg import fold_metric

        B = P3
        if (getattr(opts, "df_spherical_aux", True) if opts is not None
                else True) and aux_needs_sph(aux):
            metric = project_metric_sph(aux, metric)
            B = project_rows_sph(aux, B)
        fold_metric(metric, B)
        B[:, -1] = 0.0

    # pad rows so each device holds n_chunks x q_chunk rows exactly
    A = B.shape[0]
    nbf = primary.nbf
    A_l0 = -(-A // ndev)
    tile = memory.budget_elements("df_exchange_tile")
    qc = max(16, min(A_l0, tile // (nbf * nbf)))
    n_chunks = -(-A_l0 // qc)
    A_pad = ndev * n_chunks * qc
    if A_pad != A:
        B = np.concatenate([B, np.zeros((A_pad - A, npq1))], axis=0)

    import jax

    B_sh = jax.device_put(B, NamedSharding(mesh, P(("q", "k"), None)))
    return B_sh, screen, A_pad, qc, n_chunks
