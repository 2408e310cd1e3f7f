"""Cauchy-Schwarz screening bounds.

Q_ab = sqrt(max |(ab|ab)|) per shell pair; |(ab|cd)| <= Q_ab Q_cd.
Replaces EnergyHelpers.compute_schwarz_bounds (EnergyHelpers.jl:172-204) and
feeds the DF screening criterion of SchwarzScreening.jl.  Here the bounds
become *static masks* used to prune padded quartet batches at setup time and
to drop pq columns from the DF B tensor — never data-dependent control flow.
"""

from __future__ import annotations

import numpy as np

from ..basis.structs import Basis
from .eri import eri_block
from .pairs import PairBlock, unique_pair_blocks


def pair_schwarz(block: PairBlock) -> np.ndarray:
    """Q values for each pair in a PairBlock: sqrt(max |(ab|ab)|)."""
    idx = np.arange(block.n)
    vals = eri_block(block, block, idx, idx)        # [N, nab, nab] diagonal quartets
    n = block.n
    return np.sqrt(np.abs(vals).reshape(n, -1).max(axis=1))


def shell_pair_bounds(basis: Basis) -> np.ndarray:
    """Symmetric (nshell, nshell) matrix of Schwarz Q values."""
    nsh = basis.nshell
    Q = np.zeros((nsh, nsh))
    for blk in unique_pair_blocks(basis):
        q = pair_schwarz(blk)
        Q[blk.ish, blk.jsh] = q
        Q[blk.jsh, blk.ish] = q
    return Q
