"""Device memory size and the one table of every memory budget.

Budgets for resident tensors, exchange tiles, integral batches and fold
tiles are named shares of what the first device can hold, counted in native
f64 bytes (8 per element).
"""

from __future__ import annotations

import os

import jax

F64_BYTES = 8

# Share of device memory each buffer may take.  The ratios were first set
# for a 16 GB card and carried over unchanged; none has been tuned on an
# 80 GB H100 (PERF.md lists the peak bytes each smoke phase reached).
SHARES = {
    # dense DF: B [A, nbf, nbf], its f32 copy and the [A, nocc, nbf]
    # exchange intermediate, all resident at once; a larger B takes the
    # packed screened builder (models/rhf.py, models/uhf.py)
    "dense_df_b": 1 / 8,
    # screened DF: packed B in f64 (plus its f32 copy in the f32 phase);
    # a larger B is streamed from host RAM (models/df_screened.py)
    "screened_df_b": 3 / 8,
    # one expanded [q_chunk, nbf, nbf] exchange tile; the rest is left to
    # the W intermediates and XLA's workspaces (models/df_screened.py,
    # parallel/build.py)
    "df_exchange_tile": 3 / 32,
    # sharded DF: each device's B rows in f64 plus their f32 copy, above
    # which the f32 phase is dropped (models/df_sharded.py)
    "sharded_df_b": 9 / 16,
    # cached ERI blocks of the in-core conventional builder (ops/fock.py)
    "incore_eri": 1 / 5,
    # one 3-center launch's largest intermediate, with room for the few
    # other temporaries of its size XLA keeps live (ops/eri3c.py)
    "eri3c_work": 1 / 32,
    # one 3-center launch's output block, the device-to-host copy unit
    # (ops/eri3c.py)
    "eri3c_out": 1 / 256,
    # one metric-fold matmul's operands and output tile (models/linalg.py)
    "fold_tile": 1 / 8,
}


def device_memory_bytes() -> int:
    """Bytes the first device's allocator may hand out.

    An accelerator reports its limit through ``memory_stats()``; one that
    reports none is an error, never a guess.  On the CPU backend device
    memory is host RAM."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {dev.device_kind!r} ({dev.platform}) reports no memory "
            "limit; cannot size device buffers")
    return int(stats["bytes_limit"])


def share_bytes(name: str) -> float:
    """Bytes of the device memory share ``name`` (a key of SHARES)."""
    return SHARES[name] * device_memory_bytes()


def budget_elements(name: str) -> int:
    """f64 elements that fit in the device memory share ``name``."""
    return int(share_bytes(name) / F64_BYTES)
