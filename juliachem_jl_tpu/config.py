"""Global numerical configuration.

Chemistry needs ~1e-8 Eh absolute energy accuracy (SURVEY.md §4: S22 energies
must match GAMESS to Julia-`isapprox` rtol ≈1.5e-8), so double precision is
enabled globally.  Every device product therefore runs in native f64.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the class-batched integral kernels compile
# one executable per angular-momentum class, and caching them across
# processes removes most of the cold-start cost (analog of the reference's
# custom sysimage work, tools/sysimg/).  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; only when it is unset does the cache go to one fixed directory in
# the checkout (the path is part of the cache key, so it must not move).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# Default floating dtype used throughout the integral and SCF code.
import numpy as _np

DTYPE = _np.float64

# Allow opting out (e.g. for fp32 experiments) via environment variable.
if os.environ.get("JCHEM_X64", "1") == "0":  # pragma: no cover
    jax.config.update("jax_enable_x64", False)
    DTYPE = _np.float32
