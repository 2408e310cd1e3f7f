"""Boys function F_m(T), vectorized, f64-accurate.

The Boys function is the radial core of every Coulomb-type Gaussian integral
(the role Libint's internal Boys tables play for the reference's JERI engines,
deps/src/jeri-tei.hpp).  Branch-free formulation suitable for XLA:

* T <= TCRIT: 128-term downward series for F_mmax
  (Helgaker/Jorgensen/Olsen eq. 9.8.12), then stable downward recursion.
* T  > TCRIT: asymptotic F_0 = sqrt(pi/4T) (erf(sqrt T) = 1 to machine eps
  for T > 35) and upward recursion, stable since exp(-T) is negligible.

Branches are combined with jnp.where on clamped arguments so neither branch
produces NaN/Inf that could poison gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TCRIT = 35.0
_NSERIES = 128


def boys_np(T: np.ndarray, mmax: int) -> np.ndarray:
    """Pure-numpy Boys function (same branch-free algorithm as `boys`).

    Setup-phase integrals (OEI/Schwarz/2-center/SAD) run on the host with
    numpy: compiling the class kernels would cost more than the numpy
    runtime of these small-compute phases.
    """
    T = np.asarray(T)
    Ts = np.minimum(T, TCRIT)
    Tl = np.maximum(T, TCRIT)
    expTs = np.exp(-Ts)

    term = np.full_like(Ts, 1.0 / (2.0 * mmax + 1.0))
    ssum = term.copy()
    for k in range(_NSERIES):
        term = term * (2.0 * Ts) / (2.0 * mmax + 2.0 * k + 3.0)
        ssum += term
    f_small = [None] * (mmax + 1)
    f_small[mmax] = expTs * ssum
    for m in range(mmax - 1, -1, -1):
        f_small[m] = (2.0 * Ts * f_small[m + 1] + expTs) / (2.0 * m + 1.0)

    f_large = [None] * (mmax + 1)
    f_large[0] = 0.5 * np.sqrt(np.pi / Tl)
    expTl = np.exp(-Tl)
    inv2T = 0.5 / Tl
    for m in range(1, mmax + 1):
        f_large[m] = ((2.0 * m - 1.0) * f_large[m - 1] - expTl) * inv2T

    small = T <= TCRIT
    out = [np.where(small, fs, fl) for fs, fl in zip(f_small, f_large)]
    return np.stack(out, axis=-1)


def boys(T, mmax: int):
    """Return F_m(T) for m = 0..mmax, stacked on a new trailing axis.

    T: any shape; output shape = T.shape + (mmax + 1,).  Dispatches to the
    numpy implementation when given a numpy array outside a trace (host
    setup path); inside jit it is always traced with jax arrays.
    """
    if isinstance(T, np.ndarray):
        return boys_np(T, mmax)
    T = jnp.asarray(T)
    Ts = jnp.minimum(T, TCRIT)          # series-branch argument (clamped)
    Tl = jnp.maximum(T, TCRIT)          # large-branch argument (clamped)
    expTs = jnp.exp(-Ts)

    # --- series branch: F_mmax(Ts) ---------------------------------------
    def body(k, carry):
        s, term = carry
        term = term * (2.0 * Ts) / (2.0 * mmax + 2.0 * k + 3.0)
        return s + term, term

    term0 = jnp.full_like(Ts, 1.0 / (2.0 * mmax + 1.0))
    ssum, _ = jax.lax.fori_loop(0, _NSERIES, body, (term0, term0))
    f_small = [None] * (mmax + 1)
    f_small[mmax] = expTs * ssum
    for m in range(mmax - 1, -1, -1):   # downward: stable
        f_small[m] = (2.0 * Ts * f_small[m + 1] + expTs) / (2.0 * m + 1.0)

    # --- asymptotic branch -------------------------------------------------
    f_large = [None] * (mmax + 1)
    f_large[0] = 0.5 * jnp.sqrt(jnp.pi / Tl)
    expTl = jnp.exp(-Tl)
    inv2T = 0.5 / Tl
    for m in range(1, mmax + 1):        # upward: stable for T > TCRIT > mmax
        f_large[m] = ((2.0 * m - 1.0) * f_large[m - 1] - expTl) * inv2T

    small = T <= TCRIT
    out = [jnp.where(small, fs, fl) for fs, fl in zip(f_small, f_large)]
    return jnp.stack(out, axis=-1)
