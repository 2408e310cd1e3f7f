"""McMurchie-Davidson recurrences, batched for class-shaped inputs.

This is the mathematical engine replacing Libint's Obara-Saika recursion in
the reference's JERI layer (deps/src/jeri-{oei,tei,df-tei}.hpp).  All
recurrences run at trace time over *static* angular momenta, producing pure
tensor programs over batched primitive data — no data-dependent control flow,
so XLA can fuse and tile everything.

Conventions (Helgaker/Jorgensen/Olsen ch. 9):
  E_t^{ij}  — Hermite expansion coefficients of a 1D Gaussian product,
              including the exp(-mu AB^2) prefactor.
  R^0_{tuv} — Hermite Coulomb integrals built from Boys F_n by downward
              recursion.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .boys import boys
from .class_tables import herm_list, pair_tables


def _xp(x):
    """Array namespace for x: numpy for host (setup-phase) calls, jnp under
    trace.  The recurrences are pure array programs, so the same code serves
    both; the host path serves small setup-phase batches, where compiling a
    class kernel would cost more than evaluating it with numpy."""
    return np if isinstance(x, np.ndarray) else jnp


def pair_primitive_data(aexp, bexp, acoef, bcoef, A, B):
    """Flatten a batch of contracted shell pairs into primitive-pair arrays.

    aexp: [N, Ka], bexp: [N, Kb], coefficients likewise, A/B: [N, 3].
    Returns dict with all [N, K2] / [N, K2, 3] primitive-pair quantities
    (K2 = Ka*Kb).  Padded primitives carry coefficient 0 (exponent 1) so they
    contribute exactly zero.
    """
    xp = _xp(aexp)
    N, Ka = aexp.shape
    Kb = bexp.shape[1]
    a = xp.repeat(aexp, Kb, axis=1)                   # [N, K2]
    b = xp.tile(bexp, (1, Ka))
    cc = (acoef[:, :, None] * bcoef[:, None, :]).reshape(N, Ka * Kb)
    p = a + b
    mu = a * b / p
    P = (a[:, :, None] * A[:, None, :] + b[:, :, None] * B[:, None, :]) / p[:, :, None]
    AB = A - B                                        # [N, 3]
    return {
        "a": a, "b": b, "p": p, "mu": mu, "cc": cc,
        "P": P, "PA": P - A[:, None, :], "PB": P - B[:, None, :],
        "AB": AB,
    }


def e_dense(la: int, lb: int, prim) -> jnp.ndarray:
    """Dense per-dimension E-coefficient table.

    Returns E[N, K2, 3, la+1, lb+1, la+lb+1] with zeros where t > i+j.
    """
    p, mu = prim["p"], prim["mu"]
    PA, PB = prim["PA"], prim["PB"]                   # [N, K2, 3]
    AB = prim["AB"]                                   # [N, 3]
    xp = _xp(p)
    oo2p = (0.5 / p)[:, :, None]                      # [N, K2, 1]
    zero = xp.zeros_like(PA)

    e = {(0, 0, 0): xp.exp(-mu[:, :, None] * AB[:, None, :] ** 2)}

    def get(i, j, t):
        if t < 0 or t > i + j:
            return zero
        return e[(i, j, t)]

    for i in range(1, la + 1):
        for t in range(i + 1):
            e[(i, 0, t)] = (
                oo2p * get(i - 1, 0, t - 1)
                + PA * get(i - 1, 0, t)
                + (t + 1) * get(i - 1, 0, t + 1)
            )
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                e[(i, j, t)] = (
                    oo2p * get(i, j - 1, t - 1)
                    + PB * get(i, j - 1, t)
                    + (t + 1) * get(i, j - 1, t + 1)
                )

    L = la + lb
    rows = []
    for i in range(la + 1):
        cols = []
        for j in range(lb + 1):
            cols.append(xp.stack([get(i, j, t) for t in range(L + 1)], axis=-1))
        rows.append(xp.stack(cols, axis=-2))
    return xp.stack(rows, axis=-3)                    # [N,K2,3,la+1,lb+1,L+1]


def hermite_expansion(la: int, lb: int, prim, fold_coefs: bool = True) -> jnp.ndarray:
    """Bra/ket Hermite expansion matrix Eab[N, K2, nca*ncb, nherm(la+lb)].

    Axial normalization factors and (optionally) the primitive-pair
    contraction coefficients are folded in, so downstream contraction is a
    pure matmul over the Hermite axis.
    """
    tab = pair_tables(la, lb)
    E = e_dense(la, lb, prim)
    Ex, Ey, Ez = E[:, :, 0], E[:, :, 1], E[:, :, 2]

    ixa = tab["ix_a"][:, :, None]
    ixb = tab["ix_b"][:, :, None]
    iya = tab["iy_a"][:, :, None]
    iyb = tab["iy_b"][:, :, None]
    iza = tab["iz_a"][:, :, None]
    izb = tab["iz_b"][:, :, None]
    t = tab["t"][None, None, :]
    u = tab["u"][None, None, :]
    v = tab["v"][None, None, :]

    Eab = (
        Ex[:, :, ixa, ixb, t] * Ey[:, :, iya, iyb, u] * Ez[:, :, iza, izb, v]
    )                                                  # [N,K2,nca,ncb,nh]
    N, K2 = Eab.shape[:2]
    Eab = Eab.reshape(N, K2, tab["nca"] * tab["ncb"], tab["nh"])
    Eab = Eab * _xp(Eab).asarray(tab["axial"])[None, None, :, None]
    if fold_coefs:
        Eab = Eab * prim["cc"][:, :, None, None]
    return Eab


def r_tensor(L: int, alpha, X, F) -> jnp.ndarray:
    """Hermite Coulomb integrals R^0_{tuv} stacked in herm_list(L) order.

    alpha: [...], X: [..., 3] (the P-Q separation), F: [..., L+1] Boys values
    (any linear prefactor may be pre-multiplied into F).
    Returns [..., nherm(L)].
    """
    xp = _xp(alpha)
    Xd = [X[..., 0], X[..., 1], X[..., 2]]
    m2a = -2.0 * alpha
    pows = [xp.ones_like(alpha)]
    for n in range(1, L + 1):
        pows.append(pows[-1] * m2a)

    memo = {}

    def R(n, t, u, v):
        if t < 0 or u < 0 or v < 0:
            return None
        key = (n, t, u, v)
        if key in memo:
            return memo[key]
        if t == u == v == 0:
            val = pows[n] * F[..., n]
        elif t > 0:
            lo = R(n + 1, t - 2, u, v)
            hi = R(n + 1, t - 1, u, v)
            val = Xd[0] * hi if lo is None else (t - 1) * lo + Xd[0] * hi
        elif u > 0:
            lo = R(n + 1, t, u - 2, v)
            hi = R(n + 1, t, u - 1, v)
            val = Xd[1] * hi if lo is None else (u - 1) * lo + Xd[1] * hi
        else:
            lo = R(n + 1, t, u, v - 2)
            hi = R(n + 1, t, u, v - 1)
            val = Xd[2] * hi if lo is None else (v - 1) * lo + Xd[2] * hi
        memo[key] = val
        return val

    return xp.stack([R(0, t, u, v) for (t, u, v) in herm_list(L)], axis=-1)


__all__ = ["pair_primitive_data", "e_dense", "hermite_expansion", "r_tensor", "boys"]
