"""Electron-repulsion integrals, class-batched McMurchie-Davidson.

Replacement for the reference's RHFTEIEngine.compute_eri_block
(deps/src/jeri-tei.hpp:62-84, one libint call per shell quartet): every
(la,lb,lc,ld) class is one jitted tensor program over a batch of quartets,
structured as two batched matmuls over the Hermite axis —

    (ab|cd)[n] = Eab[n] . M[n] . Ecd[n]^T,
    M[n][h,h'] = (-1)^{|h'|} R_{h+h'}(alpha, P-Q)

— which is exactly the matmul-shaped factorization of the MD contraction.
The same kernel family serves 4-center, 3-center (unit ket shell) and
2-center (two unit shells) integrals, replacing jeri-df-tei.hpp as well.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.structs import Basis, ncart
from .boys import boys
from .class_tables import combine_tables, pair_tables
from .mcmurchie import hermite_expansion, pair_primitive_data, r_tensor
from .pairs import PairBlock

TWO_PI_POW_2_5 = 2.0 * np.pi**2.5


def bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B):
    """Hermite expansion of a pair batch: returns (Eab[N,K2,nab,nh], p[N,K2],
    P[N,K2,3]) with contraction coefficients and axial factors folded in."""
    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    Eab = hermite_expansion(la, lb, prim)
    return Eab, prim["p"], prim["P"]


@lru_cache(maxsize=None)
def _eri_kernel_body(la, lb, lc, ld, Ka, Kb, Kc, Kd):
    """Unjitted quartet-class kernel body -> blocks [N, nca*ncb, ncc*ncd].

    Exposed separately so the quartet-sharded Fock build can trace it inside
    shard_map (fock_sharded.py); _eri_kernel is its jitted form."""
    Lb = la + lb
    Lk = lc + ld
    L = Lb + Lk
    comb, sign = combine_tables(Lb, Lk)
    nab = ncart(la) * ncart(lb)
    ncd = ncart(lc) * ncart(ld)

    def f(aexp, bexp, acoef, bcoef, A, B, cexp, dexp, ccoef, dcoef, C, D):
        xp = np if isinstance(aexp, np.ndarray) else jnp
        Eab, p, P = bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B)
        Ecd, q, Q = bra_hermite(lc, ld, cexp, dexp, ccoef, dcoef, C, D)

        PQ = P[:, :, None, :] - Q[:, None, :, :]          # [N,K2b,K2k,3]
        psum = p[:, :, None] + q[:, None, :]
        alpha = p[:, :, None] * q[:, None, :] / psum
        Targ = alpha * xp.sum(PQ**2, axis=-1)
        pref = TWO_PI_POW_2_5 / (p[:, :, None] * q[:, None, :] * xp.sqrt(psum))
        F = boys(Targ, L) * pref[..., None]
        R = r_tensor(L, alpha, PQ, F)                     # [N,K2b,K2k,nherm(L)]

        M = R[..., comb] * xp.asarray(sign)[None, None, None, None, :]
        # contract ket: T1[n,kb,h,cd] = sum_{kk,h'} M * Ecd
        T1 = xp.einsum("nqkhg,nkcg->nqhc", M, Ecd)
        # contract bra: out[n,ab,cd] = sum_{kb,h} Eab * T1
        out = xp.einsum("nqah,nqhc->nac", Eab, T1)
        return out

    return f


@lru_cache(maxsize=None)
def _eri_kernel(la, lb, lc, ld, Ka, Kb, Kc, Kd):
    """Jitted quartet-class kernel -> blocks [N, nca*ncb, ncc*ncd]."""
    return jax.jit(_eri_kernel_body(la, lb, lc, ld, Ka, Kb, Kc, Kd))


def eri_block(bra: PairBlock, ket: PairBlock, sel_bra, sel_ket, chunk=1024,
              host: bool = True):
    """ERI blocks for quartets (bra[sel_bra[i]], ket[sel_ket[i]]).

    Returns numpy [len(sel), nca*ncb, ncc*ncd].

    host=True (default) evaluates the class kernel with numpy on the host:
    the setup-phase consumers (Schwarz bounds, 2-center metric, SAD atomic
    ERIs) are tiny compute, and compiling each class kernel would cost
    more than the numpy evaluation.  host=False uses the jitted device kernel (the bulk
    path used by the in-core conventional Fock cache).
    """
    n = len(sel_bra)
    if host:
        body = _eri_kernel_body(
            bra.la, bra.lb, ket.la, ket.lb,
            bra.aexp.shape[1], bra.bexp.shape[1],
            ket.aexp.shape[1], ket.bexp.shape[1],
        )
        outs = []
        for s in range(0, n, chunk):
            ib, ik = sel_bra[s:s + chunk], sel_ket[s:s + chunk]
            outs.append(np.asarray(body(
                bra.aexp[ib], bra.bexp[ib], bra.acoef[ib], bra.bcoef[ib],
                bra.A[ib], bra.B[ib],
                ket.aexp[ik], ket.bexp[ik], ket.acoef[ik], ket.bcoef[ik],
                ket.A[ik], ket.B[ik],
            )))
        return np.concatenate(outs, axis=0)
    kern = _eri_kernel(
        bra.la, bra.lb, ket.la, ket.lb,
        bra.aexp.shape[1], bra.bexp.shape[1],
        ket.aexp.shape[1], ket.bexp.shape[1],
    )
    outs = []
    chunk = min(chunk, max(n, 1))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ib, ik = sel_bra[s:e], sel_ket[s:e]
        if e - s < chunk:
            ib = np.concatenate([ib, np.repeat(ib[:1], chunk - (e - s))])
            ik = np.concatenate([ik, np.repeat(ik[:1], chunk - (e - s))])
        res = kern(
            jnp.asarray(bra.aexp[ib]), jnp.asarray(bra.bexp[ib]),
            jnp.asarray(bra.acoef[ib]), jnp.asarray(bra.bcoef[ib]),
            jnp.asarray(bra.A[ib]), jnp.asarray(bra.B[ib]),
            jnp.asarray(ket.aexp[ik]), jnp.asarray(ket.bexp[ik]),
            jnp.asarray(ket.acoef[ik]), jnp.asarray(ket.bcoef[ik]),
            jnp.asarray(ket.A[ik]), jnp.asarray(ket.B[ik]),
        )
        outs.append(np.asarray(res)[: e - s])
    return np.concatenate(outs, axis=0)


def full_eri_tensor(basis: Basis) -> np.ndarray:
    """Dense (mu nu | lam sig) tensor — correctness reference for tiny
    systems (analog of the reference's debug integral printers).

    Computes only symmetry-unique quartets (reusing the same canonical
    class kernels as the screened Fock path) and scatters all 8 index
    images per block."""
    from .pairs import unique_pair_blocks

    nbf = basis.nbf
    G = np.zeros((nbf, nbf, nbf, nbf))
    blocks = unique_pair_blocks(basis)
    for bi, bra in enumerate(blocks):
        for bj in range(bi, len(blocks)):
            ket = blocks[bj]
            if bi == bj:
                sel_b, sel_k = np.triu_indices(bra.n)
            else:
                ii, kk = np.meshgrid(np.arange(bra.n), np.arange(ket.n), indexing="ij")
                sel_b, sel_k = ii.ravel(), kk.ravel()
            vals = eri_block(bra, ket, sel_b, sel_k)
            nca, ncb = bra.nbf_block
            ncc, ncd = ket.nbf_block
            vals = vals.reshape(-1, nca, ncb, ncc, ncd)
            for m in range(len(sel_b)):
                oa, ob = bra.off_a[sel_b[m]], bra.off_b[sel_b[m]]
                oc, od = ket.off_a[sel_k[m]], ket.off_b[sel_k[m]]
                v = vals[m]
                sa, sb = slice(oa, oa + nca), slice(ob, ob + ncb)
                sc, sd = slice(oc, oc + ncc), slice(od, od + ncd)
                G[sa, sb, sc, sd] = v
                G[sb, sa, sc, sd] = v.transpose(1, 0, 2, 3)
                G[sa, sb, sd, sc] = v.transpose(0, 1, 3, 2)
                G[sb, sa, sd, sc] = v.transpose(1, 0, 3, 2)
                G[sc, sd, sa, sb] = v.transpose(2, 3, 0, 1)
                G[sd, sc, sa, sb] = v.transpose(3, 2, 0, 1)
                G[sc, sd, sb, sa] = v.transpose(2, 3, 1, 0)
                G[sd, sc, sb, sa] = v.transpose(3, 2, 1, 0)
    return G
