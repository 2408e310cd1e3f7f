"""First-derivative one-electron integrals (gradients of S, T, V).

Batched equivalent of the reference's OEIEngine derivative blocks
(deps/src/jeri-oei.hpp:67-199, compute_*_grad_block) and their assembly in
src/rhf/gradient/GradHelpers.jl:65-467 — built on the same batched
McMurchie-Davidson machinery as ops/oei.py using the exact operator identity

    d/dAx  phi_i = 2a phi_{i+1} - i phi_{i-1}

applied inside the primitive contraction (the 2a weight is per-primitive).
For the two-center S and T, translational invariance gives d/dB = -d/dA.
For the nuclear attraction the three centers satisfy
dV/dA + dV/dB + sum_C dV/dC = 0, with the per-nucleus (Hellmann-Feynman)
term obtained from the Hermite-Coulomb shift dR_tuv/dCx = -R_{t+1,u,v}.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..basis.structs import Basis, axial_normalization, cart_components, ncart
from .boys import boys_np
from .class_tables import herm_index, herm_list, pair_tables
from .mcmurchie import e_dense, pair_primitive_data, r_tensor
from .pairs import PairBlock, block_scatter_indices, unique_pair_blocks

_CHUNK = 2048


def _component_tables(la: int, lb: int):
    """Per-dimension angular momenta of each (bra, ket) component pair."""
    ca = np.array(cart_components(la))   # [nca, 3]
    cb = np.array(cart_components(lb))
    nca, ncb = ncart(la), ncart(lb)
    ia = np.broadcast_to(ca.T[:, :, None], (3, nca, ncb))
    ib = np.broadcast_to(cb.T[:, None, :], (3, nca, ncb))
    return ia.copy(), ib.copy()


def _expansion(E, ia, ib, hl, dim=None, delta=0, side="bra"):
    """Gather a 3D Hermite expansion over hl = herm_list(L') from the dense
    per-dimension table E [N,K2,3,Imax,Jmax,Tmax], with an optional +1/-1
    angular-momentum shift (delta) in one dimension on one side ("bra"/"ket").

    Returns [N, K2, nca, ncb, nh'].  Out-of-range (negative) indices are
    clamped — callers weight those entries by the original index, which is
    zero exactly when the clamp applied.
    """
    hl = np.asarray(hl)
    out = 1.0
    for d in range(3):
        i_d, j_d = ia[d], ib[d]
        if dim == d:
            if side == "bra":
                i_d = np.maximum(i_d + delta, 0)
            else:
                j_d = np.maximum(j_d + delta, 0)
        t_d = hl[:, d]
        out = out * E[:, :, d, i_d[:, :, None], j_d[:, :, None], t_d[None, None, :]]
    return out


@lru_cache(maxsize=None)
def _stv_grad_kernel(la: int, lb: int, Ka: int, Kb: int):
    """Host (numpy) kernel: per-pair dS/dA, dT/dA (d/dB = -d/dA), dV/dA,
    dV/dB and the per-nucleus dV/dC blocks for one class pair.  Runs on the
    host like ops/oei.py — tiny compute, and compilation would dominate."""
    tab = pair_tables(la, lb)
    nca, ncb = tab["nca"], tab["ncb"]
    L = la + lb
    Lg = L + 1
    ax = np.outer(axial_normalization(la), axial_normalization(lb))
    ia_t, ib_t = _component_tables(la, lb)          # [3, nca, ncb] ints
    hlL = herm_list(L)
    hlG = herm_list(Lg)
    idxG = herm_index(Lg)
    # map herm(L) triple -> index of its +1-in-dim-d image inside herm(L+1)
    shift_maps = [
        np.array([idxG[(t + (d == 0), u + (d == 1), v + (d == 2))]
                  for (t, u, v) in hlL])
        for d in range(3)
    ]

    def f(aexp, bexp, acoef, bcoef, A, B, coords, Z):
        natom = coords.shape[0]
        prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
        p, a, b, cc = prim["p"], prim["a"], prim["b"], prim["cc"]
        pref = (np.pi / p) ** 1.5 * cc                      # [N,K2]
        a2 = (2.0 * a)[:, :, None, None]
        axj = np.asarray(ax)

        # dense E with bra extended by 1, ket by 2 (kinetic needs j+2)
        E = e_dense(la + 1, lb + 2, prim)

        def g(d, i_d, j_d):
            return E[:, :, d, i_d, j_d, 0]                   # [N,K2,nca,ncb]

        iw = [np.asarray(ia_t[d], dtype=E.dtype) for d in range(3)]

        e0 = [g(d, ia_t[d], ib_t[d]) for d in range(3)]
        de = []
        for d in range(3):
            plus = g(d, ia_t[d] + 1, ib_t[d])
            minus = g(d, np.maximum(ia_t[d] - 1, 0), ib_t[d])
            de.append(a2 * plus - iw[d][None, None] * minus)

        def k1d(d, i_d):
            j_d = ib_t[d]
            jj = np.asarray(j_d, dtype=E.dtype)[None, None]
            b4 = b[:, :, None, None]
            e_0 = g(d, i_d, j_d)
            e_2 = g(d, i_d, j_d + 2)
            e_m = g(d, i_d, np.maximum(j_d - 2, 0))
            return (
                -2.0 * b4**2 * e_2
                + b4 * (2.0 * jj + 1.0) * e_0
                - 0.5 * jj * (jj - 1.0) * np.where(jj >= 2, e_m, 0.0)
            )

        k0 = [k1d(d, ia_t[d]) for d in range(3)]
        dk = []
        for d in range(3):
            plus = k1d(d, ia_t[d] + 1)
            minus = k1d(d, np.maximum(ia_t[d] - 1, 0))
            dk.append(a2 * plus - iw[d][None, None] * minus)

        def contract(x):
            return np.einsum("nk,nkab->nab", pref, x) * axj

        dS = np.stack([
            contract(de[0] * e0[1] * e0[2]),
            contract(e0[0] * de[1] * e0[2]),
            contract(e0[0] * e0[1] * de[2]),
        ], axis=1)                                           # [N,3,a,b]
        dT = np.stack([
            contract(dk[0] * e0[1] * e0[2] + de[0] * (k0[1] * e0[2] + e0[1] * k0[2])),
            contract(e0[0] * dk[1] * e0[2] + de[1] * (k0[0] * e0[2] + e0[0] * k0[2])),
            contract(e0[0] * e0[1] * dk[2] + de[2] * (k0[0] * e0[1] + e0[0] * k0[1])),
        ], axis=1)

        # ---- nuclear attraction derivatives --------------------------------
        PC = prim["P"][:, :, None, :] - coords[None, None, :, :]
        Targ = p[:, :, None] * np.sum(PC**2, axis=-1)
        F = boys_np(Targ, Lg)
        F = F * (-(2.0 * np.pi / p))[:, :, None, None] * Z[None, None, :, None]
        alpha = np.broadcast_to(p[:, :, None], Targ.shape)
        R = r_tensor(Lg, alpha, PC, F)                       # [N,K2,natom,nhG]
        Rsum = R.sum(axis=2)                                 # [N,K2,nhG]

        axf = np.asarray(ax.reshape(-1))
        ccw = cc[:, :, None, None]

        def vcontract(Eexp, Rarr):
            # Eexp [N,K2,nca,ncb,nh'], Rarr [N,K2,nh'] -> [N,a,b]
            N = Eexp.shape[0]
            Ee = Eexp.reshape(N, Eexp.shape[1], nca * ncb, -1)
            out = np.einsum("nkah,nkh->na", Ee, Rarr)
            return (out * axf[None, :]).reshape(N, nca, ncb)

        dVA, dVB = [], []
        for d in range(3):
            Ep_a = _expansion(E, ia_t, ib_t, hlG, d, +1, "bra")
            Em_a = _expansion(E, ia_t, ib_t, hlG, d, -1, "bra")
            w_a = iw[d][None, None, :, :, None]
            Ed_a = (a2[..., None] * Ep_a - w_a * Em_a) * ccw[..., None]
            dVA.append(vcontract(Ed_a, Rsum))

            b2 = (2.0 * b)[:, :, None, None, None]
            jw = np.asarray(ib_t[d], dtype=E.dtype)[None, None, :, :, None]
            Ep_b = _expansion(E, ia_t, ib_t, hlG, d, +1, "ket")
            Em_b = _expansion(E, ia_t, ib_t, hlG, d, -1, "ket")
            Ed_b = (b2 * Ep_b - jw * Em_b) * ccw[..., None]
            dVB.append(vcontract(Ed_b, Rsum))
        dVA = np.stack(dVA, axis=1)                         # [N,3,a,b]
        dVB = np.stack(dVB, axis=1)

        # per-nucleus Hellmann-Feynman term: dV/dCx = -sum E R^{(C)}_{t+1}
        Eab = _expansion(E, ia_t, ib_t, hlL) * ccw[..., None]
        N = Eab.shape[0]
        Eab = Eab.reshape(N, Eab.shape[1], nca * ncb, -1)
        dVC = []
        for d in range(3):
            Rs = R[..., np.asarray(shift_maps[d])]          # [N,K2,natom,nhL]
            out = -np.einsum("nkah,nkch->nca", Eab, Rs)
            dVC.append((out * axf[None, None, :]).reshape(N, natom, nca, ncb))
        dVC = np.stack(dVC, axis=2)                         # [N,natom,3,a,b]

        return dS, dT, dVA, dVB, dVC

    return f


def stv_gradients(basis: Basis, mol):
    """Full derivative matrices dS, dT, dV [natom, 3, nbf, nbf]
    (GradHelpers.jl:65-467 assembly analog)."""
    nbf, natom = basis.nbf, mol.natom
    coords = np.asarray(mol.coords, dtype=np.float64)
    Z = np.asarray(mol.z, dtype=np.float64)

    dS = np.zeros((natom, 3, nbf, nbf))
    dT = np.zeros((natom, 3, nbf, nbf))
    dV = np.zeros((natom, 3, nbf, nbf))

    for blk in unique_pair_blocks(basis):
        kern = _stv_grad_kernel(blk.la, blk.lb, blk.aexp.shape[1],
                                blk.bexp.shape[1])
        parts = [[], [], [], [], []]
        for s0 in range(0, blk.n, _CHUNK):
            sl = slice(s0, s0 + _CHUNK)
            res = kern(blk.aexp[sl], blk.bexp[sl], blk.acoef[sl],
                       blk.bcoef[sl], blk.A[sl], blk.B[sl], coords, Z)
            for ps, r in zip(parts, res):
                ps.append(r)
        ds, dt, dva, dvb, dvc = (np.concatenate(ps, axis=0) for ps in parts)
        at_a = basis.shell_atom[blk.ish]
        at_b = basis.shell_atom[blk.jsh]
        ia, ib = block_scatter_indices(blk)                  # [n, nca, ncb]
        off = blk.ish != blk.jsh

        def scat(M, atoms, vals):
            # vals [n, 3, nca, ncb] -> M[atom, :, ia, ib] (+ mirror image)
            np.add.at(M, (atoms[:, None, None, None],
                          np.arange(3)[None, :, None, None],
                          ia[:, None], ib[:, None]), vals)
            if off.any():
                np.add.at(M, (atoms[off][:, None, None, None],
                              np.arange(3)[None, :, None, None],
                              ib[off][:, None].transpose(0, 1, 3, 2),
                              ia[off][:, None].transpose(0, 1, 3, 2)),
                          vals[off].transpose(0, 1, 3, 2))

        scat(dS, at_a, ds)
        scat(dS, at_b, -ds)        # translational invariance: d/dB = -d/dA
        scat(dT, at_a, dt)
        scat(dT, at_b, -dt)
        scat(dV, at_a, dva)
        scat(dV, at_b, dvb)
        for c in range(natom):
            scat(dV, np.full(blk.n, c), dvc[:, c])
    return dS, dT, dV
