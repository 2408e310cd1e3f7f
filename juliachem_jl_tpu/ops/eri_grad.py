"""First-derivative 4-center ERIs and the two-electron RHF gradient term.

This EXCEEDS the reference: JuliaChem scaffolds gradients but disables them
("does not yet support RHF gradients", src/rhf/gradient/Gradient.jl:31-32).
Built on the same class-batched McMurchie-Davidson factorization as
ops/eri.py, using the derivative identity applied inside the contraction
(ops/oei_grad.py pattern):

    d/dAx (ab|cd) = 2a (a+1x,b|cd) - ax (a-1x,b|cd)

which is exact for the contracted integral (the dependence of P on A is
carried by the identity).  Differentiating a bra component raises the
Hermite order by one, so the R tensor runs to L+1 and the bra combination
table is combine_tables(L_bra+1, L_ket); mutatis mutandis for B and C.
The fourth center comes from translational invariance:
dD = -(dA + dB + dC).

The energy contraction uses the permutation-symmetrized two-particle density

    G~_mnls = 1/2 D_mn D_ls - 1/8 (D_ml D_ns + D_ms D_nl)

(the symmetrization of the closed-shell Gamma over the integral's m<->n,
l<->s symmetry), so unique shell pairs on each side with weight
(2 - delta_mn)(2 - delta_ls) cover the full four-index sum.

Host (numpy) evaluation like the other one-shot setup kernels: the MD
recurrences are xp-generic, and a gradient is computed once per geometry —
compiling a kernel per class would dominate any device win at the system
sizes gradients are run at today (not measured on the GPU).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..basis.structs import Basis, axial_normalization, ncart
from .boys import boys_np
from .class_tables import combine_tables, herm_list
from .eri import TWO_PI_POW_2_5
from .mcmurchie import e_dense, pair_primitive_data
from .mcmurchie import r_tensor
from .oei_grad import _component_tables, _expansion
from .pairs import unique_pair_blocks
from .schwarz import pair_schwarz

_CHUNK = 256


@lru_cache(maxsize=None)
def _eri_grad_kernel(la, lb, lc, ld):
    """Host kernel: per-quartet derivative blocks (dA, dB, dC), each
    [N, 3, nab, ncd].  dD = -(dA + dB + dC) is left to the caller."""
    Lb, Lk = la + lb, lc + ld
    L = Lb + Lk
    nab = ncart(la) * ncart(lb)
    ncd = ncart(lc) * ncart(ld)

    ia_t, ib_t = _component_tables(la, lb)
    ic_t, id_t = _component_tables(lc, ld)
    ax_b = np.outer(axial_normalization(la), axial_normalization(lb)).reshape(-1)
    ax_k = np.outer(axial_normalization(lc), axial_normalization(ld)).reshape(-1)
    hl_b0, hl_b1 = herm_list(Lb), herm_list(Lb + 1)
    hl_k0, hl_k1 = herm_list(Lk), herm_list(Lk + 1)
    comb_bra, sign_bra = combine_tables(Lb + 1, Lk)   # bra-side derivative
    comb_ket, sign_ket = combine_tables(Lb, Lk + 1)   # ket-side derivative

    def fold(Eexp, ax, cc):
        # [N,K2,na,nb,nh] -> [N,K2,na*nb,nh] with axial norms + coefficients
        N, K2 = Eexp.shape[:2]
        out = Eexp.reshape(N, K2, -1, Eexp.shape[-1])
        return out * ax[None, None, :, None] * cc[:, :, None, None]

    def f(aexp, bexp, acoef, bcoef, A, B, cexp, dexp, ccoef, dcoef, C, D):
        prim_b = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
        prim_k = pair_primitive_data(cexp, dexp, ccoef, dcoef, C, D)
        Eb = e_dense(la + 1, lb + 1, prim_b)
        Ek = e_dense(lc + 1, ld + 1, prim_k)
        p, q = prim_b["p"], prim_k["p"]
        cc_b, cc_k = prim_b["cc"], prim_k["cc"]

        PQ = prim_b["P"][:, :, None, :] - prim_k["P"][:, None, :, :]
        psum = p[:, :, None] + q[:, None, :]
        alpha = p[:, :, None] * q[:, None, :] / psum
        Targ = alpha * np.sum(PQ**2, axis=-1)
        pref = TWO_PI_POW_2_5 / (p[:, :, None] * q[:, None, :] * np.sqrt(psum))
        F = boys_np(Targ, L + 1) * pref[..., None]
        R = r_tensor(L + 1, alpha, PQ, F)             # [N,K2b,K2k,nherm(L+1)]

        # ---- bra-center derivatives (A, B) -------------------------------
        M1 = R[..., comb_bra] * sign_bra[None, None, None, None, :]
        Ecd0 = fold(_expansion(Ek, ic_t, id_t, hl_k0), ax_k, cc_k)
        T1 = np.einsum("nqkhg,nkcg->nqhc", M1, Ecd0)  # [N,K2b,nhb1,ncd]

        a2 = (2.0 * prim_b["a"])[:, :, None, None, None]
        b2 = (2.0 * prim_b["b"])[:, :, None, None, None]
        dA = np.empty((Targ.shape[0], 3, nab, ncd))
        dB = np.empty_like(dA)
        for d in range(3):
            iw = np.asarray(ia_t[d], dtype=Eb.dtype)[None, None, :, :, None]
            jw = np.asarray(ib_t[d], dtype=Eb.dtype)[None, None, :, :, None]
            dE_A = fold(
                a2 * _expansion(Eb, ia_t, ib_t, hl_b1, d, +1, "bra")
                - iw * _expansion(Eb, ia_t, ib_t, hl_b1, d, -1, "bra"),
                ax_b, cc_b)
            dE_B = fold(
                b2 * _expansion(Eb, ia_t, ib_t, hl_b1, d, +1, "ket")
                - jw * _expansion(Eb, ia_t, ib_t, hl_b1, d, -1, "ket"),
                ax_b, cc_b)
            dA[:, d] = np.einsum("nqah,nqhc->nac", dE_A, T1)
            dB[:, d] = np.einsum("nqah,nqhc->nac", dE_B, T1)

        # ---- ket-center derivative (C) -----------------------------------
        M2 = R[..., comb_ket] * sign_ket[None, None, None, None, :]
        Eab0 = fold(_expansion(Eb, ia_t, ib_t, hl_b0), ax_b, cc_b)
        S = np.einsum("nqah,nqkhg->nkag", Eab0, M2)   # [N,K2k,nab,nhk1]

        c2 = (2.0 * prim_k["a"])[:, :, None, None, None]
        dC = np.empty_like(dA)
        for d in range(3):
            kw = np.asarray(ic_t[d], dtype=Ek.dtype)[None, None, :, :, None]
            dE_C = fold(
                c2 * _expansion(Ek, ic_t, id_t, hl_k1, d, +1, "bra")
                - kw * _expansion(Ek, ic_t, id_t, hl_k1, d, -1, "bra"),
                ax_k, cc_k)
            dC[:, d] = np.einsum("nkag,nkcg->nac", S, dE_C)

        return dA, dB, dC

    return f


def two_electron_gradient(basis: Basis, mol, D: np.ndarray,
                          cutoff: float = 1.0e-11,
                          spin_densities=None) -> np.ndarray:
    """dE_2e/dR [natom, 3]: Schwarz-screened contraction of the derivative
    quartet blocks with the symmetrized two-particle density G~ (docstring).

    Iterates every ordered pair of unique shell-pair blocks (both (P,Q) and
    (Q,P)), so each side only needs its own pair weight (2 - delta).

    spin_densities=(Da, Db) switches to the UHF two-particle density
    (factor-1 spin densities; D must then be the total Da+Db):
        G~ = 1/2 Dt_mn Dt_ls
             - 1/4 sum_s (Ds_ml Ds_ns + Ds_ms Ds_nl)
    which reduces to the closed-shell expression for Da = Db = D/2."""
    natom = mol.natom
    grad = np.zeros((natom, 3))
    blocks = unique_pair_blocks(basis)
    bounds = [pair_schwarz(blk) for blk in blocks]
    d_scale = max(float(np.abs(D).max()), 1e-30) ** 2
    atom_of = basis.shell_atom

    for bi, bra in enumerate(blocks):
        nca, ncb = bra.nbf_block
        w_bra = np.where(bra.ish != bra.jsh, 2.0, 1.0)
        for bj, ket in enumerate(blocks):
            ncc, ncd_ = ket.nbf_block
            bound = bounds[bi][:, None] * bounds[bj][None, :]
            ii, jj = np.nonzero(bound * d_scale > cutoff)
            if len(ii) == 0:
                continue
            kern = _eri_grad_kernel(bra.la, bra.lb, ket.la, ket.lb)
            w_ket = np.where(ket.ish != ket.jsh, 2.0, 1.0)
            for s in range(0, len(ii), _CHUNK):
                ib, ik = ii[s:s + _CHUNK], jj[s:s + _CHUNK]
                dA, dB, dC = kern(
                    bra.aexp[ib], bra.bexp[ib], bra.acoef[ib], bra.bcoef[ib],
                    bra.A[ib], bra.B[ib],
                    ket.aexp[ik], ket.bexp[ik], ket.acoef[ik], ket.bcoef[ik],
                    ket.A[ik], ket.B[ik],
                )
                n = len(ib)
                oa = bra.off_a[ib][:, None] + np.arange(nca)[None, :]
                ob = bra.off_b[ib][:, None] + np.arange(ncb)[None, :]
                oc = ket.off_a[ik][:, None] + np.arange(ncc)[None, :]
                od = ket.off_b[ik][:, None] + np.arange(ncd_)[None, :]
                D_mn = D[oa[:, :, None], ob[:, None, :]].reshape(n, -1)
                D_ls = D[oc[:, :, None], od[:, None, :]].reshape(n, -1)

                def _exch(M):
                    M_ml = M[oa[:, :, None, None, None],
                             oc[:, None, None, :, None]]      # [n,a,1,c,1]
                    M_ns = M[ob[:, None, :, None, None],
                             od[:, None, None, None, :]]      # [n,1,b,1,d]
                    M_ms = M[oa[:, :, None, None, None],
                             od[:, None, None, None, :]]      # [n,a,1,1,d]
                    M_nl = M[ob[:, None, :, None, None],
                             oc[:, None, None, :, None]]      # [n,1,b,c,1]
                    return ((M_ml * M_ns) + (M_ms * M_nl)).reshape(
                        n, nca * ncb, ncc * ncd_)

                coul = 0.5 * D_mn[:, :, None] * D_ls[:, None, :]
                if spin_densities is None:
                    gam = coul - 0.125 * _exch(D)
                else:
                    Da_, Db_ = spin_densities
                    gam = coul - 0.25 * (_exch(Da_) + _exch(Db_))
                w = (w_bra[ib] * w_ket[ik])[:, None]
                fA = w * np.einsum("nac,ndac->nd", gam, dA)
                fB = w * np.einsum("nac,ndac->nd", gam, dB)
                fC = w * np.einsum("nac,ndac->nd", gam, dC)
                fD = -(fA + fB + fC)
                np.add.at(grad, atom_of[bra.ish[ib]], fA)
                np.add.at(grad, atom_of[bra.jsh[ib]], fB)
                np.add.at(grad, atom_of[ket.ish[ik]], fC)
                np.add.at(grad, atom_of[ket.jsh[ik]], fD)
    return grad


# ---------------------------------------------------------------------------
# Density-fitted (RI) two-electron gradient
# ---------------------------------------------------------------------------

def _dense_three_center(primary: Basis, aux: Basis) -> np.ndarray:
    """(A|pq) host-side dense 3-center tensor [naux, nbf, nbf] (gradient-scale
    systems; the production B build uses the fused device path in eri3c)."""
    from .eri import eri_block
    from .eri3c import aux_unit_blocks

    out = np.zeros((aux.nbf, primary.nbf, primary.nbf))
    for ab in aux_unit_blocks(aux):
        nca = ncart(ab.la)
        for pb in unique_pair_blocks(primary):
            ncp, ncq = pb.nbf_block
            ii, jj = np.meshgrid(np.arange(ab.n), np.arange(pb.n),
                                 indexing="ij")
            sel_a, sel_p = ii.ravel(), jj.ravel()
            # (A|pq): bra = (aux, unit), ket = primary pair
            vals = eri_block(ab, pb, sel_a, sel_p).reshape(
                len(sel_a), nca, ncp, ncq)
            ia = (ab.off_a[sel_a][:, None, None, None]
                  + np.arange(nca)[None, :, None, None])
            ip = (pb.off_a[sel_p][:, None, None, None]
                  + np.arange(ncp)[None, None, :, None])
            iq = (pb.off_b[sel_p][:, None, None, None]
                  + np.arange(ncq)[None, None, None, :])
            ia, ip, iq = np.broadcast_arrays(ia, ip, iq)
            out[ia, ip, iq] = vals
            tr = (0, 1, 3, 2)
            out[ia.transpose(tr), iq.transpose(tr), ip.transpose(tr)] = (
                vals.transpose(tr))
    return out


def df_two_electron_gradient(primary: Basis, aux: Basis, mol,
                             D: np.ndarray,
                             spin_densities=None,
                             sph_aux=None) -> np.ndarray:
    """dE_2e/dR [natom, 3] of the RI-fitted two-electron energy

        E_2e = sum_pqrs Gamma_pqrs (pq|A) M^-1_AB (B|rs),
        Gamma = 1/2 D_pq D_rs - 1/4 D_pr D_qs

    spin_densities=(Da, Db) switches to the UHF fitted functional
    (factor-1 spin densities, D = Da + Db):
        Gamma = 1/2 Dt_pq Dt_rs - 1/2 sum_s Ds_pr Ds_qs
    (reduces to the closed-shell form for Da = Db = D/2); only the fitted
    intermediate U changes, the derivative machinery is shared.

    =  2 sum_{A,pq} gamma_{A,pq} d(A|pq)  -  sum_{AB} Omega_AB dM_AB

    with gamma = M^-1 U,  U_A = 1/2 (P3_A . D) D - 1/4 D P3_A D (symmetric
    in pq),  W = M^-1 P3,  Omega = sym(W gamma^T) (from the metric-inverse
    derivative dM^-1 = -M^-1 dM M^-1).  The factor 2 on the 3-center term
    uses Gamma's (pq)<->(rs) symmetry.

    Derivative blocks come from the same 4-center kernels with the unit
    ket-partner trick eri3c uses for the undifferentiated tensors: the unit
    shell has exponent 0, so its center derivative vanishes identically
    (2b*(j+1 image) - j*(j-1 image) = 0) and the aux-center derivative is
    just the kernel's bra-A derivative.

    sph_aux=True (the energy path's default, models/df*.py) performs the
    fit algebra in the solid-harmonic-projected aux space the SCF actually
    fitted in, then lifts gamma/Omega back to Cartesian aux rows through
    the geometry-independent per-shell transform T (d(A'|pq) = T^T d(A|pq)
    and dM' = T^T dM T, so the lifted contractions are exact)."""
    from ..basis.spherical import (aux_needs_sph, lift_rows_sph,
                                   project_metric_sph, project_rows_sph)
    from .eri3c import aux_unit_blocks, two_center_metric

    natom = mol.natom
    nbf, naux = primary.nbf, aux.nbf
    atom_of_p = primary.shell_atom
    atom_of_a = aux.shell_atom

    P3 = _dense_three_center(primary, aux)
    M = two_center_metric(aux)
    P3f = P3.reshape(naux, -1)
    if sph_aux is None:
        sph_aux = True
    sph = bool(sph_aux) and aux_needs_sph(aux)
    if sph:
        P3f = project_rows_sph(aux, P3f)                     # [A_s, nbf^2]
        M = project_metric_sph(aux, M)
    P3c = P3f.reshape(len(P3f), nbf, nbf)

    v = P3f @ D.reshape(-1)                                  # [naux(_s)]
    if spin_densities is None:
        U = (0.5 * v[:, None, None] * D[None]
             - 0.25 * np.einsum("pr,ars,sq->apq", D, P3c, D))
    else:
        Da_, Db_ = spin_densities
        U = (0.5 * v[:, None, None] * D[None]
             - 0.5 * (np.einsum("pr,ars,sq->apq", Da_, P3c, Da_)
                      + np.einsum("pr,ars,sq->apq", Db_, P3c, Db_)))
    gamma = np.linalg.solve(M, U.reshape(len(P3f), -1))      # [naux(_s), nbf^2]
    W = np.linalg.solve(M, P3f)
    Omega = W @ gamma.T
    Omega = 0.5 * (Omega + Omega.T)
    if sph:
        gamma = lift_rows_sph(aux, gamma)
        Omega = lift_rows_sph(
            aux, np.ascontiguousarray(lift_rows_sph(aux, Omega).T))
    gamma = gamma.reshape(naux, nbf, nbf)

    grad = np.zeros((natom, 3))

    # ---- 3-center term: 2 sum_{A,pq} gamma d(A|pq) -----------------------
    for ab in aux_unit_blocks(aux):
        nca = ncart(ab.la)
        for pb in unique_pair_blocks(primary):
            ncp, ncq = pb.nbf_block
            kern = _eri_grad_kernel(ab.la, 0, pb.la, pb.lb)
            w_pq = np.where(pb.ish != pb.jsh, 2.0, 1.0)
            ii, jj = np.meshgrid(np.arange(ab.n), np.arange(pb.n),
                                 indexing="ij")
            sel_a, sel_p = ii.ravel(), jj.ravel()
            for s in range(0, len(sel_a), _CHUNK):
                ia_, ip_ = sel_a[s:s + _CHUNK], sel_p[s:s + _CHUNK]
                dA, _dB, dC = kern(
                    ab.aexp[ia_], ab.bexp[ia_], ab.acoef[ia_], ab.bcoef[ia_],
                    ab.A[ia_], ab.B[ia_],
                    pb.aexp[ip_], pb.bexp[ip_], pb.acoef[ip_], pb.bcoef[ip_],
                    pb.A[ip_], pb.B[ip_],
                )
                n = len(ia_)
                oa = ab.off_a[ia_][:, None] + np.arange(nca)[None, :]
                op = pb.off_a[ip_][:, None] + np.arange(ncp)[None, :]
                oq = pb.off_b[ip_][:, None] + np.arange(ncq)[None, :]
                g = gamma[oa[:, :, None, None], op[:, None, :, None],
                          oq[:, None, None, :]].reshape(n, nca, ncp * ncq)
                w = (2.0 * w_pq[ip_])[:, None]
                fA = w * np.einsum("nac,ndac->nd", g, dA)    # aux center
                fC = w * np.einsum("nac,ndac->nd", g, dC)    # primary p-shell
                # dD = -(dA + dB + dC), dB == 0 for the unit partner
                fD = -(fA + fC)
                np.add.at(grad, atom_of_a[ab.ish[ia_]], fA)
                np.add.at(grad, atom_of_p[pb.ish[ip_]], fC)
                np.add.at(grad, atom_of_p[pb.jsh[ip_]], fD)

    # ---- 2-center (metric) term: - sum Omega_AB dM_AB --------------------
    aux_blocks = aux_unit_blocks(aux)
    for abi in aux_blocks:
        ncp_ = ncart(abi.la)
        for abj in aux_blocks:
            ncq_ = ncart(abj.la)
            kern = _eri_grad_kernel(abi.la, 0, abj.la, 0)
            ii, jj = np.meshgrid(np.arange(abi.n), np.arange(abj.n),
                                 indexing="ij")
            sel_i, sel_j = ii.ravel(), jj.ravel()
            for s in range(0, len(sel_i), _CHUNK):
                ia_, ib_ = sel_i[s:s + _CHUNK], sel_j[s:s + _CHUNK]
                dA, _dB, dC = kern(
                    abi.aexp[ia_], abi.bexp[ia_], abi.acoef[ia_],
                    abi.bcoef[ia_], abi.A[ia_], abi.B[ia_],
                    abj.aexp[ib_], abj.bexp[ib_], abj.acoef[ib_],
                    abj.bcoef[ib_], abj.A[ib_], abj.B[ib_],
                )
                n = len(ia_)
                op = abi.off_a[ia_][:, None] + np.arange(ncp_)[None, :]
                oq = abj.off_a[ib_][:, None] + np.arange(ncq_)[None, :]
                om = Omega[op[:, :, None], oq[:, None, :]]   # [n, ncp, ncq]
                fA = -np.einsum("nac,ndac->nd", om, dA)
                fC = -np.einsum("nac,ndac->nd", om, dC)
                np.add.at(grad, atom_of_a[abi.ish[ia_]], fA)
                np.add.at(grad, atom_of_a[abj.ish[ib_]], fC)
    return grad
