"""One-electron integrals: overlap, kinetic, nuclear attraction, dipole.

Replaces the reference's OEIEngine (deps/src/jeri-oei.hpp:30-159) and the
shell-pair assembly loops in src/rhf/energy/EnergyHelpers.jl:25-140: every
angular-momentum class pair is evaluated as one batched McMurchie-Davidson
tensor program over the whole pair block.

These run on the HOST with numpy (via the dual-backend MD core in
mcmurchie.py): the compute is small, while compiling one device kernel per
class pair would cost more; the numpy path compiles nothing, and its
shapes are exact (no natom/chunk padding buckets to key compilations on).
"""

from __future__ import annotations

import numpy as np

from ..basis.structs import Basis, axial_normalization
from .boys import boys_np
from .class_tables import pair_tables
from .mcmurchie import e_dense, hermite_expansion, pair_primitive_data, r_tensor
from .pairs import PairBlock, block_scatter_indices, unique_pair_blocks

# per-chunk working-set bound (elements) for the nuclear-attraction R tensor
_WORKSET = 2.0e7


def _gather_1d(E, tab, j_shift: int = 0):
    """Per-dimension E(i,j,0) tables gathered to component-pair shape.

    E: [N,K2,3,la+1,lbx+1,L+1]; returns (ex, ey, ez) each [N,K2,nca,ncb]
    evaluated at (i_a, i_b + j_shift, t=0).
    """
    ex = E[:, :, 0, tab["ix_a"], tab["ix_b"] + j_shift, 0]
    ey = E[:, :, 1, tab["iy_a"], tab["iy_b"] + j_shift, 0]
    ez = E[:, :, 2, tab["iz_a"], tab["iz_b"] + j_shift, 0]
    return ex, ey, ez


def _stv_block(la, lb, aexp, bexp, acoef, bcoef, A, B, coords, Z):
    """S/T/V blocks for one chunk of a pair class (numpy, f64).

    Same math as the round-2 jitted `_stv_kernel`; see jeri-oei.hpp:30-159
    for the reference per-pair equivalents.
    """
    tab = pair_tables(la, lb)
    nca, ncb, L = tab["nca"], tab["ncb"], tab["L"]
    ax = np.outer(axial_normalization(la), axial_normalization(lb))

    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    p, b, cc = prim["p"], prim["b"], prim["cc"]
    pref = (np.pi / p) ** 1.5 * cc                          # [N,K2]

    # E with ket angular momentum extended by 2 (for kinetic)
    E = e_dense(la, lb + 2, prim)
    ex0, ey0, ez0 = _gather_1d(E, tab, 0)
    ex2, ey2, ez2 = _gather_1d(E, tab, 2)

    jb = np.stack([tab["ix_b"], tab["iy_b"], tab["iz_b"]]).astype(E.dtype)
    b4 = b[:, :, None, None]

    def k1d(e0, e2, j, i_a, i_b, d):
        # K(i,j) = -2 b^2 E(i,j+2) + b(2j+1) E(i,j) - j(j-1)/2 E(i,j-2)
        low = E[:, :, d, i_a, np.maximum(i_b - 2, 0), 0]
        jj = j[None, None]
        return (
            -2.0 * b4**2 * e2
            + b4 * (2.0 * jj + 1.0) * e0
            - 0.5 * jj * (jj - 1.0) * np.where(jj >= 2, low, 0.0)
        )

    kx = k1d(ex0, ex2, jb[0], tab["ix_a"], tab["ix_b"], 0)
    ky = k1d(ey0, ey2, jb[1], tab["iy_a"], tab["iy_b"], 1)
    kz = k1d(ez0, ez2, jb[2], tab["iz_a"], tab["iz_b"], 2)

    s3 = ex0 * ey0 * ez0
    t3 = kx * ey0 * ez0 + ex0 * ky * ez0 + ex0 * ey0 * kz
    S = np.einsum("nk,nkab->nab", pref, s3)
    T = np.einsum("nk,nkab->nab", pref, t3)

    # nuclear attraction
    Eab = hermite_expansion(la, lb, prim)                   # [N,K2,nab,nh]
    PC = prim["P"][:, :, None, :] - coords[None, None, :, :]
    Targ = p[:, :, None] * np.sum(PC**2, axis=-1)           # [N,K2,natom]
    F = boys_np(Targ, L)
    F = F * (-(2.0 * np.pi / p))[:, :, None, None] * Z[None, None, :, None]
    alpha = np.broadcast_to(p[:, :, None], Targ.shape)
    R = r_tensor(L, alpha, PC, F)                           # [N,K2,natom,nh]
    Rsum = R.sum(axis=2)
    V = np.einsum("nkah,nkh->na", Eab, Rsum).reshape(-1, nca, ncb)

    return S * ax, T * ax, V  # V already axial-normalized via Eab


def _dipole_block(la, lb, aexp, bexp, acoef, bcoef, A, B, origin):
    """Dipole-moment integral blocks <a| r_d - C_d |b> (numpy, f64)."""
    tab = pair_tables(la, lb)
    ax = np.outer(axial_normalization(la), axial_normalization(lb))
    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    p, cc = prim["p"], prim["cc"]
    pref = (np.pi / p) ** 1.5 * cc
    E = e_dense(la, lb + 1, prim)
    ex0, ey0, ez0 = _gather_1d(E, tab, 0)
    ex1, ey1, ez1 = _gather_1d(E, tab, 1)
    BC = B - origin[None, :]                                # [N,3]
    bc = BC[:, None, None, None, :]
    mx = ex1 + bc[..., 0] * ex0
    my = ey1 + bc[..., 1] * ey0
    mz = ez1 + bc[..., 2] * ez0
    dip = np.stack(
        [mx * ey0 * ez0, ex0 * my * ez0, ex0 * ey0 * mz], axis=-1
    )                                                       # [N,K2,a,b,3]
    out = np.einsum("nk,nkabd->nabd", pref, dip)
    return out * ax[None, :, :, None]


def _block_chunks(blk: PairBlock, natom: int):
    """Chunk sizes bounding the [N,K2,natom,nherm] nuclear R working set."""
    k2 = blk.aexp.shape[1] * blk.bexp.shape[1]
    from .class_tables import nherm
    per = k2 * max(natom, 1) * nherm(blk.la + blk.lb)
    return max(64, int(_WORKSET / max(per, 1)))


def _scatter_sym(M: np.ndarray, block: PairBlock, vals: np.ndarray) -> None:
    """Scatter pair-block values into a symmetric matrix (both triangles)."""
    ia, ib = block_scatter_indices(block)
    np.add.at(M, (ia, ib), vals)
    off = block.ish != block.jsh
    if off.any():
        np.add.at(M, (ib[off].transpose(0, 2, 1), ia[off].transpose(0, 2, 1)),
                  vals[off].transpose(0, 2, 1))


def overlap_kinetic_nuclear(basis: Basis, mol):
    """Full S, T, V matrices (numpy, f64).

    Replaces EnergyHelpers.compute_overlap/ke/nah (EnergyHelpers.jl:25-140).
    """
    nbf = basis.nbf
    S = np.zeros((nbf, nbf))
    T = np.zeros((nbf, nbf))
    V = np.zeros((nbf, nbf))
    coords = np.asarray(mol.coords, dtype=np.float64)
    Z = np.asarray(mol.z, dtype=np.float64)
    for blk in unique_pair_blocks(basis):
        chunk = _block_chunks(blk, mol.natom)
        ss, ts, vs = [], [], []
        for s0 in range(0, blk.n, chunk):
            sl = slice(s0, s0 + chunk)
            s, t, v = _stv_block(
                blk.la, blk.lb, blk.aexp[sl], blk.bexp[sl],
                blk.acoef[sl], blk.bcoef[sl], blk.A[sl], blk.B[sl],
                coords, Z)
            ss.append(s)
            ts.append(t)
            vs.append(v)
        _scatter_sym(S, blk, np.concatenate(ss, axis=0))
        _scatter_sym(T, blk, np.concatenate(ts, axis=0))
        _scatter_sym(V, blk, np.concatenate(vs, axis=0))
    return S, T, V


def dipole_matrices(basis: Basis, origin=None):
    """<mu| r - origin |nu> for x,y,z; replaces PropEngine dipole blocks
    (deps/src/jeri-prop.hpp:43-53)."""
    nbf = basis.nbf
    out = np.zeros((nbf, nbf, 3))
    origin = np.zeros(3) if origin is None else np.asarray(origin)
    for blk in unique_pair_blocks(basis):
        chunk = _block_chunks(blk, 1)
        ds = []
        for s0 in range(0, blk.n, chunk):
            sl = slice(s0, s0 + chunk)
            ds.append(_dipole_block(
                blk.la, blk.lb, blk.aexp[sl], blk.bexp[sl],
                blk.acoef[sl], blk.bcoef[sl], blk.A[sl], blk.B[sl], origin))
        d = np.concatenate(ds, axis=0)
        ia, ib = block_scatter_indices(blk)
        np.add.at(out, (ia, ib), d)
        off = blk.ish != blk.jsh
        if off.any():
            np.add.at(out, (ib[off].transpose(0, 2, 1), ia[off].transpose(0, 2, 1)),
                      d[off].transpose(0, 2, 1, 3))
    return out[..., 0], out[..., 1], out[..., 2]
