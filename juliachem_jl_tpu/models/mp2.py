"""RI-MP2 correlation energy on the density-fitted 3-index tensor.

The reference snapshot has no MP2 code (SURVEY.md header), but its data
artifacts anticipate it (eatom.h5 ships RIMP2 atomic energies; inputs are
named *_MP2.json; cc-pVDZ-RIFIT appears in 41 inputs).  This implements the
standard RI-MP2:

    B_ia^Q = sum_{mu nu} C_mu i  B^Q_{mu nu}  C_nu a          (AO->MO)
    (ia|jb) = sum_Q B_ia^Q B_jb^Q
    E2 = sum_{ijab} (ia|jb) [ 2 (ia|jb) - (ib|ja) ] / (e_i + e_j - e_a - e_b)

Device mapping: the AO->MO transform is two gemms; the ij-pair loop is a
lax.scan of [nvirt, nvirt] gemms — all DGEMM work.  Multi-device: the Q axis of
B_ia is contracted locally per shard and psum'd (see parallel/shard.py
pattern); the ij scan parallelizes over the mesh by i-blocks.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _cart_mo(result, C: np.ndarray) -> np.ndarray:
    """MO coefficients over the CARTESIAN AO rows: spherical-harmonic runs
    (rhf.py 'Spherical Transform') store C over the 2l+1 spherical AOs,
    while the B tensors here are built from the Cartesian MD kernels —
    C_cart = T C_sph spans the identical MO space, so E2 is exact."""
    T = result.get("Spherical Transform")
    return np.asarray(T) @ C if T is not None else C


@jax.jit
def _mo_b(B, Cocc, Cvirt):
    """B_ia^Q: [A, nocc, nvirt]."""
    t = jnp.einsum("qmn,mi->qin", B, Cocc)
    return jnp.einsum("qin,na->qia", t, Cvirt)


def _e2_kernel(Bia, eps_occ, eps_virt):
    """Scan over occupied i; for each i one gemm gives (ia|jb) for all j."""
    nocc = Bia.shape[1]

    def body(carry, i):
        # iab: [nocc, nvirt, nvirt] = (ia|jb) for this i over all j
        Bi = Bia[:, i, :]                                    # [A, nvirt]
        iajb = jnp.einsum("qa,qjb->jab", Bi, Bia)            # [nocc, nv, nv]
        denom = (
            eps_occ[i]
            + eps_occ[:, None, None]
            - eps_virt[None, :, None]
            - eps_virt[None, None, :]
        )
        t = iajb / denom
        e = jnp.sum(t * (2.0 * iajb - jnp.swapaxes(iajb, -1, -2)))
        return carry + e, None

    total, _ = jax.lax.scan(body, 0.0, jnp.arange(nocc))
    return total


_e2_jit = jax.jit(_e2_kernel)


def make_sharded_e2(mesh, npq1: int, nbf: int, nocc_pad: int, n_i_blk: int):
    """Sharded E2: packed-B shards -> local MO transform -> all_gather of
    B_ia over the mesh -> disjoint i-blocks per device -> scalar psum.

    The multi-device mapping sketched in the module docstring: the AO->MO
    transform is local to each device's Q rows (zero comms), B_ia rides one
    all_gather, and the ij-pair gemm scan splits its i axis across
    the mesh (BASELINE.json "MP2 on S22 ... multi-chip" config).

    Padding conventions (all handled without masks): occupied/virtual
    columns padded with zero C columns give exactly-zero B_ia slices, and
    their eps pads (-1e3 / +1e3) keep every denominator nonzero.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    nk = mesh.shape["k"]

    def local_e2(B_blk, col_map, Cocc, Cvirt, eps_occ, eps_virt):
        tile = B_blk[:, col_map].reshape(-1, nbf, nbf)
        t = jnp.einsum("qmn,mi->qin", tile, Cocc)
        Bia_l = jnp.einsum("qin,na->qia", t, Cvirt)      # [A_l, no_p, nv_p]
        Bia = jax.lax.all_gather(Bia_l, ("q", "k"), axis=0, tiled=True)
        dev = jax.lax.axis_index("q") * nk + jax.lax.axis_index("k")
        i0 = dev * n_i_blk

        def body(carry, k):
            i = jnp.minimum(i0 + k, nocc_pad - 1)
            Bi = jax.lax.dynamic_index_in_dim(Bia, i, axis=1, keepdims=False)
            iajb = jnp.einsum("qa,qjb->jab", Bi, Bia)
            denom = (eps_occ[i] + eps_occ[:, None, None]
                     - eps_virt[None, :, None] - eps_virt[None, None, :])
            t2 = iajb / denom
            e = jnp.sum(t2 * (2.0 * iajb - jnp.swapaxes(iajb, -1, -2)))
            # duplicate clamped trailing i's contribute zero (zero C column),
            # so no explicit mask is needed
            return carry + e, None

        e_loc, _ = jax.lax.scan(body, 0.0, jnp.arange(n_i_blk))
        return jax.lax.psum(e_loc, ("q", "k"))

    fn = shard_map(
        local_e2, mesh=mesh,
        in_specs=(P(("q", "k"), None), P(), P(), P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(fn)


def ri_mp2_energy_sharded(rhf_result, basis_sets, n_devices: int,
                          opts=None) -> dict:
    """Multi-chip RI-MP2: packed B built/sharded over the mesh
    (parallel/build.py), E2 via make_sharded_e2."""
    from ..parallel import mesh as mesh_mod
    from ..parallel.build import build_B_packed_sharded

    primary = basis_sets.primary
    if basis_sets.auxiliary is None:
        raise ValueError("RI-MP2 requires an auxiliary basis")
    mesh = mesh_mod.make_mesh(n_devices)
    B_sh, screen, A_pad, qc, n_chunks = build_B_packed_sharded(
        primary, basis_sets.auxiliary, mesh, opts)

    C = _cart_mo(rhf_result, np.asarray(rhf_result["MO Coeff"]))
    eps = np.asarray(rhf_result["MO Energies"])
    nocc = int(primary.nels // 2)
    nbf = primary.nbf
    nmo = C.shape[1]
    nvirt = nmo - nocc
    ndev = mesh.devices.size
    n_i_blk = -(-nocc // ndev)
    nocc_pad = n_i_blk * ndev
    nv_pad = -(-max(nvirt, 1) // 8) * 8

    Cocc = np.zeros((nbf, nocc_pad))
    Cocc[:, :nocc] = C[:, :nocc]
    Cvirt = np.zeros((nbf, nv_pad))
    Cvirt[:, :nvirt] = C[:, nocc:]
    eo = np.full(nocc_pad, -1.0e3)
    eo[:nocc] = eps[:nocc]
    ev = np.full(nv_pad, 1.0e3)
    ev[:nvirt] = eps[nocc:]

    e2_fn = make_sharded_e2(mesh, screen.npq + 1, nbf, nocc_pad, n_i_blk)
    e2 = float(e2_fn(B_sh, jnp.asarray(screen.col_map), jnp.asarray(Cocc),
                     jnp.asarray(Cvirt), jnp.asarray(eo), jnp.asarray(ev)))
    return {
        "E2": e2,
        "Energy": float(rhf_result["Energy"]) + e2,
        "E_HF": float(rhf_result["Energy"]),
    }


def _e2_ss_kernel(Bia, eps_occ, eps_virt):
    """Same-spin UMP2 channel: (1/4) sum |<ij||ab>|^2 / Delta via a scan of
    per-i gemms (antisymmetrized in the virtual pair)."""
    nocc = Bia.shape[1]

    def body(carry, i):
        Bi = Bia[:, i, :]
        iajb = jnp.einsum("qa,qjb->jab", Bi, Bia)
        anti = iajb - jnp.swapaxes(iajb, -1, -2)
        denom = (eps_occ[i] + eps_occ[:, None, None]
                 - eps_virt[None, :, None] - eps_virt[None, None, :])
        return carry + 0.25 * jnp.sum(anti * anti / denom), None

    total, _ = jax.lax.scan(body, 0.0, jnp.arange(nocc))
    return total


def _e2_os_kernel(Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b):
    """Opposite-spin UMP2 channel: sum (ia|jb)^2 / Delta (i alpha, j beta)."""
    nocc_a = Bia_a.shape[1]

    def body(carry, i):
        Bi = Bia_a[:, i, :]
        iajb = jnp.einsum("qa,qjb->jab", Bi, Bia_b)
        denom = (eo_a[i] + eo_b[:, None, None]
                 - ev_a[None, :, None] - ev_b[None, None, :])
        return carry + jnp.sum(iajb * iajb / denom), None

    total, _ = jax.lax.scan(body, 0.0, jnp.arange(nocc_a))
    return total


_e2_ss_jit = jax.jit(_e2_ss_kernel)
_e2_os_jit = jax.jit(_e2_os_kernel)


def ri_ump2_energy(uhf_result, basis_sets, B=None, opts=None) -> dict:
    """RI-UMP2 correlation energy from a converged UHF (or ROHF) result.

    E2 = E_aa + E_bb (antisymmetrized same-spin) + E_ab (opposite-spin).
    For a closed-shell reference this reduces exactly to ri_mp2_energy
    (tests/test_uhf.py pins the identity).  Also returns the channel split
    (useful for SCS-type scaling)."""
    from .df import build_B

    primary = basis_sets.primary
    aux = basis_sets.auxiliary
    if B is None:
        if aux is None:
            raise ValueError("RI-MP2 requires an auxiliary basis")
        B = build_B(primary, aux, opts)
    B = jnp.asarray(B)

    na = int(uhf_result["N Alpha"])
    nb = int(uhf_result["N Beta"])
    Ca = np.asarray(uhf_result["MO Coeff Alpha"]
                    if "MO Coeff Alpha" in uhf_result
                    else uhf_result["MO Coeff"])
    Cb = np.asarray(uhf_result.get("MO Coeff Beta", Ca))
    Ca = _cart_mo(uhf_result, Ca)
    Cb = _cart_mo(uhf_result, Cb)
    ea = np.asarray(uhf_result["MO Energies Alpha"]
                    if "MO Energies Alpha" in uhf_result
                    else uhf_result["MO Energies"])
    eb = np.asarray(uhf_result.get("MO Energies Beta", ea))

    Bia_a = _mo_b(B, jnp.asarray(Ca[:, :na]), jnp.asarray(Ca[:, na:]))
    Bia_b = _mo_b(B, jnp.asarray(Cb[:, :nb]), jnp.asarray(Cb[:, nb:]))
    e_aa = float(_e2_ss_jit(Bia_a, jnp.asarray(ea[:na]), jnp.asarray(ea[na:])))
    e_bb = float(_e2_ss_jit(Bia_b, jnp.asarray(eb[:nb]), jnp.asarray(eb[nb:])))
    e_ab = float(_e2_os_jit(Bia_a, Bia_b,
                            jnp.asarray(ea[:na]), jnp.asarray(ea[na:]),
                            jnp.asarray(eb[:nb]), jnp.asarray(eb[nb:])))
    e2 = e_aa + e_bb + e_ab
    e_ss = e_aa + e_bb
    return {
        "E2": e2,
        "E2 Same Spin": e_ss,
        "E2 Opposite Spin": e_ab,
        "E2 SCS": 1.2 * e_ab + e_ss / 3.0,   # Grimme spin-component scaling
        "Energy": float(uhf_result["Energy"]) + e2,
        "E_HF": float(uhf_result["Energy"]),
    }


def ri_mp2_energy(rhf_result, basis_sets, mol=None, B=None, opts=None,
                  scs: bool = False) -> dict:
    """Compute the RI-MP2 correlation energy from a converged RHF result.

    Uses the auxiliary basis of basis_sets (RIFIT recommended); reuses a
    prebuilt B tensor if given.  num_devices > 1 in opts routes to the
    mesh-sharded path (ri_mp2_energy_sharded).  scs=True adds the
    spin-channel split and the SCS-MP2 energy (one extra E2-cost pass).
    """
    from .df import build_B

    n_dev = int(getattr(opts, "num_devices", 1) or 1) if opts is not None else 1
    if B is None and n_dev > 1:
        return ri_mp2_energy_sharded(rhf_result, basis_sets, n_dev, opts)

    primary = basis_sets.primary
    aux = basis_sets.auxiliary
    if B is None:
        if aux is None:
            raise ValueError("RI-MP2 requires an auxiliary basis")
        B = build_B(primary, aux, opts)
    B = jnp.asarray(B)

    C = _cart_mo(rhf_result, np.asarray(rhf_result["MO Coeff"]))
    eps = np.asarray(rhf_result["MO Energies"])
    nocc = int(primary.nels // 2)
    Cocc, Cvirt = C[:, :nocc], C[:, nocc:]
    eps_occ, eps_virt = eps[:nocc], eps[nocc:]

    Bia = _mo_b(B, jnp.asarray(Cocc), jnp.asarray(Cvirt))
    e2 = float(_e2_jit(Bia, jnp.asarray(eps_occ), jnp.asarray(eps_virt)))
    out = {
        "E2": e2,
        "Energy": float(rhf_result["Energy"]) + e2,
        "E_HF": float(rhf_result["Energy"]),
    }
    if scs:
        # channel split: E_os = sum (ia|jb)^2/Delta; E_ss = E2 - E_os
        eo, ev = jnp.asarray(eps_occ), jnp.asarray(eps_virt)
        e_os = float(_e2_os_jit(Bia, Bia, eo, ev, eo, ev))
        e_ss = e2 - e_os
        out["E2 Opposite Spin"] = e_os
        out["E2 Same Spin"] = e_ss
        out["E2 SCS"] = 1.2 * e_os + e_ss / 3.0
    return out
