"""UHF energy driver — unrestricted (spin-polarized) Hartree-Fock.

This EXCEEDS the reference, which is RHF-only (src/rhf/energy/SCF.jl:69
`rhf_kernel`; odd-electron systems are simply impossible there).  The design
reuses the whole stack: the same class-batched MD integrals, the
same Fock digestion machinery (via the builders' ``two_electron_jk``
interface) and the same host LAPACK Roothaan step — UHF is two coupled
Roothaan problems sharing one Coulomb build:

    F_a = H + J(D_a + D_b) - K(D_a)
    F_b = H + J(D_a + D_b) - K(D_b)

with factor-1 spin densities D_s = C_s,occ C_s,occ^T.  The conventional
builder gets (J, K_a, K_b) from TWO digestion passes exploiting linearity
(K(D_a) = [K(D_t) + K(D_s)]/2 with D_s = D_a - D_b), the DF builder from the
shared fitted B tensor (one V_Q for J, one W per spin for K).

Result dict mirrors models/rhf.py plus S^2 / multiplicity / spin density.
"""

from __future__ import annotations

import time

import numpy as np

from ..utils import constants as C
from ..utils import memory
from ..utils.options import create_scf_options
from ..utils.timings import JCTC, Timings
from ..ops.oei import overlap_kinetic_nuclear
from . import linalg
from .scf import _device_bytes_in_use


def _occupations(nels: int, multiplicity: int) -> tuple[int, int]:
    """(n_alpha, n_beta) from electron count and spin multiplicity 2S+1."""
    if multiplicity < 1:
        raise ValueError(f"multiplicity must be >= 1 (got {multiplicity})")
    n_unpaired = multiplicity - 1
    if (nels - n_unpaired) % 2 != 0 or nels < n_unpaired:
        raise ValueError(
            f"multiplicity {multiplicity} is impossible for {nels} electrons"
        )
    nb = (nels - n_unpaired) // 2
    na = nb + n_unpaired
    return na, nb


def _spin_step(F, X, nocc):
    """Roothaan step for one spin channel: factor-1 density."""
    F = np.asarray(F)
    Fp = X.T @ F @ X
    eps, Cp = np.linalg.eigh(Fp)
    Cmo = X @ Cp
    Cocc = Cmo[:, :nocc]
    return eps, Cmo, Cocc @ Cocc.T


def s_squared(Ca, Cb, S, na: int, nb: int) -> float:
    """<S^2> = Sz(Sz+1) + N_b - sum_ij |(C_a^T S C_b)_ij|^2 (occ x occ)."""
    sz = 0.5 * (na - nb)
    if na == 0 or nb == 0:
        return sz * (sz + 1.0)
    Sab = Ca[:, :na].T @ S @ Cb[:, :nb]
    return float(sz * (sz + 1.0) + nb - np.sum(Sab ** 2))


def energy(mol, basis_sets, scf_flags: dict | None = None,
           output: int = 0) -> dict:
    """Compute the UHF (or DF-UHF) energy.

    Extra keywords over rhf.energy: ``multiplicity`` (default: from
    mol.multiplicity, default 1) and ``guess_mix`` (HOMO-LUMO mixing angle
    in radians applied to the alpha channel of the initial guess — breaks
    spin symmetry for singlet diradicals, e.g. stretched H2).
    """
    t0 = time.perf_counter()
    scf_flags = dict(scf_flags or {})
    multiplicity = int(scf_flags.pop(
        "multiplicity", getattr(mol, "multiplicity", 1)))
    guess_mix = float(scf_flags.pop("guess_mix", 0.0))
    opts = create_scf_options(scf_flags)
    timings = Timings()
    timings.set_user_options(scf_flags)
    timings.set_options(opts)

    primary = basis_sets.primary
    timings.set_basis_info(
        primary.nbf, primary.nels,
        basis_sets.auxiliary.nbf if basis_sets.auxiliary is not None else None)

    e_nuc = mol.nuclear_repulsion()
    na, nb = _occupations(primary.nels, multiplicity)

    with timings.timed(JCTC.H_time):
        S, T, V = overlap_kinetic_nuclear(primary, mol)
    H = T + V
    sph_T = None
    if getattr(basis_sets, "spherical", False):
        from ..basis.spherical import cart_to_sph_basis
        from .scf import SphericalFockAdapter

        sph_T = cart_to_sph_basis(primary)
        S_cart = S
        H = sph_T.T @ H @ sph_T
        S = sph_T.T @ S @ sph_T
    X = linalg.orthogonalizer(S)

    use_df = opts.scf_type == C.SCFType.density_fitting
    builder = _make_jk_builder(basis_sets, opts, use_df, timings)
    if sph_T is not None:
        builder = SphericalFockAdapter(builder, sph_T)

    # --- initial guess -----------------------------------------------------
    Ca = Cb = None
    with timings.timed(JCTC.guess_time):
        if opts.guess == C.Guess.sad:
            from .guess import sad_guess

            Dt = sad_guess(mol, primary)       # factor-2 total density
            if sph_T is not None:
                Q = np.linalg.solve(S, sph_T.T @ S_cart)
                Dt = Q @ Dt @ Q.T
            Da = Db = 0.5 * Dt
        else:  # hcore
            _, Ca, Da = _spin_step(H, X, na)
            _, Cb, Db = _spin_step(H, X, nb)
        if guess_mix != 0.0:
            if Ca is None:
                _, Ca, _ = _spin_step(H, X, na)
                _, Cb, _ = _spin_step(H, X, nb)
            # rotate alpha HOMO into LUMO (and beta oppositely) to break
            # spin symmetry
            c, s = np.cos(guess_mix), np.sin(guess_mix)
            ch, cl = Ca[:, na - 1].copy(), Ca[:, na].copy()
            Ca[:, na - 1], Ca[:, na] = c * ch + s * cl, -s * ch + c * cl
            if nb > 0:
                bh, bl = Cb[:, nb - 1].copy(), Cb[:, nb].copy()
                Cb[:, nb - 1], Cb[:, nb] = c * bh - s * bl, s * bh + c * bl
            Da = Ca[:, :na] @ Ca[:, :na].T
            Db = Cb[:, :nb] @ Cb[:, :nb].T

    diis = linalg.DIIS(max_vec=opts.ndiis)
    E_old = 0.0
    Da_old, Db_old = Da.copy(), Db.copy()
    Fa_old = Fb_old = None
    last_dE = 1.0e9
    converged = False
    it = 0
    eps_a = eps_b = None
    Fa = Fb = None

    if output >= 2:
        print(f"{'iter':>4s} {'E total':>20s} {'dE':>12s} {'D rms':>12s} "
              f"{'t (s)':>8s}")

    for it in range(1, opts.max_iterations + 1):
        t_it = time.perf_counter()
        with timings.timed(JCTC.fock_time, it):
            J, Ka, Kb = builder.two_electron_jk(
                Da, Db, it, timings,
                Ca[:, :na] if Ca is not None else None,
                Cb[:, :nb] if Cb is not None else None)
        Fa = H + J - Ka
        Fb = H + J - Kb

        with timings.timed(JCTC.diis_time, it):
            ea = Fa @ Da @ S - S @ Da @ Fa
            eb = Fb @ Db @ S - S @ Db @ Fb
            e_max = max(float(np.abs(ea).max()), float(np.abs(eb).max()))
            if e_max < 10.0:
                diis.push(np.stack([Fa, Fb]), np.stack([ea, eb]))
            if diis.size > 0:
                Fab = diis.extrapolate()
                Fa_x, Fb_x = Fab[0], Fab[1]
            else:
                Fa_x, Fb_x = Fa, Fb

        if opts.damp and Fa_old is not None:
            x = linalg.damping_factor(last_dE)
            if x < 1.0:
                Fa_x = x * Fa_x + (1.0 - x) * Fa_old
                Fb_x = x * Fb_x + (1.0 - x) * Fb_old
        Fa_old, Fb_old = Fa, Fb

        with timings.timed(JCTC.eigensolve_time, it):
            eps_a, Ca, Da = _spin_step(Fa_x, X, na)
            eps_b, Cb, Db = _spin_step(Fb_x, X, nb)

        E_elec = 0.5 * float(
            np.sum((Da + Db) * H) + np.sum(Da * Fa) + np.sum(Db * Fb))
        if not np.isfinite(E_elec) or abs(E_elec) > 1.0e8:
            E_old = E_elec
            break  # NaN/garbage never recovers; report a convergence error
        dE = E_elec - E_old
        last_dE = dE
        d_rms = float(np.sqrt(0.5 * (np.mean((Da - Da_old) ** 2)
                                     + np.mean((Db - Db_old) ** 2))))
        E_old = E_elec
        Da_old, Db_old = Da.copy(), Db.copy()

        t_el = time.perf_counter() - t_it
        timings.record(JCTC.iteration_time, t_el, it)
        dev_b = _device_bytes_in_use()
        if dev_b is not None:
            timings.record(JCTC.device_memory_bytes, float(dev_b), it)
        if output >= 2:
            print(f"{it:4d} {E_elec + e_nuc:20.10f} {dE:12.3e} "
                  f"{d_rms:12.3e} {t_el:8.2f}")

        if abs(dE) <= opts.energy_convergence and \
                d_rms <= opts.density_convergence:
            converged = True
            break

    builder.finalize()
    E_total = E_old + e_nuc
    timings.set_converged(converged, E_total, it)
    timings.run_time = time.perf_counter() - t0
    timings.record(JCTC.run_time, timings.run_time)
    timings.scf_energy = E_total

    if output >= 1:
        tag = "" if converged else " (NOT CONVERGED)"
        print(f"Total UHF Energy: {E_total:.10f} h{tag}")

    error = None
    if not converged:
        error = {
            "error_type": "convergence_error",
            "error_message": (
                f"UHF did not converge in {it} iterations "
                f"(dele={opts.energy_convergence}, "
                f"rmsd={opts.density_convergence})"),
            "success": False,
        }

    s2 = s_squared(Ca, Cb, S, na, nb)
    Dt = Da + Db
    return {
        "Error": error,
        # factor-conventions match RHF consumers: "Density" traces to nels
        "Fock": 0.5 * (Fa + Fb),
        "Fock Alpha": Fa,
        "Fock Beta": Fb,
        "Density": Dt,
        "Spin Density": Da - Db,
        "MO Coeff": Ca,
        "MO Coeff Alpha": Ca,
        "MO Coeff Beta": Cb,
        "MO Energies": eps_a,
        "MO Energies Alpha": eps_a,
        "MO Energies Beta": eps_b,
        "Overlap": S,
        "Energy": E_total,
        "Energy Elec": E_old,
        "E Nuc": e_nuc,
        "S2": s2,
        "S2 Ideal": (0.5 * (na - nb)) * (0.5 * (na - nb) + 1.0),
        "Multiplicity": multiplicity,
        "N Alpha": na,
        "N Beta": nb,
        "Converged?": converged,
        "Iterations": it,
        "Timings": timings,
        "Spherical Transform": sph_T,
    }


def _make_jk_builder(basis_sets, opts, use_df: bool, timings):
    """Builders exposing two_electron_jk.  DF routes like the closed-shell
    dispatcher (rhf._make_fock_builder): dense fitted-B while it takes at
    most the "dense_df_b" share of device memory, else the packed screened path
    (df_screened_jk.ScreenedDFJKBuilder)."""
    if use_df:
        from .df import DFFockBuilder

        if basis_sets.auxiliary is None:
            raise ValueError(
                "density-fitted UHF requires an auxiliary basis "
                "(model['auxiliary_basis'])")
        if int(getattr(opts, "num_devices", 1) or 1) > 1:
            from .df_sharded_jk import ShardedDFJKBuilder

            return ShardedDFJKBuilder(
                basis_sets.primary, basis_sets.auxiliary, opts,
                timings=timings)
        nbf, A = basis_sets.primary.nbf, basis_sets.auxiliary.nbf
        mode = opts.contraction_mode
        use_screened = (
            mode == C.ContractionMode.screened
            or (mode == C.ContractionMode.default
                and not opts.df_force_dense
                and A * nbf * nbf * 8
                > memory.share_bytes("dense_df_b")))
        if use_screened:
            from .df_screened_jk import ScreenedDFJKBuilder

            return ScreenedDFJKBuilder(
                basis_sets.primary, basis_sets.auxiliary, opts,
                timings=timings)
        return DFFockBuilder(basis_sets.primary, basis_sets.auxiliary, opts,
                             timings=timings)
    from ..ops.fock import DenseFock, ScreenedDirectFock

    if opts.contraction_mode == C.ContractionMode.dense and \
            basis_sets.primary.nbf <= 160:
        return DenseFock(basis_sets.primary)
    return ScreenedDirectFock(basis_sets.primary)
