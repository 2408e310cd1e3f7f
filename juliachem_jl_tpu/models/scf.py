"""SCF driver: the Roothaan-Hall / DIIS iteration loop.

Rebuild of the reference's rhf_kernel / scf_cycles_kernel
(src/rhf/energy/SCF.jl:69-592) with a pluggable Fock builder so the same
driver serves dense, screened-direct and density-fitted builds (and, like the
reference's df-guess mode, a DF warm-up phase followed by conventional
iterations — SCF.jl:527-550).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..utils import constants as C
from ..utils.options import SCFOptions, create_scf_options
from ..utils.timings import JCTC, Timings
from ..ops.oei import overlap_kinetic_nuclear
from . import linalg


@dataclass
class SCFState:
    """Carries everything the iteration loop mutates (analog of SCFData,
    src/shared/SCFData.jl:19-37)."""

    H: np.ndarray
    S: np.ndarray
    X: np.ndarray
    nocc: int
    F: np.ndarray = None
    D: np.ndarray = None
    C: np.ndarray = None
    eps: np.ndarray = None
    energy_elec: float = 0.0
    iteration: int = 0
    debug: object = None  # DebugDump or None
    stagnated: bool = False  # converged via the energy-stagnation exit
    deadline_hit: bool = False  # stopped early at opts.wall_deadline


class FockBuilder:
    """Interface: given the (factor-2) density D, return the two-electron part
    G[D] = J - 0.5 K so that F = H + G[D].  Builders that exploit the
    occupied MO factorization (DF) use C_occ when available."""

    def two_electron_fock(self, D: np.ndarray, iteration: int, timings: Timings,
                          C_occ=None):
        raise NotImplementedError

    def two_electron_jk(self, Da, Db, iteration: int, timings: Timings,
                        Ca=None, Cb=None):
        """Spin-resolved contractions for UHF (models/uhf.py): given factor-1
        spin densities, return (J(Da+Db), K(Da), K(Db))."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the spin-resolved "
            "J/K interface (UHF); use the dense, screened-direct or dense-DF "
            "builder")

    def finalize(self):  # release per-geometry tensors
        pass


class SphericalFockAdapter(FockBuilder):
    """Wrap any Cartesian Fock builder for a spherical-harmonic SCF:
    G_s(D_s) = T^T G_c(T D_s T^T) T with the geometry-independent
    block transform T (basis/spherical.py).  G is linear in D, so the
    wrapped builder's screening/DF machinery applies unchanged; the two
    projections are small dense matmuls XLA fuses into the build."""

    def __init__(self, inner: FockBuilder, T: np.ndarray):
        self.inner = inner
        self.T = np.asarray(T)
        self.supports_f32_phase = getattr(inner, "supports_f32_phase", False)

    def two_electron_fock(self, D, iteration, timings, C_occ=None, **kw):
        Dc = self.T @ D @ self.T.T
        Cc = self.T @ C_occ if C_occ is not None else None
        Fc = self.inner.two_electron_fock(Dc, iteration, timings, Cc, **kw)
        return self.T.T @ np.asarray(Fc) @ self.T

    def two_electron_jk(self, Da, Db, iteration, timings, Ca=None, Cb=None):
        T = self.T
        J, Ka, Kb = self.inner.two_electron_jk(
            T @ Da @ T.T, T @ Db @ T.T, iteration, timings,
            T @ Ca if Ca is not None else None,
            T @ Cb if Cb is not None else None)
        return (T.T @ np.asarray(J) @ T, T.T @ np.asarray(Ka) @ T,
                T.T @ np.asarray(Kb) @ T)

    def finalize(self):
        self.inner.finalize()


def _device_bytes_in_use():
    """Live device bytes on device 0, or None where the backend has no
    allocator stats (CPU)."""
    try:
        import jax

        stats = jax.devices()[0].memory_stats()
        return int(stats["bytes_in_use"]) if stats else None
    except Exception:
        return None


def electronic_energy(D, H, F) -> float:
    """E_elec = 1/2 sum D (H + F)  (reference SCF.jl:1110-1125 convention,
    D = 2 C_occ C_occ^T)."""
    return 0.5 * float(np.sum(D * (H + F)))


def scf_loop(
    state: SCFState,
    fock_builder: FockBuilder,
    opts: SCFOptions,
    timings: Timings,
    e_nuc: float,
    output: int = 0,
    max_iterations: int | None = None,
    energy_convergence: float | None = None,
    density_convergence: float | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    fingerprint: str = "",
):
    """Iterate to convergence; returns True if converged.

    Convergence test: |dE| <= dele and rms(dD) <= rmsd (SCF.jl:549).
    """
    dele = energy_convergence if energy_convergence is not None else opts.energy_convergence
    rmsd = density_convergence if density_convergence is not None else opts.density_convergence
    niter = max_iterations if max_iterations is not None else opts.max_iterations

    diis = linalg.DIIS(max_vec=opts.ndiis)
    E_old = state.energy_elec
    D_old = state.D.copy() if state.D is not None else None
    F_old = None
    last_dE = 1.0e9
    G_cumul = None
    D_fock_ref = None
    supports_f32 = getattr(fock_builder, "supports_f32_phase", False)
    fp32_phase = bool(opts.mixed_precision and supports_f32 and not opts.fdiff)
    # f32 incremental Fock (opts.fdiff_f32): increments F(dD) build in f32 —
    # their absolute error scales with ||F(dD)||, which vanishes with dD —
    # with a full-f64 resync every opts.fdiff_resync increments and a
    # mandatory resync before any convergence declaration (the test only
    # ever accepts an untainted Fock, mirroring the f32-phase rule below)
    fdiff32 = bool(getattr(opts, "fdiff_f32", False) and opts.fdiff
                   and opts.mixed_precision and supports_f32)
    inc_since_sync = 0
    force_resync = False
    last_drms = 1.0e9
    converged = False
    # Energy-stagnation exit: should a Fock build carry a small
    # deterministic noise floor, the density step d_rms limit-cycles above
    # rmsd while the energy is pinned within a window far tighter than any
    # physical tolerance (error from a density residual r is O(r^2)).  When
    # the energy spread over the last `stall_window`+1 f64 iterations is
    # <= 100*dele AND d_rms has stopped improving AND we are inside the
    # convergence basin, declare convergence and mark it (state.stagnated).
    # With an exact f64 build d_rms keeps shrinking geometrically under
    # DIIS, so this should never fire before the plain test; callers that
    # need the plain test check state.stagnated.  The basin gate scales with
    # the requested rmsd but never loosens past 1e-4, so a system that
    # limit-cycles above it runs its budget out and reports
    # non-convergence.
    stag_gate = max(1.0e-4, 10.0 * rmsd)
    from collections import deque

    stall_window = 3
    e_window: deque = deque(maxlen=stall_window + 1)
    stall_count = 0
    best_drms = 1.0e9

    if output >= 2:
        print(f"{'iter':>4s} {'E total':>20s} {'dE':>12s} {'D rms':>12s} {'t (s)':>8s}")

    t_last_iter = 0.0
    for it in range(1, niter + 1):
        # budgeted-run deadline: stop BEFORE an iteration that (by the last
        # iteration's wall) cannot finish in time, so the caller gets clean
        # partial per-iteration timings instead of a mid-iteration SIGKILL
        if (getattr(opts, "wall_deadline", 0.0) > 0.0 and it > 1
                and time.time() + 1.3 * t_last_iter > opts.wall_deadline):
            state.deadline_hit = True
            import sys

            print(f"# scf: stopping before iter {it} — wall deadline "
                  f"({opts.wall_deadline - time.time():.0f}s left < "
                  f"1.3x last iter {t_last_iter:.1f}s)", file=sys.stderr,
                  flush=True)
            break
        t_it = time.perf_counter()
        state.iteration = it

        C_occ = state.C[:, : state.nocc] if state.C is not None else None
        # mixed-precision phase control: leave f32 once the density step is
        # small (scale-free criterion), or after half the iteration budget
        # (and never converge from an f32 iteration)
        if fp32_phase and (last_drms < opts.mixed_precision_switch
                           or it > niter // 2):
            fp32_phase = False
        precision = "f32" if fp32_phase else "f64"
        if fp32_phase:
            # marker so consumers (bench.py) can split per-iteration Fock
            # times by precision phase instead of reporting a blended mean
            timings.record("fock_f32", 1.0, it)
        resync = fdiff32 and (force_resync
                              or inc_since_sync >= max(opts.fdiff_resync, 1))
        with timings.timed(JCTC.fock_time, it):
            if opts.fdiff and G_cumul is not None and not resync:
                # incremental Fock: build with dD, accumulate (SCF.jl:421-431)
                dD = state.D - D_fock_ref
                kwargs = ({"precision": "f32"}
                          if fdiff32 and supports_f32 else {})
                if fdiff32:
                    timings.record("fock_f32", 1.0, it)
                    inc_since_sync += 1
                G_cumul = G_cumul + np.asarray(
                    fock_builder.two_electron_fock(dD, it, timings, None,
                                                   **kwargs))
                D_fock_ref = state.D.copy()
                G = G_cumul
            else:
                kwargs = {"precision": precision} if supports_f32 else {}
                G = np.asarray(
                    fock_builder.two_electron_fock(state.D, it, timings, C_occ,
                                                   **kwargs))
                if opts.fdiff:
                    G_cumul = G
                    D_fock_ref = state.D.copy()
                inc_since_sync = 0
                force_resync = False
        F = state.H + np.asarray(G)

        # DIIS on e = F D S - S D F.  Deliberate deviation from the
        # reference (SCF.jl:472-501 pushes every iterate): wild early Fock
        # matrices (hcore guess on clusters) are kept out of the subspace
        # until the commutator is moderate.  Converged energies are
        # unaffected (same fixed point); iteration traces can differ from
        # the reference's in the first few cycles.
        with timings.timed(JCTC.diis_time, it):
            e_vec = F @ state.D @ state.S - state.S @ state.D @ F
            e_max = float(np.abs(e_vec).max())
            if e_max < 10.0:
                diis.push(F, e_vec)
            F_diis = diis.extrapolate() if diis.size > 0 else F

        # dynamic damping for early iterations (SCF.jl:504-505)
        if opts.damp and F_old is not None:
            x = linalg.damping_factor(last_dE)
            if x < 1.0:
                F_diis = x * F_diis + (1.0 - x) * F_old
        F_old = F

        # virtual level shift: add shift * (S - S D S / 2) — the S-metric
        # virtual projector — to the Fock used for the Roothaan step only.
        # The DIIS error vector and E_elec use the UNSHIFTED F, so the
        # converged energy is the unshifted fixed point.  Released once the
        # density step is inside the basin (d_rms < 1e-4) to let DIIS close
        # the last digits unimpeded.
        if getattr(opts, "level_shift", 0.0) > 0.0 and last_drms > 1.0e-4:
            SDS = state.S @ (0.5 * state.D) @ state.S
            F_diis = F_diis + opts.level_shift * (state.S - SDS)

        with timings.timed(JCTC.eigensolve_time, it):
            eps, Cmo, D = linalg.roothaan_step(F_diis, state.X, state.nocc)
            eps, Cmo, D = np.asarray(eps), np.asarray(Cmo), np.asarray(D)

        E_elec = electronic_energy(D, state.H, F)
        if not np.isfinite(E_elec) or abs(E_elec) > 1.0e8:
            # a NaN/inf energy never recovers (it poisons DIIS and the
            # density); stop immediately so the caller reports a clean
            # convergence error instead of burning the iteration budget.
            # The magnitude bound catches finite garbage too: |E_elec| of
            # any system runnable here is <1e6 Eh.
            state.F, state.D, state.C, state.eps = F, D, Cmo, eps
            state.energy_elec = E_elec
            return False
        dE = E_elec - E_old
        last_dE = dE
        d_rms = float(np.sqrt(np.mean((D - D_old) ** 2))) if D_old is not None else 1.0
        last_drms = d_rms

        state.F, state.D, state.C, state.eps = F, D, Cmo, eps
        state.energy_elec = E_elec
        E_old, D_old = E_elec, D.copy()

        if state.debug is not None:
            state.debug.write("fock", F, it)
            state.debug.write("density", D, it)
            state.debug.write("coefficients", Cmo, it)
            state.debug.write("energy", E_elec, it)

        t_el = time.perf_counter() - t_it
        t_last_iter = t_el
        timings.record(JCTC.iteration_time, t_el, it)
        # memory telemetry each iteration (the reference logs
        # Base.summarysize(scf_data) — DensityFitting.jl:226-228): host-side
        # SCF state bytes plus live device memory when the backend reports it
        host_b = sum(int(a.nbytes) for a in (state.H, state.S, state.X,
                                             state.F, state.D, state.C)
                     if a is not None)
        timings.record(JCTC.scf_data_bytes, float(host_b), it)
        dev_b = _device_bytes_in_use()
        if dev_b is not None:
            timings.record(JCTC.device_memory_bytes, float(dev_b), it)
        if output >= 2:
            mem = f" {host_b / 1e6:7.1f}MB" + (
                f" dev {dev_b / 1e9:6.2f}GB" if dev_b is not None else "")
            print(f"{it:4d} {E_elec + e_nuc:20.10f} {dE:12.3e} {d_rms:12.3e} "
                  f"{t_el:8.2f}{mem}")
        elif t_el > 30.0:
            # slow-iteration progress line (stderr), silent on quick runs
            import sys

            print(f"# scf iter {it} E={E_elec + e_nuc:.8f} dE={dE:.2e} "
                  f"rms={d_rms:.2e} t={t_el:.0f}s", file=sys.stderr,
                  flush=True)

        if checkpoint_path and (it % checkpoint_every == 0):
            save_checkpoint(state, checkpoint_path, e_nuc, fingerprint)

        if abs(dE) <= dele and d_rms <= rmsd:
            if fp32_phase:
                # never declare convergence off an f32 Fock: drop to f64 and
                # keep iterating
                fp32_phase = False
            elif fdiff32 and inc_since_sync > 0:
                # current Fock is built from f32 increments: rebuild full
                # f64 next iteration and only accept the test on that
                force_resync = True
            else:
                converged = True
                break

        if fp32_phase or (fdiff32 and inc_since_sync > 0):
            e_window.clear()
            stall_count = 0
        else:
            e_window.append(E_elec)
            spread = max(e_window) - min(e_window)
            if (len(e_window) == e_window.maxlen and spread <= 100.0 * dele
                    and d_rms <= stag_gate and d_rms >= 0.5 * best_drms):
                stall_count += 1
                if stall_count >= stall_window:
                    converged = True
                    state.stagnated = True
                    if output >= 2:
                        print(f"  converged via energy-stagnation exit "
                              f"(E spread {spread:.1e} over last "
                              f"{len(e_window)} iters; d_rms floor "
                              f"{d_rms:.2e} > rmsd {rmsd:.1e})")
                    break
            else:
                stall_count = 0
        best_drms = min(best_drms, d_rms)

    if checkpoint_path:
        save_checkpoint(state, checkpoint_path, e_nuc, fingerprint)
    return converged


def system_fingerprint(mol, basis) -> str:
    """Hash of geometry + basis identity for checkpoint consistency checks."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mol.coords, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(mol.z, dtype=np.int64).tobytes())
    name = getattr(basis, "name", "")
    h.update(f"{name}|{basis.nbf}|{basis.nels}".encode())
    return h.hexdigest()


def save_checkpoint(state: SCFState, path: str, e_nuc: float,
                    fingerprint: str = "") -> None:
    """Persist restartable SCF state (a capability the reference lacks —
    its 'Restart data is being output' banner writes nothing, SCF.jl:205-207)."""
    np.savez_compressed(
        path, H=state.H, S=state.S, X=state.X, F=state.F, D=state.D,
        C=state.C, eps=state.eps, nocc=state.nocc,
        energy_elec=state.energy_elec, iteration=state.iteration, e_nuc=e_nuc,
        fingerprint=np.bytes_(fingerprint.encode()),
    )


def load_checkpoint(path: str, expect_fingerprint: str | None = None,
                    expect_e_nuc: float | None = None) -> SCFState:
    z = np.load(path)
    if expect_fingerprint is not None and "fingerprint" in z:
        stored = bytes(z["fingerprint"]).decode()
        if stored and stored != expect_fingerprint:
            raise ValueError(
                f"checkpoint {path!r} was written for a different "
                f"molecule/basis (fingerprint mismatch); refusing to restart"
            )
    if expect_e_nuc is not None:
        if abs(float(z["e_nuc"]) - expect_e_nuc) > 1e-8:
            raise ValueError(
                f"checkpoint {path!r} nuclear repulsion "
                f"{float(z['e_nuc'])!r} != current {expect_e_nuc!r}; "
                f"geometry changed — refusing to restart"
            )
    state = SCFState(
        H=z["H"], S=z["S"], X=z["X"], nocc=int(z["nocc"]),
        F=z["F"], D=z["D"], C=z["C"], eps=z["eps"],
        energy_elec=float(z["energy_elec"]), iteration=int(z["iteration"]),
    )
    return state


def energy_weighted_density(state: SCFState) -> np.ndarray:
    """W = 2 sum_occ eps_i C_i C_i^T (reference SCF.jl:577-586)."""
    Cocc = state.C[:, : state.nocc]
    return 2.0 * (Cocc * state.eps[: state.nocc][None, :]) @ Cocc.T


def initial_state(mol, basis, opts: SCFOptions, timings: Timings, output: int = 0,
                  sph_T: np.ndarray | None = None) -> SCFState:
    """Hamiltonian core pieces + orthogonalizer + guess density.

    sph_T (optional [nbf_cart, nbf_sph], basis/spherical.py) switches the
    SCF to the real-solid-harmonic basis: the Cartesian one-electron
    matrices are built as usual and projected once — the integral engine
    never changes."""
    if basis.nbf > 1000:  # phase heartbeat for watchdogged big runs
        import sys

        print(f"# initial_state: building S/T/V (nbf={basis.nbf})",
              file=sys.stderr, flush=True)
    with timings.timed(JCTC.H_time):
        S = T = V = None
        oei_cache = getattr(opts, "oei_cache", "") or ""
        fp = system_fingerprint(mol, basis) if oei_cache else ""
        if oei_cache:
            try:
                z = np.load(oei_cache + "_oei.npz")
                if str(z["fingerprint"]) == fp \
                        and z["S"].shape == (basis.nbf, basis.nbf):
                    S, T, V = z["S"], z["T"], z["V"]
                    import sys

                    print(f"# initial_state: loaded cached S/T/V from "
                          f"{oei_cache}_oei.npz", file=sys.stderr, flush=True)
            except Exception:
                S = None
        if S is None:
            S, T, V = overlap_kinetic_nuclear(basis, mol)
            if oei_cache:
                try:
                    np.savez(oei_cache + "_oei.npz", S=S, T=T, V=V,
                             fingerprint=fp)
                except OSError:
                    pass
    H = T + V
    S_cart = S
    if sph_T is not None:
        H = sph_T.T @ H @ sph_T
        S = sph_T.T @ S @ sph_T
    X = linalg.orthogonalizer(S)
    debug = None
    if opts.debug:
        from ..utils.debug_dump import DebugDump

        debug = DebugDump(enabled=True)
        for key, val in (("overlap", S), ("kinetic", T), ("nuc_attr", V),
                         ("core_hamiltonian", H), ("ortho", X)):
            debug.write(key, val)
    nocc = basis.nels // 2
    if basis.nels % 2 != 0:
        raise ValueError(
            f"RHF requires an even number of electrons (got {basis.nels})"
        )
    state = SCFState(H=H, S=S, X=X, nocc=nocc, debug=debug)

    with timings.timed(JCTC.guess_time):
        if opts.guess == C.Guess.sad:
            from .guess import sad_guess

            D = sad_guess(mol, basis)
            if sph_T is not None:
                # metric projection of the Cartesian SAD density onto the
                # spherical span: D_s = Q D_c Q^T, Q = S_s^-1 T^T S_c.
                # Only a guess — trace/idempotency need not be exact.
                Q = np.linalg.solve(S, sph_T.T @ S_cart)
                D = Q @ D @ Q.T
            state.D = D
            state.F = None
        else:  # hcore guess (F = H): SCF.jl:107-117
            eps, Cmo, D = linalg.roothaan_step(H, X, nocc)
            state.eps, state.C, state.D = np.asarray(eps), np.asarray(Cmo), np.asarray(D)
            state.F = H.copy()
            state.energy_elec = electronic_energy(state.D, H, H)
    return state
