"""SCF driver tests: dense vs screened Fock parity, golden water energies,
DF-RHF parity, rotation invariance."""

import numpy as np
import pytest

from juliachem_jl_tpu import basis, molecule
from juliachem_jl_tpu.basis import CalculationBasisSets
from juliachem_jl_tpu.models import rhf

WATER = {
    "symbols": ["O", "H", "H"],
    "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285, 0.0, -0.751155, -0.465285],
}
TIGHT = {"niter": 60, "dele": 1e-9, "rmsd": 1e-7}


def _energy(mol, bname, aux=None, **flags):
    b = CalculationBasisSets(
        basis.build(mol, bname),
        basis.build_auxiliary(mol, aux, bname) if aux else None,
    )
    return rhf.energy(mol, b, {**TIGHT, **flags})


def test_water_sto3g_golden():
    mol = molecule.from_input_dict(WATER)
    res = _energy(mol, "STO-3G", contraction_mode="dense")
    assert res["Converged?"]
    # survey-cited window for water/STO-3G (SURVEY.md §7 step 4)
    assert abs(res["Energy"] - (-74.9617539687)) < 1e-8


def test_water_631g_dense_vs_screened():
    mol = molecule.from_input_dict(WATER)
    e_dense = _energy(mol, "6-31G", contraction_mode="dense")["Energy"]
    e_scr = _energy(mol, "6-31G", contraction_mode="screened")["Energy"]
    assert abs(e_dense - (-75.9839720312)) < 1e-8
    assert abs(e_dense - e_scr) < 1e-10


def test_water_ccpvdz_df_parity():
    mol = molecule.from_input_dict(WATER)
    e_conv = _energy(mol, "cc-pVDZ")["Energy"]
    # cc-pVDZ-JKFIT (as shipped in the reference's bsed.h5) is aux-limited to
    # ~1e-3; the reference CI bound is 1.5e-3 (test/runtests.jl:63)
    e_df_dz = _energy(mol, "cc-pVDZ", aux="cc-pVDZ-JKFIT", scf_type="df")["Energy"]
    assert abs(e_df_dz - e_conv) < 1.5e-3
    # cc-pVTZ-JKFIT resolves the fit: ~1e-5 (measured 1.25e-5)
    e_df_tz = _energy(mol, "cc-pVDZ", aux="cc-pVTZ-JKFIT", scf_type="df")["Energy"]
    assert abs(e_df_tz - e_conv) < 1e-4


def test_stagnation_exit_on_noisy_backend():
    # A Fock build with a deterministic noise floor makes d_rms limit-cycle
    # while the energy is pinned.  The driver must exit converged
    # (state.stagnated set) instead of burning the iteration budget.
    from juliachem_jl_tpu.models import scf as scf_mod
    from juliachem_jl_tpu.ops.fock import DenseFock
    from juliachem_jl_tpu.utils.options import create_scf_options
    from juliachem_jl_tpu.utils.timings import Timings

    mol = molecule.from_input_dict(WATER)
    b = basis.build(mol, "6-31G")

    class NoisyFock(DenseFock):
        def two_electron_fock(self, D, iteration, timings, C_occ=None, **kw):
            G = np.asarray(
                super().two_electron_fock(D, iteration, timings, C_occ, **kw))
            rng = np.random.default_rng(iteration)  # deterministic per iter
            n = 1e-9 * rng.standard_normal(G.shape)
            return G + (n + n.T) / 2

    opts = create_scf_options({"niter": 60, "dele": 1e-9, "rmsd": 1e-12})
    timings = Timings()
    state = scf_mod.initial_state(mol, b, opts, timings)
    conv = scf_mod.scf_loop(
        state, NoisyFock(b), opts, timings, mol.nuclear_repulsion())
    assert conv and state.stagnated
    assert state.iteration < 40  # did not burn the budget
    e_clean = _energy(mol, "6-31G", contraction_mode="dense")["Energy"]
    assert abs(state.energy_elec + mol.nuclear_repulsion() - e_clean) < 1e-6
    # and a clean backend must converge the normal way, never stagnated
    res = _energy(mol, "6-31G", contraction_mode="dense")
    assert res["Converged?"] and not res["Stagnated"]


def test_rotation_invariance_d_shells():
    # energies are invariant under rigid rotation; exercises every Cartesian
    # component mixing in the d shells
    mol1 = molecule.from_input_dict(WATER)
    geom = np.asarray(WATER["geometry"]).reshape(-1, 3)
    th = 0.7
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]])
    geom2 = (geom @ Rz.T) @ Rx.T
    mol2 = molecule.from_input_dict({**WATER, "geometry": geom2.ravel().tolist()})
    e1 = _energy(mol1, "6-31G*")["Energy"]
    e2 = _energy(mol2, "6-31G*")["Energy"]
    assert abs(e1 - e2) < 1e-9
