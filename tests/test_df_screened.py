"""Packed screened-pq DF builder: parity vs the dense-B builder.

The packed builder stores B as [A, npq+1] (ScreenedDF.jl:16-77 analog) and
expands per-Q tiles on the fly for exchange; dense stores [A, nbf, nbf] with
zeros outside the surviving pairs — the math is identical, so parity is
tight (float-ordering noise only)."""

import numpy as np
import pytest

from juliachem_jl_tpu import basis, molecule
from juliachem_jl_tpu.basis import CalculationBasisSets
from juliachem_jl_tpu.models import rhf
from juliachem_jl_tpu.models.df import DFFockBuilder
from juliachem_jl_tpu.models.df_screened import ScreenedDFFockBuilder
from juliachem_jl_tpu.utils.options import create_scf_options
from juliachem_jl_tpu.utils.timings import Timings

WATER = {
    "symbols": ["O", "H", "H"],
    "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                 0.0, -0.751155, -0.465285],
}


@pytest.fixture(scope="module")
def system():
    mol = molecule.from_input_dict(WATER)
    b = CalculationBasisSets(
        basis.build(mol, "6-31G"),
        basis.build_auxiliary(mol, "cc-pVDZ-JKFIT", "6-31G"),
    )
    return mol, b


def test_packed_fock_matches_dense(system):
    mol, b = system
    opts = create_scf_options({"scf_type": "df"})
    dense = DFFockBuilder(b.primary, b.auxiliary, opts, timings=Timings())
    packed = ScreenedDFFockBuilder(b.primary, b.auxiliary, opts,
                                   timings=Timings())
    assert packed.screen.npq <= b.primary.nbf ** 2
    rng = np.random.default_rng(0)
    nbf = b.primary.nbf
    nocc = b.primary.nels // 2
    C = rng.normal(size=(nbf, nocc))
    D = 2.0 * C @ C.T
    t = Timings()
    G_dense = dense.two_electron_fock(D, 1, t, C_occ=C)
    G_packed = packed.two_electron_fock(D, 1, t, C_occ=C)
    assert np.abs(G_dense - G_packed).max() < 1e-9


def test_packed_signed_indefinite(system):
    """Exchange of an indefinite dD must match the dense signed kernel."""
    mol, b = system
    opts = create_scf_options({"scf_type": "df"})
    dense = DFFockBuilder(b.primary, b.auxiliary, opts, timings=Timings())
    packed = ScreenedDFFockBuilder(b.primary, b.auxiliary, opts,
                                   timings=Timings())
    rng = np.random.default_rng(1)
    nbf = b.primary.nbf
    M = rng.normal(size=(nbf, nbf))
    dD = M + M.T  # indefinite
    t = Timings()
    G_dense = dense.two_electron_fock(dD, 1, t, C_occ=None)
    G_packed = packed.two_electron_fock(dD, 1, t, C_occ=None)
    assert np.abs(G_dense - G_packed).max() < 1e-8


def test_packed_scf_energy(system):
    mol, b = system
    flags = {"scf_type": "df", "niter": 60, "dele": 1e-9, "rmsd": 1e-7}
    e_dense = rhf.energy(mol, b, {**flags, "contraction_mode": "dense"})
    e_packed = rhf.energy(mol, b, {**flags, "contraction_mode": "screened"})
    assert e_dense["Converged?"] and e_packed["Converged?"]
    assert abs(e_dense["Energy"] - e_packed["Energy"]) < 1e-9
    # the packed path records the granular W/J/K telemetry
    tkeys = e_packed["Timings"].timings
    assert any(k.startswith("K_time-") for k in tkeys)
    assert any(k.startswith("V_time-") for k in tkeys)


def test_packed_qchunk_blocking(system):
    """df_exchange_n_blocks forces multi-block exchange; results unchanged."""
    mol, b = system
    opts = create_scf_options({"scf_type": "df", "df_exchange_n_blocks": 4})
    packed = ScreenedDFFockBuilder(b.primary, b.auxiliary, opts,
                                   timings=Timings())
    assert packed.q_chunk < packed.A
    opts1 = create_scf_options({"scf_type": "df"})
    one = ScreenedDFFockBuilder(b.primary, b.auxiliary, opts1,
                                timings=Timings())
    rng = np.random.default_rng(2)
    nbf = b.primary.nbf
    C = rng.normal(size=(nbf, 5))
    D = 2.0 * C @ C.T
    t = Timings()
    G4 = packed.two_electron_fock(D, 1, t, C_occ=C)
    G1 = one.two_electron_fock(D, 1, t, C_occ=C)
    assert np.abs(G4 - G1).max() < 1e-9


def test_blocked_lower_triangle_k(system):
    """k_blocks>1 (lower-triangular K column blocking) must be exact."""
    mol, b = system
    opts = create_scf_options({"scf_type": "df"})
    packed = ScreenedDFFockBuilder(b.primary, b.auxiliary, opts,
                                   timings=Timings())
    rng = np.random.default_rng(3)
    nbf = b.primary.nbf
    C = rng.normal(size=(nbf, 5))
    D = 2.0 * C @ C.T
    t = Timings()
    G1 = packed.two_electron_fock(D, 1, t, C_occ=C)
    packed.k_blocks = 3  # force the large-nbf path on a small system
    G3 = packed.two_electron_fock(D, 1, t, C_occ=C)
    assert np.abs(G3 - G1).max() < 1e-10
    # signed (indefinite) variant through the blocked path too
    M = rng.normal(size=(nbf, nbf))
    dD = M + M.T
    packed.k_blocks = 1
    S1 = packed.two_electron_fock(dD, 1, t, C_occ=None)
    packed.k_blocks = 3
    S3 = packed.two_electron_fock(dD, 1, t, C_occ=None)
    assert np.abs(S3 - S1).max() < 1e-8


def test_device_3c_path_matches_host(monkeypatch):
    """The jitted device 3-center path (round-4 host-scatter redesign:
    device compute blocks, immediate d2h, numpy scatter) must reproduce the
    zero-compile host-numpy path in both dense and packed modes.  Uses H2
    so the CPU-backend kernel compiles stay cheap; covers tail padding
    (n < csize, nq < NQ_CHUNK) and the shell-pair mirror."""
    from juliachem_jl_tpu.models.df import screened_pair_blocks
    from juliachem_jl_tpu.models.df_screened import build_packed_screen
    from juliachem_jl_tpu.ops import eri3c

    mol = molecule.from_input_dict({
        "symbols": ["H", "H"], "geometry": [0.0, 0.0, 0.0, 0.0, 0.0, 0.74]})
    b = CalculationBasisSets(
        basis.build(mol, "6-31G"),
        basis.build_auxiliary(mol, "cc-pVDZ-JKFIT", "6-31G"),
    )
    B_host = eri3c.three_center_tensor(b.primary, b.auxiliary)
    monkeypatch.setenv("JCHEM_FORCE_DEVICE_3C", "1")
    B_dev = eri3c.three_center_tensor(b.primary, b.auxiliary)
    assert B_dev.shape == B_host.shape
    assert np.abs(B_dev - B_host).max() < 1e-11

    pair_blocks = screened_pair_blocks(b.primary, 1e-8, 1.0)
    screen = build_packed_screen(b.primary, pair_blocks)
    monkeypatch.delenv("JCHEM_FORCE_DEVICE_3C")
    P_host = eri3c.three_center_tensor(
        b.primary, b.auxiliary, pair_blocks, col_map=screen.col_map,
        packed_width=screen.npq + 1)
    monkeypatch.setenv("JCHEM_FORCE_DEVICE_3C", "1")
    P_dev = eri3c.three_center_tensor(
        b.primary, b.auxiliary, pair_blocks, col_map=screen.col_map,
        packed_width=screen.npq + 1)
    assert np.abs(P_dev - P_host).max() < 1e-11
    assert np.all(P_dev[:, -1] == 0.0)  # trash column stays zeroed


def _tiny_device(monkeypatch):
    """Pretend the device holds 20 kB, so B is streamed from host RAM."""
    from juliachem_jl_tpu.utils import memory

    monkeypatch.setattr(memory, "device_memory_bytes", lambda: 20_000)


def test_stream_mode_f32_phase(system, monkeypatch):
    """Stream mode without a resident B32 still supports the f32 phase by
    casting host blocks per call."""
    mol, b = system
    _tiny_device(monkeypatch)
    opts = create_scf_options({"scf_type": "df", "mixed_precision": True})
    packed = ScreenedDFFockBuilder(b.primary, b.auxiliary, opts,
                                   timings=Timings())
    assert packed.stream and packed.B32 is None
    assert packed.supports_f32_phase
    rng = np.random.default_rng(4)
    nbf = b.primary.nbf
    C = rng.normal(size=(nbf, 5))
    D = 2.0 * C @ C.T
    t = Timings()
    G64 = packed.two_electron_fock(D, 1, t, C_occ=C, precision="f64")
    G32 = packed.two_electron_fock(D, 1, t, C_occ=C, precision="f32")
    assert G32.dtype == np.float32 or np.abs(G64 - G32).max() < 1e-3
    assert np.abs(G64 - np.asarray(G32, dtype=np.float64)).max() < 1e-2


def test_sharded_profile_fock_phases(system):
    """profile_fock=True must record per-iteration J/K timings and produce
    the same G as the fused sharded step."""
    from juliachem_jl_tpu.models.df_sharded import ShardedDFFockBuilder
    from juliachem_jl_tpu.utils.timings import JCTC

    mol, b = system
    rng = np.random.default_rng(11)
    nbf = b.primary.nbf
    C = rng.normal(size=(nbf, 5))
    D = 2.0 * C @ C.T

    fused = ShardedDFFockBuilder(
        b.primary, b.auxiliary,
        create_scf_options({"scf_type": "df", "num_devices": 8}),
        timings=Timings())
    t1 = Timings()
    G0 = fused.two_electron_fock(D, 1, t1, C_occ=C)

    prof = ShardedDFFockBuilder(
        b.primary, b.auxiliary,
        create_scf_options({"scf_type": "df", "num_devices": 8,
                            "profile_fock": True}),
        timings=Timings())
    t2 = Timings()
    G1 = prof.two_electron_fock(D, 1, t2, C_occ=C)
    assert np.abs(G1 - G0).max() < 1e-10
    assert f"{JCTC.J_time}-1" in t2.timings
    assert f"{JCTC.K_time}-1" in t2.timings


def test_huge_stream_scf_end_to_end(system, monkeypatch):
    """The past-device-memory route at toy scale: host-RAM B + stream mode
    without a resident B32 + the mixed-precision ladder, driven through the
    full SCF loop.  Must converge to the device-resident answer."""
    mol, b = system
    flags = {"scf_type": "df", "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
             "contraction_mode": "screened", "mixed_precision": True}
    e_ref = rhf.energy(mol, b, dict(flags))
    _tiny_device(monkeypatch)
    e_stream = rhf.energy(mol, b, dict(flags))
    assert e_stream["Timings"].non_timing_data["df_b_storage"] == \
        "host-streamed"
    assert e_ref["Converged?"] and e_stream["Converged?"]
    assert abs(e_ref["Energy"] - e_stream["Energy"]) < 1e-9


def test_fdiff_f32_incremental_scf(system):
    """f32 incremental-Fock ladder (fdiff_f32): increments build in f32 with
    periodic/terminal full-f64 resyncs; the converged energy must match the
    plain f64 path to the convergence tolerance, and f32-marked iterations
    must actually occur."""
    mol, b = system
    flags = {"scf_type": "df", "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
             "contraction_mode": "screened"}
    e_ref = rhf.energy(mol, b, dict(flags))
    e_inc = rhf.energy(mol, b, {**flags, "fdiff": True, "fdiff_f32": True,
                                "mixed_precision": True})
    assert e_ref["Converged?"] and e_inc["Converged?"]
    assert abs(e_ref["Energy"] - e_inc["Energy"]) < 1e-8
    tk = e_inc["Timings"].timings
    assert any(k.startswith("fock_f32-") for k in tk)


@pytest.mark.parametrize("when", ["dispatch", "pull"])
def test_device_3c_resource_exhausted_propagates(monkeypatch, when):
    """An out-of-memory error of a 3-center launch is not retried or
    swallowed: it surfaces from three_center_tensor, whether the launch
    fails when dispatched or when its block is pulled to the host."""
    from juliachem_jl_tpu.ops import eri3c

    mol = molecule.from_input_dict({
        "symbols": ["H", "H"], "geometry": [0.0, 0.0, 0.0, 0.0, 0.0, 0.74]})
    b = CalculationBasisSets(
        basis.build(mol, "6-31G"),
        basis.build_auxiliary(mol, "cc-pVDZ-JKFIT", "6-31G"),
    )
    msg = "RESOURCE_EXHAUSTED: injected test failure"

    class _Failed:
        def block_until_ready(self):
            raise MemoryError(msg)

    def failing_factory(*args, **kw):
        def kern(*a, **k):
            if when == "dispatch":
                raise MemoryError(msg)
            return _Failed()
        return kern

    monkeypatch.setattr(eri3c, "_threecenter_compute_kernel",
                        failing_factory)
    monkeypatch.setenv("JCHEM_FORCE_DEVICE_3C", "1")
    with pytest.raises(MemoryError, match="RESOURCE_EXHAUSTED"):
        eri3c.three_center_tensor(b.primary, b.auxiliary)
