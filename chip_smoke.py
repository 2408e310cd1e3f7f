"""Run RHF and DF-RHF end to end on the GPU and check every energy.

Each phase builds one S22x3 complex from tests/data/s22x3_gamess_goldens.json
at RHF/6-311++G(2d,2p) (full basis width) and drives the user path:
jc.initialize() -> io.parse_input -> jc.run_spec (energy, then properties)
-> jc.finalize().

  1  card: platform, device kind, name and power limit (exits on a non-GPU)
  2  conventional, class-batched (ScreenedDirectFock): ammonia_trimer vs GAMESS
  3  conventional, streaming (StreamingDirectFock, forced through
     JCHEM_CONV_STREAM=1): ammonia_trimer vs GAMESS
  4  DF-RHF (cc-pVTZ-JKFIT) on benzene_water_2 vs GAMESS
  5  DF-RHF on indole_benzene_2_stacked vs GAMESS, B resident on the card

The streaming builder evaluates every ERI on every iteration; on
benzene_water_2, the smallest S22x3 system past its automatic threshold, it
takes ~49 s per iteration on an H100 (700 W), too long for one smoke run,
so phase 3 forces it on ammonia_trimer.  The DF phases are compared with
the GAMESS golden, a conventional RHF energy at the same basis.

Each phase prints one JSON line; the last line of a passing run is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.

Usage:
  python chip_smoke.py                 # phases 1-5 on one card
  python chip_smoke.py --phases 2,4    # a subset (phase 1 always runs)
  python chip_smoke.py --four-cards    # sharded DF and conventional paths
                                       # on four cards, against one card
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "data", "s22x3_gamess_goldens.json")
BOHR_TO_ANGSTROM = 0.52917724924
FLAGS = {"niter": 60, "dele": 1e-9, "rmsd": 1e-7, "guess": "sad"}
AUX = "cc-pVTZ-JKFIT"
CONV_RTOL = 1.49e-8      # reference CI gate against GAMESS (relative)
DF_ATOL = 1.5e-3         # DF against conventional or GAMESS (Eh)
SHARD_ATOL = 1e-9        # sharded against one card (Eh)

# phase -> (system, auxiliary basis, expected Fock builder)
PHASES = {
    2: ("ammonia_trimer", None, ("ScreenedDirectFock",)),
    3: ("ammonia_trimer", None, ("StreamingDirectFock",)),
    4: ("benzene_water_2", AUX, ("DFFockBuilder", "ScreenedDFFockBuilder")),
    5: ("indole_benzene_2_stacked", AUX, ("ScreenedDFFockBuilder",)),
}

_compile_s = [0.0]


def _on_duration(event: str, duration: float, **_kw) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


def card_check(want_count: int):
    """Phase 1: refuse anything but GPUs, print what the card reports."""
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    if len(devs) < want_count:
        print(f"need {want_count} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(json.dumps({"phase": 1, "platform": dev.platform,
                      "device_kind": dev.device_kind, "count": len(devs)}))
    for line in smi.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}")
    return devs


def molecule_input(system: str) -> tuple[dict, dict]:
    with open(GOLDENS) as f:
        golden = json.load(f)[system]
    symbols, geometry = [], []
    for atom in golden["atoms"]:
        symbols.append(atom["symbol"])
        geometry.extend(x * BOHR_TO_ANGSTROM for x in atom["xyz_bohr"])
    mol = {"symbols": symbols, "geometry": geometry, "molecular_charge": 0}
    return mol, golden


@contextlib.contextmanager
def _streaming(on: bool):
    """Force the streaming conventional builder (models/rhf.py)."""
    old = os.environ.get("JCHEM_CONV_STREAM")
    if on:
        os.environ["JCHEM_CONV_STREAM"] = "1"
    try:
        yield
    finally:
        if on:
            if old is None:
                del os.environ["JCHEM_CONV_STREAM"]
            else:
                os.environ["JCHEM_CONV_STREAM"] = old


def _peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {})
               .get("peak_bytes_in_use", -1))


def _fock_split(timings) -> tuple[float, float]:
    """(first-iteration Fock seconds, median Fock seconds of the f64
    iterations after it)."""
    t = timings.timings
    its = sorted(int(k.split("-")[1]) for k in t
                 if k.startswith("fock_time-"))
    steady = [t[f"fock_time-{i}"] for i in its[1:]
              if f"fock_f32-{i}" not in t]
    return t["fock_time-1"], (statistics.median(steady) if steady
                              else float("nan"))


def run_phase(phase: int) -> dict:
    import juliachem_jl_tpu as jc
    from juliachem_jl_tpu.utils import memory

    system, aux, builders = PHASES[phase]
    mol, golden = molecule_input(system)
    model = {"method": "RHF", "basis": golden["basis"]}
    if aux:
        model["auxiliary_basis"] = aux
    c0, t0 = _compile_s[0], time.perf_counter()
    jc.initialize()
    spec = jc.io.parse_input({
        "molecule": mol, "driver": "energy", "model": model,
        "keywords": {"scf": dict(FLAGS),
                     "prop": {"mo energies": True, "mulliken": True,
                              "multipole": "dipole"}},
    })
    with _streaming(phase == 3):
        out = jc.run_spec(spec)
    jc.finalize()
    wall = time.perf_counter() - t0
    res = out["Energy"]
    tm = res["Timings"]
    info = tm.non_timing_data
    builder = info["fock_builder"]
    energy = float(res["Energy"])
    ref_e = golden["energy"]
    gate = DF_ATOL if aux else CONV_RTOL * abs(ref_e)
    iter_s = sum(v for k, v in tm.timings.items()
                 if k.startswith("iteration_time-"))
    fock_first, fock_steady = _fock_split(tm)
    line = {
        "phase": phase, "system": system, "builder": builder,
        "b_storage": info.get("df_b_storage"),
        "nbf": int(info["n_basis_functions"]),
        "naux": int(info.get("n_auxiliary_basis_functions", 0)),
        "energy": energy, "ref_energy": ref_e,
        "error": energy - ref_e, "gate": gate,
        "iterations": int(res["Iterations"]),
        "converged": bool(res["Converged?"]),
        "stagnated": bool(res["Stagnated"]),
        "wall_s": wall, "setup_s": tm.run_time - iter_s,
        "first_iter_s": tm.timings["iteration_time-1"],
        "fock_first_s": fock_first, "fock_steady_s": fock_steady,
        "compile_s": _compile_s[0] - c0,
        "three_center_s": tm.timings.get("three_center_integrals_time"),
        "three_center_d2h_s": tm.timings.get("three_center_d2h_time"),
        "three_center_scatter_s": tm.timings.get("three_center_scatter_time"),
        "fold_s": tm.timings.get("B_time"),
        "peak_device_bytes": _peak_bytes(),
        "bytes_limit": memory.device_memory_bytes(),
        "dipole_debye": float(out["Properties"]["Dipole"]["moment"]),
        "homo_lumo": float(out["Properties"]["MO Energies"]["homo_lumo"]),
    }
    print(json.dumps(line, default=float), flush=True)
    if builder not in builders:
        raise AssertionError(f"phase {phase}: builder {builder}, "
                             f"expected one of {builders}")
    if not line["converged"] or line["stagnated"]:
        raise AssertionError(f"phase {phase}: converged={line['converged']}"
                             f" stagnated={line['stagnated']}")
    if abs(line["error"]) > gate:
        raise AssertionError(f"phase {phase}: |E - E_GAMESS| = "
                             f"{abs(line['error']):.3e} > {gate:.3e}")
    if phase == 5 and line["b_storage"] != "device":
        raise AssertionError(f"phase 5: B is {line['b_storage']}, "
                             "expected resident on the card")
    return line


def _energy(system: str, aux: str | None, flags: dict) -> dict:
    from juliachem_jl_tpu import basis, io, molecule
    from juliachem_jl_tpu.models import rhf

    mol_in, golden = molecule_input(system)
    model = {"method": "RHF", "basis": golden["basis"]}
    if aux:
        model["auxiliary_basis"] = aux
    spec = io.parse_input({"molecule": mol_in, "driver": "energy",
                           "model": model})
    mol = molecule.run(spec)
    bsets = basis.run(mol, spec.model)
    t0 = time.perf_counter()
    res = rhf.energy(mol, bsets, flags)
    res["wall_s"] = time.perf_counter() - t0
    res["golden"] = golden["energy"]
    return res


# --four-cards: (system, auxiliary basis, sharded builder), each run at full
# basis width sharded over four cards and on one card.  The conventional
# case forces the streaming builders, as phase 3 does; the DF case is
# phase 5's system, whose packed B is Q-partitioned over the cards.
FOUR_CARD_CASES = [
    ("ammonia_trimer", None, "ShardedStreamingFock"),
    ("indole_benzene_2_stacked", AUX, "ShardedDFFockBuilder"),
]


def _case_flags(aux: str | None, n_cards: int) -> dict:
    flags = dict(FLAGS, num_devices=n_cards)
    if aux:
        flags["scf_type"] = "df"
    return flags


def four_cards(cases=FOUR_CARD_CASES) -> None:
    """Sharded paths on four cards, each against the same run on one."""
    import jax

    import juliachem_jl_tpu as jc
    from juliachem_jl_tpu.utils import memory

    jc.initialize()
    for system, aux, sharded_cls in cases:
        with _streaming(aux is None):
            one = _energy(system, aux, _case_flags(aux, 1))
            four = _energy(system, aux, _case_flags(aux, 4))
        line = {
            "system": system, "aux": aux,
            "builder_1": one["Timings"].non_timing_data["fock_builder"],
            "builder_4": four["Timings"].non_timing_data["fock_builder"],
            "b_storage_1": one["Timings"].non_timing_data.get(
                "df_b_storage"),
            "energy_1": one["Energy"], "energy_4": four["Energy"],
            "diff": four["Energy"] - one["Energy"],
            "golden": one["golden"],
            "error_1": one["Energy"] - one["golden"],
            "iterations_1": one["Iterations"],
            "iterations_4": four["Iterations"],
            "stagnated": [bool(one["Stagnated"]), bool(four["Stagnated"])],
            "wall_s_1": one["wall_s"], "wall_s_4": four["wall_s"],
            "fock_steady_s_1": _fock_split(one["Timings"])[1],
            "fock_steady_s_4": _fock_split(four["Timings"])[1],
            "peak_device_bytes": [
                int((d.memory_stats() or {}).get("peak_bytes_in_use", -1))
                for d in jax.devices()],
            "bytes_limit": memory.device_memory_bytes(),
        }
        print(json.dumps(line, default=float), flush=True)
        if line["builder_4"] != sharded_cls:
            raise AssertionError(f"{system}: sharded builder "
                                 f"{line['builder_4']}, expected {sharded_cls}")
        if not (one["Converged?"] and four["Converged?"]) \
                or any(line["stagnated"]):
            raise AssertionError(f"{system}: convergence {line}")
        if abs(line["diff"]) > SHARD_ATOL:
            raise AssertionError(f"{system}: four cards differ from one by "
                                 f"{line['diff']:.3e}")
        gate = DF_ATOL if aux else CONV_RTOL * abs(one["golden"])
        if abs(line["error_1"]) > gate:
            raise AssertionError(f"{system}: one card off GAMESS by "
                                 f"{line['error_1']:.3e}")
    jc.finalize()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    ap.add_argument("--phases", default="2,3,4,5",
                    help="comma-separated single-card phases (default all)")
    args = ap.parse_args()

    # the package and its goldens must be beside this script: fail before
    # printing anything when they are not
    import juliachem_jl_tpu  # noqa: F401

    if not os.path.exists(GOLDENS):
        raise FileNotFoundError(GOLDENS)
    n_cards = 4 if args.four_cards else 1
    devs = card_check(n_cards)
    from jax import monitoring

    monitoring.register_event_duration_secs_listener(_on_duration)
    if args.four_cards:
        four_cards()
    else:
        for phase in sorted(int(p) for p in args.phases.split(",")):
            run_phase(phase)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
