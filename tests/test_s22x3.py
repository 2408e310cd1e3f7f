"""S22x3 goldens vs GAMESS outputs committed in the reference repo.

The reference ships full GAMESS RHF/6-311++G(2d,2p) outputs for the S22x3
set (example_inputs/benchmarks/S22_3-GAMESS-vs-JuliaChem-vs-Psi4/
GAMESS-111thread/*.output); tests/data/s22x3_gamess_goldens.json holds the
extracted FINAL energies + Bohr geometries.  These validate the
6-311++G(2d,2p) basis data (digit-for-digit from the same outputs) and the
nitrogen-containing path end to end.

Slow (JCHEM_SLOW=1): each system is a few hundred basis functions on the
single-core CPU runner.
"""

import json
import os
import pathlib

import pytest

from tests._subproc import run_python_json

SLOW = os.environ.get("JCHEM_SLOW") == "1"
DATA = pathlib.Path(__file__).parent / "data" / "s22x3_gamess_goldens.json"
GOLDEN = json.loads(DATA.read_text())

SYSTEMS = ["ammonia_trimer"] if SLOW else []
BOHR = 0.52917724924

_CODE = """
import json
from juliachem_jl_tpu import basis, io, molecule
from juliachem_jl_tpu.models import rhf

golden = json.loads('''{golden}''')
geometry = []
symbols = []
for a in golden["atoms"]:
    symbols.append(a["symbol"])
    geometry.extend(x * {bohr} for x in a["xyz_bohr"])
spec = io.parse_input({{
    "molecule": {{"symbols": symbols, "geometry": geometry,
                  "molecular_charge": 0}},
    "driver": "energy",
    "model": {{"method": "RHF", "basis": golden["basis"]}},
}})
mol = molecule.from_input_dict(spec.molecule)
bsets = basis.run(mol, spec.model)
res = rhf.energy(mol, bsets, {{"niter": 60, "dele": 1e-9, "rmsd": 1e-7,
                               "guess": "sad"}})
print("RESULT:" + json.dumps({{"energy": res["Energy"],
                               "converged": bool(res["Converged?"])}}))
"""


@pytest.mark.parametrize("name", SYSTEMS)
def test_s22x3_vs_gamess(name):
    g = GOLDEN[name]
    out = run_python_json(_CODE.format(golden=json.dumps(g), bohr=BOHR),
                          timeout=7200)
    assert out["converged"]
    assert abs(out["energy"] - g["energy"]) <= 1.49e-8 * abs(g["energy"]), (
        f"{name}: {out['energy']} vs GAMESS {g['energy']}"
    )


def test_goldens_fixture_integrity():
    assert len(GOLDEN) == 25
    assert GOLDEN["ammonia_trimer"]["energy"] == -168.6658358894


@pytest.mark.parametrize("name,streams", [("ammonia_trimer", False),
                                          ("benzene_water_2", True)])
def test_conventional_builder_choice(monkeypatch, name, streams):
    """The screened quartet count alone picks the streaming builder:
    ammonia_trimer (5.8e6 quartets) stays class-batched, benzene_water_2
    (4.5e7) streams, with no environment override."""
    from juliachem_jl_tpu import basis, io, molecule
    from juliachem_jl_tpu.models import rhf

    monkeypatch.delenv("JCHEM_CONV_STREAM", raising=False)
    monkeypatch.delenv("JCHEM_CONV_STREAM_THRESHOLD", raising=False)
    g = GOLDEN[name]
    spec = io.parse_input({
        "molecule": {"symbols": [a["symbol"] for a in g["atoms"]],
                     "geometry": [x * BOHR for a in g["atoms"]
                                  for x in a["xyz_bohr"]],
                     "molecular_charge": 0},
        "driver": "energy",
        "model": {"method": "RHF", "basis": g["basis"]},
    })
    bsets = basis.run(molecule.run(spec), spec.model)
    assert rhf.use_streaming(bsets.primary) is streams
