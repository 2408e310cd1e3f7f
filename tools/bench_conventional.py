"""Conventional (screened direct) Fock benchmark on device.

VERDICT r1 item 8: the BASELINE configs list conventional-RHF systems
(w-cluster and S22) but only the DF path had ever been timed on a device.
This measures the ScreenedDirectFock per-iteration build (ops/fock.py), the
analog of the reference's rfh_fock_build (SCF.jl:606-744), on:
  - the first NW waters of the w7.6 cluster at 6-31G* (conventional),
  - optionally an S22 system (--s22 N) at its own 6-31G(2df,p) basis.

Appends a "conventional" section to BENCH_DETAILS.json.

Usage: python tools/bench_conventional.py [NW] [--s22 N]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REF = "/root/reference"


def run_case(name: str, mol, bsets, flags) -> dict:
    import jax

    from juliachem_jl_tpu.models import rhf
    from juliachem_jl_tpu.utils.timings import JCTC

    t0 = time.time()
    res = rhf.energy(mol, bsets, flags)
    total = time.time() - t0
    timings = res["Timings"].timings
    fock = [v for k, v in sorted(
        timings.items(), key=lambda kv: kv[0])
        if k.startswith(JCTC.fock_time + "-")]
    steady = fock[1:] if len(fock) > 2 else fock
    out = {
        "system": name,
        "nbf": bsets.primary.nbf,
        "device": jax.devices()[0].platform,
        "energy": res["Energy"],
        "converged": bool(res["Converged?"]),
        "iters": res["Iterations"],
        "total_s": round(total, 2),
        "fock_s_per_iter": round(float(np.mean(steady)), 4),
        "fock_s_first": round(fock[0], 2) if fock else None,
    }
    print(json.dumps(out))
    return out


def main():
    from juliachem_jl_tpu import basis, io, molecule
    from juliachem_jl_tpu.basis import CalculationBasisSets

    nw = 8
    s22 = None
    args = sys.argv[1:]
    while args:
        a = args.pop(0)
        if a == "--s22":
            s22 = int(args.pop(0))
        else:
            nw = int(a)

    results = []
    if nw:
        spec = io.read_input(
            f"{REF}/example_inputs/Water/7_6/water_7.6.json")
        mol = molecule.from_input_dict({
            "symbols": spec.molecule["symbols"][: 3 * nw],
            "geometry": spec.molecule["geometry"][: 9 * nw],
            "molecular_charge": 0,
        })
        bsets = CalculationBasisSets(basis.build(mol, "6-31G*"), None)
        results.append(run_case(
            f"w{nw}_631Gstar_conventional", mol, bsets,
            {"niter": 30, "dele": 1e-6, "rmsd": 1e-5, "guess": "sad"}))

    if s22 is not None:
        spec = io.read_input(f"{REF}/example_inputs/S22/{s22:02d}_MP2.json")
        mol = molecule.from_input_dict(spec.molecule)
        bsets = basis.run(mol, spec.model)
        results.append(run_case(
            f"S{s22}_conventional", mol, bsets,
            {"niter": 40, "dele": 1e-8, "rmsd": 1e-6, "guess": "sad"}))

    path = os.path.join(REPO, "BENCH_DETAILS.json")
    details = {}
    if os.path.exists(path):
        with open(path) as f:
            details = json.load(f)
    details.setdefault("conventional", []).extend(results)
    with open(path, "w") as f:
        json.dump(details, f, indent=1)


if __name__ == "__main__":
    main()
