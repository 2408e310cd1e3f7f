"""Glycine-chain family (reference example_inputs/gly/df/glyN.json):
conventional RHF vs DF-RHF self-parity.

The reference ships 18 glycine-chain inputs (cc-pVDZ, cc-pVDZ-RIFIT aux)
but commits no golden outputs for them, so the gate is the CI's own
DF-vs-conventional criterion: |E_df - E_conv| <= 1.5e-3 Eh
(/root/reference/test/runtests.jl:63).  The RIFIT aux resolves through the
AutoAux generator (basis/library.py) since no transcribable RIFIT table
exists in this environment (tools/make_basis_library.py provenance notes).

Resumable: records land in GLY_RESULTS.json per system+mode; existing
passes are skipped.  Usage:
  python tools/run_gly.py [N ...]       # default: 1 2 3
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RESULTS = os.path.join(REPO, "GLY_RESULTS.json")
INPUT = "/root/reference/example_inputs/gly/df/gly{n}.json"
KW = {"niter": 60, "dele": 1e-9, "rmsd": 1e-7, "guess": "sad"}
DF_GATE = 1.5e-3


def _load() -> dict:
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            return json.load(f)
    return {}


def _save(data: dict) -> None:
    with open(RESULTS, "w") as f:
        json.dump(data, f, indent=1)


def run_system(n: int, data: dict) -> None:
    from juliachem_jl_tpu import basis, io, molecule
    from juliachem_jl_tpu.basis import CalculationBasisSets
    from juliachem_jl_tpu.models import rhf

    key = f"gly{n}"
    rec = data.setdefault(key, {})
    spec = io.read_input(INPUT.format(n=n))
    mol = molecule.from_input_dict(spec.molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets_conv = CalculationBasisSets(
            basis.build(mol, spec.model["basis"]), None)
        aux = basis.build_auxiliary(
            mol, spec.model["auxiliary_basis"], spec.model["basis"])
        bsets_df = CalculationBasisSets(bsets_conv.primary, aux)
    print(f"# {key}: nbf={bsets_conv.primary.nbf} naux={aux.nbf}",
          flush=True)

    # DF first: it converges in minutes while conv can take hours — a
    # timeout mid-conv still banks the DF record for the family evidence
    for mode, bsets in (("df", bsets_df), ("conv", bsets_conv)):
        if rec.get(mode, {}).get("converged"):
            continue
        kw = dict(KW)
        kw["scf_type"] = "rhf" if mode == "conv" else "df"
        t0 = time.time()
        res = rhf.energy(mol, bsets, kw)
        rec[mode] = {
            "energy": res["Energy"],
            "converged": bool(res["Converged?"]),
            "iters": res["Iterations"],
            "wall_s": round(time.time() - t0, 1),
            "ts": round(time.time(), 1),
        }
        _save(data)
        print(f"{key} {mode} E={res['Energy']:.10f} "
              f"({rec[mode]['wall_s']}s, {res['Iterations']} iters)",
              flush=True)

    if rec.get("conv", {}).get("converged") and rec.get("df", {}).get(
            "converged"):
        de = abs(rec["df"]["energy"] - rec["conv"]["energy"])
        rec["df_parity_eh"] = de
        rec["pass"] = bool(de <= DF_GATE)
        _save(data)
        print(f"{key} parity {de:.2e} Eh -> "
              f"{'PASS' if rec['pass'] else 'FAIL'}", flush=True)


def _other_instance() -> int | None:
    """PID of another live run_gly.py process, if any.  Two concurrent
    instances would race on
    GLY_RESULTS.json writes and redo each other's systems."""
    skip = set()
    pid = os.getpid()
    while pid > 1:  # own ancestor chain (timeout/shell wrappers carry
        skip.add(pid)  # the script name in their cmdline)
        try:
            with open(f"/proc/{pid}/status") as f:
                pid = int(next(l for l in f
                               if l.startswith("PPid:")).split()[1])
        except (OSError, StopIteration, ValueError):
            break
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) in skip:
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if "run_gly.py" in cmd and "\x00/bin/bash\x00" not in cmd \
                and not cmd.startswith("/bin/bash"):
            return int(entry)
    return None


def main() -> int:
    other = _other_instance()
    if other is not None:
        print(f"# run_gly: another instance (pid {other}) is active; "
              "exiting to avoid racing on GLY_RESULTS.json", flush=True)
        return 0
    ns = [int(a) for a in sys.argv[1:] if a.isdigit()] or [1, 2, 3]
    data = _load()
    for n in ns:
        try:
            run_system(n, data)
        except Exception as e:  # noqa: BLE001 — record and continue
            data.setdefault(f"gly{n}", {})["error"] = (
                f"{type(e).__name__}: {e}")
            _save(data)
            print(f"gly{n} ERROR {e}", flush=True)
    npass = sum(1 for v in data.values() if v.get("pass"))
    print(json.dumps({"systems": len(data), "pass": npass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
