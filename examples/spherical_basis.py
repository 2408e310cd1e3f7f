"""Spherical-harmonic basis option — beyond the (Cartesian-only) reference.

`"spherical": true` in the model runs the SCF in the real solid-harmonic
(2l+1) space; integrals stay in their Cartesian class-batched form and
one geometry-independent block transform bridges the two
(basis/spherical.py).  Works across RHF/UHF/ROHF, DF, properties, RI-MP2
and analytic gradients.

Run: PYTHONPATH=. python examples/spherical_basis.py
"""

import juliachem_jl_tpu as jc

jc.initialize()

spec = {
    "molecule": {
        "symbols": ["O", "H", "H"],
        "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                     0.0, -0.751155, -0.465285],
    },
    "driver": "energy",
    "model": {"method": "RHF", "basis": "6-31G*", "spherical": True},
    "keywords": {"scf": {"niter": 60, "dele": 1e-9, "rmsd": 1e-7}},
}

import json
import tempfile

with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
    json.dump(spec, f)
    path = f.name

out = jc.run_file(path, output=1)
res = out["Energy"]
print("E(spherical 6-31G*) =", res["Energy"])
print("nbf spherical:", res["MO Coeff"].shape[0], "(Cartesian would be 19)")

# Cartesian comparison: the spherical span is a subspace, so E_sph >= E_cart
spec["model"]["spherical"] = False
with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
    json.dump(spec, f)
    path = f.name
e_cart = jc.run_file(path)["Energy"]["Energy"]
print("E(cartesian) =", e_cart, " gap:", res["Energy"] - e_cart)

jc.finalize()
