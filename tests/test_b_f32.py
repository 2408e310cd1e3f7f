"""df_b_dtype="f32": the transfer-halving packed-B storage option.

f32 storage halves every B-sized transfer (3c-build d2h, fold d2h,
per-iteration stream h2d).  Two invariants pinned here:

1. The metric fold must COMPUTE in f64 even for f32 storage — an f32-compute
   fold loses ~cond(metric) * eps_f32 (measured 3.0e-3 Eh on S22 S02,
   outside the 1.5e-3 DF gate); with f64 compute the shift is ~5.6e-6 Eh.
2. The fixed-point shift is deterministic and small, so the SCF still
   converges tightly.
"""

import warnings

import numpy as np

from juliachem_jl_tpu import basis, molecule
from juliachem_jl_tpu.basis import CalculationBasisSets
from juliachem_jl_tpu.models import rhf

WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, -0.1294, 0.0, -1.4941, 1.0274,
                      0.0, 1.4941, 1.0274]}


def test_f32_b_energy_close_and_converged():
    mol = molecule.from_input_dict(WATER)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets = CalculationBasisSets(
            basis.build(mol, "6-31G*"),
            basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", "6-31G*"))
    base = {"scf_type": "df", "niter": 60, "dele": 1e-8, "rmsd": 5e-6,
            "guess": "sad", "contraction_mode": "screened"}
    r64 = rhf.energy(mol, bsets, base)
    r32 = rhf.energy(mol, bsets, dict(base, df_b_dtype="f32"))
    assert r64["Converged?"] and r32["Converged?"]
    assert abs(r64["Energy"] - r32["Energy"]) < 5e-5


def test_fold_f64_compute_for_f32_storage():
    # direct check on the fold kernel semantics: f32 storage, f64 compute
    from juliachem_jl_tpu.models.linalg import fold_metric

    rng = np.random.default_rng(5)
    A = rng.standard_normal((48, 48))
    # metric with condition ~1e8 — f32-compute fold would lose ~1e-1 rel
    w = np.logspace(-6, 2, 48)
    Q, _ = np.linalg.qr(A)
    M = (Q * w) @ Q.T
    M = 0.5 * (M + M.T)
    B0 = rng.standard_normal((48, 9))
    ref = np.linalg.solve(np.linalg.cholesky(M), B0)
    B = B0.astype(np.float32)
    fold_metric(M, B)
    rel = np.abs(B - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel  # f32 representation only, no cond amplification
