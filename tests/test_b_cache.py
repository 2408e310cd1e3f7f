"""Disk cache for the folded packed-B tensor (models/df_screened.py).

The cache lets an interrupted large run resume past its most expensive
phase.  Guarded by a geometry+basis fingerprint.
"""

import warnings

import numpy as np

from juliachem_jl_tpu import basis, molecule
from juliachem_jl_tpu.basis import CalculationBasisSets
from juliachem_jl_tpu.models.df_screened import _load_b_cache, build_B_packed
from juliachem_jl_tpu.utils.options import SCFOptions

WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, -0.1294, 0.0, -1.4941, 1.0274,
                      0.0, 1.4941, 1.0274]}


def _bsets(geom_scale=1.0):
    d = dict(WATER, geometry=[g * geom_scale for g in WATER["geometry"]])
    mol = molecule.from_input_dict(d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return CalculationBasisSets(
            basis.build(mol, "6-31G"),
            basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", "6-31G"))


def test_raw_3c_checkpoint_resumes_past_build(tmp_path, monkeypatch, capfd):
    """A kill during the metric fold must not repeat the 3c build: the
    unfolded tensor is checkpointed to disk before the fold (round-5: the
    stall watchdog killed the first w32 fold and threw away a 3518s build)."""
    import os

    import juliachem_jl_tpu.models.linalg as linalg

    bs = _bsets()
    opts = SCFOptions()
    opts.df_b_cache = str(tmp_path / "bc")
    opts.df_b_dtype = "f32"

    real_fold = linalg.fold_metric

    def dying_fold(metric, B, **kw):
        raise RuntimeError("simulated mid-fold kill")

    monkeypatch.setattr(linalg, "fold_metric", dying_fold)
    try:
        build_B_packed(bs.primary, bs.auxiliary, opts)
        assert False, "fold stub should have raised"
    except RuntimeError:
        pass
    assert os.path.exists(opts.df_b_cache + "_raw.npy")
    assert not os.path.exists(opts.df_b_cache + "_B.npy")

    # resume: skips the 3c build (raw checkpoint hit), folds, writes the
    # final cache, and drops the checkpoint
    monkeypatch.setattr(linalg, "fold_metric", real_fold)
    capfd.readouterr()
    B1, s1 = build_B_packed(bs.primary, bs.auxiliary, opts)
    assert "resuming from raw 3c checkpoint" in capfd.readouterr().err
    assert not os.path.exists(opts.df_b_cache + "_raw.npy")
    assert os.path.exists(opts.df_b_cache + "_B.npy")

    # the resumed result matches an uncached build bit-for-bit
    opts2 = SCFOptions()
    opts2.df_b_dtype = "f32"
    B2, s2 = build_B_packed(bs.primary, bs.auxiliary, opts2)
    assert B1.dtype == np.float32
    assert np.array_equal(np.asarray(B1), np.asarray(B2))
    assert s1.npq == s2.npq

    # a dtype flip must MISS the raw checkpoint (stale-precision reuse)
    from juliachem_jl_tpu.models.df_screened import _load_raw_cache
    assert _load_raw_cache(opts.df_b_cache, bs.primary, bs.auxiliary,
                           False, np.float64, s1.npq + 1) is None


def test_oei_cache_roundtrip_and_fingerprint(tmp_path, capfd):
    """S/T/V disk cache (models/scf.py::initial_state): the OEI build is
    the dominant setup cost on a resumed big run (w32: 1166 s vs ~1 s
    load); a geometry change must MISS."""
    from juliachem_jl_tpu.models import rhf

    mol = __import__("juliachem_jl_tpu").molecule.from_input_dict(WATER)
    bs = _bsets()
    kw = {"scf_type": "df", "niter": 30, "dele": 1e-8, "rmsd": 1e-6,
          "guess": "sad", "oei_cache": str(tmp_path / "c")}
    r1 = rhf.energy(mol, bs, kw)
    capfd.readouterr()
    r2 = rhf.energy(mol, bs, kw)
    assert "loaded cached S/T/V" in capfd.readouterr().err
    assert r1["Energy"] == r2["Energy"]
    # different geometry, same cache prefix -> rebuild, not reuse
    d = dict(WATER, geometry=[g * 1.05 for g in WATER["geometry"]])
    mol2 = __import__("juliachem_jl_tpu").molecule.from_input_dict(d)
    bs2 = _bsets(geom_scale=1.05)
    capfd.readouterr()
    r3 = rhf.energy(mol2, bs2, kw)
    assert "loaded cached S/T/V" not in capfd.readouterr().err
    assert abs(r3["Energy"] - r1["Energy"]) > 1e-6


def test_b_cache_roundtrip_and_fingerprint(tmp_path):
    bs = _bsets()
    opts = SCFOptions()
    opts.df_b_cache = str(tmp_path / "bc")
    B1, s1 = build_B_packed(bs.primary, bs.auxiliary, opts)
    B2, s2 = build_B_packed(bs.primary, bs.auxiliary, opts)
    assert isinstance(B2, np.memmap)  # mmap load, no second RAM copy
    assert np.array_equal(np.asarray(B1), np.asarray(B2))
    assert s1.npq == s2.npq
    assert np.array_equal(s1.pq_flat, s2.pq_flat)
    # a different geometry must MISS (stale-B reuse would corrupt the SCF)
    other = _bsets(geom_scale=1.05)
    assert _load_b_cache(opts.df_b_cache, other.primary,
                         other.auxiliary) is None
