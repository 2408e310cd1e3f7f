"""Estimate the screened-quartet count and host index-array footprint of the
conventional path for wN water clusters (the w7.6 north-star feasibility
check): mirrors build_quartet_batches' screening exactly but only COUNTS, so
it costs Schwarz + counting, not the quartet materialization itself."""
import sys

import numpy as np

sys.path.insert(0, "/root/repo")
from juliachem_jl_tpu import basis, io, molecule  # noqa: E402
from juliachem_jl_tpu.basis.structs import ncart  # noqa: E402
from juliachem_jl_tpu.ops.fock import DEFAULT_CUTOFF  # noqa: E402
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks  # noqa: E402
from juliachem_jl_tpu.ops.schwarz import pair_schwarz  # noqa: E402

NW = int(sys.argv[1]) if len(sys.argv) > 1 else 8

spec = io.read_input("/root/reference/example_inputs/Water/7_6/water_7.6.json")
symbols = spec.molecule["symbols"][: 3 * NW]
geometry = spec.molecule["geometry"][: 9 * NW]
mol = molecule.from_input_dict(
    {"symbols": symbols, "geometry": geometry, "molecular_charge": 0})
import warnings

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    b = basis.build(mol, "6-31+G*")

blocks = unique_pair_blocks(b)
qvals = [pair_schwarz(blk) for blk in blocks]
qmax = max((q.max() for q in qvals if len(q)), default=1.0)
cutoff = DEFAULT_CUTOFF
pair_cut = cutoff * 1.0e-4 / max(qmax, 1e-30)
kept = []
for blk, q in zip(blocks, qvals):
    keep = q >= pair_cut
    if keep.any():
        kept.append((blk, np.sort(q[keep])[::-1], keep.sum(),
                     ncart(blk.la) * ncart(blk.lb)))

total_pairs = sum(k[2] for k in kept)
n_quartets = 0
idx_bytes = 0.0
eri_elems = 0.0
for i, (bb, qb, nb, nab) in enumerate(kept):
    for j in range(i, len(kept)):
        bk, qk_sorted, nk, ncd = kept[j]
        # count pairs with qb[r]*qk[c] >= cutoff via sorted search:
        # qk_sorted is DESCENDING, so the partners with qk >= thresh[r] are
        # a PREFIX — searchsorted on the negated (ascending) array with
        # side="right" gives that prefix length.  (ADVICE r3: the previous
        # `len - searchsorted(...)` counted the qk < thresh suffix instead,
        # inverting every feasibility number derived from this tool.)
        thresh = cutoff / qb  # qk >= thresh[r]
        cnt = np.searchsorted(-qk_sorted, -thresh, side="right")
        n = int(cnt.sum())
        if i == j:
            # upper-triangular r <= c: approximate as (n + diag)/2
            n = (n + nb) // 2
        n_quartets += n
        nca, ncb = ncart(bb.la), ncart(bb.lb)
        ncc, ncd_ = ncart(bk.la), ncart(bk.lb)
        # six image streams: ab, cd, ac, ad, bc, bd
        img = (nca * ncb + ncc * ncd_ + nca * ncc + nca * ncd_
               + ncb * ncc + ncb * ncd_)
        idx_bytes += n * img * 8 * 2  # int64 streams + scatter target copy
        eri_elems += n * nca * ncb * ncc * ncd_

print(f"NW={NW} nbf={b.nbf} nshell={b.nshell} kept_pairs={total_pairs}")
print(f"screened quartets ~ {n_quartets:.3e}")
print(f"host idx-stream footprint ~ {idx_bytes/1e9:.1f} GB (int64, x2 plan)")
print(f"screened ERI volume/iter ~ {eri_elems:.3e} elems "
      f"({eri_elems*8/1e9:.1f} GB f64)")
