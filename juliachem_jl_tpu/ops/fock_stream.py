"""Streaming conventional Fock build with ON-DEVICE quartet enumeration.

The class-batched builder (ops/fock.py) precomputes, on the host, per-quartet
index streams and a gather-sum reduction plan — O(quartets x images) host and
device memory: 16.7 GB at w16 and multi-TB at w64 (tools/
estimate_conv_quartets.py), the wall that capped the conventional path near
w16 (VERDICT r3).  This builder removes every O(quartets) array:

* Pairs of each class are sorted by Schwarz value DESCENDING (host, O(pairs
  log pairs)).  For a (bra-class, ket-class) block pair the surviving
  quartets {(r, c): q_b[r] * q_k[c] >= cutoff} then form a STAIRCASE — for
  each bra pair r the survivors are exactly the prefix c < lim[r] — so the
  whole quartet space is described by one [n_pairs] cumulative-count array
  instead of explicit (r, c) lists.  This is the same screened triangular
  walk as the reference's composite quartet index (shared/Indicies.jl:5-44 +
  SCF.jl:916-933), re-derived as trace-time arithmetic.
* A lax.scan over fixed-size flat-index chunks decodes t -> (r, c) on device
  (searchsorted on the cumulative counts), gathers the pair primitive data
  (O(pairs) device residency), evaluates the batched McMurchie-Davidson
  class kernel, and digests straight into the J/K workspaces with
  scatter-adds.

Memory: host O(pairs), device O(pairs + chunk).  It evaluates every ERI on
every iteration, where ops/fock.py caches them in device memory when they
fit, so this builder is selected only past the point where ops/fock.py's
host index streams would not fit (see models/rhf.py); correctness is
identical (same quartet set, same weights).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.structs import Basis, ncart
from ..models.scf import FockBuilder
from ..utils.timings import Timings
from .eri import _eri_kernel_body
from .fock import DEFAULT_CUTOFF, _bucket_chunks, _digest_vals_body
from .pairs import PairBlock, unique_pair_blocks
from .schwarz import pair_schwarz

_CH = 4096  # quartets decoded/digested per scan step


def _pow2_pad(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length() if n > 1 else 1


@dataclass
class _DevBlock:
    """Device-resident, Schwarz-sorted pair data of one class (padded)."""

    la: int
    lb: int
    n: int            # real pair count
    n_pad: int
    q: np.ndarray     # [n] Schwarz values, descending (host)
    arrays: tuple     # (aexp, bexp, acoef, bcoef, A, B) jnp [n_pad, ...]
    off_a: object     # [n_pad] int32
    off_b: object
    diag: object      # [n_pad] f64: 0.5 where ish==jsh else 1.0


def _dev_block(b: PairBlock, q: np.ndarray) -> _DevBlock:
    order = np.argsort(-q, kind="stable")
    b = b.select(order)
    q = q[order]
    n = b.n
    n_pad = _pow2_pad(n)

    def pad(x):
        if n_pad == n:
            return jnp.asarray(x)
        fill = np.repeat(x[:1], n_pad - n, axis=0)
        return jnp.asarray(np.concatenate([x, fill], axis=0))

    diag = np.where(b.ish == b.jsh, 0.5, 1.0)
    return _DevBlock(
        la=b.la, lb=b.lb, n=n, n_pad=n_pad, q=q,
        arrays=(pad(b.aexp), pad(b.bexp), pad(b.acoef), pad(b.bcoef),
                pad(b.A), pad(b.B)),
        off_a=pad(b.off_a.astype(np.int32)),
        off_b=pad(b.off_b.astype(np.int32)),
        diag=pad(diag),
    )


def _stream_scan_factory(la, lb, lc, ld, Ka, Kb, Kc, Kd,
                         n_bra_pad, n_ket_pad, same_block, nbf_pad):
    """Shared scan body: decode flat quartet indices t0s -> (r, c) on
    device, evaluate the class ERIs and digest into a flat [2*P2] J/K
    workspace.  Used by the single-device jit (_stream_digest) and by the
    per-device body of the mesh-sharded build (_stream_digest_sharded)."""
    eri_f = _eri_kernel_body(la, lb, lc, ld, Ka, Kb, Kc, Kd)
    nca, ncb, ncc, ncd = ncart(la), ncart(lb), ncart(lc), ncart(ld)
    vals_f = _digest_vals_body(nca, ncb, ncc, ncd)
    P2 = nbf_pad * nbf_pad

    def scan_run(JK, D, N, cum, bra, off_a, off_b, diag_b,
                 ket, off_c, off_d, diag_k, t0s):
        Dm = D.reshape(-1)
        iota = jnp.arange(_CH, dtype=jnp.int64)

        def body(JK, t0):
            t = t0 + iota
            valid = t < N
            r = jnp.searchsorted(cum, t, side="right")
            r = jnp.clip(r, 0, n_bra_pad - 1)
            base = jnp.where(r > 0, cum[jnp.maximum(r - 1, 0)], 0)
            c = jnp.clip(t - base, 0, n_ket_pad - 1)
            w = diag_b[r] * diag_k[c]
            if same_block:
                w = jnp.where(r == c, 0.5 * w, w)
            w = jnp.where(valid, w, 0.0)

            prim = tuple(x[r] for x in bra) + tuple(x[c] for x in ket)
            I = eri_f(*prim)

            # flat scatter indices from the basis-function offsets
            ia = off_a[r][:, None] + jnp.arange(nca, dtype=jnp.int32)[None, :]
            ib = off_b[r][:, None] + jnp.arange(ncb, dtype=jnp.int32)[None, :]
            ic = off_c[c][:, None] + jnp.arange(ncc, dtype=jnp.int32)[None, :]
            idd = off_d[c][:, None] + jnp.arange(ncd, dtype=jnp.int32)[None, :]

            def flat(u, v):
                return (u[:, :, None] * nbf_pad
                        + v[:, None, :]).reshape(_CH, -1)

            idx_ab, idx_cd = flat(ia, ib), flat(ic, idd)
            idx_ac, idx_ad = flat(ia, ic), flat(ia, idd)
            idx_bc, idx_bd = flat(ib, ic), flat(ib, idd)
            j_ab, j_cd, k_ac, k_ad, k_bc, k_bd = vals_f(
                I, w, Dm, idx_ab, idx_cd, idx_ac, idx_ad, idx_bc, idx_bd)
            JK = JK.at[idx_ab.reshape(-1)].add(j_ab.reshape(-1))
            JK = JK.at[idx_cd.reshape(-1)].add(j_cd.reshape(-1))
            JK = JK.at[P2 + idx_ac.reshape(-1)].add(k_ac.reshape(-1))
            JK = JK.at[P2 + idx_ad.reshape(-1)].add(k_ad.reshape(-1))
            JK = JK.at[P2 + idx_bc.reshape(-1)].add(k_bc.reshape(-1))
            JK = JK.at[P2 + idx_bd.reshape(-1)].add(k_bd.reshape(-1))
            return JK, 0

        JK, _ = jax.lax.scan(body, JK, t0s)
        return JK

    return scan_run


@lru_cache(maxsize=None)
def _stream_digest(la, lb, lc, ld, Ka, Kb, Kc, Kd,
                   n_bra_pad, n_ket_pad, same_block, nbf_pad, n_chunks):
    """One jitted program per class-pair: scan over flat quartet chunks,
    decoding (r, c) on device and digesting into the J/K workspaces."""
    scan_run = _stream_scan_factory(la, lb, lc, ld, Ka, Kb, Kc, Kd,
                                    n_bra_pad, n_ket_pad, same_block, nbf_pad)

    def run(JK, D, N, cum, bra, off_a, off_b, diag_b,
            ket, off_c, off_d, diag_k):
        t0s = jnp.arange(n_chunks, dtype=jnp.int64) * _CH
        return scan_run(JK, D, N, cum, bra, off_a, off_b, diag_b,
                        ket, off_c, off_d, diag_k, t0s)

    return jax.jit(run, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _stream_digest_sharded(la, lb, lc, ld, Ka, Kb, Kc, Kd,
                           n_bra_pad, n_ket_pad, same_block, nbf_pad,
                           n_chunks_dev, mesh):
    """Mesh-sharded staircase digestion: the flat quartet index space of a
    class pair is split into ndev contiguous ranges (t_base per device);
    every device scans its own range with the SAME decode body against the
    replicated pair tables and accumulates a device-local J/K workspace
    row.  No communication inside the step — the one reduction per
    iteration happens in the caller (MPI.Allreduce analog,
    reference SCF.jl:623)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    scan_run = _stream_scan_factory(la, lb, lc, ld, Ka, Kb, Kc, Kd,
                                    n_bra_pad, n_ket_pad, same_block, nbf_pad)

    def local(JK, D, N, cum, bra, off_a, off_b, diag_b,
              ket, off_c, off_d, diag_k, t_base):
        t0s = t_base[0] + jnp.arange(n_chunks_dev, dtype=jnp.int64) * _CH
        out = scan_run(JK[0], D, N, cum, bra, off_a, off_b, diag_b,
                       ket, off_c, off_d, diag_k, t0s)
        return out[None]

    spec = P(("q", "k"))
    step = shard_map(
        local, mesh=mesh,
        in_specs=(spec,) + (P(),) * 11 + (spec,),
        out_specs=spec,
        check_vma=False,
    )
    return jax.jit(step, donate_argnums=(0,))


@dataclass
class _ClassPair:
    bi: int
    ki: int
    same: bool
    N: int            # surviving quartets
    cum: object       # [n_bra_pad] int64 device cumulative counts
    n_chunks: int


def count_screened_quartets(basis: Basis, cutoff: float = DEFAULT_CUTOFF,
                            pair_cutoff_scale: float = 1.0e-4) -> int:
    """Exact surviving-quartet count via the staircase (host, O(pairs log
    pairs)) — the builder-selection estimate in models/rhf.py."""
    blocks = unique_pair_blocks(basis)
    qvals = [pair_schwarz(b) for b in blocks]
    qmax = max((q.max() for q in qvals if len(q)), default=1.0)
    pair_cut = cutoff * pair_cutoff_scale / max(qmax, 1e-30)
    qs = [np.sort(q[q >= pair_cut])[::-1] for q in qvals]
    qs = [q for q in qs if len(q)]
    total = 0
    for i, qb in enumerate(qs):
        for j in range(i, len(qs)):
            qk = qs[j]
            lim = np.searchsorted(-qk, -(cutoff / np.maximum(qb, 1e-300)),
                                  side="right")
            if i == j:
                lim = np.minimum(lim, np.arange(1, len(qb) + 1))
            total += int(lim.sum())
    return total


class StreamingDirectFock(FockBuilder):
    """Schwarz-staircase, device-enumerated direct Fock (the past-host-
    memory conventional scale mode; reference composite-index walk analog).
    """

    def __init__(self, basis: Basis, cutoff: float = DEFAULT_CUTOFF,
                 pair_cutoff_scale: float = 1.0e-4):
        self.basis = basis
        self.nbf = basis.nbf
        self.nbf_pad = -(-basis.nbf // 128) * 128
        self.cutoff = cutoff

        blocks = unique_pair_blocks(basis)
        qvals = [pair_schwarz(b) for b in blocks]
        qmax = max((q.max() for q in qvals if len(q)), default=1.0)
        pair_cut = cutoff * pair_cutoff_scale / max(qmax, 1e-30)
        self.blocks: list[_DevBlock] = []
        for b, q in zip(blocks, qvals):
            keep = q >= pair_cut
            if keep.any():
                self.blocks.append(_dev_block(b.select(keep), q[keep]))

        self.pairs: list[_ClassPair] = []
        self.n_quartets = 0
        for i, bb in enumerate(self.blocks):
            for j in range(i, len(self.blocks)):
                kb = self.blocks[j]
                same = i == j
                # staircase: ket survivors of bra pair r are the prefix
                # c < lim[r] of the descending-sorted ket pairs
                thresh = cutoff / np.maximum(bb.q, 1e-300)
                lim = np.searchsorted(-kb.q, -thresh, side="right")
                if same:
                    lim = np.minimum(lim, np.arange(1, bb.n + 1))
                N = int(lim.sum())
                if N == 0:
                    continue
                cum = np.zeros(bb.n_pad, dtype=np.int64)
                cum[:bb.n] = np.cumsum(lim)
                cum[bb.n:] = N  # padded bra rows contribute nothing
                # bucket the scan length so compiled programs are shared
                # across molecules (padded chunks decode t >= N -> w = 0)
                self.pairs.append(_ClassPair(
                    bi=i, ki=j, same=same, N=N, cum=jnp.asarray(cum),
                    n_chunks=_bucket_chunks(-(-N // _CH))))
                self.n_quartets += N

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None):
        J, K = self.jk_halves(D, iteration, timings)
        return np.asarray(J - 0.5 * K)

    def two_electron_jk(self, Da, Db, iteration, timings: Timings,
                        Ca=None, Cb=None):
        Dt = np.asarray(Da) + np.asarray(Db)
        J, Kt = self.jk_halves(Dt, iteration, timings)
        if np.array_equal(Da, Db):
            Ka = Kb = 0.5 * Kt
        else:
            _, Ks = self.jk_halves(np.asarray(Da) - np.asarray(Db),
                                   iteration, timings)
            Ka = 0.5 * (Kt + Ks)
            Kb = 0.5 * (Kt - Ks)
        return np.asarray(J), np.asarray(Ka), np.asarray(Kb)

    def jk_halves(self, D, iteration, timings: Timings):
        nbf, nbf_pad = self.nbf, self.nbf_pad
        P2 = nbf_pad * nbf_pad
        D = jnp.asarray(D)
        if nbf_pad != nbf:
            D = jnp.pad(D, ((0, nbf_pad - nbf), (0, nbf_pad - nbf)))
        JK = jnp.zeros(2 * P2)
        for cp in self.pairs:
            bb, kb = self.blocks[cp.bi], self.blocks[cp.ki]
            kern = _stream_digest(
                bb.la, bb.lb, kb.la, kb.lb,
                bb.arrays[0].shape[1], bb.arrays[1].shape[1],
                kb.arrays[0].shape[1], kb.arrays[1].shape[1],
                bb.n_pad, kb.n_pad, cp.same, nbf_pad, cp.n_chunks)
            JK = kern(JK, D, cp.N, cp.cum,
                      bb.arrays, bb.off_a, bb.off_b, bb.diag,
                      kb.arrays, kb.off_a, kb.off_b, kb.diag)
        JK = np.asarray(JK)
        J = JK[:P2].reshape(nbf_pad, nbf_pad)[:nbf, :nbf]
        K = JK[P2:].reshape(nbf_pad, nbf_pad)[:nbf, :nbf]
        return J + J.T, K + K.T

    def finalize(self):
        self.blocks = []
        self.pairs = []


class ShardedStreamingFock(StreamingDirectFock):
    """Mesh-sharded Schwarz-staircase direct Fock: the flat quartet space
    of every class pair is range-split over the device mesh, each device
    runs the on-device decode + digest on its range, and the per-device
    J/K workspaces are summed once per iteration (the reference's
    rank-strided composite-index walk + MPI.Allreduce, SCF.jl:683-744 +
    623, at streaming-memory O(pairs) per device)."""

    def __init__(self, basis: Basis, mesh=None, n_devices: int | None = None,
                 cutoff: float = DEFAULT_CUTOFF,
                 pair_cutoff_scale: float = 1.0e-4,
                 timings: Timings | None = None):
        super().__init__(basis, cutoff, pair_cutoff_scale)
        if mesh is None:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(n_devices)
        self.mesh = mesh
        self.ndev = int(mesh.devices.size)
        from jax.sharding import NamedSharding, PartitionSpec as P

        self._jk_sharding = NamedSharding(mesh, P(("q", "k")))
        self._repl = NamedSharding(mesh, P())
        if timings is not None:
            from ..utils.timings import JCTC

            timings.non_timing_data[JCTC.gpu_num_devices] = str(self.ndev)

    def jk_halves(self, D, iteration, timings: Timings):
        nbf, nbf_pad, ndev = self.nbf, self.nbf_pad, self.ndev
        P2 = nbf_pad * nbf_pad
        D = jnp.asarray(D)
        if nbf_pad != nbf:
            D = jnp.pad(D, ((0, nbf_pad - nbf), (0, nbf_pad - nbf)))
        D = jax.device_put(D, self._repl)
        JK = jax.device_put(jnp.zeros((ndev, 2 * P2)), self._jk_sharding)
        for cp in self.pairs:
            bb, kb = self.blocks[cp.bi], self.blocks[cp.ki]
            n_chunks_dev = _bucket_chunks(-(-cp.N // (_CH * ndev)))
            t_base = jax.device_put(
                np.arange(ndev, dtype=np.int64) * (n_chunks_dev * _CH),
                self._jk_sharding)
            kern = _stream_digest_sharded(
                bb.la, bb.lb, kb.la, kb.lb,
                bb.arrays[0].shape[1], bb.arrays[1].shape[1],
                kb.arrays[0].shape[1], kb.arrays[1].shape[1],
                bb.n_pad, kb.n_pad, cp.same, nbf_pad, n_chunks_dev,
                self.mesh)
            JK = kern(JK, D, cp.N, cp.cum,
                      bb.arrays, bb.off_a, bb.off_b, bb.diag,
                      kb.arrays, kb.off_a, kb.off_b, kb.diag, t_base)
        # one cross-device reduction per iteration (MPI.Allreduce analog)
        JKh = np.asarray(JK).sum(axis=0)
        J = JKh[:P2].reshape(nbf_pad, nbf_pad)[:nbf, :nbf]
        K = JKh[P2:].reshape(nbf_pad, nbf_pad)[:nbf, :nbf]
        return J + J.T, K + K.T
