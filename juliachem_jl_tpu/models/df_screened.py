"""Screened (packed-pq) density-fitted Fock build — the scale path.

Rebuild of the reference's ScreenedDF.jl as packed device tensors:

  reference (ScreenedDF.jl)                  here
  -------------------------                  ----
  sparse_pq_index_map + contiguous           PackedScreen.col_map (flat
  non-zero ranges per p (:16-77)             (mu,nu) -> packed column; trash
                                             column for screened-out entries)
  B stored [rank_Q, screened_pq] (:98-105)   B stored [A, npq+1] (both index
                                             orders packed; last col zero)
  per-p gemms over non-zero rows for W       on-the-fly per-Q-block tile
  (:242-289)                                 expansion (one gather) + batched
                                             einsum (DGEMM on the card)
  blocked lower-triangle exchange            Q-blocked exchange: the block
  (:385-641) bounding the K workspace        bounds the expanded-tile
                                             device footprint instead (the
                                             memory hog is the dense tile,
                                             not the K accumulator)
  screened symmetric J via per-p gemv        packed matvec pair
  (:318-365)                                 V = B d, J = V B

Memory modes (chosen automatically from the B size vs the card's memory,
utils/memory.py):
  device  — B64 resident on the card (plus B32 for the mixed-precision phase)
  stream  — B64 in host RAM, streamed per Q-block each f64 iteration;
            B32 resident on the card for the f32 phase when it fits.
The stream mode lifts the single-card ceiling past the size whose B fits
in device memory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import memory
from ..utils.timings import JCTC, Timings
from .scf import FockBuilder


@dataclass
class PackedScreen:
    """Sparse pq bookkeeping (SchwarzScreening.jl / ScreenedDF.jl:16-77
    analog).  Both (mu,nu) and (nu,mu) of every surviving pair are packed,
    so J needs no off-diagonal doubling and K tiles are symmetric."""

    nbf: int
    npq: int
    pq_flat: np.ndarray   # [npq] int64 flat (mu*nbf+nu) of packed col c
    col_map: np.ndarray   # [nbf*nbf] int64 -> packed col; npq = trash

    @property
    def fill(self) -> float:
        return self.npq / float(self.nbf * self.nbf)


def build_packed_screen(primary, pair_blocks) -> PackedScreen:
    """Packed column map over the basis-function products of the surviving
    (Schwarz/sigma-screened) shell pairs."""
    nbf = primary.nbf
    flats = []
    for b in pair_blocks:
        nca, ncb = b.nbf_block
        ia = b.off_a[:, None, None] + np.arange(nca)[None, :, None]
        ib = b.off_b[:, None, None] + np.arange(ncb)[None, None, :]
        ia = np.broadcast_to(ia, (b.n, nca, ncb)).ravel()
        ib = np.broadcast_to(ib, (b.n, nca, ncb)).ravel()
        flats.append(ia * nbf + ib)
        flats.append(ib * nbf + ia)
    pq_flat = np.unique(np.concatenate(flats)) if flats else np.empty(0, np.int64)
    npq = len(pq_flat)
    col_map = np.full(nbf * nbf, npq, dtype=np.int64)
    col_map[pq_flat] = np.arange(npq, dtype=np.int64)
    return PackedScreen(nbf=nbf, npq=npq, pq_flat=pq_flat, col_map=col_map)


def build_B_packed(primary, aux, opts=None, timings: Timings | None = None):
    """Packed B[A, npq+1] with the metric folded in, plus the screen maps.

    Same pipeline as df.build_B (2-center metric -> screening -> 3-center ->
    triangular solve) but the 3-center tensor is scattered directly into
    packed columns — the dense [A, nbf, nbf] intermediate never exists.
    When even the packed tensor exceeds the device-build budget, it is
    assembled block-by-block in host RAM (the single-chip "huge" mode that
    unlocks w48+)."""
    from ..ops import eri3c
    from .df import screened_pair_blocks

    timings = timings or Timings()
    cache = getattr(opts, "df_b_cache", "") if opts is not None else ""
    from ..basis.spherical import aux_needs_sph

    sph_aux = ((getattr(opts, "df_spherical_aux", True)
                if opts is not None else True) and aux_needs_sph(aux))
    if cache:
        hit = _load_b_cache(cache, primary, aux, sph_aux)
        if hit is not None:
            return hit
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux)
    sigma = getattr(opts, "df_screening_sigma", 1e-5) if opts is not None else 1e-5
    with timings.timed(JCTC.screening_time):
        pair_blocks = screened_pair_blocks(
            primary, sigma, float(np.diag(metric).max()))
        screen = build_packed_screen(primary, pair_blocks)
    npq1 = screen.npq + 1
    b_dtype = (np.float32
               if str(getattr(opts, "df_b_dtype", "f64")) == "f32"
               else np.float64)
    raw = _load_raw_cache(cache, primary, aux, sph_aux, b_dtype, npq1) \
        if cache else None
    if raw is not None:
        P3 = raw
        timings.timings.setdefault(JCTC.three_center_time, 0.0)
    else:
        with timings.timed(JCTC.three_center_time):
            # the 3-center builder accumulates in host memory for every
            # size (device compute blocks, host scatter).  b_dtype=f32
            # halves every B-sized transfer (build d2h, fold, per-iteration
            # stream h2d) at a deterministic ~1e-5 Eh shift of the DF fixed
            # point.
            P3 = eri3c.three_center_tensor(
                primary, aux, pair_blocks, col_map=screen.col_map,
                packed_width=npq1, out_dtype=b_dtype, timings=timings)
        if cache:
            # checkpoint the unfolded tensor, so that a run killed during
            # the fold does not repeat the 3-center build
            _save_raw_cache(cache, primary, aux, sph_aux, P3)
    with timings.timed(JCTC.B_time):
        from .linalg import fold_metric

        import sys
        print(f"# build_B_packed: folding metric into B "
              f"({getattr(P3, 'nbytes', 0) / 1e9:.1f} GB)",
              file=sys.stderr, flush=True)
        B = P3 if isinstance(P3, np.ndarray) and P3.flags.writeable \
            else np.array(P3)
        from ..basis.spherical import project_metric_sph, project_rows_sph

        if sph_aux:
            # solid-harmonic fitting space: drops the Cartesian contaminant
            # rows (d-trace in s-span etc.) that made generated (AutoAux)
            # metrics numerically singular, and shrinks every later cost
            metric = project_metric_sph(aux, metric)
            B = project_rows_sph(aux, B)
        fold_metric(metric, B)
        B[:, -1] = 0.0
    if cache:
        print(f"# build_B_packed: writing B cache to {cache}_B.npy",
              file=sys.stderr, flush=True)
        _save_b_cache(cache, primary, aux, B, screen, sph_aux)
        _drop_raw_cache(cache)
    return B, screen


def _b_cache_fingerprint(primary, aux, sph_aux: bool = False) -> np.ndarray:
    """Geometry+basis fingerprint guarding a cached B against reuse across
    systems (same spirit as the SCF checkpoint guard, models/scf.py).
    sph_aux participates so toggling the solid-harmonic aux projection
    invalidates caches built the other way."""
    parts = [np.asarray([primary.nbf, aux.nbf, float(sph_aux)],
                        dtype=np.float64)]
    for b in (primary, aux):
        for l, cl in sorted(b.classes.items()):
            parts.append(np.asarray([l, cl.nshell], dtype=np.float64))
            parts.append(np.round(cl.centers.ravel(), 10))
            parts.append(np.round(cl.exps.ravel(), 10))
    v = np.concatenate(parts)
    return np.asarray([v.size, float(v.sum()), float((v * v).sum())])


def _load_b_cache(prefix: str, primary, aux, sph_aux: bool = False):
    import os

    bp, sp = prefix + "_B.npy", prefix + "_screen.npz"
    if not (os.path.exists(bp) and os.path.exists(sp)):
        return None
    try:
        meta = np.load(sp)
        if not np.allclose(meta["fingerprint"],
                           _b_cache_fingerprint(primary, aux, sph_aux)):
            return None
        # mmap: stream mode slices Q-blocks through the page cache instead
        # of holding a second full copy in RAM
        B = np.load(bp, mmap_mode="r")
        screen = PackedScreen(nbf=int(meta["nbf"]), npq=int(meta["npq"]),
                              pq_flat=meta["pq_flat"],
                              col_map=meta["col_map"])
        arows = int(meta["arows"]) if "arows" in meta else aux.nbf
        if B.shape != (arows, screen.npq + 1):
            return None
        import sys

        # stderr: bench.py's stdout must stay a single parseable JSON line
        print(f"# build_B_packed: loaded cached B from {bp} "
              f"({B.nbytes / 1e9:.1f} GB)", file=sys.stderr, flush=True)
        return B, screen
    except Exception:
        return None


def _load_raw_cache(prefix: str, primary, aux, sph_aux, b_dtype, npq1: int):
    """Unfolded (pre-metric, pre-sph-projection) 3-center checkpoint.

    Loaded writable (the fold mutates in place).  Invalidated by the same
    geometry/basis fingerprint as the final cache; dtype and packed width
    must match the current build options exactly."""
    import os
    import sys

    rp, mp = prefix + "_raw.npy", prefix + "_rawmeta.npz"
    if not (os.path.exists(rp) and os.path.exists(mp)):
        return None
    try:
        meta = np.load(mp)
        if not np.allclose(meta["fingerprint"],
                           _b_cache_fingerprint(primary, aux, sph_aux)):
            return None
        P3 = np.load(rp)
        if P3.dtype != b_dtype or P3.ndim != 2 or P3.shape[1] != npq1:
            return None
        print(f"# build_B_packed: resuming from raw 3c checkpoint {rp} "
              f"({P3.nbytes / 1e9:.1f} GB); skipping the 3c build",
              file=sys.stderr, flush=True)
        return P3
    except Exception:
        return None


def _save_raw_cache(prefix: str, primary, aux, sph_aux, P3) -> None:
    import os
    import sys

    try:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        print(f"# build_B_packed: checkpointing raw 3c tensor to "
              f"{prefix}_raw.npy ({P3.nbytes / 1e9:.1f} GB)",
              file=sys.stderr, flush=True)
        np.save(prefix + "_raw.npy.tmp.npy", P3)
        os.replace(prefix + "_raw.npy.tmp.npy", prefix + "_raw.npy")
        np.savez(prefix + "_rawmeta.npz",
                 fingerprint=_b_cache_fingerprint(primary, aux, sph_aux))
    except OSError as exc:
        import warnings

        warnings.warn(f"raw 3c checkpoint write failed ({exc}); "
                      "continuing without", stacklevel=2)


def _drop_raw_cache(prefix: str) -> None:
    import os

    for suffix in ("_raw.npy", "_rawmeta.npz"):
        try:
            os.remove(prefix + suffix)
        except OSError:
            pass


def _save_b_cache(prefix: str, primary, aux, B, screen,
                  sph_aux: bool = False) -> None:
    import os

    try:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        np.save(prefix + "_B.npy.tmp.npy", B)
        os.replace(prefix + "_B.npy.tmp.npy", prefix + "_B.npy")
        np.savez(prefix + "_screen.npz", nbf=screen.nbf, npq=screen.npq,
                 pq_flat=screen.pq_flat, col_map=screen.col_map,
                 arows=B.shape[0],
                 fingerprint=_b_cache_fingerprint(primary, aux, sph_aux))
    except OSError as exc:
        import warnings

        warnings.warn(f"B cache write failed ({exc}); continuing without",
                      stacklevel=2)


# ---------------------------------------------------------------- kernels


# float32 products (mixed-precision phase, fdiff_f32 increments) would
# otherwise be free to run in TF32 on the card; f64 products are unaffected
HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


@jax.jit
def _v_chunk(Bc, d):
    """V_Qblock = B_block · d_packed (ScreenedDF.jl:318-340 analog)."""
    return _mm(Bc, d)


@jax.jit
def _jk_chunk(Khalf, Jp, Bc, Vc, col_map, Cocc):
    """One Q-block of the fused J/K pass.

    Jp += V_block · B_block  (packed J accumulation)
    K: expand the block to a dense [Qc, nbf, nbf] tile via one gather on
    col_map (trash column = zeros), W = tile · Cocc, Khalf += W^T W.
    """
    nbf = Cocc.shape[0]
    Jp = Jp + _mm(Vc, Bc)
    tile = Bc[:, col_map].reshape(-1, nbf, nbf)
    W = jnp.einsum("qmn,mi->qin", tile, Cocc, precision=HIGHEST)
    Wm = W.reshape(-1, nbf)
    Khalf = Khalf + _mm(Wm.T, Wm)
    return Khalf, Jp


@jax.jit
def _jk_chunk_signed(Khalf, Jp, Bc, Vc, col_map, Cs, s):
    """Signed variant for indefinite densities (fdiff dD): K is linear in D,
    so D = 2 sum_k s_k c_k c_k^T gives Khalf = sum_k s_k (W_k)^T W_k."""
    nbf = Cs.shape[0]
    Jp = Jp + _mm(Vc, Bc)
    tile = Bc[:, col_map].reshape(-1, nbf, nbf)
    W = jnp.einsum("qmn,mi->qin", tile, Cs, precision=HIGHEST)
    Ws = W * s[None, :, None]
    Khalf = Khalf + jnp.einsum("qim,qin->mn", Ws, W, precision=HIGHEST)
    return Khalf, Jp


@partial(jax.jit, static_argnums=(7,))
def _jk_chunk_lower(Kup, Jp, Bc, Vc, col_map, Cs, s, nb):
    """Q-block of the J/K pass with lower-triangular K column-blocking
    (ScreenedDF.jl:459-641 analog): only the nb(nb+1)/2 upper block products
    are computed, cutting the dominant W^T W gemm FLOPs by ~2x at scale.
    Handles both the C_occ (s=1) and signed-density (fdiff dD) cases."""
    nbf = Cs.shape[0]
    Jp = Jp + _mm(Vc, Bc)
    tile = Bc[:, col_map].reshape(-1, nbf, nbf)
    W = jnp.einsum("qmn,mi->qin", tile, Cs, precision=HIGHEST)  # [qc,k,nbf]
    M = W.shape[0] * W.shape[1]
    kb = -(-nbf // nb)
    pad = nb * kb - nbf
    Wm = W.reshape(M, nbf)
    Wsm = (W * s[None, :, None]).reshape(M, nbf)
    if pad:
        Wm = jnp.pad(Wm, ((0, 0), (0, pad)))
        Wsm = jnp.pad(Wsm, ((0, 0), (0, pad)))
    W2 = Wm.reshape(M, nb, kb)
    Ws2 = Wsm.reshape(M, nb, kb)
    for I in range(nb):
        for J in range(I, nb):
            Kup = Kup.at[I * kb:(I + 1) * kb, J * kb:(J + 1) * kb].add(
                _mm(Ws2[:, I, :].T, W2[:, J, :]))
    return Kup, Jp


# fused variants computing V_Qblock = B_block · d inside the J/K pass: in
# stream mode the host-resident B rides PCIe once per iteration instead of
# twice (the V pass is kept separate only when B is device-resident, where
# re-reading it is free and the V/K phase telemetry stays meaningful)
@jax.jit
def _jk_chunk_fused(Khalf, Jp, Bc, d, col_map, Cocc):
    return _jk_chunk(Khalf, Jp, Bc, _mm(Bc, d), col_map, Cocc)


@jax.jit
def _jk_chunk_signed_fused(Khalf, Jp, Bc, d, col_map, Cs, s):
    return _jk_chunk_signed(Khalf, Jp, Bc, _mm(Bc, d), col_map, Cs, s)


@partial(jax.jit, static_argnums=(7,))
def _jk_chunk_lower_fused(Kup, Jp, Bc, d, col_map, Cs, s, nb):
    return _jk_chunk_lower(Kup, Jp, Bc, _mm(Bc, d), col_map, Cs, s, nb)


@partial(jax.jit, static_argnums=(2,))
def _finalize_G(Khalf, Jp, nbf, pq_flat):
    Jp = Jp.astype(jnp.float64)
    J = jnp.zeros(nbf * nbf).at[pq_flat].set(Jp[:-1]).reshape(nbf, nbf)
    return J - Khalf.astype(jnp.float64)


@partial(jax.jit, static_argnums=(2, 4))
def _finalize_G_blocked(Kup, Jp, nbf, pq_flat, kb):
    """Mirror the upper block triangle (diagonal blocks counted once)."""
    idx = jnp.arange(Kup.shape[0]) // kb
    bd = idx[:, None] == idx[None, :]
    Kfull = Kup + Kup.T - jnp.where(bd, Kup, 0.0)
    Jp = Jp.astype(jnp.float64)
    J = jnp.zeros(nbf * nbf).at[pq_flat].set(Jp[:-1]).reshape(nbf, nbf)
    return J - Kfull[:nbf, :nbf].astype(jnp.float64)


# ---------------------------------------------------------------- builder


class ScreenedDFFockBuilder(FockBuilder):
    """Packed-B DF Fock builder with Q-blocked exchange and optional
    host-streamed f64 storage (the production scale path; replaces
    ScreenedDF.jl + GPUDF.jl's single-rank duties)."""

    def __init__(self, primary, auxiliary, opts=None,
                 timings: Timings | None = None):
        timings = timings or Timings()
        self.primary = primary
        self.aux = auxiliary
        self.nbf = primary.nbf
        B, screen = build_B_packed(primary, auxiliary, opts, timings)
        self.screen = screen
        A = B.shape[0]
        self.A = A

        n_blocks = int(getattr(opts, "df_exchange_n_blocks", 0) or 0)
        if n_blocks > 0:
            self.q_chunk = -(-A // n_blocks)
        else:
            self.q_chunk = max(64, memory.budget_elements("df_exchange_tile")
                               // self.nbf**2)
        self.q_chunk = min(self.q_chunk, A)

        b_budget = memory.share_bytes("screened_df_b")
        b_bytes = B.nbytes  # dtype-aware (df_b_dtype="f32" halves this)
        self.stream = b_bytes > b_budget
        self.mixed = bool(getattr(opts, "mixed_precision", False))
        if self.stream:
            self.B_host = B  # stays in host RAM (f64, or f32 via df_b_dtype)
            self.B = None
            # f32 copy resident on the card for the f32 phase (half the bytes);
            # if even that overflows, _iter_blocks streams host blocks cast
            # to f32 per iteration instead
            self.B32 = (jnp.asarray(B.astype(np.float32))
                        if B.size * 4 <= b_budget else None)
        else:
            self.B_host = None
            self.B = jnp.asarray(B)
            self.B32 = self.B.astype(jnp.float32) if self.mixed else None
        self.supports_f32_phase = self.mixed and (
            self.B32 is not None or self.stream)
        # lower-triangular K column blocking pays once the W^T W gemm
        # dominates (ScreenedDF.jl:459-641's K_block_width analog)
        self.k_blocks = 4 if self.nbf >= 1024 else 1
        self._col_map = jnp.asarray(screen.col_map)
        self._pq_flat = jnp.asarray(screen.pq_flat)
        timings.non_timing_data["df_b_storage"] = (
            "host-streamed" if self.stream else "device")

    # -- helpers ---------------------------------------------------------

    def _iter_blocks(self, dtype):
        """Yield Q-blocks of B on device in the requested precision."""
        if dtype == "f32" and self.B32 is not None:
            src, cast = self.B32, None
        elif self.B is not None:
            src, cast = self.B, None
        else:
            src, cast = self.B_host, (np.float32 if dtype == "f32" else None)
        streaming = isinstance(src, np.ndarray)
        t0 = time.perf_counter() if streaming else 0.0
        for i, s in enumerate(range(0, self.A, self.q_chunk)):
            blk = src[s:s + self.q_chunk]
            if isinstance(blk, np.ndarray):
                blk = jnp.asarray(blk if cast is None else blk.astype(cast))
                if i % 8 == 7:
                    # stream-mode heartbeat: a w64 iteration h2d-streams
                    # tens of GB; keep the watchdogged log alive
                    import sys

                    print(f"# stream h2d Q-block {i + 1}/"
                          f"{-(-self.A // self.q_chunk)} "
                          f"t={time.perf_counter() - t0:.0f}s",
                          file=sys.stderr, flush=True)
            yield blk

    def _gather_d(self, D):
        return jnp.asarray(D).reshape(-1)[self._pq_flat]

    def _signed_factor(self, D):
        w, U = np.linalg.eigh(np.asarray(D))
        keep = np.abs(w) > 1e-12
        wk, Uk = w[keep], U[:, keep]
        Cs = Uk * np.sqrt(0.5 * np.abs(wk))[None, :]
        s = np.sign(wk)
        k = Cs.shape[1]
        kp = -(-max(k, 1) // 32) * 32
        if kp != k:
            Cs = np.pad(Cs, ((0, 0), (0, kp - k)))
            s = np.pad(s, (0, kp - k))
        return jnp.asarray(Cs), jnp.asarray(s)

    # -- FockBuilder interface --------------------------------------------

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        use_f32 = precision == "f32" and self.supports_f32_phase
        dt = "f32" if use_f32 else "f64"
        fdt = jnp.float32 if use_f32 else jnp.float64
        d = self._gather_d(D)
        d = jnp.concatenate([d, jnp.zeros(1)]).astype(fdt)
        nbf = self.nbf

        signed = C_occ is None
        if signed:
            Cs, s = self._signed_factor(D)
            Cs, s = Cs.astype(fdt), s.astype(fdt)
        else:
            Cocc = jnp.asarray(C_occ).astype(fdt)

        # stream mode pulls each host B block over PCIe — do it once per
        # iteration by folding the V matvec into the J/K pass
        fuse_v = self.B is None and (dt == "f64" or self.B32 is None)
        if not fuse_v:
            with timings.timed(JCTC.V_time, iteration):
                Vs = [_v_chunk(blk, d) for blk in self._iter_blocks(dt)]
                Vs[-1].block_until_ready()

        nb = self.k_blocks
        Jp = jnp.zeros(self.screen.npq + 1, dtype=fdt)
        with timings.timed(JCTC.K_time, iteration):
            if nb > 1:
                kb = -(-nbf // nb)
                Kup = jnp.zeros((nb * kb, nb * kb), dtype=fdt)
                if not signed:
                    Cs = Cocc
                    s = jnp.ones(Cocc.shape[1], dtype=fdt)
                if fuse_v:
                    for blk in self._iter_blocks(dt):
                        Kup, Jp = _jk_chunk_lower_fused(
                            Kup, Jp, blk, d, self._col_map, Cs, s, nb)
                else:
                    for blk, Vc in zip(self._iter_blocks(dt), Vs):
                        Kup, Jp = _jk_chunk_lower(
                            Kup, Jp, blk, Vc, self._col_map, Cs, s, nb)
                Kup.block_until_ready()
            else:
                Khalf = jnp.zeros((nbf, nbf), dtype=fdt)
                if fuse_v:
                    for blk in self._iter_blocks(dt):
                        if signed:
                            Khalf, Jp = _jk_chunk_signed_fused(
                                Khalf, Jp, blk, d, self._col_map, Cs, s)
                        else:
                            Khalf, Jp = _jk_chunk_fused(
                                Khalf, Jp, blk, d, self._col_map, Cocc)
                else:
                    for blk, Vc in zip(self._iter_blocks(dt), Vs):
                        if signed:
                            Khalf, Jp = _jk_chunk_signed(
                                Khalf, Jp, blk, Vc, self._col_map, Cs, s)
                        else:
                            Khalf, Jp = _jk_chunk(
                                Khalf, Jp, blk, Vc, self._col_map, Cocc)
                Khalf.block_until_ready()
        with timings.timed(JCTC.J_time, iteration):
            if nb > 1:
                G = np.asarray(_finalize_G_blocked(
                    Kup, Jp, nbf, self._pq_flat, -(-nbf // nb)))
            else:
                G = np.asarray(_finalize_G(Khalf, Jp, nbf, self._pq_flat))
        return G

    def finalize(self):
        self.B = None
        self.B32 = None
        self.B_host = None
