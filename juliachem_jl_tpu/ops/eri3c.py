"""3-center (Q|mu nu) and 2-center (P|Q) integrals for density fitting.

Replaces the reference's DFRHFTEIEngine (deps/src/jeri-df-tei.hpp:51-95) and
the assembly loops in DensityFitting/{TwoCenterIntegrals,ThreeCenterIntegrals,
ThreeCenterIntegralsScreened}.jl.  Both reduce to the 4-center class kernel
with "unit" ket shells (exponent 0, coefficient 1 — the same xs_xx trick the
reference uses via libint's unit shell).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.structs import Basis, ncart
from ..utils import memory
from .boys import boys
from .class_tables import combine_tables
from .eri import TWO_PI_POW_2_5, bra_hermite, eri_block
from .mcmurchie import r_tensor
from .pairs import PairBlock, block_scatter_indices, unique_pair_blocks


def aux_unit_blocks(aux: Basis) -> list[PairBlock]:
    """Each auxiliary shell paired with a unit s-shell -> PairBlock per class."""
    blocks = []
    for l, cl in sorted(aux.classes.items()):
        n = cl.nshell
        blocks.append(
            PairBlock(
                la=l, lb=0,
                ish=cl.shell_idx, jsh=np.full(n, -1),
                aexp=cl.exps, bexp=np.zeros((n, 1)),
                acoef=cl.coefs, bcoef=np.ones((n, 1)),
                A=cl.centers, B=cl.centers,
                off_a=cl.offsets, off_b=np.zeros(n, dtype=np.int64),
            )
        )
    return blocks


def two_center_metric(aux: Basis) -> np.ndarray:
    """(P|Q) Coulomb metric over the auxiliary basis
    (TwoCenterIntegrals.jl analog)."""
    A = aux.nbf
    out = np.zeros((A, A))
    blocks = aux_unit_blocks(aux)
    for bi, bra in enumerate(blocks):
        for ket in blocks[bi:]:
            r, c = np.meshgrid(np.arange(bra.n), np.arange(ket.n), indexing="ij")
            sel_b, sel_k = r.ravel(), c.ravel()
            vals = eri_block(bra, ket, sel_b, sel_k)     # [N, ncp, ncq]
            ncp, ncq = ncart(bra.la), ncart(ket.la)
            ip = bra.off_a[sel_b][:, None, None] + np.arange(ncp)[None, :, None]
            iq = ket.off_a[sel_k][:, None, None] + np.arange(ncq)[None, None, :]
            ip = np.broadcast_to(ip, vals.shape)
            iq = np.broadcast_to(iq, vals.shape)
            out[ip, iq] = vals
            out[iq.transpose(0, 2, 1), ip.transpose(0, 2, 1)] = vals.transpose(0, 2, 1)
    return out


@lru_cache(maxsize=None)
def _threecenter_compute_kernel(la: int, lb: int, Ka: int, Kb: int,
                                lq: int, Kq: int, nq_pad: int,
                                out_f32: bool = False):
    """Jitted 3-center COMPUTE kernel: a chunk of bra pairs against a
    padded batch of nq_pad same-class auxiliary shells, returning one
    [Pc, nab, nq_pad, ncq] block.

    Key optimizations over quartet-batching:
    * the bra Hermite expansion Eab is computed once per *pair chunk* and
      reused across the whole auxiliary batch;
    * the pair chunk arrives as ONE packed [Pc, 2Ka+2Kb+7] array
      (aexp|acoef|bexp|bcoef|A|B|valid): one host-to-device copy per pair
      chunk instead of seven;
    * the cast for an f32 output happens in the kernel (out_f32), so the
      device-to-host copy moves half the bytes;
    * the kernel is free of the B workspace, whose shape (A x npq+1) is
      molecule-sized: keyed only on class/batch metadata, one compiled
      kernel serves every molecule in a basis family, and the
      molecule-shaped scatter lives on the host (_scatter_block_host).
    """
    def f(packed, qexp, qcoef, Qc):
        o = 0
        aexp = packed[:, o:o + Ka]; o += Ka
        acoef = packed[:, o:o + Ka]; o += Ka
        bexp = packed[:, o:o + Kb]; o += Kb
        bcoef = packed[:, o:o + Kb]; o += Kb
        A = packed[:, o:o + 3]; o += 3
        B = packed[:, o:o + 3]; o += 3
        valid = packed[:, o]
        # bra pairs (shared across the aux batch)
        Eab, p, P = bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B)
        Lb = la + lb
        vmask = valid[:, None, None, None]

        L = Lb + lq
        comb, sign = combine_tables(Lb, lq)
        sgn = jnp.asarray(sign)
        zq = jnp.zeros_like(qexp)
        Ecd, q, Qcen = bra_hermite(lq, 0, qexp, zq, qcoef,
                                   jnp.ones_like(qcoef), Qc, Qc)
        # P: [Pc, K2b, 3]; Qcen: [Nq, Kq, 3]
        PQ = P[:, :, None, None, :] - Qcen[None, None, :, :, :]
        psum = p[:, :, None, None] + q[None, None, :, :]
        alpha = p[:, :, None, None] * q[None, None, :, :] / psum
        Targ = alpha * jnp.sum(PQ**2, axis=-1)
        pref = TWO_PI_POW_2_5 / (
            p[:, :, None, None] * q[None, None, :, :] * jnp.sqrt(psum))
        F = boys(Targ, L) * pref[..., None]
        R = r_tensor(L, alpha, PQ, F)            # [Pc,K2b,Nq,Kq,nherm]
        M = R[..., comb] * sgn[None, None, None, None, None, :]
        # contract aux primitives+hermite: T1[Pc,K2b,h,Nq,c]
        T1 = jnp.einsum("pkqrhg,qrcg->pkhqc", M, Ecd)
        out = jnp.einsum("pkah,pkhqc->paqc", Eab, T1)  # [Pc,nab,Nq,ncq]
        out = out * vmask
        if out_f32:
            out = out.astype(jnp.float32)
        return out

    return jax.jit(f)


def _scatter_block_host(B3: np.ndarray, blk: np.ndarray, rows: np.ndarray,
                        cols: np.ndarray, cols_t: np.ndarray,
                        mirror: np.ndarray) -> None:
    """Host scatter-add of one transferred compute block into B3.

    blk: [pc, nab, m, ncq] (valid region only); rows: [m, ncq] aux rows;
    cols/cols_t: [pc, nab] packed/flat columns; mirror: [pc] bool.
    Within one block every (aux row, column) pair is unique, so plain
    fancy-index += is an exact reduction (same argument as the host path).
    """
    r4 = np.broadcast_to(rows[None, None, :, :], blk.shape)
    c4 = np.broadcast_to(cols[:, :, None, None], blk.shape)
    B3[r4, c4] += blk
    if mirror.any():
        bm = blk[mirror]
        B3[np.broadcast_to(rows[None, None, :, :], bm.shape),
           np.broadcast_to(cols_t[mirror][:, :, None, None], bm.shape)] += bm


def three_center_tensor(
    primary: Basis,
    aux: Basis,
    pair_blocks: list[PairBlock] | None = None,
    chunk: int = 2048,
    col_map: np.ndarray | None = None,
    packed_width: int | None = None,
    out_dtype=np.float64,
    timings=None,
) -> np.ndarray:
    """(Q | mu nu) integrals, built on device.

    pair_blocks may be pre-screened (Schwarz) unique pair blocks; default is
    all unique pairs.  Both (mu,nu) and (nu,mu) entries are filled.

    Dense mode (col_map None): returns (A, nbf, nbf).
    Packed mode: col_map is an int64 [nbf*nbf] lookup mapping flat (mu,nu) to
    a packed screened-pq column (ScreenedDF.jl:16-77 sparse_pq_index_map
    analog), with screened-out entries pointing at a trash column
    npq = col_map.max(); returns (A, npq+1) with the trash column zeroed.

    timings (optional utils.timings.Timings) receives the seconds spent
    waiting for device blocks, copying them to the host and scattering
    them into the host accumulator.
    """
    A, nbf = aux.nbf, primary.nbf
    if pair_blocks is None:
        pair_blocks = unique_pair_blocks(primary)
    import os

    if (jax.default_backend() == "cpu"
            and os.environ.get("JCHEM_FORCE_DEVICE_3C") != "1"):
        # zero-compile host path: on the CPU backend each fused 3-center
        # kernel costs a minute or more of XLA compile per pair class; the
        # numpy evaluation needs none and uses exact (unpadded) shapes.
        # JCHEM_FORCE_DEVICE_3C=1 runs the device (jit) path anyway so CPU
        # tests can cover it.
        return _three_center_host(primary, aux, pair_blocks, col_map,
                                  packed_width, out_dtype)

    packed = col_map is not None
    if packed:
        width = packed_width if packed_width is not None else int(col_map.max()) + 1
    else:
        width = nbf * nbf
    # HOST accumulator: every compute block is copied to the host as soon
    # as it is done and scattered there with numpy, so B never exists on
    # the device during the build.  out_dtype=f32 halves those copies:
    # compute stays f64 on device and each block is cast before the pull.
    B3 = np.zeros((A, width), dtype=out_dtype)
    cast32 = np.dtype(out_dtype) == np.float32

    # padded per-class auxiliary batch arrays, shared across pair classes
    from .class_tables import nherm as _nherm

    # Fixed canonical aux chunk: every aux class is processed in chunks of
    # exactly NQ_CHUNK shells (padding the tail), so the aux batch shape —
    # and with it every compute-kernel compile — is identical for every
    # molecule sharing a basis family.
    NQ_CHUNK = 64
    aux_groups: dict = {}  # (lq, Kq) -> [(qexp, qcoef, Qc, rows_np, m)]
    for aux_blk in aux_unit_blocks(aux):
        ncq = ncart(aux_blk.la)
        nq = aux_blk.n
        for q0 in range(0, nq, NQ_CHUNK):
            q1 = min(q0 + NQ_CHUNK, nq)
            m = q1 - q0
            qexp = np.ones((NQ_CHUNK, aux_blk.aexp.shape[1]))
            qcoef = np.zeros((NQ_CHUNK, aux_blk.acoef.shape[1]))
            Qc = np.zeros((NQ_CHUNK, 3))
            qexp[:m] = aux_blk.aexp[q0:q1]
            qcoef[:m] = aux_blk.acoef[q0:q1]
            Qc[:m] = aux_blk.A[q0:q1]
            rows = (aux_blk.off_a[q0:q1, None]
                    + np.arange(ncq)[None, :]).astype(np.int64)
            aux_groups.setdefault((aux_blk.la, aux_blk.aexp.shape[1]),
                                  []).append((qexp, qcoef, Qc, rows, m))

    # f64 elements of one launch's largest intermediate, and of one
    # launch's output block (the device-to-host copy granularity)
    budget = memory.budget_elements("eri3c_work")
    out_budget = memory.budget_elements("eri3c_out")
    CSIZE_MIN = 64   # smallest useful pair chunk when sizing buckets
    n_launched = 0   # telemetry counter
    t_wait = t_d2h = t_scatter = 0.0
    import sys as _sys
    import time as _time
    _t_build0 = _time.perf_counter()
    print(f"# 3c build: {sum(1 for p in pair_blocks if p.n)} pair classes, "
          f"{sum(len(v) for v in aux_groups.values())} aux chunks, nbf={nbf}",
          file=_sys.stderr, flush=True)

    def _pow2_floor(v: int) -> int:
        return 1 << (max(int(v), 1).bit_length() - 1)

    # depth-1 pipeline: at most one launch's output in flight.  The pull
    # of launch i overlaps the device execution of launch i+1, hiding the
    # smaller of (copy + scatter, compute) per launch.
    pending: list = []  # [(out_dev, scatter_ctx)]

    def _drain():
        nonlocal n_launched, t_wait, t_d2h, t_scatter
        if not pending:
            return
        out_dev, (subs, s, e, cols_pc, cols_t_pc, mirror_pc) = pending.pop()
        t0 = _time.perf_counter()
        out_dev.block_until_ready()
        t1 = _time.perf_counter()
        blk = np.asarray(out_dev)
        t2 = _time.perf_counter()
        n_launched += 1
        # scatter each valid aux sub-chunk of the batched output
        for g, c in enumerate(subs):
            rows_np, m = c[3], c[4]
            _scatter_block_host(
                B3, blk[:e - s, :, g * NQ_CHUNK: g * NQ_CHUNK + m, :],
                rows_np, cols_pc[s:e], cols_t_pc[s:e], mirror_pc[s:e])
        t_wait += t1 - t0
        t_d2h += t2 - t1
        t_scatter += _time.perf_counter() - t2

    for pblk in pair_blocks:
        if pblk.n == 0:
            continue
        ia, ib = _pair_bf_indices_flat(pblk)            # [n, nab] each
        cols = (ia * nbf + ib).astype(np.int64)
        cols_t = (ib * nbf + ia).astype(np.int64)
        if packed:
            cols = col_map[cols]
            cols_t = col_map[cols_t]
        mirror = pblk.ish != pblk.jsh                    # [n] bool

        n = pblk.n
        Ka, Kb = pblk.aexp.shape[1], pblk.bexp.shape[1]
        k2b = Ka * Kb
        nab = int(np.prod(pblk.nbf_block))
        # ONE packed host array per pair class: a single host-to-device
        # copy per pair chunk replaces seven (aexp/bexp/acoef/bcoef/A/B/valid)
        packed_h = np.concatenate(
            [pblk.aexp, pblk.acoef, pblk.bexp, pblk.bcoef,
             pblk.A, pblk.B, np.ones((n, 1))], axis=1)

        for (lq, Kq), chks in aux_groups.items():
            # per-pair-row, per-primitive-pair working set: the largest of
            # the R tensor [NQ,Kq,nherm(L)], its comb-expanded gather M
            # [NQ,Kq,nherm(Lb),nherm(lq)] and the T1 einsum intermediate
            # [nherm(Lb),NQ,ncart(lq)]
            Lb2 = pblk.la + pblk.lb
            ncq = ncart(lq)
            w = NQ_CHUNK * max(Kq * _nherm(Lb2 + lq),
                               Kq * _nherm(Lb2) * _nherm(lq),
                               _nherm(Lb2) * ncq)
            # nb: pair rows per launch at one NQ_CHUNK aux batch (G=1).  G
            # (aux chunks fused per launch) spends whatever budget the
            # `chunk` cap on the pair axis leaves unused: the per-launch
            # working set scales with csize*G, so fusing aux chunks into
            # one launch cuts the launch count for cheap classes at the
            # same memory pressure.
            nb = int(budget / max(k2b * w, 1))
            csize = _pow2_floor(max(CSIZE_MIN, min(chunk, nb)))
            G = max(1, min(len(chks), nb // csize,
                           int(out_budget / max(csize * nab * NQ_CHUNK * ncq, 1))))
            G = _pow2_floor(G)

            # batch G aux chunks into one padded launch batch
            batches = []
            for i in range(0, len(chks), G):
                sub = chks[i:i + G]
                npad = G - len(sub)
                qe = np.concatenate([c[0] for c in sub]
                                    + [np.ones((NQ_CHUNK * npad, Kq))] * (npad > 0))
                qc = np.concatenate([c[1] for c in sub]
                                    + [np.zeros((NQ_CHUNK * npad, Kq))] * (npad > 0))
                qx = np.concatenate([c[2] for c in sub]
                                    + [np.zeros((NQ_CHUNK * npad, 3))] * (npad > 0))
                batches.append((jnp.asarray(qe), jnp.asarray(qc),
                                jnp.asarray(qx), sub))

            kern = _threecenter_compute_kernel(pblk.la, pblk.lb, Ka, Kb,
                                               lq, Kq, G * NQ_CHUNK, cast32)
            s = 0
            while s < n:
                e = min(s + csize, n)
                ph = packed_h[s:e]
                if e - s < csize:  # pad the tail launch
                    fill = np.repeat(ph[:1], csize - (e - s), axis=0)
                    fill[:, -1] = 0.0  # valid column
                    ph = np.concatenate([ph, fill], axis=0)
                ch = jnp.asarray(ph)   # one h2d per pair chunk, all batches
                for qe_j, qc_j, qx_j, sub in batches:
                    out = kern(ch, qe_j, qc_j, qx_j)
                    _drain()  # pull previous launch while this one runs
                    pending.append((out, (sub, s, e, cols, cols_t, mirror)))
                s = e
    _drain()
    total = _time.perf_counter() - _t_build0
    print(f"# 3c build done: {n_launched} launches in {total:.0f}s "
          f"(wait {t_wait:.1f}s, d2h {t_d2h:.1f}s, "
          f"host scatter {t_scatter:.1f}s)", file=_sys.stderr, flush=True)
    if timings is not None:
        timings.record("three_center_wait_time", t_wait)
        timings.record("three_center_d2h_time", t_d2h)
        timings.record("three_center_scatter_time", t_scatter)
    if packed:
        B3[:, -1] = 0.0  # trash column (screened-out scatter target)
        return B3
    return B3.reshape(A, nbf, nbf)


def _three_center_host(primary: Basis, aux: Basis,
                       pair_blocks: list[PairBlock],
                       col_map: np.ndarray | None,
                       packed_width: int | None,
                       out_dtype=np.float64) -> np.ndarray:
    """Host-numpy (Q | mu nu) builder — same math as the fused device kernel
    (bra Hermite reused across aux classes, MD R-tensor contraction), but
    with exact shapes, no padding and no scatter conflicts: within one
    fancy-index add every (aux row, target column) pair is unique, so plain
    ``B3[r, c] += out`` is an exact reduction."""
    A, nbf = aux.nbf, primary.nbf
    packed = col_map is not None
    if packed:
        width = packed_width if packed_width is not None else int(col_map.max()) + 1
    else:
        width = nbf * nbf
    B3 = np.zeros((A, width), dtype=out_dtype)
    aux_blocks = aux_unit_blocks(aux)
    BUDGET = 6.0e7  # R-tensor working-set elements per pair chunk

    for pblk in pair_blocks:
        if pblk.n == 0:
            continue
        ia, ib = _pair_bf_indices_flat(pblk)            # [n, nab] each
        cols = (ia * nbf + ib).astype(np.int64)
        cols_t = (ib * nbf + ia).astype(np.int64)
        if packed:
            cols = col_map[cols]
            cols_t = col_map[cols_t]
        mirror = pblk.ish != pblk.jsh                    # [n] bool
        Lb = pblk.la + pblk.lb
        Eab, p, P = bra_hermite(pblk.la, pblk.lb, pblk.aexp, pblk.bexp,
                                pblk.acoef, pblk.bcoef, pblk.A, pblk.B)
        k2b = p.shape[1]
        for ablk in aux_blocks:
            lq = ablk.la
            ncq = ncart(lq)
            L = Lb + lq
            comb, sign = combine_tables(Lb, lq)
            zq = np.zeros_like(ablk.aexp)
            Ecd, q, Qcen = bra_hermite(lq, 0, ablk.aexp, zq, ablk.acoef,
                                       np.ones_like(ablk.acoef),
                                       ablk.A, ablk.A)
            rows = ablk.off_a[:, None] + np.arange(ncq)[None, :]  # [Nq, ncq]
            from .class_tables import nherm as _nherm
            work = k2b * ablk.n * q.shape[1] * _nherm(L)
            csize = max(8, int(BUDGET / max(work, 1)))
            for s in range(0, pblk.n, csize):
                e = min(s + csize, pblk.n)
                PQ = P[s:e, :, None, None, :] - Qcen[None, None, :, :, :]
                psum = p[s:e, :, None, None] + q[None, None, :, :]
                alpha = p[s:e, :, None, None] * q[None, None, :, :] / psum
                Targ = alpha * np.sum(PQ ** 2, axis=-1)
                pref = TWO_PI_POW_2_5 / (
                    p[s:e, :, None, None] * q[None, None, :, :]
                    * np.sqrt(psum))
                F = boys(Targ, L) * pref[..., None]
                R = r_tensor(L, alpha, PQ, F)        # [Pc,K2b,Nq,Kq,nherm]
                M = R[..., comb] * np.asarray(sign)[None, None, None, None, :]
                T1 = np.einsum("pkqrhg,qrcg->pkhqc", M, Ecd)
                out = np.einsum("pkah,pkhqc->paqc", Eab[s:e], T1)
                # scatter [Pc,nab,Nq,ncq] -> B3[rows, cols]
                r4 = np.broadcast_to(rows[None, None, :, :], out.shape)
                c4 = np.broadcast_to(cols[s:e, :, None, None], out.shape)
                B3[r4, c4] += out
                m = mirror[s:e]
                if m.any():
                    outm = out[m]
                    B3[np.broadcast_to(rows[None, None, :, :], outm.shape),
                       np.broadcast_to(cols_t[s:e][m][:, :, None, None],
                                       outm.shape)] += outm
    if packed:
        B3[:, -1] = 0.0  # trash column (screened-out scatter target)
        return B3
    return B3.reshape(A, nbf, nbf)


def _pair_bf_indices_flat(block: PairBlock):
    """Flattened per-pair component index arrays [n, nca*ncb]."""
    nca, ncb = block.nbf_block
    ia = block.off_a[:, None, None] + np.arange(nca)[None, :, None]
    ib = block.off_b[:, None, None] + np.arange(ncb)[None, None, :]
    ia = np.broadcast_to(ia, (block.n, nca, ncb)).reshape(block.n, -1)
    ib = np.broadcast_to(ib, (block.n, nca, ncb)).reshape(block.n, -1)
    return ia, ib
