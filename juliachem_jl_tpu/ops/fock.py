"""Conventional (direct-SCF) Fock builders.

Rebuild of the reference's Fock build (SCF.jl:606-1054): instead of walking a
composite triangular quartet index space across ranks/threads with per-quartet
libint calls and a scalar 6-term J/K digestion (SCF.jl:979-1054), quartets are
grouped by angular-momentum class, Schwarz-screened *at setup time* into
static batches, and each batch is digested with dense einsums + scatter-adds
on device.

Symmetry handling: each symmetry-unique quartet (unordered bra pair, unordered
ket pair, unordered pair-of-pairs) carries weight
    v = I / ((1+d_AB)(1+d_CD)(1+d_{AB,CD}))
and is accumulated into non-symmetric J/K workspaces for its four bra-side
images; the final J/K are symmetrized (J + J^T).  This reproduces the
reference's skeleton-Fock + symmetrize scheme (SCF.jl:626-641) in vector form.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.structs import Basis, ncart
from ..models.scf import FockBuilder
from ..utils import memory
from ..utils.timings import JCTC, Timings
from .eri import _eri_kernel, _eri_kernel_body, full_eri_tensor
from .pairs import PairBlock, unique_pair_blocks
from .schwarz import pair_schwarz

DEFAULT_CUTOFF = 1.0e-10  # Schwarz |(ab|cd)| cutoff (reference uses 1e-10, SCF.jl:1011)


class DenseFock(FockBuilder):
    """Full in-memory ERI tensor; correctness reference for small systems."""

    def __init__(self, basis: Basis):
        self.G = jnp.asarray(full_eri_tensor(basis))

    def two_electron_fock(self, D, iteration, timings, C_occ=None):
        D = jnp.asarray(D)
        J = jnp.einsum("pqrs,rs->pq", self.G, D)
        K = jnp.einsum("prqs,rs->pq", self.G, D)
        return np.asarray(J - 0.5 * K)

    def two_electron_jk(self, Da, Db, iteration, timings, Ca=None, Cb=None):
        Dt = jnp.asarray(Da + Db)
        J = jnp.einsum("pqrs,rs->pq", self.G, Dt)
        Ka = jnp.einsum("prqs,rs->pq", self.G, jnp.asarray(Da))
        Kb = jnp.einsum("prqs,rs->pq", self.G, jnp.asarray(Db))
        return np.asarray(J), np.asarray(Ka), np.asarray(Kb)

    def finalize(self):
        self.G = None


@dataclass
class QuartetBatch:
    """A screened batch of symmetry-unique quartets of one class."""

    bra: PairBlock
    ket: PairBlock
    sel_bra: np.ndarray      # [N] indices into bra block
    sel_ket: np.ndarray      # [N]
    weight: np.ndarray       # [N] symmetry weights v
    # flat scatter indices into (nbf*nbf), one per digestion image
    idx_ab: np.ndarray       # [N, nab]
    idx_cd: np.ndarray       # [N, ncd]
    idx_ac: np.ndarray       # [N, nca*ncc]
    idx_ad: np.ndarray       # [N, nca*ncd']
    idx_bc: np.ndarray       # [N, ncb*ncc]
    idx_bd: np.ndarray       # [N, ncb*ncd']


def _pair_bf_indices(block: PairBlock):
    """off arrays [N, nc] for each side of a pair block."""
    nca, ncb = block.nbf_block
    ia = block.off_a[:, None] + np.arange(nca)[None, :]
    ib = block.off_b[:, None] + np.arange(ncb)[None, :]
    return ia, ib


def build_quartet_batches(
    basis: Basis, cutoff: float = DEFAULT_CUTOFF,
    pair_cutoff_scale: float = 1.0e-4, nbf_pad: int | None = None,
) -> tuple[list[QuartetBatch], np.ndarray]:
    """Enumerate Schwarz-screened symmetry-unique quartet batches.

    Returns (batches, Q) where Q is the shell-pair Schwarz matrix.  Screening
    is static per geometry: quartets with Q_ab * Q_cd < cutoff are dropped
    from the batch lists entirely (the reference computes the same bound per
    quartet at SCF.jl:916-933).

    nbf_pad: stride used for the flat scatter indices.  Padding nbf to a
    bucket (128-multiples) makes every digestion kernel shape-identical
    across molecules of similar size, so the compiled class kernels are
    shared system-to-system (and found again in the persistent cache).
    """
    nbf = basis.nbf if nbf_pad is None else nbf_pad
    blocks = unique_pair_blocks(basis)
    qvals = [pair_schwarz(b) for b in blocks]
    qmax = max((q.max() for q in qvals if len(q)), default=1.0)

    # prune negligible pairs outright
    kept: list[PairBlock] = []
    kept_q: list[np.ndarray] = []
    pair_cut = cutoff * pair_cutoff_scale / max(qmax, 1e-30)
    for b, q in zip(blocks, qvals):
        keep = q >= pair_cut
        if keep.any():
            kept.append(b.select(keep))
            kept_q.append(q[keep])

    from .native import screened_quartets

    batches: list[QuartetBatch] = []
    for i, (bra, qb) in enumerate(zip(kept, kept_q)):
        for j in range(i, len(kept)):
            ket, qk = kept[j], kept_q[j]
            same_block = i == j
            r, c = screened_quartets(qb, qk, cutoff, same_block)
            if len(r) == 0:
                continue
            w = np.ones(len(r))
            w *= np.where(bra.ish[r] == bra.jsh[r], 0.5, 1.0)
            w *= np.where(ket.ish[c] == ket.jsh[c], 0.5, 1.0)
            if same_block:
                w *= np.where(r == c, 0.5, 1.0)

            ia, ib = _pair_bf_indices(bra)
            ic, idx_d = _pair_bf_indices(ket)
            ia, ib = ia[r], ib[r]
            ic, idd = ic[c], idx_d[c]

            def flat(u, v):
                # [N, nu] x [N, nv] -> [N, nu*nv] flat (nbf*nbf) indices
                return (u[:, :, None] * nbf + v[:, None, :]).reshape(len(u), -1)

            batches.append(
                QuartetBatch(
                    bra=bra, ket=ket, sel_bra=r, sel_ket=c, weight=w,
                    idx_ab=flat(ia, ib), idx_cd=flat(ic, idd),
                    idx_ac=flat(ia, ic), idx_ad=flat(ia, idd),
                    idx_bc=flat(ib, ic), idx_bd=flat(ib, idd),
                )
            )

    Q = np.zeros((basis.nshell, basis.nshell))
    for b, q in zip(blocks, qvals):
        Q[b.ish, b.jsh] = q
        Q[b.jsh, b.ish] = q
    return batches, Q


def _make_digest_body(la, lb, lc, ld, nbf):
    """Unjitted digestion body: ERI block -> (J_ws, K_ws) flat scatter
    contributions.  Exposed for shard_map tracing (fock_sharded.py)."""
    nca, ncb, ncc, ncd = ncart(la), ncart(lb), ncart(lc), ncart(ld)

    def f(J_ws, K_ws, I, w, D, idx_ab, idx_cd, idx_ac, idx_ad, idx_bc, idx_bd):
        N = I.shape[0]
        I4 = (I * w[:, None, None]).reshape(N, nca, ncb, ncc, ncd)
        Dm = D.reshape(-1)

        def gD(idx, n1, n2):
            return Dm[idx].reshape(N, n1, n2)

        D_cd = gD(idx_cd, ncc, ncd)
        D_ab = gD(idx_ab, nca, ncb)
        # J: 2v (I . D)
        j_ab = 2.0 * jnp.einsum("nabcd,ncd->nab", I4, D_cd)
        j_cd = 2.0 * jnp.einsum("nabcd,nab->ncd", I4, D_ab)
        J_ws = J_ws.at[idx_ab.reshape(-1)].add(j_ab.reshape(-1))
        J_ws = J_ws.at[idx_cd.reshape(-1)].add(j_cd.reshape(-1))
        # K: v (I . D) over the four bra-side images
        k_ac = jnp.einsum("nabcd,nbd->nac", I4, gD(idx_bd, ncb, ncd))
        k_ad = jnp.einsum("nabcd,nbc->nad", I4, gD(idx_bc, ncb, ncc))
        k_bc = jnp.einsum("nabcd,nad->nbc", I4, gD(idx_ad, nca, ncd))
        k_bd = jnp.einsum("nabcd,nac->nbd", I4, gD(idx_ac, nca, ncc))
        K_ws = K_ws.at[idx_ac.reshape(-1)].add(k_ac.reshape(-1))
        K_ws = K_ws.at[idx_ad.reshape(-1)].add(k_ad.reshape(-1))
        K_ws = K_ws.at[idx_bc.reshape(-1)].add(k_bc.reshape(-1))
        K_ws = K_ws.at[idx_bd.reshape(-1)].add(k_bd.reshape(-1))
        return J_ws, K_ws

    return f


def _make_digest(la, lb, lc, ld, nbf):
    """Jitted digestion: ERI block -> (J_ws, K_ws) flat scatter contributions."""
    return jax.jit(_make_digest_body(la, lb, lc, ld, nbf),
                   donate_argnums=(0, 1))


# ------------------------------------------------------- fused v2 digestion
#
# The scatter pattern is static per geometry: each batch becomes ONE jitted
# program — a lax.scan over fixed CH-quartet chunks producing the six J/K
# value streams — followed by one scatter-add of the concatenated streams
# into the flat J/K workspace at targets precomputed on the host.  Direct
# mode folds the ERI class kernel into the same scan (no giant I tensor
# ever materializes); in-core mode scans over the cached ERI chunk stack.

_CH = 2048  # quartets per scan chunk (value streams stay ~CH*nc_img wide)


def _bucket_chunks(n: int) -> int:
    """Round a chunk count up to {p, 1.5p} granularity: bounded pad waste
    (<=33%) with few distinct scan lengths, so the fused kernels are
    compiled once and shared across geometries."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    return (3 * p // 4) if n <= 3 * p // 4 else p


@dataclass
class DigestGroup:
    """Device-resident inputs + scatter targets for one quartet batch."""

    key: tuple
    n_chunks: int
    xs_prim: tuple          # 12 stacked primitive arrays [nc, CH, ...]
    w: object               # [nc, CH]
    idxs: tuple             # 6 int stacked index streams [nc, CH*nc_img]
    targets: object         # [m_pad] int flat J/K target of each value
    m_pad: int = 0          # bucketed value-stream length
    I_stack: object = None  # [nc, CH, nab, ncd] cached ERIs (in-core)
    vol: int = 0            # padded ERI element count


def _build_group(b: QuartetBatch, nbf_pad: int) -> DigestGroup:
    key = (b.bra.la, b.bra.lb, b.ket.la, b.ket.lb,
           b.bra.aexp.shape[1], b.bra.bexp.shape[1],
           b.ket.aexp.shape[1], b.ket.bexp.shape[1])
    n = len(b.sel_bra)
    nc = _bucket_chunks(-(-n // _CH))
    n_pad = nc * _CH
    P2 = nbf_pad * nbf_pad

    def padq(x):
        if n_pad != n:
            x = np.concatenate([x, np.repeat(x[:1], n_pad - n, axis=0)])
        return x

    sb = padq(b.sel_bra)
    sk = padq(b.sel_ket)
    w = np.concatenate([b.weight, np.zeros(n_pad - n)]) if n_pad != n else b.weight

    def stk(x, sel):
        y = x[sel]
        return jnp.asarray(y.reshape((nc, _CH) + y.shape[1:]))

    xs_prim = (
        stk(b.bra.aexp, sb), stk(b.bra.bexp, sb),
        stk(b.bra.acoef, sb), stk(b.bra.bcoef, sb),
        stk(b.bra.A, sb), stk(b.bra.B, sb),
        stk(b.ket.aexp, sk), stk(b.ket.bexp, sk),
        stk(b.ket.acoef, sk), stk(b.ket.bcoef, sk),
        stk(b.ket.A, sk), stk(b.ket.B, sk),
    )

    # J images scatter into JK[0:P2], K images into JK[P2:2*P2].  The six
    # per-image streams concatenate into ONE target stream per group, so
    # each iteration ends in a single scatter call per group.
    idxs, streams = [], []
    for img, base in ((b.idx_ab, 0), (b.idx_cd, 0), (b.idx_ac, P2),
                      (b.idx_ad, P2), (b.idx_bc, P2), (b.idx_bd, P2)):
        stream = padq(img).reshape(n_pad, -1).astype(np.int64)
        streams.append(stream.reshape(-1) + base)
        idxs.append(jnp.asarray(
            stream.reshape(nc, -1).astype(
                np.int32 if P2 < 2**31 else np.int64)))
    all_streams = np.concatenate(streams)
    # value streams zero-pad to a bucketed length so the scatter kernel
    # shape is shared across groups (and geometries); padded values are
    # zero, so their target slot is immaterial
    m_pad = _bucket_chunks(-(-all_streams.size // _CH)) * _CH
    targets = np.zeros(m_pad, np.int32 if 2 * P2 < 2**31 else np.int64)
    targets[:all_streams.size] = all_streams
    nab = b.idx_ab.shape[1]
    ncd = b.idx_cd.shape[1]
    return DigestGroup(key=key, n_chunks=nc, xs_prim=xs_prim,
                       w=jnp.asarray(w.reshape(nc, _CH)), idxs=tuple(idxs),
                       targets=jnp.asarray(targets),
                       m_pad=m_pad, vol=n_pad * nab * ncd)


@partial(jax.jit, donate_argnums=(0,))
def _scatter_into(acc, vals, targets):
    """acc += vals scattered to targets.  Conflicting f64 adds land in an
    order the device chooses, so J/K carry last-bit noise (~1e-14
    relative) from run to run."""
    return acc.at[targets].add(vals)


def _digest_vals_body(nca, ncb, ncc, ncd):
    """Per-chunk value computation shared by the direct/in-core variants."""

    def vals(I, w, Dm, idx_ab, idx_cd, idx_ac, idx_ad, idx_bc, idx_bd):
        N = I.shape[0]
        I4 = (I * w[:, None, None]).reshape(N, nca, ncb, ncc, ncd)

        def gD(idx, n1, n2):
            return Dm[idx.reshape(N, n1, n2)]

        j_ab = 2.0 * jnp.einsum("nabcd,ncd->nab", I4, gD(idx_cd, ncc, ncd))
        j_cd = 2.0 * jnp.einsum("nabcd,nab->ncd", I4, gD(idx_ab, nca, ncb))
        k_ac = jnp.einsum("nabcd,nbd->nac", I4, gD(idx_bd, ncb, ncd))
        k_ad = jnp.einsum("nabcd,nbc->nad", I4, gD(idx_bc, ncb, ncc))
        k_bc = jnp.einsum("nabcd,nad->nbc", I4, gD(idx_ad, nca, ncd))
        k_bd = jnp.einsum("nabcd,nac->nbd", I4, gD(idx_ac, nca, ncc))
        return tuple(x.reshape(x.shape[0], -1)
                     for x in (j_ab, j_cd, k_ac, k_ad, k_bc, k_bd))

    return vals


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _fused_digest_direct(la, lb, lc, ld, Ka, Kb, Kc, Kd, m_pad):
    """Direct-mode program per class: scan(ERI kernel + digestion) -> one
    zero-padded value stream (no giant I tensor ever materializes)."""
    eri_f = _eri_kernel_body(la, lb, lc, ld, Ka, Kb, Kc, Kd)
    vals_f = _digest_vals_body(ncart(la), ncart(lb), ncart(lc), ncart(ld))

    def run(D, w, idxs, xs_prim):
        Dm = D.reshape(-1)

        def body(_, xs):
            wc, idx6, prim = xs
            return 0, vals_f(eri_f(*prim), wc, Dm, *idx6)

        _, ys = jax.lax.scan(body, 0, (w, idxs, xs_prim))
        v = jnp.concatenate([y.reshape(-1) for y in ys])
        return jnp.pad(v, (0, m_pad - v.size))

    return jax.jit(run)


@_lru_cache(maxsize=None)
def _digest_incore(nca, ncb, ncc, ncd, m_pad):
    """In-core digestion per *component-shape* class (keys collapse across
    contraction patterns): scan over the cached ERI chunk stack -> one
    zero-padded value stream.  Kept free of the ERI body and of the
    reduction so the compiled graph is small and shared."""
    vals_f = _digest_vals_body(nca, ncb, ncc, ncd)

    def run(D, w, idxs, I_stack):
        Dm = D.reshape(-1)

        def body(_, xs):
            wc, idx6, I = xs
            return 0, vals_f(I, wc, Dm, *idx6)

        _, ys = jax.lax.scan(body, 0, (w, idxs, I_stack))
        v = jnp.concatenate([y.reshape(-1) for y in ys])
        return jnp.pad(v, (0, m_pad - v.size))

    return jax.jit(run)


def _incore_budget() -> int:
    """In-core ERI budget in f64 elements."""
    import os
    env = os.environ.get("JCHEM_INCORE_BUDGET")
    if env:
        return int(float(env))
    return memory.budget_elements("incore_eri")


class ScreenedDirectFock(FockBuilder):
    """Class-batched, Schwarz-screened direct Fock build (the conventional
    path below the streaming threshold; replaces SCF.jl:665-1054).

    One fused jitted program per quartet batch per iteration (scan over
    CH-quartet chunks + one scatter-add; see the v2 digestion notes
    above).

    incore: cache the screened ERI chunk stacks after the first build and
    reuse them every iteration (in-core SCF — a capability the reference
    lacks; it is direct-only).  Auto-enabled when the screened integral
    volume fits the budget."""

    def __init__(self, basis: Basis, cutoff: float = DEFAULT_CUTOFF,
                 chunk: int = _CH, incore: bool | None = None):
        self.basis = basis
        self.nbf = basis.nbf
        # bucket nbf so digestion kernels are shared across molecules
        self.nbf_pad = -(-basis.nbf // 128) * 128
        self.batches, self.Q = build_quartet_batches(
            basis, cutoff, nbf_pad=self.nbf_pad)
        self.groups = [_build_group(b, self.nbf_pad) for b in self.batches]
        if incore is None:
            incore = sum(g.vol for g in self.groups) <= _incore_budget()
        self.incore = incore

    def _fill_incore(self, g: DigestGroup):
        """Cache the ERI chunk stack for one group.

        On the CPU backend the class kernel is evaluated with numpy on the
        host (zero XLA compiles — each fresh process otherwise pays ~10-40 s
        per class kernel on the 1-core CPU backend); elsewhere via the shared
        jitted per-class ERI kernel (no extra compiled program)."""
        if jax.default_backend() == "cpu":
            eri_np = _eri_kernel_body(*g.key)
            xs = [np.asarray(x) for x in g.xs_prim]
            first = eri_np(*(x[0] for x in xs))
            stack = np.empty((g.n_chunks,) + first.shape, dtype=first.dtype)
            stack[0] = first
            for c in range(1, g.n_chunks):
                stack[c] = eri_np(*(x[c] for x in xs))
            g.I_stack = jnp.asarray(stack)
            return
        kern = _eri_kernel(*g.key)
        parts = [kern(*(x[c] for x in g.xs_prim)) for c in range(g.n_chunks)]
        g.I_stack = jnp.stack(parts)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None):
        J, K = self.jk_halves(D, iteration, timings)
        return np.asarray(J - 0.5 * K)

    def two_electron_jk(self, Da, Db, iteration, timings: Timings,
                        Ca=None, Cb=None):
        """UHF interface: (J(Dt), K(Da), K(Db)) from TWO digestion passes.

        The digestion computes J and K streams for one symmetric density;
        both are linear in D, so the spin-resolved exchanges come from the
        total and spin-difference densities:
        K(Da) = [K(Dt) + K(Ds)]/2,  K(Db) = [K(Dt) - K(Ds)]/2."""
        Dt = np.asarray(Da) + np.asarray(Db)
        J, Kt = self.jk_halves(Dt, iteration, timings)
        if np.array_equal(Da, Db):  # closed-shell channel: one pass suffices
            Ka = Kb = 0.5 * Kt
        else:
            _, Ks = self.jk_halves(np.asarray(Da) - np.asarray(Db),
                                   iteration, timings)
            Ka = 0.5 * (Kt + Ks)
            Kb = 0.5 * (Kt - Ks)
        return np.asarray(J), np.asarray(Ka), np.asarray(Kb)

    def jk_halves(self, D, iteration, timings: Timings):
        """Digest one symmetric density into (J, K) such that the RHF
        two-electron part is J - 0.5 K (both symmetrized, DenseFock
        index convention)."""
        import os
        import time as _time

        debug = os.environ.get("JCHEM_FOCK_DEBUG") and iteration <= 1
        nbf, nbf_pad = self.nbf, self.nbf_pad
        P2 = nbf_pad * nbf_pad
        D = jnp.asarray(D)
        if nbf_pad != nbf:
            D = jnp.pad(D, ((0, nbf_pad - nbf), (0, nbf_pad - nbf)))
        JK = jnp.zeros(2 * P2)
        for g in self.groups:
            if debug:
                _t0 = _time.time()
            if self.incore:
                if g.I_stack is None:
                    self._fill_incore(g)
                la, lb, lc, ld = g.key[:4]
                vals = _digest_incore(
                    ncart(la), ncart(lb), ncart(lc), ncart(ld),
                    g.m_pad)(D, g.w, g.idxs, g.I_stack)
            else:
                vals = _fused_digest_direct(*g.key, g.m_pad)(
                    D, g.w, g.idxs, g.xs_prim)
            JK = _scatter_into(JK, vals, g.targets)
            if debug:
                JK.block_until_ready()
                print(f"# fock group {g.key} m_pad={g.m_pad} nc={g.n_chunks}"
                      f" {_time.time() - _t0:.2f}s", flush=True)
        JK = np.asarray(JK)
        J = JK[:P2].reshape(nbf_pad, nbf_pad)[:nbf, :nbf]
        K = JK[P2:].reshape(nbf_pad, nbf_pad)[:nbf, :nbf]
        J = J + J.T
        K = K + K.T
        return J, K

    def finalize(self):
        for g in self.groups:
            g.I_stack = None
