"""Dense linear algebra for the SCF: orthogonalization, Roothaan step, DIIS.

Replaces the reference's LAPACK usage (eigen/potrf/trtri/sysv) in
src/rhf/energy/SCF.jl:141-162,1072-1125 and EnergyHelpers.DIIS
(EnergyHelpers.jl:234-258).  All O(mu^3) steps run as XLA ops in f64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import memory

# below this flop count the host dgemm beats the device round trip (and a
# compile); above it the device DGEMM wins
_HOST_SOLVE_FLOPS = 5.0e10
# fixed device chunk/pad sizes so the matmul kernel shape — and hence its
# compilation — is shared across systems
_COL_CHUNK = 16384
_ROW_BUCKET = 256


def triangular_inverse(L: np.ndarray) -> np.ndarray:
    """L^{-1} for lower-triangular L via LAPACK dtrtri (host, f64)."""
    from scipy.linalg.lapack import dtrtri

    Linv, info = dtrtri(np.asarray(L, dtype=np.float64, order="F"), lower=1)
    if info != 0:
        import scipy.linalg as sla

        Linv = sla.solve_triangular(L, np.eye(L.shape[0]), lower=True)
    return Linv


# f64 B: compute in f64 — the fold matrix carries cond(metric)^(1/2)
# dynamic range, and a plain f32 matmul loses ~sqrt(cond) * eps_f32
# (measured: 6.6e-4 Eh on 4 waters / 6-31+G* / cc-pVTZ-JKFIT, whose
# metric cond is 1.9e11).
_linv_matmul = jax.jit(
    lambda Li, X: (Li @ X.astype(Li.dtype)).astype(X.dtype))

# f32 B: two-float (split) fold — M = M_hi + M_lo with both parts f32
# represents the fold matrix to ~2^-46 relative, so the sqrt(cond)
# operand amplification above vanishes; what remains is f32 ACCUMULATION
# noise (~sqrt(A)*eps_f32 ~ 4e-6 relative on the output, not
# cond-amplified).  Cost: two f32 matmuls instead of one f64 matmul.
_split_matmul = jax.jit(
    lambda Mh, Ml, X: jax.lax.add(
        jax.lax.dot(Mh, X, precision=jax.lax.Precision.HIGHEST),
        jax.lax.dot(Ml, X, precision=jax.lax.Precision.HIGHEST)))


def _fold_block_shape(Ap: int, budget: float):
    """(row_block R, col_chunk C) for the fold matmul M[R,Ap] @ X[Ap,C]:
    the largest tiles whose operands and output (R*Ap + Ap*C + R*C
    elements) fit ``budget`` elements.  All row blocks share one shape (R
    divides the padded row count evenly) so a single compiled kernel serves
    the whole fold."""
    # columns first: bound the X operand to ~a third of the budget
    C = min(_COL_CHUNK, int(budget / (3 * Ap)))
    C = max(_ROW_BUCKET, (C // _ROW_BUCKET) * _ROW_BUCKET)
    rem = budget - Ap * C
    r_max = int(rem / (Ap + C))
    if r_max >= Ap:
        return Ap, C
    r_allowed = max(_ROW_BUCKET, (r_max // _ROW_BUCKET) * _ROW_BUCKET)
    n_blocks = -(-Ap // r_allowed)
    R = -(-Ap // (n_blocks * _ROW_BUCKET)) * _ROW_BUCKET
    return R, C


def apply_triangular_inverse(L: np.ndarray, B: np.ndarray) -> np.ndarray:
    """In-place B <- L^{-1} B for lower-triangular L (the DF metric fold,
    calculate_B analog — ScreenedDF.jl:98-105).

    Strategy: explicit L^{-1} on host LAPACK (exact f64; cond(L) =
    sqrt(cond(metric)) keeps the inverse-application error ~cond*eps, well
    under integral accuracy), applied as a plain device DGEMM (the
    reference's CUSOLVER trtri + CUBLAS trmm route).  Small systems stay
    entirely on host (dgemm beats the device round trip below ~5e10 flops).

    f32 B (the split-fold path in _apply_square): the raw L^{-1} carries
    sqrt(cond(metric)) cancellation (JKFIT metrics on diffuse bases reach
    cond ~1e11), which amplifies f32 accumulation noise to ~2e-4 Eh
    (measured, 4 waters).  Jacobi row equilibration fixes it EXACTLY:
    with d_i = ||L[i,:]|| = sqrt(J_ii), L = D Ls with Ls row-normalized,
    so L^{-1} B = Ls^{-1} (D^{-1} B) — the diagonal part applies in exact
    elementwise arithmetic and the matmul operand Ls^{-1} has the cond of
    the Jacobi-scaled metric (van der Sluis: near-optimal among diagonal
    scalings), orders of magnitude smaller.
    """
    if B.dtype == np.float32:
        d = np.sqrt(np.einsum("ij,ij->i", L, L))
        Ls = L / d[:, None]
        B *= (1.0 / d)[:, None].astype(np.float32)
        return _apply_square(triangular_inverse(Ls), B)
    return _apply_square(triangular_inverse(L), B)


def _apply_square(M: np.ndarray, B: np.ndarray) -> np.ndarray:
    """In-place B <- M B for a square [A, A] fold matrix, blocked over
    rows AND columns through the device matmul above the host-dgemm
    crossover, so no tile outgrows the "fold_tile" share of device memory.
    Runs in B's dtype: an f32 B folds in f32 and moves f32 bytes both
    ways."""
    A, ncols = B.shape
    if 2.0 * A * A * ncols < _HOST_SOLVE_FLOPS:
        # host: f64 dgemm, downcast on assignment when B is f32
        B[...] = M @ B.astype(np.float64, copy=False)
        return B
    import os

    # JCHEM_SPLIT_FOLD=1 opts an f32 B into the two-float split fold.
    # Off by default:
    # f32 ACCUMULATION noise is ~sqrt(A)*eps_f32*||M_row|| regardless of
    # operand splitting — measured on waters/6-31+G*/cc-pVTZ-JKFIT
    # (Jacobi-equilibrated, vs the f64 fold): -1.1e-4 Eh at w4, -5.7e-4
    # at w8 — a throughput option for w64-class feasibility runs, not for
    # golden-gated energies (DF gate 1.5e-3 Eh).
    split = (B.dtype == np.float32
             and os.environ.get("JCHEM_SPLIT_FOLD", "0") == "1")
    Ap = -(-A // _ROW_BUCKET) * _ROW_BUCKET
    R, C = _fold_block_shape(Ap, memory.budget_elements("fold_tile"))
    # M row blocks stay device-resident across the whole fold (one h2d)
    Mp = np.zeros((Ap, Ap))
    Mp[:A, :A] = M

    def _rows(Mfull):
        return [jnp.asarray(Mfull[r:r + R]) if r + R <= Ap
                else jnp.asarray(np.vstack(
                    [Mfull[r:], np.zeros((r + R - Ap, Ap),
                                         dtype=Mfull.dtype)]))
                for r in range(0, Ap, R)]

    if split:
        Mhi = Mp.astype(np.float32)
        Mlo = (Mp - Mhi).astype(np.float32)
        M_rows = list(zip(_rows(Mhi), _rows(Mlo)))
    else:
        M_rows = _rows(Mp)
    del Mp
    import sys
    import time as _time

    t0 = _time.time()
    last_beat = [t0]
    n_chunks = -(-ncols // C)

    def _beat(chunk, block):
        # progress at least once a minute on long folds
        now = _time.time()
        if now - last_beat[0] >= 60.0:
            last_beat[0] = now
            print(f"# fold chunk {chunk}/{n_chunks} block "
                  f"{block}/{len(M_rows)} t={now - t0:.0f}s",
                  file=sys.stderr, flush=True)

    buf = np.zeros((Ap, C), dtype=B.dtype)
    for s in range(0, ncols, C):
        w = min(C, ncols - s)
        buf[:A, :w] = B[:, s:s + w]
        if w < C:
            buf[:, w:] = 0.0
        Xj = jnp.asarray(buf)
        for i, Mr in enumerate(M_rows):
            if split:
                out = np.asarray(_split_matmul(Mr[0], Mr[1], Xj))
            else:
                out = np.asarray(_linv_matmul(Mr, Xj))
            r0 = i * R
            r1 = min(r0 + R, A)
            if r0 < A:
                B[r0:r1, s:s + w] = out[: r1 - r0, :w]
            _beat(s // C + 1, i + 1)
    return B


# (min(diag L) / max(diag L))^2 below this marks the metric numerically
# singular: the Cholesky factor's inverse would amplify integral noise by
# ~1/ratio.  Generated (AutoAux) auxiliary sets on N-rich systems reach
# cond ~1e17 (S22 S01: min eig 5.7e-15, deterministic garbage SCF energies
# ~-4.6e13 / NaN through the plain-Cholesky fold); real JKFIT tables sit
# around 1e5-1e8 and keep the fast path.
_METRIC_DIAG_RATIO2 = 1e-12


def fold_metric(metric: np.ndarray, B: np.ndarray,
                lindep_thresh: float = 1e-10) -> np.ndarray:
    """In-place DF metric fold B <- f(J) B with conditioning-aware f.

    Healthy metric: f = L^{-1} (Cholesky, the reference's route —
    ScreenedDF.jl:98-105).  Numerically singular metric (near-dependent
    auxiliary functions, the AutoAux failure mode): f = the symmetric
    pseudo-inverse square root V_k diag(w_k^{-1/2}) V_k^T with eigenvalues
    below ``lindep_thresh * w_max`` dropped — the same canonical-
    orthogonalization filtering the SCF applies to S (SCF.jl:141-162),
    here shape-preserving so packed, dense and mesh-sharded B layouts are
    untouched (dropped directions become exact zero rows of B, which add
    nothing to J/K/MP2 sums over Q).
    """
    try:
        L = np.linalg.cholesky(metric)
        d = np.diag(L)
        if (d.min() / d.max()) ** 2 >= _METRIC_DIAG_RATIO2:
            return apply_triangular_inverse(L, B)
    except np.linalg.LinAlgError:
        pass
    import warnings

    w, V = np.linalg.eigh(metric)
    keep = w >= lindep_thresh * w[-1]
    warnings.warn(
        f"DF metric numerically singular (min eig {w[0]:.2e}, max "
        f"{w[-1]:.2e}); folding with pseudo-inverse sqrt, dropping "
        f"{int((~keep).sum())}/{len(w)} auxiliary directions", stacklevel=2)
    Vk = V[:, keep]
    M = (Vk / np.sqrt(w[keep])[None, :]) @ Vk.T
    return _apply_square(M, B)


def orthogonalizer(S: np.ndarray, lindep_thresh: float = 1.0e-6):
    """Canonical orthogonalization X = U_f s_f^{-1/2}.

    Eigenvalues below ``lindep_thresh`` are dropped to remove linear
    dependencies, exactly as the reference filters them (SCF.jl:141-162).
    Returns X with shape (nbf, nmo), nmo <= nbf.
    """
    s, U = np.linalg.eigh(S)
    keep = s >= lindep_thresh
    return U[:, keep] / np.sqrt(s[keep])[None, :]


def roothaan_step(F, X, nocc: int):
    """One Roothaan-Hall iteration (reference ``iteration()``, SCF.jl:1072-1125).

    F' = X^T F X; eigh -> (eps, C'); C = X C'; D = 2 C_occ C_occ^T.
    Returns (eps, C, D).

    The eigensolve runs on host LAPACK, whose eigenvectors carry residuals
    near 1e-13; the O(mu^3) cost is small against the Fock build.  Whether
    an on-card eigensolve would pay has not been measured.
    """
    F = np.asarray(F)
    X = np.asarray(X)
    Fp = X.T @ F @ X
    eps, Cp = np.linalg.eigh(Fp)
    C = X @ Cp
    Cocc = C[:, :nocc]
    D = 2.0 * (Cocc @ Cocc.T)
    return eps, C, D


class DIIS:
    """Pulay DIIS on the commutator error e = F D S - S D F.

    Mirrors the reference (error push at SCF.jl:472-501, solve in
    EnergyHelpers.jl:234-258: B c = rhs via LAPACK sysv, F = sum c_i F_i).
    """

    def __init__(self, max_vec: int = 8):
        self.max_vec = max_vec
        self.F_hist: list[np.ndarray] = []
        self.e_hist: list[np.ndarray] = []

    def push(self, F: np.ndarray, e: np.ndarray) -> None:
        self.F_hist.append(np.asarray(F))
        self.e_hist.append(np.asarray(e))
        if len(self.F_hist) > self.max_vec:
            self.F_hist.pop(0)
            self.e_hist.pop(0)

    @property
    def size(self) -> int:
        return len(self.F_hist)

    def extrapolate(self) -> np.ndarray:
        n = self.size
        if n == 1:
            return self.F_hist[0]
        B = np.empty((n + 1, n + 1))
        B[:n, :n] = np.array(
            [[np.vdot(ei, ej) for ej in self.e_hist] for ei in self.e_hist]
        )
        B[n, :] = -1.0
        B[:, n] = -1.0
        B[n, n] = 0.0
        rhs = np.zeros(n + 1)
        rhs[n] = -1.0
        try:
            c = np.linalg.solve(B, rhs)
        except np.linalg.LinAlgError:
            c = np.linalg.lstsq(B, rhs, rcond=None)[0]
        F = np.zeros_like(self.F_hist[0])
        for ci, Fi in zip(c[:n], self.F_hist):
            F += ci * Fi
        return F


def damping_factor(delta_e: float) -> float:
    """Dynamic damping weight (reference SCF.jl:504-505): for |dE| >= 1,
    F <- x F + (1-x) F_old with x = 1/log_50(50 |dE|)."""
    de = abs(delta_e)
    if de < 1.0:
        return 1.0
    return 1.0 / (np.log(50.0 * de) / np.log(50.0))
