"""Density-fitted (RI) Fock build.

Rebuild of DensityFitting/DensityFitting.jl + ScreenedDF.jl as dense
einsums (cuBLAS DGEMM on the card):

  iteration 1 (setup):
    (P|Q) metric, L = chol(P|Q)                 [form_J_AB_inv analog]
    (Q|mu nu) 3-center tensor (Schwarz-masked)  [ThreeCenterIntegrals analog]
    B = L^{-1} (Q|mu nu)                        [calculate_B analog]
  every iteration:
    V_Q = sum_{mn} B[Q,m,n] D[m,n];  J = sum_Q B[Q] V_Q
    W[Q,i,n] = sum_m B[Q,m,n] C_occ[m,i]       [calculate_W analog]
    G = J - sum_{Q,i} W W^T                     [J - K/2 with D = 2 C C^T]

The whole per-iteration build is one jitted function; on a device mesh the Q
axis is sharded and J/K partials are psum-reduced (parallel/shard.py), the
direct analog of the reference's rank-partitioned B with MPI.Allreduce!
(DensityFitting.jl:68-71).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from ..ops import eri3c, schwarz
from ..ops.pairs import unique_pair_blocks
from ..utils.timings import JCTC, Timings
from .scf import FockBuilder


def screened_pair_blocks(primary, sigma: float, metric_diag_max: float):
    """Apply the DF screening criterion (Huang et al. 2020; reference
    SchwarzScreening.jl:1-8): drop shell pair ab if
    (ab|ab) < sigma^2 / max_P (P|P)."""
    from ..ops.native import df_pair_mask

    blocks = unique_pair_blocks(primary)
    out = []
    for b in blocks:
        q = schwarz.pair_schwarz(b)          # sqrt(max (ab|ab))
        keep = df_pair_mask(q, sigma, metric_diag_max)
        if keep.any():
            out.append(b.select(keep))
    return out


def build_B(primary, aux, opts=None, timings: Timings | None = None) -> np.ndarray:
    """The fitted 3-index tensor B[Q, mu, nu] with metric folded in
    (calculate_B analog, ScreenedDF.jl:98-105)."""
    timings = timings or Timings()
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux)
    sigma = getattr(opts, "df_screening_sigma", 1e-5) if opts is not None else 1e-5
    screen = getattr(opts, "df_screen_exchange", True) if opts is not None else True
    with timings.timed(JCTC.screening_time):
        pair_blocks = (
            screened_pair_blocks(primary, sigma, float(np.diag(metric).max()))
            if screen else None
        )
    with timings.timed(JCTC.three_center_time):
        P3 = eri3c.three_center_tensor(primary, aux, pair_blocks,
                                       timings=timings)
    with timings.timed(JCTC.B_time):
        from .linalg import fold_metric

        A, nbf = aux.nbf, primary.nbf
        B = P3.reshape(A, -1)
        if not (isinstance(B, np.ndarray) and B.flags.writeable
                and B.flags.c_contiguous):
            B = np.array(B)
        from ..basis.spherical import (aux_needs_sph, project_metric_sph,
                                       project_rows_sph)

        if (getattr(opts, "df_spherical_aux", True) if opts is not None
                else True) and aux_needs_sph(aux):
            metric = project_metric_sph(aux, metric)
            B = project_rows_sph(aux, B)
        fold_metric(metric, B)
    return B.reshape(B.shape[0], nbf, nbf)


# float32 products (the mixed-precision phase) would otherwise be free to
# run in TF32 on the card; f64 products are unaffected
HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def df_fock_kernel(B, D, Cocc):
    """G = J - K/2 from the fitted tensor; all contractions matmul-shaped."""
    A, nbf = B.shape[0], B.shape[1]
    Bm = B.reshape(A, nbf * nbf)
    V = jnp.matmul(Bm, D.reshape(-1), precision=HIGHEST)      # [A]
    J = jnp.matmul(V, Bm, precision=HIGHEST).reshape(nbf, nbf)
    W = jnp.einsum("qmn,mi->qin", B, Cocc,
                   precision=HIGHEST)                        # [A, occ, nbf]
    Wm = W.reshape(-1, nbf)
    Khalf = jnp.matmul(Wm.T, Wm, precision=HIGHEST)  # = K/2, D = 2 C C^T
    return J - Khalf


@jax.jit
def df_j_kernel(B, Dt):
    """Coulomb from the total density (UHF shares one V_Q per iteration)."""
    A, nbf = B.shape[0], B.shape[1]
    Bm = B.reshape(A, nbf * nbf)
    V = Bm @ Dt.reshape(-1)
    return (V @ Bm).reshape(nbf, nbf)


@jax.jit
def df_k_kernel(B, C):
    """Exchange K(C C^T) from occupied (or factor) orbitals [nbf, k]."""
    nbf = B.shape[1]
    W = jnp.einsum("qmn,mi->qin", B, C)
    Wm = W.reshape(-1, nbf)
    return Wm.T @ Wm


@jax.jit
def df_fock_kernel_signed(B, D, Cocc, s):
    """G = J - K/2 for a possibly *indefinite* D factorized as
    D = 2 sum_k s_k c_k c_k^T with s_k = ±1 (incremental-Fock dD is
    indefinite; K is linear in D so K[dD] = K[dD+] - K[dD-])."""
    A, nbf = B.shape[0], B.shape[1]
    Bm = B.reshape(A, nbf * nbf)
    V = Bm @ D.reshape(-1)
    J = (V @ Bm).reshape(nbf, nbf)
    W = jnp.einsum("qmn,mi->qin", B, Cocc)
    Ws = W * s[None, :, None]
    Khalf = jnp.einsum("qim,qin->mn", Ws, W)
    return J - Khalf


@jax.jit
def df_fock_kernel_f32(B32, D, Cocc):
    """f32 path for early SCF iterations (mixed-precision SCF).

    Far from convergence the Fock matrix only needs ~1e-4 accuracy, so the
    J/K contractions may run in f32 (full f32 products, never TF32).  The
    driver guarantees the final iterations (and hence the converged
    energy) run in f64.
    """
    G32 = df_fock_kernel(B32, D.astype(jnp.float32), Cocc.astype(jnp.float32))
    return G32.astype(jnp.float64)


class DFFockBuilder(FockBuilder):
    """Dense (single-device) DF Fock builder — the analog of the
    reference's DenseGPUDF.jl path, with screening applied to the 3-center
    build."""

    def __init__(self, primary, auxiliary, opts=None, timings: Timings | None = None):
        self.primary = primary
        self.aux = auxiliary
        self.nbf = primary.nbf
        self.B = jnp.asarray(build_B(primary, auxiliary, opts, timings))
        self.mixed = bool(getattr(opts, "mixed_precision", False))
        self.B32 = self.B.astype(jnp.float32) if self.mixed else None
        self.supports_f32_phase = self.mixed

    def _signed_factor(self, D):
        """Signed eigen-factorization D = 2 sum_k s_k c_k c_k^T, s_k = ±1.

        Correct for indefinite D (incremental-Fock density differences),
        where keeping only positive eigenvalues silently drops the negative
        exchange contributions.  Columns are padded to a multiple of 32 so
        rank changes across fdiff iterations don't force recompiles."""
        w, U = np.linalg.eigh(np.asarray(D))
        keep = np.abs(w) > 1e-12
        wk, Uk = w[keep], U[:, keep]
        C = Uk * np.sqrt(0.5 * np.abs(wk))[None, :]
        s = np.sign(wk)
        k = C.shape[1]
        kp = -(-max(k, 1) // 32) * 32
        if kp != k:
            C = np.pad(C, ((0, 0), (0, kp - k)))
            s = np.pad(s, (0, kp - k))
        return jnp.asarray(C), jnp.asarray(s)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        if C_occ is None:
            # C-free entry (SAD guess, or an indefinite fdiff dD)
            Cs, s = self._signed_factor(D)
            return np.asarray(
                df_fock_kernel_signed(self.B, jnp.asarray(D), Cs, s))
        Cocc = jnp.asarray(C_occ)
        if precision == "f32" and self.B32 is not None:
            return np.asarray(df_fock_kernel_f32(self.B32, jnp.asarray(D), Cocc))
        return np.asarray(df_fock_kernel(self.B, jnp.asarray(D), Cocc))

    def two_electron_jk(self, Da, Db, iteration, timings: Timings, Ca=None,
                        Cb=None):
        """UHF interface: J from one shared V_Q of the total density; K per
        spin from W_sigma = B C_sigma (or a PSD eigen-factor of D_sigma on
        guess iterations where no C is available)."""
        J = df_j_kernel(self.B, jnp.asarray(Da + Db))

        def K_of(Ds, Cs):
            if Cs is None:
                w, U = np.linalg.eigh(np.asarray(Ds))
                keep = w > 1e-12
                Cs = U[:, keep] * np.sqrt(w[keep])[None, :]
                k = Cs.shape[1]
                kp = -(-max(k, 1) // 32) * 32   # pad: stable kernel shapes
                if kp != k:
                    Cs = np.pad(Cs, ((0, 0), (0, kp - k)))
            return df_k_kernel(self.B, jnp.asarray(Cs))

        Ka = K_of(Da, Ca)
        Kb = Ka if (Ca is None and Cb is None and np.array_equal(Da, Db)) \
            else K_of(Db, Cb)
        return np.asarray(J), np.asarray(Ka), np.asarray(Kb)

    def finalize(self):
        self.B = None
        self.B32 = None
