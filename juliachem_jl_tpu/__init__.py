"""juliachem_jl_tpu — a quantum chemistry framework in JAX, run on GPUs.

A from-scratch rebuild of the capabilities of JuliaChem.jl (j-hayes fork):
restricted Hartree-Fock (conventional direct-SCF and density-fitted Fock
builds), Schwarz screening, DIIS/damped convergence, hcore/SAD/DF guesses,
molecular properties (Mulliken, dipole, MO energies, formation energies) and a
QCSchema-style JSON driver — built as batched array programs in JAX/XLA:

* Gaussian integrals are batched dense McMurchie-Davidson kernels over padded
  angular-momentum classes (replacing the reference's per-shell-quartet Libint
  C++ calls, ``deps/src/jeri-tei.hpp``).
* J/K digestion and all density-fitting contractions are dense einsums
  (replacing BLAS/CUBLAS calls in ``src/rhf/energy/DensityFitting/*.jl``).
* Distribution is SPMD over a ``jax.sharding.Mesh`` with psum/all_gather
  collectives (replacing the MPI rank/thread decomposition of
  ``src/rhf/energy/SCF.jl`` and ``DensityFitting/DynamicLoad.jl``).

Public API mirrors the reference's module sequence
(``JuliaChem.initialize / JCInput.run / JCBasis.run / JCMolecule.run /
JCRHF.Energy.run / JCRHF.Properties.run / JuliaChem.finalize``, see
the reference's ``example_scripts/full-rhf-repl.jl``).
"""

from . import config  # noqa: F401  (enables x64 — must run before any jax use)

__version__ = "0.1.0"

from .utils import constants  # noqa: E402
from .utils.timings import Timings  # noqa: E402
from . import io  # noqa: E402
from . import molecule  # noqa: E402
from . import basis  # noqa: E402
from . import models  # noqa: E402
from . import driver  # noqa: E402
from .driver import run_file, run_spec  # noqa: E402

_initialized = False


def initialize(force: bool = False) -> None:
    """Lifecycle entry; mirrors JuliaChem.initialize() (src/runtime/JCRuntime.jl:6-16).

    The reference initializes MPI and Libint here.  In the JAX rebuild there is
    no global C library state; this is an idempotent no-op that warms up the
    device backend, kept for API parity.
    """
    global _initialized
    if _initialized and not force:
        import warnings

        warnings.warn("juliachem_jl_tpu.initialize() called twice", stacklevel=2)
        return
    import jax

    # multi-host runtime bring-up when a cluster environment is
    # present — the MPI.Init() analog (no-op single-host)
    from .parallel.mesh import initialize_distributed

    initialize_distributed()
    jax.devices()  # touch the backend
    _initialized = True


def finalize() -> None:
    """Lifecycle exit; mirrors JuliaChem.finalize() (src/runtime/JCRuntime.jl:20-32)."""
    global _initialized
    _initialized = False


def reset() -> None:
    """Clear cached compiled executables (useful for benchmarking cold starts)."""
    import jax

    jax.clear_caches()
