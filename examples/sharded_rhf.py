"""Multi-device (sharded) RHF / DF-RHF run.

The analog of the reference's MPI launch scripts
(example_inputs/Water/7_6/w7.6_112thread.sh, test/perlmutter_gpu.sh):
instead of mpiexec ranks x GPUs, pass `num_devices` in the SCF keywords and
the Fock build runs as one shard_map over a jax.sharding.Mesh —
  scf_type "df"  -> packed screened-pq B sharded on ("q","k"),
                    psum-reduced J/K (models/df_sharded.py)
  scf_type "rhf" -> quartet batches sharded over the mesh
                    (ops/fock_sharded.py)
On several hosts, juliachem_jl_tpu.initialize() brings up
jax.distributed automatically (parallel/mesh.py::initialize_distributed).

Try it without GPUs on a virtual 8-device CPU mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/sharded_rhf.py input.json 8
"""
import sys

import juliachem_jl_tpu as jc


def sharded_rhf(input_file, num_devices):
    jc.initialize()
    spec = jc.io.read_input(input_file, output=1)
    mol = jc.molecule.run(spec, output=1)
    basis_sets = jc.basis.run(mol, spec.model, output=1)
    flags = dict(spec.scf_keywords)
    flags["num_devices"] = num_devices
    scf = jc.models.rhf.energy(mol, basis_sets, flags, output=2)
    jc.finalize()
    return scf


if __name__ == "__main__":
    import jax

    n = int(sys.argv[2]) if len(sys.argv) > 2 else len(jax.devices())
    sharded_rhf(sys.argv[1], n)
