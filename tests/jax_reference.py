"""How the port's tests compile the JAX package's reference computations.

A test runs each jitted JAX reference once, so its compile time is the
test's cost. `reference_jit` compiles with LLVM at -O0: for one SMPL
physics step on one CPU core that halves XLA's compile (22 s to 11 s,
jax 0.9), while the HLO passes run as before. The float32 rounding can
move by an ulp, so a test that holds the port to the JAX package's exact
bits, or below what the default build's rounding allows, keeps `jax.jit`
(`test_torch_domain_rand.py`'s exact DR observation, `test_torch_task.py`'s
traj vertices at 4e-6; splitting that file's jit to build its other two
steps at -O0 saved nothing). No tolerance changes.
"""

import jax

REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


def reference_jit(fun, **kwargs):
    """`jax.jit` for a reference computation that runs once."""
    return jax.jit(fun, compiler_options=REFERENCE_COMPILER_OPTIONS, **kwargs)
