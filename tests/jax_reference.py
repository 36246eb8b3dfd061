"""How the port's tests compile the JAX package's reference computations.

A test runs each jitted JAX reference once, so its compile time is the
test's cost. `reference_jit` compiles with LLVM at -O0: for one SMPL
physics step on one CPU core that halves XLA's compile (22 s to 11 s,
jax 0.9), while the HLO passes run as before. It also emits the fusions
through XLA:CPU's legacy elemental emitter instead of its MLIR fusion
emitters: the same -O0 step then compiles in 9.3 s instead of 17.3 s
(jax 0.9, one core) with bitwise the same outputs. The float32 rounding
against the default build can move by an ulp, so a test that holds the
port to the JAX package's exact bits, or below what the default build's
rounding allows, keeps `jax.jit` (`test_torch_task.py`'s traj task state;
`test_torch_eval.py`'s free rollouts, whose accel_dist moves 14%); their
eager set-up runs inside `reference_compiles()` where what it feeds the
comparison stays the same (the task test's JAX store, which both packages
read, and its reset draws and AMP windows, equal to the bit; the eval
test's env tables, which its metrics do not read). No tolerance changes.

`reference_compiles` does the same for every XLA compile inside a block:
the jits the JAX package makes itself (the motion store's per-group
programs) and the one-op programs of eager JAX (an env's constructor builds
its model, store and AMP tables with ~400 of them, each compiled at -O2 by
default). On leaving the block it drops JAX's in-memory executables, so
that nothing compiled at -O0 is reused outside it (a pytest worker runs the
JAX package's own tests in the same process); the persistent cache keys
hold the compile options, so it keeps the two builds apart.
`module_reference_compiles()`, assigned to a name in a test module, makes
that module's whole run such a block; the modules whose eager JAX runs
long rather than compiles long gain nothing from it and keep the default.
"""

import contextlib

import jax

REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def reference_jit(fun, **kwargs):
    """`jax.jit` for a reference computation that runs once."""
    return jax.jit(fun, compiler_options=REFERENCE_COMPILER_OPTIONS, **kwargs)


@contextlib.contextmanager
def reference_compiles():
    """Every XLA compile in the block at REFERENCE_COMPILER_OPTIONS (a jit's
    own options take precedence)."""
    from jax._src import compiler

    real = compiler.get_compile_options

    def at_reference_options(*args, env_options_overrides=None, **kwargs):
        return real(*args, env_options_overrides={**REFERENCE_COMPILER_OPTIONS, **(env_options_overrides or {})},
                    **kwargs)

    compiler.get_compile_options = at_reference_options
    try:
        yield
    finally:
        compiler.get_compile_options = real
        jax.clear_caches()


def module_reference_compiles():
    """An autouse module fixture: the module's tests run inside
    `reference_compiles()`."""
    import pytest

    @pytest.fixture(scope="module", autouse=True)
    def _reference_compiles():
        with reference_compiles():
            yield

    return _reference_compiles
