"""Loader for the JAX reference package, for the PyTorch port's parity tests.

`repro.core` does not import on jax 0.9: `repro/core/des.py` tests
membership in `jax.interpreters.batching.primitive_batchers`, which is now a
proxy without `__contains__`, and `repro/core/precision.py` imports
`jax.experimental.enable_x64`, which moved to `jax.enable_x64`. Both are
repaired here from OUTSIDE the package, so the reference stays untouched
and the port's tests can hold the port against the live JAX functions.

`load_reference()` must be called from a fixture or a test, never while a
module is imported: the patches and the `repro.core` import then happen
after collection, so the collection of every other test module is
unchanged. The other port test files use

    from test_torch_reference import load_reference
"""
import contextlib
import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

_REF = None


def _patch_primitive_batchers():
    from jax._src.interpreters import batching as _b
    from jax.interpreters import batching

    proxy = batching.primitive_batchers
    if hasattr(type(proxy), "__contains__"):
        return

    class _BatchersWithContains(type(proxy)):
        def __contains__(self, prim):
            tables = (getattr(_b, "fancy_primitive_batchers", {}),
                      getattr(_b, "primitive_batchers", {}))
            return any(isinstance(t, dict) and prim in t for t in tables)

    patched = _BatchersWithContains()
    batching.primitive_batchers = patched
    if getattr(_b, "primitive_batchers", None) is proxy:
        _b.primitive_batchers = patched


def _patch_enable_x64():
    import jax
    import jax.experimental

    if hasattr(jax.experimental, "enable_x64"):
        return

    @contextlib.contextmanager
    def enable_x64(new_val: bool = True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = enable_x64


def load_reference() -> types.SimpleNamespace:
    """Import the JAX reference once and return its modules.

    Fields: `jax`, `jnp`, `core` (repro.core), `des`, `packet`, `metrics`,
    `sweep`, `precision`, `lublin`, `step_ops`
    (repro.kernels.packet_step.ops); the model stack: `configs`
    (repro.configs), `layers`, `lm`, `registry` (repro.models.*),
    `policy` (repro.sharding.policy), `engine` (repro.serve.engine),
    `launch_serve` (repro.launch.serve), `attn_ops` and `attn_ref`
    (repro.kernels.flash_attention.ops / .ref); the training slice:
    `hybrid` (repro.models.hybrid), `train_step`, `train_loss`,
    `train_optim`, `train_data` (repro.train.*), `lru_kernel` and `lru_ref`
    (repro.kernels.rglru_scan.kernel / .ref); the streaming service:
    `windows` (repro.workload.windows), `service` (repro.service),
    `service_driver` (repro.service.driver), and the paper's drivers
    `launch_sim` and `launch_service` (repro.launch.sim / .service).
    """
    global _REF
    if _REF is not None:
        return _REF
    _patch_primitive_batchers()
    _patch_enable_x64()
    import jax
    import jax.numpy as jnp
    import repro.core as core
    from repro.core import des, metrics, packet, precision, sweep
    from repro.kernels.packet_step import ops as step_ops
    from repro.workload import lublin
    import repro.configs as configs
    from repro.kernels.flash_attention import ops as attn_ops
    from repro.kernels.flash_attention import ref as attn_ref
    from repro.kernels.rglru_scan import kernel as lru_kernel
    from repro.kernels.rglru_scan import ref as lru_ref
    from repro.launch import serve as launch_serve
    from repro.models import hybrid, layers, lm, registry
    from repro.serve import engine
    from repro.sharding import policy
    from repro.train import data as train_data
    from repro.train import loss as train_loss
    from repro.train import optim as train_optim
    from repro.train import step as train_step
    from repro.workload import windows
    import repro.service as service
    from repro.service import driver as service_driver
    from repro.launch import service as launch_service
    from repro.launch import sim as launch_sim
    _REF = types.SimpleNamespace(
        jax=jax, jnp=jnp, core=core, des=des, packet=packet,
        metrics=metrics, sweep=sweep, precision=precision, lublin=lublin,
        step_ops=step_ops, configs=configs, layers=layers, lm=lm,
        registry=registry, policy=policy, engine=engine,
        launch_serve=launch_serve, attn_ops=attn_ops, attn_ref=attn_ref,
        hybrid=hybrid, train_step=train_step, train_loss=train_loss,
        train_optim=train_optim, train_data=train_data,
        lru_kernel=lru_kernel, lru_ref=lru_ref, windows=windows,
        service=service, service_driver=service_driver,
        launch_sim=launch_sim, launch_service=launch_service)
    return _REF


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def test_reference_imports(ref):
    assert callable(ref.core.run_packet_grid)
    assert callable(ref.step_ops.fused_packet_step)
    assert ref.des.STEP_IMPLS == ("xla", "pallas")


def test_reference_model_stack_imports(ref):
    assert callable(ref.lm.prefill) and callable(ref.engine.generate)
    assert callable(ref.attn_ops.flash_attention)
    assert ref.configs.get_config("granite-3-2b").n_layers == 40


def test_loader_is_idempotent(ref):
    assert load_reference() is ref


def test_membership_patch_answers(ref):
    from jax._src.lax.lax import optimization_barrier_p
    from jax.interpreters import batching
    assert optimization_barrier_p in batching.primitive_batchers
    assert object() not in batching.primitive_batchers


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_reference_tiny_grid_pallas_step(ref, dtype):
    """The reference's kernel path runs on the CPU (interpret mode) in both
    dtypes and agrees with its own XLA step on schedules."""
    wl = ref.lublin.generate_workload(ref.lublin.WorkloadParams(
        n_jobs=60, nodes=32, load=0.9, homogeneous=True, seed=2))
    kw = dict(ks=[0.5, 4.0], s_props=[0.05, 0.3], dtype=dtype, mode="fused")
    gp = ref.core.run_packet_grid(wl, step_impl="pallas", **kw)
    gx = ref.core.run_packet_grid(wl, step_impl="xla", **kw)
    assert np.asarray(gp.avg_wait).dtype == np.dtype(dtype)
    assert np.asarray(gp.ok).all()
    assert np.array_equal(np.asarray(gp.n_groups), np.asarray(gx.n_groups))
    assert np.array_equal(np.asarray(gp.avg_wait), np.asarray(gx.avg_wait))


def test_float64_scope_does_not_leak(ref):
    assert not ref.jax.config.jax_enable_x64
    assert ref.jnp.asarray(1.0).dtype == ref.jnp.float32
