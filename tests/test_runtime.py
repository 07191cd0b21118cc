"""Backend policy (``runtime.block_step_kernel``), the SAGA facade's
choice of block step, and the compile-cache helper."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu import runtime
from ciao_tpu.oracles import LeastSquaresRows, ZeroOracle
from ciao_tpu.prox import NormL1
from ciao_tpu.solvers.saga import coeff_block_kernel, saga_run

B = 4096  # the smallest block the kernel was measured on


def _lsq(N=B, n=8, dtype=jnp.float32):
    rng = np.random.default_rng(0)
    return LeastSquaresRows(
        A=jnp.asarray(rng.standard_normal((N, n)), dtype),
        b=jnp.asarray(rng.standard_normal(N), dtype),
        scale=jnp.asarray(float(N), dtype),
    )


@pytest.fixture
def fake_gpu(monkeypatch):
    monkeypatch.setattr(runtime, "on_gpu", lambda: True)


def test_auto_stays_on_xla_off_gpu():
    assert not runtime.block_step_kernel(
        _lsq(), jnp.zeros(8, jnp.float32), B, True)


def test_hopper_request_raises_off_gpu():
    """A block step that asks for the kernel (``SAGACfg.kernel``) on a
    backend that cannot run it raises instead of interpreting."""
    F = _lsq(N=64)
    with pytest.raises(ValueError, match="CUDA GPU only"):
        coeff_block_kernel(F, jnp.zeros(64, jnp.float32),
                           jnp.zeros(8, jnp.float32), jnp.int32(0), 16)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_auto_takes_the_kernel_on_gpu(fake_gpu, storage):
    F = _lsq()
    if storage != "f32":
        F = F.with_storage(storage)
    assert runtime.block_step_kernel(F, jnp.zeros(8, jnp.float32), B, True)


@pytest.mark.parametrize("case", [
    "full_table", "f64_iterate", "no_rows", "too_wide", "small_block",
])
def test_gpu_gates_stay_on_xla(fake_gpu, case):
    """On the GPU a step outside the kernel's reach or its measured
    range stays on the XLA step."""
    F, x0, batch, coeff_block = _lsq(), jnp.zeros(8, jnp.float32), B, True
    if case == "full_table":
        coeff_block = False
    elif case == "f64_iterate":
        x0 = jnp.zeros(8, jnp.float64)
    elif case == "no_rows":
        F = ZeroOracle(n_terms=B)
    elif case == "too_wide":
        F = _lsq(N=16, n=2000)
        x0 = jnp.zeros(2000, jnp.float32)
    elif case == "small_block":
        batch = B // 2
    assert not runtime.block_step_kernel(F, x0, batch, coeff_block)


def _facade_cfg(batch):
    F = _lsq()
    g = NormL1(lam=jnp.asarray(0.1, jnp.float32))
    x0 = jnp.zeros(8, jnp.float32)
    L = np.full(B, float(B) * 8)
    solver = ciao_tpu.SAGA(maxit=4, batch=batch, block_sampling=True)
    return solver._setup(x0, F, g, L, None)


def test_saga_facade_kernel_choice():
    """On the CPU the facade keeps the XLA step; a config that forces
    the kernel there raises at the step."""
    _, F, g, cfg, init = _facade_cfg(16)
    assert cfg.kernel is False
    with pytest.raises(ValueError, match="CUDA GPU only"):
        saga_run(F, g, init(), cfg._replace(kernel=True), 2)


@pytest.mark.parametrize("batch, kernel", [(B, True), (B // 4, False)])
def test_saga_facade_kernel_choice_on_gpu(fake_gpu, batch, kernel):
    assert _facade_cfg(batch)[3].kernel is kernel


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert runtime.enable_compile_cache(str(tmp_path / "s.py")) == str(
        tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / ".jax_cache").exists()


def test_compile_cache_defaults_beside_the_script(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache(str(tmp_path / "s.py"))
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_CACHE_PROG = """
import sys
import jax, jax.numpy as jnp
from ciao_tpu.runtime import enable_compile_cache
hits = []
jax.monitoring.register_event_listener(
    lambda name, **kw: hits.append(name) if "cache_hits" in name else None)
enable_compile_cache(sys.argv[1])
f = jax.jit(lambda x: jnp.sin(x) @ jnp.cos(x).T + 1.0)
f(jnp.ones((64, 64))).block_until_ready()
print("HITS", len(hits))
"""


def test_compile_cache_is_written_then_hit(tmp_path):
    """Two runs of one script: the first writes ``.jax_cache/`` beside
    it, the second finds its program there (a persistent-cache hit)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    anchor = str(tmp_path / "script.py")
    hits = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _CACHE_PROG, anchor],
                             env=env, check=True, capture_output=True,
                             text=True, timeout=120).stdout
        hits.append(int(out.split("HITS")[-1]))
        assert any((tmp_path / ".jax_cache").iterdir())
    assert hits[0] == 0 and hits[1] >= 1, hits
