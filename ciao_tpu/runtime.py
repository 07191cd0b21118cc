"""Backend policy and the persistent compile cache.

One place states which code runs on which backend. Every solver step
is plain XLA on every backend. The one hand-written kernel, the
coefficient-mode SAGA block step (``ops.saga_block``), runs on a CUDA
GPU only, where the SAGA facade takes it for the shapes it was measured
on; a step that asks for it on another backend raises. No path runs
the Pallas interpreter outside the tests.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp


def on_gpu() -> bool:
    """Whether the default backend is a CUDA GPU."""
    return jax.default_backend() == "gpu"


def block_step_kernel(F, x0, batch: int, coeff_block: bool) -> bool:
    """Whether a solver's coefficient-mode block steps run through the
    Hopper kernel: on a CUDA GPU, for float32 iterates, an oracle with
    dense rows (``coeff_rows_data``) and a shape the kernel was measured
    on (``block_step_supported``). ``coeff_block`` says whether the
    solver takes coefficient block steps at all."""
    if not (coeff_block and on_gpu()
            and jnp.asarray(x0).dtype == jnp.float32
            and hasattr(F, "coeff_rows_data")):
        return False
    from ciao_tpu.ops.saga_block import block_step_supported

    rows, _ = F.coeff_rows_data()
    return block_step_supported(*rows.shape, batch, rows.dtype)


def enable_compile_cache(anchor: str) -> str:
    """Turn on JAX's persistent compile cache for an entry script.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed. Otherwise the cache is ``.jax_cache/`` beside
    ``anchor`` (the script's ``__file__``): a fixed path inside the
    checkout, so the next run of the same checkout finds it. Returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.abspath(anchor)),
                        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power_limit() -> str:
    """What ``nvidia-smi --query-gpu=name,power.limit`` reports for the
    first card (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), or "not
    available" where there is no such tool. The clock rate of a card
    set below its maximum power falls under load, so every timing is
    reported beside this line."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip() if out else "not available"


def device_record() -> dict:
    """The device fields every benchmark line carries."""
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "device_kind": d[0].device_kind,
        "device_count": len(d),
        "card": card_name_and_power_limit(),
    }
