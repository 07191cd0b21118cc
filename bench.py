#!/usr/bin/env python
"""Benchmark: SAGA throughput and time to accuracy on one GPU.

The reference publishes no performance numbers: its functional tests are
tiny (N=6..8) and its runtime is a single-process Julia loop doing one
sample per iteration (``SAGA_basic.jl:53-67``). The baseline here is a
single-core numpy implementation of that batch-1 SAGA loop, in
samples/s; the accelerator runs the minibatch block variant (the
reference's own TODO at ``SAGA_basic.jl:74``) with the whole step jitted
and scanned on the device.

Usage::

    python bench.py              # headline + anchors, one JSON line each
    python bench.py --kernel-ab  # SAGA facade with and without the
                                 # Hopper block-step kernel, in turns

The first line is the headline
``{"metric": "saga_samples_per_s", ...}``; the anchors follow
(``lfinito_10m_epochs_per_s``, ``time_to_rel1e3_staged_int8_s``,
``deep_target_10m_time_to_rel1e6_s``, ``example_deep_accuracy_rel``).
Every line names the platform, the device kind and count, and the card's
name and power limit. With no accelerator the script exits non-zero and
prints no result; any failure ends it with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N, n = 262_144, 1_024
BATCH = 4_096
STEPS_PER_EPOCH = N // BATCH
TIMED_EPOCHS = 256

# the CPU baseline takes a smaller N (same n) and counts samples/s
N_CPU, CPU_STEPS = 16_384, 20_000

_DEVICE: dict = {}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(metric: str, value, unit: str, **extra):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **extra, **_DEVICE}), flush=True)


def cpu_baseline_samples_per_s() -> float:
    """Batch-1 SAGA loop (the reference's algorithm, SAGA_basic.jl:53-67)
    in numpy — per-sample cost is O(n) BLAS-1 ops, matching the Julia
    reference's in-place broadcast profile. Best of three runs: the
    host is shared and transient load only slows a run."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N_CPU, n), dtype=np.float32)
    b = rng.standard_normal(N_CPU).astype(np.float32)
    L_max = float((A * A).sum(axis=1).max() * N_CPU)
    gamma = np.float32(1.0 / (3.0 * L_max))
    lam = np.float32(0.1)
    idx = rng.integers(0, N_CPU, size=CPU_STEPS)

    def one_run():
        s = np.zeros((N_CPU, n), np.float32)      # gradient table
        av = np.zeros(n, np.float32)
        z = np.zeros(n, np.float32)
        t0 = time.perf_counter()
        for k in range(CPU_STEPS):
            i = idx[k]
            a = A[i]
            r = a @ z - b[i]
            grad = (N_CPU * r) * a                # scale = N (reference)
            diff = grad - s[i]
            w = z - gamma * (diff + av)
            av += diff / N_CPU
            z[:] = np.sign(w) * np.maximum(np.abs(w) - gamma * lam, 0)
            s[i] = grad
        return time.perf_counter() - t0

    return CPU_STEPS / min(one_run() for _ in range(3))


def _random_lasso():
    import jax
    import jax.numpy as jnp

    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.prox import NormL1

    kA, kb = jax.random.split(jax.random.PRNGKey(0))
    A = jax.random.normal(kA, (N, n), jnp.float32)
    b = jax.random.normal(kb, (N,), jnp.float32)
    F = LeastSquaresRows(A=A, b=b, scale=jnp.asarray(float(N), jnp.float32))
    g = NormL1(lam=jnp.asarray(0.1, jnp.float32))
    return F, g, jnp.sum(A * A, axis=1) * N


def saga_step_time(F, g, L, kernel=None, epochs: int = TIMED_EPOCHS):
    """(samples/s, ms/step) of ``SAGA(batch=BATCH, block_sampling=True)``
    — the facade's own setup and chunk runner, with the timed chunk
    length compiled and run once before the clock. ``kernel`` (a bool)
    overrides the facade's choice of block step."""
    import jax
    import jax.numpy as jnp

    from ciao_tpu.solvers.saga import SAGA, saga_run

    solver = SAGA(batch=BATCH, block_sampling=True)
    _, F, g, cfg, init = solver._setup(
        jnp.zeros(n, jnp.float32), F, g, L, None)
    if kernel is not None:
        cfg = cfg._replace(kernel=kernel)
    steps = epochs * STEPS_PER_EPOCH
    state = jax.block_until_ready(saga_run(F, g, init(), cfg, steps))
    t0 = time.perf_counter()
    state = jax.block_until_ready(saga_run(F, g, state, cfg, steps))
    dt = time.perf_counter() - t0
    if not bool(jnp.all(jnp.isfinite(state.z))):
        raise FloatingPointError("SAGA iterate is not finite")
    return steps * BATCH / dt, dt / steps * 1e3


def kernel_ab():
    """The SAGA facade at N×n with B=BATCH, with and without the Hopper
    block-step kernel, in turns (xla, hopper, hopper, xla) for f32 and
    int8 rows. One JSON line per run and one verdict line per storage."""
    F32, g, L = _random_lasso()
    for storage in ("f32", "int8"):
        F = F32 if storage == "f32" else F32.with_storage("int8")
        rates = {"xla": [], "hopper": []}
        for kernel in ("xla", "hopper", "hopper", "xla"):
            rate, ms = saga_step_time(F, g, L, kernel == "hopper")
            rates[kernel].append(rate)
            emit("saga_samples_per_s", rate, "samples/s", storage=storage,
                 kernel=kernel, ms_per_step=ms, shape=[N, n], batch=BATCH)
        xla, hop = (float(np.mean(rates[k])) for k in ("xla", "hopper"))
        emit("kernel_speedup", hop / xla, "x", storage=storage,
             xla_samples_per_s=xla, hopper_samples_per_s=hop)


def staged_time_to_target(shape=(65_536, 1_024), switch=5e-2,
                          target=1e-3, max_epochs=8192):
    """Seconds from init to rel ``target`` on the planted Lasso of
    ``shape`` (65,536 × 1,024) with the staged schedule: the SAGA facade's step on int8 rows
    until rel ``switch``, ``saga_rebase``, then f32 rows until
    ``target``; the gap is checked every 64 epochs, on the clock.
    Compiles are warmed outside it. Returns (seconds, rel, epochs)."""
    import jax
    import jax.numpy as jnp

    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.prox import NormL1
    from ciao_tpu.solvers.saga import SAGA, saga_rebase, saga_run
    from ciao_tpu.utils.problems import make_lasso_device

    Np, npx = shape
    prob = make_lasso_device(Np, npx, p=min(64, npx // 8), seed=0)
    F = LeastSquaresRows(A=prob.A, b=prob.b,
                         scale=jnp.asarray(float(Np), jnp.float32))
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    _, F, g, cfg, init = SAGA(batch=BATCH, block_sampling=True)._setup(
        jnp.zeros(npx, jnp.float32), F, g, prob.L, None)
    F8 = F.with_storage("int8")
    chunk = 64 * (Np // BATCH)
    st = init()
    for Fs in (F8, F):                                     # warm
        jax.block_until_ready(saga_run(Fs, g, st, cfg, chunk))
    jax.block_until_ready(saga_rebase(F, st, cfg))
    prob.gap_rel(st.z)

    t0 = time.perf_counter()
    st, epochs = init(), 0
    rel = prob.gap_rel(st.z)
    for Fs, level in ((F8, switch), (F, target)):
        if Fs is F:
            st = saga_rebase(F, st, cfg)
        while rel > level and epochs < max_epochs:
            st = saga_run(Fs, g, st, cfg, chunk)
            epochs += 64
            rel = prob.gap_rel(st.z)
    return time.perf_counter() - t0, rel, epochs


def lfinito_10m_epochs_per_s(storage: str = "int8") -> float:
    """LFinito epochs/s on the 10,485,760 × 100 Lasso (the reference
    configuration's width; one epoch is a full-gradient pass plus a
    sweep over 1,280 blocks of 8,192 rows)."""
    import jax
    import jax.numpy as jnp

    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.prox import NormL1
    from ciao_tpu.solvers.finito import FinitoCfg, finito_run, lfinito_init

    Nb, nb, Bb = 10 * 1024 * 1024, 100, 8_192
    kA, kb = jax.random.split(jax.random.PRNGKey(0))
    A = jax.random.normal(kA, (Nb, nb), jnp.float32)
    L = jnp.sum(A * A, axis=1) * Nb
    F = LeastSquaresRows(A=A, b=jax.random.normal(kb, (Nb,), jnp.float32),
                         scale=jnp.asarray(float(Nb), jnp.float32))
    if storage != "f32":
        F = F.with_storage(storage)
    del A
    g = NormL1(lam=jnp.asarray(0.1, jnp.float32))
    cfg = FinitoCfg(N=Nb, batch=Bb, sweeping=3, alpha=0.999)
    st = lfinito_init(F, g, jnp.zeros(nb, jnp.float32), 0.999 * Nb / L,
                      jax.random.PRNGKey(0), cfg)
    epochs = 8
    jax.block_until_ready(finito_run(F, g, st, cfg, "lfinito", epochs))
    t0 = time.perf_counter()
    jax.block_until_ready(finito_run(F, g, st, cfg, "lfinito", epochs))
    return epochs / (time.perf_counter() - t0)


def deep_target_10m():
    """``deep_solve`` on the planted 10,485,760 × 100 Lasso to rel 1e-6:
    (seconds, rel), every jitted piece warmed by a short call first."""
    import jax.numpy as jnp

    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.prox import NormL1
    from ciao_tpu.solvers import deep_solve
    from ciao_tpu.utils.problems import make_lasso_device

    Nb, nb = 10 * 1024 * 1024, 100
    prob = make_lasso_device(Nb, nb, p=8, seed=0)
    F = LeastSquaresRows(A=prob.A, b=prob.b,
                         scale=jnp.asarray(float(Nb), jnp.float32))
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    x0 = jnp.zeros(nb, jnp.float32)
    kw = dict(L=prob.L, batch=8_192, chunk_epochs=16, plateau_rtol=1e-5,
              max_epochs=192, polish_steps=4, polish_max_rounds=8)
    deep_solve(x0, F, g, **{**kw, "max_epochs": 16, "polish_max_rounds": 1})
    t0 = time.perf_counter()
    z, _ = deep_solve(x0, F, g, **kw)
    dt = time.perf_counter() - t0
    return dt, prob.gap_rel(z)


def example_deep_accuracy():
    """``examples/deep_accuracy.py``'s main() (1M×128, asserts rel ≤
    1e-6): (rel, seconds)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "examples" / \
        "deep_accuracy.py"
    spec = importlib.util.spec_from_file_location("deep_accuracy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    rel = mod.main()
    return rel, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-ab", action="store_true",
                    help="time the SAGA facade with and without the "
                         "Hopper block-step kernel, and nothing else")
    args = ap.parse_args(argv)

    import jax

    from ciao_tpu import runtime

    runtime.enable_compile_cache(__file__)
    if jax.devices()[0].platform == "cpu":
        log("no accelerator: JAX found only CPU devices")
        return 2
    _DEVICE.update(runtime.device_record())
    log(f"card: {_DEVICE['card']}")
    if args.kernel_ab:
        kernel_ab()
        return 0

    cpu = cpu_baseline_samples_per_s()
    log(f"CPU batch-1 baseline: {cpu:,.0f} samples/s")
    F, g, L = _random_lasso()
    rate, ms = saga_step_time(F.with_storage("int8"), g, L)
    emit("saga_samples_per_s", rate, "samples/s", vs_baseline=rate / cpu,
         storage="int8", ms_per_step=ms, shape=[N, n], batch=BATCH)
    del F, g, L

    emit("lfinito_10m_epochs_per_s", lfinito_10m_epochs_per_s("int8"),
         "epochs/s", storage="int8")
    dt, rel, epochs = staged_time_to_target()
    emit("time_to_rel1e3_staged_int8_s", dt, "s", rel=rel, epochs=epochs,
         reached=bool(rel <= 1e-3))
    dt, rel = deep_target_10m()
    emit("deep_target_10m_time_to_rel1e6_s", dt, "s", rel=rel,
         reached=bool(rel <= 1e-6))
    rel, dt = example_deep_accuracy()
    emit("example_deep_accuracy_rel", rel, "rel_suboptimality",
         time_s=dt, shape=[1 << 20, 128], passed=bool(rel <= 1e-6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
