"""Large-N Lasso on one card: the low-memory LFinito path.

The reference's answer to N beyond table capacity is LFinito
(O(n) state, 2 gradient evals per sample per epoch,
``Finito_LFinito.jl``); one epoch is a full gradient pass plus a sweep
of block updates over the row matrix. 2M×1024 rows are 8 GB in f32;
int8 storage holds 8M×1024 — a 32 GB-equivalent f32 operator — in the
same bytes:

    python examples/large_scale_lasso.py          # f32
    python examples/large_scale_lasso.py bf16     # bf16-stored rows:
                                                  # half the traffic
    python examples/large_scale_lasso.py int8     # 8M x 1024 rows, built
                                                  # by chunked on-device
                                                  # quantization
"""

import time
from functools import partial

import jax
import jax.numpy as jnp

from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.oracles.base import quantize_rows
from ciao_tpu.prox import NormL1
from ciao_tpu.solvers.finito import FinitoCfg, finito_run, lfinito_init


def _build_int8(key, N, n, chunk=524_288):
    """(q, row_scale, b, L) with the f32 rows never fully materialized:
    each chunk is generated, quantized and written into the donated
    int8 buffer inside ONE jit, so peak device memory is the int8
    matrix plus a single f32 chunk (8.6 GB + 2 GB at the defaults), not
    the full 32 GB f32 operator."""

    @partial(jax.jit, donate_argnums=(0, 1, 2), static_argnums=(4,))
    def fill(q, rs, L, ck, chunk, start):
        a = jax.random.normal(ck, (chunk, n), jnp.float32)
        qc, rsc = quantize_rows(a)
        q = jax.lax.dynamic_update_slice(
            q, qc, (start, jnp.zeros((), start.dtype))
        )
        rs = jax.lax.dynamic_update_slice(rs, rsc, (start,))
        Lc = jnp.sum(a * a, axis=1) * N
        L = jax.lax.dynamic_update_slice(L, Lc, (start,))
        return q, rs, L

    q = jnp.zeros((N, n), jnp.int8)
    rs = jnp.zeros((N,), jnp.float32)
    L = jnp.zeros((N,), jnp.float32)
    for i in range(N // chunk):
        q, rs, L = fill(q, rs, L, jax.random.fold_in(key, i), chunk,
                        jnp.asarray(i * chunk, jnp.int32))
    return q, rs, L


def main(N=2_097_152, n=1_024, B=4_096, epochs=20, storage="f32",
         small=False):
    if small:  # CI smoke shapes (tests/test_examples.py): same code path
        N, B, epochs = 2_048, 256, 2
    key = jax.random.PRNGKey(0)
    kA, kb = jax.random.split(key)
    if storage == "int8":
        if not small:
            N = 4 * N                   # same byte budget as the f32 run
        q, rs, L = _build_int8(kA, N, n, chunk=min(524_288, N))
        b = jax.random.normal(kb, (N,), jnp.float32)
        F = LeastSquaresRows(A=q, b=b, row_scale=rs,
                             scale=jnp.asarray(float(N), jnp.float32))
    else:
        A = jax.random.normal(kA, (N, n), jnp.float32)
        b = jax.random.normal(kb, (N,), jnp.float32)
        F = LeastSquaresRows(A=A, b=b, scale=jnp.asarray(float(N), jnp.float32))
        # one jitted Lipschitz pass — an eager A*A materializes 8 GB
        L = jax.jit(lambda A: jnp.sum(A * A, axis=1) * N)(A)
        if storage == "bf16":
            F = F.with_storage()   # state/coefficients stay f32

    cfg = FinitoCfg(N=N, batch=B, sweeping=3, alpha=0.999)
    st = lfinito_init(F, g := NormL1(lam=jnp.asarray(0.1, jnp.float32)),
                      jnp.zeros(n, jnp.float32), 0.999 * N / L, key, cfg)
    jax.block_until_ready(st)

    # warm the TIMED shape (steps is a static scan length: a steps=1
    # warmup would leave the steps=epochs program to compile in-clock)
    st = jax.block_until_ready(finito_run(F, g, st, cfg, "lfinito", epochs))
    t0 = time.perf_counter()
    st = jax.block_until_ready(finito_run(F, g, st, cfg, "lfinito", epochs))
    dt = time.perf_counter() - t0
    bpe = F.A.dtype.itemsize
    print(f"N={N:,} n={n} [{storage}]: {dt / epochs * 1e3:.1f} ms/epoch "
          f"({epochs * 2 * N * n * bpe / dt / 1e9:.0f} GB/s effective)")
    # the epochs actually optimized: objective strictly below the start
    # (on-device; F is a jit ARGUMENT — closing over it would bake the
    # multi-GB operator into the compiled program as a constant)
    obj = jax.jit(lambda F, z: jnp.real(F.value_sum_all(z)) / N
                  + 0.1 * jnp.sum(jnp.abs(z)))
    o0 = float(obj(F, jnp.zeros(n, jnp.float32)))
    oz = float(obj(F, st.z))
    assert jnp.isfinite(st.z).all()
    assert oz < o0, f"LFinito must decrease the objective ({oz} vs {o0})"


if __name__ == "__main__":
    import sys

    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    _stor = "f32"
    for _s in ("bf16", "int8"):
        if _s in sys.argv[1:]:
            _stor = _s
    main(storage=_stor)
