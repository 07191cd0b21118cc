"""The reference configuration's problem: a 10M×100 Lasso on one card.

The metric is epochs/s on the 10,485,760 × 100 Lasso (the reference
publishes nothing; the comparison is its single-core loop). At n = 100
dense rows move fewer bytes than any sparse format (see
``oracles/sparse.py``): A = 10.5M × 100 f32 is 4.2 GB (2.1 GB bf16,
1.05 GB int8).

The solver is LFinito — the reference's own answer to N beyond table
capacity (O(n) state, ``Finito_LFinito.jl``) — one epoch is a full
gradient pass plus a sweep of block updates.

    python examples/lasso_10m.py          # f32
    python examples/lasso_10m.py bf16     # bf16-stored rows
    python examples/lasso_10m.py int8     # int8-stored rows
"""

import sys
import time

import jax
import jax.numpy as jnp

from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import NormL1
from ciao_tpu.solvers.finito import FinitoCfg, finito_run, lfinito_init


def main(N=10 * 1024 * 1024, n=100, B=8_192, epochs=12, storage="f32",
         small=False):
    if small:  # CI smoke shapes (tests/test_examples.py): same code path
        N, B, epochs = 8_192, 512, 2
    key = jax.random.PRNGKey(0)
    kA, kb = jax.random.split(key)

    # generation and the optional narrow cast are ONE jit so only a
    # single A-sized buffer ever exists (A is 4.2 GB f32)
    out_dt = jnp.bfloat16 if storage == "bf16" else jnp.float32

    @jax.jit
    def gen(kA):
        a = jax.random.normal(kA, (N, n), jnp.float32)
        if storage == "int8":
            # quantize INSIDE the generating jit so the f32 A never
            # leaves the fusion (int8 A is 1.05 GB vs f32's 4.2)
            from ciao_tpu.oracles.base import quantize_rows

            q, rs = quantize_rows(a)
            return q, rs, jnp.sum(a * a, axis=1) * N
        return a.astype(out_dt), None, jnp.sum(a * a, axis=1) * N

    A, rs, L = gen(kA)
    b = jax.random.normal(kb, (N,), jnp.float32)
    F = LeastSquaresRows(A=A, b=b, scale=jnp.asarray(float(N), jnp.float32),
                         row_scale=rs)
    g = NormL1(lam=jnp.asarray(0.1, jnp.float32))

    cfg = FinitoCfg(N=N, batch=B, sweeping=3, alpha=0.999)
    st = lfinito_init(F, g, jnp.zeros(n, jnp.float32), 0.999 * N / L, key, cfg)
    jax.block_until_ready(st)

    # warm the TIMED shape (a steps=1 warmup would leave the steps=epochs
    # scan to compile inside the clock)
    st = jax.block_until_ready(finito_run(F, g, st, cfg, "lfinito", epochs))
    t0 = time.perf_counter()
    st = jax.block_until_ready(finito_run(F, g, st, cfg, "lfinito", epochs))
    dt = time.perf_counter() - t0
    bpe = F.A.dtype.itemsize
    print(f"LFinito {N:,}x{n} [{storage}]: "
          f"{dt / epochs * 1e3:.1f} ms/epoch = {epochs / dt:.1f} epochs/s "
          f"({epochs * 2 * N * n * bpe / dt / 1e9:.0f} GB/s effective; "
          f"single-core CPU loop ~42k samples/s would need "
          f"~{N / 42_000:.0f}s/epoch)")
    # the epochs actually optimized (on-device objective read). F is a
    # jit ARGUMENT — closing over it would bake the multi-GB operator
    # into the compiled program as a constant
    obj = jax.jit(lambda F, z: jnp.real(F.value_sum_all(z)) / N
                  + 0.1 * jnp.sum(jnp.abs(z)))
    o0 = float(obj(F, jnp.zeros(n, jnp.float32)))
    oz = float(obj(F, st.z))
    assert jnp.isfinite(st.z).all()
    assert oz < o0, f"LFinito must decrease the objective ({oz} vs {o0})"


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    _stor = "f32"
    for _s in ("bf16", "int8"):
        if _s in sys.argv[1:]:
            _stor = _s
    main(storage=_stor)
