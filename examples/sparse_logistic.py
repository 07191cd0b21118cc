"""rcv1-style sparse L1-logistic on one card: the hybrid hot/cold layout.

Real doc×term matrices are power-law: a handful of columns carry most
of the nonzeros. ``HybridSparseLogistic`` stores those columns dense
(an (N, D) block on the dense matmul paths) and only the tail in ELL,
whose gathers and scatters cost far more per element than a dense row
stream. The logistic coefficients
c_i = −y_i σ(−y_i ⟨a_i, x⟩) keep every gradient rank-1, so the
coefficient-table SAGA and the accelerated Katyusha run unchanged on
the sparse operator.

    python examples/sparse_logistic.py            # full-size defaults
    python examples/sparse_logistic.py small      # tiny CPU-mesh smoke

Problem: synthetic power-law features (D_hot dense columns at ~60 %
density + a K-sparse tail), labels from a planted hyperplane with 10 %
flips; objective (1/N) Σ log(1+exp(−y_i⟨a_i,x⟩)) + λ‖x‖₁, λ = 1/N.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ciao_tpu.oracles import HybridSparseLogistic
from ciao_tpu.prox import NormL1
from ciao_tpu.solvers.katyusha import KatyushaCfg, katyusha_init, katyusha_run
from ciao_tpu.solvers.saga import SAGACfg, saga_init, saga_run


def build(N, n, d_hot, k_tail, seed=0):
    """ELL/hybrid fields straight from numpy (no dense (N, n) ever
    materialized — the point of the layout)."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, size=d_hot, replace=False).astype(np.int32)
    A_hot = rng.standard_normal((N, d_hot)).astype(np.float32)
    A_hot *= (rng.random((N, d_hot)) < 0.6)  # ~60 % dense-block density
    cold = np.setdiff1d(np.arange(n, dtype=np.int32), hot)
    idx = rng.choice(cold, size=(N, k_tail)).astype(np.int32)
    val = rng.standard_normal((N, k_tail)).astype(np.float32)

    # labels from a planted hyperplane (10 % label noise)
    w = rng.standard_normal(n).astype(np.float32)
    margin = A_hot[:, :d_hot] @ w[hot] + (val * w[idx]).sum(axis=1)
    y = np.sign(margin).astype(np.float32)
    y[y == 0] = 1.0
    flip = rng.random(N) < 0.1
    y[flip] = -y[flip]

    F = HybridSparseLogistic(
        A_hot=jnp.asarray(A_hot), hot_cols=jnp.asarray(hot),
        idx=jnp.asarray(idx), val=jnp.asarray(val), y=jnp.asarray(y),
        n_dim=n,
    )
    L = 0.25 * ((A_hot ** 2).sum(axis=1) + (val ** 2).sum(axis=1))
    return F, jnp.asarray(L), y


def main(N=1_048_576, n=65_536, d_hot=256, k_tail=8, B=4_096, small=False):
    if small:
        N, n, d_hot, k_tail, B = 4_096, 1_024, 16, 4, 256
    F, L, y = build(N, n, d_hot, k_tail)
    g = NormL1(lam=jnp.asarray(1.0 / N, jnp.float32))
    x0 = jnp.zeros(n, jnp.float32)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def objective(F, x):
        m = (F.A_hot.astype(x.dtype) @ x[F.hot_cols]
             + jnp.sum(F.val * jnp.take(x, F.idx, axis=0), axis=1))
        return (jnp.mean(jnp.logaddexp(0.0, -F.y * m))
                + jnp.sum(jnp.abs(x)) / N)

    print(f"N={N:,} n={n:,} hot={d_hot} K={k_tail} "
          f"({(F.A_hot.size + 2 * F.idx.size) * 4 / 2**30:.2f} GiB layout vs "
          f"{N * n * 4 / 2**30:.1f} GiB dense)")
    print(f"objective(0) = {float(objective(F, x0)):.6f}")

    # SAGA, coefficient table + contiguous blocks
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True)
    gam = jnp.asarray(1.0 / (3.0 * float(jnp.max(L))), jnp.float32)
    st = saga_init(F, g, x0, gam, key, cfg)
    spe = N // B
    epochs = 2 if small else 20
    _ = jax.block_until_ready(saga_run(F, g, st, cfg, spe))  # warm
    t0 = time.perf_counter()
    st = saga_run(F, g, st, cfg, epochs * spe)
    _ = float(st.z[0])
    dt = time.perf_counter() - t0
    print(f"SAGA: {epochs} epochs in {dt:.2f}s "
          f"({epochs * N / dt / 1e6:.1f} M samples/s), "
          f"objective {float(objective(F, st.z)):.6f}")

    # Katyusha on the same operator (acceleration pays in epochs)
    m = 2 * N // B
    kcfg = KatyushaCfg(N=N, batch=B, m=m, block=True, ns=True)
    stk = katyusha_init(
        F, g, x0, jnp.max(L), jnp.asarray(0.5, jnp.float32),
        jnp.asarray(0.5, jnp.float32), key, kcfg,
    )
    outers = 1 if small else 7  # ≈ 3 epochs each
    _ = jax.block_until_ready(katyusha_run(F, g, stk, kcfg, 1))  # warm
    t0 = time.perf_counter()
    stk = katyusha_run(F, g, stk, kcfg, outers)
    _ = float(stk.x_tilde[0])
    dt = time.perf_counter() - t0
    print(f"Katyusha: {outers} outer steps ({3 * outers} epoch-equivalents) "
          f"in {dt:.2f}s, objective {float(objective(F, stk.x_tilde)):.6f}")


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main(small="small" in sys.argv[1:])
