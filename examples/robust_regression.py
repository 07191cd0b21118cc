"""Robust regression with the Huber oracle and the Katyusha solver.

Both are BEYOND the reference's surface (its oracle set has no robust
loss; its solver set has no accelerated method) but ride the same
machinery: rank-1 coefficients, contiguous-block streaming, DP
sharding — the Huber clip is the MODE_HUBER coefficient formula, so
this solve moves the same bytes as least squares. The script corrupts
10% of a planted regression's targets with gross outliers, then shows

  * plain least squares (the closed form) is dragged off the signal;
  * Huber + Katyusha recovers it, in a handful of accelerated epochs;
  * the same problem solved data-parallel (DP Katyusha) on whatever
    mesh is available.

Run on CPU (CI mesh):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/robust_regression.py
"""

import numpy as np

import jax
import jax.numpy as jnp

from ciao_tpu import HuberRows, Katyusha
from ciao_tpu.parallel import DATA_AXIS, DPKatyusha, make_mesh, shard_finite_sum


def main():
    rng = np.random.default_rng(0)
    N, n = 4096, 64
    A = rng.standard_normal((N, n))
    x_true = rng.standard_normal(n)
    y = A @ x_true + 0.01 * rng.standard_normal(N)
    out = rng.choice(N, size=N // 10, replace=False)
    y[out] += 50.0 * rng.standard_normal(out.size)

    x_ls = np.linalg.lstsq(A, y, rcond=None)[0]
    print(f"least squares   : |x - x_true| = {np.linalg.norm(x_ls - x_true):.4f}")

    F = HuberRows(
        A=jnp.asarray(A), b=jnp.asarray(y),
        delta=jnp.asarray(0.5), scale=jnp.asarray(float(N)),
    )
    L = float(N) * (A * A).sum(axis=1)
    z0 = jnp.zeros(n)

    x_h, iters = Katyusha(maxit=60, batch=64, block_sampling=True)(
        z0, F=F, L=L, N=N
    )
    err = np.linalg.norm(np.asarray(x_h) - x_true)
    print(f"huber+katyusha  : |x - x_true| = {err:.4f}  ({iters} outer steps)")
    assert err < 0.1 * np.linalg.norm(x_ls - x_true)

    # data-parallel on all available devices
    mesh = make_mesh()
    D = mesh.shape[DATA_AXIS]
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPKatyusha(mesh=mesh, maxit=60, batch=8 * D)(z0, F=Fd, L=L)
    err_dp = np.linalg.norm(np.asarray(x_dp) - x_true)
    print(f"dp katyusha x{D} : |x - x_true| = {err_dp:.4f}")
    assert err_dp < 0.1 * np.linalg.norm(x_ls - x_true)


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main()
