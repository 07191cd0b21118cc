"""Sparse Poisson regression (count-data GLM) with the Poisson oracle.

Beyond the reference's surface entirely: ProximalOperators.jl has no
Poisson likelihood, so the reference cannot express count regression.
Here it rides the same machinery as every other rank-1 oracle — the
clamped exp link is the MODE_POISSON coefficient formula, so the
SAGA/Katyusha steps move the same bytes as least squares. The script
plants a sparse log-linear
model, draws Poisson counts, then shows

  * L1-regularized Poisson GLM (Katyusha) recovers the planted support
    with the bulk of nuisance coordinates at exactly zero;
  * the smoothness moduli come from the oracle's trust region
    (`local_smoothness(m_max)` — the Poisson Hessian is exp(m), so
    there is no global L);
  * the same fit data-parallel (DP Katyusha) on whatever mesh is
    available.

Run on CPU (CI mesh):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/poisson_glm.py
"""

import numpy as np

import jax
import jax.numpy as jnp

from ciao_tpu import Katyusha, PoissonRows
from ciao_tpu.parallel import DATA_AXIS, DPKatyusha, make_mesh, shard_finite_sum
from ciao_tpu.prox import NormL1


def main():
    rng = np.random.default_rng(0)
    N, n = 4096, 64
    A = rng.standard_normal((N, n)) * (1.2 / np.sqrt(n))
    x_true = np.zeros(n)
    x_true[:6] = [2.0, -1.6, 1.2, -1.0, 0.8, -0.7]
    y = rng.poisson(np.exp(A @ x_true)).astype(np.float64)
    print(f"counts: mean {y.mean():.2f}, max {y.max():.0f}")

    F = PoissonRows(A=jnp.asarray(A), y=jnp.asarray(y))
    # margins stay within a few units on the solve path; e^2.5·‖a_i‖²
    # is an honest local modulus there
    L = np.asarray(F.local_smoothness(2.5))
    x0 = jnp.zeros(n)

    # λ_max = ‖∇f(0)‖_∞ zeroes the solution; λ_max/10 keeps the
    # planted support and thresholds the noise
    lam_max = float(jnp.max(jnp.abs(F.grad_sum_all(x0)))) / N
    g = NormL1(lam=jnp.asarray(0.1 * lam_max))

    x_hat, iters = Katyusha(maxit=120, batch=64, block_sampling=True)(
        x0, F=F, g=g, L=L, N=N
    )
    xv = np.asarray(x_hat)
    sup = np.abs(xv) > 1e-8
    print(f"katyusha        : {int(sup.sum())} nonzeros "
          f"({iters} outer steps), support hit "
          f"{int(sup[:6].sum())}/6, corr "
          f"{np.corrcoef(xv[:6], x_true[:6])[0, 1]:.3f}")
    assert sup[:6].all(), "planted support missed"
    assert sup.sum() <= n // 2, "no sparsity"
    assert np.corrcoef(xv[:6], x_true[:6])[0, 1] > 0.95

    # data-parallel on all available devices
    mesh = make_mesh()
    D = mesh.shape[DATA_AXIS]
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPKatyusha(mesh=mesh, maxit=120, batch=8 * D)(
        x0, F=Fd, g=g, L=L)
    err_dp = np.linalg.norm(np.asarray(x_dp) - xv)
    print(f"dp katyusha x{D} : |x - x_single| = {err_dp:.5f}")
    assert err_dp < 5e-2


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main()
