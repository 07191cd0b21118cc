"""Nonconvex sparse regression: MCP penalty + the SARAH solver.

Both are BEYOND the reference's tested surface but squarely inside its
advertised problem class ("g possibly nonconvex", reference
README.md:6-12). The script plants a sparse signal, then shows

  * L1 (lasso) recovers the support but SHRINKS every surviving
    coefficient by the threshold — the classic lasso bias;
  * MCP + SARAH recovers the same support UNBIASED (large coefficients
    pass through the firm threshold untouched), landing on the oracle
    least-squares refit;
  * SARAH is the right solver here: its recursive estimator carries the
    SPIDER-class nonconvex convergence guarantee, and each inner step
    is one two-point row read (grad_sum_diff_block).

Run on CPU (CI mesh):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/nonconvex_sparse_mcp.py
"""

import numpy as np

import jax.numpy as jnp

from ciao_tpu import MCP, SARAH, LeastSquaresRows, NormL1
from ciao_tpu.parallel import DATA_AXIS, DPSARAH, make_mesh, shard_finite_sum


def main():
    rng = np.random.default_rng(0)
    N, n, p = 4096, 128, 8
    A = rng.standard_normal((N, n)) / np.sqrt(N)
    x_true = np.zeros(n)
    supp = rng.choice(n, size=p, replace=False)
    # signal bounded away from the MCP clip radius beta*lam = 2
    x_true[supp] = (3.0 + 3.0 * rng.random(p)) * rng.choice([-1.0, 1.0], p)
    b = A @ x_true + 0.02 * rng.standard_normal(N)

    F = LeastSquaresRows(
        A=jnp.asarray(A), b=jnp.asarray(b), scale=jnp.asarray(float(N))
    )
    L = float(N) * (A * A).sum(axis=1)
    lam = 0.1   # > noise level ||A^T eps||_inf ~ 0.06
    z0 = jnp.zeros(n)

    x_ls_refit = np.zeros(n)
    x_ls_refit[supp] = np.linalg.lstsq(A[:, supp], b, rcond=None)[0]

    x_l1, _ = SARAH(maxit=60, batch=64, block_sampling=True, m=N // 64)(
        z0, F=F, g=NormL1(lam=jnp.asarray(lam)), L=L, N=N
    )
    x_l1 = np.asarray(x_l1)
    err_l1 = np.linalg.norm(x_l1 - x_ls_refit)
    print(f"L1 (lasso)  : support={int((np.abs(x_l1) > 1e-8).sum())}, "
          f"|x - refit| = {err_l1:.4f}  (shrinkage bias)")

    g_mcp = MCP(lam=jnp.asarray(lam), beta=jnp.asarray(20.0))
    x_mcp, iters = SARAH(maxit=60, batch=64, block_sampling=True, m=N // 64)(
        z0, F=F, g=g_mcp, L=L, N=N
    )
    x_mcp = np.asarray(x_mcp)
    err_mcp = np.linalg.norm(x_mcp - x_ls_refit)
    print(f"MCP + SARAH : support={int((np.abs(x_mcp) > 1e-8).sum())}, "
          f"|x - refit| = {err_mcp:.6f}  ({iters} outer steps, unbiased)")
    assert set(np.flatnonzero(np.abs(x_mcp) > 1e-8)) == set(supp)
    assert err_mcp < 0.05 * err_l1

    # data-parallel on all available devices
    mesh = make_mesh()
    D = mesh.shape[DATA_AXIS]
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPSARAH(mesh=mesh, maxit=60, batch=8 * D, m=N // (8 * D))(
        z0, F=Fd, g=g_mcp, L=L
    )
    err_dp = np.linalg.norm(np.asarray(x_dp) - x_ls_refit)
    print(f"dp sarah x{D} : |x - refit| = {err_dp:.6f}")
    assert err_dp < 0.05 * err_l1


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main()
