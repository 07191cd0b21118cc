"""Analysis sparsity to machine-certified accuracy:
``ciao_tpu.deep_solve_pd`` on the fused lasso.

The problem class — ``min ½‖Ax−b‖² + λ‖Dx‖₁`` with the difference
operator INSIDE the nonsmooth term — is the one the prox-of-g-only
reference cannot express at all (no prox of λ‖D·‖₁ exists in closed
form). Condat-Vũ solves it, but its f32 iterate floors at
rel ≈ (n/jumps)·eps: the TV term is enforced through the dual, flat
runs never become exactly flat, and h pays the noise FIRST order.
``deep_solve_pd`` runs compensated-gradient Condat-Vũ just to
IDENTIFICATION, then ``tv_refine`` — a certified exact reduced solve
on the identified jump set (compensated segment Gram + iterative
refinement + a KKT dual certificate) — and returns a point whose flat
runs are exactly flat in f32, at rel ~1e-10.

    python examples/fused_lasso_tv.py          # 65536×512
    python examples/fused_lasso_tv.py small    # CI smoke shapes

Reference anchor: none (beyond-reference capability); the planted
instance is ``make_fused_lasso_planted`` — SURVEY §4's planted-optimum
discipline applied to the h(Kx) class via a rank-1 KKT construction.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np

import ciao_tpu
from ciao_tpu import FirstDifference, LeastSquaresRows, NormL1
from ciao_tpu.utils import make_fused_lasso_planted


def main(N=65_536, n=512, jumps=12, small=False):
    if small:  # CI smoke shapes (tests/test_examples.py)
        N, n, jumps = 4_096, 128, 6
    prob = make_fused_lasso_planted(N=N, n=n, jumps=jumps, seed=0)
    F = LeastSquaresRows(A=jnp.asarray(prob.A, jnp.float32),
                         b=jnp.asarray(prob.b, jnp.float32),
                         scale=jnp.asarray(float(N), jnp.float32))
    h = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))

    x, info = ciao_tpu.deep_solve_pd(
        jnp.zeros(n, jnp.float32), F, h=h, K=FirstDifference(), N=N,
        chunk=4096, chunk_steps=256, max_steps=16_384,
    )
    rel = (prob.cost(np.asarray(x)) - prob.f_star) / abs(prob.f_star)
    d = np.abs(np.diff(np.asarray(x, np.float64)))
    true_J = np.abs(np.diff(prob.x_star)) > 0
    print(f"deep_solve_pd: rel suboptimality {rel:.3e} in {info.steps} "
          f"CV steps (refined={info.refined}, certified={info.certified}, "
          f"tau={info.tau:.3e})")
    print(f"jumps recovered {int(np.sum(d[true_J] > 1e-2))}/"
          f"{int(true_J.sum())}, spurious {int(np.sum(d[~true_J] > 0))} "
          f"(flat runs exactly flat: {bool(np.all(d[~true_J] == 0.0))})")
    assert info.refined and info.certified
    assert 0 <= rel < 1e-7, rel
    assert np.all(d[~true_J] == 0.0)
    return rel


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main(small="small" in sys.argv[1:])
