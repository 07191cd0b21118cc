"""Deep accuracy as one call: ``ciao_tpu.deep_solve``.

Every f32 stochastic solver floors at rel ~√N·eps — the full-gradient
REDUCTION's rounding, not the iterate's resolution. ``deep_solve``
packages the answer: staged block SAGA to that plateau, then
compensated-gradient monotone FISTA with an automatic curvature-bound
stepsize (η = 0.9/λ̂ from ``ciao_tpu.power_lmax`` — loss-generic
through the margin-curvature protocol). The run asserts rel ≤ 1e-6;
chip_smoke.py's ``deep`` phase runs it on the GPU.

    python examples/deep_accuracy.py          # 1M×128
    python examples/deep_accuracy.py small    # CI smoke shapes

Reference anchor: the reference's accuracy comes from f64 end-to-end
(``src/algorithms/Finito/Finito_basic.jl:14``); this is the f32 route
to the same numbers.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

import ciao_tpu
from ciao_tpu import LeastSquaresRows, NormL1
from ciao_tpu.utils.problems import make_lasso


def main(N=1024 * 1024, n=128, batch=8_192, small=False):
    if small:  # CI smoke shapes (tests/test_examples.py)
        N, batch = 4_096, 256
    prob = make_lasso(N=N, n=n, p=16, seed=0, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(A=jnp.asarray(prob.A, jnp.float32),
                         b=jnp.asarray(prob.b, jnp.float32),
                         scale=jnp.asarray(float(N), jnp.float32))
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))

    x, info = ciao_tpu.deep_solve(
        jnp.zeros(n, jnp.float32), F, g, L=prob.L, N=N,
        batch=batch, chunk_epochs=8, max_epochs=128, plateau_rtol=1e-4,
    )
    rel = (prob.cost(np.asarray(x)) - prob.f_star) / abs(prob.f_star)
    print(f"deep_solve: rel suboptimality {rel:.3e} "
          f"({sum(info.staged.epochs)} SAGA epochs + {info.polish_steps} "
          f"polish steps; lambda_max {info.lmax:.3e}, eta {info.eta:.3e})")
    assert rel <= 1e-6, rel
    return rel


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main(small="small" in sys.argv[1:])
