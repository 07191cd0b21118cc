"""SVRG++ local-inner vs lockstep at D>1 — the convergence-rate study
(round 5, VERDICT r4 #4; clears the long-standing CLAUDE.md queue item).

Finding: on the 8-device CPU mesh the two modes track each other
round-for-round until deep into the run, and the ROUND GAP to a fixed
relative target is Δr ∈ {0, 1} — NOT the 4-round gap the tiny N=32 CI
instance once suggested (that gap was a small-sample artifact: with
b_loc=1 each device's shard held 4 indices). Because SVRG++ doubles m
every round, Δr is exactly the cost exponent: local pays ≤ 2^Δr ≤ 2×
the inner steps of lockstep to the same target, and it pays 2
collectives per OUTER round where lockstep pays one per INNER step.

This test pins the measured envelope so a regression in the local-inner
drift (e.g. in the warm-start w average) shows up as Δr > 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.parallel import DPSVRG, make_mesh
from ciao_tpu.prox import NormL1
from ciao_tpu.utils.problems import make_lasso


@pytest.mark.parametrize("seed", [0, 1])
def test_svrgpp_local_round_gap_envelope_at_d8(seed):
    Np, npx, m0 = 1024, 32, 8
    mesh = make_mesh()           # the 8-device CI mesh
    prob = make_lasso(N=Np, n=npx, p=4, seed=seed, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32),
        b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(Np), jnp.float32))
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    x0 = jnp.zeros(npx, jnp.float32)

    def gap(z):
        return ((prob.cost(np.asarray(z, np.float64)) - prob.f_star)
                / abs(prob.f_star))

    rounds_to_1e3 = {}
    for li in (False, True):
        sol = DPSVRG(mesh=mesh, maxit=1, batch=8, m=m0, plus=True,
                     local_inner=li)
        _, _, _, init, step, _, _ = sol._setup(x0, F, g, prob.L, Np)
        st = init()
        r_cross = None
        for r in range(1, 14):
            st = step(st)
            if gap(st.z_full) <= 1e-3:
                r_cross = r
                break
        assert r_cross is not None, f"local_inner={li} never reached 1e-3"
        rounds_to_1e3[li] = r_cross

    d_r = rounds_to_1e3[True] - rounds_to_1e3[False]
    # measured Δr ∈ {0, 1} (seeds 0: 11 vs 10; 1: 12 vs 11); the
    # envelope where local still wins wall-clock is 2^Δr < 2.2 (an
    # earlier local crossing is algorithmically fine — only the upper
    # bound is the regression guard)
    assert d_r <= 1, rounds_to_1e3
