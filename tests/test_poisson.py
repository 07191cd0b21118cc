"""Poisson-regression rows (count-data GLM — beyond the reference;
ProximalOperators.jl has no Poisson likelihood). Pins: gradients/values
vs autodiff, the margin (TP) protocol, the Newton per-row prox vs brute
force, a sparse Poisson-GLM acceptance run, and the DP path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu import PoissonRows
from ciao_tpu.prox import NormL1, SqrNormL2

N, n = 256, 32


@pytest.fixture(scope="module")
def glm_data():
    """Planted log-linear model: y_i ~ Poisson(exp(a_i·x*)), margins
    kept within a few units so the clamp never binds on the solve
    path."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n)) * (1.2 / np.sqrt(n))
    x_true = np.zeros(n)
    x_true[:4] = [2.0, -1.6, 1.2, -1.0]
    lam = np.exp(A @ x_true)
    y = rng.poisson(lam).astype(np.float64)
    return A, y, x_true


def _oracle(A, y, scale=1.0, dtype=jnp.float64):
    Aa = jnp.asarray(A, dtype)
    return PoissonRows(A=Aa, y=jnp.asarray(y, dtype),
                       scale=jnp.asarray(scale, dtype))


def test_grads_match_autodiff(glm_data):
    A, y, _ = glm_data
    F = _oracle(A, y, scale=3.0)

    def f_i(x, i):
        m = jnp.asarray(A[i]) @ x
        return 3.0 * (jnp.exp(m) - y[i] * m)

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(n) * 0.3)
    for i in (0, 3, 17):
        v, g1 = F.value_and_grad_i(x, i)
        np.testing.assert_allclose(float(v), float(f_i(x, i)), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(g1),
                                   np.asarray(jax.grad(f_i)(x, i)),
                                   rtol=1e-9, atol=1e-12)
    gs = F.grad_sum_all(x)
    ga = sum(F.value_and_grad_i(x, i)[1] for i in range(N))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ga),
                               rtol=1e-8, atol=1e-9)
    vv, gg = F.value_sum_and_grad_sum_all(x)
    np.testing.assert_allclose(float(vv),
                               sum(float(F.value_and_grad_i(x, i)[0])
                                   for i in range(N)), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(gg), np.asarray(ga),
                               rtol=1e-8, atol=1e-9)


def test_margin_protocol_and_clamp_consistency(glm_data):
    A, y, _ = glm_data
    F = _oracle(A, y, scale=2.0)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(n) * 0.3)
    r = F.margin_all(x)
    c = F.coeff_from_margin_all(r)
    np.testing.assert_allclose(np.asarray(c), np.asarray(F.coeff_all(x)),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(F.apply_all(c)),
                               np.asarray(F.grad_sum_all(x)), rtol=1e-9)
    np.testing.assert_allclose(
        float(F.value_from_margin_all(r)), float(F.value_sum_all(x)),
        rtol=1e-12,
    )
    np.testing.assert_allclose(np.asarray(F.coeff_block(x, 32, 32)),
                               np.asarray(c[32:64]), rtol=1e-12)
    # past the clamp the pair stays a consistent C¹ function:
    # coeff == d(value)/dm by central difference straddling M
    for mm in (29.0, 30.0, 31.0, 50.0):
        m0 = jnp.asarray(mm, jnp.float64)
        cc = float(F._coeff_from_margin(m0, 1.0))
        fd = float(F._val_from_margin(m0 + 1e-6, 1.0)
                   - F._val_from_margin(m0 - 1e-6, 1.0)) / 2e-6
        assert abs(cc - fd) < 1e-2 * max(1.0, abs(fd)), (mm, cc, fd)
        assert np.isfinite(cc)


def test_pointprox_newton_vs_brute(glm_data):
    """θ from the Newton solve must minimize the per-row prox objective
    f_j(z) + ‖z − v‖²/(2γ) along the rank-1 line z = z_j − γθa."""
    A, y, _ = glm_data
    F = _oracle(A, y, scale=2.0)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal(n) * 0.1)
    gamma = 0.3
    c_B = jnp.asarray(rng.standard_normal(4) * 0.5)
    idx = jnp.asarray([1, 5, 9, 40])
    theta, u = F.pointprox_batch(v, c_B, gamma, idx)
    for k in range(4):
        j = int(idx[k])
        a = A[j]
        na2 = float(a @ a)
        mz = float(a @ np.asarray(v)) + gamma * float(c_B[k]) * na2
        grid = np.linspace(-60, 60, 1200001)
        m = mz - gamma * na2 * grid
        obj = 2.0 * (np.exp(np.minimum(m, 30.0)) - y[j] * m) \
            + 0.5 * gamma * na2 * grid ** 2
        t_star = grid[np.argmin(obj)]
        assert abs(float(theta[k]) - t_star) < 2e-3, (k, float(theta[k]),
                                                      t_star)
    # the innovation Σ(c−θ)a matches its definition
    w = np.asarray(c_B) - np.asarray(theta)
    np.testing.assert_allclose(np.asarray(u), w @ A[np.asarray(idx)],
                               rtol=1e-9, atol=1e-12)


def test_sparse_poisson_glm_acceptance(glm_data):
    """Sparse Poisson regression (L1): the VR solvers reach the PANOC
    optimum and recover the planted support; ridge-regularized runs
    (strongly convex, unique optimum) agree across SAGA/Katyusha/DP."""
    A, y, x_true = glm_data
    F = _oracle(A, y)
    # margins stay within ±2.5 on the solve path (planted m std 0.64):
    # a tight trust region keeps γ = 1/(3 L_max) honest
    L = np.asarray(F.local_smoothness(2.5))
    x0 = jnp.zeros(n)

    # λ = λ_max/10 (λ_max = ‖∇f(0)‖_∞ zeroes the solution): the planted
    # support enters, nuisance coords threshold out
    lam_max = float(jnp.max(jnp.abs(F.grad_sum_all(x0)))) / N
    g1 = NormL1(lam=jnp.asarray(0.1 * lam_max))
    x_ref, _ = ciao_tpu.PANOC(maxit=100)(x0, F=F, g=g1, L=L, N=N)
    xv = np.asarray(x_ref)
    # planted support dominates; bulk of nuisance coords at exactly 0
    assert np.all(np.abs(xv[:4]) > 0.1)
    assert (np.abs(xv[4:]) < 1e-12).sum() > (n - 4) // 2
    # statistical (finite-N Poisson noise) recovery, not exact
    assert np.corrcoef(xv[:4], x_true[:4])[0, 1] > 0.9

    # exp-margin GLM is much worse-conditioned than the trust-region L
    # suggests: plain SAGA crawls (1e-3 at 625 epochs), the accelerated
    # family reaches the optimum — pin both at their measured budgets
    x_saga, _ = ciao_tpu.SAGA(maxit=20000, batch=8, block_sampling=True)(
        x0, F=F, g=g1, L=L, N=N)
    np.testing.assert_allclose(np.asarray(x_saga), xv, rtol=0, atol=2e-3)
    x_kat, _ = ciao_tpu.Katyusha(maxit=150, batch=8, block_sampling=True)(
        x0, F=F, g=g1, L=L, N=N)
    np.testing.assert_allclose(np.asarray(x_kat), xv, rtol=0, atol=5e-4)

    # Point-SAGA (no composite g): stationarity of the smooth GLM fit —
    # at a stepsize 30× the SAGA-safe default (the prox step's selling
    # point: stable where the gradient step diverges)
    gamma_big = 10.0 / float(L.max())
    x_ps, _ = ciao_tpu.PointSAGA(maxit=8000, gamma=gamma_big)(
        x0, F=F, L=L, N=N)
    gnorm = float(jnp.linalg.norm(F.grad_sum_all(x_ps))) / N
    assert gnorm < 1e-5, gnorm


def test_dp_poisson_matches_single_chip(glm_data):
    """The Poisson oracle rides the generic dense-rows protocol: DP
    SAGA reaches the same ridge-regularized optimum with no
    oracle-specific code."""
    from ciao_tpu.parallel import DPSAGA, make_mesh, shard_finite_sum

    A, y, _ = glm_data
    F = _oracle(A, y)
    g2 = SqrNormL2(lam=jnp.asarray(0.05))
    L = np.asarray(F.local_smoothness(4.0))
    x0 = jnp.zeros(n)
    x_sc, _ = ciao_tpu.SAGA(maxit=3000, batch=8, block_sampling=True)(
        x0, F=F, g=g2, L=L, N=N)
    mesh = make_mesh()
    x_dp, _ = DPSAGA(mesh=mesh, maxit=3000, batch=8, block_sampling=True)(
        x0, F=shard_finite_sum(F, mesh), g=g2, L=L)
    np.testing.assert_allclose(np.asarray(x_dp), np.asarray(x_sc),
                               rtol=0, atol=5e-4)
