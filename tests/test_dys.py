"""Davis-Yin three-operator splitting / Douglas-Rachford (beyond the
reference — the ProximalAlgorithms.jl three-term surface). Pins: the
h=0 degeneration to forward-backward, the f=0 Douglas-Rachford case
against a closed-form optimum, a binding box-constrained lasso against
the combined-prox FISTA, the iterator invariants, and the DP
trajectory equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import IndBox, NormL1, SqrDistPoint, Zero
from ciao_tpu.prox.base import ProxOperator, register_prox
from ciao_tpu.utils.problems import make_lasso

N, n = 64, 8


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    return prob, F, g


def x0(prob):
    return jnp.zeros(prob.A.shape[1], prob.A.dtype)


@register_prox
@dataclasses.dataclass(frozen=True)
class _L1Box(ProxOperator):
    """prox of lam|.|_1 + ind[-c,c] — for a 1-D convex objective the
    interval-constrained minimizer is the clipped unconstrained one, so
    this combined prox is EXACT: clip(soft(x, gamma*lam), -c, c)."""

    lam: jnp.ndarray = 1.0
    c: jnp.ndarray = 1.0

    def value(self, x):
        return self.lam * jnp.sum(jnp.abs(x))

    def prox_only(self, x, gamma):
        s = jnp.sign(x) * jnp.maximum(jnp.abs(x) - gamma * self.lam, 0)
        return jnp.clip(s, -self.c, self.c)


def test_dys_h_zero_equals_forward_backward(lasso):
    """With h = Zero the Davis-Yin recursion collapses to ISTA on the
    x_g sequence: xg_{k+1} = FB-step^k applied to prox_g(x0)."""
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    k = 25
    dys = ciao_tpu.DavisYin(maxit=k + 1).iterator(
        x0(prob), F=F, g=g, h=Zero(), L=prob.L, N=N
    )
    states = list(take(iter(dys), k + 1))
    gamma = 1.0 / np.mean(prob.L)
    start = g.prox_only(x0(prob), jnp.asarray(gamma))
    xf, _ = ciao_tpu.ForwardBackward(maxit=k)(start, F=F, g=g, L=prob.L, N=N)
    np.testing.assert_allclose(
        np.asarray(states[-1].solution), np.asarray(xf),
        rtol=1e-12, atol=1e-14,
    )


def test_douglas_rachford_closed_form():
    """f = 0 (Douglas-Rachford): min (1/2)||x-b||^2 + lam*||x||_1 has
    the closed-form optimum soft(b, lam)."""
    b = jnp.asarray(np.linspace(-2.0, 2.0, 16))
    lam = 0.7
    g = SqrDistPoint(b=b, rho=jnp.asarray(1.0))
    h = NormL1(lam=jnp.asarray(lam))
    x, it = ciao_tpu.DouglasRachford(maxit=400)(
        jnp.zeros(16, b.dtype), g=g, h=h, N=1
    )
    x_star = np.sign(np.asarray(b)) * np.maximum(np.abs(np.asarray(b)) - lam, 0)
    np.testing.assert_allclose(np.asarray(x), x_star, rtol=0, atol=1e-8)
    assert it == 400


def test_sqrdistpoint_prox_is_the_minimizer():
    """Brute-force the 1-D prox of (rho/2)(x-b)^2 on a grid."""
    rng = np.random.default_rng(0)
    xv, bv, rho, gam = 1.3, -0.4, 2.0, 0.7
    grid = np.linspace(-5, 5, 200001)
    obj = 0.5 * rho * (grid - bv) ** 2 + (grid - xv) ** 2 / (2 * gam)
    p = SqrDistPoint(b=jnp.asarray(bv), rho=jnp.asarray(rho))
    z = float(p.prox_only(jnp.asarray(xv), gam))
    assert abs(z - grid[np.argmin(obj)]) < 1e-4


def test_dys_box_constrained_lasso(lasso):
    """Lasso + a BINDING box: Davis-Yin (g = L1, h = IndBox) must match
    the combined-prox FISTA (exact prox of L1+box) — the three-operator
    split needs no combined prox, that's its point."""
    prob, F, g = lasso
    c = 0.5 * float(np.max(np.abs(prob.x_star)))  # binds the support
    h = IndBox(lo=-c, hi=c)
    x_dys, _ = ciao_tpu.DavisYin(maxit=6000)(
        x0(prob), F=F, g=g, h=h, L=prob.L, N=N
    )
    comb = _L1Box(lam=jnp.asarray(prob.lam), c=jnp.asarray(c))
    x_ref, _ = ciao_tpu.FISTA(maxit=6000)(x0(prob), F=F, g=comb, L=prob.L, N=N)
    # the constraint actually binds (else the test is vacuous)
    assert np.max(np.abs(np.asarray(x_ref))) >= c - 1e-9
    assert np.max(np.abs(np.asarray(x_dys))) <= c + 1e-9
    np.testing.assert_allclose(np.asarray(x_dys), np.asarray(x_ref),
                               rtol=0, atol=2e-6)


def test_dys_iterator_invariants(lasso):
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    h = IndBox(lo=-1.0, hi=1.0)
    solver = ciao_tpu.DavisYin(maxit=5)
    it = solver.iterator(x0(prob), F=F, g=g, h=h, L=prob.L, N=N)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution),
                                  np.asarray(x0(prob)))
    x_batch, _ = solver(x0(prob), F=F, g=g, h=h, L=prob.L, N=N)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))
    with pytest.raises(ValueError, match="smoothness"):
        ciao_tpu.DavisYin(maxit=2)(x0(prob), F=F, g=g, h=h, N=N)


def test_tp_davis_yin_matches_single_chip(lasso):
    """TPDavisYin on the (4,2) ("data","model") mesh: deterministic
    method, separable proxes — the 2-D-sharded trajectory must equal
    single-chip to reduction-order tolerance; the per-coordinate box
    bounds shard over "model" (model_prox_specs)."""
    from ciao_tpu.parallel import (
        TPDavisYin, make_mesh_2d, shard_finite_sum_2d,
    )

    prob, F, g = lasso
    h = IndBox(lo=-0.6 * jnp.ones(n), hi=0.6 * jnp.ones(n))
    z0 = x0(prob)
    mesh = make_mesh_2d(4, 2)
    Fd = shard_finite_sum_2d(F, mesh)
    x_tp, _ = TPDavisYin(mesh=mesh, maxit=300)(z0, F=Fd, g=g, h=h,
                                               L=prob.L, N=N)
    x_sc, _ = ciao_tpu.DavisYin(maxit=300)(z0, F=F, g=g, h=h, L=prob.L, N=N)
    np.testing.assert_allclose(np.asarray(x_tp), np.asarray(x_sc),
                               rtol=1e-9, atol=1e-12)
    # the guards actually guard
    import pytest as _pytest

    from ciao_tpu.prox import NormNuclear

    with _pytest.raises(ValueError, match="separable"):
        TPDavisYin(mesh=mesh, maxit=2)(z0, F=Fd, g=NormNuclear(
            lam=jnp.asarray(0.1)), h=h, L=prob.L, N=N)


def test_tp_douglas_rachford_f_zero():
    """TPDouglasRachford (f = 0 over the 2-D mesh) must actually run —
    ZeroOracle has no margin protocol, so the step body special-cases
    it — and reach the closed-form soft-threshold optimum."""
    from ciao_tpu.parallel import TPDouglasRachford, make_mesh_2d

    nn = 16
    b = jnp.asarray(np.linspace(-2.0, 2.0, nn))
    lam = 0.7
    x, _ = TPDouglasRachford(mesh=make_mesh_2d(4, 2), maxit=400)(
        jnp.zeros(nn, b.dtype), g=SqrDistPoint(b=b, rho=jnp.asarray(1.0)),
        h=NormL1(lam=jnp.asarray(lam)), N=8,
    )
    x_star = np.sign(np.asarray(b)) * np.maximum(np.abs(np.asarray(b)) - lam, 0)
    np.testing.assert_allclose(np.asarray(x), x_star, rtol=0, atol=1e-8)


def test_dp_davis_yin_matches_single_chip(lasso):
    """DPDavisYin on the 8-device mesh: deterministic method, so the
    sharded trajectory must equal single-chip to reduction-order
    tolerance."""
    from ciao_tpu.parallel import DPDavisYin, make_mesh, shard_finite_sum

    prob, F, g = lasso
    h = IndBox(lo=-0.6, hi=0.6)
    z0 = x0(prob)
    mesh = make_mesh()
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPDavisYin(mesh=mesh, maxit=300)(z0, F=Fd, g=g, h=h,
                                               L=prob.L, N=N)
    x_sc, _ = ciao_tpu.DavisYin(maxit=300)(z0, F=F, g=g, h=h, L=prob.L, N=N)
    np.testing.assert_allclose(np.asarray(x_dp), np.asarray(x_sc),
                               rtol=1e-9, atol=1e-12)
