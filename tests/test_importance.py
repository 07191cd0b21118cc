"""Importance (Lipschitz-proportional) block sampling for SAGA —
beyond the reference (cf. non-uniform SAG/SAGA, Schmidt-Le Roux-Bach).

Blocks are drawn with q_j ∝ L_j (max member modulus) through the same
stateless (key, it) stream as uniform block sampling; the direction is
reweighted by 1/(d·q_j) so it stays unbiased, and the default stepsize
scales with the MEAN block smoothness instead of the max. Tests pin
(a) the convergence win on the reference generator's ill-conditioned
planted lasso at a matched step budget, (b) the empirical visit
distribution, (c) the unbiasedness weight plumbing (exact table mean
maintained), and (d) the facade guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import NormL1
from ciao_tpu.utils.problems import make_lasso


def test_importance_beats_uniform_on_wide_L_spread():
    """The reference generator at this size plants column scales with a
    ~5x L spread; at a matched 16k-step budget importance sampling must
    land >=100x closer to the optimum (measured ~2600x with the mean-L
    stepsize vs uniform's max-L one — both runs deterministic)."""
    Np, npx = 1024, 64
    prob = make_lasso(N=Np, n=npx, p=6, seed=1)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(Np)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(npx, prob.A.dtype)
    steps = 16000
    xu, _ = ciao_tpu.SAGA(maxit=steps, batch=8, block_sampling=True)(
        z0, F=F, g=g, L=prob.L, N=Np
    )
    xi, _ = ciao_tpu.SAGA(
        maxit=steps, batch=8, block_sampling=True, importance_sampling=True
    )(z0, F=F, g=g, L=prob.L, N=Np)
    gap_u = prob.cost(np.asarray(xu)) - prob.f_star
    gap_i = prob.cost(np.asarray(xi)) - prob.f_star
    assert gap_i * 100 < gap_u, (gap_i, gap_u)


def test_importance_visit_distribution():
    """The stateless inverse-CDF draw visits block j with empirical
    frequency q_j ∝ L_j."""
    from ciao_tpu.solvers.saga import SAGACfg, SAGAState, _block_choice

    Np, B = 1024, 8
    prob = make_lasso(N=Np, n=64, p=6, seed=1)
    d = Np // B
    Lblk = np.max(np.asarray(prob.L).reshape(d, B), axis=1)
    q = Lblk / Lblk.sum()
    cfg = SAGACfg(N=Np, sag=False, batch=B, block=True, importance=True)
    st = SAGAState(
        s=None, gamma=None, av=None, z=None, key=jax.random.PRNGKey(0),
        it=jnp.zeros((), jnp.int32), status=None,
        qcum=jnp.cumsum(jnp.asarray(q)), qinv=jnp.asarray(1.0 / (d * q)),
    )
    draws = 50000
    f = jax.jit(jax.vmap(lambda it: _block_choice(cfg, st._replace(it=it))[0]))
    starts = np.asarray(f(jnp.arange(draws, dtype=jnp.int32)))
    emp = np.bincount(starts // B, minlength=d) / draws
    assert np.max(np.abs(emp - q)) < 0.15 * q.max()


def test_importance_table_mean_stays_exact():
    """The 1/(d·q_j) weight scales the DIRECTION only: the maintained
    running average must still equal the exact table mean after any
    number of steps (no importance bias leaks into av)."""
    N, n = 64, 8
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    from ciao_tpu.solvers.base import loop, take

    it = ciao_tpu.SAGA(
        maxit=30, batch=8, block_sampling=True, importance_sampling=True
    ).iterator(jnp.zeros(n, prob.A.dtype), F=F, g=g, L=prob.L, N=N)
    st = loop(take(iter(it), 25))
    av_exact = np.asarray(F.apply_all(st.s)) / N
    np.testing.assert_allclose(np.asarray(st.av), av_exact, rtol=1e-10,
                               atol=1e-12)


def test_importance_guards_and_uniform_L():
    """SAG rejects importance; block_sampling and L are required; a
    flat-L problem still converges (q degenerates to uniform)."""
    N, n = 64, 8
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    with pytest.raises(ValueError, match="SAGA only"):
        ciao_tpu.SAG(maxit=2, batch=8, block_sampling=True,
                     importance_sampling=True)(z0, F=F, g=g, L=prob.L, N=N)
    with pytest.raises(ValueError, match="block_sampling"):
        ciao_tpu.SAGA(maxit=2, importance_sampling=True)(
            z0, F=F, g=g, L=prob.L, N=N
        )
    with pytest.raises(ValueError, match="provide L"):
        ciao_tpu.SAGA(maxit=2, batch=8, block_sampling=True,
                      importance_sampling=True, gamma=1e-6)(z0, F=F, g=g, N=N)
    x, _ = ciao_tpu.SAGA(
        maxit=3000, batch=8, block_sampling=True, importance_sampling=True
    )(z0, F=F, g=g, L=prob.L, N=N)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_direct_cfg_importance_fused_or_sag_rejected():
    """SAGACfg is also constructed directly (not just via the facade);
    the step itself must reject importance+sag, whose average-first
    order ignores the 1/(d·q_j) unbiasedness weight (would silently
    bias the direction)."""
    from ciao_tpu.solvers.saga import SAGACfg, _saga_step

    bad = SAGACfg(N=8, sag=True, batch=2, block=True, importance=True)
    with pytest.raises(ValueError, match="importance"):
        _saga_step(None, None, bad, None)


def test_importance_cdf_built_in_float64():
    """The block CDF is built in f64 on host and renormalized so
    qcum[-1] == 1 exactly in the iterate dtype — a f32 cumsum over many
    blocks would skew the realized draw distribution away from the
    exact q used in the unbiasedness weights."""
    Np, npx, B = 4096, 8, 4
    prob = make_lasso(N=Np, n=npx, p=4, seed=0)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(float(Np)))
    g = NormL1(lam=jnp.asarray(prob.lam))
    solver = ciao_tpu.SAGA(maxit=1, block_sampling=True, batch=B,
                           importance_sampling=True)
    x0, F2, g2, cfg, init = solver._setup(jnp.zeros(npx), F, g,
                                          L=prob.L, N=Np)
    st = init()
    qcum = np.asarray(st.qcum, np.float64)
    assert qcum[-1] == 1.0
    assert np.all(np.diff(qcum) > 0)
    # weights consistent with the (renormalized) CDF: q_j = Δqcum
    q = np.diff(np.concatenate([[0.0], qcum]))
    d = Np // B
    np.testing.assert_allclose(np.asarray(st.qinv, np.float64),
                               1.0 / (d * q), rtol=1e-5)


def _powerlaw_lsq(Np=1024, npx=64, seed=1, span=1.5):
    """Consistent least-squares with log-uniform row scales 1..10^span:
    the wide block-L spread the reference generator lacks (~1.4x)."""
    rng = np.random.default_rng(seed)
    scale_row = 10.0 ** (span * np.arange(Np) / (Np - 1))
    A = rng.standard_normal((Np, npx)) * scale_row[:, None]
    x_true = rng.standard_normal(npx)
    b = A @ x_true
    L = Np * (A * A).sum(axis=1)
    return A, b, L


def test_finito_importance_facade_converges_and_guards():
    """Facade-level: Finito(importance_sampling=True) on the power-law
    instance converges much closer than the uniform RANDOM sweep at a
    matched budget (hot anchors refresh more often); guards reject the
    invalid combinations."""
    Np, npx = 1024, 64
    A, b, L = _powerlaw_lsq(Np, npx, seed=1)
    F = LeastSquaresRows(
        A=jnp.asarray(A), b=jnp.asarray(b), scale=jnp.asarray(float(Np)))
    g = NormL1(lam=jnp.asarray(1e-6))
    z0 = jnp.zeros(npx, A.dtype)
    steps = 16000
    xu, _ = ciao_tpu.Finito(maxit=steps, sweeping=1,
                            minibatch=(True, 8))(
        z0, F=F, g=g, L=L, N=Np)
    xi, _ = ciao_tpu.Finito(maxit=steps, sweeping=1, minibatch=(True, 8),
                            importance_sampling=True)(
        z0, F=F, g=g, L=L, N=Np)
    gap_u = float(np.sum((A @ np.asarray(xu) - b) ** 2))
    gap_i = float(np.sum((A @ np.asarray(xi) - b) ** 2))
    assert gap_i * 10 < gap_u, (gap_i, gap_u)

    with pytest.raises(ValueError, match="RANDOM"):
        ciao_tpu.Finito(maxit=2, sweeping=2, importance_sampling=True)
    with pytest.raises(ValueError, match="basic"):
        ciao_tpu.Finito(maxit=2, LFinito=True, importance_sampling=True)
    with pytest.raises(ValueError, match="coefficient"):
        ciao_tpu.Finito(maxit=2, table="full", importance_sampling=True)
    with pytest.raises(ValueError, match="provide L"):
        ciao_tpu.Finito(maxit=2, minibatch=(True, 8), gamma=0.1,
                        importance_sampling=True)(z0, F=F, g=g, N=Np)
