"""Katyusha (beyond the reference — accelerated variance reduction).

The reference has no accelerated method; Katyusha shares SVRG's data
path (anchor + one row read per inner step) and must (a) hit the
reference tolerances on the planted problems, (b) demonstrably beat
SVRG at a MATCHED gradient-evaluation budget on an ill-conditioned
problem (the O(√κ) vs O(κ) rate gap — the reason it exists here), and
(c) obey the streaming-API invariants every solver obeys.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import NormL1
from ciao_tpu.utils.problems import make_lasso

N, n = 64, 8


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    return prob, F, g


def x0(prob):
    return jnp.zeros(prob.A.shape[1], prob.A.dtype)


def test_katyusha_ns_converges(lasso):
    """Non-strongly-convex schedule (τ₁ₛ = 2/(s+4)) reaches the
    reference tolerance on the planted lasso."""
    prob, F, g = lasso
    x, it = ciao_tpu.Katyusha(maxit=30)(x0(prob), F=F, g=g, L=prob.L, N=N)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    assert it == 30


def test_katyusha_sigma_and_tau1_modes(lasso):
    """Strong-convexity τ₁ from σ, and an explicit τ₁ override."""
    prob, F, g = lasso
    # τ₁ = min(√(m·B·σ/(3·L_max)), 1/2): L_max ≈ 600 here, so σ = 1
    # puts τ₁ ≈ 0.27 — a sensible strongly-convex setting
    x, _ = ciao_tpu.Katyusha(maxit=60, sigma=1.0)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    x, _ = ciao_tpu.Katyusha(maxit=80, tau1=0.3)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_katyusha_block_matches_quality_and_minibatch(lasso):
    """Contiguous-block sampling (slices, no gather) and minibatch > 1
    both converge; misconfiguration raises."""
    prob, F, g = lasso
    x, _ = ciao_tpu.Katyusha(maxit=60, batch=8, block_sampling=True)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    with pytest.raises(ValueError, match="divisible"):
        ciao_tpu.Katyusha(maxit=2, batch=7, block_sampling=True)(
            x0(prob), F=F, g=g, L=prob.L, N=N
        )
    with pytest.raises(ValueError, match="smoothness"):
        ciao_tpu.Katyusha(maxit=2)(x0(prob), F=F, g=g, N=N)


def test_katyusha_beats_svrg_on_ill_conditioned():
    """The acceleration claim, pinned: at a MATCHED budget (Katyusha
    m=2N/B inner batches + anchor ≈ SVRG m=2N/B + anchor per outer
    step) on the reference generator's ill-conditioned planted lasso
    (column norms spread ~1000x at this size), Katyusha must be at
    least 100x closer to the optimum. Measured: 2.8e-2 vs 1.1e+3 at
    30 outers."""
    Np, npx = 1024, 64
    prob = make_lasso(N=Np, n=npx, p=6, seed=1)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(Np)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(npx, prob.A.dtype)
    xk, _ = ciao_tpu.Katyusha(maxit=30, batch=8, block_sampling=True)(
        z0, F=F, g=g, L=prob.L, N=Np
    )
    xs, _ = ciao_tpu.SVRG(
        maxit=30, m=2 * Np // 8, batch=8, block_sampling=True,
        gamma=1.0 / (10 * float(np.max(prob.L))),
    )(z0, F=F, g=g, L=prob.L, N=Np)
    gap_k = prob.cost(np.asarray(xk)) - prob.f_star
    gap_s = prob.cost(np.asarray(xs)) - prob.f_star
    assert gap_k * 100 < gap_s, (gap_k, gap_s)


def test_katyusha_iterator_invariants(lasso):
    """Streaming mode: solution(init) == x0 (anchor convention), the
    iterator's k-th state matches a maxit=k solve (same stateless
    streams), zero-copy solution view."""
    from ciao_tpu.solvers.base import loop, take

    prob, F, g = lasso
    solver = ciao_tpu.Katyusha(maxit=5)
    it = solver.iterator(x0(prob), F=F, g=g, L=prob.L, N=N)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution),
                                  np.asarray(x0(prob)))
    x_batch, _ = solver(x0(prob), F=F, g=g, L=prob.L, N=N)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))


def test_katyusha_complex_dtype():
    """c128 lasso (the reference dtype sweep) through the momentum
    coupling: τ scalars stay real, iterates complex."""
    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    x, _ = ciao_tpu.Katyusha(maxit=40)(z0, F=F, g=g, L=prob.L, N=N)
    assert x.dtype == prob.A.dtype
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_katyusha_checkpoint_resume_and_storage(tmp_path, lasso):
    """Checkpoint at outer step k and resume: the continuation matches
    the straight-through run exactly (stateless (key, it) streams).
    Narrow row storage rides the oracle: bf16 rows converge to the
    bf16 resolution floor; the anchor refresh self-heals a storage
    switch (rebase identity)."""
    from ciao_tpu import checkpoint
    from ciao_tpu.solvers.base import loop, take

    prob, F, g = lasso
    solver = ciao_tpu.Katyusha(maxit=40)
    z0 = x0(prob)
    st_full = loop(take(iter(solver.iterator(z0, F=F, g=g, L=prob.L, N=N)), 10))
    it1 = solver.iterator(z0, F=F, g=g, L=prob.L, N=N)
    st_mid = loop(take(iter(it1), 5))
    checkpoint.save(tmp_path / "kat.npz", st_mid)
    restored = checkpoint.load(tmp_path / "kat.npz")
    it2 = solver.iterator(z0, F=F, g=g, L=prob.L, N=N)
    resumed = loop(take(checkpoint.resume_iterator(it2, restored), 6))
    np.testing.assert_allclose(
        np.asarray(resumed.x_tilde), np.asarray(st_full.x_tilde),
        rtol=1e-12, atol=1e-14,
    )

    # bf16 rows: iterates stay f32, trajectory lands near the optimum
    # at bf16 gradient resolution
    prob32 = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.float32,
                        well_conditioned=True)
    F16 = ciao_tpu.LeastSquaresRows(
        A=jnp.asarray(prob32.A, jnp.float32),
        b=jnp.asarray(prob32.b, jnp.float32),
        scale=jnp.asarray(float(N), jnp.float32),
    ).with_storage()
    g32 = NormL1(lam=jnp.asarray(prob32.lam, jnp.float32))
    x, _ = ciao_tpu.Katyusha(maxit=60)(
        jnp.zeros(n, jnp.float32), F=F16, g=g32, L=prob32.L, N=N
    )
    assert x.dtype == jnp.float32
    rel = (prob32.cost(np.asarray(x)) - prob32.f_star) / abs(prob32.f_star)
    assert rel < 2e-2, rel


def test_beyond_reference_families_complex_dtype():
    """Complex dtypes are a reference-mandated capability
    (test_lasso.jl:3); the beyond-reference families support them too —
    c128 planted lasso solved to machine precision by each (Point-SAGA
    solves the smooth problem, so it is pinned against the
    least-squares optimum)."""
    import numpy as np

    from ciao_tpu.solvers.fb import FISTA
    from ciao_tpu.solvers.lsvrg import LKatyusha, LSVRG
    from ciao_tpu.solvers.point_saga import PointSAGA
    from ciao_tpu.solvers.sarah import SARAH

    prob = make_lasso(N=64, n=8, p=3, seed=3, dtype=np.complex128)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(64.0),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    x0v = jnp.zeros(8, jnp.complex128)
    runs = [
        ciao_tpu.Katyusha(maxit=300)(x0v, F=F, g=g, L=prob.L),
        SARAH(maxit=300)(x0v, F=F, g=g, L=prob.L),
        LSVRG(maxit=8000)(x0v, F=F, g=g, L=prob.L),
        LKatyusha(maxit=8000)(x0v, F=F, g=g, L=prob.L),
        FISTA(maxit=3000)(x0v, F=F, g=g, L=prob.L),
    ]
    for x, _ in runs:
        assert np.asarray(x).dtype == np.complex128
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-8

    xp, _ = PointSAGA(maxit=20000,
                      gamma=10.0 / float(np.max(prob.L)))(x0v, F=F, L=prob.L)
    xs, *_ = np.linalg.lstsq(np.asarray(prob.A), np.asarray(prob.b),
                             rcond=None)
    assert np.asarray(xp).dtype == np.complex128
    assert float(np.max(np.abs(np.asarray(xp) - xs))) < 1e-8
