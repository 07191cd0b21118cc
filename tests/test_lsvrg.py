"""L-SVRG (beyond the reference — loopless variance reduction).

The reference's SVRG is epoch-structured; L-SVRG (Kovalev et al., ALT
2020) replaces the outer loop with a Bernoulli anchor jump. Tests pin
(a) the reference tolerance on the planted lasso, (b) the coin
semantics at its two degenerate settings (p=0: the anchor never moves;
p=1: the anchor tracks the pre-update iterate every step), (c) the
streaming-API invariants every solver obeys, (d) dtype coverage, and
(e) the DP path (replicated coin, one stacked psum per step) on the
8-device CPU mesh.
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
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    return prob, F, g


def x0(prob):
    return jnp.zeros(prob.A.shape[1], prob.A.dtype)


def test_lsvrg_converges(lasso):
    """Default settings (γ = 1/(6 L_max), p = batch/N) reach the
    reference tolerance on the planted lasso."""
    prob, F, g = lasso
    x, it = ciao_tpu.LSVRG(maxit=4000)(x0(prob), F=F, g=g, L=prob.L, N=N)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    assert it == 4000


def test_lsvrg_block_and_minibatch(lasso):
    """Contiguous-block sampling (slices, no gather) and minibatch > 1
    converge; block vs iid sampling genuinely differ; misconfiguration
    raises."""
    prob, F, g = lasso
    x, _ = ciao_tpu.LSVRG(maxit=4000, batch=8, block_sampling=True)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    xs = {}
    for blk in (False, True):
        xe, _ = ciao_tpu.LSVRG(maxit=20, batch=8, block_sampling=blk)(
            x0(prob), F=F, g=g, L=prob.L, N=N
        )
        xs[blk] = np.asarray(xe)
    assert not np.array_equal(xs[False], xs[True])
    with pytest.raises(ValueError, match="divisible"):
        ciao_tpu.LSVRG(maxit=2, batch=7, block_sampling=True)(
            x0(prob), F=F, g=g, L=prob.L, N=N
        )
    with pytest.raises(ValueError, match="provide L"):
        ciao_tpu.LSVRG(maxit=2)(x0(prob), F=F, g=g, N=N)


def test_lsvrg_coin_semantics(lasso):
    """p=0: the anchor (and its gradient) is frozen at x0 forever.
    p=1: after every step the anchor equals the PRE-update iterate
    (paper order, Kovalev et al. Alg. 2)."""
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    z0 = x0(prob)
    # p = 0 — anchor never jumps
    it0 = ciao_tpu.LSVRG(maxit=9, p=0.0).iterator(
        z0, F=F, g=g, L=prob.L, N=N
    )
    states = list(take(iter(it0), 9))
    for st in states:
        np.testing.assert_array_equal(np.asarray(st.z), np.asarray(z0))
        np.testing.assert_array_equal(
            np.asarray(st.av), np.asarray(states[0].av)
        )
    # p = 1 — anchor tracks the pre-update iterate
    it1 = ciao_tpu.LSVRG(maxit=9, p=1.0).iterator(
        z0, F=F, g=g, L=prob.L, N=N
    )
    states = list(take(iter(it1), 6))
    for prev, cur in zip(states, states[1:]):
        np.testing.assert_array_equal(np.asarray(cur.z),
                                      np.asarray(prev.w))


def test_lsvrg_iterator_invariants(lasso):
    """Streaming mode: solution(init) == x0, the iterator's k-th state
    matches a maxit=k solve (stateless (key, it) streams)."""
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    solver = ciao_tpu.LSVRG(maxit=5)
    it = solver.iterator(x0(prob), F=F, g=g, L=prob.L, N=N)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution),
                                  np.asarray(x0(prob)))
    x_batch, _ = solver(x0(prob), F=F, g=g, L=prob.L, N=N)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))


def test_lsvrg_complex_dtype():
    """c128 lasso (the reference dtype sweep): the coin/γ scalars stay
    real, iterates complex."""
    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    x, _ = ciao_tpu.LSVRG(maxit=4000)(z0, F=F, g=g, L=prob.L, N=N)
    assert x.dtype == prob.A.dtype
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_lsvrg_checkpoint_resume_and_rebase(tmp_path, lasso):
    """Checkpoint at step k and resume: the continuation matches the
    straight-through run exactly. A storage swap needs the rebase hook
    (the carried anchor gradient keeps the old operator's bias until
    the next coin fires): resume_iterator(rebase=True) recomputes μ at
    the current anchor under the NEW storage."""
    from ciao_tpu import checkpoint
    from ciao_tpu.solvers.base import loop, take
    from ciao_tpu.solvers.lsvrg import lsvrg_rebase, LSVRGCfg

    prob, F, g = lasso
    solver = ciao_tpu.LSVRG(maxit=40)
    z0 = x0(prob)
    st_full = loop(take(iter(solver.iterator(z0, F=F, g=g, L=prob.L, N=N)), 10))
    it1 = solver.iterator(z0, F=F, g=g, L=prob.L, N=N)
    st_mid = loop(take(iter(it1), 5))
    checkpoint.save(tmp_path / "lsvrg.npz", st_mid)
    restored = checkpoint.load(tmp_path / "lsvrg.npz")
    it2 = solver.iterator(z0, F=F, g=g, L=prob.L, N=N)
    resumed = loop(take(checkpoint.resume_iterator(it2, restored), 6))
    np.testing.assert_allclose(
        np.asarray(resumed.w), np.asarray(st_full.w),
        rtol=1e-12, atol=1e-14,
    )
    # rebase recomputes μ exactly at the current anchor point
    cfg = LSVRGCfg(N=N, batch=1, block=False)
    st_rb = lsvrg_rebase(F, g, st_mid, cfg)
    np.testing.assert_allclose(
        np.asarray(st_rb.av),
        np.asarray(F.grad_sum_all(st_mid.z) / N),
        rtol=1e-13,
    )


def test_dp_lsvrg_converges_and_coin(lasso):
    """DP L-SVRG on the 8-device mesh: block and iid sampling both
    reach the reference tolerance; the replicated coin keeps every
    device's anchor in sync (p=0 freezes it, matching single-chip
    semantics); one stacked psum per step by construction."""
    from ciao_tpu.parallel import DPLSVRG, make_mesh, shard_finite_sum
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    mesh = make_mesh()
    Fs = shard_finite_sum(F, mesh)
    for blk in (False, True):
        x, _ = DPLSVRG(mesh=mesh, maxit=4000, batch=8, block_sampling=blk)(
            x0(prob), F=Fs, g=g, L=prob.L, N=N
        )
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4, blk
    it0 = DPLSVRG(mesh=mesh, maxit=9, batch=8, p=0.0).iterator(
        x0(prob), F=Fs, g=g, L=prob.L, N=N
    )
    states = list(take(iter(it0), 6))
    for st in states:
        np.testing.assert_array_equal(np.asarray(st.z),
                                      np.asarray(x0(prob)))
        np.testing.assert_array_equal(np.asarray(st.av),
                                      np.asarray(states[0].av))


# ---------------------------------------------------------------------------
# L-Katyusha (the loopless accelerated sibling, same paper)
# ---------------------------------------------------------------------------

def test_lkatyusha_converges(lasso):
    """Default (σ̂=0, θ₁=1/3) and strongly-convex tunings reach the
    reference tolerance on the planted lasso."""
    prob, F, g = lasso
    x, _ = ciao_tpu.LKatyusha(maxit=3000)(x0(prob), F=F, g=g, L=prob.L, N=N)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    x, _ = ciao_tpu.LKatyusha(maxit=3000, sigma=1e-3)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    x, _ = ciao_tpu.LKatyusha(maxit=3000, theta1=0.4, batch=8,
                              block_sampling=True)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_lkatyusha_beats_lsvrg_on_ill_conditioned():
    """The acceleration claim for the LOOPLESS pair, pinned: at a
    matched step budget (identical per-step block read + expected
    refresh cost) on the reference generator's ill-conditioned planted
    lasso, L-Katyusha must be at least 100x closer to the optimum than
    L-SVRG."""
    Np, npx = 1024, 64
    prob = make_lasso(N=Np, n=npx, p=6, seed=1)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(Np)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(npx, prob.A.dtype)
    steps = 2000
    xk, _ = ciao_tpu.LKatyusha(maxit=steps, batch=8, block_sampling=True)(
        z0, F=F, g=g, L=prob.L, N=Np
    )
    xs, _ = ciao_tpu.LSVRG(maxit=steps, batch=8, block_sampling=True)(
        z0, F=F, g=g, L=prob.L, N=Np
    )
    gap_k = prob.cost(np.asarray(xk)) - prob.f_star
    gap_s = prob.cost(np.asarray(xs)) - prob.f_star
    assert gap_k * 100 < gap_s, (gap_k, gap_s)


def test_lkatyusha_iterator_and_coin(lasso):
    """solution(init) == x0; k-th iterator state == maxit=k solve;
    p=1: the anchor tracks the pre-update y sequence every step."""
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    solver = ciao_tpu.LKatyusha(maxit=5)
    it = solver.iterator(x0(prob), F=F, g=g, L=prob.L, N=N)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution),
                                  np.asarray(x0(prob)))
    x_batch, _ = solver(x0(prob), F=F, g=g, L=prob.L, N=N)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))
    it1 = ciao_tpu.LKatyusha(maxit=9, p=1.0).iterator(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    states = list(take(iter(it1), 6))
    for prev, cur in zip(states, states[1:]):
        np.testing.assert_array_equal(np.asarray(cur.w_anchor),
                                      np.asarray(prev.y))


def test_dp_lkatyusha_converges(lasso):
    """DP L-Katyusha on the 8-device mesh: block and iid sampling both
    reach the reference tolerance (one stacked psum per step)."""
    from ciao_tpu.parallel import DPLKatyusha, make_mesh, shard_finite_sum

    prob, F, g = lasso
    mesh = make_mesh()
    Fs = shard_finite_sum(F, mesh)
    for blk in (False, True):
        x, _ = DPLKatyusha(mesh=mesh, maxit=3000, batch=8,
                           block_sampling=blk)(
            x0(prob), F=Fs, g=g, L=prob.L, N=N
        )
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4, blk


def test_tp_loopless_pair_converges_and_shards():
    """TPLSVRG / TPLKatyusha on a (4 data x 2 model) mesh: per step one
    stacked (2,B) "model" margin psum + one x-shard "data" psum; the
    Bernoulli refresh runs its collectives inside the replicated-coin
    cond (every device takes the same branch). Both reach the
    reference tolerance; guards reject non-separable proxes."""
    from ciao_tpu.parallel import (
        TPLKatyusha,
        TPLSVRG,
        make_mesh_2d,
        shard_finite_sum_2d,
    )

    prob = make_lasso(N=N, n=8, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(8, prob.A.dtype)
    mesh2 = make_mesh_2d(4, 2)
    F2 = shard_finite_sum_2d(F, mesh2)
    x, _ = TPLSVRG(mesh=mesh2, maxit=2000, batch=2)(
        z0, F=F2, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    x, _ = TPLKatyusha(mesh=mesh2, maxit=2000, batch=2)(
        z0, F=F2, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    from ciao_tpu.prox import NormNuclear

    with pytest.raises(ValueError, match="separable"):
        TPLSVRG(mesh=mesh2, maxit=2)(
            z0, F=F2, g=NormNuclear(lam=0.1), L=prob.L, N=N
        )

