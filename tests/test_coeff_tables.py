"""Coefficient tables, row storage modes and storage switches.

The coefficient table (an (N,) vector instead of the (N, n) gradient
table) is an exact re-parameterization for rank-1 row oracles; these
tests pin it against the full table, and pin the bf16/int8 storage
modes and the rebase that a mid-run storage switch needs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import NormL1
from ciao_tpu.utils.problems import make_lasso


def test_saga_coeff_matches_full_table():
    """table='coeff' must reproduce table='full' trajectories exactly
    (the compression is algebraic, not approximate). f64 for tightness."""
    from ciao_tpu.solvers.saga import SAGA

    prob = make_lasso(N=32, n=8, p=3, seed=2)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(32.0))
    g = NormL1(lam=jnp.asarray(prob.lam))
    x0 = jnp.zeros(8)
    a, _ = SAGA(maxit=300, table="full")(x0, F=F, g=g, L=prob.L)
    c, _ = SAGA(maxit=300, table="coeff")(x0, F=F, g=g, L=prob.L)
    np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=1e-12, atol=1e-12)
    # block sampling mode too
    a2, _ = SAGA(maxit=300, table="full", block_sampling=True, batch=8)(
        x0, F=F, g=g, L=prob.L
    )
    c2, _ = SAGA(maxit=300, table="coeff", block_sampling=True, batch=8)(
        x0, F=F, g=g, L=prob.L
    )
    np.testing.assert_allclose(np.asarray(a2), np.asarray(c2), rtol=1e-12, atol=1e-12)


def test_finito_coeff_matches_full_table():
    from ciao_tpu.solvers.finito import Finito

    prob = make_lasso(N=32, n=8, p=3, seed=2)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(32.0))
    g = NormL1(lam=jnp.asarray(prob.lam))
    x0 = jnp.zeros(8)
    for sweeping in (2, 3):
        a, _ = Finito(maxit=200, sweeping=sweeping, minibatch=(True, 8),
                      table="full")(x0, F=F, g=g, L=prob.L)
        c, _ = Finito(maxit=200, sweeping=sweeping, minibatch=(True, 8),
                      table="coeff")(x0, F=F, g=g, L=prob.L)
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=1e-10, atol=1e-10)


def test_finito_coeff_bad_config_raises():
    from ciao_tpu.solvers.finito import Finito

    prob = make_lasso(N=32, n=8, p=3, seed=2)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(32.0))
    with pytest.raises(ValueError, match="coeff"):
        Finito(maxit=10, sweeping=1, table="coeff")(
            jnp.zeros(8), F=F, g=NormL1(lam=jnp.asarray(1.0)), L=prob.L
        )


def test_svrg_block_minibatch_converges():
    """The batched contiguous-block inner loop (beyond the reference's
    batch-1 inner loop) still solves the planted Lasso."""
    from ciao_tpu.solvers.svrg import SVRG

    Np, npix = 64, 16
    prob = make_lasso(N=Np, n=npix, p=4, seed=0)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(Np)),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    x, _ = SVRG(gamma=float(1.0 / (10.0 * np.max(prob.L))), maxit=400,
                batch=8, block_sampling=True)(
        jnp.zeros(npix), F=F, g=g, L=prob.L
    )
    assert float(prob.cost(x) - prob.f_star) < 1e-4


def test_bf16_storage_stepwise_xla_path():
    """The XLA paths must accept bf16-stored rows (mixed bf16·f32
    matmuls promote to f32)."""
    from ciao_tpu.solvers.saga import SAGACfg, saga_init, saga_run

    Np, npix, Bp = 512, 128, 128
    prob = make_lasso(N=Np, n=npix, p=4, seed=1, dtype=np.float32,
                      well_conditioned=True)
    F16 = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32), b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(Np), jnp.float32),
    ).with_storage()
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gamma = jnp.asarray(1.0 / (3.0 * np.max(prob.L)), jnp.float32)
    cfg = SAGACfg(N=Np, sag=False, batch=Bp, block=True, coeff=True)
    st = saga_run(F16, g, saga_init(F16, g, jnp.zeros(npix, jnp.float32),
                                    gamma, jax.random.PRNGKey(0), cfg),
                  cfg, 32)
    assert st.z.dtype == jnp.float32
    assert bool(jnp.all(jnp.isfinite(st.z)))


def test_make_lasso_well_conditioned_kkt():
    """The capped variant still plants an exact optimum (KKT: the dual
    certificate y* = b − A x* satisfies |A_j^T y*| ≤ λ everywhere, = λ
    with matching sign on the support) and bounds the column spread."""
    prob = make_lasso(N=256, n=64, p=8, seed=0, dtype=np.float64,
                      well_conditioned=True)
    y_star = prob.b - prob.A @ prob.x_star
    corr = prob.A.T @ y_star
    sup = prob.x_star != 0
    assert sup.sum() == 8
    np.testing.assert_allclose(corr[sup], prob.lam * np.sign(prob.x_star[sup]),
                               rtol=1e-10)
    assert np.all(np.abs(corr[~sup]) <= prob.lam * (1 + 1e-12))
    norms = np.linalg.norm(prob.A, axis=0)
    assert norms.max() / norms.min() < 3.0


def test_int8_storage_oracle_consistency():
    """``with_storage(int8)``: every oracle path computes EXACTLY with
    the perturbed operator Ã = diag(row_scale)·Q — the quantized paths
    must agree with a dense reference built from Ã, and Ã must be
    within the absmax-quantization error of A."""
    rng = np.random.default_rng(0)
    Np, npix = 64, 32
    A = rng.standard_normal((Np, npix)).astype(np.float32)
    b = rng.standard_normal(Np).astype(np.float32)
    F = LeastSquaresRows(
        A=jnp.asarray(A), b=jnp.asarray(b),
        scale=jnp.asarray(float(Np), jnp.float32),
    )
    Fq = F.with_storage("int8")
    assert Fq.A.dtype == jnp.int8 and Fq.row_scale.shape == (Np,)
    At = np.asarray(Fq.A, np.float32) * np.asarray(Fq.row_scale)[:, None]
    # quantization error ≤ rs/2 per element
    assert np.max(np.abs(At - A) / np.asarray(Fq.row_scale)[:, None]) <= 0.5
    Fd = LeastSquaresRows(A=jnp.asarray(At), b=jnp.asarray(b),
                          scale=jnp.asarray(float(Np), jnp.float32))
    x = jnp.asarray(rng.standard_normal(npix).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(Np).astype(np.float32))
    idx = jnp.asarray([3, 17, 41], jnp.int32)
    tol = dict(rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(Fq.grad_sum_all(x), Fd.grad_sum_all(x), **tol)
    np.testing.assert_allclose(Fq.grad_all(x), Fd.grad_all(x), **tol)
    np.testing.assert_allclose(Fq.coeff_all(x), Fd.coeff_all(x), **tol)
    np.testing.assert_allclose(Fq.apply_all(w), Fd.apply_all(w), **tol)
    np.testing.assert_allclose(Fq.coeff_block(x, 8, 16),
                               Fd.coeff_block(x, 8, 16), **tol)
    np.testing.assert_allclose(Fq.apply_rows_block(w[8:24], 8, 16),
                               Fd.apply_rows_block(w[8:24], 8, 16), **tol)
    np.testing.assert_allclose(Fq.grad_block(x, 8, 16),
                               Fd.grad_block(x, 8, 16), **tol)
    np.testing.assert_allclose(Fq.grad_sum_diff_block(x, 0.5 * x, 8, 16),
                               Fd.grad_sum_diff_block(x, 0.5 * x, 8, 16),
                               **tol)
    np.testing.assert_allclose(Fq.grad_sum_batch(x, idx),
                               Fd.grad_sum_batch(x, idx), **tol)
    np.testing.assert_allclose(Fq.value_and_grad_i(x, 3)[1],
                               Fd.value_and_grad_i(x, 3)[1], **tol)
    # TP margin split: scale applied AFTER the (possibly psum'd) margin
    np.testing.assert_allclose(
        Fq.coeff_from_margin_all(Fq.margin_all(x)), Fd.coeff_all(x), **tol)

    # logistic family, same contract
    y = jnp.asarray(np.sign(rng.standard_normal(Np)).astype(np.float32))
    from ciao_tpu.oracles import LogisticRows

    Lq = LogisticRows(X=jnp.asarray(A), y=y).with_storage(jnp.int8)
    Ld = LogisticRows(X=jnp.asarray(
        np.asarray(Lq.X, np.float32) * np.asarray(Lq.row_scale)[:, None]
    ), y=y)
    np.testing.assert_allclose(Lq.grad_sum_all(x), Ld.grad_sum_all(x), **tol)
    np.testing.assert_allclose(Lq.coeff_all(x), Ld.coeff_all(x), **tol)
    np.testing.assert_allclose(
        Lq.coeff_from_margin_all(Lq.margin_all(x)), Ld.coeff_all(x), **tol)


def test_saga_rebase_storage_switch():
    """Staged-precision schedules swap the oracle's row storage mid-run.
    The delta-maintained running average then still carries the OLD
    operator's bias (av was accumulated as Σ c_i·ã_i/N with the previous
    rows), which never decays — the run stalls near the quantization
    error. ``saga_rebase`` recomputes av from the coefficient table
    under the new rows (one pass) and restores convergence to the new
    storage's floor."""
    from ciao_tpu.solvers.saga import (
        SAGACfg, saga_init, saga_rebase, saga_run,
    )

    Np, npix, Bp = 2048, 128, 256
    prob = make_lasso(N=Np, n=npix, p=8, seed=0, dtype=np.float32,
                      well_conditioned=True)
    Fp = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32), b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(Np), jnp.float32),
    )
    Fq = Fp.with_storage("int8")
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gam = jnp.asarray(1.0 / (3.0 * np.max(prob.L)), jnp.float32)
    cfg = SAGACfg(N=Np, sag=False, batch=Bp, block=True, coeff=True)
    key = jax.random.PRNGKey(0)
    fs = abs(prob.f_star)

    def rel(z):
        return (prob.cost(np.asarray(z)) - prob.f_star) / fs

    st = saga_init(Fp, g, jnp.zeros(npix, jnp.float32), gam, key, cfg)
    st = saga_run(Fq, g, st, cfg, 8000)           # int8 coarse stage

    st_rb = saga_rebase(Fp, st, cfg)
    # algebraic contract: av consistent with the table under f32 rows
    np.testing.assert_allclose(
        np.asarray(st_rb.av), np.asarray(Fp.apply_all(st.s) / Np),
        rtol=1e-6, atol=1e-8,
    )
    # measured on this problem: the un-rebased finish stalls ~5.9e-5
    # while the rebased one reaches ~8.7e-7 (the f32 floor)
    r_nr = rel(saga_run(Fp, g, st, cfg, 30000).z)
    r_rb = rel(saga_run(Fp, g, st_rb, cfg, 30000).z)
    assert r_rb < 5e-6, r_rb
    assert r_nr > 1e-5, r_nr
    # full-table mode is storage-consistent already: rebase is identity
    cfg_t = SAGACfg(N=Np, sag=False, batch=Bp, block=True, coeff=False)
    st_t = saga_init(Fp, g, jnp.zeros(npix, jnp.float32), gam, key, cfg_t)
    st_t2 = saga_rebase(Fp, st_t, cfg_t)
    np.testing.assert_array_equal(np.asarray(st_t2.av), np.asarray(st_t.av))


def test_finito_rebase_storage_switch():
    """Finito coefficient mode has the same delta-maintained ``av`` as
    SAGA (``test_saga_rebase_storage_switch``): after an int8→f32
    storage swap, ``finito_rebase`` must restore the exact identity
    av = hat_γ·(Σ_j invg_j·zb_j − apply_all(c)/N) under the new rows
    (and re-prox z); the rebased finish must out-converge the stalled
    un-rebased one."""
    from ciao_tpu.solvers.finito import (
        FinitoCfg, finito_coeff_init, finito_rebase, finito_run,
    )

    Np, npix, Bp = 2048, 128, 256
    prob = make_lasso(N=Np, n=npix, p=8, seed=0, dtype=np.float32,
                      well_conditioned=True)
    Fp = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32), b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(Np), jnp.float32),
    )
    Fq = Fp.with_storage("int8")
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gamma = 0.999 * Np / jnp.asarray(prob.L, jnp.float32)
    cfg = FinitoCfg(N=Np, batch=Bp, sweeping=3, alpha=0.999)
    key = jax.random.PRNGKey(0)
    fs = abs(prob.f_star)

    def rel(z):
        return (prob.cost(np.asarray(z)) - prob.f_star) / fs

    st = finito_coeff_init(Fp, g, jnp.zeros(npix, jnp.float32), gamma, key, cfg)
    st = finito_run(Fq, g, st, cfg, "basic_coeff", 4000)  # int8 stage

    st_rb = finito_rebase(Fp, g, st, cfg)
    hat = np.asarray(st.hat_gamma)
    av_ref = hat * (np.asarray(st.invg) @ np.asarray(st.zb)) - (
        hat / Np
    ) * np.asarray(Fp.apply_all(st.c))
    np.testing.assert_allclose(np.asarray(st_rb.av), av_ref, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st_rb.z),
        np.asarray(g.prox_only(jnp.asarray(av_ref), st.hat_gamma)),
        rtol=1e-5, atol=1e-7,
    )

    # measured: un-rebased floors at ~8.1e-5, rebased reaches the f32
    # floor ~1.8e-5 on this problem
    r_nr = rel(finito_run(Fp, g, st, cfg, "basic_coeff", 12000).z)
    r_rb = rel(finito_run(Fp, g, st_rb, cfg, "basic_coeff", 12000).z)
    assert r_rb < 3e-5, r_rb
    assert r_nr > 5e-5, r_nr

