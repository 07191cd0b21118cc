"""Each family's XLA block step against a plain f64 numpy version of the
same step: a few steps from the same start, on the same blocks, for
every rank-1 loss and every row storage (f32, bf16, int8 rows; f32
iterates). The numpy side rebuilds the algebra from the papers' update
rules and shares nothing with the library but the block draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rowref import MODES, STORAGES, np_coeff, row_problem

from ciao_tpu.prox import NormL1
from ciao_tpu.solvers.saga import _block_start

N, n, B, LAM = 64, 12, 16, 0.02
KEY = jax.random.PRNGKey(7)


def soft(w, t):
    return np.sign(w) * np.maximum(np.abs(w) - t, 0.0)


def grad_sum(mode, Ad, off, x, sl=slice(None)):
    """Σ_i ∇f_i(x) = Σ_i c_i(a_i·x)·a_i over the rows ``sl``."""
    return np_coeff(mode, Ad[sl] @ x, off[sl]) @ Ad[sl]


def start_of(key, it):
    return int(_block_start(key, jnp.int32(it), N, B))


def run_saga(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.saga import SAGACfg, saga_init, saga_step

    gam = 0.1
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True)
    st = saga_init(F, g, jnp.asarray(x0, jnp.float32), jnp.float32(gam),
                   KEY, cfg)
    for _ in range(3):
        st = saga_step(F, g, st, cfg)
    c = np_coeff(mode, Ad @ x0, off)
    av = c @ Ad / N
    z = soft((1 - gam) * x0, gam * LAM)
    for it in (1, 2, 3):
        sl = slice(start_of(KEY, it), start_of(KEY, it) + B)
        c_new = np_coeff(mode, Ad[sl] @ z, off[sl])
        innov = (c_new - c[sl]) @ Ad[sl]
        w = z - gam * (innov / B + av)
        av = av + innov / N
        z = soft(w, gam * LAM)
        c[sl] = c_new
    return st.z, z


def run_finito(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.finito import (
        FinitoCfg, finito_coeff_init, finito_step,
    )

    gamma = np.linspace(0.5, 1.5, N)
    cfg = FinitoCfg(N=N, batch=B, sweeping=2, alpha=0.999)
    st = finito_coeff_init(F, g, jnp.asarray(x0, jnp.float32),
                           jnp.asarray(gamma, jnp.float32), KEY, cfg)
    for _ in range(3):
        st = finito_step(F, g, st, cfg, "basic_coeff")
    c = np_coeff(mode, Ad @ x0, off)
    inv = 1.0 / gamma
    hat = 1.0 / inv.sum()
    av = hat * inv.sum() * x0 - (hat / N) * (c @ Ad)
    z = soft(av, hat * LAM)
    invg = inv.reshape(N // B, B).sum(axis=1)
    zb = np.tile(x0, (N // B, 1))
    for j in (1, 2, 3):               # cyclic sweep from position 1
        sl = slice(j * B, (j + 1) * B)
        c_new = np_coeff(mode, Ad[sl] @ z, off[sl])
        av = av + hat * invg[j] * (z - zb[j]) - (hat / N) * (
            (c_new - c[sl]) @ Ad[sl])
        c[sl] = c_new
        zb[j] = z
        z = soft(av, hat * LAM)
    return st.z, z


def run_svrg(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.svrg import SVRGCfg, svrg_init, svrg_step

    gam, m = 0.1, 3
    cfg = SVRGCfg(N=N, plus=False, batch=B, block=True)
    st = svrg_init(F, g, jnp.asarray(x0, jnp.float32), jnp.float32(gam), m,
                   KEY, cfg)
    st = svrg_step(F, g, st, cfg)
    _, sub = jax.random.split(KEY)
    av = grad_sum(mode, Ad, off, x0) / N
    w, zsum = x0.copy(), np.zeros(n)
    for k in range(m):
        s = start_of(sub, k)
        sl = slice(s, s + B)
        d = (grad_sum(mode, Ad, off, x0, sl)
             - grad_sum(mode, Ad, off, w, sl)) / B
        w = soft(w + gam * (d - av), gam * LAM)
        zsum = zsum + w
    return st.z_full, zsum / m


def run_lsvrg(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.lsvrg import (
        LSVRGCfg, _coin, lsvrg_init, lsvrg_step,
    )

    gam, p = 0.1, 0.5
    cfg = LSVRGCfg(N=N, batch=B, block=True)
    st = lsvrg_init(F, g, jnp.asarray(x0, jnp.float32), jnp.float32(gam),
                    jnp.float32(p), KEY, cfg)
    for _ in range(3):
        st = lsvrg_step(F, g, st, cfg)
    z, w = x0.copy(), x0.copy()
    av = grad_sum(mode, Ad, off, z) / N
    for it in (1, 2, 3):
        sl = slice(start_of(KEY, it), start_of(KEY, it) + B)
        d = (grad_sum(mode, Ad, off, z, sl)
             - grad_sum(mode, Ad, off, w, sl))
        w_new = soft(w + gam * (d / B - av), gam * LAM)
        if bool(_coin(KEY, jnp.int32(it), jnp.float32(p))):
            z, av = w, grad_sum(mode, Ad, off, w) / N
        w = w_new
    return st.w, w


def run_ssnm(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.ssnm import SSNMCfg, ssnm_init, ssnm_step

    tau, eta = 0.5, 0.1
    cfg = SSNMCfg(N=N, batch=B)
    st = ssnm_init(F, g, jnp.asarray(x0, jnp.float32), jnp.float32(tau),
                   jnp.float32(eta), KEY, cfg)
    for _ in range(3):
        st = ssnm_step(F, g, st, cfg)
    c = np_coeff(mode, Ad @ x0, off)
    gbar = c @ Ad / N
    zb = np.tile(x0, (N // B, 1))
    x = x0.copy()
    for it in (1, 2, 3):
        s = start_of(KEY, it)
        sl, j = slice(s, s + B), s // B
        y = tau * x + (1 - tau) * zb[j]
        c_new = np_coeff(mode, Ad[sl] @ y, off[sl])
        innov = (c_new - c[sl]) @ Ad[sl]
        x = soft(x - eta * (innov / B + gbar), eta * LAM)
        gbar = gbar + innov / N
        c[sl] = c_new
        zb[j] = y
    return st.x, x


def run_fista(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.fb import FBCfg, fb_init, fb_step

    gam = 0.5
    cfg = FBCfg(N=N, fast=True)
    st = fb_init(F, g, jnp.asarray(x0, jnp.float32), jnp.float32(gam), cfg)
    for _ in range(3):
        st = fb_step(F, g, st, cfg)
    x, y, t = x0.copy(), x0.copy(), 1.0
    for _ in range(3):
        x_new = soft(y - gam * grad_sum(mode, Ad, off, y) / N, gam * LAM)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return st.x, x


def run_katyusha(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.katyusha import (
        KatyushaCfg, katyusha_init, katyusha_step,
    )

    Lmax, tau1, tau2, m = 4.0, 0.3, 0.5, 3
    cfg = KatyushaCfg(N=N, batch=B, m=m, block=True)
    st = katyusha_init(F, g, jnp.asarray(x0, jnp.float32),
                       jnp.float32(Lmax), jnp.float32(tau1),
                       jnp.float32(tau2), KEY, cfg)
    st = katyusha_step(F, g, st, cfg)
    _, sub = jax.random.split(KEY)
    alpha, beta = 1.0 / (3.0 * tau1 * Lmax), 1.0 / (3.0 * Lmax)
    av = grad_sum(mode, Ad, off, x0) / N
    y, z, ysum = x0.copy(), x0.copy(), np.zeros(n)
    for k in range(m):
        x = tau1 * z + tau2 * x0 + (1.0 - tau1 - tau2) * y
        sl = slice(start_of(sub, k), start_of(sub, k) + B)
        gr = av + (grad_sum(mode, Ad, off, x, sl)
                   - grad_sum(mode, Ad, off, x0, sl)) / B
        z = soft(z - alpha * gr, alpha * LAM)
        y = soft(x - beta * gr, beta * LAM)
        ysum = ysum + y
    return st.x_tilde, ysum / m


def run_lkatyusha(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.lsvrg import (
        LKatyushaCfg, _coin, lkatyusha_init, lkatyusha_step,
    )

    Lmax, sig, th1, th2, p = 4.0, 0.1, 0.3, 0.5, 0.5
    cfg = LKatyushaCfg(N=N, batch=B, block=True)
    st = lkatyusha_init(F, g, jnp.asarray(x0, jnp.float32),
                        jnp.float32(Lmax), jnp.float32(sig),
                        jnp.float32(th1), jnp.float32(th2), jnp.float32(p),
                        KEY, cfg)
    for _ in range(3):
        st = lkatyusha_step(F, g, st, cfg)
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / Lmax
    denom = 1.0 + eta * sig
    y, z, w = x0.copy(), x0.copy(), x0.copy()
    av = grad_sum(mode, Ad, off, w) / N
    for it in (1, 2, 3):
        x = th1 * z + th2 * w + (1.0 - th1 - th2) * y
        sl = slice(start_of(KEY, it), start_of(KEY, it) + B)
        gr = av + (grad_sum(mode, Ad, off, x, sl)
                   - grad_sum(mode, Ad, off, w, sl)) / B
        z_new = soft((z + eta * sig * x - step * gr) / denom,
                     step / denom * LAM)
        y_new = x + th1 * (z_new - z)
        if bool(_coin(KEY, jnp.int32(it), jnp.float32(p))):
            w, av = y, grad_sum(mode, Ad, off, y) / N
        y, z = y_new, z_new
    return st.y, y


def run_sarah(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.sarah import SARAHCfg, sarah_init, sarah_step

    gam, eta, m = 0.1, 0.7, 3
    cfg = SARAHCfg(N=N, batch=B, m=m, block=True)
    st = sarah_init(F, g, jnp.asarray(x0, jnp.float32), jnp.float32(gam),
                    jnp.float32(eta), KEY, cfg)
    st = sarah_step(F, g, st, cfg)
    _, sub = jax.random.split(KEY)

    def damped(w, v):
        return w + eta * (soft(w - gam * v, gam * LAM) - w)

    v = grad_sum(mode, Ad, off, x0) / N
    w_prev, w = x0, damped(x0, v)
    for k in range(m):
        sl = slice(start_of(sub, k), start_of(sub, k) + B)
        v = v + (grad_sum(mode, Ad, off, w, sl)
                 - grad_sum(mode, Ad, off, w_prev, sl)) / B
        w_prev, w = w, damped(w, v)
    return st.x_tilde, w


def run_lfinito(mode, F, Ad, off, g, x0):
    from ciao_tpu.solvers.finito import FinitoCfg, finito_step, lfinito_init

    gamma = np.linspace(0.5, 1.5, N)
    cfg = FinitoCfg(N=N, batch=B, sweeping=2, alpha=0.999)
    st = lfinito_init(F, g, jnp.asarray(x0, jnp.float32),
                      jnp.asarray(gamma, jnp.float32), KEY, cfg)
    order = np.asarray(st.sweep.order)
    st = finito_step(F, g, st, cfg, "lfinito")
    hat = 1.0 / np.sum(1.0 / gamma)
    av = x0 - (hat / N) * grad_sum(mode, Ad, off, x0)
    z_full = soft(av, hat * LAM)
    av = z_full - (hat / N) * grad_sum(mode, Ad, off, z_full)
    for j in order:                     # one epoch of block updates
        z = soft(av, hat * LAM)
        sl = slice(j * B, (j + 1) * B)
        av = (av + (hat / N) * (grad_sum(mode, Ad, off, z_full, sl)
                                - grad_sum(mode, Ad, off, z, sl))
              + hat * np.sum(1.0 / gamma[sl]) * (z - z_full))
    return st.av, av


def _prox_coeff(mode, mz, na, gam, b):
    """θ with θ = c(mz − γ‖a‖²θ): the rank-1 prox of one row, by
    bisection (θ − c(mz − γ‖a‖²θ) increases in θ)."""
    lo, hi = np.full_like(mz, -1e4), np.full_like(mz, 1e4)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        up = mid - np_coeff(mode, mz - gam * na * mid, b) > 0
        lo, hi = np.where(up, lo, mid), np.where(up, mid, hi)
    return 0.5 * (lo + hi)


def run_point_saga(mode, F, Ad, off, g, x0):
    from ciao_tpu.prox import Zero
    from ciao_tpu.solvers.point_saga import (
        PointSAGACfg, point_saga_init, point_saga_step,
    )

    gam = 0.5
    cfg = PointSAGACfg(N=N, batch=B, block=True)
    st = point_saga_init(F, Zero(), jnp.asarray(x0, jnp.float32),
                         jnp.float32(gam), KEY, cfg)
    for _ in range(3):
        st = point_saga_step(F, Zero(), st, cfg)
    c = np_coeff(mode, Ad @ x0, off)
    av, x = c @ Ad / N, x0.copy()
    for it in (1, 2, 3):
        sl = slice(start_of(KEY, it), start_of(KEY, it) + B)
        v = x - gam * av
        na = np.sum(Ad[sl] ** 2, axis=1)
        theta = _prox_coeff(mode, Ad[sl] @ v + gam * c[sl] * na, na, gam,
                            off[sl])
        u = (c[sl] - theta) @ Ad[sl]
        x = v + (gam / B) * u
        av = av - u / N
        c[sl] = theta
    return st.x, x


FAMILIES = {"saga": run_saga, "finito": run_finito, "lfinito": run_lfinito,
            "svrg": run_svrg, "katyusha": run_katyusha, "sarah": run_sarah,
            "lsvrg": run_lsvrg, "lkatyusha": run_lkatyusha,
            "point_saga": run_point_saga, "ssnm": run_ssnm,
            "fista": run_fista}


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_stepwise_matches_f64_reference(family, mode, storage):
    F, Ad, off = row_problem(mode, storage, N, n)
    g = NormL1(lam=jnp.asarray(LAM, jnp.float32))
    x0 = (np.random.default_rng(3).standard_normal(n) * 0.3).astype(
        np.float32).astype(np.float64)
    got, ref = FAMILIES[family](mode, F, Ad, off, g, x0)
    got = np.asarray(got, np.float64)
    assert got.dtype == np.float64 and np.all(np.isfinite(got))
    # f32 steps against f64 arithmetic on the same stored rows; the
    # Poisson prox solves θ through exp in f32, which amplifies rounding
    tol = 2e-4 if (family, mode) == ("point_saga", "poisson") else 2e-5
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
