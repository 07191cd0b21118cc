"""SARAH / ProxSARAH — recursive variance reduction (BEYOND the
reference).

The reference's variance-reduced families keep their gradient estimator
anchored at a FIXED point: SVRG's inner direction is
``∇f_i(w) − ∇f_i(z_full) + μ`` against the outer anchor
(``src/algorithms/SVRG/SVRG_basic.jl:74-80``), and SAGA's against the
per-index table (``SAGA_basic.jl:58-62``). SARAH (Nguyen, Liu,
Scheinberg, Takáč, "SARAH: A Novel Method for Machine Learning Problems
Using Stochastic Recursive Gradient", ICML 2017) instead RECURSES the
estimator through consecutive iterates,

    v_t = (1/B) Σ_B [∇f_i(w_t) − ∇f_i(w_{t−1})] + v_{t−1},

which drives the estimator's variance to zero along the trajectory
(SVRG's stays bounded away until the anchor refresh) and carries the
best known complexity for NONCONVEX finite sums (the SPIDER/SpiderBoost
bound O(√N/ε²)). The composite step is ProxSARAH's damped prox
(Pham, Nguyen, Phan, Tran-Dinh, JMLR 2020):

    y_{t+1} = prox_{γg}(w_t − γ v_t),   w_{t+1} = (1−η) w_t + η y_{t+1}

with η = 1 recovering plain prox-SARAH/SpiderBoost.

Data path: the inner recursion needs ∇f_i at TWO nearby points over
the SAME rows — exactly the ``grad_sum_diff_block`` read every oracle
already provides for SVRG/Katyusha (one contiguous-block row read per
inner step, two matvecs over it); the outer anchor ``v_0 = ∇f(x̃)`` is
the same one-pass ``grad_sum_all`` reduction as SVRG's.

API matches the reference-style facades: ``SARAH(...)(x0, F=F, g=g,
L=L, N=N)`` and ``.iterator(...)``; solution(state) = x̃ (the last
inner iterate of the previous outer step).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ciao_tpu.prox import Zero
from ciao_tpu.solvers.base import (
    SolverIterable,
    real_dtype_of,
    run_solver_loop,
)


class SARAHCfg(NamedTuple):
    N: int
    batch: int = 1
    m: int = 1           # stochastic inner steps per outer iterate (static)
    block: bool = False  # contiguous-block sampling (slices, no gather)


class SARAHState(NamedTuple):
    gamma: jnp.ndarray    # scalar stepsize
    eta: jnp.ndarray      # scalar ProxSARAH damping (1 = plain SARAH)
    x_tilde: jnp.ndarray  # (n,) outer iterate
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x_tilde


def _damped_prox(g, w, v, gamma, eta):
    """ProxSARAH update: w ← (1−η)w + η·prox_{γg}(w − γv)."""
    y = g.prox_only(w - gamma * v, gamma)
    return w + eta * (y - w)


@partial(jax.jit, static_argnames=("cfg",))
def sarah_init(F, g, x0, gamma, eta, key, cfg: SARAHCfg) -> SARAHState:
    """x̃ = x0 with no gradient work — the full-pass v₀ belongs to the
    outer step (so solution(init) == x0, matching the SVRG convention
    that a maxit=1-equivalent init returns x0 untouched)."""
    return SARAHState(
        gamma=gamma, eta=eta, x_tilde=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _sarah_inner(F, g, cfg, gamma, eta, sub, w_prev, w, v, steps):
    """``steps`` recursive inner iterations on the stateless (sub, k)
    block stream."""
    from ciao_tpu.solvers.saga import _block_start

    N, B = cfg.N, cfg.batch

    def inner(carry, k):
        w_prev, w, v = carry
        if cfg.block:
            start = _block_start(sub, k, N, B)
            diff = F.grad_sum_diff_block(w, w_prev, start, B)
        else:
            ik = jax.random.fold_in(sub, k)
            i = jax.random.randint(ik, (B,), 0, N, dtype=jnp.int32)
            diff = F.grad_sum_diff(w, w_prev, i)
        v = v + diff / B                     # the SARAH recursion
        w_next = _damped_prox(g, w, v, gamma, eta)
        return (w, w_next, v), None

    (w_prev, w, v), _ = jax.lax.scan(
        inner, (w_prev, w, v), jnp.arange(steps, dtype=jnp.int32)
    )
    return w_prev, w, v


def _sarah_step(F, g, cfg: SARAHCfg, state: SARAHState) -> SARAHState:
    """One outer iterate: the full-gradient bootstrap step plus m
    recursive inner steps. Sampling uses the same stateless
    (key, inner-k) streams as the SVRG/Katyusha inner loops."""
    N, m = cfg.N, cfg.m
    gamma, eta = state.gamma, state.eta
    key, sub = jax.random.split(state.key)

    v0 = F.grad_sum_all(state.x_tilde) / N
    w_prev = state.x_tilde
    w = _damped_prox(g, w_prev, v0, gamma, eta)
    _, w, _ = _sarah_inner(F, g, cfg, gamma, eta, sub, w_prev, w, v0, m)
    return state._replace(x_tilde=w, key=key, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def sarah_run(F, g, state, cfg: SARAHCfg, steps: int):
    def body(s, _):
        with jax.named_scope("sarah_outer"):
            return _sarah_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def sarah_step(F, g, state, cfg: SARAHCfg):
    return _sarah_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class SARAH:
    """Recursive variance-reduced solver (beyond the reference).

    ``m`` counts stochastic inner steps per outer iterate and defaults
    to N // batch (one epoch of row reads between anchors; one outer
    iterate then costs N + 2·m·batch component gradients). ``gamma``
    defaults to 1/(2 L_max) — the SpiderBoost large-step choice.
    ``eta`` < 1 selects ProxSARAH's damped iterate averaging (the
    nonconvex-composite safeguard); η = 1 is plain prox-SARAH.
    ``maxit`` counts outer iterates."""

    gamma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    batch: int = 1
    eta: float = 1.0
    block_sampling: bool = False  # contiguous inner blocks (slices)
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0 and self.batch >= 1
        assert 0.0 < self.eta <= 1.0

    def _setup(self, x0, F, g, L, N):
        x0 = jnp.asarray(x0)
        if N is None:
            if F is None:
                raise ValueError("provide F or N")
            N = F.num_terms
        if F is None:
            from ciao_tpu.oracles import ZeroOracle
            F = ZeroOracle(n_terms=N)
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "SARAH: provide the smoothness moduli L, or a stepsize γ"
                )
            gamma = 1.0 / (2.0 * jnp.max(jnp.asarray(L, rdt)))
        m = N // self.batch if self.m is None else self.m
        if m < 1:
            raise ValueError("SARAH: m must be >= 1")
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SARAH block_sampling needs N divisible by batch")
        cfg = SARAHCfg(N=N, batch=self.batch, m=m, block=self.block_sampling)
        key = jax.random.PRNGKey(self.seed)
        eta = jnp.asarray(self.eta, rdt)
        init = lambda: sarah_init(F, g, x0, gamma, eta, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return sarah_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: sarah_step(F, g, s, cfg)
        # the estimator re-anchors from a full pass every outer step,
        # so a storage switch self-heals: rebase is identity
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)
