"""SVRG / SVRG++ solver family.

Re-design of reference ``src/algorithms/SVRG/SVRG_basic.jl``: outer
iterate = m variance-reduced inner prox steps + a full-gradient anchor
refresh. The inner loop runs as a ``lax.fori_loop`` with the (dynamic)
trip count ``m`` carried in state, so SVRG++'s doubling schedule
(SVRG_basic.jl:93) needs no re-compilation; the anchor refresh is one
full-pass matmul + (when sharded) a psum.

Init quirks preserved: z_full = x0, inner sum z = 0, w = x0
(SVRG_basic.jl:64-67) — so solution(init state) == x0 and a maxit=1
solve returns x0; default γ = 1/(10 L_max) with the Theorem-3.1
ρ < 1 convergence check warning (SVRG_basic.jl:44-52); plus-mode
requires an explicit γ (SVRG_basic.jl:33-35) and the facade caps maxit
at 25 (SVRG.jl:62-65).
"""

from __future__ import annotations

import dataclasses
import warnings
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


class SVRGCfg(NamedTuple):
    N: int
    plus: bool
    batch: int = 1      # inner-loop minibatch size (reference is 1)
    block: bool = False  # uniform CONTIGUOUS block per inner step


class SVRGState(NamedTuple):
    gamma: jnp.ndarray      # scalar
    m: jnp.ndarray          # dynamic inner-loop length (int32)
    av: jnp.ndarray         # (n,) full-gradient anchor
    z: jnp.ndarray          # (n,) running inner sum
    z_full: jnp.ndarray     # (n,) outer iterate
    w: jnp.ndarray          # (n,) inner iterate
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):  # reference: solution(state) = state.z_full
        return self.z_full


@partial(jax.jit, static_argnames=("cfg",))
def svrg_init(F, g, x0, gamma, m, key, cfg: SVRGCfg) -> SVRGState:
    av = F.grad_sum_all(x0) / cfg.N
    return SVRGState(
        gamma=gamma,
        m=jnp.asarray(m, jnp.int32),
        av=av,
        z=jnp.zeros_like(x0),
        z_full=x0,
        w=x0,
        key=key,
        it=jnp.ones((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


def _svrg_inner_block(F, g, cfg: SVRGCfg, z_full, av, gamma, w, zsum, key,
                      steps):
    """``steps`` inner iterations on uniformly-drawn CONTIGUOUS blocks
    of ``cfg.batch`` samples (dynamic slices, minibatch-averaged
    variance-reduced direction). The inner index is drawn by the
    stateless (key, k) schedule of saga._block_start."""
    from ciao_tpu.solvers.saga import _block_start

    B = cfg.batch

    def inner(k, carry):
        w, zsum = carry
        start = _block_start(key, k, cfg.N, B)
        d = F.grad_sum_diff_block(z_full, w, start, B) / B
        w = g.prox_only(w + gamma * (d - av), gamma)
        return w, zsum + w

    return jax.lax.fori_loop(0, steps, inner, (w, zsum))


def _svrg_step(F, g, cfg: SVRGCfg, state: SVRGState) -> SVRGState:
    """Outer iterate (SVRG_basic.jl:71-96): m inner steps with indices
    drawn iid WITH replacement (rand(ind, m), :73), then anchor refresh."""
    N = cfg.N
    gamma, av = state.gamma, state.av
    key, sub = jax.random.split(state.key)

    if cfg.block:
        w, zsum = _svrg_inner_block(
            F, g, cfg, state.z_full, av, gamma, state.w, state.z, sub,
            state.m,
        )
        m_val = state.m
    else:

        def inner(k, carry):
            w, zsum, key = carry
            key, ik = jax.random.split(key)
            i = jax.random.randint(ik, (1,), 0, N, dtype=jnp.int32)
            # anchor-minus-live in ONE oracle-row read (grad_sum_diff
            # fuses the two gradients; for linear-gradient oracles it is
            # a single matvec pair over the same gathered row)
            d = F.grad_sum_diff(state.z_full, w, i)
            w = g.prox_only(w + gamma * (d - av), gamma)
            return w, zsum + w, key

        w, zsum, _ = jax.lax.fori_loop(
            0, state.m, inner, (state.w, state.z, sub)
        )
        m_val = state.m
    z_full = zsum / m_val.astype(jnp.real(zsum).dtype)
    w_next = w if cfg.plus else z_full
    av_next = F.grad_sum_all(z_full) / N
    m_next = state.m * 2 if cfg.plus else state.m
    return state._replace(
        m=m_next,
        av=av_next,
        z=jnp.zeros_like(zsum),
        z_full=z_full,
        w=w_next,
        key=key,
        it=state.it + 1,
    )


@partial(jax.jit, static_argnames=("cfg", "steps"))
def svrg_run(F, g, state, cfg: SVRGCfg, steps: int):
    def body(s, _):
        with jax.named_scope("svrg_outer"):
            return _svrg_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def svrg_step(F, g, state, cfg: SVRGCfg):
    return _svrg_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class SVRG:
    """SVRG facade (reference ``SVRG.jl:24-44``). ``m`` defaults to N
    (SVRG.jl:59); ``plus=True`` activates SVRG++."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    m: Optional[int] = None
    plus: bool = False
    batch: int = 1       # inner-loop minibatch (beyond the reference)
    block_sampling: bool = False  # contiguous inner blocks (slices)
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0
        assert self.freq > 0
        assert self.batch >= 1

    def _effective_maxit(self):
        if self.plus and self.maxit > 25:
            warnings.warn(
                "exponential number of inner updates...reverted to 25 maximum iterations"
            )
            return 25
        return self.maxit

    def _setup(self, x0, F, g, L, mu, N):
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
        m = N if self.m is None else self.m
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if self.plus:
                raise ValueError("SVRG++: provide a stepsize γ")
            if L is None or mu is None:
                raise ValueError(
                    "SVRG: smoothness or convexity parameter absent — provide L and μ, or γ"
                )
            L_max = float(jnp.max(jnp.asarray(L, rdt)))
            mu_max = float(jnp.max(jnp.asarray(mu, rdt)))
            gam = 1.0 / (10.0 * L_max)
            # Theorem 3.1 convergence condition (SVRG_basic.jl:44-52)
            rho = (1 + 4 * L_max * gam**2 * mu_max * (N + 1)) / (
                mu_max * gam * N * (1 - 4 * L_max * gam)
            )
            if rho >= 1:
                warnings.warn("convergence condition violated...provide a stepsize!")
            gamma = jnp.asarray(gam, rdt)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SVRG block_sampling needs N divisible by batch")
        cfg = SVRGCfg(
            N=N, plus=self.plus, batch=self.batch,
            block=self.block_sampling,
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: svrg_init(F, g, x0, gamma, m, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, mu=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, mu, N)

        def run_chunk(state, n):
            return svrg_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self._effective_maxit(), self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, mu=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, mu, N)
        step = lambda s: svrg_step(F, g, s, cfg)
        # SVRG recomputes its anchor from a full pass every outer
        # step, so a storage switch self-heals: rebase is identity
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)
