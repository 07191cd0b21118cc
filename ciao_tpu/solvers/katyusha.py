"""Katyusha — accelerated variance reduction (BEYOND the reference).

The reference's fastest family on ill-conditioned problems is plain
SVRG (``src/algorithms/SVRG/SVRG_basic.jl``), whose rate degrades with
the condition number κ; Katyusha (Allen-Zhu, "Katyusha: The First
Direct Acceleration of Stochastic Gradient Methods", JMLR 2018) wraps
the same anchor-diff estimator in a three-point momentum coupling and
converges in O(√κ) epochs. It is included here because it shares the
ENTIRE data path of our SVRG: one contiguous-block row read per inner
step (``grad_sum_diff_block`` fuses the live and anchor gradients over
the same gathered rows) plus O(n) vector algebra — the three-sequence
update is a few elementwise ops next to the block's row read.

Per inner step (Option II, minibatch mean over block B):

    x   = τ₁ z + τ₂ x̃ + (1 − τ₁ − τ₂) y
    ∇̃  = μ + (1/B) Σ_B [∇f_i(x) − ∇f_i(x̃)]        μ = ∇f(x̃), anchor
    z⁺  = prox_{αg}(z − α ∇̃)            α = 1/(3 τ₁ L_max)
    y⁺  = prox_{βg}(x − β ∇̃)            β = 1/(3 L_max)

and per outer step x̃ ← mean of the epoch's y iterates, anchor
refreshed at x̃ (one full pass). τ₂ = 1/2; τ₁ from the strong-convexity
modulus σ (τ₁ = min(√(m·B·σ/(3 L_max)), 1/2)) or, when σ is unknown,
the non-strongly-convex schedule τ₁ₛ = 2/(s+4) with α re-derived per
epoch (Katyusha^ns).

API matches the reference-style facades: ``Katyusha(...)(x0, F=F, g=g,
L=L, N=N)`` and ``.iterator(...)``; solution(state) = x̃.
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


class KatyushaCfg(NamedTuple):
    N: int
    batch: int = 1
    m: int = 1          # inner steps per outer iterate (static)
    block: bool = False  # contiguous-block sampling (slices, no gather)
    ns: bool = False     # non-strongly-convex τ₁ₛ = 2/(s+4) schedule


class KatyushaState(NamedTuple):
    Lmax: jnp.ndarray       # scalar smoothness bound (drives α, β)
    tau1: jnp.ndarray       # scalar momentum weight of the CURRENT epoch
    tau2: jnp.ndarray       # scalar anchor weight (constant)
    av: jnp.ndarray         # (n,) full-gradient anchor μ = ∇f(x̃)
    x_tilde: jnp.ndarray    # (n,) outer iterate (anchor point)
    y: jnp.ndarray          # (n,) gradient-step sequence
    z: jnp.ndarray          # (n,) mirror-step sequence
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x_tilde


@partial(jax.jit, static_argnames=("cfg",))
def katyusha_init(F, g, x0, Lmax, tau1, tau2, key,
                  cfg: KatyushaCfg) -> KatyushaState:
    """Anchor bootstrap at x0 (one full gradient pass); y = z = x̃ = x0,
    so solution(init) == x0 — matching the SVRG init convention."""
    av = F.grad_sum_all(x0) / cfg.N
    return KatyushaState(
        Lmax=Lmax, tau1=tau1, tau2=tau2, av=av, x_tilde=x0, y=x0, z=x0,
        key=key, it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _katyusha_schedule(cfg, state):
    """(τ₁, τ₂, α, β) of the CURRENT outer step."""
    rdt = jnp.zeros((), jnp.result_type(state.y)).real.dtype
    if cfg.ns:
        # Katyusha^ns epoch schedule: s = it − 1 outer steps done
        s = (state.it - 1).astype(rdt)
        tau1 = 2.0 / (s + 4.0)
    else:
        tau1 = state.tau1
    alpha = 1.0 / (3.0 * tau1 * state.Lmax)
    beta = 1.0 / (3.0 * state.Lmax)
    return tau1, state.tau2, alpha, beta


def _katyusha_inner(F, g, cfg, xt, av, tau1, tau2, alpha, beta, sub,
                    y, z, ysum, steps):
    """``steps`` inner iterations on the stateless (sub, k) block
    stream."""
    from ciao_tpu.solvers.saga import _block_start

    N, B = cfg.N, cfg.batch

    def inner(carry, k):
        y, z, ysum = carry
        x = tau1 * z + tau2 * xt + (1.0 - tau1 - tau2) * y
        if cfg.block:
            start = _block_start(sub, k, N, B)
            diff = F.grad_sum_diff_block(x, xt, start, B)
        else:
            ik = jax.random.fold_in(sub, k)
            i = jax.random.randint(ik, (B,), 0, N, dtype=jnp.int32)
            diff = F.grad_sum_diff(x, xt, i)
        gr = av + diff / B          # ∇̃ = μ + mean anchor-to-live diff
        z = g.prox_only(z - alpha * gr, alpha)
        y = g.prox_only(x - beta * gr, beta)
        return (y, z, ysum + y), None

    (y, z, ysum), _ = jax.lax.scan(
        inner, (y, z, ysum), jnp.arange(steps, dtype=jnp.int32)
    )
    return y, z, ysum


def _katyusha_step(F, g, cfg: KatyushaCfg, state: KatyushaState):
    """One outer iterate: m momentum-coupled inner steps + the anchor
    refresh. Sampling uses the stateless (key, outer-it, inner-k)
    stream of the SVRG block path (saga._block_start)."""
    N, m = cfg.N, cfg.m
    tau1, tau2, alpha, beta = _katyusha_schedule(cfg, state)
    key, sub = jax.random.split(state.key)
    y, z, ysum = _katyusha_inner(
        F, g, cfg, state.x_tilde, state.av, tau1, tau2, alpha, beta, sub,
        state.y, state.z, jnp.zeros_like(state.y), m,
    )
    x_tilde = ysum / jnp.asarray(m, ysum.dtype)
    av = F.grad_sum_all(x_tilde) / N
    return state._replace(
        tau1=tau1.astype(state.tau1.dtype) if cfg.ns else state.tau1,
        av=av, x_tilde=x_tilde, y=y, z=z, key=key, it=state.it + 1,
    )


@partial(jax.jit, static_argnames=("cfg", "steps"))
def katyusha_run(F, g, state, cfg: KatyushaCfg, steps: int):
    def body(s, _):
        with jax.named_scope("katyusha_outer"):
            return _katyusha_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def katyusha_step(F, g, state, cfg: KatyushaCfg):
    return _katyusha_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class Katyusha:
    """Accelerated variance-reduced solver (beyond the reference).

    ``sigma`` — strong-convexity modulus of f (per-term average); sets
    τ₁ = min(√(m·batch·σ/(3 L_max)), 1/2). Without it the
    non-strongly-convex τ₁ₛ = 2/(s+4) epoch schedule runs (suitable for
    Lasso-type problems). ``m`` counts inner BATCHES per outer iterate
    and defaults to 2N/batch (the paper's two-epoch convention).
    ``maxit`` counts outer iterates."""

    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    batch: int = 1
    tau1: Optional[float] = None
    tau2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False  # contiguous inner blocks (slices)
    seed: int = 0

    def __post_init__(self):
        assert self.maxit > 0 and self.freq > 0 and self.batch >= 1
        assert 0.0 < self.tau2 < 1.0
        if self.tau1 is not None:
            assert 0.0 < self.tau1 <= 1.0 - self.tau2

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
        if L is None:
            raise ValueError("Katyusha: provide the smoothness moduli L")
        rdt = real_dtype_of(x0)
        Lmax = jnp.max(jnp.asarray(L, rdt))
        m = (2 * N) // self.batch if self.m is None else self.m
        if m < 1:
            raise ValueError("Katyusha: m must be >= 1")
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("Katyusha block_sampling needs N divisible by batch")
        ns = False
        if self.tau1 is not None:
            tau1 = jnp.asarray(self.tau1, rdt)
        elif self.sigma is not None:
            tau1 = jnp.minimum(
                jnp.sqrt(m * self.batch * jnp.asarray(self.sigma, rdt)
                         / (3.0 * Lmax)),
                jnp.asarray(0.5, rdt),
            )
        else:
            ns = True
            tau1 = jnp.asarray(0.5, rdt)  # epoch 0 value of 2/(s+4)
        cfg = KatyushaCfg(N=N, batch=self.batch, m=m,
                          block=self.block_sampling, ns=ns)
        key = jax.random.PRNGKey(self.seed)
        tau2 = jnp.asarray(self.tau2, rdt)
        init = lambda: katyusha_init(F, g, x0, Lmax, tau1, tau2, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return katyusha_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.tau1):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: katyusha_step(F, g, s, cfg)
        # the anchor is recomputed from a full pass every outer step,
        # so a storage switch self-heals: rebase is identity
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)
