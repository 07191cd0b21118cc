"""Point-SAGA — proximal-point incremental solver (BEYOND the
reference).

Defazio ("A Simple Practical Accelerated Method for Finite Sums",
NeurIPS 2016): replace SAGA's gradient step through f_i with the PROX
of the single sampled term,

    z_k   = x_k + γ·(g_j − ḡ)            ḡ = (1/N) Σ_i g_i (table mean)
    x_{k+1} = prox_{γ f_j}(z_k)
    g_j⁺  = (z_k − x_{k+1})/γ             (the prox-point gradient)

which tolerates stepsizes up to ~1/μ (vs SAGA's 1/(3L)) and attains an
accelerated-like rate on strongly-convex finite sums without momentum.
The reference family has nothing prox-based on the smooth terms; it is
included here because its data path is byte-identical to the SAGA
coefficient step: for scalar-loss rows (least-squares, logistic) the
per-term prox is again rank-1 — prox_{γf_j}(z) = z − γθ_j·conj(a_j)
with θ_j from a scalar equation (closed form for least squares,
a 1-D Newton loop on the margin for logistic) — so the whole batched
step is ONE margin dot + ONE apply dot over the same streamed rows
(`oracle.pointprox_block`), and the gradient table compresses exactly
to the (N,) θ coefficients.

Minibatch extension (the sanctioned batching, cf. the reference's
own minibatch TODO at ``SAGA_basic.jl:74``): each sampled row keeps its
OWN prox point z_j = v + γ·c_j·conj(a_j) around the shared shifted
iterate v = x − γ·ḡ, and the new iterate is the block mean of the prox
outputs — at batch=1 this is exactly Defazio's method.

Scope: solves min (1/N) Σ f_i(x) (the method has no separate-g
composite form — fold a proximable regularizer into the f_i or use
SAGA/SARAH for composite problems); requires a ``supports_pointprox``
oracle (dense least-squares / logistic rows, any storage mode).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ciao_tpu.prox import Zero
from ciao_tpu.solvers.base import (
    SolverIterable,
    real_dtype_of,
    run_solver_loop,
)


class PointSAGACfg(NamedTuple):
    N: int
    batch: int = 1
    block: bool = False  # contiguous-block sampling (slices, no gather)
    # Lipschitz-proportional block sampling (sampling.systematic_block, the
    # Finito schedule). Point-SAGA is a FIXED-POINT table method: at the
    # optimum every realized map fixes x* exactly (prox optimality per
    # drawn block), so non-uniform draws need NO direction reweighting
    # — the schedule only changes which anchors refresh most often. The
    # stepsize compensates via the truncated effective smoothness
    # 1/(3·max_j L_j/(d·q̃_j)).
    importance: bool = False


class PointSAGAState(NamedTuple):
    gamma: jnp.ndarray   # scalar stepsize
    c: jnp.ndarray       # (N,) prox-gradient coefficient table
    av: jnp.ndarray      # (n,) table mean ḡ = (1/N) Σ c_i·conj(a_i)
    x: jnp.ndarray       # (n,) iterate
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray
    # importance mode only (leafless None otherwise): the π-scale CDF
    # of sampling.systematic_schedule
    qcum: object = None

    @property
    def solution(self):
        return self.x


@partial(jax.jit, static_argnames=("cfg",))
def point_saga_init(F, g, x0, gamma, key, cfg: PointSAGACfg) -> PointSAGAState:
    """Table bootstrap g_i = ∇f_i(x0) (as coefficients), ḡ its mean —
    the SAGA table convention (``SAGA_basic.jl:41-47``); x = x0 so
    solution(init) == x0."""
    c = F.coeff_all(x0)
    av = F.apply_all(c) / cfg.N
    return PointSAGAState(
        gamma=gamma, c=c, av=av, x=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _point_saga_step(F, g, cfg: PointSAGACfg,
                     state: PointSAGAState) -> PointSAGAState:
    from ciao_tpu.solvers.saga import _block_start

    N, B = cfg.N, cfg.batch
    gamma = state.gamma
    v = state.x - gamma * state.av          # shared shifted iterate
    if cfg.block:
        key = state.key
        if cfg.importance:
            from ciao_tpu.sampling import systematic_block

            start = systematic_block(key, state.it, state.qcum, N // B) * B
        else:
            start = _block_start(key, state.it, N, B)
        c_B = jax.lax.dynamic_slice_in_dim(state.c, start, B)
        theta, u = F.pointprox_block(v, c_B, gamma, start, B)
        c = jax.lax.dynamic_update_slice_in_dim(state.c, theta, start, 0)
    else:
        key, sub = jax.random.split(state.key)
        idx = jax.random.randint(sub, (B,), 0, N, dtype=jnp.int32)
        c_B = state.c[idx]
        theta, u = F.pointprox_batch(v, c_B, gamma, idx)
        c = state.c.at[idx].set(theta)
    # x⁺ = mean_j prox(z_j) = v + (γ/B)·Σ_j (c_j − θ_j)·conj(a_j)
    x = v + (gamma / B) * u
    # table-mean update: ḡ += (1/N)·Σ_j (θ_j − c_j)·conj(a_j) = ḡ − u/N
    av = state.av - u / N
    return state._replace(c=c, av=av, x=x, key=key, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def point_saga_run(F, g, state, cfg: PointSAGACfg, steps: int):

    def body(s, _):
        with jax.named_scope("point_saga_step"):
            return _point_saga_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def point_saga_step(F, g, state, cfg: PointSAGACfg):
    return _point_saga_step(F, g, cfg, state)


@partial(jax.jit, static_argnames=("cfg",))
def point_saga_rebase(F, g, state, cfg: PointSAGACfg):
    """Exact table-mean recompute ḡ = (1/N)Σ c_i·conj(a_i) — REQUIRED
    after an oracle storage swap (the delta-maintained ḡ keeps the old
    operator's bias forever otherwise; cf. solvers.saga.saga_rebase)."""
    return state._replace(av=F.apply_all(state.c) / cfg.N)


@dataclasses.dataclass(frozen=True)
class PointSAGA:
    """Proximal-point incremental solver (beyond the reference).

    ``gamma`` defaults to the SAGA-compatible conservative 1/(3 L_max);
    the method's headroom is the point — on well-conditioned problems
    stepsizes orders of magnitude larger remain stable (pass ``gamma``
    explicitly, e.g. ~1/μ̄). ``maxit`` counts steps of ``batch`` rows."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    batch: int = 1
    block_sampling: bool = False
    # Lipschitz-proportional block draws (sampling.systematic_block; needs
    # block_sampling + L). No direction reweighting — Point-SAGA is a
    # fixed-point table method (PointSAGACfg.importance); γ defaults to
    # the truncated effective smoothness 1/(3·max_j L_j/(d·q̃_j)).
    importance_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0 and self.batch >= 1

    def _setup(self, x0, F, g, L, N):
        x0 = jnp.asarray(x0)
        if N is None:
            if F is None:
                raise ValueError("provide F or N")
            N = F.num_terms
        if g is not None and not isinstance(g, Zero):
            raise ValueError(
                "PointSAGA solves min (1/N)Σ f_i(x) — it has no separate "
                "composite-g form (fold the regularizer into the f_i, or "
                "use SAGA/SARAH/Katyusha for composite problems)"
            )
        g = Zero()
        if not getattr(F, "supports_pointprox", False):
            raise ValueError(
                "PointSAGA needs a scalar-loss row oracle with the "
                f"pointprox protocol; {type(F).__name__} does not "
                "support it"
            )
        rdt = real_dtype_of(x0)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError(
                "PointSAGA block_sampling needs N divisible by batch"
            )
        qcum = None
        L_eff64 = None
        if self.importance_sampling:
            if not self.block_sampling:
                raise ValueError(
                    "importance_sampling needs block_sampling=True")
            if L is None:
                raise ValueError("PointSAGA importance_sampling: provide L")
            if jnp.iscomplexobj(x0):
                raise ValueError(
                    "PointSAGA importance_sampling: real dtypes only")
            from ciao_tpu.sampling import systematic_schedule

            qcum, q64, Lblk64 = systematic_schedule(L, N, self.batch, rdt)
            L_eff64 = float(np.max(Lblk64 / ((N // self.batch) * q64)))
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "PointSAGA: provide the smoothness moduli L, or a "
                    "stepsize γ"
                )
            if self.importance_sampling:
                gamma = jnp.asarray(1.0 / (3.0 * L_eff64), rdt)
            else:
                gamma = 1.0 / (3.0 * jnp.max(jnp.asarray(L, rdt)))
        cfg = PointSAGACfg(N=N, batch=self.batch, block=self.block_sampling,
                           importance=self.importance_sampling)
        key = jax.random.PRNGKey(self.seed)
        init = lambda: point_saga_init(F, g, x0, gamma, key,
                                       cfg)._replace(qcum=qcum)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return point_saga_run(F, g, state, cfg, k)

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
        step = lambda s: point_saga_step(F, g, s, cfg)
        rebase = lambda s: point_saga_rebase(F, g, s, cfg)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)
