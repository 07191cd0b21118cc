"""SAGA / SAG solver family.

Re-design of reference ``src/algorithms/SAGA_SAG/SAGA_basic.jl``:
the per-index gradient table s_i = ∇f_i lives as one (N, n) HBM-resident
array; one step = uniform index draw, one component gradient, the
(biased for SAG / unbiased for SAGA) direction, prox, table row update.

Defaults (SAGA_basic.jl:34-35): γ = 1/(3 L_max) for SAGA,
1/(16 L_max) for SAG. Init (SAGA_basic.jl:41-48): table = gradients at
x0, av = mean, z = prox_g((1-γ) x0, γ).

Update-order quirk preserved (SAGA_basic.jl:57-62): SAG refreshes the
running average BEFORE forming the direction (biased estimator); SAGA
forms the unbiased direction first, then refreshes the average.

Beyond the reference (its TODO at SAGA_basic.jl:74): ``batch > 1``
draws a without-replacement minibatch and applies the averaged update —
the standard minibatch-SAGA estimator — keeping the accelerator busy
at scale.
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
    Status,
    real_dtype_of,
    run_solver_loop,
)


class SAGACfg(NamedTuple):
    N: int
    sag: bool
    batch: int = 1
    block: bool = False  # uniform CONTIGUOUS block instead of iid subset
    coeff: bool = False  # (N,) coefficient table instead of (N, n) rows
    importance: bool = False  # Lipschitz-proportional block sampling
    # coefficient block step through the Hopper kernel
    # (ops.saga_block) instead of XLA; the facade sets it from
    # runtime.block_step_kernel
    kernel: bool = False


class SAGAState(NamedTuple):
    s: jnp.ndarray          # (N, n) gradient table
    gamma: jnp.ndarray      # scalar
    av: jnp.ndarray         # (n,) running average of the table
    z: jnp.ndarray          # (n,)
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray
    # importance sampling only (beyond the reference): the block
    # distribution's inclusive CDF (d,) and the per-block unbiasedness
    # weights 1/(d·q_j) (d,); None otherwise (leafless pytree nodes).
    qcum: object = None
    qinv: object = None

    @property
    def solution(self):  # reference: solution(state) = state.z
        return self.z


@partial(jax.jit, static_argnames=("cfg",))
def saga_init(F, g, x0, gamma, key, cfg: SAGACfg) -> SAGAState:
    """Reference SAGA_basic.jl:41-48. In coeff mode the gradient table
    s_i = ∇f_i(x0) = c_i·a_i is stored as the EXACT (N,) coefficient
    vector (rank-1 row gradients; oracles with ``supports_coeff``)."""
    if cfg.coeff:
        s = F.coeff_all(x0)
        av = F.apply_all(s) / cfg.N
    else:
        s = F.grad_all(x0)
        av = jnp.mean(s, axis=0)
    z = g.prox_only((1 - gamma) * x0, gamma)
    return SAGAState(
        s=s, gamma=gamma, av=av, z=z, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg",))
def saga_rebase(F, state: SAGAState, cfg: SAGACfg) -> SAGAState:
    """Make ``av`` consistent with the table under ``F``'s row storage.

    The running average is maintained incrementally (delta updates), so
    after swapping the oracle's storage mid-run (the f32/bf16/int8
    stages of a staged-precision schedule) the stored ``av`` still
    reflects the OLD operator: in coefficient mode av = Σ c_i·ã_i/N was
    accumulated with the previous rows ã_i, and the mismatch with the
    new rows never decays — a permanent bias that floors convergence
    (measured: an int8→f32 switch without rebase stalls at rel ~1.2e-3
    on the 65k planted Lasso while the rebased run reaches the f32
    floor). One pass over A repairs it. Full-table mode is
    storage-consistent by construction (av literally averages the
    stored gradient rows; deltas under the new operator keep it exact)
    — returned unchanged."""
    if not cfg.coeff:
        return state
    return state._replace(av=F.apply_all(state.s) / cfg.N)


def _saga_direction(cfg, state, innov, B, wgt=1.0):
    """The SAG (biased, average first) / SAGA (unbiased) update-order
    quirk (SAGA_basic.jl:57-62), shared by all table layouts.
    ``innov`` = Σ_B (∇f_i(z) − s_i_old); ``wgt`` is the importance-
    sampling unbiasedness weight 1/(d·q_j) (1 under uniform draws) —
    it scales the DIRECTION only, never the exact table-mean delta."""
    N = cfg.N
    diff = innov * (wgt / B)
    if cfg.sag:
        av = state.av + innov / N
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (diff + state.av)
        av = state.av + innov / N
    return av, w


def _block_start(key, it, N: int, B: int):
    """Stateless uniform block start for step ``it``: deterministic in
    (key, it), so a run can be split into chunks without changing the
    stream."""
    k = jax.random.fold_in(key, it)
    return jax.random.randint(k, (), 0, N // B, dtype=jnp.int32) * B


def _block_choice(cfg: SAGACfg, state: SAGAState):
    """The step's (block start, unbiasedness weight). Uniform mode:
    the stateless ``_block_start`` stream, weight 1. Importance mode
    (beyond the reference; cf. Schmidt-Le Roux-Bach non-uniform SAG
    and the SAGA importance-sampling literature): block j is drawn
    from q_j ∝ L_j by inverse-CDF over the same stateless (key, it)
    stream, and the innovation is reweighted by 1/(d·q_j) so the
    direction stays an unbiased gradient estimate while hot (large-L)
    blocks are refreshed more often — the stepsize then scales with
    MEAN block smoothness instead of the max."""
    N, B = cfg.N, cfg.batch
    if not cfg.importance:
        return _block_start(state.key, state.it, N, B), 1.0
    u = jax.random.uniform(jax.random.fold_in(state.key, state.it), (),
                           state.qcum.dtype)
    j = jnp.minimum(
        jnp.searchsorted(state.qcum, u, side="right").astype(jnp.int32),
        N // B - 1,
    )
    return j * B, state.qinv[j]


def coeff_block_xla(F, s, z, start, B: int):
    """(table, innovation) of one coefficient block step in plain XLA:
    the new coefficients of rows [start, start+B), written into the
    table, and Σ (c_new − c_old)·a_i over the block."""
    c_new = F.coeff_block(z, start, B)
    c_old = jax.lax.dynamic_slice_in_dim(s, start, B)
    innov = F.apply_rows_block(c_new - c_old, start, B)
    return jax.lax.dynamic_update_slice_in_dim(s, c_new, start, 0), innov


def coeff_block_kernel(F, s, z, start, B: int, interpret: bool = False):
    """:func:`coeff_block_xla` through the Hopper kernel
    (ops.saga_block): one read of the block's rows. ``interpret`` runs
    the Pallas interpreter (tests only); without it the step raises
    off a CUDA GPU."""
    from ciao_tpu import runtime
    from ciao_tpu.ops.saga_block import saga_block_step

    if not (interpret or runtime.on_gpu()):
        raise ValueError("the Hopper SAGA block-step kernel runs on a CUDA "
                         f"GPU only; the backend is {jax.default_backend()!r}")

    rows, offs = F.coeff_rows_data()
    return saga_block_step(
        rows, offs, F.coeff_rows_scale(), s, z, start,
        getattr(F, "scale", 1.0), getattr(F, "delta", 0.0),
        B=B, mode=F.coeff_mode, interpret=interpret,
    )


def _saga_step_coeff(F, g, cfg: SAGACfg, state: SAGAState) -> SAGAState:
    """Coefficient-table step: no (N, n) table IO at all — the innovation
    Σ (c_new − c_old)·a_i is one extra matvec over the SAME oracle rows
    the gradient evaluation already reads."""
    N, B = cfg.N, cfg.batch
    if cfg.block:
        # stateless schedule: key constant, it advances
        key = state.key
        start, wgt = _block_choice(cfg, state)
        block_step = coeff_block_kernel if cfg.kernel else coeff_block_xla
        s, innov = block_step(F, state.s, state.z, start, B)
    else:
        wgt = 1.0
        key, sub = jax.random.split(state.key)
        if B == 1:
            idx = jax.random.randint(sub, (1,), 0, N, dtype=jnp.int32)
        else:
            idx = jax.random.choice(sub, N, (B,), replace=False).astype(jnp.int32)
        c_new = F.coeff_batch(state.z, idx)
        c_old = state.s[idx]
        innov = F.apply_rows(c_new - c_old, idx)
        s = state.s.at[idx].set(c_new)
    av, w = _saga_direction(cfg, state, innov, B, wgt)
    z = g.prox_only(w, state.gamma)
    return state._replace(s=s, av=av, z=z, key=key, it=state.it + 1)


def _saga_step(F, g, cfg: SAGACfg, state: SAGAState) -> SAGAState:
    if cfg.importance and cfg.sag:
        # SAG's average-first order has no importance-weighted analog:
        # running it under importance draws would silently bias the
        # direction. The facade rejects it; guard here too since
        # SAGACfg is also constructed directly.
        raise ValueError(
            "SAGACfg(importance=True) is incompatible with sag=True"
        )
    if cfg.coeff:
        return _saga_step_coeff(F, g, cfg, state)
    N, B = cfg.N, cfg.batch
    if cfg.block:
        # a uniformly-drawn CONTIGUOUS block (partition-stratified
        # minibatch SAGA): dynamic slices instead of a row gather and
        # scatter. Stateless (key, it) schedule; key is not advanced.
        key = state.key
        start, wgt = _block_choice(cfg, state)
        G_B = F.grad_block(state.z, start, B)
        s_old = jax.lax.dynamic_slice_in_dim(state.s, start, B, 0)
        diff = jnp.mean(G_B - s_old, axis=0)
        if cfg.sag:
            av = state.av + diff * (B / N)
            w = state.z - state.gamma * av
        else:
            w = state.z - state.gamma * (diff * wgt + state.av)
            av = state.av + diff * (B / N)
        z = g.prox_only(w, state.gamma)
        s = jax.lax.dynamic_update_slice_in_dim(state.s, G_B, start, 0)
        return state._replace(s=s, av=av, z=z, key=key, it=state.it + 1)
    key, sub = jax.random.split(state.key)
    if B == 1:
        idx = jax.random.randint(sub, (1,), 0, N, dtype=jnp.int32)
    else:
        idx = jax.random.choice(sub, N, (B,), replace=False).astype(jnp.int32)
    G_B = F.grad_batch(state.z, idx)          # (B, n) grads at z
    s_old = state.s[idx]
    diff = jnp.mean(G_B - s_old, axis=0)      # minibatch-averaged innovation
    if cfg.sag:
        av = state.av + diff * (B / N)
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (diff + state.av)
        av = state.av + diff * (B / N)
    z = g.prox_only(w, state.gamma)
    s = state.s.at[idx].set(G_B)
    return state._replace(s=s, av=av, z=z, key=key, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def saga_run(F, g, state, cfg: SAGACfg, steps: int):
    def body(s, _):
        with jax.named_scope("saga_step"):
            return _saga_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def saga_step(F, g, state, cfg: SAGACfg):
    return _saga_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class SAGA:
    """SAGA facade (reference ``SAGA.jl:24-42``). ``SAG_flag`` switches to
    the biased SAG update (reference ``SAGA.jl:190-191``)."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    SAG_flag: bool = False
    batch: int = 1
    block_sampling: bool = False  # contiguous-block minibatches (slices)
    importance_sampling: bool = False  # q_j ∝ L_j block draws (needs L)
    table: str = "auto"  # "full" (N,n) | "coeff" (N,) | "auto" (coeff if rank-1)
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0
        assert self.freq > 0
        assert self.batch >= 1

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
        qcum = qinv = None
        if self.importance_sampling:
            # Lipschitz-proportional block sampling (beyond the
            # reference): q_j ∝ L_j of the contiguous block (max of the
            # member moduli), unbiased via the 1/(d·q_j) direction
            # weight. The SAGA stepsize then scales with the MEAN block
            # smoothness Σ q_j-weighted rather than the max — the whole
            # point on data with a wide L spread. SAG's biased average-
            # first order has no importance-weighted analog here.
            if self.SAG_flag:
                raise ValueError("importance_sampling supports SAGA only")
            if not self.block_sampling:
                raise ValueError(
                    "importance_sampling needs block_sampling=True"
                )
            if L is None:
                raise ValueError("SAGA importance_sampling: provide L")
            if N % self.batch != 0:
                raise ValueError(
                    "SAGA block_sampling needs N divisible by batch"
                )
            # Build the block distribution in float64 on host: a f32
            # cumsum over a large block count d drifts enough to skew
            # the realized draws away from the exact q used in the
            # 1/(d·q_j) weights.
            Lb64 = np.asarray(jax.device_get(jnp.asarray(L)), np.float64)
            if Lb64.ndim == 0:
                Lb64 = np.full((N,), Lb64)
            d_imp = N // self.batch
            Lblk64 = np.max(Lb64.reshape(d_imp, self.batch), axis=1)
            q64 = Lblk64 / np.sum(Lblk64)
            qcum64 = np.cumsum(q64)
            qcum64 /= qcum64[-1]
            qcum = jnp.asarray(qcum64, rdt)
            qinv = jnp.asarray(1.0 / (d_imp * q64), rdt)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SAGA block_sampling needs N divisible by batch")
        assert self.table in ("auto", "full", "coeff")
        coeff = (
            getattr(F, "supports_coeff", False)
            if self.table == "auto"
            else self.table == "coeff"
        )
        from ciao_tpu import runtime

        kernel = runtime.block_step_kernel(
            F, x0, self.batch, coeff and self.block_sampling
        )
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "SAGA: smoothness parameter absent — provide L or γ"
                )
            if self.importance_sampling:
                # stepsize dividend = the EFFECTIVE smoothness
                # max_j L_j/(d·q_j), which is the mean block smoothness
                # for q ∝ L
                L_eff64 = float(np.max(Lblk64 / (d_imp * q64)))
                gamma = jnp.asarray(1.0 / (3.0 * L_eff64), rdt)
            else:
                L_max = jnp.max(jnp.asarray(L, rdt))
                gamma = 1.0 / ((16.0 if self.SAG_flag else 3.0) * L_max)
        cfg = SAGACfg(
            N=N, sag=self.SAG_flag, batch=self.batch,
            block=self.block_sampling, coeff=coeff,
            importance=self.importance_sampling, kernel=kernel,
        )
        key = jax.random.PRNGKey(self.seed)
        if self.importance_sampling:
            init = lambda: saga_init(F, g, x0, gamma, key, cfg)._replace(
                qcum=qcum, qinv=qinv
            )
        else:
            init = lambda: saga_init(F, g, x0, gamma, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return saga_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: saga_step(F, g, s, cfg)
        return SolverIterable(
            x0_orig, init, step, rebase_fn=lambda s: saga_rebase(F, s, cfg)
        )


def SAG(**kwargs):
    """SAG = SAGA with the biased update order (reference SAGA.jl:190-191)."""
    return SAGA(SAG_flag=True, **kwargs)
