"""Data-parallel (index-block sharded) solver paths.

The reference is single-process; the finite-sum index ``i`` is its
natural partition axis (SURVEY.md §2.3). Here each solver family gets a
``shard_map``-based step over the ``"data"`` mesh axis:

  * the (N, n) gradient/iterate tables, the per-index stepsizes γ_i and
    the oracle's stacked data rows live SHARDED by index block — each
    device owns N/D contiguous rows and only ever touches its own rows;
  * every step, each device draws its minibatch slice from ITS OWN index
    block (without replacement locally) — the sanctioned minibatch
    variants of each algorithm (reference ``Finito.jl:89`` minibatch;
    SAGA minibatch is the reference's own TODO at ``SAGA_basic.jl:74``)
    with a block-stratified sampler;
  * the only cross-device traffic is the x-sized reduction of the
    aggregate (``av`` deltas, SVRG anchors, ProShI coupling sums) — one
    ``psum`` over ICI per step — plus the replicated prox.

Index schedules are STATELESS: the (key, iteration, axis_index) triple
derives every draw via ``fold_in``, so schedules are deterministic,
checkpoint-free and identical across restarts — no RNG state to
shard (contrast the reference's global host RNG, SURVEY.md §2.2).

Sweeping semantics over the local block (reference ``Finito.jl:153``):
1 = fresh uniform without-replacement draw per step; 2 = cyclic over
static contiguous sub-blocks; 3 = per-epoch shuffled sub-block order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ciao_tpu.parallel.mesh import DATA_AXIS, data_specs, make_mesh, replicated_specs
from ciao_tpu.prox import Zero
from ciao_tpu.sampling import Sweep
from ciao_tpu.solvers.base import (
    SolverIterable,
    real_dtype_of,
    resolve_gamma_array,
    run_solver_loop,
)
from ciao_tpu.solvers.panoc import PANOCState as _PANOCState


# ---------------------------------------------------------------------------
# stateless per-device index schedules
# ---------------------------------------------------------------------------

def local_indices(key, it, n_loc: int, b_loc: int, sweeping: int):
    """The device's (b_loc,) index draw for step ``it`` from its own
    [0, n_loc) block. Deterministic in (key, it, device)."""
    ax = jax.lax.axis_index(DATA_AXIS)
    d_loc = n_loc // b_loc
    if sweeping == Sweep.RANDOM:
        k = jax.random.fold_in(jax.random.fold_in(key, it), ax)
        return jax.random.choice(k, n_loc, (b_loc,), replace=False).astype(jnp.int32)
    lane = jnp.arange(b_loc, dtype=jnp.int32)
    if sweeping == Sweep.CYCLIC:
        j = (it - 1) % d_loc
        return j * b_loc + lane
    # SHUFFLED: fresh permutation of sub-block order each local epoch
    epoch = (it - 1) // d_loc
    pos = (it - 1) % d_loc
    ke = jax.random.fold_in(jax.random.fold_in(key, epoch), ax)
    order = jax.random.permutation(ke, d_loc).astype(jnp.int32)
    return order[pos] * b_loc + lane


def local_block_start(key, it, n_loc: int, b_loc: int, sweeping: int):
    """Contiguous-block schedule: the device's dynamic-slice START for
    step ``it`` (random / cyclic / per-epoch-shuffled sub-blocks —
    dynamic slices instead of a row gather and scatter).
    Identical across a data row's model group when used on a 2-D mesh
    (folds only the DATA axis index)."""
    ax = jax.lax.axis_index(DATA_AXIS)
    d_loc = n_loc // b_loc
    if sweeping == Sweep.RANDOM:
        k = jax.random.fold_in(jax.random.fold_in(key, it), ax)
        return jax.random.randint(k, (), 0, d_loc, dtype=jnp.int32) * b_loc
    if sweeping == Sweep.CYCLIC:
        return ((it - 1) % d_loc) * b_loc
    epoch = (it - 1) // d_loc
    pos = (it - 1) % d_loc
    ke = jax.random.fold_in(jax.random.fold_in(key, epoch), ax)
    order = jax.random.permutation(ke, d_loc).astype(jnp.int32)
    return order[pos] * b_loc


def _rows(F, x, n_loc):
    """(n_loc, n) per-row gradients of the LOCAL shard, all at x.

    Uses the pointwise entry so oracles whose data is shared across
    terms (e.g. SqrDistBox inside a SumOracle) produce locally-shaped
    outputs even though their static ``n_terms`` is global."""
    xs = jnp.broadcast_to(x, (n_loc,) + x.shape)
    return F.grad_pointwise(xs, jnp.arange(n_loc, dtype=jnp.int32))


# ---------------------------------------------------------------------------
# configs and states
# ---------------------------------------------------------------------------

class DPCfg(NamedTuple):
    """Static config (jit cache key) for all DP families."""

    N: int          # global term count
    D: int          # mesh size along "data"
    b_loc: int      # per-device minibatch
    sweeping: int
    alpha: float
    sag: bool = False
    plus: bool = False
    block: bool = False  # contiguous-block sampling (slices, no gather)
    coeff: bool = False  # (N,) coefficient table (rank-1 oracles)
    local_steps: int = 1  # >1: local-update rounds (see _saga_local_round)
    rebase_every: int = 0  # local rounds between exact av recomputes
    local: bool = False   # LFinito local sweep / SVRG local inner loop
    m_inner: int = 0      # static inner-loop length (Katyusha, SARAH)
    variant: str = "basic"
    tol_b: float = 1e-9   # adaptive backtracking underflow bound
    max_ls: int = 10      # PANOC/ZeroFPR line-search trial bound
    adaptive: bool = False  # PANOC/ZeroFPR γ-backtracking mode
    polish_chunk: int = 0  # FB/FISTA: compensated chunked local gradient

    @property
    def n_loc(self):
        return self.N // self.D


class DPFinitoState(NamedTuple):
    s: jnp.ndarray          # (N, n) sharded table
    gamma: jnp.ndarray      # (N,) sharded
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


class DPFinitoCoeffState(NamedTuple):
    """Coefficient-compressed sharded Finito state (see
    solvers.finito.FinitoCoeffState): (N,) coefficients, per-block
    anchors and Σ1/γ sums all sharded by index block."""

    c: jnp.ndarray          # (N,) sharded coefficients
    zb: jnp.ndarray         # (D·d_loc, n) sharded per-block anchors
    invg: jnp.ndarray       # (D·d_loc,) sharded Σ 1/γ_i per block
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


class DPFinitoAdaptiveState(NamedTuple):
    """Sharded adaptive-Finito state (cf. solvers.finito.
    FinitoAdaptiveState): the three N-tables (s, gradf, fi_x) and the
    per-index stepsizes shard by index block; the aggregate (hat_γ, av,
    z) replicates — the backtracking loop runs LOCKSTEP on every device
    against broadcast owner-row data."""

    s: jnp.ndarray          # (N, n) sharded iterate table
    gradf: jnp.ndarray      # (N, n) sharded gradient table
    fi_x: jnp.ndarray       # (N,) sharded cost table
    gamma: jnp.ndarray      # (N,) sharded stepsizes
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


class DPLFinitoState(NamedTuple):
    gamma: jnp.ndarray
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    z_full: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


class DPSAGAState(NamedTuple):
    s: jnp.ndarray          # (N, n) sharded gradient table
    gamma: jnp.ndarray      # scalar
    av: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


class DPSVRGState(NamedTuple):
    gamma: jnp.ndarray
    m: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    z_full: jnp.ndarray
    w: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z_full


class DPProshiState(NamedTuple):
    s: jnp.ndarray          # (N, n) sharded block table
    gamma: jnp.ndarray      # (N,) sharded
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.s + self.gamma[:, None] * self.z[None, :]


_SHARDED_FIELDS = {
    "s": P(DATA_AXIS, None),
    "gradf": P(DATA_AXIS, None),
    "fi_x": P(DATA_AXIS),
    "gamma": P(DATA_AXIS),
    "c": P(DATA_AXIS),
    "zb": P(DATA_AXIS, None),
    "invg": P(DATA_AXIS),
}


def _state_specs(state_cls, scalar_gamma=False, coeff=False):
    specs = {}
    for f in state_cls._fields:
        if f == "s" and coeff:
            specs[f] = P(DATA_AXIS)  # (N,) coefficient table
        elif f in _SHARDED_FIELDS and not (f == "gamma" and scalar_gamma):
            specs[f] = _SHARDED_FIELDS[f]
        else:
            specs[f] = P()
    return state_cls(**specs)


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


# ---------------------------------------------------------------------------
# local (per-device) init / step bodies
# ---------------------------------------------------------------------------

def _finito_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded Finito bootstrap (reference Finito_basic.jl:44-89): local
    table rows, then the harmonic-mean/weighted-average algebra as two
    x-sized psums."""
    n_loc, N = cfg.n_loc, cfg.N
    G = _rows(F, x0, n_loc)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = 1.0 / _psum(jnp.sum(1.0 / gamma))
    av = hat_gamma * _psum(jnp.sum(s / gamma[:, None], axis=0))
    z = g.prox_only(av, hat_gamma)
    return DPFinitoState(
        s=s, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _finito_step_local(F, g, cfg: DPCfg, state: DPFinitoState):
    """Sharded Finito hot step (reference Finito_basic.jl:91-121): every
    device refreshes b_loc of its own table rows against the shared z;
    the av innovation is one psum."""
    N, B = cfg.N, cfg.b_loc
    if cfg.sweeping != Sweep.RANDOM:
        # contiguous fast path: dynamic-slice DMAs, no gather/scatter
        start = local_block_start(state.key, state.it, cfg.n_loc, B, cfg.sweeping)
        gi = jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
        G_B = F.grad_block(state.z, start, B)
        s_new = state.z[None, :] - (gi / N)[:, None] * G_B
        s_old = jax.lax.dynamic_slice_in_dim(state.s, start, B, 0)
        delta = s_new - s_old
        s = jax.lax.dynamic_update_slice_in_dim(state.s, s_new, start, 0)
    else:
        idx = local_indices(state.key, state.it, cfg.n_loc, B, cfg.sweeping)
        gi = state.gamma[idx]
        G_B = F.grad_batch(state.z, idx)
        s_new = state.z[None, :] - (gi / N)[:, None] * G_B
        delta = s_new - state.s[idx]
        s = state.s.at[idx].set(s_new)
    av = state.av + _psum(
        jnp.sum(delta * (state.hat_gamma / gi)[:, None], axis=0)
    )
    z = g.prox_only(av, state.hat_gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + 1)


def _finito_coeff_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded coefficient-Finito bootstrap (same algebra as
    solvers.finito.finito_coeff_init, with the sums turned into psums;
    hat_γ·Σ(1/γ) = 1 simplifies av to x0 − (hat/N)·Σ cᵢaᵢ)."""
    n_loc, N, B = cfg.n_loc, cfg.N, cfg.b_loc
    d_loc = n_loc // B
    c = F.coeff_all(x0)
    inv_gamma = 1.0 / gamma
    hat_gamma = 1.0 / _psum(jnp.sum(inv_gamma))
    av = x0 - (hat_gamma / N) * _psum(F.apply_all(c))
    z = g.prox_only(av, hat_gamma)
    invg = jnp.sum(inv_gamma.reshape(d_loc, B), axis=1)
    zb = jnp.broadcast_to(x0, (d_loc,) + x0.shape)
    return DPFinitoCoeffState(
        c=c, zb=zb, invg=invg, hat_gamma=hat_gamma, av=av, z=z, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _finito_coeff_step_local(F, g, cfg: DPCfg, state: DPFinitoCoeffState):
    """Sharded coefficient-Finito step: each device refreshes ONE of its
    blocks against the shared z; one x-sized psum of the combined
    anchor + coefficient innovation (cf. solvers.finito._finito_coeff_step)."""
    N, B = cfg.N, cfg.b_loc
    hat = state.hat_gamma
    start = local_block_start(state.key, state.it, cfg.n_loc, B, cfg.sweeping)
    j = start // B
    c_new = F.coeff_block(state.z, start, B)
    c_old = jax.lax.dynamic_slice_in_dim(state.c, start, B)
    z_b = state.zb[j]
    innov = _psum(
        hat * state.invg[j] * (state.z - z_b)
        - (hat / N) * F.apply_rows_block(c_new - c_old, start, B)
    )
    av = state.av + innov
    c = jax.lax.dynamic_update_slice_in_dim(state.c, c_new, start, 0)
    zb = state.zb.at[j].set(state.z)
    z = g.prox_only(av, hat)
    return state._replace(c=c, zb=zb, av=av, z=z, it=state.it + 1)


def _finito_coeff_local_round(F, g, cfg: DPCfg, state: DPFinitoCoeffState):
    """LOCAL-UPDATE round for coefficient Finito (beyond the reference;
    the multi-chip throughput mode, cf. ``_saga_local_round``): K steps
    against the device's own av/z with NO per-step collective, then one
    round-boundary sync

        av ← av₀ + psum(av_d − av₀)    z ← prox_g(av, hat_γ)

    The resync is EXACT: av is maintained by exact additive per-row
    innovations (reference Finito_basic.jl:110-117 algebra) and every
    table row / block anchor is owned by one device, so the summed
    deltas reproduce av = hat_γ·Σ(s_i/γ_i) for the union of all
    devices' updates. Unlike SAGA there is no iterate averaging — z is
    a pure function of av."""
    N, B, K = cfg.N, cfg.b_loc, cfg.local_steps
    hat = state.hat_gamma
    av0 = state.av
    starts = _local_round_starts(
        state.key, state.it, cfg.n_loc, B, K, cfg.sweeping
    )

    def body(carry, start):
        c, zb, av, z = carry
        j = start // B
        c_new = F.coeff_block(z, start, B)
        c_old = jax.lax.dynamic_slice_in_dim(c, start, B)
        av = av + (
            hat * state.invg[j] * (z - zb[j])
            - (hat / N) * F.apply_rows_block(c_new - c_old, start, B)
        )
        c = jax.lax.dynamic_update_slice_in_dim(c, c_new, start, 0)
        zb = zb.at[j].set(z)
        z = g.prox_only(av, hat)
        return (c, zb, av, z), None

    (c, zb, av, _), _ = jax.lax.scan(
        body, (state.c, state.zb, av0, state.z), starts
    )

    av = _round_boundary_av(
        cfg, state.it, av0, av,
        lambda: hat * (state.invg @ zb - F.apply_all(c) / N),
    )
    z = g.prox_only(av, hat)
    return state._replace(c=c, zb=zb, av=av, z=z, it=state.it + K)


def _finito_coeff_step_or_round(F, g, cfg: DPCfg, state):
    """One iterate of coefficient-mode DP Finito: the per-step path, or
    (``local_steps > 1``) one local-update round."""
    if cfg.local_steps > 1:
        return _finito_coeff_local_round(F, g, cfg, state)
    return _finito_coeff_step_local(F, g, cfg, state)


def _global_single_index(key, it, N: int, sweeping: int):
    """Replicated single-index schedule for the adaptive variant: one
    GLOBAL index per step, identical on every device (stateless
    (key, it) derivation — reference Finito_adaptive.jl:106-118, with
    adaptive-cyclic starting at index 1 and the first shuffled epoch in
    natural order, as in the single-chip path)."""
    if sweeping == Sweep.CYCLIC:
        return ((it - 1) % N).astype(jnp.int32)
    if sweeping == Sweep.SHUFFLED:
        epoch = (it - 1) // N
        pos = (it - 1) % N
        perm = jax.random.permutation(
            jax.random.fold_in(key, epoch), N
        ).astype(jnp.int32)
        nat = jnp.arange(N, dtype=jnp.int32)
        order = jnp.where(epoch == 0, nat, perm)
        return order[pos]
    return jax.random.randint(
        jax.random.fold_in(key, it), (), 0, N, dtype=jnp.int32
    )


def _finito_adaptive_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded adaptive-Finito bootstrap (reference
    Finito_adaptive.jl:60-97; cf. solvers.finito.finito_adaptive_init):
    the finite-difference L probe with doubling-perturbation retry runs
    per-shard (row-local, no collectives — per-device trip counts may
    differ), then hat_γ and av are one stacked psum. ``gamma`` is
    ignored — the variant derives its stepsizes from the probe."""
    del gamma
    N, n_loc = cfg.N, cfg.n_loc
    rdt = real_dtype_of(x0)
    fi_x, G0 = F.value_and_grad_all(x0)              # local tables at x0
    s = jnp.broadcast_to(x0, G0.shape)

    xeps = x0 + jnp.ones_like(x0)
    G1 = F.grad_all(xeps)
    nmg0 = jnp.sqrt(jnp.sum(jnp.abs(G1 - G0) ** 2, axis=1)).astype(rdt)
    eps = jnp.finfo(rdt).eps
    ax = jax.lax.axis_index(DATA_AXIS)

    def need_retry(c):
        nmg, t, k = c
        return jnp.any(nmg < eps)

    def retry(c):
        nmg, t, k = c
        k, sub = jax.random.split(k)
        signs = jax.random.rademacher(sub, G0.shape, dtype=rdt)
        xs = x0[None, :] + t[:, None] * signs.astype(x0.dtype)
        Gp = F.grad_pointwise(xs, jnp.arange(n_loc))
        nmg_new = jnp.sqrt(jnp.sum(jnp.abs(Gp - G0) ** 2, axis=1)).astype(rdt)
        bad = nmg < eps
        return jnp.where(bad, nmg_new, nmg), jnp.where(bad, t * 2, t), k

    t0 = jnp.ones((n_loc,), rdt)
    probe_key = jax.random.fold_in(jax.random.fold_in(key, 0x9E3779B9), ax)
    nmg, t_final, _ = jax.lax.while_loop(
        need_retry, retry, (nmg0, t0, probe_key)
    )

    n_dim = x0.size
    L_int = nmg / (t_final * jnp.sqrt(jnp.asarray(float(n_dim), rdt))) / N
    gam = jnp.asarray(cfg.alpha, rdt) / L_int
    # one stacked psum: [Σ 1/γ, Σ s/γ − Σ G0/N] over the shards
    part = jnp.concatenate([
        jnp.sum(1.0 / gam)[None].astype(x0.dtype),
        jnp.sum(s / gam[:, None], axis=0) - jnp.sum(G0, axis=0) / N,
    ])
    tot = _psum(part)
    hat_gamma = (1.0 / jnp.real(tot[0])).astype(rdt)
    av = hat_gamma * tot[1:]
    z = g.prox_only(av, hat_gamma)
    return DPFinitoAdaptiveState(
        s=s, gradf=G0, fi_x=fi_x, gamma=gam, hat_gamma=hat_gamma, av=av,
        z=z, key=key, it=jnp.ones((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


def _finito_adaptive_step_local(F, g, cfg: DPCfg, state):
    """One sharded adaptive-Finito step (reference
    Finito_adaptive.jl:100-155). LOCKSTEP design: the global index's
    owner broadcasts its row state (s_i, ∇f_i, f_i(x_i), γ_i) in one
    stacked psum, then EVERY device runs the identical backtracking
    while_loop on replicated data — each backtrack iteration pays one
    scalar psum for f_i(z) (only the owner's oracle holds row i), and
    the closed-form (av, hat_γ) rescales are replicated algebra. The
    final table writes land only on the owner's shard."""
    from ciao_tpu.solvers.base import Status

    N = cfg.N
    rdt = real_dtype_of(state.av)
    eps = jnp.finfo(rdt).eps
    i_glob = _global_single_index(state.key, state.it, N, cfg.sweeping)
    ax = jax.lax.axis_index(DATA_AXIS)
    owner = i_glob // cfg.n_loc
    i_loc = i_glob % cfg.n_loc
    mine = ax == owner

    def bcast_vec(v):
        return _psum(jnp.where(mine, v, jnp.zeros_like(v)))

    rows = bcast_vec(jnp.stack([state.s[i_loc], state.gradf[i_loc]]))
    s_i, gradf_i = rows[0], rows[1]
    scal = bcast_vec(jnp.stack([
        state.fi_x[i_loc].astype(rdt), state.gamma[i_loc].astype(rdt)
    ]))
    fi_xi, gamma_i = scal[0], scal[1]

    def sqnorm(v):
        return jnp.sum(jnp.abs(v) ** 2).astype(rdt)

    def fi_at(z):
        val = F.value_i(z, i_loc).astype(rdt)
        return _psum(jnp.where(mine, val, jnp.zeros_like(val)))

    class Carry(NamedTuple):
        gi: jnp.ndarray
        hat: jnp.ndarray
        av: jnp.ndarray
        z: jnp.ndarray
        res: jnp.ndarray
        done: jnp.ndarray
        abort: jnp.ndarray

    def cond(c: Carry):
        return ~c.done

    def body(c: Carry):
        abort_now = c.gi < cfg.tol_b / N
        fi_z = fi_at(c.z)
        model = (
            fi_xi
            + jnp.real(jnp.vdot(gradf_i, c.res)).astype(rdt)
            + (0.5 * N * cfg.alpha / c.gi) * sqnorm(c.res)
        )
        tolv = 10 * eps * (1 + jnp.abs(fi_z))
        satisfied = fi_z <= model + tolv
        done = abort_now | satisfied
        gi_new = c.gi * jnp.asarray(0.8, rdt)
        av1 = c.av / c.hat
        av1 = av1 + s_i / gi_new - s_i / c.gi
        hat_new = 1.0 / (1.0 / c.hat + 1.0 / gi_new - 1.0 / c.gi)
        av1 = av1 * hat_new
        z_new = g.prox_only(av1, hat_new)
        res_new = z_new - s_i
        keep = done

        def pick(a, b):
            return jnp.where(keep, a, b)

        return Carry(
            gi=pick(c.gi, gi_new), hat=pick(c.hat, hat_new),
            av=jnp.where(keep, c.av, av1), z=jnp.where(keep, c.z, z_new),
            res=jnp.where(keep, c.res, res_new), done=done,
            abort=c.abort | abort_now,
        )

    c0 = Carry(
        gi=gamma_i, hat=state.hat_gamma, av=state.av, z=state.z,
        res=state.z - s_i, done=jnp.zeros((), bool),
        abort=jnp.zeros((), bool),
    )
    c = jax.lax.while_loop(cond, body, c0)

    key, _ = jax.random.split(state.key)

    def aborted(_):
        return state._replace(
            key=key, status=jnp.asarray(Status.GAMMA_UNDERFLOW, jnp.int32)
        )

    def update(_):
        def owner_set(table, row, val):
            cur = table[row]
            return table.at[row].set(
                jnp.where(mine, val.astype(cur.dtype), cur)
            )

        gamma = owner_set(state.gamma, i_loc, c.gi)
        hat = c.hat
        av = c.av + (hat / c.gi) * (c.z - s_i)
        s = owner_set(state.s, i_loc, c.z)
        av = av + (hat / N) * gradf_i
        fi_new_loc, g_new_loc = F.value_and_grad_i(c.z, i_loc)
        g_new = bcast_vec(g_new_loc)
        fi_new = _psum(jnp.where(
            mine, fi_new_loc.astype(rdt), jnp.zeros((), rdt)
        ))
        fi_x = owner_set(state.fi_x, i_loc, fi_new)
        gradf = owner_set(state.gradf, i_loc, g_new)
        av = av - (hat / N) * g_new
        z = g.prox_only(av, hat)
        return DPFinitoAdaptiveState(
            s=s, gradf=gradf, fi_x=fi_x, gamma=gamma, hat_gamma=hat,
            av=av, z=z, key=key, it=state.it + 1, status=state.status,
        )

    def step(st):
        return jax.lax.cond(c.abort, aborted, update, None)

    # status guard: once aborted, the state freezes (reference returns
    # nothing and iteration stops; here the abort is a carried enum)
    return jax.lax.cond(
        state.status == Status.RUNNING, step, lambda st: st, state
    )


def _lfinito_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded LFinito bootstrap (reference Finito_LFinito.jl:39-74);
    O(n) memory per device — only γ is sharded."""
    hat_gamma = 1.0 / _psum(jnp.sum(1.0 / gamma))
    av = x0 - (hat_gamma / cfg.N) * _psum(F.grad_sum_all(x0))
    return DPLFinitoState(
        gamma=gamma, hat_gamma=hat_gamma, av=av, z=av, z_full=av, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _lfinito_step_local(F, g, cfg: DPCfg, state: DPLFinitoState):
    """Sharded LFinito epoch (reference Finito_LFinito.jl:77-103): full
    psum'd gradient refresh, then a lockstep sweep where each inner step
    processes D sub-blocks (one per device) against the same z — the
    distributed minibatch-LFinito estimator."""
    N, b_loc = cfg.N, cfg.b_loc
    n_loc = cfg.n_loc
    d_loc = n_loc // b_loc
    hat = state.hat_gamma
    ax = jax.lax.axis_index(DATA_AXIS)

    z_full = g.prox_only(state.av, hat)
    av = z_full - (hat / N) * _psum(F.grad_sum_all(z_full))

    if cfg.sweeping == Sweep.SHUFFLED:
        ke = jax.random.fold_in(jax.random.fold_in(state.key, state.it), ax)
        order = jax.random.permutation(ke, d_loc).astype(jnp.int32)
    else:
        order = jnp.arange(d_loc, dtype=jnp.int32)

    def block_body(carry, j):
        av, z = carry
        z = g.prox_only(av, hat)
        start = j * b_loc
        diff = F.grad_sum_diff_block(z_full, z, start, b_loc)
        inv_g = jnp.sum(
            1.0 / jax.lax.dynamic_slice_in_dim(state.gamma, start, b_loc)
        )
        av = av + _psum((hat / N) * diff + hat * inv_g * (z - z_full))
        return (av, z), None

    (av, z), _ = jax.lax.scan(block_body, (av, state.z), order)
    return state._replace(av=av, z=z, z_full=z_full, it=state.it + 1)


def _lfinito_local_epoch(F, g, cfg: DPCfg, state: DPLFinitoState):
    """LOCAL-SWEEP LFinito epoch (beyond the reference; the multi-chip
    throughput mode): after the exact psum'd anchor refresh, each device
    sweeps ONLY its own blocks, updating a private av copy with purely
    local innovations (no per-block collective), and the epoch boundary
    resyncs with one delta psum

        av ← av₀ + psum(av_d − av₀)

    — TWO collectives per epoch vs the lockstep path's d_loc + 1.
    Unlike the SAGA/Finito local rounds no periodic rebase is needed:
    the NEXT epoch's anchor refresh recomputes av exactly from z_full,
    so delta-resync rounding cannot accumulate across epochs. The
    trajectory is a documented local-update variant (each device's
    sweep sees only its own innovations between boundaries); at D=1 it
    reproduces the single-chip sweep algebra, and the solution view is
    prox(av) after the resync."""
    N, B = cfg.N, cfg.b_loc
    n_loc = cfg.n_loc
    d_loc = n_loc // B
    hat = state.hat_gamma
    ax = jax.lax.axis_index(DATA_AXIS)

    z_full = g.prox_only(state.av, hat)

    if cfg.sweeping == Sweep.SHUFFLED:
        ke = jax.random.fold_in(jax.random.fold_in(state.key, state.it), ax)
        order = jax.random.permutation(ke, d_loc).astype(jnp.int32)
    else:
        order = jnp.arange(d_loc, dtype=jnp.int32)

    av0 = z_full - (hat / N) * _psum(F.grad_sum_all(z_full))

    def block_body(av, j):
        z = g.prox_only(av, hat)
        start = j * B
        diff = F.grad_sum_diff_block(z_full, z, start, B)  # LOCAL
        inv_g = jnp.sum(
            1.0 / jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
        )
        av = av + (hat / N) * diff + hat * inv_g * (z - z_full)
        return av, None

    av_d, _ = jax.lax.scan(block_body, av0, order)

    av = av0 + _psum(av_d - av0)  # exact: each row owned by one device
    z = g.prox_only(av, hat)
    return state._replace(av=av, z=z, z_full=z_full, it=state.it + 1)


def _lfinito_step_or_local(F, g, cfg: DPCfg, state: DPLFinitoState):
    """One DP LFinito epoch: the lockstep (per-block psum) path, or
    (``cfg.local``) the local-sweep path with two collectives."""
    if cfg.local:
        return _lfinito_local_epoch(F, g, cfg, state)
    return _lfinito_step_local(F, g, cfg, state)


def _saga_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded SAGA bootstrap (reference SAGA_basic.jl:41-48). In coeff
    mode the local table is the (n_loc,) coefficient shard and the mean
    is one apply + psum."""
    if cfg.coeff:
        s = F.coeff_all(x0)                      # local rows' coefficients
        av = _psum(F.apply_all(s)) / cfg.N
    else:
        s = _rows(F, x0, cfg.n_loc)
        av = _psum(jnp.sum(s, axis=0)) / cfg.N
    z = g.prox_only((1 - gamma) * x0, gamma)
    return DPSAGAState(
        s=s, gamma=gamma, av=av, z=z, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _saga_step_local(F, g, cfg: DPCfg, state: DPSAGAState):
    """Sharded minibatch SAGA/SAG step (reference SAGA_basic.jl:53-67;
    minibatching is the reference's own TODO at :74). The biased SAG /
    unbiased SAGA update-order quirk is preserved."""
    N, B = cfg.N, cfg.b_loc
    B_glob = B * cfg.D
    if cfg.block:
        # contiguous fast path: each device draws one of its sub-blocks
        ax = jax.lax.axis_index(DATA_AXIS)
        k = jax.random.fold_in(jax.random.fold_in(state.key, state.it), ax)
        j = jax.random.randint(k, (), 0, cfg.n_loc // B, dtype=jnp.int32)
        start = j * B
        if cfg.coeff:
            # coefficient shard: the innovation is one extra matvec over
            # the same local rows + the x-sized psum — zero table IO
            c_new = F.coeff_block(state.z, start, B)
            c_old = jax.lax.dynamic_slice_in_dim(state.s, start, B)
            innov = _psum(F.apply_rows_block(c_new - c_old, start, B))
            s = jax.lax.dynamic_update_slice_in_dim(state.s, c_new, start, 0)
        else:
            G_B = F.grad_block(state.z, start, B)
            s_old = jax.lax.dynamic_slice_in_dim(state.s, start, B, 0)
            innov = _psum(jnp.sum(G_B - s_old, axis=0))
            s = jax.lax.dynamic_update_slice_in_dim(state.s, G_B, start, 0)
    else:
        idx = local_indices(state.key, state.it, cfg.n_loc, B, cfg.sweeping)
        G_B = F.grad_batch(state.z, idx)
        innov = _psum(jnp.sum(G_B - state.s[idx], axis=0))  # (n,)
        s = state.s.at[idx].set(G_B)
    diff = innov / B_glob
    if cfg.sag:
        av = state.av + innov / N
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (diff + state.av)
        av = state.av + innov / N
    z = g.prox_only(w, state.gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + 1)


def _local_round_starts(key, it0, n_loc, B, K, sweeping):
    """The device's K consecutive block starts for its local round,
    drawn from the SAME stateless (key, it, device) stream as the
    per-step ``local_block_start`` schedule, in one vectorized pass."""
    its = it0 + jnp.arange(K, dtype=jnp.int32)
    return jax.vmap(
        lambda it: local_block_start(key, it, n_loc, B, sweeping)
    )(its)


def _round_boundary_av(cfg: DPCfg, it0, av0, av_loc, exact_fn):
    """Round-boundary av sync for the local-update modes: normally the
    delta resync ``av0 + psum(av_loc − av0)``, and every
    ``cfg.rebase_every`` rounds the EXACT recompute from the local
    tables (one full local pass via ``exact_fn``, psum'd). The delta
    form is exact in REAL arithmetic, but in f32 its rounding
    accumulates across rounds with no restoring force — measured on a
    512×32 f32 lasso: unrebased local-Finito drifts to suboptimality
    1.4 after 3000 rounds (diverging), rebase-every-100 reaches 4.4e-5
    (below the f32 per-step floor). The ``lax.cond`` only selects the
    LOCAL summand; the psum stays unconditional (SPMD-safe — the
    predicate is replicated, every device takes the same branch)."""
    if cfg.rebase_every <= 0:
        return av0 + _psum(av_loc - av0)
    r = (it0 - 1) // cfg.local_steps
    do_rb = (r % cfg.rebase_every) == (cfg.rebase_every - 1)
    summand, offset = jax.lax.cond(
        do_rb,
        lambda: (exact_fn(), jnp.zeros_like(av0)),
        lambda: (av_loc - av0, av0),
    )
    return offset + _psum(summand)


def _saga_local_round(F, g, cfg: DPCfg, state: DPSAGAState):
    """LOCAL-UPDATE round (beyond the reference; the multi-chip
    throughput mode): ``local_steps`` coefficient-SAGA steps run purely
    on the device's own shard — the gradient estimator is
    diff_loc + av with diff_loc from the LOCAL minibatch and av the
    (stale) global table mean, each device accumulating only its own
    shard's table-mean contribution — followed by ONE sync:

        av ← av₀ + psum(av_d − av₀)   (EXACT global table mean — every
                                       row is owned by one device)
        z  ← psum(z_d) / D            (iterate averaging)

    This trades the per-step x-sized psum for one collective per K
    steps. The trajectory is NOT the reference minibatch-SAGA path (a
    documented local-update variant); convergence on the planted
    problems is pinned by tests."""
    N, B, K = cfg.N, cfg.b_loc, cfg.local_steps
    av0 = state.av

    def body(carry, _):
        s, av, z, it = carry
        start = local_block_start(state.key, it, cfg.n_loc, B,
                                  cfg.sweeping)
        c_new = F.coeff_block(z, start, B)
        c_old = jax.lax.dynamic_slice_in_dim(s, start, B)
        innov = F.apply_rows_block(c_new - c_old, start, B)  # LOCAL
        s = jax.lax.dynamic_update_slice_in_dim(s, c_new, start, 0)
        if cfg.sag:
            av = av + innov / N
            w = z - state.gamma * av
        else:
            w = z - state.gamma * (innov / B + av)
            av = av + innov / N
        z = g.prox_only(w, state.gamma)
        return (s, av, z, it + 1), None

    (s, av, z, _), _ = jax.lax.scan(
        body, (state.s, av0, state.z, state.it), None, length=K
    )

    av = _round_boundary_av(cfg, state.it, av0, av,
                            lambda: F.apply_all(s) / N)
    z = _psum(z) / cfg.D
    return state._replace(s=s, av=av, z=z, it=state.it + K)


def _saga_step_or_round(F, g, cfg: DPCfg, state: DPSAGAState):
    """One iterate of the DP SAGA family: the reference-parity global
    minibatch step, or (``local_steps > 1``) one local-update round."""
    if cfg.local_steps > 1:
        return _saga_local_round(F, g, cfg, state)
    return _saga_step_local(F, g, cfg, state)


def _svrg_init_local(F, g, x0, gamma, m, key, cfg: DPCfg):
    """Sharded SVRG bootstrap (reference SVRG_basic.jl:58-67): the anchor
    full gradient is one local matmul + psum."""
    av = _psum(F.grad_sum_all(x0)) / cfg.N
    return DPSVRGState(
        gamma=gamma, m=jnp.asarray(m, jnp.int32), av=av,
        z=jnp.zeros_like(x0), z_full=x0, w=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _svrg_step_local(F, g, cfg: DPCfg, state: DPSVRGState):
    """Sharded SVRG outer step (reference SVRG_basic.jl:71-96): each
    inner iterate draws b_loc indices per device iid from its block, and
    the variance-reduced direction is pmean'd — distributed minibatch
    SVRG with global batch b_loc · D."""
    N = cfg.N
    gamma, av = state.gamma, state.av
    ax = jax.lax.axis_index(DATA_AXIS)
    kstep = jax.random.fold_in(state.key, state.it)

    def inner(k, carry):
        w, zsum = carry
        if cfg.block:
            # contiguous-block fast path (same (key, it, k, device)
            # stream as the local-inner mode, so D=1 stays bit-equal)
            start = local_block_start(kstep, k + 1, cfg.n_loc, cfg.b_loc,
                                      cfg.sweeping)
            d = F.grad_sum_diff_block(state.z_full, w, start, cfg.b_loc)
        else:
            kk = jax.random.fold_in(jax.random.fold_in(kstep, k), ax)
            i = jax.random.randint(kk, (cfg.b_loc,), 0, cfg.n_loc,
                                   dtype=jnp.int32)
            d = F.grad_sum_diff(state.z_full, w, i)  # one row read
        d = _psum(d) / (cfg.b_loc * cfg.D)
        w = g.prox_only(w + gamma * (d - av), gamma)
        return w, zsum + w

    w, zsum = jax.lax.fori_loop(0, state.m, inner, (state.w, state.z))
    z_full = zsum / state.m.astype(jnp.zeros((), jnp.result_type(zsum)).real.dtype)
    w_next = w if cfg.plus else z_full
    av_next = _psum(F.grad_sum_all(z_full)) / N
    m_next = state.m * 2 if cfg.plus else state.m
    return state._replace(
        m=m_next, av=av_next, z=jnp.zeros_like(zsum), z_full=z_full,
        w=w_next, it=state.it + 1,
    )


def _svrg_local_outer(F, g, cfg: DPCfg, state: DPSVRGState):
    """LOCAL-INNER SVRG outer step (beyond the reference; the multi-chip
    throughput mode): the whole inner loop runs purely on the device's
    own shard — the variance-reduced direction is the LOCAL minibatch's
    anchor-minus-live diff plus the (synced) GLOBAL anchor mean — and
    only the outer boundary pays collectives: one psum of the iterate
    average and one psum of the refreshed anchor gradient, where the
    lockstep path (``_svrg_step_local``) pays one psum per INNER step.
    The trajectory is a documented
    local-update variant (each device's inner loop sees only its own
    block between boundaries; the global anchor term keeps the
    direction variance-reduced around the full gradient); at D=1 it
    coincides with the single-chip block-sampled inner loop. No
    periodic rebase is needed: the boundary anchor refresh recomputes
    av exactly from z_full every outer step."""
    N, B = cfg.N, cfg.b_loc
    gamma, av = state.gamma, state.av
    kout = jax.random.fold_in(state.key, state.it)
    ax = jax.lax.axis_index(DATA_AXIS)

    def inner(k, carry):
        w, zsum = carry
        if cfg.block:
            start = local_block_start(kout, k + 1, cfg.n_loc, B,
                                      cfg.sweeping)
            d = F.grad_sum_diff_block(state.z_full, w, start, B) / B
        else:
            kk = jax.random.fold_in(jax.random.fold_in(kout, k), ax)
            i = jax.random.randint(kk, (B,), 0, cfg.n_loc, dtype=jnp.int32)
            d = F.grad_sum_diff(state.z_full, w, i) / B  # LOCAL
        w = g.prox_only(w + gamma * (d - av), gamma)
        return w, zsum + w

    w, zsum = jax.lax.fori_loop(0, state.m, inner, (state.w, state.z))
    m_den = state.m.astype(jnp.zeros((), jnp.result_type(zsum)).real.dtype)

    z_full = _psum(zsum) / (m_den * cfg.D)
    av_next = _psum(F.grad_sum_all(z_full)) / N
    w_next = (_psum(w) / cfg.D) if cfg.plus else z_full
    m_next = state.m * 2 if cfg.plus else state.m
    return state._replace(
        m=m_next, av=av_next, z=jnp.zeros_like(zsum), z_full=z_full,
        w=w_next, it=state.it + 1,
    )


def _svrg_step_or_local(F, g, cfg: DPCfg, state: DPSVRGState):
    """One DP SVRG outer iterate: the lockstep (psum-per-inner-step)
    path, or (``cfg.local``) the local-inner path with two collectives
    per outer step."""
    if cfg.local:
        return _svrg_local_outer(F, g, cfg, state)
    return _svrg_step_local(F, g, cfg, state)


class DPKatyushaState(NamedTuple):
    Lmax: jnp.ndarray
    tau1: jnp.ndarray
    tau2: jnp.ndarray
    av: jnp.ndarray         # (n,) anchor μ = ∇f(x̃), replicated
    x_tilde: jnp.ndarray    # (n,) outer iterate
    y: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x_tilde


def _katyusha_init_local(F, g, x0, Lmax, tau1, tau2, key, cfg: DPCfg):
    """Sharded Katyusha bootstrap (solvers.katyusha — beyond the
    reference): the anchor full gradient is one local pass + psum."""
    av = _psum(F.grad_sum_all(x0)) / cfg.N
    return DPKatyushaState(
        Lmax=Lmax, tau1=tau1, tau2=tau2, av=av, x_tilde=x0, y=x0, z=x0,
        key=key, it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _katyusha_step_local(F, g, cfg: DPCfg, state: DPKatyushaState):
    """One sharded Katyusha outer iterate. LOCKSTEP (default): each of
    the m inner steps draws one block per device and pmean's the
    variance-reduced direction (global inner batch b_loc·D — one
    x-sized psum per inner step). LOCAL (``cfg.local``): the inner loop
    runs purely on-shard against the global anchor, and the boundary
    pmeans the three sequences (x̃ average + y/z warm starts, stacked
    into one psum) and psums the anchor refresh — two collectives per
    outer step total. The
    momentum coupling keeps the direction anchored to the GLOBAL full
    gradient in both modes; at D=1 the two coincide."""
    N, B, m = cfg.N, cfg.b_loc, cfg.m_inner
    rdt = jnp.zeros((), jnp.result_type(state.y)).real.dtype
    s = (state.it - 1).astype(rdt)
    tau1 = 2.0 / (s + 4.0) if cfg.variant == "ns" else state.tau1
    tau2 = state.tau2
    alpha = 1.0 / (3.0 * tau1 * state.Lmax)
    beta = 1.0 / (3.0 * state.Lmax)
    av, xt = state.av, state.x_tilde
    kout = jax.random.fold_in(state.key, state.it)
    ax = jax.lax.axis_index(DATA_AXIS)

    def inner(carry, k):
        y, z, ysum = carry
        x = tau1 * z + tau2 * xt + (1.0 - tau1 - tau2) * y
        if cfg.block:
            start = local_block_start(kout, k + 1, cfg.n_loc, B,
                                      cfg.sweeping)
            diff = F.grad_sum_diff_block(x, xt, start, B)
        else:
            kk = jax.random.fold_in(jax.random.fold_in(kout, k), ax)
            i = jax.random.randint(kk, (B,), 0, cfg.n_loc, dtype=jnp.int32)
            diff = F.grad_sum_diff(x, xt, i)
        if cfg.local:
            gr = av + diff / B                   # LOCAL estimator
        else:
            gr = av + _psum(diff) / (B * cfg.D)  # lockstep pmean
        z = g.prox_only(z - alpha * gr, alpha)
        y = g.prox_only(x - beta * gr, beta)
        return (y, z, ysum + y), None

    (y, z, ysum), _ = jax.lax.scan(
        inner, (state.y, state.z, jnp.zeros_like(state.y)),
        jnp.arange(m, dtype=jnp.int32),
    )
    if cfg.local:
        # boundary: average the sequences across devices (stacked into
        # ONE psum), then the exact anchor refresh psum — two
        # collectives per outer step
        y, z, ysum = _psum(jnp.stack([y, z, ysum])) / cfg.D
    x_tilde = ysum / jnp.asarray(m, ysum.dtype)
    av = _psum(F.grad_sum_all(x_tilde)) / N
    return state._replace(
        tau1=tau1.astype(state.tau1.dtype) if cfg.variant == "ns"
        else state.tau1,
        av=av, x_tilde=x_tilde, y=y, z=z, it=state.it + 1,
    )


class DPLSVRGState(NamedTuple):
    gamma: jnp.ndarray      # scalar stepsize
    p: jnp.ndarray          # scalar refresh probability (f32)
    av: jnp.ndarray         # (n,) full-gradient anchor, replicated
    z: jnp.ndarray          # (n,) anchor point, replicated
    w: jnp.ndarray          # (n,) iterate, replicated
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.w


def _lsvrg_init_local(F, g, x0, gamma, p, key, cfg: DPCfg):
    """Sharded L-SVRG bootstrap (solvers.lsvrg — beyond the reference):
    the anchor full gradient is one local pass + psum."""
    av = _psum(F.grad_sum_all(x0)) / cfg.N
    return DPLSVRGState(
        gamma=gamma, p=p, av=av, z=x0, w=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _lsvrg_step_local(F, g, cfg: DPCfg, state: DPLSVRGState):
    """One sharded loopless-SVRG step: each device draws a block from
    its own shard and the variance-reduced direction is pmean'd (global
    batch b_loc·D). The Bernoulli anchor coin is REPLICATED — derived
    from (key, it) only, the same stream as the single-chip solver —
    so every device jumps together; the refresh full pass runs inside a
    ``lax.cond`` locally (no collective in the branch) and its partial
    sum rides the SAME stacked psum as the direction, keeping the
    collective unconditional and the step at ONE psum total."""
    from ciao_tpu.solvers.lsvrg import _coin

    N, B = cfg.N, cfg.b_loc
    gamma, av, w = state.gamma, state.av, state.w
    if cfg.block:
        start = local_block_start(state.key, state.it, cfg.n_loc, B,
                                  cfg.sweeping)
        d_loc = F.grad_sum_diff_block(state.z, w, start, B)
    else:
        ax = jax.lax.axis_index(DATA_AXIS)
        kk = jax.random.fold_in(jax.random.fold_in(state.key, state.it), ax)
        i = jax.random.randint(kk, (B,), 0, cfg.n_loc, dtype=jnp.int32)
        d_loc = F.grad_sum_diff(state.z, w, i)
    flip = _coin(state.key, state.it, state.p)
    ref_loc = jax.lax.cond(
        flip, lambda: F.grad_sum_all(w), lambda: jnp.zeros_like(av)
    )
    tot = _psum(jnp.stack([d_loc, ref_loc]))     # ONE collective
    w_new = g.prox_only(w + gamma * (tot[0] / (B * cfg.D) - av), gamma)
    av_new = jnp.where(flip, tot[1] / N, state.av)
    z_new = jnp.where(flip, w, state.z)
    return state._replace(av=av_new, z=z_new, w=w_new, it=state.it + 1)


def _lsvrg_rebase_local(F, g, cfg: DPCfg, state: DPLSVRGState):
    """Exact anchor-gradient recompute at the current anchor point
    (one local pass + psum) — required after an oracle storage swap:
    at small p the carried μ keeps the old operator's gradient until
    the next coin fires."""
    return state._replace(av=_psum(F.grad_sum_all(state.z)) / cfg.N)


class DPLKatyushaState(NamedTuple):
    Lmax: jnp.ndarray
    sigma: jnp.ndarray
    theta1: jnp.ndarray
    theta2: jnp.ndarray
    p: jnp.ndarray
    av: jnp.ndarray         # (n,) anchor μ = ∇f(w_anchor), replicated
    w_anchor: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.y


def _lkatyusha_init_local(F, g, x0, Lmax, sigma, theta1, theta2, p, key,
                          cfg: DPCfg):
    """Sharded L-Katyusha bootstrap (solvers.lsvrg.LKatyusha — beyond
    the reference): one local pass + psum for the anchor gradient."""
    av = _psum(F.grad_sum_all(x0)) / cfg.N
    return DPLKatyushaState(
        Lmax=Lmax, sigma=sigma, theta1=theta1, theta2=theta2, p=p, av=av,
        w_anchor=x0, y=x0, z=x0, key=key, it=jnp.ones((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


def _lkatyusha_step_local(F, g, cfg: DPCfg, state: DPLKatyushaState):
    """One sharded loopless-Katyusha step (cf. _lsvrg_step_local): the
    momentum coupling and prox z-update are replicated O(n) algebra;
    each device contributes its block's anchor-to-live diff and the
    (coin-gated) refresh partial through ONE stacked psum."""
    from ciao_tpu.solvers.lsvrg import _coin

    N, B = cfg.N, cfg.b_loc
    th1, th2, sig = state.theta1, state.theta2, state.sigma
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / state.Lmax
    av, w = state.av, state.w_anchor
    x = th1 * state.z + th2 * w + (1.0 - th1 - th2) * state.y
    if cfg.block:
        start = local_block_start(state.key, state.it, cfg.n_loc, B,
                                  cfg.sweeping)
        d_loc = F.grad_sum_diff_block(x, w, start, B)
    else:
        ax = jax.lax.axis_index(DATA_AXIS)
        kk = jax.random.fold_in(jax.random.fold_in(state.key, state.it), ax)
        i = jax.random.randint(kk, (B,), 0, cfg.n_loc, dtype=jnp.int32)
        d_loc = F.grad_sum_diff(x, w, i)
    flip = _coin(state.key, state.it, state.p)
    ref_loc = jax.lax.cond(
        flip, lambda: F.grad_sum_all(state.y), lambda: jnp.zeros_like(av)
    )
    tot = _psum(jnp.stack([d_loc, ref_loc]))     # ONE collective
    gr = av + tot[0] / (B * cfg.D)
    denom = 1.0 + eta * sig
    tau = step / denom
    z_new = g.prox_only((state.z + (eta * sig) * x - step * gr) / denom, tau)
    y_new = x + th1 * (z_new - state.z)
    av_new = jnp.where(flip, tot[1] / N, state.av)
    w_new = jnp.where(flip, state.y, state.w_anchor)
    return state._replace(
        av=av_new, w_anchor=w_new, y=y_new, z=z_new, it=state.it + 1
    )


def _lkatyusha_rebase_local(F, g, cfg: DPCfg, state: DPLKatyushaState):
    """Exact anchor-gradient recompute at the current anchor point
    (one local pass + psum) — cf. _lsvrg_rebase_local."""
    return state._replace(av=_psum(F.grad_sum_all(state.w_anchor)) / cfg.N)


class DPPointSAGAState(NamedTuple):
    gamma: jnp.ndarray      # scalar stepsize
    c: jnp.ndarray          # (N,) prox-coefficient table, sharded
    av: jnp.ndarray         # (n,) table mean, replicated
    x: jnp.ndarray          # (n,) iterate, replicated
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


def _point_saga_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded Point-SAGA bootstrap (solvers.point_saga — beyond the
    reference): local coefficient shard + one psum'd table mean."""
    c = F.coeff_all(x0)
    av = _psum(F.apply_all(c)) / cfg.N
    return DPPointSAGAState(
        gamma=gamma, c=c, av=av, x=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _point_saga_step_local(F, g, cfg: DPCfg, state: DPPointSAGAState):
    """One sharded Point-SAGA step: each device proxes a block of its
    own rows around the shared shifted iterate; the block contributions
    u = Σ(c−θ)·conj(a) are ONE x-sized psum (cf.
    solvers.point_saga._point_saga_step)."""
    N, B = cfg.N, cfg.b_loc
    gamma = state.gamma
    v = state.x - gamma * state.av
    start = local_block_start(state.key, state.it, cfg.n_loc, B,
                              cfg.sweeping)
    c_B = jax.lax.dynamic_slice_in_dim(state.c, start, B)
    theta, u_loc = F.pointprox_block(v, c_B, gamma, start, B)
    c = jax.lax.dynamic_update_slice_in_dim(state.c, theta, start, 0)
    u = _psum(u_loc)
    x = v + (gamma / (B * cfg.D)) * u
    av = state.av - u / N
    return state._replace(c=c, av=av, x=x, it=state.it + 1)


def _point_saga_rebase_local(F, g, cfg: DPCfg, state: DPPointSAGAState):
    """Exact table-mean recompute from the local coefficient shards
    (one apply + psum) — required after an oracle storage swap."""
    return state._replace(av=_psum(F.apply_all(state.c)) / cfg.N)


class DPFBState(NamedTuple):
    gamma: jnp.ndarray      # scalar stepsize
    t: jnp.ndarray          # scalar Nesterov sequence (1.0 when not fast)
    x: jnp.ndarray          # (n,) iterate, replicated
    y: jnp.ndarray          # (n,) extrapolated point
    key: jnp.ndarray        # unused (deterministic method); uniform state
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


def _fb_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded ISTA/FISTA bootstrap (solvers.fb — beyond the
    reference): table-free; only the oracle rows shard."""
    rdt = jnp.zeros((), jnp.result_type(x0)).real.dtype
    return DPFBState(
        gamma=gamma, t=jnp.ones((), rdt), x=x0, y=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _fb_step_local(F, g, cfg: DPCfg, state: DPFBState):
    """One sharded forward-backward step: the full gradient is one
    local streaming pass + ONE x-sized psum; prox and extrapolation
    replicate (cf. solvers.fb._fb_step). ``polish_chunk`` routes the
    local pass through the compensated chunked sum (solvers.polish) —
    the deep-target accuracy below the f32 reduction floor, sharded:
    per-shard two-sum carries, the D-way psum adds only ~√D·eps."""
    gamma = state.gamma
    if cfg.polish_chunk:
        from ciao_tpu.solvers.polish import grad_sum_chunked

        grad = _psum(grad_sum_chunked(F, state.y,
                                      cfg.polish_chunk)) / cfg.N
    else:
        grad = _psum(F.grad_sum_all(state.y)) / cfg.N
    x_new = g.prox_only(state.y - gamma * grad, gamma)
    if cfg.variant == "fista":
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * state.t * state.t))
        y_new = x_new + ((state.t - 1.0) / t_new) * (x_new - state.x)
    else:
        t_new, y_new = state.t, x_new
    return state._replace(t=t_new, x=x_new, y=y_new, it=state.it + 1)


class DPDYSState(NamedTuple):
    gamma: jnp.ndarray      # scalar stepsize
    lam: jnp.ndarray        # scalar relaxation
    z: jnp.ndarray          # (n,) governing sequence, replicated
    xg: jnp.ndarray         # (n,) last prox_g point — solution view
    key: jnp.ndarray        # unused (deterministic); uniform state
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.xg


def _dys_init_local(F, gh, x0, gamma, lam, key, cfg: DPCfg):
    """Sharded Davis-Yin bootstrap (solvers.dys — beyond the
    reference): table-free; only the oracle rows shard. ``gh`` packs
    the TWO proximable terms (g, h) as one pytree."""
    return DPDYSState(
        gamma=gamma, lam=lam, z=x0, xg=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _dys_step_local(F, gh, cfg: DPCfg, state: DPDYSState):
    """One sharded Davis-Yin step: the solvers.dys step body verbatim
    with the full gradient as one local streaming pass + ONE x-sized
    psum; both proxes and the z-algebra replicate."""
    from ciao_tpu.solvers.dys import _dys_step

    g, h = gh
    grad_fn = lambda xg: _psum(F.grad_sum_all(xg)) / cfg.N
    return _dys_step(F, g, h, None, state, grad_fn=grad_fn)


class DPPDState(NamedTuple):
    tau: jnp.ndarray        # scalar primal stepsize
    sigma: jnp.ndarray      # scalar dual stepsize
    x: jnp.ndarray          # (n,) primal iterate, replicated
    y: jnp.ndarray          # (m,) dual iterate, replicated
    key: jnp.ndarray        # unused (deterministic); uniform state
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


def _pd_init_local(F, ghk, x0, tau, sigma, key, cfg: DPCfg):
    """Sharded Condat-Vũ bootstrap (solvers.primal_dual — beyond the
    reference): table-free; only the oracle rows shard. ``ghk`` packs
    (g, h, K) as one pytree (the two proximable terms + linear map)."""
    _, _, K = ghk
    m = K.out_dim(x0.shape[0])
    return DPPDState(
        tau=tau, sigma=sigma, x=x0, y=jnp.zeros(m, x0.dtype), key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _pd_step_local(F, ghk, cfg: DPCfg, state: DPPDState):
    """One sharded Condat-Vũ step: the solvers.primal_dual step body
    verbatim with the full gradient as one local streaming pass + ONE
    x-sized psum; K's matvec/rmatvec, both proxes and the dual update
    replicate."""
    from ciao_tpu.solvers.primal_dual import _pd_step

    g, h, K = ghk
    if cfg.polish_chunk:
        # deep-target route (parallel.deep_solve_pd_dp): per-shard
        # compensated chunked gradient, the _fb_step_local pattern
        from ciao_tpu.solvers.polish import grad_sum_chunked

        grad_fn = lambda x: _psum(grad_sum_chunked(
            F, x, cfg.polish_chunk)) / cfg.N
    else:
        grad_fn = lambda x: _psum(F.grad_sum_all(x)) / cfg.N
    return _pd_step(F, g, h, K, None, state, grad_fn=grad_fn)


class _PsumFBEOracle:
    """Oracle adapter for the replicated PANOC step: the ONLY oracle
    entry the FBE machinery uses (``value_sum_and_grad_sum_all``) runs
    on the local row shard and psums both reductions — so the whole
    solvers.panoc step body (L-BFGS, line search) reuses verbatim,
    executing replicated. The while_loop's collectives are legal under
    shard_map because its condition is computed from replicated values:
    every device takes the same trial count."""

    def __init__(self, F):
        self._F = F

    def value_sum_and_grad_sum_all(self, u):
        v, gsum = self._F.value_sum_and_grad_sum_all(u)
        return _psum(v), _psum(gsum)

    def value_sum_all(self, u):
        # adaptive γ-backtracking probe: local margin read + one psum
        return _psum(self._F.value_sum_all(u))


def _panoc_cfg(cfg: DPCfg):
    from ciao_tpu.solvers.panoc import PANOCCfg

    return PANOCCfg(N=cfg.N, mem=cfg.m_inner, max_ls=cfg.max_ls,
                    zerofpr=cfg.variant == "zerofpr", tol=None,
                    adaptive=cfg.adaptive)


def _panoc_init_local(F, g, x0, gamma, sigma, key, cfg: DPCfg):
    """Sharded PANOC/ZeroFPR bootstrap (solvers.panoc — beyond the
    reference): table-free; only the oracle rows shard, the L-BFGS ring
    and every iterate replicate. ``key`` is unused (deterministic)."""
    from ciao_tpu.solvers import panoc as _p

    rdt = jnp.zeros((), jnp.result_type(x0)).real.dtype
    pcfg = _panoc_cfg(cfg)
    Fp = _PsumFBEOracle(F)
    fx, gradx, z, gz, _r, fbe = _p._eval_fbe(Fp, g, x0, gamma, pcfg)
    m = pcfg.mem
    paux = x0.size if pcfg.zerofpr else 0
    return _p.PANOCState(
        gamma=gamma, sigma=sigma, x=x0, fx=fx, gradx=gradx, z=z,
        gz=jnp.real(gz), fbe=fbe,
        S=jnp.zeros((m, x0.size), x0.dtype),
        Y=jnp.zeros((m, x0.size), x0.dtype),
        rho=jnp.zeros((m,), rdt),
        head=jnp.zeros((), jnp.int32), count=jnp.zeros((), jnp.int32),
        pbase=jnp.zeros((paux,), x0.dtype),
        presid=jnp.zeros((paux,), x0.dtype),
        tau=jnp.ones((), rdt), ls_ewma=jnp.ones((), jnp.float32),
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _panoc_step_local(F, g, cfg: DPCfg, state):
    """One sharded PANOC/ZeroFPR step: each FBE evaluation is one local
    streaming pass + TWO psums (scalar value + x-sized gradient); the
    quasi-Newton direction and line search replicate exactly (cf.
    solvers.panoc._panoc_step)."""
    from ciao_tpu.solvers.panoc import _panoc_step

    return _panoc_step(_PsumFBEOracle(F), g, _panoc_cfg(cfg), state)


class DPSARAHState(NamedTuple):
    gamma: jnp.ndarray      # scalar stepsize
    eta: jnp.ndarray        # scalar ProxSARAH damping
    x_tilde: jnp.ndarray    # (n,) outer iterate, replicated
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x_tilde


def _sarah_init_local(F, g, x0, gamma, eta, key, cfg: DPCfg):
    """Sharded SARAH bootstrap (solvers.sarah — beyond the reference):
    table-free, so only the oracle rows shard; no gradient work at init
    (the full-pass v₀ belongs to the outer step)."""
    return DPSARAHState(
        gamma=gamma, eta=eta, x_tilde=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _sarah_step_local(F, g, cfg: DPCfg, state: DPSARAHState):
    """One sharded SARAH outer iterate (cf. solvers.sarah._sarah_step).
    LOCKSTEP (default): each of the m inner steps draws one block per
    device and pmeans the recursive-estimator innovation (global inner
    batch b_loc·D — one x-sized psum per inner step; the recursion
    itself stays replicated). LOCAL (``cfg.local``): each device runs
    its own recursive chain from the shared full-gradient bootstrap
    against purely-local innovations, and the boundary pmeans the final
    iterate — with the next outer step's exact v₀ psum that is two
    collectives per outer step total. At D=1 the two modes coincide
    bit-exactly (same stateless streams, psum over one device)."""
    from ciao_tpu.solvers.sarah import _damped_prox

    N, B, m = cfg.N, cfg.b_loc, cfg.m_inner
    gamma, eta = state.gamma, state.eta
    kout = jax.random.fold_in(state.key, state.it)
    ax = jax.lax.axis_index(DATA_AXIS)

    v0 = _psum(F.grad_sum_all(state.x_tilde)) / N
    w_prev = state.x_tilde
    w = _damped_prox(g, w_prev, v0, gamma, eta)

    def inner(carry, k):
        w_prev, w, v = carry
        if cfg.block:
            start = local_block_start(kout, k + 1, cfg.n_loc, B,
                                      cfg.sweeping)
            diff = F.grad_sum_diff_block(w, w_prev, start, B)
        else:
            kk = jax.random.fold_in(jax.random.fold_in(kout, k), ax)
            i = jax.random.randint(kk, (B,), 0, cfg.n_loc, dtype=jnp.int32)
            diff = F.grad_sum_diff(w, w_prev, i)
        if cfg.local:
            v = v + diff / B                      # LOCAL recursion
        else:
            v = v + _psum(diff) / (B * cfg.D)     # lockstep pmean
        w_next = _damped_prox(g, w, v, gamma, eta)
        return (w, w_next, v), None

    (_, w, _), _ = jax.lax.scan(
        inner, (w_prev, w, v0), jnp.arange(m, dtype=jnp.int32)
    )
    if cfg.local:
        w = _psum(w) / cfg.D   # boundary: average the local chains
    return state._replace(x_tilde=w, it=state.it + 1)


def _proshi_coupling(g, av, hat_gamma):
    z = g.prox_only(av, hat_gamma)
    return (z - av) / hat_gamma


def _proshi_init_local(F, g, x0, gamma, key, cfg: DPCfg):
    """Sharded ProShI bootstrap (reference ProShI_basic.jl:45-90):
    hat_γ = Σγ and av = Σ s_i are the two psums; z replicates."""
    n_loc, N = cfg.n_loc, cfg.N
    G = _rows(F, x0, n_loc)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = _psum(jnp.sum(gamma))
    av = _psum(jnp.sum(s, axis=0))
    z = _proshi_coupling(g, av, hat_gamma)
    return DPProshiState(
        s=s, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _proshi_step_local(F, g, cfg: DPCfg, state: DPProshiState):
    """Sharded ProShI step (reference ProShI_basic.jl:93-125): block
    variables stay put; the coupling delta is one psum, the prox of the
    sum and the broadcast of z are replicated — the all-gather + scatter
    pattern named in BASELINE.md realized as psum + replicated compute."""
    N, B = cfg.N, cfg.b_loc
    if cfg.sweeping != Sweep.RANDOM:
        start = local_block_start(state.key, state.it, cfg.n_loc, B, cfg.sweeping)
        gi = jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
        s_old = jax.lax.dynamic_slice_in_dim(state.s, start, B, 0)
        s_tmp = s_old + gi[:, None] * state.z[None, :]
        G_B = F.grad_pointwise_block(s_tmp, start, B)
        s_new = s_tmp - (gi / N)[:, None] * G_B
        s = jax.lax.dynamic_update_slice_in_dim(state.s, s_new, start, 0)
    else:
        idx = local_indices(state.key, state.it, cfg.n_loc, B, cfg.sweeping)
        gi = state.gamma[idx]
        s_old = state.s[idx]
        s_tmp = s_old + gi[:, None] * state.z[None, :]
        G_B = F.grad_pointwise(s_tmp, idx)
        s_new = s_tmp - (gi / N)[:, None] * G_B
        s = state.s.at[idx].set(s_new)
    av = state.av + _psum(jnp.sum(s_new - s_old, axis=0))
    z = _proshi_coupling(g, av, state.hat_gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + 1)


def _proshi_local_round(F, g, cfg: DPCfg, state: DPProshiState):
    """LOCAL-UPDATE ProShI round (beyond the reference; cf.
    _saga_local_round): ``local_steps`` block updates run purely on the
    device's own shard against a STALE coupling — each device maintains
    a private av copy (global av₀ + its own s-deltas) and re-derives
    z = (prox_g(av_d, Σγ) − av_d)/Σγ from it locally — then ONE
    collective at the round boundary resyncs the exact global sum

        av ← av₀ + psum(av_d − av₀)   (exact: every block variable s_i
                                       is owned by one device)

    and recomputes the true coupling. Iterates need no averaging — the
    only shared state IS (av, z). Like the SAGA/Finito rounds the
    delta-maintained av accumulates f32 rounding across rounds;
    ``rebase_every`` periodically recomputes av = Σ s_i exactly from
    the local table shards (one reduction, psum'd)."""
    N, B, K = cfg.N, cfg.b_loc, cfg.local_steps
    av0 = state.av

    def body(carry, _):
        s, av, z, it = carry
        start = local_block_start(state.key, it, cfg.n_loc, B,
                                  cfg.sweeping)
        gi = jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
        s_old = jax.lax.dynamic_slice_in_dim(s, start, B, 0)
        s_tmp = s_old + gi[:, None] * z[None, :]
        G_B = F.grad_pointwise_block(s_tmp, start, B)
        s_new = s_tmp - (gi / N)[:, None] * G_B
        s = jax.lax.dynamic_update_slice_in_dim(s, s_new, start, 0)
        av = av + jnp.sum(s_new - s_old, axis=0)      # LOCAL delta
        z = _proshi_coupling(g, av, state.hat_gamma)  # stale coupling
        return (s, av, z, it + 1), None

    (s, av_d, _, _), _ = jax.lax.scan(
        body, (state.s, av0, state.z, state.it), None, length=K
    )
    av = _round_boundary_av(cfg, state.it, av0, av_d,
                            lambda: jnp.sum(s, axis=0))
    z = _proshi_coupling(g, av, state.hat_gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + K)


def _proshi_step_or_round(F, g, cfg: DPCfg, state: DPProshiState):
    """One DP ProShI iterate: the reference-parity lockstep step, or
    (``local_steps > 1``) one local-update round."""
    if cfg.local_steps > 1:
        return _proshi_local_round(F, g, cfg, state)
    return _proshi_step_local(F, g, cfg, state)


def _saga_rebase_local(F, g, cfg: DPCfg, state: DPSAGAState):
    """Sharded mirror of ``solvers.saga.saga_rebase``: after an oracle
    row-storage swap the delta-maintained ``av`` keeps the old
    operator's bias forever — recompute it from the local coefficient
    shards (one apply + psum). Full-table mode is storage-consistent;
    returned unchanged."""
    if not cfg.coeff:
        return state
    return state._replace(av=_psum(F.apply_all(state.s)) / cfg.N)


def _finito_coeff_rebase_local(F, g, cfg: DPCfg, state: DPFinitoCoeffState):
    """Sharded mirror of ``solvers.finito.finito_rebase``:
    av = hat_γ·Σ(invg_j·zb_j − c_i·a_i/N) with the sums psum'd over the
    data axis; z re-proxed to keep the step invariant."""
    hat = state.hat_gamma
    av = hat * _psum(state.invg @ state.zb - F.apply_all(state.c) / cfg.N)
    return state._replace(av=av, z=g.prox_only(av, hat))


def _rebase_identity_local(F, g, cfg: DPCfg, state):
    """Families whose anchor is recomputed from a full pass every epoch
    (LFinito, SVRG) self-heal after one epoch; the full-table Finito
    and ProShI states are storage-consistent by construction."""
    return state

class DPSSNMState(NamedTuple):
    tau: jnp.ndarray     # scalar momentum weight (replicated)
    eta: jnp.ndarray     # scalar stepsize (replicated)
    c: jnp.ndarray       # (N,) coefficient table, sharded
    zb: jnp.ndarray      # (D·d_loc, n) per-block stored points, sharded
    gbar: jnp.ndarray    # (n,) global table mean, replicated
    x: jnp.ndarray       # (n,) iterate, replicated
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


def _ssnm_init_local(F, g, x0, tau, eta, key, cfg: DPCfg):
    """Sharded SSNM bootstrap (solvers.ssnm — beyond the reference):
    local coefficient shard + one apply psum; every stored point x0."""
    c = F.coeff_all(x0)
    gbar = _psum(F.apply_all(c)) / cfg.N
    d_loc = cfg.n_loc // cfg.b_loc
    zb = jnp.broadcast_to(x0, (d_loc,) + x0.shape)
    return DPSSNMState(
        tau=tau, eta=eta, c=c, zb=zb, gbar=gbar, x=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _ssnm_step_local(F, g, cfg: DPCfg, state: DPSSNMState):
    """One sharded SSNM step: each device draws a block from its own
    shard and forms its OWN momentum point y_d = τx + (1−τ)·φ_{j_d}
    (each term is anchored at its own stored point, so the pmean'd
    direction stays unbiased); ONE stacked x-sized psum carries the
    innovation, the mirror step and table-mean delta are replicated."""
    N, B = cfg.N, cfg.b_loc
    tau, eta = state.tau, state.eta
    ax = jax.lax.axis_index(DATA_AXIS)
    k = jax.random.fold_in(jax.random.fold_in(state.key, state.it), ax)
    j = jax.random.randint(k, (), 0, cfg.n_loc // B, dtype=jnp.int32)
    start = j * B
    y = tau * state.x + (1.0 - tau) * state.zb[j]      # per-device y_d
    c_new = F.coeff_block(y, start, B)
    c_old = jax.lax.dynamic_slice_in_dim(state.c, start, B)
    innov = _psum(F.apply_rows_block(c_new - c_old, start, B))
    grad = innov / (B * cfg.D) + state.gbar            # ∇̃ (unbiased)
    x = g.prox_only(state.x - eta * grad, eta)         # mirror step
    gbar = state.gbar + innov / N                      # exact table mean
    c = jax.lax.dynamic_update_slice_in_dim(state.c, c_new, start, 0)
    zb = state.zb.at[j].set(y)
    return state._replace(c=c, zb=zb, gbar=gbar, x=x, it=state.it + 1)


def _ssnm_rebase_local(F, g, cfg: DPCfg, state: DPSSNMState):
    """Exact ḡ recompute from the coefficient shards (storage-swap
    repair; cf. solvers.ssnm.ssnm_rebase)."""
    return state._replace(gbar=_psum(F.apply_all(state.c)) / cfg.N)




_FAMILY = {
    "finito": (_finito_init_local, _finito_step_local, DPFinitoState, False,
               _rebase_identity_local),
    "finito_coeff": (
        _finito_coeff_init_local, _finito_coeff_step_or_round,
        DPFinitoCoeffState, False, _finito_coeff_rebase_local,
    ),
    "finito_adaptive": (
        _finito_adaptive_init_local, _finito_adaptive_step_local,
        DPFinitoAdaptiveState, False, _rebase_identity_local,
    ),
    "lfinito": (_lfinito_init_local, _lfinito_step_or_local, DPLFinitoState,
                False, _rebase_identity_local),
    "saga": (_saga_init_local, _saga_step_or_round, DPSAGAState, True,
             _saga_rebase_local),
    "svrg": (_svrg_init_local, _svrg_step_or_local, DPSVRGState, True,
             _rebase_identity_local),
    "katyusha": (_katyusha_init_local, _katyusha_step_local,
                 DPKatyushaState, True, _rebase_identity_local),
    "lsvrg": (_lsvrg_init_local, _lsvrg_step_local, DPLSVRGState, True,
              _lsvrg_rebase_local),
    "lkatyusha": (_lkatyusha_init_local, _lkatyusha_step_local,
                  DPLKatyushaState, True, _lkatyusha_rebase_local),
    "sarah": (_sarah_init_local, _sarah_step_local, DPSARAHState, True,
              _rebase_identity_local),
    "fb": (_fb_init_local, _fb_step_local, DPFBState, True,
           _rebase_identity_local),
    "dys": (_dys_init_local, _dys_step_local, DPDYSState, True,
            _rebase_identity_local),
    "pd": (_pd_init_local, _pd_step_local, DPPDState, True,
           _rebase_identity_local),
    "panoc": (_panoc_init_local, _panoc_step_local, _PANOCState, True,
              _rebase_identity_local),
    "point_saga": (_point_saga_init_local, _point_saga_step_local,
                   DPPointSAGAState, True, _point_saga_rebase_local),
    "ssnm": (_ssnm_init_local, _ssnm_step_local, DPSSNMState, True,
             _ssnm_rebase_local),
    "proshi": (_proshi_init_local, _proshi_step_or_round, DPProshiState,
               False, _rebase_identity_local),
}


# ---------------------------------------------------------------------------
# shard_map + jit assembly (cached per (mesh, problem structure, cfg))
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _compiled(family: str, mesh, f_treedef, f_specs_leaves, g_treedef,
              cfg: DPCfg, extra_init_scalars: int):
    """Build (init_fn, step_fn, run_fn) for a family on a mesh.

    Cached on the problem STRUCTURE (oracle treedefs + static cfg), so
    repeated solves reuse both the closures and their jit caches.
    """
    init_local, step_local, state_cls, scalar_gamma, rebase_local = (
        _FAMILY[family]
    )
    f_specs = jax.tree_util.tree_unflatten(f_treedef, list(f_specs_leaves))
    g_specs_tree = jax.tree_util.tree_unflatten(
        g_treedef, [P()] * g_treedef.num_leaves
    )
    st_specs = _state_specs(state_cls, scalar_gamma=scalar_gamma, coeff=cfg.coeff)
    gamma_spec = P() if scalar_gamma else P(DATA_AXIS)
    init_in = (f_specs, g_specs_tree, P(), gamma_spec) + (P(),) * (
        1 + extra_init_scalars
    )

    def init_body(F, g, x0, gamma, *rest):
        return init_local(F, g, x0, gamma, *rest, cfg)

    init_sm = jax.shard_map(
        init_body, mesh=mesh, in_specs=init_in, out_specs=st_specs,
        check_vma=False,
    )
    init_fn = jax.jit(init_sm)

    def step_body(F, g, state):
        return step_local(F, g, cfg, state)

    step_sm = jax.shard_map(
        step_body, mesh=mesh, in_specs=(f_specs, g_specs_tree, st_specs),
        out_specs=st_specs, check_vma=False,
    )
    step_fn = jax.jit(step_sm)

    def run_body(F, g, state, steps):
        def body(s, _):
            with jax.named_scope(f"dp_{family}_step"):
                return step_local(F, g, cfg, s), None

        return jax.lax.scan(body, state, None, length=steps)[0]

    def make_run(steps):
        sm = jax.shard_map(
            functools.partial(run_body, steps=steps), mesh=mesh,
            in_specs=(f_specs, g_specs_tree, st_specs), out_specs=st_specs,
            check_vma=False,
        )
        return sm

    run_fn = jax.jit(
        lambda F, g, state, steps: make_run(steps)(F, g, state),
        static_argnames=("steps",),
    )

    def rebase_body(F, g, state):
        return rebase_local(F, g, cfg, state)

    rebase_sm = jax.shard_map(
        rebase_body, mesh=mesh, in_specs=(f_specs, g_specs_tree, st_specs),
        out_specs=st_specs, check_vma=False,
    )
    rebase_fn = jax.jit(rebase_sm)
    return init_fn, step_fn, run_fn, rebase_fn


def build_dp_functions(family: str, mesh, F, g, cfg: DPCfg,
                       extra_init_scalars: int = 0):
    f_specs = data_specs(F, cfg.N)
    leaves, f_treedef = jax.tree_util.tree_flatten(f_specs)
    g_treedef = jax.tree_util.tree_structure(g)
    return _compiled(
        family, mesh, f_treedef, tuple(leaves), g_treedef, cfg,
        extra_init_scalars,
    )


# ---------------------------------------------------------------------------
# facades
# ---------------------------------------------------------------------------

def _validate_mesh_batch(N, mesh, batch, sweeping, who):
    D = mesh.shape[DATA_AXIS]
    if N % D != 0:
        raise ValueError(
            f"{who}: N={N} must divide evenly over the {D}-device data axis "
            f"(pad the problem or pick a different mesh)"
        )
    if batch % D != 0:
        raise ValueError(f"{who}: global batch={batch} must be divisible by D={D}")
    b_loc = batch // D
    n_loc = N // D
    if sweeping in (Sweep.CYCLIC, Sweep.SHUFFLED) and n_loc % b_loc != 0:
        raise ValueError(
            f"{who}: cyclic/shuffled sweeps need N/D={n_loc} divisible by "
            f"the per-device batch {b_loc}"
        )
    if sweeping == Sweep.RANDOM and b_loc > n_loc:
        raise ValueError(f"{who}: per-device batch {b_loc} exceeds local block {n_loc}")
    return D, b_loc


@dataclasses.dataclass(frozen=True)
class DPFinito:
    """Data-parallel Finito/MISO (basic or LFinito) over a device mesh.

    Same knobs as :class:`ciao_tpu.solvers.Finito` where they apply;
    ``batch`` is the GLOBAL minibatch (split evenly across the data
    axis).

    ``adaptive=True`` runs the backtracking variant (reference
    ``Finito_adaptive.jl``) with the three N-tables sharded: the
    per-step single index is global (reference parity — no minibatch),
    its owner broadcasts the row state in one stacked psum, and the
    backtracking loop runs lockstep on every device with one scalar
    psum per backtrack iteration (SURVEY.md §7 flags this as the
    hardest variant to distribute; the win is sharded table MEMORY and
    a sharded init probe, not step throughput).

    ``local_steps > 1`` selects the LOCAL-UPDATE mode (beyond the
    reference — the multi-chip throughput path): each device runs that
    many purely-local coefficient-Finito steps per round and only the
    round boundary pays a
    collective — an av resync via delta psum, then one replicated
    prox (see ``_finito_coeff_local_round``). ``maxit`` then counts
    ROUNDS. Requires coefficient mode (rank-1 oracle, cyclic/shuffled
    sweeping, non-LFinito). Every ``rebase_every`` rounds the resync
    recomputes av EXACTLY from the tables (one full local pass) —
    required in f32, where delta-resync rounding otherwise accumulates
    without a restoring force (``_round_boundary_av``).

    ``local_sweep=True`` (LFinito only) is the epoch-granular analog:
    each device sweeps ONLY its own blocks against a private av copy
    and the epoch pays TWO collectives (anchor-refresh psum + delta
    resync) instead of one per block (see ``_lfinito_local_epoch``). No
    rebase knob: LFinito's anchor refresh re-derives av exactly from
    z_full every epoch, so resync rounding cannot accumulate."""

    mesh: object = None
    gamma: Optional[object] = None
    sweeping: int = 1
    LFinito: bool = False
    adaptive: bool = False
    batch: int = 0          # 0 -> one index per device
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    tol_b: float = 1e-9
    table: str = "auto"  # "full" (N,n) | "coeff" (N,) | "auto" (coeff if rank-1)
    local_steps: int = 1
    rebase_every: int = 50  # local rounds between exact av recomputes
    local_sweep: bool = False  # LFinito: local epoch sweeps (2 collectives)
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        if self.adaptive:
            return self._setup_adaptive(mesh, x0, F, g, N, rdt)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping, "DPFinito")
        gamma = resolve_gamma_array(self.gamma, L, N, self.alpha, rdt)
        coeff_ok = (
            not self.LFinito
            and self.sweeping != Sweep.RANDOM
            and getattr(F, "supports_coeff", False)
        )
        if self.table == "coeff" and not coeff_ok:
            raise ValueError(
                "DPFinito table='coeff' needs a rank-1 oracle, cyclic/"
                "shuffled sweeping and the basic (non-LFinito) variant"
            )
        coeff = self.table in ("auto", "coeff") and coeff_ok
        if self.local_steps > 1 and not coeff:
            raise ValueError(
                "DPFinito local_steps > 1 needs coefficient mode: a "
                "rank-1 oracle, cyclic/shuffled sweeping and the "
                "basic (non-LFinito) variant"
            )
        local = False
        if self.local_sweep:
            if not self.LFinito:
                raise ValueError(
                    "DPFinito local_sweep=True is the LFinito epoch mode "
                    "(set LFinito=True); the basic variant's local mode "
                    "is local_steps > 1"
                )
            if (N // D) % b_loc != 0:
                raise ValueError(
                    "DPFinito local_sweep needs N/D divisible by batch/D"
                )
            local = True
        cfg = DPCfg(
            N=N, D=D, b_loc=b_loc, sweeping=self.sweeping,
            alpha=float(self.alpha), coeff=coeff,
            local_steps=self.local_steps,
            rebase_every=self.rebase_every if self.local_steps > 1 else 0,
            local=local,
            variant="lfinito" if self.LFinito else "basic",
        )
        if self.LFinito:
            family = "lfinito"
        else:
            family = "finito_coeff" if coeff else "finito"
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            family, mesh, F, g, cfg
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: init_c(F, g, x0, gamma, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, n: run_c(F, g, s, n)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def _setup_adaptive(self, mesh, x0, F, g, N, rdt):
        """Adaptive (backtracking) variant over the mesh: stepsizes come
        from the sharded finite-difference probe, γ/L inputs are unused
        (reference parity), and the step is single-GLOBAL-index."""
        if self.LFinito or self.local_steps > 1 or self.local_sweep:
            raise ValueError(
                "DPFinito adaptive=True is exclusive with LFinito/"
                "local_steps/local_sweep (reference Finito.jl:80-116)"
            )
        if self.batch not in (0, 1):
            raise ValueError(
                "DPFinito adaptive=True is single-index (the reference "
                "adaptive variant has no minibatch, Finito_adaptive.jl:162)"
            )
        D = mesh.shape[DATA_AXIS]
        if N % D != 0:
            raise ValueError(
                f"DPFinito: N={N} must divide evenly over the {D}-device "
                f"data axis"
            )
        cfg = DPCfg(
            N=N, D=D, b_loc=1, sweeping=self.sweeping,
            alpha=float(self.alpha), tol_b=float(self.tol_b),
            variant="adaptive",
        )
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "finito_adaptive", mesh, F, g, cfg
        )
        key = jax.random.PRNGKey(self.seed)
        gamma_dummy = jnp.zeros((N,), rdt)
        init = lambda: init_c(F, g, x0, gamma_dummy, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, n: run_c(F, g, s, n)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.hat_gamma):.3e}")
        state, it = run_solver_loop(init, run, self.maxit, self.verbose, self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        # adaptive Finito is the only DP family that can abort
        # (γ-underflow); it must keep the per-step status readback so
        # the stream terminates (base.SolverIterable skips the check —
        # a device sync per iterate — for every other family)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase,
                              can_abort=self.adaptive)


@dataclasses.dataclass(frozen=True)
class DPSAGA:
    """Data-parallel minibatch SAGA/SAG over a device mesh.

    ``local_steps > 1`` selects the LOCAL-UPDATE mode (beyond the
    reference — the multi-chip throughput path): each device runs that
    many purely-local coefficient-SAGA steps per round, and only the
    round boundary pays a
    collective (exact table-mean resync + iterate averaging; see
    ``_saga_local_round``). ``maxit`` then counts ROUNDS, and the
    iterator yields the synced state once per round. Requires
    ``block_sampling`` and a rank-1 (coefficient) oracle."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    SAG_flag: bool = False
    block_sampling: bool = False  # contiguous-block minibatches (slices)
    table: str = "auto"  # "full" (N,n) | "coeff" (N,) | "auto" (coeff if rank-1)
    local_steps: int = 1
    rebase_every: int = 50  # local rounds between exact av recomputes
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM, "DPSAGA")
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError("DPSAGA: provide L or γ")
            L_max = jnp.max(jnp.asarray(L, rdt))
            gamma = 1.0 / ((16.0 if self.SAG_flag else 3.0) * L_max)
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError("DPSAGA block_sampling needs N/D divisible by batch/D")
        coeff = (
            getattr(F, "supports_coeff", False) and self.block_sampling
            if self.table == "auto"
            else self.table == "coeff"
        )
        if coeff and not self.block_sampling:
            raise ValueError("DPSAGA table='coeff' requires block_sampling")
        if self.local_steps > 1 and not (coeff and self.block_sampling):
            raise ValueError(
                "DPSAGA local_steps > 1 needs block_sampling and a "
                "rank-1 (coefficient) oracle"
            )
        cfg = DPCfg(
            N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM, alpha=0.999,
            sag=self.SAG_flag, block=self.block_sampling, coeff=coeff,
            local_steps=self.local_steps,
            rebase_every=self.rebase_every if self.local_steps > 1 else 0,
        )
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "saga", mesh, F, g, cfg
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: init_c(F, g, x0, gamma, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, n: run_c(F, g, s, n)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(init, run, self.maxit, self.verbose, self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPSAG(**kwargs):
    return DPSAGA(SAG_flag=True, **kwargs)


@dataclasses.dataclass(frozen=True)
class DPSVRG:
    """Data-parallel SVRG/SVRG++: psum'd full-gradient anchors, pmean'd
    variance-reduced inner directions (global inner batch = D·b_loc).

    ``local_inner=True`` selects the LOCAL-INNER mode (beyond the
    reference — the multi-chip throughput path): the whole m-step inner
    loop runs purely on each device's own index block and only the
    outer boundary pays collectives (iterate-average psum + anchor
    psum; ``plus=True`` adds a third, the warm-start w average) — two
    per outer step instead of one per inner step (see
    ``_svrg_local_outer``)."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    m: Optional[int] = None
    plus: bool = False
    local_inner: bool = False
    block_sampling: bool = False  # contiguous local inner blocks (slices)
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM, "DPSVRG")
        if self.gamma is None:
            if L is None:
                raise ValueError("DPSVRG: provide L or γ")
            gamma = 1.0 / (10.0 * jnp.max(jnp.asarray(L, rdt)))
        else:
            gamma = jnp.asarray(self.gamma, rdt)
        m = (N if self.m is None else self.m)
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPSVRG block_sampling needs N/D divisible by batch/D"
            )
        # inner batch scales the step count: m counts INNER BATCHES here
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, plus=self.plus,
                    block=self.block_sampling, local=self.local_inner)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "svrg", mesh, F, g, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: init_c(F, g, x0, gamma, jnp.asarray(m, jnp.int32), key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, n: run_c(F, g, s, n)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def _effective_maxit(self):
        return min(self.maxit, 25) if self.plus else self.maxit

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(
            init, run, self._effective_maxit(), self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPProshi:
    """Data-parallel ProShI: block variables x_i sharded by i; the
    coupling Σ s_i is a psum and z replicates back — the sharing
    problem's all-reduce/broadcast pattern on ICI.

    ``local_steps > 1`` selects the LOCAL-UPDATE mode (beyond the
    reference): each device runs that many contiguous-block updates
    against a stale, locally-maintained coupling and only the round
    boundary pays the collective (exact Σ s_i resync; see
    ``_proshi_local_round``). ``maxit`` then counts ROUNDS. Every
    ``rebase_every`` rounds the resync recomputes av = Σ s_i exactly
    from the table shards (f32 delta-drift control, as in the
    SAGA/Finito rounds)."""

    mesh: object = None
    gamma: Optional[object] = None
    sweeping: int = 1
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    local_steps: int = 1
    rebase_every: int = 50  # local rounds between exact av recomputes
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping, "DPProshi")
        gamma = resolve_gamma_array(self.gamma, L, N, self.alpha, rdt, who="DPProshi")
        if self.local_steps > 1 and (N // D) % b_loc != 0:
            # the local round samples contiguous blocks ONLY (random
            # sweeping draws block starts, not indices) — a non-dividing
            # batch would silently never touch each shard's tail rows
            raise ValueError(
                "DPProshi local_steps > 1 needs N/D divisible by batch/D"
            )
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=self.sweeping,
                    alpha=float(self.alpha),
                    local_steps=self.local_steps,
                    rebase_every=self.rebase_every if self.local_steps > 1
                    else 0)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "proshi", mesh, F, g, cfg
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: init_c(F, g, x0, gamma, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, n: run_c(F, g, s, n)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.hat_gamma):.3e}")
        state, it = run_solver_loop(init, run, self.maxit, self.verbose, self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPKatyusha:
    """Data-parallel Katyusha (beyond the reference — accelerated
    variance reduction; see :class:`ciao_tpu.solvers.Katyusha`).

    Default (lockstep): each inner step draws one block per device and
    pmeans the variance-reduced direction (global inner batch
    batch = D·b_loc, one x-sized psum per inner step).
    ``local_inner=True`` runs the whole m-step inner loop on-shard and
    pays two collectives per outer step (stacked sequence average +
    anchor refresh). ``m`` counts inner BATCHES per outer iterate and
    defaults to 2N/batch; ``maxit`` counts outer iterates."""

    mesh: object = None
    batch: int = 0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    tau1: Optional[float] = None
    tau2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False
    local_inner: bool = False
    seed: int = 0

    def __post_init__(self):
        # same validity envelope as the single-chip Katyusha facade:
        # the inner coupling x = τ₁z + τ₂x̃ + (1−τ₁−τ₂)y must stay a
        # convex combination
        assert self.maxit > 0 and self.freq > 0
        assert 0.0 < self.tau2 < 1.0
        if self.tau1 is not None:
            assert 0.0 < self.tau1 <= 1.0 - self.tau2

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        if L is None:
            raise ValueError("DPKatyusha: provide the smoothness moduli L")
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPKatyusha")
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPKatyusha block_sampling needs N/D divisible by batch/D"
            )
        Lmax = jnp.max(jnp.asarray(L, rdt))
        m = (2 * N) // batch if self.m is None else self.m
        if m < 1:
            raise ValueError("DPKatyusha: m must be >= 1")
        ns = False
        if self.tau1 is not None:
            tau1 = jnp.asarray(self.tau1, rdt)
        elif self.sigma is not None:
            tau1 = jnp.minimum(
                jnp.sqrt(m * batch * jnp.asarray(self.sigma, rdt)
                         / (3.0 * Lmax)),
                jnp.asarray(0.5, rdt),
            )
        else:
            ns = True
            tau1 = jnp.asarray(0.5, rdt)
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling,
                    local=self.local_inner, m_inner=m,
                    variant="ns" if ns else "sc")
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "katyusha", mesh, F, g, cfg, extra_init_scalars=2
        )
        key = jax.random.PRNGKey(self.seed)
        tau2 = jnp.asarray(self.tau2, rdt)
        init = lambda: init_c(F, g, x0, Lmax, tau1, tau2, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.tau1):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPLSVRG:
    """Data-parallel loopless SVRG (beyond the reference; see
    :class:`ciao_tpu.solvers.LSVRG`).

    Every step each device draws a block from its own shard and the
    variance-reduced direction is pmean'd (global batch D·b_loc). The
    anchor-refresh coin is replicated (same (key, it) stream on every
    device) and the refresh partial sum rides the direction's stacked
    psum — one collective per step, refresh or not. ``p`` defaults to
    batch/N (one expected full pass per epoch of global samples);
    ``maxit`` counts steps."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    block_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0
        assert self.p is None or 0.0 <= self.p <= 1.0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPLSVRG")
        if self.gamma is None:
            if L is None:
                raise ValueError("DPLSVRG: provide L or γ")
            gamma = 1.0 / (6.0 * jnp.max(jnp.asarray(L, rdt)))
        else:
            gamma = jnp.asarray(self.gamma, rdt)
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPLSVRG block_sampling needs N/D divisible by batch/D"
            )
        p = batch / N if self.p is None else self.p
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "lsvrg", mesh, F, g, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(self.seed)
        p = jnp.asarray(p, jnp.float32)
        init = lambda: init_c(F, g, x0, gamma, p, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPLKatyusha:
    """Data-parallel loopless Katyusha (beyond the reference; see
    :class:`ciao_tpu.solvers.LKatyusha`). Same collective shape as
    :class:`DPLSVRG`: a replicated coin, the refresh partial riding
    the direction's stacked psum — one collective per step."""

    mesh: object = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    theta1: Optional[float] = None
    theta2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        assert self.maxit > 0 and self.freq > 0
        assert 0.0 < self.theta2 < 1.0
        assert self.p is None or 0.0 <= self.p <= 1.0
        if self.theta1 is not None:
            assert 0.0 < self.theta1 <= 1.0 - self.theta2

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        if L is None:
            raise ValueError("DPLKatyusha: provide the smoothness moduli L")
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPLKatyusha")
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPLKatyusha block_sampling needs N/D divisible by batch/D"
            )
        Lmax = jnp.max(jnp.asarray(L, rdt))
        sigma = jnp.asarray(0.0 if self.sigma is None else self.sigma, rdt)
        if self.theta1 is not None:
            theta1 = jnp.asarray(self.theta1, rdt)
        elif self.sigma is not None:
            theta1 = jnp.minimum(
                jnp.sqrt(2.0 * sigma * N / (3.0 * batch)),
                jnp.asarray(0.5, rdt),
            )
        else:
            theta1 = jnp.asarray(1.0 / 3.0, rdt)
        p = batch / N if self.p is None else self.p
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "lkatyusha", mesh, F, g, cfg, extra_init_scalars=4
        )
        key = jax.random.PRNGKey(self.seed)
        p = jnp.asarray(p, jnp.float32)
        theta2 = jnp.asarray(self.theta2, rdt)
        init = lambda: init_c(F, g, x0, Lmax, sigma, theta1, theta2, p, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.theta1):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPSARAH:
    """Data-parallel SARAH/ProxSARAH (beyond the reference — recursive
    variance reduction; see :class:`ciao_tpu.solvers.SARAH`).

    Default (lockstep): each inner step draws one block per device and
    pmeans the estimator innovation (global inner batch batch = D·b_loc,
    one x-sized psum per inner step). ``local_inner=True`` runs each
    device's recursive chain on-shard from the shared full-gradient
    bootstrap and pays two collectives per outer step (final-iterate
    average + the next bootstrap psum). ``m`` counts inner steps per
    outer iterate and defaults to N // batch; ``maxit`` counts outer
    iterates."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    eta: float = 1.0
    block_sampling: bool = False
    local_inner: bool = False
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0
        assert 0.0 < self.eta <= 1.0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPSARAH")
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPSARAH block_sampling needs N/D divisible by batch/D"
            )
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "DPSARAH: provide the smoothness moduli L, or a "
                    "stepsize γ"
                )
            gamma = 1.0 / (2.0 * jnp.max(jnp.asarray(L, rdt)))
        m = N // batch if self.m is None else self.m
        if m < 1:
            raise ValueError("DPSARAH: m must be >= 1")
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling,
                    local=self.local_inner, m_inner=m)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "sarah", mesh, F, g, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(self.seed)
        eta = jnp.asarray(self.eta, rdt)
        init = lambda: init_c(F, g, x0, gamma, eta, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPForwardBackward:
    """Data-parallel ISTA/FISTA (beyond the reference — the
    deterministic full-gradient baseline; see :class:`ciao_tpu.solvers.
    ForwardBackward`). Each step is one local streaming pass over the
    device's row shard + ONE x-sized psum; ``fast=True`` is FISTA."""

    mesh: object = None
    gamma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    fast: bool = False
    polish_chunk: int = 0   # >0: compensated chunked local gradient
    # (solvers.polish) — accuracy below the f32 reduction floor

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0
        assert self.polish_chunk >= 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        D = mesh.shape[DATA_AXIS]
        if N % D != 0:
            raise ValueError(
                f"DPForwardBackward: N={N} must divide evenly over the "
                f"{D}-device data axis"
            )
        if self.polish_chunk:
            if (N // D) % self.polish_chunk:
                raise ValueError(
                    f"DPForwardBackward: polish_chunk="
                    f"{self.polish_chunk} must divide the per-device "
                    f"shard N/D={N // D}"
                )
            if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
                raise ValueError(
                    "DPForwardBackward: polish_chunk needs f32/bf16 "
                    "rows (rebase off int8 storage first)"
                )
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "DPForwardBackward: provide the smoothness moduli L, "
                    "or a stepsize γ"
                )
            gamma = 1.0 / jnp.mean(jnp.asarray(L, rdt))
        cfg = DPCfg(N=N, D=D, b_loc=1, sweeping=Sweep.RANDOM, alpha=0.999,
                    variant="fista" if self.fast else "ista",
                    polish_chunk=self.polish_chunk)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "fb", mesh, F, g, cfg
        )
        key = jax.random.PRNGKey(0)
        init = lambda: init_c(F, g, x0, gamma, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPFISTA(**kwargs) -> DPForwardBackward:
    """``DPForwardBackward(fast=True)``."""
    return DPForwardBackward(fast=True, **kwargs)


@dataclasses.dataclass(frozen=True)
class DPDavisYin:
    """Data-parallel Davis-Yin three-operator splitting (beyond the
    reference — see :class:`ciao_tpu.solvers.DavisYin`): minimize
    (1/N)Σf_i + g + h with both g and h proximable. Each step is one
    local streaming pass over the device's row shard + ONE x-sized
    psum; the two proxes replicate, so the trajectory equals the
    single-chip solver to reduction order. ``DPDouglasRachford`` is the
    f = 0 case (pass no F/L)."""

    mesh: object = None
    gamma: Optional[float] = None
    lam: float = 1.0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert 0 < self.lam < 2
        assert self.maxit > 0 and self.freq > 0

    def _setup(self, x0, F, g, h, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        from ciao_tpu.oracles import ZeroOracle

        if N is None:
            if F is None:
                raise ValueError("DPDavisYin: provide F or N")
            N = F.num_terms
        if F is None:
            F = ZeroOracle(n_terms=N)
        if g is None:
            g = Zero()
        if h is None:
            h = Zero()
        rdt = real_dtype_of(x0)
        D = mesh.shape[DATA_AXIS]
        if N % D != 0:
            raise ValueError(
                f"DPDavisYin: N={N} must divide evenly over the "
                f"{D}-device data axis"
            )
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        elif L is not None:
            gamma = 1.0 / jnp.mean(jnp.asarray(L, rdt))
        elif isinstance(F, ZeroOracle):
            gamma = jnp.ones((), rdt)  # f = 0: Douglas-Rachford
        else:
            raise ValueError(
                "DPDavisYin: provide the smoothness moduli L, or a "
                "stepsize γ"
            )
        lam = jnp.asarray(self.lam, rdt)
        gh = (g, h)
        cfg = DPCfg(N=N, D=D, b_loc=1, sweeping=Sweep.RANDOM, alpha=0.999)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "dys", mesh, F, gh, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(0)
        init = lambda: init_c(F, gh, x0, gamma, lam, key)
        step = lambda s: step_c(F, gh, s)
        run = lambda s, k: run_c(F, gh, s, k)
        rebase = lambda s: rebase_c(F, gh, s)
        return x0, F, gh, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, h=None, L=None, N=None,
                 observe=None):
        x0, F, gh, init, step, run, _ = self._setup(x0, F, g, h, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, L=None, N=None):
        x0_orig = x0
        x0, F, gh, init, step, run, rebase = self._setup(x0, F, g, h, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPDouglasRachford(**kwargs) -> DPDavisYin:
    """``DPDavisYin`` with f = 0 (Douglas-Rachford over the mesh —
    useful when g/h carry per-coordinate parameter vectors you want
    resident with the replicated iterate)."""
    return DPDavisYin(**kwargs)


@dataclasses.dataclass(frozen=True)
class DPCondatVu:
    """Data-parallel Condat-Vũ primal-dual splitting (beyond the
    reference — see :class:`ciao_tpu.solvers.CondatVu`): minimize
    (1/N)Σf_i + g(x) + h(Kx) with g, h proximable and K a linear map
    (:mod:`ciao_tpu.ops.linmap`). Each step is one local streaming pass
    over the device's row shard + ONE x-sized psum; K's matvec/rmatvec,
    the two proxes and the dual update replicate, so the trajectory
    equals the single-chip solver to reduction order.
    ``DPChambollePock`` is the f = 0 case (pass no F/L)."""

    mesh: object = None
    tau: Optional[float] = None
    sigma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    polish_chunk: int = 0   # >0: compensated chunked local gradient

    def __post_init__(self):
        assert self.tau is None or self.tau > 0
        assert self.sigma is None or self.sigma > 0
        assert self.maxit > 0 and self.freq > 0
        assert self.polish_chunk >= 0

    def _setup(self, x0, F, g, h, K, L, N):
        from ciao_tpu.ops.linmap import IdentityMap
        from ciao_tpu.oracles import ZeroOracle
        from ciao_tpu.solvers.primal_dual import CondatVu as _CV

        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            if F is None:
                raise ValueError("DPCondatVu: provide F or N")
            N = F.num_terms
        if F is None:
            F = ZeroOracle(n_terms=N)
        if g is None:
            g = Zero()
        if h is None:
            h = Zero()
        if K is None:
            K = IdentityMap()
        rdt = real_dtype_of(x0)
        D = mesh.shape[DATA_AXIS]
        if N % D != 0:
            raise ValueError(
                f"DPCondatVu: N={N} must divide evenly over the "
                f"{D}-device data axis"
            )
        if L is not None:
            Lf = float(jnp.mean(jnp.asarray(L, rdt)))
        elif isinstance(F, ZeroOracle):
            Lf = 0.0  # Chambolle-Pock: στ‖K‖² ≤ 1
        elif self.tau is not None:
            Lf = 0.0  # user owns the condition via explicit τ
        else:
            raise ValueError(
                "DPCondatVu: provide the smoothness moduli L, or an "
                "explicit stepsize τ"
            )
        # the single-chip stepsize policy verbatim (trajectory parity)
        cv = _CV(tau=self.tau, sigma=self.sigma)
        tau, sigma = cv._stepsizes(Lf, float(K.opnorm_bound(x0.shape[0])),
                                   rdt)
        ghk = (g, h, K)
        if self.polish_chunk:
            if isinstance(F, ZeroOracle):
                raise ValueError(
                    "DPCondatVu: polish_chunk compensates the finite-"
                    "sum gradient — there is none with F omitted")
            if (N // D) % self.polish_chunk:
                raise ValueError(
                    f"DPCondatVu: polish_chunk={self.polish_chunk} "
                    f"must divide the per-device shard N/D={N // D}")
            if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
                raise ValueError(
                    "DPCondatVu: polish_chunk needs f32/bf16 rows")
        cfg = DPCfg(N=N, D=D, b_loc=1, sweeping=Sweep.RANDOM, alpha=0.999,
                    polish_chunk=self.polish_chunk)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "pd", mesh, F, ghk, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(0)
        init = lambda: init_c(F, ghk, x0, tau, sigma, key)
        step = lambda s: step_c(F, ghk, s)
        run = lambda s, k: run_c(F, ghk, s, k)
        rebase = lambda s: rebase_c(F, ghk, s)
        return x0, F, ghk, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, h=None, K=None, L=None, N=None,
                 observe=None):
        x0, F, ghk, init, step, run, _ = self._setup(x0, F, g, h, K, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.tau):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, K=None, L=None, N=None):
        x0_orig = x0
        x0, F, ghk, init, step, run, rebase = self._setup(
            x0, F, g, h, K, L, N
        )
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPChambollePock(**kwargs) -> DPCondatVu:
    """``DPCondatVu`` with f = 0 (Chambolle-Pock over the mesh):
    minimize g(x) + h(Kx), both proximable."""
    return DPCondatVu(**kwargs)


@dataclasses.dataclass(frozen=True)
class DPPANOC:
    """Data-parallel PANOC/ZeroFPR (beyond the reference — see
    :class:`ciao_tpu.solvers.PANOC`). Each FBE evaluation is one local
    streaming pass over the device's row shard + one scalar and one
    x-sized psum; the L-BFGS direction and line search replicate, so
    the trajectory EQUALS the single-chip solver to reduction order."""

    mesh: object = None
    gamma: Optional[float] = None
    alpha: float = 0.95
    beta: float = 0.5
    maxit: int = 100
    mem: int = 5
    max_ls: int = 10
    verbose: bool = False
    freq: int = 10
    zerofpr: bool = False
    adaptive: bool = False  # γ-backtracking (auto when no γ and no L)

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert 0 < self.alpha < 1 and 0 < self.beta < 1
        assert self.maxit > 0 and self.freq > 0
        assert self.mem >= 1 and self.max_ls >= 1

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        rdt = real_dtype_of(x0)
        D = mesh.shape[DATA_AXIS]
        if N % D != 0:
            raise ValueError(
                f"DPPANOC: N={N} must divide evenly over the "
                f"{D}-device data axis"
            )
        adaptive = self.adaptive or (self.gamma is None and L is None)
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
            if L is not None:
                Lf = jnp.mean(jnp.asarray(L, rdt))
                sigma = self.beta * jnp.maximum(1.0 - gamma * Lf, 0.05) \
                    / (2.0 * gamma)
            else:
                sigma = self.beta * (1.0 - self.alpha) / (2.0 * gamma)
        elif L is not None:
            Lf = jnp.mean(jnp.asarray(L, rdt))
            gamma = self.alpha / Lf
            sigma = self.beta * (1.0 - self.alpha) / (2.0 * gamma)
        else:
            # adaptive bootstrap: eager finite-difference probe (the
            # sharded oracle's grad_sum_all auto-partitions under GSPMD)
            from ciao_tpu.solvers.panoc import _probe_gamma

            gamma = _probe_gamma(F, x0, N, self.alpha, rdt)
            sigma = self.beta * (1.0 - self.alpha) / (2.0 * gamma)
        cfg = DPCfg(N=N, D=D, b_loc=1, sweeping=Sweep.RANDOM, alpha=0.999,
                    m_inner=self.mem, max_ls=self.max_ls,
                    adaptive=adaptive,
                    variant="zerofpr" if self.zerofpr else "panoc")
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "panoc", mesh, F, g, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(0)
        sigma = jnp.asarray(sigma, rdt)
        init = lambda: init_c(F, g, x0, gamma, sigma, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(
            f"{it:5d} | {float(st.gamma):.3e} | τ={float(st.tau):.3f}"
        )
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        from ciao_tpu.solvers.panoc import warn_if_thrashing

        warn_if_thrashing(state, type(self).__name__)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPZeroFPR(**kwargs) -> DPPANOC:
    """``DPPANOC(zerofpr=True)``."""
    return DPPANOC(zerofpr=True, **kwargs)


@dataclasses.dataclass(frozen=True)
class DPPointSAGA:
    """Data-parallel Point-SAGA (beyond the reference — proximal-point
    incremental solver; see :class:`ciao_tpu.solvers.PointSAGA`). The
    (N,) prox-coefficient table shards by index block; each step every
    device proxes one contiguous block of its own rows (global batch
    = D·b_loc) and the only cross-device traffic is one x-sized psum.
    Solves min (1/N)Σf_i — no separate composite g (the method's
    scope); requires a ``supports_pointprox`` oracle."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    sweeping: int = 1
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is not None and not isinstance(g, Zero):
            raise ValueError(
                "DPPointSAGA solves min (1/N)Σ f_i(x) — no separate "
                "composite g (see PointSAGA)"
            )
        g = Zero()
        if not getattr(F, "supports_pointprox", False):
            raise ValueError(
                "DPPointSAGA needs a scalar-loss row oracle with the "
                f"pointprox protocol; {type(F).__name__} does not "
                "support it"
            )
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping,
                                        "DPPointSAGA")
        if (N // D) % b_loc != 0:
            raise ValueError(
                "DPPointSAGA: per-device block batch/D must divide N/D"
            )
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "DPPointSAGA: provide the smoothness moduli L, or a "
                    "stepsize γ"
                )
            gamma = 1.0 / (3.0 * jnp.max(jnp.asarray(L, rdt)))
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=self.sweeping,
                    alpha=0.999)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "point_saga", mesh, F, g, cfg
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: init_c(F, g, x0, gamma, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class DPSSNM:
    """Data-parallel SSNM (sampled-negative-momentum SAGA — beyond the
    reference; solvers.ssnm). Coefficient table AND the per-block
    stored-point table shard by index block; each device forms its own
    momentum point from its sampled block's stored point (every term is
    anchored at its own point, so the pmean'd direction stays
    unbiased); ONE x-sized psum per step. ``batch`` is the GLOBAL
    minibatch."""

    mesh: object = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    tau: Optional[float] = None
    sigma: Optional[float] = None
    eta: Optional[float] = None
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh = self.mesh if self.mesh is not None else make_mesh()
        x0 = jnp.asarray(x0)
        if N is None:
            N = F.num_terms
        if g is None:
            g = Zero()
        if not getattr(F, "supports_coeff", False):
            raise ValueError(
                "DPSSNM needs a rank-1 (coefficient) oracle; "
                f"{type(F).__name__} is not"
            )
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.shape[DATA_AXIS]
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPSSNM")
        if (N // D) % b_loc != 0:
            raise ValueError("DPSSNM: per-device batch must divide N/D")
        if L is None and (self.eta is None or self.tau is None):
            raise ValueError("DPSSNM: provide L, or both τ and η")
        Lmax = None if L is None else jnp.max(jnp.asarray(L, rdt))
        if self.tau is not None:
            tau = jnp.asarray(self.tau, rdt)
        elif self.sigma is not None:
            tau = jnp.minimum(
                jnp.sqrt(N * jnp.asarray(self.sigma, rdt) / (3.0 * Lmax)),
                jnp.asarray(0.5, rdt),
            )
        else:
            tau = jnp.asarray(0.5, rdt)
        eta = (jnp.asarray(self.eta, rdt) if self.eta is not None
               else 1.0 / (3.0 * tau * Lmax))  # the mirror coupling
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=True, coeff=True)
        init_c, step_c, run_c, rebase_c = build_dp_functions(
            "ssnm", mesh, F, g, cfg, extra_init_scalars=1
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: init_c(F, g, x0, tau, eta, key)
        step = lambda s: step_c(F, g, s)
        run = lambda s, k: run_c(F, g, s, k)
        rebase = lambda s: rebase_c(F, g, s)
        return x0, F, g, init, step, run, rebase

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.tau):.3e}")
        state, it = run_solver_loop(
            init, run, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)
