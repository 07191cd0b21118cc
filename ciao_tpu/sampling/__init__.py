"""On-device index schedules.

Replaces the reference's host-global RNG sampling —
``sample(1:N, batch, replace=false)`` (Finito_basic.jl:97),
``randperm`` (Finito_basic.jl:102), ``rand(1:N)`` (SAGA_basic.jl:55) —
with explicit ``jax.random`` keys threaded through solver state:
deterministic, checkpoint-resumable, and foldable per host/shard.

Sweeping strategies (reference ``Finito.jl:153``):
  1 = uniformly random (without replacement within a minibatch)
  2 = cyclic over static contiguous blocks
  3 = shuffled block order, re-shuffled every epoch

Behavioral parity notes (SURVEY.md §2.1):
  * blocks are STATIC contiguous ranges of size ``batch`` with a ragged
    final block (Finito_basic.jl:50-58); `mask` flags the valid lanes.
  * in shuffled mode the FIRST epoch runs in natural (cyclic) order —
    the reference initializes ``inds = 1:d`` and only reshuffles once a
    full epoch has been consumed (Finito_basic.jl:100-107).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class Sweep(enum.IntEnum):
    RANDOM = 1
    CYCLIC = 2
    SHUFFLED = 3


class SweepState(NamedTuple):
    """Index-schedule carry; all fields are device scalars/arrays."""

    pos: jnp.ndarray       # 1-based position within the current epoch
    order: jnp.ndarray     # (d,) current block order (0-based block ids)
    key: jnp.ndarray       # PRNG key


def num_blocks(n: int, batch: int) -> int:
    return -(-n // batch)  # ceil


def init_sweep(key, n: int, batch: int, sweeping: int = Sweep.RANDOM) -> SweepState:
    d = num_blocks(n, batch)
    # cyclic carries the reference's 1-based ``idxr`` (init 1 →
    # first step lands on block 2, Finito_basic.jl:99 with init :44);
    # shuffled carries ``idx`` (init 0 → first epoch in natural order).
    pos0 = 1 if sweeping == Sweep.CYCLIC else 0
    return SweepState(
        pos=jnp.asarray(pos0, jnp.int32),
        order=jnp.arange(d, dtype=jnp.int32),
        key=key,
    )


def next_block_id(
    state: SweepState, n: int, batch: int, sweeping: int
) -> Tuple[jnp.ndarray, SweepState]:
    """Advance a cyclic/shuffled schedule one step, returning the
    0-based BLOCK id — the block paths consume ``block * batch`` as a
    dynamic-slice start (contiguous blocks avoid a row gather and
    scatter; see oracles.base block entry points)."""
    d = num_blocks(n, batch)
    if sweeping == Sweep.RANDOM:
        # stateless iid uniform block id: deterministic in (key, pos).
        # ``pos`` is a plain draw counter here (no epoch wrap).
        k = jax.random.fold_in(state.key, state.pos)
        j = jax.random.randint(k, (), 0, d, dtype=jnp.int32)
        return j, state._replace(pos=state.pos + 1)
    if sweeping == Sweep.CYCLIC:
        new_pos = state.pos % d + 1  # reference: idxr = mod(idxr, d) + 1
        return new_pos - 1, state._replace(pos=new_pos)

    if sweeping == Sweep.SHUFFLED:
        # reference semantics: when pos == d, draw a fresh permutation and
        # restart at position 1; otherwise advance (Finito_basic.jl:100-107).
        def reshuffle(op):
            order, pos, key = op
            key, sub = jax.random.split(key)
            return jax.random.permutation(sub, d).astype(jnp.int32), jnp.ones((), jnp.int32), key

        def advance(op):
            order, pos, key = op
            return order, pos + 1, key

        order, pos, key = jax.lax.cond(
            state.pos == d, reshuffle, advance, (state.order, state.pos, state.key)
        )
        return order[pos - 1], SweepState(pos=pos, order=order, key=key)

    raise ValueError(f"block schedules need sweeping 2 or 3; got {sweeping}")


def next_block(
    state: SweepState, n: int, batch: int, sweeping: int
) -> Tuple[jnp.ndarray, jnp.ndarray, SweepState]:
    """Advance the schedule one step.

    Returns ``(idx, mask, new_state)`` with ``idx`` an (batch,)-shaped
    int32 index vector and ``mask`` the valid-lane booleans.
    """
    if sweeping == Sweep.RANDOM:
        key, sub = jax.random.split(state.key)
        idx = jax.random.choice(sub, n, (batch,), replace=False).astype(jnp.int32)
        mask = jnp.ones((batch,), bool)
        return idx, mask, state._replace(key=key)

    block, new_state = next_block_id(state, n, batch, sweeping)
    idx = block * batch + jnp.arange(batch, dtype=jnp.int32)
    mask = idx < n
    idx = jnp.minimum(idx, n - 1)
    return idx, mask, new_state


def uniform_index(key, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single uniform index (SAGA/SVRG inner sampling, SAGA_basic.jl:55)."""
    key, sub = jax.random.split(key)
    return jax.random.randint(sub, (), 0, n, dtype=jnp.int32), key


def clip_block_distribution(q, K: int):
    """Water-fill-clip a block distribution so no block carries more
    than 1/K mass: the LARGEST c with q̃ ∝ min(q, c) satisfying
    max q̃ = c/Σmin(q, c) ≤ 1/K (clips as little as possible; at the
    solution Σmin(q, c) = K·c exactly, so every clipped block sits at
    exactly 1/K).

    The clipped q̃ is the classic TRUNCATED importance distribution:
    hot blocks cap at a 1/K share of the draws. Finito and Point-SAGA
    (fixed-point table methods, which need no reweighting) draw from it:
    an anchor refreshed far more often than the others gains little,
    and on a power-law L spread the raw q ∝ L starves the cold blocks.

    Host-side, float64 (f32 cumsums over many blocks skew the realized
    draws — see the facade's CDF note). Returns ``(q_tilde, clipped)``
    with ``q_tilde`` summing to 1 and ``clipped`` the number of blocks
    at the cap (0 = no clipping was needed).
    """
    q = np.asarray(q, np.float64)
    d = q.size
    K = min(K, d)
    Z0 = q.sum()
    if q.max() * K <= Z0:
        return q / Z0, 0
    qs = np.sort(q)[::-1]
    css = np.cumsum(qs)
    total = css[-1]
    for m in range(1, K):
        c = (total - css[m - 1]) / (K - m)
        lo = qs[m] if m < d else 0.0
        if lo <= c < qs[m - 1]:
            qt = np.minimum(q, c)
            return qt / qt.sum(), int(np.sum(q > c))
    # degenerate spectrum (q concentrated on < K blocks): uniform is
    # the only distribution with max mass ≤ 1/K ≤ 1/d... reachable only
    # when K == d, where stratification covers every block each window
    return np.full(d, 1.0 / d), d


SYSTEMATIC_WINDOW = 64


def systematic_schedule(L, N: int, B: int, dtype):
    """Host-side (f64) build of the systematic importance schedule that
    Finito and Point-SAGA draw from: block moduli L_j (max over each
    contiguous block of ``B``), q_j ∝ L_j truncated at a 1/K share
    (:func:`clip_block_distribution`, K = min(64, N/B)), and the
    π-scale CDF cumsum(K·q̃) with its last entry snapped to exactly K.
    Returns ``(pcum, q̃, L_blk)``; ``pcum`` in ``dtype``."""
    d = N // B
    K = min(SYSTEMATIC_WINDOW, d)
    Lb = np.asarray(jax.device_get(jnp.asarray(L)), np.float64)
    if Lb.ndim == 0:
        Lb = np.full((N,), Lb)
    Lblk = np.max(Lb.reshape(d, B), axis=1)
    q, _ = clip_block_distribution(Lblk / Lblk.sum(), K)
    pcum = np.cumsum(K * q)
    pcum *= K / pcum[-1]
    pcum[-1] = K
    return jnp.asarray(pcum, dtype), q, Lblk


def systematic_block(key, it, pcum, d: int):
    """Block index of step ``it`` under systematic probability-
    proportional-to-size sampling over windows of K = min(64, d) steps:
    window w = it // K draws ONE uniform U, and slot k = it % K takes
    the block whose interval of ``pcum`` (``systematic_schedule``)
    contains U + k. Every window visits distinct blocks, and block j is
    drawn at rate q̃_j per step; deterministic in (key, it)."""
    K = min(SYSTEMATIC_WINDOW, d)
    u = (it % K).astype(pcum.dtype) + jax.random.uniform(
        jax.random.fold_in(key, it // K), (), pcum.dtype)
    return jnp.minimum(
        jnp.searchsorted(pcum, u, side="right").astype(jnp.int32), d - 1
    )
