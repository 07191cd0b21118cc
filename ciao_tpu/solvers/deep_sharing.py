"""Deep accuracy for the SHARING formulation (VERDICT r4 #2).

``deep_solve`` covers the finite-sum class; this is the sharing
analog. The f32 floor mechanism is DIFFERENT here: ProShI maintains the
coupling sum ``av = Σ_i s_i`` incrementally (reference
``ProShI_basic.jl:113-123``), and a rounding drift δ in that running sum
displaces the fixed point so the realized coupling sum becomes
``prox_g(av_true + δ) − δ`` — the prox's exact off-support zeros are
destroyed and the sharing objective pays a FIRST-order λ‖δ‖₁. (The f32
block table itself is NOT the floor: at the optimum the objective is
stationary in the full (N·n) variable, so table-representation noise is
second-order, rel ~(eps)².)

The fix costs one table pass per chunk: run ProShI in chunks and
RESYNC the coupling sum exactly at every chunk boundary with a
compensated (two-sum) chunked reduction (:func:`proshi_resync` — the
``solvers/polish.py`` carry pattern applied to the (N, n) block table),
then refresh ``z``. The final resync restores the exact prox structure
of the returned solution. The DP path needs no new machinery — its
local-update mode already resyncs ``av`` exactly at every round
boundary (``parallel/dp.py``); this module is the single-chip schedule
plus plateau control.

Reference anchor: ``test/test_sharing.jl:31-32`` reaches 1e-4 with f64
for free; :func:`ciao_tpu.utils.problems.make_sharing_planted` supplies
the any-scale exact-optimum instance this is measured against
(tests/test_deep_sharing.py pins rel ≤ 1e-6 in f32).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass
class DeepSharingInfo:
    """What the deep sharing solve did."""

    objs: List[float]     # compensated sharing objective per chunk
    epochs: int           # block-epochs run
    resyncs: int          # exact coupling-sum resyncs performed


def deep_solve_sharing(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    gamma=None,
    sweeping: int = 2,
    batch: int = 1,
    chunk_epochs: int = 16,
    max_epochs: int = 4096,
    plateau_rtol: float = 1e-9,
    resync_chunk: int = 4096,
    seed: int = 0,
) -> Tuple[jnp.ndarray, DeepSharingInfo]:
    """Solve ``min (1/N) Σ f_i(x_i) + g(Σ x_i)`` to deep relative
    accuracy in f32: ProShI in ``chunk_epochs``-sized chunks with an
    EXACT compensated coupling-sum resync at every chunk boundary,
    stopping when the (compensated) sharing objective plateaus.

    Returns ``(blocks, info)`` — blocks is the (N, n) array of block
    solutions x_i = s_i + γ_i z materialized AFTER a final resync, so
    the returned coupling sum carries the prox's exact zero structure.

    Parameters mirror the :class:`Proshi` facade (``sweeping``,
    ``batch``, ``gamma``/``L``); ``resync_chunk`` is the chunk size of
    the compensated reductions (rounded down to a divisor of N)."""
    from ciao_tpu.solvers.proshi import (
        Proshi,
        proshi_resync,
        proshi_run,
        sharing_objective,
    )

    facade = Proshi(
        gamma=gamma, sweeping=sweeping,
        minibatch=(batch > 1, batch), seed=seed,
    )
    x0j, F, g, cfg, init = facade._setup(jnp.asarray(x0), F, g, L, N)
    state = init()
    d = cfg.N // cfg.batch
    steps = chunk_epochs * d

    objs = [float(sharing_objective(F, g, state, resync_chunk))]
    rounds = max(1, max_epochs // chunk_epochs)
    resyncs = 0
    epochs = 0
    for _ in range(rounds):
        state = proshi_run(F, g, state, cfg, steps)
        state = proshi_resync(g, state, resync_chunk)
        resyncs += 1
        epochs += chunk_epochs
        obj = float(sharing_objective(F, g, state, resync_chunk))
        objs.append(obj)
        prev = objs[-2]
        if abs(prev - obj) <= plateau_rtol * max(abs(obj), 1e-30):
            break
    return state.solution, DeepSharingInfo(
        objs=objs, epochs=epochs, resyncs=resyncs)
