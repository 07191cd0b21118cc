"""``deep_solve`` — the deep-accuracy endgame as ONE public API.

The plan for deep targets (bench.py's ``deep_target_10m`` times it):

1. **Stochastic stage** — (optionally staged-precision) block SAGA via
   :func:`ciao_tpu.solvers.staged_saga`: delivers the f32 solver floor
   (rel ~√N·eps of the full-gradient reduction — NOT the iterate's
   resolution).
2. **Polish stage** — compensated-gradient monotone FISTA
   (:func:`ciao_tpu.solvers.fista_polish`): the same f32 rows streamed
   with two-sum chunk accumulation push the gradient noise ~3 orders
   below the monolithic f32 floor, closing rel ~4e-5 → 1e-6 and beyond
   in a handful of 2-pass epochs. The stepsize is automatic:
   η = ``eta_safety``/λ̂ with λ̂ from the GENERIC curvature power bound
   :func:`ciao_tpu.solvers.power_lmax` (margin-curvature weights via
   the oracle's ``hess_weight_from_margin`` — least-squares, logistic,
   Huber, squared-hinge globally; Poisson per trust region).

On the 10.49M×100 planted lasso every monolithic f32 solver floors at
rel ~4e-5; this plan reaches rel 1e-6 (chip_smoke.py's ``deep`` phase
checks it), where the reference (f64-on-CPU throughout,
``src/algorithms/Finito/Finito_basic.jl:14``) pays f64 for every row
read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ciao_tpu.solvers.polish import (
    fista_polish,
    power_lmax,
    power_lmax_quadratic,
    power_lmax_weighted,
)
from ciao_tpu.solvers.staged import StagedInfo, staged_saga


@dataclasses.dataclass
class DeepSolveInfo:
    """What the deep solve did."""

    staged: StagedInfo          # the stochastic stage's per-stage record
    lmax: float                 # curvature bound the polish step used
    eta: float                  # polish stepsize (= eta_safety / lmax)
    polish_steps: int           # FISTA steps actually run
    fp_res: List[float]         # fixed-point residual per polish round


def _largest_divisor_leq(N: int, c: int) -> int:
    c = min(c, N)
    while N % c:
        c -= 1
    return c


def deep_solve(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    storages: Sequence[str] = ("f32",),
    batch: int = 4096,
    chunk_epochs: int = 16,
    plateau_rtol: float = 1e-5,
    max_epochs: int = 4096,
    gamma: Optional[float] = None,
    importance_sampling: bool = False,
    polish_steps: int = 4,
    polish_max_rounds: int = 16,
    polish_chunk: int = 32_768,
    power_iters: int = 6,
    eta_safety: float = 0.9,
    margin_slack: float = 0.0,
    seed: int = 0,
    observe=None,
) -> Tuple[jnp.ndarray, DeepSolveInfo]:
    """Solve ``min (1/N) Σ f_i + g`` to DEEP relative accuracy (past the
    monolithic-f32 gradient floor): staged block SAGA to its plateau,
    then compensated-gradient FISTA polish with an automatic
    curvature-bound stepsize.

    ``F`` is a rank-1 coefficient oracle in f32 (or bf16) storage —
    dense rows preferred (the margin protocol ``coeff_from_margin`` +
    ``hess_weight_from_margin`` supplies the loss, so least-squares,
    logistic, Huber, squared-hinge and Poisson rows all work), and the
    SPARSE layouts (ELL / hybrid hot-cold) are served too for the
    quadratic family: the polish gradient runs through the block
    protocol and η through the exact two-pass quadratic power bound. For a
    staged-precision start pass e.g. ``storages=("int8", "f32")`` — the
    narrow stages are built with ``F.with_storage`` and the polish
    always runs on ``F`` itself. ``g`` needs ``prox_only`` (NormL1 /
    Zero / any separable prox). For Poisson pass ``margin_slack``
    (~0.5): its curvature weight is a trust-region bound around the
    stochastic stage's solution. ``importance_sampling=True`` runs the
    stochastic stage with Lipschitz-proportional draws — the right
    stage-1 knob for
    ill-conditioned data; the polish stage is sampling-free.

    The polish stops early when the fixed-point residual stalls
    (< 1.33× decrease over a round — the compensated-gradient floor).
    ``observe(z)``, if given, is called after every stochastic chunk
    and every polish round.

    Returns ``(x, DeepSolveInfo)``.

    Accuracy bar anchor: the reference is f64 end-to-end
    (``/root/reference/src/algorithms/Finito/Finito_basic.jl:14-20``,
    ``test/test_logistic_l1.jl:48-58``) — this API is how an f32 user
    gets the accuracy the reference's dtype gives for free.
    """
    if N is None:
        N = F.num_terms

    z, sinfo = staged_saga(
        x0, F, g, L, N,
        storages=storages, batch=batch, chunk_epochs=chunk_epochs,
        plateau_rtol=plateau_rtol, max_epochs=max_epochs, gamma=gamma,
        importance_sampling=importance_sampling, seed=seed,
        observe=observe,
    )

    from ciao_tpu.prox import Zero

    if g is None:
        g = Zero()

    key = jax.random.PRNGKey(seed + 1)
    block_protocol = not hasattr(F, "coeff_rows_data")
    if block_protocol:
        # SPARSE (ELL / hybrid) oracles: no dense stored rows — the
        # polish gradient runs through the block protocol and the
        # curvature bound through the margin-WEIGHTED two-pass power
        # iteration (round 5, VERDICT r4 #5): exact constant weights
        # for the least-squares family, pointwise trust-region
        # σ(t)(1−σ(t)) weights at the stage-1 anchor for sparse
        # logistic (pass ``margin_slack`` covering the polish's margin
        # motion; the weights sit far below the old global-1/4
        # quadratic-twin bound, so η roughly doubles and the default
        # FISTA leash suffices)
        mode = getattr(F, "coeff_mode", None)
        if mode == 0:
            lmax = float(power_lmax_quadratic(F, key, iters=power_iters))
        elif mode == 1:
            lmax = float(power_lmax_weighted(
                F, z, key, iters=power_iters, margin_slack=margin_slack))
        else:
            raise ValueError(
                "deep_solve: automatic polish stepsizes for oracles "
                "without dense rows cover the quadratic (least-"
                "squares) and logistic families — pass a dense-rows "
                "oracle or precompute η yourself via fista_polish"
            )
    else:
        lmax = float(power_lmax(F, z, key, iters=power_iters,
                                margin_slack=margin_slack))
    eta = jnp.asarray(eta_safety / lmax, jnp.float32)
    chunk = _largest_divisor_leq(N, polish_chunk)

    fp_hist: List[float] = []
    steps = 0
    for _ in range(polish_max_rounds):
        res = fista_polish(F, g, z, eta, polish_steps, chunk,
                           block_protocol=block_protocol)
        z = res.x
        steps += polish_steps
        fp = float(res.fp_res)
        fp_hist.append(fp)
        if observe is not None:
            observe(z)
        # stall = the compensated-gradient floor: the residual stops
        # contracting (FISTA on a κ≈1 basin contracts ≫1.33×/round)
        if fp == 0.0 or (len(fp_hist) >= 2
                         and fp > fp_hist[-2] / 1.33):
            break

    return z, DeepSolveInfo(staged=sinfo, lmax=lmax, eta=float(eta),
                            polish_steps=steps, fp_res=fp_hist)
