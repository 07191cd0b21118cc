"""Convergence monitoring / observability.

The reference computes NO convergence metric in its main path (stop ≡
false, ``Finito.jl:74``) and only prints ``it | hat_γ`` every ``freq``
(``Finito.jl:76,124-126``). We keep that printer for parity and add what
an accelerator build needs (SURVEY.md §5):

  * on-device fixed-point residual ``||z_{k+1} - z_k|| / hat_γ`` and
    objective value, computed with collective norms when sharded;
  * ``jax.profiler`` trace annotations around the hot phases (the solver
    steps are wrapped in ``jax.named_scope``);
  * a lightweight structured trace recorder.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp


def fixed_point_residual(z_prev, z_next, gamma):
    """||z_next - z_prev|| / gamma — the natural stationarity surrogate
    for these fixed-point iterations (works under pjit: the norm lowers
    to a collective when z is sharded)."""
    return jnp.sqrt(jnp.sum(jnp.abs(z_next - z_prev) ** 2)) / gamma


def objective(F, g, x):
    """(1/N) Σ f_i(x) + g(x), computed with full-pass oracles."""
    vals, _ = F.value_and_grad_all(x)
    return jnp.sum(vals) / F.num_terms + g.value(x)


def sharing_objective(F, g, xs):
    """(1/N) Σ f_i(x_i) + g(Σ x_i) — the SHARING formulation's objective
    (``test_sharing.jl:1``), evaluated at the (N, n) block solution each
    f_i at its OWN block point (``value_and_grad_pointwise``), with the
    coupling term g at the block sum."""
    N = F.num_terms
    idx = jnp.arange(N, dtype=jnp.int32)
    vals, _ = F.value_and_grad_pointwise(xs, idx)
    return jnp.sum(vals) / N + g.value(jnp.sum(xs, axis=0))


@dataclass
class Trace:
    """Structured per-checkpoint metric log (JSONL-dumpable)."""

    records: List[Dict[str, Any]] = field(default_factory=list)
    t0: float = field(default_factory=time.perf_counter)

    def log(self, it: int, **metrics):
        rec = {"it": int(it), "t": time.perf_counter() - self.t0}
        for k, v in metrics.items():
            rec[k] = float(v)
        self.records.append(rec)

    def dump(self, path):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def last(self, key, default=None):
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        return default


def observer(F, g, trace: "Trace", objective_every: bool = True,
             h=None, K=None):
    """An ``observe(it, state)`` callback for the solver facades'
    ``observe=`` hook: logs the objective (full-pass, collective-safe)
    and the stepsize-scaled fixed-point residual ||z_k − z_{k-1}||/γ̂
    into ``trace`` every ``freq`` iterations — the on-device convergence
    monitoring the reference's main path lacks (stop ≡ false,
    ``Finito.jl:74``).

    ``h``/``K`` extend the logged objective for the three-term solver
    families (Davis-Yin: + h(x); Condat-Vũ/Chambolle-Pock: + h(Kx) with
    K from ``ciao_tpu.ops.linmap``). The residual tracks whatever
    per-state sequence exists: ``state.z`` where the family carries one
    (ProShI's coupling variable included), else the solution view (the
    primal-dual/splitting states)."""
    prev = {}

    def observe(it, state):
        z = state.solution
        rec = {}
        if objective_every:
            if z.ndim == 2:
                # sharing-formulation state (ProShI): the solution is the
                # (N, n) block array and state.z is the DUAL-like coupling
                # variable — the finite-sum objective at z would be
                # meaningless. Compute the sharing objective instead.
                rec["obj"] = float(sharing_objective(F, g, z))
            else:
                obj = objective(F, g, z)
                if h is not None:
                    obj = obj + h.value(z if K is None else K.matvec(z))
                rec["obj"] = float(obj)
        zres = getattr(state, "z", None)
        if zres is None:
            zres = z
        if "z" in prev:
            gam = getattr(state, "hat_gamma", None)
            if gam is None:
                gam = getattr(state, "gamma", None)
            if gam is None:
                gam = getattr(state, "tau", None)   # primal-dual state
            if gam is None:
                gam = 1.0
            gam = jnp.max(jnp.asarray(gam))
            rec["residual"] = float(
                fixed_point_residual(prev["z"], zres, gam)
            )
        prev["z"] = zres
        trace.log(it, **rec)

    return observe


def profiler_trace(logdir: str):
    """Context manager: dump an xprof trace of everything inside.

    Usage::

        with monitor.profiler_trace("/tmp/xprof"):
            state = run_chunk(state, 100)
            jax.block_until_ready(state)
    """
    return jax.profiler.trace(logdir)
