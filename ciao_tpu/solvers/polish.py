"""High-accuracy FISTA polish: compensated chunked gradients.

Every f32 solver floors at rel ~4e-5 on the 10M×100 planted lasso —
NOT because the iterate needs more than f32 (at gap = 1e-6·f* the
distance to the optimum is ~1e-3·‖x‖, three orders above f32's
resolution of x) but because the full-gradient REDUCTION over 10.5M
rows accumulates f32 rounding ~√N·eps relative — the solver stalls when
the true gradient sinks below that noise. f64 rows would double the
bytes of a bandwidth-bound pass to fix a reduction error.

The fix costs almost nothing: stream the rows in f32
(``precision=HIGHEST`` so the multiplies are true f32), but accumulate
the per-chunk partial gradients with a COMPENSATED (two-sum / Kahan)
carry. Within a chunk of C rows the f32 dot rounds at ~√C·eps; across
the N/C chunks the compensation is exact to O(eps²). C = 32k cuts the
accumulation noise ~18× vs the monolithic pass — enough to push the
composite-gradient floor 2-3 orders below rel 1e-6 — while the chunk
loop's fixed cost stays small next to the stream.

``fista_polish`` wraps that gradient in a monotone FISTA loop: at the
10M scale the planted operator's Hessian has κ = (1+√(n/N))⁴ ≈ 1.03,
so once a stochastic solver has delivered the f32 floor, a handful of
polish epochs — each one 2-pass read of the rows — closes rel 4e-5 →
1e-6. Used by ``deep_solve``; reusable for any dense-rows coefficient
oracle (the margin → ``coeff_from_margin`` protocol supplies the loss;
f32/bf16 rows only — an int8 operator defines a different problem and
belongs to the staged schedule, not the polish).

No reference counterpart (CIAOAlgorithms.jl is f64-on-CPU throughout —
this is the f32 answer to the accuracy its dtype gives for free).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


class PolishResult(NamedTuple):
    x: jnp.ndarray        # polished iterate
    fp_res: jnp.ndarray   # ‖x_k − prox(x_k − η∇f)‖/η at the last step


def _two_sum(hi, lo, p):
    """Knuth two-sum: (hi, lo) ← (hi, lo) + p with the rounding error
    of the add captured exactly into the compensation term."""
    s = hi + p
    t = s - hi
    e = (p - t) + (hi - (s - t))
    return s, lo + e


def grad_sum_chunked(F, x, chunk: int):
    """Σᵢ ∇fᵢ(x) over the oracle's rows with per-chunk f32
    HIGHEST-precision dots and a compensated cross-chunk carry. Rows
    are read via the oracle's stored array (``coeff_rows_data``), the
    loss enters through the margin protocol (``coeff_from_margin``),
    so any dense-rows coefficient oracle works. f32/bf16 storage only.
    Un-normalized so the DP path can psum the per-shard sums before
    dividing by the GLOBAL N (parallel.DPForwardBackward
    ``polish_chunk``)."""
    _require_wide_rows(F, "polish")
    A, _ = F.coeff_rows_data()
    N, n = A.shape
    if N % chunk:
        raise ValueError(f"chunk {chunk} must divide N={N}")
    d = N // chunk

    def body(carry, i):
        hi, lo = carry
        start = i * chunk
        A_B = jax.lax.dynamic_slice_in_dim(A, start, chunk, 0)
        A_B = A_B.astype(x.dtype)
        m = jnp.dot(A_B, x, precision=_HI)          # raw margins
        c = F.coeff_from_margin(m, start, chunk)    # oracle's formula
        p = jnp.dot(c, A_B, precision=_HI)          # partial Σ cᵢaᵢ
        return _two_sum(hi, lo, p), None

    z = jnp.zeros(n, x.dtype)
    (hi, lo), _ = jax.lax.scan(body, (z, z), jnp.arange(d))
    return hi + lo


def grad_mean_chunked(F, x, chunk: int):
    """(1/N)·Σᵢ ∇fᵢ(x) — the compensated chunked sum, normalized."""
    return grad_sum_chunked(F, x, chunk) / F.num_terms


def grad_sum_chunked_blocks(F, x, chunk: int):
    """Σᵢ ∇fᵢ(x) with the compensated cross-chunk carry through the
    BLOCK protocol (``coeff_block`` + ``apply_rows_block``) instead of
    dense stored rows — this is how SPARSE oracles (ELL / hybrid
    hot-cold) polish: the same two-sum accumulation, one
    coefficient-read + one apply per chunk. Any rank-1 block oracle
    works; the dense-rows version (``grad_sum_chunked``) reads each
    row once instead of twice and stays preferred where it applies."""
    N = F.num_terms
    n = x.size
    if N % chunk:
        raise ValueError(f"chunk {chunk} must divide N={N}")
    d = N // chunk

    def body(carry, i):
        hi, lo = carry
        start = i * chunk
        c = F.coeff_block(x, start, chunk)
        p = F.apply_rows_block(c, start, chunk)
        return _two_sum(hi, lo, p), None

    z = jnp.zeros(n, x.dtype)
    (hi, lo), _ = jax.lax.scan(body, (z, z), jnp.arange(d))
    return hi + lo


def grad_mean_chunked_blocks(F, x, chunk: int):
    """(1/N)·Σᵢ ∇fᵢ(x) via the block protocol, compensated."""
    return grad_sum_chunked_blocks(F, x, chunk) / F.num_terms


@functools.partial(jax.jit,
                   static_argnames=("steps", "chunk", "block_protocol"))
def fista_polish(F, g, x0, eta, steps: int, chunk: int = 32_768,
                 block_protocol: bool = False):
    """``steps`` monotone-FISTA steps x ← prox_g(y − η∇f(y), η) with the
    compensated chunked gradient; one dispatch (η from a spectral bound
    — see ``power_lmax`` / ``power_lmax_quadratic``). Monotone restart:
    if the candidate's fixed-point residual grows, the momentum resets
    (standard FISTA restart; keeps the last stretch of a
    nearly-quadratic basin monotone). ``block_protocol=True`` routes
    the gradient through ``grad_mean_chunked_blocks`` — the SPARSE
    oracles' path (no dense stored rows)."""
    eta = jnp.asarray(eta, x0.dtype)
    grad_fn = (grad_mean_chunked_blocks if block_protocol
               else grad_mean_chunked)

    def step(carry, _):
        x, y, t, _ = carry
        gr = grad_fn(F, y, chunk)
        x_new = g.prox_only(y - eta * gr, eta)
        res = jnp.linalg.norm(x_new - y) / eta
        # gradient-mapping restart: ⟨y − x_new, x_new − x⟩ > 0 means the
        # momentum points uphill — restart from x_new
        restart = jnp.vdot(y - x_new, x_new - x) > 0
        t_new = jnp.where(restart, 1.0,
                          0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)))
        beta = jnp.where(restart, 0.0, (t - 1.0) / t_new)
        y_new = x_new + beta * (x_new - x)
        return (x_new, y_new, t_new, res), None

    t0 = jnp.ones((), x0.dtype)
    (x, _, _, res), _ = jax.lax.scan(
        step, (x0, x0, t0, jnp.zeros((), x0.dtype)), None, length=steps)
    return PolishResult(x=x, fp_res=res)


def _require_wide_rows(F, who: str):
    if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
        raise ValueError(f"{who} needs f32/bf16 rows (int8 dequant "
                         "defines a different operator — rebase to "
                         "wide storage first)")


@functools.partial(jax.jit, static_argnames=("iters",))
def power_lmax(F, x, key, iters: int = 8, margin_slack=0.0):
    """λmax upper bound of the mean Hessian of f = (1/N)Σ fᵢ for ANY
    dense-rows margin oracle, by power iteration on

        H̄ = (1/N) · Aᵀ diag(w̄ᵢ) A,

    where w̄ᵢ = ``F.hess_weight_from_margin(m, margin_slack)`` bounds
    each row's margin curvature d²fᵢ/dm² (exact GLOBAL constant for
    least-squares; POINTWISE trust-region weights at the anchor ``x``
    for logistic / Huber / squared-hinge / Poisson as of round 5 —
    valid while each margin moves ≤ ``margin_slack``, which the
    post-plateau polish satisfies; pass a slack covering the motion
    when in doubt). Each iteration is one 2-pass read of the rows. The
    polish caller takes η = 0.9/λ̂ (``deep_solve``); w̄ ≥ w everywhere
    in the trust region, so the step is safe there — at worst
    conservative.

    Supersedes ``lsq_power_lmax`` (kept as the least-squares wrapper).
    Reference anchor: the reference needs no such machinery because its
    kernels are f64 end-to-end (``src/algorithms/Finito/
    Finito_basic.jl:14``); this is the f32 route to the same accuracy.
    """
    _require_wide_rows(F, "power_lmax")
    A, _ = F.coeff_rows_data()
    N, n = A.shape
    m = jnp.dot(A, x.astype(jnp.float32), precision=_HI)
    w = F.hess_weight_from_margin(m, margin_slack)

    def body(v, _):
        u = jnp.dot(A, v, precision=_HI)
        hv = jnp.dot(w * u, A, precision=_HI) / N
        lam = jnp.linalg.norm(hv)
        # pointwise indicator weights (Huber/sqhinge) can be all-zero
        # at an anchor with no active rows — keep the iteration finite
        return hv / jnp.maximum(lam, jnp.finfo(hv.dtype).tiny), lam

    v0 = jax.random.normal(key, (n,), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    _, lams = jax.lax.scan(body, v0, None, length=iters)
    return lams[-1]


@functools.partial(jax.jit, static_argnames=("iters",))
def power_lmax_weighted(F, x, key, iters: int = 8, margin_slack=0.0):
    """λmax of the margin-WEIGHTED mean Hessian for BLOCK-PROTOCOL
    (sparse ELL / hybrid) oracles — the exact analog of
    :func:`power_lmax` without dense stored rows (VERDICT r4 #5):

        H̄ = (1/N) · Aᵀ diag(w̄ᵢ) A,
        w̄ᵢ = F.hess_weight_from_margin(mᵢ, margin_slack),

    where the margins mᵢ = ⟨aᵢ, x⟩ come from ONE ``margin_all`` pass at
    the anchor and each power iteration is a ``margin_all`` +
    ``apply_all`` pair (two operator passes — the
    ``power_lmax_quadratic`` machinery plus the diagonal weight). For
    sparse LOGISTIC the weight is the POINTWISE trust-region bound on
    σ(t)(1−σ(t)) over |m−mᵢ| ≤ ``margin_slack`` — near a separated
    optimum this sits far below the global 1/4, so the polish stepsize
    η = 0.9/λ̂ roughly doubles vs the quadratic-twin × 1/4 bound and the
    FISTA leash halves. Least-squares layouts get their exact constant
    weight (identical to the quadratic bound)."""
    if not (hasattr(F, "margin_all") and hasattr(F, "apply_all")
            and hasattr(F, "hess_weight_from_margin")):
        raise ValueError(
            "power_lmax_weighted needs the block margin protocol "
            "(margin_all / apply_all / hess_weight_from_margin)")
    N, n = F.num_terms, F.dim
    m = F.margin_all(x.astype(jnp.float32))
    w = F.hess_weight_from_margin(m, margin_slack)

    def body(v, _):
        u = F.margin_all(v)
        hv = F.apply_all(w * u) / N
        lam = jnp.linalg.norm(hv)
        return hv / jnp.maximum(lam, jnp.finfo(hv.dtype).tiny), lam

    v0 = jax.random.normal(key, (n,), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    _, lams = jax.lax.scan(body, v0, None, length=iters)
    return lams[-1]


@functools.partial(jax.jit, static_argnames=("iters",))
def power_lmax_quadratic(F, key, iters: int = 8):
    """λmax of the mean Hessian for a QUADRATIC (least-squares-family)
    oracle WITHOUT dense stored rows — the sparse ELL / hybrid layouts:
    since ∇ is affine, H v = (∇Σf(v) − ∇Σf(0))/N exactly, so the power
    iteration runs through ``grad_sum_all`` alone (two operator passes
    per iteration). Quadratic losses only (``coeff_mode == 0``); the
    loss-generic dense-rows bound is :func:`power_lmax`."""
    n = F.dim

    def body(v, _):
        hv = (F.grad_sum_all(v) - F.grad_sum_all(jnp.zeros_like(v)))
        hv = hv / F.num_terms
        lam = jnp.linalg.norm(hv)
        return hv / lam, lam

    v0 = jax.random.normal(key, (n,), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    _, lams = jax.lax.scan(body, v0, None, length=iters)
    return lams[-1]


def lsq_power_lmax(F, key, iters: int = 8):
    """λmax of the mean-Hessian (scale/N)·AᵀA of a least-squares rows
    oracle — the least-squares case of :func:`power_lmax` (constant
    curvature weights, so the anchor is irrelevant and zeros serve).
    The planted deep-target operator's spectrum is clustered (κ ≈ 1.03
    at N ≫ n), so even 2-3 iterations give a step-safe estimate; the
    caller should still take η = 0.9/λ̂. Raises on int8-quantized rows
    (their raw values would yield a wrong λ and hence a wrong polish
    stepsize)."""
    _require_wide_rows(F, "lsq_power_lmax")
    n = F.coeff_rows_data()[0].shape[1]
    return power_lmax(F, jnp.zeros(n, jnp.float32), key, iters=iters)
