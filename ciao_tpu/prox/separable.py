"""Prox operator library.

Covers every nonsmooth term the reference's tests exercise —
``NormL1(lam)`` (test_lasso.jl:59), ``IndBox(-Inf, ones)``
(test_sharing.jl:25), ``Zero()`` defaults (Finito.jl:69) — plus the
standard extended library (NormL2, SqrNormL2, ElasticNet, IndBallL2,
IndSimplex, NormNuclear) so users of ProximalOperators.jl find their
operators here.

Every operator is an elementwise XLA formula; XLA fuses it into the
surrounding step.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ciao_tpu.prox.base import ProxOperator, register_prox, static_field, _softsign


@register_prox
@dataclasses.dataclass(frozen=True)
class Zero(ProxOperator):
    """g == 0; prox is the identity (reference default g, Finito.jl:69)."""

    def value(self, x):
        return jnp.zeros((), jnp.real(x).dtype)

    def prox_only(self, x, gamma):
        return x

    def prox(self, x, gamma):
        return x, self.value(x)


@register_prox
@dataclasses.dataclass(frozen=True)
class NormL1(ProxOperator):
    """g(x) = lam * ||x||_1; prox = soft-thresholding.

    Complex support: |x_i| magnitudes with phase preserved, matching
    ProximalOperators' complex soft-threshold (test_lasso.jl sweeps
    ComplexF32/F64).
    """

    lam: jnp.ndarray = 1.0

    def value(self, x):
        return self.lam * jnp.sum(jnp.abs(x))

    def prox_only(self, x, gamma):
        thr = gamma * self.lam
        mag = jnp.abs(x)
        return _softsign(x) * jnp.maximum(mag - thr, 0)


@register_prox
@dataclasses.dataclass(frozen=True)
class NormL2(ProxOperator):
    """g(x) = lam * ||x||_2 (not squared); prox = block soft-threshold."""

    separable = False

    lam: jnp.ndarray = 1.0

    def value(self, x):
        return self.lam * jnp.sqrt(jnp.sum(jnp.abs(x) ** 2))

    def prox_only(self, x, gamma):
        nrm = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2))
        scale = jnp.maximum(1 - gamma * self.lam / jnp.maximum(nrm, 1e-38), 0)
        return scale * x


@register_prox
@dataclasses.dataclass(frozen=True)
class SqrNormL2(ProxOperator):
    """g(x) = (lam/2) ||x||^2; prox = shrink by 1/(1 + gamma lam)."""

    lam: jnp.ndarray = 1.0

    def value(self, x):
        return 0.5 * self.lam * jnp.sum(jnp.abs(x) ** 2)

    def prox_only(self, x, gamma):
        return x / (1 + gamma * self.lam)


@register_prox
@dataclasses.dataclass(frozen=True)
class ElasticNet(ProxOperator):
    """g(x) = lam ||x||_1 + (mu/2) ||x||^2."""

    lam: jnp.ndarray = 1.0
    mu: jnp.ndarray = 1.0

    def value(self, x):
        a = jnp.abs(x)
        return self.lam * jnp.sum(a) + 0.5 * self.mu * jnp.sum(a**2)

    def prox_only(self, x, gamma):
        mag = jnp.abs(x)
        soft = jnp.maximum(mag - gamma * self.lam, 0)
        return _softsign(x) * soft / (1 + gamma * self.mu)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndBox(ProxOperator):
    """Indicator of the box [lo, hi]; prox = clip. Infinite bounds OK
    (the sharing test uses IndBox(-Inf, 1), test_sharing.jl:25)."""

    lo: jnp.ndarray = -jnp.inf
    hi: jnp.ndarray = jnp.inf

    def value(self, x):
        # 0 on the box; the reference relies on feasibility after prox.
        # Allow a 100·eps relative slack (same convention as IndBallL2):
        # points reconstructed from a prox output — e.g. ProShI's block
        # sum Σx_i = av + hat_γ·z ≡ prox_g(av) — are feasible only up to
        # roundoff, and an exact check would report ∞ spuriously.
        rdt = jnp.result_type(jnp.asarray(x).real)
        tol = 100 * jnp.finfo(rdt).eps * (1 + jnp.abs(x))
        inside = jnp.all((x >= self.lo - tol) & (x <= self.hi + tol))
        return jnp.where(inside, 0.0, jnp.inf).astype(rdt)

    def prox_only(self, x, gamma):
        return jnp.clip(x, self.lo, self.hi)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, jnp.zeros((), jnp.result_type(z.real))


@register_prox
@dataclasses.dataclass(frozen=True)
class IndBallL2(ProxOperator):
    """Indicator of {x : ||x|| <= r}; prox = radial projection."""

    separable = False

    r: jnp.ndarray = 1.0

    def value(self, x):
        nrm = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2))
        eps = 100 * jnp.finfo(nrm.dtype).eps
        return jnp.where(nrm <= self.r * (1 + eps), 0.0, jnp.inf).astype(nrm.dtype)

    def prox_only(self, x, gamma):
        nrm = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2))
        scale = jnp.where(nrm > self.r, self.r / jnp.maximum(nrm, 1e-38), 1.0)
        return scale * x

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, jnp.zeros((), jnp.result_type(z.real))


@register_prox
@dataclasses.dataclass(frozen=True)
class IndSimplex(ProxOperator):
    """Indicator of the probability simplex {x >= 0, sum x = a}."""

    separable = False

    a: jnp.ndarray = 1.0

    def value(self, x):
        dt = jnp.result_type(x.real)
        feas = jnp.all(x >= -1e-9) & (jnp.abs(jnp.sum(x) - self.a) < 1e-6)
        return jnp.where(feas, 0.0, jnp.inf).astype(dt)

    def prox_only(self, x, gamma):
        # Sort-based projection (Held, Wolfe, Crowder).
        n = x.shape[-1]
        u = jnp.sort(x)[..., ::-1]
        css = jnp.cumsum(u, axis=-1) - self.a
        ks = jnp.arange(1, n + 1, dtype=x.dtype)
        cond = u - css / ks > 0
        k = jnp.sum(cond, axis=-1)
        tau = css[..., k - 1] / k.astype(x.dtype)
        return jnp.maximum(x - tau, 0)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, jnp.zeros((), jnp.result_type(z.real))


@register_prox
@dataclasses.dataclass(frozen=True)
class NormNuclear(ProxOperator):
    """g(X) = lam * ||X||_* on matrices; prox = singular-value soft-threshold."""

    separable = False

    lam: jnp.ndarray = 1.0

    def value(self, x):
        s = jnp.linalg.svd(x, compute_uv=False)
        return self.lam * jnp.sum(s)

    def prox_only(self, x, gamma):
        u, s, vt = jnp.linalg.svd(x, full_matrices=False)
        s_thr = jnp.maximum(s - gamma * self.lam, 0)
        return (u * s_thr[..., None, :]) @ vt


@register_prox
@dataclasses.dataclass(frozen=True)
class GroupNormL21(ProxOperator):
    """g(u) = lam · Σ_p ‖(u_p, u_{p+m}, …)‖₂ over ``groups`` stacked
    fields of equal length m = len(u)/groups, on a FLAT vector — the
    ISOTROPIC total variation norm when u is
    :class:`ciao_tpu.GradientMap2D`'s stacked (∇_h, ∇_v) output
    (groups=2); the flat-vector counterpart of the matrix group-lasso
    :class:`ciao_tpu.prox.NormL21` shaped for primal-dual duals. Prox
    = per-group block soft-threshold (group-separable, so it is
    TP-shardable along the within-field axis). Complex entries:
    magnitudes with phase kept, like NormL1."""

    separable = False


    lam: jnp.ndarray = 1.0
    groups: int = static_field(default=2)

    def value(self, u):
        v = u.reshape(self.groups, -1)
        return self.lam * jnp.sum(jnp.sqrt(jnp.sum(jnp.abs(v) ** 2, axis=0)))

    def prox_only(self, u, gamma):
        v = u.reshape(self.groups, -1)
        nrm = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2, axis=0))
        scale = jnp.maximum(
            1 - gamma * self.lam / jnp.maximum(nrm, 1e-38), 0)
        return (scale[None, :] * v).reshape(u.shape)
