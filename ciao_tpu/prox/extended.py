"""Extended prox library.

The reference's tests only exercise NormL1 / IndBox / Zero (SURVEY.md
§2.2), but its users come from ProximalOperators.jl, whose library is
much wider. This module carries the rest of the commonly-used surface —
hard thresholding, group lasso, L-inf/L1 ball machinery, affine and
halfspace projections, log-barrier, hinge — so a ProximalOperators user
switching to this framework finds their operator under the same name.

All formulas are closed-form XLA (elementwise, sort-based, or one small
solve); nothing here needs a Pallas kernel — these run once per step on
an x-sized vector.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ciao_tpu.prox.base import ProxOperator, register_prox, static_field, _softsign


def _zero_like_real(x):
    return jnp.zeros((), jnp.result_type(jnp.asarray(x).real))


def _ind_value(feasible, x):
    dt = jnp.result_type(jnp.asarray(x).real)
    return jnp.where(feasible, 0.0, jnp.inf).astype(dt)


@register_prox
@dataclasses.dataclass(frozen=True)
class NormL0(ProxOperator):
    """g(x) = lam * ||x||_0 (count of nonzeros; nonconvex).

    prox = hard threshold: keep x_i iff |x_i|^2 > 2*gamma*lam.
    (Ties broken toward zero, matching ProximalOperators.NormL0.)
    """

    lam: jnp.ndarray = 1.0

    def value(self, x):
        dt = jnp.result_type(jnp.asarray(x).real)
        return (self.lam * jnp.sum(x != 0)).astype(dt)

    def prox_only(self, x, gamma):
        keep = jnp.abs(x) ** 2 > 2 * gamma * self.lam
        return jnp.where(keep, x, 0)


@register_prox
@dataclasses.dataclass(frozen=True)
class SqrDistPoint(ProxOperator):
    """g(x) = (rho/2) ||x - b||^2 — a proximable quadratic around a
    point (ProximalOperators' ``Translate(SqrNormL2(rho), -b)``); prox
    is the convex combination (x + gamma*rho*b)/(1 + gamma*rho). The
    canonical proximable data-fit term for Douglas-Rachford /
    Chambolle-Pock splits where the quadratic is NOT treated as the
    smooth part."""

    b: jnp.ndarray = 0.0
    rho: jnp.ndarray = 1.0

    def value(self, x):
        return 0.5 * self.rho * jnp.sum(jnp.abs(x - self.b) ** 2).real

    def prox_only(self, x, gamma):
        return (x + gamma * self.rho * self.b) / (1 + gamma * self.rho)


@register_prox
@dataclasses.dataclass(frozen=True)
class NormL21(ProxOperator):
    """Group lasso: g(X) = lam * sum_j ||X_slice_j||_2, where each group
    is a slice along ``axis`` (default 0: column norms of a matrix).

    prox = per-group block soft-threshold.
    """

    separable = False

    lam: jnp.ndarray = 1.0
    axis: int = static_field(default=0)

    def _group_norms(self, x):
        return jnp.sqrt(jnp.sum(jnp.abs(x) ** 2, axis=self.axis, keepdims=True))

    def value(self, x):
        return self.lam * jnp.sum(self._group_norms(x))

    def prox_only(self, x, gamma):
        nrm = self._group_norms(x)
        scale = jnp.maximum(1 - gamma * self.lam / jnp.maximum(nrm, 1e-38), 0)
        return scale * x


def _project_l1_ball(x, r):
    """Euclidean projection onto {z : ||z||_1 <= r} (Duchi et al. 2008;
    sort-based, same machinery as the IndSimplex projection)."""
    mag = jnp.abs(x)
    dt = jnp.result_type(jnp.asarray(mag).dtype)
    inside = jnp.sum(mag) <= r
    n = x.shape[-1]
    u = jnp.sort(mag)[..., ::-1]
    css = jnp.cumsum(u, axis=-1) - r
    ks = jnp.arange(1, n + 1, dtype=dt)
    k = jnp.maximum(jnp.sum(u - css / ks > 0, axis=-1), 1)
    tau = jnp.maximum(css[..., k - 1] / k.astype(dt), 0)
    shrunk = _softsign(x) * jnp.maximum(mag - tau, 0)
    return jnp.where(inside, x, shrunk)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndBallL1(ProxOperator):
    """Indicator of {x : ||x||_1 <= r}; prox = sort-based projection."""

    separable = False

    r: jnp.ndarray = 1.0

    def value(self, x):
        nrm = jnp.sum(jnp.abs(x))
        eps = 100 * jnp.finfo(jnp.result_type(nrm)).eps
        return _ind_value(nrm <= self.r * (1 + eps), x)

    def prox_only(self, x, gamma):
        return _project_l1_ball(x, self.r)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class NormLinf(ProxOperator):
    """g(x) = lam * max_i |x_i|.

    prox via Moreau decomposition: z = x - proj_{gamma*lam * B_1}(x).
    """

    separable = False

    lam: jnp.ndarray = 1.0

    def value(self, x):
        return self.lam * jnp.max(jnp.abs(x))

    def prox_only(self, x, gamma):
        return x - _project_l1_ball(x, gamma * self.lam)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndNonnegative(ProxOperator):
    """Indicator of the nonnegative orthant; prox = clip below at 0."""

    def value(self, x):
        return _ind_value(jnp.all(x >= 0), x)

    def prox_only(self, x, gamma):
        return jnp.maximum(x, 0)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndNonpositive(ProxOperator):
    """Indicator of the nonpositive orthant; prox = clip above at 0."""

    def value(self, x):
        return _ind_value(jnp.all(x <= 0), x)

    def prox_only(self, x, gamma):
        return jnp.minimum(x, 0)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndBallLinf(ProxOperator):
    """Indicator of {x : ||x||_inf <= r}; prox = clip to [-r, r]."""

    r: jnp.ndarray = 1.0

    def value(self, x):
        return _ind_value(jnp.all(jnp.abs(x) <= self.r), x)

    def prox_only(self, x, gamma):
        return jnp.clip(x, -self.r, self.r)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndHalfspace(ProxOperator):
    """Indicator of {x : <a, x> <= b}; prox = affine projection."""

    separable = False

    a: jnp.ndarray = None
    b: jnp.ndarray = 0.0

    def value(self, x):
        viol = jnp.vdot(self.a, x).real - self.b
        eps = 1e-6 * jnp.maximum(1.0, jnp.abs(self.b))
        return _ind_value(viol <= eps, x)

    def prox_only(self, x, gamma):
        a = self.a
        viol = jnp.vdot(a, x).real - self.b
        step = jnp.maximum(viol, 0) / jnp.maximum(jnp.sum(jnp.abs(a) ** 2), 1e-38)
        return x - step * a

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndPoint(ProxOperator):
    """Indicator of the single point {p}; prox = p."""

    separable = False

    p: jnp.ndarray = 0.0

    def value(self, x):
        return _ind_value(jnp.all(jnp.abs(x - self.p) <= 1e-9), x)

    def prox_only(self, x, gamma):
        return jnp.broadcast_to(jnp.asarray(self.p, jnp.result_type(x)), x.shape)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndAffine(ProxOperator):
    """Indicator of {x : A x = b}; prox = x - A^H (A A^H)^{-1} (A x - b).

    A is (m, n) with full row rank; the m-by-m solve runs per prox call
    (m is the number of constraints — small in practice)."""

    separable = False

    A: jnp.ndarray = None
    b: jnp.ndarray = 0.0

    def value(self, x):
        res = self.A @ x - self.b
        return _ind_value(jnp.max(jnp.abs(res)) <= 1e-6, x)

    def prox_only(self, x, gamma):
        A = self.A
        res = A @ x - self.b
        G = A @ A.conj().T
        return x - A.conj().T @ jnp.linalg.solve(G, res)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class IndSphereL2(ProxOperator):
    """Indicator of {x : ||x||_2 = r} (nonconvex); prox = radial
    rescale to the sphere (x = 0 maps to r*e_1, a valid selection)."""

    separable = False

    r: jnp.ndarray = 1.0

    def value(self, x):
        nrm = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2))
        eps = 100 * jnp.finfo(jnp.result_type(nrm)).eps
        return _ind_value(jnp.abs(nrm - self.r) <= self.r * eps + eps, x)

    def prox_only(self, x, gamma):
        nrm = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2))
        e1 = jnp.zeros_like(x).at[..., 0].set(1)
        safe = jnp.where(nrm > 0, x, e1)
        return safe * (self.r / jnp.maximum(jnp.where(nrm > 0, nrm, 1.0), 1e-38))

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, _zero_like_real(z)


@register_prox
@dataclasses.dataclass(frozen=True)
class LogBarrier(ProxOperator):
    """g(x) = -mu * sum_i log(x_i) (domain x > 0).

    prox_i = (x_i + sqrt(x_i^2 + 4*gamma*mu)) / 2 (elementwise closed
    form; always lands strictly inside the domain)."""

    mu: jnp.ndarray = 1.0

    def value(self, x):
        dt = jnp.result_type(jnp.asarray(x).real)
        ok = jnp.all(x > 0)
        v = -self.mu * jnp.sum(jnp.log(jnp.where(x > 0, x, 1)))
        return jnp.where(ok, v, jnp.inf).astype(dt)

    def prox_only(self, x, gamma):
        return 0.5 * (x + jnp.sqrt(x * x + 4 * gamma * self.mu))


@register_prox
@dataclasses.dataclass(frozen=True)
class HingeLoss(ProxOperator):
    """g(x) = mu * sum_i max(0, 1 - y_i * x_i), labels y_i in {-1, +1}.

    Elementwise closed-form prox:
      y_i x_i >= 1              -> x_i            (flat region)
      y_i x_i <  1 - gamma*mu   -> x_i + gamma*mu*y_i (linear region)
      otherwise                 -> y_i            (kink: y_i z_i = 1)
    """

    y: jnp.ndarray = 1.0
    mu: jnp.ndarray = 1.0

    def value(self, x):
        return self.mu * jnp.sum(jnp.maximum(0, 1 - self.y * x))

    def prox_only(self, x, gamma):
        y = jnp.asarray(self.y, jnp.result_type(x))
        t = gamma * self.mu
        yx = y * x
        z_lin = x + t * y
        z_kink = y  # y in {-1, +1} so y*z = 1 at the kink
        return jnp.where(yx >= 1, x, jnp.where(yx < 1 - t, z_lin, z_kink))


@register_prox
@dataclasses.dataclass(frozen=True)
class MCP(ProxOperator):
    """Minimax concave penalty (Zhang 2010; nonconvex, elementwise):

      g(t) = lam*|t| - t^2/(2*beta)        for |t| <= beta*lam
             beta*lam^2/2                  otherwise

    The reference framework advertises "possibly nonconvex g"
    (README.md:6-12) but ProximalOperators' tested surface stops at
    NormL0; MCP/SCAD are the standard debiased sparse penalties. Prox
    (firm threshold, exact for gamma < beta):

      |v| <= gamma*lam     -> 0
      |v| <= beta*lam      -> softsign(v)*(|v| - gamma*lam)/(1 - gamma/beta)
      otherwise            -> v
    """

    lam: jnp.ndarray = 1.0
    beta: jnp.ndarray = 3.0

    def value(self, x):
        dt = jnp.result_type(jnp.asarray(x).real)
        a = jnp.abs(x)
        lam, beta = self.lam, self.beta
        inner = lam * a - a * a / (2 * beta)
        return jnp.sum(
            jnp.where(a <= beta * lam, inner, beta * lam * lam / 2)
        ).astype(dt)

    def prox_only(self, x, gamma):
        a = jnp.abs(x)
        lam, beta = self.lam, self.beta
        thr = gamma * lam
        firm = _softsign(x) * (a - thr) / (1 - gamma / beta)
        z = jnp.where(a <= thr, jnp.zeros_like(x),
                      jnp.where(a <= beta * lam, firm, x))
        return z.astype(x.dtype)


@register_prox
@dataclasses.dataclass(frozen=True)
class SCAD(ProxOperator):
    """Smoothly clipped absolute deviation (Fan & Li 2001; nonconvex,
    elementwise):

      g(t) = lam*|t|                                  for |t| <= lam
             (2*a*lam*|t| - t^2 - lam^2)/(2*(a-1))    for lam < |t| <= a*lam
             (a+1)*lam^2/2                            otherwise

    Prox (generalized Fan-Li thresholding, exact for gamma < a - 1):

      |v| <= lam*(1+gamma)  -> soft(v, gamma*lam)
      |v| <= a*lam          -> ((a-1)*v - softsign(v)*a*gamma*lam)/(a-1-gamma)
      otherwise             -> v
    """

    lam: jnp.ndarray = 1.0
    a: jnp.ndarray = 3.7

    def value(self, x):
        dt = jnp.result_type(jnp.asarray(x).real)
        t = jnp.abs(x)
        lam, a = self.lam, self.a
        mid = (2 * a * lam * t - t * t - lam * lam) / (2 * (a - 1))
        v = jnp.where(
            t <= lam, lam * t,
            jnp.where(t <= a * lam, mid, (a + 1) * lam * lam / 2),
        )
        return jnp.sum(v).astype(dt)

    def prox_only(self, x, gamma):
        t = jnp.abs(x)
        lam, a = self.lam, self.a
        soft = _softsign(x) * jnp.maximum(t - gamma * lam, 0)
        mid = ((a - 1) * x - _softsign(x) * a * gamma * lam) / (a - 1 - gamma)
        z = jnp.where(t <= lam * (1 + gamma), soft,
                      jnp.where(t <= a * lam, mid, x))
        return z.astype(x.dtype)
