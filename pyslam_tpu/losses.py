"""Robust M-estimator losses — parity with ``pyslam/losses.py``
(SURVEY.md §1 L3, §2.1): ``L2Loss``, ``L1Loss``, ``CauchyLoss``, ``HuberLoss``,
``TukeyLoss``, ``TDistributionLoss``.

Each loss is a rho/psi/weight triple applied **elementwise** to the stacked
residual vector (the reference's semantics):

  * ``loss(e)``      — the robustified cost contribution rho(e)
  * ``influence(e)`` — psi(e) = d rho / d e
  * ``weight(e)``    — the IRLS weight psi(e) / e, folded into the normal
                       equations as sqrt(w) scaling of residuals & Jacobians.

Device-first design: losses are frozen pytree dataclasses so they trace through
``jit``; the weight pass is fused into the residual kernels by XLA (SURVEY.md
§2.2 "fused IRLS reweighting").
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_EPS = 1e-12


def _pytree_loss(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in fields), None

    def unflatten(aux, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_pytree_loss
class L2Loss:
    """Standard squared loss: rho = e^2 / 2, unit IRLS weights."""

    def loss(self, e):
        return 0.5 * jnp.square(e)

    def influence(self, e):
        return e

    def weight(self, e):
        return jnp.ones_like(e)


@_pytree_loss
class L1Loss:
    """Absolute loss: rho = |e|, weight = 1/|e| (guarded at 0)."""

    def loss(self, e):
        return jnp.abs(e)

    def influence(self, e):
        return jnp.sign(e)

    def weight(self, e):
        return 1.0 / jnp.maximum(jnp.abs(e), _EPS)


@_pytree_loss
class CauchyLoss:
    """Cauchy/Lorentzian: rho = (k^2/2) log(1 + (e/k)^2)."""

    k: float = 1.0

    def loss(self, e):
        return 0.5 * self.k**2 * jnp.log1p(jnp.square(e / self.k))

    def influence(self, e):
        return e / (1.0 + jnp.square(e / self.k))

    def weight(self, e):
        return 1.0 / (1.0 + jnp.square(e / self.k))


@_pytree_loss
class HuberLoss:
    """Huber: quadratic inside |e| <= k, linear outside."""

    k: float = 1.0

    def loss(self, e):
        abs_e = jnp.abs(e)
        return jnp.where(abs_e <= self.k, 0.5 * e * e, self.k * (abs_e - 0.5 * self.k))

    def influence(self, e):
        return jnp.clip(e, -self.k, self.k)

    def weight(self, e):
        return jnp.minimum(1.0, self.k / jnp.maximum(jnp.abs(e), _EPS))


@_pytree_loss
class TukeyLoss:
    """Tukey biweight: hard redescending — zero influence beyond k."""

    k: float = 4.6851

    def loss(self, e):
        k2_6 = self.k**2 / 6.0
        inside = k2_6 * (1.0 - (1.0 - jnp.square(e / self.k)) ** 3)
        return jnp.where(jnp.abs(e) <= self.k, inside, k2_6)

    def influence(self, e):
        w = self.weight(e)
        return e * w

    def weight(self, e):
        r = jnp.square(e / self.k)
        return jnp.where(jnp.abs(e) <= self.k, jnp.square(1.0 - r), 0.0)


@_pytree_loss
class TDistributionLoss:
    """Student-t loss (Kerl et al. DVO) — the reference's dense-VO loss
    (pyslam/pipelines/dense.py per SURVEY.md §3.3).

    ``weight(e) = (nu + 1) / (nu + (e/scale)^2)``.  If ``scale`` is None the
    scale is re-estimated from the residuals by fixed-point iteration each
    call (jit-safe ``fori_loop``), matching the reference's online scale
    estimation.
    """

    nu: float = 5.0
    scale: float | None = None

    def _estimate_scale(self, e):
        nu = self.nu

        def body(_, sigma2):
            w = (nu + 1.0) / (nu + jnp.square(e) / sigma2)
            return jnp.mean(w * jnp.square(e)) + _EPS

        return jax.lax.fori_loop(0, 10, body, jnp.mean(jnp.square(e)) + _EPS)

    def _sigma2(self, e):
        if self.scale is not None:
            return jnp.asarray(self.scale, dtype=jnp.result_type(e)) ** 2
        return self._estimate_scale(e)

    def loss(self, e):
        s2 = self._sigma2(e)
        return 0.5 * (self.nu + 1.0) * jnp.log1p(jnp.square(e) / (self.nu * s2))

    def influence(self, e):
        return e * self.weight(e)

    def weight(self, e):
        s2 = self._sigma2(e)
        return (self.nu + 1.0) / (self.nu + jnp.square(e) / s2)


__all__ = [
    "L2Loss",
    "L1Loss",
    "CauchyLoss",
    "HuberLoss",
    "TukeyLoss",
    "TDistributionLoss",
]
