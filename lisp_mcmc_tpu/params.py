"""Parameter model: named parameter dicts <-> flat vectors.

The reference (afranson/Lisp-MCMC) represents model parameters as keyword
plists ``(:scale 1d-5 :x0 2200 ...)`` and supports four "param styles"
(multiple kwargs / single list / single vector / single 2D array; see
``mcmc-fitting.lisp:1078-1088`` and the style tag at 1153-1155).

Device-first redesign: the canonical on-device representation is a flat
``(d,)`` float vector (batched to ``(W, d)`` over walkers).  Named access
is a *host-side view* via :class:`ParamSpec`, which records the key order
once at fit-creation time (the analogue of ``walker-param-keys``,
``mcmc-fitting.lisp:469``).  The four reference styles collapse to two
accepted user inputs — a ``{name: scalar}`` dict or a flat array — which
are normalized at the API boundary exactly like the reference's
``to-double-floats`` (``mcmc-fitting.lisp:833``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import jax.numpy as jnp
import numpy as np

__all__ = [
    "ParamSpec",
    "normalize_params",
    "map_params",
    "scale_params",
    "reduce_params",
]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Ordered parameter names; the bridge between dicts and vectors.

    Hashable/frozen so it can ride inside jit static args.  Mirrors the
    plist utilities ``get-plist-keys``/``get-plist-values``/``make-plist``
    (``mcmc-fitting.lisp:432-454``).
    """

    keys: tuple[str, ...]

    @classmethod
    def from_params(cls, params: Mapping[str, Any] | Sequence[float]) -> "ParamSpec":
        if isinstance(params, Mapping):
            return cls(tuple(_norm_key(k) for k in params.keys()))
        arr = np.asarray(params)
        return cls(tuple(f"p{i}" for i in range(arr.shape[-1])))

    @property
    def ndim(self) -> int:
        return len(self.keys)

    def index(self, key: str) -> int:
        return self.keys.index(_norm_key(key))

    def flatten(self, params: Mapping[str, Any] | Sequence[float], dtype=None):
        """Dict or array -> flat ``(d,)`` jnp vector (key order = spec order)."""
        if isinstance(params, Mapping):
            params = {_norm_key(k): v for k, v in params.items()}
            vals = [params[k] for k in self.keys]
            return jnp.asarray(vals, dtype=dtype)
        return jnp.asarray(params, dtype=dtype)

    def unflatten(self, vector) -> dict[str, Any]:
        """Flat ``(..., d)`` vector -> ``{name: (...)}`` dict of scalars.

        Works on batched vectors: each value keeps leading batch dims.
        This dict is what user model functions receive (the deliberate
        API break from ``&key``-lambda ergonomics, SURVEY §7 hard part e).
        """
        return {k: vector[..., i] for i, k in enumerate(self.keys)}

    def make(self, values: Sequence[float]) -> dict[str, float]:
        return dict(zip(self.keys, values))


def _norm_key(key: str) -> str:
    """Accept ``":scale"`` (reference keyword syntax) as well as ``"scale"``."""
    return key[1:] if key.startswith(":") else key


def normalize_params(params, dtype=jnp.float64):
    """Normalize user params to ``(spec, (d,) vector)``.

    Accepts a ``{name: scalar}`` dict (reference's multiple-kwargs style)
    or a flat list/tuple/array (reference's single-item styles,
    ``mcmc-fitting.lisp:1153-1155``).  Coerces to float like
    ``to-double-floats`` (833).
    """
    spec = ParamSpec.from_params(params)
    if isinstance(params, Mapping):
        params = {_norm_key(k): v for k, v in params.items()}
        vec = jnp.asarray([float(params[k]) for k in spec.keys], dtype=dtype)
    else:
        vec = jnp.asarray(np.asarray(params, dtype=np.float64), dtype=dtype)
    return spec, vec


def map_params(fn, params: Mapping[str, Any]) -> dict[str, Any]:
    """Apply ``fn`` to every value (``map-plist``, mcmc-fitting.lisp:450)."""
    return {k: fn(v) for k, v in params.items()}


def scale_params(scale, params: Mapping[str, Any]) -> dict[str, Any]:
    """``scale-plist`` (mcmc-fitting.lisp:456)."""
    return map_params(lambda v: v * scale, params)


def reduce_params(fn, p1: Mapping[str, Any], p2: Mapping[str, Any]) -> dict[str, Any]:
    """Elementwise combine two param dicts by key (``reduce-plists``, 442)."""
    return {k: fn(v, p2[k]) for k, v in p1.items()}
