"""Weight admission: classify and sanitize rows at the serving boundary
(the port's numpy copy of the JAX package's ``robust/validate.py``).

Policy semantics (per pool / per map / per engine):

- ``reject`` (default): any violation raises the matching
  :mod:`repro_torch.robust.errors` class.  Nothing bad ever reaches an arena row.
- ``clamp``: repair in a fixed order — NaN -> 0, +Inf -> f32 max, -Inf -> 0,
  negatives -> 0 — then, if the repaired total is zero (or the finite total
  overflows), substitute the uniform placeholder ``ones(n)``.  The repaired
  row is what gets admitted; the caller learns nothing failed.
- ``quarantine``: admit a uniform placeholder row instead of the bad
  payload and flag the handle; co-tenants in the same packed arena batch are
  untouched and individual drains of the quarantined handle raise
  :class:`~repro_torch.robust.errors.QuarantinedError`.
- ``off``: skip validation entirely (benchmark witness for guard overhead;
  never use in serving).

``bad_dtype``/``bad_shape`` violations raise under every policy — there is
no finite row of the right length to repair toward.
"""
from __future__ import annotations

import numpy as np

from .errors import (
    NegativeWeightError,
    NonFiniteWeightError,
    OverflowOnPadError,
    WeightDtypeError,
    WeightShapeError,
    ZeroTotalError,
    error_for,
)

__all__ = ["POLICIES", "classify_weights", "sanitize_weights", "check_policy"]

POLICIES = ("reject", "clamp", "quarantine", "off")

_F32_MAX = float(np.finfo(np.float32).max)


def check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(f"unknown admission policy {policy!r}; want one of {POLICIES}")
    return policy


def _coerce(w) -> np.ndarray:
    """Coerce to a 1-D non-empty float64 vector or raise (any policy)."""
    try:
        arr = np.asarray(w, dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise WeightDtypeError(f"weights not coercible to float: {e}") from None
    if arr.ndim != 1 or arr.size == 0:
        raise WeightShapeError(
            f"weights must be a non-empty 1-D vector, got shape {arr.shape}"
        )
    return arr


def classify_weights(w, *, allow_zero_total: bool = False):
    """Return ``(arr, code)``: the coerced f64 row and its violation code.

    ``code`` is ``None`` for an admissible row, else one of ``non_finite`` /
    ``negative`` / ``overflow_on_pad`` / ``zero_total``.  Dtype/shape
    violations raise immediately (no policy can repair them).  With
    ``allow_zero_total`` a zero-mass row classifies clean — the spatial map
    treats zero-mass rows as exactly unselectable, not as errors.
    """
    arr = _coerce(w)
    if not np.isfinite(arr).all():
        return arr, "non_finite"
    if (arr < 0.0).any():
        return arr, "negative"
    total = float(np.sum(arr))
    if not np.isfinite(total):
        return arr, "overflow_on_pad"
    if total <= 0.0:
        return arr, None if allow_zero_total else "zero_total"
    return arr, None


def _repair(arr: np.ndarray) -> np.ndarray:
    out = np.where(np.isnan(arr), 0.0, arr)
    out = np.where(out == np.inf, _F32_MAX, out)
    out = np.where(out < 0.0, 0.0, out)
    total = float(np.sum(out))
    if not np.isfinite(total) or total <= 0.0:
        return np.ones(arr.shape[0], dtype=np.float64)
    return out


def sanitize_weights(w, policy: str = "reject", *, allow_zero_total: bool = False):
    """Admit ``w`` under ``policy``; return ``(row_f64, quarantined: bool)``.

    - clean row: returned as-is (f64), ``quarantined=False``;
    - ``reject``: raises the taxonomy class for the violation;
    - ``clamp``: returns the repaired row, ``quarantined=False``;
    - ``quarantine``: returns the uniform placeholder, ``quarantined=True``;
    - ``off``: returns the coerced row unchecked.
    """
    check_policy(policy)
    if policy == "off":
        return _coerce(w), False
    arr, code = classify_weights(w, allow_zero_total=allow_zero_total)
    if code is None:
        return arr, False
    if policy == "reject":
        raise error_for(code, f"weights rejected ({code}) for n={arr.shape[0]} row")
    if policy == "clamp":
        return _repair(arr), False
    return np.ones(arr.shape[0], dtype=np.float64), True


# Re-exported for callers that want to raise a specific class directly.
_ = (
    NonFiniteWeightError,
    NegativeWeightError,
    ZeroTotalError,
    OverflowOnPadError,
)
