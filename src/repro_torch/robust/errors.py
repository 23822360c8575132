"""Structured error taxonomy for the serving robustness layer (the port's
copy of the JAX package's ``robust/errors.py``; numpy-free, torch-free).

Every class below subclasses :class:`ValueError` so existing callers (and
tests) that catch ``ValueError`` keep working; new callers can match on the
class or on the machine-readable ``code`` attribute instead of parsing
messages.  The admission codes mirror the ways a weight row can violate the
forest invariants (a monotone CDF needs finite, non-negative mass with a
positive total that survives the f64 normalize):

==================  ==========================================================
code                meaning
==================  ==========================================================
``bad_dtype``       weights not coercible to a real float array
``bad_shape``       weights not a non-empty 1-D vector
``non_finite``      NaN or +/-Inf entries
``negative``        negative entries (even with a positive total — these
                    silently produced a clipped, index-0-biased CDF before)
``zero_total``      all entries zero (or total underflows to zero)
``overflow_on_pad`` entries finite but the f64 total overflows to Inf
``stale_handle``    handle's version does not match the arena row (evicted
                    or recycled)
``quarantined``     handle admitted under the ``quarantine`` policy; serving
                    a placeholder, refusing individual drains
``bad_request``     malformed ``serve.Request`` (submit-time validation)
==================  ==========================================================
"""
from __future__ import annotations

__all__ = [
    "ServingError",
    "AdmissionError",
    "WeightDtypeError",
    "WeightShapeError",
    "NonFiniteWeightError",
    "NegativeWeightError",
    "ZeroTotalError",
    "OverflowOnPadError",
    "StaleHandleError",
    "QuarantinedError",
    "RequestError",
]


class ServingError(ValueError):
    """Base of the serving-robustness taxonomy (a ``ValueError``)."""

    code: str = "serving"


class AdmissionError(ServingError):
    """A weight row violated an admission invariant."""

    code = "admission"


class WeightDtypeError(AdmissionError):
    code = "bad_dtype"


class WeightShapeError(AdmissionError):
    code = "bad_shape"


class NonFiniteWeightError(AdmissionError):
    code = "non_finite"


class NegativeWeightError(AdmissionError):
    code = "negative"


class ZeroTotalError(AdmissionError):
    code = "zero_total"


class OverflowOnPadError(AdmissionError):
    code = "overflow_on_pad"


class StaleHandleError(ServingError):
    """Handle version mismatch: the row was evicted or recycled."""

    code = "stale_handle"


class QuarantinedError(ServingError):
    """Operation refused because the handle is quarantined."""

    code = "quarantined"


class RequestError(ServingError):
    """Malformed ``serve.Request`` caught at submit/admit time."""

    code = "bad_request"


_BY_CODE = {
    "bad_dtype": WeightDtypeError,
    "bad_shape": WeightShapeError,
    "non_finite": NonFiniteWeightError,
    "negative": NegativeWeightError,
    "zero_total": ZeroTotalError,
    "overflow_on_pad": OverflowOnPadError,
    "stale_handle": StaleHandleError,
    "quarantined": QuarantinedError,
    "bad_request": RequestError,
}


def error_for(code: str, msg: str) -> ServingError:
    """Instantiate the taxonomy class for ``code`` with message ``msg``."""
    return _BY_CODE.get(code, ServingError)(msg)
