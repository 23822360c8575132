"""Validated admission for the port's pool: the weight-violation taxonomy
(:mod:`.errors`) and the per-pool ``reject | clamp | quarantine | off``
policy (:mod:`.validate`), numpy copies of the JAX package's modules."""
from .errors import (
    AdmissionError,
    NegativeWeightError,
    NonFiniteWeightError,
    OverflowOnPadError,
    QuarantinedError,
    RequestError,
    ServingError,
    StaleHandleError,
    WeightDtypeError,
    WeightShapeError,
    ZeroTotalError,
    error_for,
)
from .validate import POLICIES, check_policy, classify_weights, sanitize_weights

__all__ = [k for k in dir() if not k.startswith("_")]
