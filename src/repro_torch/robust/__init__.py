"""The port's serving robustness layer, three pieces threaded through the
pool and serve stack (the JAX package's ``robust``):

1. **Validated admission** (:mod:`.errors`, :mod:`.validate`): the
   weight-violation taxonomy (``non_finite`` / ``negative`` /
   ``zero_total`` / ``overflow_on_pad``, every class a ``ValueError``) and
   the per-pool ``reject | clamp | quarantine | off`` policy.
2. **Snapshot/restore on disk** (:mod:`.snapshot`): :func:`save_serving` /
   :func:`load_serving` commit the components' ``snapshot()`` dicts
   atomically through :mod:`repro_torch.ckpt`, in the JAX package's
   format.
3. **Invariant checks and chaos** (:mod:`.verify`, :mod:`.faults`):
   ``verify_forest`` / ``verify_alias`` / ``verify_pool`` and the
   :class:`~repro_torch.robust.faults.FaultPlan` harness.

``faults`` is imported lazily (``from repro_torch.robust.faults import
...``): it reaches back into :mod:`repro_torch.pool`, which imports this
package's taxonomy.
"""
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
from .snapshot import load_serving, save_serving
from .validate import POLICIES, check_policy, classify_weights, sanitize_weights
from .verify import verify_alias, verify_forest, verify_pool

__all__ = [
    "AdmissionError",
    "NegativeWeightError",
    "NonFiniteWeightError",
    "OverflowOnPadError",
    "QuarantinedError",
    "RequestError",
    "ServingError",
    "StaleHandleError",
    "WeightDtypeError",
    "WeightShapeError",
    "ZeroTotalError",
    "POLICIES",
    "check_policy",
    "classify_weights",
    "error_for",
    "sanitize_weights",
    "verify_alias",
    "verify_forest",
    "verify_pool",
    "load_serving",
    "save_serving",
]
