"""2-D piecewise-constant serving: the paper's environment-map application
(a marginal over rows times a conditional per row) in bulk on one card.
Kernels on this path: ``cdf_scan``, ``forest_delta`` and
``forest_delta_update`` (builds and updates), ``forest_pack`` and
``forest_sample`` (the marginal), ``forest_sample_batched`` (the
conditionals)."""
from .map2d import Map2DSampler

__all__ = ["Map2DSampler"]
