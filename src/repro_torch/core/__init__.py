"""Core library: radix tree forests for parallel discrete sampling."""
from .bits import DIST_SENTINEL, float_to_bits, xor_distance
from .cdf import (
    build_cdf,
    cdf_from_logits,
    lower_bounds,
    normalize_weights,
    np_build_cdf,
)
from .counting import (
    np_sample_binary_counting,
    np_sample_cutpoint_binary_counting,
    np_sample_forest_counting,
    table1_row,
    warp_cost,
)
from .forest import (
    INVALID,
    MAX_DEPTH,
    RadixForest,
    build_forest,
    build_forest_apetrei,
    build_forest_from_cdf,
    depth_stats,
    forest_from_cdf,
    forest_to_numpy,
    validate_forest,
)
from .forest2d import (
    RowForest,
    build_forest_rows,
    np_reference_rows,
    sample_forest_rows,
    validate_forest_rows,
)
from .metrics import (
    chi2_statistic,
    histogram,
    quadratic_error,
    star_discrepancy_1d,
    warped_uniformity_1d,
)
from .sample import (
    pack_forest,
    sample_binary,
    sample_cutpoint_binary,
    sample_cutpoint_linear,
    sample_forest,
    sample_forest_with_stats,
    sample_linear,
)

__all__ = [k for k in dir() if not k.startswith("_")]
