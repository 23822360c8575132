"""Training data: the radix-forest corpus mixture and the synthetic
token pipeline."""
from .mixture import MixtureSampler
from .pipeline import SyntheticCorpus, make_batch

__all__ = ["MixtureSampler", "SyntheticCorpus", "make_batch"]
