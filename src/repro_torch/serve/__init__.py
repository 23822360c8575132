"""Serving samplers of the port."""
from .sampler import ForestSampler, QmcStreams

__all__ = ["ForestSampler", "QmcStreams"]
