"""Serving samplers of the port."""
from .sampler import DeviceQmcStreams, ForestSampler, PooledForestSampler, QmcStreams

__all__ = ["DeviceQmcStreams", "ForestSampler", "PooledForestSampler", "QmcStreams"]
