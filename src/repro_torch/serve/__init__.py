"""Serving of the port: the engine and its samplers."""
from .engine import Request, ServeEngine
from .sampler import (
    DeviceQmcStreams,
    ForestSampler,
    PooledForestSampler,
    QmcStreams,
    TokenSampler,
)

__all__ = [
    "DeviceQmcStreams",
    "ForestSampler",
    "PooledForestSampler",
    "QmcStreams",
    "Request",
    "ServeEngine",
    "TokenSampler",
]
