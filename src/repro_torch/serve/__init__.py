"""Serving of the port: the engine and its samplers."""
from .engine import Request, ServeEngine
from .sampler import (
    DeviceQmc2Streams,
    DeviceQmcStreams,
    ForestSampler,
    PooledForestSampler,
    Qmc2Streams,
    QmcStreams,
    SpatialSampler,
    TokenSampler,
    restore_streams,
)

__all__ = [
    "DeviceQmc2Streams",
    "DeviceQmcStreams",
    "ForestSampler",
    "PooledForestSampler",
    "Qmc2Streams",
    "QmcStreams",
    "Request",
    "ServeEngine",
    "SpatialSampler",
    "TokenSampler",
    "restore_streams",
]
