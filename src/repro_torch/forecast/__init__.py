"""Forecast serving of the port: bucketed dispatch and the online server."""

from repro_torch.forecast.serving import (
    BucketDispatcher, ForecastRequest, ServeStats, synthetic_request_stream,
)

__all__ = [
    "BucketDispatcher",
    "ForecastRequest",
    "ServeStats",
    "synthetic_request_stream",
]
