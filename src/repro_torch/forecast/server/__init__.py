"""Continuous-batching forecast server with online HW state ingestion.

* :class:`~repro_torch.forecast.server.engine.ForecastServer` -- bounded
  request queue, deadline-driven bucket fill, batched dispatch on the card,
  ``observe`` write ingestion.
* :class:`~repro_torch.forecast.server.state.OnlineStateStore` -- host-side
  rolled Holt-Winters state per tracked series.
* :class:`~repro_torch.forecast.server.finetune.IdleFineTuner` -- sparse-Adam
  bursts on the freshest observed series when the queue drains.
"""

from repro_torch.forecast.server.finetune import IdleFineTuner
from repro_torch.forecast.server.engine import (
    ForecastFuture, ForecastServer, QueueFull, ServerConfig,
)
from repro_torch.forecast.server.state import (
    ObserveWrite, OnlineStateStore, SeriesState,
)

__all__ = [
    "ForecastFuture",
    "ForecastServer",
    "IdleFineTuner",
    "ObserveWrite",
    "OnlineStateStore",
    "QueueFull",
    "SeriesState",
    "ServerConfig",
]
