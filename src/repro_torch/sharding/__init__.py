"""Series data parallelism on ``torch.distributed``.

* :mod:`repro_torch.sharding.series` -- the series mesh, its counted
  collectives and the sharded loss, forecast, stats, eval and backtest;
* :mod:`repro_torch.sharding.ranks` -- :func:`run_ranks`, which spawns the
  ranks of a mesh, and the backend rule.
"""

from repro_torch.sharding.ranks import choose_backend, run_ranks
from repro_torch.sharding.series import (
    SERIES_AXIS, SeriesMesh, check_series_divisible, esrnn_backtest_dp,
    esrnn_eval_dp, esrnn_forecast_dp, esrnn_loss_and_grad_dp, esrnn_loss_dp,
    esrnn_param_specs, esrnn_predict_stats_dp, make_series_mesh,
)

__all__ = [
    "SERIES_AXIS", "SeriesMesh", "check_series_divisible", "choose_backend",
    "esrnn_backtest_dp", "esrnn_eval_dp", "esrnn_forecast_dp",
    "esrnn_loss_and_grad_dp", "esrnn_loss_dp", "esrnn_param_specs",
    "esrnn_predict_stats_dp", "make_series_mesh", "run_ranks",
]
