"""Series data parallelism and the LM's partition rules on ``torch.distributed``.

* :mod:`repro_torch.sharding.series` -- the series mesh, its counted
  collectives and the sharded loss, forecast, stats, eval and backtest;
* :mod:`repro_torch.sharding.ranks` -- :func:`run_ranks`, which spawns the
  ranks of a mesh, and the backend rule;
* :mod:`repro_torch.sharding.specs` -- the LM's and ES-RNN's partition
  rules (params, optimizer state, caches, batches);
* :mod:`repro_torch.sharding.ctx` -- the activation-sharding context that
  carries the LM mesh to model code;
* :mod:`repro_torch.sharding.tp` -- the rank-local serving plan
  (:func:`~repro_torch.sharding.tp.shard_lm_params`).

The names below load their module on first use: the model modules import
``ctx`` and ``tp``, and ``series`` imports the ES-RNN core, which imports
the models.
"""

import importlib

_EXPORTS = {
    "choose_backend": "ranks", "run_ranks": "ranks",
    "SERIES_AXIS": "series", "SeriesMesh": "series", "check_series_divisible": "series",
    "esrnn_backtest_dp": "series", "esrnn_eval_dp": "series", "esrnn_forecast_dp": "series",
    "esrnn_loss_and_grad_dp": "series", "esrnn_loss_dp": "series",
    "esrnn_param_specs": "series", "esrnn_predict_stats_dp": "series",
    "make_series_mesh": "series",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
