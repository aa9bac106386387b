"""The port's forecasting API: spec registry, estimator, batched + online serving.

    from repro_torch.forecast import ESRNNForecaster, get_spec

    f = ESRNNForecaster("esrnn-quarterly").fit()        # on the card
    f.predict(); f.evaluate(); f.backtest(); f.save("/tmp/fq")

CLI: ``python -m repro_torch.launch.forecast {specs|fit|predict|eval|backtest|serve|observe}``.

Submodules are imported lazily (PEP 562), as in the JAX package, so that
importing the spec registry does not pull in the trainer and the server.
"""

from __future__ import annotations

from repro_torch.forecast.spec import ForecastSpec, get_smoke_spec, get_spec, list_specs

__all__ = [
    "ForecastSpec", "get_spec", "get_smoke_spec", "list_specs",
    "ESRNNForecaster", "NotFittedError",
    "BucketDispatcher", "ForecastRequest", "ServeStats", "synthetic_request_stream",
    "CompileBudgetExceeded", "check_compile_budget",
    "ForecastServer", "ServerConfig", "ObserveWrite",
]

_LAZY = {
    "ESRNNForecaster": "repro_torch.forecast.estimator",
    "NotFittedError": "repro_torch.forecast.estimator",
    "BucketDispatcher": "repro_torch.forecast.serving",
    "ForecastRequest": "repro_torch.forecast.serving",
    "ServeStats": "repro_torch.forecast.serving",
    "synthetic_request_stream": "repro_torch.forecast.serving",
    "CompileBudgetExceeded": "repro_torch.forecast.serving",
    "check_compile_budget": "repro_torch.forecast.serving",
    "ForecastServer": "repro_torch.forecast.server",
    "ServerConfig": "repro_torch.forecast.server",
    "ObserveWrite": "repro_torch.forecast.server",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
