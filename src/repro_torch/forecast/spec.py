"""ForecastSpec: the single registry behind the forecasting API (PyTorch port).

Counterpart of ``repro.forecast.spec``, field for field: one name resolves
the full recipe -- the model hyperparameters (``core.esrnn.PRESETS``), the
data preparation, and the two-group training setup (per-series
Holt-Winters vs shared-RNN learning rates, Smyl's joint training) -- and a
spec's ``to_dict()`` is the JAX package's, so a ``forecaster.json`` written
by either package loads in the other.

    spec = get_spec("esrnn-quarterly", n_steps=500, hidden_size=64)
    smoke = get_smoke_spec("esrnn-quarterly")

Override kwargs are routed by field name: ``ESRNNConfig`` fields go into the
nested model config, everything else into the spec itself. The registry
lists every head the port has, as the reference does: ``esrnn-<freq>`` (the
paper's lstm head), ``esn-<freq>`` and ``ssm-<freq>``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.esrnn import ESRNNConfig, make_config
from repro_torch.core.heads import available_heads, get_head

_MODEL_FIELDS = {f.name for f in dataclasses.fields(ESRNNConfig)} - {"name"}


@dataclasses.dataclass(frozen=True)
class ForecastSpec:
    """Everything needed to fit / predict / eval / serve one forecaster."""

    name: str                        # registry name, e.g. "esrnn-quarterly"
    model: ESRNNConfig

    # -- data preparation (paper section 5) --------------------------------
    data_scale: float = 0.01         # fraction of the Table-2 series counts
    data_seed: int = 0
    min_length: Optional[int] = None # None -> pipeline.MIN_LENGTH[frequency]
    variable_length: bool = False    # section 8.1 left-pad + mask path

    # -- joint two-group training (paper section 3.2) ----------------------
    batch_size: int = 256
    n_steps: int = 300
    rnn_lr: float = 1e-3             # shared RNN / head / attention weights
    hw_lr: float = 1e-2              # per-series Holt-Winters parameters
                                     # (Smyl: ~10x the shared-weight lr)
    clip_norm: Optional[float] = 20.0
    seed: int = 0
    eval_every: int = 50
    ckpt_every: int = 50
    keep: int = 3
    smoke: bool = False
    scan_steps: int = 1              # steps per superstep (1 = per-step);
                                     # eval/ckpt/hooks fire at superstep
                                     # boundaries, same absolute steps
    sparse_adam: bool = False        # segment per-series Adam: touch only
                                     # the batch's HW rows

    # -- multi-device scaling --
    data_parallel: int = 0           # ranks to shard the series axis over
    series_chunk: int = 0            # > 0: out-of-core chunked fit/predict

    @property
    def frequency(self) -> str:
        return self.model.name

    @property
    def horizon(self) -> int:
        return self.model.output_size

    @property
    def use_pallas(self) -> bool:
        """The JAX package's kernel switch, kept so that specs match; the
        port dispatches by device and ignores it."""
        return self.model.use_pallas

    def replace(self, **overrides) -> "ForecastSpec":
        """Override by field name; model-config fields route into ``model``.

        Unknown names raise (naming every valid spec and model field) rather
        than being silently dropped.
        """
        model_kw = {k: v for k, v in overrides.items() if k in _MODEL_FIELDS}
        spec_kw = {k: v for k, v in overrides.items() if k not in _MODEL_FIELDS}
        spec_fields = {f.name for f in dataclasses.fields(ForecastSpec)}
        unknown = [k for k in spec_kw if k not in spec_fields]
        if unknown:
            raise TypeError(
                f"unknown ForecastSpec override(s): {sorted(unknown)}; "
                f"valid spec fields: {sorted(spec_fields - {'model'})}; "
                f"valid model fields: {sorted(_MODEL_FIELDS)}")
        if "head" in model_kw:
            get_head(model_kw["head"])
        spec = self
        if model_kw:
            if isinstance(model_kw.get("dilations"), list):
                model_kw["dilations"] = tuple(tuple(d) for d in model_kw["dilations"])
            spec = dataclasses.replace(
                spec, model=dataclasses.replace(spec.model, **model_kw))
        if spec_kw:
            spec = dataclasses.replace(spec, **spec_kw)
        return spec

    # -- serialization (estimator save/load) --------------------------------

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["model"]["dilations"] = [list(g) for g in self.model.dilations]
        return d

    @staticmethod
    def from_dict(d: Dict) -> "ForecastSpec":
        model_kw = dict(d["model"])
        model_kw["dilations"] = tuple(tuple(g) for g in model_kw["dilations"])
        spec_kw = {k: v for k, v in d.items() if k != "model"}
        return ForecastSpec(model=ESRNNConfig(**model_kw), **spec_kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# Frequency -> spec-level defaults beyond the shared dataclass defaults.
_FREQ_SPECS: Dict[str, Dict] = {
    "yearly": dict(),
    "quarterly": dict(),
    "monthly": dict(),
    "hourly": dict(batch_size=64, data_scale=0.05),
}

# Registry prefix -> head registry name. ``esrnn-`` (and the launcher-facing
# ``m4-`` alias, and a bare frequency) is the paper's lstm head; every other
# head in ``repro_torch.core.heads`` gets its own ``<head>-<freq>`` family.
_PREFIX_HEADS: Dict[str, str] = {"esrnn": "lstm", "m4": "lstm"}

# Per-frequency smoke shrinkage: tiny model + tiny run, same code paths.
_SMOKE_OVERRIDES = dict(
    data_scale=0.002, batch_size=16, n_steps=20, eval_every=10,
    ckpt_every=10, hidden_size=8, smoke=True,
)


def _canonical_name(head: str, freq: str) -> str:
    return f"{'esrnn' if head == 'lstm' else head}-{freq}"


def list_specs() -> List[str]:
    """Every registry name: ``esrnn-<freq>`` plus ``<head>-<freq>`` per head."""
    names = [f"esrnn-{freq}" for freq in _FREQ_SPECS]
    for head in available_heads():
        if head == "lstm":
            continue
        names.extend(f"{head}-{freq}" for freq in _FREQ_SPECS)
    return names


def get_spec(name: str, **overrides) -> ForecastSpec:
    """Resolve a registry name (+ optional overrides) into a ForecastSpec.

    Accepts ``esrnn-<freq>`` / ``m4-<freq>`` / a bare frequency (the paper's
    lstm head), or ``<head>-<freq>`` for any other registered head.
    """
    head = "lstm"
    freq = name
    prefix, dash, rest = name.partition("-")
    if dash and rest in _FREQ_SPECS:
        if prefix in _PREFIX_HEADS:
            head, freq = _PREFIX_HEADS[prefix], rest
        elif prefix in available_heads():
            head, freq = prefix, rest
    if freq not in _FREQ_SPECS:
        raise KeyError(
            f"unknown forecast spec {name!r}; available: {list_specs()}")
    if "head" in overrides:      # --set head=... canonicalizes the name too
        head = overrides["head"]
        get_head(head)
    spec = ForecastSpec(
        name=_canonical_name(head, freq),
        model=make_config(freq, head=head), **_FREQ_SPECS[freq])
    return spec.replace(**overrides) if overrides else spec


def get_smoke_spec(name: str, **overrides) -> ForecastSpec:
    """Smoke variant: same pipeline end-to-end, seconds on CPU."""
    return get_spec(name).replace(**{**_SMOKE_OVERRIDES, **overrides})
