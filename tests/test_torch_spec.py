"""The port's spec registry against the JAX package's, on the CPU.

* every name the port lists, and its smoke variant, resolves to the JAX
  spec's ``to_dict()`` exactly, so a ``forecaster.json`` written by one
  package describes the same forecaster in the other;
* overrides route by field name (model fields into ``model``), unknown
  fields and heads raise;
* every head of the reference resolves: ``esn-<freq>``, ``ssm-<freq>`` and
  ``head=esn|ssm`` on any spec, each to the JAX spec's dict;
* ``to_dict``/``from_dict`` round-trip across the two packages.
"""

import json

import pytest

from repro.forecast import spec as jspec
from repro_torch.forecast import spec as tspec

NAMES = tspec.list_specs()


def test_registry_lists_the_port_heads():
    assert NAMES == jspec.list_specs()
    assert NAMES[:4] == ["esrnn-yearly", "esrnn-quarterly", "esrnn-monthly", "esrnn-hourly"]
    assert [n for n in NAMES if n.endswith("-quarterly")] == [
        "esrnn-quarterly", "esn-quarterly", "ssm-quarterly"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_spec_dict_equals_jax(name, smoke):
    get_j = jspec.get_smoke_spec if smoke else jspec.get_spec
    get_t = tspec.get_smoke_spec if smoke else tspec.get_spec
    assert get_t(name).to_dict() == get_j(name).to_dict()
    over = dict(hidden_size=16, n_steps=7, precision="bf16", sparse_adam=True)
    assert get_t(name, **over).to_dict() == get_j(name, **over).to_dict()


@pytest.mark.parametrize("alias,name", [("m4-quarterly", "esrnn-quarterly"),
                                        ("monthly", "esrnn-monthly")])
def test_aliases_resolve(alias, name):
    assert tspec.get_spec(alias) == tspec.get_spec(name)
    assert tspec.get_spec(alias).to_dict() == jspec.get_spec(alias).to_dict()


def test_overrides_route_by_field():
    s = tspec.get_spec("esrnn-quarterly", hidden_size=64, n_steps=5,
                       dilations=[[1, 2], [4, 8]], hw_lr=0.05)
    assert s.model.hidden_size == 64 and s.n_steps == 5 and s.hw_lr == 0.05
    assert s.model.dilations == ((1, 2), (4, 8))
    assert s.frequency == "quarterly" and s.horizon == 8
    assert s.replace(batch_size=8).model == s.model


def test_unknown_fields_and_heads_raise():
    with pytest.raises(TypeError, match="hiden_size"):
        tspec.get_spec("esrnn-quarterly", hiden_size=64)
    with pytest.raises(KeyError, match="unknown forecast spec"):
        tspec.get_spec("esrnn-weekly")
    with pytest.raises(KeyError, match="unknown forecasting head"):
        tspec.get_spec("esrnn-quarterly", head="gru")


@pytest.mark.parametrize("head", ["esn", "ssm"])
def test_head_overrides_resolve_as_jax(head):
    by_name = tspec.get_spec(f"{head}-quarterly")
    assert by_name.model.head == head and by_name.name == f"{head}-quarterly"
    assert tspec.get_spec("esrnn-quarterly", head=head) == by_name
    assert by_name.to_dict() == jspec.get_spec("esrnn-quarterly", head=head).to_dict()
    smoke = tspec.get_smoke_spec("esrnn-monthly").replace(head=head)
    assert smoke.to_dict() == jspec.get_smoke_spec("esrnn-monthly").replace(head=head).to_dict()


@pytest.mark.parametrize("name", NAMES)
def test_dicts_load_across_packages(name):
    j = jspec.get_smoke_spec(name, attention=True, scan_steps=4)
    t = tspec.ForecastSpec.from_dict(json.loads(json.dumps(j.to_dict())))
    assert t.to_dict() == j.to_dict()
    back = jspec.ForecastSpec.from_dict(json.loads(json.dumps(t.to_dict())))
    assert back == j
