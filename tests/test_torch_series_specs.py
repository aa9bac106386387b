"""The port's series-mesh rules against ``repro.sharding.series`` on the CPU.

* ``esrnn_param_specs``: the port's per-group axis is ``series`` for exactly
  the groups whose every leaf the reference shards ``P("series")``, and
  ``None`` for the groups it replicates ``P()``, for the ESN, SSM and
  attention heads and the paper's own;
* ``check_series_divisible``: the same width returned for a batch that
  divides the mesh and the same error text for one that does not.

The reference module is imported once, here, with the one warning that the
installed jax raises for its ``jax.experimental.shard_map`` import ignored
(ROADMAP F8: the pytest settings make it an error). Jax warns for that name
only once per process, so after this import every later import of the
module in the process, the reference's own tests' too, goes through.
"""

import warnings

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.core import esrnn as jes
from repro_torch.convert import params_from_numpy
from repro_torch.sharding import series as S

with warnings.catch_warnings():
    warnings.filterwarnings("ignore", message=r"jax\.experimental\.shard_map is deprecated",
                            category=DeprecationWarning)
    from repro.sharding import series as JS


HEADS = [dict(), dict(attention=True), dict(head="esn"), dict(head="ssm")]


@pytest.mark.parametrize("over", HEADS, ids=["paper", "attention", "esn", "ssm"])
def test_param_specs_match_reference(over):
    cfg = jes.make_config("quarterly", hidden_size=8, **over)
    jparams = jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(0), cfg, 4))
    want = JS.esrnn_param_specs(jparams)
    got = S.esrnn_param_specs(params_from_numpy(jparams, "cpu"))
    assert set(got) == set(want) and "hw" in got and len(got) > 1
    for group, spec in want.items():
        leaves = jax.tree_util.tree_leaves(spec, is_leaf=lambda x: isinstance(x, P))
        assert leaves, group
        axis = set(leaves)
        assert axis in ({P(S.SERIES_AXIS)}, {P()}), (group, axis)
        assert got[group] == (S.SERIES_AXIS if axis == {P(S.SERIES_AXIS)} else None), group
    assert S.SERIES_AXIS == JS.SERIES_AXIS


class _PortMesh:
    axis_names = (S.SERIES_AXIS,)

    def __init__(self, size):
        self.size = size


class _ReferenceMesh:
    axis_names = (JS.SERIES_AXIS,)

    def __init__(self, size):
        self.devices = np.empty((size,), dtype=object)


@pytest.mark.parametrize("n,d", [(5, 1), (16, 8), (12, 8), (15, 2), (8, 4)])
def test_divisibility_guard_matches_reference(n, d):
    try:
        want = JS.check_series_divisible(n, _ReferenceMesh(d))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            S.check_series_divisible(n, _PortMesh(d))
        assert str(got.value) == str(e) and "does not divide" in str(e)
    else:
        assert S.check_series_divisible(n, _PortMesh(d)) == want == d
