"""Mesh construction for the port's launchers.

The ES-RNN series mesh lives in :mod:`repro_torch.sharding.series` and is
re-exported here, as the reference does. The reference's LM meshes
(``make_production_mesh``, ``make_host_mesh``) come with the LM stack.
"""

from repro_torch.sharding.series import make_series_mesh

__all__ = ["make_series_mesh"]
