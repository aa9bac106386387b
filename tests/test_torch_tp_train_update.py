"""Sharded LM training: each leaf's update against the reference's.

The bf16 steps of ``tests/test_torch_tp_train_bf16.py`` at the Adam of
``tests/test_torch_lm_train_step.py`` whose step is about -(lr / eps) x the
mean gradient (lr 10, eps 1e3, no clip): each step's loss and the params
within rtol 2e-2 / atol 1e-3 of the reference's jitted one-device step, and
each leaf's update (params after 3 steps - init) within 2e-2 of the norm of
the reference's, on every mesh of the sessions.
"""

import pytest

from repro_torch.configs import ARCHS
from test_torch_tp_train_bf16 import check_against_the_reference, sessions

ADAM = "linear"


@pytest.fixture(scope="module")
def ranks():
    return sessions(ADAM)


@pytest.mark.parametrize("arch", ARCHS)
def test_update_follows_the_reference(ranks, arch):
    check_against_the_reference(ranks, arch, ADAM, update=True)
