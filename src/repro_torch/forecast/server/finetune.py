"""Idle-triggered incremental fine-tune: a few sparse-Adam steps on live series.

Port of ``repro.forecast.server.finetune``. When the server's queue drains,
:class:`IdleFineTuner` assembles a small batch from the most recently
observed *known* series (cold-start series have no fitted row to tune),
runs a handful of training steps through the same loss and sparse
per-series Adam as the offline trainer
(:func:`repro_torch.train.engine.make_online_step_fn`), and hands the
updated params back. Only the touched HW rows and the shared network move.
On the card every step runs the training kernels (K1, K2, K4, K5).

* The batch is padded to a fixed ``window`` (left-pad + mask, the
  section-8.1 convention), so every burst has one shape per batch fill.
* The tuner owns a copy of the params on its device and updates it in place;
  the Adam state (with its ``t_hw`` row clocks) persists across bursts.
* After a burst the caller installs the returned params in the dispatcher
  and refreshes the store rows :meth:`IdleFineTuner.run` returns.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import copy_params
from repro_torch.core.esrnn import ESRNNConfig
from repro_torch.core.heads import frozen_param_groups
from repro_torch.device import resolve_device
from repro_torch.train.engine import make_online_step_fn, split_frozen
from repro_torch.train.optimizer import AdamConfig, adam_init_sparse

log = logging.getLogger("repro_torch.forecast.server")


class IdleFineTuner:
    """Sparse-Adam burst trainer over the online store's freshest series.

    ``steps`` training steps per :meth:`run`, batching up to ``batch``
    recently observed known series on a fixed ``window``. ``lr`` drives the
    shared network; ``hw_lr_ratio`` scales the per-series group. ``device``
    defaults to the card.
    """

    def __init__(
        self,
        config: ESRNNConfig,
        params,
        *,
        steps: int = 2,
        batch: int = 32,
        window: int = 64,
        lr: float = 1e-4,
        hw_lr_ratio: float = 10.0,
        min_history: Optional[int] = None,
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.steps = int(steps)
        self.batch = int(batch)
        self.window = int(window)
        # a training window must cover at least one full input+output span
        floor = config.input_size + config.output_size
        self.min_history = int(min_history if min_history is not None
                               else min(floor, self.window))
        self.cfg_adam = AdamConfig(
            lr=lr, group_lr={"per_series": hw_lr_ratio}, schedule="constant")
        frozen = frozen_param_groups(config)
        self.params = copy_params(params, self.device)
        self.opt_state = adam_init_sparse(split_frozen(self.params, frozen)[0])
        self._step = make_online_step_fn(config, self.cfg_adam, frozen=frozen)
        self.last_loss: Optional[float] = None

    def build_batch(
        self, store, n_known: int,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """(y, cats, mask, rows) over the freshest eligible series, or None.

        Histories are clipped to the most recent ``window`` observations and
        left-padded (first value, mask 0) to the fixed window.
        """
        states = store.recently_observed(
            rows_below=n_known, min_history=self.min_history)[:self.batch]
        if not states:
            return None
        b = len(states)
        y = np.empty((b, self.window), np.float32)
        mask = np.zeros((b, self.window), np.float32)
        cats = np.zeros((b, self.config.n_categories), np.float32)
        rows = np.empty((b,), np.int64)
        for i, st in enumerate(states):
            h = st.history_array()[-self.window:]
            y[i, :self.window - len(h)] = h[0]
            y[i, self.window - len(h):] = h
            mask[i, self.window - len(h):] = 1.0
            if 0 <= st.category < self.config.n_categories:
                cats[i, st.category] = 1.0
            rows[i] = st.row
        return y, cats, mask, rows

    def run(self, store, n_known: int):
        """One idle burst: returns ``(params, touched_rows)``.

        ``params`` is the tuner's own tree, updated in place (unchanged, and
        ``touched_rows`` empty, when no series is eligible). The caller
        propagates it to the dispatcher and refreshes the store rows.
        """
        built = self.build_batch(store, n_known)
        if built is None:
            return self.params, []
        to_dev = lambda a: torch.from_numpy(a).to(self.device)
        y, cats, mask, rows = (to_dev(a) for a in built)
        loss = None
        for _ in range(self.steps):
            self.params, self.opt_state, loss = self._step(
                self.params, self.opt_state, y, cats, mask, rows)
        self.last_loss = float(loss)
        log.debug("idle fine-tune: %d series x %d steps, loss %.5f",
                  len(built[3]), self.steps, self.last_loss)
        return self.params, [int(r) for r in built[3]]
