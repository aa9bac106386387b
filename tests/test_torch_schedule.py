"""The port's chunk-major schedule and host-table init against the JAX package's.

``repro_torch.data.pipeline`` copies the out-of-core fit's schedule from
``repro.data.pipeline``: every function must give the reference's arrays
exactly (``np.array_equal``), ragged tails, resumes mid-visit and several
epochs included, and the chunk permutations share the epoch permutations'
byte-bounded cache. ``hw_init_host`` gives ``hw_init_params``'s primer bit
for bit, and a fresh streaming ``HostStateTable`` holds it with zero
moments and clocks.
"""

import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro.train import host_table as jtable
from repro_torch.core.holt_winters import hw_init_params
from repro_torch.data import pipeline as tpipe
from repro_torch.train import host_table as ttable

# (n_series, chunk, batch, seed, start_step, n_steps): one chunk, an even
# cut, ragged tails (a tail shorter than the batch), a chunk larger than N,
# resumes mid-visit and runs across several epochs
CASES = [
    (19, 16, 8, 0, 0, 24),
    (19, 16, 8, 3, 12, 24),
    (64, 16, 8, 1, 0, 40),
    (100, 32, 12, 2, 5, 61),
    (37, 8, 16, 7, 3, 50),
    (10, 64, 4, 0, 0, 9),
    (1000, 256, 64, 5, 17, 90),
]


def _visits(mod, n, chunk, batch, seed, start, steps):
    return list(mod.chunk_visit_plan(n, chunk, batch, start, steps, seed=seed))


@pytest.mark.parametrize("n,chunk,batch,seed,start,steps", CASES)
def test_chunk_schedule_matches_jax(n, chunk, batch, seed, start, steps):
    assert tpipe.chunk_bounds(n, chunk) == jpipe.chunk_bounds(n, chunk)
    assert tpipe.chunk_layout(n, chunk, batch) == jpipe.chunk_layout(n, chunk, batch)
    n_chunks = len(jpipe.chunk_bounds(n, chunk))
    for epoch in range(3):
        np.testing.assert_array_equal(tpipe.chunk_visit_order(n_chunks, epoch, seed),
                                      jpipe.chunk_visit_order(n_chunks, epoch, seed))
    got = _visits(tpipe, n, chunk, batch, seed, start, steps)
    want = _visits(jpipe, n, chunk, batch, seed, start, steps)
    assert [dataclasses.astuple(v) for v in got] == [dataclasses.astuple(v) for v in want]
    assert sum(v.n_steps for v in got) == steps - start
    for v in got:
        rows = v.hi - v.lo
        np.testing.assert_array_equal(
            tpipe.chunk_permutation(rows, v.epoch, v.chunk_id, seed),
            jpipe.chunk_permutation(rows, v.epoch, v.chunk_id, seed))
        sched = tpipe.chunk_batch_schedule(rows, v.batch_size, v.epoch, v.chunk_id,
                                           v.start_k, v.n_steps, seed=seed)
        np.testing.assert_array_equal(
            sched, jpipe.chunk_batch_schedule(rows, v.batch_size, v.epoch, v.chunk_id,
                                              v.start_k, v.n_steps, seed=seed))
        assert sched.shape == (v.n_steps, v.batch_size) and sched.max() < rows
        np.testing.assert_array_equal(
            tpipe.chunk_batch_indices(rows, v.batch_size, v.epoch, v.chunk_id, v.start_k,
                                      seed=seed),
            jpipe.chunk_batch_indices(rows, v.batch_size, v.epoch, v.chunk_id, v.start_k,
                                      seed=seed))
    assert tpipe.chunk_batch_schedule(5, 4, 0, 0, 0, 0).shape == (0, 4)


@pytest.mark.parametrize("n,chunk,batch,seed,start,steps", CASES[:3])
def test_resume_replays_the_unbroken_schedule(n, chunk, batch, seed, start, steps):
    """A plan started at any step is the tail of the plan started at 0."""
    def steps_of(first):
        out = []
        for v in tpipe.chunk_visit_plan(n, chunk, batch, first, steps, seed=seed):
            sched = v.lo + tpipe.chunk_batch_schedule(
                v.hi - v.lo, v.batch_size, v.epoch, v.chunk_id, v.start_k, v.n_steps,
                seed=seed)
            out += [tuple(row) for row in sched]
        return out

    whole = steps_of(0)
    for first in (1, start, steps // 2, steps - 1):
        assert steps_of(first) == whole[first:]


def test_chunk_permutations_share_the_cache_budget():
    cache = tpipe._perm_cache
    cache.clear()
    a = tpipe.chunk_permutation(50, 0, 1, seed=4)
    b = tpipe.chunk_permutation(50, 0, 1, seed=4)
    assert a is b and not a.flags.writeable
    tpipe.epoch_permutation(50, 0, seed=4)
    assert cache.misses == 2 and cache.hits == 1
    assert cache.nbytes == a.nbytes * 2            # one budget for both kinds
    # different (epoch, chunk) streams, and not the global permutation's
    assert not np.array_equal(a, tpipe.chunk_permutation(50, 0, 2, seed=4))
    assert not np.array_equal(a, tpipe.epoch_permutation(50, 0, seed=4))
    with pytest.raises(ValueError, match="positive"):
        tpipe.chunk_bounds(10, 0)
    cache.clear()


@pytest.mark.parametrize("n,m,m2", [(7, 4, 0), (5, 1, 0), (3, 24, 168)])
def test_hw_init_host_matches(n, m, m2):
    got = ttable.hw_init_host(n, m, seasonality2=m2)
    want = jtable.hw_init_host(n, m, seasonality2=m2)
    torch_init = hw_init_params(n, m, seasonality2=m2, device="cpu")
    for f in dataclasses.fields(got):
        g, w, t = getattr(got, f.name), getattr(want, f.name), getattr(torch_init, f.name)
        assert (g is None) == (w is None) == (t is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, t.numpy())
            assert g.dtype == np.float32


def test_fresh_table_holds_the_primer_and_zero_state():
    table = ttable.HostStateTable.init(6, 4, device="cpu")
    want = jtable.HostStateTable.init(6, 4)
    assert table.has_moments and table.n_rows == 6
    assert table.nbytes() == want.nbytes()
    for f in dataclasses.fields(table.hw):
        for mine, ref in ((table.hw, want.hw), (table.mu_hw, want.mu_hw),
                          (table.nu_hw, want.nu_hw)):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(table.t_hw.numpy(), want.t_hw)
    assert table.mu_hw.alpha_logit.data_ptr() != table.nu_hw.alpha_logit.data_ptr()
    assert not ttable.HostStateTable.init(6, 4, with_moments=False, device="cpu").has_moments


@pytest.mark.parametrize("n", [1, 6])
def test_extended_view_counts_the_primer_row(n):
    """``ExtendedHWView.n_rows``: the fitted rows plus the primer row, as the
    reference's property; the view's leaves read the primer at row n."""
    from repro.core import holt_winters as jhw

    table = ttable.HostStateTable.init(n, 4, device="cpu")
    view = table.extended(hw_init_params(1, 4, device="cpu"))
    want = jtable.HostStateTable.init(n, 4).extended(jhw.hw_init_params(1, 4))
    assert view.n_rows == want.n_rows == n + 1
    np.testing.assert_array_equal(view.alpha_logit[np.arange(n + 1)],
                                  want.alpha_logit[np.arange(n + 1)])
