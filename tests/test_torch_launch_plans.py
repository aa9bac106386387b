"""The launch plans of the port's CUDA kernels, on the CPU.

Each kernel wrapper sizes its launch with a pure function of the shape and
the device's limits, and passes the plan to the kernel:
``hw_scan.scan_plan`` (K1/K2: series per block, staged time tiles, copy
width and where the m-slot ring lives),
``lstm_cell.cell_plan`` (K3/K4: rows per thread, row groups, unit slices,
k-chunks of the weights) and ``lstm_cell.bwd_plan`` (K5: row tiles, column
slices, row chunks of the weight-gradient sums). These tests sweep the
widths and batches the reference runs and hold every plan to the H100's
limits: 232,448 bytes of opt-in shared memory and 1,024 threads per block.
The kernels themselves are held against their plain versions on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import pytest

from repro_torch.kernels import hw_scan, lstm_cell

H100_SMEM_OPTIN = 232_448        # cudaDevAttrMaxSharedMemoryPerBlockOptin
H100_SMS = 132
MAX_THREADS = 1024

_PRESET_WIDTHS = [          # (I, H) of every preset's layers: yearly, quarterly,
    (10, 30), (30, 30),     # monthly, hourly (input window + 6 categories, then H)
    (14, 40), (40, 40), (18, 50), (50, 50), (30, 40), (62, 50),
]
_WIDE_WIDTHS = [(in_size, hidden) for hidden in (64, 128, 256, 1030)
                for in_size in (hidden, 18)]
_ROWS = [1, 2, 7, 31, 32, 33, 64, 256, 333, 512, 1024, 2048, 2049, 4096, 8192, 16384]
_K3_ROWS = _ROWS + [24_000, 25_344, 25_345, 48_000, 192_000]   # K3: the forecast's too


_SCAN_N = [1, 2, 3, 4, 8, 31, 32, 33, 64, 129, 256, 300, 2048, 24_000, 24_001, 100_000]
_SCAN_T = [1, 3, 9, 31, 32, 33, 40, 72, 128, 208, 256, 440, 2040]
_SCAN_M = [1, 4, 12, 24, 168, 400, 1700, 2000, 8760]
_STREAMS = [hw_scan.FWD_STREAMS, hw_scan.BWD_STREAMS]


def _scan_plans(streams, sm_count=H100_SMS):
    for n in _SCAN_N:
        for t_len in _SCAN_T:
            for m in _SCAN_M:
                yield (n, t_len, m), hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, sm_count,
                                                       streams)


@pytest.mark.parametrize("streams,n,t_len,m,want", [
    # K1 (y staged): 32 series a block; the most rows a tile that T needs
    # and the SMs hold, the ring after the tiles
    (1, 24_000, 128, 4, ("shared", 128, 1, 16_896)),
    (1, 64, 256, 12, ("shared", 128, 2, 34_304)),
    (1, 300, 208, 168, ("optin", 128, 2, 54_272)),
    (1, 130, 440, 400, ("optin", 128, 3, 100_352)),
    (1, 1_700, 128, 1_700, ("optin", 32, 3, 229_888)),     # the ring leaves 12 KB of tiles
    (1, 64, 2040, 2_000, ("global", 128, 3, 49_152)),
    (1, 1, 9, 4, ("shared", 16, 1, 2_560)),
    # K2 (five streams staged): one block an SM at the train batches ...
    (5, 256, 72, 4, ("optin", 128, 1, 82_432)),
    (5, 8, 256, 4, ("optin", 128, 2, 164_352)),
    (5, 300, 208, 168, ("optin", 128, 2, 185_344)),
    (5, 130, 440, 400, ("optin", 64, 3, 174_080)),
    (5, 64, 2040, 2_000, ("global", 64, 3, 122_880)),
    (5, 3, 40, 4, ("shared", 64, 1, 41_472)),
    # ... and smaller tiles where six blocks share an SM
    (5, 24_000, 128, 4, ("shared", 16, 3, 31_232)),
])
def test_scan_plan_places_the_ring_and_sizes_the_tiles(streams, n, t_len, m, want):
    p = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS, streams)
    assert (hw_scan.RING_PLACES[p.ring], p.tile, p.stages, p.smem) == want
    assert p.block == hw_scan.SCAN_BLOCK


def _tiles_bytes(p, streams):
    return 4 * p.stages * streams * p.tile * p.block


@pytest.mark.parametrize("streams", _STREAMS)
def test_scan_plan_fits_the_opt_in_shared_memory(streams):
    smallest = hw_scan.SCAN_TILES[-1]
    for (n, t_len, m), p in _scan_plans(streams):
        ring = 4 * m * p.block
        where = hw_scan.RING_PLACES[p.ring]
        assert p.smem == _tiles_bytes(p, streams) + (0 if where == "global" else ring)
        assert p.smem <= H100_SMEM_OPTIN and p.block <= MAX_THREADS, (n, t_len, m)
        if where == "shared":
            assert p.smem <= 48 * 1024
        elif where == "optin":
            assert 48 * 1024 < p.smem
        else:                   # the ring goes to device memory only when it must
            small = 4 * min(hw_scan.SCAN_PIPE, -(-t_len // smallest)) * streams * smallest
            assert small * p.block + ring > H100_SMEM_OPTIN


@pytest.mark.parametrize("streams", _STREAMS)
def test_scan_plan_covers_every_series_and_step_once(streams):
    for (n, t_len, m), p in _scan_plans(streams):
        assert p.blocks * p.block >= n > (p.blocks - 1) * p.block, (n, t_len, m)
        assert p.tile in hw_scan.SCAN_TILES and p.block % 4 == 0
        assert p.stages == min(hw_scan.SCAN_PIPE, -(-t_len // p.tile)) >= 1
        # no more rows a tile than T needs
        assert p.tile == hw_scan.SCAN_TILES[-1] or p.tile // 2 < t_len


@pytest.mark.parametrize("streams", _STREAMS)
def test_scan_plan_keeps_every_block_resident_where_a_tile_allows(streams):
    for sm_count in (H100_SMS, 114):
        for (n, t_len, m), p in _scan_plans(streams, sm_count):
            per_sm = -(-p.blocks // sm_count)
            if p.tile != hw_scan.SCAN_TILES[-1]:
                assert per_sm * (p.smem + 1024) <= H100_SMEM_OPTIN + 1024, (n, t_len, m)


@pytest.mark.parametrize("n", [1, 3, 5, 31, 33, 129, 24_001])
def test_scan_plan_copies_4_bytes_where_rows_are_not_16_byte_aligned(n):
    for streams in _STREAMS:
        assert hw_scan.scan_plan(n, 72, 4, H100_SMEM_OPTIN, H100_SMS, streams).copy == 4
        assert hw_scan.scan_plan(n + (4 - n % 4), 72, 4, H100_SMEM_OPTIN, H100_SMS,
                                 streams).copy == 16
        # a base pointer off 16 bytes takes 4-byte copies at any N
        assert hw_scan.scan_plan(4 * n, 72, 4, H100_SMEM_OPTIN, H100_SMS, streams,
                                 aligned=False).copy == 4


@pytest.mark.parametrize("streams", _STREAMS)
@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_scan_plan_fills_the_sms_at_the_forecast(streams, sm_count):
    n = 24_000                  # M4's quarterly count, the forecast's batch
    p = hw_scan.scan_plan(n, 128, 4, H100_SMEM_OPTIN, sm_count, streams)
    per_sm = -(-p.blocks // sm_count)
    assert p.blocks >= sm_count
    # one even wave: every block resident at once (32 blocks and 228 KB of
    # shared memory an SM, 1 KB of it reserved per block), and the busiest
    # SM holds under 10 % more series than the mean
    assert per_sm <= 32 and per_sm * (p.smem + 1024) <= H100_SMEM_OPTIN + 1024
    assert per_sm * p.block <= 1.1 * n / sm_count
    # and each SM has over 20 KB of the streams staged at once
    assert per_sm * _tiles_bytes(p, streams) >= 20 * 1024



# K1 with a bf16 y (the bf16 policy): the plan takes the staged element's
# size, 2 bytes; the ring stays float
BF16 = 2


@pytest.mark.parametrize("n,t_len,m,want", [
    (24_000, 128, 4, ("shared", 128, 1, 8_704, 16)),    # the forecast: half of 16,384 + ring
    (64, 256, 4, ("shared", 128, 2, 16_896, 16)),       # a serve bucket
    (4, 32, 4, ("shared", 32, 1, 2_560, 2)),            # B = 4: 8-byte rows, one element a copy
    (1, 9, 4, ("shared", 16, 1, 1_536, 2)),
    (1_700, 128, 1_700, ("optin", 128, 1, 225_792, 2)),  # one 8 KB tile beside the ring
    (64, 2040, 2_000, ("global", 128, 3, 24_576, 16)),
])
def test_scan_plan_stages_bf16_tiles(n, t_len, m, want):
    p = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS, hw_scan.FWD_STREAMS,
                          elem=BF16)
    assert (hw_scan.RING_PLACES[p.ring], p.tile, p.stages, p.smem, p.copy) == want


@pytest.mark.parametrize("n", [1, 3, 4, 5, 12, 31, 33, 129, 24_001, 24_004])
def test_scan_plan_copies_16_bytes_of_bf16_only_where_rows_align(n):
    # a 16-byte copy moves 8 bf16 series: N must be a multiple of 8
    assert hw_scan.scan_plan(n, 72, 4, H100_SMEM_OPTIN, H100_SMS, elem=BF16).copy == BF16
    n8 = n + (8 - n % 8)
    assert hw_scan.scan_plan(n8, 72, 4, H100_SMEM_OPTIN, H100_SMS, elem=BF16).copy == 16
    assert hw_scan.scan_plan(n8, 72, 4, H100_SMEM_OPTIN, H100_SMS, aligned=False,
                             elem=BF16).copy == BF16


def test_scan_plan_fits_covers_and_keeps_resident_with_bf16_y():
    for n in _SCAN_N:
        for t_len in _SCAN_T:
            for m in _SCAN_M:
                p = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS,
                                      hw_scan.FWD_STREAMS, elem=BF16)
                where = hw_scan.RING_PLACES[p.ring]
                ring = 0 if where == "global" else 4 * m * p.block
                assert p.smem == BF16 * p.stages * p.tile * p.block + ring, (n, t_len, m)
                assert p.smem <= H100_SMEM_OPTIN
                assert p.blocks * p.block >= n > (p.blocks - 1) * p.block
                assert p.stages == min(hw_scan.SCAN_PIPE, -(-t_len // p.tile)) >= 1
                assert p.block % (16 // BF16) == 0          # whole 16-byte chunks a row
                if p.tile != hw_scan.SCAN_TILES[-1]:
                    per_sm = -(-p.blocks // H100_SMS)
                    assert per_sm * (p.smem + 1024) <= H100_SMEM_OPTIN + 1024
                # the float32 plan of the same shape never stages fewer rows
                assert p.tile >= hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN,
                                                   H100_SMS).tile

# K2 with a bf16 y (bf16 training): y staged at 2 bytes, the four other
# streams (levels, seas, dlev, dseas) float32, so a tile row stages 2 + 16
# bytes a series; each stream takes its own copy width


def _parent_scan_plan(n, t_len, m, smem_optin, sm_count, streams=1, aligned=True, elem=4):
    """``scan_plan`` as it was before the plan kept a copy width per stream,
    when every staged stream was sized by the first one's element: the float32
    plans of K1 and K2 must not change."""
    block = hw_scan.SCAN_BLOCK
    blocks = -(-n // block)
    per_sm = -(-blocks // sm_count)
    ring_bytes = 4 * m * block

    def layout(tile):
        stages = min(hw_scan.SCAN_PIPE, -(-t_len // tile))
        return stages, elem * stages * streams * tile * block

    ring_shared = layout(hw_scan.SCAN_TILES[-1])[1] + ring_bytes <= smem_optin
    cap = next((t for t in reversed(hw_scan.SCAN_TILES) if t >= t_len), hw_scan.SCAN_TILES[0])
    for tile in hw_scan.SCAN_TILES:
        stages, tiles_bytes = layout(tile)
        smem = tiles_bytes + (ring_bytes if ring_shared else 0)
        resident = per_sm * (smem + 1024) <= smem_optin + 1024
        if tile <= cap and smem <= smem_optin and resident:
            break
    where = "global" if not ring_shared else ("shared" if smem <= 48 * 1024 else "optin")
    copy = 16 if aligned and (n * elem) % 16 == 0 else elem
    return dict(block=block, tile=tile, stages=stages, copy=copy,
                ring=hw_scan.RING_PLACES.index(where), smem=smem, blocks=blocks)


@pytest.mark.parametrize("streams", _STREAMS)
@pytest.mark.parametrize("aligned", [True, False])
def test_scan_plan_float32_plans_are_unchanged(streams, aligned):
    for n in _SCAN_N:
        for t_len in _SCAN_T:
            for m in _SCAN_M:
                p = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS, streams, aligned)
                want = _parent_scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS, streams,
                                         aligned)
                got = p._asdict()
                # K1 stages no float stream beside y; K2's float streams copy
                # as the parent's single width did
                assert got.pop("copy_rest") == (0 if streams == 1 else want["copy"])
                assert got == want, (n, t_len, m)
    # K1's bf16 plans are the parent's too (the one stream was sized right)
    for n in _SCAN_N:
        for t_len in _SCAN_T:
            p = hw_scan.scan_plan(n, t_len, 4, H100_SMEM_OPTIN, H100_SMS, aligned=aligned,
                                  elem=BF16)._asdict()
            assert p.pop("copy_rest") == 0
            assert p == _parent_scan_plan(n, t_len, 4, H100_SMEM_OPTIN, H100_SMS,
                                          aligned=aligned, elem=BF16)


@pytest.mark.parametrize("n,t_len,m,want", [
    # the train batches (one 128-row tile of all 72 steps, one block an SM)
    (256, 72, 4, ("optin", 128, 1, 74_240, 16, 16)),
    (2_048, 72, 1, ("optin", 128, 1, 73_856, 16, 16)),
    (8, 256, 4, ("optin", 128, 2, 147_968, 16, 16)),        # the fine-tune's K2
    (36, 41, 4, ("shared", 64, 1, 37_376, 2, 16)),          # N % 8 != 0, N % 4 == 0
    (3, 40, 4, ("shared", 64, 1, 37_376, 2, 4)),            # N % 4 != 0
    (24_000, 128, 4, ("shared", 16, 3, 28_160, 16, 16)),    # six blocks an SM
    (300, 208, 168, ("optin", 128, 2, 168_960, 2, 16)),
    (130, 440, 400, ("optin", 64, 3, 161_792, 2, 4)),
    (64, 2040, 2_000, ("global", 128, 3, 221_184, 16, 16)),
])
def test_scan_plan_stages_k2_with_a_bf16_y(n, t_len, m, want):
    p = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS, hw_scan.BWD_STREAMS,
                          elem=BF16)
    assert (hw_scan.RING_PLACES[p.ring], p.tile, p.stages, p.smem, p.copy, p.copy_rest) == want


def test_scan_plan_fits_and_copies_16_bytes_only_on_aligned_streams_with_bf16_y():
    row_bytes = BF16 + 4 * (hw_scan.BWD_STREAMS - 1)
    for n in _SCAN_N + [36, 12, 24_004]:
        for t_len in _SCAN_T:
            for m in _SCAN_M:
                p = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS,
                                      hw_scan.BWD_STREAMS, elem=BF16)
                where = hw_scan.RING_PLACES[p.ring]
                ring = 0 if where == "global" else 4 * m * p.block
                assert p.smem == row_bytes * p.stages * p.tile * p.block + ring, (n, t_len, m)
                assert p.smem <= H100_SMEM_OPTIN
                assert p.blocks * p.block >= n > (p.blocks - 1) * p.block
                assert p.stages == min(hw_scan.SCAN_PIPE, -(-t_len // p.tile)) >= 1
                if p.tile != hw_scan.SCAN_TILES[-1]:
                    per_sm = -(-p.blocks // H100_SMS)
                    assert per_sm * (p.smem + 1024) <= H100_SMEM_OPTIN + 1024
                # y's 16-byte copies move 8 series, the float streams' 4
                assert p.copy == (16 if n % 8 == 0 else BF16), (n, t_len, m)
                assert p.copy_rest == (16 if n % 4 == 0 else 4), (n, t_len, m)
                # where the ring sits as in the float32 plan of the shape, never
                # fewer rows staged (the narrower y can instead bring the ring
                # into shared memory, beside smaller tiles)
                f32 = hw_scan.scan_plan(n, t_len, m, H100_SMEM_OPTIN, H100_SMS,
                                        hw_scan.BWD_STREAMS)
                assert p.tile >= f32.tile or p.ring != f32.ring, (n, t_len, m)
        unaligned = hw_scan.scan_plan(n, 72, 4, H100_SMEM_OPTIN, H100_SMS, hw_scan.BWD_STREAMS,
                                      aligned=False, elem=BF16)
        assert (unaligned.copy, unaligned.copy_rest) == (BF16, 4)


def _preset_geometry(rows, in_size, hidden, sm_count):
    """K3/K4's launch of ``lstm_cell_smem`` at a preset width, written out:
    4 or 8 rows per thread, min(8, 1,024 / H) row groups (fewer below a
    full tile per SM), all weights and the tile in shared memory."""
    cell_r = 4 if rows <= 3 * 64 * sm_count else 8
    block_groups = min(8, 1024 // hidden)
    groups = min(block_groups, max(1, -(-rows // (cell_r * sm_count))))
    kw = in_size + hidden
    smem = 4 * (kw * 4 * hidden + kw * (groups * cell_r + 4))
    return cell_r, groups, block_groups * hidden, smem


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS)
@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_cell_plan_keeps_the_geometry_at_es_rnn_widths(in_size, hidden, sm_count):
    for rows in _K3_ROWS:
        plan = lstm_cell.cell_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count)
        assert (plan.cell_r, plan.groups, plan.threads, plan.smem) == _preset_geometry(
            rows, in_size, hidden, sm_count), rows
        assert (plan.units, plan.slices, plan.k_chunk, plan.wide) == (
            hidden, 1, in_size + hidden, 0)


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + _WIDE_WIDTHS)
def test_cell_plan_fits_a_block(in_size, hidden):
    kw = in_size + hidden
    for rows in _K3_ROWS:
        p = lstm_cell.cell_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
        assert p.threads <= lstm_cell.CELL_MAX_THREADS <= MAX_THREADS
        # registers (ptxas, sm_90a): lstm_cell_smem 86 a thread at 8 rows
        # and 64 at 4, the wide one 96 (it runs 4 rows only)
        regs = 96 if p.wide else (86 if p.cell_r == 8 else 64)
        assert p.cell_r in (4, 8) and not (p.wide and p.cell_r == 8)
        assert p.threads * regs <= 65_536
        assert p.threads % p.units == 0 and 1 <= p.groups <= p.threads // p.units
        assert p.slices * p.units >= hidden > (p.slices - 1) * p.units
        assert p.smem <= H100_SMEM_OPTIN
        assert 1 <= p.k_chunk <= kw
        per_k = 4 * (4 * p.units + p.groups * p.cell_r + lstm_cell.CELL_PAD)
        assert p.smem == p.k_chunk * per_k
        if p.k_chunk < kw:                  # the most k rows that fit
            assert (p.k_chunk + 1) * per_k > H100_SMEM_OPTIN
        assert p.wide == (p.slices > 1 or p.k_chunk < kw or kw > lstm_cell.CELL_SUM_BLOCK)


def test_cell_plan_chunks_and_slices_past_the_presets():
    assert lstm_cell.cell_plan(333, 64, 64, H100_SMEM_OPTIN, H100_SMS).k_chunk == 128
    wide = lstm_cell.cell_plan(1, 1030, 1030, H100_SMEM_OPTIN, H100_SMS)
    assert (wide.slices, wide.units, wide.threads) == (33, 32, 256) and wide.k_chunk < 2060
    # slices of 32 units keep [Wx; Wh] whole up to I + H = 354
    assert lstm_cell.cell_plan(30_000, 128, 128, H100_SMEM_OPTIN, H100_SMS).k_chunk == 256
    assert lstm_cell.cell_plan(333, 256, 256, H100_SMEM_OPTIN, H100_SMS).k_chunk < 512


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + _WIDE_WIDTHS)
def test_bwd_plan_fits_a_block(in_size, hidden):
    kw = in_size + hidden
    for rows in _ROWS:
        p = lstm_cell.bwd_plan(rows, in_size, hidden, H100_SMEM_OPTIN)
        assert p.smem <= min(H100_SMEM_OPTIN, lstm_cell.BWD_SMEM)
        # row blocks: a thread per (k, 4 rows); column blocks: per (4 k, unit)
        assert p.tile_rows % 4 == 0 and p.row_k * (p.tile_rows // 4) <= lstm_cell.BWD_THREADS
        assert p.col_k % 4 == 0 and (p.col_k // 4) * p.col_units <= lstm_cell.BWD_THREADS
        assert lstm_cell.BWD_THREADS <= MAX_THREADS
        assert p.row_kparts * p.row_k >= kw > (p.row_kparts - 1) * p.row_k
        assert p.col_kparts * p.col_k >= kw + 1 > (p.col_kparts - 1) * p.col_k
        assert p.slices * p.col_units >= hidden > (p.slices - 1) * p.col_units
        assert 1 <= p.row_units <= hidden and 1 <= p.sub_rows <= p.chunk_rows
        assert p.row_units * (16 * (p.row_k | 1) + 16 * p.tile_rows) <= p.smem
        assert p.sub_rows * (4 * p.col_k + 16 * p.col_units) <= p.smem
        # every chunk holds rows; every row block has a tile to take
        assert p.chunks * p.chunk_rows >= rows > (p.chunks - 1) * p.chunk_rows
        assert 1 <= p.row_blocks <= -(-rows // p.tile_rows) * p.row_kparts
        assert p.blocks < 2 ** 31


@pytest.mark.parametrize("rows", _ROWS)
def test_bwd_row_chunks_depend_on_the_row_count_alone(rows):
    # the chunks fix the order of the weight-gradient sums, so they may not
    # move with the widths or the device
    splits = {(p.chunks, p.chunk_rows) for p in (
        lstm_cell.bwd_plan(rows, in_size, hidden, optin)
        for in_size, hidden in _PRESET_WIDTHS + _WIDE_WIDTHS
        for optin in (H100_SMEM_OPTIN, 166_912, 101_376))}
    assert len(splits) == 1
    (chunks, chunk_rows), = splits
    assert chunks <= lstm_cell.BWD_MAX_CHUNKS
    assert chunk_rows <= lstm_cell.BWD_CHUNK_ROWS or chunks == lstm_cell.BWD_MAX_CHUNKS


@pytest.mark.parametrize("in_size", [14, 40])
def test_bwd_plan_covers_the_sms_at_the_train_batch(in_size):
    # at batch 256 (the esrnn-quarterly spec's) a launch has a block per SM
    assert lstm_cell.bwd_plan(256, in_size, 40, H100_SMEM_OPTIN).blocks >= H100_SMS


# ---------------------------------------------------------------------------
# K3/K4 in bf16 on the tensor cores (csrc/lstm_cell_tc.cu): lstm_cell.cell_tc_plan

# each preset's (I, H) at layer 1 (input window + 6 categories) and layers
# 2+: yearly H = 30, quarterly H = 40, monthly H = 50, hourly H = 40
_TC_PRESETS = {"yearly": [(10, 30), (30, 30)], "quarterly": [(14, 40), (40, 40)],
               "monthly": [(18, 50), (50, 50)], "hourly": [(30, 40), (40, 40)]}
# the widths past the presets that chip_smoke.py's WIDE_CELL runs
_WIDE_CELL = [(rows, hid, hid) for hid in (128, 256, 1030) for rows in (1, 333)]


def _tc_plans(sm_count=H100_SMS):
    for widths in _TC_PRESETS.values():
        for in_size, hidden in widths:
            for rows in _K3_ROWS:
                for act in (0, 1):
                    yield (rows, in_size, hidden, act), lstm_cell.cell_tc_plan(
                        rows, in_size, hidden, H100_SMEM_OPTIN, sm_count, act)


@pytest.mark.parametrize("preset", sorted(_TC_PRESETS))
@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_cell_tc_plan_takes_every_preset_width(preset, sm_count):
    for in_size, hidden in _TC_PRESETS[preset]:
        for rows in _K3_ROWS:
            for act in (0, 1):
                p = lstm_cell.cell_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count, act)
                assert isinstance(p, lstm_cell.TcPlan), (rows, in_size, hidden, act)
                assert p.act == act


@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_cell_tc_plan_fits_the_opt_in_shared_memory(sm_count):
    for (rows, in_size, hidden, act), p in _tc_plans(sm_count):
        assert p.smem == lstm_cell.tc_smem(p.m_tiles, p.k_pad, p.n_pad, hidden, act)
        assert p.smem <= H100_SMEM_OPTIN, (rows, in_size, hidden)
        assert 1 <= p.warps <= lstm_cell.TC_MAX_WARPS and 32 * p.warps <= MAX_THREADS
        assert 1 <= p.quads <= lstm_cell.TC_QMAX


def test_cell_tc_plan_covers_every_row_and_unit_once():
    np = pytest.importorskip("numpy")
    for (rows, in_size, hidden, act), p in _tc_plans():
        if rows > 25_345 or act:
            continue
        hq = -(-hidden // 4)
        seen = np.zeros((-(-rows // p.tile) * p.tile, hq), dtype=np.int64)
        # tile t, warp w: rows t * tile + 16 (w // slices) + 0..15, quads
        # (w % slices) * quads + 0..quads-1 that exist
        for t in range(-(-rows // p.tile)):
            for w in range(p.warps):
                r0 = t * p.tile + 16 * (w // p.slices)
                q0 = (w % p.slices) * p.quads
                seen[r0:r0 + 16, q0:min(hq, q0 + p.quads)] += 1
        assert (seen == 1).all(), (rows, in_size, hidden)


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + [(7, 50), (1, 2), (64, 64)])
def test_cell_tc_plan_pads_k_and_the_units(in_size, hidden):
    for rows in (1, 512, 24_000):
        p = lstm_cell.cell_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS, 0)
        assert p.k_x % 8 == 0 and in_size <= p.k_x < in_size + 8
        assert p.k_pad % 16 == 0 and p.k_x + hidden <= p.k_pad < p.k_x + hidden + 16
        # units padded to whole quads (4 units, 16 columns), every slice whole
        quads = -(-hidden // 4)
        assert p.n_pad == 16 * p.slices * p.quads
        assert p.slices * p.quads >= quads > (p.slices - 1) * p.quads


@pytest.mark.parametrize("in_size,hidden,want", [
    (14, 40, (4, 16, 8)), (40, 40, (16, 16, 8)), (10, 30, (4, 4, 4)), (30, 30, (4, 4, 4)),
    (18, 50, (4, 4, 4)), (50, 50, (4, 4, 4)), (30, 40, (4, 16, 8)), (62, 50, (4, 4, 4)),
    (7, 50, (2, 4, 4)), (64, 64, (16, 16, 8)), (7, 7, (2, 2, 2))])
def test_cell_tc_plan_copies_16_bytes_only_where_a_streams_rows_align(in_size, hidden, want):
    # x rows are 2 I bytes, h rows 2 H: 16-byte copies need I, H multiples
    # of 8 (I = 14, H = 30 and H = 50 are not); c and the outputs are
    # contiguous runs per tile, so only their base decides; a weight load
    # takes 4 units of a gate where H is a multiple of 4, 2 where even
    p = lstm_cell.cell_tc_plan(4_096, in_size, hidden, H100_SMEM_OPTIN, H100_SMS, 1)
    assert (p.copy_x, p.copy_h, p.copy_w) == want
    assert p.copy_c == p.copy_out == 16
    # a base off 16 bytes narrows its own stream's copies and no other
    off = lstm_cell.cell_tc_plan(4_096, in_size, hidden, H100_SMEM_OPTIN, H100_SMS, 1,
                                 4, 4, 2, 8, 4)
    assert (off.copy_w, off.copy_x, off.copy_h, off.copy_c, off.copy_out) == (
        min(4, want[2]), min(4, want[0]), 2, 8, 4)


@pytest.mark.parametrize("rows,in_size,hidden", _WIDE_CELL)
def test_cell_tc_plan_sends_the_widths_past_the_presets_to_the_wide_kernel(rows, in_size,
                                                                           hidden):
    for act in (0, 1):
        assert lstm_cell.cell_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS,
                                      act) is None
    assert lstm_cell.cell_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS).wide


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + _WIDE_WIDTHS + [
    (1, 104), (24, 104), (1, 120), (28, 100), (64, 64), (65, 64), (7, 50), (1, 2)])
def test_cell_tc_plan_takes_exactly_the_widths_lstm_cell_smem_took(in_size, hidden):
    # the bf16 stream runs the tensor-core kernel wherever cell_plan does not
    # take the wide kernel, and the wide kernel elsewhere
    for rows in _K3_ROWS:
        tc = lstm_cell.cell_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS, 1)
        wide = lstm_cell.cell_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS).wide
        assert (tc is None) == bool(wide), (rows, in_size, hidden)


@pytest.mark.parametrize("hidden", [2, 30, 40, 50, 64])
def test_tc_column_is_a_bijection_onto_the_padded_columns(hidden):
    units = 4 * -(-hidden // 4)
    cols = [lstm_cell.tc_column(q, j) for j in range(units) for q in range(4)]
    assert sorted(cols) == list(range(4 * units))


def test_tc_column_gives_each_lane_the_four_gates_of_one_unit():
    # an m16n8 accumulator fragment: lane l holds columns 2 (l % 4) and
    # 2 (l % 4) + 1 of each 8-column n-tile; a quad's two n-tiles are its
    # columns 0-7 and 8-15
    for quad in range(13):
        for lane in range(32):
            t = lane % 4
            held = [16 * quad + 8 * n + 2 * t + e for n in (0, 1) for e in (0, 1)]
            gates = {lstm_cell.tc_column(q, 4 * quad + t): q for q in range(4)}
            assert [gates[col] for col in held] == [0, 1, 2, 3]      # i, f, g, o


def _parent_cell_plan(rows, in_size, hidden, smem_optin, sm_count):
    """lstm_cell.cell_plan as it stood before the bf16 stream moved to the
    tensor cores, written out: the fp32 launches must not move."""
    kw = in_size + hidden
    cell_r = 4 if rows <= 3 * 64 * sm_count else 8
    units = hidden
    block_groups = min(8, 512 // units) if units <= 512 else 0
    groups = min(block_groups, max(1, -(-rows // (cell_r * sm_count))))
    per_k = 4 * (4 * units + groups * cell_r + 4)
    wide = block_groups == 0 or kw > 128 or kw * per_k > smem_optin
    if wide:
        cell_r, units, block_groups = 4, min(hidden, 32), 8
        groups = min(block_groups, -(-rows // cell_r))
        per_k = 4 * (4 * units + groups * cell_r + 4)
    slices = -(-hidden // units)
    k_chunk = kw if kw * per_k <= smem_optin else smem_optin // per_k
    return (cell_r, groups, units, slices, block_groups * units, k_chunk, int(wide),
            k_chunk * per_k)


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + _WIDE_WIDTHS)
@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_cell_plan_float32_plans_are_unchanged(in_size, hidden, sm_count):
    for rows in _K3_ROWS:
        assert tuple(lstm_cell.cell_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count)) == \
            _parent_cell_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count), rows


# ---------------------------------------------------------------------------
# K5 in bf16 on the tensor cores (csrc/lstm_cell_bwd_tc.cu): lstm_cell.bwd_tc_plan

# every preset's widths and the tests' odd one (I = 7, H = 50)
_BWD_TC_WIDTHS = _PRESET_WIDTHS + [(7, 50)]
# the widths chip_smoke.py's WIDE_BWD sends K5: past the presets
_WIDE_BWD = [(64, 64), (128, 128), (256, 256), (1030, 1030)]


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS)
@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_bwd_tc_plan_takes_every_preset_width(in_size, hidden, sm_count):
    for rows in _ROWS:
        p = lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count)
        assert isinstance(p, lstm_cell.BwdTcPlan), (rows, in_size, hidden)


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS)
def test_bwd_tc_plan_fits_the_opt_in_shared_memory(in_size, hidden):
    for rows in _ROWS:
        p = lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
        assert p.smem == lstm_cell.bwd_tc_smem(p.m_tiles, in_size, hidden, p.col_rows)
        assert p.smem <= H100_SMEM_OPTIN
        assert 32 * lstm_cell.BWD_TC_WARPS <= MAX_THREADS
        assert 1 <= p.m_tiles <= lstm_cell.BWD_TC_MTILES and p.tiles >= 1
        split = rows <= lstm_cell.BWD_TC_SPLIT_ROWS
        assert (p.row_blocks > 0) == split, rows
        if split:
            # one tile a row block (16 rows, 32 past 128), no cluster
            assert (p.m_tiles, p.tiles, p.cluster) == (1 if rows <= 128 else 2, 1, 1)
            # the whole batch a chunk where it fits, else the most rows that do
            whole = min(lstm_cell.BWD_TC_COL_ROWS, 16 * -(-rows // 16))
            assert p.col_rows <= whole and (p.col_rows == whole or lstm_cell.bwd_tc_smem(
                p.m_tiles, in_size, hidden, 2 * p.col_rows) > H100_SMEM_OPTIN)
        else:
            # the smallest tile that gives each block one, else the largest
            # whose layout fits; clusters of 8
            m_max = next(m for m in (4, 2, 1)
                         if lstm_cell.bwd_tc_smem(m, in_size, hidden) <= H100_SMEM_OPTIN)
            one = [m for m in (1, 2, 4)
                   if m <= m_max and -(-rows // (16 * m)) <= lstm_cell.BWD_TC_BLOCKS]
            assert p.m_tiles == (one[0] if one else m_max), rows
            assert (p.cluster, p.col_rows) == (lstm_cell.BWD_TC_CLUSTER, 0)
            assert p.blocks % p.cluster == 0 and p.blocks <= lstm_cell.BWD_TC_BLOCKS


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS)
def test_bwd_tc_plan_covers_every_row_k_and_gate_column_once(in_size, hidden):
    np = pytest.importorskip("numpy")
    g4, kw = 4 * hidden, in_size + hidden
    for rows in _ROWS:
        p = lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
        # rows: block b walks tiles b * tiles .. b * tiles + tiles - 1 of 16
        # m_tiles rows (the split plan's row blocks: one tile each); every row
        # in exactly one (block, tile), and no block wholly past the batch but
        # those that round the clusters up
        row_blocks = p.row_blocks or p.blocks
        seen = np.zeros(row_blocks * p.tiles * p.tile, dtype=np.int64)
        for b in range(row_blocks):
            for i in range(p.tiles):
                t = b * p.tiles + i
                seen[t * p.tile:(t + 1) * p.tile] += 1
        assert (seen[:rows] == 1).all(), (rows, in_size, hidden)
        assert row_blocks - p.cluster < -(-rows // (p.tile * p.tiles)) <= row_blocks
        if p.row_blocks:
            # the column blocks: every unit (its four gate columns) in one,
            # every row in one of a column block's chunks
            units = np.zeros(hidden, dtype=np.int64)
            for cb in range(p.blocks - p.row_blocks):
                u = lstm_cell.BWD_TC_COL_UNITS
                units[cb * u:(cb + 1) * u] += 1
            assert (units == 1).all()
            assert p.col_rows % 16 == 0 and p.col_rows >= min(rows, 16)
        # k: x at [0, I), h at [k_x, k_x + H), db's ones at k_x + H, each a
        # staged column of [x | h | 1] (k_pad) and, but for the ones, a
        # staged weight row (k_w), once
        cols = list(range(in_size)) + [p.k_x + j for j in range(hidden)]
        assert len(set(cols)) == kw and max(cols) < p.k_w <= p.k_pad
        assert in_size <= p.k_x < in_size + 8 and p.k_x % 8 == 0
        assert p.k_x + hidden < p.k_pad and p.k_pad % 16 == 0 and p.k_w % 16 == 0
        # gate columns: 4H within n_pad, padded to whole 16-column k-steps
        assert g4 <= p.n_pad < g4 + 16 and p.n_pad % 16 == 0
        # the cluster's ranks split the (I + H + 1) x 4H gradients into
        # regions that cover each once (the kernel's lo / hi, in float4s)
        n_out4 = (kw + 1) * g4 // 4
        bounds = [r * n_out4 // p.cluster for r in range(p.cluster + 1)]
        assert bounds[0] == 0 and bounds[-1] == n_out4 and bounds == sorted(bounds)


@pytest.mark.parametrize("in_size,hidden,want", [
    (14, 40, (16, 4, 16)), (40, 40, (16, 16, 16)), (10, 30, (16, 4, 4)), (30, 30, (16, 4, 4)),
    (18, 50, (16, 4, 4)), (50, 50, (16, 4, 4)), (30, 40, (16, 4, 16)), (62, 50, (16, 4, 4)),
    (7, 50, (16, 2, 4)), (7, 7, (8, 2, 2))])
def test_bwd_tc_plan_copies_16_bytes_only_where_a_streams_rows_align(in_size, hidden, want):
    # weight rows are 8H bytes (16-byte copies where H is even), x rows 2I
    # and h rows 2H (16 bytes where I, H are multiples of 8); the residuals
    # and the outputs are contiguous runs per tile, so only their bases decide
    p = lstm_cell.bwd_tc_plan(4_096, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
    assert (p.copy_w, p.copy_x, p.copy_h) == want
    assert p.copy_r == p.copy_out == 16
    # a base off 16 bytes narrows its own stream's copies and no other
    off = lstm_cell.bwd_tc_plan(4_096, in_size, hidden, H100_SMEM_OPTIN, H100_SMS,
                                4, 2, 8, 4, 2)
    assert (off.copy_w, off.copy_x, off.copy_h, off.copy_r, off.copy_out) == (
        min(4, want[0]), 2, min(8, want[2]), 4, 2)


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS + _WIDE_WIDTHS + _WIDE_BWD)
def test_bwd_tc_plan_is_none_exactly_where_the_templated_kernel_runs(in_size, hidden):
    # the bf16 stream runs the templated K5 (lstm_cell_bwd_wide_bf16) where
    # even 16-row tiles would pass the opt-in shared memory: at the widths
    # past the presets, and at no preset width
    wide = lstm_cell.bwd_tc_smem(1, in_size, hidden) > H100_SMEM_OPTIN
    for rows in _ROWS:
        p = lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
        assert (p is None) == wide, (rows, in_size, hidden)
    assert wide == ((in_size, hidden) in _WIDE_BWD or (in_size, hidden) in [
        (18, 128), (18, 256), (1030, 1030), (18, 1030)])


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS)
def test_bwd_tc_plan_sum_order_does_not_depend_on_the_sm_count(in_size, hidden):
    # the blocks, tiles and clusters fix the order of every weight-gradient
    # sum, so the plan may not move with the card's SM count
    for rows in _ROWS:
        plans = {lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sms)
                 for sms in (H100_SMS, 114, 1, 264)}
        assert len(plans) == 1, (rows, in_size, hidden)


def test_bwd_tc_plan_splits_small_batches_and_clusters_large_ones():
    # the train step's first layer at batch 256 and the fine-tune: row blocks
    # and column blocks, no cross-block sum; past 512 rows at most 120 blocks
    # (the clusters of 8 an H100 keeps resident) in clusters of 8
    for rows, want in [(8, (1, 1, 11, 1, 1)), (16, (1, 1, 11, 1, 1)), (64, (1, 1, 14, 1, 4)),
                       (256, (2, 1, 18, 1, 8)), (512, (2, 1, 26, 1, 16)),
                       (1_024, (1, 1, 64, 8, 0)), (2_048, (2, 1, 64, 8, 0)),
                       (4_096, (4, 1, 64, 8, 0)), (8_192, (4, 2, 64, 8, 0)),
                       (16_384, (4, 3, 88, 8, 0))]:
        p = lstm_cell.bwd_tc_plan(rows, 40, 40, H100_SMEM_OPTIN, H100_SMS)
        assert (p.m_tiles, p.tiles, p.blocks, p.cluster, p.row_blocks) == want, rows
    p = lstm_cell.bwd_tc_plan(256, 14, 40, H100_SMEM_OPTIN, H100_SMS)
    assert (p.m_tiles, p.row_blocks, p.blocks, p.col_rows) == (2, 8, 18, 256)
    # at 512 rows the whole batch is one chunk where it fits
    assert lstm_cell.bwd_tc_plan(512, 40, 40, H100_SMEM_OPTIN, H100_SMS).col_rows == 512
    assert lstm_cell.bwd_tc_plan(512, 62, 50, H100_SMEM_OPTIN, H100_SMS).col_rows == 256


def _parent_bwd_plan(rows, in_size, hidden, smem_optin):
    """lstm_cell.bwd_plan as it stood before K5's bf16 stream moved to the
    tensor cores, written out: the fp32 launches must not move."""
    cdiv = lambda a, b: -(-a // b)
    kw = in_size + hidden
    budget = min(smem_optin, 100 * 1024)
    if kw <= 256:
        row_k, r_max = kw, 4 * min(4, 256 // kw)
    else:
        row_k, r_max = 64, 16
    tile_rows = min(r_max, max(4, 4 * cdiv(cdiv(rows, 128), 4)))
    row_kparts = cdiv(kw, row_k)
    per_unit = 16 * (row_k | 1) + 16 * tile_rows
    row_units = min(hidden, budget // per_unit)
    row_blocks = min(cdiv(rows, tile_rows) * row_kparts, 128)
    col_k = 4 * cdiv(kw + 1, 4) if kw + 1 <= 128 else 64
    col_kparts = cdiv(kw + 1, col_k)
    chunk_rows = cdiv(rows, min(32, cdiv(rows, 32)))
    chunks = cdiv(rows, chunk_rows)
    max_units = 256 // (col_k // 4)
    want_slices = cdiv(128, chunks * col_kparts)
    col_units = min(max_units, cdiv(hidden, want_slices))
    slices = cdiv(hidden, col_units)
    per_row = 4 * col_k + 16 * col_units
    sub_rows = min(chunk_rows, 128, budget // per_row)
    smem = max(row_units * per_unit, sub_rows * per_row)
    return (tile_rows, row_k, row_kparts, row_units, row_blocks, col_k, col_kparts, col_units,
            slices, chunks, chunk_rows, sub_rows, smem)


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + _WIDE_WIDTHS + [(7, 50)])
def test_bwd_plan_float32_plans_are_unchanged(in_size, hidden):
    for rows in _ROWS:
        for optin in (H100_SMEM_OPTIN, 166_912, 101_376):
            assert tuple(lstm_cell.bwd_plan(rows, in_size, hidden, optin)) == \
                _parent_bwd_plan(rows, in_size, hidden, optin), (rows, optin)


# ---------------------------------------------------------------------------
# K5's dx-only launch (no weight gradients): lstm_cell.bwd_dx_plan (fp32, and
# bf16 past the presets) and lstm_cell.bwd_dx_tc_plan (bf16 on the tensor cores)

# the K5 shapes of the main path: the train step's layers at batch 256 and
# 2,048 (rows = batch x dilation, I = 14 or 40), up to the largest train
# shape, and the fine-tune's 8 to 64 rows
_DX_ROWS = sorted(set(_ROWS + [8 * d for d in (1, 2, 4, 8)] + [256 * d for d in (1, 2, 4, 8)]
                      + [2048 * d for d in (1, 2, 4, 8)]))


@pytest.mark.parametrize("in_size,hidden", _PRESET_WIDTHS + _WIDE_WIDTHS + [(7, 50)])
def test_bwd_dx_plan_is_the_row_blocks_alone(in_size, hidden):
    kw = in_size + hidden
    for rows in _DX_ROWS:
        for optin in (H100_SMEM_OPTIN, 101_376):
            full = lstm_cell.bwd_plan(rows, in_size, hidden, optin)
            p = lstm_cell.bwd_dx_plan(rows, in_size, hidden, optin)
            # the full launch's row tiles; its k-parts where they already give
            # BWD_ROW_TARGET blocks, else k cut finer (into kw / BWD_DX_MIN_K
            # parts at most) for more blocks. Each k sums the units in one order
            # whatever the parts, so the same dx, dh_prev and dc_prev
            assert p.tile_rows == full.tile_rows, (rows, optin)
            tiles = -(-rows // p.tile_rows)
            if tiles * full.row_kparts >= lstm_cell.BWD_ROW_TARGET:
                assert p[:5] == full[:5], (rows, optin)
            else:
                assert full.row_kparts <= p.row_kparts and p.row_k <= full.row_k
                assert p.row_kparts <= max(full.row_kparts,
                                           -(-kw // lstm_cell.BWD_DX_MIN_K)), (rows, optin)
                assert p.row_blocks == min(tiles * p.row_kparts, lstm_cell.BWD_ROW_BLOCKS)
                assert p.row_blocks > full.row_blocks or p.row_k == min(kw, full.row_k)
            # no column blocks, no chunk scratch (chunks 0), no tickets
            assert (p.col_k, p.col_kparts, p.col_units, p.slices, p.chunks, p.chunk_rows,
                    p.sub_rows) == (0,) * 7
            assert p.blocks == p.row_blocks <= lstm_cell.BWD_ROW_BLOCKS
            # the row blocks' layout, within the opt-in limit and the budget
            per_unit = 16 * (p.row_k | 1) + 16 * p.tile_rows
            assert p.smem == p.row_units * per_unit <= min(optin, lstm_cell.BWD_SMEM)
            assert p.row_k * (p.tile_rows // 4) <= lstm_cell.BWD_THREADS
            assert p.row_k * p.row_kparts >= kw


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS)
@pytest.mark.parametrize("sm_count", [H100_SMS, 114])
def test_bwd_dx_tc_plan_is_row_blocks_with_no_cluster(in_size, hidden, sm_count):
    for rows in _DX_ROWS:
        p = lstm_cell.bwd_dx_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count)
        full = lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, sm_count)
        # row blocks at every batch size: no column block, cluster 1, no
        # chunk of [x | h | 1] (x and h are not read), so no scratch or ticket
        assert p.row_blocks == p.blocks and p.cluster == 1 and p.col_rows == 0
        assert (p.copy_x, p.copy_h) == (0, 0)
        # the staged widths are the full launch's
        assert p[6:10] == full[6:10]
        # the row-block layout alone, within the opt-in limit
        assert p.smem == lstm_cell.bwd_tc_smem(p.m_tiles, in_size, hidden, dx_only=True)
        assert p.smem <= H100_SMEM_OPTIN
        # every row in one (block, tile), no block past the batch
        tile = 16 * p.m_tiles
        n_tiles = -(-rows // tile)
        assert p.blocks * p.tiles >= n_tiles > (p.blocks - 1) * p.tiles
        # at most one tile per SM where a tile of 64 rows allows, else 64-row
        # tiles; the fewest m-tiles that do so
        if p.tiles > 1:
            assert p.m_tiles == 4 and p.blocks <= sm_count
        else:
            assert p.blocks <= sm_count or p.m_tiles == 4
            assert p.m_tiles == 1 or -(-rows // (8 * p.m_tiles)) > sm_count


@pytest.mark.parametrize("in_size,hidden", _BWD_TC_WIDTHS + _WIDE_WIDTHS + _WIDE_BWD)
def test_bwd_dx_tc_plan_takes_the_widths_the_full_launch_takes(in_size, hidden):
    # a width's dx-only and full bf16 launches run one kernel: the tensor
    # cores where bwd_tc_plan takes the width, else the templated kernel
    for rows in (1, 256, 2048, 16384):
        full = lstm_cell.bwd_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
        p = lstm_cell.bwd_dx_tc_plan(rows, in_size, hidden, H100_SMEM_OPTIN, H100_SMS)
        assert (p is None) == (full is None), (rows, in_size, hidden)


def test_bwd_dx_tc_plan_at_the_main_path_shapes():
    # (rows, I) -> (m_tiles, tiles, blocks, smem) on an H100 at H = 40
    for (rows, in_size), want in {
            (8, 14): (1, 1, 1, 50_880), (64, 40): (1, 1, 4, 57_088),
            (256, 14): (1, 1, 16, 50_880), (2_048, 40): (1, 1, 128, 57_088),
            (4_096, 40): (2, 1, 128, 87_296), (16_384, 40): (4, 2, 128, 147_712)}.items():
        p = lstm_cell.bwd_dx_tc_plan(rows, in_size, 40, H100_SMEM_OPTIN, H100_SMS)
        assert (p.m_tiles, p.tiles, p.blocks, p.smem) == want, (rows, in_size)
