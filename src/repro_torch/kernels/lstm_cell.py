"""K3, K4, K5: the fused LSTM cell, its training forward and its backward.

All three live in ``csrc/lstm_cell.cu`` and replace the Pallas TPU kernels
of ``src/repro/kernels/lstm_cell.py``: K3 ``_lstm_kernel`` (the inference
forward), K4 ``_lstm_fwd_kernel`` (the same forward, also writing the gate
activations ``(B, 4H)`` the backward needs) and K5 ``_lstm_bwd_kernel``.
In float32 K3 and K4 are one kernel (with a second for widths past the presets'):
the weights in shared memory, each thread one hidden unit of 4 or 8 rows, a
persistent grid over row tiles; both keep the ``(B, 4H)`` gates out of
device memory. K5 is one launch of two kinds of
block: row blocks form ``dx``, ``dh_prev`` and ``dc_prev`` per row tile,
column blocks sum the weight gradients over the batch in an order fixed by
the shape (no float atomics), so it is deterministic. See the source for
the design and bounds.

Every width runs: :func:`cell_plan` and :func:`bwd_plan` size each launch
from the shape and the device's limits (:func:`~repro_torch.kernels.build.device_limits`)
-- k-chunks of the weights and unit slices where they do not fit one block
-- and pass the plan to the kernel.

:class:`LSTMCell` is the ``torch.autograd.Function`` around K4/K5 (the
counterpart of the JAX ``custom_vjp``); the plain versions are
:func:`~repro_torch.kernels.ref.lstm_cell_ref`,
:func:`~repro_torch.kernels.ref.lstm_cell_fwd_ref` and
:func:`~repro_torch.kernels.ref.lstm_cell_bwd_ref`, which the same Function
runs on CPU tensors.

All three also take bf16 (the bf16 policy's stream, every input in bf16).
K3 and K4 in bf16 run their own kernel, ``csrc/lstm_cell_tc.cu``: the gate
products on the tensor cores (``mma.sync``, bf16 in, float32 sums), the
gate columns permuted as the weights are staged so that each lane holds the
four gates of one unit, double-buffered ``cp.async`` row tiles, and h', c'
(and K4's activations) rounded to bf16 once and stored as whole rows from
shared memory; :func:`cell_tc_plan` sizes its launch. Widths past the
presets' (where :func:`cell_plan` takes the wide kernel) run the wide kernel
in bf16. K5 is templated on the element type: it widens as it loads,
computes in float32, rounds dx, dh_prev and dc_prev once and returns the
weight gradients as float32 sums over the batch, which :class:`LSTMCell`
rounds to the weight dtype once, as the reference's ``custom_vjp`` does.
K5 in bf16 runs its own kernel, ``csrc/lstm_cell_bwd_tc.cu``, at the
presets' widths: each float32 gate cotangent is split into three bf16 terms
that sum to it exactly (:func:`split_bf16`), so both products run on the
tensor cores and differ from the plain version only in summation order.
Up to 512 rows row blocks form dx and dh_prev while column blocks sum whole
gate columns of the weight gradients over the batch; above, blocks form
both for their row tiles and their partials are summed across a
thread-block cluster through distributed shared memory and across clusters
by tickets; every order is fixed by the shape (:func:`bwd_tc_plan`). Past
those widths the bf16 stream runs the templated K5 (:func:`bwd_launch`
names the kernel of a call).

Where the weights need no gradient (the esn head's frozen reservoir),
:class:`LSTMCell` takes K5's dx-only launch (:func:`lstm_cell_bwd_dx`): the
row blocks alone, in the same kernels, forming dx, dh_prev and dc_prev with
the full launch's bits and no weight gradient, scratch or ticket
(:func:`bwd_dx_plan`, :func:`bwd_dx_tc_plan`, :func:`bwd_dx_launch`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref, shapes

# K3/K4's geometry (csrc/lstm_cell.cu, lstm_cell_smem)
CELL_GROUPS = 8          # row groups of threads per block, at most
CELL_BIG_TILES = 3       # 64-row tiles per SM from which 8 rows per thread pay
CELL_PAD = 4             # floats of padding per staged input row
CELL_MAX_THREADS = 512   # threads per block, at most (86 registers each at 8 rows)
CELL_WIDE_UNITS = 32     # units per block of the wide kernel
CELL_WIDE_R = 4          # rows per thread of the wide kernel
CELL_SUM_BLOCK = 128     # k per block of the gate sums, above I + H = 128

# K5's geometry (csrc/lstm_cell.cu, lstm_bwd)
BWD_THREADS = 256        # threads per block, both kinds
BWD_ROW_TARGET = 128     # row tiles aimed at (tiles shrink to 4 rows for it)
BWD_ROW_BLOCKS = 128     # row blocks at most; they loop over the tiles
BWD_COL_TARGET = 128     # column blocks aimed at
BWD_CHUNK_ROWS = 32      # rows per chunk of the weight-gradient sums ...
BWD_MAX_CHUNKS = 32      # ... up to this many chunks
BWD_SUB_ROWS = 128       # rows a column block stages at once, at most
BWD_SMEM = 100 * 1024    # shared memory per K5 block, at most (two blocks per SM)
BWD_DX_MIN_K = 16        # a dx-only launch cuts k into kw / BWD_DX_MIN_K parts at most

# K3/K4's bf16 geometry on the tensor cores (csrc/lstm_cell_tc.cu, lstm_cell_tc)
TC_QMAX = 8              # quads of 4 units (16 gate columns) a warp holds, at most
TC_PAD = 8               # bf16 of padding per staged row of [x | h] and of the weights
TC_MAX_WARPS = 8         # warps per block, at most
TC_SMALL_QUADS = 2       # quads a warp takes where the batch does not fill the card ...
TC_FILL = 8              # ... with TC_FILL warps an SM at the largest slices
TC_DEEP = 8              # half-size tiles an SM from which half-size blocks pay

# K5's bf16 geometry on the tensor cores (csrc/lstm_cell_bwd_tc.cu, lstm_cell_bwd_tc)
BWD_TC_WARPS = 16        # warps per block
BWD_TC_MTILES = 4        # 16-row m-tiles a row tile holds, at most
BWD_TC_CLUSTER = 8       # blocks per thread-block cluster, at most
BWD_TC_BLOCKS = 120      # blocks a large batch is cut into, at most, so that its clusters of 8
                         # are resident at once on an H100. A constant, not read from the card:
                         # the blocks fix the weight-gradient sums' order
BWD_TC_TERMS = 3         # bf16 terms each float32 cotangent is split into
BWD_TC_SPLIT_ROWS = 512  # batches up to this many rows take the split plan (no cross-block sum)
BWD_TC_COL_UNITS = 4     # units of a column block of the split plan
BWD_TC_COL_ROWS = 512    # rows a column block stages at once, at most

# the constants above that csrc/lstm_cell.cu also uses, and the lengths of the
# two plans, in the order its repro_lstm_cell_constants reports them; those
# of csrc/lstm_cell_tc.cu, in the order of repro_lstm_cell_tc_constants; and
# those of csrc/lstm_cell_bwd_tc.cu, in the order of
# repro_lstm_cell_bwd_tc_constants
_C_CONSTANTS = ("CELL_PAD", "CELL_SUM_BLOCK", "CELL_WIDE_R", "BWD_THREADS",
                "CellPlan", "BwdPlan")
_TC_CONSTANTS = ("TC_QMAX", "TC_PAD", "TC_MAX_WARPS", "TcPlan")
_BWD_TC_CONSTANTS = ("BWD_TC_WARPS", "BWD_TC_MTILES", "BWD_TC_CLUSTER", "BWD_TC_TERMS",
                     "TC_PAD", "BWD_TC_COL_UNITS", "BwdTcPlan")

# launches since the last reset (kernels.ops.reset_launch_counts)
launches = 0                     # K3, float32
bf16_launches = 0                # K3, bf16
fwd_launches = 0                 # K4, float32
fwd_bf16_launches = 0            # K4, bf16
bwd_launches = 0                 # K5, float32
bwd_bf16_launches = 0            # K5, bf16
bwd_dx_launches = 0              # K5's dx-only launch, float32
bwd_dx_bf16_launches = 0         # K5's dx-only launch, bf16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class CellPlan(NamedTuple):
    """A K3/K4 launch; the kernel takes these ints in this order."""
    cell_r: int      # rows per thread (4 or 8)
    groups: int      # row groups that compute; a tile is groups * cell_r rows
    units: int       # hidden units per block: all H, or a slice
    slices: int      # unit slices (the grid's second dimension)
    threads: int     # threads per block, a multiple of units
    k_chunk: int     # rows of [Wx; Wh] staged at once (I + H: all, once per block)
    wide: int        # 1: the lstm_cell_wide kernel (slices, k-chunks or I + H > 128)
    smem: int        # dynamic shared memory, bytes


@functools.lru_cache(maxsize=4096)
def cell_plan(rows: int, in_size: int, hidden: int, smem_optin: int,
              sm_count: int) -> CellPlan:
    """K3/K4's geometry for one shape on a device with ``sm_count`` SMs and
    ``smem_optin`` bytes of opt-in shared memory per block.

    * all H units in one block, 4 rows per thread up to three 64-row tiles
      per SM and 8 above, 8 row groups (fewer if a block would pass 512
      threads, and fewer still below a full tile per SM, so small batches
      spread out), all of ``[Wx; Wh]`` staged once: the ``lstm_cell_smem``
      kernel, which every preset's width takes;
    * else (H > 512, I + H > 128, or weights past the opt-in limit) the
      wide kernel: unit slices of 32 (the grid's second dimension), 8
      groups of 4 rows, the gate sums in blocks of 128 k, and the weights
      in k-chunks, the most k rows that fit, where they do not fit whole.

    Within each kernel the sums run in the same order in every geometry.
    """
    kw = in_size + hidden

    cell_r = 4 if rows <= CELL_BIG_TILES * 64 * sm_count else 8
    units = hidden
    block_groups = min(CELL_GROUPS, CELL_MAX_THREADS // units) if units <= CELL_MAX_THREADS else 0
    groups = min(block_groups, max(1, _cdiv(rows, cell_r * sm_count)))
    per_k = 4 * (4 * units + groups * cell_r + CELL_PAD)   # a k row: weights + tile
    wide = block_groups == 0 or kw > CELL_SUM_BLOCK or kw * per_k > smem_optin
    if wide:
        # slices of CELL_WIDE_UNITS units, 8 groups of 4 rows: the weights
        # spread over more blocks, and a k row of them stays small, so they
        # are staged whole wherever I + H <= 354
        cell_r, units = CELL_WIDE_R, min(hidden, CELL_WIDE_UNITS)
        block_groups = CELL_GROUPS
        groups = min(block_groups, _cdiv(rows, cell_r))
        per_k = 4 * (4 * units + groups * cell_r + CELL_PAD)
    slices = _cdiv(hidden, units)
    threads = block_groups * units
    k_chunk = kw if kw * per_k <= smem_optin else smem_optin // per_k
    return CellPlan(cell_r, groups, units, slices, threads, k_chunk, int(wide), k_chunk * per_k)


class TcPlan(NamedTuple):
    """A launch of the bf16 cell on the tensor cores (``csrc/lstm_cell_tc.cu``);
    the kernel takes these ints in this order."""
    m_tiles: int     # 16-row m-tiles per row tile: a tile is 16 m_tiles rows
    slices: int      # unit slices per m-tile: a block is m_tiles x slices warps
    quads: int       # quads of 4 units per slice, at most TC_QMAX
    k_x: int         # k of the first h column: I rounded up to 8
    k_pad: int       # k_x + H rounded up to 16
    n_pad: int       # permuted gate columns: 16 per quad, slices x quads quads
    copy_w: int      # bytes per load of one gate's units in a weight row (2, 4 or 8)
    copy_x: int      # bytes per copy of an x row
    copy_h: int      # bytes per copy of an h row
    copy_c: int      # bytes per copy of c's tile (one contiguous run)
    copy_out: int    # bytes per store of h', c' and act (contiguous runs)
    act: int         # 1: K4, which writes act
    smem: int        # dynamic shared memory, bytes

    @property
    def tile(self) -> int:
        return 16 * self.m_tiles

    @property
    def warps(self) -> int:
        return self.m_tiles * self.slices


def tc_column(gate: int, unit: int) -> int:
    """The staged column of gate ``gate`` (0 to 3: i, f, g, o) of unit
    ``unit`` in the tensor-core kernel, which stages the weights by this map.

    16 columns per quad of 4 units: (i, f) of the quad in its first 8-column
    n-tile, (g, o) in its second, unit u of the quad at columns 2u and
    2u + 1 of each. The lane l of an m16n8 accumulator fragment holds
    columns 2 (l % 4) and 2 (l % 4) + 1 of an n-tile, so over the quad's two
    n-tiles it holds all four gates of unit l % 4.
    """
    return 16 * (unit // 4) + 8 * (gate // 2) + 2 * (unit % 4) + gate % 2


def _copy_width(align: int, row_bytes: int = 16) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that a stream's base address
    (aligned to ``align`` bytes) and its row length allow; a contiguous run
    starting on the base (c's tile, the outputs') has no rows to divide."""
    return next(w for w in (16, 8, 4, 2) if align % w == 0 and row_bytes % w == 0)


def tc_smem(m_tiles: int, k_pad: int, n_pad: int, hidden: int, act: int) -> int:
    """Shared memory of the tensor-core kernel's layout, bytes: the permuted
    weights, the float biases, two [x | h] tiles, two c tiles, and h', c'
    (and act) staged, each a multiple of 16 bytes."""
    tile = 16 * m_tiles
    run = lambda n: 16 * _cdiv(2 * n, 16)         # n bf16 in whole 16-byte units
    return (2 * k_pad * (n_pad + TC_PAD) + 4 * n_pad + 2 * 2 * tile * (k_pad + TC_PAD)
            + 2 * run(tile * hidden) + 2 * run(tile * hidden)
            + (run(4 * tile * hidden) if act else 0))


@functools.lru_cache(maxsize=4096)
def cell_tc_plan(rows: int, in_size: int, hidden: int, smem_optin: int, sm_count: int,
                 act: int, align_w: int = 16, align_x: int = 16, align_h: int = 16,
                 align_c: int = 16, align_out: int = 16) -> Optional[TcPlan]:
    """K3's (``act=0``) or K4's (``act=1``) bf16 launch on the tensor cores
    for one shape, or None where the shape takes the wide kernel (where
    :func:`cell_plan` does: the bf16 stream runs the new kernel at every
    width ``lstm_cell_smem`` takes). ``align_*``: the largest power of two,
    up to 16, dividing the base address of the weights (both), x, h, c and
    the outputs (all).

    * a warp takes 16 rows and a slice of at most TC_QMAX quads of units:
      the fewest slices, unless the m-tiles times those slices give fewer
      than TC_FILL warps an SM, where the slices take TC_SMALL_QUADS quads
      (at most TC_MAX_WARPS slices), so a small batch spreads out;
    * up to TC_MAX_WARPS warps a block, or half that (32-row tiles at
      H = 40) where the batch holds TC_DEEP such half tiles an SM: more,
      smaller blocks then overlap one tile's loads with another's update;
      m-tiles per row tile halved further while there are fewer tiles than
      SMs or the layout passes the opt-in shared memory;
    * each stream's copy width from its rows and base (:func:`_copy_width`):
      x and h row by row (16 bytes where the rows align: I and H multiples
      of 8), c and the outputs as contiguous runs per tile; the weights 4,
      2 or 1 units of a gate a load (8, 4 or 2 bytes), as H and their base
      allow.

    The quads past H (a slice of the last quad's units, and whole quads
    where slices x quads passes H / 4) carry zero weights.

    The sums run in the same order in every plan.
    """
    if cell_plan(rows, in_size, hidden, smem_optin, sm_count).wide:
        return None
    hq = _cdiv(hidden, 4)
    k_x = 8 * _cdiv(in_size, 8)
    k_pad = 16 * _cdiv(k_x + hidden, 16)
    slices = _cdiv(hq, TC_QMAX)
    if _cdiv(rows, 16) * slices < TC_FILL * sm_count:
        slices = max(slices, min(TC_MAX_WARPS, _cdiv(hq, TC_SMALL_QUADS)))
    quads = _cdiv(hq, slices)
    slices = _cdiv(hq, quads)                     # no empty slice
    n_pad = 16 * slices * quads
    m_tiles = max(1, TC_MAX_WARPS // slices)
    if m_tiles > 1 and _cdiv(rows, 16 * (m_tiles // 2)) >= TC_DEEP * sm_count:
        m_tiles //= 2
    while m_tiles > 1 and (_cdiv(rows, 16 * m_tiles) < sm_count
                           or tc_smem(m_tiles, k_pad, n_pad, hidden, act) > smem_optin):
        m_tiles //= 2
    smem = tc_smem(m_tiles, k_pad, n_pad, hidden, act)
    if smem > smem_optin:
        raise ValueError(f"cell_tc_plan: no layout of ({in_size}, {hidden}) fits "
                         f"{smem_optin} bytes of shared memory")
    copy_w = next(w for w in (8, 4, 2) if hidden % (w // 2) == 0 and align_w % w == 0)
    return TcPlan(m_tiles, slices, quads, k_x, k_pad, n_pad, copy_w,
                  _copy_width(align_x, 2 * in_size),
                  _copy_width(align_h, 2 * hidden), _copy_width(align_c),
                  _copy_width(align_out), act, smem)


class BwdPlan(NamedTuple):
    """A K5 launch; the kernel takes these ints in this order."""
    tile_rows: int   # rows per row tile (a multiple of 4)
    row_k: int       # inputs of dx | dh_prev per row block
    row_kparts: int
    row_units: int   # units whose weights and cotangents are staged at once
    row_blocks: int  # row blocks (the first of the grid)
    col_k: int       # rows of [x | h | 1] per column block (a multiple of 4)
    col_kparts: int
    col_units: int   # units per column block
    slices: int      # unit slices of the column blocks
    chunks: int      # row chunks of the weight-gradient sums
    chunk_rows: int
    sub_rows: int    # rows a column block stages at once
    smem: int        # dynamic shared memory, bytes

    @property
    def blocks(self) -> int:
        return self.row_blocks + self.col_kparts * self.slices * self.chunks


@functools.lru_cache(maxsize=4096)
def bwd_plan(rows: int, in_size: int, hidden: int, smem_optin: int) -> BwdPlan:
    """K5's geometry for one shape (and the device's opt-in shared memory,
    which only caps the staging sizes).

    Row blocks: a thread owns one k and 4 rows, so a tile has up to
    ``4 * (256 // (I + H))`` rows (16 at most; above I + H = 256, 16 rows
    and k-parts of 64), cut to 4 at small batches for more tiles; weights
    and cotangents are staged for as many units as fit BWD_SMEM. Column
    blocks: a thread owns 4 k and one unit; k-parts of 64 above
    I + H + 1 = 128, unit slices sized for about BWD_COL_TARGET blocks.

    The row chunks of the weight-gradient sums, and with them the order of
    every sum, depend on ``rows`` alone: chunks of 32 rows, at most 32 of
    them. Nothing here depends on the SM count.
    """
    kw = in_size + hidden
    budget = min(smem_optin, BWD_SMEM)
    # row blocks
    if kw <= BWD_THREADS:
        row_k, r_max = kw, 4 * min(4, BWD_THREADS // kw)
    else:
        row_k, r_max = BWD_THREADS // 4, 16
    tile_rows = min(r_max, max(4, 4 * _cdiv(_cdiv(rows, BWD_ROW_TARGET), 4)))
    row_kparts = _cdiv(kw, row_k)
    per_unit = 16 * (row_k | 1) + 16 * tile_rows      # weights of a unit + its cotangents
    row_units = min(hidden, budget // per_unit)
    row_blocks = min(_cdiv(rows, tile_rows) * row_kparts, BWD_ROW_BLOCKS)
    # column blocks
    col_k = 4 * _cdiv(kw + 1, 4) if kw + 1 <= 128 else 64
    col_kparts = _cdiv(kw + 1, col_k)
    chunk_rows = _cdiv(rows, min(BWD_MAX_CHUNKS, _cdiv(rows, BWD_CHUNK_ROWS)))
    chunks = _cdiv(rows, chunk_rows)
    max_units = BWD_THREADS // (col_k // 4)
    want_slices = _cdiv(BWD_COL_TARGET, chunks * col_kparts)
    col_units = min(max_units, _cdiv(hidden, want_slices))
    slices = _cdiv(hidden, col_units)
    per_row = 4 * col_k + 16 * col_units              # a row of inputs + its cotangents
    sub_rows = min(chunk_rows, BWD_SUB_ROWS, budget // per_row)
    smem = max(row_units * per_unit, sub_rows * per_row)
    return BwdPlan(tile_rows, row_k, row_kparts, row_units, row_blocks, col_k, col_kparts,
                   col_units, slices, chunks, chunk_rows, sub_rows, smem)


@functools.lru_cache(maxsize=4096)
def bwd_dx_plan(rows: int, in_size: int, hidden: int, smem_optin: int) -> BwdPlan:
    """K5's dx-only launch in float32 (and bf16 past the presets' widths):
    row blocks alone, every column field 0 -- no column blocks, chunk
    scratch or tickets -- and the shared memory of the row blocks' layout.

    The row tiles are :func:`bwd_plan`'s. Where they are fewer than
    BWD_ROW_TARGET, k is cut into more parts (kw / BWD_DX_MIN_K at most)
    for up to BWD_ROW_TARGET blocks: with no column blocks beside them, the
    few row blocks of a small batch would each stage every weight. Each
    thread sums one k over the units in the same order whatever the parts
    and staged units, so dx, dh_prev and dc_prev are the full launch's
    bits."""
    p = bwd_plan(rows, in_size, hidden, smem_optin)
    kw = in_size + hidden
    tiles = _cdiv(rows, p.tile_rows)
    parts = max(p.row_kparts, min(_cdiv(kw, BWD_DX_MIN_K), _cdiv(BWD_ROW_TARGET, tiles)))
    row_k = p.row_k if parts == p.row_kparts else _cdiv(kw, parts)
    per_unit = 16 * (row_k | 1) + 16 * p.tile_rows
    row_units = min(hidden, min(smem_optin, BWD_SMEM) // per_unit)
    return p._replace(row_k=row_k, row_kparts=_cdiv(kw, row_k), row_units=row_units,
                      row_blocks=min(tiles * _cdiv(kw, row_k), BWD_ROW_BLOCKS), col_k=0,
                      col_kparts=0, col_units=0, slices=0, chunks=0, chunk_rows=0, sub_rows=0,
                      smem=row_units * per_unit)


class BwdTcPlan(NamedTuple):
    """A launch of K5 in bf16 on the tensor cores (``csrc/lstm_cell_bwd_tc.cu``);
    the kernel takes these ints in this order."""
    m_tiles: int     # 16-row m-tiles per row tile: a tile is 16 m_tiles rows
    tiles: int       # row tiles a block walks, in order
    blocks: int      # blocks of the grid, a multiple of cluster
    cluster: int     # blocks per thread-block cluster
    row_blocks: int  # split plan: the blocks of [dx | dh_prev], then the column blocks of
                     # BWD_TC_COL_UNITS units; 0: the cluster plan
    col_rows: int    # split plan: rows a column block stages at once
    k_x: int         # staged column of the first h input: I rounded up to 8
    k_w: int         # staged weight rows: k_x + H rounded up to 16
    k_pad: int       # staged columns of [x | h | 1]: k_x + H + 1 rounded up to 16
    n_pad: int       # gate columns: 4H rounded up to 16
    copy_w: int      # bytes per copy of a weight row
    copy_x: int      # bytes per copy of an x row
    copy_h: int      # bytes per copy of an h row
    copy_r: int      # bytes per copy of the runs of act, c, c', dh and dc
    copy_out: int    # bytes per store of the runs of dx, dh_prev and dc_prev
    smem: int        # dynamic shared memory, bytes

    @property
    def tile(self) -> int:
        return 16 * self.m_tiles

    @property
    def clusters(self) -> int:
        return self.blocks // self.cluster


def _bwd_tc_widths(in_size: int, hidden: int):
    """(k_x, k_w, k_pad, n_pad) of the tensor-core K5's staged layout."""
    k_x = 8 * _cdiv(in_size, 8)
    return k_x, 16 * _cdiv(k_x + hidden, 16), 16 * _cdiv(k_x + hidden + 1, 16), \
        16 * _cdiv(4 * hidden, 16)


def bwd_tc_smem(m_tiles: int, in_size: int, hidden: int, col_rows: int = 0,
                dx_only: bool = False) -> int:
    """Shared memory of the tensor-core K5's layout, bytes.

    The cluster plan (``col_rows`` 0): the weights as bf16 [k][gate column],
    the block's float32 partial weight gradients, a tile of [x | h | 1], the
    tile's runs of act, c, c', dh and dc, the three bf16 terms of its
    cotangents, and dx, dh_prev and dc_prev staged; each row read by
    ldmatrix padded by TC_PAD bf16. The split plan: the larger of its row
    blocks' layout (the same without the partial and [x | h | 1]) and its
    column blocks' (``col_rows`` rows of [x | h | 1], of the slice's
    residuals and of its terms, and a float32 16 x 16 partial per warp's
    k-part of each m-tile of the staged inputs). ``dx_only``: the split
    plan's row-block layout alone (the dx-only launch)."""
    k_x, k_w, k_pad, n_pad = _bwd_tc_widths(in_size, hidden)
    tile = 16 * m_tiles
    run = lambda n: 16 * _cdiv(2 * n, 16)         # n bf16 in whole 16-byte units
    w_stride = 2 * (n_pad + TC_PAD)
    x_stride = 2 * (k_pad + TC_PAD)
    split = col_rows > 0
    rows = (k_w * w_stride + run(4 * tile * hidden) + 4 * run(tile * hidden)
            + BWD_TC_TERMS * tile * w_stride + run(tile * in_size) + 2 * run(tile * hidden))
    if dx_only:
        return rows
    if not split:
        return rows + 4 * (in_size + hidden + 1) * (n_pad + TC_PAD) + tile * x_stride
    m2 = k_pad // 16
    ksplit = max(1, BWD_TC_WARPS // m2)
    cols = (col_rows * x_stride + run(8 * BWD_TC_COL_UNITS * col_rows)
            + BWD_TC_TERMS * col_rows * 2 * (4 * BWD_TC_COL_UNITS + TC_PAD) + m2 * ksplit * 1024)
    return max(rows, cols)


@functools.lru_cache(maxsize=4096)
def bwd_tc_plan(rows: int, in_size: int, hidden: int, smem_optin: int, sm_count: int,
                align_w: int = 16, align_x: int = 16, align_h: int = 16, align_r: int = 16,
                align_out: int = 16) -> Optional[BwdTcPlan]:
    """K5's bf16 launch on the tensor cores for one shape, or None where even
    16-row tiles of the cluster plan would pass ``smem_optin`` (the widths
    past the presets', H = 64 and up at I = H, which run the templated K5).
    ``align_*``: the largest power of two, up to 16, dividing the base address
    of the weights (both), x, h, the residuals (act, c, c', dh, dc: all) and
    the outputs (dx, dh_prev, dc_prev: all).

    * Up to BWD_TC_SPLIT_ROWS rows, the split plan: row blocks of 16 rows
      (32 past 128 rows) form dx, dh_prev and dc_prev, and column blocks of
      BWD_TC_COL_UNITS units each sum their gate columns of the weight
      gradients over the whole batch, the batch at once where its rows fit
      the shared memory (else in chunks of half as many, down to 16): no
      block's sum meets another's, so there is no cluster, scratch or ticket.
    * Above, the cluster plan: tiles of 16 m_tiles rows, the fewest m-tiles
      (1, 2 or 4) that make at most BWD_TC_BLOCKS tiles (one a block), else
      the most whose layout fits, the tiles cut into at most BWD_TC_BLOCKS
      blocks, in clusters of BWD_TC_CLUSTER whose partials meet through
      distributed shared memory, the clusters' through tickets.
    * Each stream's copy width from its rows and base (:func:`_copy_width`):
      weight rows (8H bytes), x and h rows; the residuals and the outputs as
      contiguous runs per tile.

    Every sum's order follows from the plan, which depends on the shape (and
    the opt-in limit, through the tile) alone: ``sm_count`` does not enter,
    so the same inputs give the same bits on any card of the kind.
    """
    fits = [m for m in (BWD_TC_MTILES, 2, 1) if bwd_tc_smem(m, in_size, hidden) <= smem_optin]
    if not fits:
        return None
    m16 = _cdiv(rows, 16)
    col_rows = row_blocks = 0
    if rows <= BWD_TC_SPLIT_ROWS:
        m_tiles = 1 if rows <= 128 else 2
        col_rows = min(BWD_TC_COL_ROWS, 16 * m16)
        while col_rows > 16 and bwd_tc_smem(m_tiles, in_size, hidden, col_rows) > smem_optin:
            col_rows = 16 * _cdiv(col_rows // 2, 16)
        row_blocks = _cdiv(m16, m_tiles)
        tiles, cluster = 1, 1
        blocks = row_blocks + _cdiv(hidden, BWD_TC_COL_UNITS)
        if bwd_tc_smem(m_tiles, in_size, hidden, col_rows) > smem_optin:
            return None
    else:
        # the smallest tile that gives every block one tile, else the largest
        m_tiles = next((m for m in (1, 2, BWD_TC_MTILES)
                        if m <= fits[0] and _cdiv(m16, m) <= BWD_TC_BLOCKS), fits[0])
        cluster = BWD_TC_CLUSTER
        n_tiles = _cdiv(m16, m_tiles)
        tiles = _cdiv(n_tiles, BWD_TC_BLOCKS)
        blocks = cluster * _cdiv(_cdiv(n_tiles, tiles), cluster)
    k_x, k_w, k_pad, n_pad = _bwd_tc_widths(in_size, hidden)
    return BwdTcPlan(m_tiles, tiles, blocks, cluster, row_blocks, col_rows,
                     k_x, k_w, k_pad, n_pad,
                     _copy_width(align_w, 8 * hidden), _copy_width(align_x, 2 * in_size),
                     _copy_width(align_h, 2 * hidden), _copy_width(align_r),
                     _copy_width(align_out), bwd_tc_smem(m_tiles, in_size, hidden, col_rows))


@functools.lru_cache(maxsize=4096)
def bwd_dx_tc_plan(rows: int, in_size: int, hidden: int, smem_optin: int, sm_count: int,
                   align_w: int = 16, align_r: int = 16,
                   align_out: int = 16) -> Optional[BwdTcPlan]:
    """K5's dx-only launch in bf16 on the tensor cores, at the widths where
    :func:`bwd_tc_plan` takes them (else None: the templated kernel's
    dx-only launch runs), so a width's two launches run one kernel.

    Row blocks alone at every batch size, cluster size 1, the split plan's
    row-block layout (:func:`bwd_tc_smem` with ``dx_only``); x and h are not
    read (``copy_x`` and ``copy_h`` 0). Its tiles: the fewest m-tiles (1, 2
    or 4) that give each of the ``sm_count`` SMs at most one tile, else the
    most whose layout fits, walked ``tiles`` to a block. The plan sets no
    sum order: each row's dx and dh_prev sum k-step by k-step, term by term,
    whatever the tile, so they are the full launch's bits on any card.
    """
    if bwd_tc_smem(1, in_size, hidden) > smem_optin:
        return None
    fits = [m for m in (BWD_TC_MTILES, 2, 1)
            if bwd_tc_smem(m, in_size, hidden, dx_only=True) <= smem_optin]
    m16 = _cdiv(rows, 16)
    m_tiles = next((m for m in (1, 2, BWD_TC_MTILES)
                    if m <= fits[0] and _cdiv(m16, m) <= sm_count), fits[0])
    n_tiles = _cdiv(m16, m_tiles)
    tiles = _cdiv(n_tiles, sm_count)
    blocks = _cdiv(n_tiles, tiles)
    k_x, k_w, k_pad, n_pad = _bwd_tc_widths(in_size, hidden)
    return BwdTcPlan(m_tiles, tiles, blocks, 1, blocks, 0, k_x, k_w, k_pad, n_pad,
                     _copy_width(align_w, 8 * hidden), 0, 0, _copy_width(align_r),
                     _copy_width(align_out), bwd_tc_smem(m_tiles, in_size, hidden, dx_only=True))


def split_bf16(d: torch.Tensor):
    """A float32 tensor as three bf16 tensors that sum to it exactly, as
    ``csrc/lstm_cell_bwd_tc.cu`` splits each gate cotangent:
    ``d0 = bf16(d)``, ``d1 = bf16(d - d0)``, ``d2 = bf16(d - d0 - d1)``.

    Each difference is exact in float32 (the rounding error of a float32
    rounded to fewer bits), and what is left after two roundings to bf16's
    8 significant bits has at most 8 of them, so ``d2`` is exact too and
    ``d0 + d1 + d2 == d`` for finite ``d`` with ``|d| >= 2**-100`` (below
    that ``d2`` can fall past bf16's smallest subnormal). A product of a
    term and a bf16 value is exact in float32.
    """
    d0 = d.to(torch.bfloat16)
    r1 = d - d0.float()
    d1 = r1.to(torch.bfloat16)
    return d0, d1, (r1 - d1.float()).to(torch.bfloat16)


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The kernel library, once it has shown that ``csrc/lstm_cell.cu``,
    ``csrc/lstm_cell_tc.cu`` and ``csrc/lstm_cell_bwd_tc.cu`` were built with
    the constants and plan lengths this module sizes launches by (a mismatch
    would overrun shared memory or change the sum order)."""
    lib = build.library()
    want = {"CELL_PAD": CELL_PAD, "CELL_SUM_BLOCK": CELL_SUM_BLOCK,
            "CELL_WIDE_R": CELL_WIDE_R, "BWD_THREADS": BWD_THREADS,
            "CellPlan": len(CellPlan._fields), "BwdPlan": len(BwdPlan._fields)}
    want_tc = {"TC_QMAX": TC_QMAX, "TC_PAD": TC_PAD, "TC_MAX_WARPS": TC_MAX_WARPS,
               "TcPlan": len(TcPlan._fields)}
    want_bwd_tc = {"BWD_TC_WARPS": BWD_TC_WARPS, "BWD_TC_MTILES": BWD_TC_MTILES,
                   "BWD_TC_CLUSTER": BWD_TC_CLUSTER, "BWD_TC_TERMS": BWD_TC_TERMS,
                   "TC_PAD": TC_PAD, "BWD_TC_COL_UNITS": BWD_TC_COL_UNITS,
                   "BwdTcPlan": len(BwdTcPlan._fields)}
    for source, names, query, expected in (
            ("lstm_cell.cu", _C_CONSTANTS, lib.repro_lstm_cell_constants, want),
            ("lstm_cell_tc.cu", _TC_CONSTANTS, lib.repro_lstm_cell_tc_constants, want_tc),
            ("lstm_cell_bwd_tc.cu", _BWD_TC_CONSTANTS, lib.repro_lstm_cell_bwd_tc_constants,
             want_bwd_tc)):
        got = (ctypes.c_int * len(names))()
        count = query(got, len(got))
        have = dict(zip(names, got))
        if count != len(names) or have != expected:
            raise RuntimeError(f"csrc/{source} was built with {have} ({count} values); "
                               f"kernels/lstm_cell.py expects {expected}")
    return lib


_plan_ints = build.plan_ints


STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _one_dtype(kernel, named_shapes, dev, rows, hidden):
    """Check a K3/K4/K5 call: every input float32 or bfloat16, all of one
    dtype (the JAX kernel's one stream dtype)."""
    build.check_inputs(kernel, named_shapes, dev, STREAM_DTYPES)
    mixed = {str(t.dtype) for _, t, _ in named_shapes}
    if len(mixed) > 1:
        raise TypeError(f"{kernel}: the inputs mix {sorted(mixed)}; the kernel takes one dtype")
    if rows < 1 or hidden < 1:
        raise ValueError(f"{kernel}: empty problem (B={rows}, H={hidden})")


def _cell_shapes(kernel, wx, wh, b, x, h, c):
    rows, in_size = x.shape
    hidden = h.shape[1]
    dev = x.device
    _one_dtype(kernel, [
        ("wx", wx, (in_size, 4 * hidden)), ("wh", wh, (hidden, 4 * hidden)),
        ("b", b, (4 * hidden,)), ("x", x, (rows, in_size)),
        ("h", h, (rows, hidden)), ("c", c, (rows, hidden))], dev, rows, hidden)
    return rows, in_size, hidden, dev


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two, up to 16, that divides a tensor's address."""
    ptr = t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


def cell_launch(wx, wh, b, x, h, c, act: bool = False, outputs=()):
    """The C entry point and the plan that K3 (K4 with ``act``) launches for
    these inputs: ``lstm_cell_f32`` with :func:`cell_plan` in float32; in
    bf16 ``lstm_cell_bf16`` with :func:`cell_tc_plan`, or past the presets'
    widths ``lstm_cell_wide_bf16`` with :func:`cell_plan`. ``outputs``: the
    tensors the kernel writes (absent: fresh ones, 16-byte aligned)."""
    rows, in_size = x.shape
    hidden = h.shape[1]
    fwd = "_fwd" if act else ""
    limits = build.device_limits(x.device)
    if x.dtype == torch.bfloat16:
        tc = cell_tc_plan(rows, in_size, hidden, limits.smem_optin, limits.sm_count, int(act),
                          min(_alignment(wx), _alignment(wh)), _alignment(x), _alignment(h),
                          _alignment(c), min((_alignment(t) for t in outputs), default=16))
        if tc is not None:
            return f"lstm_cell{fwd}_bf16", tc
        name = f"lstm_cell{fwd}_wide_bf16"
    else:
        name = f"lstm_cell{fwd}_f32"
    return name, cell_plan(rows, in_size, hidden, limits.smem_optin, limits.sm_count)


def _launch_cell(kernel, wx, wh, b, x, h, c, act: bool):
    """Check a K3 (K4 with ``act``) call, allocate its outputs, launch the
    kernel :func:`cell_launch` picks and raise if it refuses."""
    rows, in_size, hidden, dev = _cell_shapes(kernel, wx, wh, b, x, h, c)
    outs = [torch.empty((rows, width), dtype=x.dtype, device=dev)
            for width in ((hidden, hidden, 4 * hidden) if act else (hidden, hidden))]
    name, plan = cell_launch(wx, wh, b, x, h, c, act, outs)
    plan_ints = _plan_ints(plan)
    entry = getattr(_kernel_library(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(wx.data_ptr(), wh.data_ptr(), b.data_ptr(), x.data_ptr(), h.data_ptr(),
                    c.data_ptr(), *(t.data_ptr() for t in outs), ctypes.addressof(plan_ints),
                    len(plan_ints), rows, in_size, hidden, stream)
    build.check(err, kernel)
    return outs


def lstm_cell(wx, wh, b, x, h, c):
    """Launch K3. wx:(I,4H) wh:(H,4H) b:(4H,) x:(B,I) h,c:(B,H) -> h', c'.

    All float32 or all bfloat16, contiguous, on one CUDA device; gate order
    (i, f, g, o); h' and c' in the inputs' dtype. Raises on anything else --
    it never computes on the CPU.
    """
    global launches, bf16_launches
    h_out, c_out = _launch_cell("lstm_cell", wx, wh, b, x, h, c, act=False)
    if x.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return h_out, c_out


def lstm_cell_fwd(wx, wh, b, x, h, c):
    """Launch K4: K3 that also returns ``act = [sig i | sig f | tanh g | sig o]``
    (B, 4H), in the inputs' dtype (rounded once in bf16). Same inputs and
    checks as :func:`lstm_cell`."""
    global fwd_launches, fwd_bf16_launches
    h_out, c_out, act = _launch_cell("lstm_cell_fwd", wx, wh, b, x, h, c, act=True)
    if x.dtype == torch.bfloat16:
        fwd_bf16_launches += 1
    else:
        fwd_launches += 1
    return h_out, c_out, act


_tickets = {}                    # (device index, stream) -> K5's ticket counters


def _ticket_counters(dev, stream: int, n: int) -> torch.Tensor:
    """K5's integer tickets, all 0 between launches (the kernel resets the
    ones it takes), one set per device and stream so that launches on two
    streams never share one. Launches on one stream run one after another;
    a CUDA graph keeps the set of the stream it was captured on, so its
    replays must not overlap eager K5 calls on that stream or each other."""
    key = (dev.index, stream)
    found = _tickets.get(key)
    if found is None or found.numel() < n:
        found = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
    return found


def bwd_launch(wx, wh, x, h, c, c_new, act, dh, dc, outputs=()):
    """The C entry point and the plan that K5 launches for these inputs:
    ``lstm_cell_bwd_f32`` with :func:`bwd_plan` in float32; in bf16
    ``lstm_cell_bwd_bf16`` with :func:`bwd_tc_plan`, or past the presets'
    widths ``lstm_cell_bwd_wide_bf16`` with :func:`bwd_plan`. ``outputs``:
    dx, dh_prev and dc_prev as the kernel will write them (absent: fresh
    ones, 16-byte aligned)."""
    rows, in_size = x.shape
    hidden = h.shape[1]
    limits = build.device_limits(x.device)
    if x.dtype == torch.bfloat16:
        tc = bwd_tc_plan(rows, in_size, hidden, limits.smem_optin, limits.sm_count,
                         min(_alignment(wx), _alignment(wh)), _alignment(x), _alignment(h),
                         min(_alignment(t) for t in (act, c, c_new, dh, dc)),
                         min((_alignment(t) for t in outputs), default=16))
        if tc is not None:
            return "lstm_cell_bwd_bf16", tc
        name = "lstm_cell_bwd_wide_bf16"
    else:
        name = "lstm_cell_bwd_f32"
    return name, bwd_plan(rows, in_size, hidden, limits.smem_optin)


def bwd_dx_launch(wx, wh, c, c_new, act, dh, dc, outputs=()):
    """The C entry point and the plan of K5's dx-only launch for these
    inputs: ``lstm_cell_bwd_dx_f32`` with :func:`bwd_dx_plan` in float32; in
    bf16 ``lstm_cell_bwd_dx_bf16`` with :func:`bwd_dx_tc_plan`, or past the
    presets' widths ``lstm_cell_bwd_dx_wide_bf16`` with :func:`bwd_dx_plan`.
    ``outputs``: dx, dh_prev and dc_prev as the kernel will write them."""
    rows, hidden = c.shape
    in_size = wx.shape[0]
    limits = build.device_limits(c.device)
    if c.dtype == torch.bfloat16:
        tc = bwd_dx_tc_plan(rows, in_size, hidden, limits.smem_optin, limits.sm_count,
                            min(_alignment(wx), _alignment(wh)),
                            min(_alignment(t) for t in (act, c, c_new, dh, dc)),
                            min((_alignment(t) for t in outputs), default=16))
        if tc is not None:
            return "lstm_cell_bwd_dx_bf16", tc
        name = "lstm_cell_bwd_dx_wide_bf16"
    else:
        name = "lstm_cell_bwd_dx_f32"
    return name, bwd_dx_plan(rows, in_size, hidden, limits.smem_optin)


def lstm_cell_bwd_dx(wx, wh, c, c_new, act, dh, dc):
    """Launch K5's dx-only kernel: ``(dh, dc)`` -> ``dx (B,I), dh_prev (B,H),
    dc_prev (B,H)``, no weight gradient (the weights need none: the esn
    head's frozen reservoir). The inputs all float32 or all bfloat16; the
    outputs in that dtype, the bits of :func:`lstm_cell_bwd`'s first three.
    One launch of row blocks only: no scratch and no tickets, so nothing is
    shared with another launch."""
    global bwd_dx_launches, bwd_dx_bf16_launches
    rows, hidden = c.shape
    in_size = wx.shape[0]
    dev = c.device
    g4 = 4 * hidden
    _one_dtype("lstm_cell_bwd_dx", [
        ("wx", wx, (in_size, g4)), ("wh", wh, (hidden, g4)), ("c", c, (rows, hidden)),
        ("c_new", c_new, (rows, hidden)), ("act", act, (rows, g4)),
        ("dh", dh, (rows, hidden)), ("dc", dc, (rows, hidden))], dev, rows, hidden)
    stream_dt = dict(dtype=c.dtype, device=dev)
    outs = (torch.empty((rows, in_size), **stream_dt), torch.empty((rows, hidden), **stream_dt),
            torch.empty((rows, hidden), **stream_dt))
    name, plan = bwd_dx_launch(wx, wh, c, c_new, act, dh, dc, outs)
    entry = getattr(_kernel_library(), name)
    plan_ints = _plan_ints(plan)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(wx.data_ptr(), wh.data_ptr(), c.data_ptr(), c_new.data_ptr(), act.data_ptr(),
                    dh.data_ptr(), dc.data_ptr(), *(t.data_ptr() for t in outs),
                    ctypes.addressof(plan_ints), len(plan_ints), rows, in_size, hidden, stream)
    build.check(err, "lstm_cell_bwd_dx")
    if c.dtype == torch.bfloat16:
        bwd_dx_bf16_launches += 1
    else:
        bwd_dx_launches += 1
    return outs


def lstm_cell_bwd(wx, wh, x, h, c, c_new, act, dh, dc):
    """Launch K5: ``(dh, dc)`` -> ``dx (B,I), dh_prev (B,H), dc_prev (B,H),
    dwx (I,4H), dwh (H,4H), db (4H,)``. The inputs all float32 or all
    bfloat16; dx, dh_prev and dc_prev in that dtype, the weight gradients
    always the float32 sums (:class:`LSTMCell` rounds them to the weight
    dtype). The kernel is the one :func:`bwd_launch` names.

    One launch; the weight gradients are summed over B in an order fixed by
    the shape (:func:`bwd_plan`, :func:`bwd_tc_plan`), so two launches on the
    same inputs give the same bits. Where the sum crosses blocks (fp32 and
    the wide bf16 kernel: chunks of rows; the tensor-core kernel: clusters)
    the launch takes integer tickets kept per device and stream
    (:func:`_ticket_counters`): two K5 launches that run at the same time
    must never share them, so a captured CUDA graph may not be replayed
    concurrently with K5 calls on its capture stream, nor twice at once. A
    set per launch would need a memset, a device call per call.
    """
    global bwd_launches, bwd_bf16_launches
    rows, in_size = x.shape
    hidden = h.shape[1]
    dev = x.device
    g4 = 4 * hidden
    _one_dtype("lstm_cell_bwd", [
        ("wx", wx, (in_size, g4)), ("wh", wh, (hidden, g4)),
        ("x", x, (rows, in_size)), ("h", h, (rows, hidden)), ("c", c, (rows, hidden)),
        ("c_new", c_new, (rows, hidden)), ("act", act, (rows, g4)),
        ("dh", dh, (rows, hidden)), ("dc", dc, (rows, hidden))], dev, rows, hidden)
    f32 = dict(dtype=torch.float32, device=dev)
    stream_dt = dict(dtype=x.dtype, device=dev)
    dx = torch.empty((rows, in_size), **stream_dt)
    dh_prev = torch.empty((rows, hidden), **stream_dt)
    dc_prev = torch.empty((rows, hidden), **stream_dt)
    dwx = torch.empty((in_size, g4), **f32)
    dwh = torch.empty((hidden, g4), **f32)
    db = torch.empty((g4,), **f32)
    name, plan = bwd_launch(wx, wh, x, h, c, c_new, act, dh, dc, (dx, dh_prev, dc_prev))
    # the weight-gradient sum's parts (row chunks, or clusters) and the
    # regions that each take a ticket
    if isinstance(plan, BwdTcPlan):
        parts, regions = (1, 1) if plan.row_blocks else (plan.clusters, plan.cluster)
    else:
        parts, regions = plan.chunks, plan.col_kparts * plan.slices
    scratch = (torch.empty((parts, in_size + hidden + 1, g4), **f32) if parts > 1 else None)
    entry = getattr(_kernel_library(), name)
    plan_ints = _plan_ints(plan)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _ticket_counters(dev, stream, regions)
        err = entry(
            wx.data_ptr(), wh.data_ptr(), x.data_ptr(), h.data_ptr(), c.data_ptr(),
            c_new.data_ptr(), act.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            dx.data_ptr(), dh_prev.data_ptr(), dc_prev.data_ptr(), dwx.data_ptr(),
            dwh.data_ptr(), db.data_ptr(), None if scratch is None else scratch.data_ptr(),
            tickets.data_ptr(), ctypes.addressof(plan_ints), len(plan_ints),
            rows, in_size, hidden, stream)
    build.check(err, "lstm_cell_bwd")
    if x.dtype == torch.bfloat16:
        bwd_bf16_launches += 1
    else:
        bwd_launches += 1
    return dx, dh_prev, dc_prev, dwx, dwh, db


class LSTMCell(torch.autograd.Function):
    """Differentiable fused cell: K4 forward, K5 backward on the card; the
    plain versions on the CPU. ``apply(wx, wh, b, x, h, c) -> (h', c')``,
    all six inputs float32 or all bfloat16. Where none of wx, wh, b needs a
    gradient (the esn head's frozen reservoir), the backward takes K5's
    dx-only launch (:func:`lstm_cell_bwd_dx`; on the CPU
    :func:`~repro_torch.kernels.ref.lstm_cell_bwd_dx_ref`) and returns None
    for the three weight gradients."""

    @staticmethod
    def forward(ctx, wx, wh, b, x, h, c):
        shapes.note("lstm_cell_fwd", wx, wh, b, x, h, c)
        if x.device.type == "cuda":
            h_new, c_new, act = lstm_cell_fwd(wx, wh, b, x, h, c)
        else:
            h_new, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
        ctx.save_for_backward(wx, wh, x, h, c, c_new, act)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc):
        wx, wh, x, h, c, c_new, act = ctx.saved_tensors
        # set_materialize_grads is on (the default): the cotangent of an
        # unused output (the last step's c) comes in as zeros, never None
        if not any(ctx.needs_input_grad[:3]):
            shapes.note("lstm_cell_bwd_dx", wx, wh, c, c_new, act)
            if x.device.type == "cuda":
                dx, dhp, dcp = lstm_cell_bwd_dx(wx, wh, c, c_new, act, dh.contiguous(),
                                                dc.contiguous())
            else:
                dx, dhp, dcp = ref.lstm_cell_bwd_dx_ref(wx, wh, c, c_new, act, dh, dc)
            return None, None, None, dx, dhp, dcp
        shapes.note("lstm_cell_bwd", wx, wh, x, h, c, c_new, act)
        if x.device.type == "cuda":
            dx, dhp, dcp, dwx, dwh, db = lstm_cell_bwd(
                wx, wh, x, h, c, c_new, act, dh.contiguous(), dc.contiguous())
        else:
            dx, dhp, dcp, dwx, dwh, db = ref.lstm_cell_bwd_ref(
                wx, wh, x, h, c, c_new, act, dh, dc)
        # the weight gradients are float32 sums over the whole batch, rounded
        # to the weight dtype once, here (the identity in float32)
        return dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(wx.dtype), dx, dhp, dcp
