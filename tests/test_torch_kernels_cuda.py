"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA GPU
(the decision is taken inside the ``card`` fixture, never at import). This
file imports only torch and the port -- no JAX -- so it runs on the card's
host, where the repo's ``tests/conftest.py`` (which imports JAX) is left out:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 and K2 rtol 1e-5 (same operations, same order, IEEE
rounding; K2's atol 1e-6 covers cotangents that cancel to near zero);
K3, K4 and K5 atol 1e-5 (the gate dots and the products over 4H sum in
another order than the plain matmuls); K5's weight gradients, which sum B
rows, atol 1e-5 * sqrt(B). K3's outputs and K5's weight gradients must
be bit-identical across two launches on the same inputs. K6 in fp32 within
the JAX kernel test's rtol = atol = 2e-5 (sums in another order); in bf16
against the plain version in fp32 on the same bf16 inputs, rtol = atol =
1e-2: the output's rounding (half a bf16 ulp, 2**-9 relative) and the
probabilities rounded to bf16 before the product with V. The bf16 streams
of the forecast path: K1 with a bf16 y gives its plain version's bits
(``torch.equal``: y_t is widened exactly, the rest is the fp32 walk); K3 in
bf16 is within 1 bf16 ulp of its plain version (the float32 gate sums run
in another order, and one rounding to bf16 can fall on either side), or,
where the output is so near zero that float32's sum-order error spans more
than one bf16 ulp (around |v| < 1e-4; float32 against float64 sums differ
there by up to 10 ulps on the CPU too), within the fp32 kernel's atol 1e-5.
K3 and K4 in bf16 run on the tensor cores (``csrc/lstm_cell_tc.cu``) at
every width where ``cell_plan`` does not take the wide kernel, and are held
the same way, at every preset width and ragged row counts; their outputs
are the same bits on two launches, and a row's bits do not depend on the
batch (and so the plan) it is computed in. The bf16 streams of the training
path are held the same way: K2 with a bf16 y to its plain version's bits
(dy rounded once from the same float32 walk); K4 and K5 in bf16 to 1 bf16
ulp or atol 1e-5, and K5's float32 weight gradients, before their rounding,
as the fp32 K5's (atol 1e-5 * sqrt(B), the same bits on two launches). K5
in bf16 runs on the tensor cores (``csrc/lstm_cell_bwd_tc.cu``) at every
preset width, and is held the same way at ragged row counts and on inputs
whose bases are off 16 bytes; past the presets it runs the templated kernel.
K5's dx-only launch (no weight gradients, the esn head's frozen reservoir)
is held to the plain dx-only version within K5's bounds, and to the full
launch's dx, dh_prev and dc_prev bit for bit (fp32, the templated bf16
kernel, and the bf16 split plan; past 512 rows in bf16, where the full
launch takes its cluster plan, within the bf16 bound); an esn train step
launches it and never the full K5. The out-of-core fit's host table: its
leaves are pinned, ``device_slice`` copies on the table's own (not the
default) stream, and its event orders the compute stream's first read
after a delayed copy; an unpinned table raises; a chunked fit whose visits
run A, B, A over two chunks (A restaged while B computes, after A's rows
were written back) equals the ``chunk_resident`` fit bit for bit.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch import strict_fp32
from repro_torch.kernels import build, flash_attention, hw_scan, lstm_cell, ops, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    strict_fp32()
    return torch.device("cuda")


# wide rings: m = 168 fits 48 KB of shared memory beside K1's tiles and opts
# in beside K2's, m = 400 opts in, m = 2,000 lives in device memory
# (hw_scan.scan_plan)
_WIDE_RINGS = [(300, 208, 168), (130, 440, 400), (40, 2030, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", [(300, 40, 4), (129, 9, 1), (5, 3, 12)] + _WIDE_RINGS)
def test_hw_scan_kernel_matches_plain_on_card(card, n, t_len, m):
    g = torch.Generator().manual_seed(n)
    y = torch.rand((n, t_len), generator=g) * 50 + 1
    alpha, gamma = torch.rand(n, generator=g), torch.rand(n, generator=g)
    init_seas = torch.rand((n, m), generator=g) + 0.5
    want = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    with torch.no_grad():
        lev, seas = hw_scan.hw_scan_tm(*(a.to(card) for a in (
            y.t().contiguous(), alpha, gamma, init_seas.t().contiguous())))
    torch.testing.assert_close(lev.t().cpu(), want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(seas.t().cpu(), want[1], rtol=1e-5, atol=0)


def _scan_case(n, t_len, m, seed, dev):
    g = torch.Generator().manual_seed(seed)
    y = torch.rand((n, t_len), generator=g) * 400 + 50
    alpha, gamma = torch.rand(n, generator=g), torch.rand(n, generator=g)
    init_seas = torch.rand((n, m), generator=g) + 0.5
    dlev = torch.randn((n, t_len), generator=g)
    dseas = torch.randn((n, t_len + m), generator=g)
    return [a.to(dev) for a in (y, alpha, gamma, init_seas, dlev, dseas)]


def _scan_bits(y, alpha, gamma, init_seas, dlev, dseas):
    """K1 and K2 on the card, each against its plain version on the same
    card: the same operations in the same order with IEEE rounding give the
    same bits (as chip_smoke.py reasons for K1_RTOL), so torch.equal."""
    tm = lambda a: a.t().contiguous()
    lev_p, seas_p = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    bwd_p = ref.hw_scan_bwd_ref(y, alpha, gamma, lev_p, seas_p, dlev, dseas)
    with torch.no_grad():
        fwd = hw_scan.hw_scan_tm(tm(y), alpha, gamma, tm(init_seas))
        bwd = hw_scan.hw_scan_bwd_tm(tm(y), alpha, gamma, tm(lev_p), tm(seas_p), tm(dlev),
                                     tm(dseas))
    for name, got, want in zip(("levels", "seas"), fwd, (lev_p, seas_p)):
        assert torch.equal(got.t(), want), f"K1 {name} differs from the plain version"
    for name, got, want in zip(("dy", "dalpha", "dgamma", "dinit"), bwd, bwd_p):
        assert torch.equal(got.t() if got.dim() == 2 else got, want), \
            f"K2 {name} differs from the plain version"
    return fwd + bwd


# the edges of hw_scan.scan_plan and of the walk: N not a multiple of 4
# and N = 1 (4-byte copies), T not a multiple of the 128-row tile (200,
# 333) nor of the step groups (70, 45, 9), T under one tile, the
# forecast's shape, every group of csrc/hw_scan.cuh:by_group (m = 4 and
# 8, 12: 8 steps; m = 1 and 5: 4 steps; m = 2, 3: single steps), and every
# ring placement (shared memory, opted in, device memory)
_PLAN_EDGES = [(3, 40, 4), (33, 70, 4), (1, 9, 4), (1, 256, 4), (64, 45, 4), (40, 9, 4),
               (64, 200, 4), (3, 333, 4), (5, 3, 12), (24_000, 128, 4), (33, 41, 1),
               (36, 41, 2), (35, 41, 3), (33, 41, 5), (40, 70, 8), (300, 208, 168),
               (130, 440, 400), (40, 2030, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", _PLAN_EDGES)
def test_hw_scan_kernels_equal_plain_bit_for_bit_on_card(card, n, t_len, m):
    first = _scan_bits(*_scan_case(n, t_len, m, n + t_len, card))
    second = _scan_bits(*_scan_case(n, t_len, m, n + t_len, card))
    for a, b in zip(first, second):
        assert torch.equal(a, b), "two launches on the same inputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", [(64, 40, 4), (33, 41, 1), (40, 70, 12)])
def test_hw_scan_kernels_redo_out_of_range_divisions_on_card(card, n, t_len, m):
    # operands outside [2^-60, 2^60] (alpha * y near 1e-23, a spike of y at
    # 5e18, cotangents of 1e-30) send a group of steps to IEEE division;
    # zero numerators (alpha 0, dlev 0, dseas -0) take the signed-zero path
    y, alpha, gamma, init_seas, dlev, dseas = _scan_case(n, t_len, m, 7, card)
    alpha[::3] = 1e-25
    alpha[1::7] = 0.0
    y[::2, 5] = 5e18
    dlev[:, ::4] = 0.0
    dlev[:, 1::5] = 1e-30
    dseas[:, 2::3] = -0.0
    _scan_bits(y, alpha, gamma, init_seas, dlev, dseas)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["short", "smem", "copy"])
def test_hw_scan_kernels_refuse_a_plan_the_source_does_not_take_on_card(
        card, monkeypatch, fault):
    # the C entry points check the plan against the layout csrc/hw_scan.cuh
    # computes: one int short, shared memory 4 bytes short, or 16-byte
    # copies of rows that are not 16-byte aligned (N = 33)
    if fault == "short":
        monkeypatch.setattr(hw_scan, "_plan_ints",
                            lambda plan: (ctypes.c_int * (len(plan) - 1))(*plan[:-1]))
    else:
        real = hw_scan.scan_plan

        def broken(*args, **kwargs):
            plan = real(*args, **kwargs)
            return (plan._replace(smem=plan.smem - 4) if fault == "smem"
                    else plan._replace(copy=16))
        monkeypatch.setattr(hw_scan, "scan_plan", broken)
    y, alpha, gamma, init_seas, dlev, dseas = _scan_case(33, 40, 4, 3, card)
    tm = lambda a: a.t().contiguous()
    lev, seas = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    with torch.no_grad():
        for call in (lambda: hw_scan.hw_scan_tm(tm(y), alpha, gamma, tm(init_seas)),
                     lambda: hw_scan.hw_scan_bwd_tm(tm(y), alpha, gamma, tm(lev), tm(seas),
                                                    tm(dlev), tm(dseas))):
            with pytest.raises(RuntimeError, match="invalid argument"):
                call()


_PRESET_WIDTHS = [          # (I, H) of every preset's layers: yearly, quarterly,
    (10, 30), (30, 30),     # monthly, hourly (input window + 6 categories, then H)
    (14, 40), (40, 40), (18, 50), (50, 50), (30, 40), (62, 50),
]


# widths past the presets': K3/K4 stage the weights whole (64), in k-chunks
# (128, 256) and in unit slices (1,030); K5 stages in unit chunks and k-parts
_WIDE_WIDTHS = [(64, 64), (128, 128), (18, 256), (1030, 1030)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", [
    (rows, in_size, hidden) for in_size, hidden in _PRESET_WIDTHS
    for rows in (1, 31, 333, 24_001)]                       # across the row tiles
    + [(rows, in_size, hidden) for in_size, hidden in _WIDE_WIDTHS for rows in (1, 31, 333)]
    + [(30_000, 128, 128)])             # the wide kernel past 8 rows per thread's threshold
def test_lstm_cell_kernel_matches_plain_on_card(card, rows, in_size, hidden):
    g = torch.Generator().manual_seed(rows)
    u = lambda *s: torch.rand(s, generator=g) * 2 - 1
    args = [u(in_size, 4 * hidden) * 0.2, u(hidden, 4 * hidden) * 0.2, u(4 * hidden),
            u(rows, in_size), u(rows, hidden), u(rows, hidden)]
    want = ref.lstm_cell_ref(*args)
    with torch.no_grad():
        got = lstm_cell.lstm_cell(*(a.to(card) for a in args))
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt.cpu(), w, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernels_raise_on_other_dtypes_on_card(card):
    x = torch.ones((2, 3), dtype=torch.float64, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hw_scan.hw_scan_tm(x, x[0], x[0], x)
    y = torch.ones((2, 3), dtype=torch.bfloat16, device=card)
    with pytest.raises(TypeError, match="alpha is torch.float64; the kernel takes float32 only"):
        hw_scan.hw_scan_tm(y, x[0], x[0], x)


def _hw_inputs(n, t_len, m, seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.rand((n, t_len), generator=g) * 50 + 1
    alpha, gamma = torch.rand(n, generator=g), torch.rand(n, generator=g)
    init_seas = torch.rand((n, m), generator=g) + 0.5
    lev, seas = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    dlev = torch.randn((n, t_len), generator=g)
    dseas = torch.randn((n, t_len + m), generator=g)
    return y, alpha, gamma, lev, seas, dlev, dseas


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", [(300, 40, 4), (129, 9, 1), (5, 3, 12)] + _WIDE_RINGS)
def test_hw_scan_bwd_kernel_matches_plain_on_card(card, n, t_len, m):
    args = _hw_inputs(n, t_len, m, n)
    want = ref.hw_scan_bwd_ref(*args)
    tm = [a.t().contiguous() if a.dim() == 2 else a for a in args]
    got = hw_scan.hw_scan_bwd_tm(*(a.to(card) for a in tm))
    for gt, w in zip(got, want):
        gt = gt.cpu()
        torch.testing.assert_close(gt.t() if gt.dim() == 2 else gt, w,
                                   rtol=1e-5, atol=1e-6)


def _cell_inputs(rows, in_size, hidden, seed):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g) * 2 - 1
    return [u(in_size, 4 * hidden) * 0.2, u(hidden, 4 * hidden) * 0.2, u(4 * hidden),
            u(rows, in_size), u(rows, hidden), u(rows, hidden)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", [
    (1, 14, 40), (333, 40, 40), (70, 62, 50), (256, 14, 40), (2_049, 40, 40),
    (257, 18, 50), (31, 10, 30),
    # the other batch-256 train-step shapes (rows = 256 x dilation) and the
    # largest at batch 2048: K5's row chunks of 32 rows and of 512
    (512, 40, 40), (1_024, 40, 40), (2_048, 40, 40), (16_384, 40, 40)]
    + [(rows, in_size, hidden) for in_size, hidden in _WIDE_WIDTHS for rows in (1, 33, 256)])
def test_lstm_cell_fwd_bwd_kernels_match_plain_on_card(card, rows, in_size, hidden):
    wx, wh, b, x, h, c = _cell_inputs(rows, in_size, hidden, rows)
    h_new, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    got = lstm_cell.lstm_cell_fwd(*(a.to(card) for a in (wx, wh, b, x, h, c)))
    for gt, w in zip(got, (h_new, c_new, act)):
        torch.testing.assert_close(gt.cpu(), w, rtol=0, atol=1e-5)
    g = torch.Generator().manual_seed(rows + 1)
    dh, dc = torch.randn((rows, hidden), generator=g), torch.randn((rows, hidden), generator=g)
    bwd_args = (wx, wh, x, h, c, c_new, act, dh, dc)
    want = ref.lstm_cell_bwd_ref(*bwd_args)
    on_card = [a.to(card) for a in bwd_args]
    got = lstm_cell.lstm_cell_bwd(*on_card)
    for k, (gt, w) in enumerate(zip(got, want)):
        # dx, dh_prev, dc_prev sum 4H terms; the weight gradients sum B rows
        atol = 1e-5 if k < 3 else 1e-5 * max(1.0, rows ** 0.5)
        torch.testing.assert_close(gt.cpu(), w, rtol=0, atol=atol)
    again = lstm_cell.lstm_cell_bwd(*on_card)
    for gt, rerun in zip(got[3:], again[3:]):
        assert torch.equal(gt, rerun), "K5 weight gradients differ between launches"


@pytest.mark.cuda
def test_autograd_functions_launch_the_kernels_on_card(card):
    wx, wh, b, x, h, c = (a.to(card).requires_grad_(True)
                          for a in _cell_inputs(64, 14, 40, 3))
    ops.reset_launch_counts()
    h_new, c_new = ops.lstm_cell(wx, wh, b, x, h, c)
    (h_new.square().sum() + c_new.sum()).backward()
    with torch.no_grad():
        ops.lstm_cell(wx, wh, b, x, h, c)
    counts = ops.launch_counts()
    assert (counts["lstm_cell_fwd"], counts["lstm_cell_bwd"], counts["lstm_cell"]) == (1, 1, 1)


def _attn_inputs(b, hq, hkv, tq, tk, d, dtype, seed, dev, dv=None):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, dv or d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal", [
    (2, 8, 2, 256, 256, 128, True),       # GQA prefill
    (1, 4, 4, 1000, 1000, 64, True),      # MHA, ragged Tq = Tk
    (2, 8, 1, 33, 300, 128, True),        # decode-append, ragged tiles
    (1, 8, 2, 1, 77, 64, True),           # one query
    (2, 4, 2, 70, 130, 128, False),       # non-causal, Tq < Tk
    (1, 4, 2, 150, 40, 64, False),        # non-causal, Tq > Tk
])
def test_flash_attention_kernel_matches_plain_on_card(card, dtype, b, hq, hkv, tq, tk, d,
                                                      causal):
    q, k, v = _attn_inputs(b, hq, hkv, tq, tk, d, dtype, seed=tq + tk, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


_TILE_EDGES = [              # (Tq, Tk, causal) across K6's 128-row/128-key tiles
    (1000, 1000, True), (1000, 1000, False), (70, 130, True), (70, 130, False),
    (33, 1024, True), (1, 77, True), (150, 40, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk,causal", _TILE_EDGES)
def test_flash_attention_bf16_tile_edges_on_card(card, tq, tk, causal, d, group):
    hkv = 2
    q, k, v = _attn_inputs(1, hkv * group, hkv, tq, tk, d, torch.bfloat16,
                           seed=tq * 7 + tk + d + group, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq,tk,causal", _TILE_EDGES)
def test_flash_attention_mla_head_dims_across_tile_edges_on_card(card, tq, tk, causal, dtype):
    """MLA's prefill shape: q and k 192 wide, v 128 (its own V tile, tensor
    map and transaction count in bf16; dynamic shared memory past 48 KB in
    fp32), at MLA's own scale (dn + dr)^-0.5."""
    q, k, v = _attn_inputs(2, 4, 4, tq, tk, 192, dtype, seed=tq * 3 + tk, dev=card, dv=128)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal, scale=192 ** -0.5)
    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 4, tq, 128)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("tq,tk,causal", _TILE_EDGES)
def test_flash_attention_head_dim_80_across_tile_edges_on_card(card, tq, tk, causal, group,
                                                               dtype):
    """zamba2's head dim, D = DV = 80, at the model's scale 1/sqrt(80). bf16:
    the 128-wide tile, TMA zero-filling the columns past 80, o stored in
    rows of 80 (a store past a row would land in the next one). fp32: the
    SIMT kernel's static 128-wide tiles with D = DV = 80 at run time, as the
    hybrid's fp32 parity prefill runs it."""
    hkv = 2
    q, k, v = _attn_inputs(1, hkv * group, hkv, tq, tk, 80, dtype,
                           seed=tq * 5 + tk + group, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal, scale=80 ** -0.5)
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=80 ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_takes_the_models_scale_on_card(card, d):
    # granite's 2**-7, which the bf16 kernel folds into its exp2 with log2(e)
    q, k, v = _attn_inputs(2, 8, 2, 200, 260, d, torch.bfloat16, seed=d, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True, scale=0.0078125)
    got = flash_attention.flash_attention(q, k, v, causal=True, scale=0.0078125)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


# whisper-base's four uses of K6 (B, Hq, Hkv, Tq, Tk, causal), MHA 8 x 64:
# the served cell's (batch 8, prompt 2,048, 1,500 frames) in bf16 and the
# parity cell's (batch 2, prompt 128) in fp32
_WHISPER_USES = {
    "encoder": lambda b, p: (b, 8, 8, 1500, 1500, False),
    "decoder_self": lambda b, p: (b, 8, 8, p, p, True),
    "cross_prefill": lambda b, p: (b, 8, 8, p, 1500, False),
    "cross_decode": lambda b, p: (b, 8, 8, 1, 1500, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("use", list(_WHISPER_USES))
def test_flash_attention_whisper_uses_on_card(card, use, dtype):
    """The encoder's non-causal 1,500 x 1,500, the decoder's causal prompt,
    and the cross-attention over 1,500 frames from the prompt and from one
    decode position (Tq = 1: the bf16 block's 128-row query tile holds one
    real row, TMA zero-filling the rest; Tk = 1,500 is 11 key tiles and 92
    keys), at scale 1/sqrt(64)."""
    b, hq, hkv, tq, tk, causal = _WHISPER_USES[use](
        *((8, 2048) if dtype == torch.bfloat16 else (2, 128)))
    q, k, v = _attn_inputs(b, hq, hkv, tq, tk, 64, dtype, seed=tq + tk, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal, scale=0.125)
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tk", [1, 127, 1500])
def test_flash_attention_one_query_over_ragged_keys_on_card(card, tk, causal, dtype):
    """One query row against 1, 127 (one partial tile) and 1,500 keys, as
    whisper's cross-attention decode runs it; causal with Tq = 1 sees every
    key (the end-aligned offset)."""
    q, k, v = _attn_inputs(8, 8, 8, 1, tk, 64, dtype, seed=tk, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (8, 8, 1, 64)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_granite_scale_at_its_shapes_on_card(card, dtype):
    """granite-3-2b's attention, GQA 32/8 at D 64 and its scale 2**-7: the
    served prefill's (8, 2048) in bf16, the parity prefill's (2, 128) in
    fp32."""
    b, t = (8, 2048) if dtype == torch.bfloat16 else (2, 128)
    q, k, v = _attn_inputs(b, 32, 8, t, t, 64, dtype, seed=t, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True, scale=0.0078125)
    got = flash_attention.flash_attention(q, k, v, causal=True, scale=0.0078125)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


# the decode route (flash_decode_bf16, bf16 at D 64): (Tk, G, Tq, causal)
# with G * Tq = 1, 4 and 16 query rows a kv head; causal needs Tq <= Tk
_DECODE_CASES = [(tk, group, tq, causal) for tk in (1, 127, 1500, 4096)
                 for group, tq in ((1, 1), (4, 1), (1, 4), (16, 1), (4, 4), (1, 16))
                 for causal in (False, True) if not (causal and tq > tk)]


@pytest.mark.cuda
@pytest.mark.parametrize("tk,group,tq,causal", _DECODE_CASES)
def test_flash_decode_matches_plain_on_card(card, tk, group, tq, causal):
    """The split kernel and its combine against the plain version and the
    plain split-and-combine: keys in one partial tile (1, 127), whisper's
    1,500 frames and 4,096; causal rows of Tq 4 or 16 end before the last
    split."""
    hkv = 2
    q, k, v = _attn_inputs(2, hkv * group, hkv, tq, tk, 64, torch.bfloat16,
                           seed=tk + 17 * group + tq, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_decode"]) == (1, 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)
    plan = flash_attention.decode_plan(2 * hkv, tk, build.device_limits(card).sm_count)
    split = ref.attention_decode_ref(q.float(), k.float(), v.float(), causal=causal,
                                     n_split=plan.splits)
    torch.testing.assert_close(got.float(), split, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_flash_decode_at_whispers_cross_decode_on_card(card):
    """whisper-base's cross-attention from one decode position over 1,500
    frames, (8, 8, 8, 1 x 1,500, 64) at scale 1/8: within 1e-2 of the fp32
    plain version, the same bits on two launches (no atomics: each split
    writes its own partial, one thread sums them in a fixed order), one K6
    call and one decode-route launch each; the prefill kernel, through its
    own entry, still takes the shape."""
    q, k, v = _attn_inputs(8, 8, 8, 1, 1500, 64, torch.bfloat16, seed=1501, dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=False, scale=0.125)
    ops.reset_launch_counts()
    first = flash_attention.flash_attention(q, k, v, causal=False, scale=0.125)
    second = flash_attention.flash_attention(q, k, v, causal=False, scale=0.125)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_decode"]) == (2, 2)
    torch.testing.assert_close(first.float(), want, rtol=1e-2, atol=1e-2)
    assert torch.equal(first, second), "the decode route differs between two launches"
    parent = torch.empty_like(q)
    err = build.library().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), parent.data_ptr(), 8, 8, 8, 1, 1500, 64, 64,
        0, 0.125, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_bf16")
    torch.cuda.synchronize()
    torch.testing.assert_close(parent.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_flash_decode_refuses_a_plan_that_misses_keys_on_card(card):
    q, k, v = _attn_inputs(1, 8, 2, 1, 300, 64, torch.bfloat16, seed=3, dev=card)
    o = torch.empty_like(q)
    part = torch.empty((2 * 4 * 4, 66), device=card)
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    # (splits, keys): too few keys, an empty last split, 17 rows a kv head
    for splits, keys, hq in ((2, 100, 8), (4, 100, 8), (2, 150, 34)):
        err = lib.flash_attention_decode_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), part.data_ptr(),
            part.data_ptr(), 1, hq, 2, 1, 300, splits, keys, 0, 0.125, stream)
        assert err != 0, f"the decode entry took {splits} splits of {keys} keys, Hq {hq}"


# flash_tc_bf16<64, 64>'s prefill schedule at ragged Tq and Tk (not
# multiples of the 128-row / 128-key tiles), causal and not
_D64_RAGGED = [(200, 260, True), (333, 1157, True), (129, 129, True), (1000, 1000, True),
               (17, 300, True), (700, 1500, False), (255, 383, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(32, 8), (8, 8)])
@pytest.mark.parametrize("tq,tk,causal", _D64_RAGGED)
def test_flash_attention_d64_prefill_schedule_at_ragged_tiles_on_card(card, tq, tk, causal,
                                                                     hq, hkv):
    """granite's GQA 32/8 at its scale 2**-7 and whisper's MHA 8/8 at 1/8."""
    scale = 0.0078125 if hq != hkv else 0.125
    q, k, v = _attn_inputs(1, hq, hkv, tq, tk, 64, torch.bfloat16, seed=tq + 3 * tk + hq,
                           dev=card)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal, scale=scale)
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_decode"]) == (1, 0)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", [(24_001, 14, 40), (333, 50, 50),
                                                 (333, 128, 128)])
def test_lstm_cell_is_bit_identical_across_launches_on_card(card, rows, in_size, hidden):
    args = [a.to(card) for a in _cell_inputs(rows, in_size, hidden, 5)]
    with torch.no_grad():
        first = lstm_cell.lstm_cell(*args)
        second = lstm_cell.lstm_cell(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b), "K3 differs between two launches on the same inputs"


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["short", "smem"])
def test_lstm_cell_kernels_refuse_a_plan_the_source_does_not_take_on_card(
        card, monkeypatch, fault):
    # the constants and plan lengths that kernels/lstm_cell.py shares with
    # csrc/lstm_cell.cu agree (checked when the library is first used) ...
    lstm_cell._kernel_library()
    # ... and the C entry points refuse a plan one int short, or one whose
    # shared memory is 4 bytes short of the layout the source computes
    if fault == "short":
        monkeypatch.setattr(lstm_cell, "_plan_ints",
                            lambda plan: (ctypes.c_int * (len(plan) - 1))(*plan[:-1]))
    else:
        for name in ("cell_plan", "bwd_plan"):
            real = getattr(lstm_cell, name)
            monkeypatch.setattr(lstm_cell, name,
                                lambda *a, real=real: real(*a)._replace(smem=real(*a).smem - 4))
    wx, wh, b, x, h, c = (a.to(card) for a in _cell_inputs(33, 14, 40, 5))
    with torch.no_grad():
        for call in (lambda: lstm_cell.lstm_cell(wx, wh, b, x, h, c),
                     lambda: lstm_cell.lstm_cell_fwd(wx, wh, b, x, h, c),
                     lambda: lstm_cell.lstm_cell_bwd(wx, wh, x, h, c, c, torch.zeros(
                         (33, 160), device=card), h, c)):
            with pytest.raises(RuntimeError, match="invalid argument"):
                call()


@pytest.mark.cuda
def test_flash_attention_takes_the_models_scale_on_card(card):
    q, k, v = _attn_inputs(2, 4, 2, 64, 96, 64, torch.float32, seed=1, dev=card)
    want = ref.attention_ref(q, k, v, causal=True, scale=0.0078125)
    got = flash_attention.flash_attention(q, k, v, causal=True, scale=0.0078125)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_chunked_attention_launches_k6_on_card(card):
    from repro_torch.models.attention import chunked_attention

    q, k, v = _attn_inputs(2, 8, 4, 80, 80, 64, torch.float32, seed=2, dev="cpu")
    want = chunked_attention(q, k, v, causal=True, scale=0.125, q_chunk=32)
    ops.reset_launch_counts()
    got = chunked_attention(*(t.to(card).transpose(1, 2).contiguous().transpose(1, 2)
                              for t in (q, k, v)), causal=True, scale=0.125)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take_on_card(card):
    q, k, v = _attn_inputs(1, 4, 2, 8, 8, 32, torch.bfloat16, seed=3, dev=card)
    with pytest.raises(ValueError, match=r"bf16 head dims \(D, DV\) = \(32, 32\)"):
        flash_attention.flash_attention(q, k, v, causal=True)
    # (D, DV) pairs no instantiation takes: bf16 (128, 64), (192, 192), (80,
    # 64) and (96, 96); fp32 DV past D or past 128, and D past 192
    for d, dv, dtype in ((128, 64, torch.bfloat16), (192, 192, torch.bfloat16),
                         (80, 64, torch.bfloat16), (96, 96, torch.bfloat16),
                         (64, 128, torch.float32), (192, 160, torch.float32),
                         (256, 128, torch.float32)):
        q, k, v = _attn_inputs(1, 4, 2, 8, 8, d, dtype, seed=3, dev=card, dv=dv)
        with pytest.raises(ValueError, match=rf"head dims \(D, DV\) = \({d}, {dv}\)"):
            flash_attention.flash_attention(q, k, v, causal=True)
    q, k, v = _attn_inputs(1, 4, 2, 9, 8, 64, torch.float32, seed=3, dev=card)
    with pytest.raises(ValueError, match="no visible key"):
        flash_attention.flash_attention(q, k, v, causal=True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention.flash_attention(q.double(), k.double(), v.double(), causal=False)
    with pytest.raises(ValueError, match="scale -0.125"):
        flash_attention.flash_attention(q, k, v, causal=False, scale=-0.125)
    # the C entry points refuse such a pair too, past the wrapper's check
    lib = build.library()
    for entry, dtype, (d, dv) in (("flash_attention_bf16", torch.bfloat16, (128, 64)),
                                  ("flash_attention_bf16", torch.bfloat16, (96, 96)),
                                  ("flash_attention_bf16", torch.bfloat16, (80, 64)),
                                  ("flash_attention_f32", torch.float32, (64, 128))):
        q, k, v = _attn_inputs(1, 4, 2, 8, 8, d, dtype, seed=3, dev=card, dv=dv)
        o = q.new_empty((1, 4, 8, dv))
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  1, 4, 2, 8, 8, d, dv, 1, 0.125,
                                  torch.cuda.current_stream().cuda_stream)
        assert err != 0, f"{entry} took (D, DV) = ({d}, {dv})"


# ---------------------------------------------------------------------------
# the bf16 streams of K1 and K3 (the bf16 forecast and serve path)


def _scan_bf16_case(n, t_len, m, seed, dev):
    g = torch.Generator().manual_seed(seed)
    y = (torch.rand((n, t_len), generator=g) * 400 + 50).to(torch.bfloat16)
    alpha, gamma = torch.rand(n, generator=g), torch.rand(n, generator=g)
    init_seas = torch.rand((n, m), generator=g) + 0.5
    if m == 1:                  # the m == 1 convention of kernels/ops.py
        gamma, init_seas = torch.zeros(n), torch.ones((n, 1))
    return [a.to(dev) for a in (y, alpha, gamma, init_seas)]


# the forecast's shape, every serve bucket (B x T, m = 4), m = 1, the wide
# rings (shared, opted-in, device memory) and N off a multiple of 8 (2-byte
# element copies)
_BF16_SCANS = ([(24_000, 128, 4), (24_000, 128, 1)]
               + [(b, t, 4) for b in (1, 4, 16, 64) for t in (32, 64, 128, 256)]
               + [(300, 208, 168), (130, 440, 400), (64, 2040, 2000)]
               + [(3, 40, 4), (33, 70, 4), (12, 333, 4), (24_001, 128, 4), (36, 41, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", _BF16_SCANS)
def test_hw_scan_bf16_equals_plain_bit_for_bit_on_card(card, n, t_len, m):
    y, alpha, gamma, init_seas = _scan_bf16_case(n, t_len, m, n + m, card)
    want = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = hw_scan.hw_scan_tm(y.t().contiguous(), alpha, gamma, init_seas.t().contiguous())
    counts = ops.launch_counts()
    assert (counts["hw_scan_bf16"], counts["hw_scan"]) == (1, 0)
    for name, g, w in zip(("levels", "seas"), got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g.t(), w), f"K1 bf16 {name} differs from the plain version"


def _cell_bf16_args(rows, in_size, hidden, seed, dev):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s, scale=1.0: ((torch.rand(s, generator=g) * 2 - 1) * scale).to(torch.bfloat16)
    return [a.to(dev) for a in (u(in_size, 4 * hidden, scale=in_size ** -0.5),
                                u(hidden, 4 * hidden, scale=hidden ** -0.5),
                                u(4 * hidden, scale=0.1), u(rows, in_size), u(rows, hidden),
                                u(rows, hidden, scale=2.0))]


# the forecast's first layer (B = 24,000, I = 14), every serve batch folded
# by the quarterly dilations (rows = B * d, I = 14 then 40), and the widths
# past the presets (H = 128, 256: k-chunks; 1,030: unit slices)
_BF16_CELLS = ([(24_000, 14, 40), (192_000, 40, 40)]
               + sorted({(b * d, i, 40) for b in (1, 4, 16, 64) for d, i in
                         ((1, 14), (2, 40), (4, 40), (8, 40))})
               + [(rows, hid, hid) for hid in (128, 256, 1030) for rows in (1, 333)]
               + [(30_000, 18, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", _BF16_CELLS)
def test_lstm_cell_bf16_within_one_ulp_or_fp32_atol_of_plain_on_card(card, rows, in_size,
                                                                      hidden):
    args = _cell_bf16_args(rows, in_size, hidden, rows + hidden, card)
    want = ref.lstm_cell_ref(*args)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = lstm_cell.lstm_cell(*args)
        again = lstm_cell.lstm_cell(*args)
    counts = ops.launch_counts()
    assert (counts["lstm_cell_bf16"], counts["lstm_cell"]) == (2, 0)
    for g, w, a in zip(got, want, again):
        assert g.dtype == torch.bfloat16
        past = (ref.bf16_ulps(g, w) > 1) & ((g.float() - w.float()).abs() > 1e-5)
        assert not past.any(), f"{int(past.sum())} outputs past 1 bf16 ulp and atol 1e-5"
        assert torch.equal(g, a), "two launches on the same inputs differ"


# ---------------------------------------------------------------------------
# K3 and K4 in bf16 on the tensor cores (csrc/lstm_cell_tc.cu)


def _run_cell(act, args):
    with torch.no_grad():
        return (lstm_cell.lstm_cell_fwd(*args) if act else lstm_cell.lstm_cell(*args))


# every preset width (H = 30, 40, 50 with each input width) at ragged row
# counts: one row, an m-tile short and past, and a tile past 4,096
_TC_RAGGED = [(rows, in_size, hidden) for in_size, hidden in _PRESET_WIDTHS
              for rows in (1, 15, 17, 4_097)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("rows,in_size,hidden", _TC_RAGGED + _BF16_CELLS)
def test_lstm_cell_tc_within_one_ulp_or_fp32_atol_of_plain_on_card(card, act, rows, in_size,
                                                                   hidden):
    args = _cell_bf16_args(rows, in_size, hidden, rows + 7 * hidden + in_size, card)
    name, _ = lstm_cell.cell_launch(*args, act=act)
    lim = build.device_limits(card)
    wide = lstm_cell.cell_plan(rows, in_size, hidden, lim.smem_optin, lim.sm_count).wide
    assert name == ("lstm_cell_fwd" if act else "lstm_cell") + ("_wide" if wide else "") + "_bf16"
    ops.reset_launch_counts()
    got = _run_cell(act, args)
    counts = ops.launch_counts()
    assert counts["lstm_cell_fwd_bf16" if act else "lstm_cell_bf16"] == 1
    assert counts["lstm_cell"] == counts["lstm_cell_fwd"] == 0
    want = (ref.lstm_cell_fwd_ref if act else ref.lstm_cell_ref)(*args)
    for what, gt, w in zip(("h", "c", "act"), got, want):
        _within_ulp_or_atol(gt, w, f"{name} {what}")


# the quarterly widths and the yearly one, whose h and c rows (60 bytes)
# take 4-byte copies; a slice 3 rows in moves x's base off 16 bytes too
@pytest.mark.cuda
@pytest.mark.parametrize("act", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("in_size,hidden", [(14, 40), (40, 40), (10, 30), (18, 50)])
def test_lstm_cell_tc_gives_a_row_the_same_bits_in_any_batch_on_card(card, act, in_size,
                                                                      hidden):
    wx, wh, b, x, h, c = _cell_bf16_args(24_000, in_size, hidden, in_size + hidden, card)
    big = _run_cell(act, (wx, wh, b, x, h, c))
    again = _run_cell(act, (wx, wh, b, x, h, c))
    for a, r in zip(big, again):
        assert torch.equal(a, r), "two launches on the same inputs differ"
    for lo in (0, 3, 20_000):
        part = (wx, wh, b, x[lo:lo + 512], h[lo:lo + 512], c[lo:lo + 512])
        small_plan = lstm_cell.cell_launch(*part, act=act)[1]
        assert small_plan != lstm_cell.cell_launch(wx, wh, b, x, h, c, act=act)[1]
        for a, small in zip(big, _run_cell(act, part)):
            assert torch.equal(a[lo:lo + 512], small), (
                f"rows {lo}..{lo + 511} differ between batches of 24,000 and 512")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["short", "smem", "copy", "geometry"])
def test_lstm_cell_tc_refuses_a_plan_the_source_does_not_take_on_card(card, monkeypatch, fault):
    # the constants and plan length shared with csrc/lstm_cell_tc.cu agree
    # (checked when the library is first used) ...
    lstm_cell._kernel_library()
    # ... and its entry points refuse a plan one int short, 4 bytes of
    # shared memory short of the layout, a 16-byte copy of x rows that are
    # 28 bytes long, or a slice of more quads than a warp holds
    real = lstm_cell.cell_tc_plan
    faults = dict(smem=lambda p: p._replace(smem=p.smem - 4),
                  copy=lambda p: p._replace(copy_x=16),
                  geometry=lambda p: p._replace(quads=lstm_cell.TC_QMAX + 1, slices=1))
    if fault == "short":
        monkeypatch.setattr(lstm_cell, "_plan_ints",
                            lambda plan: (ctypes.c_int * (len(plan) - 1))(*plan[:-1]))
    else:
        monkeypatch.setattr(lstm_cell, "cell_tc_plan", lambda *a: faults[fault](real(*a)))
    args = _cell_bf16_args(4_000, 14, 40, 5, card)
    for act in (False, True):
        assert lstm_cell.cell_launch(*args, act=act)[0].endswith("_bf16")
        with pytest.raises(RuntimeError, match="invalid argument"):
            _run_cell(act, args)


@pytest.mark.cuda
def test_bf16_forecast_launches_only_the_bf16_kernels_on_card(card):
    from repro_torch.convert import params_to_device
    from repro_torch.core import esrnn

    cfg = esrnn.make_config("quarterly", precision="bf16")
    params = esrnn.esrnn_init(torch.Generator().manual_seed(0), cfg, 40, device="cpu")
    g = torch.Generator().manual_seed(1)
    y = torch.rand((40, 32), generator=g) * 100 + 50
    cats = torch.eye(6)[torch.randint(0, 6, (40,), generator=g)]
    want = esrnn.esrnn_forecast(cfg, params, y, cats)
    ops.reset_launch_counts()
    got = esrnn.esrnn_forecast(cfg, params_to_device(params, card), y.to(card), cats.to(card))
    counts = ops.launch_counts()
    positions = 32 - cfg.input_size + 1             # the window positions the stack walks
    steps = sum(-(-positions // d) for block in cfg.dilations for d in block)
    assert counts == dict(counts, hw_scan_bf16=1, lstm_cell_bf16=steps, hw_scan=0,
                          lstm_cell=0, lstm_cell_fwd=0, lstm_cell_bwd=0)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2, atol=1e-3)


@pytest.mark.cuda
def test_cell_kernels_take_one_dtype_on_card(card):
    # K3, K4 and K5 take one dtype for all their inputs, as the reference
    # kernel; K2 takes a bf16 y only, every other stream float32
    h = torch.ones((2, 2), dtype=torch.bfloat16, device=card)
    w = torch.ones((3, 8), dtype=torch.bfloat16, device=card)
    wh = torch.ones((2, 8), dtype=torch.bfloat16, device=card)
    b = torch.ones(8, dtype=torch.bfloat16, device=card)
    x = torch.ones((2, 3), dtype=torch.bfloat16, device=card)
    act = torch.ones((2, 8), dtype=torch.bfloat16, device=card)
    with pytest.raises(TypeError, match="mix"):
        lstm_cell.lstm_cell(w.float(), wh, b, x, h, h)
    with pytest.raises(TypeError, match="mix"):
        lstm_cell.lstm_cell_fwd(w, wh, b, x, h.float(), h)
    with pytest.raises(TypeError, match="mix"):
        lstm_cell.lstm_cell_bwd(w, wh, x, h, h, h, act, h.float(), h)
    f = torch.ones(3, device=card)
    with pytest.raises(TypeError, match="dlev_tm is torch.bfloat16; the kernel takes float32"):
        hw_scan.hw_scan_bwd_tm(x, f, f, x.float(), torch.ones((3, 3), device=card), x,
                               torch.ones((3, 3), device=card))


# ---------------------------------------------------------------------------
# the bf16 streams of K2, K4 and K5 (bf16 training and the bf16 fine-tune)


# K2 at the train batches (256 and 2,048; m = 4 and the m == 1 convention),
# the fine-tune's (8, 256, 4), the wide rings, and N off the copy widths: a
# multiple of 4 but not of 8 (bf16 y one element a copy, the float streams
# 16 bytes), not of 4 (both one element), and 1
_BF16_SCAN_BWDS = ([(256, 72, 4), (2_048, 72, 4), (256, 72, 1), (2_048, 72, 1), (8, 256, 4)]
                   + [(300, 208, 168), (130, 440, 400), (40, 2030, 2000)]
                   + [(36, 41, 4), (12, 333, 4), (33, 70, 4), (3, 40, 12), (1, 9, 4),
                      (36, 41, 2), (24_004, 128, 4)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", _BF16_SCAN_BWDS)
def test_hw_scan_bwd_bf16_equals_plain_bit_for_bit_on_card(card, n, t_len, m):
    y, alpha, gamma, init_seas = _scan_bf16_case(n, t_len, m, n + t_len, card)
    g = torch.Generator().manual_seed(n + m)
    dlev = torch.randn((n, t_len), generator=g).to(card)
    dseas = torch.randn((n, t_len + m), generator=g).to(card)
    lev, seas = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    want = ref.hw_scan_bwd_ref(y, alpha, gamma, lev, seas, dlev, dseas)
    tm = lambda a: a.t().contiguous()
    args = (tm(y), alpha, gamma, tm(lev), tm(seas), tm(dlev), tm(dseas))
    ops.reset_launch_counts()
    with torch.no_grad():
        got = hw_scan.hw_scan_bwd_tm(*args)
        again = hw_scan.hw_scan_bwd_tm(*args)
    counts = ops.launch_counts()
    assert (counts["hw_scan_bwd_bf16"], counts["hw_scan_bwd"]) == (2, 0)
    assert got[0].dtype == torch.bfloat16
    for name, gt, w, a in zip(("dy", "dalpha", "dgamma", "dinit"), got, want, again):
        gt = gt.t() if gt.dim() == 2 else gt
        assert gt.dtype == w.dtype
        assert torch.equal(gt, w), f"K2 bf16 {name} differs from the plain version"
        assert torch.equal(gt, a.t() if a.dim() == 2 else a), "two launches differ"


def _within_ulp_or_atol(got, want, what):
    assert got.dtype == want.dtype == torch.bfloat16, what
    past = (ref.bf16_ulps(got, want) > 1) & ((got.float() - want.float()).abs() > 1e-5)
    assert not past.any(), f"{what}: {int(past.sum())} outputs past 1 bf16 ulp and atol 1e-5"


# K4 and K5 at every bf16 train-step shape (rows = batch x dilation, I = 14
# then 40, at batch 256 and 2,048), the fine-tune's (batch 8), the tests'
# odd width (I = 7, H = 50), and the widths past the presets
_BF16_TRAIN_CELLS = ([(b * d, i, 40) for b in (256, 2_048, 8)
                      for d, i in ((1, 14), (2, 40), (4, 40), (8, 40))]
                     + [(128, 7, 50), (333, 62, 50)]
                     + [(rows, hid, hid) for hid in (64, 128, 256) for rows in (1, 256)]
                     + [(33, 1030, 1030)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", _BF16_TRAIN_CELLS)
def test_lstm_cell_fwd_bwd_bf16_within_one_ulp_of_plain_on_card(card, rows, in_size, hidden):
    wx, wh, b, x, h, c = _cell_bf16_args(rows, in_size, hidden, rows + hidden, card)
    ops.reset_launch_counts()
    fwd = lstm_cell.lstm_cell_fwd(wx, wh, b, x, h, c)
    want_fwd = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    for name, gt, w in zip(("h", "c", "act"), fwd, want_fwd):
        _within_ulp_or_atol(gt, w, f"K4 bf16 {name}")
    # K5 on the plain forward's residuals, as the Function feeds it
    g = torch.Generator().manual_seed(rows + 1)
    dh = torch.randn((rows, hidden), generator=g).to(card, torch.bfloat16)
    dc = torch.randn((rows, hidden), generator=g).to(card, torch.bfloat16)
    _, c_new, act = want_fwd
    bwd_args = (wx, wh, x, h, c, c_new, act, dh, dc)
    got = lstm_cell.lstm_cell_bwd(*bwd_args)
    again = lstm_cell.lstm_cell_bwd(*bwd_args)
    want = ref.lstm_cell_bwd_ref(*bwd_args)
    counts = ops.launch_counts()
    assert (counts["lstm_cell_fwd_bf16"], counts["lstm_cell_bwd_bf16"]) == (1, 2)
    assert counts["lstm_cell_fwd"] == counts["lstm_cell_bwd"] == 0
    # every preset width (H <= 50) on the tensor cores, the wide widths not
    entry, plan = lstm_cell.bwd_launch(*bwd_args)
    assert entry == ("lstm_cell_bwd_bf16" if hidden <= 50 else "lstm_cell_bwd_wide_bf16")
    assert isinstance(plan, lstm_cell.BwdTcPlan) == (hidden <= 50)
    for name, gt, w in zip(("dx", "dh_prev", "dc_prev"), got[:3], want[:3]):
        _within_ulp_or_atol(gt, w, f"K5 bf16 {name}")
    # the weight gradients: float32 sums over B rows before any rounding,
    # bit-identical across launches
    for name, gt, w, a in zip(("dwx", "dwh", "db"), got[3:], want[3:], again[3:]):
        assert gt.dtype == torch.float32
        torch.testing.assert_close(gt, w, rtol=0, atol=1e-5 * max(1.0, rows ** 0.5))
        assert torch.equal(gt, a), f"K5 bf16 {name} differs between launches"


@pytest.mark.cuda
def test_lstm_cell_function_in_bf16_on_card(card):
    # K4 forward, K5 backward; the weight gradients rounded to bf16 once,
    # the fp32 master weights behind the cast receive float32
    masters = [a.float().requires_grad_(True)
               for a in _cell_bf16_args(256, 14, 40, 5, card)[:3]]
    x, h, c = (a.requires_grad_(True) for a in _cell_bf16_args(256, 14, 40, 6, card)[3:])
    ops.reset_launch_counts()
    h_new, c_new = ops.lstm_cell(*(m.to(torch.bfloat16) for m in masters), x, h, c)
    (h_new.float().square().sum() + c_new.float().sum()).backward()
    counts = ops.launch_counts()
    assert (counts["lstm_cell_fwd_bf16"], counts["lstm_cell_bwd_bf16"]) == (1, 1)
    assert h_new.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    cpu = [m.detach().cpu().requires_grad_(True) for m in masters]
    xc, hc, cc = (a.detach().cpu().requires_grad_(True) for a in (x, h, c))
    hw, cw = ops.lstm_cell(*(m.to(torch.bfloat16) for m in cpu), xc, hc, cc)
    (hw.float().square().sum() + cw.float().sum()).backward()
    # against the CPU Function: its forward rounds its own residuals, which
    # may sit 1 bf16 ulp from the card's, so the bf16 bound of the forecast
    for m, mc in zip(masters, cpu):
        assert m.grad.dtype == torch.float32
        torch.testing.assert_close(m.grad.cpu(), mc.grad, rtol=2e-2, atol=2e-2)
    for a, ac in zip((x, h, c), (xc, hc, cc)):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.cpu().float(), ac.grad.float(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# K5 in bf16 on the tensor cores (csrc/lstm_cell_bwd_tc.cu)


def _bwd_bf16_args(rows, in_size, hidden, seed, dev):
    """K5's bf16 inputs: a cell's bf16 inputs, the plain forward's c' and act
    (the residuals the Function saves) and bf16 cotangents."""
    wx, wh, b, x, h, c = _cell_bf16_args(rows, in_size, hidden, seed, dev)
    _, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    g = torch.Generator().manual_seed(seed + 1)
    dh, dc = (torch.randn((rows, hidden), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    return [wx, wh, x, h, c, c_new, act, dh, dc]


def _within_bwd_bounds(got, want, rows, what):
    # dx, dh_prev, dc_prev within 1 bf16 ulp or atol 1e-5; the float32
    # weight gradients, sums over B rows, within 1e-5 sqrt(B)
    for name, gt, w in zip(("dx", "dh_prev", "dc_prev"), got[:3], want[:3]):
        _within_ulp_or_atol(gt, w, f"{what} {name}")
    for gt, w in zip(got[3:], want[3:]):
        assert gt.dtype == torch.float32
        torch.testing.assert_close(gt, w, rtol=0, atol=1e-5 * max(1.0, rows ** 0.5))


# every preset width and the tests' (7, 50) at ragged rows: one row, a few,
# past two m-tiles, the train step's 256, a 64-row tile past 2,048 (clusters
# and tickets), and the largest train shape's row count
_BWD_TC_RAGGED = [(rows, in_size, hidden) for in_size, hidden in _PRESET_WIDTHS + [(7, 50)]
                  for rows in (1, 7, 33, 256, 2_049, 16_384)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", _BWD_TC_RAGGED)
def test_lstm_cell_bwd_tc_within_one_ulp_or_fp32_atol_of_plain_on_card(card, rows, in_size,
                                                                       hidden):
    args = _bwd_bf16_args(rows, in_size, hidden, rows + 3 * hidden + in_size, card)
    entry, plan = lstm_cell.bwd_launch(*args)
    assert entry == "lstm_cell_bwd_bf16" and isinstance(plan, lstm_cell.BwdTcPlan)
    ops.reset_launch_counts()
    got = lstm_cell.lstm_cell_bwd(*args)
    again = lstm_cell.lstm_cell_bwd(*args)
    counts = ops.launch_counts()
    assert (counts["lstm_cell_bwd_bf16"], counts["lstm_cell_bwd"]) == (2, 0)
    _within_bwd_bounds(got, ref.lstm_cell_bwd_ref(*args), rows, entry)
    for name, a, b in zip(("dx", "dh_prev", "dc_prev", "dwx", "dwh", "db"), got, again):
        assert torch.equal(a, b), f"K5 bf16 {name} differs between two launches"


def _off_16_bytes(t):
    """A copy of ``t`` whose base lies one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("in_size,hidden", [(14, 40), (40, 40), (10, 30), (7, 50)])
def test_lstm_cell_bwd_tc_takes_inputs_off_16_byte_bases_on_card(card, in_size, hidden):
    rows = 333
    args = _bwd_bf16_args(rows, in_size, hidden, 11, card)
    shifted = [_off_16_bytes(t) for t in args]
    assert all(t.data_ptr() % 16 == 2 for t in shifted)
    entry, plan = lstm_cell.bwd_launch(*shifted)
    assert entry == "lstm_cell_bwd_bf16"
    # every stream one element a copy
    assert (plan.copy_w, plan.copy_x, plan.copy_h, plan.copy_r) == (2, 2, 2, 2)
    got = lstm_cell.lstm_cell_bwd(*shifted)
    _within_bwd_bounds(got, ref.lstm_cell_bwd_ref(*args), rows, "K5 bf16 off 16-byte bases")
    # the copies move the same values, so the sums are the aligned launch's
    for name, a, b in zip(("dx", "dh_prev", "dc_prev", "dwx", "dwh", "db"), got,
                          lstm_cell.lstm_cell_bwd(*args)):
        assert torch.equal(a, b), f"K5 bf16 {name} differs from the aligned inputs'"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [256, 4_000], ids=["split", "clusters"])
@pytest.mark.parametrize("fault", ["short", "smem", "copy", "geometry"])
def test_lstm_cell_bwd_tc_refuses_a_plan_the_source_does_not_take_on_card(card, monkeypatch,
                                                                          fault, rows):
    # the constants and plan length shared with csrc/lstm_cell_bwd_tc.cu agree
    # (checked when the library is first used) ...
    lstm_cell._kernel_library()
    # ... and its entry point refuses, in either plan, a plan one int short,
    # 4 bytes of shared memory short of the layout, a 16-byte copy of x rows
    # that are 28 bytes long, or a cluster of more blocks than the kernel sums
    # (the split plan: a column block short of the units)
    real = lstm_cell.bwd_tc_plan
    faults = dict(smem=lambda p: p._replace(smem=p.smem - 4),
                  copy=lambda p: p._replace(copy_x=16),
                  geometry=lambda p: (p._replace(blocks=p.blocks - 1) if p.row_blocks
                                      else p._replace(cluster=lstm_cell.BWD_TC_CLUSTER + 1)))
    if fault == "short":
        monkeypatch.setattr(lstm_cell, "_plan_ints",
                            lambda plan: (ctypes.c_int * (len(plan) - 1))(*plan[:-1]))
    else:
        monkeypatch.setattr(lstm_cell, "bwd_tc_plan", lambda *a: faults[fault](real(*a)))
    args = _bwd_bf16_args(rows, 14, 40, 5, card)
    entry, plan = lstm_cell.bwd_launch(*args)
    assert entry == "lstm_cell_bwd_bf16" and (plan.row_blocks > 0) == (rows == 256)
    with pytest.raises(RuntimeError, match="invalid argument"):
        lstm_cell.lstm_cell_bwd(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hidden", [(256, 64), (256, 128), (256, 256), (33, 1030)])
def test_lstm_cell_bwd_bf16_past_the_presets_launches_the_wide_kernel_on_card(card, rows,
                                                                              hidden):
    args = _bwd_bf16_args(rows, hidden, hidden, rows + hidden, card)
    lim = build.device_limits(card)
    assert lstm_cell.bwd_tc_plan(rows, hidden, hidden, lim.smem_optin, lim.sm_count) is None
    entry, plan = lstm_cell.bwd_launch(*args)
    assert entry == "lstm_cell_bwd_wide_bf16" and isinstance(plan, lstm_cell.BwdPlan)
    ops.reset_launch_counts()
    got = lstm_cell.lstm_cell_bwd(*args)
    assert ops.launch_counts()["lstm_cell_bwd_bf16"] == 1
    _within_bwd_bounds(got, ref.lstm_cell_bwd_ref(*args), rows, entry)


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_bf16_train_step_launches_only_the_bf16_kernels_on_card(card, sparse):
    from repro_torch.convert import copy_params
    from repro_torch.core import esrnn
    from repro_torch.train.engine import make_step_fn
    from repro_torch.train.optimizer import AdamConfig, adam_init, adam_init_sparse

    cfg = esrnn.make_config("quarterly", precision="bf16")
    n, t_len, batch = 64, 40, 16
    g = torch.Generator().manual_seed(2)
    y = torch.rand((n, t_len), generator=g) * 100 + 50
    cats = torch.eye(6)[torch.randint(0, 6, (n,), generator=g)]
    mask = torch.ones((n, t_len))
    idx = torch.randperm(n, generator=g)[:batch]
    params = esrnn.esrnn_init(torch.Generator().manual_seed(0), cfg, n, device="cpu")
    adam = AdamConfig(lr=1e-3, clip_norm=20.0, group_lr={"per_series": 10.0, "default": 1.0})
    losses = {}
    for where in ("cpu", "card"):
        dev = torch.device("cpu") if where == "cpu" else card
        p = copy_params(params, dev)
        opt = adam_init_sparse(p) if sparse else adam_init(p)
        step = make_step_fn(cfg, adam, y.to(dev), cats.to(dev), mask.to(dev), sparse=sparse)
        ops.reset_launch_counts()
        p, opt, loss = step(p, opt, idx.to(dev))
        losses[where] = float(loss)
        if where == "card":
            counts = ops.launch_counts()
            for _, leaf in esrnn.param_leaves(p):
                assert leaf.dtype == torch.float32
    positions = t_len - cfg.input_size + 1
    steps = sum(-(-positions // d) for block in cfg.dilations for d in block)
    want = dict.fromkeys(counts, 0)
    want.update(hw_scan_bf16=1, hw_scan_bwd_bf16=1, lstm_cell_fwd_bf16=steps,
                lstm_cell_bwd_bf16=steps)
    assert counts == want
    assert abs(losses["card"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"])


# ---------------------------------------------------------------------------
# K5's dx-only launch: dx, dh_prev and dc_prev alone, for a step whose weights
# need no gradient (the esn head's frozen reservoir)

# the main path's K5 shapes (H = 40): the train step's layers at batch 256
# and 2,048 (rows = batch x dilation, I = 14 then 40) and the fine-tune's
# 8 to 64 rows; beside them ragged rows, the other preset widths and the
# widths past the presets
_DX_CELLS = ([(b * d, i, 40) for b in (256, 2_048, 8) for d, i in
              ((1, 14), (2, 40), (4, 40), (8, 40))]
             + [(rows, in_size, hidden) for in_size, hidden in ((10, 30), (18, 50), (62, 50))
                for rows in (1, 33, 2_049)]
             + [(rows, hid, hid) for hid in (64, 128) for rows in (1, 256)] + [(33, 1030, 1030)])


def _dx_args(rows, in_size, hidden, bf16, dev):
    if bf16:
        wx, wh, x, h, c, c_new, act, dh, dc = _bwd_bf16_args(rows, in_size, hidden,
                                                             rows + hidden, dev)
    else:
        wx, wh, b, x, h, c = _cell_inputs(rows, in_size, hidden, rows + hidden)
        _, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
        g = torch.Generator().manual_seed(rows + 1)
        dh, dc = (torch.randn((rows, hidden), generator=g) for _ in range(2))
        wx, wh, x, h, c, c_new, act, dh, dc = (a.to(dev) for a in (wx, wh, x, h, c, c_new, act,
                                                                   dh, dc))
    return [wx, wh, x, h, c, c_new, act, dh, dc]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,in_size,hidden", _DX_CELLS)
def test_lstm_cell_bwd_dx_matches_the_full_launch_and_plain_on_card(card, bf16, rows, in_size,
                                                                    hidden):
    full_args = _dx_args(rows, in_size, hidden, bf16, card)
    wx, wh, x, h, c, c_new, act, dh, dc = full_args
    dx_args = (wx, wh, c, c_new, act, dh, dc)
    entry, plan = lstm_cell.bwd_dx_launch(*dx_args)
    full_entry, _ = lstm_cell.bwd_launch(*full_args)
    assert entry == full_entry.replace("_bwd_", "_bwd_dx_")     # the same kernel, dx-only
    ops.reset_launch_counts()
    got = lstm_cell.lstm_cell_bwd_dx(*dx_args)
    again = lstm_cell.lstm_cell_bwd_dx(*dx_args)
    counts = ops.launch_counts()
    suffix = "_bf16" if bf16 else ""
    assert counts[f"lstm_cell_bwd_dx{suffix}"] == 2 and counts[f"lstm_cell_bwd{suffix}"] == 0
    for name, a, b in zip(("dx", "dh_prev", "dc_prev"), got, again):
        assert torch.equal(a, b), f"dx-only K5 {name} differs between two launches"
    full = lstm_cell.lstm_cell_bwd(*full_args)
    want = ref.lstm_cell_bwd_dx_ref(*dx_args)
    for name, g, f, w in zip(("dx", "dh_prev", "dc_prev"), got, full, want):
        assert g.dtype == c.dtype
        if bf16:
            _within_ulp_or_atol(g, w, f"dx-only K5 bf16 {name}")
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        # the full launch's row blocks, or the same per-row sums: its bits
        # in fp32 and in the bf16 split plan; past 512 rows in bf16 (the
        # full launch's cluster plan) held to it within the bf16 bound
        if bf16 and rows > lstm_cell.BWD_TC_SPLIT_ROWS and isinstance(plan, lstm_cell.BwdTcPlan):
            _within_ulp_or_atol(g, f, f"dx-only K5 bf16 {name} against the full launch")
        else:
            assert torch.equal(g, f), f"dx-only K5 {name} differs from the full launch's"


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fault", ["short", "smem", "geometry"])
def test_lstm_cell_bwd_dx_refuses_a_plan_the_source_does_not_take_on_card(card, monkeypatch,
                                                                          bf16, fault):
    # a plan one int short, 4 bytes of shared memory short of the layout, or
    # a plan with column blocks (fp32) or a cluster (bf16) is refused
    lstm_cell._kernel_library()
    name = "bwd_dx_tc_plan" if bf16 else "bwd_dx_plan"
    real = getattr(lstm_cell, name)
    faults = dict(smem=lambda p: p._replace(smem=p.smem - 4),
                  geometry=lambda p: (p._replace(cluster=2, blocks=2 * p.blocks) if bf16
                                      else p._replace(chunks=1)))
    if fault == "short":
        monkeypatch.setattr(lstm_cell, "_plan_ints",
                            lambda plan: (ctypes.c_int * (len(plan) - 1))(*plan[:-1]))
    else:
        monkeypatch.setattr(lstm_cell, name, lambda *a: faults[fault](real(*a)))
    wx, wh, x, h, c, c_new, act, dh, dc = _dx_args(256, 14, 40, bf16, card)
    with pytest.raises(RuntimeError, match="invalid argument"):
        lstm_cell.lstm_cell_bwd_dx(wx, wh, c, c_new, act, dh, dc)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("sparse", [False, True])
def test_esn_train_step_launches_the_dx_only_k5_on_card(card, precision, sparse):
    from repro_torch.convert import copy_params
    from repro_torch.core import esrnn
    from repro_torch.train.engine import make_step_fn, split_frozen
    from repro_torch.train.optimizer import AdamConfig, adam_init, adam_init_sparse

    cfg = esrnn.make_config("quarterly", head="esn", precision=precision)
    n, t_len, batch = 64, 40, 16
    g = torch.Generator().manual_seed(2)
    y = torch.rand((n, t_len), generator=g) * 100 + 50
    cats = torch.eye(6)[torch.randint(0, 6, (n,), generator=g)]
    mask = torch.ones((n, t_len))
    idx = torch.randperm(n, generator=g)[:batch]
    params = esrnn.esrnn_init(torch.Generator().manual_seed(0), cfg, n, device="cpu")
    adam = AdamConfig(lr=1e-3, clip_norm=20.0, group_lr={"per_series": 10.0, "default": 1.0})
    losses = {}
    for where in ("cpu", "card"):
        dev = torch.device("cpu") if where == "cpu" else card
        p = copy_params(params, dev)
        trainable = split_frozen(p, {"rnn"})[0]
        opt = adam_init_sparse(trainable) if sparse else adam_init(trainable)
        step = make_step_fn(cfg, adam, y.to(dev), cats.to(dev), mask.to(dev), sparse=sparse,
                            frozen=frozenset({"rnn"}))
        ops.reset_launch_counts()
        p, opt, loss = step(p, opt, idx.to(dev))
        losses[where] = float(loss)
        if where == "card":
            counts = ops.launch_counts()
            for (path, leaf), (_, leaf0) in zip(esrnn.param_leaves(p),
                                                esrnn.param_leaves(params)):
                if path[0] == "rnn":
                    assert torch.equal(leaf.cpu(), leaf0), path
    positions = t_len - cfg.input_size + 1
    steps = sum(-(-positions // d) for block in cfg.dilations for d in block)
    s = "_bf16" if precision == "bf16" else ""
    want = dict.fromkeys(counts, 0)
    want.update({f"hw_scan{s}": 1, f"hw_scan_bwd{s}": 1, f"lstm_cell_fwd{s}": steps,
                 f"lstm_cell_bwd_dx{s}": steps})
    assert counts == want
    rtol = 2e-2 if precision == "bf16" else 1e-5
    assert abs(losses["card"] - losses["cpu"]) <= rtol * abs(losses["cpu"])


# -- the out-of-core fit's host table and copy stream ---------------------------


@pytest.mark.cuda
def test_host_table_device_slice_on_a_copy_stream_on_card(card):
    from repro_torch.train.host_table import HostStateTable, pinned_copy

    n, lo, hi = 200_000, 70_000, 190_000
    table = HostStateTable.init(n, 4, device=card)
    assert table.is_pinned()
    table.hw.alpha_logit.copy_(torch.arange(n, dtype=torch.float32))
    table.t_hw.copy_(torch.arange(n, dtype=torch.int32))
    data = pinned_copy(torch.arange(n * 3, dtype=torch.float32).reshape(n, 3), card)
    stream = table.copy_stream()
    assert stream != torch.cuda.current_stream() and stream != torch.cuda.default_stream()
    # hold the copy stream back, so that a read not ordered after the copy
    # would find the destination unwritten
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)
    rows = table.device_slice(lo, hi, (data[lo:hi],))
    assert rows.stream is stream and rows.done is not None
    rows.wait()
    got = [rows.state["hw"].alpha_logit * 1, rows.state["t_hw"] + 0, rows.extra[0] * 1]
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), table.hw.alpha_logit[lo:hi])
    assert torch.equal(got[1].cpu(), table.t_hw[lo:hi])
    assert torch.equal(got[2].cpu(), data[lo:hi])
    unpinned = HostStateTable(table.hw.map(lambda a: a.clone()), device=card)
    with pytest.raises(RuntimeError, match="pinned"):
        unpinned.device_slice(0, 10)


@pytest.mark.cuda
def test_chunked_fit_restaging_a_chunk_equals_chunk_resident_on_card(card):
    from repro_torch.core.esrnn import make_config, param_leaves
    from repro_torch.data.pipeline import chunk_visit_order, chunk_visit_plan, synthetic_prepared
    from repro_torch.train.trainer import TrainConfig, train_esrnn

    n, chunk, batch = 4096, 2048, 256
    # a seed whose first two epochs visit the two chunks in the same order:
    # A, B, A, B -- A's rows are staged again while B computes
    seed = next(s for s in range(100)
                if np.array_equal(chunk_visit_order(2, 0, s), chunk_visit_order(2, 1, s)))
    kw = dict(batch_size=batch, n_steps=24, scan_steps=4, series_chunk=chunk, eval_every=24,
              ckpt_every=1000, seed=seed, straggler_factor=float("inf"))
    visits = [(v.lo, v.hi) for v in chunk_visit_plan(n, chunk, batch, 0, 24, seed=seed)]
    assert len(visits) == 3 and visits[0] == visits[2] != visits[1]
    cfg = make_config("quarterly")
    data = synthetic_prepared(n, series_length=36)
    runs = [train_esrnn(cfg, data, TrainConfig(chunk_resident=resident, **kw), device=card,
                        generator=torch.Generator().manual_seed(0))
            for resident in (False, True)]
    assert runs[0]["history"]["loss"] == runs[1]["history"]["loss"]
    assert len(runs[0]["history"]["h2d"]) == 3
    for (path, a), (_, b) in zip(param_leaves(runs[0]["params"]),
                                 param_leaves(runs[1]["params"])):
        assert torch.equal(a.cpu(), b.cpu()), path
    assert runs[0]["params"]["hw"].alpha_logit.is_pinned()
    assert torch.equal(runs[0]["opt_state"]["t_hw"], runs[1]["opt_state"]["t_hw"].cpu())


@pytest.mark.cuda
def test_rope_at_width_80_matches_the_cpu_to_position_4096_on_card(card):
    """zamba2's rotated width, 80, at every position a train cell reaches and
    past it: the card's frequencies are the CPU's bits (both made on the
    host), and the rotation within 1e-5 of the CPU's (the card's sin and cos
    of the same float32 angles)."""
    from repro_torch.models import layers as TL

    assert torch.equal(TL.rope_freqs(80, 10000.0, card).cpu(), TL.rope_freqs(80, 10000.0))
    gen = torch.Generator().manual_seed(80)
    x = torch.randn((2, 4096, 3, 80), generator=gen)
    pos = torch.arange(4096)[None, :]
    want = TL.apply_rope(x, pos, theta=10000.0)
    got = TL.apply_rope(x.to(card), pos.to(card), theta=10000.0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_train_step_takes_the_plain_attention_route_on_card(card):
    """A train step's attention needs a gradient: the plain chunked path on
    the card too, counted, and no K6 launch; without a gradient the same
    call launches K6, and K6 itself still refuses a tensor that needs one."""
    import dataclasses

    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import attention as A
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import adam_init

    strict_fp32()
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    cell = ShapeCell("t", "train", 32, 4, microbatch=2)
    batch = synthetic_batch(cfg, cell, 0, device=card)
    A.reset_grad_route_calls()
    ops.reset_launch_counts()
    _, _, loss = S.make_train_step(model, cell)(params, adam_init(params), batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert ops.launch_counts()["flash_attention"] == 0
    assert A.grad_route_calls() == cfg.n_layers * 2 * 2      # layers x microbatches x remat
    q = torch.randn((1, 4, 32, 16), device=card, requires_grad=True)
    k = torch.randn((1, 2, 32, 16), device=card)
    with torch.no_grad():
        A.chunked_attention(q, k, k, causal=True, scale=0.25)
    assert ops.launch_counts()["flash_attention"] == 1
    with pytest.raises(RuntimeError, match="needs a gradient"):
        flash_attention.flash_attention(q, k, k, causal=True)


def _mesh_collectives_rank(mesh, seed):
    """One rank of ``test_mesh_gather_and_reduce_scatter_on_one_nccl_rank``."""
    g = torch.Generator(device=mesh.device).manual_seed(seed)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.randn((6, 5, 4), generator=g, device=mesh.device).to(dtype)
        for dim in (0, 1, 2):
            gathered = mesh.axis("data").all_gather(t, dim)
            scattered = mesh.axis("model").reduce_scatter(t, dim)
            out[str(dtype), dim] = (torch.equal(gathered, t), torch.equal(scattered, t))
    return out, mesh.backend, mesh.collective_counts()


@pytest.mark.cuda
def test_mesh_gather_and_reduce_scatter_on_one_nccl_rank(card):
    """``MeshAxis.all_gather`` and ``reduce_scatter`` on one NCCL rank (the
    native ``all_gather_into_tensor`` and ``reduce_scatter_tensor``, not the
    gloo all-reduces) give one device's bits, fp32 and bf16, on every dim."""
    import functools

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import run_ranks

    (got, backend, counts), = run_ranks(_mesh_collectives_rank, 1, device="cuda", args=(4,),
                                        mesh_factory=functools.partial(make_host_mesh, 1))
    assert backend == "nccl"
    assert all(a and b for a, b in got.values()), got
    assert counts == {"data": {"all_gather": 6}, "model": {"reduce_scatter": 6}}


@pytest.mark.cuda
def test_sharded_train_matches_one_device_on_card(card):
    """``train(model_parallel=2)`` on the card (two gloo ranks sharing it, a
    (1, 2) mesh) against the one-device card run at SMOKE size: the losses
    within rtol 1e-5, the gathered masters within the bf16 bound, no K6."""
    import numpy as np

    from repro_torch.launch import train as T
    from repro_torch.train.optimizer import param_leaves

    kw = dict(smoke=True, steps=3, batch=4, seq=32, microbatch=2, seed=2, device="cuda")
    got = T.train("qwen3-moe-30b-a3b", model_parallel=2, **kw)
    want = T.train("qwen3-moe-30b-a3b", **kw)
    assert got["mesh"] == {"data": 1, "model": 2, "backend": "gloo"}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for (_, a), (_, b) in zip(param_leaves(got["params"]), param_leaves(want["params"]),
                              strict=True):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=2e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b_shape", [(48, 40), (3, 48, 40)])
def test_mm_f32_gradients_on_card(card, b_shape):
    """``layers.mm_f32`` of bf16 operands under a gradient (a sharded train
    step's row-parallel products; the card's ``out_dtype`` GEMM has no
    derivative): float32 outputs, and the gradients of the operands' own
    bf16 GEMM, within an ulp."""
    from repro_torch.models.layers import mm_f32

    g = torch.Generator(device=card).manual_seed(0)
    a_shape = (3, 16, 48) if len(b_shape) == 3 else (2, 16, 48)
    a = torch.randn(a_shape, generator=g, device=card).to(torch.bfloat16).requires_grad_()
    b = torch.randn(b_shape, generator=g, device=card).to(torch.bfloat16).requires_grad_()
    out = mm_f32(a, b)
    assert out.dtype == torch.float32
    ct = torch.randn(out.shape, generator=g, device=card).to(torch.bfloat16).float()
    out.backward(ct)
    a2, b2 = a.detach().requires_grad_(), b.detach().requires_grad_()
    ref = a2 @ b2
    ref.backward(ct.to(torch.bfloat16))
    torch.testing.assert_close(out, a.detach().float() @ b.detach().float(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(a.grad, a2.grad)      # the bf16 defaults: an ulp
    torch.testing.assert_close(b.grad, b2.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b"])
def test_sharded_remat_step_matches_one_device_on_card(card, arch):
    """One sharded fp32 step with every layer recomputed in the backward, on
    two gloo ranks sharing the card (a (1, 2) mesh): the one-device card
    step's loss and gradients (rtol 1e-5; each leaf within 1e-5 of its
    largest). On the card the backward, and so the recompute, runs on the
    autograd engine's thread: the recompute must find the mesh's context."""
    import functools

    import numpy as np
    import torch_tp_train_ranks as R

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import run_ranks

    got = run_ranks(R.grads_case, 2, device="cuda", args=(arch, True),
                    mesh_factory=functools.partial(make_host_mesh, 2))
    want = R.grads_case(make_host_mesh(1, device=card), arch, True)
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank]["loss"], want["loss"], rtol=1e-5)
        for k, w in want["grads"].items():
            err = float(np.abs(got[rank]["grads"][k] - w).max())
            assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-30), (arch, rank, k, err)
        assert got[rank]["collectives"]["model"]["all_reduce"] >= \
            got[rank]["want_collectives"]["model"]["all_reduce"]
