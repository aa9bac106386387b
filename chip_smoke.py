#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc (printing the build seconds and ptxas's report on the attention,
LSTM-cell and HW-scan sources), holds every kernel against its plain
PyTorch version on the card (K1/K2 records carry their launch plan),
drives the forecast-serving path at the full width of the paper's
quarterly model (hidden 40, dilations ((1, 2), (4, 8)), 6 categories; random weights
from a fixed seed) and checks it against the same calls on the CPU, then
serves requests through ``ForecastServer`` on the card. It then trains the
same model on the card (``train_esrnn``: 24,000 quarterly series of length
72, dense and sparse Adam) against the same steps on the CPU, trains it at
``hidden_size=64`` (the width of the reference's own spec example) the
same way, times train steps, profiles one, and runs a server whose idle
fine-tune trains on the card against a CPU server. Last, the LM serving path: yi-6b at full width
and two layers in fp32 on the card against the CPU (``lm_parity``), then at
full width and depth in bf16 (``lm_serve``: batch 8, prompt 2048, 32
generated tokens; K6 once per layer in the prefill), and one profiled
prefill and decode step; then the MoE family: qwen3-moe-30b-a3b at full
width and two layers in fp32 on the card against the CPU, its routing held
equal on the same layer input and its dropped share equal on both devices,
with deepseek-v2-lite's MoE layer (routed and shared experts) alone
(``lm_moe_parity``), 12 of its 48 layers in bf16 through the serve
launcher (``lm_moe_serve``; ``SERVE_DEPTH``), and one profiled prefill and decode step with
their device time split into the expert products, the dispatch, K6, the
attention projections and the rest (``profile_lm_moe``,
``profile_lm_moe_decode``); then MLA: deepseek-v2-lite-16b at full width
and two layers in fp32 on the card against the CPU, its MLA caches and
routing equal and its absorbed decode held to the up-projected one
(``lm_mla_parity``), the full 27-layer model in bf16 through the serve
launcher, K6 once per layer at q . k 192 and v 128 (``lm_mla_serve``), and
one profiled prefill and decode step split the same way, with the MLA
projections and the absorbed attention apart (``profile_lm_mla``,
``profile_lm_mla_decode``); then the vlm, ssm and hybrid families:
internvl2-2b (256 image patches before the prompt), mamba2-1.3b (at a
prompt of 128 and one the SSD pads) and zamba2-2.7b (12 layers: two
applications of its shared block) at full width in fp32 on the card
against the CPU, logits and every cache (``lm_vlm_parity``,
``lm_ssm_parity``, ``lm_hybrid_parity``), each at full width in bf16
(internvl2 at full depth, mamba2 and zamba2 at 12 blocks: ``SERVE_DEPTH``)
through the serve launcher (``lm_vlm_serve``: K6 once per layer;
``lm_ssm_serve``: no K6, and what the Mamba2 block's SiLU costs against
``F.silu``; ``lm_hybrid_serve``: K6 at head dim 80 once per application of
the shared block), and one profiled hybrid prefill and
decode step split into the SSD einsums, the conv, the projections, K6 and
the rest (``profile_lm_hybrid``); then the encoder-decoder: whisper-base at
full width and depth (6 + 6 layers) in fp32 on the card against the CPU
and float64, logits and every cache with the encoder's memory, K6 18 times
a prefill and 6 a decode step (``lm_encdec_parity``), in bf16 through the
serve launcher with 1,500 synthetic frames (``lm_encdec_serve``: K6 held
against its plain version on the first launch of each of its four uses,
the tanh GELU's cost against ``F.gelu``) and one profiled prefill and
decode step split into the encoder, the decoder's self-attention, the
cross-attention, the MLPs and K6 (``profile_lm_encdec``); last,
granite-3-2b, chatglm3-6b and qwen2.5-14b at full width and 2 layers in
fp32 against the CPU and float64 (``lm_dense_parity``) and at full width
and 12 layers in bf16 (``lm_dense_serve``: K6 on the first layer's own q, k, v
at the model's scale); then tensor-parallel serving on two gloo ranks
sharing the card, a (1, 2) host mesh, in one spawn: every arch at full width
and the parity depths in fp32 against the one-device card run of the same
weights, logits and every cache, routing, K6 launches and collectives per
rank (``lm_tp_parity``), and yi-6b at full width and depth in bf16, 2 x 512
+ 8 tokens (``lm_tp_serve``: prefill and decode ms, each rank's peak GB and
collective ms a step, the logits held to the model in fp32 against the
one-device bf16 serve's, K6 at 16 q and 2 kv heads against its plain
version); the production-mesh dry-run of every cell (``dryrun``); then LM
training, for granite-3-2b, qwen3-moe,
deepseek-v2-lite, internvl2-2b, mamba2-1.3b, zamba2-2.7b and whisper-base:
at full width and the parity depths in fp32, the loss and every gradient
card against CPU, MoE routing equal, remat on against off, and one bf16
train step in 2 microbatches, its update leaf by leaf against the step's
plain version on the card and, for three of them, against the CPU
(``lm_train_parity``); each in the train cell
(seq 2,048, batch 8 in microbatches of 2, 1 warm-up and 3 timed steps)
through the train launcher, whisper-base at full depth, the others cut
in depth (``TRAIN_DEPTH``), whisper-base also resumed from a
checkpoint (``lm_train``: ms a step, tokens/s, peak GB, K6 0 launches and
the plain attention route counted); one granite-3-2b step of one
microbatch profiled by part
(``profile_lm_train``); then sharded LM training on four gloo ranks sharing
the card, a (2, 2) host mesh (FSDP on ``data``, heads, hidden units and the
MoE experts on ``model``), in one spawn: yi-6b, deepseek-v2-lite,
internvl2-2b, mamba2-1.3b, zamba2-2.7b (6 blocks) and whisper-base at full
width in fp32, one step's loss, clip norm and every gradient shard against
the one-device card step on the same weights and rows, routing and the
collectives of the training plan (``lm_train_tp_parity``), and yi-6b at full
width, 2 layers, bf16 compute over fp32 masters, 4 x 512 tokens in 2
microbatches through the train launcher's ``train_on_mesh``, its losses
against the one-device bf16 run (``lm_train_tp``: ms a step, tokens/s, each
rank's collective ms by axis and op, peak GB, bytes of masters and Adam
state against the dry-run's); last, the three Torch examples
(``examples/*_torch.py`` but train_lm's), each once in a process of its
own on the card (``examples``: exit 0, the last printed line). Every phase
line carries the script's wall seconds so far (``wall_s``); ``done`` closes
the phases. Between the fp32 serving
phases and training, the
same forecast and server run under the bf16 policy (``precision="bf16"``:
K1 with a bf16 y, K3 in bf16 on the tensor cores; phases ``forecast_bf16``, ``profile_bf16``
and ``serve_bf16``), against the CPU and the card's fp32 forecast. After
the fine-tune, training and the fine-tune run under bf16 too (K1 and K2
with a bf16 y, K4 and K5 in bf16 on the tensor cores; phases ``train_bf16``,
``profile_train_bf16`` and ``finetune_bf16``), against the CPU and the
card's fp32 training, and ``owa_bf16`` fits head_compare's fast cell in
fp32 and bf16 on the card and holds the bf16/fp32 OWA ratio to 1.01.
``estimator`` then drives the user surface at the same width: the
esrnn-quarterly spec on its full synthetic quarterly set, fitted through
the forecast CLI (``repro_torch.launch.forecast``, in process) on the card
against the estimator on the CPU, resumed from a checkpoint bit for bit,
its saved directory served by every inference subcommand against the same
directory loaded on the CPU, head_compare's fast cell held to the
reference's lstm OWA, and a bf16 fit and eval through the spec. ``heads``
then drives the esn and ssm heads at the same width: the forecast cell on
the card (held to the CPU on its first 2,048 series), dense train steps
against the CPU (the esn reservoir bit-identical; per step K4 and K5's
dx-only launch 124 times each, the full K5 never; the ssm head K1 and K2
only), esn under bf16, an esn fine-tune server, head_compare's fast cell
per head against the reference's OWA, and each head's spec through the
CLI with a resume bit for bit; K5's dx-only launch is also held against
its plain version and the full K5 in phase ``kernel``. ``chunked`` then
drives the out-of-core fit, its per-series table pinned on the host and
streamed to the card on a copy stream: (a) at M4's quarterly count, 24,000
series in chunks of 2,048, the streamed fit equal to the fit with the whole
table on the card bit for bit (fp32, bf16, esn), within TRAIN_RTOL of the
CPU's, resumed from its row-sharded checkpoint bit for bit, its launches
counted; (b) 1,000,000 series at full width (the reference's gate size):
steps/s, the copies' ms per visit and their overlap with the compute
stream in a profiler trace, a streamed predict, the device peak against
the same fit at 250,000 series (within 5 %) and against the resident fit,
and the reference's peak_memory cell beside its 0.175; (c) the CLI with
``--set series_chunk=2048``, every subcommand from the sharded directory
against the CPU; (d) the reference's own 1M gate (hidden 8, T = 24) in a
fresh process (``chip_smoke.py --million``): wall time and peak host RSS,
split by owner. ``dp`` then drives series data parallelism: two gloo ranks
sharing the card (``repro_torch.sharding.run_ranks``) fit the train cell
dense and sparse, fp32 and bf16, esn and chunked, predict, backtest and
eval the forecast cell and serve the serve cell's requests, against the
same calls on one device of the card (ranks bit-identical, collectives and
each rank's launches counted); the sharded loss, eval and backtest on one
NCCL rank equal one device bit for bit; ``fit --devices 2`` through the CLI
against ``--devices 1``. ``analyze`` then runs the invariant auditor
(``repro_torch.analysis``) through the CLI at full width: the lstm fp32,
bf16, esn, ssm and chunked fits, forecasts and dispatchers, ``--devices
2`` on two gloo ranks sharing the card and one NCCL rank, each report
``ok`` (the esn step launching K5's dx-only kernel once per cell step, the
full K5 never), one seeded violation per lint found on the card, and the
recorders' cost per step. Each phase prints
one JSON line (``heads`` one per part); any failed check raises and the
script exits non-zero. The last line is ``{"ok": true, "device": {...}}``.

It needs one CUDA device and the ``src/`` tree beside it, and imports
nothing of the JAX package. fp32 parity: TF32 is switched off for matmuls
and convolutions before anything runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the quarterly M4 cell: 24,000 series (M4's quarterly count), T = 128
N_SERIES, T_LEN = 24_000, 128
ORIGINS = (64, 96, 128)
# the server's buckets (ForecastServer's defaults, passed explicitly)
LENGTH_BUCKETS, BATCH_BUCKETS = (32, 64, 128, 256), (1, 4, 16, 64)
N_REQUESTS = 96
N_OBSERVED = 4
OBS_LEN = 40

# the train cell: M4's quarterly count at the quarterly MIN_LENGTH (72), the
# esrnn-quarterly spec's batch and the largest batch of
# benchmarks/table5_speedup.py
TRAIN_N, TRAIN_T = 24_000, 72
TRAIN_BATCH, BIG_BATCH = 256, 2048
DENSE_STEPS, SPARSE_STEPS, SPARSE_SCAN = 10, 8, 4
TIMED_STEPS = 10
# the wide train cell: the quarterly model at hidden_size=64
# (src/repro/forecast/spec.py's example), batch 256, dense steps
WIDE_HIDDEN, WIDE_STEPS = 64, 3
# the fine-tune server: known series observed, observations each, steps per burst
FT_SERIES, FT_OBS, FT_STEPS = 8, 40, 2
# the OWA cell: benchmarks/head_compare.py's fast cell (the quarterly
# synthetic split at scale 0.002, seed 0; 40 steps at batch min(64, N), lr
# 4e-3), and the reference's bf16/fp32 lstm OWA ratio on it (JAX on the
# CPU, BENCH_PR10.json's head_compare) beside the gate both are held to
OWA_SCALE, OWA_STEPS, OWA_BATCH, OWA_LR = 0.002, 40, 64, 4e-3
OWA_RATIO_GATE, OWA_RATIO_REFERENCE = 1.01, 0.992
# the estimator cell: the esrnn-quarterly spec at the paper's width, its
# synthetic M4 quarterly set in full (data_scale=1.0: 24,000 series drawn,
# 8,572 of at least the quarterly MIN_LENGTH kept by the section-5.2
# equalization), batch 256, driven through the forecast CLI and the
# estimator; 20 fp32 steps with eval and checkpoints every 10, a resume
# from step 10, 10 bf16 steps; the serve and observe calls of the CLI; and
# the reference's lstm OWA on head_compare's fast cell (BENCH_PR10.json
# head_compare, JAX on the CPU) with the factor it is held to
EST_SPEC, EST_STEPS, EST_EVERY, EST_BF16_STEPS = "esrnn-quarterly", 20, 10, 10
EST_SCALE = 1.0
EST_SETS = (f"data_scale={EST_SCALE}", f"eval_every={EST_EVERY}", f"ckpt_every={EST_EVERY}")
EST_REQUESTS, EST_WAVES = 64, 2
EST_OBSERVE = ({"op": "observe", "series_id": 0, "y": 105.2},
               {"op": "forecast", "series_id": 0}, {"op": "stats"})
EST_OWA_SETS = ("data_scale=0.002", "rnn_lr=0.004", "hw_lr=0.04", "batch_size=64")
EST_OWA_REFERENCE, EST_OWA_FACTOR = 0.687, 1.01

# the heads cell: the esn and ssm heads at the quarterly preset's full width
# (hidden 40, dilations ((1, 2), (4, 8)), 6 categories; ssm: 5 heads x 8,
# state 8, chunk 32), weights random from a seed. The forecast at the
# forecast cell's N and T on the card, held to the CPU on its first
# HEADS_CPU_N series (series are independent; a full-size CPU ssm pass
# would hold GBs of (N, chunks, heads, 32, 32) tensors on the host);
# HEADS_STEPS dense train steps per head on the train cell, esn also
# HEADS_BF16_STEPS under bf16; head_compare's fast cell per head, its OWA
# held to HEADS_OWA_FACTOR times the reference's (BENCH_PR10.json
# head_compare, JAX on the CPU); the CLI at data_scale=1.0, HEADS_CLI_STEPS
# steps with eval and checkpoints every HEADS_CLI_EVERY, resumed from there
HEADS = ("esn", "ssm")
HEADS_CPU_N = 2048
HEADS_STEPS, HEADS_BF16_STEPS = 5, 3
HEADS_OWA_REFERENCE, HEADS_OWA_FACTOR = {"esn": 0.780, "ssm": 0.769}, 1.01
HEADS_CLI_STEPS, HEADS_CLI_EVERY = 10, 5

# the chunked cell (the out-of-core fit, the quarterly preset at full width).
# (a) exactness at M4's quarterly count: the train cell's 24,000 series of
# length 72, batch 256, chunks of 2,048 (12 chunks, the last 1,472 rows), 24
# steps in supersteps of 4, eval every 12. Schedule seed 1 visits chunks 8,
# 11 (the ragged tail, 6 steps), 4 and 7; the eval at 12 and the resume at 12
# land inside the tail's visit (the schedule is checked, not assumed). The
# bf16 and esn runs take the first 12 steps.
CHUNK_ROWS, CHUNK_STEPS, CHUNK_SCAN, CHUNK_EVERY, CHUNK_SEED = 2048, 24, 4, 12, 1
CHUNK_SHORT = 12
# (b) scale: the reference's 1M-series gate (scripts/million_series_smoke.py)
# at the preset's width and T = 72: chunks of 65,536, batch 8,192, supersteps
# of 8, 32 steps (4 visits of 8), the streamed val over all series at the end
# and a streamed predict; the same fit on the first 250,000 series for the
# device-memory check (the two peaks within CHUNK_MEM_TOL), and a fit of 16
# steps under the profiler for the copies' overlap with the compute stream
SCALE_N, SCALE_SMALL_N, SCALE_CHUNK, SCALE_BATCH, SCALE_SCAN, SCALE_STEPS = (
    1_000_000, 250_000, 65_536, 8_192, 8, 32)
SCALE_PROFILE_STEPS, CHUNK_MEM_TOL = 16, 0.05
# the reference's peak_memory cell (benchmarks/memory_footprint.py --fast):
# N = 8,192, chunks of 1,024, batch 256, 12 steps in supersteps of 4, hidden
# 8, T = 24, live device bytes sampled at every superstep boundary; its
# chunked/resident ratio (BENCH_PR10.json peak_memory, JAX on the CPU)
REF_MEM_N, REF_MEM_CHUNK, REF_MEM_BATCH, REF_MEM_STEPS, REF_MEM_HIDDEN = 8192, 1024, 256, 12, 8
REF_MEM_RATIO = 0.175
# (b') the reference's own 1M gate (scripts/million_series_smoke.py:37-45,
# :52-59): esrnn-quarterly at hidden 8, T = 24, the scale cell's chunks,
# batch, supersteps and steps, sparse Adam, then a predict of 1M x 8, in a
# fresh process: fit + predict within 900 s and peak host RSS within 4,096 MB
MILLION_HIDDEN, MILLION_T, MILLION_WALL_S, MILLION_RSS_MB = 8, 24, 900.0, 4096.0
RSS_SAMPLE_S = 0.005

# the dp cell: the train cell (24,000 series of length 72, batch 256) on two
# gloo ranks sharing the card, 12 steps with eval every 6: dense and sparse
# (supersteps of 4) in fp32 and bf16, an esn fit, the chunked fit in chunks
# of 2,048; the forecast cell's predict, backtest and eval and the serve
# cell's requests; the CLI's fit at data_scale 0.1 for 6 steps
DP_RANKS, DP_STEPS, DP_EVERY = 2, 12, 6
DP_FITS = {
    "dense": ({}, {}),
    "sparse": ({}, dict(sparse_adam=True, scan_steps=4)),
    "dense_bf16": (dict(precision="bf16"), {}),
    "sparse_bf16": (dict(precision="bf16"), dict(sparse_adam=True, scan_steps=4)),
    "esn": (dict(head="esn"), {}),
    "chunked": ({}, dict(series_chunk=CHUNK_ROWS, scan_steps=4)),
}
DP_ORIGINS = (40, 56, 72)
DP_CLI_STEPS, DP_CLI_SETS = 6, ("data_scale=0.1",)
# sharded against one device on the card, the same kernels on both sides:
# losses within the CPU tests' fit bounds (tests/test_torch_dp.py FIT_RTOL,
# and BF16_RTOL in bf16: only the order of fp32 sums differs); inference
# within 1e-6 relative (rows are computed alone; only the metric sums change
# order)
DP_FIT_RTOL, DP_FIT16_RTOL, DP_INFER_RTOL = 1e-5, 1e-3, 1e-6

# tolerances, with their reasons:
# K1 runs the plain version's operations in the same order with IEEE
# rounding, so only a contracted multiply-add could differ: rtol 1e-5.
K1_RTOL = 1e-5
# K3 sums the gate dots in another order than the plain matmul: atol 1e-5.
K3_ATOL = 1e-5
# the whole forecast, card against CPU (sums in other orders, through exp)
FC_RTOL, FC_ATOL = 1e-4, 1e-5
# bf16: K1 with a bf16 y gives the plain version's bits (y_t widened
# exactly, then the fp32 walk); K3 in bf16 rounds h' and c' once from float32
# sums taken in another order than the plain matmul, so at most 1 bf16 ulp
# apart, or, where an output is so near zero that float32's sum-order error
# spans more than one bf16 ulp, within K3's fp32 atol
K3_BF16_ULPS = 1
# the bf16 forecast and server, card against CPU: a 1-ulp bf16 difference
# (2**-8 relative) carried through 229 cell steps and the exp, the bound the
# CPU tests hold the port to against the JAX package; and the bf16 forecast
# against the card's fp32 one: tests/core/test_precision.py's rtol 0.05
FC16_RTOL, FC16_ATOL = 2e-2, 1e-3
FC16_VS_FP32_RTOL, FC16_VS_FP32_ATOL = 0.05, 1e-3
# K2 runs the plain adjoint's operations in the same order, IEEE rounding:
# rtol 1e-5; atol 1e-6 for cotangents that cancel to near zero.
K2_RTOL, K2_ATOL = 1e-5, 1e-6
# K4 as K3. K5's dx, dh_prev, dc_prev sum 4H terms in another order than
# the plain matmuls: atol 1e-5; its weight gradients sum B rows: atol
# 1e-5 * sqrt(B). K5's weight gradients must be bit-identical across runs.
K45_ATOL = 1e-5
# bf16 training streams: K2 with a bf16 y gives the plain version's bits (y_t
# widened exactly, the fp32 walk, dy rounded once); K4 and K5 in bf16 round
# h', c', act and dx, dh_prev, dc_prev once from float32 sums taken in
# another order than the plain matmuls, so they are held as K3 in bf16: 1
# bf16 ulp, or K45_ATOL near zero; K5's float32 weight gradients, before
# their rounding, as the fp32 K5's (K45_ATOL * sqrt(B), the same bits on two
# launches). Training under bf16, card against CPU: the bf16 serving bound
# FC16_RTOL on per-step losses and val sMAPE; against the card's fp32 run,
# the reference's own bf16-vs-fp32 bound (tests/core/test_precision.py).
TRAIN16_RTOL, TRAIN16_VS_FP32_RTOL = FC16_RTOL, 0.05
# train losses, card against CPU. The first loss differs only by summation
# order (~1e-7 relative). Adam's steps are sign-like (about lr * sign(g)
# per weight), so a gradient component that sits at rounding level can get
# the opposite step on the two devices; its gradient is ~0, so the loss
# moves only at second order, and 10 steps stay well inside rtol 1e-4.
TRAIN_RTOL = 1e-4

# K6 in fp32: the JAX kernel test's rtol = atol = 2e-5 (sums in another
# order). K6 in bf16, against the plain version in fp32 on the same bf16
# inputs: rtol = atol = 1e-2, for the output's rounding to bf16 (half an
# ulp, 2**-9 relative) and the probabilities rounded to bf16 before the
# product with V, as the JAX kernel does (its test allows 0.05).
K6_F32_TOL, K6_BF16_TOL = 2e-5, 1e-2
# the LM card-vs-CPU parity (fp32, TF32 off): the forecast's rtol 1e-4, and
# atol 5e-5 instead of its 1e-5. The logits sum 4096- and 11008-wide
# products through two layers, in another order on each device: each
# device's prefill logits (up to |5.7|) sit 0.9e-5 (CPU) and 1.4e-5 (card)
# from a prefill with float64 products, and 1.5e-5 from each other (on an
# H100 80GB HBM3 at 700 W); the phase checks both against float64 as well
LM_RTOL, LM_ATOL = 1e-4, 5e-5

# the LM serve cell: yi-6b (the JAX serve launcher's own example), bf16, at
# full width and depth; batch and prompt cut from the reference's
# prefill_32k cell (32 x 32,768) to one card and a smoke run's time
LM_ARCH = "yi-6b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
# the LM parity cell: full width, depth cut to 2 layers for the CPU's sake
LM_PARITY_LAYERS, LM_PARITY_BATCH, LM_PARITY_PROMPT, LM_PARITY_GEN = 2, 2, 128, 8
# the MoE cells: qwen3-moe-30b-a3b (128 experts top-8, GQA 32/4 with
# QK-norm) served at full width (depth: ``SERVE_DEPTH``) in bf16 with the
# LM serve cell's batch, prompt and tokens; its parity cell at full width,
# 2 layers, fp32, with LM parity's batch, prompt and steps;
# deepseek-v2-lite's MoE layer (64 routed top-6 + 2 shared) alone
MOE_ARCH, MOE_DEEPSEEK = "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"
MOE_PARITY_LAYERS = 2
# the vlm, ssm and hybrid cells: internvl2-2b (256 image patches before the
# prompt), mamba2-1.3b and zamba2-2.7b served at full width (the latter
# two cut in depth: ``SERVE_DEPTH``) in bf16 with the LM serve cell's
# batch, prompt and tokens; their parity cells at full width, fp32, 2
# layers (zamba2: 12, two groups of 6, so that two applications of the
# shared block fill two KV caches), with LM parity's batch and steps;
# mamba2's also at a prompt that is not a multiple of its SSD chunk (128),
# so the scan pads
VLM_ARCH, SSM_ARCH, HYBRID_ARCH = "internvl2-2b", "mamba2-1.3b", "zamba2-2.7b"
# serve cells cut in depth to keep the script inside its time limit: qwen3-moe
# (48 layers), mamba2 (48 blocks), zamba2 (54; 2 shared-block applications at
# 12), granite-3-2b (40), chatglm3-6b (28) and qwen2.5-14b (48) at 12, since
# the sharded training phases (at 24 the whole script took 1,092-1,174 s on
# an H100 80GB HBM3 at 700 W); PERF.md keeps their full-depth serving numbers
SERVE_DEPTH = {"qwen3-moe-30b-a3b": 12, "mamba2-1.3b": 12, "zamba2-2.7b": 12,
               "granite-3-2b": 12, "chatglm3-6b": 12, "qwen2.5-14b": 12}
HYBRID_PARITY_LAYERS = 12
SSM_RAGGED_PROMPT = 200
# the encdec cells: whisper-base (6 + 6 layers, d 512, MHA 8 x 64, 1,500
# synthetic frames: the conv stub's output) served at full width and depth
# in bf16 with the LM serve cell's batch, prompt and tokens; its parity cell
# at full width and full depth (the model is small), fp32, with LM parity's
# batch, prompt and steps
ENCDEC_ARCH = "whisper-base"
# the dense presets not served before: granite-3-2b (D 64 at scale 2**-7,
# its multipliers), chatglm3-6b (2 KV heads for 32, half-dim RoPE) and
# qwen2.5-14b (48 x 5,120, qkv biases, 29.5 GB in bf16); parity at full
# width, 2 layers, fp32, serving at full width and depth in bf16, both with
# the LM cells' batch, prompt and tokens
DENSE_PRESETS = ("granite-3-2b", "chatglm3-6b", "qwen2.5-14b")
# the LM train cells: the seven models of the six families. Parity
# (``lm_train_parity``): full width in fp32 at ``run_parity``'s depths (2
# layers; deepseek its dense prefix layer and one MoE layer; zamba2 12
# blocks, two shared-block applications; whisper its 6 + 6), batch 2 x 128
# text tokens (internvl2's 256 patches before them, whisper's 1,500
# frames), card against CPU. The train cell (``lm_train``): seq 2,048
# (internvl2 1,792 tokens after its 256 patches; whisper 2,048 tokens over
# 1,500 frames), global batch 8 in microbatches of 2, fp32 masters, bf16
# compute, AdamConfig(lr=3e-4, clip_norm=1.0), 1 warm-up and 3 timed steps
# through ``launch.train.train``; qwen3-moe at 4 layers and deepseek-v2-lite
# at its prefix layer + 3 (their fp32 masters, gradients and Adam moments
# at full depth, 550 and 292 GB, are past one card); since the sharded
# training phases, granite-3-2b at 10 of 40 layers, internvl2-2b at 6 of 24,
# mamba2-1.3b at 12 of 48 and zamba2-2.7b at 12 of 54, for the script's
# time limit (the whole script took 1,092 s with them at full depth on an
# H100 80GB HBM3 at 700 W; PERF.md keeps their full-depth numbers); whisper
# at full depth
TRAIN_ARCHS = ("granite-3-2b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "internvl2-2b",
               "mamba2-1.3b", "zamba2-2.7b", "whisper-base")
TRAIN_PARITY_LAYERS = {"zamba2-2.7b": HYBRID_PARITY_LAYERS, "whisper-base": None}
TRAIN_PARITY_TEXT = 128
# the parity's bf16 train step at 2 x 32 text tokens: the card's host has
# no bf16 matrix unit, and its bf16 products run ~5x slower than fp32 ones
# (2 x 128 tokens took 8-45 s a model on the CPU)
TRAIN16_PARITY_TEXT = 32
# ... card against CPU for granite-3-2b, mamba2-1.3b and whisper-base; the
# others' CPU step (Adam over 0.5-1.9 B fp32 params, the vlm's 256 patches:
# 16-31 s each) the script's time limit cannot hold, so every model's card
# step is held to the plain version of the step on the card
TRAIN16_CARD_ONLY = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "internvl2-2b",
                     "zamba2-2.7b")
# ... with an Adam whose eps is far above every |gradient| and no clip: its
# first step is -lr g / (|g| + eps), here about -0.1 x the mean gradient, so
# the update carries the microbatches' sum, the division by their count,
# the cast and the sign, stands well above the fp32 spacing of the weights
# it moves, and lifts the largest gradients' moves past the params' atol
# (the launcher's Adam moves each weight by about lr x sign(g) whatever the
# gradient's scale, under the bf16 atol at lr 3e-4; at -1 x the gradient,
# one bf16 gradient element's spread, card against CPU, passed that atol)
TRAIN16_STEP_ADAM = dict(lr=1e2, eps=1e3)
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_MICRO = 2048, 8, 2
LM_TRAIN_WARMUP, LM_TRAIN_TIMED = 1, 3
TRAIN_DEPTH = {"qwen3-moe-30b-a3b": 4, "deepseek-v2-lite-16b": 4, "granite-3-2b": 10,
               "internvl2-2b": 6, "mamba2-1.3b": 12, "zamba2-2.7b": 12}
# why each is cut
TRAIN_CUT_WHY = {"qwen3-moe-30b-a3b": "the full model's training state is past one card",
                 "deepseek-v2-lite-16b": "the full model's training state is past one card"}
TRAIN_RESUME_ARCH, TRAIN_PROFILE_ARCH = "whisper-base", "granite-3-2b"
# gradients card against CPU: each leaf within 1e-4 of its largest element
# on the CPU (fp32 sums in another order through 2 to 12 layers); the bf16
# train step within the repo's bf16 bound, and each leaf's update within
# that rtol as a share of its norm
GRAD_TOL = 1e-4
TRAIN16_STEP_RTOL, TRAIN16_STEP_ATOL = 2e-2, 1e-3

# the sharded training cells: 4 gloo ranks sharing the card, a (2, 2) host
# mesh (FSDP on data, heads, hidden units and the MoE experts on model).
# Parity (``lm_train_tp_parity``): one arch of each family at full width in
# fp32 at the train parity's depths and batch (2 x 128 text tokens: one row
# a data rank), one step's loss and gradients against the one-device card
# step on the same weights and rows, remat off (the collectives of
# ``fsdp.step_collectives``); the MoE family by deepseek-v2-lite (MLA, the
# shared experts), qwen3-moe left out: its 9.9 s step was the slowest of the
# seven in the phases' 150 s (the CPU tests hold all ten); zamba2 at 6
# blocks, one application of its shared block (12 took 8.1-10.3 s). The
# train cell (``lm_train_tp``): yi-6b (its 64,000-entry vocabulary is cut at tp 2) at
# full width, cut to 2 layers (4 took 10.2 s a step, past the phases'
# share), seq 512, global batch 4 in 2 microbatches, bf16 compute over fp32
# masters, 1 warm-up and 2 timed steps through the train launcher's
# ``train_on_mesh`` with the collectives timed, its losses against the
# one-device bf16 run of the same weights within the repo's bf16 bound
TRAIN_TP_MESH = (2, 2)
TRAIN_TP_ARCHS = ("yi-6b", "deepseek-v2-lite-16b", "internvl2-2b", "mamba2-1.3b",
                  "zamba2-2.7b", "whisper-base")
TRAIN_TP_PARITY_LAYERS = {"zamba2-2.7b": 6, "whisper-base": None}
TRAIN_TP_ARCH, TRAIN_TP_LAYERS = "yi-6b", 2
TRAIN_TP_SEQ, TRAIN_TP_BATCH, TRAIN_TP_MICRO = 512, 4, 2
TRAIN_TP_WARMUP, TRAIN_TP_TIMED = 1, 2
# the examples phase: each Torch example once on the card, in a process of
# its own, with these arguments (quickstart's fit at 40 of its 80 steps,
# forecast_m4 at one frequency and 25 steps: the phases' time)
EXAMPLES = (("quickstart_torch.py", ("--steps", "40")),
            ("forecast_m4_torch.py", ("--freq", "quarterly", "--steps", "25")),
            ("serve_decode_torch.py", ()))

# the tensor-parallel cells: 2 gloo ranks sharing the card, a (1, 2) host
# mesh. Parity (``lm_tp_parity``): every arch at full width in fp32 at
# ``run_parity``'s depths (2 layers; zamba2 12 blocks; whisper 6 + 6) and
# inputs, against the one-device card run of the same weights on rank 0, at
# the LM bounds; all ten in one spawn. Serving (``lm_tp_serve``): yi-6b at
# full width and depth in bf16, batch 2 x prompt 512 + 8 tokens (its
# prefill's partial sums cross the host through gloo twice a layer, so the
# cell is cut from the LM serve cell's 8 x 2048), against the one-device
# bf16 serve of the same inputs within the bf16 bound
TP_SIZE = 2
TP_PARITY_LAYERS = {"zamba2-2.7b": HYBRID_PARITY_LAYERS, "whisper-base": None}
TP_SERVE_ARCH, TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_SERVE_GEN = "yi-6b", 2, 512, 8
# the bf16 bound, reported for the tp logits against the one-device serve's;
# at full depth the one-device bf16 serve is as far from its own fp32 model
# (77 x that bound, on an H100 80GB HBM3 at 700 W), so the phase holds the tp
# logits to the fp32 model: their RMS error at most TP16_RMS_GATE x the
# one-device bf16 serve's (two roundings of one model, in another order)
TP16_RTOL, TP16_ATOL = 2e-2, 1e-3
TP16_RMS_GATE = 1.1
TP_COLLECTIVE_STEPS = 3     # decode steps whose collectives are timed

# phase analyze: the CLI's audits at full width, by part: (name, spec, --set)
ANALYZE_RUNS = (("lstm", "esrnn-quarterly", ()), ("bf16", "esrnn-quarterly", ("precision=bf16",)),
                ("esn", "esn-quarterly", ()), ("ssm", "ssm-quarterly", ()),
                ("chunked", "esrnn-quarterly", ("series_chunk=2048",)))
ANALYZE_COST_STEPS = 10   # train steps a turn when the recorders' cost is timed
ANALYZE_DISPATCH_REPS = 30   # dispatches a turn when the serving counter's cost is timed

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 CUDA-core flop/s and
# dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's wall seconds
    so far (``wall_s``)."""
    if "phase" in obj:
        obj = dict(obj, wall_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_CAPTURE_STREAM = []


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the kernels run back to back and
    the host's launch path stays out of the reading.

    Every capture runs on one side stream: cuBLAS keeps a 32 MiB workspace
    for each stream it has run on, so a fresh stream per timing would leave
    one behind each time (and inflate the train phase's peak memory).
    """
    import torch

    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up off the default stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def wrapper_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Time per call of ``iters`` calls issued from the host (CUDA events
    around the loop): the wrapper's host path where it is longer than the
    kernel, as in a train step's chain of small launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float, peak_flops: float = FP32_FLOPS):
    """Least time on the card: the larger of the byte and the flop term."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(report: str):
    """The lines of an ``nvcc -Xptxas -v`` report that name an entry
    function, its registers, shared memory and spills, or a warning (such
    as wgmma serialised or setmaxnreg ignored)."""
    keep = ("Compiling entry", "Used", "spill", "arning", "Potential")
    return [line.split(":", 1)[-1].strip() for line in report.splitlines()
            if any(k in line for k in keep)]


def max_rel(a, b) -> float:
    return float(((a - b).abs() / b.abs()).max())


def check_close(name, got, want, *, rtol, atol) -> float:
    import torch

    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name}: max abs err {err} outside rtol {rtol}, atol {atol}")
    return float((got - want).abs().max())


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version, on the card
# ---------------------------------------------------------------------------


def _layers(cfg):
    """(dilation, input width) of each LSTM layer, in order."""
    layers, width = [], cfg.input_size + cfg.n_categories
    for block in cfg.dilations:
        for d in block:
            layers.append((d, width))
            width = cfg.hidden_size
    return layers


# widths past the presets', which every kernel must also take: K3/K4 at
# (rows, I, H) with the weights in k-chunks (H = 128, 256) and in unit
# slices (H = 1,030); K5 at the same and H = 64; K1/K2 at (N, T, m) with the
# ring beside the staged tiles in shared memory (m = 168 in K1), in opted-in
# shared memory (m = 400; m = 168 in K2) and in device memory (m = 2,000)
WIDE_CELL = [(rows, hid, hid) for hid in (128, 256, 1030) for rows in (1, 333)]
WIDE_BWD = [(256, 64, 64), (256, 128, 128), (256, 256, 256), (33, 1030, 1030)]
WIDE_RING = [(300, 208, 168), (130, 440, 400), (64, 2040, 2000)]


def main_path_shapes(cfg):
    """The shapes the forecast and serve phases hand each kernel.

    K1 gets (series, length, m): the forecast batch and every serve bucket.
    K3 gets (rows, input width): each layer of dilation d folds d chains into
    the batch, so rows = batch * d, for the forecast batch and every batch
    bucket.
    """
    m, layers = max(cfg.seasonality, 1), _layers(cfg)
    k1 = [(N_SERIES, T_LEN, m)] + [(bb, t, m) for bb in BATCH_BUCKETS
                                   for t in LENGTH_BUCKETS]
    k3 = list(dict.fromkeys((n * d, i) for n in (N_SERIES,) + BATCH_BUCKETS
                            for d, i in layers))
    return k1, k3


def _hw_inputs(n, t_len, m, gen, dev):
    import torch

    y = (torch.rand((n, t_len), generator=gen) * 400 + 50).to(dev)
    alpha = torch.rand(n, generator=gen).to(dev)
    if m > 1:
        gamma = torch.rand(n, generator=gen).to(dev)
        init_seas = (torch.rand((n, m), generator=gen) + 0.5).to(dev)
    else:   # the m == 1 convention of kernels/ops.py: flat ring, gamma 0
        gamma = torch.zeros(n, device=dev)
        init_seas = torch.ones((n, 1), device=dev)
    return y, alpha, gamma, init_seas


def _cell_inputs(rows, in_size, hidden, gen, dev):
    import torch

    u = lambda *shape: (torch.rand(shape, generator=gen) * 2 - 1).to(dev)
    wx = u(in_size, 4 * hidden) / in_size ** 0.5
    wh = u(hidden, 4 * hidden) / hidden ** 0.5
    b = u(4 * hidden) * 0.1
    return wx, wh, b, u(rows, in_size), u(rows, hidden), u(rows, hidden) * 2


def check_hw_scan(n, t_len, m, gen, timed=True, bf16=False):
    """K1 against its plain version; ``timed=False`` skips the plain
    version's timing (a loop of T small launches at the wide rings);
    ``bf16`` streams y in bf16 (record ``hw_scan_bf16``), where the outputs
    must be the plain version's bits."""
    import torch

    from repro_torch.kernels import hw_scan, ref

    y, alpha, gamma, init_seas = _hw_inputs(n, t_len, m, gen, torch.device("cuda"))
    if bf16:
        y = y.to(torch.bfloat16)
    y_tm, s_tm = y.t().contiguous(), init_seas.t().contiguous()
    kernel = lambda: hw_scan.hw_scan_tm(y_tm, alpha, gamma, s_tm)
    plain = lambda: ref.hw_scan_ref(y, alpha, gamma, init_seas)
    lev_k, seas_k = kernel()
    torch.cuda.synchronize()
    lev_p, seas_p = plain()
    err = max(check_close("hw_scan levels", lev_k.t(), lev_p, rtol=K1_RTOL, atol=0.0),
              check_close("hw_scan seas", seas_k.t(), seas_p, rtol=K1_RTOL, atol=0.0))
    if bf16 and not (torch.equal(lev_k.t(), lev_p) and torch.equal(seas_k.t(), seas_p)):
        raise AssertionError(f"hw_scan_bf16 {(n, t_len, m)}: not the plain version's bits")
    rel = max(max_rel(lev_k.t(), lev_p), max_rel(seas_k.t(), seas_p))
    ms, host_ms = time_ms(kernel), wrapper_ms(kernel)
    plain_ms = time_ms(plain, iters=5) if timed else None
    # y in, alpha, gamma and the ring in, levels and seas out
    n_bytes = y.element_size() * n * t_len + 4 * n * (2 + m) + 4 * n * (t_len + t_len + m)
    n_flops = 8 * n * t_len
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(name="hw_scan_bf16" if bf16 else "hw_scan", shape=dict(N=n, T=t_len, m=m),
                plan=scan_plan_of([y_tm], n, t_len, m, "fwd"), max_abs_err=err,
                max_rel_err=rel, ms=ms, wrapper_ms=host_ms, plain_ms=plain_ms,
                library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def scan_plan_of(staged, n, t_len, m, direction):
    """K1's (``direction="fwd"``) or K2's (``"bwd"``) launch plan for this
    shape on this card (hw_scan.scan_plan) and the tensors the kernel
    stages, with the ring's place by name."""
    import torch

    from repro_torch.kernels import build, hw_scan

    lim = build.device_limits(torch.device("cuda"))
    streams = hw_scan.FWD_STREAMS if direction == "fwd" else hw_scan.BWD_STREAMS
    plan = hw_scan.scan_plan(n, t_len, m, lim.smem_optin, lim.sm_count, streams,
                             all(t.data_ptr() % 16 == 0 for t in staged),
                             staged[0].element_size())
    return dict(plan._asdict(), ring=hw_scan.RING_PLACES[plan.ring])


def check_lstm_cell(rows, in_size, hidden, gen, bf16=False):
    """K3 against its plain version; ``bf16``: every input in bf16 (record
    ``lstm_cell_bf16``), held to K3_BF16_ULPS, its bound taken at the
    card's bf16 rate."""
    import torch

    from repro_torch.kernels import lstm_cell, ref

    wx, wh, b, x, h, c = _cell_inputs(rows, in_size, hidden, gen, torch.device("cuda"))
    if bf16:
        wx, wh, b, x, h, c = (t.to(torch.bfloat16) for t in (wx, wh, b, x, h, c))
    kernel = lambda: lstm_cell.lstm_cell(wx, wh, b, x, h, c)
    plain = lambda: ref.lstm_cell_ref(wx, wh, b, x, h, c)
    # one PyTorch call computing the same function (timed only, never used by
    # the port): torch.lstm_cell takes the weights transposed, two biases
    w_ih, w_hh, zero_b = wx.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
    library = lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, b, zero_b)
    h_k, c_k = kernel()
    torch.cuda.synchronize()
    h_p, c_p = plain()
    if bf16:
        err, ulp_stats = check_bf16(f"lstm_cell_bf16 {(rows, in_size, hidden)}",
                                    ((h_k, h_p), (c_k, c_p)), K3_ATOL)
    else:
        err = max(check_close("lstm_cell h", h_k, h_p, rtol=0.0, atol=K3_ATOL),
                  check_close("lstm_cell c", c_k, c_p, rtol=0.0, atol=K3_ATOL))
        h_l, c_l = library()
        check_close("torch.lstm_cell h", h_l, h_p, rtol=0.0, atol=K3_ATOL)
    ms, plain_ms, library_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    host_ms = wrapper_ms(kernel)
    g4 = 4 * hidden
    n_bytes = x.element_size() * (rows * in_size + 4 * rows * hidden
                                  + (in_size + hidden) * g4 + g4)
    n_flops = 2 * rows * (in_size + hidden) * g4
    bound_ms, bound_by = bound(n_bytes, n_flops, BF16_FLOPS if bf16 else FP32_FLOPS)
    rec = dict(name="lstm_cell_bf16" if bf16 else "lstm_cell",
               shape=dict(B=rows, I=in_size, H=hidden),
               **cell_launch_of((wx, wh, b, x, h, c), act=False), max_abs_err=err, ms=ms,
               wrapper_ms=host_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if bf16:
        rec.update(ulp_stats)
    return rec


def check_bf16(what, pairs, atol):
    """bf16 (kernel, plain) output pairs within K3_BF16_ULPS bf16 ulp, or
    within ``atol`` where an output is so near zero that float32's sum-order
    error spans more ulps. Returns the max abs error and how far the
    near-zero outputs went in ulps, and how many passed one."""
    from repro_torch.kernels import ref

    for got, want in pairs:
        if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against "
                                 f"{want.dtype} {tuple(want.shape)}")
    ulps = [ref.bf16_ulps(a, b) for a, b in pairs]
    diffs = [(a.float() - b.float()).abs() for a, b in pairs]
    past = sum(int(((u > K3_BF16_ULPS) & (d > atol)).sum()) for u, d in zip(ulps, diffs))
    if past:
        raise AssertionError(f"{what}: {past} outputs past {K3_BF16_ULPS} bf16 ulp and "
                             f"atol {atol}")
    over = [u > K3_BF16_ULPS for u in ulps]
    return max(float(d.max()) for d in diffs), dict(
        max_ulps=max(int(u.max()) for u in ulps),
        past_1_ulp=sum(int(o.sum()) for o in over),
        past_1_ulp_max_abs=max((float(d[o].max()) for d, o in zip(diffs, over) if o.any()),
                               default=0.0))


# registers a thread of each instantiation of the bf16 cell kernel on the
# tensor cores (csrc/lstm_cell_tc.cu), by its template arguments (WITH_ACT,
# quads a warp), from the ptxas report of the build (main fills it in)
TC_REGISTERS = {}


def cell_launch_of(args, act):
    """K3's (K4's with ``act``) C entry point and launch plan for these
    inputs on this card (lstm_cell.cell_launch), and the registers ptxas
    gave the tensor-core kernel where it runs."""
    from repro_torch.kernels import lstm_cell

    entry, plan = lstm_cell.cell_launch(*args, act=act)
    rec = dict(entry=entry, plan=plan._asdict())
    if isinstance(plan, lstm_cell.TcPlan):
        rec.update(kernel="lstm_cell_tc", registers=TC_REGISTERS.get((act, plan.quads)))
    return rec


# registers a thread of the bf16 K5 kernel on the tensor cores
# (csrc/lstm_cell_bwd_tc.cu), from the ptxas report of the build (main fills
# it in)
BWD_TC_REGISTERS = {}


def bwd_launch_of(args, outputs):
    """K5's C entry point and launch plan for these inputs and outputs on
    this card (lstm_cell.bwd_launch), and the registers ptxas gave the
    tensor-core kernel where it runs."""
    from repro_torch.kernels import lstm_cell

    entry, plan = lstm_cell.bwd_launch(*args, outputs=outputs)
    rec = dict(entry=entry, plan=dict(plan._asdict(), blocks=plan.blocks))
    if isinstance(plan, lstm_cell.BwdTcPlan):
        rec.update(kernel="lstm_cell_bwd_tc", registers=BWD_TC_REGISTERS.get("lstm_cell_bwd_tc"))
    return rec


def train_path_shapes(cfg, window: int):
    """The shapes the train and fine-tune phases hand K2, K4 and K5.

    K2 gets (series, length, m): the train batches at T = 72 and the
    fine-tune batch on the server's largest length bucket. K4 and K5 get
    (rows, input width) with rows = batch * d for each layer.
    """
    m, layers = max(cfg.seasonality, 1), _layers(cfg)
    batches = (TRAIN_BATCH, BIG_BATCH, FT_SERIES)
    k2 = [(TRAIN_BATCH, TRAIN_T, m), (BIG_BATCH, TRAIN_T, m), (FT_SERIES, window, m)]
    k45 = list(dict.fromkeys((b * d, i) for b in batches for d, i in layers))
    return k2, k45


def check_hw_scan_bwd(n, t_len, m, gen, timed=True, bf16=False):
    """K2 against the plain adjoint on the card. No single PyTorch call
    computes the adjoint of this recurrence (autograd of the plain scan is
    one small launch per operation per step), so ``library_ms`` is None.
    ``timed=False`` skips the plain version's timing; ``bf16`` streams y
    and dy in bf16 (record ``hw_scan_bwd_bf16``), where every output must be
    the plain version's bits."""
    import torch

    from repro_torch.kernels import hw_scan, ref

    dev = torch.device("cuda")
    y, alpha, gamma, init_seas = _hw_inputs(n, t_len, m, gen, dev)
    if bf16:
        y = y.to(torch.bfloat16)
    levels, seas = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    dlev = torch.randn((n, t_len), generator=gen).to(dev)
    dseas = torch.randn((n, t_len + m), generator=gen).to(dev)
    tm = lambda a: a.t().contiguous()
    args_tm = (tm(y), alpha, gamma, tm(levels), tm(seas), tm(dlev), tm(dseas))
    kernel = lambda: hw_scan.hw_scan_bwd_tm(*args_tm)
    plain = lambda: ref.hw_scan_bwd_ref(y, alpha, gamma, levels, seas, dlev, dseas)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    names = ("dy", "dalpha", "dgamma", "dinit_seas")
    err = max(check_close(f"hw_scan_bwd {name}", g.t() if g.dim() == 2 else g, w,
                          rtol=K2_RTOL, atol=K2_ATOL)
              for name, g, w in zip(names, got, want))
    if bf16 and not all(g.dtype == w.dtype and torch.equal(g.t() if g.dim() == 2 else g, w)
                        for g, w in zip(got, want)):
        raise AssertionError(f"hw_scan_bwd_bf16 {(n, t_len, m)}: not the plain version's bits")
    ms, host_ms = time_ms(kernel), wrapper_ms(kernel)
    plain_ms = time_ms(plain, iters=3, warmup=1) if timed else None
    # reads y, levels, dlev, seas (T N: the kernel reads seas rows 0..T-1
    # only), dseas ((T+m) N), alpha, gamma; writes dy (T N), dalpha, dgamma,
    # dinit (m N); 27 flops per (t, series). y and dy in y's element size
    n_bytes = (y.element_size() * 2 * n * t_len + 4 * n * (3 * t_len + (t_len + m) + 2)
               + 4 * n * (2 + m))
    n_flops = 27 * n * t_len
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(name="hw_scan_bwd_bf16" if bf16 else "hw_scan_bwd",
                shape=dict(N=n, T=t_len, m=m),
                plan=scan_plan_of([args_tm[i] for i in (0, 3, 4, 5, 6)], n, t_len, m, "bwd"),
                max_abs_err=err,
                ms=ms, wrapper_ms=host_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms,
                bound_by=bound_by)


def check_lstm_cell_fwd(rows, in_size, hidden, gen, bf16=False):
    """K4 against its plain version; ``torch.lstm_cell`` (timed only) as the
    library yardstick, though it writes no activations. ``bf16``: every
    input in bf16 (record ``lstm_cell_fwd_bf16``), h', c' and act held to
    K3_BF16_ULPS, the bound taken at the card's bf16 rate."""
    import torch

    from repro_torch.kernels import lstm_cell, ref

    dev = torch.device("cuda")
    wx, wh, b, x, h, c = _cell_inputs(rows, in_size, hidden, gen, dev)
    if bf16:
        wx, wh, b, x, h, c = (t.to(torch.bfloat16) for t in (wx, wh, b, x, h, c))
    kernel = lambda: lstm_cell.lstm_cell_fwd(wx, wh, b, x, h, c)
    plain = lambda: ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    w_ih, w_hh, zero_b = wx.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
    library = lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, b, zero_b)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    ulp_stats = {}
    if bf16:
        err, ulp_stats = check_bf16(f"lstm_cell_fwd_bf16 {(rows, in_size, hidden)}",
                                    list(zip(got, want)), K45_ATOL)
    else:
        err = max(check_close(f"lstm_cell_fwd {name}", g, w, rtol=0.0, atol=K45_ATOL)
                  for name, g, w in zip(("h", "c", "act"), got, want))
    ms, plain_ms, library_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    host_ms = wrapper_ms(kernel)
    g4 = 4 * hidden
    n_bytes = x.element_size() * (rows * in_size + 4 * rows * hidden + rows * g4
                                  + (in_size + hidden) * g4 + g4)
    n_flops = 2 * rows * (in_size + hidden) * g4
    bound_ms, bound_by = bound(n_bytes, n_flops, BF16_FLOPS if bf16 else FP32_FLOPS)
    return dict(name="lstm_cell_fwd_bf16" if bf16 else "lstm_cell_fwd",
                shape=dict(B=rows, I=in_size, H=hidden),
                **cell_launch_of((wx, wh, b, x, h, c), act=True), max_abs_err=err, ms=ms,
                wrapper_ms=host_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, **ulp_stats)


def check_lstm_cell_bwd(rows, in_size, hidden, gen, bf16=False):
    """K5 against its plain version, and bit-identical weight gradients
    across two launches. No single PyTorch call computes a cell's backward
    with its weight gradients (autograd of ``torch.lstm_cell`` is a fused
    elementwise backward plus separate cuBLAS products), so ``library_ms``
    is None. ``bf16``: every input in bf16 (record ``lstm_cell_bwd_bf16``),
    dx, dh_prev and dc_prev held to K3_BF16_ULPS, the float32 weight
    gradients, before their rounding, as the fp32 kernel's."""
    import torch

    from repro_torch.kernels import lstm_cell, ref

    dev = torch.device("cuda")
    wx, wh, b, x, h, c = _cell_inputs(rows, in_size, hidden, gen, dev)
    dh = torch.randn((rows, hidden), generator=gen).to(dev)
    dc = torch.randn((rows, hidden), generator=gen).to(dev)
    if bf16:
        wx, wh, b, x, h, c, dh, dc = (t.to(torch.bfloat16)
                                      for t in (wx, wh, b, x, h, c, dh, dc))
    _, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    args = (wx, wh, x, h, c, c_new, act, dh, dc)
    kernel = lambda: lstm_cell.lstm_cell_bwd(*args)
    plain = lambda: ref.lstm_cell_bwd_ref(*args)
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    for name, g1, g2 in zip(("dwx", "dwh", "db"), got[3:], again[3:]):
        if not torch.equal(g1, g2):
            raise AssertionError(f"lstm_cell_bwd {name}: two launches differ")
    want = plain()
    names = ("dx", "dh_prev", "dc_prev", "dwx", "dwh", "db")
    ulp_stats = {}
    if bf16:
        err, ulp_stats = check_bf16(f"lstm_cell_bwd_bf16 {(rows, in_size, hidden)}",
                                    list(zip(got[:3], want[:3])), K45_ATOL)
    else:
        err = max(check_close(f"lstm_cell_bwd {name}", g, w, rtol=0.0, atol=K45_ATOL)
                  for name, g, w in zip(names[:3], got[:3], want[:3]))
    # the weight gradients, float32 sums over B rows in either dtype
    err = max([err] + [check_close(f"lstm_cell_bwd {name}", g, w, rtol=0.0,
                                   atol=K45_ATOL * max(1.0, rows ** 0.5))
                       for name, g, w in zip(names[3:], got[3:], want[3:])])
    ms, plain_ms, host_ms = time_ms(kernel), time_ms(plain), wrapper_ms(kernel)
    g4, kw = 4 * hidden, in_size + hidden
    e = x.element_size()
    # inputs in the stream dtype; dx, dh_prev, dc_prev in it, the weight
    # gradients float32
    n_bytes = (e * (kw * g4 + rows * in_size + 5 * rows * hidden + rows * g4)
               + e * (rows * in_size + 2 * rows * hidden) + 4 * (kw * g4 + g4))
    # dx + dh_prev and the weight gradients: two products over 4H x (I + H)
    # per row; db and the gate algebra (about 20 flops per row and unit)
    n_flops = 4 * rows * g4 * kw + rows * g4 + 20 * rows * hidden
    bound_ms, bound_by = bound(n_bytes, n_flops, BF16_FLOPS if bf16 else FP32_FLOPS)
    return dict(name="lstm_cell_bwd_bf16" if bf16 else "lstm_cell_bwd",
                shape=dict(B=rows, I=in_size, H=hidden),
                **bwd_launch_of(args, got[:3]), max_abs_err=err, deterministic=True, ms=ms,
                wrapper_ms=host_ms,
                plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by, **ulp_stats)


DX_REGISTERS = {}


def check_lstm_cell_bwd_dx(rows, in_size, hidden, gen, bf16=False):
    """K5's dx-only launch (the esn head's frozen reservoir: no weight
    gradients) against its plain version within K5's bounds (fp32 atol
    K45_ATOL; bf16 K3_BF16_ULPS or K45_ATOL), the same bits on two launches,
    and against the full K5's dx, dh_prev and dc_prev on the same inputs:
    bit for bit in fp32 and the bf16 split plan (the same row blocks, or the
    same per-row sums), within the bf16 bound past 512 rows in bf16 (the
    full launch's cluster plan), the record saying which. Timed beside the
    full K5 (``full_ms``); its bytes are the residuals, the weights and the
    three outputs (x and h are not read); ``registers``: ptxas's count for
    the dx-only kernel and the full one. No one PyTorch call gives a cell's
    input gradients alone: ``library_ms`` None."""
    import torch

    from repro_torch.kernels import lstm_cell, ref

    dev = torch.device("cuda")
    wx, wh, b, x, h, c = _cell_inputs(rows, in_size, hidden, gen, dev)
    dh = torch.randn((rows, hidden), generator=gen).to(dev)
    dc = torch.randn((rows, hidden), generator=gen).to(dev)
    if bf16:
        wx, wh, b, x, h, c, dh, dc = (t.to(torch.bfloat16)
                                      for t in (wx, wh, b, x, h, c, dh, dc))
    _, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    args = (wx, wh, c, c_new, act, dh, dc)
    full_args = (wx, wh, x, h, c, c_new, act, dh, dc)
    kernel = lambda: lstm_cell.lstm_cell_bwd_dx(*args)
    full = lambda: lstm_cell.lstm_cell_bwd(*full_args)
    plain = lambda: ref.lstm_cell_bwd_dx_ref(*args)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    names = ("dx", "dh_prev", "dc_prev")
    for name, g1, g2 in zip(names, got, again):
        if not torch.equal(g1, g2):
            raise AssertionError(f"lstm_cell_bwd_dx {name}: two launches differ")
    want = plain()
    what = f"lstm_cell_bwd_dx{'_bf16' if bf16 else ''} {(rows, in_size, hidden)}"
    ulp_stats = {}
    if bf16:
        err, ulp_stats = check_bf16(what, list(zip(got, want)), K45_ATOL)
    else:
        err = max(check_close(f"{what} {name}", g, w, rtol=0.0, atol=K45_ATOL)
                  for name, g, w in zip(names, got, want))
    entry, plan = lstm_cell.bwd_dx_launch(*args, outputs=got)
    full_out = full()[:3]
    equal_full = all(torch.equal(g, f) for g, f in zip(got, full_out))
    split = not (bf16 and isinstance(plan, lstm_cell.BwdTcPlan)
                 and rows > lstm_cell.BWD_TC_SPLIT_ROWS)
    if split and not equal_full:
        raise AssertionError(f"{what}: dx, dh_prev, dc_prev differ from the full K5's")
    vs_full = dict(bit_identical=equal_full,
                   held_to="bits" if split else "the bf16 bound (the full launch's cluster plan)")
    if not split:
        _, vs_full["ulps"] = check_bf16(f"{what} against the full K5", list(zip(got, full_out)),
                                        K45_ATOL)
    ms, full_ms = time_ms(kernel), time_ms(full)
    plain_ms, host_ms = time_ms(plain), wrapper_ms(kernel)
    g4, kw = 4 * hidden, in_size + hidden
    e = c.element_size()
    # wx, wh, act, c, c', dh, dc in; dx, dh_prev, dc_prev out
    n_bytes = e * (kw * g4 + rows * (g4 + 4 * hidden) + rows * (in_size + 2 * hidden))
    # dx + dh_prev: one product over 4H x (I + H) per row; the gate algebra
    n_flops = 2 * rows * g4 * kw + 20 * rows * hidden
    bound_ms, bound_by = bound(n_bytes, n_flops, BF16_FLOPS if bf16 else FP32_FLOPS)
    tc = isinstance(plan, lstm_cell.BwdTcPlan)
    stream = "tc" if tc else ("bf16" if bf16 else "f32")
    return dict(name="lstm_cell_bwd_dx_bf16" if bf16 else "lstm_cell_bwd_dx",
                shape=dict(B=rows, I=in_size, H=hidden), entry=entry,
                plan=dict(plan._asdict(), blocks=plan.blocks),
                registers=dict(dx_only=DX_REGISTERS.get(("dx", stream)),
                               full=DX_REGISTERS.get(("full", stream))),
                max_abs_err=err, deterministic=True, vs_full=vs_full, ms=ms, full_ms=full_ms,
                wrapper_ms=host_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, **ulp_stats)


def k6_shapes():
    """K6's checks: (B, Hq, Hkv, Tq, Tk, D, DV, dtype, causal). The first is
    the LM serve path's own (one launch per layer of the yi-6b prefill); the
    others cover fp32, ragged tiles, decode-append, non-causal, D = 64 and
    MHA; then MLA's (q . k 192, v 128): one layer of the deepseek-v2-lite
    serve prefill in bf16 and of its parity prefill in fp32; then zamba2's
    head dim 80 (one shared-block application of its serve prefill, ragged,
    non-causal; in fp32 one application of its parity prefill, and a ragged
    non-causal 300 x 500), and one layer of the internvl2-2b serve prefill
    (2,048 prompt positions after 256 image patches); then whisper-base's
    four uses at D = DV = 64 in its serve cell (bf16: the encoder's
    non-causal 1,500 x 1,500, the decoder's causal prompt, the
    cross-attention from the prompt and from one decode position over the
    1,500 frames) and its parity cell (fp32, batch 2, prompt 128); then one
    layer of each dense preset's serve prefill (granite-3-2b at D 64 and its
    scale 2**-7, the tuple's tenth entry; chatglm3-6b's 2 KV heads;
    qwen2.5-14b's 40 / 8)."""
    return [
        (LM_BATCH, 32, 4, LM_PROMPT, LM_PROMPT, 128, 128, "bfloat16", True),
        (2, 32, 4, LM_PROMPT, LM_PROMPT, 128, 128, "float32", True),
        (2, 32, 4, 1000, 1000, 128, 128, "bfloat16", True),
        (LM_BATCH, 32, 4, 33, 1024, 128, 128, "bfloat16", True),
        (LM_BATCH, 32, 4, 33, 1024, 128, 128, "float32", True),
        (2, 32, 4, 512, 1024, 128, 128, "bfloat16", False),
        (2, 16, 16, 1024, 1024, 64, 64, "bfloat16", True),
        (2, 16, 16, 300, 300, 64, 64, "float32", False),
        (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 192, 128, "bfloat16", True),
        (LM_PARITY_BATCH, 16, 16, LM_PARITY_PROMPT, LM_PARITY_PROMPT, 192, 128, "float32", True),
        (LM_BATCH, 32, 32, LM_PROMPT, LM_PROMPT, 80, 80, "bfloat16", True),
        (2, 32, 32, 1000, 1000, 80, 80, "bfloat16", True),
        (2, 32, 32, 512, 1024, 80, 80, "bfloat16", False),
        (LM_PARITY_BATCH, 32, 32, LM_PARITY_PROMPT, LM_PARITY_PROMPT, 80, 80, "float32", True),
        (2, 32, 32, 300, 500, 80, 80, "float32", False),
        (LM_BATCH, 16, 8, LM_PROMPT + 256, LM_PROMPT + 256, 128, 128, "bfloat16", True),
        (LM_BATCH, 8, 8, 1500, 1500, 64, 64, "bfloat16", False),
        (LM_BATCH, 8, 8, LM_PROMPT, LM_PROMPT, 64, 64, "bfloat16", True),
        (LM_BATCH, 8, 8, LM_PROMPT, 1500, 64, 64, "bfloat16", False),
        (LM_BATCH, 8, 8, 1, 1500, 64, 64, "bfloat16", False),
        (LM_PARITY_BATCH, 8, 8, 1500, 1500, 64, 64, "float32", False),
        (LM_PARITY_BATCH, 8, 8, LM_PARITY_PROMPT, LM_PARITY_PROMPT, 64, 64, "float32", True),
        (LM_PARITY_BATCH, 8, 8, LM_PARITY_PROMPT, 1500, 64, 64, "float32", False),
        (LM_PARITY_BATCH, 8, 8, 1, 1500, 64, 64, "float32", False),
        (LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 64, 64, "bfloat16", True, 2.0 ** -7),
        (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, 128, "bfloat16", True),
        (LM_BATCH, 40, 8, LM_PROMPT, LM_PROMPT, 128, 128, "bfloat16", True),
    ]


def k6_work(b, hq, hkv, tq, tk, d, dv, elem_bytes, causal):
    """Bytes K6 must move (q and k read once at D, v once and o written
    once at DV) and flops it must do: 2 (D + DV) per visible (query, key)
    pair (S = Q . K^T, then P . V), which the causal mask cuts to sum_i
    min(Tk, i + Tk - Tq + 1) pairs."""
    if causal:
        pairs = sum(min(tk, i + tk - tq + 1) for i in range(tq))
    else:
        pairs = tq * tk
    n_bytes = elem_bytes * (b * hq * tq * (d + dv) + b * hkv * tk * (d + dv))
    return n_bytes, 2.0 * b * hq * (d + dv) * pairs


def device_kernel_names(call):
    """The device kernels one ``call()`` runs, by device time, under
    torch.profiler (which backend a library call picked); empty where the
    profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = {}
    for evt in device_work(prof):
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.end - evt.time_range.start
    return [name[:90] for name, _ in sorted(by_name.items(), key=lambda kv: -kv[1])]


def check_flash_attention(gen, b, hq, hkv, tq, tk, d, dv, dtype_name, causal, scale=None,
                          qkv=None):
    """K6 against its plain version on the card at ``scale`` (None: 1/sqrt(D));
    SDPA (timed only) as the library yardstick, with an explicit end-aligned
    mask where Tq != Tk under the causal mask (its ``is_causal`` aligns the
    starts). Where DV != D, the record names the kernels SDPA ran
    (``library_kernels``: which backend it picked)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    if qkv is None:
        qkv = [torch.randn(shape, generator=gen).to(dev, dtype)
               for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, dv))]
    q, k, v = qkv
    kernel = lambda: flash_attention.flash_attention(q, k, v, causal=causal, scale=scale)
    plain = lambda: ref.attention_ref(q, k, v, causal=causal, scale=scale)
    mask = None
    if causal and tq != tk:
        mask = (torch.arange(tk, device=dev)[None, :]
                <= torch.arange(tq, device=dev)[:, None] + (tk - tq))
    library = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
        enable_gqa=True)
    got = kernel()
    torch.cuda.synchronize()
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal, scale=scale)
    tol = K6_F32_TOL if dtype == torch.float32 else K6_BF16_TOL
    err = check_close(f"flash_attention {tuple(q.shape)} x {tuple(k.shape)}", got, want,
                      rtol=tol, atol=tol)
    check_close("scaled_dot_product_attention", library(), want, rtol=tol, atol=tol)
    del want
    ms, host_ms, library_ms = time_ms(kernel), wrapper_ms(kernel), time_ms(library)
    plain_ms = time_ms(plain, iters=3, warmup=1)
    sdpa = dict(library_kernels=device_kernel_names(library)) if dv != d else {}
    n_bytes, n_flops = k6_work(b, hq, hkv, tq, tk, d, dv, q.element_size(), causal)
    bound_ms, bound_by = bound(n_bytes, n_flops,
                               FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
    return dict(name="flash_attention",
                kernel="flash_tc_bf16" if dtype == torch.bfloat16 else "flash_simt_f32",
                shape=dict(B=b, Hq=hq, Hkv=hkv, Tq=tq, Tk=tk, D=d, DV=dv, causal=causal),
                scale=d ** -0.5 if scale is None else scale, dtype=dtype_name,
                max_abs_err=err, tol=tol, ms=ms, wrapper_ms=host_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, tflops=n_flops / ms / 1e9, **sdpa)


def check_k6_on(launch, gen):
    """``check_flash_attention`` on one launch a model made: its own q, k, v,
    causal flag and scale (``LMServe.k6_launches``)."""
    import torch

    q, k, v, causal, scale = launch
    (b, hq, tq, d), (hkv, tk), dv = q.shape, k.shape[1:3], v.shape[3]
    with torch.no_grad():
        return check_flash_attention(gen, b, hq, hkv, tq, tk, d, dv,
                                     str(q.dtype).split(".")[-1], causal, scale, qkv=(q, k, v))


# ---------------------------------------------------------------------------
# phase 3: the forecast entry points at full quarterly width
# ---------------------------------------------------------------------------


def make_model(n_series: int, seed: int = 0, head: str = "lstm"):
    """Quarterly config of ``head`` and CPU params: random weights,
    per-series HW rows."""
    import torch

    from repro_torch.core.esrnn import esrnn_init, make_config
    from repro_torch.core.holt_winters import HWParams

    cfg = make_config("quarterly", head=head)
    params = esrnn_init(torch.Generator().manual_seed(seed), cfg, n_series,
                        device="cpu")
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    params["hw"] = HWParams(
        alpha_logit=f32(rng.normal(0.0, 1.0, n_series)),
        gamma_logit=f32(rng.normal(-1.0, 1.0, n_series)),
        init_seas_logit=f32(rng.normal(0.0, 0.1, (n_series, cfg.seasonality))))
    return cfg, params


def make_batch(cfg, n_series: int, t_len: int, seed: int = 1):
    """Positive seasonal series (N, T) and one-hot categories, from a seed."""
    rng = np.random.default_rng(seed)
    m = cfg.seasonality
    level = np.exp(rng.normal(5.0, 1.0, (n_series, 1))
                   + rng.normal(0.0, 0.02, (n_series, t_len)).cumsum(axis=1))
    seas = np.exp(rng.normal(0.0, 0.1, (n_series, m)))
    seas = np.tile(seas, (1, t_len // m + 1))[:, :t_len]
    y = level * seas * np.exp(rng.normal(0.0, 0.03, (n_series, t_len)))
    cats = np.eye(cfg.n_categories, dtype=np.float32)[
        rng.integers(0, cfg.n_categories, n_series)]
    return y.astype(np.float32), cats


def run_forecast(cfg, params_cpu, params_dev, y, cats, dev):
    """Card entry points vs the same forward pass on the CPU."""
    import torch

    from repro_torch.core import forward as F
    from repro_torch.core.esrnn import (
        esrnn_forecast, esrnn_forecast_at, esrnn_predict_stats,
    )

    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    calls = {
        "esrnn_forecast": lambda: esrnn_forecast(cfg, params_dev, y_d, c_d),
        "esrnn_predict_stats": lambda: esrnn_predict_stats(cfg, params_dev, y_d, c_d),
        "esrnn_forecast_at": lambda: esrnn_forecast_at(cfg, params_dev, y_d, c_d, ORIGINS),
    }
    outs, ms = {}, {}
    for name, call in calls.items():
        call()                                    # first call: allocator warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = call()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3

    # the CPU reference: one forward pass read three ways, exactly what the
    # three entry points compute (each runs its own pass on the card)
    t0 = time.perf_counter()
    with torch.no_grad():
        y_c, c_c = torch.from_numpy(y), torch.from_numpy(cats)
        states = F.esrnn_states(cfg, params_cpu, y_c, c_c)
        want_fc = F.forecast_from_states(cfg, states, y.shape[1])
        want_sigma = F.quantile_sigma(states, y_c)
        want_at = F.forecast_at_origins(cfg, states, ORIGINS, y.shape[1])
    cpu_s = time.perf_counter() - t0

    n, h = y.shape[0], cfg.output_size
    errs = {
        "esrnn_forecast": check_close("esrnn_forecast", outs["esrnn_forecast"],
                                      want_fc, rtol=FC_RTOL, atol=FC_ATOL),
        "esrnn_predict_stats": max(
            check_close("predict_stats fc", outs["esrnn_predict_stats"][0],
                        want_fc, rtol=FC_RTOL, atol=FC_ATOL),
            check_close("predict_stats sigma", outs["esrnn_predict_stats"][1],
                        want_sigma, rtol=FC_RTOL, atol=FC_ATOL)),
        "esrnn_forecast_at": check_close("esrnn_forecast_at", outs["esrnn_forecast_at"],
                                         want_at, rtol=FC_RTOL, atol=FC_ATOL),
    }
    if tuple(outs["esrnn_forecast"].shape) != (n, h):
        raise AssertionError(f"forecast shape {tuple(outs['esrnn_forecast'].shape)}")
    if tuple(outs["esrnn_forecast_at"].shape) != (n, len(ORIGINS), h):
        raise AssertionError("forecast_at shape")
    # the last origin is the end of the series: it must be the forecast
    check_close("forecast_at[-1] == forecast", outs["esrnn_forecast_at"][:, -1],
                outs["esrnn_forecast"], rtol=1e-6, atol=0.0)
    return dict(ms=ms, max_abs_err=errs, cpu_reference_s=cpu_s)


def forecast_steps(cfg, t_len: int) -> int:
    """LSTM-cell launches of one forward pass over T steps: each layer of
    dilation d walks ceil(P / d) steps over the P = T - W + 1 window
    positions."""
    positions = t_len - cfg.input_size + 1
    return sum(-(-positions // d) for block in cfg.dilations for d in block)


def run_forecast_bf16(cfg, params_cpu, params_dev, y, cats, dev, want_fp32):
    """One ``esrnn_forecast`` under the bf16 policy on the card (the caller
    has made a warm one), against the same call on the CPU and against the
    card's fp32 forecast ``want_fp32``."""
    import torch

    from repro_torch.core.esrnn import esrnn_forecast

    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = esrnn_forecast(cfg, params_dev, y_d, c_d)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = esrnn_forecast(cfg, params_cpu, torch.from_numpy(y), torch.from_numpy(cats))
    cpu_s = time.perf_counter() - t0
    if got.dtype != torch.float32 or tuple(got.shape) != (y.shape[0], cfg.output_size):
        raise AssertionError(f"bf16 forecast {got.dtype} {tuple(got.shape)}")
    err = check_close("forecast_bf16 vs the CPU", got, want, rtol=FC16_RTOL, atol=FC16_ATOL)
    err32 = check_close("forecast_bf16 vs the card's fp32 forecast", got, want_fp32,
                        rtol=FC16_VS_FP32_RTOL, atol=FC16_VS_FP32_ATOL)
    return dict(ms=ms, series_per_s=y.shape[0] / ms * 1e3, max_abs_err=err,
                max_abs_err_vs_fp32=err32, max_rel_err_vs_fp32=max_rel(got.cpu(), want_fp32.cpu()),
                cpu_reference_s=cpu_s)


def profile_forecast(cfg, params_dev, y, cats, dev, top: int = 8):
    """Where one ``esrnn_forecast`` call spends the card's time; K3's device
    ms under ``matched`` (fp32 ``lstm_cell_smem``, bf16 ``lstm_cell_tc``)."""
    import torch

    from repro_torch.core.esrnn import esrnn_forecast

    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    match = ({"lstm_cell_bf16": ("lstm_cell_tc<false",)} if cfg.precision == "bf16"
             else {"lstm_cell": ("lstm_cell_smem<false",)})
    return profile_call(lambda: esrnn_forecast(cfg, params_dev, y_d, c_d), top, match)


def device_work(prof, ranges=()):
    """The profile's device activities (kernels and copies), without the
    device-side spans of ``record_function`` ranges."""
    from torch.autograd import DeviceType

    return [evt for evt in prof.events()
            if evt.device_type == DeviceType.CUDA and evt.name not in ranges
            and not getattr(evt, "is_user_annotation", False)]


def profile_call(call, top: int = 8, match=None, keep_profile=False, ranges=()):
    """Where one warm ``call()`` spends the card's time.

    torch.profiler (CUPTI) over one call after a warm one: device time by
    kernel name, the number of device activities (kernels and copies), and
    the device-busy share of the call's wall time (the union of kernel and
    copy intervals over the host-clock wall); with ``match`` (a substring of
    kernel names, or a dict of labels to tuples of substrings a name must
    all hold) also the calls and device ms of the kernels it names; with
    ``keep_profile`` the profile itself under ``profile``. ``None`` fields
    when the profiler saw no device activity. The device-side spans of
    ``record_function`` ranges (user annotations, or named in ``ranges``)
    are not device work and are left out.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for evt in device_work(prof, ranges):
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        calls, us = by_name.get(evt.name, (0, 0.0))
        by_name[evt.name] = (calls + 1, us + (end - start))
    def matching(parts):
        hits = [v for name, v in by_name.items() if all(p in name for p in parts)]
        return dict(calls=sum(c for c, _ in hits), ms=sum(us for _, us in hits) / 1e3)

    matched = None
    if isinstance(match, str):
        matched = dict(name=match, **matching((match,)))
    elif match is not None:
        matched = {label: dict(parts=list(parts), **matching(parts))
                   for label, parts in match.items()}
    kept = dict(profile=prof) if keep_profile else {}
    if not spans:
        return dict(wall_ms=wall_ms, device_busy_ms=None, busy_share=None,
                    device_calls=0, kernels=None, matched=matched, **kept)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            busy_us += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall_ms, device_calls=len(spans),
                kernels=[dict(name=name[:90], calls=calls, ms=us / 1e3)
                         for name, (calls, us) in ranked], matched=matched, **kept)


# ---------------------------------------------------------------------------
# phase 4: the server on the card, against a CPU dispatcher
# ---------------------------------------------------------------------------


def run_serve(cfg, params_cpu, params_dev, dev, n_requests: int, seed: int = 2,
              rtol: float = FC_RTOL, atol: float = FC_ATOL):
    """``n_requests`` through ``ForecastServer`` on the card and observe
    round trips, against a CPU dispatcher of the same config within
    ``rtol``/``atol``."""
    from repro_torch.forecast import (
        BucketDispatcher, ForecastRequest, synthetic_request_stream,
    )
    from repro_torch.forecast.server import ForecastServer, ServerConfig

    n_known = params_cpu["hw"].alpha_logit.shape[0]
    reqs = synthetic_request_stream(cfg, n_requests, n_known=n_known, seed=seed)
    reference = BucketDispatcher(cfg, params_cpu, length_buckets=LENGTH_BUCKETS,
                                 batch_buckets=BATCH_BUCKETS, device="cpu")
    want = reference.forecast_batch(reqs)

    server = ForecastServer(cfg, params_dev, device=dev,
                            length_buckets=LENGTH_BUCKETS, batch_buckets=BATCH_BUCKETS,
                            server_config=ServerConfig(max_wait_ms=2.0))
    server.forecast_batch(reqs)                    # warm wave (synchronous)
    bucket_shapes = server.stats.compiles
    if bucket_shapes > server.stats.compile_budget:
        raise AssertionError(
            f"{bucket_shapes} bucket shapes > budget {server.stats.compile_budget}")
    server.stats.reset()
    server.start()
    try:
        t0 = time.perf_counter()
        futures = [server.submit(r) for r in reqs]
        got = [f.result(timeout=300) for f in futures]
        wall_s = time.perf_counter() - t0
    finally:
        server.stop()
    stats = server.stats
    if stats.requests != n_requests:
        raise AssertionError(f"served {stats.requests} of {n_requests} requests")
    err = max(check_close(f"serve request {i}", _t(g), _t(w), rtol=rtol, atol=atol)
              for i, (g, w) in enumerate(zip(got, want)))
    lat = stats.latency_percentiles()

    # observe round-trips: read-your-writes on known series
    rng = np.random.default_rng(seed + 1)
    sids = [int(s) for s in rng.choice(n_known, N_OBSERVED, replace=False)]
    obs_err = 0.0
    for sid in sids:
        hist = (100.0 * np.exp(rng.normal(0, 0.02, OBS_LEN + 1).cumsum())).astype(np.float32)
        cat = sid % cfg.n_categories
        for v in hist[:-1]:
            server.observe(sid, float(v), category=cat)
        ask = ForecastRequest(series_id=sid, category=cat)   # no y: the store's
        first = server.forecast_batch([ask])[0]
        server.observe(sid, float(hist[-1]))
        second = server.forecast_batch([ask])[0]
        for got_fc, seen in ((first, hist[:-1]), (second, hist)):
            want_fc = reference.forecast_batch([ForecastRequest(
                y=seen, category=cat, series_id=sid)])[0]
            obs_err = max(obs_err, check_close(
                f"observe series {sid}", _t(got_fc), _t(want_fc), rtol=rtol, atol=atol))
        if np.array_equal(first, second):
            raise AssertionError(f"observe on series {sid} did not change its forecast")
        if server.store.get(sid).t != OBS_LEN + 1:
            raise AssertionError(f"series {sid} absorbed {server.store.get(sid).t} writes")
    return dict(requests=n_requests, wall_s=wall_s,
                requests_per_s=n_requests / wall_s, **lat,
                batches=stats.batches, bucket_shapes=bucket_shapes,
                bucket_budget=stats.compile_budget, padded_series=stats.padded_series,
                truncated_series=stats.truncated_series,
                kernel_launches=dict(stats.kernel_launches),
                max_abs_err=err, observed_series=sids,
                observe_round_trips=2 * len(sids), observe_max_abs_err=obs_err)


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# phase 5: training on the card, against the same steps on the CPU
# ---------------------------------------------------------------------------


def run_train(cfg, data, dev, rtol=TRAIN_RTOL):
    """``train_esrnn`` on the card and on the CPU from the same init and
    schedule: 10 dense Adam steps (per-step engine) and 8 sparse Adam steps
    in supersteps of 4. Per-step losses and the final validation sMAPE must
    agree within ``rtol``."""
    import torch

    from repro_torch.core.esrnn import param_leaves
    from repro_torch.train.trainer import TrainConfig, train_esrnn

    runs = {"dense": dict(n_steps=DENSE_STEPS, scan_steps=1, sparse_adam=False),
            "sparse": dict(n_steps=SPARSE_STEPS, scan_steps=SPARSE_SCAN, sparse_adam=True)}
    out = {}
    for name, kw in runs.items():
        tcfg = TrainConfig(batch_size=TRAIN_BATCH, eval_every=1000, seed=0, **kw)
        res, wall = {}, {}
        for where, device in (("card", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            res[where] = train_esrnn(cfg, data, tcfg, device=device,
                                     generator=torch.Generator().manual_seed(0))
            if where == "card":
                torch.cuda.synchronize()
            wall[where] = time.perf_counter() - t0
        card_h, cpu_h = res["card"]["history"], res["cpu"]["history"]
        losses = torch.tensor(card_h["loss"], dtype=torch.float64)
        want = torch.tensor(cpu_h["loss"], dtype=torch.float64)
        if not torch.isfinite(losses).all() or len(losses) != kw["n_steps"]:
            raise AssertionError(f"train {name}: losses {card_h['loss']}")
        check_close(f"train {name} losses", losses, want, rtol=rtol, atol=0.0)
        smape = torch.tensor([v for _, v in card_h["val_smape"]])
        check_close(f"train {name} val sMAPE", smape,
                    torch.tensor([v for _, v in cpu_h["val_smape"]]),
                    rtol=rtol, atol=0.0)
        param_diff = max(
            float((a.detach().cpu() - b.detach()).abs().max())
            for (_, a), (_, b) in zip(param_leaves(res["card"]["params"]),
                                      param_leaves(res["cpu"]["params"])))
        out[name] = dict(
            steps=kw["n_steps"], scan_steps=kw["scan_steps"], losses=card_h["loss"],
            max_rel_loss_err=max_rel(losses, want), val_smape=card_h["val_smape"],
            cpu_val_smape=cpu_h["val_smape"], max_abs_param_diff=param_diff,
            card_wall_s=wall["card"], cpu_wall_s=wall["cpu"])
    return out


def run_dense_train(cfg, data, dev, steps, rtol):
    """``train_esrnn`` of ``cfg`` on the card and on the CPU from the same
    init and schedule: ``steps`` dense Adam steps at batch 256, per-step
    losses within ``rtol``. For the esn head, every reservoir leaf on the
    card is the init's, bit for bit."""
    import torch

    from repro_torch.core.esrnn import esrnn_init, param_leaves
    from repro_torch.train.trainer import TrainConfig, train_esrnn

    tcfg = TrainConfig(batch_size=TRAIN_BATCH, eval_every=1000, seed=0, n_steps=steps,
                       scan_steps=1, sparse_adam=False)
    res, wall = {}, {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        res[where] = train_esrnn(cfg, data, tcfg, device=device,
                                 generator=torch.Generator().manual_seed(0))
        if where == "card":
            torch.cuda.synchronize()
        wall[where] = time.perf_counter() - t0
    card_l, cpu_l = res["card"]["history"]["loss"], res["cpu"]["history"]["loss"]
    losses = torch.tensor(card_l, dtype=torch.float64)
    want = torch.tensor(cpu_l, dtype=torch.float64)
    if not torch.isfinite(losses).all() or len(losses) != steps:
        raise AssertionError(f"{cfg.head} train: losses {card_l}")
    check_close(f"{cfg.head} train losses ({cfg.precision})", losses, want, rtol=rtol, atol=0.0)
    reservoir = None
    if cfg.head == "esn":
        init = esrnn_init(torch.Generator().manual_seed(0), cfg, data.n_series, device="cpu")
        leaves = [(path, t) for path, t in param_leaves(res["card"]["params"]) if path[0] == "rnn"]
        same = [torch.equal(t.detach().cpu(), t0) for (_, t), (_, t0)
                in zip(leaves, [lf for lf in param_leaves(init) if lf[0][0] == "rnn"])]
        if not all(same):
            raise AssertionError(f"esn reservoir leaves moved on the card: "
                                 f"{[p for (p, _), ok in zip(leaves, same) if not ok]}")
        reservoir = dict(leaves=len(leaves), bit_identical=True)
    return dict(head=cfg.head, precision=cfg.precision, steps=steps, losses=card_l,
                cpu_losses=cpu_l, max_rel_loss_err=max_rel(losses, want), reservoir=reservoir,
                card_wall_s=wall["card"], cpu_wall_s=wall["cpu"])


def run_train_wide(data, dev):
    """The quarterly model at ``hidden_size=64``: WIDE_STEPS dense Adam
    steps of ``train_esrnn`` at batch 256 on the card against the CPU, per-step
    losses within TRAIN_RTOL. At this width every LSTM layer after the first
    has I = H = 64: K4 and K5 with (I + H) x 4H weights of 128 KB."""
    from repro_torch.core.esrnn import make_config

    cfg = make_config("quarterly", hidden_size=WIDE_HIDDEN)
    return dict(hidden=cfg.hidden_size, dilations=cfg.dilations,
                **run_dense_train(cfg, data, dev, WIDE_STEPS, TRAIN_RTOL))


class TrainSteps:
    """One dense or sparse train step on the card at a given batch, over
    the train cell's data (the step ``train_esrnn`` runs)."""

    def __init__(self, cfg, data, dev, batch: int, sparse: bool, mesh=None):
        import torch

        from repro_torch.core.esrnn import esrnn_init
        from repro_torch.core.heads import frozen_param_groups
        from repro_torch.data.pipeline import batch_indices
        from repro_torch.train.engine import make_step_fn, split_frozen
        from repro_torch.train.optimizer import AdamConfig, adam_init, adam_init_sparse

        n = data.n_series
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.params = esrnn_init(torch.Generator().manual_seed(0), cfg, n, device=dev)
        frozen = frozen_param_groups(cfg)             # the esn head's reservoir
        trainable = split_frozen(self.params, frozen)[0]
        self.opt = adam_init_sparse(trainable) if sparse else adam_init(trainable)
        adam = AdamConfig(lr=1e-3, clip_norm=20.0,
                          group_lr={"per_series": 10.0, "default": 1.0})
        self.step_fn = make_step_fn(cfg, adam, to_dev(data.train), to_dev(data.cats),
                                    to_dev(data.mask), sparse=sparse, frozen=frozen, mesh=mesh)
        self.idx = [to_dev(batch_indices(n, batch, s)) for s in range(TIMED_STEPS + 4)]
        self.k = 0

    def step(self):
        """One step, then the per-step engine's host sync on its loss."""
        self.params, self.opt, loss = self.step_fn(
            self.params, self.opt, self.idx[self.k % len(self.idx)])
        self.k += 1
        return float(loss)


def time_train_steps(cfg, data, dev):
    """Steps/s of the per-step engine on the card, and launches per step:
    K1 and K2 once, K4 and K5 once a cell step, in the policy's stream dtype
    (the ``_bf16`` counters under bf16), and nothing else."""
    import torch

    from repro_torch.kernels import ops

    cells = forecast_steps(cfg, TRAIN_T)              # a train step walks the same cells
    want = dict.fromkeys(ops.launch_counts(), 0)     # every kernel and stream dtype
    suffix = "_bf16" if cfg.precision == "bf16" else ""
    want.update({"hw_scan" + suffix: 1, "hw_scan_bwd" + suffix: 1,
                 "lstm_cell_fwd" + suffix: cells, "lstm_cell_bwd" + suffix: cells})
    rows = []
    for batch in (TRAIN_BATCH, BIG_BATCH):
        for sparse in (False, True):
            bench = TrainSteps(cfg, data, dev, batch, sparse)
            for _ in range(2):
                bench.step()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            bench.step()
            per_step = ops.launch_counts()
            if per_step != want:
                raise AssertionError(f"launches per train step {per_step}, want {want}")
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                bench.step()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / TIMED_STEPS
            torch.cuda.reset_peak_memory_stats()
            bench.step()
            rows.append(dict(batch=batch, adam="sparse" if sparse else "dense",
                             ms_per_step=dt * 1e3, steps_per_s=1.0 / dt,
                             series_per_s=batch / dt,
                             peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20))
    return dict(launches_per_step=want, timings=rows)


# ---------------------------------------------------------------------------
# phase 6: a server whose idle fine-tune trains on the card, against the CPU
# ---------------------------------------------------------------------------


def run_finetune(cfg, params_cpu, params_dev, dev, seed: int = 6, rtol: float = FC_RTOL,
                 atol: float = FC_ATOL, loss_rtol: float = TRAIN_RTOL):
    """Two ``ForecastServer``s with ``finetune_steps > 0``, on the card and
    on the CPU, observe the same histories, forecast, fine-tune when the
    queue drains, and forecast again; card and CPU must agree, the
    forecasts within ``rtol``/``atol``, the last loss within ``loss_rtol``."""
    import torch

    from repro_torch.core.esrnn import param_leaves
    from repro_torch.core.heads import frozen_param_groups
    from repro_torch.forecast import ForecastRequest
    from repro_torch.forecast.server import ForecastServer, ServerConfig

    sc = ServerConfig(finetune_steps=FT_STEPS, finetune_batch=FT_SERIES)
    kw = dict(length_buckets=LENGTH_BUCKETS, batch_buckets=BATCH_BUCKETS, server_config=sc)
    servers = {"card": ForecastServer(cfg, params_dev, device=dev, **kw),
               "cpu": ForecastServer(cfg, params_cpu, device="cpu", **kw)}
    n_known = params_cpu["hw"].alpha_logit.shape[0]
    rng = np.random.default_rng(seed)
    sids = [int(s) for s in rng.choice(n_known, FT_SERIES, replace=False)]
    m = cfg.seasonality
    for sid in sids:
        seas = np.tile(np.exp(rng.normal(0, 0.1, m)), FT_OBS // m + 1)[:FT_OBS]
        hist = (100.0 * np.exp(rng.normal(0, 0.02, FT_OBS).cumsum()) * seas).astype(np.float32)
        for srv in servers.values():
            for v in hist:
                srv.observe(sid, float(v), category=sid % cfg.n_categories)
    asks = [ForecastRequest(series_id=sid, category=sid % cfg.n_categories) for sid in sids]
    waves = {k: [] for k in servers}
    for _ in range(2):        # each wave ends in a drained queue: one burst each
        for name, srv in servers.items():
            waves[name].append(np.stack(srv.forecast_batch(asks)))
    err = 0.0
    for w in range(2):
        err = max(err, check_close(f"fine-tune wave {w}", _t(waves["card"][w]),
                                   _t(waves["cpu"][w]), rtol=rtol, atol=atol))
    if np.array_equal(waves["card"][0], waves["card"][1]):
        raise AssertionError("the fine-tune burst did not change the forecasts")
    card, cpu = servers["card"], servers["cpu"]
    # a frozen group (the esn reservoir) leaves the fine-tune as it came
    frozen = frozen_param_groups(cfg)
    moved = [path for (path, t), (_, t0) in zip(param_leaves(card.tuner.params),
                                                param_leaves(params_dev))
             if path[0] in frozen and not torch.equal(t, t0)]
    if moved:
        raise AssertionError(f"the fine-tune moved frozen leaves {moved}")
    if not card.stats.finetunes == cpu.stats.finetunes == 2:
        raise AssertionError(f"finetunes: card {card.stats.finetunes}, cpu {cpu.stats.finetunes}")
    # the fine-tuned HW rows are reported, not held to a bound: Adam
    # normalises each per-series gradient, so a logit whose gradient sits at
    # rounding level may step by up to ~lr * sqrt(k) either way on each
    # device. Such a logit barely moves the loss or the forecasts; those two
    # carry the check of the fine-tuned rows
    hw_err = max(float(np.abs(getattr(card.dispatcher._hw_table, f)[sids]
                              - getattr(cpu.dispatcher._hw_table, f)[sids]).max())
                 for f in ("alpha_logit", "gamma_logit", "init_seas_logit"))
    check_close("fine-tune loss", _t(np.float64(card.tuner.last_loss)),
                _t(np.float64(cpu.tuner.last_loss)), rtol=loss_rtol, atol=0.0)
    return dict(series=sids, observations=FT_OBS, steps_per_burst=FT_STEPS,
                bursts=card.stats.finetunes, window=card.tuner.window,
                last_loss=card.tuner.last_loss, cpu_last_loss=cpu.tuner.last_loss,
                forecast_max_abs_err=err, hw_rows_max_abs_diff=hw_err,
                kernel_launches=dict(card.stats.kernel_launches))


# ---------------------------------------------------------------------------
# phase 6b: bf16 training, the bf16 fine-tune and the OWA gate
# ---------------------------------------------------------------------------


def run_train_bf16(cfg16, data, dev, fp32_runs):
    """The train phase's runs under ``precision="bf16"``: card against CPU
    within TRAIN16_RTOL, and the card's bf16 losses within
    TRAIN16_VS_FP32_RTOL of the card's fp32 losses of the same runs
    (``fp32_runs``, the train phase's result)."""
    import torch

    out = run_train(cfg16, data, dev, rtol=TRAIN16_RTOL)
    for name, rec in out.items():
        l16 = torch.tensor(rec["losses"], dtype=torch.float64)
        l32 = torch.tensor(fp32_runs[name]["losses"], dtype=torch.float64)
        check_close(f"train_bf16 {name} losses against the card's fp32 run", l16, l32,
                    rtol=TRAIN16_VS_FP32_RTOL, atol=0.0)
        rec.update(fp32_losses=fp32_runs[name]["losses"],
                   max_rel_loss_err_vs_fp32=max_rel(l16, l32))
    return out


def run_owa(dev):
    """``benchmarks/head_compare.py``'s fast cell on the card: the lstm head
    fitted by ``train_esrnn`` in fp32 and in bf16 from the same init and
    schedule, each test forecast scored by sMAPE and MASE against the port's
    Naive2 (``core/comb.py``), and the bf16/fp32 OWA ratio held to
    OWA_RATIO_GATE."""
    import torch

    from repro_torch.core import losses as L
    from repro_torch.core.comb import naive2_forecast
    from repro_torch.core.esrnn import esrnn_forecast, make_config
    from repro_torch.data.pipeline import prepare
    from repro_torch.data.synthetic_m4 import generate
    from repro_torch.train.trainer import TrainConfig, train_esrnn

    data = prepare(generate("quarterly", scale=OWA_SCALE, seed=0))
    m, h = data.seasonality, data.horizon
    y_in = np.asarray(data.val_input, np.float32)
    target = torch.from_numpy(np.asarray(data.test_target, np.float32))
    insample = torch.from_numpy(y_in)
    n2 = torch.from_numpy(naive2_forecast(y_in, h, m).astype(np.float32))
    n2_smape, n2_mase = float(L.smape(n2, target)), float(L.mase(n2, target, insample, m))
    tcfg = TrainConfig(batch_size=min(OWA_BATCH, data.n_series), n_steps=OWA_STEPS, lr=OWA_LR,
                       eval_every=max(OWA_STEPS // 3, 1), seed=0)
    rows = {}
    for precision in ("fp32", "bf16"):
        cfg = make_config("quarterly", precision=precision)
        t0 = time.perf_counter()
        out = train_esrnn(cfg, data, tcfg, device=dev, generator=torch.Generator().manual_seed(0))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fc = esrnn_forecast(cfg, out["params"], insample.to(dev),
                            torch.from_numpy(np.asarray(data.cats, np.float32)).to(dev)).cpu()
        if fc.dtype != torch.float32 or fc.shape != target.shape or not torch.isfinite(fc).all():
            raise AssertionError(f"owa {precision}: forecast {fc.dtype} {tuple(fc.shape)}")
        smape, mase = float(L.smape(fc, target)), float(L.mase(fc, target, insample, m))
        rows[precision] = dict(fit_s=fit_s, smape=smape, mase=mase,
                               owa=float(L.owa(smape, mase, n2_smape, n2_mase)),
                               final_loss=out["history"]["loss"][-1])
    ratio = rows["bf16"]["owa"] / rows["fp32"]["owa"]
    if not ratio <= OWA_RATIO_GATE:
        raise AssertionError(f"bf16/fp32 lstm OWA ratio {ratio} > {OWA_RATIO_GATE}")
    return dict(frequency="quarterly", n_series=data.n_series, steps=OWA_STEPS,
                batch=tcfg.batch_size, lr=OWA_LR,
                naive2=dict(smape=n2_smape, mase=n2_mase), lstm=rows, bf16_owa_ratio=ratio,
                gate=OWA_RATIO_GATE, reference_bf16_owa_ratio=OWA_RATIO_REFERENCE,
                reference_of="JAX on the CPU, BENCH_PR10.json head_compare")


# ---------------------------------------------------------------------------
# phase 6c: the spec, the estimator, the forecast CLI and checkpoints
# ---------------------------------------------------------------------------


def forecast_cli(*argv, stdin=None):
    """``repro_torch.launch.forecast.main(argv)`` in process, its standard
    output captured (it must not mix with this script's JSON lines):
    ``(output, seconds)``; a non-zero exit raises."""
    import torch

    from repro_torch.launch import forecast

    buf, old_stdin = io.StringIO(), sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO("".join(json.dumps(op) + "\n" for op in stdin))
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = forecast.main(list(argv))
    finally:
        sys.stdin = old_stdin
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"forecast {' '.join(argv)} exited {rc}")
    return buf.getvalue(), seconds


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _sets(pairs):
    return [arg for pair in pairs for arg in ("--set", pair)]


def _timed_ms(fn, reps: int = 3) -> float:
    """Median wall ms of ``reps`` calls after one warm-up, synchronized."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _check_scores(what, got, want, keys, rtol):
    for k in keys:
        g, w = got[k], want[k]
        if not (np.isfinite(g) and abs(g - w) <= rtol * abs(w)):
            raise AssertionError(f"{what} {k}: {g} against the CPU's {w} (rtol {rtol})")
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in keys)


def _resume(name, spec, data, dev, ckpt_dir, every, unbroken):
    """``spec`` fitted on the card into ``ckpt_dir`` for ``every`` steps, then
    a fresh estimator asked for the spec's steps there: resumed from
    ``every``, its losses the unbroken run's ``unbroken`` bit for bit. The
    resume record and the median seconds of a resumed step."""
    from repro_torch.forecast import ESRNNForecaster

    part = ESRNNForecaster(spec, device=dev).fit(data, ckpt_dir=ckpt_dir, n_steps=every)
    stamps = []
    rest = ESRNNForecaster(spec, device=dev).fit(
        data, ckpt_dir=ckpt_dir, hooks={"on_step": lambda *_: stamps.append(time.perf_counter())})
    if rest.resumed_from_ != every or len(rest.history_["loss"]) != len(unbroken) - every:
        raise AssertionError(f"{name} resume: from {rest.resumed_from_}, "
                             f"{len(rest.history_['loss'])} losses")
    diff = max(abs(a - b) for a, b in zip(part.history_["loss"] + rest.history_["loss"],
                                          unbroken))
    if diff != 0.0:
        raise AssertionError(f"{name}: resumed losses differ from the unbroken run's by "
                             f"{diff}: {rest.history_['loss']} against {unbroken}")
    step_s = float(np.median(np.diff(stamps)[:-1]))      # the last did an eval and a save
    return dict(resumed_from=rest.resumed_from_, max_abs_loss_diff=diff), step_s


def _predict_eval(name, out_dir, cpu, card):
    """``predict --quantiles`` and ``eval`` through the CLI on the card from
    the saved ``out_dir``, against ``cpu`` (it loaded on the CPU): bands and
    forecast within FC_RTOL / FC_ATOL, scores within rtol 1e-4. The errors,
    the scores, the largest relative score error and the CLI seconds."""
    import torch

    taus = (0.1, 0.5, 0.9)
    text, predict_s = forecast_cli("predict", "--dir", out_dir, "--quantiles",
                                   ",".join(map(str, taus)), "--json", *card)
    bands = _last_json(text)["quantiles"]
    want_bands = cpu.predict_quantiles(taus=taus)
    errs = {f"band {t}": check_close(f"{name} band {t}", torch.tensor(bands[str(t)]),
                                     torch.from_numpy(want_bands[t]), rtol=FC_RTOL, atol=FC_ATOL)
            for t in taus}
    errs["forecast"] = check_close(f"{name} forecast", torch.tensor(bands["0.5"]),
                                   torch.from_numpy(cpu.predict()), rtol=FC_RTOL, atol=FC_ATOL)
    text, eval_s = forecast_cli("eval", "--dir", out_dir, "--split", "test", "--json", *card)
    scores, want = _last_json(text), cpu.evaluate(split="test")
    eval_err = _check_scores(f"{name} eval", scores, want, [k for k in want if k != "split"],
                             1e-4)
    return errs, scores, eval_err, dict(predict=predict_s, eval=eval_s)


def _backtest_serve_observe(name, out_dir, cpu, dev, errs):
    """``backtest``, ``serve`` (both engines, EST_REQUESTS x EST_WAVES) and
    ``observe`` (EST_OBSERVE) through the CLI on the card from the saved
    ``out_dir``, against ``cpu`` (it loaded on the CPU) and the CLI's
    ``observe`` on the CPU: forecasts within FC_RTOL / FC_ATOL (into
    ``errs``), backtest scores within rtol 1e-4. The backtest, its largest
    relative score error, its CLI seconds, the serve records and the card's
    observe replies."""
    import torch

    card = ("--device", str(dev))
    text, backtest_s = forecast_cli("backtest", "--dir", out_dir, "--json", *card)
    bt, want_bt = _last_json(text), cpu.backtest()
    errs["backtest"] = check_close(f"{name} backtest forecasts", torch.tensor(bt["forecasts"]),
                                   torch.from_numpy(want_bt["forecasts"]),
                                   rtol=FC_RTOL, atol=FC_ATOL)
    bt_err = max(_check_scores(f"{name} backtest origin {w.get('origin', 'overall')}", g, w,
                               ("smape", "mase"), 1e-4)
                 for g, w in zip(bt["per_origin"] + [bt], want_bt["per_origin"] + [want_bt]))
    serve = {}
    for engine in ("continuous", "batch"):
        text, seconds = forecast_cli("serve", "--dir", out_dir, "--engine", engine,
                                     "--requests", str(EST_REQUESTS), "--waves",
                                     str(EST_WAVES), *card)
        m = re.search(r"served (\d+) requests .*?: (\d+) series/s wall \((\d+) req/s", text)
        if not m or int(m.group(1)) != EST_REQUESTS * EST_WAVES:
            raise AssertionError(f"{name} serve {engine}: {text}")
        serve[engine] = dict(requests=int(m.group(1)), series_per_s_wall=int(m.group(2)),
                             requests_per_s_dispatch=int(m.group(3)), cli_s=seconds,
                             output=text.strip().splitlines())
    observed = {}
    for where in (str(dev), "cpu"):
        text, _ = forecast_cli("observe", "--dir", out_dir, "--device", where,
                               stdin=EST_OBSERVE)
        observed[where] = [json.loads(line) for line in text.strip().splitlines()]
    card_obs, cpu_obs = observed[str(dev)], observed["cpu"]
    if len(card_obs) != len(EST_OBSERVE) or card_obs[0].get("ok") is not True \
            or card_obs[2].get("observes") != 1:
        raise AssertionError(f"{name} observe: {card_obs}")
    errs["observe"] = check_close(f"{name} observe forecast",
                                  torch.tensor(card_obs[1]["forecast"]),
                                  torch.tensor(cpu_obs[1]["forecast"]),
                                  rtol=FC_RTOL, atol=FC_ATOL)
    return bt, bt_err, backtest_s, serve, card_obs


def run_estimator(dev, tmp):
    """The user surface at full width, fp32, on the card against the CPU.

    1. ``fit`` through the CLI on the card (20 steps, eval and checkpoints
       every 10, the estimator saved), the same spec fitted by the estimator
       on the CPU: per-step losses and val sMAPE within TRAIN_RTOL.
    2. Resume on the card: a 10-step fit into a checkpoint directory, then a
       fresh estimator asked for 20 steps there: resumed from 10, its losses
       the unbroken CLI run's steps 10-19 bit for bit.
    3. ``predict --quantiles``, ``eval``, ``backtest``, ``serve`` (both
       engines) and ``observe`` through the CLI on the card from the saved
       directory, against ``ESRNNForecaster.load(dir, device="cpu")``:
       forecasts within FC_RTOL / FC_ATOL, scores within rtol 1e-4.
    4. head_compare's fast cell through the CLI: the lstm OWA within
       EST_OWA_FACTOR of the reference's.
    Timings: fit steps/s and wall, save and load seconds, predict, eval and
    backtest ms, serve requests/s.
    """
    import torch

    from repro_torch.forecast import ESRNNForecaster, get_spec

    spec = get_spec(EST_SPEC, n_steps=EST_STEPS, data_scale=EST_SCALE, eval_every=EST_EVERY,
                    ckpt_every=EST_EVERY)
    d1, d2, out_dir, owa_dir = (str(Path(tmp) / n) for n in ("ckpt1", "ckpt2", "fq", "owa"))
    card = ("--device", str(dev))

    # 1. the fit, card (CLI) against CPU (estimator)
    text, fit_s = forecast_cli("fit", "--spec", EST_SPEC, "--steps", str(EST_STEPS),
                               *_sets(EST_SETS), "--ckpt-dir", d1, "--out-dir", out_dir,
                               "--json", *card)
    fit = _last_json(text)
    t0 = time.perf_counter()
    cpu_fit = ESRNNForecaster(spec, device="cpu").fit()
    cpu_fit_s = time.perf_counter() - t0
    data = cpu_fit.data_
    losses = torch.tensor(fit["loss"], dtype=torch.float64)
    if len(losses) != EST_STEPS or not torch.isfinite(losses).all():
        raise AssertionError(f"estimator fit: losses {fit['loss']}")
    check_close("estimator fit losses", losses,
                torch.tensor(cpu_fit.history_["loss"], dtype=torch.float64),
                rtol=TRAIN_RTOL, atol=0.0)
    if [s for s, _ in fit["val_smape"]] != [s for s, _ in cpu_fit.history_["val_smape"]]:
        raise AssertionError(f"estimator fit: val sMAPE at {fit['val_smape']}")
    check_close("estimator fit val sMAPE", torch.tensor([v for _, v in fit["val_smape"]]),
                torch.tensor([v for _, v in cpu_fit.history_["val_smape"]]),
                rtol=TRAIN_RTOL, atol=0.0)

    # 2. resume on the card, against the unbroken CLI run
    resume, step_s = _resume("estimator", spec, data, dev, d2, EST_EVERY, fit["loss"])

    # 3. inference from the saved directory: card (CLI) against CPU (load)
    cpu = ESRNNForecaster.load(out_dir, device="cpu")
    cpu.data_ = data
    errs, scores, eval_err, cli_s = _predict_eval("estimator", out_dir, cpu, card)
    bt, bt_err, backtest_s, serve, card_obs = _backtest_serve_observe(
        "estimator", out_dir, cpu, dev, errs)

    # timings of the estimator's own calls on the card, at the phase's N
    t0 = time.perf_counter()
    f = ESRNNForecaster.load(out_dir, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    f.data_ = data
    t0 = time.perf_counter()
    f.save(str(Path(tmp) / "resaved"))
    save_s = time.perf_counter() - t0
    timings = dict(predict_ms=_timed_ms(f.predict), eval_ms=_timed_ms(f.evaluate),
                   backtest_ms=_timed_ms(f.backtest), save_s=save_s, load_s=load_s)

    # 4. head_compare's fast cell through the CLI
    text, _ = forecast_cli("fit", "--spec", EST_SPEC, "--steps", str(OWA_STEPS),
                           *_sets(EST_OWA_SETS), "--out-dir", owa_dir, "--json", *card)
    owa_fit = _last_json(text)
    text, _ = forecast_cli("eval", "--dir", owa_dir, "--json", *card)
    owa = _last_json(text)
    gate = EST_OWA_FACTOR * EST_OWA_REFERENCE
    if not owa["owa"] <= gate:
        raise AssertionError(f"lstm OWA through the estimator {owa['owa']} > {gate}")

    return dict(
        spec=EST_SPEC, n_series=fit["n_series"], batch=spec.batch_size,
        hidden=spec.model.hidden_size, dilations=spec.model.dilations,
        fit=dict(steps=EST_STEPS, losses=fit["loss"], val_smape=fit["val_smape"],
                 cpu_val_smape=cpu_fit.history_["val_smape"],
                 max_rel_loss_err=max_rel(losses, torch.tensor(cpu_fit.history_["loss"],
                                                               dtype=torch.float64)),
                 cli_wall_s=fit_s, cpu_wall_s=cpu_fit_s, steps_per_s=1.0 / step_s),
        resume=resume,
        inference=dict(max_abs_err=errs, eval_max_rel_err=eval_err,
                       backtest_max_rel_err=bt_err, eval=scores,
                       backtest=dict(origins=bt["origins"], per_origin=bt["per_origin"],
                                     smape=bt["smape"], mase=bt["mase"]),
                       cli_s=dict(cli_s, backtest=backtest_s),
                       serve=serve, observe=card_obs),
        timings=timings,
        owa=dict(n_series=owa_fit["n_series"], steps=OWA_STEPS, sets=EST_OWA_SETS,
                 final_loss=owa_fit["loss"][-1], smape=owa["smape"], mase=owa["mase"],
                 owa=owa["owa"], gate=gate, reference=EST_OWA_REFERENCE,
                 reference_of="JAX on the CPU, BENCH_PR10.json head_compare"))


def run_estimator_bf16(dev, tmp, counted):
    """A 10-step ``fit`` and an ``eval`` through the CLI on the card under
    ``--set precision=bf16``, each counted on its own (the bf16 training
    streams in the fit, K1 and K3 bf16 in eval, no fp32 kernel), against the
    same fit and eval on the CPU: losses and scores within TRAIN16_RTOL."""
    import torch

    from repro_torch.forecast import ESRNNForecaster, get_spec

    spec = get_spec(EST_SPEC, n_steps=EST_BF16_STEPS, data_scale=EST_SCALE, eval_every=EST_EVERY,
                    ckpt_every=EST_EVERY, precision="bf16")
    out_dir = str(Path(tmp) / "fq_bf16")
    sets = _sets(EST_SETS + ("precision=bf16",))
    (text, _), fit_launches = counted(
        ("hw_scan_bf16", "hw_scan_bwd_bf16", "lstm_cell_fwd_bf16", "lstm_cell_bwd_bf16"),
        "the bf16 estimator fit", lambda: forecast_cli(
            "fit", "--spec", EST_SPEC, "--steps", str(EST_BF16_STEPS), *sets,
            "--out-dir", out_dir, "--json", "--device", str(dev)))
    fit = _last_json(text)
    (text, _), eval_launches = counted(
        ("hw_scan_bf16", "lstm_cell_bf16"), "the bf16 estimator eval",
        lambda: forecast_cli("eval", "--dir", out_dir, "--json", "--device", str(dev)))
    scores = _last_json(text)
    if any(eval_launches[k] for k in ("hw_scan_bwd_bf16", "lstm_cell_fwd_bf16",
                                      "lstm_cell_bwd_bf16")):
        raise AssertionError(f"the bf16 eval launched training kernels: {eval_launches}")
    cpu = ESRNNForecaster(spec, device="cpu").fit()
    want = cpu.evaluate(split="test")
    check_close("bf16 estimator losses", torch.tensor(fit["loss"], dtype=torch.float64),
                torch.tensor(cpu.history_["loss"], dtype=torch.float64),
                rtol=TRAIN16_RTOL, atol=0.0)
    err = _check_scores("bf16 eval", scores, want, [k for k in want if k != "split"],
                        TRAIN16_RTOL)
    return dict(steps=EST_BF16_STEPS, losses=fit["loss"], cpu_losses=cpu.history_["loss"],
                eval=scores, cpu_eval=want, max_rel_score_err=err), \
        fit_launches, eval_launches


# ---------------------------------------------------------------------------
# phase 6d: the esn and ssm heads
# ---------------------------------------------------------------------------


def _first_rows(params, n):
    """``params`` with the first ``n`` rows of the HW table (the shared
    weights as they are): the forecast of those series alone."""
    return {k: (v.map(lambda a: a[:n]) if k == "hw" else v) for k, v in params.items()}


def run_head_forecast(head, dev):
    """``esrnn_forecast`` of ``head`` at the forecast cell's N and T on the
    card, held to the CPU on the first HEADS_CPU_N series (each series is
    independent of the others), every value finite and of the right shape;
    then timed."""
    import torch

    from repro_torch.convert import params_to_device
    from repro_torch.core.esrnn import esrnn_forecast

    cfg, params_cpu = make_model(N_SERIES, seed=0, head=head)
    params_dev = params_to_device(params_cpu, dev)
    y, cats = make_batch(cfg, N_SERIES, T_LEN)
    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    got = esrnn_forecast(cfg, params_dev, y_d, c_d)
    torch.cuda.synchronize()
    if tuple(got.shape) != (N_SERIES, cfg.output_size) or not torch.isfinite(got).all():
        raise AssertionError(f"{head} forecast {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    n = HEADS_CPU_N
    t0 = time.perf_counter()
    want = esrnn_forecast(cfg, _first_rows(params_cpu, n), torch.from_numpy(y[:n]),
                          torch.from_numpy(cats[:n]))
    cpu_s = time.perf_counter() - t0
    err = check_close(f"{head} forecast", got[:n], want, rtol=FC_RTOL, atol=FC_ATOL)
    ms = _timed_ms(lambda: esrnn_forecast(cfg, params_dev, y_d, c_d))
    return dict(head=head, N=N_SERIES, T=T_LEN, cpu_rows=n, max_abs_err=err,
                max_rel_err=max_rel(got[:n].cpu(), want), ms=ms,
                series_per_s=N_SERIES / ms * 1e3, cpu_reference_s=cpu_s)


def head_step_launches(cfg, data, dev):
    """Launches of one dense train step of ``cfg``'s head at batch 256: K1
    and K2 once; for esn K4 once a cell step and K5's dx-only launch once a
    cell step, the full K5 never; for ssm nothing else; and the steps/s of
    the per-step engine (TIMED_STEPS dense steps)."""
    import torch

    from repro_torch.kernels import ops

    s = "_bf16" if cfg.precision == "bf16" else ""
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update({f"hw_scan{s}": 1, f"hw_scan_bwd{s}": 1})
    if cfg.head != "ssm":
        cells = forecast_steps(cfg, TRAIN_T)
        want[f"lstm_cell_fwd{s}"] = cells
        want[f"lstm_cell_bwd_dx{s}" if cfg.head == "esn" else f"lstm_cell_bwd{s}"] = cells
    bench = TrainSteps(cfg, data, dev, TRAIN_BATCH, sparse=False)
    for _ in range(2):
        bench.step()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    bench.step()
    per_step = ops.launch_counts()
    if per_step != want:
        raise AssertionError(f"{cfg.head} ({cfg.precision}) launches per train step "
                             f"{per_step}, want {want}")
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        bench.step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED_STEPS
    return bench, dict(launches_per_step={k: v for k, v in per_step.items() if v},
                       ms_per_step=dt * 1e3, steps_per_s=1.0 / dt)


# the kernels of a train step by name, for the profiles of the heads phase
STEP_MATCH = {"K1 hw_scan": ("hw_scan_kernel",), "K2 hw_scan_bwd": ("hw_scan_bwd_kernel",),
              "K4 lstm_cell_fwd": ("lstm_cell_smem<true",),
              "K5 lstm_cell_bwd (full)": ("lstm_bwd<",),
              "K5 lstm_cell_bwd_dx": ("lstm_bwd_dx<",)}


def run_head_owa(head, dev):
    """``benchmarks/head_compare.py``'s fast cell for ``head`` on the card in
    fp32 (``run_owa``'s data, steps, batch, lr and seed; no other seed
    tried), scored against the port's Naive2; the OWA held to
    HEADS_OWA_FACTOR times the reference's (BENCH_PR10.json head_compare).
    A miss is returned, not raised: the caller reports it and fails."""
    import torch

    from repro_torch.core import losses as L
    from repro_torch.core.comb import naive2_forecast
    from repro_torch.core.esrnn import esrnn_forecast, make_config
    from repro_torch.data.pipeline import prepare
    from repro_torch.data.synthetic_m4 import generate
    from repro_torch.train.trainer import TrainConfig, train_esrnn

    data = prepare(generate("quarterly", scale=OWA_SCALE, seed=0))
    m, h = data.seasonality, data.horizon
    y_in = np.asarray(data.val_input, np.float32)
    target = torch.from_numpy(np.asarray(data.test_target, np.float32))
    insample = torch.from_numpy(y_in)
    n2 = torch.from_numpy(naive2_forecast(y_in, h, m).astype(np.float32))
    n2_smape, n2_mase = float(L.smape(n2, target)), float(L.mase(n2, target, insample, m))
    tcfg = TrainConfig(batch_size=min(OWA_BATCH, data.n_series), n_steps=OWA_STEPS, lr=OWA_LR,
                       eval_every=max(OWA_STEPS // 3, 1), seed=0)
    cfg = make_config("quarterly", head=head)
    t0 = time.perf_counter()
    out = train_esrnn(cfg, data, tcfg, device=dev, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fc = esrnn_forecast(cfg, out["params"], insample.to(dev),
                        torch.from_numpy(np.asarray(data.cats, np.float32)).to(dev)).cpu()
    if fc.shape != target.shape or not torch.isfinite(fc).all():
        raise AssertionError(f"owa {head}: forecast {tuple(fc.shape)}")
    smape, mase = float(L.smape(fc, target)), float(L.mase(fc, target, insample, m))
    owa = float(L.owa(smape, mase, n2_smape, n2_mase))
    gate = HEADS_OWA_FACTOR * HEADS_OWA_REFERENCE[head]
    return dict(head=head, n_series=data.n_series, steps=OWA_STEPS, batch=tcfg.batch_size,
                lr=OWA_LR, fit_s=fit_s, smape=smape, mase=mase, owa=owa,
                naive2=dict(smape=n2_smape, mase=n2_mase), gate=gate,
                reference=HEADS_OWA_REFERENCE[head], passed=owa <= gate,
                final_loss=out["history"]["loss"][-1],
                reference_of="JAX on the CPU, BENCH_PR10.json head_compare")


def run_head_cli(head, dev, tmp):
    """``<head>-quarterly`` through the forecast CLI on the card at
    ``data_scale=1.0``: a HEADS_CLI_STEPS-step ``fit`` with ``--ckpt-dir``
    (eval and checkpoints every HEADS_CLI_EVERY); a fit resumed from step
    HEADS_CLI_EVERY equal to the unbroken CLI run bit for bit (for esn its
    checkpoints hold moments of the trainable subtree only); ``predict
    --quantiles`` and ``eval`` from the saved directory against it loaded on
    the CPU (:func:`_predict_eval`); fit steps/s."""
    from repro_torch.forecast import ESRNNForecaster, get_spec

    name = f"{head}-quarterly"
    every = HEADS_CLI_EVERY
    sets = (f"data_scale={EST_SCALE}", f"eval_every={every}", f"ckpt_every={every}")
    spec = get_spec(name, n_steps=HEADS_CLI_STEPS, data_scale=EST_SCALE, eval_every=every,
                    ckpt_every=every)
    d1, d2, out_dir = (str(Path(tmp) / f"{head}_{n}") for n in ("ckpt1", "ckpt2", "fq"))
    card = ("--device", str(dev))
    text, fit_s = forecast_cli("fit", "--spec", name, "--steps", str(HEADS_CLI_STEPS),
                               *_sets(sets), "--ckpt-dir", d1, "--out-dir", out_dir, "--json",
                               *card)
    fit = _last_json(text)
    if len(fit["loss"]) != HEADS_CLI_STEPS or not np.isfinite(fit["loss"]).all():
        raise AssertionError(f"{name} fit: losses {fit['loss']}")
    cpu = ESRNNForecaster.load(out_dir, device="cpu")
    data = cpu.make_data()
    cpu.data_ = data
    resume, step_s = _resume(name, spec, data, dev, d2, every, fit["loss"])
    errs, scores, eval_err, cli_s = _predict_eval(name, out_dir, cpu, card)
    return dict(spec=name, n_series=fit["n_series"], steps=HEADS_CLI_STEPS,
                losses=fit["loss"], val_smape=fit["val_smape"], cli_fit_s=fit_s,
                fit_steps_per_s=1.0 / step_s, resume=resume, predict_max_abs_err=errs,
                eval=scores, eval_max_rel_err=eval_err, cli_s=cli_s)


# ---------------------------------------------------------------------------
# phase 6e: the out-of-core chunked fit (the table pinned on the host and
# streamed to the card on a copy stream), chunked predict, eval, backtest
# ---------------------------------------------------------------------------


def _launch_diff(before):
    from repro_torch.kernels import ops

    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def _fit_state(out):
    """Params, then moments, ``t_hw`` (sparse Adam) and the step count, as
    host tensors."""
    import torch

    from repro_torch.core.esrnn import param_leaves

    opt = out["opt_state"]
    return ([t.detach().cpu() for _, t in param_leaves(out["params"])]
            + [t.detach().cpu() for t in opt["mu"] + opt["nu"]]
            + ([opt["t_hw"].cpu()] if "t_hw" in opt else []) + [torch.tensor(opt["step"])])


def _same_fits(what, a, b):
    """Two fits equal bit for bit: per-step losses and every state leaf."""
    import torch

    diff = max(abs(x - y) for x, y in zip(a["history"]["loss"], b["history"]["loss"],
                                          strict=True))
    leaves = [i for i, (x, y) in enumerate(zip(_fit_state(a), _fit_state(b), strict=True))
              if not torch.equal(x, y)]
    if diff != 0.0 or leaves:
        raise AssertionError(f"{what}: loss absdiff {diff}, state leaves differing {leaves}")
    return diff


def _chunk_fit(cfg, data, device, steps, **kw):
    """``train_esrnn`` with the chunked cell's settings: ``(out, seconds)``."""
    import torch

    from repro_torch.train.trainer import TrainConfig, train_esrnn

    tcfg = TrainConfig(batch_size=TRAIN_BATCH, n_steps=steps, scan_steps=CHUNK_SCAN,
                       series_chunk=CHUNK_ROWS, eval_every=CHUNK_EVERY, ckpt_every=1000,
                       seed=CHUNK_SEED, straggler_factor=float("inf"), **kw)
    t0 = time.perf_counter()
    out = train_esrnn(cfg, data, tcfg, device=device, generator=torch.Generator().manual_seed(0))
    if device != "cpu":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_chunked_exact(cfg, data, dev, tmp):
    """(a) The streamed fit at M4's quarterly count, fp32: on the card
    against the ``chunk_resident`` fit on the card (losses, params and
    optimizer state bit for bit, val sMAPE rtol 1e-5) and against the
    streamed fit on the CPU (losses and val sMAPE within TRAIN_RTOL); its
    launches K1 once a step and once a chunk of each streamed eval, K2 once
    a step, K4 and K5 once a cell step, K3 once a cell step of each eval
    chunk; stopped at 12 and resumed from the row-sharded checkpoint, equal
    to the unbroken run bit for bit. Then 12 bf16 steps (streamed equal to
    chunk_resident bit for bit, losses within TRAIN16_VS_FP32_RTOL of the
    fp32 run's) and 12 esn steps (streamed equal to chunk_resident; K5's
    dx-only launch once a cell step, the full K5 never; the reservoir
    bit-identical to the init's)."""
    import torch

    from repro_torch.core.esrnn import esrnn_init, make_config, param_leaves
    from repro_torch.data.pipeline import chunk_layout, chunk_visit_plan
    from repro_torch.kernels import ops

    n = data.n_series
    per_chunk, _ = chunk_layout(n, CHUNK_ROWS, TRAIN_BATCH)
    visits = list(chunk_visit_plan(n, CHUNK_ROWS, TRAIN_BATCH, 0, CHUNK_STEPS, seed=CHUNK_SEED))
    tail = len(per_chunk) - 1
    if len(visits) < 3 or tail not in [v.chunk_id for v in visits]:
        raise AssertionError(f"the chunked schedule misses the ragged tail: {visits}")
    cells = forecast_steps(cfg, TRAIN_T)

    before = ops.launch_counts()
    stream, stream_s = _chunk_fit(cfg, data, dev, CHUNK_STEPS)
    launches = _launch_diff(before)
    evals = len(stream["history"]["val_smape"])
    want = dict.fromkeys(launches, 0)
    want.update(hw_scan=CHUNK_STEPS + evals * len(per_chunk), hw_scan_bwd=CHUNK_STEPS,
                lstm_cell_fwd=CHUNK_STEPS * cells, lstm_cell_bwd=CHUNK_STEPS * cells,
                lstm_cell=evals * len(per_chunk) * cells)
    if launches != want:
        raise AssertionError(f"the streamed fit launched {launches}, want {want}")
    losses = torch.tensor(stream["history"]["loss"], dtype=torch.float64)
    if len(losses) != CHUNK_STEPS or not torch.isfinite(losses).all():
        raise AssertionError(f"streamed fit losses {stream['history']['loss']}")
    if not stream["params"]["hw"].alpha_logit.is_pinned():
        raise AssertionError("the streamed fit's table is not in pinned memory")
    resident, resident_s = _chunk_fit(cfg, data, dev, CHUNK_STEPS, chunk_resident=True)
    _same_fits("streamed vs chunk_resident (fp32)", stream, resident)
    vs = lambda out: torch.tensor([v for _, v in out["history"]["val_smape"]], dtype=torch.float64)
    check_close("streamed vs chunk_resident val sMAPE", vs(stream), vs(resident),
                rtol=1e-5, atol=0.0)
    cpu, cpu_s = _chunk_fit(cfg, data, "cpu", CHUNK_STEPS)
    check_close("streamed card vs CPU losses", losses,
                torch.tensor(cpu["history"]["loss"], dtype=torch.float64),
                rtol=TRAIN_RTOL, atol=0.0)
    check_close("streamed card vs CPU val sMAPE", vs(stream), vs(cpu), rtol=TRAIN_RTOL,
                atol=0.0)

    ckpt = str(Path(tmp) / "chunked_ckpt")
    part, _ = _chunk_fit(cfg, data, dev, CHUNK_EVERY, ckpt_dir=ckpt)
    shards = sorted(f for f in Path(ckpt, f"step_{CHUNK_EVERY}").iterdir()
                    if ".shard_" in f.name)
    if not shards:
        raise AssertionError(f"no row-sharded table files in {ckpt}")
    rest, _ = _chunk_fit(cfg, data, dev, CHUNK_STEPS, ckpt_dir=ckpt)
    if rest["resumed_from"] != CHUNK_EVERY:
        raise AssertionError(f"resumed from {rest['resumed_from']}")
    joined = dict(rest, history=dict(rest["history"],
                                     loss=part["history"]["loss"] + rest["history"]["loss"]))
    resume_diff = _same_fits("resumed vs unbroken", joined, stream)

    cfg16 = dataclasses.replace(cfg, precision="bf16")
    s16, _ = _chunk_fit(cfg16, data, dev, CHUNK_SHORT)
    r16, _ = _chunk_fit(cfg16, data, dev, CHUNK_SHORT, chunk_resident=True)
    _same_fits("streamed vs chunk_resident (bf16)", s16, r16)
    err16 = check_close("bf16 streamed vs fp32 streamed losses",
                        torch.tensor(s16["history"]["loss"], dtype=torch.float64),
                        losses[:CHUNK_SHORT], rtol=TRAIN16_VS_FP32_RTOL, atol=0.0)

    cfg_esn = make_config("quarterly", head="esn")
    before = ops.launch_counts()
    esn, _ = _chunk_fit(cfg_esn, data, dev, CHUNK_SHORT)
    esn_launches = _launch_diff(before)
    if (esn_launches["lstm_cell_bwd_dx"] != CHUNK_SHORT * cells
            or esn_launches["lstm_cell_bwd"] or esn_launches["lstm_cell_bwd_bf16"]):
        raise AssertionError(f"the esn chunked fit launched {esn_launches}")
    esn_res, _ = _chunk_fit(cfg_esn, data, dev, CHUNK_SHORT, chunk_resident=True)
    _same_fits("streamed vs chunk_resident (esn)", esn, esn_res)
    init = esrnn_init(torch.Generator().manual_seed(0), cfg_esn, 1, device="cpu")
    reservoir = [(p, t) for p, t in param_leaves(esn["params"]) if p[0] == "rnn"]
    moved = [p for (p, t), (_, t0) in zip(reservoir, [lf for lf in param_leaves(init)
                                                       if lf[0][0] == "rnn"])
             if not torch.equal(t.detach().cpu(), t0)]
    if not reservoir or moved:
        raise AssertionError(f"esn reservoir leaves moved in the chunked fit: {moved}")

    return dict(
        N=n, T=TRAIN_T, batch=TRAIN_BATCH, series_chunk=CHUNK_ROWS, chunks=len(per_chunk),
        tail_rows=per_chunk[-1][1] - per_chunk[-1][0], steps=CHUNK_STEPS, scan_steps=CHUNK_SCAN,
        seed=CHUNK_SEED, visits=[(v.chunk_id, v.n_steps) for v in visits],
        launches=launches, losses=stream["history"]["loss"],
        val_smape=stream["history"]["val_smape"],
        resident_val_smape=resident["history"]["val_smape"],
        cpu_val_smape=cpu["history"]["val_smape"],
        max_rel_loss_err_vs_cpu=max_rel(losses, torch.tensor(cpu["history"]["loss"],
                                                             dtype=torch.float64)),
        loss_absdiff_vs_chunk_resident=0.0, resume=dict(resumed_from=CHUNK_EVERY,
                                                        loss_absdiff=resume_diff,
                                                        shard_files=len(shards)),
        h2d_per_visit=stream["history"].get("h2d"),
        wall_s=dict(streamed=stream_s, chunk_resident=resident_s, cpu=cpu_s),
        bf16=dict(steps=CHUNK_SHORT, loss_absdiff_vs_chunk_resident=0.0,
                  max_rel_vs_fp32=max_rel(torch.tensor(s16["history"]["loss"],
                                                       dtype=torch.float64),
                                          losses[:CHUNK_SHORT]), err=err16),
        esn=dict(steps=CHUNK_SHORT, loss_absdiff_vs_chunk_resident=0.0,
                 launches={k: v for k, v in esn_launches.items() if v},
                 reservoir_leaves=len(reservoir), reservoir_bit_identical=True))


def _first_series(data, n):
    """``data`` cut to its first ``n`` series."""
    return dataclasses.replace(data, **{
        f.name: getattr(data, f.name)[:n] for f in dataclasses.fields(data)
        if isinstance(getattr(data, f.name), np.ndarray)})


def _host_rss_mb():
    """The process's resident set now and at its peak, in MB."""
    import resource

    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return now / 1024, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _scale_fit(cfg, data, dev, steps, allow_oom=False, **kw):
    """One fit of the scale cell, with the device peak above the memory in
    use before it (``max_memory_allocated``), the peak sampled at every
    superstep boundary up to the last one before the final eval, and the
    boundaries' wall clock. With ``allow_oom`` a fit that runs out of device
    memory returns ``None`` and the record so far, the error in it."""
    import torch

    from repro_torch.train.trainer import TrainConfig, train_esrnn

    tcfg = TrainConfig(batch_size=SCALE_BATCH, n_steps=steps, scan_steps=SCALE_SCAN,
                       eval_every=steps, ckpt_every=10**9, seed=0,
                       straggler_factor=float("inf"), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stamps, peaks = [], []

    def on_step(last, losses, params):
        stamps.append((last + 1, time.perf_counter()))
        peaks.append(torch.cuda.max_memory_allocated() - base)

    t0 = time.perf_counter()
    try:
        out = train_esrnn(cfg, data, tcfg, device=dev, hooks={"on_step": on_step},
                          generator=torch.Generator().manual_seed(0))
        error = None
    except torch.cuda.OutOfMemoryError as e:
        if not allow_oom:
            raise
        out, error = None, str(e).splitlines()[0]
    torch.cuda.synchronize()
    before_eval = peaks if error else peaks[:-1]     # the last boundary ran the eval
    rec = dict(wall_s=time.perf_counter() - t0,
               peak_bytes=None if error else torch.cuda.max_memory_allocated() - base,
               peak_bytes_before_final_eval=before_eval[-1] if before_eval else None,
               boundaries=stamps)
    if error:
        rec["out_of_memory"] = error
    return out, rec


def _h2d_overlap(trace_path):
    """From a profiler trace: the device time of the host-to-device copies
    that ran on another stream than the compute stream (the stream with
    the most kernels), the share of it during which a kernel ran on the
    compute stream, and the compute stream's busy share over the trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels.setdefault(e["args"].get("stream"), []).append((e["ts"], e["ts"] + e["dur"]))
    if not kernels:
        return dict(error="no kernel events in the trace")
    compute = max(kernels, key=lambda k: len(kernels[k]))
    merged = []
    for a, b in sorted(kernels[compute]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    copies = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream")) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    side = [(a, b) for a, b, st in copies if st != compute]
    total = sum(b - a for a, b in side)
    covered = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in side for ka, kb in merged)
    busy = sum(b - a for a, b in merged)
    span = max(b for _, b in merged) - min(a for a, _ in merged)
    return dict(copies=len(side), kernel_streams=sorted(kernels),
                copy_streams=sorted({st for _, _, st in copies if st != compute}),
                compute_stream=compute, h2d_ms=total / 1e3, window_ms=span / 1e3,
                h2d_overlapped_share=covered / total if total else None,
                compute_busy_share=busy / span if span else None,
                compute_stream_h2d_copies=sum(1 for *_, st in copies if st == compute))


def run_chunked_scale(dev, tmp):
    """(b) The scale cell: the streamed fit of SCALE_N series at the preset's
    width (losses finite, the table pinned), its steps/s between the first
    and the third visit's ends, the copies' device ms per visit, the
    streamed predict of SCALE_N x 8 (finite); the device peak of the same
    fit on SCALE_SMALL_N series within CHUNK_MEM_TOL of it; the resident
    sparse fit's peak at SCALE_N (or its out-of-memory error); host RSS; and
    a 16-step streamed fit under ``torch.profiler``, read for the copies'
    overlap with the compute stream."""
    import torch

    from repro_torch.core.esrnn import make_config
    from repro_torch.data.pipeline import synthetic_prepared
    from repro_torch.forecast import ESRNNForecaster, get_spec

    cfg = make_config("quarterly")
    t0 = time.perf_counter()
    data = synthetic_prepared(SCALE_N, series_length=TRAIN_T)
    data_s = time.perf_counter() - t0
    big, big_rec = _scale_fit(cfg, data, dev, SCALE_STEPS, series_chunk=SCALE_CHUNK)
    losses = big["history"]["loss"]
    if len(losses) != SCALE_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"the {SCALE_N}-series chunked fit: losses {losses}")
    table = [big["params"]["hw"].alpha_logit, big["params"]["hw"].init_seas_logit,
             big["opt_state"]["t_hw"]]
    table += [m for m in big["opt_state"]["mu"] if m.device.type == "cpu"]
    if not all(t.device.type == "cpu" and t.is_pinned() for t in table):
        raise AssertionError("the fitted host table is not pinned")
    (s1, t1), (s3, t3) = big_rec["boundaries"][0], big_rec["boundaries"][2]
    steps_per_s = (s3 - s1) / (t3 - t1)
    rss_fit = _host_rss_mb()

    spec = get_spec("esrnn-quarterly", series_chunk=SCALE_CHUNK)
    f = ESRNNForecaster(spec, device=dev)
    f.params_, f.n_series_, f.data_, f.cats_ = big["params"], SCALE_N, data, data.cats
    fc = f.predict()
    if fc.shape != (SCALE_N, cfg.output_size) or not np.isfinite(fc).all():
        raise AssertionError(f"the streamed predict: {fc.shape}, finite {np.isfinite(fc).all()}")
    predict_ms = _timed_ms(f.predict, reps=2)
    del f, fc

    small, small_rec = _scale_fit(cfg, _first_series(data, SCALE_SMALL_N), dev, SCALE_STEPS,
                                  series_chunk=SCALE_CHUNK)
    del small
    mem_ratio = big_rec["peak_bytes"] / small_rec["peak_bytes"]
    if abs(mem_ratio - 1.0) > CHUNK_MEM_TOL:
        raise AssertionError(f"the chunked fit's device peak at {SCALE_N} series is "
                             f"{mem_ratio:.4f} x its peak at {SCALE_SMALL_N}")

    from torch.profiler import ProfilerActivity, profile

    trace = str(Path(tmp) / "chunked_trace.json")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _scale_fit(cfg, data, dev, SCALE_PROFILE_STEPS, series_chunk=SCALE_CHUNK)
    prof.export_chrome_trace(trace)
    overlap = _h2d_overlap(trace)
    del prof
    if len(overlap.get("kernel_streams", [None])) != 1:
        raise AssertionError(f"the chunked fit launched kernels on several streams: {overlap}")

    torch.cuda.empty_cache()
    resident, res_rec = _scale_fit(cfg, data, dev, SCALE_STEPS, allow_oom=True,
                                   sparse_adam=True)
    del resident
    resident_peak = {k: v for k, v in res_rec.items() if k != "boundaries"}
    torch.cuda.empty_cache()
    rss_end = _host_rss_mb()
    ratio = (big_rec["peak_bytes"] / resident_peak["peak_bytes"]
             if resident_peak["peak_bytes"] else None)
    ratio_train = (big_rec["peak_bytes_before_final_eval"]
                   / resident_peak["peak_bytes_before_final_eval"]
                   if resident_peak.get("peak_bytes_before_final_eval") else None)
    strip = lambda rec: {k: v for k, v in rec.items() if k != "boundaries"}
    return dict(
        N=SCALE_N, T=TRAIN_T, hidden=cfg.hidden_size, batch=SCALE_BATCH,
        series_chunk=SCALE_CHUNK, scan_steps=SCALE_SCAN, steps=SCALE_STEPS,
        data_s=data_s, losses=losses, val_smape=big["history"]["val_smape"],
        fit=strip(big_rec), fit_steps_per_s=steps_per_s,
        h2d_per_visit=big["history"].get("h2d"),
        h2d_mb_per_visit=_visit_bytes(cfg, SCALE_CHUNK, TRAIN_T) / 1e6,
        predict=dict(shape=[SCALE_N, cfg.output_size], ms=predict_ms),
        table_pinned=True, host_rss_mb=dict(after_fit=rss_fit, end=rss_end),
        memory=dict(chunked_peak_mb=big_rec["peak_bytes"] / 2**20,
                    chunked_small_n=SCALE_SMALL_N,
                    chunked_small_peak_mb=small_rec["peak_bytes"] / 2**20,
                    peak_ratio_n_vs_small_n=mem_ratio, tolerance=CHUNK_MEM_TOL,
                    resident=resident_peak, chunked_vs_resident=ratio,
                    chunked_vs_resident_before_final_eval=ratio_train),
        profile=dict(steps=SCALE_PROFILE_STEPS, **overlap))


def _visit_bytes(cfg, rows, t_len):
    """Bytes one visit copies to the card: the HW rows, their two moments
    and clocks, y, mask and the one-hots, float32 (clocks int32)."""
    hw = 2 + max(cfg.seasonality, 1)
    return rows * 4 * (3 * hw + 1 + 2 * t_len + cfg.n_categories)


def run_chunked_memory_reference(dev):
    """(b) The reference's peak_memory cell: the resident sparse fit and the
    streamed fit, live device bytes (``memory_allocated`` above the memory
    in use before the fit) sampled at every superstep boundary; the
    chunked/resident ratio beside the reference's (reported, not gated)."""
    import torch

    from repro_torch.core.esrnn import make_config
    from repro_torch.data.pipeline import synthetic_prepared
    from repro_torch.train.trainer import TrainConfig, train_esrnn

    cfg = make_config("quarterly", hidden_size=REF_MEM_HIDDEN)
    data = synthetic_prepared(REF_MEM_N, seasonality=cfg.seasonality,
                              horizon=cfg.output_size, series_length=24)
    out = {}
    for name, chunk in (("resident", 0), ("chunked", REF_MEM_CHUNK)):
        tcfg = TrainConfig(batch_size=REF_MEM_BATCH, n_steps=REF_MEM_STEPS, scan_steps=4,
                           sparse_adam=True, series_chunk=chunk, eval_every=10**9,
                           ckpt_every=10**9)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        peak = [0]

        def on_step(last, losses, params):
            peak[0] = max(peak[0], torch.cuda.memory_allocated() - base)

        fit = train_esrnn(cfg, data, tcfg, device=dev, hooks={"on_step": on_step},
                          generator=torch.Generator().manual_seed(0))
        out[name] = dict(peak_live_bytes=peak[0], final_loss=fit["history"]["loss"][-1])
        del fit
    return dict(N=REF_MEM_N, series_chunk=REF_MEM_CHUNK, batch=REF_MEM_BATCH,
                steps=REF_MEM_STEPS, hidden=REF_MEM_HIDDEN, T=24, **out,
                ratio_chunked_vs_resident=out["chunked"]["peak_live_bytes"]
                / out["resident"]["peak_live_bytes"],
                reference_ratio=REF_MEM_RATIO,
                reference_of="JAX on the CPU, BENCH_PR10.json peak_memory")


def run_chunked_cli(dev, tmp):
    """(c) ``esrnn-quarterly`` at ``data_scale=1.0`` through the CLI with
    ``--set series_chunk=2048``: a 20-step ``fit`` (eval and checkpoints
    every 10) that logs "streaming chunked fit" and leaves row-sharded
    table files in its checkpoint directory; ``predict --quantiles``,
    ``eval``, ``backtest``, ``serve`` (both engines) and ``observe`` from
    the saved directory on the card against it loaded on the CPU (its
    table on the host, the verbs streamed there too), rtol 1e-4 / atol
    1e-5, scores rtol 1e-4."""
    import logging

    from repro_torch.forecast import ESRNNForecaster

    sets = EST_SETS + (f"series_chunk={CHUNK_ROWS}",)
    ckpt, out_dir = (str(Path(tmp) / n) for n in ("cli_chunked_ckpt", "cli_chunked_fq"))
    card = ("--device", str(dev))
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logger = logging.getLogger("repro_torch.train")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        text, fit_s = forecast_cli("fit", "--spec", EST_SPEC, "--steps", str(EST_STEPS),
                                   *_sets(sets), "--ckpt-dir", ckpt, "--out-dir", out_dir,
                                   "--json", *card)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    fit = _last_json(text)
    if len(fit["loss"]) != EST_STEPS or not np.isfinite(fit["loss"]).all():
        raise AssertionError(f"chunked CLI fit: losses {fit['loss']}")
    if not any("streaming chunked fit" in m for m in records):
        raise AssertionError(f"the chunked CLI fit did not stream: {records}")
    shards = [p.name for p in Path(ckpt, f"step_{EST_STEPS}").iterdir()
              if p.name.startswith("leaf_") and ".shard_" in p.name]
    if not shards:
        raise AssertionError(f"no leaf_*.shard_*.bin in {ckpt}/step_{EST_STEPS}")
    cpu = ESRNNForecaster.load(out_dir, device="cpu")
    if cpu.spec.series_chunk != CHUNK_ROWS or cpu.n_series_ <= CHUNK_ROWS:
        raise AssertionError(f"saved spec series_chunk {cpu.spec.series_chunk}, "
                             f"{cpu.n_series_} series")
    cpu.data_ = cpu.make_data()
    errs, scores, eval_err, cli_s = _predict_eval("chunked CLI", out_dir, cpu, card)
    bt, bt_err, backtest_s, serve, card_obs = _backtest_serve_observe(
        "chunked CLI", out_dir, cpu, dev, errs)
    return dict(spec=EST_SPEC, sets=list(sets), n_series=fit["n_series"], steps=EST_STEPS,
                losses=fit["loss"], val_smape=fit["val_smape"], cli_fit_s=fit_s,
                shard_files=len(shards), max_abs_err=errs, eval=scores,
                eval_max_rel_err=eval_err, backtest_max_rel_err=bt_err,
                backtest=dict(per_origin=bt["per_origin"], smape=bt["smape"], mase=bt["mase"]),
                cli_s=dict(cli_s, backtest=backtest_s), serve=serve, observe=card_obs)


# ---------------------------------------------------------------------------
# phase 6f: series data parallelism (two gloo ranks sharing the card, one
# NCCL rank)
# ---------------------------------------------------------------------------


def _dp_fit_config(name, steps=DP_STEPS):
    """The model and TrainConfig of one dp fit: the train cell at batch
    256, eval every DP_EVERY (chunked: chunks of CHUNK_ROWS)."""
    from repro_torch.core.esrnn import make_config
    from repro_torch.train.trainer import TrainConfig

    over, kw = DP_FITS[name]
    cfg = make_config("quarterly", **over)
    return cfg, TrainConfig(batch_size=TRAIN_BATCH, n_steps=steps, eval_every=DP_EVERY,
                            ckpt_every=1000, seed=0, straggler_factor=float("inf"), **kw)


def _dp_fit(name, data, dev, mesh=None):
    """One dp fit from the seed's init: its losses, val sMAPE, a digest of
    its params and optimizer state, its kernel launches and collectives."""
    import hashlib

    import torch

    from repro_torch.kernels import ops
    from repro_torch.train.trainer import train_esrnn

    cfg, tcfg = _dp_fit_config(name)
    before = ops.launch_counts()          # deltas: the phase's own count runs on
    if mesh is not None:
        mesh.reset_counts()
    t0 = time.perf_counter()
    out = train_esrnn(cfg, data, tcfg, mesh=mesh, device=dev,
                      generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    digest = hashlib.sha256()
    for t in _fit_state(out):
        digest.update(t.contiguous().numpy().tobytes())
    return dict(loss=out["history"]["loss"], val_smape=out["history"]["val_smape"],
                state_sha256=digest.hexdigest(), launches=_launch_diff(before),
                collectives=None if mesh is None else mesh.collective_counts(), wall_s=wall)


def _dp_inference(fc_cfg, params, y, cats, data, dev, mesh=None):
    """The estimator's predict, backtest and evaluate of the forecast cell
    (24,000 series), and the serve cell's 96 requests through a server:
    outputs, kernel launches and collectives by call."""
    from repro_torch.forecast import ESRNNForecaster, get_spec, synthetic_request_stream
    from repro_torch.forecast.server import ForecastServer
    from repro_torch.kernels import ops

    spec = get_spec("esrnn-quarterly")
    f = ESRNNForecaster(spec, device=dev)
    f.params_, f.n_series_, f.cats_ = params, N_SERIES, cats
    reqs = synthetic_request_stream(fc_cfg, N_REQUESTS, n_known=N_SERIES, seed=2)
    calls = {
        "predict": lambda: f.predict(y, cats, mesh=mesh),
        "backtest": lambda: f.backtest(y=y, cats=cats, origins=ORIGINS, mesh=mesh),
        "evaluate": lambda: f.evaluate(data, split="test", mesh=mesh),
        "serve": lambda: np.stack(ForecastServer(
            fc_cfg, params, mesh=mesh, device=dev, length_buckets=LENGTH_BUCKETS,
            batch_buckets=BATCH_BUCKETS).forecast_batch(reqs)),
    }
    out = {}
    for name, call in calls.items():
        before = ops.launch_counts()
        if mesh is not None:
            mesh.reset_counts()
        t0 = time.perf_counter()
        value = call()
        out[name] = dict(value=value, wall_ms=(time.perf_counter() - t0) * 1e3,
                         launches=_launch_diff(before),
                         collectives=None if mesh is None else mesh.collective_counts())
    return out


def _dp_steps_per_s(data, dev, mesh=None):
    """Steps/s of the dense fp32 step at batch 256 (TIMED_STEPS after two
    warm-up steps, each synced by its loss)."""
    import torch

    from repro_torch.core.esrnn import make_config

    bench = TrainSteps(make_config("quarterly"), data, dev, TRAIN_BATCH, sparse=False,
                       mesh=mesh)
    for _ in range(2):
        bench.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        bench.step()
    torch.cuda.synchronize()
    return TIMED_STEPS / (time.perf_counter() - t0)


def _dp_collective_ms(mesh, n_grad: int, reps: int = 50):
    """Wall ms per all-reduce of a train step's two buffers on this mesh:
    the three loss terms and the gradient buffer of ``n_grad`` floats."""
    import torch

    out = {}
    for name, n in (("loss_terms", 3), ("grad_buffer", n_grad)):
        buf = torch.ones(n, device=mesh.device)
        mesh.all_reduce(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            mesh.all_reduce(buf)
        torch.cuda.synchronize()
        out[name] = dict(floats=n, ms=(time.perf_counter() - t0) * 1e3 / reps)
    mesh.reset_counts()
    return out


def _dp_rank(mesh, fc_cfg, fc_params, y, cats):
    """One rank of the dp phase (a spawned process): every fit, the
    inference calls and the timings, on this rank's share of the rows."""
    from repro_torch import strict_fp32
    from repro_torch.convert import params_to_device
    from repro_torch.core.esrnn import param_leaves
    from repro_torch.data.pipeline import synthetic_prepared

    strict_fp32()
    dev = mesh.device
    data = synthetic_prepared(TRAIN_N, series_length=TRAIN_T)
    out = {"rank": mesh.rank, "fits": {name: _dp_fit(name, data, dev, mesh) for name in DP_FITS}}
    infer = _dp_inference(fc_cfg, params_to_device(fc_params, dev), y, cats, data, dev, mesh)
    out["inference"] = infer
    out["steps_per_s"] = _dp_steps_per_s(data, dev, mesh)
    n_grad = TRAIN_BATCH * 6 + sum(t.numel() for path, t in param_leaves(fc_params)
                                   if path[0] != "hw")
    out["collective_ms"] = _dp_collective_ms(mesh, n_grad)
    return out


def _dp_nccl(dev, tmp):
    """The sharded loss, eval and backtest called directly on a 1-rank
    NCCL group (no 1-rank degeneration): bit for bit the single-device
    results, every collective launched on the card."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import copy_params
    from repro_torch.core import losses as L
    from repro_torch.core.esrnn import (
        esrnn_forecast, esrnn_forecast_at, esrnn_loss_fn, param_leaves, value_and_grad,
    )
    from repro_torch.sharding import series as S

    cfg, params = make_model(TRAIN_BATCH, seed=3)
    y, cats = (torch.from_numpy(a).to(dev) for a in make_batch(cfg, TRAIN_BATCH, TRAIN_T))
    mask = torch.ones_like(y)
    mask[:16, :20] = 0.0
    tgt = y[:, -cfg.output_size:]
    ins = y[:, :-cfg.output_size]
    tm = torch.ones((TRAIN_BATCH, len(DP_ORIGINS), cfg.output_size), device=dev)
    tm[:, -1, 4:] = 0.0
    bt_tgt = torch.stack([y[:, o - cfg.output_size:o] for o in DP_ORIGINS], dim=1)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                            world_size=1)
    try:
        mesh = S.make_series_mesh(1, device=dev)
        got, want = {}, {}
        p = copy_params(params, dev)
        leaves = [t.requires_grad_(True) for _, t in param_leaves(p)]
        got["loss"], got["grads"] = S.esrnn_loss_and_grad_dp(cfg, p, y, cats, mask, mesh=mesh)
        want["loss"], want["grads"] = value_and_grad(
            lambda: esrnn_loss_fn(cfg, p, y, cats, mask), leaves)
        ev = S.esrnn_eval_dp(cfg, p, ins, cats, tgt, ins, seasonality=cfg.seasonality,
                             mesh=mesh)
        got["eval"] = [ev["smape"], ev["mase"]]
        fc = esrnn_forecast(cfg, p, ins, cats)
        s0, s1 = L.smape_terms(fc, tgt)
        m0, m1 = L.mase_terms(fc, tgt, ins, cfg.seasonality)
        want["eval"] = [200.0 * s0 / torch.clamp_min(s1, 1.0), m0 / torch.clamp_min(m1, 1.0)]
        got["backtest"] = S.esrnn_backtest_dp(cfg, p, y, cats, DP_ORIGINS, bt_tgt, tm,
                                              seasonality=cfg.seasonality, mesh=mesh)
        fc_at = esrnn_forecast_at(cfg, p, y, cats, DP_ORIGINS)
        want["backtest"] = (fc_at, tuple(L.rolling_metric_terms(
            fc_at, bt_tgt, tm, y, DP_ORIGINS, cfg.seasonality)))
        torch.cuda.synchronize()
        counts = mesh.collective_counts()
    finally:
        dist.destroy_process_group()
    flat = lambda v: [t.detach().float().cpu() for t in (
        v if isinstance(v, (list, tuple)) else [v])]
    for key in got:
        g = flat(got[key]) if key != "backtest" else flat([got[key][0], *got[key][1]])
        w = flat(want[key]) if key != "backtest" else flat([want[key][0], *want[key][1]])
        for a, b in zip(g, w, strict=True):
            if not torch.equal(a, b):
                raise AssertionError(f"the 1-rank NCCL {key} differs from one device: "
                                     f"max abs {float((a - b).abs().max())}")
    want_counts = {"all_reduce": 2 + 1 + 1}
    if counts != want_counts:
        raise AssertionError(f"NCCL collectives {counts}, want {want_counts}")
    return dict(backend="nccl", ranks=1, calls=["esrnn_loss_dp", "esrnn_eval_dp",
                                                "esrnn_backtest_dp"],
                collectives=counts, bit_identical=True)


def _dp_values(value) -> np.ndarray:
    """An inference call's numbers as one vector: the forecasts, or the
    scores (sMAPE and MASE, overall and per origin)."""
    if isinstance(value, np.ndarray):
        return value.ravel().astype(np.float64)
    nums = [value["smape"], value["mase"]]
    if "forecasts" in value:
        nums += [v for row in value["per_origin"] for v in (row["smape"], row["mase"])]
        return np.concatenate([value["forecasts"].ravel(), nums])
    return np.asarray(nums, np.float64)


def run_dp(dev, tmp):
    """The dp phase: two gloo ranks sharing the card against the same calls
    on one device of the card, then one NCCL rank."""
    import torch

    from repro_torch.convert import params_to_device
    from repro_torch.data.pipeline import synthetic_prepared
    from repro_torch.sharding import run_ranks
    from repro_torch.sharding import series as S

    data = synthetic_prepared(TRAIN_N, series_length=TRAIN_T)
    fc_cfg, fc_params = make_model(N_SERIES)
    y, cats = make_batch(fc_cfg, N_SERIES, T_LEN)
    single = {name: _dp_fit(name, data, dev) for name in DP_FITS}
    single_inf = _dp_inference(fc_cfg, params_to_device(fc_params, dev), y, cats, data, dev)
    single_sps = _dp_steps_per_s(data, dev)
    t0 = time.perf_counter()
    ranks = run_ranks(_dp_rank, DP_RANKS, device="cuda", args=(fc_cfg, fc_params, y, cats))
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    fits = {}
    for name in DP_FITS:
        got, want = r0["fits"][name], single[name]
        for r in ranks[1:]:
            if r["fits"][name]["state_sha256"] != got["state_sha256"] or (
                    r["fits"][name]["loss"] != got["loss"]):
                raise AssertionError(f"dp fit {name}: the ranks' states differ")
        rtol = DP_FIT16_RTOL if "bf16" in name else DP_FIT_RTOL
        err = max(abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"], strict=True))
        verr = max(abs(g[1] - w[1]) / abs(w[1])
                   for g, w in zip(got["val_smape"], want["val_smape"], strict=True))
        if not (err <= rtol and verr <= rtol):
            raise AssertionError(f"dp fit {name}: loss rel {err}, val rel {verr} > {rtol}")
        evals = len(want["val_smape"])
        want_coll = {"all_reduce": 2 * DP_STEPS + evals}
        if got["collectives"] != want_coll:
            raise AssertionError(f"dp fit {name}: collectives {got['collectives']}, "
                                 f"want {want_coll}")
        for r in ranks:
            if r["fits"][name]["launches"] != want["launches"]:
                raise AssertionError(f"dp fit {name}: rank {r['rank']} launched "
                                     f"{r['fits'][name]['launches']}, one device "
                                     f"{want['launches']}")
        fits[name] = dict(loss_max_rel=err, val_smape_max_rel=verr, rtol=rtol,
                          collectives=got["collectives"], launches=got["launches"],
                          rank_wall_s=got["wall_s"], single_wall_s=want["wall_s"],
                          ranks_bit_identical=True)
    inference = {}
    want_coll = dict.fromkeys(("predict", "backtest", "evaluate"), S.VERB_COLLECTIVES)
    for name, want in single_inf.items():
        got = r0["inference"][name]
        g, w = _dp_values(got["value"]), _dp_values(want["value"])
        for r in ranks[1:]:
            if not np.array_equal(_dp_values(r["inference"][name]["value"]), g,
                                  equal_nan=True):
                raise AssertionError(f"dp {name}: the ranks' results differ")
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"dp {name}: unscored (NaN) entries differ from one device")
        rel = float(np.nanmax(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
        if not rel <= DP_INFER_RTOL:
            raise AssertionError(f"dp {name}: max rel {rel} > {DP_INFER_RTOL}")
        wc = want_coll.get(name, {"all_reduce": None})
        if name == "serve":
            wc = {"all_reduce": got["collectives"].get("all_reduce")}
            if not wc["all_reduce"]:
                raise AssertionError(f"dp serve: no collectives {got['collectives']}")
        if got["collectives"] != wc:
            raise AssertionError(f"dp {name}: collectives {got['collectives']}, want {wc}")
        for r in ranks:
            if r["inference"][name]["launches"] != want["launches"]:
                raise AssertionError(f"dp {name}: rank {r['rank']} launched "
                                     f"{r['inference'][name]['launches']}, one device "
                                     f"{want['launches']}")
        inference[name] = dict(max_rel=rel, bound=DP_INFER_RTOL, collectives=got["collectives"],
                               rank_ms=got["wall_ms"], single_ms=want["wall_ms"])
    nccl = _dp_nccl(dev, tmp)
    torch.cuda.empty_cache()
    return dict(ranks=DP_RANKS, backend="gloo", device_shared=torch.cuda.get_device_name(0),
                fits=fits, inference=inference, steps_per_s=dict(
                    two_ranks=r0["steps_per_s"], one_device=single_sps),
                collective_ms=r0["collective_ms"], ranks_wall_s=ranks_s, nccl=nccl,
                note="two ranks share one card's SMs: overhead, not scaling")


def run_dp_cli(dev, tmp):
    """``fit --devices 2`` through the CLI (it spawns the ranks) against
    ``--devices 1``, and the sharded fit's saved directory predicted with
    ``--devices 2`` against ``--devices 1``."""
    args = ["--spec", EST_SPEC, "--device", "cuda", "--steps", str(DP_CLI_STEPS),
            *_sets(DP_CLI_SETS), "--json"]
    fits, secs = {}, {}
    for d in (1, DP_RANKS):
        out, secs[d] = forecast_cli("fit", *args, "--devices", str(d),
                                    "--out-dir", f"{tmp}/dp_cli_{d}")
        fits[d] = _last_json(out)
    g, w = fits[DP_RANKS]["loss"], fits[1]["loss"]
    err = max(abs(a - b) / abs(b) for a, b in zip(g, w, strict=True))
    if not err <= DP_FIT_RTOL:
        raise AssertionError(f"fit --devices {DP_RANKS}: loss rel {err} > {DP_FIT_RTOL}")
    preds = {}
    for d in (1, DP_RANKS):
        out, _ = forecast_cli("predict", "--dir", f"{tmp}/dp_cli_{DP_RANKS}", "--device", "cuda",
                              "--devices", str(d), "--json")
        preds[d] = np.asarray(_last_json(out)["forecast"])
    prel = float(np.max(np.abs(preds[DP_RANKS] - preds[1]) / np.abs(preds[1])))
    if not prel <= DP_INFER_RTOL:
        raise AssertionError(f"predict --devices {DP_RANKS}: max rel {prel}")
    return dict(n_series=fits[1]["n_series"], steps=DP_CLI_STEPS, loss_max_rel=err,
                predict_max_rel=prel, fit_s={str(d): s for d, s in secs.items()})


# ---------------------------------------------------------------------------
# phase 6e (b'): the reference's 1M-series gate, in a fresh process
# ---------------------------------------------------------------------------


def million_main(dev=None) -> int:
    """The reference's cell (scripts/million_series_smoke.py) on the card
    (``dev``, default the first): its host RSS split by owner, its wall
    time; one JSON line."""
    import resource

    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch import strict_fp32
    from repro_torch.core.esrnn import param_leaves
    from repro_torch.data.pipeline import synthetic_prepared
    from repro_torch.forecast import ESRNNForecaster, get_spec
    from repro_torch.kernels import build

    rss = lambda: _host_rss_mb()[0]
    # the pinned-host allocator's bytes in use and at their peak, in MB
    pinned = lambda: {k: torch.cuda.host_memory_stats()[f"allocated_bytes.{k}"] / 2**20
                      for k in ("current", "peak")}
    strict_fp32()
    rec = {"rss_mb": {"python_torch": rss()}}
    # this process's peak RSS: VmRSS sampled every RSS_SAMPLE_S on a thread
    peak_seen, stop = [rec["rss_mb"]["python_torch"]], threading.Event()

    def sample():
        while not stop.wait(RSS_SAMPLE_S):
            peak_seen[0] = max(peak_seen[0], rss())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        build.library()
    spec = get_spec("esrnn-quarterly", hidden_size=MILLION_HIDDEN, batch_size=SCALE_BATCH,
                    n_steps=SCALE_STEPS, series_chunk=SCALE_CHUNK, sparse_adam=True,
                    scan_steps=SCALE_SCAN, eval_every=10**9, ckpt_every=10**9, smoke=True)
    # the bare context: the kernel library loaded, one forecast launched
    warm = ESRNNForecaster(spec.replace(series_chunk=0), device=dev)
    warm.init_params(8)
    warm.predict(np.full((8, MILLION_T), 100.0, np.float32))
    torch.cuda.synchronize()
    rec["rss_mb"]["cuda_context"] = rss()
    del warm
    t0 = time.perf_counter()
    data = synthetic_prepared(SCALE_N, seasonality=spec.model.seasonality,
                              horizon=spec.horizon, series_length=MILLION_T)
    rec["data_s"] = time.perf_counter() - t0
    rec["data_mb"] = sum(getattr(data, f.name).nbytes for f in dataclasses.fields(data)
                         if isinstance(getattr(data, f.name), np.ndarray)) / 2**20
    rec["rss_mb"]["data"] = rss()
    t0 = time.perf_counter()
    f = ESRNNForecaster(spec, device=dev).fit(data)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    losses = np.asarray(f.history_["loss"], np.float64)
    if len(losses) != SCALE_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"the 1M fit's losses: {losses}")
    val = f.history_["val_smape"]
    if not (val and np.isfinite(val[-1][1])):
        raise AssertionError(f"the 1M fit's val sMAPE: {val}")
    rec["rss_mb"]["fit"] = rss()
    rec["pinned_mb_after_fit"] = pinned()
    rec["table_mb"] = sum(t.nbytes for _, t in param_leaves({"hw": f.params_["hw"]})) / 2**20
    t0 = time.perf_counter()
    fc = f.predict()
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    if fc.shape != (SCALE_N, spec.horizon) or not np.isfinite(fc).all():
        raise AssertionError(f"the 1M predict: {fc.shape}")
    rec["rss_mb"]["predict"] = rss()
    rec["pinned_mb_after_predict"] = pinned()
    # the table and its moments are pinned whole; the data set is the
    # caller's, each visit pinning a copy of its own rows only
    if rec["pinned_mb_after_predict"]["peak"] >= rec["data_mb"]:
        print(f"the 1M cell pinned {rec['pinned_mb_after_predict']['peak']:.0f} MB at its peak, "
              f"as much as its {rec['data_mb']:.0f} MB data set", file=sys.stderr)
        return 1
    stop.set()
    sampler.join()
    # the peak is the sampled VmRSS: ru_maxrss keeps, across exec, the
    # resident set of the process that started this one (reported beside)
    peak = max(peak_seen[0], rss())
    rec["ru_maxrss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    wall = t_fit + t_pred
    context = rec["rss_mb"]["cuda_context"]
    # the reference's budget; above the bare context's RSS where that alone
    # takes more than half of it (a CUDA process's fixed cost)
    above_context = context > MILLION_RSS_MB / 2
    gated = peak - context if above_context else peak
    rec.update(n_series=SCALE_N, T=MILLION_T, hidden=MILLION_HIDDEN, chunk=SCALE_CHUNK,
               batch=SCALE_BATCH, steps=SCALE_STEPS, scan_steps=SCALE_SCAN, fit_s=t_fit,
               predict_s=t_pred, wall_s=wall, wall_gate_s=MILLION_WALL_S, peak_rss_mb=peak,
               rss_gate_mb=MILLION_RSS_MB, rss_gated_mb=gated,
               rss_gate_above_context=above_context, final_loss=float(losses[-1]),
               val_smape=float(val[-1][1]))
    print(json.dumps(rec), flush=True)
    if wall > MILLION_WALL_S or gated > MILLION_RSS_MB:
        print(f"the 1M gate failed: {wall:.1f} s (gate {MILLION_WALL_S}), {gated:.0f} MB "
              f"(gate {MILLION_RSS_MB})", file=sys.stderr)
        return 1
    return 0


def run_million():
    """:func:`million_main` in a fresh process, so that its peak RSS is the
    cell's own; its record."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--million"],
                          capture_output=True, text=True, timeout=MILLION_WALL_S + 300)
    sys.stderr.write(proc.stderr[-4000:])
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the 1M cell exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# phase 6g: the invariant auditor (repro_torch.analysis) on the card
# ---------------------------------------------------------------------------


def _loss_with_broadcast(cfg, params, y, cats, mask=None, *, mesh):
    """The sharded loss plus a broadcast past the mesh: the collective
    audit's seeded violation (module level: the ranks unpickle it)."""
    import torch.distributed as dist

    from repro_torch.sharding import series as S

    loss = S.esrnn_loss_dp(cfg, params, y, cats, mask, mesh=mesh)
    dist.broadcast(loss.detach().clone(), src=0)
    return loss


def _analyze_report(name, tmp, *argv):
    """``analyze`` through the CLI in process on the card (it exits 1 on a
    violation, which raises); its report."""
    path = f"{tmp}/analyze_{name}.json"
    _, seconds = forecast_cli("analyze", "--device", "cuda", "--json-out", path, *argv)
    report = json.loads(Path(path).read_text())
    if not report["ok"]:
        raise AssertionError(f"analyze {name}: {report}")
    return report, seconds


def _seeded_violations(dev):
    """One seeded violation per lint, run on the card through the real entry
    points; each must land in its section's violations under its lint."""
    from unittest import mock

    import torch

    from repro_torch.analysis import audit as A
    from repro_torch.core.heads import frozen_param_groups
    from repro_torch.forecast import get_spec
    from repro_torch.forecast.serving import BucketDispatcher
    from repro_torch.train import engine

    out = {}

    def seeded(lint, section):
        lints = {f.lint for f in section.violations}
        if lint not in lints:
            raise AssertionError(f"the seeded {lint} violation was not found: {section}")
        out[lint] = dict(section=section.name, found=sorted(lints),
                         violations=len(section.violations))
        return section

    # gradient-leak: the esn step built with no frozen group trains its reservoir
    spec = get_spec("esn-quarterly")
    cfg, params, y, cats = A.probe_model(spec, dev)
    step, opt_init, _ = A.fit_step(spec, cfg, y, cats, frozenset())
    leak = seeded("gradient-leak", A.audit_step(cfg, step, params, opt_init(params),
                                                frozen_param_groups(cfg)))
    # on the card the recorder sees K5's weight gradients as the allocation
    # of its outputs: the full K5's must show as frozen-weight-shaped values
    metrics = leak.metrics["gradient_leak"]
    k5 = metrics["k5_launches"]
    if not (k5["full"] > 0 and k5["dx_only"] == 0 and metrics["grad_op_hits"] > 0):
        raise AssertionError(f"the trainable reservoir's step: {metrics}")
    out["gradient-leak"].update({k: metrics[k] for k in (
        "k5_launches", "grad_op_hits", "frozen_accumulate_grads", "passthrough_ok")})
    # dtype-policy: a float64 zero added to the step's loss
    real = engine.esrnn_loss_fn

    def f64_loss(*args, **kwargs):
        loss = real(*args, **kwargs)
        return loss + torch.zeros((), dtype=torch.float64, device=loss.device)

    with mock.patch.object(engine, "esrnn_loss_fn", f64_loss):
        seeded("dtype-policy", A.audit_fit(get_spec("esrnn-quarterly"), device=dev))
    # donation: a step that rebinds a moment to a fresh tensor
    spec = get_spec("esrnn-quarterly")
    cfg, params, y, cats = A.probe_model(spec, dev)
    step, opt_init, _ = A.fit_step(spec, cfg, y, cats, frozenset())

    def replacing(p, o, idx):
        p, o, loss = step(p, o, idx)
        o["mu"][0] = o["mu"][0].clone()
        return p, o, loss

    seeded("donation", A.audit_step(cfg, replacing, params, opt_init(params), frozenset()))

    # recompile: a dispatcher that skips the batch padding
    class Unpadded(BucketDispatcher):
        def pad_batch(self, requests, bb):
            return requests

    serve = seeded("recompile", A.audit_serve(spec, device=dev, dispatcher=Unpadded))
    out["recompile"]["repeat_launch_shapes"] = serve.metrics["repeat_launch_shapes"]
    # collectives: a broadcast in the loss, on two gloo ranks sharing the card
    coll = seeded("collectives", A.audit_collectives(spec, 2, device=dev,
                                                     loss_fn=_loss_with_broadcast))
    out["collectives"]["loss_grad"] = coll.metrics["counts"]["loss_grad"]
    return out


def _recorder_cost(dev, steps=ANALYZE_COST_STEPS):
    """ms per training step of the full-width quarterly model (dense fp32,
    the audit's probe batch) with the recorders disarmed and armed (a
    Trace and a LaunchShapeCounter around each step), in turns."""
    import torch

    from repro_torch.analysis import audit as A
    from repro_torch.analysis.recompile import LaunchShapeCounter
    from repro_torch.analysis.trace import Trace
    from repro_torch.forecast import get_spec

    spec = get_spec("esrnn-quarterly")
    cfg, params, y, cats = A.probe_model(spec, dev)
    step, opt_init, _ = A.fit_step(spec, cfg, y, cats, frozenset())
    opt = opt_init(params)
    idx = torch.arange(5, device=dev)

    def run(armed):
        nonlocal params, opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            if armed:
                with Trace(), LaunchShapeCounter():
                    params, opt, _ = step(params, opt, idx)
            else:
                params, opt, _ = step(params, opt, idx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    run(False)
    run(True)                                   # warm-up, both ways
    times = {"disarmed": [], "armed": []}
    for armed in (False, True, True, False):
        times["armed" if armed else "disarmed"].append(run(armed))
    med = {k: float(np.median(v)) for k, v in times.items()}
    return dict(steps=steps, batch=5, ms_per_step=med, runs_ms=times,
                armed_over_disarmed=med["armed"] / med["disarmed"])


def _dispatch_cost(dev, reps=ANALYZE_DISPATCH_REPS):
    """ms per serving dispatch of the full-width quarterly model (8 requests
    on the (8, 64) bucket, its shape already counted, so the dispatcher runs
    it unarmed) alone and inside a warm LaunchShapeCounter (what arming
    every dispatch costs), in turns."""
    import contextlib

    import torch

    from repro_torch.analysis import audit as A
    from repro_torch.analysis.recompile import LaunchShapeCounter
    from repro_torch.forecast import get_spec
    from repro_torch.forecast.serving import BucketDispatcher, synthetic_request_stream

    cfg, params, _, _ = A.probe_model(get_spec("esrnn-quarterly"), dev)
    srv = BucketDispatcher(cfg, params, length_buckets=(32, 64), batch_buckets=(1, 8),
                           device=dev)
    reqs = synthetic_request_stream(cfg, 8, n_known=A.PROBE_SERIES, seed=0,
                                    len_range=(40, 60))
    counter = LaunchShapeCounter()

    def run(armed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            with counter if armed else contextlib.nullcontext():
                srv.run_bucket(reqs, 64)
        return (time.perf_counter() - t0) * 1e3 / reps

    run(False)
    run(True)                                   # warm-up, both ways
    times = {"unarmed": [], "armed": []}
    for armed in (False, True, True, False) * 2:
        times["armed" if armed else "unarmed"].append(run(armed))
    med = {k: float(np.median(v)) for k, v in times.items()}
    launches = sum(srv.stats.kernel_launches.values()) / srv.stats.batches
    return dict(reps=reps, ms_per_dispatch=med, runs_ms=times, keys=counter.count,
                kernel_calls_per_dispatch=launches,
                armed_over_unarmed=med["armed"] / med["unarmed"])


def run_analyze(dev, tmp):
    """Phase analyze: the CLI's ``analyze`` at full width for every head and
    precision the port serves, ``--devices 2`` on two gloo ranks sharing the
    card, one NCCL rank, one seeded violation per lint, the recorders' cost
    and the serving counter's; one JSON line per part, the phase's wall time
    on the last."""
    from repro_torch.analysis import audit as A
    from repro_torch.analysis.gradleak import cell_steps
    from repro_torch.forecast import get_spec

    t_phase = time.perf_counter()
    for name, spec_name, sets in ANALYZE_RUNS:
        report, seconds = _analyze_report(name, tmp, "--spec", spec_name, "--entries",
                                          "fit,predict,serve", *_sets(sets))
        fit = report["sections"][0]["metrics"]
        k5 = fit["gradient_leak"]["k5_launches"]
        cfg = get_spec(spec_name).model
        if name == "esn" and k5 != {"full": 0, "dx_only": cell_steps(cfg, A.PROBE_T)}:
            raise AssertionError(f"the esn fit launched K5 {k5}")
        emit(dict(phase="analyze", part=name, spec=report["spec"], sets=list(sets),
                  ok=report["ok"], seconds=seconds,
                  metrics={s["name"]: s["metrics"] for s in report["sections"]}))
    report, seconds = _analyze_report("devices2", tmp, "--spec", "esrnn-quarterly",
                                      "--entries", "predict", "--devices", "2")
    coll = report["sections"][-1]["metrics"]
    want = {"predict": {"all_reduce": 1}, "loss_grad": {"all_reduce": 2}}
    for call, counts in want.items():
        if not coll["counts"][call] == coll["counts"][f"mesh_{call}"] == counts:
            raise AssertionError(f"analyze --devices 2: {coll}")
    emit(dict(phase="analyze", part="devices2", ok=True, seconds=seconds, collectives=coll))
    t0 = time.perf_counter()
    nccl = A.audit_collectives(get_spec("esrnn-quarterly"), 1, device=dev)
    if nccl.violations or nccl.metrics["backend"] != "nccl":
        raise AssertionError(f"the 1-rank NCCL collective audit: {nccl}")
    emit(dict(phase="analyze", part="nccl", ok=True, seconds=time.perf_counter() - t0,
              collectives=nccl.metrics))
    t0 = time.perf_counter()
    seeded = _seeded_violations(dev)
    emit(dict(phase="analyze", part="seeded", seconds=time.perf_counter() - t0, found=seeded))
    cost = _recorder_cost(dev)
    dispatch = _dispatch_cost(dev)
    return dict(part="summary", wall_s=time.perf_counter() - t_phase, recorder_cost=cost,
                dispatch_cost=dispatch)


# ---------------------------------------------------------------------------
# phase 7: the LM serving path (yi-6b prefill + greedy decode)
# ---------------------------------------------------------------------------


def arch_config(arch, n_layers=None, dtype=None):
    """``arch``'s config, its depth and dtype optionally cut."""
    import dataclasses

    from repro_torch.configs import get_config

    changes = {k: v for k, v in (("n_layers", n_layers), ("dtype", dtype)) if v is not None}
    return dataclasses.replace(get_config(arch), **changes)


def _params_to(params, dev):
    if isinstance(params, dict):
        return {k: _params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, dev) for v in params]
    return params.to(dev)


def cache_err(what, dev_caches, cpu_caches) -> float:
    """The largest difference between two devices' caches, walked leaf by
    leaf (dicts, lists of per-layer caches, each a ``KVCache``, an
    ``MLACache`` or an ``SSMCache``, and bare tensors such as an encdec
    model's ``memory``), within the LM bounds; cache lengths equal."""
    if not hasattr(cpu_caches, "_fields") and not isinstance(cpu_caches, (dict, list)):
        return check_close(what, dev_caches, cpu_caches, rtol=LM_RTOL, atol=LM_ATOL)
    if isinstance(cpu_caches, dict):
        return max(cache_err(f"{what} {k}", dev_caches[k], c) for k, c in cpu_caches.items())
    if isinstance(cpu_caches, list):
        if len(dev_caches) != len(cpu_caches):
            raise AssertionError(f"{what}: {len(dev_caches)} caches != {len(cpu_caches)}")
        return max(cache_err(f"{what} {i}", d, c)
                   for i, (d, c) in enumerate(zip(dev_caches, cpu_caches)))
    errs = []
    for f in cpu_caches._fields:
        d, c = getattr(dev_caches, f), getattr(cpu_caches, f)
        if f == "length":
            if d != c:
                raise AssertionError(f"{what}: length {d} != {c}")
            continue
        errs.append(check_close(f"{what} {f}", d, c, rtol=LM_RTOL, atol=LM_ATOL))
    return max(errs)


def k6_per_prefill(cfg) -> int:
    """K6 launches a prefill makes: one per attention layer, one per
    application of a hybrid's shared block, none in an ssm model; an encdec
    model one per encoder layer and two per decoder layer (self and cross)."""
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "encdec": (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)


def k6_per_decode_step(cfg) -> int:
    """K6 launches a decode step makes: an encdec model's cross-attention,
    one per decoder layer; none in any other family (its decode attends
    through ``cached_attention``, a plain einsum)."""
    return cfg.n_layers if cfg.family == "encdec" else 0


def run_parity(dev, arch, n_layers, prompt_len, batch=LM_PARITY_BATCH, gen=LM_PARITY_GEN,
               seed=7):
    """``arch`` at full width, ``n_layers`` deep, fp32, card against CPU on
    the serve launcher's inputs (``draw_inputs``): the prefill (K6 on the
    card in each attention, the plain chunked path on the CPU; the SSD and
    a MoE layer's dispatch are PyTorch calls on both) and every decode
    step's logits and caches. Both decode the CPU's greedy tokens, so a
    near-tie that flips one token on one device cannot derail the
    comparison; whether the card's own greedy tokens agree is reported. K6
    launches asserted: ``k6_per_prefill`` in the prefill (one per attention
    layer or shared-block application; an encdec model's encoder layers,
    decoder self- and cross-attentions) and ``k6_per_decode_step`` in each
    decode step (an encdec model's cross-attentions, else none). By family:
    a dense or encdec model's prefill is also held, on both devices, against
    one with float64 weights and products (norms, RoPE, softmax and the
    sinusoids stay fp32, as the model casts); an encdec model's caches
    include its encoder ``memory``; each
    MoE layer's routing is held equal on the same input (``parity_routing``);
    under MLA the card's absorbed decode is held against its up-projected
    one (``absorbed_decode=False``) on the same cache at every step."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import draw_inputs
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import moe_route

    cfg = arch_config(arch, n_layers=n_layers, dtype="float32")
    model = build_model(cfg)
    # drawn on the card (a CPU draw of qwen2.5-14b's 2 layers took 25 s), copied
    t0 = time.perf_counter()
    params_dev = model.init(torch.Generator(device=dev).manual_seed(seed))
    params_cpu = _params_to(params_dev, "cpu")
    init_s = time.perf_counter() - t0
    prompts, extra = draw_inputs(cfg, batch, prompt_len, seed)
    batch_cpu = {"tokens": prompts, **extra}
    batch_dev = {k: v.to(dev) for k, v in batch_cpu.items()}
    offset = extra["image_embeds"].shape[1] if "image_embeds" in extra else 0
    max_len = prompt_len + offset + gen
    want_k6 = (k6_per_prefill(cfg), k6_per_decode_step(cfg) * (gen - 1))
    rec = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers, dtype="float32",
               batch=batch, prompt_len=prompt_len, image_patches=offset, steps=gen,
               init_s=init_s)
    if cfg.family == "encdec":
        rec.update(n_enc_layers=cfg.n_enc_layers, frames=cfg.n_frames)
    seen = {"cpu": [], "card": []}

    def route_on(where):
        return lambda p, c, x: seen[where].append((p, x, moe_route(p, c, x)))

    errs, cache_errs, absorbed_errs, agree = [], [], [], []
    with torch.no_grad():
        before = ops.launch_counts()["flash_attention"]
        with moe_layers_seen(route_on("cpu")):
            log_c, cache_c = model.prefill(params_cpu, batch_cpu, max_len)
        with moe_layers_seen(route_on("card")):
            log_d, cache_d = model.prefill(params_dev, batch_dev, max_len)
        torch.cuda.synchronize()
        prefill_launches = ops.launch_counts()["flash_attention"] - before
        if seen["cpu"]:
            rec.update(parity_routing(cfg, seen, dev))
        seen = None
        if cfg.family in ("dense", "encdec"):
            params64 = _params_to(params_cpu, torch.float64)
            log64, _ = build_model(arch_config(arch, n_layers, "float64")).prefill(
                params64, batch_cpu, max_len)
            del params64
            rec["prefill_max_abs_err_vs_fp64"] = {
                where: check_close(f"{arch} parity {where} vs float64", log, log64,
                                   rtol=LM_RTOL, atol=LM_ATOL)
                for where, log in (("card", log_d), ("cpu", log_c))}
        decode_launches = 0
        for step in range(gen):
            errs.append(check_close(f"{arch} parity logits, step {step}", log_d, log_c,
                                    rtol=LM_RTOL, atol=LM_ATOL))
            cache_errs.append(cache_err(f"{arch} parity caches, step {step}", cache_d, cache_c))
            tok = log_c[:, -1].argmax(dim=-1)
            agree.append(bool((log_d[:, -1].argmax(dim=-1).cpu() == tok).all()))
            if step == gen - 1:
                break
            pos = torch.full((batch, 1), prompt_len + offset + step, dtype=torch.int64)
            log_c, cache_c = model.decode(
                params_cpu, {"tokens": tok[:, None], "positions": pos}, cache_c)
            step_dev = {"tokens": tok[:, None].to(dev), "positions": pos.to(dev)}
            before = ops.launch_counts()["flash_attention"]
            if cfg.use_mla:
                # the up-projected decode first: both write this step's
                # latents at the same slots, and the absorbed one's stay
                with mla_decode_up_projected():
                    log_u, _ = model.decode(params_dev, step_dev, cache_d)
            log_d, cache_d = model.decode(params_dev, step_dev, cache_d)
            decode_launches += ops.launch_counts()["flash_attention"] - before
            if cfg.use_mla:
                absorbed_errs.append(check_close(
                    f"{arch} parity absorbed vs up-projected decode, step {step}", log_d, log_u,
                    rtol=LM_RTOL, atol=LM_ATOL))
    if (prefill_launches, decode_launches) != want_k6:
        raise AssertionError(f"{arch} parity: K6 launches (prefill, {gen - 1} decode steps) "
                             f"{(prefill_launches, decode_launches)}, want {want_k6}")
    if cfg.use_mla:
        rec["absorbed_vs_up_projected_max_abs_err_per_step"] = absorbed_errs
    del params_dev, cache_d, params_cpu, cache_c
    torch.cuda.empty_cache()
    return dict(rec, k6_launches_prefill=prefill_launches, k6_launches_decode=decode_launches,
                k6_launches_per_decode_step=decode_launches // max(gen - 1, 1),
                max_abs_err_per_step=errs, max_abs_err=max(errs),
                cache_max_abs_err_per_step=cache_errs, logits_scale=float(log_c.abs().max()),
                greedy_tokens_agree=all(agree), tokens_agree_per_step=agree,
                rtol=LM_RTOL, atol=LM_ATOL)


class LMServe:
    """The LM serve cell on the card: the model the serve launcher builds
    (random weights from a seeded CUDA generator) and its inputs
    (``draw_inputs``: the prompts and, for a vlm, its image embeddings, for
    an encdec model its frames, ``extra``)."""

    def __init__(self, dev, cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, seed=0):
        import torch

        from repro_torch.launch.serve import draw_inputs
        from repro_torch.models.model import build_model

        self.cfg = cfg
        self.model = build_model(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.params = self.model.init(torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self.prompts, self.extra = draw_inputs(cfg, batch, prompt_len, seed, dev)

    @property
    def offset(self) -> int:
        """Positions before the prompt: a vlm's image patches."""
        return self.extra["image_embeds"].shape[1] if "image_embeds" in self.extra else 0

    def batch(self):
        return {"tokens": self.prompts, **self.extra}

    def prefill(self, gen=LM_GEN):
        return self.model.prefill(self.params, self.batch(),
                                  self.prompts.shape[1] + self.offset + gen)

    def decode_step(self, gen=LM_GEN):
        """A call that runs one decode step after a prefill: each call
        rewrites the same cache slot, so it can repeat."""
        import torch

        logits, caches = self.prefill(gen)
        batch, prompt_len = self.prompts.shape
        step = {"tokens": logits[:, -1].argmax(dim=-1)[:, None],
                "positions": torch.full((batch, 1), prompt_len + self.offset,
                                        dtype=torch.int64, device=logits.device)}
        return lambda: self.model.decode(self.params, step, caches)

    def k6_launches(self, which=(0,), call=None):
        """The K6 launches numbered ``which`` (in launch order) of one
        ``call()`` (default: one prefill), each as (q, k, v, causal, scale):
        the first is the first attention layer's (a hybrid's shared block at
        its first application; an encdec model's first encoder layer). Taken
        at the wrapper: the model calls K6 through ``ops``, so swapping the
        module's attribute sees every call; the port itself is unchanged."""
        import torch

        seen = {}
        with torch.no_grad(), k6_captured(seen, which):
            (call or self.prefill)()
        return [seen[i] for i in which]


def run_lm_serve(lm, gen=LM_GEN):
    """Prefill + ``gen - 1`` greedy decode steps through the serve
    launcher's ``generate``, after one untimed warm-up call."""
    import torch

    from repro_torch.launch.serve import generate

    cfg = lm.cfg
    generate(lm.model, lm.params, lm.prompts, 2, **lm.extra)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = generate(lm.model, lm.params, lm.prompts, gen, **lm.extra)
    peak = torch.cuda.max_memory_allocated()
    k6 = (out["kernel_launches"]["prefill"]["flash_attention"],
          out["kernel_launches"]["decode"]["flash_attention"])
    want = (k6_per_prefill(cfg), k6_per_decode_step(cfg) * (gen - 1))
    if k6 != want:
        raise AssertionError(f"{cfg.name} serving: K6 launches (prefill, {gen - 1} decode "
                             f"steps) {k6}, want {want}")
    if not out["logits_finite"]:
        raise AssertionError(f"{cfg.name} serving: non-finite logits")
    generated = out["generated"]
    batch, prompt_len = lm.prompts.shape
    if generated.shape != (batch, gen) or not ((0 <= generated) & (generated < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name} serving: generated {generated.shape}, "
                             f"ids out of range")
    return dict(arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype, batch=batch,
                prompt_len=prompt_len, image_patches=lm.offset, gen=gen, init_s=lm.init_s,
                prefill_ms=out["prefill_s"] * 1e3,
                prefill_tokens_per_s=batch * (prompt_len + lm.offset) / out["prefill_s"],
                decode_ms_per_token=out["decode_s_per_tok"] * 1e3,
                decode_tokens_per_s=batch / out["decode_s_per_tok"],
                k6_launches_per_prefill=k6[0], k6_launches_per_decode_step=k6[1] // (gen - 1),
                peak_mem_gb=peak / 1e9,
                param_gb=sum(t.numel() * t.element_size() for t in _leaves(lm.params)) / 1e9,
                logits_finite=True, sample=generated[0, :8].tolist())


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 7b: the MoE family (qwen3-moe-30b-a3b; deepseek-v2-lite's MoE layer)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def moe_layers_seen(on_call):
    """``on_call(p, cfg, x)`` at each ``moe_apply`` the model makes, with the
    layer's params and its input, before the layer runs. The transformer
    calls ``moe_apply`` through its module, so swapping the module's
    attribute sees every MoE layer; the port itself is unchanged."""
    from repro_torch.models import moe

    real = moe.moe_apply

    def spy(p, cfg, x, **kw):
        on_call(p, cfg, x)
        return real(p, cfg, x, **kw)

    moe.moe_apply = spy
    try:
        yield
    finally:
        moe.moe_apply = real


def moe_margin(r, k):
    """The smallest gap, over tokens, between the K-th and (K+1)-th router
    probability: how near a token came to another expert."""
    import torch

    top = torch.topk(r.probs, k + 1, dim=-1).values
    return float((top[..., k - 1] - top[..., k]).min())


def moe_routing_same(what, r_cpu, r_dev):
    """Top-k ids, positions and ``keep`` equal on both devices."""
    import torch

    for field in ("top_ids", "pos", "keep"):
        a, b = getattr(r_cpu, field), getattr(r_dev, field).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: routing differs in {field} at "
                                 f"{int((a != b).sum())} of {a.numel()} entries")


def dropped_share(routings) -> float:
    kept = sum(int(r.keep.sum()) for r in routings)
    total = sum(r.keep.numel() for r in routings)
    return 1.0 - kept / total


def parity_routing(cfg, seen, dev):
    """The MoE layers of a parity prefill (``seen``: each device's
    (params, layer input, routing), in layer order): each layer's routing on
    the CPU's input, recomputed on the card, has equal top-k ids, slots and
    ``keep``; beside it the CPU's least K-th/(K+1)-th probability gap,
    whether each device's routing of its own input agreed, and each device's
    dropped share of its own prefill (equal on both)."""
    import torch

    from repro_torch.models.moe import moe_route

    margins, own_same = [], []
    for i, ((p_c, x_c, r_c), (p_d, _, r_d)) in enumerate(zip(seen["cpu"], seen["card"])):
        moe_routing_same(f"{cfg.name} parity layer {i}", r_c, moe_route(p_d, cfg, x_c.to(dev)))
        margins.append(moe_margin(r_c, cfg.top_k))
        own_same.append(all(torch.equal(getattr(r_c, f), getattr(r_d, f).cpu())
                            for f in ("top_ids", "pos", "keep")))
    dropped = {where: dropped_share([r for _, _, r in seen[where]]) for where in seen}
    if dropped["cpu"] != dropped["card"]:
        raise AssertionError(f"{cfg.name} parity: dropped shares differ {dropped}")
    return dict(capacity_prefill=seen["cpu"][0][2].capacity, routing_same_input_equal=True,
                routing_own_input_equal=own_same, min_topk_margin_per_layer=margins,
                dropped_share=dropped,
                dropped_share_per_layer_cpu=[dropped_share([r]) for _, _, r in seen["cpu"]])


def run_deepseek_moe(dev, batch, seq_len, seed):
    """One ``moe_apply`` at deepseek-v2-lite's MoE width (64 routed experts
    top-6, 2 shared, expert d_ff 1,408) on a (batch, seq_len, 2048) fp32
    input, card against CPU: output and aux loss within the LM bounds,
    routing equal on the same input. Its attention (MLA) is not ported and
    not run."""
    import torch

    from repro_torch.models.moe import moe_apply, moe_init, moe_route

    cfg = arch_config(MOE_DEEPSEEK, dtype="float32")
    p_cpu = moe_init(torch.Generator().manual_seed(seed), cfg, torch.float32)
    p_dev = _params_to(p_cpu, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=gen)
    with torch.no_grad():
        y_c, aux_c = moe_apply(p_cpu, cfg, x)
        y_d, aux_d = moe_apply(p_dev, cfg, x.to(dev))
        r_c, r_d = moe_route(p_cpu, cfg, x), moe_route(p_dev, cfg, x.to(dev))
    err = check_close("deepseek_moe output", y_d, y_c, rtol=LM_RTOL, atol=LM_ATOL)
    aux_err = check_close("deepseek_moe aux", aux_d, aux_c, rtol=LM_RTOL, atol=LM_ATOL)
    moe_routing_same("deepseek_moe", r_c, r_d)
    dropped = {"cpu": dropped_share([r_c]), "card": dropped_share([r_d])}
    if dropped["cpu"] != dropped["card"]:
        raise AssertionError(f"deepseek_moe: dropped shares differ {dropped}")
    del p_dev
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, part="deepseek_moe", batch=batch, seq_len=seq_len,
                n_experts=cfg.n_experts, top_k=cfg.top_k, n_shared_experts=cfg.n_shared_experts,
                moe_d_ff=cfg.moe_d_ff, capacity=r_c.capacity, max_abs_err=err,
                output_scale=float(y_c.abs().max()), aux=float(aux_c), aux_abs_err=aux_err,
                min_topk_margin=moe_margin(r_c, cfg.top_k), dropped_share=dropped)


def moe_prefill_routing(lm):
    """The capacity and dropped share of one prefill of the serve cell, its
    routing recomputed on each MoE layer's input."""
    import torch

    from repro_torch.models.moe import moe_route

    counts = []

    def count(p, cfg, x):
        r = moe_route(p, cfg, x)
        counts.append((r.keep.sum(), r.keep.numel(), r.capacity))

    with torch.no_grad(), moe_layers_seen(count):
        lm.prefill()
    share = 1.0 - sum(int(k) for k, _, _ in counts) / sum(n for _, n, _ in counts)
    return dict(capacity_prefill=counts[0][2], dropped_share_prefill=share,
                dropped_share_per_layer=[1.0 - int(k) / n for k, n, _ in counts])


# the profiled MoE step's parts: each function, while profiled, runs inside
# a profiler range of its label; a kernel counts for the innermost range
# around the ATen op that launched it (K6, a ctypes launch, by its name)
MOE_PROFILE_LABELS = (
    ("repro_torch.models.moe", "moe_route", "moe.route"),
    ("repro_torch.models.moe", "moe_aux", "moe.aux"),
    ("repro_torch.models.moe", "moe_scatter", "moe.scatter"),
    ("repro_torch.models.moe", "moe_experts", "moe.experts"),
    ("repro_torch.models.moe", "moe_gather", "moe.gather"),
    ("repro_torch.models.attention", "gqa_apply", "attention"),
    ("repro_torch.models.attention", "gqa_qkv", "attention.qkv"),
    ("repro_torch.models.attention", "cached_attention", "attention.cached"),
    ("repro_torch.models.attention", "mla_apply", "mla"),
    ("repro_torch.models.attention", "mla_qkv", "mla.qkv"),
    ("repro_torch.models.attention", "_mla_absorbed", "mla.absorbed"),
    ("repro_torch.models.transformer", "_logits", "lm_head"),
)


@contextlib.contextmanager
def profiler_ranges(labels=MOE_PROFILE_LABELS):
    """Each listed module function wrapped in a ``record_function`` range."""
    import importlib

    from torch.profiler import record_function

    def ranged(fn, label):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    saved = []
    try:
        for module, name, label in labels:
            mod = importlib.import_module(module)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, ranged(getattr(mod, name), label))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's and CUTLASS's product kernels


def device_ms_by_range(prof, labels):
    """Device ms of a profile by the innermost range (of ``labels``) whose
    device-side span holds each kernel; K6 by its kernel name; what no
    range holds under ``rest``. A range's device span runs from the first
    to the last kernel launched inside it, and the kernels of one stream
    do not overlap, so the spans split the kernels without double counts.
    ``gemm_ms_by_range``: the part of each range's ms in product kernels."""
    from torch.autograd import DeviceType

    names = set(labels)
    spans = sorted((evt.time_range.end - evt.time_range.start, evt.time_range.start,
                    evt.time_range.end, evt.name) for evt in prof.events()
                   if evt.device_type == DeviceType.CUDA and evt.name in names)
    parts = dict.fromkeys(list(labels) + ["K6 flash_attention", "rest"], 0.0)
    gemm = dict.fromkeys(parts, 0.0)
    work = device_work(prof, names)
    for evt in work:
        start, end = evt.time_range.start, evt.time_range.end
        part = "K6 flash_attention" if "flash_" in evt.name else next(
            (name for _, s0, s1, name in spans if s0 <= start and end <= s1), "rest")
        parts[part] += end - start
        if part != "K6 flash_attention" and any(g in evt.name.lower() for g in GEMM_NAMES):
            gemm[part] += end - start
    return dict(total_ms=sum(parts.values()) / 1e3, range_spans=len(spans),
                by_range_ms={k: v / 1e3 for k, v in parts.items()},
                gemm_ms_by_range={k: v / 1e3 for k, v in gemm.items() if v})


def moe_split(ms, gemm):
    return dict(experts=ms["moe.experts"],
                dispatch=ms["moe.route"] + ms["moe.scatter"] + ms["moe.gather"],
                k6=ms["K6 flash_attention"],
                attention_proj=ms["attention"] + ms["attention.qkv"],
                cached_attention=ms["attention.cached"],
                mla_projections=ms["mla"] + ms["mla.qkv"],
                mla_absorbed=ms["mla.absorbed"],
                rest=ms["lm_head"] + ms["moe.aux"] + ms["rest"])


def profile_split(call, labels, split, top: int = 12):
    """``profile_call`` of one step, each listed function in a profiler
    range (``profiler_ranges``), its device time split by ``split``."""
    names = [label for _, _, label in labels]
    with profiler_ranges(labels):
        out = profile_call(call, top=top, keep_profile=True, ranges=set(names))
    prof = out.pop("profile")
    out["split"] = by_range = device_ms_by_range(prof, names)
    by_range["split_ms"] = split(by_range["by_range_ms"], by_range["gemm_ms_by_range"])
    return out


def profile_moe(call, top: int = 12):
    """``profile_call`` of one MoE step, its device time split by part."""
    return profile_split(call, MOE_PROFILE_LABELS, moe_split, top)


def run_moe_phases(dev, smi, counted, lm_kernels, gen):
    """Phase 7b: qwen3-moe-30b-a3b at full width, 2 layers, fp32, card
    against CPU with its routing held equal (and deepseek-v2-lite's MoE
    layer); then 12 of its 48 layers (``SERVE_DEPTH``) in bf16 through
    ``generate``, K6 once per
    layer of each prefill, one profiled prefill and decode step split by
    part, and K6 on layer 0's own q, k, v. ``counted`` is ``main``'s: the
    launches of the parity run and of ``generate`` join the main path's."""
    import torch

    moe_parity, moe_parity_launches = counted(
        lm_kernels, "the MoE parity run",
        lambda: run_parity(dev, MOE_ARCH, MOE_PARITY_LAYERS, LM_PARITY_PROMPT))
    emit(dict(phase="lm_moe_parity", card=smi, launches=moe_parity_launches, **moe_parity))
    deepseek = run_deepseek_moe(dev, LM_PARITY_BATCH, LM_PARITY_PROMPT, seed=7)
    emit(dict(phase="lm_moe_parity", card=smi, **deepseek))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe_lm = LMServe(dev, arch_config(MOE_ARCH, n_layers=SERVE_DEPTH.get(MOE_ARCH)))
    init_peak = torch.cuda.max_memory_allocated()
    moe_serve, moe_launches = counted(lm_kernels, "MoE serving",
                                      lambda: run_lm_serve(moe_lm))
    moe_serve.update(init_peak_gb=init_peak / 1e9, **moe_prefill_routing(moe_lm))
    with torch.no_grad():
        moe_prefill = profile_moe(lambda: moe_lm.prefill())
        moe_decode = profile_moe(moe_lm.decode_step())
    qkv = moe_lm.k6_launches()[0]
    del moe_lm
    torch.cuda.empty_cache()
    # K6 on layer 0's own q, k, v, once the weights are freed (its plain
    # version's fp32 scores take 4.3 GB a copy)
    layer0 = check_k6_on(qkv, gen)
    del qkv
    emit(dict(phase="lm_moe_serve", card=smi, launches=moe_launches, k6_layer0=layer0,
              **moe_serve))
    emit(dict(phase="profile_lm_moe", call=f"one {MOE_ARCH} prefill", batch=LM_BATCH,
              prompt_len=LM_PROMPT, card=smi, **moe_prefill))
    emit(dict(phase="profile_lm_moe_decode", call=f"one {MOE_ARCH} decode step",
              batch=LM_BATCH, cache_len=LM_PROMPT + LM_GEN, card=smi, **moe_decode))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7c: MLA (deepseek-v2-lite-16b: its attention in every layer)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def mla_decode_up_projected():
    """The model's MLA decode up-projects the cache to per-head K/V and runs
    ``cached_attention`` (``absorbed_decode=False``) while this is open. The
    transformer calls ``mla_apply`` through its module, as ``moe_layers_seen``
    relies on; the port itself is unchanged."""
    from repro_torch.models import attention

    real = attention.mla_apply

    def up_projected(*args, **kw):
        return real(*args, **kw, absorbed_decode=False)

    attention.mla_apply = up_projected
    try:
        yield
    finally:
        attention.mla_apply = real


def run_mla_phases(dev, smi, counted, lm_kernels, gen):
    """Phase 7c: deepseek-v2-lite-16b at full width, 2 layers, fp32, card
    against CPU (``lm_mla_parity``); then the full 27-layer model in bf16
    through ``generate``, K6 once per layer of each prefill at q . k 192 and
    v 128, none in the absorbed decode (``lm_mla_serve``), one profiled
    prefill and decode step split by part, and K6 on the prefix layer's own
    q, k, v. ``counted`` is ``main``'s: these launches join the main path's."""
    import torch

    parity, parity_launches = counted(
        lm_kernels, "the MLA parity run",
        lambda: run_parity(dev, MOE_DEEPSEEK, MOE_PARITY_LAYERS, LM_PARITY_PROMPT))
    emit(dict(phase="lm_mla_parity", card=smi, launches=parity_launches, **parity))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LMServe(dev, arch_config(MOE_DEEPSEEK))
    init_peak = torch.cuda.max_memory_allocated()
    serve, launches = counted(lm_kernels, "MLA serving", lambda: run_lm_serve(lm))
    serve.update(init_peak_gb=init_peak / 1e9, **moe_prefill_routing(lm))
    with torch.no_grad():
        prefill = profile_moe(lambda: lm.prefill())
        decode = profile_moe(lm.decode_step())
    qkv = lm.k6_launches()[0]
    del lm
    torch.cuda.empty_cache()
    # K6 on the prefix layer's own q, k, v (192/128), once the weights are freed
    layer0 = check_k6_on(qkv, gen)
    del qkv
    emit(dict(phase="lm_mla_serve", card=smi, launches=launches, k6_layer0=layer0, **serve))
    emit(dict(phase="profile_lm_mla", call=f"one {MOE_DEEPSEEK} prefill", batch=LM_BATCH,
              prompt_len=LM_PROMPT, card=smi, **prefill))
    emit(dict(phase="profile_lm_mla_decode", call=f"one {MOE_DEEPSEEK} decode step",
              batch=LM_BATCH, cache_len=LM_PROMPT + LM_GEN, card=smi, **decode))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7d: the vlm image prefix, the Mamba2 LM and the hybrid
# ---------------------------------------------------------------------------


# the profiled hybrid step's parts (``device_ms_by_range``): the SSD scan,
# the causal conv and the rest of each Mamba2 block (its in- and
# out-projections apart by kernel name), the shared block, its attention
HYBRID_PROFILE_LABELS = (
    ("repro_torch.models.ssm", "ssd_chunked", "ssm.ssd"),
    ("repro_torch.models.ssm", "_causal_conv", "ssm.conv"),
    ("repro_torch.models.ssm", "ssm_apply", "ssm"),
    ("repro_torch.models.hybrid", "_shared_block", "shared"),
    ("repro_torch.models.attention", "gqa_apply", "attention"),
    ("repro_torch.models.attention", "gqa_qkv", "attention.qkv"),
    ("repro_torch.models.attention", "cached_attention", "attention.cached"),
    ("repro_torch.models.ssm_lm", "logits", "lm_head"),
)


def hybrid_split(ms, gemm):
    """SSD einsums, conv, the Mamba2 blocks' projections (in and out), the
    shared block's products (w_concat, q/k/v, wo, MLP), K6, the LM head and
    the rest (gating, norms, softplus, the decode's recurrent step, the
    cached attention, residuals)."""
    shared = ("shared", "attention", "attention.qkv")
    ssm_proj = gemm.get("ssm", 0.0)
    shared_gemm = sum(gemm.get(k, 0.0) for k in shared)
    return dict(ssd_einsums=ms["ssm.ssd"], conv=ms["ssm.conv"], ssm_projections=ssm_proj,
                shared_block_products=shared_gemm, k6=ms["K6 flash_attention"],
                lm_head=ms["lm_head"],
                rest=(ms["ssm"] - ssm_proj) + sum(ms[k] for k in shared) - shared_gemm
                + ms["attention.cached"] + ms["rest"])


def silu_cost(lm):
    """What the Mamba2 block's SiLU costs against ``F.silu`` in the served
    model ``lm``. The block's ``_silu`` computes x * 1/(1 + exp(-x)) with
    each step rounded to the input dtype, as XLA expands ``jax.nn.silu``
    (``F.silu`` rounds once, and the bf16 block then leaves the reference's
    bound). Device ms of each on one prefill's two SiLU operands (the conv's
    output and the gate z), and host-issued ms of one prefill and one
    decode step with each swapped in, in the order ours, ``F.silu``,
    ``F.silu``, ours."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import ssm

    ours, cfg = ssm._silu, lm.cfg
    gen = torch.Generator(device=lm.prompts.device).manual_seed(11)
    operands = {}
    for name, width in (("conv", cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state),
                        ("gate", cfg.d_inner)):
        x = torch.randn((LM_BATCH, LM_PROMPT, width), generator=gen,
                        device=lm.prompts.device).to(cfg.tdtype)
        operands[name] = dict(width=width, ms=time_ms(lambda: ours(x)),
                              f_silu_ms=time_ms(lambda: F.silu(x)))
        del x
    model = {"ours": [], "f_silu": []}
    for name in ("ours", "f_silu", "f_silu", "ours"):
        ssm._silu = ours if name == "ours" else F.silu
        try:
            with torch.no_grad():
                model[name].append(dict(prefill_ms=wrapper_ms(lm.prefill, iters=3, warmup=1),
                                        decode_ms=wrapper_ms(lm.decode_step(), iters=10)))
        finally:
            ssm._silu = ours
    return dict(operands=operands, model=model, blocks=cfg.n_layers)


def run_family_phases(dev, smi, counted, lm_kernels, gen):
    """Phase 7d: internvl2-2b (vlm: 256 image patches before the prompt),
    mamba2-1.3b (ssm) and zamba2-2.7b (hybrid), each at full width, 2
    layers (zamba2: 12, two applications of its shared block), fp32, card
    against CPU (``lm_vlm_parity``, ``lm_ssm_parity`` at a prompt of 128 and
    a ragged one, ``lm_hybrid_parity``); then each at full width in bf16
    (mamba2 and zamba2 at ``SERVE_DEPTH``) through ``generate``
    (``lm_vlm_serve``: K6 once per layer; ``lm_ssm_serve``: no K6;
    ``lm_hybrid_serve``: K6 at D = DV = 80 once per application of the
    shared block, 2 at 12 blocks), K6 held against its plain
    version on the q, k, v a prefill passes its first K6 launch (the
    hybrid's: the shared block's at its first application), mamba2's SiLU
    against ``F.silu`` (``silu_cost``), and the hybrid's prefill and decode
    step profiled (``profile_lm_hybrid``). ``counted`` is ``main``'s: these
    launches join the main path's."""
    import torch

    for phase, arch, runs, kernels in (
            ("lm_vlm_parity", VLM_ARCH, [(2, LM_PARITY_PROMPT)], lm_kernels),
            ("lm_ssm_parity", SSM_ARCH, [(2, LM_PARITY_PROMPT), (2, SSM_RAGGED_PROMPT)], ()),
            ("lm_hybrid_parity", HYBRID_ARCH, [(HYBRID_PARITY_LAYERS, LM_PARITY_PROMPT)],
             lm_kernels)):
        for n_layers, prompt_len in runs:
            rec, launches = counted(kernels, f"the {arch} parity run",
                                    lambda: run_parity(dev, arch, n_layers, prompt_len))
            emit(dict(phase=phase, card=smi, launches=launches, **rec))
        torch.cuda.empty_cache()

    for phase, arch, kernels in (("lm_vlm_serve", VLM_ARCH, lm_kernels),
                                 ("lm_ssm_serve", SSM_ARCH, ()),
                                 ("lm_hybrid_serve", HYBRID_ARCH, lm_kernels)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm = LMServe(dev, arch_config(arch, n_layers=SERVE_DEPTH.get(arch)))
        init_peak = torch.cuda.max_memory_allocated()
        serve, launches = counted(kernels, f"{arch} serving", lambda: run_lm_serve(lm))
        serve.update(init_peak_gb=init_peak / 1e9)
        profiles = {}
        if arch == HYBRID_ARCH:
            with torch.no_grad():
                profiles = dict(prefill=profile_split(lambda: lm.prefill(),
                                                      HYBRID_PROFILE_LABELS, hybrid_split),
                                decode=profile_split(lm.decode_step(),
                                                     HYBRID_PROFILE_LABELS, hybrid_split))
        if arch == SSM_ARCH:
            serve["silu_cost"] = silu_cost(lm)
        qkv = lm.k6_launches()[0] if k6_per_prefill(lm.cfg) else None
        del lm
        torch.cuda.empty_cache()
        if qkv is not None:
            # K6 on the first attention's own q, k, v, once the weights are freed
            serve["k6_layer0"] = check_k6_on(qkv, gen)
            del qkv
        emit(dict(phase=phase, card=smi, launches=launches, **serve))
        for part, prof in profiles.items():
            emit(dict(phase="profile_lm_hybrid", part=part,
                      call=f"one {HYBRID_ARCH} {'prefill' if part == 'prefill' else 'decode step'}",
                      batch=LM_BATCH, prompt_len=LM_PROMPT, card=smi, **prof))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7e: the encoder-decoder (whisper-base) and the dense presets
# ---------------------------------------------------------------------------


# the profiled whisper step's parts (``device_ms_by_range``): the encoder
# (its norms, projections and residuals; its MLPs and K6 apart), the
# decoder's self-attention, the cross-attention with its k/v recompute from
# the memory apart, every GELU MLP
ENCDEC_PROFILE_LABELS = (
    ("repro_torch.models.encdec", "encode", "encoder"),
    ("repro_torch.models.encdec", "gelu_mlp_apply", "mlp"),
    ("repro_torch.models.attention", "gqa_apply", "attention"),
    ("repro_torch.models.attention", "cached_attention", "attention.cached"),
    ("repro_torch.models.attention", "cross_attn_apply", "cross"),
    ("repro_torch.models.attention", "cross_attn_kv", "cross.kv"),
)


def encdec_split(ms, gemm):
    """Encoder, decoder self-attention, cross-attention (its k/v recompute
    also alone), the MLPs with their GELU, K6 and the rest (embedding,
    sinusoids, decoder norms, the tied head)."""
    return dict(encoder=ms["encoder"],
                decoder_self_attention=ms["attention"] + ms["attention.cached"],
                cross_attention=ms["cross"] + ms["cross.kv"], cross_kv_recompute=ms["cross.kv"],
                mlp_gelu=ms["mlp"], k6=ms["K6 flash_attention"], rest=ms["rest"])


def gelu_cost(lm):
    """What the GELU MLP's reference-exact tanh GELU (``layers.gelu_tanh``:
    each step rounded to the input dtype, as XLA rounds
    ``jax.nn.gelu(approximate=True)``) costs against ``F.gelu(approximate=
    "tanh")`` in the served whisper ``lm``: device ms of each on the encoder's
    and the prefill decoder's MLP operand, and host-issued ms of one prefill
    and one decode step with each swapped in, in the order ours,
    ``F.gelu``, ``F.gelu``, ours."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers

    ours, cfg = layers.gelu_tanh, lm.cfg
    f_gelu = lambda x: F.gelu(x, approximate="tanh")
    gen = torch.Generator(device=lm.prompts.device).manual_seed(12)
    operands = {}
    for name, rows in (("encoder", cfg.n_frames), ("decoder", lm.prompts.shape[1])):
        x = torch.randn((lm.prompts.shape[0], rows, cfg.d_ff), generator=gen,
                        device=lm.prompts.device).to(cfg.tdtype)
        operands[name] = dict(shape=list(x.shape), ms=time_ms(lambda: ours(x)),
                              f_gelu_ms=time_ms(lambda: f_gelu(x)))
        del x
    model = {"ours": [], "f_gelu": []}
    for name in ("ours", "f_gelu", "f_gelu", "ours"):
        layers.gelu_tanh = ours if name == "ours" else f_gelu
        try:
            with torch.no_grad():
                model[name].append(dict(prefill_ms=wrapper_ms(lm.prefill, iters=5, warmup=1),
                                        decode_ms=wrapper_ms(lm.decode_step(), iters=10)))
        finally:
            layers.gelu_tanh = ours
    return dict(operands=operands, model=model,
                mlps_per_prefill=(cfg.n_enc_layers or cfg.n_layers) + cfg.n_layers)


def run_encdec_phases(dev, smi, counted, lm_kernels, gen):
    """Phase 7e, encdec: whisper-base at full width and depth (6 + 6
    layers), fp32, card against CPU, logits and every cache with the
    encoder's memory, both devices also against float64, K6 (18, 6) a step
    (``lm_encdec_parity``); then in bf16 through ``generate``, batch 8 x
    (1,500 frames, prompt 2,048) + 32 tokens, K6 18 per prefill and 6 per
    decode step (``lm_encdec_serve``), K6 held against its plain version on
    the q, k, v (causal flag, scale) of the first launch of each use (the
    encoder's, the decoder's self-attention, the cross-attention in the
    prefill and in a decode step), the tanh GELU against ``F.gelu``
    (``gelu_cost``), and one profiled prefill and decode step split by part
    (``profile_lm_encdec``). ``counted`` is ``main``'s: these launches join
    the main path's."""
    import torch

    rec, launches = counted(lm_kernels, "the whisper parity run",
                            lambda: run_parity(dev, ENCDEC_ARCH, None, LM_PARITY_PROMPT))
    emit(dict(phase="lm_encdec_parity", card=smi, launches=launches, **rec))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LMServe(dev, arch_config(ENCDEC_ARCH))
    init_peak = torch.cuda.max_memory_allocated()
    serve, launches = counted(lm_kernels, "whisper serving", lambda: run_lm_serve(lm))
    serve.update(init_peak_gb=init_peak / 1e9, frames=lm.cfg.n_frames,
                 gelu_cost=gelu_cost(lm))
    with torch.no_grad():
        profiles = dict(prefill=profile_split(lambda: lm.prefill(), ENCDEC_PROFILE_LABELS,
                                              encdec_split),
                        decode=profile_split(lm.decode_step(), ENCDEC_PROFILE_LABELS,
                                             encdec_split))
    n_enc = lm.cfg.n_enc_layers
    uses = dict(zip(("encoder", "decoder_self", "cross_prefill"),
                    lm.k6_launches(which=(0, n_enc, n_enc + 1))))
    uses["cross_decode"] = lm.k6_launches(call=lm.decode_step())[0]
    del lm
    torch.cuda.empty_cache()
    serve["k6_by_use"] = {use: check_k6_on(launch, gen) for use, launch in uses.items()}
    del uses
    emit(dict(phase="lm_encdec_serve", card=smi, launches=launches, **serve))
    for part, prof in profiles.items():
        emit(dict(phase="profile_lm_encdec", part=part,
                  call=f"one {ENCDEC_ARCH} {'prefill' if part == 'prefill' else 'decode step'}",
                  batch=LM_BATCH, prompt_len=LM_PROMPT, card=smi, **prof))
    torch.cuda.empty_cache()


def run_dense_presets(dev, smi, counted, lm_kernels, gen):
    """Phase 7e, the dense presets not served before (granite-3-2b,
    chatglm3-6b, qwen2.5-14b): each at full width, 2 layers, fp32, card
    against CPU and float64 (``lm_dense_parity``), then at full width and
    12 layers (``SERVE_DEPTH``) in bf16 through ``generate``
    (``lm_dense_serve``), K6 once per
    layer, held against its plain version on the first layer's own q, k, v
    at the model's scale. ``counted`` is ``main``'s: these launches join the
    main path's."""
    import torch

    for arch in DENSE_PRESETS:
        rec, launches = counted(lm_kernels, f"the {arch} parity run",
                                lambda: run_parity(dev, arch, LM_PARITY_LAYERS,
                                                   LM_PARITY_PROMPT))
        emit(dict(phase="lm_dense_parity", card=smi, launches=launches, **rec))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm = LMServe(dev, arch_config(arch, n_layers=SERVE_DEPTH.get(arch)))
        init_peak = torch.cuda.max_memory_allocated()
        serve, launches = counted(lm_kernels, f"{arch} serving", lambda: run_lm_serve(lm))
        serve.update(init_peak_gb=init_peak / 1e9)
        launch = lm.k6_launches()[0]
        del lm
        torch.cuda.empty_cache()
        # K6 on the first layer's own q, k, v, once the weights are freed
        serve["k6_layer0"] = check_k6_on(launch, gen)
        del launch
        emit(dict(phase="lm_dense_serve", card=smi, launches=launches, **serve))
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7e': tensor-parallel serving (two gloo ranks sharing the card) and the
# production-mesh dry-run
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def routing_recorded(calls):
    """``moe_route`` recording each call's top-k ids, slots and keep (and
    its least top-k probability gap) in ``calls`` while the block runs."""
    import torch

    from repro_torch.models import moe as MOE

    real = MOE.moe_route

    def route(*a, **k):
        r = real(*a, **k)
        with torch.no_grad():
            gap = moe_margin(r, r.top_ids.shape[-1])
        calls.append(dict(top_ids=r.top_ids.cpu(), pos=r.pos.cpu(), keep=r.keep.cpu(), gap=gap))
        return r

    MOE.moe_route = route
    try:
        yield
    finally:
        MOE.moe_route = real


def _routing_digest(calls):
    import hashlib

    h = hashlib.sha256()
    for c in calls:
        for f in ("top_ids", "pos", "keep"):
            h.update(c[f].numpy().tobytes())
    return h.hexdigest()


def _k6_launches():
    from repro_torch.kernels import ops

    return ops.launch_counts()["flash_attention"]


def _tp_run(model, params, batch_in, max_len, steps, tokens=None):
    """The prefill and ``steps`` decode steps; ``tokens`` (steps, B) the ids
    to feed (else each step's greedy ids). Returns every step's last-position
    logits, the greedy ids, the caches after the prefill and after the last
    step (kept by reference: the decode writes the KV caches in place, so
    the prefill's are cloned), K6 launches of the prefill and of the decode
    steps."""
    import torch

    from repro_torch.sharding import ctx

    mesh = (ctx.current() or {}).get("mesh")
    b, p = batch_in["tokens"].shape
    offset = batch_in["image_embeds"].shape[1] if "image_embeds" in batch_in else 0
    k0 = _k6_launches()
    if mesh is not None:
        mesh.reset_counts()
    logits, caches = model.prefill(params, batch_in, max_len)
    torch.cuda.synchronize()
    out = dict(k6_prefill=_k6_launches() - k0, logits=[logits[:, -1].float().cpu()],
               collectives=[mesh.collective_counts()] if mesh is not None else [])
    out["caches_prefill"] = _clone_caches(caches)
    greedy = [logits[:, -1].argmax(dim=-1)]
    k0 = _k6_launches()
    for i in range(steps):
        tok = greedy[-1] if tokens is None else tokens[i].to(logits.device)
        pos = torch.full((b, 1), p + offset + i, dtype=torch.int64, device=logits.device)
        if mesh is not None:
            mesh.reset_counts()
        logits, caches = model.decode(params, {"tokens": tok[:, None], "positions": pos},
                                      caches)
        if mesh is not None:
            out["collectives"].append(mesh.collective_counts())
        out["logits"].append(logits[:, -1].float().cpu())
        greedy.append(logits[:, -1].argmax(dim=-1))
    torch.cuda.synchronize()
    out.update(k6_decode=_k6_launches() - k0, greedy=torch.stack(greedy).cpu(),
               caches_last=caches)
    return out


def _clone_caches(caches):
    if isinstance(caches, dict):
        return {k: _clone_caches(v) for k, v in caches.items()}
    if isinstance(caches, list):
        return [_clone_caches(v) for v in caches]
    if hasattr(caches, "_fields"):
        return type(caches)(*(v if isinstance(v, int) else v.clone()
                              for v in (getattr(caches, f) for f in caches._fields)))
    return caches.clone()


def _tp_parity_case(mesh, arch, n_layers, batch=LM_PARITY_BATCH, prompt_len=LM_PARITY_PROMPT,
                    gen=LM_PARITY_GEN, seed=7):
    """One arch on the rank: the whole model from the seed on the card, cut
    to this rank's share; the prefill and ``gen - 1`` greedy decode steps
    under the mesh's context, the caches gathered back to one device's
    layout; then, on rank 0, the one-device card run of the same weights fed
    the same ids, held at the LM bounds (logits every step, every cache
    after the prefill and after the last step), its routing and greedy ids
    against the ranks'. K6 launches and collectives counted."""
    import torch

    from repro_torch.launch.serve import draw_inputs
    from repro_torch.models.model import build_model
    from repro_torch.sharding import ctx, tp

    cfg = arch_config(arch, n_layers=n_layers, dtype="float32")
    model = build_model(cfg)
    dev = mesh.device
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    local = tp.shard_lm_params(cfg, params, mesh)
    if mesh.rank:
        del params
    prompts, extra = draw_inputs(cfg, batch, prompt_len, seed, dev)
    batch_in = {"tokens": prompts, **extra}
    offset = extra["image_embeds"].shape[1] if "image_embeds" in extra else 0
    max_len = prompt_len + offset + gen
    tp_routing, routing = [], []
    t0 = time.perf_counter()
    with torch.no_grad(), ctx.activation_sharding(mesh, dp="data", tp="model"), \
            routing_recorded(tp_routing):
        run = _tp_run(model, local, batch_in, max_len, gen - 1)
        gathered = {k: tp.gather_caches(cfg, mesh, run[k], batch)
                    for k in ("caches_prefill", "caches_last")}
    tp_s = time.perf_counter() - t0
    want_k6 = (k6_per_prefill(cfg), k6_per_decode_step(cfg) * (gen - 1))
    if (run["k6_prefill"], run["k6_decode"]) != want_k6:
        raise AssertionError(f"{arch} tp parity, rank {mesh.rank}: K6 launches "
                             f"{(run['k6_prefill'], run['k6_decode'])}, want {want_k6}")
    want_coll = [tp.collectives_per_call(cfg, mesh.shape["model"], prefill=i == 0)
                 for i in range(gen)]
    got_coll = [c.get("model", {}).get("all_reduce", 0) for c in run["collectives"]]
    if got_coll != want_coll:
        raise AssertionError(f"{arch} tp parity, rank {mesh.rank}: collectives {got_coll}, "
                             f"want {want_coll}")
    rec = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers, batch=batch,
               prompt_len=prompt_len, steps=gen, rank=mesh.rank,
               k6_launches_prefill=run["k6_prefill"],
               k6_launches_per_decode_step=run["k6_decode"] // max(gen - 1, 1),
               collectives_prefill=got_coll[0], collectives_per_decode_step=got_coll[1],
               routing_digest=_routing_digest(tp_routing), tp_s=tp_s,
               greedy=run["greedy"].tolist())
    del local, run["caches_prefill"], run["caches_last"]
    if mesh.rank == 0:
        with torch.no_grad(), routing_recorded(routing):
            one = _tp_run(model, params, batch_in, max_len, gen - 1,
                          tokens=torch.tensor(rec["greedy"]))
        del params
        errs = [check_close(f"{arch} tp vs one device, logits step {i}", g, w,
                            rtol=LM_RTOL, atol=LM_ATOL)
                for i, (g, w) in enumerate(zip(run["logits"], one["logits"]))]
        cache_errs = [cache_err(f"{arch} tp vs one device, caches after the {when}",
                                gathered[k], one[k])
                      for when, k in (("prefill", "caches_prefill"),
                                      ("last step", "caches_last"))]
        # one device's own greedy ids against the ranks' (fed to both)
        agree = (one["greedy"] == run["greedy"]).all(dim=1).tolist()
        flips = sum(int((a[f] != b[f]).any()) for a, b in zip(tp_routing, routing)
                    for f in ("top_ids", "pos", "keep"))
        if len(tp_routing) != len(routing) or flips:
            raise AssertionError(f"{arch} tp parity: routing differs from one device's "
                                 f"({flips} fields of {len(routing)} calls)")
        rec.update(max_abs_err_per_step=errs, max_abs_err=max(errs),
                   cache_max_abs_err=cache_errs, greedy_tokens_agree=all(agree),
                   tokens_agree_per_step=agree, moe_calls=len(routing),
                   least_topk_gap=min((c["gap"] for c in routing), default=None),
                   one_device_k6=(one["k6_prefill"], one["k6_decode"]),
                   rtol=LM_RTOL, atol=LM_ATOL)
    return rec


@contextlib.contextmanager
def k6_captured(seen, which=(0,)):
    """Records the K6 launches numbered ``which`` (in launch order) as (q,
    k, v, causal, scale) in ``seen``: the model calls K6 through ``ops``, so
    swapping the module's attribute sees every call; the port itself is
    unchanged."""
    from repro_torch.kernels import ops

    real, n = ops.flash_attention, [0]

    def spy(q, k, v, *, causal, scale=None):
        if n[0] in which:
            seen[n[0]] = (q, k, v, causal, scale)
        n[0] += 1
        return real(q, k, v, causal=causal, scale=scale)

    ops.flash_attention = spy
    try:
        yield
    finally:
        ops.flash_attention = real


def logit_errs(got, want, rtol=TP16_RTOL, atol=TP16_ATOL):
    """Over every step's logits: the largest |got - want|, its root mean
    square, the largest |got - want| / (atol + rtol |want|) (1 is the
    bound) and ``want``'s largest magnitude."""
    import torch

    got, want = torch.stack([torch.as_tensor(g) for g in got]), torch.stack(
        [torch.as_tensor(w) for w in want])
    d = (got - want).abs()
    return dict(max_abs_err=float(d.max()), rms_err=float(d.square().mean().sqrt()),
                bound_excess=float((d / (atol + rtol * want.abs())).max()),
                scale=float(want.abs().max()))


def tp_serve_reference(dev, seed=0):
    """The one-device serve of the tensor-parallel serve cell, on the card
    in this process: its bf16 greedy ids (B, gen) and each step's logits,
    the same steps fed the same ids with the weights in fp32 (the model the
    bf16 serves round), and one warm-up and one timed ``generate``."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    lm = LMServe(dev, arch_config(TP_SERVE_ARCH), batch=TP_SERVE_BATCH,
                 prompt_len=TP_SERVE_PROMPT, seed=seed)
    max_len = TP_SERVE_PROMPT + TP_SERVE_GEN
    with torch.no_grad():
        run = _tp_run(lm.model, lm.params, lm.batch(), max_len, TP_SERVE_GEN - 1)
    generate(lm.model, lm.params, lm.prompts, 2)                  # warm-up
    out = generate(lm.model, lm.params, lm.prompts, TP_SERVE_GEN)
    if not (out["generated"] == run["greedy"].T.numpy()).all():
        raise AssertionError("the one-device serve's ids differ from its own greedy run")
    ref = dict(generated=out["generated"], logits=[t.numpy() for t in run["logits"]])
    prompts = lm.prompts
    timing = dict(prefill_ms=out["prefill_s"] * 1e3,
                  decode_ms_per_token=out["decode_s_per_tok"] * 1e3,
                  k6_launches_per_prefill=out["kernel_launches"]["prefill"]["flash_attention"])
    params32 = _params_to(lm.params, torch.float32)
    del lm, run
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(arch_config(TP_SERVE_ARCH), dtype="float32"))
    with torch.no_grad():
        run32 = _tp_run(model32, params32, {"tokens": prompts}, max_len,
                        TP_SERVE_GEN - 1, tokens=torch.from_numpy(ref["generated"].T.copy()))
    ref["fp32_logits"] = [t.numpy() for t in run32["logits"]]
    del params32, run32
    torch.cuda.empty_cache()
    return ref, timing


def _tp_serve_case(mesh, ref, seed=0):
    """yi-6b at full width and depth in bf16 on the rank: the whole model
    from the seed, cut to its share (16 q heads, 2 kv heads); one warm-up
    and one timed ``generate`` (prefill ms, decode ms a token, the rank's
    peak GB, greedy ids against the one-device serve's, ``ref``); the
    prefill and decode steps fed the one-device ids, their logits within the
    bf16 bound of its on rank 0; a prefill and ``TP_COLLECTIVE_STEPS``
    decode steps with the collectives timed (the device synchronized around
    each); on rank 0, the prefill's first K6 launch against its plain
    version once the weights are freed."""
    import torch

    from repro_torch.launch.serve import draw_inputs, generate
    from repro_torch.models.model import build_model
    from repro_torch.sharding import ctx, tp

    cfg = arch_config(TP_SERVE_ARCH)
    model = build_model(cfg)
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats()
    params = tp.shard_lm_params(cfg, model.init(torch.Generator(device=dev).manual_seed(seed)),
                                mesh)
    torch.cuda.empty_cache()
    init_peak = torch.cuda.max_memory_allocated()
    prompts, _ = draw_inputs(cfg, TP_SERVE_BATCH, TP_SERVE_PROMPT, seed, dev)
    batch_in, max_len = {"tokens": prompts}, TP_SERVE_PROMPT + TP_SERVE_GEN
    rec = dict(rank=mesh.rank, mesh=dict(mesh.shape, backend=mesh.backend),
               init_peak_gb=init_peak / 1e9,
               param_gb=sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9)
    launch = {}
    with ctx.activation_sharding(mesh, dp="data", tp="model"):
        generate(model, params, prompts, 2)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = generate(model, params, prompts, TP_SERVE_GEN)
        peak = torch.cuda.max_memory_allocated()
        k6 = (out["kernel_launches"]["prefill"]["flash_attention"],
              out["kernel_launches"]["decode"]["flash_attention"])
        if k6 != (k6_per_prefill(cfg), 0) or not out["logits_finite"]:
            raise AssertionError(f"tp serving, rank {mesh.rank}: K6 {k6}, finite "
                                 f"{out['logits_finite']}")
        agree = (out["generated"] == ref["generated"]).all(axis=0)
        rec.update(prefill_ms=out["prefill_s"] * 1e3,
                   decode_ms_per_token=out["decode_s_per_tok"] * 1e3,
                   prefill_tokens_per_s=TP_SERVE_BATCH * TP_SERVE_PROMPT / out["prefill_s"],
                   k6_launches_per_prefill=k6[0], k6_launches_per_decode_step=0,
                   collectives=out["collectives"], peak_mem_gb=peak / 1e9,
                   greedy_tokens_agree=bool(agree.all()), tokens_agree_per_step=agree.tolist())
        with torch.no_grad(), k6_captured(launch):
            run = _tp_run(model, params, batch_in, max_len, TP_SERVE_GEN - 1,
                          tokens=torch.from_numpy(ref["generated"].T.copy()))
        tp_logits = [t.numpy() for t in run["logits"]]
        del run
        mesh.timed = True
        try:
            with torch.no_grad():
                mesh.reset_counts()
                logits, caches = model.prefill(params, batch_in, max_len)
                prefill_s = sum(mesh.seconds.values())
                mesh.reset_counts()
                for i in range(TP_COLLECTIVE_STEPS):
                    pos = torch.full((TP_SERVE_BATCH, 1), TP_SERVE_PROMPT + i, dtype=torch.int64,
                                     device=dev)
                    logits, caches = model.decode(
                        params, {"tokens": logits[:, -1].argmax(dim=-1)[:, None],
                                 "positions": pos}, caches)
                torch.cuda.synchronize()
                decode_s = sum(mesh.seconds.values()) / TP_COLLECTIVE_STEPS
        finally:
            mesh.timed = False
        del logits, caches
        rec.update(collective_ms_prefill=prefill_s * 1e3,
                   collective_ms_per_decode_step=decode_s * 1e3)
    q, k = launch[0][0], launch[0][1]
    if (q.shape[1], k.shape[1]) != (cfg.n_heads // TP_SIZE, cfg.n_kv_heads // TP_SIZE):
        raise AssertionError(f"tp serving: K6 ran {q.shape[1]} q and {k.shape[1]} kv heads "
                             f"on rank {mesh.rank}")
    rec["k6_heads"] = dict(q=q.shape[1], kv=k.shape[1])
    del params
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        rec["k6_layer0"] = check_k6_on(launch[0], torch.Generator().manual_seed(0))
        rec["logits"] = tp_logits
    return rec


def _tp_rank(mesh, parity_cases, serve_ref):
    """One rank of the tensor-parallel phases (a spawned process): every
    parity case, then the serve cell."""
    import torch

    from repro_torch import strict_fp32

    strict_fp32()
    parity = []
    for arch, n_layers in parity_cases:
        parity.append(_tp_parity_case(mesh, arch, n_layers))
        torch.cuda.empty_cache()
    return dict(parity=parity, serve=_tp_serve_case(mesh, serve_ref))


def run_tp_phases(dev, smi, counted, lm_kernels):
    """Phase 7e', tensor-parallel serving: the one-device bf16 serve of the
    serve cell here, then one spawn of ``TP_SIZE`` gloo ranks sharing the
    card on a (1, 2) host mesh (``run_ranks`` with ``make_host_mesh``) for
    ``lm_tp_parity`` (all ten archs) and ``lm_tp_serve``. The ranks' routing
    and greedy ids are held equal here. The ranks' K6 launches are theirs,
    counted and checked in each rank; this process's (the reference serve)
    join the main path's through ``counted``."""
    import functools

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import run_ranks

    t0 = time.perf_counter()
    (ref, one_device), launches = counted(lm_kernels, "the one-device tp serve reference",
                                          lambda: tp_serve_reference(dev))
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    cases = [(arch, TP_PARITY_LAYERS.get(arch, LM_PARITY_LAYERS)) for arch in ARCHS]
    t0 = time.perf_counter()
    ranks = run_ranks(_tp_rank, TP_SIZE, device="cuda", args=(cases, ref),
                      mesh_factory=functools.partial(make_host_mesh, TP_SIZE))
    spawn_s = time.perf_counter() - t0
    for i, _ in enumerate(cases):
        recs = [r["parity"][i] for r in ranks]
        for key in ("routing_digest", "greedy"):
            if any(r[key] != recs[0][key] for r in recs):
                raise AssertionError(f"{recs[0]['arch']} tp parity: the ranks' {key} differ")
        emit(dict(phase="lm_tp_parity", card=smi, mesh=dict(data=1, model=TP_SIZE),
                  backend="gloo", **{k: v for k, v in recs[0].items() if k != "greedy"},
                  ranks_tp_s=[r["tp_s"] for r in recs]))
    tp_logits = ranks[0]["serve"].pop("logits")
    errs = dict(tp_vs_one_device=logit_errs(tp_logits, ref["logits"]),
                tp_vs_fp32=logit_errs(tp_logits, ref["fp32_logits"]),
                one_device_vs_fp32=logit_errs(ref["logits"], ref["fp32_logits"]))
    one_rms = errs["one_device_vs_fp32"]["rms_err"]
    ratio = errs["tp_vs_fp32"]["rms_err"] / one_rms if one_rms else float("inf")
    emit(dict(phase="lm_tp_serve", card=smi, arch=TP_SERVE_ARCH, dtype="bfloat16",
              batch=TP_SERVE_BATCH, prompt_len=TP_SERVE_PROMPT, gen=TP_SERVE_GEN,
              one_device=dict(one_device, launches=launches, s=ref_s), logits=errs,
              rms_vs_fp32_ratio=ratio, rms_gate=TP16_RMS_GATE, rtol=TP16_RTOL, atol=TP16_ATOL,
              ranks=[r["serve"] for r in ranks], spawn_s=spawn_s))
    if ratio > TP16_RMS_GATE:
        raise AssertionError(f"tp serving: logits {ratio} x as far from the fp32 model's as "
                             f"the one-device bf16 serve's (gate {TP16_RMS_GATE})")


def train_tp_parity_reference(dev, arch, seed=13):
    """The one-device card step of ``arch`` at the sharded parity cell: its
    fp32 config at ``TRAIN_TP_PARITY_LAYERS``' depth, remat off, the batch of 2 x
    ``TRAIN_PARITY_TEXT`` text tokens; the loss, every gradient (in
    ``param_leaves`` order), their global norm and each MoE call's routing.
    The weights are drawn on the card from ``seed``, as each rank draws
    them."""
    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import global_norm

    cfg = dataclasses.replace(arch_config(arch, n_layers=TRAIN_TP_PARITY_LAYERS.get(
        arch, LM_PARITY_LAYERS), dtype="float32"), remat=False)
    model = build_model(cfg)
    seq = TRAIN_PARITY_TEXT + (cfg.n_patches if cfg.family == "vlm" else 0)
    cell = ShapeCell("tp parity", "train", seq, LM_PARITY_BATCH)
    batch = synthetic_batch(cfg, cell, 0, seed, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    routing = []
    with routing_recorded(routing):
        loss, grads = loss_and_grads(model, params, batch)
    del params
    with torch.no_grad():
        norm = float(global_norm(grads))
    torch.cuda.empty_cache()
    return dict(cfg=cfg, seed=seed, loss=float(loss), grads=grads, norm=norm,
                routing=[{f: c[f] for f in ("top_ids", "pos", "keep")} for c in routing])


def _train_tp_parity_case(mesh, ref):
    """One arch on the rank: the whole model drawn from the reference's seed,
    cut to the rank's shards by the training plan; one sharded step in fp32
    compute (its Adam replaced by a spy that keeps the gradients it is
    given), the loss, the global norm through the plan's ``sq_reduce``,
    each gradient shard against its block of the one-device gradient (every
    element of a leaf held once over the ranks: the gathered comparison
    without moving the leaves) within ``GRAD_TOL`` of the leaf's largest
    element, the routing of the rank's row against the one-device routing's,
    and the collectives against ``fsdp.step_collectives``."""
    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.sharding import ctx, fsdp, tp
    from repro_torch.train.optimizer import AdamConfig, global_norm

    cfg, dev = ref["cfg"], mesh.device
    model = build_model(cfg)
    cell = ShapeCell("tp parity", "train", TRAIN_PARITY_TEXT + (
        cfg.n_patches if cfg.family == "vlm" else 0), LM_PARITY_BATCH)
    with ctx.activation_sharding(mesh, dp="data", tp="model"):
        step = S.make_train_step(model, cell, adam=AdamConfig(lr=1e-3),
                                 compute_dtype=torch.float32)
    plan = step.plan
    full = model.init(torch.Generator(device=dev).manual_seed(ref["seed"]))
    masters = plan.shard(full)
    del full
    torch.cuda.empty_cache()
    batch = synthetic_batch(cfg, cell, 0, ref["seed"], dev)
    seen, real = {}, S.adam_update

    def spy(grads, opt_state, params, adam, **kw):
        seen.update(grads=grads, sq_reduce=kw["sq_reduce"])
        return params, opt_state

    routing = []
    S.adam_update = spy
    try:
        torch.cuda.synchronize()
        mesh.reset_counts()
        t0 = time.perf_counter()
        with routing_recorded(routing):
            _, _, loss = step(masters, {"step": 0}, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        collectives = mesh.collective_counts()
    finally:
        S.adam_update = real
    want = fsdp.step_collectives(cfg, plan, 1, clip=False)
    if collectives != want:
        raise AssertionError(f"{cfg.name} sharded parity, rank {mesh.rank}: collectives "
                             f"{collectives}, want {want}")
    with torch.no_grad():
        norm = float(global_norm(seen["grads"], seen["sq_reduce"]))
    loss_err = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(norm - ref["norm"]) / ref["norm"]
    if loss_err > LM_RTOL or norm_err > LM_RTOL:
        raise AssertionError(f"{cfg.name} sharded parity, rank {mesh.rank}: loss {float(loss)} "
                             f"vs {ref['loss']}, norm {norm} vs {ref['norm']}")
    worst = 0.0
    with torch.no_grad():
        for lp, g, w in zip(plan.leaves, seen["grads"], ref["grads"], strict=True):
            block = tp.cut(w, lp.model)
            if lp.data is not None:
                block = block.narrow(lp.data, *plan.data_block(lp))
            scale = float(w.abs().max())
            err = float((g - block).abs().max())
            rel = err / scale if scale > 0 else err
            if not np.isfinite(rel) or rel > GRAD_TOL:
                raise AssertionError(f"{cfg.name} sharded parity, rank {mesh.rank}: gradient "
                                     f"{lp.path} off by {err:.3g} (scale {scale:.3g})")
            worst = max(worst, rel)
    rows = plan.rows(LM_PARITY_BATCH)
    flips = sum(int((a[f].cpu() != b[f][rows].cpu()).any()) for a, b in
                zip(routing, ref["routing"]) for f in ("top_ids", "pos", "keep"))
    if len(routing) != len(ref["routing"]) or flips:
        raise AssertionError(f"{cfg.name} sharded parity, rank {mesh.rank}: routing differs "
                             f"from one device's ({flips} fields)")
    del masters, seen
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers, rank=mesh.rank,
                loss_rel_err=loss_err, norm_rel_err=norm_err, grad_max_rel_err=worst,
                n_grad_leaves=len(plan.leaves), moe_calls=len(routing), collectives=collectives,
                differs_from_spec=sorted(plan.differs_from_spec()), step_s=step_s)


def train_tp_reference(dev):
    """The one-device bf16 run of the sharded train cell on the card: the
    train launcher's losses over the cell's steps, its ms a step and peak
    GB; the launcher's weights from seed 0."""
    import torch

    from repro_torch.launch import train as T

    cfg = arch_config(TRAIN_TP_ARCH, n_layers=TRAIN_TP_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    with train_config(cfg):
        out = T.train(TRAIN_TP_ARCH, smoke=False, steps=TRAIN_TP_WARMUP + TRAIN_TP_TIMED,
                      batch=TRAIN_TP_BATCH, seq=TRAIN_TP_SEQ, microbatch=TRAIN_TP_MICRO,
                      seed=0, device=dev, log_every=100)
    rec = dict(losses=out["losses"], step_s=out["step_s"],
               ms_per_step=float(np.mean(out["step_s"][TRAIN_TP_WARMUP:])) * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del out
    torch.cuda.empty_cache()
    return rec


def _train_tp_cell(mesh):
    """The sharded train cell on the rank, through ``train_on_mesh`` (the
    depth cut given by ``train_config``) with the mesh's collectives timed
    by (axis, op), the device synchronized around each: each step's seconds
    and losses, the rank's peak GB and bytes of masters and Adam state
    against the dry-run's reckoning for the mesh, and its collectives and
    their ms a step."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train_on_mesh
    from repro_torch.models.model import build_model

    cfg = arch_config(TRAIN_TP_ARCH, n_layers=TRAIN_TP_LAYERS)
    steps = TRAIN_TP_WARMUP + TRAIN_TP_TIMED
    torch.cuda.reset_peak_memory_stats()
    mesh.timed = True
    try:
        with train_config(cfg):
            out = train_on_mesh(mesh, TRAIN_TP_ARCH, steps=steps, smoke=False,
                                batch=TRAIN_TP_BATCH, seq=TRAIN_TP_SEQ,
                                microbatch=TRAIN_TP_MICRO, seed=0, log_every=100,
                                gather_params=False)
        seconds = {f"{axis} {op}": t * 1e3 / steps
                   for (axis, op), t in sorted(mesh.seconds.items())}
    finally:
        mesh.timed = False
    peak = torch.cuda.max_memory_allocated()
    want = dryrun.train_state_bytes(build_model(cfg), mesh)
    if out["state_bytes"] != want["params"] + want["opt"] - 4:
        raise AssertionError(f"sharded train cell, rank {mesh.rank}: {out['state_bytes']} bytes "
                             f"of state, the dry-run reckons {want}")
    torch.cuda.empty_cache()
    return dict(rank=mesh.rank, mesh=out["mesh"], losses=out["losses"], step_s=out["step_s"],
                ms_per_step=float(np.mean(out["step_s"][TRAIN_TP_WARMUP:])) * 1e3,
                peak_gb=peak / 1e9, state_bytes=out["state_bytes"],
                dryrun_state_bytes=want["params"] + want["opt"] - 4,
                collectives_per_step={a: {o: n / steps for o, n in ops.items()}
                                      for a, ops in out["collectives"].items()},
                collective_ms_per_step=seconds)


def _train_tp_rank(mesh, refs):
    """One rank of the sharded training phases (a spawned process): every
    parity arch, then the train cell."""
    import torch

    from repro_torch import strict_fp32

    strict_fp32()
    parity = []
    for ref in refs:
        parity.append(_train_tp_parity_case(mesh, ref))
        torch.cuda.empty_cache()
    return dict(parity=parity, cell=_train_tp_cell(mesh))


def run_train_tp_phases(dev, smi, counted):
    """Phase 7g, sharded LM training: the one-device bf16 run of the train
    cell and each parity arch's one-device fp32 step here (their gradients
    stay on the card and reach the ranks as CUDA IPC handles), then one spawn
    of 4 gloo ranks sharing the card on a (2, 2) host mesh for
    ``lm_train_tp_parity`` and ``lm_train_tp``. A train step launches no
    K6 (its attention needs a gradient): ``counted`` checks this process's
    runs; the ranks count their own."""
    import functools

    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import run_ranks

    t0 = time.perf_counter()
    one_device, launches = counted((), "the one-device sharded-cell reference",
                                   lambda: train_tp_reference(dev))
    refs, ref_launches = counted((), "the sharded parity references", lambda: [
        train_tp_parity_reference(dev, arch) for arch in TRAIN_TP_ARCHS])
    ref_s = time.perf_counter() - t0
    if launches["flash_attention"] or ref_launches["flash_attention"]:
        raise AssertionError("a one-device train step launched K6")
    world = TRAIN_TP_MESH[0] * TRAIN_TP_MESH[1]
    t0 = time.perf_counter()
    ranks = run_ranks(_train_tp_rank, world, device="cuda", args=(refs,),
                      mesh_factory=functools.partial(make_host_mesh, TRAIN_TP_MESH[1]))
    spawn_s = time.perf_counter() - t0
    del refs
    torch.cuda.ipc_collect()       # the ranks' handles of the gradients shared with them
    torch.cuda.empty_cache()
    mesh = dict(data=TRAIN_TP_MESH[0], model=TRAIN_TP_MESH[1])
    for i, arch in enumerate(TRAIN_TP_ARCHS):
        recs = [r["parity"][i] for r in ranks]
        emit(dict(phase="lm_train_tp_parity", card=smi, mesh=mesh, backend="gloo",
                  arch=arch, family=recs[0]["family"], n_layers=recs[0]["n_layers"],
                  batch=LM_PARITY_BATCH, text_tokens=TRAIN_PARITY_TEXT, dtype="float32",
                  loss_rel_err=max(r["loss_rel_err"] for r in recs),
                  norm_rel_err=max(r["norm_rel_err"] for r in recs),
                  grad_max_rel_err=max(r["grad_max_rel_err"] for r in recs),
                  n_grad_leaves=recs[0]["n_grad_leaves"], moe_calls=recs[0]["moe_calls"],
                  collectives_per_rank=[r["collectives"] for r in recs],
                  differs_from_spec=recs[0]["differs_from_spec"],
                  step_s=[r["step_s"] for r in recs], loss_rtol=LM_RTOL, grad_tol=GRAD_TOL))
    cells = [r["cell"] for r in ranks]
    losses = cells[0]["losses"]
    if any(c["losses"] != losses for c in cells):
        raise AssertionError("sharded train cell: the ranks' losses differ")
    loss_err = check_close("sharded train cell losses against one device",
                           torch.tensor(losses), torch.tensor(one_device["losses"]),
                           rtol=TRAIN16_STEP_RTOL, atol=TRAIN16_STEP_ATOL)
    tokens = TRAIN_TP_BATCH * TRAIN_TP_SEQ
    ms = float(np.mean([c["ms_per_step"] for c in cells]))
    emit(dict(phase="lm_train_tp", card=smi, arch=TRAIN_TP_ARCH, mesh=mesh, backend="gloo",
              n_layers=TRAIN_TP_LAYERS, seq=TRAIN_TP_SEQ, global_batch=TRAIN_TP_BATCH,
              microbatch=TRAIN_TP_MICRO, dtype="bf16 compute, fp32 masters",
              cut=f"depth {TRAIN_TP_LAYERS} of {arch_config(TRAIN_TP_ARCH).n_layers} layers, "
                  f"seq {TRAIN_TP_SEQ}, batch {TRAIN_TP_BATCH}: gloo stages every "
                  "collective of the 4 ranks through the host",
              losses=losses, one_device=dict(one_device, launches=launches),
              loss_max_abs_err=loss_err, rtol=TRAIN16_STEP_RTOL, atol=TRAIN16_STEP_ATOL,
              ms_per_step=ms, tokens_per_step=tokens, tokens_per_s=tokens / ms * 1e3,
              ranks=cells, references_s=ref_s, spawn_s=spawn_s))


def _last_line(text: str) -> str:
    lines = [line for line in text.splitlines() if line.strip()]
    return lines[-1] if lines else ""


def run_examples_phase(smi, tmp):
    """Phase 7h: each Torch example (``EXAMPLES``) once, in a process of its
    own on the card (``--device`` left at its default), from the checkout's
    ``examples/``; the three run side by side (each mostly its interpreter's
    and the card's start-up). Each must exit 0, and its last printed line
    goes on the phase's line."""
    import os

    # the three share the host's cores
    env = dict(os.environ, PYTHONPATH=str(SRC),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 3) // len(EXAMPLES))))
    done = {}

    def run(name, argv):
        extra = ("--ckpt-root", str(Path(tmp) / "ckpt")) if name.startswith("forecast") else ()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), *argv, *extra],
                              capture_output=True, text=True, env=env, cwd=tmp, timeout=600)
        done[name] = (proc, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=ex) for ex in EXAMPLES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, argv in EXAMPLES:
        if name not in done:
            raise AssertionError(f"example {name} did not run to its end")
        proc, seconds = done[name]
        if proc.returncode:
            raise AssertionError(f"example {name} exited {proc.returncode}:\n"
                                 + proc.stderr[-3000:])
        emit(dict(phase="examples", card=smi, example=name, argv=list(argv), s=seconds,
                  last_line=_last_line(proc.stdout), lines=len(proc.stdout.splitlines())))


def run_dryrun_phase(smi, tmp):
    """Phase 7e'', the dry-run: ``--all`` on both production meshes through
    the port's CLI (``repro_torch.launch.dryrun.main``); every cell ``ok``,
    and each rank's bytes against this card's memory."""
    from repro_torch.launch import dryrun

    for kind in ("single", "multi"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = dryrun.main(["--all", "--mesh", kind, "--out", tmp])
        folder = Path(tmp) / kind
        cells = [json.loads(f.read_text()) for f in sorted(folder.glob("*.json"))]
        bad = [c["arch"] + " x " + c["shape"] for c in cells if c["status"] != "ok"]
        if rc or bad or len(cells) != 33:
            raise AssertionError(f"dryrun {kind}: rc {rc}, {len(cells)} cells, errors {bad}:\n"
                                 + out.getvalue()[-2000:])
        card = cells[0]["device_bytes"]
        emit(dict(phase="dryrun", card=smi, mesh=kind, chips=cells[0]["chips"],
                  cells=len(cells), errors=0, device_bytes=card,
                  all_fit=None if card is None else all(c["fits"] for c in cells),
                  s=time.perf_counter() - t0,
                  per_rank_gb={f"{c['arch']} {c['shape']}": round(
                      c["per_rank_bytes"]["total"] / 1e9, 4) for c in cells}))


# ---------------------------------------------------------------------------
# phase 7f: LM training (every family's loss, remat, the train step, the
# train launcher)
# ---------------------------------------------------------------------------


def attention_calls(cfg, remat: bool) -> int:
    """Attention calls in one forward and backward of ``cfg``'s loss: one
    per attention layer, one per application of a hybrid's shared block,
    none in an ssm model; an encdec model one per encoder layer and two per
    decoder layer; under remat twice each (the forward and its recompute),
    but once in DeepSeek's prefix layers, which run without remat. Each
    needs a gradient and takes the plain path, once per microbatch."""
    n = k6_per_prefill(cfg)
    prefix = cfg.first_dense_layers if cfg.family == "moe" else 0
    return 2 * n - prefix if remat else n


def loss_and_grads(model, params, batch):
    """``model.loss`` and its gradient per ``param_leaves`` entry, by
    autograd; the leaves' flags are put back."""
    import torch

    from repro_torch.core.esrnn import param_leaves

    leaves = [t for _, t in param_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        loss.backward()
        grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
    return loss.detach(), grads


def check_close_on_card(name, got, want, *, rtol, atol) -> float:
    """``check_close`` of a card tensor against a CPU one, compared on the
    card (a model's leaves are gigabytes; the CPU would take seconds)."""
    import torch

    want = want.detach().to(got.device, torch.float32)
    got = got.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max abs err {err} outside rtol {rtol}, atol {atol}")
    return err


def grads_err(what, got, want, tol=GRAD_TOL) -> float:
    """The largest leaf error of ``got`` against ``want`` (lists of
    tensors), each relative to that leaf's largest |want|; raises past
    ``tol`` or on a non-finite gradient."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = w.to(g.device)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        rel = err / scale if scale > 0 else err
        if not np.isfinite(rel) or rel > tol:
            raise AssertionError(f"{what}: gradient leaf {i} {tuple(w.shape)} off by {err:.3g}"
                                 f" (its scale {scale:.3g}, bound {tol} of it)")
        worst = max(worst, rel)
    return worst


def update_err(what, got, want, rtol=TRAIN16_STEP_RTOL) -> float:
    """The largest ``|got - want| / |want|`` over the leaves' updates (lists
    of tensors, the norms over each leaf); raises past ``rtol``, where a
    leaf's update is not finite, or where ``want`` moves no leaf."""
    import torch

    worst, moved = 0.0, False
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = w.to(g.device, torch.float64)
        norm = float(w.norm())
        err = float((g.double() - w).norm())
        rel = err / norm if norm > 0 else err
        if not np.isfinite(rel) or rel > rtol:
            raise AssertionError(f"{what}: the update of leaf {i} {tuple(w.shape)} off by "
                                 f"{rel:.3g} of its norm {norm:.3g} (bound {rtol})")
        worst, moved = max(worst, rel), moved or norm > 0
    if not moved:
        raise AssertionError(f"{what}: no leaf moved")
    return worst


def plain_train_update(model, params, batch, n_micro, adam):
    """The plain version of one ``make_train_step`` from a fresh Adam state
    with no clip or weight decay: each microbatch's loss and gradient on the
    bf16-cast masters (a cast's gradient is its output's, in fp32), both
    summed and divided by ``n_micro``, and Adam's first step from zero
    moments, ``-lr g / (|g| + eps)``, added to each fp32 master as the step
    adds it. Returns ``(loss, updates)`` by leaf: new master - old master."""
    from repro_torch.core.esrnn import param_leaves
    from repro_torch.launch.steps import cast_params_for_compute

    assert adam.clip_norm is None and not adam.weight_decay
    rows = next(iter(batch.values())).shape[0] // n_micro
    loss, grads = 0.0, None
    for i in range(n_micro):
        micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        m_loss, m_grads = loss_and_grads(model, cast_params_for_compute(params), micro)
        loss = loss + m_loss
        m_grads = [g.float() for g in m_grads]
        grads = m_grads if grads is None else [a + b for a, b in zip(grads, m_grads)]
    grads = [g / n_micro for g in grads]
    return loss / n_micro, [(p - adam.lr * g / (g.abs() + adam.eps)) - p
                            for (_, p), g in zip(param_leaves(params), grads, strict=True)]


def run_train_parity(dev, arch, seed=11):
    """``arch`` at full width in fp32 (``run_parity``'s depth), the train
    launcher's batch of 2 x 128 text tokens: the loss within rtol 1e-4 and
    every gradient leaf within ``GRAD_TOL`` of its largest element, card
    against CPU, remat off; each MoE layer's routing on the CPU's layer
    input equal on both devices (``parity_routing``); remat on against off
    on the card within the same bounds; K6 never launched, the plain route
    taken ``attention_calls`` times a loss and its backward. Then one
    ``make_train_step`` step in 2 microbatches under the bf16 compute
    policy (the model's bf16 config over the same fp32 masters, 2 x 32 text
    tokens, ``TRAIN16_STEP_ADAM``) against ``plain_train_update`` on the
    card and, but for ``TRAIN16_CARD_ONLY``, against the same step on the
    CPU: the loss (and on the CPU every updated param) within rtol 2e-2 /
    atol 1e-3, and each leaf's update within 2e-2 of its norm
    (``update_err``)."""
    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.core.esrnn import param_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import attention as A
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import moe_route
    from repro_torch.train.optimizer import AdamConfig, adam_init

    def leaves(params):
        return [t for _, t in param_leaves(params)]

    cfg = arch_config(arch, n_layers=TRAIN_PARITY_LAYERS.get(arch, LM_PARITY_LAYERS),
                      dtype="float32")
    off = build_model(dataclasses.replace(cfg, remat=False))
    on = build_model(dataclasses.replace(cfg, remat=True))
    seq = TRAIN_PARITY_TEXT + (cfg.n_patches if cfg.family == "vlm" else 0)
    cell = ShapeCell("parity", "train", seq, LM_PARITY_BATCH)
    batch_cpu = synthetic_batch(cfg, cell, 0, seed)
    batch_dev = {k: v.to(dev) for k, v in batch_cpu.items()}
    # drawn on the card (a CPU draw of qwen3-moe's 1.9 B takes 16 s), copied
    t0 = time.perf_counter()
    params_dev = off.init(torch.Generator(device=dev).manual_seed(seed))
    params_cpu = _params_to(params_dev, "cpu")
    init_s = time.perf_counter() - t0
    seen = {"cpu": [], "card": []}

    def route_on(where):
        def record(p, c, x):
            with torch.no_grad():
                seen[where].append((p, x.detach(), moe_route(p, c, x.detach())))
        return record

    t0 = time.perf_counter()
    with moe_layers_seen(route_on("cpu")):
        loss_c, g_c = loss_and_grads(off, params_cpu, batch_cpu)
    cpu_s = time.perf_counter() - t0
    A.reset_grad_route_calls()
    k6_before = ops.launch_counts()["flash_attention"]
    with moe_layers_seen(route_on("card")):
        loss_d, g_d = loss_and_grads(off, params_dev, batch_dev)
    routes_off = A.grad_route_calls()
    rec = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers, dtype="float32",
               batch=LM_PARITY_BATCH, text_tokens=TRAIN_PARITY_TEXT,
               image_patches=cfg.n_patches if cfg.family == "vlm" else 0,
               frames=cfg.n_frames if cfg.family == "encdec" else 0, init_s=init_s,
               cpu_loss_and_grads_s=cpu_s, n_grad_leaves=len(g_c))
    if seen["cpu"]:
        with torch.no_grad():
            rec.update(parity_routing(cfg, seen, dev))
    seen = None
    rec["loss"] = float(loss_c)
    rec["loss_rel_err"] = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    if rec["loss_rel_err"] > LM_RTOL:
        raise AssertionError(f"{arch} train parity: loss {float(loss_d)} != {float(loss_c)}")
    rec["grad_max_rel_err"] = grads_err(f"{arch} train parity", g_d, g_c)
    del g_c
    A.reset_grad_route_calls()
    loss_r, g_r = loss_and_grads(on, params_dev, batch_dev)
    routes_on = A.grad_route_calls()
    rec["remat_loss_rel_err"] = abs(float(loss_r) - float(loss_d)) / abs(float(loss_d))
    if rec["remat_loss_rel_err"] > LM_RTOL:
        raise AssertionError(f"{arch} remat on/off: loss {float(loss_r)} != {float(loss_d)}")
    rec["remat_grad_max_rel_err"] = grads_err(f"{arch} remat on/off", g_r, g_d)
    del g_r, g_d
    torch.cuda.synchronize()
    k6 = ops.launch_counts()["flash_attention"] - k6_before
    want_routes = (attention_calls(cfg, False), attention_calls(cfg, True))
    if k6 or (routes_off, routes_on) != want_routes:
        raise AssertionError(f"{arch} train parity: K6 {k6}, plain routes (remat off, on) "
                             f"{(routes_off, routes_on)}, want 0 and {want_routes}")
    rec.update(k6_launches=k6, plain_route_calls_remat_off=routes_off,
               plain_route_calls_remat_on=routes_on)

    # one bf16-policy train step in 2 microbatches from the same fp32 masters
    model16 = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    seq16 = TRAIN16_PARITY_TEXT + (cfg.n_patches if cfg.family == "vlm" else 0)
    step_cell = ShapeCell("parity", "train", seq16, LM_PARITY_BATCH, microbatch=1)
    adam = AdamConfig(**TRAIN16_STEP_ADAM)
    step = make_train_step(model16, step_cell, adam=adam)
    batch16_cpu = synthetic_batch(cfg, step_cell, 1, seed)
    batch16_dev = {k: v.to(dev) for k, v in batch16_cpu.items()}
    rec.update(bf16_step_text_tokens=TRAIN16_PARITY_TEXT, bf16_step_adam=TRAIN16_STEP_ADAM)
    masters = [t.clone() for t in leaves(params_dev)]
    loss_p, delta_p = plain_train_update(model16, params_dev, batch16_dev,
                                         LM_PARITY_BATCH, adam)
    params_dev, _, l16_d = step(params_dev, adam_init(params_dev), batch16_dev)
    rec["bf16_step_loss"] = float(l16_d)

    def delta_d():
        return (t - m for t, m in zip(leaves(params_dev), masters, strict=True))

    rec["bf16_step_vs_plain_loss_abs_err"] = check_close(
        f"{arch} bf16 step loss, card against its plain version", l16_d, loss_p,
        rtol=TRAIN16_STEP_RTOL, atol=TRAIN16_STEP_ATOL)
    rec["bf16_step_vs_plain_update_rel_err"] = update_err(
        f"{arch} bf16 step, card against its plain version", delta_d(), delta_p)
    del delta_p
    if arch not in TRAIN16_CARD_ONLY:
        masters_cpu = [t.clone() for t in leaves(params_cpu)]
        t0 = time.perf_counter()
        params_cpu, _, l16_c = step(params_cpu, adam_init(params_cpu), batch16_cpu)
        rec["cpu_bf16_step_s"] = time.perf_counter() - t0
        rec["bf16_step_loss_abs_err"] = check_close(
            f"{arch} bf16 step loss", l16_d, l16_c, rtol=TRAIN16_STEP_RTOL,
            atol=TRAIN16_STEP_ATOL)
        rec["bf16_step_params_max_abs_err"] = max(
            check_close_on_card(f"{arch} bf16 step params {i}", d, c,
                                rtol=TRAIN16_STEP_RTOL, atol=TRAIN16_STEP_ATOL)
            for i, (d, c) in enumerate(zip(leaves(params_dev), leaves(params_cpu))))
        rec["bf16_step_update_rel_err"] = update_err(
            f"{arch} bf16 step, card against CPU", delta_d(),
            [t - m for t, m in zip(leaves(params_cpu), masters_cpu, strict=True)])
        del masters_cpu
    del masters, params_dev, params_cpu
    torch.cuda.empty_cache()
    return dict(rec, loss_rtol=LM_RTOL, grad_tol=GRAD_TOL, bf16_rtol=TRAIN16_STEP_RTOL,
                bf16_atol=TRAIN16_STEP_ATOL, update_rtol=TRAIN16_STEP_RTOL)


@contextlib.contextmanager
def train_config(cfg):
    """The train launcher given ``cfg`` for ``cfg.name`` (a depth cut), as
    ``examples/train_lm_torch.py`` gives it its config; the port itself is
    unchanged."""
    from repro_torch.launch import train as T

    real = T.get_config
    T.get_config = lambda arch: cfg if arch == cfg.name else real(arch)
    try:
        yield
    finally:
        T.get_config = real


def run_lm_train(dev, arch, counted):
    """``arch`` in the train cell through ``launch.train.train`` on the
    card (given its ``TRAIN_DEPTH`` cut by ``train_config``): 1 warm-up and
    3 timed steps. Returns the record: ms a step (host clock over the whole
    step, batch drawing included, ended by the loss's read-back), tokens/s,
    the peak GB, the losses, K6 launches (asserted 0) and the plain-route
    count (asserted ``attention_calls`` x microbatches x steps), and the
    share of the card's dense bf16 peak that (8 with remat, else 6) x
    active params x tokens a step gives. Asserts every loss finite and the
    first layer's first matrix moved off its init (the launcher's seeded
    ``model.init``, made again here)."""
    import torch

    from repro_torch.core.esrnn import param_leaves
    from repro_torch.launch import train as T
    from repro_torch.models import attention as A
    from repro_torch.models.model import build_model

    cfg = arch_config(arch, n_layers=TRAIN_DEPTH.get(arch))
    steps = LM_TRAIN_WARMUP + LM_TRAIN_TIMED
    seed = 0

    def first_layer_matrix(params):
        return next(t for path, t in param_leaves(params)
                    if t.dim() == 2 and len(path) > 1 and isinstance(path[1], int))

    at_init = first_layer_matrix(build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(seed))).float()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_grad_route_calls()
    with train_config(cfg) if arch in TRAIN_DEPTH else contextlib.nullcontext():
        out, launches = counted((), f"{arch} training", lambda: T.train(
            arch, smoke=False, steps=steps, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
            microbatch=LM_TRAIN_MICRO, seed=seed, device=dev, log_every=steps))
    peak = torch.cuda.max_memory_allocated()
    routes = A.grad_route_calls()
    n_micro = LM_TRAIN_BATCH // LM_TRAIN_MICRO
    want_routes = attention_calls(cfg, cfg.remat) * n_micro * steps
    if launches["flash_attention"] or routes != want_routes:
        raise AssertionError(f"{arch} training: K6 {launches['flash_attention']}, plain routes "
                             f"{routes}, want 0 and {want_routes}")
    losses = out["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} training: losses {losses}")
    params = out.pop("params")
    moved = float((first_layer_matrix(params) - at_init).abs().max())
    del params, at_init
    torch.cuda.empty_cache()
    if not moved > 0:
        raise AssertionError(f"{arch} training: the first layer's weights did not move")
    timed = out["step_s"][LM_TRAIN_WARMUP:]
    step_s = float(np.mean(timed))
    # positions a step runs through the decoder (a vlm's patches among them;
    # an encdec model's 1,500 frames go through its encoder besides)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    active = cfg.active_param_count()
    flops = (8 if cfg.remat else 6) * active * tokens
    return dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                full_depth=cfg.n_layers == arch_config(arch).n_layers,
                seq=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH, microbatch=LM_TRAIN_MICRO,
                image_patches=cfg.n_patches if cfg.family == "vlm" else 0,
                frames=cfg.n_frames if cfg.family == "encdec" else 0, remat=cfg.remat,
                params=cfg.param_count(), active_params=active, warmup_s=out["step_s"][0],
                step_s=timed, ms_per_step=step_s * 1e3, tokens_per_step=tokens,
                tokens_per_s=tokens / step_s, peak_gb=peak / 1e9, losses=losses,
                k6_launches=launches["flash_attention"], plain_route_calls=routes,
                plain_route_calls_per_step=routes // steps, first_layer_moved=moved,
                model_flops_per_step=flops, bf16_peak_share=flops / step_s / BF16_FLOPS)


def run_train_resume(dev, arch, tmp):
    """``arch`` in the train cell: 2 steps, a checkpoint, 1 more step from
    it, against 3 unbroken steps, on the card: the last loss and every
    param within rtol 1e-4 (atol 1e-6)."""
    import torch

    from repro_torch.core.esrnn import param_leaves
    from repro_torch.launch import train as T

    kw = dict(smoke=False, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, microbatch=LM_TRAIN_MICRO,
              seed=0, device=dev)
    whole = T.train(arch, steps=3, **kw)
    t0 = time.perf_counter()
    first = T.train(arch, steps=2, ckpt_dir=tmp, **kw)
    rest = T.train(arch, steps=3, ckpt_dir=tmp, **kw)
    resumed_s = time.perf_counter() - t0
    if len(rest["losses"]) != 1:
        raise AssertionError(f"{arch} resume: ran {len(rest['losses'])} steps after step 2")
    loss_err = check_close(f"{arch} resumed losses", torch.tensor(first["losses"] + rest["losses"]),
                           torch.tensor(whole["losses"]), rtol=LM_RTOL, atol=0)
    err = max(check_close(f"{arch} resumed params {i}", a, b, rtol=LM_RTOL, atol=1e-6)
              for i, ((_, a), (_, b)) in enumerate(zip(param_leaves(rest["params"]),
                                                      param_leaves(whole["params"]),
                                                      strict=True)))
    del whole, first, rest
    torch.cuda.empty_cache()
    return dict(arch=arch, part="resume", steps="2 + checkpoint + 1 vs 3",
                two_runs_with_checkpoint_s=resumed_s, loss_abs_err=loss_err,
                params_max_abs_err=err, rtol=LM_RTOL, atol=1e-6)


def train_split(prof, labels):
    """Device ms of one profiled train step by part. A kernel belongs to the
    innermost of ``labels``' ranges around the op that launched it; a
    backward op (``autograd::engine::evaluate_function: ...``) to the range
    of the forward op that made its node (the profiler's sequence numbers
    tie them); a recompute under remat runs its forward again inside the
    backward, its attention in the attention range. What no range holds is
    split into product kernels (``GEMM_NAMES``: the weight products,
    forward, recompute and backward) and the rest (element-wise work, the
    casts, the norms, the embedding's scatter)."""
    from torch.autograd import DeviceType

    names = set(labels)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def innermost(e):
        while e is not None:
            if e.name in names:
                return e.name, False
            if e.name.startswith("autograd::engine::evaluate_function"):
                return None, e
            e = e.cpu_parent
        return None, False

    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            label, bwd = innermost(e)
            if bwd is False:
                forward.setdefault((e.thread, e.sequence_nr), label)
    parts = dict.fromkeys([f"{n} forward" for n in labels] + [f"{n} backward" for n in labels]
                          + ["gemm", "rest"], 0.0)
    for e in events:
        if not e.kernels:
            continue
        label, bwd = innermost(e)
        if label is not None:
            key = f"{label} forward"
        elif bwd is not False:
            fwd = forward.get((bwd.fwd_thread, bwd.sequence_nr))
            key = f"{fwd} backward" if fwd else None
        else:
            key = None
        for k in e.kernels:
            if key is None:
                part = "gemm" if any(g in k.name.lower() for g in GEMM_NAMES) else "rest"
            else:
                part = key
            parts[part] += k.duration
    return {k: v / 1e3 for k, v in parts.items()}


TRAIN_PROFILE_LABELS = (
    ("repro_torch.models.attention", "chunked_attention", "attention"),
    ("repro_torch.models.transformer", "cross_entropy_loss", "cross_entropy"),
    ("repro_torch.launch.steps", "cast_params_for_compute", "cast"),
    ("repro_torch.launch.steps", "adam_update", "adam"),
)


def profile_lm_train(dev, arch):
    """One train step of ``arch`` at the train cell's shape with one
    microbatch of 2 (the cell's step makes 4 of them) under torch.profiler
    (after a warm one): wall ms, the device-busy share, device ms by part
    (``train_split``: the plain attention forward (with its recompute) and
    backward, cross-entropy, the bf16 casts, the Adam update, the other
    product kernels, the rest) and the top kernels."""
    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import fp32_masters, synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamConfig, adam_init

    cfg = arch_config(arch, n_layers=TRAIN_DEPTH.get(arch))
    model = build_model(cfg)
    params = fp32_masters(model.init(torch.Generator(device=dev).manual_seed(0)))
    opt = adam_init(params)
    # one microbatch of the cell and the update: the cell's step runs that
    # microbatch's work 4 times, and the profiler's events of 4 take a
    # minute to read back
    cell = ShapeCell("train", "train", LM_TRAIN_SEQ, LM_TRAIN_MICRO, microbatch=LM_TRAIN_MICRO)
    step = S.make_train_step(model, cell, adam=AdamConfig(lr=3e-4, clip_norm=1.0))
    batch = synthetic_batch(cfg, cell, 0, 0, dev)
    names = [label for _, _, label in TRAIN_PROFILE_LABELS]
    t0 = time.perf_counter()
    with profiler_ranges(TRAIN_PROFILE_LABELS):
        out = profile_call(lambda: step(params, opt, batch), top=12, keep_profile=True,
                           ranges=set(names))
    t1 = time.perf_counter()
    prof = out.pop("profile")
    out["split_ms"] = split = train_split(prof, names)
    out["profile_s"], out["split_s"] = t1 - t0, time.perf_counter() - t1
    out["split_total_ms"] = sum(split.values())
    del params, opt, prof
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, seq=LM_TRAIN_SEQ,
                global_batch=LM_TRAIN_MICRO, microbatch=LM_TRAIN_MICRO, **out)


def run_train_phases(dev, smi, counted):
    """Phase 7f, LM training: for each of ``TRAIN_ARCHS``, the parity of its
    loss, gradients, remat and a bf16 train step, card against CPU
    (``lm_train_parity``); then each in the train cell through the train
    launcher (``lm_train``), whisper-base also resumed from a checkpoint;
    then one granite-3-2b step of one microbatch profiled by part
    (``profile_lm_train``). A
    train step launches no K6: every attention of it needs a gradient and
    takes the plain path, which the phases count. ``counted`` is
    ``main``'s: these phases' launches join the main path's (none)."""
    import torch

    for arch in TRAIN_ARCHS:
        rec, launches = counted((), f"the {arch} train parity run",
                                lambda: run_train_parity(dev, arch))
        emit(dict(phase="lm_train_parity", card=smi, launches=launches, **rec))
        torch.cuda.empty_cache()
    for arch in TRAIN_ARCHS:
        rec = run_lm_train(dev, arch, counted)
        if not rec["full_depth"]:
            rec["cut"] = (f"depth {rec['n_layers']} of {arch_config(arch).n_layers} layers: "
                          + TRAIN_CUT_WHY.get(arch, "the script's time limit"))
        emit(dict(phase="lm_train", card=smi, **rec))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_train_") as tmp:
        rec, launches = counted((), "the resumed training",
                                lambda: run_train_resume(dev, TRAIN_RESUME_ARCH, tmp))
    emit(dict(phase="lm_train", card=smi, launches=launches, **rec))
    emit(dict(phase="profile_lm_train", card=smi,
              call=f"one {TRAIN_PROFILE_ARCH} train step of one microbatch of the train cell",
              **profile_lm_train(dev, TRAIN_PROFILE_ARCH)))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if "--million" in sys.argv[1:]:
        if not torch.cuda.is_available():
            return 1
        return million_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import strict_fp32
    from repro_torch.convert import params_to_device
    from repro_torch.kernels import build, ops

    strict_fp32()
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # phase 1: the card and the kernel build
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    reports = build.build_info.get("ptxas", {})
    regs = {name: [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
            for name, rep in reports.items()}
    emit(dict(phase="device", nvidia_smi=smi, name=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, build_s=build_s, registers=regs,
              allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32]))
    # what ptxas made of the redesigned kernels' sources: per entry
    # function its registers, shared memory, spills and any warning (an
    # empty report: the library was built by an earlier process)
    report = {name: ptxas_summary(reports.get(name, ""))
              for name in ("flash_attention.cu", "lstm_cell.cu", "lstm_cell_tc.cu",
                           "lstm_cell_bwd_tc.cu", "hw_scan.cu", "hw_scan_bwd.cu")}
    # the bf16 instantiations of K1 to K5: each entry and the two lines
    # ptxas prints after it (stack and spills, registers and shared memory)
    bf16 = {name: [line for i, entry in enumerate(report[name]) if "bfloat16" in entry
                   for line in report[name][i:i + 3]]
            for name in ("hw_scan.cu", "hw_scan_bwd.cu", "lstm_cell.cu", "lstm_cell_tc.cu")}
    # the tensor-core cell kernel's registers by instantiation: K3 (ILb0E)
    # and K4 (ILb1E), quads a warp (ILi<q>E)
    for act, quads, used in re.findall(
            r"Compiling entry function '[^']*lstm_cell_tcILb(\d)ELi(\d+)E[^']*'"
            r".*?Used (\d+) registers", reports.get("lstm_cell_tc.cu", ""), re.S):
        TC_REGISTERS[(act == "1", int(quads))] = int(used)
    # K5's dx-only kernels and the full ones beside them, by stream (the
    # bf16 K5 on the tensor cores: ILb0E the full launch, ILb1E dx-only)
    for which, stream, source, fn in (
            ("dx", "f32", "lstm_cell.cu", "lstm_bwd_dxIfE"),
            ("full", "f32", "lstm_cell.cu", "lstm_bwdIfE"),
            ("dx", "bf16", "lstm_cell.cu", "lstm_bwd_dxI13__nv_bfloat16E"),
            ("full", "bf16", "lstm_cell.cu", "lstm_bwdI13__nv_bfloat16E"),
            ("dx", "tc", "lstm_cell_bwd_tc.cu", "lstm_cell_bwd_tcILb1E"),
            ("full", "tc", "lstm_cell_bwd_tc.cu", "lstm_cell_bwd_tcILb0E")):
        found = re.search(rf"Compiling entry function '[^']*{fn}[^']*'.*?Used (\d+) registers",
                          reports.get(source, ""), re.S)
        DX_REGISTERS[which, stream] = int(found.group(1)) if found else None
    BWD_TC_REGISTERS["lstm_cell_bwd_tc"] = DX_REGISTERS["full", "tc"]
    emit(dict(phase="ptxas", build_s=build_s, report=report, bf16_entries=bf16,
              lstm_cell_tc_registers={f"{'k4' if act else 'k3'} quads {q}": n
                                      for (act, q), n in sorted(TC_REGISTERS.items())},
              lstm_cell_bwd_tc_registers=BWD_TC_REGISTERS.get("lstm_cell_bwd_tc"),
              lstm_cell_bwd_dx_registers={f"{which} {stream}": n
                                          for (which, stream), n in DX_REGISTERS.items()}))

    # phase 2: kernels against their plain versions, at the main path's
    # shapes (the first of each list is the first launch of the forecast
    # batch, for K1/K3, or of a train step at batch 256, for K2/K4/K5), plus
    # the m == 1 convention of the yearly and other non-seasonal models
    cfg, params_cpu = make_model(N_SERIES)
    k1_shapes, k3_shapes = main_path_shapes(cfg)
    k2_shapes, k45_shapes = train_path_shapes(cfg, window=max(LENGTH_BUCKETS))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        k1 = [check_hw_scan(n, t, m, gen) for n, t, m in k1_shapes]
        k1.append(check_hw_scan(N_SERIES, T_LEN, 1, gen))
        k1 += [check_hw_scan(n, t, m, gen, timed=False) for n, t, m in WIDE_RING]
        k3 = [check_lstm_cell(rows, width, cfg.hidden_size, gen)
              for rows, width in k3_shapes]
        # the monthly model's widths (H = 50): K3's largest shared-memory
        # footprint among the presets, (18 + 50) x 200 and (50 + 50) x 200 weights
        k3 += [check_lstm_cell(N_SERIES, width, 50, gen) for width in (18, 50)]
        k3 += [check_lstm_cell(*shape, gen) for shape in WIDE_CELL]
        k2 = [check_hw_scan_bwd(n, t, m, gen) for n, t, m in k2_shapes]
        k2 += [check_hw_scan_bwd(n, TRAIN_T, 1, gen) for n in (TRAIN_BATCH, BIG_BATCH)]
        k2 += [check_hw_scan_bwd(n, t, m, gen, timed=False) for n, t, m in WIDE_RING]
        k4 = [check_lstm_cell_fwd(rows, width, cfg.hidden_size, gen)
              for rows, width in k45_shapes]
        k4 += [check_lstm_cell_fwd(*shape, gen) for shape in WIDE_CELL]
        k5 = [check_lstm_cell_bwd(rows, width, cfg.hidden_size, gen)
              for rows, width in k45_shapes]
        k5 += [check_lstm_cell_bwd(*shape, gen) for shape in WIDE_BWD]
        k6 = [check_flash_attention(gen, *shape) for shape in k6_shapes()]
        # the bf16 streams of K1 and K3 at the bf16 forecast's and serve
        # buckets' shapes, and the widths past the presets
        k1b = [check_hw_scan(n, t, m, gen, bf16=True) for n, t, m in k1_shapes]
        k1b += [check_hw_scan(n, t, m, gen, timed=False, bf16=True) for n, t, m in WIDE_RING]
        k3b = [check_lstm_cell(rows, width, cfg.hidden_size, gen, bf16=True)
               for rows, width in k3_shapes]
        k3b += [check_lstm_cell(*shape, gen, bf16=True) for shape in WIDE_CELL]
        # the bf16 streams of K2, K4 and K5 at the bf16 train steps' and the
        # bf16 fine-tune's shapes, and the wide widths
        k2b = [check_hw_scan_bwd(n, t, m, gen, bf16=True) for n, t, m in k2_shapes]
        k2b += [check_hw_scan_bwd(n, TRAIN_T, 1, gen, bf16=True)
                for n in (TRAIN_BATCH, BIG_BATCH)]
        k2b += [check_hw_scan_bwd(n, t, m, gen, timed=False, bf16=True) for n, t, m in WIDE_RING]
        k4b = [check_lstm_cell_fwd(rows, width, cfg.hidden_size, gen, bf16=True)
               for rows, width in k45_shapes]
        k4b += [check_lstm_cell_fwd(*shape, gen, bf16=True) for shape in WIDE_CELL]
        k5b = [check_lstm_cell_bwd(rows, width, cfg.hidden_size, gen, bf16=True)
               for rows, width in k45_shapes]
        k5b += [check_lstm_cell_bwd(*shape, gen, bf16=True) for shape in WIDE_BWD]
        # K5's dx-only launch (the esn head's reservoir) at every main-path
        # K5 shape, fp32 and bf16
        k5dx = [check_lstm_cell_bwd_dx(rows, width, cfg.hidden_size, gen)
                for rows, width in k45_shapes]
        k5dxb = [check_lstm_cell_bwd_dx(rows, width, cfg.hidden_size, gen, bf16=True)
                 for rows, width in k45_shapes]
    torch.cuda.empty_cache()
    for rec in k1 + k3 + k2 + k4 + k5 + k6 + k1b + k3b + k2b + k4b + k5b + k5dx + k5dxb:
        emit(dict(phase="kernel", **rec))

    # phases 3 to 7 are the main paths: each counts launches from zero and
    # must have launched every kernel of its path
    path_launches = dict.fromkeys(ops.launch_counts(), 0)

    def counted(phase_kernels, what, run):
        ops.reset_launch_counts()
        result = run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        missed = [k for k in phase_kernels if counts[k] == 0]
        if missed:
            raise AssertionError(f"{what} missed kernel(s) {missed}: {counts}")
        for k, v in counts.items():
            path_launches[k] += v
        return result, counts

    forecast_kernels = ("hw_scan", "lstm_cell")
    train_kernels = ("hw_scan", "hw_scan_bwd", "lstm_cell_fwd", "lstm_cell_bwd")
    params_dev = params_to_device(params_cpu, dev)
    y, cats = make_batch(cfg, N_SERIES, T_LEN)
    fc, fc_launches = counted(forecast_kernels, "the forecast", lambda: run_forecast(
        cfg, params_cpu, params_dev, y, cats, dev))
    emit(dict(phase="forecast", config="quarterly", N=N_SERIES, T=T_LEN,
              hidden=cfg.hidden_size, dilations=cfg.dilations, origins=ORIGINS,
              launches=fc_launches, **fc))
    emit(dict(phase="profile", call="esrnn_forecast", N=N_SERIES, T=T_LEN,
              **profile_forecast(cfg, params_dev, y, cats, dev)))

    serve, serve_launches = counted(forecast_kernels, "serving", lambda: run_serve(
        cfg, params_cpu, params_dev, dev, N_REQUESTS))
    emit(dict(phase="serve", card=smi, launches=serve_launches, **serve))

    # phase 4b: the same forecast and server under the bf16 policy: K1 with a
    # bf16 y once and K3 in bf16 once a step, and no fp32 K1 or K3 launch
    from repro_torch.core.esrnn import esrnn_forecast

    cfg16 = dataclasses.replace(cfg, precision="bf16")
    bf16_kernels = ("hw_scan_bf16", "lstm_cell_bf16")
    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    fc32_card = esrnn_forecast(cfg, params_dev, y_d, c_d)
    esrnn_forecast(cfg16, params_dev, y_d, c_d)              # warm-up
    fc16, fc16_launches = counted(bf16_kernels, "the bf16 forecast", lambda: run_forecast_bf16(
        cfg16, params_cpu, params_dev, y, cats, dev, fc32_card))
    want = dict(hw_scan_bf16=1, lstm_cell_bf16=forecast_steps(cfg16, T_LEN), hw_scan=0,
                lstm_cell=0)
    if {k: fc16_launches[k] for k in want} != want:
        raise AssertionError(f"the bf16 forecast launched {fc16_launches}, want {want}")
    emit(dict(phase="forecast_bf16", config="quarterly", precision="bf16", N=N_SERIES,
              T=T_LEN, hidden=cfg.hidden_size, card=smi, launches=fc16_launches, **fc16))
    emit(dict(phase="profile_bf16", call="esrnn_forecast, precision bf16", N=N_SERIES,
              T=T_LEN, **profile_forecast(cfg16, params_dev, y, cats, dev)))
    del fc32_card, y_d, c_d
    serve16, serve16_launches = counted(bf16_kernels, "bf16 serving", lambda: run_serve(
        cfg16, params_cpu, params_dev, dev, N_REQUESTS, rtol=FC16_RTOL, atol=FC16_ATOL))
    if serve16_launches["hw_scan"] or serve16_launches["lstm_cell"]:
        raise AssertionError(f"bf16 serving launched fp32 kernels: {serve16_launches}")
    emit(dict(phase="serve_bf16", precision="bf16", card=smi, launches=serve16_launches,
              **serve16))

    # phase 5: train_esrnn on the card against the CPU, then steps/s
    from repro_torch.data.pipeline import synthetic_prepared

    data = synthetic_prepared(TRAIN_N, series_length=TRAIN_T)
    train, train_launches = counted(train_kernels, "training",
                                    lambda: run_train(cfg, data, dev))
    emit(dict(phase="train", config="quarterly", N=TRAIN_N, T=TRAIN_T,
              batch=TRAIN_BATCH, card=smi, launches=train_launches, **train,
              **time_train_steps(cfg, data, dev)))
    wide, wide_launches = counted(train_kernels, "training at hidden 64",
                                  lambda: run_train_wide(data, dev))
    emit(dict(phase="train_wide", config="quarterly", N=TRAIN_N, T=TRAIN_T,
              batch=TRAIN_BATCH, card=smi, launches=wide_launches, **wide))
    bench = TrainSteps(cfg, data, dev, TRAIN_BATCH, sparse=False)
    # K5's device time per step is the profile's "lstm_bwd" entry
    emit(dict(phase="profile_train", call="one dense train step", N=TRAIN_N, T=TRAIN_T,
              batch=TRAIN_BATCH, **profile_call(bench.step, match="lstm_bwd")))

    # phase 6: the fine-tuning server on the card against the CPU
    finetune, ft_launches = counted(
        forecast_kernels + train_kernels, "the fine-tune server",
        lambda: run_finetune(cfg, params_cpu, params_dev, dev))
    emit(dict(phase="finetune", card=smi, launches=ft_launches, **finetune))

    # phase 6b: the same training and fine-tune under the bf16 policy: K1
    # and K2 with a bf16 y once a step, K4 and K5 in bf16 once a cell step,
    # and no fp32 training kernel; then head_compare's OWA cell, fp32 and
    # bf16, on the card
    train16_kernels = ("hw_scan_bf16", "hw_scan_bwd_bf16", "lstm_cell_fwd_bf16",
                       "lstm_cell_bwd_bf16")
    fp32_kernels = ("hw_scan", "hw_scan_bwd", "lstm_cell", "lstm_cell_fwd", "lstm_cell_bwd")

    def fp32_free(what, counts):
        if any(counts[k] for k in fp32_kernels + ("lstm_cell_bwd_dx",)):
            raise AssertionError(f"{what} launched fp32 kernels: {counts}")

    train16, train16_launches = counted(train16_kernels, "bf16 training",
                                        lambda: run_train_bf16(cfg16, data, dev, train))
    fp32_free("bf16 training", train16_launches)
    emit(dict(phase="train_bf16", config="quarterly", precision="bf16", N=TRAIN_N, T=TRAIN_T,
              batch=TRAIN_BATCH, card=smi, launches=train16_launches, **train16,
              **time_train_steps(cfg16, data, dev)))
    bench16 = TrainSteps(cfg16, data, dev, TRAIN_BATCH, sparse=False)
    emit(dict(phase="profile_train_bf16", call="one dense bf16 train step", N=TRAIN_N,
              T=TRAIN_T, batch=TRAIN_BATCH, card=smi, **profile_call(
                  bench16.step, match={"lstm_cell_fwd_bf16": ("lstm_cell_tc<true",),
                                       "lstm_cell_bwd_bf16": ("lstm_cell_bwd_tc",)})))
    del bench16
    finetune16, ft16_launches = counted(
        bf16_kernels + train16_kernels, "the bf16 fine-tune server",
        lambda: run_finetune(cfg16, params_cpu, params_dev, dev, rtol=FC16_RTOL,
                             atol=FC16_ATOL, loss_rtol=TRAIN16_RTOL))
    fp32_free("the bf16 fine-tune server", ft16_launches)
    emit(dict(phase="finetune_bf16", precision="bf16", card=smi, launches=ft16_launches,
              **finetune16))
    owa, owa_launches = counted(train_kernels + train16_kernels, "the OWA cell",
                                lambda: run_owa(dev))
    emit(dict(phase="owa_bf16", card=smi, launches=owa_launches, **owa))

    # phase 6c: the user surface -- spec, estimator, forecast CLI and
    # checkpoints -- at full width: fp32 K1 to K5 all launched; then bf16
    # through the spec, its bf16 streams only
    with tempfile.TemporaryDirectory(prefix="chip_smoke_estimator_") as tmp:
        est, est_launches = counted(fp32_kernels, "the estimator",
                                    lambda: run_estimator(dev, tmp))
        est16, fit16_launches, eval16_launches = run_estimator_bf16(dev, tmp, counted)
    fp32_free("the bf16 estimator fit", fit16_launches)
    fp32_free("the bf16 estimator eval", eval16_launches)
    emit(dict(phase="estimator", card=smi, launches=est_launches, **est,
              bf16=dict(fit_launches=fit16_launches, eval_launches=eval16_launches, **est16)))
    torch.cuda.empty_cache()

    # phase 6d: the esn and ssm heads at the quarterly preset's full width.
    # The esn head runs K1, K3 (K4 and K5's dx-only launch in training, never
    # the full K5: its reservoir is frozen); the ssm head K1 and K2 only
    from repro_torch.core.esrnn import make_config

    heads_kernels = {"esn": dict(forecast=("hw_scan", "lstm_cell"),
                                 train=("hw_scan", "hw_scan_bwd", "lstm_cell_fwd",
                                        "lstm_cell_bwd_dx")),
                     "ssm": dict(forecast=("hw_scan",), train=("hw_scan", "hw_scan_bwd"))}
    lstm_free = ("lstm_cell", "lstm_cell_fwd", "lstm_cell_bwd", "lstm_cell_bwd_dx",
                 "lstm_cell_bf16", "lstm_cell_fwd_bf16", "lstm_cell_bwd_bf16",
                 "lstm_cell_bwd_dx_bf16")

    def head_launches(head, what, counts):
        if head == "ssm" and any(counts[k] for k in lstm_free):
            raise AssertionError(f"{what} launched LSTM-cell kernels: {counts}")
        if head == "esn" and (counts["lstm_cell_bwd"] or counts["lstm_cell_bwd_bf16"]):
            raise AssertionError(f"{what} launched the full K5: {counts}")

    def head_train_launches(cfg_h, steps, what, counts):
        # a run of `steps` dense steps: K2 once a step; for esn K4 and the
        # dx-only K5 once a cell step each; in the policy's stream dtype
        head_launches(cfg_h.head, what, counts)
        s = "_bf16" if cfg_h.precision == "bf16" else ""
        cells = forecast_steps(cfg_h, TRAIN_T) if cfg_h.head == "esn" else 0
        want = {f"hw_scan_bwd{s}": steps, f"lstm_cell_fwd{s}": steps * cells,
                f"lstm_cell_bwd_dx{s}": steps * cells}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"{what} launched {counts}, want {want}")

    for head in HEADS:
        fc, fc_launches = counted(heads_kernels[head]["forecast"], f"the {head} forecast",
                                  lambda: run_head_forecast(head, dev))
        head_launches(head, f"the {head} forecast", fc_launches)
        if head == "esn" and fc_launches["lstm_cell"] != (
                fc_launches["hw_scan"] * forecast_steps(cfg, T_LEN)):
            raise AssertionError(f"the esn forecast launched {fc_launches}")
        emit(dict(phase="heads", part="forecast", card=smi, launches=fc_launches, **fc))
    step_profiles = {}
    for head in HEADS + ("lstm",):          # the lstm beside them, in the same call
        cfg_h = make_config("quarterly", head=head)
        rec = dict(head=head)
        if head in HEADS:
            tr, tr_launches = counted(
                heads_kernels[head]["train"], f"{head} training",
                lambda: run_dense_train(cfg_h, data, dev, HEADS_STEPS, TRAIN_RTOL))
            head_train_launches(cfg_h, HEADS_STEPS, f"{head} training", tr_launches)
            rec.update(launches=tr_launches, **tr)
        bench, steps_rec = head_step_launches(cfg_h, data, dev)
        step_profiles[head] = profile_call(bench.step, match=STEP_MATCH)
        del bench
        emit(dict(phase="heads", part="train", card=smi, batch=TRAIN_BATCH, T=TRAIN_T, **rec,
                  **steps_rec))
    emit(dict(phase="heads", part="profile_train", call="one dense train step per head",
              batch=TRAIN_BATCH, T=TRAIN_T, card=smi, **step_profiles))
    cfg16_esn = make_config("quarterly", head="esn", precision="bf16")
    tr16, tr16_launches = counted(
        ("hw_scan_bf16", "hw_scan_bwd_bf16", "lstm_cell_fwd_bf16", "lstm_cell_bwd_dx_bf16"),
        "esn bf16 training",
        lambda: run_dense_train(cfg16_esn, data, dev, HEADS_BF16_STEPS, TRAIN16_RTOL))
    head_train_launches(cfg16_esn, HEADS_BF16_STEPS, "esn bf16 training", tr16_launches)
    fp32_free("esn bf16 training", tr16_launches)
    _, steps16 = head_step_launches(cfg16_esn, data, dev)
    emit(dict(phase="heads", part="train_bf16", card=smi, batch=TRAIN_BATCH, T=TRAIN_T,
              launches=tr16_launches, **tr16, **steps16))
    cfg_esn, esn_cpu = make_model(N_SERIES, head="esn")
    esn_ft, esn_ft_launches = counted(
        forecast_kernels + ("hw_scan_bwd", "lstm_cell_fwd", "lstm_cell_bwd_dx"),
        "the esn fine-tune server", lambda: run_finetune(
            cfg_esn, esn_cpu, params_to_device(esn_cpu, dev), dev))
    head_launches("esn", "the esn fine-tune server", esn_ft_launches)
    emit(dict(phase="heads", part="finetune", head="esn", card=smi, launches=esn_ft_launches,
              **esn_ft))
    del esn_cpu
    owa_missed = []
    for head in HEADS:
        rec, owa_launches = counted(heads_kernels[head]["train"], f"the {head} OWA cell",
                                    lambda: run_head_owa(head, dev))
        head_launches(head, f"the {head} OWA cell", owa_launches)
        emit(dict(phase="heads", part="owa", card=smi, launches=owa_launches, **rec))
        if not rec["passed"]:
            owa_missed.append((head, rec["owa"], rec["gate"]))
    if owa_missed:
        raise AssertionError(f"head OWA past its gate (head, OWA, gate): {owa_missed}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_heads_") as tmp:
        for head in HEADS:
            rec, cli_launches = counted(
                heads_kernels[head]["train"], f"the {head} CLI",
                lambda: run_head_cli(head, dev, tmp))
            head_launches(head, f"the {head} CLI", cli_launches)
            emit(dict(phase="heads", part="cli", card=smi, launches=cli_launches, **rec))
    torch.cuda.empty_cache()

    # phase 6e: the out-of-core chunked fit and the chunked verbs. K1, K2,
    # K4 and K5 in every chunk step, K1 and K3 in the streamed eval and
    # predict; the table pinned on the host, copied on a copy stream
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chunked_") as tmp:
        exact, exact_launches = counted(train_kernels + ("lstm_cell",), "the chunked fit",
                                        lambda: run_chunked_exact(cfg, data, dev, tmp))
        emit(dict(phase="chunked", part="exact", card=smi, phase_launches=exact_launches,
                  **exact))
        scale, scale_launches = counted(train_kernels + ("lstm_cell",), "the chunked scale cell",
                                        lambda: run_chunked_scale(dev, tmp))
        emit(dict(phase="chunked", part="scale", card=smi, launches=scale_launches, **scale))
        memref, _ = counted(train_kernels, "the peak_memory cell",
                            lambda: run_chunked_memory_reference(dev))
        emit(dict(phase="chunked", part="memory_reference", card=smi, **memref))
        cli_rec, cli_launches = counted(train_kernels + ("lstm_cell",), "the chunked CLI",
                                        lambda: run_chunked_cli(dev, tmp))
        emit(dict(phase="chunked", part="cli", card=smi, launches=cli_launches, **cli_rec))
    torch.cuda.empty_cache()
    # (b') the reference's own 1M gate, in a fresh process: its launches are
    # that process's, checked there by its losses and forecasts
    emit(dict(phase="chunked", part="million", card=smi, **run_million()))

    # phase 6f: series data parallelism. Two gloo ranks share the card (each
    # launches K1 to K5 on its share of the rows; their launches are checked
    # against this process's single-device runs), then one NCCL rank here
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        dp, dp_launches = counted(train_kernels + ("lstm_cell",), "the dp phase",
                                  lambda: run_dp(dev, tmp))
        emit(dict(phase="dp", part="ranks", card=smi, launches=dp_launches, **dp))
        dp_cli, dp_cli_launches = counted(train_kernels, "the dp CLI",
                                          lambda: run_dp_cli(dev, tmp))
        emit(dict(phase="dp", part="cli", card=smi, launches=dp_cli_launches, **dp_cli))
    torch.cuda.empty_cache()

    # phase 6g: the invariant auditor. Its fp32 and bf16 fits, forecasts and
    # dispatchers launch K1 to K5 in both streams (the esn fit K5's dx-only
    # launch); the gloo ranks' launches are theirs, checked by their audits
    analyze_kernels = train_kernels + ("lstm_cell", "lstm_cell_bwd_dx") + train16_kernels + (
        "lstm_cell_bf16",)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analyze_") as tmp:
        analyze, analyze_launches = counted(analyze_kernels, "the analyze phase",
                                            lambda: run_analyze(dev, tmp))
    emit(dict(phase="analyze", card=smi, launches=analyze_launches, **analyze))
    torch.cuda.empty_cache()

    # phase 7: the LM serving path. Card against CPU at full width, two
    # layers, fp32; then the full yi-6b in bf16 through the serve launcher's
    # generate, K6 held against its plain version on layer 0's own q, k, v,
    # and one profiled prefill
    lm_kernels = ("flash_attention",)
    parity, parity_launches = counted(
        lm_kernels, "the LM parity run",
        lambda: run_parity(dev, LM_ARCH, LM_PARITY_LAYERS, LM_PARITY_PROMPT))
    emit(dict(phase="lm_parity", card=smi, launches=parity_launches, **parity))
    lm = LMServe(dev, arch_config(LM_ARCH))
    serve_lm, lm_launches = counted(lm_kernels, "LM serving", lambda: run_lm_serve(lm))
    layer0 = check_k6_on(lm.k6_launches()[0], gen)
    emit(dict(phase="lm_serve", card=smi, launches=lm_launches, k6_layer0=layer0,
              **serve_lm))
    with torch.no_grad():
        prefill = profile_call(lambda: lm.prefill(), top=12)
        decode = profile_call(lm.decode_step(), top=12)
    emit(dict(phase="profile_lm", call="one yi-6b prefill", batch=LM_BATCH,
              prompt_len=LM_PROMPT, **prefill))
    emit(dict(phase="profile_lm_decode", call="one yi-6b decode step", batch=LM_BATCH,
              cache_len=LM_PROMPT + LM_GEN, **decode))
    del lm
    torch.cuda.empty_cache()

    # phase 7b: the MoE family; 7c: MLA
    run_moe_phases(dev, smi, counted, lm_kernels, gen)
    torch.cuda.empty_cache()
    run_mla_phases(dev, smi, counted, lm_kernels, gen)
    # phase 7d: the vlm image prefix, the Mamba2 LM and the hybrid
    torch.cuda.empty_cache()
    run_family_phases(dev, smi, counted, lm_kernels, gen)
    # phase 7e: the encoder-decoder (whisper-base), then the dense presets
    # not served before
    torch.cuda.empty_cache()
    run_encdec_phases(dev, smi, counted, lm_kernels, gen)
    run_dense_presets(dev, smi, counted, lm_kernels, gen)
    # phase 7e': tensor-parallel serving on two gloo ranks sharing the card
    # (every arch's parity, yi-6b served in bf16), then the dry-run
    torch.cuda.empty_cache()
    run_tp_phases(dev, smi, counted, lm_kernels)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        run_dryrun_phase(smi, tmp)
    # phase 7f: LM training, every family, at full width
    torch.cuda.empty_cache()
    run_train_phases(dev, smi, counted)
    # phase 7g: sharded LM training on 4 gloo ranks sharing the card; 7h:
    # the Torch examples, each in a process of its own
    torch.cuda.empty_cache()
    run_train_tp_phases(dev, smi, counted)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        run_examples_phase(smi, tmp)
    emit(dict(phase="done"))

    # phase 8: summary, one entry per ported kernel and stream dtype.
    # Launches: the main-path phases 3 to 7. Times at the first listed shape
    # of each (K1, K3 and their bf16 streams: the forecast batch, N = 24,000,
    # layer 0; K2, K4, K5: a train step at batch 256, layer 0; K6: one layer
    # of the yi-6b prefill)
    def entry(name, source, replaces, recs, library_ms):
        main_rec = recs[0]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=path_launches[name],
                    max_abs_err=max(r["max_abs_err"] for r in recs),
                    ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
                    bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
                    library_ms=library_ms)

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        entry("hw_scan", csrc + "hw_scan.cu", "src/repro/kernels/hw_scan.py:56", k1, None),
        entry("lstm_cell", csrc + "lstm_cell.cu", "src/repro/kernels/lstm_cell.py:56", k3,
              k3[0]["library_ms"]),
        entry("hw_scan_bwd", csrc + "hw_scan_bwd.cu", "src/repro/kernels/hw_scan.py:89",
              k2, None),
        entry("lstm_cell_fwd", csrc + "lstm_cell.cu", "src/repro/kernels/lstm_cell.py:72",
              k4, k4[0]["library_ms"]),
        entry("lstm_cell_bwd", csrc + "lstm_cell.cu", "src/repro/kernels/lstm_cell.py:90",
              k5, None),
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:28", k6, k6[0]["library_ms"]),
        entry("hw_scan_bf16", csrc + "hw_scan.cu", "src/repro/kernels/hw_scan.py:56", k1b,
              None),
        entry("lstm_cell_bf16", csrc + "lstm_cell_tc.cu", "src/repro/kernels/lstm_cell.py:56",
              k3b, k3b[0]["library_ms"]),
        entry("hw_scan_bwd_bf16", csrc + "hw_scan_bwd.cu", "src/repro/kernels/hw_scan.py:89",
              k2b, None),
        entry("lstm_cell_fwd_bf16", csrc + "lstm_cell_tc.cu",
              "src/repro/kernels/lstm_cell.py:72", k4b, k4b[0]["library_ms"]),
        entry("lstm_cell_bwd_bf16", csrc + "lstm_cell_bwd_tc.cu",
              "src/repro/kernels/lstm_cell.py:90",
              k5b, None),
        # K5's dx-only launch (the esn head's frozen reservoir): no PyTorch
        # call gives a cell's input gradients alone
        entry("lstm_cell_bwd_dx", csrc + "lstm_cell.cu", "src/repro/kernels/lstm_cell.py:90",
              k5dx, None),
        entry("lstm_cell_bwd_dx_bf16", csrc + "lstm_cell_bwd_tc.cu",
              "src/repro/kernels/lstm_cell.py:90", k5dxb, None),
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
