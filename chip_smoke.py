#!/usr/bin/env python3
"""Drive the PyTorch port (`deeplearning4j_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero with no result line:

1. device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of every CUDA kernel from `csrc/` (one
   nvcc a source, all at once);
2. kernels: every kernel of the port against its plain PyTorch version
   on the card, each with its time (cold L2), its bound, the plain
   version's time and one PyTorch library call's time as a yardstick
   (the port never calls it):
   - the decode-attention kernels B5 (slot pool) and B6 (paged pool)
     over GQA ratios, visibility modes, page lengths, shared pages and
     dtypes (B5q also at path_s's linear pools, Hkv 8, L 2048), against
     `F.scaled_dot_product_attention` over the gathered cache; each
     B5/B5q and B6/B6q row names its design (float32 queries on the
     split grid, "split", bfloat16 caches on design 1, "ffma") and its
     share of the bound, and a design-2 row also holds
     and times design 1 on the same inputs (`ffma_ms`); then design 2
     twice at Path A's shape over float32, int8 and e4m3 pages
     (`b6_repeat`) and at Path B's over its ring (`b5_repeat`),
     bit-equal;
   - the flash-attention forward B3a and backward B3b/B3c at the
     training paths' shape (B 8, H 8, T 2048, Dh 64, causal) in float32
     and bfloat16 and at ragged, cross, narrow and wide variants of
     both, against SDPA's forward and backward; each row names the
     design that ran (bfloat16 at Dh 64 and 128 on the tensor cores,
     "wgmma"; float32 there, forward and backward, on the tensor cores
     as three TF32 products, "tf32x3"; else float32 FMA, "ffma"), its
     TFLOP/s and its share of its design's bound (`flash_rate`), and the
     bfloat16 main shape and every "tf32x3" row also time design 1 on the
     same inputs (`ffma_ms`); a "tf32x3" row also holds both designs
     against the plain forward (o and lse) or backward in float64 (the
     guard: at most twice design 1's error) and its SDPA yardstick names
     the kernels SDPA ran; a
     bfloat16 forward or backward must lie nearer the plain version that
     rounds P and dS (C6) than the one that does not; then designs 2 and
     3 twice at that shape and at Dh 128, o, lse, dq, dk and dv
     bit-equal (`flash_repeat`);
   - the banded forward B4 at `path_w`'s shape and its variants
     (`banded_cases`), against SDPA with the band as a mask; each row
     names its design (float32 at Dh 32/64/128 on the folded grid,
     "folded"; bfloat16 on design 1, "ffma"), and a design-2 row also
     holds and times design 1 on the same inputs (`ffma_ms`) and checks
     two launches of design 2 bit-equal;
   - the fused Adam B1a over the training path's leaves and odd sizes,
     float32 and bfloat16, steps 1 and 1000, over LeNet's bfloat16
     leaves (`path_m`), over `path_p`'s VAE and center-loss head
     (float32, step 12) and over `path_i`'s InceptionResNetV1 (every
     leaf, Adam(1e-3), step 4) and Keras VGG transfer head (its
     unfrozen leaves, Adam(1e-5), step 6), against
     `torch.optim.Adam(fused=True)` (which puts ε inside the bias
     correction: a time yardstick, not the same function);
   - the fused LSTM forward B2a (with residuals) and B2b (inference) and
     the backward B2c (its reverse-time kernel and its weight-gradient
     launch) at the recurrent paths' shapes (T 128, B 64, H 512; T 200,
     50, 8, 4 and 1 at B 32, H 256), peepholes on and off, masked and
     not, against cuDNN's LSTM (`torch.nn.LSTM`, which also does the
     input projection and has no peepholes or mask: a time yardstick)
     and, for the weight gradients, one `torch.matmul`; each forward row
     names the design `b2_design` picked (the persistent grid, design 2,
     from T 8, else the cluster design 1) and holds and times the other
     one on the same inputs; design 2 twice, bit-equal; B2c's rows the
     same with its two designs a launch (the recurrence by
     `b2c_design`: "persistent" from T 8, else "cluster"; the weight
     product "pipelined", design 1 "tiled"), both designs of both
     launches held to the plain backward at every shape with T > 1;
   - the fused Nesterovs B1b over the LSTM training path's leaves and
     odd sizes, float32 and bfloat16, and over `path_p`'s first RBM and
     `path_i`'s GoogLeNet and AlexNet (every leaf, float32, momentum
     0.9), against `torch.optim.SGD(momentum,
     nesterov=True, fused=True)` (PyTorch's form of Nesterov momentum,
     not ND4J's: a time yardstick);
   - the conv+BN statistics kernels B7a (1x1 as a matmul) and B7b (3x3
     SAME) at every distinct shape of `path_r` (ResNet-50 at batch 128:
     15 and 4 shapes) and at ragged ones, float32 and bfloat16, against
     `torch.matmul` / `F.conv2d` computing y alone (a time yardstick);
     each row names the design that ran (bfloat16 on the tensor cores,
     "wgmma"; aligned float32 on the tensor cores as 3xTF32, "tf32x3";
     otherwise exact FMA, "ffma"), its TFLOP/s and its share of the
     bound at the design's rate; rows on "wgmma" and "tf32x3" also time
     design 1 on the same inputs, and float32 rows on "tf32x3" hold the
     guard (y, Σy and Σy² against float64 within twice design 1's error)
     and two launches bit-equal; then designs 2 and 3 twice on a shape of
     each kernel, y and the statistics bit-equal;
3. path_a: decode serving of `TextGenerationTransformer` at the width
   of the repo's largest transformer (d_model 512, 8 heads, 6 blocks,
   T 2048) through `DecodeSessionManager`, prefix cache on, so the
   paged pool and B6 carry every decode step, every launch on design 2;
   a second wave shares a 1024-token stem and hits the prefix cache;
   every decode window of every serving path is one CUDA graph replay
   (captured at the manager's warm-up), and Path A serves both waves
   again through the eager loop, every stream equal token for token;
4. path_b: the Llama-shaped variant (RoPE, RMSNorm, SwiGLU, 2 KV heads
   under 8, window 256, rolling cache) at 2 blocks; the rolling ring
   cannot page, so the slot pool and B5 carry it, every launch on design
   2, and the streams run past the ring's length so it wraps;
5. cpu_parity: the port on the card against the port on the CPU, same
   weights, one short greedy prompt; then path_q (quantized pools, see
   `path_q`), and:
   - path_h: Path A's model and 8 cold prompts through
     `InferenceServer` on 127.0.0.1 (8 client threads, SSE, 64 greedy
     tokens), every stream equal to the direct `DecodeSessionManager`'s;
     `/metrics` reconciles; `/models`, `/healthz`, "stream": false and
     `POST /output` (batch 8, within 1e-5 of `net.output`); `deploy()`
     of another seed while 4 streams run (they complete, a later stream
     equals the new net's), and a candidate with 2 KV heads rolled back;
     B6 on design 2 throughout, B3a on `/output` and the warm-ups (all
     on design 3); a
     padded `/output` batch (9 rows in the bucket of 32) timed against
     the exact one;
   - path_s: speculative decoding with a 1-block truncated draft sharing
     the target's weights (spec_k 8) through `InferenceServer`: streams
     equal the non-spec decode's; the windows eager against graphed
     (packed rows and streams); the silenced pair's acceptance at least
     0.85 and an EOS inside a window; an int8 leg (B5q) against
     non-spec int8, and the silenced pair at int8 (acceptance at least
     0.85); the draft's steps on B5 (B5q), design 2;
6. path_t: training of the same model at full width (6 blocks, T 2048,
   batch 8, float32, its default Adam(3e-4)) through `net.fit`: 4 fixed
   batches of random tokens, 3 epochs, 12 steps; B3a/B3b/B3c carry the
   attention (all on design 3, 3xTF32) and B1a the update; steps 2-12
   run under `torch.cuda.set_sync_debug_mode("error")`, and the losses
   are read after the steps;
7. train_parity: two Adam steps of a 2-block model at T 256 on the card
   against the same on the CPU, same weights and batch;
   then path_t_bf16: `path_t` in bfloat16, the dtype `bench.py` trains
   this model in (`BENCH_DTYPE`'s default; the zoo conf with its dtype
   replaced, as `_bench_transformer` builds it): B3b and B3c six times a
   step each, B3a six, all on design 2, and B1a once, the same sync
   guard; then `path_t_bf16_k`: the same 12 steps at K 1 twice and at
   K 4 (`fit(steps_per_dispatch=4)`: window 1 eager, then captured,
   windows 2-3 replayed), K 4 bit-equal to K 1 or within the two K 1
   runs' spread, with the same launch counts; and train_parity_bf16,
   `train_parity` in bfloat16 with the tolerances bf16 training allows
   (`TRAIN_PARITY_BF16`), each leaf's update also within 15% of the
   CPU's;
8. path_l: training of the repo's LSTM bench model at full width
   (GravesLSTM(512) x 2 + RnnOutputLayer(64), input width 128, T 128,
   batch 64, float32, Nesterovs(0.01, 0.9)) through `net.fit`: 4 fixed
   batches, two of them with ragged feature masks, 3 epochs, 12 steps;
   B2a and B2c (all on design 2, both launches) run twice a step and
   B1b once; steps
   2-12 run under
   `torch.cuda.set_sync_debug_mode("error")`;
9. path_g: the zoo's `TextGenerationLSTM` (LSTM(256) x 2, 77 characters,
   Adam(1e-3), tBPTT 50) at its own width: one epoch of `fit` on 2
   batches of 32 one-hot sequences of T 200 (four chunks of 50 with the
   carries handed on: B2a and B2c on design 2, B1a), `output()` on one
   batch (B2b at T 200, design 2), then a greedy loop of 200
   `rnn_time_step` calls for 32 streams (B2b at T 1, design 1, twice a
   call), each call a graph replay, and the same loop eagerly, tokens
   equal;
10. lstm_parity: both recurrent models at T 32, batch 4: two `fit` steps
    and 8 `rnn_time_step` calls on the card against the same on the CPU;
11. path_r: `bench.py`'s ResNet-50 (224x224, 1000 classes, bfloat16,
    batch 128; Nesterovs at 0.01 where the bench has 0.1, so that the
    loss falls) as a fused ComputationGraph through
    `net.fit`: 4 fixed batches, 3 epochs, 12 steps; B7a 36 and B7b 16
    times a step, every launch on design 2, B1b once; steps 2-12 under
    `torch.cuda.set_sync_debug_mode("error")`; then `output()`, which
    launches no B7; then the same 12 steps unfused (cuDNN convolutions,
    plain batch norms), as information; then `path_r_f32`, the same
    fused and unfused in float32 (the zoo's dtype), TF32 off: every B7
    launch on design 3, "tf32x3";
12. resnet_parity: the fused ResNet-50 at 64x64, batch 16, float32 (B7
    on design 3): two Nesterovs steps on the card against the CPU, then
    `output()` of both on the card's trained weights;
13. path_m: LeNet as a user drives it (the zoo's LeNet, bfloat16 as
    `bench.py` trains it, its default Adam(1e-3): B1a once a step) on the
    port's `MnistDataSetIterator` (synthetic unless MNIST files are
    present) at batch 1024: 4 batches x 3 epochs = 12 steps through
    `net.fit`, steps 2-12 under the same sync guard; `evaluate()` over the
    10,000-image test split against the card's argmax of `output()` on the
    same batches; `save_model` / `load_model` onto the card, `output()`
    bit-equal; then `path_m_k`, as `path_t_bf16_k`;
14. lenet_parity: LeNet in float32 at batch 64, 8 steps, card against
    CPU from the same JSON and weights, under Sgd, Adam (B1a) and
    Nesterovs (B1b);
15. host_overhead: `bench.py`'s host-overhead mode on its MLP: ms a step
    in sync, deferred, fused (K 8, one graph a window) and floor (one
    graph of 256 steps) modes;
16. graph_parity: SimpleCNN (batch norm, dropout) and a small
    Nesterovs ComputationGraph at K 4 against K 1, bit for bit, with
    the same launch counts; a 2-block transformer's graphed decode
    windows against the eager loop, and a lane whose EOS falls inside
    a window stops AT it.
17. path_gen: lockstep generation through `utils.textgen` at Path A's
    width (6 blocks, T 2048, batch 8, float32): greedy `generate` over
    8 prompts of 1024 tokens (prefill chunks of 128) to the end of the
    cache, every decode step one `rnn_time_step` graph replay with B5
    six times on design 2, its probabilities against `output()`'s
    teacher-forced ones within 1e-4, a step past the cache refused
    before anything launches, B5 at the broadcast position against its
    plain version; nucleus sampling (every token in its step's nucleus
    of the teacher-forced probabilities); `beam_search` over 2 prompts
    at width 1 (= greedy) and 4, the beam's probabilities followed
    back through the recorded parents against `output()`'s; Path B's
    ring (B5 twice a step) past its length against the port on the
    CPU; the 2-block stack and `TextGenerationLSTM` (B2b) as
    ComputationGraphs against the sequential nets;
18. path_ckpt: `path_t_bf16`'s model with gradient checkpointing, 8
    steps at K 1 and at K 4 against 8 without it from the same weights
    (B3a twelve times a step, B3b/B3c six, design 2; B1a once), the
    peak memory lower; a float32 2-block model with dropout,
    checkpointed against plain;
19. path_x: `examples/seq2seq_cross_attention.py`'s graph at width
    (Tq 2048, Tk 1024, batch 8) fed MultiDataSets, 8 Adam steps at K 1
    and K 4 in bfloat16 (B3a-c non-causal on design 2) and float32
    (design 3), then card against CPU at Tq 256, Tk 200.
20. path_p: DL4J's fit stages besides SGD (A1b) at its examples' widths
    on the MNIST iterator: `pretrain` of DeepAutoEncoderExample's nine
    RBMs (784-1000-500-250-100-30 and back, batch 1000, 4 batches a
    layer, Nesterovs: B1b once a step, 36), `fit` of one batch under
    line_gradient_descent and lbfgs (20 iterations each, the loss
    history non-increasing, one host read a line-search probe), the
    VariationalAutoEncoderExample VAE pretrained 12 steps (Adam: B1a
    once a step, the ELBO improving), the frozen encoder under a
    center-loss head (B1a over the head alone, frozen leaves bit-equal,
    K 4 against K 1); then `p_parity`: AutoEncoder pretraining, line
    gradient descent and every activation on the card against the CPU;
21. path_m_async: `path_m` at K 1 and K 4 fed through
    `AsyncDataSetIterator` beside the bare iterator, three times each in
    alternating order: losses bit-equal, images/s, the host's split of a
    step (the source's reshuffle and slices, the fit loop's wait for a
    batch, its enqueue), the idle share (profiler) and the pump's hit
    ratio.
22. path_i: the rest of the CNN family and model import (slice 21) at
    full width, float32: GoogLeNet (224x224x3, 1000 classes, batch 32,
    6 steps, Nesterovs: B1b once a step), InceptionResNetV1 (160x160x3,
    batch 32, 4 steps, Adam: B1a), AlexNet (224x224x3, batch 64, 6
    steps, B1b), and a VGG16-shaped Keras Sequential configuration
    (`keras_vgg`: DepthwiseConv2D, SeparableConv2D, Conv2DTranspose,
    UpSampling2D and Cropping2D among its convolutions, a 4096-4096
    dense head) imported from its JSON with Keras-layout weights from
    numpy, its convolution stack frozen by `TransferLearning`, its head
    replaced by 10 classes, 6 Adam(1e-5) steps (B1a over the head alone,
    the frozen tensors bit-equal). Each: step ms p50, images/s, B1a/B1b
    launches equal to the steps, finite losses, and the card's
    pre-softmax outputs against the port's on the CPU on the same
    weights; before the VGG fit, one Adam step on one batch at lr 1e-5
    and 1e-7 from the same weights, that batch's loss read before and
    after (the gradient points down: the smaller step lowers it).

Weights are random, from fixed seeds. Each path resets the kernels'
launch counts just before it runs and reads them just after; a kernel
of the path that was never launched, or a plain version called on a
CUDA tensor, fails the run. The last lines are the kernels' summary, the
card's name and power limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32 products on the tensor cores as three TF32 products (design 3
# of B3b/B3c): the dense TF32 rate, 495 TFLOP/s, over three
PEAK_FLOPS_TF32X3 = 495e12 / 3
# (atol, rtol) of a kernel against its plain version, in the working
# dtype. Both compute in float32 and round once; in bfloat16 they may
# then land one bf16 step apart, at most 2**-7 of the value.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
REPLACES = {
    "banded_decode_attention":
        "deeplearning4j_tpu/ops/banded_attention.py:314 (_decode_kernel)",
    "paged_decode_attention":
        "deeplearning4j_tpu/ops/banded_attention.py:487 "
        "(_paged_decode_kernel)",
    "banded_decode_attention_q":
        "deeplearning4j_tpu/ops/banded_attention.py:314 (_decode_kernel, "
        "quant=True: :327, :364-367)",
    "paged_decode_attention_q":
        "deeplearning4j_tpu/ops/banded_attention.py:487 "
        "(_paged_decode_kernel, quant=True: :499, :528-531)",
    "banded_attention":
        "deeplearning4j_tpu/ops/banded_attention.py:117 (_banded_kernel)",
    "flash_attention_fwd":
        "deeplearning4j_tpu/ops/attention.py:64 (_flash_kernel)",
    "flash_attention_bwd_dkdv":
        "deeplearning4j_tpu/ops/attention.py:211 (_flash_bwd_dkdv_kernel)",
    "flash_attention_bwd_dq":
        "deeplearning4j_tpu/ops/attention.py:251 (_flash_bwd_dq_kernel)",
    "adam_update":
        "deeplearning4j_tpu/ops/fused_update.py:46 (_adam_kernel)",
    "nesterov_update":
        "deeplearning4j_tpu/ops/fused_update.py:63 (_nesterov_kernel)",
    # no Pallas body: JAX's Adam computes its bias-corrected rate with XLA
    # operations, which the port's updater launches one kernel for
    "adam_lrbc": "deeplearning4j_tpu/optim/updaters.py:193 (Adam's "
                 "bias-corrected rate, XLA operations)",
    "lstm_fwd": "deeplearning4j_tpu/ops/lstm.py:61 (_fwd_kernel)",
    "lstm_fwd_inference":
        "deeplearning4j_tpu/ops/lstm.py:92 (_fwd_kernel_inference)",
    "lstm_bwd": "deeplearning4j_tpu/ops/lstm.py:166 (_bwd_kernel: dxw, "
                "dh0, dc0)",
    "lstm_bwd_weights": "deeplearning4j_tpu/ops/lstm.py:166 (_bwd_kernel: "
                        "dRW, dP)",
    "lstm_fwd_bf16": "deeplearning4j_tpu/ops/lstm.py:61 (_fwd_kernel, "
                     "bfloat16 xw)",
    "lstm_fwd_inference_bf16":
        "deeplearning4j_tpu/ops/lstm.py:92 (_fwd_kernel_inference, "
        "bfloat16 xw)",
    "lstm_bwd_bf16": "deeplearning4j_tpu/ops/lstm.py:166 (_bwd_kernel: "
                     "dxw, dh0, dc0; bfloat16)",
    "lstm_bwd_weights_bf16": "deeplearning4j_tpu/ops/lstm.py:166 "
                             "(_bwd_kernel: dRW, dP; bfloat16)",
    "conv1x1_bn_stats":
        "deeplearning4j_tpu/ops/conv_fused.py:69 (_mm_stats_kernel)",
    "conv3x3_bn_stats":
        "deeplearning4j_tpu/ops/conv_fused.py:167 (_conv3_stats_kernel)",
}
SOURCES = {
    "banded_decode_attention":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "banded_decode_attention_q":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention_q":
        "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
    "banded_attention": "deeplearning4j_tpu_torch/csrc/banded_attention.cu",
    "flash_attention_fwd": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkdv":
        "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq":
        "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
    "adam_update": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
    "nesterov_update": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
    "adam_lrbc": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
    "lstm_fwd": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_fwd_inference": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_bwd": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_bwd_weights": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_fwd_bf16": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_fwd_inference_bf16": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_bwd_bf16": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "lstm_bwd_weights_bf16": "deeplearning4j_tpu_torch/csrc/lstm.cu",
    "conv1x1_bn_stats": "deeplearning4j_tpu_torch/csrc/conv_fused.cu",
    "conv3x3_bn_stats": "deeplearning4j_tpu_torch/csrc/conv_fused.cu",
}
# products a kernel computes over each visible (query, key) pair, 2 Dh
# flops each: forward S and PV; dK/dV kernel S, dP, dV, dK; dQ kernel
# S, dP, dQ
FLASH_PRODUCTS = {"flash_attention_fwd": 2, "flash_attention_bwd_dkdv": 4,
                  "flash_attention_bwd_dq": 3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing
def time_ms(fn, flush: torch.Tensor, iters: int = 30) -> float:
    """Mean device time of `fn` over `iters` launches, each preceded by
    a write of `flush` (larger than the 50 MB L2) so every launch finds
    the cache cold, as a decode step does after the other layers'."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def queued_ms(fn, flush: torch.Tensor, iters: int = 30,
              lead_cycles: int = 2_000_000) -> float:
    """`time_ms` with the host ahead of the card: before each flush the
    card spins `lead_cycles` cycles (about 1 ms), so the launch is queued
    before the card reaches it and the events time the kernel alone, not
    a host that is slower than the flush (a B1 launch checks every
    gradient on the host)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(lead_cycles)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def graph_ms(fn, flush: torch.Tensor, side: torch.cuda.Stream,
             iters: int = 30) -> float:
    """`time_ms` of `fn` captured once in a CUDA graph on stream `side`
    and replayed: the device time of a call that launches many kernels
    from the host (a library yardstick such as SDPA's autograd backward,
    whose forward the caller ran on `side`, where autograd then runs the
    backward), without the gaps where the card waits for the host."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    return time_ms(graph.replay, flush, iters)


# ------------------------------------------------------- phase 2: kernels
def kv_rows(vis, page_table=None, page_len=None):
    """Distinct K/V rows the visible keys live in. A slot-pool slot owns
    its rows; slots whose page tables share a page read its rows once."""
    if page_table is None:
        return int(vis.sum())
    s_idx, j = vis.nonzero(as_tuple=True)
    phys = page_table.long()[s_idx, j // page_len] * page_len + j % page_len
    return int(torch.unique(phys).numel())


def bound(vis, rows, q, hkv, dtype, extra_bytes, kv_dtype=None):
    """(bound_ms, bound_by): the larger of the bytes this call must move
    (the `rows` distinct visible K and V rows — quantized, one byte an
    element plus two 4-byte scales a row and kv head — q, out, indices)
    over HBM bandwidth and its operations (QK and PV, 4 flops per slot's
    visible key, head and head dim) over the peak rate of its dtype."""
    esize = torch.tensor([], dtype=dtype).element_size()
    kv_esize = torch.tensor([], dtype=kv_dtype or dtype).element_size()
    S, H, Dh = q.shape
    scale_bytes = 0 if kv_dtype is None else rows * 2 * hkv * 4
    nbytes = rows * 2 * hkv * Dh * kv_esize + scale_bytes \
        + 2 * q.numel() * esize + extra_bytes
    flops = int(vis.sum()) * 4 * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k_log, v_log, vis, scales=None):
    """One `scaled_dot_product_attention` over the logical [S, L, Hkv,
    Dh] cache with the same boolean mask: the library yardstick. With
    `scales` (the logical [S, L, Hkv] scale rows of quantized caches) a
    dequantize pass comes first, inside the timed call."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.banded_attention import dequantize

    qh = q[:, :, None, :]                       # [S, H, 1, Dh]
    mask = vis[:, None, None, :]
    gqa = q.shape[1] != k_log.shape[2]

    def call():
        k, v = k_log, v_log
        if scales is not None:
            k = dequantize(k, scales[0], q.dtype)
            v = dequantize(v, scales[1], q.dtype)
        return F.scaled_dot_product_attention(
            qh, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=gqa)
    return call


def kernel_cases():
    """The slice's own shapes (S 8, H 8, Dh 64) over the variations the
    kernels must hold; the two `main` cases are exactly what Path A (B6)
    and Path B (B5) hand the kernels."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for hkv in (8, 2):
            for mode in ("linear", "window", "rolling"):
                cases.append(dict(kernel="banded_decode_attention", dtype=dt,
                                  hkv=hkv, mode=mode,
                                  L=2303 if mode == "rolling" else 2048,
                                  main=(dt == torch.float32 and hkv == 2
                                        and mode == "rolling"),
                                  path_s=(dt == torch.float32 and hkv == 8
                                          and mode == "linear")))
            for lp in (128, 16):
                cases.append(dict(kernel="paged_decode_attention", dtype=dt,
                                  hkv=hkv, mode="paged", L=2048,
                                  page_len=lp,
                                  main=(dt == torch.float32 and hkv == 8
                                        and lp == 128)))
    # B5q and B6q at the shapes path_q hands them (path_b's ring, path_a's
    # pages), and B5q at path_s's int8 leg's (the draft's and the
    # target's linear slot pools of Path A's width), int8 and e4m3 codes
    # under float32 queries
    for kv in (torch.int8, torch.float8_e4m3fn):
        main = kv == torch.int8
        cases.append(dict(kernel="banded_decode_attention_q",
                          dtype=torch.float32, kv=kv, hkv=2, mode="rolling",
                          L=2303, main=main))
        cases.append(dict(kernel="banded_decode_attention_q",
                          dtype=torch.float32, kv=kv, hkv=8, mode="linear",
                          L=2048, main=False, path_s=main))
        cases.append(dict(kernel="paged_decode_attention_q",
                          dtype=torch.float32, kv=kv, hkv=8, mode="paged",
                          L=2048, page_len=128, main=main))
    return cases


def run_kernel_case(c, flush, gen):
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    dev = flush.device
    dt, hkv, L, S, H, Dh = c["dtype"], c["hkv"], c["L"], 8, 8, 64
    kv = c.get("kv")
    scales = []

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dt)

    def cache(*shape):
        # quantized cases: codes, their scale rows kept in `scales`
        if kv is None:
            return rnd(*shape)
        codes, sc = quantize_kv(rnd(*shape), kv)
        scales.append(sc)
        return codes

    q = rnd(S, H, Dh)
    window = None if c["mode"] in ("linear", "paged") else 256
    rolling = c["mode"] == "rolling"
    if rolling:
        # spread over the first pass and well past it: the ring wraps
        qpos = torch.tensor([0, 5, 255, 1000, 2302, 2303, 2900, 5000])
    else:
        # spread across the cache, first and last position included
        qpos = torch.linspace(0, L - 1, S).round().long()
    qpos = qpos.to(dev, torch.int32)
    end = qpos.clone()
    pt = lp = None
    lib_scales = None
    if c["mode"] == "paged":
        lp = c["page_len"]
        npg = L // lp
        P = S * npg
        kc, vc = cache(P, lp, hkv, Dh), cache(P, lp, hkv, Dh)
        sk, sv = scales or (None, None)
        pt = torch.randperm(P, generator=gen).reshape(S, npg)
        pt[1:, : npg // 4] = pt[0, : npg // 4]    # a shared prefix chain
        pt = pt.to(dev, torch.int32)
        run = lambda: ba.paged_decode_attention(  # noqa: E731
            q, kc, vc, pt, qpos, scale_k=sk, scale_v=sv)
        plain = lambda: ba.paged_decode_attention_plain(  # noqa: E731
            q, kc, vc, pt, qpos, scale_k=sk, scale_v=sv)
        k_log, v_log = ba.gather_pages(kc, pt), ba.gather_pages(vc, pt)
        if kv is not None:
            lib_scales = (ba.gather_pages(sk, pt), ba.gather_pages(sv, pt))
        extra = pt.numel() * 4 + S * 4
    else:
        kc, vc = cache(S, L, hkv, Dh), cache(S, L, hkv, Dh)
        sk, sv = scales or (None, None)
        run = lambda: ba.banded_decode_attention(  # noqa: E731
            q, kc, vc, qpos, end, window=window, rolling=rolling,
            scale_k=sk, scale_v=sv)
        plain = lambda: ba.decode_attention_plain(  # noqa: E731
            q, kc, vc, qpos, end, window=window, rolling=rolling,
            scale_k=sk, scale_v=sv)
        k_log, v_log = kc, vc
        lib_scales = scales or None
        extra = 2 * S * 4
    vis = ba.visibility(qpos, end, L, window, rolling)
    live = vis.any(dim=1)        # rows with no visible key are garbage
    atol, rtol = TOL[dt]

    def held(out, ref, what):
        diff = (out[live].float() - ref[live].float()).abs()
        err = diff.max().item()
        ok = bool((diff <= atol + rtol * ref[live].float().abs()).all())
        check(ok, f"{what} {c} disagrees with its plain version: max abs "
              f"err {err}, tolerance atol {atol} + rtol {rtol} * |ref|")
        return err

    before = dict(ba.LAUNCHES_BY_DESIGN)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    paged = c["mode"] == "paged"
    design = new_design(ba.LAUNCHES_BY_DESIGN, before, c["kernel"])
    err = held(out, ref, c["kernel"])
    # the kernel's device time from a CUDA graph: a decode wrapper's host
    # path (tens of microseconds a call, `tools/torch_b5_splits.py`) can
    # outlast the flush before it, so an eager launch's events time the
    # host
    side = torch.cuda.Stream(device=dev)
    ms = graph_ms(run, flush, side)
    plain_ms = time_ms(plain, flush)
    library_ms = time_ms(sdpa_call(q, k_log, v_log, vis, lib_scales), flush)
    rows = kv_rows(vis, pt, lp)
    bms, by = bound(vis, rows, q, hkv, dt, extra, kv)
    row = {"phase": "kernels", "kernel": c["kernel"],
           "dtype": str(dt).replace("torch.", ""),
           "kv_dtype": str(kv or dt).replace("torch.", ""), "S": S, "H": H,
           "Hkv": hkv, "Dh": Dh, "L": L, "mode": c["mode"],
           "page_len": c.get("page_len"), "window": window,
           "visible_keys": int(vis.sum()), "kv_rows": rows,
           "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "bound_share": bms / ms, "design": design,
           "main_path_shape": c["main"],
           "path_s_shape": c.get("path_s", False)}
    if design == "split" and paged:
        row["split_pages"] = ba.b6_splits(S, hkv, pt.shape[1], lp,
                                          ba._sm_count(q.device))
        row["nsplit"] = -(-pt.shape[1] // row["split_pages"])

        # design 1 on the same inputs, held to the same limit
        def run1():
            return ba.paged_decode_attention(q, kc, vc, pt, qpos,
                                             scale_k=sk, scale_v=sv,
                                             design="ffma")
    elif design == "split":
        row["split_keys"], row["nsplit"] = ba.b5_splits(
            S, hkv, L, window, ba._sm_count(q.device),
            ba.split_tile_keys(Dh, kc.dtype))

        def run1():
            return ba.banded_decode_attention(
                q, kc, vc, qpos, end, window=window, rolling=rolling,
                scale_k=sk, scale_v=sv, design="ffma")
    if design == "split":
        row["ffma_max_abs_err"] = held(run1(), ref, f"{c['kernel']} (ffma)")
        row["ffma_ms"] = graph_ms(run1, flush, side)
        row["speedup_over_ffma"] = row["ffma_ms"] / ms
    emit(row)
    return row


def run_b6_repeat(gen):
    """Design 2 of B6 (float32 pages) and B6q (int8, e4m3) launched
    twice at Path A's and path_q's shape (S 8, H 8, Hkv 8, Dh 64, L
    2048, pages of 128): outputs bit-equal (each slot's splits merged in
    split order by the last block to arrive, whichever it is)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    rows = []
    S, H, hkv, Dh, lp, npg = 8, 8, 8, 64, 128, 16
    qpos = torch.linspace(0, lp * npg - 1, S).round().to("cuda", torch.int32)
    pt = torch.randperm(S * npg, generator=gen).reshape(S, npg)
    pt = pt.to("cuda", torch.int32)
    q = torch.randn(S, H, Dh, generator=gen).to("cuda")
    for kv in (torch.float32, torch.int8, torch.float8_e4m3fn):
        k, v = (torch.randn(S * npg, lp, hkv, Dh, generator=gen).to("cuda")
                for _ in range(2))
        sk = sv = None
        if kv != torch.float32:
            (k, sk), (v, sv) = quantize_kv(k, kv), quantize_kv(v, kv)
        name = "paged_decode_attention" + ("" if sk is None else "_q")
        before = ba.LAUNCHES_BY_DESIGN[(name, "split")]
        a, b = (ba.paged_decode_attention(q, k, v, pt, qpos, scale_k=sk,
                                          scale_v=sv) for _ in range(2))
        torch.cuda.synchronize()
        check(ba.LAUNCHES_BY_DESIGN[(name, "split")] == before + 2,
              f"b6 repeat {kv}: design 2 did not take both launches")
        check(torch.equal(a, b), f"b6 repeat {kv}: two launches differ")
        rows.append({"phase": "b6_repeat", "kernel": name,
                     "kv_dtype": str(kv).replace("torch.", ""),
                     "design": "split", "bit_equal": True})
        emit(rows[-1])
    return rows


def run_b5_repeat(gen):
    """Design 2 of B5 (float32 ring) and B5q (int8, e4m3) launched twice
    at Path B's and path_q's shape (S 8, H 8, Hkv 2, Dh 64, a ring of
    2303, window 256, positions before, at and past its length): outputs
    bit-equal (each slot's chunks merged in chunk order by the last block
    to arrive, whichever it is)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    rows = []
    S, H, hkv, Dh, L = 8, 8, 2, 64, 2303
    qpos = torch.tensor([0, 5, 255, 1000, 2302, 2303, 2900, 5000],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(S, H, Dh, generator=gen).to("cuda")
    for kv in (torch.float32, torch.int8, torch.float8_e4m3fn):
        k, v = (torch.randn(S, L, hkv, Dh, generator=gen).to("cuda")
                for _ in range(2))
        sk = sv = None
        if kv != torch.float32:
            (k, sk), (v, sv) = quantize_kv(k, kv), quantize_kv(v, kv)
        name = "banded_decode_attention" + ("" if sk is None else "_q")
        before = ba.LAUNCHES_BY_DESIGN[(name, "split")]
        a, b = (ba.banded_decode_attention(q, k, v, qpos, qpos, window=256,
                                           rolling=True, scale_k=sk,
                                           scale_v=sv) for _ in range(2))
        torch.cuda.synchronize()
        check(ba.LAUNCHES_BY_DESIGN[(name, "split")] == before + 2,
              f"b5 repeat {kv}: design 2 did not take both launches")
        check(torch.equal(a, b), f"b5 repeat {kv}: two launches differ")
        rows.append({"phase": "b5_repeat", "kernel": name,
                     "kv_dtype": str(kv).replace("torch.", ""),
                     "design": "split", "bit_equal": True})
        emit(rows[-1])
    return rows


# --------------------------------------------- kernels: flash (B3a-c)
def flash_cases():
    """The training paths' shape (B 8 x H 8 = BH 64, T 2048, Dh 64,
    causal) in float32 (`path_t`) and bfloat16 (`path_t_bf16`), and the
    variants the kernels must hold: a ragged T, Tq != Tk, head dims 32
    and 128, in float32 (B3a-c on design 3 at Dh 64 and 128, design 1 at
    Dh 32) and bfloat16 (design 2 at Dh 64 and 128, design 1 at Dh
    32)."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = dict(bh=64, causal=True, dtype=f32, main=False, dh=64)
    cases = [dict(base, tq=2048, tk=2048, main=True),
             dict(base, tq=2048, tk=2048, dtype=bf16, main=True)]
    for dt in (f32, bf16):
        cases += [dict(base, dtype=dt, tq=1000, tk=1000),
                  dict(base, dtype=dt, tq=512, tk=768, causal=False),
                  dict(base, dtype=dt, tq=1024, tk=1024, dh=32),
                  dict(base, dtype=dt, tq=1024, tk=1024, dh=128)]
    return cases


def cross_flash_cases():
    """`path_x`'s cross-attention shape (BH 64, Tq 2048, Tk 1024, Dh 64,
    not causal) and Tk 1000, which ends in a partial key tile, in
    float32 (B3a-c on design 3) and bfloat16 (design 2). They draw
    their inputs from a generator of their own, so the cases before them
    keep the inputs they always had."""
    base = dict(bh=64, causal=False, main=False, dh=64, tq=2048)
    return [dict(base, dtype=dt, tk=tk, path_x=tk == 1024)
            for dt in (torch.float32, torch.bfloat16) for tk in (1024, 1000)]


def flash_flops(name, c):
    """The products a flash kernel computes over the visible (query,
    key) pairs (causal: the lower triangle), 2 Dh flops a pair each."""
    bh, tq, tk, dh = c["bh"], c["tq"], c["tk"], c["dh"]
    pairs = bh * tq * (tq + 1) // 2 if c["causal"] else bh * tq * tk
    return FLASH_PRODUCTS[name] * 2 * dh * pairs


def flash_rate(c, design):
    """The peak rate a flash kernel's products are bound by: the dtype's
    (FMA in float32, the tensor cores in bfloat16), or the 3xTF32 rate
    for design 3."""
    return PEAK_FLOPS_TF32X3 if design == "tf32x3" else \
        PEAK_FLOPS[c["dtype"]]


def flash_bound(name, c, design="ffma"):
    """(bound_ms, bound_by) of one flash kernel in `design`: its products
    (`flash_flops`) at the design's peak rate (`flash_rate`), or the
    bytes it must move (inputs read once, outputs written once, row
    statistics float32) over HBM bandwidth."""
    es = torch.tensor([], dtype=c["dtype"]).element_size()
    bh, tq, tk, dh = c["bh"], c["tq"], c["tk"], c["dh"]
    qe, ke = bh * tq * dh, bh * tk * dh
    nbytes = {"flash_attention_fwd": (2 * qe + 2 * ke) * es + 4 * bh * tq,
              "flash_attention_bwd_dkdv": (2 * qe + 4 * ke) * es
              + 8 * bh * tq,
              "flash_attention_bwd_dq": (3 * qe + 2 * ke) * es
              + 8 * bh * tq}[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_flops(name, c) / flash_rate(c, design) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_err(got, ref, dtype, atol):
    """(max abs error, within tolerance): float32 within `atol`; bfloat16
    within `atol` plus one bf16 step of the reference."""
    d = (got.float() - ref.float()).abs()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    return d.max().item(), bool((d <= atol + rtol * ref.float().abs())
                                .all())


# the gradients' absolute tolerance, a share of the largest |ref|, past
# `flash_err`'s one bf16 step of each element. float32: sums taken in
# another order, 1e-4. bfloat16, both designs: both sides round P and dS
# to bfloat16 operands (C6) from float32 values that differ in their last
# bits wherever their sums run in another order, so an operand may land a
# bf16 step apart and move a row by that step; 1e-3, the plain version's
# bound against the Pallas kernels. That limit alone does not catch the
# C6 fault everywhere (a kernel that kept P and dS in float32 reads 8e-4
# to 2.1e-3 against the rounded plain version), so every bfloat16 row also
# reads the excess (`excess_share`) against the plain version left
# unrounded (`unrounded_excess_share`) and must lie nearer the rounded one.
FLASH_GRAD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


def flash_want(dtype, dh, kernel):
    """The design `ops.attention.b3_design` must give `kernel` (any of
    B3a-c) on aligned tensors: bfloat16 at Dh 64/128 "wgmma"; float32
    there "tf32x3"; every other call "ffma"."""
    if dh not in (64, 128):
        return "ffma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def f64_share(grads, refs):
    """The largest error of `grads` against the float64 `refs`, a share of
    the largest |ref| of each (the guard of design 3)."""
    return max(((g.double() - r).abs().max() / r.abs().max()).item()
               for g, r in zip(grads, refs))


def cuda_kernel_names(fn, stream):
    """The names of the CUDA kernels one call of `fn` on `stream` runs
    (`torch.profiler`), each cut to 120 characters."""
    from torch.profiler import ProfilerActivity, profile

    with torch.cuda.stream(stream):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return sorted({e.key[:120] for e in prof.key_averages()
                   if e.device_type.name == "CUDA"})


def new_design(by_design, before, kernel):
    """The design under which `kernel` was launched since `before` (a
    copy of a module's LAUNCHES_BY_DESIGN)."""
    return next(d for (k, d), n in by_design.items()
                if k == kernel and n > before[(k, d)])


def grad_errs(grads, refs, dt, names=("dq", "dk", "dv")):
    """{name: (max abs error, within tolerance, atol, excess share)} of
    the gradients `names` against `refs`, at FLASH_GRAD_ATOL[dt] of the
    largest |ref| (`flash_err`); the excess share is the largest error
    past one bf16 step of its element (bfloat16) over the largest |ref|,
    the reading that limit bounds."""
    errs = {}
    rtol = 2.0 ** -7 if dt == torch.bfloat16 else 0.0
    for name, g_, r_ in zip(names, grads, refs):
        r_ = r_.float()
        big = r_.abs().max().item()
        err, ok = flash_err(g_, r_, dt, FLASH_GRAD_ATOL[dt] * big)
        past = ((g_.float() - r_).abs() - rtol * r_.abs()).max().item()
        errs[name] = (err, ok, FLASH_GRAD_ATOL[dt] * big,
                      max(past, 0.0) / big)
    return errs


def run_flash_case(c, flush, gen):
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention as fa

    dev, dt, causal = flush.device, c["dtype"], c["causal"]
    bh, tq, tk, dh = c["bh"], c["tq"], c["tk"], c["dh"]

    def rnd(t):
        return torch.randn(bh, t, dh, generator=gen).to(dev, dt)

    q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
    before = dict(fa.LAUNCHES_BY_DESIGN)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    fwd_design = new_design(fa.LAUNCHES_BY_DESIGN, before,
                            "flash_attention_fwd")
    # bfloat16: p rounded against the running max of the kernel's tile
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal,
                                              block_k=fa.KERNEL_BLOCK_K)
    # the backward kernels and the plain backward from the same residuals
    before = dict(fa.LAUNCHES_BY_DESIGN)
    grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal)
    design = new_design(fa.LAUNCHES_BY_DESIGN, before,
                        "flash_attention_bwd_dq")
    g_ref = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    shape = {kk: c[kk] for kk in ("bh", "tq", "tk", "dh", "causal")}

    def fwd_errs(o_, lse_, d):
        e_o, ok_o = flash_err(o_, o_ref, dt, fa.fwd_atol(o_ref, d))
        e_l, ok_l = flash_err(lse_, lse_ref, torch.float32, 2e-5)
        check(ok_o and ok_l, f"flash_attention_fwd {shape} {dt} ({d}): o "
              f"err {e_o} (tolerance {fa.fwd_atol(o_ref, d)} plus one bf16 "
              f"step), lse err {e_l} (tolerance 2e-5)")
        # the outputs past design 1's limit
        past = (o_.float() - o_ref.float()).abs() \
            - (fa.fwd_atol(o_ref, "ffma")
               + (2.0 ** -7 if dt == torch.bfloat16 else 0.0)
               * o_ref.float().abs())
        return max(e_o, e_l), int((past > 0).sum())

    e_fwd, past_fwd = fwd_errs(o, lse, fwd_design)
    errs = grad_errs(grads, g_ref, dt)
    for name, (err, ok, atol, _) in errs.items():
        check(ok, f"flash backward {shape} {dt} ({design}): {name} err "
              f"{err}, tolerance {atol} ({FLASH_GRAD_ATOL[dt]} of the "
              f"largest |ref|)")
    want = (flash_want(dt, dh, "flash_attention_fwd"),
            flash_want(dt, dh, "flash_attention_bwd_dq"))
    check((fwd_design, design) == want,
          f"flash {shape} {dt} ran designs {fwd_design} (forward) and "
          f"{design} (backward), want {want}")
    g64 = None
    if design == "tf32x3":
        # the guard's reference: the plain backward in float64 on the
        # same float32 inputs
        g64 = fa.flash_attention_bwd_plain(
            *(x.double() for x in (q, k, v, o_ref, lse_ref, do)), causal)

    delta = (do.float() * o_ref.float()).sum(dim=-1)
    runs = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, causal, with_lse=True),
        "flash_attention_bwd_dkdv": lambda: fa.launch_bwd_dkdv(
            q, k, v, do, lse_ref, delta, causal, design=design),
        "flash_attention_bwd_dq": lambda: fa.launch_bwd_dq(
            q, k, v, do, lse_ref, delta, causal, design=design)}
    errs_of = {"flash_attention_fwd": e_fwd,
               "flash_attention_bwd_dkdv": max(errs["dk"][0], errs["dv"][0]),
               "flash_attention_bwd_dq": errs["dq"][0]}
    share = {"flash_attention_bwd_dkdv": max(errs["dk"][3], errs["dv"][3]),
             "flash_attention_bwd_dq": errs["dq"][3]}
    unrounded = {}
    if dt == torch.bfloat16:
        # the control: the same outputs against the plain versions left
        # unrounded (float32 throughout), the fault C6 repaired
        g_f32 = fa.flash_attention_bwd_plain(
            *(x.float() for x in (q, k, v, o_ref)), lse_ref, do.float(),
            causal)
        ctrl = grad_errs(grads, g_f32, dt)
        del g_f32
        o_f32, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            causal)
        share["flash_attention_fwd"] = grad_errs((o,), (o_ref,), dt,
                                                 ("o",))["o"][3]
        unrounded = {"flash_attention_fwd": grad_errs(
                         (o,), (o_f32,), dt, ("o",))["o"][3],
                     "flash_attention_bwd_dkdv": max(ctrl["dk"][3],
                                                     ctrl["dv"][3]),
                     "flash_attention_bwd_dq": ctrl["dq"][3]}
        del o_f32
        for name, x in unrounded.items():
            d = fwd_design if name == "flash_attention_fwd" else design
            check(share[name] < x, f"{name} {shape} {dt} ({d}) lies "
                  f"{share[name]} of the largest |ref| past one bf16 step "
                  f"from the plain version that rounds P and dS, and {x} "
                  f"from the one that does not (C6)")
    timed_plain = c["main"] or dt == torch.bfloat16 or c.get("path_x")
    plain = lib = host = {}
    if timed_plain:
        plain_fwd = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                             causal), flush,
                            iters=10)
        plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o_ref, lse_ref, do, causal), flush, iters=10)
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_bwd_dkdv": plain_bwd,
                 "flash_attention_bwd_dq": plain_bwd}
        b = bh // 8
        q4, k4, v4, do4 = (t.reshape(b, 8, t.shape[1], dh).detach()
                           for t in (q, k, v, do))
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), flush)
        # the kernels SDPA's forward ran (float32: PyTorch's
        # memory-efficient kernel)
        lib_fwd_names = cuda_kernel_names(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=causal),
            torch.cuda.current_stream())
        qg, kg, vg = (t.clone().requires_grad_() for t in (q4, k4, v4))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            og = F.scaled_dot_product_attention(qg, kg, vg,
                                                is_causal=causal)
        torch.cuda.current_stream().wait_stream(side)
        # SDPA's backward launches several kernels through autograd: its
        # device time is taken from a CUDA graph of the call (its host
        # launches can outlast the flush and leave the card waiting)
        lib_bwd = graph_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), do4, retain_graph=True), flush, side)
        host_bwd = time_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), do4, retain_graph=True), flush)
        # the kernels SDPA's backward ran (float32: PyTorch's
        # memory-efficient kernel on CUTLASS's 3xTF32 products)
        lib_names = cuda_kernel_names(lambda: torch.autograd.grad(
            og, (qg, kg, vg), do4, retain_graph=True), side)
        lib = {"flash_attention_fwd": lib_fwd,
               "flash_attention_bwd_dkdv": lib_bwd,
               "flash_attention_bwd_dq": lib_bwd}
        # the same backward timed from the host, as the other yardsticks
        host = {"flash_attention_bwd_dkdv": host_bwd,
                "flash_attention_bwd_dq": host_bwd}
    rows = []
    for name, fn in runs.items():
        d_row = fwd_design if name == "flash_attention_fwd" else design
        bms, by = flash_bound(name, c, d_row)
        ms = time_ms(fn, flush)
        row = {"phase": "kernels", "kernel": name,
               "dtype": str(dt).replace("torch.", ""), **shape,
               "design": d_row,
               "max_abs_err": errs_of[name],
               "excess_share": share.get(name),
               "grad_limit_share": None if name == "flash_attention_fwd"
               else FLASH_GRAD_ATOL[dt],
               "o_limit_share": fa.FWD_WGMMA_SHARE
               if name == "flash_attention_fwd" and fwd_design == "wgmma"
               else None,
               "unrounded_excess_share": unrounded.get(name), "ms": ms,
               "tflops": flash_flops(name, c) / ms / 1e9,
               "plain_ms": plain.get(name), "library_ms": lib.get(name),
               "library_ms_with_host_launches": host.get(name),
               "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
               "bound_rate_tflops": flash_rate(c, d_row) / 1e12,
               "main_path_shape": c["main"],
               "path_x_shape": c.get("path_x", False)}
        if timed_plain:
            row["library_kernels"] = lib_fwd_names \
                if name == "flash_attention_fwd" else lib_names
        if name != "flash_attention_fwd" and (
                design == "tf32x3" or design == "wgmma" and c["main"]):
            # design 1 on the same inputs, to compare the two in one run
            launch = fa.launch_bwd_dkdv if name.endswith("dkdv") \
                else fa.launch_bwd_dq
            run1 = lambda: launch(  # noqa: E731
                q, k, v, do, lse_ref, delta, causal, design="ffma")
            # and held to the same limit
            if name.endswith("dq"):
                e1 = grad_errs((run1(),), g_ref[:1], dt, ("dq",))
            else:
                e1 = grad_errs(run1(), g_ref[1:], dt, ("dk", "dv"))
            for gname, (err, ok, atol, _) in e1.items():
                check(ok, f"flash backward {shape} {dt} (ffma): {gname} "
                      f"err {err}, tolerance {atol}")
            row["ffma_excess_share"] = max(e[3] for e in e1.values())
            row["ffma_ms"] = time_ms(run1, flush)
            row["speedup_over_ffma"] = row["ffma_ms"] / ms
            if design == "tf32x3":
                # design 1's own bound, and the guard: both designs
                # against the float64 plain backward on the same inputs
                fb, _ = flash_bound(name, c, "ffma")
                sl = slice(0, 1) if name.endswith("dq") else slice(1, 3)
                got1 = run1()
                f3 = f64_share(grads[sl], g64[sl])
                f1 = f64_share(got1 if isinstance(got1, tuple)
                               else (got1,), g64[sl])
                row.update(ffma_bound_ms=fb,
                           ffma_bound_share=fb / row["ffma_ms"],
                           f64_share=f3, ffma_f64_share=f1,
                           guard_ratio=f3 / f1, guard_limit=2.0)
                check(f3 <= 2 * f1, f"{name} {shape} float32 (tf32x3): "
                      f"{f3} of the largest |ref| from the float64 "
                      f"backward, design 1 {f1}: past twice design 1's")
        if name == "flash_attention_fwd":
            row["past_2e-5_limit"] = past_fwd
            if fwd_design == "tf32x3" or fwd_design == "wgmma" and c["main"]:
                # design 1 on the same inputs, held to its own limit
                def run1():
                    return fa.launch_fwd(q, k, v, causal, design="ffma")

                o1, lse1 = run1()
                row["ffma_max_abs_err"] = fwd_errs(o1, lse1, "ffma")[0]
                row["ffma_ms"] = time_ms(run1, flush)
                row["speedup_over_ffma"] = row["ffma_ms"] / ms
                if fwd_design == "tf32x3":
                    row.update(fwd_guard(name, c, q, k, v, o, lse, o1, lse1,
                                         row["ffma_ms"]))
                del o1, lse1
        emit(row)
        rows.append(row)
    del g64
    return rows


def fwd_guard(name, c, q, k, v, o, lse, o1, lse1, ffma_ms):
    """Design 3's forward beside design 1's on the same inputs (o1, lse1,
    timed at `ffma_ms`): design 1's own bound and the guard, both designs'
    largest error against the plain forward in float64, on o and on lse
    (the backward rebuilds p from lse), each a share of the largest
    |ref|; design 3 within twice design 1's on both."""
    from deeplearning4j_tpu_torch.ops import attention as fa

    fb, _ = flash_bound(name, c, "ffma")
    o64, lse64 = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                          c["causal"])
    f3 = {"o": f64_share((o,), (o64,)), "lse": f64_share((lse,), (lse64,))}
    f1 = {"o": f64_share((o1,), (o64,)),
          "lse": f64_share((lse1,), (lse64,))}
    del o64, lse64
    ratio = {x: f3[x] / f1[x] for x in f3}
    shape = {kk: c[kk] for kk in ("bh", "tq", "tk", "dh", "causal")}
    check(all(f3[x] <= 2 * f1[x] for x in f3),
          f"{name} {shape} float32 (tf32x3): {f3} of the largest |ref| "
          f"from the float64 forward, design 1 {f1}: past twice design 1's")
    return dict(ffma_bound_ms=fb, ffma_bound_share=fb / ffma_ms,
                f64_share=f3, ffma_f64_share=f1, guard_ratio=ratio,
                guard_limit=2.0)


def run_flash_repeat(gen):
    """Every kernel launched twice at `path_t_bf16`'s and `path_t`'s shape
    and at Dh 128, in bfloat16 (all on design 2) and float32 (all on
    design 3): o and lse bit-equal (B3a), dq, dk and dv bit-equal (B3b,
    B3c: two kernels, no atomics)."""
    from deeplearning4j_tpu_torch.ops import attention as fa

    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for bh, t, dh in ((64, 2048, 64), (16, 2048, 128)):
            q, k, v, do = (torch.randn(bh, t, dh, generator=gen)
                           .to("cuda", dt) for _ in range(4))
            before = dict(fa.LAUNCHES_BY_DESIGN)
            o, lse = fa.flash_attention_fwd(q, k, v, True)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, True)
            a = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
            b = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
            torch.cuda.synchronize()
            designs = {kk: flash_want(dt, dh, kk) for kk in FLASH_KERNELS}
            check(all(fa.LAUNCHES_BY_DESIGN[(kk, d)] == before[(kk, d)] + 2
                      for kk, d in designs.items()),
                  f"flash repeat {dt} BH {bh} T {t} Dh {dh}: {designs} did "
                  f"not take both launches of every kernel")
            equal = [torch.equal(x, y) for x, y in zip((o, lse, *a),
                                                       (o2, lse2, *b))]
            check(all(equal), f"flash repeat {dt} BH {bh} T {t} Dh {dh}: "
                  f"two launches differ (o, lse, dq, dk, dv equal: "
                  f"{equal})")
            rows.append({"phase": "flash_repeat", "bh": bh, "t": t,
                         "dh": dh, "causal": True,
                         "dtype": str(dt).replace("torch.", ""),
                         "design": designs,
                         "bit_equal": dict(zip(("o", "lse", "dq", "dk",
                                                "dv"), equal))})
            emit(rows[-1])
            del q, k, v, do, o, o2, lse, lse2, a, b
    return rows


# ------------------------------------------------ kernels: banded (B4)
def banded_cases():
    """`path_w`'s shape (B 8, H 8, Hkv 2, T 2048, Dh 64, window 256,
    causal, float32), and the variants the kernel must hold: MHA (Hkv
    8), bidirectional, a window past T, a ragged T with another window,
    bfloat16."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = dict(b=8, h=8, hkv=2, t=2048, dh=64, w=256, causal=True,
                dtype=f32, main=False)
    return [dict(base, main=True), dict(base, hkv=8),
            dict(base, causal=False), dict(base, w=4096),
            dict(base, t=1000, w=100), dict(base, dtype=bf16)]


def banded_bound(c):
    """(bound_ms, bound_by) of B4: its two products over the visible
    (query, key) pairs at the peak rate of its dtype, or the bytes it
    must move (q, k, v read once, o written once) over HBM bandwidth."""
    from deeplearning4j_tpu_torch.ops.banded_attention import band_pairs

    es = torch.tensor([], dtype=c["dtype"]).element_size()
    pairs = c["b"] * c["h"] * band_pairs(c["t"], c["w"], c["causal"])
    flops = 2 * 2 * c["dh"] * pairs
    nbytes = 2 * c["b"] * c["t"] * (c["h"] + c["hkv"]) * c["dh"] * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[c["dtype"]] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), pairs


def run_banded_case(c, flush, gen):
    """B4 against its plain version (the dense band-masked softmax);
    yardstick: SDPA with the band as a boolean mask, GQA enabled."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    dev, dt = flush.device, c["dtype"]
    b, t, h, hkv, dh, w, causal = (c[k] for k in ("b", "t", "h", "hkv",
                                                  "dh", "w", "causal"))

    def rnd(heads):
        return torch.randn(b, t, heads, dh, generator=gen).to(dev, dt)

    q, k, v = rnd(h), rnd(hkv), rnd(hkv)
    run = lambda: ba.banded_attention_fwd(q, k, v, w, causal)  # noqa: E731
    # bfloat16: p rounded against the running max of the kernel's tile
    plain = lambda: ba.banded_reference(  # noqa: E731
        q, k, v, w, causal, block_k=ba.BAND_TILE)
    before = dict(ba.LAUNCHES_BY_DESIGN)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    design = new_design(ba.LAUNCHES_BY_DESIGN, before, "banded_attention")
    atol, rtol = TOL[dt]
    shape = {kk: c[kk] for kk in ("b", "t", "h", "hkv", "dh", "w", "causal")}

    def held(o, what):
        diff = (o.float() - ref.float()).abs()
        err = diff.max().item()
        check(bool((diff <= atol + rtol * ref.float().abs()).all()),
              f"banded_attention ({what}) {shape} {dt}: max abs err {err}, "
              f"tolerance atol {atol} + rtol {rtol} * |ref|")
        return err

    err = held(out, design)
    extra = {}
    if design == "folded":
        # design 1 on the same inputs, held to the same limit; design 2
        # launched again gives the same bits
        run1 = lambda: ba.banded_attention_fwd(  # noqa: E731
            q, k, v, w, causal, design="ffma")
        extra["ffma_max_abs_err"] = held(run1(), "ffma")
        again = run()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"banded_attention (folded) {shape}: "
              f"two launches differ")
        extra["bit_equal"] = True
        del again
        extra["ffma_ms"] = time_ms(run1, flush)
    del out, ref
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    mask = ba.band_visibility(t, w, causal, dev)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, enable_gqa=hkv != h)
    (bms, by), pairs = banded_bound(c)
    timed_plain = c["main"] or dt == torch.bfloat16 or c.get("path_x")
    ms = time_ms(run, flush)
    row = {"phase": "kernels", "kernel": "banded_attention",
           "dtype": str(dt).replace("torch.", ""), **shape,
           "visible_pairs": pairs, "max_abs_err": err, "atol": atol,
           "rtol": rtol, "ms": ms,
           "plain_ms": time_ms(plain, flush, iters=5) if timed_plain
           else None,
           "library_ms": time_ms(lib, flush, iters=10),
           "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
           "design": design, **extra, "main_path_shape": c["main"]}
    if "ffma_ms" in row:
        row["speedup_over_ffma"] = row["ffma_ms"] / ms
    emit(row)
    return row


# ------------------------------------------ kernels: Adam, Nesterovs (B1)
PATH_I_LEAVES = ("inception_resnet_v1", "vgg_head", "googlenet", "alexnet")
B1_DESIGNS = ("multi", "persistent")
# the leaf sets whose updater call is timed: each one path's update
B1_UPDATER_SETS = ("real", "lenet", "vae", "head", "rbm") + PATH_I_LEAVES


def shape_tree(tree):
    """A params tree's structure with each leaf's shape in its place."""
    return {k: shape_tree(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def tree_shapes(stree):
    """A shape tree's shapes in `tree_leaves` order."""
    return [s for v in stree.values()
            for s in (tree_shapes(v) if isinstance(v, dict) else [v])]


def fill_tree(stree, it):
    """The shape tree's structure with the next tensor of `it` at each
    leaf, in `tree_leaves` order."""
    return {k: fill_tree(v, it) if isinstance(v, dict) else next(it)
            for k, v in stree.items()}


def flat_tree(shapes):
    """A two-level tree of `shapes`, one leaf a layer."""
    return {f"l{i}": {"W": s} for i, s in enumerate(shapes)}


def path_i_leaves():
    """The shape trees of `path_i`'s two B1a updates: InceptionResNetV1
    at 160x160x3 and 1000 classes, and the unfrozen layers of the Keras
    VGG transfer (`vgg_transfer`)."""
    from deeplearning4j_tpu_torch import zoo

    net = zoo.InceptionResNetV1(num_classes=1000,
                                input_shape=(160, 160, 3)).init(device="cuda")
    irv1 = shape_tree(net.params_tree)
    del net
    net = vgg_transfer(*keras_vgg(np.random.default_rng(22)))
    head = {layer.name: shape_tree(net.params_tree[layer.name])
            for layer in net.layers if not layer.frozen}
    del net
    torch.cuda.empty_cache()
    return irv1, head


def path_i_nesterov_leaves():
    """The shape trees of `path_i`'s two B1b updates: GoogLeNet and
    AlexNet at 224x224x3 and 1000 classes."""
    from deeplearning4j_tpu_torch import zoo

    out = []
    for model in (zoo.GoogLeNet, zoo.AlexNet):
        net = model(num_classes=1000, input_shape=(224, 224, 3)).init(
            device="cuda")
        out.append(shape_tree(net.params_tree))
        del net
    torch.cuda.empty_cache()
    return out


def b1_leaves(kind, shapes, dt, seed, misaligned=False):
    """One B1 case's leaves, (p, g, m, v) or (p, g, v) a leaf, drawn on
    the card from a generator seeded with `seed` (so every call gives the
    same values). `misaligned`: each tensor a view one element into a
    buffer of its own, so no address is 16-byte aligned."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(s, scale=1.0, uniform=False):
        n = int(np.prod(s))
        size = (n + 1,) if misaligned else s
        x = (torch.rand(size, generator=g, device=dev) if uniform
             else scale * torch.randn(size, generator=g, device=dev))
        x = x.to(dt)
        return x[1:] if misaligned else x

    return [(draw(s), draw(s), draw(s, 0.1), draw(s, uniform=True))
            if kind == "adam" else (draw(s), draw(s), draw(s, 0.1))
            for s in shapes]


def b1_errs(kind, leaves, ref, dt):
    """(max abs error, within tolerance) of updated `leaves` against the
    plain version's `ref`: 2^-22 of |ref| in float32 (two ulps; the
    kernels round every operation as the plain version does), one bf16
    step (2^-7) in bfloat16."""
    rtol = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
    err, ok = 0.0, True
    for leaf, r in zip(leaves, ref):
        outs = (leaf[0], leaf[2], leaf[3]) if kind == "adam" \
            else (leaf[0], leaf[2])
        for got, want in zip(outs, r):
            d = (got.float() - want.float()).abs()
            err = max(err, d.max().item() if d.numel() else 0.0)
            ok = ok and bool((d <= rtol * want.float().abs()).all())
    return err, ok, rtol


def b1_case(kind, leafset, stree, dt, seed, scalar, hyper, flush, *,
            lr=None, step=None, misaligned=False):
    """One B1 case: both designs (`B1_DESIGNS`) held to the plain version
    on the same inputs; each design timed on one plan (`UpdatePlan`:
    multi, persistent, persistent, multi, after a 256 MB L2 flush each,
    `queued_ms`: the kernel, not the host's checks);
    for the leaf sets of `B1_UPDATER_SETS`, the updater's own call over
    the leaf set's tree (`update_with_params`, as the train step calls
    it: the host clock over 50 calls without a sync, `host_ms`, and the
    events with the flush, `updater_ms`), its result held to the plain
    version too; the plain version's time and `torch.optim`'s fused step
    (`library_ms`) beside them."""
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    shapes = tree_shapes(stree)
    adam = kind == "adam"
    plain = fu.adam_update_plain if adam else fu.nesterov_update_plain
    update = fu.adam_update if adam else fu.nesterov_update
    kernel = "adam_update" if adam else "nesterov_update"
    ref = [plain(*leaf, scalar, **hyper)
           for leaf in b1_leaves(kind, shapes, dt, seed, misaligned)]
    row = {"phase": "kernels", "kernel": kernel,
           "dtype": str(dt).replace("torch.", ""), "leaves": leafset,
           "n_leaves": len(shapes), "misaligned": misaligned, **hyper}
    err = 0.0
    for d in B1_DESIGNS:
        leaves = b1_leaves(kind, shapes, dt, seed, misaligned)
        update(*zip(*leaves), scalar, design=d, **hyper)
        torch.cuda.synchronize()
        e, ok, rtol = b1_errs(kind, leaves, ref, dt)
        check(ok, f"{kernel} {leafset} {dt} {d}: max abs err {e} past "
              f"{rtol} of |ref|")
        row[f"{d}_max_abs_err"], err = e, max(err, e)
    del ref
    leaves = b1_leaves(kind, shapes, dt, seed, misaligned)
    n = sum(leaf[0].numel() for leaf in leaves)
    esize = leaves[0][0].element_size()
    row.update(max_abs_err=err, rtol=rtol, elements=n,
               bound_ms=(7 if adam else 5) * n * esize
               / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    cols = list(zip(*leaves))
    plan = fu.UpdatePlan(kind, cols[0], cols[2] if adam else None, cols[-1])
    grads = list(cols[1])
    design = fu.DEFAULT_DESIGN
    times = {d: [] for d in B1_DESIGNS}
    for d in B1_DESIGNS + B1_DESIGNS[::-1]:
        times[d].append(queued_ms(lambda: plan.launch(
            grads, scalar, design=d, **hyper), flush))
    for d in B1_DESIGNS:
        row[f"{d}_ms"] = float(np.mean(times[d]))
        row[f"{d}_ms_runs"] = times[d]
    row.update(design=design, ms=row[f"{design}_ms"],
               speedup_over_multi=row["multi_ms"] / row[f"{design}_ms"],
               bound_share=row["bound_ms"] / row[f"{design}_ms"],
               blocks=len(plan.blocks), chunks=plan.n_chunks)
    if leafset in B1_UPDATER_SETS:
        row.update(b1_updater_call(kind, stree, leaves, scalar, hyper, lr,
                                   step, dt, flush))
        row["plain_ms"] = time_ms(lambda: [plain(*leaf, scalar, **hyper)
                                           for leaf in leaves], flush,
                                  iters=10)
        ps = [torch.nn.Parameter(p) for p, *_ in leaves]
        for prm, leaf in zip(ps, leaves):
            prm.grad = leaf[1]
        opt = (torch.optim.Adam(ps, lr=lr, betas=(hyper["beta1"],
                                                  hyper["beta2"]),
                                eps=hyper["eps"], fused=True) if adam
               else torch.optim.SGD(ps, lr=lr, momentum=hyper["momentum"],
                                    nesterov=True, fused=True))
        row["library_ms"] = time_ms(opt.step, flush)
        del opt, ps
    emit(row)
    del leaves, cols, grads, plan
    return row


def b1_updater_call(kind, stree, leaves, scalar, hyper, lr, step, dt,
                    flush):
    """The updater's own call over `leaves` laid out as `stree`: Adam
    (its lrbc from the step counter on the card) or Nesterovs, a
    constant rate `lr`, each call with a gradient tree of its own, as a
    training step's backward makes them (distinct sets at their own
    addresses, cycled where memory allows fewer than the calls). Its
    first call is held to the plain version; then `host_ms` (the host
    clock over 50 calls, no sync: what the train step waits for) and its
    parts on the same calls: finding the plans (a walk of the params and
    state trees, each tensor's identity), reading the gradient tree's
    leaves, checking them (count, numel, dtype, device, contiguity) and
    the launch that follows; `updater_ms` (`time_ms`'s events, the
    device's time for the call with the host's in it where the host is
    the slower), with the B1 launches and `adam_lrbc` launches of one
    call."""
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs

    adam = kind == "adam"
    dev = leaves[0][0].device
    cols = list(zip(*leaves))
    p_tree, g_tree, v_tree = (fill_tree(stree, iter(c))
                              for c in (cols[0], cols[1], cols[-1]))
    if adam:
        u = Adam(lr, beta1=hyper["beta1"], beta2=hyper["beta2"],
                 epsilon=hyper["eps"])
        state = {"m": fill_tree(stree, iter(cols[2])), "v": v_tree}
        rate = fu.adam_lrbc_plain(torch.tensor(step, device=dev), lr,
                                  hyper["beta1"], hyper["beta2"])
    else:
        u = Nesterovs(lr, momentum=hyper["momentum"])
        state = {"v": v_tree}
        rate = torch.tensor(lr, dtype=torch.float32, device=dev)
    step_t = torch.tensor(step or 0, dtype=torch.int64, device=dev)
    plain = fu.adam_update_plain if adam else fu.nesterov_update_plain
    ref = [plain(*leaf, rate, **hyper) for leaf in leaves]
    fu.reset_counts()
    u.update_with_params(g_tree, state, p_tree, step_t)
    torch.cuda.synchronize()
    launches = dict(fu.LAUNCHES)
    e, ok, rtol = b1_errs(kind, leaves, ref, dt)
    check(ok, f"{kind} updater call over {len(leaves)} leaves: max abs "
          f"err {e} past {rtol} of |ref|")
    del ref
    calls = 50
    set_bytes = sum(g.numel() * g.element_size() for g in cols[1])
    n_sets = max(2, min(calls, int(4e9 // max(set_bytes, 1))))
    g_sets = [fill_tree(stree, iter([g.clone() for g in cols[1]]))
              for _ in range(n_sets)]
    nxt = iter(range(1 << 30))

    def g_next():
        return g_sets[next(nxt) % n_sets]

    def host(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ms = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda.synchronize()
        return ms

    plans = fu.leaf_plans(kind, p_tree, state.get("m"), v_tree)
    plan = plans.groups[0][1]
    g_lists = [plans.grads(t) for t in g_sets]
    k = iter(range(1 << 30))
    row = {"host_ms": host(lambda: u.update_with_params(
               g_next(), state, p_tree, step_t)),
           "grad_sets": n_sets,
           "host_ms_plan_lookup": host(lambda: fu.leaf_plans(
               kind, p_tree, state.get("m"), v_tree)),
           "host_ms_grad_leaves": host(lambda: plans.grads(g_next())),
           "host_ms_grad_check": host(lambda: plan._check_grads(
               g_lists[next(k) % n_sets]))
           if len(plans.groups) == 1 else None,
           "updater_ms": time_ms(lambda: u.update_with_params(
               g_next(), state, p_tree, step_t), flush),
           "updater_max_abs_err": e,
           "updater_launches": {k: v for k, v in launches.items() if v}}
    del g_sets, g_lists
    return row


def run_adam_phase(flush, gen):
    """B1a, both designs, against its plain version over the training
    path's real leaves (default hyperparameters), odd sizes and the same
    odd sizes as misaligned views (non-default ones), float32 and
    bfloat16, at steps 1 and 1000; then, each with its own time, bound,
    updater call and `Adam(fused=True)` time, over LeNet's 8 bfloat16
    leaves (`path_m`'s update: 431,080 parameters, Adam(1e-3), step 12)
    and over `path_p`'s two float32 updates at step 12: the VAE's 14
    leaves (535,828 elements, Adam(1e-3)) and the fine-tune's
    center-loss head, 30 x 10 and 10 (Adam(1e-2)); and over `path_i`'s
    two float32 updates: InceptionResNetV1's 272 leaves (Adam(1e-3),
    step 4) and the Keras VGG transfer's unfrozen head (a 25088 x 4096
    leaf among them; Adam(1e-5), step 6). Each case's inputs are drawn
    on the card from a seed of its own (`b1_leaves`)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    real = shape_tree(build_net("cuda", num_blocks=6, seed=3).params_tree)
    lenet = shape_tree(MultiLayerNetwork(lenet_conf(), device="cuda")
                       .init().params_tree)
    vae = shape_tree(MultiLayerNetwork(vae_conf(), device="cuda")
                     .init().params_tree)
    ft = finetune_net("cuda", [])
    head = {"head": shape_tree(ft.params_tree[ft.conf.layers[-1].name])}
    del ft
    irv1, vgg_head = path_i_leaves()
    odd = flat_tree([(1,), (127,), (4097,), ((1 << 20) + 3,)])
    rows = []
    cases = [(dt, step, leafset, hyper, 3e-4, False)
             for dt in (torch.float32, torch.bfloat16) for step in (1, 1000)
             for leafset, hyper in (("real", (0.9, 0.999, 1e-8)),
                                    ("odd", (0.8, 0.99, 1e-6)))]
    cases += [(dt, 1, "misaligned", (0.8, 0.99, 1e-6), 3e-4, True)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(torch.bfloat16, 12, "lenet", (0.9, 0.999, 1e-8), 1e-3, False),
              (torch.float32, 12, "vae", (0.9, 0.999, 1e-8), 1e-3, False),
              (torch.float32, 12, "head", (0.9, 0.999, 1e-8), 1e-2, False),
              (torch.float32, 4, "inception_resnet_v1", (0.9, 0.999, 1e-8),
               1e-3, False),
              (torch.float32, 6, "vgg_head", (0.9, 0.999, 1e-8), 1e-5,
               False)]
    for i, (dt, step, leafset, hyper, lr, misaligned) in enumerate(cases):
        stree = {"real": real, "odd": odd, "misaligned": odd,
                 "lenet": lenet, "vae": vae, "head": head,
                 "inception_resnet_v1": irv1, "vgg_head": vgg_head}[leafset]
        b1, b2, eps = hyper
        t = step + 1
        lrbc = torch.tensor(lr * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t),
                            device="cuda")
        row = b1_case("adam", leafset, stree, dt, 100 + i, lrbc,
                      dict(beta1=b1, beta2=b2, eps=eps), flush, lr=lr,
                      step=step, misaligned=misaligned)
        row.update(step=step, lr=lr, main_path_shape=leafset == "real"
                   and dt == torch.float32 and step == 1000)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def run_lrbc_phase(flush):
    """`adam_lrbc` (Adam's bias-corrected rate from the step counter)
    against its plain version, bit for bit, over steps from 0 to 2^20
    under the paths' betas, a constant rate and a schedule's (a device
    scalar); timed at `path_t`'s Adam(3e-4), step 1000. Bound: the 8
    bytes of the step and the 4 of the rate read, 4 written."""
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    err = 0.0
    for b1, b2 in ((0.9, 0.999), (0.8, 0.99), (0.85, 0.995)):
        for step in (0, 1, 2, 3, 4, 6, 11, 12, 999, 1000, 12345,
                     (1 << 20) - 1):
            s = torch.tensor(step, dtype=torch.int64, device=dev)
            for lr in (3e-4, 1e-2, torch.tensor(0.037, device=dev)):
                got = fu.adam_lrbc(s, lr, b1, b2)
                want = fu.adam_lrbc_plain(s, lr, b1, b2)
                d = (got - want).abs().item()
                err = max(err, d)
                check(d <= 2.0 ** -22 * abs(want.item()),
                      f"adam_lrbc step {step} betas {b1} {b2} lr {lr}: "
                      f"{got.item()} against {want.item()}")
    s = torch.tensor(1000, dtype=torch.int64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    row = {"phase": "kernels", "kernel": "adam_lrbc", "dtype": "float32",
           "max_abs_err": err, "rtol": 2.0 ** -22, "lr": 3e-4, "step": 1000,
           "ms": time_ms(lambda: fu.adam_lrbc(s, 3e-4, 0.9, 0.999,
                                              out=out), flush),
           "plain_ms": time_ms(lambda: fu.adam_lrbc_plain(s, 3e-4, 0.9,
                                                          0.999), flush),
           "bound_ms": 16 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None, "main_path_shape": True}
    emit(row)
    return [row]


# --------------------------------------------- kernels: Nesterovs (B1b)
def run_nesterov_phase(flush, gen):
    """B1b, both designs, against its plain version over the LSTM
    training path's real leaves (its Nesterovs(0.01, 0.9)), odd sizes
    and the same as misaligned views (another momentum), float32 and
    bfloat16, over `path_p`'s first RBM's leaves (784 x 1000, float32:
    its largest pretrain step) and over `path_i`'s GoogLeNet (173
    leaves) and AlexNet (every leaf, float32, their Nesterovs(1e-2,
    0.9)), with `b1_case`'s timings. Bound: read p, g, v and write p, v
    once (5 tensors of n elements) over HBM bandwidth."""
    net = build_lstm_net("cuda", seed=3)
    real = shape_tree(net.params_tree)
    del net
    odd = flat_tree([(1,), (127,), (4097,), ((1 << 20) + 3,)])
    rows = []
    # path_p's largest pretrain step: the first RBM's W, hb, vb
    rbm = {"rbm": {"W": (DEEP_AE[0], DEEP_AE[1]), "hb": (DEEP_AE[1],),
                   "vb": (DEEP_AE[0],)}}
    googlenet, alexnet = path_i_nesterov_leaves()
    i = 0
    for dt in (torch.float32, torch.bfloat16):
        for leafset, mu in (("real", 0.9), ("odd", 0.8), ("misaligned", 0.8),
                            ("rbm", 0.9), ("googlenet", 0.9),
                            ("alexnet", 0.9)):
            if leafset not in ("real", "odd", "misaligned") and \
                    dt != torch.float32:
                continue
            stree = {"real": real, "odd": odd, "misaligned": odd, "rbm": rbm,
                     "googlenet": googlenet, "alexnet": alexnet}[leafset]
            lr = torch.tensor(0.01, device="cuda")
            row = b1_case("nesterov", leafset, stree, dt, 200 + i, lr,
                          dict(momentum=mu), flush, lr=0.01,
                          misaligned=leafset == "misaligned")
            row["main_path_shape"] = leafset == "real" and \
                dt == torch.float32
            rows.append(row)
            i += 1
            torch.cuda.empty_cache()
    return rows


# ----------------------------------------------- kernels: LSTM (B2a-c)
def lstm_cases():
    """(T, B, H, input width, which kernels the recurrent paths run at
    this shape): `path_l` trains at T 128; `path_g` trains in chunks of
    T 50, runs `output()` at T 200 and steps at T 1; T 8 and 4 straddle
    `b2_design`'s shortest sequence for design 2."""
    return [dict(T=128, B=64, H=512, F=128, main=("lstm_fwd", "lstm_bwd",
                                                  "lstm_bwd_weights")),
            dict(T=200, B=32, H=256, F=77, main=("lstm_fwd_inference",)),
            dict(T=50, B=32, H=256, F=77, main=()),
            dict(T=8, B=32, H=256, F=77, main=()),
            dict(T=4, B=32, H=256, F=77, main=()),
            dict(T=1, B=32, H=256, F=77, main=())]


def lstm_bounds(T, B, H, dtype=torch.float32):
    """{kernel: (bound_ms, bound_by)}: each kernel's product, 2·T·B·H·4H
    flops at the peak of `dtype`, against the bytes it must move (inputs
    read once, outputs written once, each element of `dtype`) over HBM
    bandwidth."""
    ops_ms = 2.0 * T * B * H * 4 * H / PEAK_FLOPS[dtype] * 1e3
    esize = torch.tensor([], dtype=dtype).element_size()
    seq, small = T * B * H, H * 4 * H + 3 * H + 2 * B * H
    nbytes = {
        # xw, rw, p, h0, c0, mask in; hs, hT, cT (+ cs, gates) out
        "lstm_fwd_inference": 4 * seq + small + T * B + seq + 2 * B * H,
        "lstm_fwd": 4 * seq + small + T * B + 6 * seq + 2 * B * H,
        # dhs, gates, cs, rw, p, mask, dhT, dcT, c0 in; dxw, dh0, dc0 out
        "lstm_bwd": 6 * seq + small + B * H + T * B + 4 * seq + 2 * B * H,
        # hs, h0, dxw in; drw, dp out
        "lstm_bwd_weights": 5 * seq + B * H + H * 4 * H + 3 * H}
    out = {}
    for k, n in nbytes.items():
        t_bytes = esize * n / HBM_BYTES_PER_S * 1e3
        out[k] = (t_bytes, "bytes") if t_bytes >= ops_ms \
            else (ops_ms, "operations")
    return out


def lstm_fwd_errs(got, ref, tag, what):
    """The largest error of a forward's outputs against the plain
    version's; raises past the tolerances of `run_lstm_case`."""
    e = 0.0
    for name, a, b in zip(("hs", "cs", "gates", "hT", "cT"), got, ref):
        if a is None:
            continue
        tol = 1e-4 * max(1.0, b.abs().max().item()) \
            if name in ("cs", "cT") else 1e-4
        d = (a - b).abs().max().item()
        check(d <= tol, f"{what} {tag}: {name} err {d} past {tol}")
        e = max(e, d)
    return e


def run_lstm_case(c, flush, gen):
    """Every variant (peepholes on/off x masked or not) of one shape
    against the plain versions; the main variant (peepholes on, masked)
    is the one timed. Tolerances (sums of H products in another order,
    carried through T steps): 1e-4 absolute on hs and the gates, which
    lie in [-1, 1]; 1e-4 of the reference's largest magnitude (at least
    1) on the cell states, which are not bounded, and on each gradient.
    The forwards run in the design `b2_design` picks (one rule for B2a
    and B2b, so their common outputs are bit-equal); the other design is
    also held to the plain version and timed on the same inputs, and
    where design 2 runs it is launched twice for bit-equal outputs. The
    backward (T > 1) runs through `lstm_bwd`, its recurrence in the
    design `b2c_design` picks and its weight product "pipelined"; the
    other recurrence design and the "tiled" weight product are held to
    the same limits and timed on the same inputs, and design 2 of both
    launches runs twice for bit-equal outputs."""
    from deeplearning4j_tpu_torch.ops import lstm as lk

    dev = flush.device
    T, B, H, F = c["T"], c["B"], c["H"], c["F"]
    with_bwd = T > 1
    design = lk.b2_design(T, B, H, *lk.card_limits(dev))
    other = next(d for d in lk.DESIGNS if d != design)
    # B2c: the design each launch takes, and the other one
    bwd_design = {"lstm_bwd": lk.b2c_design(T, B, H, *lk.card_limits(dev)),
                  "lstm_bwd_weights": "pipelined"}
    bwd_other = {k: next(d for d in lk.B2C_DESIGNS[k] if d != v)
                 for k, v in bwd_design.items()}

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    errs = {k: 0.0 for k in lk.LAUNCHES}
    timed = None
    for peep in (False, True):
        for masked in (False, True):
            xw, rw = rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5)
            p = rnd(3, H, scale=0.5) if peep else torch.zeros(3, H,
                                                              device=dev)
            h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
            mask = torch.ones(T, B, device=dev)
            if masked and T > 1:
                lens = torch.randint(T // 4, T, (B,), generator=gen)
                mask = (torch.arange(T)[:, None] < lens[None, :]
                        ).float().to(dev)
            ins = (xw, rw, p, h0, c0, mask)
            tag = f"T{T} B{B} H{H} peep={peep} masked={masked}"
            before = dict(lk.LAUNCHES_BY_DESIGN)
            got = lk.lstm_fwd(*ins, with_residuals=True)
            inf = lk.lstm_fwd(*ins, with_residuals=False)
            check(lk.LAUNCHES_BY_DESIGN[("lstm_fwd", design)]
                  == before[("lstm_fwd", design)] + 1
                  and lk.LAUNCHES_BY_DESIGN[("lstm_fwd_inference", design)]
                  == before[("lstm_fwd_inference", design)] + 1,
                  f"lstm {tag}: the forwards did not run on {design}")
            ref = lk.lstm_fwd_plain(*ins, with_residuals=True)
            torch.cuda.synchronize()
            e = lstm_fwd_errs(got, ref, tag, f"lstm_fwd ({design})")
            check(all(torch.equal(a, b) for a, b in
                      ((got[0], inf[0]), (got[3], inf[3]), (got[4], inf[4]))),
                  f"lstm_fwd_inference {tag} differs from lstm_fwd")
            errs["lstm_fwd"] = max(errs["lstm_fwd"], e)
            errs["lstm_fwd_inference"] = max(errs["lstm_fwd_inference"], e)
            # the other design on the same inputs, held to the same limits
            e = lstm_fwd_errs(lk.launch_fwd(*ins, True, other), ref, tag,
                              f"lstm_fwd ({other})")
            errs[f"lstm_fwd/{other}"] = max(errs.get(f"lstm_fwd/{other}",
                                                     0.0), e)
            if design == "persistent":
                again = lk.lstm_fwd(*ins, with_residuals=True)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"lstm_fwd {tag}: two design-2 launches differ")
            bw = None
            if with_bwd:
                hs, cs, gates = ref[0], ref[1], ref[2]
                dhs, dhT, dcT = rnd(T, B, H), rnd(B, H), rnd(B, H)
                bw = (rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT)
                before = dict(lk.LAUNCHES_BY_DESIGN)
                gk = lk.lstm_bwd(*bw)
                check(all(lk.LAUNCHES_BY_DESIGN[(k, d)] == before[(k, d)] + 1
                          for k, d in bwd_design.items()),
                      f"lstm_bwd {tag}: not on {bwd_design}")
                gr = lk.lstm_bwd_plain(*bw)
                # the other design of each launch, by hand
                rec = lk.launch_bwd_recurrence(
                    rw, p, mask, cs, gates, c0, dhs, dhT, dcT,
                    bwd_other["lstm_bwd"])
                go = rec[:3] + lk.launch_bwd_weights(
                    hs, h0, rec[0], rec[3], bwd_other["lstm_bwd_weights"])
                torch.cuda.synchronize()
                for got, suffix in ((gk, ""), (go, "other")):
                    for name, a, b in zip(("dxw", "dh0", "dc0", "drw", "dp"),
                                          got, gr):
                        k = "lstm_bwd_weights" if name in ("drw", "dp") \
                            else "lstm_bwd"
                        d_name = (bwd_design if not suffix else bwd_other)[k]
                        tol = 1e-4 * b.abs().max().item()
                        d = (a - b).abs().max().item()
                        check(d <= tol, f"lstm_bwd {tag}: {name} ({d_name}) "
                              f"err {d} past {tol} (1e-4 of the largest "
                              f"|ref|)")
                        key = k if not suffix else f"{k}/{d_name}"
                        errs[key] = max(errs.get(key, 0.0), d)
                # design 2 of both launches twice: bit-equal
                rec2 = [lk.launch_bwd_recurrence(
                    rw, p, mask, cs, gates, c0, dhs, dhT, dcT, "persistent")
                    for _ in range(2)]
                wts2 = [lk.launch_bwd_weights(hs, h0, r[0], r[3],
                                              "pipelined") for r in rec2]
                check(all(torch.equal(a, b) for a, b in
                          zip(rec2[0] + wts2[0], rec2[1] + wts2[1])),
                      f"lstm_bwd {tag}: two design-2 launches differ")
            if peep and masked:
                timed = (ins, bw)
    ins, bw = timed
    xw, rw, p, h0, c0, mask = ins
    runs = {"lstm_fwd": lambda: lk.lstm_fwd(*ins, with_residuals=True),
            "lstm_fwd_inference": lambda: lk.lstm_fwd(
                *ins, with_residuals=False)}
    plain = {"lstm_fwd": lambda: lk.lstm_fwd_plain(*ins),
             "lstm_fwd_inference": lambda: lk.lstm_fwd_plain(
                 *ins, with_residuals=False)}
    # the library yardstick: cuDNN's LSTM over x [T, B, F], which also
    # does the input projection and has no peepholes and no mask
    cudnn = torch.nn.LSTM(F, H).to(dev)
    x = rnd(T, B, F)
    state = (h0[None].contiguous(), c0[None].contiguous())

    def lib_inference():
        with torch.no_grad():
            return cudnn(x, state)

    lib = {"lstm_fwd": lambda: cudnn(x, state),
           "lstm_fwd_inference": lib_inference}
    others = {}
    if with_bwd:
        _, _, _, hs, cs, gates, _, _, dhs, dhT, dcT = bw
        rec = {d: lk.launch_bwd_recurrence(rw, p, mask, cs, gates, c0, dhs,
                                           dhT, dcT, d)
               for d in lk.B2C_DESIGNS["lstm_bwd"]}

        def bwd_run(name, d):
            if name == "lstm_bwd":
                return lambda: lk.launch_bwd_recurrence(
                    rw, p, mask, cs, gates, c0, dhs, dhT, dcT, d)
            r = rec[bwd_design["lstm_bwd"]]
            return lambda: lk.launch_bwd_weights(hs, h0, r[0], r[3], d)

        for name in bwd_design:
            runs[name] = bwd_run(name, bwd_design[name])
            others[name] = bwd_run(name, bwd_other[name])
        dxw = rec[bwd_design["lstm_bwd"]]
        plain["lstm_bwd"] = plain["lstm_bwd_weights"] = \
            lambda: lk.lstm_bwd_plain(*bw)
        y, _ = cudnn(x.requires_grad_(), state)
        wrt = [x] + list(cudnn.parameters())
        lib["lstm_bwd"] = lambda: torch.autograd.grad(
            y, wrt, dhs, retain_graph=True)
        hprev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
        flat = dxw[0].reshape(T * B, 4 * H)
        lib["lstm_bwd_weights"] = lambda: torch.matmul(hprev.t(), flat)
    bounds = lstm_bounds(T, B, H)
    rows = []
    for name, fn in runs.items():
        timed_plain = name in c["main"] or T == 128
        ms = time_ms(fn, flush)
        row = {"phase": "kernels", "kernel": name, "dtype": "float32",
               "T": T, "B": B, "H": H, "max_abs_err": errs[name],
               "ms": ms,
               "plain_ms": time_ms(plain[name], flush, iters=5)
               if timed_plain else None,
               "library_ms": time_ms(lib[name], flush),
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "main_path_shape": name in c["main"]}
        if name in ("lstm_fwd", "lstm_fwd_inference"):
            resid = name == "lstm_fwd"
            other_ms = time_ms(lambda: lk.launch_fwd(*ins, resid, other),
                               flush)
            row.update({"design": design, "bound_share": bounds[name][0] / ms,
                        f"{other}_ms": other_ms,
                        f"speedup_over_{other}": other_ms / ms,
                        f"{other}_max_abs_err": errs[f"lstm_fwd/{other}"]})
        else:
            d, o = bwd_design[name], bwd_other[name]
            other_ms = time_ms(others[name], flush)
            row.update({"design": d, "bound_share": bounds[name][0] / ms,
                        f"{o}_ms": other_ms,
                        f"speedup_over_{o}": other_ms / ms,
                        f"{o}_max_abs_err": errs[f"{name}/{o}"]})
        emit(row)
        rows.append(row)
    return rows


# ------------------------------------ kernels: conv + BN statistics (B7)
def lstm_bf16_cases():
    """bfloat16 B2a/B2b/B2c at `path_l_bf16`'s shape (T 128, B 64, H 512,
    its main path), `path_g`'s chunk (T 50) and step (T 1) at B 32, H 256,
    and an odd shape (H 37: the strip copies 4 bytes at a time, and the
    weight product stays on "tiled")."""
    main = ("lstm_fwd_bf16", "lstm_fwd_inference_bf16", "lstm_bwd_bf16",
            "lstm_bwd_weights_bf16")
    return [dict(T=128, B=64, H=512, F=128, main=main),
            dict(T=50, B=32, H=256, F=77, main=()),
            dict(T=1, B=32, H=256, F=77, main=()),
            dict(T=7, B=5, H=37, F=11, main=())]


def bf16_weights_check(name, tag, got, wts):
    """dRW and dP of a bfloat16 weight launch (on the CPU) against the
    plain versions on the same inputs `wts` (hs, h0, dxw, cs, c0): within
    contract C13's elementwise bound (`c13_bound`) of the plain running
    bfloat16 sum, and within a bfloat16 step of their own size plus two
    float32 sums' error (`weights_f32_err`) of a float32 sum rounded
    once. Returns ({"drw": figures, "dp": figures}, the largest error
    against the sum rounded once)."""
    from deeplearning4j_tpu_torch.ops import lstm as lk

    run = lk.lstm_weights_plain(*wts)
    once = lk.lstm_weights_plain(*wts, running=False)
    out, worst = {}, 0.0
    for part, a, r, o, bnd, f32 in zip(
            ("drw", "dp"), got, run, once, lk.c13_bound(*wts),
            lk.weights_f32_err(*wts)):
        e_run = (a.float() - r.float()).abs()
        check(bool((e_run <= bnd).all()),
              f"{name} {tag}: {part} outside C13's bound at "
              f"{int((e_run > bnd).sum())} elements")
        o = o.float()
        e_once = (a.float() - o).abs()
        tol_once = lk.BF16_STEP * o.abs() + 2 * f32
        check(bool((e_once <= tol_once).all()),
              f"{name} {tag}: {part} more than a bfloat16 step from a "
              f"float32 sum rounded once")
        out[part] = {"max_abs_err_running": e_run.max().item(),
                     "max_bound": bnd.max().item(),
                     "max_err_share_of_bound":
                         (e_run / bnd.clamp_min(1e-30)).max().item(),
                     "max_abs_err_once": e_once.max().item(),
                     "max_abs": r.float().abs().max().item()}
        worst = max(worst, e_once.max().item())
    return out, worst


def run_lstm_bf16_case(c, flush, gen):
    """The bfloat16 kernels of one shape, peepholes on and masked (a row
    of T 1 held), against their plain versions on the same bfloat16
    inputs, run on the CPU, whose arithmetic is JAX's bit for bit. The
    forwards run in the design `b2_design` picks ("persistent_bf16", the
    tensor-core grid, from T 8 where a tile fits; else "cluster_bf16"),
    held by `ops/lstm.bf16_check` (2^-5 absolute on hs and the gates,
    2^-5 of the largest magnitude on cs, at most 2^-3 of hs, cs and the
    gates different at all); B2b bit-equal to B2a's common outputs. Where
    design 2 runs, design 1 is held to the same check and timed on the
    same inputs, and design 2 is launched twice for bit-equal outputs.
    The backward from the CPU's residuals: the recurrence in the design
    `b2c_design` picks ("persistent_bf16", the tensor-core grid, from T 8
    where a tile fits; else "cluster_bf16") by `bf16_check` (2^-4 of the
    largest magnitude, at most 2^-3 of dxw different); where design 2
    runs, design 1 is held to the same check and timed on the same
    inputs, and design 2 launched twice for bit-equal outputs. dRW and dP
    on the kernel's own dxw and dP partials in the design
    `b2c_weights_design` picks ("wgmma_bf16" where H is a multiple of 8,
    else "tiled_bf16") within contract C13's bound of the plain running
    bfloat16 sum and a bfloat16 step of a float32 sum rounded once
    (`bf16_weights_check`); where "wgmma" runs, "tiled" is held to the
    same and timed on the same inputs, and "wgmma" launched twice for
    bit-equal outputs. Times (cold L2) beside the bound at the
    bfloat16 peak and element size, the plain versions' on the card at
    the main shape, and cuDNN's LSTM in bfloat16 (a yardstick the port
    never calls, with the input projection and no peepholes or mask) or,
    for the weight product, one bfloat16 `torch.matmul`."""
    from deeplearning4j_tpu_torch.ops import lstm as lk

    dev = flush.device
    bf = torch.bfloat16
    T, B, H, F = c["T"], c["B"], c["H"], c["F"]
    design = lk.b2_design(T, B, H, *lk.card_limits(dev), bf)
    r_design = lk.b2c_design(T, B, H, *lk.card_limits(dev), bf)
    w_design = lk.b2c_weights_design(H, bf)
    # the design each launch takes, and design 1 beside it where it does
    # not run
    designs = {"lstm_fwd": design, "lstm_fwd_inference": design,
               "lstm_bwd": r_design, "lstm_bwd_weights": w_design}
    others = {k: lk.BF16_DESIGNS[k][0] for k, d in designs.items()
              if d != lk.BF16_DESIGNS[k][0]}

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev, bf)

    xw, rw = rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5)
    p, h0, c0 = rnd(3, H, scale=0.5), rnd(B, H, scale=0.5), rnd(B, H,
                                                              scale=0.5)
    lens = torch.randint(0 if T == 1 else T // 4, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[:, None] < lens[None, :]).to(dev, bf)
    ins = (xw, rw, p, h0, c0, mask)
    tag = f"bf16 T{T} B{B} H{H}"
    before = dict(lk.LAUNCHES_BY_DESIGN)
    got = lk.lstm_fwd(*ins, with_residuals=True)
    inf = lk.lstm_fwd(*ins, with_residuals=False)
    check(all(lk.LAUNCHES_BY_DESIGN[(k, design + "_bf16")]
              == before[(k, design + "_bf16")] + 1
              for k in ("lstm_fwd", "lstm_fwd_inference")),
          f"lstm {tag}: the forwards did not run on {design}_bf16")
    host = [t.cpu() for t in ins]
    ref = lk.lstm_fwd_plain(*host, with_residuals=True)
    errs, shares = {}, {}

    def fwd_check(outs, what):
        e, sh = 0.0, {}
        for name, a, b in zip(("hs", "cs", "gates", "hT", "cT"), outs, ref):
            a = a.cpu()
            ok, d, share = lk.bf16_check(name, a, b)
            check(a.dtype == bf and ok, f"lstm_fwd {tag} ({what}): {name} "
                  f"err {d} (limit {lk.bf16_atol(name, b)}), {share} of it "
                  f"differs")
            e = max(e, d)
            sh[name] = share
        return e, sh

    errs["fwd"], shares["fwd"] = fwd_check(got, design)
    check(all(torch.equal(a, b) for a, b in
              ((got[0], inf[0]), (got[3], inf[3]), (got[4], inf[4]))),
          f"lstm_fwd_inference {tag} differs from lstm_fwd")
    if design == "persistent":
        again = lk.lstm_fwd(*ins, with_residuals=True)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"lstm_fwd {tag}: two persistent_bf16 launches differ")
        errs["fwd_other"], shares["fwd_cluster"] = fwd_check(
            lk.launch_fwd(*ins, True, "cluster"), "cluster")
    dhs, dhT, dcT = rnd(T, B, H), rnd(B, H), rnd(B, H)
    hs, cs, gates = (t.to(dev) for t in ref[:3])
    bw = (rw, p, mask, hs, cs, gates, h0, c0, dhs, dhT, dcT)
    bw_host = [t.cpu() for t in bw]
    before = dict(lk.LAUNCHES_BY_DESIGN)
    gk = lk.lstm_bwd(*bw)
    check(lk.LAUNCHES_BY_DESIGN[("lstm_bwd", r_design + "_bf16")]
          == before[("lstm_bwd", r_design + "_bf16")] + 1
          and lk.LAUNCHES_BY_DESIGN[("lstm_bwd_weights", w_design + "_bf16")]
          == before[("lstm_bwd_weights", w_design + "_bf16")] + 1,
          f"lstm_bwd {tag}: not on {r_design}_bf16 + {w_design}_bf16")
    gr = lk.lstm_bwd_plain(*bw_host)
    gk_host = [t.cpu() for t in gk]

    def bwd_check(outs, what):
        e, sh = 0.0, {}
        for name, a, b in zip(("dxw", "dh0", "dc0"), outs, gr):
            a = a.cpu()
            ok, d, share = lk.bf16_check(name, a, b)
            check(a.dtype == bf and ok, f"lstm_bwd {tag} ({what}): {name} "
                  f"err {d} (limit {lk.bf16_atol(name, b)}), {share} of it "
                  f"differs")
            e = max(e, d)
            sh[name] = share
        return e, sh

    errs["bwd"], shares["bwd"] = bwd_check(gk_host, r_design)
    # the weight launch on the kernel's own dxw and dP partials, on the CPU
    wts = (bw_host[3], bw_host[6], gk_host[0], bw_host[4], bw_host[7])
    c13, errs["weights"] = bf16_weights_check("lstm_bwd_weights", tag,
                                              gk_host[3:], wts)
    rec = lk.launch_bwd_recurrence(rw, p, mask, cs, gates, c0, dhs, dhT,
                                   dcT, r_design)
    if r_design == "persistent":
        check(all(torch.equal(a, b) for a, b in zip(rec[:3], gk[:3])),
              f"lstm_bwd {tag}: two persistent_bf16 launches differ")
        errs["bwd_other"], shares["bwd_cluster"] = bwd_check(
            lk.launch_bwd_recurrence(rw, p, mask, cs, gates, c0, dhs, dhT,
                                     dcT, "cluster"), "cluster")
    if w_design == "wgmma":
        two = [lk.launch_bwd_weights(hs, h0, rec[0], rec[3], "wgmma")
               for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*two)),
              f"lstm_bwd_weights {tag}: two wgmma_bf16 launches differ")
        tiled = lk.launch_bwd_weights(hs, h0, rec[0], rec[3], "tiled")
        wts_k = wts[:2] + (rec[0].cpu(),) + wts[3:]
        c13["tiled_bf16"], errs["weights_other"] = bf16_weights_check(
            "lstm_bwd_weights (tiled)", tag, [t.cpu() for t in tiled],
            wts_k)
    emit({"phase": "kernels", "kernel": "lstm_bwd_weights_bf16",
          "check": "c13", "design": w_design + "_bf16", "T": T, "B": B,
          "H": H, **c13, "share_differing": shares})

    def launch(name, d):
        if name in ("lstm_fwd", "lstm_fwd_inference"):
            return lambda: lk.launch_fwd(*ins, name == "lstm_fwd", d)
        if name == "lstm_bwd":
            return lambda: lk.launch_bwd_recurrence(
                rw, p, mask, cs, gates, c0, dhs, dhT, dcT, d)
        return lambda: lk.launch_bwd_weights(hs, h0, rec[0], rec[3], d)

    plain = {"lstm_fwd_bf16": lambda: lk.lstm_fwd_plain(*ins),
             "lstm_fwd_inference_bf16": lambda: lk.lstm_fwd_plain(
                 *ins, with_residuals=False),
             "lstm_bwd_bf16": lambda: lk.lstm_bwd_plain(*bw),
             "lstm_bwd_weights_bf16": lambda: lk.lstm_weights_plain(
                 hs, h0, rec[0], cs, c0)}
    cudnn = torch.nn.LSTM(F, H).to(dev, bf)
    x = rnd(T, B, F)
    state = (h0[None].contiguous(), c0[None].contiguous())

    def lib_inference():
        with torch.no_grad():
            return cudnn(x, state)

    y, _ = cudnn(x.requires_grad_(), state)
    wrt = [x] + list(cudnn.parameters())
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
    flat = rec[0].reshape(T * B, 4 * H)
    lib = {"lstm_fwd_bf16": lambda: cudnn(x, state),
           "lstm_fwd_inference_bf16": lib_inference,
           "lstm_bwd_bf16": lambda: torch.autograd.grad(
               y, wrt, dhs, retain_graph=True),
           "lstm_bwd_weights_bf16": lambda: torch.matmul(hprev.t(), flat)}
    bounds = lstm_bounds(T, B, H, bf)
    err_of = {"lstm_fwd": "fwd", "lstm_fwd_inference": "fwd",
              "lstm_bwd": "bwd", "lstm_bwd_weights": "weights"}
    flops = 2.0 * T * B * H * 4 * H
    rows = []
    for base, d in designs.items():
        name = base + "_bf16"
        ms = time_ms(launch(base, d), flush)
        row = {"phase": "kernels", "kernel": name, "dtype": "bfloat16",
               "T": T, "B": B, "H": H, "max_abs_err": errs[err_of[base]],
               "ms": ms,
               "plain_ms": time_ms(plain[name], flush, iters=3)
               if name in c["main"] else None,
               "library_ms": time_ms(lib[name], flush),
               "bound_ms": bounds[base][0], "bound_by": bounds[base][1],
               "bound_share": bounds[base][0] / ms,
               "tflops": flops / ms * 1e-9,
               "design": d + "_bf16",
               "main_path_shape": name in c["main"]}
        if base in others:
            o = others[base]
            other_ms = time_ms(launch(base, o), flush)
            row.update({f"{o}_bf16_ms": other_ms,
                        f"speedup_over_{o}_bf16": other_ms / ms,
                        f"{o}_bf16_max_abs_err": errs[err_of[base]
                                                      + "_other"]})
        if base == "lstm_bwd_weights" and d == "wgmma":
            row["splits"] = lk.b2c_wgmma_splits(
                T, B, H, lk.card_limits(dev)[0], lk.wgmma_clusters(dev))
        if base in ("lstm_fwd", "lstm_bwd"):
            part = "fwd" if base == "lstm_fwd" else "bwd"
            row["share_differing"] = shares[part]
            if part + "_cluster" in shares:
                row["cluster_bf16_share_differing"] = \
                    shares[part + "_cluster"]
        emit(row)
        rows.append(row)
    return rows


def resnet_conf(num_classes=1000, size=224, fused=True, dtype="bfloat16",
                **kw):
    """`bench.py`'s ResNet-50 configuration (`_bench_resnet50`), `fused`
    conv+BN, in `dtype`, with one cut: Nesterovs(0.01, 0.9) in place of
    the bench's Nesterovs(0.1, 0.9). At 0.1, with no warmup, 12 steps on
    four fixed batches of random images make the loss rise (epoch means
    10.27, 14.17, 16.04 on an H100), and `path_r` requires it to fall;
    the step's work, and so its time, does not depend on the rate."""
    import dataclasses

    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    from deeplearning4j_tpu_torch.zoo import ResNet50

    kw.setdefault("updater", Nesterovs(0.01, 0.9))
    conf = ResNet50(num_classes=num_classes, input_shape=(size, size, 3),
                    fused=fused, **kw).conf()
    return dataclasses.replace(conf, dtype=dtype)


def b7_path_shapes(batch=128):
    """{(kernel, shape): launches a train step} of `path_r`, read off its
    configuration: B7a (M, K, N) for each fused 1x1 (M counts the strided
    rows), B7b (B, H, W, C_in, C_out) for each fused 3x3."""
    import collections

    from deeplearning4j_tpu_torch.nn.graph import resolve_output_type
    from deeplearning4j_tpu_torch.nn.layers import FusedConvBNLayer

    conf = resnet_conf()
    known = dict(conf.input_types)
    shapes = collections.Counter()
    for name in conf.topological_order:
        v = conf.vertices[name]
        ins = conf.vertex_inputs[name]
        in_types = [known[i] for i in ins if i in known]
        layer = getattr(v, "layer", None)
        if isinstance(layer, FusedConvBNLayer):
            it = in_types[0]
            if tuple(layer.kernel) == (3, 3):
                shapes[("conv3x3_bn_stats", (batch, it.height, it.width,
                                             it.channels, layer.n_out))] += 1
            else:
                sh, sw = layer.stride
                m = batch * -(-it.height // sh) * -(-it.width // sw)
                shapes[("conv1x1_bn_stats",
                        (m, it.channels, layer.n_out))] += 1
        resolve_output_type(name, v, in_types, len(ins), known)
    return shapes


def b7_cases():
    """Every distinct B7 shape of `path_r` (with its launches a step) and
    ragged cases: M, K, N off the 128x64x16 tiles, 7x7 maps at batch 3,
    3 input channels."""
    cases = [dict(kernel=k, shape=s, per_step=n)
             for (k, s), n in sorted(b7_path_shapes().items())]
    cases += [dict(kernel="conv1x1_bn_stats", shape=s, per_step=0)
              for s in ((1000, 37, 130), (129, 19, 65), (147, 2048, 512))]
    cases += [dict(kernel="conv3x3_bn_stats", shape=s, per_step=0)
              for s in ((3, 7, 7, 512, 512), (2, 5, 6, 3, 4))]
    return cases


def b7_data_cases():
    """float32 cases of other data than Gaussians, for design 3: x after a
    ReLU (nonnegative, as ResNet's activations), and small integers, on
    which every product and sum is exact in TF32, so design 3 must be
    exact where design 1 is. Not on the main path (`per_step` 0)."""
    return [dict(kernel=k, shape=s, per_step=0, data=d)
            for d in ("relu", "ints")
            for k, s in (("conv1x1_bn_stats", (100352, 256, 128)),
                         ("conv3x3_bn_stats", (128, 14, 14, 256, 256)))]


def b7_flops(kernel, shape):
    """2·M·K·N of one B7 call (K = 9·C for the 3x3)."""
    if kernel == "conv1x1_bn_stats":
        m, k, n = shape
        return 2.0 * m * k * n
    b, h, w, c, n = shape
    return 2.0 * b * h * w * 9 * c * n


def b7_rate(dtype, design="ffma"):
    """The peak rate a B7 call's products are bound by: the dtype's (FMA
    in float32, the tensor cores in bfloat16), or the 3xTF32 rate for
    design 3."""
    return PEAK_FLOPS_TF32X3 if design == "tf32x3" else PEAK_FLOPS[dtype]


def b7_bound(kernel, shape, dtype, design="ffma"):
    """(bound_ms, bound_by): 2·M·K·N flops at the design's peak
    (`b7_rate`) against x, w read once, y written once and the 2·N
    float32 sums over HBM."""
    es = torch.tensor([], dtype=dtype).element_size()
    if kernel == "conv1x1_bn_stats":
        m, k, n = shape
        x_elems = m * k
    else:
        b, h, w, c, n = shape
        m, k, x_elems = b * h * w, 9 * c, b * h * w * c
    ops_ms = b7_flops(kernel, shape) / b7_rate(dtype, design) * 1e3
    bytes_ms = ((x_elems + k * n + m * n) * es + 8 * n) \
        / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


B7_OUTPUTS = ("y", "sums", "sumsqs")


def b7_f64_shares(got, ref64):
    """{output: largest error against the float64 plain version, a share
    of the largest |ref|} for y, Σy and Σy² (the guard of design 3)."""
    return {n: ((a.double().reshape(r.shape) - r).abs().max()
                / r.abs().max()).item()
            for n, a, r in zip(B7_OUTPUTS, got, ref64)}


def run_b7_case(c, dtype, flush, gen):
    """One B7 shape in one dtype against its plain version: y within
    2e-5 of its largest magnitude (float32, K products summed in another
    order) or one bf16 step (both round once from float32); Σy within
    1e-5 of Σ|y| and Σy² within 1e-5 relative (M values summed in another
    order), the statistics from the float32 accumulator in both dtypes.
    Timed with a cold L2: the kernel, the plain version, and the library
    yardstick — `torch.matmul` (B7a) or `F.conv2d` (B7b) computing y
    alone, without the statistics, in the same dtype (bf16 on the tensor
    cores; float32 with TF32 off). The row names the design that ran
    (`ops.conv_fused.b7_design`: "wgmma" for aligned bfloat16, "tf32x3"
    for aligned float32, "ffma" otherwise), its TFLOP/s and its share of
    the bound at the design's rate. A row on design 2 or 3 also times
    design 1 on the same inputs (`ffma_ms`); on design 3 it holds the
    guard, each of y, Σy and Σy² against the plain version in float64 at
    most twice design 1's error (`guard_ratio`), and two launches
    bit-equal."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import conv_fused as cf

    dev = flush.device
    kernel, shape = c["kernel"], c["shape"]
    data = c.get("data", "gauss")
    if data != "gauss":
        x, w = b7_data(kernel, shape, data, gen)
        x, w = x.to(dev, dtype), w.to(dev, dtype)
    if kernel == "conv1x1_bn_stats":
        m, k, n = shape
        if data == "gauss":
            x = torch.randn(m, k, generator=gen).to(dev, dtype)
            w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(dev, dtype)
        run = lambda: cf.matmul_with_channel_stats(x, w)  # noqa: E731
        plain = lambda: cf.matmul_with_channel_stats_plain(x, w)  # noqa
        lib = lambda: torch.matmul(x, w)  # noqa: E731
    else:
        b, h, wd, cin, n = shape
        if data == "gauss":
            x = torch.randn(b, h, wd, cin, generator=gen).to(dev, dtype)
            w = (torch.randn(3, 3, cin, n, generator=gen)
                 / (9 * cin) ** 0.5).to(dev, dtype)
        run = lambda: cf.conv3x3_with_channel_stats(x, w)  # noqa: E731
        plain = lambda: cf.conv3x3_with_channel_stats_plain(x, w)  # noqa
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        lib = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
    before = cf.LAUNCHES[kernel]
    by_design = dict(cf.LAUNCHES_BY_DESIGN)
    y, s, q = run()
    yr, sr, qr = plain()
    torch.cuda.synchronize()
    check(cf.LAUNCHES[kernel] == before + 1, f"{kernel} did not launch")
    ran = [d for d in cf.DESIGNS if cf.LAUNCHES_BY_DESIGN[(kernel, d)]
           == by_design[(kernel, d)] + 1]
    check(len(ran) == 1, f"{kernel}: launches by design {ran}")
    yf, yrf = y.float(), yr.float()
    err_y = (yf - yrf).abs().max().item()
    tag = f"{kernel} {shape} {dtype} {data}"
    if dtype == torch.float32:
        tol = 2e-5 * max(1.0, yrf.abs().max().item())
        check(err_y <= tol, f"{tag}: y err {err_y} past {tol}")
    else:
        check(bool(((yf - yrf).abs() <= 1e-5 + 2.0 ** -7 * yrf.abs()).all()),
              f"{tag}: y more than one bf16 step from the plain version")
    abs_sum = yrf.abs().reshape(-1, yrf.shape[-1]).sum(0)
    err_s = (s - sr).abs().max().item()
    err_q = (q - qr).abs().max().item()
    check(bool(((s - sr).abs() <= 1e-5 * abs_sum + 1e-6).all()),
          f"{tag}: sums err {err_s}")
    check(bool(((q - qr).abs() <= 1e-5 * qr.abs() + 1e-6).all()),
          f"{tag}: sums of squares err {err_q}")
    del y, s, q, yr, sr, qr, yf, yrf
    row = {"phase": "kernels", "kernel": kernel, "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""), "data": data,
           "launches_per_path_r_step": c["per_step"],
           "max_abs_err": max(err_y, err_s, err_q), "max_abs_err_y": err_y,
           "max_abs_err_sums": err_s, "max_abs_err_sumsq": err_q,
           "ms": time_ms(run, flush),
           "plain_ms": time_ms(plain, flush, iters=5),
           "library_ms": time_ms(lib, flush),
           "library": "torch.matmul (y only)" if kernel == "conv1x1_bn_stats"
           else "F.conv2d (y only)",
           "main_path_shape": c["per_step"] > 0, "design": ran[0]}
    row["bound_ms"], row["bound_by"] = b7_bound(kernel, shape, dtype,
                                                ran[0])
    row["tflops"] = b7_flops(kernel, shape) / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if ran[0] in ("wgmma", "tf32x3"):
        # design 1 on the same inputs, timed only: the redesign's gain
        row["ffma_ms"] = time_ms(
            lambda: cf._launch(kernel, x, w, shape, "ffma"), flush)
        row["speedup_over_ffma"] = row["ffma_ms"] / row["ms"]
    if ran[0] == "tf32x3":
        row.update(b7_guard(kernel, shape, x, w, run, tag))
    emit(row)
    return row


def b7_data(kernel, shape, data, gen):
    """float32 inputs on the host: "relu", x = relu(N(0, 1)) and w scaled
    by its fan in; "ints", both in -3..3 (exact in TF32)."""
    *lead, cin, n = shape
    kshape = (cin, n) if kernel == "conv1x1_bn_stats" else (3, 3, cin, n)
    if data == "ints":
        return (torch.randint(-3, 4, (*lead, cin), generator=gen).float(),
                torch.randint(-3, 4, kshape, generator=gen).float())
    fan = cin * (9 if kernel == "conv3x3_bn_stats" else 1)
    return (torch.relu(torch.randn(*lead, cin, generator=gen)),
            torch.randn(*kshape, generator=gen) / fan ** 0.5)


def b7_guard(kernel, shape, x, w, run, tag):
    """Design 3 against design 1 on the same float32 inputs, each against
    the plain version in float64: the largest error of y, Σy and Σy² (a
    share of the largest |ref|) must stay within twice design 1's (so be
    exact where design 1 is: TF32-exact data); and two launches of
    design 3 bit-equal (fixed-order sums, no atomics)."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf

    plain = cf.matmul_with_channel_stats_plain \
        if kernel == "conv1x1_bn_stats" \
        else cf.conv3x3_with_channel_stats_plain
    ref64 = plain(x.double(), w.double())
    first, again = run(), run()
    d1 = cf._launch(kernel, x, w, shape, "ffma")
    torch.cuda.synchronize()
    mine = b7_f64_shares(first, ref64)
    ffma = b7_f64_shares(d1, ref64)
    ratio = {n: mine[n] / ffma[n] if ffma[n] else
             (0.0 if mine[n] == 0 else float("inf")) for n in B7_OUTPUTS}
    equal = [torch.equal(a, b) for a, b in zip(first, again)]
    check(all(mine[n] <= 2.0 * ffma[n] for n in B7_OUTPUTS),
          f"{tag}: design 3's guard {ratio} past 2 (design 3 {mine}, "
          f"design 1 {ffma})")
    check(all(equal), f"{tag}: two design 3 launches differ {equal}")
    return {"f64_share": mine, "ffma_f64_share": ffma,
            "guard_ratio": ratio, "bit_equal_repeat": equal,
            "ffma_bound_ms": b7_bound(kernel, shape, x.dtype)[0]}


def run_b7_repeat(gen):
    """Design 2 (bfloat16) and design 3 (float32) each launched twice on
    two `path_r` shapes, one of each kernel: y and the statistics must be
    bit-equal (fixed-order sums, no atomics). The float32 cases draw
    after the bfloat16 ones, which keep the inputs they always had."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf

    rows = []
    for dtype, design in ((torch.bfloat16, "wgmma"),
                          (torch.float32, "tf32x3")):
        for kernel, shape in (("conv1x1_bn_stats", (401408, 64, 256)),
                              ("conv3x3_bn_stats", (128, 14, 14, 256, 256))):
            *lead, cin, n = shape
            x = torch.randn(*lead, cin, generator=gen).to("cuda", dtype)
            if kernel == "conv1x1_bn_stats":
                w = torch.randn(cin, n, generator=gen).to("cuda", dtype)
                run = cf.matmul_with_channel_stats
            else:
                w = torch.randn(3, 3, cin, n, generator=gen).to("cuda",
                                                                dtype)
                run = cf.conv3x3_with_channel_stats
            before = cf.LAUNCHES_BY_DESIGN[(kernel, design)]
            a, b = run(x, w), run(x, w)
            torch.cuda.synchronize()
            check(cf.LAUNCHES_BY_DESIGN[(kernel, design)] == before + 2,
                  f"{kernel} {shape}: {design} did not take both launches")
            equal = [torch.equal(u, v) for u, v in zip(a, b)]
            check(all(equal), f"{kernel} {shape} {dtype}: two launches "
                  f"differ (y, sums, sums of squares equal: {equal})")
            rows.append({"phase": "b7_repeat", "kernel": kernel,
                         "shape": list(shape), "design": design,
                         "dtype": str(dtype).replace("torch.", ""),
                         "bit_equal": equal})
            emit(rows[-1])
            del x, w, a, b
    return rows


def b7_step_totals(rows, kernel, dtype):
    """The times of one B7 kernel a `path_r` step in `dtype` ("bfloat16"
    for `path_r`, "float32" for `path_r_f32`): each shape's per-launch
    time times its launches a step, summed; the bound by the larger
    summed side, at the design's rate; design 1's time on the same
    inputs (`ffma_ms`); the library's; the largest error against the
    plain version on the Gaussian cases; design 3's guard at its worst
    on every case."""
    mine = [r for r in rows if r["kernel"] == kernel
            and r["dtype"] == dtype]
    main = [r for r in mine if r["main_path_shape"]]
    gauss = [r for r in mine if r["data"] == "gauss"]
    tot = {key: sum(r.get(key, r["ms"]) * r["launches_per_path_r_step"]
                    for r in main)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "ffma_ms")}
    by_ops = sum(r["bound_ms"] * r["launches_per_path_r_step"]
                 for r in main if r["bound_by"] == "operations")
    flops = sum(b7_flops(kernel, tuple(r["shape"]))
                * r["launches_per_path_r_step"] for r in main)
    out = {**tot, "max_abs_err": max(r["max_abs_err"] for r in gauss),
           "bound_by": "operations" if by_ops >= tot["bound_ms"] / 2
           else "bytes", "design": sorted({r["design"] for r in main}),
           "tflops": flops / tot["ms"] / 1e9,
           "bound_share": tot["bound_ms"] / tot["ms"],
           "speedup_over_ffma": tot["ffma_ms"] / tot["ms"],
           "speedup_over_library": tot["library_ms"] / tot["ms"],
           "per": f"path_r step: "
                  f"{sum(r['launches_per_path_r_step'] for r in main)} "
                  f"launches over {len(main)} shapes, {dtype}"}
    guarded = [r for r in mine if "guard_ratio" in r]
    if guarded:
        out["guard_ratio_max"] = {n: max(r["guard_ratio"][n]
                                         for r in guarded)
                                  for n in B7_OUTPUTS}
        out["ffma_bound_ms"] = sum(r["ffma_bound_ms"]
                                   * r["launches_per_path_r_step"]
                                   for r in main)
    return out


# ------------------------------------------------------ serving phases
def build_net(device, *, num_blocks, seed, t=2048, dtype="float32",
              gradient_checkpointing=False, dropout=None, d_model=512,
              **kw):
    """The zoo transformer at the repo's largest width; another `dtype`
    replaces the zoo conf's, as `bench.py`'s `_bench_transformer` does
    (`bench.py:497-501`); `gradient_checkpointing` and a `dropout` on
    every block change the conf too."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.layers import TransformerEncoderBlock
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    zoo = TextGenerationTransformer(
        input_shape=(t, 1), d_model=d_model, num_heads=8,
        num_blocks=num_blocks, seed=seed, **kw)
    conf = dataclasses.replace(
        zoo.conf(), dtype=dtype,
        gradient_checkpointing=gradient_checkpointing)
    if dropout:
        conf = dataclasses.replace(conf, layers=tuple(
            dataclasses.replace(l, dropout=dropout)
            if isinstance(l, TransformerEncoderBlock) else l
            for l in conf.layers))
    return MultiLayerNetwork(conf, device=device).init()


def control_plane(net, *, slots, chunk, k, kv_dtype=None, draft=None,
                  spec_k=None):
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeSessionManager, ModelRegistry,
        ServingStats,
    )

    registry = ModelRegistry()
    registry.deploy("default", 1, net, warm=False)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats,
                                        max_batch_size=2 * slots)
    mgr = DecodeSessionManager(registry, sched, "default", slots=slots,
                               prefill_chunk=chunk, fused_k=k,
                               draft_net=draft, spec_k=spec_k,
                               kv_dtype=kv_dtype, metrics=stats.registry)
    return registry, sched, mgr


def pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else None


def serve_wave(mgr, prompts, greedy, max_tokens, vocab):
    """Open every session at once, wait for all; returns the streams and
    the wave's end-to-end numbers (host clock)."""
    itl_before = len(mgr._h_itl.values())
    t0 = time.perf_counter()
    sessions = [mgr.open_session(p, max_tokens=max_tokens, greedy=g,
                                 temperature=0.8, top_k=40, seed=1000 + i)
                for i, (p, g) in enumerate(zip(prompts, greedy))]
    streams = [s.result(timeout=600) for s in sessions]
    wall = time.perf_counter() - t0
    for s, toks in zip(sessions, streams):
        check(len(toks) == max_tokens,
              f"session {s.id} returned {len(toks)} of {max_tokens}")
        check(all(0 <= t < vocab for t in toks),
              f"session {s.id} produced an out-of-vocabulary token")
    ttft = [s.ttft_ms for s in sessions]
    itl = mgr._h_itl.values()[itl_before:]
    n_tok = sum(len(t) for t in streams)
    return streams, {
        "sessions": len(sessions), "prompt_tokens": int(
            sum(len(p) for p in prompts)),
        "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "ttft_samples": len(ttft), "itl_ms_p50": pct(itl, 50),
        "itl_samples": len(itl)}


def drive_path(net, name, kernel, prompts_waves, greedy, max_tokens, *,
               slots, chunk, k, kv_dtype=None):
    """Serve each wave through the session manager with every launch
    count zeroed just before and read just after; returns the streams
    and the path's summary line."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba

    registry, sched, mgr = control_plane(net, slots=slots, chunk=chunk, k=k,
                                         kv_dtype=kv_dtype)
    try:
        torch.cuda.synchronize()
        ba.reset_counts()
        before = window_graph_counts(net)
        waves, streams = [], []
        for prompts in prompts_waves:
            s, w = serve_wave(mgr, prompts, greedy, max_tokens, mgr.vocab)
            streams.append(s)
            waves.append(w)
        torch.cuda.synchronize()
        launches, by_design, plain_on_cuda = decode_counts(ba)
        snap = mgr.snapshot()
        graphs = {c: v - before[c]
                  for c, v in window_graph_counts(net).items()}
    finally:
        sched.shutdown()
        registry.close()
    windows = snap["dispatches"]["windows"]
    if net.cuda_graphs:
        # the manager's warm-up captured the window: every window of the
        # waves is one replay
        check(graphs["replays"] == windows and graphs["eager"] == 0,
              f"{name}: {windows} windows, graph counts {graphs}")
    else:
        check(graphs["replays"] == 0, f"{name}: the eager loop replayed "
              f"graphs: {graphs}")
    # float32 queries: every B5/B5q and B6/B6q launch on design 2
    check_design_2(name, kernel, launches, by_design, plain_on_cuda)
    row = {"phase": name, "kernel": kernel, "launches": launches,
           "launches_by_design": by_design,
           "plain_on_cuda": plain_on_cuda, "waves": waves,
           "slots": snap["slots"], "kv_dtype": snap["kv_dtype"],
           "prefix_cache": snap["prefix_cache"],
           "decode_loop": snap["decode_loop"],
           "window_graphs": net.cuda_graphs, "window_graph_counts": graphs,
           "dispatches": snap["dispatches"],
           "kernel_policy": snap["kernel_policy"]}
    return streams, row


def window_graph_counts(net):
    st = net._graphs.stats.get("decode_window", {})
    return {c: st.get(c, 0) for c in ("replays", "eager", "captures",
                                      "capture_ms")}


def path_a(device, rng):
    """Full width, 6 blocks, prefix cache on: B6 on every decode step,
    each decode window one CUDA graph replay; then the same waves through
    the eager loop (`cuda_graphs` off, the plain version of the graphs),
    every stream, greedy and sampled, equal token for token."""
    net = build_net(device, num_blocks=6, seed=7)
    prompts = [rng.integers(0, 256, 1024) for _ in range(8)]
    stem = prompts[0]
    # wave 2: the wave-1 prompt 0 itself (warm, must equal its cold
    # stream), then the same 1024-token stem with distinct suffixes
    wave2 = [stem] + [np.concatenate([stem, rng.integers(0, 256, 8)])
                      for _ in range(7)]
    greedy = [True] * 6 + [False] * 2
    (w1, w2), row = drive_path(net, "path_a", "paged_decode_attention",
                               [prompts, wave2], greedy, 64, slots=8,
                               chunk=128, k=8)
    check(row["prefix_cache"]["enabled"], "path_a: prefix cache is off")
    check(row["prefix_cache"]["hits"] >= 8,
          f"path_a: wave 2 missed the prefix cache: {row['prefix_cache']}")
    check(w2[0] == w1[0], "path_a: a warm-prefix session's greedy stream "
          "differs from the cold one")
    row["warm_vs_cold_ttft_p50"] = (row["waves"][1]["ttft_ms_p50"]
                                    / row["waves"][0]["ttft_ms_p50"])
    net.cuda_graphs = False
    (e1, e2), eager = drive_path(net, "path_a_eager", "paged_decode_attention",
                                 [prompts, wave2], greedy, 64, slots=8,
                                 chunk=128, k=8)
    net.cuda_graphs = True
    check(e1 == w1 and e2 == w2, "path_a: the graphed windows' streams "
          "differ from the eager loop's")
    row["eager_loop"] = {k: eager[k] for k in ("waves", "launches",
                                               "dispatches",
                                               "window_graph_counts")}
    row["graphed_streams_equal_eager"] = True
    emit(row)
    return row, prompts, w1


def build_path_b_net(device):
    return build_net(device, num_blocks=2, seed=11, pos_encoding="rope",
                     norm="rms", ffn_activation="swiglu", num_kv_heads=2,
                     window=256, rolling_cache=True)


def path_b(device, rng):
    """Llama-shaped, 2 blocks, rolling ring (L = 2048 + 256 - 1 = 2303):
    B5 on every decode step; prompts of 2240 + 128 new tokens run past
    the ring's length, so it wraps."""
    net = build_path_b_net(device)
    prompts = [rng.integers(0, 256, 2240) for _ in range(8)]
    greedy = [True] * 6 + [False] * 2
    (streams,), row = drive_path(net, "path_b", "banded_decode_attention",
                                 [prompts], greedy, 128, slots=8, chunk=128,
                                 k=8)
    check(not row["prefix_cache"]["enabled"],
          "path_b: a rolling ring cannot page, yet the prefix cache is on")
    emit(row)
    return row, prompts, streams


def cpu_parity(rng, steps=8, tol=1e-3):
    """Path A's model at 2 blocks on the card and on the CPU, same seed
    and so the same weights: one 64-token greedy prompt, then `steps`
    single-token steps fed the CPU's greedy tokens. Output probabilities
    agree within `tol`; the card's greedy token equals the CPU's wherever
    the CPU's top-2 margin exceeds `tol`; the fused window's greedy
    tokens on the card equal the stepwise CPU stream."""
    nets = {d: build_net(d, num_blocks=2, seed=7) for d in ("cuda", "cpu")}
    prompt = rng.integers(0, 256, 64)

    def prefill(net):
        carries = net.session_carries(1, page_len=128)
        stem = prompt[:-1].astype(np.float32)[None, :, None]
        _, carries = net.session_step(stem, carries,
                                      valid=np.ones((1, stem.shape[1]),
                                                    np.float32))
        return carries

    carries = {d: prefill(n) for d, n in nets.items()}
    tok = int(prompt[-1])
    max_err, checked, cpu_stream, clear = 0.0, 0, [], steps
    for i in range(steps):
        probs = {}
        for d, net in nets.items():
            x = np.full((1, 1, 1), tok, np.float32)
            out, carries[d] = net.session_step(x, carries[d])
            probs[d] = out[0, -1].float().cpu()
        err = (probs["cuda"] - probs["cpu"]).abs().max().item()
        max_err = max(max_err, err)
        check(err <= tol, f"cpu_parity: probabilities differ by {err}")
        top2 = torch.topk(probs["cpu"], 2).values
        tok = int(torch.argmax(probs["cpu"]))
        if float(top2[0] - top2[1]) > tol:
            check(int(torch.argmax(probs["cuda"])) == tok,
                  "cpu_parity: greedy tokens differ at a clear margin")
            checked += 1
        else:
            clear = min(clear, i)
        cpu_stream.append(tok)
    # the fused window on the card feeds back its own tokens, so its
    # stream must equal the CPU's up to the first step whose top-2
    # margin is too small to call
    S = 1
    win = nets["cuda"].session_decode_window(
        np.array([prompt[-1]]), prefill(nets["cuda"]),
        active=np.ones(S, bool), k=steps,
        temperature=np.ones(S, np.float32), top_k=np.full(S, 256, np.int32),
        top_p=np.ones(S, np.float32), greedy=np.ones(S, bool),
        keys=np.zeros((S, 2), np.uint32), offsets=np.zeros(S, np.int32),
        budgets=np.full(S, steps, np.int32),
        eos_ids=np.full(S, -1, np.int32))
    window_stream = win[0][0].cpu().tolist()
    check(window_stream[:clear + 1] == cpu_stream[:clear + 1],
          f"cpu_parity: fused window {window_stream} != CPU stepwise "
          f"{cpu_stream} within the first {clear + 1} tokens")
    row = {"phase": "cpu_parity", "max_abs_err": max_err, "tol": tol,
           "steps": steps, "greedy_checked": checked,
           "window_checked": min(clear + 1, steps), "tokens": cpu_stream}
    emit(row)
    return row


def prefill_slot0(net, carries, prompt, chunk=128):
    """Step all but the last token of `prompt` through slot 0, in
    valid-masked chunks of `chunk` (a rolling ring takes at most
    max_cache - window + 1 tokens a step)."""
    stem = np.asarray(prompt[:-1], np.float32)
    for i in range(0, len(stem), chunk):
        part = stem[i:i + chunk]
        x = np.zeros((1, chunk, 1), np.float32)
        x[0, :len(part), 0] = part
        valid = np.zeros((1, chunk), np.float32)
        valid[0, :len(part)] = 1.0
        _, carries = net.session_step(x, carries, valid=valid)
    return carries


def teacher_forced_gap(net, prompt, kv_dtype, page_len=None, steps=8):
    """JAX's contract for quantized KV (`tests/test_kv_quant.py:112-124`):
    one native and one quantized carry of the same weights take the same
    prompt, then the same `steps` tokens (the native stream's, so that a
    flipped argmax cannot make the inputs part); returns the largest
    difference of their output probabilities over those steps."""
    carries = {}
    for kd in ("native", kv_dtype):
        c = net.session_carries(1, kv_dtype=kd, page_len=page_len)
        for layer in c.values():
            if "page_table" in layer.get("attn", {}):
                npg = layer["attn"]["page_table"].shape[1]
                layer["attn"]["page_table"][0] = torch.arange(npg)
        carries[kd] = prefill_slot0(net, c, prompt)
    tok, gap = int(prompt[-1]), 0.0
    for _ in range(steps):
        probs = {}
        for kd in carries:
            out, carries[kd] = net.session_step(
                np.full((1, 1, 1), tok, np.float32), carries[kd])
            probs[kd] = out[0, -1].float()
        gap = max(gap, (probs[kv_dtype] - probs["native"]).abs().max()
                  .item())
        tok = int(torch.argmax(probs["native"]))
    return gap


def path_q(native_a, native_b, tol=0.02):
    """Quantized-KV decode serving through `DecodeSessionManager(...,
    kv_dtype=...)`: path_a's net with int8 pages (B6q on every decode
    step) and path_b's ring with e4m3, then int8 codes (B5q), each a
    wave of the native path's own prompts. Each wave is held to JAX's
    contract for quantized KV (`teacher_forced_gap` within `tol`); the
    share of greedy tokens equal to the native wave's is information
    only."""
    greedy = [True] * 6 + [False] * 2
    waves = [("path_q_a_int8", "paged_decode_attention_q", "int8",
              lambda: build_net("cuda", num_blocks=6, seed=7), native_a, 64,
              128),
             ("path_q_b_fp8", "banded_decode_attention_q", "fp8",
              lambda: build_path_b_net("cuda"), native_b, 128, None),
             ("path_q_b_int8", "banded_decode_attention_q", "int8",
              lambda: build_path_b_net("cuda"), native_b, 128, None)]
    rows = []
    for name, kernel, kv, build, (prompts, native), new, page_len in waves:
        net = build()
        (streams,), row = drive_path(net, name, kernel, [prompts], greedy,
                                     new, slots=8, chunk=128, k=8,
                                     kv_dtype=kv)
        native_kernel = kernel[:-2]
        check(row["launches"][native_kernel] == 0,
              f"{name}: the native {native_kernel} ran on a quantized pool")
        check(row["kv_dtype"]["kind"] == row["slots"]["kv_dtype"] == kv,
              f"{name}: pool holds {row['slots']['kv_dtype']}, asked {kv}")
        gap = teacher_forced_gap(net, prompts[0], kv, page_len)
        check(gap <= tol, f"{name}: quantized probabilities differ from the "
              f"native pool's by {gap} (tolerance {tol})")
        same = [a == b for s, n, g in zip(streams, native, greedy) if g
                for a, b in zip(s, n)]
        row.update(teacher_forced_max_prob_gap=gap, tol=tol,
                   greedy_tokens_equal_native_share=sum(same) / len(same))
        emit(row)
        rows.append(row)
        del net
    return rows


# ------------------------------------------ HTTP front, speculative decoding
HTTP_TIMEOUT = 120


def http_call(port, path, body=None, headers=None):
    """(status, content type, parsed JSON or raw bytes) of one request
    to the server on 127.0.0.1."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            status, ctype, raw = r.status, r.headers.get("Content-Type"), \
                r.read()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers.get("Content-Type"), e.read()
    if ctype == "application/json":
        raw = json.loads(raw)
    return status, ctype, raw


class SseClient:
    """One streamed POST /generate on a thread of its own: its frames,
    the host time each arrived at, and the error that ended it if any."""

    def __init__(self, port, prompt, max_tokens, **kw):
        import threading

        self.body = {"prompt_ids": [int(t) for t in prompt],
                     "max_tokens": max_tokens, "greedy": True, **kw}
        self.port = port
        self.frames, self.times = [], []
        self.error = None
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import urllib.request

        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{self.port}/generate",
                data=json.dumps(self.body).encode())
            with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
                for line in r:
                    if line.startswith(b"data: "):
                        self.frames.append(json.loads(line[6:]))
                        self.times.append(time.perf_counter())
        except Exception as e:          # reported by result()
            self.error = e

    def tokens(self):
        return [f["token"] for f in self.frames if "token" in f]

    def result(self):
        """Wait for the stream's end; returns its tokens, or fails."""
        self.thread.join(HTTP_TIMEOUT)
        check(not self.thread.is_alive(), "an SSE stream hung")
        check(self.error is None, f"an SSE stream failed: {self.error!r}")
        last = self.frames[-1] if self.frames else {}
        check(last.get("outcome") == "completed",
              f"a stream ended with {last}")
        toks = self.tokens()
        check(len(toks) == self.body["max_tokens"],
              f"a stream gave {len(toks)} of {self.body['max_tokens']}")
        return toks

    def ttft_ms(self):
        first = next(t for f, t in zip(self.frames, self.times)
                     if "token" in f)
        return (first - self.t0) * 1e3


def wait_first_tokens(clients, timeout=HTTP_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not all(c.tokens() for c in clients):
        check(time.monotonic() < deadline, "no stream got its first token")
        check(all(c.error is None for c in clients),
              f"a stream failed: {[c.error for c in clients]}")
        time.sleep(0.002)


def http_wave(port, prompts, max_tokens):
    """Every prompt as one streamed greedy /generate at once, 8 client
    threads; returns the streams and the wave's client-side numbers."""
    t0 = time.perf_counter()
    clients = [SseClient(port, p, max_tokens) for p in prompts]
    streams = [c.result() for c in clients]
    wall = time.perf_counter() - t0
    ttft = [c.ttft_ms() for c in clients]
    n_tok = sum(len(s) for s in streams)
    return streams, {"sessions": len(clients), "new_tokens": n_tok,
                     "wall_s": wall, "tokens_per_s": n_tok / wall,
                     "ttft_ms_p50": pct(ttft, 50),
                     "ttft_ms_p99": pct(ttft, 99)}


def truncated_draft(target, blocks=1):
    """A draft of the target's embedding, positions, first `blocks`
    blocks and output layer, sharing the target's weight tensors."""
    draft = build_net(target.device, num_blocks=blocks, seed=0)
    tl = [l.name for l in target.layers]
    dl = [l.name for l in draft.layers]
    for d, t in zip(dl[:-1], tl):
        draft.params_tree[d] = target.params_tree[t]
    draft.params_tree[dl[-1]] = target.params_tree[tl[-1]]
    return draft


def silence(net, keep=1):
    """Zero the residual write-backs (attn_Wo, attn_b, ffn_w2, ffn_b2) of
    every block after the first `keep`, in place: under pre-norm those
    blocks become identities, so the net computes what a `keep`-block
    truncated draft computes (`bench.py:1228-1262`'s silenced pair)."""
    blocks = [name for name, p in net.params_tree.items()
              if "attn_Wo" in p]
    for name in blocks[keep:]:
        for key in ("attn_Wo", "attn_b", "ffn_w2", "ffn_b2"):
            net.params_tree[name][key].zero_()
    return net


def first_divergence(net, prompt, got, want):
    """Where two greedy streams part: the position and the target's top-
    two probability gap there (teacher-forced on `want`'s prefix)."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    c = net.session_carries(1)
    c = prefill_slot0(net, c, np.concatenate([prompt, want[:i]]))
    last = want[i - 1] if i else prompt[-1]
    out, _ = net.session_step(np.full((1, 1, 1), last, np.float32), c)
    top2 = torch.topk(out[0, -1].float(), 2).values
    return {"position": i, "got": got[i], "want": want[i],
            "top2_gap": float(top2[0] - top2[1])}


def check_streams(net, prompts, got, want, what):
    for p, g, w in zip(prompts, got, want):
        if g != w:
            check(False, f"{what}: a stream diverges: "
                  f"{first_divergence(net, p, g, w)}")


def decode_counts(ba):
    return (dict(ba.LAUNCHES), launches_by_design(ba),
            dict(ba.PLAIN_ON_CUDA))


def check_design_2(name, kernel, launches, by_design, plain):
    check(launches[kernel] > 0, f"{name}: {kernel} was never launched")
    check(by_design[f"{kernel}/split"] == launches[kernel]
          and by_design[f"{kernel}/ffma"] == 0,
          f"{name}: {kernel} not all on design 2: {by_design}")
    check(sum(plain.values()) == 0,
          f"{name}: plain versions ran on CUDA tensors: {plain}")


@contextlib.contextmanager
def uncounted(mod):
    """Launches inside are a yardstick's, not the path's: every count of
    kernel module `mod` is put back as it was on the way out."""
    saved = [(d, dict(d)) for d in (
        getattr(mod, n) for n in ("LAUNCHES", "LAUNCHES_BY_DESIGN",
                                  "PLAIN_ON_CUDA") if hasattr(mod, n))]
    try:
        yield
    finally:
        for d, was in saved:
            d.clear()
            d.update(was)


def padded_output_cost(srv, net, rng, rows=9, reps=3):
    """What the registry's bucket padding costs `/output`: `rows` rows
    through the deployed runner (padded to the next bucket, 32 for 9)
    against `net.output` of exactly those rows (a yardstick: its B3a
    launches are not counted), each to host numpy, best of `reps` wall
    times after one untimed call; the two must agree within 1e-5."""
    from deeplearning4j_tpu_torch.ops import attention as fa

    runner = srv.registry.get("default").runner
    x = rng.integers(0, 256, (rows, net.conf.input_type.timesteps, 1)
                     ).astype(np.float32)

    def exact():
        with torch.no_grad(), uncounted(fa):
            return net.output(x).float().cpu().numpy()

    out = {"rows": rows, "bucket": runner._bucket(rows)}
    got = {}
    for name, fn in (("padded", lambda: runner.run_batch(x)),
                     ("exact", exact)):
        got[name] = fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms"] = min(times)
    err = float(np.abs(got["padded"] - got["exact"]).max())
    check(err <= 1e-5, f"path_h: the padded /output batch differs from "
          f"the exact one by {err}")
    out["max_abs_err"] = err
    out["padded_over_exact"] = out["padded_ms"] / out["exact_ms"]
    return out


def path_h(prompts, max_new=64, long_prompt=128, long_new=1900,
           after_new=512):
    """The HTTP front and hot-swap at Path A's width: Path A's 8 cold
    1024-token prompts through the direct `DecodeSessionManager` (the
    reference and the yardstick), then through `InferenceServer` on
    127.0.0.1 by 8 client threads as SSE streams, token for token equal;
    `/metrics`' decode block reconciles with the clients; `/models`,
    `/healthz`, a "stream": false request and `POST /output` of a batch
    of 8 (within 1e-5 of `net.output`); then `deploy()` of another seed
    while 4 long streams run (all complete; a stream opened after it
    equals the new net's direct stream) and of a candidate with 2 KV
    heads, which rolls back while 2 streams run. The 4 streams live across
    the flip take the prompts' first `long_prompt` tokens and `long_new`
    new ones, so that they outlast the candidate's warm-up. B6 carries
    every decode step, all on design 2; B3a the full forwards of
    `/output` and of the deploy warm-ups (its count runs from the
    server's start to its stop). A batch of 9 rows, which the registry
    pads to its bucket of 32, is timed against `net.output` of the 9."""
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.serving import (
        DeployRolledBackError, InferenceServer,
    )

    rng = np.random.default_rng(15)
    net = build_net("cuda", num_blocks=6, seed=7)
    registry, sched, mgr = control_plane(net, slots=8, chunk=128, k=8)
    try:
        direct, dwave = serve_wave(mgr, prompts, [True] * 8, max_new, 256)
    finally:
        sched.shutdown()
        registry.close()
    x = rng.integers(0, 256, (8, net.conf.input_type.timesteps, 1)
                     ).astype(np.float32)
    want = net.output(x).cpu().numpy()
    # B3a carries /output's and the deploy warm-ups' full forwards: its
    # count runs from the server's start to its stop
    torch.cuda.synchronize()
    fa.reset_counts()
    srv = InferenceServer(net, decode_slots=8, decode_prefill_chunk=128,
                          decode_fused_k=8)
    row = {"phase": "path_h", "kernel": "paged_decode_attention",
           "direct": dwave}
    flips = []
    try:
        port = srv.start()
        # a process's first request pays one-time costs of the HTTP
        # stack: timed apart from the wave
        t0 = time.perf_counter()
        st, _, _ = http_call(port, "/healthz")
        first_ms = (time.perf_counter() - t0) * 1e3
        check(st == 200, f"path_h: /healthz answered {st}")
        torch.cuda.synchronize()
        ba.reset_counts()
        streams, wave = http_wave(port, prompts, max_new)
        wave["first_request_ms"] = first_ms
        check_streams(net, prompts, streams, direct, "path_h HTTP")
        st, _, metrics = http_call(port, "/metrics")
        dec = metrics["decode"]["default"]
        check(st == 200 and dec["tokens_streamed"] == wave["new_tokens"],
              f"path_h: /metrics streamed {dec['tokens_streamed']}, the "
              f"clients got {wave['new_tokens']}")
        wave["itl_ms_p50"] = dec["itl_ms"]["p50"]
        row.update(http=wave, prefix_cache=dec["prefix_cache"],
                   dispatches=dec["dispatches"])
        st_m, _, models = http_call(port, "/models")
        st_h, _, health = http_call(port, "/healthz")
        check(st_m == 200 and models["models"]["default"]["version"] == 1
              and st_h == 200 and health["status"] == "ok",
              f"path_h: /models {models}, /healthz {health}")
        st, _, whole = http_call(port, "/generate", {
            "prompt_ids": prompts[0].tolist(), "max_tokens": 16,
            "greedy": True, "stream": False})
        check(st == 200 and whole["tokens"] == direct[0][:16],
              f"path_h: a \"stream\": false request gave {whole}")
        t0 = time.perf_counter()
        st, _, out = http_call(port, "/output", {"ndarray": x.tolist()})
        out_s = time.perf_counter() - t0
        check(st == 200, f"path_h: /output answered {st}: {out}")
        err = float(np.abs(np.asarray(out["output"], np.float32)
                           - want).max())
        check(err <= 1e-5, f"path_h: /output differs from net.output by "
              f"{err}")
        row["output"] = {"rows": 8, "max_abs_err": err, "wall_s": out_s,
                         "padded": padded_output_cost(srv, net, rng)}

        # hot-swap while streams run
        def probe(phase, name, version, net_):
            if phase == "flipped":
                _, _, s = http_call(port, "/sessions")
                flips.append(s["decode"]["default"]["sessions"]["active"])

        srv.registry.add_deploy_hook("default", probe)
        net2 = build_net("cuda", num_blocks=6, seed=8)
        live = [SseClient(port, p[:long_prompt], long_new)
                for p in prompts[:4]]
        wait_first_tokens(live)
        t0 = time.perf_counter()
        srv.deploy("default", 2, net2)
        deploy_s = time.perf_counter() - t0
        after = [SseClient(port, p, after_new) for p in prompts[4:6]]
        wait_first_tokens(after)
        bad = build_net("cuda", num_blocks=6, seed=9, num_kv_heads=2)
        t0 = time.perf_counter()
        try:
            srv.deploy("default", 3, bad)
            check(False, "path_h: a candidate with 2 KV heads was deployed")
        except DeployRolledBackError as e:
            rollback = {"error": str(e)[:160],
                        "wall_s": time.perf_counter() - t0}
        del bad
        for c in live:
            c.result()
        after_streams = [c.result() for c in after]
        st, _, models = http_call(port, "/models")
        check(models["models"]["default"]["version"] == 2,
              f"path_h: after the swaps /models says {models}")
        check(flips == [len(live)], f"path_h: {flips} sessions were live "
              f"at the flip, want {len(live)}")
        torch.cuda.synchronize()
        launches, by_design, plain = decode_counts(ba)
        g2 = dict(net2._graphs.stats.get("decode_window", {}))
    finally:
        srv.stop()
    torch.cuda.synchronize()
    flash, flash_by_design = dict(fa.LAUNCHES), launches_by_design(fa)
    registry, sched, mgr = control_plane(net2, slots=8, chunk=128, k=8)
    try:
        want, _ = serve_wave(mgr, prompts[4:6], [True] * 2, after_new, 256)
    finally:
        sched.shutdown()
        registry.close()
    check_streams(net2, prompts[4:6], after_streams, want,
                  "path_h after deploy()")
    check_design_2("path_h", "paged_decode_attention", launches, by_design,
                   plain)
    check(flash["flash_attention_fwd"] > 0,
          "path_h: /output and the warm-ups never launched B3a")
    # float32 at Dh 64: every B3a launch on design 3
    fwd_design = flash_want(torch.float32, 64, "flash_attention_fwd")
    check(flash_by_design[f"flash_attention_fwd/{fwd_design}"]
          == flash["flash_attention_fwd"],
          f"path_h: B3a not all on {fwd_design}: {flash_by_design}")
    row.update(launches=launches, launches_by_design=by_design,
               plain_on_cuda=plain, flash_launches=flash,
               flash_launches_by_design=flash_by_design,
               streams_equal_direct=True,
               hot_swap={"deploy_s": deploy_s, "live_at_flip": flips[0],
                         "live_tokens": long_new, "after_tokens": after_new,
                         "after_equal_v2_direct": True,
                         "v2_window_graphs": g2, "rollback": rollback})
    emit(row)
    return row, direct


def spec_wave(net, draft, prompts, max_new, *, kv_dtype=None):
    """A greedy wave through a speculating manager (spec_k 8); returns the
    streams, the wave's numbers and the manager's snapshot."""
    registry, sched, mgr = control_plane(net, slots=8, chunk=128, k=8,
                                         kv_dtype=kv_dtype, draft=draft,
                                         spec_k=8)
    try:
        check(mgr.spec_enabled, f"spec decoding is off: {mgr._spec_reason}")
        streams, wave = serve_wave(mgr, prompts, [True] * len(prompts),
                                   max_new, 256)
        return streams, wave, mgr.snapshot()
    finally:
        sched.shutdown()
        registry.close()


def spec_window_rows(net, draft, prompts, k=8, windows=3):
    """`windows` propose + verify windows over freshly prefilled slot
    pools, with the manager's bookkeeping: the packed rows and draft
    tokens of each."""
    S = len(prompts)
    stem = np.stack([p[:-1] for p in prompts]).astype(np.float32)[:, :, None]
    val = np.ones(stem.shape[:2], np.float32)
    tc, dc = net.session_carries(S), draft.session_carries(S)
    _, tc = net.session_step(stem, tc, active=np.ones(S, bool), valid=val)
    _, dc = draft.session_step(stem, dc, active=np.ones(S, bool), valid=val)
    tok0 = np.array([p[-1] for p in prompts], np.int64)
    rew, ptk = np.zeros(S, np.int32), np.zeros(S, np.int32)
    pvl, offs = np.zeros(S, bool), np.zeros(S, np.int32)
    knobs = dict(temperature=np.ones(S, np.float32),
                 top_k=np.full(S, 256, np.int32),
                 top_p=np.ones(S, np.float32), greedy=np.ones(S, bool),
                 keys=np.zeros((S, 2), np.uint32))
    rows = []
    for _ in range(windows):
        d_t, d_p, dc = draft.session_propose_window(
            tok0, dc, active=np.ones(S, bool), k=k, rewind=rew,
            pre_tokens=ptk, pre_valid=pvl, offsets=offs, **knobs)
        packed, tc = net.session_verify_window(
            tok0, tc, active=np.ones(S, bool), k=k, draft_tokens=d_t,
            draft_probs=d_p, offsets=offs, budgets=np.full(S, 64, np.int32),
            eos_ids=np.full(S, -1, np.int32), **knobs)
        ph = packed.cpu().numpy()
        rows.append((ph, d_t.cpu().numpy(), d_p.cpu()))
        n = ph[:, 0]
        tok0 = ph[np.arange(S), 2 + n].astype(np.int64)
        rew = np.maximum(k - n, 0).astype(np.int32)
        ptk, pvl = ph[:, 2].astype(np.int32), n == k + 1
        offs = (offs + n).astype(np.int32)
    return rows


def spec_graph_counts(net, draft):
    return {kind: {c: n._graphs.stats.get(kind, {}).get(c, 0)
                   for c in ("replays", "eager", "captures")}
            for kind, n in (("propose_window", draft),
                            ("verify_window", net))}


def path_s(prompts, plain, http_plain, max_new=64):
    """Speculative decoding at Path A's width: the target is Path A's net,
    the draft its embedding, first block and output layer sharing the
    target's weights (spec_k 8). Path A's 8 prompts as streamed greedy
    /generate requests to `InferenceServer(net, decode_slots=8,
    decode_draft_net=draft, decode_spec_k=8)`: every stream equals the
    non-spec fused decode's (`plain`, `path_h`'s direct wave); the same
    wave with the windows eager (`cuda_graphs` off), and 3 windows'
    packed rows graphed against eager; the silenced pair (blocks 2-6
    identities: the target computes what the draft computes), greedy
    acceptance at least 0.85, and a lane whose EOS falls inside a window
    stops AT it; the int8 leg (B5q) against non-spec int8, and the
    silenced pair again at int8, acceptance at least 0.85 (a wrong B5q
    draft step lowers acceptance and nothing else). B5 carries the
    draft's steps (B5q on the int8 legs), all on design 2."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.serving import InferenceServer

    net = build_net("cuda", num_blocks=6, seed=7)
    draft = truncated_draft(net)
    srv = InferenceServer(net, decode_slots=8, decode_prefill_chunk=128,
                          decode_draft_net=draft, decode_spec_k=8)
    row = {"phase": "path_s", "kernel": "banded_decode_attention",
           "spec_k": 8, "draft_blocks": 1, "target_blocks": 6}
    try:
        port = srv.start()
        before = spec_graph_counts(net, draft)
        torch.cuda.synchronize()
        ba.reset_counts()
        streams, wave = http_wave(port, prompts, max_new)
        torch.cuda.synchronize()
        launches, by_design, plain_cuda = decode_counts(ba)
        _, _, metrics = http_call(port, "/metrics")
    finally:
        srv.stop()
    dec = metrics["decode"]["default"]
    graphs = {kind: {c: v - before[kind][c] for c, v in counts.items()}
              for kind, counts in spec_graph_counts(net, draft).items()}
    check_streams(net, prompts, streams, plain, "path_s spec vs plain")
    check_design_2("path_s", "banded_decode_attention", launches, by_design,
                   plain_cuda)
    check(launches["paged_decode_attention"] == 0,
          "path_s: a speculating target ran on the paged pool")
    windows = dec["dispatches"]["windows"]
    for kind, g in graphs.items():
        check(g["replays"] == windows and g["eager"] == 0,
              f"path_s: {windows} windows, {kind} graph counts {g}")
    wave["itl_ms_p50"] = dec["itl_ms"]["p50"]
    row.update(http=wave, launches=launches, launches_by_design=by_design,
               plain_on_cuda=plain_cuda, spec_decode=dec["spec_decode"],
               dispatches=dec["dispatches"], window_graph_counts=graphs,
               tokens_per_s_vs_plain_http=wave["tokens_per_s"]
               / http_plain["tokens_per_s"],
               streams_equal_plain=True)

    # the same windows eagerly: streams and packed rows
    graphed_rows = spec_window_rows(net, draft, prompts)
    net.cuda_graphs = draft.cuda_graphs = False
    try:
        eager_rows = spec_window_rows(net, draft, prompts)
        eager, ewave, _ = spec_wave(net, draft, prompts, max_new)
    finally:
        net.cuda_graphs = draft.cuda_graphs = True
    for (gp, gt, gq), (ep, et, eq) in zip(graphed_rows, eager_rows):
        check(np.array_equal(gp, ep) and np.array_equal(gt, et)
              and torch.equal(gq, eq),
              "path_s: graphed windows' packed rows differ from eager ones")
    check(eager == streams, "path_s: the eager windows' streams differ")
    row["eager"] = {"tokens_per_s": ewave["tokens_per_s"],
                    "packed_rows_equal": True, "streams_equal": True}
    del draft

    # the silenced pair: full acceptance and the bonus token; EOS
    snet = silence(build_net("cuda", num_blocks=6, seed=7))
    sdraft = truncated_draft(snet)
    ba.reset_counts()
    sil, swave, ssnap = spec_wave(snet, sdraft, prompts, max_new)
    launches_sil = dict(ba.LAUNCHES)
    acc = ssnap["spec_decode"]["acceptance_rate"]
    check(acc is not None and acc >= 0.85,
          f"path_s: the silenced pair accepts {acc} of its drafts")
    firsts = [(lane, i) for lane, st in enumerate(sil)
              for i in range(1, max_new - 1)
              if st[i] not in st[:i] and i % 9 != 8]
    check(bool(firsts), f"path_s: silenced streams too repetitive: {sil}")
    lane, i = firsts[0]
    registry, sched, mgr = control_plane(snet, slots=8, chunk=128, k=8,
                                         draft=sdraft, spec_k=8)
    try:
        got = mgr.open_session(prompts[lane], max_tokens=max_new,
                               greedy=True, eos_id=sil[lane][i]).result(
                                   timeout=HTTP_TIMEOUT)
    finally:
        sched.shutdown()
        registry.close()
    check(got == sil[lane][:i + 1], f"path_s: a lane did not stop AT its "
          f"EOS {sil[lane][i]} (index {i}): {got}")
    row["silenced"] = {"acceptance_rate": acc,
                       "spec_decode": ssnap["spec_decode"],
                       "tokens_per_s": swave["tokens_per_s"],
                       "launches": launches_sil["banded_decode_attention"],
                       "eos": {"lane": lane, "index": i,
                               "stream": got}}

    # the int8 leg: spec against non-spec, both from int8 caches
    draft = truncated_draft(net)
    ba.reset_counts()
    q_spec, qwave, qsnap = spec_wave(net, draft, prompts, max_new,
                                     kv_dtype="int8")
    q_launches, q_by_design, q_plain = decode_counts(ba)
    registry, sched, mgr = control_plane(net, slots=8, chunk=128, k=8,
                                         kv_dtype="int8")
    try:
        q_ref, q_ref_wave = serve_wave(mgr, prompts, [True] * 8, max_new,
                                       256)
    finally:
        sched.shutdown()
        registry.close()
    check_design_2("path_s int8", "banded_decode_attention_q", q_launches,
                   q_by_design, q_plain)
    check(q_launches["banded_decode_attention"] == 0,
          "path_s int8: the native B5 ran on an int8 pool")
    check_streams(net, prompts, q_spec, q_ref, "path_s int8 spec vs plain")
    row["int8"] = {"launches": q_launches["banded_decode_attention_q"],
                   "launches_by_design": q_by_design,
                   "spec_decode": qsnap["spec_decode"],
                   "tokens_per_s": qwave["tokens_per_s"],
                   "plain_tokens_per_s": q_ref_wave["tokens_per_s"],
                   "streams_equal_plain": True}
    del draft

    # the silenced pair at int8: the target's tokens come from its dense
    # verify chunk, so only the acceptance floor holds B5q's draft steps
    ba.reset_counts()
    _, sqwave, sqsnap = spec_wave(snet, sdraft, prompts, max_new,
                                  kv_dtype="int8")
    sq_launches, sq_by_design, sq_plain = decode_counts(ba)
    check_design_2("path_s silenced int8", "banded_decode_attention_q",
                   sq_launches, sq_by_design, sq_plain)
    acc = sqsnap["spec_decode"]["acceptance_rate"]
    check(acc is not None and acc >= 0.85,
          f"path_s: the silenced pair at int8 accepts {acc} of its drafts")
    row["silenced_int8"] = {
        "acceptance_rate": acc, "spec_decode": sqsnap["spec_decode"],
        "tokens_per_s": sqwave["tokens_per_s"],
        "launches": sq_launches["banded_decode_attention_q"]}
    del snet, sdraft
    emit(row)
    return row


# ------------------------------------------------------ training phases
def lm_batches(rng, n, batch, t, vocab=256):
    """`n` fixed DataSets of random tokens [batch, t, 1] with next-token
    one-hot labels (the last position's target is random too)."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, t + 1))
        out.append(DataSet(toks[:, :t, None].astype(np.float32),
                           eye[toks[:, 1:]]))
    return out


def kernel_modules():
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.ops import lstm as lk

    return (fa, fu, ba, lk, cf)


def reset_all_counts():
    for mod in kernel_modules():
        mod.reset_counts()


def read_all_counts():
    """(launches, plain calls on CUDA tensors) of every kernel module."""
    launches, plain = {}, {}
    for mod in kernel_modules():
        launches.update(mod.LAUNCHES)
        plain.update({f"{mod.__name__.rsplit('.', 1)[1]}.{k}": v
                      for k, v in mod.PLAIN_ON_CUDA.items()})
    return launches, plain


def timed_fit(name, net, batches, epochs, tokens_per_step, unit="tokens",
              loss_must_fall=True, per_epoch=None, k=1):
    """`net.fit(batches, epochs, steps_per_dispatch=k)` with every launch
    count zeroed just before and read just after. Step times come from
    CUDA events recorded after each step is enqueued (at K > 1 a window's
    K steps are enqueued at once, so a step's time is its window's over
    K), beside the host's time fetching each step's batch (`etl_ms`, the
    executor's); every step (K 1) or window (K > 1) after the first runs
    with host syncs made errors; the losses stay on the device until the
    fit has returned. Checks the step count, finite losses and (unless
    `loss_must_fall` is false) a falling epoch mean loss; returns the
    measurements common to the training paths, the rate counted in
    `unit` (`tokens_per_step` of them a step) over steps 3-12 (K 1) and
    over steps 5-12 (any K: windows 2-3 at K 4), and the net's graph
    windows and eager steps. `batches` is a list of DataSets or an
    iterator of `per_epoch` batches an epoch."""
    from deeplearning4j_tpu_torch.optim.listeners import TrainingListener

    class Clock(TrainingListener):
        def __init__(self):
            self.events, self.losses, self.etl = [], [], []

        def _mark(self):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

        def on_fit_start(self, model):
            self._mark()

        def set_etl_time(self, ms):
            self.etl.append(ms)

        def iteration_done(self, model, iteration, epoch, score):
            self._mark()
            self.losses.append(score)      # a device tensor: not read here

    clock = Clock()
    net.listeners.append(clock)

    def guarded(dispatch):
        def run(arg):
            # every dispatch after the first: any host sync inside raises
            if net.iteration >= 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(arg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    net._fit_batch = guarded(net._fit_batch)
    net._fused_dispatch = guarded(net._fused_dispatch)
    stats0 = dict(net.fit_stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    net.fit(batches, epochs=epochs, steps_per_dispatch=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_on_cuda = read_all_counts()
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    b1_by_design = launches_by_design(fu)
    for kernel in ("adam_update", "nesterov_update"):
        check(sum(b1_by_design[f"{kernel}/{d}"] for d in fu.DESIGNS)
              == launches[kernel],
              f"{name}: {kernel} launches by design {b1_by_design} do not "
              f"add up to {launches[kernel]}")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in clock.losses]       # read after the steps
    steps = len(losses)
    ev = clock.events
    step_ms = [ev[i].elapsed_time(ev[i + k]) / k
               for i in range(0, steps - k + 1, k)]
    per_epoch = per_epoch or len(batches)
    epoch_loss = [float(np.mean(losses[i:i + per_epoch]))
                  for i in range(0, steps, per_epoch)]
    check(steps == epochs * per_epoch, f"{name}: {steps} steps ran")
    check(all(np.isfinite(losses)), f"{name}: losses {losses}")
    if loss_must_fall:
        check(epoch_loss[-1] < epoch_loss[0],
              f"{name}: mean loss did not fall: {epoch_loss}")
    check(sum(plain_on_cuda.values()) == 0,
          f"{name}: plain versions ran on CUDA tensors: {plain_on_cuda}")
    graphs = net._graphs.stats.get("fit", {})
    rates = {}
    if steps > 4:
        rates[f"{unit}_per_s_steps_5_12"] = (
            (steps - 4) * tokens_per_step
            / (ev[4].elapsed_time(ev[steps]) / 1e3))
    if k == 1 and steps > 2:
        rates[f"{unit}_per_s_steps_3_12"] = (
            (steps - 2) * tokens_per_step
            / (ev[2].elapsed_time(ev[steps]) / 1e3))
    return {"steps": steps, "steps_per_dispatch": k, **rates,
            "step_ms_p50": float(np.median(step_ms[1:])),
            "step_ms_max": max(step_ms[1:]), "step_ms_first": step_ms[0],
            "step_ms": step_ms, "etl_ms": clock.etl, "wall_s": wall,
            "max_memory_allocated_bytes": peak,
            "epoch_mean_loss": epoch_loss, "losses": losses,
            "launches": launches, "plain_on_cuda": plain_on_cuda,
            "b1_launches_by_design": b1_by_design,
            **{c: net.fit_stats[c] - stats0[c] for c in stats0},
            "graph_captures": graphs.get("captures", 0),
            "capture_ms": graphs.get("capture_ms", 0.0),
            "sync_debug_mode": "error after the first "
                               + ("step" if k == 1 else "window")}


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq")


def path_t(rng, epochs=3, dtype="float32"):
    """Full width training: 6 blocks, T 2048, batch 8, the zoo's default
    Adam(3e-4), 4 fixed batches x 3 epochs = 12 steps through `net.fit`
    (`timed_fit`). float32 (`path_t`): B3a-c on design 3 (3xTF32 on the
    tensor cores); bfloat16 (`path_t_bf16`,
    `bench.py`'s dtype for this model: BENCH_DTYPE's default,
    `bench.py:586`): B3a-c on design 2, the tensor cores."""
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    name = {"float32": "path_t", "bfloat16": "path_t_bf16"}[dtype]
    B, T, blocks = 8, 2048, 6
    net = build_net("cuda", num_blocks=blocks, seed=5, dtype=dtype)
    check(net.conf.updater == Adam(3e-4),
          f"{name}: zoo updater is {net.conf.updater}, not Adam(3e-4)")
    check(str(net.dtype) == f"torch.{dtype}",
          f"{name}: the net computes in {net.dtype}, not {dtype}")
    fit = timed_fit(name, net, lm_batches(rng, 4, B, T), epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    for kernel in FLASH_KERNELS:
        check(launches[kernel] == blocks * steps,
              f"{name}: {kernel} launched {launches[kernel]} times, want "
              f"{blocks} a step x {steps}")
    check(launches["adam_update"] == steps,
          f"{name}: adam_update launched {launches['adam_update']} times, "
          f"want one a step x {steps}")
    by_design = launches_by_design(fa)
    designs = {kernel: flash_want(getattr(torch, dtype), 64, kernel)
               for kernel in FLASH_KERNELS}
    for kernel, design in designs.items():
        check(by_design[f"{kernel}/{design}"] == blocks * steps
              and all(by_design[f"{kernel}/{d}"] == 0
                      for d in fa.DESIGNS if d != design),
              f"{name}: {kernel} not all on {design}: {by_design}")
    row = {"phase": name, "model": "TextGenerationTransformer",
           "d_model": 512, "heads": 8, "blocks": blocks, "T": T,
           "batch": B, "dtype": dtype, "updater": str(net.conf.updater),
           **fit, "flash_designs": designs, "launches_by_design": by_design}
    emit(row)
    del net
    torch.cuda.empty_cache()
    return row


def leaves_of(net):
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    return [t.detach().clone() for tree in (
        net.params_tree, net.updater_state, net.state_tree)
        for t in tree_leaves(tree)]


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (warning where a call has none)
    without the NaN fill of new tensors: `index_select`'s backward, an
    `index_add_` by atomics otherwise (the zoo transformer's embedding),
    then sums in a fixed order."""
    import torch.utils.deterministic as td

    fill = td.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    td.fill_uninitialized_memory = False
    try:
        yield
    finally:
        td.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(False)


def k_parity(name, make_net, make_batches, tokens_per_step, kernels,
             unit="tokens", per_epoch=None, epochs=3):
    """`name`'s 12 steps at K 1, again at K 1, then at K 4 (`timed_fit`),
    each a fresh net of the same seeded weights on the same batches, on
    PyTorch's deterministic algorithms (`deterministic`): the
    rate over steps 5-12, step ms, peak memory, graph windows and eager
    steps of each. After the steps, parameters, optimizer state, running
    statistics and losses at K 4 must equal K 1's bit for bit; if the two
    K 1 runs already differ, K 4 is held to their spread instead (the
    largest difference of any leaf or loss between them), never looser.
    `kernels` launch at K 4 as often as at K 1."""
    runs = {}
    for tag, k in (("k1", 1), ("k1_again", 1), ("k4", 4)):
        net = make_net()
        with deterministic():
            fit = timed_fit(f"{name} {tag}", net, make_batches(), epochs,
                            tokens_per_step, unit=unit, per_epoch=per_epoch,
                            k=k)
        runs[tag] = (fit, leaves_of(net))
        del net
        torch.cuda.empty_cache()

    def gap(a, b):
        (fa, la), (fb, lb) = runs[a], runs[b]
        return max([max(abs(x - y) for x, y in zip(fa["losses"],
                                                   fb["losses"]))]
                   + [(x.float() - y.float()).abs().max().item()
                      for x, y in zip(la, lb)])

    spread, k4_gap = gap("k1", "k1_again"), gap("k4", "k1")
    check(k4_gap <= spread, f"{name}: K 4 differs from K 1 by {k4_gap}, "
          f"two K 1 runs by {spread}")
    k1, k4 = runs["k1"][0], runs["k4"][0]
    for kernel in kernels:
        check(k4["launches"][kernel] == k1["launches"][kernel],
              f"{name}: {kernel} launched {k4['launches'][kernel]} times at "
              f"K 4, {k1['launches'][kernel]} at K 1")
    check(k4["graph_windows"] == 2 and k4["eager_steps"] == 4
          and k4["graph_captures"] == 1,
          f"{name}: K 4 ran {k4['graph_windows']} graph windows, "
          f"{k4['eager_steps']} eager steps")
    keep = ("steps", f"{unit}_per_s_steps_5_12", "step_ms_p50",
            "step_ms_max", "step_ms_first", "step_ms", "etl_ms",
            "max_memory_allocated_bytes", "graph_windows", "eager_steps",
            "graph_captures", "capture_ms", "epoch_mean_loss")
    row = {"phase": f"{name}_k", "k1_runs_spread": spread,
           "k4_vs_k1_max_abs": k4_gap, "k4_bit_equal_k1": k4_gap == 0.0,
           "k4_vs_k1_again_max_abs": gap("k4", "k1_again"),
           "launches": {kernel: k4["launches"][kernel] for kernel in kernels},
           **{tag: {c: f[c] for c in keep} for tag, (f, _) in runs.items()}}
    row["k1"][f"{unit}_per_s_steps_3_12"] = k1[f"{unit}_per_s_steps_3_12"]
    emit(row)
    return row


def train_parity(rng, name="train_parity", kernel="flash_attention_fwd",
                 steps=2, tol_loss=1e-5, tol_param=1e-5, rtol_param=0.0,
                 tol_update_gap=None, dtype="float32", build=None,
                 batch=None, **net_kw):
    """The port's train step on the card against the CPU: a 2-block model
    at T 256, batch 2, the same seed (so the same weights) and batch,
    `steps` Adam steps in `dtype`; `kernel` must have run twice a step on
    the card (in bfloat16 B3b and B3c on design 2). `build(device)` and
    `batch` replace the model and the batch (`lstm_parity_bf16`). Adam's ε is 1e-3 here so that
    a near-zero gradient's first update (≈ lr·sign(g) at ε 1e-8) cannot
    flip with the last bits of a sum; losses agree within `tol_loss`
    relative and every parameter within `tol_param` absolute plus
    `rtol_param` of the larger of its two values. The row also reads how
    far the card's updates (final less initial parameters) lie from the
    CPU's, as a share of the CPU's: over the whole tree
    (`update_gap_tree`) and the largest over the leaves
    (`update_gap_leaf_max`), which must stay within `tol_update_gap`
    where that is given."""
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, tree_leaves

    if batch is None:
        batch = lm_batches(rng, 1, 2, 256)
    if build is None:
        def build(d):
            return build_net(d, num_blocks=2, seed=17, t=256, dtype=dtype,
                             updater=Adam(3e-4, epsilon=1e-3), **net_kw)
    losses, leaves, moves = {}, {}, {}
    for d in ("cuda", "cpu"):
        net = build(d)
        start = [p.double().cpu() for p in tree_leaves(net.params_tree)]
        scores = CollectScoresIterationListener()
        net.listeners.append(scores)
        reset_all_counts()
        net.fit(batch, epochs=steps)
        if d == "cuda":
            launches, _ = read_all_counts()
            check(launches[kernel] == 2 * steps,
                  f"{name}: {kernel} launched {launches[kernel]} times, "
                  f"want 2 layers x {steps} steps")
            if kernel == "flash_attention_fwd":
                # bfloat16: B3a-c on design 2; float32: on design 3
                by_design = launches_by_design(fa)
                want = {k: flash_want(getattr(torch, dtype), 64, k)
                        for k in FLASH_KERNELS}
                check(all(by_design[f"{k}/{d}"] == 2 * steps
                          for k, d in want.items()),
                      f"{name}: B3a-c not on {want}: {by_design}")
        losses[d] = [sc for _, sc in scores.scores]
        leaves[d] = [p.float().cpu() for p in tree_leaves(net.params_tree)]
        moves[d] = [p.double() - p0 for p, p0 in zip(leaves[d], start)]
    gaps = [((a - b).norm().item(), b.norm().item())
            for a, b in zip(moves["cuda"], moves["cpu"])]
    gap_tree = (sum(g * g for g, _ in gaps)
                / max(sum(n * n for _, n in gaps), 1e-300)) ** 0.5
    gap_leaf = max(g / n for g, n in gaps if n > 0)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    dp = max((a - b).abs().max().item()
             for a, b in zip(leaves["cuda"], leaves["cpu"]))
    over = sum(int(((a - b).abs() > tol_param
                    + rtol_param * torch.maximum(a.abs(), b.abs())).sum())
               for a, b in zip(leaves["cuda"], leaves["cpu"]))
    check(rel <= tol_loss, f"{name}: losses {losses} differ by {rel} "
          f"relative")
    check(over == 0, f"{name}: {over} parameters differ by more than "
          f"{tol_param} + {rtol_param} of their size (largest {dp})")
    check(tol_update_gap is None or gap_leaf <= tol_update_gap,
          f"{name}: a leaf's update lies {gap_leaf} of its size from the "
          f"CPU's (limit {tol_update_gap})")
    row = {"phase": name, "dtype": dtype, "steps": steps, "losses": losses,
           "loss_rel_err": rel, "tol_loss_rel": tol_loss,
           "max_param_abs_err": dp, "tol_param_abs": tol_param,
           "rtol_param": rtol_param, "params_over_tolerance": over,
           "update_gap_tree": gap_tree, "update_gap_leaf_max": gap_leaf,
           "tol_update_gap": tol_update_gap}
    emit(row)
    return row


# `train_parity` in bfloat16. The card and the CPU round activations at
# other places, so their gradients and Adam's updates differ a little (the
# 1e-5), and each of the two steps stores a parameter to a bf16 step (2^-7
# of it at most), where the two sides may land a step apart: 2^-6 over two
# steps. Sound runs (`tools/torch_parity_faults.py`, three batches, in
# three runs of it): losses up to 1.3e-4 relative apart, no parameter
# past that, each leaf's update within 10.2% of the CPU's. A wrong update
# moves a parameter by about the learning rate, past the per-parameter
# limit wherever |p| < 0.018; the planted faults there (a skipped update,
# a lost dK tile, swapped dQ rows) broke it in 7,956-22,560 parameters,
# and dQ 2^-5 too large, which it let pass, moved a leaf's update by
# 23.4-23.7%, past the 15% update-gap limit.
TRAIN_PARITY_BF16 = dict(tol_loss=1e-3, tol_param=1e-5,
                         rtol_param=2.0 ** -6, tol_update_gap=0.15,
                         dtype="bfloat16")


LLAMA = dict(pos_encoding="rope", norm="rms", ffn_activation="swiglu",
             num_kv_heads=2)


def path_w(rng, epochs=3):
    """Full width training of the sliding-window (Mistral-shaped)
    transformer: 6 Llama blocks (RoPE, RMSNorm, SwiGLU, 2 KV heads under
    8) with window 256, T 2048, batch 8, float32, the zoo's default
    Adam(3e-4), 4 fixed batches x 3 epochs = 12 steps through `net.fit`
    (`timed_fit`): B4 forward in every block, every launch on design 2
    ("folded"), and B1a; then one `output()` (B4 under no_grad, design 2
    too)."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    B, T, blocks = 8, 2048, 6
    net = build_net("cuda", num_blocks=blocks, seed=5, window=256, **LLAMA)
    check(net.conf.updater == Adam(3e-4),
          f"path_w: zoo updater is {net.conf.updater}, not Adam(3e-4)")
    batches = lm_batches(rng, 4, B, T)
    fit = timed_fit("path_w", net, batches, epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    by_design = launches_by_design(ba)
    check(launches["banded_attention"] == blocks * steps,
          f"path_w: banded_attention launched "
          f"{launches['banded_attention']} times, want {blocks} a step x "
          f"{steps}")
    # float32 at Dh 64, G 4: every B4 launch on design 2
    check(by_design["banded_attention/folded"] == blocks * steps
          and by_design["banded_attention/ffma"] == 0,
          f"path_w: B4 not all on design 2: {by_design}")
    check(launches["adam_update"] == steps,
          f"path_w: adam_update launched {launches['adam_update']} times, "
          f"want one a step x {steps}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        check(launches[name] == 0, f"path_w: {name} ran in a windowed model")
    t0 = time.perf_counter()
    probs = net.output(batches[0].features)
    torch.cuda.synchronize()
    output_s = time.perf_counter() - t0
    after, plain = read_all_counts()
    check(tuple(probs.shape) == (B, T, 256), f"path_w: output {probs.shape}")
    check(bool(torch.isfinite(probs).all()), "path_w: output not finite")
    check(float((probs.sum(-1) - 1).abs().max()) < 1e-4,
          "path_w: output rows do not sum to 1")
    out_launches = after["banded_attention"] - launches["banded_attention"]
    check(out_launches == blocks, f"path_w: output() launched B4 "
          f"{out_launches} times, want {blocks}")
    out_by_design = {d: n - by_design[d]
                     for d, n in launches_by_design(ba).items()
                     if d.startswith("banded_attention/")}
    check(out_by_design["banded_attention/folded"] == blocks,
          f"path_w: output()'s B4 not all on design 2: {out_by_design}")
    check(sum(plain.values()) == 0,
          f"path_w: plain versions ran on CUDA tensors: {plain}")
    row = {"phase": "path_w", "model": "TextGenerationTransformer",
           "d_model": 512, "heads": 8, "kv_heads": 2, "window": 256,
           "blocks": blocks, "T": T, "batch": B, "dtype": "float32",
           "updater": str(net.conf.updater), **fit, "output_s": output_s,
           "output_launches": out_launches,
           "launches_by_design": {d: n for d, n in by_design.items()
                                  if d.startswith("banded_attention/")},
           "output_launches_by_design": out_by_design}
    emit(row)
    return row


# ----------------------------------------------------- recurrent phases
def build_lstm_net(device, *, seed, h=512, f=128, classes=64, fused=None,
                   dtype="float32", updater=None):
    """The repo's LSTM bench model: GravesLSTM(h) x 2 + RnnOutputLayer,
    tanh, Nesterovs(0.01, 0.9) (or `updater`), sequences of any length,
    in `dtype`."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or Nesterovs(0.01, 0.9)).activation("tanh")
            .list(GravesLSTM(n_out=h, fused=fused),
                  GravesLSTM(n_out=h, fused=fused),
                  RnnOutputLayer(n_out=classes, activation="softmax"))
            .set_input_type(InputType.recurrent(f)).build())
    return MultiLayerNetwork(dataclasses.replace(conf, dtype=dtype),
                             device=device).init()


def seq_batches(rng, n, batch, t, f, classes, masked=()):
    """`n` fixed DataSets: standard-normal features [batch, t, f], random
    one-hot labels; the batches listed in `masked` carry a features mask
    of ragged lengths in [t/4, t)."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(classes, dtype=np.float32)
    out = []
    for i in range(n):
        x = rng.standard_normal((batch, t, f)).astype(np.float32)
        y = eye[rng.integers(0, classes, (batch, t))]
        fm = None
        if i in masked:
            lens = rng.integers(t // 4, t, batch)
            fm = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        out.append(DataSet(x, y, fm, None))
    return out


def onehot_batches(rng, n, batch, t, vocab):
    """`n` fixed DataSets of random characters, one-hot [batch, t, vocab],
    with next-character labels."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (batch, t + 1))
        out.append(DataSet(eye[ids[:, :t]], eye[ids[:, 1:]]))
    return out


def path_l(rng, epochs=3):
    """Full width LSTM training: GravesLSTM(512) x 2, T 128, batch 64,
    float32, Nesterovs(0.01, 0.9); 4 fixed batches (two masked) x 3
    epochs = 12 steps through `net.fit` (`timed_fit`); B2a on design 2,
    the persistent grid."""
    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    B, T = 64, 128
    net = build_lstm_net("cuda", seed=5)
    check(net.conf.updater == Nesterovs(0.01, 0.9),
          f"path_l: updater is {net.conf.updater}")
    batches = seq_batches(rng, 4, B, T, 128, 64, masked=(1, 3))
    fit = timed_fit("path_l", net, batches, epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    for name in ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights"):
        check(launches[name] == 2 * steps,
              f"path_l: {name} launched {launches[name]} times, want 2 a "
              f"step x {steps}")
    check(launches["nesterov_update"] == steps,
          f"path_l: nesterov_update launched {launches['nesterov_update']} "
          f"times, want one a step x {steps}")
    check(launches["lstm_fwd_inference"] == 0,
          "path_l: the inference kernel ran in a train step")
    by_design = launches_by_design(lk)
    check(by_design["lstm_fwd/persistent"] == 2 * steps
          and by_design["lstm_fwd/cluster"] == 0,
          f"path_l: lstm_fwd not all on design 2: {by_design}")
    check_b2c_design_2("path_l", by_design, 2 * steps)
    row = {"phase": "path_l", "model": "GravesLSTM x 2 + RnnOutputLayer",
           "hidden": 512, "n_in": 128, "classes": 64, "T": T, "batch": B,
           "dtype": "float32", "updater": str(net.conf.updater),
           "masked_batches": 2, **fit, "launches_by_design": by_design}
    emit(row)
    return row


def check_b2c_design_2(name, by_design, launches):
    """Every launch of both B2c kernels ran on design 2: the recurrence
    on "persistent", the weight product on "pipelined"."""
    from deeplearning4j_tpu_torch.ops import lstm as lk

    for kernel, (d1, d2) in lk.B2C_DESIGNS.items():
        check(by_design[f"{kernel}/{d2}"] == launches
              and by_design[f"{kernel}/{d1}"] == 0,
              f"{name}: {kernel} not all {launches} launches on design 2 "
              f"({d2}): {by_design}")


def path_g(rng, calls=200):
    """The zoo LSTM at its own width: tBPTT fit, `output()`, then a
    greedy stepping loop of `calls` `rnn_time_step` calls for 32 streams,
    each fed the one-hot of its last argmax. The loop's tokens are read
    once, after it. The fit's B2a (T 50 chunks) and `output()`'s B2b
    (T 200) run on design 2, the loop's B2b (T 1) on design 1."""
    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    B, T, V = 32, 200, 77
    net = TextGenerationLSTM(input_shape=(T, V), seed=9).init(device="cuda")
    check(net.conf.updater == Adam(1e-3) and net.conf.tbptt_fwd_length == 50,
          f"path_g: zoo updater {net.conf.updater}, tbptt "
          f"{net.conf.tbptt_fwd_length}")
    batches = onehot_batches(rng, 2, B, T, V)
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    net.fit(batches, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches, _ = read_all_counts()
    fit_by_design = launches_by_design(lk)
    chunks = 2 * (T // 50)
    check(fit_by_design["lstm_fwd/persistent"] == 2 * chunks,
          f"path_g: the tBPTT fit's B2a not all on design 2: "
          f"{fit_by_design}")
    check_b2c_design_2("path_g's fit", fit_by_design, 2 * chunks)
    for name in ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights"):
        check(fit_launches[name] == 2 * chunks,
              f"path_g: {name} launched {fit_launches[name]} times in the "
              f"tBPTT fit, want 2 a chunk x {chunks}")
    check(fit_launches["adam_update"] == chunks,
          f"path_g: adam_update launched {fit_launches['adam_update']} "
          f"times, want one a chunk x {chunks}")
    check(net.iteration == 2, f"path_g: {net.iteration} iterations for 2 "
          f"batches")
    check(np.isfinite(net.score_), f"path_g: loss {net.score_}")

    probs = net.output(batches[0].features)
    torch.cuda.synchronize()
    after_output, _ = read_all_counts()
    check(tuple(probs.shape) == (B, T, V), f"path_g: output {probs.shape}")
    check(bool(torch.isfinite(probs).all()), "path_g: output is not finite")
    check(float((probs.sum(-1) - 1).abs().max()) < 1e-4,
          "path_g: output rows do not sum to 1")
    check(after_output["lstm_fwd_inference"] == 2
          and launches_by_design(lk)["lstm_fwd_inference/persistent"] == 2,
          "path_g: output() did not run the inference kernel twice on "
          "design 2")

    eye = torch.eye(V, device=net.device)
    first = torch.as_tensor(rng.integers(0, V, B), device=net.device)

    def stepping():
        """The greedy loop from `first`: (tokens, last rows, loop
        figures, launches, launches by design, plain calls on CUDA
        tensors) of its `calls` calls."""
        net.rnn_clear_previous_state()
        net.rnn_time_step(eye[first])      # warm-up calls, not timed: they
        net.rnn_time_step(eye[first])      # capture both graphs
        net.rnn_clear_previous_state()
        torch.cuda.synchronize()
        reset_all_counts()
        tok, stream, stepped, host_ms = first, [], [], []
        t0 = time.perf_counter()
        for _ in range(calls):
            t1 = time.perf_counter()
            out = net.rnn_time_step(eye[tok])
            tok = torch.argmax(out[:, -1, :], dim=-1)
            stream.append(tok)
            stepped.append(out[:, -1, :])
            host_ms.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches, plain_on_cuda = read_all_counts()
        check(sum(plain_on_cuda.values()) == 0,
              f"path_g: plain versions ran on CUDA tensors: {plain_on_cuda}")
        check(launches["lstm_fwd_inference"] == 2 * calls,
              f"path_g: {launches['lstm_fwd_inference']} inference "
              f"launches in {calls} calls, want 2 a call")
        by_design = launches_by_design(lk)
        check(by_design["lstm_fwd_inference/cluster"] == 2 * calls,
              f"path_g: the stepping loop's B2b not all on design 1: "
              f"{by_design}")
        figures = {"loop_s": loop_s, "tokens_per_s": B * calls / loop_s,
                   "call_ms_p50": float(np.median(host_ms)),
                   "call_ms_p99": float(np.percentile(host_ms, 99))}
        return stream, stepped, figures, launches, by_design, plain_on_cuda

    stream, stepped, graphed, launches, by_design, plain_on_cuda = stepping()
    st = net._graphs.stats["rnn_time_step"]
    check(st["replays"] >= calls and st["captures"] == 2,
          f"path_g: the graphed loop's graph counts {st}")
    graphed["graph_counts"] = dict(st)
    net.cuda_graphs = False
    eager_stream, _, eager, _, _, _ = stepping()
    net.cuda_graphs = True
    toks = torch.stack(stream, dim=1).cpu().numpy()
    check(np.array_equal(toks, torch.stack(eager_stream, dim=1)
                         .cpu().numpy()),
          "path_g: the graphed stepping's tokens differ from the eager "
          "call's")
    check(toks.shape == (B, calls) and toks.min() >= 0 and toks.max() < V,
          "path_g: stepping produced an out-of-vocabulary token")
    # stepping one token at a time with carried state equals `output()`
    # over the same tokens fed at once
    fed = torch.cat([first[:, None], torch.stack(stream, dim=1)[:, :-1]],
                    dim=1)
    whole = net.output(eye[fed])
    step_err = float((whole - torch.stack(stepped, dim=1)).abs().max())
    check(step_err <= 1e-4, f"path_g: stepping differs from output() over "
          f"the same tokens by {step_err}")
    row = {"phase": "path_g", "model": "TextGenerationLSTM", "hidden": 256,
           "vocab": V, "T": T, "batch": B, "tbptt": 50, "dtype": "float32",
           "updater": str(net.conf.updater), "fit_s": fit_s,
           "fit_loss": net.score_, "fit_launches": fit_launches,
           "streams": B, "calls": calls, **graphed, "eager_call": eager,
           "graphed_tokens_equal_eager": True,
           "stepping_vs_output_max_abs_err": step_err,
           "launches": launches, "launches_by_design": by_design,
           "fit_launches_by_design": fit_by_design,
           "plain_on_cuda": plain_on_cuda}
    emit(row)
    return row, batches


def lstm_parity(rng, tol=1e-4):
    """Both recurrent models, 2 layers at full width but T 32 and batch
    4, on the card against the CPU (which runs the plain versions): two
    `fit` steps, then 8 `rnn_time_step` calls. Losses within `tol`
    relative, parameters and step outputs within `tol` absolute. Adam's
    ε is 1e-3 here, as in `train_parity`."""
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, tree_leaves
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    T, B = 32, 4
    models = {
        "lstm_bench": (lambda d: build_lstm_net(d, seed=21),
                       seq_batches(rng, 2, B, T, 128, 64, masked=(1,)),
                       rng.standard_normal((8, B, 128)).astype(np.float32)),
        "text_generation_lstm": (
            lambda d: TextGenerationLSTM(
                input_shape=(T, 77), seed=22,
                updater=Adam(1e-3, epsilon=1e-3)).init(device=d),
            onehot_batches(rng, 2, B, T, 77),
            np.eye(77, dtype=np.float32)[rng.integers(0, 77, (8, B))])}
    row = {"phase": "lstm_parity", "tol": tol, "models": {}}
    for name, (build, batches, steps) in models.items():
        losses, leaves, outs = {}, {}, {}
        for d in ("cuda", "cpu"):
            net = build(d)
            scores = CollectScoresIterationListener()
            net.listeners.append(scores)
            net.fit(batches, epochs=1)
            losses[d] = [sc for _, sc in scores.scores]
            leaves[d] = [p.float().cpu()
                         for p in tree_leaves(net.params_tree)]
            outs[d] = [net.rnn_time_step(x).float().cpu() for x in steps]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        dp = max((a - b).abs().max().item()
                 for a, b in zip(leaves["cuda"], leaves["cpu"]))
        do = max((a - b).abs().max().item()
                 for a, b in zip(outs["cuda"], outs["cpu"]))
        check(rel <= tol, f"lstm_parity {name}: losses {losses} differ by "
              f"{rel} relative")
        check(dp <= tol, f"lstm_parity {name}: parameters differ by {dp}")
        check(do <= tol, f"lstm_parity {name}: step outputs differ by {do}")
        row["models"][name] = {"losses": losses, "loss_rel_err": rel,
                               "max_param_abs_err": dp,
                               "max_step_output_abs_err": do}
    emit(row)
    return row


def path_l_bf16(rng, epochs=3):
    """`path_l` in bfloat16: GravesLSTM(512) x 2, T 128, batch 64, its
    Nesterovs(0.01, 0.9) on bfloat16 leaves, 4 fixed batches (two
    masked) x 3 epochs = 12 steps through `net.fit` (`timed_fit`): B2a
    and B2c in bfloat16 twice a step, the forward, B2c's recurrence
    ("persistent_bf16" both, none on "cluster_bf16") and its weight
    product ("wgmma_bf16") on design 2, no float32 LSTM launch, B1b once
    a step; then `output()`, B2b in bfloat16 twice on
    "persistent_bf16"."""
    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    B, T = 64, 128
    net = build_lstm_net("cuda", seed=5, dtype="bfloat16")
    check(net.conf.updater == Nesterovs(0.01, 0.9)
          and net.dtype == torch.bfloat16,
          f"path_l_bf16: {net.conf.updater}, {net.dtype}")
    batches = seq_batches(rng, 4, B, T, 128, 64, masked=(1, 3))
    fit = timed_fit("path_l_bf16", net, batches, epochs, B * T)
    steps, launches = fit["steps"], fit["launches"]
    for name in ("lstm_fwd_bf16", "lstm_bwd_bf16", "lstm_bwd_weights_bf16"):
        check(launches[name] == 2 * steps,
              f"path_l_bf16: {name} launched {launches[name]} times, want "
              f"2 a step x {steps}")
    check(all(launches[k] == 0 for k in lk.KERNELS)
          and launches["lstm_fwd_inference_bf16"] == 0,
          f"path_l_bf16: a float32 or inference LSTM kernel ran: {launches}")
    check(launches["nesterov_update"] == steps,
          f"path_l_bf16: nesterov_update launched "
          f"{launches['nesterov_update']} times, want one a step")
    by_design = launches_by_design(lk)
    check(by_design["lstm_fwd/persistent_bf16"] == 2 * steps
          and by_design["lstm_bwd/persistent_bf16"] == 2 * steps
          and by_design["lstm_bwd/cluster_bf16"] == 0
          and by_design["lstm_bwd_weights/wgmma_bf16"] == 2 * steps,
          f"path_l_bf16: not on persistent_bf16 (forward and recurrence) "
          f"and wgmma_bf16: {by_design}")
    torch.cuda.synchronize()
    reset_all_counts()
    probs = net.output(batches[0].features)
    torch.cuda.synchronize()
    out_launches, plain = read_all_counts()
    check(probs.dtype == torch.bfloat16 and tuple(probs.shape) == (B, T, 64)
          and bool(torch.isfinite(probs).all()),
          f"path_l_bf16: output {probs.dtype} {tuple(probs.shape)}")
    out_by_design = launches_by_design(lk)
    check(out_launches["lstm_fwd_inference_bf16"] == 2
          and out_by_design["lstm_fwd_inference/persistent_bf16"] == 2
          and sum(plain.values()) == 0,
          f"path_l_bf16: output() launches {out_launches} "
          f"({out_by_design}), plain {plain}")
    row = {"phase": "path_l_bf16",
           "model": "GravesLSTM x 2 + RnnOutputLayer", "hidden": 512,
           "n_in": 128, "classes": 64, "T": T, "batch": B,
           "dtype": "bfloat16", "updater": str(net.conf.updater),
           "masked_batches": 2, **fit, "launches_by_design": by_design,
           "output_launches": {k: v for k, v in out_launches.items()
                               if k.startswith("lstm")},
           "output_launches_by_design": {
               k: v for k, v in out_by_design.items()
               if k.startswith("lstm_fwd_inference/")}}
    emit(row)
    row["launches"] = {**launches, "lstm_fwd_inference_bf16":
                       out_launches["lstm_fwd_inference_bf16"]}
    return row


def lstm_greedy_loop(net, prompts, chunk, max_new):
    """Greedy streams of every prompt at once by `rnn_time_step`
    (`path_g`'s loop): the prompt's stem in the session manager's chunks,
    then one-hot tokens one a call from the last prompt token, each the
    argmax of the last."""
    V = int(net.layers[0].n_in)
    eye = torch.eye(V, device=net.device)
    stems = torch.as_tensor(np.stack([p[:-1] for p in prompts]),
                            device=net.device)
    net.rnn_clear_previous_state()
    for lo in range(0, stems.shape[1], chunk):
        net.rnn_time_step(eye[stems[:, lo:lo + chunk]])
    tok = torch.as_tensor([int(p[-1]) for p in prompts], device=net.device)
    toks = []
    for _ in range(max_new):
        tok = torch.argmax(net.rnn_time_step(eye[tok])[:, -1, :], dim=-1)
        toks.append(tok)
    net.rnn_clear_previous_state()
    return torch.stack(toks, dim=1).cpu().numpy().tolist()


def check_lstm_streams(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            at = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            check(False, f"{what}: stream {i} parts from the reference at "
                  f"token {at} ({g[at]} against {w[at]})")


def path_ls(rng, prompt_len=200, max_new=200, slots=32, chunk=50, k=8):
    """S7, recurrent decode sessions, at the zoo's width:
    `TextGenerationLSTM` (LSTM(256) x 2, 77 characters, one-hot,
    float32) serving `slots` prompts of `prompt_len` characters through
    `DecodeSessionManager` (prefill chunks of `chunk`, windows of K `k`
    as graph replays, `max_new` greedy tokens each). Every stream equals
    token for token the greedy `rnn_time_step` loop on the same weights
    (`lstm_greedy_loop`); the eager windows give the same streams; the
    prefix cache and speculation are off, their reasons naming the
    recurrent carries. B2b runs on design 2 for the prefill chunks (T 50)
    and on design 1 for the decode steps (T 1), 2 a step, and nothing
    else launches. Then the same prompts through `InferenceServer`, 8
    SSE clients at a time, every stream equal to the direct one; then a
    same-shape `deploy()` (a copy of the weights) under 4 live streams,
    which complete equal to the direct ones: the flip carried their
    h/c."""
    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    V = 77
    net = TextGenerationLSTM(input_shape=(prompt_len, V),
                             seed=31).init(device="cuda")
    prompts = [rng.integers(0, V, prompt_len) for _ in range(slots)]
    t0 = time.perf_counter()
    want = lstm_greedy_loop(net, prompts, chunk, max_new)
    loop_s = time.perf_counter() - t0

    def serve(graphs):
        net.cuda_graphs = graphs
        registry, sched, mgr = control_plane(net, slots=slots, chunk=chunk,
                                             k=k)
        try:
            torch.cuda.synchronize()
            reset_all_counts()
            before = window_graph_counts(net)
            streams, wave = serve_wave(mgr, prompts, [True] * slots,
                                       max_new, V)
            torch.cuda.synchronize()
            launches, plain = read_all_counts()
            by_design = launches_by_design(lk)
            snap = mgr.snapshot()
            counts = {c: v - before[c]
                      for c, v in window_graph_counts(net).items()}
        finally:
            sched.shutdown()
            registry.close()
            net.cuda_graphs = True
        check(sum(plain.values()) == 0,
              f"path_ls: plain versions ran on CUDA tensors: {plain}")
        return streams, wave, launches, by_design, snap, counts

    streams, wave, launches, by_design, snap, counts = serve(True)
    check_lstm_streams(streams, want, "path_ls")
    windows = snap["dispatches"]["windows"]
    check(counts["replays"] == windows and counts["eager"] == 0,
          f"path_ls: {windows} windows, graph counts {counts}")
    d1 = by_design["lstm_fwd_inference/cluster"]
    d2 = by_design["lstm_fwd_inference/persistent"]
    check(d1 == 2 * k * windows and d2 > 0 and d2 % 2 == 0
          and d1 + d2 == launches["lstm_fwd_inference"],
          f"path_ls: B2b launches by design {by_design} for {windows} "
          f"windows of {k}")
    others = {n: v for n, v in launches.items()
              if v and n != "lstm_fwd_inference"}
    check(not others, f"path_ls: other kernels launched: {others}")
    pc, sd = snap["prefix_cache"], snap["spec_decode"]
    check(not pc["enabled"] and "recurrent carries" in pc["reason"]
          and not sd["enabled"] and "recurrent carries" in sd["reason"],
          f"path_ls: prefix {pc}, spec {sd}")
    slot_bytes = snap["slots"]["slot_bytes"]
    check(slot_bytes == 2 * 2 * 256 * 4,
          f"path_ls: {slot_bytes} bytes a slot, want two layers' h and c")
    eager_streams, eager_wave, _, _, _, eager_counts = serve(False)
    check(eager_streams == streams and eager_counts["replays"] == 0,
          f"path_ls: the eager windows differ from the replayed ones "
          f"({eager_counts})")

    srv = InferenceServer(net, decode_slots=slots,
                          decode_prefill_chunk=chunk, decode_fused_k=k)
    try:
        port = srv.start()
        http, waves = [], []
        for lo in range(0, slots, 8):
            got, w = http_wave(port, prompts[lo:lo + 8], max_new)
            http += got
            waves.append(w)
        check_lstm_streams(http, streams, "path_ls HTTP")
        live = [SseClient(port, p, max_new) for p in prompts[:4]]
        wait_first_tokens(live)
        t0 = time.perf_counter()
        srv.deploy("default", 2, net.clone())
        deploy_s = time.perf_counter() - t0
        swapped = [c.result() for c in live]
        check_lstm_streams(swapped, streams[:4], "path_ls across deploy()")
        _, _, models = http_call(port, "/models")
        check(models["models"]["default"]["version"] == 2,
              f"path_ls: after the deploy /models says {models}")
    finally:
        srv.stop()
    row = {"phase": "path_ls", "model": "TextGenerationLSTM", "hidden": 256,
           "vocab": V, "dtype": "float32", "slots": slots,
           "prompt_len": prompt_len, "max_new": max_new,
           "prefill_chunk": chunk, "k": k, "direct": wave,
           "eager": eager_wave, "rnn_time_step_loop_s": loop_s,
           "streams_equal_rnn_time_step": True,
           "eager_equal_replayed": True, "http_waves": waves,
           "http_equal_direct": True,
           "hot_swap": {"deploy_s": deploy_s, "live": len(live),
                        "live_equal_direct": True},
           "slot_bytes": slot_bytes, "prefix_cache": pc,
           "spec_decode": {"enabled": sd["enabled"],
                           "reason": sd["reason"]},
           "dispatches": snap["dispatches"], "window_graph_counts": counts,
           "launches": launches, "launches_by_design": by_design}
    emit(row)
    return row


def path_gt(batches):
    """`path_g`'s tBPTT fit as a ComputationGraph: the same three layers as
    vertices (`graph_twin`), tBPTT 50, Adam(1e-3), from the same initial
    weights (`TextGenerationLSTM(seed=9)`'s seeded init) on `path_g`'s
    two batches (B 32, T 200), beside the sequential fit run again on
    the same inputs. The per-batch losses (each the mean of its 4 chunk
    losses) and the final parameters agree within 1e-6 relative (the row
    says whether bit for bit); B2a, B2c and B1a launch as often on both;
    then one more batch under tbptt(50, 25): each chunk's head advances
    the carries through B2b, its tail trains."""
    import dataclasses

    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    B, T, V = 32, 200, 77
    seq = TextGenerationLSTM(input_shape=(T, V), seed=9).init(device="cuda")
    graph = graph_twin(seq)
    graph.conf = dataclasses.replace(graph.conf, tbptt_fwd_length=50,
                                     tbptt_back_length=50)
    runs = {}
    for name, net in (("sequential", seq), ("graph", graph)):
        scores = CollectScoresIterationListener()
        net.listeners.append(scores)
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        net.fit(batches, epochs=1)
        torch.cuda.synchronize()
        launches, plain = read_all_counts()
        check(sum(plain.values()) == 0,
              f"path_gt {name}: plain versions ran on CUDA tensors")
        runs[name] = {"losses": [sc for _, sc in scores.scores],
                      "fit_s": time.perf_counter() - t0,
                      "launches": launches,
                      "by_design": launches_by_design(lk),
                      "leaves": [p.detach().clone()
                                 for p in tree_leaves(net.params_tree)]}
    sq, gr = runs["sequential"], runs["graph"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gr["losses"],
                                                       sq["losses"]))
    param_rel = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(gr["leaves"], sq["leaves"]))
    bit_equal = gr["losses"] == sq["losses"] and all(
        torch.equal(a, b) for a, b in zip(gr["leaves"], sq["leaves"]))
    check(len(gr["losses"]) == 2 and loss_rel <= 1e-6 and param_rel <= 1e-6,
          f"path_gt: the graph's fit differs from the sequential one: "
          f"losses {gr['losses']} against {sq['losses']}, parameters "
          f"{param_rel} relative")
    kernels = ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights", "adam_update")
    check(all(gr["launches"][n] == sq["launches"][n] > 0 for n in kernels)
          and gr["by_design"] == sq["by_design"],
          f"path_gt: launches {gr['launches']} against {sq['launches']}")
    graph.conf = dataclasses.replace(graph.conf, tbptt_back_length=25)
    torch.cuda.synchronize()
    reset_all_counts()
    graph.fit(batches[:1], epochs=1)
    torch.cuda.synchronize()
    back, _ = read_all_counts()
    check(all(back[n] == 8 for n in ("lstm_fwd", "lstm_fwd_inference",
                                     "lstm_bwd", "lstm_bwd_weights"))
          and back["adam_update"] == 4 and np.isfinite(graph.score_),
          f"path_gt tbptt(50, 25): launches {back}, loss {graph.score_}")
    row = {"phase": "path_gt", "model": "TextGenerationLSTM as a "
           "ComputationGraph", "T": T, "batch": B, "tbptt": 50,
           "losses": gr["losses"], "sequential_losses": sq["losses"],
           "loss_rel_err": loss_rel, "param_rel_err": param_rel,
           "bit_equal": bit_equal, "fit_s": gr["fit_s"],
           "sequential_fit_s": sq["fit_s"],
           "launches": {n: gr["launches"][n] for n in kernels},
           "launches_by_design": gr["by_design"],
           "tbptt_50_25": {"loss": graph.score_,
                           "launches": {n: back[n] for n in kernels
                                        + ("lstm_fwd_inference",)}}}
    emit(row)
    return row


ADDITION_VOCAB = 12          # the digits, "+" and the go/pad " "


def addition_conf(hidden=256, digits=2, seed=41):
    """dl4j-examples `AdditionRNN`'s encoder-decoder graph: the encoder
    GravesLSTM reads "a+b" (2 x digits + 1 characters, one-hot), its
    last step (`LastTimeStepVertex`) is broadcast over the decoder's
    digits + 1 steps (`DuplicateToTimeSeriesVertex`) and merged with the
    decoder's input (the sum shifted behind a go symbol), a GravesLSTM
    decodes and a softmax reads each digit of the sum. Adam(1e-2),
    float32."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import (
        DuplicateToTimeSeriesVertex, LastTimeStepVertex, MergeVertex,
    )
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    te, td = 2 * digits + 1, digits + 1
    g = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
         .activation("tanh").graph_builder()
         .add_inputs("additionIn", "sumIn")
         .set_input_types(InputType.recurrent(ADDITION_VOCAB, te),
                          InputType.recurrent(ADDITION_VOCAB, td)))
    g.add_layer("encoder", GravesLSTM(n_out=hidden), "additionIn")
    g.add_vertex("lastTimeStep", LastTimeStepVertex(mask_input="additionIn"),
                 "encoder")
    g.add_vertex("duplicateTimeStep",
                 DuplicateToTimeSeriesVertex(timesteps=td), "lastTimeStep")
    g.add_vertex("merge", MergeVertex(), "sumIn", "duplicateTimeStep")
    g.add_layer("decoder", GravesLSTM(n_out=hidden), "merge")
    g.add_layer("output", RnnOutputLayer(n_out=ADDITION_VOCAB,
                                         activation="softmax",
                                         loss="mcxent"), "decoder")
    g.set_outputs("output")
    return ComputationGraph, g.build()


def addition_batches(rng, n, batch, digits=2):
    """`n` MultiDataSets of random sums a + b (a, b < 10^digits), one-hot:
    the encoder's "a+b", the decoder's go symbol and the sum's first
    digits, the sum's digits + 1 digits as labels."""
    from deeplearning4j_tpu_torch.data import MultiDataSet

    eye = np.eye(ADDITION_VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        a, b = (rng.integers(0, 10 ** digits, batch) for _ in range(2))

        def digits_of(v, width):
            return np.stack([(v // 10 ** i) % 10
                             for i in range(width - 1, -1, -1)], axis=1)

        enc = np.concatenate([digits_of(a, digits),
                              np.full((batch, 1), 10),
                              digits_of(b, digits)], axis=1)
        total = digits_of(a + b, digits + 1)
        dec = np.concatenate([np.full((batch, 1), 11), total[:, :-1]],
                             axis=1)
        out.append(MultiDataSet([eye[enc], eye[dec]], [eye[total]]))
    return out


def path_s2s(rng, batch=512, hidden=256):
    """The two recurrent vertices: `AdditionRNN`'s graph (`addition_conf`)
    at hidden 256 and batch 512, 4 fixed batches x 3 epochs = 12 Adam
    steps at K 1, again at K 1, and at K 4 (`k_parity`: K 4 bit-equal to
    K 1, the loss falling); B2a, B2c (T 5 and T 3: design 1) twice a
    step and B1a once; then `output()`: B2b twice."""
    from deeplearning4j_tpu_torch.ops import lstm as lk

    batches = addition_batches(rng, 4, batch)

    def make():
        cls, conf = addition_conf(hidden)
        return cls(conf, device="cuda").init()

    kernels = ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights", "adam_update")
    row = k_parity("path_s2s", make, lambda: batches, batch, kernels,
                   unit="sequences")
    check(row["k4_bit_equal_k1"], "path_s2s: K 4 is not bit-equal to K 1")
    check(all(row["launches"][n] == 24 for n in kernels[:3])
          and row["launches"]["adam_update"] == 12,
          f"path_s2s: launches {row['launches']}")
    net = make()
    torch.cuda.synchronize()
    reset_all_counts()
    probs = net.output(*batches[0].features)
    torch.cuda.synchronize()
    launches, plain = read_all_counts()
    by_design = launches_by_design(lk)
    check(tuple(probs.shape) == (batch, 3, ADDITION_VOCAB)
          and bool(torch.isfinite(probs).all())
          and float((probs.sum(-1) - 1).abs().max()) < 1e-4,
          f"path_s2s: output {tuple(probs.shape)}")
    check(launches["lstm_fwd_inference"] == 2
          and by_design["lstm_fwd_inference/cluster"] == 2
          and sum(plain.values()) == 0,
          f"path_s2s: output() launches {launches}, plain {plain}")
    out = {"phase": "path_s2s", "graph": "AdditionRNN", "hidden": hidden,
           "batch": batch, "T_encoder": 5, "T_decoder": 3,
           "launches": row["launches"],
           "epoch_mean_loss": row["k1"]["epoch_mean_loss"],
           "output_launches": launches["lstm_fwd_inference"]}
    emit(out)
    return out


# ------------------------------------------------ ResNet-50 phases (B7)
def image_batches(rng, n, batch, size, classes):
    """`n` fixed DataSets: standard-normal NHWC images, random one-hot
    labels."""
    from deeplearning4j_tpu_torch.data import DataSet

    eye = np.eye(classes, dtype=np.float32)
    return [DataSet(rng.standard_normal((batch, size, size, 3),
                                        dtype=np.float32),
                    eye[rng.integers(0, classes, batch)])
            for _ in range(n)]


B7_KERNELS = ("conv1x1_bn_stats", "conv3x3_bn_stats")


def launches_by_design(mod):
    """{"kernel/design": launches} of a kernel module with two designs
    (`ops.attention`: B3a-c, `ops.lstm`: B2a/B2b, `ops.conv_fused`: B7,
    `ops.banded_attention`: B6/B6q) since the counts were reset."""
    return {f"{k}/{d}": n for (k, d), n in mod.LAUNCHES_BY_DESIGN.items()}


@contextlib.contextmanager
def tf32_off():
    """TF32 off for `torch.matmul` and cuDNN inside, restored after: no
    float32 product on a float32 path is then single-pass TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# the B7 design each dtype of path_r takes at every shape
PATH_R_DESIGN = {"bfloat16": "wgmma", "float32": "tf32x3"}


def path_r(batches, epochs=3, fused=True, dtype="bfloat16"):
    """`bench.py`'s ResNet-50 at full width (224x224, 1000 classes,
    batch 128; Nesterovs(0.01, 0.9): `resnet_conf`) in `dtype`: bfloat16
    (`path_r`, the bench's) or float32 (`path_r_f32`, the zoo's own, TF32
    off: `tf32_off`), 4 fixed batches x 3 epochs = 12 steps through
    `net.fit` (`timed_fit`): with `fused`, B7a 36 and B7b 16 times a
    step, all on the dtype's design (`PATH_R_DESIGN`: "wgmma" or
    "tf32x3"), and B1b once, then one `output()`, which folds the running
    statistics and launches no B7. Unfused (information only): cuDNN
    convolutions and plain batch norms, no B7."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.ops import conv_fused as cf

    name = ("path_r" if dtype == "bfloat16" else "path_r_f32") \
        + ("" if fused else "_unfused")
    batch = batches[0].features.shape[0]
    with tf32_off():
        net = ComputationGraph(resnet_conf(fused=fused, dtype=dtype),
                               device="cuda").init()
        fit = timed_fit(name, net, batches, epochs, batch, unit="images",
                        loss_must_fall=fused)
    steps, launches = fit["steps"], fit["launches"]
    per_step = {"conv1x1_bn_stats": 36, "conv3x3_bn_stats": 16} if fused \
        else {"conv1x1_bn_stats": 0, "conv3x3_bn_stats": 0}
    for k, n in per_step.items():
        check(launches[k] == n * steps, f"{name}: {k} launched "
              f"{launches[k]} times, want {n} a step x {steps}")
    check(launches["nesterov_update"] == steps,
          f"{name}: nesterov_update launched {launches['nesterov_update']} "
          f"times, want one a step x {steps}")
    by_design = launches_by_design(cf)
    want = PATH_R_DESIGN[dtype]
    for k, n in per_step.items():
        check(all(by_design[f"{k}/{d}"] == (n * steps if d == want else 0)
                  for d in cf.DESIGNS),
              f"{name}: {dtype} {k} not all on {want}: {by_design}")
    row = {"phase": name, "model": "ResNet50", "fused": fused,
           "input": [224, 224, 3], "classes": 1000, "batch": batch,
           "dtype": dtype, "updater": str(net.conf.updater), **fit,
           "launches_by_design": by_design}
    if fused:
        t0 = time.perf_counter()
        with tf32_off():
            probs = net.output(batches[0].features)
        torch.cuda.synchronize()
        row["output_s"] = time.perf_counter() - t0
        after, plain = read_all_counts()
        row["output_launches"] = {k: after[k] - launches[k]
                                  for k in B7_KERNELS}
        check(sum(row["output_launches"].values()) == 0,
              f"{name}: output() launched B7: {row['output_launches']}")
        check(sum(plain.values()) == 0,
              f"{name}: plain versions ran on CUDA tensors: {plain}")
        check(tuple(probs.shape) == (batch, 1000),
              f"{name}: output {tuple(probs.shape)}")
        check(bool(torch.isfinite(probs).all()), f"{name}: output not finite")
        row["output_row_sum_max_err"] = float(
            (probs.float().sum(-1) - 1).abs().max())
        # a softmax's rows: one bf16 step in bfloat16, float32 rounding
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        check(row["output_row_sum_max_err"] < tol,
              f"{name}: output rows do not sum to 1 ({dtype})")
    emit(row)
    del net
    torch.cuda.empty_cache()
    return row


def resnet_parity(rng, tol_first=1e-4, tol_loss=2e-2, tol_param=5e-3,
                  tol_out=1e-3):
    """The fused ResNet-50 on the card against the CPU (plain versions),
    float32, TF32 off, same seed (so the same weights) and batch: two
    Nesterovs(1e-4, 0.9) steps of `fit`, then `output()`. At 64x64 and
    batch 16: at 32x32 and batch 4 training-mode batch norms over four
    values a channel make the step chaotic (float32 against float64 on
    the CPU: the second loss 10-30% apart even at lr 1e-5); here float32
    against float64 differ by 1.4e-6 on the first loss, 6.3e-3 on the
    second and 1.1e-3 on parameters. Tolerances: first loss (a forward)
    `tol_first` relative, second loss `tol_loss` relative, parameters
    `tol_param` absolute. `output()` is compared on the SAME trained
    weights and running statistics (the card's, loaded into the CPU net):
    after two steps the running statistics are far from the batch's, the
    eval logits reach hundreds and the softmax saturates, so outputs of
    the two nets' own weights differ by their parameters' 5e-3, not by
    the eval path (float32 against float64 on shared weights: 8.6e-5);
    `tol_out` absolute on the probabilities."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs, tree_leaves

    size, batch = 64, 16
    ds = image_batches(rng, 1, batch, size, 8)[0]
    nets, losses = {}, {}
    for d in ("cuda", "cpu"):
        net = ComputationGraph(resnet_conf(
            num_classes=8, size=size, dtype="float32",
            updater=Nesterovs(1e-4, 0.9)), device=d).init()
        scores = CollectScoresIterationListener()
        net.listeners.append(scores)
        reset_all_counts()
        net.fit(ds, epochs=2)
        if d == "cuda":
            launches, plain = read_all_counts()
            check(launches["conv1x1_bn_stats"] == 72
                  and launches["conv3x3_bn_stats"] == 32,
                  f"resnet_parity: B7 launches {launches}")
            by_design = launches_by_design(cf)
            check(by_design["conv1x1_bn_stats/tf32x3"] == 72
                  and by_design["conv3x3_bn_stats/tf32x3"] == 32,
                  f"resnet_parity: float32 B7 not on design 3: {by_design}")
            check(sum(plain.values()) == 0,
                  f"resnet_parity: plain versions on CUDA: {plain}")
        nets[d], losses[d] = net, [sc for _, sc in scores.scores]
    card, cpu = nets["cuda"], nets["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                              losses["cpu"])]
    dp = max((a.cpu() - b).abs().max().item()
             for a, b in zip(tree_leaves(card.params_tree),
                             tree_leaves(cpu.params_tree)))
    for tree, src in ((cpu.params_tree, card.params_tree),
                      (cpu.state_tree, card.state_tree)):
        for a, b in zip(tree_leaves(tree), tree_leaves(src)):
            a.copy_(b.cpu())
    do = (card.output(ds.features).cpu()
          - cpu.output(ds.features)).abs().max().item()
    check(rel[0] <= tol_first and rel[1] <= tol_loss,
          f"resnet_parity: losses {losses} differ by {rel}")
    check(dp <= tol_param, f"resnet_parity: parameters differ by {dp}")
    check(do <= tol_out, f"resnet_parity: outputs on shared weights differ "
          f"by {do}")
    row = {"phase": "resnet_parity", "input": [size, size, 3],
           "batch": batch, "classes": 8, "dtype": "float32",
           "updater": "Nesterovs(1e-4, 0.9)", "steps": 2, "losses": losses,
           "loss_rel_err": rel, "tol_first_loss_rel": tol_first,
           "tol_loss_rel": tol_loss, "max_param_abs_err": dp,
           "tol_param_abs": tol_param,
           "max_output_abs_err_shared_weights": do,
           "tol_output_abs": tol_out, "launches_by_design": by_design}
    emit(row)
    return row


# ------------------------------------------------- K steps a dispatch (A1c)
def overhead_mlp():
    """`bench.py`'s host-overhead model (`bench.py:878-886`): MLP
    16 -> 32 -> 4, Sgd(0.01), seed 0."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.01))
            .list(DenseLayer(n_out=32, activation="relu"),
                  OutputLayer(n_out=4, activation="softmax",
                              loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    return MultiLayerNetwork(conf, device="cuda").init()


def host_overhead(batch=64, steps=256, k=8):
    """The port of `bench.py`'s host-overhead mode (`bench.py:843-990`)
    with its model and sizes: ms a step of the fit path's own step
    methods on batches already on the card (so no ETL), best of 3, in
    four modes: `sync` (`float()` of every step's loss), `deferred` (the
    default loop: the loss stays on the card), `fused` (`_fused_dispatch`
    of K steps: one graph replay a window) and `floor` (one graph of all
    `steps` steps). Host overhead a step = mode - floor, and
    `host_overhead_reduction` = (sync - floor) / (fused - floor), as
    JAX defines them; then the host syncs a step of a default `fit`."""
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.default_rng(0)
    dss = [DataSet(rng.standard_normal((batch, 16)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[rng.integers(0, 4, batch)])
           for _ in range(steps)]

    def measure(mode, kk=k):
        net = overhead_mlp()
        dev = [net._put_batch(d) for d in dss]
        if mode in ("fused", "floor"):
            net._fused_dispatch(dev[:kk])        # eager warm-up, capture
        else:
            net._fit_batch(dev[0])
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            if mode == "sync":
                for ds in dev:
                    float(net._fit_batch(ds))
            elif mode == "deferred":
                for ds in dev:
                    net._fit_batch(ds)
            else:
                for i in range(0, steps, kk):
                    net._fused_dispatch(dev[i:i + kk])
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / steps * 1e3)
        graphs = net._graphs.stats.get("fit", {})
        want = 3 * steps // kk if mode in ("fused", "floor") else 0
        check(graphs.get("replays", 0) == want,
              f"host_overhead {mode}: {graphs} graph replays, want {want}")
        loss = float(net.score(dss[0]))
        check(np.isfinite(loss), f"host_overhead {mode}: loss {loss}")
        return best, graphs.get("capture_ms", 0.0)

    (sync_ms, _), (deferred_ms, _) = measure("sync"), measure("deferred")
    fused_ms, fused_capture = measure("fused")
    floor_ms, floor_capture = measure("floor", steps)

    def overhead(ms):
        return max(ms - floor_ms, 0.0)

    def reduction(ms):
        return overhead(sync_ms) / overhead(ms) if overhead(ms) > 0 else None

    net = overhead_mlp()
    feats = np.concatenate([d.features for d in dss[:32]])
    labs = np.concatenate([d.labels for d in dss[:32]])
    net.fit(feats, labs, batch_size=batch, epochs=2)
    tracked = net._loss_tracker
    row = {"phase": "host_overhead", "model": "MLP 16-32-4, Sgd(0.01)",
           "unit": "ms/step", "batch": batch, "steps": steps,
           "steps_per_dispatch": k, "sync_ms_per_step": sync_ms,
           "deferred_ms_per_step": deferred_ms,
           "fused_ms_per_step": fused_ms,
           "compute_floor_ms_per_step": floor_ms,
           "host_overhead_ms_per_step": {
               "sync": overhead(sync_ms), "deferred": overhead(deferred_ms),
               "fused": overhead(fused_ms)},
           "host_overhead_reduction": reduction(fused_ms),
           "host_overhead_reduction_deferred_only": reduction(deferred_ms),
           "capture_ms": {"fused": fused_capture, "floor": floor_capture},
           "host_sync_per_step": {
               "sync": 1.0,
               "deferred_fit": tracked.host_syncs / max(1, tracked.updates)}}
    check(fused_ms < sync_ms, f"host_overhead: fused {fused_ms} ms a step "
          f"is not below sync {sync_ms}")
    emit(row)
    return row


def decode_streams(net, prompts, k, n, eos=-1):
    """Greedy streams of `prompts` through `session_step` (one prefill
    chunk) and `session_decode_window`s of `k` until every lane has `n`
    tokens or met `eos`."""
    S = len(prompts)
    c = net.session_carries(S)
    L = max(len(p) for p in prompts) - 1
    tok = np.zeros((S, L), np.float32)
    val = np.zeros((S, L), np.float32)
    for i, p in enumerate(prompts):
        tok[i, :len(p) - 1] = p[:-1]
        val[i, :len(p) - 1] = 1.0
    _, c = net.session_step(tok[:, :, None], c, active=np.ones(S, bool),
                            valid=val)
    first = np.array([p[-1] for p in prompts], np.int32)
    streams = [[] for _ in range(S)]
    live = np.ones(S, bool)
    while live.any():
        offs = np.array([len(x) for x in streams], np.int32)
        toks, emits, c = net.session_decode_window(
            first, c, active=live, k=k, temperature=np.ones(S, np.float32),
            top_k=np.full(S, 256, np.int32), top_p=np.ones(S, np.float32),
            greedy=np.ones(S, bool), keys=np.zeros((S, 2), np.uint32),
            offsets=offs, budgets=n - offs,
            eos_ids=np.full(S, eos, np.int32))
        toks, emits = toks.cpu().numpy(), emits.cpu().numpy()
        for i in range(S):
            new = [int(t) for t, e in zip(toks[i], emits[i]) if e]
            streams[i] += new
            if new:
                first[i] = new[-1]
            if len(streams[i]) >= n or eos in new:
                live[i] = False
    return streams


def graph_parity(rng):
    """Small shapes on the card: SimpleCNN (batch norm, dropout 0.5,
    Adam: B1a) at K 4 against K 1, and a small ComputationGraph with
    batch norm under Nesterovs (B1b) likewise: losses, parameters,
    optimizer state and running statistics bit-equal (equal parameters
    after dropout need the same masks), the same launch counts; then a
    2-block transformer's decode windows graphed against the eager loop,
    and with a lane's EOS inside a window that lane stops AT the EOS
    under the graph too."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import (
        ComputationGraph, MultiLayerNetwork,
    )
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    def simple_cnn():
        return MultiLayerNetwork(SimpleCNN(input_shape=(16, 16, 3),
                                           num_classes=5).conf(),
                                 device="cuda").init()

    def small_graph():
        g = (NeuralNetConfiguration.builder().seed(5)
             .updater(Nesterovs(0.05, 0.9)).graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(8, 8, 3)))
        g.add_layer("c", ConvolutionLayer(n_out=8, kernel=(3, 3),
                                          convolution_mode="same"), "in")
        g.add_layer("b", BatchNormalization(activation="relu"), "c")
        g.add_layer("gap", GlobalPoolingLayer(pooling="avg"), "b")
        g.add_layer("output", OutputLayer(n_out=3, activation="softmax"),
                    "gap")
        g.set_outputs("output")
        return ComputationGraph(g.build(), device="cuda").init()

    def batches(n, b, shape, classes):
        return [DataSet(rng.random((b, *shape), dtype=np.float32),
                        np.eye(classes, dtype=np.float32)[
                            rng.integers(0, classes, b)])
                for _ in range(n)]

    row = {"phase": "graph_parity"}
    for name, make, data, kernel in (
            ("simple_cnn", simple_cnn, batches(8, 8, (16, 16, 3), 5),
             "adam_update"),
            ("graph_nesterovs", small_graph, batches(8, 4, (8, 8, 3), 3),
             "nesterov_update")):
        out = {}
        for k in (1, 4):
            net = make()
            scores = CollectScoresIterationListener()
            net.listeners.append(scores)
            reset_all_counts()
            net.fit(data, epochs=2, steps_per_dispatch=k)
            launches, plain = read_all_counts()
            check(sum(plain.values()) == 0,
                  f"graph_parity {name}: plain versions on CUDA: {plain}")
            out[k] = ([sc for _, sc in scores.scores], leaves_of(net),
                      launches, dict(net.fit_stats))
            del net
        (l1, t1, n1, _), (l4, t4, n4, st4) = out[1], out[4]
        check(l1 == l4 and all(torch.equal(a, b) for a, b in zip(t1, t4)),
              f"graph_parity {name}: K 4 differs from K 1")
        check(n4 == n1 and n4[kernel] == 16, f"graph_parity {name}: "
              f"launches {n4[kernel]} at K 4, {n1[kernel]} at K 1")
        check(st4 == {"graph_windows": 3, "eager_steps": 4},
              f"graph_parity {name}: {st4}")
        row[name] = {"losses": l4, "launches": n4[kernel], **st4,
                     "bit_equal_k1": True}

    net = build_net("cuda", num_blocks=2, seed=3, t=64)
    prompts = [rng.integers(0, 256, n) for n in (9, 17, 5)]
    free = decode_streams(net, prompts, 4, 16)
    net.cuda_graphs = False
    check(decode_streams(net, prompts, 4, 16) == free,
          "graph_parity: graphed windows differ from the eager loop")
    net.cuda_graphs = True
    # a token a lane meets first inside a window (not at a window's end)
    firsts = [(lane, j) for lane, st in enumerate(free)
              for j in range(1, len(st))
              if st[j] not in st[:j] and j % 4 != 3]
    check(bool(firsts), f"graph_parity: streams too repetitive: {free}")
    lane, i = firsts[0]
    eos = free[lane][i]
    before = window_graph_counts(net)["replays"]
    stopped = decode_streams(net, prompts, 4, 16, eos=eos)
    for st, want in zip(stopped, free):
        cut = want[:want.index(eos) + 1] if eos in want else want
        check(st == cut, f"graph_parity: a lane did not stop AT its EOS "
              f"{eos}: {st}, free-running {want}")
    check(window_graph_counts(net)["replays"] > before,
          "graph_parity: the EOS run replayed no window graph")
    row["eos_mid_window"] = {"lane": lane, "eos_at": i, "window": 4,
                             "stream": stopped[lane]}
    emit(row)
    return row


# ------------------------------------------------------------ LeNet (A1a)
LENET_LEAVES = 431_080        # LeNet's parameters: 8 leaves, 28x28x1 input


def lenet_conf(dtype="bfloat16", updater=None, seed=123):
    """The zoo's LeNet (its default Adam(1e-3) unless `updater`) with its
    dtype replaced, as `bench.py`'s `_bench_lenet` builds it."""
    import dataclasses

    from deeplearning4j_tpu_torch.zoo import LeNet

    kw = {} if updater is None else {"updater": updater}
    return dataclasses.replace(LeNet(seed=seed, **kw).conf(), dtype=dtype)


def path_m(epochs=3, batch=1024, batches_per_epoch=4):
    """LeNet as a MultiLayerNetwork, as a user drives it: the zoo's LeNet
    in bfloat16 with its default Adam(1e-3) (B1a once a step) on the
    port's `MnistDataSetIterator` (the synthetic surrogate when no MNIST
    files are present) at batch 1024, 4 batches x 3 epochs = 12 steps
    through `net.fit` (`timed_fit`); then `evaluate()` on the 10,000-image
    test split, held to the card's own argmax of `output()` over the same
    batches (the same forward at the same shapes, so the same classes),
    and a `save_model` / `load_model` round trip onto the card whose
    `output()` must equal the saved net's bit for bit."""
    import os
    import tempfile

    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialize import (
        load_model, save_model,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    net = MultiLayerNetwork(lenet_conf(), device="cuda").init()
    check(net.conf.updater == Adam(1e-3),
          f"path_m: zoo updater is {net.conf.updater}, not Adam(1e-3)")
    check(net.dtype == torch.bfloat16 and net.num_params() == LENET_LEAVES,
          f"path_m: {net.dtype}, {net.num_params()} parameters")
    train = MnistDataSetIterator(batch, num_examples=batches_per_epoch
                                 * batch, seed=0)
    fit = timed_fit("path_m", net, train, epochs, batch, unit="images",
                    per_epoch=batches_per_epoch)
    steps, launches = fit["steps"], fit["launches"]
    check(launches["adam_update"] == steps,
          f"path_m: adam_update launched {launches['adam_update']} times, "
          f"want one a step x {steps}")
    row = {"phase": "path_m", "model": "LeNet", "input": [28, 28, 1],
           "classes": 10, "parameters": net.num_params(), "batch": batch,
           "dtype": "bfloat16", "updater": str(net.conf.updater),
           "data": "synthetic" if train.synthetic else "MNIST files",
           **fit}
    print(f"path_m: MNIST {row['data']}", flush=True)

    test = MnistDataSetIterator(batch, train=False, shuffle=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = net.evaluate(test)
    row["evaluate_s"] = time.perf_counter() - t0
    cm = ev.confusion.matrix
    hits = torch.zeros((), dtype=torch.int64, device="cuda")
    n_test = 0
    for ds in test:
        lab = torch.as_tensor(ds.labels.argmax(-1), device="cuda")
        hits += (torch.argmax(net.output(ds.features), -1) == lab).sum()
        n_test += ds.num_examples()
    row.update(test_examples=n_test, accuracy=ev.accuracy(),
               correct=int(np.trace(cm)), correct_by_output=int(hits))
    check(int(cm.sum()) == n_test == 10000,
          f"path_m: the confusion matrix counts {int(cm.sum())} of "
          f"{n_test} examples")
    check(row["correct"] == row["correct_by_output"],
          f"path_m: evaluate() counts {row['correct']} right, argmax of "
          f"output() on the card {row['correct_by_output']}")

    xb = next(iter(test)).features
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lenet.zip")
        t0 = time.perf_counter()
        save_model(net, path)
        back = load_model(path, device="cuda")
        torch.cuda.synchronize()
        row["save_load_s"] = time.perf_counter() - t0
        row["model_file_bytes"] = os.path.getsize(path)
    check(back.device == net.device and back.dtype == torch.bfloat16
          and (back.iteration, back.epoch) == (net.iteration, net.epoch),
          f"path_m: reloaded {back.device} {back.dtype} at iteration "
          f"{back.iteration}, epoch {back.epoch}")
    check(torch.equal(back.output(xb), net.output(xb)),
          "path_m: the reloaded net's output() differs from the saved one's")
    row["reload_output_bit_equal"] = True
    emit(row)
    del net, back
    torch.cuda.empty_cache()
    return row


def path_m_k():
    """`path_m`'s 12 steps at K 1 (twice) and K 4 (`k_parity`), each on
    a fresh iterator of the same seed."""
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    return k_parity(
        "path_m", lambda: MultiLayerNetwork(lenet_conf(),
                                            device="cuda").init(),
        lambda: MnistDataSetIterator(1024, num_examples=4096, seed=0),
        1024, ("adam_update",), unit="images", per_epoch=4)


def lenet_parity(rng, steps=8, batch=64, tol_loss=1e-5, tol_param=1e-5):
    """LeNet in float32 on the card against the CPU (plain versions), TF32
    off: the same configuration JSON and the same weights (the seeded
    init runs on the CPU for both), `steps` steps of `fit` on one fixed
    batch of 64, under Sgd(0.1), Adam (B1a on the card) and Nesterovs
    (B1b). Adam's ε is 1e-3, as in `train_parity`: at 1e-8 a near-zero
    gradient's first update is ±lr whatever its size. Losses within
    `tol_loss` relative and every parameter within `tol_param` absolute,
    as `train_parity`. The whole batch is one step: on halves of it
    Sgd(0.1) is chaotic (float32 against float64 on the CPU drift from
    1e-7 to 1.4e-4 apart by the 14th step), while on the whole batch they
    stay within 1e-7 over the 8 steps under all three updaters. The card
    runs cuDNN's deterministic algorithms (`cudnn.deterministic`): under
    its default ones one batch's Sgd and Nesterovs runs land 2e-8 or
    7e-6 to 2.4e-5 from the CPU's from call to call (ROADMAP C10)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import (
        Adam, Nesterovs, Sgd, tree_leaves,
    )

    ds = DataSet(rng.random((batch, 784), dtype=np.float32),
                 np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
    kernels = {"sgd": None, "adam": "adam_update",
               "nesterovs": "nesterov_update"}
    updaters = {"sgd": Sgd(0.1), "adam": Adam(1e-3, epsilon=1e-3),
                "nesterovs": Nesterovs(0.01, 0.9)}
    row = {"phase": "lenet_parity", "dtype": "float32", "batch": batch,
           "steps": steps, "tol_loss_rel": tol_loss,
           "tol_param_abs": tol_param}
    for name, u in updaters.items():
        js = lenet_conf("float32", updater=u).to_json()
        losses, leaves = {}, {}
        for d in ("cuda", "cpu"):
            net = MultiLayerNetwork(MultiLayerConfiguration.from_json(js),
                                    device=d).init()
            scores = CollectScoresIterationListener()
            net.listeners.append(scores)
            reset_all_counts()
            torch.backends.cudnn.deterministic = True
            try:
                net.fit(ds, epochs=steps, batch_size=batch)
            finally:
                torch.backends.cudnn.deterministic = False
            if d == "cuda":
                launches, plain = read_all_counts()
                check(sum(plain.values()) == 0,
                      f"lenet_parity {name}: plain versions on CUDA: {plain}")
                for k in ("adam_update", "nesterov_update"):
                    want = steps if k == kernels[name] else 0
                    check(launches[k] == want,
                          f"lenet_parity {name}: {k} launched "
                          f"{launches[k]} times, want {want}")
            losses[d] = [sc for _, sc in scores.scores]
            leaves[d] = [p.float().cpu() for p in tree_leaves(net.params_tree)]
        rels = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"])]
        rel = max(rels)
        dp = max((a - b).abs().max().item()
                 for a, b in zip(leaves["cuda"], leaves["cpu"]))
        check(len(rels) == steps, f"lenet_parity {name}: {len(rels)} steps")
        check(rel <= tol_loss, f"lenet_parity {name}: losses {losses} "
              f"differ by {rel} relative")
        check(dp <= tol_param, f"lenet_parity {name}: parameters differ by "
              f"{dp}")
        check(losses["cuda"][-1] < losses["cuda"][0],
              f"lenet_parity {name}: loss did not fall: {losses['cuda']}")
        row[name] = {"updater": str(u), "losses": losses,
                     "loss_rel_err": rel, "loss_rel_err_by_step": rels,
                     "max_param_abs_err": dp,
                     "kernel": kernels[name]}
    emit(row)
    return row


# ------------------------------------------------------------------ main
# ------------------------------------------------------ slice 16 (A4)
def chain_graph(seq_conf):
    """The layers of a sequential configuration as a chain
    ComputationGraph configuration, vertices named after the layers, so
    the sequential net's params tree fits it unchanged."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration

    g = (NeuralNetConfiguration.builder().seed(seq_conf.seed)
         .updater(seq_conf.updater).graph_builder().add_inputs("in")
         .set_input_types(seq_conf.input_type))
    prev = "in"
    for layer in seq_conf.layers:
        g.add_layer(layer.name, layer, prev)
        prev = layer.name
    g.set_outputs(prev)
    return dataclasses.replace(g.build(), dtype=seq_conf.dtype)


def graph_twin(net):
    """`net`'s layers as a chain ComputationGraph on its device, with its
    weights."""
    from deeplearning4j_tpu_torch.models import ComputationGraph

    twin = ComputationGraph(chain_graph(net.conf), device=net.device).init()
    for name, sub in net.params_tree.items():
        for k, v in sub.items():
            twin.params_tree[name][k].copy_(v)
    return twin


class StepRecorder:
    """Wraps a net's `rnn_time_step` and `rnn_reorder_state`, in order:
    each call's last-position probabilities (float32, left on the card)
    or reorder indices, and CUDA events around each step call (its time
    on the card's clock, with no host sync in the loop)."""

    def __init__(self, net):
        self.net = net
        self.events = []               # ("step", probs) | ("reorder", idx)
        self.marks = []
        self._step, self._reorder = net.rnn_time_step, net.rnn_reorder_state
        net.rnn_time_step = self.step
        net.rnn_reorder_state = self.reorder

    def step(self, *xs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self._step(*xs)
        b.record()
        self.marks.append((a, b))
        self.events.append(("step", out[:, -1, :].float()))
        return out

    def reorder(self, idx):
        self.events.append(("reorder", np.asarray(idx)))
        return self._reorder(idx)

    def close(self):
        del self.net.rnn_time_step, self.net.rnn_reorder_state

    def steps(self):
        return [p for kind, p in self.events if kind == "step"]

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.marks]


@contextlib.contextmanager
def uncounted_all():
    """Launches inside are a check's, not the path's (`uncounted` over
    every kernel module)."""
    with contextlib.ExitStack() as stack:
        for mod in kernel_modules():
            stack.enter_context(uncounted(mod))
        yield


def teacher_forced(net, streams, t):
    """`output()` probabilities [B, t, V] of token streams [B, n <= t],
    each padded with zeros to the net's fixed length `t` (a causal model:
    no position sees the padding after it); float32, on the host."""
    ids = np.zeros((streams.shape[0], t), np.float32)
    ids[:, :streams.shape[1]] = streams
    with uncounted_all():
        probs = net.output(ids[:, :, None])
    return probs.float().cpu().numpy()


def nucleus_mass_above(p, tok, temperature):
    """The tempered, normalized mass of the tokens ranked above `tok` in
    a stable descending order: `tok` lies in the top-p nucleus iff this
    is below top_p (`utils.sampling.warp_probs_lanes`)."""
    w = np.exp(np.log(np.maximum(p.astype(np.float64), 1e-30))
               / temperature)
    w /= w.sum()
    order = np.argsort(-w, kind="stable")
    rank = int(np.nonzero(order == tok)[0][0])
    return float(w[order[:rank]].sum())


def beam_calls_and_parents(events, prefill_calls):
    """Parse a `StepRecorder`'s events of one `beam_search` into the
    probabilities each selection drew from (the last prefill call's [B,
    V], then each step call's [B*W, V]) and each selection's reorder
    indices (None where every beam kept its own parent, which
    `beam_search` skips): prefill calls, the tiling reorder, then per
    selection an optional reorder and, but after the last, a step."""
    steps = [i for i, (kind, _) in enumerate(events) if kind == "step"]
    tile = steps[prefill_calls - 1] + 1
    check(events[tile][0] == "reorder", "path_gen: no tiling reorder after "
          "the beam prefill")
    calls = [events[steps[prefill_calls - 1]][1].cpu().numpy()]
    parents, pending = [], None
    for kind, val in events[tile + 1:]:
        if kind == "reorder":
            pending = val
        else:
            parents.append(pending)
            pending = None
            calls.append(val.cpu().numpy())
    parents.append(pending)
    return calls, parents


def lineage_probs(calls, parents, width, tokens):
    """The probability each returned beam's token had where it was drawn,
    [B, n]: with no length penalty and no EOS the returned beam is slot 0
    (the top-W selection keeps the slots sorted by score), and following
    it back through the parents picks, at each step, the row of the
    call its token was drawn from."""
    batch, n = tokens.shape
    probs = np.empty((batch, n))
    for b in range(batch):
        s = 0
        for t in range(n - 1, -1, -1):
            idx = parents[t]
            prev = s if idx is None else int(idx[b * width + s]) - b * width
            row = calls[0][b] if t == 0 else calls[t][b * width + prev]
            probs[b, t] = row[tokens[b, t]]
            s = prev
    return probs


def path_gen(rng, t=2048, batch=8, prompt_len=1024, chunk=128,
             nucleus_new=256, beam_new=256, ring_new=2048, graph_new=64,
             lstm_calls=50):
    """Lockstep generation at full width (A4), through the entry points a
    user calls (`utils.textgen.generate`, `beam_search`): Path A's model
    (6 blocks, d_model 512, T 2048, float32, learned positions), every
    decode step one `rnn_time_step` graph replay with B5 six times on
    design 2, against `output()`'s teacher-forced probabilities; Path B's
    Llama-shaped ring (B5 twice a step) wrapping its ring, against the
    port on the CPU; the same stacks as ComputationGraphs; and
    `TextGenerationLSTM` as a graph (B2b)."""
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import lstm as lk
    from deeplearning4j_tpu_torch.utils.textgen import beam_search, generate
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    B, T, V, blocks = batch, t, 256, 6
    new = T - prompt_len
    chunks = prompt_len // chunk
    net = build_net("cuda", num_blocks=blocks, seed=21, t=T)
    prompts = rng.integers(0, V, (B, prompt_len))
    row = {"phase": "path_gen", "model": "TextGenerationTransformer",
           "d_model": 512, "heads": 8, "blocks": blocks, "T": T,
           "batch": B, "dtype": "float32", "prompt_len": prompt_len,
           "prefill_chunk": chunk}

    # 1. greedy, to the end of the cache
    rec = StepRecorder(net)
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    toks = generate(net, prompts, new, greedy=True, prefill_chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the last token too: the cache then holds exactly max_cache
    last = torch.as_tensor(toks[:, -1:, None], dtype=torch.float32)
    net.rnn_time_step(last)
    launches, plain = read_all_counts()
    by_design = launches_by_design(ba)
    step_ms = rec.step_ms()
    probs = torch.stack(rec.steps()[chunks - 1:], dim=1).cpu().numpy()
    rec.close()
    check(net._decode_state.pos == T,
          f"path_gen: decode position {net._decode_state.pos}, want {T}")
    reset_all_counts()
    try:
        net.rnn_time_step(last)
        check(False, "path_gen: a step past max_cache was not refused")
    except ValueError as e:
        check(f"limit {T}" in str(e),
              f"path_gen: the refusal names no limit: {e}")
    refused, _ = read_all_counts()
    check(sum(refused.values()) == 0,
          f"path_gen: the refused step launched kernels: {refused}")
    check_design_2("path_gen", "banded_decode_attention", launches,
                   by_design, plain)
    check(launches["banded_decode_attention"] == blocks * new,
          f"path_gen: B5 launched {launches['banded_decode_attention']} "
          f"times, want {blocks} a step x {new}")
    tf = teacher_forced(net, np.concatenate([prompts, toks], 1), T)
    gap = float(np.abs(probs - tf[:, prompt_len - 1:]).max())
    check(gap <= 1e-4, f"path_gen: lockstep probabilities differ from "
          f"output()'s by {gap}")
    decode_ms = step_ms[chunks:]
    row["greedy"] = {
        "new_tokens": new, "wall_s": wall, "tokens_per_s": B * new / wall,
        "decode_tokens_per_s": B * len(decode_ms) / (sum(decode_ms) / 1e3),
        "step_ms_p50": float(np.median(decode_ms)),
        "step_ms_p99": pct(decode_ms, 99),
        "prefill_chunk_ms": step_ms[:chunks],
        "teacher_forced_max_abs_err": gap,
        "graph_counts": dict(net._graphs.stats["rnn_time_step"]),
        "refused_past_cache": True, "launches": launches,
        "launches_by_design": by_design}
    # B5 held to its plain version at this path's shape: block 0's live
    # caches, every row's query at the same (broadcast) position
    carry = net._decode_state.carries[net.layers[2].name]["attn"]
    ck, cv = carry["cache_k"], carry["cache_v"]
    q = torch.randn((B, net.layers[2].num_heads, ck.shape[-1]),
                    generator=torch.Generator().manual_seed(3)
                    ).to(ck.device)
    qpos = (carry["pos"] - 1).expand(B).contiguous()
    with uncounted(ba):
        o = ba.banded_decode_attention(q, ck, cv, qpos, qpos)
        o_ref = ba.decode_attention_plain(q, ck, cv, qpos, qpos)
    b5_err = float((o - o_ref).abs().max())
    check(b5_err <= TOL[torch.float32][0],
          f"path_gen: B5 at a broadcast position differs from its plain "
          f"version by {b5_err}")
    row["b5_broadcast_pos_max_abs_err"] = b5_err

    # 2. nucleus
    reset_all_counts()
    t0 = time.perf_counter()
    nuc = generate(net, prompts, nucleus_new, temperature=0.9, top_p=0.9,
                   prefill_chunk=chunk, rng=np.random.default_rng(0))
    nuc_wall = time.perf_counter() - t0
    nuc_launches, _ = read_all_counts()
    tf = teacher_forced(net, np.concatenate([prompts, nuc], 1), T)
    above = max(nucleus_mass_above(tf[b, prompt_len - 1 + i], nuc[b, i],
                                   0.9)
                for b in range(B) for i in range(nucleus_new))
    check(above < 0.9 + 1e-4, f"path_gen: a nucleus token lies outside "
          f"its nucleus (mass above it {above})")
    row["nucleus"] = {"new_tokens": nucleus_new, "wall_s": nuc_wall,
                      "largest_mass_above_a_token": above,
                      "distinct_tokens": int(len(np.unique(nuc))),
                      "b5_launches": nuc_launches["banded_decode_attention"]}

    # 3. beam search over 2 prompts
    two = prompts[:2]
    greedy2 = generate(net, two, beam_new, greedy=True, prefill_chunk=chunk)
    w1 = beam_search(net, two, beam_new, beam_width=1, length_penalty=0.0,
                     prefill_chunk=chunk)
    check(np.array_equal(w1, greedy2),
          "path_gen: beam width 1 differs from greedy")
    rec = StepRecorder(net)
    reset_all_counts()
    t0 = time.perf_counter()
    beams = beam_search(net, two, beam_new, beam_width=4,
                        length_penalty=0.0, prefill_chunk=chunk)
    beam_wall = time.perf_counter() - t0
    beam_launches, _ = read_all_counts()
    rec.close()
    calls, parents = beam_calls_and_parents(rec.events, chunks)
    check(len(calls) == beam_new and len(parents) == beam_new,
          f"path_gen: {len(calls)} beam calls, {len(parents)} selections")
    got = lineage_probs(calls, parents, 4, beams)
    window = slice(prompt_len - 1, prompt_len - 1 + beam_new)

    def tf_probs(stream):
        p = teacher_forced(net, np.concatenate([two, stream], 1), T)
        return np.take_along_axis(p[:, window], stream[:, :, None],
                                  axis=2)[..., 0]

    want = tf_probs(beams)
    lin = float(np.abs(got - want).max())
    check(lin <= 1e-4, f"path_gen: the beam's probabilities along its "
          f"lineage differ from output()'s by {lin}")
    check(beam_launches["banded_decode_attention"]
          == blocks * (beam_new - 1),
          f"path_gen: B5 launched {beam_launches['banded_decode_attention']}"
          f" times in the beam search, want {blocks} x {beam_new - 1}")
    reorders = sum(1 for kind, _ in rec.events if kind == "reorder")
    row["beam"] = {
        "prompts": 2, "beam_width": 4, "new_tokens": beam_new,
        "wall_s": beam_wall, "ms_per_token": beam_wall * 1e3 / beam_new,
        "reorders": reorders, "lineage_max_abs_err": lin,
        "width_1_equals_greedy": True,
        "teacher_forced_logprob_beam": float(np.log(want).sum()),
        "teacher_forced_logprob_greedy": float(np.log(
            tf_probs(greedy2)).sum()),
        "b5_launches": beam_launches["banded_decode_attention"]}

    # 4. the 2-block stack as a ComputationGraph
    small = build_net("cuda", num_blocks=2, seed=23, t=T)
    g = graph_twin(small)
    a = generate(small, prompts, graph_new, greedy=True, prefill_chunk=chunk)
    b = generate(g, prompts, graph_new, greedy=True, prefill_chunk=chunk)
    check(np.array_equal(a, b), "path_gen: the ComputationGraph's greedy "
          "tokens differ from the sequential net's")
    row["graph_equals_sequential_tokens"] = graph_new
    del net, small, g
    torch.cuda.empty_cache()

    # 5. Path B's ring, past its length, against the CPU
    ring = build_path_b_net("cuda")
    rec = StepRecorder(ring)
    reset_all_counts()
    t0 = time.perf_counter()
    rtoks = generate(ring, prompts, ring_new, greedy=True,
                     prefill_chunk=chunk)
    ring_wall = time.perf_counter() - t0
    ring_launches, ring_plain = read_all_counts()
    ring_design = launches_by_design(ba)
    rec.close()
    check_design_2("path_gen ring", "banded_decode_attention",
                   ring_launches, ring_design, ring_plain)
    check(ring_launches["banded_decode_attention"] == 2 * (ring_new - 1),
          f"path_gen: the ring's B5 launched "
          f"{ring_launches['banded_decode_attention']} times, want 2 x "
          f"{ring_new - 1}")
    tail = torch.stack(rec.steps()[-64:], dim=1)[0].cpu().numpy()
    cpu = build_path_b_net("cpu")
    fed = np.concatenate([prompts[:1], rtoks[:1, :-1]], 1)
    outs = [cpu.rnn_time_step(fed[:, s:s + chunk, None].astype(np.float32))
            for s in range(0, fed.shape[1], chunk)]
    ref = torch.cat(outs, dim=1)[0, -64:].numpy()
    ring_gap = float(np.abs(tail - ref).max())
    check(ring_gap <= 1e-4, f"path_gen: the ring's last 64 probabilities "
          f"differ from the CPU's by {ring_gap}")
    ring_ms = rec.step_ms()[chunks:]
    row["ring"] = {"model": "Path B (RoPE, RMSNorm, SwiGLU, 2 KV heads, "
                            "window 256, ring 2303, 2 blocks)",
                   "new_tokens": ring_new, "positions": fed.shape[1],
                   "wall_s": ring_wall,
                   "step_ms_p50": float(np.median(ring_ms)),
                   "decode_tokens_per_s": B * len(ring_ms)
                   / (sum(ring_ms) / 1e3),
                   "cpu_last_64_max_abs_err": ring_gap,
                   "launches": ring_launches,
                   "launches_by_design": ring_design}
    del ring, cpu
    torch.cuda.empty_cache()

    # 6. TextGenerationLSTM as a ComputationGraph (B2b)
    lstm = TextGenerationLSTM(input_shape=(200, 77), seed=9).init(
        device="cuda")
    lg = graph_twin(lstm)
    eye = torch.eye(77, device="cuda")
    tok = torch.as_tensor(rng.integers(0, 77, 32), device="cuda")
    reset_all_counts()
    lstm_gap = 0.0
    for _ in range(lstm_calls):
        a = lstm.rnn_time_step(eye[tok])
        b = lg.rnn_time_step(eye[tok])
        lstm_gap = max(lstm_gap, float((a - b).abs().max()))
        tok = torch.argmax(a[:, -1, :], dim=-1)
    lstm_launches, _ = read_all_counts()
    check(lstm_gap <= 1e-5, f"path_gen: the LSTM graph's steps differ from "
          f"the sequential net's by {lstm_gap}")
    check(lstm_launches["lstm_fwd_inference"] == 2 * 2 * lstm_calls,
          f"path_gen: B2b launched {lstm_launches['lstm_fwd_inference']} "
          f"times, want 2 layers x 2 nets x {lstm_calls}")
    row["lstm_graph"] = {"calls": lstm_calls, "streams": 32,
                         "max_abs_err": lstm_gap,
                         "b2b_launches": lstm_launches["lstm_fwd_inference"],
                         "b2b_by_design": {
                             d: launches_by_design(lk)[
                                 f"lstm_fwd_inference/{d}"]
                             for d in lk.DESIGNS}}
    del lstm, lg
    torch.cuda.empty_cache()
    emit(row)
    return row


def path_ckpt(epochs=2, batch=8, t=2048, drop_t=512):
    """Gradient checkpointing (A4): `path_t_bf16`'s model (6 blocks, T
    2048, batch 8, bfloat16, Adam(3e-4)) trained 8 steps (4 batches x 2
    epochs) without it, with it at K 1 and with it at K 4, each from the
    same seeded weights on PyTorch's deterministic algorithms: losses
    within 1e-3 relative and parameters within `train_parity_bf16`'s
    rule of the plain run; B3a twelve times a step (the forward and the
    backward's recompute), B3b and B3c six, all on design 2, B1a once;
    the checkpointed peak memory below the plain one. Then a float32
    2-block model with dropout 0.1 on its blocks, 2 steps checkpointed
    against 2 plain: parameters within 1e-6 (the recompute replays the
    forward's masks)."""
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    B, T, blocks = batch, t, 6
    batches = lm_batches(np.random.default_rng(16), 4, B, T)
    runs = {}
    for tag, ckpt, k in (("plain", False, 1), ("ckpt", True, 1),
                         ("ckpt_k4", True, 4)):
        net = build_net("cuda", num_blocks=blocks, seed=5, t=T,
                        dtype="bfloat16", gradient_checkpointing=ckpt)
        with deterministic():
            fit = timed_fit(f"path_ckpt {tag}", net, batches, epochs,
                            B * T, k=k)
        by_design = launches_by_design(fa)
        steps = fit["steps"]
        want = {"flash_attention_fwd": (2 if ckpt else 1) * blocks,
                "flash_attention_bwd_dkdv": blocks,
                "flash_attention_bwd_dq": blocks, "adam_update": 1}
        for kernel, per_step in want.items():
            check(fit["launches"][kernel] == per_step * steps,
                  f"path_ckpt {tag}: {kernel} launched "
                  f"{fit['launches'][kernel]} times, want {per_step} a "
                  f"step x {steps}")
            if kernel in FLASH_KERNELS:
                check(by_design[f"{kernel}/wgmma"] == per_step * steps,
                      f"path_ckpt {tag}: {kernel} not all on design 2: "
                      f"{by_design}")
        runs[tag] = (fit, [p.detach().float().cpu()
                           for p in tree_leaves(net.params_tree)])
        del net
        torch.cuda.empty_cache()
    rule = TRAIN_PARITY_BF16
    base_fit, base = runs["plain"]
    row = {"phase": "path_ckpt", "model": "TextGenerationTransformer",
           "blocks": blocks, "T": T, "batch": B, "dtype": "bfloat16",
           "steps": base_fit["steps"]}
    for tag in ("ckpt", "ckpt_k4"):
        fit, leaves = runs[tag]
        rel = max(abs(a - b) / abs(b) for a, b in zip(fit["losses"],
                                                      base_fit["losses"]))
        over = sum(int(((a - b).abs() > rule["tol_param"] + rule[
            "rtol_param"] * torch.maximum(a.abs(), b.abs())).sum())
            for a, b in zip(leaves, base))
        dp = max((a - b).abs().max().item() for a, b in zip(leaves, base))
        check(rel <= rule["tol_loss"], f"path_ckpt {tag}: losses differ "
              f"from the plain run's by {rel} relative")
        check(over == 0, f"path_ckpt {tag}: {over} parameters past the "
              f"bf16 rule (largest gap {dp})")
        check(fit["max_memory_allocated_bytes"]
              < base_fit["max_memory_allocated_bytes"],
              f"path_ckpt {tag}: peak memory "
              f"{fit['max_memory_allocated_bytes']} not below the plain "
              f"run's {base_fit['max_memory_allocated_bytes']}")
        row[tag] = {"steps_per_dispatch": fit["steps_per_dispatch"],
                    "loss_rel_err_vs_plain": rel,
                    "max_param_abs_err_vs_plain": dp,
                    "bit_equal_to_plain": dp == 0.0 and rel == 0.0,
                    **{c: fit[c] for c in (
                        "tokens_per_s_steps_5_12", "step_ms_p50",
                        "max_memory_allocated_bytes", "graph_windows",
                        "eager_steps", "launches")}}
    row["plain"] = {c: base_fit[c] for c in (
        "tokens_per_s_steps_5_12", "step_ms_p50",
        "max_memory_allocated_bytes", "launches")}
    row["launches"] = runs["ckpt"][0]["launches"]

    # float32, dropout 0.1: checkpointed against plain
    leaves = {}
    drop_batches = lm_batches(np.random.default_rng(17), 2, 4, drop_t)
    for ckpt in (False, True):
        net = build_net("cuda", num_blocks=2, seed=7, t=drop_t,
                        gradient_checkpointing=ckpt, dropout=0.1)
        net.fit(drop_batches)
        leaves[ckpt] = [p.detach().cpu()
                        for p in tree_leaves(net.params_tree)]
        del net
    drop_gap = max((a - b).abs().max().item()
                   for a, b in zip(leaves[True], leaves[False]))
    check(drop_gap <= 1e-6, f"path_ckpt: with dropout, the checkpointed "
          f"parameters differ from the plain ones by {drop_gap}")
    row["dropout_float32_max_param_abs_err"] = drop_gap
    emit(row)
    torch.cuda.empty_cache()
    return row


def seq2seq_conf(dtype, tq, tk, width=512, heads=8, classes=256,
                 feats=64):
    """`examples/seq2seq_cross_attention.py`'s graph at width: a
    DenseLayer(width) on each branch, CrossAttentionVertex(heads, width)
    (queries from the decoder, keys and values from the encoder),
    RnnOutputLayer(classes); Adam(1e-2) and relu as the example has."""
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import CrossAttentionVertex
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    return (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-2))
            .activation("relu").dtype(dtype).graph_builder()
            .add_inputs("dec", "enc")
            .add_layer("enc_ff", DenseLayer(n_out=width), "enc")
            .add_layer("dec_ff", DenseLayer(n_out=width), "dec")
            .add_vertex("xattn", CrossAttentionVertex(num_heads=heads,
                                                      n_out=width),
                        "dec_ff", "enc_ff")
            .add_layer("out", RnnOutputLayer(n_out=classes,
                                             activation="softmax"), "xattn")
            .set_outputs("out")
            .set_input_types(InputType.recurrent(feats, tq),
                             InputType.recurrent(feats, tk))
            .build())


def seq2seq_batches(rng, n, batch, tq, tk, feats=64, classes=256):
    """`n` fixed MultiDataSets: standard-normal decoder [batch, tq,
    feats] and encoder [batch, tk, feats] inputs, one-hot labels."""
    from deeplearning4j_tpu_torch.data import MultiDataSet

    eye = np.eye(classes, dtype=np.float32)
    return [MultiDataSet(
        [rng.standard_normal((batch, tq, feats)).astype(np.float32),
         rng.standard_normal((batch, tk, feats)).astype(np.float32)],
        [eye[rng.integers(0, classes, (batch, tq))]])
        for _ in range(n)]


def path_x(rng, epochs=2, batch=8, tq=2048, tk=1024, width=512):
    """Cross-attention through MultiDataSet feeding (A4): the seq2seq
    graph at width (Tq 2048, Tk 1024, batch 8) trained 8 Adam steps (4
    MultiDataSets x 2 epochs) at K 1 and at K 4, in bfloat16 (B3a-c
    non-causal at Tq != Tk on design 2) and float32 (B3a-c on design
    3), each
    kernel once a step and B1a once; K 4 against K 1; then the graph at
    Tq 256, Tk 200 in float32, 2 steps on the card against the CPU."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    B, TQ, TK = batch, tq, tk
    batches = seq2seq_batches(rng, 4, B, TQ, TK)
    row = {"phase": "path_x", "Tq": TQ, "Tk": TK, "batch": B,
           "width": width, "heads": 8, "classes": 256}
    for dtype in ("bfloat16", "float32"):
        design = {kernel: flash_want(getattr(torch, dtype), width // 8,
                                     kernel) for kernel in FLASH_KERNELS}
        runs = {}
        for k in (1, 4):
            net = ComputationGraph(seq2seq_conf(dtype, TQ, TK, width),
                                   device="cuda").init()
            with deterministic():
                fit = timed_fit(f"path_x {dtype} K{k}", net, batches,
                                epochs, B * TQ, k=k)
            by_design = launches_by_design(fa)
            for kernel in FLASH_KERNELS + ("adam_update",):
                check(fit["launches"][kernel] == fit["steps"],
                      f"path_x {dtype} K{k}: {kernel} launched "
                      f"{fit['launches'][kernel]} times, want one a step")
                if kernel in FLASH_KERNELS:
                    check(by_design[f"{kernel}/{design[kernel]}"]
                          == fit["steps"],
                          f"path_x {dtype}: {kernel} not all on "
                          f"{design[kernel]}: {by_design}")
            runs[k] = (fit, [p.detach().float().cpu()
                             for p in tree_leaves(net.params_tree)])
            del net
            torch.cuda.empty_cache()
        (f1, l1), (f4, l4) = runs[1], runs[4]
        k4_gap = max([abs(a - b) for a, b in zip(f1["losses"],
                                                 f4["losses"])]
                     + [(a - b).abs().max().item() for a, b in zip(l1, l4)])
        check(f4["graph_windows"] == 1 and f4["eager_steps"] == 4,
              f"path_x {dtype}: K 4 ran {f4['graph_windows']} graph "
              f"windows, {f4['eager_steps']} eager steps")
        row[dtype] = {
            "design": design, "k4_vs_k1_max_abs": k4_gap,
            **{f"k{k}": {c: f[c] for c in (
                "tokens_per_s_steps_5_12", "step_ms_p50",
                "max_memory_allocated_bytes", "epoch_mean_loss",
                "graph_windows", "eager_steps", "launches")}
               for k, (f, _) in runs.items()}}
    row["launches"] = row["bfloat16"]["k1"]["launches"]

    # the card against the CPU, float32, Tq 256, Tk 200 (a tail tile)
    small = seq2seq_batches(np.random.default_rng(18), 1, 2, 256, 200)
    losses = {}
    for d in ("cuda", "cpu"):
        net = ComputationGraph(seq2seq_conf("float32", 256, 200, width),
                               device=d).init()
        scores = CollectScoresIterationListener()
        net.listeners.append(scores)
        net.fit(small, epochs=2)
        losses[d] = [s for _, s in scores.scores]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    check(rel <= 1e-5, f"path_x: card and CPU losses {losses} differ by "
          f"{rel} relative")
    row["cpu_parity"] = {"Tq": 256, "Tk": 200, "losses": losses,
                         "loss_rel_err": rel}
    emit(row)
    return row


# ----------------------------------------------------- slice 17 (A1b)
# DL4J's DeepAutoEncoderExample (dl4j-examples 0.x): nine RBMs, 784 down
# to 30 and back up to 1000, then a sigmoid MSE output layer 1000 -> 784
DEEP_AE = (784, 1000, 500, 250, 100, 30, 100, 250, 500, 1000)


def deep_ae_conf(widths=DEEP_AE, updater=None, algo=None, iterations=20,
                 seed=123):
    """The deep autoencoder's stack: an RBM per width after the first,
    then OutputLayer(widths[-1] -> widths[0], sigmoid, MSE); Nesterovs
    (0.1, 0.9) unless `updater`; `algo` sets the full-batch solver."""
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import RBM, OutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater or Nesterovs(0.1, 0.9)))
    if algo is not None:
        b = b.optimization_algo(algo, iterations)
    layers = [RBM(n_out=n) for n in widths[1:]]
    layers.append(OutputLayer(n_out=widths[0], activation="sigmoid",
                              loss="mse"))
    return (b.list(*layers).set_input_type(InputType.feed_forward(widths[0]))
            .pretrain(True).backprop(True).build())


def vae_conf(n_in=784, hidden=(256, 256), latent=2, updater=None):
    """DL4J's VariationalAutoEncoderExample widths: 784 -> encoder (256,
    256) -> latent 2 -> decoder (256, 256), bernoulli reconstruction,
    leakyrelu; Adam(1e-3) where the example has RmsProp, so that B1a
    runs once a pretrain step."""
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import VariationalAutoencoder
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    return (NeuralNetConfiguration.builder().seed(123)
            .updater(updater or Adam(1e-3)).activation("leakyrelu")
            .list(VariationalAutoencoder(
                n_out=latent, encoder_sizes=hidden, decoder_sizes=hidden,
                reconstruction_distribution="bernoulli"))
            .set_input_type(InputType.feed_forward(n_in))
            .pretrain(True).backprop(False).build())


def finetune_net(device, encoder, widths=DEEP_AE[:6], classes=10,
                 lr=1e-2):
    """The pretrained encoder half as FrozenLayers (its RBMs' weights
    `encoder`, a list of per-layer dicts) under a CenterLossOutputLayer
    of `classes`, trained by Adam(lr)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM, CenterLossOutputLayer, FrozenLayer,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    layers = [FrozenLayer(layer=RBM(n_out=n)) for n in widths[1:]]
    layers.append(CenterLossOutputLayer(n_out=classes, activation="softmax",
                                        alpha=0.1, lambda_=1e-2))
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(7).updater(Adam(lr))
        .list(*layers).set_input_type(InputType.feed_forward(widths[0]))
        .build(), device=device).init()
    for layer, src in zip(net.conf.layers, encoder):
        for k, v in net.params_tree[layer.name].items():
            v.copy_(src[k])
    return net


def kernel_events(trace_path):
    """The device kernels of a `torch.profiler` Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def busy_us(kernels):
    """Length of the union of the kernel intervals, in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_idle_share(run):
    """(wall ms, device busy ms, idle share) of `run()` under
    `torch.profiler`: busy is the union of the kernel intervals of its
    Chrome trace (`busy_us`), wall the host clock to a synchronize."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = kernel_events(path)
    check(bool(kernels), "the profiler saw no device kernels")
    busy = busy_us(kernels)
    return wall_us / 1e3, busy / 1e3, 1.0 - busy / wall_us


def path_p(batch=1000, pretrain_batches=4, solver_iterations=20,
           vae_batch=128, vae_steps=12):
    """Layerwise pretraining, the full-batch solvers and a frozen-encoder
    fine-tune (A1b) at DL4J's example widths, float32, on the port's
    MNIST iterator (the synthetic surrogate unless MNIST files are
    present):

    - pretrain: `deep_ae_conf`'s nine RBMs, each on its input featurized
      through the RBMs before it, 4 batches of 1000 a layer under
      Nesterovs(0.1, 0.9): B1b once a pretrain step (36), ms a step;
    - solvers: one batch of 1000 (the images as their own labels)
      through `fit` under line_gradient_descent (the example's algorithm)
      and lbfgs, 20 iterations each, from the pretrained weights (loaded
      by `set_params(params())`): the loss history non-increasing, ms and
      host reads (`solver_syncs`) an iteration, then the same fit traced
      for the card's busy ms and idle share;
    - VAE: `vae_conf` pretrained 12 steps at batch 128 (B1a once a
      step): the mean negative ELBO of the last 4 below the first 4's;
    - fine-tune: the pretrained encoder half frozen under a 10-class
      CenterLossOutputLayer, Adam(1e-2), 4 batches of 1000 x 3 epochs
      (`timed_fit`): the frozen leaves bit-equal to theirs before, B1a
      once a step over the head's leaves alone, the centers moved; then
      K 1 (twice) against K 4 (`k_parity`).

    Each timed part follows an untimed warm-up of the same calls on a
    throwaway net."""
    from deeplearning4j_tpu_torch.data import DataSet, MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.multilayer import _updater_groups

    row = {"phase": "path_p", "model": "DeepAutoEncoder (9 RBMs) + VAE",
           "widths": list(DEEP_AE), "batch": batch, "dtype": "float32"}
    n_rbm = len(DEEP_AE) - 1

    def warm_batch():
        return MnistDataSetIterator(batch, num_examples=batch, seed=9)

    # warm-ups, untimed: each phase's kernels and cuBLAS plans load on
    # their first call
    MultiLayerNetwork(deep_ae_conf(), device="cuda").init().pretrain(
        warm_batch())
    net = MultiLayerNetwork(deep_ae_conf(), device="cuda").init()
    out_name = net.conf.layers[-1].name
    w_out = net.params_tree[out_name]["W"].clone()
    w_first = net.params_tree[net.conf.layers[0].name]["W"].clone()
    data = MnistDataSetIterator(batch, num_examples=pretrain_batches * batch,
                                seed=0)
    t0 = time.perf_counter()
    list(data)                  # one pass on the host: its shuffle, slices
    pass_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    reset_all_counts()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    net.pretrain(data, epochs=1)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_all_counts()
    steps = n_rbm * pretrain_batches
    check(sum(plain.values()) == 0, f"path_p pretrain: plain on CUDA {plain}")
    check(launches["nesterov_update"] == steps,
          f"path_p pretrain: nesterov_update launched "
          f"{launches['nesterov_update']} times, want {steps}")
    check(launches["adam_update"] == 0, "path_p pretrain: adam_update ran")
    losses = {n: [float(v) for v in ls]
              for n, ls in net.pretrain_losses.items()}
    check(len(losses) == n_rbm and all(
        len(v) == pretrain_batches and np.all(np.isfinite(v))
        for v in losses.values()), f"path_p pretrain: losses {losses}")
    check(torch.equal(w_out, net.params_tree[out_name]["W"])
          and not torch.equal(w_first, net.params_tree[
              net.conf.layers[0].name]["W"]),
          "path_p pretrain: the wrong layers moved")
    row["pretrain"] = {
        "updater": str(net.conf.updater), "rbms": n_rbm,
        "batches_a_layer": pretrain_batches, "steps": steps,
        "launches": {k: launches[k] for k in ("nesterov_update",
                                              "adam_update")},
        "ms_per_step": e0.elapsed_time(e1) / steps, "wall_s": wall,
        "host_pass_ms": pass_ms, "losses": losses}
    flat = net.params()

    x = next(iter(MnistDataSetIterator(batch, num_examples=batch,
                                       seed=1))).features
    ds = DataSet(x, x)
    row["solvers"] = {}
    for algo in ("line_gradient_descent", "lbfgs"):
        MultiLayerNetwork(deep_ae_conf(algo=algo, iterations=2),
                          device="cuda").init().fit(ds, batch_size=batch)
        sn = MultiLayerNetwork(deep_ae_conf(algo=algo,
                                            iterations=solver_iterations),
                               device="cuda").init()
        sn.set_params(flat)
        check(torch.equal(sn.params(), flat),
              f"path_p {algo}: set_params did not load params()")
        before = sn.score(ds)
        torch.cuda.synchronize()
        reset_all_counts()
        e0.record()
        t0 = time.perf_counter()
        sn.fit(ds, batch_size=batch)
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = sn._solver.last_history.cpu().tolist()
        syncs = sn._solver.solver_syncs
        launches, plain = read_all_counts()
        check(sum(plain.values()) == 0 and not any(launches.values()),
              f"path_p {algo}: kernels {launches}, plain {plain}")
        check(len(hist) == solver_iterations and np.all(np.isfinite(hist)),
              f"path_p {algo}: history {hist}")
        check(all(b <= a for a, b in zip(hist, hist[1:])),
              f"path_p {algo}: the loss history rose: {hist}")
        check(hist[-1] < before, f"path_p {algo}: loss {before} -> "
              f"{hist[-1]}")
        traced = MultiLayerNetwork(deep_ae_conf(
            algo=algo, iterations=solver_iterations), device="cuda").init()
        traced.set_params(flat)
        t_wall, t_busy, t_idle = device_idle_share(
            lambda: traced.fit(ds, batch_size=batch))
        row["solvers"][algo] = {
            "iterations": solver_iterations, "score_before": before,
            "history": hist, "solver_syncs": syncs,
            "syncs_per_iteration": syncs / solver_iterations,
            "ms_per_iteration": e0.elapsed_time(e1) / solver_iterations,
            "wall_s": wall,
            "traced_busy_ms_per_iteration": t_busy / solver_iterations,
            "traced_wall_ms_per_iteration": t_wall / solver_iterations,
            "idle_share": t_idle}
        del sn, traced

    MultiLayerNetwork(vae_conf(), device="cuda").init().pretrain(
        MnistDataSetIterator(vae_batch, num_examples=vae_batch, seed=9))
    vnet = MultiLayerNetwork(vae_conf(), device="cuda").init()
    vname = vnet.conf.layers[0].name
    vdata = MnistDataSetIterator(vae_batch, num_examples=vae_batch
                                 * vae_steps, seed=2)
    torch.cuda.synchronize()
    reset_all_counts()
    e0.record()
    vnet.pretrain(vdata, epochs=1)
    e1.record()
    torch.cuda.synchronize()
    launches, plain = read_all_counts()
    elbo = [float(v) for v in vnet.pretrain_losses[vname]]
    check(sum(plain.values()) == 0, f"path_p vae: plain on CUDA {plain}")
    check(launches["adam_update"] == vae_steps,
          f"path_p vae: adam_update launched {launches['adam_update']} "
          f"times, want {vae_steps}")
    check(len(elbo) == vae_steps and np.all(np.isfinite(elbo))
          and np.mean(elbo[-4:]) < np.mean(elbo[:4]),
          f"path_p vae: negative ELBO {elbo}")
    row["vae"] = {"widths": [784, 256, 256, 2, 256, 256, 784],
                  "batch": vae_batch, "steps": vae_steps,
                  "updater": str(vnet.conf.updater),
                  "launches": launches["adam_update"],
                  "ms_per_step": e0.elapsed_time(e1) / vae_steps,
                  "neg_elbo": elbo}
    del vnet

    encoder = [{k: v.detach().clone() for k, v in
                net.params_tree[layer.name].items()}
               for layer in net.conf.layers[:5]]
    del net
    ft = finetune_net("cuda", encoder)
    head = ft.conf.layers[-1].name
    groups = _updater_groups(ft._layer_updaters)
    check([names for _, names in groups] == [[head]],
          f"path_p finetune: updater groups {groups}")
    frozen = {l.name: {k: v.clone() for k, v in ft.params_tree[l.name]
                       .items()} for l in ft.conf.layers[:-1]}

    def ft_data():
        return MnistDataSetIterator(batch, num_examples=4 * batch, seed=3)

    fit = timed_fit("path_p finetune", ft, ft_data(), 3, batch,
                    unit="images", per_epoch=4)
    check(fit["launches"]["adam_update"] == fit["steps"],
          f"path_p finetune: adam_update launched "
          f"{fit['launches']['adam_update']} times, want {fit['steps']}")
    check(all(torch.equal(v, frozen[n][k]) for n in frozen
              for k, v in ft.params_tree[n].items()),
          "path_p finetune: a frozen leaf moved")
    centers = ft.state_tree[head]["centers"]
    check(bool(centers.abs().sum() > 0), "path_p finetune: centers at 0")
    head_elems = sum(v.numel() for v in ft.params_tree[head].values())
    row["finetune"] = {
        "frozen_layers": len(frozen), "head": "CenterLossOutputLayer(10)",
        "trained_elements": head_elems,
        "frozen_elements": sum(v.numel() for d in frozen.values()
                               for v in d.values()),
        "centers_abs_sum": float(centers.abs().sum()),
        **{k: fit[k] for k in ("steps", "images_per_s_steps_5_12",
                               "step_ms_p50", "epoch_mean_loss",
                               "launches")}}
    del ft
    kp = k_parity("path_p_finetune", lambda: finetune_net("cuda", encoder),
                  ft_data, batch, ("adam_update",), unit="images",
                  per_epoch=4)
    row["finetune"]["k4_bit_equal_k1"] = kp["k4_bit_equal_k1"]
    row["launches"] = {
        "nesterov_update": row["pretrain"]["launches"]["nesterov_update"],
        "adam_update": row["vae"]["launches"]
        + fit["launches"]["adam_update"]}
    row["nvidia_smi"] = gpu_name_and_limit()
    emit(row)
    torch.cuda.empty_cache()
    return row


def p_parity(width=64, batch=64, tol_param=1e-5, tol_loss=1e-5,
             tol_act=1e-6):
    """path_p's arithmetic on the card against the CPU, TF32 off, the
    same seeded weights: two AutoEncoders of width 64 (corruption 0)
    under a 10-class output, pretrained 8 steps (4 batches of 64 a
    layer) under Adam (ε 1e-3, as `lenet_parity`): every parameter
    within `tol_param`; a 2-layer width-64 net's first 5
    line_gradient_descent iterations on one batch: losses within
    `tol_loss` relative; every activation name (and the parametrised
    forms), forward and gradient, within `tol_act` of the CPU's (relative
    above 1 in magnitude, absolute below)."""
    from deeplearning4j_tpu_torch.data import DataSet, MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.activations import Activation
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        AutoEncoder, DenseLayer, OutputLayer,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam, tree_leaves

    row = {"phase": "p_parity", "width": width, "batch": batch}
    ae = (NeuralNetConfiguration.builder().seed(11)
          .updater(Adam(1e-3, epsilon=1e-3)).activation("sigmoid")
          .list(AutoEncoder(n_out=width, corruption_level=0.0),
                AutoEncoder(n_out=width, corruption_level=0.0),
                OutputLayer(n_out=10, activation="softmax"))
          .set_input_type(InputType.feed_forward(784)).build())
    leaves = {}
    for d in ("cuda", "cpu"):
        net = MultiLayerNetwork(ae, device=d).init()
        reset_all_counts()
        net.pretrain(MnistDataSetIterator(batch, num_examples=4 * batch,
                                          seed=4), epochs=1)
        if d == "cuda":
            launches, plain = read_all_counts()
            check(launches["adam_update"] == 8 and not sum(plain.values()),
                  f"p_parity pretrain: launches {launches}, plain {plain}")
        leaves[d] = [t.float().cpu() for t in tree_leaves(net.params_tree)]
    dp = max((a - b).abs().max().item()
             for a, b in zip(leaves["cuda"], leaves["cpu"]))
    check(dp <= tol_param, f"p_parity pretrain: parameters differ by {dp}")
    row["pretrain"] = {"steps": 8, "max_param_abs_err": dp}

    gd = (NeuralNetConfiguration.builder().seed(12)
          .optimization_algo("line_gradient_descent", 5)
          .list(DenseLayer(n_out=width, activation="tanh"),
                OutputLayer(n_out=10, activation="softmax"))
          .set_input_type(InputType.feed_forward(784)).build())
    ds = next(iter(MnistDataSetIterator(batch, num_examples=batch, seed=5)))
    hist = {}
    for d in ("cuda", "cpu"):
        net = MultiLayerNetwork(gd, device=d).init()
        net.fit(DataSet(ds.features, ds.labels), batch_size=batch)
        hist[d] = net._solver.last_history.cpu().tolist()
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist["cuda"], hist["cpu"]))
    check(rel <= tol_loss, f"p_parity solver: histories {hist} differ by "
          f"{rel} relative")
    row["line_gradient_descent"] = {"iterations": 5, "histories": hist,
                                    "loss_rel_err": rel}

    gen = torch.Generator().manual_seed(6)
    x = (torch.rand((64, 33), generator=gen) * 6 - 3)
    w = torch.randn((64, 33), generator=gen)
    worst = {}
    for name in Activation.names() + ["leakyrelu:0.2", "elu:0.5",
                                      "clippedrelu:2.5",
                                      "thresholdedrelu:0.7"]:
        f = Activation.get(name)
        got = {}
        for d in ("cuda", "cpu"):
            xd = x.to(d).requires_grad_(True)
            y = f(xd)
            g, = torch.autograd.grad((y * w.to(d)).sum(), xd)
            got[d] = (y.detach().cpu(), g.cpu())
        err = max(((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
                  for a, b in zip(got["cuda"], got["cpu"]))
        check(err <= tol_act, f"p_parity activation {name}: {err}")
        worst[name] = err
    row["activations"] = {"names": len(worst),
                          "max_err": max(worst.values()), "by_name": worst}
    emit(row)
    return row


def path_m_async(epochs=3, batch=1024, per_epoch=4, reps=3):
    """`path_m`'s LeNet (bfloat16, Adam(1e-3), batch 1024, 12 steps) at K
    1 and K 4, each fed by the bare `MnistDataSetIterator` and by
    `AsyncDataSetIterator(MnistDataSetIterator(...), prefetch=2)` (DL4J's
    fit wrap), `reps` times in alternating order (bare first on even
    repeats), on PyTorch's deterministic algorithms: every run's losses
    bit-equal to the first bare run's at the same K (the same batches in
    the same order), B1a once a step. Each run records images/s and the
    host's split of a step: the source iterator's `reset()` (its
    reshuffle) and `next()` (a slice) in whichever thread iterates it,
    the pump's or the fit loop's; the fit loop's wait for each batch
    (the executor's `etl_ms`, an epoch's first batch apart from the
    rest); its enqueue time each step (`train_dispatch_ms`); the pump's
    prefetch hit ratio. The first repeat of each is then traced for
    another 3 epochs (`device_idle_share`): wall and busy ms a step and
    the idle share. A measurement, not a bar: whether the pump moves the
    idle share, and what holds the card back."""
    from deeplearning4j_tpu_torch.data import (
        AsyncDataSetIterator, DataSetIterator, MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observe import get_registry

    class Timed(DataSetIterator):
        """`base` with the host ms of each `reset()` and `next()`."""

        def __init__(self, base):
            self._base = base
            self.reset_ms, self.next_ms = [], []

        def reset(self):
            t0 = time.perf_counter()
            self._base.reset()
            self.reset_ms.append((time.perf_counter() - t0) * 1e3)

        def __next__(self):
            t0 = time.perf_counter()
            d = next(self._base)
            self.next_ms.append((time.perf_counter() - t0) * 1e3)
            return d

        @property
        def batch_size(self):
            return self._base.batch_size

        @property
        def num_outcomes(self):
            return self._base.num_outcomes

    reg = get_registry()
    hits = reg.counter("prefetch_hits_total", stage="async")
    misses = reg.counter("prefetch_misses_total", stage="async")
    dispatch = reg.histogram("train_dispatch_ms")
    row = {"phase": "path_m_async", "model": "LeNet", "batch": batch,
           "dtype": "bfloat16", "prefetch": 2, "reps": reps}
    launches = {"adam_update": 0, "nesterov_update": 0}
    for k in (1, 4):
        runs = {"bare": [], "async": []}
        for rep in range(reps):
            for tag in ("bare", "async")[::1 if rep % 2 == 0 else -1]:
                src = Timed(MnistDataSetIterator(
                    batch, num_examples=per_epoch * batch, seed=0))
                it = AsyncDataSetIterator(src, prefetch=2) \
                    if tag == "async" else src
                net = MultiLayerNetwork(lenet_conf(), device="cuda").init()
                h0, m0 = hits.value, misses.value
                c0 = dispatch.count
                with deterministic():
                    fit = timed_fit(f"path_m_async {tag} k{k} rep {rep}",
                                    net, it, epochs, batch, unit="images",
                                    per_epoch=per_epoch, k=k)
                check(fit["launches"]["adam_update"] == fit["steps"],
                      f"path_m_async {tag} k{k}: adam_update launched "
                      f"{fit['launches']['adam_update']} times")
                if tag == "async":
                    for kern in launches:
                        launches[kern] += fit["launches"][kern]
                dh, dm = hits.value - h0, misses.value - m0
                etl = fit["etl_ms"]
                run = {
                    "images_per_s_steps_5_12":
                    fit["images_per_s_steps_5_12"],
                    "step_ms_p50": fit["step_ms_p50"],
                    "async_prefetch_hit_ratio": (dh / (dh + dm))
                    if dh + dm else None,
                    "etl_ms_first_of_epoch": etl[::per_epoch],
                    "etl_ms_others_p50": float(np.median(
                        [e for i, e in enumerate(etl) if i % per_epoch])),
                    "source_reset_ms": list(src.reset_ms),
                    "source_next_ms_p50": float(np.median(src.next_ms)),
                    "source_next_ms_max": max(src.next_ms),
                    # the fit loop's enqueue a step (at K 4 a window's
                    # over K: eager, capture, replay)
                    "dispatch_ms": dispatch.values()[c0 - dispatch.count:],
                    "graph_windows": fit["graph_windows"],
                    "losses": fit["losses"]}
                if rep == 0:
                    with deterministic():
                        wall, busy, idle = device_idle_share(
                            lambda: net.fit(it, epochs=epochs,
                                            steps_per_dispatch=k))
                    run.update(
                        traced_wall_ms_per_step=wall / (epochs * per_epoch),
                        traced_busy_ms_per_step=busy / (epochs * per_epoch),
                        idle_share=idle)
                if tag == "async":
                    it.close()
                runs[tag].append(run)
                del net
        want = runs["bare"][0]["losses"]
        check(all(r["losses"] == want
                  for r in runs["bare"][1:] + runs["async"]),
              f"path_m_async k{k}: a run's losses differ from the first "
              f"bare run's {want}")
        rate = "images_per_s_steps_5_12"
        row[f"k{k}"] = {**runs, "async_over_bare": [
            a[rate] / b[rate] for a, b in zip(runs["async"], runs["bare"])]}
    row["launches"] = launches
    row["nvidia_smi"] = gpu_name_and_limit()
    emit(row)
    torch.cuda.empty_cache()
    return row


# ------------------------------------ the CNN family and model import (A2b)
# card against CPU on the same weights: the largest |card - CPU| of the
# pre-softmax outputs over the largest |CPU| one (float32, TF32 off)
I_LOGIT_RTOL = 1e-5


def keras_vgg(rng, size=224, classes=1000, div=1):
    """A VGG16-shaped Keras Sequential configuration (five blocks of 3x3
    convolutions at 64-128-256-512-512 channels over `div`, max pools to
    7x7, a 4096-4096-`classes` dense head) with the slice's layers among
    its convolutions: DepthwiseConv2D and SeparableConv2D in blocks 1-3,
    and block 5 as UpSampling2D, a stride-2 Conv2D, a Conv2DTranspose
    (valid: truncate, p 0) and Cropping2D. Returns (the model's JSON,
    Keras layer name -> its weights in Keras's layouts, He-scaled,
    float32, from `rng`), and the index of the last convolution-stack
    layer among the port's layers (Flatten maps to none)."""
    def c(n):
        return max(n // div, 1)

    layers, weights = [], {}
    ch = [3]

    def he(shape, fan_in):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                ).astype(np.float32)

    def add(cls, cfg, w=None, out=None):
        name = f"{cls.lower()}_{len(layers)}"
        cfg = dict(cfg, name=name)
        if not layers:
            cfg["batch_input_shape"] = [None, size, size, 3]
        layers.append({"class_name": cls, "config": cfg})
        if w:
            weights[name] = w
        if out:
            ch[0] = out

    def conv(n, k=3, stride=1, padding="same"):
        add("Conv2D", {"filters": n, "kernel_size": [k, k],
                       "strides": [stride, stride], "padding": padding,
                       "activation": "relu", "use_bias": True},
            [he((k, k, ch[0], n), k * k * ch[0]),
             np.zeros(n, np.float32)], n)

    def pool():
        add("MaxPooling2D", {"pool_size": [2, 2], "strides": [2, 2],
                             "padding": "valid"})

    conv(c(64))
    add("DepthwiseConv2D", {"kernel_size": [3, 3], "strides": [1, 1],
                            "padding": "same", "depth_multiplier": 1,
                            "activation": "relu", "use_bias": True},
        [he((3, 3, ch[0], 1), 9), np.zeros(ch[0], np.float32)])
    pool()
    for n in (c(128), c(256)):
        add("SeparableConv2D", {"filters": n, "kernel_size": [3, 3],
                                "strides": [1, 1], "padding": "same",
                                "depth_multiplier": 1, "activation": "relu",
                                "use_bias": True},
            [he((3, 3, ch[0], 1), 9), he((1, 1, ch[0], n), ch[0]),
             np.zeros(n, np.float32)], n)
        conv(n)
        if n == c(256):
            conv(n)
        pool()
    for _ in range(3):
        conv(c(512))
    pool()                                          # 14
    add("UpSampling2D", {"size": [2, 2]})           # 28
    conv(c(512), stride=2, padding="valid")         # 13
    n = c(512)
    add("Conv2DTranspose", {"filters": n, "kernel_size": [3, 3],
                            "strides": [1, 1], "padding": "valid",
                            "activation": "relu", "use_bias": True},
        [he((3, 3, n, ch[0]), 9 * ch[0]), np.zeros(n, np.float32)], n)
    add("Cropping2D", {"cropping": [[1, 0], [1, 0]]})   # 15 -> 14
    pool()                                          # 7
    last_conv = len(layers) - 1
    add("Flatten", {})
    flat = ch[0] * (size // 32) ** 2
    for i, n in enumerate((c(4096), c(4096), classes)):
        fan = flat if i == 0 else c(4096)
        add("Dense", {"units": n, "use_bias": True,
                      "activation": "softmax" if n == classes else "relu"},
            [he((fan, n), fan), np.zeros(n, np.float32)])
    conf = {"class_name": "Sequential", "config": {"layers": layers}}
    return json.dumps(conf), weights, last_conv


def logit_conf(conf):
    """`conf` with its output layer's activation set to identity: the
    same net's pre-softmax outputs (a graph's first output)."""
    def ident(layer):
        return dataclasses.replace(layer, activation="identity")

    if hasattr(conf, "vertices"):
        out = conf.network_outputs[0]
        v = conf.vertices[out]
        return dataclasses.replace(conf, vertices={
            **conf.vertices, out: dataclasses.replace(v, layer=ident(v.layer))})
    return dataclasses.replace(
        conf, layers=(*conf.layers[:-1], ident(conf.layers[-1])))


def card_vs_cpu_gaps(net, x):
    """The card's outputs of `x` against the CPU's (plain versions) on
    the net's trained weights and running statistics, copied into twins
    of its configuration: (largest |card - CPU| of `output(x)`, largest
    |card - CPU| of the pre-softmax outputs over the largest |CPU| one,
    that largest |CPU| one). The pre-softmax outputs come from twins
    whose output layer's activation is identity (`logit_conf`), on the
    card and on the CPU."""
    from deeplearning4j_tpu_torch.models.convert import (
        params_from_numpy, state_from_numpy,
    )
    from deeplearning4j_tpu_torch.utils.pytrees import tree_to_numpy

    params = tree_to_numpy(net.params_tree)
    state = tree_to_numpy(net.state_tree)

    def twin(conf, device):
        t = type(net)(conf, device=device).init()
        params_from_numpy(t, params)
        state_from_numpy(t, state)
        return t

    def out(n):
        y = n.output(x)
        y = y[0] if isinstance(y, (list, tuple)) else y
        check(bool(torch.isfinite(y).all()), f"{n.device} output not finite")
        return y.float().cpu()

    card, cpu = out(net), out(twin(net.conf, "cpu"))
    check(tuple(card.shape) == tuple(cpu.shape),
          f"output shapes {tuple(card.shape)} != {tuple(cpu.shape)}")
    lconf = logit_conf(net.conf)
    lcard, lcpu = out(twin(lconf, "cuda")), out(twin(lconf, "cpu"))
    scale = float(lcpu.abs().max())
    return (float((card - cpu).abs().max()),
            float((lcard - lcpu).abs().max()) / scale, scale)


def vgg_transfer(text, weights, last_conv, lr=1e-5):
    """`path_i`'s Keras VGG transfer on the card: `keras_vgg`'s
    configuration imported with its weights, its convolution stack
    frozen, its head's n_out replaced by 10 (Xavier), the head
    fine-tuned under Adam(`lr`)."""
    from deeplearning4j_tpu_torch.keras_import import (
        import_keras_configuration,
    )
    from deeplearning4j_tpu_torch.models.transfer import (
        FineTuneConfiguration, TransferLearning,
    )
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    src = import_keras_configuration(text, device="cuda", weights=weights)
    return (TransferLearning.builder(src)
            .fine_tune_configuration(FineTuneConfiguration(
                updater=Adam(lr)))
            .set_feature_extractor(last_conv)
            .n_out_replace(len(src.layers) - 1, 10, weight_init="xavier")
            .build())


def vgg_descent_probe(text, weights, last_conv, batch, lrs=(1e-5, 1e-7)):
    """One Adam step of the VGG transfer on `batch` at each of `lrs`,
    each from the imported weights: {lr: (the batch's loss before, after)}.
    Adam's first step is about lr·sign(g), so its first-order change of
    the loss is -lr·|g|_1: the smallest lr must lower the loss, or the
    gradient is wrong."""
    probe = {}
    for lr in lrs:
        net = vgg_transfer(text, weights, last_conv, lr)
        before = net.score(batch)
        net.fit([batch], epochs=1)
        probe[str(lr)] = [before, net.score(batch)]
        del net
        torch.cuda.empty_cache()
    low = probe[str(min(lrs))]
    check(low[1] < low[0], f"path_i_keras_vgg: one Adam step at lr "
          f"{min(lrs)} raised the batch's loss {low[0]} -> {low[1]}")
    return probe


def path_i_model(name, net, batches, epochs, kernel, frozen=(),
                 cpu_rows=2, **info):
    """`timed_fit` of one path_i model: `kernel` (B1a or B1b) once a
    step and the other updater kernel never; finite losses; the tensors
    of the `frozen` layers bit-equal after the fit; then the card's
    pre-softmax outputs of `cpu_rows` images against the CPU's
    (`card_vs_cpu_gaps`), held to `I_LOGIT_RTOL`."""
    other = {"adam_update": "nesterov_update",
             "nesterov_update": "adam_update"}[kernel]
    before = {(n, k): t.clone() for n in frozen
              for k, t in net.params_tree[n].items()}
    batch = batches[0].features.shape[0]
    with b1_host_clock() as (host_ms, parts):
        fit = timed_fit(name, net, batches, epochs, batch, unit="images",
                        loss_must_fall=False)
    steps, launches = fit["steps"], fit["launches"]
    check(launches[kernel] == steps,
          f"{name}: {kernel} launched {launches[kernel]} times, want one "
          f"a step x {steps}")
    check(launches[other] == 0, f"{name}: {other} launched "
          f"{launches[other]} times")
    frozen_equal = all(torch.equal(net.params_tree[n][k], t)
                       for (n, k), t in before.items())
    check(frozen_equal, f"{name}: a frozen tensor moved")
    gap, logit_gap, scale = card_vs_cpu_gaps(
        net, batches[0].features[:cpu_rows])
    check(logit_gap <= I_LOGIT_RTOL, f"{name}: card and CPU pre-softmax "
          f"outputs differ by {logit_gap} of their largest |value| {scale}")
    b1 = b1_step_share(net, batches[:2], host_ms, parts,
                       fit["step_ms_p50"])
    updater = net.layers[-1].updater if hasattr(net, "layers") else None
    row = {"phase": name, **info, "batch": batch, "dtype": "float32",
           "updater": str(updater or net.conf.updater), "steps": steps,
           "step_ms_p50": fit["step_ms_p50"], "step_ms_max":
           fit["step_ms_max"], "step_ms_first": fit["step_ms_first"],
           "images_per_s": batch * (steps - 1)
           / (sum(fit["step_ms"][1:]) / 1e3),
           "adam_update_launches": launches["adam_update"],
           "nesterov_update_launches": launches["nesterov_update"],
           "losses": fit["losses"], "losses_finite": True,
           "frozen_tensors": len(before),
           "frozen_bit_equal": frozen_equal if before else None,
           "max_output_abs_err_card_vs_cpu": gap,
           "logit_rel_err_card_vs_cpu": logit_gap,
           "logit_max_abs_cpu": scale, "tol_logit_rel": I_LOGIT_RTOL,
           "cpu_rows": cpu_rows,
           "max_memory_allocated_bytes": fit["max_memory_allocated_bytes"],
           **b1,
           "launches": {k: launches[k] for k in ("adam_update",
                                                 "nesterov_update")}}
    emit(row)
    return row


@contextlib.contextmanager
def b1_host_clock():
    """Times every `Adam` / `Nesterovs.update_with_params` call on the
    host clock (ms, in call order) while the block runs: the B1 part of
    a K 1 step the host waits for (the call's launches, not the card);
    and, inside those calls, its parts, each summed over a call: finding
    the plans (`leaf_plans`), checking the gradients
    (`UpdatePlan._check_grads`) and the B1 launches with their checks
    (`UpdatePlan.launch`). Yields (call ms, {part: ms a call})."""
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs

    times, parts, saved = [], {}, []

    def clocked(owner, attr, sink):
        orig = getattr(owner, attr)
        saved.append((owner, attr, orig))

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            sink((time.perf_counter() - t0) * 1e3)
            return out
        setattr(owner, attr, timed)

    current = {}

    def part(name):
        def add(ms):
            current[name] = current.get(name, 0.0) + ms
        return add

    def call(ms):
        times.append(ms)
        for name, v in current.items():
            parts.setdefault(name, []).append(v)
        current.clear()

    for cls in (Adam, Nesterovs):
        clocked(cls, "update_with_params", call)
    clocked(fu, "leaf_plans", part("plan_lookup"))
    clocked(fu.UpdatePlan, "_check_grads", part("grad_check"))
    clocked(fu.UpdatePlan, "launch", part("launch"))
    try:
        yield times, parts
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def b1_step_share(net, batches, host_ms, parts, step_ms):
    """B1's share of a K 1 step: its host ms a step (`b1_host_clock` over
    the timed fit, the steps after the first: the first builds the
    plans) with its parts' medians, and its device ms a step from a
    `torch.profiler` trace of
    `len(batches)` more steps (the B1a/B1b kernels and `adam_lrbc`),
    beside the traced steps' busy time and the untraced step's p50."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(batches, epochs=1)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = kernel_events(path)
    steps = len(batches)
    check(bool(kernels), "b1_step_share: the profiler saw no kernels")
    b1 = sum(e["dur"] for e in kernels
             if "AdamRule" in e["name"] or "NesterovRule" in e["name"]
             or "adam_lrbc" in e["name"]) / 1e3 / steps
    busy = busy_us(kernels) / 1e3 / steps
    later = host_ms[1:] or host_ms
    return {"b1_host_ms_per_step": float(np.median(later)),
            "b1_host_ms_parts_per_step": {
                k: float(np.median(v[1:] or v)) for k, v in parts.items()},
            "b1_host_ms_first_step": host_ms[0],
            "b1_device_ms_per_step": b1,
            "b1_traced_busy_ms_per_step": busy,
            "b1_share_of_step_p50": max(float(np.median(later)), b1)
            / step_ms,
            "b1_device_share_of_busy": b1 / busy}


def path_i(rng):
    """GoogLeNet, InceptionResNetV1, AlexNet at their published widths
    and the Keras VGG16-shaped transfer (module docstring, 22)."""
    from deeplearning4j_tpu_torch import zoo

    rows = {}
    for key, model, size, batch, n, epochs, kernel in (
            ("googlenet", zoo.GoogLeNet, 224, 32, 3, 2, "nesterov_update"),
            ("inception_resnet_v1", zoo.InceptionResNetV1, 160, 32, 2, 2,
             "adam_update"),
            ("alexnet", zoo.AlexNet, 224, 64, 3, 2, "nesterov_update")):
        net = model(num_classes=1000, input_shape=(size, size, 3)).init(
            device="cuda")
        rows[key] = path_i_model(
            f"path_i_{key}", net, image_batches(rng, n, batch, size, 1000),
            epochs, kernel, model=model.__name__,
            input=[size, size, 3], classes=1000)
        del net
        torch.cuda.empty_cache()

    text, weights, last_conv = keras_vgg(rng)
    vgg_batches = image_batches(rng, 3, 32, 224, 10)
    probe = vgg_descent_probe(text, weights, last_conv, vgg_batches[0])
    net = vgg_transfer(text, weights, last_conv)
    frozen = [l.name for l in net.layers if l.frozen]
    check(len(frozen) == last_conv + 1,
          f"path_i_keras_vgg: {len(frozen)} frozen layers")
    kinds = sorted({type(l).__name__ for l in net.layers})
    for k in ("Cropping2DLayer", "Deconvolution2DLayer",
              "DepthwiseConvolution2DLayer", "SeparableConvolution2DLayer",
              "Upsampling2DLayer"):
        check(k in kinds, f"path_i_keras_vgg: no {k} among {kinds}")
    rows["keras_vgg"] = path_i_model(
        "path_i_keras_vgg", net, vgg_batches, 2,
        "adam_update", frozen=frozen, model="Keras VGG16-shaped Sequential",
        input=[224, 224, 3], classes=10, frozen_layers=len(frozen),
        layer_kinds=kinds, params=net.num_params(), descent_probe=probe)
    del net
    torch.cuda.empty_cache()
    return {"rows": rows,
            "launches": {k: sum(r["launches"][k] for r in rows.values())
                         for k in ("adam_update", "nesterov_update")}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0, "built": built})

    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.ops import lstm as lk
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = [run_kernel_case(c, flush, gen) for c in kernel_cases()]
    run_b6_repeat(gen)
    run_b5_repeat(gen)
    for c in flash_cases():
        rows += run_flash_case(c, flush, gen)
    rows += [run_banded_case(c, flush, gen) for c in banded_cases()]
    rows += run_adam_phase(flush, gen)
    rows += run_lrbc_phase(flush)
    rows += run_nesterov_phase(flush, gen)
    for c in lstm_cases():
        rows += run_lstm_case(c, flush, gen)
    bf16_gen = torch.Generator().manual_seed(18)
    for c in lstm_bf16_cases():
        rows += run_lstm_bf16_case(c, flush, bf16_gen)
    for c in b7_cases():
        for dt in (torch.float32, torch.bfloat16):
            rows.append(run_b7_case(c, dt, flush, gen))
            torch.cuda.empty_cache()
    run_b7_repeat(gen)
    data_gen = torch.Generator().manual_seed(25)
    for c in b7_data_cases():
        rows.append(run_b7_case(c, torch.float32, flush, data_gen))
        torch.cuda.empty_cache()
    run_flash_repeat(gen)
    cross_gen = torch.Generator().manual_seed(16)
    for c in cross_flash_cases():
        rows += run_flash_case(c, flush, cross_gen)
    del flush
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    a, *native_a = path_a("cuda", rng)
    b, *native_b = path_b("cuda", rng)
    cpu_parity(rng)
    qa, qb_fp8, qb_int8 = path_q(native_a, native_b)
    ph, ph_direct = path_h(native_a[0])
    ps = path_s(native_a[0], ph_direct, ph["http"])
    t32 = path_t(rng)
    train_parity(rng)
    t = path_t(rng, dtype="bfloat16")
    # batches of their own: the shared stream stays as the phases after
    # it have always drawn from it
    bf16_batches = lm_batches(np.random.default_rng(14), 4, 8, 2048)
    k_parity("path_t_bf16",
             lambda: build_net("cuda", num_blocks=6, seed=5,
                               dtype="bfloat16"),
             lambda: bf16_batches, 8 * 2048,
             FLASH_KERNELS + ("adam_update",))
    del bf16_batches
    train_parity(rng, "train_parity_bf16", **TRAIN_PARITY_BF16)
    w = path_w(rng)
    train_parity(rng, "window_parity", "banded_attention", window=32,
                 **LLAMA)
    lp = path_l(rng)
    g, g_batches = path_g(rng)
    lstm_parity(rng)
    # the recurrent paths of slice 18 draw from streams of their own: the
    # shared one stays as the phases after them have always drawn from it
    ls = path_ls(np.random.default_rng(18))
    gt = path_gt(g_batches)
    del g_batches
    s2s = path_s2s(np.random.default_rng(19))
    lb = path_l_bf16(np.random.default_rng(20))
    bf16_rng = np.random.default_rng(21)
    train_parity(bf16_rng, "lstm_parity_bf16", "lstm_fwd_bf16",
                 build=lambda d: build_lstm_net(d, seed=23,
                                                dtype="bfloat16"),
                 batch=seq_batches(bf16_rng, 1, 8, 32, 128, 64,
                                   masked=(0,)),
                 **TRAIN_PARITY_BF16)
    images = image_batches(rng, 4, 128, 224, 1000)
    r = path_r(images)
    path_r(images, fused=False)
    r32 = path_r(images, dtype="float32")
    path_r(images, fused=False, dtype="float32")
    del images
    resnet_parity(rng)
    m = path_m()
    path_m_k()
    lenet_parity(rng)
    host_overhead()
    graph_parity(rng)
    gen = path_gen(rng)
    ckpt = path_ckpt()
    xa = path_x(rng)
    pp = path_p()
    p_parity()
    ma = path_m_async()
    pi = path_i(np.random.default_rng(22))

    b5q = {"banded_decode_attention_q":
           qb_fp8["launches"]["banded_decode_attention_q"]
           + qb_int8["launches"]["banded_decode_attention_q"]}
    summary = []
    for name, launches in (
            ("banded_decode_attention", b["launches"]),
            ("paged_decode_attention", a["launches"]),
            ("banded_decode_attention_q", b5q),
            ("paged_decode_attention_q", qa["launches"]),
            ("banded_attention", w["launches"]),
            ("flash_attention_fwd", t["launches"]),
            ("flash_attention_bwd_dkdv", t["launches"]),
            ("flash_attention_bwd_dq", t["launches"]),
            ("adam_update", t32["launches"]),
            ("nesterov_update", lp["launches"]),
            ("adam_lrbc", t32["launches"]),
            ("lstm_fwd", lp["launches"]),
            ("lstm_fwd_inference", g["launches"]),
            ("lstm_bwd", lp["launches"]),
            ("lstm_bwd_weights", lp["launches"]),
            ("lstm_fwd_bf16", lb["launches"]),
            ("lstm_fwd_inference_bf16", lb["launches"]),
            ("lstm_bwd_bf16", lb["launches"]),
            ("lstm_bwd_weights_bf16", lb["launches"])):
        mine = [r for r in rows if r["kernel"] == name]
        mains = [r for r in mine if r["main_path_shape"]]
        # the flash kernels: path_t_bf16's row (this slice's path), with
        # path_t's float32 row beside it
        main_row = mains[-1]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
        if name == "paged_decode_attention":
            summary[-1]["launches_path_h"] = ph["launches"][name]
        if name == "banded_decode_attention":
            summary[-1].update(
                launches_path_gen=gen["greedy"]["launches"][name],
                launches_path_gen_nucleus=gen["nucleus"]["b5_launches"],
                launches_path_gen_beam=gen["beam"]["b5_launches"],
                launches_path_gen_ring=gen["ring"]["launches"][name])
        if name == "lstm_fwd_inference":
            summary[-1]["launches_path_gen"] = \
                gen["lstm_graph"]["b2b_launches"]
            summary[-1]["launches_path_ls"] = ls["launches"][name]
            summary[-1]["launches_path_s2s"] = s2s["output_launches"]
        if name in ("lstm_fwd", "lstm_bwd", "lstm_bwd_weights",
                    "adam_update"):
            summary[-1]["launches_path_gt"] = gt["launches"][name]
            summary[-1]["launches_path_s2s"] = s2s["launches"][name]
        if name in FLASH_KERNELS + ("adam_update",):
            summary[-1]["launches_path_ckpt"] = ckpt["launches"][name]
            summary[-1]["launches_path_x"] = xa["launches"][name]
        at_x = [r for r in mine if r.get("path_x_shape")]
        if at_x:
            # path_x's cross-attention shape: non-causal, Tq 2048, Tk 1024
            summary[-1]["path_x_shape"] = [{k: r[k] for k in (
                "dtype", "tq", "tk", "design", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "bound_share",
                "max_abs_err")} for r in at_x]
        if name in FLASH_KERNELS:
            summary[-1]["launches_path_h"] = ph["flash_launches"][name]
        at_s = [r for r in mine if r.get("path_s_shape")]
        if at_s:
            # the slot pools path_s decodes from: Hkv 8, linear, L 2048
            summary[-1]["path_s_shape"] = {k: at_s[0][k] for k in (
                "kv_dtype", "Hkv", "mode", "L", "design", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "bound_share",
                "max_abs_err")}
        if name == "banded_decode_attention":
            summary[-1]["launches_path_s"] = ps["launches"][name]
            summary[-1]["launches_path_s_silenced"] = \
                ps["silenced"]["launches"]
        if name == "banded_decode_attention_q":
            summary[-1]["launches_path_s_int8"] = ps["int8"]["launches"]
            summary[-1]["launches_path_s_silenced_int8"] = \
                ps["silenced_int8"]["launches"]
        if name in ("adam_update", "nesterov_update"):
            summary[-1]["launches_path_p"] = pp["launches"][name]
            summary[-1]["launches_path_m_async"] = ma["launches"][name]
            summary[-1]["launches_path_i"] = pi["launches"][name]
        if name in ("adam_update", "nesterov_update"):
            # both designs (design 2 is "persistent") and the
            # updater's own call, at the main path's shape and over
            # path_i's updates, each over its model's leaves
            b1_keys = ("design", "multi_ms", "persistent_ms",
                       "speedup_over_multi", "bound_share", "host_ms",
                       "host_ms_plan_lookup", "host_ms_grad_leaves",
                       "host_ms_grad_check", "updater_ms",
                       "updater_launches")
            summary[-1].update({k: main_row[k] for k in b1_keys})
            fit = t32 if name == "adam_update" else lp
            summary[-1]["launches_by_design"] = {
                d: fit["b1_launches_by_design"][f"{name}/{d}"]
                for d in B1_DESIGNS}
            summary[-1]["path_i"] = [{k: r[k] for k in (
                "leaves", "dtype", "elements", "n_leaves", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err") + b1_keys}
                for r in mine if r["leaves"] in PATH_I_LEAVES]
            summary[-1]["path_i_steps"] = {
                key: {k: row[k] for k in row if k.startswith("b1_")}
                for key, row in pi["rows"].items()}
            summary[-1]["misaligned"] = [
                {k: r[k] for k in ("dtype", "multi_ms", "persistent_ms",
                                   "max_abs_err")}
                for r in mine if r["misaligned"]]
        if name == "nesterov_update":
            rbm = next(r for r in mine if r["leaves"] == "rbm")
            summary[-1]["path_p"] = {k: rbm[k] for k in (
                "dtype", "elements", "n_leaves", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        if name == "adam_update":
            keys = ("dtype", "elements", "n_leaves", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "max_abs_err")
            lenet = next(r for r in mine if r["leaves"] == "lenet")
            summary[-1]["launches_path_m"] = m["launches"][name]
            summary[-1]["path_m"] = {k: lenet[k] for k in keys}
            # path_p's two updates: the VAE's pretrain step, the head's
            summary[-1]["path_p"] = [
                {"leaves": r["leaves"], **{k: r[k] for k in keys}}
                for r in mine if r["leaves"] in ("vae", "head")]
        if name in FLASH_KERNELS:
            f32 = mains[0]
            summary[-1].update(
                {k: main_row[k] for k in ("dtype", "design", "tflops",
                                          "bound_share", "ffma_ms",
                                          "speedup_over_ffma")
                 if k in main_row},
                launches_by_design={
                    d: t["launches_by_design"][f"{name}/{d}"]
                    for d in ("ffma", "wgmma", "tf32x3")},
                # path_t's float32 row: B3a-c on design 3 (3xTF32)
                # beside design 1 on the same inputs, each against its
                # own bound, and the guard against a float64 forward (o
                # and lse) or backward
                float32={**{k: f32.get(k) for k in (
                    "design", "ms", "plain_ms", "library_ms",
                    "library_kernels", "bound_ms", "bound_by",
                    "bound_rate_tflops", "bound_share", "ffma_ms",
                    "speedup_over_ffma", "ffma_bound_ms",
                    "ffma_bound_share", "f64_share", "ffma_f64_share",
                    "guard_ratio", "max_abs_err")},
                    "launches_path_t": t32["launches"][name],
                    "launches_path_t_by_design": {
                        d: t32["launches_by_design"][f"{name}/{d}"]
                        for d in ("ffma", "wgmma", "tf32x3")}})
        if name.endswith("_bf16"):
            base = name[:-len("_bf16")]
            by = (lb["output_launches_by_design"]
                  if base == "lstm_fwd_inference"
                  else lb["launches_by_design"])
            summary[-1].update(
                {k: main_row[k] for k in main_row
                 if k in ("dtype", "design", "bound_share", "tflops")
                 or k.endswith("_bf16_ms") or k.endswith("share_differing")
                 or k.startswith("speedup_over_")},
                launches_by_design={
                    d + "_bf16": by[f"{base}/{d}_bf16"]
                    for d in lk.BF16_DESIGNS[base]},
                shapes=[{k: r[k] for k in (
                    "T", "B", "H", "design", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "max_abs_err")
                    if k in r} for r in mine])
        elif name in lk.LAUNCHES:
            by = (g["launches_by_design"] if name == "lstm_fwd_inference"
                  else lp["launches_by_design"])
            designs = lk.B2C_DESIGNS.get(name, lk.DESIGNS)
            summary[-1].update(
                {k: main_row[k] for k in main_row
                 if k in ("design", "bound_share")
                 or any(k == f"{d}_ms" or k == f"speedup_over_{d}"
                        for d in designs)},
                launches_by_design={d: by[f"{name}/{d}"] for d in designs})
        if "decode_attention" in name:
            by = {"paged_decode_attention": a, "paged_decode_attention_q": qa,
                  "banded_decode_attention": b}.get(name)
            by = by["launches_by_design"] if by else {
                k: qb_fp8["launches_by_design"][k]
                + qb_int8["launches_by_design"][k]
                for k in qb_fp8["launches_by_design"]}
            summary[-1].update(
                {k: main_row[k] for k in ("design", "bound_share", "ffma_ms",
                                          "speedup_over_ffma", "split_pages",
                                          "split_keys", "nsplit")
                 if k in main_row},
                launches_by_design={d: by[f"{name}/{d}"]
                                    for d in ("ffma", "split")})
            if name.endswith("_q"):
                e4m3 = next(r for r in mine if r["kv_dtype"] ==
                            "float8_e4m3fn")
                summary[-1]["e4m3"] = {k: e4m3[k] for k in (
                    "ms", "ffma_ms", "speedup_over_ffma", "plain_ms",
                    "library_ms", "bound_ms", "bound_share")}
        if name == "banded_attention":
            summary[-1].update(
                {k: main_row[k] for k in ("design", "bound_share", "ffma_ms",
                                          "speedup_over_ffma")},
                launches_by_design={
                    d: w["launches_by_design"][f"{name}/{d}"]
                    for d in ("ffma", "folded")},
                output_launches_by_design={
                    d: w["output_launches_by_design"][f"{name}/{d}"]
                    for d in ("ffma", "folded")})
        if name == "lstm_fwd_inference":
            # most of its launches on path_g are the stepping loop's, at T 1
            t1 = next(r for r in mine if r["T"] == 1)
            summary[-1].update({f"{k}_at_T1": t1[k] for k in (
                "ms", "design", "bound_ms", "bound_by", "library_ms")})
    for name in B7_KERNELS:
        # many shapes a step: the times are a path_r_f32 step's, summed
        # (this slice's path: design 3), with path_r's bfloat16 beside
        by32, by16 = (run["launches_by_design"] for run in (r32, r))
        summary.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": r32["launches"][name],
                        **b7_step_totals(rows, name, "float32"),
                        "launches_by_design": {
                            d: by32[f"{name}/{d}"] for d in cf.DESIGNS},
                        "bfloat16": {
                            **b7_step_totals(rows, name, "bfloat16"),
                            "launches_path_r": r["launches"][name],
                            "launches_by_design": {
                                d: by16[f"{name}/{d}"]
                                for d in cf.DESIGNS}}})
    for entry in summary:
        # a kernel with one design: all its launches are design 1's
        entry.setdefault("launches_by_design",
                         {"design 1": entry["launches"]})
    emit({"kernels": summary})
    print(gpu_name_and_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
