"""Smoke test of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port's main paths on a TinyLlama-1.1B-shaped Llama with Monarch
adapters on all seven projections (random seeded weights) through the
hand-written CUDA kernels, and checks them:

  1. device: a CUDA card of compute capability 9.0, its name and power limit;
  2. build: the kernels are compiled from ``kernels/csrc/`` in this checkout;
  3. forward kernels K1, K2 against their plain PyTorch versions at the
     slice's shapes, bfloat16 and float32, timed beside their bound and the
     one PyTorch call that computes the same function, summed a decoder
     layer at every row count of ROWS, each call's plan printed; then at
     ragged shapes (P and m no multiple of 8, L != K, Q != R) with x and
     base off 16 bytes;
  4. backward kernels K3, K4 likewise at the training shapes, on the
     cluster kernel of ``csrc/monarch_bwd.cu`` (its plan and launches a
     call, ptxas's registers and spills), and the
     autograd Functions of K1 and K2 (whose backward is K3);
  5. serving, float32: prefill logits and greedy tokens against a copy with
     the adapters merged on the CPU;
  6. serving, bfloat16: greedy decode timed, unmerged (K2) and merged (K1);
  7. training, float32, 2 layers: one optimizer step on the card against a
     CPU copy on the plain path, merged training off (K2, K3) and on (K4),
     with splash attention (K17 forward, K18 and K19 backward),
     and with remat "dots" against the same step without remat (K2 twice);
  8. training, bfloat16, all 22 layers, bs 4 x ga 8 x seq 512 through
     ``Trainer``: merged training off, then on from the same state on the
     same batches, timed and profiled; then with splash attention, merged
     off, from the same state on the same batches (K17-K19 528 launches
     each, the first loss against the einsum run's), timed and profiled;
     then with remat "dots" and "nothing" from the same state on the same
     batches, timed and profiled beside the run without remat (K2 twice an
     adapted linear and micro-batch, K3 once), one merged-on step under
     "dots" (K4 once) and one splash step under "nothing" (K17 twice);
  9. the quantized base: K7/K5 (forward) and K8/K6 (dx) against their plain
     versions at the slice's shapes, timed beside their bound and one
     PyTorch call on the dequantized matrix, and their autograd Functions;
     K5/K7 above 16 rows and K6/K8 in bf16 run the wgmma kernels of
     ``csrc/quant_wgmma.cu`` (int4 dequantized into B in shared memory,
     int8 into A in registers), whose four functions' SASS must hold HGMMA;
     K5/K7 at decode rows (``csrc/quant_matmul.cu``'s ``qgemv_kernel``, one
     launch a call) also timed cold, over weight sets past L2, beside
     ``F.linear`` cold and the launch floor, with each projection's plan and
     the registers of each instantiation (no local memory, two CTAs an SM);
     K5's and K7's tile forward and K6/K8 at in 1000, 1032 and 1096 (int4's
     h = in / 2 no multiple of 8) against their plain versions;
 10. quantized serving, float32, int8 and int4: prefill logits and greedy
     tokens against a copy whose codes were dequantized and whose adapters
     were merged on the CPU;
 11. quantized serving, bfloat16, timed: int8 unmerged (K7, K2), int8
     requantize-merged with the w8a8 head (K7), int4 unmerged (K5, K2);
     in each profiled decode step the wrappers count the decode kernel once
     an adapted linear, exactly; the profiler counts ``qgemv_kernel`` as
     often over the profiled steps, exactly (in a window padded at both
     ends, which keeps every record: ROADMAP C.10), and ``qsplit_sum``
     never;
 12. quantized training: one float32 step (2 layers) on the card against a
     CPU copy, int8 and int4; then 22-layer bfloat16 training over an int8
     base (``run_alpaca --bits 8``: K7 and K8 at training rows) and over an
     int4 base (``--bits 4``), each timed and profiled;
 13. the fused dense + Monarch linear: K9 (forward), K10 (dx) and K11 (the
     factor gradients, K4's kernel) against their plain versions at
     ``bench_more_linear``'s three Llama-7B and micro-bench shapes (bf16)
     and a ragged f32 case, timed beside their bound and one PyTorch call,
     each bf16 call's tile plan printed, HGMMA in the SASS of every bf16
     K9/K10 kernel (``csrc/more_linear.cu``'s ``fused_kernel``) and no spill
     in ptxas's report, the autograd Function against the plain
     composition, then the port of ``scripts/bench_more_linear.py`` (fused,
     hybrid and plain steps);
 14. the forward-tile experiments: K15 (the wgmma + TMA tiled matmul) at
     every tile and K12 (K1 at every row tile) against their plain versions
     at a ragged shape, K12 at every row tile equal to K1 at its own plan bit
     for bit, K15's SASS checked for HGMMA, then the ports of
     ``scripts/exp_matmul_tiles.py`` and ``scripts/exp_fwd_tile.py`` at
     2664 x 4096 -> 4096 (each variant checked, then timed);
 15. the dw experiments: K13 (K4's kernel at a row group) and K14 (K13 at
     256 rows) and K3/K4 through the fast path at blk_r 8 and 16 and through
     the generic kernel against their plain versions at a ragged shape,
     the plans at the experiments' and the bench's shapes, K13 and K14 bit
     for bit, then the ports of ``scripts/exp_dw_kernel.py`` and
     ``scripts/exp_merged_v3.py`` at 2664 x 4096 -> 4096 (each variant
     checked, then timed);
 16. the int4 dequant-arithmetic variants: K16 (K5's decode kernel
     ``qgemv_kernel`` with its per-cell arithmetic a parameter) in all
     seven variants against
     their plain versions at ragged shapes, f32mul bit for bit K5 at
     decode rows, then the port of ``scripts/exp_int4_dequant_variants.py``
     at its four shapes (each variant checked against its plain version
     and the JAX script's oracle bound, then timed);
 17. splash attention's kernels: K17 (causal flash-attention forward), K18
     (dq) and K19 (dk/dv) of ``csrc/flash_attention.cu`` against their
     plain versions at the attention bench's shape, the 1.1B training
     micro-batch's and ragged t, bf16 and f32, ptxas's report (no spill),
     HGMMA in the SASS of the persistent bf16 K17-K19, each bf16 shape's
     schedule, timed in bf16 beside their bound and SDPA (run with the
     kernels of 3 and 4);
     then the port of ``scripts/bench_attention.py`` after training (8);
 18. the Alpaca + MMLU harness (``scripts/run_alpaca.py``, as users run
     it): the tiny smoke Llama in float32 at ``--bits`` 16, 8 and 4 on the
     card against the same run on the CPU (the logged losses, eval_loss and
     the MMLU choice logits within 1e-4, launches exact), and at 16 with
     ``--pack=True`` likewise; a run resumed at step 2 (``--resume=True``)
     against a straight one, the losses within 1e-4; then at
     TinyLlama-1.1B widths (22 layers, bf16, random seeded weights through
     the harness's ``build`` seam) at ``--bits`` 16 and 4 with the harness's
     defaults but ga 4, and at 16 with ``--pack=True``: launches exact (K3
     1,232; K6 1,208), the wall and device-busy ms a step, the MMLU scoring and
     predict seconds, the peak memory, the packed rows and their token
     efficiency;
 19. the reasoning harness (``scripts/run_reasoning.py``): the tiny smoke
     Llama in float32 (``--dropout=0.0``) at ``-task math`` and ``-task
     alpaca --greedy_decoding=False`` (penalty 1.1, 5-gram bans) on the
     card against the CPU (losses within 1e-4, ``eval/*`` and generations
     equal, launches exact), ``-task gsm8k`` sampled (three evals under one
     seed equal) and ``beam_generate`` at 4 beams against a CPU copy of the
     trained model (equal tokens); then TinyLlama-1.1B widths from an
     HF-format directory written here (random seeded bf16 weights; the
     loaded tensors equal the written ones; kept for 23) with a byte-fallback
     BPE ``tokenizer.json`` written beside them (no tokenizer package:
     merges learned from the phase's prompts, 32000 ids), through which the
     harness tokenizes (each prompt decoded back from its ids): 2 steps of
     ``-task math`` with the harness's remat "nothing" and dropout 0.1 (K1
     twice an adapted linear and micro-batch, K3 once), its greedy eval and
     a beam-4 eval (beam-sample at temperature 0.1), launches exact (K2
     none: with dropout every forward takes K1), each step's wall, busy,
     idle share and peak memory, each eval's wall and busy a forward;
 20. the GLUE and AG News harnesses (``scripts/run_glue.py``,
     ``scripts/run_agnews.py``): the smoke recipes (RoBERTa CoLA, STS-B and
     MNLI, DeBERTa MRPC, AG News monarch) in float32 with dropout off on the
     card against the CPU (losses and eval_loss within 1e-4, metrics and
     TSV files equal, launches exact: K2 and K3 only); then RoBERTa-large
     and DeBERTa-v3-base from HF-format directories written here (random
     seeded float32 weights; the loaded tensors equal the written ones;
     deleted after), 3 bf16 steps of each's CoLA recipe through the
     harness (launches exact, step wall, busy, idle share and peak), its
     eval and predictions timed alone, and K2/K3 timed at the run's rows
     beside their bound and ``addmm``;
 21. the paper's baselines, SVD projection and the search through the
     harnesses: smoke (float32, dropout off, BOFT's too) on the card
     against the CPU, ``run_glue`` with ``--lora`` and ``--boft`` (no kernel
     of ours), ``--svd_init`` (K2, K3) and ``--adapter=False`` (projection:
     K1, K3) on CoLA, STS-B and DeBERTa's MRPC, the reference orientation
     with svd_init from a written peft config, ``--do_tune`` on STS-B (3
     trials in two rungs: the same trials, budgets and best, every metric
     finite, no trial failed), ``run_agnews --method lora`` and
     ``run_alpaca --adapter=lora`` (launches exact: none under LoRA and
     BOFT); the reference orientation's identity product (K1) on the card
     at 1024 wide against the CPU;
 22. the recipes of the paper's GLUE table at RoBERTa-large width, from
     20's HF-format directory (kept for 23), bf16, 3 steps each with the
     harness's eval and predictions: LoRA, BOFT, Monarch with svd_init (K2
     72 times a forward, K3 72 times a step) and in projection mode (32
     blocks of 32: K1 72 times a forward, K3 72 times a step); launches
     exact, each run's init s (the SVD on the card), step wall, busy, idle
     share and peak;
 23. ReFT through the reasoning harness: smoke (float32, dropout off) on
     the card against the CPU with Loreft (untied f7+l7), Noreft, Consreft
     and MoRe interventions over the Monarch adapters (losses, results,
     generations and Loreft's beam-4 eval equal; K2 and K3 exact), the
     Loreft model through its three checkpoint formats, MoReFT GLUE on the
     tiny RoBERTa and DAS on the toy MLP (no kernel of ours); then the
     LoReFT commonsense recipe (Loreft rank 8, f7+l7 tied, all 22 layers)
     over 19's TinyLlama-1.1B-width directory and moreft_glue.sh's recipe
     over 20's RoBERTa-large directory (both deleted after), 3 steps each:
     launches exact, step wall, busy, idle share, peak, decode wall and
     busy a forward;
 24. the other decoder families: tiny GPT-2, GPT-Neo, GPT-NeoX and
     Backpack-GPT-2 HF-format directories through the Alpaca harness and a
     tiny Gemma through the reasoning harness, float32, on the card against
     the CPU (losses, eval_loss and MMLU logits within 1e-4, predictions,
     generations and eval results equal, launches exact: K2 and K3), and a
     LoReFT at Backpack's sense site (loss and gradients within 1e-4);
     then GPT-2-medium and Pythia-1B through the Alpaca harness (every
     linear adapted, Pythia's ``embed_out`` too) and Gemma-2B through the
     reasoning harness's commonsense recipe, full width and depth, bf16,
     from HF-format directories written here (deleted after), 2 steps and
     a greedy eval each: launches exact (K1, K3), step wall, busy, idle
     share, peak; K1 and K3 timed at every adapted shape, K3's plan
     printed (its generic kernel timed where a shape takes it);
 25. BLIP (``models/blip.py``): the tiny VQA and ITM models (the JAX
     ``tiny()`` shapes, every linear of the towers Monarch-adapted) in
     float32 on the card against a CPU copy: the VQA decoder logits and
     encoder hidden states, the ITM scores with the ITM head and
     contrastive, two AdamW steps of the answer loss (losses and every
     adapter gradient), a LoReFT at a text-encoder block output and a
     cross-attention output (loss and every gradient); launches exact (K2,
     K3); then BLIP-base (``Salesforce/blip-vqa-base``'s config) from an
     HF-format directory written here (random seeded float32 weights, the
     loaded tensors against the written ones; deleted after), 288 adapted
     linears, two ``Trainer`` steps at batch 8 x ga 2 with 20-token
     questions (step wall, busy, idle share, peak), each adapted shape's
     rows and K3's plan, K2 and K3 timed there, a LoReFT step at four
     text-encoder layers, the ITM model in both modes, the adapters merged
     (K1) and a merged eval forward; launches exact;
 26. the structured layers and ops (``layers/structured.py``,
     ``layers/blocksparse.py``, ``layers/spectral.py``,
     ``ops/butterfly.py``; no kernel of ours: cuBLAS products and cuFFT,
     as XLA computes the JAX layers): BlockdiagLinear at RoBERTa-large's
     FFN widths (1024 <-> 4096, 4 blocks, shuffle on and off, float32 and
     bfloat16), BlockSparseLinear (a flat butterfly layout of 32-blocks,
     1024 -> 4096 and ragged 1000 -> 4000), both at the GLUE micro-batch
     of 3 x 512 rows, ButterflyFFT (fft and ifft at 1024 and 4096) and
     ButterflyFFT2 (64 x 64) through the complex Monarch multiply,
     block_butterfly_multiply (16 blocks of 64), SpectralConv1d and
     SpectralConv2d at the FNO Burgers and Darcy (85 x 85) settings:
     forward and backward on the card against the same module on the CPU,
     the transforms against ``torch.fft`` at init, each timed.

18 also runs the smoke harness over an int4 base with ``--optim adamw8bit``
(the 8-bit codes that differ between the card and the CPU counted), and
its int4 run at full width with it (the optimizer state's bytes printed
beside AdamW's).

Serving (5, 6, 10 and 11) runs before the experiments (13-16).  Every
profile is taken in ``benchlib.device_profile``'s window, padded at both
ends so that it keeps every kernel's record (ROADMAP C.10).  Each main path (6, 8 off, 8 on, 8
with splash, each remat run and step of 8, each configuration of 11, each step of 12, the bench of 13,
each script of 14, 15 and 16, the attention bench of 17, each harness run
of 18, 19, 20, 21, 22, 23 and 24, 19's beam search and beam-4 eval, 20's timed
eval and predictions, 21's reference-orientation layer, 23's evals and DAS
runs, 24's Backpack LoReFT, and each forward, training run, LoReFT step,
merge and merged forward of 25) zeroes the launch counts of every kernel
just before it and reads them just after.  Any failed check
exits non-zero.  The line before the last is one JSON object on the
kernels (K5 and K7 at decode and, as ``int4_matmul_tile`` and
``int8_matmul_tile``, at a training micro-batch, each entry's launches
those of its own source: the decode entries serving's decode steps, the
``_tile`` entries serving's prefills and the bf16 training phases'
forwards; K9-K11: ms, plain, library and bound summed over the bench's
three shapes; K15, K12 and K13: the best tile's ms at the scripts' shape,
the tile in ``records.json``; K14 at that shape; K16 the best variant at
(4, 2048, 5632); K17-K19 at the 1.1B micro-batch, their launches those
of the 22-layer splash training); the last is ``{"ok": true, "device":
{...}}``.
Per-case records go to ``chip_smoke_out/records.json``.
It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

try:
    import torch

    from sparse_matrix_fine_tuning_torch import quant
    from sparse_matrix_fine_tuning_torch.kernels import attention_cuda, monarch_cuda, quant_cuda
    from sparse_matrix_fine_tuning_torch.kernels.build import build
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm
    from sparse_matrix_fine_tuning_torch.utils import benchlib
    from sparse_matrix_fine_tuning_torch.utils.benchlib import card_line, roofline_ms, time_ms
    from sparse_matrix_fine_tuning_torch.data.hf_tokenizer import (BPETokenizer,
                                                                   write_byte_fallback_bpe)
    from sparse_matrix_fine_tuning_torch.ops.attention import attention_cost
    from sparse_matrix_fine_tuning_torch.utils.testing import (ATTN_BLOCK_ROWS, ATTN_BLOCK_RTOL,
                                                               TOLERANCES, attention_block_error)
except ImportError as exc:  # run outside a checkout of the repository
    print(f"chip_smoke: cannot import the port ({exc}); run it from the repository root",
          file=sys.stderr)
    sys.exit(2)

SEED = 0
# TinyLlama-1.1B widths (bench.py:130-140) and its Monarch adapters.
MODEL = dict(vocab_size=32000, hidden_size=2048, num_hidden_layers=22,
             num_attention_heads=32, num_key_value_heads=4, intermediate_size=5632)
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
# (name, in, out) of the adapted projections of one decoder layer.
PROJECTIONS = [("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256), ("o", 2048, 2048),
               ("gate", 2048, 5632), ("up", 2048, 5632), ("down", 5632, 2048)]
ROWS = (4, 65, 256, 2048)
# benchlib.time_ms's reps and rounds for K1/K2 at ROWS (phase_kernels): 112
# cases, three timings each (the other kernel phases' 20 x 3)
KERNEL_TIMING = (20, 3)
N_ADAPTED = 7 * MODEL["num_hidden_layers"]
BATCH, PROMPT, NEW = 4, 64, 128  # bench.py:128
PROMPT_LENS = (64, 48, 33, 17)
F32_NEW = 32
# f32 prefill logits, kernel path against the merged reference: 22 layers of
# fp32 sums taken in another order (x W^T + monarch(x) against x (W + M)^T)
F32_LOGIT_TOL = 1e-3
# Training (bench.py:389-418 with the 1.1B widths): rows of the backward
# kernels' checks, one micro-batch being 4 x 512 = 2048 rows.
BWD_ROWS = (65, 2047, 2048)
TRAIN_BS, TRAIN_GA, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 512, 3  # 1 warm-up + 2 timed
REMAT_STEPS = 2  # phase_train_remat's runs: 1 warm-up + 1 timed
F32_TRAIN = dict(layers=2, bs=2, ga=2, seq=128)
TRAIN_LR = 1e-4
# f32 training step, card against the CPU copy (2 layers, fp32 sums in
# another order, TF32 off): the loss within 1e-5 of itself; every factor's
# (clipped) gradient within 1e-4 of its largest element; the updated factors
# within 1e-2 * lr wherever the gradient is above 1e-3 of its largest (the
# first AdamW step is lr * g / (|g| + eps), about lr * sign(g)), and within
# 2 * lr elsewhere, where a gradient near zero may round to either sign.
F32_TRAIN_LOSS_RTOL, F32_TRAIN_GRAD_TOL = 1e-5, 1e-4
# bf16 training, merged against unmerged on the same batches: the merged
# operand rounds W + M to bf16 once, the unmerged path rounds W x and adds
# monarch(x) in fp32; after 4 AdamW steps the losses (about 10.4) may differ
# by this much.
BF16_MERGED_LOSS_ATOL = 2e-2
KERNELS = {
    "monarch_kernel": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:157"),
    "monarch_add": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:164"),
    "monarch_bwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:173"),
    "monarch_dw_fused": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:364"),
    # K5 and K7 at decode rows (M <= 16: quant_matmul.cu's decode kernel) and
    # at a training micro-batch (bf16, M > 16: the wgmma kernel); K6 and K8
    # in bf16
    "int4_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:115"),
    "int4_matmul_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:115"),
    "int4_matmul_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:141"),
    "int8_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:305"),
    "int8_matmul_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:305"),
    "int8_matmul_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:312"),
    "more_linear_fwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/more_linear.cu",
                        "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:52"),
    "more_linear_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/more_linear.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:80"),
    "more_linear_dw": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:108"),
    "tiled_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/tiled_matmul.cu",
                     "scripts/exp_matmul_tiles.py:20"),
    "monarch_fwd_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                         "scripts/exp_fwd_tile.py:21"),
    "monarch_dw_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                        "scripts/exp_dw_kernel.py:24"),
    "monarch_dw_merged": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                          "scripts/exp_merged_v3.py:23"),
    "int4_variant": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                     "scripts/exp_int4_dequant_variants.py:108"),
    # K17-K19: the three Pallas kernels of JAX's splash attention that
    # _splash_attention runs (forward, dq, dk/dv)
    "splash_fwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/flash_attention.cu",
                   "sparse_matrix_fine_tuning_tpu/models/llama.py:57"),
    "splash_dq": ("sparse_matrix_fine_tuning_torch/kernels/csrc/flash_attention.cu",
                  "sparse_matrix_fine_tuning_tpu/models/llama.py:57"),
    "splash_dkv": ("sparse_matrix_fine_tuning_torch/kernels/csrc/flash_attention.cu",
                   "sparse_matrix_fine_tuning_tpu/models/llama.py:57"),
}
ATTN_KERNELS = ("splash_fwd", "splash_dq", "splash_dkv")
# K17-K19's checks, (label, (b, t, heads, head_dim)): the attention bench's
# shape (scripts/bench_attention.py:17), the 1.1B training micro-batch (the
# JSON line's; bs 4 x seq 512, 32 heads of 64) and t ragged against the
# persistent K17-K19's 128-row tiles, their 64-row kv tiles and q steps and
# the f32 kernels' 32-row tiles ((3, 129, 5, 64): one 128-row tile and a
# row, heads that start off 16 bytes in lse and di; (2, 65, 3, 64): one of
# K18's 64-row kv tiles and a row at head_dim 64, where K17's are 128);
# bf16 and f32 at each.  Timed (bf16) at the first two.
ATTN_SHAPES = (("bench", (4, 1024, 32, 128)), ("1.1B", (TRAIN_BS, TRAIN_SEQ, 32, 64)),
               ("ragged", (2, 200, 4, 64)), ("ragged", (1, 1000, 2, 128)),
               ("ragged", (3, 129, 5, 64)), ("ragged", (2, 65, 3, 64)))
ATTN_REPS, ATTN_ROUNDS = 20, 3  # time_ms at these shapes: the plain versions take ms a call
# The 22-layer bf16 splash run against einsum (phase_train_splash): einsum
# rounds the scores and the probabilities to bf16 where splash keeps them in
# fp32 (P rounds for P.V only).  The loss gap, the first step's against the
# einsum run's and the first micro-batch's against einsum's arithmetic, and
# the factors' gradients' relative error on that micro-batch.  Limits 3x
# the largest sound readings (H100, PERF.md §6):
# loss 0.00111 (the splash kernels 0.00039, K17's plain version with
# an fp32 backward 0.00111), gradients 0.047 (every sound arithmetic is
# 0.044-0.047 from every other: 22 bf16 layers of random weights spread one
# ulp that far).  Each of ATTENTION_CONTROLS must exceed one of them: they
# read 0.0025-0.043 in the loss and 0.40-1.4 in the gradients.
SPLASH_LOSS_ATOL = 3.3e-3
SPLASH_GRAD_RTOL = 0.15
# bench_attention's max |difference| of dpa's and splash's output against
# einsum's (q, k, v N(0, 1), head_dim 128): einsum rounds its scores to bf16,
# whose ulp is 0.25 at the 30-40 they reach there, 2% of p; readings 0.0234
# (dpa and splash, PERF.md §6), limit about 2x.
BENCH_ATTN_DIFF = 0.05
# The quantized base (quant/, run_alpaca.py --bits): (bits, whether dx).
QUANT_KERNELS = {"int8_matmul": (8, False), "int8_matmul_dx": (8, True),
                 "int4_matmul": (4, False), "int4_matmul_dx": (4, True)}
QUANT_GROUP = 64  # quantize_frozen_base's default group
# K5/K7 at decode rows timed cold: each projection's calls rotate over
# weight sets of more than this many bytes, twice the 50 MB L2
DECODE_ROTATE_BYTES = 100e6
# Prefill logits cosine, quantized bf16 model against the unquantized bf16
# one, on this random 22-layer model, which passes the weights' rounding
# noise on undamped.  int8 (per-column absmax, a step of 1/127 of the
# column's largest weight, an rms error near 0.8% of the weights' rms):
# >= 0.99.  int4 (group-64 absmax, a step of 1/7 of the group's largest
# weight, an rms error near 10%: about 150 times int8's variance): 1 - cos
# grows with that variance, and int8's measured 1 - cos of 0.0027 (H100,
# this script) scaled by it gives about 0.4, so >= 0.6.  The requantize-
# merged int8 model with the w8a8 head adds one more int8 rounding of
# W + delta and of the head's activations: >= 0.99.
QUANT_COS = {8: 0.99, 4: 0.6}
# decode steps each quantized configuration profiles (profile_decode)
DECODE_PROFILE_STEPS = 8
# phase_quant_bf16's generates that alternate the quantized model with the
# unquantized one: new tokens each (the counted generate keeps NEW); a decode
# step's ms is their wall less the prefill over their steps
QUANT_ALT_NEW = 32
# The fused dense + Monarch linear (K9-K11): short labels of
# bench_more_linear.SHAPES, and the ragged f32 check (tests/kernels/
# test_more_linear.py:17): (label, rows, n, m, nblocks, blk_r).
MORE_KERNELS = ("more_linear_fwd", "more_linear_dx", "more_linear_dw")
MORE_LABELS = ("qkv", "micro", "gate")
MORE_RAGGED = ("ragged", 200, 128, 96, 4, 8)
# The bench's fused loss against its plain one: each bf16 y is within two
# ulps (2**-7 relatively) of the plain path's, so each y**2 within 2**-6.
MORE_LOSS_RTOL = 2.0 ** -6
# instantiations of bf16's K9/K10 kernel (csrc/more_linear.cu): six pairs
# of tile and summary width, forward and dx
MORE_FUSED_KERNELS = 12
# K9/K10 at J = 32, 2664 x 1800 -> 1800 ((rows, n, m, K, Q, L) of
# compare_more_linear.inputs), where one card run once gave other bits:
# MORE_REPEATS calls of each must equal the first bit for bit.
MORE_REPEAT_CASE = (2664, 1800, 1800, 4, 8, 4)
MORE_REPEATS = 50
# The forward-tile experiments' ragged checks: K15 at (M, K, N) with M past
# every BM, K past the k step of 64 and N past every BN (multiples of 8, as
# TMA needs); K12 at (B, n, m, nblocks, rank) in f32, B past every row tile.
TILES_RAGGED = (200, 200, 392)
TILES_BENCH = (2664, 4096, 4096)  # K15's repeat check: exp_matmul_tiles.SHAPE
FWD_TILE_RAGGED = (37, 256, 384, 4, 4)
# The dw experiments' ragged checks, (M, K, Q, P, L, S, R): the fast path at
# blk_r 8 and 16, and the generic kernel (P % 8 != 0), M past every row
# group; K13's row groups there: the 16-row tile and the sweep's.
DW_RAGGED = ((200, 4, 8, 64, 4, 48, 8, True), (200, 4, 16, 64, 4, 48, 16, True),
             (200, 4, 16, 60, 4, 48, 16, False))
DW_RAGGED_ROWS = (16, *monarch_cuda.DW_TILE_ROWS)
# K1/K2's ragged checks, (B, K, Q, P, L, S, R, offset of x and base in
# elements): P and S * L no multiple of 8, K != L and Q != R, rows past the
# decode bound and past a row tile, P past 64 chunks (3 chunks a lane), a
# training micro-batch at down_proj's P, R = 16 (K12's rank), and a wide J
# (512: the plan's shared memory past 48 KB, K1 then K2; 2048: past 227 KB
# at one tile of 16 rows, so the plan halves the tile).
FWD_RAGGED = ((5, 4, 4, 13, 4, 7, 4, 1), (17, 2, 8, 36, 4, 9, 4, 1), (3, 3, 5, 9, 5, 3, 3, 1),
              (65, 4, 4, 1100, 4, 36, 4, 0), (2048, 4, 4, 1408, 4, 65, 4, 1),
              (33, 2, 32, 20, 4, 13, 16, 1), (16, 4, 128, 520, 8, 40, 64, 0),
              (16, 8, 256, 64, 8, 24, 256, 1))
# K5-K8 where int4's h = in / 2 is no multiple of 8 (ROADMAP C.8): (in, out,
# group), at M 17 and 129 (the tile path), bf16
QUANT_RAGGED_IN = ((1000, 272, 20), (1032, 272, 43), (1096, 384, 137))
QUANT_RAGGED_ROWS = (17, 129)
# K16's ragged checks: rows 3, 13 (one block of 16) and 40 (three blocks;
# five of 8 for ugdot and u2dot) at in 1536 -> out 272 (17 column tiles of
# 16), group 64.
INT4_VARIANT_ROWS = (3, 13, 40)
INT4_VARIANT_RAGGED = (1536, 272, 64)
# K16's JSON line: the best variant at this shape of the script
INT4_VARIANT_SHAPE = (4, 2048, 5632)
# The Alpaca harness (phase_alpaca): (a) the smoke argv on the card and on
# the CPU, whose losses, eval_loss and MMLU choice logits (float32) agree
# within ALPACA_TOL; (b) the full-width argv, the harness's defaults
# otherwise.  Both take 2 optimizer steps, of ALPACA_GA micro-batches (a;
# the harness's default is 16) and of ALPACA_FULL_GA (b).
ALPACA_STEPS, ALPACA_GA = 2, 8
ALPACA_ARGV = ["--smoke=True", "--dropout=0.0", f"--max_steps={ALPACA_STEPS}",
               f"--gradient_accumulation_steps={ALPACA_GA}",
               "--logging_steps=1", "--eval_dataset_size=8", "--max_mmlu_samples=16",
               "--do_predict=True", "--max_new_tokens=8"]
ALPACA_FULL_NEW = 16
ALPACA_FULL_GA = 4  # the harness's default is 16; 4 quarters the phase's micro-batches
ALPACA_FULL_ARGV = [f"--max_steps={ALPACA_STEPS}", "--logging_steps=1", "--eval_dataset_size=8",
                    f"--gradient_accumulation_steps={ALPACA_FULL_GA}",
                    "--max_mmlu_samples=32", "--do_predict=True",
                    f"--max_new_tokens={ALPACA_FULL_NEW}"]
ALPACA_TOL = TOLERANCES["f32_logits"]
# The reasoning harness (phase_reasoning_smoke, phase_reasoning_full): (a) the
# smoke argv, float32, on the card and on the CPU (-task is added per run);
# beam_generate's new tokens there; (b) TinyLlama-1.1B's config.json for the
# HF-format directory the phase writes, and the harness's argv at batch 4 x
# ga 8 x max length 512 (its defaults otherwise: remat "nothing", dropout
# 0.1), one math eval dataset, greedy then beam-sample at temperature 0.1;
# the new tokens of the profiled evals.
REASONING_STEPS, REASONING_GA = 2, 4
REASONING_ARGV = ["--smoke=True", "--dropout=0.0", "-e", "1", "-batch_size", "4",
                  "-gradient_accumulation_steps", str(REASONING_GA),
                  f"--max_steps={REASONING_STEPS}", "--logging_steps=1",
                  "--max_n_train_example=32", "--max_n_eval_example=4"]
REASONING_BEAM_NEW = 12
TINYLLAMA_HF = {"model_type": "llama", "architectures": ["LlamaForCausalLM"], **MODEL,
                "max_position_embeddings": 2048, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                "hidden_act": "silu", "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": None,
                "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
REASONING_FULL_STEPS = 2
REASONING_FULL_ARGV = ["-task", "math", "-batch_size", "4", "-gradient_accumulation_steps", "8",
                       "-max_length", "512", f"--max_steps={REASONING_FULL_STEPS}",
                       "--logging_steps=1", "-eval_dataset", "MultiArith",
                       "--max_n_eval_example=8", "-top_k", "0", "-top_p", "1.0", "-t", "0.1"]
REASONING_PROFILE_NEW = 16
# The math task's new tokens in phase_reasoning_full's evals (the harness's
# 512): the random model ends no row within them, and with the BPE
# tokenizer each 512-token eval took 36-41 s on an H100 80GB HBM3 at 700 W.
REASONING_FULL_NEW = 32
# The GLUE and AG News harnesses (phase_glue_smoke, phase_glue_full): (a) the
# smoke argv of each run, float32, dropout off, on the card and on the CPU,
# cut to GLUE_STEPS steps (CoLA, MNLI and MRPC at 100x the recipe's rate, so
# that 3 steps move the predictions); STS-B's correlations within
# GLUE_CORRELATION_ATOL (a correlation divides the scores' float32
# differences by their small spread; the CPU tests read 1.3e-5 and 1.1e-4);
# (b) RoBERTa-large's and DeBERTa-v3-base's config.json for the HF-format
# directories the phase writes (their names tell run_glue the family), and
# the recipes' argv in bf16, cut to GLUE_STEPS steps.
GLUE_STEPS = 3
GLUE_FAST = ["--learning_rate=0.003"]
GLUE_SMOKE = (("roberta cola", "monarch_roberta_glue/cola.json", GLUE_FAST),
              ("roberta stsb", "monarch_roberta_glue/stsb.json", []),
              ("roberta mnli", "monarch_roberta_glue/mnli.json", GLUE_FAST),
              ("deberta mrpc", "deberta_glue/mrpc.json", GLUE_FAST))
GLUE_CUT = [f"--max_steps={GLUE_STEPS}", "--logging_steps=1"]
AGNEWS_STEPS = 2  # a quarter of the 256 smoke items at batch 32
AGNEWS_SMOKE = ["--smoke=True", "--method=monarch", "-e", "0.25", "--logging_steps=1"]
GLUE_CORRELATION_ATOL = 1e-3
ROBERTA_LARGE_HF = {"model_type": "roberta", "architectures": ["RobertaForMaskedLM"],
                    "vocab_size": 50265, "hidden_size": 1024, "num_hidden_layers": 24,
                    "num_attention_heads": 16, "intermediate_size": 4096,
                    "max_position_embeddings": 514, "type_vocab_size": 1,
                    "layer_norm_eps": 1e-5, "pad_token_id": 1, "hidden_act": "gelu"}
DEBERTA_V3_BASE_HF = {"model_type": "deberta-v2", "architectures": ["DebertaV2ForMaskedLM"],
                      "vocab_size": 128100, "hidden_size": 768, "num_hidden_layers": 12,
                      "num_attention_heads": 12, "intermediate_size": 3072,
                      "max_position_embeddings": 512, "type_vocab_size": 0,
                      "layer_norm_eps": 1e-7, "pad_token_id": 0, "hidden_act": "gelu",
                      "relative_attention": True, "position_buckets": 256,
                      "max_relative_positions": -1, "pos_att_type": ["p2c", "c2p"],
                      "share_att_key": True, "norm_rel_ebd": "layer_norm",
                      "position_biased_input": False}
# (label, task config, config.json, directory under OUT_DIR)
GLUE_FULL = (("RoBERTa-large", "monarch_roberta_glue/cola.json", ROBERTA_LARGE_HF,
              "glue_roberta_large"),
             ("DeBERTa-v3-base", "deberta_glue/cola.json", DEBERTA_V3_BASE_HF,
              "glue_deberta_v3_base"))
# The baselines, projection and the search through the GLUE harness
# (phase_baselines_smoke, phase_baselines_full): (a) each run's label, task
# config, flags and the kernel of its forwards (None: LoRA and BOFT run none
# of ours), smoke, float32, dropout off, on the card against the CPU; the
# reference orientation with svd_init from a peft config written beside a
# copy of the CoLA recipe; the search on STS-B (3 trials in two rungs: a
# third of an epoch, then the best one resumed to the epoch; the lr scaled
# 10x so that the trials' pearson values lie apart); AG News and Alpaca with
# LoRA; the reference orientation's identity product (K1) on the card at
# RoBERTa-large's width; (b) the recipes at RoBERTa-large width from
# phase_glue_full's HF-format directory, bf16, GLUE_STEPS steps.
BASELINE_SMOKE = (
    ("roberta lora cola", "lora_roberta_glue/cola.json",
     ["--monarch=False", "--lora=True", *GLUE_FAST], None),
    ("roberta boft cola", "boft_roberta_glue/cola.json",
     ["--monarch=False", "--boft=True", *GLUE_FAST], None),
    ("roberta boft stsb", "boft_roberta_glue/stsb.json", ["--monarch=False", "--boft=True"], None),
    ("roberta svd_init cola", "monarch_roberta_glue/cola.json",
     ["--svd_init=True", *GLUE_FAST], "monarch_add"),
    ("roberta svd_init stsb", "monarch_roberta_glue/stsb.json", ["--svd_init=True"],
     "monarch_add"),
    ("roberta projection cola", "monarch_roberta_glue/cola.json",
     ["--adapter=False", *GLUE_FAST], "monarch_kernel"),
    ("roberta projection stsb", "monarch_roberta_glue/stsb.json", ["--adapter=False"],
     "monarch_kernel"),
    ("deberta projection mrpc", "deberta_glue/mrpc.json", ["--adapter=False", *GLUE_FAST],
     "monarch_kernel"),
)
BASELINE_TUNE = ["--logging_steps=1", "--num_train_epochs=1", "--do_tune=True", "--n_trials=3",
                 "--tune_grace=0.34", "--tune_lr_scale=10"]
BASELINE_TUNE_EPOCHS = [0.34] * 3 + [1.0]
PROJECTION_BWD_REPS = (5, 2)  # benchlib.time_ms's reps and rounds for K3's generic kernel
SVD_CARD_RTOL = 1e-3  # reference_orientation_on_card: the card's SVD against the CPU's
BASELINE_FULL_MODEL = "RoBERTa-large"
BASELINE_FULL = (("LoRA", "lora_roberta_glue/cola.json", ["--monarch=False", "--lora=True"], None),
                 ("BOFT", "boft_roberta_glue/cola.json", ["--monarch=False", "--boft=True"], None),
                 ("Monarch svd_init", "monarch_roberta_glue/cola.json", ["--svd_init=True"],
                  "monarch_add"),
                 ("Monarch projection", "monarch_roberta_glue/cola.json", ["--adapter=False"],
                  "monarch_kernel"))
# ReFT through the reasoning harness (phase_reft_smoke, phase_reft_full):
# (a) the reasoning smoke argv on one eval dataset with each intervention
# (Loreft untied f7+l7: four interventions; the others tied, two), its
# beam-4 eval at temperature 1e-6 with top-k and top-p off (equal to beam
# search, so that card and CPU agree); MoReFT GLUE on the tiny RoBERTa
# (moreft_glue.sh's recipe, dropout off, 100x its rate); DAS on the toy MLP
# (scripts/das_demo.py cut to DAS_STEPS; its losses within DAS_RTOL: 80
# Adam steps compound float32 sums in another order); (b) the LoReFT
# paper's commonsense recipe over TinyLlama-1.1B widths (rank 8, f7+l7
# tied, every layer, no dropout: K2 on every forward) at batch 4 x ga 4 x
# max length 512, and moreft_glue.sh's recipe at RoBERTa-large width (no
# kernel of ours), REFT_FULL_STEPS steps each.
REFT_SMOKE_ARGV = [*REASONING_ARGV, "-task", "math", "-eval_dataset", "AddSub", "-p", "f7+l7",
                   "-rank", "4", "-top_k", "0", "-top_p", "1.0", "-t", "1e-6"]
REFT_SMOKE = (("Loreft untied f7+l7", ["--intervention_type", "LoreftIntervention"], 4),
              ("Noreft", ["--intervention_type", "NoreftIntervention", "-sw"], 2),
              ("Consreft", ["--intervention_type", "ConsreftIntervention", "-sw"], 2),
              ("MoRe", ["--intervention_type", "MoReIntervention", "-sw"], 2))
MOREFT_GLUE_SMOKE = ["-task", "glue", "-train_dataset", "cola", "-p", "f1", "-e", "1",
                     "-lr", "3e-2", "-rank", "1", "-batch_size", "32", "-max_length", "64",
                     "--intervention_type=MoReIntervention", "--dropout=0.0", "-allow_cls_grad",
                     "--smoke=True", "--max_steps=3", "--logging_steps=1"]
DAS_STEPS = (60, 20)  # das_demo's base-model and DAS steps
DAS_RTOL = 1e-3
REFT_FULL_STEPS = 3
REFT_FULL_ARGV = ["-task", "commonsense", "--intervention_type", "LoreftIntervention", "-l", "all",
                  "-rank", "8", "-p", "f7+l7", "--share_weights", "--dropout", "0.0",
                  "-batch_size", "4", "-gradient_accumulation_steps", "4", "-max_length", "512",
                  f"--max_steps={REFT_FULL_STEPS}", "--logging_steps=1", "-eval_dataset", "boolq",
                  "--max_n_eval_example=8", "-top_k", "0", "-top_p", "1.0"]
MOREFT_GLUE_FULL_ARGV = ["-task", "glue", "-train_dataset", "cola", "-p", "f1", "-l", "all",
                         "-rank", "1", "-batch_size", "32", "-eval_batch_size", "32",
                         "-lr", "3e-4", "-gradient_accumulation_steps", "1", "-max_length", "256",
                         "--intervention_type=MoReIntervention", "--dropout=0.05",
                         "-allow_cls_grad", "-test_split", "validation",
                         f"--max_steps={REFT_FULL_STEPS}", "--logging_steps=1"]
# The other decoder families (phase_families_smoke, phase_families_full):
# (a) each family's tiny HF-format directory (FAMILY_TINY, float32 weights
# written here with the hash tokenizer's 32000 ids and room for the MMLU
# scoring's 2048 tokens) through the harness it names, built in float32,
# dropout off, TF32 off, on the card against the CPU, with its adapted
# linears (2 layers); a LoReFT at Backpack's sense site on the card against
# the CPU; (b) GPT-2-medium (models/gpt2.py:94-98) and Pythia-1B
# (models/gpt_neox.py:87-92) through run_alpaca, every linear adapted
# (embed_out too), and Gemma-2B (models/config.py:165-174) through
# run_reasoning's commonsense recipe, full width and depth, bf16, from
# HF-format directories written here, FAMILIES_FULL_STEPS steps each.
FAMILY_VOCAB = 32000
_TINY_GPT2 = {"vocab_size": FAMILY_VOCAB, "n_embd": 64, "n_layer": 2, "n_head": 4,
              "n_positions": 2048}
FAMILY_TINY = {  # family -> (config.json, harness, extra argv, adapted linears)
    "gpt2": ({"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], **_TINY_GPT2},
             "alpaca", [], 2 * 4),
    "gpt_neo": ({"model_type": "gpt_neo", "architectures": ["GPTNeoForCausalLM"],
                 "vocab_size": FAMILY_VOCAB, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
                 "max_position_embeddings": 2048, "window_size": 16,
                 "attention_types": [[["global", "local"], 1]]}, "alpaca", [], 2 * 6),
    "gpt_neox": ({"model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
                  "vocab_size": FAMILY_VOCAB, "hidden_size": 64, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "intermediate_size": 256,
                  "max_position_embeddings": 2048, "rotary_pct": 0.25,
                  "use_parallel_residual": True, "hidden_act": "gelu"}, "alpaca", [], 2 * 4 + 1),
    "backpack": ({"model_type": "gpt2", "architectures": ["BackpackGPT2LMHeadModel"],
                  **_TINY_GPT2, "num_senses": 4, "sense_intermediate_scale": 4,
                  "scale_attn_by_inverse_layer_idx": True},
                 "alpaca", ["--do_predict=False"], 2 * 4 + 5),
    "gemma": ({"model_type": "gemma", "architectures": ["GemmaForCausalLM"],
               "vocab_size": FAMILY_VOCAB, "hidden_size": 64, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 1, "head_dim": 32,
               "intermediate_size": 128, "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
               "tie_word_embeddings": True}, "reasoning", [], 2 * 7),
}
FAMILY_ALPACA_ARGV = [a for a in ALPACA_ARGV if a != "--smoke=True"]
FAMILY_REASONING_ARGV = [a for a in REASONING_ARGV if a != "--smoke=True"] + [
    "-task", "commonsense", "-eval_dataset", "boolq", "-max_length", "128"]
SENSE_LOREFT = {"layer": 0, "component": "sense_network_output",
                "intervention": "LoreftIntervention", "low_rank_dimension": 4}
FAMILIES_FULL_STEPS = 2
GPT2_MEDIUM_HF = {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
                  "vocab_size": 50257, "n_embd": 1024, "n_layer": 24, "n_head": 16,
                  "n_positions": 1024, "layer_norm_epsilon": 1e-5, "bos_token_id": 50256,
                  "eos_token_id": 50256}
PYTHIA_1B_HF = {"model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
                "vocab_size": 50432, "hidden_size": 2048, "num_hidden_layers": 16,
                "num_attention_heads": 8, "intermediate_size": 8192,
                "max_position_embeddings": 2048, "rotary_pct": 0.25, "rotary_emb_base": 10000,
                "use_parallel_residual": True, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
                "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0}
GEMMA_2B_HF = {"model_type": "gemma", "architectures": ["GemmaForCausalLM"],
               "vocab_size": 256000, "hidden_size": 2048, "num_hidden_layers": 18,
               "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
               "intermediate_size": 16384, "max_position_embeddings": 8192,
               "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "hidden_act": "gelu_pytorch_tanh",
               "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1,
               "pad_token_id": 0}
_FULL_CUT = [f"--max_steps={FAMILIES_FULL_STEPS}", "--logging_steps=1"]
# (label, harness, config.json, argv, adapted linears): GPT-2-medium's 1024
# learned positions cannot hold the MMLU scoring's 2048-token 5-shot
# prompts, so its run scores no MMLU; the lengths are cut to fit the time.
FAMILIES_FULL = (
    ("GPT-2-medium", "alpaca", GPT2_MEDIUM_HF,
     [*_FULL_CUT, "--gradient_accumulation_steps=4", "--eval_dataset_size=8",
      "--source_max_len=512", "--target_max_len=128", "--do_mmlu_eval=False",
      "--do_predict=True", "--max_new_tokens=16"], 4 * 24),
    ("Pythia-1B", "alpaca", PYTHIA_1B_HF,
     [*_FULL_CUT, "--gradient_accumulation_steps=4", "--eval_dataset_size=8",
      "--source_max_len=512", "--target_max_len=128", "--max_mmlu_samples=16",
      "--do_predict=True", "--max_new_tokens=16"], 4 * 16 + 1),
    ("Gemma-2B", "reasoning", GEMMA_2B_HF,
     [*_FULL_CUT, "-task", "commonsense", "-batch_size", "4", "-gradient_accumulation_steps",
      "4", "-max_length", "256", "-eval_dataset", "boolq", "--max_n_eval_example=8"], 7 * 18),
)
BLIP_TARGETS = ["qkv", "projection", "fc1", "fc2", "query", "key", "value", "dense",
                "intermediate", "output"]  # every linear of the towers; not the LM head's
BLIP_PEFT = {**PEFT, "dropout": 0.0, "target_modules": BLIP_TARGETS}
BLIP_SMOKE_LOREFT = [{"layer": 1, "component": "block_output",
                      "intervention": "LoreftIntervention", "low_rank_dimension": 4},
                     {"layer": 0, "component": "cross_attention_output",
                      "intervention": "LoreftIntervention", "low_rank_dimension": 4}]
# Salesforce/blip-vqa-base's published config.json (the fields the loader reads)
BLIP_VQA_BASE_HF = {
    "architectures": ["BlipForQuestionAnswering"], "model_type": "blip",
    "image_text_hidden_size": 256, "projection_dim": 512,
    "text_config": {"vocab_size": 30524, "hidden_size": 768, "intermediate_size": 3072,
                    "num_hidden_layers": 12, "num_attention_heads": 12,
                    "encoder_hidden_size": 768, "max_position_embeddings": 512,
                    "layer_norm_eps": 1e-12, "pad_token_id": 0, "bos_token_id": 30522,
                    "sep_token_id": 102},
    "vision_config": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                      "num_attention_heads": 12, "image_size": 384, "patch_size": 16,
                      "layer_norm_eps": 1e-5}}
BLIP_BATCH, BLIP_QUESTION, BLIP_GA, BLIP_STEPS = 8, 20, 2, 2
BLIP_ADAPTED = {"qa": 12 * 4 + 2 * 12 * 10, "itm": 12 * 4 + 12 * 10,
                "contrastive": 12 * 4 + 12 * 6}  # adapted calls a forward
BLIP_REFT_LAYERS = (2, 5, 8, 11)
OUT_DIR = "chip_smoke_out"  # per-case records; .gitignore lists it
RECORDS: list[dict] = []  # one per kernel case, written to OUT_DIR


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_counts() -> None:
    """Zero the launch counts of every kernel (K1-K4, K12-K14, K5-K8, K16,
    K9-K11, K15 and K17-K19)."""
    monarch_cuda.reset_launch_counts()
    quant_cuda.reset_launch_counts()
    ml.reset_launch_counts()
    tm.reset_launch_counts()
    attention_cuda.reset_launch_counts()


def counts() -> dict:
    """The launch counts of every kernel since the last reset."""
    return {**monarch_cuda.LAUNCHES, **quant_cuda.LAUNCHES, **ml.LAUNCHES, **tm.LAUNCHES,
            **attention_cuda.LAUNCHES}


def expect_only(got: dict, expect: dict, what: str) -> None:
    """Require launch counts ``got`` to be ``expect`` and 0 elsewhere."""
    require(got == {**dict.fromkeys(got, 0), **expect},
            f"{what}: launches {got}; expected {expect}")


def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), got {cap}")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)
    return card


def phase_build():
    t0 = time.perf_counter()
    lib = build(verbose=True)
    monarch_cuda.load_ops()
    print(f"[build] {time.perf_counter() - t0:.1f} s, {lib}", flush=True)
    return lib


def cost(name: str, m_rows: int, n_in: int, n_out: int, dtype: torch.dtype,
         r: int = PEFT["blk_r"]) -> tuple[int, int]:
    """(bytes, operations) the kernel's function needs: each input read once,
    each output written once (dw in fp32); multiply-adds count two.  K5-K8:
    the codes, the f32 scales, the activations in and the result out;
    2 * M * in * out operations.  K9/K10: x (or dout), the dense weight and
    the factors in, the output out; the dense product and the two factors'
    multiply-adds (r * (in + out) a row, the factors themselves, not the
    TPU kernel's K-times-larger expansion).  K11 is K4's function."""
    item = 2 if dtype == torch.bfloat16 else 4
    if name in ("more_linear_fwd", "more_linear_dx"):
        factors = r * (n_in + n_out)
        return (m_rows * (n_in + n_out) + n_in * n_out + factors) * item, \
            2 * m_rows * (n_in * n_out + factors)
    if name == "more_linear_dw":
        name = "monarch_dw_fused"
    if name in QUANT_KERNELS:
        bits = QUANT_KERNELS[name][0]
        codes = n_in * n_out // (2 if bits == 4 else 1)
        scale_rows = n_in // QUANT_GROUP if bits == 4 else 1
        return codes + 4 * scale_rows * n_out + m_rows * (n_in + n_out) * item, \
            2 * m_rows * n_in * n_out
    factors = r * (n_in + n_out)  # w1 (K, Q, P) has r * n_in elements, w2 r * n_out
    rows = {"monarch_kernel": n_in + n_out, "monarch_add": n_in + 2 * n_out,
            "monarch_bwd": 2 * n_in + n_out, "monarch_dw_fused": n_in + n_out}[name]
    nbytes = (m_rows * rows + factors) * item
    if name in ("monarch_bwd", "monarch_dw_fused"):
        nbytes += factors * 4
    macs = {"monarch_kernel": r * (n_in + n_out), "monarch_add": r * (n_in + n_out),
            "monarch_bwd": r * (3 * n_in + 2 * n_out),
            "monarch_dw_fused": r * (2 * n_in + 2 * n_out)}[name]
    return nbytes, 2 * m_rows * macs + (m_rows * n_out if name == "monarch_add" else 0)


def bound(name: str, m_rows: int, n_in: int, n_out: int, dtype: torch.dtype,
          r: int = PEFT["blk_r"]) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    return roofline_ms(*cost(name, m_rows, n_in, n_out, dtype, r), dtype)


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """f32: the two sum in another order, 1e-5 of the output's scale.
    bf16: the intermediate may round one ulp apart, and the output rounds
    once more, so two bf16 ulps of the output's scale (2**-6 of it)."""
    scale = float(ref.float().abs().max())
    return scale * (1e-5 if dtype == torch.float32 else 2.0 ** -6)


def _record(name: str, proj: str, n_in: int, n_out: int, m_rows: int, dtype: torch.dtype,
            err: float, share: float, ms: float, plain_ms: float, call: float, plain_call: float,
            library_ms, r: int = PEFT["blk_r"]) -> dict:
    """Print and keep one case: ``err`` is the largest absolute error over the
    kernel's outputs, ``share`` the largest error / tolerance among them;
    ``r`` the adapters' blk_r."""
    bound_ms, bound_by = bound(name, m_rows, n_in, n_out, dtype, r)
    gbs = cost(name, m_rows, n_in, n_out, dtype, r)[0] / ms / 1e6
    lib = f"{library_ms:.5f}" if library_ms is not None else "none"
    print(f"[kernels] {name:16s} {proj:5s} {n_in}->{n_out:<5d} {m_rows:5d} {str(dtype)[6:]:8s} "
          f"{err:.3e}  {share:.3f}  {ms:.5f}  {plain_ms:.5f}  {lib:8s}  {bound_ms:.5f} "
          f"({bound_by})  {call:.5f}  {plain_call:.5f}  {gbs:.1f}", flush=True)
    rec = {"kernel": name, "proj": proj, "in": n_in, "out": n_out, "rows": m_rows, "blk_r": r,
           "dtype": str(dtype)[6:], "max_abs_err": err, "share_of_tol": share, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "call_ms": call, "plain_call_ms": plain_call, "GB_per_s": gbs}
    RECORDS.append(rec)
    return rec


_HEADER = ("[kernels] kernel           proj  in->out     M     dtype    max_abs_err  /tol   "
           "dev_ms    plain_ms  library   bound_ms           call_ms  plain_call  GB/s")


def _layer_sums(recs: list[dict]) -> dict:
    """Per decoder layer: the seven projections' ms, plain, library and bound;
    ``bound_by`` is the kind ("bytes" or "operations") that bounds the larger
    part of the layer's bound."""
    out = {k: sum(r[k] for r in recs) for k in ("ms", "plain_ms", "bound_ms")}
    libs = [r["library_ms"] for r in recs]
    out["library_ms"] = None if None in libs else sum(libs)
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in recs:
        by_kind[r["bound_by"]] += r["bound_ms"]
    out["bound_by"] = max(by_kind, key=by_kind.get)
    return out


def _offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` starting ``off`` elements into its buffer
    (off 16 bytes for off > 0), as a sliced view would."""
    buf = torch.empty(t.numel() + off, device=t.device, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def phase_kernels_ragged(g: torch.Generator) -> float:
    """K1 and K2 at ``FWD_RAGGED``, f32 and bf16, against their plain
    versions (``tolerance``); x and base sliced views where the case says
    so.  Returns the largest error over the tolerance."""
    share = 0.0
    with torch.inference_mode():
        for b, K, Q, P, L, S, R, off in FWD_RAGGED:
            for dtype in (torch.float32, torch.bfloat16):
                x = _offset(torch.randn(b, K * P, generator=g, device="cuda").to(dtype), off)
                w1 = (torch.randn(K, Q, P, generator=g, device="cuda") / P ** 0.5).to(dtype)
                w2 = (torch.randn(L, S, R, generator=g, device="cuda") / R ** 0.5).to(dtype)
                base = _offset(torch.randn(b, S * L, generator=g, device="cuda").to(dtype), off)
                for got, ref in ((monarch_cuda.monarch_kernel(x, w1, w2),
                                  monarch_cuda.monarch_kernel_reference(x, w1, w2)),
                                 (monarch_cuda.monarch_add(base, x, w1, w2),
                                  monarch_cuda.monarch_add_reference(base, x, w1, w2))):
                    torch.cuda.synchronize()
                    err = float((got.float() - ref.float()).abs().max())
                    tol = tolerance(dtype, ref)
                    require(got.shape == ref.shape and err <= tol
                            and bool(torch.isfinite(got).all()),
                            f"K1/K2 at {(b, K, Q, P, L, S, R)} off {off} {dtype}: max abs err "
                            f"{err} > {tol}")
                    share = max(share, err / tol)
    return share


def phase_kernels(card: str) -> dict:
    """K1 and K2 against their plain versions at the slice's shapes, with the
    library call that computes the same function on a precomputed dense
    matrix: ``F.linear(x, M)`` for K1, ``torch.addmm(base, x, M^T)`` for K2;
    the sums a decoder layer (bf16) at every row count, each call's plan;
    then the ragged cases (``phase_kernels_ragged``)."""
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_kernel": 0.0, "monarch_add": 0.0}
    per_layer = {(name, m_rows): [] for name in worst for m_rows in ROWS}
    print(f"[kernels] card: {card}", flush=True)
    for m_rows in ROWS:
        for proj, n_in, n_out in PROJECTIONS:
            plan = monarch_cuda.monarch_fwd_plan(m_rows, (nb, r, n_in // nb),
                                                 (nb, n_out // nb, r))
            print(f"[kernels] K1/K2 plan, bf16, M={m_rows} {proj}: {plan}", flush=True)
    print(_HEADER, flush=True)
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for m_rows in ROWS:
                for proj, n_in, n_out in PROJECTIONS:
                    p, s = n_in // nb, n_out // nb
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
                    w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                    w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                    base = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
                    dense = monarch_dense_equivalent(w1.float(), w2.float()).to(dtype)
                    cases = {
                        "monarch_kernel": (lambda: monarch_cuda.monarch_kernel(x, w1, w2),
                                           lambda: monarch_cuda.monarch_kernel_reference(x, w1, w2),
                                           lambda: torch.nn.functional.linear(x, dense)),
                        "monarch_add": (lambda: monarch_cuda.monarch_add(base, x, w1, w2),
                                        lambda: monarch_cuda.monarch_add_reference(base, x, w1, w2),
                                        lambda: torch.addmm(base, x, dense.t())),
                    }
                    for name, (kern, plain, library) in cases.items():
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        require(got.shape == ref.shape and got.dtype == ref.dtype,
                                f"{name} {proj} M={m_rows}: {got.shape}/{got.dtype} vs "
                                f"{ref.shape}/{ref.dtype}")
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(dtype, ref)
                        (ms, call), (plain_ms, plain_call) = (time_ms(kern, *KERNEL_TIMING),
                                                              time_ms(plain, *KERNEL_TIMING))
                        rec = _record(name, proj, n_in, n_out, m_rows, dtype, err, err / tol, ms,
                                      plain_ms, call, plain_call,
                                      time_ms(library, *KERNEL_TIMING)[0])
                        require(err <= tol and bool(torch.isfinite(got).all()),
                                f"{name} {proj} M={m_rows} {dtype}: max_abs_err {err} > tol {tol}")
                        worst[name] = max(worst[name], err)
                        if dtype == torch.bfloat16:
                            per_layer[(name, m_rows)].append(rec)
    sums = {key: _layer_sums(recs) for key, recs in per_layer.items()}
    for m_rows in ROWS:
        print(f"[kernels] {card}: device time per decoder layer at M={m_rows} (bf16, "
              "7 projections): "
              + ", ".join(f"{k} {sums[(k, m_rows)]['ms']:.5f} ms (plain "
                          f"{sums[(k, m_rows)]['plain_ms']:.5f}, library "
                          f"{sums[(k, m_rows)]['library_ms']:.5f}, bound "
                          f"{sums[(k, m_rows)]['bound_ms']:.5f} ms)" for k in worst), flush=True)
    RECORDS.append({"monarch_fwd_per_layer": [{"kernel": k, "rows": m, **v}
                                              for (k, m), v in sums.items()], "card": card})
    share = phase_kernels_ragged(g)
    print(f"[kernels] {card}: K1/K2 at {len(FWD_RAGGED)} ragged shapes (f32, bf16; x and "
          f"base off 16 bytes where marked) within tolerance, worst {share:.3f} of it",
          flush=True)
    # the JSON line: decode's shape (M = 4), where the unmerged serving path runs K2
    layer = {name: sums[(name, 4)] for name in worst}
    return {"worst": worst, "layer": layer}


def kernel_ptxas(lib, kernel: str, count: int, tag: str) -> None:
    """ptxas's registers and spills of each of the ``count`` instantiations
    of ``kernel``, from the build's log (``kernels/_build/<key>/build.log``,
    which the build keeps); none may spill."""
    from sparse_matrix_fine_tuning_torch.kernels.build import LOG_NAME
    from sparse_matrix_fine_tuning_torch.scripts.compare_monarch_bwd import ptxas_lines

    lines = [ln for ln in ptxas_lines((lib.parent / LOG_NAME).read_text()) if kernel in ln]
    require(len(lines) == count, f"ptxas: {len(lines)} {kernel} instantiations, expected {count}")
    for line in lines:
        name, rest = line.split(": ", 1)
        args = name[name.index(kernel) + len(kernel):]
        print(f"[{tag}] ptxas {kernel}{args[:24]}: {rest}", flush=True)
        require(" 0 bytes spill stores" in rest, f"ptxas: {line} spills")


def phase_kernels_bwd(card: str, lib) -> dict:
    """K3 and K4 against their plain versions at the training shapes: the
    seven projections, rows M in BWD_ROWS (ragged and whole), bf16 and f32,
    each on the cluster kernel (``monarch_bwd_plan_fields``, printed with its
    launches a call at a training micro-batch), after ptxas's registers and
    spills of its 12 instantiations (``kernel_ptxas``).
    No single PyTorch call computes either function (dx and the two factor
    gradients of the Monarch structure), so they have no library time.
    Tolerances: dx as the forward's output; the fp32 factor gradients 1e-5
    of their scale in f32, 2**-6 of it in bf16 (an intermediate one bf16 ulp
    apart enters every row's product)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_bwd": 0.0, "monarch_dw_fused": 0.0}
    train = {name: [] for name in worst}
    kernel_ptxas(lib, "bwd_cluster_kernel", 12, "kernels")
    for dtype in (torch.bfloat16, torch.float32):
        for m_rows in BWD_ROWS:
            for proj, n_in, n_out in PROJECTIONS:
                for with_dx in (True, False):
                    plan = monarch_cuda.monarch_bwd_plan_fields(
                        m_rows, (nb, r, n_in // nb), (nb, n_out // nb, r), with_dx=with_dx,
                        dtype=dtype)
                    require(plan["fast"] == 1, f"K3/K4 {proj} M={m_rows}: not the cluster "
                                               f"kernel: {plan}")
                    if dtype == torch.bfloat16 and m_rows == TRAIN_BS * TRAIN_SEQ:
                        # the cluster kernel, and the clusters' sum where there
                        # is more than one cluster (compare_monarch_bwd.py
                        # counts them with the profiler; a profile here made
                        # the later decode profiles lose records, ROADMAP C.10)
                        print(f"[kernels] {'K3' if with_dx else 'K4'} plan, bf16, M={m_rows} "
                              f"{proj}: {plan}; {1 + (plan['clusters'] > 1)} launches a call",
                              flush=True)
    print(_HEADER, flush=True)
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for m_rows in BWD_ROWS:
                for proj, n_in, n_out in PROJECTIONS:
                    p, s = n_in // nb, n_out // nb
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
                    w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                    w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                    dout = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
                    cases = {
                        "monarch_bwd": (lambda: monarch_cuda.monarch_bwd(x, w1, w2, dout),
                                        lambda: monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)),
                        "monarch_dw_fused": (
                            lambda: monarch_cuda.monarch_dw_fused(x, dout, w1, w2),
                            lambda: monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)),
                    }
                    for name, (kern, plain) in cases.items():
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        err = share = 0.0
                        for out, want in zip(got, ref):
                            require(out.shape == want.shape and out.dtype == want.dtype,
                                    f"{name} {proj} M={m_rows}: {out.shape}/{out.dtype} vs "
                                    f"{want.shape}/{want.dtype}")
                            require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
                            e = float((out.float() - want.float()).abs().max())
                            err, share = max(err, e), max(share, e / tolerance(dtype, want))
                        (ms, call), (plain_ms, plain_call) = (time_ms(kern, 20, 3),
                                                              time_ms(plain, 20, 3))
                        rec = _record(name, proj, n_in, n_out, m_rows, dtype, err, share, ms,
                                      plain_ms, call, plain_call, None)
                        require(share <= 1.0, f"{name} {proj} M={m_rows} {dtype}: an output is "
                                              f"over its tolerance ({share:.3f} of it)")
                        worst[name] = max(worst[name], err)
                        if dtype == torch.bfloat16 and m_rows == TRAIN_BS * TRAIN_SEQ:
                            train[name].append(rec)
    layer = {name: _layer_sums(recs) for name, recs in train.items()}
    print(f"[kernels] {card}: device time per decoder layer at a training micro-batch "
          f"(M={TRAIN_BS * TRAIN_SEQ}, bf16, 7 projections): "
          + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, bound "
                      f"{v['bound_ms']:.5f} ms)" for k, v in layer.items()), flush=True)
    return {"worst": worst, "layer": layer}


def phase_autograd(card: str) -> None:
    """The autograd Functions of K1 and K2 (backward K3): torch.autograd.grad
    of a fixed random cotangent against the plain Functions' gradients, for
    x, w1, w2 and base, at every projection with M = 2047, bf16 and f32,
    tolerances as ``tolerance``.  Then the adapter layer with dropout 0.1 in
    training mode: its forward is K1, its gradient K3, against the same
    layer's arithmetic on the plain path with the same dropout mask."""
    import torch.nn.functional as F

    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    nb, r, m_rows = PEFT["nblocks"], PEFT["blk_r"], 2047
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for proj, n_in, n_out in PROJECTIONS:
            p, s = n_in // nb, n_out // nb
            x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
            w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
            w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
            base = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
            cot = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
            for name, kern, plain, leaves in (
                    ("monarch_kernel", monarch_cuda.monarch_kernel,
                     monarch_cuda.monarch_kernel_reference, (x, w1, w2)),
                    ("monarch_add", monarch_cuda.monarch_add,
                     monarch_cuda.monarch_add_reference, (base, x, w1, w2))):
                a = [t.clone().requires_grad_() for t in leaves]
                b = [t.clone().requires_grad_() for t in leaves]
                before = monarch_cuda.LAUNCHES["monarch_bwd"]
                got = torch.autograd.grad(kern(*a), a, cot)
                want = torch.autograd.grad(plain(*b), b, cot)
                torch.cuda.synchronize()
                require(monarch_cuda.LAUNCHES["monarch_bwd"] == before + 1,
                        f"the backward of {name} did not launch K3")
                for gt, wt in zip(got, want):
                    e = float((gt.float() - wt.float()).abs().max())
                    tol = tolerance(dtype, wt)
                    require(gt.dtype == wt.dtype and e <= tol,
                            f"grad of {name} {proj} {dtype}: {e} > {tol}")
                    worst = max(worst, e / tol)
    print(f"[autograd] {card}: gradients of K1 and K2 (backward K3) at M={m_rows}, all 7 "
          f"projections, bf16 and f32: worst error {worst:.3f} of its tolerance", flush=True)

    gw = torch.Generator(device="cuda").manual_seed(SEED + 7)
    layer = MonarchLinear(2048, 2048, peft_config={"dropout": 0.1},
                          weights=torch.randn(2048, 2048, generator=gw, device="cuda") / 45,
                          device="cuda").to(torch.bfloat16).train()
    with torch.no_grad():
        layer.blkdiag2.normal_(0.0, 0.1, generator=gw)
    x = torch.randn(m_rows, 2048, generator=gw, device="cuda").to(torch.bfloat16)
    cot = torch.randn(m_rows, 2048, generator=gw, device="cuda").to(torch.bfloat16)
    before = dict(monarch_cuda.LAUNCHES)
    torch.manual_seed(SEED)
    got = torch.autograd.grad(layer(x), (layer.blkdiag1, layer.blkdiag2), cot)
    torch.manual_seed(SEED)
    w1, w2 = layer.blkdiag1.detach().requires_grad_(), layer.blkdiag2.detach().requires_grad_()
    plain = F.linear(x, layer.dense) + F.dropout(
        monarch_cuda.monarch_kernel_reference(x, w1, w2), 0.1, training=True)
    want = torch.autograd.grad(plain, (w1, w2), cot)
    torch.cuda.synchronize()
    require(monarch_cuda.LAUNCHES["monarch_kernel"] == before["monarch_kernel"] + 1
            and monarch_cuda.LAUNCHES["monarch_bwd"] == before["monarch_bwd"] + 1,
            "the dropout adapter did not run K1 forward and K3 backward")
    for gt, wt in zip(got, want):
        e, tol = float((gt - wt).abs().max()), tolerance(torch.bfloat16, wt)
        require(e <= tol, f"dropout adapter factor gradient: {e} > {tol}")
    print(f"[autograd] dropout 0.1 adapter (q shape, bf16, M={m_rows}): K1 forward and K3 "
          "backward, factor gradients within tolerance of the plain path", flush=True)


def slice_config(dtype: str):
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig

    return LlamaConfig(**MODEL, param_dtype=dtype, dtype=dtype,
                       max_position_embeddings=PROMPT + 3 * NEW)


def build_model(dtype: str, state=None):
    """The slice's model on the card, with Monarch adapters on all seven
    projections; random seeded weights, or ``state`` where given."""
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaForCausalLM(slice_config(dtype), device="cuda", generator=g)
    adapted = init_monarch(model, PEFT, generator=g)
    require(len(adapted) == N_ADAPTED, f"{len(adapted)} adapted linears, expected {N_ADAPTED}")
    if state is not None:
        model.load_state_dict(state)
    return model.eval()


@torch.no_grad()
def randomize_adapters(model) -> float:
    """Seeded random nonzero factors (the plain-adapter init zeroes blkdiag2,
    which would hide a kernel that writes zeros), scaled so that
    |monarch(x)| / |dense(x)| is about 0.1 for q_proj at layer 0 on the
    prompts' real input.  Returns that ratio."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    layers = [m for m in model.modules() if isinstance(m, MonarchLinear)]
    for m in layers:
        m.blkdiag1.normal_(0.0, 1.0, generator=g).div_(m.in_blksz ** 0.5)
        m.blkdiag2.normal_(0.0, 1.0, generator=g).div_(m.blk_r ** 0.5)
    ids, mask = prompts(torch.Generator(device="cuda").manual_seed(SEED + 2))
    layer0 = model.model.layers[0]
    x = layer0.input_layernorm(model.model.embed_tokens(ids))[mask.bool()]
    q = layer0.self_attn.q_proj

    def ratio():
        mon = monarch_cuda.monarch_kernel_reference(x, q.blkdiag1.to(x.dtype), q.blkdiag2.to(x.dtype))
        return float(mon.float().norm() / q._dense_forward(x).float().norm())

    scale = 0.1 / ratio()
    for m in layers:
        m.blkdiag2.mul_(scale)
    return ratio()


def prompts(g: torch.Generator):
    """Four left-padded prompts of lengths 64, 48, 33 and 17, padded to 64."""
    vocab = MODEL["vocab_size"]
    ids = torch.randint(3, vocab, (len(PROMPT_LENS), PROMPT), generator=g, device="cuda")
    mask = torch.zeros_like(ids)
    for row, n in enumerate(PROMPT_LENS):
        mask[row, PROMPT - n:] = 1
    return ids * mask, mask


def phase_f32() -> dict:
    """The slice in float32 against a copy with no kernel in it: the
    adapters merged on the CPU by the plain functions, then moved to the card."""
    import copy

    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products in both
    torch.backends.cudnn.allow_tf32 = False
    model = build_model("float32")
    ratio = randomize_adapters(model)
    print(f"[f32] |monarch(x)|/|dense(x)| at layer 0 q_proj: {ratio:.4f}", flush=True)
    ref = copy.deepcopy(model).cpu()
    require(merge_all_adapters(ref) == N_ADAPTED, "merge on the CPU missed adapters")
    ref = ref.to("cuda")
    ids, mask = prompts(torch.Generator(device="cuda").manual_seed(SEED + 2))
    monarch_cuda.reset_launch_counts()
    with torch.inference_mode():
        got = model(ids, attention_mask=mask)
        want = ref(ids, attention_mask=mask)
    torch.cuda.synchronize()
    require(monarch_cuda.LAUNCHES["monarch_add"] == N_ADAPTED,
            f"prefill launched {monarch_cuda.LAUNCHES}; expected {N_ADAPTED} fused adds")
    valid = mask.bool()
    err = float((got - want)[valid].abs().max())
    scale = float(want[valid].abs().max())
    tol = F32_LOGIT_TOL * scale
    print(f"[f32] prefill logits {tuple(got.shape)}: max_abs_err {err:.3e}, tol {tol:.3e} "
          f"({F32_LOGIT_TOL:g} of max|logit| {scale:.3f})", flush=True)
    require(bool(torch.isfinite(got).all()), "non-finite f32 logits")
    require(err <= tol, f"f32 prefill logits differ: {err} > {tol}")

    check_greedy(model, ref, ids, mask, tol, "f32")
    # kept on the host, so that the peak memory of a later phase is its own
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, ref
    torch.cuda.empty_cache()
    return {"logits": got.detach(), "mask": mask, "ids": ids, "state": state}


def check_greedy(model, ref, ids, mask, tol: float, tag: str) -> None:
    """Greedy F32_NEW tokens of ``model`` against ``ref``: identical, or the
    first divergence of a row at a near-tie of the reference's logits (gap
    within ``tol``)."""
    from sparse_matrix_fine_tuning_torch.models.generate import (
        GenerationConfig,
        _positions_from_mask,
        generate,
    )

    gc = GenerationConfig(max_new_tokens=F32_NEW)
    toks = generate(model, ids, mask, gc)
    ref_toks = generate(ref, ids, mask, gc)
    require(tuple(toks.shape) == (len(PROMPT_LENS), PROMPT + F32_NEW), f"tokens {toks.shape}")
    for row in range(toks.shape[0]):
        diff = (toks[row] != ref_toks[row]).nonzero()
        if len(diff) == 0:
            continue
        # the first divergence must be a true near-tie of the reference's logits
        at = int(diff[0])
        seq = ref_toks[row:row + 1, :at]
        m = torch.cat([mask[row:row + 1], torch.ones_like(seq[:, PROMPT:])], dim=-1)
        with torch.inference_mode():
            last = ref(seq, attention_mask=m, positions=_positions_from_mask(m))[0, -1]
        gap = float(last[ref_toks[row, at]] - last[toks[row, at]])
        print(f"[{tag}] row {row} diverges at step {at - PROMPT}: logit gap {gap:.3e} "
              f"(tol {tol:.3e})", flush=True)
        require(gap <= tol, f"{tag} tokens differ at row {row}, step {at - PROMPT}, gap {gap}")
    same = int((toks == ref_toks).all(dim=-1).sum())
    print(f"[{tag}] greedy {F32_NEW} tokens: {same}/{toks.shape[0]} rows identical to the "
          "reference", flush=True)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def device_busy(label: str, calls: int = 1, kernels: dict | None = None):
    """Profile a block of ``calls`` calls with torch.profiler, recording the
    card alone (host operators' ranges, ``Optimizer.step#AdamW.step`` among
    them, would count their kernels' time again, and make a session of 10^5
    kernels slow to read back), in ``benchlib.device_profile``'s padded
    window, which keeps every kernel's record (ROADMAP C.10).  Yields a dict that receives ``busy_ms``,
    the device time per call (None when the profiler sees no device time),
    and ``wall_ms``, the wall time per call with the profiler on; prints
    the top kernels by device time.  ``kernels``, where given, receives
    each device kernel's launches a call by name."""
    result = {}
    torch.cuda.synchronize()
    with benchlib.device_profile() as prof:
        t0 = time.perf_counter()
        yield result
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    if kernels is not None:
        for _, count, key in rows:
            kernels[key] = kernels.get(key, 0) + count / calls
    busy_ms = sum(row[0] for row in rows) / calls
    result.update(busy_ms=busy_ms or None, wall_ms=wall_ms)
    if busy_ms == 0:
        print(f"[profile] {label}: device time not measured (the profiler saw no device time)",
              flush=True)
        return
    launches = sum(row[1] for row in rows) / calls
    print(f"[profile] {calls} {label} under the profiler: wall {wall_ms:.3f} ms each "
          f"(profiler on), device busy {busy_ms:.3f} ms and {launches:.0f} kernels each",
          flush=True)
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   {dev_ms / calls:8.4f} ms  {count // calls:5d} launches  {key[:90]}",
              flush=True)


def device_busy_ms(fn, calls: int, label: str, kernels: dict | None = None):
    """``device_busy``'s device ms per call of ``fn(i)``, i < ``calls``."""
    with device_busy(label, calls, kernels) as result:
        for i in range(calls):
            fn(i)
    return result["busy_ms"]


@torch.inference_mode()
def profile_decode(model, ids, mask, steps: int = 8, kernels: dict | None = None,
                   wrappers: list | None = None):
    """Device time per decode forward after a prefill, from torch.profiler;
    ``kernels`` as ``device_busy_ms``'s; ``wrappers``, where given, receives
    the wrappers' launch counts (``counts``) of each profiled step, one dict
    a step."""
    from sparse_matrix_fine_tuning_torch.models.generate import _positions_from_mask
    from sparse_matrix_fine_tuning_torch.models.llama import init_caches

    b, t = ids.shape
    caches = init_caches(model.config, b, t + steps + 1, torch.bfloat16, "cuda")
    mask_full = torch.cat([mask, mask.new_zeros(b, steps + 1)], dim=-1)
    pos = _positions_from_mask(mask)
    logits, caches = model(ids, attention_mask=mask_full, positions=pos, caches=caches,
                           cache_index=0)
    tok, pos = logits[:, -1].argmax(-1)[:, None], pos[:, -1:] + 1

    def step(i):
        mask_full[:, t + i] = 1
        return model(tok, attention_mask=mask_full, positions=pos + i, caches=caches,
                     cache_index=t + i)

    def counted(i):
        before = counts()
        out = step(i + 1)
        if wrappers is not None:
            after = counts()
            wrappers.append({k: after[k] - before[k] for k in after})
        return out

    step(0)
    return device_busy_ms(counted, steps, "decode steps", kernels)


def phase_bf16(f32: dict, card: str) -> dict:
    """The slice in bfloat16, timed as bench.py times the JAX one: batch 4,
    prompt 64, 128 new tokens, no EOS; prefill the median of 3 timed
    1-token generates (2 merged), a step from the counted generate (one
    sample each, unmerged and merged: the repeats were cut to pay for the
    BLIP phases).  The counted main path is: unmerged
    greedy generate (K2 on every adapted linear), merge of the adapters on
    the card (K1), greedy generate of the merged model."""
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    model = build_model("bfloat16", f32["state"])
    resident_gb = torch.cuda.memory_allocated() / 1e9
    with torch.inference_mode():
        logits = model(f32["ids"], attention_mask=f32["mask"])
    valid = f32["mask"].bool()
    require(bool(torch.isfinite(logits).all()), "non-finite bf16 logits")
    cos = float(torch.nn.functional.cosine_similarity(
        logits[valid].float().flatten(), f32["logits"][valid].float().flatten(), dim=0))
    print(f"[bf16] prefill logits cosine to f32: {cos:.5f} (need >= 0.99)", flush=True)
    require(cos >= 0.99, f"bf16 prefill logits cosine {cos} < 0.99")

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    mask = torch.ones(BATCH, PROMPT, dtype=torch.long, device="cuda")

    def fresh_ids():
        return torch.randint(2, MODEL["vocab_size"], (BATCH, PROMPT), generator=g, device="cuda")

    gc = GenerationConfig(max_new_tokens=NEW, eos_token_id=None)
    gc1 = GenerationConfig(max_new_tokens=1, eos_token_id=None)
    steps = NEW - 1  # decode forwards: one per new token after the prefill's

    def gen_s(new_cfg):
        ids = fresh_ids()
        return timed(lambda: generate(model, ids, mask, new_cfg))[1]

    generate(model, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
    prefill = [gen_s(gc1) for _ in range(3)]
    gens = []
    busy_ms = profile_decode(model, fresh_ids(), mask)
    probe = fresh_ids()
    with torch.inference_mode():
        unmerged_logits = model(probe, attention_mask=mask)

    reset_counts()  # the counted main path starts here
    ids = fresh_ids()
    toks, main_s = timed(lambda: generate(model, ids, mask, gc))
    adds = monarch_cuda.LAUNCHES["monarch_add"]
    _, merge_s = timed(lambda: merge_all_adapters(model))
    merged_toks, merged_main_s = timed(lambda: generate(model, ids, mask, gc))
    launches = counts()  # the counted main path ends here

    require(tuple(toks.shape) == (BATCH, PROMPT + NEW), f"tokens {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < MODEL["vocab_size"])).all()), "token out of range")
    want = N_ADAPTED * (1 + steps)
    print(f"[bf16] launches in the main path: {launches}; monarch_add in the unmerged "
          f"generate {adds}, expected {N_ADAPTED} x (1 + {steps}) = {want}", flush=True)
    require(adds == want == launches["monarch_add"], "fused-add launches do not match")
    require(launches["monarch_kernel"] == N_ADAPTED,
            f"merge launched monarch_kernel {launches['monarch_kernel']} times, "
            f"expected {N_ADAPTED}")
    require(all(launches[k] == 0 for k in QUANT_KERNELS), f"quantized kernels ran: {launches}")

    with torch.inference_mode():
        merged_logits = model(probe, attention_mask=mask)
    merged_cos = float(torch.nn.functional.cosine_similarity(
        merged_logits.float().flatten(), unmerged_logits.float().flatten(), dim=0))
    agree = float((merged_toks[:, PROMPT:] == toks[:, PROMPT:]).float().mean())
    merged_prefill = [gen_s(gc1) for _ in range(2)]
    merged_gens = [merged_main_s]

    med = statistics.median
    prefill_ms = med(prefill) * 1e3
    gen_med = med(gens + [main_s])
    decode_ms = (gen_med * 1e3 - prefill_ms) / steps
    merged_prefill_ms = med(merged_prefill) * 1e3
    merged_decode_ms = (med(merged_gens) * 1e3 - merged_prefill_ms) / steps
    print(f"[bf16] {card}: batch {BATCH}, prompt {PROMPT}, {NEW} new tokens, unmerged adapters: "
          f"prefill {prefill_ms:.3f} ms (median of {len(prefill)}), decode {decode_ms:.4f} "
          f"ms/step, {BATCH * NEW / gen_med:.1f} tokens/s (generate median of "
          f"{len(gens) + 1}: {gen_med:.4f} s; all {[round(x, 4) for x in gens + [main_s]]}); "
          f"weights and buffers resident {resident_gb:.3f} GB", flush=True)
    if busy_ms is not None:
        print(f"[bf16] {card}: decode device busy {busy_ms:.3f} ms/step (profiled) of {decode_ms:.3f} "
              f"ms/step (unprofiled): idle share {1 - busy_ms / decode_ms:.3f}", flush=True)
    print(f"[bf16] {card}: merged on the card in {merge_s * 1e3:.1f} ms; merged: prefill "
          f"{merged_prefill_ms:.3f} ms, decode {merged_decode_ms:.4f} ms/step, "
          f"{BATCH * NEW / med(merged_gens):.1f} tokens/s; prefill logits cosine merged to "
          f"unmerged {merged_cos:.5f}; greedy tokens agree on {agree:.3f} of positions",
          flush=True)
    require(merged_cos >= 0.99, f"merged bf16 logits cosine {merged_cos} < 0.99")
    return {"launches": launches}


def train_data(rows: int, seq: int, seed: int) -> dict:
    """Seeded random token rows, every position a label (numpy, as Trainer
    takes them)."""
    import numpy as np

    ids = np.random.default_rng(seed).integers(3, MODEL["vocab_size"], (rows, seq)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids.copy()}


def train_model(dtype: str, layers: int, attention_impl: str = "einsum"):
    """The training slice's model on the card: TinyLlama-1.1B widths,
    ``layers`` decoder layers, adapters on all seven projections with the
    random nonzero factors of ``randomize_adapters``; the same weights for
    every ``attention_impl``."""
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    cfg = LlamaConfig(**{**MODEL, "num_hidden_layers": layers}, param_dtype=dtype, dtype=dtype,
                      max_position_embeddings=TRAIN_SEQ, attention_impl=attention_impl)
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    model = LlamaForCausalLM(cfg, device="cuda", generator=g)
    require(len(init_monarch(model, PEFT, generator=g)) == 7 * layers, "adapters missing")
    randomize_adapters(model)
    return model


def train_args(merged: str, bs: int, ga: int, steps: int):
    from sparse_matrix_fine_tuning_torch.training.trainer import TrainingArgs

    return TrainingArgs(output_dir=os.path.join(OUT_DIR, "train"), learning_rate=TRAIN_LR,
                        max_steps=steps, per_device_train_batch_size=bs,
                        gradient_accumulation_steps=ga, warmup_ratio=0.0, logging_steps=0,
                        log_param_steps=0, merged_training=merged)


def check_step(model, data: dict, merged: str, expect: dict, tag: str) -> dict:
    """One optimizer step (``F32_TRAIN``) through Trainer on the card and on
    a CPU copy on the plain path.  The card's step launches exactly
    ``expect``; the loss, every factor's gradient and the updated factors
    agree within the F32_TRAIN_* tolerances.  ``tag`` opens the printed
    line; returns the card's launch counts, loss and factor gradients."""
    import copy

    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    c = F32_TRAIN
    out = {}
    for dev, m in (("cuda", model), ("cpu", copy.deepcopy(model).cpu())):
        tr = Trainer(m, train_args(merged, c["bs"], c["ga"], 1), train_data=data,
                     extra_trainable_paths=(), device=dev)
        batch, _ = next(tr._batches(data, c["bs"], shuffle=False, accum=c["ga"]))
        reset_counts()
        loss = float(tr.train_step(batch))
        launches = counts()
        out[dev] = (loss, {n: (p.grad.detach().cpu(), p.detach().cpu())
                           for n, p in m.named_parameters() if p.requires_grad}, launches)
        tr.close()
    (loss, got, launches), (want_loss, want, _) = out["cuda"], out["cpu"]
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"{tag}: launches {launches}, expected {expect}")
    require(abs(loss - want_loss) <= F32_TRAIN_LOSS_RTOL * abs(want_loss),
            f"{tag}: loss {loss} on the card, {want_loss} on the CPU")
    require(sorted(got) == sorted(want) and len(got) == 2 * 7 * c["layers"],
            f"{tag}: the trainable set is not the factors")
    worst_g = worst_p = 0.0
    for name, (grad, param) in got.items():
        wgrad, wparam = want[name]
        scale = float(wgrad.abs().max())
        eg = float((grad - wgrad).abs().max())
        require(eg <= F32_TRAIN_GRAD_TOL * scale,
                f"{tag}: grad of {name}: {eg} > {F32_TRAIN_GRAD_TOL} x {scale}")
        strong = wgrad.abs() >= 1e-3 * scale
        dp = (param - wparam).abs()
        require(float(dp[strong].max()) <= 1e-2 * TRAIN_LR
                and float(dp.max()) <= 2 * TRAIN_LR, f"{tag}: update of {name}")
        worst_g, worst_p = max(worst_g, eg / scale), max(worst_p, float(dp.max()))
    print(f"{tag}: loss {loss:.6f} card, {want_loss:.6f} CPU; worst factor gradient error "
          f"{worst_g:.2e} of its scale; worst update difference {worst_p:.2e} (lr {TRAIN_LR}); "
          f"launches {expect}", flush=True)
    return {"launches": launches, "loss": loss, "grads": {n: g for n, (g, _) in got.items()}}


def train_timed(model, merged: str, tag: str, extra: str = "",
                steps: int = TRAIN_STEPS) -> dict:
    """bf16 training at full size through Trainer: bs 4 x ga 8 x seq 512, 1
    warm-up and ``steps`` - 1 timed optimizer steps, the launch counts zeroed just
    before the first step and read just after the last, then one step
    under the profiler.  Prints step ms, tokens/s, MFU, peak memory and the
    idle share after ``tag`` (and ``extra``); returns the losses, the
    launch counts and those numbers."""
    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    data = train_data(TRAIN_BS * TRAIN_GA * steps, TRAIN_SEQ, SEED + 10)
    cfg = model.config
    h, i, kv = cfg.hidden_size, cfg.intermediate_size, cfg.kv_heads * cfg.head_width
    p_matmul = cfg.num_hidden_layers * (2 * h * h + 2 * h * kv + 3 * h * i) + h * cfg.vocab_size
    # Model FLOPs per token with a frozen base: forward 2P and input
    # gradient 2P for every matmul (no weight gradient), plus 12 L h T for
    # the attention scores and values (causality not discounted); the
    # adapters' own FLOPs are left out.  bench.py:460-465 counts 6P: its
    # base is frozen too, but it counts the weight gradient.
    flops_per_token = 4 * p_matmul + 12 * cfg.num_hidden_layers * h * TRAIN_SEQ
    tr = Trainer(model, train_args(merged, TRAIN_BS, TRAIN_GA, steps), train_data=data,
                 extra_trainable_paths=(), device="cuda")
    batches = [b for b, _ in tr._batches(data, TRAIN_BS, shuffle=False, accum=TRAIN_GA)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the counted main path starts here
    losses, secs = [], []
    for batch in batches:
        loss, sec = timed(lambda: tr.train_step(batch))
        losses.append(float(loss))
        secs.append(sec)
    launches = counts()  # the counted main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(secs[1:]) * 1e3
    busy = device_busy_ms(lambda k: tr.train_step(batches[k]), 1,
                          f"bf16 training step ({tag.split(': ', 1)[-1]})")
    opt_bytes = tr.optimizer.state_bytes()
    tr.close()
    require(all(map(math.isfinite, losses)), f"{tag}: losses {losses}")
    tps = TRAIN_BS * TRAIN_GA * TRAIN_SEQ / (step_ms / 1e3)
    mfu = flops_per_token * tps / benchlib.PEAK_OPS[torch.bfloat16]
    idle = f"{1 - busy / step_ms:.3f}" if busy is not None else "not measured"
    print(f"{tag}: losses {[round(x, 5) for x in losses]}; step {step_ms:.2f} ms (median of "
          f"{len(secs) - 1}; all {[round(x * 1e3, 2) for x in secs]}), {tps:.0f} tokens/s, MFU "
          f"{100 * mfu:.2f}% of 989 TFLOP/s ({flops_per_token / 1e9:.3f} GFLOP/token: 4 P_matmul "
          f"+ 12 L h T), {extra}peak memory {peak_gb:.2f} GB, device busy "
          f"{busy if busy is None else round(busy, 2)} ms/step, idle share {idle}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return {"losses": losses, "launches": launches, "step_ms": step_ms, "busy_ms": busy,
            "peak_gb": peak_gb, "mfu": mfu, "opt_state_bytes": opt_bytes}


def phase_train_f32(card: str) -> None:
    """One optimizer step (bs 2 x ga 2 x seq 128, full width, 2 layers, f32,
    TF32 off) through Trainer on the card against a CPU copy on the plain
    path (``check_step``), with merged training off (K2 forward, K3
    backward) and on (K4); then with ``attention_impl="splash"``, merged
    off (K17 forward, K18 and K19 backward in every layer, the CPU copy on
    their plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = F32_TRAIN
    model = train_model("float32", c["layers"])
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    data = train_data(c["bs"] * c["ga"], c["seq"], SEED + 9)
    n = 7 * c["layers"] * c["ga"]
    expect = {"off": {"monarch_add": n, "monarch_bwd": n}, "on": {"monarch_dw_fused": n}}
    steps = {}
    for merged in ("off", "on"):
        model.load_state_dict(state)
        steps[merged] = check_step(model, data, merged, expect[merged],
                                   f"[train-f32] {card}: merged {merged}")
    # remat "dots": the forward kernel again in the recompute, K3 once; the
    # step against the one without remat on the card, then the CPU copy's
    model.load_state_dict(state)
    set_remat(model, "dots")
    remat = check_step(model, data, "off", {"monarch_add": 2 * n, "monarch_bwd": n},
                       f"[train-f32] {card}: remat dots, merged off")
    plain = steps["off"]
    require(abs(remat["loss"] - plain["loss"]) <= F32_TRAIN_LOSS_RTOL * abs(plain["loss"]),
            f"remat dots: loss {remat['loss']}, {plain['loss']} without remat")
    worst = 0.0
    for name, grad in plain["grads"].items():
        err = float((remat["grads"][name] - grad).abs().max()) / float(grad.abs().max())
        require(err <= F32_TRAIN_GRAD_TOL, f"remat dots: grad of {name} {err:.2e} of its scale")
        worst = max(worst, err)
    print(f"[train-f32] {card}: remat dots against no remat on the card: loss {remat['loss']:.6f} "
          f"/ {plain['loss']:.6f}, worst factor gradient error {worst:.2e} of its scale "
          f"(tol {F32_TRAIN_GRAD_TOL})", flush=True)
    del model
    model = train_model("float32", c["layers"], attention_impl="splash")
    check_step(model, data, "off", {**expect["off"], **dict.fromkeys(ATTN_KERNELS, n // 7)},
               f"[train-f32] {card}: splash attention, merged off")
    del model
    torch.cuda.empty_cache()


def phase_train_bf16(card: str) -> dict:
    """The training slice at full size (``train_timed``): TinyLlama-1.1B
    widths, all 22 layers, bf16; merged training off and then on from the
    same factors on the same batches."""
    model = train_model("bfloat16", MODEL["num_hidden_layers"])
    factors = {n: p.detach().clone() for n, p in model.named_parameters() if "blkdiag" in n}
    runs = {}
    for merged in ("off", "on"):
        restore_factors(model, factors)
        runs[merged] = train_timed(model, merged, f"[train-bf16] {card}: merged {merged}")
        launches = runs[merged]["launches"]
        want = N_ADAPTED * TRAIN_GA * TRAIN_STEPS
        counted = ("monarch_add", "monarch_bwd") if merged == "off" else ("monarch_dw_fused",)
        require(all(launches[k] == want for k in counted)
                and all(v == 0 for k, v in launches.items() if k not in counted),
                f"merged {merged}: launches {launches}; expected {want} of {counted}")
    diff = max(abs(a - b) for a, b in zip(runs["off"]["losses"], runs["on"]["losses"]))
    print(f"[train-bf16] merged against unmerged: largest loss difference {diff:.5f} "
          f"(tol {BF16_MERGED_LOSS_ATOL})", flush=True)
    require(diff <= BF16_MERGED_LOSS_ATOL, f"merged and unmerged losses differ by {diff}")
    del model
    torch.cuda.empty_cache()
    return {"launches": {**runs["off"]["launches"],
                         "monarch_dw_fused": runs["on"]["launches"]["monarch_dw_fused"]},
            "losses": runs["off"]["losses"], "off": runs["off"]}


@torch.no_grad()
def restore_factors(model, factors: dict) -> None:
    for n, p in model.named_parameters():
        if n in factors:
            p.copy_(factors[n])


def set_remat(model, policy) -> None:
    """Remat on with ``policy`` ("dots" or "nothing"), or off (None): the
    decoder stack reads its config at every forward."""
    cfg = dataclasses.replace(model.config, remat=policy is not None,
                              remat_policy=policy or "nothing")
    model.config = model.model.config = cfg


def remat_step(model, factors: dict, merged: str, policy) -> tuple[float, dict]:
    """One optimizer step (bs 4 x ga 8 x seq 512) from ``factors`` with remat
    ``policy`` (None: off) through a fresh Trainer on ``train_timed``'s first
    batch; the loss and the step's launches."""
    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    restore_factors(model, factors)
    set_remat(model, policy)
    data = train_data(TRAIN_BS * TRAIN_GA, TRAIN_SEQ, SEED + 10)
    tr = Trainer(model, train_args(merged, TRAIN_BS, TRAIN_GA, 1), train_data=data,
                 extra_trainable_paths=(), device="cuda")
    batch, _ = next(tr._batches(data, TRAIN_BS, shuffle=False, accum=TRAIN_GA))
    torch.cuda.synchronize()
    reset_counts()
    loss = float(tr.train_step(batch))
    launches = counts()
    tr.close()
    set_remat(model, None)
    return loss, launches


def phase_train_remat(card: str, plain: dict) -> None:
    """Remat at full size (``train_timed``: TinyLlama-1.1B widths, all 22
    layers, bf16, bs 4 x ga 8 x seq 512, merged off) from
    ``phase_train_bf16``'s factors on its first ``REMAT_STEPS`` batches,
    "dots" then "nothing", each beside ``plain`` (that phase's merged-off
    run, no remat): ms a step (the one after the warm-up), busy, idle
    share, peak memory, MFU (the same FLOPs: the recompute is no useful
    work).  Launches, derived from the code: the recompute runs each
    adapted linear's forward again, so K2 launches twice an adapted linear
    and micro-batch (2 x 154 x 8 x 2 = 4,928) under either policy ("dots"
    keeps only ``aten.mm``'s outputs, and K2 adds into one of them); K3
    once (2,464).  The losses within ``BF16_MERGED_LOSS_ATOL`` of
    ``plain``'s.  Then one step from the same
    factors with merged training on, without remat and under "dots": K4
    once an adapted linear and micro-batch (1,232) in both, the merged
    product's output kept, so no kernel of ours in the recompute; the
    losses within the same tolerance.  Then a splash model (the same
    weights, ``attention_impl="splash"``): one step without remat and one
    under "nothing", where K17 runs twice a layer and micro-batch (352),
    K18 and K19 once (176), K2 2,464 and K3 1,232."""
    model = train_model("bfloat16", MODEL["num_hidden_layers"])
    factors = {n: p.detach().clone() for n, p in model.named_parameters() if "blkdiag" in n}
    want = N_ADAPTED * TRAIN_GA * REMAT_STEPS
    rows = {"none": plain}
    for policy in ("dots", "nothing"):
        restore_factors(model, factors)
        set_remat(model, policy)
        run = train_timed(model, "off", f"[train-remat] {card}: remat {policy}, merged off",
                          steps=REMAT_STEPS)
        set_remat(model, None)
        expect = {"monarch_add": 2 * want, "monarch_bwd": want}
        launches = run["launches"]
        require(launches == {**dict.fromkeys(launches, 0), **expect},
                f"remat {policy}: launches {launches}; expected {expect}")
        diff = max(abs(a - b) for a, b in zip(run["losses"], plain["losses"]))
        require(diff <= BF16_MERGED_LOSS_ATOL, f"remat {policy}: losses {run['losses']}, "
                                               f"{plain['losses']} without remat")
        rows[policy] = {**run, "loss_diff": diff}
    for policy, r in rows.items():
        busy = r["busy_ms"]
        idle = f"{1 - busy / r['step_ms']:.3f}" if busy is not None else "not measured"
        timed_steps = (TRAIN_STEPS if policy == "none" else REMAT_STEPS) - 1
        print(f"[train-remat] {card}: remat {policy:7s}: step {r['step_ms']:.2f} ms (wall, "
              f"median of {timed_steps}), device busy "
              f"{busy if busy is None else round(busy, 2)} ms, idle share {idle}, peak "
              f"{r['peak_gb']:.2f} GB, MFU {100 * r['mfu']:.2f}%, largest loss difference "
              f"from no remat {r.get('loss_diff', 0.0):.5f}", flush=True)
    RECORDS.append({"train_remat": {p: {k: r[k] for k in ("step_ms", "busy_ms", "peak_gb", "mfu",
                                                         "losses")} for p, r in rows.items()},
                    "card": card})
    steps = {}
    for policy in (None, "dots"):
        steps[policy] = remat_step(model, factors, "on", policy)
        expect = {"monarch_dw_fused": N_ADAPTED * TRAIN_GA}
        launches = steps[policy][1]
        require(launches == {**dict.fromkeys(launches, 0), **expect},
                f"merged on, remat {policy}: launches {launches}; expected {expect}")
    diff = abs(steps["dots"][0] - steps[None][0])
    require(diff <= BF16_MERGED_LOSS_ATOL, f"merged on: remat dots loss {steps['dots'][0]}, "
                                           f"{steps[None][0]} without")
    print(f"[train-remat] {card}: merged on, one step: loss {steps['dots'][0]:.5f} under dots, "
          f"{steps[None][0]:.5f} without remat; launches {expect} in both", flush=True)
    del model
    torch.cuda.empty_cache()
    model = train_model("bfloat16", MODEL["num_hidden_layers"], attention_impl="splash")
    per_layer = MODEL["num_hidden_layers"] * TRAIN_GA
    steps = {}
    for policy in (None, "nothing"):
        steps[policy] = remat_step(model, factors, "off", policy)
        twice = 2 if policy else 1
        expect = {"monarch_add": twice * N_ADAPTED * TRAIN_GA, "monarch_bwd": N_ADAPTED * TRAIN_GA,
                  "splash_fwd": twice * per_layer, "splash_dq": per_layer,
                  "splash_dkv": per_layer}
        launches = steps[policy][1]
        require(launches == {**dict.fromkeys(launches, 0), **expect},
                f"splash, remat {policy}: launches {launches}; expected {expect}")
    diff = abs(steps["nothing"][0] - steps[None][0])
    require(diff <= BF16_MERGED_LOSS_ATOL, f"splash: remat nothing loss {steps['nothing'][0]}, "
                                           f"{steps[None][0]} without")
    print(f"[train-remat] {card}: splash attention, one step: loss {steps['nothing'][0]:.5f} "
          f"under nothing, {steps[None][0]:.5f} without remat; launches under nothing {expect}",
          flush=True)
    del model
    torch.cuda.empty_cache()


# -- splash attention (K17-K19) ---------------------------------------------------

@contextlib.contextmanager
def skipped_kv_tile():
    """A planted fault in the plain versions (``ops/attention.py``): the
    last 64-row q tile skips kv tile 0, as a kernel whose loop started one
    tile late there would (K17 renormalises without it; K18 and K19, given
    the true lse, get p = 0 there).  Needs t > 64."""
    from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref

    scores = attn_ref._scores

    def faulty(q, k):
        s = scores(q, k)
        last = (s.shape[-1] - 1) // ATTN_BLOCK_ROWS * ATTN_BLOCK_ROWS
        require(last > 0, "skipped_kv_tile needs t > 64")
        return torch.cat([s[..., :last, :], torch.cat(
            [torch.full_like(s[..., last:, :ATTN_BLOCK_ROWS], float("-inf")),
             s[..., last:, ATTN_BLOCK_ROWS:]], -1)], -2)

    attn_ref._scores = faulty
    try:
        yield
    finally:
        attn_ref._scores = scores


def narrowed(dtype: torch.dtype, *xs):
    """A planted fault: the operands rounded to the next narrower type
    (bf16 -> float8_e4m3, f32 -> bf16) and back, as a kernel that loaded
    them at that precision would see them."""
    narrow = torch.float8_e4m3fn if dtype == torch.bfloat16 else torch.bfloat16
    return [x.to(narrow).to(dtype) for x in xs]


def attention_check(got: tuple, ref: tuple, dtype: torch.dtype) -> dict:
    """K17-K19's check of one call's outputs against the plain version's:
    every output finite, of ref's shape and dtype, within ``tolerance`` of
    its scale (the lse: 1e-5 of it), and each (b, t, h, d) output within
    ``ATTN_BLOCK_RTOL`` row block by row block (``attention_block_error``).
    Returns the largest abs error, the largest share of either tolerance,
    the largest block error and whether every bound held."""
    err = share = block = 0.0
    ok = True
    for a, b in zip(got, ref):
        e = float((a.float() - b.float()).abs().max())
        tol = (1e-5 * float(b.abs().max()) if b.dtype == torch.float32 and
               dtype == torch.bfloat16 else tolerance(dtype, b))
        ok &= a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all())
        ok &= e <= tol
        err, share = max(err, e), max(share, e / tol)
        if b.dim() == 4:
            blk = attention_block_error(a, b)
            ok &= blk <= ATTN_BLOCK_RTOL[dtype]
            block, share = max(block, blk), max(share, blk / ATTN_BLOCK_RTOL[dtype])
    return {"err": err, "share": share, "block": block, "ok": ok}


def phase_attention(card: str, lib) -> dict:
    """K17, K18 and K19 (``csrc/flash_attention.cu``) against their plain
    versions (``ops/attention.py``) at ``ATTN_SHAPES``, bf16 and f32
    (``attention_check``), the backward kernels fed the plain forward's lse
    and di; two planted faults of the plain versions (``skipped_kv_tile``,
    ``narrowed``) must fail the same check at every case, and the printed
    line says whether the scale-wide bound alone would have seen them;
    ptxas's registers (no spill in any of the 12 instantiations), HGMMA in
    the SASS of the persistent K17, K18 and K19 at head_dim 64 and 128
    (``check_hgmma``), each bf16 shape's schedule (CTAs, items, stages: the
    card's plan, which must be the Python mirror's); timed in
    bf16 at the bench's and the 1.1B micro-batch's shape beside the bound,
    the plain version and SDPA (``scaled_dot_product_attention(is_causal=
    True)``: its forward for K17, its backward through
    ``torch.autograd.grad`` (dq, dk and dv in one call) for K18 and K19).
    Returns the worst errors and the 1.1B shape's records."""
    import torch.nn.functional as F

    from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref

    for kernel in ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel", "fwd_f32_kernel",
                   "dq_f32_kernel", "dkv_f32_kernel"):
        kernel_ptxas(lib, kernel, 2, "attention")
    hgmma = sum(check_hgmma(lib, kernel, 2)
                for kernel in ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel"))
    print(f"[attention] {card}: HGMMA in all {hgmma} persistent K17-K19 kernels, none spills",
          flush=True)
    for label, shape in ATTN_SHAPES:
        for name in ATTN_KERNELS:
            plan = attention_cuda.attention_plan(name, *shape)
            require(plan == attention_cuda.schedule_plan(name, *shape, plan["sms"], plan["per_sm"]),
                    f"{name} {shape}: the card's plan {plan} is not the mirror's")
            print(f"[attention] schedule {name:10s} {label:6s} {tuple(shape)}: {plan['ctas']} CTAs "
                  f"({plan['per_sm']} an SM) over {plan['items']} items, {plan['steps']} steps of "
                  f"{plan['step_rows']} rows, {plan['passes']} pass(es), {plan['stages']} stages, "
                  f"{plan['smem']} bytes of shared memory", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    worst, layer = dict.fromkeys(ATTN_KERNELS, 0.0), {}
    blocks = {}
    for label, shape in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, dout = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
            q = q / shape[-1] ** 0.5
            q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
            o_ref, lse_ref = attn_ref.causal_attention_reference(q, k, v)
            di = attn_ref.attention_di(o_ref, dout)
            # the library call: SDPA on (b, h, t, d) views, q already scaled
            qh, kh, vh = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            sdpa = {}

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0)

            def sdpa_bwd():
                if "out" not in sdpa:
                    sdpa["out"] = sdpa_fwd()
                return torch.autograd.grad(sdpa["out"], (qh, kh, vh), dout.transpose(1, 2),
                                           retain_graph=True)

            plains = {
                "splash_fwd": lambda q, k, v, dout: attn_ref.causal_attention_reference(q, k, v),
                "splash_dq": lambda q, k, v, dout: attn_ref.attention_dq_reference(
                    q, k, v, dout, lse_ref, di),
                "splash_dkv": lambda q, k, v, dout: attn_ref.attention_dkv_reference(
                    q, k, v, dout, lse_ref, di)}
            cases = {
                "splash_fwd": (lambda: attention_cuda.splash_fwd(q, k, v), sdpa_fwd),
                "splash_dq": (lambda: attention_cuda.splash_dq(q, k, v, dout, lse_ref, di),
                              sdpa_bwd),
                "splash_dkv": (lambda: attention_cuda.splash_dkv(q, k, v, dout, lse_ref, di),
                               sdpa_bwd)}
            for name, (kern, library) in cases.items():
                plain = functools.partial(plains[name], q, k, v, dout)
                before = attention_cuda.LAUNCHES[name]
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                require(attention_cuda.LAUNCHES[name] == before + 1, f"{name} did not launch")
                got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
                c = attention_check(got, ref, dtype)
                require(c["ok"], f"{name} {label} {tuple(shape)} {dtype}: max abs err "
                        f"{c['err']}, block error {c['block']} ({c['share']} of a tolerance)")
                worst[name] = max(worst[name], c["err"])
                key = f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
                blocks[key] = max(blocks.get(key, 0.0), c["block"])
                # the planted faults: the same check must reject each
                with skipped_kv_tile():
                    tile = plain()
                prec = plains[name](*narrowed(dtype, q, k, v, dout))
                faults = {}
                for fault, out in (("tile", tile), ("narrow", prec)):
                    out = out if isinstance(out, tuple) else (out,)
                    f = attention_check(out, ref, dtype)
                    require(not f["ok"], f"{name} {label} {tuple(shape)} {dtype}: the planted "
                            f"fault {fault} passed the check ({f})")
                    scale_share = max(float((a.float() - b.float()).abs().max())
                                      / tolerance(dtype, b) for a, b in zip(out, ref)
                                      if b.dim() == 4)
                    faults[fault] = {"block": f["block"], "scale_share": scale_share,
                                     "block_share": f["block"] / ATTN_BLOCK_RTOL[dtype]}
                shown = ", ".join(f"{f} {v['block']:.4f} ({v['block_share']:.1f} of the limit; "
                                  f"{v['scale_share']:.2f} of the scale-wide bound)"
                                  for f, v in faults.items())
                print(f"[attention] {name:10s} {label:6s} {tuple(shape)} {key.split()[1]}: "
                      f"err {c['err']:.3e}, block {c['block']:.3e} ({c['share']:.3f} of a tol); "
                      f"planted faults rejected, block errors {shown}", flush=True)
                RECORDS.append({"kernel": name, "label": label, "shape": list(shape),
                                "dtype": key.split()[1], "check": c, "faults": faults})
                if label == "ragged" or dtype != torch.bfloat16:
                    continue
                ms, call = time_ms(kern, ATTN_REPS, ATTN_ROUNDS)
                plain_ms, plain_call = time_ms(plain, ATTN_REPS, ATTN_ROUNDS)
                library_ms = time_ms(library, ATTN_REPS, ATTN_ROUNDS)[0]
                nbytes, ops = attention_cost(name, shape, dtype)
                bound_ms, bound_by = roofline_ms(nbytes, ops, dtype)
                rec = {"kernel": name, "label": label, "shape": list(shape), "dtype": "bfloat16",
                       "max_abs_err": c["err"], "share_of_tol": c["share"], "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "call_ms": call, "plain_call_ms": plain_call,
                       "TFLOP_per_s": ops / ms / 1e9}
                RECORDS.append(rec)
                print(f"[attention] {name:10s} {label:6s} {tuple(shape)} bf16: {ms:.5f} ms (call "
                      f"{call:.5f}), plain {plain_ms:.5f}, SDPA {library_ms:.5f}, bound "
                      f"{bound_ms:.5f} ({bound_by}), {100 * bound_ms / ms:.1f}% of it, "
                      f"{ops / ms / 1e9:.1f} TFLOP/s", flush=True)
                if label == "1.1B":
                    layer[name] = rec
    print(f"[attention] {card}: K17-K19 within tolerance at {len(ATTN_SHAPES)} shapes, bf16 and "
          f"f32; worst abs errors {worst}; worst block errors {blocks} (limits "
          f"{ {str(k): v for k, v in ATTN_BLOCK_RTOL.items()} })", flush=True)
    return {"worst": worst, "layer": layer}


def einsum_attention(q, k, v, causal: bool = True):
    """``LlamaAttention``'s einsum branch with the causal bias alone (an
    all-ones mask): bf16 scores, in fp32 over sqrt(head_dim), an fp32
    softmax, the probabilities in q's dtype, times v.  ``causal=False`` is a
    control: the mask dropped."""
    t = q.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(scores, -1).to(q.dtype), v)


def plain_splash_attention(q, k, v):
    """``_splash_attention`` on K17's plain version (``ops/attention.py``);
    through autograd its backward keeps fp32 throughout."""
    from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref

    scale = float(torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype))
    return attn_ref.causal_attention_reference(q * scale, k, v)[0]


def tile_skipped_attention(q, k, v):
    """A control: ``plain_splash_attention`` with ``skipped_kv_tile``'s
    fault planted in it."""
    with skipped_kv_tile():
        return plain_splash_attention(q, k, v)


# Wrong attentions that the end-to-end check must reject (phase_train_splash).
ATTENTION_CONTROLS = {"no causal mask": functools.partial(einsum_attention, causal=False),
                      "o = v": lambda q, k, v: v,
                      "one kv tile skipped": tile_skipped_attention}


def first_batch_loss_and_grads(model, attention=None) -> tuple[float, list]:
    """The first training micro-batch's loss (as ``Trainer`` computes it)
    and the trainable factors' gradients, no optimizer step, with
    ``models/llama._splash_attention`` replaced by ``attention`` (None: the
    kernels)."""
    from sparse_matrix_fine_tuning_torch.models import llama
    from sparse_matrix_fine_tuning_torch.peft.surgery import trainable_filter

    data = train_data(TRAIN_BS * TRAIN_GA * TRAIN_STEPS, TRAIN_SEQ, SEED + 10)
    ids, mask, labels = (torch.as_tensor(data[k][:TRAIN_BS], device="cuda")
                         for k in ("input_ids", "attention_mask", "labels"))
    trainable_filter(model, ())
    params = [p for p in model.parameters() if p.requires_grad]
    kept = llama._splash_attention
    llama._splash_attention = attention or kept
    try:
        loss = model.training_loss(ids, labels, attention_mask=mask)
        # allow_unused: the control o = v leaves q_proj's factors out
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        llama._splash_attention = kept
    return float(loss.detach()), [torch.zeros_like(p, dtype=torch.float32) if g is None
                                  else g.float() for p, g in zip(params, grads)]


def phase_train_splash(card: str, einsum_losses: list) -> dict:
    """The training slice with ``attention_impl="splash"`` (``train_timed``:
    22 layers, bf16, bs 4 x ga 8 x seq 512, merged off), from the state and
    on the batches of ``phase_train_bf16``'s einsum run: K17, K18 and K19
    launch once a layer each micro-batch, exactly; the first step's loss is
    the einsum run's within ``SPLASH_LOSS_ATOL``.  Before it, on the fresh
    model's first micro-batch (``first_batch_loss_and_grads``): the loss
    within ``SPLASH_LOSS_ATOL`` and the factors' gradients within
    ``SPLASH_GRAD_RTOL`` (relative, all together) of ``einsum_attention``'s,
    and each of ``ATTENTION_CONTROLS`` outside one of the two.
    ``plain_splash_attention`` is read beside the kernels (printed, and the
    kernels' gradients against its)."""
    def rel(grads, ref):
        err = sum(float((g - r).square().sum()) for g, r in zip(grads, ref))
        return math.sqrt(err / sum(float(r.square().sum()) for r in ref))

    model = train_model("bfloat16", MODEL["num_hidden_layers"], attention_impl="splash")
    ref_loss, ref_grads = first_batch_loss_and_grads(model, einsum_attention)
    gaps, kept = {}, {}
    for tag, attention in {"splash": None, "plain fp32": plain_splash_attention, **ATTENTION_CONTROLS}.items():
        loss, grads = first_batch_loss_and_grads(model, attention)
        gaps[tag] = {"loss": abs(loss - ref_loss), "grad": rel(grads, ref_grads)}
        if tag in ("splash", "plain fp32"):
            kept[tag] = grads
    against_plain = rel(kept["splash"], kept["plain fp32"])
    del kept
    shown = "; ".join(f"{t}: {g['loss']:.6f}, {g['grad']:.3e}" for t, g in gaps.items())
    print(f"[train-splash] first micro-batch against the einsum branch (loss {ref_loss:.5f}), "
          f"loss gap and factor gradients' relative error: {shown} (limits {SPLASH_LOSS_ATOL}, "
          f"{SPLASH_GRAD_RTOL}); the kernels' gradients against the plain fp32 ones "
          f"{against_plain:.3e}", flush=True)
    g = gaps["splash"]
    require(g["loss"] <= SPLASH_LOSS_ATOL and g["grad"] <= SPLASH_GRAD_RTOL,
            f"splash against einsum on the first micro-batch: {g}")
    for tag in ATTENTION_CONTROLS:
        g = gaps[tag]
        require(g["loss"] > SPLASH_LOSS_ATOL or g["grad"] > SPLASH_GRAD_RTOL,
                f"the control {tag!r} passed the end-to-end check: {g}")
    RECORDS.append({"splash_first_batch": gaps, "splash_against_plain_fp32": against_plain,
                    "card": card})
    torch.cuda.empty_cache()
    run = train_timed(model, "off", f"[train-splash] {card}: attention splash, merged off")
    launches = run["launches"]
    want = N_ADAPTED * TRAIN_GA * TRAIN_STEPS
    per_kernel = MODEL["num_hidden_layers"] * TRAIN_GA * TRAIN_STEPS
    expect = {"monarch_add": want, "monarch_bwd": want, **dict.fromkeys(ATTN_KERNELS, per_kernel)}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"splash training: launches {launches}; expected {expect}")
    diffs = [abs(a - b) for a, b in zip(run["losses"], einsum_losses)]
    print(f"[train-splash] splash against einsum, same state and batches: loss differences "
          f"{[f'{d:.5f}' for d in diffs]} (the first within {SPLASH_LOSS_ATOL})", flush=True)
    require(diffs[0] <= SPLASH_LOSS_ATOL, f"splash's first loss differs by {diffs[0]}")
    del model
    torch.cuda.empty_cache()
    return run


def phase_bench_attention(card: str) -> None:
    """The port of ``scripts/bench_attention.py`` (its own checks and times),
    K17-K19's launches exact: one forward in its cross-check, and a forward
    and a backward in each of its splash steps; dpa's and splash's outputs
    within ``BENCH_ATTN_DIFF`` of einsum's."""
    from sparse_matrix_fine_tuning_torch.scripts import bench_attention

    reset_counts()  # the counted main path starts here: bench_attention
    out = bench_attention.run()
    launches = counts()  # ... and ends here
    steps = out["steps"]
    expect = {"splash_fwd": steps + 1, "splash_dq": steps, "splash_dkv": steps}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"bench_attention: launches {launches}; expected {expect}")
    require(all(math.isfinite(d) and d <= BENCH_ATTN_DIFF for d in out["diffs"].values()),
            f"bench_attention: differences against einsum {out['diffs']} (limit {BENCH_ATTN_DIFF})")
    RECORDS.append({"bench_attention": out, "card": card})


# -- the quantized base (K5-K8) ------------------------------------------------

def _quant_weight(bits: int, n_in: int, n_out: int, g: torch.Generator):
    """Codes and scales of a seeded random (n_out, n_in) weight, quantized on
    the card as ``quantize_frozen_base`` does, and its dequantized matrix."""
    w = torch.randn(n_out, n_in, generator=g, device="cuda") * 0.02
    if bits == 8:
        codes, scales = quant._quantize_int8_device(w)
        dense = quant.dequantize_int8(codes, scales)
    else:
        codes, scales = quant._quantize_int4_device(w, QUANT_GROUP)
        dense = quant.dequantize_int4(codes, scales, QUANT_GROUP)
    return codes, scales, dense


def _quant_calls(name: str, a, codes, scales, dense):
    """(kernel, plain version, library call) of one K5-K8 case on operand a
    (x for the forward, dy for dx); the library call is one PyTorch product
    with the dequantized matrix, precomputed in a's dtype."""
    bits, dx = QUANT_KERNELS[name]
    g = QUANT_GROUP
    if bits == 8:
        kern = quant_cuda.int8_matmul_dx if dx else quant_cuda.int8_matmul
        plain = quant_cuda.int8_matmul_dx_reference if dx else quant_cuda.int8_matmul_reference
        args = (a, codes, scales)
    else:
        kern = quant_cuda.int4_matmul_dx if dx else quant_cuda.int4_matmul
        plain = quant_cuda.int4_matmul_dx_reference if dx else quant_cuda.int4_matmul_reference
        args = (a, codes, scales, g)
    w = dense.to(a.dtype)
    library = (lambda: torch.matmul(a, w)) if dx else (lambda: torch.nn.functional.linear(a, w))
    return (lambda: kern(*args)), (lambda: plain(*args)), library


def phase_quant_kernels(card: str, lib) -> dict:
    """K7/K5 at ROWS and K8/K6 at BWD_ROWS, the seven projections, bf16 and
    f32, against their plain versions, timed beside their bound and the
    library call on the dequantized matrix (``F.linear(x, W)`` forward,
    ``torch.matmul(dy, W)`` for dx).  Tolerances as ``tolerance``, for the
    output and for dx alike: both sides round each dequantized weight to the
    working dtype once and sum in fp32, in another order.  K5 and K7 in bf16
    above 16 rows (``int4_matmul_tile`` and ``int8_matmul_tile`` in the JSON
    line) and K6 and K8 in bf16 run the wgmma kernels, whose four functions
    (``qwgmma_kernel`` for int4, ``qwgmma_rs_kernel`` for int8, forward and
    dx) must hold HGMMA in their SASS (``check_hgmma``)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    worst = dict.fromkeys((*QUANT_KERNELS, "int4_matmul_tile", "int8_matmul_tile"), 0.0)
    per_layer = {(name, m): [] for name in QUANT_KERNELS for m in (4, TRAIN_BS * TRAIN_SEQ)}
    print(_HEADER, flush=True)
    with torch.inference_mode():
        for name, (bits, dx) in QUANT_KERNELS.items():
            for dtype in (torch.bfloat16, torch.float32):
                for m_rows in (BWD_ROWS if dx else ROWS):
                    for proj, n_in, n_out in PROJECTIONS:
                        codes, scales, dense = _quant_weight(bits, n_in, n_out, g)
                        a = torch.randn(m_rows, n_out if dx else n_in, generator=g,
                                        device="cuda").to(dtype)
                        kern, plain, library = _quant_calls(name, a, codes, scales, dense)
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        require(got.shape == ref.shape and got.dtype == ref.dtype,
                                f"{name} {proj} M={m_rows}: {got.shape}/{got.dtype} vs "
                                f"{ref.shape}/{ref.dtype}")
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(dtype, ref)
                        (ms, call), (plain_ms, plain_call) = (time_ms(kern, 20, 3),
                                                              time_ms(plain, 20, 3))
                        rec = _record(name, proj, n_in, n_out, m_rows, dtype, err, err / tol, ms,
                                      plain_ms, call, plain_call, time_ms(library, 20, 3)[0])
                        require(err <= tol and bool(torch.isfinite(got).all()),
                                f"{name} {proj} M={m_rows} {dtype}: max_abs_err {err} > tol {tol}")
                        tile = not dx and dtype == torch.bfloat16 and m_rows > 16
                        key = name + "_tile" if tile else name
                        worst[key] = max(worst[key], err)
                        if dtype == torch.bfloat16 and (name, m_rows) in per_layer:
                            per_layer[(name, m_rows)].append(rec)
    layer = {key: _layer_sums(recs) for key, recs in per_layer.items() if recs}
    for (name, m_rows), v in layer.items():
        print(f"[quant-kernels] {card}: {name} per decoder layer (M={m_rows}, bf16, 7 "
              f"projections): {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, library "
              f"{v['library_ms']:.5f}, bound {v['bound_ms']:.5f} ms, {v['bound_by']})", flush=True)
    decode_rows(card, layer)
    quant_ragged_in(card, g)
    hgmma = check_hgmma(lib, "qwgmma", 4)
    print(f"[quant-kernels] {card}: HGMMA in all {hgmma} wgmma kernels (int4 and int8, "
          f"forward and dx)", flush=True)
    # the JSON line: the forward at decode (serving's shape) and at a
    # training micro-batch (``_tile``); dx at a training micro-batch
    main = {name: layer[(name, TRAIN_BS * TRAIN_SEQ if dx else 4)]
            for name, (_, dx) in QUANT_KERNELS.items()}
    for name in ("int4_matmul", "int8_matmul"):
        main[name + "_tile"] = layer[(name, TRAIN_BS * TRAIN_SEQ)]
    return {"worst": worst, "layer": main}


def quant_ragged_in(card: str, g: torch.Generator) -> None:
    """K5-K8 in bf16 at ``QUANT_RAGGED_IN`` x ``QUANT_RAGGED_ROWS``, forward
    (the wgmma tile path) and dx, against their plain versions: int4's h =
    in / 2 is no multiple of 8 there, where the tile forward reads an
    aligned copy of x (ROADMAP C.8; it trapped before)."""
    with torch.inference_mode():
        for n_in, n_out, group in QUANT_RAGGED_IN:
            w = torch.randn(n_out, n_in, generator=g, device="cuda") * 0.02
            for bits in (4, 8):
                if bits == 4:
                    codes, scales = quant._quantize_int4_device(w, group)
                    pairs = lambda x, dy: (  # noqa: E731
                        (quant_cuda.int4_matmul(x, codes, scales, group),
                         quant_cuda.int4_matmul_reference(x, codes, scales, group)),
                        (quant_cuda.int4_matmul_dx(dy, codes, scales, group),
                         quant_cuda.int4_matmul_dx_reference(dy, codes, scales, group)))
                else:
                    codes, scales = quant._quantize_int8_device(w)
                    pairs = lambda x, dy: (  # noqa: E731
                        (quant_cuda.int8_matmul(x, codes, scales),
                         quant_cuda.int8_matmul_reference(x, codes, scales)),
                        (quant_cuda.int8_matmul_dx(dy, codes, scales),
                         quant_cuda.int8_matmul_dx_reference(dy, codes, scales)))
                for m_rows in QUANT_RAGGED_ROWS:
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").bfloat16()
                    dy = torch.randn(m_rows, n_out, generator=g, device="cuda").bfloat16()
                    for what, (got, ref) in zip(("forward", "dx"), pairs(x, dy)):
                        torch.cuda.synchronize()
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(torch.bfloat16, ref)
                        require(got.shape == ref.shape and err <= tol
                                and bool(torch.isfinite(got).all()),
                                f"int{bits} {what} at in {n_in} (group {group}) M={m_rows}: "
                                f"max abs err {err} > {tol}")
    print(f"[quant-kernels] {card}: int4 and int8, forward and dx, bf16, at in "
          f"{', '.join(str(c[0]) for c in QUANT_RAGGED_IN)} (int4's h % 8 != 0), M "
          f"{' and '.join(map(str, QUANT_RAGGED_ROWS))}: within tolerance", flush=True)


def decode_rows(card: str, layer: dict) -> None:
    """K5 and K7 at M = 4 as a decode step finds them: each projection's
    timed calls rotate over weight sets of more than ``DECODE_ROTATE_BYTES``
    (L2 holds none of them, as a step reads each layer's weights once),
    beside ``F.linear`` on rotating dequantized bf16 weights and the launch
    floor (an empty kernel at the decode kernel's grid, cluster and shared
    memory), summed over the seven projections and printed beside the warm
    numbers of ``layer`` (one weight set); then the plan of each projection
    and the registers of each K5/K7 instantiation of the decode kernel."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for bits in (4, 8):
        name = f"int{bits}_matmul"
        cold = {"ms": 0.0, "library_ms": 0.0, "floor_ms": 0.0}
        with torch.inference_mode():
            for proj, n_in, n_out in PROJECTIONS:
                codes, scales, _ = _quant_weight(bits, n_in, n_out, g)
                nbytes = codes.numel() + 4 * scales.numel()
                sets = [(codes, scales)] + [_quant_weight(bits, n_in, n_out, g)[:2]
                                            for _ in range(math.ceil(DECODE_ROTATE_BYTES / nbytes))]
                n_dense = min(len(sets), math.ceil(DECODE_ROTATE_BYTES / (2 * n_in * n_out)) + 1)
                denses = [(quant.dequantize_int8(c, s) if bits == 8 else
                           quant.dequantize_int4(c, s, QUANT_GROUP)).to(torch.bfloat16)
                          for c, s in sets[:n_dense]]
                x = torch.randn(4, n_in, generator=g, device="cuda").to(torch.bfloat16)
                kern = (lambda c, s: quant_cuda.int8_matmul(x, c, s)) if bits == 8 else (
                    lambda c, s: quant_cuda.int4_matmul(x, c, s, QUANT_GROUP))
                state = {"i": 0}

                def nxt(items):
                    state["i"] += 1
                    return items[state["i"] % len(items)]

                ms = time_ms(lambda: kern(*nxt(sets)), 20, 3)[0]
                lib_ms = time_ms(lambda: torch.nn.functional.linear(x, nxt(denses)), 20, 3)[0]
                floor_ms = time_ms(lambda: quant_cuda.decode_empty(
                    bits, torch.bfloat16, 4, n_in, n_out, QUANT_GROUP), 20, 3)[0]
                plan = quant_cuda.decode_plan(bits, torch.bfloat16, 4, n_in, n_out, QUANT_GROUP)
                print(f"[decode-rows] {name} {proj:5s} {n_in}->{n_out}: cold {ms:.5f} ms "
                      f"({len(sets)} weight sets), F.linear cold {lib_ms:.5f} ({len(denses)}), "
                      f"launch floor {floor_ms:.5f}; plan {plan}", flush=True)
                RECORDS.append({"kernel": name, "proj": proj, "in": n_in, "out": n_out, "rows": 4,
                                "cold_ms": ms, "cold_library_ms": lib_ms, "floor_ms": floor_ms,
                                "weight_sets": len(sets), "plan": plan})
                cold["ms"] += ms
                cold["library_ms"] += lib_ms
                cold["floor_ms"] += floor_ms
                del sets, denses
        warm = layer[(name, 4)]
        print(f"[decode-rows] {card}: {name} per decoder layer (M=4, bf16): warm {warm['ms']:.5f} "
              f"ms, cold {cold['ms']:.5f}; F.linear warm {warm['library_ms']:.5f}, cold "
              f"{cold['library_ms']:.5f}; launch floor {cold['floor_ms']:.5f}; bound "
              f"{warm['bound_ms']:.5f}", flush=True)
        RECORDS.append({"kernel": name, "layer_rows": 4, "warm": warm, "cold": cold, "card": card})
    for a in quant_cuda.decode_attrs():
        if a["arith"] == 0:
            print(f"[decode-rows] qgemv_kernel int{a['bits']} "
                  f"{'bf16 (mma)' if a['bf16'] else 'f32 (FMA)'}, {a['rows']} rows a block: "
                  f"{a['registers']} registers, {a['local_bytes']} bytes local, "
                  f"{a['ctas_per_sm']} CTAs an SM", flush=True)
        require(a["local_bytes"] == 0 and a["ctas_per_sm"] >= 2,
                f"a decode-kernel instantiation spills or runs one CTA an SM: {a}")


def phase_quant_autograd(card: str) -> None:
    """The autograd Functions of K7 and K5: the gradient of x at M = 2047,
    every projection, bf16 and f32, against the plain version's autograd;
    each backward launches its dx kernel (K8, K6) exactly once."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = 0.0
    for bits, name in ((8, "int8_matmul"), (4, "int4_matmul")):
        for dtype in (torch.bfloat16, torch.float32):
            for proj, n_in, n_out in PROJECTIONS:
                codes, scales, _ = _quant_weight(bits, n_in, n_out, g)
                x = torch.randn(2047, n_in, generator=g, device="cuda").to(dtype)
                cot = torch.randn(2047, n_out, generator=g, device="cuda").to(dtype)
                extra = () if bits == 8 else (QUANT_GROUP,)
                kern = quant_cuda.int8_matmul if bits == 8 else quant_cuda.int4_matmul
                plain = (quant_cuda.int8_matmul_reference if bits == 8
                         else quant_cuda.int4_matmul_reference)
                a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
                before = quant_cuda.LAUNCHES[name + "_dx"]
                (got,) = torch.autograd.grad(kern(a, codes, scales, *extra), a, cot)
                (want,) = torch.autograd.grad(plain(b, codes, scales, *extra), b, cot)
                torch.cuda.synchronize()
                require(quant_cuda.LAUNCHES[name + "_dx"] == before + 1,
                        f"the backward of {name} did not launch its dx kernel once")
                e, tol = float((got.float() - want.float()).abs().max()), tolerance(dtype, want)
                require(got.dtype == want.dtype and e <= tol,
                        f"grad of {name} {proj} {dtype}: {e} > {tol}")
                worst = max(worst, e / tol)
    print(f"[quant-autograd] {card}: gradients of x through K7 and K5 (backward K8, K6) at "
          f"M=2047, all 7 projections, bf16 and f32: worst error {worst:.3f} of its tolerance",
          flush=True)


# -- the fused dense + Monarch linear (K9-K11) ---------------------------------

def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def more_linear_repeats() -> None:
    """K9 and K10 (bf16) at ``MORE_REPEAT_CASE``: ``MORE_REPEATS`` calls of
    each give the first call's bits (PERF.md §7 left a race at J = 32
    open; every run of this script now looks for it)."""
    from sparse_matrix_fine_tuning_torch.scripts.compare_more_linear import inputs

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x, dout, wd, w1, w2 = inputs(*MORE_REPEAT_CASE, torch.bfloat16, g)
    with torch.no_grad():
        for name, call in (("K9", lambda: ml.more_linear_fwd(x, wd, w1, w2)),
                           ("K10", lambda: ml.more_linear_dx(dout, wd, w1, w2))):
            first = call()
            same = sum(bool(torch.equal(call(), first)) for _ in range(MORE_REPEATS))
            require(same == MORE_REPEATS, f"{name} at {MORE_REPEAT_CASE}: {MORE_REPEATS - same} "
                                          f"of {MORE_REPEATS} repeats gave other bits")
    print(f"[more-linear] K9 and K10 at {MORE_REPEAT_CASE} (J = 32): {MORE_REPEATS} repeats "
          "each equal the first bit for bit", flush=True)


def phase_more_linear(card: str, lib) -> dict:
    """The fused dense + Monarch linear, at ``bench_more_linear``'s three
    shapes in bf16 and at one ragged f32 case:
      * K9, K10 and K11 against their plain versions (``tolerance``; K11's
        fp32 factor gradients to that of the inputs' dtype), timed beside
        their bound, the plain version and one PyTorch call on the merged
        dense matrix Wd + M (M the factors' dense equivalent):
        ``F.linear(x, Wd + M)`` for K9, ``torch.matmul(dout, Wd + M)`` for
        K10, none for K11 (no single call gives both factor gradients);
      * one forward and backward of ``more_linear``: y and the gradients of
        x, w1 and w2 against the plain composition's autograd, each kernel
        launched exactly once.
    bf16's K9/K10 kernel (``fused_kernel``): its plan at each bench shape,
    HGMMA in the SASS of all its instantiations and ptxas's report of no
    spill.  Then the counted main path: ``bench_more_linear.run`` at the
    three shapes (fused, hybrid and plain steps), the launch counts zeroed
    just before and read just after."""
    import torch.nn.functional as F

    from sparse_matrix_fine_tuning_torch.ops.monarch import (
        monarch_dense_equivalent,
        monarch_forward_f32,
    )
    from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench

    worst = dict.fromkeys(MORE_KERNELS, 0.0)
    main = {name: [] for name in MORE_KERNELS}
    cases = [((label, *shape[1:]), torch.bfloat16)
             for label, shape in zip(MORE_LABELS, bench.SHAPES)]
    cases.append((MORE_RAGGED, torch.float32))
    print(_HEADER, flush=True)
    for (label, rows, n, m, nb, r), dtype in cases:
        x, wd, w1, w2 = bench.make_inputs(rows, n, m, nb, r, dtype, seed=SEED + 15)
        g = torch.Generator(device="cuda").manual_seed(SEED + 16)
        dout = torch.randn(rows, m, generator=g, device="cuda").to(dtype)
        merged = (wd.float() + monarch_dense_equivalent(w1.float(), w2.float())).to(dtype)
        calls = {
            "more_linear_fwd": (lambda: ml.more_linear_fwd(x, wd, w1, w2),
                                lambda: ml.more_linear_fwd_reference(x, wd, w1, w2),
                                lambda: F.linear(x, merged)),
            "more_linear_dx": (lambda: ml.more_linear_dx(dout, wd, w1, w2),
                               lambda: ml.more_linear_dx_reference(dout, wd, w1, w2),
                               lambda: torch.matmul(dout, merged)),
            "more_linear_dw": (lambda: ml.more_linear_dw(x, dout, w1, w2),
                               lambda: ml.more_linear_dw_reference(x, dout, w1, w2), None),
        }
        with torch.no_grad():
            for name, (kern, plain, library) in calls.items():
                got, ref = _outputs(kern()), _outputs(plain())
                torch.cuda.synchronize()
                err = share = 0.0
                for out, want in zip(got, ref):
                    require(out.shape == want.shape and out.dtype == want.dtype,
                            f"{name} {label}: {out.shape}/{out.dtype} vs {want.shape}/{want.dtype}")
                    require(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output")
                    e = float((out.float() - want.float()).abs().max())
                    err, share = max(err, e), max(share, e / tolerance(dtype, want))
                (ms, call), (plain_ms, plain_call) = time_ms(kern, 20, 3), time_ms(plain, 20, 3)
                lib_ms = time_ms(library, 20, 3)[0] if library is not None else None
                rec = _record(name, label, n, m, rows, dtype, err, share, ms, plain_ms, call,
                              plain_call, lib_ms, r)
                require(share <= 1.0, f"{name} {label} {dtype}: an output is over its tolerance "
                                      f"({share:.3f} of it)")
                worst[name] = max(worst[name], err)
                if dtype == torch.bfloat16:
                    main[name].append(rec)

        # the autograd Function: one forward and backward
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        plain_leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        before = dict(ml.LAUNCHES)
        y = ml.more_linear(leaves[0], wd, *leaves[1:])
        y.backward(dout)
        torch.cuda.synchronize()
        require(ml.LAUNCHES == {k: v + 1 for k, v in before.items()},
                f"more_linear {label}: one forward and backward launched "
                f"{ {k: ml.LAUNCHES[k] - v for k, v in before.items()} }, expected 1 of each")
        xb, w1b, w2b = plain_leaves
        comp = (xb.float() @ wd.float().T + monarch_forward_f32(xb, w1b, w2b)).to(dtype)
        want = [comp.detach(), *torch.autograd.grad(comp, plain_leaves, dout)]
        for what, g, w in zip(("y", "dx", "dw1", "dw2"), [y.detach()] + [t.grad for t in leaves],
                              want):
            e, tol = float((g.float() - w.float()).abs().max()), tolerance(dtype, w)
            require(g.dtype == w.dtype and g.shape == w.shape and e <= tol,
                    f"more_linear {label} {dtype}: {what} {e} > {tol}")
        del x, wd, w1, w2, dout, merged, y, leaves, plain_leaves, comp, want
        torch.cuda.empty_cache()
    print(f"[more-linear] {card}: K9, K10, K11 and the autograd Function (y, dx, dw1, dw2) "
          "within tolerance of the plain versions at the three bench shapes (bf16) and the "
          "ragged case (f32); one launch of each a forward and backward", flush=True)
    for label, (_, rows, n, m, nb, r) in zip(MORE_LABELS, bench.SHAPES):
        for name, dx in (("K9", False), ("K10", True)):
            print(f"[more-linear] plan {label} {name}: "
                  f"{ml.more_linear_plan(rows, n, m, nb * r, dx)}", flush=True)
    hgmma = check_hgmma(lib, "fused_kernel", MORE_FUSED_KERNELS)
    kernel_ptxas(lib, "fused_kernel", MORE_FUSED_KERNELS, "more-linear")
    more_linear_repeats()
    print(f"[more-linear] {card}: HGMMA in all {hgmma} bf16 K9/K10 kernels, none spills",
          flush=True)

    reset_counts()  # the counted main path starts here
    runs = [bench.run(*shape) for shape in bench.SHAPES]
    launches = counts()  # the counted main path ends here
    steps = sum(run["steps"] for run in runs)
    expect = {"more_linear_fwd": steps + len(runs), "more_linear_dx": steps,
              "more_linear_dw": steps, "monarch_add": steps, "monarch_bwd": steps}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"bench_more_linear: launches {launches}; expected {expect}")
    for label, run in zip(MORE_LABELS, runs):
        require(run["rel_diff"] <= MORE_LOSS_RTOL,
                f"bench_more_linear {label}: fused loss {run['rel_diff']} from the plain one")
        print(f"[more-linear] {card}: bench {label}: device us a step fused "
              f"{run['fused_us']:.1f}, hybrid {run['hybrid_us']:.1f}, plain {run['plain_us']:.1f} "
              f"(wall {run['fused_wall_us']:.1f}, {run['hybrid_wall_us']:.1f}, "
              f"{run['plain_wall_us']:.1f}); loss rel diff {run['rel_diff']:.2e}", flush=True)
    RECORDS.append({"bench_more_linear": runs, "card": card})
    return {"worst": worst, "layer": {name: _layer_sums(recs) for name, recs in main.items()},
            "launches": {name: launches[name] for name in MORE_KERNELS}}


# -- the forward-tile experiments (K15, K12) ------------------------------------

def check_hgmma(lib, prefix: str, count: int) -> int:
    """Each of the ``count`` kernels whose name holds ``prefix`` in the built
    library holds the warpgroup MMA (``HGMMA`` in its SASS, read with the
    toolkit's ``cuobjdump``), so that a build that dropped wgmma cannot pass.
    Returns how many were found."""
    from sparse_matrix_fine_tuning_torch.kernels.build import _cuda_home

    sass = subprocess.run([str(_cuda_home() / "bin" / "cuobjdump"), "-sass", str(lib)],
                          check=True, stdout=subprocess.PIPE, text=True).stdout
    kernels = [f for f in sass.split("Function : ")[1:] if prefix in f.splitlines()[0]]
    require(len(kernels) == count,
            f"cuobjdump found {len(kernels)} {prefix} functions, expected {count}")
    for f in kernels:
        require("HGMMA" in f, f"no HGMMA in the SASS of {f.splitlines()[0].strip()}")
    return len(kernels)


def phase_tiles(card: str, lib) -> dict:
    """K15 and K12, the kernels of the forward-tile experiments:
      * at a ragged shape, outside the counted paths: K15 at every tile
        against ``tiled_matmul_reference`` (bf16) and K12 at every row tile
        against ``monarch_kernel_reference`` (f32; and bf16 at 8 rows bit
        for bit against K1, whose instantiation it is);
      * every K15 kernel's SASS holds HGMMA (``check_hgmma``) and none
        spills (``kernel_ptxas``); at the bench shape each tile's plan is
        the Python mirror's (``schedule_plan``) and a repeated call gives
        the same bits;
      * the counted main paths: the ports of ``exp_matmul_tiles`` and
        ``exp_fwd_tile`` at 2664 x 4096 -> 4096, each of which checks every
        variant against its plain version before timing it, the launch
        counts zeroed just before each and read just after."""
    from sparse_matrix_fine_tuning_torch.scripts import exp_fwd_tile, exp_matmul_tiles

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    m, k, n = TILES_RAGGED
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
    ref = tm.tiled_matmul_reference(x, w)
    for tile in tm.TILES:
        got = tm.tiled_matmul(x, w, tile)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(got.shape == ref.shape and err <= tolerance(torch.bfloat16, ref),
                f"tiled_matmul {tile} at {TILES_RAGGED}: max abs err {err}")
    b, n_in, n_out, nb, rank = FWD_TILE_RAGGED
    x = torch.randn(b, n_in, generator=g, device="cuda")
    w1 = torch.randn(nb, rank, n_in // nb, generator=g, device="cuda") / (n_in // nb) ** 0.5
    w2 = torch.randn(nb, n_out // nb, rank, generator=g, device="cuda") / rank ** 0.5
    ref = monarch_cuda.monarch_kernel_reference(x, w1, w2)
    for rows in monarch_cuda.FWD_TILE_ROWS:
        got = monarch_cuda.monarch_fwd_tile(x, w1, w2, rows)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        require(got.shape == ref.shape and err <= tolerance(torch.float32, ref),
                f"monarch_fwd_tile rows {rows} at {FWD_TILE_RAGGED} f32: max abs err {err}")
    xb, w1b, w2b = (t.to(torch.bfloat16) for t in (x, w1, w2))
    k1_rows = monarch_cuda.monarch_fwd_plan(b, w1b.shape, w2b.shape)["rows"]
    with torch.no_grad():
        k1 = monarch_cuda.monarch_kernel(xb, w1b, w2b)
        for rows in monarch_cuda.FWD_TILE_ROWS:
            require(torch.equal(monarch_cuda.monarch_fwd_tile(xb, w1b, w2b, rows), k1),
                    f"monarch_fwd_tile at {rows} rows differs from K1 at its own row tile "
                    f"({k1_rows})")
    hgmma = check_hgmma(lib, "tiled_mm_kernel", len(tm.TILES))
    kernel_ptxas(lib, "tiled_mm_kernel", len(tm.TILES), "tiles")
    m, k, n = TILES_BENCH
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    for tile in tm.TILES:
        plan = tm.tiled_matmul_plan(m, n, k, tile)
        require(plan == tm.schedule_plan(m, n, k, tile, plan["resident"]),
                f"tiled_matmul {tile}: the kernel's plan {plan} is not the Python mirror's")
        require(torch.equal(tm.tiled_matmul(x, w, tile), tm.tiled_matmul(x, w, tile)),
                f"tiled_matmul {tile} at {TILES_BENCH}: a repeated call gave other bits")
        print(f"[tiles] plan {tile} at {TILES_BENCH}: {plan}", flush=True)
    del x, w
    print(f"[tiles] {card}: K15 at {len(tm.TILES)} tiles and K12 at "
          f"{len(monarch_cuda.FWD_TILE_ROWS)} row tiles within tolerance at the ragged shapes; "
          f"K12 at every row tile equals K1 at its own ({k1_rows} rows); HGMMA in all "
          f"{hgmma} K15 kernels, none spills; K15 repeats bit for bit at {TILES_BENCH}, "
          "its plan the mirror's", flush=True)

    reset_counts()  # the counted main path starts here: exp_matmul_tiles
    mm = exp_matmul_tiles.run()
    launches = counts()  # ... and ends here
    expect = {"tiled_matmul": mm["steps"]}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_matmul_tiles: launches {launches}; expected {expect}")
    mm_launches = launches["tiled_matmul"]
    reset_counts()  # the counted main path starts here: exp_fwd_tile
    fwd = [exp_fwd_tile.run(*shape) for shape in exp_fwd_tile.SHAPES]
    launches = counts()  # ... and ends here
    expect = {"monarch_fwd_tile": sum(run["steps"] for run in fwd)}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_fwd_tile: launches {launches}; expected {expect}")
    for t in mm["tiles"]:
        require(t["max_abs_err"] <= mm["tolerance"], f"tiled_matmul {t['tile']}: {t}")
    for run in fwd:
        for t in run["tiles"]:
            require(t["max_abs_err"] <= run["tolerance"], f"monarch_fwd_tile {run['tag']}: {t}")
    best, script = mm["best"], fwd[0]
    print(f"[tiles] {card}: exp_matmul_tiles best tile {tuple(best['tile'])} "
          f"{best['ms']:.5f} ms ({best['tflops']:.1f} TFLOP/s), torch.matmul "
          f"{mm['library_ms']:.5f}, bound {mm['bound_ms']:.5f} ms; exp_fwd_tile best row tile "
          + "; ".join(f"{r['best']['rows']} {r['best']['ms']:.5f} ms (copy floor "
                      f"{r['copy_ms']:.5f}, bound {r['bound_ms']:.5f})" for r in fwd), flush=True)
    RECORDS.append({"exp_matmul_tiles": mm, "exp_fwd_tile": fwd, "card": card})
    layer = {
        "tiled_matmul": {"ms": best["ms"], "plain_ms": mm["plain_ms"],
                         "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"],
                         "library_ms": mm["library_ms"]},
        "monarch_fwd_tile": {"ms": script["best"]["ms"], "plain_ms": script["plain_ms"],
                             "bound_ms": script["bound_ms"], "bound_by": script["bound_by"],
                             "library_ms": script["library_ms"]},
    }
    worst = {"tiled_matmul": max(t["max_abs_err"] for t in mm["tiles"]),
             "monarch_fwd_tile": max(t["max_abs_err"] for r in fwd for t in r["tiles"])}
    return {"layer": layer, "worst": worst,
            "launches": {"tiled_matmul": mm_launches,
                         "monarch_fwd_tile": expect["monarch_fwd_tile"]}}


# -- the dw experiments (K13, K14) -------------------------------------------

def phase_dw(card: str) -> dict:
    """K13 and K14, the kernels of the dw experiments, and K3/K4 through the
    fast path at blk_r 8 and 16:
      * outside the counted paths, at the ragged shapes of ``DW_RAGGED`` in
        f32 and bf16: K3 and K4 against their plain versions, on the path
        ``monarch_bwd_plan`` names; K13 at 16 rows and at every
        ``DW_TILE_ROWS`` against K4's plain version;
      * ``monarch_bwd_plan`` reports the fast path at the bench's three
        shapes and the dw script's two;
      * at the dw script's shape (bf16): two K13 launches at 256 rows equal
        bit for bit, K14 equals K13 at 256 rows bit for bit, and K14 timed
        against the plain version on rotating input sets;
      * the counted main paths: the ports of ``exp_dw_kernel`` and
        ``exp_merged_v3`` at 2664 x 4096 -> 4096, each of which checks every
        variant before timing it, the launch counts zeroed just before each
        and read just after."""
    from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench
    from sparse_matrix_fine_tuning_torch.scripts import exp_dw_kernel, exp_merged_v3

    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    with torch.no_grad():
        for m_rows, k, q, p, l, s, r, fast in DW_RAGGED:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m_rows, k * p, generator=g, device="cuda").to(dtype)
                w1 = (torch.randn(k, q, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                w2 = (torch.randn(l, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                dout = torch.randn(m_rows, s * l, generator=g, device="cuda").to(dtype)
                tag = f"M={m_rows} (K, Q, P)=({k}, {q}, {p}) (L, S, R)=({l}, {s}, {r}) {dtype}"
                for with_dx in (True, False):
                    plan = monarch_cuda.monarch_bwd_plan(m_rows, w1.shape, w2.shape,
                                                         with_dx=with_dx, dtype=dtype)
                    require(plan[0] == fast, f"monarch_bwd_plan {tag}: {plan}, fast {fast}")
                ref_bwd = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)
                ref_dw = ref_bwd[1:]
                cases = [("K3", monarch_cuda.monarch_bwd(x, w1, w2, dout), ref_bwd),
                         ("K4", monarch_cuda.monarch_dw_fused(x, dout, w1, w2), ref_dw)]
                cases += [(f"K13 rows {rows}", monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows),
                           ref_dw) for rows in DW_RAGGED_ROWS]
                torch.cuda.synchronize()
                for name, got, want in cases:
                    for out, ref in zip(got, want):
                        err = float((out.float() - ref.float()).abs().max())
                        require(out.shape == ref.shape and out.dtype == ref.dtype
                                and bool(torch.isfinite(out).all())
                                and err <= tolerance(dtype, ref),
                                f"{name} {tag}: max abs err {err} > {tolerance(dtype, ref)}")
    plans = {}
    for label, (_, rows, n, m, nb, r) in zip(MORE_LABELS, bench.SHAPES):
        plans[f"bench {label}"] = monarch_cuda.monarch_bwd_plan(
            rows, (nb, r, n // nb), (nb, m // nb, r), with_dx=True)
    for tag, b, n, m, nb, r in exp_dw_kernel.SHAPES:
        plans[f"exp_dw_kernel rank {r}"] = monarch_cuda.monarch_bwd_plan(
            b, (nb, r, n // nb), (nb, m // nb, r))
    require(all(fast for fast, _ in plans.values()), f"not the fast path: {plans}")

    _, b, n, m, nb, r = exp_dw_kernel.SHAPES[0]
    pairs, w1, w2 = exp_dw_kernel.make_inputs(b, n, m, nb, r)
    x, dout = pairs[0]
    rows = monarch_cuda.MERGED_DW_ROWS
    with torch.no_grad():
        first = monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
        second = monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
        merged = monarch_cuda.monarch_dw_merged(x, dout, w1, w2)
        ref = monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(first, second)),
                "two K13 launches at blk_r 16 differ")
        require(all(torch.equal(a, c) for a, c in zip(first, merged)),
                f"K14 differs from K13 at {rows} rows")
        merged_err = exp_dw_kernel.check("K14", merged, ref)
        merged_ms = time_ms(exp_dw_kernel.rotating(
            lambda xx, dd: monarch_cuda.monarch_dw_merged(xx, dd, w1, w2), pairs),
            exp_dw_kernel.REPS, exp_dw_kernel.ROUNDS)[0]
    del pairs, x, dout, first, second, merged, ref
    torch.cuda.empty_cache()
    print(f"[dw] {card}: K3, K4 and K13 at {len(DW_RAGGED_ROWS)} row groups within tolerance "
          f"at {len(DW_RAGGED)} ragged shapes (f32, bf16); fast path at "
          + ", ".join(f"{k} {v}" for k, v in plans.items())
          + f"; K13 repeats bit for bit, K14 equals K13 at {rows} rows; K14 {merged_ms:.5f} ms",
          flush=True)

    reset_counts()  # the counted main path starts here: exp_dw_kernel
    dw = [exp_dw_kernel.run(*shape) for shape in exp_dw_kernel.SHAPES]
    launches = counts()  # ... and ends here
    expect = {"monarch_dw_tile": sum(len(run["tiles"]) * run["steps"] for run in dw),
              "more_linear_dw": sum(run["steps"] for run in dw)}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_dw_kernel: launches {launches}; expected {expect}")
    tile_launches = expect["monarch_dw_tile"]
    reset_counts()  # the counted main path starts here: exp_merged_v3
    mv3 = [exp_merged_v3.run(*shape) for shape in exp_merged_v3.SHAPES]
    launches = counts()  # ... and ends here
    steps = sum(run["steps"] for run in mv3)
    expect = {"monarch_add": steps, "monarch_bwd": steps, "monarch_dw_fused": steps,
              "monarch_dw_merged": steps}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_merged_v3: launches {launches}; expected {expect}")
    script = dw[0]
    print(f"[dw] {card}: exp_dw_kernel "
          + "; ".join(f"rank {run['shape'][4]}: best row group {run['best']['rows']} "
                      f"{run['best']['ms']:.5f} ms, K11 {run['k11']['ms']:.5f}, plain "
                      f"{run['plain_ms']:.5f}, read floor {run['floor_ms']:.5f}, bound "
                      f"{run['bound_ms']:.5f}" for run in dw)
          + "; exp_merged_v3 device us a micro-batch "
          + "; ".join(f"rank {run['shape'][4]}: " + ", ".join(
              f"{k} {v['us']:.1f}" for k, v in run["variants"].items()) for run in mv3),
          flush=True)
    RECORDS.append({"exp_dw_kernel": dw, "exp_merged_v3": mv3, "plans": plans,
                    "monarch_dw_merged_ms": merged_ms, "card": card})
    layer = {
        "monarch_dw_tile": {"ms": script["best"]["ms"], "plain_ms": script["plain_ms"],
                            "bound_ms": script["bound_ms"], "bound_by": script["bound_by"],
                            "library_ms": None},
        "monarch_dw_merged": {"ms": merged_ms, "plain_ms": script["plain_ms"],
                              "bound_ms": script["bound_ms"], "bound_by": script["bound_by"],
                              "library_ms": None},
    }
    worst = {"monarch_dw_tile": max(t["max_abs_err"] for run in dw for t in run["tiles"]),
             "monarch_dw_merged": merged_err}
    return {"layer": layer, "worst": worst,
            "launches": {"monarch_dw_tile": tile_launches, "monarch_dw_merged": steps}}


def phase_int4_variants(card: str) -> dict:
    """K16, the int4 dequant-arithmetic variants:
      * outside the counted path, at ``INT4_VARIANT_RAGGED`` and each of
        ``INT4_VARIANT_ROWS``: every variant's raw output against its plain
        version (two bf16 ulps of its scale), and f32mul equal to K5 bit
        for bit where K5 takes the decode kernel (M <= 16);
      * the counted main path: the port of ``exp_int4_dequant_variants`` at
        its four shapes, which checks every variant against its plain
        version and the JAX script's oracle bound before timing it, the
        launch counts zeroed just before and read just after."""
    from sparse_matrix_fine_tuning_torch.scripts import exp_int4_dequant_variants as script

    n_in, n_out, group = INT4_VARIANT_RAGGED
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    worst = 0.0
    with torch.no_grad():
        packed, scales = quant._quantize_int4_device(
            torch.randn(n_out, n_in, generator=g, device="cuda") * 0.05, group)
        for m_rows in INT4_VARIANT_ROWS:
            x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(torch.bfloat16)
            k5 = quant_cuda.int4_matmul(x, packed, scales, group)
            for name in quant_cuda.INT4_VARIANTS:
                got = quant_cuda.int4_variant_matmul(x, packed, scales, group, name)
                ref = quant_cuda.int4_variant_reference(x, packed, scales, group, name)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                require(got.shape == ref.shape and got.dtype == ref.dtype
                        and bool(torch.isfinite(got).all()) and err <= tolerance(ref.dtype, ref),
                        f"K16 {name} M={m_rows} {n_in}->{n_out}: max abs err {err} > "
                        f"{tolerance(ref.dtype, ref)}")
                worst = max(worst, err)
                if name == "f32mul" and m_rows <= 16:
                    require(torch.equal(got, k5), f"K16 f32mul differs from K5 at M={m_rows}")
    print(f"[int4-variants] {card}: K16's {len(quant_cuda.INT4_VARIANTS)} variants within "
          f"tolerance at M {INT4_VARIANT_ROWS}, {n_in}->{n_out}; f32mul equals K5 at decode rows",
          flush=True)

    reset_counts()  # the counted main path starts here: exp_int4_dequant_variants
    runs = [script.run(*shape) for shape in script.SHAPES]
    launches = counts()  # ... and ends here
    expect = {k: sum(run["launches"][k] for run in runs) for k in ("int4_variant", "int4_matmul")}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_int4_dequant_variants: launches {launches}; expected {expect}")
    for run in runs:
        best = run["variants"][run["best"]]
        print(f"[int4-variants] {card}: B={run['shape'][0]} {run['shape'][1]}->{run['shape'][2]}: "
              + ", ".join(f"{k} {v['ms']:.5f}" for k, v in run["variants"].items())
              + f" ms; best {run['best']} ({best['share_of_bound']:.1%} of the bound "
              f"{run['bound_ms']:.5f}, {run['bound_by']}); K5 {run['k5_ms']:.5f}, F.linear "
              f"{run['library_ms']:.5f}, read floor {run['floor_ms']:.5f}", flush=True)
    RECORDS.append({"exp_int4_dequant_variants": runs, "card": card})
    main = next(run for run in runs if tuple(run["shape"]) == INT4_VARIANT_SHAPE)
    best = main["variants"][main["best"]]
    worst = max([worst] + [v["max_abs_err"] for run in runs for v in run["variants"].values()])
    layer = {"int4_variant": {"ms": best["ms"], "plain_ms": best["plain_ms"],
                              "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                              "library_ms": main["library_ms"]}}
    return {"layer": layer, "worst": {"int4_variant": worst},
            "launches": {"int4_variant": expect["int4_variant"]}}


def dequantized_copy(model):
    """A CPU copy of a quantized model with no kernel in it: each layer's
    codes dequantized into a float32 dense by the plain functions."""
    import copy

    from torch import nn

    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    ref = copy.deepcopy(model).cpu()
    for m in ref.modules():
        if isinstance(m, MonarchLinear) and m.quant_bits:
            if m.quant_bits == 8:
                w = quant.dequantize_int8(m.dense, m.dense_scales)
            else:
                w = quant.dequantize_int4(m.dense, m.dense_scales, m.quant_group)
            m.dense = nn.Parameter(w, requires_grad=False)
            m.dense_scales, m.quant_bits, m.quant_group = None, 0, 0
    return ref


def phase_quant_f32(f32: dict, card: str) -> None:
    """Quantized serving in float32, int8 and int4: the 22-layer model with
    the random adapters of ``randomize_adapters``, quantized on the card,
    against a copy with no kernel in it (codes dequantized by the plain
    functions and the adapters merged, on the CPU, then moved to the card).
    Prefill launches K7 (or K5) and K2 once on each adapted linear."""
    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids, mask = f32["ids"], f32["mask"]
    for bits in (8, 4):
        model = build_model("float32", f32["state"])
        require(quant.quantize_frozen_base(model, bits=bits) == N_ADAPTED, "quantize missed layers")
        ref = dequantized_copy(model)
        require(merge_all_adapters(ref) == N_ADAPTED, "merge on the CPU missed adapters")
        ref = ref.to("cuda")
        name = f"int{bits}_matmul"
        reset_counts()
        with torch.inference_mode():
            got = model(ids, attention_mask=mask)
        launches = counts()
        with torch.inference_mode():
            want = ref(ids, attention_mask=mask)
        torch.cuda.synchronize()
        require(launches[name] == N_ADAPTED and launches["monarch_add"] == N_ADAPTED
                and sum(launches.values()) == 2 * N_ADAPTED,
                f"int{bits} prefill launched {launches}; expected {N_ADAPTED} of {name} and of "
                "monarch_add")
        valid = mask.bool()
        err = float((got - want)[valid].abs().max())
        scale = float(want[valid].abs().max())
        tol = F32_LOGIT_TOL * scale
        print(f"[quant-f32] {card}: int{bits} prefill logits {tuple(got.shape)}: max_abs_err "
              f"{err:.3e}, tol {tol:.3e} ({F32_LOGIT_TOL:g} of max|logit| {scale:.3f}); "
              f"launches {name} {launches[name]}, monarch_add {launches['monarch_add']}",
              flush=True)
        require(bool(torch.isfinite(got).all()), f"non-finite int{bits} f32 logits")
        require(err <= tol, f"int{bits} f32 prefill logits differ: {err} > {tol}")
        check_greedy(model, ref, ids, mask, tol, f"quant-f32 int{bits}")
        del model, ref
        torch.cuda.empty_cache()


def phase_quant_bf16(f32: dict, card: str) -> dict:
    """Quantized serving in bfloat16, timed as ``phase_bf16``: batch 4,
    prompt 64, 128 new tokens, three configurations of the 22-layer model:
    (a) int8 base, adapters unmerged (K7 and K2 on every adapted linear);
    (b) int8 base with ``requantize_merge_adapters`` (its deltas through
        K1) and the w8a8 ``Int8LMHead``, ``bench.py:141-145`` (K7 only);
    (c) int4 base, adapters unmerged (K5 and K2).
    Each generate is a counted main path; the prefill logits are held
    against the unquantized bf16 model's (cosine, ``QUANT_COS``).  The host
    clock drifts over minutes, so each configuration's timed generates
    alternate with the unquantized bf16 model's, which is timed beside it;
    the counted generate runs alone, last (2 prefills and 1 generate of
    ``QUANT_ALT_NEW`` tokens of each alternate; a decode step's ms is the
    median over those and the counted generate).  Resident and peak memory are the
    configuration's own: measured from what was allocated before its model
    was built.  A counted generate launches the forward once an adapted
    linear for its prefill (BATCH x PROMPT = 256 rows: the wgmma kernel)
    and once a decode step (BATCH rows: the decode kernel); the returned
    launches split them so (``int8_matmul_tile``, ``int8_matmul``)."""
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate

    base = build_model("bfloat16", f32["state"])
    with torch.inference_mode():
        base_logits = base(f32["ids"], attention_mask=f32["mask"])
    valid = f32["mask"].bool()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    mask = torch.ones(BATCH, PROMPT, dtype=torch.long, device="cuda")

    def fresh_ids():
        return torch.randint(2, MODEL["vocab_size"], (BATCH, PROMPT), generator=g, device="cuda")

    gc = GenerationConfig(max_new_tokens=NEW, eos_token_id=None)
    gc_alt = GenerationConfig(max_new_tokens=QUANT_ALT_NEW, eos_token_id=None)
    gc1 = GenerationConfig(max_new_tokens=1, eos_token_id=None)
    steps = NEW - 1
    med = statistics.median
    out = {}
    for label, bits, merged in (("a: int8 unmerged", 8, False),
                                ("b: int8 requantize-merged, w8a8 head", 8, True),
                                ("c: int4 unmerged", 4, False)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model = build_model("bfloat16", f32["state"])
        require(quant.quantize_frozen_base(model, bits=bits) == N_ADAPTED, "quantize missed layers")
        if merged:
            reset_counts()
            require(quant.requantize_merge_adapters(model) == N_ADAPTED, "requantize-merge")
            require(monarch_cuda.LAUNCHES["monarch_kernel"] == N_ADAPTED,
                    f"requantize-merge launched {counts()}; expected {N_ADAPTED} of K1")
            require(quant.quantize_lm_head(model, impl="w8a8"), "lm_head not quantized")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident_gb = (torch.cuda.memory_allocated() - before) / 1e9
        with torch.inference_mode():
            logits = model(f32["ids"], attention_mask=f32["mask"])
        require(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
        cos = float(torch.nn.functional.cosine_similarity(
            logits[valid].float().flatten(), base_logits[valid].float().flatten(), dim=0))
        need = QUANT_COS[bits]
        print(f"[quant-bf16] {label}: prefill logits cosine to the unquantized bf16 model "
              f"{cos:.5f} (need >= {need})", flush=True)
        require(cos >= need, f"{label}: logits cosine {cos} < {need}")

        def gen_s(m, cfg):
            ids = fresh_ids()
            return timed(lambda: generate(m, ids, mask, cfg))[1]

        def alternate(cfg, n):
            """n timed generates of the quantized model and of the unquantized
            one, alternating."""
            pairs = [(gen_s(model, cfg), gen_s(base, cfg)) for _ in range(n)]
            return [p[0] for p in pairs], [p[1] for p in pairs]

        generate(model, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
        generate(base, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
        prefill, base_prefill = alternate(gc1, 2)
        gens, base_gens = alternate(gc_alt, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # the counted main path starts here
        ids = fresh_ids()
        toks, main_s = timed(lambda: generate(model, ids, mask, gc))
        launches = counts()  # the counted main path ends here
        peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
        kernels, wrappers = {}, []
        busy_ms = profile_decode(model, fresh_ids(), mask, steps=DECODE_PROFILE_STEPS,
                                 kernels=kernels, wrappers=wrappers)
        name = f"int{bits}_matmul"
        # the decode kernel once an adapted linear a step, one launch a call:
        # the wrappers' own count, exact every step; the profiler's count
        # over the profiled steps, exact (device_busy's padded window keeps
        # every record, ROADMAP C.10); qsplit_sum never
        per_step = [w[name] for w in wrappers]
        require(per_step == [N_ADAPTED] * DECODE_PROFILE_STEPS,
                f"{label}: the wrappers counted {per_step} {name} launches in the profiled "
                f"decode steps; expected {N_ADAPTED} each")
        if busy_ms is not None:
            want = N_ADAPTED * DECODE_PROFILE_STEPS
            gemv = round(DECODE_PROFILE_STEPS * sum(
                n for key, n in kernels.items() if "qgemv_kernel" in key))
            split = round(DECODE_PROFILE_STEPS * sum(
                n for key, n in kernels.items() if "qsplit_sum" in key))
            print(f"[quant-bf16] {label}: {DECODE_PROFILE_STEPS} decode steps launch "
                  f"qgemv_kernel {gemv} times by the profiler, {sum(per_step)} by the wrappers' "
                  f"count ({name}: {per_step}), qsplit_sum {split} times", flush=True)
            require(gemv == want and split == 0,
                    f"{label}: the profiler counted qgemv_kernel {gemv} and qsplit_sum {split} "
                    f"times in {DECODE_PROFILE_STEPS} decode steps; expected {want} and 0")
        want = N_ADAPTED * (1 + steps)
        expect = {name: want, "monarch_add": 0 if merged else want}
        require(tuple(toks.shape) == (BATCH, PROMPT + NEW), f"{label}: tokens {tuple(toks.shape)}")
        require(launches == {**dict.fromkeys(launches, 0), **expect},
                f"{label}: launches {launches}; expected {expect}")
        prefill_ms = med(prefill) * 1e3
        decode_all = [(g * 1e3 - prefill_ms) / (QUANT_ALT_NEW - 1) for g in gens] + \
            [(main_s * 1e3 - prefill_ms) / steps]
        decode_ms = med(decode_all)
        base_prefill_ms = med(base_prefill) * 1e3
        base_decode_ms = (med(base_gens) * 1e3 - base_prefill_ms) / (QUANT_ALT_NEW - 1)
        idle = f"{1 - busy_ms / decode_ms:.3f}" if busy_ms is not None else "not measured"
        print(f"[quant-bf16] {card}: {label}: prefill {prefill_ms:.3f} ms (median of "
              f"{len(prefill)}), decode {decode_ms:.4f} ms/step (median of "
              f"{[round(x, 4) for x in decode_all]}: the alternating {QUANT_ALT_NEW}-token "
              f"generates {[round(x, 4) for x in gens]} s and the counted {NEW}-token one), "
              f"{BATCH * NEW / main_s:.1f} tokens/s (the counted generate: {main_s:.4f} s); "
              f"device busy "
              f"{busy_ms if busy_ms is None else round(busy_ms, 3)} ms/step, idle share {idle}; "
              f"weights and buffers resident {resident_gb:.3f} GB, peak {peak_gb:.3f} GB; "
              f"launches {expect}", flush=True)
        print(f"[quant-bf16] {card}: {label}: the unquantized bf16 model, timed alternately "
              f"with it: prefill {base_prefill_ms:.3f} ms, decode {base_decode_ms:.4f} ms/step "
              f"({QUANT_ALT_NEW}-token generates {[round(x, 4) for x in base_gens]} s against "
              f"{[round(x, 4) for x in gens]})", flush=True)
        out[label] = launches
        del model
        torch.cuda.empty_cache()
    # each counted generate's launches were required exact above: one
    # prefill (N_ADAPTED) and `steps` decode steps of N_ADAPTED each
    launches = {}
    for name in ("int8_matmul", "int4_matmul"):
        total = sum(v[name] for v in out.values())
        prefills = N_ADAPTED * sum(1 for v in out.values() if v[name])
        launches.update({name: total - prefills, name + "_tile": prefills})
    return {"launches": launches}


def phase_quant_train_f32(card: str) -> None:
    """One optimizer step (bs 2 x ga 2 x seq 128, full width, 2 layers, f32,
    TF32 off, merged training off) over an int8 and an int4 base, through
    Trainer on the card against a CPU copy on the plain path, with
    ``phase_train_f32``'s tolerances.  Launches: K7/K5 and K2 in the forward
    and K3 in the backward on every adapted linear each micro-batch; K8/K6
    on all but layer 0's q, k and v, whose input (the frozen embedding,
    normalised) needs no gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = F32_TRAIN
    n_adapted = 7 * c["layers"]
    data = train_data(c["bs"] * c["ga"], c["seq"], SEED + 14)
    for bits in (8, 4):
        model = train_model("float32", c["layers"])
        require(quant.quantize_frozen_base(model, bits=bits) == n_adapted, "quantize missed layers")
        name = f"int{bits}_matmul"
        expect = {name: n_adapted * c["ga"], "monarch_add": n_adapted * c["ga"],
                  "monarch_bwd": n_adapted * c["ga"], name + "_dx": (n_adapted - 3) * c["ga"]}
        check_step(model, data, "off", expect, f"[quant-train-f32] {card}: int{bits}")
        del model
        torch.cuda.empty_cache()


def phase_quant_train_bf16(card: str, bits: int) -> dict:
    """QLoRA-style training at full size (``run_alpaca.py --bits 8`` or
    ``--bits 4``): the 22-layer bf16 model over an int8 or int4 base, bs 4 x
    ga 8 x seq 512, merged training off, 1 warm-up and 3 timed optimizer
    steps through Trainer, the launch counts zeroed just before the first
    step and read just after the last (``train_timed``).  Launches, exact:
    the base's forward (K7, K5) and K2 and K3 on every adapted linear each
    micro-batch, its dx (K8, K6) on all but layer 0's q, k and v, whose
    input needs no gradient; nothing else."""
    model = train_model("bfloat16", MODEL["num_hidden_layers"])
    require(quant.quantize_frozen_base(model, bits=bits) == N_ADAPTED, "quantize missed layers")
    torch.cuda.empty_cache()
    resident = f"weights and buffers resident {torch.cuda.memory_allocated() / 1e9:.3f} GB, "
    run = train_timed(model, "off", f"[quant-train-bf16] {card}: int{bits} base, merged off",
                      resident)
    launches = run["launches"]
    print(f"[quant-train-bf16] {card}: int{bits} base: AdamW state "
          f"{run['opt_state_bytes'] / 1e6:.3f} MB", flush=True)
    micro = TRAIN_GA * TRAIN_STEPS
    name = f"int{bits}_matmul"
    expect = {name: N_ADAPTED * micro, "monarch_add": N_ADAPTED * micro,
              "monarch_bwd": N_ADAPTED * micro, name + "_dx": (N_ADAPTED - 3) * micro}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"int{bits} training: launches {launches}; expected {expect}")
    del model
    torch.cuda.empty_cache()
    return {"launches": {name: launches[name], name + "_dx": launches[name + "_dx"]}}


# -- the Alpaca + MMLU harness (scripts/run_alpaca.py) --------------------------

def _alpaca_records(out_dir: str, name: str = "metrics.jsonl", task: str = "alpaca") -> list:
    with open(os.path.join(out_dir, task, name)) as f:
        return [json.loads(line) for line in f]


def alpaca_run(argv: list, build=None, step_context=None) -> dict:
    """One ``run_alpaca.run`` with the launch counts zeroed just before it
    and read just after, and the forwards of its model counted (a hook on
    the decoder stack, through which training, the eval loss, MMLU and
    generation all pass), with the shapes of the training forwards; the
    wall seconds of the whole run beside them.  ``step_context`` goes to
    the harness's trainer."""
    from sparse_matrix_fine_tuning_torch.scripts import run_alpaca

    forwards, shapes = [0], collections.Counter()

    def hook(module, args):
        forwards[0] += 1
        if module.training:
            shapes[tuple(args[0].shape)] += 1

    def counted(args, peft_config):
        model = (build or run_alpaca.build_model)(args, peft_config)
        model.model.register_forward_pre_hook(hook)
        return model

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    reset_counts()  # the counted main path starts here
    t0 = time.perf_counter()
    result = run_alpaca.run(argv, build=counted, step_context=step_context)
    seconds = time.perf_counter() - t0
    launches = counts()  # the counted main path ends here
    return {"run": result, "launches": launches, "forwards": forwards[0],
            "train_shapes": dict(shapes), "seconds": seconds}


def alpaca_expect(bits: int, adapted: int, forwards: int, micro: int, forward: str) -> dict:
    """The exact launches of a harness run: ``forward`` (K2, or K1 where
    dropout wraps the adapter branch) and the quantized forward on every
    adapted linear each forward of the model, K3 on every adapted linear
    each training micro-batch, the quantized dx on all but layer 0's q, k
    and v (their input, the frozen embedding normalised, needs no
    gradient); nothing else."""
    expect = {forward: adapted * forwards, "monarch_bwd": adapted * micro}
    if bits != 16:
        expect[f"int{bits}_matmul"] = adapted * forwards
        expect[f"int{bits}_matmul_dx"] = (adapted - 3) * micro
    return expect


def alpaca_pair(card: str, name: str, argv: list, out: str, expect_of, report=None) -> dict:
    """One smoke run of the Alpaca harness on the card and on the CPU
    (``--platform=cpu``, the plain path, launching nothing), float32: the
    logged losses, ``eval_loss`` and the MMLU choice logits agree within
    ``ALPACA_TOL``, ``eval_results.json`` and ``predictions.jsonl`` are
    written, and the card's launches are ``expect_of(card run)`` exactly;
    ``report(card run, CPU run)``, where given, adds to the printed line.
    Returns those launches."""
    tol = ALPACA_TOL
    micro = ALPACA_STEPS * ALPACA_GA
    for d in (out, f"{out}_cpu"):  # the run logger appends to metrics.jsonl
        shutil.rmtree(d, ignore_errors=True)
    card_run = alpaca_run([*argv, f"--output_dir={out}"])
    cpu_run = alpaca_run([*argv, f"--output_dir={out}_cpu", "--platform=cpu"])
    require(not any(cpu_run["launches"].values()),
            f"alpaca {name}: the CPU run launched {cpu_run['launches']}")
    require(card_run["forwards"] == cpu_run["forwards"] > micro,
            f"alpaca {name}: {card_run['forwards']} forwards on the card, "
            f"{cpu_run['forwards']} on the CPU")
    expect = expect_of(card_run)
    expect_only(card_run["launches"], expect, f"alpaca {name}")
    losses = [[r["loss"] for r in _alpaca_records(d) if "loss" in r]
              for d in (out, f"{out}_cpu")]
    require(len(losses[0]) == len(losses[1]) == ALPACA_STEPS, f"losses {losses}")
    err = max(abs(a - b) - tol["rtol"] * abs(b) for a, b in zip(*losses))
    require(err <= tol["atol"], f"alpaca {name}: losses {losses[0]} card, "
                                f"{losses[1]} CPU")
    m_card, m_cpu = card_run["run"].metrics, cpu_run["run"].metrics
    require(abs(m_card["eval_loss"] - m_cpu["eval_loss"])
            <= tol["atol"] + tol["rtol"] * abs(m_cpu["eval_loss"]),
            f"alpaca {name}: eval_loss {m_card['eval_loss']} card, {m_cpu['eval_loss']} CPU")
    logits = [torch.from_numpy(r["run"].choice_logits()) for r in (card_run, cpu_run)]
    gap = float(((logits[0] - logits[1]).abs() - tol["rtol"] * logits[1].abs()).max())
    n_mmlu = len(card_run["run"].mmlu_eval)
    require(logits[0].shape == logits[1].shape == (n_mmlu, 4) and gap <= tol["atol"],
            f"alpaca {name}: MMLU choice logits differ by {gap} past the rtol")
    for fname in ("eval_results.json", "predictions.jsonl"):
        require(os.path.getsize(os.path.join(out, "alpaca", fname)) > 0, f"no {fname}")
    preds = [[r["prediction"] for r in _alpaca_records(d, "predictions.jsonl")]
             for d in (out, f"{out}_cpu")]
    same = sum(a == b for a, b in zip(*preds))
    acc = [m["eval_mmlu_eval_accuracy"] for m in (m_card, m_cpu)]
    if "--pack=True" in argv:
        packed = card_run["run"].trainer.train_data
        name += (f" ({len(packed['input_ids'])} rows of {packed['input_ids'].shape[1]}, "
                 f"{int(packed['attention_mask'].sum())} tokens)")
    extra = f"; {report(card_run, cpu_run)}" if report else ""
    print(f"[alpaca] {card}: smoke, {name}{extra}: losses "
          f"{losses[0]} card, {losses[1]} CPU; eval_loss {m_card['eval_loss']} / "
          f"{m_cpu['eval_loss']}; MMLU choice logits max |card - CPU| "
          f"{float((logits[0] - logits[1]).abs().max()):.2e} (tol {tol}); MMLU accuracy "
          f"{acc[0]} / {acc[1]}; predictions equal {same}/{len(preds[0])}; "
          f"{card_run['forwards']} forwards; launches {expect}; wall "
          f"{card_run['seconds']:.2f} s "
          f"card, {cpu_run['seconds']:.2f} s CPU", flush=True)
    return expect


def phase_alpaca_smoke(card: str) -> dict:
    """(a) The tiny smoke Llama (float32, TF32 off) at ``--bits`` 16, 8 and 4,
    and at 16 with ``--pack=True``, on the card against the CPU
    (``alpaca_pair``; the launches ``alpaca_expect``'s).  Then
    ``alpaca_resume``.  Returns the launches of the card's runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    micro = ALPACA_STEPS * ALPACA_GA
    launches = {}
    for bits, extra in ((16, []), (8, []), (4, []), (16, ["--pack=True"]),
                        (4, ["--optim=adamw8bit"])):
        name = (f"int{bits}" if bits < 16 else "f32") + " base" + (
            ", packed" if "--pack=True" in extra else "") + (
            ", 8-bit AdamW" if "--optim=adamw8bit" in extra else "")
        out = os.path.join(OUT_DIR, f"alpaca_{bits}" + ("_pack" if "--pack=True" in extra else "")
                           + ("_8bit" if "--optim=adamw8bit" in extra else ""))
        expect = alpaca_pair(card, name, [*ALPACA_ARGV, "--bits", str(bits), *extra], out,
                             lambda run, bits=bits: alpaca_expect(bits, 7 * 2, run["forwards"],
                                                                  micro, "monarch_add"),
                             report=optimizer_codes if "--optim=adamw8bit" in extra else None)
        for k, v in expect.items():
            launches[k] = launches.get(k, 0) + v
    for k, v in alpaca_resume(card).items():
        launches[k] = launches.get(k, 0) + v
    return launches


def optimizer_codes(card_run: dict, cpu_run: dict) -> str:
    """The 8-bit optimizer's state of two harness runs: its bytes and the
    codes that differ between the card's and the CPU's (the card's gradients
    come from the kernels, so a value near a codebook midpoint may fall on
    the other side)."""
    states = [r["run"].trainer.optimizer for r in (card_run, cpu_run)]
    arrays = [{k: v.cpu() for k, v in opt.state_arrays().items()} for opt in states]
    require(type(states[0].opt).__name__ == "AdamW8bit" and sorted(arrays[0]) == sorted(arrays[1]),
            "alpaca 8-bit AdamW: the runs' optimizer states differ in kind")
    codes = collections.Counter()
    for key, got in arrays[0].items():
        if key.endswith(("/mq", "/vq")):
            codes[key[-2:] + " total"] += got.numel()
            codes[key[-2:]] += int((got != arrays[1][key]).sum())
    return (f"8-bit state {states[0].state_bytes()} bytes; codes differing card against CPU: "
            f"m {codes['mq']} of {codes['mq total']}, v {codes['vq']} of {codes['vq total']}")


def alpaca_resume(card: str) -> dict:
    """The smoke argv (no MMLU, no predictions) on the card: 2·N optimizer
    steps straight (N = ``ALPACA_STEPS``), then N into another directory and
    a second ``run`` there with ``--max_steps`` 2·N and ``--resume=True``,
    which loads the checkpoint at N and goes on.  The resumed run's launches
    exact (its N steps alone); the logged losses of steps N+1 to 2·N (and
    1 to N) within ``ALPACA_TOL`` of the straight run's.  Returns the
    resumed run's launches."""
    tol = ALPACA_TOL
    argv = [*ALPACA_ARGV, "--do_mmlu_eval=False", "--do_predict=False"]
    straight, cut = (os.path.join(OUT_DIR, f"alpaca_{name}") for name in ("straight", "resumed"))
    for d in (straight, cut):
        shutil.rmtree(d, ignore_errors=True)
    alpaca_run([*argv, f"--max_steps={2 * ALPACA_STEPS}", f"--output_dir={straight}"])
    alpaca_run([*argv, f"--max_steps={ALPACA_STEPS}", f"--output_dir={cut}"])
    resumed = alpaca_run([*argv, f"--max_steps={2 * ALPACA_STEPS}", "--resume=True",
                          f"--output_dir={cut}"])
    require(resumed["run"].trainer.step == 2 * ALPACA_STEPS,
            f"alpaca resume: the resumed run ended at step {resumed['run'].trainer.step}")
    expect = alpaca_expect(16, 7 * 2, resumed["forwards"], ALPACA_STEPS * ALPACA_GA,
                           "monarch_add")
    expect_only(resumed["launches"], expect, "alpaca resume")
    losses = [[r["loss"] for r in _alpaca_records(d) if "loss" in r] for d in (cut, straight)]
    require(len(losses[0]) == len(losses[1]) == 2 * ALPACA_STEPS, f"alpaca resume: {losses}")
    err = max(abs(a - b) - tol["rtol"] * abs(b) for a, b in zip(*losses))
    require(err <= tol["atol"], f"alpaca resume: losses {losses[0]} resumed, {losses[1]} straight")
    print(f"[alpaca] {card}: smoke, resumed at step {ALPACA_STEPS} to {2 * ALPACA_STEPS}: losses "
          f"{losses[0]} (the first {ALPACA_STEPS} before the resume), straight {losses[1]}; "
          f"{resumed['forwards']} forwards in the resumed run; launches {expect}", flush=True)
    return expect


def harness_step_context(steps: dict, label: str):
    """A harness trainer's ``step_context``: step 0 under the profiler
    (``busy_ms``, ``profiled_wall_ms``), each later step alone, the card
    synchronised around it (``wall_ms``, one a step; ``peak_gb``, the last
    step's peak memory; ``peak_before_gb``, the largest peak before a
    step); all into ``steps``."""
    from sparse_matrix_fine_tuning_torch.utils.profiling import device_memory_stats

    @contextlib.contextmanager
    def harness_step(k):
        if k == 0:
            with device_busy(f"{label} training step 0") as prof:
                yield
            steps.update(busy_ms=prof["busy_ms"], profiled_wall_ms=prof["wall_ms"])
            return
        torch.cuda.synchronize()
        steps["peak_before_gb"] = max(steps.get("peak_before_gb", 0.0),
                                      torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        steps.setdefault("wall_ms", []).append((time.perf_counter() - t0) * 1e3)
        steps["peak_gb"] = device_memory_stats()["cuda:0"]["peak_bytes_in_use"] / 1e9

    return harness_step


def phase_alpaca_full(card: str) -> dict:
    """(b) The harness at TinyLlama-1.1B widths (all 22 layers, bf16, random
    seeded weights through the ``build`` seam) at ``--bits`` 16 and 4 with
    the harness's defaults but ga (dropout 0.1, so K1 and not K2 in the
    forwards; batch 4 x ga ``ALPACA_FULL_GA``, 4; lengths 1024/256; 5-shot
    MMLU at 2048 tokens) over its synthetic data: the launches exact
    (``alpaca_expect``: K3 154 x 8 = 1,232, K6 151 x 8 = 1,208); the
    harness's own two steps, through its
    trainer's ``step_context``: step 0 under the profiler (device busy),
    step 1 alone (wall ms, the card synchronised around it, and its peak
    memory); the MMLU scoring and predict seconds the harness measured;
    the peak memory over the run and what stays resident after it.  Then
    the bf16 base with ``--pack=True``: the same, beside the packed rows'
    count and token efficiency.  Returns the launches."""
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.scripts import run_alpaca
    from sparse_matrix_fine_tuning_torch.utils.profiling import device_memory_stats

    micro = ALPACA_STEPS * ALPACA_FULL_GA
    launches = {}

    def build_full(args, peft_config):
        cfg = LlamaConfig(**MODEL, param_dtype="bfloat16", dtype="bfloat16",
                          max_position_embeddings=2048)
        g = torch.Generator(device="cuda").manual_seed(SEED + 20)
        return run_alpaca.adapt_model(LlamaForCausalLM(cfg, device="cuda", generator=g), args,
                                      peft_config)

    for bits, extra in ((16, []), (4, ["--optim=adamw8bit"]), (16, ["--pack=True"])):
        base = ("int4" if bits == 4 else "bf16") + (", packed" if "--pack=True" in extra else "")
        steps = {}
        gc.collect()  # what the last run left to the cyclic collector goes before measuring
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9
        out = os.path.join(OUT_DIR, f"alpaca_full_{bits}" + ("_pack" if "--pack=True" in extra
                                                              else ""))
        shutil.rmtree(out, ignore_errors=True)
        full = alpaca_run([*ALPACA_FULL_ARGV, "--bits", str(bits), *extra, f"--output_dir={out}"],
                          build=build_full,
                          step_context=harness_step_context(steps, f"harness ({base} base)"))
        memory = device_memory_stats()["cuda:0"]
        # step 1 reset the peak: the run's is the larger of the peaks before and since
        run_peak_gb = max(memory["peak_bytes_in_use"] / 1e9, steps["peak_before_gb"])
        resident_gb = memory["bytes_in_use"] / 1e9
        expect = alpaca_expect(bits, N_ADAPTED, full["forwards"], micro, "monarch_kernel")
        expect_only(full["launches"], expect, f"alpaca full width, {base} base")
        for k, v in expect.items():
            launches[k] = launches.get(k, 0) + v
        metrics, a = full["run"].metrics, full["run"].trainer.args
        require(math.isfinite(metrics["eval_loss"]), f"eval_loss {metrics['eval_loss']}")
        losses = [r["loss"] for r in _alpaca_records(out) if "loss" in r]
        require(len(losses) == ALPACA_STEPS and all(map(math.isfinite, losses)),
                f"losses {losses}")
        require(len(steps.get("wall_ms", [])) == ALPACA_STEPS - 1 and "busy_ms" in steps,
                f"alpaca full width, {base} base: the harness's steps seen {steps}")
        wall, busy = steps["wall_ms"][0], steps["busy_ms"]
        data = full["run"].trainer.train_data
        rows, width = data["input_ids"].shape
        packing = (f"{rows} training rows of {width} tokens, token efficiency "
                   f"{int(data['attention_mask'].sum()) / (rows * width):.4f}; ")
        RECORDS.append({"alpaca_full": base, "rows": rows, "width": width,
                        "tokens": int(data["attention_mask"].sum()), "step1_wall_ms": wall,
                        "step0_busy_ms": busy, "card": card})
        idle = f"{1 - busy / wall:.3f}" if busy is not None else "not measured"
        print(f"[alpaca-full] {card}: TinyLlama-1.1B widths, 22 layers, bf16, {base} base, "
              f"dropout 0.1: {packing}losses {losses}, eval_loss {metrics['eval_loss']}; "
              f"the harness's "
              f"steps (ga {a.gradient_accumulation_steps} x bs {a.per_device_train_batch_size}; "
              f"training forwards by shape {full['train_shapes']}): step 1 wall {wall:.2f} ms "
              f"(alone, the card synchronised around it), step 0 device busy "
              f"{busy if busy is None else round(busy, 2)} ms (profiled; wall "
              f"{steps['profiled_wall_ms']:.2f} ms with the profiler on, the run's first "
              f"step), idle share {idle} (1 - step 0 busy / step 1 wall); MMLU scoring "
              f"{metrics['eval_mmlu_runtime']} s ({len(full['run'].mmlu_eval)} items, "
              f"--mmlu_kshot {full['run'].args.mmlu_kshot}) and predict "
              f"{metrics['predict_runtime']} s "
              f"({metrics['predict_samples']} rows, {ALPACA_FULL_NEW} new tokens), both wall; "
              f"harness run {full['seconds']:.2f} s wall; memory: {before_gb:.2f} GB allocated "
              f"before the run, peak {run_peak_gb:.2f} GB over "
              f"the run (the build and quantization on the card included), {resident_gb:.2f} GB "
              f"resident after it, peak {steps['peak_gb']:.2f} GB over step 1; optimizer "
              f"{type(full['run'].trainer.optimizer.opt).__name__}, state "
              f"{full['run'].trainer.optimizer.state_bytes() / 1e6:.3f} MB; "
              f"{full['forwards']} forwards; launches {expect}", flush=True)
        del full
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def decoder_stack(model):
    """The decoder stack of a harness's model (a ``ReftModel`` wraps it):
    its ``LlamaModel``, or the GPT families' body (Backpack's whole model,
    whose contextualization ``GPT2Model`` comes after it)."""
    from sparse_matrix_fine_tuning_torch import models
    from sparse_matrix_fine_tuning_torch.models import backpack_gpt2, gpt2, gpt_neo, gpt_neox

    stacks = (models.LlamaModel, backpack_gpt2.BackpackGPT2Model, gpt2.GPT2Model,
              gpt_neo.GPTNeoModel, gpt_neox.GPTNeoXModel)
    return next(m for m in model.modules() if isinstance(m, stacks))


def reasoning_run(argv: list, build=None, step_context=None) -> dict:
    """One ``run_reasoning.run`` with the launch counts zeroed just before it
    and read just after, and its model's forwards counted by mode (a hook on
    the decoder stack: "train" the training micro-batches, "eval" the
    prefills and decode steps of generation); the wall seconds of the run
    beside them, and the shapes of the training forwards.  ``forwards`` goes
    on counting the model's later calls."""
    from sparse_matrix_fine_tuning_torch.scripts import run_reasoning

    forwards, shapes = collections.Counter(), collections.Counter()

    def hook(module, args):
        forwards["train" if module.training else "eval"] += 1
        if module.training:
            shapes[tuple(args[0].shape)] += 1

    def counted(args, peft_config):
        model = (build or run_reasoning.build_model)(args, peft_config)
        decoder_stack(model).register_forward_pre_hook(hook)
        return model

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    reset_counts()  # the counted main path starts here
    t0 = time.perf_counter()
    result = run_reasoning.run(argv, build=counted, step_context=step_context)
    seconds = time.perf_counter() - t0
    launches = counts()  # the counted main path ends here
    return {"run": result, "launches": launches, "forwards": forwards,
            "train_forwards": forwards["train"], "eval_forwards": forwards["eval"],
            "train_shapes": dict(shapes), "seconds": seconds}


@contextlib.contextmanager
def capped_new_tokens(task: str, n: int):
    """The reasoning task's ``generation_args`` at ``n`` new tokens while
    the block runs (the harness's evals read them), restored after."""
    from sparse_matrix_fine_tuning_torch.data.reasoning import TASK_CONFIG

    args = TASK_CONFIG[task]["generation_args"]
    saved = copy.deepcopy(args)
    for gen in args.values():
        gen["max_new_tokens"] = n
    try:
        yield
    finally:
        args.clear()
        args.update(saved)


def counted_eval(run: dict, label: str, **kw) -> dict:
    """``ReasoningRun.evaluate(**kw)`` on a ``reasoning_run``'s trained model,
    with the launch counts zeroed just before it and read just after: the
    results, the launches, the forwards (prefills and decode steps) and the
    wall seconds, the card synchronised around it."""
    before = run["forwards"]["eval"]
    torch.cuda.synchronize()
    reset_counts()  # the counted main path starts here
    t0 = time.perf_counter()
    results = run["run"].evaluate(**kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()  # the counted main path ends here
    return {"results": results, "launches": launches, "seconds": seconds,
            "forwards": run["forwards"]["eval"] - before, "label": label}


def _generations(out_dir: str) -> list:
    with open(os.path.join(out_dir, "generations.json")) as f:
        return json.load(f)


def phase_reasoning_smoke(card: str) -> dict:
    """(a) The reasoning harness (``scripts/run_reasoning.py``) on the tiny
    smoke Llama in float32, TF32 off, ``--dropout=0.0`` (the card's dropout
    masks are not the CPU's): ``-task math --smoke=True`` on the card and
    on the CPU: the logged losses within ``ALPACA_TOL``, the seven
    ``eval/*`` and the generations equal, the card's launches exact (K2 on
    every adapted linear each forward, K3 each training micro-batch), none
    on the CPU.  ``-task alpaca --greedy_decoding=False`` (penalty 1.1 and
    5-gram bans) likewise, its alpaca_eval dump equal.  ``-task gsm8k
    --greedy_decoding=False`` (top-k 40, top-p 0.95, temperature 0.8): the
    trained model's sampled eval twice, under one seed, equal.  Then
    ``beam_generate`` at 4 beams on the math run's trained model and a CPU
    copy of it: equal tokens, K2 exact.  Returns the launches."""
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, beam_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = ALPACA_TOL
    adapted = 7 * 2
    launches = collections.Counter()
    runs = {}
    for task, extra in (("math", []), ("alpaca", ["--greedy_decoding=False"]),
                        ("gsm8k", ["--greedy_decoding=False"])):
        out = os.path.join(OUT_DIR, f"reasoning_{task}")
        argv = [*REASONING_ARGV, "-task", task, *extra]
        for d in (out, f"{out}_cpu"):  # the run logger appends to metrics.jsonl
            shutil.rmtree(d, ignore_errors=True)
        card_run = reasoning_run([*argv, f"--output_dir={out}"])
        micro = card_run["train_forwards"]
        require(micro == REASONING_STEPS * REASONING_GA,
                f"reasoning {task}: {micro} training forwards")
        expect = alpaca_expect(16, adapted, micro + card_run["eval_forwards"], micro,
                               "monarch_add")
        expect_only(card_run["launches"], expect, f"reasoning {task}")
        launches.update(expect)
        runs[task] = card_run
        gens = _generations(os.path.join(out, task))
        require(len(gens) > 0, f"reasoning {task}: no generations")
        if task == "gsm8k":
            again = [card_run["run"].evaluate(greedy=False, out=os.path.join(out, f"again{i}"))
                     for i in range(2)]
            draws = [_generations(os.path.join(out, f"again{i}")) for i in range(2)]
            require(draws[0] == draws[1] == gens and again[0] == again[1]
                    == card_run["run"].results,
                    f"reasoning gsm8k: sampled evals under one seed differ: {again}")
            print(f"[reasoning] {card}: smoke, gsm8k sampled (top-k 40, top-p 0.95, "
                  f"temperature 0.8): three evals under one seed equal ({len(gens)} "
                  f"generations, {card_run['run'].results}); launches {expect}", flush=True)
            continue
        cpu_run = reasoning_run([*argv, f"--output_dir={out}_cpu", "--platform=cpu"])
        require(not any(cpu_run["launches"].values()),
                f"reasoning {task}: the CPU run launched {cpu_run['launches']}")
        losses = [[r["loss"] for r in _alpaca_records(d, "metrics.jsonl", task) if "loss" in r]
                  for d in (out, f"{out}_cpu")]
        require(len(losses[0]) == len(losses[1]) == REASONING_STEPS, f"losses {losses}")
        err = max(abs(a - b) - tol["rtol"] * abs(b) for a, b in zip(*losses))
        require(err <= tol["atol"], f"reasoning {task}: losses {losses[0]} card, "
                                    f"{losses[1]} CPU")
        cpu_gens = _generations(os.path.join(f"{out}_cpu", task))
        same = sum(a == b for a, b in zip(gens, cpu_gens))
        results = [r["run"].results for r in (card_run, cpu_run)]
        require(same == len(gens) == len(cpu_gens) and results[0] == results[1],
                f"reasoning {task}: generations equal {same}/{len(gens)}; results {results}")
        print(f"[reasoning] {card}: smoke, {task}{' ' + extra[0] if extra else ''}: losses "
              f"{losses[0]} card, {losses[1]} CPU (tol {tol}); results {results[0]} on both; "
              f"generations equal {same}/{len(gens)}; {micro} training and "
              f"{card_run['eval_forwards']} generation forwards; launches {expect}; wall "
              f"{card_run['seconds']:.2f} s card, {cpu_run['seconds']:.2f} s CPU", flush=True)

    # beam search on the math run's trained weights, on the card and a CPU copy
    model = runs["math"]["run"].trainer.model
    cpu_model = copy.deepcopy(model).cpu()
    g = torch.Generator().manual_seed(SEED + 21)
    ids = torch.randint(4, 1024, (3, 12), generator=g)
    mask = torch.ones_like(ids)
    mask[1, :5] = mask[2, :9] = 0
    ids = ids * mask + runs["math"]["run"].tokenizer.pad_token_id * (1 - mask)
    gc_beam = GenerationConfig(max_new_tokens=REASONING_BEAM_NEW, num_beams=4,
                               eos_token_id=runs["math"]["run"].tokenizer.eos_token_id,
                               pad_token_id=runs["math"]["run"].tokenizer.pad_token_id)
    before = runs["math"]["forwards"]["eval"]
    reset_counts()  # the counted main path starts here
    got = beam_generate(model, ids.cuda(), mask.cuda(), gc_beam).cpu()
    beam_launches = counts()  # the counted main path ends here
    steps = runs["math"]["forwards"]["eval"] - before
    want = beam_generate(cpu_model, ids, mask, gc_beam)
    expect = {"monarch_add": adapted * steps}
    expect_only(beam_launches, expect, "beam_generate, 4 beams")
    launches.update(expect)
    require(torch.equal(got, want), f"beam_generate: card {got.tolist()}, CPU {want.tolist()}")
    print(f"[reasoning] {card}: smoke, beam_generate at 4 beams (3 left-padded prompts, "
          f"{REASONING_BEAM_NEW} new tokens): card tokens equal the CPU's; {steps} forwards; "
          f"launches {expect}", flush=True)
    del runs, model, cpu_model
    return dict(launches)


def llama_shapes(config: dict) -> dict:
    """HF tensor name -> shape of a Llama checkpoint of ``config``."""
    h, inter, layers = config["hidden_size"], config["intermediate_size"], \
        config["num_hidden_layers"]
    kv = config["num_key_value_heads"] * h // config["num_attention_heads"]
    shapes = {"model.embed_tokens.weight": (config["vocab_size"], h)}
    for i in range(layers):
        p = f"model.layers.{i}"
        shapes.update({f"{p}.self_attn.q_proj.weight": (h, h),
                       f"{p}.self_attn.k_proj.weight": (kv, h),
                       f"{p}.self_attn.v_proj.weight": (kv, h),
                       f"{p}.self_attn.o_proj.weight": (h, h),
                       f"{p}.mlp.gate_proj.weight": (inter, h),
                       f"{p}.mlp.up_proj.weight": (inter, h),
                       f"{p}.mlp.down_proj.weight": (h, inter),
                       f"{p}.input_layernorm.weight": (h,),
                       f"{p}.post_attention_layernorm.weight": (h,)})
    shapes.update({"model.norm.weight": (h,), "lm_head.weight": (config["vocab_size"], h)})
    return shapes


def is_norm_weight(name: str) -> bool:
    """A LayerNorm's or RMSNorm's scale in an HF checkpoint (``*norm.weight``,
    BLIP's ``layer_norm1``/``layer_norm2``, GPT-2's ``ln_1``, ``ln_2``, ``ln_f``
    and Backpack's ``ln``)."""
    leaf = name.rsplit(".", 2)[-2:]
    return re.search(r"norm\d?\.weight$", name.lower()) is not None or (
        leaf[1] == "weight" and (leaf[0] == "ln" or leaf[0].startswith("ln_")))


def write_hf_checkpoint(path: str, config: dict, shapes: dict, seed: int,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """An HF-format directory: ``config.json`` and a ``model.safetensors``
    (``models/hf_convert.write_safetensors``) of the tensors ``shapes``
    names, random, in ``dtype``, drawn on the card from a generator seeded
    ``seed`` in ``shapes``' order: N(0, 0.02), and 1 + N(0, 0.02) for a
    norm's weight (``is_norm_weight``; Gemma's stored offset stays N(0,
    0.02)).  Returns the written tensors, on the card."""
    from sparse_matrix_fine_tuning_torch.models.hf_convert import write_safetensors

    g = torch.Generator(device="cuda").manual_seed(seed)
    tensors = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=g, device="cuda").mul_(0.02)
        if is_norm_weight(name) and config.get("model_type") != "gemma":
            t += 1.0  # Gemma stores its norms' offset from 1
        tensors[name] = t.to(dtype)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return tensors


def reasoning_tokenizer(ckpt: str) -> str:
    """Write a byte-fallback BPE ``tokenizer.json`` and its
    ``tokenizer_config.json`` into the TinyLlama-width directory
    (``data/hf_tokenizer.write_byte_fallback_bpe``, no tokenizer package:
    <unk>, <s>, </s>, the 256 <0xNN> tokens, merges learned from the prompts
    of the items ``REASONING_FULL_ARGV`` trains and evaluates on, padded to
    the model's 32000 ids), load it through ``get_tokenizer`` as the harness
    does, and require decode(encode(prompt)) to give each prompt back.
    Returns the line that reports it."""
    from sparse_matrix_fine_tuning_torch.data.reasoning import (
        TASK_CONFIG,
        build_prompt,
        load_data_items,
    )
    from sparse_matrix_fine_tuning_torch.data.tokenizer import get_tokenizer
    from sparse_matrix_fine_tuning_torch.scripts import run_reasoning

    t0 = time.perf_counter()
    args, _ = run_reasoning.parse_args([*REASONING_FULL_ARGV, "--model", ckpt])
    train = load_data_items(args.task, args.train_dataset or TASK_CONFIG[args.task][
        "train_datasets"][0], args.data_dir, split="train", max_n_example=args.max_n_train_example,
        seed=args.seed)
    evals = load_data_items(args.task, args.eval_dataset, args.data_dir, split=args.test_split,
                            is_eval=True, max_n_example=args.max_n_eval_example, seed=args.seed)
    prompts = [build_prompt(args.task, it, "")[1] for it in train] + \
        [build_prompt(args.task, it, "")[0] for it in evals]
    spec = write_byte_fallback_bpe(ckpt, prompts, vocab_size=TINYLLAMA_HF["vocab_size"])
    write_s = time.perf_counter() - t0
    tok = get_tokenizer(ckpt)
    require(isinstance(tok, BPETokenizer) and tok.vocab_size == TINYLLAMA_HF["vocab_size"],
            f"reasoning full: get_tokenizer gave {type(tok).__name__}")
    t0 = time.perf_counter()
    counts_ = []
    for prompt in prompts:
        ids = tok.encode_ids(prompt)
        require(tok.decode(ids) == prompt and ids[0] == tok.bos_token_id,
                f"reasoning full: decode(encode({prompt[:60]!r}...)) gives "
                f"{tok.decode(ids)[:60]!r}")
        counts_.append(len(ids))
    encode_s = time.perf_counter() - t0
    chars = sum(map(len, prompts))
    merges = len(spec["model"]["merges"])
    RECORDS.append({"reasoning_tokenizer": merges,
                    "tokens_per_prompt": counts_, "chars": chars, "write_s": write_s,
                    "encode_decode_s": encode_s})
    return (f"byte-fallback BPE tokenizer.json written in {write_s:.2f} s ({merges} merges "
            f"learned from the {len(prompts)} prompts, {tok.vocab_size} ids), every "
            f"prompt decoded back from its ids; tokens a prompt min {min(counts_)} median "
            f"{statistics.median(counts_)} max {max(counts_)}, {chars / sum(counts_):.2f} chars a "
            f"token; encode and decode {encode_s * 1e3 / len(prompts):.2f} ms a prompt (host)")


def phase_reasoning_full(card: str) -> dict:
    """(b) The reasoning harness at TinyLlama-1.1B widths, all 22 layers,
    from an HF-format directory that this phase writes (``TINYLLAMA_HF``,
    random seeded bf16 weights, ``write_hf_checkpoint``, and the BPE
    tokenizer of ``reasoning_tokenizer``), which ``phase_reft_full``
    deletes: the tensors the harness's loader gives equal the written ones,
    the harness tokenizes through the BPE tokenizer; ``-task math`` in bf16 with the harness's defaults (remat "nothing", dropout
    0.1, so K1 on every forward, K1 twice a training micro-batch) at batch 4
    x ga 8 x max length 512 for ``REASONING_FULL_STEPS`` steps (step 0
    profiled: device busy; the later steps alone: wall and peak memory),
    then its greedy eval of one dataset (``REASONING_FULL_NEW`` new tokens
    for every eval of the phase, ``capped_new_tokens``); then the same eval
    again, timed
    alone (its results the harness's), and a beam-4 eval (``-top_k 0 -top_p
    1.0 -t 0.1``: beam-sample at temperature 0.1), each through
    ``ReasoningRun.evaluate``.  Wall a decode forward for each (the
    prefill included; a decode ends early where every row has emitted EOS),
    and device busy a forward from the profiler over a
    ``REASONING_PROFILE_NEW``-token eval of each.  Launches exact (K1, K3;
    K2 none).  Returns the launches and the directory, which
    ``phase_reft_full`` reads and deletes."""
    from sparse_matrix_fine_tuning_torch.scripts import run_reasoning

    ckpt = os.path.join(OUT_DIR, "reasoning_tinyllama")
    out = os.path.join(OUT_DIR, "reasoning_full")
    for d in (ckpt, out):
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    written = write_hf_checkpoint(ckpt, TINYLLAMA_HF, llama_shapes(TINYLLAMA_HF), SEED + 22)
    write_s = time.perf_counter() - t0
    size_gb = os.path.getsize(os.path.join(ckpt, "model.safetensors")) / 1e9
    tokenizer_line = reasoning_tokenizer(ckpt)
    loaded = {}

    def build_checked(args, peft_config):
        t0 = time.perf_counter()
        model = run_reasoning.build_model(args, peft_config)
        torch.cuda.synchronize()
        loaded["seconds"] = time.perf_counter() - t0
        params = dict(model.named_parameters())
        for name, t in written.items():
            proj = name.rsplit(".", 2)[-2]
            key = name[:-len("weight")] + "dense" if proj.endswith("_proj") else name
            require(params[key].dtype == torch.bfloat16 and torch.equal(params[key], t),
                    f"reasoning full: the loaded {key} is not the written {name}")
        loaded["tensors"] = len(written)
        loaded["config"] = model.config
        written.clear()
        return model

    with capped_new_tokens("math", REASONING_FULL_NEW):
        steps = {}
        torch.cuda.reset_peak_memory_stats()
        full = reasoning_run([*REASONING_FULL_ARGV, "--model", ckpt, f"--output_dir={out}"],
                             build=build_checked,
                             step_context=harness_step_context(steps, "reasoning harness (1.1B)"))
        cfg = loaded["config"]
        require(loaded.get("tensors") == 3 + 9 * 22 and cfg.remat
                and cfg.remat_policy == "nothing", f"reasoning full: loaded {loaded}")
        require(isinstance(full["run"].tokenizer, BPETokenizer),
                f"reasoning full: the harness tokenized with {type(full['run'].tokenizer).__name__}")
        micro = full["train_forwards"]
        require(micro == REASONING_FULL_STEPS * 8, f"reasoning full: {micro} training forwards")
        greedy_forwards = full["eval_forwards"]
        expect = {"monarch_kernel": N_ADAPTED * (2 * micro + greedy_forwards),
                  "monarch_bwd": N_ADAPTED * micro}
        expect_only(full["launches"], expect, "reasoning full, training and greedy eval")
        launches = collections.Counter(expect)
        losses = [r["loss"] for r in _alpaca_records(out, "metrics.jsonl", "math") if "loss" in r]
        require(len(losses) == REASONING_FULL_STEPS and all(map(math.isfinite, losses)),
                f"reasoning full: losses {losses}")
        require(len(steps.get("wall_ms", [])) == REASONING_FULL_STEPS - 1 and "busy_ms" in steps,
                f"reasoning full: the harness's steps seen {steps}")
        evals = {}
        for label, greedy in (("greedy", True), ("beam-4", False)):
            evals[label] = counted_eval(full, label, greedy=greedy, out=os.path.join(out, label))
            expect = {"monarch_kernel": N_ADAPTED * evals[label]["forwards"]}
            expect_only(evals[label]["launches"], expect, f"reasoning full, {label} eval")
            launches.update(expect)
        require(evals["greedy"]["results"] == full["run"].results,
                f"reasoning full: the greedy eval gave {evals['greedy']['results']}, the harness's "
                f"{full['run'].results}")
        busy = {}
        for label, greedy in (("greedy", True), ("beam-4", False)):
            before = full["forwards"]["eval"]
            with device_busy(f"reasoning {label} eval, {REASONING_PROFILE_NEW} new tokens") as prof:
                full["run"].evaluate(greedy=greedy, max_new=REASONING_PROFILE_NEW,
                                     out=os.path.join(out, f"profiled_{label}"))
            busy[label] = (prof["busy_ms"], full["forwards"]["eval"] - before)
    data = full["run"].trainer.train_data
    rows, width = data["input_ids"].shape
    wall = statistics.median(steps["wall_ms"])
    idle = f"{1 - steps['busy_ms'] / wall:.3f}" if steps["busy_ms"] else "not measured"
    evals_line = "; ".join(
        f"{label} eval {e['seconds']:.2f} s wall over {e['forwards']} forwards "
        f"({e['seconds'] * 1e3 / e['forwards']:.2f} ms a forward, the prefill included), "
        + (f"device busy {busy[label][0] / busy[label][1]:.3f} ms a forward (profiled, "
           f"{busy[label][1]} forwards)" if busy[label][0] else "device busy not measured")
        for label, e in evals.items())
    RECORDS.append({"reasoning_full": "math", "steps_wall_ms": steps["wall_ms"],
                    "step0_busy_ms": steps["busy_ms"], "harness_eval_forwards": greedy_forwards,
                    **{f"{label}_s": e["seconds"] for label, e in evals.items()},
                    **{f"{label}_forwards": e["forwards"] for label, e in evals.items()},
                    "busy": busy, "card": card})
    print(f"[reasoning-full] {card}: TinyLlama-1.1B widths from an HF-format directory, 22 "
          f"layers, bf16, remat \"nothing\", dropout 0.1: checkpoint {size_gb:.2f} GB written in "
          f"{write_s:.2f} s, loaded and adapted in {loaded['seconds']:.2f} s, its "
          f"{loaded['tensors']} tensors equal the written ones; {tokenizer_line}; {rows} "
          f"training rows of "
          f"{width} tokens; losses {losses}; steps 1-{REASONING_FULL_STEPS - 1} wall "
          f"{[round(w, 2) for w in steps['wall_ms']]} ms (median {wall:.2f}), step 0 device busy "
          f"{steps['busy_ms'] if steps['busy_ms'] is None else round(steps['busy_ms'], 2)} ms "
          f"(profiled; wall {steps['profiled_wall_ms']:.2f} ms with the profiler on), idle "
          f"share {idle} (1 - busy / median wall), peak {steps['peak_gb']:.2f} GB over step "
          f"{REASONING_FULL_STEPS - 1} ({steps['peak_before_gb']:.2f} GB before it); "
          f"the harness's greedy eval {greedy_forwards} forwards; then {evals_line}; results "
          f"greedy {full['run'].results}, beam-4 {evals['beam-4']['results']}; harness run "
          f"{full['seconds']:.2f} s wall; launches {dict(launches)}", flush=True)
    del full, evals
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": dict(launches), "checkpoint": ckpt}


def encoder_adapted_calls(model) -> int:
    """The adapted linears' calls a forward of a GLUE encoder: query, key and
    value a layer (RoBERTa); DeBERTa's shared position projections add
    query_proj and key_proj on the position rows."""
    if hasattr(model, "roberta"):
        return 3 * model.config.num_hidden_layers
    cfg = model.config
    shared = 2 if cfg.relative_attention and cfg.share_att_key else 0
    return (3 + shared) * cfg.num_hidden_layers


def encoder_run(module, argv: list, *, dropout: bool = True, build=None,
                step_context=None) -> dict:
    """One ``run`` of ``scripts/run_glue`` or ``scripts/run_agnews`` with the
    launch counts zeroed just before it and read just after; the forwards of
    its encoder counted by mode (a hook: "train" the micro-batches, "eval"
    the eval loss's and the predictions' batches) with the training
    shapes, its adapted calls a forward, and the run's wall seconds.
    ``dropout=False`` sets every ``nn.Dropout`` of the built model to 0, and
    every BOFT layer's dropout (the card's masks are not the CPU's)."""
    from sparse_matrix_fine_tuning_torch.peft.boft import BOFTLinear

    forwards, shapes, calls = collections.Counter(), collections.Counter(), {}

    def hook(encoder, args):
        forwards["train" if encoder.training else "eval"] += 1
        if encoder.training:
            shapes[tuple(args[0].shape)] += 1

    def counted(*a):
        model = (build or module.build_model)(*a)
        if not dropout:
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
                elif isinstance(m, BOFTLinear):
                    m.dropout_p = 0.0
        encoder = model.roberta if hasattr(model, "roberta") else model.deberta
        encoder.register_forward_pre_hook(hook)
        calls["per_forward"] = encoder_adapted_calls(model)
        return model

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    reset_counts()  # the counted main path starts here
    t0 = time.perf_counter()
    result = module.run(argv, build=counted, step_context=step_context)
    seconds = time.perf_counter() - t0
    launches = counts()  # the counted main path ends here
    return {"run": result, "launches": launches, "forwards": forwards, "shapes": dict(shapes),
            "per_forward": calls["per_forward"], "seconds": seconds}


def encoder_expect(run: dict, forward: str | None = "monarch_add") -> dict:
    """The exact launches of an encoder harness run: ``forward`` on every
    adapted call each forward (training, eval and predictions): K2 for
    Monarch adapters over a dense base (the GLUE adapters carry no dropout,
    so no forward takes K1), K1 in projection mode; K3 on each a training
    forward.  None (LoRA, BOFT): no kernel of ours."""
    if forward is None:
        return {}
    per = run["per_forward"]
    return {forward: per * (run["forwards"]["train"] + run["forwards"]["eval"]),
            "monarch_bwd": per * run["forwards"]["train"]}


def _close(a: float, b: float, tol: dict) -> bool:
    return abs(a - b) <= tol["atol"] + tol["rtol"] * abs(b)


def encoder_pair(card: str, label: str, module, argv: list, out: str,
                 forward: str | None = "monarch_add", steps: int | None = None) -> dict:
    """One harness run (``scripts/run_glue`` or ``scripts/run_agnews``) on the
    card and on the CPU (``--platform=cpu``, launching nothing), float32,
    dropout off, into ``out`` and ``out``_cpu: the logged losses and
    ``eval_loss`` within ``ALPACA_TOL``, the other metrics equal (STS-B's
    correlations within ``GLUE_CORRELATION_ATOL``), the TSV files equal, the
    forwards equal (``steps`` training forwards, where given), the card's
    launches exact (``encoder_expect`` with ``forward``).  Returns the card
    run's launches and both runs."""
    from sparse_matrix_fine_tuning_torch.scripts import run_glue

    tol = ALPACA_TOL
    for d in (out, f"{out}_cpu"):  # the run logger appends to metrics.jsonl
        shutil.rmtree(d, ignore_errors=True)
    card_run = encoder_run(module, [*argv, f"--output_dir={out}"], dropout=False)
    cpu_run = encoder_run(module, [*argv, f"--output_dir={out}_cpu", "--platform=cpu"],
                          dropout=False)
    require(not any(cpu_run["launches"].values()),
            f"{label}: the CPU run launched {cpu_run['launches']}")
    require(card_run["forwards"] == cpu_run["forwards"]
            and (steps is None or card_run["forwards"]["train"] == steps),
            f"{label}: forwards {card_run['forwards']} card, {cpu_run['forwards']} CPU")
    expect = encoder_expect(card_run, forward)
    expect_only(card_run["launches"], expect, f"{label}")
    if module is run_glue:
        sub = card_run["run"].args.config_path
        task = next(iter(card_run["run"].results))
        dirs = [os.path.join(d, task) for d in (out, f"{out}_cpu")]
        results = [r["run"].results for r in (card_run, cpu_run)]
        tsvs = [[os.path.basename(p) for p in r["run"].tsv_paths] for r in (card_run, cpu_run)]
        require(tsvs[0] == tsvs[1] and tsvs[0], f"{label}: TSV files {tsvs}")
        for name in tsvs[0]:
            texts = [open(os.path.join(d, "predict", name)).read() for d in dirs]
            require(texts[0] == texts[1], f"{label}: {name} differs between card and CPU")
    else:
        method = card_run["run"].args.method
        sub, dirs = "agnews", [os.path.join(d, method) for d in (out, f"{out}_cpu")]
        results = [{"agnews": r["run"].result} for r in (card_run, cpu_run)]
    losses = [[r["loss"] for r in _alpaca_records(d, task="") if "loss" in r] for d in dirs]
    require(len(losses[0]) == len(losses[1]) >= 2
            and all(_close(a, b, tol) for a, b in zip(*losses)),
            f"{label}: losses {losses[0]} card, {losses[1]} CPU")
    require(results[0].keys() == results[1].keys(), f"{label}: {results}")
    for split, metrics in results[1].items():
        for key, value in metrics.items():
            got = results[0][split][key]
            ok = (_close(got, value, tol) if key == "eval_loss"
                  else abs(got - value) <= GLUE_CORRELATION_ATOL
                  if key in ("eval_pearson", "eval_spearmanr") else got == value)
            require(ok, f"{label}: {split} {key} {got} card, {value} CPU")
    print(f"[glue] {card}: smoke, {label} ({sub}): losses {losses[0]} card, {losses[1]} "
          f"CPU; results {results[0]} card, {results[1]} CPU; forwards "
          f"{dict(card_run['forwards'])} ({card_run['per_forward']} adapted calls a "
          f"forward); launches {expect}; wall {card_run['seconds']:.2f} s card, "
          f"{cpu_run['seconds']:.2f} s CPU", flush=True)
    return {"launches": expect, "card": card_run, "cpu": cpu_run}


def phase_glue_smoke(card: str) -> dict:
    """(a) The GLUE harness (``scripts/run_glue.py``) as users run it,
    ``task_configs/<family>/<task>.json --smoke=True``: CoLA, STS-B
    (regression), MNLI (matched and mismatched, two TSV files) on RoBERTa,
    MRPC on DeBERTa, then ``run_agnews.py --smoke=True --method=monarch``;
    float32, TF32 off, dropout off, ``GLUE_STEPS`` steps; each on the card
    against the CPU (``encoder_pair``: K2 and K3 only).  Returns the card
    runs' launches."""
    from sparse_matrix_fine_tuning_torch.scripts import run_agnews, run_glue

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = collections.Counter()
    runs = [(label, run_glue, [os.path.join("task_configs", config), "--smoke=True",
                               *GLUE_CUT, *extra], GLUE_STEPS)
            for label, config, extra in GLUE_SMOKE]
    runs.append(("agnews monarch", run_agnews, AGNEWS_SMOKE, AGNEWS_STEPS))
    for label, module, argv, steps in runs:
        out = os.path.join(OUT_DIR, "glue_smoke", label.replace(" ", "_"))
        launches.update(encoder_pair(card, label, module, argv, out, steps=steps)["launches"])
    return dict(launches)


def encoder_shapes(config: dict) -> dict:
    """HF tensor name -> shape of a RoBERTa or DeBERTa-v2 encoder checkpoint
    of ``config`` (no head)."""
    h, inter = config["hidden_size"], config["intermediate_size"]
    deberta = config["model_type"].startswith("deberta")
    top = "deberta" if deberta else "roberta"
    shapes = {f"{top}.embeddings.word_embeddings.weight": (config["vocab_size"], h)}
    if not deberta:
        shapes[f"{top}.embeddings.position_embeddings.weight"] = (
            config["max_position_embeddings"], h)
        shapes[f"{top}.embeddings.token_type_embeddings.weight"] = (config["type_vocab_size"], h)
    shapes.update({f"{top}.embeddings.LayerNorm.weight": (h,),
                   f"{top}.embeddings.LayerNorm.bias": (h,)})
    if deberta:
        shapes.update({f"{top}.encoder.rel_embeddings.weight": (2 * config["position_buckets"], h),
                       f"{top}.encoder.LayerNorm.weight": (h,),
                       f"{top}.encoder.LayerNorm.bias": (h,)})
    projections = ("query_proj", "key_proj", "value_proj") if deberta else ("query", "key",
                                                                            "value")
    for i in range(config["num_hidden_layers"]):
        p = f"{top}.encoder.layer.{i}"
        for name, shape in ([(f"attention.self.{n}", (h, h)) for n in projections]
                            + [("attention.output.dense", (h, h)),
                               ("intermediate.dense", (inter, h)),
                               ("output.dense", (h, inter))]):
            shapes[f"{p}.{name}.weight"] = shape
            shapes[f"{p}.{name}.bias"] = (shape[0],)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes.update({f"{p}.{name}.weight": (h,), f"{p}.{name}.bias": (h,)})
    return shapes


def encoder_port_name(hf_name: str) -> str:
    """The adapted port model's parameter that an HF encoder tensor loads
    into (query/key/value weights: the adapters' frozen ``dense``)."""
    n = hf_name.replace("roberta.encoder.layer.", "roberta.layer.")
    if n.startswith("deberta."):
        for old, new in (("deberta.embeddings.LayerNorm", "deberta.emb_LayerNorm"),
                         ("deberta.embeddings.", "deberta."),
                         ("deberta.encoder.rel_embeddings", "deberta.rel_embeddings"),
                         ("deberta.encoder.LayerNorm", "deberta.rel_LayerNorm"),
                         ("deberta.encoder.layer.", "deberta.layer."),
                         ("attention.self.", "attention_self."),
                         ("attention.output.", "attention_output."),
                         ("intermediate.dense", "intermediate"),
                         (".output.dense", ".output_dense"),
                         (".output.LayerNorm", ".output_LayerNorm")):
            n = n.replace(old, new)
    proj = n.rsplit(".", 2)[-2]
    if proj in ("query", "key", "value", "query_proj", "key_proj", "value_proj") \
            and n.endswith(".weight"):
        n = n[:-len("weight")] + "dense"
    return n


def encoder_kernel_times(card: str, label: str, per_layer: list, dtype=torch.bfloat16) -> dict:
    """K2 and K3 timed (``benchlib.time_ms``) at the GLUE path's own
    projections and rows, ``per_layer`` [(proj, rows, in, out)], against
    their plain versions, the bound and (K2) ``torch.addmm`` on the dense
    equivalent; summed a layer.  Launches made here are not the path's."""
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    recs = {"monarch_add": [], "monarch_bwd": []}
    print(_HEADER, flush=True)
    with torch.no_grad():
        for proj, rows, n_in, n_out in per_layer:
            p, s = n_in // nb, n_out // nb
            x = torch.randn(rows, n_in, generator=g, device="cuda").to(dtype)
            w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
            w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
            base = torch.randn(rows, n_out, generator=g, device="cuda").to(dtype)
            dense = monarch_dense_equivalent(w1.float(), w2.float()).to(dtype)
            cases = {"monarch_add": (lambda: monarch_cuda.monarch_add(base, x, w1, w2),
                                     lambda: monarch_cuda.monarch_add_reference(base, x, w1, w2),
                                     lambda: torch.addmm(base, x, dense.t())),
                     "monarch_bwd": (lambda: monarch_cuda.monarch_bwd(x, w1, w2, base),
                                     lambda: monarch_cuda.monarch_bwd_reference(x, w1, w2, base),
                                     None)}
            for name, (kern, plain, library) in cases.items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
                err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
                share = max(float((a.float() - b.float()).abs().max()) / tolerance(dtype, b)
                            for a, b in pairs)
                require(share <= 1.0, f"{name} {label} {proj} M={rows}: {share:.3f} of tol")
                (ms, call), (plain_ms, plain_call) = time_ms(kern), time_ms(plain)
                lib = time_ms(library)[0] if library is not None else None
                recs[name].append(_record(name, proj, n_in, n_out, rows, dtype, err, share, ms,
                                          plain_ms, call, plain_call, lib))
    layer = {name: _layer_sums(v) for name, v in recs.items()}
    print(f"[glue-full] {card}: {label}: device time a layer at the GLUE path's rows ("
          + ", ".join(f"{proj} {rows}" for proj, rows, _, _ in per_layer) + "): "
          + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, library "
                      f"{v['library_ms'] if v['library_ms'] is None else round(v['library_ms'], 5)}"
                      f", bound {v['bound_ms']:.5f} ms, {v['bound_by']})"
                      for k, v in layer.items()), flush=True)
    RECORDS.append({"glue_kernels_per_layer": label, **{k: v for k, v in layer.items()},
                    "card": card})
    return layer


def phase_glue_full(card: str) -> dict:
    """(b) The GLUE harness at full width in bfloat16: for RoBERTa-large (24
    layers, hidden 1024, 16 heads, FFN 4096, vocab 50265) and DeBERTa-v3-base
    (12 layers, hidden 768, 12 heads, vocab 128100, 256 position buckets), an
    HF-format directory written here (``encoder_shapes``, random seeded
    float32 weights; the tensors the harness's loader gives equal the
    written ones; DeBERTa's deleted after, RoBERTa-large's by
    ``phase_reft_full``, after ``phase_baselines_full`` reuses it), then
    ``run_glue.py <family>/cola.json --bf16_compute=True --max_steps=3`` on
    it with the recipe's batch (16; 32) and max_seq_length 128, length grouping in buckets of 32, dropout
    0.1 in the encoder (the adapters' 0.0: K2, not K1): launches exact
    (``encoder_expect``); the harness's own steps through its trainer's
    ``step_context`` (step 0 profiled: busy; steps 1-2 alone: wall, peak);
    then its eval and its predictions again, each counted and timed alone
    (equal to the harness's); K2 and K3 timed at the run's own rows
    (``encoder_kernel_times``).  Returns the launches of the runs."""
    from sparse_matrix_fine_tuning_torch.scripts import run_glue

    launches = collections.Counter()
    layers = {}
    for label, config, hf_config, dirname in GLUE_FULL:
        ckpt = os.path.join(OUT_DIR, dirname)
        out = os.path.join(OUT_DIR, dirname + "_run")
        for d in (ckpt, out):
            shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        written = write_hf_checkpoint(ckpt, hf_config, encoder_shapes(hf_config), SEED + 40,
                                      torch.float32)
        write_s = time.perf_counter() - t0
        size_gb = os.path.getsize(os.path.join(ckpt, "model.safetensors")) / 1e9
        loaded = {}

        def build_checked(args, data_args, peft_config, num_labels, seed):
            t0 = time.perf_counter()
            model = run_glue.build_model(args, data_args, peft_config, num_labels, seed)
            torch.cuda.synchronize()
            loaded["seconds"] = time.perf_counter() - t0
            params = dict(model.named_parameters())
            for name, t in written.items():
                key = encoder_port_name(name)
                require(params[key].dtype == torch.float32 and torch.equal(params[key], t),
                        f"glue full, {label}: the loaded {key} is not the written {name}")
            loaded["tensors"] = len(written)
            loaded["config"] = model.config
            written.clear()
            return model

        steps = {}
        torch.cuda.reset_peak_memory_stats()
        full = encoder_run(run_glue, [os.path.join("task_configs", config), "--bf16_compute=True",
                                      *GLUE_CUT, f"--model_name_or_path={ckpt}",
                                      f"--output_dir={out}"],
                           build=build_checked,
                           step_context=harness_step_context(steps, f"glue {label}"))
        cfg = loaded["config"]
        require(loaded.get("tensors") == len(encoder_shapes(hf_config))
                and cfg.dtype == "bfloat16" and cfg.num_hidden_layers
                == hf_config["num_hidden_layers"], f"glue full, {label}: loaded {loaded}")
        expect = encoder_expect(full)
        expect_only(full["launches"], expect, f"glue full, {label}")
        require(full["forwards"] == {"train": GLUE_STEPS, "eval": 4},
                f"glue full, {label}: forwards {full['forwards']} (expected {GLUE_STEPS} "
                "training, 2 eval-loss batches, 1 eval prediction and 1 test prediction)")
        launches.update(expect)
        run = full["run"]
        task = next(iter(run.results))
        metrics = run.results[task]
        losses = [r["loss"] for r in _alpaca_records(out, task=task) if "loss" in r]
        require(len(losses) == GLUE_STEPS and all(map(math.isfinite, losses))
                and math.isfinite(metrics["eval_loss"]), f"glue full, {label}: {losses}, "
                f"{metrics}")
        require(len(steps.get("wall_ms", [])) == GLUE_STEPS - 1 and "busy_ms" in steps,
                f"glue full, {label}: the harness's steps seen {steps}")
        timed_evals = {}
        for what in ("eval", "predict"):
            before = full["forwards"]["eval"]
            torch.cuda.synchronize()
            reset_counts()  # the counted main path starts here
            t0 = time.perf_counter()
            if what == "eval":
                got = run.trainer.evaluate()
            else:
                got = run_glue.predict_tsv(run.trainer.model, run.data["test"], task,
                                           os.path.join(out, "timed_predict"))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got_launches = counts()  # the counted main path ends here
            n = full["forwards"]["eval"] - before
            want = {"monarch_add": full["per_forward"] * n}
            expect_only(got_launches, want, f"glue full, {label}, timed {what}")
            launches.update(want)
            timed_evals[what] = (seconds, n)
            if what == "eval":
                require(abs(got["eval_loss"] - metrics["eval_loss"]) <= 1e-3 * abs(
                    metrics["eval_loss"]), f"glue full, {label}: eval {got} against the "
                    f"harness's {metrics}")
            else:
                harness_tsv = open(run.tsv_paths[0]).read()
                require(open(got).read() == harness_tsv,
                        f"glue full, {label}: the timed predictions differ from the harness's")
        (b, t), _ = max(full["shapes"].items(), key=lambda kv: kv[1])  # the commonest
        h = hf_config["hidden_size"]
        per_layer = [(p, b * t, h, h) for p in ("q", "k", "v")]
        if hf_config["model_type"].startswith("deberta"):
            span2 = 2 * hf_config["position_buckets"]
            per_layer += [("pos_q", span2, h, h), ("pos_k", span2, h, h)]
        layers[label] = encoder_kernel_times(card, label, per_layer)
        wall = statistics.median(steps["wall_ms"])
        busy = steps["busy_ms"]
        idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
        a = run.trainer.args
        RECORDS.append({"glue_full": label, "steps_wall_ms": steps["wall_ms"],
                        "step0_busy_ms": busy, "eval_s": timed_evals["eval"][0],
                        "predict_s": timed_evals["predict"][0], "peak_gb": steps["peak_gb"],
                        "train_shapes": {str(k): v for k, v in full["shapes"].items()},
                        "card": card})
        print(f"[glue-full] {card}: {label} from an HF-format directory, "
              f"{cfg.num_hidden_layers} layers, hidden {h}, bf16 compute, float32 parameters: "
              f"checkpoint {size_gb:.2f} GB written in {write_s:.2f} s, loaded and adapted in "
              f"{loaded['seconds']:.2f} s, its {loaded['tensors']} tensors equal the written "
              f"ones; cola recipe, bs {a.per_device_train_batch_size}, training shapes "
              f"{full['shapes']}; losses {losses}; steps 1-{GLUE_STEPS - 1} wall "
              f"{[round(w, 2) for w in steps['wall_ms']]} ms (median {wall:.2f}), step 0 device "
              f"busy {busy if busy is None else round(busy, 2)} ms (profiled; wall "
              f"{steps['profiled_wall_ms']:.2f} ms with the profiler on), idle share {idle} "
              f"(1 - busy / median wall), peak {steps['peak_gb']:.2f} GB over step "
              f"{GLUE_STEPS - 1} ({steps['peak_before_gb']:.2f} GB before it); results "
              f"{run.results}; eval {timed_evals['eval'][0]:.3f} s over "
              f"{timed_evals['eval'][1]} forwards, predict {timed_evals['predict'][0]:.3f} s over "
              f"{timed_evals['predict'][1]} (each wall, alone); harness run "
              f"{full['seconds']:.2f} s wall; {full['per_forward']} adapted calls a forward; "
              f"launches {expect}", flush=True)
        del full, run
        if label != BASELINE_FULL_MODEL:  # phase_baselines_full and phase_reft_full read it
            shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": dict(launches), "layer": layers,
            "checkpoint": os.path.join(OUT_DIR, dict((g[0], g[3]) for g in GLUE_FULL)[
                BASELINE_FULL_MODEL])}


class _Tee:
    """A stream that writes through to ``out`` and keeps what it wrote."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, text: str) -> int:
        self.text.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


def reference_orientation_on_card(card: str) -> dict:
    """The reference orientation with svd_init on weights on the card, at
    RoBERTa-large's width (1024, nblocks 4): its residual comes from the
    identity's product, K1, one launch a layer; the residual and the layer's
    output against the same layer built on the CPU (the SVD's signs do not
    reach either), within ``SVD_CARD_RTOL`` of their scale: two float32
    SVDs, cuSOLVER's and LAPACK's, agree to about 1e-4 of the weights'
    scale (1.3e-4 in the first run).  Returns the launches."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator().manual_seed(SEED + 50)
    w = torch.randn(1024, 1024, generator=g) / 32
    x = torch.randn(64, 1024, generator=g)
    peft = {**PEFT, "reference_orientation": True, "svd_init": True}
    cpu = MonarchLinear(1024, 1024, peft_config=peft, weights=w)
    torch.cuda.synchronize()
    reset_counts()  # the counted main path starts here
    layer = MonarchLinear(1024, 1024, peft_config=peft, weights=w.cuda())
    torch.cuda.synchronize()
    launches = counts()  # ... and ends here
    expect_only(launches, {"monarch_kernel": 1}, "reference orientation on the card, init")
    err = float((layer.dense.cpu() - cpu.dense).abs().max())
    with torch.no_grad():
        out_err = float((layer(x.cuda()).cpu() - cpu(x)).abs().max())
        scale = float(cpu(x).abs().max())
    require(err <= SVD_CARD_RTOL * float(w.abs().max())
            and out_err <= SVD_CARD_RTOL * scale,
            f"reference orientation on the card: residual {err}, output {out_err} from the CPU's")
    print(f"[baselines] {card}: reference orientation with svd_init at 1024 -> 1024 on the "
          f"card: K1 once (the identity's product), residual max |card - CPU| {err:.2e}, "
          f"output {out_err:.2e} (scale {scale:.3f})", flush=True)
    return {"monarch_kernel": 1}


def phase_baselines_smoke(card: str) -> dict:
    """(a) The paper's baselines, SVD projection and the search through the
    harnesses, smoke, float32, TF32 off, dropout off (BOFT's too), on the
    card against the CPU (``encoder_pair``, ``alpaca_pair``): ``run_glue``
    with ``--lora`` and ``--boft`` (no kernel of ours: launches none),
    ``--svd_init=True`` (K2, K3) and ``--adapter=False`` (projection: K1,
    K3) on CoLA and STS-B and DeBERTa's MRPC (``BASELINE_SMOKE``); the
    reference orientation with svd_init from a peft config written beside a
    copy of the CoLA recipe (K2, K3: the identity's product runs on the CPU,
    where the smoke model is built); ``--do_tune`` on STS-B
    (``BASELINE_TUNE``): the same trials, budgets and best hyperparameters,
    the metrics within the harness's tolerances, every trial's metric finite
    and no "[hpo] trial ... failed" printed (a failed trial scores worst
    and the search goes on), K2/K3 exact over all its trials; ``run_agnews
    --method lora``; ``run_alpaca --adapter=lora``; then
    ``reference_orientation_on_card``.  Returns the card runs' launches."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
    from sparse_matrix_fine_tuning_torch.scripts import run_agnews, run_glue

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = collections.Counter()
    base = os.path.join(OUT_DIR, "baselines_smoke")
    ref_cfg = os.path.join(base, "reference_orientation_recipe")
    os.makedirs(ref_cfg, exist_ok=True)
    shutil.copy(os.path.join("task_configs", "monarch_roberta_glue", "cola.json"), ref_cfg)
    with open(os.path.join("task_configs", "monarch_roberta_glue", "peft_config.json")) as f:
        peft = {**json.load(f), "reference_orientation": True, "svd_init": True}
    with open(os.path.join(ref_cfg, "peft_config.json"), "w") as f:
        json.dump(peft, f)
    runs = [(label, os.path.join("task_configs", config), [*GLUE_CUT, *extra], forward,
             GLUE_STEPS) for label, config, extra, forward in BASELINE_SMOKE]
    runs.append(("roberta reference_orientation cola", os.path.join(ref_cfg, "cola.json"),
                 [*GLUE_CUT, *GLUE_FAST], "monarch_add", GLUE_STEPS))
    runs.append(("roberta do_tune stsb", os.path.join("task_configs", "monarch_roberta_glue",
                                                      "stsb.json"),
                 BASELINE_TUNE, "monarch_add", None))
    for label, config, extra, forward, steps in runs:
        out = os.path.join(base, label.replace(" ", "_"))
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            pair = encoder_pair(card, label, run_glue, [config, "--smoke=True", *extra], out,
                                forward, steps)
        launches.update(pair["launches"])
        model = pair["card"]["run"].trainer.model
        if "svd_init" in label or "reference" in label:
            require(all(m.svd_init and m.dense is not None for m in model.modules()
                        if isinstance(m, MonarchLinear)), f"{label}: not svd_init")
        if "do_tune" not in label:
            continue
        searches = [pair[k]["run"].search for k in ("card", "cpu")]
        failed = [line for line in "".join(tee.text).splitlines()
                  if line.startswith("[hpo] trial") and "failed" in line]
        trials = [[(t["id"], t["hp"], t["epochs"]) for t in s["trials"]] for s in searches]
        metrics = [[t["eval_pearson"] for t in s["trials"]] for s in searches]
        require(not failed and trials[0] == trials[1]
                and [t[2] for t in trials[0]] == BASELINE_TUNE_EPOCHS
                and all(map(math.isfinite, metrics[0] + metrics[1]))
                and all(abs(a - b) <= GLUE_CORRELATION_ATOL for a, b in zip(*metrics))
                and searches[0]["best_hyperparams"] == searches[1]["best_hyperparams"],
                f"{label}: trials {trials}, metrics {metrics}, failed {failed}, best "
                f"{[s['best_hyperparams'] for s in searches]}")
        brief = [(t[0], t[1]["learning_rate"], t[1]["per_device_train_batch_size"], t[2])
                 for t in trials[0]]
        print(f"[baselines] {card}: search, STS-B: trials (id, lr, batch, epochs) {brief}; "
              f"pearson {[round(m, 6) for m in metrics[0]]} card, "
              f"{[round(m, 6) for m in metrics[1]]} CPU; best {searches[0]['best_hyperparams']} "
              f"(pearson {searches[0]['best_metric']:.6f}); no trial failed", flush=True)
    lora_news = [a for a in AGNEWS_SMOKE if not a.startswith("--method")] + ["--method=lora"]
    launches.update(encoder_pair(card, "agnews lora", run_agnews, lora_news,
                                 os.path.join(base, "agnews_lora"), None,
                                 AGNEWS_STEPS)["launches"])
    launches.update(alpaca_pair(card, "f32 base, LoRA", [*ALPACA_ARGV, "--adapter=lora"],
                                os.path.join(base, "alpaca_lora"), lambda run: {}))
    launches.update(reference_orientation_on_card(card))
    return dict(launches)


def projection_kernel_times(card: str, rows: int, dtype=torch.bfloat16) -> dict:
    """K1 and K3 timed (``benchlib.time_ms``) at projection mode's
    RoBERTa-large shape, w1 and w2 (32, 32, 32) on ``rows`` rows of 1024,
    against their plain versions, the bound and (K1) ``F.linear`` on the
    dense equivalent; a layer's three projections (query, key and value, of
    one shape) are three times one call's.  K3 runs its generic kernel
    here, tens of ms a call: it is timed over ``PROJECTION_BWD_REPS``.
    Launches made here are not the path's."""
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent

    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    nb = r = 32
    n = nb * nb
    layer = {}
    print(_HEADER, flush=True)
    with torch.no_grad():
        x = torch.randn(rows, n, generator=g, device="cuda").to(dtype)
        w1 = (torch.randn(nb, r, nb, generator=g, device="cuda") / nb ** 0.5).to(dtype)
        w2 = (torch.randn(nb, nb, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
        dout = torch.randn(rows, n, generator=g, device="cuda").to(dtype)
        dense = monarch_dense_equivalent(w1.float(), w2.float()).to(dtype)
        cases = {"monarch_kernel": (lambda: monarch_cuda.monarch_kernel(x, w1, w2),
                                    lambda: monarch_cuda.monarch_kernel_reference(x, w1, w2),
                                    lambda: torch.nn.functional.linear(x, dense), ()),
                 "monarch_bwd": (lambda: monarch_cuda.monarch_bwd(x, w1, w2, dout),
                                 lambda: monarch_cuda.monarch_bwd_reference(x, w1, w2, dout),
                                 None, PROJECTION_BWD_REPS)}
        for name, (kern, plain, library, reps) in cases.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
            err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
            share = max(float((a.float() - b.float()).abs().max()) / tolerance(dtype, b)
                        for a, b in pairs)
            require(share <= 1.0, f"{name} projection M={rows}: {share:.3f} of tol")
            (ms, call), (plain_ms, plain_call) = time_ms(kern, *reps), time_ms(plain, *reps)
            lib = time_ms(library)[0] if library is not None else None
            rec = _record(name, "qkv", n, n, rows, dtype, err, share, ms, plain_ms, call,
                          plain_call, lib, r)
            layer[name] = {"ms": 3 * ms, "plain_ms": 3 * plain_ms, "bound_ms": 3 * rec["bound_ms"],
                           "bound_by": rec["bound_by"],
                           "library_ms": None if lib is None else 3 * lib}
    print(f"[baselines-full] {card}: projection mode, 32 blocks of 32: device time a layer (3 "
          f"calls) at {rows} rows: "
          + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, library "
                      f"{v['library_ms'] if v['library_ms'] is None else round(v['library_ms'], 5)}"
                      f", bound {v['bound_ms']:.5f} ms, {v['bound_by']})"
                      for k, v in layer.items()), flush=True)
    RECORDS.append({"projection_kernels_per_layer": rows, **layer, "card": card})
    return layer


def phase_baselines_full(card: str, checkpoint: str) -> dict:
    """(b) The recipes of the paper's GLUE table at RoBERTa-large width (24
    layers, hidden 1024) from ``phase_glue_full``'s HF-format directory
    (``phase_reft_full`` reads it next and deletes it), bf16 compute,
    ``GLUE_STEPS`` steps each with the harness's eval and test predictions (``BASELINE_FULL``):
    ``lora_roberta_glue/cola.json`` (bs 16, r 8, alpha 16, gaussian, q/k/v),
    ``boft_roberta_glue/cola.json`` (bs 32, seq 64, block 8, 2 butterfly
    factors, dropout 0.05, bias boft_only) and the Monarch CoLA recipe with
    ``--svd_init=True`` (the residual as base: K2 72 times a forward, K3 72
    times a step) and with ``--adapter=False`` (projection, 32 blocks of
    32: K1 72 times a forward, K3 72 times a step, on its generic kernel).
    Launches exact (none of ours for LoRA and BOFT); the adapters' shapes;
    each run's init s (``adapt_model``: the SVD on the card for the
    projections), its steps through the trainer's ``step_context`` (step 0
    profiled: busy; steps 1-2 alone: wall, peak), idle share; K1 and K3
    timed at projection mode's rows (``projection_kernel_times``).  Returns
    the launches and those times."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
    from sparse_matrix_fine_tuning_torch.peft.boft import BOFTLinear
    from sparse_matrix_fine_tuning_torch.peft.surgery import ScaledLoRA
    from sparse_matrix_fine_tuning_torch.scripts import run_glue

    launches = collections.Counter()
    real_adapt = run_glue.adapt_model
    init_s = []

    def timed_adapt(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = real_adapt(*a, **kw)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
        return model

    kinds = {"LoRA": ScaledLoRA, "BOFT": BOFTLinear}
    layer_times = None
    try:
        run_glue.adapt_model = timed_adapt
        for label, config, extra, forward in BASELINE_FULL:
            out = os.path.join(OUT_DIR, "baselines_full_" + label.replace(" ", "_"))
            shutil.rmtree(out, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            init_s.clear()
            steps = {}
            full = encoder_run(run_glue, [os.path.join("task_configs", config),
                                          "--bf16_compute=True", *GLUE_CUT,
                                          f"--model_name_or_path={checkpoint}",
                                          f"--output_dir={out}", *extra],
                               step_context=harness_step_context(steps, f"glue {label}"))
            expect = encoder_expect(full, forward)
            expect_only(full["launches"], expect, f"baselines full, {label}")
            launches.update(expect)
            run = full["run"]
            model = run.trainer.model
            layers = [m for m in model.modules()
                      if isinstance(m, kinds.get(label, MonarchLinear))]
            require(len(layers) == full["per_forward"] == 72 and len(init_s) == 1,
                    f"baselines full, {label}: {len(layers)} adapted layers, inits {init_s}")
            shapes = {tuple(layers[0].blkdiag1.shape), tuple(layers[0].blkdiag2.shape)} \
                if forward else None
            if label == "Monarch projection":
                require(shapes == {(32, 32, 32)} and all(m.dense is None for m in layers),
                        f"baselines full, projection: factors {shapes}")
            elif label == "Monarch svd_init":
                require(shapes == {(4, 4, 256), (4, 256, 4)}
                        and all(m.dense is not None for m in layers),
                        f"baselines full, svd_init: factors {shapes}")
            task = next(iter(run.results))
            metrics = run.results[task]
            losses = [r["loss"] for r in _alpaca_records(out, task=task) if "loss" in r]
            require(full["forwards"]["train"] == GLUE_STEPS and len(losses) == GLUE_STEPS
                    and all(map(math.isfinite, losses)) and math.isfinite(metrics["eval_loss"])
                    and len(run.tsv_paths) == 1,
                    f"baselines full, {label}: forwards {full['forwards']}, losses {losses}, "
                    f"{metrics}")
            require(len(steps.get("wall_ms", [])) == GLUE_STEPS - 1 and "busy_ms" in steps,
                    f"baselines full, {label}: the harness's steps seen {steps}")
            wall = statistics.median(steps["wall_ms"])
            busy = steps["busy_ms"]
            idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
            a = run.trainer.args
            RECORDS.append({"baselines_full": label, "init_s": init_s[0],
                            "steps_wall_ms": steps["wall_ms"], "step0_busy_ms": busy,
                            "peak_gb": steps["peak_gb"], "launches": expect,
                            "train_shapes": {str(k): v for k, v in full["shapes"].items()},
                            "card": card})
            print(f"[baselines-full] {card}: {label}, {config}, {BASELINE_FULL_MODEL} (24 "
                  f"layers, hidden 1024) from the HF-format directory, bf16 compute: init "
                  f"{init_s[0]:.3f} s (adapters on 72 linears"
                  f"{', factors ' + str(shapes) if shapes else ''}); bs "
                  f"{a.per_device_train_batch_size}, training shapes {full['shapes']}; "
                  f"losses {losses}; steps 1-{GLUE_STEPS - 1} wall "
                  f"{[round(w, 2) for w in steps['wall_ms']]} ms (median {wall:.2f}), step 0 "
                  f"device busy {busy if busy is None else round(busy, 2)} ms (profiled; wall "
                  f"{steps['profiled_wall_ms']:.2f} ms with the profiler on), idle share {idle}, "
                  f"peak {steps['peak_gb']:.2f} GB over step {GLUE_STEPS - 1}; results "
                  f"{run.results}; forwards {dict(full['forwards'])}; harness run "
                  f"{full['seconds']:.2f} s wall; launches {expect}", flush=True)
            if label == "Monarch projection":
                (b, t), _ = max(full["shapes"].items(), key=lambda kv: kv[1])  # the commonest
                layer_times = projection_kernel_times(card, b * t)
            del full, run, model, layers
    finally:
        run_glue.adapt_model = real_adapt
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": dict(launches), "layer": layer_times}


def _ms(value):
    """A profiled ms rounded to 2 places, or None where nothing was measured."""
    return None if value is None else round(value, 2)


def _zeroed_interventions(model):
    """A CPU copy of a ReftModel with its interventions' parameters zeroed."""
    fresh = copy.deepcopy(model).cpu()
    with torch.no_grad():
        for p in fresh.interventions.parameters():
            p.zero_()
    return fresh


def _same_state(got, want, what: str) -> None:
    got, want = got.state_dict(), want.state_dict()
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    require(got.keys() == want.keys() and not bad, f"{what}: differs at {bad[:4]}")


def reft_checkpoints(card: str, model) -> None:
    """The card-trained ReftModel through the three checkpoint formats into
    zeroed CPU copies, each equal to it bit for bit afterwards:
    ``save_interventions``/``load_interventions`` (npz), the pyvene
    ``intkey_*.bin`` files, and the reference-format adapter dict of its
    base (``peft/import_reference``, ``.bin``)."""
    from sparse_matrix_fine_tuning_torch.interventions import (
        load_pyvene_interventions,
        save_pyvene_interventions,
    )
    from sparse_matrix_fine_tuning_torch.peft.import_reference import (
        load_reference_adapters,
        save_reference_adapters,
    )

    base = os.path.join(OUT_DIR, "reft_checkpoints")
    shutil.rmtree(base, ignore_errors=True)
    fresh = _zeroed_interventions(model)
    model.save_interventions(os.path.join(base, "npz"))
    fresh.load_interventions(os.path.join(base, "npz"))
    _same_state(fresh.interventions, model.interventions, "interventions.npz")
    fresh = _zeroed_interventions(model)
    files = save_pyvene_interventions(model, os.path.join(base, "pyvene"))
    loaded, skipped = load_pyvene_interventions(fresh, os.path.join(base, "pyvene"))
    require(loaded == files and not skipped, f"pyvene files {files}: loaded {loaded}")
    _same_state(fresh.interventions, model.interventions, "pyvene files")
    fresh = copy.deepcopy(model.model).cpu()
    with torch.no_grad():
        for p in fresh.parameters():
            if p.requires_grad:
                p.zero_()
    save_reference_adapters(model.model, os.path.join(base, "adapters.bin"))
    keys, skipped = load_reference_adapters(fresh, os.path.join(base, "adapters.bin"))
    _same_state(fresh, model.model, "reference adapters")
    print(f"[reft] {card}: checkpoints of the card-trained model: interventions.npz, "
          f"{len(files)} pyvene files, {len(keys)} reference adapter keys ({skipped} skipped) "
          "each loaded into a zeroed CPU copy, equal bit for bit", flush=True)


def glue_reft_run(argv: list, *, dropout: bool = True, step_context=None) -> dict:
    """One MoReFT GLUE ``run_reasoning.run`` with the launch counts zeroed
    just before it and read just after, the wall seconds beside them;
    ``dropout=False`` sets every ``nn.Dropout`` of the built model to 0 (the
    card's masks are not the CPU's)."""
    from sparse_matrix_fine_tuning_torch.scripts import run_reasoning

    def build(*a):
        model = run_reasoning.build_glue_model(*a)
        if not dropout:
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
        return model

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    reset_counts()  # the counted main path starts here
    t0 = time.perf_counter()
    result = run_reasoning.run(argv, build=build, step_context=step_context)
    seconds = time.perf_counter() - t0
    launches = counts()  # the counted main path ends here
    return {"run": result, "launches": launches, "seconds": seconds}


def phase_reft_smoke(card: str) -> dict:
    """(a) ReFT through the reasoning harness on the tiny smoke Llama in
    float32, TF32 off, on the card and on the CPU: ``REFT_SMOKE``'s
    interventions (Loreft untied f7+l7, Noreft, Consreft, MoRe) over the
    Monarch adapters, ``-task math`` on one eval dataset: losses within
    ``ALPACA_TOL``, results and generations equal, launches exact (K2 on
    every adapted linear each forward, K3 each training micro-batch; none on
    the CPU); Loreft's beam-4 eval (intervened beams) equal too, and its
    card-trained model through the three checkpoint formats
    (``reft_checkpoints``).  MoReFT GLUE on the tiny RoBERTa
    (``MOREFT_GLUE_SMOKE``): losses within ``ALPACA_TOL``, metrics and
    ``metrics.json`` equal, no launch.  DAS (``scripts/das_demo.py``, cut
    to ``DAS_STEPS``): accuracies equal, losses within ``DAS_RTOL``, no
    launch.  Returns the launches."""
    from sparse_matrix_fine_tuning_torch.scripts import das_demo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = ALPACA_TOL
    adapted = 7 * 2
    launches = collections.Counter()
    for label, extra, n_iv in REFT_SMOKE:
        out = os.path.join(OUT_DIR, "reft_" + label.split()[0].lower())
        for d in (out, f"{out}_cpu"):
            shutil.rmtree(d, ignore_errors=True)
        runs = {}
        for where, d in (("card", out), ("cpu", f"{out}_cpu")):
            argv = [*REFT_SMOKE_ARGV, *extra, f"--output_dir={d}"]
            runs[where] = reasoning_run(argv + (["--platform=cpu"] if where == "cpu" else []))
        card_run, cpu_run = runs["card"], runs["cpu"]
        model = card_run["run"].trainer.model
        micro = card_run["train_forwards"]
        require(micro == REASONING_STEPS * REASONING_GA and len(model.interventions) == n_iv,
                f"reft {label}: {micro} training forwards, {len(model.interventions)} "
                "interventions")
        expect = alpaca_expect(16, adapted, micro + card_run["eval_forwards"], micro,
                               "monarch_add")
        expect_only(card_run["launches"], expect, f"reft {label}")
        require(not any(cpu_run["launches"].values()),
                f"reft {label}: the CPU run launched {cpu_run['launches']}")
        launches.update(expect)
        losses = [[r["loss"] for r in _alpaca_records(d, "metrics.jsonl", "math") if "loss" in r]
                  for d in (out, f"{out}_cpu")]
        require(len(losses[0]) == len(losses[1]) == REASONING_STEPS
                and all(_close(a, b, tol) for a, b in zip(*losses)),
                f"reft {label}: losses {losses[0]} card, {losses[1]} CPU")
        gens = [_generations(os.path.join(d, "math")) for d in (out, f"{out}_cpu")]
        results = [r["run"].results for r in (card_run, cpu_run)]
        require(gens[0] == gens[1] and len(gens[0]) > 0 and results[0] == results[1],
                f"reft {label}: results {results}, generations equal "
                f"{sum(a == b for a, b in zip(*gens))}/{len(gens[0])}")
        beam = ""
        if n_iv == 4:
            ev = counted_eval(card_run, "beam-4", greedy=False, out=os.path.join(out, "beam"))
            expect = {"monarch_add": adapted * ev["forwards"]}
            expect_only(ev["launches"], expect, f"reft {label}, beam-4 eval")
            launches.update(expect)
            want = cpu_run["run"].evaluate(greedy=False, out=os.path.join(f"{out}_cpu", "beam"))
            beams = [_generations(os.path.join(d, "beam")) for d in (out, f"{out}_cpu")]
            require(beams[0] == beams[1] and ev["results"] == want,
                    f"reft {label}, beam-4: results {ev['results']} card, {want} CPU")
            beam = (f"; beam-4 eval equal ({ev['forwards']} forwards, {ev['seconds']:.2f} s, "
                    f"launches {expect})")
        print(f"[reft] {card}: smoke, {label} ({n_iv} interventions): losses {losses[0]} card, "
              f"{losses[1]} CPU (tol {tol}); results {results[0]} on both; generations equal "
              f"({len(gens[0])}); launches "
              f"{ {k: v for k, v in card_run['launches'].items() if v} }{beam}; wall "
              f"{card_run['seconds']:.2f} s card, {cpu_run['seconds']:.2f} s CPU", flush=True)
        if n_iv == 4:
            reft_checkpoints(card, model)
        del runs, card_run, cpu_run, model

    out = os.path.join(OUT_DIR, "reft_glue")
    runs = {}
    for where, d in (("card", out), ("cpu", f"{out}_cpu")):
        shutil.rmtree(d, ignore_errors=True)
        argv = [*MOREFT_GLUE_SMOKE, f"--output_dir={d}"]
        runs[where] = glue_reft_run(argv + (["--platform=cpu"] if where == "cpu" else []),
                                    dropout=False)
    expect_only(runs["card"]["launches"], {}, "MoReFT GLUE smoke")
    losses = [[r["loss"] for r in runs[w]["run"].trainer.log_history if "loss" in r]
              for w in ("card", "cpu")]
    metrics = [runs[w]["run"].results for w in ("card", "cpu")]
    files = []
    for d in (out, f"{out}_cpu"):
        with open(os.path.join(d, "glue_cola", "metrics.json")) as f:
            files.append(json.load(f))
    require(len(losses[0]) == len(losses[1]) == 3 and all(_close(a, b, tol)
                                                         for a, b in zip(*losses))
            and metrics[0] == metrics[1] == files[0] == files[1] and metrics[0],
            f"MoReFT GLUE smoke: losses {losses}, metrics {metrics}, files {files}")
    print(f"[reft] {card}: smoke, MoReFT GLUE (tiny RoBERTa, CoLA, MoRe rank 1 f1 on "
          f"{len(runs['card']['run'].trainer.model.interventions)} layers, --allow_cls_grad): "
          f"losses {losses[0]} card, {losses[1]} CPU; metrics {metrics[0]} on both, "
          f"metrics.json equal; no launch; wall {runs['card']['seconds']:.2f} s card, "
          f"{runs['cpu']['seconds']:.2f} s CPU", flush=True)

    das = {}
    for where in ("cuda", "cpu"):
        reset_counts()  # the counted main path starts here
        das[where] = das_demo.main(["--platform", where], train_steps=DAS_STEPS[0],
                                   das_steps=DAS_STEPS[1])
        if where == "cuda":
            expect_only(counts(), {}, "DAS")  # the counted main path ends here
    got, want = das["cuda"], das["cpu"]
    require([got[k] for k in ("base_accuracy", "before", "after")]
            == [want[k] for k in ("base_accuracy", "before", "after")]
            and all(abs(a - b) <= DAS_RTOL * abs(b) for a, b in zip(got["losses"],
                                                                 want["losses"])),
            f"DAS: card {got}, CPU {want}")
    print(f"[reft] {card}: smoke, DAS (toy MLP, {DAS_STEPS[0]} training and {DAS_STEPS[1]} DAS "
          f"steps): base accuracy {got['base_accuracy']:.3f}, interchange accuracy "
          f"{got['before']:.3f} -> {got['after']:.3f} on both; losses "
          f"{got['losses'][0]:.4f} -> {got['losses'][-1]:.4f} card, {want['losses'][0]:.4f} -> "
          f"{want['losses'][-1]:.4f} CPU (rtol {DAS_RTOL}); no launch", flush=True)
    return dict(launches)


def phase_reft_full(card: str, llama_checkpoint: str, roberta_checkpoint: str) -> dict:
    """(b) ReFT at full width, the two HF-format directories of
    ``phase_reasoning_full`` and ``phase_glue_full`` read and then deleted:
    the LoReFT paper's commonsense recipe (``REFT_FULL_ARGV``: Loreft rank 8,
    f7+l7 tied, on all 22 layers of the TinyLlama-1.1B-wide model in bf16
    with the harness's remat "nothing", dropout 0: K2 twice an adapted
    linear and micro-batch, K3 once) for ``REFT_FULL_STEPS`` steps at batch
    4 x ga 4 x max length 512 with its greedy eval, then a greedy and a
    beam-4 eval of the trained model (wall a forward) and both again at
    ``REASONING_PROFILE_NEW`` tokens under the profiler (busy a forward);
    then moreft_glue.sh's recipe at RoBERTa-large width
    (``MOREFT_GLUE_FULL_ARGV``, float32, MoRe rank 1 at every layer, dropout
    0.05 on the interventions, the classifier trained) for
    ``REFT_FULL_STEPS`` steps and its eval: no kernel of ours.  Each run's
    steps through the trainer's ``step_context`` (step 0 profiled: busy;
    the later ones alone: wall, peak).  Launches exact.  Returns the
    launches."""
    launches = collections.Counter()
    try:
        out = os.path.join(OUT_DIR, "reft_full")
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        steps = {}
        torch.cuda.reset_peak_memory_stats()
        full = reasoning_run([*REFT_FULL_ARGV, "--model", llama_checkpoint,
                              f"--output_dir={out}"],
                             step_context=harness_step_context(steps, "ReFT (1.1B)"))
        model = full["run"].trainer.model
        micro = full["train_forwards"]
        require(micro == REFT_FULL_STEPS * 4 and len(model.interventions) == 22
                and model.config.remat, f"reft full: {micro} training forwards, "
                f"{len(model.interventions)} interventions")
        expect = {"monarch_add": N_ADAPTED * (2 * micro + full["eval_forwards"]),
                  "monarch_bwd": N_ADAPTED * micro}
        expect_only(full["launches"], expect, "reft full, training and greedy eval")
        launches.update(expect)
        losses = [r["loss"] for r in _alpaca_records(out, "metrics.jsonl", "commonsense")
                  if "loss" in r]
        require(len(losses) == REFT_FULL_STEPS and all(map(math.isfinite, losses))
                and len(steps.get("wall_ms", [])) == REFT_FULL_STEPS - 1 and "busy_ms" in steps,
                f"reft full: losses {losses}, steps {steps}")
        evals, busy = {}, {}
        for label, greedy in (("greedy", True), ("beam-4", False)):
            evals[label] = counted_eval(full, label, greedy=greedy, out=os.path.join(out, label))
            expect = {"monarch_add": N_ADAPTED * evals[label]["forwards"]}
            expect_only(evals[label]["launches"], expect, f"reft full, {label} eval")
            launches.update(expect)
        require(evals["greedy"]["results"] == full["run"].results,
                f"reft full: greedy eval {evals['greedy']['results']}, the harness's "
                f"{full['run'].results}")
        for label, greedy in (("greedy", True), ("beam-4", False)):
            before = full["forwards"]["eval"]
            with device_busy(f"ReFT {label} eval, {REASONING_PROFILE_NEW} new tokens") as prof:
                full["run"].evaluate(greedy=greedy, max_new=REASONING_PROFILE_NEW,
                                     out=os.path.join(out, f"profiled_{label}"))
            busy[label] = (prof["busy_ms"], full["forwards"]["eval"] - before)
        wall = statistics.median(steps["wall_ms"])
        idle = f"{1 - steps['busy_ms'] / wall:.3f}" if steps["busy_ms"] else "not measured"
        evals_line = "; ".join(
            f"{label} eval {e['seconds']:.2f} s over {e['forwards']} forwards "
            f"({e['seconds'] * 1e3 / e['forwards']:.2f} ms a forward, the prefill included), "
            + (f"busy {busy[label][0] / busy[label][1]:.3f} ms a forward (profiled, "
               f"{busy[label][1]} forwards)" if busy[label][0] else "busy not measured")
            for label, e in evals.items())
        RECORDS.append({"reft_full": "commonsense Loreft", "steps_wall_ms": steps["wall_ms"],
                        "step0_busy_ms": steps["busy_ms"], "peak_gb": steps["peak_gb"],
                        **{f"{label}_s": e["seconds"] for label, e in evals.items()},
                        **{f"{label}_forwards": e["forwards"] for label, e in evals.items()},
                        "busy": busy, "card": card})
        print(f"[reft-full] {card}: TinyLlama-1.1B widths (22 layers, bf16, remat \"nothing\"),"
              f" Loreft rank 8 f7+l7 tied on every layer over the Monarch adapters, dropout 0, "
              f"commonsense, bs 4 x ga 4 x 512: losses {losses}; steps 1-{REFT_FULL_STEPS - 1} "
              f"wall {[round(w, 2) for w in steps['wall_ms']]} ms (median {wall:.2f}), step 0 "
              f"device busy {_ms(steps['busy_ms'])} ms (profiled; wall "
              f"{steps['profiled_wall_ms']:.2f} ms with the profiler on), "
              f"idle share {idle}, peak {steps['peak_gb']:.2f} GB over step "
              f"{REFT_FULL_STEPS - 1}; the harness's greedy eval {full['eval_forwards']} "
              f"forwards; then {evals_line}; results greedy {full['run'].results}, beam-4 "
              f"{evals['beam-4']['results']}; harness run {full['seconds']:.2f} s wall; "
              f"launches {dict(launches)}", flush=True)
        del full, model, evals
        shutil.rmtree(llama_checkpoint, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        out = os.path.join(OUT_DIR, "reft_glue_full")
        shutil.rmtree(out, ignore_errors=True)
        steps = {}
        torch.cuda.reset_peak_memory_stats()
        glue = glue_reft_run([*MOREFT_GLUE_FULL_ARGV, "--model", roberta_checkpoint,
                              f"--output_dir={out}"],
                             step_context=harness_step_context(steps, "MoReFT GLUE (large)"))
        expect_only(glue["launches"], {}, "MoReFT GLUE, RoBERTa-large")
        run = glue["run"]
        model = run.trainer.model
        losses = [r["loss"] for r in run.trainer.log_history if "loss" in r]
        require(len(model.interventions) == 24 and len(losses) == REFT_FULL_STEPS
                and all(map(math.isfinite, losses)) and run.results
                and all(map(math.isfinite, run.results.values()))
                and len(steps.get("wall_ms", [])) == REFT_FULL_STEPS - 1 and "busy_ms" in steps,
                f"MoReFT GLUE large: {len(model.interventions)} interventions, losses {losses}, "
                f"results {run.results}, steps {steps}")
        torch.cuda.synchronize()
        reset_counts()  # the counted main path starts here
        t0 = time.perf_counter()
        again = run.evaluate()
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        expect_only(counts(), {}, "MoReFT GLUE, RoBERTa-large eval")  # the path ends here
        require(again == run.results, f"MoReFT GLUE large: eval {again}, run {run.results}")
        wall = statistics.median(steps["wall_ms"])
        idle = f"{1 - steps['busy_ms'] / wall:.3f}" if steps["busy_ms"] else "not measured"
        data = run.trainer.train_data
        RECORDS.append({"reft_full": "MoReFT GLUE cola", "steps_wall_ms": steps["wall_ms"],
                        "step0_busy_ms": steps["busy_ms"], "peak_gb": steps["peak_gb"],
                        "eval_s": eval_s, "card": card})
        print(f"[reft-full] {card}: MoReFT GLUE, RoBERTa-large (24 layers, hidden 1024) from "
              f"the HF-format directory, float32, MoRe rank 1 f1 on every layer, dropout 0.05, "
              f"classifier trained, CoLA bs 32 x {data['input_ids'].shape[1]} tokens: losses "
              f"{losses}; steps 1-{REFT_FULL_STEPS - 1} wall "
              f"{[round(w, 2) for w in steps['wall_ms']]} ms (median {wall:.2f}), step 0 device "
              f"busy {_ms(steps['busy_ms'])} ms (profiled; wall "
              f"{steps['profiled_wall_ms']:.2f} ms with the profiler on), "
              f"idle share {idle}, peak {steps['peak_gb']:.2f} GB over step "
              f"{REFT_FULL_STEPS - 1}; results {run.results}; eval {eval_s:.3f} s wall; harness "
              f"run {glue['seconds']:.2f} s wall; no kernel of ours launched", flush=True)
        del glue, run, model
    finally:
        shutil.rmtree(llama_checkpoint, ignore_errors=True)
        shutil.rmtree(roberta_checkpoint, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches)


# -- the other decoder families (models/gpt2, gpt_neo, gpt_neox, backpack_gpt2, Gemma) --

def _gpt2_body_shapes(pfx: str, config: dict) -> dict:
    """A GPT-2 body's tensors under ``pfx``, projections in HF's Conv1D
    layout (in, out)."""
    h, n = config["n_embd"], config["n_layer"]
    shapes = {f"{pfx}wte.weight": (config["vocab_size"], h),
              f"{pfx}wpe.weight": (config["n_positions"], h)}
    for i in range(n):
        p = f"{pfx}h.{i}"
        for name, shape in (("attn.c_attn", (h, 3 * h)), ("attn.c_proj", (h, h)),
                            ("mlp.c_fc", (h, 4 * h)), ("mlp.c_proj", (4 * h, h))):
            shapes.update({f"{p}.{name}.weight": shape, f"{p}.{name}.bias": (shape[1],)})
        for ln in ("ln_1", "ln_2"):
            shapes.update({f"{p}.{ln}.weight": (h,), f"{p}.{ln}.bias": (h,)})
    shapes.update({f"{pfx}ln_f.weight": (h,), f"{pfx}ln_f.bias": (h,)})
    return shapes


def family_shapes(config: dict) -> dict:
    """HF tensor name -> shape of a checkpoint of ``config``: GPT-2,
    Backpack-GPT-2 (the reference's layout: Conv1D but the weight network's
    ``nn.Linear``), GPT-Neo, GPT-NeoX or Gemma (tied: no ``lm_head``)."""
    mt, v = config["model_type"], config["vocab_size"]
    if "BackpackGPT2LMHeadModel" in config.get("architectures", ()):
        h, nv, k = config["n_embd"], config["num_senses"], config["sense_intermediate_scale"]
        shapes = _gpt2_body_shapes("backpack.gpt2_model.", config)
        sn = "backpack.sense_network"
        for name, shape in (("block.mlp.c_fc", (h, 4 * h)), ("block.mlp.c_proj", (4 * h, h)),
                            ("final_mlp.c_fc", (h, k * h)), ("final_mlp.c_proj", (k * h, nv * h))):
            shapes.update({f"{sn}.{name}.weight": shape, f"{sn}.{name}.bias": (shape[1],)})
        for ln in ("ln", "block.ln_1", "block.ln_2"):
            shapes.update({f"{sn}.{ln}.weight": (h,), f"{sn}.{ln}.bias": (h,)})
        shapes.update({"backpack.sense_weight_net.c_attn.weight": (2 * h, h),
                       "backpack.sense_weight_net.c_attn.bias": (2 * h,)})
        return shapes
    if mt == "gpt2":
        return _gpt2_body_shapes("transformer.", config)
    if mt == "gemma":
        h, inter, hd = config["hidden_size"], config["intermediate_size"], config["head_dim"]
        q, kv = config["num_attention_heads"] * hd, config["num_key_value_heads"] * hd
        shapes = {"model.embed_tokens.weight": (v, h)}
        for i in range(config["num_hidden_layers"]):
            p = f"model.layers.{i}"
            shapes.update({f"{p}.self_attn.q_proj.weight": (q, h),
                           f"{p}.self_attn.k_proj.weight": (kv, h),
                           f"{p}.self_attn.v_proj.weight": (kv, h),
                           f"{p}.self_attn.o_proj.weight": (h, q),
                           f"{p}.mlp.gate_proj.weight": (inter, h),
                           f"{p}.mlp.up_proj.weight": (inter, h),
                           f"{p}.mlp.down_proj.weight": (h, inter),
                           f"{p}.input_layernorm.weight": (h,),
                           f"{p}.post_attention_layernorm.weight": (h,)})
        shapes["model.norm.weight"] = (h,)
        return shapes
    h = config["hidden_size"]
    if mt == "gpt_neo":
        shapes = {"transformer.wte.weight": (v, h),
                  "transformer.wpe.weight": (config["max_position_embeddings"], h)}
        for i in range(config["num_layers"]):
            p = f"transformer.h.{i}"
            shapes.update({f"{p}.attn.attention.{n}.weight": (h, h)
                           for n in ("q_proj", "k_proj", "v_proj", "out_proj")})
            shapes.update({f"{p}.attn.attention.out_proj.bias": (h,),
                           f"{p}.mlp.c_fc.weight": (4 * h, h), f"{p}.mlp.c_fc.bias": (4 * h,),
                           f"{p}.mlp.c_proj.weight": (h, 4 * h), f"{p}.mlp.c_proj.bias": (h,)})
            for ln in ("ln_1", "ln_2"):
                shapes.update({f"{p}.{ln}.weight": (h,), f"{p}.{ln}.bias": (h,)})
        shapes.update({"transformer.ln_f.weight": (h,), "transformer.ln_f.bias": (h,)})
        return shapes
    require(mt == "gpt_neox", f"family_shapes: model_type {mt!r}")
    inter = config["intermediate_size"]
    shapes = {"gpt_neox.embed_in.weight": (v, h)}
    for i in range(config["num_hidden_layers"]):
        p = f"gpt_neox.layers.{i}"
        for name, shape in (("attention.query_key_value", (3 * h, h)), ("attention.dense", (h, h)),
                            ("mlp.dense_h_to_4h", (inter, h)), ("mlp.dense_4h_to_h", (h, inter))):
            shapes.update({f"{p}.{name}.weight": shape, f"{p}.{name}.bias": (shape[0],)})
        for ln in ("input_layernorm", "post_attention_layernorm"):
            shapes.update({f"{p}.{ln}.weight": (h,), f"{p}.{ln}.bias": (h,)})
    shapes.update({"gpt_neox.final_layer_norm.weight": (h,),
                   "gpt_neox.final_layer_norm.bias": (h,), "embed_out.weight": (v, h)})
    return shapes


def monarch_layers(model) -> list:
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    return [m for m in model.modules() if isinstance(m, MonarchLinear)]


def family_harness_run(harness: str, argv: list, *, dtype: str = "bfloat16",
                       step_context=None) -> dict:
    """``alpaca_run`` or ``reasoning_run`` over ``argv`` with the harness's own
    ``build_model`` at ``dtype``; ``train`` and ``eval`` forwards beside the
    run's."""
    from sparse_matrix_fine_tuning_torch.scripts import run_alpaca, run_reasoning

    if harness == "alpaca":
        run = alpaca_run(argv, build=functools.partial(run_alpaca.build_model, dtype=dtype),
                         step_context=step_context)
        run["train_forwards"] = sum(run["train_shapes"].values())
        run["eval_forwards"] = run["forwards"] - run["train_forwards"]
        return run
    return reasoning_run(argv, build=functools.partial(run_reasoning.build_model, dtype=dtype),
                         step_context=step_context)


def remat_factor(model) -> int:
    """The forwards each adapted linear runs a training micro-batch: 2 under
    the Llama's remat (the recompute), else 1 (the GPT families ignore it)."""
    return 2 if getattr(model.config, "remat", False) else 1


def _family_outputs(harness: str, out: str) -> dict:
    """The files a run wrote that must be equal on the card and the CPU: the
    predictions or the generations as they are, and the eval results less
    the losses (held within a tolerance) and the wall seconds."""
    task = "alpaca" if harness == "alpaca" else "commonsense"
    got = {}
    for name in ("predictions.jsonl", "generations.json", "eval_results.json"):
        path = os.path.join(out, task, name)
        if os.path.exists(path):
            with open(path) as f:
                got[name] = f.read()
    if "eval_results.json" in got:
        got["eval_results.json"] = {k: v for k, v in json.loads(got["eval_results.json"]).items()
                                    if "loss" not in k and "runtime" not in k}
    return got


def backpack_sense_loreft(card: str, ckpt: str) -> dict:
    """A LoReFT at Backpack's ``sense_network_output`` site over the tiny
    Backpack of ``ckpt`` (float32, every linear Monarch-adapted): one
    forward and backward on the card against a CPU copy: the loss within
    ``ALPACA_TOL``, every trainable parameter's gradient within it of the
    gradient's scale; launches exact (K2 on every adapted linear, K3 on
    every one).  Returns the launches."""
    from sparse_matrix_fine_tuning_torch.interventions import reft
    from sparse_matrix_fine_tuning_torch.models.hf_convert import from_pretrained_causal_lm
    from sparse_matrix_fine_tuning_torch.peft import surgery

    tol = ALPACA_TOL
    model = from_pretrained_causal_lm(ckpt, dtype="float32", device="cpu")
    surgery.init_monarch(model, dict(PEFT, target_modules=surgery.find_all_linear_names(model)),
                         generator=torch.Generator().manual_seed(SEED + 70))
    cpu = reft.ReftModel(model, reft.ReftConfig(representations=[SENSE_LOREFT]),
                         generator=torch.Generator().manual_seed(SEED + 71))
    surgery.trainable_filter(cpu)
    card_model = copy.deepcopy(cpu).cuda()
    g = torch.Generator().manual_seed(SEED + 72)
    ids = torch.randint(4, FAMILY_VOCAB, (2, 24), generator=g)
    locs = torch.tensor([[[3, 7, 20]], [[0, 11, 23]]])
    grads, losses = {}, {}
    for where, m in (("cpu", cpu), ("card", card_model)):
        dev = next(m.parameters()).device
        reset_counts()  # the counted main path starts here
        loss = m.loss(m(ids.to(dev), intervention_locations=locs.to(dev)), ids.to(dev))
        loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            launches = counts()  # the counted main path ends here
        losses[where] = loss.item()
        grads[where] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                        if p.requires_grad}
    adapted = len(monarch_layers(cpu))
    expect = {"monarch_add": adapted, "monarch_bwd": adapted}
    expect_only(launches, expect, "Backpack sense-site LoReFT")
    require(_close(losses["card"], losses["cpu"], tol), f"Backpack LoReFT: losses {losses}")
    worst = 0.0
    for name, want in grads["cpu"].items():
        got = grads["card"][name]
        scale = float(want.abs().max())
        gap = float((got - want).abs().max())
        worst = max(worst, gap / max(scale, 1e-30))
        require(gap <= tol["atol"] + tol["rtol"] * scale,
                f"Backpack LoReFT: {name} gradient off by {gap} at scale {scale}")
    ivs = [n for n in grads["cpu"] if n.startswith("interventions.")]
    require(ivs and any(float(grads["card"][n].abs().max()) > 0 for n in ivs),
            f"Backpack LoReFT: intervention gradients {ivs}")
    print(f"[families] {card}: smoke, Backpack LoReFT rank 4 at sense_network_output over "
          f"{adapted} Monarch-adapted linears (positions {locs.tolist()}): loss "
          f"{losses['card']} card, {losses['cpu']} CPU; {len(grads['cpu'])} gradients, the "
          f"worst {worst:.2e} of its scale (tol {tol}); launches {expect}", flush=True)
    return expect


def phase_families_smoke(card: str) -> dict:
    """(a) Each family's tiny HF-format directory (``FAMILY_TINY``, float32
    weights written here) through its harness, the harness's ``build_model``
    at float32, dropout off, TF32 off, on the card and on the CPU: GPT-2,
    GPT-Neo, GPT-NeoX and Backpack through ``run_alpaca`` (the smoke argv
    without ``--smoke``: 2 steps of ``ALPACA_GA`` micro-batches, eval loss, MMLU,
    greedy predictions but for Backpack, which has no cache), Gemma through
    ``run_reasoning -task commonsense``: the adapted linears the family's,
    the logged losses and ``eval_loss`` within ``ALPACA_TOL``, the MMLU
    choice logits within it, the predictions, generations and eval results
    (less losses and seconds) equal, the card's launches exact (K2 on every
    adapted linear each forward, twice a training micro-batch under Gemma's
    remat; K3 each training micro-batch), none on the CPU.  Then
    ``backpack_sense_loreft``.  Returns the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = ALPACA_TOL
    launches = collections.Counter()
    for family, (config, harness, extra, n_adapted) in FAMILY_TINY.items():
        ckpt = os.path.join(OUT_DIR, f"family_{family}")
        out = os.path.join(OUT_DIR, f"family_{family}_run")
        for d in (ckpt, out, f"{out}_cpu"):
            shutil.rmtree(d, ignore_errors=True)
        write_hf_checkpoint(ckpt, config, family_shapes(config), SEED + 80, dtype=torch.float32)
        argv = [*(FAMILY_ALPACA_ARGV if harness == "alpaca" else FAMILY_REASONING_ARGV), *extra,
                "--model", ckpt]
        runs = {where: family_harness_run(harness, [*argv, f"--output_dir={d}", *flag],
                                          dtype="float32")
                for where, d, flag in (("card", out, []), ("cpu", f"{out}_cpu",
                                                            ["--platform=cpu"]))}
        card_run, cpu_run = runs["card"], runs["cpu"]
        model = card_run["run"].trainer.model
        adapted = len(monarch_layers(model))
        micro, evals = card_run["train_forwards"], card_run["eval_forwards"]
        require(adapted == n_adapted and (micro, evals) == (cpu_run["train_forwards"],
                                                            cpu_run["eval_forwards"])
                and micro > 0 and evals > 0,
                f"family {family}: {adapted} adapted, forwards {micro} + {evals} card, "
                f"{cpu_run['train_forwards']} + {cpu_run['eval_forwards']} CPU")
        require(not any(cpu_run["launches"].values()),
                f"family {family}: the CPU run launched {cpu_run['launches']}")
        expect = alpaca_expect(16, adapted, remat_factor(model) * micro + evals, micro,
                               "monarch_add")
        expect_only(card_run["launches"], expect, f"family {family}")
        launches.update(expect)
        task = "alpaca" if harness == "alpaca" else "commonsense"
        losses = [[r["loss"] for r in _alpaca_records(d, "metrics.jsonl", task) if "loss" in r]
                  for d in (out, f"{out}_cpu")]
        require(len(losses[0]) == len(losses[1]) > 0
                and all(_close(a, b, tol) for a, b in zip(*losses)),
                f"family {family}: losses {losses[0]} card, {losses[1]} CPU")
        files = [_family_outputs(harness, d) for d in (out, f"{out}_cpu")]
        detail = ""
        if harness == "alpaca":
            m = [r["run"].metrics for r in (card_run, cpu_run)]
            require(_close(m[0]["eval_loss"], m[1]["eval_loss"], tol),
                    f"family {family}: eval_loss {m[0]['eval_loss']} card, {m[1]['eval_loss']} CPU")
            logits = [torch.from_numpy(r["run"].choice_logits()) for r in (card_run, cpu_run)]
            gap = float(((logits[0] - logits[1]).abs() - tol["rtol"] * logits[1].abs()).max())
            require(logits[0].shape == logits[1].shape and gap <= tol["atol"],
                    f"family {family}: MMLU choice logits differ by {gap} past the rtol")
            detail = (f"eval_loss {m[0]['eval_loss']} / {m[1]['eval_loss']}; MMLU choice logits "
                      f"{tuple(logits[0].shape)} max |card - CPU| "
                      f"{float((logits[0] - logits[1]).abs().max()):.2e}; ")
        else:
            results = [r["run"].results for r in (card_run, cpu_run)]
            require(results[0] == results[1], f"family {family}: results {results}")
            detail = f"results {results[0]} on both; "
        require(files[0] == files[1] and files[0], f"family {family}: the written "
                f"{sorted(files[0])} differ between the card and the CPU")
        print(f"[families] {card}: smoke, {family} ({type(model).__name__}) through run_{harness}"
              f", {adapted} adapted linears: losses {losses[0]} card, {losses[1]} CPU (tol "
              f"{tol}); {detail}{' and '.join(sorted(files[0]))} equal; {micro} training and "
              f"{evals} other forwards; launches {expect}; wall "
              f"{card_run['seconds']:.2f} s card, {cpu_run['seconds']:.2f} s CPU", flush=True)
        if family == "backpack":
            launches.update(backpack_sense_loreft(card, ckpt))
        del runs, card_run, cpu_run, model
        for d in (ckpt, out, f"{out}_cpu"):
            shutil.rmtree(d, ignore_errors=True)
    return dict(launches)


def family_kernel_times(card: str, label: str, layers: list, rows: int,
                        dtype=torch.bfloat16) -> dict:
    """K1 and K3 timed at each distinct adapted shape of ``layers`` (the
    run's ``MonarchLinear`` layers) on ``rows`` rows (``adapter_kernel_times``)."""
    shapes = collections.Counter((m.in_features, m.out_features, tuple(m.blkdiag1.shape),
                                  tuple(m.blkdiag2.shape), rows) for m in layers)
    return adapter_kernel_times(card, label, shapes, "monarch_kernel", dtype, "families-full")


def adapter_kernel_times(card: str, label: str, shapes: collections.Counter, forward: str,
                         dtype: torch.dtype, tag: str) -> dict:
    """The forward kernel ``forward`` (K1, or K2 over a random base) and K3
    timed (``benchlib.time_ms``) at each (in, out, w1 shape, w2 shape, rows)
    of ``shapes``, against their plain versions, the bound and (the forward)
    ``F.linear`` on the dense equivalent (K1) or ``addmm`` (K2), K3's plan
    printed ("fast": the cluster kernel; else the generic kernel, ROADMAP B
    lead 10); summed over the counts of ``shapes``.  Launches made here are
    not the path's."""
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent

    g = torch.Generator(device="cuda").manual_seed(SEED + 90)
    totals = {forward: collections.Counter(), "monarch_bwd": collections.Counter()}
    plans, generic = [], []
    print(_HEADER, flush=True)
    with torch.no_grad():
        for (n_in, n_out, s1, s2, rows), n in shapes.items():
            fields = monarch_cuda.monarch_bwd_plan_fields(rows, s1, s2, with_dx=True, dtype=dtype)
            plans.append(f"{n_in}->{n_out} at {rows} rows x{n} (w1 {s1}, w2 {s2}): fast "
                         f"{fields['fast']}")
            x = torch.randn(rows, n_in, generator=g, device="cuda").to(dtype)
            w1 = (torch.randn(s1, generator=g, device="cuda") / s1[2] ** 0.5).to(dtype)
            w2 = (torch.randn(s2, generator=g, device="cuda") / s2[2] ** 0.5).to(dtype)
            dout = torch.randn(rows, n_out, generator=g, device="cuda").to(dtype)
            dense = monarch_dense_equivalent(w1.float(), w2.float()).to(dtype)
            if forward == "monarch_add":
                base = torch.randn(rows, n_out, generator=g, device="cuda").to(dtype)
                fwd = (lambda: monarch_cuda.monarch_add(base, x, w1, w2),
                       lambda: monarch_cuda.monarch_add_reference(base, x, w1, w2),
                       lambda: torch.addmm(base, x, dense.T))
            else:
                fwd = (lambda: monarch_cuda.monarch_kernel(x, w1, w2),
                       lambda: monarch_cuda.monarch_kernel_reference(x, w1, w2),
                       lambda: torch.nn.functional.linear(x, dense))
            cases = {forward: fwd,
                     "monarch_bwd": (lambda: monarch_cuda.monarch_bwd(x, w1, w2, dout),
                                     lambda: monarch_cuda.monarch_bwd_reference(x, w1, w2, dout),
                                     None)}
            for name, (kern, plain, library) in cases.items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
                err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
                share = max(float((a.float() - b.float()).abs().max()) / tolerance(dtype, b)
                            for a, b in pairs)
                require(share <= 1.0, f"{name} {label} {n_in}->{n_out} M={rows}: "
                                      f"{share:.3f} of tol")
                reps = (50, 5) if fields["fast"] or name != "monarch_bwd" else PROJECTION_BWD_REPS
                (ms, call), (plain_ms, plain_call) = time_ms(kern, *reps), time_ms(plain, *reps)
                lib = time_ms(library)[0] if library is not None else None
                rec = _record(name, f"x{n}", n_in, n_out, rows, dtype, err, share, ms, plain_ms,
                              call, plain_call, lib, r=s1[1])
                for k in ("ms", "plain_ms", "bound_ms"):
                    totals[name][k] += n * rec[k]
                totals[name]["library_ms"] += n * (lib or 0.0)
                if name == "monarch_bwd" and not fields["fast"]:
                    generic.append({"shape": [n_in, n_out], "rows": rows, "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": rec["bound_ms"]})
    line = ", ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, library "
                     f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f})" if k != "monarch_bwd"
                     else f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
                     f"{v['bound_ms']:.4f})" for k, v in totals.items())
    print(f"[{tag}] {card}: {label}: K3 plans: {'; '.join(plans)}; device time over the "
          f"{sum(shapes.values())} adapted linears: {line}; K3 on the generic kernel (ROADMAP B "
          f"lead 10): {generic or 'none'}", flush=True)
    RECORDS.append({"adapter_kernels": label, "tag": tag, "plans": plans,
                    "totals": {k: dict(v) for k, v in totals.items()}, "generic_k3": generic,
                    "card": card})
    return {"totals": totals, "generic": generic}


def phase_families_full(card: str) -> dict:
    """(b) ``FAMILIES_FULL``: GPT-2-medium and Pythia-1B through
    ``run_alpaca`` (every linear adapted, Pythia's ``embed_out`` too), Gemma-2B
    through ``run_reasoning``'s commonsense recipe, each from an HF-format
    directory written here (random seeded bf16 weights, deleted after), at
    full width and depth in bf16 with the harnesses' dropout 0.1 (so K1, not
    K2, on every forward, eval included) for ``FAMILIES_FULL_STEPS`` steps
    and a short greedy eval: the adapted linears the predicted count,
    launches exact (K1 on every adapted linear each forward, twice a
    training micro-batch under the Llama's remat "nothing"; K3 once a
    micro-batch); the harness's steps through its trainer's
    ``step_context`` (step 0 profiled: busy; the later ones alone: wall,
    peak); then K1 and K3 timed at the run's adapted shapes
    (``family_kernel_times``).  Returns the launches."""
    launches = collections.Counter()
    for label, harness, config, argv, n_adapted in FAMILIES_FULL:
        ckpt = os.path.join(OUT_DIR, "family_full")
        out = os.path.join(OUT_DIR, "family_full_run")
        for d in (ckpt, out):
            shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        write_hf_checkpoint(ckpt, config, family_shapes(config), SEED + 91)
        write_s = time.perf_counter() - t0
        size_gb = os.path.getsize(os.path.join(ckpt, "model.safetensors")) / 1e9
        steps = {}
        torch.cuda.reset_peak_memory_stats()
        try:
            full = family_harness_run(harness, [*argv, "--model", ckpt, f"--output_dir={out}"],
                                      step_context=harness_step_context(steps, label))
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        model = full["run"].trainer.model
        layers = monarch_layers(model)
        micro, evals = full["train_forwards"], full["eval_forwards"]
        remat = remat_factor(model)
        ga = full["run"].trainer.args.gradient_accumulation_steps
        require(len(layers) == n_adapted and micro == FAMILIES_FULL_STEPS * ga and evals > 0,
                f"{label}: {len(layers)} adapted, {micro} training and {evals} other forwards")
        expect = {"monarch_kernel": n_adapted * (remat * micro + evals),
                  "monarch_bwd": n_adapted * micro}
        expect_only(full["launches"], expect, f"{label} through run_{harness}")
        launches.update(expect)
        task = "alpaca" if harness == "alpaca" else "commonsense"
        losses = [r["loss"] for r in _alpaca_records(out, "metrics.jsonl", task) if "loss" in r]
        require(len(losses) == FAMILIES_FULL_STEPS and all(map(math.isfinite, losses))
                and len(steps.get("wall_ms", [])) == FAMILIES_FULL_STEPS - 1
                and "busy_ms" in steps, f"{label}: losses {losses}, steps {steps}")
        if harness == "alpaca":
            metrics = full["run"].metrics
            require(math.isfinite(metrics["eval_loss"]) and metrics["predict_samples"] > 0,
                    f"{label}: metrics {metrics}")
            data = full["run"].trainer.train_data
            result = (f"eval_loss {metrics['eval_loss']}, "
                      + (f"MMLU accuracy {metrics['eval_mmlu_eval_accuracy']} "
                         f"({metrics['eval_mmlu_runtime']} s), "
                         if "eval_mmlu_eval_accuracy" in metrics else "no MMLU, ")
                      + f"{metrics['predict_samples']} predictions ({metrics['predict_runtime']} "
                        "s)")
        else:
            results = full["run"].results
            require(results and all(map(math.isfinite, results.values())),
                    f"{label}: results {results}")
            data = full["run"].trainer.train_data
            result = f"results {results}"
        rows, width = data["input_ids"].shape
        wall = statistics.median(steps["wall_ms"])
        idle = f"{1 - steps['busy_ms'] / wall:.3f}" if steps["busy_ms"] else "not measured"
        per_step = {"monarch_kernel": n_adapted * remat * ga, "monarch_bwd": n_adapted * ga}
        RECORDS.append({"families_full": label, "losses": losses, "steps_wall_ms": steps["wall_ms"],
                        "step0_busy_ms": steps["busy_ms"], "peak_gb": steps["peak_gb"],
                        "peak_before_gb": steps.get("peak_before_gb"), "launches": expect,
                        "launches_a_step": per_step, "eval_forwards": evals,
                        "adapted": n_adapted, "card": card})
        print(f"[families-full] {card}: {label} through run_{harness}, "
              f"{model.config.num_hidden_layers} layers, bf16, dropout 0.1, "
              f"{type(model).__name__}: checkpoint {size_gb:.2f} GB written in {write_s:.2f} s; "
              f"{n_adapted} adapted linears; {rows} training rows of up to {width} tokens, ga "
              f"{ga}; losses {losses}; steps 1-{FAMILIES_FULL_STEPS - 1} wall "
              f"{[round(w, 2) for w in steps['wall_ms']]} ms (median {wall:.2f}), step 0 device "
              f"busy {_ms(steps['busy_ms'])} ms (profiled; wall {steps['profiled_wall_ms']:.2f} ms "
              f"with the profiler on), idle share {idle}, peak {steps['peak_gb']:.2f} GB over "
              f"step {FAMILIES_FULL_STEPS - 1} ({steps['peak_before_gb']:.2f} GB before it); "
              f"{result}; launches a step K1 {per_step['monarch_kernel']}, K3 "
              f"{per_step['monarch_bwd']}, K1 an eval forward {n_adapted} ({evals} eval "
              f"forwards), K2 none (dropout 0.1 sends every forward to K1); launches "
              f"{expect}; harness run {full['seconds']:.2f} s wall", flush=True)
        tokens = max(b * t for b, t in full["train_shapes"])
        family_kernel_times(card, label, layers, tokens)
        del full, model, layers
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return dict(launches)


# -- BLIP (models/blip.py) --------------------------------------------------------

def blip_model(kind: str, cfg, seed: int):
    """A BLIP VQA (``kind`` "qa") or ITM model on the CPU, float32, drawn from
    CPU generators seeded from ``seed``: ``BLIP_PEFT``'s adapters with random
    nonzero factors and random biases (the plain-adapter init zeroes
    blkdiag2, which would hide a kernel that writes zeros)."""
    from sparse_matrix_fine_tuning_torch.models import blip
    from sparse_matrix_fine_tuning_torch.peft import surgery

    cls = blip.BlipForQuestionAnswering if kind == "qa" else blip.BlipForImageTextRetrieval
    model = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    surgery.init_monarch(model, BLIP_PEFT, generator=torch.Generator().manual_seed(seed + 1))
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "blkdiag" in name:
                p.normal_(0.0, 1.0, generator=g).div_(p.shape[-1] ** 0.5)
            elif p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def blip_inputs(cfg, b: int, t: int, g: torch.Generator) -> tuple:
    """(ids, mask, pixels, answers): question ids, rows after the first
    padded by 1, 2, ... tokens (at most half), (b, 3, H, W) pixels, answer
    tokens."""
    tc, vc = cfg.text_config, cfg.vision_config
    ids = torch.randint(1, tc.vocab_size, (b, t), generator=g)
    lens = torch.tensor([t - min(i, t // 2) for i in range(b)])
    mask = (torch.arange(t)[None] < lens[:, None]).long()
    pixels = torch.randn(b, 3, vc.image_size, vc.image_size, generator=g)
    answers = torch.randint(1, tc.vocab_size, (b,), generator=g)
    return ids * mask, mask, pixels, answers


def _worst(got: dict, want: dict, tol: dict, what: str) -> float:
    """The largest |got - want| past ``tol``'s rtol over two dicts of
    tensors (each in its own scale), required within its atol; returns the
    largest |got - want| / scale."""
    worst = 0.0
    for key, ref in want.items():
        ref = ref.detach().float().cpu()
        val = got[key].detach().float().cpu()
        require(val.shape == ref.shape and bool(torch.isfinite(val).all()),
                f"{what} {key}: shape {tuple(val.shape)} against {tuple(ref.shape)}")
        scale = float(ref.abs().max())
        gap = float((val - ref).abs().max())
        require(gap <= tol["atol"] + tol["rtol"] * scale,
                f"{what} {key}: off by {gap} at scale {scale}")
        worst = max(worst, gap / max(scale, 1e-30))
    return worst


def blip_answer_loss(out: dict, answers: torch.Tensor) -> torch.Tensor:
    """Cross entropy of the decoder's first-position logits against the
    answer tokens."""
    return torch.nn.functional.cross_entropy(out["decoder_logits"][:, 0].float(), answers)


def phase_blip_smoke(card: str) -> dict:
    """(a) The tiny BLIP (the JAX ``tiny()`` shapes: towers of 2 layers, width
    32) in float32, TF32 off, with ``BLIP_PEFT``'s adapters on every linear of
    the towers, on the card against a CPU copy, within ``ALPACA_TOL``: the
    VQA wrapper's decoder logits and every encoder hidden state, the ITM
    wrapper's scores with the ITM head and contrastive; two AdamW steps
    (``GroupedAdamW``) of the answer loss, each step's loss and every adapter
    gradient; then a LoReFT at a text-encoder block output and a
    cross-attention output over the adapted VQA wrapper, its loss and every
    adapter and intervention gradient.  Launches exact, each counted path
    on its own: K2 once an adapted linear a forward (48 VQA, 28 ITM head, 20
    contrastive), K3 once a backward.  Returns the launches."""
    from sparse_matrix_fine_tuning_torch.interventions import reft
    from sparse_matrix_fine_tuning_torch.models import blip
    from sparse_matrix_fine_tuning_torch.peft import surgery
    from sparse_matrix_fine_tuning_torch.training.optim import build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = ALPACA_TOL
    cfg = blip.BlipModelConfig.tiny()
    adapted = {"qa": 2 * 4 + 2 * 2 * 10, "itm": 2 * 4 + 2 * 10, "contrastive": 2 * 4 + 2 * 6}
    g = torch.Generator().manual_seed(SEED + 100)
    ids, mask, pixels, answers = blip_inputs(cfg, 3, 7, g)
    launches = collections.Counter()

    def counted(fn, expect: dict, what: str):
        torch.cuda.synchronize()
        reset_counts()  # the counted main path starts here
        out = fn()
        torch.cuda.synchronize()
        expect_only(counts(), expect, what)  # the counted main path ends here
        launches.update(expect)
        return out

    def on(device, *xs):
        return [x.to(device) for x in xs]

    qa_cpu = blip_model("qa", cfg, SEED + 101)
    itm_cpu = blip_model("itm", cfg, SEED + 104)
    qa_card, itm_card = copy.deepcopy(qa_cpu).cuda(), copy.deepcopy(itm_cpu).cuda()
    require(len(monarch_layers(qa_cpu)) == adapted["qa"]
            and len(monarch_layers(itm_cpu)) == adapted["itm"],
            f"BLIP smoke: {len(monarch_layers(qa_cpu))} and {len(monarch_layers(itm_cpu))} "
            "adapted linears")
    worst = {}
    with torch.no_grad():
        want = blip.BlipWrapper(qa_cpu)(ids, pixels, attention_mask=mask)
        got = counted(lambda: blip.BlipWrapper(qa_card)(*on("cuda", ids, pixels),
                                                        attention_mask=mask.cuda()),
                      {"monarch_add": adapted["qa"]}, "BLIP VQA forward")
        worst["vqa"] = _worst(
            {"decoder_logits": got["decoder_logits"],
             **{f"hidden {i}": h for i, h in enumerate(got["encoder_hidden_states"])}},
            {"decoder_logits": want["decoder_logits"],
             **{f"hidden {i}": h for i, h in enumerate(want["encoder_hidden_states"])}},
            tol, "BLIP VQA")
        for mode, head in (("itm", True), ("contrastive", False)):
            want = blip.BlipITMWrapper(itm_cpu, head)(ids, pixels, attention_mask=mask)
            got = counted(lambda head=head: blip.BlipITMWrapper(itm_card, head)(
                *on("cuda", ids, pixels), attention_mask=mask.cuda()),
                {"monarch_add": adapted[mode]}, f"BLIP ITM ({mode})")
            worst[mode] = _worst({"itm_score": got["itm_score"]},
                                 {"itm_score": want["itm_score"]}, tol, f"BLIP ITM ({mode})")

    def train_steps(model, device):
        named = [(n, p) for n, p in model.named_parameters()
                 if n in set(surgery.trainable_filter(model, ()))]
        opt = build_optimizer(named, learning_rate=1e-2, total_steps=BLIP_STEPS,
                              warmup_ratio=0.0, lr_scheduler_type="constant")
        wrapper, steps = blip.BlipWrapper(model), []
        for _ in range(BLIP_STEPS):
            opt.zero_grad()
            x, px, m, ans = on(device, ids, pixels, mask, answers)
            loss = blip_answer_loss(wrapper(x, px, attention_mask=m), ans)
            loss.backward()
            steps.append({"loss": loss.detach(),
                          **{n: p.grad.detach().clone() for n, p in named}})
            opt.step()
        return steps, len(named)

    want, n_trainable = train_steps(qa_cpu, "cpu")
    got, _ = counted(lambda: train_steps(qa_card, "cuda"),
                     {"monarch_add": adapted["qa"] * BLIP_STEPS,
                      "monarch_bwd": adapted["qa"] * BLIP_STEPS}, "BLIP VQA training")
    require(n_trainable == 2 * adapted["qa"], f"BLIP smoke: {n_trainable} trainable")
    worst["training"] = max(_worst(gs, ws, tol, f"BLIP training step {k}")
                            for k, (gs, ws) in enumerate(zip(got, want)))
    losses = [[float(st["loss"]) for st in run] for run in (got, want)]

    model = blip_model("qa", cfg, SEED + 101)
    rcfg = reft.ReftConfig(representations=BLIP_SMOKE_LOREFT)
    reft_cpu = reft.ReftModel(blip.BlipWrapper(model), rcfg,
                              generator=torch.Generator().manual_seed(SEED + 107))
    reft_card = copy.deepcopy(reft_cpu).cuda()
    locs = torch.tensor([[[0, 3], [1, 2]], [[2, 4], [0, 1]], [[1, 2], [3, 0]]])

    def reft_step(m, device):
        surgery.trainable_filter(m, ())
        x, px, msk, ans, lc = on(device, ids, pixels, mask, answers, locs)
        loss = blip_answer_loss(m(x, attention_mask=msk, intervention_locations=lc,
                                  pixel_values=px), ans)
        loss.backward()
        return {"loss": loss.detach(), **{n: p.grad.detach() for n, p in m.named_parameters()
                                          if p.requires_grad}}

    want = reft_step(reft_cpu, "cpu")
    got = counted(lambda: reft_step(reft_card, "cuda"),
                  {"monarch_add": adapted["qa"], "monarch_bwd": adapted["qa"]},
                  "BLIP LoReFT step")
    ivs = [n for n in want if n.startswith("interventions.")]
    require(len(ivs) == 2 * 3 and all(float(want[n].abs().max()) > 0 for n in ivs),
            f"BLIP LoReFT: intervention gradients {ivs}")
    worst["loreft"] = _worst(got, want, tol, "BLIP LoReFT")
    print(f"[blip] {card}: smoke, tiny BLIP (towers of 2 layers, width 32), float32, "
          f"{adapted['qa']} (VQA) and {adapted['itm']} (ITM) Monarch-adapted linears: card "
          f"against CPU, the worst |card - CPU| / scale: VQA outputs and hidden states "
          f"{worst['vqa']:.2e}, ITM head {worst['itm']:.2e}, contrastive "
          f"{worst['contrastive']:.2e}; {BLIP_STEPS} AdamW steps: losses {losses[0]} card, "
          f"{losses[1]} CPU, {n_trainable} adapter gradients a step {worst['training']:.2e}; "
          f"LoReFT at {[(r['layer'], r['component']) for r in BLIP_SMOKE_LOREFT]}: loss "
          f"{float(got['loss'])} card, {float(want['loss'])} CPU, {len(want) - 1} gradients "
          f"{worst['loreft']:.2e} (tol {tol}); launches {dict(launches)}", flush=True)
    return dict(launches)


def blip_hf_shapes(config: dict) -> dict:
    """{HF name: shape} of a ``BlipForQuestionAnswering`` checkpoint as
    ``save_pretrained`` writes it (the LM head's decoder weight is tied to
    the decoder's word embeddings and not written)."""
    tc, vc = config["text_config"], config["vision_config"]
    d, p, i_v = vc["hidden_size"], vc["patch_size"], vc["intermediate_size"]
    h, i_t, enc = tc["hidden_size"], tc["intermediate_size"], tc["encoder_hidden_size"]
    shapes = {"vision_model.embeddings.class_embedding": (1, 1, d),
              "vision_model.embeddings.patch_embedding.weight": (d, 3, p, p),
              "vision_model.embeddings.patch_embedding.bias": (d,),
              "vision_model.embeddings.position_embedding":
                  (1, (vc["image_size"] // p) ** 2 + 1, d)}

    def linear(name, n_out, n_in):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (n_out, n_in), (n_out,)

    def norm(name, width):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (width,), (width,)

    for k in range(vc["num_hidden_layers"]):
        pfx = f"vision_model.encoder.layers.{k}"
        norm(f"{pfx}.layer_norm1", d)
        linear(f"{pfx}.self_attn.qkv", 3 * d, d)
        linear(f"{pfx}.self_attn.projection", d, d)
        norm(f"{pfx}.layer_norm2", d)
        linear(f"{pfx}.mlp.fc1", i_v, d)
        linear(f"{pfx}.mlp.fc2", d, i_v)
    norm("vision_model.post_layernorm", d)
    for tower in ("text_encoder", "text_decoder.bert"):
        shapes[f"{tower}.embeddings.word_embeddings.weight"] = (tc["vocab_size"], h)
        shapes[f"{tower}.embeddings.position_embeddings.weight"] = \
            (tc["max_position_embeddings"], h)
        norm(f"{tower}.embeddings.LayerNorm", h)
        for k in range(tc["num_hidden_layers"]):
            pfx = f"{tower}.encoder.layer.{k}"
            for block, kv in (("attention", h), ("crossattention", enc)):
                linear(f"{pfx}.{block}.self.query", h, h)
                linear(f"{pfx}.{block}.self.key", h, kv)
                linear(f"{pfx}.{block}.self.value", h, kv)
                linear(f"{pfx}.{block}.output.dense", h, h)
                norm(f"{pfx}.{block}.output.LayerNorm", h)
            linear(f"{pfx}.intermediate.dense", i_t, h)
            linear(f"{pfx}.output.dense", h, i_t)
            norm(f"{pfx}.output.LayerNorm", h)
    linear("text_decoder.cls.predictions.transform.dense", h, h)
    norm("text_decoder.cls.predictions.transform.LayerNorm", h)
    shapes["text_decoder.cls.predictions.bias"] = (tc["vocab_size"],)
    return shapes


def adapted_rows(model, run) -> collections.Counter:
    """{(in, out, w1 shape, w2 shape, rows): adapted linears} of ``model``'s
    ``MonarchLinear`` layers over one call of ``run``, the rows each one's
    input had."""
    seen = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.update([(mod.in_features, mod.out_features,
                                        tuple(mod.blkdiag1.shape), tuple(mod.blkdiag2.shape),
                                        args[0].numel() // mod.in_features)]))
        for m in monarch_layers(model)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def phase_blip_full(card: str) -> dict:
    """(b) BLIP at ``Salesforce/blip-vqa-base`` width (``BLIP_VQA_BASE_HF``:
    ViT-B/16 at 384 px, 577 tokens, 12 layers of 768; text encoder and
    decoder of 12 BERT-base layers with cross-attention, vocab 30524), from
    an HF-format directory written here (random seeded float32 weights,
    ``blip_hf_shapes``; deleted after) through ``from_pretrained_blip``, the
    loaded tensors against the written ones; float32, TF32 off, as the JAX
    model computes; ``BLIP_PEFT``'s adapters on all 288 linears of the
    towers.  Two ``Trainer`` steps of the answer loss at batch
    ``BLIP_BATCH``, ``BLIP_QUESTION``-token questions, ga ``BLIP_GA``
    (step 0 profiled, step 1 timed alone: wall, busy, idle, peak), each
    adapted linear's rows and K3's plan at every shape, K2 and K3 timed
    there; one LoReFT step at text-encoder layers ``BLIP_REFT_LAYERS``;
    the ITM model (its heads drawn here, ``image_text_hidden_size`` 256)
    forward with the ITM head and contrastive; then the adapters merged
    (K1 once each) and an eval forward of the merged model against the
    unmerged one.  Launches exact, each path counted on its own.  Returns
    the launches."""
    from sparse_matrix_fine_tuning_torch.interventions import reft
    from sparse_matrix_fine_tuning_torch.models import blip
    from sparse_matrix_fine_tuning_torch.models.hf_convert import load_state_dict
    from sparse_matrix_fine_tuning_torch.peft import surgery
    from sparse_matrix_fine_tuning_torch.training.optim import build_optimizer
    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer, TrainingArgs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = collections.Counter()

    def counted(fn, expect: dict, what: str):
        torch.cuda.synchronize()
        reset_counts()  # the counted main path starts here
        out = fn()
        torch.cuda.synchronize()
        expect_only(counts(), expect, what)  # the counted main path ends here
        launches.update(expect)
        return out

    ckpt, out_dir = (os.path.join(OUT_DIR, name) for name in ("blip_full", "blip_full_run"))
    for d in (ckpt, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    written = write_hf_checkpoint(ckpt, BLIP_VQA_BASE_HF, blip_hf_shapes(BLIP_VQA_BASE_HF),
                                  SEED + 110, dtype=torch.float32)
    write_s = time.perf_counter() - t0
    size_gb = os.path.getsize(os.path.join(ckpt, "model.safetensors")) / 1e9
    try:
        t0 = time.perf_counter()
        model = blip.from_pretrained_blip(ckpt, "qa", device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state = load_state_dict(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    cfg = model.config
    tied = "text_decoder.bert.embeddings.word_embeddings.weight"
    patch = written["vision_model.embeddings.patch_embedding.weight"]
    with torch.no_grad():
        total = sum(float(p.double().sum()) for p in model.parameters())
        want_total = sum(float(t.double().sum()) for t in written.values()) \
            + float(written[tied].double().sum())
        require(torch.equal(model.vision_model.embeddings.patch_kernel,
                            patch.reshape(patch.shape[0], -1).T)
                and torch.equal(model.lm_head.decoder.weight, written[tied])
                and abs(total - want_total) <= 1e-9 * max(abs(want_total), 1.0)
                and sum(p.numel() for p in model.parameters())
                == sum(t.numel() for t in written.values()) + written[tied].numel(),
                f"BLIP full: the loaded model differs from the written tensors ({total} against "
                f"{want_total})")
    del written
    n_params = sum(p.numel() for p in model.parameters())
    adapted = surgery.init_monarch(model, BLIP_PEFT,
                                   generator=torch.Generator().manual_seed(SEED + 111))
    require(len(adapted) == BLIP_ADAPTED["qa"], f"BLIP full: {len(adapted)} adapted linears")
    wrapper = blip.BlipWrapper(model)

    g = torch.Generator().manual_seed(SEED + 112)
    n = BLIP_BATCH * BLIP_GA * BLIP_STEPS
    ids, mask, pixels, answers = blip_inputs(cfg, n, BLIP_QUESTION, g)
    data = {"input_ids": ids.int().numpy(), "attention_mask": mask.int().numpy(),
            "pixel_values": pixels.numpy(), "labels": answers.int().numpy()}

    def loss_fn(m, batch, train):
        return blip_answer_loss(m(batch["input_ids"], batch["pixel_values"],
                                  attention_mask=batch["attention_mask"]), batch["labels"])

    args = TrainingArgs(output_dir=out_dir, learning_rate=1e-4, max_steps=BLIP_STEPS,
                        per_device_train_batch_size=BLIP_BATCH,
                        gradient_accumulation_steps=BLIP_GA, logging_steps=1, log_param_steps=0,
                        warmup_ratio=0.0, lr_scheduler_type="constant", merged_training="off",
                        seed=SEED)
    steps = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(wrapper, args, train_data=data, loss_fn=loss_fn, extra_trainable_paths=(),
                 device="cuda", step_context=harness_step_context(steps, "BLIP"))
    micro = BLIP_STEPS * BLIP_GA
    t0 = time.perf_counter()
    counted(tr.train, {"monarch_add": BLIP_ADAPTED["qa"] * micro,
                       "monarch_bwd": BLIP_ADAPTED["qa"] * micro}, "BLIP full training")
    train_s = time.perf_counter() - t0
    losses = [r["loss"] for r in tr.log_history if "loss" in r]
    require(len(losses) == BLIP_STEPS and all(map(math.isfinite, losses))
            and len(steps.get("wall_ms", [])) == BLIP_STEPS - 1 and "busy_ms" in steps,
            f"BLIP full: losses {losses}, steps {steps}")
    wall, busy = steps["wall_ms"][0], steps["busy_ms"]
    idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
    opt_bytes = tr.optimizer.state_bytes()
    batch = {k: torch.from_numpy(v[:BLIP_BATCH]).cuda() for k, v in data.items()}
    batch = {k: v.long() if k != "pixel_values" else v for k, v in batch.items()}
    with torch.no_grad():
        shapes = adapted_rows(model, lambda: wrapper(batch["input_ids"], batch["pixel_values"],
                                                     attention_mask=batch["attention_mask"]))
    RECORDS.append({"blip_full": "VQA training", "losses": losses, "step1_wall_ms": wall,
                    "step0_busy_ms": busy, "peak_gb": steps["peak_gb"],
                    "adapted": len(adapted), "card": card})
    print(f"[blip-full] {card}: blip-vqa-base width, float32: checkpoint {size_gb:.2f} GB "
          f"({n_params / 1e6:.1f} M parameters) written in {write_s:.2f} s, loaded in "
          f"{load_s:.2f} s, equal to the written tensors; {len(adapted)} adapted linears; "
          f"{BLIP_STEPS} steps at batch {BLIP_BATCH} x ga {BLIP_GA}, questions of "
          f"{BLIP_QUESTION} tokens: losses {losses}; step 1 wall {wall:.2f} ms (alone), step 0 "
          f"device busy {_ms(busy)} ms (profiled; wall {steps['profiled_wall_ms']:.2f} ms with "
          f"the profiler on), idle share {idle}, peak {steps['peak_gb']:.2f} GB over step 1 "
          f"({steps['peak_before_gb']:.2f} GB before it); AdamW state {opt_bytes / 1e6:.2f} MB; "
          f"training {train_s:.2f} s wall; rows by adapted shape "
          f"{ {f'{k[0]}->{k[1]}@{k[4]}': v for k, v in shapes.items()} }", flush=True)
    adapter_kernel_times(card, "BLIP-base VQA, float32", shapes, "monarch_add", torch.float32,
                         "blip-full")
    tr.close()
    del tr

    rcfg = reft.ReftConfig(representations=[
        {"layer": k, "component": "block_output", "intervention": "LoreftIntervention",
         "low_rank_dimension": 8} for k in BLIP_REFT_LAYERS])
    reft_model = reft.ReftModel(wrapper, rcfg, generator=torch.Generator().manual_seed(SEED + 113))
    named = [(k, p) for k, p in reft_model.named_parameters()
             if k in set(surgery.trainable_filter(reft_model, ()))]
    opt = build_optimizer(named, learning_rate=1e-4, total_steps=1, warmup_ratio=0.0,
                          lr_scheduler_type="constant")
    locs = torch.tensor([[0, BLIP_QUESTION // 2 - 1]], device="cuda").expand(
        BLIP_BATCH, len(BLIP_REFT_LAYERS), 2)

    def reft_step():
        opt.zero_grad()
        loss = blip_answer_loss(reft_model(batch["input_ids"],
                                           attention_mask=batch["attention_mask"],
                                           intervention_locations=locs,
                                           pixel_values=batch["pixel_values"]), batch["labels"])
        loss.backward()
        opt.step()
        return float(loss.detach())

    reft_loss, reft_s = timed(lambda: counted(
        reft_step, {"monarch_add": BLIP_ADAPTED["qa"], "monarch_bwd": BLIP_ADAPTED["qa"]},
        "BLIP full LoReFT step"))
    reft_busy = device_busy_ms(lambda k: reft_step(), 1, "BLIP LoReFT step")
    require(math.isfinite(reft_loss), f"BLIP LoReFT loss {reft_loss}")
    print(f"[blip-full] {card}: LoReFT rank 8 at text-encoder layers {BLIP_REFT_LAYERS} over the "
          f"adapted model, {len(named)} trainable tensors: one step, loss {reft_loss}, wall "
          f"{reft_s * 1e3:.2f} ms (the card synchronised around it), device busy "
          f"{_ms(reft_busy)} ms (a second step, profiled)", flush=True)
    del reft_model, opt, named

    itm = blip.BlipForImageTextRetrieval(cfg, device="cuda",
                                         generator=torch.Generator(device="cuda").manual_seed(
                                             SEED + 114))
    heads = {f"{name}.{leaf}": getattr(getattr(itm, name), leaf).detach().cpu()
             for name in ("vision_proj", "text_proj", "itm_head") for leaf in ("weight", "bias")}
    blip.load_blip_itm(itm, {**state, **heads})
    require(len(surgery.init_monarch(itm, BLIP_PEFT, generator=torch.Generator().manual_seed(
        SEED + 115))) == BLIP_ADAPTED["itm"], "BLIP ITM: adapted linears")
    scores = {}
    with torch.no_grad():
        for mode, head in (("itm", True), ("contrastive", False)):
            scores[mode] = counted(lambda head=head: blip.BlipITMWrapper(itm, head)(
                batch["input_ids"], batch["pixel_values"],
                attention_mask=batch["attention_mask"])["itm_score"],
                {"monarch_add": BLIP_ADAPTED[mode]}, f"BLIP full ITM ({mode})")
    require(tuple(scores["itm"].shape) == (BLIP_BATCH, 2)
            and tuple(scores["contrastive"].shape) == (BLIP_BATCH, BLIP_BATCH)
            and all(bool(torch.isfinite(v).all()) for v in scores.values())
            and float(scores["contrastive"].abs().max()) <= 1.0 + 1e-5,
            f"BLIP ITM scores {[tuple(v.shape) for v in scores.values()]}")
    del itm, state

    with torch.no_grad():
        def eval_forward():
            return wrapper(batch["input_ids"], batch["pixel_values"],
                           attention_mask=batch["attention_mask"])["decoder_logits"]
        unmerged = eval_forward()
        n_merged = counted(lambda: surgery.merge_all_adapters(model),
                           {"monarch_kernel": BLIP_ADAPTED["qa"]}, "BLIP merge")
        merged, merged_s = timed(lambda: counted(eval_forward, {}, "BLIP merged eval forward"))
        merged_busy = device_busy_ms(lambda k: eval_forward(), 1, "BLIP merged eval forward")
    gap = float((merged - unmerged).abs().max())
    scale = float(unmerged.abs().max())
    require(n_merged == BLIP_ADAPTED["qa"] and gap <= 1e-3 * scale,
            f"BLIP merged: {n_merged} merged, logits off by {gap} at scale {scale}")
    print(f"[blip-full] {card}: ITM (image_text_hidden_size {cfg.image_text_hidden_size}), "
          f"{BLIP_ADAPTED['itm']} adapted: scores {tuple(scores['itm'].shape)} with the ITM "
          f"head, {tuple(scores['contrastive'].shape)} contrastive; {n_merged} adapters merged "
          f"(K1 once each); merged eval forward {merged_s * 1e3:.2f} ms wall, device busy "
          f"{_ms(merged_busy)} ms, decoder logits within {gap:.2e} of the unmerged model's "
          f"(scale {scale:.3e}); launches {dict(launches)}", flush=True)
    del model, wrapper
    shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches)


# The structured layers and ops (phase_structured): each case's module built
# on the CPU from a CPU generator, copied to the card, both run forward and
# backward on the same inputs and cotangent; every output and gradient of
# the card within STRUCT_RTOL of the CPU's scale (float32: the two sum in
# another order, cuFFT against pocketFFT; bfloat16: two ulps, as
# utils/testing.bf16_atol); ButterflyFFT/FFT2 at init within STRUCT_FFT_ATOL
# of torch.fft on the card, as JAX tests/layers/test_structured.py holds
# them.  Timed forward + backward (benchlib.time_ms, STRUCT_TIMING reps and
# rounds).  Widths: RoBERTa-large's FFN (1024 <-> 4096) at the GLUE
# micro-batch, 3 x 512 rows; the FNO settings of neuraloperator's
# fourier_1d.py (Burgers: modes 16, width 64, 8192 / 8 = 1024 points, batch
# 20) and fourier_2d.py (Darcy: modes 12, width 32, s = 85, batch 20).
STRUCT_ROWS = (3, 512)
STRUCT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
STRUCT_FFT_ATOL = 1e-3
STRUCT_TIMING = (10, 3)
STRUCT_SPARSITY = dict(butterfly_size=32, n_factors=2, block=32)


class BlockButterfly(torch.nn.Module):
    """``ops/butterfly.block_butterfly_multiply`` over x (rows, 1, n, bs)
    with a trainable twiddle (1, log2 n, n/2, 2, 2, bs, bs)."""

    def __init__(self, n: int, bs: int, g: torch.Generator):
        super().__init__()
        log_n = int(math.log2(n))
        self.twiddle = torch.nn.Parameter(
            torch.randn(1, log_n, n // 2, 2, 2, bs, bs, generator=g) / math.sqrt(2 * bs))

    def forward(self, x):
        from sparse_matrix_fine_tuning_torch.ops.butterfly import block_butterfly_multiply
        return block_butterfly_multiply(self.twiddle, x)


def structured_cases():
    """(label, module factory on the CPU, input shape, dtype, complex input,
    the torch.fft function the module equals at init or None)."""
    from sparse_matrix_fine_tuning_torch import layers

    rows = STRUCT_ROWS
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n_in, n_out in ((1024, 4096), (4096, 1024)):
            for shuffle in (False, True):
                cases.append((f"BlockdiagLinear {n_in}->{n_out} nblocks 4 shuffle {shuffle} "
                               f"{str(dtype)[6:]}",
                               functools.partial(layers.BlockdiagLinear, n_in, n_out, nblocks=4,
                                                 shuffle=shuffle, param_dtype=dtype, device="cpu"),
                               (*rows, n_in), dtype, False, None))
    for n_in, n_out in ((1024, 4096), (1000, 4000)):
        cfg = layers.FlatBlockButterflySparsityConfig(**STRUCT_SPARSITY)
        cases.append((f"BlockSparseLinear {n_in}->{n_out} butterfly 32, 2 factors, block 32",
                      functools.partial(layers.BlockSparseLinear, n_in, n_out, cfg, device="cpu"),
                      (*rows, n_in), torch.float32, False, None))
    for n in (1024, 4096):
        for direction in ("fft", "ifft"):
            cases.append((f"ButterflyFFT {direction} n {n}",
                          functools.partial(layers.ButterflyFFT, n, direction, device="cpu"),
                          (rows[1], n), torch.complex64, True,
                          functools.partial(getattr(torch.fft, direction), norm="ortho")))
    cases.append(("ButterflyFFT2 64 x 64", functools.partial(layers.ButterflyFFT2, 64, 64,
                                                             device="cpu"),
                  (64, 64, 64), torch.complex64, True,
                  functools.partial(torch.fft.fft2, norm="ortho")))
    cases.append(("block_butterfly_multiply 16 blocks of 64",
                  lambda: BlockButterfly(16, 64, torch.Generator().manual_seed(SEED + 70)),
                  (rows[0] * rows[1], 1, 16, 64), torch.float32, False, None))
    cases.append(("SpectralConv1d Burgers modes 16 width 64, 1024 points, batch 20",
                  functools.partial(layers.SpectralConv1d, 64, 64, 16, device="cpu"),
                  (20, 64, 1024), torch.float32, False, None))
    cases.append(("SpectralConv2d Darcy modes 12 width 32, 85 x 85, batch 20",
                  functools.partial(layers.SpectralConv2d, 32, 32, 12, 12, device="cpu"),
                  (20, 32, 85, 85), torch.float32, False, None))
    return cases


def _fwd_bwd(module, x, cot):
    """(output, [each parameter's gradient], the input's gradient) of
    sum(Re(module(x) * conj(cot)))."""
    x = x.detach().clone().requires_grad_()
    for p in module.parameters():
        p.grad = None
    out = module(x)
    loss = (out * cot.conj()).real.sum() if out.is_complex() else (out.float() * cot).sum()
    loss.backward()
    return out.detach(), [p.grad for p in module.parameters()], x.grad


def _scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.detach().cpu()
    scale = float(want.abs().max())
    return float((got.detach().cpu() - want).abs().max()) / (scale or 1.0)


def phase_structured(card: str) -> dict:
    """The structured layers and ops on the card (no kernel of ours: the
    products are cuBLAS batched matmuls, the transforms cuFFT, as the JAX
    package's are XLA's): ``structured_cases`` card against CPU, forward
    and backward, each timed.  Returns {label: device ms}."""
    times = {}
    for i, (label, make, shape, dtype, cplx, fft) in enumerate(structured_cases()):
        g = torch.Generator().manual_seed(SEED + 80 + i)
        cpu = make()
        module = copy.deepcopy(cpu).to("cuda")
        if cplx:
            x = torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))
        else:
            x = torch.randn(shape, generator=g).to(dtype)
        xc = x.cuda()
        with torch.no_grad():
            probe = module(xc)  # the output's shape and dtype
        cot = torch.complex(torch.randn(probe.shape, generator=g),
                            torch.randn(probe.shape, generator=g)) if probe.is_complex() \
            else torch.randn(probe.shape, generator=g)
        want = _fwd_bwd(cpu, x, cot)
        cotc = cot.cuda()
        got = _fwd_bwd(module, xc, cotc)
        torch.cuda.synchronize()
        tol = STRUCT_RTOL[torch.bfloat16 if dtype == torch.bfloat16 else torch.float32]
        errs = [_scaled_error(got[0], want[0])] + [_scaled_error(a, b) for a, b in
                                                    zip(got[1], want[1])] + \
            [_scaled_error(got[2], want[2])]
        require(got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
                and bool(torch.isfinite(got[0]).all()), f"structured {label}: output "
                f"{got[0].dtype} {tuple(got[0].shape)} against {want[0].dtype}")
        require(max(errs) <= tol, f"structured {label}: card against CPU {errs} (tol {tol})")
        fft_err = None
        if fft is not None:
            with torch.no_grad():
                fft_err = float((module(xc) - fft(xc)).abs().max())
            require(fft_err <= STRUCT_FFT_ATOL, f"structured {label}: {fft_err} from torch.fft")

        def step():
            torch.autograd.backward(module(xc), cotc)

        device_ms, call_ms = time_ms(step, *STRUCT_TIMING)
        times[label] = device_ms
        params = sum(p.numel() for p in module.parameters())
        RECORDS.append({"structured": label, "shape": list(shape), "dtype": str(dtype),
                        "errors": errs, "fft_err": fft_err, "ms": device_ms, "call_ms": call_ms,
                        "params": params, "card": card})
        print(f"[structured] {card}: {label}, x {tuple(shape)} {str(dtype)[6:]}, {params} "
              f"parameters: card against CPU, output and {len(errs) - 1} gradients within "
              f"{max(errs):.2e} of scale (tol {tol:g})"
              + (f", {fft_err:.2e} from torch.fft at init" if fft_err is not None else "")
              + f"; forward + backward {device_ms:.5f} ms device, {call_ms:.5f} ms a call",
              flush=True)
        del module, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return times


def main() -> None:
    t0 = time.perf_counter()

    def lap(tag: str) -> None:
        print(f"[time] {tag} done at {time.perf_counter() - t0:.1f} s", flush=True)

    card = phase_device()
    lib = phase_build()
    fwd = phase_kernels(card)
    bwd = phase_kernels_bwd(card, lib)
    qk = phase_quant_kernels(card, lib)
    attn = phase_attention(card, lib)
    lap("kernels")
    phase_autograd(card)
    phase_quant_autograd(card)
    # serving before the experiments, whose dozen profiler sessions made its
    # quantized decode profiles lose records until benchlib.device_profile
    # padded each session's window (ROADMAP C.10)
    f32 = phase_f32()
    phase_quant_f32(f32, card)
    lap("f32 serving")
    serving = phase_bf16(f32, card)
    qserving = phase_quant_bf16(f32, card)
    del f32
    lap("bf16 serving")
    more = phase_more_linear(card, lib)
    lap("fused dense+Monarch linear")
    tiles = phase_tiles(card, lib)
    lap("forward-tile experiments")
    dws = phase_dw(card)
    lap("dw experiments")
    variants = phase_int4_variants(card)
    lap("int4 dequant variants")
    phase_train_f32(card)
    phase_quant_train_f32(card)
    lap("f32 training")
    training = phase_train_bf16(card)
    splash = phase_train_splash(card, training["losses"])
    lap("bf16 training with splash attention")
    phase_train_remat(card, training["off"])
    lap("bf16 training with remat")
    phase_bench_attention(card)
    lap("attention bench")
    q8training = phase_quant_train_bf16(card, 8)
    q4training = phase_quant_train_bf16(card, 4)
    lap("bf16 training")
    alpaca = phase_alpaca_smoke(card)
    lap("alpaca harness, smoke")
    alpaca_full = phase_alpaca_full(card)
    print(f"[alpaca] launches of the harness's runs: smoke {alpaca}, full width {alpaca_full}",
          flush=True)
    lap("alpaca harness, full width")
    reasoning = phase_reasoning_smoke(card)
    lap("reasoning harness, smoke")
    reasoning_full = phase_reasoning_full(card)
    print(f"[reasoning] launches of the harness's runs: smoke {reasoning}, full width "
          f"{reasoning_full['launches']}", flush=True)
    lap("reasoning harness, full width")
    glue = phase_glue_smoke(card)
    lap("GLUE and AG News harnesses, smoke")
    glue_full = phase_glue_full(card)
    print(f"[glue] launches of the harness's runs: smoke {glue}, full width "
          f"{glue_full['launches']}", flush=True)
    lap("GLUE harness, full width")
    baselines = phase_baselines_smoke(card)
    lap("baselines, projection and search through the harnesses, smoke")
    baselines_full = phase_baselines_full(card, glue_full["checkpoint"])
    print(f"[baselines] launches of the harnesses' runs: smoke {baselines}, full width "
          f"{baselines_full['launches']}", flush=True)
    lap("baselines and projection, RoBERTa-large width")
    reft = phase_reft_smoke(card)
    lap("ReFT, MoReFT GLUE and DAS, smoke")
    reft_full = phase_reft_full(card, reasoning_full["checkpoint"], glue_full["checkpoint"])
    print(f"[reft] launches of the harnesses' runs: smoke {reft}, full width {reft_full}",
          flush=True)
    lap("ReFT and MoReFT GLUE, full width")
    families = phase_families_smoke(card)
    lap("the other decoder families, smoke")
    families_full = phase_families_full(card)
    print(f"[families] launches of the harnesses' runs: smoke {families}, full width "
          f"{families_full}", flush=True)
    lap("the other decoder families, full width")
    blip_smoke = phase_blip_smoke(card)
    lap("BLIP, smoke")
    blip_full = phase_blip_full(card)
    print(f"[blip] launches of the BLIP paths: smoke {blip_smoke}, full width {blip_full}",
          flush=True)
    lap("BLIP, full width")
    phase_structured(card)
    lap("structured layers")
    launches = {"monarch_kernel": serving["launches"]["monarch_kernel"],
                "monarch_add": serving["launches"]["monarch_add"],
                "monarch_bwd": training["launches"]["monarch_bwd"],
                "monarch_dw_fused": training["launches"]["monarch_dw_fused"],
                # the forwards by the kernel that ran them: serving's decode
                # steps (the decode kernel), serving's prefills and the
                # quantized training steps' micro-batches (the wgmma kernel)
                "int8_matmul": qserving["launches"]["int8_matmul"],
                "int8_matmul_tile": qserving["launches"]["int8_matmul_tile"]
                + q8training["launches"]["int8_matmul"],
                "int8_matmul_dx": q8training["launches"]["int8_matmul_dx"],
                "int4_matmul": qserving["launches"]["int4_matmul"],
                "int4_matmul_tile": qserving["launches"]["int4_matmul_tile"]
                + q4training["launches"]["int4_matmul"],
                "int4_matmul_dx": q4training["launches"]["int4_matmul_dx"],
                **more["launches"], **tiles["launches"], **dws["launches"],
                **variants["launches"],
                **{name: splash["launches"][name] for name in ATTN_KERNELS}}
    measured = {**fwd["layer"], **bwd["layer"], **qk["layer"], **more["layer"], **tiles["layer"],
                **dws["layer"], **variants["layer"], **attn["layer"]}
    worst = {**fwd["worst"], **bwd["worst"], **qk["worst"], **more["worst"], **tiles["worst"],
             **dws["worst"], **variants["worst"], **attn["worst"]}
    require(all(launches[name] > 0 for name in KERNELS), f"a kernel never launched: {launches}")
    lines = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
              "launches": launches[name], "max_abs_err": worst[name],
              "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"],
              "bound_ms": measured[name]["bound_ms"], "bound_by": measured[name]["bound_by"],
              "library_ms": measured[name]["library_ms"]}
             for name, (src, replaces) in KERNELS.items()]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "records.json"), "w") as f:
        json.dump({"card": card, "records": RECORDS, "kernels": lines}, f, indent=1)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
