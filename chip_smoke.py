#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card's name and power limit (nvidia-smi), capability 9.0;
  2. build   — every CUDA kernel built from the sources in this checkout;
  3. kernels — each kernel against its plain PyTorch version on the card
               at the serving path's shapes (llama3-8b attention geometry:
               decode, prefill, window, garbage, and a long-context decode
               of 8 tokens at 2048 over pages of their own), each row naming
               its route and split count, with its device time (a CUDA
               graph), the plain version's time and its bound;
  4. reference — llama3-8b at full width, cut to two layers, in fp32: the
               engine's logits on the card against the same engine on the
               CPU (plain attention), step by step, with the host's CPU;
  5. engine  — InferenceEngineV2 for llama3-8b at full width and depth in
               bf16 (random weights from a seed) generates through the
               kernels, with a bf16 and an int8 KV cache; the launch counts
               of that run show the path went through the kernels (every
               launch on the mma route); then a
               profiled generate and the kernel path's logits against the
               gather path's;
  6. server  — InferenceServer answers 8 requests from 4 threads;
  7. train-kernels — flash_fwd, flash_bwd_dq, flash_bwd_dkv and fused_adamw
               against their plain versions at the training path's shapes
               (gpt2-350m and llama3-8b attention geometry, a sliding
               window, a tail, a bidirectional windowed GQA case at D 128,
               fp32 bodies; AdamW over every gpt2-350m leaf, bit for bit),
               with times, bounds and library times (the three flash
               kernels beside SDPA's forward and backward in the same
               call), each row naming the route its kernel took (wgmma for
               bf16, fma for fp32);
  8. train-reference — gpt2-350m width cut to two layers, fp32: two
               train_batch steps on the card against the same engine on
               the CPU (loss, grad norm, params);
  9. train   — gpt2-350m at full width and depth in bf16 with the bench
               row's step (micro 8, gas 8, seq 1024, AdamW, clip 1.0,
               ZeRO-1): a warm-up step, then three timed steps whose launch
               counts show the path ran the kernels, every flash_fwd,
               flash_bwd_dq and flash_bwd_dkv on its wgmma route; a
               profiled step; one
               step with remat "nothing_saveable" (the forward reruns);
 10. sparse-kernels — bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv against their
               plain versions: the sparse path's shape and layout, Fixed,
               BigBird with per-head layouts, llama3-8b geometry with GQA,
               a bidirectional case with 128-token blocks and an fp32
               case, each with its time, its bound from the layout's live
               pairs, and scaled_dot_product_attention under the expanded
               mask as the library time;
 11. lion-kernel — fused_lion over every gpt2-350m fp32 leaf, bit for bit;
 12. train-sparse-reference — phase 8 with block-sparse attention
               (DeepSpeed's BSLongformer layout, causal) and Lion;
 13. train-sparse — phase 9's step with block-sparse attention and Lion
               (lr 3e-5, betas 0.9/0.99, weight decay 0.1): a warm-up
               step, three timed steps whose launch counts show the
               block-sparse and Lion kernels (all three on their wgmma
               routes) and no flash kernel, and a profiled step;
 14. linear-kernels — quantize, dequantize and fake_quantize bit for bit
               against their plain versions (llama3-8b projection weights,
               bf16 int8/int4 at group 512, fp32 at group 128, a row tail,
               a 1-D tensor) and fp6_matmul within tolerance (decode-sized
               and the path's M, M 7, bf16 and fp32 activations), with
               times, bounds and, for fp6_matmul, torch.matmul against the
               dequantized bf16 weight as the library time, each row
               naming its route (wgmma for bf16, fma for fp32);
 15. linear-reference — a LoRAStack (residual SwiGLU MLP blocks whose
               projections are OptimizedLinears over quantized frozen
               bases, adapters trained by a duck-typed engine) cut to
               hidden 512, intermediate 1024, 2 blocks, fp32: two
               train_batch steps on the card against the CPU, for q_bits
               4, 6 and 8;
 16. linear-train — the LoRAStack at llama3-8b width (hidden 4096,
               intermediate 14336), 4 blocks, bf16 bases of q_bits 6 (the
               FP6 GEMM carries the forward) and 8 (the dequantize kernel
               runs before each base product): a warm-up step, three timed
               steps whose launch counts show the kernels and no attention
               kernel, every FP6 GEMM on its wgmma route, and a profiled
               step, per q_bits;
 17. ring-kernels — ring_carry, ring_bwd_dq and ring_bwd_dkv against their
               plain versions: the path's shape (llama3-8b attention
               geometry, 4096 tokens a rank) for the diagonal and the
               neighbour's hop under striped placement and the diagonal and
               a fully live hop under contiguous placement, timed beside
               the plain versions, their bounds and SDPA under the hop's
               position mask; MHA d 64, a sliding window, a non-causal hop,
               a 1000-row shard and fp32; every row names its kernel's
               route (wgmma for bf16, fma for fp32); then a whole two-rank
               ring at S_l 1024, both placements, on the wgmma route: each
               rank's carried hops, normalised once, against flash_fwd_ref,
               and each rank's dq and the dk/dv carried back to their
               block's owner against flash_bwd_ref, over the unsplit 2048
               positions;
 17c. fpdt-kernel — chunked_attention with K/V parked in pinned host
               memory at llama3-8b's heads (bf16, seq 32768, chunk 4096,
               causal), forward and backward: one launch of each ring hop
               kernel a live chunk pair (36 each, wgmma), against
               flash_attention and (forward) its plain version, with peak
               memory and times;
 18. ring-reference — the ring engine (llama3-8b head geometry at hidden
               1024, 2 layers, fp32, seq 512, ZeRO-2 over the seq axis) in
               two ranks sharing the card over gloo against the same engine
               in this process on the CPU at sp 1, two steps, both
               placements, with each rank's launches; the same card ranks
               at ring_interleave 2 give the bits of interleave 1 on the
               fp32 and the int8 wire; then in
               the same card ranks and two CPU ranks, ulysses-reference
               (that model with seq_impl "ulysses", untiled and with loss
               tiles, card against CPU ranks, all_to_all bytes, launches)
               and fpdt-reference (FPDTAttention over the ranks);
 18b. mesh-reference — that engine in four ranks sharing the card over
               gloo at {"data": 2, "seq": 2} (striped), ZeRO stages 1, 2
               and 3 in one launch, against one CPU engine at data 1 on the
               same global batch: losses, grad norms, params, launches;
 19. ring-train — llama3-8b at full width, 2 layers, seq 8192 striped over
               two ranks sharing the card (bench.py's longseq_ring step:
               micro 1, gas 2, bf16, AdamW, clip 1.0, ZeRO-2 over the seq
               axis, loss_tiles 32; ring_interleave 2): a warm-up step, one
               timed step whose launch counts a rank show the ring
               kernels, AdamW and nothing else, every carry, dq and dk/dv
               launch on its wgmma route, the flat buckets the gradients
               are reduced through, peak memory a rank, and a profiled
               step on rank 0 (device busy share, and the host time inside
               the comm layer's ranges); then, in the same ranks,
               ring-train-int8 (the int8 wire, interleave 1) and
               ulysses-train (seq_impl "ulysses": the flash kernels on
               wgmma, all_to_all bytes a step, MFU);
 20. gemm-kernels — gather_matmul (the ZeRO-3 fused MLP's GEMM) against
               its plain version in bf16 and fp32: the gpt2-350m MLP at
               micro 8 x seq 1024 (forward wi and wo, and the backward's
               dx = g·wᵀ and dw = xᵀ·g through transposed views), llama3-8b
               width SwiGLU (M 4096, K 4096 <-> N 14336) and the JAX test's
               ragged shapes, with times, bounds, torch.matmul as the
               library time and the route each case took (wgmma, or mma
               where TMA cannot read an operand, fma for fp32);
 21. zero-reference — gpt2-350m width cut to 2 layers, fp32, in two ranks
               sharing the card over gloo ({"mesh": {"data": 2}}, micro 2 x
               seq 256 a rank, gas 2) at ZeRO stages 1, 2, 3, 3 with the
               fused gather-matmul, 3 with the gather window at depth 2
               and one-layer gradient buckets, and 3 with the int8 weight
               gather (qwZ), against the same engine in this process on
               the CPU at data 1 (ZeRO-3 with qwZ for the qwZ config):
               losses, grad norms and the gathered params after two steps,
               and each rank's launches (gather_matmul only in the fused
               run);
 22. zero3-train — gpt2-350m at full width, depth cut to 4 layers, under
               ZeRO-3 with the fused gather-matmul over two ranks sharing
               the card (bench.py's ZeRO-3 row: micro 8 a rank, seq 1024,
               bf16, AdamW, clip 1.0, persistence 0, gather_prefetch_depth
               2; gas 2): a warm-up step, one timed step whose
               launch counts a rank show gather_matmul, flash, AdamW and
               nothing else, every GEMM and attention kernel on the wgmma
               route, and a profiled step on rank 0 (device busy
               share, host time inside comm.all_gather, comm.reduce_scatter
               and comm.all_reduce);
 23. ckpt-train — gpt2-350m at full width, depth cut to 4 layers (the
               train phase's step, gas 1): two steps, a save through each
               writer (pickle, its ds_to_universal, fast, decoupled), two more
               steps; a fresh engine loads each form and takes the same
               two steps, bit for bit (losses and every master leaf), with
               bytes, save and load seconds and GB/s, and the decoupled
               save's blocking time;
 24. ckpt-zero3 — zero3-train's config (gas 1) over two ranks: a step,
               the save (every slice gathered), a step; the pickle resumes
               at data 2 bit for bit; then the 2-layer fp32 model saved
               at data 2 and converted to universal resumes at data 1 on
               the card and on the CPU (ckpt-zero3-shrink);
 24b. zeropp-reference — the zero-reference model (2 layers, fp32, micro
               1 x seq 32 a rank, gas 2, one step, qgZ two) in four ranks
               sharing the card
               over gloo at {"data": 4} factored into outer 2 x inner 2:
               hpZ 2 at ZeRO-3, MiCS 2 at ZeRO-2 and 3, hpZ 2 with the qwZ
               int8 gather, two-level qgZ at ZeRO-1 under hpZ 2, each
               against the same config in four CPU ranks (losses, grad
               norms, gathered params; qgZ's update bound), launches
               (quantize/dequantize 2/2 a step under qgZ), hpZ's weight
               gathers over the inner group only, the bytes a step by
               group (inner, outer, world);
 24c. zeropp-train — gpt2-350m at full width and depth in the same four
               ranks (bf16, AdamW, clip 1.0, seq 1024, micro 4 x gas 2 a
               rank, gather_prefetch_depth 2, remat none), each run a
               warm-up step and timed steps: hpZ 2 at ZeRO-3 (two), MiCS 2
               at ZeRO-3 and two-level qgZ (8 layers each; one): seconds,
               tokens/s, MFU, peak and reserved memory a rank, collectives
               and bytes a step by group, launches a step (flash layers x
               gas, AdamW 1 or qgZ's quantize/dequantize 2/2, no
               gather_matmul), and a profiled step on rank 0 each;
 25. recovery — RecoverySupervisor runs the port's worker on the card
               (gpt2-350m, two gloo ranks at data 2); rank 0 dies after
               step 2, before its save, the group restarts at data 1 from
               the step-1 universal checkpoint: the outage seconds, the
               steps lost and the resumed losses against an unkilled run.
 26. dp-quant-kernels — quantize and dequantize against their plain
               versions at the data axis's gradient-reduction shapes: the
               fp32 [2, m] chunks of gpt2-350m's padded gradient at data 2
               in groups of 256 (grad_reduce) and in qgZ's group (2048,
               or the whole chunk where 2048 does not divide it, as the
               JAX ``_quant_chunked_reduce``), timed beside the plain
               versions and the bytes bound;
 27. dp-quant-reference — the zero-reference model (gpt2-350m width, 2
               layers, fp32) in two ranks sharing the card over gloo
               against two ranks on the CPU, for grad_reduce int8 with and
               without error feedback, fp8 and fp32 spelled out, qgZ, the
               three 1-bit optimizers (freeze_step 1: a compressed step
               runs), the decomposed update and it with the fused
               reduce-scatter, seq 32, two steps: losses, params (bounds
               set between the sound readings and planted faults',
               tools/dp_quant_faults.py), launches;
 28. dp-quant-train — bench.py's row_gpt2_350m_commquant step (gpt2-350m
               at full width and depth, seq 1024, micro 8 a rank, bf16,
               AdamW lr 1e-4, clip 1.0, ZeRO-1, grad_reduce int8 with
               error feedback) over two ranks sharing the card, then in
               the same ranks qgZ and OnebitAdam: a warm-up step and one
               timed step each (seconds, peak memory a rank, grad-reduce
               wire bytes a step against the row's fp32 control's,
               computed since the control run was cut, quantize and
               dequantize launches a step) and a profiled step on rank 0
               (idle share, host ms in all_to_all and all_gather).
Then the ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result; so does a machine without CUDA or a directory without the port.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor rate,
# fp32 outside the tensor cores (the flash kernels' fp32 bodies)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

MODEL = "llama3-8b"
ENGINE_CFG = {"memory_config": {"num_blocks": 1024, "block_size": 16},
              "max_context": 2048}
# kernel vs plain version, bf16 output: about two bf16 ulps, relative
KERNEL_RTOL = 2.0 ** -7
# logits through the kernel vs through paged_gather (both bf16 on the
# card): the gather path rounds q.k to bf16 before its softmax, the kernel
# keeps fp32 scores; 32 layers compound that rounding
LOGITS_RTOL = 0.1
# card vs CPU in fp32 (phase 4): the two differ in summation order only
# (cuBLAS vs CPU GEMMs over K up to 14336, kernel vs plain page walk)
REF_LAYERS = 2
REF_RTOL = 1e-4

TRAIN_MODEL = "gpt2-350m"
# bench.py row_gpt2_350m's step, on one device; remat "none" stands in for
# "dots_flash_saveable" (not ported): same numbers, more memory
TRAIN_CFG = {"train_micro_batch_size_per_gpu": 8,
             "gradient_accumulation_steps": 8,
             "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
             "bf16": {"enabled": True},
             "zero_optimization": {"stage": 1},
             "gradient_clipping": 1.0,
             "steps_per_print": 10_000,
             "activation_checkpointing": {"remat_policy": "none"}}
TRAIN_SEQ = 1024
TRAIN_STEPS = 3
# flash kernels vs plain versions, by the output's dtype: bf16 outputs
# about two ulps (other summation order before p, ds and the outputs
# round), fp32 outputs (lse in every case) summation order only
FLASH_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
# slice 3: the same step with DeepSpeed's BSLongformerSparsityConfig
# defaults (unidirectional, as a causal LM uses) and Lion
SPARSE = {"mode": "bslongformer", "block": 16, "num_sliding_window_blocks": 3,
          "global_block_indices": [0], "attention": "unidirectional"}
SPARSE_TRAIN_CFG = {**TRAIN_CFG, "optimizer": {
    "type": "Lion", "params": {"lr": 3e-5, "betas": [0.9, 0.99],
                               "weight_decay": 0.1}}}
# kernel name -> the parts of its name in a profiler trace: the attention
# roles are one template each, told apart by their mask policy; the three
# flash kernels, the three ring kernels, the three block-sparse kernels,
# fp6_matmul and gather_matmul on the main path are their wgmma kernels
# (flash, ring and block-sparse one template a role, three mask policies)
PROFILE_NAMES = {
    "ring_carry": ("attn_fwd_wgmma_kernel", "RingOffsets"),
    "ring_bwd_dq": ("attn_bwd_dq_wgmma_kernel", "RingOffsets"),
    "ring_bwd_dkv": ("attn_bwd_dkv_wgmma_kernel", "RingOffsets"),
    # the int8 lanes: the wgmma walks over int8 K/V (kernels of their own
    # names)
    "ring_carry_int8": ("attn_fwd_wgmma_s8_kernel", "RingOffsets"),
    "ring_bwd_dq_int8": ("attn_bwd_dq_wgmma_s8_kernel", "RingOffsets"),
    "ring_bwd_dkv_int8": ("attn_bwd_dkv_wgmma_s8_kernel", "RingOffsets"),
    "flash_fwd": ("attn_fwd_wgmma_kernel", "CausalWindow"),
    "flash_bwd_dq": ("attn_bwd_dq_wgmma_kernel", "CausalWindow"),
    "flash_bwd_dkv": ("attn_bwd_dkv_wgmma_kernel", "CausalWindow"),
    "bsa_fwd": ("attn_fwd_wgmma_kernel", "BlockLayoutT"),
    "bsa_bwd_dq": ("attn_bwd_dq_wgmma_kernel", "BlockLayout"),
    "bsa_bwd_dkv": ("attn_bwd_dkv_wgmma_kernel", "BlockLayout"),
    "fused_adamw": ("fused_adamw_kernel",),
    "fused_lion": ("fused_lion_kernel",),
    "fp6_matmul": ("fp6_wgmma_kernel",),
    "dequantize": ("dequant_kernel",),
    "gather_matmul": ("gemm_wgmma_kernel",)}
# slice 11: head dims off the kernels' 64/128 lanes, at the registry's
# geometries (one sequence; D 32 the *-tiny configs'): name, b, hq, hkv, S, D.
# Flash runs them causal, the ring hop as the striped path's hop 1 on S/2 a
# rank, block-sparse under the training path's BSLongformer layout; bf16
# and fp32, bf16 timed.
HEAD_DIM_CASES = [
    ("tiny-d32", 2, 4, 4, 256, 32),
    ("phi-2", 1, 32, 32, 2048, 80),
    ("gptneox-20b", 1, 64, 64, 2048, 96),
    ("gptj-6b", 1, 16, 16, 2048, 256),
]
# train-reference-d80: phi-2 (head_dim 80, padded to the 128 lane) at its
# width, 2 layers, fp32, card vs CPU as the train-reference phase does, at
# seq 512 to keep the CPU's steps short
D80_MODEL = "phi-2"
D80_SEQ = 512
# slice 4: LoRA adapters over quantized llama3-8b-width MLP bases
LINEAR_MODEL = "llama3-8b"
LINEAR_BLOCKS = 4
LINEAR_GROUP = 512
LINEAR_SEQ = 512
LINEAR_CFG = {"train_micro_batch_size_per_gpu": 8,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
              "gradient_clipping": 1.0,
              "steps_per_print": 10_000}
PROJ = ("gate", "up", "down")
# A block with no norm is quadratic in its input: at hidden 4096 and
# intermediate 14336 with std-0.02 weights it adds about 2·std(h)^2 to h,
# so unit-variance inputs compound to ~1e6 over 4 blocks (losses ~1e13).
# Inputs of std 0.1 keep h near 0.1 through the stack.
LINEAR_X_STD = 0.1
# The full-width first step (bf16 activations, 8 mantissa bits, through
# 4 blocks) against the same step in fp32 with plain ops: relative L2 of
# the adapters' update and relative error of the grad norm.  At lr 1e-4 the
# loss moves less than one bf16 step of h, so this, not the loss, shows
# that the update is the right one.
LINEAR_UPDATE_RTOL = 0.05


# slice 5: ring sequence parallelism.  bench.py _longseq_ring_body's step
# (llama-class d-128 GQA, seq_impl "ring", striped, AdamW, bf16, clip 1.0,
# a 4096-token shard a rank) on llama3-8b at its registered width, depth
# cut to 2 layers (each rank holds fp32 masters, grads and AdamW state of
# 1.48 G parameters, ~27 GB, so two ranks fit one card), seq 8192
# (llama3-8b's max_seq_len) over two ranks sharing the card, at the row's
# ZeRO stage 2 over the seq axis (state and gradients split over the two
# ranks, each micro-step's gradients reduce-scattered through the flat
# buckets).  The row's loss_tiles=32 runs tiled (ALST's tiled loss), the
# fp32 wire at step_schedule.ring_interleave 2 (each hop's rotation in
# flight while it attends), the int8 wire at 1.  One timed step (two
# before the dp-quant phases joined the script, three before
# mesh-reference).
RING_MODEL = "llama3-8b"
RING_RANKS = 2
RING_BACKEND = "gloo"     # NCCL refuses two ranks on one GPU
RING_LAYERS = 2
RING_SEQ = 8192
RING_STEPS = 1
RING_LOSS_TILES = 32
RING_MODEL_KW = {"num_layers": RING_LAYERS, "seq_impl": "ring",
                 "ring_placement": "striped", "loss_tiles": RING_LOSS_TILES}
RING_CFG = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2},
            "gradient_clipping": 1.0,
            "steps_per_print": 10_000,
            "activation_checkpointing": {"remat_policy": "none"},
            "mesh": {"seq": RING_RANKS}}
RING_I2_CFG = {**RING_CFG, "step_schedule": {"ring_interleave": 2}}
# ring-train's untiled, interleave-1 baselines as PERF.md records them
# (the peak a rank at ZeRO-2; the ring_rotate host ms of two profiles)
RING_BASELINE = {"max_memory_allocated_gib": 30.1,
                 "ring_rotate_host_ms": [660.9, 675.3]}
# ulysses-train, ring-train's step with seq_impl "ulysses"
# (contiguous shards: Ulysses' all-to-alls around the flash kernels) in the
# same launch, one timed step
ULYSSES_MODEL_KW = {"num_layers": RING_LAYERS, "seq_impl": "ulysses",
                    "loss_tiles": RING_LOSS_TILES}
ULYSSES_STEPS = 1
# fpdt-kernel: chunked_attention on the ring's hop kernels, llama3-8b's
# heads, bf16, K/V parked in pinned host memory: 8 causal chunks launch
# 36 of each hop kernel forward and backward
FPDT_KERNEL = {"b": 1, "hq": 32, "hkv": 8, "s": 32768, "d": 128,
               "chunk": 4096}
# ring-reference: llama3-8b's head dim 128 and GQA group 4 at a width the
# CPU run keeps short
RING_REF_MODEL = {"hidden_size": 1024, "num_heads": 8, "num_kv_heads": 2,
                  "intermediate_size": 3584, "vocab_size": 32000,
                  "num_layers": 2}
RING_REF_SEQ = 512
RING_REF_STEPS = 2
# ulysses-reference, the ring-reference model with seq_impl
# "ulysses" in the same two card ranks and two CPU ranks, untiled and with
# 64-token loss tiles, to ZERO_REF_RTOL / ZERO_REF_PARAMS_RTOL; and
# FPDTAttention over those ranks (chunks of 128 of the 512 positions, K/V
# parked on the host), card against CPU to FLASH_RTOL
ULYSSES_REF = {"untiled": {}, "tiled": {"loss_tiles": 8}}
FPDT_REF_CHUNK = 128
# slice 17: mesh-reference, the ring-reference model in four gloo ranks
# sharing the card at data 2 x seq 2 (ZeRO over both axes), striped, at
# these stages in one launch, against one CPU engine at data 1 (micro 2,
# the same global rows) to ZERO_REF_RTOL / ZERO_REF_PARAMS_RTOL
MESH_REF_MESH = {"data": 2, "seq": 2}
MESH_REF_STAGES = (1, 2, 3)
# slice 13: the quantized ring wire (comm_quantization.ring_rotation).  The
# ring-train-int8 phase is RING_CFG with the int8 wire; ring-reference-int8
# and -fp8 are the ring-reference phase with that wire, card ranks against
# CPU ranks (both encode alike).  Their first step's loss and grad norm are
# held to REF_RTOL; the second step's and the params after it to
# RING_WIRE_REF_RTOL: the traveling dk/dv re-encode every hop, so an
# element whose sum lies on a rounding boundary of the wire may land one
# wire step apart on the two devices, and AdamW's first step turns that into
# an update of up to lr on a near-zero gradient element.
RING_WIRES = ("int8", "fp8")
# the wires ring-reference's card ranks also run at ring_interleave 2, each
# held bit for bit to its interleave-1 run (the int8 one on rows 8b-10b)
RING_I2_WIRES = ("fp32", "int8")
# ring-train-int8's timed steps (the phase costs ~13 s a step at ZeRO-2,
# gloo's collectives most of it; two before the dp-quant phases joined)
RING_WIRE_STEPS = 1
RING_WIRE_REF_RTOL = 1e-3
# the int8 K/V lanes against their plain versions (which decode the rows and
# compute in fp32): bf16 q 2^-10 (the lanes' products are exact or fp32 up
# to summation order; p and ds enter them as two bf16 parts, about 16
# bits), fp32 q 1e-4 (summation order)
RING_INT8_RTOL = {"bfloat16": 2.0 ** -10, "float32": 1e-4}
# slices 14-15: each ring kernel's int8 lane for bf16 q at D 64/128 over
# views TMA reads (all three on their wgmma walks); fp32 q takes fma_s8 and
# D 256 mma_s8 in every kernel
RING_INT8_ROUTES = {"ring_carry": "wgmma_s8", "ring_bwd_dq": "wgmma_s8",
                    "ring_bwd_dkv": "wgmma_s8"}

# slice 6: ZeRO-3 over a data axis.  bench.py's ZeRO-3 row (_autosched_body
# with the fused variant of _autosched_fused_ab): gpt2-350m, seq 1024, micro
# 8 a rank, bf16 over fp32 masters, AdamW lr 1e-4, clip 1.0, ZeRO 3,
# persistence 0, fused gather-matmul.  Cut: data 8 -> 2 ranks sharing the
# card over gloo; gas 8 -> 2 (every collective is staged through the host);
# remat dots_flash_saveable -> none (A13).  gather_prefetch_depth 2 runs
# (the ZeRO-3 gather window, zero.Window).
ZERO_RANKS = 2
ZERO_BACKEND = "gloo"     # NCCL refuses two ranks on one GPU
# one timed step, cut from three for time (PERF.md keeps their spread),
# at ZERO_LAYERS layers, cut from 24 for time (PERF.md keeps the
# full-depth steps, profiles and ckpt-zero3 saves)
ZERO_STEPS = 1
ZERO_LAYERS = 4
ZERO_CFG = {"train_micro_batch_size_per_gpu": 8,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3, "param_persistence_threshold": 0},
            "gradient_clipping": 1.0,
            "steps_per_print": 10_000,
            "activation_checkpointing": {"remat_policy": "none"},
            "step_schedule": {"fused_gather_matmul": True,
                              "gather_prefetch_depth": 2},
            "mesh": {"data": ZERO_RANKS}}
# zero-reference: 2 layers, fp32, micro 2 x seq 256 a rank; the ZeRO
# configs the card's ranks run against one CPU engine at data 1: name ->
# (stage, fused gather-matmul, the config's extra keys).  stage3-prefetch2
# runs the gather window at depth 2 with buckets of one layer's gradients
# (its element count); stage3-qwz the int8 weight gather (qwZ), whose CPU
# engine at data 1 takes the same codec's round trip on every leaf
ZERO_REF_LAYERS = 2
ZERO_REF_SEQ = 256
ZERO_REF_MICRO = 2
ZERO_REF_STEPS = 2
ZERO_REF_CONFIGS = {
    "stage1": (1, False, {}), "stage2": (2, False, {}),
    "stage3": (3, False, {}), "stage3-fused": (3, True, {}),
    "stage3-prefetch2": (3, False, {
        "step_schedule": {"gather_prefetch_depth": 2},
        "zero_optimization": {"reduce_bucket_size": "one layer"}}),
    "stage3-qwz": (3, False, {"zero_optimization": {
        "zero_quantized_weights": True}})}
# card (cuBLAS, the kernels) vs CPU (plain versions) in fp32: losses and
# grad norms, and the params' relative L2 after two steps
ZERO_REF_RTOL = 1e-5
ZERO_REF_PARAMS_RTOL = 1e-6
# gather_matmul vs its plain version: bf16 outputs elementwise
# |k - r| <= rtol (1 + |r|) (about two bf16 ulps), fp32 outputs
# max |k - r| <= rtol max |r| (summation order only: an element's error
# follows the partial sums over K, so one that cancels to near zero is held
# to the output's scale)
GEMM_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}

# slice 16: checkpoints and recovery, written under build/ (ignored by git)
CKPT_ROOT = ROOT / "build" / "ckpt_smoke"
# ckpt-train: the train phase's step at full width (bf16 over fp32
# masters, AdamW, seq 1024), gas cut 8 -> 1 and depth 24 -> CKPT_LAYERS
# for time (PERF.md keeps the full-depth saves and loads); CKPT_STEPS
# steps before the saves and as many after, in the uninterrupted run and
# in each resumed one
CKPT_CFG = {**TRAIN_CFG, "gradient_accumulation_steps": 1}
CKPT_STEPS = 2
CKPT_LAYERS = 4
CKPT_FORMS = ("pickle", "universal", "fast", "decoupled")
# ckpt-zero3: in the zero3-train ranks after their steps (ZERO_CFG), a
# save, its universal conversion, one step after them, and a resume from
# each form at data 2 (a ZeRO-3 step over gloo is host-bound); its
# elastic shrink is the zero-reference model (2 layers, fp32) saved at
# data 2 and resumed at data 1, card against the CPU and against the
# data-2 continuation to ZERO_REF_RTOL / ZERO_REF_PARAMS_RTOL
CKPT_ZERO_STEPS = 1
CKPT_ZERO_FORMS = ("pickle", "universal")
# recovery: RecoverySupervisor runs the port's worker on the card, two
# gloo ranks (hosts) at data 2, gpt2-350m at its registry config (the
# worker's defaults: fp32, AdamW lr 1e-3, ZeRO 2); rank 0 dies after step
# RECOVERY_DIE_AT (before its save), the survivors' plan is data 1.  The
# resumed losses are held to the unkilled run's (at data 2) within
# RECOVERY_LOSS_ATOL, the JAX chaos test's bound: fp32 at another data
# axis is another summation order.  Two steps: the first saved, the
# second lost and run again after the resume
RECOVERY_STEPS = 2
RECOVERY_DIE_AT = 2
RECOVERY_SEQ = 1024
RECOVERY_BATCH = 8
RECOVERY_LOSS_ATOL = 2e-3
# dp-quant (slice 19): the data axis's quantized gradient reduction.
# dp-quant-train is bench.py row_gpt2_350m_commquant's step: gpt2-350m,
# seq 1024, micro 8 a rank, bf16 over fp32 masters, AdamW lr 1e-4, clip
# 1.0, ZeRO-1, comm_quantization.grad_reduce int8 (error feedback on).
# Cuts: data 8 -> 2 ranks sharing the card over gloo, gas 8 -> 2, remat
# dots_flash_saveable -> none (A13).  The same ranks then run qgZ and
# OnebitAdam (freeze_step 1).  The row's explicit fp32-wire control
# (DPQ_RUNS["fp32"], still the multicard probe's) is cut from the one-card
# phase for time: its wire is computed from the padded buffer (the bytes
# the control moved when it ran) and PERF.md keeps its steps.
DPQ_RANKS = 2
DPQ_BACKEND = "gloo"      # NCCL refuses two ranks on one GPU
DPQ_STEPS = 1             # timed, after one warm-up step (cut from two)
DPQ_CFG = {"train_micro_batch_size_per_gpu": 8,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
           "bf16": {"enabled": True},
           "zero_optimization": {"stage": 1},
           "gradient_clipping": 1.0,
           "steps_per_print": 10_000,
           "activation_checkpointing": {"remat_policy": "none"},
           "mesh": {"data": DPQ_RANKS}}
DPQ_RUNS = {
    "int8": {"comm_quantization": {"enabled": True, "grad_reduce": "int8"}},
    "fp32": {"comm_quantization": {"enabled": True, "grad_reduce": "fp32"}},
    "qgz": {"zero_optimization": {"stage": 1,
                                  "zero_quantized_gradients": True}},
    "onebitadam": {"optimizer": {"type": "OnebitAdam", "params": {
        "lr": 1e-4, "freeze_step": 1}}}}
# quantize / dequantize launches a step a rank: grad_reduce int8 with error
# feedback encodes twice (reduce-scatter, all-gather) and decodes three
# times (its residual, the received chunks, the gathered shard); one-level
# qgZ once each; the fp32 wire and the 1-bit wire (plain PyTorch, as the
# JAX module) none
DPQ_QUANT_LAUNCHES = {"int8": (2, 3), "fp32": (0, 0), "qgz": (1, 1),
                      "onebitadam": (0, 0)}
DPQ_TRAIN_RUNS = ("int8", "qgz", "onebitadam")
# dp-quant-reference: the zero-reference model (gpt2-350m width, 2 layers,
# fp32: 2048 divides qgZ's chunk) at micro 1 x seq 32 a rank, gas 2, two
# steps (the 1-bit optimizers' warm-up and a compressed step), lr 1e-4;
# card ranks against CPU ranks.  The CPU side, the plain versions over 78M
# gradients, sets the phase's time: its configs run in DPQ_REF_CPU_LAUNCHES
# launches of two ranks side by side (on 8 cores: 122 s in one launch of
# two 4-thread ranks, 83 s in two of 2-thread ranks, at seq 64; 67 s at
# seq 32): name -> the config's extra keys
DPQ_REF_SEQ = 32
DPQ_REF_CPU_LAUNCHES = 2
DPQ_REF_MICRO = 1
DPQ_REF_STEPS = 2
DPQ_REF_CONFIGS = {
    "int8-ef": {"comm_quantization": {"enabled": True, "grad_reduce": "int8"}},
    "int8-no-ef": {"comm_quantization": {"enabled": True, "grad_reduce": "int8",
                                         "error_feedback": False}},
    "fp8": {"comm_quantization": {"enabled": True, "grad_reduce": "fp8"}},
    "fp32-explicit": {"comm_quantization": {"enabled": True,
                                            "grad_reduce": "fp32"}},
    "qgz": {"zero_optimization": {"stage": 1,
                                  "zero_quantized_gradients": True}},
    **{name: {"optimizer": {"type": name, "params": {"lr": 1e-4,
                                                     "freeze_step": 1}}}
       for name in ("OnebitAdam", "OnebitLamb", "ZeroOneAdam")},
    "decomposed": {"step_schedule": {"weight_update": "decomposed"}},
    "decomposed-fused-rs": {"zero_optimization": {"stage": 1},
                            "step_schedule": {"weight_update": "decomposed",
                                              "fused_reduce_scatter": True}}}
# card (kernels, cuBLAS) vs CPU (plain versions) in fp32: the losses, and
# the params' distance over the update's L2 norm (the CPU tests' bound
# against the JAX engine: 1e-3, and 5e-3 on the int8 wires, whose
# quantization turns a summation-order difference on a rounding boundary
# into one wire step; qgZ 2e-2: its blocks are 8x longer, so such a step is
# coarser, and nothing feeds it back; seen 8.0e-3 here).  The 1-bit
# optimizers: after a one-step warm-up the variance of every element no
# token of the batch reaches (most embedding rows, the key bias) is zero
# or rounding noise, so the compressed step moves it by +-scale / eps,
# whose sign card and CPU may round apart, and so does every element whose
# momentum sits within rounding of zero (each flipped element lands twice
# its step away): the layers but the key bias are held at
# DPQ_REF_ONEBIT_RTOL (seen 1.15e-2 to 1.42e-2) and the whole tree at
# DPQ_REF_ONEBIT_WHOLE_RTOL (seen 7.0e-3 to 0.292).  Planted faults
# (tools/dp_quant_faults.py, H100 80GB HBM3, 700 W) read 0.383 to 0.386 on
# the held layers and 1.247 to 1.260 on the whole tree (a peer's momentum
# dropped, the received scales swapped), qgZ 0.781 (a peer's chunk
# dropped) and 0.475 (its wire at the int4 range): every bound sits
# between the sound reading and the faults'.  A zeroed server error reads
# as the sound run: the one compressed step never reads it
# (tests/test_torch_dp_compression.py holds the error states)
DPQ_REF_RTOL = 1e-5
DPQ_REF_ONEBIT_RTOL = 5e-2
DPQ_REF_ONEBIT_WHOLE_RTOL = 0.6
DPQ_REF_UPDATE_RTOL = {"int8-ef": 5e-3, "int8-no-ef": 5e-3, "qgz": 2e-2}
DPQ_REF_UPDATE_RTOL_DEFAULT = 1e-3

# zeropp: hierarchical ZeRO++ over a data axis of four ranks
# factored into outer 2 x inner 2 (hpZ's secondary partition, MiCS's
# sub-groups, two-level qgZ), four gloo ranks sharing the card.
# zeropp-reference: the zero-reference model (gpt2-350m width, 2 layers,
# fp32) at micro 1 x seq 32 a rank, gas 2, card ranks against the same
# config in CPU ranks (ZPP_REF_CPU_LAUNCHES launches of four, in threads
# beside them), one step (two for qgZ, whose bound is over two): name ->
# the zero_optimization block (persistence 0)
ZPP_RANKS = 4
ZPP_BACKEND = "gloo"      # NCCL refuses two ranks on one GPU
ZPP_REF_SEQ = 32
ZPP_REF_MICRO = 1
ZPP_REF_CPU_LAUNCHES = 2
ZPP_REF_STEPS = {"qgz-hpz": 2}      # else 1
ZPP_REF_CONFIGS = {
    "hpz3": {"stage": 3, "zero_hpz_partition_size": 2},
    "mics2": {"stage": 2, "mics_shard_size": 2},
    "mics3": {"stage": 3, "mics_shard_size": 2},
    "hpz3-qwz": {"stage": 3, "zero_hpz_partition_size": 2,
                 "zero_quantized_weights": True},
    "qgz-hpz": {"stage": 1, "zero_hpz_partition_size": 2,
                "zero_quantized_gradients": True}}
# quantize/dequantize launches a step a rank: two-level qgZ encodes and
# decodes once a level
ZPP_QUANT_LAUNCHES = {"qgz-hpz": (2, 2)}
# zeropp-train: gpt2-350m at full width and depth, bf16 over fp32 masters,
# AdamW lr 1e-4, clip 1.0, seq 1024, micro 4 x gas 2 a rank (32 rows a
# step, zero3-train's 2 ranks x micro 8), gather_prefetch_depth 2, remat
# none; each run a warm-up step, then timed steps (ZPP_HPZ_STEPS for the
# hpZ run, one for MiCS at ZeRO-3 and for two-level qgZ at ZeRO-1 under
# hpZ 2, in the same ranks), then one profiled step on rank 0.  The card
# ranks start them once the reference's CPU ranks have finished, so that
# no CPU rank shares the host with a timed step.  MiCS and qgZ are cut to
# ZPP_CUT_LAYERS layers: qgZ's whole params, fp32 flat m/v/error state and
# the engine's unused AdamW state take about 16 bytes a param a rank, four
# ranks of which leave no room on one card at full depth; MiCS for time.
# name -> (the config's extra keys, model overrides)
ZPP_HPZ_STEPS = 2
ZPP_CUT_LAYERS = 8
ZPP_TRAIN_CFG = {"train_micro_batch_size_per_gpu": 4,
                 "gradient_accumulation_steps": 2,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                 "bf16": {"enabled": True},
                 "gradient_clipping": 1.0,
                 "steps_per_print": 10_000,
                 "activation_checkpointing": {"remat_policy": "none"},
                 "step_schedule": {"gather_prefetch_depth": 2},
                 "mesh": {"data": ZPP_RANKS}}
ZPP_TRAIN_RUNS = {
    "hpz": ({"zero_optimization": {"stage": 3,
                                   "param_persistence_threshold": 0,
                                   "zero_hpz_partition_size": 2}}, {}),
    "mics": ({"zero_optimization": {"stage": 3,
                                    "param_persistence_threshold": 0,
                                    "mics_shard_size": 2}},
             {"num_layers": ZPP_CUT_LAYERS}),
    "qgz": ({"zero_optimization": {"stage": 1,
                                   "zero_hpz_partition_size": 2,
                                   "zero_quantized_gradients": True}},
            {"num_layers": ZPP_CUT_LAYERS})}

def bound_ms(nbytes, ops, peak):
    """The least time of a call, and what bounds it: the bytes it must move
    over the HBM rate against its operations over ``peak``."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line on stdout; a phase's line also notes on stderr the
    seconds since the script started."""
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        print(f"chip_smoke: {time.perf_counter() - START:.1f} s {obj['phase']}",
              file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stream_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call of ``fn`` on the stream, between CUDA events: the
    caller's host work included wherever it is longer than the kernels."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# calls a CUDA graph could not capture, timed on the stream instead (the
# caller's line and the error), emitted before the kernels line
STREAM_TIMED = []


def kernel_name(mangled: str) -> str:
    """A kernel's name and first int template argument from its Itanium
    mangled entry (``_ZN8flash_wg24attn_fwd_wgmma_s8_kernelILi128E...`` ->
    ``attn_fwd_wgmma_s8_kernel<128>``)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    return name + (f"<{arg.group(1)}>" if arg else "")


def ptxas_spills(log: str) -> dict:
    """Spill-store bytes by kernel (:func:`kernel_name`; the most over a
    name's instantiations) from a ptxas -v report."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name is not None:
            out[name] = max(out.get(name, 0), int(m.group(1)))
    return out


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3, stream=None) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph (on ``stream`` if given), the graph replayed between CUDA events,
    ``iters // 4`` times (at least once).  Every kernel row, plain version
    and library call is timed so, so that no time carries the wrapper's
    host work.  A call the graph cannot capture (a host sync, a copy from
    pageable memory) is timed on the stream and listed in STREAM_TIMED."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        caller = sys._getframe(1)
        STREAM_TIMED.append(f"{caller.f_code.co_name}:{caller.f_lineno}: "
                            f"{str(e).splitlines()[0][:160]}")
        del graph
        return stream_time_ms(fn, iters, 0)
    reps = max(1, iters // 4)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def kernel_ms(fn, iters: int = 20) -> dict:
    """A kernel row's times: ``ms`` its device time (:func:`cuda_time_ms`),
    ``stream_ms`` the same calls on the stream, host work included."""
    return {"ms": cuda_time_ms(fn, iters), "stream_ms": stream_time_ms(fn, iters)}


def grad_time_ms(forward, inputs, grad):
    """Device time of ``torch.autograd.grad(out, inputs, grad)`` for the
    ``out`` that ``forward()`` gives: the forward runs on a side stream,
    which the graph then captures, since autograd runs each backward op on
    its forward's stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    torch.cuda.current_stream().wait_stream(side)
    return cuda_time_ms(lambda: torch.autograd.grad(
        out, inputs, grad, retain_graph=True), stream=side)


# ----------------------------------------------------------------------
# phase 3: paged attention kernel against its plain version
# ----------------------------------------------------------------------
def quantize_rows(x):
    """int8 rows + fp32 per-row scales, as the engine quantizes on append."""
    import torch

    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q8.to(torch.int8).contiguous(), scale.contiguous()


def make_case(gen, t, nkv, nh, d, bs, num_blocks, nb, kind):
    """Inputs at the serving path's shapes.  ``kind``: decode (ragged
    contexts up to nb*bs, one token each), long (decode with every token at
    context nb*bs, each over pages of its own: t*nb distinct pages, so
    that the unique-page bound is the per-token bytes), prefill (a
    256-token chunk at the end of one 2048-token prompt), window (decode
    under a sliding window), garbage (tables past the context and padding
    tokens point at page 0, which holds huge values that must never
    leak)."""
    import torch

    dev = "cuda"
    p_rows = num_blocks * bs
    q = torch.randn((t, nh, d), generator=gen, device=dev).bfloat16()
    kp = torch.randn((nkv, p_rows, d), generator=gen, device=dev).bfloat16()
    vp = torch.randn((nkv, p_rows, d), generator=gen, device=dev).bfloat16()
    pages = torch.randint(1, num_blocks, (t, nb), generator=gen, device=dev,
                          dtype=torch.int32)
    if kind == "prefill":
        ctx = nb * bs
        pos = torch.arange(ctx - t, ctx, device=dev, dtype=torch.int32)
        clen = torch.full((t,), ctx, device=dev, dtype=torch.int32)
        pages = pages[:1].expand(t, nb).contiguous()
    elif kind == "long":
        pages = torch.randperm(num_blocks, generator=gen, device=dev)[:t * nb] \
            .reshape(t, nb).to(torch.int32)
        clen = torch.full((t,), nb * bs, device=dev, dtype=torch.int32)
        pos = clen - 1
    else:
        clen = torch.randint(1, nb * bs + 1, (t,), generator=gen, device=dev,
                             dtype=torch.int32)
        pos = clen - 1
    if kind == "garbage":
        kp[:, :bs] = 1e3
        vp[:, :bs] = 1e3
        used = torch.arange(nb, device=dev)[None, :] * bs < clen[:, None]
        pages = torch.where(used, pages, torch.zeros_like(pages))
        pad = slice(t - 4, t)   # padding tokens: slot row of zeros
        pages[pad] = 0
        pos[pad] = 0
        clen[pad] = 0
    window = 512 if kind == "window" else None
    return q, kp, vp, pages.contiguous(), pos.contiguous(), clen.contiguous(), window


def kernel_bound(pages, pos, clen, nkv, nh, d, bs, window, kv_elem, quant,
                 q_bytes):
    """Least time for the call: unique live K/V page bytes (each read
    once) + q + out + tables over the HBM rate, against the data's flops
    (q.k and p.v over every visited key) over the bf16 tensor rate."""
    import torch

    nb = pages.shape[1]
    j = torch.arange(nb, device=pages.device)[None, :]
    j_hi = (pos.long() // bs + 1)[:, None]
    j_lo = torch.zeros_like(j_hi) if window is None else torch.clamp(
        torch.div(pos.long() - (window - 1), bs, rounding_mode="floor"),
        min=0)[:, None]
    live = (j >= j_lo) & (j < j_hi)
    n_pages = int(torch.unique(pages[live]).numel())
    row_bytes = d * kv_elem + (4 if quant else 0)
    kv_bytes = 2 * n_pages * nkv * bs * row_bytes
    io_bytes = 2 * q_bytes + pages.numel() * 4 + 2 * pos.numel() * 4
    keys = int(live.sum()) * bs
    flops = 4.0 * keys * nh * d
    return (*bound_ms(kv_bytes + io_bytes, flops, BF16_FLOPS),
            kv_bytes + io_bytes)


def phase_kernels(pa, mc, bs, num_blocks):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    nh, nkv, d = mc.num_heads, mc.kv_heads, mc.dim_per_head
    nb = ENGINE_CFG["max_context"] // bs
    scale = 1.0 / d ** 0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    summary = {}
    for kind, t in (("decode", 32), ("prefill", 256), ("window", 32),
                    ("garbage", 32), ("long", 8)):
        q, kp, vp, pages, pos, clen, window = make_case(
            gen, t, nkv, nh, d, bs, num_blocks, nb, kind)
        kq, ks = quantize_rows(kp)
        vq, vs = quantize_rows(vp)
        for name, args, kw in (
                ("paged_attention", (q, kp, vp), {}),
                ("paged_attention_int8", (q, kq, vq),
                 {"k_scales": ks, "v_scales": vs})):
            call = (lambda fn, a=args, k=kw: fn(
                *a, pages, pos, clen, bs, scale, window, **k))
            path = pa.route(q, args[1], bs, nb)
            before = dict(pa.paged_decode_attention.routes)
            out = call(pa.paged_decode_attention)
            if pa.paged_decode_attention.routes[f"{name}.{path}"] \
                    != before[f"{name}.{path}"] + 1:
                fail(f"{name} ({kind}) did not launch on its {path} route")
            torch.cuda.synchronize()
            ref = call(pa.paged_decode_attention_ref)
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            ok = bool(torch.all(diff <= KERNEL_RTOL * (1 + ref.float().abs())))
            finite = bool(torch.isfinite(out.float()).all())
            row = {"phase": "kernel", "kernel": name, "case": kind, "T": t,
                   "nh": nh, "nkv": nkv, "d": d, "bs": bs, "NB": nb,
                   "window": window, "route": path,
                   "splits": pa.split_plan(t, nkv, nb, sms,
                                           f"{name}.{path}"),
                   "max_abs_err": err,
                   "tolerance": "|k-r| <= 2^-7 * (1 + |r|)", "ok": ok,
                   "finite": finite}
            if kind in ("decode", "prefill", "long"):
                bound, by, nbytes = kernel_bound(
                    pages, pos, clen, nkv, nh, d, bs, window,
                    args[1].element_size(), "k_scales" in kw,
                    q.numel() * q.element_size())
                row.update(
                    **kernel_ms(lambda: call(pa.paged_decode_attention)),
                    plain_ms=cuda_time_ms(
                        lambda: call(pa.paged_decode_attention_ref), iters=3,
                        warmup=1),
                    bound_ms=bound, bound_by=by, bound_bytes=nbytes,
                    library_ms=None,
                    library_note="no single PyTorch call computes attention "
                                 "over a block table")
                if kind == "decode":
                    summary[name] = row
            emit(row)
            if not (ok and finite):
                fail(f"{name} disagrees with its plain version ({kind})")
    return summary


# ----------------------------------------------------------------------
# phase 4: the card against the CPU on a small input, in fp32
# ----------------------------------------------------------------------
def phase_reference(v2, tf_model, tf, pa, prompts):
    """llama3-8b at full width cut to REF_LAYERS layers, fp32 weights and
    KV: the engine on the card (the kernel's fp32 body and cuBLAS) and the
    same weights on the CPU (the plain attention and CPU matmuls) take the
    same chunked prefill and decode steps; their logits must agree to
    REF_RTOL of the largest logit at every step."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(MODEL, num_layers=REF_LAYERS)
    cfg = {**ENGINE_CFG, "dtype": "float32"}
    card = v2.InferenceEngineV2(model, cfg, seed=1)
    host = v2.InferenceEngineV2(
        model, cfg, device="cpu",
        model_params=tf.tree_map_with_path(lambda _p, a: a.cpu(),
                                           card.params))
    uids = list(range(4))
    batch = [p[:200] for p in prompts[:4]]   # chunked over several steps
    launches0 = pa.paged_decode_attention.launches["paged_attention"]
    worst, agree, steps, full_steps = 0.0, [], 0, 0
    pending = (uids, batch)
    # until two steps in which every sequence decoded; a sequence whose
    # prompt is done decodes beside the others' prefill chunks
    while full_steps < 2:
        if steps == 16:
            fail("reference steps did not reach decode")
        lc, lh = card.put(*pending), host.put(*pending)
        pending = ([], [])
        steps += 1
        if set(lc) != set(lh):
            fail(f"reference step {steps}: card returned {sorted(lc)}, "
                 f"CPU {sorted(lh)}")
        for u in lh:
            a, b = lc[u], lh[u]
            if not (np.isfinite(a).all() and a.shape == (model.vocab_size,)):
                fail("card logits are not finite [vocab]")
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
            agree.append(int(a.argmax()) == int(b.argmax()))
            nxt = int(b.argmax())   # both decode the CPU's token
            card.extend(u, nxt)
            host.extend(u, nxt)
        full_steps += set(lh) == set(uids)
    launched = pa.paged_decode_attention.launches["paged_attention"] - launches0
    emit({"phase": "reference", "model": MODEL, "layers": REF_LAYERS,
          "dtype": "float32", "steps": steps,
          "prompt_tokens": sum(map(len, batch)),
          "check": "card (kernel, cuBLAS) vs CPU (plain version) logits",
          "max_rel_err": worst, "tolerance": REF_RTOL, "host": _host_info(),
          "argmax_agreement": sum(agree) / len(agree),
          "kernel_launches": launched})
    if worst > REF_RTOL:
        fail(f"card logits differ from the CPU's by {worst}")
    if launched != steps * REF_LAYERS:
        fail(f"the card's steps launched the kernel {launched} times")
    del card, host
    torch.cuda.empty_cache()


def _host_info():
    """The CPU the reference side ran on: the plain CPU kernels PyTorch
    picks follow its capability."""
    import os

    import torch

    model = next((ln.split(":", 1)[1].strip() for ln in
                  open("/proc/cpuinfo").read().splitlines()
                  if ln.startswith("model name")), "unknown")
    return {"cpu_model": model, "cpu_count": os.cpu_count(),
            "torch_threads": torch.get_num_threads(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


# ----------------------------------------------------------------------
# phase 5/6: engine and server on llama3-8b
# ----------------------------------------------------------------------
def phase_engine(pa, tf_model, v2, prompts):
    import torch

    model = tf_model.get_model_config(MODEL)
    counts = pa.paged_decode_attention.launches
    t0 = time.perf_counter()
    eng = v2.InferenceEngineV2(model, ENGINE_CFG, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    new = 64
    launches = {}
    outs = {}
    for kv, engine in (("bf16", eng), ("int8", None)):
        if engine is None:
            cfg = {**ENGINE_CFG, "memory_config": {
                **ENGINE_CFG["memory_config"], "kv_dtype": "int8"}}
            # shares eng's device weights (already bf16: no copy)
            engine = v2.InferenceEngineV2(model, cfg, model_params=eng.params)
        zero_counts(counts, pa.paged_decode_attention.routes,
                    pa.paged_decode_attention.merges)
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[kv] = dict(counts)
        # the merge kernel's launches (calls of more than one split)
        launches[kv + "_merges"] = dict(pa.paged_decode_attention.merges)
        routes = {r: n for r, n in pa.paged_decode_attention.routes.items() if n}
        outs[kv] = out
        ok = (all(len(o) == new for o in out)
              and all(0 <= x < model.vocab_size for o in out for x in o))
        emit({"phase": "engine", "model": MODEL, "layers": model.num_layers,
              "kv_dtype": kv, "prompts": len(prompts),
              "prompt_tokens": sum(map(len, prompts)), "new_tokens": new,
              "wall_s": wall, "launches": launches[kv], "routes": routes,
              "merge_launches": launches[kv + "_merges"],
              "ok": ok, "init_s": init_s if kv == "bf16" else None})
        if not ok:
            fail(f"{kv} engine produced malformed tokens")
        # bf16 and int8 pages of 16 rows at llama3-8b's geometry: every
        # launch on mma
        name = "paged_attention" if kv == "bf16" else "paged_attention_int8"
        want = {f"{name}.mma": launches[kv][name]}
        if routes != want:
            fail(f"{kv} engine launched on {routes}, expected {want}")
        if engine is not eng:
            del engine
    if launches["bf16"]["paged_attention"] == 0:
        fail("bf16 engine never launched the paged_attention kernel")
    if launches["int8"]["paged_attention_int8"] == 0:
        fail("int8 engine never launched the paged_attention_int8 kernel")
    agree = sum(a == b for oa, ob in zip(outs["bf16"], outs["int8"])
                for a, b in zip(oa, ob)) / (len(prompts) * new)
    emit({"phase": "engine", "check": "bf16 vs int8 KV greedy agreement",
          "fraction": agree})
    torch.cuda.empty_cache()
    return eng, launches, outs["bf16"]


def trace_events(prof):
    """The raw events of a finished ``torch.profiler`` run, as (name, start
    ns, end ns, on the device, a user annotation) tuples, read from its
    kineto results.  ``key_averages()`` and ``events()`` first build a
    Python ``FunctionEvent`` (and the op tree) for every event, the
    longest part of a profiled phase on the host; this reads the same
    fields and leaves out the events torch's own parsing hides."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        hidden = getattr(e, "is_hidden_event", None)
        if hidden is not None and hidden():
            continue
        out.append((e.name(), e.start_ns(), e.end_ns(),
                    e.device_type() != DeviceType.CPU,
                    e.is_user_annotation()))
    return out


def profile_call(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, device ms by kernel
    name, device busy ms, the trace's events, ``trace_events``).  Only
    device-side events count: a CPU op's self device time repeats the time
    of the kernels it launched, and a ``record_function`` range's
    device-side copy is no work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = trace_events(prof)
    by_name = {}
    for name, start, end, on_device, annotation in events:
        if on_device and not annotation and end > start:
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    return wall_ms, by_name, sum(by_name.values()), events


def comm_ms(events, names=("comm.ring_rotate", "comm.all_reduce")):
    """The host time a profiled run (``trace_events``) spent inside each
    ``record_function`` range of ``names`` (``comm/comm.py`` opens one
    around each collective): calls, host ms, and own ms, the host ms less
    the part during which this process's compute kernels ran on the card.
    A staged collective first copies its buffer to the host, which waits
    for the kernels queued before it; own ms leaves that wait out and
    keeps the staging copies and the transfer."""
    import bisect

    busy = sorted((start, end) for name, start, end, on_device, annotation
                  in events if on_device and not annotation
                  and not name.startswith(("Memcpy", "Memset")))
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]

    def overlap(a, b):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        ns = 0
        while i < len(merged) and merged[i][0] < b:
            ns += max(0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
        return ns

    out = {}
    for want in names:
        spans = [(start, end) for name, start, end, on_device, _a in events
                 if not on_device and name == want]
        host = sum(b - a for a, b in spans)
        out[want] = {"calls": len(spans), "host_ms": host / 1e6,
                     "own_ms": (host - sum(overlap(a, b) for a, b in spans))
                     / 1e6}
    return out


def phase_profile(eng, prompts, card):
    """Where the time goes in one generate() on the bf16 engine: device
    kernel time by name from torch.profiler, and the device's idle share
    of the wall time."""
    wall_ms, by_name, busy_ms, _ = profile_call(
        lambda: eng.generate(prompts, max_new_tokens=32))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    attn_ms = sum(v for k, v in by_name.items() if "paged_attention" in k)
    emit({"phase": "profile", "what": f"generate {len(prompts)} prompts, "
          "32 new tokens, bf16 KV", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "paged_attention_ms": attn_ms,
          "paged_attention_share_of_busy": attn_ms / max(busy_ms, 1e-9),
          "top_kernels_ms": [[k[:90], v] for k, v in top], "card": card})


def phase_logits(v2, tf_model, params, prompts):
    """One ragged prefill step (240 tokens) and one decode step through
    the kernel and through paged_gather on the card, with the same weights
    and inputs, for the bf16 and the int8 KV cache."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(MODEL)
    uids = list(range(1000, 1004))
    batch = [p[:60] for p in prompts[:4]]   # 240 tokens: one prefill step
    for kv in ("bf16", "int8"):
        mem = {**ENGINE_CFG["memory_config"],
               **({"kv_dtype": "int8"} if kv == "int8" else {})}
        pair = [v2.InferenceEngineV2(
            model, {**ENGINE_CFG, "memory_config": mem,
                    "modules": {"attention": attn}}, model_params=params)
            for attn in ("paged_kernel", "paged_gather")]
        worst, agree = 0.0, []
        logits = [e.put(uids, batch) for e in pair]
        for step in ("prefill", "decode"):
            lk, lg = logits
            if set(lk) != set(uids) or set(lg) != set(uids):
                fail(f"logits {step} step returned {sorted(lk)}/{sorted(lg)}")
            for u in uids:
                a, b = lk[u], lg[u]
                if not (np.isfinite(a).all()
                        and a.shape == (model.vocab_size,)):
                    fail("kernel-path logits are not finite [vocab]")
                worst = max(worst, float(np.abs(a - b).max()
                                         / max(np.abs(b).max(), 1e-30)))
                agree.append(int(a.argmax()) == int(b.argmax()))
            if step == "prefill":
                for u in uids:
                    for e in pair:
                        e.extend(u, int(lk[u].argmax()))
                logits = [e.put([], []) for e in pair]
        emit({"phase": "logits", "kv_dtype": kv,
              "check": "kernel vs paged_gather, bf16 compute",
              "max_rel_err": worst, "tolerance": LOGITS_RTOL,
              "argmax_agreement": sum(agree) / len(agree)})
        if worst > LOGITS_RTOL:
            fail(f"{kv} kernel-path logits differ from paged_gather by "
                 f"{worst}")
        del pair
        torch.cuda.empty_cache()


def phase_server(serving, pa, eng, prompts, ref, card):
    import torch

    new = 64
    counts = pa.paged_decode_attention.launches
    for k in counts:
        counts[k] = 0
    srv = serving.InferenceServer(eng).start()
    results = {}
    errors = []

    def worker(i):
        try:
            streams = [(r, srv.submit(prompts[r], serving.SamplingParams(
                max_new_tokens=new))) for r in (2 * i, 2 * i + 1)]
            for r, s in streams:
                results[r] = list(s)
        except Exception as e:  # reported below; the phase then fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    alive = any(th.is_alive() for th in threads)
    srv.stop(drain=not alive, timeout=120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = srv.metrics.snapshot()
    launches = dict(counts)
    ok = (not alive and not errors and len(results) == 8
          and launches["paged_attention"] > 0
          and all(len(results[r]) == new for r in results)
          and snap["completed"] == 8)
    same = sum(results.get(r) == ref[r] for r in range(8))
    emit({"phase": "server", "requests": 8, "threads": 4,
          "completed": snap["completed"], "errors": errors,
          "ttft_p50_s": snap["ttft"].get("p50"),
          "tpot_p50_s": snap["tpot"].get("p50"),
          "decode_tokens_per_s": snap["tokens_out"] / wall,
          "wall_s": wall, "match_engine_generate": same,
          "launches": launches, "card": card,
          "ok": ok})
    if not ok:
        fail("server did not finish its 8 requests")


# ----------------------------------------------------------------------
# phase 7: training kernels against their plain versions
# ----------------------------------------------------------------------
def attn_pairs(s, causal, window):
    """(query, key) pairs the mask keeps: the work these inputs need."""
    import numpy as np

    rows = np.arange(s)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(rows - window + 1, 0)
    hi = rows + 1 if causal else np.full(s, s)
    return int(np.sum(hi - lo))


def flash_bounds(b, hq, hkv, s, d, elem, pairs, fp32):
    """Least time of the forward, dq and dk/dv kernels, in that order: their
    operands read once and outputs written once over the HBM rate, against
    their products (2 flops per multiply-add, 2, 3 and 4 products of
    pairs x d per head; ``pairs``: the (query, key) pairs a head keeps)
    over the peak for the operands' type."""
    q_bytes, kv_bytes, rows = b * hq * s * d * elem, b * hkv * s * d * elem, b * hq * s * 4
    per_pair = 2.0 * pairs * d * hq * b
    work = [(2 * q_bytes + 2 * kv_bytes + rows, 2 * per_pair),       # fwd
            (3 * q_bytes + 2 * kv_bytes + 2 * rows, 3 * per_pair),   # dq
            (2 * q_bytes + 4 * kv_bytes + 2 * rows, 4 * per_pair)]   # dk/dv
    peak = FP32_FLOPS if fp32 else BF16_FLOPS
    return [bound_ms(nbytes, flops, peak) for nbytes, flops in work]


# name, b, hq, hkv, s, d, dtype, causal, window, timed (and library-timed)
FLASH_CASES = [
    ("gpt2-350m", 8, 16, 16, 1024, 64, "bfloat16", True, None, True),
    ("llama3-8b", 1, 32, 8, 4096, 128, "bfloat16", True, None, True),
    ("window", 2, 16, 16, 2048, 64, "bfloat16", True, 512, False),
    ("tail", 4, 16, 16, 1000, 64, "bfloat16", True, None, False),
    ("fp32", 2, 16, 16, 1024, 64, "float32", True, None, True),
    ("fp32-gqa-d128", 1, 8, 2, 520, 128, "float32", False, 200, False),
    ("bidir-window-gqa", 2, 16, 4, 1530, 128, "bfloat16", False, 384, False),
]


def bshd_inputs(b, hq, hkv, s, d, dtype, seed):
    """q, k, v, do in the model's layout: [B, S, H, D] read as [B, H, S, D]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(h):
        return torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype).transpose(1, 2)

    return rand(hq), rand(hkv), rand(hkv), rand(hq)


def lane_pad(lane):
    """The zero-pad of a [.., D] operand to a head_dim lane (the entries'
    ``flash_mha.head_dim_padded``), the identity where D is the lane."""
    import torch.nn.functional as F

    return lambda x: x if x.shape[-1] == lane else F.pad(x, (0, lane - x.shape[-1]))


def attn_case(row, roles, inputs, bounds, library, timed, routes=None,
              lane=None):
    """Each kernel of one attention case against its plain version on the
    same inputs.  ``roles``: (name, kernel, plain) for the forward
    ``(q, k, v) -> (o, lse)``, then dq and dk/dv ``(q, k, v, do, lse,
    delta)``, the backward fed the kernel forward's lse.  ``library``:
    keyword arguments and a note for the scaled_dot_product_attention call
    timed beside the kernels.  ``routes``: the kernel route each role's
    launch takes, by name, recorded in its row.  ``lane``: the kernels'
    head_dim when the inputs' D is off the lanes: the kernels take q, k, v,
    do zero-padded to it once (and are timed so), their outputs are sliced
    back to D, and the plain versions run at D."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_mha import attn_delta

    q, k, v, do = inputs
    d = q.shape[-1]
    pad = lane_pad(lane or d)
    qp, kp, vp, dop = (pad(x) for x in inputs)
    (fwd, fwd_k, fwd_p), (dqn, dq_k, dq_p), (dkvn, dkv_k, dkv_p) = roles
    o, lse = fwd_k(qp, kp, vp)
    o = o[..., :d]
    bwd = (q, k, v, do, lse, attn_delta(o, do).contiguous())
    bwd_k = (qp, kp, vp, dop, *bwd[4:])
    dq = dq_k(*bwd_k)[..., :d]
    dk, dv = (x[..., :d] for x in dkv_k(*bwd_k))
    torch.cuda.synchronize()
    checks = {fwd: ((o, lse), fwd_p(q, k, v)), dqn: ((dq,), (dq_p(*bwd),)),
              dkvn: ((dk, dv), dkv_p(*bwd))}
    rows = {}
    for (kname, (got, ref)), (bound, by) in zip(checks.items(), bounds):
        err, ok = 0.0, True
        for g, r in zip(got, ref):
            rtol = FLASH_RTOL[str(g.dtype).removeprefix("torch.")]
            diff = (g.float() - r.float()).abs()
            err = max(err, float(diff.max()))
            ok &= bool(torch.all(diff <= rtol * (1 + r.float().abs())))
            ok &= bool(torch.isfinite(g.float()).all())
        rows[kname] = {**row, "kernel": kname,
                       **({"route": routes[kname]} if routes else {}),
                       "lane": ("native" if (lane or d) == d
                                else f"padded to {lane}"),
                       "max_abs_err": err,
                       "tolerance": "|k-r| <= rtol * (1 + |r|), rtol "
                                    f"{FLASH_RTOL} by output dtype",
                       "ok": ok, "bound_ms": bound, "bound_by": by}
    if timed:
        calls = {fwd: (lambda: fwd_k(qp, kp, vp), lambda: fwd_p(q, k, v)),
                 dqn: (lambda: dq_k(*bwd_k), lambda: dq_p(*bwd)),
                 dkvn: (lambda: dkv_k(*bwd_k), lambda: dkv_p(*bwd))}
        for kname, (kern, plain) in calls.items():
            rows[kname].update(kernel_ms(kern))
            rows[kname]["plain_ms"] = cuda_time_ms(plain, iters=2, warmup=1)
        # one PyTorch call for the same function, timed as a yardstick only
        kw, note = library
        lib = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        sdpa = (lambda: F.scaled_dot_product_attention(
            *lib, enable_gqa=q.shape[1] != k.shape[1], **kw))
        with torch.no_grad():
            rows[fwd]["library_ms"] = cuda_time_ms(sdpa)
        pair_ms = grad_time_ms(sdpa, lib, do)
        rows[fwd]["library_note"] = note
        for kname in (dqn, dkvn):
            rows[kname]["library_ms"] = pair_ms
            rows[kname]["library_note"] = f"{note} backward: dq, dk and dv together"
    for r in rows.values():
        emit(r)
        if not r["ok"]:
            fail(f"{r['kernel']} disagrees with its plain version "
                 f"({r['case']})")
    return rows


def flash_case(fm, case, phase="train-kernel"):
    import torch

    name, b, hq, hkv, s, d, dt, causal, window, timed = case
    inputs = bshd_inputs(b, hq, hkv, s, d, getattr(torch, dt), seed=7)
    lane = fm.head_dim_lane(d)
    padded = [lane_pad(lane)(x) for x in inputs]
    args = (causal, 1.0 / d ** 0.5, window)
    roles = [("flash_fwd", lambda q, k, v: fm.flash_fwd(q, k, v, *args),
              lambda q, k, v: fm.flash_fwd_ref(q, k, v, *args)),
             ("flash_bwd_dq", lambda *a: fm.flash_bwd_dq(*a, *args),
              lambda *a: fm.flash_bwd_dq_ref(*a, *args)),
             ("flash_bwd_dkv", lambda *a: fm.flash_bwd_dkv(*a, *args),
              lambda *a: fm.flash_bwd_dkv_ref(*a, *args))]
    pairs = attn_pairs(s, causal, window)
    row = {"phase": phase, "case": name, "B": b, "Hq": hq,
           "Hkv": hkv, "S": s, "D": d, "dtype": dt, "causal": causal,
           "window": window, "pairs": pairs}
    bwd = fm.bwd_route(*padded)
    routes = {"flash_fwd": fm.fwd_route(*padded[:3]), "flash_bwd_dq": bwd,
              "flash_bwd_dkv": bwd}
    before = dict(fm.flash_mha.routes)
    rows = attn_case(row, roles, inputs,
                     flash_bounds(b, hq, hkv, s, d, inputs[0].element_size(),
                                  pairs, dt == "float32"),
                     ({"is_causal": causal}, "scaled_dot_product_attention"),
                     timed, routes, lane)
    taken = {r for r, c in fm.flash_mha.routes.items() if c != before[r]}
    if taken != {f"{n}.{r}" for n, r in routes.items()}:
        fail(f"{phase} ({name}): launches on {sorted(taken)}, "
             f"expected {routes}")
    return rows


# name, b, hq, hkv, s, d, dtype, (sparsity config, its kwargs), causal
SPARSE_KW = {k: v for k, v in SPARSE.items() if k != "mode"}
SPARSE_CASES = [
    ("gpt2-350m", 8, 16, 16, 1024, 64, "bfloat16",
     ("BSLongformerSparsityConfig", SPARSE_KW), True),
    ("fixed", 2, 16, 16, 1024, 64, "bfloat16",
     ("FixedSparsityConfig", {"block": 16, "num_local_blocks": 4,
                              "num_global_blocks": 1,
                              "attention": "unidirectional"}), True),
    ("bigbird-per-head", 2, 16, 16, 1024, 64, "bfloat16",
     ("BigBirdSparsityConfig", {"block": 16, "num_random_blocks": 2,
                                "different_layout_per_head": True,
                                "seed": 1}), True),
    ("llama3-8b", 1, 32, 8, 4096, 128, "bfloat16",
     ("BSLongformerSparsityConfig", {"block": 64,
                                     "attention": "unidirectional"}), True),
    ("bidirectional-b128", 2, 16, 16, 2048, 64, "bfloat16",
     ("BSLongformerSparsityConfig", {"block": 128}), False),
    ("fp32", 2, 16, 16, 1024, 64, "float32",
     ("BSLongformerSparsityConfig", SPARSE_KW), True),
]


def strided_tail(lengths, sms):
    """The forward's persistent schedule: block x of min(n, sms) takes
    items x, x + blocks, ... (no snake): (largest, mean) tiles a block."""
    blocks = min(len(lengths), sms)
    loads = [sum(lengths[x::blocks]) for x in range(blocks)]
    return max(loads), sum(loads) / blocks


def sparse_schedule(plan, b, hkv, sms):
    """The wgmma walks' schedule tails for a layout: forward and dq items
    are (128-row query tile, head, batch) in attention_wgmma.cuh's Item
    order (longest causal walks first) walking their live 128-key
    (forward) or 64-key (dq) tiles; dk/dv items (128-key tile, KV head,
    batch) in KvItem order walking their group's live 64-row query tiles."""
    import numpy as np

    hq = plan.heads

    def q_items(walk):     # [h, iq] lengths in Item order
        n = np.diff(walk[0].cpu().numpy()).reshape(hq, -1)
        return [int(n[h, iq]) for iq in reversed(range(n.shape[1]))
                for _b in range(b) for h in range(hq)]

    dkv = np.diff(plan.dkv_walk[0].cpu().numpy()).reshape(hq, -1)  # [h, ik]
    dkv = dkv.reshape(hkv, hq // hkv, -1).sum(1)                   # [hk, ik]
    dkv_items = [int(dkv[h, ik]) for ik in range(dkv.shape[1])
                 for _b in range(b) for h in range(hkv)]
    out = {}
    for name, items in (("bsa_fwd", q_items(plan.fwd_walk)),
                        ("bsa_bwd_dq", q_items(plan.dq_walk)),
                        ("bsa_bwd_dkv", dkv_items)):
        worst, mean = (strided_tail if name == "bsa_fwd" else snake_tail)(
            items, sms)
        out[name] = {"items": len(items), "blocks": min(len(items), sms),
                     "live_tiles": sum(items), "max_block_tiles": worst,
                     "mean_block_tiles": mean,
                     "tail": worst / mean if mean else None}
    return out


def sparse_case(bsm, fm, sa, case, phase="sparse-kernel"):
    """A block-sparse case: the layout of a DeepSpeed sparsity config, its
    bound from the pairs the layout (and causal) keeps, and SDPA under the
    expanded boolean mask as the library time; each row names its route
    (and lane), timed bf16 rows the wgmma walks' schedule, the dense
    causal flash kernels on the same inputs (what the sparse ones should
    beat: they compute a fraction of the same tiles), the same walks with
    every tile's full flag set (the maskless body everywhere: wrong
    numbers, timed only, to show what the mask test costs) and, for the
    forward, its parent route (the 64 x 64 walk, ``mma``) on the same
    inputs."""
    import copy

    import torch

    name, b, hq, hkv, s, d, dt, (cls, kw), causal = case
    inputs = bshd_inputs(b, hq, hkv, s, d, getattr(torch, dt), seed=9)
    layout = getattr(sa, cls)(num_heads=hq, **kw).make_layout(s)
    plan = bsm.SparseLayout(layout, kw["block"], causal, "cuda")
    scale = d ** -0.5
    lane = fm.head_dim_lane(d)
    padded = [lane_pad(lane)(x) for x in inputs]
    roles = [("bsa_fwd", lambda q, k, v: bsm.bsa_fwd(q, k, v, plan, scale),
              lambda q, k, v: bsm.bsa_fwd_ref(q, k, v, plan, scale)),
             ("bsa_bwd_dq", lambda *a: bsm.bsa_bwd_dq(*a, plan, scale),
              lambda *a: bsm.bsa_bwd_dq_ref(*a, plan, scale)),
             ("bsa_bwd_dkv", lambda *a: bsm.bsa_bwd_dkv(*a, plan, scale),
              lambda *a: bsm.bsa_bwd_dkv_ref(*a, plan, scale))]
    mask = plan.token_mask()
    pairs = int(mask.sum()) / hq     # mean over the heads
    n = plan.live.shape[1]
    bwd = bsm.bwd_route(*padded, plan)
    routes = {"bsa_fwd": bsm.fwd_route(*padded[:3], plan),
              "bsa_bwd_dq": bwd, "bsa_bwd_dkv": bwd}
    row = {"phase": phase, "case": name, "B": b, "Hq": hq,
           "Hkv": hkv, "S": s, "D": d, "dtype": dt, "causal": causal,
           "layout": cls, "block": kw["block"], "pairs_per_head": pairs,
           "dense_pairs_per_head": attn_pairs(s, causal, None),
           "live_tiles": int(plan.live.sum()),
           "visited_tiles_dense": hq * (n * (n + 1) // 2 if causal else n * n)}
    if plan.wgmma:
        row["live_tiles_wgmma"] = {
            "fwd_128x128": int(plan.fwd_walk[1].numel()),
            "dq_128x64": int(plan.dq_walk[1].numel()),
            "dkv_64x128": int(plan.dkv_walk[1].numel()),
            "full_64x64": int(plan.full.sum())}
    before = dict(bsm.block_sparse_mha.routes)
    timed = dt == "bfloat16" or phase == "sparse-kernel"
    rows = attn_case(row, roles, inputs,
                     flash_bounds(b, hq, hkv, s, d, inputs[0].element_size(),
                                  pairs, dt == "float32"),
                     ({"attn_mask": mask[None]},
                      "scaled_dot_product_attention with the layout's "
                      "boolean mask"), timed, routes, lane)
    taken = {r for r, c in bsm.block_sparse_mha.routes.items()
             if c != before[r]}
    if taken != {f"{n_}.{r}" for n_, r in routes.items()}:
        fail(f"{phase} ({name}): launches on {sorted(taken)}, expected "
             f"{routes}")
    if timed and dt == "bfloat16" and lane == d:
        # the dense causal flash kernels on the same inputs, same call
        q, k, v, do = inputs
        o, lse = fm.flash_fwd(q, k, v, True, scale)
        delta = fm.attn_delta(o, do).contiguous()
        dense_fwd = {"flash_fwd": cuda_time_ms(lambda: fm.flash_fwd(
                         q, k, v, True, scale)),
                     "route": fm.fwd_route(q, k, v)}
        dense = {"flash_bwd_dq": cuda_time_ms(lambda: fm.flash_bwd_dq(
                     q, k, v, do, lse, delta, True, scale)),
                 "flash_bwd_dkv": cuda_time_ms(lambda: fm.flash_bwd_dkv(
                     q, k, v, do, lse, delta, True, scale)),
                 "route": fm.bwd_route(q, k, v, do)}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sched = sparse_schedule(plan, b, hkv, sms) if bwd == "wgmma" else {}
        maskless, parent = {}, None
        if bwd == "wgmma":
            bare = copy.copy(plan)
            bare.full = torch.ones_like(plan.full)
            o, lse = bsm.bsa_fwd(q, k, v, plan, scale)
            args = (q, k, v, do, lse, fm.attn_delta(o, do).contiguous())
            maskless = {
                "bsa_fwd": cuda_time_ms(lambda: bsm.bsa_fwd(q, k, v, bare, scale)),
                "bsa_bwd_dq": cuda_time_ms(lambda: bsm.bsa_bwd_dq(*args, bare, scale)),
                "bsa_bwd_dkv": cuda_time_ms(lambda: bsm.bsa_bwd_dkv(*args, bare, scale))}
            # the forward's parent route, the 64 x 64 walk, on these inputs
            route_rule = bsm.fwd_route
            bsm.fwd_route = lambda *a: "mma"
            try:
                parent = cuda_time_ms(lambda: bsm.bsa_fwd(q, k, v, plan, scale))
            finally:
                bsm.fwd_route = route_rule
        for kname in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv"):
            beside = {"dense_causal_flash_fwd_ms": dense_fwd,
                      "mma_route_ms": parent} if kname == "bsa_fwd" else \
                {"dense_causal_flash_bwd_ms": dense}
            rows[kname].update(beside)
            if kname in sched:
                rows[kname]["schedule"] = sched[kname]
            emit({"phase": phase + "-beside", "case": name, "kernel": kname,
                  "ms": rows[kname]["ms"],
                  ("sdpa_masked_fwd_ms" if kname == "bsa_fwd"
                   else "sdpa_masked_bwd_ms"): rows[kname]["library_ms"],
                  **beside, "all_tiles_maskless_ms": maskless.get(kname),
                  "schedule": sched.get(kname)})
    return rows


def phase_adamw(fo, tf_model, tf):
    """The fused AdamW kernel over every fp32 leaf of gpt2-350m in one
    launch, against its plain version leaf by leaf: bit for bit."""
    import torch

    mc = tf_model.get_model_config(TRAIN_MODEL)
    params = tf.init_params(mc, seed=0, device="cuda")
    ps = []
    tf.tree_map_with_path(lambda _p, x: ps.append(x), params)
    gen = torch.Generator(device="cuda").manual_seed(11)
    gs = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-2 for p in ps]
    ms = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in ps]
    vs = [torch.rand(p.shape, generator=gen, device="cuda") * 1e-5 for p in ps]
    ref = [[t.clone() for t in group] for group in (ps, ms, vs)]
    hp = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    count = 5
    table = fo.LeafTable()
    fo.fused_adamw(ps, gs, ms, vs, count=count, table=table, **hp)
    torch.cuda.synchronize()
    bc1, bc2 = fo.bias_corrections(count, hp["b1"], hp["b2"])

    def plain(group=ref):
        for p, g, m, v in zip(group[0], gs, group[1], group[2]):
            fo.adamw_leaf_ref(p, g, m, v, hp["lr"], bc1, bc2, hp["b1"],
                              hp["b2"], hp["eps"], hp["wd"])

    plain()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for ga, gb in zip((ps, ms, vs), ref)
                for a, b in zip(ga, gb))
    err = max(float((a - b).abs().max()) for ga, gb in zip((ps, ms, vs), ref)
              for a, b in zip(ga, gb))
    n = sum(p.numel() for p in ps)
    # p, g, m, v read; p, m, v written
    bound, by = bound_ms(28.0 * n, 16.0 * n, FP32_FLOPS)
    row = {"phase": "train-kernel", "kernel": "fused_adamw",
           "case": f"{TRAIN_MODEL}: all {len(ps)} fp32 leaves, one launch",
           "elements": n, "bitwise_equal": equal, "max_abs_err": err,
           **kernel_ms(lambda: fo.fused_adamw(
               ps, gs, ms, vs, count=count, table=table, **hp), iters=10),
           "plain_ms": cuda_time_ms(plain, iters=2, warmup=1),
           "bound_ms": bound, "bound_by": by}
    steps = [torch.tensor(float(count + 1), device="cuda") for _ in ps]
    row["library_ms"] = cuda_time_ms(lambda: torch._fused_adamw_(
        ref[0], gs, ref[1], ref[2], [], steps, lr=hp["lr"], beta1=hp["b1"],
        beta2=hp["b2"], weight_decay=hp["wd"], eps=hp["eps"], amsgrad=False,
        maximize=False), iters=10)
    row["library_note"] = "torch._fused_adamw_ over the same leaves"
    emit(row)
    if not equal:
        fail(f"fused_adamw differs from its plain version by {err}")
    del params, ps, gs, ms, vs, ref
    torch.cuda.empty_cache()
    return row


def phase_lion(fo, tf_model, tf):
    """The fused Lion kernel over every fp32 leaf of gpt2-350m in one
    launch, against its plain version leaf by leaf: bit for bit."""
    import torch

    mc = tf_model.get_model_config(TRAIN_MODEL)
    params = tf.init_params(mc, seed=0, device="cuda")
    ps = tf.tree_leaves(params)
    gen = torch.Generator(device="cuda").manual_seed(12)
    gs = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-2 for p in ps]
    ms = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in ps]
    ref = [[t.clone() for t in group] for group in (ps, ms)]
    hp = dict(lr=3e-5, b1=0.9, b2=0.99, wd=0.1)
    table = fo.LeafTable()
    fo.fused_lion(ps, gs, ms, table=table, **hp)
    torch.cuda.synchronize()

    def plain(group=ref):
        for p, g, m in zip(group[0], gs, group[1]):
            fo.lion_leaf_ref(p, g, m, hp["lr"], hp["b1"], hp["b2"], hp["wd"])

    plain()
    torch.cuda.synchronize()
    pairs = [(a, b) for ga, gb in zip((ps, ms), ref) for a, b in zip(ga, gb)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    n = sum(p.numel() for p in ps)
    bound, by = bound_ms(20.0 * n, 10.0 * n, FP32_FLOPS)  # p, g, m read; p, m written
    row = {"phase": "lion-kernel", "kernel": "fused_lion",
           "case": f"{TRAIN_MODEL}: all {len(ps)} fp32 leaves, one launch",
           "elements": n, "bitwise_equal": equal, "max_abs_err": err,
           **kernel_ms(lambda: fo.fused_lion(
               ps, gs, ms, table=table, **hp), iters=10),
           "plain_ms": cuda_time_ms(plain, iters=2, warmup=1),
           "bound_ms": bound, "bound_by": by,
           "library_ms": None,
           "library_note": "no PyTorch call computes a Lion step"}
    emit(row)
    if not equal:
        fail(f"fused_lion differs from its plain version by {err}")
    del params, ps, gs, ms, ref
    torch.cuda.empty_cache()
    return row


def phase_sparse_kernels(bsm, fm, sa, fo, tf_model, tf):
    import torch

    summary = {}
    for case in SPARSE_CASES:
        rows = sparse_case(bsm, fm, sa, case)
        if case[0] == TRAIN_MODEL:
            summary.update(rows)
        torch.cuda.empty_cache()
    summary["fused_lion"] = phase_lion(fo, tf_model, tf)
    return summary


def phase_head_dim_kernels(fm, bsm, sa):
    """Flash, one ring hop and block-sparse at head dims off the 64/128
    lanes: each kernel on operands zero-padded to the lane (D 256 native on
    the 64 x 64 walk) against its plain version at the real D, each row
    naming its lane and route; bf16 timed beside SDPA at the same shape."""
    import torch

    for name, b, hq, hkv, s, d in HEAD_DIM_CASES:
        for dt in ("bfloat16", "float32"):
            timed = dt == "bfloat16"
            flash_case(fm, (name, b, hq, hkv, s, d, dt, True, None, timed),
                       phase="head-dim-kernel")
            ring_case(fm, (name, b, hq, hkv, s // 2, d, dt, True, None,
                           (1, 2, 0, 2), timed), phase="head-dim-kernel")
            sparse_case(bsm, fm, sa, (name, b, hq, hkv, s, d, dt,
                                      ("BSLongformerSparsityConfig",
                                       SPARSE_KW), True),
                        phase="head-dim-kernel")
            torch.cuda.empty_cache()


def phase_train_kernels(fm, fo, tf_model, tf):
    import torch

    summary = {}
    for case in FLASH_CASES:
        rows = flash_case(fm, case)
        if case[0] == TRAIN_MODEL:
            summary.update(rows)
        torch.cuda.empty_cache()
    summary["fused_adamw"] = phase_adamw(fo, tf_model, tf)
    return summary


# ----------------------------------------------------------------------
# phases 8/9: training on gpt2-350m
# ----------------------------------------------------------------------
def train_batch_of(vocab, rows, seed=0, seq=TRAIN_SEQ):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(rows, seq + 1), dtype=np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:].astype(np.int32)}


def zero_counts(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def expected(counters, **nonzero):
    """Every counted kernel at 0 but the ones named."""
    return {**{k: 0 for c in counters for k in c}, **nonzero}


def phase_train_reference(ds, tf_model, tf, counters, phase, cfg, want,
                          model_name=TRAIN_MODEL, seq=TRAIN_SEQ, **model_kw):
    """``model_name`` (gpt2-350m) at its width cut to REF_LAYERS layers,
    fp32 weights and compute: the engine on the card (kernels, cuBLAS with
    TF32 off) and the same engine on the CPU (plain versions) take two
    train_batch steps on one batch of ``seq`` tokens a row; loss, grad norm
    and params must agree to REF_RTOL (summation order only), and the
    card's steps launch ``want``."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(model_name, num_layers=REF_LAYERS,
                                      **model_kw)
    cfg = {**cfg, "bf16": {"enabled": False},
           "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2}
    card, *_ = ds.initialize(model=model, config=cfg, seed=1)
    host, *_ = ds.initialize(
        model=model, config=cfg, device="cpu",
        model_parameters=tf.tree_map_with_path(
            lambda _p, a: a.detach().cpu(), card.params))
    p0 = tf.tree_map_with_path(lambda _p, a: a.detach().clone(), host.params)
    batch = train_batch_of(model.vocab_size, 4, seed=3, seq=seq)
    zero_counts(*counters)
    rows = []
    worst = 0.0
    for step in range(2):
        lc, lh = float(card.train_batch(batch)), float(host.train_batch(batch))
        gc_, gh = card.get_global_grad_norm(), host.get_global_grad_norm()
        if not (np.isfinite(lc) and np.isfinite(gc_)):
            fail(f"{phase}: loss or grad norm not finite")
        rows.append({"loss_card": lc, "loss_cpu": lh,
                     "grad_norm_card": gc_, "grad_norm_cpu": gh})
        worst = max(worst, abs(lc - lh) / abs(lh), abs(gc_ - gh) / gh)
    launched = {k: v for c in counters for k, v in c.items()}
    num = den = upd_den = upd_max = 0.0
    for a, b, z in zip(tf.tree_leaves(card.params), tf.tree_leaves(host.params),
                       tf.tree_leaves(p0)):
        a, b, z = a.detach().cpu().double(), b.detach().double(), z.double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
        upd_den += float(((b - z) ** 2).sum())
        upd_max = max(upd_max, float((a - b).abs().max()))
    params_rel = (num / den) ** 0.5
    update_rel = (num / upd_den) ** 0.5   # |(a - p0) - (b - p0)| / |b - p0|
    emit({"phase": phase, "model": model_name, "layers": REF_LAYERS,
          "head_dim": model.dim_per_head,
          "dtype": "float32", "micro": 2, "gas": 2, "seq": seq,
          "attn_impl": model.attn_impl, "optimizer": cfg["optimizer"]["type"],
          "steps": rows,
          "check": "card (kernels, cuBLAS) vs CPU (plain versions)",
          "max_rel_err_loss_grad_norm": worst, "params_rel_l2": params_rel,
          "update_rel_l2": update_rel, "params_max_abs_diff": upd_max,
          "tolerance": REF_RTOL, "launches": launched, "expected": want})
    if worst > REF_RTOL or params_rel > REF_RTOL:
        fail(f"{phase}: card training differs from the CPU's: {worst}, "
             f"{params_rel}")
    if launched != want:
        fail(f"{phase}: the reference steps launched {launched}, expected {want}")
    del card, host
    torch.cuda.empty_cache()


def fwd_flops_per_tok(model, seq):
    """Model forward flops a token (qkvo GQA-aware + MLP + lm_head +
    attention), the JAX package's telemetry/derive.py formula."""
    h, n_layers, vocab = model.hidden_size, model.num_layers, model.vocab_size
    act = 3 if model.activation == "swiglu" else 2
    qkvo = 2 * h * h + 2 * h * (h * model.kv_heads // model.num_heads)
    matmul = n_layers * (qkvo + act * h * model.intermediate_size)
    return 2 * matmul + 2 * h * vocab + 2 * seq * h * n_layers


def phase_train(ds, tf_model, counters, card, phase, cfg, want, remat=False,
                **model_kw):
    """gpt2-350m at full width and depth in bf16 with the bench row's
    step: a warm-up step, TRAIN_STEPS timed steps on one fixed batch (the
    counts are zeroed just before them and read just after and must equal
    ``want`` a step), then a profiled step; with ``remat``, one more step
    under remat "nothing_saveable" (the checkpointed forward reruns, so the
    forward kernel launches twice a layer).  Returns the timed steps'
    launches."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(TRAIN_MODEL, **model_kw)
    t0 = time.perf_counter()
    eng, *_ = ds.initialize(model=model, config=cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = cfg["train_micro_batch_size_per_gpu"] * cfg["gradient_accumulation_steps"]
    batch = train_batch_of(model.vocab_size, rows)
    t0 = time.perf_counter()
    losses = [float(eng.train_batch(batch))]     # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)))   # float() syncs
        step_s.append(time.perf_counter() - t0)
    launches = {k: v for c in counters for k, v in c.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = rows * TRAIN_SEQ
    tps = tokens * TRAIN_STEPS / sum(step_s)
    mfu = tps * 3 * fwd_flops_per_tok(model, TRAIN_SEQ) / BF16_FLOPS
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and per_step == want)
    emit({"phase": phase, "model": TRAIN_MODEL, "layers": model.num_layers,
          "dtype": "bfloat16", "attn_impl": model.attn_impl,
          "sparse_attention": model.sparse_attention,
          "optimizer": cfg["optimizer"], "remat": "none", "zero_stage": 1,
          "micro": cfg["train_micro_batch_size_per_gpu"],
          "gas": cfg["gradient_accumulation_steps"], "seq": TRAIN_SEQ,
          "init_s": init_s, "warmup_step_s": warm_s, "step_s": step_s,
          "tokens_per_step": tokens, "tokens_per_s": tps, "mfu": mfu,
          "mfu_peak": "989 TFLOP/s bf16 dense (H100 SXM); the formula "
                      "counts dense attention",
          "losses": losses, "max_memory_allocated_gib": peak_gb,
          "launches": launches, "launches_per_step": per_step,
          "expected_per_step": want, "card": card, "ok": ok})
    if not ok:
        fail(f"{phase}: losses not finite and falling, or the launch counts "
             "do not show the kernels")

    wall_ms, by_name, busy_ms, _ = profile_call(lambda: eng.train_batch(batch))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    def share(*keys):
        return sum(v for k, v in by_name.items() if any(x in k for x in keys))

    emit({"phase": phase + "-profile",
          "what": f"one train_batch, gpt2-350m bf16, attn_impl "
                  f"{model.attn_impl}, {cfg['optimizer']['type']}",
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "kernel_ms": {n: sum(v for k, v in by_name.items()
                               if all(x in k for x in parts))
                        for n, parts in PROFILE_NAMES.items() if want.get(n)},
          "gemm_ms": share("gemm", "nvjet", "cutlass", "xmma"),
          "top_kernels_ms": [[k[:90], v] for k, v in top], "card": card})
    if not remat:
        return launches

    cfg = {**cfg, "activation_checkpointing":
           {"remat_policy": "nothing_saveable"}}
    eng2, *_ = ds.initialize(model=model, config=cfg,
                             model_parameters=eng.params)
    del eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    t0 = time.perf_counter()
    loss = float(eng2.train_batch(batch))
    remat_s = time.perf_counter() - t0
    remat_launches = {k: v for c in counters for k, v in c.items()}
    fwd = next(k for k in ("flash_fwd", "bsa_fwd") if want.get(k))
    # the forward's launches (and its route's count) double
    want_remat = {k: 2 * v if k.split(".")[0] == fwd else v
                  for k, v in want.items()}
    emit({"phase": phase + "-remat", "remat": "nothing_saveable",
          "step_s": remat_s, "loss": loss,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": remat_launches, "expected": want_remat})
    if remat_launches != want_remat or not np.isfinite(loss):
        fail(f"remat step launched {remat_launches}, expected {want_remat}")
    del eng2
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 14-16: LoRA adapters over quantized llama3-8b-width MLP bases
# ----------------------------------------------------------------------
class LoRAStack:
    """A duck-typed trainable over the public API of
    ``deepspeed_tpu_torch.linear``: a residual stack of SwiGLU MLP blocks,
    ``h = h + down(silu(gate(h)) * up(h))``, each projection an
    ``OptimizedLinear`` over a frozen base quantized to ``q_bits`` with a
    LoRA adapter (``LoRAConfig()`` defaults: r 64, alpha 16) that the
    params hold; loss = mean squared error of the last h against
    ``batch["y"]``.  ``weights``: per block an iterable of the gate, up and
    down ``[in, out]`` weights, consumed one at a time (each is quantized
    and dropped)."""

    def __init__(self, lin, weights, q_bits, group_size, dtype):
        self.lora_config = lin.LoRAConfig(delay_lora_init=True)
        qc = lin.QuantizationConfig(q_bits=q_bits, group_size=group_size)
        self.lin, self.dtype = lin, dtype
        self.blocks = [{name: lin.OptimizedLinear(
            w, lora_config=self.lora_config, quantization_config=qc)
            for name, w in zip(PROJ, block)} for block in weights]

    def init(self, generator):
        params = {}
        for i, block in enumerate(self.blocks):
            for name, layer in block.items():
                params.setdefault(f"block{i}", {})[name] = \
                    self.lin.init_lora_params(generator, *layer.base.shape,
                                              self.lora_config)
        return params

    def loss(self, params, batch):
        import torch

        h = batch["x"].to(self.dtype)
        for i, block in enumerate(self.blocks):
            p = params[f"block{i}"]
            g = block["gate"](h, **p["gate"])
            u = block["up"](h, **p["up"])
            h = h + block["down"](torch.nn.functional.silu(g) * u, **p["down"])
        return torch.mean(torch.square(h.float() - batch["y"]))

    def nbytes(self):
        return sum(b.base.nbytes for block in self.blocks for b in block.values())


def stack_weights(hidden, inter, blocks, seed, dtype, device):
    """Per block, a generator of the gate, up and down weights (std 0.02,
    from one seeded generator), made on ``device`` as they are consumed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def block():
        for shape in ((hidden, inter), (hidden, inter), (inter, hidden)):
            yield (torch.randn(shape, generator=gen, device=device)
                   * 0.02).to(dtype)

    return (block() for _ in range(blocks))


# name, shape, dtype, group, bits, timed
QUANT_CASES = [
    ("gate/up weight bf16 int8", (4096, 14336), "bfloat16", 512, 8, True),
    ("gate/up weight bf16 int4", (4096, 14336), "bfloat16", 512, 4, False),
    ("down weight bf16 int8", (14336, 4096), "bfloat16", 512, 8, False),
    ("down weight fp32 int8 g128", (14336, 4096), "float32", 128, 8, False),
    ("row tail", (300, 384), "bfloat16", 128, 8, False),
    ("1-D", (1 << 20,), "bfloat16", 256, 4, False),
]


def quant_case(qk, case):
    """quantize, dequantize (to the input dtype) and fake_quantize against
    their plain versions, bit for bit; timed rows for the path's case."""
    import torch

    name, shape, dt, gs, bits, timed = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
    x[..., :gs] = 0.0                       # an all-zero group: scale 1.0
    q, s = qk.quantize(x, bits, gs)
    d = qk.dequantize(q, s, dtype)
    f = qk.fake_quantize(x, bits, gs)
    torch.cuda.synchronize()
    q_r, s_r = qk.quantize_ref(x, bits, gs)
    d_r = qk.dequantize_ref(q, s, dtype)
    f_r = qk.fake_quantize_ref(x, bits, gs)
    n = x.numel()
    elem = x.element_size()
    s_bytes = s.numel() * 4
    work = {"quantize": ((q, q_r), (s, s_r), n * elem + n + s_bytes, 5 * n),
            "dequantize": ((d, d_r), (d, d_r), n + s_bytes + n * elem, n),
            "fake_quantize": ((f, f_r), (f, f_r), 2 * n * elem, 6 * n)}
    calls = {"quantize": (lambda: qk.quantize(x, bits, gs),
                          lambda: qk.quantize_ref(x, bits, gs)),
             "dequantize": (lambda: qk.dequantize(q, s, dtype),
                            lambda: qk.dequantize_ref(q, s, dtype)),
             "fake_quantize": (lambda: qk.fake_quantize(x, bits, gs),
                               lambda: qk.fake_quantize_ref(x, bits, gs))}
    rows = {}
    for kname, ((a, a_r), (b, b_r), nbytes, ops) in work.items():
        equal = torch.equal(a, a_r) and torch.equal(b, b_r)
        err = max(float((a.float() - a_r.float()).abs().max()),
                  float((b.float() - b_r.float()).abs().max()))
        row = {"phase": "linear-kernel", "kernel": kname, "case": name,
               "shape": list(shape), "dtype": dt, "group": gs, "bits": bits,
               "bitwise_equal": equal, "max_abs_err": err,
               "tolerance": "bit for bit"}
        if timed:
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, FP32_FLOPS)
            row.update(**kernel_ms(calls[kname][0]),
                       plain_ms=cuda_time_ms(calls[kname][1], iters=3, warmup=1),
                       bound_bytes=nbytes, library_ms=None,
                       library_note="no single PyTorch call computes "
                                    "per-group absmax quantization")
        rows[kname] = row
        emit(row)
        if not equal:
            fail(f"{kname} differs from its plain version ({name}): {err}")
    return rows


# name, M, K, N, x dtype, timed
FP6_CASES = [
    ("decode gate/up", 16, 4096, 14336, "bfloat16", True),
    ("decode down", 16, 14336, 4096, "bfloat16", True),
    ("path gate/up", 4096, 4096, 14336, "bfloat16", True),
    ("path down", 4096, 14336, 4096, "bfloat16", True),
    ("M 7", 7, 4096, 14336, "bfloat16", False),
    ("fp32 x", 256, 4096, 14336, "float32", True),
]
FP6_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}


def fp6_case(t6, case):
    """fp6_matmul against its plain version; timed cases add the bound and
    torch.matmul of x with the dequantized weight (the 16-bit product FP6
    exists to beat at decode) as the library time."""
    import torch

    name, m, k, n, dt, timed = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(22)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    packed, scale = t6.fp6_quantize(w)
    del w
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    out = t6.fp6_matmul(x, packed, scale)
    torch.cuda.synchronize()
    ref = t6.fp6_matmul_ref(x, packed, scale)
    diff = (out.float() - ref.float()).abs()
    rtol = FP6_RTOL[dt]
    ok = (bool(torch.all(diff <= rtol * (1 + ref.float().abs())))
          and bool(torch.isfinite(out.float()).all()))
    row = {"phase": "linear-kernel", "kernel": "fp6_matmul", "case": name,
           "M": m, "K": k, "N": n, "dtype": dt, "route": t6.route(x, packed),
           "max_abs_err": float(diff.max()),
           "tolerance": f"|k-r| <= {rtol} * (1 + |r|)", "ok": ok}
    if timed:
        elem = x.element_size()
        nbytes = packed.numel() + scale.numel() * 4 + m * k * elem + m * n * elem
        peak = FP32_FLOPS if dt == "float32" else BF16_FLOPS
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * m * k * n, peak)
        row.update(**kernel_ms(lambda: t6.fp6_matmul(x, packed, scale)),
                   plain_ms=cuda_time_ms(
                       lambda: t6.fp6_matmul_ref(x, packed, scale), iters=3,
                       warmup=1),
                   bound_bytes=nbytes)
        wd = t6.fp6_dequantize(packed, scale, dtype)
        row["library_ms"] = cuda_time_ms(lambda: torch.matmul(x, wd))
        row["library_note"] = (f"torch.matmul of x with the dequantized "
                               f"{dt} weight")
        row["library_bound_ms"] = bound_ms(
            k * n * elem + m * k * elem + m * n * elem, 2.0 * m * k * n, peak)[0]
        del wd
    emit(row)
    if not ok:
        fail(f"fp6_matmul disagrees with its plain version ({name})")
    return row


def phase_linear_kernels(qk, t6):
    import torch

    summary = {}
    for case in QUANT_CASES:
        rows = quant_case(qk, case)
        if case[-1]:
            summary.update(rows)
        else:
            for k, r in rows.items():   # the worst error over every case
                summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"],
                                                r["max_abs_err"])
        torch.cuda.empty_cache()
    for case in FP6_CASES:
        row = fp6_case(t6, case)
        if case[0] == "path gate/up":
            summary["fp6_matmul"] = row
        torch.cuda.empty_cache()
    return summary


def phase_linear_reference(ds, lin, counters, all_counters):
    """The LoRAStack cut to hidden 512, intermediate 1024, 2 blocks, fp32:
    the same weights quantized on the card (kernels) and on the CPU (plain
    versions) must give the same bytes; two train_batch steps on each
    (micro 2, gas 2, seq 64) must agree to REF_RTOL on loss, grad norm and
    adapters, and the card's steps launch the expected kernels."""
    import numpy as np
    import torch

    hidden, inter, blocks = 512, 1024, 2
    cfg = {**LINEAR_CFG, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2}
    rng = np.random.default_rng(23)
    batch = {k: rng.standard_normal((4, 64, hidden)).astype(np.float32)
             for k in ("x", "y")}
    for q_bits in (4, 6, 8):
        weights = [[w.cpu() for w in block] for block in stack_weights(
            hidden, inter, blocks, 24, torch.float32, "cuda")]
        zero_counts(*all_counters)
        card_stack = LoRAStack(lin, [[w.cuda() for w in b] for b in weights],
                               q_bits, LINEAR_GROUP, torch.float32)
        built = {k: v for c in counters for k, v in c.items()}
        host_stack = LoRAStack(lin, weights, q_bits, LINEAR_GROUP,
                               torch.float32)
        same_bytes = all(
            torch.equal(a.base.data.cpu(), b.base.data)
            and torch.equal(a.base.scale.cpu(), b.base.scale)
            for ba, bb in zip(card_stack.blocks, host_stack.blocks)
            for a, b in zip(ba.values(), bb.values()))
        card, *_ = ds.initialize(model=card_stack, config=cfg, seed=1)
        host, *_ = ds.initialize(
            model=host_stack, config=cfg, device="cpu",
            model_parameters={b: {n: {k: v.detach().cpu() for k, v in p.items()}
                                  for n, p in blk.items()}
                              for b, blk in card.params.items()})
        zero_counts(*all_counters)
        steps, worst = [], 0.0
        for _ in range(2):
            lc, lh = float(card.train_batch(batch)), float(host.train_batch(batch))
            gc_, gh = card.get_global_grad_norm(), host.get_global_grad_norm()
            steps.append({"loss_card": lc, "loss_cpu": lh,
                          "grad_norm_card": gc_, "grad_norm_cpu": gh})
            worst = max(worst, abs(lc - lh) / abs(lh), abs(gc_ - gh) / gh)
        launched = {k: v for c in all_counters for k, v in c.items()}
        num = den = 0.0
        for blk in card.params:
            for n in card.params[blk]:
                for k in ("lora_A", "lora_B"):
                    a = card.params[blk][n][k].detach().cpu().double()
                    b = host.params[blk][n][k].detach().double()
                    num += float(((a - b) ** 2).sum())
                    den += float((b ** 2).sum())
        params_rel = (num / den) ** 0.5
        micro = 2 * 2 * 3 * blocks          # steps x gas x projections x blocks
        want_built = expected(counters, quantize=3 * blocks if q_bits != 6 else 0)
        want = expected(all_counters, fused_adamw=2,
                        **({"fp6_matmul": micro, "fp6_matmul.fma": micro}
                           if q_bits == 6 else {"dequantize": micro}))
        emit({"phase": "linear-reference", "q_bits": q_bits, "hidden": hidden,
              "intermediate": inter, "blocks": blocks, "dtype": "float32",
              "micro": 2, "gas": 2, "seq": 64, "group": LINEAR_GROUP,
              "lora_r": 64, "bases_bytes_equal": same_bytes, "steps": steps,
              "check": "card (kernels, cuBLAS) vs CPU (plain versions)",
              "max_rel_err_loss_grad_norm": worst, "adapters_rel_l2": params_rel,
              "tolerance": REF_RTOL, "construction_launches": built,
              "expected_construction": want_built, "launches": launched,
              "expected": want})
        if not same_bytes:
            fail(f"linear-reference q{q_bits}: bases quantized on the card "
                 "differ from the CPU's")
        if worst > REF_RTOL or params_rel > REF_RTOL:
            fail(f"linear-reference q{q_bits}: card training differs from "
                 f"the CPU's: {worst}, {params_rel}")
        if launched != want or built != want_built:
            fail(f"linear-reference q{q_bits}: launched {built} / {launched}, "
                 f"expected {want_built} / {want}")
        del card, host, card_stack, host_stack
        torch.cuda.empty_cache()


def adapter_leaves(params):
    """((block, projection, name), leaf) over a LoRAStack's params."""
    for blk, projs in params.items():
        for proj, leaves in projs.items():
            for name, leaf in leaves.items():
                yield (blk, proj, name), leaf


def linear_first_update(stack, eng, before, batch):
    """The engine's first step on the adapters (``before`` -> ``eng.params``)
    against the same step in fp32 with plain ops only: each base
    dequantized to fp32 by its plain version, the stack's forward and
    backward per micro-batch, the mean over the micro-batches, the clip and
    one AdamW step by ``adamw_leaf_ref``.  Returns the relative L2 error of
    the update over every adapter leaf, the plain grad norm and the relative
    error of the engine's."""
    import torch

    from deepspeed_tpu_torch.ops import fp6_linear as t6
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.ops import quantize as qk
    from deepspeed_tpu_torch.ops import quantizer

    def plain_weight(base):
        if base.q_bits == 6:
            return t6.fp6_dequantize(base.data, base.scale, torch.float32)
        q = quantizer.unpack_int4(base.data) if base.q_bits == 4 else base.data
        return qk.dequantize_ref(q, base.scale, torch.float32)

    ws = [{n: plain_weight(layer.base) for n, layer in blk.items()}
          for blk in stack.blocks]
    ps = {k: v.clone().requires_grad_(True) for k, v in before.items()}
    s = stack.lora_config.lora_alpha / stack.lora_config.lora_r
    gas = eng.gradient_accumulation_steps()
    micro = batch["x"].shape[0] // gas
    for i in range(gas):
        rows = slice(i * micro, (i + 1) * micro)
        h = batch["x"][rows].float()
        for b, blk in enumerate(ws):
            def proj(n, x, b=b, blk=blk):
                a, bb = ps[(f"block{b}", n, "lora_A")], ps[(f"block{b}", n, "lora_B")]
                return x @ blk[n] + s * ((x @ a) @ bb)
            h = h + proj("down", torch.nn.functional.silu(proj("gate", h))
                         * proj("up", h))
        torch.mean(torch.square(h - batch["y"][rows])).backward()
    del ws, h
    opt, lr = eng.optimizer, LINEAR_CFG["optimizer"]["params"]["lr"]
    after = dict(adapter_leaves(eng.params))
    with torch.no_grad():
        grads = {k: p.grad / gas for k, p in ps.items()}
        norm = float(torch.sqrt(sum(torch.sum(torch.square(g))
                                    for g in grads.values())))
        coef = min(1.0, LINEAR_CFG["gradient_clipping"] / (norm + 1e-6))
        num = den = 0.0
        for k, g in grads.items():
            p = before[k].clone()
            fo.adamw_leaf_ref(p, g * coef, torch.zeros_like(p),
                              torch.zeros_like(p), lr, 1 - opt.b1, 1 - opt.b2,
                              opt.b1, opt.b2, opt.eps, opt.wd)
            d_ref = (p - before[k]).double()
            d_eng = (after[k].detach() - before[k]).double()
            num += float(torch.sum(torch.square(d_eng - d_ref)))
            den += float(torch.sum(torch.square(d_ref)))
    return ((num / den) ** 0.5, norm,
            abs(eng.get_global_grad_norm() - norm) / norm)


def phase_linear_train(ds, lin, all_counters, card, q_bits):
    """The LoRAStack at llama3-8b width and LINEAR_BLOCKS blocks in bf16:
    build (counting the construction's quantize launches), a warm-up step
    held to the same step in fp32 with plain ops (``linear_first_update``),
    TRAIN_STEPS timed steps on one fixed batch (counts zeroed just before
    and read just after: fp6_matmul or dequantize 3 x blocks x gas times a
    step, fused_adamw once, nothing else), then a profiled step.  Returns
    (construction launches, timed steps' launches)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import registry

    mc = registry.get_model_config(LINEAR_MODEL)
    hidden, inter = mc.hidden_size, mc.intermediate_size
    zero_counts(*all_counters)
    t0 = time.perf_counter()
    stack = LoRAStack(lin, stack_weights(hidden, inter, LINEAR_BLOCKS, 25,
                                         torch.bfloat16, "cuda"),
                      q_bits, LINEAR_GROUP, torch.bfloat16)
    eng, *_ = ds.initialize(model=stack, config=LINEAR_CFG, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    built = {k: v for c in all_counters for k, v in c.items()}
    want_built = expected(all_counters, quantize=3 * LINEAR_BLOCKS
                          if q_bits != 6 else 0)
    micro, gas = (LINEAR_CFG["train_micro_batch_size_per_gpu"],
                  LINEAR_CFG["gradient_accumulation_steps"])
    rows = micro * gas * LINEAR_SEQ
    # inputs and target of std LINEAR_X_STD (see its note), on the card
    gen = torch.Generator(device="cuda").manual_seed(26)
    shape = (micro * gas, LINEAR_SEQ, hidden)
    batch = {"x": (torch.randn(shape, generator=gen, device="cuda")
                   * LINEAR_X_STD).to(torch.bfloat16),
             "y": torch.randn(shape, generator=gen, device="cuda") * LINEAR_X_STD}
    before = {k: v.detach().clone() for k, v in adapter_leaves(eng.params)}
    t0 = time.perf_counter()
    losses = [float(eng.train_batch(batch))]     # warm-up
    warm_s = time.perf_counter() - t0
    update_err, plain_norm, norm_err = linear_first_update(stack, eng, before,
                                                           batch)
    del before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*all_counters)
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)))   # float() syncs
        step_s.append(time.perf_counter() - t0)
    launches = {k: v for c in all_counters for k, v in c.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    n_proj = 3 * LINEAR_BLOCKS * gas
    # every FP6 GEMM of the step on the wgmma route
    want = expected(all_counters, fused_adamw=1,
                    **({"fp6_matmul": n_proj, "fp6_matmul.wgmma": n_proj}
                       if q_bits == 6 else {"dequantize": n_proj}))
    # base products forward and dx backward: 2 x 2 x K x N a row a projection
    flops = 2 * 2.0 * rows * 3 * hidden * inter * LINEAR_BLOCKS
    base_bytes = stack.nbytes()
    bf16_bytes = 3 * hidden * inter * LINEAR_BLOCKS * 2
    first_ok = max(update_err, norm_err) <= LINEAR_UPDATE_RTOL
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0] and first_ok
          and per_step == want and built == want_built)
    emit({"phase": "linear-train", "model": f"{LINEAR_MODEL} MLP width",
          "hidden": hidden, "intermediate": inter, "blocks": LINEAR_BLOCKS,
          "q_bits": q_bits, "group": LINEAR_GROUP if q_bits != 6 else None,
          "lora_r": 64, "lora_alpha": 16.0, "dtype": "bfloat16",
          "optimizer": LINEAR_CFG["optimizer"], "micro": micro, "gas": gas,
          "seq": LINEAR_SEQ, "x_std": LINEAR_X_STD, "rows_per_step": rows,
          "init_s": init_s,
          "warmup_step_s": warm_s, "step_s": step_s,
          "rows_per_s": rows * TRAIN_STEPS / sum(step_s),
          "base_tflops_per_s": flops * TRAIN_STEPS / sum(step_s) / 1e12,
          "losses": losses,
          "first_step_vs_fp32_plain": {
              "update_rel_l2": update_err, "grad_norm_rel_err": norm_err,
              "grad_norm_plain": plain_norm, "tolerance": LINEAR_UPDATE_RTOL},
          "max_memory_allocated_gib": peak_gb,
          "bases_nbytes": base_bytes, "bases_bf16_bytes": bf16_bytes,
          "bases_fraction_of_bf16": base_bytes / bf16_bytes,
          "adapter_leaves": 2 * 3 * LINEAR_BLOCKS,
          "construction_launches": built, "expected_construction": want_built,
          "launches": launches, "launches_per_step": per_step,
          "expected_per_step": want, "card": card, "ok": ok})
    if not ok:
        fail(f"linear-train q{q_bits}: losses not finite and falling, the "
             "first step off the fp32 plain step, or the launch counts do "
             "not show the kernels")

    wall_ms, by_name, busy_ms, _ = profile_call(lambda: eng.train_batch(batch))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "linear-train-profile",
          "what": f"one train_batch, LoRAStack q_bits {q_bits}",
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "kernel_ms": {n: sum(v for k, v in by_name.items()
                               if all(x in k for x in parts))
                        for n, parts in PROFILE_NAMES.items() if want.get(n)},
          "gemm_ms": sum(v for k, v in by_name.items()
                         if any(x in k for x in ("gemm", "nvjet", "cutlass",
                                                 "xmma"))),
          "top_kernels_ms": [[k[:90], v] for k, v in top], "card": card})
    del eng, stack, batch
    torch.cuda.empty_cache()
    return built, launches


# ----------------------------------------------------------------------
# phases 17-19: ring sequence parallelism over two ranks sharing the card
# ----------------------------------------------------------------------
def ring_pairs(s, causal, window, pos):
    """(query, key) pairs a hop keeps: for each query row, its key columns
    under the causal and window tests on global positions (``pos`` =
    q_off, q_stride, k_off, k_stride)."""
    import numpy as np

    q_off, q_stride, k_off, k_stride = pos
    qpos = q_off + q_stride * np.arange(s)
    hi = (np.clip((qpos - k_off) // k_stride + 1, 0, s) if causal
          else np.full(s, s))
    lo = (np.clip(-((k_off - qpos + window - 1) // k_stride), 0, s)
          if window else np.zeros(s, np.int64))
    return int(np.sum(np.maximum(hi - lo, 0)))


def ring_mask(s, causal, window, pos, device):
    """The hop's [S, S] boolean position mask (SDPA's, as the yardstick)."""
    import torch

    q_off, q_stride, k_off, k_stride = pos
    qp = q_off + q_stride * torch.arange(s, device=device)[:, None]
    kp = k_off + k_stride * torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < window
    return mask


def ring_bounds(b, hq, hkv, s, d, elem, pairs, fp32, kv_row_bytes=None):
    """Least time of the carry, dq and dk/dv kernels of one hop: operands
    read once and outputs written once (the fp32 carry and accumulators
    are read and written in place) against 2, 3 and 4 products of
    pairs x d per head.  ``kv_row_bytes``: the bytes of one K or V row when
    they are not d x elem (the int8 wire: d payload bytes and a 4-byte
    scale)."""
    kv_row = d * elem if kv_row_bytes is None else kv_row_bytes
    q_bytes, kv_bytes, rows = b * hq * s * d * elem, b * hkv * s * kv_row, b * hq * s * 4
    qacc, kvacc = b * hq * s * d * 4, b * hkv * s * d * 4
    per_pair = 2.0 * pairs * d * hq * b
    work = [(q_bytes + 2 * kv_bytes + 4 * rows + 2 * qacc, 2 * per_pair),
            (2 * q_bytes + 2 * kv_bytes + 2 * rows + 2 * qacc, 3 * per_pair),
            (2 * q_bytes + 2 * kv_bytes + 2 * rows + 4 * kvacc, 4 * per_pair)]
    peak = FP32_FLOPS if fp32 else BF16_FLOPS
    return [bound_ms(nbytes, flops, peak) for nbytes, flops in work]


def ring_walks(s, causal, window, pos, tq, tk):
    """Each query tile's live key tiles and each key tile's live query
    tiles (counts) of a hop on tq x tk tiles: the bounds RingOffsetsT of
    ops/csrc/ring_attention.cu computes (k_begin/k_end, q_begin/q_end)."""
    q_off, q_stride, k_off, k_stride = pos
    nq, nk = -(-s // tq), -(-s // tk)

    def ceil_div(a, d):
        return -((-a) // d)

    def k_range(iq):
        lo = 0
        if window:
            c = ceil_div(q_off + q_stride * iq * tq - window + 1 - k_off, k_stride)
            lo = 0 if c <= 0 else min(c, s) // tk
        hi = nk
        if causal:
            c = (q_off + q_stride * min(iq * tq + tq - 1, s - 1) - k_off) // k_stride
            hi = 0 if c < 0 else min(c // tk + 1, nk)
        return max(hi - lo, 0)

    def q_range(ik):
        lo = 0
        if causal:
            r = ceil_div(k_off + k_stride * ik * tk - q_off, q_stride)
            lo = 0 if r <= 0 else min(r, s) // tq
        hi = nq
        if window:
            r = (k_off + k_stride * min(ik * tk + tk - 1, s - 1) + window - 1
                 - q_off) // q_stride
            hi = 0 if r < 0 else min(r // tq + 1, nq)
        return max(hi - lo, 0)

    return [k_range(i) for i in range(nq)], [q_range(i) for i in range(nk)]


def snake_tail(lengths, sms):
    """The persistent kernels' schedule (attention_wgmma_bwd.cuh `snake`):
    item i of len(lengths) on block r*G + x or r*G + G-1-x by round parity,
    G = min(items, sms).  Returns the largest and the mean of the blocks'
    summed walks (tiles), the tail being their ratio."""
    n = len(lengths)
    g = min(n, sms)
    load = [0] * g
    for i, length in enumerate(lengths):
        r, x = divmod(i, g)
        load[x if r % 2 == 0 else g - 1 - x] += length
    return max(load), sum(load) / g


def ring_schedule(s, hq, hkv, b, causal, window, pos, sms):
    """The two backward kernels' schedule tails at a case's shape: dq items
    are 128-row query tiles (longest walks first) walking 64-key tiles,
    dk/dv items 128-key tiles (low tiles first) walking their group's
    64-row query tiles."""
    dq_walk, _ = ring_walks(s, causal, window, pos, 128, 64)
    _, dkv_walk = ring_walks(s, causal, window, pos, 64, 128)
    dq_items = [w for w in reversed(dq_walk) for _ in range(hq * b)]
    dkv_items = [w * (hq // hkv) for w in dkv_walk for _ in range(hkv * b)]
    out = {}
    for name, items in (("ring_bwd_dq", dq_items), ("ring_bwd_dkv", dkv_items)):
        worst, mean = snake_tail(items, sms)
        out[name] = {"items": len(items), "blocks": min(len(items), sms),
                     "max_block_tiles": worst, "mean_block_tiles": mean,
                     "tail": worst / mean if mean else None}
    return out


def ring_case(fm, case, phase="ring-kernel"):
    """The three hop kernels of one case against their plain versions on
    the same inputs: the hop from a fresh carry, dq and dk/dv into seeded
    fp32 accumulators from the carry's lse.  Path-shape cases are timed
    (CUDA events; the in-place kernels re-run on their own output), beside
    the plain versions and scaled_dot_product_attention under the hop's
    position mask (one hop's attention without the carry merge, forward
    and backward).  A head_dim off the lanes hops as ring_attention runs
    it: q, k, v, do and the fp32 state zero-padded to the lane once (the
    kernels timed so), compared on the real D."""
    import torch
    import torch.nn.functional as F

    name, b, hq, hkv, s, d, dt, causal, window, pos, timed = case
    q, k, v, do = bshd_inputs(b, hq, hkv, s, d, getattr(torch, dt), seed=13)
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale, window=window)
    gen = torch.Generator(device="cuda").manual_seed(14)
    lane = fm.head_dim_lane(d)
    pad = lane_pad(lane)
    qp, kp, vp, dop = (pad(x) for x in (q, k, v, do))

    def fresh(width=d):
        return (torch.full((b, hq, s), fm.NEG_INF, device="cuda"),
                torch.zeros((b, hq, s), device="cuda"),
                torch.zeros((b, hq, s, width), device="cuda"))

    def small(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.1

    state, ref = fresh(lane), fresh()
    route = {"ring_carry": fm.fwd_route(qp, kp, vp),
             "ring_bwd_dq": fm.bwd_route(qp, kp, vp, dop),
             "ring_bwd_dkv": fm.bwd_route(qp, kp, vp, dop)}
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(qp, kp, vp, *state, pos, **kw)
    fm.ring_carry_ref(q, k, v, *ref, pos, causal, scale, window)
    m, l, _ = ref
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    delta = small(b, hq, s)
    acc0 = [small(b, hq, s, d), small(b, hkv, s, d), small(b, hkv, s, d)]
    got = [pad(t).clone() for t in acc0]
    want = [t.clone() for t in acc0]
    bwd = (q, k, v, do, lse, delta)
    bwd_k = (qp, kp, vp, dop, lse, delta)
    fm.flash_ring_dq_block(*bwd_k, got[0], pos, **kw)
    fm.flash_ring_dkv_block(*bwd_k, got[1], got[2], pos, **kw)
    fm.ring_bwd_dq_ref(*bwd, want[0], pos, causal, scale, window)
    fm.ring_bwd_dkv_ref(*bwd, want[1], want[2], pos, causal, scale, window)
    torch.cuda.synchronize()
    taken = {n: c - routes[n] for n, c in fm.ring_routes.items()
             if c != routes[n]}
    if taken != {f"{n}.{r}": 1 for n, r in route.items()}:
        fail(f"{phase} ({name}): routes {taken}, expected {route}")
    rtol = FLASH_RTOL[dt]
    safe = [x[1].clamp(min=1e-20)[..., None] for x in (state, ref)]
    cut = [x[..., :d] for x in got]
    checks = {
        "ring_carry": [(state[0], ref[0], 1e-4), (state[1], ref[1], rtol),
                       (state[2][..., :d] / safe[0], ref[2] / safe[1], rtol)],
        "ring_bwd_dq": [(cut[0], want[0], rtol)],
        "ring_bwd_dkv": [(cut[1], want[1], rtol), (cut[2], want[2], rtol)]}
    pairs = ring_pairs(s, causal, window, pos)
    bounds = ring_bounds(b, hq, hkv, s, d, q.element_size(), pairs,
                         dt == "float32")
    rows = {}
    for (kname, pairs_), (bound, by) in zip(checks.items(), bounds):
        err, ok = 0.0, True
        for g, r, tol in pairs_:
            diff = (g.float() - r.float()).abs()
            err = max(err, float(diff.max()))
            ok &= bool(torch.all(diff <= tol * (1 + r.float().abs())))
            ok &= bool(torch.isfinite(g).all())
        rows[kname] = {"phase": phase, "case": name, "kernel": kname,
                       "route": route[kname],
                       "lane": "native" if lane == d else f"padded to {lane}",
                       "B": b, "Hq": hq, "Hkv": hkv, "S_l": s, "D": d,
                       "dtype": dt, "causal": causal, "window": window,
                       "pos": list(pos), "pairs": pairs,
                       "max_abs_err": err, "ok": ok,
                       "tolerance": "|k-r| <= rtol * (1 + |r|) on m (1e-4), "
                                    f"l, acc/l, dq, dk, dv (rtol {rtol})",
                       "bound_ms": bound, "bound_by": by}
    if timed:
        st, st_r = fresh(lane), fresh()
        calls = {"ring_carry": (lambda: fm.flash_carry_block(qp, kp, vp, *st, pos, **kw),
                                lambda: fm.ring_carry_ref(q, k, v, *st_r, pos, causal,
                                                          scale, window)),
                 "ring_bwd_dq": (lambda: fm.flash_ring_dq_block(*bwd_k, got[0], pos, **kw),
                                 lambda: fm.ring_bwd_dq_ref(*bwd, want[0], pos, causal,
                                                            scale, window)),
                 "ring_bwd_dkv": (lambda: fm.flash_ring_dkv_block(
                     *bwd_k, got[1], got[2], pos, **kw),
                     lambda: fm.ring_bwd_dkv_ref(*bwd, want[1], want[2], pos, causal,
                                                 scale, window))}
        for kname, (kern, plain) in calls.items():
            rows[kname].update(kernel_ms(kern))
            rows[kname]["plain_ms"] = cuda_time_ms(plain, iters=2, warmup=1)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for kname, sched in ring_schedule(s, hq, hkv, b, causal, window, pos,
                                          sms).items():
            if route[kname] == "wgmma":    # the persistent walks' balance
                rows[kname]["schedule"] = sched
        mask = ring_mask(s, causal, window, pos, "cuda")
        lib = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        sdpa = (lambda: F.scaled_dot_product_attention(
            *lib, attn_mask=mask, scale=scale, enable_gqa=hq != hkv))
        with torch.no_grad():
            rows["ring_carry"]["library_ms"] = cuda_time_ms(sdpa)
        pair_ms = grad_time_ms(sdpa, lib, do)
        note = ("scaled_dot_product_attention under the hop's boolean "
                "position mask: one hop's attention without the carry merge")
        rows["ring_carry"]["library_note"] = note
        for kname in ("ring_bwd_dq", "ring_bwd_dkv"):
            rows[kname]["library_ms"] = pair_ms
            rows[kname]["library_note"] = f"{note}; backward, dq, dk and dv together"
    for r in rows.values():
        emit(r)
        if not r["ok"]:
            fail(f"{r['kernel']} disagrees with its plain version ({r['case']})")
    return rows


# name, b, hq, hkv, s_l, d, dtype, causal, window, (q_off, q_stride, k_off,
# k_stride), timed.  The path: llama3-8b attention geometry, 4096 tokens a
# rank of two; striped rank 1 holds positions 1, 3, ..., contiguous rank 1
# positions 4096 on.
RING_CASES = [
    ("path-striped-hop0", 1, 32, 8, 4096, 128, "bfloat16", True, None,
     (1, 2, 1, 2), True),
    ("path-striped-hop1", 1, 32, 8, 4096, 128, "bfloat16", True, None,
     (1, 2, 0, 2), True),
    ("path-contiguous-hop0", 1, 32, 8, 4096, 128, "bfloat16", True, None,
     (4096, 1, 4096, 1), True),
    ("path-contiguous-live", 1, 32, 8, 4096, 128, "bfloat16", True, None,
     (4096, 1, 0, 1), True),
    ("mha-d64", 2, 16, 16, 1024, 64, "bfloat16", True, None, (1, 2, 0, 2),
     False),
    ("window", 1, 16, 4, 2048, 128, "bfloat16", True, 512,
     (2048, 1, 0, 1), False),
    ("noncausal", 1, 16, 4, 1024, 128, "bfloat16", False, None,
     (0, 1, 1024, 1), False),
    ("tail", 1, 8, 2, 1000, 128, "bfloat16", True, None, (1, 2, 0, 2), False),
    ("fp32", 1, 8, 2, 1024, 128, "float32", True, None, (1, 2, 0, 2), False),
]
RING_ROW_CASE = "path-striped-hop1"   # the kernels line's row: a live
                                      # off-diagonal hop of the main path


# the whole-ring check: b, hq, hkv, S_l, d of two ranks' shards
RING_WHOLE = (1, 32, 8, 1024, 128)


def ring_whole_check(fm):
    """A two-rank causal ring at S_l 1024 (llama3-8b heads), both
    placements, bf16, every hop on the wgmma route.  Forward: each rank's
    hops as sequence/ring.py runs them (its own block, then the other's
    unless it is dead) through the carry, normalised once, against
    flash_fwd_ref over the unsplit 2048 positions.  Backward: from each
    rank's carried o and lse, the same hops through ring_bwd_dq into the
    rank's dq and through ring_bwd_dkv into the visiting block's dk/dv,
    which travel with it and end at the block's owner, against
    flash_bwd_ref over the unsplit positions.  Both at FLASH_RTOL.  This
    holds the accumulate mode across hops on the main path's route (the
    ring-reference phase runs fp32, on the fma route)."""
    import torch

    b, hq, hkv, s_l, d = RING_WHOLE
    ranks, scale = 2, d ** -0.5
    q, k, v, do = bshd_inputs(b, hq, hkv, ranks * s_l, d, torch.bfloat16,
                              seed=15)
    o_ref, lse_ref = fm.flash_fwd_ref(q, k, v, True, scale)
    grads_ref = fm.flash_bwd_ref(q, k, v, o_ref, lse_ref, do, True, scale)
    rtol = FLASH_RTOL["bfloat16"]
    kernels = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")

    def close(got, want):
        want = want.float()
        diff = (got.float() - want).abs()
        return (float(diff.max()),
                bool(torch.all(diff <= rtol * (1 + want.abs())))
                and bool(torch.isfinite(got.float()).all()))

    for placement in ("striped", "contiguous"):
        def block(j):     # global positions of block j, and (off, stride)
            if placement == "striped":
                return torch.arange(s_l, device="cuda") * ranks + j, (j, ranks)
            return torch.arange(s_l, device="cuda") + j * s_l, (j * s_l, 1)

        def hops_of(r):   # rank r's live hops in ring order: (src, pos)
            rows, q_pos = block(r)
            for src in (r, 1 - r):
                cols, k_pos = block(src)
                if int(cols.min()) <= int(rows.max()):   # else dead: no launch
                    yield src, (*q_pos, *k_pos)

        routes, hops = dict(fm.ring_routes), 0
        err = {"o": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        ok = True
        shard = [{n: x[:, :, block(r)[0]].contiguous()
                  for n, x in (("q", q), ("k", k), ("v", v), ("do", do))}
                 for r in range(ranks)]
        for r in range(ranks):
            sh = shard[r]
            m = torch.full((b, hq, s_l), fm.NEG_INF, device="cuda")
            l = torch.zeros((b, hq, s_l), device="cuda")
            acc = torch.zeros((b, hq, s_l, d), device="cuda")
            for src, pos in hops_of(r):
                fm.flash_carry_block(sh["q"], shard[src]["k"], shard[src]["v"],
                                     m, l, acc, pos, causal=True, sm_scale=scale)
                hops += 1
            safe = l.clamp(min=1e-20)
            sh["o"] = (acc / safe[..., None]).to(torch.bfloat16)
            sh["lse"] = (m + torch.log(safe)).contiguous()
            sh["delta"] = fm.attn_delta(sh["o"], sh["do"]).contiguous()
            e, good = close(sh["o"], o_ref[:, :, block(r)[0]])
            err["o"], ok = max(err["o"], e), ok and good
        dq = [torch.zeros((b, hq, s_l, d), device="cuda") for _ in range(ranks)]
        dkv = [[torch.zeros((b, hkv, s_l, d), device="cuda") for _ in range(2)]
               for _ in range(ranks)]
        for hop in range(2):     # every rank's hop 0, then every rank's hop 1
            for r in range(ranks):
                live = list(hops_of(r))
                if hop >= len(live):
                    continue
                src, pos = live[hop]
                sh = shard[r]
                bwd = (sh["q"], shard[src]["k"], shard[src]["v"], sh["do"],
                       sh["lse"], sh["delta"])
                fm.flash_ring_dq_block(*bwd, dq[r], pos, causal=True,
                                       sm_scale=scale)
                fm.flash_ring_dkv_block(*bwd, *dkv[src], pos, causal=True,
                                        sm_scale=scale)
        for r in range(ranks):
            rows = block(r)[0]
            for name, got, want in (("dq", dq[r], grads_ref[0]),
                                    ("dk", dkv[r][0], grads_ref[1]),
                                    ("dv", dkv[r][1], grads_ref[2])):
                e, good = close(got.to(torch.bfloat16), want[:, :, rows])
                err[name], ok = max(err[name], e), ok and good
        taken = {n: c - routes[n] for n, c in fm.ring_routes.items()
                 if c != routes[n]}
        ok &= taken == {f"{n}.wgmma": hops for n in kernels}
        emit({"phase": "ring-whole", "placement": placement, "ranks": ranks,
              "B": b, "Hq": hq, "Hkv": hkv, "S_l": s_l, "D": d,
              "dtype": "bfloat16", "hops": hops, "routes": taken,
              "check": "each rank's carried hops, normalised once, against "
                       "flash_fwd_ref; each rank's dq and each block's dk/dv "
                       "(carried back to its owner) against flash_bwd_ref; "
                       "over the unsplit sequence",
              "max_abs_err": err,
              "tolerance": f"|k-r| <= {rtol} * (1 + |r|)", "ok": ok})
        if not ok:
            fail(f"ring-whole ({placement}): the ring differs from attention "
                 "over the unsplit sequence, or a hop left the wgmma route")


def phase_ring_kernels(fm):
    import torch

    summary = {}
    for case in RING_CASES:
        rows = ring_case(fm, case)
        if case[0] == RING_ROW_CASE:
            summary.update(rows)
        torch.cuda.empty_cache()
    ring_whole_check(fm)
    torch.cuda.empty_cache()
    return summary


# the int8 K/V lanes (ring-int8-kernels): name, b, hq, hkv, s_l, d, q dtype,
# causal, window, pos, timed.  The path: ring-train-int8's visiting hop
# (llama3-8b heads, 4096 tokens a rank of two, striped rank 1 <- block 0).
RING_INT8_CASES = [
    ("path-striped-hop1-int8", 1, 32, 8, 4096, 128, "bfloat16", True, None,
     (1, 2, 0, 2), True),
    ("contiguous-tail-130", 1, 8, 2, 130, 128, "bfloat16", True, None,
     (130, 1, 0, 1), False),
    ("fp32-q", 1, 8, 2, 1024, 128, "float32", True, None, (1, 2, 0, 2),
     False),
    ("d256", 1, 16, 16, 2048, 256, "bfloat16", True, None, (1, 2, 0, 2),
     False),
]
RING_INT8_ROW_CASE = "path-striped-hop1-int8"


def int8_routes(dt, d):
    """Each ring kernel's int8 lane for q of dtype ``dt`` at head dim ``d``
    over views TMA reads."""
    kernels = tuple(RING_INT8_ROUTES)
    if dt == "float32":
        return dict.fromkeys(kernels, "fma_s8")
    return dict(RING_INT8_ROUTES) if d in (64, 128) else dict.fromkeys(kernels, "mma_s8")


def ring_int8_case(fm, codec, case):
    """The three hop kernels' int8 lanes of one case against their plain
    versions on the same inputs: K/V of the case encoded by the wire codec
    (int8 payloads, one fp32 scale a row), the hop from a fresh carry, dq
    and dk/dv into seeded fp32 accumulators from the carry's lse; each
    kernel on its lane (:func:`int8_routes`).  The path case is timed
    beside the plain versions, scaled_dot_product_attention under the
    hop's mask on the decoded bf16 K/V (the decode not counted) and, for
    each kernel on ``wgmma_s8``, the 64 x 64 walk's lane (``mma_s8``, the
    lane before its redesign) on the same inputs, by graph and by
    stream."""
    import torch
    import torch.nn.functional as F

    name, b, hq, hkv, s, d, dt, causal, window, pos, timed = case
    q, k, v, do = bshd_inputs(b, hq, hkv, s, d, getattr(torch, dt), seed=16)
    (kp, ks), (vp, vs) = (codec.wire_encode_rows(x, "int8") for x in (k, v))
    wire = dict(k_scale=ks[..., 0], v_scale=vs[..., 0])
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale, window=window)
    gen = torch.Generator(device="cuda").manual_seed(17)

    def fresh():
        return (torch.full((b, hq, s), fm.NEG_INF, device="cuda"),
                torch.zeros((b, hq, s), device="cuda"),
                torch.zeros((b, hq, s, d), device="cuda"))

    def small(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.1

    want_route = int8_routes(dt, d)
    state, ref = fresh(), fresh()
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, kp, vp, *state, pos, **kw, **wire)
    fm.ring_carry_ref(q, kp, vp, *ref, pos, causal, scale, window, **wire)
    m, l, _ = ref
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    delta = small(b, hq, s)
    acc0 = [small(b, hq, s, d), small(b, hkv, s, d), small(b, hkv, s, d)]
    got = [t.clone() for t in acc0]
    want = [t.clone() for t in acc0]
    bwd = (q, kp, vp, do, lse, delta)
    fm.flash_ring_dq_block(*bwd, got[0], pos, **kw, **wire)
    fm.flash_ring_dkv_block(*bwd, got[1], got[2], pos, **kw, **wire)
    fm.ring_bwd_dq_ref(*bwd, want[0], pos, causal, scale, window, **wire)
    fm.ring_bwd_dkv_ref(*bwd, want[1], want[2], pos, causal, scale, window,
                        **wire)
    torch.cuda.synchronize()
    taken = {n: c - routes[n] for n, c in fm.ring_routes.items()
             if c != routes[n]}
    if taken != {f"{n}.{r}": 1 for n, r in want_route.items()}:
        fail(f"ring-int8-kernels ({name}): routes {taken}, expected "
             f"{want_route}")
    rtol = RING_INT8_RTOL[dt]
    safe = [x[1].clamp(min=1e-20)[..., None] for x in (state, ref)]
    checks = {
        "ring_carry": [(state[0], ref[0], 1e-4), (state[1], ref[1], rtol),
                       (state[2] / safe[0], ref[2] / safe[1], rtol)],
        "ring_bwd_dq": [(got[0], want[0], rtol)],
        "ring_bwd_dkv": [(got[1], want[1], rtol), (got[2], want[2], rtol)]}
    pairs = ring_pairs(s, causal, window, pos)
    bounds = ring_bounds(b, hq, hkv, s, d, q.element_size(), pairs,
                         dt == "float32", kv_row_bytes=d + 4)
    rows = {}
    for (kname, pairs_), (bound, by) in zip(checks.items(), bounds):
        err, ok = 0.0, True
        for g, r, tol in pairs_:
            diff = (g.float() - r.float()).abs()
            err = max(err, float(diff.max()))
            ok &= bool(torch.all(diff <= tol * (1 + r.float().abs())))
            ok &= bool(torch.isfinite(g).all())
        rows[kname] = {"phase": "ring-int8-kernels", "case": name,
                       "kernel": kname, "route": want_route[kname],
                       "lane": "int8 K/V + fp32 row scales",
                       "B": b, "Hq": hq, "Hkv": hkv, "S_l": s, "D": d,
                       "dtype": dt, "causal": causal, "window": window,
                       "pos": list(pos), "pairs": pairs,
                       "max_abs_err": err, "ok": ok,
                       "tolerance": "|k-r| <= rtol * (1 + |r|) on m (1e-4), "
                                    f"l, acc/l, dq, dk, dv (rtol {rtol})",
                       "bound_ms": bound, "bound_by": by,
                       "bound_note": "the bf16 lane's products (2, 3, 4 "
                                     "pairs x d a head) with K/V as int8 "
                                     "rows plus a 4-byte scale"}
    if timed:
        st, st_r = fresh(), fresh()
        calls = {"ring_carry": (
                     lambda: fm.flash_carry_block(q, kp, vp, *st, pos, **kw, **wire),
                     lambda: fm.ring_carry_ref(q, kp, vp, *st_r, pos, causal, scale,
                                               window, **wire)),
                 "ring_bwd_dq": (
                     lambda: fm.flash_ring_dq_block(*bwd, got[0], pos, **kw, **wire),
                     lambda: fm.ring_bwd_dq_ref(*bwd, want[0], pos, causal, scale,
                                                window, **wire)),
                 "ring_bwd_dkv": (
                     lambda: fm.flash_ring_dkv_block(*bwd, got[1], got[2], pos, **kw,
                                                     **wire),
                     lambda: fm.ring_bwd_dkv_ref(*bwd, want[1], want[2], pos, causal,
                                                 scale, window, **wire))}
        for kname, (kern, plain) in calls.items():
            rows[kname].update(kernel_ms(kern))
            rows[kname]["plain_ms"] = cuda_time_ms(plain, iters=2, warmup=1)
        # the redesigned kernels' lane before, the 64 x 64 walk (mma_s8),
        # on the same inputs in this call
        route_rule = fm.ring_route
        fm.ring_route = lambda *a: "mma_s8"
        try:
            for kname, r in want_route.items():
                if r == "wgmma_s8":
                    t = kernel_ms(calls[kname][0])
                    rows[kname]["mma_s8_ms"] = t["ms"]
                    rows[kname]["mma_s8_stream_ms"] = t["stream_ms"]
        finally:
            fm.ring_route = route_rule
        mask = ring_mask(s, causal, window, pos, "cuda")
        dec = [codec.wire_decode_rows(p, sc, "int8").to(q.dtype)
               for p, sc in ((kp, ks), (vp, vs))]
        lib = [x.detach().clone().requires_grad_(True) for x in (q, *dec)]
        sdpa = (lambda: F.scaled_dot_product_attention(
            *lib, attn_mask=mask, scale=scale, enable_gqa=hq != hkv))
        with torch.no_grad():
            rows["ring_carry"]["library_ms"] = cuda_time_ms(sdpa)
        pair_ms = grad_time_ms(sdpa, lib, do)
        note = ("scaled_dot_product_attention under the hop's boolean "
                "position mask on the K/V decoded to bf16 (the decode not "
                "counted): one hop's attention without the carry merge")
        rows["ring_carry"]["library_note"] = note
        for kname in ("ring_bwd_dq", "ring_bwd_dkv"):
            rows[kname]["library_ms"] = pair_ms
            rows[kname]["library_note"] = f"{note}; backward, dq, dk and dv together"
    for r in rows.values():
        emit(r)
        if not r["ok"]:
            fail(f"{r['kernel']} ({r['route']}) disagrees with its plain "
                 f"version ({r['case']})")
    return rows


def phase_fpdt_kernel(fm, card):
    """fpdt-kernel: ``chunked_attention`` with ``offload_kv`` on one card at
    FPDT_KERNEL (llama3-8b's heads, bf16, causal), forward and backward:
    every live chunk pair one launch of each ring hop kernel, all on the
    wgmma route (n·(n+1)/2 each for n chunks), against ``flash_attention``
    (the flash kernels) on the same inputs, forward and gradients, and the
    forward against its plain version (the JAX function's online softmax
    over K/V chunks, on the card; its autograd state at this length would
    not fit, so the gradients are held to the flash kernels alone), each
    to FLASH_RTOL of the reference's largest magnitude.  Reports peak
    memory, the host bytes the K/V are parked in, the chunked path's
    forward and forward+backward times on the stream (the fetches run on a
    side stream), the plain forward's, SDPA's causal GQA forward's and the
    hop kernels' bounds over the causal pairs.  Returns the launches of the
    checked run by kernel and route."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    from deepspeed_tpu_torch.sequence import fpdt

    c = FPDT_KERNEL
    b, hq, hkv, s, d, chunk = (c[k] for k in ("b", "hq", "hkv", "s", "d",
                                              "chunk"))
    gen = torch.Generator(device="cuda").manual_seed(21)

    def rand(h):
        return torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)

    def chunked(q_, k_, v_):
        return fpdt.chunked_attention(q_, k_, v_, chunk, offload_kv=True)

    def flash(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=True)

    def fwd_bwd(fn):
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        o = fn(qs, ks, vs)
        o.backward(do)
        return [o.detach(), qs.grad, ks.grad, vs.grad]

    counters = (fm.ring_launches, fm.ring_routes, fm.flash_mha.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    got = fwd_bwd(chunked)
    torch.cuda.synchronize()
    launches = {k_: v_ for cnt in counters for k_, v_ in cnt.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = fwd_bwd(flash)
    with torch.no_grad():
        plain = fpdt._plain_chunked_attention(q, k, v, chunk, True, d ** -0.5)
    err = {name: float((a.float() - r.float()).abs().max()
                       / r.float().abs().max())
           for name, a, r in zip(("o", "dq", "dk", "dv"), got, want)}
    err_plain = float((got[0].float() - plain.float()).abs().max()
                      / plain.float().abs().max())
    del want, plain
    n = s // chunk
    pairs = n * (n + 1) // 2
    kernels = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")
    expect = {**{k_: 0 for k_ in launches}, **{k_: pairs for k_ in kernels},
              **{f"{k_}.wgmma": pairs for k_ in kernels}}
    with torch.no_grad():
        fwd_ms = stream_time_ms(lambda: chunked(q, k, v), iters=3, warmup=1)
        plain_ms = stream_time_ms(lambda: fpdt._plain_chunked_attention(
            q, k, v, chunk, True, d ** -0.5), iters=1, warmup=0)
        sdpa_ms = stream_time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), iters=3, warmup=1)
    fwd_bwd_ms = stream_time_ms(lambda: fwd_bwd(chunked), iters=2, warmup=0)
    bounds = ring_bounds(b, hq, hkv, s, d, 2, s * (s + 1) // 2, False)
    tol = FLASH_RTOL["bfloat16"]
    ok = (launches == expect and max(err.values()) <= tol
          and err_plain <= tol and all(torch.isfinite(x).all() for x in got))
    emit({"phase": "fpdt-kernel", **c, "dtype": "bfloat16", "causal": True,
          "offload_kv": True, "chunk_pairs": pairs,
          "kv_host_bytes": 2 * b * s * hkv * d * 2,
          "check": "chunked_attention (ring hop kernels a live chunk pair) "
                   "vs flash_attention (flash kernels), forward and "
                   "gradients, and vs its plain version, forward: max abs "
                   "error over the reference's max abs",
          "max_rel_err_vs_flash": err, "max_rel_err_vs_plain_fwd": err_plain,
          "tolerance": tol, "launches": launches, "expected": expect,
          "max_memory_allocated_gib": peak,
          "fwd_ms_stream": fwd_ms, "fwd_bwd_ms_stream": fwd_bwd_ms,
          "plain_fwd_ms_stream": plain_ms, "sdpa_fwd_ms_stream": sdpa_ms,
          "bound_ms": {k_: round(bnd[0], 5) for k_, bnd in zip(kernels, bounds)},
          "bound_by": {k_: bnd[1] for k_, bnd in zip(kernels, bounds)},
          "card": card, "ok": ok})
    if not ok:
        fail(f"fpdt-kernel: launched {launches} (expected {expect}), or "
             f"differs from flash_attention ({err}) or its plain version "
             f"({err_plain})")
    del got, q, k, v, do
    torch.cuda.empty_cache()
    return launches


def phase_ring_int8_kernels(fm, codec):
    """The int8 K/V lanes; the kernels line's rows, named ``<kernel>_int8``,
    from the path case."""
    import torch

    summary = {}
    for case in RING_INT8_CASES:
        rows = ring_int8_case(fm, codec, case)
        if case[0] == RING_INT8_ROW_CASE:
            summary.update({f"{k}_int8": r for k, r in rows.items()})
        torch.cuda.empty_cache()
    return summary


def _ring_counters():
    """Every kernel counter of the port, in this process."""
    from deepspeed_tpu_torch.ops import block_sparse_mha as bsm
    from deepspeed_tpu_torch.ops import flash_mha as fm
    from deepspeed_tpu_torch.ops import fp6_linear as t6
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quantize as qk

    return (pa.paged_decode_attention.launches, fm.flash_mha.launches,
            bsm.block_sparse_mha.launches, fo.fused_adamw.launches,
            fo.fused_lion.launches, qk.launches, t6.fp6_matmul.launches,
            fm.ring_launches, fm.ring_routes)


def _seq_counters():
    """:func:`_ring_counters` and the flash kernels' routes (the local
    attention of Ulysses)."""
    from deepspeed_tpu_torch.ops import flash_mha as fm

    return _ring_counters() + (fm.flash_mha.routes,)


def ring_rank_reference(rank, world, model_kw, params, cfgs, batch, steps,
                        device=None, ulysses=None, fpdt=None):
    """One rank of the ring-reference phases: the fp32 engine over a seq
    axis of ``world`` ranks on the card (or, ``device="cpu"``, on the CPU),
    per config of ``cfgs`` (by wire) and placement, from ``params``:
    losses, grad norms, the ring's wire, launch counts and (rank 0) the
    params after.  ``ulysses`` (name -> (model overrides, config)): the
    same engine with ``seq_impl="ulysses"`` per entry, with its
    ``all_to_all`` bytes a step too; ``fpdt`` (global ``q, k, v, w`` numpy
    arrays and ``chunk``): ``FPDTAttention`` over the ranks with K/V
    parked on the host, this rank's output and the gradients of
    ``sum(o * w)``, and its launches."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(4)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    counters = _seq_counters()
    out = {}
    for name, (kw, cfg) in (ulysses or {}).items():
        model = registry.get_model_config(RING_MODEL, seq_impl="ulysses",
                                          **model_kw, **kw)
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=params, device=device)
        zero_counts(*counters)
        comm.clear_counts()
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(eng.train_batch(batch)))
            norms.append(eng.get_global_grad_norm())
        out.setdefault("ulysses", {})[name] = {
            "losses": losses, "grad_norms": norms,
            "all_to_all_bytes_per_step": comm.nbytes().get("all_to_all", 0)
            // steps,
            "launches": {k: v for c in counters for k, v in c.items()},
            "params": (tf.tree_map_with_path(
                lambda _p, x: x.detach().cpu(), eng.params)
                if rank == 0 else None)}
        del eng
        if device != "cpu":
            torch.cuda.empty_cache()
    if fpdt is not None:
        from deepspeed_tpu_torch.parallel.topology import MeshTopology
        from deepspeed_tpu_torch.sequence import FPDTAttention

        from deepspeed_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        n = fpdt["q"].shape[1] // world
        qs, ks, vs, ws = (torch.tensor(fpdt[x][:, rank * n:(rank + 1) * n],
                                       device=dev) for x in "qkvw")
        for x in (qs, ks, vs):
            x.requires_grad_()
        zero_counts(*counters)
        o = FPDTAttention(fpdt["chunk"], offload_kv=True,
                          topology=MeshTopology({"seq": world}))(qs, ks, vs)
        (o * ws).sum().backward()
        out["fpdt"] = {"arrays": [x.detach().cpu() for x in
                                  (o, qs.grad, ks.grad, vs.grad)],
                       "launches": {k: v for c in counters
                                    for k, v in c.items()}}
    for wire, cfg in cfgs.items():
        out[wire] = {}
        for placement in ("contiguous", "striped"):
            model = registry.get_model_config(RING_MODEL, seq_impl="ring",
                                              ring_placement=placement,
                                              **model_kw)
            eng, *_ = ds.initialize(model=model, config=cfg,
                                    model_parameters=params, device=device)
            zero_counts(*counters)
            losses, norms = [], []
            for _ in range(steps):
                losses.append(float(eng.train_batch(batch)))
                norms.append(eng.get_global_grad_norm())
            out[wire][placement] = {
                "losses": losses, "grad_norms": norms,
                "wire": eng.model_config.ring_wire_dtype,
                "interleave": eng.model_config.ring_interleave,
                "launches": {k: v for c in counters for k, v in c.items()},
                "params": (tf.tree_map_with_path(
                    lambda _p, x: x.detach().cpu(), eng.params)
                    if rank == 0 else None)}
            del eng
            if device != "cpu":
                torch.cuda.empty_cache()
    return out


def wire_bytes_of_step(step):
    """Run ``step()`` with every ``ring_rotate`` of sequence/ring.py
    recorded: each rotation's bytes by dtype (payloads, scales, or the
    tensors as they are on the fp32 wire) for the step's first forward ring
    and first backward ring, and the step's rotations and bytes in all."""
    from deepspeed_tpu_torch.sequence import ring as ring_mod

    calls, where, seen = [], [None], {"forward": -1, "backward": -1}
    orig = (ring_mod.ring_rotate, ring_mod._ring_fwd, ring_mod._ring_bwd)

    def rotate(tensors, group=None, async_op=False):
        by = {}
        for t in tensors:
            by[str(t.dtype)] = by.get(str(t.dtype), 0) + t.numel() * t.element_size()
        calls.append((where[0], by))
        return orig[0](tensors, group, async_op=async_op)

    def tagged(fn, name):
        def run(*a, **k):
            seen[name] += 1
            where[0] = (name, seen[name])
            return fn(*a, **k)
        return run

    ring_mod.ring_rotate = rotate
    ring_mod._ring_fwd = tagged(orig[1], "forward")
    ring_mod._ring_bwd = tagged(orig[2], "backward")
    try:
        step()
    finally:
        ring_mod.ring_rotate, ring_mod._ring_fwd, ring_mod._ring_bwd = orig
    return {"first_forward_ring": [b for w, b in calls if w == ("forward", 0)],
            "first_backward_ring": [b for w, b in calls if w == ("backward", 0)],
            "rotations_per_step": len(calls),
            "bytes_per_step": sum(sum(b.values()) for _, b in calls)}


def ring_rank_train(rank, world, runs, seq):
    """One rank of the ring-train phases (and ulysses-train), for each
    ``(model overrides, cfg, steps)`` of ``runs`` in turn (one spawn for
    them all): llama3-8b width, bf16, a warm-up step (a ring's wire bytes
    recorded), ``steps`` timed steps (counts zeroed just before them and
    read just after), then one step profiled on rank 0.  Returns a result
    a run."""
    import torch

    out = []
    for model_kw, cfg, steps in runs:
        out.append(_ring_rank_run(rank, model_kw, cfg, seq, steps))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ring_rank_run(rank, model_kw, cfg, seq, steps):
    import numpy as np
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    counters = _seq_counters()
    model = registry.get_model_config(RING_MODEL, **model_kw)
    t0 = time.perf_counter()
    eng, *_ = ds.initialize(model=model, config=cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = cfg["train_micro_batch_size_per_gpu"] * cfg["gradient_accumulation_steps"]
    batch = train_batch_of(model.vocab_size, rows, seed=0, seq=seq)  # every rank alike
    t0 = time.perf_counter()
    losses = []       # the warm-up, its ring's wire bytes recorded
    wire_bytes = wire_bytes_of_step(
        lambda: losses.append(float(eng.train_batch(batch))))
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    comm.clear_counts()
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)))   # float() syncs
        step_s.append(time.perf_counter() - t0)
    launches = {k: v for c in counters for k, v in c.items()}
    res = {"rank": rank, "device": str(eng.device), "init_s": init_s,
           "warmup_step_s": warm_s, "step_s": step_s, "losses": losses,
           "launches": launches,
           "collectives_per_step": {k: v / steps for k, v in comm.calls().items()},
           "bytes_per_step": {k: v / steps for k, v in comm.nbytes().items()},
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "max_memory_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "param_checksum": float(sum(float(p.detach().double().sum())
                                       for p in tf.tree_leaves(eng.params))),
           "finite": bool(np.all(np.isfinite(losses))),
           "wire": eng.model_config.ring_wire_dtype,
           "interleave": eng.model_config.ring_interleave,
           "wire_bytes": wire_bytes, "grad_buckets": eng.grad_bucket_count}
    if rank == 0:
        wall_ms, by_name, busy_ms, events = profile_call(
            lambda: eng.train_batch(batch))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        res["profile"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "collectives": comm_ms(events, names=RING_COLLECTIVES),
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_ms": {n: sum(v for k, v in by_name.items()
                                 if all(x in k for x in parts))
                          for n, parts in PROFILE_NAMES.items()
                          if n.startswith(("ring", "flash"))
                          or n == "fused_adamw"},
            "gemm_ms": sum(v for k, v in by_name.items()
                           if any(x in k for x in ("gemm", "nvjet", "cutlass",
                                                   "xmma"))),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}
    else:
        eng.train_batch(batch)    # the profiled step's partner
    return res


# the comm layer's ranges in a ring step at ZeRO-2: the rotations, one
# rank-major reduce_scatter a bucket each micro-step, the stepped slices'
# all_gather, the loss sums' and the grad norm's all_reduce
RING_COLLECTIVES = ("comm.ring_rotate", "comm.reduce_scatter",
                    "comm.all_gather", "comm.all_reduce", "comm.all_to_all")


def ring_ref_cfgs(wires):
    """The ring-reference phases' fp32 configs by wire."""
    cfg = {**RING_CFG, "bf16": {"enabled": False}}
    return {w: cfg if w == "fp32" else
            {**cfg, "comm_quantization": {"enabled": True, "ring_rotation": w}}
            for w in wires}


def ring_reference_start(ds, tf_model, tf, launch, pool):
    """The ring-reference phases' set-up, and their CPU ranks started in
    ``pool`` (they run beside the card-bound kernel phases before
    :func:`phase_ring_reference`): the CPU engine at sp 1 and its params,
    the batch, the Ulysses configs and FPDT's inputs; returns them with the
    CPU ranks' future."""
    import numpy as np

    model = tf_model.get_model_config(RING_MODEL, **RING_REF_MODEL)
    cfg = {**RING_CFG, "bf16": {"enabled": False}}
    host, *_ = ds.initialize(model=model, device="cpu", seed=2, config={
        k: v for k, v in cfg.items() if k != "mesh"})
    params = tf.tree_map_with_path(lambda _p, a: a.detach().clone(),
                                   host.params)
    rows = cfg["train_micro_batch_size_per_gpu"] * cfg["gradient_accumulation_steps"]
    batch = train_batch_of(model.vocab_size, rows, seed=5, seq=RING_REF_SEQ)
    for t in tf.tree_leaves(params):   # before two launches pickle them
        t.share_memory_()
    ulysses = {name: (kw, cfg) for name, kw in ULYSSES_REF.items()}
    gen = np.random.default_rng(9)
    d, hq, hkv = model.dim_per_head, model.num_heads, model.kv_heads
    fpdt = {"chunk": FPDT_REF_CHUNK,
            **{x: gen.standard_normal((1, RING_REF_SEQ, h, d)).astype(
                np.float32) for x, h in (("q", hq), ("k", hkv), ("v", hkv),
                                         ("w", hq))}}
    cpu = pool.submit(launch, ring_rank_reference, RING_RANKS,
                      args=(RING_REF_MODEL, params, ring_ref_cfgs(RING_WIRES),
                            batch, RING_REF_STEPS, "cpu", ulysses, fpdt),
                      backend=RING_BACKEND, device="cpu")
    return {"model": model, "cfg": cfg, "host": host, "params": params,
            "batch": batch, "ulysses": ulysses, "fpdt": fpdt, "cpu": cpu}


def phase_ring_reference(ds, tf_model, tf, launch, started):
    """The ring engine in two ranks on the card (gloo, one card) against
    the same engine in this process on the CPU at sp 1, fp32, at
    llama3-8b's head geometry and a reduced width: loss and grad norm of
    each of RING_REF_STEPS steps and the params after them to REF_RTOL
    (summation order only), under both placements; each rank's launches.
    The same two card ranks then run the engine with each quantized wire
    of RING_WIRES, which :func:`phase_ring_reference_wire` holds against
    two CPU ranks on the same wire (``started``: :func:`ring_reference_start`,
    whose CPU ranks run meanwhile).  The card ranks run in a thread beside
    this process's CPU steps; returns the card ranks' and the CPU ranks'
    results."""
    import torch

    model, cfg, host = started["model"], started["cfg"], started["host"]
    params, batch = started["params"], started["batch"]
    fpdt = started["fpdt"]
    card_cfgs = {**ring_ref_cfgs(("fp32",) + RING_WIRES),
                 **{f"{w}-interleave2": {**c, "step_schedule":
                                         {"ring_interleave": 2}}
                    for w, c in ring_ref_cfgs(RING_I2_WIRES).items()}}
    with ThreadPoolExecutor(1) as pool:
        card = pool.submit(launch, ring_rank_reference, RING_RANKS,
                           args=(RING_REF_MODEL, params, card_cfgs, batch,
                                 RING_REF_STEPS, None, started["ulysses"],
                                 fpdt),
                           backend=RING_BACKEND, device="cuda")
        want = []
        for _ in range(RING_REF_STEPS):
            want.append((float(host.train_batch(batch)),
                         host.get_global_grad_norm()))
        ranks, cpu_ranks = card.result(), started["cpu"].result()
    # launches a rank: steps x gas x layers x live hops (contiguous rank 0
    # skips its dead hop); one AdamW a step
    per = RING_REF_STEPS * cfg["gradient_accumulation_steps"] * RING_REF_MODEL["num_layers"]
    for placement in ("contiguous", "striped"):
        got = [r["fp32"][placement] for r in ranks]
        worst = 0.0
        for r in got:
            for (lc, gc), (lh, gh) in zip(zip(r["losses"], r["grad_norms"]), want):
                worst = max(worst, abs(lc - lh) / abs(lh), abs(gc - gh) / gh)
        params_rel = _params_rel(got[0]["params"], host.params, tf)
        wants = []
        for rank in range(RING_RANKS):
            live = 1 if placement == "contiguous" and rank == 0 else 2
            wants.append({**{k: 0 for k in got[rank]["launches"]},
                          "ring_carry": per * live, "ring_bwd_dq": per * live,
                          "ring_bwd_dkv": per * live,
                          **{f"{k}.fma": per * live       # fp32
                             for k in ("ring_carry", "ring_bwd_dq",
                                       "ring_bwd_dkv")},
                          "fused_adamw": RING_REF_STEPS})
        launches = [r["launches"] for r in got]
        emit({"phase": "ring-reference", "model": RING_MODEL,
              "overrides": RING_REF_MODEL, "dtype": "float32",
              "placement": placement, "ranks": RING_RANKS,
              "backend": RING_BACKEND, "seq": RING_REF_SEQ,
              "micro": cfg["train_micro_batch_size_per_gpu"],
              "gas": cfg["gradient_accumulation_steps"],
              "steps": [{"loss_card": [r["losses"][i] for r in got],
                         "loss_cpu": want[i][0],
                         "grad_norm_card": [r["grad_norms"][i] for r in got],
                         "grad_norm_cpu": want[i][1]}
                        for i in range(RING_REF_STEPS)],
              "check": "two ranks on the card (ring kernels, cuBLAS) vs one "
                       "CPU process at sp 1 (plain flash attention)",
              "max_rel_err_loss_grad_norm": worst,
              "params_rel_l2": params_rel, "tolerance": REF_RTOL,
              "launches_per_rank": launches, "expected_per_rank": wants})
        if worst > REF_RTOL or params_rel > REF_RTOL:
            fail(f"ring-reference ({placement}): the card's ranks differ "
                 f"from the CPU: {worst}, {params_rel}")
        if launches != wants:
            fail(f"ring-reference ({placement}): launched {launches}, "
                 f"expected {wants}")
        # interleave 2 (each hop's rotation in flight while it attends), on
        # the fp32 and the int8 wire: the bits of interleave 1 in the same
        # card ranks
        for wire in RING_I2_WIRES:
            one = [r[wire][placement] for r in ranks]
            i2 = [r[f"{wire}-interleave2"][placement] for r in ranks]
            same = all(a["losses"] == b["losses"]
                       and a["grad_norms"] == b["grad_norms"]
                       and a["launches"] == b["launches"]
                       and b["interleave"] == 2 for a, b in zip(one, i2))
            same = same and all(torch.equal(a, b) for a, b in zip(
                tf.tree_leaves(one[0]["params"]),
                tf.tree_leaves(i2[0]["params"])))
            emit({"phase": "ring-reference-interleave2", "wire": wire,
                  "placement": placement,
                  "losses_interleave1": [r["losses"] for r in one],
                  "losses_interleave2": [r["losses"] for r in i2],
                  "launches_interleave2": [r["launches"] for r in i2],
                  "check": "losses, grad norms, launches and rank 0's "
                           "params bit for bit", "ok": same})
            if not same:
                fail(f"ring-reference ({placement}, {wire} wire): interleave "
                     "2 does not give the bits of interleave 1")
    phase_ulysses_reference(tf, model, ranks, cpu_ranks, fpdt)
    del host
    torch.cuda.empty_cache()
    return ranks, cpu_ranks


def phase_ulysses_reference(tf, model, ranks, cpu_ranks, fpdt):
    """ulysses-reference: the ring-reference model with seq_impl "ulysses"
    in the card ranks against the CPU ranks (the same params and batch),
    untiled and tiled: each step's losses and grad norms to ZERO_REF_RTOL,
    the params after the steps to ZERO_REF_PARAMS_RTOL (relative L2), the
    all_to_all bytes a step (:func:`ulysses_a2a_bytes`, fp32) and each card
    rank's launches (steps x gas x layers of each flash kernel on the fma
    route, one AdamW a step).  Then fpdt-reference: FPDTAttention over the
    same ranks, each card rank's output and gradients against its CPU
    rank's to FLASH_RTOL, its launches one of each hop kernel a live chunk
    pair on the fma route."""
    import numpy as np

    gas = RING_CFG["gradient_accumulation_steps"]
    per = RING_REF_STEPS * gas * RING_REF_MODEL["num_layers"]
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    a2a = ulysses_a2a_bytes(model, RING_CFG["train_micro_batch_size_per_gpu"]
                            * gas, RING_REF_SEQ, RING_RANKS, 4)
    for name in ULYSSES_REF:
        got = [r["ulysses"][name] for r in ranks]
        want = [r["ulysses"][name] for r in cpu_ranks]
        worst = max(max(abs(g - w) / abs(w) for g, w in
                        zip(a["losses"] + a["grad_norms"],
                            b["losses"] + b["grad_norms"]))
                    for a, b in zip(got, want))
        params_rel = _params_rel(got[0]["params"], want[0]["params"], tf)
        wants = [{**{k: 0 for k in g["launches"]}, **{k: per for k in flash},
                  **{f"{k}.fma": per for k in flash},
                  "fused_adamw": RING_REF_STEPS} for g in got]
        launches = [g["launches"] for g in got]
        bytes_ = [g["all_to_all_bytes_per_step"] for g in got + want]
        ok = (worst <= ZERO_REF_RTOL and params_rel <= ZERO_REF_PARAMS_RTOL
              and launches == wants and all(b == a2a for b in bytes_)
              and bool(np.all(np.isfinite([g["losses"] for g in got]))))
        emit({"phase": "ulysses-reference", "config": name,
              "model": RING_MODEL, "overrides": {**RING_REF_MODEL,
                                                 **ULYSSES_REF[name]},
              "dtype": "float32", "placement": "contiguous",
              "ranks": RING_RANKS, "backend": RING_BACKEND,
              "seq": RING_REF_SEQ,
              "steps": [{"loss_card": [g["losses"][i] for g in got],
                         "loss_cpu": [w["losses"][i] for w in want],
                         "grad_norm_card": [g["grad_norms"][i] for g in got],
                         "grad_norm_cpu": [w["grad_norms"][i] for w in want]}
                        for i in range(RING_REF_STEPS)],
              "check": "two ranks on the card (all_to_all through gloo, "
                       "flash kernels, cuBLAS) vs two ranks on the CPU "
                       "(plain versions)",
              "max_rel_err_loss_grad_norm": worst,
              "params_rel_l2": params_rel,
              "tolerance": {"loss_grad_norm": ZERO_REF_RTOL,
                            "params_rel_l2": ZERO_REF_PARAMS_RTOL},
              "all_to_all_bytes_per_step": bytes_,
              "all_to_all_bytes_expected": a2a,
              "launches_per_rank": launches, "expected_per_rank": wants,
              "ok": ok})
        if not ok:
            fail(f"ulysses-reference ({name}): the card's ranks differ from "
                 f"the CPU's ({worst}, {params_rel}), moved {bytes_} bytes "
                 f"through all_to_all (expected {a2a}) or launched "
                 f"{launches}, expected {wants}")
    n = RING_REF_SEQ // FPDT_REF_CHUNK
    pairs = n * (n + 1) // 2
    kernels = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")
    worst = {}
    for r, c in zip(ranks, cpu_ranks):
        for name, a, b in zip(("o", "dq", "dk", "dv"), r["fpdt"]["arrays"],
                              c["fpdt"]["arrays"]):
            rel = float((a - b).abs().max() / b.abs().max())
            worst[name] = max(worst.get(name, 0.0), rel)
    wants = [{**{k: 0 for k in r["fpdt"]["launches"]},
              **{k: pairs for k in kernels},
              **{f"{k}.fma": pairs for k in kernels}} for r in ranks]
    launches = [r["fpdt"]["launches"] for r in ranks]
    ok = (max(worst.values()) <= FLASH_RTOL["float32"] and launches == wants)
    emit({"phase": "fpdt-reference", "heads": [model.num_heads,
                                               model.kv_heads],
          "head_dim": model.dim_per_head, "seq": RING_REF_SEQ,
          "chunk": fpdt["chunk"], "offload_kv": True, "dtype": "float32",
          "ranks": RING_RANKS,
          "check": "FPDTAttention in two card ranks (all_to_all, the hop "
                   "kernels a live chunk pair, K/V parked in pinned host "
                   "memory) vs two CPU ranks (the plain chunked attention): "
                   "max abs error over max abs of the CPU's",
          "max_rel_err": worst, "tolerance": FLASH_RTOL["float32"],
          "launches_per_rank": launches, "expected_per_rank": wants,
          "ok": ok})
    if not ok:
        fail(f"fpdt-reference: the card's ranks differ from the CPU's "
             f"({worst}) or launched {launches}, expected {wants}")


def _params_rel(a_tree, b_tree, tf):
    """Relative L2 distance of two param trees."""
    num = den = 0.0
    for a, b in zip(tf.tree_leaves(a_tree), tf.tree_leaves(b_tree)):
        a, b = a.double(), b.detach().double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5


def phase_ring_reference_wire(tf, card, cpu):
    """The ring-reference phase with each quantized wire of RING_WIRES
    (ring-reference-int8, -fp8): the card ranks' run of
    :func:`phase_ring_reference` (``card``) against the same fp32 engine
    and params in two ranks on the CPU (gloo, ``cpu``), both placements;
    per step
    the losses and grad norms, and the params after the steps.  The first
    step at REF_RTOL, the rest at RING_WIRE_REF_RTOL.  Each card rank's
    launches: its own block on the fma route, and with int8 every live
    visiting hop on the fma_s8 lane (fp8 decodes K/V with the codec and
    runs the fma route)."""
    cfgs = ring_ref_cfgs(RING_WIRES)
    for wire in RING_WIRES:
        ring_wire_check(tf, wire, cfgs[wire], [r[wire] for r in card],
                        [r[wire] for r in cpu])


def ring_wire_check(tf, wire, cfg, card, cpu):
    """One wire's ring-reference lines (see
    :func:`phase_ring_reference_wire`)."""
    per = RING_REF_STEPS * cfg["gradient_accumulation_steps"] * RING_REF_MODEL["num_layers"]
    kernels = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")
    phase = f"ring-reference-{wire}"
    for placement in ("contiguous", "striped"):
        got = [r[placement] for r in card]
        want = [r[placement] for r in cpu]
        first = later = 0.0
        for g, w in zip(got, want):
            for i in range(RING_REF_STEPS):
                rel = max(abs(g["losses"][i] - w["losses"][i]) / abs(w["losses"][i]),
                          abs(g["grad_norms"][i] - w["grad_norms"][i])
                          / w["grad_norms"][i])
                if i == 0:
                    first = max(first, rel)
                else:
                    later = max(later, rel)
        params_rel = _params_rel(got[0]["params"], want[0]["params"], tf)
        wants = []
        for rank in range(RING_RANKS):
            visiting = 0 if placement == "contiguous" and rank == 0 else 1
            routes = ({"fma": per, "fma_s8": per * visiting} if wire == "int8"
                      else {"fma": per * (1 + visiting)})
            wants.append({**{k: 0 for k in got[rank]["launches"]},
                          **{k: per * (1 + visiting) for k in kernels},
                          **{f"{k}.{r}": n for k in kernels
                             for r, n in routes.items() if n},
                          "fused_adamw": RING_REF_STEPS})
        launches = [g["launches"] for g in got]
        ok = (first <= REF_RTOL and later <= RING_WIRE_REF_RTOL
              and params_rel <= RING_WIRE_REF_RTOL and launches == wants
              and all(g["wire"] == wire for g in got + want))
        emit({"phase": phase, "model": RING_MODEL,
              "overrides": RING_REF_MODEL, "dtype": "float32", "wire": wire,
              "placement": placement, "ranks": RING_RANKS,
              "backend": RING_BACKEND, "seq": RING_REF_SEQ,
              "steps": [{"loss_card": [g["losses"][i] for g in got],
                         "loss_cpu": [w["losses"][i] for w in want],
                         "grad_norm_card": [g["grad_norms"][i] for g in got],
                         "grad_norm_cpu": [w["grad_norms"][i] for w in want]}
                        for i in range(RING_REF_STEPS)],
              "check": "two ranks on the card (ring kernels, the int8 lanes "
                       "for int8, cuBLAS) vs two ranks on the CPU (plain "
                       "versions), the same wire",
              "max_rel_err_first_step": first,
              "max_rel_err_later_steps": later, "params_rel_l2": params_rel,
              "tolerance": {"first_step": REF_RTOL,
                            "later_steps_and_params": RING_WIRE_REF_RTOL},
              "launches_per_rank": launches, "expected_per_rank": wants,
              "ok": ok})
        if not ok:
            fail(f"{phase} ({placement}): the card's ranks differ from the "
                 f"CPU's ({first}, {later}, {params_rel}) or launched "
                 f"{launches}, expected {wants}")


def mesh_rank_reference(rank, world, model_kw, params, configs, batch, steps):
    """One rank of the mesh-reference phase: the fp32 ring engine at
    MESH_REF_MESH on the card, per ZeRO config of ``configs``, from
    ``params``: losses, grad norms, the ZeRO world, the flat buckets,
    launch counts and (rank 0) the params after, gathered."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import registry

    counters = _ring_counters()
    model = registry.get_model_config(RING_MODEL, seq_impl="ring",
                                      ring_placement="striped", **model_kw)
    out = {}
    for name, cfg in configs.items():
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=params)
        zero_counts(*counters)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(eng.train_batch(batch)))
            norms.append(eng.get_global_grad_norm())
        launches = {k: v for c in counters for k, v in c.items()}
        with zero.GatheredParameters(eng.params) as full:
            gathered = full if rank == 0 else None
        topo = eng.topology
        out[name] = {"losses": losses, "grad_norms": norms,
                     "zero_rank": topo.rank, "zero_size": topo.world_size,
                     "grad_buckets": eng.grad_bucket_count,
                     "launches": launches, "params": gathered}
        del eng
        torch.cuda.empty_cache()
    return out


def phase_mesh_reference(ds, tf_model, tf, launch):
    """The ring-reference model in four ranks sharing the card (gloo) at
    MESH_REF_MESH, striped, ZeRO over the data and seq axes at each stage
    of MESH_REF_STAGES (one launch), against one engine in this process
    on the CPU at data 1 on the same global batch: losses and grad norms
    of each step to ZERO_REF_RTOL, the gathered params after them to
    ZERO_REF_PARAMS_RTOL (relative L2), and each rank's launches: steps x
    gas x layers x two live hops (striped) of each ring kernel on the fma
    route (fp32), one AdamW a step.  Returns rank 0's launches by stage."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(RING_MODEL, seq_impl="ring",
                                      ring_placement="striped",
                                      **RING_REF_MODEL)
    gas = RING_CFG["gradient_accumulation_steps"]
    micro = RING_CFG["train_micro_batch_size_per_gpu"]
    ranks_n = MESH_REF_MESH["data"] * MESH_REF_MESH["seq"]
    base = {k: v for k, v in RING_CFG.items()
            if k not in ("mesh", "zero_optimization")}
    base["bf16"] = {"enabled": False}
    host, *_ = ds.initialize(model=model, device="cpu", seed=4, config={
        **base, "train_micro_batch_size_per_gpu": micro * MESH_REF_MESH["data"]})
    params = tf.tree_map_with_path(lambda _p, a: a.detach().clone(),
                                   host.params)
    rows = micro * gas * MESH_REF_MESH["data"]
    batch = train_batch_of(model.vocab_size, rows, seed=7, seq=RING_REF_SEQ)
    configs = {f"stage{st}": {**base, "mesh": MESH_REF_MESH,
                              "zero_optimization": {
                                  "stage": st,
                                  "param_persistence_threshold": 0}}
               for st in MESH_REF_STAGES}
    # the card's ranks train while this process runs the CPU engine
    with ThreadPoolExecutor(1) as pool:
        card_ranks = pool.submit(launch, mesh_rank_reference, ranks_n,
                                 args=(RING_REF_MODEL, params, configs, batch,
                                       RING_REF_STEPS),
                                 backend=RING_BACKEND, device="cuda")
        want = []
        for _ in range(RING_REF_STEPS):
            want.append((float(host.train_batch(batch)),
                         host.get_global_grad_norm()))
        ranks = card_ranks.result()
    per = RING_REF_STEPS * gas * RING_REF_MODEL["num_layers"] * 2
    kernels = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")
    out = {}
    for name in configs:
        got = [r[name] for r in ranks]
        worst = 0.0
        for r in got:
            for (lc, gc), (lh, gh) in zip(zip(r["losses"], r["grad_norms"]),
                                          want):
                worst = max(worst, abs(lc - lh) / abs(lh), abs(gc - gh) / gh)
        params_rel = _params_rel(got[0]["params"], host.params, tf)
        wants = [{**{k: 0 for k in r["launches"]},
                  **{k: per for k in kernels},
                  **{f"{k}.fma": per for k in kernels},
                  "fused_adamw": RING_REF_STEPS} for r in got]
        launches = [r["launches"] for r in got]
        ok = (worst <= ZERO_REF_RTOL and params_rel <= ZERO_REF_PARAMS_RTOL
              and launches == wants
              and [(r["zero_rank"], r["zero_size"]) for r in got]
              == [(i, ranks_n) for i in range(ranks_n)]
              and bool(np.all(np.isfinite([r["losses"] for r in got]))))
        emit({"phase": "mesh-reference", "config": name,
              "zero_stage": configs[name]["zero_optimization"]["stage"],
              "mesh": MESH_REF_MESH, "model": RING_MODEL,
              "overrides": RING_REF_MODEL, "dtype": "float32",
              "placement": "striped", "ranks": ranks_n,
              "backend": RING_BACKEND, "seq": RING_REF_SEQ, "micro": micro,
              "gas": gas, "zero_world": [[r["zero_rank"], r["zero_size"]]
                                         for r in got],
              "grad_buckets": got[0]["grad_buckets"],
              "steps": [{"loss_card": [r["losses"][i] for r in got],
                         "loss_cpu": want[i][0],
                         "grad_norm_card": [r["grad_norms"][i] for r in got],
                         "grad_norm_cpu": want[i][1]}
                        for i in range(RING_REF_STEPS)],
              "check": "four ranks on the card (ring kernels, cuBLAS, ZeRO "
                       "over data x seq through gloo) vs one CPU process at "
                       "data 1 (plain versions)",
              "max_rel_err_loss_grad_norm": worst, "params_rel_l2": params_rel,
              "tolerance": {"loss_grad_norm": ZERO_REF_RTOL,
                            "params_rel_l2": ZERO_REF_PARAMS_RTOL},
              "launches_per_rank": launches, "expected_per_rank": wants,
              "ok": ok})
        if not ok:
            fail(f"mesh-reference ({name}): the card's ranks differ from the "
                 f"CPU ({worst}, {params_rel}), launched {launches}, or the "
                 "ZeRO world is not the four ranks")
        out[name] = launches[0]
    del host, params, ranks
    torch.cuda.empty_cache()
    return out


def phase_ring_trains(tf_model, launch, card):
    """ring-train, ring-train-int8 and ulysses-train in one launch of
    RING_RANKS ranks sharing the card (gloo): the fp32 wire at interleave 2
    for RING_STEPS timed steps, the int8 wire for RING_WIRE_STEPS
    (:func:`phase_ring_train` reports each), then Ulysses for ULYSSES_STEPS
    (:func:`phase_ulysses_train`).  Returns rank 0's launches of each."""
    emit({"phase": "ring-backend", "backend": RING_BACKEND,
          "why": "the ranks share one card, and NCCL refuses two ranks "
                 "on one GPU; point-to-point buffers go through pinned "
                 "host memory, every computation stays on the card"})
    int8 = {**RING_CFG, "comm_quantization": {"enabled": True,
                                              "ring_rotation": "int8"}}
    ranks = launch(ring_rank_train, RING_RANKS,
                   args=([(RING_MODEL_KW, RING_I2_CFG, RING_STEPS),
                          (RING_MODEL_KW, int8, RING_WIRE_STEPS),
                          (ULYSSES_MODEL_KW, RING_CFG, ULYSSES_STEPS)],
                         RING_SEQ),
                   backend=RING_BACKEND, device="cuda")
    fp32 = [r[0] for r in ranks]
    return (phase_ring_train(tf_model, card, fp32),
            phase_ring_train(tf_model, card, [r[1] for r in ranks],
                             wire="int8", base=fp32, steps=RING_WIRE_STEPS),
            phase_ulysses_train(tf_model, card, [r[2] for r in ranks]))


def ulysses_a2a_bytes(model, rows, seq, ranks, elem):
    """Bytes a rank sends through ``all_to_all`` in a step of Ulysses
    without remat: a layer a micro-step, q, k, v and the output forward and
    their gradients backward, each its shard of ``rows x seq / ranks``
    tokens (K/V at the KV heads: sp divides them)."""
    tokens = rows * seq // ranks
    heads = 2 * model.num_heads + 2 * model.kv_heads
    return 2 * tokens * heads * model.dim_per_head * elem * model.num_layers


def phase_ulysses_train(tf_model, card, ranks):
    """ulysses-train: ring-train's step (llama3-8b width, RING_LAYERS
    layers, seq RING_SEQ over RING_RANKS ranks sharing the card, bf16,
    ZeRO-2 over the seq axis, loss_tiles) with seq_impl "ulysses": seconds
    a step, tokens/s, MFU, peak memory a rank, all_to_all bytes a step a
    rank against :func:`ulysses_a2a_bytes`, a profiled step's host ms in
    each collective, and each rank's launches a step: layers x gas of each
    flash kernel on its wgmma route, one AdamW, no ring kernel.  Returns
    rank 0's launches a step."""
    model = tf_model.get_model_config(RING_MODEL, **ULYSSES_MODEL_KW)
    gas = RING_CFG["gradient_accumulation_steps"]
    rows = RING_CFG["train_micro_batch_size_per_gpu"] * gas
    n = RING_LAYERS * gas
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    want = {**{k: 0 for k in ranks[0]["launches"]},
            **{k: n for k in flash}, **{f"{k}.wgmma": n for k in flash},
            "fused_adamw": 1}
    steps = ULYSSES_STEPS
    per_step = [{k: v / steps for k, v in r["launches"].items()}
                for r in ranks]
    a2a = ulysses_a2a_bytes(model, rows, RING_SEQ, RING_RANKS, 2)
    got_a2a = [r["bytes_per_step"].get("all_to_all", 0) for r in ranks]
    step_s = [max(r["step_s"][i] for r in ranks) for i in range(steps)]
    tokens = rows * RING_SEQ
    tps = tokens * steps / sum(step_s)
    ok = (all(r["finite"] for r in ranks)
          and all(r["losses"] == ranks[0]["losses"] for r in ranks)
          and all(r["param_checksum"] == ranks[0]["param_checksum"]
                  for r in ranks)
          and ranks[0]["losses"][-1] < ranks[0]["losses"][0]
          and all(p == want for p in per_step)
          and all(b == a2a for b in got_a2a))
    emit({"phase": "ulysses-train", "model": RING_MODEL,
          "layers": RING_LAYERS, "params": count_params(model),
          "dtype": "bfloat16", "placement": "contiguous",
          "ranks": RING_RANKS, "backend": RING_BACKEND, "seq": RING_SEQ,
          "seq_per_rank": RING_SEQ // RING_RANKS,
          "loss_tiles": RING_LOSS_TILES, "micro": RING_CFG[
              "train_micro_batch_size_per_gpu"], "gas": gas,
          "optimizer": RING_CFG["optimizer"], "remat": "none",
          "zero_stage": RING_CFG["zero_optimization"]["stage"],
          "step_s": step_s, "tokens_per_step": tokens, "tokens_per_s": tps,
          "mfu": tps * 3 * fwd_flops_per_tok(model, RING_SEQ) / BF16_FLOPS,
          "mfu_peak": "989 TFLOP/s bf16 dense (H100 SXM), the card's two "
                      "ranks together; the formula counts dense attention",
          "max_memory_allocated_gib": [r["max_memory_allocated_gib"]
                                       for r in ranks],
          "all_to_all_bytes_per_step": got_a2a,
          "all_to_all_bytes_expected": a2a,
          "ranks_detail": [{k: v for k, v in r.items()
                            if k not in ("profile", "wire_bytes")}
                           for r in ranks],
          "launches_per_step": per_step, "expected_per_step": want,
          "card": card, "ok": ok})
    emit({"phase": "ulysses-train-profile",
          "what": "one train_batch on rank 0 (rank 1 steps beside it)",
          "collectives_note": "host time inside comm.all_to_all (q, k, v "
                              "and the output a layer, their gradients), "
                              "comm.reduce_scatter, comm.all_gather and "
                              "comm.all_reduce; own = less this rank's "
                              "compute kernels running",
          **ranks[0]["profile"], "card": card})
    if not ok:
        fail("ulysses-train: losses not finite, not equal on the ranks or "
             "not falling, params differ between ranks, the all_to_all "
             f"bytes {got_a2a} are not {a2a}, or the launch counts "
             f"{per_step} do not show the flash kernels on wgmma")
    return per_step[0]


def phase_ring_train(tf_model, card, ranks, wire="fp32", base=None,
                     steps=RING_STEPS):
    """The ranks' results (``ring_rank_train``) of one wire: llama3-8b at full width, depth cut to RING_LAYERS, seq RING_SEQ over
    RING_RANKS ranks sharing the card (gloo), striped, bf16, the
    longseq_ring row's step: seconds a step, tokens/s for the card, peak
    memory a rank, the ring's wire bytes, a profiled step on rank 0 with
    the time inside ring_rotate and all_reduce (``comm_ms``), and each
    rank's launches a step, which must be 2 layers x gas 2 x 2 live hops of
    each ring kernel, one AdamW and nothing else: on the wgmma route, or,
    with ``wire`` "int8" (``comm_quantization.ring_rotation``, the
    ring-train-int8 phase), the own block's hop on wgmma and the visiting
    hop on each kernel's int8 lane (RING_INT8_ROUTES: all three on
    wgmma_s8).  ``base``: the fp32-wire phase's
    result, whose losses at the same seed and wire bytes the int8 phase
    reports beside its own (``ring_loss_delta``, bench.py's _ring_wire_ab).
    Returns the launches of rank 0 by kernel and route."""
    model = tf_model.get_model_config(RING_MODEL, **RING_MODEL_KW)
    gas = RING_CFG["gradient_accumulation_steps"]
    live = RING_LAYERS * gas * 2
    cfg = RING_I2_CFG
    phase = "ring-train"
    if wire != "fp32":
        cfg = {**RING_CFG, "comm_quantization": {"enabled": True,
                                                 "ring_rotation": wire}}
        phase = f"ring-train-{wire}"
    rows = cfg["train_micro_batch_size_per_gpu"] * gas
    tokens = rows * RING_SEQ
    step_s = [max(r["step_s"][i] for r in ranks) for i in range(steps)]
    kernels = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")
    routes = {k: {"wgmma": live} if wire == "fp32"
              else {"wgmma": live // 2, RING_INT8_ROUTES[k]: live // 2}
              for k in kernels}
    want = {**{k: 0 for k in ranks[0]["launches"]},
            **{k: live for k in kernels},
            **{f"{k}.{r}": n for k in kernels for r, n in routes[k].items()},
            "fused_adamw": 1}
    per_step = [{k: v / steps for k, v in r["launches"].items()}
                for r in ranks]
    ok = (all(r["finite"] for r in ranks)
          and all(r["losses"] == ranks[0]["losses"] for r in ranks)
          and all(r["param_checksum"] == ranks[0]["param_checksum"]
                  for r in ranks)
          and ranks[0]["losses"][-1] < ranks[0]["losses"][0]
          and all(r["wire"] == wire for r in ranks)
          and all(p == want for p in per_step))
    n_params = count_params(model)
    prof = ranks[0]["profile"]
    row = {"phase": phase, "model": RING_MODEL,
           "layers": RING_LAYERS, "params": n_params, "dtype": "bfloat16",
           "wire": wire, "interleave": ranks[0]["interleave"],
           "loss_tiles": RING_LOSS_TILES,
           "placement": "striped", "ranks": RING_RANKS,
           "max_memory_allocated_gib": [r["max_memory_allocated_gib"]
                                        for r in ranks],
           "ring_rotate_host_ms": prof["collectives"]["comm.ring_rotate"],
           "untiled_interleave1_baseline": RING_BASELINE,
           "backend": RING_BACKEND, "seq": RING_SEQ,
           "seq_per_rank": RING_SEQ // RING_RANKS,
           "micro": cfg["train_micro_batch_size_per_gpu"], "gas": gas,
           "optimizer": cfg["optimizer"], "remat": "none",
           "zero_stage": cfg["zero_optimization"]["stage"],
           "grad_buckets": ranks[0]["grad_buckets"], "step_s": step_s,
           "tokens_per_step": tokens, "tokens_per_s": tokens * steps / sum(step_s),
           "wire_bytes": ranks[0]["wire_bytes"],
           "ranks_detail": [{k: v for k, v in r.items()
                             if k not in ("profile", "wire_bytes")}
                            for r in ranks],
           "launches_per_step": per_step, "expected_per_step": want,
           "card": card, "ok": ok}
    if base is not None:
        b0 = base[0]
        row["ring_loss_delta"] = max(abs(a - b) for a, b in
                                     zip(ranks[0]["losses"], b0["losses"]))
        row["losses_fp32_wire"] = b0["losses"]
        row["wire_bytes_fp32_wire"] = {
            k: b0["wire_bytes"][k] for k in ("first_forward_ring",
                                             "first_backward_ring",
                                             "bytes_per_step")}
        row["wire_reduction"] = {
            "forward": (sum(sum(c.values()) for c in b0["wire_bytes"]["first_forward_ring"])
                        / sum(sum(c.values()) for c in ranks[0]["wire_bytes"]["first_forward_ring"])),
            "backward": (sum(sum(c.values()) for c in b0["wire_bytes"]["first_backward_ring"])
                         / sum(sum(c.values()) for c in ranks[0]["wire_bytes"]["first_backward_ring"])),
            "step": (b0["wire_bytes"]["bytes_per_step"]
                     / ranks[0]["wire_bytes"]["bytes_per_step"])}
    emit(row)
    emit({"phase": f"{phase}-profile",
          "what": "one train_batch on rank 0 (rank 1 steps beside it)",
          "collectives_note": "host time inside comm.ring_rotate, "
                              "comm.reduce_scatter (one a flat bucket each "
                              "micro-step), comm.all_gather (each stepped "
                              "slice) and comm.all_reduce (the loss sum "
                              "and count once a micro-step, the grad "
                              "norm); own = less this rank's compute "
                              "kernels running",
          **prof, "card": card})
    if not ok:
        fail(f"{phase}: losses not finite, not equal on the ranks or not "
             "falling, params differ between ranks, the wire is not the "
             "configured one, or the launch counts do not show the ring "
             "kernels on their routes")
    return ranks[0]["launches"]


# ----------------------------------------------------------------------
# phases 20-22: ZeRO-3 over a data axis and the gather-matmul GEMM
# ----------------------------------------------------------------------
# (case, M, K, N, a transposed, b transposed, dtype): the gpt2-350m MLP at
# micro 8 x seq 1024 (M 8192; wi [1024, 4096], wo [4096, 1024]); the
# backward's dx = g·wᵀ reads w transposed, dw = xᵀ·g reads x transposed
GEMM_CASES = [
    ("path-wi-fwd", 8192, 1024, 4096, False, False, "bfloat16"),
    ("path-wo-fwd", 8192, 4096, 1024, False, False, "bfloat16"),
    ("path-wi-dx", 8192, 4096, 1024, False, True, "bfloat16"),
    ("path-wi-dw", 1024, 8192, 4096, True, False, "bfloat16"),
    ("path-wo-dx", 8192, 1024, 4096, False, True, "bfloat16"),
    ("path-wo-dw", 4096, 8192, 1024, True, False, "bfloat16"),
    ("path-wi-fwd-fp32", 8192, 1024, 4096, False, False, "float32"),
    ("path-wi-dw-fp32", 1024, 8192, 4096, True, False, "float32"),
    ("llama3-8b-up", 4096, 4096, 14336, False, False, "bfloat16"),
    ("llama3-8b-down", 4096, 14336, 4096, False, False, "bfloat16"),
    ("ragged-64x64x256", 64, 64, 256, False, False, "bfloat16"),
    ("ragged-130x96x72", 130, 96, 72, False, False, "bfloat16"),
    ("ragged-8x300x128", 8, 300, 128, False, False, "bfloat16"),
    ("ragged-64x64x256-fp32", 64, 64, 256, False, False, "float32"),
    ("ragged-130x96x72-fp32", 130, 96, 72, False, False, "float32"),
    ("ragged-8x300x128-fp32", 8, 300, 128, False, False, "float32"),
]
GEMM_ROW_CASE = "path-wi-fwd"     # the kernels line's row


def gemm_operand(gen, rows, cols, transpose, dtype):
    """A [rows, cols] operand on the card, a transposed view when asked."""
    import torch

    shape = (cols, rows) if transpose else (rows, cols)
    t = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return t.T if transpose else t


def phase_gemm_kernels(tgm):
    """gather_matmul against its plain version at each GEMM_CASES shape:
    max abs error against GEMM_RTOL, kernel, plain and torch.matmul ms, and
    the bound (operations: 2MKN over the dtype's peak, against the bytes of
    a, b and the output over the HBM rate)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    for name, m, k, n, ta, tb, dt in GEMM_CASES:
        dtype = getattr(torch, dt)
        a = gemm_operand(gen, m, k, ta, dtype)
        b = gemm_operand(gen, k, n, tb, dtype)
        got = tgm.gemm(a, b)
        torch.cuda.synchronize()
        ref = tgm.matmul_ref(a, b)
        diff = (got.float() - ref.float()).abs()
        rtol = GEMM_RTOL[dt]
        if dtype == torch.float32:
            ok = bool(diff.max() <= rtol * ref.abs().max())
        else:
            ok = bool((diff <= rtol * (1 + ref.float().abs())).all())
        ok &= bool(torch.isfinite(got.float()).all())
        elem = a.element_size()
        bound, by = bound_ms((m * k + k * n + m * n) * elem, 2.0 * m * k * n,
                             BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
        big = m * k * n >= 1 << 30
        row = {"phase": "gemm-kernels", "case": name, "kernel": "gather_matmul",
               "route": tgm.route(a, b),
               "m": m, "k": k, "n": n, "a_transposed": ta, "b_transposed": tb,
               "dtype": dt, "max_abs_err": float(diff.max()),
               "max_abs_ref": float(ref.float().abs().max()),
               "tolerance": ("max|k-r| <= rtol * max|r|" if dtype == torch.float32
                             else "|k-r| <= rtol * (1 + |r|)") + f", rtol {rtol}",
               "ok": ok, **kernel_ms(lambda: tgm.gemm(a, b),
                                     iters=10 if big else 20),
               "plain_ms": cuda_time_ms(lambda: tgm.matmul_ref(a, b), iters=2,
                                        warmup=1),
               "library_ms": cuda_time_ms(lambda: torch.matmul(a, b),
                                          iters=10 if big else 20),
               "library_note": "torch.matmul on the same operands (cuBLAS; "
                               "TF32 off for fp32)",
               "bound_ms": bound, "bound_by": by}
        row["tflops"] = 2.0 * m * k * n / row["ms"] / 1e9
        emit(row)
        if not ok:
            fail(f"gather_matmul disagrees with its plain version ({name})")
        rows[name] = row
        del a, b, got, ref, diff
    torch.cuda.empty_cache()
    return {"gather_matmul": rows[GEMM_ROW_CASE]}


def _zero_counters():
    """Every kernel counter of the port, the GEMM's included."""
    from deepspeed_tpu_torch.ops import gather_matmul as tgm

    return _ring_counters() + (tgm.gemm.launches,)


def _route_counters():
    """The per-route counts of the two kernels that have routes."""
    from deepspeed_tpu_torch.ops import flash_mha as fm
    from deepspeed_tpu_torch.ops import gather_matmul as tgm

    return tgm.gemm.routes, fm.flash_mha.routes


def zero_rank_reference(rank, world, model_kw, params, configs, batch, steps):
    """One rank of the zero-reference phase: the fp32 engine over a data
    axis of ``world`` ranks on the card, per ZeRO config, from ``params``:
    losses, grad norms, whether the fused path is on, launch counts and
    (rank 0) the params after, gathered."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry

    counters = _zero_counters()
    model = registry.get_model_config(TRAIN_MODEL, **model_kw)
    out = {}
    for name, cfg in configs.items():
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=params)
        zero_counts(*counters)
        comm.clear_counts()
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(eng.train_batch(batch)))
            norms.append(eng.get_global_grad_norm())
        launches = {k: v for c in counters for k, v in c.items()}
        calls = comm.calls()
        with zero.GatheredParameters(eng.params) as full:
            gathered = full if rank == 0 else None
        out[name] = {"losses": losses, "grad_norms": norms,
                     "fused": bool(eng.model_config.fused_gather_matmul),
                     "launches": launches, "collective_calls": calls,
                     "stage3_buckets": eng.stage3_buckets,
                     "depth": eng._prefetch_depth,
                     "qwz": eng._qwz, "params": gathered}
        del eng
        torch.cuda.empty_cache()
    return out


def zero_rank_train(rank, world, cfg, seq, steps, ckpt):
    """One rank of the zero3-train phase: gpt2-350m at full width and
    ZERO_LAYERS layers under ZeRO-3 with the fused gather-matmul, a warm-up
    step, ``steps``
    timed steps (counts zeroed just before them and read just after), then
    one step profiled on rank 0; then the ckpt-zero3 phase on the same
    engine (``zero_rank_ckpt``, its result under ``"ckpt"``)."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    counters = _zero_counters() + _route_counters()
    model = registry.get_model_config(TRAIN_MODEL, num_layers=ZERO_LAYERS)
    t0 = time.perf_counter()
    eng, *_ = ds.initialize(model=model, config=cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = (cfg["train_micro_batch_size_per_gpu"]
            * cfg["gradient_accumulation_steps"] * world)
    batch = train_batch_of(model.vocab_size, rows, seed=0, seq=seq)  # the global batch
    t0 = time.perf_counter()
    losses = [float(eng.train_batch(batch))]      # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    comm.clear_counts()
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)))   # float() syncs
        step_s.append(time.perf_counter() - t0)
    launches = {k: v for c in counters[:-2] for k, v in c.items()}
    routes = {k: v for c in counters[-2:] for k, v in c.items()}
    calls = {k: v / steps for k, v in comm.calls().items()}
    shard_bytes = sum(p.numel() * p.element_size() for p in tf.tree_leaves(eng.params))
    res = {"rank": rank, "device": str(eng.device), "init_s": init_s,
           "fused": bool(eng.model_config.fused_gather_matmul),
           "warmup_step_s": warm_s, "step_s": step_s, "losses": losses,
           "launches": launches, "routes": routes,
           "collective_calls_per_step": calls,
           "gather_prefetch_depth": eng._prefetch_depth,
           "stage3_buckets_per_micro_step": eng.stage3_buckets,
           "master_shard_gb": shard_bytes / 1e9,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "finite": bool(np.all(np.isfinite(losses)))}
    if rank == 0:
        wall_ms, by_name, busy_ms, events = profile_call(
            lambda: eng.train_batch(batch))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        res["profile"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "collectives": comm_ms(events, names=("comm.all_gather",
                                                "comm.reduce_scatter",
                                                "comm.all_reduce")),
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_ms": {n: sum(v for k, v in by_name.items()
                                 if all(x in k for x in parts))
                          for n, parts in PROFILE_NAMES.items()
                          if n.startswith("flash") or n in ("fused_adamw",
                                                            "gather_matmul")},
            "gemm_ms": sum(v for k, v in by_name.items()
                           if any(x in k for x in ("gemm", "nvjet", "cutlass",
                                                   "xmma"))),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}
    else:
        eng.train_batch(batch)    # the profiled step's partner
    held = [eng]      # handed over, so that the checkpoint phase frees it
    del eng
    res["ckpt"] = zero_rank_ckpt(held, model, cfg, counters, batch, **ckpt)
    return res


def zero_rank_ckpt(held, model, cfg, counters, batch, root, small_cfg,
                   small_batch, small_kw):
    """The ckpt-zero3 phase in a zero3-train rank, after its profiled
    step: the ZeRO-3 state is gathered and saved through the pickle engine
    (the gather's host seconds from ``last_checkpoint_stats``) and
    converted to universal, and CKPT_ZERO_STEPS more steps are taken; for
    each of CKPT_ZERO_FORMS a fresh engine of another seed loads the save
    at the same data axis and takes the same steps (losses, this rank's
    master slices and launches are returned beside the uninterrupted
    run's).  Then the elastic shrink's source: the 2-layer fp32 model
    (``small_cfg``) trains, is saved and converted at data 2, and
    continues at data 2."""
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.checkpoint import universal as cu
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    def run(e):
        zero_counts(*counters)
        losses = [float(e.train_batch(batch)) for _ in range(CKPT_ZERO_STEPS)]
        return (losses, {k: v for c in counters for k, v in c.items()},
                [m.detach().clone() for m in tf.tree_leaves(e._masters)])

    t_phase = time.perf_counter()
    eng = held.pop()
    eng.save_checkpoint(root, tag="zero3")
    stats = dict(eng.last_checkpoint_stats)
    t0 = time.perf_counter()
    cu.ds_to_universal(root, tag="zero3", engine=eng)
    convert_s = time.perf_counter() - t0
    shard_gb = sum(t.tensor.numel() * t.tensor.element_size()
                   for t in eng._checkpoint_leaves()) / 1e9
    after, launches_after, masters = run(eng)
    out = {"gather_s": stats["gather_s"], "save_s": stats["save_s"],
           "convert_s": convert_s, "state_shard_gb": shard_gb,
           "after": after, "launches_after": launches_after, "forms": {}}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    for i, form in enumerate(CKPT_ZERO_FORMS):
        e2, *_ = ds.initialize(model=model, seed=1 + i, config={
            **cfg, "load_universal_checkpoint": form == "universal"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e2.load_checkpoint(root, tag="zero3")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got, launched, got_masters = run(e2)
        out["forms"][form] = {
            "load_s": load_s, "resumed": got, "launches": launched,
            "masters_equal": all(torch.equal(a, b)
                                 for a, b in zip(masters, got_masters))}
        del e2, got_masters
        gc.collect()
        torch.cuda.empty_cache()
    del masters

    small = registry.get_model_config(TRAIN_MODEL, **small_kw)
    e3, *_ = ds.initialize(model=small, config=small_cfg, seed=3)
    for _ in range(ZERO_REF_STEPS):
        e3.train_batch(small_batch)
    e3.save_checkpoint(root, tag="small")
    cu.ds_to_universal(root, tag="small", engine=e3)
    out["small_after_data2"] = [float(e3.train_batch(small_batch))
                                for _ in range(ZERO_REF_STEPS)]
    del e3
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def phase_zero_reference(ds, tf_model, tf, launch):
    """The ZeRO configs in two ranks on the card (gloo, one card) against
    one engine in this process on the CPU at data 1, fp32, gpt2-350m width
    cut to ZERO_REF_LAYERS: losses and grad norms of each step to
    ZERO_REF_RTOL, the gathered params after them to ZERO_REF_PARAMS_RTOL
    (relative L2), and each rank's launches (gather_matmul in the fused
    run only).  The qwZ config is held to a second CPU engine, ZeRO-3 with
    qwZ at data 1."""
    import numpy as np
    import torch

    model_kw = {"num_layers": ZERO_REF_LAYERS}
    model = tf_model.get_model_config(TRAIN_MODEL, **model_kw)
    gas = ZERO_CFG["gradient_accumulation_steps"]
    base = {k: v for k, v in ZERO_CFG.items()
            if k not in ("mesh", "step_schedule", "zero_optimization")}
    base = {**base, "bf16": {"enabled": False},
            "train_micro_batch_size_per_gpu": ZERO_REF_MICRO}
    host, *_ = ds.initialize(model=model, device="cpu", seed=3, config={
        **base, "train_micro_batch_size_per_gpu": ZERO_REF_MICRO * ZERO_RANKS})
    params = tf.tree_map_with_path(lambda _p, a: a.detach().clone(),
                                   host.params)
    rows = ZERO_REF_MICRO * gas * ZERO_RANKS
    batch = train_batch_of(model.vocab_size, rows, seed=6, seq=ZERO_REF_SEQ)
    layer_elems = sum(a[0].numel() for a in tf.tree_leaves(params["layers"]))

    def host_steps(eng):
        out = [(float(eng.train_batch(batch)), eng.get_global_grad_norm())
               for _ in range(ZERO_REF_STEPS)]
        return out, eng.params

    # the qwZ reference: ZeRO-3 at data 1 takes the codec's round trip on
    # every leaf (nothing is gathered), as the JAX engine does
    host_qwz, *_ = ds.initialize(model=model, device="cpu", config={
        **base, "train_micro_batch_size_per_gpu": ZERO_REF_MICRO * ZERO_RANKS,
        "zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
        model_parameters=params)
    configs = {}
    for name, (stage, fused, extra) in ZERO_REF_CONFIGS.items():
        zc = {"stage": stage, "param_persistence_threshold": 0,
              **extra.get("zero_optimization", {})}
        if zc.get("reduce_bucket_size") == "one layer":
            zc["reduce_bucket_size"] = layer_elems
        cfg = {**base, "mesh": {"data": ZERO_RANKS}, "zero_optimization": zc}
        ss = {**extra.get("step_schedule", {})}
        if fused:
            ss["fused_gather_matmul"] = True
        if ss:
            cfg["step_schedule"] = ss
        configs[name] = cfg
    # the card's ranks train while this process runs the CPU engines
    with ThreadPoolExecutor(1) as pool:
        card = pool.submit(launch, zero_rank_reference, ZERO_RANKS,
                           args=(model_kw, params, configs, batch,
                                 ZERO_REF_STEPS),
                           backend=ZERO_BACKEND, device="cuda")
        want = {False: host_steps(host), True: host_steps(host_qwz)}
        ranks = card.result()
    per = ZERO_REF_STEPS * gas * ZERO_REF_LAYERS
    for name, (stage, fused, extra) in ZERO_REF_CONFIGS.items():
        zc = configs[name]["zero_optimization"]
        qwz = bool(zc.get("zero_quantized_weights"))
        depth = configs[name].get("step_schedule", {}).get(
            "gather_prefetch_depth", 1)
        steps_want, host_params = want[qwz]
        got = [r[name] for r in ranks]
        worst = 0.0
        for r in got:
            for (lc, gc), (lh, gh) in zip(zip(r["losses"], r["grad_norms"]),
                                          steps_want):
                worst = max(worst, abs(lc - lh) / abs(lh), abs(gc - gh) / gh)
        num = den = 0.0
        for a, b in zip(tf.tree_leaves(got[0]["params"]),
                        tf.tree_leaves(host_params)):
            a, b = a.double(), b.detach().double()
            num += float(((a - b) ** 2).sum())
            den += float((b ** 2).sum())
        params_rel = (num / den) ** 0.5
        wants = [{**{k: 0 for k in r["launches"]},
                  "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                  "fused_adamw": ZERO_REF_STEPS,
                  "gather_matmul": 6 * per if fused else 0} for r in got]
        launches = [r["launches"] for r in got]
        ok = (worst <= ZERO_REF_RTOL and params_rel <= ZERO_REF_PARAMS_RTOL
              and launches == wants and all(r["fused"] == fused for r in got)
              and all(r["depth"] == depth for r in got)
              and all((r["qwz"] is not None) == qwz for r in got)
              and bool(np.all(np.isfinite([r["losses"] for r in got]))))
        emit({"phase": "zero-reference", "config": name, "zero_stage": stage,
              "fused_gather_matmul": fused, "gather_prefetch_depth": depth,
              "reduce_bucket_size": zc.get("reduce_bucket_size", 500_000_000),
              "qwz": got[0]["qwz"], "model": TRAIN_MODEL,
              "layers": ZERO_REF_LAYERS, "dtype": "float32",
              "ranks": ZERO_RANKS, "backend": ZERO_BACKEND,
              "seq": ZERO_REF_SEQ, "micro_per_rank": ZERO_REF_MICRO,
              "gas": gas,
              "steps": [{"loss_card": [r["losses"][i] for r in got],
                         "loss_cpu": steps_want[i][0],
                         "grad_norm_card": [r["grad_norms"][i] for r in got],
                         "grad_norm_cpu": steps_want[i][1]}
                        for i in range(ZERO_REF_STEPS)],
              "check": "two ranks on the card (kernels, cuBLAS, ZeRO over "
                       "gloo) vs one CPU process at data 1 (plain versions"
                       + ("; ZeRO-3 with qwZ: the round trip on every leaf)"
                          if qwz else ")"),
              "max_rel_err_loss_grad_norm": worst, "params_rel_l2": params_rel,
              "tolerance": {"loss_grad_norm": ZERO_REF_RTOL,
                            "params_rel_l2": ZERO_REF_PARAMS_RTOL},
              "launches_per_rank": launches, "expected_per_rank": wants,
              "collective_calls_rank0": got[0]["collective_calls"],
              "stage3_buckets_last_micro_step": got[0]["stage3_buckets"],
              "ok": ok})
        if not ok:
            fail(f"zero-reference ({name}): the card's ranks differ from the "
                 f"CPU ({worst}, {params_rel}), launched {launches}, or the "
                 "fused gate, the depth or the wire decided otherwise")
    del host, host_qwz, params, ranks, want
    torch.cuda.empty_cache()


def phase_zero_train(tf_model, launch, card, ckpt):
    """gpt2-350m at full width and ZERO_LAYERS layers under ZeRO-3 with the
    fused gather-matmul over ZERO_RANKS ranks sharing the card (gloo):
    seconds a step (the slower rank's), tokens/s for the card, peak memory
    a rank, a
    profiled step on rank 0 with the host time inside all_gather,
    reduce_scatter and all_reduce (``comm_ms``), and each rank's launches a
    step, which must be 6 GEMMs x layers x gas of gather_matmul, layers x
    gas of each flash kernel, one AdamW and nothing else.  The ranks then
    run the ckpt-zero3 phase (``ckpt``: ``zero_rank_ckpt``'s arguments);
    returns the kernel line's launches and the ranks' results."""
    import numpy as np

    model = tf_model.get_model_config(TRAIN_MODEL, num_layers=ZERO_LAYERS)
    gas = ZERO_CFG["gradient_accumulation_steps"]
    per = model.num_layers * gas
    emit({"phase": "zero-backend", "backend": ZERO_BACKEND,
          "why": "the ranks share one card, and NCCL refuses two ranks on "
                 "one GPU; all-gather and reduce-scatter buffers go through "
                 "pinned host memory, every computation stays on the card"})
    ranks = launch(zero_rank_train, ZERO_RANKS,
                   args=(ZERO_CFG, TRAIN_SEQ, ZERO_STEPS, ckpt),
                   backend=ZERO_BACKEND, device="cuda")
    rows = ZERO_CFG["train_micro_batch_size_per_gpu"] * gas * ZERO_RANKS
    tokens = rows * TRAIN_SEQ
    step_s = [max(r["step_s"][i] for r in ranks) for i in range(ZERO_STEPS)]
    want = {**{k: 0 for k in ranks[0]["launches"]},
            "gather_matmul": 6 * per, "flash_fwd": per, "flash_bwd_dq": per,
            "flash_bwd_dkv": per, "fused_adamw": 1}
    per_step = [{k: v / ZERO_STEPS for k, v in r["launches"].items()}
                for r in ranks]
    # every GEMM and every attention launch on the wgmma route
    want_routes = {**{k: 0 for k in ranks[0]["routes"]},
                   "gather_matmul.wgmma": 6 * per, "flash_fwd.wgmma": per,
                   "flash_bwd_dq.wgmma": per, "flash_bwd_dkv.wgmma": per}
    routes_per_step = [{k: v / ZERO_STEPS for k, v in r["routes"].items()}
                       for r in ranks]
    ok = (all(r["finite"] and r["fused"] for r in ranks)
          and all(r["gather_prefetch_depth"] == 2 for r in ranks)
          and all(r["losses"] == ranks[0]["losses"] for r in ranks)
          and ranks[0]["losses"][-1] < ranks[0]["losses"][0]
          and all(p == want for p in per_step)
          and all(p == want_routes for p in routes_per_step))
    tps = tokens * ZERO_STEPS / sum(step_s)
    emit({"phase": "zero3-train", "model": TRAIN_MODEL,
          "layers": model.num_layers, "dtype": "bfloat16", "zero_stage": 3,
          "fused_gather_matmul": True, "persistence_threshold": 0,
          "ranks": ZERO_RANKS, "backend": ZERO_BACKEND, "seq": TRAIN_SEQ,
          "micro_per_rank": ZERO_CFG["train_micro_batch_size_per_gpu"],
          "gas": gas, "optimizer": ZERO_CFG["optimizer"], "remat": "none",
          "gather_prefetch_depth": ZERO_CFG["step_schedule"][
              "gather_prefetch_depth"],
          "step_s": step_s, "tokens_per_step": tokens, "tokens_per_s": tps,
          "mfu": tps * 3 * fwd_flops_per_tok(model, TRAIN_SEQ) / BF16_FLOPS,
          "mfu_peak": "989 TFLOP/s bf16 dense (H100 SXM), one card for both "
                      "ranks; the formula counts dense attention",
          "ranks_detail": [{k: v for k, v in r.items()
                            if k not in ("profile", "ckpt")} for r in ranks],
          "launches_per_step": per_step, "expected_per_step": want,
          "routes_per_step": routes_per_step,
          "expected_routes_per_step": want_routes, "card": card, "ok": ok})
    prof = ranks[0]["profile"]
    emit({"phase": "zero3-train-profile",
          "what": "one train_batch on rank 0 (rank 1 steps beside it)",
          "collectives_note": "host time inside comm.all_gather (issue and "
                              "wait ranges of each flat layer gather and "
                              "each fused-MLP gather), "
                              "comm.reduce_scatter (the stage-3 gradient "
                              "buckets) and comm.all_reduce (the loss sum "
                              "and count, the grad norm); own = less this "
                              "rank's compute kernels running",
          **prof, "card": card})
    if not ok:
        fail("zero3-train: losses not finite, not equal on the ranks or not "
             "falling, the fused path off, or the launch or route counts do "
             "not show the kernels")
    return {"gather_matmul": ranks[0]["launches"]["gather_matmul"]}, ranks


# ----------------------------------------------------------------------
# zeropp-reference and zeropp-train: hierarchical ZeRO++
# ----------------------------------------------------------------------
def _all_gathers(comm, steps):
    """The all-gathers issued since the counts were cleared, by group,
    divided by ``steps``."""
    return {g: ops["all_gather"] / steps
            for g, ops in comm.group_calls.items() if ops.get("all_gather")}


def _nested(eng):
    """How many of ``eng``'s masters are a slice of their param (or of
    its slice: hpZ's nested state), each gathered back into it once a
    step (under hpZ at stage 3 over the outer group)."""
    return sum(place.rel is not None for place in eng._places)


def weight_gathers_inner(all_gathers, stepped):
    """Whether, of the all-gathers by group of an hpZ stage-3 run, the
    weight gathers all ran over the inner group: the outer group's are
    the ``stepped`` slices' alone, and no other group gathered."""
    return (set(all_gathers) == {"inner", "outer"} and stepped > 0
            and all_gathers["outer"] == stepped)


def zpp_rank_reference(rank, world, model_kw, params, configs, batch,
                       device=None, threads=None):
    """One rank of the zeropp-reference phase: per config, the fp32
    engine over ``{"data": world}`` (factored by the config's hpZ or MiCS
    key) from ``params``, ZPP_REF_STEPS steps: losses, grad norms, the
    modes, launch counts, the all-gathers by group (``all_gathers``) and
    how many of them gathered stepped slices (``stepped``: one a step for
    each master nested in a param slice), the collectives' bytes a step by
    group and, on rank 0, the params after the steps, gathered."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 2) // world))
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry

    counters = _zero_counters()
    model = registry.get_model_config(TRAIN_MODEL, **model_kw)
    out = {}
    for name, cfg in configs.items():
        steps = ZPP_REF_STEPS.get(name, 1)
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=params, device=device)
        zero_counts(*counters)
        comm.clear_counts()
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(eng.train_batch(batch)))
            norms.append(eng.get_global_grad_norm())
        topo = eng.topology
        res = {"losses": losses, "grad_norms": norms,
               "launches": {k: v for c in counters for k, v in c.items()},
               "all_gathers": _all_gathers(comm, 1),
               "stepped": steps * _nested(eng),
               "bytes_per_step": {g: {op: n / steps for op, n in ops.items()}
                                  for g, ops in comm.group_nbytes.items()},
               "modes": {"secondary": eng._secondary_mode,
                         "onebit": eng._onebit_variant,
                         "qwz": eng._qwz is not None,
                         "outer_x_inner": [topo.outer_size,
                                           topo.inner_size]}}
        with zero.GatheredParameters(eng.params) as full:
            res["params"] = full if rank == 0 else None
        out[name] = res
        del eng
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def zpp_rank_train(rank, world, runs, seq, hpz_steps):
    """One rank of the zeropp-train phase: per run (name -> (config, model
    overrides)), the engine on the card: a warm-up step, then ``hpz_steps``
    timed steps for the hpZ run and one for every other run; counts
    zeroed just before the timed steps and read just after (launches and
    routes a step, the collectives and bytes a step by group, the
    all-gathers a step by group and the stepped slices' among them, peak
    memory); then one step profiled on rank 0 (the other ranks step
    beside it)."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry

    counters = _zero_counters() + _route_counters()
    out = {}
    for name, (cfg, model_kw) in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = registry.get_model_config(TRAIN_MODEL, **model_kw)
        t0 = time.perf_counter()
        eng, *_ = ds.initialize(model=model, config=cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rows = (cfg["train_micro_batch_size_per_gpu"]
                * cfg["gradient_accumulation_steps"] * world)
        batch = train_batch_of(model.vocab_size, rows, seed=0, seq=seq)
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(batch))]    # warm-up
        warm_s = time.perf_counter() - t0
        steps = hpz_steps if name == "hpz" else 1
        zero_counts(*counters)
        comm.clear_counts()
        step_s = []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(batch)))   # float() syncs
            step_s.append(time.perf_counter() - t0)
        res = {"init_s": init_s, "warmup_step_s": warm_s, "step_s": step_s,
               "losses": losses, "layers": model.num_layers,
               "launches_per_step": {k: v / steps for c in counters[:-2]
                                     for k, v in c.items()},
               "routes_per_step": {k: v / steps for c in counters[-2:]
                                   for k, v in c.items()},
               "calls_per_step": {g: {op: n / steps for op, n in ops.items()}
                                  for g, ops in comm.group_calls.items()},
               "bytes_per_step": {g: {op: n / steps for op, n in ops.items()}
                                  for g, ops in comm.group_nbytes.items()},
               "all_gathers_per_step": _all_gathers(comm, steps),
               "stepped_per_step": _nested(eng),
               "secondary": eng._secondary_mode,
               "onebit": eng._onebit_variant,
               "outer_x_inner": [eng.topology.outer_size,
                                 eng.topology.inner_size],
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2 ** 30,
               "memory_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
               "finite": bool(np.all(np.isfinite(losses)))}
        if rank == 0:
            wall_ms, by_name, busy_ms, events = profile_call(
                lambda: eng.train_batch(batch))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            res["profile"] = {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
                "collectives": comm_ms(events, names=(
                    "comm.all_gather", "comm.reduce_scatter",
                    "comm.all_reduce", "comm.all_to_all")),
                "top_kernels_ms": [[k[:90], v] for k, v in top]}
        else:
            eng.train_batch(batch)
        out[name] = res
        del eng
    return out


def zpp_rank_card(rank, world, reference, train, cpu_done):
    """One card rank of the zeropp phases: the reference configs
    (``zpp_rank_reference``'s arguments), then, once the file ``cpu_done``
    exists (the reference's CPU ranks have finished), the training runs
    (``zpp_rank_train``'s)."""
    ref = zpp_rank_reference(rank, world, *reference)
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    while not os.path.exists(cpu_done):
        if time.perf_counter() > t0 + 900:
            raise RuntimeError("zeropp: the CPU reference ranks did not "
                               "finish within 900 s")
        time.sleep(0.2)
    return {"reference": ref, "waited_s": time.perf_counter() - t0,
            "train": zpp_rank_train(rank, world, *train)}


def zpp_reference_setup(tf_model, tf):
    """The zeropp-reference phase's inputs: ``(model_kw, configs, params,
    batch)``."""
    model_kw = {"num_layers": ZERO_REF_LAYERS}
    model = tf_model.get_model_config(TRAIN_MODEL, **model_kw)
    base = {**{k: v for k, v in ZPP_TRAIN_CFG.items()},
            "bf16": {"enabled": False},
            "train_micro_batch_size_per_gpu": ZPP_REF_MICRO}
    configs = {name: {**base, "zero_optimization": {
        "param_persistence_threshold": 0, **zc}}
        for name, zc in ZPP_REF_CONFIGS.items()}
    params = tf.init_params(model, seed=3, device="cpu")
    rows = ZPP_REF_MICRO * ZPP_TRAIN_CFG["gradient_accumulation_steps"] \
        * ZPP_RANKS
    batch = train_batch_of(model.vocab_size, rows, seed=8, seq=ZPP_REF_SEQ)
    batch["labels"][0, :5] = -100          # the ranks' token counts differ
    return model_kw, configs, params, batch


def phase_zeropp(tf_model, tf, launch, card):
    """zeropp-reference and zeropp-train in one launch of ZPP_RANKS card
    ranks (gloo, one card), the reference's CPU ranks in a thread beside
    them.  zeropp-reference: per ZPP_REF_CONFIGS config the card against
    the CPU, losses and grad norms to ZERO_REF_RTOL and the gathered
    params to ZERO_REF_PARAMS_RTOL (relative L2; qgZ: losses to
    DPQ_REF_RTOL, params within DPQ_REF_UPDATE_RTOL["qgz"] of the update's
    L2 norm), the same modes, each card rank's launches and, under hpZ,
    every weight gather over the inner group, with the bytes a step by
    group.  zeropp-train: ZPP_TRAIN_RUNS (see ZPP_TRAIN_CFG).  Returns
    rank 0's launches a step by run, for the kernels line."""
    import numpy as np
    import torch

    gas = ZPP_TRAIN_CFG["gradient_accumulation_steps"]
    model_kw, configs, params, batch = zpp_reference_setup(tf_model, tf)
    runs = {name: ({**ZPP_TRAIN_CFG, **extra}, kw)
            for name, (extra, kw) in ZPP_TRAIN_RUNS.items()}
    emit({"phase": "zeropp-backend", "backend": ZPP_BACKEND,
          "ranks": ZPP_RANKS,
          "why": "the ranks share one card, and NCCL refuses two ranks on "
                 "one GPU; all-gather, reduce-scatter and all-to-all "
                 "buffers go through pinned host memory, every computation "
                 "stays on the card"})
    names = list(configs)
    parts = [{n: configs[n] for n in names[i::ZPP_REF_CPU_LAUNCHES]}
             for i in range(ZPP_REF_CPU_LAUNCHES)]
    threads = max(1, (os.cpu_count() or 2) // (ZPP_RANKS * len(parts)))
    cpu_done = ROOT / "build" / "zeropp_cpu_reference.done"
    cpu_done.parent.mkdir(exist_ok=True)
    cpu_done.unlink(missing_ok=True)
    for t in tf.tree_leaves(params):   # before several launches pickle them
        t.share_memory_()

    def cpu_reference():
        try:
            with ThreadPoolExecutor(len(parts)) as inner:
                runs_ = [inner.submit(launch, zpp_rank_reference, ZPP_RANKS,
                                      args=(model_kw, params, part, batch,
                                            "cpu", threads),
                                      backend=ZPP_BACKEND, device="cpu")
                         for part in parts]
                out = [{} for _ in range(ZPP_RANKS)]
                for run in runs_:
                    for rank, res in enumerate(run.result()):
                        out[rank].update(res)
            return out
        finally:          # the card ranks wait for it, failed or not
            cpu_done.touch()

    with ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(cpu_reference)
        ranks = launch(zpp_rank_card, ZPP_RANKS,
                       args=((model_kw, params, configs, batch),
                             (runs, TRAIN_SEQ, ZPP_HPZ_STEPS),
                             str(cpu_done)),
                       backend=ZPP_BACKEND, device="cuda")
        cpu = cpu_run.result()
    cpu_done.unlink(missing_ok=True)
    for name in ZPP_REF_CONFIGS:
        n_steps = ZPP_REF_STEPS.get(name, 1)
        per = n_steps * gas * ZERO_REF_LAYERS
        got = [r["reference"][name] for r in ranks]
        want = [r[name] for r in cpu]
        worst = max(abs(a - b) / abs(b) for g, w in zip(got, want)
                    for a, b in zip(g["losses"], w["losses"]))
        qgz = got[0]["modes"]["onebit"] == "qgz"
        if not qgz:
            worst = max([worst] + [abs(a - b) / b for g, w in zip(got, want)
                                   for a, b in zip(g["grad_norms"],
                                                   w["grad_norms"])])
        params_rel = _params_rel(got[0]["params"], want[0]["params"], tf)
        _w, update_rel, _whole, _b, _o = dpq_reference_readings(
            tf, params, "qgz", [{**got[0], "modes": {"onebit": "qgz"}}],
            [want[0]])
        q, dq = ZPP_QUANT_LAUNCHES.get(name, (0, 0))
        wants = [{**{k: 0 for k in g["launches"]},
                  "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                  "fused_adamw": 0 if qgz else n_steps,
                  "quantize": q * n_steps,
                  "dequantize": dq * n_steps} for g in got]
        launches = [g["launches"] for g in got]
        # under hpZ at stage 3 the weight gathers run over the inner group
        # and only the stepped slices over the outer one
        hpz = got[0]["modes"]["secondary"] == "hpz" \
            and ZPP_REF_CONFIGS[name]["stage"] == 3
        gathers_inner = all(weight_gathers_inner(g["all_gathers"],
                                                 g["stepped"]) for g in got)
        if qgz:
            ok = (worst <= DPQ_REF_RTOL
                  and update_rel <= DPQ_REF_UPDATE_RTOL["qgz"])
        else:
            ok = worst <= ZERO_REF_RTOL and params_rel <= ZERO_REF_PARAMS_RTOL
        ok = (ok and launches == wants and (gathers_inner or not hpz)
              and all(g["modes"] == want[0]["modes"] for g in got + want)
              and got[0]["modes"]["outer_x_inner"] == [2, 2]
              and all(np.isfinite(g["losses"]).all() for g in got))
        emit({"phase": "zeropp-reference", "config": name,
              "zero_optimization": ZPP_REF_CONFIGS[name],
              "modes": got[0]["modes"], "model": TRAIN_MODEL,
              "layers": ZERO_REF_LAYERS, "dtype": "float32",
              "ranks": ZPP_RANKS, "backend": ZPP_BACKEND,
              "seq": ZPP_REF_SEQ, "micro_per_rank": ZPP_REF_MICRO,
              "gas": gas, "steps": n_steps, "losses_card": [g["losses"] for g in got],
              "losses_cpu": [w["losses"] for w in want],
              "grad_norms_card": got[0]["grad_norms"],
              "grad_norms_cpu": want[0]["grad_norms"],
              "check": "four ranks on the card (kernels, cuBLAS, ZeRO over "
                       "gloo) vs four ranks on the CPU (plain versions), "
                       "the same config",
              "max_rel_err_loss_grad_norm": worst,
              "params_rel_l2": params_rel,
              "params_distance_over_update_l2": update_rel,
              "tolerance": ({"loss": DPQ_REF_RTOL,
                             "params_over_update": DPQ_REF_UPDATE_RTOL["qgz"]}
                            if qgz else
                            {"loss_grad_norm": ZERO_REF_RTOL,
                             "params_rel_l2": ZERO_REF_PARAMS_RTOL}),
              "all_gathers_by_group_rank0": got[0]["all_gathers"],
              "stepped_slice_gathers_rank0": got[0]["stepped"],
              "weight_gathers_inner_only": gathers_inner if hpz else None,
              "bytes_per_step_by_group_rank0": got[0]["bytes_per_step"],
              "launches_per_rank": launches, "expected_per_rank": wants,
              "ok": bool(ok)})
        if not ok:
            fail(f"zeropp-reference ({name}): the card's ranks differ from "
                 f"the CPU's ({worst}, {params_rel}, {update_rel}), chose "
                 f"other modes, gathered over {got[0]['all_gathers']} or "
                 f"launched {launches}, expected {wants}")
    del cpu, params
    # zeropp-train
    out = {}
    for name, (extra, kw) in ZPP_TRAIN_RUNS.items():
        got = [r["train"][name] for r in ranks]
        model = tf_model.get_model_config(TRAIN_MODEL, **kw)
        per_run = model.num_layers * gas
        steps = len(got[0]["step_s"])
        step_s = [max(g["step_s"][i] for g in got) for i in range(steps)]
        rows = ZPP_TRAIN_CFG["train_micro_batch_size_per_gpu"] * gas \
            * ZPP_RANKS
        tokens = rows * TRAIN_SEQ
        tps = tokens * steps / sum(step_s)
        qgz = got[0]["onebit"] == "qgz"
        q, dq = (2, 2) if qgz else (0, 0)
        want = {**{k: 0 for k in got[0]["launches_per_step"]},
                "flash_fwd": per_run, "flash_bwd_dq": per_run,
                "flash_bwd_dkv": per_run, "fused_adamw": 0 if qgz else 1,
                "quantize": q, "dequantize": dq}
        want_routes = {**{k: 0 for k in got[0]["routes_per_step"]},
                       "flash_fwd.wgmma": per_run,
                       "flash_bwd_dq.wgmma": per_run,
                       "flash_bwd_dkv.wgmma": per_run}
        ok = (all(g["finite"] for g in got)
              and all(g["losses"] == got[0]["losses"] for g in got)
              and all(g["launches_per_step"] == want for g in got)
              and all(g["routes_per_step"] == want_routes for g in got)
              and all(g["outer_x_inner"] == [2, 2] for g in got))
        if name == "hpz":
            ok = (ok and got[0]["losses"][-1] < got[0]["losses"][0]
                  and all(weight_gathers_inner(g["all_gathers_per_step"],
                                               g["stepped_per_step"])
                          for g in got))
        emit({"phase": "zeropp-train", "run": name, "model": TRAIN_MODEL,
              "layers": model.num_layers, "dtype": "bfloat16",
              "zero_optimization": extra["zero_optimization"],
              "secondary": got[0]["secondary"], "onebit": got[0]["onebit"],
              "ranks": ZPP_RANKS, "backend": ZPP_BACKEND, "seq": TRAIN_SEQ,
              "micro_per_rank": ZPP_TRAIN_CFG["train_micro_batch_size_per_gpu"],
              "gas": gas, "remat": "none", "gather_prefetch_depth": 2,
              "optimizer": ZPP_TRAIN_CFG["optimizer"],
              "step_s": step_s, "tokens_per_step": tokens,
              "tokens_per_s": tps,
              "mfu": tps * 3 * fwd_flops_per_tok(model, TRAIN_SEQ)
              / BF16_FLOPS,
              "mfu_peak": "989 TFLOP/s bf16 dense (H100 SXM), one card for "
                          "the four ranks; the formula counts dense "
                          "attention",
              "timed": "after a warm-up step",
              "card_ranks_waited_for_cpu_reference_s":
                  [r["waited_s"] for r in ranks],
              "losses": got[0]["losses"],
              "init_s": [g["init_s"] for g in got],
              "max_memory_allocated_gib": [g["max_memory_allocated_gib"]
                                           for g in got],
              "memory_reserved_gib": [g["memory_reserved_gib"] for g in got],
              "collectives_per_step_by_group_rank0":
                  got[0]["calls_per_step"],
              "bytes_per_step_by_group_rank0": got[0]["bytes_per_step"],
              "all_gathers_per_step_by_group":
                  [g["all_gathers_per_step"] for g in got],
              "stepped_slice_gathers_per_step": got[0]["stepped_per_step"],
              "launches_per_step": [g["launches_per_step"] for g in got],
              "expected_per_step": want, "card": card, "ok": bool(ok)})
        emit({"phase": "zeropp-train-profile", "run": name,
              "what": "one train_batch on rank 0 (ranks 1-3 step beside "
                      "it)",
              "collectives_note": "host time inside each comm range: the "
                                  "weight gathers and stepped slices "
                                  "(all_gather), the stage-3 gradient "
                                  "buckets and hpZ's outer buckets "
                                  "(reduce_scatter), the loss, norm and "
                                  "MiCS's outer sums (all_reduce), qgZ's "
                                  "exchanges (all_to_all); own = less this "
                                  "rank's compute kernels running",
              **got[0]["profile"], "card": card})
        if not ok:
            fail(f"zeropp-train ({name}): losses not finite, not equal on "
                 "the ranks or not falling, a weight gather off the inner "
                 "group, or the launch or route counts do not show the "
                 "kernels")
        out[name] = got[0]["launches_per_step"]
    del ranks
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phases 23-25: checkpoints (ckpt-zero3 in the zero3-train ranks, then
# ckpt-train) and recovery
# ----------------------------------------------------------------------
def dir_bytes(path) -> int:
    """Bytes of the files under ``path`` (or of the file itself)."""
    path = Path(path)
    if path.is_file():
        return path.stat().st_size
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def gbps(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds > 0 else None


def phase_ckpt_train(ds, tf_model, tf, counters, want, card):
    """gpt2-350m at full width and CKPT_LAYERS layers (CKPT_CFG): CKPT_STEPS
    steps, a save through each writer the config names
    (``checkpoint.writer.type`` "": pickle, then ds_to_universal of the
    pickle tag; "fast";
    "decoupled", whose write overlaps the uninterrupted run's next
    CKPT_STEPS steps), then for each saved form a fresh engine of another
    seed, configured for that form, loads it and takes the same steps:
    losses and every master leaf must equal the uninterrupted run's bit
    for bit, and each resumed run launches ``want``.  Per form: bytes,
    save and load seconds and GB/s (reads are warm: the page cache holds
    what was just written), and the decoupled save's blocking time.  Each
    tag is deleted after its check."""
    import shutil

    import torch

    from deepspeed_tpu_torch.checkpoint import universal as cu

    root = CKPT_ROOT / "train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model = tf_model.get_model_config(TRAIN_MODEL, num_layers=CKPT_LAYERS)
    rows = CKPT_CFG["train_micro_batch_size_per_gpu"] * CKPT_CFG[
        "gradient_accumulation_steps"]
    batch = train_batch_of(model.vocab_size, rows, seed=5, seq=TRAIN_SEQ)
    eng, *_ = ds.initialize(model=model, config=CKPT_CFG, seed=0)
    before = [float(eng.train_batch(batch)) for _ in range(CKPT_STEPS)]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def writer(form):
        """The config's writer for ``form``: the universal dir is the
        pickle tag's conversion."""
        return "" if form in ("pickle", "universal") else form

    def save(form):
        eng.config.checkpoint_config.writer_type = writer(form)
        return timed(lambda: eng.save_checkpoint(str(root), tag=form))[1]

    saves = {"pickle": {"save_s": save("pickle"),
                        "bytes": dir_bytes(root / "pickle")}}
    out, sec = timed(lambda: cu.ds_to_universal(str(root), tag="pickle"))
    saves["universal"] = {"save_s": sec, "bytes": dir_bytes(out),
                          "note": "ds_to_universal of the pickle tag: reads "
                                  "the pickle, writes one .npy a leaf"}
    saves["fast"] = {"save_s": save("fast"), "bytes": dir_bytes(root / "fast")}
    t0 = time.perf_counter()
    save("decoupled")
    blocked = eng.checkpoint_engine.last_save_blocked_s
    # the uninterrupted run's next steps, while the decoupled write is in
    # flight: its snapshot must not see them
    zero_counts(*counters)
    after = [float(eng.train_batch(batch)) for _ in range(CKPT_STEPS)]
    ref_launches = {k: v for c in counters for k, v in c.items()}
    eng.checkpoint_engine.wait()
    saves["decoupled"] = {"save_s": blocked + eng.checkpoint_engine.last_write_s,
                          "blocked_s": blocked,
                          "commit_s": time.perf_counter() - t0,
                          "bytes": dir_bytes(root / "decoupled"),
                          "note": f"save_s: blocked_s (the copies into "
                                  f"pinned host memory and the sync) plus "
                                  f"the worker thread's write, during which "
                                  f"the {CKPT_STEPS} steps after the save "
                                  f"ran; commit_s: save() to the commit"}
    masters = [t.detach().clone() for t in tf.tree_leaves(eng._masters)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    ok = ref_launches == want
    for form in CKPT_FORMS:
        e2, *_ = ds.initialize(model=model, seed=1, config={
            **CKPT_CFG, "load_universal_checkpoint": form == "universal",
            "checkpoint": {"writer": {"type": writer(form)}}})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the universal dir is found under the pickle tag
        e2.load_checkpoint(str(root), tag="pickle" if form == "universal"
                           else form)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        zero_counts(*counters)
        got = [float(e2.train_batch(batch)) for _ in range(CKPT_STEPS)]
        launched = {k: v for c in counters for k, v in c.items()}
        diff = max(float((a - b.detach()).abs().max())
                   for a, b in zip(masters, tf.tree_leaves(e2._masters)))
        same = got == after and diff == 0.0
        row = saves[form]
        emit({"phase": "ckpt-train", "form": form,
              "writer": writer(form) or "pickle", "model": TRAIN_MODEL,
              "layers": model.num_layers, "dtype": "bfloat16 over fp32 "
              "masters", "micro": CKPT_CFG["train_micro_batch_size_per_gpu"],
              "gas": CKPT_CFG["gradient_accumulation_steps"],
              "gas_note": "the train phase's gas 8 cut to 1 for time",
              "seq": TRAIN_SEQ, "bytes": row["bytes"],
              "save_s": row["save_s"],
              "save_gb_per_s": gbps(row["bytes"], row["save_s"]),
              "load_s": load_s, "load_gb_per_s": gbps(row["bytes"], load_s),
              "load_note": "warm read (the page cache holds the tag)",
              **{k: row[k] for k in ("blocked_s", "commit_s", "note")
                 if k in row},
              "losses_before_save": before,
              "losses_uninterrupted": after, "losses_resumed": got,
              "masters_max_abs_diff": diff, "bit_for_bit": same,
              "launches_resumed": launched,
              "launches_uninterrupted": ref_launches, "expected": want,
              "card": card, "ok": same and launched == want})
        ok = ok and same and launched == want
        del e2
        gc.collect()
        torch.cuda.empty_cache()
        if form != "pickle":        # the pickle tag holds the universal dir
            shutil.rmtree(root / ("pickle" if form == "universal" else form))
    shutil.rmtree(root, ignore_errors=True)
    if not ok:
        fail("ckpt-train: a resumed run differs from the uninterrupted one, "
             "or the launch counts do not show the kernels")
    return {form: {k: v for k, v in row.items() if k != "note"}
            for form, row in saves.items()}


def zero_small_setup(tf_model):
    """The elastic shrink's model, configs and batch: zero-reference's
    2-layer fp32 model under ZeRO-3 at data ZERO_RANKS (``cfg``) and at
    data 1 (``one``, the same global batch)."""
    kw = {"num_layers": ZERO_REF_LAYERS}
    base = {k: v for k, v in ZERO_CFG.items()
            if k not in ("mesh", "step_schedule", "zero_optimization")}
    base = {**base, "bf16": {"enabled": False},
            "zero_optimization": {"stage": 3,
                                  "param_persistence_threshold": 0}}
    model = tf_model.get_model_config(TRAIN_MODEL, **kw)
    rows = ZERO_REF_MICRO * base["gradient_accumulation_steps"] * ZERO_RANKS
    return {"kw": kw, "model": model,
            "cfg": {**base, "mesh": {"data": ZERO_RANKS},
                    "train_micro_batch_size_per_gpu": ZERO_REF_MICRO},
            "one": {**base, "mesh": {"data": 1},
                    "train_micro_batch_size_per_gpu":
                        ZERO_REF_MICRO * ZERO_RANKS},
            "batch": train_batch_of(model.vocab_size, rows, seed=6,
                                    seq=ZERO_REF_SEQ)}


def phase_ckpt_zero3(ds, tf_model, tf, ranks, small, root, card):
    """ZeRO-3 checkpoints of the zero3-train ranks (``zero_rank_ckpt``):
    the gpt2-350m save gathers every slice (host seconds) and is
    converted to universal; the pickle and the universal each resume at
    data 2 bit for bit (losses and every rank's master slices) with the
    zero3-train launches.  The 2-layer fp32 universal saved at data 2
    resumes at data 1 on the card and on the CPU, held to each other and
    to the ranks' data-2 continuation as zero-reference holds its
    configs."""
    import shutil

    import numpy as np
    import torch

    from deepspeed_tpu_torch.checkpoint import universal as cu

    model = tf_model.get_model_config(TRAIN_MODEL, num_layers=ZERO_LAYERS)
    gas = ZERO_CFG["gradient_accumulation_steps"]
    per = model.num_layers * gas
    steps = CKPT_ZERO_STEPS
    got = [r["ckpt"] for r in ranks]
    want = {**{k: 0 for k in got[0]["launches_after"]},
            "gather_matmul": 6 * per * steps, "flash_fwd": per * steps,
            "flash_bwd_dq": per * steps, "flash_bwd_dkv": per * steps,
            "fused_adamw": steps, "gather_matmul.wgmma": 6 * per * steps,
            "flash_fwd.wgmma": per * steps, "flash_bwd_dq.wgmma": per * steps,
            "flash_bwd_dkv.wgmma": per * steps}
    same = all(r["after"] == got[0]["after"]
               and all(f["resumed"] == r["after"] and f["masters_equal"]
                       for f in r["forms"].values()) for r in got)
    launches_ok = all(r["launches_after"] == want
                      and all(f["launches"] == want
                              for f in r["forms"].values()) for r in got)
    pickle_bytes = dir_bytes(root / "zero3" / "mp_rank_00_model_states.pt")
    ok = same and launches_ok and set(got[0]["forms"]) == set(CKPT_ZERO_FORMS)
    emit({"phase": "ckpt-zero3", "model": TRAIN_MODEL,
          "layers": model.num_layers, "dtype": "bfloat16 over fp32 masters",
          "zero_stage": 3, "fused_gather_matmul": True, "ranks": ZERO_RANKS,
          "backend": ZERO_BACKEND, "seq": TRAIN_SEQ,
          "micro_per_rank": ZERO_CFG["train_micro_batch_size_per_gpu"],
          "gas": gas, "where": "the zero3-train ranks, after their "
                               "profiled step",
          "steps_each_side": steps, "bytes": pickle_bytes,
          "universal_bytes": dir_bytes(root / "zero3" / "universal"),
          "gather_s": [r["gather_s"] for r in got],
          "gather_note": "host seconds of the save's gather (every slice "
                         "all-gathered over gloo, rank 0 keeping numpy); "
                         "save_s includes it",
          "save_s": [r["save_s"] for r in got],
          "convert_s": [r["convert_s"] for r in got],
          "convert_note": "ds_to_universal of the tag: rank 0 reads the "
                          "pickle and writes one .npy a leaf",
          "load_s": {form: [r["forms"][form]["load_s"] for r in got]
                     for form in got[0]["forms"]},
          "state_shard_gb": [r["state_shard_gb"] for r in got],
          "rank_wall_s": [r["wall_s"] for r in got],
          "losses_uninterrupted": [r["after"] for r in got],
          "losses_resumed_data2": {form: [r["forms"][form]["resumed"]
                                          for r in got]
                                   for form in got[0]["forms"]},
          "masters_equal": {form: [r["forms"][form]["masters_equal"]
                                   for r in got] for form in got[0]["forms"]},
          "bit_for_bit": same,
          "launches_resumed": {form: [r["forms"][form]["launches"]
                                      for r in got]
                               for form in got[0]["forms"]},
          "expected": want, "card": card, "ok": ok})
    if not ok:
        fail("ckpt-zero3: a data-2 resume differs from the uninterrupted "
             "run, or the launch counts do not show the kernels")

    # the elastic shrink: the data-2 universal at data 1, card against CPU
    # and both against the ranks' data-2 continuation
    udir = str(root / "small" / "universal")
    engines = {}
    for dev in ("cuda", "cpu"):
        e, *_ = ds.initialize(model=small["model"], config=small["one"],
                              seed=9, device=dev)
        cu.load_universal(e, udir)
        engines[dev] = e
    rows_out, worst = [], 0.0
    for _ in range(ZERO_REF_STEPS):
        lc = float(engines["cuda"].train_batch(small["batch"]))
        lh = float(engines["cpu"].train_batch(small["batch"]))
        gc_ = engines["cuda"].get_global_grad_norm()
        gh = engines["cpu"].get_global_grad_norm()
        rows_out.append({"loss_card": lc, "loss_cpu": lh,
                         "grad_norm_card": gc_, "grad_norm_cpu": gh})
        worst = max(worst, abs(lc - lh) / abs(lh), abs(gc_ - gh) / gh)
    num = den = 0.0
    for a, b in zip(tf.tree_leaves(engines["cuda"].params),
                    tf.tree_leaves(engines["cpu"].params)):
        a, b = a.detach().cpu().double(), b.detach().double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    params_rel = (num / den) ** 0.5
    data2 = [r["small_after_data2"] for r in got]
    vs_data2 = max(abs(row[k] - r[i]) / abs(r[i])
                   for i, row in enumerate(rows_out)
                   for k in ("loss_card", "loss_cpu") for r in data2)
    ok = (worst <= ZERO_REF_RTOL and params_rel <= ZERO_REF_PARAMS_RTOL
          and vs_data2 <= ZERO_REF_RTOL
          and all(np.isfinite([r["loss_card"] for r in rows_out]))
          and engines["cuda"].global_steps == 2 * ZERO_REF_STEPS)
    emit({"phase": "ckpt-zero3-shrink", "model": TRAIN_MODEL,
          "layers": ZERO_REF_LAYERS, "dtype": "float32", "zero_stage": 3,
          "saved_at": {"data": ZERO_RANKS}, "resumed_at": {"data": 1},
          "seq": ZERO_REF_SEQ, "steps": rows_out,
          "losses_data2_continuation": data2,
          "max_rel_err_loss_grad_norm": worst, "params_rel_l2": params_rel,
          "max_rel_err_loss_vs_data2": vs_data2,
          "tolerance": {"loss_grad_norm": ZERO_REF_RTOL,
                        "params_rel_l2": ZERO_REF_PARAMS_RTOL,
                        "loss_vs_data2": ZERO_REF_RTOL},
          "check": "the universal saved by two ranks at data 2, loaded at "
                   "data 1 on the card and on the CPU: card vs CPU, and "
                   "each one's losses vs the ranks' own data-2 "
                   "continuation",
          "card": card, "ok": ok})
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    if not ok:
        fail(f"ckpt-zero3-shrink: the data-1 resume differs from the CPU's "
             f"or from the data-2 continuation ({worst}, {params_rel}, "
             f"{vs_data2})")


def phase_recovery(ds, tf_model, card):
    """RecoverySupervisor runs ``python -m
    deepspeed_tpu_torch.resilience.worker`` on the card: two gloo ranks
    sharing it (hosts h0, h1: data 2), gpt2-350m, RECOVERY_STEPS steps;
    rank 0 dies after step RECOVERY_DIE_AT, before its save: the supervisor
    detects it, dumps a bundle, stops the group, re-plans data 1 (h1 is
    gone) and restarts, and the worker resumes from the last committed
    universal tag.  The unkilled run is the worker's engine and batches
    (``worker.train_config``, ``worker.batch_for``) trained in this process
    at data 1.  Reports the outage seconds (detected to resumed), the steps
    lost and the resumed losses against the unkilled run's."""
    import json as _json
    import shutil

    import torch

    from deepspeed_tpu_torch.resilience import worker
    from deepspeed_tpu_torch.resilience.supervisor import (RecoverySupervisor,
                                                           loss_curve,
                                                           read_progress)

    root = CKPT_ROOT / "recovery"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model = tf_model.get_model_config(TRAIN_MODEL,
                                      max_seq_len=max(RECOVERY_SEQ, 16))
    t0 = time.perf_counter()
    eng, *_ = ds.initialize(model=model, seed=7, config=worker.train_config(
        {"data": 1}, RECOVERY_BATCH, 2))
    ref_curve = {step + 1: float(eng.train_batch(worker.batch_for(
        step, model.vocab_size, RECOVERY_BATCH, RECOVERY_SEQ)))
        for step in range(RECOVERY_STEPS)}
    ref_s = time.perf_counter() - t0
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    sentinel = root / ".chaos_fired"
    t0 = time.perf_counter()
    res = RecoverySupervisor(
        str(root), hosts_fn=lambda: ["h0"] if sentinel.exists() else ["h0", "h1"],
        total_steps=RECOVERY_STEPS, deadline_s=300.0, poll_s=0.2,
        stop_timeout_s=10.0, resume_deadline_s=600.0,
        worker_env={"PYTHONPATH": str(ROOT), "DSTPU_MODEL": TRAIN_MODEL,
                    "DSTPU_SEQ": str(RECOVERY_SEQ),
                    "DSTPU_BATCH": str(RECOVERY_BATCH),
                    "DSTPU_BACKEND": "gloo",
                    "DSTPU_CHAOS": _json.dumps({"die_at": RECOVERY_DIE_AT})}
    ).run()
    run_s = time.perf_counter() - t0
    curve = loss_curve(res.progress_path)
    rows = read_progress(res.progress_path)
    died_after = max(r["step"] for r in rows if r["incarnation"] == 0)
    resumed_from = min(r["step"] for r in rows if r["incarnation"] == 1) - 1
    # the step each restarted rank's engine began at: the resumed tag's
    # (a worker that found no committed tag starts over at 0)
    start_steps = sorted({r["start_step"] for r in rows
                          if r["incarnation"] == 1})
    steps = list(range(1, RECOVERY_STEPS + 1))
    diffs = [abs(curve[s] - ref_curve[s]) for s in steps if s in curve]
    ok = (res.returncode == 0 and res.recoveries == 1
          and res.mesh == {"data": 1} and sorted(curve) == steps
          and died_after == RECOVERY_DIE_AT
          and resumed_from == RECOVERY_DIE_AT - 1
          and start_steps == [RECOVERY_DIE_AT - 1]
          and died_after - resumed_from == 1
          and len(diffs) == len(steps) and max(diffs) <= RECOVERY_LOSS_ATOL)
    emit({"phase": "recovery", "model": TRAIN_MODEL, "dtype": "float32",
          "seq": RECOVERY_SEQ, "global_batch": RECOVERY_BATCH,
          "zero_stage": 2, "backend": "gloo",
          "worker": "python -m deepspeed_tpu_torch.resilience.worker",
          "mesh_before": {"data": 2}, "mesh_after": res.mesh,
          "chaos": {"die_at": RECOVERY_DIE_AT, "rank": 0},
          "outage_s": [o["outage_s"] for o in res.outages],
          "outage_note": "supervisor clock from detected to the first "
                         "progress line of the restarted group",
          "steps_lost": died_after - resumed_from,
          "died_after_step": died_after, "resumed_from_step": resumed_from,
          "restart_start_steps": start_steps,
          "losses_unkilled": [ref_curve[s] for s in steps],
          "unkilled_note": "the worker's engine and batches in this "
                           "process at data 1, no save",
          "losses_recovered": [curve.get(s) for s in steps],
          "max_abs_diff": max(diffs) if diffs else None,
          "tolerance_abs": RECOVERY_LOSS_ATOL,
          "states": [e.state for e in res.events],
          "unkilled_run_s": ref_s, "recovered_run_s": run_s,
          "card": card, "ok": ok})
    shutil.rmtree(root, ignore_errors=True)
    if not ok:
        fail("recovery: the supervised run did not recover once onto data "
             "1 from the tag of the step before the death, or its losses "
             "left the unkilled run's")


# ----------------------------------------------------------------------
# phases 26-28: the data axis's quantized gradient reduction (slice 19)
# ----------------------------------------------------------------------
def dpq_padded(tf_model, world, multiple):
    """gpt2-350m's gradient count padded as the path pads it (to a
    multiple of ``multiple``), and the chunk a rank quantizes."""
    model = tf_model.get_model_config(TRAIN_MODEL)
    h, v, f, nl = (model.hidden_size, model.vocab_size,
                   model.intermediate_size, model.num_layers)
    # gpt2: wte, wpe, final LayerNorm; a layer's attention (qkv and out,
    # with biases), MLP (with biases) and two LayerNorms
    n = v * h + model.max_seq_len * h + 2 * h + nl * (
        4 * h * h + 4 * h + 2 * h * f + f + h + 4 * h)
    padded = -(-n // multiple) * multiple
    return n, padded, padded // world


def dpq_kernel_case(qk, name, x, group, iters):
    """quantize and dequantize of the fp32 [world, m] ``x`` in groups of
    ``group`` against their plain versions, bit for bit, timed (CUDA
    graph) beside the plain versions, with the bytes bound."""
    import torch

    q, s = qk.quantize(x, 8, group)
    d = qk.dequantize(q, s, torch.float32)
    torch.cuda.synchronize()
    q_r, s_r = qk.quantize_ref(x, 8, group)
    d_r = qk.dequantize_ref(q, s, torch.float32)
    n = x.numel()
    s_bytes = s.numel() * 4
    work = {"quantize": ((q, q_r), (s, s_r), 4 * n + n + s_bytes, 5 * n,
                         lambda: qk.quantize(x, 8, group),
                         lambda: qk.quantize_ref(x, 8, group)),
            "dequantize": ((d, d_r), (d, d_r), n + s_bytes + 4 * n, n,
                           lambda: qk.dequantize(q, s, torch.float32),
                           lambda: qk.dequantize_ref(q, s, torch.float32))}
    rows = {}
    for kname, ((a, a_r), (b, b_r), nbytes, ops, fn, ref) in work.items():
        equal = torch.equal(a, a_r) and torch.equal(b, b_r)
        err = max(float((a.float() - a_r.float()).abs().max()),
                  float((b.float() - b_r.float()).abs().max()))
        row = {"phase": "dp-quant-kernels", "kernel": kname, "case": name,
               "shape": list(x.shape), "dtype": "float32", "group": group,
               "bits": 8, "bitwise_equal": equal, "max_abs_err": err,
               "tolerance": "bit for bit"}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, FP32_FLOPS)
        row.update(ms=cuda_time_ms(fn, iters, warmup=1),
                   stream_ms=stream_time_ms(fn, iters, warmup=1),
                   plain_ms=cuda_time_ms(ref, iters=2, warmup=1),
                   bound_bytes=nbytes, library_ms=None,
                   library_note="no single PyTorch call computes per-group "
                                "absmax quantization")
        rows[kname] = row
        emit(row)
        if not equal:
            fail(f"dp-quant-kernels: {kname} differs from its plain version "
                 f"({name}): {err}")
    return rows


def phase_dp_quant_kernels(qk, tf_model):
    """Phase 26: the path's shapes (see the module docstring).  Returns
    the grad_reduce case's rows, for the kernels line."""
    import torch

    _n, _padded, m = dpq_padded(tf_model, DPQ_RANKS, DPQ_RANKS * 256)
    _n, _padded, m_q = dpq_padded(tf_model, DPQ_RANKS, DPQ_RANKS * 8)
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn((DPQ_RANKS, m), generator=gen, device="cuda") * 1e-3
    x[:, :256] = 0.0                       # an all-zero group: scale 1.0
    rows = dpq_kernel_case(qk, "grad_reduce chunks, group 256", x, 256, 10)
    if m_q != m:
        x = torch.randn((DPQ_RANKS, m_q), generator=gen, device="cuda") * 1e-3
    group = 2048 if m_q % 2048 == 0 else m_q
    dpq_kernel_case(qk, "qgZ chunks, group " + ("2048" if group == 2048 else
                    "the whole chunk (2048 does not divide it)"), x, group, 2)
    del x
    torch.cuda.empty_cache()
    return rows


def dpq_rank_reference(rank, world, model_kw, params, configs, batch, steps,
                       device=None, threads=None):
    """One rank of the dp-quant-reference phase: per config, the fp32
    engine over ``{"data": world}`` from ``params``, ``steps`` steps:
    losses, the modes
    its gates chose, launch counts (on the card) and, on rank 0, the
    params after the steps."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 2) // world))
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    counters = _zero_counters()
    model = registry.get_model_config(TRAIN_MODEL, **model_kw)
    out = {}
    for name, cfg in configs.items():
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=params, device=device)
        zero_counts(*counters)
        losses = [float(eng.train_batch(batch)) for _ in range(steps)]
        out[name] = {
            "losses": losses,
            "launches": {k: v for c in counters for k, v in c.items()},
            "modes": {"comm_quant": eng._comm_quant is not None,
                      "onebit": eng._onebit_variant,
                      "decomposed": eng._decomposed,
                      "fused_rs": eng._fused_rs},
            "params": tf.tree_map_with_path(
                lambda _p, a: a.detach().cpu().clone(), eng.params)
            if rank == 0 else None}
        del eng
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def dpq_reference_readings(tf, params, name, got, want):
    """A dp-quant-reference config's readings from the ranks' results
    (``dpq_rank_reference``) under test (``got``) and of the CPU
    (``want``), from the initial ``params``: the worst loss's relative
    error, the params' distance over the update's L2 norm on the held
    leaves and on the whole tree, the config's bound on the held leaves,
    and whether it is a 1-bit optimizer (the held leaves then the layers'
    but the key bias: see DPQ_REF_ONEBIT_RTOL)."""
    worst = max(abs(a - b) / abs(b) for g, w in zip(got, want)
                for a, b in zip(g["losses"], w["losses"]))
    onebit = got[0]["modes"]["onebit"] not in (None, "qgz")
    paths = []
    tf.tree_map_with_path(lambda p, _x: paths.append(p), params)

    def distance(held):
        num = den = 0.0
        for path, (a, b, p0) in zip(paths, zip(
                tf.tree_leaves(got[0]["params"]),
                tf.tree_leaves(want[0]["params"]), tf.tree_leaves(params))):
            if held(path):
                a, b, p0 = a.double(), b.double(), p0.double()
                num += float(((a - b) ** 2).sum())
                den += float(((b - p0) ** 2).sum())
        return (num / den) ** 0.5

    whole_rel = distance(lambda _p: True)
    update_rel = distance(lambda p: p[0] == "layers" and p[-1] != "bk") \
        if onebit else whole_rel
    bound = DPQ_REF_ONEBIT_RTOL if onebit else DPQ_REF_UPDATE_RTOL.get(
        name, DPQ_REF_UPDATE_RTOL_DEFAULT)
    return worst, update_rel, whole_rel, bound, onebit


def dpq_reference_setup(tf_model, tf):
    """The dp-quant-reference phase's inputs: ``(model_kw, configs,
    params, batch)`` (DPQ_REF_CONFIGS over the fp32 base config)."""
    model_kw = {"num_layers": ZERO_REF_LAYERS}
    model = tf_model.get_model_config(TRAIN_MODEL, **model_kw)
    base = {**{k: v for k, v in DPQ_CFG.items() if k != "zero_optimization"},
            "bf16": {"enabled": False},
            "train_micro_batch_size_per_gpu": DPQ_REF_MICRO}
    configs = {}
    for name, extra in DPQ_REF_CONFIGS.items():
        configs[name] = {**base, **{k: v for k, v in extra.items()
                                    if k != "zero_optimization"},
                         "zero_optimization": extra.get(
                             "zero_optimization", {"stage": 1})}
    params = tf.init_params(model, seed=3, device="cpu")
    rows = DPQ_REF_MICRO * DPQ_CFG["gradient_accumulation_steps"] * DPQ_RANKS
    batch = train_batch_of(model.vocab_size, rows, seed=7, seq=DPQ_REF_SEQ)
    batch["labels"][0, :5] = -100          # the ranks' token counts differ
    return model_kw, configs, params, batch


def phase_dp_quant_reference(ds, tf_model, tf, launch):
    """Phase 27: DPQ_REF_CONFIGS in two ranks on the card against two ranks
    on the CPU (the CPU ranks in a thread beside the card ranks), from one
    set of params and one global batch: per config the losses to
    DPQ_REF_RTOL, the params after the steps within the update bound,
    the same modes on both sides, and each card rank's launches (the
    quantize/dequantize counts of the mode, every flash kernel's, AdamW
    but for the 1-bit and qgZ steps)."""
    import numpy as np
    import torch

    gas = DPQ_CFG["gradient_accumulation_steps"]
    model_kw, configs, params, batch = dpq_reference_setup(tf_model, tf)
    names = list(configs)
    parts = [{n: configs[n] for n in names[i::DPQ_REF_CPU_LAUNCHES]}
             for i in range(DPQ_REF_CPU_LAUNCHES)]
    threads = max(1, (os.cpu_count() or 2) // (DPQ_RANKS * len(parts)))
    with ThreadPoolExecutor(len(parts)) as pool:
        cpu_runs = [pool.submit(launch, dpq_rank_reference, DPQ_RANKS,
                                args=(model_kw, params, part, batch,
                                      DPQ_REF_STEPS, "cpu", threads),
                                backend=DPQ_BACKEND, device="cpu")
                    for part in parts]
        card = launch(dpq_rank_reference, DPQ_RANKS,
                      args=(model_kw, params, configs, batch,
                            DPQ_REF_STEPS),
                      backend=DPQ_BACKEND, device="cuda")
        cpu = [{} for _ in range(DPQ_RANKS)]
        for run in cpu_runs:
            for rank, out in enumerate(run.result()):
                cpu[rank].update(out)
    for name in DPQ_REF_CONFIGS:
        n_steps = DPQ_REF_STEPS
        per = n_steps * gas * ZERO_REF_LAYERS
        got, want = [r[name] for r in card], [r[name] for r in cpu]
        worst, update_rel, whole_rel, bound, onebit = dpq_reference_readings(
            tf, params, name, got, want)
        modes = got[0]["modes"]
        quant = {"int8-ef": (2, 3), "int8-no-ef": (2, 2),
                 "qgz": (1, 1)}.get(name, (0, 0))
        own_step = modes["onebit"] is None
        wants = [{**{k: 0 for k in g["launches"]},
                  "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                  "fused_adamw": n_steps if own_step else 0,
                  "quantize": quant[0] * n_steps,
                  "dequantize": quant[1] * n_steps} for g in got]
        launches = [g["launches"] for g in got]
        whole_bound = DPQ_REF_ONEBIT_WHOLE_RTOL if onebit else bound
        ok = (worst <= DPQ_REF_RTOL and update_rel <= bound
              and whole_rel <= whole_bound and launches == wants
              and all(g["modes"] == want[0]["modes"] for g in got + want)
              and all(np.isfinite(g["losses"]).all() for g in got))
        emit({"phase": "dp-quant-reference", "config": name,
              "extra": DPQ_REF_CONFIGS[name], "modes": modes,
              "model": TRAIN_MODEL, "layers": ZERO_REF_LAYERS,
              "dtype": "float32", "ranks": DPQ_RANKS, "backend": DPQ_BACKEND,
              "seq": DPQ_REF_SEQ, "micro_per_rank": DPQ_REF_MICRO, "gas": gas,
              "losses_card": [g["losses"] for g in got],
              "losses_cpu": [w["losses"] for w in want],
              "check": "two ranks on the card (kernels, cuBLAS) vs two ranks "
                       "on the CPU (plain versions), one config each",
              "max_rel_err_loss": worst,
              "params_distance_over_update_l2": update_rel,
              "params_held": "the layers but the key bias" if onebit
              else "every leaf",
              "whole_tree_distance_over_update_l2": whole_rel,
              "tolerance": {"loss": DPQ_REF_RTOL, "params": bound,
                            "whole_tree": whole_bound},
              "launches_per_rank": launches, "expected_per_rank": wants,
              "ok": bool(ok)})
        if not ok:
            fail(f"dp-quant-reference ({name}): the card's ranks differ from "
                 f"the CPU's ({worst}, {update_rel}), chose other modes, or "
                 f"launched {launches}, expected {wants}")
    del card, cpu, params
    torch.cuda.empty_cache()


def dpq_rank_train(rank, world, runs, seq, steps):
    """One rank of the dp-quant-train phase: per run (name -> config), a
    warm-up step, ``steps`` timed steps (counts and wire bytes zeroed just
    before them and read just after), then one step profiled on rank 0
    (its partner steps beside it)."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry

    counters = _zero_counters() + _route_counters()
    model = registry.get_model_config(TRAIN_MODEL)
    out = {}
    for name, cfg in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng, *_ = ds.initialize(model=model, config=cfg, seed=0)
        rows = (cfg["train_micro_batch_size_per_gpu"]
                * cfg["gradient_accumulation_steps"] * world)
        batch = train_batch_of(model.vocab_size, rows, seed=0, seq=seq)
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(batch))]      # warm-up
        warm_s = time.perf_counter() - t0
        zero_counts(*counters)
        comm.clear_counts()
        step_s = []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(batch)))   # float() syncs
            step_s.append(time.perf_counter() - t0)
        launches = {k: v / steps for c in counters[:-2] for k, v in c.items()}
        routes = {k: v / steps for c in counters[-2:] for k, v in c.items()}
        nbytes = {k: v / steps for k, v in comm.nbytes().items()}
        calls = {k: v / steps for k, v in comm.calls().items()}
        res = {"init_and_warmup_s": warm_s, "step_s": step_s,
               "losses": losses, "launches_per_step": launches,
               "routes_per_step": routes, "bytes_per_step": nbytes,
               "collective_calls_per_step": calls,
               "modes": {"comm_quant": eng._comm_quant is not None,
                         "onebit": eng._onebit_variant,
                         "residual": getattr(eng, "_quant_residual", None)
                         is not None},
               "quant_flat_numel": None if eng._quant_flat is None
               else eng._quant_flat.numel(),
               "finite": bool(np.all(np.isfinite(losses)))}
        if rank == 0:
            wall_ms, by_name, busy_ms, events = profile_call(
                lambda: eng.train_batch(batch))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            res["profile"] = {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
                "collectives": comm_ms(events, names=(
                    "comm.all_to_all", "comm.all_gather", "comm.all_reduce")),
                "quantize_ms": sum(v for k, v in by_name.items()
                                   if "quant_kernel" in k),
                "dequantize_ms": sum(v for k, v in by_name.items()
                                     if "dequant_kernel" in k),
                "top_kernels_ms": [[k[:90], v] for k, v in top]}
        else:
            eng.train_batch(batch)
        res["max_memory_allocated_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = res
        del eng
    return out


def phase_dp_quant_train(tf_model, launch, card):
    """Phase 28 (see the module docstring): per run the slower rank's step
    seconds, tokens/s for the card, peak memory a rank, the grad-reduce
    wire bytes a step (against the fp32 control's, computed), launches
    a step a rank (every flash kernel layers x gas times on wgmma, AdamW
    once for the engine's own step, quantize/dequantize as
    DPQ_QUANT_LAUNCHES) and rank 0's profile.  Returns the int8 run's
    quantize/dequantize launches a step (rank 0), for the kernels line."""
    import numpy as np

    model = tf_model.get_model_config(TRAIN_MODEL)
    gas = DPQ_CFG["gradient_accumulation_steps"]
    per = model.num_layers * gas
    runs = {name: {**DPQ_CFG, **DPQ_RUNS[name]} for name in DPQ_TRAIN_RUNS}
    ranks = launch(dpq_rank_train, DPQ_RANKS,
                   args=(runs, TRAIN_SEQ, DPQ_STEPS),
                   backend=DPQ_BACKEND, device="cuda")
    rows = DPQ_CFG["train_micro_batch_size_per_gpu"] * gas * DPQ_RANKS
    tokens = rows * TRAIN_SEQ
    wire = {}
    for name in DPQ_TRAIN_RUNS:
        got = [r[name] for r in ranks]
        step_s = [max(g["step_s"][i] for g in got) for i in range(DPQ_STEPS)]
        nb = got[0]["bytes_per_step"]
        wire[name] = sum(nb.get(op, 0) for op in ("quant_reduce_scatter",
                                                  "quant_all_gather"))
        q, dq = DPQ_QUANT_LAUNCHES[name]
        own_step = got[0]["modes"]["onebit"] is None
        want = {**{k: 0 for k in got[0]["launches_per_step"]},
                "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                "fused_adamw": 1 if own_step else 0,
                "quantize": q, "dequantize": dq}
        want_routes = {**{k: 0 for k in got[0]["routes_per_step"]},
                       "flash_fwd.wgmma": per, "flash_bwd_dq.wgmma": per,
                       "flash_bwd_dkv.wgmma": per}
        ok = (all(g["finite"] for g in got)
              and all(g["losses"] == got[0]["losses"] for g in got)
              and all(g["launches_per_step"] == want for g in got)
              and all(g["routes_per_step"] == want_routes for g in got))
        if name in ("int8", "qgz"):
            ok = ok and got[0]["losses"][-1] < got[0]["losses"][0]
        if name == "int8":       # the buffer dp-quant-kernels timed
            ok = ok and got[0]["modes"]["residual"] and \
                got[0]["quant_flat_numel"] == dpq_padded(
                    tf_model, DPQ_RANKS, DPQ_RANKS * 256)[1]
        emit({"phase": "dp-quant-train", "run": name, "model": TRAIN_MODEL,
              "layers": model.num_layers, "dtype": "bfloat16",
              "zero_stage": 1, "extra": DPQ_RUNS[name], "modes":
              got[0]["modes"], "ranks": DPQ_RANKS, "backend": DPQ_BACKEND,
              "seq": TRAIN_SEQ, "micro_per_rank": DPQ_CFG[
                  "train_micro_batch_size_per_gpu"], "gas": gas,
              "remat": "none", "step_s": step_s,
              "init_and_warmup_s": [g["init_and_warmup_s"] for g in got],
              "tokens_per_step": tokens,
              "tokens_per_s": tokens * DPQ_STEPS / sum(step_s),
              "losses": got[0]["losses"],
              "grad_reduce_wire_bytes_per_step": wire[name],
              "bytes_per_step_rank0": nb,
              "collective_calls_per_step_rank0":
                  got[0]["collective_calls_per_step"],
              "max_memory_allocated_gib": [g["max_memory_allocated_gib"]
                                           for g in got],
              "launches_per_step": [g["launches_per_step"] for g in got],
              "expected_per_step": want, "card": card, "ok": bool(ok)})
        prof = got[0]["profile"]
        emit({"phase": "dp-quant-train-profile", "run": name,
              "what": "one train_batch on rank 0 (rank 1 steps beside it)",
              "collectives_note": "host time inside comm.all_to_all (the "
                                  "quantized reduce-scatter's exchange), "
                                  "comm.all_gather (its gather phase; "
                                  "ZeRO-1's stepped slices) and "
                                  "comm.all_reduce; own = less this "
                                  "rank's compute kernels running",
              **prof, "card": card})
        if not ok:
            fail(f"dp-quant-train ({name}): losses not finite, not equal on "
                 "the ranks or not falling, or the launch or route counts "
                 "do not show the kernels")
    # the fp32 control's wire over the same padded buffer: the buffer on
    # the reduce-scatter, a rank's 1/world of it on the all-gather
    padded = dpq_padded(tf_model, DPQ_RANKS, DPQ_RANKS * 256)[1]
    wire["fp32"] = 4 * (padded + padded // DPQ_RANKS)
    ratio = wire["fp32"] / wire["int8"]
    emit({"phase": "dp-quant-wire", "fp32_bytes_per_step": wire["fp32"],
          "fp32_bytes_note": "computed from the padded buffer: the "
                             "control run is cut for time",
          "int8_bytes_per_step": wire["int8"], "reduction": ratio,
          "expected": 4 / (1 + 4 / 256), "card": card,
          "ok": 3.9 <= ratio <= 4.0})
    if not 3.9 <= ratio <= 4.0:
        fail(f"dp-quant-wire: the int8 wire moved {ratio}x fewer bytes than "
             "the fp32 control, expected 3.9-4.0")
    return {k: ranks[0]["int8"]["launches_per_step"][k]
            for k in ("quantize", "dequantize")}


def count_params(model):
    """Parameter count of a llama-class model (untied head, RMSNorm)."""
    h, hd = model.hidden_size, model.dim_per_head
    attn = h * model.num_heads * hd * 2 + 2 * h * model.kv_heads * hd
    layer = attn + 3 * h * model.intermediate_size + 2 * h
    return 2 * model.vocab_size * h + model.num_layers * layer + h


def main() -> int:
    if not (ROOT / "deepspeed_tpu_torch").is_dir():
        print("chip_smoke: the deepspeed_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import serving
    from deepspeed_tpu_torch.inference import v2
    from deepspeed_tpu_torch.models import registry as tf_model
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch import linear as lin
    from deepspeed_tpu_torch.ops import block_sparse_mha as bsm
    from deepspeed_tpu_torch.ops import flash_mha as fm
    from deepspeed_tpu_torch.ops import fp6_linear as t6
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quantize as qk
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    rng = np.random.default_rng(0)
    mc = tf_model.get_model_config(MODEL)
    prompts = [rng.integers(0, mc.vocab_size,
                            size=int(rng.integers(64, 513))).tolist()
               for _ in range(16)]
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if cap != (9, 0):
        fail(f"capability {cap}, the kernels are built for sm_90a")

    # 2. build
    t0 = time.perf_counter()
    op_builder.build_all()
    emit({"phase": "build", "kernels": list(op_builder.KERNEL_SOURCES),
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for name in op_builder.KERNEL_SOURCES
                    for ln in op_builder.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln],
          "spill_store_bytes": {name: ptxas_spills(op_builder.build_log(name))
                                for name in op_builder.KERNEL_SOURCES}})
    # 3. kernels against their plain versions
    bs = ENGINE_CFG["memory_config"]["block_size"]
    summary = phase_kernels(pa, mc, bs,
                            ENGINE_CFG["memory_config"]["num_blocks"])

    # 4. reference, 5. engine, 6. server
    phase_reference(v2, tf_model, tf, pa, prompts)
    eng, launches, ref = phase_engine(pa, tf_model, v2, prompts)
    phase_profile(eng, prompts, smi)
    phase_logits(v2, tf_model, eng.params, prompts)
    phase_server(serving, pa, eng, prompts, ref, smi)
    del eng
    torch.cuda.empty_cache()

    # 7. training kernels, 8. training reference, 9. training
    counters = (fm.flash_mha.launches, bsm.block_sparse_mha.launches,
                fo.fused_adamw.launches, fo.fused_lion.launches)
    layers = tf_model.get_model_config(TRAIN_MODEL).num_layers
    micro_steps = TRAIN_CFG["gradient_accumulation_steps"]
    train_summary = phase_train_kernels(fm, fo, tf_model, tf)
    # 7b. the head-dim lanes' kernels
    phase_head_dim_kernels(fm, bsm, sa)
    ref_steps = 2 * 2 * REF_LAYERS    # 2 steps x gas 2 x layers
    phase_train_reference(
        ds, tf_model, tf, counters, "train-reference", TRAIN_CFG,
        expected(counters, flash_fwd=ref_steps, flash_bwd_dq=ref_steps,
                 flash_bwd_dkv=ref_steps, fused_adamw=2))
    # 8b. phi-2 (head_dim 80: flash_mha pads it to the 128 lane) card vs CPU
    routed = counters + (fm.flash_mha.routes,)
    phase_train_reference(
        ds, tf_model, tf, routed, "train-reference-d80", TRAIN_CFG,
        expected(routed, flash_fwd=ref_steps, flash_bwd_dq=ref_steps,
                 flash_bwd_dkv=ref_steps, fused_adamw=2,
                 **{f"{n}.fma": ref_steps for n in fm.flash_mha.launches}),
        model_name=D80_MODEL, seq=D80_SEQ)
    n = layers * micro_steps
    # every flash launch of the step on the wgmma route
    routed = counters + (fm.flash_mha.routes,)
    train_launches = phase_train(
        ds, tf_model, routed, smi, "train", TRAIN_CFG,
        expected(routed, flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n,
                 fused_adamw=1, **{"flash_fwd.wgmma": n,
                                   "flash_bwd_dq.wgmma": n,
                                   "flash_bwd_dkv.wgmma": n}), remat=True)

    # 10. block-sparse kernels and Lion, 11. their training reference,
    # 12. training with block-sparse attention and Lion
    sparse = {"attn_impl": "sparse", "sparse_attention": SPARSE}
    sparse_summary = phase_sparse_kernels(bsm, fm, sa, fo, tf_model, tf)
    phase_train_reference(
        ds, tf_model, tf, counters, "train-sparse-reference", SPARSE_TRAIN_CFG,
        expected(counters, bsa_fwd=ref_steps, bsa_bwd_dq=ref_steps,
                 bsa_bwd_dkv=ref_steps, fused_lion=2), **sparse)
    # every block-sparse launch of the step on the wgmma walks, none on mma
    routed = counters + (bsm.block_sparse_mha.routes,)
    sparse_launches = phase_train(
        ds, tf_model, routed, smi, "train-sparse", SPARSE_TRAIN_CFG,
        expected(routed, bsa_fwd=n, bsa_bwd_dq=n, bsa_bwd_dkv=n,
                 fused_lion=1, **{"bsa_fwd.wgmma": n, "bsa_bwd_dq.wgmma": n,
                                  "bsa_bwd_dkv.wgmma": n}), **sparse)

    # 14. quantize and FP6 kernels, 15. their training reference,
    # 16. LoRA training over quantized llama3-8b-width bases
    lcount = (qk.launches, t6.fp6_matmul.launches, fo.fused_adamw.launches)
    all_counters = (pa.paged_decode_attention.launches, *counters,
                    qk.launches, t6.fp6_matmul.launches)
    zero_counts(*all_counters)
    linear_summary = phase_linear_kernels(qk, t6)
    fake_phase_launches = qk.launches["fake_quantize"]
    # the FP6 GEMM's launches by route beside the totals
    routed = all_counters + (t6.fp6_matmul.routes,)
    phase_linear_reference(ds, lin, lcount, routed)
    built6, fp6_launches = phase_linear_train(ds, lin, routed, smi, 6)
    built8, int8_launches = phase_linear_train(ds, lin, routed, smi, 8)

    # 17. ring kernels, 18. ring reference (two ranks on the card against
    # the CPU), 19. ring training at llama3-8b width over two ranks.  The
    # kernels are built above, before any rank starts (two ranks building
    # at once would race), and this process frees its cache so that two
    # ranks of ~30 GB fit beside it.
    # 19b-d (slice 13): the int8 K/V lanes of the hop kernels, the ring
    # reference with the int8 and fp8 wires (card ranks against CPU ranks),
    # and the ring training step with the int8 wire
    from deepspeed_tpu_torch.comm import quantized as codec
    from deepspeed_tpu_torch.launcher import launch

    # the ring-reference phases' CPU ranks start now and run beside the
    # kernel phases, whose times are the card's (CUDA graphs)
    ring_pool = ThreadPoolExecutor(1)
    ring_ref = ring_reference_start(ds, tf_model, tf, launch, ring_pool)
    ring_summary = phase_ring_kernels(fm)
    ring_summary.update(phase_ring_int8_kernels(fm, codec))
    # FPDT's chunked attention on the hop kernels, one card
    fpdt_launches = phase_fpdt_kernel(fm, smi)
    ref_card, ref_cpu = phase_ring_reference(ds, tf_model, tf, launch,
                                             ring_ref)
    ring_pool.shutdown()
    del ring_ref
    phase_ring_reference_wire(tf, ref_card, ref_cpu)
    del ref_card, ref_cpu
    # 18b (slice 17): ZeRO over data x seq, four ranks on the card
    mesh_launches = phase_mesh_reference(ds, tf_model, tf, launch)
    gc.collect()     # engines of earlier phases left in reference cycles
    torch.cuda.empty_cache()
    emit({"phase": "ring-parent-memory",
          "memory_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
    ring_run, int8_run, ulysses_run = phase_ring_trains(tf_model, launch, smi)
    ring_train_launches = {
        **{k: ring_run[k] for k in ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")},
        **{f"{k}_int8": int8_run[f"{k}.{r}"] for k, r in RING_INT8_ROUTES.items()}}

    # 20. the gather-matmul GEMM, 21. ZeRO stages in two ranks on the card
    # against the CPU, 22. gpt2-350m under ZeRO-3 with the fused
    # gather-matmul over two ranks
    from deepspeed_tpu_torch.ops import gather_matmul as tgm

    gemm_summary = phase_gemm_kernels(tgm)
    phase_zero_reference(ds, tf_model, tf, launch)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "zero-parent-memory",
          "memory_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
    # 23. checkpoints of ZeRO-3 over the zero3-train ranks (and the elastic
    # shrink to data 1), 24. of the dense step, 25. the recovery loop on
    # the card
    import shutil

    zero_root = CKPT_ROOT / "zero3"
    shutil.rmtree(zero_root, ignore_errors=True)
    zero_root.mkdir(parents=True)
    small = zero_small_setup(tf_model)
    zero_train_launches, zero_ranks = phase_zero_train(
        tf_model, launch, smi, {"root": str(zero_root),
                                "small_cfg": small["cfg"],
                                "small_batch": small["batch"],
                                "small_kw": small["kw"]})
    phase_ckpt_zero3(ds, tf_model, tf, zero_ranks, small, zero_root, smi)
    del zero_ranks
    # 24b-c: hierarchical ZeRO++ (hpZ, MiCS, two-level qgZ)
    # over four ranks sharing the card, against CPU ranks, then trained
    gc.collect()
    torch.cuda.empty_cache()
    zpp_launches = phase_zeropp(tf_model, tf, launch, smi)
    ckpt_n = CKPT_LAYERS * CKPT_CFG["gradient_accumulation_steps"] * \
        CKPT_STEPS
    routed = counters + (fm.flash_mha.routes,)
    phase_ckpt_train(ds, tf_model, tf, routed, expected(
        routed, flash_fwd=ckpt_n, flash_bwd_dq=ckpt_n, flash_bwd_dkv=ckpt_n,
        fused_adamw=CKPT_STEPS, **{"flash_fwd.wgmma": ckpt_n,
                                   "flash_bwd_dq.wgmma": ckpt_n,
                                   "flash_bwd_dkv.wgmma": ckpt_n}), smi)
    phase_recovery(ds, tf_model, smi)

    # 26. quantize/dequantize at the data axis's reduction shapes, 27. the
    # reduction modes in two ranks on the card against two on the CPU, 28.
    # gpt2-350m's commquant step and its control, qgZ and OnebitAdam
    gc.collect()
    torch.cuda.empty_cache()
    dp_rows = phase_dp_quant_kernels(qk, tf_model)
    phase_dp_quant_reference(ds, tf_model, tf, launch)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "dp-quant-parent-memory",
          "memory_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
    dp_launches = phase_dp_quant_train(tf_model, launch, smi)

    # 20. kernels line: each path's launches from its own run
    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/pallas/"
    sources = {"paged_attention": csrc + "paged_attention.cu",
               "paged_attention_int8": csrc + "paged_attention.cu",
               "flash_fwd": csrc + "flash_attention.cu",
               "flash_bwd_dq": csrc + "flash_attention.cu",
               "flash_bwd_dkv": csrc + "flash_attention.cu",
               "fused_adamw": csrc + "fused_adamw.cu",
               "bsa_fwd": csrc + "block_sparse_attention.cu",
               "bsa_bwd_dq": csrc + "block_sparse_attention.cu",
               "bsa_bwd_dkv": csrc + "block_sparse_attention.cu",
               "fused_lion": csrc + "fused_lion.cu",
               "quantize": csrc + "quantize.cu",
               "dequantize": csrc + "quantize.cu",
               "fake_quantize": csrc + "quantize.cu",
               "fp6_matmul": csrc + "fp6_linear.cu",
               "ring_carry": csrc + "ring_attention.cu",
               "ring_bwd_dq": csrc + "ring_attention.cu",
               "ring_bwd_dkv": csrc + "ring_attention.cu",
               "ring_carry_int8": csrc + "ring_attention_int8.cu",
               "ring_bwd_dq_int8": csrc + "ring_attention_int8.cu",
               "ring_bwd_dkv_int8": csrc + "ring_attention_int8.cu",
               "gather_matmul": csrc + "gather_matmul.cu"}
    replaces = {"paged_attention": pallas + "paged_attention.py:52",
                "paged_attention_int8": pallas + "paged_attention.py:129",
                "flash_fwd": pallas + "flash_mha.py:147",
                "flash_bwd_dq": pallas + "flash_mha.py:172",
                "flash_bwd_dkv": pallas + "flash_mha.py:192",
                "fused_adamw": pallas + "fused_optimizer.py:77",
                "bsa_fwd": pallas + "block_sparse_mha.py:119",
                "bsa_bwd_dq": pallas + "block_sparse_mha.py:171",
                "bsa_bwd_dkv": pallas + "block_sparse_mha.py:211",
                "fused_lion": pallas + "fused_optimizer.py:133",
                "quantize": pallas + "quantize.py:78",
                "dequantize": pallas + "quantize.py:125",
                "fake_quantize": pallas + "quantize.py:158",
                "fp6_matmul": pallas + "fp6_linear.py:132",
                "ring_carry": pallas + "flash_mha.py:471",
                "ring_bwd_dq": pallas + "flash_mha.py:699",
                "ring_bwd_dkv": pallas + "flash_mha.py:765",
                "ring_carry_int8": pallas + "flash_mha.py:471",
                "ring_bwd_dq_int8": pallas + "flash_mha.py:699",
                "ring_bwd_dkv_int8": pallas + "flash_mha.py:765",
                "gather_matmul": pallas + "gather_matmul.py:133"}
    also = {"flash_fwd": pallas + "flash_mha.py:286",
            "flash_bwd_dq": pallas + "flash_mha.py:346",
            "flash_bwd_dkv": pallas + "flash_mha.py:390"}
    # the kernels the int8 lanes run on the path: the wgmma walks' int8
    # kernels (slices 14-15)
    walks = {"ring_carry_int8": csrc + "attention_wgmma.cuh attn_fwd_wgmma_s8_kernel",
             "ring_bwd_dq_int8": csrc + "attention_wgmma_bwd.cuh "
                                        "attn_bwd_dq_wgmma_s8_kernel",
             "ring_bwd_dkv_int8": csrc + "attention_wgmma_bwd.cuh "
                                         "attn_bwd_dkv_wgmma_s8_kernel"}
    # the quantized lanes of the ring kernels (wire_dequant_rows, :460)
    lanes = {"ring_carry_int8": pallas + "flash_mha.py:505",
             "ring_bwd_dq_int8": pallas + "flash_mha.py:729",
             "ring_bwd_dkv_int8": pallas + "flash_mha.py:795"}
    launch_run = {"paged_attention": launches["bf16"]["paged_attention"],
                  "paged_attention_int8":
                  launches["int8"]["paged_attention_int8"],
                  **{k: train_launches[k] for k in train_summary},
                  **{k: sparse_launches[k] for k in sparse_summary},
                  "quantize": built8["quantize"],
                  "dequantize": int8_launches["dequantize"],
                  "fake_quantize": fake_phase_launches,
                  "fp6_matmul": fp6_launches["fp6_matmul"],
                  **ring_train_launches, **zero_train_launches}
    notes = {"quantize": "at construction of the q_bits 8 LoRAStack (one a "
                         "base); a train_batch launches none",
             "fake_quantize": "the linear-kernels phase's launches: the "
                              "training path does not run fake_quantize "
                              "(ops.quantizer.fake_quantize, the QAT op)",
             **{k: f"rank 0 of {RING_RANKS} in the ring-train phase's "
                   f"{RING_STEPS} timed steps (each rank launched as many); "
                   f"times from the {RING_ROW_CASE} case"
                for k in ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")},
             **{f"{k}_int8": f"rank 0 of {RING_RANKS} in the ring-train-int8 "
                             f"phase's {RING_WIRE_STEPS} timed steps, the visiting "
                             f"hops' {r} launches (each rank launched as many); "
                             f"times from the {RING_INT8_ROW_CASE} case"
                for k, r in RING_INT8_ROUTES.items()},
             "gather_matmul": f"rank 0 of {ZERO_RANKS} in the zero3-train "
                              f"phase's {ZERO_STEPS} timed steps (each rank "
                              f"launched as many); times from the "
                              f"{GEMM_ROW_CASE} case"}
    merges = {"paged_attention": launches["bf16_merges"]["paged_attention"],
              "paged_attention_int8":
              launches["int8_merges"]["paged_attention_int8"]}
    emit({"phase": "timing", "method": "CUDA graph (cuda_time_ms)",
          "stream_timed": STREAM_TIMED})
    entries = []
    for name, row in {**summary, **train_summary, **sparse_summary,
                      **linear_summary, **ring_summary,
                      **gemm_summary}.items():
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name], "launches": launch_run[name],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                 "stream_ms": row["stream_ms"]}
        if name in merges:     # the paged kernel's merge kernel, same run
            entry["merge_launches"] = merges[name]
        if "route" in row:     # which of the kernel's routes the row timed
            entry["kernel_route"] = row["route"]
        if "splits" in row:    # the paged kernel's blocks a (token, KV head)
            entry["splits"] = row["splits"]
        if name in also:
            entry["also_replaces"] = also[name]
        if name in lanes:
            entry["replaces_lane"] = lanes[name]
            entry["walk"] = walks[name]
        if "mma_s8_ms" in row:     # the lane before, same inputs, same call
            entry["mma_s8_ms"] = row["mma_s8_ms"]
            entry["mma_s8_stream_ms"] = row["mma_s8_stream_ms"]
        if name in notes:
            entry["launches_note"] = notes[name]
        if name in dp_rows:      # the data axis's gradient reduction (slice 19)
            row = dp_rows[name]
            entry["dp_path"] = {k: row[k] for k in (
                "case", "shape", "group", "ms", "stream_ms", "plain_ms",
                "bound_ms", "bound_by", "max_abs_err")}
            entry["launches_dp_quant_train"] = dp_launches[name]
            entry["launches_dp_quant_train_note"] = (
                f"a step, rank 0 of {DPQ_RANKS} in dp-quant-train's int8 run "
                f"(error feedback), the mean of its {DPQ_STEPS} timed steps")
        zpp = {run: counts[name] for run, counts in zpp_launches.items()
               if name in counts}
        if zpp:     # a step, rank 0 of zeropp-train's four, by run
            entry["launches_zeropp_train"] = zpp
        if name in ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv"):
            # FPDT's chunk pairs (fpdt-kernel, one card)
            entry["launches_fpdt_kernel"] = fpdt_launches[name]
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "fused_adamw"):
            # a step, rank 0 of ulysses-train's two (Ulysses' local attention)
            entry["launches_ulysses_train"] = ulysses_run[name]
        if name in ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv",
                    "fused_adamw"):
            # rank 0 of the mesh-reference phase's four, by ZeRO stage
            entry["launches_mesh_reference"] = {
                st: counts[name] for st, counts in mesh_launches.items()}
        entries.append(entry)
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
