#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card at every
   shape the live step, prefill, a decode step, phases 6b and 6c and the
   kernel bench give it (``stream_matmul``'s expert-batched form at the MoE
   pair's capacities with the rows of a dispatch, beside ``torch.bmm``; and
   at the reference's test shapes; ``stream_matmul``'s
   K-major form, the tied LM head, also at M = 1, 4096 and 4352 of
   minicpm-2b's table; ``stream_matmul_int8`` also at the
   projections of paper-llama3-8b, the model it was written for, at M = 1,
   4 and 4096; ``paged_attention`` also at the edges of its split rule;
   both attention kernels also at head dim 256, recurrentgemma-9b's), and
   times kernel, plain version and one library call (a yardstick only: the
   port never calls it), weighted by each path's calls a step; logs each
   shape's route (``stream_matmul``: gemv / wgmma / narrow / simt,
   ``stream_matmul_int8``: gemv / wgmma / simt, ``flash_attention``: wgmma /
   simt), read from the wrapper's ``wgmma_launches`` (and
   ``stream_matmul.narrow_launches``) and held against the route rule, its share of the
   bound, its ratio to the library call and its registers and spills from
   ``-Xptxas -v``; profiles one gemv call whose K is split and one decode
   expert call (one kernel each, the expert grid spanning the bound on the
   experts hit, not E); gates the prefill, live and decode paths'
   ``stream_matmul`` sums, each
   ``flash_attention`` call of FA_LIBRARY_GATED (the dense prefills,
   hubert-xlarge's forward at D = 80 and recurrentgemma-9b's prefill at D =
   256), each dense decode ``paged_attention`` call and the int8 kernel's M
   = 4096 sum at MAX_LIBRARY_RATIO times the library's (for int8,
   ``torch.matmul`` with bf16 weights);
4. runs qwen3-1.7b and mamba2-1.3b at full width (2 layers) through the
   kernels and holds their logits against the plain versions of the same
   weights on the CPU, for ``forward`` and for prefill + decode, and holds
   decode against ``forward`` over the same tokens;
5. serves qwen3-1.7b + llama3.2-3b + mamba2-1.3b (the reference's live set) at
   their published widths and depths under 150% oversubscription through
   ``MultiModelServer`` with 2 MiB pages: every migration is a pinned-host <->
   HBM copy. It checks that every request is served, that bytes moved both
   ways, that each step launched exactly its ``stream_matmul`` and
   ``flash_attention`` kernels and no other, and that the steps' logits are
   bit-identical to the same steps run all-resident; no call of this path
   takes a tensor-core route;
6. runs the decode path of the three models at their published widths and
   depths: 4 prompts of 1024 tokens through ``make_prefill_step``, then 64
   greedy steps through ``make_serve_step``. It checks the launches of
   prefill and of every step (every M = 4096 projection and every attention
   of a prefill on the wgmma route, none of a decode step), that the logits
   are finite, and that they agree with one ``forward`` over the same 1088
   tokens;
6b. runs the attention families that the live set leaves out, each at its
   published width and depth: minicpm-2b (tied embeddings: the LM head reads
   the embedding table through ``stream_matmul``'s K-major form) and
   qwen2-vl-7b (M-RoPE, QKV bias, g = 7; 1/8 of each prompt vision
   embeddings) prefill 4 x 1024 positions and decode 64 greedy steps, gated
   against one ``forward`` over the same positions; hubert-xlarge (the
   bidirectional encoder, D = 80) runs ``forward`` over 4 x 1024 masked
   frames. Launches are gated exactly (the tied head on the K-major wgmma
   route in ``forward`` and on the K-major gemv at prefill and decode;
   hubert's attention on the wgmma route at D = 80), and first each of the three runs
   at 2 layers against the CPU on the same weights;
6c. runs the MoE family at published width, its depth cut to fit the card:
   grok-1-314b at 4 of 64 layers and arctic-480b (128 experts, a dense
   residual) at 2 of 35, one model at a time; each prefills 4 x 1024 tokens
   at the published capacity factor 1.25 and decodes 64 greedy steps, its
   three expert products a layer through ``stream_matmul``'s expert-batched
   form (one launch each, counted in ``batched_launches``; wgmma at prefill,
   gemv at decode), the f32 router on the narrow route at prefill
   (``narrow_launches``) and on the gemv at decode, launches gated exactly
   per call. It prints prefill
   ms and tokens/s against an operations-or-bytes bound, the median decode
   step against the bytes of the experts the step hit, tokens dropped per
   layer, and the device's idle share. First, at published width, each
   model's MoE path in f32 (1 layer each) is held against the
   same path on the CPU (equal top-k sets for every token and layer,
   relative L2 <= 1e-4), and decode against one ``forward`` at a capacity
   factor where nothing drops; the same in bf16 is reported;
6d. runs the hybrid family, recurrentgemma-9b (RG-LRU recurrent layers and
   local attention at head dim 256, MQA), at published width and depth (38
   layers): first at 5 layers (one (rec, rec, attn) group and the two
   trailing recurrent layers) against the CPU on the same weights (f32 and
   bf16, ``forward`` and prefill + decode), and decode against ``forward``
   after a prefill of ``window`` tokens, where the ring of slots drops what
   the window drops; then a prefill of 4 x 1024 tokens and 64 greedy decode
   steps, launches gated exactly per call (attention on the wgmma flash route
   at D = 256 at prefill, ``paged_attention`` over the ring at decode), against their
   bounds with the device's idle share; then the hybrid beside the live set
   served at 150% oversubscription, oversubscribed logits bit-identical to
   all-resident ones;
7. runs the port's kernel bench (``repro_torch.kernels.bench``), the only
   path of ``stream_matmul_int8``, as the JAX package's kernel bench is its
   only caller there; every bench call of the three kernels with a
   tensor-core route takes it;
8. trains: holds ``flash_attention``'s backward kernel against the plain
   version's gradients at every family's training shape in f32 and bf16,
   each call's route (``fa_bwd_route``: wgmma for bf16 at head dim 64, 80,
   128 and 256, simt otherwise) logged and held against
   ``bwd_wgmma_launches``, the wgmma route also with the row statistics its
   forward writes under autograd (the same bits as without) and gated at
   the calls of FA_BWD_LIBRARY_GATED (qwen3-1.7b's, hubert-xlarge's and
   recurrentgemma-9b's) at MAX_BWD_LIBRARY_RATIO times the backward of
   ``scaled_dot_product_attention`` (times beside its operations bound and
   that backward, a yardstick the port never calls), and
   ``stream_matmul``'s gradients (through ``stream_matmul`` itself, x read
   in place for dW) at qwen3-1.7b's projections and minicpm-2b's tied head,
   and the expert-batched form's (dX over the stack, dW over the filled
   slots) at grok-1-314b's and arctic-480b's training shapes in bf16 and
   f32, beside ``torch.bmm``; then the loss and every gradient of
   qwen3-1.7b, minicpm-2b, hubert-xlarge, mamba2-1.3b, llama3.2-3b and
   qwen2-vl-7b (2 layers), recurrentgemma-9b (3) and grok-1-314b (1, f32
   only) at published width on the card against the CPU (f32 gated, bf16
   reported), and arctic-480b at 1 layer in bf16 on the card (finite);
   then qwen3-1.7b at published width and depth, 5 AdamW steps through
   ``make_train_step`` on 4 x 1024 tokens of ``TokenPipeline`` with remat,
   and the MoE pair (grok-1-314b at 2 layers, arctic-480b at 1) for 5
   Adafactor steps each, every step's launches gated exactly (every
   attention call, forward and backward, on its tensor-core route; the
   expert products and their gradients on the expert-batched form), the
   loss falling, remat off giving the same bits, against operations and
   bytes bounds; and ``TrainSupervisor`` with an injected failure resuming
   with the uninterrupted run's losses;
9. drives the reference's training examples, the mesh path and the
   dry-run: (9a) ``examples/port_quickstart.py``, 30 steps of the reduced
   qwen3-1.7b, the loss falling from about ln(512); (9b)
   ``examples/port_train_lm.py``, the ~76 M llama-style config for 200
   steps, and again with a failure injected at step 130, the restarted
   run's losses the uninterrupted run's from the checkpoint on (its
   attention at head dim 64 on the wgmma routes, forward and backward);
   (9c) qwen3-1.7b at published width (MESH_LAYERS layers) through
   ``TrainSupervisor`` on a one-rank NCCL group (a FileStore) and a 1 x 1
   mesh, the state placed as DTensors: the losses of the same run without a
   mesh, bit for bit (the step's split over ``model`` has one rank there and
   runs as the unsharded step), and checkpoints that cross between the two; then
   grok-1-314b at 1 layer, published width, Adafactor, and the recurrent
   families (MESH_RECURRENT: mamba2-1.3b and recurrentgemma-9b at
   published width, depth cut) through ``make_sharded_train_step`` on the
   same group (its per-layer gathers and dp-group routing) beside
   ``make_train_step``, the losses bit for bit; (9d) the dry-run of every
   applicable cell on the 16x16, 2x16x16 and 1x1 meshes (a subprocess an arch and mesh on the host, started
   after phase 8's train path at the lowest priority, so that it runs
   beside phase 8's MoE path and phase 9 on the cores they leave idle, meta
   tensors only; the MoE pair's and qwen1.5-110b's train
   records on the production meshes logged whole, with the bytes by kind
   at the peak), its 1x1 record of qwen3-1.7b's train
   state against the bytes ``make_train_state`` really takes of the card's
   allocator (its rounding allowed), its products' FLOPs of phase 8's step
   against ``train_bounds``' operations, at the ratio
   :func:`predicted_dot_flops` gives, and its 1x1 count (argument + temp +
   output - alias, the memory pass of ``roofline/memory.py``) of phase 8's
   three train runs and of qwen3-1.7b's prefill in phase 6 against the
   peak the card's allocator reached there, within MEMORY_BAND; (9e) one
   rank of the 16x16 mesh on a fake process group of 256 (its collectives
   return at once): qwen3-1.7b at published depth, grok-1-314b at 1
   layer and the recurrent families at RANK_CELLS' depths take a train_4k
   step through ``make_sharded_train_step``, each product on the rank's
   ``model`` shard (the SSM's heads, its projection exchanged over
   ``model``; the RG-LRU's channels), the allocator's peak within
   RANK_BAND of the dry-run's count of the same rank, cell and depth, and
   every (kernel, route, shapes) the step met checked again against its
   plain version (flash at D = 256 on the hybrid's one query head a
   rank among them); (9f) prefill and decode on a mesh: on a one-rank NCCL
   group each model of SERVE_ONE_CELLS (qwen3-1.7b, mamba2-1.3b and
   recurrentgemma-9b at published depth, grok-1-314b at 1 layer) prefills
   4 x 1024 tokens and decodes 16 through ``make_sharded_prefill_step`` /
   ``make_sharded_serve_step``, the logits the meshless steps' bit for bit;
   then on 9e's fake group of 256, rank 0 of 16x16 takes a prefill_32k and
   4 decode_32k steps of each model of SERVE_RANK_CELLS, each product on
   its ``model`` shard and the cache's sequence cut over ``model`` (the
   hybrid's ring of 2,048 slots too; the decode's ``paged_attention``
   returning its log-sum-exp for the merge), the SSM's state and the
   RG-LRU's by heads and channels, the allocator's peak within RANK_BAND of
   the dry-run's count and every (kernel, route, shapes) met against its
   plain version (``paged_attention`` with ``lse`` at a row of length 0 and
   at its split count, on the hybrid's ring shard too); every launch of
   9a-9c, 9e and 9f gated exactly;
10. runs the simulator path (``examples/port_serve_trace.py``'s ``run`` at
   its defaults, each backend's run traced by a full telemetry hub: metrics,
   prediction audit, stall ledger) on this machine's host, with no JAX and
   no ``repro`` in ``sys.modules``. The simulator models a ``Platform`` (the
   paper's RTX5080) in host Python and launches no kernel. Both scoreboards
   are gated against SIM_REFERENCE, the JAX package's values for the same
   call: integers exactly, floats at SIM_RTOL. ``validate_trace`` must find
   no error in either exported trace, and the phase must end within
   SIM_MAX_S;
11. runs the cluster and the control plane on this machine's host, with no
   JAX and no ``repro`` in ``sys.modules``: ``examples/port_cluster_serve.py``'s
   ``run`` over CLUSTER_GPUS GPUs (``A100_40G`` and ``A100_80G`` alternating)
   with rebalancing, three placements, and ``scripts/port_msctl.py``'s crash
   demo fleet (2 x ``RTX5080`` on NVLink: a coordinator crash and journal
   replay, a GPU failure and recovery, an operator cancel, the replay
   checked). The cluster models its GPUs and links as ``Platform``s in host
   Python and launches no kernel. Every report is gated against
   CLUSTER_REFERENCE, the JAX package's values for the same calls: integers,
   strings and lists exactly, floats at CLUSTER_RTOL, the demo's journal
   length and lifecycle summary exactly. The runs in CLUSTER_TRACED carry a
   full telemetry hub and ``validate_trace`` must find no error in their
   traces; the phase must end within CLUSTER_MAX_S;
12. prints the kernels line and, last, the device line.

Any failure raises, so the exit code is not 0; so is a run without a card or
without ``src/repro_torch`` beside this file. Needs no network and no JAX.
"""
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 5e-2  # rtol = atol, the reference's kernel-test tolerance
PAGE_SIZE = 2 << 20  # UVM large page
ARCHS = ["qwen3-1.7b", "llama3.2-3b", "mamba2-1.3b"]
REQUESTS_PER_MODEL = 6
# The decode path (phase 6): prompts, prompt length, greedy steps, cache slots.
DECODE_B, PROMPT, DECODE_STEPS = 4, 1024, 64
DECODE_SMAX = PROMPT + DECODE_STEPS
PREFILL_M = DECODE_B * PROMPT  # rows of x of a prefill's projections
# Decode logits against one forward over the same tokens, relative L2 over
# all of them. Both paths round to bf16 after every projection, norm and
# attention (about 10 places a layer) but at other places and after sums in
# another order, so they differ by a random walk of bf16 steps (2^-9
# relative): about sqrt(28 * 10) * 2^-9 = 3.3e-2 over 28 layers. A wrong
# slot, position or page gives an error of order 1. The gate is 3x the walk.
DECODE_REL_L2 = 1e-1
# mamba2 (48 layers). Decode sums the conv's 4 taps in f32 and rounds once
# (as the reference's einsum does), forward rounds after each tap; the scans
# add in another order. In bf16 the two paths drift apart with depth, not as
# a random walk: the JAX package's own decode and forward differ by relative
# L2 1.1e-2 at 2 layers and 2.7e-1 at 48 (reduced width, 64-token prompt, 16
# steps; the port: 1.2e-2 and 2.4e-1). A state or conv tail that is wrong
# after prefill gives 0.9-1.2 there. The bf16 gate sits between, over all
# positions (one position of the reference's reaches 0.51). The same path in
# f32 is the strict check: the reference's decode and forward agree to
# 1.5e-5 there (the port's to 1.1e-5), and the same faults give 0.9-1.2.
# (A first gate of 1.3e-1, from a random-walk estimate of the bf16 drift,
# failed at 2.3e-1 on the card and was replaced by these two.)
SSM_DECODE_REL_L2 = 5e-1
SSM_DECODE_REL_L2_F32 = 1e-3
# stream_matmul_int8 is also gated at relative L2 <= INT8_REL_L2: with 32-112
# scale groups, one group dropped or read with another's scale moves the
# output by 9-18% in L2, where rtol = atol = 5e-2 on outputs of size ~100
# would not see it; bf16 rounding of the output gives ~2e-3.
INT8_REL_L2 = 1e-2
DECODE_TOL = 8e-2  # rtol = atol, the reference's decode-vs-forward tolerance
# paged_attention is also gated at max |out - ref| <= PA_REL * rms(ref): over
# a thousand slots of randn inputs its outputs have an rms near 0.05, so TOL
# alone is as large as an output and would pass a dropped page. PA_REL is
# about 10x the bf16 error measured at those shapes (2.4e-4).
PA_REL = 5e-2
# flash_attention is also gated at relative L2 <= FA_REL_L2 against
# attention_ref: at S = 1024 late rows have outputs of rms ~0.04, so TOL alone
# would pass a dropped KV tile. The wgmma route rounds P to bf16 before PV,
# which gives ~2e-3 at the prefill shapes (bf16 output rounding ~1e-3).
FA_REL_L2 = 1e-2
# stream_matmul_int8 with bf16 x and f32 output is also gated at relative L2
# <= INT8_EXACT_REL_L2: every route keeps the int8 products exact (the wgmma
# route multiplies bf16 x by the unscaled weight and scales each group's f32
# sum), so only the order of f32 sums differs from the reference (~1e-6 at
# K = 14336); a scale applied to the wrong group or a weight rounded to bf16
# with its scale (up to 2^-9 relative) shows far above it.
INT8_EXACT_REL_L2 = 1e-5
# The tensor-core routes and the redesigned decode attention must come within
# this factor of the library call on the same inputs: the stream_matmul sum
# over a prefill of each model against torch.matmul's, the gemv's sums over a
# live step and a decode step of each model against torch.matmul's, each prefill
# flash_attention call against scaled_dot_product_attention, each dense
# decode paged_attention call against SDPA over the contiguous cache, and the
# stream_matmul_int8 sum over paper-llama3-8b's projections at M = 4096
# against torch.matmul of x with bf16 weights of the same (K, N).
MAX_LIBRARY_RATIO = 2.0
# a gemv shape that reads more than this times torch.matmul is profiled: both
# calls' kernels and their own device times (phase 3)
GEMV_PROFILED = 1.1
# the flash_attention calls of phase 3 held to MAX_LIBRARY_RATIO: the dense
# prefills and the tensor-core calls at head dims 80 and 256 of the families
# and hybrid paths
FA_LIBRARY_GATED = ("qwen3 prefill", "llama3.2 prefill", "hubert forward", "hybrid prefill")
# The backward's tensor-core route at qwen3-1.7b's, hubert-xlarge's and
# recurrentgemma-9b's training calls (FA_BWD_LIBRARY_GATED; the forward's
# statistics given) must come within this factor of SDPA's backward on the
# same inputs: it runs seven products where SDPA's runs five (dQ has a
# kernel of its own, so that no sum needs atomics and the bits depend on the
# shapes alone), so it is held to a looser factor than the forward kernels.
MAX_BWD_LIBRARY_RATIO = 3.0
PATHS = ("serve", "prefill", "decode", "families", "moe", "hybrid", "kernel_bench", "train", "train_moe")
# Phase 6b: the attention families beside the live set, at published width
# and depth: tied embeddings, M-RoPE (VLM), the bidirectional audio encoder.
# A step of the "families" path is one call of an entry point: a prefill or
# a decode step of minicpm-2b and qwen2-vl-7b, hubert-xlarge's forward.
FAMILY_ARCHS = ("minicpm-2b", "qwen2-vl-7b", "hubert-xlarge")
# the tied head's K-major product (N, K) = (V, d) of minicpm-2b, checked in
# phase 3 also off the path: the live step's M = 1, a 4096-row product and
# the decode check's forward over 4 x 1088 positions
TIED_NK = (122753, 2304)
KERNELS = ("stream_matmul", "stream_matmul_int8", "flash_attention", "paged_attention", "flash_attention_backward")
BENCH_KERNELS = KERNELS[:4]  # the kernel bench's: every forward kernel
# Phase 6c: the MoE family at published width. A step of the "moe" path is a
# prefill or a decode step of one model. Depth is the only cut: grok-1-314b
# holds 9.84 GB a layer (64 layers: 630 GB), arctic-480b 27.2 GB (35 layers:
# 953 GB), so 4 and 2 layers with their heads take 42.6 and 55.4 GB of the
# card's 80.
MOE_DEPTHS = {"grok-1-314b": 4, "arctic-480b": 2}
# The strict check in f32 (twice the bytes): 1 layer each, grok-1-314b 26.1
# GB (phase 8 checks its training at the same depth in f32), arctic-480b
# 56.3 GB, each also copied to the host for the CPU run.
MOE_F32_DEPTHS = {"grok-1-314b": 1, "arctic-480b": 1}
# f32 MoE path on the card against the CPU: the same function in f32 with
# sums in another order (~1e-6 relative a product), while one token routed
# to another expert, or dropped, moves its logits by order 1 (a relative L2
# over 64 tokens of ~1e-1); the gate sits far from both.
MOE_F32_REL_L2 = 1e-4
MOE_CHECK_B, MOE_CHECK_S = 2, 32  # the CPU comparison's prompt
MOE_DEC_B, MOE_DEC_S = 4, 36  # decode vs forward: B x S = 144 positions, the last 4 decoded
# Phase 6d: the hybrid family (RG-LRU recurrent layers and local attention at
# head dim 256) at published width and depth, 38 layers (20.9 GB in bf16, no
# cut). A step of the "hybrid" path is a prefill, a decode step or a live step
# of it. First, at HYBRID_CHECK_LAYERS layers (one (rec, rec, attn) group and
# the two trailing recurrent layers), the card against the CPU on one set of
# weights.
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_CHECK_LAYERS = 5
HYBRID_CHECK_B, HYBRID_CHECK_S = 2, 64  # the CPU comparison's prompt, then 4 decode steps
# f32 card against the CPU, and decode against forward where the ring holds
# the window: the same f32 function with sums in another order (~1e-6),
# while a wrong slot, state or conv tail moves the logits by order 1.
HYBRID_F32_REL_L2 = 1e-4
# bf16 card against the CPU, relative L2 over every logit: at 5 layers bf16
# rounding at other places (CUDA's exp and the CPU's differ in the last f32
# bit) sends the recurrence down another bf16 path, as it does between the
# two packages on the CPU (2.1e-2 there at the reduced width; the reference's
# own bf16 forward is 2.4e-2 from its f32 one), so no elementwise gate holds;
# a fault is of order 1.
HYBRID_BF16_REL_L2 = 5e-2
# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
# and operations/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# Bench's spin before each timed call: about half a millisecond at the
# H100's 1.98 GHz, longer than the host takes to queue a kernel's call or
# its library's
LEAD_CYCLES = 1_000_000
# paper-llama3-8b's projections (K, N), for which stream_matmul_int8 was
# written: wq, wk/wv, w1/w3, w2, the LM head
LLAMA3_8B_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))
# Phase 8: training. A step of the "train" path is one train step of
# qwen3-1.7b at published width and depth over TRAIN_B x TRAIN_S tokens.
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_B, TRAIN_S = 4, 1024
TRAIN_STEPS = 5
# flash_attention's backward against the plain version's gradients (autograd
# through attention_ref in f32): in f32 the same function with sums in another
# order (~1e-6 measured), in bf16 the rounding of inputs, forward output and
# gradients (~2e-3 measured); a dropped tile or a wrong row statistic moves a
# gradient by order 1.
FA_BWD_REL_L2 = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
# Phase 8's MoE path ("train_moe"): a step is one train step of one MoE
# model at published width over TRAIN_B x TRAIN_S tokens, Adafactor and remat
# as published, capacity factor 1.25. Depth is the only cut: bf16 parameters
# and gradients of grok-1-314b at 2 layers take 45.8 GB, of arctic-480b at 1
# layer 56.3 GB, of the card's 80.
TRAIN_MOE_DEPTHS = {"grok-1-314b": 2, "arctic-480b": 1}
# the families' training shapes: (label, B, S, H, Hkv, D, causal, window,
# calls a train step by path); llama3.2-3b (g = 3), qwen2-vl-7b (g = 7), the
# MoE pair (g = 6, 7) and examples/port_train_lm.py's config (g = 5, phase
# 9b) leave padding rows in the wgmma route's 64-row tiles of 64 // g
# positions
TRAIN_LABEL = "qwen3"  # the FA_BWD_CASES row of the train path's call
FA_BWD_CASES = (
    (TRAIN_LABEL, TRAIN_B, TRAIN_S, 16, 8, 128, True, 0, {"train": 28}),
    ("minicpm-2b", TRAIN_B, TRAIN_S, 36, 36, 64, True, 0, {}),
    ("hubert-xlarge", TRAIN_B, TRAIN_S, 16, 16, 80, False, 0, {}),
    ("recurrentgemma-9b", TRAIN_B, TRAIN_S, 16, 1, 256, True, 2048, {}),
    ("recurrentgemma-9b S=4096", 1, 4096, 16, 1, 256, True, 2048, {}),
    ("g=4 D=80", 2, TRAIN_S, 16, 4, 80, True, 0, {}),
    ("llama3.2-3b", TRAIN_B, TRAIN_S, 24, 8, 128, True, 0, {}),
    ("qwen2-vl-7b", TRAIN_B, TRAIN_S, 28, 4, 128, True, 0, {}),
    ("grok-1-314b", TRAIN_B, TRAIN_S, 48, 8, 128, True, 0, {"train_moe": TRAIN_MOE_DEPTHS["grok-1-314b"]}),
    ("arctic-480b", TRAIN_B, TRAIN_S, 56, 8, 128, True, 0, {"train_moe": TRAIN_MOE_DEPTHS["arctic-480b"]}),
    ("port_train_lm", 4, 128, 10, 2, 64, True, 0, {}),
)
# the rows of FA_BWD_CASES whose bf16 call is held to MAX_BWD_LIBRARY_RATIO:
# the train path's, and the tensor-core calls at head dims 80 and 256
FA_BWD_LIBRARY_GATED = (TRAIN_LABEL, "hubert-xlarge", "recurrentgemma-9b", "recurrentgemma-9b S=4096")
# flash_attention by positions (the reference attend's mask) at Qwen2-VL's
# M-RoPE layout (vlm_positions: an image's patches, the prompt's first
# eighth, share temporal position 0): (label, B, S, H, Hkv, D, dtype,
# window, tail, forward calls a step by path). Phase 3 holds the forward
# and phase 8 the backward against the plain version by the same
# positions (FA_REL_L2, FA_BWD_REL_L2; rows that see no key exactly 0) and
# times each beside the index route at the same shape and SDPA with the same
# boolean mask. qwen2-vl-7b's prefill (the families path's calls) with row
# 0's last `tail` slots at -1, an f32 call (the simt route) and a D = 80
# call with a window (a second wgmma head dim).
FA_POSITION_CASES = (
    ("qwen2-vl prefill", DECODE_B, PROMPT, 28, 4, 128, "bfloat16", 0, 77, {"families": 28}),
    ("positions f32", 2, 512, 28, 4, 128, "float32", 0, 77, {}),
    ("positions D=80", 2, PROMPT, 16, 16, 80, "bfloat16", 256, 77, {}),
)
# Card against CPU at published width: (arch, layers, dtypes); the loss and
# every gradient leaf in f32 within this relative L2 (the same f32 function
# with sums in another order, ~1e-6 a product), bf16 reported. llama3.2-3b
# (g = 3) and qwen2-vl-7b (g = 7) in f32 only, the gate their GQA ratios
# need; grok-1-314b in f32 only: 6.53 B parameters, 26.1 GB of them and 26.1
# GB of gradients on the card, and as much again on the host for the CPU's
# run.
TRAIN_CHECK = (("qwen3-1.7b", 2, ("float32", "bfloat16")), ("minicpm-2b", 2, ("float32", "bfloat16")),
               ("hubert-xlarge", 2, ("float32", "bfloat16")), ("mamba2-1.3b", 2, ("float32", "bfloat16")),
               ("recurrentgemma-9b", 3, ("float32", "bfloat16")), ("llama3.2-3b", 2, ("float32",)),
               ("qwen2-vl-7b", 2, ("float32",)), ("grok-1-314b", 1, ("float32",)))
# arctic-480b's f32 parameters and gradients at 1 layer take 113 GB, more
# than the card holds: its f32 check is the kernel-level one at its expert
# shapes (check_batched_grads) and the reduced model in the on-card tests;
# at published width it runs in bf16 at 1 layer, loss and gradients finite.
TRAIN_CARD_ONLY = (("arctic-480b", 1),)
TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 32
TRAIN_F32_REL_L2 = 1e-4
# the expert-batched gradients against f32 products of the same operands:
# bf16 rounds each gradient once (~2e-3), f32 sums in another order (~1e-6)
BATCHED_GRAD_REL_L2 = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}


# Phase 9: the reference's training examples, the one-rank mesh, the dry-run.
QUICKSTART_STEPS = 30
# examples/port_train_lm.py as the reference runs it: 200 steps, checkpoints
# every 40; the failure at step 130, so that the restart from step 120 runs
# ten steps again (at 120, the reference's example, nothing is run twice)
TRAIN_LM_STEPS, TRAIN_LM_KILL, TRAIN_LM_CKPT = 200, 130, 40
# the mesh path: qwen3-1.7b at published width, depth cut to MESH_LAYERS so
# that each run's checkpoint (4.1 GB of bf16 parameters and f32 moments at 2
# layers) is written and read back within a few seconds
MESH_LAYERS, MESH_STEPS = 2, 3
# the MoE model on the same one-rank group: grok-1-314b at published width,
# 1 layer (bf16 parameters 13.1 GB, and as much again of gradients), through
# make_sharded_train_step beside make_train_step
MESH_MOE_ARCH, MESH_MOE_LAYERS = "grok-1-314b", 1
# the recurrent families on the same group, (arch, layers): published width,
# depth cut so that both take a few seconds; recurrentgemma-9b's 5 layers are
# one (rec, rec, attn) group and its two trailing recurrent layers
MESH_RECURRENT = (("mamba2-1.3b", 8), ("recurrentgemma-9b", 5))
# the train cells the per-layer gathers bring under the card's 80 GiB on the
# production meshes; phase 9d logs their records
DRYRUN_FSDP_CELLS = ("grok-1-314b", "arctic-480b", "qwen1.5-110b")
DRYRUN_MESHES = ("16x16", "2x16x16", "1x1")
# the dry-run's 1x1 count of a run that phases 6 and 8 measured (argument +
# temp + output - alias) lies within this share of the allocator's peak there
MEMORY_BAND = 0.10
MEMORY_GATED = ("train qwen3-1.7b", "train grok-1-314b", "train arctic-480b", "prefill qwen3-1.7b")
# Phase 9e: one rank of the production 16x16 mesh on the card, its 255 peers
# stood in for by PyTorch's fake process group (every collective returns at
# once, so the values are not checked): the products split over model at
# the shard shapes the production mesh gives them. Each cell is (arch, layers;
# None for the published depth): qwen3-1.7b's train_4k step at 28 layers
# (the dry-run counts 17.8 GiB a device), grok-1-314b at 1 of 64, and the
# recurrent families split over model at MESH_RECURRENT's depths.
RANK_MESH = (16, 16)
RANK_CELLS = (("qwen3-1.7b", None), ("grok-1-314b", 1), *MESH_RECURRENT)
RANK_BAND = 0.05  # the dry-run's count of the same rank, cell and depth against the allocator's peak
# Phase 9f: prefill and decode on a mesh. On a one-rank NCCL group (as 9c's)
# each model of SERVE_ONE_CELLS (arch, layers; None for the published depth)
# prefills DECODE_B x PROMPT tokens and decodes SERVE_ONE_STEPS tokens
# through the sharded serving steps beside the meshless ones, bit for bit;
# on 9e's fake group of 256 rank 0 of RANK_MESH takes SERVE_RANK_CELLS'
# prefill_32k and SERVE_RANK_STEPS decode_32k steps, each product on its
# model shard, the cache's sequence cut over model.
SERVE_ONE_CELLS = (("qwen3-1.7b", None), ("grok-1-314b", 1), ("mamba2-1.3b", None), ("recurrentgemma-9b", None))
SERVE_ONE_STEPS = 16
SERVE_RANK_CELLS = (("qwen3-1.7b", None), ("grok-1-314b", 1), *MESH_RECURRENT)
SERVE_RANK_STEPS = 4
# a flash call whose plain version would hold more than FA_CHECK_BYTES of
# f32 scores (prefill_32k: 2 x 32,768² a head) is held against it on five
# runs of FA_CHECK_ROWS query rows, starting at 0, S/4, S/2, 3S/4 and at
# its last FA_CHECK_ROWS; every other call on every row
FA_CHECK_BYTES = 4 << 30
FA_CHECK_ROWS = 1024
# paged_attention with lse at a shard shape: the log-sum-exp within this of
# the plain version's (absolute; |lse| is a few units)
PA_LSE_TOL = 1e-3
# stream_matmul at a shard shape against its plain version, relative L2 by the
# inputs' dtype: bf16 rounds the output once (~2e-3), f32 sums in another order
MM_REL_L2 = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}
# Phase 10: the simulator path. SIM_REFERENCE is the scoreboard of the JAX
# package's examples/serve_trace.py at its defaults (integers, then floats
# as repr writes them); tests/test_torch_serving.py holds it to the
# reference's own run on the CPU. The integers are gated exactly and the
# floats at SIM_RTOL: bursty_trace draws through random.lognormvariate and
# gammavariate, whose math.log / math.exp may round the last bit otherwise
# on another machine's libm.
SIM_INT_KEYS = ("n_requests", "n_finished", "n_rejected", "faults", "migrated_bytes", "capacity_bytes", "switches")
SIM_FLOAT_KEYS = ("offered_rps", "oversubscription", "ttft_p50_us", "ttft_p99_us", "tpot_p50_us", "tpot_p99_us",
                  "latency_p99_us", "goodput_per_s", "throughput_per_s")
SIM_REFERENCE = {
    "um": {"n_requests": 14, "n_finished": 6, "n_rejected": 0, "faults": 175832, "migrated_bytes": 184373215232,
           "capacity_bytes": 4650106880, "switches": 2700, "offered_rps": 7.132529412357349,
           "oversubscription": 4.984782608695652, "ttft_p50_us": 1334777.8963980214,
           "ttft_p99_us": 1652013.248483295, "tpot_p50_us": 56764.482620133786, "tpot_p99_us": 1644526.1499792682,
           "latency_p99_us": 8943653.127097672, "goodput_per_s": 1.5283991597908606,
           "throughput_per_s": 3.056798319581721},
    "msched": {"n_requests": 14, "n_finished": 14, "n_rejected": 0, "faults": 0, "migrated_bytes": 29007806464,
               "capacity_bytes": 4650106880, "switches": 14, "offered_rps": 7.132529412357349,
               "oversubscription": 0.5038968360228314, "ttft_p50_us": 359090.4558833982,
               "ttft_p99_us": 881014.5852142877, "tpot_p50_us": 3047.436136290431, "tpot_p99_us": 3081.842536297341,
               "latency_p99_us": 976551.7038395053, "goodput_per_s": 7.132529412357349,
               "throughput_per_s": 7.132529412357349},
}
SIM_RTOL = 1e-9
SIM_MAX_S = 30.0
# Phase 11: the cluster and the control plane. CLUSTER_REFERENCE holds the
# JAX package's answers for the same calls (cluster_scoreboard of each report;
# for the demo also its journal length and lifecycle summary): its
# examples/cluster_serve.py --gpus 4 --migrate and the crash demo fleet of its
# scripts/msctl.py. tests/test_torch_cluster_table.py holds the table to the
# reference's own run on the CPU. 4 GPUs at 1.5x oversubscription is the
# middle of benchmarks/cluster_oversub.py's 2 / 4 / 8 sweep. Only the msched
# placement and the demo are traced: the reference's stall ledger refuses the
# traced round-robin and least-loaded runs (LedgerConservationError: a
# migrated request's transit wait is counted past its wall), and the port,
# a copy, refuses them alike (ROADMAP.md §3).
CLUSTER_GPUS = 4
CLUSTER_TRACED = ("msched", "demo")
CLUSTER_RTOL = 1e-9
CLUSTER_MAX_S = 90.0
CLUSTER_REFERENCE = {
    "roundrobin": {
        "backend": "msched", "placement": "roundrobin", "n_gpus": 4, "total_capacity_bytes": 18567397376,
        "oversubscription": 0.8805344562255574, "offered_rps": 15.224030999420172, "ttft_slo_us": 3000000.0,
        "tpot_slo_us": 100000.0, "migrations": 7, "migrated_requests": 5, "deferred_migrations": 0,
        "peer_fetches": 0, "peer_fetch_bytes": 0, "peer_fallback_pages": 0, "linger_finish_reaped": 0,
        "faults_applied": 0, "recoveries": 0, "recoveries_by_kind": {"checkpoint": 0, "linger": 0, "cold": 0,
        "requeue": 0}, "replayed_iters": 0, "shed_requests": 0, "lost_requests": 0, "retry_exhausted": 0,
        "checkpoints": 0, "checkpoint_bytes": 0, "journal_len": 0, "journal_replays": 0, "coordinator_crashes":
        0, "deadline_misses": 0, "preemptions": 0, "deadline_sheds": 0, "planned_transfers": 0,
        "planner_replans": 0, "planner_deferred": 0, "n_requests": 56, "n_finished": 56, "n_rejected": 0,
        "ttft_p50_us": 482497.7134902389, "ttft_p99_us": 1518115.901069615, "tpot_p50_us": 3047.775952593501,
        "tpot_p99_us": 16215.00376052741, "latency_p50_us": 695965.6324788048, "latency_p99_us":
        2328615.8634149814, "goodput_per_s": 15.224030999420172, "throughput_per_s": 15.224030999420172,
        "gpu_placed": [14, 14, 14, 14], "gpu_finished": [13, 15, 13, 15], "gpu_faults": [0, 0, 0, 0],
        "gpu_migrated_bytes": [31136415744, 29095886848, 26967277568, 29037166592], "gpu_switches": [17, 20, 15,
        18]},
    "leastloaded": {
        "backend": "msched", "placement": "leastloaded", "n_gpus": 4, "total_capacity_bytes": 18567397376,
        "oversubscription": 0.7542929096838865, "offered_rps": 15.224030999420172, "ttft_slo_us": 3000000.0,
        "tpot_slo_us": 100000.0, "migrations": 9, "migrated_requests": 9, "deferred_migrations": 0,
        "peer_fetches": 0, "peer_fetch_bytes": 0, "peer_fallback_pages": 0, "linger_finish_reaped": 0,
        "faults_applied": 0, "recoveries": 0, "recoveries_by_kind": {"checkpoint": 0, "linger": 0, "cold": 0,
        "requeue": 0}, "replayed_iters": 0, "shed_requests": 0, "lost_requests": 0, "retry_exhausted": 0,
        "checkpoints": 0, "checkpoint_bytes": 0, "journal_len": 0, "journal_replays": 0, "coordinator_crashes":
        0, "deadline_misses": 0, "preemptions": 0, "deadline_sheds": 0, "planned_transfers": 0,
        "planner_replans": 0, "planner_deferred": 0, "n_requests": 56, "n_finished": 56, "n_rejected": 0,
        "ttft_p50_us": 785823.4101163954, "ttft_p99_us": 2827205.0392067963, "tpot_p50_us": 3047.775952586982,
        "tpot_p99_us": 5752.783808874131, "latency_p50_us": 979697.2062542522, "latency_p99_us":
        2851555.9837283054, "goodput_per_s": 15.224030999420172, "throughput_per_s": 15.224030999420172,
        "gpu_placed": [21, 15, 13, 7], "gpu_finished": [15, 18, 13, 10], "gpu_faults": [0, 0, 0, 0],
        "gpu_migrated_bytes": [35246833664, 37346082816, 22915579904, 20728250368], "gpu_switches": [21, 21, 16,
        11]},
    "msched": {
        "backend": "msched", "placement": "msched", "n_gpus": 4, "total_capacity_bytes": 18567397376,
        "oversubscription": 0.7544349771986051, "offered_rps": 15.224030999420172, "ttft_slo_us": 3000000.0,
        "tpot_slo_us": 100000.0, "migrations": 7, "migrated_requests": 7, "deferred_migrations": 0,
        "peer_fetches": 0, "peer_fetch_bytes": 0, "peer_fallback_pages": 0, "linger_finish_reaped": 0,
        "faults_applied": 0, "recoveries": 0, "recoveries_by_kind": {"checkpoint": 0, "linger": 0, "cold": 0,
        "requeue": 0}, "replayed_iters": 0, "shed_requests": 0, "lost_requests": 0, "retry_exhausted": 0,
        "checkpoints": 0, "checkpoint_bytes": 0, "journal_len": 0, "journal_replays": 0, "coordinator_crashes":
        0, "deadline_misses": 0, "preemptions": 0, "deadline_sheds": 0, "planned_transfers": 0,
        "planner_replans": 0, "planner_deferred": 0, "n_requests": 56, "n_finished": 56, "n_rejected": 0,
        "ttft_p50_us": 737877.3051655316, "ttft_p99_us": 2910964.9498409643, "tpot_p50_us": 3046.501641480718,
        "tpot_p99_us": 5752.783808874131, "latency_p50_us": 929552.0137075223, "latency_p99_us":
        2910964.9498409643, "goodput_per_s": 15.224030999420172, "throughput_per_s": 15.224030999420172,
        "gpu_placed": [9, 22, 11, 14], "gpu_finished": [9, 22, 10, 15], "gpu_faults": [0, 0, 0, 0],
        "gpu_migrated_bytes": [20728250368, 45596278784, 18775801856, 31136415744], "gpu_switches": [13, 25, 13,
        18]},
    "demo": {
        "backend": "msched", "placement": "leastloaded", "n_gpus": 2, "total_capacity_bytes": 8589934592,
        "oversubscription": 0.8133907318115234, "offered_rps": 13.448315782274639, "ttft_slo_us": 3000000.0,
        "tpot_slo_us": 100000.0, "migrations": 0, "migrated_requests": 0, "deferred_migrations": 0,
        "peer_fetches": 0, "peer_fetch_bytes": 0, "peer_fallback_pages": 0, "linger_finish_reaped": 0,
        "faults_applied": 4, "recoveries": 1, "recoveries_by_kind": {"checkpoint": 0, "linger": 0, "cold": 1,
        "requeue": 0}, "replayed_iters": 94, "shed_requests": 0, "lost_requests": 0, "retry_exhausted": 0,
        "checkpoints": 0, "checkpoint_bytes": 0, "journal_len": 74, "journal_replays": 1, "coordinator_crashes":
        1, "deadline_misses": 0, "preemptions": 0, "deadline_sheds": 0, "planned_transfers": 0,
        "planner_replans": 0, "planner_deferred": 0, "n_requests": 16, "n_finished": 15, "n_rejected": 1,
        "ttft_p50_us": 955784.3314654466, "ttft_p99_us": 3290469.735602394, "tpot_p50_us": 3040.5548562969925,
        "tpot_p99_us": 34553.391938487024, "latency_p50_us": 1186861.978162728, "latency_p99_us":
        3707109.3998498106, "goodput_per_s": 11.76727630949031, "throughput_per_s": 12.607796045882473,
        "gpu_placed": [12, 4], "gpu_finished": [11, 4], "gpu_faults": [0, 0], "gpu_migrated_bytes":
        [24868028416, 8308916224], "gpu_switches": [17, 7], "journal": 74, "lifecycle": {"FINISHED": 15,
        "CANCELLED": 1}},
}
# the caching allocator rounds every request up to a multiple of 512 B, and
# leaves a request above 1 MiB the rest of its block where that rest is 1
# MiB or less (it splits a block only for a larger rest)
ALLOC_ROUND, ALLOC_LARGE = 512, 1 << 20


def log(*args):
    print(*args, flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build
    from repro_torch.kernels import _build

    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s into {_build.BUILD_DIR}")
    for log_file in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {log_file.stem}: {line.strip()}")

    run_phases(torch, dev)


def run_phases(torch, dev) -> None:
    """Phases 3 to 11."""
    bench = Bench(torch, dev)
    usage = ptxas_usage()
    t_run = time.perf_counter()

    def phase_done(name):
        log(f"[{time.perf_counter() - t_run:.0f} s] {name} done; {torch.cuda.memory_allocated(dev)} B allocated, "
            f"{torch.cuda.memory_reserved(dev)} B reserved on the card, {host_rss()} B resident on the host")

    recs = {
        "stream_matmul": check_stream_matmul(torch, dev, bench, usage),
        "stream_matmul_int8": check_stream_matmul_int8(torch, dev, bench, usage),
        "flash_attention": check_flash_attention(torch, dev, bench, usage),
        "paged_attention": check_paged_attention(torch, dev, bench, usage),
    }
    phase_done("3. kernels against their plain versions")
    check_model_against_cpu(torch, dev)
    check_decode_against_cpu(torch, dev)
    check_ssm_against_cpu(torch, dev)
    phase_done("4. card against the CPU")
    # each path: its launches, read with every count set to 0 just before it
    paths = {"serve": serve_slice(torch, dev)}
    phase_done("5. serve")
    decode_paths, peaks = decode_slice(torch, dev)
    paths.update(decode_paths)
    phase_done("6. prefill and decode")
    check_families_against_cpu(torch, dev)
    paths["families"], nk_launches = families_slice(torch, dev)
    phase_done("6b. families")
    check_moe_against_cpu(torch, dev)
    paths["moe"], (batched_launches, narrow_launches), _ = moe_slice(torch, dev)
    phase_done("6c. moe")
    check_hybrid_against_cpu(torch, dev)
    paths["hybrid"], _ = hybrid_slice(torch, dev)
    phase_done("6d. hybrid")
    paths["kernel_bench"] = kernel_bench_path(torch, dev)
    phase_done("7. kernel bench")
    # 8. training
    recs["flash_attention_backward"] = check_flash_backward(torch, dev)
    check_stream_matmul_grads(torch, dev)
    check_batched_grads(torch, dev, recs["stream_matmul"])
    phase_done("8. gradient kernels")
    check_train_against_cpu(torch, dev)
    phase_done("8. training against the CPU")
    paths["train"], train_run_numbers = train_slice(torch, dev)
    phase_done("8. train")
    with tempfile.TemporaryDirectory() as tmp:
        # 9d's dry-run takes the host's other cores from here on, at the lowest priority
        dry = start_dryrun(Path(tmp))
        try:
            paths["train_moe"], moe_runs = train_moe_slice(torch, dev)
            phase_done("8. train_moe")
            for name, run in ((TRAIN_ARCH, train_run_numbers), *moe_runs.items()):
                peaks[f"train {name}"] = run["peak_allocated_bytes"] - run["base_allocated_bytes"]
            supervisor_on_card(torch, dev)
            paths["quickstart"] = quickstart_on_card(torch, dev)
            phase_done("9a. quickstart")
            paths["train_lm"] = train_lm_on_card(torch, dev)
            phase_done("9b. train_lm")
            paths["mesh"], paths["mesh_moe"], paths["mesh_recurrent"] = mesh_on_card(torch, dev)
            phase_done("9c. mesh")
            # 9e and 9f time nothing
            paths["rank"] = rank_on_card(torch, dev)
            phase_done("9e. one rank of 16x16")
            paths["serve_one"], paths["serve_rank"] = serve_on_mesh(torch, dev)
            phase_done("9f. prefill and decode on a mesh")
            dryrun_on_card(torch, dev, Path(tmp), dry, peaks)
        finally:
            for proc in dry.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    phase_done("9d. dry-run")
    simulator_on_host()
    phase_done("10. simulator")
    cluster_on_host()
    phase_done("11. cluster")

    recs["stream_matmul"]["extra"]["nk_launches"] = {"families": nk_launches}
    mesh_batched = paths["mesh_moe"][3]
    paths["mesh_moe"] = paths["mesh_moe"][:3]
    recs["stream_matmul"]["extra"]["batched_launches"] = {"moe": batched_launches,
                                                          "train_moe": sum(r["batched"][0] for r in moe_runs.values()),
                                                          "mesh_moe": mesh_batched[0]}
    recs["stream_matmul"]["extra"]["batched_grad_launches"] = {
        "train_moe": sum(r["batched"][1] for r in moe_runs.values()), "mesh_moe": mesh_batched[1]}
    recs["stream_matmul"]["extra"]["narrow_launches"] = {
        "moe": narrow_launches, "train_moe": sum(r["narrow"] for r in moe_runs.values())}
    kernels = kernels_line(recs, paths)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


def kernels_line(recs, paths):
    """Per kernel: launches on each path, and kernel / plain / bound / library
    ms of one step of that path for each model, weighted by the calls a step
    makes at each shape; the top-level ms sum one step of every timed path.
    Phase 9's paths (quickstart, train_lm, mesh) are counted, not timed
    (``"timed": false``): their calls are the shapes of phase 8's train path
    at other sizes. library_ms is null where no single PyTorch call computes
    the function. Raises if a kernel was launched on no path."""
    kernels = []
    for name in KERNELS:
        rec = recs[name]
        by_path = {}
        for path, (launches, steps, wgmma) in paths.items():
            by_path[path] = {"launches": launches[name], "launches_per_step": launches[name] / steps,
                             **({"wgmma_launches": wgmma[name]} if name in wgmma else {}),
                             **rec["by_path"].get(path, {"timed": False})}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": sum(p["launches"] for p in by_path.values()),
            **({"wgmma_launches": sum(p["wgmma_launches"] for p in by_path.values())}
               if name in WGMMA_KERNELS else {}),
            "max_abs_err": rec["max_abs_err"],
            **{key: sum_or_none(p[key] for p in by_path.values() if p.get("timed", True))
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": rec["bound_by"],
            "by_path": by_path,
            **rec.get("extra", {}),
        })
    unused = [k["name"] for k in kernels if k["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels never launched on a main path: {unused}")
    return kernels


def sum_or_none(values):
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


class Bench:
    """CUDA-event timing, median of ``reps`` launches after a warm-up, with
    the 50 MB L2 flushed before each launch (the live path reads every weight
    once a step, so it finds them cold). After the flush the card spins for
    LEAD_CYCLES, about half a millisecond, so that the host has queued both events
    and the call before the card reaches the first event: the events read the
    card's time for the call, and a host slowed by its neighbours does not
    leave the card idle between them."""

    def __init__(self, torch, dev, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_usage():
    """{mangled kernel name: (registers, spilled bytes)} from the ``-Xptxas
    -v`` report of every library in the build directory."""
    from repro_torch.kernels import _build

    usage, entry, spill = {}, None, 0
    for log_file in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log_file.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = int(line.split("bytes spill stores")[0].split(",")[-1])
            elif "Used" in line and "registers" in line and entry is not None:
                usage[entry] = (int(line.split("Used")[1].split("registers")[0]), spill)
                entry = None
    return usage


def kernel_usage(usage, *fragments) -> str:
    """Registers and spilled bytes of the kernel instances whose mangled names
    hold every fragment (a range where several instances match)."""
    found = [v for k, v in usage.items() if all(f in k for f in fragments)]
    if not found:
        return "ptxas: not reported"
    regs = sorted({r for r, _ in found})
    span = f"{regs[0]}" if len(regs) == 1 else f"{regs[0]}-{regs[-1]}"
    return f"{span} regs, {max(sp for _, sp in found)} B spilled"


def max_err(torch, out, ref) -> float:
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL, atol=TOL)
    return float((out.float() - ref.float()).abs().max())


def step_projections(c, m_layer, m_head):
    """{(M, K, N, w_layout, dtype): calls} of one call of a model: every
    layer's 2-D projections at M = m_layer (bf16; an MoE layer's router in
    f32; its expert products are :func:`step_experts`'), the LM head at M =
    m_head ("nk", the embedding table, where the embeddings are tied)."""
    d, L = c.d_model, c.num_layers
    n_rec, n_attn = layer_counts(c)
    mats = []  # (K, N, calls)
    if c.family == "ssm":
        d_inner = c.ssm.expand * d
        mats = [(d, 2 * d_inner + 2 * c.ssm.state_dim + d_inner // c.ssm.head_dim, L), (d_inner, d, L)]
    else:
        hd = c.resolved_head_dim()
        mats = [(d, c.num_heads * hd, n_attn), (d, c.num_kv_heads * hd, 2 * n_attn), (c.num_heads * hd, d, n_attn)]
        # the hybrid's recurrent layers: w_in, w_gate_branch, w_a, w_x, w_out
        mats += [(d, d, 5 * n_rec)]
        f = c.moe.dense_d_ff if c.moe is not None else c.d_ff
        if c.moe is None or c.moe.dense_residual:
            mats += [(d, f, 2 * L), (f, d, L)]
    counts = {}
    for k, n, calls in mats:
        if calls:
            counts[(m_layer, k, n, "kn", "bf16")] = counts.get((m_layer, k, n, "kn", "bf16"), 0) + calls
    if c.moe is not None:
        counts[(m_layer, d, c.moe.num_experts, "kn", "f32")] = L
    head = (m_head, d, c.vocab_size, "nk" if c.tie_embeddings else "kn", "bf16")
    counts[head] = counts.get(head, 0) + 1
    return counts


def train_projections(c, m, remat=True):
    """{(M, K, N, layout, dtype): calls} of one train step of a model over m
    tokens: the forward's 2-D projections (the layers' twice with remat; an
    MoE layer's router, not its expert products, which are
    :func:`step_experts`') and LM head, then each product's two gradients
    through stream_matmul: for a (K, N) weight dX = dY (M, N) @ W^T with W
    read K-major in place and dW = X^T @ dY with X (M, K) read in place as
    (K', M') ("km"); for the tied head's (V, d) table dX = dY (M, V) @ E and
    dE = dY^T @ X, dY read in place, or from a transposed copy ("kn") where
    its bf16 rows are no multiple of 16 bytes (an odd V)."""
    counts = {}

    def add(key, calls):
        counts[key] = counts.get(key, 0) + calls

    for (mm, k, n, layout, dt), calls in step_projections(c, m, m).items():
        head = n == c.vocab_size or k == c.vocab_size
        add((mm, k, n, layout, dt), calls * (1 + (remat and not head)))
        if layout == "kn":
            add((mm, n, k, "nk", dt), calls)
            add((k, mm, n, "km", dt), calls)
        else:  # x (M, K) @ w.T for w (N, K)
            add((mm, n, k, "kn", dt), calls)
            add((n, mm, k, "kn" if dt == "bf16" and n % 8 else "km", dt), calls)
    return counts


def step_experts(c, n_tokens):
    """{(E, C, K, N): calls} of the expert-batched products of one call of an
    MoE model over ``n_tokens`` tokens: w1 and w3 (E, d, f), w2 (E, f, d)
    each layer, at C = the capacity for that many tokens."""
    from repro_torch.models.layers import moe_capacity

    m, d, L = c.moe, c.d_model, c.num_layers
    cap = moe_capacity(m, n_tokens)
    return {(m.num_experts, cap, d, m.d_ff): 2 * L, (m.num_experts, cap, m.d_ff, d): L}


def layer_counts(cfg):
    """(recurrent layers, attention layers) of a model: the hybrid's from its
    (rec, rec, attn) pattern; an SSM's layers count as neither."""
    kinds = cfg.layer_kinds()
    return kinds.count("rec"), kinds.count("attn")


def hybrid_config(layers=None):
    """recurrentgemma-9b's published config, at ``layers`` layers if given."""
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_ARCH)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def moe_config(arch, layers=None):
    """The published config of an MoE arch at ``layers`` (its phase 6c depth
    by default)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers or MOE_DEPTHS[arch])


def projection_shapes():
    """{path: {label: {(M, K, N, layout, dtype): calls a step}}}: every x @ W of
    one step of each main path (the train path's gradient products included,
    :func:`train_projections`): the live step (M = 1), a prefill of DECODE_B
    prompts (M = DECODE_B * PROMPT for the layers, M = DECODE_B for the LM
    head on the last position) and a decode step (M = DECODE_B), for each
    model; on the families path a prefill and a decode step of each decode
    model and hubert-xlarge's forward (M = DECODE_B * PROMPT throughout); on
    the moe path a prefill and a decode step of each MoE model at its phase
    6c depth (the expert products apart, :func:`step_experts`); on the
    hybrid path a prefill, a decode step and a live step of recurrentgemma-9b;
    the kernel bench's one product; and a train step of each MoE model at its
    phase 8 depth (the expert products and their gradients apart)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bench as kernel_bench

    shapes = {path: {} for path in PATHS}
    for arch in ARCHS:
        c = get_config(arch)
        for path, m_layer, m_head in (("serve", 1, 1), ("prefill", DECODE_B * PROMPT, DECODE_B),
                                      ("decode", DECODE_B, DECODE_B)):
            shapes[path][arch] = step_projections(c, m_layer, m_head)
    for arch in FAMILY_ARCHS:
        c = get_config(arch)
        if c.has_decode:
            shapes["families"][f"{arch} prefill"] = step_projections(c, DECODE_B * PROMPT, DECODE_B)
            shapes["families"][f"{arch} decode"] = step_projections(c, DECODE_B, DECODE_B)
        else:
            shapes["families"][f"{arch} forward"] = step_projections(c, DECODE_B * PROMPT, DECODE_B * PROMPT)
    for arch in MOE_DEPTHS:
        c = moe_config(arch)
        shapes["moe"][f"{arch} prefill"] = step_projections(c, DECODE_B * PROMPT, DECODE_B)
        shapes["moe"][f"{arch} decode"] = step_projections(c, DECODE_B, DECODE_B)
    c = hybrid_config()
    shapes["hybrid"][f"{HYBRID_ARCH} prefill"] = step_projections(c, DECODE_B * PROMPT, DECODE_B)
    shapes["hybrid"][f"{HYBRID_ARCH} decode"] = step_projections(c, DECODE_B, DECODE_B)
    shapes["hybrid"][f"{HYBRID_ARCH} live"] = step_projections(c, 1, 1)
    shapes["kernel_bench"]["bench"] = {(*kernel_bench.MM_SHAPE, "kn", "bf16"): 1}
    c = get_config(TRAIN_ARCH)
    shapes["train"][f"{TRAIN_ARCH} step"] = train_projections(c, TRAIN_B * TRAIN_S, c.remat)
    for arch, layers in TRAIN_MOE_DEPTHS.items():
        c = moe_config(arch, layers)
        shapes["train_moe"][f"{arch} step"] = train_projections(c, TRAIN_B * TRAIN_S, c.remat)
    return shapes


def path_totals(library=0.0):
    return {path: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=library) for path in PATHS}


def counters():
    """Each kernel's wrapper, which counts its launches, the name of its
    count, and the name of its count of tensor-core launches (None where it
    has no such route): the backward of flash_attention counts on the
    forward's wrapper, in ``bwd_launches`` and ``bwd_wgmma_launches``."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.streammm.ops import stream_matmul, stream_matmul_int8

    return {"stream_matmul": (stream_matmul, "launches", "wgmma_launches"),
            "stream_matmul_int8": (stream_matmul_int8, "launches", "wgmma_launches"),
            "flash_attention": (flash_attention, "launches", "wgmma_launches"),
            "paged_attention": (paged_attention, "launches", None),
            "flash_attention_backward": (flash_attention, "bwd_launches", "bwd_wgmma_launches")}


# kernels with a tensor-core route
WGMMA_KERNELS = ("stream_matmul", "stream_matmul_int8", "flash_attention", "flash_attention_backward")


def zero_launches():
    for fn, count, wgmma_count in counters().values():
        setattr(fn, count, 0)
        if wgmma_count is not None:
            setattr(fn, wgmma_count, 0)
    for count in POSITION_COUNTS.values():
        setattr(counters()["flash_attention"][0], count, 0)
    counters()["stream_matmul"][0].narrow_launches = 0


def read_narrow() -> int:
    """stream_matmul's launches on the f32 narrow route (the MoE routers)."""
    return counters()["stream_matmul"][0].narrow_launches


# the flash calls by positions (the VLM's), forward and backward, counted on
# the forward's wrapper beside the route
POSITION_COUNTS = {"flash_attention": "position_launches", "flash_attention_backward": "bwd_position_launches"}


def read_positions():
    fn = counters()["flash_attention"][0]
    return {name: getattr(fn, count) for name, count in POSITION_COUNTS.items()}


def step_positions(cfg, path):
    """The flash calls of one call of ``path`` that mask by positions: every
    one of the VLM's (its M-RoPE layout), none of another family's."""
    n = step_launches(cfg, path)
    return {name: n[name] if cfg.family == "vlm" else 0 for name in POSITION_COUNTS}


def read_launches():
    return {name: getattr(fn, count) for name, (fn, count, _) in counters().items()}


def read_wgmma():
    """The launches that took the tensor-core route, by kernel."""
    return {name: getattr(fn, wgmma_count) for name, (fn, _, wgmma_count) in counters().items()
            if wgmma_count is not None}


def model_matmuls(cfg) -> int:
    """stream_matmul launches of the layer stack: 2 an SSM layer; 4 attention
    projections, then 3 for a dense MLP, or an MoE layer's router, its 3
    expert-batched products and the dense residual's 3; 5 projections of the
    RG-LRU block and 3 for the MLP a hybrid recurrent layer."""
    if cfg.family == "ssm":
        return 2 * cfg.num_layers
    n_rec, n_attn = layer_counts(cfg)
    if cfg.moe is None:
        return 7 * n_attn + 8 * n_rec
    return (4 + 1 + 3 + 3 * cfg.moe.dense_residual) * n_attn


def step_launches(cfg, path):
    """The launches of one call of ``path`` ("serve", "prefill", "decode" or
    "forward") of a model: its projections and LM head through stream_matmul,
    one attention an attention layer (flash on the live step, prefill and
    forward, paged on decode), none of the SSM family."""
    _, n_attn = layer_counts(cfg)
    return {
        "stream_matmul": model_matmuls(cfg) + 1,
        "stream_matmul_int8": 0,
        "flash_attention": n_attn if path != "decode" else 0,
        "paged_attention": n_attn if path == "decode" else 0,
        "flash_attention_backward": 0,
    }


def train_launches(cfg, remat: bool):
    """The launches of one train step of a model: every projection and the
    LM head forward (the layers' twice with remat: the backward replays each
    layer's forward, but for the hybrid's trailing recurrent layers, which
    run outside its remat groups), then two gradient products each (dX, and
    dW of the weight), through stream_matmul; one flash_attention an
    attention layer (two with remat) and one backward call."""
    n_rec, n_attn = layer_counts(cfg)
    layers = model_matmuls(cfg)
    replayed = layers - 8 * (n_rec - 2 * n_attn) if cfg.family == "hybrid" else layers
    return {
        "stream_matmul": layers + remat * replayed + 1 + 2 * (layers + 1),
        "stream_matmul_int8": 0,
        "flash_attention": n_attn * (1 + remat),
        "paged_attention": 0,
        "flash_attention_backward": n_attn,
    }


def attention_on_wgmma(cfg, b, s) -> bool:
    """Whether a model's self-attention over b x s positions takes the
    tensor-core route: ``fa_route`` at the model's heads, head dim and
    dtype (bf16 at head dim 64, 80, 128 or 256, at least 64 folded rows; the
    wrappers' operands are 16-byte aligned on these paths)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import fa_route

    return fa_route(b, s, s, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(),
                    getattr(torch, cfg.dtype)) == "wgmma"


def train_wgmma(cfg, remat: bool, b=TRAIN_B, s=TRAIN_S):
    """The attention launches of one train step over b x s tokens of a
    model that take the tensor-core route (:func:`attention_on_wgmma`, so
    every head dim the route takes: qwen3-1.7b's 128, hubert-xlarge's 80,
    recurrentgemma-9b's 256): every forward (twice with remat) and every
    backward call, the backward reading the statistics its forward wrote;
    none where the rule says simt."""
    _, n_attn = layer_counts(cfg)
    on = bool(n_attn) and attention_on_wgmma(cfg, b, s)
    return {"flash_attention": n_attn * (1 + remat) * on, "flash_attention_backward": n_attn * on}


def step_wgmma(cfg, path, b=DECODE_B, s=PROMPT):
    """The launches of one call of ``path`` that take the tensor-core route:
    on prefill and on a forward over DECODE_B x PROMPT positions or more every
    bf16 projection (all but an MoE router, which is f32 on the narrow route,
    :func:`step_narrow`; the expert products' capacity is above 8 rows
    there) and, in a forward, the LM head
    (a prefill's runs on the last position, M = 4: gemv); every attention
    that ``fa_route`` sends there (:func:`attention_on_wgmma` over b x s:
    hubert-xlarge's D = 80 and recurrentgemma-9b's D = 256 included); none
    on the live and decode steps (M = 1 and 4, Sq = 1 or paged; an expert
    capacity of 2). The int8 kernel is on no model's path, the backward on
    none of these."""
    _, n_attn = layer_counts(cfg)
    if path not in ("prefill", "forward"):
        return {"stream_matmul": 0, "stream_matmul_int8": 0, "flash_attention": 0, "flash_attention_backward": 0}
    routers = cfg.num_layers if cfg.moe is not None else 0
    return {"stream_matmul": model_matmuls(cfg) - routers + (path == "forward"),
            "stream_matmul_int8": 0,
            "flash_attention": n_attn if n_attn and attention_on_wgmma(cfg, b, s) else 0,
            "flash_attention_backward": 0}


def step_narrow(cfg, path):
    """stream_matmul's launches of one call of ``path`` on the f32 narrow
    route: every MoE router (x (M, d) @ w (d, E) in f32, E of 8 or 128) on
    prefill and on a forward (M = DECODE_B x PROMPT or more); none on the
    live and decode steps (M <= 8: gemv) or in a model without experts."""
    return cfg.num_layers if cfg.moe is not None and path in ("prefill", "forward") else 0


def train_narrow(cfg, remat: bool):
    """stream_matmul's launches of one train step on the f32 narrow route:
    every MoE router forward (twice with remat), then its dX (dY (M, E) @
    w^T, K = E) and its dW (x read as (K, M), N = E)."""
    return cfg.num_layers * (1 + remat + 2) if cfg.moe is not None else 0


def step_batched(cfg):
    """stream_matmul's expert-batched launches of any call of a model: 3 an
    MoE layer."""
    return 3 * cfg.num_layers if cfg.moe is not None else 0


def step_nk(cfg):
    """stream_matmul's K-major launches of any call of a model: the tied LM
    head, once, where the embeddings are tied."""
    return int(cfg.tie_embeddings)


def checked_route(fn, rule, call):
    """Calls ``call`` once and returns ``(output, route)``, the route read from
    ``fn.wgmma_launches`` and, where the wrapper has one (``stream_matmul``),
    ``fn.narrow_launches``: "wgmma" or "narrow" if that count rose by one,
    else ``rule``'s answer (gemv or simt, which the counters do not tell
    apart). Raises if the tensor-core or the narrow kernel ran where the
    route rule says it should not, or the other way round."""
    before = fn.wgmma_launches, getattr(fn, "narrow_launches", 0)
    out = call()
    took = fn.wgmma_launches - before[0], getattr(fn, "narrow_launches", 0) - before[1]
    if took != (rule == "wgmma", rule == "narrow"):
        raise AssertionError(f"{fn.__name__}: route rule says {rule}, wgmma and narrow launches rose by {took}")
    return out, "wgmma" if took[0] else "narrow" if took[1] else rule


def traced_kernels(torch, fn):
    """[(name, grid, µs)] of the kernels one call of ``fn`` ran on the card,
    from torch.profiler's trace (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    return [(e["name"], tuple(e.get("args", {}).get("grid", ())), e.get("dur")) for e in events
            if e.get("cat") == "kernel"]


def check_gemv_launches(torch, dev):
    """The gemv route's launches as the profiler sees them: a product whose
    K is split (qwen3-1.7b's wk at the live step, 8 splits) runs one kernel,
    and a decode step's expert call (arctic-480b's w1 shape, E = 128, 4
    tokens x top-2 hitting at most 8 experts) one kernel whose grid spans the
    bound's 8 slots, not E. Gated."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.streammm.ops import GEMV_ROW_BYTES, k_splits, stream_matmul

    gen = torch.Generator(dev).manual_seed(5)
    x = torch.randn((1, 2048), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((2048, 1024), generator=gen, device=dev).to(torch.bfloat16)
    splits = k_splits(1, 1024, 2048, sm_count(dev))
    ran = traced_kernels(torch, lambda: stream_matmul(x, w))
    log(f"  profiler, qwen3 wk at M=1 ({splits} K splits): {ran}")
    if splits < 2 or len(ran) != 1 or ran[0][1] != (1024 // (GEMV_ROW_BYTES // 2), splits, 1):
        raise AssertionError(f"stream_matmul gemv with {splits} K splits ran {ran}, want one kernel")
    c = moe_config("arctic-480b")
    e, d, f, hit = c.moe.num_experts, c.d_model, c.moe.d_ff, min(c.moe.num_experts, c.moe.top_k * DECODE_B)
    xe = torch.randn((e, 2, d), generator=gen, device=dev).to(torch.bfloat16)
    we = torch.empty((e, d, f), device=dev, dtype=torch.bfloat16).normal_(generator=gen)
    rows = torch.zeros(e, dtype=torch.int32, device=dev)
    rows[torch.randperm(e, generator=gen, device=dev)[:hit]] = 1
    ran = traced_kernels(torch, lambda: stream_matmul(xe, we, rows=rows, experts_hit=hit))
    log(f"  profiler, arctic-480b w1 at decode (E={e}, bound {hit}): {ran}")
    slabs = -(-f // (GEMV_ROW_BYTES // 2))
    want = (slabs, k_splits(2, f, d, sm_count(dev), experts=hit), hit)
    if len(ran) != 1 or ran[0][1] != want:
        raise AssertionError(f"stream_matmul expert gemv ran {ran}, want one kernel of grid {want}")
    del xe, we
    torch.cuda.empty_cache()


def check_stream_matmul(torch, dev, bench, usage):
    from repro_torch.kernels.streammm.ops import mm_route, stream_matmul
    from repro_torch.kernels.streammm.ref import stream_matmul_ref

    gen = torch.Generator(dev).manual_seed(0)

    def operands(m, k, n, dtype, layout="kn"):
        x = torch.randn((k, m) if layout == "km" else (m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((n, k) if layout == "nk" else (k, n), generator=gen, device=dev) / k ** 0.5).to(dtype)
        return x, w

    def library(x, w, layout):
        return torch.matmul(x.T if layout == "km" else x, w.T if layout == "nk" else w)

    def layout_kw(layout):
        return {"w_layout": "kn", "x_layout": "km"} if layout == "km" else {"w_layout": layout}

    def route_rule(m, k, n, x, w, layout):
        kw = layout_kw(layout)
        return mm_route(m, n, k, x.dtype, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, kw["w_layout"],
                        kw.get("x_layout", "mk"))

    log("stream_matmul's streaming gemv (M rows of x: ptxas registers, spills): " + "; ".join(
        f"M<={mm} {kernel_usage(usage, 'gemv_stream_kernel', f'Li{mm}E')}" for mm in (1, 2, 4, 8)))
    check_gemv_launches(torch, dev)
    log("stream_matmul against stream_matmul_ref at every shape of each path (ms: CUDA events, cold L2; "
        "layout nk: x @ w.T for w (N, K), the library call torch.matmul(x, w.T); km: x.T @ w for x (K, M), "
        "x read in place, torch.matmul(x.T, w)):")
    totals = path_totals()
    errs, bound_kinds, measured, by_shape = [], set(), {}, []
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for path, by_arch in projection_shapes().items():
        for arch, counts in by_arch.items():
            step = dict(ms=0.0, bound_ms=0.0, library_ms=0.0)
            for (m, k, n, layout, dt), calls in counts.items():
                if (m, k, n, layout, dt) not in measured:
                    dtype = dtypes[dt]
                    x, w = operands(m, k, n, dtype, layout)
                    kw = dict(out_dtype=dtype, **layout_kw(layout))
                    rule = route_rule(m, k, n, x, w, layout)
                    out, route = checked_route(stream_matmul, rule, lambda: stream_matmul(x, w, **kw))
                    err = max_err(torch, out, stream_matmul_ref(x, w, **kw))
                    if not torch.equal(out, stream_matmul(x, w, **kw)):
                        raise AssertionError(f"stream_matmul ({m},{k},{n}) {layout} is not deterministic")
                    t = bench.ms(lambda: stream_matmul(x, w, **kw))
                    t_plain = bench.ms(lambda: stream_matmul_ref(x, w, **kw))
                    t_lib = bench.ms(lambda: library(x, w, layout))
                    elem = x.element_size()
                    b, kind = bound(elem * (m * k + k * n + m * n), 2 * m * k * n, dtype)
                    measured[(m, k, n, layout, dt)] = dict(ms=t, plain_ms=t_plain, bound_ms=b, library_ms=t_lib)
                    by_shape.append({"M": m, "K": k, "N": n, "w_layout": layout, "dtype": dt, "route": route,
                                     "ms": t, "bound_ms": b, "bound_by": kind, "plain_ms": t_plain,
                                     "library_ms": t_lib, "max_abs_err": err})
                    if route == "gemv" and t > GEMV_PROFILED * t_lib:  # the kernels' own times, cold L2
                        by_shape[-1]["profile"] = {
                            name: [(k_name[:60], us) for k_name, _, us in traced_kernels(
                                torch, lambda: (bench.flush_buf.zero_(), call()))[1:]]
                            for name, call in (("stream_matmul", lambda: stream_matmul(x, w, **kw)),
                                               ("torch.matmul", lambda: library(x, w, layout)))}
                        log(f"  profile M={m} K={k} N={n} {dt} (kernel µs after an L2 flush): "
                            f"{by_shape[-1]['profile']}")
                    errs.append(err)
                    bound_kinds.add(kind)
                    del x, w, out
                    log(f"  M={m} K={k} N={n} {layout} {dt} [{route}]: err {err:.2e} kernel {t:.4f} ms bound "
                        f"{b:.4f} ms ({kind}, {100 * b / t:.0f}%) plain {t_plain:.4f} ms torch.matmul {t_lib:.4f} "
                        f"ms (kernel {t / t_lib:.2f}x)")
                for key, val in measured[(m, k, n, layout, dt)].items():
                    totals[path][key] += calls * val
                    if key in step:
                        step[key] += calls * val
            log(f"  one {path} step of {arch} ({sum(counts.values())} calls): kernel {step['ms']:.3f} ms, "
                f"bound {step['bound_ms']:.3f} ms, torch.matmul {step['library_ms']:.3f} ms "
                f"(kernel {step['ms'] / step['library_ms']:.2f}x)")
    check_batched_experts(torch, dev, bench, totals, by_shape, errs, bound_kinds)
    moe = totals["moe"]
    log(f"  moe path (a prefill and a decode step of grok-1-314b at {MOE_DEPTHS['grok-1-314b']} layers and "
        f"arctic-480b at {MOE_DEPTHS['arctic-480b']}, expert products included): kernel {moe['ms']:.3f} ms, "
        f"library {moe['library_ms']:.3f} ms ({moe['ms'] / moe['library_ms']:.2f}x), bound {moe['bound_ms']:.3f} ms")
    fam = totals["families"]
    log(f"  families path (a prefill and a decode step of minicpm-2b and qwen2-vl-7b, hubert-xlarge's "
        f"forward): kernel {fam['ms']:.3f} ms, torch.matmul {fam['library_ms']:.3f} ms "
        f"({fam['ms'] / fam['library_ms']:.2f}x), bound {fam['bound_ms']:.3f} ms")
    prefill = totals["prefill"]
    ratio = prefill["ms"] / prefill["library_ms"]
    log(f"  prefill path: kernel {prefill['ms']:.3f} ms, torch.matmul {prefill['library_ms']:.3f} ms "
        f"({ratio:.2f}x, gate {MAX_LIBRARY_RATIO}x), bound {prefill['bound_ms']:.3f} ms "
        f"({100 * prefill['bound_ms'] / prefill['ms']:.0f}%)")
    if not ratio <= MAX_LIBRARY_RATIO:
        raise AssertionError(f"stream_matmul prefill sum {ratio:.2f}x torch.matmul > {MAX_LIBRARY_RATIO}x")
    for path, name in (("serve", "live"), ("decode", "decode")):  # every product on the gemv route
        sums = totals[path]
        ratio = sums["ms"] / sums["library_ms"]
        log(f"  {name} path (one step of {', '.join(ARCHS)}): kernel {sums['ms']:.3f} ms, torch.matmul "
            f"{sums['library_ms']:.3f} ms ({ratio:.2f}x, gate {MAX_LIBRARY_RATIO}x), bound {sums['bound_ms']:.3f} ms "
            f"({100 * sums['bound_ms'] / sums['ms']:.0f}%)")
        if not ratio <= MAX_LIBRARY_RATIO:
            raise AssertionError(f"stream_matmul {name} sum {ratio:.2f}x torch.matmul > {MAX_LIBRARY_RATIO}x")
    tied_n, tied_k = TIED_NK
    off_path = [(256, 2048, 2048, torch.bfloat16, "kn"), (1, 2048, 2048, torch.float32, "kn"),
                (64, 2048, 6144, torch.float32, "kn"), (3, 1000, 999, torch.bfloat16, "kn"),
                (200, 264, 136, torch.bfloat16, "kn"), (130, 72, 8, torch.bfloat16, "kn")]
    # the K-major form off the path: the tied head at the live step's M = 1,
    # at M = 4096 and at the decode check's 4 x 1088 rows; a ragged K on gemv
    # and simt, f32 on simt, a ragged N on wgmma
    off_path += [(m, tied_k, tied_n, torch.bfloat16, "nk") for m in (1, PREFILL_M, DECODE_B * DECODE_SMAX)]
    off_path += [(3, 300, 1001, torch.bfloat16, "nk"), (64, 300, 1001, torch.bfloat16, "nk"),
                 (64, 2048, 1001, torch.float32, "nk"), (200, 264, 137, torch.bfloat16, "nk")]
    # x read in place as (K, M): a ragged K and N on wgmma, a K of 2 (wgmma:
    # TMA zero-fills past it), f32 with N = 200 (simt), an M no multiple of 8
    # (simt)
    off_path += [(264, 200, 136, torch.bfloat16, "km"), (2048, 2, 1024, torch.bfloat16, "km"),
                 (300, 64, 200, torch.float32, "km"), (100, 256, 512, torch.bfloat16, "km")]
    for m, k, n, dtype, layout in off_path:
        x, w = operands(m, k, n, dtype, layout)
        kw = dict(out_dtype=dtype, **layout_kw(layout))
        rule = route_rule(m, k, n, x, w, layout)
        out, route = checked_route(stream_matmul, rule, lambda: stream_matmul(x, w, **kw))
        err = max_err(torch, out, stream_matmul_ref(x, w, **kw))
        if not torch.equal(out, stream_matmul(x, w, **kw)):
            raise AssertionError(f"stream_matmul ({m},{k},{n}) {dtype} {layout} is not deterministic")
        t = bench.ms(lambda: stream_matmul(x, w, **kw))
        line = f"  off-path M={m} K={k} N={n} {dtype} {layout} [{route}]: err {err:.2e} kernel {t:.4f} ms"
        if layout == "nk" and n == tied_n:
            t_lib = bench.ms(lambda: library(x, w, layout))
            b, kind = bound(2 * (m * k + k * n + m * n), 2 * m * k * n, dtype)
            by_shape.append({"M": m, "K": k, "N": n, "w_layout": layout, "route": route, "ms": t,
                             "bound_ms": b, "bound_by": kind, "library_ms": t_lib, "max_abs_err": err,
                             "off_path": True})
            line += (f" bound {b:.4f} ms ({kind}, {100 * b / t:.0f}%) torch.matmul {t_lib:.4f} ms "
                     f"(kernel {t / t_lib:.2f}x)")
        errs.append(err)
        del x, w, out
        log(line)
    return {
        "source": "src/repro_torch/csrc/streammm.cu",
        "replaces": "src/repro/kernels/streammm/kernel.py:50",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
        "extra": {"by_shape": by_shape},
    }


def check_batched_experts(torch, dev, bench, totals, by_shape, errs, bound_kinds):
    """``stream_matmul``'s expert-batched form against ``stream_matmul_ref``
    at phase 6c's shapes: each MoE model's w1/w3 (E, d, f) and w2 (E, f, d)
    products at the capacity of a prefill (4 x 1024 tokens) and of a decode
    step (4 tokens), with the ``rows`` of a dispatch of that many tokens
    (router logits from a seed) and zeros past them, as ``moe_apply`` builds
    its buffer, and its bound on the experts hit, min(E, top_k x tokens).
    Gated: the tolerance, exact zeros past ``rows``, the same
    bits on a second call, the route. Timed beside the plain version and
    ``torch.bmm`` on the same (E, C, K) @ (E, K, N); the bound counts the
    filled rows' operations, the weights of the experts that hold a row and
    the whole output. Adds each product's calls a step into ``totals["moe"]``
    and, at the prefill's capacity (the same 4 x 1024 tokens), a phase 8
    train step's forward calls (twice a layer with remat) into
    ``totals["train_moe"]``."""
    from repro_torch.kernels.streammm.ops import mm_route, stream_matmul
    from repro_torch.kernels.streammm.ref import stream_matmul_ref
    from repro_torch.models.common import dense_init
    from repro_torch.models.layers import moe_dispatch

    gen = torch.Generator(dev).manual_seed(4)
    log("stream_matmul expert-batched (x (E, C, K) @ w (E, K, N), rows of a dispatch) against "
        "stream_matmul_ref; library torch.bmm:")
    for arch in MOE_DEPTHS:
        c = moe_config(arch)
        for what, n_tokens in (("prefill", DECODE_B * PROMPT), ("decode", DECODE_B)):
            route_rows = moe_dispatch(torch.randn((n_tokens, c.moe.num_experts), generator=gen, device=dev),
                                      c.moe).rows
            counts = route_rows.tolist()
            train_calls = {}
            if what == "prefill" and arch in TRAIN_MOE_DEPTHS:
                ct = moe_config(arch, TRAIN_MOE_DEPTHS[arch])
                train_calls = {key: n * (1 + ct.remat) for key, n in step_experts(ct, TRAIN_B * TRAIN_S).items()}
            for (e, cap, k, n), calls in step_experts(c, n_tokens).items():
                live = torch.arange(cap, device=dev) < route_rows[:, None].long()
                x = torch.randn((e, cap, k), generator=gen, device=dev).to(torch.bfloat16) * live[..., None]
                w = dense_init(gen, (e, k, n), torch.bfloat16, fan_in=k)  # in pieces: arctic's is 8.9 GB
                kw = dict(rows=route_rows, experts_hit=min(e, c.moe.top_k * n_tokens))  # as moe_apply
                rule = mm_route(cap, n, k, x.dtype, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
                out, route = checked_route(stream_matmul, rule, lambda: stream_matmul(x, w, **kw))
                err = max_err(torch, out, stream_matmul_ref(x, w, rows=route_rows))
                if out[~live].any():
                    raise AssertionError(f"stream_matmul batched {arch} {what}: rows past the count are not 0")
                if not torch.equal(out, stream_matmul(x, w, **kw)):
                    raise AssertionError(f"stream_matmul batched {arch} {what} ({e},{cap},{k},{n}) "
                                         "is not deterministic")
                t = bench.ms(lambda: stream_matmul(x, w, **kw))
                t_plain = bench.ms(lambda: stream_matmul_ref(x, w, rows=route_rows))
                t_lib = bench.ms(lambda: torch.bmm(x, w))
                filled, hit = sum(counts), sum(r > 0 for r in counts)
                b, kind = bound(2 * (filled * k + hit * k * n + e * cap * n), 2 * filled * k * n, torch.bfloat16)
                for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", b), ("library_ms", t_lib)):
                    totals["moe"][key] += calls * val
                    totals["train_moe"][key] += train_calls.get((e, cap, k, n), 0) * val
                by_shape.append({"label": f"{arch} {what}", "E": e, "C": cap, "K": k, "N": n, "rows": filled,
                                 "experts_hit": hit, "route": route, "ms": t, "bound_ms": b, "bound_by": kind,
                                 "plain_ms": t_plain, "library_ms": t_lib, "max_abs_err": err})
                errs.append(err)
                bound_kinds.add(kind)
                log(f"  {arch} {what} E={e} C={cap} K={k} N={n} ({filled} rows filled, {hit} experts hit) "
                    f"[{route}]: err {err:.2e} kernel {t:.4f} ms bound {b:.4f} ms ({kind}, {100 * b / t:.0f}%) "
                    f"plain {t_plain:.4f} ms torch.bmm {t_lib:.4f} ms (kernel {t / t_lib:.2f}x)")
                del x, w, out, live
            torch.cuda.empty_cache()


def check_stream_matmul_int8(torch, dev, bench, usage):
    """The int8 kernel against ``stream_matmul_int8_ref`` at the reference's
    test shapes, the kernel bench's, and paper-llama3-8b's projections at
    M = 1 and 4 (the gemv route) and, with bf16 x, at M = 4096 (the wgmma
    route), each call's route read from ``wgmma_launches`` and held against
    ``int8_route``. Gated: relative L2 in bf16 output, in f32 output for bf16
    x (INT8_EXACT_REL_L2), the same bits on a second call, and the M = 4096
    sum at MAX_LIBRARY_RATIO times that of ``torch.matmul`` of x with bf16
    weights of the same (K, N): the same operations, the time an int8 kernel
    reading half the weight bytes should beat at M <= 8 and approach at
    M = 4096. No single PyTorch call computes the int8 function itself."""
    from repro_torch.kernels import bench as kernel_bench
    from repro_torch.kernels.streammm.ops import int8_route, stream_matmul_int8
    from repro_torch.kernels.streammm.ref import stream_matmul_int8_ref

    gen = torch.Generator(dev).manual_seed(3)
    bm, bk_, bn = kernel_bench.MM_SHAPE
    cases = [
        # (label, M, K, N, block_k, x dtypes, kernel-bench calls)
        ("test 1", 64, 128, 64, 64, (torch.bfloat16, torch.float32), 0),
        ("test 2", 128, 256, 128, 64, (torch.bfloat16, torch.float32), 0),
        ("bench", bm, bk_, bn, kernel_bench.INT8_BLOCK_K, (torch.bfloat16, torch.float32), 1),
        ("ragged", 130, 256, 144, 64, (torch.bfloat16,), 0),
        ("block_k 100", 9, 300, 1008, 100, (torch.bfloat16,), 0),
    ] + [("llama3-8b", m, k, n, 128, (torch.bfloat16, torch.float32), 0)
         for m in (1, 4) for k, n in LLAMA3_8B_KN] + [
        ("llama3-8b prefill", PREFILL_M, k, n, 128, (torch.bfloat16,), 0) for k, n in LLAMA3_8B_KN]
    log("stream_matmul_int8 against stream_matmul_int8_ref (ms: CUDA events, cold L2; "
        "bf16 matmul: torch.matmul with bf16 weights of the same (K, N), a yardstick, not the same function):")
    totals = path_totals(library=None)
    errs, bound_kinds, by_shape = [], set(), []
    big = dict(ms=0.0, bf16_matmul_ms=0.0, bound_ms=0.0)
    for label, m, k, n, block_k, dtypes, calls in cases:
        w_q = torch.randint(-127, 127, (k, n), generator=gen, device=dev, dtype=torch.int8)
        scales = 0.005 + 0.015 * torch.rand((k // block_k, n), generator=gen, device=dev)
        w_bf16 = (w_q.float() * scales.repeat_interleave(block_k, 0)).to(torch.bfloat16)
        for dtype in dtypes:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_q, scales))
            rule = int8_route(m, n, k, block_k, dtype, aligned)
            out, route = checked_route(stream_matmul_int8, rule,
                                       lambda: stream_matmul_int8(x, w_q, scales, block_k))
            ref = stream_matmul_int8_ref(x, w_q, scales, block_k)
            err = max_err(torch, out, ref)
            rel = float((out.float() - ref.float()).norm() / ref.float().norm())
            del ref
            if not rel <= INT8_REL_L2:
                raise AssertionError(f"stream_matmul_int8 {label} {dtype}: relative L2 {rel:.3e} > {INT8_REL_L2}")
            if not torch.equal(out, stream_matmul_int8(x, w_q, scales, block_k)):
                raise AssertionError(f"stream_matmul_int8 {label} is not deterministic")
            out32 = stream_matmul_int8(x, w_q, scales, block_k, out_dtype=torch.float32)
            ref32 = stream_matmul_int8_ref(x, w_q, scales, block_k, out_dtype=torch.float32)
            rel32 = float((out32 - ref32).norm() / ref32.norm())
            del out32, ref32
            if not rel32 <= INT8_EXACT_REL_L2:
                raise AssertionError(f"stream_matmul_int8 {label} {dtype}: f32 output relative L2 "
                                     f"{rel32:.3e} > {INT8_EXACT_REL_L2}")
            t = bench.ms(lambda: stream_matmul_int8(x, w_q, scales, block_k))
            t_plain = bench.ms(lambda: stream_matmul_int8_ref(x, w_q, scales, block_k))
            x16 = x.to(torch.bfloat16)
            t_bf16 = bench.ms(lambda: torch.matmul(x16, w_bf16))
            nbytes = x.element_size() * m * k + k * n + 4 * scales.numel() + 2 * m * n
            b, kind = bound(nbytes, 2 * m * k * n, dtype)
            errs.append(err)
            kernel = {"wgmma": "wgmma_kernelI13__nv_bfloat16E", "simt": "tiled_kernel", "gemv": "gemv_kernel"}[route]
            regs = kernel_usage(usage, "streammm_int8_cu", kernel)
            by_shape.append({"label": label, "M": m, "K": k, "N": n, "block_k": block_k, "x": str(dtype),
                             "route": route, "ms": t, "bound_ms": b, "bound_by": kind, "plain_ms": t_plain,
                             "bf16_matmul_ms": t_bf16, "max_abs_err": err, "rel_l2": rel, "rel_l2_f32": rel32,
                             "ptxas": regs})
            if calls and dtype == torch.bfloat16:
                bound_kinds.add(kind)
                for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", b)):
                    totals["kernel_bench"][key] += calls * val
            if label == "llama3-8b prefill":
                for key, val in (("ms", t), ("bf16_matmul_ms", t_bf16), ("bound_ms", b)):
                    big[key] += val
            log(f"  {label} M={m} K={k} N={n} block_k={block_k} x {dtype} [{route}; {regs}]: err {err:.2e} "
                f"rel L2 {rel:.2e} (f32 out {rel32:.2e}) kernel {t:.4f} ms bound {b:.4f} ms ({kind}, "
                f"{100 * b / t:.0f}%) plain {t_plain:.4f} ms bf16 matmul {t_bf16:.4f} ms "
                f"(kernel {t / t_bf16:.2f}x)")
            del x, x16, out
        del w_q, scales, w_bf16
    ratio = big["ms"] / big["bf16_matmul_ms"]
    log(f"  llama3-8b projections at M={PREFILL_M}: kernel {big['ms']:.3f} ms, bf16 matmul "
        f"{big['bf16_matmul_ms']:.3f} ms ({ratio:.2f}x, gate {MAX_LIBRARY_RATIO}x), bound {big['bound_ms']:.3f} ms "
        f"({100 * big['bound_ms'] / big['ms']:.0f}%)")
    if not ratio <= MAX_LIBRARY_RATIO:
        raise AssertionError(f"stream_matmul_int8 M={PREFILL_M} sum {ratio:.2f}x bf16 torch.matmul "
                             f"> {MAX_LIBRARY_RATIO}x")
    return {
        "source": "src/repro_torch/csrc/streammm_int8.cu",
        "replaces": "src/repro/kernels/streammm/kernel.py:101",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
        "extra": {"by_shape": by_shape, "llama3_8b_m4096": {**big, "ratio": ratio}},
    }


def attention_pairs(sq, skv, causal, window):
    """(query, key) pairs the mask keeps: the work this input needs."""
    n = 0
    for s in range(sq):
        lo = max(0, s - window + 1) if window > 0 else 0
        hi = min(skv, s + 1) if causal else skv
        n += max(0, hi - lo)
    return n


def sdpa_window_mask(torch, sq, skv, causal, window, dev):
    """The boolean mask of the SDPA yardstick for a window, or None where
    the window hides nothing (query position minus key position is at most
    Sq - 1 < window), so that SDPA takes its causal or unmasked path there
    as it would for the same attention without a window."""
    if not 0 < window < sq:
        return None
    i = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(skv, device=dev)[None, :]
    return (i - j < window) & ((i >= j) if causal else True)


def vlm_positions(torch, b, s, dev, tail=0):
    """Qwen2-VL's M-RoPE positions (3, B, S) for a prompt whose first eighth
    is vision (``make_concrete_batch``'s split): the patches of a gh x gw
    image (gh != gw, the squarest such grid) at temporal 0, height the
    patch's row, width its column, then the text from max(gh, gw) on all
    three axes (arXiv:2409.12191 section 2.1); row 0's last ``tail`` slots
    at -1 (padding: no query sees them, and their queries see no key)."""
    n = s // 8
    gh = max(d for d in range(1, math.isqrt(n) + 1) if n % d == 0 and d * d != n)
    gw = n // gh
    patch = torch.arange(n, dtype=torch.int32)
    text = torch.arange(s - n, dtype=torch.int32) + max(gh, gw)
    pos = torch.stack([torch.cat([torch.zeros_like(patch), text]), torch.cat([patch // gw, text]),
                       torch.cat([patch % gw, text])])
    pos = pos[:, None, :].expand(3, b, s).contiguous()
    if tail:
        pos[:, 0, s - tail:] = -1
    return pos.to(dev)


def position_mask(torch, pos, causal, window):
    """(B, S, S) bool: the reference attend's mask by ``pos`` (B, S)."""
    qp, kp = pos[:, :, None], pos[:, None, :]
    mask = (kp >= 0) & ((qp >= kp) if causal else True)
    return mask & (qp - kp < window) if window > 0 else mask


def check_flash_positions(torch, dev, bench, backward):
    """flash_attention (phase 3) or its backward (phase 8) by positions at
    FA_POSITION_CASES against the plain version with the same positions:
    relative L2 within FA_REL_L2 (the forward) or FA_BWD_REL_L2 (the
    gradients, against f32 ones), every value finite, the rows that see no
    key (row 0's tail) exactly 0 in the output and dQ and the keys no row
    sees exactly 0 in dK and dV, the same bits on a second call, each call
    on the positions route (``position_launches``, ``bwd_position_launches``)
    and the route of ``fa_route``. Timed beside the index route at the same
    shape, the plain version and SDPA with the same boolean mask (its
    backward for phase 8). The bound counts the visible pairs. Returns
    (records, path totals, bound kinds, max abs errors)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_backward

    fa = fa_ops.flash_attention
    gen = torch.Generator(dev).manual_seed(9 if backward else 2)
    totals, recs, kinds, errs = path_totals(), [], set(), []
    for label, b, s, h, hkv, d, dtype, window, tail, calls in FA_POSITION_CASES:
        dt = getattr(torch, dtype)
        q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dt) for _ in range(2))
        pos = vlm_positions(torch, b, s, dev, tail)[0]
        kw = dict(causal=True, window=window)
        pkw = dict(kw, q_positions=pos, kv_positions=pos)
        route = fa_ops.fa_route(b, s, s, h, hkv, d, dt)
        mask = position_mask(torch, pos, True, window)
        dead = pos < 0  # row 0's tail: no key for those queries, no query for those keys
        count = "bwd_position_launches" if backward else "position_launches"
        wgmma = "bwd_wgmma_launches" if backward else "wgmma_launches"
        before = (getattr(fa, count), getattr(fa, wgmma))
        if backward:
            with torch.no_grad():
                out = fa(q, k, v, **pkw)
            got = fa_ops.flash_attention_backward(q, k, v, out, do, **pkw)
            again = fa_ops.flash_attention_backward(q, k, v, out, do, **pkw)
            want = attention_ref_backward(q.float(), k.float(), v.float(), do.float(), **pkw)
            zero = [got[0][dead]] + [g[dead] for g in got[1:]]
            gate = FA_BWD_REL_L2[str(dt)]
        else:
            got = (fa(q, k, v, **pkw),)
            again = (fa(q, k, v, **pkw),)
            want = (attention_ref(q, k, v, **pkw),)
            zero = [got[0][dead]]
            gate = FA_REL_L2
        took = (getattr(fa, count) - before[0], getattr(fa, wgmma) - before[1])
        if took != (2, 2 * (route == "wgmma")):
            raise AssertionError(f"flash_attention{' backward' if backward else ''} {label}: positions / "
                                 f"tensor-core launches rose by {took}, want 2 and the route rule's {route}")
        rels = [float((g.float() - w.float()).norm() / w.float().norm()) for g, w in zip(got, want)]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        zeros = all(bool((z == 0).all()) for z in zero)
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        del again, want
        if not (finite and zeros and same and max(rels) <= gate):
            raise AssertionError(f"flash_attention{' backward' if backward else ''} {label}: relative L2 {rels} "
                                 f"(gate {gate}), finite {finite}, rows without a key 0 {zeros}, same bits {same}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_kw = dict(attn_mask=mask[:, None], enable_gqa=h != hkv)
        if backward:
            t = bench.ms(lambda: fa_ops.flash_attention_backward(q, k, v, out, do, **pkw))
            t_index = bench.ms(lambda: fa_ops.flash_attention_backward(q, k, v, out, do, **kw))
            t_plain = bench.ms(lambda: attention_ref_backward(q, k, v, do, **pkw))
            qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
            dot = do.transpose(1, 2).contiguous()
            t_lib = bench.ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
            del sdpa_out, dot
        else:
            t = bench.ms(lambda: fa(q, k, v, **pkw))
            t_index = bench.ms(lambda: fa(q, k, v, **kw))
            t_plain = bench.ms(lambda: attention_ref(q, k, v, **pkw))
            t_lib = bench.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw))
        pairs = int(mask.sum()) * h
        elem = q.element_size()
        nbytes = elem * ((4 * q.numel() + 2 * k.numel() + 2 * v.numel()) if backward
                         else (2 * q.numel() + k.numel() + v.numel())) + 4 * 2 * pos.numel()
        bt, kind = bound(nbytes, (10 if backward else 4) * d * pairs, dt)
        for path, n in ({} if backward else calls).items():
            kinds.add(kind)
            for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                totals[path][key] += n * val
        errs.append(err)
        recs.append({"label": label, "B": b, "S": s, "H": h, "Hkv": hkv, "D": d, "dtype": dtype, "window": window,
                     "tail": tail, "route": route, "ms": t, "index_ms": t_index, "bound_ms": bt, "bound_by": kind,
                     "plain_ms": t_plain, "library_ms": t_lib, "visible_pairs": pairs, "max_abs_err": err,
                     "rel_l2": rels})
        log(f"  by positions {label} B={b} S={s} H={h} Hkv={hkv} D={d} window={window} tail={tail} {dtype} "
            f"[{route}]: rel L2 {', '.join(f'{r:.2e}' for r in rels)} kernel {t:.4f} ms (index route {t_index:.4f} "
            f"ms) bound {bt:.5f} ms ({kind}, {100 * bt / t:.0f}%) plain {t_plain:.4f} ms sdpa+mask "
            f"{'backward ' if backward else ''}{t_lib:.4f} ms")
        del q, k, v, do, got, mask, qt, kt, vt
        if backward:
            del out
        torch.cuda.empty_cache()
    return recs, totals, kinds, errs


def check_flash_attention(torch, dev, bench, usage):
    import torch.nn.functional as F

    from repro_torch.kernels import bench as kernel_bench
    from repro_torch.kernels.flash_attention.ops import fa_route, flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(dev).manual_seed(1)
    fb, fs, fh, fhkv, fd = kernel_bench.FA_SHAPE
    cases = [
        # (label, B, Sq, Skv, H, Hkv, D, causal, window, dtype, calls a step by path)
        ("qwen3 live", 1, 1, 1, 16, 8, 128, True, 0, torch.bfloat16, {"serve": 28}),
        ("llama3.2 live", 1, 1, 1, 24, 8, 128, True, 0, torch.bfloat16, {"serve": 28}),
        # the train step of phase 8 runs the same call twice a layer (remat)
        ("qwen3 prefill", DECODE_B, PROMPT, PROMPT, 16, 8, 128, True, 0, torch.bfloat16,
         {"prefill": 28, "train": 56}),
        ("llama3.2 prefill", DECODE_B, PROMPT, PROMPT, 24, 8, 128, True, 0, torch.bfloat16, {"prefill": 28}),
        ("long causal", 1, 2048, 2048, 16, 8, 128, True, 0, torch.bfloat16, {}),
        ("long window", 1, 2048, 2048, 16, 8, 128, True, 512, torch.bfloat16, {}),
        ("test 1", 1, 128, 128, 4, 4, 32, True, 0, torch.bfloat16, {}),
        ("test 2", 2, 256, 256, 8, 2, 64, True, 0, torch.float32, {}),
        ("test 3", 2, 128, 128, 4, 1, 32, True, 64, torch.bfloat16, {}),
        ("test 4", 1, 128, 128, 4, 4, 32, False, 0, torch.float32, {}),
        ("S=1 f32", 1, 1, 1, 16, 8, 128, True, 0, torch.float32, {}),
        ("bench", fb, fs, fs, fh, fhkv, fd, True, 0, torch.bfloat16, {"kernel_bench": 1}),
        # phase 6b: minicpm-2b (MHA, D = 64) prefill, hubert-xlarge's
        # bidirectional forward at D = 80 (the wgmma route); qwen2-vl-7b's
        # prefill masks by positions (FA_POSITION_CASES)
        ("minicpm prefill", DECODE_B, PROMPT, PROMPT, 36, 36, 64, True, 0, torch.bfloat16, {"families": 40}),
        ("hubert forward", DECODE_B, PROMPT, PROMPT, 16, 16, 80, False, 0, torch.bfloat16, {"families": 48}),
        # phase 6c: grok-1-314b (g = 6) and arctic-480b (g = 7) prefill
        # and phase 8's train step of each (the same call, twice a layer with remat)
        ("grok prefill", DECODE_B, PROMPT, PROMPT, 48, 8, 128, True, 0, torch.bfloat16,
         {"moe": MOE_DEPTHS["grok-1-314b"], "train_moe": 2 * TRAIN_MOE_DEPTHS["grok-1-314b"]}),
        ("arctic prefill", DECODE_B, PROMPT, PROMPT, 56, 8, 128, True, 0, torch.bfloat16,
         {"moe": MOE_DEPTHS["arctic-480b"], "train_moe": 2 * TRAIN_MOE_DEPTHS["arctic-480b"]}),
        # phase 6d: recurrentgemma-9b (MQA, g = 16, D = 256, window 2048) at
        # prefill (the wgmma route), the live step (16 folded rows: simt), a
        # window that the sequence outgrows, and f32
        ("hybrid prefill", DECODE_B, PROMPT, PROMPT, 16, 1, 256, True, 2048, torch.bfloat16, {"hybrid": 12}),
        ("hybrid live", 1, 1, 1, 16, 1, 256, True, 2048, torch.bfloat16, {"hybrid": 12}),
        ("hybrid windowed", 1, 4096, 4096, 16, 1, 256, True, 2048, torch.bfloat16, {}),
        ("hybrid f32", 1, 512, 512, 16, 1, 256, True, 128, torch.float32, {}),
    ]
    log("flash_attention against attention_ref (ms: CUDA events):")
    totals = path_totals()
    errs, bound_kinds, by_shape = [], set(), []
    for label, b, sq, skv, h, hkv, d, causal, window, dtype, calls in cases:
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        rule = fa_route(b, sq, skv, h, hkv, d, dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
        out, route = checked_route(flash_attention, rule, lambda: flash_attention(q, k, v, **kw))
        ref = attention_ref(q, k, v, **kw)
        err = max_err(torch, out, ref)
        rel = float((out.float() - ref.float()).norm() / ref.float().norm())
        if not rel <= FA_REL_L2:
            raise AssertionError(f"flash_attention {label}: relative L2 {rel:.3e} > {FA_REL_L2}")
        if not torch.equal(out, flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention {label} is not deterministic")
        del ref
        errs.append(err)
        t = bench.ms(lambda: flash_attention(q, k, v, **kw))
        t_plain = bench.ms(lambda: attention_ref(q, k, v, **kw))
        # yardstick: PyTorch's fused attention on (B, H, S, D) copies
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_kw = dict(attn_mask=sdpa_window_mask(torch, sq, skv, causal, window, dev), enable_gqa=h != hkv)
        sdpa_kw["is_causal"] = causal and sdpa_kw["attn_mask"] is None
        t_lib = bench.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw))
        elem = torch.tensor([], dtype=dtype).element_size()
        nbytes = elem * (2 * q.numel() + k.numel() + v.numel())
        bt, kind = bound(nbytes, 4 * b * h * d * attention_pairs(sq, skv, causal, window), dtype)
        for path, n in calls.items():
            bound_kinds.add(kind)
            for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                totals[path][key] += n * val
        by_shape.append({"label": label, "B": b, "Sq": sq, "Skv": skv, "H": h, "Hkv": hkv, "D": d,
                         "causal": causal, "window": window, "dtype": str(dtype), "route": route,
                         "ms": t, "bound_ms": bt, "bound_by": kind, "plain_ms": t_plain,
                         "library_ms": t_lib, "max_abs_err": err, "rel_l2": rel})
        log(f"  {label} B={b} Sq={sq} Skv={skv} H={h} Hkv={hkv} D={d} causal={causal} "
            f"window={window} {dtype} [{route}]: err {err:.2e} rel L2 {rel:.2e} kernel {t:.4f} ms "
            f"bound {bt:.5f} ms ({kind}, {100 * bt / t:.0f}%) plain {t_plain:.4f} ms sdpa {t_lib:.4f} ms "
            f"(kernel {t / t_lib:.2f}x)")
        if label in FA_LIBRARY_GATED and not t <= MAX_LIBRARY_RATIO * t_lib:
            raise AssertionError(f"flash_attention {label}: {t:.4f} ms > {MAX_LIBRARY_RATIO} x sdpa {t_lib:.4f} ms")
    # by positions: qwen2-vl-7b's prefill calls (the families path's), f32, D = 80
    pos_recs, pos_totals, pos_kinds, pos_errs = check_flash_positions(torch, dev, bench, backward=False)
    errs += pos_errs
    bound_kinds |= pos_kinds
    for path, vals in pos_totals.items():
        for key, val in vals.items():
            totals[path][key] += val
    # registers and spills of each tensor-core instance, forward and backward
    # (the forward's kernel is compiled into both libraries)
    regs = {f"{kernel} D={d}{' by positions' * pos}": kernel_usage(usage, f"{kernel}ILi{d}ELb{pos}E")
            for kernel in ("fa_wgmma_kernel", "fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma") for d in (64, 80, 128, 256)
            for pos in (0, 1)}
    log("flash_attention tensor-core instances (ptxas): " + "; ".join(f"{k}: {v}" for k, v in regs.items()))
    return {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
        "extra": {"by_shape": by_shape, "by_positions": pos_recs, "ptxas": regs},
    }


def check_paged_attention(torch, dev, bench, usage):
    """The split-KV decode kernel against ``paged_attention_ref`` at the
    decode shapes of both dense models, the reference's test shapes, the
    kernel bench's, and the edges of the split rule (``pa_splits``): a row
    that ends inside the first run of pages, lengths on run boundaries, a
    table whose width is no multiple of the run, g = 16, a row of length 0.
    Gated: max error against rms(ref), the same bits on a second call, exact
    zeros for length 0, and each dense decode call in bf16 at
    MAX_LIBRARY_RATIO times SDPA over the contiguous cache."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import bench as kernel_bench
    from repro_torch.kernels.paged_attention.ops import pa_splits, paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.layers import kv_page_tokens

    gen = torch.Generator(dev).manual_seed(2)
    pb, ph, pd, ppt, pmp = kernel_bench.PA_SHAPE
    # the decode path's lengths: 1025 .. 1088, one per row, in its page view
    decode_lengths = tuple(PROMPT + 1 + (DECODE_STEPS - 1) * i // (DECODE_B - 1) for i in range(DECODE_B))
    decode_pt = kv_page_tokens(DECODE_SMAX)
    mp = DECODE_SMAX // decode_pt
    sms = _build.sm_count(dev)
    run = -(-mp // pa_splits(DECODE_B, 8, mp, sms)) * decode_pt  # tokens of a run at the decode shapes
    cases = [
        # (label, B, H, Hkv, D, page_tokens, max_pages, lengths, permuted table,
        #  calls a step by path): the decode shapes of both dense models, the
        #  split rule's edges at those shapes, then the reference's PA_CASES
        #  with its lengths, its growing-length case (one length a row), g = 3
        #  with a permuted table and a row of length 0, and the kernel bench's
        ("qwen3 decode", DECODE_B, 16, 8, 128, decode_pt, mp, decode_lengths, False, {"decode": 28}),
        ("llama3.2 decode", DECODE_B, 24, 8, 128, decode_pt, mp, decode_lengths, False, {"decode": 28}),
        ("llama3.2 permuted", DECODE_B, 24, 8, 128, decode_pt, mp, decode_lengths, True, {}),
        ("inside the first run", DECODE_B, 24, 8, 128, decode_pt, mp, (1, run // 2, run - 1, 0), True, {}),
        ("run boundaries", DECODE_B, 16, 8, 128, decode_pt, mp, (run, 2 * run, 5 * run, mp * decode_pt), False, {}),
        ("long row, ragged runs", 1, 16, 8, 128, 64, 205, (12000,), True, {}),
        ("g=16", 2, 32, 2, 128, 64, mp, (1088, 700), True, {}),
        # phase 6b's decode shapes: minicpm-2b (MHA, D = 64), qwen2-vl-7b (g = 7)
        ("minicpm decode", DECODE_B, 36, 36, 64, decode_pt, mp, decode_lengths, False, {"families": 40}),
        ("qwen2-vl decode", DECODE_B, 28, 4, 128, decode_pt, mp, decode_lengths, False, {"families": 28}),
        ("qwen2-vl permuted", DECODE_B, 28, 4, 128, decode_pt, mp, decode_lengths, True, {}),
        # phase 6c's decode shapes: grok-1-314b (g = 6), arctic-480b (g = 7)
        ("grok decode", DECODE_B, 48, 8, 128, decode_pt, mp, decode_lengths, False, {"moe": MOE_DEPTHS["grok-1-314b"]}),
        ("arctic decode", DECODE_B, 56, 8, 128, decode_pt, mp, decode_lengths, False,
         {"moe": MOE_DEPTHS["arctic-480b"]}),
        # phase 6d's ring decode: recurrentgemma-9b (MQA, g = 16 in 4 blocks of
        # 4 heads, D = 256), a full ring of PROMPT slots in pages of 64, then a
        # ring that has not wrapped yet with a row of length 0
        ("hybrid decode", DECODE_B, 16, 1, 256, 64, PROMPT // 64, (PROMPT,) * DECODE_B, False, {"hybrid": 12}),
        ("hybrid ring filling", DECODE_B, 16, 1, 256, 64, PROMPT // 64, (1, 300, PROMPT - 1, 0), True, {}),
        ("test 1", 2, 4, 2, 32, 16, 4, (1, 8), False, {}),
        ("test 2", 3, 8, 1, 64, 32, 3, (1, 8, 15), False, {}),
        ("test 3", 1, 4, 4, 32, 16, 8, (1,), False, {}),
        ("growing", 5, 4, 2, 32, 16, 4, (1, 16, 17, 32, 64), False, {}),
        ("g=3 length 0", 3, 6, 2, 32, 8, 5, (37, 0, 40), True, {}),
        ("bench", pb, ph, 2, pd, ppt, pmp, (kernel_bench.PA_LENGTH,) * pb, False, {"kernel_bench": 1}),
    ]
    log(f"paged_attention against paged_attention_ref (ms: CUDA events, cold L2; runs of pages from pa_splits, "
        f"{sms} SMs):")
    totals = path_totals()
    errs, bound_kinds, by_shape = [], set(), []
    for label, b, h, hkv, d, pt, max_pages, lengths, permuted, calls in cases:
        splits = pa_splits(b, hkv, max_pages, sms)
        g = h // hkv
        md = 128 if d <= 128 else 256  # the kernel instance's widest head dim
        heads = g if g <= 4 else (8 if d <= 128 else 4)  # query heads a block serves
        regs = kernel_usage(usage, "paged_attention_cu", "pa_split_kernelI13__nv_bfloat16Li"
                            f"{heads}ELb{int(d % 8 == 0)}ELi{md}E")
        for dtype in (torch.bfloat16, torch.float32):
            n_pool = b * max_pages + 3
            q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
            pool_k = torch.randn((n_pool, pt, hkv, d), generator=gen, device=dev).to(dtype)
            pool_v = torch.randn((n_pool, pt, hkv, d), generator=gen, device=dev).to(dtype)
            ids = torch.randperm(n_pool, generator=gen, device=dev) if permuted else torch.arange(n_pool, device=dev)
            table = ids[: b * max_pages].reshape(b, max_pages).to(torch.int32).contiguous()
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            args = (q, pool_k, pool_v, table, lens)
            out = paged_attention(*args)
            ref = paged_attention_ref(*args)
            err = max_err(torch, out, ref)
            rms = float(ref.float().pow(2).mean().sqrt())
            if not err <= PA_REL * rms:
                raise AssertionError(f"paged_attention {label} {dtype}: max abs err {err:.3e} "
                                     f"> {PA_REL} x rms(ref) {rms:.3e}")
            if not torch.equal(out, paged_attention(*args)):
                raise AssertionError(f"paged_attention {label} is not deterministic")
            for row, length in enumerate(lengths):
                if length == 0 and out[row].any():
                    raise AssertionError(f"paged_attention {label}: row {row} of length 0 is not zero")
            errs.append(err)
            t = bench.ms(lambda: paged_attention(*args))
            t_plain = bench.ms(lambda: paged_attention_ref(*args))
            # yardstick: PyTorch's fused attention over the contiguous cache
            # (the pages gathered in table order), masked past each length
            k_seq = pool_k[table.long()].reshape(b, max_pages * pt, hkv, d).transpose(1, 2).contiguous()
            v_seq = pool_v[table.long()].reshape(b, max_pages * pt, hkv, d).transpose(1, 2).contiguous()
            mask = (torch.arange(max_pages * pt, device=dev)[None, :] < lens[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :]
            t_lib = bench.ms(lambda: F.scaled_dot_product_attention(
                q4, k_seq, v_seq, attn_mask=mask, enable_gqa=h != hkv))
            elem = q.element_size()
            valid = sum(lengths)
            nbytes = (elem * (2 * q.numel() + 2 * valid * hkv * d)
                      + 4 * (b + sum(-(-n // pt) for n in lengths)))
            bt, kind = bound(nbytes, 4 * h * d * valid, dtype)
            for path, n in calls.items():
                if dtype == torch.bfloat16:
                    bound_kinds.add(kind)
                    for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                        totals[path][key] += n * val
            if dtype == torch.bfloat16:
                by_shape.append({"label": label, "B": b, "H": h, "Hkv": hkv, "D": d, "page_tokens": pt,
                                 "max_pages": max_pages, "lengths": list(lengths), "splits": splits, "ms": t,
                                 "bound_ms": bt, "bound_by": kind, "plain_ms": t_plain, "library_ms": t_lib,
                                 "max_abs_err": err, "ptxas": regs})
            log(f"  {label} B={b} H={h} Hkv={hkv} D={d} pt={pt} pages={max_pages} lengths={list(lengths)} "
                f"{'permuted ' if permuted else ''}{dtype} [{splits} runs; {regs if dtype == torch.bfloat16 else 'f32'}]: "
                f"err {err:.2e} (rms {rms:.2e}) kernel {t:.4f} ms bound {bt:.5f} ms ({kind}, {100 * bt / t:.0f}%) "
                f"plain {t_plain:.4f} ms sdpa {t_lib:.4f} ms (kernel {t / t_lib:.2f}x)")
            if "decode" in calls and dtype == torch.bfloat16 and not t <= MAX_LIBRARY_RATIO * t_lib:
                raise AssertionError(f"paged_attention {label}: {t:.4f} ms > {MAX_LIBRARY_RATIO} x sdpa {t_lib:.4f} ms")
            del q, pool_k, pool_v, k_seq, v_seq, out, ref
    return {
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:69",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
        "extra": {"by_shape": by_shape},
    }


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@contextlib.contextmanager
def kernel_plain_attend():
    """``attend`` on the CPU as the flash_attention kernel's plain version
    (f32 scores and probabilities) instead of the copy of the JAX package's,
    which rounds them to bf16; by the positions it is given, as the kernel
    masks the VLM's."""
    import repro_torch.models.layers as layers
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def attend(q, k, v, *, causal, window=None, q_positions=None, kv_positions=None, **_):
        return attention_ref(q, k, v, causal=causal, window=window or 0, q_positions=q_positions,
                             kv_positions=kv_positions)

    saved = layers.attend
    layers.attend = attend
    try:
        yield
    finally:
        layers.attend = saved


def check_model_against_cpu(torch, dev):
    """qwen3-1.7b at full width, 2 layers, S = 64: logits of the kernel path
    on the card against the plain path on the CPU, from the same weights.

    Gated at the tolerance: (1) bf16, the CPU taking each kernel's plain
    version (``stream_matmul_ref``, ``attention_ref``), the same arithmetic up
    to summation order; (2) the same weights in f32, where bf16 rounding
    cannot hide or amplify a difference. Reported: (3) bf16 against the CPU
    ``forward`` as it runs there, whose ``attend`` (a copy of the JAX
    package's) rounds scores and probabilities to bf16 where the kernel keeps
    f32."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(0))
    batch_card, batch_cpu = {"tokens": tokens.to(dev)}, {"tokens": tokens}
    t0 = time.perf_counter()

    with torch.inference_mode():
        on_card = fns.forward(params, batch_card).cpu()
        cpu_params = tree_map(lambda t: t.cpu(), params)
        with kernel_plain_attend():
            kernels_plain = fns.forward(cpu_params, batch_cpu)
        cpu_forward = fns.forward(cpu_params, batch_cpu)
        f32_card = fns.forward(tree_map(lambda t: t.float(), params), batch_card).cpu()
        f32_cpu = fns.forward(tree_map(lambda t: t.float(), cpu_params), batch_cpu)
    for out in (on_card, f32_card):
        if out.shape != (1, 64, cfg.vocab_size) or not torch.isfinite(out.float()).all():
            raise AssertionError(f"model: logits {tuple(out.shape)} not finite / wrong shape")
    err = max_err(torch, on_card, kernels_plain)
    err32 = max_err(torch, f32_card, f32_cpu)
    diff = (on_card.float() - cpu_forward.float()).abs()
    beyond = int((diff > TOL + TOL * cpu_forward.float().abs()).sum())
    log(f"model qwen3-1.7b full width, 2 layers, S=64, |logits| max "
        f"{float(kernels_plain.float().abs().max()):.2f} ({time.perf_counter() - t0:.1f} s):")
    log(f"  bf16 card kernels vs CPU plain kernels: max abs err {err:.3e}")
    log(f"  f32  card kernels vs CPU plain forward: max abs err {err32:.3e}")
    log(f"  bf16 card kernels vs CPU forward (bf16 attend): max abs err {float(diff.max()):.3e}, "
        f"{beyond} of {diff.numel()} beyond rtol=atol={TOL} (reported, not gated)")
    return {"bf16_err": err, "f32_err": err32, "bf16_vs_attend_err": float(diff.max()),
            "bf16_vs_attend_beyond": beyond}


def check_decode_against_cpu(torch, dev):
    """qwen3-1.7b at full width, 2 layers: prefill 64 tokens into a cache of
    68 slots, then 4 decode steps, on the card and on the CPU from the same
    weights. Gated: the card's logits (prefill's last and each step's)
    against the CPU taking the kernels' plain versions, at the tolerance as in
    phase 4; on the card, the same logits against ``forward`` over the same
    68 tokens, at the reference's decode tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(dev).manual_seed(0))
    b, s, n = 2, 64, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n), generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()

    def prefill_decode(params, tokens):
        logits, cache = fns.prefill(params, {"tokens": tokens[:, :s]}, max_seq=s + n)
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(params, cache, {"tokens": tokens[:, s + i : s + i + 1]})
            outs.append(logits)
        if int(cache["index"]) != s + n:
            raise AssertionError(f"decode: index {int(cache['index'])} != {s + n}")
        return torch.cat(outs, dim=1)  # positions s-1 .. s+n-1

    with torch.inference_mode():
        on_card = prefill_decode(params, tokens.to(dev))
        forward_card = fns.forward(params, {"tokens": tokens.to(dev)})[:, s - 1 :]
        with kernel_plain_attend():
            on_cpu = prefill_decode(tree_map(lambda t: t.cpu(), params), tokens)
    if on_card.shape != (b, n + 1, cfg.vocab_size) or not torch.isfinite(on_card.float()).all():
        raise AssertionError(f"decode: logits {tuple(on_card.shape)} not finite / wrong shape")
    on_card = on_card.cpu()
    err = max_err(torch, on_card, on_cpu)
    forward_card = forward_card.cpu()
    torch.testing.assert_close(on_card.float(), forward_card.float(), rtol=DECODE_TOL, atol=DECODE_TOL)
    err_fwd = float((on_card.float() - forward_card.float()).abs().max())
    log(f"decode qwen3-1.7b full width, 2 layers, B={b}, prefill {s} + {n} steps "
        f"({time.perf_counter() - t0:.1f} s):")
    log(f"  card kernels vs CPU plain kernels: max abs err {err:.3e} (rtol=atol={TOL})")
    log(f"  card decode vs card forward: max abs err {err_fwd:.3e} (rtol=atol={DECODE_TOL})")
    return {"err": err, "err_forward": err_fwd}


def check_ssm_against_cpu(torch, dev):
    """mamba2-1.3b at full width, 2 layers, from the same weights on the card
    and on the CPU (where stream_matmul is its plain version; the scan is the
    same PyTorch on both). Gated at the tolerance: ``forward`` at S = 64 in
    bf16 and in f32, and the logits of a prefill of 64 tokens and 4 decode
    steps at B = 2; at the reference's decode tolerance, the card's decode
    against the card's ``forward`` over the same 68 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(dev).manual_seed(0))
    b, s, n = 2, 64, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n), generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()

    def prefill_decode(params, tokens):
        logits, cache = fns.prefill(params, {"tokens": tokens[:, :s]})
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(params, cache, {"tokens": tokens[:, s + i : s + i + 1]})
            outs.append(logits)
        if int(cache["index"]) != s + n:
            raise AssertionError(f"ssm decode: index {int(cache['index'])} != {s + n}")
        return torch.cat(outs, dim=1)  # positions s-1 .. s+n-1

    with torch.inference_mode():
        cpu_params = tree_map(lambda t: t.cpu(), params)
        fwd_card = fns.forward(params, {"tokens": tokens.to(dev)})
        fwd_cpu = fns.forward(cpu_params, {"tokens": tokens})
        f32_card = fns.forward(tree_map(lambda t: t.float(), params), {"tokens": tokens[:1, :s].to(dev)})
        f32_cpu = fns.forward(tree_map(lambda t: t.float(), cpu_params), {"tokens": tokens[:1, :s]})
        dec_card = prefill_decode(params, tokens.to(dev))
        dec_cpu = prefill_decode(cpu_params, tokens)
    for out in (fwd_card, dec_card):
        if not torch.isfinite(out.float()).all():
            raise AssertionError("ssm: logits not finite")
    if fwd_card.shape != (b, s + n, cfg.vocab_size) or dec_card.shape != (b, n + 1, cfg.vocab_size):
        raise AssertionError(f"ssm: logits {tuple(fwd_card.shape)}, {tuple(dec_card.shape)}")
    fwd_card, dec_card = fwd_card.cpu(), dec_card.cpu()
    err = max_err(torch, fwd_card, fwd_cpu)
    err32 = max_err(torch, f32_card.cpu(), f32_cpu)
    err_dec = max_err(torch, dec_card, dec_cpu)
    torch.testing.assert_close(dec_card.float(), fwd_card[:, s - 1 :].float(), rtol=DECODE_TOL, atol=DECODE_TOL)
    err_fwd = float((dec_card.float() - fwd_card[:, s - 1 :].float()).abs().max())
    log(f"model mamba2-1.3b full width, 2 layers, B={b}, S={s + n}, prefill {s} + {n} steps "
        f"({time.perf_counter() - t0:.1f} s):")
    log(f"  forward bf16 card vs CPU: max abs err {err:.3e}; f32: {err32:.3e} (rtol=atol={TOL})")
    log(f"  prefill + decode card vs CPU: max abs err {err_dec:.3e} (rtol=atol={TOL})")
    log(f"  card decode vs card forward: max abs err {err_fwd:.3e} (rtol=atol={DECODE_TOL})")
    return {"err": err, "f32_err": err32, "decode_err": err_dec, "err_forward": err_fwd}


def serve_slice(torch, dev, archs=ARCHS, label="serve"):
    """Phase 5 (and phase 6d with the hybrid beside the live set): ``archs``
    at full width served under 150% oversubscription; returns the run's
    launches, its steps and its tensor-core launches."""
    from repro_torch.runtime.serve_loop import MultiModelServer, Request

    t0 = time.perf_counter()
    server = MultiModelServer(archs, device=dev, full=True, page_size=PAGE_SIZE)
    rt = server.runtime
    tasks = list(rt.tasks.values())
    footprint = sum(t.footprint_bytes() for t in tasks)
    budget = rt.pool.capacity * rt.page_size
    log(f"{label}: {len(tasks)} models at full width, footprint {footprint / 1e9:.3f} GB, "
        f"budget {budget / 1e9:.3f} GB ({100 * footprint / budget:.0f}%), page {PAGE_SIZE} B, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    # time every residency sync (the runtime's copies are synchronous), split
    # into those of the proactive switch and those of demand faults
    syncs = []  # (demand fault?, seconds, bytes in, bytes out)
    in_fault = [False]
    sync, fault_in = rt._sync_residency, rt._fault_in

    def timed_sync():
        b_in, b_out = rt.stats.migrated_in_bytes, rt.stats.migrated_out_bytes
        s0 = time.perf_counter()
        sync()
        syncs.append((in_fault[0], time.perf_counter() - s0,
                      rt.stats.migrated_in_bytes - b_in, rt.stats.migrated_out_bytes - b_out))

    def tagged_fault_in(task):
        in_fault[0] = True
        try:
            fault_in(task)
        finally:
            in_fault[0] = False

    rt._sync_residency, rt._fault_in = timed_sync, tagged_fault_in

    # record each step's logits and its time (synchronised) inside the served run
    outputs = {t.task_id: [] for t in tasks}
    step_s = {t.task_id: [] for t in tasks}
    for t in tasks:
        def timed(i, t=t, step=t.run_step):
            torch.cuda.synchronize(dev)
            s0 = time.perf_counter()
            out = step(i)
            torch.cuda.synchronize(dev)
            step_s[t.task_id].append(time.perf_counter() - s0)
            outputs[t.task_id].append((i, out))
            return out
        t.run_step = timed

    zero_launches()
    for i in range(REQUESTS_PER_MODEL * len(tasks)):
        server.submit(Request(model=i % len(tasks), arrival_s=time.perf_counter()))
    t0 = time.perf_counter()
    stats = server.serve(wall_budget_s=600.0)
    serve_s = time.perf_counter() - t0
    launches, wgmma = read_launches(), read_wgmma()
    for t in tasks:
        del t.run_step
    del rt._sync_residency, rt._fault_in

    steps = sum(rt.stats.steps.values())
    ls = rt.stats
    log(f"{label}: {serve_s:.2f} s, served {stats.served}, "
        f"p99 {[f'{1e3 * stats.p99(m):.1f} ms' for m in stats.served]}, steps {ls.steps}")
    log(f"{label}: migrated_in {ls.migrated_in_bytes} B, migrated_out {ls.migrated_out_bytes} B, "
        f"demand_faults {ls.demand_faults}, switches {len(ls.switch_wall_s)}")
    log(f"{label}: per-switch coordinator wall {[f'{1e3 * s:.2f}' for s in ls.coordinator_wall_s]} ms; "
        f"per-switch plan+copies {[f'{1e3 * s:.1f}' for s in ls.switch_wall_s]} ms")
    for fault, kind in ((False, "switch syncs"), (True, "demand-fault syncs")):
        sel = [x for x in syncs if x[0] == fault]
        secs = sum(x[1] for x in sel)
        b_in, b_out = sum(x[2] for x in sel), sum(x[3] for x in sel)
        rate = (b_in + b_out) / secs / 1e9 if secs else 0.0
        log(f"{label}: {kind}: {len(sel)} calls, {secs:.3f} s, in {b_in} B, out {b_out} B, "
            f"{rate:.2f} GB/s (synchronous pinned copies, page walk included)")
    for t in tasks:
        wbytes = sum(s.nbytes for s in t.segments)
        med = statistics.median(step_s[t.task_id])
        log(f"{label}: {t.cfg.name} step median {1e3 * med:.3f} ms over {len(step_s[t.task_id])} steps, "
            f"weight-bytes bound {1e3 * wbytes / HBM_BYTES_PER_S:.3f} ms ({wbytes} B)")
    log(f"{label}: launches {launches} over {steps} steps")

    if stats.served != {t.task_id: REQUESTS_PER_MODEL for t in tasks} or any(server.queues.values()):
        raise AssertionError(f"not every request was served: {stats.served}")
    if not (ls.migrated_in_bytes > 0 and ls.migrated_out_bytes > 0):
        raise AssertionError("no real migration in both directions")
    # the live step is a forward: 197 stream_matmul and 28 flash_attention
    # for each dense model at its published depth, 97 stream_matmul for
    # mamba2, 293 and 12 for recurrentgemma-9b, no paged_attention and no
    # int8 kernel
    want = {name: sum(step_launches(t.cfg, "serve")[name] * ls.steps[t.task_id] for t in tasks)
            for name in KERNELS}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if any(wgmma.values()):
        raise AssertionError(f"live steps took the tensor-core route: {wgmma}")

    # the same steps all-resident give the same bits
    for t in tasks:
        for s in t.segments:
            if s.device is None:
                s.device = s.host.to(dev)
        for i, out in outputs[t.task_id]:
            again = t.run_step(i)
            if not torch.equal(again, out) or not torch.isfinite(out.float()).all():
                raise AssertionError(f"{t.cfg.name} step {i}: oversubscribed != all-resident")
    log(f"{label}: {sum(len(v) for v in outputs.values())} oversubscribed steps bit-identical to all-resident")
    for t in tasks:
        profile_steps(torch, dev, t.cfg.name, t.run_step, statistics.median(step_s[t.task_id]))
    return launches, steps, wgmma


def profile_steps(torch, dev, name: str, step, step_wall_s: float, n: int = 3, top: int = 4) -> None:
    """Device time of ``n`` calls ``step(i)`` from torch.profiler, against
    the median step wall time of the timed run (taken without the profiler,
    whose own host cost would inflate the wall): the device's idle share,
    and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6 / n
    if busy_s == 0:
        log(f"profile: {name} device time not measured (the profiler saw no kernel)")
        return
    heavy = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    log(f"profile: {name} device busy {1e3 * busy_s:.3f} ms a step; of a "
        f"{1e3 * step_wall_s:.3f} ms step the device idles {100 * (1 - busy_s / step_wall_s):.1f}%; "
        "top kernels (ms a step): " + ", ".join(
            f"{e.key[:48]} {e.self_device_time_total * 1e-3 / n:.3f}" for e in heavy))


def decode_slice(torch, dev):
    """Phase 6, the decode path of every model at its published widths and
    depths, random weights from a seed. Returns each path's launches and
    steps and tensor-core launches: {"prefill": (launches, prefills, wgmma),
    "decode": (launches, steps, wgmma)}; and, by "prefill <arch>", the most
    the card's allocator held from before the parameters were made to the
    end of the prefill (the parameters, the prompts and the prefill's
    peak), which phase 9d holds against the dry-run's count."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import flatten
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    paths = {path: ({name: 0 for name in KERNELS}, 0, {name: 0 for name in WGMMA_KERNELS})
             for path in ("prefill", "decode")}
    peaks = {}

    def add(path, launches, wgmma):
        total, n, total_wgmma = paths[path]
        paths[path] = ({k: total[k] + launches[k] for k in total}, n + 1,
                       {k: total_wgmma[k] + wgmma[k] for k in total_wgmma})

    for seed, arch in enumerate(ARCHS):
        cfg = get_config(arch)
        dense = cfg.family == "dense"
        fns = build_model(cfg)
        prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
        with torch.inference_mode():
            torch.cuda.synchronize(dev)
            start = torch.cuda.memory_allocated(dev)
            params = fns.init(torch.Generator(dev).manual_seed(seed))
            prompts = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT), device=dev,
                                    generator=torch.Generator(dev).manual_seed(100 + seed))
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_launches()
            t0 = time.perf_counter()
            logits, cache = prefill_step(params, {"tokens": prompts}, max_seq=DECODE_SMAX)
            torch.cuda.synchronize(dev)
            prefill_s = time.perf_counter() - t0
            peaks[f"prefill {arch}"] = torch.cuda.max_memory_allocated(dev) - start
            prefill_launches, prefill_wgmma = read_launches(), read_wgmma()
            want = step_launches(cfg, "prefill")
            if prefill_launches != want:
                raise AssertionError(f"{arch} prefill: launches {prefill_launches} != {want}")
            if prefill_wgmma != step_wgmma(cfg, "prefill"):
                raise AssertionError(f"{arch} prefill: tensor-core launches {prefill_wgmma} "
                                     f"!= {step_wgmma(cfg, 'prefill')}")
            add("prefill", prefill_launches, prefill_wgmma)

            want = step_launches(cfg, "decode")
            outs, fed, step_s = [logits], [], []
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(DECODE_STEPS):
                zero_launches()
                t0 = time.perf_counter()
                logits, cache = serve_step(params, cache, {"tokens": tok})
                torch.cuda.synchronize(dev)
                step_s.append(time.perf_counter() - t0)
                launches, wgmma = read_launches(), read_wgmma()
                if launches != want or any(wgmma.values()):
                    raise AssertionError(f"{arch} decode step {i}: launches {launches} != {want} "
                                         f"or tensor-core launches {wgmma}")
                add("decode", launches, wgmma)
                fed.append(tok)
                outs.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            if int(cache["index"]) != DECODE_SMAX or cache["host_index"] != DECODE_SMAX:
                raise AssertionError(f"{arch}: index {int(cache['index'])} != {DECODE_SMAX}")

            decoded = torch.cat(outs, dim=1).float()  # positions PROMPT-1 .. DECODE_SMAX-1
            if not torch.isfinite(decoded).all():
                raise AssertionError(f"{arch}: decode logits not finite")
            t0 = time.perf_counter()
            full = fns.forward(params, {"tokens": torch.cat([prompts] + fed, dim=1)})
            ref = full[:, PROMPT - 1 :].float()
            del full
            forward_s = time.perf_counter() - t0
            rel = float((decoded - ref).norm() / ref.norm())
            per_step = ((decoded - ref).norm(dim=(0, 2)) / ref.norm(dim=(0, 2))).tolist()
            del decoded, ref

            leaves = flatten(params)
            weight_bytes = sum(t.nbytes for p, t in leaves if p != "head/embed")
            weight_bytes += DECODE_B * cfg.d_model * params["head"]["embed"].element_size()  # rows a step reads
            med = statistics.median(step_s)
            if dense:
                elem = cache["k"].element_size()
                kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim() * elem
                med_len = statistics.median(range(PROMPT + 1, DECODE_SMAX + 1))
                cache_bytes = cache["k"].nbytes + cache["v"].nbytes
                step_cache = kv_row * DECODE_B * (med_len + 1)  # reads, then the new slot
                what = f"KV at length {med_len}"
                gate, worst = DECODE_REL_L2, rel
            else:
                cache_bytes = cache["state"].nbytes + cache["conv"].nbytes
                step_cache = 2 * cache_bytes  # state and conv history read and written
                what = "state + conv read and written"
                gate, worst = SSM_DECODE_REL_L2, rel
            step_bytes = weight_bytes + step_cache
            log(f"decode slice {arch}: B={DECODE_B}, prompt {PROMPT}, {DECODE_STEPS} greedy steps, "
                f"cache {cache_bytes} B" + (f" ({DECODE_SMAX} slots)" if dense else " (constant size)"))
            log(f"  prefill {1e3 * prefill_s:.3f} ms, {DECODE_B * PROMPT / prefill_s:.1f} tokens/s; "
                f"launches {prefill_launches}, tensor-core {prefill_wgmma}")
            log(f"  decode step median {1e3 * med:.3f} ms (min {1e3 * min(step_s):.3f}, max "
                f"{1e3 * max(step_s):.3f}), bound {1e3 * step_bytes / HBM_BYTES_PER_S:.3f} ms "
                f"({weight_bytes} B weights + {step_cache:.0f} B {what}); "
                f"{DECODE_B / med:.1f} tokens/s at the median, {DECODE_B * DECODE_STEPS / sum(step_s):.1f} "
                f"over the {DECODE_STEPS} steps")
            log(f"  decode vs forward over the same {DECODE_SMAX} tokens ({1e3 * forward_s:.0f} ms): "
                f"relative L2 {rel:.3e} (gate {gate}); "
                f"per position max {max(per_step):.3e}, first {per_step[0]:.3e}, last {per_step[-1]:.3e}")
            if not worst <= gate:
                raise AssertionError(f"{arch}: decode vs forward relative L2 {worst:.3e} > {gate}")
            if not dense:
                ssm_decode_f32(torch, cfg, params, prompts, fed)

            # 3 steps under the profiler, feeding the last 3 tokens again: the
            # dense cache is rewound by 3 slots (the same k/v land in the same
            # slots); the SSM cache has a constant size and just goes on
            if dense:
                cache["index"] = torch.tensor(DECODE_SMAX - 3, dtype=torch.int32, device=dev)
                cache["host_index"] = DECODE_SMAX - 3
            state = {"cache": cache}

            def step(i):
                tokens = fed[DECODE_STEPS - 3 + i]
                _, state["cache"] = serve_step(params, state["cache"], {"tokens": tokens})

            profile_steps(torch, dev, f"{arch} decode", step, med)
            del params, cache, state, outs, fed, logits
        torch.cuda.empty_cache()
    return paths, peaks


def ssm_decode_f32(torch, cfg, params, prompts, fed):
    """The SSM decode path again with the same weights in f32: prefill of the
    same prompts, the same fed tokens decoded, against one f32 ``forward``
    over all of them, gated at SSM_DECODE_REL_L2_F32. Its launches are not
    counted on any path."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg32)(p32, {"tokens": prompts})
    outs = [logits]
    serve_step = make_serve_step(cfg32)
    for tok in fed:
        logits, cache = serve_step(p32, cache, {"tokens": tok})
        outs.append(logits)
    decoded = torch.cat(outs, dim=1)
    ref = build_model(cfg32).forward(p32, {"tokens": torch.cat([prompts] + fed, dim=1)})[:, PROMPT - 1 :]
    rel = float((decoded - ref).norm() / ref.norm())
    del p32, cache, outs, decoded, ref
    log(f"  f32 weights, the same tokens: decode vs forward relative L2 {rel:.3e} "
        f"(gate {SSM_DECODE_REL_L2_F32}; {time.perf_counter() - t0:.1f} s)")
    if not rel <= SSM_DECODE_REL_L2_F32:
        raise AssertionError(f"{cfg.name} f32: decode vs forward relative L2 {rel:.3e} > {SSM_DECODE_REL_L2_F32}")


def families_batch(cfg, b, s, seed, device, kind="prefill"):
    """The reference's batch of ``b`` x ``s`` positions for the model's family
    (``make_concrete_batch``): tokens; for the VLM family 1/8 of them vision
    embeddings ahead of the tokens, at Qwen2-VL's M-RoPE positions
    (:func:`vlm_positions`: the image's patches share temporal position 0,
    so the attention's mask is not the index's); for the audio family frames
    with a 30% frame mask."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import make_concrete_batch

    batch = make_concrete_batch(cfg, ShapeSpec(f"{cfg.name} {b}x{s}", s, b, kind), seed=seed, device=device)
    if cfg.family == "vlm":
        batch["positions3"] = vlm_positions(torch, b, s, device)
    return batch


def check_families_against_cpu(torch, dev):
    """Phase 6b, first part: minicpm-2b, qwen2-vl-7b and hubert-xlarge at
    full width, 2 layers, from the same weights on the card and on the CPU.
    Gated at the tolerance, as phase 4 does for qwen3: ``forward`` over 2 x
    64 positions in bf16 against the CPU taking the kernels' plain versions,
    and in f32; for the two decode models also a prefill of 64 positions and
    4 decode steps. Reported: bf16 against the CPU ``forward`` as it runs
    there (its ``attend`` rounds scores and probabilities to bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    results = {}
    for seed, arch in enumerate(FAMILY_ARCHS):
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        fns = build_model(cfg)
        params = fns.init(torch.Generator(dev).manual_seed(seed))
        b, s, n = 2, 64, 4
        batch = families_batch(cfg, b, s, 200 + seed, "cpu")
        tokens = torch.randint(1, cfg.vocab_size, (b, n), generator=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()

        def to(batch, device):
            return {k: v.to(device) for k, v in batch.items()}

        def prefill_decode(params, device):
            logits, cache = fns.prefill(params, to(batch, device), max_seq=s + n)
            outs = [logits]
            for i in range(n):
                logits, cache = fns.decode_step(params, cache, {"tokens": tokens[:, i : i + 1].to(device)})
                outs.append(logits)
            if int(cache["index"]) != s + n:
                raise AssertionError(f"{arch} decode: index {int(cache['index'])} != {s + n}")
            return torch.cat(outs, dim=1)

        with torch.inference_mode():
            on_card = fns.forward(params, to(batch, dev)).cpu()
            cpu_params = tree_map(lambda t: t.cpu(), params)
            with kernel_plain_attend():
                kernels_plain = fns.forward(cpu_params, batch)
                dec_cpu = prefill_decode(cpu_params, "cpu") if cfg.has_decode else None
            cpu_forward = fns.forward(cpu_params, batch)
            dec_card = prefill_decode(params, dev).cpu() if cfg.has_decode else None
            f32_batch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
            f32_card = fns.forward(tree_map(lambda t: t.float(), params), to(f32_batch, dev)).cpu()
            f32_cpu = fns.forward(tree_map(lambda t: t.float(), cpu_params), f32_batch)
            del params, cpu_params
        for out in (on_card, f32_card):
            if out.shape != (b, s, cfg.vocab_size) or not torch.isfinite(out.float()).all():
                raise AssertionError(f"{arch}: logits {tuple(out.shape)} not finite / wrong shape")
        err = max_err(torch, on_card, kernels_plain)
        err32 = max_err(torch, f32_card, f32_cpu)
        diff = (on_card.float() - cpu_forward.float()).abs()
        beyond = int((diff > TOL + TOL * cpu_forward.float().abs()).sum())
        log(f"model {arch} full width, 2 layers, B={b}, S={s} ({time.perf_counter() - t0:.1f} s):")
        log(f"  bf16 card kernels vs CPU plain kernels: max abs err {err:.3e}; f32: {err32:.3e} (rtol=atol={TOL})")
        results[arch] = {"bf16_err": err, "f32_err": err32, "bf16_vs_attend_err": float(diff.max()),
                         "bf16_vs_attend_beyond": beyond}
        if dec_card is not None:
            err_dec = max_err(torch, dec_card, dec_cpu)
            results[arch]["decode_err"] = err_dec
            log(f"  prefill {s} + {n} decode steps, card vs CPU plain kernels: max abs err {err_dec:.3e}")
        log(f"  bf16 card kernels vs CPU forward (bf16 attend): max abs err {float(diff.max()):.3e}, "
            f"{beyond} of {diff.numel()} beyond rtol=atol={TOL} (reported, not gated)")
        torch.cuda.empty_cache()
    return results


def families_slice(torch, dev):
    """Phase 6b: minicpm-2b, qwen2-vl-7b and hubert-xlarge at their published
    widths and depths, random weights from a seed, one model at a time. The
    two decode models prefill DECODE_B x PROMPT positions (qwen2-vl-7b: 1/8
    vision embeddings) and decode DECODE_STEPS greedy steps, gated against one
    ``forward`` over the same positions; hubert-xlarge runs ``forward`` over
    DECODE_B x PROMPT masked frames. Every call's launches are gated exactly,
    the tied head's K-major ones too. Returns the path's launches, its steps
    (one a prefill, a decode step or hubert's forward) and its tensor-core
    launches, and the K-major launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import flatten
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    total = ({name: 0 for name in KERNELS}, 0, {name: 0 for name in WGMMA_KERNELS})
    nk_total = [0]

    def gated(what, cfg, path, run):
        """Runs ``run`` with every count at 0 and gates its launches; returns
        its output, its launches and its tensor-core launches."""
        torch.cuda.synchronize(dev)
        zero_launches()
        nk0 = counters()["stream_matmul"][0].nk_launches
        out = run()
        torch.cuda.synchronize(dev)
        launches, wgmma, by_pos = read_launches(), read_wgmma(), read_positions()
        nk = counters()["stream_matmul"][0].nk_launches - nk0
        want, want_wgmma = step_launches(cfg, path), step_wgmma(cfg, path)
        if (launches != want or wgmma != want_wgmma or nk != step_nk(cfg)
                or by_pos != step_positions(cfg, path)):
            raise AssertionError(f"{what}: launches {launches}, tensor-core {wgmma}, K-major {nk}, by positions "
                                 f"{by_pos}; want {want}, {want_wgmma}, {step_nk(cfg)}, {step_positions(cfg, path)}")
        return out, launches, wgmma, nk

    def add(launches, wgmma, nk):
        nonlocal total
        counts, n, counts_wgmma = total
        total = ({k: counts[k] + launches[k] for k in counts}, n + 1,
                 {k: counts_wgmma[k] + wgmma[k] for k in counts_wgmma})
        nk_total[0] += nk

    for seed, arch in enumerate(FAMILY_ARCHS):
        cfg = get_config(arch)
        fns = build_model(cfg)
        with torch.inference_mode():
            t0 = time.perf_counter()
            params = fns.init(torch.Generator(dev).manual_seed(300 + seed))
            batch = families_batch(cfg, DECODE_B, PROMPT, 400 + seed, dev)
            torch.cuda.synchronize(dev)
            leaves = flatten(params)
            log(f"families {arch}: {cfg.num_layers} layers, d {cfg.d_model}, V {cfg.vocab_size}, "
                f"{sum(t.nbytes for _, t in leaves)} B of weights, set-up {time.perf_counter() - t0:.1f} s")
            if not cfg.has_decode:
                # the encoder: one forward over the masked frames
                t0 = time.perf_counter()
                logits, launches, wgmma, nk = gated(f"{arch} forward", cfg, "forward",
                                                    lambda: fns.forward(params, batch))
                forward_s = time.perf_counter() - t0
                add(launches, wgmma, nk)
                if logits.shape != (DECODE_B, PROMPT, cfg.vocab_size) or not torch.isfinite(logits.float()).all():
                    raise AssertionError(f"{arch}: forward logits {tuple(logits.shape)} not finite / wrong shape")
                log(f"  forward over {DECODE_B} x {PROMPT} frames ({int(batch['frame_mask'].sum())} masked): "
                    f"{1e3 * forward_s:.3f} ms, {DECODE_B * PROMPT / forward_s:.1f} frames/s; launches {launches}, "
                    f"tensor-core {wgmma}")
                profile_steps(torch, dev, f"{arch} forward", lambda i: fns.forward(params, batch), forward_s)
                del params, batch, logits
                torch.cuda.empty_cache()
                continue

            prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
            t0 = time.perf_counter()
            (logits, cache), launches, wgmma, nk = gated(
                f"{arch} prefill", cfg, "prefill", lambda: prefill_step(params, batch, max_seq=DECODE_SMAX))
            prefill_s = time.perf_counter() - t0
            add(launches, wgmma, nk)
            if cache["host_index"] != PROMPT:
                raise AssertionError(f"{arch}: prefill index {cache['host_index']} != {PROMPT}")
            log(f"  prefill {DECODE_B} x {PROMPT} positions"
                + (f" ({batch['vision_embeds'].shape[1]} vision, {batch['tokens'].shape[1]} text)"
                   if cfg.family == "vlm" else "")
                + f": {1e3 * prefill_s:.3f} ms, {DECODE_B * PROMPT / prefill_s:.1f} tokens/s; launches {launches}, "
                  f"tensor-core {wgmma}, K-major {nk}")

            outs, fed, step_s = [logits], [], []
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(DECODE_STEPS):
                t0 = time.perf_counter()
                (logits, cache), launches, wgmma, nk = gated(
                    f"{arch} decode step {i}", cfg, "decode", lambda: serve_step(params, cache, {"tokens": tok}))
                step_s.append(time.perf_counter() - t0)
                add(launches, wgmma, nk)
                fed.append(tok)
                outs.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            if int(cache["index"]) != DECODE_SMAX or cache["host_index"] != DECODE_SMAX:
                raise AssertionError(f"{arch}: index {int(cache['index'])} != {DECODE_SMAX}")

            decoded = torch.cat(outs, dim=1).float()  # positions PROMPT-1 .. DECODE_SMAX-1
            if not torch.isfinite(decoded).all():
                raise AssertionError(f"{arch}: decode logits not finite")
            full = dict(batch, tokens=torch.cat([batch["tokens"]] + fed, dim=1))
            if cfg.family == "vlm":  # the prompt's layout, then the decoded tokens at their slots
                decoded_at = torch.arange(PROMPT, DECODE_SMAX, dtype=torch.int32, device=dev)
                full["positions3"] = torch.cat(
                    [batch["positions3"], decoded_at.expand(3, DECODE_B, DECODE_STEPS)], dim=2)
            t0 = time.perf_counter()
            ref, _, fwd_wgmma, _ = gated(f"{arch} forward", cfg, "forward", lambda: fns.forward(params, full))
            forward_s = time.perf_counter() - t0
            ref = ref[:, PROMPT - 1 :].float()
            rel = float((decoded - ref).norm() / ref.norm())
            per_step = ((decoded - ref).norm(dim=(0, 2)) / ref.norm(dim=(0, 2))).tolist()
            del decoded, ref, full

            embed = params["head"]["embed"]
            weight_bytes = sum(t.nbytes for p, t in leaves if p != "head/embed")
            # the tied head reads the whole table a step; else the gather reads DECODE_B rows
            weight_bytes += embed.nbytes if cfg.tie_embeddings else DECODE_B * cfg.d_model * embed.element_size()
            kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim() * cache["k"].element_size()
            med_len = statistics.median(range(PROMPT + 1, DECODE_SMAX + 1))
            step_cache = kv_row * DECODE_B * (med_len + 1)
            med = statistics.median(step_s)
            log(f"  decode step median {1e3 * med:.3f} ms (min {1e3 * min(step_s):.3f}, max "
                f"{1e3 * max(step_s):.3f}), bound {1e3 * (weight_bytes + step_cache) / HBM_BYTES_PER_S:.3f} ms "
                f"({weight_bytes} B weights + {step_cache:.0f} B KV at length {med_len}); "
                f"{DECODE_B / med:.1f} tokens/s at the median")
            log(f"  decode vs forward over the same {DECODE_SMAX} positions ({1e3 * forward_s:.0f} ms; "
                f"tensor-core {fwd_wgmma}): relative L2 {rel:.3e} (gate {DECODE_REL_L2}); per position max "
                f"{max(per_step):.3e}, first {per_step[0]:.3e}, last {per_step[-1]:.3e}")
            if not rel <= DECODE_REL_L2:
                raise AssertionError(f"{arch}: decode vs forward relative L2 {rel:.3e} > {DECODE_REL_L2}")

            # 3 steps under the profiler, the cache rewound by 3 slots (the same
            # k/v land in the same slots)
            cache["index"] = torch.tensor(DECODE_SMAX - 3, dtype=torch.int32, device=dev)
            cache["host_index"] = DECODE_SMAX - 3
            state = {"cache": cache}

            def step(i):
                _, state["cache"] = serve_step(params, state["cache"], {"tokens": fed[DECODE_STEPS - 3 + i]})

            profile_steps(torch, dev, f"{arch} decode", step, med)
            del params, cache, state, outs, fed, logits, batch, leaves, embed
        torch.cuda.empty_cache()
    launches, steps, wgmma = total
    log(f"families path: launches {launches} over {steps} calls, tensor-core {wgmma}, K-major {nk_total[0]}")
    return (launches, steps, wgmma), nk_total[0]


@contextlib.contextmanager
def moe_routing(calls):
    """Records the router logits (n, E) f32 of every MoE layer the model runs
    into ``calls``, in call order; adds no launch and no sync."""
    import repro_torch.models.model as model_mod

    real = model_mod.moe_apply

    def record(p, h, cfg):
        out, logits = real(p, h, cfg)
        calls.append(logits)
        return out, logits

    model_mod.moe_apply = record
    try:
        yield calls
    finally:
        model_mod.moe_apply = real


def top_k_sets(torch, logits, k):
    """Each token's top-k experts as a sorted set (n, k)."""
    return torch.sort(torch.topk(logits.float(), k, dim=-1).indices, dim=-1).values


def to_f32_in_place(torch, tree):
    """Every floating leaf of ``tree`` in f32, one leaf at a time, each bf16
    leaf dropped as its copy lands: peak memory is the f32 tree plus one leaf."""
    for key, val in tree.items():
        if isinstance(val, dict):
            to_f32_in_place(torch, val)
        elif val.is_floating_point():
            tree[key] = val.float()
            del val


def moe_decode_vs_forward(torch, fns, params, tokens):
    """Prefill of all but the last 4 tokens, then 4 decode steps, against one
    ``forward`` over all of them: relative L2 over the 5 positions."""
    s = tokens.shape[1]
    logits, cache = fns.prefill(params, {"tokens": tokens[:, : s - 4]}, max_seq=s)
    outs = [logits]
    for i in range(4):
        logits, cache = fns.decode_step(params, cache, {"tokens": tokens[:, s - 4 + i : s - 3 + i]})
        outs.append(logits)
    got = torch.cat(outs, dim=1).float()
    ref = fns.forward(params, {"tokens": tokens})[:, s - 5 :].float()
    return float((got - ref).norm() / ref.norm())


def check_moe_against_cpu(torch, dev):
    """Phase 6c, first part: each MoE model at published width, at
    MOE_F32_DEPTHS layers, from one set of weights. In f32 (gated): the card
    against the CPU taking the kernels' plain versions, ``forward`` over
    MOE_CHECK_B x MOE_CHECK_S tokens at the published capacity factor: every
    token's top-k set equal in every layer, relative L2 <= MOE_F32_REL_L2; and
    on the card, decode against ``forward`` over MOE_DEC_B x MOE_DEC_S tokens
    at a capacity factor of E / k, where no path drops a token (at the
    published 1.25 the capacity follows the token count, so a prefill, a
    decode step and a forward drop different tokens, in the reference too),
    at the same relative L2. In bf16 (reported): the card's ``forward``
    against its f32 one (relative L2, share of (token, layer) routings that
    differ) and decode against ``forward``. A bf16 rounding of 2^-9 in the
    router's input flips a token's top-k where its k-th and (k+1)-th gates
    are that close, and a flipped expert moves the token by order 1, so bf16
    has no gate here."""
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.models.model import build_model

    gc.collect()  # the served slice's pinned host copies: the host copy of arctic's layer takes 56 GB
    results = {}
    for seed, arch in enumerate(MOE_DEPTHS):
        cfg = moe_config(arch, MOE_F32_DEPTHS[arch])
        m = cfg.moe
        no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))
        t0 = time.perf_counter()
        tokens = torch.randint(1, cfg.vocab_size, (MOE_CHECK_B, MOE_CHECK_S),
                               generator=torch.Generator().manual_seed(600 + seed))
        dec_tokens = torch.randint(1, cfg.vocab_size, (MOE_DEC_B, MOE_DEC_S),
                                   generator=torch.Generator().manual_seed(700 + seed)).to(dev)
        with torch.inference_mode():
            fns = build_model(cfg)
            params = fns.init(torch.Generator(dev).manual_seed(500 + seed))
            with moe_routing([]) as calls16:
                logits16 = fns.forward(params, {"tokens": tokens.to(dev)}).float()
            dec16 = moe_decode_vs_forward(torch, build_model(no_drop), params, dec_tokens)
            to_f32_in_place(torch, params)
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            batched0 = stream_matmul.batched_launches
            with moe_routing([]) as calls32:
                logits32 = build_model(cfg32).forward(params, {"tokens": tokens.to(dev)})
            if stream_matmul.batched_launches - batched0 != 3 * cfg.num_layers:
                raise AssertionError(f"{arch} f32: batched launches {stream_matmul.batched_launches - batched0}")
            no_drop32 = dataclasses.replace(no_drop, dtype="float32")
            dec32 = moe_decode_vs_forward(torch, build_model(no_drop32), params, dec_tokens)
            card_s = time.perf_counter() - t0
            cpu_params = {}
            for path in list(params):  # move to the host leaf by leaf, freeing the card
                cpu_params[path] = tree_map(lambda t: t.cpu(), params.pop(path))
            torch.cuda.empty_cache()
            with kernel_plain_attend(), moe_routing([]) as calls_cpu:
                logits_cpu = build_model(cfg32).forward(cpu_params, {"tokens": tokens})
            del cpu_params
        logits32 = logits32.cpu()
        if not (torch.isfinite(logits32).all() and torch.isfinite(logits16).all()):
            raise AssertionError(f"{arch}: MoE logits not finite")
        rel32 = float((logits32 - logits_cpu).norm() / logits_cpu.norm())
        n_tok = MOE_CHECK_B * MOE_CHECK_S
        sets_card = [top_k_sets(torch, c.cpu(), m.top_k) for c in calls32]
        sets_cpu = [top_k_sets(torch, c, m.top_k) for c in calls_cpu]
        sets16 = [top_k_sets(torch, c.cpu(), m.top_k) for c in calls16]
        routing_diff = sum(int((a != b).any(-1).sum()) for a, b in zip(sets_card, sets_cpu))
        flips16 = sum(int((a != b).any(-1).sum()) for a, b in zip(sets16, sets_card))
        rel16 = float((logits16.cpu() - logits32).norm() / logits32.norm())
        log(f"moe {arch} published width, {cfg.num_layers} layer(s), {m.num_experts} experts top-{m.top_k} "
            f"(card {card_s:.1f} s, total {time.perf_counter() - t0:.1f} s):")
        log(f"  f32 card vs CPU plain kernels, forward over {MOE_CHECK_B} x {MOE_CHECK_S} tokens at capacity "
            f"factor {m.capacity_factor}: relative L2 {rel32:.3e} (gate {MOE_F32_REL_L2}), top-k sets differing in "
            f"{routing_diff} of {n_tok * cfg.num_layers} (token, layer) (gate 0)")
        log(f"  f32 decode vs forward over {MOE_DEC_B} x {MOE_DEC_S} tokens, capacity factor "
            f"{no_drop.moe.capacity_factor} (no drops): relative L2 {dec32:.3e} (gate {MOE_F32_REL_L2})")
        log(f"  bf16 (reported): forward vs the f32 forward relative L2 {rel16:.3e}, routings differing in "
            f"{flips16} of {n_tok * cfg.num_layers} (token, layer); decode vs forward relative L2 {dec16:.3e}")
        if routing_diff or not rel32 <= MOE_F32_REL_L2:
            raise AssertionError(f"{arch} f32 card vs CPU: {routing_diff} routings differ, rel L2 {rel32:.3e}")
        if not dec32 <= MOE_F32_REL_L2:
            raise AssertionError(f"{arch} f32 decode vs forward: relative L2 {dec32:.3e} > {MOE_F32_REL_L2}")
        results[arch] = {"f32_rel_l2": rel32, "f32_decode_rel_l2": dec32, "bf16_rel_l2": rel16,
                         "bf16_routing_flips": flips16, "token_layers": n_tok * cfg.num_layers,
                         "bf16_decode_rel_l2": dec16}
        del params, logits16, logits32, logits_cpu
        torch.cuda.empty_cache()
    return results


def moe_slice(torch, dev):
    """Phase 6c: grok-1-314b and arctic-480b at published width and
    MOE_DEPTHS layers, random weights from a seed, one model at a time: a
    prefill of DECODE_B x PROMPT tokens and DECODE_STEPS greedy decode steps
    at the published capacity factor, each call's launches gated exactly
    (the expert-batched ones too), logits finite. Reported: prefill time
    against its bound (operations or weight bytes, the larger), tokens
    dropped per layer, each decode step's time against the bytes of the
    weights it reads (the experts its tokens hit, counted from the router's
    logits) and the valid K/V, the device's idle share, and decode against
    one ``forward`` over the same tokens (not gated: at capacity factor 1.25
    they drop different tokens). Returns the path's launches, its steps and
    tensor-core launches, and the expert-batched launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import flatten
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.layers import moe_dispatch
    from repro_torch.models.model import build_model

    stream_matmul = counters()["stream_matmul"][0]
    total = ({name: 0 for name in KERNELS}, 0, {name: 0 for name in WGMMA_KERNELS})
    batched_total = narrow_total = 0
    results = {}

    def gated(what, cfg, path, run):
        nonlocal total, batched_total, narrow_total
        torch.cuda.synchronize(dev)
        zero_launches()
        b0 = stream_matmul.batched_launches
        out = run()
        torch.cuda.synchronize(dev)
        launches, wgmma, narrow = read_launches(), read_wgmma(), read_narrow()
        batched = stream_matmul.batched_launches - b0
        want, want_wgmma = step_launches(cfg, path), step_wgmma(cfg, path)
        if launches != want or wgmma != want_wgmma or batched != step_batched(cfg) \
                or narrow != step_narrow(cfg, path):
            raise AssertionError(f"{what}: launches {launches}, tensor-core {wgmma}, batched {batched}, narrow "
                                 f"{narrow}; want {want}, {want_wgmma}, {step_batched(cfg)}, "
                                 f"{step_narrow(cfg, path)}")
        if path != "forward":
            counts, n, counts_wgmma = total
            total = ({k: counts[k] + launches[k] for k in counts}, n + 1,
                     {k: counts_wgmma[k] + wgmma[k] for k in counts_wgmma})
            batched_total += batched
            narrow_total += narrow
        return out, launches, wgmma, batched

    for seed, arch in enumerate(MOE_DEPTHS):
        cfg = moe_config(arch)
        m, d, L = cfg.moe, cfg.d_model, cfg.num_layers
        fns = build_model(cfg)
        prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
        with torch.inference_mode():
            t0 = time.perf_counter()
            params = fns.init(torch.Generator(dev).manual_seed(800 + seed))
            prompts = torch.randint(1, cfg.vocab_size, (DECODE_B, PROMPT), device=dev,
                                    generator=torch.Generator(dev).manual_seed(900 + seed))
            torch.cuda.synchronize(dev)
            leaves = flatten(params)
            weight_bytes = sum(t.nbytes for _, t in leaves)
            log(f"moe {arch}: {L} of {get_config(arch).num_layers} layers, d {d}, {m.num_experts} experts x "
                f"(d_ff {m.d_ff}), top-{m.top_k}, capacity factor {m.capacity_factor}"
                + (f", dense residual d_ff {m.dense_d_ff}" if m.dense_residual else "")
                + f"; {weight_bytes} B of weights, set-up {time.perf_counter() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card")

            t0 = time.perf_counter()
            with moe_routing([]) as prefill_calls:
                (logits, cache), launches, wgmma, batched = gated(
                    f"{arch} prefill", cfg, "prefill", lambda: prefill_step(params, {"tokens": prompts},
                                                                             max_seq=DECODE_SMAX))
            prefill_s = time.perf_counter() - t0
            n = DECODE_B * PROMPT
            dropped = [int((~moe_dispatch(c, m).keep).sum()) for c in prefill_calls]
            kept = [m.top_k * n - x for x in dropped]
            # the prefill's least time: its operations at the bf16 rate, or
            # its weight bytes (every leaf but the embedding table) at the HBM
            # rate, the larger; the attention at causal pairs, the experts
            # over the kept assignments, the router in f32
            hd = cfg.resolved_head_dim()
            attn_ops = 2 * n * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + 2 * n * cfg.num_heads * hd * d
            attn_ops += 4 * DECODE_B * cfg.num_heads * hd * attention_pairs(PROMPT, PROMPT, True, 0)
            dense_ops = 2 * n * 3 * d * m.dense_d_ff if m.dense_residual else 0
            ops = L * (attn_ops + dense_ops) + sum(2 * k_ * 3 * d * m.d_ff for k_ in kept)
            ops += 2 * DECODE_B * d * cfg.vocab_size
            f32_ops = L * 2 * n * d * m.num_experts
            read_bytes = weight_bytes - params["head"]["embed"].nbytes
            t_ops = ops / PEAK_OPS["torch.bfloat16"] * 1e3 + f32_ops / PEAK_OPS["torch.float32"] * 1e3
            t_bytes = read_bytes / HBM_BYTES_PER_S * 1e3
            prefill_bound, prefill_kind = max((t_ops, "operations"), (t_bytes, "bytes"))
            log(f"  prefill {DECODE_B} x {PROMPT} tokens: {1e3 * prefill_s:.3f} ms, {n / prefill_s:.1f} tokens/s, "
                f"bound {prefill_bound:.3f} ms ({prefill_kind}; operations {t_ops:.3f} ms, weight bytes "
                f"{t_bytes:.3f} ms); launches {launches}, tensor-core {wgmma}, expert-batched {batched}")
            log(f"  tokens dropped per layer at prefill (capacity {moe_dispatch(prefill_calls[0], m).cap} of "
                f"{m.top_k * n} assignments over {m.num_experts} experts): {dropped} (reported, not gated)")

            outs, fed, step_s, step_calls = [logits], [], [], []
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(DECODE_STEPS):
                t0 = time.perf_counter()
                with moe_routing([]) as calls:
                    (logits, cache), _, _, _ = gated(f"{arch} decode step {i}", cfg, "decode",
                                                     lambda: serve_step(params, cache, {"tokens": tok}))
                step_s.append(time.perf_counter() - t0)
                step_calls.append(calls)
                fed.append(tok)
                outs.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            if int(cache["index"]) != DECODE_SMAX or cache["host_index"] != DECODE_SMAX:
                raise AssertionError(f"{arch}: index {int(cache['index'])} != {DECODE_SMAX}")
            decoded = torch.cat(outs, dim=1).float()
            if not torch.isfinite(decoded).all():
                raise AssertionError(f"{arch}: decode logits not finite")

            # a step reads every weight but the experts no token hit, DECODE_B
            # rows of the embedding table, and the valid K/V
            expert_bytes = 3 * d * m.d_ff * params["layers"]["moe"]["w1"].element_size()
            all_experts = L * m.num_experts * expert_bytes
            fixed = weight_bytes - params["head"]["embed"].nbytes - all_experts
            fixed += DECODE_B * d * params["head"]["embed"].element_size()
            kv_row = 2 * L * cfg.num_kv_heads * hd * cache["k"].element_size()
            hits, bounds = [], []
            for i, calls in enumerate(step_calls):
                hit = sum(int((moe_dispatch(c, m).rows > 0).sum()) for c in calls)
                kv = kv_row * DECODE_B * (PROMPT + i + 2)  # reads index + 1 slots, writes one
                hits.append(hit)
                bounds.append((fixed + hit * expert_bytes + kv) / HBM_BYTES_PER_S * 1e3)
            med = statistics.median(step_s)
            med_bound = statistics.median(bounds)
            log(f"  decode step median {1e3 * med:.3f} ms (min {1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}), "
                f"bound median {med_bound:.3f} ms (experts hit a step over {L} layers: min {min(hits)}, median "
                f"{statistics.median(hits)}, max {max(hits)} of {L * m.num_experts}; every expert read: "
                f"{(fixed + all_experts) / HBM_BYTES_PER_S * 1e3:.3f} ms); "
                f"{DECODE_B / med:.1f} tokens/s at the median")

            full = torch.cat([prompts] + fed, dim=1)
            t0 = time.perf_counter()
            ref, _, fwd_wgmma, _ = gated(f"{arch} forward", cfg, "forward",
                                         lambda: fns.forward(params, {"tokens": full}))
            forward_s = time.perf_counter() - t0
            ref = ref[:, PROMPT - 1 :].float()
            rel = float((decoded - ref).norm() / ref.norm())
            del decoded, ref
            log(f"  decode vs one forward over the same {DECODE_SMAX} tokens ({1e3 * forward_s:.0f} ms; tensor-core "
                f"{fwd_wgmma}): relative L2 {rel:.3e} (reported, not gated: at capacity factor "
                f"{m.capacity_factor} the capacity follows the token count, so they drop different tokens)")

            cache["index"] = torch.tensor(DECODE_SMAX - 3, dtype=torch.int32, device=dev)
            cache["host_index"] = DECODE_SMAX - 3
            state = {"cache": cache}

            def step(i):
                _, state["cache"] = serve_step(params, state["cache"], {"tokens": fed[DECODE_STEPS - 3 + i]})

            profile_steps(torch, dev, f"{arch} decode", step, med)
            results[arch] = {"prefill_ms": 1e3 * prefill_s, "prefill_bound_ms": prefill_bound,
                             "prefill_bound_by": prefill_kind, "dropped_per_layer": dropped,
                             "decode_median_ms": 1e3 * med, "decode_bound_median_ms": med_bound,
                             "experts_hit_median": statistics.median(hits), "decode_vs_forward_rel_l2": rel}
            del params, cache, state, outs, fed, logits, leaves, prompts, full, step_calls, prefill_calls
        torch.cuda.empty_cache()
    launches, steps, wgmma = total
    log(f"moe path: launches {launches} over {steps} calls, tensor-core {wgmma}, expert-batched {batched_total}, "
        f"narrow (the f32 routers) {narrow_total}")
    return (launches, steps, wgmma), (batched_total, narrow_total), results


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_hybrid_against_cpu(torch, dev):
    """Phase 6d, first part: recurrentgemma-9b at published width and
    HYBRID_CHECK_LAYERS layers, one set of weights. On the card and on the
    CPU (the kernels' plain versions): ``forward`` over HYBRID_CHECK_B x
    (HYBRID_CHECK_S + 4) tokens, and a prefill of HYBRID_CHECK_S tokens (the
    ring of min(window, S) slots) with 4 decode steps; gated by relative L2,
    at HYBRID_F32_REL_L2 in f32 and HYBRID_BF16_REL_L2 in bf16 (its max error
    and the logits beyond rtol = atol = TOL reported). On the card, decode
    against ``forward`` after a prefill of ``window`` tokens, where the
    reference's ring drops exactly what the window drops: gated at
    HYBRID_F32_REL_L2 in f32 and DECODE_REL_L2 in bf16; after a prefill of
    PROMPT < window tokens its ring of PROMPT slots drops position 0 at the
    first step, where ``forward`` still sees it (reference behaviour):
    reported. Launches are not counted on any path."""
    from repro_torch.models.model import build_model

    gc.collect()  # the earlier phases' host copies
    cfg = hybrid_config(HYBRID_CHECK_LAYERS)
    b, s, n = HYBRID_CHECK_B, HYBRID_CHECK_S, 4
    win = cfg.rglru.window
    tokens = torch.randint(1, cfg.vocab_size, (b, s + n), generator=torch.Generator().manual_seed(1000))
    long_tokens = torch.randint(1, cfg.vocab_size, (1, max(win, PROMPT) + n),
                                generator=torch.Generator().manual_seed(1001))
    t0 = time.perf_counter()

    def run(fns, params, device):
        """(forward logits, the prefill's last and the n decode steps' logits), on the host."""
        toks = tokens.to(device)
        fwd = fns.forward(params, {"tokens": toks}).float().cpu()
        logits, cache = fns.prefill(params, {"tokens": toks[:, :s]})
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(params, cache, {"tokens": toks[:, s + i : s + i + 1]})
            outs.append(logits)
        if cache["k"].shape[2] != min(win, s) or int(cache["index"]) != s + n:
            raise AssertionError(f"hybrid: ring {cache['k'].shape[2]} slots, index {int(cache['index'])}")
        return fwd, torch.cat(outs, dim=1).float().cpu()

    def decode_vs_forward(fns, params, prompt):
        toks = long_tokens[:, : prompt + n].to(dev)
        logits, cache = fns.prefill(params, {"tokens": toks[:, :prompt]})
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(params, cache, {"tokens": toks[:, prompt + i : prompt + i + 1]})
            outs.append(logits)
        ref = fns.forward(params, {"tokens": toks})[:, prompt - 1 :]
        return rel_l2(torch.cat(outs, dim=1), ref)

    with torch.inference_mode():
        fns = build_model(cfg)
        params = fns.init(torch.Generator(dev).manual_seed(1100))
        fwd16, dec16 = run(fns, params, dev)
        win16 = decode_vs_forward(fns, params, win)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        with kernel_plain_attend():
            fwd16_cpu, dec16_cpu = run(fns, cpu_params, "cpu")
        to_f32_in_place(torch, params)
        fns32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        fwd32, dec32 = run(fns32, params, dev)
        win32 = decode_vs_forward(fns32, params, win)
        short32 = decode_vs_forward(fns32, params, PROMPT)
        del params
        torch.cuda.empty_cache()
        to_f32_in_place(torch, cpu_params)
        with kernel_plain_attend():
            fwd32_cpu, dec32_cpu = run(fns32, cpu_params, "cpu")
        del cpu_params
    for out in (fwd16, dec16, fwd32, dec32):
        if not torch.isfinite(out).all():
            raise AssertionError("hybrid: logits not finite")
    if fwd16.shape != (b, s + n, cfg.vocab_size) or dec16.shape != (b, n + 1, cfg.vocab_size):
        raise AssertionError(f"hybrid: logits {tuple(fwd16.shape)}, {tuple(dec16.shape)}")
    rel = {"forward f32": rel_l2(fwd32, fwd32_cpu), "prefill + decode f32": rel_l2(dec32, dec32_cpu),
           "forward bf16": rel_l2(fwd16, fwd16_cpu), "prefill + decode bf16": rel_l2(dec16, dec16_cpu)}
    diff = (fwd16 - fwd16_cpu).abs()
    beyond = int((diff > TOL + TOL * fwd16_cpu.abs()).sum())
    log(f"hybrid {HYBRID_ARCH} published width, {cfg.num_layers} layers (one (rec, rec, attn) group and "
        f"{cfg.num_layers - 3} trailing recurrent), B={b}, forward over {s + n}, prefill {s} + {n} steps "
        f"({time.perf_counter() - t0:.1f} s):")
    log("  card vs CPU plain kernels, relative L2: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (gates {HYBRID_F32_REL_L2} f32, {HYBRID_BF16_REL_L2} bf16); bf16 forward max abs err "
          f"{float(diff.max()):.3e}, {beyond} of {diff.numel()} beyond rtol=atol={TOL} (reported)")
    log(f"  decode vs forward after a prefill of window = {win} tokens (ring {win} slots), B=1, {n} steps: "
        f"relative L2 f32 {win32:.3e} (gate {HYBRID_F32_REL_L2}), bf16 {win16:.3e} (gate {DECODE_REL_L2})")
    log(f"  decode vs forward after a prefill of {PROMPT} < window tokens (ring {PROMPT} slots: the first step "
        f"drops position 0, forward keeps it), f32: relative L2 {short32:.3e} (reported, not gated)")
    for key, val in rel.items():
        if not val <= (HYBRID_F32_REL_L2 if "f32" in key else HYBRID_BF16_REL_L2):
            raise AssertionError(f"hybrid {key} card vs CPU: relative L2 {val:.3e}")
    if not (win32 <= HYBRID_F32_REL_L2 and win16 <= DECODE_REL_L2):
        raise AssertionError(f"hybrid decode vs forward at s = window: f32 {win32:.3e}, bf16 {win16:.3e}")
    return {"rel_l2": rel, "bf16_forward_max_err": float(diff.max()), "bf16_forward_beyond": beyond,
            "window_decode_rel_l2_f32": win32, "window_decode_rel_l2_bf16": win16,
            "short_prompt_decode_rel_l2_f32": short32}


def hybrid_slice(torch, dev):
    """Phase 6d: recurrentgemma-9b at published width and depth (38 layers:
    12 (rec, rec, attn) groups and 2 trailing recurrent layers), random
    weights from a seed: a prefill of DECODE_B x PROMPT tokens (a ring of
    min(window, PROMPT) slots) and DECODE_STEPS greedy decode steps, each
    call's launches gated exactly (every M = 4096 projection of the prefill
    on the wgmma route, its 12 flash_attention calls at D = 256 too; 293
    stream_matmul and 12 paged_attention a decode step), logits finite.
    Reported: prefill time against its bound (operations or weight bytes,
    the larger), each decode step against the bytes it must move (weights,
    the ring, the recurrent state and conv history read and written), the
    device's idle share, and decode against one ``forward`` over the same
    tokens (not gated: the ring of PROMPT slots has dropped position 0 at
    the first step, which the window of 2048 keeps). Then the hybrid beside
    the live set served at 150% oversubscription (:func:`serve_slice`).
    Returns the path's launches (the served run's included), its calls and
    its tensor-core launches."""
    from repro_torch.core.runtime import flatten
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    cfg = hybrid_config()
    n_rec, n_attn = layer_counts(cfg)
    d, hd, V = cfg.d_model, cfg.resolved_head_dim(), cfg.vocab_size
    fns = build_model(cfg)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    total = [{name: 0 for name in KERNELS}, 0, {name: 0 for name in WGMMA_KERNELS}]

    def gated(what, path, run, count=True):
        torch.cuda.synchronize(dev)
        zero_launches()
        out = run()
        torch.cuda.synchronize(dev)
        launches, wgmma = read_launches(), read_wgmma()
        want, want_wgmma = step_launches(cfg, path), step_wgmma(cfg, path)
        if launches != want or wgmma != want_wgmma:
            raise AssertionError(f"{what}: launches {launches}, tensor-core {wgmma}; want {want}, {want_wgmma}")
        if count:
            add(launches, 1, wgmma)
        return out, launches, wgmma

    def add(launches, steps, wgmma):
        total[0] = {k: total[0][k] + launches[k] for k in total[0]}
        total[1] += steps
        total[2] = {k: total[2][k] + wgmma[k] for k in total[2]}

    with torch.inference_mode():
        t0 = time.perf_counter()
        params = fns.init(torch.Generator(dev).manual_seed(1200))
        prompts = torch.randint(1, V, (DECODE_B, PROMPT), device=dev,
                                generator=torch.Generator(dev).manual_seed(1300))
        torch.cuda.synchronize(dev)
        leaves = flatten(params)
        weight_bytes = sum(t.nbytes for _, t in leaves)
        log(f"hybrid {HYBRID_ARCH}: {cfg.num_layers} layers ({n_rec} recurrent, {n_attn} local attention, window "
            f"{cfg.rglru.window}), d {d}, H {cfg.num_heads}, Hkv {cfg.num_kv_heads}, D {hd}, V {V}; {weight_bytes} B "
            f"of weights, set-up {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card")

        t0 = time.perf_counter()
        (logits, cache), launches, wgmma = gated(
            f"{HYBRID_ARCH} prefill", "prefill", lambda: prefill_step(params, {"tokens": prompts}, max_seq=DECODE_SMAX))
        prefill_s = time.perf_counter() - t0
        w = cache["k"].shape[2]
        if w != min(cfg.rglru.window, PROMPT) or cache["host_index"] != PROMPT:
            raise AssertionError(f"{HYBRID_ARCH}: ring of {w} slots, index {cache['host_index']}")
        # the prefill's least time: its operations at the bf16 rate (every
        # projection at M = DECODE_B x PROMPT, the causal pairs inside the
        # window, the LM head on the last position) or its weight bytes
        # (every leaf but the embedding table), the larger
        n_tok = DECODE_B * PROMPT
        proj = sum(t.numel() for p, t in leaves if t.dim() == 3 and not p.endswith("conv_w"))
        ops = 2 * n_tok * proj + 2 * DECODE_B * d * V
        ops += n_attn * 4 * DECODE_B * cfg.num_heads * hd * attention_pairs(PROMPT, PROMPT, True, cfg.rglru.window)
        t_ops = ops / PEAK_OPS["torch.bfloat16"] * 1e3
        t_bytes = (weight_bytes - params["head"]["embed"].nbytes) / HBM_BYTES_PER_S * 1e3
        prefill_bound, prefill_kind = max((t_ops, "operations"), (t_bytes, "bytes"))
        log(f"  prefill {DECODE_B} x {PROMPT} tokens: {1e3 * prefill_s:.3f} ms, {n_tok / prefill_s:.1f} tokens/s, "
            f"bound {prefill_bound:.3f} ms ({prefill_kind}; operations {t_ops:.3f} ms, weight bytes {t_bytes:.3f} ms); "
            f"launches {launches}, tensor-core {wgmma}; ring of {w} slots")

        outs, fed, step_s = [logits], [], []
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            (logits, cache), _, _ = gated(f"{HYBRID_ARCH} decode step {i}", "decode",
                                          lambda: serve_step(params, cache, {"tokens": tok}))
            step_s.append(time.perf_counter() - t0)
            fed.append(tok)
            outs.append(logits)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        if int(cache["index"]) != DECODE_SMAX or cache["host_index"] != DECODE_SMAX:
            raise AssertionError(f"{HYBRID_ARCH}: index {int(cache['index'])} != {DECODE_SMAX}")
        decoded = torch.cat(outs, dim=1).float()
        if not torch.isfinite(decoded).all():
            raise AssertionError(f"{HYBRID_ARCH}: decode logits not finite")
        # a step reads every weight but the embedding table (DECODE_B rows of
        # it), the ring's valid k/v (full: w slots) and writes one slot, reads
        # and writes the recurrent state (f32) and the conv history
        elem = cache["k"].element_size()
        ring = 2 * n_attn * DECODE_B * (w + 1) * cfg.num_kv_heads * hd * elem
        state = 2 * (cache["h"].nbytes + cache["conv"].nbytes)
        step_bytes = weight_bytes - params["head"]["embed"].nbytes + DECODE_B * d * elem + ring + state
        med = statistics.median(step_s)
        log(f"  decode step median {1e3 * med:.3f} ms (min {1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}), "
            f"bound {1e3 * step_bytes / HBM_BYTES_PER_S:.3f} ms ({step_bytes} B: weights, ring {ring} B, state and "
            f"conv {state} B); {DECODE_B / med:.1f} tokens/s at the median")

        full = torch.cat([prompts] + fed, dim=1)
        t0 = time.perf_counter()
        ref, _, fwd_wgmma = gated(f"{HYBRID_ARCH} forward", "forward",
                                  lambda: fns.forward(params, {"tokens": full}), count=False)
        forward_s = time.perf_counter() - t0
        ref = ref[:, PROMPT - 1 :].float()
        rel = rel_l2(decoded, ref)
        per_step = ((decoded - ref).norm(dim=(0, 2)) / ref.norm(dim=(0, 2))).tolist()
        del decoded, ref
        log(f"  decode vs one forward over the same {DECODE_SMAX} tokens ({1e3 * forward_s:.0f} ms; tensor-core "
            f"{fwd_wgmma}): relative L2 {rel:.3e}, per position first {per_step[0]:.3e}, max {max(per_step):.3e} "
            f"(reported, not gated: the ring of {w} slots dropped position 0 at the first step, the window of "
            f"{cfg.rglru.window} keeps it)")

        profile_steps(torch, dev, f"{HYBRID_ARCH} prefill",
                      lambda i: prefill_step(params, {"tokens": prompts}, max_seq=DECODE_SMAX), prefill_s, n=1)
        state_ = {"cache": cache}

        def step(i):  # a ring never fills: the decode just goes on
            _, state_["cache"] = serve_step(params, state_["cache"], {"tokens": fed[i]})

        profile_steps(torch, dev, f"{HYBRID_ARCH} decode", step, med)
        result = {"prefill_ms": 1e3 * prefill_s, "prefill_bound_ms": prefill_bound, "prefill_bound_by": prefill_kind,
                  "decode_median_ms": 1e3 * med, "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
                  "decode_vs_forward_rel_l2": rel}
        del params, cache, state_, outs, fed, logits, leaves, prompts, full
    gc.collect()
    torch.cuda.empty_cache()

    # the hybrid as a live task beside the live set: the footprint over 1.5
    # must hold the hybrid's own pages (20.9 GB), which the live set alone
    # (14.2 GB) would not
    torch.cuda.synchronize(dev)
    launches, steps, wgmma = serve_slice(torch, dev, ARCHS + [HYBRID_ARCH], "hybrid serve")
    add(launches, steps, wgmma)
    gc.collect()
    torch.cuda.empty_cache()
    launches, steps, wgmma = total
    log(f"hybrid path: launches {launches} over {steps} calls, tensor-core {wgmma}")
    return (launches, steps, wgmma), result


def kernel_bench_path(torch, dev):
    """Phase 7: the port's kernel bench, the path of stream_matmul_int8 (the
    JAX package's kernel bench is its only caller there). Returns its
    launches, read from zero, its steps (a step is one call of each row,
    which the bench makes REPS + 1 times on the card: a warm-up, then the
    timed launches) and its tensor-core launches, every one of which must
    be a tensor-core launch for the three kernels that have that route."""
    from repro_torch.kernels import bench as kernel_bench

    torch.cuda.synchronize(dev)
    zero_launches()
    rows = kernel_bench.run(dev)
    torch.cuda.synchronize(dev)
    launches, wgmma = read_launches(), read_wgmma()
    log("kernel bench (python -m repro_torch.kernels.bench), name,us,derived:")
    for name, us, derived in rows:
        log(f"  {name},{us:.1f},{derived}")
    log(f"kernel bench: launches {launches}, tensor-core {wgmma}")
    missing = [name for name in BENCH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernel bench launched no {missing}")
    # the bench's shapes (M = 256 products, S = 512 attention) are all on the
    # tensor-core routes
    if any(wgmma[name] != launches[name] for name in BENCH_KERNELS if name in WGMMA_KERNELS):
        raise AssertionError(f"kernel bench: tensor-core launches {wgmma} != launches {launches}")
    return launches, kernel_bench.REPS + 1, wgmma


def check_flash_backward(torch, dev):
    """Phase 8, first part: ``flash_attention_backward`` against the plain
    version's gradients, autograd through ``attention_ref`` in f32, at every
    family's training shape (FA_BWD_CASES), in f32 and bf16, the forward's
    output from the forward kernel, itself held against ``attention_ref``. Each call's route (``fa_bwd_route``:
    wgmma for bf16 at head dim 64, 80, 128 and 256, simt otherwise) is logged and
    held against ``bwd_wgmma_launches``. Gated: relative L2 of dQ, dK and dV
    (FA_BWD_REL_L2; bf16 against the f32 gradients of the same inputs), the
    same bits on a second call; on the wgmma route also the forward's row
    statistics (written only when asked: O bit-equal without them, within
    1e-5 of ``attention_ref_lse``), the same gradient bits with them as
    without, and at the calls of FA_BWD_LIBRARY_GATED a time within
    MAX_BWD_LIBRARY_RATIO of SDPA's backward. Timed (CUDA events, cold L2) as the train path calls
    it (with the forward's statistics where its route takes them; also
    without, reported), beside the plain version on the same inputs, the
    backward of ``scaled_dot_product_attention`` on (B, H, S, D) copies (a
    yardstick only, which reads its forward's logsumexp too) and the bound:
    every input and gradient moved once, and 2.5 times the forward's
    operations (the five products of the standard backward: S again, dV,
    dP, dQ, dK) over the masked pairs. The qwen3 row's calls a train step go
    into the train path."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_backward, attention_ref_lse

    flash_attention, flash_attention_backward = fa_ops.flash_attention, fa_ops.flash_attention_backward
    bench = Bench(torch, dev, reps=5)
    gen = torch.Generator(dev).manual_seed(8)
    log("flash_attention_backward against the plain version's gradients (ms: CUDA events, with the forward's "
        "statistics on the wgmma route; library: the backward of scaled_dot_product_attention on (B, H, S, D) "
        "copies):")
    totals = path_totals()
    errs, bound_kinds, by_shape = [], set(), []
    for label, b, s, h, hkv, d, causal, window, calls in FA_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
            kw = dict(causal=causal, window=window)
            with torch.no_grad():
                out = flash_attention(q, k, v, **kw)
                ref_o = attention_ref(q.float(), k.float(), v.float(), **kw)
                rel_o = float((out.float() - ref_o).norm() / ref_o.norm())
                del ref_o
            if not rel_o <= FA_BWD_REL_L2[str(dtype)]:
                raise AssertionError(f"flash_attention {label} {dtype}: the forward's relative L2 {rel_o:.2e} > "
                                     f"{FA_BWD_REL_L2[str(dtype)]}")
            rule = fa_ops.fa_bwd_route(b, s, s, h, hkv, d, dtype)
            before = flash_attention.bwd_wgmma_launches
            grads = flash_attention_backward(q, k, v, out, do, **kw)
            if flash_attention.bwd_wgmma_launches - before != (rule == "wgmma"):
                raise AssertionError(f"flash_attention_backward {label} {dtype}: route rule says {rule}, wgmma "
                                     f"launches rose by {flash_attention.bwd_wgmma_launches - before}")
            want = attention_ref_backward(q.float(), k.float(), v.float(), do.float(), **kw)
            rels = [float((g.float() - w).norm() / w.norm()) for g, w in zip(grads, want)]
            err = max(float((g.float() - w).abs().max()) for g, w in zip(grads, want))
            del want
            if not max(rels) <= FA_BWD_REL_L2[str(dtype)]:
                raise AssertionError(f"flash_attention_backward {label} {dtype}: relative L2 dq/dk/dv "
                                     f"{rels} > {FA_BWD_REL_L2[str(dtype)]}")
            again = flash_attention_backward(q, k, v, out, do, **kw)
            if not all(torch.equal(g, a) for g, a in zip(grads, again)):
                raise AssertionError(f"flash_attention_backward {label} {dtype} is not deterministic")
            del again
            lse, lse_err = None, None
            if rule == "wgmma":
                # the statistics as autograd's forward writes them
                lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
                out_lse = fa_ops._forward(q, k, v, causal, window, 1.0 / math.sqrt(d), lse)
                lse_err = float((lse - attention_ref_lse(q, k, **kw)).abs().max())
                with_lse = flash_attention_backward(q, k, v, out, do, lse=lse, **kw)
                if not (torch.equal(out_lse, out) and lse_err <= 1e-5
                        and all(torch.equal(g, a) for g, a in zip(grads, with_lse))):
                    raise AssertionError(f"flash_attention_backward {label}: O with statistics equal "
                                         f"{torch.equal(out_lse, out)}, statistics off by {lse_err:.2e}, gradients "
                                         f"with them equal {all(torch.equal(g, a) for g, a in zip(grads, with_lse))}")
                del out_lse, with_lse
            kw_path = dict(kw, lse=lse) if lse is not None else kw
            t = bench.ms(lambda: flash_attention_backward(q, k, v, out, do, **kw_path))
            t_none = bench.ms(lambda: flash_attention_backward(q, k, v, out, do, **kw)) if lse is not None else t
            t_plain = bench.ms(lambda: attention_ref_backward(q, k, v, do, **kw))
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            mask = sdpa_window_mask(torch, s, s, causal, window, dev)
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                                                      enable_gqa=h != hkv)
            dot = do.transpose(1, 2).contiguous()
            t_lib = bench.ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
            del sdpa_out, qt, kt, vt, dot, mask
            elem = q.element_size()
            nbytes = elem * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())  # q, o, dO, dQ; k, v, dK, dV
            bt, kind = bound(nbytes, 10 * b * h * d * attention_pairs(s, s, causal, window), dtype)
            for path, n in calls.items():
                if dtype != torch.bfloat16:
                    continue
                bound_kinds.add(kind)
                for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                    totals[path][key] += n * val
            errs.append(err)
            by_shape.append({"label": label, "B": b, "S": s, "H": h, "Hkv": hkv, "D": d, "causal": causal,
                             "window": window, "dtype": str(dtype), "route": rule, "ms": t,
                             "ms_without_statistics": t_none, "bound_ms": bt, "bound_by": kind, "plain_ms": t_plain,
                             "library_ms": t_lib, "max_abs_err": err, "rel_l2": rels, "rel_l2_o": rel_o,
                             "lse_max_abs_err": lse_err})
            log(f"  {label} B={b} S={s} H={h} Hkv={hkv} D={d} causal={causal} window={window} {dtype} [{rule}]: "
                f"rel L2 o {rel_o:.2e} dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} kernel {t:.3f} ms"
                + (f" (without statistics {t_none:.3f} ms; statistics off by {lse_err:.2e})" if lse is not None else "")
                + f" bound {bt:.4f} ms ({kind}, {100 * bt / t:.1f}%) plain {t_plain:.3f} ms sdpa backward "
                f"{t_lib:.3f} ms (kernel {t / t_lib:.2f}x)")
            if label in FA_BWD_LIBRARY_GATED and dtype == torch.bfloat16 and not t <= MAX_BWD_LIBRARY_RATIO * t_lib:
                raise AssertionError(f"flash_attention_backward {label}: {t:.3f} ms > {MAX_BWD_LIBRARY_RATIO} x sdpa "
                                     f"backward {t_lib:.3f} ms")
            del q, k, v, do, out, grads, lse
        torch.cuda.empty_cache()
    # by positions: qwen2-vl-7b's training shape at its layout, f32, D = 80
    pos_recs, _, pos_kinds, pos_errs = check_flash_positions(torch, dev, bench, backward=True)
    return {
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "the gradient XLA takes of attend in the reference's loss, src/repro/models/common.py:131",
        "max_abs_err": max(errs + pos_errs),
        "bound_by": "+".join(sorted(bound_kinds | pos_kinds)),
        "by_path": totals,
        "extra": {"by_shape": by_shape, "by_positions": pos_recs},
    }


def check_stream_matmul_grads(torch, dev):
    """Phase 8: ``stream_matmul``'s gradients on the card (the 2-D form under
    autograd: dX and dW are ``stream_matmul`` calls themselves, dW reading x
    in place) at qwen3-1.7b's projections and LM head at M = 4096 and
    minicpm-2b's tied head (``w_layout="nk"``), in bf16, against f32
    products of the same operands at relative L2 1e-2 (one bf16 rounding of
    each gradient, ~2e-3); every product's launches (3) and the gradients'
    routes logged from the counters, and whether dW has the bits of the same
    product on a transposed copy. Their times are phase 3's, at the train
    path's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.streammm.ops import stream_matmul

    gen = torch.Generator(dev).manual_seed(9)
    m = TRAIN_B * TRAIN_S
    c = get_config(TRAIN_ARCH)
    d, f, hd = c.d_model, c.d_ff, c.resolved_head_dim()
    cases = [(d, c.num_heads * hd, "kn"), (d, c.num_kv_heads * hd, "kn"), (c.num_heads * hd, d, "kn"), (d, f, "kn"),
             (f, d, "kn"), (d, c.vocab_size, "kn"), (TIED_NK[1], TIED_NK[0], "nk")]
    log(f"stream_matmul gradients at M={m} (bf16, against f32 products of the same operands):")
    for k, n, layout in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
        w = (torch.randn((k, n) if layout == "kn" else (n, k), generator=gen, device=dev) / k ** 0.5).to(
            torch.bfloat16).requires_grad_()
        dy = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
        torch.cuda.synchronize(dev)
        l0, w0, nk0 = stream_matmul.launches, stream_matmul.wgmma_launches, stream_matmul.nk_launches
        y = stream_matmul(x, w, out_dtype=torch.bfloat16, w_layout=layout)
        gx, gw = torch.autograd.grad(y, (x, w), dy)
        torch.cuda.synchronize(dev)
        launches, wgmma, nk = (stream_matmul.launches - l0, stream_matmul.wgmma_launches - w0,
                               stream_matmul.nk_launches - nk0)
        xf, wf, dyf = x.detach().float(), w.detach().float(), dy.float()
        want_x = dyf @ (wf.T if layout == "kn" else wf)
        rel_x = float((gx.float() - want_x).norm() / want_x.norm())
        del want_x
        want_w = xf.T @ dyf if layout == "kn" else dyf.T @ xf
        rel_w = float((gw.float() - want_w).norm() / want_w.norm())
        del want_w, xf, wf, dyf
        # dW reads x (or dY) in place; the same product on a transposed copy
        # (the form before it did), compared bit for bit (reported)
        with torch.no_grad():
            copied = stream_matmul(*((x.detach().T.contiguous(), dy) if layout == "kn" else (dy.T.contiguous(), x.detach())),
                                   out_dtype=torch.bfloat16)
        same = torch.equal(copied, gw)
        del copied
        log(f"  K={k} N={n} {layout}: launches {launches} (tensor-core {wgmma}, K-major {nk}); rel L2 dX "
            f"{rel_x:.2e} dW {rel_w:.2e}; dW bit-identical to the product on a transposed copy: {same}")
        if launches != 3 or gx.dtype != torch.bfloat16 or gw.dtype != torch.bfloat16:
            raise AssertionError(f"stream_matmul gradient K={k} N={n} {layout}: {launches} launches, "
                                 f"dtypes {gx.dtype} {gw.dtype}")
        if not max(rel_x, rel_w) <= 1e-2:
            raise AssertionError(f"stream_matmul gradient K={k} N={n} {layout}: rel L2 {rel_x:.2e} {rel_w:.2e}")
        del x, w, dy, y, gx, gw
    torch.cuda.empty_cache()


def host_rss() -> int:
    """The process's resident host memory now, in bytes (Linux)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return 0


def release_host_cache(torch) -> None:
    """Frees the pinned host blocks that PyTorch's caching host allocator
    keeps after the served phases' migrations (up to their 35 GB footprint),
    so that the CPU side of phase 8's checks fits beside them in the host's
    memory. PyTorch names the call ``_host_emptyCache`` (2.11) or
    ``_accelerator_emptyHostCache`` (later); raises if it has neither."""
    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache", None)
    if empty is None:
        raise RuntimeError("chip_smoke: this PyTorch has no call that empties its pinned host cache")
    before = host_rss()
    empty()
    log(f"pinned host cache released: host resident {before} B -> {host_rss()} B")


def chunked_rel_l2(torch, got, want_of, chunk_bytes=2 << 30):
    """(relative L2, max abs error) of an expert stack ``got`` against
    ``want_of(slice)``, the f32 reference of a slice of its experts, a few
    experts at a time: arctic-480b's f32 dW is 17.8 GB, and a whole f32
    reference beside it and the weights would not fit on the card."""
    e = got.shape[0]
    step = max(1, chunk_bytes // (4 * got[0].numel()))
    num = den = err = 0.0
    for i in range(0, e, step):
        sl = slice(i, i + step)
        want = want_of(sl)
        diff = got[sl].float() - want
        num += float(diff.square().sum())
        den += float(want.square().sum())
        err = max(err, float(diff.abs().max()))
        del want, diff
    return math.sqrt(num / den), err


def check_batched_grads(torch, dev, rec):
    """Phase 8: the expert-batched form's gradients (dX = dY @ W^T over the
    stack, rows past ``rows[e]`` written as 0; dW = X^T @ dY over the filled
    slots, X read in place) at the MoE pair's training shapes (grok-1-314b:
    E 8, C 1280, d 6144, f 32768; arctic-480b: E 128, C 80, d 7168, f 4864;
    C the capacity of TRAIN_B x TRAIN_S tokens at 1.25), through autograd
    as the layer calls them, in bf16 and f32, against f32 products of the
    same operands (BATCHED_GRAD_REL_L2). Each expert's rows come from a
    dispatch of random router logits, with three experts set empty, full
    and partly filled; x and dY hold noise past the rows. Gated: the
    tolerance, dX's rows past the count and an empty expert's dW exactly 0,
    the same bits on a second backward (bf16), the launches exactly (the
    forward and two gradient launches a backward) and each route against
    the rule.
    Timed in bf16 (CUDA events, cold L2) beside the plain version, the
    bound (dX: the weight bytes of the experts that hold a row, or the
    filled rows' operations; dW: those operations, or the bytes of dW
    written plus X and dY read) and ``torch.bmm`` of the same gradients
    (a yardstick over every slot); each call's times go into the
    train_moe path of ``rec`` weighted by its calls a step."""
    from repro_torch.kernels.streammm.ops import mm_route, stream_matmul
    from repro_torch.kernels.streammm.ref import stream_matmul_ref
    from repro_torch.models.layers import moe_dispatch

    gc.collect()
    torch.cuda.empty_cache()
    bench = Bench(torch, dev, reps=5)
    gen = torch.Generator(dev).manual_seed(10)
    totals = rec["by_path"]["train_moe"]
    log("stream_matmul expert-batched gradients at the MoE pair's training shapes (against f32 products of the "
        "same operands; ms: CUDA events, cold L2; library: torch.bmm of the same gradient):")
    fn = stream_matmul
    for arch, layers in TRAIN_MOE_DEPTHS.items():
        c = moe_config(arch, layers)
        m = c.moe
        rows = moe_dispatch(torch.randn((TRAIN_B * TRAIN_S, m.num_experts), generator=gen, device=dev), m).rows
        for (e, cap, k, n), calls in step_experts(c, TRAIN_B * TRAIN_S).items():
            rows[0], rows[1], rows[2] = 0, cap, cap // 3 + 1
            counts = rows.tolist()
            filled, hit = sum(counts), sum(r > 0 for r in counts)
            live = torch.arange(cap, device=dev) < rows[:, None].long()
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((e, cap, k), generator=gen, device=dev).to(dtype).requires_grad_()
                w = (torch.randn((e, k, n), generator=gen, device=dev) / k ** 0.5).to(dtype).requires_grad_()
                dy = torch.randn((e, cap, n), generator=gen, device=dev).to(dtype)
                aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
                rules = (mm_route(cap, k, n, dtype, aligned, "nk"), mm_route(k, n, cap, dtype, aligned, "kn", "km"))
                torch.cuda.synchronize(dev)
                before = (fn.launches, fn.wgmma_launches, fn.batched_launches, fn.batched_grad_launches)
                y = fn(x, w, out_dtype=dtype, rows=rows)
                wgmma_fwd = fn.wgmma_launches - before[1]
                gx, gw = torch.autograd.grad(y, (x, w), dy)
                torch.cuda.synchronize(dev)
                counted = (fn.launches - before[0], fn.wgmma_launches - before[1] - wgmma_fwd,
                           fn.batched_launches - before[2], fn.batched_grad_launches - before[3])
                want_counts = (3, sum(r == "wgmma" for r in rules), 1, 2)
                if counted != want_counts:
                    raise AssertionError(f"batched gradients {arch} ({e},{cap},{k},{n}) {dtype}: launches, gradient "
                                         f"tensor-core, forward, gradient {counted} != {want_counts}")
                xd, wd = x.detach(), w.detach()
                rel_x, _ = chunked_rel_l2(torch, gx, lambda sl: stream_matmul_ref(
                    dy[sl].float(), wd[sl].float(), torch.float32, "nk", rows[sl]))
                rel_w, err = chunked_rel_l2(torch, gw, lambda sl: stream_matmul_ref(
                    xd[sl].float(), dy[sl].float(), torch.float32, "kn", rows[sl], "km"))
                zeros = not gx[~live].any() and not gw[0].any()
                del y
                same = True
                if dtype == torch.bfloat16:  # f32 (no atomics either) would hold three 17.8 GB stacks at arctic's
                    again = torch.autograd.grad(fn(x, w, out_dtype=dtype, rows=rows), (x, w), dy)
                    same = torch.equal(gx, again[0]) and torch.equal(gw, again[1])
                    del again
                tol = BATCHED_GRAD_REL_L2[str(dtype)]
                line = (f"  {arch} E={e} C={cap} K={k} N={n} {dtype} ({filled} rows filled, {hit} experts hit) "
                        f"[dX {rules[0]}, dW {rules[1]}]: rel L2 dX {rel_x:.2e} dW {rel_w:.2e} (gate {tol})")
                if not (max(rel_x, rel_w) <= tol and zeros and same and gx.dtype == gw.dtype == dtype):
                    raise AssertionError(f"batched gradients {arch} ({e},{cap},{k},{n}) {dtype}: rel L2 {rel_x:.2e} "
                                         f"{rel_w:.2e}, zeros past the rows {zeros}, deterministic {same}")
                del gx, gw
                if dtype == torch.bfloat16:
                    kw_x, kw_w = dict(out_dtype=dtype, w_layout="nk", rows=rows), dict(out_dtype=dtype, rows=rows,
                                                                                      x_layout="km")
                    t_x = bench.ms(lambda: fn(dy, wd, **kw_x))
                    t_w = bench.ms(lambda: fn(xd, dy, **kw_w))
                    p_x = bench.ms(lambda: stream_matmul_ref(dy, wd, dtype, "nk", rows))
                    p_w = bench.ms(lambda: stream_matmul_ref(xd, dy, dtype, "kn", rows, "km"))
                    l_x = bench.ms(lambda: torch.bmm(dy, wd.transpose(1, 2)))
                    l_w = bench.ms(lambda: torch.bmm(xd.transpose(1, 2), dy))
                    ops = 2 * filled * k * n
                    b_x, kind_x = bound(2 * (hit * k * n + filled * n + e * cap * k), ops, dtype)
                    b_w, kind_w = bound(2 * (e * k * n + filled * (k + n)), ops, dtype)
                    for t, p, bt, lt in ((t_x, p_x, b_x, l_x), (t_w, p_w, b_w, l_w)):
                        for key, val in (("ms", t), ("plain_ms", p), ("bound_ms", bt), ("library_ms", lt)):
                            totals[key] += calls * val
                    rec["extra"]["by_shape"].append({
                        "label": f"{arch} train gradients", "E": e, "C": cap, "K": k, "N": n, "rows": filled,
                        "experts_hit": hit, "route": list(rules), "ms": [t_x, t_w], "bound_ms": [b_x, b_w],
                        "bound_by": [kind_x, kind_w], "plain_ms": [p_x, p_w], "library_ms": [l_x, l_w],
                        "rel_l2": [rel_x, rel_w], "max_abs_err": err})
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    line += (f"; dX {t_x:.3f} ms (bound {b_x:.3f} {kind_x}, {100 * b_x / t_x:.0f}%; plain {p_x:.3f}; "
                             f"torch.bmm {l_x:.3f}, {t_x / l_x:.2f}x), dW {t_w:.3f} ms (bound {b_w:.3f} {kind_w}, "
                             f"{100 * b_w / t_w:.0f}%; plain {p_w:.3f}; torch.bmm {l_w:.3f}, {t_w / l_w:.2f}x); "
                             f"{calls} of each a step")
                log(line)
                del x, w, dy, xd, wd
                torch.cuda.empty_cache()


def check_train_against_cpu(torch, dev):
    """Phase 8: the loss and every gradient leaf at published width and cut
    depth (TRAIN_CHECK) on the card (the kernels, forward and backward)
    against the same weights and batch on the CPU (the plain versions, which
    autograd differentiates), remat as published. Gated in f32: the loss and
    each leaf within TRAIN_F32_REL_L2; reported in bf16. The card's
    gradients stay on the card while the CPU runs and are compared one leaf
    at a time, so the host holds the parameters, the CPU's gradients and one
    leaf of the card's (grok-1-314b in f32: 26.1 + 26.1 + 6.4 GB), after the
    pinned blocks that the served phases left in PyTorch's host cache are
    released (:func:`release_host_cache`); the host's resident memory is
    logged. Then TRAIN_CARD_ONLY (arctic-480b
    at 1 layer in bf16, too large for f32 on one card): the loss and every
    gradient finite."""
    import resource

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model import build_model
    from repro_torch.tree import flatten

    def batch_of(cfg, seed):  # the VLM at Qwen2-VL's layout (families_batch)
        return families_batch(cfg, TRAIN_CHECK_B, TRAIN_CHECK_S, seed, "cpu", kind="train")

    release_host_cache(torch)
    results = {}
    for seed, (arch, layers, dtypes) in enumerate(TRAIN_CHECK):
        t0 = time.perf_counter()
        row = {}
        for dtype in dtypes:
            cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
            fns = build_model(cfg)
            params = fns.init(torch.Generator(dev).manual_seed(500 + seed))
            batch = batch_of(cfg, 600 + seed)
            loss, _, grads = value_and_grad(fns, params, {k: v.to(dev) for k, v in batch.items()})
            paths = [p for p, _ in flatten(params)]
            params = tree_map(lambda t: t.cpu(), params)
            torch.cuda.empty_cache()
            loss_cpu, _, grads_cpu = value_and_grad(fns, params, batch)
            del params
            rel = {}
            for i, path in enumerate(paths):  # one card leaf on the host at a time
                g, want = grads[i].cpu().float(), grads_cpu[i].float()
                rel[path] = float((g - want).norm() / want.norm().clamp(min=1e-30))
                grads[i] = grads_cpu[i] = None
                del g, want
            loss_rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
            worst = max(rel, key=rel.get)
            row[dtype] = {"loss": float(loss), "loss_cpu": float(loss_cpu), "loss_rel": loss_rel,
                          "worst_leaf": worst, "worst_rel_l2": rel[worst]}
            del grads, grads_cpu, batch
            torch.cuda.empty_cache()
            if not (math.isfinite(float(loss)) and math.isfinite(float(loss_cpu))):
                raise AssertionError(f"train {arch} {dtype}: loss {float(loss)} / {float(loss_cpu)} not finite")
            if dtype == "float32" and not (loss_rel <= TRAIN_F32_REL_L2 and rel[worst] <= TRAIN_F32_REL_L2):
                raise AssertionError(f"train {arch} f32 card vs CPU: loss rel {loss_rel:.2e}, {worst} relative "
                                     f"L2 {rel[worst]:.2e} > {TRAIN_F32_REL_L2}")
        f32 = row["float32"]
        line = (f"train {arch} at published width, {layers} layers, B={TRAIN_CHECK_B} S={TRAIN_CHECK_S}, card vs CPU "
                f"({time.perf_counter() - t0:.1f} s): f32 loss {f32['loss']:.6f} (rel {f32['loss_rel']:.2e}), "
                f"worst leaf {f32['worst_leaf']} rel L2 {f32['worst_rel_l2']:.2e} (gate {TRAIN_F32_REL_L2})")
        if "bfloat16" in row:
            line += (f"; bf16 loss rel {row['bfloat16']['loss_rel']:.2e}, worst leaf {row['bfloat16']['worst_leaf']} "
                     f"rel L2 {row['bfloat16']['worst_rel_l2']:.2e} (reported)")
        log(line + f"; host resident {host_rss()} B (peak of the process "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B)")
        results[arch] = row
    for seed, (arch, layers) in enumerate(TRAIN_CARD_ONLY):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        fns = build_model(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        params = fns.init(torch.Generator(dev).manual_seed(550 + seed))
        batch = batch_of(cfg, 650 + seed)
        loss, aux, grads = value_and_grad(fns, params, {k: v.to(dev) for k, v in batch.items()})
        paths = [p for p, _ in flatten(params)]
        norms = {p: float(g.float().norm()) if g.dim() < 3 else
                 math.sqrt(sum(float(sl.float().square().sum()) for sl in g.reshape(-1, *g.shape[-2:])))
                 for p, g in zip(paths, grads)}
        bad = [p for p, v in norms.items() if not math.isfinite(v)]
        peak = torch.cuda.max_memory_allocated(dev)
        del params, grads
        torch.cuda.empty_cache()
        log(f"train {arch} at published width, {layers} layer(s), {cfg.dtype}, B={TRAIN_CHECK_B} S={TRAIN_CHECK_S} "
            f"on the card ({time.perf_counter() - t0:.1f} s): loss {float(loss):.6f} (ce {float(aux['ce']):.6f}, "
            f"aux {float(aux['aux']):.6f}); gradient norms " + ", ".join(f"{p} {v:.4e}" for p, v in norms.items())
            + f"; peak allocated {peak} B")
        if not math.isfinite(float(loss)) or bad:
            raise AssertionError(f"train {arch} bf16: loss {float(loss)}, gradients not finite: {bad}")
        results[arch] = {"bfloat16": {"loss": float(loss), "grad_norms": norms}}
    return results


def train_slice(torch, dev):
    """Phase 8: qwen3-1.7b at published width and depth (28 layers, 2.03 B
    parameters), AdamW and the cosine schedule of its config, remat as
    published, through :func:`train_run`. Returns the path's launches,
    steps and tensor-core launches, and the run's numbers."""
    from repro_torch.configs import get_config

    return train_run(torch, dev, get_config(TRAIN_ARCH), seed=700)


def train_moe_slice(torch, dev):
    """Phase 8's MoE path: grok-1-314b at TRAIN_MOE_DEPTHS (2 of 64 layers)
    and arctic-480b (1 of 35, its dense residual beside the experts), one
    model at a time, each through :func:`train_run` at published width,
    Adafactor and remat as published, capacity factor 1.25: the expert
    products and their gradients through ``stream_matmul``'s expert-batched
    form. Returns the path's launches, steps and tensor-core launches, and
    each model's numbers."""
    total = ({name: 0 for name in KERNELS}, 0, {name: 0 for name in WGMMA_KERNELS})
    runs = {}
    for i, (arch, layers) in enumerate(TRAIN_MOE_DEPTHS.items()):
        (counts, n, wgmma), runs[arch] = train_run(torch, dev, moe_config(arch, layers), seed=710 + i)
        total = ({k: total[0][k] + counts[k] for k in counts}, total[1] + n,
                 {k: total[2][k] + wgmma[k] for k in wgmma})
        torch.cuda.empty_cache()
    return total, runs


def train_batched(cfg, remat: bool):
    """stream_matmul's expert-batched launches of one train step: the three
    expert products of every MoE layer forward (twice with remat) in
    ``batched_launches``, and their dX and dW in ``batched_grad_launches``."""
    if cfg.moe is None:
        return 0, 0
    return 3 * cfg.num_layers * (1 + remat), 6 * cfg.num_layers


def train_bounds(cfg, params, tokens, kept):
    """(operations, bytes) that one train step must at least do and move.
    Operations: 6 per weight of a product a token (forward, dX, dW), the
    expert products over the ``kept`` assignments of each layer instead of
    every token, and 14 B H D a layer a masked pair for attention forward
    and backward. Bytes: the layer stack's parameters read four times
    (forward, remat's replay, dX) or written (dW) in the products, the LM
    head's three times (no replay), the embedding's gradient written once;
    the clip norm reads every gradient, and the optimizer reads them again,
    then reads the parameters and gradients and writes the parameters
    (AdamW also reads and writes its two f32 moments). Activations are not
    counted."""
    from repro_torch.tree import flatten

    d, n_layers = cfg.d_model, cfg.num_layers
    ops, nbytes = 0, 0
    for path, p in flatten(params):
        size = p.numel() * p.element_size()
        nbytes += 5 * size
        if cfg.optimizer == "adamw":
            nbytes += 4 * 4 * p.numel()
        if path == "head/embed":
            nbytes += size
            if not cfg.tie_embeddings:
                continue
        if p.dim() < 2:
            continue
        nbytes += (3 if path.startswith("head/") else 4 if cfg.remat else 3) * size
        if cfg.moe is not None and path.split("/")[-1] in ("w1", "w2", "w3") and "/moe/w" in path:
            continue  # the experts: over the kept assignments below
        ops += 6 * p.numel() * tokens
    if cfg.moe is not None:
        ops += sum(6 * 3 * d * cfg.moe.d_ff * k for k in kept)
    if n_layers and cfg.family != "ssm":
        ops += 14 * TRAIN_B * cfg.num_heads * cfg.resolved_head_dim() * layer_counts(cfg)[1] * \
            attention_pairs(TRAIN_S, TRAIN_S, True, 0)
    return ops, nbytes


def train_run(torch, dev, cfg, seed):
    """One model at published width: TRAIN_STEPS steps through
    ``make_train_step`` (``warmup=1``) on one batch of TRAIN_B x TRAIN_S
    tokens from ``TokenPipeline``, repeated, the config's optimizer and
    schedule and remat. Gated: every step's launches exactly
    (:func:`train_launches`; for MoE also :func:`train_batched`), its
    attention launches on the tensor-core routes (:func:`train_wgmma`), the
    MoE routers' on the narrow route (:func:`train_narrow`), the
    loss finite and falling, and the loss and every gradient with remat off
    equal to those with remat on, bit for bit (remat on's gradients held on
    the host meanwhile). Reported: the median step, tokens/s, the device's
    idle share and top kernels (torch.profiler), the peak of allocated
    memory over the state's making and the steps (and what was allocated
    before: phase 9d holds the difference to the dry-run's count), and the
    operations and bytes bounds of a step
    (:func:`train_bounds`, the experts over the first step's kept
    assignments). Returns the launches, steps and tensor-core launches, and
    the run's numbers."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.launch.steps import make_train_state, make_train_step, value_and_grad
    from repro_torch.models.layers import moe_dispatch
    from repro_torch.models.model import build_model
    from repro_torch.tree import leaves

    name = cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(seed))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipeline_for(cfg, ShapeSpec("train", TRAIN_S, TRAIN_B, "train"), seed=7).batch(0).items()}
    step_fn = make_train_step(cfg, warmup=1, total_steps=100)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    log(f"train {name}: {cfg.num_layers} layers, d {cfg.d_model}, V {cfg.vocab_size}, {n_params} parameters, "
        f"{cfg.optimizer} + {cfg.schedule}, remat {cfg.remat}"
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} at capacity factor {cfg.moe.capacity_factor}"
           if cfg.moe is not None else "") + f"; set-up {time.perf_counter() - t0:.1f} s")
    want, want_wgmma = train_launches(cfg, cfg.remat), train_wgmma(cfg, cfg.remat)
    want_batched, want_narrow = train_batched(cfg, cfg.remat), train_narrow(cfg, cfg.remat)
    total = ({k: 0 for k in KERNELS}, 0, {k: 0 for k in WGMMA_KERNELS})
    losses, step_s, kept, batched_total, narrow_total = [], [], [], (0, 0), 0
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        zero_launches()
        stream_matmul.batched_launches = stream_matmul.batched_grad_launches = 0
        t0 = time.perf_counter()
        with moe_routing([]) as routed:
            state, metrics = step_fn(state, batch)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        launches, wgmma, narrow = read_launches(), read_wgmma(), read_narrow()
        batched = (stream_matmul.batched_launches, stream_matmul.batched_grad_launches)
        if launches != want or any(wgmma[k] != n for k, n in want_wgmma.items()) or batched != want_batched \
                or narrow != want_narrow:
            raise AssertionError(f"train {name} step {i}: launches {launches} != {want}, or tensor-core {wgmma} "
                                 f"against {want_wgmma}, or expert-batched {batched} != {want_batched}, or "
                                 f"narrow {narrow} != {want_narrow}")
        if i == 0 and cfg.moe is not None:  # the layers' routings (remat's replay routes the same)
            kept = [int(moe_dispatch(logits, cfg.moe).rows.sum()) for logits in routed[:cfg.num_layers]]
        del routed
        counts, n, counts_wgmma = total
        total = ({k: counts[k] + launches[k] for k in counts}, n + 1,
                 {k: counts_wgmma[k] + wgmma[k] for k in counts_wgmma})
        batched_total = (batched_total[0] + batched[0], batched_total[1] + batched[1])
        narrow_total += narrow
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        log(f"  step {i}: {1e3 * step_s[-1]:.1f} ms, loss {m['loss']:.6f} ce {m['ce']:.6f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e}; launches {launches}, tensor-core {wgmma}"
            + (f", expert-batched {batched}, narrow {narrow}" if cfg.moe is not None else ""))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train {name}: losses {losses} not finite or not falling")
    peak = torch.cuda.max_memory_allocated(dev)
    med = statistics.median(step_s[1:])
    tokens = TRAIN_B * TRAIN_S
    ops, nbytes = train_bounds(cfg, state["params"], tokens, kept)
    ops_ms, bytes_ms = ops / PEAK_OPS["torch.bfloat16"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  median step {1e3 * med:.1f} ms over steps 1-{TRAIN_STEPS - 1}, {tokens / med:.0f} tokens/s; "
        f"operations bound {ops_ms:.1f} ms ({ops:.4e} operations at the bf16 peak"
        + (f", the experts over {kept} kept assignments a layer" if kept else "")
        + f"), bytes bound {bytes_ms:.1f} ms ({nbytes:.4e} B at {HBM_BYTES_PER_S:.3g} B/s); "
        f"{100 * max(ops_ms, bytes_ms) / (1e3 * med):.1f}% of the step; peak allocated {peak} B ({base} B before "
        "the state was made)")
    profile_steps(torch, dev, f"{name} train step", lambda i: step_fn(state, batch), med, n=2, top=12)

    # remat off against remat on: the loss and every gradient, bit for bit
    params = state["params"]
    del state, metrics
    torch.cuda.empty_cache()
    loss_on, _, grads = value_and_grad(build_model(cfg), params, batch)
    grads_on = [g.cpu() for g in grads]
    del grads
    torch.cuda.empty_cache()
    zero_launches()
    stream_matmul.batched_launches = stream_matmul.batched_grad_launches = 0
    loss_off, _, grads = value_and_grad(build_model(dataclasses.replace(cfg, remat=False)), params, batch)
    torch.cuda.synchronize(dev)
    launches, wgmma, narrow = read_launches(), read_wgmma(), read_narrow()
    batched = (stream_matmul.batched_launches, stream_matmul.batched_grad_launches)
    want_off, want_off_wgmma = train_launches(cfg, False), train_wgmma(cfg, False)
    if launches != want_off or any(wgmma[k] != n for k, n in want_off_wgmma.items()) \
            or batched != train_batched(cfg, False) or narrow != train_narrow(cfg, False):
        raise AssertionError(f"train {name} without remat: launches {launches} != {want_off}, or tensor-core "
                             f"{wgmma} against {want_off_wgmma}, or expert-batched {batched}, or narrow {narrow}")
    same = torch.equal(loss_on, loss_off)
    for i, g in enumerate(grads):
        same = same and torch.equal(g.cpu(), grads_on[i])
        grads[i] = grads_on[i] = None
    log(f"  remat off vs on: loss {float(loss_off):.6f} vs {float(loss_on):.6f}, {len(grads)} gradient leaves, "
        f"bit-identical {same}; launches without remat {launches}")
    if not same:
        raise AssertionError(f"train {name}: remat off does not give remat on's bits")
    del grads, grads_on, params, batch
    torch.cuda.empty_cache()
    return total, {"losses": losses, "median_step_ms": 1e3 * med, "tokens_per_s": tokens / med,
                   "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms, "kept": kept, "peak_allocated_bytes": peak,
                   "base_allocated_bytes": base, "batched": batched_total, "narrow": narrow_total}


def supervisor_on_card(torch, dev):
    """Phase 8, last: ``TrainSupervisor`` at qwen3-1.7b's reduced config on the
    card, in a temporary directory: a run with an injected failure at step 3
    restarts from the step-2 checkpoint and gives the uninterrupted run's
    losses from there (rtol = atol = 1e-5, the reference's test; bit-equality
    reported)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.runtime.train_loop import FailureInjector, TrainSupervisor

    cfg = get_config(TRAIN_ARCH).reduced()
    shape = ShapeSpec("smoke", 64, 4, "train")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        base = TrainSupervisor(cfg, shape, f"{tmp}/a", ckpt_every=2, device=dev).run(total_steps=6)
        rep = TrainSupervisor(cfg, shape, f"{tmp}/b", ckpt_every=2, device=dev).run(
            total_steps=6, injector=FailureInjector(fail_at=[3]))
    same = rep.losses[3:] == base.losses[2:]
    log(f"TrainSupervisor {cfg.name} on the card ({time.perf_counter() - t0:.1f} s): restarts {rep.restarts}, "
        f"final step {rep.final_step}, checkpoints {rep.checkpoints}, losses {base.losses}; after the restart "
        f"{rep.losses[3:]} (bit-identical {same})")
    if rep.restarts != 1 or rep.final_step != 6 or len(rep.losses) != 7:
        raise AssertionError(f"TrainSupervisor: {rep}")
    if not all(abs(a - b) <= 1e-5 + 1e-5 * abs(b) for a, b in zip(rep.losses[3:], base.losses[2:])):
        raise AssertionError(f"TrainSupervisor: resumed losses {rep.losses[3:]} != {base.losses[2:]}")



def start_dryrun(out: Path):
    """Phase 9d's dry-run on the host, one subprocess an assigned arch and
    mesh of DRYRUN_MESHES, each at the lowest priority (nice 19) and on one
    thread: its records to ``out/<arch>_<mesh>.jsonl`` and its own output
    beside them in ``.log``. Started after phase 8's train path, whose
    qwen3-1.7b step the host's speed sets (on the H100's host a dry-run
    beside it, even at nice 19, took it from 520.7-645.9 to 923.4 ms),
    so that it runs on the cores that the phases after it leave idle: the
    MoE train steps (grok-1-314b's set by the card, arctic-480b's read
    up to ~15% slower beside it) and phase 9's paths, which are not
    timed. Phases 10 and 11, timed on the host, come after it has ended.
    Returns the processes by (arch, mesh)."""
    import os

    from repro_torch.configs import ASSIGNED

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for arch in ASSIGNED:
        for mesh in DRYRUN_MESHES:
            with open(out / f"{arch}_{mesh}.log", "w") as log_file:
                procs[arch, mesh] = subprocess.Popen(
                    [sys.executable, "-c", "import os, runpy; os.nice(19); runpy.run_module("
                     "'repro_torch.launch.dryrun', run_name='__main__', alter_sys=True)",
                     "--arch", arch, "--meshes", mesh, "--out", str(out / f"{arch}_{mesh}.jsonl")], env=env, cwd=ROOT,
                    stdout=log_file, stderr=subprocess.STDOUT)
    return procs


def example_module(name: str, folder: str = "examples"):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gate_train_launches(name, cfg, steps, launches, wgmma, b=TRAIN_B, s=TRAIN_S):
    """Every launch of ``steps`` train steps over b x s tokens of a dense
    ``cfg``, exactly (:func:`train_launches`, :func:`train_wgmma`)."""
    want = {k: steps * n for k, n in train_launches(cfg, cfg.remat).items()}
    want_wgmma = {k: steps * n for k, n in train_wgmma(cfg, cfg.remat, b, s).items()}
    if launches != want or any(wgmma[k] != n for k, n in want_wgmma.items()):
        raise AssertionError(f"{name}: launches {launches} != {want}, or tensor-core {wgmma} against {want_wgmma}")


def quickstart_on_card(torch, dev):
    """Phase 9a: ``examples/port_quickstart.py`` on the card through its
    ``run``: the reduced qwen3-1.7b for 30 steps (seq 128, batch 8, peak lr
    1e-3). Gated: the first loss within 0.6 of ln(512) and the last 0.5 below
    it; every launch exactly. Returns the path's launches, steps and
    tensor-core launches."""
    from repro_torch.configs import get_config

    example = example_module("port_quickstart")
    cfg = get_config("qwen3-1.7b").reduced()
    torch.cuda.synchronize(dev)
    zero_launches()
    t0 = time.perf_counter()
    losses = example.run(dev, QUICKSTART_STEPS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches, wgmma = read_launches(), read_wgmma()
    log(f"quickstart: {QUICKSTART_STEPS} steps in {wall:.2f} s; losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"launches {launches}, tensor-core {wgmma}")
    gate_train_launches("quickstart", cfg, QUICKSTART_STEPS, launches, wgmma, 8, 128)
    if not (abs(losses[0] - math.log(512)) < 0.6 and losses[-1] < losses[0] - 0.5):
        raise AssertionError(f"quickstart: losses {losses} do not fall from about ln(512)")
    return launches, QUICKSTART_STEPS, wgmma


def train_lm_on_card(torch, dev):
    """Phase 9b: ``examples/port_train_lm.py`` on the card through its
    ``run``, as the reference runs it (TRAIN_LM_STEPS steps, checkpoints
    every TRAIN_LM_CKPT), then with a failure injected at TRAIN_LM_KILL.
    Gated: the loss falling; one restart, from the last checkpoint before
    the failure, after which the losses are the uninterrupted run's (rtol =
    atol = 1e-5, the reference's test; bit-equality reported); every launch
    of both runs exactly, the attention at head dim 64 on the wgmma routes.
    Returns the path's launches, steps and tensor-core launches."""
    example = example_module("port_train_lm")
    cfg = example.build_cfg()
    total = ({k: 0 for k in KERNELS}, 0, {k: 0 for k in WGMMA_KERNELS})
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for kill in (None, TRAIN_LM_KILL):
            torch.cuda.synchronize(dev)
            zero_launches()
            report, wall = example.run(TRAIN_LM_STEPS, kill, f"{tmp}/{kill}", TRAIN_LM_CKPT, dev)
            torch.cuda.synchronize(dev)
            launches, wgmma = read_launches(), read_wgmma()
            steps = len(report.losses)
            log(f"train_lm (kill at {kill}): {steps} steps, {report.restarts} restarts, {report.checkpoints} "
                f"checkpoints in {wall:.2f} s ({1e3 * wall / steps:.2f} ms a step, checkpoints included; "
                f"{steps * example.SHAPE.seq_len * example.SHAPE.global_batch / wall:.0f} tokens/s); losses {report.losses[0]:.6f} -> "
                f"{report.losses[-1]:.6f}; launches {launches}, tensor-core {wgmma}")
            gate_train_launches(f"train_lm (kill at {kill})", cfg, steps, launches, wgmma,
                                example.SHAPE.global_batch, example.SHAPE.seq_len)
            total = ({k: total[0][k] + launches[k] for k in KERNELS}, total[1] + steps,
                     {k: total[2][k] + wgmma[k] for k in WGMMA_KERNELS})
            runs.append(report)
    base, killed = runs
    resume = TRAIN_LM_KILL // TRAIN_LM_CKPT * TRAIN_LM_CKPT
    after, want = killed.losses[TRAIN_LM_KILL:], base.losses[resume:]
    diff = max(abs(a - b) for a, b in zip(after, want))
    log(f"train_lm: restart at {TRAIN_LM_KILL} resumed from step {resume}; {len(after)} losses after it against "
        f"the uninterrupted run's: bit-identical {after == want}, largest difference {diff:.3e}")
    if not base.losses[-1] < base.losses[0]:
        raise AssertionError(f"train_lm: the loss did not fall: {base.losses[0]} -> {base.losses[-1]}")
    if killed.restarts != 1 or len(after) != len(want) or \
            not all(abs(a - b) <= 1e-5 + 1e-5 * abs(b) for a, b in zip(after, want)):
        raise AssertionError(f"train_lm: the restarted run's losses {after[:4]}... != {want[:4]}...")
    return total


def mesh_on_card(torch, dev):
    """Phase 9c: qwen3-1.7b at published width and MESH_LAYERS layers, AdamW
    and remat as published, MESH_STEPS steps of TRAIN_B x TRAIN_S tokens
    through ``TrainSupervisor``, first without a mesh, then on a one-rank
    NCCL group (a FileStore, no network) under a 1 x 1 ``DeviceMesh``, the
    state placed as DTensors (``sharding.specs``), the step
    ``make_sharded_train_step``. Gated: the same losses bit for bit; the
    same launches, exactly those of the steps (:func:`train_launches`); a
    one-element NCCL all-reduce on the group; the mesh run's checkpoint
    restored without a mesh, and the meshless run's restored into the placed
    state, both equal to the meshless state bit for bit. Then, on the same
    group, :func:`train_on_mesh` of the MoE model and of each recurrent
    model. Returns the mesh run's launches, steps and tensor-core launches,
    the MoE mesh run's with its expert-batched launches, and the recurrent
    mesh runs' summed."""
    import torch.distributed as dist

    from repro_torch.checkpointing.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.launch.steps import abstract_train_state, make_train_state
    from repro_torch.runtime.train_loop import TrainSupervisor
    from repro_torch.sharding.specs import gather, place, state_shardings
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=MESH_LAYERS)
    shape = ShapeSpec("mesh", TRAIN_S, TRAIN_B, "train")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        init_ranks(0, 1, f"{tmp}/store", dev)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), dev)
            one = torch.ones(1, device=dev)
            dist.all_reduce(one)
            shardings = state_shardings(cfg, abstract_train_state(cfg), mesh)
            log(f"mesh: a group of {dist.get_world_size()} rank, mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({dist.get_backend()}), an all-reduce of one element gave {float(one)}")
            runs = {}
            for name, kw in (("plain", {}), ("mesh", {"mesh": mesh, "shardings": shardings})):
                torch.cuda.synchronize(dev)
                zero_launches()
                t0 = time.perf_counter()
                report = TrainSupervisor(cfg, shape, f"{tmp}/{name}", ckpt_every=MESH_STEPS, device=dev,
                                         **kw).run(MESH_STEPS)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                runs[name] = (report, read_launches(), read_wgmma())
                log(f"mesh path, {name}: {cfg.num_layers} layers of {TRAIN_ARCH} at published width, {MESH_STEPS} "
                    f"steps of {TRAIN_B} x {TRAIN_S} tokens in {wall:.2f} s (set-up and a checkpoint included); "
                    f"losses {report.losses}; launches {runs[name][1]}, tensor-core {runs[name][2]}")
                gate_train_launches(f"mesh path, {name}", cfg, MESH_STEPS, runs[name][1], runs[name][2])
            plain = restore(f"{tmp}/plain", MESH_STEPS, make_train_state(cfg, torch.Generator(dev).manual_seed(1)))
            other = restore(f"{tmp}/mesh", MESH_STEPS, make_train_state(cfg, torch.Generator(dev).manual_seed(2)))
            same_from = all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(plain), flatten(other)))
            del other
            other = restore(f"{tmp}/plain", MESH_STEPS,
                            place(make_train_state(cfg, torch.Generator(dev).manual_seed(3)), shardings))
            same_into = all(torch.equal(a, gather(b)) for (_, a), (_, b) in zip(flatten(plain), flatten(other)))
            del plain, other
            moe = train_on_mesh(torch, dev, mesh, moe_config(MESH_MOE_ARCH, MESH_MOE_LAYERS))
            recurrent = [train_on_mesh(torch, dev, mesh, dataclasses.replace(get_config(arch), num_layers=layers))
                         for arch, layers in MESH_RECURRENT]
        finally:
            dist.destroy_process_group()
    (base, base_launches, _), (meshed, launches, wgmma) = runs["plain"], runs["mesh"]
    log(f"mesh path: losses bit-identical {meshed.losses == base.losses}; checkpoints across: mesh -> none "
        f"{same_from}, none -> mesh {same_into}")
    if meshed.losses != base.losses or launches != base_launches or not (same_from and same_into):
        raise AssertionError(f"mesh path: losses {meshed.losses} vs {base.losses}, launches {launches} vs "
                             f"{base_launches}, checkpoints across {same_from} / {same_into}")
    torch.cuda.empty_cache()
    steps = sum(r[1] for r in recurrent)
    recurrent = ({k: sum(r[0][k] for r in recurrent) for k in KERNELS}, steps,
                 {k: sum(r[2][k] for r in recurrent) for k in WGMMA_KERNELS})
    return (launches, MESH_STEPS, wgmma), moe, recurrent


def train_on_mesh(torch, dev, mesh, cfg):
    """Phase 9c's other models (the MoE model at MESH_MOE_LAYERS layers,
    Adafactor, capacity factor 1.25; the recurrent families of
    MESH_RECURRENT, AdamW): at published width, remat as published,
    MESH_STEPS steps of one TRAIN_B x TRAIN_S batch through
    ``make_train_step``, then through ``make_sharded_train_step`` on ``mesh``
    (the one-rank group) with the state placed as DTensors. Nothing splits
    there, so the per-layer gathers, the dp group's routing and the split
    over ``model`` run none of their collectives. Gated: the same losses bit
    for bit; every step's launches exactly, for both
    (:func:`train_launches`, :func:`train_wgmma`, :func:`train_batched`).
    Returns the mesh run's launches, steps, tensor-core and expert-batched
    launches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.launch.steps import make_sharded_train_step, make_train_state, make_train_step
    from repro_torch.sharding.specs import place, state_shardings

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipeline_for(cfg, ShapeSpec("mesh", TRAIN_S, TRAIN_B, "train"), seed=7).batch(0).items()}
    want, want_wgmma = train_launches(cfg, cfg.remat), train_wgmma(cfg, cfg.remat)
    want_batched = train_batched(cfg, cfg.remat)
    runs = {}
    for name in ("plain", "mesh"):
        gc.collect()
        torch.cuda.empty_cache()
        state = make_train_state(cfg, torch.Generator(dev).manual_seed(11))
        if name == "mesh":
            state = place(state, state_shardings(cfg, state, mesh))
            step = make_sharded_train_step(cfg, mesh, warmup=1, total_steps=100)
        else:
            step = make_train_step(cfg, warmup=1, total_steps=100)
        total = ({k: 0 for k in KERNELS}, {k: 0 for k in WGMMA_KERNELS}, [0, 0])
        losses, t0 = [], time.perf_counter()
        for i in range(MESH_STEPS):
            torch.cuda.synchronize(dev)
            zero_launches()
            stream_matmul.batched_launches = stream_matmul.batched_grad_launches = 0
            state, metrics = step(state, batch)
            torch.cuda.synchronize(dev)
            launches, wgmma = read_launches(), read_wgmma()
            batched = (stream_matmul.batched_launches, stream_matmul.batched_grad_launches)
            if launches != want or any(wgmma[k] != n for k, n in want_wgmma.items()) or batched != want_batched:
                raise AssertionError(f"mesh path, {cfg.name} {name} step {i}: launches {launches} != {want}, or "
                                     f"tensor-core {wgmma} against {want_wgmma}, or expert-batched {batched} != "
                                     f"{want_batched}")
            losses.append(float(metrics["loss"]))
            total = ({k: total[0][k] + launches[k] for k in KERNELS},
                     {k: total[1][k] + wgmma[k] for k in WGMMA_KERNELS},
                     [total[2][0] + batched[0], total[2][1] + batched[1]])
        wall = time.perf_counter() - t0
        runs[name] = (losses, total)
        log(f"mesh path, {cfg.name} {name}: {cfg.num_layers} layers at published width, {MESH_STEPS} steps of "
            f"{TRAIN_B} x {TRAIN_S} tokens in {wall:.2f} s; losses {losses}; launches {total[0]}, tensor-core "
            f"{total[1]}, expert-batched {total[2]}")
        del state, metrics, step
    (base, _), (got, (launches, wgmma, batched)) = runs["plain"], runs["mesh"]
    log(f"mesh path, {cfg.name}: losses bit-identical {got == base}")
    if got != base:
        raise AssertionError(f"mesh path, {cfg.name}: losses {got} vs {base}")
    torch.cuda.empty_cache()
    return launches, MESH_STEPS, wgmma, tuple(batched)


def rank_state(torch, cfg, mesh, dev, keys=None):
    """The train state of ``cfg`` (its ``keys``, default all) as this rank's
    shards on ``mesh`` (the placements of ``sharding.specs``), made on the
    card shard by shard: parameters drawn at 0.02, the optimizer's state 0.
    No whole leaf is ever made."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.steps import abstract_train_state
    from repro_torch.sharding.specs import state_shardings
    from repro_torch.tree import tree_map

    state = abstract_train_state(cfg)

    def shard(t, s, draw):
        local = torch.empty(s.shard_shape(tuple(t.shape)), dtype=t.dtype, device=dev)
        local.normal_(std=0.02) if draw and t.is_floating_point() else local.zero_()
        return DTensor.from_local(local, mesh, s.placements(), run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape, device="meta").stride())

    shardings = state_shardings(cfg, state, mesh)
    return {key: tree_map(lambda t, s: shard(t, s, key == "params"), state[key], shardings[key])
            for key in (keys or state)}


def kernel_calls(calls):
    """Wraps each kernel's launch (``streammm.ops._launch``, ``flash_attention.
    ops._forward`` and ``flash_attention_backward``) and the model's
    ``paged_attention`` so that every call notes, in ``calls``, its kernel,
    route and shapes; returns the undo."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention.ops import pa_splits
    from repro_torch.kernels.streammm import ops as mm_ops
    from repro_torch.models import layers

    launch, forward, backward = mm_ops._launch, fa_ops._forward, fa_ops.flash_attention_backward
    paged = layers.paged_attention

    def paged_(q, pool_k, pool_v, table, lengths, **kw):
        b, h, d = q.shape
        _, pt, hkv, _ = pool_k.shape
        splits = pa_splits(b, hkv, table.shape[1], _build.sm_count(q.device)) if q.is_cuda else 1
        key = ("paged_attention", f"split-kv {splits}", b, h, hkv, d, pt, table.shape[1], str(q.dtype),
               kw.get("return_lse", False))
        calls[key] = calls.get(key, 0) + 1
        return paged(q, pool_k, pool_v, table, lengths, **kw)

    def launch_(x, w, out, rows, e, slots, m, n, k, route, splits, w_layout, x_layout):
        key = ("stream_matmul", route, x.dim() == 3, e, m, n, k, w_layout, x_layout, str(x.dtype), str(out.dtype),
               rows is not None, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
        calls[key] = calls.get(key, 0) + 1
        return launch(x, w, out, rows, e, slots, m, n, k, route, splits, w_layout, x_layout)

    def forward_(q, k, v, causal, window, scale, lse=None):
        b, sq, h, d = q.shape
        route = fa_ops.fa_route(b, sq, k.shape[1], h, k.shape[2], d, q.dtype, fa_ops._aligned(q, k, v))
        key = ("flash_attention", route, b, sq, k.shape[1], h, k.shape[2], d, str(q.dtype), causal, window, scale)
        calls[key] = calls.get(key, 0) + 1
        return forward(q, k, v, causal, window, scale, lse)

    def backward_(q, k, v, out, dout, *, lse=None, causal=True, window=0, sm_scale=None):
        b, sq, h, d = q.shape
        route = fa_ops.fa_bwd_route(b, sq, k.shape[1], h, k.shape[2], d, q.dtype,
                                    fa_ops._aligned(q, k, v, out, dout))
        key = ("flash_attention_backward", route, b, sq, k.shape[1], h, k.shape[2], d, str(q.dtype), causal,
               window, sm_scale, lse is not None)
        calls[key] = calls.get(key, 0) + 1
        return backward(q, k, v, out, dout, lse=lse, causal=causal, window=window, sm_scale=sm_scale)

    mm_ops._launch, fa_ops._forward, fa_ops.flash_attention_backward = launch_, forward_, backward_
    layers.paged_attention = paged_

    def undo():
        mm_ops._launch, fa_ops._forward, fa_ops.flash_attention_backward = launch, forward, backward
        layers.paged_attention = paged

    return undo


def check_kernel_call(torch, dev, key) -> float:
    """One call of a kernel noted by :func:`kernel_calls`, on fresh random
    inputs of its shapes (misaligned where the noted call's were), against
    its plain version, its route held against the noted one. Returns the
    relative L2 (the largest of dQ, dK, dV for the backward)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_backward
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.kernels.streammm.ref import stream_matmul_ref

    gen = torch.Generator(dev).manual_seed(len(key))
    dtypes = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}

    def randn(shape, dtype, scale=1.0, aligned=True):
        n = math.prod(shape)
        buf = torch.randn(n + 8, generator=gen, device=dev).mul_(scale).to(dtype)
        return (buf[:n] if aligned else buf[1 : n + 1]).view(shape)

    kernel, route = key[0], key[1]
    if kernel == "paged_attention":
        return check_paged_call(torch, dev, key, randn)
    if kernel == "stream_matmul":
        _, _, batched, e, m, n, k, w_layout, x_layout, x_dtype, out_dtype, has_rows, aligned = key
        lead = (e,) if batched else ()
        dtype = dtypes[x_dtype]
        x = randn((*lead, *((k, m) if x_layout == "km" else (m, k))), dtype, 1.0, aligned)
        w = randn((*lead, *((n, k) if w_layout == "nk" else (k, n))), dtype, k ** -0.5)
        rows = torch.randint(1, m + 1, (e,), generator=gen, device=dev, dtype=torch.int32) if has_rows else None
        kw = dict(out_dtype=dtypes[out_dtype], w_layout=w_layout, rows=rows, x_layout=x_layout)
        with torch.no_grad():  # raises where the wgmma or narrow count leaves the noted route
            out, _ = checked_route(stream_matmul, route, lambda: stream_matmul(x, w, **kw))
        took = route == "wgmma"
        rel = rel_l2(out, stream_matmul_ref(x.float(), w.float(), **dict(kw, out_dtype=torch.float32)))
        tol = MM_REL_L2[x_dtype]
    else:
        b, sq, skv, h, hkv, d, dtype, causal, window, scale = key[2:12]
        dtype = dtypes[dtype]
        q, do = randn((b, sq, h, d), dtype), randn((b, sq, h, d), dtype)
        k, v = randn((b, skv, hkv, d), dtype), randn((b, skv, hkv, d), dtype)
        kw = dict(causal=causal, window=window, sm_scale=scale)
        if kernel == "flash_attention":
            before = fa_ops.flash_attention.wgmma_launches
            with torch.no_grad():
                out = fa_ops.flash_attention(q, k, v, **kw)
            took = fa_ops.flash_attention.wgmma_launches - before
            if causal and sq == skv and 4 * b * h * sq * skv > FA_CHECK_BYTES:  # five runs of its query rows
                starts = (0, sq // 4, sq // 2, 3 * sq // 4, sq - FA_CHECK_ROWS)
                rel = max(rel_l2(out[:, a : a + FA_CHECK_ROWS], attention_rows_ref(torch, q, k, v, a, FA_CHECK_ROWS,
                                                                                   **kw)) for a in starts)
            else:
                rel = rel_l2(out, attention_ref(q.float(), k.float(), v.float(), **kw))
            tol = FA_REL_L2
        else:
            with torch.no_grad():
                out = fa_ops.flash_attention(q, k, v, **kw)
            lse = None
            if key[12]:
                lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
                fa_ops._forward(q, k, v, causal, window, scale, lse)
            before = fa_ops.flash_attention.bwd_wgmma_launches
            grads = fa_ops.flash_attention_backward(q, k, v, out, do, lse=lse, **kw)
            took = fa_ops.flash_attention.bwd_wgmma_launches - before
            want = attention_ref_backward(q.float(), k.float(), v.float(), do.float(), **kw)
            rel = max(rel_l2(g, w) for g, w in zip(grads, want))
            tol = FA_BWD_REL_L2[str(dtype)]
    if took != (route == "wgmma") or not rel <= tol:
        raise AssertionError(f"{key}: route {route}, tensor-core launches rose by {took}; relative L2 {rel:.2e} "
                             f"against the plain version (at most {tol})")
    return rel


def attention_rows_ref(torch, q, k, v, start, rows, causal=True, window=0, sm_scale=None):
    """``attention_ref`` of query rows [start, start + rows) of a
    self-attention (Sq = Skv) against the keys they can see (every key
    before start + rows where causal, else every key), masked by the rows'
    own positions: the plain version's arithmetic (f32 scores, -1e30 at
    masked keys, softmax, GQA), without the other rows' scores."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    t = start + rows if causal else s
    k, v = k[:, :t], v[:, :t]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q[:, start : start + rows].float().reshape(b, rows, hkv, g, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qf * scale, k.float())
    qpos = torch.arange(start, start + rows, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((rows, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    scores = torch.where(mask[None, None, None], scores, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v.float()).reshape(b, rows, h, d)


def check_paged_call(torch, dev, key, randn) -> float:
    """One ``paged_attention`` call noted by :func:`kernel_calls`, on fresh
    inputs of its shapes (row 0 of length 0, the others random), with
    ``lse`` where the noted call took it, against ``paged_attention_ref``;
    then the same at one page a row (one split: the first kernel writes
    ``lse``, not the merge). Gated: the output's largest error within
    PA_REL of the plain version's RMS, exact zeros at length 0; ``lse``
    within PA_LSE_TOL, -inf exactly where the plain version's is; one
    launch a call. Returns the largest relative L2 of the outputs."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    _, _, b, h, hkv, d, pt, max_pages, dtype, lse = key
    dtype = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}[dtype]
    worst = 0.0
    for pages in (max_pages, 1):
        q = randn((b, h, d), dtype)
        pools = [randn((b * pages, pt, hkv, d), dtype) for _ in range(2)]
        table = torch.arange(b * pages, dtype=torch.int32, device=dev).reshape(b, pages)
        lengths = torch.randint(1, pages * pt + 1, (b,), dtype=torch.int32, device=dev)
        lengths[0] = 0
        args = (q, *pools, table, lengths)
        before = paged_attention.launches
        got = paged_attention(*args, return_lse=lse)
        want = paged_attention_ref(*args, return_lse=lse)
        (out, got_lse), (ref, want_lse) = (got, want) if lse else ((got, None), (want, None))
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, rel_l2(out, ref))
        bad = paged_attention.launches != before + 1 or err > PA_REL * float(ref.float().pow(2).mean().sqrt()) \
            or out[0].any()
        if lse:
            finite = torch.isfinite(want_lse)
            bad = bad or not torch.equal(finite, torch.isfinite(got_lse)) or \
                float((got_lse[finite] - want_lse[finite]).abs().max()) > PA_LSE_TOL
        if bad:
            raise AssertionError(f"{key} at {pages} pages a row: max error {err:.3e} against the plain version, "
                                 f"launches {paged_attention.launches - before}, zeros at length 0 "
                                 f"{not out[0].any()}, lse {got_lse[:2] if lse else None} against "
                                 f"{want_lse[:2] if lse else None}")
    return worst


def rank_on_card(torch, dev):
    """Phase 9e: one rank of the production 16x16 mesh on the card. A
    ``fake`` process group of 256 ranks (``torch.testing._internal.
    distributed.fake_pg``; this process is rank 0, its collectives return
    at once and leave their outputs as they were) carries the mesh of
    ``make_mesh``; each cell of RANK_CELLS takes one train_4k step through
    ``make_sharded_train_step`` on its state's shards (:func:`rank_state`)
    and the global batch, of which the step takes the rank's 16 rows.
    Gated: the allocator's peak over the step (its state's shards
    included) within RANK_BAND of the dry-run's count of the same rank,
    cell and depth (``build_cell``: argument + temp + output - alias); the
    launches exactly those of a train step of the model
    (:func:`train_launches`, :func:`train_batched`); and each (kernel,
    route, shapes) the step met, once more on fresh inputs against its
    plain version (:func:`check_kernel_call`). Returns the path's launches,
    steps and tensor-core launches."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_sharded_train_step

    shape = SHAPES["train_4k"]
    total = ({k: 0 for k in KERNELS}, {k: 0 for k in WGMMA_KERNELS})
    calls, missed = {}, []
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(RANK_MESH))
    try:
        mesh = make_mesh(RANK_MESH, ("data", "model"), dev)
        log(f"rank path: rank 0 of {dict(zip(mesh.mesh_dim_names, mesh.shape))} on a {dist.get_backend()} group "
            f"of {dist.get_world_size()}")
        for arch, layers in RANK_CELLS:
            cfg = get_config(arch) if layers is None else dataclasses.replace(get_config(arch), num_layers=layers)
            t0 = time.perf_counter()
            mem = dryrun.build_cell(cfg, shape, "x".join(map(str, RANK_MESH))).mem
            count = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
            t_count = time.perf_counter() - t0
            batch = {k: torch.from_numpy(v).to(dev) for k, v in pipeline_for(cfg, shape, seed=9).batch(0).items()}
            step = make_sharded_train_step(cfg, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize(dev)
            base = allocated_bytes(torch, dev)
            torch.cuda.reset_peak_memory_stats(dev)
            state = rank_state(torch, cfg, mesh, dev)
            zero_launches()
            stream_matmul.batched_launches = stream_matmul.batched_grad_launches = 0
            undo = kernel_calls(calls)
            t0 = time.perf_counter()
            try:
                state, metrics = step(state, batch)
                torch.cuda.synchronize(dev)
            finally:
                undo()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            launches, wgmma = read_launches(), read_wgmma()
            batched = (stream_matmul.batched_launches, stream_matmul.batched_grad_launches)
            del state, metrics, step, batch
            gc.collect()
            torch.cuda.empty_cache()
            margin = (count - peak) / peak
            log(f"rank path, {arch} at {cfg.num_layers} layers, train_4k on {RANK_MESH}: one step in {wall:.2f} s; "
                f"dry-run count {count} B ({count / 2**30:.3f} GiB, counted in {t_count:.1f} s), allocator's peak "
                f"{peak} B ({peak / 2**30:.3f} GiB), margin {100 * margin:+.2f}%; temp by kind at its peak (GiB): "
                + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in mem["temp_breakdown"].items() if v)
                + f"; launches {launches}, tensor-core {wgmma}, expert-batched {batched}")
            if abs(margin) > RANK_BAND:
                missed.append(f"{arch}: count {count} B against the peak {peak} B ({100 * margin:+.2f}%)")
            if launches != train_launches(cfg, cfg.remat) or batched != train_batched(cfg, cfg.remat):
                missed.append(f"{arch}: launches {launches} != {train_launches(cfg, cfg.remat)} or expert-batched "
                              f"{batched} != {train_batched(cfg, cfg.remat)}")
            total = ({k: total[0][k] + launches[k] for k in KERNELS},
                     {k: total[1][k] + wgmma[k] for k in WGMMA_KERNELS})
    finally:
        dist.destroy_process_group()
    log(f"rank path: {len(calls)} (kernel, route, shapes) at the shard shapes, each against its plain version "
        "(relative L2):")
    for key, n in calls.items():
        rel = check_kernel_call(torch, dev, key)
        log(f"  {key}: {n} calls a step's worth; relative L2 {rel:.2e}")
        torch.cuda.empty_cache()
    if missed:
        raise AssertionError(f"rank path: {missed}")
    return total[0], len(RANK_CELLS), total[1]


def serve_on_mesh(torch, dev):
    """Phase 9f: prefill and decode on a mesh, each product on its ``model``
    shard and the KV cache's sequence cut over ``model``
    (``launch/steps.make_sharded_prefill_step`` and
    ``make_sharded_serve_step``). Runs while 9d's dry-run takes the host:
    :func:`serve_one_rank`, then :func:`serve_rank`. Returns their paths'
    (launches, steps, tensor-core launches)."""
    one = serve_one_rank(torch, dev)
    return one, serve_rank(torch, dev)


def serve_one_rank(torch, dev):
    """A one-rank NCCL group (a FileStore, as 9c's) and a 1 x 1 mesh: each
    cell of SERVE_ONE_CELLS at published width prefills DECODE_B x PROMPT
    tokens into PROMPT + SERVE_ONE_STEPS slots and decodes SERVE_ONE_STEPS
    greedy tokens, first through ``make_prefill_step`` / ``make_serve_step``
    on whole parameters, then through the sharded steps on the same
    parameters placed as DTensors (views of them: a rank holds every leaf
    whole there). Gated: every logit bit for bit and the same tokens; each
    run's launches exactly a prefill's and SERVE_ONE_STEPS decodes'
    (:func:`step_launches`)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step, make_sharded_prefill_step,
                                          make_sharded_serve_step)
    from repro_torch.models.model import build_model
    from repro_torch.sharding.specs import param_shardings
    from repro_torch.tree import tree_map

    total = ({k: 0 for k in KERNELS}, {k: 0 for k in WGMMA_KERNELS})
    with tempfile.TemporaryDirectory() as tmp:
        init_ranks(0, 1, f"{tmp}/store", dev)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), dev)
            for arch, layers in SERVE_ONE_CELLS:
                cfg = get_config(arch) if layers is None else dataclasses.replace(get_config(arch), num_layers=layers)
                gc.collect()
                torch.cuda.empty_cache()
                params = build_model(cfg).init(torch.Generator(dev).manual_seed(13))
                placed = tree_map(lambda t, sp: DTensor.from_local(t, mesh, sp.placements(), run_check=False),
                                  params, param_shardings(cfg, params, mesh))
                prompt = torch.randint(1, cfg.vocab_size, (DECODE_B, PROMPT), generator=torch.Generator(dev)
                                       .manual_seed(14), device=dev)
                want = step_launches(cfg, "prefill")
                want = {k: n + SERVE_ONE_STEPS * step_launches(cfg, "decode")[k] for k, n in want.items()}
                runs = {}
                for name, prefill, serve, p in (
                        ("meshless", make_prefill_step(cfg), make_serve_step(cfg), params),
                        ("mesh", make_sharded_prefill_step(cfg, mesh), make_sharded_serve_step(cfg, mesh), placed)):
                    torch.cuda.synchronize(dev)
                    zero_launches()
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        logits, cache = prefill(p, {"tokens": prompt}, max_seq=PROMPT + SERVE_ONE_STEPS)
                        outs = [logits]
                        for _ in range(SERVE_ONE_STEPS):
                            tok = outs[-1].argmax(-1)
                            logits, cache = serve(p, cache, {"tokens": tok})
                            outs.append(logits)
                    torch.cuda.synchronize(dev)
                    wall = time.perf_counter() - t0
                    runs[name] = (torch.stack(outs), read_launches(), read_wgmma())
                    log(f"serve on a mesh, {name}: {arch} at {cfg.num_layers} layers, published width, a prefill "
                        f"of {DECODE_B} x {PROMPT} and {SERVE_ONE_STEPS} decode steps in {wall:.2f} s; launches "
                        f"{runs[name][1]}")
                    del cache, logits, outs
                (base, base_launches, _), (got, launches, wgmma) = runs["meshless"], runs["mesh"]
                same = torch.equal(got, base)
                log(f"serve on a mesh, {arch}: logits bit-identical {same}, greedy tokens the same "
                    f"{torch.equal(got.argmax(-1), base.argmax(-1))}")
                if not same or launches != base_launches or launches != want:
                    raise AssertionError(f"serve on a mesh, {arch}: bits {same}, launches {launches} against the "
                                         f"meshless {base_launches} and {want}")
                total = ({k: total[0][k] + launches[k] for k in KERNELS},
                         {k: total[1][k] + wgmma[k] for k in WGMMA_KERNELS})
                del params, placed, runs, got, base
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return total[0], len(SERVE_ONE_CELLS), total[1]


def rank_cache(torch, cfg, mesh, dev, batch: int, slots: int):
    """A zero decode cache of ``batch`` rows and ``slots`` slots (the
    hybrid's ring: its window's) as this rank's shards on ``mesh``
    (``cache_shardings``), made on the card shard by shard, at position 0
    (rank 0 owns slot 0)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.model import build_model
    from repro_torch.sharding.specs import cache_shardings
    from repro_torch.tree import tree_map

    whole = build_model(cfg).init_cache(batch, slots, "meta")
    specs = cache_shardings(cfg, whole, mesh, batch)

    def shard(t, sp):
        local = torch.zeros(sp.shard_shape(tuple(t.shape)), dtype=t.dtype, device=dev)
        return DTensor.from_local(local, mesh, sp.placements(), run_check=False, shape=t.shape, stride=t.stride())

    return dict(tree_map(shard, {k: whole[k] for k in specs}, specs), host_index=0)


def serve_rank(torch, dev):
    """Rank 0 of RANK_MESH on 9e's ``fake`` group of 256 (its collectives
    return at once and leave their outputs as they were, so values are not
    checked): each cell of SERVE_RANK_CELLS takes a prefill_32k (the rank's
    2 rows of 32 x 32,768 tokens) through ``make_sharded_prefill_step`` on
    its param shards (:func:`rank_state`), and SERVE_RANK_STEPS decode_32k
    steps (its 8 rows of 128, a cache of 32,768 slots of which it holds
    2,048 of every KV head, or of the hybrid's ring of 2,048 its 128, and
    its heads and channels of the recurrent states, :func:`rank_cache`)
    through ``make_sharded_serve_step``. Gated: each run's allocator peak (its
    arguments included) within RANK_BAND of the dry-run's count of the same
    rank, cell and depth (argument + temp + output - alias); the launches
    exactly a prefill's and SERVE_RANK_STEPS decodes' (:func:`step_launches`:
    the merge's ``lse`` adds none); and each (kernel, route, shapes) met,
    once more on fresh inputs against its plain version
    (:func:`check_kernel_call`; ``paged_attention`` with ``lse`` at a row of
    length 0 and at its split count). Returns the path's launches, runs and
    tensor-core launches."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import make_concrete_batch
    from repro_torch.launch.steps import make_sharded_prefill_step, make_sharded_serve_step

    total = ({k: 0 for k in KERNELS}, {k: 0 for k in WGMMA_KERNELS})
    calls, missed, runs = {}, [], 0
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(RANK_MESH))
    try:
        mesh = make_mesh(RANK_MESH, ("data", "model"), dev)
        for arch, layers in SERVE_RANK_CELLS:
            cfg = get_config(arch) if layers is None else dataclasses.replace(get_config(arch), num_layers=layers)
            for shape_name in ("prefill_32k", "decode_32k"):
                shape = SHAPES[shape_name]
                t0 = time.perf_counter()
                mem = dryrun.build_cell(cfg, shape, "x".join(map(str, RANK_MESH))).mem
                count = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
                t_count = time.perf_counter() - t0
                batch = make_concrete_batch(cfg, shape, seed=15, device=dev)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize(dev)
                base = allocated_bytes(torch, dev)
                torch.cuda.reset_peak_memory_stats(dev)
                params = rank_state(torch, cfg, mesh, dev, keys=("params",))["params"]
                steps = 1 if shape.kind == "prefill" else SERVE_RANK_STEPS
                want = step_launches(cfg, shape.kind)
                want = {k: n * steps for k, n in want.items()}
                zero_launches()
                undo = kernel_calls(calls)
                t0 = time.perf_counter()
                try:
                    with torch.no_grad():
                        if shape.kind == "prefill":
                            logits, cache = make_sharded_prefill_step(cfg, mesh)(params, batch)
                        else:
                            cache = rank_cache(torch, cfg, mesh, dev, shape.global_batch, shape.seq_len)
                            serve = make_sharded_serve_step(cfg, mesh)
                            for _ in range(steps):
                                logits, cache = serve(params, cache, batch)
                        rows = logits.shape[0]
                        local = {k: tuple(v.to_local().shape) for k, v in cache.items() if k not in ("index", "host_index")}
                    torch.cuda.synchronize(dev)
                finally:
                    undo()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated(dev) - base
                launches, wgmma = read_launches(), read_wgmma()
                del params, cache, logits, batch
                gc.collect()
                torch.cuda.empty_cache()
                margin = (count - peak) / peak
                log(f"serve rank path, {arch} at {cfg.num_layers} layers, {shape_name} on {RANK_MESH}: {steps} "
                    f"call(s) in {wall:.2f} s, the rank's {rows} rows, cache shard {local}; dry-run count "
                    f"{count} B ({count / 2**30:.3f} GiB, counted in {t_count:.1f} s), allocator's peak {peak} B "
                    f"({peak / 2**30:.3f} GiB), margin {100 * margin:+.2f}%; temp by kind at its peak (GiB): "
                    + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in mem["temp_breakdown"].items() if v)
                    + f"; launches {launches}, tensor-core {wgmma}")
                if abs(margin) > RANK_BAND:
                    missed.append(f"{arch} {shape_name}: count {count} B against the peak {peak} B "
                                  f"({100 * margin:+.2f}%)")
                if launches != want:
                    missed.append(f"{arch} {shape_name}: launches {launches} != {want}")
                total = ({k: total[0][k] + launches[k] for k in KERNELS},
                         {k: total[1][k] + wgmma[k] for k in WGMMA_KERNELS})
                runs += 1
    finally:
        dist.destroy_process_group()
    log(f"serve rank path: {len(calls)} (kernel, route, shapes) at the shard shapes, each against its plain "
        "version (relative L2):")
    for key, n in calls.items():
        rel = check_kernel_call(torch, dev, key)
        log(f"  {key}: {n} calls; relative L2 {rel:.2e}")
        torch.cuda.empty_cache()
    if missed:
        raise AssertionError(f"serve rank path: {missed}")
    return total[0], runs, total[1]


def allocated_bytes(torch, dev) -> int:
    """The bytes of the blocks the caching allocator has given out, live on
    the card now."""
    return torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]


def alloc_slack(nbytes: int) -> int:
    """The most the caching allocator gives a request of ``nbytes`` beyond
    it (ALLOC_ROUND, ALLOC_LARGE)."""
    return ALLOC_ROUND + (ALLOC_LARGE if nbytes > ALLOC_LARGE else 0)


def predicted_dot_flops(cfg, b: int, s: int) -> int:
    """The products' FLOPs that the dry-run counts for a train step of a
    dense attention model over b x s tokens: a layer's seven projections
    forward, dX and dW, and with remat replayed but for the last (w2, whose
    output the backward does not need: the checkpoint's replay stops once
    every saved tensor is back); the LM head forward, dX and dW; the plain
    attention's two S x S products a head forward (all S² scores: it masks,
    it does not skip), replayed with remat, and four in the backward."""
    d, n_layers, h, hkv, hd = cfg.d_model, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    w_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * cfg.d_ff
    r, t = int(cfg.remat), b * s
    products = 2 * t * n_layers * (w_layer * (3 + r) - r * d * cfg.d_ff) + 6 * t * d * cfg.vocab_size
    return products + (12 + 4 * r) * b * h * s * s * hd * n_layers


def memory_counts(torch):
    """The dry-run's 1x1 count (argument + temp + output - alias, and temp's
    bytes by kind at the peak) of each run phases 6 and 8 measured: the
    train step of qwen3-1.7b at 28 layers and of the MoE pair at
    TRAIN_MOE_DEPTHS over TRAIN_B x TRAIN_S tokens (``build_cell``), and
    the prefill of 4 x 1024 tokens into DECODE_SMAX slots of each decode
    model (``roofline.memory.count`` of ``prefill``, the kernels' CUDA
    paths, on meta): the parameters, the prompts, the peak and the logits
    and cache it returns."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.common import SHAPES_ONLY
    from repro_torch.models.model import build_model
    from repro_torch.roofline import memory
    from repro_torch.tree import leaves

    counts = {}
    shape = ShapeSpec("train", TRAIN_S, TRAIN_B, "train")
    for cfg in (get_config(TRAIN_ARCH), *(moe_config(a, n) for a, n in TRAIN_MOE_DEPTHS.items())):
        m = dryrun.build_cell(cfg, shape, "1x1").mem
        counts[f"train {cfg.name}"] = (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"] - m["alias_bytes"],
                                       m["temp_breakdown"])
    for arch in ARCHS:
        fns = build_model(get_config(arch))
        params = fns.init(SHAPES_ONLY)
        tokens = torch.empty((DECODE_B, PROMPT), dtype=torch.int64, device="meta")
        _, c = memory.count(fns.prefill, params, {"tokens": tokens}, max_seq=DECODE_SMAX, card=True)
        given = sum(t.numel() * t.element_size() for t in leaves(params)) + tokens.numel() * tokens.element_size()
        counts[f"prefill {arch}"] = (given + c.peak + c.output, c.breakdown)
    return counts


def dryrun_on_card(torch, dev, out: Path, dry, peaks) -> None:
    """Phase 9d: the dry-run, started after phase 8's train path
    (:func:`start_dryrun`, its
    processes ``dry`` writing into ``out``); while it runs, its ``1x1``
    count of qwen3-1.7b's train state (28 layers, AdamW) is held against
    the bytes ``make_train_state`` takes of the card's allocator, its
    count of phase 8's step against the prediction, and its memory counts
    (:func:`memory_counts`) against ``peaks``, the allocator's peaks that
    phases 6 and 8 read. Logs each cell's per-device bytes, products' FLOPs
    and collective bytes, and each measured run's count, peak, margin and
    bytes by kind. Gated: every applicable cell ok on every mesh; the
    allocated bytes at least the record's state bytes and at most
    :func:`alloc_slack` a tensor above them; the step's products' FLOPs
    equal to :func:`predicted_dot_flops`, logged beside ``train_bounds``'
    operations; each run of MEMORY_GATED counted within MEMORY_BAND of
    its peak, on either side."""
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.configs.base import SHAPE_ORDER, SHAPES, ShapeSpec, cell_applicable
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import abstract_train_state, make_train_state
    from repro_torch.roofline.costs import depth_flops
    from repro_torch.tree import flatten

    cfg = get_config(TRAIN_ARCH)
    state_bytes = dryrun.build_cell(cfg, SHAPES["train_4k"], "1x1").mem["state_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    before = allocated_bytes(torch, dev)
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    allocated = allocated_bytes(torch, dev) - before
    sizes = [t.numel() * t.element_size() for _, t in flatten(state)]
    del state
    torch.cuda.empty_cache()
    over, slack = allocated - state_bytes, sum(alloc_slack(n) for n in sizes)
    log(f"dry-run 1x1 {TRAIN_ARCH} train state: {state_bytes} B in {len(sizes)} tensors ({sum(sizes)} B "
        f"by their shapes); make_train_state took {allocated} B of the card's allocator ({over} B above, at "
        f"most {slack}: {ALLOC_ROUND} B a tensor, and {ALLOC_LARGE} B more for each of the "
        f"{sum(n > ALLOC_LARGE for n in sizes)} above {ALLOC_LARGE} B)")
    if not 0 <= over <= slack:
        raise AssertionError(f"dry-run state bytes {state_bytes} against {allocated} allocated")

    cell = dryrun.build_cell(cfg, ShapeSpec("train", TRAIN_S, TRAIN_B, "train"), "1x1")
    flops = depth_flops(cfg, cell.count)
    ops, _ = train_bounds(cfg, abstract_train_state(cfg)["params"], TRAIN_B * TRAIN_S, [])
    predicted = predicted_dot_flops(cfg, TRAIN_B, TRAIN_S)
    log(f"dry-run of phase 8's step ({TRAIN_ARCH}, {TRAIN_B} x {TRAIN_S} tokens, remat): {flops:.6e} "
        f"products' FLOPs, predicted {predicted:.6e}; train_bounds' operations {ops:.6e}: ratio "
        f"{flops / ops:.4f}, predicted {predicted / ops:.4f}")
    if flops != predicted:
        raise AssertionError(f"dry-run: {flops} products' FLOPs, predicted {predicted}")

    t0 = time.perf_counter()
    counts = memory_counts(torch)
    log(f"dry-run memory counts against the card's peaks ({time.perf_counter() - t0:.1f} s; 1x1, argument + "
        f"temp + output - alias; gated within {MEMORY_BAND:.0%}: {', '.join(MEMORY_GATED)}):")
    missed = []
    for label, (count, breakdown) in counts.items():
        peak = peaks[label]
        margin = (count - peak) / peak
        log(f"  {label}: count {count} B ({count / 1e9:.3f} GB), peak allocated {peak} B ({peak / 1e9:.3f} GB), "
            f"margin {100 * margin:+.2f}%{'' if label in MEMORY_GATED else ' (not gated)'}; temp by kind at its "
            "peak (GB): " + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in breakdown.items() if v))
        if label in MEMORY_GATED and abs(margin) > MEMORY_BAND:
            missed.append(label)
    if missed:
        raise AssertionError(f"dry-run memory counts outside {MEMORY_BAND:.0%} of the card's peaks: {missed}")

    t0 = time.perf_counter()
    records = []
    for (arch, mesh), proc in dry.items():
        if proc.wait(timeout=600) != 0:
            raise AssertionError(f"dry-run of {arch} on {mesh} exited {proc.returncode}: "
                                 f"{(out / f'{arch}_{mesh}.log').read_text()[-2000:]}")
        records += [json.loads(line) for line in (out / f"{arch}_{mesh}.jsonl").read_text().splitlines()]
    want = sum(cell_applicable(get_config(a), SHAPES[s])[0] for a in ASSIGNED for s in SHAPE_ORDER)
    ok = [r for r in records if r["status"] == "ok"]
    log(f"dry-run: {len(records)} records ({len(ok)} ok, waited {time.perf_counter() - t0:.1f} s); per device: "
        "arch shape mesh | argument GiB (state or params, cache, batch) | temp GiB | output - alias GiB | "
        "dot FLOPs | all-gather / reduce-scatter / all-reduce GB | fits 80 GiB")
    for r in ok:
        m, c = r["mem"], r["hlo_costs"]
        log(f"  {r['arch']} {r['shape']} {r['mesh']} | {m['argument_bytes'] / 2**30:.3f} | "
            f"{m['temp_bytes'] / 2**30:.3f} | {(m['output_bytes'] - m['alias_bytes']) / 2**30:.3f} | "
            f"{c['dot_flops']:.4e} | {c['collective_bytes']['all-gather'] / 1e9:.3f} / "
            f"{c['collective_bytes']['reduce-scatter'] / 1e9:.3f} / "
            f"{c['collective_bytes']['all-reduce'] / 1e9:.3f} | {r['fits_h100']}")
    log("dry-run: the train cells of the per-layer gathers on the production meshes, per device (GiB; the "
        "records as JSON after each line):")
    for arch in DRYRUN_FSDP_CELLS:
        for mesh in DRYRUN_MESHES[:2]:
            (r,) = [r for r in ok if (r["arch"], r["shape"], r["mesh"]) == (arch, "train_4k", mesh)]
            m = r["mem"]
            total = m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"] - m["alias_bytes"]
            log(f"  {arch} train_4k {mesh}: argument {m['argument_bytes'] / 2**30:.3f} + temp "
                f"{m['temp_bytes'] / 2**30:.3f} + output {m['output_bytes'] / 2**30:.3f} - alias "
                f"{m['alias_bytes'] / 2**30:.3f} = {total / 2**30:.3f}, fits_h100 {r['fits_h100']}; temp by kind "
                "at its peak: " + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in m["temp_breakdown"].items() if v))
            log("  " + json.dumps({k: r[k] for k in ("arch", "shape", "mesh", "mem", "fits_h100", "hlo_costs")}))
    if len(ok) != want * len(DRYRUN_MESHES) or any(r["status"] not in ("ok", "skipped") for r in records):
        raise AssertionError(f"dry-run: {len(ok)} cells ok of {want * len(DRYRUN_MESHES)}: "
                             f"{[r.get('error') for r in records if r['status'] == 'error'][:3]}")
    (rec,) = [r for r in ok if (r["arch"], r["shape"], r["mesh"]) == (TRAIN_ARCH, "train_4k", "1x1")]
    if rec["mem"]["state_bytes"] != state_bytes:
        raise AssertionError(f"dry-run: the 1x1 record's state bytes {rec['mem']['state_bytes']} != {state_bytes}")


def sim_scoreboard(report) -> dict:
    """A ``ServeReport``'s gated numbers: SIM_INT_KEYS, then SIM_FLOAT_KEYS."""
    board = {k: (report.result.switches if k == "switches" else getattr(report, k)) for k in SIM_INT_KEYS}
    board.update((k, getattr(report, k)) for k in SIM_FLOAT_KEYS)
    return board


def simulator_on_host() -> None:
    """Phase 10: ``examples/port_serve_trace.py``'s ``run`` at its defaults,
    each backend traced by a full hub. Gated: no JAX and no ``repro`` loaded,
    each scoreboard against SIM_REFERENCE (integers exactly, floats at
    SIM_RTOL), ``validate_trace`` clean on each exported trace, the phase
    within SIM_MAX_S of wall time."""
    from repro_torch.telemetry import Telemetry, validate_trace

    t0 = time.perf_counter()
    hubs = {backend: Telemetry(sample_stride=1, metrics=True, audit=True) for backend in SIM_REFERENCE}
    reports = example_module("port_serve_trace").run(telemetry=hubs)
    # each trace as a file holds it (write_chrome's JSON), read back
    traces = {backend: json.loads(json.dumps(hub.chrome_trace())) for backend, hub in hubs.items()}
    wall = time.perf_counter() - t0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if loaded:
        raise AssertionError(f"simulator: the reference is loaded: {loaded[:5]}")
    for backend, want in SIM_REFERENCE.items():
        got = sim_scoreboard(reports[backend])
        wrong = [k for k in SIM_INT_KEYS if got[k] != want[k]]
        wrong += [k for k in SIM_FLOAT_KEYS if not math.isclose(got[k], want[k], rel_tol=SIM_RTOL, abs_tol=0.0)]
        errors = validate_trace(traces[backend])
        hub = hubs[backend]
        audit = hub.audit.summary()["fleet"]
        log(f"simulator {backend}: {json.dumps(got)}; {len(hub.events)} events, {len(traces[backend]['traceEvents'])} "
            f"in the chrome trace, {len(hub.metrics_report().metrics)} metrics, prediction audit F- "
            f"{audit['false_negative_pct']} % F+ {audit['false_positive_pct']} %, stall totals "
            f"{json.dumps({k: round(v, 3) for k, v in hub.stall_totals().items()})}")
        if wrong:
            raise AssertionError(f"simulator {backend}: {[(k, got[k], want[k]) for k in wrong]} against the reference")
        if errors:
            raise AssertionError(f"simulator {backend}: validate_trace: {errors[:5]}")
    log(f"simulator: {wall:.3f} s wall for both runs, traced (limit {SIM_MAX_S} s)")
    if wall > SIM_MAX_S:
        raise AssertionError(f"simulator: {wall:.1f} s > {SIM_MAX_S} s")



def cluster_scoreboard(report) -> dict:
    """A ``ClusterReport``'s gated numbers: its ``to_row()``, the per-GPU rows
    as one list a column (``gpu_placed``, ...)."""
    row = report.to_row()
    gpus = row.pop("per_gpu")
    for key in ("placed", "finished", "faults", "migrated_bytes", "switches"):
        row[f"gpu_{key}"] = [g[key] for g in gpus]
    return row


def lifecycle_summary(control, order) -> dict:
    """Each lifecycle state's task count, in ``order``, as ``msctl demo``
    prints it."""
    states = list(control.lifecycle.states().values())
    return {s: states.count(s) for s in order if states.count(s)}


def cluster_mismatches(got: dict, want: dict) -> list:
    """(key, got, want) where a float differs beyond CLUSTER_RTOL or anything
    else differs at all, the key sets included."""
    def close(a, b):
        if isinstance(b, float):
            return isinstance(a, float) and math.isclose(a, b, rel_tol=CLUSTER_RTOL, abs_tol=0.0)
        return type(a) is type(b) and a == b

    keys = sorted(set(got) | set(want))
    return [(k, got.get(k), want.get(k)) for k in keys if k not in got or k not in want or not close(got[k], want[k])]


def cluster_on_host() -> None:
    """Phase 11: ``examples/port_cluster_serve.py``'s ``run`` over
    CLUSTER_GPUS GPUs with rebalancing, and ``scripts/port_msctl.py``'s crash
    demo fleet, the runs in CLUSTER_TRACED traced by a full hub. Nothing here
    launches a kernel: the cluster models its GPUs in host Python. Gated: no
    JAX and no ``repro`` loaded, every scoreboard against CLUSTER_REFERENCE
    (floats at CLUSTER_RTOL, all else exactly), ``validate_trace`` clean on
    each exported trace, the phase within CLUSTER_MAX_S of wall time."""
    from repro_torch.telemetry import Telemetry, validate_trace

    t0 = time.perf_counter()
    hubs = {name: Telemetry(sample_stride=1, metrics=True, audit=True) for name in CLUSTER_TRACED}
    reports = example_module("port_cluster_serve").run(gpus=CLUSTER_GPUS, migrate=True, telemetry=hubs)
    msctl = example_module("port_msctl", "scripts")
    reports["demo"], control = msctl._run_demo_fleet(True, telemetry=hubs["demo"])
    traces = {name: json.loads(json.dumps(hub.chrome_trace())) for name, hub in hubs.items()}
    wall = time.perf_counter() - t0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if loaded:
        raise AssertionError(f"cluster: the reference is loaded: {loaded[:5]}")
    for name, want in CLUSTER_REFERENCE.items():
        got = cluster_scoreboard(reports[name])
        if name == "demo":
            got["journal"] = len(control.journal)
            got["lifecycle"] = lifecycle_summary(control, msctl._ORDER)
        log(f"cluster {name}: {json.dumps(got)}")
        wrong = cluster_mismatches(got, want)
        if wrong:
            raise AssertionError(f"cluster {name}: {wrong[:8]} against the reference")
    for name, hub in hubs.items():
        errors = validate_trace(traces[name])
        log(f"cluster {name} traced: {len(hub.events)} events, {len(traces[name]['traceEvents'])} in the chrome trace, "
            f"{len(hub.metrics_report().metrics)} metrics")
        if errors:
            raise AssertionError(f"cluster {name}: validate_trace: {errors[:5]}")
    log(f"cluster: {wall:.3f} s wall for the four runs, two traced (limit {CLUSTER_MAX_S} s)")
    if wall > CLUSTER_MAX_S:
        raise AssertionError(f"cluster: {wall:.1f} s > {CLUSTER_MAX_S} s")


if __name__ == "__main__":
    main()
