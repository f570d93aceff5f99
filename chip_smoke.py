#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

  1. versions, the card's name and power limit, and the build of every
     CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the slice gives it (p = 11, E = 50,420, the plan's blocks:
     each CFD kernel's own tile, 3 elements a CTA step):
     float32 within rtol 5e-4 / atol 5e-4 max|plain|, and in bfloat16
     within one bfloat16 step (rtol 2^-7 / atol 1e-3 max|plain|; timed
     too: half the bytes for the same arithmetic, a probe of what bounds
     the kernel), and
     bitwise equality of one E-element call with two E/2 calls; times of
     kernel, plain version and (where one PyTorch call computes the same
     function: ``torch.einsum`` for interpolation and for the whole
     inverse Helmholtz, held against the plain version first, the faster
     of opt_einsum's path and einsum's own) that call, beside the least
     time the card could take; and the GEMM-chain kernel at
     interpolation's bytes with 0, 3 and 6 contractions (a probe that
     splits memory pipeline from contraction time);
  3. the slice: ``compile_cfd_pipeline(11, backends="pallas",
     batch_elements=50_420)`` (the E of earlier runs: the planner's own
     is 50,419, no longer padded to a block) and
     ``.run()`` over 8 batches of E elements, with the launch counters
     zeroed just before and read just after; pipelined and serial
     checksums bitwise equal; 64 elements of batch 0 against the float64
     numpy oracles;
  F. the paper's Fig. 2 path: ``run_simulation(SimConfig(p=11,
     backend="pallas"))`` on the h100-sxm plan (E = 67,226, BE = 3, the
     kernel's tile) over
     4 batches, launch counters zeroed just before and read just after;
     K = 1 and K = 0 checksums bitwise equal; the ``xla`` and ``staged``
     backends' checksums at the same E within rtol 1e-4; 64 elements of
     batch 0 through ``batched_fn`` against the float64 oracle; the
     kernel timed at this shape;
  Q. fixed point: the Inverse Helmholtz at p = 11 through
     ``api.compile_cfdlang`` at Q24.40 (E = 33,613) and Q8.24
     (E = 67,226), ``xla`` and ``staged``, one batch encoded on the host
     and run on the card: 16 elements bitwise equal to the same code on
     the CPU, ``xla`` bitwise equal to ``staged``, MSE against the float64
     oracle within 100x the paper's (9.39e-22, 3.58e-12); the peak device
     memory above the inputs, beside the 2.67 / 2.33 GiB measured while
     ``core.precision`` widened whole operands (commit 93b3fea) and the
     3.38 / 3.14 GiB while ``core.emit`` kept every intermediate (commit
     775a332);
  D. the single-operator design-space sweep on the card: ``explore`` over
     xla/staged/pallas at float32 on one card, the top three measured and
     the cost correction fitted;
  X. stage fusion and the chain DSE at p = 11 on the h100-sxm plans
     (n_eq = 2,000,000): the named cuts planned with ``max_stages=2``
     (interp+grad, E = 50,419) and ``max_stages=1`` (all three, E =
     40,335, a recipe of 15 element slots), and the 13-stage auto
     schedule compiled with ``fuse="auto"`` (three stages); every fused
     stage compiled to ``pallas``; one batch of each, counters zeroed
     just before and read just after (5 GEMM-chain launches, 1
     Helmholtz), with gy, gz and v bitwise equal to the unfused chains'
     on the same inputs (the fully fused v against the unfused chain
     whose Helmholtz stage runs its recipe on the GEMM-chain kernel,
     since the Helmholtz kernel contracts the modes in another order,
     and within rtol 5e-4 / atol 5e-4 max|ref| of the Helmholtz
     kernel's); each fused recipe on the kernel against its plain
     version at phase 2's tolerance, timed beside the unfused stages it
     replaces (at the same E), its plain version and its bound; then
     ``explore_chain`` over all 27 backend combinations of the all-kernel
     chain, the top three measured and the cost correction fitted;
  B. blocks at p = 11, float32: (a) each CFD kernel at every tile it
     launches with (te = 1 .. its largest) -- the Helmholtz kernel at the
     chain's and Fig. 2's shapes, the GEMM-chain kernel on interp and
     grad -- bitwise against its default tile, its default against the
     plain version at phase 2's tolerance, a ragged E = 50,419 bitwise
     against the whole batch's first 50,419 elements, the time of each
     tile beside the bound; (b) ``flow.compile(..., tune_blocks=True)``
     on the card, each stage's candidates, times and winner; (c) one
     batch of the named chain from arrays at per-stage E = (E, E/2, E/4)
     and (E/4, E, E/2), E = 50,420, counters zeroed just before and read
     just after, bitwise against the uniform serial run, each stage's
     kernel time at its E_s, and ``measure_chain_plan`` on the second;
  S. serving, tracing, metrics and the profile store on the named p = 11
     chain planned on h100-sxm (E = 50,419): ``PlanCache.get_or_compile``
     twice (a hit; ``plan_chain`` not called again); a ``ServeEngine``
     (K from the plan, ``max_wait_s=0.05``, a tracer, a metrics registry,
     an SLO tracker, a latency tracker) takes 16 requests of 2,000-18,000
     elements drawn from seed 0 and one of 60,000, their rows made before
     the first submit, then ``drain()``, counters zeroed just before the
     first submit and read just after the drain; every request's gy, gz
     and v bitwise equal to serving it alone; elements/s over the
     window, request latency p50/p99 (queue and execute), waves, pad rows
     and the device's busy share (CUDA-event dispatch time over the
     window); the metrics snapshot checked and reconciled with the
     trace's serve counters; then ``run_chain`` traced over 4 batches of
     the served rows with a ``StepMonitor`` (counters zeroed and read
     around it): the Chrome JSON through ``python -m repro_torch.trace``,
     channel-byte counters exactly 4 x host_stream_bytes, the stable
     attribution equal to the same plan's on the CPU, each stage's
     CUDA-event time a batch beside phase 2's kernel time; finally
     ``flow.compile(tune_blocks=True, profile=store)`` and the traced
     run recorded into a store in a temporary directory: its keys carry
     the card's fingerprint, and ``plan_chain(profile=store)`` fits
     contention;
  M. element-axis placement over the device pool [cuda:0, cuda:0] (two
     slots on the one card): the named chain at p = 11 planned on
     h100-sxm for two devices with cu_count (1, 2, 1) (E = 50,418, the
     planner's E snapped to shard evenly; interp on slot 0, grad sharded
     over slots 1 and 0, Helmholtz on slot 1) over 4 batches of given
     rows, outputs collected, counters zeroed just before and read just
     after: every output bitwise the serial one-slot run at that E, each
     kernel launched batches x shards times; both traced again for each
     stage's and each handoff's device time a batch; the reference's
     two-kind case (h100:1,alveo:1, stage groups (0, 1, 1), E_s (E/2, E,
     E)) bitwise; Fig. 2 with two CUs, its checksum within rel 1e-4 of
     phase F's; ``measure_chain_plan`` on the placed plan; phase S's 17
     requests served over the pool (E = 50,418), each bitwise its
     one-slot answer; with two cards the chain once more over [cuda:0,
     cuda:1], else a line saying it was not done;
  4. the flash-attention kernels against their plain version at the
     model path's shape (B = 4, Hq = 16, Hkv = 8, T = 4096, d = 128,
     causal): bfloat16 on the tensor-core (wgmma) route, float32 on the
     CUDA-core (fma) route, plus Tq = 512 < Tk = 4096, a non-causal
     case, phase E's two shapes (olmoe: B = 4, Hq = Hkv = 16; dbrx:
     B = 2, Hq = 48 over Hkv = 8) and phase J's (jamba: B = 2, Hq = 64
     over Hkv = 8; all T = 4096, d = 128, bfloat16, causal), and phase
     W's two at d = 64 (whisper's encoder: B = 16, Hq = Hkv = 6, T =
     1,500, non-causal, one whole-axis block; its decoder: T = 448,
     causal), each checked to run on its route; bitwise equality of G heads
     with two calls of G/2; times of kernel, plain version and
     ``scaled_dot_product_attention`` (``is_causal`` at Tq = Tk; at
     Tq < Tk the end-aligned mask ``causal_lower_right(Tq, Tk)``);
     then the backward kernels, split by the same routes
     (``csrc/flash_attention_bwd_sm90.cu`` on tensor cores,
     ``csrc/flash_attention_bwd.cu`` on CUDA cores), at phase T's
     training shape (B = 4, Hq = 16, Hkv = 8, T = 4096, d = 128,
     bfloat16, causal; wgmma), a float32 smoke shape at d = 16 (fma) and
     whisper-tiny's decoder (B = 16, Hq = Hkv = 6, T = 448, d = 64,
     causal; wgmma): the forward kernel's output with its LSE written
     bitwise the output without it, the LSE of both forward routes
     against the plain version's, dq, dk and dv against
     ``flash_attention_bwd_plain`` on the same (q, k, v, o, lse, do)
     (float32 by the f32 rule; bfloat16 within rtol 8e-3 / atol 1e-3
     max|plain|), two calls bitwise equal, one count a call on the
     case's route; times of kernel, plain version and SDPA's backward
     (``torch.autograd.grad`` with ``retain_graph``), beside the bound
     (10 d flops a visible pair at the peak of the dtype), and the
     route's kernels' ptxas registers and spills;
  5. the model path: ``build_model(configs.get("internlm2-1.8b"))`` at
     full size (24 layers, bfloat16, random weights from generator seed
     0), one scoring ``forward`` on tokens (4, 4096) with the launch
     counters zeroed just before and read just after (exactly 24 flash
     launches, all on the wgmma route), its next-token loss, and the
     same forward with ``attn_impl="xla"``; then serving: prefill of a
     512-token prompt at batch 4, 32 greedy decode steps, and their
     logits against the teacher-forced forward of the same sequence;
  E. the MoE decoders: ``moe_apply`` on the card against the CPU
     (olmoe's smoke config in float32, the same params on both, a
     capacity that drops about half of the assignments, 1 and 4 groups,
     both combine modes: within rtol 1e-5 / atol 1e-5 max|CPU|, equal
     counts of kept assignments); ``build_model(configs.get(
     "olmoe-1b-7b"))`` whole (16 layers, 64 experts top-8, bfloat16,
     random weights from generator seed 0): a scoring forward on (4, 4096)
     tokens, counters zeroed just before and read just after (exactly 16
     flash launches, all wgmma), its next-token loss within 2 of ln V,
     the share of assignments the default capacity drops, and its logits
     against ``attn_impl="xla"``; prefill of (4, 512) and 32 greedy decode
     steps against the teacher-forced forward (prefill and that forward
     with one slot per token, so nothing drops); then dbrx-132b at its
     published widths with the depth cut to 2 of 40 layers, a scoring
     forward on (2, 4096) (2 wgmma launches) against ``attn_impl="xla"``.
     Logits are held by phase 5's bounds; where a router near-tie sent a
     position to other experts in the two runs, the max|diff| bound holds
     on the positions routed alike and the argmax bound on all;
  R. the xLSTM: ``mlstm_apply``, ``mlstm_apply_chunked`` and
     ``slstm_apply`` on the card against the CPU (xlstm-125m's smoke
     config in float32, with and without a carried state: within rtol
     1e-5 / atol 1e-5 max|CPU|); ``build_model(configs.get("xlstm-125m"))``
     whole (12 layers: 9 mLSTM, 3 sLSTM; bfloat16, random weights from
     generator seed 0) against the same code on the CPU on (2, 128)
     tokens, at ``MLSTM_CHUNK`` None and 64; a scoring forward of (4,
     4096) on the exact recurrent scan (at (4, 1024) if a timed (4, 256)
     forward says (4, 4096) would take over 60 s) and one on chunks of 64,
     their logits held against each other; the chunked forward's and the
     recurrent loops' launches and kernel time a step (profiles at 256
     and 512 tokens for the chunked forward, 8 and 16 steps for the
     recurrent loops, differenced) multiplied out, an sLSTM and a
     chunked mLSTM layer timed alone; prefill of (4, 512) and 32 greedy
     decode steps on the recurrent state against the teacher-forced
     forward, prefill's cost multiplied out the same way (8 and 16
     steps) and one decode step profiled.  Logits by phase 5's bounds;
     the path reaches no kernel of the port (counters zeroed just before
     each forward, prefill and decode, all 0 just after);
  J. the jamba hybrid: ``mamba_apply`` on the card against the CPU
     (jamba's smoke config in float32, (2, 128), with and without a
     carried state: within rtol 1e-5 / atol 1e-5 max|CPU|) and the smoke
     hybrid's forward (one flash launch, fma route at d = 16) against
     the CPU by phase 5's logit bounds; then, with the earlier phases'
     models freed, ``build_model`` of jamba-1.5-large at its published
     widths cut to one period (8 of 72 layers) and 8 of 16 experts
     (bfloat16, random weights from generator seed 0, 25.37 B params):
     a scoring forward on (2, 4096) tokens, counters zeroed just before
     and read just after (exactly one flash launch, on wgmma), against
     ``attn_impl="xla"`` by phase 5's bounds on the positions routed
     alike in every MoE layer and the argmax bound on all; tokens/s,
     the drop share at the default capacity, peak memory above the
     params; the Mamba loops' launches and kernel time a step (profiles
     of forwards at 64 and 128 tokens, differenced) multiplied out, a
     Mamba mixer, an MoE layer, a dense MLP and the attention layer
     timed alone at (2, 4096) and the busy share; prefill of (4, 512)
     and 32 greedy decode steps against the teacher-forced forward, one
     decode step profiled;
  W. the encoder-decoder: whisper-tiny's smoke config in float32 on the
     card against the CPU at the published 1,500 frames (``encode`` and
     a whole ``encdec_forward`` through the flash kernel on its fma route
     against its plain version, within rtol 1e-5 / atol 1e-5 max|CPU|);
     then ``build_model(configs.get("whisper-tiny"))`` at its published
     widths, nothing cut (4 + 4 layers, d 384, 6 heads of 64, vocab
     51,865, 1,500 frames; bfloat16, random weights from generator seed
     0; the conv frontend stubbed, as in the reference, so frames are
     random d_model embeddings): a scoring forward on 16 x (1,500
     frames, 448 tokens), counters zeroed just before and read just
     after (exactly 8 flash launches, all wgmma: 4 encoder layers at one
     whole-axis block, 4 causal decoder layers), against
     ``attn_impl="xla"`` by phase 5's bounds, profiled; prefill of the
     4-token prompt (exactly 4 launches, the encoder's) and 32 greedy
     decode steps (none) against the teacher-forced forward, one decode
     step profiled, and the cross-attention's K and V projections of
     every frame, which each step recomputes, timed alone;
  T. training: the smoke internlm2 (float32) on the card against the
     CPU from the same params and batch (the loss within rtol 1e-5, every
     gradient within rtol 1e-4 / atol 1e-4 max|CPU|, two AdamW steps'
     updates within 1e-3 relative L2 a leaf); the smoke model trained 3 steps,
     checkpointed, trained 2 more, then restored and trained the same 2
     again: losses and every state leaf bitwise equal; then
     internlm2-1.8b whole (published widths, bfloat16, remat "block",
     seed 0) trained 5 AdamW steps of 4 x 4,096 ``TokenStream`` tokens
     through ``PrefetchPipeline``, counters zeroed just before and read
     just after (exactly 48 forward flash launches a step, 24 of them
     the remat recompute, and 24 backward calls, all on the wgmma
     route): seconds, tokens/s,
     loss, grad norm and lr a step, peak memory, a step's busy share and
     top kernels; and one step at 4 x 1,024 through the kernels against
     ``attn_impl="xla"`` (loss within 0.5 %, each gradient leaf within
     2 % relative L2); every family's smoke step (float32, 2 x 16) on the
     card against the CPU (the loss within rtol 1e-5, each gradient leaf
     within 1e-4 x the tree's largest |gradient|); and the sharded step at world
     size 1: internlm2-1.8b's state distributed over a 1 x 1
     ``DeviceMesh`` (``distributed.sharding.distribute_state``, the
     one-process nccl group of ``launch.mesh.make_local_mesh``), 3 steps
     of 4 x 1,024 against the unsharded step from a copy of the state,
     counters zeroed just before each step and read just after (48 + 24
     flash calls, all wgmma): loss, grad norm and every state leaf
     bitwise equal, and both steps' seconds;
  Y. the dry run (``repro_torch.launch.dryrun``), after phase T and
     alone, in a process of its own (its fake group of 256 ranks must
     not meet phase T's nccl group): the single-pod cells of
     ``decode_32k`` for every arch and of ``train_4k`` for every arch
     but the two whose loops are composed from short runs (the xLSTM
     and jamba, 40-160 s each on the host; the tests hold their
     composition), xlstm-125m's ``prefill_32k`` (composed; its
     temporaries within 2x the reference's 0.86 GiB), and
     internlm2-1.8b's ``train_4k`` and ``decode_32k``
     on the multi-pod 2 x 16 x 16 mesh, on meta tensors with nothing on
     the card, each with status, seconds, per-device GFLOPs, bytes,
     collective bytes, memory and bound, none in error; then two card
     checks, each a step counted on the card by ``FlopCounterMode``
     that equals the dry run's 1 x 1 count of it exactly, with three
     timed steps' seconds and peak memory printed against the
     roofline's max(t_compute, t_memory) and the predicted arguments +
     temporaries: phase T's check step (internlm2-1.8b, 4 x 1,024,
     attn_impl="xla", one AdamW step, no flash launch) and phase T's
     training step (4 x 4,096 through the flash kernels' ops, remat
     "block", one AdamW step; counters zeroed just before the counted
     step and read just after: 48 forward and 24 backward launches, all
     wgmma);
  6. one JSON line describing every kernel (the flash row's launches
     are phase 5's, phase E's and phase J's scoring forwards', phase
     W's forward and prefill, phase T's steps, the sharded ones
     included, and phase Y's counted kernel-path step; the backward's
     are phase T's steps and phase Y's), then the result line.

Without a CUDA device, or without the repository beside it, it exits
with a non-zero code before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"
sys.path.insert(0, str(SRC))
try:
    from repro_torch.memory.channels import H100_SXM, H100_SXM_BF16_FLOPS
except ImportError:     # no repository beside this file: main() says so
    H100_SXM = H100_SXM_BF16_FLOPS = None

#: H100 SXM datasheet peaks the bounds are computed against
#: (``repro_torch.memory.channels``, one source with the roofline)
PEAK_BYTES_PER_S = H100_SXM and H100_SXM.hbm_bw          # 3.35 TB/s
PEAK_F32_FLOPS = H100_SXM and H100_SXM.peak_flops        # CUDA cores
PEAK_BF16_FLOPS = H100_SXM_BF16_FLOPS                    # dense tensor cores
N_BATCHES = 8
CHECK_ELEMENTS = 64
F32_RTOL, F32_ATOL_FRAC = 5e-4, 5e-4
#: the CFD kernels in bfloat16: kernel and plain version compute in
#: float32 from the same bfloat16 inputs and round once, so they differ
#: by one bfloat16 step (rtol 2^-7) where their float32 values straddle a
#: rounding boundary, plus a small floor for that float32 difference
BF16_RTOL, BF16_ATOL_FRAC = 2 ** -7, 1e-3
#: flash attention in bfloat16, per element: one bfloat16 step of the
#: output (rtol 8e-3, where the two float32 values straddle a rounding
#: boundary), a small absolute floor for their float32 difference near
#: zero, and -- on the wgmma route, which rounds p to bfloat16 for the PV
#: product -- one bfloat16 rounding of the p terms, 2^-8 sum_j p_j |v_j| / l,
#: which the plain version returns beside its result: scores summed in
#: another float32 order can round a p to the other bfloat16 neighbour.
#: Bounded per element, so a row of typical size (about 0.03 at T = 4096)
#: is held as tightly as the largest one; a dropped key tile or a scale
#: 1 % off fails it
FLASH_BF16_RTOL, FLASH_BF16_ATOL_FRAC = 8e-3, 1e-4
#: the model path: internlm2-1.8b at full width and depth
MODEL_ARCH = "internlm2-1.8b"
SCORE_BATCH, SCORE_LEN = 4, 4096
PROMPT_LEN, DECODE_STEPS = 512, 32
#: kernel logits against another bfloat16 path to the same logits
#: (plain-op attention, which rounds p to bfloat16 before the PV product;
#: the cached prefill/decode path, whose products have other shapes):
#: they round at other places, so logits of order 1 differ by bfloat16
#: noise -- about 1 % of max|logits| on an H100 -- and near-ties may swap
#: the argmax.  Allowed: 5 % and 90 % agreement.
LOGIT_ATOL_FRAC, LOGIT_MIN_ARGMAX = 0.05, 0.9
#: the one-call yardsticks of the CFD kernels (timed, never used by the
#: port): interpolation, and the whole inverse Helmholtz with D as a
#: Hadamard factor; the element tensor comes first, so that einsum's
#: left-to-right path is the sequence of mode contractions
INTERP_EINSUM = "elmn,il,jm,kn->eijk"
HELMHOLTZ_EINSUM = "eabc,la,mb,nc,elmn,li,mj,nk->eijk"
#: the auto schedule's last fused stage (s8..s12): t0 contracted in mode
#: 1, D as a Hadamard factor, then S transposed in every mode
HELMHOLTZ_TAIL_EINSUM = "eazc,bz,eabc,ai,bj,ck->eijk"
#: the Fig. 2 path: batches of the run, and the plan's batch
FIG2_BATCHES = 4
FIG2_E = 67_226
#: checksums of the xla / staged backends against the kernel's: float32
#: sums of the same 4 x 67,226 x 1,331 values in other orders
FIG2_CHECKSUM_RTOL = 1e-4
#: fixed point: elements compared bitwise with the CPU; the paper's MSEs
FIXED_CPU_ELEMENTS = 16
PAPER_MSE = {"fixed64_q24.40": 9.39e-22, "fixed32_q8.24": 3.58e-12}
MSE_SLACK = 100.0
#: phase X: the problem size the fusion and chain-DSE plans assume
FUSION_N_EQ = 2_000_000
#: phase 3: the batch of earlier runs, whose checksums it repeats (the
#: planner's own E is 50,419 since E is not padded to a block)
SLICE_E = 50_420
#: E of phase B's alveo-u280 plan (its VMEM blocks divide it)
REF_TARGET_E = 4096
#: phase Q: device memory above the inputs (GiB) while core.emit kept
#: every intermediate to the end (commit 775a332; NVIDIA H100 80GB HBM3,
#: 700 W), before it freed each after its last reader
KEEP_ALL_PEAK_GIB = {"fixed64_q24.40": 3.38, "fixed32_q8.24": 3.14}
#: phase Q: the same peaks once emit freed each intermediate, while
#: core.precision still widened whole operands (commit 93b3fea; NVIDIA
#: H100 80GB HBM3, 700 W)
WHOLE_WIDEN_PEAK_GIB = {"fixed64_q24.40": 2.67, "fixed32_q8.24": 2.33}
#: phase S: the served chain's E (the planner's own on h100-sxm), the
#: requests (16 drawn from seed 0 in [2,000, 18,000] elements, one of
#: 60,000 spanning two waves), the coalescing latency knob, and the
#: batches of the traced run_chain
SERVE_P, SERVE_E = 11, 50_419
SERVE_REQUESTS, SERVE_SIZES, SERVE_BIG = 16, (2_000, 18_000), 60_000
SERVE_MAX_WAIT_S = 0.05
TRACE_BATCHES = 4
#: phase M: the placed chain's width, per-stage CU counts (interp on slot
#: 0, grad sharded over slots 1 and 0, Helmholtz on slot 1) and batches;
#: a checksum over two slots sums per-shard sums: another float32 order
PLACE_P, PLACE_CUS, PLACE_BATCHES = 11, (1, 2, 1), 4
CHAIN_CHECKSUM_RTOL = 1e-4
#: phase E: the MoE decoders.  olmoe-1b-7b whole; dbrx-132b at its
#: published widths with its depth cut to 2 of 40 layers (131.6 B params
#: do not fit one card; 2 layers are 7.75 B), scored at batch 2
EXPERT_ARCH = "olmoe-1b-7b"
DBRX_ARCH, DBRX_LAYERS, DBRX_BATCH = "dbrx-132b", 2, 2
#: phase E: moe_apply on the card against the CPU (olmoe's smoke config,
#: float32): tokens (batch, length), a capacity that drops about half of
#: the assignments, and the tolerance -- both sum in float32, in another
#: order (the scatter mode's atomics in none)
MOE_CHECK_SHAPE, MOE_CHECK_CAPACITY = (4, 64), 32
MOE_CARD_RTOL = 1e-5
#: phase R: xlstm-125m whole at its published widths; the chunked
#: forward's chunk width (it divides SCORE_LEN and PROMPT_LEN)
XLSTM_ARCH, XLSTM_CHUNK = "xlstm-125m", 64
#: phase R: the recurrent forward runs at (4, SCORE_LEN) unless a timed
#: (4, XLSTM_PROBE_LEN) forward, multiplied out, says it would take more
#: than XLSTM_RECURRENT_LIMIT_S; then at (4, XLSTM_SHORT_LEN)
XLSTM_PROBE_LEN, XLSTM_RECURRENT_LIMIT_S, XLSTM_SHORT_LEN = 256, 60.0, 1024
#: phases R and J: the recurrent blocks on the card against the CPU
#: (smoke config, float32, (2, XLSTM_CHECK_LEN) inputs, a state from a
#: first (2, 64) call): rtol, and atol of that fraction of max|CPU| --
#: float32 sums and scans in another order; and a model on the card
#: against the same code on the CPU on (2, XLSTM_CHECK_LEN) tokens, by
#: phase 5's logit bounds
XLSTM_CARD_RTOL, XLSTM_CHECK_LEN = 1e-5, 128
#: phase R: the step counts whose profiles are differenced for the
#: launches and kernel time one step of a recurrent loop takes
XLSTM_STEP_PROFILE = (8, 16)
#: how many times :func:`per_step` profiles its two lengths before it
#: fails: the card's profiler has recorded fewer kernels at the longer
#: length than at the shorter (an sLSTM layer, 126 and 114) in one run
#: of several whose code was the same
PROFILE_TRIES = 3
#: phase J: jamba-1.5-large at its published widths, cut in depth and
#: in experts.  The reference builds n_layers // attn_period periods, so
#: one period of JAMBA_LAYERS = 8 is the least depth that keeps the 1:7
#: layout (72 layers are 9 periods); its four MoE layers of 16 experts
#: alone are 77.3 GB in bfloat16, so JAMBA_EXPERTS = 8 (top-2 routing,
#: d_ff_expert 24,576 and every width kept): 25.37 B params, 50.75 GB.
#: Scored at batch 2, as dbrx: batch 4 would put the MoE's float32
#: transients near the card's limit
JAMBA_ARCH, JAMBA_LAYERS, JAMBA_EXPERTS = "jamba-1.5-large-398b", 8, 8
JAMBA_BATCH = 2
#: phase J: the forward lengths whose profiles are differenced for the
#: launches and kernel time one step of the Mamba loops takes
JAMBA_STEP_PROFILE = (64, 128)
#: phase R: the chunked forward's lengths (multiples of XLSTM_CHUNK)
#: whose profiles are differenced, in place of one of the whole forward
XLSTM_CHUNKED_PROFILE = (256, 512)
#: phase W: whisper-tiny at its published widths, nothing cut: a batch
#: of 16 thirty-second windows (1,500 frames each) scored at whisper's
#: decoder context of 448 tokens; serving prefills its 4-token
#: start-of-transcript sequence, then decodes greedily
WHISPER_ARCH = "whisper-tiny"
WHISPER_BATCH, WHISPER_TOKENS, WHISPER_PROMPT = 16, 448, 4
#: phase W: the smoke encoder-decoder on the card against the CPU in
#: float32 at the published frame count, (2, frames) and (2, 64) tokens
WHISPER_CHECK_TOKENS = 64
#: the flash-attention kernel of each route
FLASH_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "fma": "src/repro_torch/csrc/flash_attention.cu"}
#: the backward kernel of each route (as the forward's: "wgmma" bfloat16
#: at head dims 64 and 128 on tensor cores, "fma" the rest on CUDA cores)
#: and the TPU-side function they replace (the reference's Pallas kernel
#: has no derivative)
FLASH_BWD_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                     "fma": "src/repro_torch/csrc/flash_attention_bwd.cu"}
FLASH_BWD_REPLACES = "src/repro/kernels/attention/xla_flash.py:96"
#: phase 4's backward rows: phase T's training shape (internlm2, B 4,
#: T 4,096, bfloat16, causal; wgmma), a float32 smoke shape at head dim 16
#: (internlm2's smoke config: 4 query heads over 2, B 2, T 256; fma) and
#: whisper-tiny's decoder self-attention (B 16, 6 heads, T 448, d 64,
#: causal; wgmma)
BWD_SMOKE_BATCH, BWD_SMOKE_LEN = 2, 256
#: the backward in bfloat16, per element: kernel and plain version compute
#: from the same inputs (q, k, v, do, and o and lse from the forward
#: kernel), sum in float32 and round at the same places (on the wgmma
#: route p and ds as product operands, each gradient once), so they differ
#: by one bfloat16 step where their float32 values straddle a rounding
#: boundary (2^-7 relative: rtol 8e-3), plus a floor for their two float32
#: summation orders over up to 8,192 rows a key (1e-3 max|plain|); a
#: dropped tile, a wrong D or a scale off by 1 % fails it.  float32 rows
#: take F32_RTOL / F32_ATOL_FRAC
BWD_BF16_RTOL, BWD_BF16_ATOL_FRAC = 8e-3, 1e-3
#: phase T: internlm2-1.8b trained whole (published widths, bfloat16,
#: remat "block") for TRAIN_STEPS AdamW steps of TRAIN_BATCH x TRAIN_LEN
#: tokens (configs/shapes.py's train_4k sequence length; its global batch
#: of 256 cut to 4 on one card), the launcher's optimizer settings
TRAIN_ARCH = MODEL_ARCH
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 4096, 5
#: phase T's peak memory before the vocab-parallel loss (NVIDIA H100
#: 80GB HBM3, 700 W); plain logits still pick their labels by a gather
#: (DTensor logits by the masked sum), so the peak should hold
TRAIN_PEAK_GATHER_GB = 46.69
#: phase T: the smoke step card against the CPU (float32) and the resume
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_LEN = 2, 128
#: phase T: one step through the kernels against attn_impl="xla" at
#: TRAIN_BATCH x TRAIN_CHECK_LEN: two bfloat16 paths that round at other
#: places (the kernels round p for PV in the forward, the plain path
#: rounds p before PV and differentiates that), so the loss within 0.5 %
#: and each leaf's gradient within 2 % relative L2
TRAIN_CHECK_LEN = 1024
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 5e-3, 2e-2
#: phase T's smoke step on the card against the CPU (float32): loss rtol
#: 1e-5, each gradient within rtol 1e-4 / atol 1e-4 max|CPU| (float32 sums
#: in another order through two layers and the attention kernels), and
#: each leaf's update after two AdamW steps within 1e-3 relative L2 of
#: the CPU's.  Not entry by entry: Adam's step is a ratio of moments, so
#: an entry with a small gradient carries that gradient's relative error
#: (up to ~1e-3 at |g| ~ 1e-4 max|g|) into its update whole
TRAIN_CARD_LOSS_RTOL, TRAIN_CARD_GRAD_TOL, TRAIN_CARD_UPDATE_L2 = 1e-5, 1e-4, 1e-3
#: phase T: every family's smoke step (float32, B 2 x T 16, seeded
#: tokens) on the card against the CPU: the loss within rtol 1e-5, each
#: gradient leaf within 1e-4 x the tree's largest |gradient| on the CPU
#: (tests/test_torch_train_families.py's bound: float32 sums in another
#: order, and leaves whose gradients are float32 noise)
FAMILY_BATCH, FAMILY_LEN, FAMILY_GRAD_FRAC = 2, 16, 1e-4
#: phase T: the sharded step at world size 1 -- internlm2-1.8b whole on a
#: 1 x 1 mesh of the one-process nccl group against the unsharded step
#: from the same state, TRAIN_SHARDED_STEPS steps of TRAIN_BATCH x
#: TRAIN_SHARDED_LEN tokens, each bitwise equal (loss, grad norm, every
#: param and moment): on one rank every redistribution is a no-op
TRAIN_SHARDED_LEN, TRAIN_SHARDED_STEPS = 1024, 3
#: phase Y: the dry run's single-pod cells built on the host, after
#: phase T and alone (every arch at these shapes but DRYRUN_COMPOSED's
#: train_4k, whose loops ``scancost`` composes from short runs: 40-160 s
#: a cell), DRYRUN_MULTIPOD's cells on the 2 x 16 x 16 mesh, and its
#: 1 x 1 counts of phase T's check step (TRAIN_BATCH x TRAIN_CHECK_LEN,
#: attn_impl="xla") and of phase T's training step (TRAIN_BATCH x
#: TRAIN_LEN through the flash kernels' ops, attn_impl="auto"), each held
#: against the card's
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_COMPOSED = ("xlstm-125m", "jamba-1.5-large-398b")
DRYRUN_MULTIPOD = (("internlm2-1.8b", "train_4k"),
                   ("internlm2-1.8b", "decode_32k"))
#: phase Y's composed single-pod cells that it runs (four short runs,
#: 15-30 s), each with the reference's temporaries in GiB (its JAX
#: compile on 512 forced host devices, the production cell of
#: ``tests/test_torch_dryrun.py``): the port's must stay within
#: DRYRUN_TEMP_RATIO of them -- each rank steps its own rows of the
#: xLSTM's recurrences (it held the global batch's: 15.22 GiB)
DRYRUN_RECURRENT = (("xlstm-125m", "prefill_32k", 0.86),)
DRYRUN_TEMP_RATIO = 2.0
#: phase Y's cells that must fit one H100's 80 GiB (arguments plus
#: temporaries a device): the multi-pod train cell whose attention and MLP
#: the sharded step used to leave whole on every rank of the model axis
DRYRUN_FIT = (("internlm2-1.8b", "train_4k", "multipod"),)
DRYRUN_FIT_BYTES = 80 * 2 ** 30
DRYRUN_TIMEOUT_S = 300
#: the dry run on the host: cells, then the two steps' counts (last line)
DRYRUN_HOST = """
import json, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
from repro_torch import configs
from repro_torch.analysis import roofline
from repro_torch.configs import shapes as shape_mod
from repro_torch.launch import dryrun, mesh as mesh_mod
job = json.loads(sys.argv[2])
results = tempfile.mkdtemp(prefix="dryrun_smoke_")
cells = [(arch, name, "single") for arch in configs.ARCH_IDS
         for name in job["shapes"]
         if not (arch in job["composed"] and name == "train_4k")]
cells += [(arch, name, "single") for arch, name, _ in job["recurrent"]]
cells += [(arch, name, "multipod") for arch, name in job["multipod"]]
out = {"cells": []}
for arch, name, mesh_kind in cells:
    t = time.perf_counter()
    rec = dryrun.run_cell(arch, name, mesh_kind, results_dir=results)
    rec.pop("traceback", None)
    rec["seconds"] = time.perf_counter() - t
    rec["vocab"] = configs.get(arch).vocab
    # RoPE's angle table of the whole batch: (B, 1, T, hd / 2)
    cfg = configs.get(arch)
    spec = shape_mod.SHAPES[name]
    rec["rope_table"] = ([spec.global_batch, spec.seq_len, cfg.hd // 2]
                         if cfg.rope_theta > 0 else None)
    out["cells"].append(rec)
cfg = configs.get(job["arch"])
mesh = dryrun.fake_mesh(mesh_mod.MeshShape(("data", "model"), (1, 1)))
dryrun.set_dispatch(mesh, False)
for key, impl, seq_len in (("check", "xla", job["check_len"]),
                           ("check_auto", "auto", job["train_len"])):
    shape_mod.SHAPES[key] = shape_mod.ShapeSpec(key, "train", seq_len,
                                                job["batch"])
    c = dryrun.count_cell(cfg, key, mesh, attn_impl=impl)
    r = roofline.analyze(c, arch=cfg.arch_id, shape=key, mesh_name="1x1",
                         chips=1, model_flops_value=c["model_flops"])
    out[key] = dict(flops=c["flops"], bytes=c["bytes"], memory=c["memory"],
                    t_compute=r.t_compute, t_memory=r.t_memory,
                    seconds=c["seconds"], seq_len=seq_len, attn_impl=impl)
dryrun.release_fake_group()
print(json.dumps(out))
"""


class SmokeFailure(RuntimeError):
    """A phase found the port wrong or unable to run."""


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


def compare(got, want, rtol: float, atol_frac: float, what: str,
            extra=None) -> float:
    """Elementwise ``|got - want| <= atol + rtol |want| (+ extra)`` with
    ``atol = atol_frac * max|want|``; returns max|got - want|, fails
    otherwise."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    atol = atol_frac * want.abs().max().item()
    bound = atol + rtol * want.abs()
    if extra is not None:
        bound += extra
    bad = err > bound
    if bad.any():
        fail(f"{what}: {int(bad.sum())} entries off, max |err| "
             f"{err.max().item():.3e} (atol {atol:.3e}, rtol {rtol})")
    return err.max().item()


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def einsum_ms(equation: str, operands, want, what: str):
    """The yardstick of a CFD kernel: one ``torch.einsum`` call, held
    against the plain version and then timed, with opt_einsum's path
    (where it is installed) and with einsum's own left-to-right path;
    returns the faster time and a line naming both."""
    import torch

    flag = torch.backends.opt_einsum
    times = {}
    for opt in ([True, False] if flag.is_available() else [False]):
        saved, flag.enabled = flag.enabled, opt
        try:
            fn = lambda: torch.einsum(equation, *operands)
            compare(fn(), want, F32_RTOL, F32_ATOL_FRAC,
                    f"einsum {what} (opt_einsum {opt})")
            times["opt_einsum" if opt else "left to right"] = time_ms(fn, 20)
        finally:
            flag.enabled = saved
    txt = "einsum " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
    return min(times.values()), txt


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over ``peak`` (default the f32 CUDA-core peak),
    whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _wrappers():
    from repro_torch.kernels.attention import attention
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.helmholtz import helmholtz

    return {"helmholtz": helmholtz.inverse_helmholtz,
            "gemm_chain": gemm.gemm_chain,
            "flash_attention": attention.flash_attention}


def zero_counts() -> None:
    """Set every kernel's launch count to 0 (just before a main path):
    the forward kernels' (``read_counts``) and the flash backward's
    (``read_bwd_count``)."""
    from repro_torch.kernels.attention import attention

    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["flash_attention"].launches_by_route.update(wgmma=0, fma=0)
    attention.flash_attention_bwd.launches = 0
    attention.flash_attention_bwd.launches_by_route.update(wgmma=0, fma=0)


def read_bwd_count() -> int:
    """The flash backward's calls since ``zero_counts`` (only training
    reaches it)."""
    from repro_torch.kernels.attention import attention

    return attention.flash_attention_bwd.launches


def read_bwd_routes() -> dict:
    """The flash backward's calls by route since ``zero_counts``."""
    from repro_torch.kernels.attention import attention

    return dict(attention.flash_attention_bwd.launches_by_route)


def read_counts() -> dict:
    """Every kernel's launch count (just after a main path)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_setup():
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  opt_einsum "
          f"{torch.backends.opt_einsum.is_available()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    # float32 products in full float32 (the kernels' plain versions, the
    # cache path's scores): no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)} | count "
          f"{torch.cuda.device_count()}")
    from repro_torch.kernels import _cuda

    _cuda.library()
    print(f"kernels built in {_cuda.build_seconds:.1f} s "
          f"({_cuda.nvcc_path()}, sm_90a)")
    for line in ptxas_summary(_cuda.build_log):
        print(f"  {line}")
    return card


def kernel_label(mangled: str) -> str:
    """A compiled kernel's name from its mangled one, with its template
    arguments: the storage dtype first, then the integers (a CFD kernel's
    p, a flash kernel's head dim), e.g. ``flash_bwd_sm90_dq_kernel<128>``."""
    import re

    # the nested name: <length><identifier> pieces after _ZN (or one after _Z)
    pos, name = (3 if mangled.startswith("_ZN") else 2), None
    while (m := re.match(r"\d+", mangled[pos:])):
        n, start = int(m.group()), pos + len(m.group())
        piece = mangled[start:start + n]
        pos = start + n
        if piece.endswith("_kernel"):
            name = piece
            break
    if name is None:
        return mangled[:60]
    rest = mangled[pos:]
    if not rest.startswith("I"):
        return name
    part = rest[:rest.find("Ev")] if "Ev" in rest else rest
    args = (["bf16"] if "13__nv_bfloat16" in part
            else ["f32"] if re.search(r"(?:^I|E)f(?:L|E|$)", part) else [])
    args += re.findall(r"Li(\d+)E", part)
    return f"{name}<{', '.join(args)}>"


def ptxas_summary(build_log) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output: its
    name (:func:`kernel_label`), registers and spills."""
    import re

    out, name, spill = [], "?", ""
    for line in "\n".join(build_log).splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; "
                       f"{spill or 'no spill report'}")
            name, spill = "?", ""
    return out


def phase_kernels(system):
    """Each kernel against its plain version at the slice's shapes."""
    import torch

    from repro_torch.flow import patterns
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.helmholtz import helmholtz

    dev = torch.device("cuda", 0)
    plan = system.plan
    E = plan.batch_elements
    p = system.program.inputs["u"].shape[0]
    blocks = {sp.name: sp.block_elements for sp in plan.stages}
    progs = {s.name: s.program for s in system.chain.stages}
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    rows = {}

    def split_calls(fn, E, be):
        """fn(lo, hi, be) on both halves, concatenated (bitwise check)."""
        half = E // 2
        return be, lambda: fn(0, half, be), lambda: fn(half, E, be)

    # -- helmholtz -----------------------------------------------------------
    be = blocks["helmholtz"]
    S, D, u = uniform(p, p), uniform(E, p, p, p), uniform(E, p, p, p)
    got = helmholtz.inverse_helmholtz(S, D, u, block_elements=be)
    want = helmholtz.inverse_helmholtz_plain(S, D, u, block_elements=be)
    torch.cuda.synchronize()
    err = compare(got, want, F32_RTOL, F32_ATOL_FRAC, "helmholtz f32")
    Sb, Db, ub = S.bfloat16(), D.bfloat16(), u.bfloat16()
    got_b = helmholtz.inverse_helmholtz(Sb, Db, ub, block_elements=be)
    want_b = helmholtz.inverse_helmholtz_plain(Sb, Db, ub, block_elements=be)
    err_b = compare(got_b, want_b, BF16_RTOL, BF16_ATOL_FRAC, "helmholtz bf16")
    be2, lo, hi = split_calls(
        lambda a, b, k: helmholtz.inverse_helmholtz(
            S, D[a:b], u[a:b], block_elements=k), E, be)
    if not torch.equal(got, torch.cat([lo(), hi()])):
        fail(f"helmholtz: E={E} (BE={be}) differs bitwise from two E/2 "
             f"calls (BE={be2})")
    ms = time_ms(lambda: helmholtz.inverse_helmholtz(S, D, u, block_elements=be), 20)
    # probe: bfloat16 moves half the bytes for the same arithmetic
    ms_bf16 = time_ms(
        lambda: helmholtz.inverse_helmholtz(Sb, Db, ub, block_elements=be), 20)
    plain_ms = time_ms(
        lambda: helmholtz.inverse_helmholtz_plain(S, D, u, block_elements=be), 3)
    # one PyTorch call computes v = S(x)3 (D o S^T(x)3 u): left to right it
    # contracts a, b, c, multiplies by D and contracts l, m, n, the
    # kernel's own order
    library_ms, lib_txt = einsum_ms(HELMHOLTZ_EINSUM, (u, S, S, S, D, S, S, S),
                                    want, "helmholtz")
    b_ms, b_by = bound(nbytes(S, D, u, got), E * progs["helmholtz"].total_flops())
    rows["helmholtz"] = [dict(stage="helmholtz", block_elements=be, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=library_ms, max_abs_err=err,
                              max_abs_err_bf16=err_b, ms_bf16=ms_bf16)]
    print(f"helmholtz  E={E} BE={be}: f32 max|err| {err:.3e}, bf16 "
          f"{err_b:.3e}, split bitwise ok | kernel {ms:.3f} ms (bf16 "
          f"{ms_bf16:.3f} ms)  plain "
          f"{plain_ms:.3f} ms  {lib_txt}  bound {b_ms:.3f} ms ({b_by})")
    del D, u, got, want, Sb, Db, ub, got_b, want_b

    # -- gemm chain: interpolation and gradient ------------------------------
    rows["gemm_chain"] = []
    for stage in ("interp", "grad"):
        recipe = patterns.match_gemm_chain(progs[stage])
        if recipe is None:
            fail(f"stage {stage} does not match the GEMM-chain kernel")
        be = blocks[stage]
        env = {
            name: (uniform(E, *shape) if is_elem else uniform(*shape))
            for name, shape, is_elem in recipe.inputs
        }
        got = gemm.gemm_chain(recipe, env, block_elements=be)
        want = gemm.gemm_chain_plain(recipe, env, block_elements=be)
        torch.cuda.synchronize()
        err = max(compare(got[k], want[k], F32_RTOL, F32_ATOL_FRAC,
                          f"gemm_chain {stage} {k}") for k in got)
        elem_names = [n for n, _, is_elem in recipe.inputs if is_elem]

        def half(a, b, k, env=env, recipe=recipe, elem_names=elem_names):
            sub = {n: (v[a:b] if n in elem_names else v) for n, v in env.items()}
            return gemm.gemm_chain(recipe, sub, block_elements=k)

        be2, lo, hi = split_calls(half, E, be)
        parts = (lo(), hi())
        for k in got:
            if not torch.equal(got[k], torch.cat([parts[0][k], parts[1][k]])):
                fail(f"gemm_chain {stage}: output {k} at E={E} (BE={be}) "
                     f"differs bitwise from two E/2 calls (BE={be2})")
        ms = time_ms(lambda: gemm.gemm_chain(recipe, env, block_elements=be), 20)
        env_b = {k: v.bfloat16() for k, v in env.items()}
        got_b = gemm.gemm_chain(recipe, env_b, block_elements=be)
        want_b = gemm.gemm_chain_plain(recipe, env_b, block_elements=be)
        err_b = max(compare(got_b[k], want_b[k], BF16_RTOL, BF16_ATOL_FRAC,
                            f"gemm_chain {stage} {k} bf16") for k in got_b)
        ms_bf16 = time_ms(
            lambda: gemm.gemm_chain(recipe, env_b, block_elements=be), 20)
        del got_b, want_b
        plain_ms = time_ms(
            lambda: gemm.gemm_chain_plain(recipe, env, block_elements=be), 3)
        b_ms, b_by = bound(nbytes(*env.values(), *got.values()),
                           E * progs[stage].total_flops())
        library_ms = None
        if stage == "interp":
            # one PyTorch call computes w_ijk = sum A_il A_jm A_kn u_lmn;
            # with the element tensor first, einsum's left-to-right path is
            # three mode contractions (without opt_einsum it never reorders)
            (mat,) = [n for n, _, is_elem in recipe.inputs if not is_elem]
            A, x = env[mat], env[elem_names[0]]
            library_ms, lib_txt = einsum_ms(INTERP_EINSUM, (x, A, A, A),
                                            want[recipe.outputs[0][0]], stage)
        rows["gemm_chain"].append(dict(
            stage=stage, block_elements=be, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            max_abs_err=err, max_abs_err_bf16=err_b, ms_bf16=ms_bf16))
        lib_txt = f"  {lib_txt}" if library_ms else ""
        print(f"gemm_chain {stage} E={E} BE={be}: f32 max|err| {err:.3e}, "
              f"bf16 {err_b:.3e}, split bitwise ok | kernel {ms:.3f} ms "
              f"(bf16 {ms_bf16:.3f} ms)  plain {plain_ms:.3f} "
              f"ms{lib_txt}  bound {b_ms:.3f} ms ({b_by})")
        del env, env_b, got, want, parts
    rows["probes"] = probe_gemm_chain(
        patterns.match_gemm_chain(progs["interp"]), E, blocks["interp"],
        uniform)
    torch.cuda.empty_cache()
    return rows


def probe_gemm_chain(interp, E, be, uniform) -> dict:
    """What bounds the GEMM-chain kernel: at interpolation's bytes (u in,
    one cube out, f32), the kernel with no contraction (a scale), with
    interpolation's three and with six (interpolation twice).  Time that
    grows with the contractions is the compute side's; what stays is the
    memory pipeline's."""
    from repro_torch.kernels.gemm import gemm

    p = interp.p
    cube = (p, p, p)
    copy = gemm.GemmRecipe(p=p, inputs=(("u", cube, True),),
                           ops=(("ewise", "scale", 0, -1, 1.0),),
                           outputs=(("y", 1),))
    six = gemm.GemmRecipe(
        p=p, inputs=interp.inputs,
        ops=interp.ops + tuple(
            (op[0], op[1] + 3) + tuple(op[2:]) for op in interp.ops),
        outputs=((interp.outputs[0][0], interp.outputs[0][1] + 3),))
    env = {name: (uniform(E, *shape) if is_elem else uniform(*shape))
           for name, shape, is_elem in interp.inputs}
    out = {}
    for name, recipe in (("0 contractions", copy), ("3 contractions", interp),
                         ("6 contractions", six)):
        out[name] = time_ms(
            lambda: gemm.gemm_chain(recipe, env, block_elements=be), 20)
    print("probe gemm_chain at interp's bytes (f32): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def phase_slice(system):
    """The main path: the whole pipeline over N_BATCHES batches."""
    import numpy as np
    import torch

    from repro_torch.cfd import operators, reference, simulation
    from repro_torch.memory import pipeline as mempipe

    if system.backends != ("pallas",) * 3:
        fail(f"effective backends {system.backends}, want pallas x3")
    E = system.plan.batch_elements
    n_eq = N_BATCHES * E
    p = system.program.inputs["u"].shape[0]

    zero_counts()
    res = system.run(n_eq=n_eq)
    torch.cuda.synchronize()
    launches = read_counts()
    n = res.batches
    if n != N_BATCHES or launches != {"gemm_chain": 2 * n, "helmholtz": n,
                                      "flash_attention": 0}:
        fail(f"main path ran {n} batches with launches {launches}; want "
             f"{N_BATCHES} batches, 2n gemm_chain and n helmholtz")
    if not res.pipelined_stages:
        fail("the plan's pipeline mode did not run stage-pipelined")
    eps = res.elements / res.wall_s
    gflops = res.elements * operators.flops_per_element(p) / res.wall_s / 1e9
    print(f"slice: {n} batches x {E} elements in {res.wall_s:.3f} s "
          f"(stage-pipelined): {eps:.0f} elements/s, {gflops:.1f} GFLOPS "
          f"(Eq. 2) | launches {launches}")
    for q, v in sorted(res.checksums.items()):
        if not np.isfinite(v):
            fail(f"checksum {q} is not finite")
        print(f"  checksum {q} = {v!r}")

    serial = system.run(n_eq=n_eq, pipeline_stages=False)
    if serial.checksums != res.checksums:
        fail(f"serial checksums {serial.checksums} != pipelined "
             f"{res.checksums}")
    print(f"serial schedule: {serial.wall_s:.3f} s, checksums bitwise equal")

    one = system.run(n_eq=E, max_batches=1, collect_outputs=True)
    chain = system.chain
    shared = {k: v.astype(np.float64)
              for k, v in simulation._shared_host(chain, 0, None).items()}
    # where a batch's wall time goes: host synthesis of its inputs, then
    # pinning and copying them to the card (the kernels' share is phase 2's)
    t = time.perf_counter()
    b0 = next(simulation._chain_batch_inputs(chain, E, 1, 0, None))
    synth_s = time.perf_counter() - t
    stager = mempipe.HostStager(torch.device("cuda", 0), slots=1)
    stager(b0).arrays()  # the first call also allocates the pinned slot
    torch.cuda.synchronize()
    t = time.perf_counter()
    stager(b0).arrays()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    print(f"one batch: {res.wall_s / n:.3f} s wall, host synthesis "
          f"{synth_s:.3f} s, pin + copy to the card {stage_s:.3f} s "
          f"({sum(v.nbytes for v in b0.values()) / 2**20:.1f} MiB)")
    m = CHECK_ELEMENTS
    u = b0["interp.u"][:m].astype(np.float64)
    D = b0["helmholtz.D"][:m].astype(np.float64)
    w = reference.interpolation_batch(shared["A"], u)
    gx = np.einsum("al,elyz->eayz", shared["Dx"], w)
    want = {
        "grad.gy": np.einsum("am,exmz->eaxz", shared["Dy"], w),
        "grad.gz": np.einsum("an,exyn->eaxy", shared["Dz"], w),
        "helmholtz.v": reference.inverse_helmholtz_batch(shared["S"], D, gx),
    }
    for q, ref in want.items():
        got = torch.from_numpy(one.outputs[q][:m])
        if got.shape != ref.shape:
            fail(f"{q}: shape {tuple(got.shape)} != {ref.shape}")
        err = compare(got.double(), torch.from_numpy(ref), F32_RTOL,
                      F32_ATOL_FRAC, f"slice {q} vs float64 oracle")
        print(f"  {q}[:{m}] vs float64 oracle: max|err| {err:.3e}")
    return res, launches


def phase_fig2():
    """The paper's Fig. 2 path: the single-operator simulation driver on
    the Helmholtz kernel, with the launch counters read around it."""
    import numpy as np
    import torch

    from repro_torch.cfd import operators, reference, simulation
    from repro_torch.kernels.helmholtz import helmholtz
    from repro_torch.memory import pipeline as mempipe

    p, seed = 11, 0
    dev = torch.device("cuda", 0)
    cfg = simulation.SimConfig(p=p, backend="pallas", seed=seed)
    plan = simulation.plan_config(cfg)
    E, be = plan.batch_elements, plan.block_elements
    if plan.target.name != "h100-sxm" or (E, be) != (FIG2_E, 3):
        fail(f"Fig. 2 plan: {plan.target.name} E={E} BE={be}; want h100-sxm "
             "E=67226 BE=3 (the Helmholtz kernel's tile)")
    zero_counts()
    res = simulation.run_simulation(cfg, plan=plan, max_batches=FIG2_BATCHES)
    torch.cuda.synchronize()
    launches = read_counts()
    if res.batches != FIG2_BATCHES or launches != {
            "helmholtz": FIG2_BATCHES, "gemm_chain": 0, "flash_attention": 0}:
        fail(f"Fig. 2 path ran {res.batches} batches with launches "
             f"{launches}; want {FIG2_BATCHES} helmholtz launches only")
    if not np.isfinite(res.checksum):
        fail(f"Fig. 2 checksum {res.checksum} is not finite")
    eps = res.elements / res.wall_s
    gflops = simulation.achieved_gflops(res, p)
    print(f"fig2: {res.batches} batches x {E} elements (BE={be}, K="
          f"{plan.prefetch_depth}) in {res.wall_s:.3f} s: {eps:.0f} "
          f"elements/s, {gflops:.1f} GFLOPS (Eq. 2) | launches {launches} | "
          f"checksum {res.checksum!r}")
    serial_cfg = simulation.SimConfig(p=p, backend="pallas", seed=seed,
                                      prefetch_depth=0)
    serial = simulation.run_simulation(
        serial_cfg, plan=simulation.plan_config(serial_cfg),
        max_batches=FIG2_BATCHES)
    if serial.checksum != res.checksum:
        fail(f"Fig. 2: K=0 checksum {serial.checksum!r} != K=1 "
             f"{res.checksum!r}")
    print(f"  K=0: {serial.wall_s:.3f} s, checksum bitwise equal")
    others = {}
    for backend in ("xla", "staged"):
        other = simulation.run_simulation(
            simulation.SimConfig(p=p, backend=backend, seed=seed,
                                 batch_elements=E),
            max_batches=FIG2_BATCHES)
        rel = abs(other.checksum - res.checksum) / abs(res.checksum)
        if other.elements != res.elements or rel > FIG2_CHECKSUM_RTOL:
            fail(f"Fig. 2 {backend}: checksum {other.checksum!r} over "
                 f"{other.elements} elements vs the kernel's {res.checksum!r}"
                 f" (rel {rel:.2e} > {FIG2_CHECKSUM_RTOL})")
        others[backend] = dict(wall_s=other.wall_s, checksum=other.checksum,
                               rel=rel)
        print(f"  {backend}: {other.wall_s:.3f} s, checksum {other.checksum!r}"
              f" (rel {rel:.2e})")

    # batch 0 through the compiled operator, against the float64 oracle
    t = time.perf_counter()
    b0 = next(simulation._batch_generator(p, E, 1, seed))
    synth_s = time.perf_counter() - t
    S = np.random.default_rng(seed + 2 ** 31).uniform(-1, 1, (p, p)).astype(
        np.float32)
    stager = mempipe.HostStager(dev, slots=1)
    stager(b0).arrays()  # the first call also allocates the pinned slot
    torch.cuda.synchronize()
    t = time.perf_counter()
    staged = stager(b0).arrays()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    compiled = operators.build_inverse_helmholtz(p, backend="pallas", plan=plan)
    v = compiled.batched_fn({"S": S, **b0})["v"]
    m = CHECK_ELEMENTS
    oracle = reference.inverse_helmholtz_batch(
        S.astype(np.float64), b0["D"][:m].astype(np.float64),
        b0["u"][:m].astype(np.float64))
    err = compare(v[:m].cpu().double(), torch.from_numpy(oracle), F32_RTOL,
                  F32_ATOL_FRAC, "fig2 v vs float64 oracle")
    print(f"  one batch: {res.wall_s / res.batches:.3f} s wall, host "
          f"synthesis {synth_s:.3f} s, pin + copy to the card {stage_s:.3f} s"
          f" ({sum(x.nbytes for x in b0.values()) / 2**20:.1f} MiB) | v[:{m}]"
          f" vs float64 oracle: max|err| {err:.3e}")

    # the kernel at this path's shape, beside its plain version and einsum
    S_d = torch.from_numpy(S).to(dev)
    D_d, u_d = staged["D"], staged["u"]
    got = helmholtz.inverse_helmholtz(S_d, D_d, u_d, block_elements=be)
    want = helmholtz.inverse_helmholtz_plain(S_d, D_d, u_d, block_elements=be)
    kerr = compare(got, want, F32_RTOL, F32_ATOL_FRAC, "helmholtz fig2 f32")
    if not torch.equal(got, v):
        fail("fig2: the kernel called directly differs from batched_fn's v")
    ms = time_ms(lambda: helmholtz.inverse_helmholtz(S_d, D_d, u_d,
                                                     block_elements=be), 20)
    plain_ms = time_ms(lambda: helmholtz.inverse_helmholtz_plain(
        S_d, D_d, u_d, block_elements=be), 3)
    library_ms, lib_txt = einsum_ms(HELMHOLTZ_EINSUM,
                                    (u_d, S_d, S_d, S_d, D_d, S_d, S_d, S_d),
                                    want, "helmholtz fig2")
    b_ms, b_by = bound(nbytes(S_d, D_d, u_d, got),
                       E * compiled.program.total_flops())
    print(f"helmholtz  E={E} BE={be} (fig2): f32 max|err| {kerr:.3e} | kernel "
          f"{ms:.3f} ms  plain {plain_ms:.3f} ms  {lib_txt}  bound "
          f"{b_ms:.3f} ms ({b_by})")
    row = dict(stage="fig2", block_elements=be, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
               max_abs_err=kerr)
    stats = dict(E=E, block_elements=be, batches=res.batches,
                 wall_s=res.wall_s, wall_per_batch_s=res.wall_s / res.batches,
                 synth_s=synth_s, stage_s=stage_s, elements_per_s=eps,
                 gflops_eq2=gflops, checksum=res.checksum,
                 serial_wall_s=serial.wall_s, oracle_max_abs_err=err,
                 backends=others)
    inputs = dict(S=S, D=b0["D"], u=b0["u"], oracle=oracle)
    del got, want, staged, D_d, u_d, v
    torch.cuda.empty_cache()
    return row, stats, launches, inputs


def phase_fixed(inputs):
    """The paper's fixed-point formats on the card: batch 0 of the Fig. 2
    stream, encoded on the host, through ``api.compile_cfdlang``."""
    import numpy as np
    import torch

    from repro_torch.core import api, dsl
    from repro_torch.core.precision import FIXED32, FIXED64
    from repro_torch.memory import channels, dse

    p = 11
    src = dsl.INVERSE_HELMHOLTZ_SRC.format(p=p)
    oracle = inputs["oracle"]
    m, c = oracle.shape[0], FIXED_CPU_ELEMENTS
    out = {}
    for pol in (FIXED64, FIXED32):
        E = dse.make_plan(p, target=channels.H100_SXM,
                          policy=pol.name).batch_elements
        t = time.perf_counter()
        enc = {"S": pol.encode(inputs["S"]),
               "D": pol.encode(inputs["D"][:E]),
               "u": pol.encode(inputs["u"][:E])}
        encode_s = time.perf_counter() - t
        dev_in = {k: v.cuda() for k, v in enc.items()}
        results = {}
        for backend in ("xla", "staged"):
            fn = api.compile_cfdlang(src, element_vars=("u", "D", "v"),
                                     policy=pol, backend=backend)
            fn.batched_fn(dev_in)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            v = fn.batched_fn(dev_in)["v"]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - base
            if v.dtype != pol.storage_dtype or tuple(v.shape) != (E, p, p, p):
                fail(f"{pol.name} {backend}: v {v.dtype} {tuple(v.shape)}")
            cpu = api.compile_cfdlang(src, element_vars=("u", "D", "v"),
                                      policy=pol, backend=backend,
                                      device="cpu")
            want = cpu.batched_fn({k: (x if k == "S" else x[:c])
                                   for k, x in enc.items()})["v"]
            if not torch.equal(v[:c].cpu(), want):
                fail(f"{pol.name} {backend}: the card's first {c} elements "
                     "differ bitwise from the CPU's")
            results[backend] = v
            out[f"{pol.name} {backend}"] = dict(
                E=E, s=secs, elements_per_s=E / secs, peak_bytes=peak,
                encode_s=encode_s)
            print(f"{pol.name} {backend}: E={E} one batch {secs:.3f} s, "
                  f"{E / secs:.0f} elements/s, peak device memory "
                  f"{peak / 2**30:.2f} GiB above the inputs (widening whole "
                  f"operands: {WHOLE_WIDEN_PEAK_GIB[pol.name]:.2f}; keeping "
                  f"every intermediate: {KEEP_ALL_PEAK_GIB[pol.name]:.2f}; "
                  f"encode on the host {encode_s:.3f} s); first {c} elements "
                  "bitwise equal to the CPU")
        if not torch.equal(results["xla"], results["staged"]):
            fail(f"{pol.name}: xla and staged differ bitwise")
        got = pol.decode(results["xla"][:m].cpu()).numpy()
        mse = float(np.mean((got - oracle) ** 2))
        limit = PAPER_MSE[pol.name] * MSE_SLACK
        if not (0 < mse < limit):
            fail(f"{pol.name}: MSE {mse:.3e} vs the float64 oracle, want "
                 f"(0, {limit:.3e})")
        # one product's rounding, in units of the last place: fmul of
        # 2**20 pairs in [-1, 1] against the float64 product of the same
        # decoded values (exact to 2**-53 relative)
        gen = torch.Generator(device="cuda").manual_seed(3)
        a, b = (pol.encode(torch.rand(1 << 20, generator=gen, device="cuda",
                                      dtype=torch.float64) * 2 - 1)
                for _ in range(2))
        ulp = (pol.decode(pol.fmul(a, b)) - pol.decode(a) * pol.decode(b)) * (
            pol.scale)
        rounding = dict(mean_ulp=ulp.mean().item(), min_ulp=ulp.min().item(),
                        max_ulp=ulp.max().item())
        out[pol.name] = dict(mse=mse, paper_mse=PAPER_MSE[pol.name],
                             product_rounding=rounding)
        print(f"{pol.name}: xla == staged bitwise; MSE over {m} elements "
              f"{mse:.3e} (paper {PAPER_MSE[pol.name]:.2e}, limit "
              f"{limit:.2e}); one product's error {rounding['mean_ulp']:+.4f}"
              f" ulp on average, in [{rounding['min_ulp']:+.4f}, "
              f"{rounding['max_ulp']:+.4f}]")
        del results, dev_in, v
        torch.cuda.empty_cache()
    return out


def phase_dse():
    """The single-operator design-space sweep, the top three measured on
    the card and the cost correction fitted."""
    from repro_torch.memory import channels, dse

    space = dse.DesignSpace(backends=("xla", "staged", "pallas"),
                            policies=("float32",), cu_counts=(1,))
    t = time.perf_counter()
    cands = dse.explore(11, target=channels.H100_SXM, n_eq=2_000_000,
                        space=space, measure_top=3, measure_batches=2,
                        calibrate=True)
    secs = time.perf_counter() - t
    measured = [c for c in cands if c.verified]
    if len(measured) != 3 or not all(c.measured_s_per_element > 0
                                     for c in measured):
        fail(f"DSE: {len(measured)} candidates measured, want the top three")
    corr = dse.fit_correction(cands)
    print(f"dse: {len(cands)} candidates in {secs:.1f} s")
    print(dse.format_ranking(cands, 8))
    print(f"  correction {corr}")
    return dict(seconds=secs, n_candidates=len(cands),
                correction=dataclasses.asdict(corr),
                measured=[dict(backend=c.plan.backend, E=c.plan.batch_elements,
                               K=c.plan.prefetch_depth,
                               predicted_s_per_element=c.predicted_s_per_element,
                               measured_s_per_element=c.measured_s_per_element)
                          for c in measured])


def _stage_env(prog, E, gen):
    """Uniform inputs in [-1, 1) on the card for one stage program."""
    import torch

    elem = set(prog.element_vars)
    return {name: torch.rand(((E,) + tuple(node.shape)) if name in elem
                             else tuple(node.shape), generator=gen,
                             device="cuda") * 2 - 1
            for name, node in prog.inputs.items()}


def _time_stage(prog, E, gen):
    """CUDA-event ms of the kernel a stage program dispatches to, alone."""
    from repro_torch.flow import patterns

    impl = patterns.pallas_impl_for(prog)
    if impl is None:
        fail(f"no kernel matches stage program with inputs {list(prog.inputs)}")
    env = _stage_env(prog, E, gen)
    return time_ms(lambda: impl(env), 20)


def _run_one_batch(chain, plan, elems):
    """One batch of ``chain`` with the element inputs ``elems`` (by bare
    name), outputs collected on the host by bare name."""
    from repro_torch.cfd import simulation

    inputs = {f"{s.name}.{n}": elems[n]
              for i, s in enumerate(chain.stages)
              for n, _ in chain.host_element_inputs(i)}
    res = simulation.run_chain(chain, plan, inputs=inputs, max_batches=1,
                               collect_outputs=True)
    if res.batches != 1 or res.elements != plan.batch_elements:
        fail(f"fused run: {res.batches} batches of {res.elements} elements")
    return {q.split(".", 1)[1]: v for q, v in res.outputs.items()}, res


def phase_fusion():
    """Phase X: stage fusion and the chain DSE at p = 11 on the h100-sxm
    plans -- every fused stage on the GEMM-chain kernel, bitwise against
    the unfused chains, timed beside the kernels it replaces and its
    bound; then ``explore_chain`` with the top three measured."""
    import numpy as np
    import torch

    from repro_torch import flow
    from repro_torch.cfd import operators
    from repro_torch.flow import patterns
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.memory import chain as mchain
    from repro_torch.memory import channels, dse

    p, n_eq, H = 11, FUSION_N_EQ, channels.H100_SXM
    gen = torch.Generator(device="cuda").manual_seed(5)
    named = operators.build_cfd_chain(p, backends="pallas", target=H)
    base = mchain.plan_chain(named, target=H, n_eq=n_eq)
    plans = {k: mchain.plan_chain(named, target=H, n_eq=n_eq, max_stages=k)
             for k in (2, 1)}
    src = operators.CFD_PIPELINE_SRC.format(p=p)
    auto = flow.compile(src, target=H, backend="pallas", n_eq=n_eq)
    auto_fused = flow.compile(src, target=H, backend="pallas", n_eq=n_eq,
                              fuse="auto")
    want_groups = {
        2: (("interp", "grad"), ("helmholtz",)),
        1: (("interp", "grad", "helmholtz"),),
        "auto": (("s0", "s1", "s2"), ("s3", "s4", "s5", "s6", "s7"),
                 ("s8", "s9", "s10", "s11", "s12")),
    }
    got_groups = {k: plans[k].fusion.groups for k in (2, 1)}
    got_groups["auto"] = auto_fused.plan.fusion.groups
    if got_groups != want_groups or base.batch_elements != 50_419:
        fail(f"fusion decisions {got_groups} (E={base.batch_elements}); "
             f"want {want_groups} at E=50419")
    fused_chains = {2: plans[2].fusion.chain, 1: plans[1].fusion.chain,
                    "auto": auto_fused.chain}
    for k, chain in fused_chains.items():
        for s in chain.stages:
            if s.backend != "pallas":
                fail(f"fused stage {s.name} ({k}) compiled to {s.backend}")
    predicted = {"named": base.cost.t_pipelined, "max_stages=2":
                 plans[2].cost.t_pipelined, "max_stages=1":
                 plans[1].cost.t_pipelined, "auto 13": auto.plan.cost.t_pipelined,
                 "auto fused": auto_fused.plan.cost.t_pipelined}
    print("fusion: planner ms/batch " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in predicted.items()) +
        f" | E {base.batch_elements}, max_stages=1 E "
        f"{plans[1].batch_elements}, auto fused E "
        f"{auto_fused.plan.batch_elements}")

    # -- one batch of each, outputs bitwise against the unfused chains ----
    E0 = base.batch_elements
    rng = np.random.default_rng(11)
    elems = {q: rng.uniform(-1, 1, (E0, p, p, p)).astype(np.float32)
             for q in ("u", "D")}
    want, _ = _run_one_batch(named, base, elems)
    # the unfused chain with its Helmholtz stage on the GEMM-chain kernel:
    # the recipe contracts the modes in the program's order (0, 2, 1),
    # the Helmholtz kernel in 0, 1, 2, so their v differ by rounding
    hh = named.stages[2]
    hh_recipe = patterns.match_gemm_chain(hh.program)
    on_chain = mchain.ProgramChain(list(named.stages[:2]) + [
        mchain.ChainStage(hh.name, dataclasses.replace(
            hh.compiled, batched_fn=gemm_ops.make_pallas_impl(hh_recipe)),
            dict(hh.bindings))])
    want_gemm, _ = _run_one_batch(on_chain, base, elems)
    auto_base = mchain.plan_chain(auto.chain, target=H, batch_elements=E0,
                                  n_eq=E0)
    zero_counts()
    got = {k: _run_one_batch(fused_chains[k], plans[k], elems)
           for k in (2, 1)}
    got["auto"] = _run_one_batch(auto_fused.chain, auto_fused.plan, elems)
    torch.cuda.synchronize()
    launches = read_counts()
    if launches != {"gemm_chain": 5, "helmholtz": 1, "flash_attention": 0}:
        fail(f"fused runs launched {launches}; want 5 gemm_chain (1 + 1 + "
             "3 fused stages) and 1 helmholtz")
    want_auto, _ = _run_one_batch(auto.chain, auto_base, elems)
    v_err = {}
    for k, (outs, _) in got.items():
        n = next(iter(outs.values())).shape[0]
        for q in ("gy", "gz", "v"):
            ref = want_auto if k == "auto" else (
                want_gemm if (k == 1 and q == "v") else want)
            if not np.isfinite(outs[q]).all():
                fail(f"fused {k}: {q} is not finite")
            if not np.array_equal(outs[q], ref[q][:n]):
                fail(f"fused {k}: {q} differs bitwise from the unfused chain")
        v_err[k] = compare(torch.from_numpy(outs["v"]),
                           torch.from_numpy(want["v"][:n]), F32_RTOL,
                           F32_ATOL_FRAC, f"fused {k} v vs the Helmholtz kernel's")
    print(f"fusion: one batch each, gy/gz/v bitwise equal to the unfused "
          f"chains (max_stages=1: v bitwise equal with the Helmholtz stage on "
          f"the GEMM-chain kernel; against the Helmholtz kernel's v max|err| "
          f"{v_err[1]:.3e}) | launches {launches}")
    del want, want_gemm, want_auto, got, elems

    # -- each fused recipe on the kernel against its plain version, timed
    #    beside the unfused stages it replaces and its bound --------------
    members = {s.name: s.program for s in named.stages}
    members.update({s.name: s.program for s in auto.chain.stages})
    rows = []
    for k in (2, 1, "auto"):
        plan = auto_fused.plan if k == "auto" else plans[k]
        E = plan.batch_elements
        for s in fused_chains[k].stages:
            if "+" not in s.name:
                continue
            recipe = patterns.match_gemm_chain(s.program)
            _, n_slots, _, _, _, _ = gemm.op_table(recipe)
            env = _stage_env(s.program, E, gen)
            got = gemm.gemm_chain(recipe, env)
            ref = gemm.gemm_chain_plain(recipe, env)
            torch.cuda.synchronize()
            err = max(compare(got[q], ref[q], F32_RTOL, F32_ATOL_FRAC,
                              f"fused {s.name} {q}") for q in got)
            ms = time_ms(lambda: gemm.gemm_chain(recipe, env), 20)
            plain_ms = time_ms(lambda: gemm.gemm_chain_plain(recipe, env), 3)
            unfused = sum(_time_stage(members[m], E, gen)
                          for m in s.name.split("+"))
            b_ms, b_by = bound(nbytes(*env.values(), *got.values()),
                               E * s.program.total_flops())
            library_ms, lib_txt = None, ""
            if s.name == "s0+s1+s2":   # interpolation: one einsum call
                (mat,) = [n for n, _, is_e in recipe.inputs if not is_e]
                (x,) = [n for n, _, is_e in recipe.inputs if is_e]
                A = env[mat]
                library_ms, lib_txt = einsum_ms(
                    INTERP_EINSUM, (env[x], A, A, A),
                    ref[recipe.outputs[0][0]], s.name)
                lib_txt = "  " + lib_txt
            elif s.name == "s8+s9+s10+s11+s12":   # one output, v
                S = env["S"]
                library_ms, lib_txt = einsum_ms(
                    HELMHOLTZ_TAIL_EINSUM, (env["t0"], S, env["D"], S, S, S),
                    ref["v"], s.name)
                lib_txt = "  " + lib_txt
            rows.append(dict(stage=s.name, plan=str(k), E=E,
                             element_slots=n_slots, ms=ms, plain_ms=plain_ms,
                             unfused_ms=unfused, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, max_abs_err=err))
            print(f"gemm_chain {s.name} E={E} ({n_slots} element slots): "
                  f"f32 max|err| {err:.3e} | kernel {ms:.3f} ms  unfused "
                  f"stages {unfused:.3f} ms  plain {plain_ms:.3f} ms"
                  f"{lib_txt}  bound {b_ms:.3f} ms ({b_by})")
            del env, got, ref
    # device time an element of each configuration's kernels (the chain's
    # batches are host-bound; this is what the planner's roofline prices)
    by_stage = {r["stage"]: r for r in rows}
    t_unfused = sum(_time_stage(members[m], E0, gen)
                    for m in ("interp", "grad", "helmholtz"))
    device_us = {
        "named": t_unfused / E0 * 1e3,
        "max_stages=2": (by_stage["interp+grad"]["ms"]
                         + _time_stage(members["helmholtz"], E0, gen))
        / E0 * 1e3,
        "max_stages=1": by_stage["interp+grad+helmholtz"]["ms"]
        / plans[1].batch_elements * 1e3,
    }
    print("fusion: kernel time an element (us) " + ", ".join(
        f"{k} {v:.5f}" for k, v in device_us.items()) +
        " | planner (us) " + ", ".join(
        f"{k} {predicted[k] / pl.batch_elements * 1e6:.5f}" for k, pl in
        (("named", base), ("max_stages=2", plans[2]),
         ("max_stages=1", plans[1]))))
    torch.cuda.empty_cache()

    # -- the chain DSE on the card -----------------------------------------
    # all 27 backend combinations, so that the compiled all-kernel chain is
    # among the candidates (the default keeps the first 16 only)
    space = dse.ChainDesignSpace(backends=("xla", "staged", "pallas"),
                                 cu_counts=(1,), max_backend_combos=27)
    t = time.perf_counter()
    cands = dse.explore_chain(named, target=H, n_eq=n_eq, space=space,
                              measure_top=3, measure_batches=2,
                              calibrate=True)
    secs = time.perf_counter() - t
    measured = [c for c in cands if c.verified]
    if len(measured) != 3 or not all(c.measured_s_per_element > 0
                                     for c in measured):
        fail(f"chain DSE: {len(measured)} candidates measured, want three")
    corr = dse.fit_correction(cands)
    print(f"chain dse: {len(cands)} candidates in {secs:.1f} s")
    print(dse.format_chain_ranking(cands, 8))
    print(f"  correction {corr}")
    dse_stats = dict(
        seconds=secs, n_candidates=len(cands),
        correction=dataclasses.asdict(corr),
        measured=[dict(backends=[sp.backend for sp in c.plan.stages],
                       E=c.plan.batch_elements,
                       K=[sp.prefetch_depth for sp in c.plan.stages],
                       predicted_s_per_element=c.predicted_s_per_element,
                       measured_s_per_element=c.measured_s_per_element)
                  for c in measured])
    stats = dict(groups={str(k): v for k, v in got_groups.items()},
                 predicted_ms_per_batch={k: v * 1e3
                                         for k, v in predicted.items()},
                 device_us_per_element=device_us, v_err_full_fusion=v_err[1],
                 launches=launches, chain_dse=dse_stats)
    return rows, stats, launches


def _tile_sweep(what, run, want, E, b_ms):
    """One CFD kernel at every tile it launches with: ``run(te, n)`` gives
    its outputs for the first ``n`` elements at tile ``te`` (None: the
    default).  Each tile's outputs are bitwise the default's, the
    default's within phase 2's tolerance of the plain version ``want``,
    and a ragged n = E - 1 bitwise the whole batch's first E - 1; times
    of each tile beside the bound."""
    import torch

    base = run(None, E)
    torch.cuda.synchronize()
    err = max(compare(base[k], want[k], F32_RTOL, F32_ATOL_FRAC,
                      f"{what} default tile vs plain") for k in want)
    ragged = run(None, E - 1)
    for k in base:
        if not torch.equal(ragged[k], base[k][:E - 1]):
            fail(f"{what}: E={E - 1} differs bitwise from the first "
                 f"{E - 1} elements of E={E}")
    del ragged
    ms = {}
    for te in range(1, 1 + run.max_te):
        got = run(te, E)
        for k in base:
            if not torch.equal(got[k], base[k]):
                fail(f"{what}: te={te} differs bitwise from the default tile")
        del got
        ms[te] = time_ms(lambda: run(te, E), 20)
    print(f"blocks {what} E={E}: te " + ", ".join(
        f"{te} {t:.3f} ms" for te, t in ms.items()) +
        f" (default {run.default_te}) | bitwise equal, ragged E={E - 1} "
        f"bitwise, f32 max|err| {err:.3e} | bound {b_ms:.3f} ms")
    return dict(E=E, default_te=run.default_te, ms=ms, bound_ms=b_ms,
                max_abs_err=err)


def phase_blocks():
    """Phase B: the CFD kernels at every tile they launch with, the block
    tuner on the card, and per-stage batch sizes with re-blocking."""
    import numpy as np
    import torch

    from repro_torch import flow
    from repro_torch.cfd import operators
    from repro_torch.flow import patterns
    from repro_torch.kernels import _cube
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.helmholtz import helmholtz
    from repro_torch.memory import chain as mchain
    from repro_torch.memory import channels, dse
    from repro_torch.memory import pipeline as mempipe

    p, E, H = 11, SLICE_E, channels.H100_SXM
    gen = torch.Generator(device="cuda").manual_seed(7)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 2 - 1

    # -- (a) every legal tile --------------------------------------------
    named = operators.build_cfd_chain(p, backends="pallas", target=H)
    progs = {s.name: s.program for s in named.stages}
    tiles = {}
    S = uniform(p, p)
    for what, n in (("helmholtz", E), ("helmholtz fig2", FIG2_E)):
        D, u = uniform(n, p, p, p), uniform(n, p, p, p)

        def run(te, k, D=D, u=u):
            return {"v": helmholtz.inverse_helmholtz(S, D[:k], u[:k],
                                                     block_elements=te)}

        run.default_te, _, _ = _cube.helmholtz_tile(p, 4)
        run.max_te = _cube.helmholtz_max_tile(p, 4)
        want = {"v": helmholtz.inverse_helmholtz_plain(S, D, u)}
        b_ms, _ = bound(nbytes(S, D, u, want["v"]),
                        n * progs["helmholtz"].total_flops())
        tiles[what] = _tile_sweep(what, run, want, n, b_ms)
        del D, u, want
    for stage in ("interp", "grad"):
        recipe = patterns.match_gemm_chain(progs[stage])
        elem = {nm for nm, _, is_elem in recipe.inputs if is_elem}
        env = {nm: (uniform(E, *shape) if is_elem else uniform(*shape))
               for nm, shape, is_elem in recipe.inputs}

        def run(te, k, env=env, recipe=recipe, elem=elem):
            return gemm.gemm_chain(
                recipe, {nm: (v[:k] if nm in elem else v)
                         for nm, v in env.items()}, block_elements=te)

        run.default_te = gemm.kernel_tile(recipe, 4)[0]
        run.max_te = gemm.kernel_max_tile(recipe, 4)
        want = gemm.gemm_chain_plain(recipe, env)
        b_ms, _ = bound(nbytes(*env.values(), *want.values()),
                        E * progs[stage].total_flops())
        tiles[stage] = _tile_sweep(stage, run, want, E, b_ms)
        del env, want
    torch.cuda.empty_cache()

    # -- (b) the block tuner on the card ---------------------------------
    t = time.perf_counter()
    tuned = flow.compile(operators.CFD_PIPELINE_SRC.format(p=p),
                         stages=operators.CFD_PIPELINE_STAGES, target=H,
                         backend="pallas", n_eq=FUSION_N_EQ,
                         tune_blocks=True)
    tune_s = time.perf_counter() - t
    tuning = {}
    for sp in tuned.plan.stages:
        tu = tuned.tuning.get(sp.name)
        if tu is None or [be for be, _, _ in tu.candidates] != [1, 2, 3]:
            fail(f"tune_blocks: stage {sp.name} candidates "
                 f"{tu and tu.candidates}; want the tiles 1, 2, 3")
        if sp.block_elements != tu.block_elements:
            fail(f"tune_blocks: plan block {sp.block_elements} for "
                 f"{sp.name}, winner {tu.block_elements}")
        tuning[sp.name] = dict(E=tu.batch_elements,
                               winner=tu.block_elements,
                               ms={be: s * 1e3 for be, _, s in tu.candidates},
                               klass={be: k for be, k, _ in tu.candidates})
        print(f"tune_blocks {sp.name} E={tu.batch_elements}: " + ", ".join(
            f"te {be} ({k}) {s * 1e3:.3f} ms" for be, k, s in tu.candidates)
            + f" -> {tu.block_elements}")
    print(f"tune_blocks: compile with tuning {tune_s:.1f} s")

    # -- (c) per-stage batch sizes, re-blocked on the card ---------------
    rng = np.random.default_rng(13)
    elems = {q: rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
             for q in ("u", "D")}
    base = mchain.plan_chain(named, target=H, batch_elements=E, n_eq=E,
                             prefetch_depth=0)
    want, _ = _run_one_batch_serial(named, base, elems)
    envs = {s.name: _stage_env(s.program, E, gen) for s in named.stages}
    impls = {s.name: patterns.pallas_impl_for(s.program)
             for s in named.stages}
    uniform_ms = {n: time_ms(lambda n=n: impls[n](envs[n]), 20)
                  for n in impls}
    launches = {"gemm_chain": 0, "helmholtz": 0, "flash_attention": 0}
    reblock = {}
    for es in ((E, E // 2, E // 4), (E // 4, E, E // 2)):
        plan = mchain.plan_chain(named, target=H, batch_elements=E, n_eq=E,
                                 stage_batch_elements=es)
        if plan.stage_batch_elements != es:
            fail(f"per-stage E {es} planned as {plan.stage_batch_elements}")
        zero_counts()
        got, _ = _run_one_batch(named, plan, elems)
        torch.cuda.synchronize()
        counts = read_counts()
        expect = {"gemm_chain": E // es[0] + E // es[1],
                  "helmholtz": E // es[2], "flash_attention": 0}
        if counts != expect:
            fail(f"per-stage E {es}: launches {counts}, want {expect}")
        for name in launches:
            launches[name] += counts[name]
        for q in want:
            if not np.array_equal(got[q], want[q]):
                fail(f"per-stage E {es}: {q} differs bitwise from the "
                     "uniform serial run")
        # a re-blocked kernel stage writes into slices of the batch's
        # outputs (out=, as run_chain does); torch.cat timed beside it
        stage_ms, cat_ms = {}, {}
        for s, e_s in zip(named.stages, es):
            keys = tuple(s.program.element_vars)
            shapes = {n: tuple(v.shape) for n, v in s.program.outputs.items()}
            fn = mempipe.reblock_batched_fn(impls[s.name], keys, e_s,
                                            outputs=shapes)
            cat = mempipe.reblock_batched_fn(impls[s.name], keys, e_s)
            one = impls[s.name](envs[s.name])
            for q, v in fn(envs[s.name]).items():
                if not torch.equal(v, one[q]):
                    fail(f"re-blocked {s.name} at E_s {e_s}: {q} differs "
                         "bitwise from the whole batch")
            del one
            stage_ms[s.name] = time_ms(lambda: fn(envs[s.name]), 20)
            cat_ms[s.name] = time_ms(lambda: cat(envs[s.name]), 20)
        reblock[str(es)] = dict(stage_ms=stage_ms, cat_ms=cat_ms,
                                launches=counts,
                                predicted_s_per_element=(
                                    plan.cost.t_pipelined / E),
                                t_reblock_ms=[r * 1e3 for r in
                                              plan.cost.t_reblock])
        print(f"per-stage E {es}: bitwise equal to the uniform serial run |"
              " kernel ms " + ", ".join(
                  f"{n} {stage_ms[n]:.3f} (uniform {uniform_ms[n]:.3f}, "
                  f"torch.cat {cat_ms[n]:.3f})"
                  for n in stage_ms) + f" | launches {counts} | planner "
              f"re-block ms {reblock[str(es)]['t_reblock_ms']}")
    # the chain DSE's verification of such a plan: two batches of host
    # synthesis through run_chain (one warm-up)
    secs = dse.measure_chain_plan(named, plan, max_batches=1)
    if not (isinstance(secs, float) and secs > 0):
        fail(f"measure_chain_plan on per-stage E {es} gave {secs!r}")
    reblock[str(es)]["measured_s_per_element"] = secs
    print(f"measure_chain_plan at per-stage E {es}: {secs * 1e6:.3f} "
          f"us/element (predicted {plan.cost.t_pipelined / E * 1e6:.3f})")
    del envs, want

    # -- (e) a plan for a reference datasheet runs on the card -----------
    # alveo-u280's blocks are VMEM blocks (512 here), no CUDA tile: the
    # plan keeps them and the kernels launch at their default tile
    kw = dict(stages=operators.CFD_PIPELINE_STAGES, backend="pallas",
              batch_elements=REF_TARGET_E, n_eq=REF_TARGET_E)
    src = operators.CFD_PIPELINE_SRC.format(p=p)
    alveo = flow.compile(src, target=channels.ALVEO_U280, **kw)
    h100 = flow.compile(src, target=H, **kw)
    ref_blocks = [sp.block_elements for sp in alveo.plan.stages]
    if min(ref_blocks) <= 3:
        fail(f"alveo-u280 plan blocks {ref_blocks}: want VMEM blocks")
    small = {q: v[:REF_TARGET_E] for q, v in elems.items()}
    got, _ = _run_one_batch(alveo.chain, alveo.plan, small)
    want, _ = _run_one_batch(h100.chain, h100.plan, small)
    for q in want:
        if not np.array_equal(got[q], want[q]):
            fail(f"alveo-u280 plan on the card: {q} differs bitwise from "
                 "the h100-sxm plan's")
    print(f"alveo-u280 plan (blocks {ref_blocks}) on the card at E "
          f"{REF_TARGET_E}: bitwise the h100-sxm plan's outputs")
    del elems, small, got, want
    torch.cuda.empty_cache()
    stats = dict(tiles=tiles, tuning=tuning, tune_s=tune_s,
                 uniform_stage_ms=uniform_ms, per_stage_e=reblock,
                 reference_target_blocks=ref_blocks)
    return stats, launches


def _run_one_batch_serial(chain, plan, elems):
    """:func:`_run_one_batch` on the serial schedule (the reference run
    that per-stage batch sizes are held against)."""
    from repro_torch.cfd import simulation

    inputs = {f"{s.name}.{n}": elems[n]
              for i, s in enumerate(chain.stages)
              for n, _ in chain.host_element_inputs(i)}
    res = simulation.run_chain(chain, plan, inputs=inputs, max_batches=1,
                               collect_outputs=True, pipeline_stages=False)
    return {q.split(".", 1)[1]: v for q, v in res.outputs.items()}, res


def visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs the attention must form: with ``causal`` and
    queries aligned to the end of the keys, row i sees
    ``clamp(Tk - Tq + i + 1, 0, Tk)`` keys (half of Tq * Tk at Tq = Tk)."""
    if not causal:
        return Tq * Tk
    return sum(min(max(Tk - Tq + i + 1, 0), Tk) for i in range(Tq))


def phase_flash():
    """The flash-attention kernel against its plain version at the model
    path's shapes; times beside SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch import configs
    from repro_torch.kernels.attention import attention, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # (name, model, batch, Tq, Tk, causal, dtype[, blocks]); the first is
    # phase 5's main path, then phase E's two scoring forwards, phase J's
    # and phase W's two (whisper's encoder at one whole-axis block, its
    # decoder at the default blocks)
    Tf = configs.get(WHISPER_ARCH).n_audio_frames
    cases = [
        ("causal bf16", MODEL_ARCH, SCORE_BATCH, SCORE_LEN, SCORE_LEN, True,
         torch.bfloat16),
        ("causal f32", MODEL_ARCH, SCORE_BATCH, SCORE_LEN, SCORE_LEN, True,
         torch.float32),
        ("causal bf16 Tq<Tk", MODEL_ARCH, SCORE_BATCH, PROMPT_LEN, SCORE_LEN,
         True, torch.bfloat16),
        ("non-causal bf16", MODEL_ARCH, SCORE_BATCH, SCORE_LEN, SCORE_LEN,
         False, torch.bfloat16),
        (f"{EXPERT_ARCH} causal bf16", EXPERT_ARCH, SCORE_BATCH, SCORE_LEN,
         SCORE_LEN, True, torch.bfloat16),
        (f"{DBRX_ARCH} causal bf16", DBRX_ARCH, DBRX_BATCH, SCORE_LEN,
         SCORE_LEN, True, torch.bfloat16),
        ("jamba causal bf16", JAMBA_ARCH, JAMBA_BATCH, SCORE_LEN, SCORE_LEN,
         True, torch.bfloat16),
        ("whisper encoder bf16", WHISPER_ARCH, WHISPER_BATCH, Tf, Tf, False,
         torch.bfloat16, (Tf, Tf)),
        ("whisper decoder bf16", WHISPER_ARCH, WHISPER_BATCH, WHISPER_TOKENS,
         WHISPER_TOKENS, True, torch.bfloat16),
    ]
    rows = []
    for name, arch, B, Tq, Tk, causal, dtype, *blocks in cases:
        cfg = configs.get(arch)
        Hq, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = torch.randn(B * Hq, Tq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(B * Hkv, Tk, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(B * Hkv, Tk, d, generator=gen, device=dev).to(dtype)
        kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal)
        if blocks:
            kw.update(block_q=blocks[0][0], block_k=blocks[0][1])
        kernel = ref.route(dtype, d)
        counts = dict(attention.flash_attention.launches_by_route)
        got = attention.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        after = attention.flash_attention.launches_by_route
        if after[kernel] != counts[kernel] + 1 or sum(after.values()) != (
                sum(counts.values()) + 1):
            fail(f"flash {name}: launches by route {counts} -> {after}; "
                 f"want one {kernel} launch")
        want, p_bound = ref.flash_attention_plain(q, k, v, return_p_bound=True,
                                                  **kw)
        if dtype == torch.float32:
            err = compare(got, want, F32_RTOL, F32_ATOL_FRAC, f"flash {name}")
        else:
            err = compare(got, want, FLASH_BF16_RTOL, FLASH_BF16_ATOL_FRAC,
                          f"flash {name}", extra=p_bound)
        size = want.float().abs()
        max_plain, median_plain = size.max().item(), size.median().item()
        max_p_bound = p_bound.max().item()
        del size, p_bound
        h = B // 2  # G heads against two calls of G/2 (split by batch)
        parts = [attention.flash_attention(q[a * Hq:(a + h) * Hq],
                                           k[a * Hkv:(a + h) * Hkv],
                                           v[a * Hkv:(a + h) * Hkv], **kw)
                 for a in (0, h)]
        if not torch.equal(got, torch.cat(parts)):
            fail(f"flash {name}: G={B * Hq} heads differ bitwise from two "
                 f"calls of {h * Hq}")
        ms = time_ms(lambda: attention.flash_attention(q, k, v, **kw), 5)
        plain_ms = time_ms(lambda: ref.flash_attention_plain(q, k, v, **kw), 2)
        # SDPA's is_causal aligns the mask to the top left; the kernel's,
        # to the end of the keys, which causal_lower_right gives at Tq < Tk
        mask = dict(is_causal=causal) if Tq == Tk or not causal else dict(
            attn_mask=causal_lower_right(Tq, Tk))
        shape4 = lambda t, H: t.view(B, H, t.shape[1], d)
        sdpa = lambda: F.scaled_dot_product_attention(
            shape4(q, Hq), shape4(k, Hkv), shape4(v, Hkv), enable_gqa=True,
            **mask)
        lib_err = (sdpa().reshape(got.shape).float() - want.float()).abs().max().item()
        if lib_err > 0.1 * max_plain:
            fail(f"flash {name}: SDPA is off the plain version by "
                 f"{lib_err:.3e}: not the same function")
        library_ms = time_ms(sdpa, 5)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        flops = 4 * B * Hq * d * visible_pairs(Tq, Tk, causal)
        b_ms, b_by = bound(nbytes(q, k, v, got), flops, peak)
        peak_name = ("bf16 tensor-core 989 TFLOP/s" if dtype == torch.bfloat16
                     else "f32 CUDA-core 67 TFLOP/s")
        rows.append(dict(case=name, route=kernel, source=FLASH_SOURCES[kernel],
                         model=arch, B=B, Hq=Hq, Hkv=Hkv,
                         G=B * Hq, Tq=Tq, Tk=Tk, d=d, causal=causal,
                         blocks=blocks[0] if blocks else (512, 512),
                         dtype=str(dtype).split(".")[-1], ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by, peak=peak_name,
                         max_abs_err=err, max_abs_plain=max_plain,
                         median_abs_plain=median_plain, max_p_bound=max_p_bound,
                         sdpa_max_abs_err=lib_err))
        print(f"flash {name} [{kernel}]: G={B * Hq} (Hq {Hq} over Hkv {Hkv}) "
              f"Tq={Tq} Tk={Tk} d={d}: "
              f"max|err| {err:.3e} (max|plain| {max_plain:.3f}, median "
              f"{median_plain:.4f}, max p bound {max_p_bound:.2e}), head "
              f"split bitwise ok | kernel {ms:.3f} "
              f"ms  plain {plain_ms:.3f} ms  sdpa {library_ms:.3f} ms "
              f"(max|sdpa - plain| {lib_err:.3e})  bound {b_ms:.3f} ms "
              f"({b_by}; {flops / 1e9:.1f} GFLOP at the {peak_name} peak)")
        del q, k, v, got, want, parts
    torch.cuda.empty_cache()
    return rows


def ptxas_by_source(build_log) -> dict:
    """:func:`ptxas_summary`'s kernel lines grouped by source file name."""
    out, src = {}, None
    for line in ptxas_summary(build_log):
        if line.startswith("=="):
            src = line[2:].strip()
            out[src] = []
        elif src is not None:
            out[src].append(line)
    return out


def phase_flash_bwd():
    """The flash backward kernels against their plain version at phase T's
    training shape (bfloat16, the wgmma route), a float32 smoke shape (the
    fma route) and whisper-tiny's decoder (bfloat16 at d = 64, wgmma); the
    LSE of both forward kernels against the plain version's, and their
    output with the LSE written bitwise the output without it; times
    beside the backward of SDPA and the bound, and each route's kernels'
    registers and spills."""
    import re

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.attention import attention, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    cfg, smoke = configs.get(TRAIN_ARCH), configs.get_smoke(TRAIN_ARCH)
    cases = [("train bf16", cfg, TRAIN_BATCH, TRAIN_LEN, torch.bfloat16),
             ("smoke f32", smoke, BWD_SMOKE_BATCH, BWD_SMOKE_LEN,
              torch.float32),
             ("whisper decoder bf16", configs.get(WHISPER_ARCH),
              WHISPER_BATCH, WHISPER_TOKENS, torch.bfloat16)]
    ptxas = ptxas_by_source(_cuda.build_log)
    rows = []
    for name, c, B, T, dtype in cases:
        Hq, Hkv, d = c.n_heads, c.n_kv_heads, c.hd
        q = torch.randn(B * Hq, T, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(B * Hkv, T, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(B * Hkv, T, d, generator=gen, device=dev).to(dtype)
        do = torch.randn(B * Hq, T, d, generator=gen, device=dev).to(dtype)
        kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=True)
        fwd_kw = dict(kw, scale=1.0 / d ** 0.5, block_q=512, block_k=512)
        kernel = ref.route(dtype, d)
        source = FLASH_BWD_SOURCES[kernel]
        regs = ptxas.get(pathlib.Path(source).name,
                         ["not reported (the library was built earlier)"])
        o_plain, _ = attention._forward_kernel(q, k, v, with_lse=False,
                                               **fwd_kw)
        o, lse = attention._forward_kernel(q, k, v, with_lse=True, **fwd_kw)
        torch.cuda.synchronize()
        if not torch.equal(o, o_plain):
            fail(f"flash bwd {name}: the forward's output with the LSE "
                 f"written differs from the output without it [{kernel}]")
        _, want_lse = ref.flash_attention_plain(q, k, v, return_lse=True,
                                                **kw)
        lse_err = compare(lse, want_lse, F32_RTOL, F32_ATOL_FRAC,
                          f"flash {name} LSE [{kernel}]")
        before = dict(attention.flash_attention_bwd.launches_by_route)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        after = attention.flash_attention_bwd.launches_by_route
        if after != dict(before, **{kernel: before[kernel] + 1}):
            fail(f"flash bwd {name}: launches by route {before} -> {after}; "
                 f"want one more on {kernel}")
        want = ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        rtol, frac = ((F32_RTOL, F32_ATOL_FRAC) if dtype == torch.float32
                      else (BWD_BF16_RTOL, BWD_BF16_ATOL_FRAC))
        errs = {g: compare(a, b, rtol, frac, f"flash bwd {name} {g}")
                for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        again = attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash bwd {name}: two calls differ bitwise")
        max_plain = {g: w.float().abs().max().item()
                     for g, w in zip(("dq", "dk", "dv"), want)}
        del again, want
        ms = time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, o, lse, do, **kw), 3)
        # each of the call's kernels (rowsum, dk/dv, dq) on the device
        kernel_ms = {}
        for e in profiled_kernels(lambda: attention.flash_attention_bwd(
                q, k, v, o, lse, do, **kw)):
            m = re.search(r"flash_bwd\w*?_kernel", e.key)
            if m:
                kernel_ms[m.group()] = e.self_device_time_total / 1e3 / e.count
        plain_ms = time_ms(lambda: ref.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), 1)
        # the library yardstick: SDPA's backward on the same inputs
        shape4 = lambda t, H: t.view(B, H, T, d).detach().requires_grad_()
        q4, k4, v4 = shape4(q, Hq), shape4(k, Hkv), shape4(v, Hkv)
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)
        do4 = do.view(B, Hq, T, d)
        sdpa = lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True)
        lib_err = max((a.reshape(b.shape).float() - b.float()).abs().max().item()
                      / max_plain[g]
                      for g, a, b in zip(("dq", "dk", "dv"), sdpa(), got))
        if lib_err > 0.1:
            fail(f"flash bwd {name}: SDPA's gradients are off the kernel's "
                 f"by {lib_err:.3e} of max|plain|: not the same function")
        library_ms = time_ms(sdpa, 5)
        del out4, q4, k4, v4
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        pairs = visible_pairs(T, T, True)
        flops = 10 * d * B * Hq * pairs
        b_ms, b_by = bound(nbytes(q, k, v, o, do, lse, *got), flops, peak)
        peak_name = ("bf16 tensor-core 989 TFLOP/s" if dtype == torch.bfloat16
                     else "f32 CUDA-core 67 TFLOP/s")
        rows.append(dict(case=name, route="cuda", bwd_route=kernel,
                         source=source, ptxas=regs, model=c.arch_id, B=B, Hq=Hq,
                         Hkv=Hkv, G=B * Hq, T=T, d=d, causal=True,
                         dtype=str(dtype).split(".")[-1], ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by, peak=peak_name,
                         kernel_ms=kernel_ms,
                         max_abs_err=max(errs.values()), errs=errs,
                         max_abs_plain=max_plain, lse_max_abs_err=lse_err,
                         sdpa_rel_err=lib_err))
        print(f"flash bwd {name} [{kernel}: {source}]: G={B * Hq} (Hq {Hq} "
              f"over Hkv {Hkv}) T={T} d={d} {rows[-1]['dtype']}: forward "
              f"[{kernel}] output with LSE bitwise without, max|LSE err| "
              f"{lse_err:.3e} | max|err| "
              + ", ".join(f"{g} {e:.3e} (max|plain| {max_plain[g]:.3f})"
                          for g, e in errs.items())
              + f", bitwise repeatable | kernel {ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms  sdpa backward {library_ms:.3f} ms (max "
              f"|sdpa - kernel| {lib_err:.2e} of max|plain|)  bound "
              f"{b_ms:.3f} ms ({b_by}; {flops / 1e9:.1f} GFLOP at the "
              f"{peak_name} peak)")
        print("  its kernels on the card: " + (", ".join(
            f"{n} {t:.3f} ms" for n, t in kernel_ms.items())
            or "the profiler saw no device time"))
        for line in regs:
            print(f"  ptxas: {line}")
        del q, k, v, do, o, o_plain, lse, want_lse, got
    torch.cuda.empty_cache()
    return rows


def phase_model():
    """The model path: a scoring forward at full size through the flash
    kernel, the same forward through plain attention, then serving."""
    import math

    import torch

    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.runtime import losses

    cfg = configs.get(MODEL_ARCH)
    dev = torch.device("cuda", 0)
    model = build_model(cfg)
    if model.device.type != "cuda":
        fail(f"build_model placed the model on {model.device}")
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"model {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab {cfg.vocab}"
          f": {n_params / 1e9:.3f} B params ({cfg.param_dtype}), init "
          f"{time.perf_counter() - t:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_LEN),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}

    model.forward(params, batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    logits = model.forward(params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    launches = read_counts()
    want = {"helmholtz": 0, "gemm_chain": 0, "flash_attention": cfg.n_layers}
    by_route = dict(_wrappers()["flash_attention"].launches_by_route)
    if launches != want or by_route != {"wgmma": cfg.n_layers, "fma": 0}:
        fail(f"scoring forward launched {launches}, flash by route "
             f"{by_route}; want {want}, all flash launches on wgmma")
    launches["flash_attention_by_route"] = by_route
    if logits.shape != (SCORE_BATCH, SCORE_LEN, cfg.vocab) or (
            logits.dtype != torch.float32):
        fail(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not torch.isfinite(logits).all():
        fail("scoring forward: non-finite logits")
    loss = losses.next_token_loss(logits, tokens).item()
    ln_v = math.log(cfg.vocab)
    if not (math.isfinite(loss) and abs(loss - ln_v) < 2.0):
        fail(f"next-token loss {loss} not near ln V = {ln_v:.3f}")
    n_tok = SCORE_BATCH * SCORE_LEN
    print(f"scoring forward ({SCORE_BATCH}, {SCORE_LEN}): {fwd_s:.3f} s, "
          f"{n_tok / fwd_s:.0f} tokens/s | launches {launches} | next-token "
          f"loss {loss:.4f} (ln V = {ln_v:.4f}) | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    fwd_profile = device_profile(lambda: model.forward(params, batch),
                                 "scoring forward")

    # the kernel's share of one forward: its launches at this shape, timed
    # alone (phase 4's main case) over the forward's wall time
    xla_model = build_model(cfg, attn_impl="xla")
    t = time.perf_counter()
    logits_x = xla_model.forward(params, batch)
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t
    print(f"attn_impl='xla' forward: {xla_s:.3f} s")
    stats = dict(forward_s=fwd_s, forward_tokens_per_s=n_tok / fwd_s,
                 xla_forward_s=xla_s, loss=loss, launches=launches,
                 forward_profile=fwd_profile,
                 vs_xla=logit_agreement(logits, logits_x,
                                        "kernel logits vs attn_impl='xla'"))
    del logits, logits_x, xla_model
    torch.cuda.empty_cache()

    # serving: prefill a prompt, decode greedily, then teacher-force
    prompt = tokens[:, :PROMPT_LEN]
    zero_counts()
    cache = model.init_cache(SCORE_BATCH, PROMPT_LEN + DECODE_STEPS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = model.prefill(params, {"tokens": prompt}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    steps, fed = [lg], []
    t = time.perf_counter()
    for i in range(DECODE_STEPS):
        tok = steps[-1].argmax(-1)
        fed.append(tok)
        lg, cache = model.decode_step(params, tok, cache, PROMPT_LEN + i)
        steps.append(lg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    serve_launches = read_counts()
    seq = torch.cat([prompt, torch.stack(fed, dim=1)], dim=1)
    # causal: padding past the sequence leaves its logits unchanged, and
    # 1024 rows satisfy the attention's block rule
    pad = torch.zeros(SCORE_BATCH, 1024 - seq.shape[1], dtype=seq.dtype,
                      device=dev)
    full = model.forward(params, {"tokens": torch.cat([seq, pad], dim=1)})
    forced = full[:, PROMPT_LEN - 1:PROMPT_LEN + DECODE_STEPS]
    served = torch.stack(steps, dim=1)
    if serve_launches["flash_attention"] != 0:
        fail(f"prefill/decode launched {serve_launches}: the cache path "
             "should not reach the flash kernel")
    print(f"serving: prefill ({SCORE_BATCH}, {PROMPT_LEN}) {prefill_s:.3f} s, "
          f"{DECODE_STEPS} decode steps {decode_s:.3f} s = "
          f"{SCORE_BATCH * DECODE_STEPS / decode_s:.1f} tokens/s | launches "
          f"{serve_launches}")
    stats.update(prefill_s=prefill_s, decode_s=decode_s,
                 decode_tokens_per_s=SCORE_BATCH * DECODE_STEPS / decode_s,
                 vs_forced=logit_agreement(
                     served, forced, "decode logits vs teacher-forced forward"))
    last = PROMPT_LEN + DECODE_STEPS - 1   # rewrites that slot's same K/V
    stats["decode_profile"] = device_profile(
        lambda: model.decode_step(params, fed[-1], cache, last),
        "one decode step")
    return stats


def moe_card_vs_cpu() -> dict:
    """``moe_apply`` on the card against the CPU: olmoe's smoke config in
    float32, the same params and tokens on both, a capacity that drops
    assignments, 1 and 4 groups, both combine modes; outputs within
    MOE_CARD_RTOL (rtol, and atol of that fraction of max|CPU|) and the
    same count of kept assignments."""
    import torch
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_smoke(EXPERT_ARCH)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    p_cpu = moe.moe_init(gen, cfg, torch.float32)
    p_dev = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p_cpu.items()}
    x = torch.randn(*MOE_CHECK_SHAPE, cfg.d_model, generator=gen)
    saved = (moe._NUM_GROUPS, moe._EP_SPEC, moe.COMBINE_MODE)
    out = {}
    try:
        for groups in (1, 4):
            moe.set_ep_sharding(None, (), num_groups=groups)
            xt = x.reshape(groups, -1, cfg.d_model)
            kept = [int(moe._route(p, xt.to(p["w_up"].device), cfg,
                                   MOE_CHECK_CAPACITY)[4].sum())
                    for p in (p_cpu, p_dev)]
            made = xt.shape[0] * xt.shape[1] * cfg.moe.top_k
            if kept[0] != kept[1] or not 0 < kept[0] < made:
                fail(f"moe_apply groups {groups}: kept assignments CPU "
                     f"{kept[0]}, card {kept[1]} of {made}")
            for mode in ("gather", "scatter"):
                moe.COMBINE_MODE = mode
                want = moe.moe_apply(p_cpu, x, cfg, capacity=MOE_CHECK_CAPACITY)
                got = moe.moe_apply(p_dev, x.to(dev), cfg,
                                    capacity=MOE_CHECK_CAPACITY)
                err = compare(got.cpu(), want, MOE_CARD_RTOL, MOE_CARD_RTOL,
                              f"moe_apply groups {groups} {mode}")
                out[f"G={groups} {mode}"] = dict(
                    max_abs_err=err, dropped_share=1 - kept[0] / made)
    finally:
        moe._NUM_GROUPS, moe._EP_SPEC, moe.COMBINE_MODE = saved
    print(f"moe_apply on the card vs the CPU ({cfg.arch_id}, float32, "
          f"{MOE_CHECK_SHAPE} tokens, capacity {MOE_CHECK_CAPACITY}): "
          + ", ".join(f"{k} max|err| {v['max_abs_err']:.2e} (dropped "
                      f"{v['dropped_share']:.3f}, equal counts)"
                      for k, v in out.items()))
    return out


def _build_on_card(cfg, attn_impl="auto"):
    from repro_torch.models import build_model

    model = build_model(cfg, attn_impl=attn_impl)
    if model.device.type != "cuda":
        fail(f"build_model placed {cfg.arch_id} on {model.device}")
    return model


def _score_moe(cfg, batch_size: int, stats: dict):
    """A scoring forward of ``cfg`` at ``batch_size`` x SCORE_LEN random
    tokens through the flash kernel (counters zeroed just before and
    read just after: one wgmma launch a layer), its loss, the drop share
    at the default capacity, its profile, and its logits against
    ``attn_impl="xla"`` with the routing of both runs compared.  Returns
    the model, its params, the tokens and the launch counts."""
    import math

    import torch

    from repro_torch.runtime import losses

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    model = _build_on_card(cfg)
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"model {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
          f"params ({n_bytes / 1e9:.2f} GB {cfg.param_dtype}), init "
          f"{time.perf_counter() - t:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch_size, SCORE_LEN),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    model.forward(params, batch)  # warm-up
    torch.cuda.synchronize()
    E, L = cfg.moe.n_experts, cfg.n_layers
    with RoutingLog(E) as log:
        zero_counts()
        t = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t
        launches = read_counts()
    by_route = dict(_wrappers()["flash_attention"].launches_by_route)
    want = {"helmholtz": 0, "gemm_chain": 0, "flash_attention": L}
    if launches != want or by_route != {"wgmma": L, "fma": 0}:
        fail(f"{cfg.arch_id} scoring forward launched {launches}, flash by "
             f"route {by_route}; want {want}, all on wgmma")
    launches["flash_attention_by_route"] = by_route
    if logits.shape != (batch_size, SCORE_LEN, cfg.vocab) or (
            logits.dtype != torch.float32) or not torch.isfinite(logits).all():
        fail(f"{cfg.arch_id} logits {tuple(logits.shape)} {logits.dtype}, "
             "or not finite")
    loss = losses.next_token_loss(logits, tokens).item()
    ln_v = math.log(cfg.vocab)
    if not (math.isfinite(loss) and abs(loss - ln_v) < 2.0):
        fail(f"{cfg.arch_id} next-token loss {loss} not near ln V = {ln_v:.3f}")
    n_tok = batch_size * SCORE_LEN
    dropped = log.dropped_share()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{cfg.arch_id} scoring forward ({batch_size}, {SCORE_LEN}): "
          f"{fwd_s:.3f} s, {n_tok / fwd_s:.0f} tokens/s | launches {launches} "
          f"| next-token loss {loss:.4f} (ln V = {ln_v:.4f}) | dropped at the "
          f"default capacity (factor {cfg.moe.capacity_factor}) {dropped:.5f} "
          f"| peak memory {peak:.1f} GiB")
    stats.update(params=n_params, forward_s=fwd_s,
                 forward_tokens_per_s=n_tok / fwd_s, loss=loss,
                 launches=launches, dropped_share=dropped, peak_gib=peak,
                 forward_profile=device_profile(
                     lambda: model.forward(params, batch),
                     f"{cfg.arch_id} scoring forward"))
    routes = log.by_position(L, batch_size)

    xla_model = _build_on_card(cfg, attn_impl="xla")
    with RoutingLog(E) as xla_log:
        t = time.perf_counter()
        logits_x = xla_model.forward(params, batch)
        torch.cuda.synchronize()
        stats["xla_forward_s"] = time.perf_counter() - t
    print(f"  {cfg.arch_id} attn_impl='xla' forward: "
          f"{stats['xla_forward_s']:.3f} s")
    stats["vs_xla"] = logit_agreement(
        logits, logits_x, f"{cfg.arch_id} kernel logits vs attn_impl='xla'",
        rerouted=rerouted(routes, xla_log.by_position(L, batch_size)))
    del logits, logits_x, xla_model, routes
    torch.cuda.empty_cache()
    return model, params, tokens, launches


def phase_experts() -> dict:
    """Phase E: the MoE decoders.  ``moe_apply`` on the card against the
    CPU; olmoe-1b-7b whole (a scoring forward, then prefill and greedy
    decode against the teacher-forced forward); dbrx-132b at its widths
    with the depth cut (a scoring forward).  Each model is freed before
    the next is built."""
    import dataclasses
    import gc

    import torch

    from repro_torch import configs

    dev = torch.device("cuda", 0)
    stats = {"card_vs_cpu": moe_card_vs_cpu()}

    # -- olmoe-1b-7b, nothing cut -------------------------------------------
    cfg = configs.get(EXPERT_ARCH)
    olmoe = stats[EXPERT_ARCH] = {}
    model, params, tokens, launches = _score_moe(cfg, SCORE_BATCH, olmoe)
    flash = launches["flash_attention"]

    # serving: capacity depends on a call's token count, so prefill and
    # the teacher-forced forward get one slot per token (nothing drops:
    # a token's top-k experts are distinct); decode at batch 4 has the
    # default 8 slots, more than its 4 tokens can fill
    E, L, B = cfg.moe.n_experts, cfg.n_layers, SCORE_BATCH
    prompt = tokens[:, :PROMPT_LEN]
    cache = model.init_cache(B, PROMPT_LEN + DECODE_STEPS)
    with RoutingLog(E) as served_log:
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = model.prefill(params, {"tokens": prompt}, cache,
                                  moe_capacity=B * PROMPT_LEN)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        steps, fed = [lg], []
        t = time.perf_counter()
        for i in range(DECODE_STEPS):
            tok = steps[-1].argmax(-1)
            fed.append(tok)
            lg, cache = model.decode_step(params, tok, cache, PROMPT_LEN + i)
            steps.append(lg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        serve_launches = read_counts()
    if serve_launches["flash_attention"] != 0:
        fail(f"{cfg.arch_id} prefill/decode launched {serve_launches}: the "
             "cache path should not reach the flash kernel")
    if served_log.dropped_share() != 0.0:
        fail(f"{cfg.arch_id} serving dropped {served_log.dropped_share()} "
             "of its assignments")
    seq = torch.cat([prompt, torch.stack(fed, dim=1)], dim=1)
    # causal: padding past the sequence leaves its logits unchanged, and
    # 1024 rows satisfy the attention's block rule
    pad = torch.zeros(B, 1024 - seq.shape[1], dtype=seq.dtype, device=dev)
    with RoutingLog(E) as forced_log:
        full = model.forward(params, {"tokens": torch.cat([seq, pad], dim=1)},
                             moe_capacity=B * 1024)
    span = slice(PROMPT_LEN - 1, PROMPT_LEN + DECODE_STEPS)
    forced, served = full[:, span], torch.stack(steps, dim=1)
    moved = rerouted(served_log.by_position(L, B),
                     forced_log.by_position(L, B)[:, :, :seq.shape[1]])
    print(f"  serving {cfg.arch_id}: prefill ({B}, {PROMPT_LEN}) "
          f"{prefill_s:.3f} s, {DECODE_STEPS} decode steps {decode_s:.3f} s "
          f"= {B * DECODE_STEPS / decode_s:.1f} tokens/s | launches "
          f"{serve_launches} | nothing dropped")
    olmoe.update(prefill_s=prefill_s, decode_s=decode_s,
                 decode_tokens_per_s=B * DECODE_STEPS / decode_s,
                 vs_forced=logit_agreement(
                     served, forced,
                     f"{cfg.arch_id} decode logits vs teacher-forced forward",
                     rerouted=moved[:, span]))
    last = PROMPT_LEN + DECODE_STEPS - 1   # rewrites that slot's same K/V
    olmoe["decode_profile"] = device_profile(
        lambda: model.decode_step(params, fed[-1], cache, last),
        f"{cfg.arch_id} one decode step")
    del model, params, tokens, cache, full, forced, served, steps, lg
    gc.collect()
    torch.cuda.empty_cache()

    # -- dbrx-132b at published widths, depth cut ---------------------------
    full_cfg = configs.get(DBRX_ARCH)
    cfg = dataclasses.replace(full_cfg, n_layers=DBRX_LAYERS)
    print(f"{DBRX_ARCH}: depth cut to {DBRX_LAYERS} of {full_cfg.n_layers} "
          f"layers ({full_cfg.param_count() / 1e9:.1f} B params in all)")
    dbrx = stats[DBRX_ARCH] = {"layers": DBRX_LAYERS,
                               "published_layers": full_cfg.n_layers}
    model, params, tokens, launches = _score_moe(cfg, DBRX_BATCH, dbrx)
    flash += launches["flash_attention"]
    del model, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    stats["flash_launches"] = flash
    return stats


def blocks_card_vs_cpu(cfg, blocks, gen) -> dict:
    """Recurrent blocks on the card against the CPU: for each ``name:
    (init, apply, init_state)`` the same float32 params (``init(gen)``)
    and (2, XLSTM_CHECK_LEN) inputs on both, without a state and with
    the state a first (2, 64) call on the CPU left; output and new state
    within XLSTM_CARD_RTOL (rtol, and atol of that fraction of
    max|CPU|).  Returns each case's max|err|."""
    import torch

    dev = torch.device("cuda", 0)
    out = {}
    for name, (init, apply, init_state) in blocks.items():
        p_cpu = init(gen)
        p_dev = _tree_to(p_cpu, dev)
        x = torch.randn(2, XLSTM_CHECK_LEN, cfg.d_model, generator=gen)
        _, carried = apply(p_cpu, torch.randn(2, 64, cfg.d_model, generator=gen),
                           cfg, state=init_state)
        for st in (None, carried):
            what = f"{name} {'with' if st else 'without'} state"
            want, want_st = apply(p_cpu, x, cfg, state=st)
            got, got_st = apply(p_dev, x.to(dev), cfg, state=None if st is None
                                else _tree_to(st, dev))
            err = compare(got.cpu(), want, XLSTM_CARD_RTOL, XLSTM_CARD_RTOL,
                          what)
            for k in (want_st or {}):
                err = max(err, compare(got_st[k].cpu(), want_st[k],
                                       XLSTM_CARD_RTOL, XLSTM_CARD_RTOL,
                                       f"{what}: new state {k}"))
            out[what] = err
    return out


def xlstm_card_vs_cpu() -> dict:
    """``mlstm_apply``, ``mlstm_apply_chunked`` and ``slstm_apply`` on the
    card against the CPU (xlstm-125m's smoke config, ``blocks_card_vs_cpu``)."""
    import functools

    import torch
    from repro_torch import configs
    from repro_torch.models import ssm

    cfg = configs.get_smoke(XLSTM_ARCH)
    f32 = torch.float32
    m_init = lambda g: ssm.mlstm_init(g, cfg, f32)
    m_state = ssm.xlstm_init_state(cfg, 2, "mlstm")
    out = blocks_card_vs_cpu(cfg, {
        "mlstm_apply": (m_init, ssm.mlstm_apply, m_state),
        "mlstm_apply_chunked": (m_init, functools.partial(
            ssm.mlstm_apply_chunked, chunk=XLSTM_CHUNK), m_state),
        "slstm_apply": (lambda g: ssm.slstm_init(g, cfg, f32), ssm.slstm_apply,
                        ssm.xlstm_init_state(cfg, 2, "slstm")),
    }, torch.Generator().manual_seed(0))
    print(f"xLSTM blocks on the card vs the CPU ({cfg.arch_id}, float32, "
          f"(2, {XLSTM_CHECK_LEN}), chunk {XLSTM_CHUNK}; max|err| over the "
          "output and new state): "
          + ", ".join(f"{k} {v:.2e}" for k, v in out.items()))
    return out


def per_step(fn_of_len, what: str, lens=XLSTM_STEP_PROFILE, full_len=None,
             wall_s=None) -> dict:
    """What one step of a recurrent loop costs on the card: ``fn_of_len``
    profiled at the two lengths ``lens``, differenced -- kernels a step,
    their device time a step, and the rest (the launches and kernel time
    outside the loop, at the shorter length).  With ``full_len`` and
    ``wall_s`` (a call's wall time at ``full_len``, taken without the
    profiler) also that call multiplied out, in place of a profile of
    it: its launches, kernel time, busy share and wall a launch, and the
    largest kernels of the longer profile."""
    t0, t1 = lens
    fn_of_len(t0)  # warm-up

    def totals(n):
        kernels = profiled_kernels(lambda: fn_of_len(n))
        return (kernels, sum(e.count for e in kernels),
                sum(e.self_device_time_total for e in kernels) / 1e6)

    for _ in range(PROFILE_TRIES):
        (_, n0, d0), (k1, n1, d1) = totals(t0), totals(t1)
        if n0 < n1:
            break
        print(f"  {what}: the profiler saw {n0} and {n1} kernels at T = "
              f"{t0} and {t1}; profiling both again")
    else:
        fail(f"{what}: the profiler saw {n0} and {n1} kernels at T = {t0} "
             f"and {t1}, {PROFILE_TRIES} times")
    out = dict(launches_per_step=(n1 - n0) / (t1 - t0),
               device_s_per_step=(d1 - d0) / (t1 - t0))
    out["other_launches"] = n0 - t0 * out["launches_per_step"]
    out["other_device_s"] = d0 - t0 * out["device_s_per_step"]
    print(f"  {what}: {out['launches_per_step']:.1f} launches and "
          f"{out['device_s_per_step'] * 1e6:.1f} us of kernels a step "
          f"(profiles at T = {t0} and {t1}); {out['other_launches']:.0f} "
          "launches outside the loop")
    if full_len is None:
        return out
    launches = out["other_launches"] + full_len * out["launches_per_step"]
    dev_s = out["other_device_s"] + full_len * out["device_s_per_step"]
    top = sorted(k1, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    out.update(len=full_len, wall_s=wall_s, device_s=dev_s,
               busy_share=dev_s / wall_s, launches=launches,
               s_per_launch=wall_s / launches, top_at=t1,
               top=[dict(kernel=e.key[:80], s=e.self_device_time_total / 1e6,
                         calls=e.count) for e in top])
    print(f"    multiplied out to T = {full_len}: {launches:.0f} launches, "
          f"kernels {dev_s:.4f} s on the card, wall {wall_s:.4f} s, busy "
          f"share {dev_s / wall_s:.3f}, {wall_s / launches * 1e6:.1f} us of "
          f"wall a launch; the largest kernels at T = {t1}:")
    for k in out["top"]:
        print(f"      {k['s']:.4f} s  x{k['calls']}  {k['kernel']}")
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _xlstm_forward(model, params, tokens, chunk, what: str):
    """One scoring forward at ``MLSTM_CHUNK = chunk``, counters zeroed
    just before and read just after (the path reaches no kernel of the
    port), its logits checked; returns (logits, seconds, its peak device
    memory in GiB above what was allocated before it)."""
    import torch
    from repro_torch.models import ssm

    ssm.MLSTM_CHUNK = chunk
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    logits = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    launches = read_counts()
    if any(launches.values()):
        fail(f"{what} launched {launches}: the xLSTM path reaches no kernel")
    if logits.shape != (*tokens.shape, model.cfg.vocab) or (
            logits.dtype != torch.float32) or not torch.isfinite(logits).all():
        fail(f"{what}: logits {tuple(logits.shape)} {logits.dtype}, or not "
             "finite")
    return logits, secs, peak


def phase_xlstm() -> dict:
    """Phase R: the xLSTM.  Its blocks on the card against the CPU;
    xlstm-125m whole (bf16, seed 0, nothing cut) against the same code on
    the CPU on a short input; a scoring forward of (4, 4096) on the exact
    recurrent scan and on chunks of XLSTM_CHUNK, held against each other;
    then prefill of (4, 512) and greedy decode on the O(1) state against
    the teacher-forced forward.  ``MLSTM_CHUNK`` is restored at the end."""
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch.models import build_model, layers, ssm
    from repro_torch.runtime import losses

    dev = torch.device("cuda", 0)
    stats = {"card_vs_cpu": xlstm_card_vs_cpu()}
    cfg = configs.get(XLSTM_ARCH)
    model = build_model(cfg)
    if model.device.type != "cuda":
        fail(f"build_model placed {cfg.arch_id} on {model.device}")
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    kinds = [ssm.xlstm_block_kind(i, cfg) for i in range(cfg.n_layers)]
    print(f"model {cfg.arch_id}: {cfg.n_layers} layers ({kinds.count('mlstm')}"
          f" mLSTM, {kinds.count('slstm')} sLSTM), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, vocab {cfg.vocab}: "
          f"{n_params / 1e6:.3f} M params ({n_bytes / 1e6:.1f} MB "
          f"{cfg.param_dtype}), init {time.perf_counter() - t:.1f} s")
    stats.update(params=n_params)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_LEN),
                           generator=gen, device=dev)
    saved = ssm.MLSTM_CHUNK
    try:
        # the same code on the CPU, full width, a short input
        short = tokens[:2, :XLSTM_CHECK_LEN]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = _tree_to(params, "cpu")
        for chunk in (None, XLSTM_CHUNK):
            ssm.MLSTM_CHUNK = chunk
            want = cpu_model.forward(cpu_params, {"tokens": short.cpu()})
            got = model.forward(params, {"tokens": short})
            stats[f"vs_cpu_chunk_{chunk}"] = logit_agreement(
                got.cpu(), want, f"{cfg.arch_id} on the card vs the CPU, "
                f"(2, {XLSTM_CHECK_LEN}) tokens, MLSTM_CHUNK = {chunk}")
        del cpu_model, cpu_params, want, got

        # scoring: warm up both paths, then decide the recurrent length
        warm = tokens[:, :2 * XLSTM_CHUNK]
        for chunk in (None, XLSTM_CHUNK):
            _xlstm_forward(model, params, warm, chunk, "warm-up")
        _, probe_s, _ = _xlstm_forward(model, params,
                                       tokens[:, :XLSTM_PROBE_LEN], None,
                                       "probe forward")
        guess = probe_s * SCORE_LEN / XLSTM_PROBE_LEN
        rec_len = SCORE_LEN if guess <= XLSTM_RECURRENT_LIMIT_S else (
            XLSTM_SHORT_LEN)
        print(f"  recurrent forward ({SCORE_BATCH}, {XLSTM_PROBE_LEN}) "
              f"{probe_s:.3f} s: at ({SCORE_BATCH}, {SCORE_LEN}) about "
              f"{guess:.1f} s, so it runs at ({SCORE_BATCH}, {rec_len})")
        rec, rec_s, rec_peak = _xlstm_forward(
            model, params, tokens[:, :rec_len], None, "recurrent forward")
        n_rec = SCORE_BATCH * rec_len
        loss = losses.next_token_loss(rec, tokens[:, :rec_len]).item()
        if not math.isfinite(loss):
            fail(f"{cfg.arch_id} next-token loss {loss}")
        chunked, chk_s, chk_peak = _xlstm_forward(
            model, params, tokens, XLSTM_CHUNK, "chunked forward")
        n_tok = SCORE_BATCH * SCORE_LEN
        print(f"{cfg.arch_id} scoring forward, recurrent (MLSTM_CHUNK = None)"
              f" ({SCORE_BATCH}, {rec_len}): {rec_s:.3f} s, "
              f"{n_rec / rec_s:.0f} tokens/s, peak memory {rec_peak:.2f} GiB "
              "above its inputs,"
              f" next-token loss {loss:.4f} (ln V = {math.log(cfg.vocab):.4f};"
              f" the tied embedding at scale 1 gives logits of std about "
              f"sqrt(d))")
        print(f"{cfg.arch_id} scoring forward, chunked (MLSTM_CHUNK = "
              f"{XLSTM_CHUNK}) ({SCORE_BATCH}, {SCORE_LEN}): {chk_s:.3f} s, "
              f"{n_tok / chk_s:.0f} tokens/s, peak memory {chk_peak:.2f} GiB "
              "above its inputs")
        stats.update(
            recurrent=dict(len=rec_len, probe_s=probe_s, guess_s=guess,
                           forward_s=rec_s, tokens_per_s=n_rec / rec_s,
                           peak_gib=rec_peak, loss=loss),
            chunked=dict(len=SCORE_LEN, chunk=XLSTM_CHUNK, forward_s=chk_s,
                         tokens_per_s=n_tok / chk_s, peak_gib=chk_peak),
            chunked_vs_recurrent=logit_agreement(
                chunked[:, :rec_len], rec,
                f"{cfg.arch_id} chunked vs recurrent forward logits "
                f"({SCORE_BATCH}, {rec_len})"))
        del rec, chunked
        torch.cuda.empty_cache()

        # where the time goes: the chunked forward's and the recurrent
        # loops' cost a step (a chunk's worth of tokens for the chunked
        # forward), multiplied out; the layers timed alone
        ssm.MLSTM_CHUNK = XLSTM_CHUNK
        stats["chunked"]["profile"] = per_step(
            lambda n: model.forward(params, {"tokens": tokens[:, :n]}),
            f"{cfg.arch_id} chunked forward, a token", XLSTM_CHUNKED_PROFILE,
            SCORE_LEN, chk_s)
        ssm.MLSTM_CHUNK = None
        blk = params["blocks"]
        h = layers.norm_apply(blk[1]["ln"], layers.embed_apply(
            params["embed"], tokens, cfg), cfg.norm, cfg.norm_eps)
        steps = {
            "forward": per_step(lambda n: model.forward(
                params, {"tokens": tokens[:, :n]}), "recurrent forward"),
            "mlstm": per_step(lambda n: ssm.mlstm_apply(
                blk[1]["core"], h[:, :n], cfg), "one mLSTM layer"),
            "slstm": per_step(lambda n: ssm.slstm_apply(
                blk[0]["core"], h[:, :n], cfg), "one sLSTM layer"),
        }
        fw = steps["forward"]
        launches = fw["other_launches"] + rec_len * fw["launches_per_step"]
        dev_s = rec_len * fw["device_s_per_step"]
        stats["recurrent"].update(
            per_step=steps, launches=launches, device_s_steps=dev_s,
            busy_share=dev_s / rec_s, s_per_launch=rec_s / launches)
        print(f"  recurrent forward ({SCORE_BATCH}, {rec_len}), multiplied "
              f"out: {launches:.0f} launches, {dev_s:.3f} s of kernels in the"
              f" loops, busy share {dev_s / rec_s:.3f}, {rec_s / launches * 1e6:.1f}"
              " us of wall a launch")
        layer_s = {}
        for name, fn in (("slstm", lambda: ssm.slstm_apply(
                              blk[0]["core"], h, cfg)),
                         ("mlstm_chunked", lambda: ssm.mlstm_apply_chunked(
                              blk[1]["core"], h, cfg, chunk=XLSTM_CHUNK))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            layer_s[name] = time.perf_counter() - t
        s_share = (kinds.count("slstm") * layer_s["slstm"]) / (
            kinds.count("slstm") * layer_s["slstm"]
            + kinds.count("mlstm") * layer_s["mlstm_chunked"])
        stats["chunked"].update(layer_s=layer_s, slstm_share=s_share)
        print(f"  one layer alone at ({SCORE_BATCH}, {SCORE_LEN}): sLSTM "
              f"{layer_s['slstm']:.3f} s, chunked mLSTM "
              f"{layer_s['mlstm_chunked']:.3f} s: the sLSTM layers take "
              f"{s_share:.3f} of the chunked forward's layer time")
        # the forward's peak memory against the tied unembedding's alone
        x = layers.embed_apply(params["embed"], tokens, cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lg = layers.unembed_apply(params["embed"], None, x, cfg)
        torch.cuda.synchronize()
        unembed_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        stats["unembed_peak_gib"] = unembed_gib
        print(f"  the tied unembedding alone at ({SCORE_BATCH}, {SCORE_LEN}): "
              f"{unembed_gib:.2f} GiB above its input, its f32 logits "
              f"{lg.numel() * 4 / 2**30:.2f} GiB")
        del h, x, lg

        # serving on the recurrent state
        B = SCORE_BATCH
        prompt = tokens[:, :PROMPT_LEN]
        zero_counts()
        states = model.init_cache(B, PROMPT_LEN + DECODE_STEPS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, states = model.prefill(params, {"tokens": prompt}, states)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        steps, fed = [lg], []
        t = time.perf_counter()
        for i in range(DECODE_STEPS):
            tok = steps[-1].argmax(-1)
            fed.append(tok)
            lg, states = model.decode_step(params, tok, states, PROMPT_LEN + i)
            steps.append(lg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        serve_launches = read_counts()
        if any(serve_launches.values()):
            fail(f"{cfg.arch_id} prefill/decode launched {serve_launches}")
        seq = torch.cat([prompt, torch.stack(fed, dim=1)], dim=1)
        full = model.forward(params, {"tokens": seq})
        forced = full[:, PROMPT_LEN - 1:PROMPT_LEN + DECODE_STEPS]
        print(f"  serving {cfg.arch_id}: prefill ({B}, {PROMPT_LEN}) "
              f"{prefill_s:.3f} s, {DECODE_STEPS} decode steps {decode_s:.3f} s"
              f" = {B * DECODE_STEPS / decode_s:.1f} tokens/s")
        stats.update(
            prefill_s=prefill_s, decode_s=decode_s,
            decode_tokens_per_s=B * DECODE_STEPS / decode_s,
            vs_forced=logit_agreement(
                torch.stack(steps, dim=1), forced,
                f"{cfg.arch_id} decode logits vs teacher-forced forward"),
            prefill_profile=per_step(
                lambda n: model.prefill(params, {"tokens": prompt[:, :n]},
                                        model.init_cache(B, n)),
                f"{cfg.arch_id} prefill ({B}, {PROMPT_LEN}), recurrent",
                full_len=PROMPT_LEN, wall_s=prefill_s),
            decode_profile=device_profile(
                lambda: model.decode_step(params, fed[-1], states, 0),
                f"{cfg.arch_id} one decode step"))
    finally:
        ssm.MLSTM_CHUNK = saved
    del model, params, tokens, states, full, forced, steps, lg
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def jamba_card_vs_cpu() -> dict:
    """``mamba_apply`` on the card against the CPU (jamba's smoke config,
    ``blocks_card_vs_cpu``), then the smoke hybrid whole (one period:
    three Mamba mixers, attention, two MoE layers) on the same params
    and tokens: one flash launch on the card, on the fma route (d = 16),
    and logits against the CPU's by phase 5's bounds."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.attention import attention
    from repro_torch.models import build_model, ssm

    cfg = configs.get_smoke(JAMBA_ARCH)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = blocks_card_vs_cpu(cfg, {"mamba_apply": (
        lambda g: ssm.mamba_init(g, cfg, torch.float32), ssm.mamba_apply,
        ssm.mamba_init_state(cfg, 2))}, gen)
    print(f"mamba_apply on the card vs the CPU ({cfg.arch_id}, float32, "
          f"(2, {XLSTM_CHECK_LEN}); max|err| over the output and new state): "
          + ", ".join(f"{k} {v:.2e}" for k, v in out.items()))

    cpu_model, model = build_model(cfg, device="cpu"), build_model(cfg)
    params = cpu_model.init(torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (2, XLSTM_CHECK_LEN), generator=gen)
    want = cpu_model.forward(params, {"tokens": tokens})
    before = dict(attention.flash_attention.launches_by_route)
    got = model.forward(_tree_to(params, dev), {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    after = dict(attention.flash_attention.launches_by_route)
    if after != dict(before, fma=before["fma"] + 1):
        fail(f"smoke hybrid forward: flash launches by route {before} -> "
             f"{after}; want one fma launch")
    out["smoke_forward"] = logit_agreement(
        got.cpu(), want, f"{cfg.arch_id} forward on the card (one fma flash "
        f"launch) vs the CPU, (2, {XLSTM_CHECK_LEN}) tokens")
    return out


def phase_jamba() -> dict:
    """Phase J: the jamba hybrid.  Mamba and the smoke hybrid on the card
    against the CPU; jamba-1.5-large at its widths cut to one period and
    JAMBA_EXPERTS experts (bf16, seed 0): a scoring forward through the
    flash kernel against ``attn_impl="xla"``, where its time goes, then
    prefill and greedy decode against the teacher-forced forward.  The
    earlier phases' models are freed first."""
    import dataclasses
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch.models import layers, moe, ssm
    from repro_torch.models.transformer import _layer
    from repro_torch.runtime import losses

    dev = torch.device("cuda", 0)
    stats = {"card_vs_cpu": jamba_card_vs_cpu()}
    full_cfg = configs.get(JAMBA_ARCH)
    cfg = dataclasses.replace(
        full_cfg, n_layers=JAMBA_LAYERS,
        moe=dataclasses.replace(full_cfg.moe, n_experts=JAMBA_EXPERTS))
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"{JAMBA_ARCH}: cut to {JAMBA_LAYERS} of {full_cfg.n_layers} layers "
          f"({cfg.n_layers // cfg.attn_period} period of {cfg.attn_period}) "
          f"and {JAMBA_EXPERTS} of "
          f"{full_cfg.moe.n_experts} experts | device memory allocated "
          f"before init {base / 2**30:.3f} GiB")
    model = _build_on_card(cfg)
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    leaves = list(_leaves(params))
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    n_moe = sum(i % 2 for i in range(cfg.n_layers))
    n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_period
    print(f"model {cfg.arch_id} (cut): {cfg.n_layers} layers ({n_mamba} "
          f"Mamba, {cfg.n_layers - n_mamba} attention; {n_moe} MoE FFNs), "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.hd}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
          f"params ({n_bytes / 1e9:.2f} GB {cfg.param_dtype}), init "
          f"{init_s:.1f} s")
    stats.update(layers=cfg.n_layers, published_layers=full_cfg.n_layers,
                 experts=cfg.moe.n_experts,
                 published_experts=full_cfg.moe.n_experts, params=n_params,
                 param_bytes=n_bytes, allocated_before_init_gib=base / 2**30,
                 init_s=init_s)

    # -- scoring -----------------------------------------------------------
    B, E, T = JAMBA_BATCH, cfg.moe.n_experts, SCORE_LEN
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev)
    batch = {"tokens": tokens}
    model.forward(params, batch)  # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with RoutingLog(E) as log:
        zero_counts()
        t = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t
        launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    n_flash = cfg.n_layers // cfg.attn_period
    by_route = dict(_wrappers()["flash_attention"].launches_by_route)
    want = {"helmholtz": 0, "gemm_chain": 0, "flash_attention": n_flash}
    if launches != want or by_route != {"wgmma": n_flash, "fma": 0}:
        fail(f"{cfg.arch_id} scoring forward launched {launches}, flash by "
             f"route {by_route}; want {want}, all on wgmma")
    launches["flash_attention_by_route"] = by_route
    if logits.shape != (B, T, cfg.vocab) or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all():
        fail(f"{cfg.arch_id} logits {tuple(logits.shape)} {logits.dtype}, "
             "or not finite")
    loss = losses.next_token_loss(logits, tokens).item()
    if not math.isfinite(loss):
        fail(f"{cfg.arch_id} next-token loss {loss}")
    dropped = log.dropped_share()
    print(f"{cfg.arch_id} scoring forward ({B}, {T}): {fwd_s:.3f} s, "
          f"{B * T / fwd_s:.0f} tokens/s | launches {launches} | next-token "
          f"loss {loss:.1f} (ln V = {math.log(cfg.vocab):.4f}; the tied "
          f"embedding at scale 1 scores a position's own token about |e|^2 "
          f"= d) | dropped at the default capacity (factor "
          f"{cfg.moe.capacity_factor}) {dropped:.5f} | peak memory "
          f"{peak:.2f} GiB above the params and inputs")
    stats.update(forward_s=fwd_s, forward_tokens_per_s=B * T / fwd_s,
                 loss=loss, launches=launches, dropped_share=dropped,
                 peak_above_params_gib=peak)
    routes = log.by_position(n_moe, B)
    xla_model = _build_on_card(cfg, attn_impl="xla")
    with RoutingLog(E) as xla_log:
        t = time.perf_counter()
        logits_x = xla_model.forward(params, batch)
        torch.cuda.synchronize()
        stats["xla_forward_s"] = time.perf_counter() - t
    print(f"  {cfg.arch_id} attn_impl='xla' forward: "
          f"{stats['xla_forward_s']:.3f} s")
    stats["vs_xla"] = logit_agreement(
        logits, logits_x, f"{cfg.arch_id} kernel logits vs attn_impl='xla'",
        rerouted=rerouted(routes, xla_log.by_position(n_moe, B)))
    del logits, logits_x, xla_model, routes
    torch.cuda.empty_cache()

    # -- where the time goes: the Mamba loops a step, multiplied out; each
    # kind of layer alone at (B, T) ------------------------------------------
    steps = per_step(lambda n: model.forward(params, {"tokens": tokens[:, :n]}),
                     f"{cfg.arch_id} forward", JAMBA_STEP_PROFILE, T, fwd_s)
    period = _layer(params["periods"], 0)
    attn_sub = f"sub{cfg.attn_period - 1}"
    h = layers.norm_apply(period["sub0"]["ln1"], layers.embed_apply(
        params["embed"], tokens, cfg), cfg.norm, cfg.norm_eps)
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    mamba_runs = []
    for _ in range(3):  # the first warms up; the mean of the other two
        torch.cuda.synchronize()
        t = time.perf_counter()
        ssm.mamba_apply(period["sub0"]["mamba"], h, cfg)
        torch.cuda.synchronize()
        mamba_runs.append(time.perf_counter() - t)
    mamba_s = sum(mamba_runs[1:]) / 2
    layer_fns = {
        "moe": (lambda: moe.moe_apply(period["sub1"]["moe"], h, cfg),
                f"one MoE layer alone ({B}, {T})"),
        "mlp": (lambda: layers.mlp_apply(period["sub0"]["mlp"], h, cfg),
                f"one dense MLP alone ({B}, {T})"),
        "attention": (lambda: layers.attention_apply(
            period[attn_sub]["attn"], h, cfg, positions=pos),
            f"the attention layer alone ({B}, {T}), flash kernel"),
    }
    alone = {}
    for name, (fn, what) in layer_fns.items():
        fn()  # warm-up: a first call's wall time also pays the allocator
        alone[name] = device_profile(fn, what)
    counts = {"mamba": n_mamba, "moe": n_moe,
              "mlp": cfg.n_layers - n_moe, "attention": n_flash}
    walls = dict(mamba=mamba_s, **{k: v["wall_s"] for k, v in alone.items()})
    loop_s = T * steps["device_s_per_step"]
    other_dev = [v["device_s"] for v in alone.values()]
    busy = None
    if None not in other_dev:
        busy = (loop_s + sum(counts[k] * v["device_s"]
                             for k, v in alone.items())) / fwd_s
    shares = {k: counts[k] * walls[k] / fwd_s for k in walls}
    print(f"  one Mamba mixer alone ({B}, {T}): {mamba_s:.3f} s (the mean of "
          f"two after a warm-up of {mamba_runs[0]:.3f} s) | each kind "
          "of layer's wall times its count over the forward's: "
          + ", ".join(f"{k} x{counts[k]} {v:.3f}" for k, v in shares.items())
          + f" | busy share (the Mamba loops' kernels multiplied out, "
          f"{loop_s:.3f} s, plus the other layers' kernels alone) "
          + (f"{busy:.3f}" if busy is not None else "not measured"))
    stats.update(per_step=steps, mamba_alone_s=mamba_s,
                 mamba_alone_runs_s=mamba_runs, alone=alone,
                 layer_wall_shares=shares, loop_device_s=loop_s,
                 busy_share=busy, s_per_launch=steps["s_per_launch"])
    del h, pos

    # -- serving: prefill, greedy decode, teacher-forced forward ------------
    # capacity depends on a call's token count, so prefill and the
    # teacher-forced forward get one slot per token (nothing drops); decode
    # at batch 4 has the default 8 slots, more than its 4 tokens can fill
    Bs = SCORE_BATCH
    prompt = torch.randint(0, cfg.vocab, (Bs, PROMPT_LEN), generator=gen,
                           device=dev)
    cache = model.init_cache(Bs, PROMPT_LEN + DECODE_STEPS)
    with RoutingLog(E) as served_log:
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = model.prefill(params, {"tokens": prompt}, cache,
                                  moe_capacity=Bs * PROMPT_LEN)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        steps_lg, fed = [lg], []
        t = time.perf_counter()
        for i in range(DECODE_STEPS):
            tok = steps_lg[-1].argmax(-1)
            fed.append(tok)
            lg, cache = model.decode_step(params, tok, cache, PROMPT_LEN + i)
            steps_lg.append(lg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        serve_launches = read_counts()
    if any(serve_launches.values()):
        fail(f"{cfg.arch_id} prefill/decode launched {serve_launches}: the "
             "cache path should not reach a kernel of the port")
    if served_log.dropped_share() != 0.0:
        fail(f"{cfg.arch_id} serving dropped {served_log.dropped_share()} "
             "of its assignments")
    seq = torch.cat([prompt, torch.stack(fed, dim=1)], dim=1)
    # causal (attention and Mamba): padding past the sequence leaves its
    # logits unchanged, and 1024 rows satisfy the attention's block rule
    pad = torch.zeros(Bs, 1024 - seq.shape[1], dtype=seq.dtype, device=dev)
    with RoutingLog(E) as forced_log:
        full = model.forward(params, {"tokens": torch.cat([seq, pad], dim=1)},
                             moe_capacity=Bs * 1024)
    span = slice(PROMPT_LEN - 1, PROMPT_LEN + DECODE_STEPS)
    forced, served = full[:, span], torch.stack(steps_lg, dim=1)
    moved = rerouted(served_log.by_position(n_moe, Bs),
                     forced_log.by_position(n_moe, Bs)[:, :, :seq.shape[1]])
    print(f"  serving {cfg.arch_id}: prefill ({Bs}, {PROMPT_LEN}) "
          f"{prefill_s:.3f} s, {DECODE_STEPS} decode steps {decode_s:.3f} s "
          f"= {Bs * DECODE_STEPS / decode_s:.1f} tokens/s | launches "
          f"{serve_launches} | nothing dropped")
    stats.update(prefill_s=prefill_s, decode_s=decode_s,
                 decode_tokens_per_s=Bs * DECODE_STEPS / decode_s,
                 vs_forced=logit_agreement(
                     served, forced,
                     f"{cfg.arch_id} decode logits vs teacher-forced forward",
                     rerouted=moved[:, span]))
    last = PROMPT_LEN + DECODE_STEPS - 1   # rewrites that slot's same K/V
    stats["decode_profile"] = device_profile(
        lambda: model.decode_step(params, fed[-1], cache, last),
        f"{cfg.arch_id} one decode step")
    stats["flash_launches"] = launches["flash_attention"]
    del model, params, tokens, cache, full, forced, served, steps_lg, lg
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def whisper_card_vs_cpu() -> dict:
    """The smoke encoder-decoder in float32 on the card against the same
    code on the CPU, the same params: ``encode`` of (2, n_audio_frames)
    frames at the published 1,500 (a whole-axis block; the flash kernel
    on its fma route at head dim 16) and a whole ``encdec_forward`` on
    (2, WHISPER_CHECK_TOKENS) tokens, both at ``attn_impl="pallas"``
    (the kernel on the card, its plain version on the CPU), within rtol
    1e-5 / atol 1e-5 max|CPU|; exactly 2 and 4 fma launches on the
    card."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.kernels.attention import attention
    from repro_torch.models import transformer

    Tf = configs.get(WHISPER_ARCH).n_audio_frames
    cfg = dataclasses.replace(configs.get_smoke(WHISPER_ARCH),
                              n_audio_frames=Tf)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    params = transformer.encdec_init(cfg, gen, device="cpu")
    p_dev = _tree_to(params, dev)
    frames = torch.randn(2, Tf, cfg.d_model, generator=gen)
    tokens = torch.randint(0, cfg.vocab, (2, WHISPER_CHECK_TOKENS),
                           generator=gen)
    out = {}
    for name, n_flash, run in (
            ("encode", cfg.n_encoder_layers, lambda p, f, t: transformer.encode(
                p, f, cfg, attn_impl="pallas")),
            ("encdec_forward", cfg.n_encoder_layers + cfg.n_layers,
             lambda p, f, t: transformer.encdec_forward(
                 p, f, t, cfg, attn_impl="pallas"))):
        want = run(params, frames, tokens)
        before = dict(attention.flash_attention.launches_by_route)
        got = run(p_dev, frames.to(dev), tokens.to(dev))
        torch.cuda.synchronize()
        after = dict(attention.flash_attention.launches_by_route)
        if after != dict(before, fma=before["fma"] + n_flash):
            fail(f"{cfg.arch_id} {name} on the card: flash launches by route "
                 f"{before} -> {after}; want {n_flash} fma launches")
        out[name] = compare(got.cpu(), want, XLSTM_CARD_RTOL, XLSTM_CARD_RTOL,
                            f"{cfg.arch_id} {name} on the card vs the CPU")
    print(f"{cfg.arch_id} on the card vs the CPU (float32, (2, {Tf}) frames, "
          f"(2, {WHISPER_CHECK_TOKENS}) tokens, the flash kernel against its "
          "plain version; max|err|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in out.items()))
    return out


def phase_whisper() -> dict:
    """Phase W: the encoder-decoder.  The smoke model on the card against
    the CPU; whisper-tiny at its published widths (bf16, seed 0): a
    scoring forward of WHISPER_BATCH x (1,500 frames, 448 tokens) through
    the flash kernel (8 wgmma launches: 4 encoder layers at one
    whole-axis block, 4 causal decoder layers) against
    ``attn_impl="xla"``, where its time goes; then prefill of the
    4-token prompt (4 launches, the encoder's) and 32 greedy decode
    steps (none) against the teacher-forced forward, with what
    recomputing the cross-attention's K and V costs a step."""
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.runtime import losses

    dev = torch.device("cuda", 0)
    stats = {"card_vs_cpu": whisper_card_vs_cpu()}
    cfg = configs.get(WHISPER_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    model = _build_on_card(cfg)
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in _leaves(params))
    L_enc, L_dec = cfg.n_encoder_layers, cfg.n_layers
    print(f"model {cfg.arch_id}: {L_enc} encoder and {L_dec} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_audio_frames} frames: "
          f"{n_params / 1e6:.3f} M params ({cfg.param_dtype}), init "
          f"{init_s:.1f} s")
    stats.update(params=n_params, init_s=init_s)

    # -- scoring ------------------------------------------------------------
    B, T, Tf = WHISPER_BATCH, WHISPER_TOKENS, cfg.n_audio_frames
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn(B, Tf, cfg.d_model, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev)
    batch = {"frames": frames, "tokens": tokens}
    model.forward(params, batch)  # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    logits = model.forward(params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    n_flash = L_enc + L_dec
    by_route = dict(_wrappers()["flash_attention"].launches_by_route)
    want = {"helmholtz": 0, "gemm_chain": 0, "flash_attention": n_flash}
    if launches != want or by_route != {"wgmma": n_flash, "fma": 0}:
        fail(f"{cfg.arch_id} scoring forward launched {launches}, flash by "
             f"route {by_route}; want {want}, all on wgmma")
    launches["flash_attention_by_route"] = by_route
    if logits.shape != (B, T, cfg.vocab) or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all():
        fail(f"{cfg.arch_id} logits {tuple(logits.shape)} {logits.dtype}, "
             "or not finite")
    loss = losses.next_token_loss(logits, tokens).item()
    if not math.isfinite(loss):
        fail(f"{cfg.arch_id} next-token loss {loss}")
    print(f"{cfg.arch_id} scoring forward ({B} x ({Tf} frames, {T} tokens)): "
          f"{fwd_s:.4f} s, {B * T / fwd_s:.0f} tokens/s ({B * Tf / fwd_s:.0f} "
          f"frames/s) | launches {launches} | next-token loss {loss:.1f} (ln V "
          f"= {math.log(cfg.vocab):.4f}; the tied embedding at scale 1 scores "
          f"a position's own token about |e|^2 = d) | peak memory {peak:.2f} "
          "GiB above the params and inputs")
    stats.update(forward_s=fwd_s, forward_tokens_per_s=B * T / fwd_s,
                 forward_frames_per_s=B * Tf / fwd_s, loss=loss,
                 launches=launches, peak_above_params_gib=peak)
    stats["forward_profile"] = device_profile(
        lambda: model.forward(params, batch), f"{cfg.arch_id} scoring forward")
    xla_model = _build_on_card(cfg, attn_impl="xla")
    t = time.perf_counter()
    logits_x = xla_model.forward(params, batch)
    torch.cuda.synchronize()
    stats["xla_forward_s"] = time.perf_counter() - t
    print(f"  {cfg.arch_id} attn_impl='xla' forward: "
          f"{stats['xla_forward_s']:.4f} s")
    stats["vs_xla"] = logit_agreement(
        logits, logits_x, f"{cfg.arch_id} kernel logits vs attn_impl='xla'")
    del logits, logits_x, xla_model
    torch.cuda.empty_cache()

    # -- serving: prefill, greedy decode, teacher-forced forward ------------
    P = WHISPER_PROMPT
    prompt = {"frames": frames, "tokens": tokens[:, :P]}
    cache = model.init_cache(B, T)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = model.prefill(params, prompt, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = read_counts()
    want = {"helmholtz": 0, "gemm_chain": 0, "flash_attention": L_enc}
    if prefill_launches != want:
        fail(f"{cfg.arch_id} prefill launched {prefill_launches}; want {want} "
             "(the encoder's layers)")
    steps, fed = [lg], []
    zero_counts()
    t = time.perf_counter()
    for i in range(DECODE_STEPS):
        tok = steps[-1].argmax(-1)
        fed.append(tok)
        lg, cache = model.decode_step(params, tok, cache, P + i)
        steps.append(lg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    decode_launches = read_counts()
    if any(decode_launches.values()):
        fail(f"{cfg.arch_id} decode launched {decode_launches}: the cache "
             "path should not reach a kernel of the port")
    seq = torch.cat([tokens[:, :P], torch.stack(fed, dim=1)], dim=1)
    full = model.forward(params, {"frames": frames, "tokens": seq})
    forced = full[:, P - 1:P + DECODE_STEPS]
    served = torch.stack(steps, dim=1)
    print(f"  serving {cfg.arch_id}: prefill ({B}, {P}) with {Tf} frames "
          f"{prefill_s:.4f} s (launches {prefill_launches}), {DECODE_STEPS} "
          f"decode steps {decode_s:.4f} s = {B * DECODE_STEPS / decode_s:.1f} "
          f"tokens/s (launches {decode_launches})")
    stats.update(prefill_s=prefill_s, prefill_launches=prefill_launches,
                 decode_s=decode_s,
                 decode_tokens_per_s=B * DECODE_STEPS / decode_s,
                 decode_launches=decode_launches,
                 vs_forced=logit_agreement(
                     served, forced,
                     f"{cfg.arch_id} decode logits vs teacher-forced forward"))
    last = P + DECODE_STEPS - 1   # rewrites that slot's same K/V
    stats["decode_profile"] = device_profile(
        lambda: model.decode_step(params, fed[-1], cache, last),
        f"{cfg.arch_id} one decode step")
    # what recomputing the cross-attention's K and V of every frame costs a
    # step (the reference's decode does it too): those projections alone
    enc, cd = cache["enc"], layers.torch_dtype(cfg.compute_dtype)

    def cross_kv():
        for bp in params["dec_blocks"]:
            layers.dense_apply(bp["cross_attn"]["wk"], enc, cd)
            layers.dense_apply(bp["cross_attn"]["wv"], enc, cd)

    kv_ms = time_ms(cross_kv, 10)
    kv_flops = 2 * 2 * L_dec * B * Tf * cfg.d_model * cfg.n_kv_heads * cfg.hd
    step_s = decode_s / DECODE_STEPS
    print(f"  cross-attention K and V of {Tf} frames recomputed a step: "
          f"{kv_ms:.3f} ms on the card ({kv_flops / 1e9:.1f} GFLOP), "
          f"{kv_ms / 1e3 / step_s:.3f} of a decode step's {step_s * 1e3:.2f} "
          "ms of wall")
    stats.update(cross_kv_ms=kv_ms, cross_kv_gflop=kv_flops / 1e9,
                 cross_kv_share_of_step=kv_ms / 1e3 / step_s,
                 flash_launches=launches["flash_attention"]
                 + prefill_launches["flash_attention"])
    del model, params, frames, tokens, cache, full, forced, served, steps, lg
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _rel_l2(got, want) -> float:
    want = want.float()
    den = want.norm().item()
    diff = (got.float() - want).norm().item()
    return diff / den if den else diff


def _state_leaves(state):
    from repro_torch.tree import named_leaves

    return named_leaves(state)


def train_card_vs_cpu() -> dict:
    """The smoke internlm2 (float32) on the card against the CPU: the same
    params and batch on both, the loss and every gradient of one step,
    then the params after two AdamW steps (each leaf's update within
    TRAIN_CARD_UPDATE_L2 relative L2 of the CPU's)."""
    import torch

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (init_train_state, make_loss_fn,
                                           make_train_step, value_and_grad)

    dev = torch.device("cuda", 0)
    cfg = configs.get_smoke(TRAIN_ARCH)
    models = {d: build_model(cfg, device=d) for d in ("cpu", dev)}
    state_cpu = init_train_state(models["cpu"],
                                 torch.Generator().manual_seed(0))
    states = {"cpu": state_cpu, dev: _tree_to(state_cpu, dev)}
    p0 = _tree_to(state_cpu["params"], "cpu")
    stream = TokenStream(vocab=cfg.vocab, batch=TRAIN_SMOKE_BATCH,
                         seq_len=TRAIN_SMOKE_LEN, seed=0)
    batches = [stream.batch_at(i) for i in range(2)]
    out = {}
    zero_counts()
    grads, losses = {}, {}
    for d, model in models.items():
        batch = {k: torch.as_tensor(v, device=d) for k, v in batches[0].items()}
        losses[d], grads[d] = value_and_grad(make_loss_fn(model),
                                             states[d]["params"], batch)
    # remat "block": each layer's forward runs again in the backward
    want = (2 * cfg.n_layers, cfg.n_layers)
    if (read_counts()["flash_attention"], read_bwd_count()) != want:
        fail(f"smoke step on the card: flash {read_counts()}, backward "
             f"{read_bwd_count()}; want {want[0]} forward, {want[1]} backward")
    l_card, l_cpu = losses[dev].item(), losses["cpu"].item()
    if not abs(l_card - l_cpu) <= TRAIN_CARD_LOSS_RTOL * abs(l_cpu):
        fail(f"smoke step: loss on the card {l_card} vs CPU {l_cpu}")
    out["loss_card"], out["loss_cpu"] = l_card, l_cpu
    g_cpu = dict(_state_leaves(grads["cpu"]))
    out["grad_max_abs_err"] = max(
        compare(g.cpu(), g_cpu[n], TRAIN_CARD_GRAD_TOL, TRAIN_CARD_GRAD_TOL,
                f"smoke step gradient {n}")
        for n, g in _state_leaves(grads[dev]))
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    for d, model in models.items():
        step = make_train_step(model, opt)
        for b in batches:
            states[d], _ = step(states[d], b)
    cpu_p = dict(_state_leaves(states["cpu"]["params"]))
    base = dict(_state_leaves(p0))
    worst = 0.0
    for n, p in _state_leaves(states[dev]["params"]):
        e = _rel_l2(p.cpu() - base[n], cpu_p[n] - base[n])
        if not e <= TRAIN_CARD_UPDATE_L2:
            fail(f"smoke steps: {n}'s update on the card is {e:.3e} "
                 "relative L2 off the CPU's")
        worst = max(worst, e)
    out["update_rel_l2"] = worst
    print(f"  smoke {cfg.arch_id} (float32, {TRAIN_SMOKE_BATCH} x "
          f"{TRAIN_SMOKE_LEN}) card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f}, "
          f"max|grad err| {out['grad_max_abs_err']:.3e}, two AdamW steps' "
          f"updates within {worst:.3e} relative L2")
    return out


def train_resume() -> dict:
    """The smoke model on the card: 3 steps, a checkpoint, 2 more; then the
    checkpoint restored and the same 2 steps again: losses and every leaf
    of the state bitwise equal (deterministic kernels, resumable data)."""
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    dev = torch.device("cuda", 0)
    cfg = configs.get_smoke(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=10))
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))

    def run(state, start, n):
        data = TokenStream(vocab=cfg.vocab, batch=TRAIN_SMOKE_BATCH,
                           seq_len=TRAIN_SMOKE_LEN, seed=0, start_step=start)
        losses = []
        for _ in range(n):
            state, m = step(state, next(data))
            losses.append(m["loss"].item())
        return state, losses

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        state, first = run(state, 0, 3)
        mgr.save(state, step=3, blocking=False)
        mgr.wait()
        state, tail = run(state, 3, 2)
        ref_leaves = [(n, v.clone()) for n, v in _state_leaves(state)]
        restored = mgr.restore(state)
        if int(restored["step"]) != 3:
            fail(f"resume: restored step {int(restored['step'])}, want 3")
        restored, again = run(restored, 3, 2)
    if tail != again:
        fail(f"resume: losses {again} after the restore, {tail} without")
    got = dict(_state_leaves(restored))
    for n, v in ref_leaves:
        if not torch.equal(got[n], v):
            fail(f"resume: {n} differs bitwise from the uninterrupted run")
    print(f"  resume (smoke, card): losses {first} | {tail}; after restoring "
          f"step 3: {again}, every one of {len(ref_leaves)} state leaves "
          "bitwise equal")
    return dict(losses=first + tail, resumed=again, leaves=len(ref_leaves))


def train_families_card_vs_cpu() -> dict:
    """Every family's smoke step (float32) on the card against the CPU:
    the same params (the CPU's init, copied) and batch on both, the loss
    and every gradient leaf of one ``value_and_grad`` (the card through
    the flash kernels, the CPU through plain attention)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.runtime.train import (init_train_state, make_loss_fn,
                                           value_and_grad)

    dev = torch.device("cuda", 0)
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_smoke(arch)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(
            0, cfg.vocab, (FAMILY_BATCH, FAMILY_LEN)).astype(np.int32))
            for k in ("tokens", "labels")}
        if cfg.is_encdec:
            batch["frames"] = torch.as_tensor(rng.normal(size=(
                FAMILY_BATCH, cfg.n_audio_frames, cfg.d_model)).astype(
                    np.float32))
        res = {}
        params = init_train_state(build_model(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0))["params"]
        for d in ("cpu", dev):
            loss, grads = value_and_grad(
                make_loss_fn(build_model(cfg, device=d)), _tree_to(params, d),
                {k: v.to(d) for k, v in batch.items()})
            res[d] = (loss.item(), dict(_state_leaves(grads)))
        (l_card, g_card), (l_cpu, g_cpu) = res[dev], res["cpu"]
        if not abs(l_card - l_cpu) <= TRAIN_CARD_LOSS_RTOL * abs(l_cpu):
            fail(f"{arch} smoke step: loss on the card {l_card} vs CPU {l_cpu}")
        scale = max(g.abs().max().item() for g in g_cpu.values())
        err = {n: (g.cpu() - g_cpu[n]).abs().max().item()
               for n, g in g_card.items()}
        worst = max(err, key=err.get)
        if not err[worst] <= FAMILY_GRAD_FRAC * scale:
            fail(f"{arch} smoke step: gradient {worst} off the CPU's by "
                 f"{err[worst]:.3e} > {FAMILY_GRAD_FRAC} x {scale:.3e}")
        out[arch] = dict(loss_card=l_card, loss_cpu=l_cpu,
                         grad_err_frac=err[worst] / scale, worst_leaf=worst)
        print(f"  {arch} smoke step card vs CPU (float32): loss {l_card:.6f} "
              f"vs {l_cpu:.6f}, worst gradient {err[worst] / scale:.2e} of "
              f"max|grad| ({worst})")
    return out


def _step_launches() -> dict:
    from repro_torch.kernels.attention import attention

    return dict(forward=read_counts()["flash_attention"],
                forward_wgmma=_wrappers()[
                    "flash_attention"].launches_by_route["wgmma"],
                backward=read_bwd_count(),
                backward_wgmma=attention.flash_attention_bwd
                .launches_by_route["wgmma"])


def train_sharded_one_rank() -> dict:
    """internlm2-1.8b whole, its state distributed over a 1 x 1
    ``DeviceMesh`` on cuda:0 (``make_local_mesh``'s one-process nccl
    group): TRAIN_SHARDED_STEPS steps against the unsharded step from a
    copy of the same state on the same batches, each bitwise equal in
    loss, grad norm and every leaf of the state; both steps' seconds
    (the sharded one's excess is DTensor's dispatch) and flash launches
    (counters zeroed just before each step and read just after)."""
    import gc

    import torch
    import torch.distributed

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step
    from repro_torch.tree import tree_map

    dev = torch.device("cuda", 0)
    cfg = configs.get(TRAIN_ARCH)
    model = build_model(cfg)
    mesh = make_local_mesh(1, device=dev)
    if mesh.size() != 1:
        fail(f"mesh of {mesh.size()} ranks; want 1")
    plain = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    state = sharding.distribute_state(tree_map(torch.clone, plain), mesh)
    step = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=10,
                                              total_steps=TRAIN_STEPS))
    stream = TokenStream(vocab=cfg.vocab, batch=TRAIN_BATCH,
                         seq_len=TRAIN_SHARDED_LEN, seed=0)
    want = dict(forward=2 * cfg.n_layers, forward_wgmma=2 * cfg.n_layers,
                backward=cfg.n_layers, backward_wgmma=cfg.n_layers)
    steps, total = [], {"forward": 0, "backward": 0}
    for i in range(TRAIN_SHARDED_STEPS):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.batch_at(i).items()}
        row = {}
        for name in ("unsharded", "sharded"):
            b = batch if name == "unsharded" else sharding.distribute_batch(
                batch, mesh)
            zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "unsharded":
                plain, m = step(plain, b)
            else:
                state, m = step(state, b)
            loss = m["loss"].item()
            row[name] = dict(s=time.perf_counter() - t, loss=loss,
                             grad_norm=m["grad_norm"].item(),
                             launches=_step_launches(), metrics=m)
            if row[name]["launches"] != want:
                fail(f"{name} step {i}: flash launches "
                     f"{row[name]['launches']}; want {want}")
            total["forward"] += row[name]["launches"]["forward"]
            total["backward"] += row[name]["launches"]["backward"]
        mu, ms = row["unsharded"].pop("metrics"), row["sharded"].pop("metrics")
        for k in ("loss", "grad_norm", "lr"):
            if not torch.equal(mu[k], ms[k]):
                fail(f"sharded step {i}: {k} {ms[k].item()!r} vs unsharded "
                     f"{mu[k].item()!r}")
        got = dict(_state_leaves(state))
        bad = [n for n, v in _state_leaves(plain)
               if not torch.equal(got[n].to_local() if hasattr(
                   got[n], "to_local") else got[n], v)]
        if bad:
            fail(f"sharded step {i}: {len(bad)} state leaves differ from "
                 f"the unsharded step's, first {bad[0]}")
        steps.append(row)
        print(f"  sharded step {i} (1 x 1 mesh, {TRAIN_BATCH} x "
              f"{TRAIN_SHARDED_LEN}): {row['sharded']['s']:.3f} s vs "
              f"unsharded {row['unsharded']['s']:.3f} s, loss "
              f"{row['sharded']['loss']:.5f}, flash "
              f"{row['sharded']['launches']}; loss, grad norm and "
              f"{len(got)} state leaves bitwise the unsharded step's")
    del plain, state, step, got
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    warm = steps[1:]
    return dict(mesh={"data": 1, "model": 1}, batch=TRAIN_BATCH,
                seq_len=TRAIN_SHARDED_LEN, steps=steps, launches=total,
                sharded_s=sum(r["sharded"]["s"] for r in warm) / len(warm),
                unsharded_s=sum(r["unsharded"]["s"] for r in warm) / len(warm),
                bitwise=True)


#: kernel classes of a train step's profile, matched in order on the
#: lower-cased kernel name
KERNEL_CLASSES = (
    ("flash backward", ("flash_bwd",)),
    ("flash forward", ("flash_sm90", "flash_attention_kernel")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("copies and casts", ("copy",)),
    ("reductions and softmax", ("reduce", "softmax", "norm")),
    ("other elementwise", ("elementwise",)),
)


def kernel_breakdown(kernels, what: str) -> dict:
    """Device seconds and calls of ``profiled_kernels``' result by
    :data:`KERNEL_CLASSES` (the rest as "other"), printed largest first."""
    out = {}
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "other")
        s, n = out.get(cls, (0.0, 0))
        out[cls] = (s + e.self_device_time_total / 1e6, n + e.count)
    total = sum(s for s, _ in out.values())
    print(f"  {what}: {total:.4f} s on the card")
    for cls, (sec, n) in sorted(out.items(), key=lambda x: -x[1][0]):
        print(f"    {cls}: {sec:.4f} s ({sec / total:.3f}), {n} calls")
    return {cls: dict(s=sec, calls=n) for cls, (sec, n) in out.items()}


def phase_dryrun(card: str) -> dict:
    """Phase Y: the dry run (``launch.dryrun``).  Its single-pod cells
    (``DRYRUN_SHAPES`` of every arch but ``DRYRUN_COMPOSED``'s train
    cells, and ``DRYRUN_RECURRENT``'s composed cells, each held within
    ``DRYRUN_TEMP_RATIO`` of the reference's temporaries) and
    ``DRYRUN_MULTIPOD``'s cells on the multi-pod mesh, on
    meta tensors over a fake group of 256 or 512 ranks, built in a
    process of its own while nothing else runs, each with status,
    seconds, per-device GFLOPs, bytes, collective bytes, memory and
    bound (a train cell whose largest temporaries have the whole vocab
    as their last dim, where the model axis splits it, fails the phase,
    as does a multi-pod train cell that holds a RoPE table of the global
    batch among them -- its three largest are printed -- and a cell of
    ``DRYRUN_FIT`` whose arguments and temporaries exceed the card's 80
    GiB);
    then two card checks, each a step counted by
    ``FlopCounterMode`` on the card that must equal the dry run's 1 x 1
    count of it exactly (the same ops), its peak memory and seconds
    printed beside the dry run's prediction and roofline bound: phase
    T's check step (internlm2-1.8b, TRAIN_BATCH x TRAIN_CHECK_LEN,
    ``attn_impl="xla"``, one AdamW step) and phase T's training step
    (TRAIN_BATCH x TRAIN_LEN through the flash kernels, remat "block";
    counters zeroed just before the counted step and read just after:
    48 forward and 24 backward launches, all wgmma)."""
    import torch

    t = time.perf_counter()
    job = dict(shapes=DRYRUN_SHAPES, composed=DRYRUN_COMPOSED,
               multipod=DRYRUN_MULTIPOD, recurrent=DRYRUN_RECURRENT,
               arch=TRAIN_ARCH, batch=TRAIN_BATCH,
               check_len=TRAIN_CHECK_LEN, train_len=TRAIN_LEN)
    try:
        host = subprocess.run(
            [sys.executable, "-c", DRYRUN_HOST, str(SRC), json.dumps(job)],
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"the dry run's host process took over {DRYRUN_TIMEOUT_S} s")
    if host.returncode != 0:
        fail(f"the dry run's host process failed: {host.stderr[-3000:]}")
    res = json.loads(host.stdout.strip().splitlines()[-1])
    host_s = time.perf_counter() - t
    print(f"  the host's cells and counts: {host_s:.1f} s (torch "
          f"{res['cells'][0]['torch_version']})")
    bad = [f"{c['arch']} {c['shape']} {c['mesh']}: {c.get('error')}"
           for c in res["cells"] if c["status"] == "error"]
    for c in res["cells"]:
        if c["status"] != "ok":
            print(f"  {c['arch']:<22} {c['shape']:<11} {c['mesh']:<8} "
                  f"{c['status']} ({c.get('reason') or c.get('error')})")
            continue
        rf, ma = c["roofline"], c["memory_analysis"]
        print(f"  {c['arch']:<22} {c['shape']:<11} {c['mesh']:<8} ok "
              f"{c['seconds']:6.1f} s  "
              f"{rf['device_flops'] / 1e9:12.1f} GFLOP  "
              f"{rf['device_bytes'] / 1e9:10.1f} GB  coll "
              f"{rf['coll_bytes'] / 1e6:12.1f} MB  mem "
              f"{ma['argument_size_in_bytes'] / 2**30:.2f}+"
              f"{ma['temp_size_in_bytes'] / 2**30:.2f} GiB  bound "
              f"{rf['bottleneck']} {max(rf['t_compute'], rf['t_memory'], rf['t_collective']):.4g} s")
        # the vocab-parallel head and loss: no logits-like tensor (the
        # whole vocab as its last dim) among the largest live at a train
        # cell's peak, where the model axis of 16 splits the vocab
        vocab = c["vocab"]
        if c["shape"] == "train_4k" and vocab % 16 == 0 and any(
                shape[-1] == vocab
                for _, shape, _, _ in c["peak_temporaries"]):
            bad.append(f"{c['arch']} train_4k {c['mesh']}: a tensor with "
                       f"the whole vocab of {vocab} at the peak "
                       f"({c['peak_temporaries']})")
        # RoPE's tables built from the positions every row shares: no
        # (global batch, ..., T, hd / 2) table among the largest live at
        # a multi-pod train cell's peak
        if c["mesh"] == "multipod" and c["shape"] == "train_4k":
            print(f"    {c['arch']} train_4k multipod, its largest "
                  f"temporaries: " + "; ".join(
                      f"{tuple(shape)} {dtype} {op} {size / 2**30:.2f} GiB"
                      for size, shape, dtype, op in
                      c["peak_temporaries"][:3]))
            rope = c["rope_table"]
            if rope and any(len(shape) > 2 and shape[0] == rope[0]
                            and list(shape[-2:]) == rope[1:]
                            for _, shape, _, _ in c["peak_temporaries"]):
                bad.append(f"{c['arch']} train_4k multipod: a RoPE table "
                           f"of the global batch of {rope[0]} at the peak "
                           f"({c['peak_temporaries']})")
        for arch, name, ref_gib in DRYRUN_RECURRENT:
            if (c["arch"], c["shape"], c["mesh"]) != (arch, name, "single"):
                continue
            tmp = ma["temp_size_in_bytes"] / 2**30
            print(f"    {arch} {name} single: temporaries {tmp:.2f} GiB "
                  f"beside the reference's {ref_gib:.2f} GiB "
                  f"({tmp / ref_gib:.2f}x; its largest: " + "; ".join(
                      f"{tuple(shape)} {dtype} {op}" for _, shape, dtype, op
                      in c["peak_temporaries"][:3]) + ")")
            if tmp > DRYRUN_TEMP_RATIO * ref_gib:
                bad.append(f"{arch} {name} single: {tmp:.2f} GiB of "
                           f"temporaries, over {DRYRUN_TEMP_RATIO}x the "
                           f"reference's {ref_gib:.2f}")
        held = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        if (c["arch"], c["shape"], c["mesh"]) in DRYRUN_FIT and (
                held > DRYRUN_FIT_BYTES):
            bad.append(f"{c['arch']} {c['shape']} {c['mesh']}: "
                       f"{held / 2**30:.2f} GiB of arguments and "
                       f"temporaries, over the card's "
                       f"{DRYRUN_FIT_BYTES / 2**30:.0f}")
    if bad:
        fail("dry-run cells failed: " + "; ".join(bad))
    checks = {}
    for key in ("check", "check_auto"):
        checks[key] = _dryrun_card_check(card, res[key])
    return {"cells": [{k: c.get(k) for k in ("arch", "shape", "mesh",
                                               "status", "seconds",
                                               "roofline",
                                               "memory_analysis", "reason",
                                               "error")}
                      for c in res["cells"]],
            "card_check": checks["check"],
            "card_check_auto": checks["check_auto"],
            "host_s": host_s}


def _dryrun_card_check(card: str, check: dict) -> dict:
    """One of phase Y's card checks: ``check`` (the host's 1 x 1 count of
    a TRAIN_BATCH x ``check["seq_len"]`` internlm2-1.8b train step at
    ``check["attn_impl"]``) against the same step on the card, counted by
    ``FlopCounterMode`` with ``FLOP_FORMULAS`` (counters zeroed just
    before it and read just after), then three timed steps' seconds and
    the peak memory above the pre-state base."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.launch.dryrun import FLOP_FORMULAS
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    impl, seq_len = check["attn_impl"], check["seq_len"]
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = configs.get(TRAIN_ARCH)
    model = build_model(cfg, attn_impl=impl)
    base = torch.cuda.memory_allocated()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(
        vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=seq_len,
        seed=1).batch_at(0).items()}
    step = make_train_step(model, AdamWConfig())
    zero_counts()
    with FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS) as fc:
        state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = _step_launches()
    flops = fc.get_total_flops()
    if flops != check["flops"]:
        fail(f"the card's {impl} step counts {flops} FLOPs, the dry run's "
             f"1 x 1 count {check['flops']}")
    want = (dict(forward=0, forward_wgmma=0, backward=0, backward_wgmma=0)
            if impl == "xla" else
            dict(forward=2 * cfg.n_layers, forward_wgmma=2 * cfg.n_layers,
                 backward=cfg.n_layers, backward_wgmma=cfg.n_layers))
    if launches != want:
        fail(f"the {impl} check step launched {launches}; want {want}")
    seconds = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.isfinite(m["loss"]):
        fail(f"the {impl} check step's loss is not finite")
    ma = check["memory"]
    predicted = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
    bound = max(check["t_compute"], check["t_memory"])
    print(f"  card check ({card}): {cfg.arch_id} train step {TRAIN_BATCH} x "
          f"{seq_len}, attn_impl={impl!r}: FlopCounterMode "
          f"{flops} FLOPs = the dry run's 1 x 1 count (held exactly), "
          f"flash {launches}; peak memory {peak / 2**30:.2f} GiB measured "
          f"vs {predicted / 2**30:.2f} GiB predicted (arguments "
          f"{ma['argument_size_in_bytes'] / 2**30:.2f} + temporaries "
          f"{ma['temp_size_in_bytes'] / 2**30:.2f}); a step "
          f"{min(seconds):.4f}-{max(seconds):.4f} s against the roofline's "
          f"max(t_compute {check['t_compute']:.4f}, t_memory "
          f"{check['t_memory']:.4f}) = {bound:.4f} s")
    del state, batch, step, model, m
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, attn_impl=impl, seq_len=seq_len, flops=flops,
                dryrun_flops=check["flops"], launches=launches,
                peak_bytes=peak, predicted_bytes=predicted, memory=ma,
                step_s=seconds, t_compute=check["t_compute"],
                t_memory=check["t_memory"], bound_s=bound,
                dryrun_host_s=check["seconds"])


def phase_train() -> dict:
    """Phase T: the training path on the card -- the smoke step against
    the CPU, a bitwise resume, internlm2-1.8b trained whole, and one step
    through the kernels against attn_impl="xla"."""
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch.data import PrefetchPipeline, TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves
    from repro_torch.runtime.train import (init_train_state, make_loss_fn,
                                           make_train_step, value_and_grad)

    stats = {"card_vs_cpu": train_card_vs_cpu(), "resume": train_resume(),
             "families": train_families_card_vs_cpu()}
    gc.collect()
    torch.cuda.empty_cache()

    dev = torch.device("cuda", 0)
    cfg = configs.get(TRAIN_ARCH)
    if cfg.remat != "block" or cfg.param_dtype != "bfloat16":
        fail(f"{cfg.arch_id}: remat {cfg.remat}, params {cfg.param_dtype}; "
             "want block and bfloat16")
    model = build_model(cfg)
    t = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    state_gb = sum(x.numel() * x.element_size()
                   for x in tree_leaves(state)) / 1e9
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab "
          f"{cfg.vocab}: {n_params / 1e6:.1f} M params ({cfg.param_dtype}), "
          f"train state {state_gb:.2f} GB, init "
          f"{time.perf_counter() - t:.1f} s")
    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=TRAIN_STEPS)
    train_step = make_train_step(model, opt)
    data = PrefetchPipeline(TokenStream(vocab=cfg.vocab, batch=TRAIN_BATCH,
                                        seq_len=TRAIN_LEN, seed=0),
                            device=dev)
    n_tok = TRAIN_BATCH * TRAIN_LEN
    steps = []
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    zero_counts()
    for i in range(TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = train_step(state, batch)
        loss = m["loss"].item()
        dt = time.perf_counter() - t
        fwd, bwd = read_counts()["flash_attention"], read_bwd_count()
        want = (2 * cfg.n_layers * (i + 1), cfg.n_layers * (i + 1))
        if (fwd, bwd) != want:
            fail(f"train step {i}: flash forward/backward launches so far "
                 f"{fwd}/{bwd}, want {want[0]}/{want[1]}")
        if read_bwd_routes() != {"wgmma": want[1], "fma": 0}:
            fail(f"train step {i}: flash backward launches by route "
                 f"{read_bwd_routes()}; want all {want[1]} on wgmma")
        gnorm, lr = m["grad_norm"].item(), m["lr"].item()
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train step {i}: loss {loss}, grad norm {gnorm}")
        steps.append(dict(step=i, s=dt, tokens_per_s=n_tok / dt, loss=loss,
                          grad_norm=gnorm, lr=lr))
        print(f"  step {i}: {dt:.3f} s, {n_tok / dt:,.0f} tokens/s, loss "
              f"{loss:.4f}, grad norm {gnorm:.4f}, lr {lr:.3e}")
    launches = read_counts()
    launches["flash_attention_bwd"] = read_bwd_count()
    launches["flash_attention_bwd_by_route"] = read_bwd_routes()
    launches["flash_attention_by_route"] = dict(
        _wrappers()["flash_attention"].launches_by_route)
    if launches["flash_attention_by_route"]["fma"] != 0:
        fail(f"training launched {launches}: want every forward on wgmma")
    data.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if int(state["step"]) != TRAIN_STEPS:
        fail(f"state step {int(state['step'])}, want {TRAIN_STEPS}")
    warm = steps[1:]
    print(f"  {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_LEN}: launches "
          f"{launches} | steps 1-{TRAIN_STEPS - 1}: "
          f"{sum(x['s'] for x in warm) / len(warm):.3f} s a step, "
          f"{n_tok * len(warm) / sum(x['s'] for x in warm):,.0f} tokens/s | "
          f"peak memory {peak_gb:.2f} GB ({TRAIN_PEAK_GATHER_GB:.2f} GB "
          f"before the vocab-parallel loss; train state {base_gb:.2f} GB)")
    stats.update(arch=cfg.arch_id, params=n_params, state_gb=state_gb,
                 batch=TRAIN_BATCH, seq_len=TRAIN_LEN, steps=steps,
                 launches=launches, peak_gb=peak_gb,
                 mean_step_s=sum(x["s"] for x in warm) / len(warm),
                 tokens_per_s=n_tok * len(warm) / sum(x["s"] for x in warm))
    stats["step_profile"] = device_profile(
        lambda: train_step(state, batch), "one train step")
    stats["step_breakdown"] = kernel_breakdown(
        profiled_kernels(lambda: train_step(state, batch)),
        "one train step's kernels")
    del batch
    gc.collect()

    # one step through the kernels against attn_impl="xla"
    check = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(
        vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_CHECK_LEN,
        seed=1).batch_at(0).items()}
    params = state["params"]
    del state, train_step
    gc.collect()
    torch.cuda.empty_cache()
    l_k, g_k = value_and_grad(make_loss_fn(model), params, check)
    l_x, g_x = value_and_grad(make_loss_fn(build_model(cfg, attn_impl="xla")),
                              params, check)
    l_k, l_x = l_k.item(), l_x.item()
    if not abs(l_k - l_x) <= TRAIN_LOSS_RTOL * abs(l_x):
        fail(f"kernel step loss {l_k} vs xla {l_x}")
    g_x = dict(_state_leaves(g_x))
    rel = {n: _rel_l2(g, g_x[n]) for n, g in _state_leaves(g_k)}
    worst = max(rel, key=rel.get)
    if rel[worst] > TRAIN_GRAD_REL_L2:
        fail(f"kernel step gradient {worst} is {rel[worst]:.3e} relative L2 "
             f"off attn_impl='xla'")
    print(f"  kernels vs attn_impl='xla' at {TRAIN_BATCH} x "
          f"{TRAIN_CHECK_LEN}: loss {l_k:.5f} vs {l_x:.5f}, worst gradient "
          f"relative L2 {rel[worst]:.3e} ({worst})")
    stats["vs_xla"] = dict(loss=l_k, loss_xla=l_x, worst_leaf=worst,
                           worst_rel_l2=rel[worst])
    del params, g_k, g_x, model
    gc.collect()
    torch.cuda.empty_cache()
    stats["sharded"] = train_sharded_one_rank()
    return stats


def profiled_kernels(fn):
    """The CUDA kernels ``torch.profiler`` records in one call of ``fn``,
    summed by name (``key_averages``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_profile(fn, what: str):
    """Where ``fn``'s time goes on the card: its wall time without the
    profiler, then the kernels ``torch.profiler`` records in a second
    call -- their summed device time, its share of that wall time (one
    stream, so kernels do not overlap), and the largest kernels."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    kernels = profiled_kernels(fn)
    dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
    if dev_s == 0:
        print(f"  {what}: wall {wall:.4f} s; the profiler saw no device "
              "time, busy share not measured")
        return dict(wall_s=wall, device_s=None, busy_share=None, top=[])
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    out = dict(wall_s=wall, device_s=dev_s, busy_share=dev_s / wall,
               launches=sum(e.count for e in kernels),
               top=[dict(kernel=e.key[:80], s=e.self_device_time_total / 1e6,
                         calls=e.count) for e in top])
    print(f"  {what}: wall {wall:.4f} s, kernels {dev_s:.4f} s on the card "
          f"({out['launches']} launches), busy share {dev_s / wall:.3f}")
    for k in out["top"]:
        print(f"    {k['s']:.4f} s  x{k['calls']}  {k['kernel']}")
    return out


def logit_agreement(got, want, what: str, rerouted=None) -> dict:
    """Two bfloat16 paths to the same logits: max |got - want| within
    LOGIT_ATOL_FRAC max|want| and the same argmax at LOGIT_MIN_ARGMAX of
    the positions, else fail.

    ``rerouted`` (MoE models; a bool per (batch, position)) marks the
    positions whose kept experts differ between the two runs in some
    layer: a near-tie in the router that the bfloat16 noise tipped the
    other way, after which the two runs compute another function of that
    token.  The max|diff| bound then holds on the other positions; the
    argmax bound holds on all, and the rerouted share and their max|diff|
    are reported."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite logits")
    diff = (got - want).abs()
    scale = want.abs().max().item()
    out = dict(max_abs=diff.max().item(), mean_abs=diff.mean().item(),
               max_ref=scale,
               argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float()
               .mean().item())
    held = out["max_abs"]
    line = (f"  {what}: max|diff| {out['max_abs']:.3e}, mean "
            f"{out['mean_abs']:.3e} (max|ref| {scale:.3f}); argmax agreement "
            f"{out['argmax_agreement']:.4f}")
    if rerouted is not None:
        pos_diff = diff.amax(-1)
        n = int(rerouted.sum())
        held = pos_diff[~rerouted].max().item() if n < rerouted.numel() else 0.0
        out.update(rerouted_positions=n,
                   rerouted_share=n / rerouted.numel(),
                   max_abs_routed_alike=held,
                   max_abs_rerouted=pos_diff[rerouted].max().item() if n else 0.0,
                   bound_held_on_all=out["max_abs"] <= LOGIT_ATOL_FRAC * scale)
        line += (f"; {n} of {rerouted.numel()} positions rerouted in some "
                 f"layer ({out['rerouted_share']:.4f}): max|diff| "
                 f"{out['max_abs_rerouted']:.3e} there, {held:.3e} on the "
                 f"others; max|diff| bound "
                 + ("held on all positions" if out["bound_held_on_all"]
                    else "held on the positions routed alike"))
    print(line)
    if held > LOGIT_ATOL_FRAC * scale or (
            out["argmax_agreement"] < LOGIT_MIN_ARGMAX):
        fail(f"{what}: beyond max|diff| <= {LOGIT_ATOL_FRAC} max|ref| or "
             f"argmax agreement >= {LOGIT_MIN_ARGMAX}")
    return out


class RoutingLog:
    """Every MoE block's routing while the log is open: for each call of
    ``moe._route``, which experts kept each token, as a (tokens, E) bool
    mask, and the count of (token, expert) assignments kept and made.
    It wraps the module's router; ``moe_apply`` computes as without it."""

    def __init__(self, n_experts: int):
        self.n_experts = n_experts
        self.masks = []
        self.kept = self.made = 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self._moe, route = moe, moe._route

        def logged(p, xt, cfg, capacity):
            out = route(p, xt, cfg, capacity)
            eidx, keep = out[1], out[4].view(out[1].shape)
            mask = torch.zeros(*eidx.shape[:-1], self.n_experts,
                               dtype=torch.bool, device=eidx.device)
            self.masks.append(mask.scatter_(-1, eidx, keep)
                              .reshape(-1, self.n_experts))
            self.kept = self.kept + keep.sum()
            self.made += keep.numel()
            return out

        self._route, moe._route = route, logged
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route

    def dropped_share(self) -> float:
        return 1.0 - float(self.kept) / self.made

    def by_position(self, n_layers: int, batch: int):
        """(layers, batch, positions, E): the logged calls taken as runs of
        ``n_layers`` consecutive blocks (one forward, prefill or decode
        step each), joined along the positions in call order."""
        import torch

        runs = [torch.stack(self.masks[i:i + n_layers])
                for i in range(0, len(self.masks), n_layers)]
        return torch.cat([r.view(n_layers, batch, -1, self.n_experts)
                          for r in runs], dim=2)


def rerouted(a, b):
    """Positions (batch, position) whose kept experts differ in some layer
    between two ``RoutingLog.by_position`` masks."""
    return (a != b).any(-1).any(0)


def serve_requests(chain, sizes=None):
    """Phase S's requests for ``chain``: 16 sizes drawn from seed 0 in
    SERVE_SIZES and one of SERVE_BIG (or ``sizes``), each request's rows
    of every host stream drawn from the same generator; returns the
    streams' (name, shape) pairs, sorted, and the requests."""
    import numpy as np

    rng = np.random.default_rng(0)
    if sizes is None:
        sizes = rng.integers(SERVE_SIZES[0], SERVE_SIZES[1] + 1,
                             SERVE_REQUESTS).tolist() + [SERVE_BIG]
    specs = sorted((f"{s.name}.{n}", tuple(node.shape))
                   for i, s in enumerate(chain.stages)
                   for n, node in chain.host_element_inputs(i))
    reqs = [{q: rng.uniform(-1, 1, (n,) + shape).astype(np.float32)
             for q, shape in specs} for n in sizes]
    return specs, reqs


def phase_serve(kernel_rows):
    """Phase S: the serving engine, tracing, metrics and the profile store
    on the named p = 11 chain (``compile_cfd_pipeline(11,
    backends="pallas")`` planned on h100-sxm, E = 50,419)."""
    import os
    import tempfile
    import warnings

    import numpy as np
    import torch

    from repro_torch import metrics, trace
    from repro_torch.cfd import operators, simulation
    from repro_torch.flow import build
    from repro_torch.memory import chain as mchain
    from repro_torch.memory.channels import H100_SXM
    from repro_torch.runtime.monitor import RequestLatency, StepMonitor
    from repro_torch.serve import PlanCache, ServeEngine

    p = SERVE_P
    src = operators.CFD_PIPELINE_SRC.format(p=p)
    kw = dict(name=f"cfd_pipeline_p{p}", stages=operators.CFD_PIPELINE_STAGES,
              backends=("pallas",) * 3)
    out = {}

    # -- the plan cache: a repeat compile never plans again ----------------
    tracer, reg = trace.Tracer(), metrics.MetricsRegistry()
    planned = []
    real_plan_chain = build.plan_chain

    def spy(*a, **k):
        planned.append(1)
        return real_plan_chain(*a, **k)

    cache = PlanCache(tracer=tracer, metrics=reg)
    build.plan_chain = spy
    try:
        t = time.perf_counter()
        system = cache.get_or_compile(src, **kw)
        compile_s = time.perf_counter() - t
        n_planned = len(planned)
        again = cache.get_or_compile(src, **kw)
    finally:
        build.plan_chain = real_plan_chain
    if again is not system or (cache.hits, cache.misses) != (1, 1) or (
            len(planned) != n_planned):
        fail(f"plan cache: hits {cache.hits} misses {cache.misses}, "
             f"plan_chain calls {n_planned} -> {len(planned)}")
    plan = system.plan
    E = plan.batch_elements
    if (plan.target.name, E) != ("h100-sxm", SERVE_E):
        fail(f"served plan {plan.target.name} E={E}; want h100-sxm "
             f"E={SERVE_E}")
    print(f"serve: plan cache hit on the repeat compile (compile "
          f"{compile_s:.1f} s, plan_chain called {n_planned}x), E={E}")

    # -- requests, made before the first submit ----------------------------
    specs, reqs = serve_requests(system.chain)
    sizes = [next(iter(r.values())).shape[0] for r in reqs]
    total = sum(sizes)

    # -- serve: coalesced waves through the ring ----------------------------
    lat = RequestLatency()
    slo = metrics.SLOTracker(5.0, 0.01, registry=reg)
    engine = ServeEngine(system, max_wait_s=SERVE_MAX_WAIT_S, tracer=tracer,
                         metrics=reg, slo=slo, latency=lat, seed=0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = tracer.clock()
    served = [engine.submit(r) for r in reqs]
    engine.drain()
    torch.cuda.synchronize()
    t1 = tracer.clock()
    launches = read_counts()
    failed = [r.rid for r in served if r.error is not None]
    if failed:
        fail(f"serve: requests {failed} failed: {served[failed[0]].error!r}")
    st = engine.stats
    waves = st["waves"]
    if launches != {"gemm_chain": 2 * waves, "helmholtz": waves,
                    "flash_attention": 0}:
        fail(f"serve: {waves} waves with launches {launches}")
    if st["pad_elements"] != waves * E - total:
        fail(f"serve: pad {st['pad_elements']} != {waves} x {E} - {total}")
    wall = t1 - t0
    disp = [s for s in tracer.spans if s.cat == "dispatch"]
    busy = sum(s.duration for s in disp if t0 <= s.t0 and s.t1 <= t1)
    if any("host_s" not in s.args for s in disp):
        fail("serve: a dispatch span carries no CUDA-event time")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    total_s = [r.completed_s - r.submitted_s for r in served]
    queue_s = [r.admitted_s - r.submitted_s for r in served]
    exec_s = [r.completed_s - r.admitted_s for r in served]
    out["serve"] = dict(
        requests=len(served), elements=total, waves=waves,
        pad_elements=st["pad_elements"], ticks=st["ticks"], wall_s=wall,
        elements_per_s=total / wall, busy_share=busy / wall,
        device_busy_s=busy,
        latency_s={"p50": pct(total_s, 50), "p99": pct(total_s, 99)},
        queue_s={"p50": pct(queue_s, 50), "p99": pct(queue_s, 99)},
        execute_s={"p50": pct(exec_s, 50), "p99": pct(exec_s, 99)},
        launches=launches, slo=slo.verdict()["verdict"])
    print(f"serve: {len(served)} requests ({total} elements) in {waves} waves "
          f"(pad {st['pad_elements']}) in {wall:.3f} s: {total / wall:.0f} "
          f"elements/s | latency p50 {pct(total_s, 50):.3f} s p99 "
          f"{pct(total_s, 99):.3f} s (queue p50 {pct(queue_s, 50):.3f} / p99 "
          f"{pct(queue_s, 99):.3f}, execute p50 {pct(exec_s, 50):.3f} / p99 "
          f"{pct(exec_s, 99):.3f}) | device busy {busy * 1e3:.1f} ms = "
          f"{100 * busy / wall:.2f} % of the window | launches {launches}")

    # each request alone through the same system: bit for bit
    serial = ServeEngine(system, seed=0)
    for r, inp in zip(served, reqs):
        one = serial.submit(inp)
        serial.drain()
        if one.error is not None:
            fail(f"serve: r{r.rid} alone failed: {one.error!r}")
        for q in engine.out_names:
            if not np.array_equal(r.outputs[q], one.outputs[q]):
                fail(f"serve: r{r.rid} output {q} differs from serving it "
                     "alone")
            if not np.isfinite(r.outputs[q]).all():
                fail(f"serve: r{r.rid} output {q} is not finite")
        r.outputs = None
    print(f"serve: every request's gy, gz and v bitwise equal to serving it "
          f"alone")

    # metrics: structure, the serving invariants, and the trace's counters
    snap = reg.snapshot()
    metrics.check_structure(snap)
    checked = metrics.check_snapshot(snap, trace.to_chrome(tracer))
    if "trace-reconciliation" not in checked:
        fail(f"metrics: checks run {checked}, want trace-reconciliation")
    print(f"metrics: {len(snap['metrics'])} series, checks {checked}")
    out["metrics"] = dict(series=len(snap["metrics"]), checks=checked)
    del served, serial, engine, cache

    # -- trace: run_chain over the served rows, CUDA-event stage times ------
    rows = {q: np.concatenate([r[q] for r in reqs])[:TRACE_BATCHES * E]
            for q, _ in specs}
    del reqs
    ttr = trace.Tracer()
    zero_counts()
    res = simulation.run_chain(system.chain, plan, inputs=rows,
                               max_batches=TRACE_BATCHES, tracer=ttr,
                               monitor=StepMonitor())
    torch.cuda.synchronize()
    trace_launches = read_counts()
    if res.batches != TRACE_BATCHES or trace_launches != {
            "gemm_chain": 2 * TRACE_BATCHES, "helmholtz": TRACE_BATCHES,
            "flash_attention": 0}:
        fail(f"trace: {res.batches} batches, launches {trace_launches}")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/run_chain.json"
        trace.write_chrome(ttr, path)
        env = {**os.environ, "PYTHONPATH": str(SRC)}
        chk = subprocess.run([sys.executable, "-m", "repro_torch.trace", path],
                             capture_output=True, text=True, env=env,
                             timeout=120)
        if chk.returncode != 0:
            fail(f"python -m repro_torch.trace: {chk.stdout}{chk.stderr}")
        ch = sum(ttr.totals("channel_bytes").values())
        if ch != TRACE_BATCHES * plan.host_stream_bytes:
            fail(f"trace: channel bytes {ch} != {TRACE_BATCHES} x "
                 f"{plan.host_stream_bytes}")
        stable = trace.attribution_report(ttr, plan, stable_only=True)
        # the same plan on the host: its stages run on torch.einsum (the
        # kernels' plain versions would take minutes at this size), which
        # changes no span of the stable section
        cpu_chain = operators.build_cfd_chain(p, device="cpu")
        cpu_tr = trace.Tracer()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            simulation.run_chain(cpu_chain, plan, inputs=rows,
                                 max_batches=TRACE_BATCHES, tracer=cpu_tr,
                                 device="cpu")
        cpu_stable = trace.attribution_report(cpu_tr, plan, stable_only=True)
        if stable != cpu_stable:
            fail(f"trace: stable attribution differs from the CPU's:\n"
                 f"{stable}\n--- cpu ---\n{cpu_stable}")
        a = trace.attribute(ttr, plan)
        kernel_ms = {"interp": kernel_rows["gemm_chain"][0]["ms"],
                     "grad": kernel_rows["gemm_chain"][1]["ms"],
                     "helmholtz": kernel_rows["helmholtz"][0]["ms"]}
        stages = {}
        for s in a.stages:
            traced = s.measured_s_per_batch * 1e3
            host = [sp.args["host_s"] for sp in ttr.spans
                    if sp.cat == "dispatch" and sp.args["stage"] == s.index]
            stages[s.name] = dict(traced_ms=traced, kernel_ms=kernel_ms[s.name],
                                  ratio=traced / kernel_ms[s.name],
                                  host_ms=1e3 * sum(host) / len(host))
        print(f"trace: {res.batches} batches, schema ok, channel bytes = "
              f"{TRACE_BATCHES} x host_stream_bytes, stable attribution = "
              f"the CPU's | per-stage device ms/batch (CUDA events) vs phase "
              "2's kernel: " + ", ".join(
                  f"{k} {v['traced_ms']:.3f} vs {v['kernel_ms']:.3f} "
                  f"(x{v['ratio']:.3f}; host {v['host_ms']:.3f} ms to launch)"
                  for k, v in stages.items()))
        print(trace.attribution_report(ttr, plan))
        out["trace"] = dict(batches=res.batches, wall_s=res.wall_s,
                            stages=stages, launches=trace_launches,
                            stragglers=list(res.straggler_batches))

        # -- profile: tuner winners and the traced stages into a store -----
        store = trace.ProfileStore(path=f"{tmp}/profile.json")
        fp = trace.machine_fingerprint()
        if store.fingerprint != fp or fp == trace.machine_fingerprint("cpu"):
            fail(f"profile: store fingerprint {store.fingerprint}, card's {fp}")
        tuned = operators.compile_cfd_pipeline(p, backends="pallas",
                                               tune_blocks=True, profile=store)
        n_stage = store.record_trace(ttr, plan)
        doc = json.loads(pathlib.Path(store.path).read_text())
        keys = list(doc["entries"])
        samples = [s for v in doc["entries"].values() for s in v]
        tune = [s for s in samples if s.get("scope") == "tune"]
        if not keys or any(not k.startswith(f"{fp}/h100-sxm/") for k in keys):
            fail(f"profile: keys {keys} do not carry the card's fingerprint")
        if len(tune) != len(tuned.tuning or {}) or not tune:
            fail(f"profile: {len(tune)} tune samples for "
                 f"{len(tuned.tuning or {})} tuned stages")
        fitted = mchain.plan_chain(system.chain, target=H100_SXM,
                                   profile=store)
        if not fitted.cost.contention_fit:
            fail("profile: plan_chain(profile=store) fitted no contention")
        print(f"profile: {len(tune)} tune + {n_stage} traced samples under "
              f"fingerprint {fp}; contention fitted "
              f"{list(fitted.cost.contention_fit)}")
        out["profile"] = dict(fingerprint=fp, tune_samples=len(tune),
                              trace_samples=n_stage,
                              contention_fit=list(fitted.cost.contention_fit))
    launches = {k: launches[k] + trace_launches[k] for k in launches}
    torch.cuda.empty_cache()
    return out, launches


def _stage_ms(tracer, n_batches):
    """Per-stage device ms a batch of a traced chain run: its dispatch
    spans, and its cross-group reshard (handoff) spans."""
    out = {}
    for sp in tracer.spans:
        if sp.cat in ("dispatch", "handoff"):
            for what, secs in ((sp.cat, sp.duration),
                               ("host", sp.args.get("host_s", 0.0))):
                key = (what, sp.args["stage"])
                out[key] = out.get(key, 0.0) + secs * 1e3 / n_batches
    return out


def phase_placement(fig2_checksum, slice_batch_s, *, p=PLACE_P, e=None,
                    dev=None):
    """Phase M: element-axis placement and CU replication over the device
    pool [dev, dev] (two slots on one card), the named chain at ``p``.

    The chain is planned on h100-sxm for ``DeviceTopology.homogeneous(2)``
    with cu_count (1, 2, 1) (E the planner's, snapped to shard evenly;
    ``e`` overrides it), run over 4 batches with its outputs collected,
    bitwise against the serial one-slot run at that E, each kernel
    launched once a shard; both runs are traced again for the device time
    of each stage and handoff.  Then the reference's two-kind case
    (h100:1,alveo:1, stage groups (0, 1, 1), E_s (E/2, E, E)), Fig. 2 with
    two CUs (the checksum within rel 1e-4 of phase F's one-slot run),
    ``measure_chain_plan`` on the placed plan, phase S's requests served
    on the pool (each bitwise its one-slot answer), and with two cards the
    chain over [cuda:0, cuda:1]."""
    import numpy as np
    import torch

    from repro_torch import trace
    from repro_torch.cfd import operators, simulation
    from repro_torch.memory import chain as mchain
    from repro_torch.memory import dse
    from repro_torch.memory.channels import H100_SXM
    from repro_torch.memory.placement import DeviceTopology
    from repro_torch.serve import ServeEngine

    dev = dev if dev is not None else torch.device("cuda", 0)
    card = dev.type == "cuda"
    pool = [dev, dev]

    def sync():
        if card:
            torch.cuda.synchronize()

    out = {"pool": [str(d) for d in pool]}
    system = operators.compile_cfd_pipeline(
        p, backends="pallas", target="h100-sxm", device=dev,
        cu_count=PLACE_CUS, devices=DeviceTopology.homogeneous(2),
        **({} if e is None else {"batch_elements": e}))
    chain, plan = system.chain, system.plan
    E = plan.batch_elements
    groups = plan.placement.device_groups
    shards = [len(g) for g in groups]
    if E % 2 or groups != ((0,), (1, 0), (1,)):
        fail(f"placed plan: E={E} groups {groups}; want an even E and "
             "groups ((0,), (1, 0), (1,))")
    n = PLACE_BATCHES
    inputs = {
        q: np.concatenate([b[q] for b in simulation._chain_batch_inputs(
            chain, E, n, 0, None)])
        for q in ("interp.u", "helmholtz.D")
    }
    base_plan = mchain.plan_chain(chain, target=H100_SXM, batch_elements=E,
                                  n_eq=n * E, prefetch_depth=0)

    # -- the chain over [dev, dev], bitwise the serial one-slot run -------
    t = time.perf_counter()
    base = simulation.run_chain(chain, base_plan, inputs=inputs,
                                collect_outputs=True, devices=[dev],
                                pipeline_stages=False)
    sync()
    one_s = time.perf_counter() - t
    sync()
    zero_counts()
    t = time.perf_counter()
    res = simulation.run_chain(chain, plan, inputs=inputs,
                               collect_outputs=True, devices=pool)
    sync()
    two_s = time.perf_counter() - t
    launches = read_counts()
    want = {"gemm_chain": n * (shards[0] + shards[1]),
            "helmholtz": n * shards[2], "flash_attention": 0}
    if card and launches != want:
        fail(f"placed chain: launches {launches}; want batches x shards "
             f"{want}")
    if res.placement_groups != groups or res.devices != tuple(
            str(d) for d in pool) or res.batches != n:
        fail(f"placed chain ran groups {res.placement_groups} on "
             f"{res.devices}, {res.batches} batches")
    for q, v in base.outputs.items():
        if not np.array_equal(res.outputs[q], v):
            fail(f"placed chain: {q} differs from the one-slot run")
        if not np.isfinite(v).all():
            fail(f"placed chain: {q} is not finite")
    del res
    print(f"placement: chain p={p} E={E} on {out['pool']} groups "
          f"{list(groups)} (cu {list(PLACE_CUS)}): {n} batches bitwise the "
          f"serial one-slot run | launches {launches} = batches x shards "
          f"{shards} | wall/batch (rows given, outputs collected) "
          f"{two_s / n:.3f} s vs one slot serial {one_s / n:.3f} s vs phase "
          f"3's {slice_batch_s:.3f} s (synthesis included)")
    out["chain"] = dict(E=E, groups=[list(g) for g in groups],
                        launches=launches, wall_per_batch_s=two_s / n,
                        one_slot_serial_wall_per_batch_s=one_s / n,
                        slice_wall_per_batch_s=slice_batch_s)
    total = dict(launches)

    # -- where a batch's device time goes: stages and handoffs, traced ----
    one_plan = mchain.plan_chain(chain, target=H100_SXM, batch_elements=E,
                                 n_eq=n * E)
    timed = {}
    for name, pl, pl_pool in (("one slot", one_plan, [dev]),
                              ("two slots", plan, pool)):
        tr = trace.Tracer()
        r = simulation.run_chain(chain, pl, inputs=inputs, devices=pl_pool,
                                 tracer=tr)
        sync()
        trace.assert_valid(tr)
        ms = _stage_ms(tr, n)
        timed[name] = dict(
            wall_per_batch_s=r.wall_s / n,
            stage_ms={chain.stages[i].name: ms.get(("dispatch", i), 0.0)
                      for i in range(3)},
            handoff_ms={chain.stages[i].name: ms.get(("handoff", i), 0.0)
                        for i in range(3)},
            host_ms={chain.stages[i].name: ms.get(("host", i), 0.0)
                     for i in range(3)})
        if name == "one slot":
            want_sums = r.checksums
        else:
            for q, v in want_sums.items():
                if abs(r.checksums[q] - v) > CHAIN_CHECKSUM_RTOL * abs(v):
                    fail(f"placed chain: checksum {q} {r.checksums[q]!r} vs "
                         f"one slot {v!r}")
    two = timed["two slots"]
    busy = sum(two["stage_ms"].values()) + sum(two["handoff_ms"].values())
    hand = sum(two["handoff_ms"].values())
    out["traced"] = dict(timed, handoff_share=hand / busy if busy else 0.0)
    for name, v in timed.items():
        print(f"  traced {name}: wall/batch {v['wall_per_batch_s']:.3f} s | "
              "device ms/batch " + ", ".join(
                  f"{k} {v['stage_ms'][k]:.3f}" + (
                      f" (+ reshard {v['handoff_ms'][k]:.3f})"
                      if v["handoff_ms"][k] else "")
                  for k in v["stage_ms"]) + " | host ms/batch to launch "
              + ", ".join(f"{k} {x:.3f}" for k, x in v["host_ms"].items()))
    print(f"  handoffs: {hand:.3f} ms of {busy:.3f} ms device time a batch "
          f"({100 * out['traced']['handoff_share']:.1f} %); checksums within "
          f"rel {CHAIN_CHECKSUM_RTOL} of one slot")

    # -- the reference's two-kind case -------------------------------------
    hplan = mchain.plan_chain(
        chain, target=H100_SXM, batch_elements=E, n_eq=2 * E,
        prefetch_depth=(2, 1, 1), cu_count=1,
        topology=DeviceTopology.parse("h100:1,alveo:1"),
        stage_groups=(0, 1, 1), stage_batch_elements=(E // 2, E, E))
    kinds = [hplan.placement.stage_kind(i) for i in range(3)]
    if not hplan.feasible or kinds != ["h100-sxm", "alveo-u280",
                                       "alveo-u280"]:
        fail(f"two-kind plan: feasible {hplan.feasible}, kinds {kinds}")
    zero_counts()
    h = simulation.run_chain(chain, hplan, inputs=inputs, max_batches=2,
                             collect_outputs=True, devices=pool)
    sync()
    h_launches = read_counts()
    if card and h_launches != {"gemm_chain": 2 * 3, "helmholtz": 2,
                               "flash_attention": 0}:
        fail(f"two-kind chain: launches {h_launches}")
    if h.placement_groups != ((0,), (1,), (1,)):
        fail(f"two-kind chain ran groups {h.placement_groups}")
    for q, v in base.outputs.items():
        if not np.array_equal(h.outputs[q], v[:2 * E]):
            fail(f"two-kind chain: {q} differs from the one-slot run")
    print(f"  two kinds {kinds}, E_s {list(hplan.stage_batch_elements)}: "
          f"groups {list(h.placement_groups)}, 2 batches bitwise the "
          f"one-slot run | launches {h_launches}")
    out["two_kind"] = dict(kinds=kinds, stage_e=list(hplan.stage_batch_elements),
                           groups=[list(g) for g in h.placement_groups],
                           launches=h_launches)
    for k in total:
        total[k] += h_launches[k]
    del h

    # -- several cards -------------------------------------------------------
    if card and torch.cuda.device_count() >= 2:
        cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
        x = simulation.run_chain(chain, plan, inputs=inputs,
                                 collect_outputs=True, devices=cards)
        for q, v in base.outputs.items():
            if not np.array_equal(x.outputs[q], v):
                fail(f"cross-card chain: {q} differs from the one-slot run")
        print(f"phase M: cross-card run over {[str(c) for c in cards]}: "
              f"groups {list(x.placement_groups)}, bitwise the one-slot run, "
              f"{x.wall_s / x.batches:.3f} s a batch")
        out["cross_card"] = dict(wall_per_batch_s=x.wall_s / x.batches)
        del x
    else:
        print("phase M: cross-card run not done (1 card)")
        out["cross_card"] = None
    del base, inputs

    # -- Fig. 2 with two CUs -------------------------------------------------
    cfg = simulation.SimConfig(p=p, backend="pallas", seed=0,
                               **({} if e is None else {"batch_elements": e}))
    zero_counts()
    f = simulation.run_simulation(cfg, devices=pool, max_batches=FIG2_BATCHES)
    sync()
    f_launches = read_counts()
    rel = abs(f.checksum - fig2_checksum) / abs(fig2_checksum)
    if card and f_launches != {"helmholtz": 2 * FIG2_BATCHES,
                               "gemm_chain": 0, "flash_attention": 0}:
        fail(f"Fig. 2 over two slots: launches {f_launches}")
    if f.plan.cu_count != 2 or rel > FIG2_CHECKSUM_RTOL:
        fail(f"Fig. 2 over two slots: cu {f.plan.cu_count}, checksum "
             f"{f.checksum!r} vs one slot {fig2_checksum!r} (rel {rel:.2e})")
    print(f"  fig2 with 2 CUs: E={f.plan.batch_elements}, {f.batches} batches "
          f"in {f.wall_s:.3f} s | launches {f_launches} | checksum "
          f"{f.checksum!r} (rel {rel:.2e} to one slot)")
    out["fig2"] = dict(E=f.plan.batch_elements, wall_s=f.wall_s,
                       checksum=f.checksum, rel=rel, launches=f_launches)
    for k in total:
        total[k] += f_launches[k]

    # -- the DSE measures the placed plan --------------------------------------
    secs = dse.measure_chain_plan(chain, plan, max_batches=1, devices=pool)
    if secs is None or not secs > 0:
        fail(f"measure_chain_plan on the placed plan gave {secs}")
    print(f"  measure_chain_plan on the placed plan: {secs * 1e6:.3f} "
          "us/element")
    out["dse_us_per_element"] = secs * 1e6

    # -- phase S's requests on the pool ----------------------------------------
    served_sys = operators.compile_cfd_pipeline(
        p, backends="pallas", target="h100-sxm", device=dev, batch_elements=E)
    specs, reqs = serve_requests(
        served_sys.chain, sizes=None if e is None else [3, E, 2 * E + 1, 5])
    engine = ServeEngine(served_sys, seed=0, devices=pool,
                         max_wait_s=SERVE_MAX_WAIT_S)
    sync()
    zero_counts()
    t = time.perf_counter()
    served = [engine.submit(r) for r in reqs]
    engine.drain()
    sync()
    serve_s = time.perf_counter() - t
    s_launches = read_counts()
    waves = engine.stats["waves"]
    if card and s_launches != {"gemm_chain": 2 * 2 * waves,
                               "helmholtz": 2 * waves, "flash_attention": 0}:
        fail(f"serve over two slots: {waves} waves, launches {s_launches}")
    alone = ServeEngine(served_sys, seed=0, devices=[dev])
    for r, inp in zip(served, reqs):
        if r.error is not None:
            fail(f"serve over two slots: r{r.rid} failed: {r.error!r}")
        one = alone.submit(inp)
        alone.drain()
        for q in engine.out_names:
            if not np.array_equal(r.outputs[q], one.outputs[q]):
                fail(f"serve over two slots: r{r.rid} {q} differs from its "
                     "one-slot answer")
        r.outputs = None
    elems = sum(next(iter(r.values())).shape[0] for r in reqs)
    print(f"  serve: {len(reqs)} requests ({elems} elements) in {waves} waves "
          f"over {out['pool']} in {serve_s:.3f} s ({elems / serve_s:.0f} "
          f"elements/s), each bitwise its one-slot answer | launches "
          f"{s_launches}")
    out["serve"] = dict(requests=len(reqs), elements=elems, waves=waves,
                        wall_s=serve_s, elements_per_s=elems / serve_s,
                        launches=s_launches)
    for k in total:
        total[k] += s_launches[k]
    del engine, alone, served, reqs
    if card:
        torch.cuda.empty_cache()
    return out, total


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; the chip smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        card = phase_setup()
        from repro_torch.cfd import operators

        natural = operators.compile_cfd_pipeline(11, backends="pallas")
        system = operators.compile_cfd_pipeline(11, backends="pallas",
                                                batch_elements=SLICE_E)
        if system.target.name != "h100-sxm":
            fail(f"planned for {system.target.name}, want h100-sxm")
        blocks = [sp.block_elements for sp in system.plan.stages]
        if blocks != [3, 3, 3]:
            fail(f"plan blocks {blocks}; want each kernel's tile, 3")
        print(f"plan: E={system.plan.batch_elements} (the planner's own "
              f"{natural.plan.batch_elements})  blocks {blocks}  "
              f"host stream {system.plan.host_stream_bytes / 2**20:.1f} "
              "MiB/batch")
        rows = phase_kernels(system)
        slice_res, launches = phase_slice(system)
        t_new = time.perf_counter()
        fig2_row, fig2, fig2_launches, fig2_inputs = phase_fig2()
        rows["helmholtz"].append(fig2_row)
        launches["helmholtz"] += fig2_launches["helmholtz"]
        fixed = phase_fixed(fig2_inputs)
        del fig2_inputs
        dse_stats = phase_dse()
        new_s = time.perf_counter() - t_new
        print(f"phases F, Q and D: {new_s:.1f} s")
        t_x = time.perf_counter()
        fused_rows, fusion, fused_launches = phase_fusion()
        for name in ("gemm_chain", "helmholtz"):
            launches[name] += fused_launches[name]
        fusion_s = time.perf_counter() - t_x
        print(f"phase X: {fusion_s:.1f} s")
        t_b = time.perf_counter()
        blocks_stats, block_launches = phase_blocks()
        for name in ("gemm_chain", "helmholtz"):
            launches[name] += block_launches[name]
        blocks_s = time.perf_counter() - t_b
        print(f"phase B: {blocks_s:.1f} s")
        t_s = time.perf_counter()
        serve_stats, serve_launches = phase_serve(rows)
        for name in ("gemm_chain", "helmholtz"):
            launches[name] += serve_launches[name]
        serve_stats["seconds"] = time.perf_counter() - t_s
        print(f"phase S: {serve_stats['seconds']:.1f} s")
        t_m = time.perf_counter()
        place_stats, place_launches = phase_placement(
            fig2["checksum"], slice_res.wall_s / slice_res.batches)
        for name in ("gemm_chain", "helmholtz"):
            launches[name] += place_launches[name]
        place_stats["seconds"] = time.perf_counter() - t_m
        print(f"phase M: {place_stats['seconds']:.1f} s")
        t_f = time.perf_counter()
        flash_rows = phase_flash()
        bwd_rows = phase_flash_bwd()
        print(f"phase 4: {time.perf_counter() - t_f:.1f} s")
        t_5 = time.perf_counter()
        model = phase_model()
        print(f"phase 5: {time.perf_counter() - t_5:.1f} s")
        t_e = time.perf_counter()
        experts = phase_experts()
        experts["seconds"] = time.perf_counter() - t_e
        print(f"phase E: {experts['seconds']:.1f} s")
        t_r = time.perf_counter()
        xlstm = phase_xlstm()
        xlstm["seconds"] = time.perf_counter() - t_r
        print(f"phase R: {xlstm['seconds']:.1f} s")
        t_j = time.perf_counter()
        jamba = phase_jamba()
        jamba["seconds"] = time.perf_counter() - t_j
        print(f"phase J: {jamba['seconds']:.1f} s")
        t_w = time.perf_counter()
        whisper = phase_whisper()
        whisper["seconds"] = time.perf_counter() - t_w
        print(f"phase W: {whisper['seconds']:.1f} s")
        t_t = time.perf_counter()
        train = phase_train()
        train["seconds"] = time.perf_counter() - t_t
        print(f"phase T: {train['seconds']:.1f} s")
        t_y = time.perf_counter()
        dry = phase_dryrun(card)
        dry["seconds"] = time.perf_counter() - t_y
        print(f"phase Y: {dry['seconds']:.1f} s")
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1

    sources = {
        "helmholtz": ("src/repro_torch/csrc/helmholtz.cu",
                      "src/repro/kernels/helmholtz/helmholtz.py:92"),
        "gemm_chain": ("src/repro_torch/csrc/gemm_chain.cu",
                       "src/repro/kernels/gemm/gemm.py:204"),
    }
    kernels = []
    probes = rows.pop("probes")
    for name, shapes in rows.items():
        # one main-path batch: the kernel's calls at each of its shapes
        b_ms = sum(r["bound_ms"] for r in shapes)
        libs = [r["library_ms"] for r in shapes]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": b_ms,
            "bound_by": max(shapes, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(libs) if all(x is not None for x in libs) else None,
            "shapes": shapes,
            **({"probes_ms": probes, "fused_shapes": fused_rows}
               if name == "gemm_chain" else {}),
            "tiles": {k: v for k, v in blocks_stats["tiles"].items()
                      if k.startswith(name) or (
                          name == "gemm_chain" and k in ("interp", "grad"))},
        })
    main_case = flash_rows[0]  # the shape the model path gives the kernel
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": FLASH_SOURCES[main_case["route"]],
        "replaces": "src/repro/kernels/attention/attention.py:88",
        "launches": (model["launches"]["flash_attention"]
                     + experts["flash_launches"] + jamba["flash_launches"]
                     + whisper["flash_launches"]
                     + train["launches"]["flash_attention"]
                     + train["sharded"]["launches"]["forward"]
                     + dry["card_check_auto"]["launches"]["forward"]),
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "shapes": flash_rows,
    })
    train_case = bwd_rows[0]  # the shape phase T's training gives it
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": FLASH_BWD_SOURCES[train_case["bwd_route"]],
        "replaces": FLASH_BWD_REPLACES,
        "launches": (train["launches"]["flash_attention_bwd"]
                     + train["sharded"]["launches"]["backward"]
                     + dry["card_check_auto"]["launches"]["backward"]),
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        **{k: train_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
        "shapes": bwd_rows,
    })
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"fig2": fig2, "fixed_point": fixed, "dse": dse_stats,
                      "new_phases_s": new_s, "fusion": fusion,
                      "fusion_s": fusion_s, "blocks": blocks_stats,
                      "blocks_s": blocks_s}))
    print(json.dumps({"model": model}))
    print(json.dumps({"experts": experts}))
    print(json.dumps({"xlstm": xlstm}))
    print(json.dumps({"jamba": jamba}))
    print(json.dumps({"whisper": whisper}))
    print(json.dumps({"train": train}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"serve": serve_stats}))
    print(json.dumps({"placement": place_stats}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
