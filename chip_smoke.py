"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from src/repro_torch/csrc, holds each kernel
against its plain PyTorch version on the card at the full-width SmolLM2-135M
and whisper-small shapes of the serving paths (float32 and bfloat16; ragged
attention also at the d_head-128 configs' heads) and times both, then
serves full-width SmolLM2-135M (random weights from a seed) through each of
the engine's three step families (flat, dense chunked, monolithic), every
step a replay of a CUDA graph captured at warmup, SmolLM2-135M and
whisper-small through the static batch loop, Qwen3-8B at full width
and depth, three other dense configs and InternVL2's language model,
RWKV-6 1.6B whole through the recurrent path, Qwen3-MoE and Arctic at
full width, cut in depth, through the expert-batched mmt4d, and
jamba-v0.1-52B at full width, cut in whole periods, through the
selective_scan kernel; trains them; and runs the distributed path on a
mesh of one card (the dry-run of every cell, an Engine on a one-rank
NCCL mesh, moe's per-shard dispatch):

  1. the card (nvidia-smi name and power limit); TF32 off;
  2. the kernel build and its seconds;
  3. per kernel: max abs error against the plain version, with its
     tolerance (exceeding it raises); mmt4d also at every width of the bf16
     flat ladder (the gate linear), and twice, bit-identical; mmt4d's
     unpacked store at the Q, K/V and tied-head exits, bit-identical to the
     packed store followed by the unpack kernel, timed beside that pair, the
     packed store alone and torch.matmul; unpack beside an empty kernel
     launched the same way (the launch floor).  mmt4d, the
     tied-head pack and ragged_attn are timed L2-cold: each timed call of
     the kernel, the plain version and the library call takes the next of
     enough operand copies to pass 64 MB (the card's L2 holds 50 MB; the
     drain streams 30 layers of weights and KV pools through it every
     step).  ragged_attn (decode rows, one long decode row, mixed prefill)
     runs from a host-built plan (its split in the kernels line), also
     L2-warm, with padding zero, repeats bit-identical, no synchronising
     copy, a refused call without a plan, and beside the SDPA yardstick
     (one scaled_dot_product_attention on K/V gathered per row); whisper's
     biased gelu up-projection at decode and over its encoder frames
     (beside torch._addmm_activation, itself held to the plain version), its
     tied head (vocab 51865, a partial last tile), its per-call weight
     packs and its encoder output's unpack; ragged_attn also at d_head 128,
     both dtypes: Qwen3-8B's decode rows (32 query heads over 8) and a
     mixed prefill at W = 512, ChatGLM3-6B's decode rows (32 over 2: tiles
     of 8 positions);
  4. the moe family: the expert-batched mmt4d (B_pack [E, N_o, K_o, n_r,
     k_r], the expert dim in the kernel's grid) against its plain version
     at qwen3-moe's and arctic's flat-step expert products (gate with
     silu and down, bf16; qwen3-moe's gate also f32, within
     EXPERT_F32_TOL), timed L2-cold beside its bound (every expert's
     weights) and torch.bmm; each config at its published widths in f32,
     card = CPU (qwen3-moe 1 layer, arctic 1: its layer's f32 experts
     are 53.5 GB): routing equal on a forward (or parted only below a
     top-k margin of F32_MARGIN), then the flat and monolithic drains
     token for token, first-call logits within F32_MARGIN, equal dropped
     fractions, replay = eager; then in bf16 cut to the depth whose
     reckoned peak fits the card (printed), weights drawn on the card and
     packed in place: the §4 flat drain (launches per model call checked,
     3 expert-batched mmt4d a layer, replay = eager) and a second drain
     capturing nothing (its requests' tokens repeat where nothing is
     dropped; parted requests counted); printed: ms per step and
     tokens/s beside the weight-bytes bound, peak memory, warmup, the
     drains' dropped fractions and the phase's seconds;
  5. jamba: selective_scan (csrc/selective_scan.cu) against its plain
     version at jamba's widths (di 8192, N 16; x, z, B and C as strided
     views of the projections' outputs), f32 and bf16: decode rows (4
     rows, 1 token, from a nonzero state), a 512-token prefill from zero
     and a 2-row 256-token prefill from a cached state, y and the state
     (written in place) within SCAN_RTOL / SCAN_ATOL (bf16 y: TOL[BF]),
     the f32 state bit for bit, a repeat bit-identical, timed L2-cold
     beside its bound, the plain version (no library call) and the bf16
     cases' times before the redesign (EARLIER_MS); jamba-v0.1-52B at its published widths
     (d 4096, vocab 65536, 16 experts top-2 of d_ff 14336 on every second
     layer) in bf16, cut to the whole 8-layer periods whose reckoned peak
     fits the card (printed), weights drawn on the card and packed in
     place, through the monolithic engine: the §4 requests, each prompt
     length capturing its exact-length prefill graph, replay = eager at
     two step shapes, the launches of every model call checked (7
     selective_scan a period), then a second drain capturing nothing;
     printed: ms per step and tokens/s beside the weight-bytes bound, peak
     memory, warmup, the dropped fractions and the phase's seconds; its
     first period with its moe layers in f32, card = CPU (routing, the
     monolithic drain token for token, first logits within F32_MARGIN,
     dropped fractions);
  6. the dense configs and the vlm family at their published widths:
     Qwen3-8B at full depth (36 layers, 8.19 B parameters, weights drawn
     on the card) through the bf16 flat drain of phase 9's shape (8
     requests, prompts 64-512, 32 new), its launches per model call
     checked, then a second drain capturing nothing with the same tokens;
     printed: ms per step and tokens/s beside the weight-bytes bound,
     launches per step, peak memory, init, prepack and warmup seconds;
     Qwen2-7B (QKV bias, 28 over 4 heads: g = 7), ChatGLM3-6B (partial 2d
     RoPE, g = 16) and OLMo-1B (non-parametric LayerNorm, MHA, tied head),
     each cut to 1 layer: the f32 flat drain card = CPU token for token
     (first-call logits within F32_MARGIN), and a bf16 drain whose picks
     agree with the f32 drain's wherever the top-2 margin is at least
     BF16_MARGIN; InternVL2-26B's language model behind its stub vision
     prefix through generate_static ((256 patches + 256 prompt tokens),
     32 new): f32 at 1 layer, batch 2, card = CPU, bf16 at 8 of its 48
     layers, batch 4, each with static_run's checks (the vision prefix counted once
     per batch), prefill and decode ms;
  7. the recurrent mixers: wkv6 (csrc/wkv6.cu) against its plain version at
     RWKV-6's heads (32 of 64), f32, decode rows (4 rows, 1 token), a
     512-token prefill and a 2-row 256-token prefill from a cached state,
     y and the final state within WKV6_TOL, timed L2-cold beside its
     bound, the plain token loop (no library call) and the headline
     cases' times before the chunked redesign (EARLIER_MS);
     RWKV-6 1.6B at its published widths and depth (24 layers, d 2048,
     vocab 65536, weights drawn on the card) in bf16 through the
     monolithic engine (4 slots, seq_len 1024): the §4 requests, each
     distinct prompt length capturing its exact-length prefill graph, the
     launches of every model call checked (193 mmt4d, 242 pack, 49 unpack,
     24 wkv6), then a second drain capturing nothing with the same
     tokens; printed: ms per step and tokens/s beside the bound, captures,
     warmup seconds and peak memory; RWKV-6 cut to PARITY_LAYERS layers in
     f32, card = CPU token for token (first-call logits within
     F32_MARGIN, as every family) and generate_static = generate on the card;
  8. float32 end to end, each family: a greedy drain of 4 requests on the
     card (after warmup; no graph captured during the drain) and on the CPU
     (plain versions), same weights and prompts: identical tokens, in every
     family alike (the top-2 margins at a first difference are printed);
  9. bfloat16 end to end, each family: Engine(max_slots=4, page_tokens=16,
     flat and dense chunk_tokens=128), seq_len 1024; warmup (its graphs, its
     seconds and the device memory it keeps), then 8 requests (prompts
     64-512 tokens, 32 new each) with the kernel launch counts set to 0
     just before the drain and read just after, checked per model call
     (and mmt4d's unpacked stores: the 91 linear exits of each call);
     no graph captured during the drain;
     in phases 8 and 9 the replay of two step shapes of each drain is held
     bit for bit to the model's eager step on the same inputs and state;
 10. sampled picks: phase 8's drains sampled (seed 11, per-request
     temperatures), card vs CPU in each family, equal apart from picks
     whose perturbed top-2 margin is below F32_MARGIN (counted); then a
     sampled bf16 drain of phase 9's requests on its warmed engines, the
     families held to each other under BF16_MARGIN;
 11. two warmed engines of one family over one model (each family): the
     second warmup leaves the model's trace_counts where they were, each
     engine counts its own captures, and the device memory of the second
     comes back once it is dropped;
 12. the static batch loop (Engine.generate_static) at full width, each
     model in float32 and bfloat16: SmolLM2-135M and whisper-small (12 +
     12 layers, d 768, vocab 51865, 256 encoder frames from a seeded
     torch.Generator), batch 4, one shared prompt of 256 tokens, 32 new,
     seq_len 1024; a first call captures the prefill and decode graphs,
     a second (the wrapper counts set to 0 just before and read just
     after) captures nothing and repeats its tokens, with the launches
     per model call (and whisper's encoder once per batch) checked, the
     bias + gelu epilogues and per-call weight packs among them; a third
     holds replay to the eager step bit for bit at both shapes; one eager
     step runs under set_sync_debug_mode("error"); printed: prefill ms,
     decode ms per step (device), tokens/s, whisper's encoder ms, launches
     per decode step by kernel; the picks held to the f32 CPU plain
     path's (f32 exactly, bf16 under BF16_MARGIN); for SmolLM2 also
     generate() of a flat engine equal to generate_static (f32), and the
     standalone DraftModelDrafter.propose equal to an attached drafter's
     over a reconcile sequence (f32, 2 layers);
 13. prefix cache and speculative decode at full width, f32 then bf16,
     each family: baseline, prefix_cache=True, and spec_tokens=2 with the
     n-gram drafter and with a draft model (SmolLM2-135M cut to 2 layers),
     each over the spec trace and (baseline and cache) the shared-prefix
     trace, greedy and sampled; picks held to the baseline's under the
     dtype's margin; prefill tokens with the cache at most half those
     without, the refcount ledger balanced after clear(), acceptance and
     rollback pages printed, no capture after warmup (the draft model's
     included), every kernel of the path launched in every drain, and
     tokens/s and ms per step of each drain;
 14. resilience under chaos at full width, f32 then bf16, for the flat,
     flat with n-gram speculation (k = 2) and the prefix cache, and dense
     chunked families, each on one warmed engine (queue_limit=6; in f32
     the runtime sanitizer checks every model call): five requests on a
     step clock drained clean, then under each fault plan of
     scripts/chaos_smoke.py (OOM spikes, a drafter burst, a NaN row, page
     copier failures), then a lifecycle drain (a cancel of a queued, a
     prefilling and a decoding request, a queue_limit shed, a deadline and
     a max_queue_s expiry) and a watchdog trip caught as StallError; every
     pick held to the clean drain's (f32 exactly, bf16 below BF16_MARGIN,
     parted picks counted), the allocator audit clean with every used page
     a cached one, no trace or capture after warmup, the pools never
     moved, every kernel of the path launched, and each drain's ms per
     step;
 15. serving observability, bfloat16, full width: in each family the §4
     drain of phase 9 on a warmed engine with telemetry=True beside the
     same drain on one without, over one model: identical tokens, no
     capture in either drain, the cost model (built at warmup) moving no
     trace_counts, every step record's sched + device + draft + host
     equal to its wall; printed: TTFT, ITL, queue-wait and e2e
     percentiles, the mean sched/device/draft/host ms per step, each step
     family's predicted against measured device seconds with its FLOPs
     and bytes, MFU, MBU, roofline fraction and padding waste; the flat
     engine's report pair (.html and .prom, linted) and Chrome trace
     written to a temporary directory, and the observer's cost over
     TEL_PAIRS alternating off/on drains; then, with telemetry on, the
     spec and shared-prefix traces on a flat engine with n-gram spec
     (k = 2) and the prefix cache (the draft span and the cache instants
     fire), and a chaos drain (OOM spike and NaN plans) whose fault
     instants land in the trace; every kernel of the path launched in
     every drain;
 16. vector lengths and layout policies, full width: the card's descriptor
     scaled twice and four times (h100_vl256, h100_vl512: tiles n_r = k_r =
     256 and 512 on the same card; bounds from the card's own rates), every
     serving kernel at those tiles against its plain version (mmt4d at gate
     decode, q/o, k/v, down and the tied head, packed and with the unpacked
     store; pack at stream entry, the tied head's embed and a prepacked
     W^T; the final stream's unpack; dgrad and wgrad at the gate and the
     tied head), f32 and bf16, timed; f32 flat drains card = CPU (the CPU
     on the mirrored TPU preset with the same tiles) under (scalable,
     h100_vl256), (scalable, h100_vl512), (fixed, h100_vl512) and
     (unpacked, h100); the bf16 §4 flat drain on one warmed engine per
     (policy, descriptor): h100, h100_vl256, h100_vl512, fixed and
     unpacked, drained four times in turns (forward, reversed, ...),
     printing ms per step, tokens/s, warmup seconds and programs and
     launches per step
     (unpacked: no mmt4d, pack or unpack), each layout's picks within
     BF16_MARGIN of the scalable h100 drain's; one f32 train step at
     h100_vl512, card = CPU; earlier, at the 128-wide tiles, the f32 mmt4d
     kernel (k staged in chunks of 64) is held bit for bit to its
     whole-tile staging;
 17. training: mmt4d's two gradient kernels (dgrad, wgrad) against their
     plain versions at the full-width training linears (4,096 tokens; the
     gate with its silu's gradient, the down projection, the tied head, the
     K projection), f32 and bf16, bit-identical on a repeat, timed L2-cold
     beside one torch.matmul of the same product and their bound (bf16:
     with the reduction's split per cluster and the achieved TFLOP/s and
     TB/s); one f32 step's loss
     and every gradient leaf, SmolLM2 at full width cut to 2 layers (seq
     128, batch 2), card vs CPU plain path; then bf16 at full depth, seq
     1024 (chunked_attention), batch 4, through Trainer on SyntheticLM, its
     compiled step capturing one CUDA graph on the first step and replaying
     it after (one capture, checked): 20 steps (every loss finite, the mean
     of the last 5 below the first 5's),
     5 with 8-bit AdamW and gradient compression, 5 with remat (its losses
     the first 5 steps' bit for bit), each printing ms per step, tokens/s,
     the first step's ms and the capture's seconds, peak memory and
     launches per step, checked per kernel; then replay = eager bit for
     bit (loss, grad_norm, every parameter and optimizer-state leaf) over 5
     steps in bf16 (plain, 8-bit + compression, remat, microbatch=2) and f32
     (2 layers, seq 128, batch 2), each first eager step under
     set_sync_debug_mode("error"); the launcher with --profile over the
     replays (the trace's port launches must equal the wrappers' counts);
     then a crash
     injected after a checkpoint and the resume, whose history and final
     parameters and optimizer state equal an uninterrupted run's bit for bit;
 18. the comparisons still waiting on the CPU plain path's runs (see
     below) are made, and the torch threads given back;
 19. training the recurrent and moe families: wkv6's backward
     (csrc/wkv6_bwd.cu) at RWKV-6's training shape (4, 1024, 32, 64) f32
     and selective_scan's (csrc/selective_scan_bwd.cu) at jamba's (4,
     1024, 8192), N 16, bf16 and f32, and each again at a ragged length
     (1000 tokens) from a nonzero final-state gradient (wkv6) or starting
     state (the scan), each from the forward kernel's
     checkpoints against the plain backward (which makes its own), every
     gradient within WKV6_BWD_TOL / SCAN_BWD_TOL of its largest |value|, a
     repeat bit-identical, timed L2-cold beside the bound and the plain
     version; mmt4d_dgrad and mmt4d_wgrad over every expert at Qwen3-MoE's
     training experts (128, C 320 at 4,096 tokens, 4096 <-> 1536; the gate
     with silu's gradient) and jamba's (16, C 640, 4096 <-> 14336), bf16
     (the Qwen3-MoE gate also f32), beside torch.bmm; one f32 step's loss
     and gradients card = CPU (FAMILY_F32: RWKV-6 at full width cut to 2
     layers, jamba's reduced period, reduced Qwen3-MoE and Arctic; the moe
     metrics too); bf16 held to references: RWKV-6 at 2 layers, one bf16
     step card = the CPU's bf16 plain path and 10 steps card bf16 against
     card f32 (losses); RWKV-6 1.6B whole in bf16, 20 steps through the compiled
     step (loss falling, wkv6 and wkv6_bwd once a layer each step), and
     Qwen3-MoE at full width cut to the layers whose reckoned peak fits
     the card (float32 moments), 5 steps (the dropped fraction, the
     expert-batched gradient launches, the peak memory held to the
     reckoning); replay = eager bit for bit for
     both; the training launcher's --profile on RWKV-6 cut to 2 layers
     (the trace's launches held to the wrappers' counts);
 20. the mesh, the sharding rules, the dry-run and moe's per-shard
     dispatch (ROADMAP A10): the dry-run (launch/dryrun.py) of all 32
     runnable cells on the pod and multipod meshes and SmolLM2-135M's
     serving cell, priced from the card's h100 descriptor (one line a
     cell, labelled a prediction), the card's allocated bytes unmoved;
     the dry-run's bytes per device of phase 19's two train states
     (RWKV-6 1.6B whole, Qwen3-MoE at its training depth) on a one-rank
     mesh against what the caching allocator held right after building
     them: the requested bytes exactly, and each leaf's block its bytes
     rounded up to 512 (plus any remainder the allocator left unsplit,
     from its snapshot), with the reckoned step peak beside the eager and
     the compiled step's measured peaks; a one-rank NCCL group
     (HashStore) and make_elastic_mesh's (1, 1) mesh: SmolLM2-135M's f32
     flat drain through Engine(mesh=) equal to the drain without a mesh
     bit for bit (tokens, every call's logits, captures); Qwen3-MoE's moe
     layer at full width in f32 with moe_local_dispatch over 4 data
     shards (an AbstractMesh: the global view), one forward of 4 x 256
     tokens card = CPU (routing under the top-k margin rule, routed and
     kept assignments exactly, y within F32_MARGIN; the CPU's forward on
     the CPU's thread beside the phase's card work), and the expert gate
     product at its blocked shape [128, 4 C, 4096] held to its plain
     version beside the unblocked case;
 21. the kernels JSON line (launches from the main path of each kernel: the
     flat drain for the serving kernels, the 20-step bf16 training run for
     the gradient kernels, the RWKV-6 1.6B drain for wkv6, jamba's first
     drain for selective_scan, RWKV-6 1.6B's 20 training steps for
     wkv6_bwd, jamba's f32 train step on the card for selective_scan_bwd;
     each other path's beside them, phases 6's and 7's included; each
     kernel's representative case at the scaled tiles; ragged_attn's
     d_head-128 cases; the gradient kernels' expert-batched cases), then
     the result line.

The CPU plain path's reference runs, most of the run's wall when made
in turn, run beside the card's work (CpuRuns): those over weights from
a CPU generator (phases 8, 10, 12 and 16: SmolLM2 and whisper) in a
worker process, those over weights drawn on the card (phases 4-7: the
moe, jamba, dense, vlm and recurrent configs) on one thread of this
process, handed a host copy of the weights (at most CPU_HOST_LIMIT bytes
of them at once).  Each comparison is made, and printed, at the first
phase boundary after its CPU run ended (phase 18 makes the rest), and
fails the run as before; the family training phase runs its own CPU
steps after every CPU run has ended, and the mesh phase puts its one CPU
forward on the thread again.  The phases whose CPU runs take
longest come first, so that the later card-only phases cover them.

Usage:  python3 chip_smoke.py [--out results.json]
Exits non-zero, printing no result, without a CUDA card or without the
repository's src/ beside it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TF = torch.float32
BF = torch.bfloat16
EXPECTED_PER_STEP = {"mmt4d": 30 * 7 + 1, "pack": 1 + 30 + 1 + 1,
                     "unpack": 1, "ragged_attn": 30}
# the paged step (dense chunked and monolithic families) attends through
# PyTorch (core_attention), as the JAX package does outside Pallas
EXPECTED_PER_PAGED_CALL = {**EXPECTED_PER_STEP, "ragged_attn": 0}
# mmt4d launches per model call that write their result unpacked: the Q/K/V
# exits of 30 layers and the tied head (the final stream's unpack stays a
# kernel); the same in every family
EXPECTED_UNPACKED_PER_STEP = 30 * 3 + 1
SOURCES = {
    "mmt4d": ("src/repro_torch/csrc/mmt4d.cu", "src/repro/kernels/mmt4d/kernel.py:113"),
    "pack": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack/kernel.py:46"),
    "unpack": ("src/repro_torch/csrc/unpack.cu", "src/repro/kernels/unpack/kernel.py:31"),
    "ragged_attn": ("src/repro_torch/csrc/ragged_attn.cu",
                    "src/repro/kernels/ragged_attn/kernel.py:109"),
    # mmt4d's two gradient products: no Pallas kernel of their own; the
    # products the TPU kernel computes in its body, transposed (the JAX
    # package differentiates the jnp mmt4d, src/repro/core/mmt4d.py:64)
    "mmt4d_dgrad": ("src/repro_torch/csrc/mmt4d_bwd.cu",
                    "src/repro/kernels/mmt4d/kernel.py:113"),
    "mmt4d_wgrad": ("src/repro_torch/csrc/mmt4d_bwd.cu",
                    "src/repro/kernels/mmt4d/kernel.py:113"),
    # RWKV-6's recurrence: no Pallas kernel; the JAX package's lax.scan
    "wkv6": ("src/repro_torch/csrc/wkv6.cu", "src/repro/models/rwkv6.py:87"),
    # mamba's selective scan: no Pallas kernel; the JAX package's
    # lax.associative_scan
    "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/models/mamba.py:79"),
    # the two recurrences' backward: no Pallas kernel; the JAX package
    # differentiates its lax.scan (checkpointed per 128-token chunk) and
    # its lax.associative_scan
    "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu", "src/repro/models/rwkv6.py:87"),
    "selective_scan_bwd": ("src/repro_torch/csrc/selective_scan_bwd.cu",
                           "src/repro/models/mamba.py:79"),
}
SERVING_KERNELS = ("mmt4d", "pack", "unpack", "ragged_attn")
GRAD_KERNELS = ("mmt4d_dgrad", "mmt4d_wgrad")
# the recurrences' backward kernels: no serving drain launches them
RECURRENT_GRAD = ("wkv6_bwd", "selective_scan_bwd")
# the case each kernel's headline numbers come from (bfloat16, the default
# RunConfig): the shape that carries most of its time in the drain
REPRESENTATIVE = {"mmt4d": "gate decode", "pack": "tied head embed",
                  "unpack": "final stream decode", "ragged_attn": "decode rows",
                  "mmt4d_dgrad": "tied head", "mmt4d_wgrad": "tied head",
                  "wkv6": "decode rows", "selective_scan": "decode rows",
                  "wkv6_bwd": "train", "selective_scan_bwd": "train"}
# max |kernel - plain| <= TOL * max(floor, max |plain|): float32 sums in
# another order; bfloat16 may round the float32 result to a neighbouring
# value.  floor is 1 for the forward kernels, whose results are of order 1,
# and 0 for the gradient products, whose results are small: their limit
# scales with the result alone and must stay a small share (GRAD_TOL_SHARE)
# of the result's mean |value|
TOL = {TF: 1e-4, BF: 2e-2}
# the expert-batched mmt4d in float32: within this share of the plain
# version's largest |value| (each K tile summed, then the tiles, in
# another order than the plain version's)
EXPERT_F32_TOL = 1e-5
GRAD_TOL_SHARE = 0.25
# wkv6 (float32 only): y and the final state each within this share of the
# plain version's largest |value| (float32 sums over dh = 64 in another
# order, FMAs, and a recurrence of up to 512 steps)
WKV6_TOL = 1e-5
# selective_scan: float32 y and every final state within SCAN_RTOL of the
# plain version's value plus SCAN_ATOL, element by element (the state's
# recurrence rounds as the plain version's; the sum over N runs in another
# order); bfloat16 y within TOL[BF] of max(1, max |plain|) (a bfloat16
# rounding of nearby float32 values)
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
# the recurrent kernels' headline cases before their redesign (PERF.md §6:
# wkv6's token loop, one thread a state column, float32; selective_scan's
# one thread a channel, bfloat16; L2-cold, NVIDIA H100 80GB HBM3 at
# 700 W), printed beside this run's times
EARLIER_MS = {("wkv6", "decode rows", "float32"): ("token loop", 0.004781),
              ("wkv6", "prefill", "float32"): ("token loop", 0.243790),
              ("selective_scan", "decode rows", "bfloat16"): ("a thread a channel", 0.012227),
              ("selective_scan", "prefill 512", "bfloat16"): ("a thread a channel", 0.592840),
              ("selective_scan", "prefill cached", "bfloat16"): ("a thread a channel", 0.299648),
              # the recurrences' backward before PR 30's redesign: wkv6_bwd
              # a block a (row, head), its states in an L2 scratch;
              # selective_scan_bwd two expf an element, 30 shuffles a step
              ("wkv6_bwd", "train", "float32"): ("a block a head", 1.945682),
              ("selective_scan_bwd", "train", "bfloat16"): ("two expf an element", 3.060730),
              ("selective_scan_bwd", "train", "float32"): ("two expf an element", 3.131126)}
L2_FLUSH_BYTES = 64 * 2**20     # operand copies per cold-timed case pass this
# two runs of one drain may pick differently only where a pick's (perturbed,
# for a sampled pick) top-2 logit margin is below this: float32 logits of
# the card and the CPU, or of two batch layouts, differ by about 1e-6; the
# bfloat16 logits of two layouts by about a bfloat16 ulp of the logits
F32_MARGIN = 1e-5
BF16_MARGIN = 0.0625
# the f32 prefix-cache and speculation drains' depth: SmolLM2 at full
# width cut to 8 of its 30 layers (all 30 until the family training
# phase came: the cut pays for its wall; the bf16 drains keep all 30)
VARIANTS_F32_LAYERS = 8
# the sampled drains' per-request temperatures, in turn (0 picks greedily)
TEMPERATURES = (1.0, 0.7, 1.3, 0.0)


def earlier_note(name: str, label: str, dtype: str, ms: float) -> str:
    """``; before the redesign (design): t ms, x times this run's`` where
    EARLIER_MS has the case."""
    if (name, label, dtype) not in EARLIER_MS:
        return ""
    design, t = EARLIER_MS[name, label, dtype]
    return f"; before the redesign ({design}): {t:.6f} ms, {t / ms:.2f}x this run's"


def cold_sets(*tensors):
    """``tensors`` and enough copies of them to pass L2_FLUSH_BYTES."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = 1 + -(-L2_FLUSH_BYTES // nbytes)
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(copies - 1)]


def cycle(fn, sets):
    """A call of ``fn`` on the next set of operands, round robin."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SPIN_CYCLES_PER_MS: list = []


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card,
    measured once."""
    if not _SPIN_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def time_ms(fn, iters: int = 20, spin: bool = True, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    ``warmup`` calls (CUDA events).  A spin kernel holds the stream while the host
    queues every call, so a call shorter than its host-side launch cost
    is timed on the device and not at the host's launch rate.  The spin
    lasts four times the host's measured time to queue the calls; should
    it still end first, the timing is refused and retried once with a
    spin twice as long.  ``spin=False`` times without it, for a call of
    more launches than the device's queue holds (a plain version's token
    loop): its time is then the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not spin:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin_ms = max(20.0, 4 * queue_ms)
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        spin_ms *= 2
    raise AssertionError("the spin kernel ended before the host had queued "
                         "every call, twice: the timing would be the host's")


# ------------------------------------------- the CPU plain path, off the card's way
#
# The CPU plain path's reference runs take longer than the card's side of
# most comparisons, so they run beside the card's work: those whose
# weights come from a CPU generator (SmolLM2 and whisper) in a worker
# process (CpuRuns.proc: no weights cross, and its Python runs apart from
# the card's driver); those over weights drawn on the card (the dense,
# vlm, recurrent and moe configs) on one thread of this process
# (CpuRuns.thread), handed the weights' host copy; their large products
# release Python's lock while they compute.  Each comparison is made when
# its CPU run has ended (CpuRuns.defer).  No run on the thread touches the
# card, and the card's driver runs no CPU moe layer while the thread may:
# the moe drop counter is keyed by device, and the routing record
# (route_recorder) by thread.

# the host bytes the thread's runs may hold at once (weights handed to it):
# arctic's layer (53.5 GB) beside qwen3-moe's, not beside jamba's period
# (51 GB), on a one-card host of about 100 GB
CPU_HOST_LIMIT = 72e9
# torch threads: the worker process's and the thread's, of a one-card
# host's 8 cores
CPU_PROC_THREADS, CPU_THREAD_THREADS = 3, 5


def _timed(fn, *args, **kw):
    """(fn's result, its seconds): a lane's unit of work."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _proc_init(src: str, threads: int) -> None:
    """The worker process's start: the port on its path, its torch threads."""
    sys.path.insert(0, src)
    torch.set_num_threads(threads)


class CpuRuns:
    """The CPU plain path's runs of the smoke run, beside the card's: a
    worker process (``proc``), one thread (``thread``, whose weights'
    host bytes are reserved with ``reserve``), and the comparisons that
    wait on them (``defer``, made by ``settle``)."""

    def __init__(self, src: str):
        import concurrent.futures as cf
        import multiprocessing as mp
        import queue
        import threading
        self.t0 = time.perf_counter()
        self.pool = cf.ProcessPoolExecutor(
            1, mp_context=mp.get_context("spawn"), initializer=_proc_init,
            initargs=(src, CPU_PROC_THREADS))
        self.jobs, self.cond, self.held = queue.Queue(), threading.Condition(), 0
        self.threads_before = torch.get_num_threads()
        self.futures, self.pending, self.log = [], [], []
        self.waited = 0.0
        self.worker = threading.Thread(target=self._run, name="cpu-runs", daemon=True)
        self.worker.start()

    def proc(self, fn, *args, **kw):
        """``fn(*args, **kw)`` in the worker process (a module-level
        function of this script, on picklable arguments)."""
        fut = self.pool.submit(_timed, fn, *args, **kw)
        self.futures.append(fut)
        return fut

    def reserve(self, nbytes: int) -> None:
        """Wait until ``nbytes`` more host bytes fit CPU_HOST_LIMIT beside
        the thread's unfinished runs' (or it has none), and hold them for
        the next ``thread`` run."""
        t0 = time.perf_counter()
        with self.cond:
            self.cond.wait_for(lambda: self.held == 0
                               or self.held + nbytes <= CPU_HOST_LIMIT)
            self.held += nbytes
        self.waited += time.perf_counter() - t0

    def thread(self, fn, *args, nbytes: int = 0, **kw):
        """``fn(*args, **kw)`` on the thread, after every earlier one; the
        ``nbytes`` reserved for it are given back when it ends, and its
        arguments dropped."""
        import concurrent.futures as cf
        fut = cf.Future()
        self.futures.append(fut)
        self.jobs.put((fut, fn, args, kw, nbytes))
        return fut

    def _run(self):
        import gc
        torch.set_num_threads(CPU_THREAD_THREADS)
        while True:
            job = self.jobs.get()
            if job is None:
                return
            fut, nbytes = job[0], job[4]
            if fut.set_running_or_notify_cancel():
                self._call(*job[:4])
            del job
            # the engine and its recorders hold the weights in reference
            # cycles: free them before their bytes count as given back
            gc.collect()
            with self.cond:
                self.held -= nbytes
                self.cond.notify_all()

    @staticmethod
    def _call(fut, fn, args, kw):
        try:
            fut.set_result(_timed(fn, *args, **kw))
        except BaseException as e:      # raised where the comparison waits
            fut.set_exception(e)

    def defer(self, label: str, fut, check) -> None:
        """Call ``check(result)`` once ``fut``'s run has ended."""
        self.pending.append((label, fut, check))

    def settle(self, block: bool = False) -> None:
        """Make every comparison whose run has ended (``block``: all)."""
        keep = []
        for label, fut, check in self.pending:
            if not (block or fut.done()):
                keep.append((label, fut, check))
                continue
            t0 = time.perf_counter()
            res, secs = fut.result()
            self.waited += time.perf_counter() - t0
            self.log.append((label, secs))
            print(f"  card = CPU, {label}: the CPU plain path's run took {secs:.1f} s "
                  f"beside the card's work")
            check(res)
        self.pending = keep

    def finish(self) -> dict:
        """Wait for every run, make every comparison, give the torch threads
        back; returns the runs' seconds and the waits on them."""
        self.settle(block=True)
        import concurrent.futures as cf
        cf.wait(self.futures)
        torch.set_num_threads(self.threads_before)
        busy = sum(s for _, s in self.log)
        print(f"  the CPU plain path's runs: {len(self.log)}, {busy:.1f} s of them "
              f"beside the card's work (worker process {CPU_PROC_THREADS} torch "
              f"threads, thread {CPU_THREAD_THREADS}); the card's driver waited "
              f"{self.waited:.1f} s on them; {time.perf_counter() - self.t0:.1f} s "
              f"since they began")
        return {"runs": dict(self.log), "busy_s": busy, "waited_s": self.waited}

    def close(self) -> None:
        """Stop the worker process and the thread (the process at once if a
        run is still going: the smoke run has failed)."""
        for fut in self.futures:
            fut.cancel()
        self.jobs.put(None)
        if not all(fut.done() for fut in self.futures):
            for p in list((getattr(self.pool, "_processes", None) or {}).values()):
                p.terminate()
        self.pool.shutdown(wait=True, cancel_futures=True)


CPU_RUNS: CpuRuns | None = None     # main's, for the phases' comparisons


def tree_bytes(tree) -> int:
    """The bytes of a nested dict's tensors."""
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def to_cpu_thread(fn, *args, params, **kw):
    """``fn(*args, params=<a host copy of params>, **kw)`` on the CPU's
    thread: the copy (of card tensors) made here, on the card's driver,
    once its bytes fit (CpuRuns.reserve), and handed over."""
    from repro_torch.models.transformer import tree_map
    nbytes = tree_bytes(params)
    CPU_RUNS.reserve(nbytes)
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    return CPU_RUNS.thread(fn, *args, params=host, nbytes=nbytes, **kw)


class KernelChecks:
    """Kernel vs plain version at the serving path's shapes, timed.  The
    tiles come from ``tiles_hw`` (default ``hw``: a scaled descriptor
    widens them); bounds and splits from ``hw``, the card's own."""

    def __init__(self, hw, gen, tiles_hw=None):
        self.hw, self.gen = hw, gen
        self.tiles_hw = tiles_hw or hw
        self.cases = {name: [] for name in SOURCES}

    def layout(self, dtype):
        from repro_torch.core.layout import make_layout
        return make_layout("scalable", self.tiles_hw, dtype)

    def rand(self, shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=self.gen, device="cuda") * scale).to(dtype)

    def bound(self, nbytes: int, flops: int, dtype) -> tuple[float, str]:
        t_bytes = nbytes / self.hw.hbm_bw
        t_ops = flops / self.hw.peak_flops(dtype)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def record(self, name, label, dtype, kernel, plain, library, nbytes, flops,
               exact=False, select=lambda t: t, floor=1.0, share=None,
               plain_spin=True, **extra):
        """Compare ``select`` of the two results (the positions the caller
        keeps) within TOL[dtype] (or ``share``) * max(floor, max |plain|),
        then time the bare calls (``plain_spin=False``: a plain version of
        more launches than the device queue holds, timed at the host's
        launch rate).  ``nbytes`` and ``flops`` are the function's own, on
        the unpadded operands: the bound counts no tile padding."""
        got, want = select(kernel()), select(plain())
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        mean = want.float().abs().mean().item()
        tol = 0.0 if exact else (share or TOL[dtype]) * max(floor, top)
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        print(f"  {name:<11} {label:<44} {str(dtype)[6:]:<8} max_abs_err "
              f"{err:.3e} (tolerance {tol:.3e}; plain max|.| {top:.3e}, mean|.| "
              f"{mean:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} {dtype}: error {err} > {tol}")
        bound_ms, bound_by = self.bound(nbytes, flops, dtype)
        self.cases[name].append({
            "shape": label, "dtype": str(dtype)[6:], "max_abs_err": err,
            "tolerance": tol, "plain_max_abs": top, "plain_mean_abs": mean,
            "kernel_ms": time_ms(kernel),
            "plain_ms": time_ms(plain, iters=20 if plain_spin else 5,
                                spin=plain_spin),
            "library_ms": None if library is None else time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by, **extra})

    def wkv6(self, b, s, label, h=32, dh=64):
        """wkv6 (float32 only) at RWKV-6's heads: r, k, v ~ N(0, 1), w =
        exp(-exp(N(-2, 1))) in (0, 1), u and the starting state ~ N(0,
        0.1); y and the final state each within WKV6_TOL of the plain
        version's largest |value|; timed L2-cold.  Bound: r, k, v, w, u and
        the state read once, y and the state written once (bytes), the
        4 dh^2 operations per token and head at the float32 rate."""
        from repro_torch.kernels.wkv6.ops import wkv6
        from repro_torch.kernels.wkv6.ref import wkv6_ref
        r, k, v = (self.rand((b, s, h, dh), TF) for _ in range(3))
        w = torch.exp(-torch.exp(self.rand((b, s, h, dh), TF) - 2))
        u, s0 = self.rand((h, dh), TF, 0.1), self.rand((b, h, dh, dh), TF, 0.1)
        got, want = wkv6(r, k, v, w, u, s0), wkv6_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        errs, tols = [], []
        for name, g, x in zip(("y", "state"), got, want):
            errs.append((g - x).abs().max().item())
            tols.append(WKV6_TOL * x.abs().max().item())
            ok = errs[-1] <= tols[-1] and bool(torch.isfinite(g).all())
            print(f"  {'wkv6':<11} {label + ' ' + name:<44} float32  max_abs_err "
                  f"{errs[-1]:.3e} (tolerance {tols[-1]:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"wkv6 {label} {name}: error {errs[-1]} > "
                                     f"{tols[-1]}")
        sets = cold_sets(r, k, v, w, u, s0)
        nbytes = 4 * (5 * b * s * h * dh + 2 * b * h * dh * dh + h * dh)
        bound_ms, bound_by = self.bound(nbytes, 4 * b * s * h * dh * dh, TF)
        self.cases["wkv6"].append({
            "shape": f"{label}, r/k/v/w ({b},{s},{h},{dh}), state ({b},{h},{dh},{dh})",
            "dtype": "float32", "max_abs_err": max(errs), "tolerance": min(tols),
            "max_abs_err_y": errs[0], "max_abs_err_state": errs[1],
            "kernel_ms": time_ms(cycle(wkv6, sets)),
            "plain_ms": time_ms(cycle(wkv6_ref, sets[:1]), iters=5 if s > 1 else 20,
                                spin=s == 1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        c = self.cases["wkv6"][-1]
        print(f"  {'wkv6':<11} {label:<44} float32  {c['kernel_ms']:.6f} ms "
              f"(bound {bound_ms:.6f} by {bound_by}, plain {c['plain_ms']:.4f}, "
              f"no library call"
              f"{earlier_note('wkv6', label, 'float32', c['kernel_ms'])})")

    def selective_scan(self, dtype, b, s, h0, label, di=8192, n=16, dt_rank=256):
        """selective_scan at jamba's widths (di 8192, N 16, dt_rank 256):
        x = silu(N(0, 1)), z the second half of an in-projection output
        and B, C slices of an x-projection output (strided views, as
        mamba_apply hands them over), delta = softplus(N(-4, 1)), a_log =
        log(1..N) plus N(0, 0.1), d_skip ~ 1 + N(0, 0.1), the state ~ N(0,
        1) (``h0``) or zero.  y and the final state (written in place)
        against the plain version's (SCAN_RTOL / SCAN_ATOL, bf16 y
        TOL[BF]); a second call from the same h0 bit-identical; timed
        L2-cold.  Bound: delta, x, z, B, C, a_log, d_skip and the state
        read once, y and the state written once (bytes); 8 float32
        operations per (token, channel, state) element and 7 per (token,
        channel) at the float32 rate."""
        import torch.nn.functional as F
        from repro_torch.kernels.selective_scan.ops import selective_scan
        from repro_torch.kernels.selective_scan.ref import selective_scan_ref
        x = F.silu(self.rand((b, s, di), TF)).to(dtype)
        xz = self.rand((b, s, 2 * di), dtype)
        proj = self.rand((b, s, dt_rank + 2 * n), dtype)
        delta = F.softplus(self.rand((b, s, di), TF) - 4)
        a_log = (torch.log(torch.arange(1, n + 1, device="cuda", dtype=TF))
                 + self.rand((di, n), TF, 0.1))
        d_skip = 1 + self.rand((di,), TF, 0.1)
        state = self.rand((b, di, n), TF) if h0 else torch.zeros(
            (b, di, n), device="cuda")

        def call(fn, d, xx, xzz, p, al, ds, st):
            return fn(d, xx, xzz[..., di:], p[..., dt_rank:dt_rank + n],
                      p[..., dt_rank + n:], al, ds, st)

        ops = (delta, x, xz, proj, a_log, d_skip)
        start = state.clone()
        want_h = state.clone()
        want = call(selective_scan_ref, *ops, want_h)
        got = call(selective_scan, *ops, state)
        got_h = state.clone()
        state.copy_(start)
        again = call(selective_scan, *ops, state)
        torch.cuda.synchronize()
        if not (torch.equal(again, got) and torch.equal(state, got_h)):
            raise AssertionError(f"selective_scan {label} {dtype}: two calls "
                                 f"from the same state differ")
        errs, limits = {}, {}
        for name, g, w in (("y", got.float(), want.float()), ("state", got_h, want_h)):
            errs[name] = (g - w).abs().max().item()
            if name == "y" and dtype is BF:
                limits[name] = f"{TOL[BF] * max(1.0, w.abs().max().item()):.3e}"
                ok = errs[name] <= TOL[BF] * max(1.0, w.abs().max().item())
            else:
                limits[name] = f"rtol {SCAN_RTOL:g} atol {SCAN_ATOL:g}"
                ok = bool(((g - w).abs() <= SCAN_ATOL + SCAN_RTOL * w.abs()).all())
            ok = ok and bool(torch.isfinite(g).all())
            print(f"  {'selective_scan':<14} {label + ' ' + name:<41} "
                  f"{str(dtype)[6:]:<8} max_abs_err {errs[name]:.3e} "
                  f"(tolerance {limits[name]}; plain max|.| "
                  f"{w.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"selective_scan {label} {dtype} {name}: "
                                     f"error {errs[name]} over {limits[name]}")
        # the state's products round as the plain version's: in float32 the
        # final state is the plain version's bit for bit
        state_bitwise = torch.equal(got_h, want_h)
        print(f"  {'selective_scan':<14} {label + ' state':<41} "
              f"{str(dtype)[6:]:<8} bit for bit: {state_bitwise}")
        if dtype is TF and not state_bitwise:
            raise AssertionError(f"selective_scan {label} float32: the final "
                                 f"state differs from the plain version's")
        es = x.element_size()
        nbytes = (4 * b * s * di + 3 * es * b * s * di + 2 * es * b * s * n
                  + 4 * di * n + 4 * di + 2 * 4 * b * di * n)
        bound_ms, bound_by = self.bound(nbytes, b * s * di * (8 * n + 7)
                                        + 2 * b * di * n, TF)
        sets = cold_sets(*ops, state)
        self.cases["selective_scan"].append({
            "shape": f"{label}, delta/x/z ({b},{s},{di}), B/C ({b},{s},{n}), "
                     f"state ({b},{di},{n})",
            "dtype": str(dtype)[6:], "max_abs_err": max(errs.values()),
            "max_abs_err_y": errs["y"], "max_abs_err_state": errs["state"],
            "state_bitwise": state_bitwise, "tolerance": limits,
            "kernel_ms": time_ms(cycle(lambda *t: call(selective_scan, *t), sets)),
            "plain_ms": time_ms(cycle(lambda *t: call(selective_scan_ref, *t),
                                      sets[:1]), iters=5 if s > 1 else 20,
                                spin=s == 1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        c = self.cases["selective_scan"][-1]
        print(f"  {'selective_scan':<14} {label:<41} {str(dtype)[6:]:<8} "
              f"{c['kernel_ms']:.6f} ms (bound {bound_ms:.6f} by {bound_by}, "
              f"plain {c['plain_ms']:.4f}, no library call"
              f"{earlier_note('selective_scan', label, c['dtype'], c['kernel_ms'])})")

    def mmt4d(self, dtype, w_tokens, k, n, act, label, bias=False):
        """``bias``: with a packed bias in the epilogue (added before the
        tanh gelu, as whisper's MLP does); the library call is then
        ``torch._addmm_activation(b, x, w, use_gelu=True)``, cuBLASLt's
        GELU_BIAS epilogue, held to the plain version like the kernel."""
        from repro_torch.core import packing
        from repro_torch.core.mmt4d import Epilogue
        from repro_torch.kernels.mmt4d.ops import mmt4d, pick_split
        from repro_torch.kernels.mmt4d.ref import mmt4d_ref
        from repro_torch.kernels.unpack.ref import unpack_ref
        if bias and act != "gelu":
            raise ValueError("a biased case is whisper's gelu up-projection")
        lay = self.layout(dtype)
        x = self.rand((w_tokens, k), dtype)
        w = self.rand((k, n), dtype, k ** -0.5)
        bv = self.rand((n,), dtype, 0.1) if bias else None
        bb = None if bv is None else Epilogue().bias_pack(bv, lay)
        ap, bp = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay)
        out = mmt4d(ap, bp, bb, activation=act)
        if not torch.equal(out, mmt4d(ap, bp, bb, activation=act)):
            raise AssertionError(f"mmt4d {label} {dtype}: two calls differ")
        split = {} if dtype is TF else {"split": str(pick_split(
            ap.shape[0], bp.shape[0], ap.shape[1], lay.m_r, lay.n_r, lay.k_r,
            self.hw.sm_count))}
        sets = cold_sets(ap, bp, x, w)
        library = cycle(lambda _a, _b, xx, ww: torch.matmul(xx, ww), sets)
        if bias:
            lib = torch._addmm_activation(bv, x, w, use_gelu=True)
            want = unpack_ref(mmt4d_ref(ap, bp, bb, activation=act), w_tokens, n)
            lib_err = (lib.float() - want.float()).abs().max().item()
            lib_tol = TOL[dtype] * max(1.0, want.float().abs().max().item())
            if not lib_err <= lib_tol:
                raise AssertionError(f"mmt4d {label} {dtype}: the library call "
                                     f"differs from the plain version by {lib_err}")
            library = cycle(lambda _a, _b, xx, ww: torch._addmm_activation(
                bv, xx, ww, use_gelu=True), sets)
        es = dtype.itemsize
        self.record("mmt4d", f"{label} A{tuple(ap.shape)} B{tuple(bp.shape)}"
                    + (" + bias" if bias else ""), dtype,
                    cycle(lambda a, b, _x, _w: mmt4d(a, b, bb, activation=act), sets),
                    cycle(lambda a, b, _x, _w: mmt4d_ref(a, b, bb, activation=act), sets),
                    library,
                    (w_tokens * k + k * n + w_tokens * n + (n if bias else 0)) * es,
                    2 * w_tokens * k * n, copies=len(sets), **split)
        if bias:
            case = self.cases["mmt4d"][-1]
            print(f"    mmt4d {label} {str(dtype)[6:]}: {case['kernel_ms']:.6f} ms "
                  f"against a bound of {case['bound_ms']:.6f} ms; "
                  f"torch._addmm_activation {case['library_ms']:.6f} ms "
                  f"({case['kernel_ms'] / case['library_ms']:.2f}x; max_abs_err "
                  f"{lib_err:.3e} to the plain version)")

    def experts(self, dtype, e, c, k, n, act, label):
        """The expert-batched mmt4d at a moe layer's expert product: x [E,
        C, K] (C the capacity: rows per expert) through w [E, K, N], stored
        unpacked as the path stores it, held to its plain version (f32
        within EXPERT_F32_TOL of the largest |value|, bf16 under TOL) and
        bit-identical on a repeat; timed L2-cold beside the plain version
        and one torch.bmm on the unpacked operands (the yardstick).  Bound:
        every expert's weights read once (the capacity dispatch runs every
        expert), x read and C written once, by bytes or operations."""
        from repro_torch.core import packing
        from repro_torch.kernels.mmt4d.ops import mmt4d, pick_split
        from repro_torch.kernels.mmt4d.ref import mmt4d_ref
        from repro_torch.kernels.unpack.ref import unpack_ref
        lay = self.layout(dtype)
        x = self.rand((e, c, k), dtype)
        w = torch.empty((e, k, n), dtype=dtype, device="cuda")
        for e0 in range(0, e, 16):        # drawn in blocks: no f32 copy of it all
            w[e0:e0 + 16] = self.rand((min(16, e - e0), k, n), dtype, k ** -0.5)
        ap, bp = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay)
        to = (c, n)
        out = mmt4d(ap, bp, activation=act, unpack_to=to)
        if not torch.equal(out, mmt4d(ap, bp, activation=act, unpack_to=to)):
            raise AssertionError(f"mmt4d {label} {dtype}: two calls differ")
        split = {} if dtype is TF else {"split": str(pick_split(
            ap.shape[1], bp.shape[1], ap.shape[2], lay.m_r, lay.n_r, lay.k_r,
            self.hw.sm_count, e))}
        sets = cold_sets(ap, bp, x, w)
        es = dtype.itemsize
        self.record("mmt4d", f"{label} A{tuple(ap.shape)} B{tuple(bp.shape)}"
                    f" -> {tuple(out.shape)}", dtype,
                    cycle(lambda a, b, *_: mmt4d(a, b, activation=act,
                                                 unpack_to=to), sets),
                    cycle(lambda a, b, *_: unpack_ref(
                        mmt4d_ref(a, b, activation=act), *to), sets),
                    cycle(lambda _a, _b, xx, ww: torch.bmm(xx, ww), sets),
                    (e * c * k + e * k * n + e * c * n) * es, 2 * e * c * k * n,
                    floor=1.0 if dtype is BF else 0.0,
                    share=EXPERT_F32_TOL if dtype is TF else None,
                    plain_spin=False, copies=len(sets), experts=e, **split)
        case = self.cases["mmt4d"][-1]
        print(f"    mmt4d {label} {str(dtype)[6:]}: {case['kernel_ms']:.6f} ms, "
              f"bound {case['bound_ms']:.6f} ms by {case['bound_by']} (all "
              f"{e} experts' weights, {e * k * n * es / 1e9:.3f} GB, read once), "
              f"plain {case['plain_ms']:.4f} ms, torch.bmm "
              f"{case['library_ms']:.6f} ms ({self.hw.device_name})")
        del x, w, ap, bp, sets
        torch.cuda.empty_cache()

    def mmt4d_unpacked(self, dtype, w_tokens, k, n, label):
        """A linear's exit: mmt4d writing [1, w_tokens, n] unpacked, held to
        the plain version (unpack_ref of mmt4d_ref) and bit for bit to the
        packed store followed by the unpack kernel; timed L2-cold beside
        that pair, the packed store alone and torch.matmul."""
        from repro_torch.core import packing
        from repro_torch.kernels.mmt4d.ops import mmt4d
        from repro_torch.kernels.mmt4d.ref import mmt4d_ref
        from repro_torch.kernels.unpack.ops import unpack
        from repro_torch.kernels.unpack.ref import unpack_ref
        lay = self.layout(dtype)
        x = self.rand((1, w_tokens, k), dtype)
        w = self.rand((k, n), dtype, k ** -0.5)
        ap, bp = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay)
        to = (w_tokens, n)

        def pair(a, b, *_):
            return unpack(mmt4d(a, b), *to)

        out = mmt4d(ap, bp, unpack_to=to)
        if not torch.equal(out, pair(ap, bp)):
            raise AssertionError(f"mmt4d {label} {dtype}: the unpacked store "
                                 f"differs from mmt4d then unpack")
        sets = cold_sets(ap, bp, x, w)
        es = dtype.itemsize
        self.record("mmt4d", f"{label} A{tuple(ap.shape)} B{tuple(bp.shape)}"
                    f" -> {tuple(out.shape)}", dtype,
                    cycle(lambda a, b, *_: mmt4d(a, b, unpack_to=to), sets),
                    cycle(lambda a, b, *_: unpack_ref(mmt4d_ref(a[0], b)[None], *to), sets),
                    cycle(lambda _a, _b, xx, ww: torch.matmul(xx, ww), sets),
                    (w_tokens * k + k * n + w_tokens * n) * es,
                    2 * w_tokens * k * n, copies=len(sets),
                    pair_ms=time_ms(cycle(pair, sets)),
                    packed_ms=time_ms(cycle(lambda a, b, *_: mmt4d(a, b), sets)))

    def grads(self, dtype, m, k, n, act, label):
        """mmt4d's gradient products at a training linear: dgrad (dA =
        dZ . B over N) and wgrad (dB = dZ^T . A over the m tokens), with the
        activation's gradient formed as dZ loads (the gate's silu), each
        held to its plain version, bit-identical on a repeat, and timed
        L2-cold beside one torch.matmul of the same product on the
        unpacked operands (the yardstick)."""
        from repro_torch.core import packing
        from repro_torch.kernels.mmt4d.ops import (gemm_operands, mmt4d_dgrad,
                                                   mmt4d_wgrad, pick_grad_split)
        from repro_torch.kernels.mmt4d.ref import mmt4d_dgrad_ref, mmt4d_wgrad_ref
        lay = self.layout(dtype)
        x = self.rand((m, k), dtype)
        w = self.rand((k, n), dtype, k ** -0.5)
        dy = self.rand((m, n), dtype, m ** -0.5)
        z = self.rand((m, n), dtype) if act else dy[:0]
        ap, bp, dzp = (packing.pack_lhs(x, lay), packing.pack_rhs(w, lay),
                       packing.pack_out(dy, lay))
        zp = packing.pack_out(z, lay) if act else None
        es = dtype.itemsize
        sets = cold_sets(ap, bp, dzp, *(() if zp is None else (zp,)), x, w, dy)
        zi = (lambda s: s[3]) if act else (lambda s: None)

        def dgrad(*t):
            return mmt4d_dgrad(t[2], t[1], zi(t), activation=act)

        def wgrad(*t):
            return mmt4d_wgrad(t[2], t[0], zi(t), activation=act)[0]

        # each reads dY (and Z) and the other operand once and writes its
        # result once, all unpadded: m*n*(1 or 2) + k*n + m*k elements
        nbytes = (m * n * (2 if act else 1) + k * n + m * k) * es
        for name, fn, plain, library in (
                ("mmt4d_dgrad", dgrad,
                 lambda *t: mmt4d_dgrad_ref(t[2], t[1], zi(t), activation=act),
                 lambda *t: torch.matmul(t[-1], t[-2].T)),
                ("mmt4d_wgrad", wgrad,
                 lambda *t: mmt4d_wgrad_ref(t[2], t[0], zi(t), activation=act)[0],
                 lambda *t: torch.matmul(t[-1].T, t[-3]))):
            if not torch.equal(fn(*sets[0]), fn(*sets[0])):
                raise AssertionError(f"{name} {label} {dtype}: two calls differ")
            split = {}
            if dtype is BF:     # the reduction's split: blocks per cluster
                pqr = gemm_operands(name[6:], ap.shape[0], bp.shape[0], ap.shape[1],
                                    lay.m_r, lay.n_r, lay.k_r)[:3]
                split = {"split": pick_grad_split(*pqr, self.hw.sm_count), "pqr": pqr}
            self.record(name, f"{label} dZ{tuple(dzp.shape)}", dtype,
                        cycle(fn, sets), cycle(plain, sets), cycle(library, sets),
                        nbytes, 2 * m * n * k, floor=0.0, copies=len(sets), **split)
            case = self.cases[name][-1]
            ms = case["kernel_ms"]
            print(f"    {name} {label} {str(dtype)[6:]}: {ms:.4f} ms "
                  f"({2 * m * n * k / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} "
                  f"TB/s) against a bound of {case['bound_ms']:.5f} ms "
                  f"({case['bound_by']}: {self.hw.peak_flops(dtype) / 1e12:.0f} "
                  f"TFLOP/s, {self.hw.hbm_bw / 1e12:.2f} TB/s); torch.matmul "
                  f"{case['library_ms']:.4f} ms ({ms / case['library_ms']:.2f}x)"
                  + (f"; (P, Q, R) {split['pqr']}, split {split['split']}, cluster "
                     f"(1, 1, {split['split']})" if split else ""))
            if case["tolerance"] > GRAD_TOL_SHARE * case["plain_mean_abs"]:
                raise AssertionError(
                    f"{name} {label} {dtype}: the tolerance {case['tolerance']} is "
                    f"above {GRAD_TOL_SHARE} of the mean |result| "
                    f"{case['plain_mean_abs']}: it would pass a wrong result")

    def expert_grads(self, dtype, e, c, k, n, act, label):
        """mmt4d_dgrad and mmt4d_wgrad over every expert at a moe layer's
        expert product (x [E, C, K] through w [E, K, N], C the capacity),
        the gate's silu gradient formed as dZ loads where ``act``: each
        held to its plain version with the expert dim and bit-identical on
        a repeat, timed L2-cold beside one torch.bmm of the same product
        on the unpacked operands.  Bound: dY (and Z), the other operand and
        the result, each read or written once, unpadded."""
        from repro_torch.core import packing
        from repro_torch.kernels.mmt4d.ops import mmt4d_dgrad, mmt4d_wgrad
        from repro_torch.kernels.mmt4d.ref import mmt4d_dgrad_ref, mmt4d_wgrad_ref
        lay = self.layout(dtype)
        x = self.rand((e, c, k), dtype)
        w = torch.empty((e, k, n), dtype=dtype, device="cuda")
        for e0 in range(0, e, 16):        # drawn in blocks: no f32 copy of it all
            w[e0:e0 + 16] = self.rand((min(16, e - e0), k, n), dtype, k ** -0.5)
        dy = self.rand((e, c, n), dtype, c ** -0.5)
        ap, bp, dzp = (packing.pack_lhs(x, lay), packing.pack_rhs(w, lay),
                       packing.pack_out(dy, lay))
        zp = packing.pack_out(self.rand((e, c, n), dtype), lay) if act else None
        zi = (lambda s: s[3]) if act else (lambda s: None)
        sets = cold_sets(ap, bp, dzp, *(() if zp is None else (zp,)), x, w, dy)
        es = dtype.itemsize
        nbytes = (e * c * n * (2 if act else 1) + e * k * n + e * c * k) * es
        for name, fn, plain, library in (
                ("mmt4d_dgrad", lambda *t: mmt4d_dgrad(t[2], t[1], zi(t), activation=act),
                 lambda *t: mmt4d_dgrad_ref(t[2], t[1], zi(t), activation=act),
                 lambda *t: torch.bmm(t[-1], t[-2].transpose(1, 2))),
                ("mmt4d_wgrad",
                 lambda *t: mmt4d_wgrad(t[2], t[0], zi(t), activation=act, experts=True)[0],
                 lambda *t: mmt4d_wgrad_ref(t[2], t[0], zi(t), activation=act,
                                            experts=True)[0],
                 lambda *t: torch.bmm(t[-3].transpose(1, 2), t[-1]))):
            if not torch.equal(fn(*sets[0]), fn(*sets[0])):
                raise AssertionError(f"{name} experts {label} {dtype}: two calls differ")
            self.record(name, f"experts {label} dZ{tuple(dzp.shape)}", dtype,
                        cycle(fn, sets), cycle(plain, sets), cycle(library, sets),
                        nbytes, 2 * e * c * k * n, floor=0.0, copies=len(sets),
                        experts=e, plain_spin=False)
            case = self.cases[name][-1]
            ms = case["kernel_ms"]
            print(f"    {name} experts {label} {str(dtype)[6:]}: {ms:.4f} ms "
                  f"({2 * e * c * k * n / ms / 1e9:.1f} TFLOP/s) against a bound of "
                  f"{case['bound_ms']:.5f} ms ({case['bound_by']}); plain "
                  f"{case['plain_ms']:.3f} ms; torch.bmm {case['library_ms']:.4f} ms "
                  f"({ms / case['library_ms']:.2f}x)")
            if case["tolerance"] > GRAD_TOL_SHARE * case["plain_mean_abs"]:
                raise AssertionError(
                    f"{name} experts {label} {dtype}: the tolerance "
                    f"{case['tolerance']} is above {GRAD_TOL_SHARE} of the mean "
                    f"|result| {case['plain_mean_abs']}")
        del x, w, dy, ap, bp, dzp, zp, sets
        torch.cuda.empty_cache()

    def leaves_close(self, name, label, dtype, got, want, share) -> tuple:
        """Each gradient of ``got`` within ``share`` of its ``want``
        counterpart's largest |value|, printed; returns (the worst error,
        its tolerance)."""
        worst = None
        for i, (g, w) in enumerate(zip(got, want)):
            err = (g.float() - w.float()).abs().max().item()
            tol = share * w.float().abs().max().item()
            ok = err <= tol and bool(torch.isfinite(g.float()).all()) and g.dtype == w.dtype
            if worst is None or err * worst[1] >= worst[0] * tol:
                worst = (err, tol)
            if not ok:
                raise AssertionError(f"{name} {label} {dtype} gradient {i}: error "
                                     f"{err} > {tol} (dtypes {g.dtype}, {w.dtype})")
        print(f"  {name:<18} {label:<38} {str(dtype)[6:]:<8} {len(got)} gradients, "
              f"worst max_abs_err {worst[0]:.3e} (tolerance {worst[1]:.3e}: "
              f"{share:g} of each gradient's largest |value|) ok")
        return worst

    def wkv6_bwd(self, b, s, label, h=32, dh=64, with_ds=False):
        """wkv6's backward (float32) at RWKV-6's heads, as a train step
        calls it (no gradient of the final state; ``with_ds``: a random
        one): the forward kernel writes the checkpoints, the backward
        kernel the gradients of r, k, v, w, u and the starting state, each
        within WKV6_BWD_TOL of the plain backward's (which makes its own
        checkpoints) largest |value|; bit-identical on a repeat; timed
        L2-cold (checkpoints given, as the kernel gets them).  Bound: r,
        k, v, w, dy, u, the starting state (and ds) and the checkpoints
        read once, the six gradients written once (bytes); 8 multiply-adds
        per (token, head, i, j) at the float32 rate."""
        from repro_torch.kernels.wkv6.ops import checkpoints, wkv6, wkv6_bwd
        from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref
        r, k, v, dy = (self.rand((b, s, h, dh), TF) for _ in range(4))
        w = torch.exp(-torch.exp(self.rand((b, s, h, dh), TF) - 2))
        u, s0 = self.rand((h, dh), TF, 0.1), self.rand((b, h, dh, dh), TF, 0.1)
        ds = self.rand((b, h, dh, dh), TF) if with_ds else None
        ckpt = checkpoints(r)
        wkv6(r, k, v, w, u, s0, ckpt=ckpt)
        got = wkv6_bwd(r, k, v, w, u, s0, dy, ds, ckpt)
        want = wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds)
        if not all(torch.equal(a, g) for a, g in zip(
                wkv6_bwd(r, k, v, w, u, s0, dy, ds, ckpt), got)):
            raise AssertionError(f"wkv6_bwd {label}: two calls differ")
        err, tol = self.leaves_close("wkv6_bwd", label, TF, got, want, WKV6_BWD_TOL)
        del got, want
        sets = cold_sets(r, k, v, w, u, s0, dy, ckpt, *(() if ds is None else (ds,)))
        nbytes = 4 * (9 * b * s * h * dh + 2 * h * dh + (3 if with_ds else 2) * b * h * dh * dh
                      + ckpt.numel())
        bound_ms, bound_by = self.bound(nbytes, 16 * b * s * h * dh * dh, TF)
        call = lambda fn: (lambda *t: fn(*t[:7], t[8] if with_ds else None, t[7]))
        self.cases["wkv6_bwd"].append({
            "shape": f"{label}, r/k/v/w/dy ({b},{s},{h},{dh}), state ({b},{h},{dh},{dh})",
            "dtype": "float32", "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(cycle(call(wkv6_bwd), sets)),
            "plain_ms": time_ms(cycle(call(wkv6_bwd_ref), sets[:1]), iters=2,
                                spin=False, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        c = self.cases["wkv6_bwd"][-1]
        print(f"  {'wkv6_bwd':<18} {label:<38} float32  {c['kernel_ms']:.6f} ms "
              f"(bound {bound_ms:.6f} by {bound_by}, plain {c['plain_ms']:.2f}, "
              f"no library call"
              f"{earlier_note('wkv6_bwd', label, 'float32', c['kernel_ms'])})")
        del r, k, v, w, dy, u, s0, ds, ckpt, sets
        torch.cuda.empty_cache()

    def selective_scan_bwd(self, dtype, b, s, label, di=8192, n=16, dt_rank=256,
                           h0_nonzero=False):
        """selective_scan's backward at jamba's widths, as a train step
        calls it (from a zero state, or with ``h0_nonzero`` a random one;
        x, z, B and C strided views of the projections' outputs): the
        forward kernel writes the checkpoints,
        the backward kernel the eight gradients, each within
        SCAN_BWD_TOL[dtype] of the plain backward's (which makes its own
        checkpoints) largest |value|, in its operand's dtype; bit-identical
        on a repeat; timed L2-cold.  Bound: delta, x, z, dout, B, C, a_log,
        d_skip, the state and the checkpoints read once, the gradients of
        all but dout written once (bytes); about 20 float32 operations per (token,
        channel, state) element and 10 per (token, channel) at the float32
        rate."""
        import torch.nn.functional as F
        from repro_torch.kernels.selective_scan.ops import (checkpoints, selective_scan,
                                                            selective_scan_bwd)
        from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
        xz = self.rand((b, s, 2 * di), dtype)
        xz[..., :di] = F.silu(xz[..., :di].float()).to(dtype)
        proj = self.rand((b, s, dt_rank + 2 * n), dtype)
        delta = F.softplus(self.rand((b, s, di), TF) - 4)
        a_log = (torch.log(torch.arange(1, n + 1, device="cuda", dtype=TF))
                 + self.rand((di, n), TF, 0.1))
        d_skip = 1 + self.rand((di,), TF, 0.1)
        h0 = (self.rand((b, di, n), TF, 0.1) if h0_nonzero
              else torch.zeros((b, di, n), device="cuda"))
        dout = self.rand((b, s, di), dtype)

        def ops(d, xz_, p, al, ds, st):
            return (d, xz_[..., :di], xz_[..., di:], p[..., dt_rank:dt_rank + n],
                    p[..., dt_rank + n:], al, ds, st)

        base = (delta, xz, proj, a_log, d_skip, h0)
        ckpt = checkpoints(delta, dtype, n)
        selective_scan(*ops(*base[:5], h0.clone()), ckpt=ckpt)
        got = selective_scan_bwd(*ops(*base), dout, ckpt)
        want = selective_scan_bwd_ref(*ops(*base), dout)
        if not all(torch.equal(a, g) for a, g in zip(
                selective_scan_bwd(*ops(*base), dout, ckpt), got)):
            raise AssertionError(f"selective_scan_bwd {label} {dtype}: two calls differ")
        err, tol = self.leaves_close("selective_scan_bwd", label, dtype, got, want,
                                     SCAN_BWD_TOL[dtype])
        del want
        es = dtype.itemsize
        # delta, x, z and dout read, their three gradients (not dout's)
        # written; B and C read and dB, dC written; a_log, d_skip and the
        # state read and their gradients written; the checkpoints read
        nbytes = ((8 + 5 * es) * b * s * di + 2 * 2 * es * b * s * n
                  + 2 * (4 * di * n + 4 * di + 4 * b * di * n) + 4 * ckpt.numel())
        bound_ms, bound_by = self.bound(nbytes, b * s * di * (20 * n + 10), TF)
        sets = cold_sets(*base, dout, ckpt)
        self.cases["selective_scan_bwd"].append({
            "shape": f"{label}, delta/x/z ({b},{s},{di}), B/C ({b},{s},{n})",
            "dtype": str(dtype)[6:], "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(cycle(lambda *t: selective_scan_bwd(
                *ops(*t[:6]), t[6], t[7]), sets)),
            "plain_ms": time_ms(cycle(lambda *t: selective_scan_bwd_ref(
                *ops(*t[:6]), t[6], t[7]), sets[:1]), iters=2, spin=False, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        c = self.cases["selective_scan_bwd"][-1]
        print(f"  {'selective_scan_bwd':<18} {label:<38} {str(dtype)[6:]:<8} "
              f"{c['kernel_ms']:.6f} ms (bound {bound_ms:.6f} by {bound_by}, plain "
              f"{c['plain_ms']:.2f}, no library call"
              f"{earlier_note('selective_scan_bwd', label, str(dtype)[6:], c['kernel_ms'])})")
        del got, base, xz, proj, delta, dout, ckpt, sets
        torch.cuda.empty_cache()

    def pack(self, dtype, x, t0, t1, label, cold=False):
        import torch.nn.functional as F
        from repro_torch.kernels.pack.ops import pack
        from repro_torch.kernels.pack.ref import pack_ref
        m, k = x.shape[-2:]
        mo, ko = -(-m // t0), -(-k // t1)

        def library(xx):
            xp = F.pad(xx, (0, ko * t1 - k, 0, mo * t0 - m))
            return xp.reshape(*xx.shape[:-2], mo, t0, ko, t1).transpose(-3, -2).contiguous()

        out = pack(x, t0, t1)
        sets = cold_sets(x) if cold else [(x,)]
        self.record("pack", f"{label} {tuple(x.shape)}->{tuple(out.shape)}", dtype,
                    cycle(lambda xx: pack(xx, t0, t1), sets),
                    cycle(lambda xx: pack_ref(xx, t0, t1), sets), cycle(library, sets),
                    (x.numel() + out.numel()) * dtype.itemsize, 0, exact=True,
                    copies=len(sets))

    def unpack(self, dtype, m, k, t0, t1, label):
        from repro_torch.kernels.pack.ops import pack
        from repro_torch.kernels.unpack.ops import unpack, vector_path
        from repro_torch.kernels.unpack.ref import unpack_ref
        ap = pack(self.rand((1, m, k), dtype), t0, t1)
        _, mo, ko, _, _ = ap.shape

        def library():       # the permute/reshape/contiguous chain
            return ap.permute(0, 1, 3, 2, 4).reshape(1, mo * t0, ko * t1)[:, :m, :k].contiguous()

        self.record("unpack", f"{label} {tuple(ap.shape)}->(1, {m}, {k})", dtype,
                    lambda: unpack(ap, m, k), lambda: unpack_ref(ap, m, k), library,
                    (ap.numel() + m * k) * dtype.itemsize, 0, exact=True,
                    vector_path=vector_path(ap, unpack(ap, m, k), k))

    def launch_floor(self):
        """The device time of an empty kernel launched as unpack launches,
        timed as every kernel here is: the launch floor; and of one that
        also waits on its predecessor (griddepcontrol), as unpack must."""
        from repro_torch.kernels.unpack.ops import empty_launch
        like = torch.empty(1, device="cuda")
        self.floor_ms = time_ms(lambda: empty_launch(like))
        self.floor_wait_ms = time_ms(lambda: empty_launch(like, wait=True))
        print(f"  {'unpack':<11} {'empty launch (the launch floor)':<44} "
              f"{self.floor_ms:.6f} ms, waiting on its predecessor "
              f"{self.floor_wait_ms:.6f} ms")

    def ragged(self, dtype, segments, width, label, pages=257, t=16, mp=64,
               hq=9, hkv=3, dh=64):
        """``segments``: [(row, first_pos, n)] laid out back to back in a
        stream of ``width`` positions (the rest padding).  Timed L2-cold
        (each call takes the next of enough copies of q and the pools to
        pass 64 MB) and L2-warm; the library call is the SDPA yardstick."""
        from repro_torch.kernels.ragged_attn.ops import plan_ragged, ragged_attention
        from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref
        rng = np.random.default_rng(len(segments) + width)
        bt = (rng.permutation(pages - 1)[:4 * mp] + 1).astype(np.int32).reshape(4, mp)
        row_ids = np.full(width, -1, np.int32)
        q_pos = np.zeros(width, np.int32)
        pos, need = 0, {}
        for row, first, n in segments:
            row_ids[pos:pos + n] = row
            q_pos[pos:pos + n] = first + np.arange(n)
            need[row] = max(need.get(row, 0), first + n)
            pos += n
        kp = self.rand((pages, t, hkv, dh), dtype)
        vp = self.rand((pages, t, hkv, dh), dtype)
        q = self.rand((width, hq, dh), dtype)
        args = dict(block_tables=torch.from_numpy(bt).cuda(),
                    row_ids=torch.from_numpy(row_ids).cuda(),
                    q_pos=torch.from_numpy(q_pos).cuda())
        plan = plan_ragged(row_ids, q_pos, t, mp, hkv, self.hw.sm_count,
                           group=hq // hkv).to("cuda")
        valid = torch.from_numpy(row_ids >= 0).cuda()
        torch.cuda.set_sync_debug_mode("error")   # no copy back to the host
        try:
            out = ragged_attention(q, kp, vp, plan=plan, **args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if out[~valid].any() or not torch.equal(
                out, ragged_attention(q, kp, vp, plan=plan, **args)):
            raise AssertionError(f"ragged_attn {label} {dtype}: padding not zero "
                                 f"or two calls differ")
        try:
            ragged_attention(q, kp, vp, **args)
        except ValueError:
            pass
        else:
            raise AssertionError("ragged_attn: a CUDA call without a plan ran")
        sdpa, sdpa_args, scatter = self.sdpa_yardstick(q, kp, vp, bt, row_ids, q_pos)
        want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
        err = (scatter(sdpa(*sdpa_args))[valid].float() - want).abs().max().item()
        if err > TOL[dtype] * max(1.0, want.abs().max().item()):
            raise AssertionError(f"SDPA yardstick {label} {dtype}: error {err}")
        es = dtype.itemsize
        page_bytes = t * hkv * dh * es * 2                       # K and V
        kv_pages = sum(-(-n // t) for n in need.values())
        pad_pages = 1 if (row_ids < 0).any() else 0              # row 0's page 0
        flops = sum(4 * hq * dh * (int(p) + 1) for p in q_pos[row_ids >= 0])
        sets = cold_sets(q, kp, vp)
        lib_sets = cold_sets(*sdpa_args)
        warm_ms = time_ms(lambda: ragged_attention(q, kp, vp, plan=plan, **args))
        self.record("ragged_attn", f"{label} W={width} segs={len(segments)}", dtype,
                    cycle(lambda a, b, c: ragged_attention(a, b, c, plan=plan, **args), sets),
                    cycle(lambda a, b, c: ragged_attention_ref(a, b, c, **args), sets),
                    cycle(sdpa, lib_sets),
                    2 * q.numel() * es + (kv_pages + pad_pages) * page_bytes
                    + 3 * width * 4 + bt.nbytes, flops,
                    select=lambda t: t[valid],   # padding rows: the plain version's garbage
                    split=plan.splits, tiles=plan.tiles, kernel_l2_warm_ms=warm_ms,
                    copies=len(sets), library_err=err)

    @staticmethod
    def sdpa_yardstick(q, kp, vp, bt, row_ids, q_pos):
        """One ``F.scaled_dot_product_attention(..., enable_gqa=True)`` call
        with a boolean mask, on K/V already gathered per row and padded to
        the longest row (queries grouped by row, padded likewise).  Returns
        (attend, args, scatter): ``scatter(attend(*args))`` is [W, Hq, dh]
        at the valid positions; only ``attend`` is timed."""
        import torch.nn.functional as F
        t = kp.shape[1]
        rows = sorted(set(row_ids[row_ids >= 0].tolist()))
        lq = max(int((row_ids == r).sum()) for r in rows)
        lk = max(int(q_pos[row_ids == r].max()) + 1 for r in rows)
        w, hq, dh = q.shape
        hkv = kp.shape[2]
        qg = torch.zeros((len(rows), hq, lq, dh), dtype=q.dtype, device=q.device)
        kg = torch.zeros((len(rows), hkv, lk, dh), dtype=q.dtype, device=q.device)
        vg = torch.zeros_like(kg)
        mask = torch.zeros((len(rows), 1, lq, lk), dtype=torch.bool, device=q.device)
        mask[..., 0] = True                    # padded queries: no empty softmax
        where = []
        for i, r in enumerate(rows):
            idx = np.flatnonzero(row_ids == r)
            n_keys = int(q_pos[idx].max()) + 1
            pg = torch.from_numpy(bt[r, :-(-n_keys // t)].astype(np.int64)).cuda()
            kg[i, :, :n_keys] = kp[pg].reshape(-1, hkv, dh)[:n_keys].transpose(0, 1)
            vg[i, :, :n_keys] = vp[pg].reshape(-1, hkv, dh)[:n_keys].transpose(0, 1)
            qg[i, :, :len(idx)] = q[torch.from_numpy(idx).cuda()].transpose(0, 1)
            kv = torch.arange(lk, device=q.device)
            qp = torch.from_numpy(q_pos[idx].astype(np.int64)).cuda()
            mask[i, 0, :len(idx)] = kv[None, :] <= qp[:, None]
            where.append((i, torch.from_numpy(idx).cuda()))

        def attend(qq, kk, vv, mm):
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm,
                                                  enable_gqa=True)

        def scatter(o):
            full = torch.zeros((w, hq, dh), dtype=o.dtype, device=o.device)
            for i, idx in where:
                full[idx] = o[i, :, :len(idx)].transpose(0, 1)
            return full

        return attend, (qg, kg, vg, mask), scatter

    def run(self, ladder):
        """``ladder``: the bf16 engine's flat widths; the gate linear runs at
        each (at 8 and 512 in float32)."""
        e = self.rand((49152, 576), BF, 0.02)
        self.launch_floor()
        for dtype in (BF, TF):
            lay = self.layout(dtype)
            m_r = lay.m_r
            dec, pre = 16 if dtype is BF else 8, 512
            for w in sorted(set(ladder) | {dec} if dtype is BF else {dec, pre}):
                self.mmt4d(dtype, w, 576, 1536, "silu",
                           "gate decode" if w == dec else f"gate W={w}")
            self.mmt4d(dtype, dec, 576, 576, None, "q/o decode")
            self.mmt4d(dtype, dec, 576, 192, None, "k/v decode")
            self.mmt4d(dtype, dec, 1536, 576, None, "down decode")
            self.mmt4d(dtype, 4, 576, 49152, None, "tied head")
            self.mmt4d_unpacked(dtype, dec, 576, 576, "q exit unpacked")
            self.mmt4d_unpacked(dtype, dec, 576, 192, "k/v exit unpacked")
            self.mmt4d_unpacked(dtype, 4, 576, 49152, "tied head unpacked")
            self.pack(dtype, self.rand((1, dec, 576), dtype), m_r, 128, "stream entry")
            self.pack(dtype, self.rand((1, pre, 576), dtype), m_r, 128, "O-linear input")
            self.pack(dtype, e.to(dtype), 128, 128, "tied head embed", cold=True)
            self.pack(dtype, self.rand((576, 1536), dtype).T, 128, 128, "prepack w^T")
            self.unpack(dtype, dec, 576, m_r, 128, "final stream decode")
            self.unpack(dtype, pre, 576, m_r, 128, "Q exit prefill")
            self.unpack(dtype, 4, 49152, m_r, 128, "logits")
            self.ragged(dtype, [(0, 300, 1), (1, 511, 1), (2, 95, 1), (3, 1000, 1)],
                        16, "decode rows")
            self.ragged(dtype, [(0, 1000, 1)], 16, "long decode row")
            self.ragged(dtype, [(0, 600, 1), (1, 64, 1), (2, 0, 300), (3, 128, 206)],
                        pre, "mixed prefill")
            # whisper-small's static path (d 768, d_ff 3072, vocab 51865,
            # weights packed on every call): the biased gelu up-projection
            # at decode and over the encoder's 4 x 256 frames, the tied
            # head's partial last tile, the per-call weight packs, the
            # encoder output's unpack
            self.mmt4d(dtype, 4, 768, 3072, "gelu", "whisper up decode", bias=True)
            self.mmt4d(dtype, 1024, 768, 3072, "gelu", "whisper up encoder", bias=True)
            self.mmt4d_unpacked(dtype, 4, 768, 51865, "whisper tied head unpacked")
            self.pack(dtype, self.rand((768, 3072), dtype).T, 128, 128,
                      "whisper up w^T (per call)")
            self.pack(dtype, self.rand((51865, 768), dtype, 0.02), 128, 128,
                      "whisper tied head embed (per call)", cold=True)
            self.unpack(dtype, 1024, 768, m_r, 128, "whisper encoder output")

    def run_d128(self):
        """ragged_attn at d_head 128, both dtypes, at the served configs'
        heads: Qwen3-8B's decode rows (32 query heads over 8, g = 4) and a
        mixed prefill step of its flat ladder's widest width, ChatGLM3-6B's
        decode rows (32 over 2, g = 16: tiles of 8 positions)."""
        for dtype in (BF, TF):
            self.ragged(dtype, [(0, 300, 1), (1, 511, 1), (2, 95, 1), (3, 1000, 1)],
                        16, "d128 qwen3-8b decode rows", hq=32, hkv=8, dh=128)
            self.ragged(dtype, [(0, 300, 1), (1, 511, 1), (2, 95, 1), (3, 1000, 1)],
                        16, "d128 chatglm3-6b decode rows", hq=32, hkv=2, dh=128)
            self.ragged(dtype, [(0, 600, 1), (1, 64, 1), (2, 0, 300), (3, 128, 206)],
                        512, "d128 qwen3-8b mixed prefill", hq=32, hkv=8, dh=128)

    def run_scaled(self):
        """The serving path's kernels at this descriptor's tiles (a scaled
        one: n_r = k_r = 256 or 512), both dtypes: mmt4d at gate decode,
        q/o, k/v, down and the tied head, packed and with the unpacked
        store; pack at stream entry, the tied head's embed (per call) and
        a prepacked W^T; unpack of the final stream; the gradient kernels
        at the gate and the tied head (4,096 tokens)."""
        e = self.rand((49152, 576), BF, 0.02)
        for dtype in (BF, TF):
            lay = self.layout(dtype)
            dec = 16 if dtype is BF else 8
            self.mmt4d(dtype, dec, 576, 1536, "silu", "gate decode")
            self.mmt4d(dtype, dec, 576, 576, None, "q/o decode")
            self.mmt4d(dtype, dec, 576, 192, None, "k/v decode")
            self.mmt4d(dtype, dec, 1536, 576, None, "down decode")
            self.mmt4d(dtype, 4, 576, 49152, None, "tied head")
            self.mmt4d_unpacked(dtype, dec, 576, 576, "q exit unpacked")
            self.mmt4d_unpacked(dtype, dec, 576, 192, "k/v exit unpacked")
            self.mmt4d_unpacked(dtype, 4, 576, 49152, "tied head unpacked")
            self.pack(dtype, self.rand((1, dec, 576), dtype), lay.m_r, lay.k_r,
                      "stream entry")
            self.pack(dtype, e.to(dtype), lay.n_r, lay.k_r, "tied head embed",
                      cold=True)
            self.pack(dtype, self.rand((576, 1536), dtype).T, lay.n_r, lay.k_r,
                      "prepack w^T")
            self.unpack(dtype, dec, 576, lay.m_r, lay.k_r, "final stream decode")
            self.grads(dtype, TRAIN_BATCH * TRAIN_SEQ, 576, 1536, "silu", "gate")
            self.grads(dtype, TRAIN_BATCH * TRAIN_SEQ, 576, 49152, None, "tied head")

    def f32_chunk_identity(self) -> int:
        """The float32 mmt4d kernel stages k in chunks of F32_CHUNK; at this
        descriptor's tiles (128 wide) it is held bit for bit to the same
        kernel staging whole tiles (``F32_CHUNK = k_r``: the kernel before k
        was chunked) at the serving shapes, packed and unpacked store.
        Returns the number of cases."""
        from repro_torch.core import packing
        from repro_torch.kernels.mmt4d import ops
        lay = self.layout(TF)
        cases, chunk = 0, ops.F32_CHUNK
        for m, k, n, act in ((8, 576, 1536, "silu"), (8, 576, 576, None),
                             (8, 576, 192, None), (8, 1536, 576, None),
                             (4, 576, 49152, None), (512, 576, 1536, "silu")):
            ap = packing.pack_lhs(self.rand((m, k), TF), lay)
            bp = packing.pack_rhs(self.rand((k, n), TF, k ** -0.5), lay)
            for to in (None, (m, n)):
                got = ops.mmt4d(ap, bp, activation=act, unpack_to=to)
                ops.F32_CHUNK = lay.k_r
                try:
                    whole = ops.mmt4d(ap, bp, activation=act, unpack_to=to)
                finally:
                    ops.F32_CHUNK = chunk
                if not torch.equal(got, whole):
                    raise AssertionError(f"f32 mmt4d {m}x{k}x{n} {to}: chunked k "
                                         f"differs from whole-tile staging")
                cases += 1
        print(f"  mmt4d f32, k staged in chunks of 64: bit for bit the whole-tile "
              f"staging at {lay.n_r}-wide tiles in {cases} cases (gate, q/o, k/v, "
              f"down, tied head at decode, the gate over 512 tokens; packed and "
              f"unpacked store)")
        return cases

# the three serving step families: engine arguments at the f32 parity
# drain (seq_len 64) and at the full-width bf16 drain (seq_len 1024)
FAMILIES_F32 = {"flat": dict(chunk_tokens=32),
                "dense": dict(chunk_tokens=32, flat=False),
                "monolithic": {}}
FAMILIES_BF16 = {"flat": dict(chunk_tokens=128),
                 "dense": dict(chunk_tokens=128, flat=False),
                 "monolithic": {}}


def state_leaves(caches) -> list:
    """The recurrent state of a cache tree: every tensor but the page
    pools (``*_pages``), which a step writes at its own positions."""
    out = []
    for k, v in caches.items():
        if isinstance(v, dict):
            out.extend(state_leaves(v))
        elif not k.endswith("_pages"):
            out.append(v)
    return out


class ReplayCheck:
    """Stands in for an engine's compiled step: passes every call through,
    and for the first ``shapes`` distinct input signatures of the drain
    also runs the same step on the same inputs and state the other way,
    and requires the replay's logits bit for bit on the valid rows (an
    inert row of the paged step attends over nothing: its logits are
    garbage in both) and the same recurrent state after both.  A
    signature captured before the call replays, and the model's eager
    step method runs after it; one the call captures (a recurrent model's
    exact-length prefill, captured at its first use) ran eagerly, and its
    graph replays after it.  The recurrent state (``state_leaves``) is
    put back between the two; both calls write the same K/V to the same
    places.  The second call's launches (and a moe model's routed and
    kept assignments) are taken back out of the counts."""

    def __init__(self, step, shapes: int = 2):
        self.step, self.shapes, self.checked = step, shapes, []

    def __call__(self, params, caches, *args, plan=None, graphs=None):
        sig = self.step.signature(args, plan)
        if len(self.checked) >= self.shapes or sig in self.checked:
            return self.step(params, caches, *args, plan=plan, graphs=graphs)
        from repro_torch import kernels
        from repro_torch.models.moe import DropCounter
        dev = self.step.model.device
        captured = self.step.signature(args, plan, caches) not in graphs.graphs
        states = state_leaves(caches)
        start = [t.clone() for t in states]
        out, caches = self.step(params, caches, *args, plan=plan, graphs=graphs)
        out = out.clone()           # a replay's output is the graph's own
        first = [t.clone() for t in states]
        for t, s0 in zip(states, start):
            t.copy_(s0)
        before = kernels.counters()
        # this device's counter only: the CPU's thread may be counting its own
        counter = DropCounter._installed.get(torch.device(dev).type)
        drops = [] if counter is None else [(counter, counter.counts.clone())]
        if captured:                # the call ran eagerly: now replay
            again, _ = self.step(params, caches, *args, plan=plan, graphs=graphs)
        else:
            extra = {} if plan is None else {"plan": plan.to(dev)}
            again, _ = self.step.fn(params, caches,
                                    *(None if a is None else a.to(dev)
                                      for a in args), **extra)
        after = kernels.counters()
        kernels.add_counts({k: after[k] - before[k] for k in after}, -1)
        for c, counts in drops:            # nor the second call's routing
            c.counts.copy_(counts)
        valid = (args[3] > 0).to(dev) if self.step.kind == "paged" else \
            torch.ones(out.shape[0], dtype=torch.bool, device=dev)
        if not torch.equal(out[valid], again[valid]):
            err = (out[valid].float() - again[valid].float()).abs().max().item()
            raise AssertionError(f"{self.step.kind} step {sig}: the graph's "
                                 f"replay differs from the eager call "
                                 f"(max |diff| {err:.3e})")
        if not all(torch.equal(a, b) for a, b in zip(first, states)):
            raise AssertionError(f"{self.step.kind} step {sig}: the replay's "
                                 f"recurrent state differs from the eager "
                                 f"call's")
        self.checked.append(sig)
        return out, caches


def attach_replay_check(eng) -> ReplayCheck:
    if eng.flat:
        eng._flat_step = check = ReplayCheck(eng._flat_step)
    else:
        eng._paged_step = check = ReplayCheck(eng._paged_step)
    return check


def count_model_calls(eng) -> list:
    """Wrap the engine's model call; returns the list each call's float32
    logits are appended to."""
    calls = []
    name = "_run_flat" if eng.flat else "_run_paged"
    run = getattr(eng, name)
    setattr(eng, name, lambda *a, **k: calls.append(run(*a, **k)) or calls[-1])
    return calls


class PickRecorder:
    """Wraps an engine's pick: records every pick as (rid, position) ->
    (token, top-2 margin of the row it was picked from: the logits, or for
    a sampled pick the logits over the temperature plus the Gumbel noise),
    and the host seconds the recording itself took."""

    def __init__(self, eng):
        from repro_torch.serving import sampling
        self.sampling, self.pick, self.picks, self.seconds = sampling, eng._pick, {}, 0.0
        eng._pick = self

    def __call__(self, row, req, greedy, seed):
        tok = self.pick(row, req, greedy, seed)
        t0 = time.perf_counter()
        z = row
        if not greedy and req.temperature > 0.0:
            s = seed if req.seed is None else req.seed
            key = self.sampling.pick_key(s, req.rid, len(req.out_tokens))
            z = (row / np.float32(req.temperature) if req.temperature != 1.0 else row) \
                + self.sampling.gumbel(key, row.shape[0])
        top2 = np.partition(z, -2)[-2:]
        self.picks[(req.rid, len(req.out_tokens))] = (tok, float(top2[1] - top2[0]))
        self.seconds += time.perf_counter() - t0
        return tok


def compare_picks(a: dict, b: dict, tol: float, label: str) -> dict:
    """Two runs' picks, request by request in position order: equal, or the
    first difference of a request at a pick whose top-2 margin (in either
    run) is below ``tol``, after which that request is compared no
    further (its streams have parted).  Any other difference raises.
    Returns the counts: picks compared, picks below ``tol`` in either run,
    requests that parted and the largest margin at a parting."""
    out = {"picks": 0, "low_margin_picks": 0, "parted": 0, "parted_margin": 0.0}
    for rid in sorted({r for r, _ in a} | {r for r, _ in b}):
        pos = sorted({p for r, p in a if r == rid} | {p for r, p in b if r == rid})
        for p in pos:
            ta, ma = a.get((rid, p), (None, 0.0))
            tb, mb = b.get((rid, p), (None, 0.0))
            out["picks"] += 1
            out["low_margin_picks"] += int(min(ma, mb) < tol)
            if ta != tb:
                if not min(ma, mb) < tol:
                    raise AssertionError(
                        f"{label}: rid {rid} position {p}: {ta} vs {tb} at "
                        f"top-2 margins {ma:.3e} / {mb:.3e} (tolerance {tol:g})")
                out["parted"] += 1
                out["parted_margin"] = max(out["parted_margin"], min(ma, mb))
                print(f"  {label}: rid {rid} parts at position {p} ({ta} vs {tb}, "
                      f"top-2 margins {ma:.3e} / {mb:.3e})")
                break
    print(f"  {label}: {out['picks']} picks compared, "
          f"{out['low_margin_picks']} with a top-2 margin below {tol:g}, "
          f"{out['parted']} requests parted")
    return out


# the CPU's twin of each card descriptor: the mirrored TPU preset with the
# same tiles (lanes, sublanes, mxu_k)
CPU_TWIN = {"h100": "tpu_v5e", "h100_vl256": "tpu_vl256", "h100_vl512": "tpu_vl512"}


def descriptor(device, hw_name):
    """``hw_name``'s descriptor on ``device``: the card's own (scaled) on
    the card, its mirrored TPU twin on the CPU."""
    from repro_torch.core.hardware import query
    return query(device, hw_name if device == "cuda" else CPU_TWIN[hw_name])


def serve_f32(device, cfg, prompts, family, greedy=True, policy="scalable",
              hw_name="h100", params=None, new=8, drops=False):
    """A drain at full width in float32 through one step family, greedy or
    sampled (seed 11; the requests' temperatures 1.0, 0.7, 1.3 and 0 in
    turn), ``new`` tokens each, under a layout policy and descriptor (the
    CPU: the descriptor's TPU twin); returns tokens, the first model call's
    logits, each pick's (rid, position) -> (token, perturbed top-2
    margin), and on the card the graphs captured at warmup (the drain
    captures nothing more but a recurrent model's exact-length prefill
    graphs) and the shapes checked replay against eager (``drops``: also
    the drain's moe dropped
    fraction, a DropCounter installed before warmup).  ``params``: the
    weights (default: a CPU generator's, seed 0)."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import DropCounter
    from repro_torch.serving.engine import Engine
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    layout_policy=policy)
    model = build_model(cfg, run, ShapeSpec("serve", 64, 4, "decode"),
                        hw=descriptor(device, hw_name), device=device)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    counter = DropCounter(device).install() if drops else None
    eng = Engine(model, params, device=device, max_slots=4, page_tokens=16,
                 **FAMILIES_F32[family])
    info = {}
    if device == "cuda":
        eng.warmup()
        info["captures"] = eng.stats()["captures"]
        check = attach_replay_check(eng)
    if counter is not None:
        counter.reset()
    calls, picks = count_model_calls(eng), PickRecorder(eng)
    rids = [eng.add_request(p, new, temperature=TEMPERATURES[i % 4])
            for i, p in enumerate(prompts)]
    fin = {r.rid: r.out_tokens for r in eng.drain(greedy=greedy, seed=11)}
    if counter is not None:
        info["dropped_frac"] = counter.dropped_frac()
        counter.uninstall()
    if device == "cuda":
        # exact-length prefills (a recurrent model) capture one graph each
        want = dict(info["captures"])
        if eng._bucket == 1 and not eng.chunked:
            want["paged"] += len({len(p) for p in prompts})
        if eng.stats()["captures"] != want:
            raise AssertionError(f"f32 {family} drain captured after warmup: "
                                 f"{info['captures']} -> {eng.stats()['captures']}")
        info["replay_checked"] = len(check.checked)
    return [fin[r] for r in rids], calls[0], picks.picks, info


def compare_f32(cfg, prompts, family, greedy=True, policy="scalable",
                hw_name="h100") -> dict:
    """The f32 drain of one family on the card and on the CPU (under a
    layout policy and descriptor; the CPU's in the worker process, compared
    when it ends).  Greedy: identical tokens (the first differing pick,
    with both top-2 margins, is printed before failing).  Sampled:
    identical tokens apart from a pick whose perturbed top-2 margin is
    below F32_MARGIN, whose request is compared no further; the count of
    such picks is printed.  The returned dict gains the comparison's
    numbers when it is made."""
    t0 = time.perf_counter()
    layout = dict(policy=policy, hw_name=hw_name)
    cpu = CPU_RUNS.proc(serve_f32, "cpu", cfg, prompts, family, greedy, **layout)
    cuda_toks, cuda_first, cuda_picks, info = serve_f32("cuda", cfg, prompts,
                                                        family, greedy, **layout)
    mode = "greedy" if greedy else "sampled"
    if (policy, hw_name) != ("scalable", "h100"):
        mode = f"{mode} {policy} {hw_name}"
    print(f"  {family} {mode}: card graphs {info['captures']}, replay = eager "
          f"bit for bit at {info['replay_checked']} shapes "
          f"({time.perf_counter() - t0:.1f} s)")
    if info["replay_checked"] < 2:
        raise AssertionError(f"{family}: replay checked at "
                             f"{info['replay_checked']} shapes, not 2")
    out = {"tokens": cuda_toks, **info}

    def check(res):
        cpu_toks, cpu_first, cpu_picks, _ = res
        diff = float(np.abs(cuda_first - cpu_first).max())
        print(f"  {family} {mode}: first call max |logit diff| {diff:.3e}")
        cmp = compare_picks(cuda_picks, cpu_picks, 0.0 if greedy else F32_MARGIN,
                            f"f32 {mode} {family} card vs cpu")
        if greedy and cuda_toks != cpu_toks:
            raise AssertionError(f"{family}: greedy tokens differ: card {cuda_toks} "
                                 f"cpu {cpu_toks}")
        out.update(first_logit_diff=diff, **cmp)
    CPU_RUNS.defer(f"f32 {mode} {family}", cpu, check)
    return out


def drain_bf16(cfg, family, prompts, eng=None, expected=None) -> dict:
    """The bf16 drain of one family at full width: warmup (its graphs,
    seconds and the device memory it reserved), then the requests with
    every wrapper count set to 0 just before and read just after; every
    request finishes, no graph is captured during the drain, replay equals
    eager at two shapes, and each model call launches the expected
    kernels (``expected``: (counts per call, unpacked stores per call);
    default SmolLM2-135M's)."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    if eng is None:
        model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                            device="cuda")
        eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                     device="cuda", max_slots=4, page_tokens=16,
                     **FAMILIES_BF16[family])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    graphs = eng.stats()["compiles"]
    # what warmup keeps: the graphs' memory pool (which empty_cache cannot
    # release while the graphs live) and their static inputs and outputs
    torch.cuda.empty_cache()
    warm_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    check = attach_replay_check(eng)
    calls = count_model_calls(eng)
    rids = [eng.add_request(p, 32) for p in prompts]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    finished = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    unpacked = kernels.wrappers()["mmt4d"].unpacked_stores
    delattr(eng, "_run_flat" if eng.flat else "_run_paged")   # the counter
    st = eng.stats()
    n = len(calls)
    ntok = sum(len(r.out_tokens) for r in finished)
    print(f"  {family}: warmup {warm_s:.3f} s, {sum(graphs.values())} graphs "
          f"{graphs}, {warm_mib:.1f} MiB kept by warmup (graph pool and buffers); {st['steps']} steps, "
          f"{n} model calls, {wall:.3f} s wall, {1e3 * wall / st['steps']:.3f} ms "
          f"per step, {ntok} tokens, {ntok / wall:.1f} generated tokens/s")
    print(f"  {family}: launches {launches}, per model call "
          f"{ {k: v / n for k, v in launches.items()} }, mmt4d unpacked stores "
          f"{unpacked} ({unpacked / n} per call); replay = eager bit for bit "
          f"at {len(check.checked)} shapes")
    if sorted(r.rid for r in finished) != sorted(rids) \
            or any(r.finish_reason != "length" or len(r.out_tokens) != 32
                   for r in finished):
        raise AssertionError(f"{family}: not every request finished: "
                             f"{[(r.rid, r.finish_reason) for r in finished]}")
    if eng.pool.num_used != 0 or not all(np.isfinite(c).all() for c in calls):
        raise AssertionError(f"{family}: pool used {eng.pool.num_used}, or "
                             f"non-finite logits")
    if st["compiles"] != graphs or st["captures"] != graphs:
        raise AssertionError(f"{family}: captured during the drain: {graphs} -> "
                             f"{st['compiles']}, {st['captures']}")
    if len(check.checked) < 2:
        raise AssertionError(f"{family}: replay checked at {len(check.checked)} "
                             f"shapes, not 2")
    if expected is None:
        expected = (EXPECTED_PER_STEP if eng.flat else EXPECTED_PER_PAGED_CALL,
                    EXPECTED_UNPACKED_PER_STEP)
    for k, per in expected[0].items():
        if launches[k] != per * n:
            raise AssertionError(f"{family} {k}: {launches[k]} launches over {n} "
                                 f"model calls, expected {per} per call")
    if unpacked != expected[1] * n:
        raise AssertionError(f"{family} mmt4d: {unpacked} unpacked stores over "
                             f"{n} calls, expected {expected[1]} per call")
    return {"family": family, "steps": st["steps"], "model_calls": n,
            "wall_s": wall, "ms_per_step": 1e3 * wall / st["steps"],
            "tokens": ntok, "tokens_per_s": ntok / wall, "warmup_s": warm_s,
            "graphs": graphs, "warmup_kept_mib": warm_mib,
            "launches": launches, "unpacked_stores": unpacked,
            "replay_checked": len(check.checked), "stats": st, "engine": eng}


def leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def check_path_launches(label, launches, flat, rwkv=False, mamba=False) -> None:
    """Every kernel of the path ran in the drain just read: all four
    serving kernels in the flat family, all but ragged_attn in the paged
    ones (which attend through PyTorch and must not launch it), wkv6 where
    the model has RWKV layers (``rwkv``) and selective_scan where it has
    mamba layers (``mamba``), each only there; a drain launches no
    gradient kernel."""
    for k, n in launches.items():
        if (n == 0) != (k in GRAD_KERNELS + RECURRENT_GRAD
                        or (k == "wkv6" and not rwkv)
                        or (k == "selective_scan" and not mamba)
                        or (k == "ragged_attn" and not flat)):
            raise AssertionError(f"{label}: {k} launched {n} times")


def timed_drain(eng, reqs, greedy, seed, label, staggered=False) -> dict:
    """Queue ``reqs`` ((prompt, max_new, temperature) each) and drain them,
    recording every pick, with the wrapper counts set to 0 just before and
    read just after; checks that the drain captured no graph (the engine's
    and its draft model's) and that every kernel of the path ran.
    ``staggered``: request i arrives at 2i on a clock that advances one
    per step, so admissions see earlier requests' cached pages."""
    from repro_torch import kernels
    rec = eng._pick if isinstance(eng._pick, PickRecorder) else PickRecorder(eng)
    rec.picks, rec.seconds = {}, 0.0
    st0 = eng.stats()
    rids = [eng.add_request(p, n, temperature=t,
                            arrival=float(2 * i) if staggered else 0.0)
            for i, (p, n, t) in enumerate(reqs)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fin, clock = [], 0.0
    while eng.scheduler.has_work:
        fin.extend(eng.step(now=clock if staggered else None, greedy=greedy,
                            seed=seed))
        clock += 1.0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    if sorted(r.rid for r in fin) != sorted(rids) or any(
            r.finish_reason != "length" for r in fin):
        raise AssertionError(f"{label}: not every request finished")
    if st["captures"] != st0["captures"] or (
            "speculative" in st and st["speculative"]["drafter"].get("captures")
            != st0["speculative"]["drafter"].get("captures")):
        raise AssertionError(f"{label}: captured during the drain")
    check_path_launches(label, launches, eng.flat,
                        rwkv="rwkv" in eng.model.cfg.layer_types,
                        mamba="mamba" in eng.model.cfg.layer_types)
    steps = st["steps"] - st0["steps"]
    ntok = sum(len(r.out_tokens) for r in fin)
    host = wall - rec.seconds
    out = {"wall_s": wall, "recording_s": rec.seconds, "steps": steps,
           "tokens": ntok, "tokens_per_s": ntok / host,
           "ms_per_step": 1e3 * host / max(1, steps),
           "prefill_tokens": st["prefill_tokens"] - st0["prefill_tokens"],
           "launches": launches, "picks": dict(rec.picks)}
    extra = ""
    if "speculative" in st:
        sp, sp0 = st["speculative"], st0["speculative"]
        drafted = sp["drafted"] - sp0["drafted"]
        out.update(drafted=drafted, accepted=sp["accepted"] - sp0["accepted"],
                   rollback_pages=sp["rollback_pages"] - sp0["rollback_pages"])
        out["acceptance_rate"] = out["accepted"] / max(1, drafted)
        extra = (f", acceptance {out['acceptance_rate']:.3f} ({out['accepted']}/"
                 f"{drafted}), rollback pages {out['rollback_pages']}")
    print(f"  {label}: {steps} steps, {ntok} tokens, {wall:.3f} s wall "
          f"({rec.seconds:.3f} s of it recording picks), "
          f"{out['ms_per_step']:.3f} ms per step, {out['tokens_per_s']:.1f} "
          f"generated tokens/s, prefill tokens {out['prefill_tokens']}{extra}")
    return out


def prefix_trace(vocab, n=12, sys_tokens=256, seed=0):
    """The shared-system-prompt trace of the JAX package's serving
    benchmark (``make_prefix_trace``), drawn with numpy: one system prompt
    of ``sys_tokens`` plus a 2-6-token suffix per request, 3-16 new
    tokens; the temperatures cycle through TEMPERATURES.  The last request
    is the bare system prompt, whole pages all cached by then: its prefill
    restarts inside the last shared page, which is copied first."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, vocab, sys_tokens)
    reqs = [(np.concatenate([sysp, rng.integers(0, vocab, int(rng.integers(2, 7)))]),
             int(rng.integers(3, 17)), TEMPERATURES[i % 4]) for i in range(n - 1)]
    return reqs + [(sysp, 8, TEMPERATURES[(n - 1) % 4])]


def spec_trace(vocab, n=8, seed=0):
    """The speculative trace of the JAX package's serving benchmark
    (``make_spec_trace``), drawn with numpy: a 4-token motif tiled to at
    most 16 tokens per prompt, 16-32 new tokens."""
    rng = np.random.default_rng(seed)
    return [(np.tile(rng.integers(0, vocab, 4), int(rng.integers(2, 5)))[:16],
             int(rng.integers(16, 33)), TEMPERATURES[i % 4]) for i in range(n)]


def serve_variants(cfg, dtype, families) -> dict:
    """Prefix cache and speculation at full width in one dtype, each
    family: engines over one model (signatures per model, graphs per
    engine), each warmed, then the spec trace greedy and sampled and (the
    baseline and the cache) the prefix trace greedy and sampled, in that
    order on every engine, so the request ids, and the sampled keys, match.
    Variants: "off" (the baseline), "cache" (prefix_cache=True), "ngram"
    and "draft" (spec_tokens=2 with NgramDrafter and with
    DraftModelDrafter over SmolLM2-135M cut to 2 layers).  Each variant's
    picks are held to the baseline's under the dtype's margin rule."""
    import dataclasses
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.speculative import DraftModelDrafter
    name = str(dtype)[6:]
    run = RunConfig(param_dtype=name, compute_dtype=name)
    shape = ShapeSpec("serve", 1024, 4, "decode")
    model = build_model(cfg, run, shape, device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    dmodel = build_model(dataclasses.replace(cfg, n_layers=2), run, shape,
                         device="cuda")
    dparams = dmodel.init(torch.Generator().manual_seed(7))
    tol = F32_MARGIN if dtype is TF else BF16_MARGIN
    traces = {"spec": spec_trace(cfg.vocab), "prefix": prefix_trace(cfg.vocab)}
    out = {}
    for family in families:
        base = {}
        for variant in ("off", "cache", "ngram", "draft"):
            kw = dict(FAMILIES_BF16[family])
            if variant == "cache":
                kw["prefix_cache"] = True
            elif variant != "off":
                kw["spec_tokens"] = 2
                if variant == "draft":
                    kw["drafter"] = DraftModelDrafter(dmodel, dparams)
            eng = Engine(model, params, device="cuda", max_slots=4,
                         page_tokens=16, **kw)
            t0 = time.perf_counter()
            eng.warmup()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            pools = {id(t): t.data_ptr() for t in leaves(eng.caches)}
            if variant == "cache":
                # the page copy: in place, and nothing read back to the host
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.pool.page_copier(0, 0)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            st = eng.stats()
            dcap = st.get("speculative", {}).get("drafter", {}).get("captures")
            print(f"  {name} {family} {variant}: warmup {warm_s:.3f} s, captures "
                  f"{st['captures']}" + (f", draft model {dcap}" if dcap else ""))
            runs = {}
            for trace in ("spec", "prefix") if variant in ("off", "cache") else ("spec",):
                for greedy in (True, False):
                    mode = "greedy" if greedy else "sampled"
                    label = f"{name} {family} {variant} {trace} {mode}"
                    r = timed_drain(eng, traces[trace], greedy, 5, label,
                                    staggered=trace == "prefix")
                    if variant == "off":
                        base[f"{trace} {mode}"] = r
                    else:
                        r["vs_off"] = compare_picks(base[f"{trace} {mode}"]["picks"],
                                                    r["picks"], tol,
                                                    f"{label} vs off")
                    runs[f"{trace} {mode}"] = r
            if {id(t): t.data_ptr() for t in leaves(eng.caches)} != pools:
                raise AssertionError(f"{name} {family} {variant}: a KV pool "
                                     f"was reallocated or rebound")
            if variant == "cache":
                off_pf = base["prefix greedy"]["prefill_tokens"]
                on_pf = runs["prefix greedy"]["prefill_tokens"]
                pc = eng.stats()["prefix_cache"]
                eng.prefix_cache.clear()
                ledger, pool = eng.pool.ledger(), eng.pool
                balance = pool.total_allocs + pool.total_shares - pool.total_frees
                print(f"  {name} {family} cache: prefill tokens {on_pf} with the "
                      f"cache, {off_pf} without ({on_pf / off_pf:.3f}x); hits "
                      f"{pc['hits']} of {pc['lookups']} lookups, {pc['hit_tokens']} "
                      f"hit tokens, {pc['cow_copies']} copy-on-write copies; after "
                      f"clear(): {len(ledger['refs'])} live pages, "
                      f"{len(ledger['free'])} free of {pool.usable_pages}, "
                      f"allocs + shares - frees = {balance}")
                if on_pf > 0.5 * off_pf or ledger["refs"] or balance \
                        or len(ledger["free"]) != pool.usable_pages \
                        or pc["cow_copies"] < 2:
                    raise AssertionError(f"{name} {family} cache: prefill "
                                         f"{on_pf} vs {off_pf}, or the pool "
                                         f"does not balance")
            out[(family, variant)] = {"warmup_s": warm_s, "captures": st["captures"],
                                      "draft_captures": dcap, "runs": runs,
                                      **({"prefix_cache": pc} if variant == "cache"
                                         else {})}
            del eng
            gc.collect()
    for r in out.values():
        for run_ in r["runs"].values():
            run_.pop("picks", None)
    return out


def c1_two_engines(bf16_engines) -> dict:
    """Two warmed engines of one family over one model: the second warmup
    leaves the model's trace_counts where they were, each engine counts
    its own captures, and once the second is dropped the device memory it
    took (its graphs, their static buffers and pool, its prepacked
    weights and KV pools) comes back."""
    import gc
    from repro_torch.serving.engine import Engine
    out = {}
    for family, first in bf16_engines.items():
        model = first.model
        counts = dict(model.trace_counts)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        second = Engine(model, model.init(torch.Generator().manual_seed(1)),
                        device="cuda", max_slots=4, page_tokens=16,
                        **FAMILIES_BF16[family])
        second.warmup()
        torch.cuda.synchronize()
        alloc1 = torch.cuda.memory_allocated()
        caps = (first.stats()["captures"], second.stats()["captures"])
        after = dict(model.trace_counts)
        del second
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc2, res2 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        print(f"  {family}: trace_counts {counts} -> {after} at the second "
              f"warmup; captures {caps[0]} and {caps[1]}; allocated "
              f"{alloc0 / 2**20:.1f} -> {alloc1 / 2**20:.1f} -> "
              f"{alloc2 / 2**20:.1f} MiB, reserved {res0 / 2**20:.1f} -> "
              f"{res2 / 2**20:.1f} MiB after the second is dropped")
        if after != counts or caps[0] != caps[1] or caps[0] != counts \
                or alloc2 != alloc0 or res2 > res0:
            raise AssertionError(f"C1 {family}: counts {counts} -> {after}, "
                                 f"captures {caps}, allocated {alloc0} -> "
                                 f"{alloc2}, reserved {res0} -> {res2}")
        out[family] = {"trace_counts": counts, "captures": caps[1],
                       "second_engine_mib": (alloc1 - alloc0) / 2**20,
                       "allocated_back": alloc2 == alloc0}
    return out


# the static batch loop (Engine.generate_static): full-width SmolLM2-135M and
# whisper-small, one shared prompt length, lock step through the dense-cache
# "decode" step, two CUDA graphs (prefill, decode) over one dense cache
STATIC_BATCH, STATIC_PROMPT, STATIC_NEW, STATIC_SEQ = 4, 256, 32, 1024


def static_per_call(cfg) -> dict:
    """The wrapper counts one call of the static decode step adds (the
    prefill and a decode step alike).  Dense (prepacked): the stream entry
    pack, per layer Q/K/V/O, gate, up, down (Q/K/V stored unpacked) and
    the O linear's input pack, then the tied head (its weight packed per
    call, stored unpacked).  encdec (weights packed on every call): per
    layer the self-attention's Q/K/V/O, the cross-attention's Q and O and
    the MLP's biased gelu up and down projections, each weight packed, the
    two O inputs packed, Q/K/V and the cross Q stored unpacked.  An untied
    head (vlm) is prepacked: no pack per call."""
    n = cfg.n_layers
    if cfg.family == "encdec":
        return {"mmt4d": 8 * n + 1, "pack": 1 + 10 * n + 1, "unpack": 0,
                "ragged_attn": 0, "mmt4d.unpacked_stores": 4 * n + 1,
                "mmt4d.bias_activation": n}
    return {"mmt4d": 7 * n + 1, "pack": 1 + n + int(cfg.tie_embeddings),
            "unpack": 0, "ragged_attn": 0,
            "mmt4d.unpacked_stores": 3 * n + 1, "mmt4d.bias_activation": 0}


def per_batch(cfg) -> dict:
    """The counts made once per static batch.  whisper's encoder and cross
    K/V: the frontend projector (frames and weight packed, stored
    unpacked), the stream entry pack, per encoder layer Q/K/V/O and the
    biased gelu MLP (weights packed, the O input packed), the final
    unpack, then per decoder layer the cross K and V (the encoder output
    and each weight packed, stored unpacked).  The vlm prefix: the
    patches packed, ``vision_proj`` (prepacked) stored unpacked.  No
    other family has any."""
    if cfg.family == "vlm":
        return {"mmt4d": 1, "pack": 1, "unpack": 0, "ragged_attn": 0,
                "mmt4d.unpacked_stores": 1, "mmt4d.bias_activation": 0}
    if cfg.family != "encdec":
        return {}
    e, n = cfg.encoder_layers, cfg.n_layers
    return {"mmt4d": 1 + 6 * e + 2 * n, "pack": 3 + 7 * e + 4 * n, "unpack": 1,
            "ragged_attn": 0, "mmt4d.unpacked_stores": 1 + 3 * e + 2 * n,
            "mmt4d.bias_activation": e}


def static_batch(cfg, batch=STATIC_BATCH) -> dict:
    """The launcher's static batch at this phase's sizes
    (``python -m repro_torch.launch.serve --static``): seeded prompts and,
    for whisper, frames from a seeded torch.Generator."""
    from repro_torch.launch.serve import static_batch as launcher_batch
    return launcher_batch(cfg, argparse.Namespace(
        seed=0, slots=batch, prompt_len=STATIC_PROMPT, max_len=STATIC_SEQ))


class StaticRecorder:
    """Stands in for a static engine's compiled decode step: passes every
    call through; on the card records CUDA events around each (the device
    time of each model call, the first of a batch its prefill); with
    ``rows`` on also keeps each call's last-position logits in float32 on
    the host (which waits for the card: never in a timed run)."""

    def __init__(self, step, cuda: bool):
        self.step, self.cuda, self.rows_on = step, cuda, False
        self.events, self.rows = [], []

    def __call__(self, *a, **kw):
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = self.step(*a, **kw)
        if self.cuda:
            ev[1].record()
            self.events.append(ev)
        if self.rows_on:
            self.rows.append(out[0][:, -1].float().cpu().numpy())
        return out

    def reset(self, rows: bool):
        self.events, self.rows, self.rows_on = [], [], rows

    def ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.events]


def static_picks(out: np.ndarray, rows: list) -> dict:
    """(row, position) -> (token, top-2 margin of the logits it was picked
    from), as compare_picks reads them."""
    picks = {}
    for j, r in enumerate(rows):
        top2 = np.partition(r, -2, axis=-1)[:, -2:]
        for b in range(out.shape[0]):
            picks[(b, j)] = (int(out[b, j]), float(top2[b, 1] - top2[b, 0]))
    return picks


def static_engine(cfg, dtype, device, params=None, batch=STATIC_BATCH):
    """A static engine in ``dtype`` on ``device`` over ``params`` (default:
    drawn from a CPU generator, seed 0) for batches of ``batch`` rows."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    name = str(dtype)[6:]
    model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                        ShapeSpec("serve", STATIC_SEQ, batch, "decode"),
                        device=device)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, device=device, max_slots=batch)
    eng._decode_step = StaticRecorder(eng._decode_step, device == "cuda")
    return eng


def static_run(cfg, dtype, label, params=None, batch=STATIC_BATCH,
               new=STATIC_NEW) -> dict:
    """One model's static batch on the card in ``dtype``: a first call
    (captures the prefill and decode graphs), a second with the wrapper
    counts set to 0 just before and read just after (timed: wall, tokens/s,
    prefill and decode device ms, whisper's encoder ms), which must
    capture nothing, make no program, repeat the first call's tokens and
    launch the expected kernels per model call; then a third recording
    each step's logits (for the margins), with graph replay held bit for
    bit to the eager step at both shapes; and one eager decode step with
    the card's synchronising calls made errors (the cache write, its mask
    and whisper's position gather stay on the device)."""
    from repro_torch import kernels
    eng = static_engine(cfg, dtype, "cuda", params, batch)
    del params
    rec = eng._decode_step
    nb, batch = batch, static_batch(cfg, batch)
    model = eng.model
    enc_ev = []
    caches_fn = eng._static_caches

    def timed_caches(b):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = caches_fn(b)
        ev[1].record()
        enc_ev.append(ev)
        return out

    eng._static_caches = timed_caches
    t0 = time.perf_counter()
    first = eng.generate_static(batch, new)
    first_s = time.perf_counter() - t0
    made = (dict(model.trace_counts), dict(eng._graphs.captures))
    rec.reset(rows=False)
    enc_ev.clear()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate_static(batch, new)
    wall = time.perf_counter() - t0
    counts = kernels.counters()
    step_ms = rec.ms()
    enc_ms = enc_ev[0][0].elapsed_time(enc_ev[0][1])
    if (dict(model.trace_counts), dict(eng._graphs.captures)) != made:
        raise AssertionError(f"{label}: the second call made programs or "
                             f"graphs: {made} -> {model.trace_counts}, "
                             f"{eng._graphs.captures}")
    if made[1]["decode"] != 2 or made[0]["decode"] != 2:
        raise AssertionError(f"{label}: {made} programs and graphs, not 2 each")
    if not np.array_equal(out, first):
        raise AssertionError(f"{label}: two calls on the same batch differ")
    if out.shape != (nb, new) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        raise AssertionError(f"{label}: tokens {out.shape} outside the vocabulary")
    calls = len(step_ms)
    per = static_per_call(cfg)
    enc = per_batch(cfg)
    for k, n in per.items():
        want = n * calls + enc.get(k, 0)
        if counts[k] != want:
            raise AssertionError(f"{label} {k}: {counts[k]} launches, expected "
                                 f"{n} x {calls} model calls + {enc.get(k, 0)}")
    if counts["mmt4d_dgrad"] or counts["mmt4d_wgrad"]:
        raise AssertionError(f"{label}: a gradient kernel ran: {counts}")
    check = ReplayCheck(rec.step)
    rec.step = check
    rec.reset(rows=True)
    again = eng.generate_static(batch, new)
    rows = rec.rows
    if not np.array_equal(again, out) or len(check.checked) != 2:
        raise AssertionError(f"{label}: the recording call differs, or replay "
                             f"checked at {len(check.checked)} shapes")
    if not all(np.isfinite(r).all() for r in rows):
        raise AssertionError(f"{label}: non-finite logits")
    caches = eng._static_bufs[(nb,)
                              + ((model.enc_len,) if cfg.family == "encdec" else ())]
    tok = torch.as_tensor(out[:, -1:], device="cuda")
    pos = torch.full((), STATIC_PROMPT + new, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")      # nothing read back to the host
    try:
        model.decode_step(eng.params, caches, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ntok = out.size
    launches = {k: v for k, v in counts.items() if "." not in k}
    res = {"tokens": out.tolist(), "first_call_s": first_s, "wall_s": wall,
           "tokens_per_s": ntok / wall, "prefill_ms": step_ms[0],
           "decode_ms_per_step": float(np.mean(step_ms[1:])),
           "encoder_ms": enc_ms if cfg.family == "encdec" else None,
           "model_calls": calls, "launches": launches,
           "unpacked_stores": counts["mmt4d.unpacked_stores"],
           "bias_activation": counts["mmt4d.bias_activation"],
           "launches_per_decode_step": per, "encoder_launches": enc or None,
           "programs": made[0]["decode"], "graphs": made[1]["decode"],
           "picks": static_picks(out, rows)}
    print(f"  {label}: first call {first_s:.3f} s (2 programs, 2 graphs); "
          f"second {wall:.6f} s wall, {ntok / wall:.2f} tokens/s, prefill "
          f"{step_ms[0]:.4f} ms, decode {res['decode_ms_per_step']:.4f} ms per "
          f"step (device, {calls - 1} steps)"
          + (f", encoder and cross K/V {enc_ms:.4f} ms"
             if cfg.family == "encdec" else "")
          + f"; no capture, no program; replay = eager bit for bit at 2 shapes")
    print(f"  {label}: launches {launches} (mmt4d unpacked stores "
          f"{counts['mmt4d.unpacked_stores']}, bias + activation epilogues "
          f"{counts['mmt4d.bias_activation']}); per decode step {per}"
          + (f"; once per batch {enc}" if enc else ""))
    return res


def static_cpu(cfg, dtype=TF, params=None, batch=STATIC_BATCH,
               new=STATIC_NEW) -> dict:
    """The same static batch on the CPU (the plain versions): its tokens
    and each step's picks with their top-2 margins."""
    eng = static_engine(cfg, dtype, "cpu", params, batch)
    eng._decode_step.reset(rows=True)
    out = eng.generate_static(static_batch(cfg, batch), new)
    return {"tokens": out, "picks": static_picks(out, eng._decode_step.rows)}


def static_drafters(cfg) -> dict:
    """The standalone DraftModelDrafter.propose (dense per-request cache,
    eager steps) against one attached to an engine (its paged step's
    graphs) over one context at full width in float32, SmolLM2 cut to 2
    layers: a fresh context, then four commits (all drafts, a partial
    reject, the re-fed final token, a full reject); every proposal equal."""
    import dataclasses
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.speculative import DraftModelDrafter
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    shape = ShapeSpec("serve", STATIC_SEQ, STATIC_BATCH, "decode")
    target = build_model(cfg, run, shape, device="cuda")
    dmodel = build_model(dataclasses.replace(cfg, n_layers=2), run, shape,
                         device="cuda")
    dparams = dmodel.init(torch.Generator().manual_seed(7))
    attached = DraftModelDrafter(dmodel, dparams)
    Engine(target, target.init(torch.Generator().manual_seed(0)), device="cuda",
           max_slots=STATIC_BATCH, chunk_tokens=128, spec_tokens=3,
           drafter=attached)
    alone = DraftModelDrafter(dmodel, dparams)
    prompt = static_batch(cfg)["tokens"][0]
    reqs = [Request(rid=0, prompt=prompt, max_new=STATIC_NEW) for _ in range(2)]
    for r in reqs:
        r.out_tokens = [int(prompt[-1])]
    k, rounds = 3, []
    commits = [lambda p: list(p), lambda p: [p[0], (p[1] + 1) % cfg.vocab],
               lambda p: [p[0]], lambda p: [(p[0] + 7) % cfg.vocab]]
    t0 = time.perf_counter()
    for i in range(len(commits) + 1):
        want = attached.propose_all([(reqs[0], k)])[0]
        got = alone.propose(reqs[1], k)
        rounds.append(got)
        if got != want:
            raise AssertionError(f"standalone drafter round {i}: {got}, attached "
                                 f"{want}")
        if i < len(commits):
            for r in reqs:
                r.out_tokens += commits[i](got)
    secs = time.perf_counter() - t0
    print(f"  standalone DraftModelDrafter.propose = the attached drafter's "
          f"over {len(rounds)} proposals (fresh, commit all, partial reject, "
          f"re-fed final token, full reject): {rounds}; standalone draft "
          f"steps {alone.draft_steps} (eager), attached {attached.draft_steps} "
          f"(graphs {attached.stats()['captures']}); {secs:.1f} s")
    return {"proposals": rounds, "standalone_steps": alone.draft_steps,
            "attached_steps": attached.draft_steps}


def static_vs_generate(cfg, static_out) -> dict:
    """generate() of a flat engine (chunk_tokens=128) over a float32 model at
    full width, beside the static loop's tokens on the same batch (the
    JAX package's continuous-vs-static contract); picks may part only
    below a top-2 margin of F32_MARGIN."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, run, ShapeSpec("serve", STATIC_SEQ, STATIC_BATCH,
                                            "decode"), device="cuda")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 device="cuda", max_slots=STATIC_BATCH, chunk_tokens=128)
    rec = PickRecorder(eng)
    out = eng.generate(static_batch(cfg), STATIC_NEW)
    return compare_picks(static_out["picks"], rec.picks, F32_MARGIN,
                         "f32 generate() (flat) vs generate_static")


def static_phase(card) -> tuple:
    """The static batch loop at full width: SmolLM2-135M (f32 card = CPU,
    = generate(); the standalone drafter = the attached one; bf16 picks
    held to the f32 CPU's under BF16_MARGIN) and whisper-small (f32 card =
    CPU; bf16).  Returns (results, launches by path)."""
    from repro_torch.configs import get_config
    res, paths = {}, {}
    for arch in ("smollm2-135m", "whisper-small"):
        cfg = get_config(arch)
        print(f"  {arch}: {cfg.n_layers} layers"
              + (f" + {cfg.encoder_layers} encoder layers over "
                 f"{STATIC_SEQ // cfg.audio_downsample} frames"
                 if cfg.encoder_layers else "")
              + f", d {cfg.d_model}, vocab {cfg.vocab}; batch {STATIC_BATCH} x "
              f"prompt {STATIC_PROMPT}, {STATIC_NEW} new, seq_len {STATIC_SEQ} "
              f"({card})")
        cpu = CPU_RUNS.proc(static_cpu, cfg)       # f32, the plain versions
        r = {}
        for dtype in (TF, BF):
            name = str(dtype)[6:]
            r[name] = static_run(cfg, dtype, f"{arch} static {name}")
            paths[f"static {arch} {name}"] = r[name]["launches"]
        if cfg.family == "dense":
            r["vs_generate"] = static_vs_generate(cfg, r["float32"])
            r["drafters"] = static_drafters(cfg)
        picks = {name: r[name].pop("picks") for name in ("float32", "bfloat16")}

        def check(cpu_res, arch=arch, r=r, picks=picks):
            for name, tol in (("float32", 0.0), ("bfloat16", BF16_MARGIN)):
                r[name]["vs_cpu_f32"] = compare_picks(
                    picks[name], cpu_res["picks"], tol,
                    f"{arch} static {name} card vs f32 CPU")
            if not np.array_equal(np.asarray(r["float32"]["tokens"]), cpu_res["tokens"]):
                raise AssertionError(f"{arch}: f32 static tokens card != CPU")
            print(f"  {arch} f32 static tokens, card = CPU: "
                  f"{np.asarray(r['float32']['tokens'])[:, :8].tolist()} ...")
        CPU_RUNS.defer(f"{arch} static f32", cpu, check)
        res[arch] = r
    return res, paths


# the chaos phase: scripts/chaos_smoke.py's fault plans, and the families
# the resilience layer runs through (flat, flat with n-gram speculation
# and the prefix cache, dense chunked)
CHAOS_PLANS = {
    "oom-spike": [(0, "oom"), (1, "oom"), (2, "oom")],
    "drafter-burst": [(s, "drafter") for s in (1, 2, 3, 5, 7)],
    "nan-logits": [(3, "nan")],
    "copier-failure": [(1, "copier"), (3, "copier")],
}
CHAOS_FAMILIES = {"flat": dict(chunk_tokens=128),
                  "flat-spec-cache": dict(chunk_tokens=128, spec_tokens=2,
                                          prefix_cache=True),
                  "dense": dict(chunk_tokens=128, flat=False)}


def chaos_trace(vocab, seed=5):
    """Five requests ((prompt, max_new, arrival) each) on a clock that
    advances one per step: a 48-token prompt A, a 23-token one, A again at
    1 and at 3 (with the prefix cache, A's three pages are cached by then:
    the prefill restarts inside the last one, which is copied first), and
    a 57-token one at 4."""
    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, vocab, n) for n in (48, 23, 57))
    return [(a, 12, 0.0), (b, 16, 0.0), (a, 8, 1.0), (a, 10, 3.0), (c, 10, 4.0)]


def chaos_drain(eng, adds, plan=None, hook=None) -> dict:
    """Queue ``adds`` ((index, prompt, max_new, add_request keywords) each)
    and step on a synthetic clock (step i at now = i) under ``plan`` until
    every request, shed and cancelled ones included, is delivered;
    ``hook(i, rid_of_index)`` runs after step i.  The wrapper counts are
    set to 0 just before and read just after.  Returns each index's
    (tokens, reason), its picks keyed (index, position), steps, wall and
    launches."""
    import contextlib
    from repro_torch import kernels
    rec = eng._pick if isinstance(eng._pick, PickRecorder) else PickRecorder(eng)
    rec.picks = {}
    steps0 = eng.stats()["steps"]
    index = {eng.add_request(p, n, **kw): i for i, p, n, kw in adds}
    rid_of = {i: r for r, i in index.items()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fin, clock = [], 0
    with plan.on(eng) if plan is not None else contextlib.nullcontext():
        while eng.scheduler.has_work or eng._finished_oob:
            fin.extend(eng.step(now=float(clock)))
            if hook is not None:
                hook(clock, rid_of)
            clock += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    fin.extend(eng.drain())      # no step left: ends the drain's auto-disable
    if sorted(r.rid for r in fin) != sorted(index):
        raise AssertionError(f"requests lost: {sorted(index)} added, "
                             f"{sorted(r.rid for r in fin)} delivered")
    steps = eng.stats()["steps"] - steps0
    return {"out": {index[r.rid]: (list(r.out_tokens), r.finish_reason) for r in fin},
            "picks": {(index[rid], pos): v for (rid, pos), v in rec.picks.items()},
            "steps": steps, "wall_s": wall, "ms_per_step": 1e3 * wall / max(1, steps),
            "launches": launches}


def chaos_check(eng, label, run, clean, tol, baseline) -> dict:
    """A drain held to the contract: each request the clean drain also
    served gives its picks (float32: exactly; bfloat16: parting only below
    a top-2 margin of ``tol``), a survivor all of its tokens; the
    allocator audits clean with every used page a prefix-cache page; the
    model traced and the engine captured nothing since warmup; every
    kernel of the path ran.  Prints the drain's line."""
    from repro_torch.analysis.aliasing import check_pool_consistency
    served = {i for i in run["out"] if i in clean["out"]}
    picks = {k: v for k, v in run["picks"].items() if k[0] in served}
    want = {k: v for k, v in clean["picks"].items()
            if k in picks or (k[0] in served and run["out"][k[0]][1] == "length")}
    cmp = compare_picks(want, picks, tol, label)
    for i in served:
        toks, reason = run["out"][i]
        if reason in ("length", "eos") and tol == 0.0 and \
                (toks, reason) != clean["out"][i]:
            raise AssertionError(f"{label}: survivor {i} {toks} != clean "
                                 f"{clean['out'][i]}")
    findings = check_pool_consistency(eng, label)
    cached = (len(set(eng.prefix_cache.pages()))
              if eng.prefix_cache is not None else 0)
    live = sum(len(s.pages) for s in eng.pool.sequences())
    st = eng.stats()
    if findings or eng.pool.num_used != cached or live:
        raise AssertionError(f"{label}: allocator {[f.format() for f in findings]}, "
                             f"used {eng.pool.num_used}, cached {cached}, live {live}")
    if dict(eng.model.trace_counts) != baseline["traces"] \
            or st["captures"] != baseline["captures"]:
        raise AssertionError(f"{label}: traced or captured after warmup: "
                             f"{baseline} -> {dict(eng.model.trace_counts)}, "
                             f"{st['captures']}")
    check_path_launches(label, run["launches"], eng.flat)
    reasons = dict(collections.Counter(r for _, r in run["out"].values()))
    print(f"  {label}: {run['steps']} steps, {run['ms_per_step']:.3f} ms per step, "
          f"finish reasons {reasons}, audit clean, used pages {eng.pool.num_used} "
          f"= cached {cached}, traces and captures as at warmup")
    return {"reasons": reasons, **cmp, "steps": run["steps"],
            "ms_per_step": run["ms_per_step"], "wall_s": run["wall_s"],
            "launches": run["launches"]}


def chaos_phase(cfg, dtype) -> dict:
    """Resilience under chaos at full width in one dtype, each of
    CHAOS_FAMILIES on one warmed engine (queue_limit=6; in float32 the
    runtime sanitizer on every call): the clean drain of chaos_trace, the
    same under each of CHAOS_PLANS, then a lifecycle drain (a 300-token
    request cancelled mid-prefill, A cancelled decoding, one cancelled
    while queued, one shed at the queue limit, a deadline and a
    max_queue_s expiry), then a watchdog trip (every page held elsewhere:
    nothing can be admitted) caught as StallError and the drain resumed.
    The prefix cache is cleared between drains, so each starts cold.  The
    pools never move."""
    import gc
    from repro_torch.analysis.sanitize import install
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine, StallError
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    from repro_torch.serving.kv_cache import SequencePages
    name = str(dtype)[6:]
    model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                        ShapeSpec("serve", 1024, 4, "decode"), device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    tol = 0.0 if dtype is TF else BF16_MARGIN
    trace = chaos_trace(cfg.vocab)
    adds = [(i, p, n, {"arrival": a}) for i, (p, n, a) in enumerate(trace)]
    out = {}
    for family, kw in CHAOS_FAMILIES.items():
        eng = Engine(model, params, device="cuda", max_slots=4, page_tokens=16,
                     queue_limit=6, **kw)
        san = install(eng) if dtype is TF else None
        eng.warmup()
        torch.cuda.synchronize()
        baseline = {"traces": dict(model.trace_counts),
                    "captures": eng.stats()["captures"]}
        pools = {id(t): t.data_ptr() for t in leaves(eng.caches)}
        res = {}

        def cold():
            if eng.prefix_cache is not None:
                eng.prefix_cache.clear()

        clean = chaos_drain(eng, adds)
        if any(r != "length" for _, r in clean["out"].values()):
            raise AssertionError(f"{name} {family}: clean drain {clean['out']}")
        res["clean"] = chaos_check(eng, f"{name} {family} clean", clean, clean, tol,
                                   baseline)
        cold()
        for plan_name, events in CHAOS_PLANS.items():
            plan = FaultPlan([FaultEvent(s, k) for s, k in events])
            run = chaos_drain(eng, adds, plan)
            label = f"{name} {family} {plan_name}"
            res[plan_name] = chaos_check(eng, label, run, clean, tol, baseline)
            res[plan_name]["fired"] = dict(plan.fired)
            res[plan_name]["resilience"] = eng.stats()["resilience"]
            print(f"    fired {plan.fired}")
            cold()
        # the lifecycle drain: indices 0, 1, 4 are the trace's requests
        a, b, c = trace[0][0], trace[1][0], trace[4][0]
        long = np.random.default_rng(9).integers(0, cfg.vocab, 300)
        life = [(5, long, 8, {}), (0, a, 12, {}), (1, b, 16, {"deadline_s": 4.0}),
                (4, c, 10, {}), (6, a, 8, {"max_queue_s": 1.0}), (7, a, 8, {}),
                (8, b, 8, {})]
        states = {}

        def hook(i, rid_of):
            running = {r.rid: r.status for r in eng.scheduler.running.values()}
            if i == 0:
                states["cancelled queued"] = eng.cancel(rid_of[7])
                states["prefilling"] = running.get(rid_of[5])
                states["cancelled prefilling"] = eng.cancel(rid_of[5])
            elif i == 1:
                states["decoding"] = running.get(rid_of[0])
                states["cancelled decoding"] = eng.cancel(rid_of[0])

        before = eng.stats()["resilience"]
        run = chaos_drain(eng, life, hook=hook)
        after = eng.stats()["resilience"]
        delta = {k: after[k] - before[k] for k in ("sheds", "cancels", "timeouts",
                                                   "quarantines")}
        label = f"{name} {family} lifecycle"
        res["lifecycle"] = chaos_check(eng, label, run, clean, tol, baseline)
        res["lifecycle"]["counters"] = delta
        want = {5: "cancelled", 0: "cancelled", 1: "timeout", 4: "length",
                6: "timeout", 7: "cancelled", 8: "rejected"}
        got = {i: r for i, (_, r) in run["out"].items()}
        print(f"    states at cancel {states}, counters {delta}")
        if got != want or delta != {"sheds": 1, "cancels": 3, "timeouts": 2,
                                    "quarantines": 0} \
                or states != {"cancelled queued": True, "prefilling": "prefilling",
                              "cancelled prefilling": True, "decoding": "running",
                              "cancelled decoding": True}:
            raise AssertionError(f"{label}: reasons {got}, counters {delta}, "
                                 f"states {states}")
        cold()
        # the watchdog: a holder outside the engine takes every free page,
        # so nothing can be admitted; once it lets go the drain resumes
        hog = SequencePages(eng.pool)
        hog.ensure(eng.pool.num_free * eng.pool.page_tokens)
        trips = eng.stats()["resilience"]["watchdog_trips"]

        def wedge(i, rid_of):
            if i == 0:
                try:
                    eng.drain()
                except StallError as e:
                    states["stall"] = str(e)
                hog.release()

        run = chaos_drain(eng, [(1, b, 16, {})], hook=wedge)
        res["watchdog"] = chaos_check(eng, f"{name} {family} watchdog", run, clean,
                                      tol, baseline)
        trips = eng.stats()["resilience"]["watchdog_trips"] - trips
        print(f"    StallError after {eng.watchdog_steps} idle steps: "
              f"{states.get('stall', '')[:72]}...; trips {trips}")
        if trips != 1 or "no request advanced" not in states.get("stall", "") \
                or run["out"][1][1] != "length":
            raise AssertionError(f"{name} {family} watchdog: trips {trips}, "
                                 f"{states.get('stall')}, {run['out']}")
        if {id(t): t.data_ptr() for t in leaves(eng.caches)} != pools:
            raise AssertionError(f"{name} {family}: a KV pool was reallocated or "
                                 f"rebound")
        if san is not None:
            print(f"  {name} {family} sanitizer: {san.checks} model calls, "
                  f"{san.pages_checked} write pages, {san.cancels_checked} "
                  f"quarantines checked, no SanitizerError")
            res["sanitizer"] = {"checks": san.checks, "pages": san.pages_checked,
                                "quarantines": san.cancels_checked}
        out[family] = res
        del eng
        gc.collect()
    return out


# the telemetry phase: the same drains with telemetry off and on
TEL_PAIRS = 5                     # alternating off/on drains for the cost


def tel_drain(eng, prompts, label) -> dict:
    """The §4 drain on a warmed engine: 32 new tokens per prompt, the
    wrapper counts set to 0 just before and read just after; every request
    finishes, nothing is captured, every kernel of the path runs."""
    from repro_torch import kernels
    st0 = eng.stats()
    rids = [eng.add_request(p, 32) for p in prompts]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fin = {r.rid: r for r in eng.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    if sorted(fin) != sorted(rids) or any(r.finish_reason != "length"
                                          for r in fin.values()):
        raise AssertionError(f"{label}: not every request finished")
    if st["captures"] != st0["captures"] or st["compiles"] != st0["compiles"]:
        raise AssertionError(f"{label}: captured during the drain: "
                             f"{st0['captures']} -> {st['captures']}")
    check_path_launches(label, launches, eng.flat)
    steps = st["steps"] - st0["steps"]
    return {"tokens": [fin[r].out_tokens for r in rids], "wall_s": wall,
            "steps": steps, "ms_per_step": 1e3 * wall / steps,
            "launches": launches}


def check_records(eng, label) -> None:
    """Every step record's sched + device + draft + host is its wall, and
    the drain totals' too."""
    recs = list(eng.obs.step_records)
    for rec in recs:
        parts = rec["sched"] + rec["device"] + rec["draft"] + rec["host"]
        if abs(parts - rec["wall"]) > 1e-9 + 1e-6 * rec["wall"] \
                or not rec["families"]:
            raise AssertionError(f"{label}: step record {rec} does not sum to "
                                 f"its wall")
    tot = eng.obs.attribution_summary()["totals"]
    comp = tot["sched_s"] + tot["device_s"] + tot["draft_s"] + tot["host_s"]
    if not recs or abs(comp - tot["wall_s"]) > 1e-6 * tot["wall_s"]:
        raise AssertionError(f"{label}: totals {tot} do not sum to the wall")


def print_telemetry(eng, label) -> dict:
    """The drain's latency percentiles, wall split, per-family predicted
    against measured device time, and MFU/MBU."""
    tel = eng.telemetry()
    lat, att = tel["latency"], tel["attribution"]
    tot, steps = att["totals"], max(1, att["totals"]["steps"])
    print(f"  {label}: latency ms (p50 / p95 / p99): " + "; ".join(
        f"{k[:-2]} {1e3 * v['p50']:.3f} / {1e3 * v['p95']:.3f} / "
        f"{1e3 * v['p99']:.3f} (n={v['count']})" for k, v in lat.items()))
    split = {k: 1e3 * tot[f"{k}_s"] / steps
             for k in ("wall", "sched", "device", "draft", "host")}
    print(f"  {label}: mean ms per step over {tot['steps']} steps: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    cm = eng.cost_model
    for fam, f in sorted(att["families"].items()):
        fc = cm.get(fam)
        print(f"    {fam}: {f['steps']} steps, fill {f['fill']:.3f}, device "
              f"{f['device_s']:.6f} s measured vs {f['predicted_s']:.6f} s "
              f"predicted (ratio {f['predicted_vs_measured']:.4f}); per step "
              f"{fc.flops:.4e} FLOPs, {fc.hbm_bytes:.4e} B ({fc.kv_gather_bytes:.4e} "
              f"KV gather), roofline {1e3 * fc.predicted_s:.6f} ms ({fc.bottleneck})")
    print(f"  {label}: MFU {att['mfu']:.6f}, MBU {att['mbu']:.6f}, roofline "
          f"fraction {att['roofline_fraction']:.6f}, padding waste ratio "
          f"{att['padding_waste_ratio']:.6f}, achieved {att['achieved_tokens_per_s']:.1f}"
          f" vs roofline {att['roofline_tokens_per_s']:.1f} tokens/s, goodput "
          f"{att['goodput_ratio']:.3f}, alerts {[a['kind'] for a in tel['alerts']]}")
    return {"latency": lat, "ms_per_step": split, "attribution": att,
            "alerts": tel["alerts"]}


def telemetry_phase(cfg, prompts, card) -> dict:
    """Serving observability at full width in bfloat16, each family: the
    §4 drain on a warmed engine with telemetry on beside the same drain on
    one with it off, over one model (identical tokens, no capture in
    either, the cost model built at warmup moving no trace_counts, step
    records summing to wall); the flat family's report pair and trace
    exported and linted, and the observer's cost over alternating pairs;
    the spec and shared-prefix traces with n-gram speculation (k = 2) and
    the prefix cache, flat; a chaos drain with telemetry on, its fault
    instants in the trace."""
    import gc
    import tempfile
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.obs.attrib import build_cost_model
    from repro_torch.obs.export import lint_prometheus
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    out, by_path = {}, {}

    def engine(telemetry, **kw):
        eng = Engine(model, params, device="cuda", max_slots=4, page_tokens=16,
                     telemetry=telemetry, **kw)
        eng.warmup()
        return eng

    for family, kw in FAMILIES_BF16.items():
        off, on = engine(False, **kw), engine(True, **kw)
        traces = dict(model.trace_counts)
        cm = build_cost_model(on)
        if dict(model.trace_counts) != traces or off.cost_model is not None \
                or on.cost_model is None or cm.families.keys() != on.cost_model.families.keys():
            raise AssertionError(f"{family}: the cost model moved trace_counts "
                                 f"or was built without telemetry")
        print(f"  {family}: cost model at warmup, {cm.hw_name} @ {cm.dtype}, "
              f"peak {cm.peak_flops:.4g} FLOP/s, HBM {cm.hbm_bw:.4g} B/s, "
              f"{len(cm.families)} families {list(cm.families)}; trace_counts "
              f"{traces} unmoved")
        r_off = tel_drain(off, prompts, f"bf16 {family} telemetry off")
        r_on = tel_drain(on, prompts, f"bf16 {family} telemetry on")
        if r_on["tokens"] != r_off["tokens"]:
            raise AssertionError(f"{family}: telemetry on changed the tokens")
        check_records(on, f"bf16 {family}")
        print(f"  {family}: tokens identical with telemetry on and off; "
              f"{r_off['ms_per_step']:.3f} (off) and {r_on['ms_per_step']:.3f} "
              f"(on) ms per step, {r_on['steps']} steps; no capture in either "
              f"drain; records sum to wall")
        res = {"off": {k: v for k, v in r_off.items() if k != "tokens"},
               "on": {k: v for k, v in r_on.items() if k != "tokens"},
               "cost_model": cm.to_dict(), **print_telemetry(on, f"{family}")}
        by_path[f"telemetry {family} off"] = r_off["launches"]
        by_path[f"telemetry {family} on"] = r_on["launches"]
        if family == "flat":
            with tempfile.TemporaryDirectory() as tmp:
                paths = on.telemetry(report=os.path.join(tmp, "drain"))["report"]
                prom = open(paths["prom"]).read()
                html = open(paths["html"]).read()
                problems = lint_prometheus(prom)
                trace_path = os.path.join(tmp, "drain.trace.json")
                on.obs.export_trace(trace_path)
                with open(trace_path) as f:
                    events = json.load(f)["traceEvents"]
            if problems or "<script" in html or not events:
                raise AssertionError(f"exports: lint {problems}, "
                                     f"{len(events)} trace events")
            print(f"  {family}: report {len(html)} B html + {len(prom.splitlines())}"
                  f"-line .prom (lint clean), Chrome trace {len(events)} events")
            res["exports"] = {"html_bytes": len(html),
                              "prom_lines": len(prom.splitlines()),
                              "trace_events": len(events)}
            pairs = []
            for i in range(TEL_PAIRS):
                a = tel_drain(off, prompts, f"flat pair {i} off")
                on.telemetry(reset=True)
                b = tel_drain(on, prompts, f"flat pair {i} on")
                if a["tokens"] != b["tokens"] or b["tokens"] != r_off["tokens"]:
                    raise AssertionError(f"flat pair {i}: tokens differ")
                pairs.append((a["ms_per_step"], b["ms_per_step"]))
            offs, ons = zip(*pairs)
            print(f"  observer cost, flat, {TEL_PAIRS} alternating pairs (off, on) "
                  f"ms per step: {[(round(x, 4), round(y, 4)) for x, y in pairs]}; "
                  f"medians {float(np.median(offs)):.4f} off, "
                  f"{float(np.median(ons)):.4f} on ({card})")
            res["pairs"] = pairs
        out[family] = res
        del off, on
        gc.collect()

    # speculation and the prefix cache, flat: the draft span, the cache and
    # rollback instants
    eng = engine(True, chunk_tokens=128, spec_tokens=2, prefix_cache=True)
    spec = [(p, n, 0.0) for p, n, _ in spec_trace(cfg.vocab)]
    pre = [(p, n, 0.0) for p, n, _ in prefix_trace(cfg.vocab)]
    r_spec = timed_drain(eng, spec, True, 0, "bf16 flat spec+cache, spec trace, "
                         "telemetry on")
    r_pre = timed_drain(eng, pre, True, 0, "bf16 flat spec+cache, shared-prefix "
                        "trace, telemetry on", staggered=True)
    check_records(eng, "spec+cache")
    snap = eng.obs.registry.snapshot()
    evs = eng.obs.tracer.events()
    names = collections.Counter(e["name"] for e in evs if e["ph"] in ("i", "X"))
    print(f"  spec+cache: draft rows {snap['draft_rows']}, draft tokens "
          f"{snap['draft_tokens']}, prefix hits {snap['prefix_hits']} "
          f"({snap['prefix_hit_tokens']} tokens), evictions "
          f"{snap['prefix_evictions']}, cow {snap['cow_copies']}, rollback pages "
          f"{snap['spec_rollback_pages']}; trace spans and instants {dict(names)}")
    if not (names["draft"] and names["prefix_hit"] and snap["draft_tokens"]
            and snap["step_draft_s"]["count"]):
        raise AssertionError(f"spec+cache: the draft span or the cache "
                             f"instants did not fire: {dict(names)}")
    out["spec_cache"] = {"counters": {k: v for k, v in snap.items()
                                      if not isinstance(v, dict) and k != "_scope"},
                         "instants": dict(names),
                         **print_telemetry(eng, "spec+cache")}
    by_path["telemetry spec trace"] = r_spec["launches"]
    by_path["telemetry prefix trace"] = r_pre["launches"]
    del eng
    gc.collect()

    # a chaos drain with telemetry on: the fault instants land in the trace
    eng = engine(True, queue_limit=6, **CHAOS_FAMILIES["flat-spec-cache"])
    trace = chaos_trace(cfg.vocab)
    adds = [(i, p, n, {"arrival": a}) for i, (p, n, a) in enumerate(trace)]
    events = CHAOS_PLANS["oom-spike"] + CHAOS_PLANS["nan-logits"]
    plan = FaultPlan([FaultEvent(st, k) for st, k in events])
    run = chaos_drain(eng, adds, plan)
    check_path_launches("telemetry chaos", run["launches"], True)
    check_records(eng, "chaos")
    names = collections.Counter(e["name"] for e in eng.obs.tracer.events()
                                if e["ph"] == "i")
    reasons = collections.Counter(r for _, r in run["out"].values())
    print(f"  chaos (oom-spike + nan-logits, flat spec+cache): fired "
          f"{plan.fired}, reasons {dict(reasons)}, instants {dict(names)}")
    if names["fault:nan"] != plan.fired["nan"] or names["fault:oom"] != plan.fired["oom"] \
            or not names["quarantine"] or not plan.fired["nan"]:
        raise AssertionError(f"chaos: fault instants {dict(names)} vs fired "
                             f"{plan.fired}")
    out["chaos"] = {"fired": dict(plan.fired), "instants": dict(names),
                    "reasons": dict(reasons), "ms_per_step": run["ms_per_step"]}
    by_path["telemetry chaos"] = run["launches"]
    del eng
    gc.collect()
    return out, by_path


# --------------------------------------------------------------- training

# the vector lengths and layout policies of the phase that runs them: the
# card's descriptor and its scaled forms (the tiles widen to 256 and 512;
# the card's peaks do not), and the fixed and unpacked policies
SCALED = ("h100_vl256", "h100_vl512")
LAYOUTS_F32 = (("scalable", "h100_vl256"), ("scalable", "h100_vl512"),
               ("fixed", "h100_vl512"), ("unpacked", "h100"))
LAYOUTS_BF16 = (("scalable", "h100"), ("scalable", "h100_vl256"),
                ("scalable", "h100_vl512"), ("fixed", "h100"),
                ("unpacked", "h100"))
# drains of each layout engine, in turns: forward, reversed, forward, ...
LAYOUT_TURNS = 4
# under unpacked every product is a torch.matmul: no mmt4d, pack or unpack
EXPECTED_UNPACKED_POLICY = {"mmt4d": 0, "pack": 0, "unpack": 0, "ragged_attn": 30}


def layout_engine(cfg, policy, hw_name):
    """A warmed flat bf16 engine of the §4 drain (chunk_tokens=128, 4
    slots, 16-token pages, seq_len 1024) on a fresh model under a layout
    policy and descriptor, and what its warmup took."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.core.hardware import query
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    model = build_model(cfg, RunConfig(layout_policy=policy),
                        ShapeSpec("serve", 1024, 4, "decode"),
                        hw=query("cuda", hw_name), device="cuda")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 device="cuda", max_slots=4, page_tokens=16, **FAMILIES_BF16["flat"])
    lay = model.ctx.layout(model.compute_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    graphs = dict(eng.stats()["compiles"])
    info = {"policy": policy, "hw": hw_name, "tiles": (lay.m_r, lay.n_r, lay.k_r),
            "flat_widths": eng._flat_shapes(), "page_tokens": eng.pool.page_tokens,
            "warmup_s": time.perf_counter() - t0, "programs": sum(graphs.values())}
    print(f"  bf16 {policy} {hw_name}: tiles (m_r, n_r, k_r) {info['tiles']}, flat "
          f"widths {info['flat_widths']}; warmup {info['warmup_s']:.3f} s, "
          f"{info['programs']} programs")
    return eng, info


def layout_drain(eng, prompts, label, policy) -> dict:
    """The §4 drain's requests on a warmed layout engine, with every
    wrapper count set to 0 just before and read just after: every request
    finishes, nothing is captured, the launches per model call are
    checked, every pick is recorded (the recording's host time is taken
    out of the wall)."""
    from repro_torch import kernels
    st0 = eng.stats()
    rec = eng._pick if isinstance(eng._pick, PickRecorder) else PickRecorder(eng)
    rec.picks, rec.seconds = {}, 0.0
    calls = count_model_calls(eng)
    rids = [eng.add_request(p, 32) for p in prompts]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    finished = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - rec.seconds
    launches = kernels.launch_counts()
    delattr(eng, "_run_flat")                      # the call counter
    st = eng.stats()
    n, steps = len(calls), st["steps"] - st0["steps"]
    ntok = sum(len(r.out_tokens) for r in finished)
    if sorted(r.rid for r in finished) != sorted(rids) or any(
            r.finish_reason != "length" or len(r.out_tokens) != 32 for r in finished):
        raise AssertionError(f"{label}: not every request finished")
    if st["captures"] != st0["captures"] or not all(np.isfinite(c).all()
                                                    for c in calls):
        raise AssertionError(f"{label}: captured during the drain, or non-finite "
                             f"logits")
    expected = (EXPECTED_UNPACKED_POLICY if policy == "unpacked"
                else EXPECTED_PER_STEP)
    for k in SOURCES:
        if launches[k] != expected.get(k, 0) * n:
            raise AssertionError(f"{label} {k}: {launches[k]} launches over {n} "
                                 f"model calls, expected {expected.get(k, 0)} each")
    place = {rid: i for i, rid in enumerate(rids)}
    return {"steps": steps, "model_calls": n, "wall_s": wall,
            "ms_per_step": 1e3 * wall / steps, "tokens": ntok,
            "tokens_per_s": ntok / wall, "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items() if v},
            # picks keyed by the request's place in the drain, not its rid
            "picks": {(place[r], p): v for (r, p), v in rec.picks.items()}}


def layouts_phase(cfg, f32_prompts, bf16_prompts, gen, card) -> tuple:
    """Vector lengths and layout policies at full SmolLM2 width: the
    serving kernels at the scaled tiles against their plain versions; f32
    flat drains card = CPU under LAYOUTS_F32; the bf16 §4 drain under
    LAYOUTS_BF16, each drain's picks within BF16_MARGIN of the scalable
    h100 drain's; one f32 train step at h100_vl512, card = CPU.  Returns
    (results, launches by path, kernel checks by descriptor)."""
    from repro_torch.core.hardware import query
    hw = query("cuda", "h100")
    checks = {}
    for name in SCALED:
        print(f"  kernels vs plain versions at the tiles of {name} "
              f"(bounds from the card's own rates; {card}):")
        checks[name] = KernelChecks(hw, gen, tiles_hw=query("cuda", name))
        checks[name].run_scaled()
    print(f"  float32, flat: 4 requests x 8 new tokens, card vs CPU plain path "
          f"(the CPU on the descriptor's TPU twin, the same tiles)")
    f32 = {f"{p} {h}": compare_f32(cfg, f32_prompts, "flat", policy=p, hw_name=h)
           for p, h in LAYOUTS_F32}
    print(f"  bfloat16, flat: the §4 drain (8 requests, 32 new each), one warmed "
          f"engine per layout, each on its own model, drained {LAYOUT_TURNS} times "
          f"in turns (forward, reversed, ...; {card}); no MFU or roofline share: "
          f"a scaled descriptor's peaks are not the card's")
    engines = {f"{p} {h}": layout_engine(cfg, p, h) for p, h in LAYOUTS_BF16}
    keys = list(engines)
    runs = {k: [] for k in keys}
    for order in (keys, keys[::-1]) * (LAYOUT_TURNS // 2):
        for k in order:
            runs[k].append(layout_drain(engines[k][0], bf16_prompts, f"bf16 {k}",
                                        engines[k][1]["policy"]))
    bf16 = {}
    for k in keys:
        first = runs[k][0]
        ms = [r["ms_per_step"] for r in runs[k]]
        tps = [r["tokens_per_s"] for r in runs[k]]
        bf16[k] = {**engines[k][1], "runs": runs[k], "ms_per_step": ms,
                   "tokens_per_s": tps, "median_ms_per_step": float(np.median(ms)),
                   "median_tokens_per_s": float(np.median(tps)),
                   "launches_per_step": first["launches_per_step"],
                   "repeats_identical": all(r["picks"] == first["picks"]
                                            for r in runs[k])}
        print(f"  bf16 {k}: {first['steps']} steps; ms per step by turn "
              f"{[round(x, 4) for x in ms]} (median {np.median(ms):.4f}), tokens/s "
              f"{[round(x, 2) for x in tps]} (median {np.median(tps):.2f}); picks "
              f"of every turn identical: {bf16[k]['repeats_identical']}; launches "
              f"per step {({n: round(v, 4) for n, v in first['launches_per_step'].items()})}")
    del engines
    torch.cuda.empty_cache()
    base = runs["scalable h100"][0]["picks"]
    for k in keys[1:]:
        bf16[k]["vs_scalable_h100"] = compare_picks(
            base, runs[k][0]["picks"], BF16_MARGIN, f"bf16 {k} vs scalable h100")
    for r in runs.values():
        for run_ in r:
            run_.pop("picks")
    print(f"  training, float32: one step's loss and gradients at h100_vl512 "
          f"(CPU: tpu_vl512), full width cut to 2 layers, seq 128, batch 2")
    train = train_card_vs_cpu(cfg.name, 2, 128, 2, 1e-5, hw_name="h100_vl512")
    paths = {f"layout bf16 {k}": r["runs"][0]["launches"] for k, r in bf16.items()}
    return {"f32": f32, "bf16": bf16, "train_f32_vl512": train}, paths, checks


TRAIN_BATCH, TRAIN_SEQ = 4, 1024     # 4,096 tokens a step: chunked_attention


def train_launches_per_step(layers: int, remat: bool) -> dict:
    """Kernel launches of one train step (forward + backward) of the dense
    model with tied embeddings, no prepacked weights: per layer 7 linears
    (each packs its weight; Q/K/V write unpacked, so their gradient is
    packed back), the O linear's input pack, and the gate's pre-activation
    recomputed in its backward; plus the stream entry and the tied head.
    ``remat`` runs each layer's forward twice."""
    per = {"mmt4d": 8, "mmt4d_dgrad": 7, "mmt4d_wgrad": 7, "pack": 11,
           "unpack": 8, "ragged_attn": 0}
    once = {"mmt4d": 1, "mmt4d_dgrad": 1, "mmt4d_wgrad": 1, "pack": 3,
            "unpack": 2, "ragged_attn": 0}
    out = {k: per[k] * layers + once[k] for k in per}
    if remat:
        out["mmt4d"] += 7 * layers
        out["pack"] += 8 * layers
    return out


def state_held(state, allocated0: int, requested0: int) -> dict:
    """What the caching allocator holds for a train state just built:
    the allocated and requested bytes since (``allocated0``, ``requested0``)
    and, from the allocator's snapshot, each leaf's block (its size and
    the bytes requested of it).  A block is the request rounded up to 512
    bytes, unless the allocator left a remainder of at most 1 MiB of a
    large segment unsplit, which the block keeps (``unsplit``)."""
    from repro_torch.training.optimizer import leaves
    torch.cuda.synchronize()
    ts = leaves({"p": state.params, "o": state.opt_state})
    ptrs = {t.untyped_storage().data_ptr() for t in ts}
    blocks = []
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated" and addr in ptrs:
                blocks.append((b["size"], b["requested_size"]))
            addr += b["size"]
    rounded = sum(-(-req // 512) * 512 for _, req in blocks)
    return {"allocated": torch.cuda.memory_allocated() - allocated0,
            "requested": requested_bytes() - requested0, "leaves": len(ts),
            "storages": len(ptrs), "blocks_found": len(blocks),
            "block_bytes": sum(size for size, _ in blocks), "rounded_512": rounded,
            "unsplit": sum(size for size, _ in blocks) - rounded}


def requested_bytes() -> int:
    """The caching allocator's requested bytes now (unrounded)."""
    return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)


def train_run(model, run, steps, label, ckpt_dir=None, fail_at=None,
              total_steps=None, ckpt_every=50, want=None, gen=None,
              measure_state=False) -> dict:
    """``Trainer.fit`` on SyntheticLM with the wrapper counts set to 0 just
    before and read just after (checked per step against ``want``, by
    default the dense model's :func:`train_launches_per_step`), each step
    timed by the trainer (to its loss read, which waits for the step); the
    first step runs eagerly and captures the step's graph, every later one
    replays it (exactly one capture, checked); peak device memory from a
    reset.  ``gen``: the init's generator (default a CPU one, seed 0).
    ``measure_state``: what the allocator holds for the state right after
    the trainer builds it (:func:`state_held`), under ``"held"``."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.trainer import Trainer
    data = SyntheticLM(model.cfg, model.shape, seed=0)
    tr = Trainer(model, data, run, ckpt_dir=ckpt_dir, total_steps=total_steps or steps,
                 ckpt_every=ckpt_every, keep=1, log_fn=lambda m: print("   ", m))
    held = {}
    if measure_state:
        init = tr.init_state

        def measured(generator):
            torch.cuda.synchronize()
            a0, r0 = torch.cuda.memory_allocated(), requested_bytes()
            state = init(generator)
            held.update(state_held(state, a0, r0))
            return state
        tr.init_state = measured
    times = tr.step_ms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        state, hist = tr.fit(gen or torch.Generator().manual_seed(0), steps=steps,
                             fail_at=fail_at)
    except RuntimeError as e:
        if fail_at is None or "injected failure" not in str(e):
            raise
        return {"crashed": str(e), "steps": len(times)}
    launches = kernels.launch_counts()
    counters = kernels.counters()
    n = len(times)
    if want is None:
        want = train_launches_per_step(model.cfg.n_layers, run.remat)
    for k, per in want.items():
        if launches[k] != per * n:
            raise AssertionError(f"{label} {k}: {launches[k]} launches over {n} "
                                 f"steps, expected {per} a step")
    if tr.step_fn.captures != 1:
        raise AssertionError(f"{label}: {tr.step_fn.captures} captures over {n} "
                             f"steps of one signature, expected 1")
    steady = sorted(times[1:] or times)
    ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    capture_s = tr.step_fn.capture_seconds
    print(f"  {label}: {n} steps, loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
          f"{ms:.1f} ms per step (median of the replays after the first, "
          f"which took {times[0]:.1f}: the eager step and its capture of "
          f"{capture_s:.3f} s), {tokens / ms * 1e3:.0f} tokens/s, peak "
          f"{peak:.2f} GiB allocated ({peak_reserved:.2f} reserved); 1 capture; "
          f"launches per step {dict((k, launches[k] // max(1, n)) for k in want)}")
    return {"state": state, "history": hist, "steps": n, "ms_per_step": ms,
            "step_ms": list(times), "first_step_ms": times[0], "capture_s": capture_s,
            "tokens_per_s": tokens / ms * 1e3, "peak_gib": peak,
            "peak_reserved_gib": peak_reserved, "launches": launches,
            "counters": counters, **({"held": held} if measure_state else {})}


def bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal bit for bit (a NaN equals a NaN of the same bits)."""
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def training_phase(cfg, card) -> tuple:
    """f32 card vs CPU, then bf16 full depth through the compiled step (20
    steps, then 8-bit AdamW with compression, then remat), replay = eager
    in five configurations, the launcher with --profile, then a crash and
    resume bit for bit."""
    import dataclasses as dc
    import gc
    import shutil
    import tempfile
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import leaves
    out, by_path = {}, {}
    print(f"training, float32: one step's loss and gradients, full-width "
          f"SmolLM2 cut to 2 layers, seq 128, batch 2, card vs CPU plain path "
          f"({card})")
    out["f32"] = train_card_vs_cpu(cfg.name, 2, 128, 2, 1e-5)

    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    # bfloat16, the default lr with the first step at full lr: at full width
    # 20 steps can only cut the random logits' spread, and a larger lr adds
    # more noise than that removes (PERF.md)
    base = RunConfig(remat=False, warmup_steps=1)
    print(f"training, bfloat16: full-width SmolLM2 (30 layers), seq {TRAIN_SEQ} "
          f"(chunked_attention), batch {TRAIN_BATCH}, SyntheticLM, lr "
          f"{base.lr:g}, warmup {base.warmup_steps} ({card})")
    for key, run, steps in (("bf16", base, 20),
                            ("bf16 8bit+compression",
                             dc.replace(base, adam_8bit=True, grad_compression=True), 5),
                            ("bf16 remat", dc.replace(base, remat=True), 5)):
        # every run on the 20-step schedule, so the first 5 steps' lr agree
        r = train_run(build_model(cfg, run, shape, device="cuda"), run, steps, key,
                      total_steps=20)
        r.pop("state")
        by_path[f"train {key}"] = r.pop("launches")
        out[key] = r
        gc.collect()
    print(f"training, replay = eager bit for bit: 5 steps each through the "
          f"compiled step's eager fn and through its graph, from one init "
          f"({card})")
    f32 = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                    warmup_steps=1)
    out["replay"] = {}
    for key, c, run, shp in (
            ("bf16", cfg, base, shape),
            ("bf16 8bit+compression", cfg,
             dc.replace(base, adam_8bit=True, grad_compression=True), shape),
            ("bf16 remat", cfg, dc.replace(base, remat=True), shape),
            ("bf16 microbatch=2", cfg, dc.replace(base, microbatch=2), shape),
            ("f32 2 layers seq 128 batch 2", dc.replace(cfg, n_layers=2), f32,
             ShapeSpec("train", 128, 2, "train"))):
        out["replay"][key] = train_replay_check(
            build_model(c, run, shp, device="cuda"), run, 5, key)
        gc.collect()

    h = out["bf16"]["history"]
    first, last = float(np.mean(h[:5])), float(np.mean(h[-5:]))
    print(f"  bf16: every loss finite: {bool(np.all(np.isfinite(h)))}; mean loss "
          f"of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    if not (np.all(np.isfinite(h)) and last < first):
        raise AssertionError(f"bf16 training: a loss not finite, or the loss did "
                             f"not fall ({first} -> {last})")
    # remat recomputes the forward bit for bit on the same schedule, so the
    # histories agree
    same_remat = out["bf16 remat"]["history"] == h[:5]
    # one init and one first batch: the first loss of every run agrees; the
    # JAX package's 8-bit moments with compressed bf16 gradients diverge
    # after a few steps on its own reduced model too (ROADMAP C), so the
    # later losses are printed and not held to anything
    h8 = out["bf16 8bit+compression"]["history"]
    print(f"  remat history = the first 5 steps without remat, bit for bit: "
          f"{same_remat}; 8-bit+compression first loss = the AdamW run's: "
          f"{h8[0] == h[0]} (losses {[round(x, 4) for x in h8]})")
    if not (same_remat and h8[0] == h[0]):
        raise AssertionError("bf16 training: remat or 8-bit run's losses differ")
    print(f"  peak memory with graphs, remat off {out['bf16']['peak_gib']:.2f} GiB "
          f"allocated ({out['bf16']['peak_reserved_gib']:.2f} reserved), on "
          f"{out['bf16 remat']['peak_gib']:.2f} GiB "
          f"({out['bf16 remat']['peak_reserved_gib']:.2f})")

    print(f"training, the launcher: python -m repro_torch.launch.train --steps 4 "
          f"--seq {TRAIN_SEQ} --batch {TRAIN_BATCH} --dtype bfloat16 --profile "
          f"(device time by kernel over steps 3-4, graph replays; {card})")
    from repro_torch.launch import train as launch_train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        _, hist = launch_train.main(["--steps", "4", "--seq", str(TRAIN_SEQ),
                                     "--batch", str(TRAIN_BATCH), "--dtype",
                                     "bfloat16", "--profile",
                                     os.path.join(tmp, "train.json.gz")])
    if not np.all(np.isfinite(hist)):
        raise AssertionError(f"launcher: loss not finite: {hist}")

    print(f"training, crash and resume: bf16 full width, 6 steps, checkpoints "
          f"every 3, a crash injected at step 4, resumed from step 3; history "
          f"and final parameters held to an uninterrupted run bit for bit ({card})")
    model = build_model(cfg, base, shape, device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        kw = dict(total_steps=6, ckpt_every=3)
        ref = train_run(model, base, 6, "uninterrupted",
                        ckpt_dir=os.path.join(tmp, "ref"), **kw)
        crash = train_run(model, base, 6, "crash", ckpt_dir=os.path.join(tmp, "a"),
                          fail_at=4, **kw)
        print(f"  crash: {crash['crashed']} after {crash['steps']} steps")
        res = train_run(model, base, 6, "resumed", ckpt_dir=os.path.join(tmp, "a"), **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same_hist = res["history"] == ref["history"][3:]
    same_params = all(torch.equal(a, b) for a, b in zip(
        leaves({"p": ref["state"].params, "o": ref["state"].opt_state}),
        leaves({"p": res["state"].params, "o": res["state"].opt_state})))
    print(f"  resumed history {res['history']} vs uninterrupted "
          f"{ref['history'][3:]}: {'equal' if same_hist else 'DIFFER'}; final "
          f"parameters and optimizer state {'equal' if same_params else 'DIFFER'} "
          f"bit for bit")
    if not (same_hist and same_params and res["state"].step == 6):
        raise AssertionError("crash/resume: not bitwise equal to the uninterrupted run")
    out["crash_resume"] = {"history": ref["history"], "resumed": res["history"],
                           "equal": True}
    by_path["train crash-resume"] = res["launches"]
    return out, by_path


# --------------------------------------------------- dense configs and vlm

# the served configs at full width: Qwen3-8B whole through the flat drain
# in bfloat16; Qwen2-7B (QKV bias, g = 7), ChatGLM3-6B (partial 2d RoPE, QKV
# bias, g = 16) and OLMo-1B (non-parametric LayerNorm, MHA, tied head), each
# cut to DENSE_F32_LAYERS layers; InternVL2-26B's language model through
# the static loop, cut to VLM_LAYERS of its 48 layers in bfloat16 (all 48
# do not fit beside a prepacked copy) and to VLM_F32_LAYERS in float32.
# The f32 checks run the CPU's plain path beside the card, which sets the
# phase's time (InternVL2's took 233 s at 2 layers on an H100 machine with
# a slow host CPU): their depth was cut from 2 to 1 when the moe phase
# came, keeping each config's feature; RWKV-6's f32 check keeps
# PARITY_LAYERS.  InternVL2's f32 check decodes VLM_F32_NEW tokens, not
# the static batch's 32, since jamba's phase came: each CPU decode step
# reads the 2.3 GB float32 head (89.5 s for 32 on an H100 machine)
PARITY_ARCHS = ("qwen2-7b", "chatglm3-6b", "olmo-1b")
PARITY_LAYERS, VLM_LAYERS, VLM_F32_BATCH, VLM_F32_NEW = 2, 8, 2, 8
DENSE_F32_LAYERS, VLM_F32_LAYERS = 1, 1


def flat_per_call(cfg) -> tuple:
    """(launches per flat model call by kernel, mmt4d unpacked stores per
    call): per layer Q/K/V/O, gate, up and down (Q/K/V stored unpacked),
    the O linear's input pack and one ragged attention; the stream entry
    pack, the final stream's unpack and the logits rows' pack; the head
    stored unpacked, its weight packed per call when it is the tied
    embedding (SmolLM2-135M: EXPECTED_PER_STEP)."""
    n = cfg.n_layers
    return ({"mmt4d": 7 * n + 1, "pack": 2 + n + int(cfg.tie_embeddings),
             "unpack": 1, "ragged_attn": n}, 3 * n + 1)


def by_request(picks: dict) -> list:
    """A drain's picks as each request's tokens, in request order."""
    rids = sorted({r for r, _ in picks})
    return [[t for (r, _), (t, _) in sorted(picks.items()) if r == rid]
            for rid in rids]


def qwen3_full(card) -> tuple:
    """Qwen3-8B at its published widths and full depth (36 layers, d 4096,
    32 query heads over 8 KV heads of 128, qk_norm, d_ff 12288, vocab
    151936, untied head, rope_theta 1e6) in bfloat16 through the §4 flat
    drain (8 requests, prompts 64-512, 32 new, 4 slots, 16-token pages,
    seq_len 1024, chunk_tokens 128): weights drawn on the card, prepacked;
    warmup (one graph per flat width); the drain with drain_bf16's checks
    at this model's launches per call; a second drain of the same requests
    that captures nothing and repeats the first's tokens.  Prints ms per
    step and tokens/s beside the weight-bytes bound, launches per step by
    kernel, peak memory and the init, prepack and warmup seconds."""
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import query
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = get_config("qwen3-8b")
    hw = query("cuda", "h100")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    step_bytes = weight_bytes - params["embed"]["e"].numel() * 2
    t0 = time.perf_counter()
    eng = Engine(model, params, device="cuda", max_slots=4, page_tokens=16,
                 chunk_tokens=128)
    torch.cuda.synchronize()
    prepack_s = time.perf_counter() - t0
    del params          # the engine keeps the prepacked copy (and the table)
    bound_ms = 1e3 * weight_bytes / hw.hbm_bw
    step_bound_ms = 1e3 * step_bytes / hw.hbm_bw
    print(f"  qwen3-8b: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
          f"query heads over {cfg.n_kv_heads} of {cfg.d_head}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}; {cfg.param_counts()['total']} parameters, "
          f"{weight_bytes / 1e9:.3f} GB in bf16, drawn on the card in "
          f"{init_s:.2f} s, prepacked in {prepack_s:.2f} s ({card})")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    print(f"  qwen3-8b prompts {lens.tolist()}")
    rec = PickRecorder(eng)
    expected = flat_per_call(cfg)
    first = drain_bf16(cfg, "flat", prompts, eng, expected=expected)
    first.pop("engine")
    first_picks = dict(rec.picks)
    check_path_launches("qwen3-8b flat bf16", first["launches"], True)
    second = timed_drain(eng, [(p, 32, 0.0) for p in prompts], True, 0,
                         "qwen3-8b bf16 flat, second drain")
    if by_request(second.pop("picks")) != by_request(first_picks):
        raise AssertionError("qwen3-8b: the second drain's tokens differ from "
                             "the first's")
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / first["steps"] for k, v in first["launches"].items() if v}
    print(f"  qwen3-8b: {first['ms_per_step']:.4f} ms per step "
          f"({first['tokens_per_s']:.2f} tokens/s), second drain "
          f"{second['ms_per_step']:.4f} ms per step ({second['tokens_per_s']:.2f} "
          f"tokens/s, no capture, same tokens); bound: every weight read once a "
          f"step, {weight_bytes / 1e9:.3f} GB / {hw.hbm_bw / 1e12:.2f} TB/s = "
          f"{bound_ms:.4f} ms ({step_bound_ms:.4f} ms without the embedding "
          f"table, of which a step gathers rows only); launches per step "
          f"{per_step}; peak memory {peak / 2**30:.2f} GiB; warmup "
          f"{first['warmup_s']:.3f} s ({card})")
    res = {**first, "second": second, "init_s": init_s, "prepack_s": prepack_s,
           "weight_bytes": weight_bytes, "bound_ms": bound_ms,
           "step_bound_ms": step_bound_ms, "peak_bytes": peak,
           "launches_per_step": per_step, "card": card}
    del eng, rec
    return res, {"qwen3-8b flat bf16": first["launches"],
                 "qwen3-8b flat bf16 second": second["launches"]}


def dense_parity(arch, card) -> tuple:
    """One config at its published widths cut to DENSE_F32_LAYERS layers:
    weights drawn once on the card serve both sides (the CPU's drain on
    the CPU's thread, compared when it ends); the f32 flat drain
    (4 requests of 5-24 tokens, 8 new) on the card after warmup equals the
    CPU plain path's token for token with the first call's logits within
    F32_MARGIN of the logits' own scale (max(1, max |logit|): float32 sums
    of up to d_ff = 18,944 products in another order); a bf16 drain on the card over the same weights, rounded,
    whose picks agree with the f32 card drain's wherever both top-2
    margins are at least BF16_MARGIN, with every kernel of the path
    launched as many times per model call as the config makes."""
    import dataclasses
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving.engine import Engine
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=DENSE_F32_LAYERS)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in rng.integers(5, 25, 4)]
    f32 = RunConfig(param_dtype="float32", compute_dtype="float32")
    shape = ShapeSpec("serve", 64, 4, "decode")
    params = build_model(cfg, f32, shape, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    cpu = to_cpu_thread(serve_f32, "cpu", cfg, prompts, "flat", params=params)
    t0 = time.perf_counter()
    cuda_toks, cuda_first, cuda_picks, info = serve_f32("cuda", cfg, prompts,
                                                        "flat", params=params)
    print(f"  {arch} ({DENSE_F32_LAYERS} of {full.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} over {cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) f32 flat: graphs "
          f"{info['captures']}, replay = eager at {info['replay_checked']} "
          f"shapes; card {time.perf_counter() - t0:.1f} s")
    out = {"layers": DENSE_F32_LAYERS, "tokens": cuda_toks, **info}

    def check(res):
        cpu_toks, cpu_first, cpu_picks, _ = res
        diff = float(np.abs(cuda_first - cpu_first).max())
        scale = max(1.0, float(np.abs(cpu_first).max()))
        print(f"  {arch} f32 flat: first call max |logit diff| {diff:.3e} (max "
              f"|logit| {scale:.3f})")
        cmp = compare_picks(cuda_picks, cpu_picks, 0.0, f"{arch} f32 card vs cpu")
        if cuda_toks != cpu_toks or diff > F32_MARGIN * scale:
            raise AssertionError(f"{arch}: f32 card {cuda_toks} vs CPU {cpu_toks}, "
                                 f"first logits {diff:.3e} apart (limit "
                                 f"{F32_MARGIN:g} x {scale:.3f})")
        out.update(first_logit_diff=diff, max_logit=scale, f32_vs_cpu=cmp)
    CPU_RUNS.defer(f"{arch} f32 flat", cpu, check)
    if info["replay_checked"] < 2:
        raise AssertionError(f"{arch}: replay checked at {info['replay_checked']} "
                             f"shapes, not 2")
    bf = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model(cfg, bf, shape, device="cuda")
    eng = Engine(model, tree_map(lambda t: t.to(BF), params), device="cuda",
                 max_slots=4, page_tokens=16, **FAMILIES_F32["flat"])
    del params
    eng.warmup()
    calls = count_model_calls(eng)
    bf16 = timed_drain(eng, [(p, 8, 0.0) for p in prompts], True, 0,
                       f"{arch} bf16 flat")
    per, _ = flat_per_call(cfg)
    for k, n in per.items():
        if bf16["launches"][k] != n * len(calls):
            raise AssertionError(f"{arch} bf16 {k}: {bf16['launches'][k]} launches "
                                 f"over {len(calls)} calls, expected {n} per call")
    bf16["vs_f32"] = compare_picks(cuda_picks, bf16.pop("picks"), BF16_MARGIN,
                                   f"{arch} bf16 vs f32 (card)")
    del eng
    out["bf16"] = bf16
    return out, {f"{arch} flat bf16": bf16["launches"]}


def internvl2_static(card) -> tuple:
    """InternVL2-26B's language model (d 6144, 48 query heads over 8 of
    128, d_ff 16384, vocab 92553: a partial last tile) behind its stub
    vision prefix, through generate_static: rows of 256 patch embeddings +
    a 256-token prompt, seq_len 1024.  float32 at VLM_F32_LAYERS layers,
    VLM_F32_BATCH rows and VLM_F32_NEW new tokens (the CPU's plain path
    is most of the phase's time, and grows with the rows and the steps),
    32 new in bfloat16; card = CPU token for token,
    weights drawn once on the card (the CPU's run on the CPU's thread);
    bfloat16 at VLM_LAYERS layers and 4 rows, weights drawn on the
    card.  Each card run is static_run's: a first call capturing the
    prefill and decode graphs, a second capturing nothing with its
    launches per call and once per batch (the vision prefix) checked,
    prefill and decode ms."""
    import dataclasses
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    full = get_config("internvl2-26b")
    res, paths = {}, {}
    for dtype, layers, nb, new in ((TF, VLM_F32_LAYERS, VLM_F32_BATCH, VLM_F32_NEW),
                                   (BF, VLM_LAYERS, STATIC_BATCH, STATIC_NEW)):
        name = str(dtype)[6:]
        cfg = dataclasses.replace(full, n_layers=layers)
        model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                            ShapeSpec("serve", STATIC_SEQ, nb, "decode"),
                            device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        print(f"  internvl2-26b {name}: {layers} of {full.n_layers} layers, "
              f"{cfg.param_counts()['total']} parameters, d {cfg.d_model}, "
              f"vocab {cfg.vocab}; batch {nb} x ({cfg.vision_tokens} "
              f"patches + prompt {STATIC_PROMPT}), {new} new ({card})")
        label = f"internvl2-26b static {name} ({layers} layers)"
        if dtype is TF:     # the plain versions, on the CPU's thread
            cpu = to_cpu_thread(static_cpu, cfg, params=params, batch=nb, new=new)
        r = static_run(cfg, dtype, label, params=params, batch=nb, new=new)
        del params, model
        picks = r.pop("picks")
        if dtype is TF:
            def check(cpu_res, label=label, r=r, picks=picks):
                r["vs_cpu_f32"] = compare_picks(picks, cpu_res["picks"], 0.0,
                                                f"{label} card vs CPU")
                if not np.array_equal(np.asarray(r["tokens"]), cpu_res["tokens"]):
                    raise AssertionError(f"{label}: tokens card != CPU")
                print(f"  {label} tokens, card = CPU: "
                      f"{np.asarray(r['tokens'])[:, :8].tolist()} ...")
            CPU_RUNS.defer(label, cpu, check)
        res[name] = {"layers": layers, "batch": nb, **r}
        paths[f"static internvl2-26b {name}"] = r["launches"]
    return res, paths


def dense_phase(card) -> tuple:
    """Qwen3-8B whole, the three parity configs and InternVL2; returns
    (results, launches by path)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    res, paths = {}, {}
    res["qwen3-8b"], p = qwen3_full(card)
    paths.update(p)
    for arch in PARITY_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        res[arch], p = dense_parity(arch, card)
        paths.update(p)
    gc.collect()
    torch.cuda.empty_cache()
    res["internvl2-26b"], p = internvl2_static(card)
    paths.update(p)
    return res, paths

RWKV_SLOTS, RWKV_REQUESTS, RWKV_NEW = 4, 8, 32


def rwkv_per_call(cfg) -> tuple:
    """(launches per model call of an RWKV model by kernel, mmt4d unpacked
    stores per call), a prefill's and a decode step's alike: per layer the
    8 linears (time-mix r, k, v, g, o; channel-mix k, r, v), each stored
    unpacked, 10 packs (the inputs of those 8, each mixer's output into the
    packed stream), 2 unpacks (the normed stream into each mixer) and one
    wkv6; the stream entry pack, the final stream's unpack, the logits
    rows' pack and the untied head, stored unpacked."""
    n = cfg.n_layers
    return ({"mmt4d": 8 * n + 1, "pack": 10 * n + 2, "unpack": 2 * n + 1,
             "ragged_attn": 0, "wkv6": n}, 8 * n + 1)


def rwkv_full(card) -> tuple:
    """RWKV-6 1.6B at its published widths and depth (24 layers, d 2048, 32
    heads of 64, d_ff 7168, vocab 65536, untied head, LayerNorm) in bf16,
    weights drawn on the card, through the monolithic engine (4 slots,
    seq_len 1024): warmup (the decode[4,1] graph), then the §4 requests
    (8, prompts 64-512, 32 new, greedy), each distinct prompt length
    capturing its exact-length prefill graph at its first prefill; the
    launches of every model call checked (rwkv_per_call); then a second
    drain of the same requests that captures nothing and repeats the
    first's tokens.  Prints ms per step and tokens/s beside the bound (each
    weight but the embedding table read once and the slots' state read and
    written once a decode step), captures, warmup seconds and peak
    memory."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import query
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = get_config("rwkv6-1.6b")
    hw = query("cuda", "h100")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, RWKV_SLOTS,
                                                    "decode"), device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    step_bytes = weight_bytes - params["embed"]["e"].numel() * 2
    eng = Engine(model, params, device="cuda", max_slots=RWKV_SLOTS,
                 page_tokens=16)
    del params
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(eng.caches))
    bound_ms = 1e3 * (step_bytes + 2 * state_bytes) / hw.hbm_bw
    print(f"  rwkv6-1.6b: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {cfg.param_counts()['total']} "
          f"parameters, {weight_bytes / 1e9:.4f} GB in bf16 (the embedding "
          f"table {(weight_bytes - step_bytes) / 1e9:.4f} GB of it), drawn on "
          f"the card in {init_s:.2f} s; per-slot state "
          f"{state_bytes / RWKV_SLOTS / 1e6:.3f} MB ({card})")
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    graphs = dict(eng.stats()["captures"])
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, RWKV_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    print(f"  rwkv6-1.6b prompts {lens.tolist()}; warmup {warm_s:.3f} s, graphs "
          f"{graphs}")
    rec = PickRecorder(eng)
    calls = count_model_calls(eng)
    rids = [eng.add_request(p, RWKV_NEW) for p in prompts]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    unpacked = kernels.wrappers()["mmt4d"].unpacked_stores
    del eng._run_paged                     # the call counter
    st = eng.stats()
    n = len(calls)
    if sorted(r.rid for r in fin) != sorted(rids) or any(
            r.finish_reason != "length" or len(r.out_tokens) != RWKV_NEW
            for r in fin):
        raise AssertionError("rwkv6-1.6b: not every request finished")
    if not all(np.isfinite(c).all() for c in calls):
        raise AssertionError("rwkv6-1.6b: non-finite logits")
    per, per_unpacked = rwkv_per_call(cfg)
    for k, want in per.items():
        if launches[k] != want * n:
            raise AssertionError(f"rwkv6-1.6b {k}: {launches[k]} launches over "
                                 f"{n} model calls, expected {want} per call")
    if unpacked != per_unpacked * n:
        raise AssertionError(f"rwkv6-1.6b: {unpacked} unpacked stores over {n} "
                             f"calls, expected {per_unpacked} per call")
    captured = st["captures"]["paged"] - graphs["paged"]
    if captured != len(set(lens.tolist())):
        raise AssertionError(f"rwkv6-1.6b: {captured} graphs captured in the "
                             f"drain for {len(set(lens.tolist()))} prompt lengths")
    first_picks = dict(rec.picks)
    ntok = sum(len(r.out_tokens) for r in fin)
    first = {"steps": st["steps"], "model_calls": n, "wall_s": wall,
             "ms_per_step": 1e3 * wall / st["steps"], "tokens": ntok,
             "tokens_per_s": ntok / wall, "launches": launches,
             "unpacked_stores": unpacked, "captured_in_drain": captured}
    print(f"  rwkv6-1.6b bf16 monolithic, first drain: {st['steps']} steps, {n} "
          f"model calls, {wall:.3f} s wall, {first['ms_per_step']:.4f} ms per "
          f"step, {ntok / wall:.2f} generated tokens/s, {captured} prefill "
          f"graphs captured (one per prompt length); launches per model call "
          f"{ {k: v / n for k, v in launches.items() if v} }, unpacked stores "
          f"{unpacked / n} per call")
    second = timed_drain(eng, [(p, RWKV_NEW, 0.0) for p in prompts], True, 0,
                         "rwkv6-1.6b bf16 monolithic, second drain")
    if by_request(second.pop("picks")) != by_request(first_picks):
        raise AssertionError("rwkv6-1.6b: the second drain's tokens differ from "
                             "the first's")
    peak = torch.cuda.max_memory_allocated()
    print(f"  rwkv6-1.6b: second drain {second['ms_per_step']:.4f} ms per step, "
          f"{second['tokens_per_s']:.2f} generated tokens/s (no capture, same "
          f"tokens); bound of a decode step: every weight but the embedding "
          f"table read once and 4 slots' state read and written once, "
          f"({step_bytes / 1e9:.4f} + 2 x {state_bytes / 1e9:.4f}) GB / "
          f"{hw.hbm_bw / 1e12:.2f} TB/s = {bound_ms:.4f} ms; captures "
          f"{graphs['paged']} at warmup + {captured} in the first drain; peak "
          f"memory {peak / 2**30:.2f} GiB ({card})")
    res = {**first, "second": second, "init_s": init_s, "warmup_s": warm_s,
           "warmup_graphs": graphs, "weight_bytes": weight_bytes,
           "step_bytes": step_bytes, "state_bytes": state_bytes,
           "bound_ms": bound_ms, "peak_bytes": peak,
           "prompt_lens": lens.tolist(), "card": card}
    del eng, rec
    return res, {"rwkv6-1.6b monolithic bf16": launches,
                 "rwkv6-1.6b monolithic bf16 second": second["launches"]}


def recurrent_f32(device, cfg, prompts, params, new) -> tuple:
    """One float32 monolithic drain of a recurrent model (4 slots, seq_len
    64): tokens, the first model call's logits, the picks and the graphs
    captured (on the card: warmup's, then one per prompt length)."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    model = build_model(cfg, RunConfig(param_dtype="float32",
                                       compute_dtype="float32"),
                        ShapeSpec("serve", 64, 4, "decode"), device=device)
    eng = Engine(model, params, device=device, max_slots=4, page_tokens=16)
    eng.warmup()
    calls, picks = count_model_calls(eng), PickRecorder(eng)
    rids = [eng.add_request(p, new) for p in prompts]
    fin = {r.rid: r.out_tokens for r in eng.drain()}
    return [fin[r] for r in rids], calls[0], picks.picks, eng.stats()["captures"]


def recurrent_parity(label, cfg, params, prompts, new, card) -> dict:
    """The f32 monolithic drain on the card and on the CPU over the same
    weights (drawn on the card): identical tokens, first-call logits
    within F32_MARGIN of max(1, max |logit|) (the CPU's on its thread,
    compared when it ends)."""
    cpu = to_cpu_thread(recurrent_f32, "cpu", cfg, prompts, params=params, new=new)
    t0 = time.perf_counter()
    cuda_toks, cuda_first, cuda_picks, captures = recurrent_f32(
        "cuda", cfg, prompts, params, new)
    print(f"  {label} f32 monolithic: graphs {captures}; card "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    out = {"tokens": cuda_toks, "captures": captures}

    def check(res):
        cpu_toks, cpu_first, cpu_picks, _ = res
        diff = float(np.abs(cuda_first - cpu_first).max())
        scale = max(1.0, float(np.abs(cpu_first).max()))
        cmp = compare_picks(cuda_picks, cpu_picks, 0.0, f"{label} f32 card vs cpu")
        if cuda_toks != cpu_toks or diff > F32_MARGIN * scale:
            raise AssertionError(f"{label}: f32 card {cuda_toks} vs CPU {cpu_toks}, "
                                 f"first logits {diff:.3e} apart (limit "
                                 f"{F32_MARGIN:g} x {scale:.3f})")
        print(f"  {label} tokens, card = CPU: {cuda_toks}; first logits within "
              f"{diff / scale:.3e} of max(1, max |logit|) (limit {F32_MARGIN:g})")
        out.update(first_logit_diff=diff, max_logit=scale, vs_cpu=cmp)
    CPU_RUNS.defer(f"{label} f32 monolithic", cpu, check)
    return out


def recurrent_phase(card) -> tuple:
    """RWKV-6 1.6B whole in bf16 (rwkv_full); RWKV-6 at full width cut to
    PARITY_LAYERS layers in f32, card = CPU, and generate_static =
    generate on the card (jamba's mixers are held in the jamba phase).
    Returns (results, launches by path)."""
    import dataclasses
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    res["rwkv6-1.6b"], paths = rwkv_full(card)
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("rwkv6-1.6b")
    cfg = dataclasses.replace(full, n_layers=PARITY_LAYERS)
    f32 = RunConfig(param_dtype="float32", compute_dtype="float32")
    shape = ShapeSpec("serve", 64, 4, "decode")
    params = build_model(cfg, f32, shape, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in rng.integers(5, 25, 4)]
    label = f"rwkv6-1.6b ({PARITY_LAYERS} of {full.n_layers} layers)"
    res["rwkv6-1.6b f32"] = recurrent_parity(label, cfg, params, prompts, 8, card)
    eng = Engine(build_model(cfg, f32, shape, device="cuda"), params,
                 device="cuda", max_slots=4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    static = eng.generate_static(batch, 8)
    gen = eng.generate(batch, 8)
    if not np.array_equal(static, gen):
        raise AssertionError(f"{label}: generate_static {static.tolist()} != "
                             f"generate {gen.tolist()}")
    print(f"  {label} f32: generate_static = generate on the card, batch 4 x "
          f"16 tokens, 8 new: {static.tolist()}")
    res["rwkv6-1.6b f32"]["static_equals_generate"] = True
    del eng, params
    return res, paths


MOE_ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
# f32 card = CPU depth: one qwen3-moe layer holds 9.7 GB of f32 experts (2
# until the family training phase came, to hold the run's wall); one
# arctic layer holds 53.5 GB (two would not fit the card)
MOE_F32_LAYERS = {"qwen3-moe-235b-a22b": 1, "arctic-480b": 1,
                  # jamba's first period: 7 mamba mixers, attention, 4 moe
                  # layers (51 GB of f32 weights)
                  "jamba-v0.1-52b": 8}
MOE_F32_FAMILIES = ("flat", "monolithic")
MOE_F32_NEW = 4
# the bf16 depth: the most layers whose reckoned peak (weights, the larger
# of the prepack's and the init's transient, MOE_POOL_BYTES) stays under
# MOE_FIT of the card's memory
MOE_POOL_BYTES = 2 * 2**30      # graph pool, KV pages, activations
MOE_FIT = 0.95


def moe_per_call(cfg) -> tuple:
    """(launches per flat model call by kernel, mmt4d unpacked stores, of
    them expert-batched) of a model whose every layer is moe: per layer the
    attention's Q/K/V/O (Q/K/V stored unpacked), the O input's pack and a
    ragged attention; the moe FFN's unpack of the packed stream, the pack
    of the dispatched [E, C, d] and of the gate x up product, the gate, up
    and down expert-batched launches (each stored unpacked) and the pack of
    its output into the stream; arctic's dense branch 3 more mmt4d (the
    down projection stored unpacked); the stream entry pack, the final
    stream's unpack, the logits rows' pack and the untied head."""
    n, dense = cfg.n_layers, int(cfg.dense_residual)
    return ({"mmt4d": n * (7 + 3 * dense) + 1, "pack": 4 * n + 2,
             "unpack": n + 1, "ragged_attn": n},
            n * (6 + dense) + 1, 3 * n)


def dry_bytes(tree) -> int:
    """The dry-run's bytes per device of a parameter tree on a one-rank
    mesh (every leaf whole), from the tree's meta tensors."""
    from repro_torch.configs import RunConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((1, 1), ("data", "model"))
    return sharding.device_bytes(tree, sharding.param_specs(tree, RunConfig(), mesh), mesh)


def meta_params(cfg, layers: int) -> dict:
    """``cfg``'s bf16 parameter tree cut to ``layers`` layers, on the meta
    device (the dry-run's: nothing allocated)."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.core.hardware import query
    from repro_torch.launch.dryrun import MetaGenerator
    from repro_torch.models.model import build_model
    model = build_model(dataclasses.replace(cfg, n_layers=layers), RunConfig(),
                        ShapeSpec("meta", 1024, 4, "decode"),
                        hw=query("cuda", "h100"), device="meta")
    return model.init(MetaGenerator())


def expert_leaf_bytes(groups: dict) -> int:
    """The largest expert leaf ([G, E, K, N]) of a stacked layer tree, a
    group's share of it."""
    from repro_torch.distributed import sharding
    return max(dry_bytes({"w": t}) // t.shape[0]
               for path, t in sharding.tree_paths(groups).items()
               if path.endswith(("wu/w", "wg/w", "wd/w")) and t.ndim == 4)


def moe_bytes(cfg) -> tuple:
    """(bytes of one layer's weights in bf16, of the embedding, head and
    final norm, of one layer's largest expert leaf), the dry-run's bytes
    of the config's meta tree at one layer."""
    p = meta_params(cfg, 1)
    layer = dry_bytes(p["groups"])
    return layer, dry_bytes(p) - layer, expert_leaf_bytes(p["groups"])


def moe_depth(cfg, total: int) -> tuple:
    """The bf16 depth and its reckoning (printed): for L layers, the
    weights, plus the larger transient: the prepack's packed copy of one
    stacked expert leaf ([L, E, K, N], while its unpacked one lives) or
    the init's one layer drawn beside the stack (and its float32 block of
    1 GiB), plus MOE_POOL_BYTES."""
    layer, fixed, leaf = moe_bytes(cfg)
    best, rows = 0, []
    for n in range(1, cfg.n_layers + 1):
        init = (layer if n > 1 else 0) + 2**30
        peak = fixed + n * layer + max(n * leaf, init) + MOE_POOL_BYTES
        rows.append((n, peak))
        if peak <= MOE_FIT * total:
            best = n
        else:
            break
    return best, rows, (layer, fixed, leaf)


_ROUTES = threading.local()      # the routing record of this thread, if any


def route_recorder():
    """Record each eager call of the moe layer's routing made on this
    thread: its float32 router probabilities and top-k choices (host
    arrays); returns the list and the undo.  The routing is wrapped once
    for every thread (the CPU's thread records its own runs' while the
    card's driver records the card's)."""
    from repro_torch.models import moe
    if not getattr(moe._route, "records", False):
        orig = moe._route

        def rec(xf, w, k):
            out = orig(xf, w, k)
            seen = getattr(_ROUTES, "seen", None)
            if seen is not None:
                seen.append((out[1].float().cpu().numpy(), out[3].cpu().numpy()))
            return out
        rec.records = True
        moe._route = rec
    _ROUTES.seen = seen = []
    return seen, lambda: setattr(_ROUTES, "seen", None)


def route_forward(model, params, tokens) -> list:
    """One forward of ``tokens`` with this thread's routing recorded."""
    seen, undo = route_recorder()
    try:
        with torch.no_grad():
            model.forward(params, {"tokens": tokens[None]})
    finally:
        undo()
    return seen


def routing_check(label, k, card_routes, cpu_routes):
    """The routing of one forward on each side (route_forward): equal
    top-k choices in every moe layer, or at the first difference a
    top-k boundary margin (the CPU's k-th minus (k+1)-th probability of
    that token) below F32_MARGIN, printed; else the phase fails."""
    sides = [card_routes, cpu_routes]
    tokens = card_routes[0][1] if card_routes else ()
    diffs, first = 0, None
    for layer, ((_, e_card), (probs, e_cpu)) in enumerate(zip(*sides)):
        rows = np.nonzero((np.sort(e_card, 1) != np.sort(e_cpu, 1)).any(1))[0]
        diffs += len(rows)
        if len(rows) and first is None:
            srt = np.sort(probs[rows[0]])[::-1]
            first = (layer, int(rows[0]), float(srt[k - 1] - srt[k]))
    if len(card_routes) != len(cpu_routes):
        raise AssertionError(f"{label}: {len(card_routes)} moe layers routed on "
                             f"the card, {len(cpu_routes)} on the CPU")
    if first is None:
        print(f"  {label}: routing card = CPU in every moe layer "
              f"({len(sides[0])} layers x {len(tokens)} tokens, top-{k})")
        return {"routing_differs": 0}
    layer, row, margin = first
    print(f"  {label}: routing differs at {diffs} (token, layer) pairs; the first "
          f"(layer {layer}, token {row}) at a top-{k} boundary margin of "
          f"{margin:.3e} (limit {F32_MARGIN:g})")
    if not margin < F32_MARGIN:
        raise AssertionError(f"{label}: a routing choice differs at a top-k "
                             f"margin of {margin:.3e}")
    return {"routing_differs": diffs, "first_margin": margin}


def moe_cpu_side(cfg, prompts, families, params) -> tuple:
    """The CPU's half of moe_f32_parity, on the CPU's thread: the routing of
    one forward of the first prompt, and each family's drain (serve_f32)."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    f32 = RunConfig(param_dtype="float32", compute_dtype="float32")
    mh = build_model(cfg, f32, ShapeSpec("serve", 64, 4, "decode"),
                     hw=descriptor("cpu", "h100"), device="cpu")
    routes = route_forward(mh, params, torch.as_tensor(prompts[0]))
    return routes, {family: serve_f32("cpu", cfg, prompts, family, params=params,
                                      new=MOE_F32_NEW, drops=True)
                    for family in families}


def moe_f32_parity(arch, card) -> dict:
    """``arch`` at its published widths cut to MOE_F32_LAYERS[arch] layers
    in f32: weights drawn once on the card and packed there serve both
    sides (the CPU's a copy of the packed tree, run on the CPU's thread by
    moe_cpu_side and compared when it ends); routing card = CPU on one
    forward (routing_check); then each of MOE_F32_FAMILIES (a recurrent
    model: the monolithic step only) through
    serve_f32: 2 requests of 5-24 tokens, MOE_F32_NEW new, card after
    warmup (replay = eager checked) and CPU plain path: identical tokens,
    first-call logits within F32_MARGIN of max(1, max |logit|), equal
    dropped fractions."""
    import dataclasses
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.linear import prepack_params
    from repro_torch.models.model import build_model
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=MOE_F32_LAYERS[arch])
    f32 = RunConfig(param_dtype="float32", compute_dtype="float32")
    shape = ShapeSpec("serve", 64, 4, "decode")
    t0 = time.perf_counter()
    mc = build_model(cfg, f32, shape, hw=descriptor("cuda", "h100"), device="cuda")
    # packed on the card in place (each w dropped as its pack is made:
    # arctic's layer does not fit the card twice), then copied to the host:
    # the CPU's tiles are the card's (CPU_TWIN), and packing 56 GB on the
    # host would take most of a minute
    pc = prepack_params(mc.init(torch.Generator(device="cuda").manual_seed(0)),
                        mc.ctx, consume=True)
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in rng.integers(5, 25, 2)]
    families = (("monolithic",) if set(cfg.layer_types) - {"attn"}
                else MOE_F32_FAMILIES)
    label = f"{arch} f32 ({cfg.n_layers} layers)"
    card_routes = route_forward(mc, pc, torch.as_tensor(prompts[0]))
    nbytes = tree_bytes(pc)
    cpu = to_cpu_thread(moe_cpu_side, cfg, prompts, families, params=pc)
    print(f"  {arch} f32: {cfg.n_layers} of {full.n_layers} layers at full width, "
          f"{nbytes / 1e9:.2f} GB of packed f32 weights on each side, drawn, "
          f"packed and copied in {time.perf_counter() - t0:.1f} s ({card})")
    out = {"layers": cfg.n_layers, "weight_bytes": nbytes}
    card_runs = {}
    for family in families:
        t0 = time.perf_counter()
        ct, cf, cp, info = serve_f32("cuda", cfg, prompts, family, params=pc,
                                     new=MOE_F32_NEW, drops=True)
        card_runs[family] = (ct, cf, cp, info)
        print(f"  {arch} f32 {family}: replay = eager at {info['replay_checked']} "
              f"shapes, graphs {info['captures']}; card "
              f"{time.perf_counter() - t0:.1f} s")
        if info["replay_checked"] < 1:
            raise AssertionError(f"{arch} f32 {family}: replay checked at "
                                 f"{info['replay_checked']} shapes")
    del pc, mc
    gc.collect()
    torch.cuda.empty_cache()

    def check(res):
        cpu_routes, drains = res
        out.update(routing_check(label, cfg.top_k, card_routes, cpu_routes))
        for family in families:
            ct, cf, cp, info = card_runs[family]
            ht, hf, hp, hinfo = drains[family]
            cd, hd = info.pop("dropped_frac"), hinfo["dropped_frac"]
            diff = float(np.abs(cf - hf).max())
            scale = max(1.0, float(np.abs(hf).max()))
            print(f"  {arch} f32 {family}: first call max |logit diff| {diff:.3e} "
                  f"({diff / scale:.3e} of max(1, max |logit|) {scale:.3f}; limit "
                  f"{F32_MARGIN:g}), dropped fraction card {cd:.6f} CPU {hd:.6f}")
            cmp = compare_picks(cp, hp, 0.0, f"{arch} f32 {family} card vs cpu")
            if ct != ht or diff > F32_MARGIN * scale or cd != hd:
                raise AssertionError(f"{arch} f32 {family}: tokens {ct} vs {ht}, "
                                     f"logits {diff:.3e} apart (scale {scale:.3f}), "
                                     f"dropped {cd} vs {hd}")
            out[family] = {"tokens": ct, "first_logit_diff": diff, "max_logit": scale,
                           "dropped_frac": cd, "vs_cpu": cmp, **info}
        print(f"  {arch} f32: card = CPU token for token in {list(families)}")
    CPU_RUNS.defer(f"{arch} f32", cpu, check)
    return out


def moe_bf16(arch, card) -> tuple:
    """``arch`` at its published widths in bf16, cut in depth by
    moe_depth (printed with its reckoning), weights drawn on the card and
    packed in place; the §4 flat drain (8 requests, prompts 64-512, 32 new,
    chunk_tokens 128) with drain_bf16's checks (replay = eager, no capture,
    launches per model call by moe_per_call, expert-batched launches
    counted) and a DropCounter; then a second drain that captures nothing
    (its requests land in other slots, so where assignments are dropped a
    request's tokens may part from the first drain's: counted; where
    neither drain drops one they must repeat).  Prints ms per step and tokens/s of
    the second beside the weight-bytes bound, peak memory, warmup and the
    drains' dropped fractions."""
    import dataclasses
    import gc
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import query
    from repro_torch.core.linear import prepack_params
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import DropCounter
    from repro_torch.serving.engine import Engine
    full = get_config(arch)
    hw = query("cuda", "h100")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    depth, rows, (layer, fixed, leaf) = moe_depth(full, total)
    if depth < 1:
        raise AssertionError(f"{arch}: not one layer fits the card")
    print(f"  {arch}: reckoning (bf16): a layer {layer / 1e9:.3f} GB, embedding + "
          f"head {fixed / 1e9:.3f} GB, an expert leaf {leaf / 1e9:.3f} GB a layer; "
          f"peak at L layers = weights + max(L x leaf, a layer + 1 GiB) + "
          f"{MOE_POOL_BYTES / 2**30:.0f} GiB: "
          + ", ".join(f"L={n}: {p / 1e9:.2f} GB" for n, p in rows)
          + f"; the card holds {total / 1e9:.2f} GB, so {depth} of "
          f"{full.n_layers} layers (limit {MOE_FIT:g} of it) ({card})")
    cfg = dataclasses.replace(full, n_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    step_bytes = weight_bytes - params["embed"]["e"].numel() * 2
    t0 = time.perf_counter()
    params = prepack_params(params, model.ctx, consume=True)
    torch.cuda.synchronize()
    prepack_s = time.perf_counter() - t0
    drops = DropCounter("cuda").install()
    try:
        eng = Engine(model, params, device="cuda", max_slots=4, page_tokens=16,
                     chunk_tokens=128)
        del params
        bound_ms = 1e3 * step_bytes / hw.hbm_bw
        print(f"  {arch}: {depth} of {full.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff_expert}"
              f"{' + a dense branch of d_ff ' + str(cfg.d_ff) if cfg.dense_residual else ''}, "
              f"{cfg.n_heads} query heads over {cfg.n_kv_heads} of {cfg.d_head}, "
              f"vocab {cfg.vocab}; {weight_bytes / 1e9:.3f} GB in bf16, drawn "
              f"on the card in {init_s:.2f} s, packed in place in "
              f"{prepack_s:.2f} s ({card})")
        rng = np.random.default_rng(0)
        lens = rng.integers(64, 513, 8)
        prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
        print(f"  {arch} prompts {lens.tolist()}")
        rec = PickRecorder(eng)
        per, per_unpacked, per_expert = moe_per_call(cfg)
        drops.reset()
        first = drain_bf16(cfg, "flat", prompts, eng, expected=(per, per_unpacked))
        first.pop("engine")
        first_drop = drops.dropped_frac()
        experts = kernels.wrappers()["mmt4d"].expert_batched
        if experts != per_expert * first["model_calls"]:
            raise AssertionError(f"{arch}: {experts} expert-batched launches over "
                                 f"{first['model_calls']} calls, expected "
                                 f"{per_expert} per call")
        check_path_launches(f"{arch} flat bf16", first["launches"], True)
        first_picks = dict(rec.picks)
        drops.reset()
        second = timed_drain(eng, [(p, 32, 0.0) for p in prompts], True, 0,
                             f"{arch} bf16 flat, second drain")
        second_drop = drops.dropped_frac()
    finally:
        drops.uninstall()
    # a request's tokens depend on its step's other tokens only through the
    # capacity: the second drain admits the requests into other slots (the
    # free list's order after the first), so the flat layout and which
    # assignments are dropped differ; where neither drain drops one, the
    # tokens must repeat
    parted = sum(a != b for a, b in zip(by_request(second.pop("picks")),
                                        by_request(first_picks)))
    if parted and first_drop == second_drop == 0.0:
        raise AssertionError(f"{arch}: {parted} requests' tokens differ between "
                             f"two drains that dropped nothing")
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / first["steps"] for k, v in first["launches"].items() if v}
    print(f"  {arch}: second drain {second['ms_per_step']:.4f} ms per step, "
          f"{second['tokens_per_s']:.2f} generated tokens/s (no capture; "
          f"{parted} of {len(prompts)} requests parted from the first drain's "
          f"tokens, other slots; first {first['ms_per_step']:.4f}); bound: every weight but "
          f"the embedding table read once a step (every expert: the capacity "
          f"dispatch runs them all), {step_bytes / 1e9:.3f} GB / "
          f"{hw.hbm_bw / 1e12:.2f} TB/s = {bound_ms:.4f} ms; launches per model "
          f"call {per} ({per_expert} expert-batched), per step {per_step}; "
          f"dropped fraction of the real tokens' assignments {first_drop:.6f} "
          f"(second {second_drop:.6f}); peak "
          f"memory {peak / 2**30:.2f} GiB; warmup {first['warmup_s']:.3f} s "
          f"({card})")
    res = {**first, "second": second, "layers": depth, "init_s": init_s,
           "prepack_s": prepack_s, "weight_bytes": weight_bytes,
           "step_bytes": step_bytes, "bound_ms": bound_ms, "peak_bytes": peak,
           "dropped_frac": first_drop, "second_dropped_frac": second_drop,
           "second_parted_requests": parted,
           "expert_batched": experts, "launches_per_step": per_step,
           "reckoning": rows, "card": card}
    del eng, rec
    gc.collect()
    torch.cuda.empty_cache()
    return res, {f"{arch} flat bf16": first["launches"],
                 f"{arch} flat bf16 second": second["launches"]}


def moe_phase(card, checks) -> tuple:
    """The moe family: the expert-batched mmt4d at qwen3-moe's and
    arctic's flat-step expert products (checks.experts); each config's f32
    card = CPU (moe_f32_parity) and its bf16 §4 drain at full width, cut
    in depth (moe_bf16).  Returns (results, launches by path)."""
    t_phase = time.perf_counter()
    print(f"  expert-batched mmt4d vs its plain version, L2-cold, beside "
          f"torch.bmm ({card}):")
    for arch, (d, f, e, k) in (("qwen3-moe", (4096, 1536, 128, 8)),
                               ("arctic", (7168, 4864, 128, 2))):
        c = max(8, -(-int(128 * k / e * 1.25) // 8) * 8)   # capacity at W = 128
        checks.experts(BF, e, c, d, f, "silu", f"experts {arch} gate flat")
        checks.experts(BF, e, c, f, d, None, f"experts {arch} down flat")
        if arch == "qwen3-moe":
            checks.experts(TF, e, c, d, f, "silu", f"experts {arch} gate flat")
    res, paths = {}, {}
    for arch in MOE_ARCHS:
        res[f"{arch} f32"] = moe_f32_parity(arch, card)
    for arch in MOE_ARCHS:
        res[arch], p = moe_bf16(arch, card)
        paths.update(p)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  the moe phase took {res['seconds']:.1f} s ({card})")
    return res, paths


JAMBA = "jamba-v0.1-52b"
# selective_scan at jamba's widths: (rows, steps, from a nonzero h0, label)
SCAN_CASES = ((4, 1, True, "decode rows"), (1, 512, False, "prefill 512"),
              (2, 256, True, "prefill cached"))


def jamba_per_call(cfg) -> tuple:
    """(launches per monolithic model call by kernel, mmt4d unpacked
    stores, of them expert-batched) of jamba cut to G = n_layers / 8
    periods; a prefill's and a decode step's alike.  Per period: seven
    mamba mixers, each the in, x and out projections (stored unpacked),
    the packs of the x and out projections' inputs and of its output into
    the stream, and one selective_scan; one attention layer, Q/K/V/O (Q/K/V
    stored unpacked), the O input's pack (the paged step attends through
    PyTorch: no ragged_attn); four moe FFNs (layers 1, 3, 5, 7), each the
    packed stream's unpack, the packs of the dispatched [E, C, d], of the
    gate x up product and of its output into the stream, and the gate,
    up and down expert-batched launches (stored unpacked); four dense
    SwiGLU MLPs (gate, up, down, kept packed).  Per call: the stream
    entry pack, the final stream's unpack, the logits rows' pack and the
    untied head, stored unpacked."""
    g = cfg.n_layers // len(cfg.block_pattern)
    return ({"mmt4d": 49 * g + 1, "pack": 34 * g + 2, "unpack": 4 * g + 1,
             "ragged_attn": 0, "wkv6": 0, "selective_scan": 7 * g},
            36 * g + 1, 12 * g)


def jamba_bytes(cfg) -> tuple:
    """(bytes of one period's weights in bf16, of the embedding, untied
    head and final norm, of one moe layer's expert leaf, of the largest
    block: a mamba mixer with a moe FFN), the dry-run's bytes of the
    config's meta tree at one period."""
    p = meta_params(cfg, len(cfg.block_pattern))
    period = dry_bytes(p["groups"])
    block = max(dry_bytes(b) for b in p["groups"].values())
    return period, dry_bytes(p) - period, expert_leaf_bytes(p["groups"]), block


def jamba_depth(cfg, total: int) -> tuple:
    """The bf16 depth in whole periods and its reckoning (printed): for G
    periods, the weights, plus the larger transient: the prepack's packed
    copy of one stacked expert leaf ([G, E, K, N], while its unpacked one
    lives) or the init's one block drawn beside the stack (and its
    float32 block of 1 GiB), plus MOE_POOL_BYTES."""
    period, fixed, leaf, block = jamba_bytes(cfg)
    best, rows = 0, []
    for g in range(1, cfg.n_layers // len(cfg.block_pattern) + 1):
        peak = fixed + g * period + max(g * leaf, block + 2**30) + MOE_POOL_BYTES
        rows.append((g, peak))
        if peak <= MOE_FIT * total:
            best = g
        else:
            break
    return best, rows, (period, fixed, leaf, block)


def jamba_bf16(card) -> tuple:
    """jamba-v0.1-52B at its published widths in bf16, cut to the whole
    periods jamba_depth picks (printed with its reckoning), weights drawn
    on the card and packed in place, a DropCounter installed, through the
    monolithic engine (4 slots, seq_len 1024): warmup (the decode[4,1]
    graph), then the §4 requests (8, prompts 64-512, 32 new, greedy), each
    distinct prompt length capturing its exact-length prefill graph, with
    replay = eager checked at two step shapes (its first prefill, replayed
    after its capture, and the decode step) and the launches of every
    model call checked (jamba_per_call); then a second drain of the same
    requests that captures nothing (its requests' tokens repeat where
    neither drain drops an assignment; parted requests counted).  Prints
    ms per step and tokens/s of the second beside the weight-bytes bound
    (every weight but the embedding table read once a step: the capacity
    dispatch runs every expert), peak memory, warmup, the dropped
    fractions and the seconds."""
    import dataclasses
    import gc
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import query
    from repro_torch.core.linear import prepack_params
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import DropCounter
    from repro_torch.serving.engine import Engine
    full = get_config(JAMBA)
    hw = query("cuda", "h100")
    period_len = len(full.block_pattern)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    periods, rows, (period, fixed, leaf, block) = jamba_depth(full, total)
    if periods < 1:
        raise AssertionError(f"{JAMBA}: not one period fits the card")
    print(f"  {JAMBA}: reckoning (bf16): a period of {period_len} layers "
          f"{period / 1e9:.3f} GB (4 moe layers, 4 dense MLPs, 7 mamba mixers, "
          f"1 attention), embedding + head {fixed / 1e9:.3f} GB, an expert leaf "
          f"{leaf / 1e9:.3f} GB a moe layer, the largest block {block / 1e9:.3f} "
          f"GB; peak at G periods = weights + max(G x leaf, a block + 1 GiB) + "
          f"{MOE_POOL_BYTES / 2**30:.0f} GiB: "
          + ", ".join(f"G={g}: {p / 1e9:.2f} GB" for g, p in rows)
          + f"; the card holds {total / 1e9:.2f} GB, so {periods} of "
          f"{full.n_layers // period_len} periods, {periods * period_len} of "
          f"{full.n_layers} layers (limit {MOE_FIT:g} of it) ({card})")
    cfg = dataclasses.replace(full, n_layers=periods * period_len)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    step_bytes = weight_bytes - params["embed"]["e"].numel() * 2
    reckoned = fixed + periods * period
    if abs(weight_bytes - reckoned) > 0.01 * weight_bytes:
        raise AssertionError(f"{JAMBA}: {weight_bytes} bytes of weights, "
                             f"{reckoned} reckoned")
    t0 = time.perf_counter()
    params = prepack_params(params, model.ctx, consume=True)
    torch.cuda.synchronize()
    prepack_s = time.perf_counter() - t0
    drops = DropCounter("cuda").install()
    try:
        eng = Engine(model, params, device="cuda", max_slots=RWKV_SLOTS,
                     page_tokens=16)
        del params
        state_bytes = sum(t.numel() * t.element_size()
                          for t in state_leaves(eng.caches))
        bound_ms = 1e3 * (step_bytes + 2 * state_bytes) / hw.hbm_bw
        print(f"  {JAMBA}: {cfg.n_layers} of {full.n_layers} layers, d "
              f"{cfg.d_model}, mamba di {cfg.mamba_expand * cfg.d_model} N "
              f"{cfg.mamba_d_state}, {cfg.n_heads} query heads over "
              f"{cfg.n_kv_heads} of {cfg.d_head}, {cfg.n_experts} experts "
              f"top-{cfg.top_k} of d_ff {cfg.d_ff_expert} on every second "
              f"layer, vocab {cfg.vocab}; {weight_bytes / 1e9:.3f} GB in bf16 "
              f"(reckoned {reckoned / 1e9:.3f}), drawn on the card in "
              f"{init_s:.2f} s, packed in place in {prepack_s:.2f} s; per-slot "
              f"state {state_bytes / RWKV_SLOTS / 1e6:.3f} MB ({card})")
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        graphs = dict(eng.stats()["captures"])
        rng = np.random.default_rng(0)
        lens = rng.integers(64, 513, RWKV_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
        print(f"  {JAMBA} prompts {lens.tolist()}; warmup {warm_s:.3f} s, "
              f"graphs {graphs}")
        rec = PickRecorder(eng)
        check = attach_replay_check(eng)
        calls = count_model_calls(eng)
        rids = [eng.add_request(p, RWKV_NEW) for p in prompts]
        drops.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fin = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        unpacked = kernels.wrappers()["mmt4d"].unpacked_stores
        experts = kernels.wrappers()["mmt4d"].expert_batched
        first_drop = drops.dropped_frac()
        del eng._run_paged                     # the call counter
        eng._paged_step = check.step
        st = eng.stats()
        n = len(calls)
        if sorted(r.rid for r in fin) != sorted(rids) or any(
                r.finish_reason != "length" or len(r.out_tokens) != RWKV_NEW
                for r in fin):
            raise AssertionError(f"{JAMBA}: not every request finished")
        if not all(np.isfinite(c).all() for c in calls):
            raise AssertionError(f"{JAMBA}: non-finite logits")
        per, per_unpacked, per_expert = jamba_per_call(cfg)
        for k, want in per.items():
            if launches[k] != want * n:
                raise AssertionError(f"{JAMBA} {k}: {launches[k]} launches over "
                                     f"{n} model calls, expected {want} per call")
        if unpacked != per_unpacked * n or experts != per_expert * n:
            raise AssertionError(f"{JAMBA}: {unpacked} unpacked stores and "
                                 f"{experts} expert-batched launches over {n} "
                                 f"calls, expected {per_unpacked} and "
                                 f"{per_expert} per call")
        check_path_launches(f"{JAMBA} monolithic bf16", launches, False,
                            mamba=True)
        captured = st["captures"]["paged"] - graphs["paged"]
        if captured != len(set(lens.tolist())):
            raise AssertionError(f"{JAMBA}: {captured} graphs captured in the "
                                 f"drain for {len(set(lens.tolist()))} prompt "
                                 f"lengths")
        if len(check.checked) < 2:
            raise AssertionError(f"{JAMBA}: replay checked at "
                                 f"{len(check.checked)} shapes, not 2")
        first_picks = dict(rec.picks)
        ntok = sum(len(r.out_tokens) for r in fin)
        first = {"steps": st["steps"], "model_calls": n, "wall_s": wall,
                 "ms_per_step": 1e3 * wall / st["steps"], "tokens": ntok,
                 "tokens_per_s": ntok / wall, "launches": launches,
                 "unpacked_stores": unpacked, "expert_batched": experts,
                 "captured_in_drain": captured,
                 "replay_checked": len(check.checked)}
        print(f"  {JAMBA} bf16 monolithic, first drain: {st['steps']} steps, {n} "
              f"model calls, {wall:.3f} s wall, {first['ms_per_step']:.4f} ms per "
              f"step, {ntok / wall:.2f} generated tokens/s, {captured} prefill "
              f"graphs captured (one per prompt length), replay = eager at "
              f"{len(check.checked)} shapes; launches per model call "
              f"{ {k: v / n for k, v in launches.items() if v} }, unpacked "
              f"stores {unpacked / n}, expert-batched {experts / n} per call; "
              f"dropped fraction {first_drop:.6f}")
        drops.reset()
        second = timed_drain(eng, [(p, RWKV_NEW, 0.0) for p in prompts], True,
                             0, f"{JAMBA} bf16 monolithic, second drain")
        second_drop = drops.dropped_frac()
    finally:
        drops.uninstall()
    parted = sum(a != b for a, b in zip(by_request(second.pop("picks")),
                                        by_request(first_picks)))
    if parted and first_drop == second_drop == 0.0:
        raise AssertionError(f"{JAMBA}: {parted} requests' tokens differ between "
                             f"two drains that dropped nothing")
    peak = torch.cuda.max_memory_allocated()
    print(f"  {JAMBA}: second drain {second['ms_per_step']:.4f} ms per step, "
          f"{second['tokens_per_s']:.2f} generated tokens/s (no capture; "
          f"{parted} of {len(prompts)} requests parted from the first drain's "
          f"tokens); bound: every weight but the embedding table read once a "
          f"step (every expert: the capacity dispatch runs them all) and 4 "
          f"slots' state read and written, ({step_bytes / 1e9:.3f} + 2 x "
          f"{state_bytes / 1e9:.4f}) GB / {hw.hbm_bw / 1e12:.2f} TB/s = "
          f"{bound_ms:.4f} ms; dropped fraction {first_drop:.6f} (second "
          f"{second_drop:.6f}); captures {graphs['paged']} at warmup + "
          f"{captured} in the first drain; peak memory {peak / 2**30:.2f} GiB "
          f"(reckoned {rows[periods - 1][1] / 1e9:.2f} GB) ({card})")
    res = {**first, "second": second, "periods": periods,
           "layers": cfg.n_layers, "init_s": init_s, "prepack_s": prepack_s,
           "warmup_s": warm_s, "warmup_graphs": graphs,
           "weight_bytes": weight_bytes, "step_bytes": step_bytes,
           "state_bytes": state_bytes, "bound_ms": bound_ms, "peak_bytes": peak,
           "dropped_frac": first_drop, "second_dropped_frac": second_drop,
           "second_parted_requests": parted, "reckoning": rows,
           "prompt_lens": lens.tolist(), "card": card}
    del eng, rec, check
    gc.collect()
    torch.cuda.empty_cache()
    return res, {f"{JAMBA} monolithic bf16": launches,
                 f"{JAMBA} monolithic bf16 second": second["launches"]}


def jamba_phase(card, checks) -> tuple:
    """Mamba's selective_scan at jamba's widths (SCAN_CASES, float32 and
    bfloat16, checks.selective_scan); jamba in bf16 at the whole periods
    that fit (jamba_bf16); its first period with its moe layers in f32,
    card = CPU (moe_f32_parity: routing, the monolithic drain, first
    logits, dropped fractions).  Returns (results, launches by path)."""
    t_phase = time.perf_counter()
    print(f"  selective_scan vs its plain version at jamba's widths, L2-cold "
          f"({card}):")
    for dtype in (TF, BF):
        for b, s, h0, label in SCAN_CASES:
            checks.selective_scan(dtype, b, s, h0, label)
    res = {}
    res[JAMBA], paths = jamba_bf16(card)
    res[f"{JAMBA} f32"] = moe_f32_parity(JAMBA, card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  the jamba phase took {res['seconds']:.1f} s ({card})")
    return res, paths


# ------------------------------- training the recurrent and moe families

# the training step of every family: RWKV-6 1.6B whole and Qwen3-MoE at
# full width cut in depth in bf16 (4 x 1024 tokens a step); jamba and
# arctic, whose one layer or period does not fit one card with its
# gradients and moments (ROADMAP A10), at their reduced configs in f32.
# RWKV-6 at lr 1e-4: over 20 steps from its random init the mean loss of
# the last 5 rose above the first 5's at 3e-4 (11.5897 -> 11.6767, warmup
# 5) and 1e-3 (11.6057 -> 11.6403) and fell at 1e-4 (11.5817 -> 11.5606;
# measured on an NVIDIA H100 80GB HBM3 at 700.00 W).  Not bf16's doing:
# cut to 12 layers, warmup 1 (launch.train --layers 12 --steps 20 --warmup
# 1), float32 fell less at 3e-4 than bf16 did (11.6036 -> 11.6024 against
# 11.6113 -> 11.5746) and both fell further at 1e-4 (11.5995 -> 11.5480,
# 11.6008 -> 11.5583); at a random init a larger lr adds more noise than
# 20 steps remove, as SmolLM2's training phase found.  Qwen3-MoE with
# float32 moments (the default AdamW): its one layer's 3.73 B parameters
# and moments hold 34.8 GiB; the capture of its step once ran out of
# memory with 18.95 GiB free in the graph's pool, none of it in a block
# that could take the update's 3 GiB float32 temporaries of the stacked
# experts, and a capture cannot give free blocks back to the device
# (ROADMAP C11, closed: the update takes large leaves in slices;
# scripts/c11_memory.py)
RWKV_TRAIN, MOE_TRAIN = "rwkv6-1.6b", "qwen3-moe-235b-a22b"
RWKV_TRAIN_LR = 1e-4
RWKV_TRAIN_STEPS, MOE_TRAIN_STEPS, FAMILY_REPLAY_STEPS = 20, 5, 3
# f32 card = CPU: (arch, layers: None for the reduced config, else the
# published widths cut to that many layers, seq, batch, each gradient
# leaf's tolerance as a share of its largest |value|).  1e-5: float32 sums
# in another order, as SmolLM2's.  RWKV-6 at full width, 2e-4: the card's
# expf and the CPU's differ by an ulp, and the decays (about 0.9975 at
# init) carry that through 128 steps of the state into the r and k
# gradients, which the 2048-wide projections' weight gradients then sum
# over 256 tokens with cancellation (their mean |value| a 20th of their
# largest): 7.0e-5 measured on the H100 for wr and wk, every other leaf
# under 3.3e-5; the same step on the CPU through the backward's plain
# version and through autograd of the token loop agree within 2e-6
FAMILY_F32 = (("rwkv6-1.6b", 2, 128, 2, 2e-4), ("jamba-v0.1-52b", None, 32, 2, 1e-5),
              ("qwen3-moe-235b-a22b", None, 32, 2, 1e-5),
              ("arctic-480b", None, 32, 2, 1e-5))
# bf16 training's witnesses, RWKV-6 at full width cut to
# BF16_WITNESS_LAYERS, seq 128, batch 2.  (1) One bf16 step card = the
# CPU's bf16 plain path (train_card_vs_cpu): the loss within 1e-3
# relative and each gradient leaf within 5e-2 of its largest entry; both
# sides round the same products' f32 sums to bf16, so they part only
# where a sum lands near a rounding boundary, an ulp (2^-8) at a time.
# (2) BF16_WITNESS_STEPS steps at RWKV_TRAIN_LR on the card in bf16 and
# in f32 (bf16_vs_f32_training): each step's loss within 1e-2, relative
# (bf16 rounds every weight, activation and stored input to 2^-9; the
# bf16 weights then drop updates below half an ulp, so the runs' weights
# part).  Not a gradient against f32: at this shape the gradient norm is
# mostly the bonus u's, whose sum over tokens cancels, and bf16 inputs
# move it by about a fifth on either device (on the CPU, d|u| 50.05 in
# f32, 52.34 in bf16, the difference 22.8 % of it: scripts/bf16_grad_parts.py)
BF16_WITNESS_LAYERS, BF16_WITNESS_STEPS = 2, 10
BF16_LOSS_TOL, BF16_GRAD_TOL, BF16_TRAIN_LOSS_TOL = 1e-3, 5e-2, 1e-2
# the share of the card a training run's reckoned peak may take
TRAIN_FIT = 0.95
# wkv6's backward: each gradient within this share of the plain backward's
# largest |value| (float32 sums in another order, a recurrence of 1024
# steps, the forward kernel's chunked states as checkpoints)
WKV6_BWD_TOL = 1e-5
# selective_scan's backward: each gradient within this share of the plain
# backward's largest |value| (float32: sums over the channels and lanes in
# another order; bfloat16: dx, dz, dB and dC rounded to bfloat16 from
# float32 sums of another order)
SCAN_BWD_TOL = {TF: 1e-5, BF: 2e-2}
# the backward kernels' second case: a length no chunk divides (wkv6's 16,
# the scan's 16, 24 and 32), from a nonzero ds (wkv6) or h0 (the scan)
RAGGED_SEQ = 1000


def moe_train_depth(cfg, total: int) -> tuple:
    """The bf16 training depth of a moe config with float32 moments (the
    default AdamW) and its reckoning (printed): for L layers, 12 bytes a
    parameter (bf16 weights and gradients, float32 moments: 6 times the
    bf16 weights), plus a step's transients once (ROADMAP C11): the
    packed copies of every expert leaf the forward saves, the logits and
    their gradient in float32, and the rest (the activations, the head's
    and the embedding's gradients in their packed and unpacked forms, the
    update's float32 slices) taken as 8 bytes an element of the largest
    leaf (at 1 layer 9.2 GB of the 19.0 GB of transients measured on an
    NVIDIA H100 80GB HBM3 at 700 W, 12.9 reckoned); plus MOE_POOL_BYTES."""
    layer, fixed, leaf = moe_bytes(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    experts = leaf * (3 if cfg.glu else 2)
    best, rows = 0, []
    for n in range(1, cfg.n_layers + 1):
        peak = (6 * (fixed + n * layer)
                + n * experts + 8 * leaf + 8 * tokens * cfg.vocab
                + MOE_POOL_BYTES)
        rows.append((n, peak))
        if peak <= TRAIN_FIT * total:
            best = n
        else:
            break
    return best, rows


def train_card_vs_cpu(arch, layers, seq, batch, grad_tol, hw_name="h100",
                      dtype="float32", loss_tol=1e-5) -> dict:
    """One ``dtype`` step's loss and gradients of ``arch`` (reduced, or its
    published widths cut to ``layers``), the same weights and batch on the
    card (``hw_name``'s tiles) and on the CPU plain path (its twin's): the
    loss within ``loss_tol`` relative, the moe metrics within 1e-6, every
    gradient leaf within ``grad_tol`` of its largest entry (the worst
    leaves printed by name).  The wrapper counts are set to 0 just before
    the card's step and read after it."""
    import dataclasses as dc
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import leaves, tree_map
    from repro_torch.training.step import value_and_grad
    full = get_config(arch)
    cfg = reduced_config(full) if layers is None else dc.replace(full, n_layers=layers)
    shape = ShapeSpec("train", seq, batch, "train")
    run = RunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False)
    batch_ = SyntheticLM(cfg, shape, seed=0).batch_at(0)
    params = build_model(cfg, run, shape, hw=descriptor("cpu", hw_name),
                         device="cpu").init(torch.Generator().manual_seed(0))
    res, t = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, run, shape, hw=descriptor(dev, hw_name), device=dev)
        p = tree_map(lambda x: x.to(dev), params)
        t0 = time.perf_counter()
        if dev == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        (loss, met), grads = value_and_grad(model, p, batch_)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = kernels.counters()
        t[dev] = time.perf_counter() - t0
        res[dev] = (float(loss), {k: float(v) for k, v in met.items()},
                    [g.float().cpu() for g in leaves(grads)])
        del model, p, grads
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    names = leaf_names(params)
    by_leaf = sorted(((a - b).abs().max().item() / max(1e-30, b.abs().max().item()), n)
                     for n, a, b in zip(names, res["cuda"][2], res["cpu"][2]))
    worst = by_leaf[-1][0]
    aux = {k: (res["cuda"][1][k], res["cpu"][1][k])
           for k in ("load_balance", "router_z", "dropped_frac") if k in res["cpu"][1]}
    aux_off = max([abs(a - b) / max(1.0, abs(b)) for a, b in aux.values()] or [0.0])
    ran = {k: v for k, v in counts.items() if v}
    what = "reduced" if layers is None else f"{layers} of {full.n_layers} layers"
    print(f"  {arch} {dtype} ({what}, seq {seq}, batch {batch}, {hw_name}): loss "
          f"card {res['cuda'][0]:.7f} cpu {res['cpu'][0]:.7f} (relative {rel:.2e}, "
          f"tolerance {loss_tol:g}); {len(res['cpu'][2])} gradient leaves, worst "
          f"max|card - cpu| / max|cpu| {worst:.2e} (tolerance {grad_tol:g}; "
          f"the worst three {[(n, f'{r:.2e}') for r, n in by_leaf[-3:]]})"
          + (f"; moe metrics card/cpu {aux} (tolerance 1e-6)" if aux else "")
          + f"; card {t['cuda']:.1f} s, CPU {t['cpu']:.1f} s; launches {ran}")
    if rel > loss_tol or worst > grad_tol or aux_off > 1e-6:
        raise AssertionError(f"{arch} {dtype} train step: card and CPU differ (loss "
                             f"{rel}, gradients {worst}, moe metrics {aux_off})")
    return {"layers": cfg.n_layers, "loss_card": res["cuda"][0],
            "loss_cpu": res["cpu"][0], "loss_rel": rel, "grad_rel_worst": worst,
            "moe_metrics": aux, "leaves": len(res["cpu"][2]), "launches": counts}


def bf16_vs_f32_training(arch, layers, seq, batch, steps, lr) -> dict:
    """A witness for bfloat16 training: ``arch`` at its published widths
    cut to ``layers``, ``steps`` steps at ``lr`` (warmup 1) through the
    trainer's compiled step on the card in float32 and in bfloat16, from
    one init (a CUDA generator, seed 0: the bf16 weights are the f32
    ones rounded, checked) and the same batches.  Each bf16 step's loss
    within BF16_TRAIN_LOSS_TOL of the f32 step's, relative.  The grad
    norms are printed, not held: RWKV-6's is mostly the bonus u's, a sum
    over tokens with cancellation that bf16 inputs move by a fifth (see
    BF16_WITNESS_LAYERS); the gradients are held to the CPU's own bf16
    path instead (train_card_vs_cpu)."""
    import dataclasses as dc
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import Trainer
    cfg = dc.replace(get_config(arch), n_layers=layers)
    shape = ShapeSpec("train", seq, batch, "train")
    hist, init = {}, {}
    for dt in ("float32", "bfloat16"):
        run = RunConfig(param_dtype=dt, compute_dtype=dt, remat=False, lr=lr,
                        warmup_steps=1)
        data = SyntheticLM(cfg, shape, seed=0)
        tr = Trainer(build_model(cfg, run, shape, device="cuda"), data, run,
                     total_steps=steps, log_fn=lambda m: print("   ", m))
        state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
        init[dt] = [t.to("cpu", copy=True) for t in leaves(state.params)]
        hist[dt] = []
        for i in range(steps):
            state, m = tr.step_fn(state, data.batch_at(i))
            hist[dt].append((float(m["loss"]), float(m["grad_norm"])))
        if tr.step_fn.captures != 1:
            raise AssertionError(f"{arch} {dt}: {tr.step_fn.captures} captures")
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
    rounded = all(torch.equal(a.to(b.dtype), b)
                  for a, b in zip(init["float32"], init["bfloat16"], strict=True))
    f, h = np.array(hist["float32"]), np.array(hist["bfloat16"])
    loss_rel = np.abs(h[:, 0] - f[:, 0]) / np.abs(f[:, 0])
    gnorm_rel = np.abs(h[:, 1] - f[:, 1]) / np.abs(f[:, 1])
    print(f"  {arch} ({layers} of {get_config(arch).n_layers} layers, seq {seq}, "
          f"batch {batch}, lr {lr:g}), {steps} steps each through the compiled "
          f"step: loss f32 {[round(float(x), 4) for x in f[:, 0]]}, bf16 "
          f"{[round(float(x), 4) for x in h[:, 0]]} (worst relative gap "
          f"{loss_rel.max():.2e}, tolerance {BF16_TRAIN_LOSS_TOL:g}); grad_norm "
          f"f32 {[round(float(x), 2) for x in f[:, 1]]}, bf16 "
          f"{[round(float(x), 2) for x in h[:, 1]]} (not held); the bf16 init "
          f"the f32 one rounded: {rounded}")
    if not (rounded and loss_rel.max() <= BF16_TRAIN_LOSS_TOL):
        raise AssertionError(f"{arch}: bf16 training parts from f32 (loss "
                             f"{loss_rel.max()}, init rounded {rounded})")
    return {"layers": layers, "seq": seq, "batch": batch, "lr": lr,
            "f32": hist["float32"], "bf16": hist["bfloat16"],
            "loss_rel_worst": float(loss_rel.max()),
            "first_grad_norm_rel": float(gnorm_rel[0])}


def card_memory() -> str:
    """The card's memory in use, after a collection and empty_cache (what
    the next run starts beside)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} reserved before it")


def leaf_names(tree, prefix="") -> list:
    """The '/'-joined keys of a parameter tree's leaves, in ``leaves``'
    order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def train_replay_check(model, run, steps, label) -> dict:
    """Replay = eager, bit for bit, with one state on the card at a time
    (so a model whose training state the card holds once, not twice, is
    checked too): from one init (a CUDA generator, seed 0), ``steps``
    steps through the compiled step's eager ``fn`` (the first under
    ``set_sync_debug_mode("error")``: no host sync), the final state
    copied to the host; the state drawn again from the same seed, the
    same steps through the compiled step (eager and captured on the first
    call, replayed after).  Each step's loss and grad_norm and every final
    parameter and optimizer-state leaf (the error buffer included) must
    agree bit for bit, with one capture.  Each side's ms per step (host
    clock to a synchronise) is printed."""
    import gc
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.trainer import Trainer
    data = SyntheticLM(model.cfg, model.shape, seed=0)
    tr = Trainer(model, data, run, total_steps=20, log_fn=lambda m: print("   ", m))
    step = tr.step_fn
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    eager_m, ms = [], {"eager": [], "graph": []}
    for i in range(steps):
        on_card = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(i).items()}
        scalars = tr.optimizer.scalars(state.step, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if i == 0 else "default")
        try:
            state, em = step.fn(state, on_card, scalars)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eager_m.append({k: em[k].clone() for k in ("loss", "grad_norm")})
        torch.cuda.synchronize()
        ms["eager"].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    peaks = {"eager": torch.cuda.max_memory_allocated() - base}
    host = [t.cpu() for t in leaves({"p": state.params, "o": state.opt_state})]
    del state, em
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    for i in range(steps):
        t0 = time.perf_counter()
        state, gm = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        ms["graph"].append((time.perf_counter() - t0) * 1e3)
        for k in ("loss", "grad_norm"):
            if not bits_equal(eager_m[i][k], gm[k]):
                raise AssertionError(f"replay {label} step {i}: {k} eager "
                                     f"{eager_m[i][k].item()} graph {gm[k].item()}")
    torch.cuda.synchronize()
    # the first compiled call runs eagerly and captures: the capture's peak
    peaks["capture"] = torch.cuda.max_memory_allocated() - base
    got = leaves({"p": state.params, "o": state.opt_state})
    kinds = sorted(state.opt_state)
    differ = sum(not bits_equal(x.cpu(), y) for x, y in zip(got, host, strict=True))
    if differ or step.captures != 1:
        raise AssertionError(f"replay {label}: {differ} of {len(host)} state leaves "
                             f"differ, {step.captures} captures")
    med = {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in ms.items()}
    print(f"  {label}: {steps} steps, loss and grad_norm of each, {len(host)} state "
          f"leaves after the last ({kinds}) equal bit for bit (one state on the "
          f"card, the eager run's kept on the host); 1 capture "
          f"({step.capture_seconds:.3f} s); "
          f"the first eager step made no host sync; ms per step eager "
          f"{med['eager']:.1f}, replay {med['graph']:.1f} (medians after the first); "
          f"peak above the {base / 2**30:.2f} GiB held before: eager "
          f"{peaks['eager'] / 2**30:.2f} GiB, compiled (its eager first call and "
          f"capture, then replays) {peaks['capture'] / 2**30:.2f} GiB")
    del state, host
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "leaves": len(got), "capture_s": step.capture_seconds,
            "eager_ms": ms["eager"], "graph_ms": ms["graph"], "equal": True,
            "peak_bytes": peaks, "cfg": model.cfg, "run": run}


def family_bf16_train(arch, layers, steps, run, card) -> dict:
    """``arch`` at its published widths (cut to ``layers``) in bf16, seq
    TRAIN_SEQ, batch TRAIN_BATCH, through the trainer's compiled step
    (one capture): ``steps`` steps, every loss finite, the launches per
    step checked (the recurrences' forward and backward kernels once a
    layer, a moe model's expert-batched gradient kernels), the dropped
    fraction of a moe model printed (``moe.DropCounter``).  ``run``: the
    RunConfig (bf16, its lr and optimizer)."""
    import dataclasses as dc
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    if layers != cfg.n_layers:
        cfg = dc.replace(cfg, n_layers=layers)
    model = build_model(cfg, run, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                        device="cuda")
    per = {"wkv6": layers, "wkv6_bwd": layers} if "rwkv" in set(cfg.layer_types) \
        else {}
    counter = moe.DropCounter("cuda").install() if cfg.moe else None
    try:
        r = train_run(model, run, steps, f"{arch} bf16 ({layers} layers)",
                      total_steps=steps, want=per,
                      gen=torch.Generator(device="cuda").manual_seed(0),
                      measure_state=True)
    finally:
        if counter is not None:
            counter.uninstall()
    r.pop("state")
    r["cfg"], r["run"] = cfg, run          # what the mesh phase reckons
    h = r["history"]
    ok = bool(np.all(np.isfinite(h)))
    if steps >= 10:
        first, last = float(np.mean(h[:5])), float(np.mean(h[-5:]))
        ok = ok and last < first
        print(f"  {arch}: every loss finite: {bool(np.all(np.isfinite(h)))}; mean "
              f"loss of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    if cfg.moe:
        c = r["counters"]
        r["dropped_frac"] = counter.dropped_frac()
        print(f"  {arch}: dropped fraction over the run {r['dropped_frac']:.6f} "
              f"(real tokens' assignments over capacity); expert-batched launches "
              f"per step: mmt4d {c['mmt4d.expert_batched'] // r['steps']}, dgrad "
              f"{c['mmt4d_dgrad.expert_batched'] // r['steps']}, wgrad "
              f"{c['mmt4d_wgrad.expert_batched'] // r['steps']}")
        ok = ok and c["mmt4d_dgrad.expert_batched"] > 0 and c["mmt4d_wgrad.expert_batched"] > 0
    if not ok:
        raise AssertionError(f"{arch} bf16 training: a loss not finite, the loss "
                             f"did not fall, or no expert gradient kernel ran: {h}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return r


def family_training_phase(card, checks) -> tuple:
    """The backward kernels of the recurrences and the expert-batched
    gradient kernels against their plain versions at the training shapes;
    one f32 step card = CPU for each family the port newly trains; RWKV-6
    1.6B whole and Qwen3-MoE at full width cut in depth, in bf16 through
    the compiled step; replay = eager bit for bit for both; the launcher's
    --profile naming the new kernels."""
    import dataclasses as dc
    import gc
    import tempfile
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    out, by_path = {}, {}
    print(f"the backward kernels at the training shapes (4 x 1024 tokens), "
          f"L2-cold, beside their plain versions ({card}):")
    checks.wkv6_bwd(TRAIN_BATCH, TRAIN_SEQ, "train")
    checks.wkv6_bwd(TRAIN_BATCH, RAGGED_SEQ, f"ragged {RAGGED_SEQ}, ds", with_ds=True)
    for dtype in (BF, TF):
        checks.selective_scan_bwd(dtype, TRAIN_BATCH, TRAIN_SEQ, "train")
        checks.selective_scan_bwd(dtype, TRAIN_BATCH, RAGGED_SEQ, f"ragged {RAGGED_SEQ}, h0",
                                  h0_nonzero=True)
    print(f"the expert-batched gradient kernels at the training experts "
          f"(Qwen3-MoE: 128 experts, C 320 at 4,096 tokens, 4096 <-> 1536; jamba: "
          f"16 experts, C 640, 4096 <-> 14336), beside torch.bmm ({card}):")
    for e, c, k, n, act, label in ((128, 320, 4096, 1536, "silu", "qwen3-moe gate"),
                                   (128, 320, 1536, 4096, None, "qwen3-moe down"),
                                   (16, 640, 4096, 14336, "silu", "jamba gate"),
                                   (16, 640, 14336, 4096, None, "jamba down")):
        checks.expert_grads(BF, e, c, k, n, act, label)
    checks.expert_grads(TF, 128, 320, 4096, 1536, "silu", "qwen3-moe gate")

    print(f"training, float32: one step's loss and gradients, card vs CPU plain "
          f"path ({card}):")
    out["f32"] = {}
    for arch, layers, seq, batch, tol in FAMILY_F32:
        out["f32"][arch] = r = train_card_vs_cpu(arch, layers, seq, batch, tol)
        by_path[f"train f32 {arch}"] = r["launches"]
        gc.collect()
    print(f"training, bfloat16: {RWKV_TRAIN} cut to {BF16_WITNESS_LAYERS} layers, "
          f"one step card = the CPU's bf16 plain path, then {BF16_WITNESS_STEPS} "
          f"steps against float32 on the card ({card})")
    out["bf16"] = r = train_card_vs_cpu(RWKV_TRAIN, BF16_WITNESS_LAYERS, 128, 2,
                                        BF16_GRAD_TOL, dtype="bfloat16",
                                        loss_tol=BF16_LOSS_TOL)
    by_path[f"train bf16 {RWKV_TRAIN} card = cpu"] = r["launches"]
    out["bf16_vs_f32"] = bf16_vs_f32_training(RWKV_TRAIN, BF16_WITNESS_LAYERS, 128, 2,
                                              BF16_WITNESS_STEPS, RWKV_TRAIN_LR)

    total = torch.cuda.get_device_properties(0).total_memory
    base = RunConfig(remat=False, warmup_steps=1)
    rwkv_run = dc.replace(base, lr=RWKV_TRAIN_LR)
    print(f"training, bfloat16: {RWKV_TRAIN} whole, seq {TRAIN_SEQ}, batch "
          f"{TRAIN_BATCH}, lr {RWKV_TRAIN_LR:g}, {RWKV_TRAIN_STEPS} steps through "
          f"the compiled step ({card}); {card_memory()}")
    rwkv_layers = get_config(RWKV_TRAIN).n_layers
    out["rwkv6 bf16"] = r = family_bf16_train(RWKV_TRAIN, rwkv_layers,
                                              RWKV_TRAIN_STEPS, rwkv_run, card)
    by_path["train bf16 rwkv6-1.6b"] = r.pop("launches")
    mcfg = get_config(MOE_TRAIN)
    depth, rows = moe_train_depth(mcfg, total)
    if depth < 1:
        raise AssertionError(f"{MOE_TRAIN}: not one layer fits the card in training")
    print(f"  {MOE_TRAIN} training depth from the dry-run's bytes: {depth} ("
          + ", ".join(f"{n} layers {p / 1e9:.4f} GB" for n, p in rows) + ")")
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    print(f"training, replay = eager bit for bit: {FAMILY_REPLAY_STEPS} steps each "
          f"through the compiled step's eager fn and through its graph, from one "
          f"init, the eager run's final state held on the host ({card}); "
          f"{card_memory()}")
    out["replay"] = {}
    for key, cfg, run in ((f"{RWKV_TRAIN} bf16", get_config(RWKV_TRAIN), rwkv_run),
                          (f"{MOE_TRAIN} {depth} layers bf16",
                           dc.replace(mcfg, n_layers=depth), base)):
        out["replay"][key] = train_replay_check(
            build_model(cfg, run, shape, device="cuda"), run, FAMILY_REPLAY_STEPS, key)
    print(f"training, bfloat16: {MOE_TRAIN} at full width with float32 moments (the "
          f"default AdamW), the most layers whose reckoned peak fits {TRAIN_FIT:.0%} "
          f"of the card's {total / 1e9:.2f} GB: "
          + ", ".join(f"{n} layers {p / 1e9:.2f} GB" for n, p in rows)
          + f" -> {depth} ({card}); {card_memory()}")
    out["qwen3-moe bf16"] = r = family_bf16_train(MOE_TRAIN, depth, MOE_TRAIN_STEPS,
                                                  base, card)
    r["layers"], r["reckoning"] = depth, rows
    reckoned = rows[depth - 1][1]
    print(f"  {MOE_TRAIN}: peak {r['peak_gib'] * 2**30 / 1e9:.2f} GB allocated against "
          f"the reckoned {reckoned / 1e9:.2f} GB ({r['peak_gib'] * 2**30 / reckoned:.3f} "
          f"of it)")
    if r["peak_gib"] * 2**30 > reckoned:
        raise AssertionError(f"{MOE_TRAIN}: peak {r['peak_gib']:.2f} GiB above the "
                             f"reckoned {reckoned / 2**30:.2f} GiB")
    by_path["train bf16 qwen3-moe"] = r.pop("launches")

    print(f"training, the launcher: python -m repro_torch.launch.train --arch "
          f"{RWKV_TRAIN} --layers 2 --steps 4 --seq {TRAIN_SEQ} --batch "
          f"{TRAIN_BATCH} --dtype bfloat16 --profile (the trace's launches held "
          f"to the wrappers' counts, wkv6_bwd among them; {card}); {card_memory()}")
    from repro_torch.launch import train as launch_train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        _, hist = launch_train.main(["--arch", RWKV_TRAIN, "--layers", "2", "--steps",
                                     "4", "--seq", str(TRAIN_SEQ), "--batch",
                                     str(TRAIN_BATCH), "--dtype", "bfloat16",
                                     "--profile", os.path.join(tmp, "train.json.gz")])
    if not np.all(np.isfinite(hist)):
        raise AssertionError(f"launcher: loss not finite: {hist}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  the family training phase took {out['seconds']:.1f} s ({card})")
    return out, by_path


MESH_DP = 4                 # the blocked moe check's data shards (global view)
MESH_MOE_SEQ = 256          # tokens a row: MESH_DP rows of one block each


def blocked_moe(model, ffn, x) -> tuple:
    """One forward of the moe layer ``ffn`` over ``x`` [B, S, d] under the
    model's context: (y on the host, [routed, kept] assignments, the
    routing recorded on this thread, the kernels' launches)."""
    from repro_torch import kernels
    from repro_torch.models import moe
    counter = moe.DropCounter(x.device.type).install()
    seen, undo = route_recorder()
    before = kernels.launch_counts()
    try:
        with torch.no_grad():
            y, _ = moe.moe_apply(ffn, x, model.ctx, model.cfg)
    finally:
        undo()
        counter.uninstall()
    after = kernels.launch_counts()
    return (y.cpu(), counter.counts.tolist(), seen,
            {k: after[k] - before[k] for k in after})


def blocked_moe_cpu(cfg, run, x, params) -> tuple:
    """The CPU's half of the blocked moe check, on the CPU's thread: the
    same layer in the global view of MESH_DP data shards."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import build_model
    model = build_model(cfg, run, ShapeSpec("mesh", MESH_MOE_SEQ, MESH_DP, "decode"),
                        hw=descriptor("cpu", "h100"), device="cpu",
                        mesh=AbstractMesh((MESH_DP, 1), ("data", "model")))
    return blocked_moe(model, params, x)


def mesh_drain(cfg, params, prompts, mesh) -> dict:
    """SmolLM2's f32 flat drain on the card through ``Engine(mesh=mesh)``
    (and ``ReproModel(mesh=mesh)``), or without a mesh: tokens, every model
    call's logits, the graphs captured at warmup and after, the launches."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, run, ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda", mesh=mesh)
    eng = Engine(model, params, device="cuda", max_slots=4, page_tokens=16,
                 chunk_tokens=128, mesh=mesh)
    eng.warmup()
    captures = dict(eng.stats()["captures"])
    calls = count_model_calls(eng)
    rids = [eng.add_request(p, 16) for p in prompts]
    kernels.reset_launch_counts()
    fin = {r.rid: r.out_tokens for r in eng.drain()}
    launches = kernels.launch_counts()
    out = {"tokens": [fin[r] for r in rids], "logits": calls,
           "captures": captures, "captures_after": dict(eng.stats()["captures"]),
           "launches": launches, "cache_specs": eng.cache_specs}
    del eng, model
    return out


def mesh_phase(card, checks, fam_train) -> tuple:
    """ROADMAP A10 on the card: (1) the dry-run of every runnable cell on
    both production meshes and SmolLM2's serving cell, priced from the
    card's h100 descriptor, allocating nothing on the card; (2) the
    dry-run's bytes per device of the family training phase's two train
    states on a one-rank mesh against what the caching allocator held
    right after building them (the requested bytes exactly; each leaf's
    block: its bytes rounded up to 512, plus any remainder of at most 1
    MiB of a large segment the allocator left unsplit, read from its
    snapshot), and the reckoned step peak beside the eager and the
    compiled step's; (3) a one-rank NCCL process group and
    make_elastic_mesh's (1, 1) mesh: SmolLM2-135M's f32 flat drain through
    Engine(mesh=) equal to the drain without a mesh bit for bit (tokens,
    every call's logits, captures); (4) Qwen3-MoE's moe layer at full
    width in f32 with the per-shard dispatch over MESH_DP data shards (an
    AbstractMesh: the global view), one forward of MESH_DP x MESH_MOE_SEQ
    tokens, card = CPU (routing under the top-k margin rule, the routed
    and kept assignments exactly, y within F32_MARGIN of max(1, max |y|);
    the CPU's run on the CPU's thread), and the expert gate product at
    its blocked shape in KernelChecks."""
    import gc
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, RunConfig, ShapeSpec, cells, get_config
    from repro_torch.core.hardware import query
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ABSTRACT_MESHES, AbstractMesh, make_elastic_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    out, by_path = {}, {}
    hw = query("cuda", "h100")

    # (4) first: the CPU's forward runs on its thread beside (1)-(3)
    cfg = dataclasses.replace(get_config(MOE_TRAIN), n_layers=1)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    moe_local_dispatch=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ffn = moe.moe_init(gen, cfg, torch.float32)
    x = torch.randn((MESH_DP, MESH_MOE_SEQ, cfg.d_model), generator=gen, device="cuda")
    cpu = to_cpu_thread(blocked_moe_cpu, cfg, run, x.cpu(), params=ffn)

    print(f"  (1) the dry-run: {sum(ok for *_, ok, _ in cells())} runnable cells x "
          f"{list(ABSTRACT_MESHES)}, predicted from {hw.device_name}'s published "
          f"peaks (the h100 descriptor: bf16 {hw.flops_bf16 / 1e12:.0f} TFLOP/s, "
          f"HBM {hw.hbm_bw / 1e12:.2f} TB/s, link {hw.ici_bw / 1e9:.0f} GB/s); not "
          f"measurements ({card})")
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    recs = [dryrun.run_cell(a, sh, m, RunConfig(microbatch=8), verbose=True, hw=hw)
            for a, sh, ok, _ in cells() if ok for m in ABSTRACT_MESHES]
    serving = dryrun.serving_cell("smollm2-135m", RunConfig(), hw=hw)
    torch.cuda.synchronize()
    moved = torch.cuda.memory_allocated() - allocated0
    out["dryrun"] = {"cells": len(recs), "seconds": time.perf_counter() - t0,
                     "allocated_moved": moved,
                     "records": [{k: r[k] for k in (
                         "arch", "shape", "mesh", "chips", "compute_s", "memory_s",
                         "collective_s", "bottleneck", "roofline_fraction",
                         "memory_per_device")} for r in recs],
                     "serving": {k: serving[k] for k in (
                         "num_pages", "page_tokens", "kv_bytes_per_token",
                         "block_table_gather_bytes", "cost_model")}}
    print(f"  dry-run: {len(recs)} cells and the serving cell priced in "
          f"{out['dryrun']['seconds']:.1f} s; the card's allocated bytes moved by "
          f"{moved} ({card})")
    if len(recs) != 64 or any(r["status"] != "ok" for r in recs) or moved:
        raise AssertionError(f"dry-run: {len(recs)} cells, allocated moved {moved}")

    print(f"  (2) bytes reckoned against bytes held: the family training phase's "
          f"states on a one-rank mesh ({card})")
    one = AbstractMesh((1, 1), ("data", "model"))
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    out["bytes"] = {}
    for key, replay_key in (("rwkv6 bf16", f"{RWKV_TRAIN} bf16"),
                            ("qwen3-moe bf16", next(k for k in fam_train["replay"]
                                                    if k.startswith(MOE_TRAIN)))):
        r, rep = fam_train[key], fam_train["replay"][replay_key]
        held = r["held"]
        cell = dryrun.build_cell(r["cfg"], shape, r["run"], one, hw)
        state, specs = cell.trees["state"], cell.specs["state"]
        exact = sharding.device_bytes(state, specs, one)
        rounded = sharding.device_bytes(state, specs, one, block=512)
        peak = dryrun.cell_counts(cell)["memory"]["peak_bytes"]
        row = {"reckoned": exact, "reckoned_512": rounded, "held": held,
               "reckoned_peak": peak, "eager_peak": rep["peak_bytes"]["eager"],
               "compiled_peak": rep["peak_bytes"]["capture"],
               "train_run_peak": r["peak_gib"] * 2**30}
        out["bytes"][key] = row
        print(f"    {key} ({r['cfg'].n_layers} layers): state reckoned {exact} B "
              f"(rounded to 512 a leaf: {rounded}); held: requested {held['requested']}, "
              f"allocated {held['allocated']} = {held['rounded_512']} in "
              f"{held['blocks_found']} leaf blocks of 512-byte multiples + "
              f"{held['unsplit']} left unsplit by the allocator; step peak reckoned "
              f"{peak / 2**30:.2f} GiB, measured eager {row['eager_peak'] / 2**30:.2f} "
              f"GiB, compiled {row['compiled_peak'] / 2**30:.2f} GiB (the 20-step run's "
              f"{r['peak_gib']:.2f} GiB absolute)")
        if not (exact == held["requested"] and rounded == held["rounded_512"]
                and held["allocated"] == held["block_bytes"]
                and held["blocks_found"] == held["storages"] == held["leaves"]):
            raise AssertionError(f"{key}: reckoned {exact} / {rounded} against held "
                                 f"{held}")

    print(f"  (3) a one-rank NCCL group, make_elastic_mesh(): SmolLM2-135M f32 "
          f"flat drain through Engine(mesh=) against the drain without ({card})")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_elastic_mesh()
        smol = get_config("smollm2-135m")
        params = build_model(smol, RunConfig(param_dtype="float32",
                                              compute_dtype="float32"),
                             ShapeSpec("serve", 1024, 4, "decode"),
                             device="cuda").init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, smol.vocab, int(n)) for n in rng.integers(20, 300, 4)]
        plain = mesh_drain(smol, params, prompts, None)
        meshed = mesh_drain(smol, params, prompts, mesh)
    finally:
        dist.destroy_process_group()
    same = (plain["tokens"] == meshed["tokens"]
            and len(plain["logits"]) == len(meshed["logits"])
            and all(np.array_equal(a, b) for a, b in zip(plain["logits"], meshed["logits"]))
            and plain["captures"] == meshed["captures"]
            and plain["captures_after"] == meshed["captures_after"] == meshed["captures"])
    print(f"    mesh {tuple(mesh.mesh.shape)} over {mesh.mesh_dim_names}: tokens, "
          f"{len(meshed['logits'])} model calls' logits and captures "
          f"{meshed['captures']} equal bit for bit: {same}; launches "
          f"{meshed['launches']}")
    if not same:
        raise AssertionError("Engine(mesh=) on a one-rank mesh differs from no mesh")
    by_path["mesh drain f32"] = meshed["launches"]
    out["drain"] = {"equal": same, "calls": len(meshed["logits"]),
                    "captures": meshed["captures"], "tokens": meshed["tokens"]}
    del params, plain, meshed
    gc.collect()

    print(f"  (4) blocked moe: {MOE_TRAIN} at full width, 1 layer, f32, "
          f"moe_local_dispatch over {MESH_DP} data shards (AbstractMesh, the global "
          f"view), {MESH_DP} x {MESH_MOE_SEQ} tokens, card = CPU ({card})")
    model = build_model(cfg, run, ShapeSpec("mesh", MESH_MOE_SEQ, MESH_DP, "decode"),
                        device="cuda", mesh=AbstractMesh((MESH_DP, 1), ("data", "model")))
    blocks = moe.dispatch_blocks(MESH_DP * MESH_MOE_SEQ, model.ctx)
    c = moe.capacity(MESH_MOE_SEQ, cfg)
    y, counts, routes, launches = blocked_moe(model, ffn, x)
    by_path["mesh blocked moe f32"] = launches
    if blocks != MESH_DP or launches["mmt4d"] != 3:
        raise AssertionError(f"blocked moe: {blocks} blocks, launches {launches}")
    checks.experts(BF, cfg.n_experts, MESH_DP * c, cfg.d_model, cfg.d_ff_expert,
                   "silu", f"experts qwen3-moe gate blocked {MESH_DP} x {c}")
    del ffn, x, model
    gc.collect()
    torch.cuda.empty_cache()
    CPU_RUNS.settle(block=True)
    cpu_y, cpu_counts, cpu_routes, _ = cpu.result()[0]
    diff = float((y - cpu_y).abs().max())
    scale = max(1.0, float(cpu_y.abs().max()))
    routing = routing_check(f"blocked moe ({blocks} blocks of C = {c})", cfg.top_k,
                            routes, cpu_routes)
    print(f"    {blocks} blocks, capacity {c} a block (rows [E, {blocks * c}, d]); "
          f"routed, kept: card {counts}, CPU {cpu_counts}; max |y diff| {diff:.3e} "
          f"(limit {F32_MARGIN:g} x {scale:.3f})")
    if counts != cpu_counts or not diff <= F32_MARGIN * scale:
        raise AssertionError(f"blocked moe card != CPU: counts {counts} vs "
                             f"{cpu_counts}, y diff {diff:.3e}")
    out["blocked_moe"] = {"blocks": blocks, "capacity": c, "counts": counts,
                          "y_diff": diff, **routing}
    out["cpu_runs"] = CPU_RUNS.finish()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  the mesh phase took {out['seconds']:.1f} s ({card})")
    return out, by_path


def by_descriptor(kernel, scaled_checks) -> dict:
    """Kernel ``kernel``'s bf16 representative case at each scaled
    descriptor's tiles: times, bound and library time (ragged_attn's tiles
    do not follow the lanes: it has none)."""
    out = {}
    for name, checks in scaled_checks.items():
        rep = next((c for c in checks.cases[kernel] if c["dtype"] == "bfloat16"
                    and c["shape"].startswith(REPRESENTATIVE[kernel])), None)
        if rep is not None:
            out[name] = {key: rep[key] for key in ("shape", "kernel_ms", "plain_ms",
                                                   "bound_ms", "bound_by",
                                                   "library_ms", "max_abs_err")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    sys.path.insert(0, src)
    import repro_torch.serving.engine     # noqa: F401  (the port is beside this script)
    global CPU_RUNS
    CPU_RUNS = CpuRuns(src)
    try:
        return smoke(args)
    finally:
        CPU_RUNS.close()


def smoke(args) -> int:
    """The phases, in the order the module's docstring gives them."""
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import query
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    t_start = time.perf_counter()

    def elapsed():          # each phase's start, for the run's timeline
        CPU_RUNS.settle()   # the comparisons whose CPU runs have ended
        print(f"[{time.perf_counter() - t_start:.1f} s into the run]")

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s, "
          f"sm_90a, one nvcc per source)")

    hw = query("cuda", "h100")      # the card's own, whatever $REPRO_HW says
    print(f"hardware: {hw.device_name}, {hw.sm_count} SMs, HBM {hw.hbm_bw / 1e12:.2f} TB/s, "
          f"bf16 {hw.flops_bf16 / 1e12:.0f} TFLOP/s, f32 {hw.flops_f32 / 1e12:.0f} TFLOP/s")
    cfg = get_config("smollm2-135m")
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)), device="cuda",
                 max_slots=4, chunk_tokens=128, page_tokens=16)
    elapsed()
    print("kernels vs plain versions on the card (mmt4d and the tied-head pack "
          "L2-cold):")
    checks = KernelChecks(hw, torch.Generator(device="cuda").manual_seed(0))
    checks.run(eng._flat_shapes())
    print(f"ragged_attn at d_head 128 (Qwen3-8B's and ChatGLM3-6B's heads) "
          f"vs its plain version, L2-cold and warm, beside the SDPA yardstick "
          f"({card}):")
    checks.run_d128()
    f32_chunk_cases = checks.f32_chunk_identity()

    # the bf16 flat drain below makes its own engine: the moe and jamba
    # phases reckon their depth from the whole card
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {}
    elapsed()
    print(f"the moe family: the expert-batched mmt4d at qwen3-moe's and "
          f"arctic's expert products; each at full width, f32 card = CPU "
          f"({', '.join(f'{a} {MOE_F32_LAYERS[a]} layers' for a in MOE_ARCHS)}; "
          f"tokens, first logits within {F32_MARGIN:g}, dropped fractions, "
          f"routing) and the bf16 §4 flat drain cut in depth ({card})")
    moe_res, moe_paths = moe_phase(card, checks)
    by_path.update(moe_paths)
    elapsed()
    print(f"jamba: selective_scan against its plain version at jamba's widths "
          f"(di 8192, N 16), f32 (rtol {SCAN_RTOL:g}, atol {SCAN_ATOL:g}) and "
          f"bf16; jamba-v0.1-52B in bf16 at its published widths cut to the "
          f"whole periods that fit, through the monolithic step; its first "
          f"period with its moe layers in f32, card = CPU ({card})")
    jamba, jamba_paths = jamba_phase(card, checks)
    by_path.update(jamba_paths)
    elapsed()
    print(f"the dense configs and the vlm family at their published widths: "
          f"Qwen3-8B at full depth through the flat drain (bf16); Qwen2-7B, "
          f"ChatGLM3-6B and OLMo-1B cut to {DENSE_F32_LAYERS} layers (f32 card = "
          f"CPU, bf16 under a top-2 margin of {BF16_MARGIN:g}); InternVL2-26B's "
          f"language model through generate_static (f32 at {VLM_F32_LAYERS} "
          f"layers card = CPU, bf16 at {VLM_LAYERS}) ({card})")
    dense, dense_paths = dense_phase(card)
    by_path.update(dense_paths)
    elapsed()
    print(f"the recurrent mixers: wkv6 against its plain version at RWKV-6's "
          f"heads (32 of 64), L2-cold, relative tolerance {WKV6_TOL:g} on y "
          f"and the final state ({card}):")
    checks.wkv6(4, 1, "decode rows")
    checks.wkv6(1, 512, "prefill")
    checks.wkv6(2, 256, "prefill cached")
    elapsed()
    print(f"RWKV-6 1.6B whole (bf16, monolithic, exact-length prefills) and "
          f"RWKV-6 at {PARITY_LAYERS} layers (f32 card = CPU, generate_static "
          f"= generate) ({card})")
    recurrent, rec_paths = recurrent_phase(card)
    by_path.update(rec_paths)
    elapsed()
    print("end to end, float32: 4 requests x 8 new tokens, card vs CPU plain "
          "path, each step family (card: graphs captured at warmup)")
    rng = np.random.default_rng(1)
    f32_prompts = [rng.integers(0, cfg.vocab, int(n)) for n in rng.integers(5, 25, 4)]
    f32 = {fam: compare_f32(cfg, f32_prompts, fam) for fam in FAMILIES_F32}
    if len({str(r["tokens"]) for r in f32.values()}) != 1:
        raise AssertionError(f"the families' f32 tokens differ: "
                             f"{ {k: r['tokens'] for k, r in f32.items()} }")
    print(f"  greedy tokens identical on the card, flat = dense = monolithic "
          f"(each held to the CPU's when its run ends): {f32['flat']['tokens']}")
    elapsed()
    print(f"end to end, float32, sampled (seed 11, temperatures "
          f"{TEMPERATURES}): the same drains, card vs CPU plain path, each "
          f"family; a pick may differ only below a perturbed top-2 margin of "
          f"{F32_MARGIN:g}")
    f32_sampled = {fam: compare_f32(cfg, f32_prompts, fam, greedy=False)
                   for fam in FAMILIES_F32}

    elapsed()
    print("end to end, bfloat16: Engine(max_slots=4, page_tokens=16), seq_len "
          "1024, 8 requests x 32 new tokens, each family (flat and dense: "
          f"chunk_tokens=128) ({card})")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    print(f"  prompts {lens.tolist()}")
    e2e = {fam: drain_bf16(cfg, fam, prompts) for fam in FAMILIES_BF16}
    launches, steps = e2e["flat"]["launches"], e2e["flat"]["steps"]
    unpacked = e2e["flat"]["unpacked_stores"]
    engines = {fam: r.pop("engine") for fam, r in e2e.items()}
    by_path.update({f: r["launches"] for f, r in e2e.items()})

    elapsed()
    print(f"end to end, bfloat16, sampled (seed 3, temperatures "
          f"{TEMPERATURES}): the same 8 requests on the warmed engines, each "
          f"family; the families' picks may differ only below a perturbed "
          f"top-2 margin of {BF16_MARGIN:g} ({card})")
    reqs = [(p, 32, TEMPERATURES[i % 4]) for i, p in enumerate(prompts)]
    bf16_sampled = {fam: timed_drain(e, reqs, False, 3, f"bf16 {fam} sampled")
                    for fam, e in engines.items()}
    flat_picks = bf16_sampled["flat"].pop("picks")
    for fam in ("dense", "monolithic"):
        bf16_sampled[fam]["vs_flat"] = compare_picks(
            flat_picks, bf16_sampled[fam].pop("picks"), BF16_MARGIN,
            f"bf16 sampled {fam} vs flat")
        by_path[f"{fam} sampled"] = bf16_sampled[fam]["launches"]
    by_path["flat sampled"] = bf16_sampled["flat"]["launches"]

    elapsed()
    print(f"two engines of one family over one model, both warmed (bf16, "
          f"the engines above; {card})")
    c1 = c1_two_engines(engines)
    del engines
    elapsed()
    print(f"the static batch loop (generate_static), full width, float32 and "
          f"bfloat16: SmolLM2-135M and whisper-small, each card vs the f32 "
          f"CPU plain path (f32 exactly, bf16 under a top-2 margin of "
          f"{BF16_MARGIN:g}) ({card})")
    static, static_paths = static_phase(card)
    by_path.update(static_paths)
    elapsed()
    print(f"prefix cache and speculation (spec_tokens=2), float32, full width "
          f"cut to {VARIANTS_F32_LAYERS} of {cfg.n_layers} layers, each family: "
          f"the spec trace (8 requests, 4-token motifs tiled to "
          f"16, 16-32 new) and the shared-prefix trace (12 requests, one "
          f"256-token system prompt, 2-6-token suffixes, 3-16 new, "
          f"staggered), greedy and sampled (seed 5); picks held to the "
          f"baseline's below a top-2 margin of {F32_MARGIN:g} ({card})")
    variants_f32 = serve_variants(dataclasses.replace(cfg, n_layers=VARIANTS_F32_LAYERS),
                                  TF, FAMILIES_BF16)
    elapsed()
    print(f"the same in bfloat16, picks held to the baseline's below a top-2 "
          f"margin of {BF16_MARGIN:g} ({card})")
    variants_bf16 = serve_variants(cfg, BF, FAMILIES_BF16)
    for (fam, variant), r in variants_bf16.items():
        for key, run_ in r["runs"].items():
            by_path[f"{fam} {variant} {key}"] = run_["launches"]

    chaos = {}
    for dtype, what in ((TF, f"float32, survivors held to the clean drain's "
                             f"tokens exactly, the runtime sanitizer on"),
                        (BF, f"bfloat16, picks held to the clean drain's below "
                             f"a top-2 margin of {BF16_MARGIN:g}")):
        elapsed()
        print(f"resilience under chaos, {what}: full width, max_slots=4, "
              f"page_tokens=16, queue_limit=6, each of {list(CHAOS_FAMILIES)}, "
              f"the plans of scripts/chaos_smoke.py, a lifecycle drain and a "
              f"watchdog trip ({card})")
        chaos[str(dtype)[6:]] = chaos_phase(cfg, dtype)
    for dt, fams in chaos.items():
        for fam, runs in fams.items():
            for key, r in runs.items():
                if "launches" in r:
                    by_path[f"chaos {dt} {fam} {key}"] = r["launches"]

    elapsed()
    print(f"serving observability, bfloat16, full width: the §4 drain with "
          f"telemetry off and on in each family, the spec and shared-prefix "
          f"traces (flat, spec_tokens=2, prefix cache) and a chaos drain with "
          f"telemetry on ({card})")
    telemetry, tel_paths = telemetry_phase(cfg, prompts, card)
    by_path.update(tel_paths)

    elapsed()
    print(f"vector lengths and layout policies, full width: the card's "
          f"descriptor scaled to {list(SCALED)} (wider tiles, the same card) "
          f"and the fixed and unpacked policies ({card})")
    layouts, layout_paths, scaled_checks = layouts_phase(
        cfg, f32_prompts, prompts, torch.Generator(device="cuda").manual_seed(1),
        card)
    by_path.update(layout_paths)

    elapsed()
    print(f"mmt4d's gradient kernels vs plain versions on the card at the "
          f"full-width training linears ({TRAIN_BATCH * TRAIN_SEQ} tokens; the "
          f"gate with its silu's gradient), L2-cold, beside torch.matmul ({card}):")
    for dtype in (BF, TF):
        checks.grads(dtype, TRAIN_BATCH * TRAIN_SEQ, 576, 1536, "silu", "gate")
        checks.grads(dtype, TRAIN_BATCH * TRAIN_SEQ, 1536, 576, None, "down")
        checks.grads(dtype, TRAIN_BATCH * TRAIN_SEQ, 576, 49152, None, "tied head")
        checks.grads(dtype, TRAIN_BATCH * TRAIN_SEQ, 576, 192, None, "k proj")
    training, train_paths = training_phase(cfg, card)
    by_path.update(train_paths)
    elapsed()
    print("the CPU plain path's runs: every comparison still waiting on one")
    cpu_runs = CPU_RUNS.finish()
    elapsed()
    print(f"training the recurrent and moe families: wkv6's and selective_scan's "
          f"backward kernels and the expert-batched gradient kernels against their "
          f"plain versions; one f32 step card = CPU for "
          f"{[a for a, *_ in FAMILY_F32]}; {RWKV_TRAIN} whole and {MOE_TRAIN} at "
          f"full width cut in depth in bf16 through the compiled step ({card})")
    fam_train, fam_paths = family_training_phase(card, checks)
    by_path.update(fam_paths)
    elapsed()
    print(f"the mesh, the sharding rules, the dry-run and moe's per-shard dispatch "
          f"(ROADMAP A10): the dry-run on the card's descriptor, its bytes against "
          f"the training states held, a one-rank NCCL mesh's drain, and the blocked "
          f"moe layer card = CPU ({card})")
    mesh_res, mesh_paths = mesh_phase(card, checks, fam_train)
    by_path.update(mesh_paths)
    # the main path of each kernel: the flat drain for the serving kernels,
    # the 20-step bf16 training run for the gradient kernels
    train_main = train_paths["train bf16"]
    # the RWKV-6 1.6B drain for wkv6, jamba's first drain for selective_scan
    main_launches = {**launches, **{k: train_main[k] for k in GRAD_KERNELS},
                     "wkv6": rec_paths["rwkv6-1.6b monolithic bf16"]["wkv6"],
                     "selective_scan": jamba_paths[f"{JAMBA} monolithic bf16"][
                         "selective_scan"]}
    main_steps = {k: training["bf16"]["steps"] if k in GRAD_KERNELS else steps
                  for k in SOURCES}
    main_steps["wkv6"] = recurrent["rwkv6-1.6b"]["steps"]
    main_steps["selective_scan"] = jamba[JAMBA]["steps"]
    # the backward kernels' main paths: RWKV-6 1.6B's 20 bf16 train steps
    # for wkv6_bwd; jamba's one f32 train step on the card (its period does
    # not fit one card in training) for selective_scan_bwd
    main_launches["wkv6_bwd"] = fam_paths["train bf16 rwkv6-1.6b"]["wkv6_bwd"]
    main_steps["wkv6_bwd"] = fam_train["rwkv6 bf16"]["steps"]
    main_launches["selective_scan_bwd"] = fam_paths[
        "train f32 jamba-v0.1-52b"]["selective_scan_bwd"]
    main_steps["selective_scan_bwd"] = 1
    for k in SOURCES:
        if not main_launches[k]:
            raise AssertionError(f"{k}: no launch on its main path")

    kernel_rows = []
    for k, cases in checks.cases.items():
        # wkv6 and its backward: f32 only
        rep_dtype = "float32" if k in ("wkv6", "wkv6_bwd") else "bfloat16"
        rep = next(c for c in cases if c["dtype"] == rep_dtype
                   and c["shape"].startswith(REPRESENTATIVE[k]))
        src, replaces = SOURCES[k]
        kernel_rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[k],
            "launches_per_step": main_launches[k] / main_steps[k],
            "launches_by_path": {f: n[k] for f, n in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rep["kernel_ms"], "kernel_ms": rep["kernel_ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            **({"library": "none: no PyTorch call computes this recurrence"}
               if rep["library_ms"] is None else {}),
            "by_descriptor": by_descriptor(k, scaled_checks),
            **({"d_head_128": [{key: c[key] for key in (
                "shape", "dtype", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "split")} for c in cases
                if c["shape"].startswith("d128")]} if k == "ragged_attn" else {}),
            **({"experts": [{key: c.get(key) for key in (
                "shape", "dtype", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "split")} for c in cases
                if c["shape"].startswith("experts")]}
               if k in ("mmt4d",) + GRAD_KERNELS else {}),
            **({"expert_batched_launches_per_step": fam_train["qwen3-moe bf16"][
                "counters"][f"{k}.expert_batched"] / fam_train["qwen3-moe bf16"]["steps"]}
               if k in GRAD_KERNELS else {}),
            "split": rep.get("split"), "shape": rep["shape"],
            "dtype": rep["dtype"], "card": card, "cases": cases,
            **({"unpacked_stores": unpacked} if k == "mmt4d" else {}),
            **({"floor_ms": checks.floor_ms, "floor_wait_ms": checks.floor_wait_ms}
               if k == "unpack" else {})})
    result = {"kernels": kernel_rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**result, "card": card, "e2e_bf16": e2e, "e2e_f32": f32,
                       "f32_sampled": f32_sampled, "bf16_sampled": bf16_sampled,
                       "c1": c1,
                       "variants_f32": {str(k): v for k, v in variants_f32.items()},
                       "variants_bf16": {str(k): v for k, v in variants_bf16.items()},
                       "chaos": chaos, "telemetry": telemetry,
                       "static": static, "layouts": layouts,
                       "f32_chunk_cases": f32_chunk_cases,
                       "scaled_checks": {n: c.cases for n, c in scaled_checks.items()},
                       "training": training, "dense": dense,
                       "recurrent": recurrent, "moe": moe_res, "jamba": jamba,
                       "family_training": fam_train, "mesh": mesh_res,
                       "cpu_runs": cpu_runs,
                       "total_s": time.perf_counter() - t_start}, f, indent=1,
                      default=str)
    elapsed()
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
