"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs the paper's plan-and-train loop, the RWKV6 server and the Qwen3
server, trains both language models, and serves the dense configs with
their options (QKV biases, the GELU MLP, an untied head, sliding windows),
the MoE configs, the VLM backbone and the hybrid and audio families,
through ``repro_torch`` on the card, in phases; any failure raises and
exits non-zero:

  1. device  require CUDA; print the card's name and power limit
  2. build   build K1 (min-plus), K3 (WKV6), K2 (flash), K2' (flash
             backward) and K3' (WKV6 backward) from the checkout's sources,
             one nvcc each, all started together; print K1's ptxas -v
  3. kernel  hold K1 against its plain PyTorch version on the card, at the
             thresholds Algorithm 1 sweeps on the quickstart instance
             (VGG-16, 6 servers + 4 clients) and on a fleet instance
             (48 servers x 30 layers), at their bottleneck calls (max mode
             at t = inf) and at all their thresholds: float64
             bitwise equal, float32 within rtol 1e-4 with matching finite
             masks, both modes; timed by CUDA events and by the profiler's
             device time, with the route each ran (a cluster of C blocks a
             threshold, or tiles of T thresholds a block); the same checks
             on a 96-server graph that no 16-block cluster holds (the tiled
             route) and at thresholds under beta* on the fleet (no feasible
             path; under every beta the sweep exits after one layer)
  4. plan    ours(B=512, b0=20) on cuda equals the same call on the CPU
             (cuts, placement, b, T_f, T_i, L_t) and launched K1;
             no_pipeline and the Eq. (14) event-simulation gap
 4b. sweep   K1's graph axis (many graphs in one launch) against its plain
             version at the shapes Planner.solve_many launches, recorded
             on the CPU: phases B (beta* per b) and C (every (b, t) pair)
             of the quickstart's exhaustive_joint(B=512, b_step=4) and of
             the fleet's b-sweep (B=128, b_step=16), and a case whose
             groups do not fill whole tiles; float64 bitwise (also against
             one one-graph call per graph), float32 within rtol 1e-4 with
             matching finite masks, both modes; timed by the profiler's
             device time and CUDA events beside the bound, the plain
             version and the one-graph calls the launch replaces.  Then the
             paper's comparison schemes on cuda equal to the CPU:
             exhaustive_joint (2 K1 launches; wall on both devices),
             rc_op / rp_oc(seed=7) (masked sweeps only, no K1 launch; ours
             no worse), optimal (Fig. 7's gap) and the fluctuation report
             (cv 0.2, 16 draws)
  4c. replan warm replans, the batched device planner and the elastic
             coordinator on the reference's planner benchmark fleet
             (transformer_profile "bench30": 28 blocks, d_model 512, 8
             heads, d_ff 2048, vocab 32000, seq 128; 24 servers + 4
             clients, seed 1, kappa 1/32, f 1-10 TFLOP/s, memory 4-32 GiB;
             B = 64): solve_many(b = 1..64, backend="device") in float64
             equal to the CPU's and to backend="exact" on cuda, float32
             within the reference's contract (feasibility, rtol 1e-4 on the
             float64-repriced objective, b), 2 K1 launches a call (phases B
             and C), walls of all three; K1's graph axis at the device
             backend's phase B and C shapes (recorded on the CPU) against
             its plain version, timed beside the bound; the 16 single-link
             and straggler deltas of benchmarks/bench_planner.py at b = 8:
             each warm solve on cuda equal to a cold solve on a fresh cuda
             Planner and to the CPU's warm solve, 16 incremental hits, the
             patched graph equal to a fresh assembly, warm and cold walls;
             then ft.Coordinator on the quickstart (B = 512) through
             RateChange(1, 2, 0.25), Straggler(6, 3.0) and NodeFailure(1),
             each plan (solution, b, L_t) equal to the CPU coordinator's
 4d. sim     the simulator's engines on the card (repro_torch.sim), on
             instances rebuilt with the port's constructors: (a) the
             quickstart plan (ours, B = 512) on the event and vectorized
             engines under fifo / 1f1b / memory admission, on the constant
             network and a Gauss-Markov scenario (cv 0.3, seed 0):
             vectorized within 1e-9 of event, cuda within rtol 1e-12 of
             the CPU, cross_validate ok at rtol 1e-6 on it and on
             cross_validate_many(20); (b) the reference's engine-scaling
             chain (100 nodes, one stage each, 10,000 micro-batches: 3.98 M
             tasks) on the vectorized engine, fifo and 1f1b: Eq. (12)-(14)
             within rtol 1e-6 under fifo (Eq. (12) under 1f1b, and 1f1b
             against the event engine at 200 micro-batches), cuda within
             1e-12 of the CPU, walls and peak device memory; (c) the
             Gauss-Markov trace chain (8 nodes x 10,000): vectorized
             against event on cuda within 1e-9, both walls; (d)
             simulate_plans over the quickstart plan at b = 1..64: stacked
             equal to 64 looped calls and to the CPU within 1e-12, both
             walls; (e) simulate_with_replanning on the quickstart with a
             Straggler and a RateChange: 2 replans, every segment's plan
             equal to the CPU run's, the makespan within 1e-12, K1
             launched (sim_replan_launches in the kernels line)
 4e. robust  planning scored by the simulator and by tail risk, the fuzz
             campaign, the replan policies, Chrome traces and checkpoints,
             each on cuda against the port's CPU result: (a) sim_refined
             on the quickstart (B = 512, b0 = 20) equal to the CPU's plan,
             objective within 1e-12, K1 launched; SimMakespan's
             evaluate_many over the plan's whole feasible-b box (one
             stacked simulate_plans) equal to looped evaluate; (b) the
             trace-mode fluctuation report (cv 0.2, 16 draws, piecewise
             and Gauss-Markov) equal to the CPU's; (c) run_fuzz(500,
             seed=0) (the reference's standing campaign: vectorized engine
             on the card, heap engine on the host) with every gap within
             1e-9, the same vectorized / fallback counts as the CPU, and
             every tests/corpus case replayed; (d) the reference's CVaR
             selection grid (random_instance 3, 5, 9, 12 and the 4-server
             paper network at B = 64; 16 fuzzed scenarios plus a crafted
             first-hop outage): closed-form and RobustMakespan picks equal
             to the CPU's, the robust pick's CVaR0.95 no worse on every
             instance and better on one; bcd_solve(quickstart, B = 512,
             RobustMakespan(n_scenarios=12)) equal to the CPU's, K1
             launched; (e) bench_ft_policy.py's zoo (random_instance(3),
             10 flap streams, solve downtime 0.05, remap 0.01) plus
             AdaptiveCadence: reports equal to the CPU's, Hysteresis
             <= 25% of Eager's replans with a mean no worse than Eager's
             and a final objective no worse than RideOut's, K1 launched;
             (f) write_chrome_trace of the quickstart plan's run valid and
             equal to the CPU's; the executor's VGG-16 stage parameters
             checkpointed from the card and restored onto it bitwise; a
             coordinator NodeFailure charged estimate_restore_seconds of
             that checkpoint (a rate change nothing)
  5. train   one VGG-16 round on cuda matches the CPU (TF32 off), also with
             int8 and top-k link hooks; then a few rounds at the B=512
             plan, timed
  6. build   K3, the RWKV6 WKV scan (two passes: the states entering each
             64-token tile, then every tile's outputs): ptxas -v, the
             tensor-core instructions (HMMA) of each pass's bf16 and f32
             kernel in the SASS (fails if any has none) and each pass's
             resident blocks per SM
  7. wkv6    hold K3 against its plain versions on the card (the chunked
             and per-token ones, and wkv6_tiled_plain, the kernel's own
             decomposition) at the reference's WKV_SWEEP shapes, two odd
             chunks, tiles crossing chunks of 1, 2 and 31 with a ragged last
             tile, the served layer shape (1 x 512 tokens x 32 heads x 64,
             chunk 256) and a 511-token prompt (chunk 1): atol = rtol = 1e-4
             in float32 and 3e-2 in bfloat16 on y and the final state; under
             a decay strong enough to overflow the chunked form (log w about
             -4.5), finite and within those of the other two; two halves
             with the state carried equal the whole sequence; then time it
             at the served and 511-token shapes by CUDA events and by the
             profiler's device time
  8. model   a 2-layer rwkv6-1.6b at full width in float32 compute (TF32
             off): 512- and 511-token prefills on cuda (through K3; chunk
             256 and 1) match the same weights on the CPU (plain) within
             1e-3 relative to each tensor's largest magnitude, on the logits
             and the WKV state; 64 decode steps after a 64-token prefill
             match a 128-token prefill at the reference's 2e-3
  9. serve   BatchedServer("rwkv6-1.6b", reduced=False, batch=4,
             cache_len=1024): 8 requests of 512 prompt tokens, 32 new
             tokens each; K3 launched 8 x 24 = 192 times; prefill ms per
             request, decode tokens/s, peak device memory
 10. build   K2, the flash-attention forward: ptxas -v of both entries,
             the tensor-core instructions (HMMA / HGMMA) in the bf16
             kernel's SASS (cuobjdump; fails if there are none) and its
             resident blocks per SM
 11. flash   hold K2 against its plain version on the card at the
             reference's FLASH_SWEEP shapes (a length of 200, cross lengths
             128/256 with GQA 4:1, MQA), a ragged 77-token shape at hd 16,
             the served layer shape of qwen3-0.6b (1 x 512 x 512, 16 heads,
             8 kv heads of 128, causal) and a 2048-token causal prompt (the
             reference's chunked_attention branch): atol = rtol = 2e-5 in
             float32 and 2e-2 in bfloat16; then time K2 (bf16 and float32
             inputs), its plain version and scaled_dot_product_attention
             (the library yardstick, never called by the port) at the
             served and 2048-token shapes, beside the bound, and K2 on one
             query tile per head against all the keys (the longest block's
             chain alone)
 12. model   a 2-layer qwen3-0.6b at full width in float32 compute (TF32
             off): a 512-token prefill on cuda (through K2) matches the
             same weights on the CPU (plain) within 1e-3 relative to each
             tensor's largest magnitude, on the logits and the KV cache;
             64 decode steps after a 64-token prefill match a 128-token
             prefill at the reference's 2e-3
 13. serve   BatchedServer("qwen3-0.6b", reduced=False, batch=4,
             cache_len=1024): 8 requests of 512 prompt tokens, 32 new
             tokens each; K2 launched 8 x 28 = 224 times; prefill ms per
             request, decode tokens/s, peak device memory
 14. build   K2' and K3' (built in phase 2): their ptxas -v, the
             tensor-core instructions (HMMA / HGMMA) in the SASS of the
             bf16 dk/dv and dq kernels of K2' at every head size and of the
             passes B1 and B2 of K3' (both entries; fails if any has none),
             and each one's resident blocks per SM
 15. flash'  K2' against flash_bwd_plain and against autograd through
             attention_plain (float32 on the same inputs), and K2's
             log-sum-exp against attention_lse_plain, at the FLASH_SWEEP
             shapes, the ragged 77-token shape at hd 16 and qwen3-0.6b's
             training layer (4 x 512 x 512, 16 heads / 8 kv heads of 128,
             causal): atol = rtol = 1e-4 for float32 inputs, 3e-2 for
             bfloat16; the autograd route (FlashAttention) equals the
             direct call; then K2' timed at the training layer (CUDA
             events, device_ms) beside its bound, the plain
             version and scaled_dot_product_attention's backward (device
             time of its backward kernels: the library yardstick), with
             each kernel's share of the device time
 16. wkv6'   K3' against wkv6_bwd_plain, wkv6_bwd_tiled_plain (the
             kernel's own decomposition) and autograd through the chunked
             plain version, with a nonzero s0 and a gradient on the
             final state, at the WKV_SWEEP shapes, tiles crossing chunks
             with a ragged last tile, head sizes 1 and 2 (padded to 4, via
             the autograd route) and rwkv6-1.6b's training layer (4 x 512
             tokens, 32 heads of 64); under a strong decay (log w about
             -4.5) against autograd through the per-token version; 1e-4
             float32, 3e-2 bfloat16 r/k/v; the autograd route (WKV6)
             equals the direct call; then K3' timed at the training
             layer, with each pass's share of the device time
 17. grads   a 2-layer qwen3-0.6b and a 2-layer rwkv6-1.6b at full width
             in float32 compute with TF32 off (matmul and cuDNN): the loss
             and every gradient over 2 micro-batches of 1 x 256 tokens on
             cuda (K2/K2', K3/K3') match the same weights on the CPU
             (plain) within 1e-3 of each tensor's largest magnitude, under
             remat none and layer; K2'/K3' launched layers x micro-batches
             times, K2/K3 once more per layer and micro-batch under layer
 18. train   train("qwen3-0.6b", reduced=False) and train("rwkv6-1.6b",
             reduced=False): full width and depth, bf16 compute, AdamW,
             batch 8 x 512 tokens in 2 micro-batches, 4 steps; every loss
             finite and the last below the first; K2 / K2' (K3 / K3')
             launched 2 x and 1 x layers x micro-batches x steps (remat
             "layer" runs each forward kernel again in the backward); step
             time, tokens/s, peak device memory and the device's idle
             share over one more step (profiled steps, two agreeing); then a restart from a
             checkpoint on the reduced configs, its losses within 1e-3 of
             an uninterrupted run
 19. window  K2 and K2' with a sliding window (1, 7, 64, 100, 4096) against
             their plain versions: K2 at the causal FLASH_SWEEP shapes, the
             ragged hd-16 one, the served qwen3 layer and 2048 tokens (f32
             2e-5, bf16 2e-2); K2' and K2's lse at the causal FLASH_SWEEP
             shapes and the training layer (f32 1e-4, bf16 3e-2), no NaN in
             any output or lse, the autograd route equal to the direct
             call; head size 8 (zero-padded to 16) with and without a
             window; then K2 (served, 2048) and K2' (training layer) timed
             at window 128 beside the bound over the pairs inside the
             window, the unwindowed call, the plain version and SDPA given
             the same boolean mask (its backend named)
 20. dense   a 2-layer qwen1.5-4b and llama3-8b at full width in f32 (TF32
             off), each as published and with sliding_window 100 and
             ffn_mult 2 together: a 512-token prefill on cuda (K2) against
             the CPU on the logits and KV cache, and the loss and every gradient
             (bq / bk / bv, b_up / b_down, lm_head among them) over 2
             micro-batches of 1 x 256 tokens (K2 / K2' launched layers x
             micro-batches times), within 1e-3 of each tensor's largest
             magnitude
 21. serve   BatchedServer("qwen1.5-4b"), ("llama3-8b") and
             ("command-r-35b"), reduced=False, num_layers=8: full width, 8
             of 40 / 32 / 40 layers (command-r's 40 in f32 are ~121 GB; the
             others are cut for the run's time); f32 params, bf16 compute,
             batch 4, cache_len 1024, 8 requests of 512 prompt tokens and
             32 new tokens each; K2 launched 8 x 8 = 64 times each; prefill
             ms per request, decode tokens/s, peak device memory; each
             model freed before the next
 22. moe k2  K2 (f32 2e-5, bf16 2e-2) and K2' (bf16, batch 4, 3e-2)
             against their plain versions at the layer shapes of
             granite-moe-3b (24 / 8 heads of 64), qwen3-moe-235b (64 / 4 of
             128) and internvl2-1b (14 / 2 of 64, 256 patches + 512
             tokens); K2 timed there and at phase 21's dense serving layers
             (20 / 20, 32 / 8, 64 / 8 of 128) by CUDA events and the
             profiler's device time in turns with
             scaled_dot_product_attention, beside the bound and the plain
             version
 23. moe     a 2-layer granite-moe-3b and internvl2-1b and a 1-layer
             qwen3-moe-235b at full width in f32 (TF32 off): a 512-token
             prefill (internvl2-1b's after 256 seeded patch embeddings) on
             cuda (K2) against the CPU on the logits and KV cache; for the
             first two the loss and every gradient (router, experts, bq /
             bk / bv, the patch path) over 2 micro-batches of 1 x 256
             tokens, and 2 Adafactor steps of granite-moe-3b (parameters
             and stacked optimizer state), all within 1e-3; every MoE
             call's top-K sets compared with the card's on the CPU: a
             differing token must sit at a near-tie (K-th and (K+1)-th
             probabilities within 1e-5) and then takes the card's picks,
             so every output stays compared; counted and printed
 24. serve   BatchedServer at full width: granite-moe-3b-a800m at 8 of
             its 32 layers (for the run's time), internvl2-1b at full
             depth, qwen3-moe-235b-a22b at 4 of its 94 layers (94 in f32 are
             ~940 GB); as phase 21 (8 requests of 512 prompt tokens,
             internvl2-1b's after zero patch embeddings, 32 new tokens
             each); K2 launched 8 x layers times (64, 192, 32)
 25. hybrid/audio  whisper-small at full size (12 + 12 layers, 1500
             frames) and jamba-1.5-large at full width cut to one period of
             2 layers (a Mamba + SwiGLU and an attention + MoE slot) with 4
             of its 16 experts, in f32 (TF32 off): a prefill (whisper: 1500
             seeded frames and 64 tokens; jamba: 256 tokens) on cuda (K2)
             against the CPU on the logits, every cache entry (k / v, xk /
             xv, each Mamba slot's conv and ssm states) and whisper's
             encoder output; 32 decode steps against the logits of the
             longer sequence on the card (2e-3; jamba's experts then hold
             every token, as a one-token decode step's do); the loss and
             every gradient over 2 micro-batches of 1 x 64 (whisper) and
             1 x 128 (jamba) tokens, K2 / K2' launched (12 + 2 x 12) and 1
             times a micro-batch; all within 1e-3 of each tensor's largest
             magnitude, every MoE call's routing held to the card's
 26. ha k2   K2 (f32 2e-5, bf16 2e-2) and K2' and K2's lse (1e-4, 3e-2)
             against their plain versions without the causal mask at
             whisper's encoder (1500 x 1500, 12 heads of 64) and cross
             (64 x 1500) layers and a ragged (2, 77, 131, 4, 2, 16) shape,
             and at jamba's attention layer (512, 64 / 8 heads of 128,
             causal); no NaN; K2 and K2' at the encoder, cross and jamba
             attention shapes timed (device_ms) in turns with
             scaled_dot_product_attention and its backward (kernel, SDPA,
             SDPA, kernel), beside the bound, the plain version and (K2)
             CUDA events of back-to-back calls
 27. serve   BatchedServer at full width: whisper-small (reduced=False; 8
             requests of 64 prompt tokens after zero frames and 64 new
             tokens, cache_len 448: K2 launched 8 x 36 = 288 times) and
             jamba at the 2-layer period with all 16 experts (8 requests of
             512 prompt tokens and 32 new, cache_len 1024: K2 launched 8
             times); f32 params, bf16 compute, batch 4; prefill ms per
             request, decode tokens/s, peak device memory; each model
             freed before the next
 28. spmd    the paper's stage pipeline (pipeline/spmd.py) over (data
             2 x stage 2): the stage planner (core/planner.py, H100
             defaults, 2 GPUs, the 8 rows a data rank scores of a batch
             of 16; BCD from b0 = 8 and from 1, the lower L_t kept) gives
             Q; four processes share the card under gloo (host-staged
             transfers; NCCL refuses two ranks on one GPU), each holding
             14 of qwen3-0.6b's 28 layers at full width in their FSDP
             blocks over the two data ranks (gathered once a step, the
             gradients reduce-scattered); float32 with TF32 off: the
             pipelined loss within 1e-5 of the plain model's on the card,
             every block gradient and one AdamW step within 1e-4 of each
             tensor's largest magnitude against the matching blocks of the
             plain ones; bfloat16: each rank's memory_allocated after
             shard_params and opt.init beside its blocks' bytes, the same
             stage's at one data rank and the dry run's argument bytes of
             the cell, 2 timed AdamW steps (wall, tokens/s, each rank's
             device busy time from two profiled steps whose kernel counts
             must agree, peak memory, host seconds and bytes by transfer)
             beside the plan's T_f / T_i / L_t / bubble and the plain
             single-process step at the same batch (Q = 2 and Q); K2 / K2'
             launches per rank equal to T x 14 (x 2 for K2 under remat
             "layer") a step
 29. tp      the "model" axis inside the stages: qwen3-0.6b over (stage
             2 x model 2), four processes sharing the card under gloo
             (2 intra-op threads each), each rank 14 layers at 8 / 4
             heads of 128 and d_ff 1536, the head's vocabulary split over
             the model ranks, Q from the planner as in 28; internvl2-1b's
             backbone (2 layers) over (stage 1 x model 4) in the same
             processes, its 14 heads gathered whole and the keys split
             (f32 checks as below, 2 timed bf16 steps, K2 / K2' launches
             as derived); K2 / K2' with a key offset at its layer, split
             4 and 3 ways, against the plain versions and combined
             against the whole calls, timed beside SDPA given each
             block's mask;
             float32 (TF32 off), the model blocks put back together: loss
             within 1e-5, every gradient within 1e-4 of scale of the plain
             model's, one AdamW step within 1e-6 of scale of AdamW on its
             gradients; granite-moe-3b (2 layers, 20 experts a rank) at
             the same bounds; bfloat16: 3 timed steps, busy time, peak
             memory, Pipe.seconds / Pipe.bytes by kind, K2 / K2' launches
             per rank T x 14 (x 2) / T x 14; K2 and K2' at the TP-local
             layer (1 x 512, 8 / 4 of 128) against their plain versions
             and timed beside SDPA; the dry run of the same cell (fake CUDA
             tensors, a fake group of 4) beside the measured bytes, peak
             and counted FLOPs, and its roofline row (predictions); the
             dry runs of the reduced cells its repair covers (micro-batches
             with fewer rows than the (pod, data) ranks, RWKV6's decode
             state, RWKV6 training over (pod, data), whisper's prefill,
             the VLM pipeline, qwen3-moe-235b's training and
             jamba-1.5-large's batch-1 decode with the experts on their
             FSDP blocks) on fake CUDA tensors, each kernel of the
             cell charged, beside the same trace on fake CPU tensors

Every device time a run prints (``device_ms``) comes from CUDA events
around replays of a CUDA graph of the calls, or, for a function a graph
cannot capture (host syncs), from the profiler's kernel events with a
check for lost events; ``device_ms: ...`` before the kernels line counts
both and the sessions run again.

A line ``{"sim": ..., "card": ...}`` carries phase 4d's walls, device busy
times and peak memory; ``{"robust": ..., "card": ...}`` phase 4e's walls,
gaps, picks and K1 launches; ``{"train": ..., "card": ...}`` phases 17
and 18's gaps, losses, step times, memory, idle shares and launches;
``{"dense": ..., "card": ...}`` phases 19-21's errors, windowed times,
gaps, serving numbers and launches; ``{"moe": ..., "card": ...}`` phases
22-24's errors, times, routing counts, gaps, serving numbers and launches;
``{"hybrid_audio": ..., "card": ...}`` phases 25-27's; ``{"spmd": ...,
"card": ...}`` phase 28's; ``{"tp": ..., "card": ...}`` phase 29's.
The next-to-last line is a JSON object with the kernels' measurements;
the last is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package ``repro``.

    python3 chip_smoke.py --time-k1 [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --time-k3 [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --grads
    python3 chip_smoke.py --dense
    python3 chip_smoke.py --moe
    python3 chip_smoke.py --hybrid-audio
    python3 chip_smoke.py --spmd
    python3 chip_smoke.py --tp

only time K1 (its six phase-3 shapes, both modes, by CUDA events, the
profiler's device time and the host's time per call, and the planner's wall
on the card; for a kernel with routes also the windows and bottleneck calls
at every cluster size and the all-thresholds sweeps and a 96-server graph
at every tile) or K3
(phase 7's timings), with this checkout's ``repro_torch`` or another's, to
compare two versions of a kernel in one run; ``--grads`` builds and checks
K2' and K3' alone (phases 14-16); ``--dense`` builds K2 and K2' and runs
phases 19-21 alone, ``--moe`` phases 22-24, ``--hybrid-audio`` phases
25-27, ``--spmd`` builds every kernel and runs phase 28, ``--tp`` builds
K2 and K2' and runs phase 29.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))



def _package_file(relpath: str):
    """A module of this checkout's ``src/repro_torch`` that imports nothing
    of the package, loaded by its path: importing ``repro_torch`` here
    would fix which checkout's package the phases run before ``--src`` can
    choose it."""
    import importlib.util
    name = "_smoke_" + relpath.replace("/", "_").removesuffix(".py")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                        "repro_torch", relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    module = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_NETWORK = _package_file("core/network.py")
#: H100 SXM peaks (NVIDIA data sheet; dense, no sparsity, 700 W): float64
#: and float32 outside the tensor cores, bfloat16 on the tensor cores; the
#: HBM rate and the bfloat16 peak are the planner's (core/network.py)
HBM_BYTES_PER_S = _NETWORK.H100_HBM_BW
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12,
            torch.bfloat16: _NETWORK.H100_PEAK_FLOPS}
#: TF32 on the tensor cores, where K3' does its products
PEAK_TF32 = 495e12
F32_RTOL = 1e-4
LOSS_RTOL = 1e-4
#: K3 against its plain versions: the reference's WKV tolerances
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: the reference's WKV_SWEEP (tests/test_kernels.py), two chunks the
#: model's selection loop can produce for other prompt lengths, and the
#: served layer shape: (B, S, H, hd, chunk)
WKV_SHAPES = [(1, 64, 1, 16, 16), (2, 128, 2, 32, 32), (1, 256, 4, 64, 64),
              (2, 96, 2, 8, 32), (1, 128, 2, 64, 128), (1, 62, 2, 64, 31),
              (1, 9, 2, 64, 1)]
SERVED_WKV = (1, 512, 32, 64, 256)
#: an odd-length prompt: the model's selection loop gives it chunk 1
ODD_WKV = (1, 511, 32, 64, 1)
#: K3's 64-token tiles across chunks of 1, 2 and 31, the last tile ragged
WKV_CROSSING = [(1, 511, 2, 64, 1), (1, 130, 2, 64, 2), (1, 124, 2, 64, 31)]
#: log w about -4.5 a token (log(-log w) centred at 1.5): the chunked form's
#: k exp(-L) overflows float32 within a 64-token chunk
STRONG_DECAY = 1.5
STRONG_WKV = [(1, 256, 2, 64, 64), SERVED_WKV]
MODEL_REL_TOL = 1e-3          # phases 8, 12: cuda vs CPU, f32, TF32 off
DECODE_TOL = 2e-3             # the reference's prefill-vs-decode contract
#: K2 against its plain version: the reference's flash tolerances
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the reference's FLASH_SWEEP (tests/test_kernels.py) and a ragged shape
#: at hd 16, the served layer shape of qwen3-0.6b and a 2048-token prompt,
#: which the reference's transformer computes with chunked_attention:
#: (B, S, T, H, KV, hd, causal)
FLASH_SHAPES = [(1, 64, 64, 2, 2, 32, True), (2, 128, 128, 4, 2, 64, True),
                (1, 200, 200, 4, 4, 64, True),
                (2, 128, 256, 8, 2, 128, False),
                (1, 96, 96, 8, 1, 64, True), (2, 77, 77, 4, 1, 16, True)]
SERVED_FLASH = (1, 512, 512, 16, 8, 128, True)
LONG_FLASH = (1, 2048, 2048, 16, 8, 128, True)


#: each phase of the full run: its label -> the perf_counter at its start
PHASE_STARTS = {}


def mark_phase(label):
    PHASE_STARTS[label] = time.perf_counter()


def phase_walls() -> dict:
    """Seconds from each marked phase's start to the next's (the last's
    to now)."""
    labels = list(PHASE_STARTS)
    ends = [PHASE_STARTS[k] for k in labels[1:]] + [time.perf_counter()]
    return {k: round(e - PHASE_STARTS[k], 1) for k, e in zip(labels, ends)}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, min_seconds: float = 0.2) -> float:
    """Mean device time of ``fn`` over repeated launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(1000, int(min_seconds / max(time.perf_counter() - t0,
                                                   1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: idle seconds before and after the launches of a profiled session
PROFILE_PAD_S = 0.02
#: profiled sessions per measurement before a loss of events fails the run
#: (with ``reps`` 1, sessions until two of them agree)
PROFILE_TRIES = 4
PROFILE_TRIES_ONE_CALL = 6
#: least total replay time of a CUDA-graph timing
GRAPH_MIN_MS = 20.0
#: how ``device_ms`` measured: calls, those timed by CUDA-graph replay and
#: by the profiler (functions a graph cannot capture: host syncs, a
#: backward whose forward ran outside the capture), profiler sessions,
#: sessions that lost events or saw no device time and were run again,
#: and sessions still short after their retries (each fails its phase, so
#: a finished run prints 0); ``uncapturable`` names the profiled callers
PROFILER_STATS = {"calls": 0, "graph_timed": 0, "profiler_timed": 0,
                  "sessions": 0, "lossy_sessions": 0, "empty_sessions": 0,
                  "unresolved": 0, "largest_session": 0, "probe_lost": 0,
                  "uncapturable": {}}


def _caller() -> str:
    """``function:line`` of the chip_smoke.py code that asked for a time."""
    import inspect
    for fr in inspect.stack()[2:]:
        if fr.function not in ("device_ms", "<lambda>"):
            return f"{fr.function}:{fr.lineno}"
    return "?"


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time per call of ``fn``: ``reps`` calls captured in one
    CUDA graph on a stream of its own, the graph replayed between two CUDA
    events (for at least ``GRAPH_MIN_MS``).  The kernels' own times plus
    the gaps between graph nodes; no host dispatch, no profiler.  Raises
    when ``fn`` cannot be captured."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    n = max(3, min(200, math.ceil(GRAPH_MIN_MS
                                  / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del g
    return ms


def _kernel_name(name: str) -> str:
    """A kernel's base name; a copy or memset keeps its own."""
    m = re.search(r"\w+(?=<|\(|$)", name)
    return m.group(0) if m else name


#: launches of the spin kernel that open a profiled session: at first,
#: and at most (the number grows with the profiler's loss, see ``profiled``)
PROBE_LAUNCHES = 64
PROBE_LAUNCHES_MAX = 16384
PROBE_KERNEL = "spin_kernel"
#: the spin launches that open the next profiled session
PROBE = {"launches": PROBE_LAUNCHES}


def _probe():
    """``PROBE["launches"]`` launches of ``torch.cuda._sleep``'s spin kernel
    (a name no measured function launches), then a sync."""
    for _ in range(PROBE["launches"]):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _probe_loss(recorded: int) -> bool:
    """Note a session's loss of opening spin launches (``recorded`` of
    ``PROBE["launches"]`` seen) and keep the next sessions' opening ahead
    of it: the loss grows over a long process (53-63 of 64 lost late in
    full runs, PR 34 chip calls), so past half the opening, the opening is
    made four times longer, up to ``PROBE_LAUNCHES_MAX``.  True when the
    opening grew after losing every spin launch: that session says
    nothing and is run again without using up a try."""
    launches = PROBE["launches"]
    lost = launches - recorded
    PROFILER_STATS["probe_lost"] = max(PROFILER_STATS["probe_lost"], lost)
    if 2 * lost <= launches or launches >= PROBE_LAUNCHES_MAX:
        return False
    PROBE["launches"] = min(4 * launches, PROBE_LAUNCHES_MAX)
    log(f"profiler: {lost} of {launches} opening probe launches lost; "
        f"sessions now open with {PROBE['launches']}")
    return recorded == 0


def profiled(fn, reps: int = 50, host_events: bool = True) -> tuple:
    """(device ms per call, {kernel: ms per call}, {kernel: events per
    call}) of ``fn`` from the CUDA kernel events of ``torch.profiler`` over
    ``reps`` calls.  In a long process the profiler drops the first few
    records of every session (a debt that grows after each session of
    ~10^5 kernels: PR 29 chip calls 8-12), so each session opens with
    ``PROBE_LAUNCHES`` spin kernels that take the loss; a session is
    trusted when at least one of them was recorded (the loss ended inside
    them) and, over ``fn``'s own kernels, every kernel ran a whole number
    of times a call (``fn`` launches each of its kernels a fixed number of
    times a call) or, with ``reps`` 1, where that says nothing, two
    sessions count the same events at the largest count seen (up to
    ``PROFILE_TRIES_ONE_CALL`` sessions).  A session that saw no device
    time or failed a check is run again without host events
    (``host_events=False`` from the start traces the device alone: a run
    of ~10^5 launches whose host events would take the profiler longer to
    collect than the run); when no session passes, the measurement raises.
    Each session is padded with idle time on both sides."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    tries = PROFILE_TRIES_ONE_CALL if reps == 1 else PROFILE_TRIES
    attempt = -1
    while attempt + 1 < tries:
        attempt += 1
        PROFILER_STATS["sessions"] += 1
        with profile(activities=[ProfilerActivity.CUDA]
                     + [ProfilerActivity.CPU] * host_events) as prof:
            time.sleep(PROFILE_PAD_S)
            _probe()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        probes = sum(_kernel_name(e.name) == PROBE_KERNEL for e in events)
        kernels = [e for e in events
                   if _kernel_name(e.name) != PROBE_KERNEL]
        PROFILER_STATS["largest_session"] = max(
            PROFILER_STATS["largest_session"], len(kernels))
        opening = PROBE["launches"]
        if _probe_loss(probes):
            PROFILER_STATS["lossy_sessions"] += 1
            attempt -= 1
            continue
        us = sum(e.time_range.elapsed_us() for e in kernels)
        split, counts = {}, {}
        for e in kernels:
            name = _kernel_name(e.name)
            split[name] = split.get(name, 0.0) \
                + e.time_range.elapsed_us() / reps / 1e3
            counts[name] = counts.get(name, 0) + 1
        if us <= 0:
            PROFILER_STATS["empty_sessions"] += 1
            log(f"profiler session {attempt + 1} saw no device time; run "
                "again")
            host_events = False
            continue
        if probes == 0:
            PROFILER_STATS["lossy_sessions"] += 1
            log(f"profiler session {attempt + 1} lost all {opening} "
                "probe launches; run again")
            continue
        result = (us / reps / 1e3, split,
                  {n: c / reps for n, c in counts.items()})
        if reps == 1:
            total = sum(counts.values())
            most = max([total] + [sum(c.values()) for c, _ in seen])
            twin = next((r for c, r in seen if c == counts), None)
            if twin is not None and total == most:
                return twin
            if seen:
                PROFILER_STATS["lossy_sessions"] += 1
                log(f"profiler session {attempt + 1}: {total} kernel "
                    f"events, the earlier ones "
                    f"{[sum(c.values()) for c, _ in seen]}; run again")
            seen.append((counts, result))
            continue
        short = {n: c for n, c in counts.items() if c % reps}
        if short:
            PROFILER_STATS["lossy_sessions"] += 1
            log(f"profiler session {attempt + 1} lost events ({short} over "
                f"{reps} calls; {probes} of {opening} probes); run "
                "again without host events")
            host_events = False
            continue
        return result
    PROFILER_STATS["unresolved"] += 1
    raise RuntimeError(f"the profiler lost kernel events in every one of "
                       f"{tries} sessions ({_caller()})")


def device_ms(fn, reps: int = 50, host_events: bool = True,
              split: dict = None, counts: dict = None,
              graph: bool = True) -> float:
    """Mean device time per call of the kernels ``fn`` launches, without
    the gaps in which the device waits for the host to dispatch the next
    launch (``cuda_ms`` has those): by CUDA events around replays of a
    CUDA graph holding ``reps`` calls (``graph_ms``), or, where ``fn``
    cannot be captured (``graph=False``, or a capture that raises: logged
    and named in ``PROFILER_STATS["uncapturable"]``), by the profiler's
    kernel events summed (``profiled``, checked for lost events).  A
    ``split`` dict receives each kernel's ms per call and a ``counts``
    dict its events per call, {kernel name: value}, from a checked
    profiler session.  The profiler lost events in long runs (a third of
    K2' kernels' in one, 42 of 50 launches in another), which read as a
    shorter time; the graph route does not ask it."""
    PROFILER_STATS["calls"] += 1
    ms = None
    if graph:
        try:
            ms = graph_ms(fn, reps)
            PROFILER_STATS["graph_timed"] += 1
        except RuntimeError as e:
            where = _caller()
            PROFILER_STATS["uncapturable"][where] = \
                str(e).strip().splitlines()[0][:160]
            log(f"device_ms: {where} cannot be captured in a CUDA graph "
                f"({PROFILER_STATS['uncapturable'][where]}); timed by the "
                "profiler")
            torch.cuda.synchronize()
    if ms is None or split is not None or counts is not None:
        prof_ms, prof_split, prof_counts = profiled(fn, reps, host_events)
        if ms is None:
            ms = prof_ms
            PROFILER_STATS["profiler_timed"] += 1
            if not graph:
                PROFILER_STATS["uncapturable"].setdefault(
                    _caller(), "host syncs (graph=False)")
        for target, source in ((split, prof_split), (counts, prof_counts)):
            if target is not None:
                for name, v in source.items():
                    target[name] = target.get(name, 0.0) + v
    return ms


def yardstick_turns(fn, turns: int = 2) -> dict:
    """``fn`` timed both ways in turns (graph, profiler, profiler,
    graph...): CUDA-graph replay counts the gaps between the graph's
    kernels, the profiler's kernel sum does not."""
    out = {"graph_ms": [], "profiler_ms": []}
    for i in range(turns):
        for way in (("graph", "profiler") if i % 2 == 0
                    else ("profiler", "graph")):
            out[f"{way}_ms"].append(graph_ms(fn) if way == "graph"
                                    else profiled(fn)[0])
    return out


def profiler_line() -> str:
    st = PROFILER_STATS
    return (f"device_ms: {st['calls']} calls, {st['graph_timed']} timed by "
            f"CUDA-graph replay, {st['profiler_timed']} by the profiler; "
            f"{st['sessions']} profiler sessions, {st['lossy_sessions']} "
            f"lost events and {st['empty_sessions']} saw no device time "
            f"(each run again), {st['unresolved']} unresolved, the largest "
            f"{st['largest_session']} kernel events, at most "
            f"{st['probe_lost']} opening probe launches lost (sessions "
            f"opened with {PROBE_LAUNCHES} to {PROBE['launches']}); "
            f"profiled because not capturable: {st['uncapturable']}")


@contextlib.contextmanager
def recording_sweeps(shortest_path):
    """Record every K1 call Algorithm 1 makes (its actual inputs, mode and
    graph index)."""
    calls = []
    real = shortest_path.sweep_minplus

    def record(*args, **kw):
        calls.append((args, kw.get("mode", "sum"), kw.get("graph")))
        return real(*args, **kw)

    shortest_path.sweep_minplus = record
    try:
        yield calls
    finally:
        shortest_path.sweep_minplus = real


def layers_run(args, mode) -> torch.Tensor:
    """Layers K1 runs per threshold: it stops after the first layer whose
    dist is all-inf (work that depends on the data, counted as it is)."""
    Cc, Bc, Ss, Bs, sc, sb, K, ts = args
    inf = torch.tensor(math.inf, dtype=Cc.dtype, device=Cc.device)
    op = torch.add if mode == "sum" else torch.maximum
    t4 = ts[:, None, None, None]
    Vc = torch.where(Bc <= t4, Cc if mode == "sum" else Bc, inf)
    Vs = torch.where(Bs <= t4, Ss if mode == "sum" else Bs, inf)
    dist = torch.full((ts.shape[0],) + tuple(Cc.shape[:2]), math.inf,
                      dtype=Cc.dtype, device=Cc.device)
    dist[:, 0] = torch.where(sb <= ts[:, None], sc if mode == "sum" else sb,
                             inf)
    alive = torch.ones(ts.shape[0], dtype=torch.bool, device=Cc.device)
    count = torch.zeros(ts.shape[0], dtype=torch.long, device=Cc.device)
    for _ in range(2, K + 1):
        count += alive
        dist = op(op(dist[..., None], Vc).amin(1)[..., None], Vs).amin(1)
        alive &= torch.isfinite(dist).flatten(1).any(1)
    return count


def bound_seconds(args, mode, dtype) -> tuple:
    """(byte_s, op_s): each input the mode reads read once and the output
    written once over HBM bandwidth (the sum mode reads costs and betas,
    the max mode betas only); the operations these inputs need (a
    compare-select per edge per threshold to fold the mask, then an (+ or
    max) and a min per candidate per layer run) over the dtype's
    non-tensor-core peak."""
    Cc, Bc, Ss, Bs, sc, sb, K, ts = args
    esize = torch.tensor([], dtype=dtype).element_size()
    reads = (Cc.numel() + Ss.numel() + sc.numel()) * (mode == "sum")
    elems = reads + Bc.numel() + Bs.numel() + sb.numel() + 2 * ts.numel()
    cands = Cc.numel() + Ss.numel()
    layers = int(layers_run(args, mode).sum())
    ops = ts.numel() * cands + 2 * cands * layers
    return elems * esize / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]


def bound_ms(args, mode, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of ``bound_seconds``' two times."""
    byte_s, op_s = bound_seconds(args, mode, dtype)
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def k1_route(minplus, args) -> dict:
    """The route K1's wrapper picks for these inputs (``launch_plan``):
    {"launch_route": "cluster", "cluster": C} or {"launch_route": "tiled",
    "tile": T}; "one block per threshold" for a kernel without routes."""
    plan_fn = getattr(minplus.kernel, "launch_plan", None)
    if plan_fn is None:
        return {"launch_route": "one block per threshold"}
    Cc, ts = args[0], args[7]
    plan = plan_fn(ts.numel(), Cc.shape[0], Cc.shape[1], Cc.element_size(),
                   torch.cuda.get_device_properties(0).multi_processor_count)
    return ({"launch_route": "cluster", "cluster": plan.cluster}
            if plan.route == "cluster" else {"launch_route": "tiled",
                                             "tile": plan.tile})


def host_ms(fn, reps: int = 200) -> float:
    """Mean host time of one call of ``fn`` that only enqueues work: the
    wrapper's Python and the launch, without waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def time_k1_shape(args, mode, minplus) -> dict:
    """K1 at these inputs: CUDA events of back-to-back calls (``ms``), the
    profiler's device time per call (``device_ms``), the host's time to
    make one call (``host_ms``), the route."""
    call = lambda: minplus.sweep_minplus(*args, mode=mode)
    return {"ms": cuda_ms(call), "device_ms": device_ms(call),
            "host_ms": host_ms(call), **k1_route(minplus, args)}


def check_kernel(label, cpu_args, minplus, timed=True):
    """Hold K1 against sweep_plain on the card, both modes, both dtypes:
    float64 bitwise, float32 within F32_RTOL with the same finite entries.
    With ``timed``, returns the float64 sum-mode measurements at these
    inputs, and the max mode's under "max_mode"."""
    out = {}
    for mode in ("sum", "max"):
        f64 = [a.cuda() if torch.is_tensor(a) else a for a in cpu_args]
        got = minplus.sweep_minplus(*f64, mode=mode)
        want = minplus.sweep_plain(*f64, mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K1 f64 {label}/{mode}: {bad} of "
                                 f"{got.numel()} values differ from plain")
        want_cpu = minplus.sweep_plain(*cpu_args, mode=mode)
        if not torch.equal(got.cpu(), want_cpu):
            raise AssertionError(f"K1 f64 {label}/{mode} differs from the "
                                 "plain version on the CPU")
        f32 = [a.float() if torch.is_tensor(a) else a for a in f64]
        got32 = minplus.sweep_minplus(*f32, mode=mode).double()
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got32)):
            raise AssertionError(f"K1 f32 {label}/{mode}: finite masks differ")
        rel = ((got32[fin] - want[fin]).abs()
               / want[fin].abs().clamp_min(1e-300))
        rel_max = float(rel.max()) if rel.numel() else 0.0
        if rel_max > F32_RTOL:
            raise AssertionError(f"K1 f32 {label}/{mode}: rel err {rel_max}")
        N, I1 = f64[0].shape[:2]
        head = (f"K1 {label} mode={mode} N={N} I+1={I1} K={f64[6]} "
                f"S={f64[7].numel()} {k1_route(minplus, f64)} "
                f"(f32 {k1_route(minplus, f32)}): f64 bitwise equal, f32 max "
                f"rel err {rel_max:.3e}, {int(fin.sum())} finite")
        if not timed:
            log(head)
            continue
        t = time_k1_shape(f64, mode, minplus)
        t["plain_ms"] = cuda_ms(lambda: minplus.sweep_plain(*f64, mode=mode))
        t["bound_ms"], t["bound_by"] = bound_ms(f64, mode, torch.float64)
        log(f"{head}; kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} "
            f"ms), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
        if mode == "sum":
            out.update(S=f64[7].numel(), N=N, I1=I1, K=f64[6], **t,
                       max_abs_err=float((got - want).abs().nan_to_num()
                                         .max()))
        else:
            out["max_mode"] = t
    return out


def graph_groups(graph) -> dict:
    """{graph index: positions of its thresholds} of a graph-axis call."""
    groups: dict = {}
    for s, g in enumerate(graph):
        groups.setdefault(int(g), []).append(s)
    return groups


def graph_route(minplus, args, graph) -> dict:
    """The route K1's wrapper picks for a launch over stacked graphs
    (``launch_plan`` with the thresholds per graph)."""
    Cc, ts = args[0], args[7]
    counts = tuple(len(v) for _, v in sorted(graph_groups(graph).items()))
    plan = minplus.kernel.launch_plan(
        ts.numel(), Cc.shape[1], Cc.shape[2], Cc.element_size(),
        torch.cuda.get_device_properties(0).multi_processor_count, counts)
    return ({"launch_route": "cluster", "cluster": plan.cluster}
            if plan.route == "cluster" else {"launch_route": "tiled",
                                             "tile": plan.tile})


def per_graph(args, graph):
    """The same work as one one-graph call per graph (the launches the
    graph axis replaces): [(one graph's inputs with its thresholds)]."""
    Cc, Bc, Ss, Bs, sc, sb, K, ts = args
    out = []
    for g, pos in graph_groups(graph).items():
        idx = torch.tensor(pos, device=ts.device)
        out.append((Cc[g], Bc[g], Ss[g], Bs[g], sc[g], sb[g], K, ts[idx]))
    return out


def graph_bound_ms(args, mode, graph) -> tuple:
    """(bound_ms, bound_by) of a graph-axis launch (float64): each graph it
    names read once (the stacked graphs it does not name need no read)
    with its thresholds, their int32 graph indices read once, and the work
    of each threshold on its own graph (``bound_seconds``)."""
    parts = [bound_seconds(one, mode, torch.float64)
             for one in per_graph(args, graph)]
    byte_s = sum(b for b, _ in parts) + 4 * len(graph) / HBM_BYTES_PER_S
    op_s = sum(o for _, o in parts)
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def check_graph_axis(label, cpu_args, graph, minplus,
                     time_f32=False) -> dict:
    """Hold K1's graph axis against sweep_plain on the card, both modes,
    both dtypes (float64 bitwise, also against one one-graph K1 call per
    graph; float32 within F32_RTOL with the same finite entries); time it
    in float64 by the profiler's device time and CUDA events beside the
    bound, the plain version and the per-graph calls; with ``time_f32``
    also the float32 launch's device time."""
    out = {}
    for mode in ("sum", "max"):
        f64 = [a.cuda() if torch.is_tensor(a) else a for a in cpu_args]
        call = lambda: minplus.sweep_minplus(*f64, mode=mode, graph=graph)
        got = call()
        want = minplus.sweep_plain(*f64, mode=mode, graph=graph)
        loop = per_graph(f64, graph)
        parts = [minplus.sweep_minplus(*one, mode=mode) for one in loop]
        torch.cuda.synchronize()
        one_by_one = torch.empty_like(got)
        for pos, part in zip(graph_groups(graph).values(), parts):
            one_by_one[torch.tensor(pos, device="cuda")] = part
        for name, ref in (("plain", want), ("per-graph calls", one_by_one)):
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"K1 graph axis f64 {label}/{mode}: "
                                     f"{bad} of {got.numel()} values differ "
                                     f"from {name}")
        if not torch.equal(got.cpu(), minplus.sweep_plain(
                *cpu_args, mode=mode, graph=graph)):
            raise AssertionError(f"K1 graph axis f64 {label}/{mode} differs "
                                 "from the plain version on the CPU")
        f32 = [a.float() if torch.is_tensor(a) else a for a in f64]
        got32 = minplus.sweep_minplus(*f32, mode=mode, graph=graph).double()
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got32)):
            raise AssertionError(f"K1 graph axis f32 {label}/{mode}: finite "
                                 "masks differ")
        rel = ((got32[fin] - want[fin]).abs()
               / want[fin].abs().clamp_min(1e-300))
        rel_max = float(rel.max()) if rel.numel() else 0.0
        if rel_max > F32_RTOL:
            raise AssertionError(f"K1 graph axis f32 {label}/{mode}: rel err "
                                 f"{rel_max}")
        if torch.equal(got32, want) and bool(fin.any()):
            raise AssertionError(f"K1 graph axis f32 {label}/{mode}: the "
                                 "float32 launch returned the float64 values")
        loop_call = lambda: [minplus.sweep_minplus(*one, mode=mode)
                             for one in loop]
        t = {"G": f64[0].shape[0], "graphs": len(loop), "S": len(graph),
             **graph_route(minplus, f64, graph),
             "device_ms": device_ms(call), "ms": cuda_ms(call),
             "host_ms": host_ms(call),
             "plain_ms": cuda_ms(lambda: minplus.sweep_plain(
                 *f64, mode=mode, graph=graph)),
             "per_graph_launches": len(loop),
             "per_graph_device_ms": device_ms(loop_call),
             "per_graph_ms": cuda_ms(loop_call),
             "f32_max_rel_err": rel_max, "finite": int(fin.sum())}
        t["bound_ms"], t["bound_by"] = graph_bound_ms(f64, mode, graph)
        if time_f32:
            t["device_ms_f32"] = device_ms(lambda: minplus.sweep_minplus(
                *f32, mode=mode, graph=graph))
        if t["launch_route"] == "tiled":
            t["device_ms_by_tile"] = tile_sweep(minplus, f64, mode, graph,
                                                got)
        log(f"K1 graph axis {label} mode={mode} G={t['G']} (graphs named "
            f"{t['graphs']}) S={t['S']} N={f64[0].shape[1]} "
            f"I+1={f64[0].shape[2]} {graph_route(minplus, f64, graph)}: f64 "
            f"bitwise equal to plain and to {len(loop)} one-graph calls, f32 "
            f"max rel err {rel_max:.3e}, {t['finite']} finite; one launch: "
            f"device {t['device_ms']:.4f} ms, events {t['ms']:.4f} ms, host "
            f"{t['host_ms']:.4f} ms; {len(loop)} one-graph launches: device "
            f"{t['per_graph_device_ms']:.4f} ms, events "
            f"{t['per_graph_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']})"
            + (f"; device ms by tile {t['device_ms_by_tile']}"
               if "device_ms_by_tile" in t else "")
            + (f"; f32 launch device {t['device_ms_f32']:.4f} ms"
               if time_f32 else ""))
        out[mode] = t
    return out


def tile_sweep(minplus, args, mode, graph, want) -> dict:
    """A tiled graph-axis launch at every tile T that fits (padded by
    ``tile_slots`` as the wrapper pads): {T: device ms}; each result must
    equal ``want`` bit for bit (float64)."""
    k = minplus.kernel
    Cc = args[0]
    out = {}
    for T in k.TILES:
        if not k.tile_fits(Cc.shape[1], Cc.shape[2], T, 8):
            continue
        slots, slot_graph = k.tile_slots(graph, T)
        slots = torch.tensor(slots, device="cuda")
        ts_pad = torch.full((len(slot_graph),), -math.inf,
                            dtype=torch.float64, device="cuda")
        ts_pad[slots] = args[7]
        res = torch.empty_like(ts_pad)
        g = torch.tensor(slot_graph, dtype=torch.int32, device="cuda")
        plan = k.LaunchPlan("tiled", 0, T)
        run = lambda: k.launch(plan, *args[:7], ts_pad, res, mode, graph=g)
        run()
        torch.cuda.synchronize()
        if not torch.equal(res[slots], want):
            raise AssertionError(f"K1 graph axis at tile {T} differs")
        out[T] = device_ms(run)
    return out


def ragged_graph_window(args, sizes, seed=0):
    """``sizes[g]`` of graph g's candidate thresholds (its distinct finite
    betas, spread evenly) on stacked graphs, in no order: (inputs,
    graph index per threshold)."""
    Cc, Bc, Ss, Bs, sc, sb, K = args[:7]
    graph, ts = [], []
    for g, n in enumerate(sizes):
        betas = torch.cat([Bc[g].flatten(), Bs[g].flatten(), sb[g]])
        betas = torch.unique(betas[torch.isfinite(betas)])
        pick = torch.linspace(0, betas.numel() - 1, n).round().long()
        graph += [g] * n
        ts.append(betas[pick])
    order = torch.randperm(len(graph),
                           generator=torch.Generator().manual_seed(seed))
    return ((Cc, Bc, Ss, Bs, sc, sb, K, torch.cat(ts)[order]),
            [graph[q] for q in order.tolist()])


def largest_window(calls):
    """The sum-mode call with the most thresholds (the phase-3 window)."""
    sums = [args for args, mode, graph in calls
            if mode == "sum" and graph is None]
    return max(sums, key=lambda a: a[7].numel())


def bottleneck_call(calls):
    """The first max-mode call (``min_bottleneck`` at t = inf: it runs
    every layer)."""
    return next(args for args, mode, graph in calls
                if mode == "max" and graph is None)


def big_graph(core) -> tuple:
    """K1's inputs past the fleet: 96 servers, a graph no 16-block cluster
    holds in float64 (the tiled route), over 256 of its thresholds."""
    planner = core.Planner(core.random_profile(np.random.default_rng(2), 30),
                           core.make_edge_network(num_servers=96,
                                                  num_clients=4, seed=2,
                                                  kappa=1 / 32.0,
                                                  mem_range=(4 * 2**30,
                                                             32 * 2**30)),
                           device="cpu")
    return all_thresholds(planner, 16, max_s=256)


def all_thresholds(planner, b, max_s=1024):
    """K1's inputs over every candidate threshold of the graph at ``b`` —
    the widest window Algorithm 1 could sweep — thinned evenly to at most
    ``max_s`` thresholds."""
    dp = planner._dp(b, planner.default_K(None))
    ts = dp.all_betas()
    ts = ts[::max(1, -(-ts.numel() // max_s))]
    return (*dp._kernel_args(), ts)


def k1_shapes(core, shortest_path) -> tuple:
    """K1's inputs at its six timed shapes, recorded from the planner on
    the CPU: the quickstart's window (the largest sum-mode call of
    ours(VGG-16, 6 servers + 4 clients, B=512, b0=20)), its bottleneck
    call (max mode at t = inf) and all its thresholds, and the same three
    of the fleet (random_profile(30), 48 servers, b=16, B=128).  Returns
    ({label: inputs}, {name: what the later checks reuse})."""
    profile = core.vgg16_profile(work_units="bytes")
    net = core.make_edge_network(num_servers=6, num_clients=4, seed=1,
                                 kappa=1 / 32.0)
    t0 = time.perf_counter()
    with recording_sweeps(shortest_path) as calls:
        plan_cpu = core.ours(profile, net, B=512, b0=20, device="cpu")
    cpu_plan_s = time.perf_counter() - t0
    fleet_prof = core.random_profile(np.random.default_rng(1), 30)
    fleet_net = core.make_edge_network(num_servers=48, num_clients=4, seed=1,
                                       kappa=1 / 32.0,
                                       mem_range=(4 * 2**30, 32 * 2**30))
    fleet_planner = core.Planner(fleet_prof, fleet_net, device="cpu")
    with recording_sweeps(shortest_path) as fcalls:
        fleet_cpu = fleet_planner.solve(16, 128)
    shapes = {
        "quickstart window": largest_window(calls),
        "quickstart bottleneck": bottleneck_call(calls),
        "quickstart all-thresholds": all_thresholds(
            core.Planner(profile, net, device="cpu"), plan_cpu.b),
        "fleet window": largest_window(fcalls),
        "fleet bottleneck": bottleneck_call(fcalls),
        "fleet all-thresholds": all_thresholds(fleet_planner, 16)}
    return shapes, dict(profile=profile, net=net, plan_cpu=plan_cpu,
                        cpu_plan_s=cpu_plan_s, fleet_prof=fleet_prof,
                        fleet_net=fleet_net, fleet_planner=fleet_planner,
                        fleet_cpu=fleet_cpu)


def time_k1(minplus, core, shapes) -> dict:
    """K1 alone at the six shapes in both modes (float64): CUDA events, the
    profiler's device time and the host's time per call, with the route
    that ran; the planner's wall time of the quickstart's ``ours`` on the
    card.  For a kernel with routes, also the windows and bottleneck calls
    at every cluster size the kernel takes, and the all-thresholds sweeps
    and the 96-server graph (at 1 and 256 thresholds) at every tile."""
    out = {}
    for label, cpu_args in shapes.items():
        f64 = [a.cuda() if torch.is_tensor(a) else a for a in cpu_args]
        out[label] = {mode: time_k1_shape(f64, mode, minplus)
                      for mode in ("sum", "max")}
        log(f"K1 {label} S={f64[7].numel()}: " + "; ".join(
            f"{mode} {t['launch_route']} "
            f"{t.get('cluster', t.get('tile', ''))}: "
            f"device {t['device_ms']:.4f} ms, events {t['ms']:.4f} ms, host "
            f"{t['host_ms']:.4f} ms" for mode, t in out[label].items()))
    profile = core.vgg16_profile(work_units="bytes")
    net = core.make_edge_network(num_servers=6, num_clients=4, seed=1,
                                 kappa=1 / 32.0)
    walls = []
    for _ in range(6):                    # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core.ours(profile, net, B=512, b0=20, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["planner_wall_s"] = walls[1:]
    log(f"planner wall (ours, quickstart, cuda): {walls[1:]} s")
    k = minplus.kernel
    if not hasattr(k, "launch_plan"):
        return out
    big = big_graph(core)
    sweeps = {label: shapes[label] for label in (
        "quickstart window", "quickstart bottleneck", "fleet window",
        "fleet bottleneck", "quickstart all-thresholds",
        "fleet all-thresholds")}
    sweeps["96-server window"] = (*big[:7], big[7][-1:])
    sweeps["96-server all-thresholds"] = big
    for label, cpu_args in sweeps.items():
        f64 = [a.cuda() if torch.is_tensor(a) else a for a in cpu_args]
        N, I1 = f64[0].shape[:2]
        route = "tiled" if "thresholds" in label or "96" in label \
            else "cluster"
        plans = ([k.LaunchPlan("cluster", C, 0)
                  for C in range(1, k.MAX_CLUSTER + 1)
                  if k.cluster_fits(N, I1, C, 8)] if route == "cluster"
                 else [k.LaunchPlan("tiled", 0, T) for T in k.TILES
                       if k.tile_fits(N, I1, T, 8)])
        res = torch.empty(f64[7].numel(), dtype=torch.float64, device="cuda")
        sweep = {}
        for plan in plans:
            size = plan.cluster or plan.tile
            try:
                sweep[size] = {mode: device_ms(
                    lambda: k.launch(plan, *f64[:7], f64[7], res, mode))
                    for mode in ("sum", "max")}
            except RuntimeError as err:          # a refused cluster size
                sweep[size] = {"refused": str(err)}
        log(f"K1 {label} S={f64[7].numel()} device ms by {route} size: "
            + ", ".join(f"{c}: " + (f"sum {t['sum']:.4f} max {t['max']:.4f}"
                                    if "sum" in t else "refused")
                        for c, t in sweep.items()))
        out.setdefault(label, {})[f"device_ms_by_{route}_size"] = sweep
    return out


def wkv6_inputs(B, S, H, hd, dtype, seed=7, log_decay=-2.0):
    """K3's inputs at the reference's scales (tests/test_kernels.py),
    drawn on the card; ``log_decay`` centres log(-log w)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    r, k, v = (n(B, S, H, hd).mul_(0.5).to(dtype) for _ in range(3))
    logw = -torch.exp(n(B, S, H, hd) * 0.5 + log_decay)
    return r, k, v, logw, n(H, hd) * 0.3, n(B, H, hd, hd) * 0.2


def wkv6_bound_ms(B, S, H, hd, dtype) -> tuple:
    """(bound_ms, bound_by) of K3: each input read once and each output
    written once over HBM bandwidth, vs the float32 operations of the
    cheapest exact form of the same function over the non-tensor-core
    float32 peak.  Two forms are counted per head, and the smaller taken:
    the per-token recurrence (r S, the bonus, the state's decay and rank-1
    update: 5 hd^2 + 6 hd per token), and the chunked form at its best
    tile length n (q S and the state update, 2 n hd^2 each; q k'^T and its
    product with v below the diagonal, n (n-1) hd each; decays,
    exponentials and bonus, 8 n hd; the state's decay, hd^2)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    elems = B * S * H * hd
    byte_s = (elems * (3 * esize + 4 + 4) + H * hd * 4
              + 2 * B * H * hd * hd * 4) / HBM_BYTES_PER_S

    def chunked(n):
        return sum(4 * m * hd * hd + 2 * m * (m - 1) * hd + 8 * m * hd
                   + hd * hd
                   for m in [n] * (S // n) + ([S % n] if S % n else []))

    ops = min([S * (5 * hd * hd + 6 * hd)]
              + [chunked(n) for n in range(1, S + 1)])
    op_s = ops * B * H / PEAK_OPS[torch.float32]
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def check_wkv6(shape, dtype, wkv6_mod, log_decay=-2.0) -> float:
    """Hold K3 against wkv6_chunked_plain, the per-token wkv6_plain and
    wkv6_tiled_plain (the kernel's decomposition) on the card; returns the
    largest absolute error against the first of them.  Under a strong decay
    (``log_decay`` above 0) the chunked form overflows, so K3 is held to the
    other two and must be finite."""
    B, S, H, hd, chunk = shape
    args = wkv6_inputs(B, S, H, hd, dtype, log_decay=log_decay)
    y, s = wkv6_mod.wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    tol = WKV_TOL[dtype]
    plains = [("per-token plain", wkv6_mod.wkv6_plain(*args)),
              ("tiled plain", wkv6_mod.wkv6_tiled_plain(*args))]
    if log_decay <= 0:
        plains.insert(0, ("chunked plain",
                          wkv6_mod.wkv6_chunked_plain(*args, chunk)))
    if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
        raise AssertionError(f"K3 {shape} {dtype}: non-finite output")
    err = None
    for name, (y_p, s_p) in plains:
        for what, got, want in (("y", y, y_p), ("S_final", s, s_p)):
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                bad = float((got - want).abs().max())
                raise AssertionError(f"K3 {shape} {dtype} {what} vs {name}: "
                                     f"max abs err {bad} > {tol}")
        if err is None:
            err = max(float((y - y_p).abs().max()),
                      float((s - s_p).abs().max()))
    log(f"K3 (B,S,H,hd,chunk)={shape} {str(dtype)[6:]}"
        + (f" log w ~ -exp(N(0, 0.5) + {log_decay})" if log_decay > 0 else "")
        + f": y and S_final within {tol} of "
        + ", ".join(name for name, _ in plains)
        + f" (max abs err vs {plains[0][0]} {err:.3e})")
    return err


def time_k3(wkv6_mod) -> dict:
    """K3 at the served layer shape and at a 511-token prompt (chunk 1):
    CUDA events of back-to-back calls (``ms``) and the profiler's device
    time per call (``device_ms``) with bf16 and f32 r/k/v, and the plain
    chunked version by CUDA events."""
    out = {}
    for label, (B, S, H, hd, chunk) in (("served", SERVED_WKV),
                                        ("odd_prompt", ODD_WKV)):
        t = {}
        for tag, dtype in (("", torch.bfloat16), ("_f32", torch.float32)):
            args = wkv6_inputs(B, S, H, hd, dtype)
            t["ms" + tag] = cuda_ms(lambda: wkv6_mod.wkv6(*args, chunk=chunk))
            t["device_ms" + tag] = device_ms(
                lambda: wkv6_mod.wkv6(*args, chunk=chunk))
        args = wkv6_inputs(B, S, H, hd, torch.bfloat16)
        t["plain_ms"] = cuda_ms(
            lambda: wkv6_mod.wkv6_chunked_plain(*args, chunk))
        t["bound_ms"], t["bound_by"] = wkv6_bound_ms(B, S, H, hd,
                                                     torch.bfloat16)
        log(f"K3 {label} {(B, S, H, hd, chunk)}: bf16 r/k/v {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f} ms), f32 r/k/v {t['ms_f32']:.4f} "
            f"ms (device {t['device_ms_f32']:.4f} ms), plain chunked "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
        out[label] = t
    return out


def flash_inputs(B, S, T, H, KV, hd, dtype, seed=42):
    """K2's q, k, v (standard normal, as tests/test_kernels.py draws
    them), drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def mask_pairs(S, T, causal, window=0, k_offset=0) -> int:
    """The query-key pairs the mask keeps: all S T, or under the
    start-aligned causal mask kpos <= qpos, and under a window > 0 only
    kpos > qpos - window besides, the T keys at positions k_offset on."""
    total = 0
    for s in range(S):
        hi = min(s - k_offset, T - 1) if causal else T - 1
        lo = max(0, s - k_offset - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound_ms(B, S, T, H, KV, hd, causal, dtype, window=0,
                   k_offset=0) -> tuple:
    """(bound_ms, bound_by) of K2: q, k and v read once and the output
    written once over HBM bandwidth, vs the operations of the query-key
    pairs the mask keeps (2 hd for the score, 2 hd for its share of p v;
    under the causal mask only the pairs kpos <= qpos, and under a window
    only those inside it, not whole tiles) over the type's peak (bfloat16
    on the tensor cores, float32 outside them)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    byte_s = esize * (2 * B * S * H * hd + 2 * B * T * KV * hd) \
        / HBM_BYTES_PER_S
    pairs = mask_pairs(S, T, causal, window, k_offset)
    op_s = 4 * hd * pairs * B * H / PEAK_OPS[dtype]
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def check_flash(shape, dtype, flash_mod, window=0) -> float:
    """Hold K2 against attention_plain on the card (with a sliding
    ``window`` > 0, both take it); returns the largest absolute error."""
    B, S, T, H, KV, hd, causal = shape
    q, k, v = flash_inputs(B, S, T, H, KV, hd, dtype)
    out = flash_mod.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_mod.attention_plain(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    err = float((out.float() - want.float()).abs().max())
    if not (out.dtype == dtype and out.shape == q.shape
            and torch.isfinite(out).all()
            and torch.allclose(out.float(), want.float(), atol=tol,
                               rtol=tol)):
        raise AssertionError(f"K2 {shape} window {window} {dtype}: max abs "
                             f"err {err} > {tol}")
    log(f"K2 (B,S,T,H,KV,hd,causal)={shape}"
        + (f" window {window}" if window else "")
        + f" {str(dtype)[6:]}: within {tol} of the plain version (max abs "
        f"err {err:.3e})")
    return err


def sdpa(q, k, v, causal=True):
    """The library yardstick of K2: one scaled_dot_product_attention call
    on the (B, H, S, hd) views, GQA and the causal mask (when ``causal``)
    inside the call."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


#: True when ``--src`` imports another checkout's repro_torch (an older one
#: may lack a plain version added since: phase 16 then skips that check)
OTHER_SRC = False
#: K2' and K3' against their plain versions: atol = rtol, float32 and
#: bfloat16 inputs (the plain versions in float32 on the same inputs)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: qwen3-0.6b's training layer (B 4 per micro-batch, 512 tokens, 16 heads /
#: 8 kv heads of 128, causal) and rwkv6-1.6b's (4 x 512 tokens, 32 heads of
#: 64, chunk 256)
TRAIN_FLASH = (4, 512, 512, 16, 8, 128, True)
TRAIN_WKV = (4, 512, 32, 64, 256)
#: K3' at head sizes 1 and 2 (zero-padded to 4 around the kernel) and at
#: a strong decay (log w about -4.5) held to autograd through the
#: per-token recurrence, at lengths it steps through quickly
WKV_GRAD_PADDED = [(1, 64, 2, 1, 16), (2, 64, 2, 2, 32)]
WKV_GRAD_STRONG = [(1, 64, 2, 64, 64), (1, 130, 2, 64, 2)]


def flash_bwd_bound_ms(B, S, T, H, KV, hd, causal, dtype,
                       window=0, k_offset=0) -> tuple:
    """(bound_ms, bound_by) of K2': q, k, v, o, do and lse read once and dq,
    dk, dv written once over HBM bandwidth, vs the five hd-deep products
    (q k^T, dO v^T, P^T dO, dS^T q, dS k: 2 hd operations a pair each)
    over the pairs the mask keeps (inside the window, if any), at the
    type's peak."""
    esize = torch.tensor([], dtype=dtype).element_size()
    byte_s = (esize * (4 * B * S * H * hd + 4 * B * T * KV * hd)
              + 4 * B * H * S) / HBM_BYTES_PER_S
    pairs = mask_pairs(S, T, causal, window, k_offset)
    op_s = 5 * 2 * hd * pairs * B * H / PEAK_OPS[dtype]
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def wkv6_bwd_bound_ms(B, S, H, hd, dtype) -> tuple:
    """(bound_ms, bound_by) of K3': r, k, v, log w, dy, u, s0 and dS_final
    read once and dr, dk, dv, dlog w, du and ds0 written once over HBM
    bandwidth, vs the operations of the per-token walk (S_{t-1} dy and the
    state update forward, G v, G^T k and the G update backward: 10 hd^2 a
    token and head) as TF32 products on the tensor cores, where K3' does
    them: one each for bf16 r/k/v, three (3xTF32) for float32, whose exact
    products still beat the 67 TFLOP/s of the CUDA cores."""
    esize = torch.tensor([], dtype=dtype).element_size()
    elems = B * S * H * hd
    byte_s = (elems * (3 * esize + 4 + 4) + H * hd * 4
              + 2 * B * H * hd * hd * 4
              + elems * (3 * esize + 4) + H * hd * 4
              + B * H * hd * hd * 4) / HBM_BYTES_PER_S
    op_s = (10 * hd * hd * B * S * H * (1 if dtype == torch.bfloat16 else 3)
            / PEAK_TF32)
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations")


def max_rel(got, want) -> float:
    """max over the tensors of max |got - want| / max |want|."""
    return max(rel_err(g, w) for g, w in zip(got, want))


def check_grads(label, got, want, tol) -> float:
    """Every tensor of ``got`` within atol = rtol = ``tol`` of ``want`` (in
    float32) and finite; returns the largest absolute error."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        if not (torch.isfinite(g).all() and torch.allclose(
                g, w, atol=tol, rtol=tol)):
            bad = float((g - w).abs().max())
            raise AssertionError(f"{label} gradient {i}: max abs err {bad} "
                                 f"> {tol}")
        err = max(err, float((g - w).abs().max()))
    return err


def check_flash_grad(shape, dtype, flash_mod, flash_kernel,
                     window=0) -> float:
    """Hold K2' against flash_bwd_plain and against autograd through
    attention_plain (float32 on the same inputs), K2's log-sum-exp against
    attention_lse_plain (finite: with a ``window`` a row's first key tiles
    may hold none of its keys), and the autograd route (FlashAttention)
    against the direct call; returns the largest absolute error."""
    B, S, T, H, KV, hd, causal = shape
    q, k, v = flash_inputs(B, S, T, H, KV, hd, dtype)
    do = flash_inputs(B, S, S, H, H, hd, dtype, seed=43)[0]
    tol = GRAD_TOL[dtype]
    tag = f"{shape}" + (f" window {window}" if window else "") + \
        f" {str(dtype)[6:]}"
    out, lse = flash_kernel._forward(q, k, v, causal, True, window)
    lse_want = flash_mod.attention_lse_plain(q, k, causal=causal,
                                             window=window)
    if not (torch.isfinite(lse).all() and torch.allclose(
            lse, lse_want, atol=FLASH_TOL[torch.float32],
            rtol=FLASH_TOL[torch.float32])):
        raise AssertionError(f"K2 lse {tag}: max abs err "
                             f"{float((lse - lse_want).abs().max())}")
    got = flash_mod.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    plain = flash_mod.flash_bwd_plain(q.float(), k.float(), v.float(),
                                      out.float(), do.float(), lse,
                                      causal=causal, window=window)
    err = check_grads(f"K2' {tag} vs flash_bwd_plain", got, plain, tol)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = flash_mod.attention_plain(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(ref, leaves, do.float())
    err_auto = check_grads(f"K2' {tag} vs autograd", got, auto, tol)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    via_fn = torch.autograd.grad(
        flash_mod.flash_attention(*leaves, causal=causal, window=window),
        leaves, do)
    for a, b in zip(via_fn, got):
        if not torch.equal(a, b):
            raise AssertionError(f"K2' {tag}: FlashAttention's backward "
                                 "differs from flash_attention_bwd")
    log(f"K2' (B,S,T,H,KV,hd,causal)={tag}: dq, dk, dv "
        f"within {tol} of flash_bwd_plain (max abs err {err:.3e}) and of "
        f"autograd through attention_plain ({err_auto:.3e}); lse within "
        f"{FLASH_TOL[torch.float32]}")
    return max(err, err_auto)


def sdpa_bwd(q, k, v, do, mask=None, causal=True):
    """The library yardstick of K2': the backward of one
    scaled_dot_product_attention call on (B, H, S, hd) leaves (its backward
    kernels only; the forward runs outside the timed calls), with the
    causal mask (unless ``causal`` is False) or a boolean ``mask``.  The
    backward's kernels run on the stream its forward ran on, so the forward
    is made again whenever the caller's stream changes: on the stream a
    CUDA graph captures, during ``graph_ms``' warm-up calls."""
    state = {}
    g = do.transpose(1, 2).contiguous()

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if state.get("stream") != stream:
            leaves = [t.transpose(1, 2).detach().clone().requires_grad_()
                      for t in (q, k, v)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
            state.update(stream=stream, out=out, leaves=leaves)
        return torch.autograd.grad(state["out"], state["leaves"], g,
                                   retain_graph=True)

    call()
    return call


def time_flash_grad(flash_mod, flash_kernel) -> dict:
    """K2' at qwen3-0.6b's training layer: CUDA events of back-to-back calls
    and the profiler's device time (bf16 and f32 inputs), the plain
    version, and the backward of scaled_dot_product_attention (device time
    of its backward kernels), beside the bound."""
    B, S, T, H, KV, hd, causal = TRAIN_FLASH
    t = {}
    for tag, dtype in (("", torch.bfloat16), ("_f32", torch.float32)):
        q, k, v = flash_inputs(B, S, T, H, KV, hd, dtype, seed=5)
        do = flash_inputs(B, S, S, H, H, hd, dtype, seed=6)[0]
        out, lse = flash_kernel._forward(q, k, v, causal, True)
        call = lambda: flash_mod.flash_attention_bwd(q, k, v, out, do, lse,
                                                     causal=causal)
        t["ms" + tag] = cuda_ms(call)
        t["device_split" + tag] = {}
        t["device_ms" + tag] = device_ms(call, split=t["device_split" + tag])
        if dtype == torch.bfloat16:
            t["plain_ms"] = cuda_ms(lambda: flash_mod.flash_bwd_plain(
                q, k, v, out, do, lse, causal=causal))
            lib = sdpa_bwd(q, k, v, do)
            t["library_ms"] = cuda_ms(lib)
            t["library_device_ms"] = device_ms(lib)
    t["bound_ms"], t["bound_by"] = flash_bwd_bound_ms(*TRAIN_FLASH,
                                                      torch.bfloat16)
    t["bound_ms_f32"], t["bound_by_f32"] = flash_bwd_bound_ms(
        *TRAIN_FLASH, torch.float32)
    log(f"K2' training layer {TRAIN_FLASH}, bf16: kernel {t['ms']:.4f} ms "
        f"(device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention's backward {t['library_ms']:.4f} ms "
        f"(device {t['library_device_ms']:.4f} ms), bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_by']}); f32: kernel "
        f"{t['ms_f32']:.4f} ms (device {t['device_ms_f32']:.4f} ms), bound "
        f"{t['bound_ms_f32']:.6f} ms ({t['bound_by_f32']}); by kernel "
        f"(device ms): bf16 {t['device_split']}, f32 "
        f"{t['device_split_f32']}")
    return t


def wkv6_grad_inputs(B, S, H, hd, dtype, log_decay=-2.0):
    """K3's inputs (nonzero s0) and the output gradients dy and dS_final,
    drawn on the card."""
    args = wkv6_inputs(B, S, H, hd, dtype, log_decay=log_decay)
    g = torch.Generator(device="cuda").manual_seed(8)
    dy = torch.randn((B, S, H, hd), generator=g, device="cuda") * 0.5
    ds = torch.randn((B, H, hd, hd), generator=g, device="cuda") * 0.2
    return args, dy, ds


def check_wkv6_grad(shape, dtype, wkv6_mod, log_decay=-2.0) -> float:
    """Hold K3' against wkv6_bwd_plain, wkv6_bwd_tiled_plain (its own
    decomposition) and autograd through the chunked plain version (under a
    strong decay, ``log_decay`` > 0, through the per-token one: the chunked
    form overflows), and the autograd route
    (WKV6) against the direct call; returns the largest absolute error.
    Head sizes 1 and 2 go through the autograd route only (``wkv6`` pads
    them to 4 around the kernels)."""
    B, S, H, hd, chunk = shape
    args, dy, ds = wkv6_grad_inputs(B, S, H, hd, dtype, log_decay)
    tol = GRAD_TOL[dtype]
    f32 = [t.float() for t in args]
    leaves = [t.clone().requires_grad_() for t in f32]
    if log_decay > 0:
        y, s_fin = wkv6_mod.wkv6_plain(*leaves)
    else:
        y, s_fin = wkv6_mod.wkv6_chunked_plain(*leaves, chunk)
    auto = torch.autograd.grad((y, s_fin), leaves, (dy, ds))
    leaves = [t.detach().clone().requires_grad_() for t in args]
    y, s_fin = wkv6_mod.wkv6(*leaves, chunk=chunk)
    via_fn = torch.autograd.grad((y, s_fin), leaves, (dy, ds))
    torch.cuda.synchronize()
    if hd < 4:
        err = check_grads(f"K3' {shape} {dtype} (padded) vs autograd",
                          via_fn, auto, tol)
        log(f"K3' (B,S,H,hd,chunk)={shape} {str(dtype)[6:]}, head padded "
            f"to 4: dr, dk, dv, dlogw, du, ds0 within {tol} of autograd "
            f"through the chunked plain version (max abs err {err:.3e})")
        return err
    got = wkv6_mod.wkv6_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    for a, b in zip(via_fn, got):
        if not torch.equal(a, b):
            raise AssertionError(f"K3' {shape} {dtype}: WKV6's backward "
                                 "differs from wkv6_bwd")
    plain = wkv6_mod.wkv6_bwd_plain(*f32, dy, ds)
    err = check_grads(f"K3' {shape} {dtype} vs wkv6_bwd_plain", got, plain,
                      tol)
    tiled = getattr(wkv6_mod, "wkv6_bwd_tiled_plain", None)
    if tiled is None and not OTHER_SRC:
        raise AssertionError("repro_torch has no wkv6_bwd_tiled_plain")
    err_tiled = float("nan") if tiled is None else check_grads(
        f"K3' {shape} {dtype} vs wkv6_bwd_tiled_plain", got,
        tiled(*f32, dy, ds), tol)
    err_auto = check_grads(f"K3' {shape} {dtype} vs autograd", got, auto,
                           tol)
    log(f"K3' (B,S,H,hd,chunk)={shape} {str(dtype)[6:]}"
        + (f" log w ~ -exp(N(0, 0.5) + {log_decay})" if log_decay > 0 else "")
        + f": dr, dk, dv, dlogw, du, ds0 within {tol} of wkv6_bwd_plain "
        f"(max abs err {err:.3e}), of wkv6_bwd_tiled_plain ({err_tiled:.3e}) "
        "and of autograd through the "
        + ("per-token" if log_decay > 0 else "chunked")
        + f" plain version ({err_auto:.3e}; rel {max_rel(got, auto):.2e})")
    return max(err, err_tiled, err_auto)


def time_wkv6_grad(wkv6_mod, wkv6_kernel) -> dict:
    """K3' at rwkv6-1.6b's training layer, from the forward's states: CUDA
    events and the profiler's device time (bf16 and f32 r/k/v) and the
    plain version, beside the bound."""
    B, S, H, hd, chunk = TRAIN_WKV
    t = {}
    for tag, dtype in (("", torch.bfloat16), ("_f32", torch.float32)):
        args, dy, ds = wkv6_grad_inputs(B, S, H, hd, dtype)
        states = wkv6_kernel._launch(*args)[2]
        call = lambda: wkv6_mod.wkv6_bwd(*args, dy, ds, states=states)
        t["ms" + tag] = cuda_ms(call)
        t["device_split" + tag] = {}
        t["device_ms" + tag] = device_ms(call, split=t["device_split" + tag])
        if dtype == torch.bfloat16:
            t["plain_ms"] = cuda_ms(
                lambda: wkv6_mod.wkv6_bwd_plain(*args, dy, ds))
    t["bound_ms"], t["bound_by"] = wkv6_bwd_bound_ms(B, S, H, hd,
                                                     torch.bfloat16)
    log(f"K3' training layer {TRAIN_WKV}: bf16 r/k/v {t['ms']:.4f} ms "
        f"(device {t['device_ms']:.4f} ms), f32 {t['ms_f32']:.4f} ms "
        f"(device {t['device_ms_f32']:.4f} ms), plain {t['plain_ms']:.4f} "
        f"ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}); by kernel "
        f"(device ms): bf16 {t['device_split']}, f32 "
        f"{t['device_split_f32']}")
    return t


def grad_kernel_phases(flash_mod, flash_kernel, wkv6_mod,
                       wkv6_kernel) -> dict:
    """Phases 15 and 16: K2' and K3' against their plain versions, then
    timed.  TF32 is off for every float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"k2_bwd_err": 0.0, "k3_bwd_err": 0.0}
    for shape in FLASH_SHAPES + [TRAIN_FLASH]:
        for dtype in (torch.float32, torch.bfloat16):
            out["k2_bwd_err"] = max(out["k2_bwd_err"], check_flash_grad(
                shape, dtype, flash_mod, flash_kernel))
    out["k2_bwd_times"] = time_flash_grad(flash_mod, flash_kernel)
    for shape in WKV_SHAPES + WKV_CROSSING + WKV_GRAD_PADDED + [TRAIN_WKV]:
        for dtype in (torch.float32, torch.bfloat16):
            out["k3_bwd_err"] = max(out["k3_bwd_err"], check_wkv6_grad(
                shape, dtype, wkv6_mod))
    out["k3_bwd_strong_err"] = max(
        check_wkv6_grad(shape, dtype, wkv6_mod, STRONG_DECAY)
        for shape in WKV_GRAD_STRONG
        for dtype in (torch.float32, torch.bfloat16))
    out["k3_bwd_times"] = time_wkv6_grad(wkv6_mod, wkv6_kernel)
    return out


#: phase 17: 2-layer models at full width, 2 micro-batches of 1 x 256
#: tokens, cuda (K2/K2', K3/K3') vs CPU (plain) in float32, TF32 off
GRAD_MODEL = {"batch": 2, "seq": 256, "microbatches": 2}
#: phase 18: the trainer at full width and depth (bf16 compute, AdamW)
TRAIN_RUN = {"steps": 4, "batch": 8, "seq": 512, "microbatches": 2,
             "lr": 1e-3}
#: phase 18's restart on the reduced configs: the resumed losses against
#: an uninterrupted run (the embedding's backward sums with atomics on the
#: card, so the runs may differ in the last bits, and bf16 rounds them)
RESTART_RTOL = 1e-3


def reset_launches(*counters):
    for c in counters:
        c.launches = 0


def model_grad_phase(flash_mod, wkv6_mod) -> dict:
    """Phase 17: a 2-layer qwen3-0.6b and a 2-layer rwkv6-1.6b at full
    width in float32 compute with TF32 off (matmul and cuDNN): the mean
    loss and every parameter's gradient over 2 micro-batches on cuda
    (through K2/K2' or K3/K3') match the same weights on the CPU (plain)
    within 1e-3 of each tensor's largest magnitude, under remat none and
    layer; K2'/K3' launch layers x micro-batches times, the forward kernel
    once more per layer and micro-batch under "layer"."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.models import rwkv6, transformer
    from repro_torch.pipeline.executor import microbatch_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    kinds = (("qwen3-0.6b", transformer, transformer.Transformer,
              flash_mod.flash_attention, flash_mod.flash_attention_bwd),
             ("rwkv6-1.6b", rwkv6, rwkv6.RWKV6, wkv6_mod.wkv6,
              wkv6_mod.wkv6_bwd))
    for arch, lib, cls, fwd, bwd in kinds:
        for remat in ("none", "layer"):
            cfg = dataclasses.replace(get_config(arch), num_layers=2,
                                      compute_dtype=torch.float32,
                                      remat=remat)
            cpu_model = lib.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu")
            gpu_model = cls(cfg, "cuda")
            gpu_model.load_state_dict(cpu_model.state_dict())
            b = next(token_lm_batches(batch=GRAD_MODEL["batch"],
                                      seq_len=GRAD_MODEL["seq"],
                                      vocab=cfg.vocab, seed=2))
            q = GRAD_MODEL["microbatches"]
            runs = {}
            for route, dev, model in (("kernel", "cuda", gpu_model),
                                      ("plain", "cpu", cpu_model)):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in b.items()}
                reset_launches(fwd, bwd)
                loss, grads = microbatch_grads(
                    lambda _p, mb: lib.loss_fn(model, mb),
                    list(model.parameters()), batch, q)
                if route == "kernel":
                    torch.cuda.synchronize()
                    launches = {"forward": fwd.launches,
                                "backward": bwd.launches}
                runs[route] = (loss, grads)
            want = {"forward": cfg.num_layers * q
                    * (2 if remat == "layer" else 1),
                    "backward": cfg.num_layers * q}
            if launches != want:
                raise AssertionError(f"{arch} remat {remat}: launches "
                                     f"{launches} != {want}")
            names = [n for n, _ in gpu_model.named_parameters()]
            errs = {"loss": rel_err(runs["kernel"][0], runs["plain"][0])}
            errs.update({n: rel_err(g, c) for n, g, c in
                         zip(names, runs["kernel"][1], runs["plain"][1])})
            worst = max(errs, key=errs.get)
            if not (math.isfinite(float(runs["kernel"][0]))
                    and errs[worst] <= MODEL_REL_TOL):
                raise AssertionError(f"{arch} remat {remat}: cuda vs cpu "
                                     f"{worst} {errs[worst]}")
            log(f"model grads {arch} (2 layers, full width, f32, TF32 off, "
                f"remat {remat}, {q} micro-batches of "
                f"{GRAD_MODEL['batch'] // q} x {GRAD_MODEL['seq']}): loss "
                f"cuda {float(runs['kernel'][0])!r} cpu "
                f"{float(runs['plain'][0])!r}; {len(names)} gradients, max "
                f"err / max magnitude {errs[worst]:.2e} ({worst}; tolerance "
                f"{MODEL_REL_TOL}); launches {launches}")
            out[f"{arch}_{remat}"] = {"max_rel_err": errs[worst],
                                      "loss_rel_err": errs["loss"],
                                      "launches": launches}
            del cpu_model, gpu_model, runs
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return out


def train_phase(flash_mod, wkv6_mod, minplus, out_dir) -> dict:
    """Phase 18: ``train`` at full width and depth for both families (bf16
    compute, AdamW, remat "layer"): every loss finite, the last below the
    first; K2/K2' (qwen3) and K3/K3' (rwkv6) launched as remat "layer"
    implies (the forward kernel twice per layer and micro-batch: once in
    the forward, once recomputed in the backward); step time, tokens/s,
    peak device memory, and the device's idle share over one more step
    (profiler).  Then a restart from a checkpoint on the reduced configs."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.launch import train as train_mod
    from repro_torch.models.registry import get_model
    from repro_torch.optim import get_optimizer
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_bwd,
                wkv6_mod.wkv6, wkv6_mod.wkv6_bwd, minplus.sweep_minplus)
    step_s = []
    factory = train_mod.make_train_step

    def timed_factory(*a, **kw):
        step = factory(*a, **kw)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return res
        return timed

    run = TRAIN_RUN
    tokens = run["batch"] * run["seq"]
    out = {}
    train_mod.make_train_step = timed_factory
    try:
        for arch, fwd, bwd in (("qwen3-0.6b", flash_mod.flash_attention,
                                flash_mod.flash_attention_bwd),
                               ("rwkv6-1.6b", wkv6_mod.wkv6,
                                wkv6_mod.wkv6_bwd)):
            cfg = get_config(arch)
            step_s.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(*counters)
            t0 = time.perf_counter()
            losses = train_mod.train(
                arch, reduced=False, steps=run["steps"], batch=run["batch"],
                seq=run["seq"], microbatches=run["microbatches"],
                optimizer="adamw", lr=run["lr"], log_every=1, seed=0,
                device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            per_step = cfg.num_layers * run["microbatches"]
            want = {fwd.__name__: 2 * per_step * run["steps"],
                    bwd.__name__: per_step * run["steps"]}
            if any(launches[k] != v for k, v in want.items()):
                raise AssertionError(f"train {arch}: launches {launches}, "
                                     f"expected {want}")
            if not (all(math.isfinite(v) for v in losses)
                    and losses[-1] < losses[0]):
                raise AssertionError(f"train {arch}: losses {losses}")
            # one more step, profiled, on a fresh model and optimizer
            api = get_model(cfg, "cuda")
            model = api.init(torch.Generator(device="cuda").manual_seed(0))
            opt = get_optimizer("adamw", lr=run["lr"])
            state = opt.init(dict(model.named_parameters()))
            step = factory(cfg, opt, run["microbatches"], "cuda")
            b = next(token_lm_batches(batch=run["batch"],
                                      seq_len=run["seq"], vocab=cfg.vocab,
                                      seed=0))
            b = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
            step(model, state, b)                                # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(model, state, b)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
            # the device time of a step: one step captured in a CUDA graph
            # and replayed (or, where it cannot be captured, profiled steps
            # two of which count the same kernel events)
            busy = device_ms(lambda: step(model, state, b), reps=1,
                             host_events=False)
            idle = {"wall_ms": wall_ms, "device_busy_ms": busy,
                    "device_idle_share": 1.0 - busy / wall_ms}
            n_params = api.param_count(model)
            del api, model, opt, state, step
            out[arch] = {
                "losses": losses, "step_s": step_s[:],
                "tokens_per_s": [tokens / t for t in step_s],
                "wall_s": wall_s, "peak_gib": peak_gib,
                "launches": launches, "idle": idle, "params": n_params}
            log(f"train {arch} full width ({cfg.num_layers} layers, "
                f"{out[arch]['params']} parameters, bf16 compute, AdamW lr "
                f"{run['lr']}, remat {cfg.remat}; batch {run['batch']} x "
                f"{run['seq']} tokens in {run['microbatches']} micro-batches"
                f"): losses {[round(v, 4) for v in losses]}; step s "
                f"{[round(t, 4) for t in step_s]} (tokens/s "
                f"{[round(tokens / t) for t in step_s]}); peak device memory "
                f"{peak_gib:.2f} GiB; launches {launches}; one more step "
                f"profiled: wall {idle['wall_ms']:.1f} ms, device busy "
                f"{idle['device_busy_ms']:.1f} ms, idle share "
                f"{idle['device_idle_share']:.3f}")
            torch.cuda.empty_cache()
    finally:
        train_mod.make_train_step = factory
    # a restart from a checkpoint, on the reduced configs
    kw = dict(reduced=True, batch=4, seq=64, microbatches=2, lr=2e-3,
              log_every=100, device="cuda")
    out["restart"] = {}
    for arch in ("qwen3-0.6b", "rwkv6-1.6b"):
        ckpt = os.path.join(out_dir, arch)
        shutil.rmtree(ckpt, ignore_errors=True)
        whole = train_mod.train(arch, steps=6, **kw)
        first = train_mod.train(arch, steps=4, ckpt_dir=ckpt, ckpt_every=2,
                                **kw)
        rest = train_mod.train(arch, steps=6, ckpt_dir=ckpt, **kw)
        gap = max(abs(a - b) / abs(b) for a, b in zip(first + rest, whole))
        if not (len(rest) == 2 and gap <= RESTART_RTOL):
            raise AssertionError(f"restart {arch}: {first} + {rest} vs "
                                 f"{whole}")
        log(f"restart {arch} (reduced, on the card): 4 steps, checkpoint "
            f"at step 3, relaunch resumed at step 4; losses within "
            f"{gap:.2e} of an uninterrupted run (tolerance {RESTART_RTOL})")
        out["restart"][arch] = gap
    return out


#: phase 19: the windows K2 and K2' are held to their plain versions at (1
#: and 7: inside a 64-key tile; 64: one tile; 100: off the tiles; 4096:
#: longer than every prompt, no effect) and the window they are timed at
WINDOWS = (1, 7, 64, 100, 4096)
TIMED_WINDOW = 128
#: command-r-35b's reduced head size, which the kernels are not built for:
#: the wrappers zero-pad it to 16
PADDED_FLASH = (1, 512, 512, 8, 2, 8, True)


def window_mask(S, T, window, device="cuda"):
    """(S, T) bool of the pairs the causal mask and ``window`` keep."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


def sdpa_masked(q, k, v, mask):
    """scaled_dot_product_attention on the (B, H, S, hd) views with a
    boolean mask (GQA inside the call): K2's library yardstick under a
    window."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def sdpa_backend(kernels) -> str:
    """Which of SDPA's backends ran, from its CUDA kernels' names."""
    names = " ".join(kernels).lower()
    if "flash" in names:
        return "flash"
    if "fmha" in names or "efficient" in names or "mem_eff" in names:
        return "efficient"
    return "math"


def time_window(flash_mod, flash_kernel) -> dict:
    """K2 (bf16) at the served and 2048-token shapes and K2' (bf16) at the
    training layer, at window TIMED_WINDOW: CUDA events and the profiler's
    device time beside the window-aware bound, the plain version, the
    unwindowed call and SDPA given the same boolean mask (which backend
    ran, from its kernels' names)."""
    w = TIMED_WINDOW
    out = {"window": w}
    for label, shape in (("served", SERVED_FLASH), ("2048", LONG_FLASH)):
        B, S, T, H, KV, hd, causal = shape
        q, k, v = flash_inputs(*shape[:6], torch.bfloat16, seed=5)
        mask = window_mask(S, T, w)
        call = lambda: flash_mod.flash_attention(q, k, v, window=w)
        lib = lambda: sdpa_masked(q, k, v, mask)
        if not torch.allclose(call().float(), lib().transpose(1, 2).float(),
                              atol=2e-2, rtol=2e-2):
            raise AssertionError(f"K2 {shape} window {w} differs from "
                                 "scaled_dot_product_attention")
        split = {}
        t = {"ms": cuda_ms(call), "device_ms": device_ms(call),
             "plain_ms": cuda_ms(lambda: flash_mod.attention_plain(
                 q, k, v, window=w)),
             "library_ms": cuda_ms(lib),
             "library_device_ms": device_ms(lib, split=split),
             "unwindowed_device_ms": device_ms(
                 lambda: flash_mod.flash_attention(q, k, v))}
        t["library_kernels"] = sorted(split)
        t["library_backend"] = sdpa_backend(split)
        t["bound_ms"], t["bound_by"] = flash_bound_ms(
            *shape, torch.bfloat16, window=w)
        t["pairs"] = mask_pairs(S, T, causal, w)
        out[label] = t
        log(f"K2 {label} {shape} window {w}, bf16: kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}; unwindowed "
            f"{t['unwindowed_device_ms']:.4f}), plain {t['plain_ms']:.4f} "
            f"ms, SDPA with the mask {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}; backend {t['library_backend']}: "
            f"{t['library_kernels']}), bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}, {t['pairs']} pairs)")
    B, S, T, H, KV, hd, causal = TRAIN_FLASH
    q, k, v = flash_inputs(B, S, T, H, KV, hd, torch.bfloat16, seed=5)
    do = flash_inputs(B, S, S, H, H, hd, torch.bfloat16, seed=6)[0]
    o, lse = flash_kernel._forward(q, k, v, causal, True, w)
    call = lambda: flash_mod.flash_attention_bwd(q, k, v, o, do, lse,
                                                 window=w)
    lib = sdpa_bwd(q, k, v, do, window_mask(S, T, w))
    split, lib_split = {}, {}
    t = {"ms": cuda_ms(call), "device_ms": device_ms(call, split=split),
         "plain_ms": cuda_ms(lambda: flash_mod.flash_bwd_plain(
             q, k, v, o, do, lse, window=w)),
         "library_ms": cuda_ms(lib),
         "library_device_ms": device_ms(lib, split=lib_split)}
    o0, lse0 = flash_kernel._forward(q, k, v, causal, True)
    t["unwindowed_device_ms"] = device_ms(
        lambda: flash_mod.flash_attention_bwd(q, k, v, o0, do, lse0))
    t["device_split"] = split
    t["library_backend"] = sdpa_backend(lib_split)
    t["bound_ms"], t["bound_by"] = flash_bwd_bound_ms(
        *TRAIN_FLASH, torch.bfloat16, window=w)
    out["train_bwd"] = t
    log(f"K2' training layer {TRAIN_FLASH} window {w}, bf16: kernel "
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}; unwindowed "
        f"{t['unwindowed_device_ms']:.4f}; by kernel {split}), plain "
        f"{t['plain_ms']:.4f} ms, SDPA's backward with the mask "
        f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f}; "
        f"backend {t['library_backend']}), bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']})")
    return out


def window_phase(flash_mod, flash_kernel) -> dict:
    """Phase 19: K2 and K2' with a sliding window against their plain
    versions (TF32 off), the padded head size, then timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    causal_shapes = [s for s in FLASH_SHAPES if s[6]]
    out = {"k2_err": 0.0, "k2_bwd_err": 0.0, "padded_err": 0.0,
           "windows": WINDOWS}
    for shape in causal_shapes + [SERVED_FLASH, LONG_FLASH]:
        for window in WINDOWS:
            for dtype in (torch.float32, torch.bfloat16):
                out["k2_err"] = max(out["k2_err"], check_flash(
                    shape, dtype, flash_mod, window))
    for shape in causal_shapes + [TRAIN_FLASH]:
        for window in WINDOWS:
            for dtype in (torch.float32, torch.bfloat16):
                out["k2_bwd_err"] = max(out["k2_bwd_err"], check_flash_grad(
                    shape, dtype, flash_mod, flash_kernel, window))
    for window in (0, 100):
        for dtype in (torch.float32, torch.bfloat16):
            out["padded_err"] = max(
                out["padded_err"],
                check_flash(PADDED_FLASH, dtype, flash_mod, window),
                check_flash_grad(PADDED_FLASH, dtype, flash_mod, flash_kernel,
                                 window))
    out["times"] = time_window(flash_mod, flash_kernel)
    return out


#: phase 20: 2-layer models at full width, f32, TF32 off, each as published
#: and with a window of 100 and the GELU MLP together (the float32 CPU side
#: of one run takes 15-30 s there, most of it the 128-152k vocabulary's
#: head: one run per option would double the phase)
DENSE_ARCHS = ("qwen1.5-4b", "llama3-8b")
DENSE_VARIANTS = {"as published": {},
                  "window 100, gelu mlp": {"sliding_window": 100,
                                           "ffn_mult": 2}}


def dense_model_phase(flash_mod) -> dict:
    """Phase 20: a 2-layer qwen1.5-4b and llama3-8b at full width in float32
    compute with TF32 off, each also with ``sliding_window`` 100 and
    ``ffn_mult`` 2: a 512-token prefill on cuda (K2) against the same
    weights on the CPU (plain) on the logits and the KV cache, and the loss
    and every gradient over 2 micro-batches of 1 x 256 tokens (K2 / K2',
    remat none: each launched layers x micro-batches times), within 1e-3
    of each tensor's largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.models import transformer
    from repro_torch.pipeline.executor import microbatch_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    q = GRAD_MODEL["microbatches"]
    out = {}
    for arch in DENSE_ARCHS:
        for variant, change in DENSE_VARIANTS.items():
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch), num_layers=2,
                                      compute_dtype=torch.float32,
                                      remat="none", **change)
            gpu_model = transformer.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            cpu_model = transformer.Transformer(cfg, "cpu")
            cpu_model.load_state_dict(gpu_model.state_dict())
            prompt = torch.randint(0, cfg.vocab, (1, 512),
                                   generator=torch.Generator().manual_seed(1))
            reset_launches(fwd, bwd)
            logits_g, cache_g = transformer.prefill(gpu_model, prompt.cuda(),
                                                    512)
            torch.cuda.synchronize()
            if fwd.launches != cfg.num_layers:
                raise AssertionError(f"{arch} {variant}: the cuda prefill "
                                     f"launched K2 {fwd.launches} times")
            logits_c, cache_c = transformer.prefill(cpu_model, prompt, 512)
            errs = {"logits": rel_err(logits_g, logits_c),
                    **{f"cache {n}": rel_err(cache_g[n], cache_c[n])
                       for n in cache_c}}
            if not (torch.isfinite(logits_g).all()
                    and max(errs.values()) <= MODEL_REL_TOL):
                raise AssertionError(f"{arch} {variant} prefill cuda vs cpu: "
                                     f"{errs}")
            del logits_g, cache_g, logits_c, cache_c
            b = next(token_lm_batches(batch=GRAD_MODEL["batch"],
                                      seq_len=GRAD_MODEL["seq"],
                                      vocab=cfg.vocab, seed=2))
            runs = {}
            for route, dev, model in (("kernel", "cuda", gpu_model),
                                      ("plain", "cpu", cpu_model)):
                batch = {n: torch.as_tensor(x, device=dev)
                         for n, x in b.items()}
                reset_launches(fwd, bwd)
                runs[route] = microbatch_grads(
                    lambda _p, mb: transformer.loss_fn(model, mb),
                    list(model.parameters()), batch, q)
                if route == "kernel":
                    torch.cuda.synchronize()
                    launches = {"forward": fwd.launches,
                                "backward": bwd.launches}
            want = cfg.num_layers * q
            if launches != {"forward": want, "backward": want}:
                raise AssertionError(f"{arch} {variant}: launches {launches}"
                                     f" != {want} each")
            names = [n for n, _ in gpu_model.named_parameters()]
            gerrs = {"loss": rel_err(runs["kernel"][0], runs["plain"][0])}
            gerrs.update({n: rel_err(g, c) for n, g, c in
                          zip(names, runs["kernel"][1], runs["plain"][1])})
            worst = max(gerrs, key=gerrs.get)
            if not (math.isfinite(float(runs["kernel"][0]))
                    and gerrs[worst] <= MODEL_REL_TOL):
                raise AssertionError(f"{arch} {variant} grads cuda vs cpu: "
                                     f"{worst} {gerrs[worst]}")
            named = {n: gerrs[n] for n in gerrs
                     if n.split(".")[-1] in ("bq", "bk", "bv", "b_up",
                                             "b_down", "lm_head")}
            out[f"{arch} {variant}"] = {
                "prefill_launches": cfg.num_layers,
                "prefill_max_rel_err": max(errs.values()),
                "grads_max_rel_err": gerrs[worst], "worst": worst,
                "loss_rel_err": gerrs["loss"], "launches": launches,
                "option_grads_max_rel_err": max(named.values(), default=None),
                "wall_s": time.perf_counter() - t0}
            log(f"dense model {arch} {variant} (2 layers, d {cfg.d_model}, "
                f"{cfg.n_heads} heads / {cfg.n_kv} kv of {cfg.head_dim}, d_ff "
                f"{cfg.d_ff}, vocab {cfg.vocab}, window "
                f"{cfg.sliding_window}, ffn_mult {cfg.ffn_mult}, qkv_bias "
                f"{cfg.qkv_bias}, tied {cfg.tie_embeddings}; f32, TF32 off): "
                f"512-token prefill cuda (K2) vs cpu "
                + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                + f"; loss and {len(names)} gradients over {q} micro-batches "
                f"of {GRAD_MODEL['batch'] // q} x {GRAD_MODEL['seq']}: loss "
                f"cuda {float(runs['kernel'][0])!r} cpu "
                f"{float(runs['plain'][0])!r}, max err / max magnitude "
                f"{gerrs[worst]:.2e} ({worst}); "
                + ", ".join(f"{n} {e:.2e}" for n, e in named.items())
                + f" (tolerance {MODEL_REL_TOL}); launches {launches}; "
                f"{out[f'{arch} {variant}']['wall_s']:.1f} s")
            del gpu_model, cpu_model, runs
            torch.cuda.empty_cache()
    return out


#: phase 21: (arch, layers served); command-r-35b's 40 layers in f32 (~121
#: GB with its tied 8.4 GB embedding) do not fit one 80 GB card, 8 do; the
#: others, which fit at full depth, are cut to 8 layers as well to keep the
#: whole run within half its time limit (decode is host-bound: its time goes
#: as the layer count)
DENSE_SERVE = (("qwen1.5-4b", 8), ("llama3-8b", 8), ("command-r-35b", 8))


def k2_per_prefill(cfg) -> int:
    """K2's launches in one prefill (and one training forward) of
    ``cfg``'s model: one per attention layer (Whisper's encoder layers,
    and its decoder's self- and cross-attention)."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))


def serve_phase(server_cls, request_cls, flash_mod, counters,
                runs=DENSE_SERVE) -> dict:
    """Phases 13, 21, 24 and 27: BatchedServer at full width for each
    (arch, layers or None for all[, options]) of ``runs`` (phase 21:
    DENSE_SERVE; phase 24: MOE_SERVE; phase 27: ``ha_serve_runs()``): f32
    parameters, bf16 compute, 4 slots, 8 requests; by default cache_len
    1024, 512 prompt tokens (a VLM's after its zero patch embeddings, an
    audio model's after zero frames) and 32 new tokens each, which the
    options ``prompt``, ``gen`` and ``cache_len`` change (and ``config``
    serves in place of the arch's config); K2 launched 8 x
    ``k2_per_prefill`` times, a fresh prefill of request 0 finite and
    giving its first served token; prefill ms per request, decode
    tokens/s and peak device memory.  Each model is freed before the next
    is built."""
    from repro_torch.configs import get_config
    prefill_s = []

    class TimedServer(server_cls):
        """Records each prefill's time; admission and decoding unchanged."""

        def _prefill_one(self, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super()._prefill_one(req)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            return res

    out = {}
    for arch, layers, *opts in runs:
        opts = opts[0] if opts else {}
        prompt, gen = opts.get("prompt", 512), opts.get("gen", 32)
        cache_len = opts.get("cache_len", 1024)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_gib = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        srv = TimedServer(arch, reduced=False, batch=4, cache_len=cache_len,
                          seed=0, device="cuda", num_layers=layers,
                          config=opts.get("config"))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = srv.cfg
        n_params = srv.api.param_count(srv.params)
        rng = np.random.default_rng(0)
        reqs = [request_cls(rid, rng.integers(0, cfg.vocab, size=prompt)
                            .astype(np.int32), max_new=gen)
                for rid in range(8)]
        warm = srv.api.prefill(srv.params,
                               srv.prefill_batch(reqs[0].prompt[:64]),
                               cache_len)
        del warm                          # casts the weights to bf16 once
        for req in reqs:
            srv.submit(req)
        prefill_s.clear()
        reset_launches(*counters)
        stats = srv.run()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        k2_want = len(reqs) * k2_per_prefill(cfg)
        if launches[flash_mod.flash_attention.__name__] != k2_want:
            raise AssertionError(f"serve {arch}: launches {launches}, K2 "
                                 f"expected {k2_want}")
        done = stats["completed"]
        if not (len(done) == len(reqs) and all(
                len(r.generated) == gen and r.done
                and all(0 <= t < cfg.vocab for t in r.generated)
                for r in done)):
            raise AssertionError(f"serve {arch}: served {len(done)} of "
                                 f"{len(reqs)} requests")
        logits, cache = srv.api.prefill(
            srv.params, srv.prefill_batch(reqs[0].prompt), cache_len)
        if not (torch.isfinite(logits).all()
                and all(torch.isfinite(c).all() for c in cache.values())
                and int(torch.argmax(logits[0, -1])) == reqs[0].generated[0]):
            raise AssertionError(f"serve {arch}: a fresh prefill of request "
                                 "0 is not finite or disagrees with its "
                                 "first served token")
        decode_s = stats["seconds"] - sum(prefill_s)
        out[arch] = {
            "layers": cfg.num_layers,
            "layers_published": get_config(arch).num_layers,
            "patch_tokens": cfg.patch_tokens,
            "prompt": prompt, "gen": gen, "cache_len": cache_len,
            "params": n_params, "init_s": init_s,
            "prefill_ms": [t * 1e3 for t in prefill_s],
            "decode_tokens": stats["tokens"], "seconds": stats["seconds"],
            "decode_tok_per_s": stats["tokens"] / decode_s,
            "peak_gib": peak_gib, "held_gib": held_gib,
            "launches": launches}
        log(f"serve {arch} full width, {cfg.num_layers} of "
            f"{out[arch]['layers_published']} layers ({n_params} parameters, "
            f"f32 params, bf16 compute; init {init_s:.2f} s): {len(done)} "
            f"requests x {prompt} prompt tokens"
            + (f" after {cfg.patch_tokens} patch positions"
               if cfg.patch_tokens else "")
            + (f" after {cfg.encoder_frames} zero frames"
               if cfg.family == "audio" else "")
            + f", {gen} new tokens each, cache_len {cache_len}, "
            f"{stats['tokens']} decode tokens "
            f"in {stats['seconds']:.3f} s; prefill ms per request "
            f"{[round(t * 1e3, 3) for t in prefill_s]}; decode "
            f"{out[arch]['decode_tok_per_s']:.2f} tokens/s; launches "
            f"{launches}; peak device memory {peak_gib:.2f} GiB, of which "
            f"{held_gib:.2f} GiB was held before the server was built")
        del srv, stats, done, reqs, logits, cache
        torch.cuda.empty_cache()
    return out


#: phases 22-24: the MoE configs and the VLM backbone
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "internvl2-1b")
#: phase 22 also times K2 at the dense serving layers of phase 21
DENSE_TIMED = ("qwen1.5-4b", "llama3-8b", "command-r-35b")
#: phase 23: (arch, layers, the loss and gradients too): 2-layer
#: granite-moe-3b and internvl2-1b; qwen3-moe-235b's f32 layer is ~10 GB
#: (with ~5 GB of embedding and untied head, and a host copy of both), so
#: one layer and the prefill only
MOE_MODELS = (("granite-moe-3b-a800m", 2, True), ("internvl2-1b", 2, True),
              ("qwen3-moe-235b-a22b", 1, False))
#: a token's top-K set may differ between the card and the CPU only where
#: its K-th and (K+1)-th router probabilities are this close
NEAR_TIE = 1e-5
#: phase 24: (arch, layers served); qwen3-moe-235b's 94 layers in f32 are
#: ~940 GB, 4 with their bf16 casts ~66 GB; granite-moe-3b, which fits at
#: full depth, is cut to 8 of its 32 layers for the run's time (as phase 21)
MOE_SERVE = (("granite-moe-3b-a800m", 8), ("internvl2-1b", None),
             ("qwen3-moe-235b-a22b", 4))
MOE_PROMPT = 512


def layer_shape(cfg, batch=1, prompt=MOE_PROMPT) -> tuple:
    """(B, S, T, H, KV, hd, causal) of a prefill's attention: the prompt
    after the config's patch positions."""
    S = prompt + cfg.patch_tokens
    return (batch, S, S, cfg.n_heads, cfg.n_kv, cfg.head_dim, True)


def moe_flash_phase(flash_mod, flash_kernel) -> dict:
    """Phase 22: K2 (f32 and bf16) and K2' (bf16, batch 4) against their
    plain versions (TF32 off) at the layer shapes of granite-moe-3b (24 /
    8 heads of 64), qwen3-moe-235b (64 / 4 of 128) and internvl2-1b (14 /
    2 of 64 over 256 patches + 512 tokens); then K2 timed at those and at
    phase 21's dense serving layers."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"k2_err": 0.0, "k2_bwd_err": 0.0, "times": {}}
    for arch in MOE_ARCHS:
        shape = layer_shape(get_config(arch))
        for dtype in (torch.float32, torch.bfloat16):
            out["k2_err"] = max(out["k2_err"],
                                check_flash(shape, dtype, flash_mod))
        out["k2_bwd_err"] = max(out["k2_bwd_err"], check_flash_grad(
            layer_shape(get_config(arch), batch=4), torch.bfloat16,
            flash_mod, flash_kernel))
    for arch in MOE_ARCHS + DENSE_TIMED:
        shape = layer_shape(get_config(arch))
        t = out["times"][arch] = {"shape": shape,
                                  **time_flash_turns(flash_mod, shape)}
        log(f"K2 {arch} layer {shape}, bf16: kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
    return out


class RoutingProbe:
    """Stands in for ``models/moe.py::route`` while a model runs.  Recording
    (the card's run), it keeps each call's top-K picks and kept slots.
    Replaying (the same calls on the CPU, in the same order), it compares
    each token's top-K set with the card's: a token whose set differs must
    sit at a near-tie (its K-th and (K+1)-th probabilities within
    NEAR_TIE), and takes the card's picks, so the run goes on with the
    card's routing and every output stays comparable; then the kept slots
    must equal the card's.  ``stats`` counts calls, tokens, the tokens
    that differed and their gaps."""

    def __init__(self, moe):
        self.moe = moe
        self.route = moe.route
        self.calls = []
        self.replay = None
        self.stats = {"calls": 0, "tokens": 0, "differing_tokens": 0,
                      "gaps": []}

    @contextlib.contextmanager
    def recording(self):
        self.calls.clear()
        self.replay = None
        self.moe.route = self
        try:
            yield self
        finally:
            self.moe.route = self.route

    @contextlib.contextmanager
    def replaying(self):
        self.replay = iter(self.calls)
        self.moe.route = self
        try:
            yield self
        finally:
            self.moe.route = self.route
            self.replay = None

    def __call__(self, logits, C, E, K):
        r = self.route(logits, C, E, K)
        if self.replay is None:
            self.calls.append((r.idx.cpu(), r.keep.cpu(), r.slot.cpu()))
            return r
        idx, keep, slot = next(self.replay)
        same = torch.equal(torch.sort(r.idx, -1).values,
                           torch.sort(idx, -1).values)
        self.stats["calls"] += 1
        self.stats["tokens"] += idx.shape[0] * idx.shape[1]
        if not same:
            probs = torch.softmax(logits, dim=-1)
            top = torch.topk(probs, K + 1, dim=-1).values
            gap = top[..., K - 1] - top[..., K]
            differ = (torch.sort(r.idx, -1).values
                      != torch.sort(idx, -1).values).any(-1)
            gaps = gap[differ].tolist()
            self.stats["differing_tokens"] += len(gaps)
            self.stats["gaps"] += gaps
            if max(gaps) >= NEAR_TIE:
                raise AssertionError(f"routing: {len(gaps)} tokens' top-{K} "
                                     f"sets differ from the card's with "
                                     f"gaps {gaps} (a near-tie is under "
                                     f"{NEAR_TIE})")
            idx = idx.to(r.idx.device)
            r = self.moe.assign(idx, self.moe.gates_of(logits, idx), C, E)
        if not (torch.equal(r.keep, keep) and torch.equal(r.slot, slot)):
            raise AssertionError("routing: the kept slots differ from the "
                                 "card's for the same top-K sets")
        return r


def grads_cuda_vs_cpu(label, loss_fn, gpu_model, cpu_model, b, probe,
                      counters, q, want) -> tuple:
    """The mean loss and every gradient of ``loss_fn(model, micro-batch)``
    over ``q`` micro-batches of the batch ``b`` (numpy arrays), on cuda
    (``probe`` recording each MoE call's routing) and on the CPU (replaying
    it); K2 and K2' (``counters``) must launch ``want`` times each on the
    card, and each result must lie within MODEL_REL_TOL of each tensor's
    largest magnitude.  Returns ({name: error, "loss": error}, the worst
    name, the launches, the card's loss)."""
    from repro_torch.pipeline.executor import microbatch_grads
    fwd, bwd = counters
    runs = {}
    for route, dev, model in (("kernel", "cuda", gpu_model),
                              ("plain", "cpu", cpu_model)):
        batch = {n: torch.as_tensor(x, device=dev) for n, x in b.items()}
        with probe.recording() if dev == "cuda" else probe.replaying():
            reset_launches(fwd, bwd)
            runs[route] = microbatch_grads(
                lambda _p, mb, model=model: loss_fn(model, mb),
                list(model.parameters()), batch, q)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {"forward": fwd.launches,
                            "backward": bwd.launches}
    if launches != {"forward": want, "backward": want}:
        raise AssertionError(f"{label}: launches {launches} != {want} each")
    names = [n for n, _ in gpu_model.named_parameters()]
    errs = {"loss": rel_err(runs["kernel"][0], runs["plain"][0])}
    errs.update({n: rel_err(g, c) for n, g, c in
                 zip(names, runs["kernel"][1], runs["plain"][1])})
    worst = max(errs, key=errs.get)
    loss = float(runs["kernel"][0])
    if not (math.isfinite(loss) and errs[worst] <= MODEL_REL_TOL):
        raise AssertionError(f"{label} grads cuda vs cpu: {worst} "
                             f"{errs[worst]}")
    return errs, worst, launches, loss


def moe_model_phase(flash_mod) -> dict:
    """Phase 23: a 2-layer granite-moe-3b and internvl2-1b and a 1-layer
    qwen3-moe-235b at full width in float32 compute with TF32 off: a
    512-token prefill (internvl2-1b's after 256 seeded patch embeddings) on
    cuda (K2) against the same weights on the CPU on the logits and the KV
    cache; for the first two also the loss and every gradient over 2
    micro-batches of 1 x 256 tokens (K2 / K2', remat none: each launched
    layers x micro-batches times), and for granite-moe-3b 2 Adafactor
    steps of the trainer (``adafactor_steps``); each within 1e-3 of each
    tensor's largest magnitude.  Every MoE call's
    routing on the CPU is held to the card's (``RoutingProbe``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.models import moe, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    q = GRAD_MODEL["microbatches"]
    out = {}
    for arch, layers, with_grads in MOE_MODELS:
        t0 = time.perf_counter()
        probe = RoutingProbe(moe)
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  compute_dtype=torch.float32, remat="none")
        gpu_model = transformer.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        cpu_model = transformer.Transformer(cfg, "cpu")
        cpu_model.load_state_dict(gpu_model.state_dict())
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (1, MOE_PROMPT), generator=gen)
        patches = None
        if cfg.patch_tokens:
            patches = torch.randn((1, cfg.patch_tokens, cfg.d_model),
                                  generator=gen)
        cache_len = MOE_PROMPT + cfg.patch_tokens
        with probe.recording():
            reset_launches(fwd, bwd)
            logits_g, cache_g = transformer.prefill(
                gpu_model, prompt.cuda(), cache_len,
                None if patches is None else patches.cuda())
            torch.cuda.synchronize()
        if fwd.launches != layers:
            raise AssertionError(f"{arch}: the cuda prefill launched K2 "
                                 f"{fwd.launches} times")
        with probe.replaying():
            logits_c, cache_c = transformer.prefill(cpu_model, prompt,
                                                    cache_len, patches)
        errs = {"logits": rel_err(logits_g, logits_c),
                **{f"cache {n}": rel_err(cache_g[n], cache_c[n])
                   for n in cache_c}}
        if not (torch.isfinite(logits_g).all()
                and max(errs.values()) <= MODEL_REL_TOL):
            raise AssertionError(f"{arch} prefill cuda vs cpu: {errs}")
        del logits_g, cache_g, logits_c, cache_c
        row = {"layers": layers, "prefill_launches": layers,
               "prefill_max_rel_err": max(errs.values()),
               "prefill_errs": errs}
        if with_grads:
            b = next(token_lm_batches(batch=GRAD_MODEL["batch"],
                                      seq_len=GRAD_MODEL["seq"],
                                      vocab=cfg.vocab, seed=2))
            if cfg.patch_tokens:
                b["patch_embeds"] = torch.randn(
                    (GRAD_MODEL["batch"], cfg.patch_tokens, cfg.d_model),
                    generator=gen).numpy()
            gerrs, worst, launches, loss = grads_cuda_vs_cpu(
                arch, transformer.loss_fn, gpu_model, cpu_model, b, probe,
                (fwd, bwd), q, layers * q)
            row.update(grads_max_rel_err=gerrs[worst], worst=worst,
                       loss_rel_err=gerrs["loss"], launches=launches,
                       loss=loss,
                       option_grads_rel_err={
                           n: e for n, e in gerrs.items()
                           if n.split(".")[-1] in ("router", "w_gate",
                                                   "w_up", "w_down", "bq",
                                                   "bk", "bv")})
        if with_grads and cfg.moe_experts:
            row["adafactor"] = adafactor_steps(cfg, gpu_model, cpu_model,
                                               probe, fwd, bwd)
        row["routing"] = {k: v for k, v in probe.stats.items()
                          if k != "gaps"}
        row["routing"]["near_tie_gaps"] = probe.stats["gaps"]
        row["wall_s"] = time.perf_counter() - t0
        out[arch] = row
        log(f"moe/vlm model {arch} ({layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads} heads / {cfg.n_kv} kv of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, experts {cfg.moe_experts} top {cfg.moe_top_k}, "
            f"patches {cfg.patch_tokens}, vocab {cfg.vocab}; f32, TF32 off): "
            f"{MOE_PROMPT}-token prefill cuda (K2) vs cpu "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + (f"; loss and {len(gerrs) - 1} gradients over {q} "
               f"micro-batches: max err / max magnitude "
               f"{row['grads_max_rel_err']:.2e} ({row['worst']}), "
               + ", ".join(f"{n} {e:.2e}" for n, e in
                           row["option_grads_rel_err"].items())
               + f"; launches {row['launches']}" if with_grads else "")
            + (f"; adafactor {row['adafactor']}" if "adafactor" in row
               else "")
            + f"; routing {row['routing']} (tolerance {MODEL_REL_TOL}); "
            f"{row['wall_s']:.1f} s")
        del gpu_model, cpu_model
        torch.cuda.empty_cache()
    return out


def adafactor_steps(cfg, gpu_model, cpu_model, probe, fwd, bwd,
                    steps=2) -> dict:
    """``steps`` Adafactor steps of the trainer (``make_train_step``, 2
    micro-batches of 1 x 256 tokens) on cuda, each held to the CPU: from
    the card's parameters before the step, the CPU's loss and gradients
    (in the optimizer's layout, stacked over the layers) against the
    card's, and the CPU's Adafactor update on the card's gradients and
    state against the card's parameters and state after the step; each
    within 1e-3 of each tensor's largest magnitude.  The update is held
    on the same gradients: Adafactor scales each row and column of a
    matrix by its own gradient's rms, so a column whose gradient is
    rounding noise (an expert's unit that one token reached with a
    near-zero value) takes a full-size step in the noise's direction, on
    any two devices (a float32 and a float64 CPU run differ by 0.9% after
    one step)."""
    from repro_torch.data import token_lm_batches
    from repro_torch.launch.steps import (init_optimizer, make_train_step,
                                          optimizer_tree)
    from repro_torch.models import transformer
    from repro_torch.optim import get_optimizer
    from repro_torch.pipeline.executor import microbatch_grads
    from repro_torch.utils import tree_map
    q = GRAD_MODEL["microbatches"]
    stream = token_lm_batches(batch=GRAD_MODEL["batch"],
                              seq_len=GRAD_MODEL["seq"], vocab=cfg.vocab,
                              seed=4)
    opt = get_optimizer("adafactor", lr=1e-3)
    seen = []

    def update(params, grads, state):
        seen.append(tree_map(lambda g: g.detach().cpu(), grads))
        return opt.update(params, grads, state)

    step = make_train_step(cfg, dataclasses.replace(opt, update=update), q,
                           device="cuda")
    state = init_optimizer(opt, gpu_model)
    to_cpu = lambda tree: tree_map(lambda t: t.detach().cpu().clone(), tree)
    errs, losses, launches = {}, [], {"forward": 0, "backward": 0}
    for k in range(steps):
        b = next(stream)
        before = {n: p.detach().cpu().clone()
                  for n, p in gpu_model.named_parameters()}
        state_before = to_cpu(state)
        with probe.recording():
            reset_launches(fwd, bwd)
            gpu_model, state, loss = step(gpu_model, state, b)
            torch.cuda.synchronize()
            launches = {"forward": launches["forward"] + fwd.launches,
                        "backward": launches["backward"] + bwd.launches}
        with torch.no_grad():
            for n, p in cpu_model.named_parameters():
                p.copy_(before[n])
        named = dict(cpu_model.named_parameters())
        with probe.replaying():
            loss_c, grads = microbatch_grads(
                lambda _p, mb: transformer.loss_fn(cpu_model, mb),
                list(named.values()),
                {n: torch.as_tensor(x) for n, x in b.items()}, q)
        grads = optimizer_tree(dict(zip(named, grads)), opt)
        tree = optimizer_tree(before, opt)
        _, state_c = opt.update(tree, seen[-1], state_before)
        after = to_cpu(optimizer_tree(dict(gpu_model.named_parameters()),
                                      opt))
        losses.append((float(loss), float(loss_c)))
        errs[f"loss {k}"] = abs(losses[-1][0] - losses[-1][1]) \
            / abs(losses[-1][1])
        for label, got, want in (("grad", seen[-1], grads),
                                 ("param", after, tree),
                                 ("state", to_cpu(state["f"]),
                                  state_c["f"])):
            for path, g, w in tree_pairs(got, want):
                errs[f"{label} {k} {path}"] = rel_err(g, w)
    want = cfg.num_layers * q * steps
    if launches != {"forward": want, "backward": want}:
        raise AssertionError(f"adafactor steps: launches {launches}")
    worst = max(errs, key=errs.get)
    if not (all(math.isfinite(a) for a, _ in losses)
            and errs[worst] <= MODEL_REL_TOL):
        raise AssertionError(f"adafactor steps cuda vs cpu: {worst} "
                             f"{errs[worst]}")
    return {"steps": steps, "losses_cuda_cpu": losses,
            "max_rel_err": errs[worst], "worst": worst,
            "launches": launches, "compared": len(errs)}


def tree_pairs(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        for k in sorted(a):
            yield from tree_pairs(a[k], b[k], f"{path}/{k}" if path else k)
    else:
        yield path, a, b


def moe_phases(flash_mod, flash_kernel, server_cls, request_cls,
               counters) -> dict:
    """Phases 22-24, timed."""
    t0 = time.perf_counter()
    flash = moe_flash_phase(flash_mod, flash_kernel)
    t1 = time.perf_counter()
    models = moe_model_phase(flash_mod)
    t2 = time.perf_counter()
    served = serve_phase(server_cls, request_cls, flash_mod, counters,
                         MOE_SERVE)
    walls = {"22": t1 - t0, "23": t2 - t1, "24": time.perf_counter() - t2}
    log("phase walls: " + ", ".join(f"{k} {v:.1f} s"
                                    for k, v in walls.items()))
    return {"flash": flash, "models": models, "serve": served,
            "phase_walls_s": walls}


#: phases 25-27: the hybrid and audio families
WHISPER = "whisper-small"
JAMBA = "jamba-1.5-large-398b"
#: jamba at full width cut to one period of 2 layers (a Mamba + SwiGLU
#: slot and an attention + MoE slot): 11.9B parameters, where one published
#: period of 8 holds 45.2B (181 GB in f32)
JAMBA_CUT = {"num_layers": 2, "attn_every": 2}
#: phase 25 cuts jamba's experts to 4 of 16 as well (4.67B parameters, 18.7
#: GB in f32), so the parameters, their gradients and a CPU copy fit
JAMBA_CHECK_EXPERTS = 4
#: phase 25: (arch, prompt tokens, tokens per micro-batch row)
HA_MODELS = ((WHISPER, 64, 64), (JAMBA, 256, 128))
HA_DECODE_STEPS = 32
#: phase 26: K2 / K2' shapes (B, S, T, H, KV, hd, causal)
HA_FLASH = {"whisper_encoder": (1, 1500, 1500, 12, 12, 64, False),
            "whisper_cross": (1, 64, 1500, 12, 12, 64, False),
            "ragged_non_causal": (2, 77, 131, 4, 2, 16, False),
            "jamba_attention": (1, 512, 512, 64, 8, 128, True)}
HA_TIMED = ("whisper_encoder", "whisper_cross", "jamba_attention")


def jamba_cut(**changes):
    """jamba-1.5-large at full width cut to one period of 2 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(JAMBA), **JAMBA_CUT, **changes)


def ha_serve_runs() -> tuple:
    """Phase 27's servers: whisper-small at full size (the decoder's 448
    positions) and the jamba cut with all 16 experts."""
    return ((WHISPER, None, {"prompt": 64, "gen": 64, "cache_len": 448}),
            (JAMBA, None, {"config": jamba_cut()}))


@contextlib.contextmanager
def experts_hold_every_token(model):
    """Each MoE layer of ``model`` with capacity_factor experts / top-k,
    so that an expert's capacity holds every token (as it always does in a
    one-token decode step): a longer prefill then drops no pair, and
    decode and prefill compute the same function."""
    from repro_torch.models import moe
    layers = [m for m in model.modules() if isinstance(m, moe.MoEFFN)]
    saved = [m.cfg for m in layers]
    for m in layers:
        m.cfg = dataclasses.replace(
            m.cfg, capacity_factor=m.cfg.moe_experts / m.cfg.moe_top_k)
    try:
        yield
    finally:
        for m, cfg in zip(layers, saved):
            m.cfg = cfg


def all_logits(model, tokens, frames=None):
    """The logits at every position of ``tokens`` (B, L) on the model's
    device, without grad: Jamba's training forward and head, Whisper's
    teacher-forced decoder over the encoder's output of ``frames``."""
    from repro_torch.models import jamba, whisper
    with torch.no_grad():
        if frames is not None:
            return whisper.decode_train(model, tokens,
                                        whisper.encode(model, frames))
        return model.logits(jamba.forward_hidden(model, tokens))


def ha_model_phase(flash_mod) -> dict:
    """Phase 25: whisper-small at full size and the jamba cut (2 layers,
    4 experts) in float32 compute with TF32 off (see the module
    docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.models import moe, whisper
    from repro_torch.models.registry import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    q = GRAD_MODEL["microbatches"]
    out = {}
    for arch, prompt_len, grad_seq in HA_MODELS:
        t0 = time.perf_counter()
        probe = RoutingProbe(moe)
        base = (get_config(arch) if arch == WHISPER
                else jamba_cut(moe_experts=JAMBA_CHECK_EXPERTS))
        cfg = dataclasses.replace(base, compute_dtype=torch.float32,
                                  remat="none")
        api_g, api_c = get_model(cfg, "cuda"), get_model(cfg, "cpu")
        gpu_model = api_g.init(torch.Generator(device="cuda").manual_seed(0))
        cpu_model = type(gpu_model)(cfg, "cpu")
        cpu_model.load_state_dict(gpu_model.state_dict())
        audio = cfg.family == "audio"
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab,
                               (1, prompt_len + HA_DECODE_STEPS),
                               generator=gen)
        batch = {"tokens": tokens[:, :prompt_len]}
        if audio:
            batch["frames"] = torch.randn(
                (1, cfg.encoder_frames, cfg.d_model), generator=gen)
        on_card = {n: t.cuda() for n, t in batch.items()}
        cache_len = prompt_len + HA_DECODE_STEPS
        with probe.recording():
            reset_launches(fwd, bwd)
            logits_g, cache_g = api_g.prefill(gpu_model, on_card, cache_len)
            torch.cuda.synchronize()
            prefill_launches = fwd.launches
        if prefill_launches != k2_per_prefill(cfg):
            raise AssertionError(f"{arch}: the cuda prefill launched K2 "
                                 f"{prefill_launches} times")
        with probe.replaying():
            logits_c, cache_c = api_c.prefill(cpu_model, batch, cache_len)
        errs = {"logits": rel_err(logits_g, logits_c),
                **{f"cache {n}": rel_err(cache_g[n], cache_c[n])
                   for n in cache_c}}
        if audio:
            with torch.no_grad():
                errs["encoder output"] = rel_err(
                    whisper.encode(gpu_model, on_card["frames"]),
                    whisper.encode(cpu_model, batch["frames"]))
        finite = torch.isfinite(logits_g).all() and all(
            torch.isfinite(c).all() for c in cache_g.values())
        if not (finite and max(errs.values()) <= MODEL_REL_TOL):
            raise AssertionError(f"{arch} prefill cuda vs cpu: {errs}")
        del logits_g, cache_g, logits_c, cache_c

        # decode on the card against the longer sequence's logits
        with experts_hold_every_token(gpu_model):
            _, cache = api_g.prefill(gpu_model, on_card, cache_len)
            steps = []
            for t in range(HA_DECODE_STEPS):
                pos = prompt_len + t
                lg, cache = api_g.decode(gpu_model, cache,
                                         tokens[:, pos:pos + 1].cuda(), pos)
                steps.append(lg[:, 0])
            full = all_logits(gpu_model, tokens.cuda(),
                              on_card.get("frames"))[:, prompt_len:]
        want = full.float()
        decode_err = float((torch.stack(steps, 1).float() - want).abs().max()
                           / want.abs().max())
        if not decode_err <= DECODE_TOL:
            raise AssertionError(f"{arch}: {HA_DECODE_STEPS} decode steps "
                                 f"vs the longer sequence: {decode_err}")
        del cache, steps, full, want

        b = next(token_lm_batches(batch=GRAD_MODEL["batch"], seq_len=grad_seq,
                                  vocab=cfg.vocab, seed=2))
        if audio:
            b["frames"] = torch.randn(
                (GRAD_MODEL["batch"], cfg.encoder_frames, cfg.d_model),
                generator=gen).numpy()
        gerrs, worst, launches, _ = grads_cuda_vs_cpu(
            arch, api_g.loss, gpu_model, cpu_model, b, probe, (fwd, bwd), q,
            k2_per_prefill(cfg) * q)
        row = {"layers": cfg.num_layers, "experts": cfg.moe_experts,
               "params": api_g.param_count(gpu_model),
               "prompt": prompt_len, "prefill_launches": prefill_launches,
               "prefill_max_rel_err": max(errs.values()),
               "prefill_errs": errs, "decode_steps": HA_DECODE_STEPS,
               "decode_max_rel_err": decode_err,
               "grads_max_rel_err": gerrs[worst], "worst": worst,
               "loss_rel_err": gerrs["loss"], "launches": launches,
               "grad_tokens": [GRAD_MODEL["batch"], grad_seq],
               "routing": {k: v for k, v in probe.stats.items()
                           if k != "gaps"},
               "wall_s": time.perf_counter() - t0}
        row["routing"]["near_tie_gaps"] = probe.stats["gaps"]
        out[arch] = row
        log(f"hybrid/audio model {arch} ({cfg.num_layers} layers"
            + (f" + {cfg.encoder_layers} encoder layers over "
               f"{cfg.encoder_frames} frames" if audio else
               f", attn_every {cfg.attn_every}, {cfg.moe_experts} experts "
               f"top {cfg.moe_top_k}")
            + f", d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv} kv of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
            f"{row['params']} parameters; f32, TF32 off): {prompt_len}-token "
            f"prefill cuda (K2 x {prefill_launches}) vs cpu "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f"; {HA_DECODE_STEPS} decode steps vs the longer sequence "
            f"{decode_err:.2e} (tolerance {DECODE_TOL}); loss and "
            f"{len(gerrs) - 1} gradients over {q} micro-batches of 1 x "
            f"{grad_seq}: max err / max magnitude {gerrs[worst]:.2e} "
            f"({worst}), loss {gerrs['loss']:.2e}; launches {launches}; "
            f"routing {row['routing']} (tolerance {MODEL_REL_TOL}); "
            f"{row['wall_s']:.1f} s")
        del gpu_model, cpu_model
        torch.cuda.empty_cache()
    return out


#: calls of each side before timed turns, so that neither side's first
#: session pays a one-time cost (a library's plan, a lazy allocation)
WARM_CALLS = 20


def time_flash_turns(flash_mod, shape, turns=2) -> dict:
    """K2 (bf16) at ``shape`` against scaled_dot_product_attention with
    the same mask, by the profiler's device time in turns (K2, SDPA, SDPA,
    K2 for two turns) so that a drift of the card's clock falls on both,
    with the names of SDPA's kernels (its backend) and K2's profiler events
    a call (from checked profiler sessions), and
    those timed by CUDA events after losing events every time are counted;
    also CUDA events, the plain version and the bound."""
    q, k, v = flash_inputs(*shape[:6], torch.bfloat16, seed=5)
    causal = shape[6]
    call = lambda: flash_mod.flash_attention(q, k, v, causal=causal)
    lib = lambda: sdpa(q, k, v, causal)
    if not torch.allclose(call().float(), lib().transpose(1, 2).float(),
                          atol=2e-2, rtol=2e-2):
        raise AssertionError(f"K2 {shape} differs from "
                             "scaled_dot_product_attention")
    for _ in range(WARM_CALLS):
        call()
        lib()
    runs, lib_split, k_counts = {"kernel": [], "library": []}, {}, {}
    for i in range(turns):
        for who in (("kernel", "library") if i % 2 == 0
                    else ("library", "kernel")):
            runs[who].append(
                device_ms(call, counts=k_counts) if who == "kernel"
                else device_ms(lib, split=lib_split))
    t = {"device_ms": float(np.mean(runs["kernel"])),
         "library_device_ms": float(np.mean(runs["library"])),
         "device_ms_turns": runs["kernel"],
         "library_device_ms_turns": runs["library"],
         "library_kernels": sorted(lib_split, key=lib_split.get,
                                   reverse=True)[:3],
         "kernel_events_per_call": {n: round(c / turns, 3)
                                    for n, c in k_counts.items()},
         "ms": cuda_ms(call), "library_ms": cuda_ms(lib),
         "plain_ms": cuda_ms(lambda: flash_mod.attention_plain(
             q, k, v, causal=causal))}
    t["bound_ms"], t["bound_by"] = flash_bound_ms(*shape, torch.bfloat16)
    return t


def time_flash_bwd_turns(flash_mod, flash_kernel, shape, turns=2) -> dict:
    """K2' (bf16) at ``shape`` against the backward of
    scaled_dot_product_attention with the same mask, by the profiler's
    device time in turns (K2', SDPA, SDPA, K2' for two turns), with the
    names of SDPA's kernels; also the plain version (CUDA events) and the
    bound."""
    q, k, v = flash_inputs(*shape[:6], torch.bfloat16, seed=5)
    do = flash_inputs(shape[0], shape[1], shape[1], shape[3], shape[3],
                      shape[5], torch.bfloat16, seed=6)[0]
    causal = shape[6]
    out, lse = flash_kernel._forward(q, k, v, causal, True)
    call = lambda: flash_mod.flash_attention_bwd(q, k, v, out, do, lse,
                                                 causal=causal)
    lib = sdpa_bwd(q, k, v, do, causal=causal)
    for _ in range(WARM_CALLS):
        call()
        lib()
    runs, lib_split, k_counts = {"kernel": [], "library": []}, {}, {}
    for i in range(turns):
        for who in (("kernel", "library") if i % 2 == 0
                    else ("library", "kernel")):
            runs[who].append(
                device_ms(call, counts=k_counts) if who == "kernel"
                else device_ms(lib, split=lib_split))
    t = {"device_ms": float(np.mean(runs["kernel"])),
         "library_device_ms": float(np.mean(runs["library"])),
         "device_ms_turns": runs["kernel"],
         "library_device_ms_turns": runs["library"],
         "library_kernels": sorted(lib_split, key=lib_split.get,
                                   reverse=True)[:3],
         "kernel_events_per_call": {n: round(c / turns, 3)
                                    for n, c in k_counts.items()},
         "plain_ms": cuda_ms(lambda: flash_mod.flash_bwd_plain(
             q, k, v, out, do, lse, causal=causal))}
    t["bound_ms"], t["bound_by"] = flash_bwd_bound_ms(*shape, torch.bfloat16)
    return t


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature now
    (``nvidia-smi``): beside a timing, they say whether the card ran at
    its full clock (calls have timed the same kernel 3x apart)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


def ha_flash_phase(flash_mod, flash_kernel) -> dict:
    """Phase 26: K2 and K2' at the HA_FLASH shapes against their plain
    versions (TF32 off), then K2 and K2' timed at HA_TIMED."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"k2_err": 0.0, "k2_bwd_err": 0.0, "times": {}}
    for shape in HA_FLASH.values():
        for dtype in (torch.float32, torch.bfloat16):
            out["k2_err"] = max(out["k2_err"],
                                check_flash(shape, dtype, flash_mod))
            out["k2_bwd_err"] = max(out["k2_bwd_err"], check_flash_grad(
                shape, dtype, flash_mod, flash_kernel))
    for name in HA_TIMED:
        shape = HA_FLASH[name]
        before = gpu_clocks()
        t = out["times"][name] = {"shape": shape,
                                  **time_flash_turns(flash_mod, shape)}
        t["clocks"] = [before, gpu_clocks()]
        log(f"K2 {name} {shape}, bf16: device {t['device_ms']:.4f} ms "
            f"(turns {[round(x, 4) for x in t['device_ms_turns']]}), "
            f"scaled_dot_product_attention device "
            f"{t['library_device_ms']:.4f} ms (turns "
            f"{[round(x, 4) for x in t['library_device_ms_turns']]}; "
            f"{t['library_kernels']}); events: kernel {t['ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms; bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}); K2's events a call "
            f"{t['kernel_events_per_call']}; clocks, "
            f"power and temperature before / after: {t['clocks']}")
        t = out["times"][name]["backward"] = time_flash_bwd_turns(
            flash_mod, flash_kernel, shape)
        log(f"K2' {name} {shape}, bf16: device {t['device_ms']:.4f} ms "
            f"(turns {[round(x, 4) for x in t['device_ms_turns']]}), "
            f"scaled_dot_product_attention's backward device "
            f"{t['library_device_ms']:.4f} ms (turns "
            f"{[round(x, 4) for x in t['library_device_ms_turns']]}; "
            f"{t['library_kernels']}); plain "
            f"{t['plain_ms']:.4f} ms (events); bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}); K2' events a call "
            f"{t['kernel_events_per_call']}")
    return out


def ha_phases(flash_mod, flash_kernel, server_cls, request_cls,
              counters) -> dict:
    """Phases 25-27, timed."""
    t0 = time.perf_counter()
    models = ha_model_phase(flash_mod)
    t1 = time.perf_counter()
    flash = ha_flash_phase(flash_mod, flash_kernel)
    t2 = time.perf_counter()
    served = serve_phase(server_cls, request_cls, flash_mod, counters,
                         ha_serve_runs())
    walls = {"25": t1 - t0, "26": t2 - t1, "27": time.perf_counter() - t2}
    log("phase walls: " + ", ".join(f"{k} {v:.1f} s"
                                    for k, v in walls.items()))
    return {"models": models, "flash": flash, "serve": served,
            "phase_walls_s": walls}


def bench30_instance(core) -> tuple:
    """The reference's planner benchmark fleet
    (``benchmarks/bench_planner.py::bench_instance(24, 28)``): a 30-layer
    transformer profile on 24 servers and 4 clients."""
    prof = core.transformer_profile(
        "bench30", num_layers=28, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
        vocab=32000, seq_len=128)
    net = core.make_edge_network(num_servers=24, num_clients=4, seed=1,
                                 kappa=1 / 32.0, f_range=(1e12, 10e12),
                                 mem_range=(4 * 2**30, 32 * 2**30))
    return prof, net


def replan_deltas(ft, n: int) -> list:
    """The 16 deltas ``benchmarks/bench_planner.py::fleet_run`` replans
    through: rate changes of 0.8 / 1.25 and stragglers of 1.5 / 1 / 1.5,
    alternating, over the servers of an ``n``-node network."""
    deltas = []
    for k in range(16):
        if k % 2 == 0:
            deltas.append(ft.RateChange(n_from=1 + k % (n - 1),
                                        n_to=1 + (k + 1) % (n - 1),
                                        factor=0.8 if k % 4 else 1.25))
        else:
            deltas.append(ft.Straggler(node=1 + k % (n - 1),
                                       slowdown=1.5 if k % 4 == 1
                                       else 1 / 1.5))
    return deltas


def msp_key(r) -> tuple:
    """What ``tests/conftest.py::same_msp_result`` compares."""
    if not r.feasible:
        return (False,)
    return (True, r.objective, r.solution.cuts, r.solution.placement,
            r.T_1, r.T_f, r.b)


def f32_contract(want, got) -> bool:
    """The reference's float32 contract for the device backend: the same
    feasibility, the float64-repriced objective within rtol 1e-4, the same
    b."""
    if want.feasible != got.feasible:
        return False
    return not want.feasible or (
        abs(got.objective - want.objective) <= F32_RTOL * abs(want.objective)
        and got.b == want.b)


#: phase 4d's tolerances: the reference's engine parity (compare_engines),
#: cuda against the CPU, and Eq. (12)-(14) (cross_validate)
SIM_ENGINE_TOL = 1e-9
SIM_DEVICE_RTOL = 1e-12
SIM_EQ14_RTOL = 1e-6


def sim_gap(want, got) -> float:
    """Largest relative gap between two float64 tensors (any devices)."""
    w = want.detach().cpu().double()
    g = got.detach().cpu().double()
    if w.numel() == 0:
        return 0.0
    return float(((w - g).abs() / w.abs().clamp(min=1e-30)).max())


def sim_device_gap(cuda_rep, cpu_rep) -> float:
    """cuda against the CPU over ``mb_complete`` and, for a vectorized run,
    the dense ``starts`` / ``ends``."""
    gaps = [sim_gap(cpu_rep.mb_complete, cuda_rep.mb_complete)]
    if cuda_rep.timeline is not None:
        gaps += [sim_gap(cpu_rep.timeline.starts, cuda_rep.timeline.starts),
                 sim_gap(cpu_rep.timeline.ends, cuda_rep.timeline.ends)]
    return max(gaps)


#: micro-batches of the 1F1B chain whose device busy time phase 4d reads
SIM_BUSY_Q = 1_000
#: one-call busy-time measurements of host-bound runs (phases 4d, 4e),
#: taken after phase 27: their profiled sessions are the run's largest, and
#: the profiler loses events in later sessions after large ones
DEFERRED_BUSY = []


def defer_busy(label, fn, entry, wall_s):
    """Measure ``fn``'s device busy time (``device_ms``, one call, by the
    profiler) after phase 27 and store it in ``entry`` as
    ``device_busy_ms`` and ``idle_share`` against ``wall_s``."""
    DEFERRED_BUSY.append((label, fn, entry, wall_s))


def run_deferred_busy():
    for label, fn, entry, wall_s in DEFERRED_BUSY:
        busy = device_ms(fn, reps=1, host_events=False, graph=False)
        entry["device_busy_ms"] = busy
        entry["idle_share"] = 1.0 - busy / 1e3 / wall_s
        log(f"{label}: device busy {busy:.2f} ms of {wall_s:.4f} s (idle "
            f"share {entry['idle_share']:.3f})")
    DEFERRED_BUSY.clear()


def scale_chain(core, num_nodes: int = 100, num_microbatches: int = 10_000,
                b: int = 4) -> tuple:
    """The reference's engine-scaling chain
    (``benchmarks/sweep_grid.py::scale_instance``) from the port's own
    constructors: ``num_nodes`` identical stages, one per node (f = 100,
    no fixed latencies), links of 1e4 bytes/s, ``uniform_profile(fp=1,
    bp=1, act=1)``.  Returns (profile, net, solution, b, Q)."""
    S = num_nodes
    prof = core.uniform_profile(S, fp=1.0, bp=1.0, act=1.0)
    nodes = [core.Node("clients", f=100.0, t0=0.0, t1=0.0, b_th=0,
                       is_client=True)]
    nodes += [core.Node(f"s{i}", f=100.0, t0=0.0, t1=0.0, b_th=0)
              for i in range(1, S)]
    rate = np.full((S, S), 1e4)
    np.fill_diagonal(rate, 0.0)
    net = core.EdgeNetwork(nodes=nodes, rate=rate, num_clients=1)
    sol = core.SplitSolution(cuts=tuple(range(1, S + 1)),
                             placement=tuple(range(S)))
    return prof, net, sol, b, num_microbatches


def trace_chain(core, sim, num_nodes: int = 8,
                num_microbatches: int = 10_000, cv: float = 0.3,
                seed: int = 0) -> tuple:
    """The reference's trace chain (``benchmarks/bench_sim.py::
    trace_instance``): the scaling chain under a Gauss-Markov multiplier
    trace on every node and link (``dt = horizon / 256``)."""
    prof, net, sol, b, Q = scale_chain(core, num_nodes, num_microbatches)
    horizon = 4.0 * (num_microbatches / 50.0 + num_nodes)
    scen = sim.gauss_markov_scenario(net, cv, np.random.default_rng(seed),
                                     dt=horizon / 256, horizon=horizon)
    return prof, net, sol, b, Q, scen


def sim_phase(core, minplus, profile, net, plan) -> dict:
    """Phase 4d: the simulator's engines on the card (module docstring).
    Raises on any failed check; returns the walls, the peak device memory
    and K1's launches during the replanning run."""
    from repro_torch import ft, sim
    from repro_torch.core import latency as lat
    out = {}
    sol, b = plan.solution, plan.b
    # (a) the quickstart plan: both engines, three policies, two networks
    base = sim.simulate_plan(profile, net, sol, b, B=512, device="cuda")
    L = base.L_t
    gm = sim.gauss_markov_scenario(net, 0.3, np.random.default_rng(0),
                                   dt=L / 16, horizon=4 * L)
    quick = {}
    for scen_name, scen in (("constant", None), ("gauss_markov", gm)):
        for pol in ("fifo", "1f1b", "memory"):
            runs = {(eng, dev): sim.simulate_plan(
                profile, net, sol, b, B=512, scenario=scen, policy=pol,
                engine=eng, device=dev)
                for eng in ("event", "vectorized") for dev in ("cuda", "cpu")}
            vec = runs["vectorized", "cuda"]
            if vec.engine != "vectorized" or \
                    vec.mb_complete.device.type != "cuda":
                raise AssertionError(f"sim (a) {scen_name}/{pol}: the "
                                     "vectorized run did not stay on cuda")
            g_ev = sim_gap(runs["event", "cuda"].mb_complete,
                           vec.mb_complete)
            g_dev = max(sim_device_gap(runs[eng, "cuda"], runs[eng, "cpu"])
                        for eng in ("event", "vectorized"))
            if not (g_ev < SIM_ENGINE_TOL and g_dev <= SIM_DEVICE_RTOL):
                raise AssertionError(
                    f"sim (a) {scen_name}/{pol}: vectorized vs event "
                    f"{g_ev:.3e}, cuda vs cpu {g_dev:.3e}")
            quick[f"{scen_name}/{pol}"] = {
                "L_t": vec.L_t, "event_gap": g_ev, "cpu_gap": g_dev,
                "reason": vec.engine_reason}
            log(f"sim (a) quickstart {scen_name}/{pol}: Q="
                f"{vec.num_microbatches} L_t={vec.L_t!r}; vectorized vs "
                f"event {g_ev:.3e}, cuda vs cpu {g_dev:.3e} "
                f"({vec.engine_reason})")
    cv = sim.cross_validate(profile, net, sol, b, 512, rtol=SIM_EQ14_RTOL,
                            device="cuda")
    many = sim.cross_validate_many(20, rtol=SIM_EQ14_RTOL, device="cuda")
    if not (cv.ok and all(c.ok for c in many)):
        raise AssertionError(f"sim (a) cross_validate: {cv.max_rel_err}, "
                             f"{[c.max_rel_err for c in many]}")
    log(f"sim (a) cross_validate ok at rtol {SIM_EQ14_RTOL}: quickstart "
        f"{cv.max_rel_err:.3e}, cross_validate_many(20) worst "
        f"{max(c.max_rel_err for c in many):.3e}")
    out["quickstart"] = quick

    # (b) the engine-scaling chain: 100 nodes x 10,000 micro-batches
    prof_s, net_s, sol_s, b_s, Q_s = scale_chain(core)
    eq = (lat.fill_latency(prof_s, net_s, sol_s, b_s),
          lat.pipeline_interval(prof_s, net_s, sol_s, b_s),
          lat.total_latency(prof_s, net_s, sol_s, b_s, b_s * Q_s))
    scale = {}
    for pol in ("fifo", "1f1b"):
        def run(dev, Q=Q_s, pol=pol):
            return sim.simulate_plan(prof_s, net_s, sol_s, b_s,
                                     num_microbatches=Q, policy=pol,
                                     engine="vectorized", device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):
            rep, wall = timed(lambda: run("cuda"), "cuda")
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated()
        # the device's busy time in one run (profiler, kernels summed, two
        # sessions agreeing); under 1F1B, a chain of SIM_BUSY_Q
        # micro-batches beside its own wall: the 10,000-micro-batch run's
        # ~10^5 launches a session lose an event now and then
        busy_Q = Q_s if pol == "fifo" else SIM_BUSY_Q
        busy_wall = min(walls) if busy_Q == Q_s else min(
            timed(lambda: run("cuda", Q=busy_Q), "cuda")[1]
            for _ in range(2))
        cpu_rep, cpu_wall = timed(lambda: run("cpu"), "cpu")
        g_dev = sim_device_gap(rep, cpu_rep)
        got = (rep.T_f, rep.T_i, rep.L_t)
        rel = [abs(g - w) / abs(w) for g, w in zip(got, eq)]
        # Eq. (13)/(14) hold for FIFO admission; 1F1B's window on the last
        # stage serializes its FP and BP, so only Eq. (12)'s fill holds
        checked = rel if pol == "fifo" else rel[:1]
        if not (g_dev <= SIM_DEVICE_RTOL
                and max(checked) <= SIM_EQ14_RTOL):
            raise AssertionError(f"sim (b) {pol}: cuda vs cpu {g_dev:.3e}, "
                                 f"Eq. (12)-(14) rel {rel}")
        entry = {"walls_s": walls, "cpu_wall_s": cpu_wall,
                 "busy_microbatches": busy_Q, "busy_wall_s": busy_wall,
                 "peak_mib": peak / 2**20, "cpu_gap": g_dev,
                 "T_f": rep.T_f, "T_i": rep.T_i, "L_t": rep.L_t,
                 "eq_rel": rel, "reason": rep.engine_reason}
        if pol == "1f1b":
            # the window path against the heap at 200 micro-batches
            short = sim.compare_engines(prof_s, net_s, sol_s, b_s, 200,
                                        policy=pol, device="cuda")
            if not short < SIM_ENGINE_TOL:
                raise AssertionError(f"sim (b) 1f1b: vectorized vs event at "
                                     f"Q = 200 {short:.3e}")
            entry["event_gap_q200"] = short
        scale[pol] = entry
        defer_busy(f"4d (b) scaling chain {pol}, {busy_Q} micro-batches",
                   lambda r=run, q=busy_Q: r("cuda", Q=q), entry, busy_wall)
        log(f"sim (b) scaling chain 100 nodes x {Q_s} micro-batches "
            f"({Q_s * len(sim.build_visit_table(prof_s, net_s, sol_s, b_s))}"
            f" tasks), {pol}: T_f={rep.T_f!r} T_i={rep.T_i!r} "
            f"L_t={rep.L_t!r} (Eq. 12-14 rel {[f'{x:.2e}' for x in rel]}); "
            f"cuda vs cpu {g_dev:.3e}; wall on cuda "
            f"{[round(w, 4) for w in walls]} s (device busy after phase "
            f"27, at {busy_Q} micro-batches: {busy_wall:.4f} s),"
            f" on cpu {cpu_wall:.4f} s; peak device memory "
            f"{peak / 2**20:.1f} MiB"
            + (f"; vectorized vs event at Q = 200: "
               f"{entry['event_gap_q200']:.3e}" if pol == "1f1b" else ""))
        del rep, cpu_rep
    out["scale_chain"] = scale

    # (c) the Gauss-Markov trace chain: 8 nodes x 10,000 micro-batches
    prof_t, net_t, sol_t, b_t, Q_t, scen_t = trace_chain(core, sim)
    traced = {}
    for pol in ("fifo", "1f1b"):
        def run(eng, dev, pol=pol):
            return sim.simulate_plan(prof_t, net_t, sol_t, b_t,
                                     num_microbatches=Q_t, scenario=scen_t,
                                     policy=pol, engine=eng, device=dev)
        ev, ev_wall = timed(lambda: run("event", "cuda"), "cuda")
        vec, vec_wall = timed(lambda: run("vectorized", "cuda"), "cuda")
        vec_cpu, vec_cpu_wall = timed(lambda: run("vectorized", "cpu"),
                                      "cpu")
        g_ev = sim_gap(ev.mb_complete, vec.mb_complete)
        g_dev = sim_device_gap(vec, vec_cpu)
        if not (g_ev < SIM_ENGINE_TOL and g_dev <= SIM_DEVICE_RTOL):
            raise AssertionError(f"sim (c) {pol}: vectorized vs event "
                                 f"{g_ev:.3e}, cuda vs cpu {g_dev:.3e}")
        traced[pol] = {"event_wall_s": ev_wall, "vectorized_wall_s": vec_wall,
                       "vectorized_cpu_wall_s": vec_cpu_wall,
                       "event_gap": g_ev, "cpu_gap": g_dev,
                       "reason": vec.engine_reason}
        log(f"sim (c) trace chain 8 nodes x {Q_t}, Gauss-Markov cv 0.3, "
            f"{pol}: L_t={vec.L_t!r}; vectorized vs event {g_ev:.3e}, cuda "
            f"vs cpu {g_dev:.3e}; wall event {ev_wall:.3f} s, vectorized "
            f"{vec_wall:.4f} s on cuda (device busy after phase 27); "
            f"{vec_cpu_wall:.4f} s on cpu; {vec.engine_reason}")
        defer_busy(f"4d (c) trace chain {pol}",
                   lambda r=run: r("vectorized", "cuda"), traced[pol],
                   vec_wall)
        del ev, vec, vec_cpu
    out["trace_chain"] = traced

    # (d) simulate_plans over 64 candidate plans (b = 1..64)
    plans = [(sol, bb) for bb in range(1, 65)]
    stacked_runs = {}
    for pol in ("fifo", "1f1b"):
        stacked, st_wall = timed(lambda: sim.simulate_plans(
            profile, net, plans, B=512, policy=pol, device="cuda"), "cuda")
        looped, lp_wall = timed(lambda: [sim.simulate_plan(
            profile, net, s, bb, B=512, policy=pol, engine="auto",
            device="cuda") for s, bb in plans], "cuda")
        on_cpu = sim.simulate_plans(profile, net, plans, B=512, policy=pol,
                                    device="cpu")
        g_loop = max(sim_gap(lr.mb_complete, sr.mb_complete)
                     for lr, sr in zip(looped, stacked))
        g_dev = max(sim_gap(cr.mb_complete, sr.mb_complete)
                    for cr, sr in zip(on_cpu, stacked))
        if not all("stacked plan axis" in r.engine_reason for r in stacked):
            raise AssertionError(f"sim (d) {pol}: not stacked: "
                                 f"{stacked[0].engine_reason}")
        if not (g_loop <= SIM_DEVICE_RTOL and g_dev <= SIM_DEVICE_RTOL):
            raise AssertionError(f"sim (d) {pol}: stacked vs looped "
                                 f"{g_loop:.3e}, cuda vs cpu {g_dev:.3e}")
        stacked_runs[pol] = {"stacked_wall_s": st_wall,
                             "looped_wall_s": lp_wall, "looped_gap": g_loop,
                             "cpu_gap": g_dev}
        log(f"sim (d) simulate_plans, 64 plans (b = 1..64, B = 512), {pol}: "
            f"stacked vs looped {g_loop:.3e}, cuda vs cpu {g_dev:.3e}; wall "
            f"stacked {st_wall:.4f} s, 64 looped calls {lp_wall:.4f} s")
    out["simulate_plans"] = stacked_runs

    # (e) simulated-time replanning on the quickstart (K1 on the card)
    node = sol.placement[1]

    def triggers():
        return [sim.ReplanTrigger(0.4 * L, ft.Straggler(node, 6.0)),
                sim.ReplanTrigger(0.9 * L, ft.RateChange(0, node, 0.5))]

    minplus.sweep_minplus.launches = 0
    rr, rr_wall = timed(lambda: sim.simulate_with_replanning(
        profile, net, 512, triggers(), device="cuda"), "cuda")
    k1_launches = minplus.sweep_minplus.launches
    rc, rc_wall = timed(lambda: sim.simulate_with_replanning(
        profile, net, 512, triggers(), device="cpu"), "cpu")

    def seg_key(rep):
        return [(s.plan.solution.cuts, s.plan.solution.placement, s.plan.b,
                 s.completed, s.cutoff) for s in rep.segments]

    if not (rr.num_replans == rc.num_replans == 2
            and seg_key(rr) == seg_key(rc)
            and abs(rr.makespan - rc.makespan)
            <= SIM_DEVICE_RTOL * abs(rc.makespan) and k1_launches > 0):
        raise AssertionError(f"sim (e): {rr.num_replans} replans, segments "
                             f"{seg_key(rr)} vs cpu {seg_key(rc)}, makespan "
                             f"{rr.makespan} vs {rc.makespan}, K1 launches "
                             f"{k1_launches}")
    out["replan"] = {"wall_s": rr_wall, "cpu_wall_s": rc_wall,
                     "makespan": rr.makespan, "replans": rr.num_replans,
                     "k1_launches": k1_launches,
                     "segments": [list(map(list, k[:2])) + list(k[2:])
                                  for k in seg_key(rr)]}
    log(f"sim (e) simulate_with_replanning (quickstart, B = 512; "
        f"Straggler({node}, 6) at 0.4 L_t, RateChange(0, {node}, 0.5) at "
        f"0.9 L_t): {rr.num_replans} replans, segments {seg_key(rr)} equal "
        f"to the CPU run's, makespan {rr.makespan!r} (undisturbed "
        f"{L!r}); K1 launches {k1_launches}; wall {rr_wall:.3f} s on cuda, "
        f"{rc_wall:.3f} s on cpu")
    return out


#: phase 4e: the reference's CVaR-selection grid (bench_robustness.py:99-108)
#: and its policy zoo (bench_ft_policy.py::run_zoo)
CVAR_SEEDS = (3, 5, 9, 12)
CVAR_ALPHA = 0.95
CVAR_SCENARIOS = 16
FUZZ_TRIALS = 500
ZOO_STREAMS = 10
ZOO_SOLVE_DOWNTIME = 0.05
ZOO_REMAP_PENALTY = 0.01


def rel_gap(a: float, b: float) -> float:
    """Relative gap of two floats (0 when equal, inf included)."""
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def plan_gap(got, want) -> tuple:
    """(same plan?, objective gap) of two ``core.Plan``s: cuts, placement,
    b, iterations and the history's plans equal; the objectives (and the
    history's) within a relative gap."""
    same = ((got.solution.cuts, got.solution.placement, got.b,
             got.iterations, got.feasible, got.cost_model)
            == (want.solution.cuts, want.solution.placement, want.b,
                want.iterations, want.feasible, want.cost_model)
            and [h[1:] for h in got.history] == [h[1:] for h in want.history])
    gap = max([rel_gap(got.objective, want.objective)]
              + [rel_gap(g[0], w[0]) for g, w in zip(got.history,
                                                     want.history)])
    return same, gap


def candidate_pool(core, prof, net, B, b_ref, K=3, cap=8):
    """``bench_robustness.py::_candidate_pool``: the best closed-form b per
    distinct placement, then the ``cap`` best placements."""
    cm = core.ClosedForm()
    b_choices = sorted({1, max(1, b_ref // 2), b_ref})
    raw = [(sol, b) for sol in core.enumerate_solutions(prof, net, K)
           for b in b_choices]
    best: dict = {}
    for (sol, b), v in zip(raw, cm.evaluate_many(prof, net, raw, B)):
        if math.isfinite(v) and (sol.placement not in best
                                 or v < best[sol.placement][0]):
            best[sol.placement] = (v, sol, b)
    ranked = sorted(best.values(), key=lambda t: t[0])[:cap]
    return [(sol, b) for _v, sol, b in ranked], [v for v, _s, _b in ranked]


def cvar_grid(core, sim):
    """The reference's CVaR-selection grid: random_instance 3, 5, 9, 12 and
    the 4-server paper network at B = 64."""
    for seed in CVAR_SEEDS:
        prof, net, _sol, b, B = sim.random_instance(seed)
        yield f"random_{seed}", seed, prof, net, b, B
    prof = core.vgg16_profile(work_units="bytes")
    net = core.make_edge_network(num_servers=4, num_clients=4, seed=1,
                                 kappa=1 / 32.0, bw_range_hz=(10e6, 50e6))
    plan = core.bcd_solve(prof, net, B=64, device="cpu")
    yield "paper_4srv", 1, prof, net, max(1, plan.b), 64


def cvar_select(core, sim, seed, prof, net, b_ref, B, device):
    """One instance of ``bench_robustness.py::run_cvar`` on ``device``:
    (closed pick, robust pick, robust objectives, closed CVaR, robust
    CVaR, the closed pick's worst-blocked resource)."""
    cands, closed_vals = candidate_pool(core, prof, net, B, b_ref)
    ci = min(range(len(cands)), key=lambda i: closed_vals[i])
    c_sol, c_b = cands[ci]
    cfg = sim.FuzzConfig(families=("adversarial", "outage", "degradation",
                                   "flapping"))
    scens = list(sim.scenario_distribution(
        net, CVAR_SCENARIOS, seed=seed, profile=prof, sol=c_sol, b=c_b,
        num_microbatches=max(1, B // c_b), config=cfg))
    width = sim.simulate_plan(prof, net, c_sol, c_b, B=B, engine="auto",
                              device=device).L_t
    if len(c_sol.placement) > 1 and math.isfinite(width):
        a, c = c_sol.placement[0], c_sol.placement[1]
        scens.append(sim.NetworkScenario().with_outage(
            a, c, 0.1 * width, 1.1 * width, both_directions=True))
    robust = sim.RobustMakespan(scenarios=scens, alpha=CVAR_ALPHA,
                                risk_aversion=1.0, device=device)
    r_vals = robust.evaluate_many(prof, net, cands, B)
    ri = min(range(len(cands)), key=lambda i: r_vals[i])
    c_rep = sim.score_plan(prof, net, c_sol, c_b, B=B, scenarios=scens,
                           alpha=CVAR_ALPHA, device=device)
    r_rep = sim.score_plan(prof, net, *cands[ri], B=B, scenarios=scens,
                           alpha=CVAR_ALPHA, attribution=False,
                           device=device)
    top = c_rep.top_blocked(1)
    return {"candidates": len(cands), "closed": ci, "robust": ri,
            "robust_values": r_vals, "closed_cvar": c_rep.cvar,
            "robust_cvar": r_rep.cvar, "closed_nominal": c_rep.nominal,
            "closed_b": c_b, "robust_b": cands[ri][1],
            "top_blocked": repr(top[0][0]) if top else ""}


def zoo(ft, sim, device):
    """``bench_ft_policy.py::run_zoo`` (full corpus) plus AdaptiveCadence,
    on ``device``: the reports and the launches of K1 are the caller's."""
    prof, net, _sol, _b, B = sim.random_instance(3)
    streams = [sim.fuzz_event_stream(np.random.default_rng(1000 + s), net,
                                     horizon=4.0, max_events=5,
                                     allow_failure=False, flap_fraction=0.75)
               for s in range(ZOO_STREAMS)]
    policies = {
        "eager": lambda: None,
        "ride_out": ft.RideOut,
        "periodic_0.5": lambda: ft.Periodic(0.5),
        "hysteresis": lambda: ft.RateLimited(ft.Hysteresis(0.25,
                                                           cooldown=0.3)),
        "cvar_pre_spill": lambda: ft.CVaRPreSpill(bound=1.5, n_scenarios=4,
                                                  device=device),
        "adaptive": ft.AdaptiveCadence,
    }
    return ft.evaluate_policies(prof, net, B, streams, policies, alpha=0.9,
                                remap_penalty=ZOO_REMAP_PENALTY,
                                solve_downtime=ZOO_SOLVE_DOWNTIME,
                                attribution=True, device=device)


def zoo_row(r) -> dict:
    return {**r.row(), "makespans": list(r.makespans),
            "final_objectives": list(r.final_objectives),
            "blocked": {repr(k): v for k, v in (r.blocked or {}).items()}}


def planning_phase(core, minplus, profile, net, plan, out_dir) -> dict:
    """Phase 4e: planning scored by the simulator and by tail risk, the
    fuzz campaign, the replan policies, the Chrome trace and a checkpoint,
    on the card against the port's CPU results (module docstring).
    Raises on any failed check; returns walls, gaps and K1's launches."""
    from repro_torch import checkpoint, ft, obs, sim
    from repro_torch.pipeline import SplitLearningExecutor
    out = {}
    k1 = minplus.sweep_minplus

    # (a) simulator-scored planning on the quickstart
    k1.launches = 0
    got, wall = timed(lambda: core.sim_refined(profile, net, 512, b0=20,
                                               device="cuda"), "cuda")
    launches = k1.launches
    want, cpu_wall = timed(lambda: core.sim_refined(profile, net, 512, b0=20,
                                                    device="cpu"), "cpu")
    same, gap = plan_gap(got, want)
    if not (same and gap <= SIM_DEVICE_RTOL and launches > 0):
        raise AssertionError(f"4e (a) sim_refined: cuda {got} vs cpu {want} "
                             f"(objective gap {gap:.3e}, K1 launches "
                             f"{launches})")
    cm = core.SimMakespan(device="cuda")
    box = [b for b, ok in zip(range(1, 513), cm.memory_feasible_many(
        profile, net, got.solution, range(1, 513))) if ok]
    cands = [(got.solution, b) for b in box]
    many, many_wall = timed(lambda: cm.evaluate_many(profile, net, cands,
                                                     512), "cuda")
    looped, loop_wall = timed(lambda: [cm.evaluate(profile, net, s, b, 512)
                                       for s, b in cands], "cuda")
    cpu_many = core.SimMakespan(device="cpu").evaluate_many(profile, net,
                                                            cands, 512)
    reasons = sorted({r.engine_reason for r in sim.simulate_plans(
        profile, net, cands, B=512, policy=cm.policy, device="cuda")})
    g_loop = max(rel_gap(a, b) for a, b in zip(many, looped))
    g_dev = max(rel_gap(a, b) for a, b in zip(many, cpu_many))
    if not (g_loop == 0.0 and g_dev <= SIM_DEVICE_RTOL):
        raise AssertionError(f"4e (a) SimMakespan over {len(box)} b: "
                             f"stacked vs looped {g_loop:.3e}, cuda vs cpu "
                             f"{g_dev:.3e}")
    out["sim_refined"] = {
        "cuts": list(got.solution.cuts),
        "placement": list(got.solution.placement), "b": got.b,
        "objective": got.objective, "L_t": got.L_t, "wall_s": wall,
        "cpu_wall_s": cpu_wall, "k1_launches": launches,
        "box": len(box), "evaluate_many_wall_s": many_wall,
        "evaluate_many": {},
        "engine_reasons": reasons, "looped_wall_s": loop_wall,
        "looped_gap": g_loop, "cpu_gap": g_dev}
    log(f"4e (a) sim_refined (quickstart, B = 512): cuts={got.solution.cuts} "
        f"placement={got.solution.placement} b={got.b} objective "
        f"{got.objective!r} (equal to the CPU's); K1 launches {launches}; "
        f"wall {wall:.3f} s on cuda, {cpu_wall:.3f} s on cpu; "
        f"SimMakespan.evaluate_many over the feasible box ({len(box)} b, "
        f"one simulate_plans: {reasons}) {many_wall:.3f} s vs {len(box)} "
        f"looped evaluate {loop_wall:.3f} "
        f"s: gap {g_loop:.3e}, cuda vs cpu {g_dev:.3e}")
    defer_busy(f"4e (a) evaluate_many over {len(box)} b",
               lambda: cm.evaluate_many(profile, net, cands, 512),
               out["sim_refined"]["evaluate_many"], many_wall)

    # (b) the fluctuation report in trace mode
    fluct = {}
    for model in ("piecewise", "gauss_markov"):
        rep, f_wall = timed(lambda: core.evaluate_under_fluctuation(
            profile, net, got, 0.2, draws=16, mode="trace",
            trace_model=model, device="cuda"), "cuda")
        ref = core.evaluate_under_fluctuation(
            profile, net, want, 0.2, draws=16, mode="trace",
            trace_model=model, device="cpu")
        if dataclasses.asdict(rep) != dataclasses.asdict(ref):
            raise AssertionError(f"4e (b) {model}: cuda {rep} vs cpu {ref}")
        fluct[model] = {**dataclasses.asdict(rep), "wall_s": f_wall}
        log(f"4e (b) fluctuation, trace mode ({model}, cv 0.2, 16 draws): "
            f"mean {rep.mean_latency!r}, p95 {rep.p95_latency!r}, "
            f"degradation {rep.degradation!r} (equal to the CPU's); wall "
            f"{f_wall:.3f} s")
    out["fluctuation"] = fluct

    # (c) the fuzz campaign (vectorized on the card, heap on the host)
    fz, fz_wall = timed(lambda: sim.run_fuzz(FUZZ_TRIALS, seed=0,
                                             device="cuda"), "cuda")
    fz_cpu, fz_cpu_wall = timed(lambda: sim.run_fuzz(FUZZ_TRIALS, seed=0,
                                                     device="cpu"), "cpu")
    if not (fz.ok and fz.max_gap <= SIM_ENGINE_TOL and fz.vectorized > 0
            and (fz.vectorized, fz.event_fallback)
            == (fz_cpu.vectorized, fz_cpu.event_fallback)):
        raise AssertionError(f"4e (c) run_fuzz({FUZZ_TRIALS}): "
                             f"{len(fz.failures)} failures, max gap "
                             f"{fz.max_gap:.3e}, {fz.vectorized} / "
                             f"{fz.event_fallback} vs cpu "
                             f"{fz_cpu.vectorized} / {fz_cpu.event_fallback}")
    corpus = sim.load_corpus(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "corpus"))
    if not corpus:
        raise AssertionError("4e (c): tests/corpus holds no case")
    replayed = {}
    for path, case in corpus:
        res = sim.check_parity(case, device="cuda")
        ok = res.ok if case.scenario.drains() else \
            (res.engine == "event" and res.gap == 0.0)
        if not ok:
            raise AssertionError(f"4e (c) corpus {path}: {res}")
        replayed[os.path.basename(path)] = {"engine": res.engine,
                                            "gap": res.gap}
    out["fuzz"] = {"trials": FUZZ_TRIALS, "vectorized": fz.vectorized,
                   "event_fallback": fz.event_fallback,
                   "max_gap": fz.max_gap, "cpu_max_gap": fz_cpu.max_gap,
                   "wall_s": fz_wall, "cpu_wall_s": fz_cpu_wall,
                   "corpus": replayed}
    log(f"4e (c) run_fuzz({FUZZ_TRIALS}, seed=0): {fz.vectorized} "
        f"vectorized on cuda, {fz.event_fallback} event fallbacks, 0 "
        f"failures, max gap {fz.max_gap:.3e} (cpu {fz_cpu.max_gap:.3e}); "
        f"wall {fz_wall:.3f} s (all on cpu {fz_cpu_wall:.3f} s); corpus "
        f"replayed on cuda: {replayed}")

    # (d) CVaR plan selection, the reference's grid and acceptance
    grid = {}
    for name, seed, prof, gnet, b_ref, B in cvar_grid(core, sim):
        row, g_wall = timed(lambda: cvar_select(core, sim, seed, prof, gnet,
                                                b_ref, B, "cuda"), "cuda")
        ref = cvar_select(core, sim, seed, prof, gnet, b_ref, B, "cpu")
        g = max(rel_gap(a, b) for a, b in zip(row["robust_values"],
                                              ref["robust_values"]))
        if (row["closed"], row["robust"]) != (ref["closed"], ref["robust"]) \
                or g > SIM_DEVICE_RTOL:
            raise AssertionError(
                f"4e (d) {name}: picks cuda ({row['closed']}, "
                f"{row['robust']}) vs cpu ({ref['closed']}, "
                f"{ref['robust']}); robust objectives cuda "
                f"{row['robust_values']} vs cpu {ref['robust_values']}")
        row.update(wall_s=g_wall, cpu_gap=g)
        grid[name] = row
        log(f"4e (d) {name}: {row['candidates']} candidates; closed pick "
            f"{row['closed']} (b {row['closed_b']}) CVaR0.95 "
            f"{row['closed_cvar']!r}, robust pick {row['robust']} (b "
            f"{row['robust_b']}) CVaR0.95 {row['robust_cvar']!r} (equal "
            f"picks on the CPU, objectives within {g:.3e}); closed pick's "
            f"worst-blocked {row['top_blocked']}; wall {g_wall:.3f} s")
    rows = list(grid.values())
    if not (all(r["robust_cvar"] <= r["closed_cvar"] * (1 + 1e-9)
                for r in rows)
            and any(r["robust_cvar"] < r["closed_cvar"] * (1 - 1e-9)
                    for r in rows)):
        raise AssertionError(f"4e (d) acceptance: {rows}")
    k1.launches = 0
    robust_cm = sim.RobustMakespan(n_scenarios=12, device="cuda")
    rb, rb_wall = timed(lambda: core.bcd_solve(profile, net, 512,
                                               cost_model=robust_cm,
                                               device="cuda"), "cuda")
    rb_launches = k1.launches
    # no device busy time here: the solve launches a few kernels more or
    # less on every call (42,521-42,531 kernel events in six profiled
    # solves), so no profiler session of it can be checked for lost events
    rb_cpu, rb_cpu_wall = timed(lambda: core.bcd_solve(
        profile, net, 512, cost_model=sim.RobustMakespan(n_scenarios=12,
                                                         device="cpu"),
        device="cpu"), "cpu")
    same, rb_gap = plan_gap(rb, rb_cpu)
    if not (same and rb_gap <= SIM_DEVICE_RTOL and rb_launches > 0):
        raise AssertionError(f"4e (d) robust bcd_solve: cuda {rb} vs cpu "
                             f"{rb_cpu} (gap {rb_gap:.3e}), K1 launches "
                             f"{rb_launches}")
    out["cvar"] = {"grid": grid, "strict_wins": sum(
        r["robust_cvar"] < r["closed_cvar"] * (1 - 1e-9) for r in rows),
        "robust_bcd": {"cuts": list(rb.solution.cuts),
                       "placement": list(rb.solution.placement), "b": rb.b,
                       "objective": rb.objective, "cpu_gap": rb_gap,
                       "wall_s": rb_wall, "cpu_wall_s": rb_cpu_wall,
                       "k1_launches": rb_launches}}
    log(f"4e (d) acceptance: robust CVaR0.95 <= closed on all {len(rows)} "
        f"instances, < on {out['cvar']['strict_wins']}; bcd_solve(quickstart"
        f", B = 512, RobustMakespan(n_scenarios=12)): cuts={rb.solution.cuts}"
        f" placement={rb.solution.placement} b={rb.b} objective "
        f"{rb.objective!r} (cpu gap {rb_gap:.3e}); K1 launches "
        f"{rb_launches}; wall {rb_wall:.3f} s on cuda, {rb_cpu_wall:.3f} s "
        f"on cpu")

    # (e) the policy zoo
    k1.launches = 0
    reps, z_wall = timed(lambda: zoo(ft, sim, "cuda"), "cuda")
    z_launches = k1.launches
    cpu_reps, z_cpu_wall = timed(lambda: zoo(ft, sim, "cpu"), "cpu")
    for name, r in reps.items():
        c = cpu_reps[name]
        if (r.replans, r.suppressed, r.final_objectives, r.downtime,
                r.eval_errors) != (c.replans, c.suppressed,
                                   c.final_objectives, c.downtime,
                                   c.eval_errors) or max(
                rel_gap(a, b) for a, b in zip(r.makespans, c.makespans)) \
                > SIM_DEVICE_RTOL:
            raise AssertionError(f"4e (e) {name}: cuda {r} vs cpu {c}")
    eager, ride, hyst = reps["eager"], reps["ride_out"], reps["hysteresis"]
    if not (eager.replans > 0 and hyst.replans <= 0.25 * eager.replans
            and hyst.mean <= eager.mean * (1 + 1e-9)
            and np.mean(hyst.final_objectives)
            <= np.mean(ride.final_objectives) * (1 + 1e-9)
            and z_launches > 0):
        raise AssertionError(f"4e (e) acceptance: eager {eager.row()}, "
                             f"hysteresis {hyst.row()}, ride-out "
                             f"{ride.row()}, K1 launches {z_launches}")
    out["zoo"] = {"policies": {n: zoo_row(r) for n, r in reps.items()},
                  "wall_s": z_wall, "cpu_wall_s": z_cpu_wall,
                  "k1_launches": z_launches}
    for n, r in reps.items():
        log(f"4e (e) zoo {n}: mean {r.mean!r} cvar0.9 {r.cvar!r} replans "
            f"{r.replans} suppressed {r.suppressed} final objective "
            f"{float(np.mean(r.final_objectives))!r}")
    log(f"4e (e) zoo ({ZOO_STREAMS} flap streams, 6 policies): equal to the "
        f"CPU's; hysteresis {hyst.replans} replans vs eager {eager.replans}; "
        f"K1 launches {z_launches}; wall {z_wall:.3f} s on cuda, "
        f"{z_cpu_wall:.3f} s on cpu")

    # (f) Chrome trace and checkpoint
    traces = {}
    for dev in ("cuda", "cpu"):
        rep = sim.simulate_plan(profile, net, plan.solution, plan.b, B=512,
                                engine="vectorized", device=dev)
        path = sim.write_chrome_trace(
            rep.records, os.path.join(out_dir, f"trace_{dev}.json"),
            counter_tracks=True, flow_events=True)
        with open(path) as f:
            traces[dev] = json.load(f)
    errs = obs.validate_chrome_trace(traces["cuda"])
    if errs or traces["cuda"] != traces["cpu"]:
        raise AssertionError(f"4e (f) trace: {errs[:3]}, equal to cpu "
                             f"{traces['cuda'] == traces['cpu']}")
    ex = SplitLearningExecutor(plan, profile, net, seed=0, device="cuda")
    tree = [[dict(m.state_dict()) for m in stage]
            for stage in ex.stage_params()]
    like = [[{k: torch.zeros_like(v) for k, v in m.items()} for m in stage]
            for stage in tree]
    ckpt_dir = os.path.join(out_dir, "ckpt")
    store = checkpoint.CheckpointStore(ckpt_dir, keep=1)
    _, save_wall = timed(lambda: (store.save(1, tree), store.wait()), "cuda")
    (back, meta), restore_wall = timed(
        lambda: store.restore_latest(like, device="cuda"), "cuda")
    flat = [(m1[k], m2[k]) for s1, s2 in zip(tree, back)
            for m1, m2 in zip(s1, s2) for k in m1]
    if not (all(b.device.type == "cuda" and torch.equal(a, b)
                for a, b in flat) and meta["step"] == 1):
        raise AssertionError("4e (f) checkpoint: restore is not bitwise")
    estimate = checkpoint.estimate_restore_seconds(ckpt_dir)
    coord = ft.Coordinator(profile, net, 512, device="cuda",
                           restore_cost=lambda: checkpoint.
                           estimate_restore_seconds(ckpt_dir))
    failed = coord.apply(ft.NodeFailure(1))
    moved = coord.apply(ft.RateChange(0, 1, 0.5))
    if not (failed.restore_seconds == estimate > 0
            and moved.restore_seconds == 0.0):
        raise AssertionError(f"4e (f) restore charge {failed.restore_seconds}"
                             f" vs estimate {estimate}, rate change "
                             f"{moved.restore_seconds}")
    n_events = len(traces["cuda"]["traceEvents"])
    out["trace_checkpoint"] = {
        "trace_events": n_events, "leaves": len(flat),
        "bytes": meta["bytes"], "save_wall_s": save_wall,
        "restore_wall_s": restore_wall, "estimate_s": estimate}
    log(f"4e (f) Chrome trace of the quickstart plan's run: {n_events} "
        f"events, valid, equal to the CPU's; checkpoint of the executor's "
        f"{len(tree)} VGG-16 stages ({len(flat)} tensors, {meta['bytes']} "
        f"bytes) saved from cuda in {save_wall:.3f} s, restored onto it "
        f"bitwise in {restore_wall:.3f} s; NodeFailure charged "
        f"{failed.restore_seconds!r} s (= estimate_restore_seconds), the "
        f"rate change 0")
    del ex, tree, back, like, flat
    return out


#: phase 28: the paper's stage pipeline (pipeline/spmd.py) on the card:
#: qwen3-0.6b at full width and depth over (data 2 x stage 2), four
#: processes sharing the one GPU under gloo (NCCL refuses two ranks on a
#: GPU), each holding its stage's layers in their FSDP blocks over the two
#: data ranks (gathered once a step, their gradients reduce-scattered); a
#: batch of 16 x 512 tokens, 8 rows a data rank as phase 28 ran on one
#: before; Q from the stage planner on the batch a data rank scores
SPMD_RUN = {"arch": "qwen3-0.6b", "data": 2, "stages": 2, "batch": 16,
            "seq": 512, "lr": 1e-3, "steps": 2, "seed": 0}
#: pipelined against plain on the card, float32 with TF32 off: the loss
#: relative to its size, each gradient and each updated parameter relative
#: to its tensor's largest magnitude (the reference's own pipeline test
#: keeps 1e-5 / 1e-4, tests/test_spmd.py)
SPMD_LOSS_REL, SPMD_REL = 1e-5, 1e-4
#: the pipelined train step against AdamW applied to the gradients that
#: step computed, every element relative to its tensor's largest
#: magnitude: float32 rounding of the same formula (tests/
#: test_torch_spmd.py keeps the same bound against the reference's AdamW)
SPMD_STEP_REL = 1e-6
#: the step against the plain step (launch/steps.py) is held where the
#: plain gradient is at least this large: AdamW's first step is g / (|g| +
#: 1e-8), so below it a rounding of the gradient moves the step by a
#: visible share of the rate; the elements below are counted
SPMD_STEP_GRAD_MIN = 1e-6
#: seconds the parent waits for the four ranks
SPMD_TIMEOUT_S = 600
#: profiled steps a rank runs for its device busy time
SPMD_PROFILED = 3


def _flat_tree(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _stage_part(key, full, k, stages):
    """The part of the whole tree's leaf ``key`` that stage k holds."""
    if not key.startswith("layers/"):
        return full
    n = full.shape[0] // stages
    return full[k * n:(k + 1) * n]


def _block_part(cfg, layout, key, full, d, k, m, S):
    """Rank (data d, stage k, model m)'s block of the whole tree's leaf
    ``key``, as ``shard_params`` cuts it: the model and data dims
    ``pipeline/spmd.py::block_dims`` names on the whole shape, then the
    stage's rows."""
    from repro_torch.pipeline.spmd import block_dims
    sizes = {"model": layout.shape.get("model", 1),
             "data": layout.shape.get("pod", 1) * layout.shape.get("data", 1)}
    for dim, i, axis in zip(block_dims(cfg, layout, key, tuple(full.shape)),
                            (m, d), ("model", "data")):
        if dim is not None:
            n = full.shape[dim] // sizes[axis]
            full = full.narrow(dim, i * n, n)
    return _stage_part(key, full, k, S)


def derived_spmd_launches(Q: int, S: int, layers_per_stage: int,
                          remat: str) -> dict:
    """K2 (forward) and K2' (backward) launches one stage rank makes in a
    pipelined loss and its gradient: every one of the T = Q + S - 1 ticks
    runs the stage's layers, once more in the backward under remat
    "layer"."""
    fwd = (Q + S - 1) * layers_per_stage
    return {"flash_attention": fwd * (2 if remat == "layer" else 1),
            "flash_attention_bwd": fwd}


def step_busy(run_step, sessions_to_run: int = SPMD_PROFILED) -> dict:
    """A pipelined step's device busy time on this rank:
    ``sessions_to_run`` profiled steps (the same number on every rank: a
    step is a
    collective), kept from two sessions that count the same kernel events
    at the largest count seen (a step launches the same kernels every
    time; a lost event shows as a difference); with the top kernels and
    K2's mean span.  Two or more processes time-slice the card, so a
    kernel's recorded span can hold another rank's slices."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out, sessions = {}, []
    for _ in range(sessions_to_run):
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            _probe()
            run_step()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and _kernel_name(e.name) != PROBE_KERNEL]
        counts, split = {}, {}
        for e in kernels:
            name = _kernel_name(e.name)
            counts[name] = counts.get(name, 0) + 1
            split[name] = split.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        sessions.append((sum(e.time_range.elapsed_us() for e in kernels)
                         / 1e3, counts, split))
    out["busy_sessions_ms"] = [ms for ms, _, _ in sessions]
    out["busy_sessions_kernels"] = [sum(c.values()) for _, c, _ in sessions]
    most = max(sum(c.values()) for _, c, _ in sessions)
    pair = next(((i, j) for i in range(len(sessions))
                 for j in range(i + 1, len(sessions))
                 if sessions[i][1] == sessions[j][1]
                 and sum(sessions[i][1].values()) == most), None)
    out["busy_sessions_agree"] = pair is not None
    if pair is None:
        _, first, split = sessions[0]
        out["busy_sessions_differ"] = {
            n: [c.get(n, 0) for _, c, _ in sessions]
            for n in sorted(set().union(*(c for _, c, _ in sessions)))
            if len({c.get(n, 0) for _, c, _ in sessions}) > 1}
        out["busy_ms"] = []
    else:
        out["busy_ms"] = [sessions[i][0] for i in pair]
        _, first, split = sessions[pair[0]]
    out["kernels_a_step"] = sum(first.values())
    top = sorted(split, key=split.get, reverse=True)[:6]
    out["top_kernels"] = {n: {"ms": split[n], "calls": first[n],
                              "mean_ms": split[n] / first[n]} for n in top}
    k2 = "flash_fwd_mma_kernel"
    if k2 in split:
        out["k2_mean_ms"] = split[k2] / first[k2]
    return out


def _spmd_blocks_bytes(cfg, layout, k: int, S: int) -> int:
    """Bytes of rank (data 0, stage k)'s blocks of ``cfg``'s parameters and
    their AdamW state on ``layout`` (float32: the parameter, m and v), from
    the shapes (meta tensors), with AdamW's int32 step count."""
    from repro_torch.configs import param_specs
    specs = _flat_tree(param_specs(cfg))
    n = sum(_block_part(cfg, layout, key, t, 0, k, 0, S).numel()
            for key, t in specs.items())
    return 3 * 4 * n + 4


def _spmd_work(rank: int, job: dict) -> dict:
    """Phase 28 on one rank of (data D x stage S): correctness in float32,
    then the timed bfloat16 steps."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.kernels import flash as flash_mod
    from repro_torch.launch.mesh import MeshLayout, build_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import nest_layers
    from repro_torch.models.registry import get_model
    from repro_torch.optim import get_optimizer
    from repro_torch.utils import tree_leaves, tree_map
    from repro_torch.pipeline.spmd import (PipelineConfig,
                                           make_pipelined_loss,
                                           make_pipelined_train_step,
                                           shard_params)
    D, S, Q, B, L = (job["data"], job["stages"], job["q"], job["batch"],
                     job["seq"])
    pcfg = PipelineConfig(S, Q)
    layout = MeshLayout(("data", "stage"), (D, S))
    mesh = build_mesh(layout, "cuda")
    d, k = divmod(rank, S)                 # the mesh's ranks, row-major
    base = get_config(job["arch"])
    batch = next(token_lm_batches(batch=B, seq_len=L, vocab=base.vocab,
                                  seed=job["seed"]))
    batch = {n: torch.as_tensor(v, device="cuda") for n, v in batch.items()}
    out = {"rank": rank, "data": d, "stage": k}

    def whole_tree(model):
        return nest_layers({n: p.detach().clone()
                            for n, p in model.named_parameters()},
                           torch.stack)

    # float32, TF32 off: pipelined against plain on this card.  The plain
    # model's loss, gradient and AdamW step run one rank at a time (each
    # holds the whole model, its gradient and moments meanwhile), each
    # keeping its blocks of them
    cfg32 = dataclasses.replace(base, compute_dtype=torch.float32)
    opt = get_optimizer("adamw", lr=job["lr"])

    def part(key, full):
        return _block_part(cfg32, layout, key, full, d, k, 0, S).clone()

    plain = {}
    for turn in range(D * S):
        if turn == rank:
            gen = torch.Generator(device="cuda").manual_seed(job["seed"])
            model = tf.init_params(cfg32, gen, "cuda")
            tree = whole_tree(model)
            named = dict(model.named_parameters())
            loss0 = get_model(cfg32, "cuda").loss(model, batch)
            g0 = dict(zip(named, torch.autograd.grad(
                loss0, list(named.values()))))
            plain["loss"] = loss0.item()
            plain["grads"] = {key: part(key, g) for key, g in _flat_tree(
                nest_layers(g0, torch.stack)).items()}
            del g0, loss0
            plain_step = make_train_step(cfg32, opt, Q, "cuda")
            model, _, _ = plain_step(model, opt.init(named), batch)
            plain["stepped"] = {key: part(key, p) for key, p in
                                _flat_tree(whole_tree(model)).items()}
            del model, named, plain_step
            torch.cuda.empty_cache()
        dist.barrier()
    local = shard_params(tree, mesh, pcfg, "cuda", cfg=cfg32)
    loss_fn = make_pipelined_loss(cfg32, mesh, pcfg, "cuda")
    if (loss_fn.pipe.d, loss_fn.pipe.k) != (d, k):
        raise AssertionError(f"rank {rank} is (data {loss_fn.pipe.d}, stage "
                             f"{loss_fn.pipe.k}), not ({d}, {k})")
    out.update(backend=loss_fn.pipe.backend,
               transport=loss_fn.pipe.transport)
    loss = loss_fn(local, batch)
    leaves = _flat_tree(local)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    out["loss"], out["plain_loss"] = loss.item(), plain["loss"]
    out["loss_rel"] = abs(out["loss"] - out["plain_loss"]) \
        / abs(out["plain_loss"])
    out["grad_rel"] = {}
    for key, g in grads.items():
        want = plain["grads"][key]
        if g.shape != want.shape:
            raise AssertionError(f"{key}: block {tuple(g.shape)} against "
                                 f"{tuple(want.shape)}")
        out["grad_rel"][key] = float((g - want).abs().max()
                                     / want.abs().max())
    del loss, grads, leaves, local, loss_fn
    # one AdamW step each way from the same weights.  The pipelined step
    # hands its optimizer the block gradients it computed: they are held to
    # the plain ones, and the step's every element to AdamW applied to them
    local = shard_params(tree, mesh, pcfg, "cuda", cfg=cfg32)
    del tree
    seen = {}

    def recorded(params, grads, state):
        seen["before"] = tree_map(lambda p: p.detach().clone(), params)
        seen["grads"] = tree_map(torch.clone, grads)
        return opt.update(params, grads, state)

    pipe_step = make_pipelined_train_step(
        cfg32, mesh, pcfg, dataclasses.replace(opt, update=recorded), "cuda")
    local, _, _ = pipe_step(local, opt.init(local), batch)
    adamw = opt.update(seen["before"], seen["grads"],
                       opt.init(seen["before"]))[0]
    adamw, step_grads = _flat_tree(adamw), _flat_tree(seen["grads"])
    out["step_rel"], out["step_grad_rel"] = {}, {}
    out["step_plain_rel"], out["step_small_grad"] = {}, {}
    for key, p in _flat_tree(local).items():
        p = p.detach()
        out["step_rel"][key] = float((p - adamw[key]).abs().max()
                                     / adamw[key].abs().max())
        g = plain["grads"][key]
        out["step_grad_rel"][key] = float((step_grads[key] - g).abs().max()
                                          / g.abs().max())
        # against the plain step where AdamW's first step is well
        # conditioned (SPMD_STEP_GRAD_MIN); the rest is only counted
        want = plain["stepped"][key]
        held = g.abs() >= SPMD_STEP_GRAD_MIN
        diff = torch.where(held, (p - want).abs(), 0.0)
        out["step_plain_rel"][key] = float(diff.max() / want.abs().max())
        out["step_small_grad"][key] = int((~held).sum())
    seen.clear()                      # the closure `recorded` keeps it
    del local, plain, pipe_step, adamw, step_grads, p, g, want, held, diff
    torch.cuda.empty_cache()

    # bfloat16 compute (the config's), remat "layer": what a rank holds,
    # then timed steps
    gen = torch.Generator(device="cuda").manual_seed(job["seed"])
    model = tf.init_params(base, gen, "cuda")
    tree = whole_tree(model)
    del model
    local = shard_params(tree, mesh, pcfg, "cuda", cfg=base)
    del tree
    torch.cuda.empty_cache()
    opt = get_optimizer("adamw", lr=job["lr"])
    state = opt.init(local)
    torch.cuda.synchronize()
    out["allocated_after_init"] = torch.cuda.memory_allocated()
    out["held_bytes"] = sum(t.numel() * t.element_size()
                            for t in tree_leaves((local, state)))
    out["blocks_bytes"] = _spmd_blocks_bytes(base, layout, k, S)
    out["blocks_bytes_d1"] = _spmd_blocks_bytes(
        base, MeshLayout(("stage",), (S,)), k, S)
    step = make_pipelined_train_step(base, mesh, pcfg, opt, "cuda")
    step(local, state, batch)                                  # warm-up
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_bwd)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches(*counters)
    torch.cuda.reset_peak_memory_stats()
    step.pipe.seconds = dict.fromkeys(step.pipe.seconds, 0.0)
    step.pipe.bytes = dict.fromkeys(step.pipe.bytes, 0)
    walls, losses = [], []
    for _ in range(job["steps"]):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(local, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # the timed steps are done: the parent's dry run may start
    open(job["timed"].format(rank=rank), "w").close()
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["launches_derived"] = {
        name: n * job["steps"] for name, n in derived_spmd_launches(
            Q, S, base.num_layers // S, base.remat).items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["step_s"], out["losses"] = walls, losses
    out["transfer_s"] = {n: v / job["steps"]
                         for n, v in step.pipe.seconds.items()}
    out["transfer_bytes"] = {n: v // job["steps"]
                             for n, v in step.pipe.bytes.items()}
    out.update(step_busy(lambda: step(local, state, batch)))
    return out


def spmd_rank(rank: int, job: dict) -> None:
    """One rank of phase 28, in a process of its own: gloo over a
    FileStore, loopback sockets; writes its results as JSON."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist
    torch.set_num_threads(TP_THREADS)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = job["data"] * job["stages"]
    dist.init_process_group("gloo", store=dist.FileStore(job["store"],
                                                         world),
                            rank=rank, world_size=world)
    try:
        out = _spmd_work(rank, job)
        with open(job["out"].format(rank=rank), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spmd_dry_run(Q: int) -> dict:
    """The dry run (launch/dryrun.py) of phase 28's cell on a fake process
    group of its ranks with fake CUDA tensors: rank 0's argument bytes
    and the rest of its record (predictions from shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (_lower_pipeline_cell,
                                           fake_process_group)
    from repro_torch.launch.mesh import MeshLayout
    run = SPMD_RUN
    layout = MeshLayout(("data", "stage"), (run["data"], run["stages"]))
    with fake_process_group(layout.size):
        return _lower_pipeline_cell(
            run["arch"], layout, num_stages=run["stages"], q=Q,
            device="cuda", cfg=get_config(run["arch"]),
            batch_override=(run["batch"], run["seq"]))


def spmd_phase(out_dir: str) -> dict:
    """Phase 28: the stage planner picks Q for qwen3-0.6b on 2 GPUs (the
    batch of one data rank); four processes, one rank of (data 2 x stage
    2) each, share the card under gloo (host-staged transfers); each holds
    its stage's 14 layers in their FSDP blocks over the two data ranks.
    float32 (TF32 off): the pipelined loss within 1e-5 of the plain
    model's on the card, every block gradient within 1e-4 of its tensor's
    largest magnitude against the matching block of the plain gradient;
    one pipelined AdamW step: the block gradients it used within 1e-4 of
    the plain ones, its every element within 1e-6 of AdamW applied to
    them, and within 1e-4 of the plain step where the plain gradient is
    at least 1e-6.  bfloat16: each rank's ``memory_allocated`` after
    ``shard_params`` and ``opt.init`` beside its blocks' bytes from the
    shapes, the same stage's at D = 1 and the dry run's argument bytes of
    the same cell; the steps' wall, tokens/s, each rank's device busy
    time, peak memory and ``Pipe.seconds`` / ``Pipe.bytes`` by kind beside
    the plan's T_f, T_i, L_t and bubble, and the plain single-process
    step at the same batch; K2 / K2' launches a step per rank equal to T x
    the layers a stage holds (twice for K2 under remat "layer")."""
    import multiprocessing
    import shutil
    from repro_torch.configs import get_config
    run = SPMD_RUN
    cfg = get_config(run["arch"])
    D, S = run["data"], run["stages"]
    plans, best, Q = stage_plan_q({**run, "batch": run["batch"] // D})
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    job = {**run, "q": Q, "store": os.path.join(out_dir, "store"),
           "out": os.path.join(out_dir, "rank{rank}.json"),
           "timed": os.path.join(out_dir, "timed{rank}")}
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=spmd_rank, args=(r, job))
             for r in range(D * S)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    # the dry run of the same cell (host work only, fake tensors) runs in
    # this process once every rank has timed its steps
    dry_out = {}

    def dry_run():
        marks = [job["timed"].format(rank=r) for r in range(D * S)]
        while not all(os.path.exists(m) for m in marks):
            if not any(p.is_alive() for p in procs):
                return                      # the ranks failed: see below
            time.sleep(0.5)
        try:
            dry_out["record"] = spmd_dry_run(Q)
        except BaseException as e:          # re-raised below
            dry_out["error"] = e

    dry_thread = threading.Thread(target=dry_run)
    dry_thread.start()
    deadline = t0 + SPMD_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    ranks_s = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    dry_thread.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 28 ranks ended with "
                             f"{[p.exitcode for p in procs]}")
    if "error" in dry_out:
        raise dry_out["error"]
    rec = dry_out["record"]
    ranks = []
    for r in range(D * S):
        with open(job["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    failures = []
    for o in ranks:
        worst = max(o["grad_rel"], key=o["grad_rel"].get)
        worst_step = max(o["step_rel"], key=o["step_rel"].get)
        worst_sg = max(o["step_grad_rel"], key=o["step_grad_rel"].get)
        worst_plain = max(o["step_plain_rel"], key=o["step_plain_rel"].get)
        small = sum(o["step_small_grad"].values())
        log(f"phase 28 rank {o['rank']} (data {o['data']}, stage "
            f"{o['stage']}; backend {o['backend']}, transport "
            f"{o['transport']}): float32 loss {o['loss']:.6f} against plain "
            f"{o['plain_loss']:.6f} (rel {o['loss_rel']:.2e}); block "
            f"gradients within {o['grad_rel'][worst]:.2e} of scale (worst "
            f"{worst}); AdamW step: its gradients within "
            f"{o['step_grad_rel'][worst_sg]:.2e} of the plain blocks (worst "
            f"{worst_sg}), every element within "
            f"{o['step_rel'][worst_step]:.2e} of AdamW on them (worst "
            f"{worst_step}), within {o['step_plain_rel'][worst_plain]:.2e} "
            f"of the plain step (worst {worst_plain}; {small} entries with "
            f"|g| < {SPMD_STEP_GRAD_MIN} not held to it)")
        log(f"phase 28 rank {o['rank']}: bf16 parameters and AdamW state "
            f"{o['held_bytes']} B held (from the shapes {o['blocks_bytes']} B;"
            f" the same stage at D = 1 {o['blocks_bytes_d1']} B, ratio "
            f"{o['blocks_bytes'] / o['blocks_bytes_d1']:.4f}), "
            f"memory_allocated after shard_params and opt.init "
            f"{o['allocated_after_init']} B; steps "
            f"{[round(x, 4) for x in o['step_s']]} s, peak "
            f"{o['peak_gib']:.2f} GiB, launches {o['launches']} (derived "
            f"{o['launches_derived']}); profiled steps' device time "
            f"{[round(x, 2) for x in o['busy_sessions_ms']]} ms with "
            f"{o['busy_sessions_kernels']} kernel events; host seconds a "
            f"step by transfer {o['transfer_s']}; bytes a step by transfer "
            f"{o['transfer_bytes']}; K2's mean span in a step "
            f"{o.get('k2_mean_ms', 0.0):.4f} ms; top kernels "
            f"{ {n: round(v['ms'], 1) for n, v in o['top_kernels'].items()} }"
            + ("" if o["busy_sessions_agree"] else
               f"; no two sessions agree: {o['busy_sessions_differ']}"))
        if not (o["loss_rel"] <= SPMD_LOSS_REL
                and o["grad_rel"][worst] <= SPMD_REL
                and o["step_grad_rel"][worst_sg] <= SPMD_REL
                and o["step_rel"][worst_step] <= SPMD_STEP_REL
                and o["step_plain_rel"][worst_plain] <= SPMD_REL):
            failures.append(f"rank {o['rank']} outside the bounds")
        if o["launches"] != o["launches_derived"]:
            failures.append(f"rank {o['rank']} launched {o['launches']}, "
                            f"derived {o['launches_derived']}")
        if not o["busy_sessions_agree"]:
            failures.append(f"rank {o['rank']}'s profiled steps counted "
                            "different kernel events every time")
        if o["held_bytes"] != o["blocks_bytes"]:
            failures.append(f"rank {o['rank']} holds {o['held_bytes']} B of "
                            f"parameters and state, its blocks "
                            f"{o['blocks_bytes']}")
        if not (o["transfer_bytes"]["fsdp_gather"] > 0
                and o["transfer_bytes"]["fsdp_scatter"] > 0):
            failures.append(f"rank {o['rank']} ran no FSDP gather or "
                            "reduce-scatter")
    r0 = next(r for r in ranks if r["rank"] == 0)
    args = rec["memory"]["argument_size_in_bytes"]
    log(f"phase 28 dry run of the same cell (predicted from shapes; fake "
        f"CUDA tensors, a fake group of {D * S}; rank 0): arguments {args} "
        f"B (rank 0's memory_allocated after shard_params and opt.init "
        f"{r0['allocated_after_init']} B, its blocks and state "
        f"{r0['held_bytes']} B), peak {rec['hbm_per_device'] / 2**30:.3f} "
        f"GiB (measured max_memory_allocated {r0['peak_gib']:.3f}), FLOPs a "
        f"step {rec['flops_per_device']:.6e}, collectives "
        f"{rec['collective_breakdown']}")
    tokens = run["batch"] * run["seq"]
    walls = [max(r["step_s"][i] for r in ranks)
             for i in range(run["steps"])]
    # the plain single-process step at the same batch, bfloat16
    plain = {}
    from repro_torch.launch.steps import make_train_step
    from repro_torch.data import token_lm_batches
    from repro_torch.models.registry import get_model
    from repro_torch.optim import get_optimizer
    api = get_model(cfg, "cuda")
    model = api.init(torch.Generator(device="cuda").manual_seed(run["seed"]))
    b = next(token_lm_batches(batch=run["batch"], seq_len=run["seq"],
                              vocab=cfg.vocab, seed=run["seed"]))
    b = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    for q in sorted({2, Q}):
        opt = get_optimizer("adamw", lr=run["lr"])
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt, q, "cuda")
        step(model, state, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(run["steps"]):
            t1 = time.perf_counter()
            step(model, state, b)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t1)
        plain[f"Q={q}"] = {"step_s": ts, "tokens_per_s": [tokens / t
                                                          for t in ts],
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2**30}
        del opt, state, step
    del api, model
    torch.cuda.empty_cache()
    T = Q + S - 1
    out = {"plans": plans, "Q": Q, "data": D, "stages": S, "ticks": T,
           "tick_bubble": (S - 1) / T, "step_s": walls,
           "tokens_per_s": [tokens / w for w in walls],
           "ranks": ranks, "plain": plain, "ranks_wall_s": ranks_s,
           "dry_run": {k: rec[k] for k in (
               "memory", "hbm_per_device", "flops_per_device",
               "collective_breakdown")},
           "launches": {name: sum(r["launches"][name] for r in ranks)
                        for name in ranks[0]["launches"]}}
    log(f"phase 28 pipelined qwen3-0.6b ({cfg.num_layers} layers, "
        f"{cfg.num_layers // S} a stage) over (data {D} x stage {S}) on one "
        f"card (gloo, host-staged transfers), Q {Q}, T {T} ticks (tick "
        f"bubble {out['tick_bubble']:.4f}); bf16 AdamW steps "
        f"{[round(w, 4) for w in walls]} s "
        f"({[round(t) for t in out['tokens_per_s']]} tokens/s); device busy "
        f"a step per rank {[[round(x, 1) for x in r['busy_ms']] for r in ranks]}"
        f" ms; peak per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB; "
        f"launches over the {run['steps']} steps per rank "
        f"{[r['launches'] for r in ranks]} (derived "
        f"{ranks[0]['launches_derived']}); plan T_f {best['T_f']:.6f} s, T_i "
        f"{best['T_i']:.6f} s, L_t {best['L_t']:.6f} s, bubble "
        f"{best['bubble_fraction']:.4f}; plain single-process step "
        + ", ".join(f"{k}: {[round(x, 4) for x in v['step_s']]} s "
                    f"({v['peak_gib']:.2f} GiB)" for k, v in plain.items())
        + f"; ranks' processes {ranks_s:.1f} s")
    if failures:
        raise AssertionError("phase 28: " + "; ".join(failures))
    return out


#: phase 29: tensor parallelism inside the pipeline's stages on the card
#: (pipeline/spmd.py with a "model" axis): qwen3-0.6b at full width, cut
#: to 8 of its 28 layers (phase 28 runs the full depth; the cut keeps the
#: script inside its time limit), over (stage 2 x model 2), four
#: processes sharing the GPU under gloo with TP_THREADS intra-op threads
#: each, 4 layers a stage and 8 / 4 heads of 128 and d_ff 1536 a rank; a
#: batch of 8 x 512 tokens, Q from the stage planner on the whole model as
#: in phase 28
TP_RUN = {"arch": "qwen3-0.6b", "layers": 8, "stages": 2, "model": 2,
          "batch": 8, "seq": 512, "lr": 1e-3, "steps": 3, "seed": 0}
TP_THREADS = 2
#: the MoE branch on the card: granite-moe-3b at full width, 2 layers,
#: 40 experts (expert parallelism: 20 a rank), Q = 2
TP_MOE = {"arch": "granite-moe-3b-a800m", "layers": 2, "q": 2}
#: K2 / K2' at the TP-local qwen3 layer: 1 x 512, 8 / 4 heads of 128
TP_FLASH = (1, 512, 512, 8, 4, 128, True)
#: phase 29's split-key cell: internvl2-1b's backbone at full width (d
#: 896, 14 / 2 heads of 64, d_ff 4864), 2 layers, over (stage 1 x model 4):
#: its 14 query heads do not split over 4, so every rank gathers them
#: whole and attends to its quarter of the keys' sequence (the reference's
#: _kv_seq_spec); its vocabulary (151655) does not split over 4, so the
#: head stays whole.  A batch of 4 x 512 tokens in Q = 2.
TP_SPLIT = {"arch": "internvl2-1b", "layers": 2, "stages": 1, "model": 4,
            "batch": 4, "q": 2, "steps": 2}
#: K2 / K2' with a key offset at internvl2-1b's layer: B, S = T, H, KV,
#: hd (causal), the keys split into 4 even blocks and 3 uneven ones
SPLIT_FLASH = (1, 512, 14, 2, 64)
SPLIT_WAYS = (4, 3)
#: seconds the parent waits for the four ranks
TP_TIMEOUT_S = 600
#: profiled steps a rank of phase 29 runs for its device busy time
TP_PROFILED = 3


def _model_blocks_joined(pipe, cfg, layout, key, g, full_shape):
    """The model group's blocks of the gradient ``g`` of leaf ``key``
    (this rank's stage rows) put back together along the dim the rules
    split (gathered through the host under gloo); ``g`` itself when the
    leaf is whole on every model rank."""
    import torch.distributed as dist
    from repro_torch.pipeline.spmd import block_dims
    d = block_dims(cfg, layout, key, tuple(full_shape))[0]
    if d is None:
        return g
    host = g.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(pipe.M)]
    dist.all_gather(parts, host, group=pipe.model_group)
    return torch.cat(parts, dim=d).to(g.device)


def _tp_check(cfg, layout, pcfg, batch, seed, q_plain) -> dict:
    """Loss and every gradient of the pipelined model (the model blocks
    put back together) against the plain single-process model on the
    card, from the same weights (f32, TF32 off)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import nest_layers
    from repro_torch.models.registry import get_model
    from repro_torch.pipeline.executor import microbatch_grads
    from repro_torch.pipeline.spmd import make_pipelined_loss, shard_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = tf.init_params(cfg, gen, "cuda")
    tree = nest_layers({n: p.detach().clone()
                        for n, p in model.named_parameters()}, torch.stack)
    api = get_model(cfg, "cuda")
    names = [n for n, _ in model.named_parameters()]
    loss0, g0 = microbatch_grads(lambda _p, mb: api.loss(model, mb),
                                 list(model.parameters()), batch, q_plain)
    g0 = _flat_tree(nest_layers(dict(zip(names, g0)), torch.stack))
    del model
    local = shard_params(tree, layout, pcfg, "cuda", cfg=cfg)
    del tree
    loss_fn = make_pipelined_loss(cfg, layout, pcfg, "cuda")
    pipe = loss_fn.pipe
    loss = loss_fn(local, batch)
    leaves = _flat_tree(local)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {"loss": loss.item(), "plain_loss": loss0.item(),
           "stage": pipe.k, "model": pipe.m, "grad_rel": {}}
    out["loss_rel"] = abs(out["loss"] - out["plain_loss"]) \
        / abs(out["plain_loss"])
    for key, g in zip(leaves, grads):
        whole = _model_blocks_joined(pipe, cfg, layout, key, g,
                                     g0[key].shape)
        want = _stage_part(key, g0[key], pipe.k, pipe.S)
        if whole.shape != want.shape:
            raise AssertionError(f"{key}: joined blocks {tuple(whole.shape)}"
                                 f" against {tuple(want.shape)}")
        out["grad_rel"][key] = float((whole - want).abs().max()
                                     / want.abs().max())
    return out, g0


def _tp_adamw_check(cfg32, layout, pcfg, batch, seed, lr, g0) -> tuple:
    """One pipelined AdamW step of ``cfg32`` (f32) from the seed's weights:
    (each updated leaf against AdamW applied to the gradients the step
    used, those gradients against the rank's block of the plain model's
    ``g0``), each relative to its tensor's largest magnitude."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import nest_layers
    from repro_torch.optim import get_optimizer
    from repro_torch.pipeline.spmd import (make_pipelined_train_step,
                                           shard_params)
    from repro_torch.utils import tree_map
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = tf.init_params(cfg32, gen, "cuda")
    tree = nest_layers({n: p.detach().clone()
                        for n, p in model.named_parameters()}, torch.stack)
    del model
    local = shard_params(tree, layout, pcfg, "cuda", cfg=cfg32)
    del tree
    opt = get_optimizer("adamw", lr=lr)
    seen = {}

    def recorded(params, grads, state):
        seen["before"] = tree_map(lambda p: p.detach().clone(), params)
        seen["grads"] = tree_map(torch.clone, grads)
        return opt.update(params, grads, state)

    step32 = make_pipelined_train_step(
        cfg32, layout, pcfg, dataclasses.replace(opt, update=recorded),
        "cuda")
    k, m = step32.pipe.k, step32.pipe.m
    local, _, _ = step32(local, opt.init(local), batch)
    adamw, _ = opt.update(seen["before"], seen["grads"],
                          opt.init(seen["before"]))
    adamw, step_grads = _flat_tree(adamw), _flat_tree(seen["grads"])
    step_rel, grad_rel = {}, {}
    for key, p in _flat_tree(local).items():
        step_rel[key] = float((p.detach() - adamw[key]).abs().max()
                              / adamw[key].abs().max())
        g = _block_part(cfg32, layout, key, g0[key], 0, k, m,
                        pcfg.num_stages)
        grad_rel[key] = float((step_grads[key] - g).abs().max()
                              / g.abs().max())
    return step_rel, grad_rel


def _tp_split_cell(job: dict) -> dict:
    """Phase 29's split-key cell (``TP_SPLIT``) on one rank: the f32
    loss, every gradient and one AdamW step against the plain model on
    the card, then timed bfloat16 steps with their K2 / K2' launches and
    ``Pipe.seconds`` / ``Pipe.bytes`` by kind."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.kernels import flash as flash_mod
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import nest_layers
    from repro_torch.optim import get_optimizer
    from repro_torch.pipeline.spmd import (PipelineConfig,
                                           make_pipelined_train_step,
                                           shard_params, vocab_parallel)
    c = TP_SPLIT
    layout = MeshLayout(("stage", "model"), (c["stages"], c["model"]))
    pcfg = PipelineConfig(c["stages"], c["q"])
    base = dataclasses.replace(get_config(c["arch"]),
                               num_layers=c["layers"])
    mode = tf.attention_mode(base, c["model"])
    if mode != "split_keys" or vocab_parallel(base, c["model"]):
        raise AssertionError(f"{c['arch']} over {c['model']}: attention "
                             f"{mode}, vocabulary split "
                             f"{vocab_parallel(base, c['model'])}")
    batch = next(token_lm_batches(batch=c["batch"], seq_len=job["seq"],
                                  vocab=base.vocab, seed=job["seed"]))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    out = {"attention": mode}
    cfg32 = dataclasses.replace(base, compute_dtype=torch.float32)
    out["f32"], g0 = _tp_check(cfg32, layout, pcfg, batch, job["seed"],
                               c["q"])
    out["step_rel"], out["step_grad_rel"] = _tp_adamw_check(
        cfg32, layout, pcfg, batch, job["seed"], job["lr"], g0)
    del g0
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(job["seed"])
    model = tf.init_params(base, gen, "cuda")
    tree = nest_layers({n: p.detach().clone()
                        for n, p in model.named_parameters()}, torch.stack)
    del model
    local = shard_params(tree, layout, pcfg, "cuda", cfg=base)
    del tree
    opt = get_optimizer("adamw", lr=job["lr"])
    state = opt.init(local)
    step = make_pipelined_train_step(base, layout, pcfg, opt, "cuda")
    step(local, state, batch)                                  # warm-up
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_bwd)
    pipe = step.pipe
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches(*counters)
    pipe.seconds = dict.fromkeys(pipe.seconds, 0.0)
    pipe.bytes = dict.fromkeys(pipe.bytes, 0)
    walls = []
    for _ in range(c["steps"]):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(local, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["launches"] = {f.__name__: f.launches for f in counters}
    out["launches_derived"] = {
        name: n * c["steps"] for name, n in derived_spmd_launches(
            c["q"], c["stages"], c["layers"] // c["stages"],
            base.remat).items()}
    out["step_s"] = walls
    out["transfer_s"] = {n: v / c["steps"] for n, v in pipe.seconds.items()}
    out["transfer_bytes"] = {n: v // c["steps"]
                             for n, v in pipe.bytes.items()}
    del local, state, step
    torch.cuda.empty_cache()
    return out


def check_split_keys(flash_mod, flash_kernel) -> dict:
    """K2 and K2' with a key offset at ``SPLIT_FLASH`` on the card, its
    keys split into each of ``SPLIT_WAYS`` blocks (even and uneven), in
    float32 and bfloat16: each block's output and lse against the plain
    versions with the offset (the flash forward contract; a row before
    the block's first key a zero output row and lse -inf, no NaN); the
    blocks combined by the log-sum-exp against the whole K2; K2' on each
    block from the combined output and lse against flash_bwd_plain (the
    backward contract), the blocks' dq summed and dk, dv joined against
    the whole K2'.  Then, in bfloat16, the first and last of 4 blocks
    (offsets 0 and 384) timed by device time beside the whole call, SDPA
    given the block's mask, the plain versions and the bound."""
    from repro_torch.kernels.flash.split import key_blocks
    B, S, H, KV, hd = SPLIT_FLASH
    out = {"k2_err": 0.0, "k2_bwd_err": 0.0, "combined_err": 0.0,
           "combined_bwd_err": 0.0, "empty_rows": 0}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(B, S, S, H, KV, hd, dtype)
        do = flash_inputs(B, S, S, H, H, hd, dtype, seed=43)[0]
        tol, gtol = FLASH_TOL[dtype], GRAD_TOL[dtype]
        o_all, lse_all = flash_kernel._forward(q, k, v, True, True)
        g_all = flash_mod.flash_attention_bwd(q, k, v, o_all, do, lse_all)
        for M in SPLIT_WAYS:
            tag = f"K2 split {M} ways {str(dtype)[6:]}"
            parts = []
            for lo, hi in key_blocks(S, M):
                kb, vb = k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous()
                o_m, lse_m = flash_kernel._forward(q, kb, vb, True, True, 0,
                                                   lo)
                want = flash_mod.attention_plain(q, kb, vb, k_offset=lo)
                want_lse = flash_mod.attention_lse_plain(q, kb, k_offset=lo)
                err = float((o_m.float() - want.float()).abs().max())
                kept = torch.isfinite(want_lse)
                lse_err = float((lse_m - want_lse)[kept].abs().max())
                empty = ~kept
                if not (torch.isfinite(o_m).all()
                        and torch.allclose(o_m.float(), want.float(),
                                           atol=tol, rtol=tol)
                        and lse_err <= tol * (1 + float(want_lse[kept]
                                                       .abs().max()))
                        and torch.equal(torch.isneginf(lse_m), empty)
                        and bool((o_m.transpose(1, 2)[empty] == 0).all())):
                    raise AssertionError(f"{tag} block {lo}:{hi}: max abs "
                                         f"err {err}, lse {lse_err}")
                out["k2_err"] = max(out["k2_err"], err)
                out["empty_rows"] += int(empty.sum())
                parts.append((lo, hi, kb, vb, o_m, lse_m))
            lse = torch.logsumexp(torch.stack([p[5] for p in parts]), 0)
            o = sum(torch.exp(p[5] - lse).transpose(1, 2)[..., None]
                    * p[4].float() for p in parts)
            cerr = float((o - o_all.float()).abs().max())
            if not torch.allclose(o, o_all.float(), atol=tol, rtol=tol):
                raise AssertionError(f"{tag}: combined output off the whole "
                                     f"K2 by {cerr}")
            out["combined_err"] = max(out["combined_err"], cerr)
            o = o.to(dtype)
            dq = torch.zeros_like(q, dtype=torch.float32)
            dks, dvs = [], []
            for lo, hi, kb, vb, _, _ in parts:
                got = flash_mod.flash_attention_bwd(q, kb, vb, o, do, lse,
                                                    k_offset=lo)
                want = flash_mod.flash_bwd_plain(q, kb, vb, o, do, lse,
                                                 k_offset=lo)
                out["k2_bwd_err"] = max(out["k2_bwd_err"], check_grads(
                    f"K2' split {M} ways block {lo}:{hi} {str(dtype)[6:]}",
                    got, want, gtol))
                if not torch.all(got[0][:, :lo] == 0):
                    raise AssertionError(f"K2' block {lo}:{hi}: dq of the "
                                         "rows before it not zero")
                dq += got[0].float()
                dks.append(got[1])
                dvs.append(got[2])
            out["combined_bwd_err"] = max(
                out["combined_bwd_err"], check_grads(
                    f"K2' split {M} ways combined {str(dtype)[6:]}",
                    (dq, torch.cat(dks, 1), torch.cat(dvs, 1)), g_all, gtol))
            log(f"{tag}: blocks within {tol} of the plain versions with "
                f"their offsets (max abs err {out['k2_err']:.3e}), "
                f"combined within {cerr:.3e} of the whole K2; K2' blocks "
                f"within {gtol} (max {out['k2_bwd_err']:.3e}), combined "
                f"within {out['combined_bwd_err']:.3e} of the whole K2'")
    out["times"] = time_split_keys(flash_mod, flash_kernel)
    return out


def time_split_keys(flash_mod, flash_kernel) -> dict:
    """K2 / K2' (bf16) on the first and last of 4 key blocks at
    ``SPLIT_FLASH`` (offsets 0 and 384) and on the whole keys, by device
    time, beside SDPA given each block's mask (its backward too), the
    plain versions (CUDA events) and the bounds."""
    from repro_torch.kernels.flash.split import key_blocks
    B, S, H, KV, hd = SPLIT_FLASH
    q, k, v = flash_inputs(B, S, S, H, KV, hd, torch.bfloat16, seed=5)
    do = flash_inputs(B, S, S, H, H, hd, torch.bfloat16, seed=6)[0]
    blocks = key_blocks(S, 4)
    out = {}
    for label, (lo, hi) in (("whole", (0, S)), ("block 0", blocks[0]),
                            ("block 3", blocks[-1])):
        kb, vb = k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous()
        T = hi - lo
        qpos = torch.arange(S, device="cuda")[:, None]
        mask = torch.arange(lo, hi, device="cuda")[None, :] <= qpos
        # SDPA gives a row with no kept key NaN: those rows are left out of
        # its call (the same kept pairs)
        r0 = lo
        o_m, lse_m = flash_kernel._forward(q, kb, vb, True, True, 0, lo)
        fwd = lambda: flash_kernel._forward(q, kb, vb, True, False, 0, lo)
        bwd = lambda: flash_mod.flash_attention_bwd(q, kb, vb, o_m, do,
                                                    lse_m, k_offset=lo)
        lib = lambda: sdpa_masked(q[:, r0:], kb, vb, mask[r0:])
        lib_bwd = sdpa_bwd(q[:, r0:], kb, vb, do[:, r0:], mask=mask[r0:])
        for fn in (fwd, bwd, lib, lib_bwd):
            for _ in range(WARM_CALLS):
                fn()
        row = {"offset": lo, "keys": T,
               "device_ms": device_ms(fwd), "bwd_device_ms": device_ms(bwd),
               "library_device_ms": device_ms(lib),
               "library_bwd_device_ms": device_ms(lib_bwd),
               "plain_ms": cuda_ms(lambda: flash_mod.attention_plain(
                   q, kb, vb, k_offset=lo)),
               "bwd_plain_ms": cuda_ms(lambda: flash_mod.flash_bwd_plain(
                   q, kb, vb, o_m, do, lse_m, k_offset=lo))}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            B, S, T, H, KV, hd, True, torch.bfloat16, 0, lo)
        row["bwd_bound_ms"], row["bwd_bound_by"] = flash_bwd_bound_ms(
            B, S, T, H, KV, hd, True, torch.bfloat16, 0, lo)
        log(f"K2 / K2' at {SPLIT_FLASH} keys {lo}:{hi} (offset {lo}), "
            f"bf16: device {row['device_ms']:.4f} / "
            f"{row['bwd_device_ms']:.4f} ms, SDPA with the block's mask "
            f"{row['library_device_ms']:.4f} / "
            f"{row['library_bwd_device_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} / {row['bwd_plain_ms']:.4f} ms "
            f"(events), bound {row['bound_ms']:.6f} ({row['bound_by']}) / "
            f"{row['bwd_bound_ms']:.6f} ms ({row['bwd_bound_by']})")
        out[label] = row
    return out


def _tp_work(rank: int, job: dict) -> dict:
    """Phase 29 on one rank: the f32 checks (qwen3-0.6b, its AdamW step,
    granite-moe-3b), the split-key cell (``_tp_split_cell``), then the
    timed bfloat16 steps and one step's count (utils/cost.py)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import token_lm_batches
    from repro_torch.kernels import flash as flash_mod
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import nest_layers
    from repro_torch.optim import get_optimizer
    from repro_torch.pipeline.spmd import (PipelineConfig,
                                           make_pipelined_train_step,
                                           shard_params)
    from repro_torch.utils import step_cost, tree_map
    S, M, Q = job["stages"], job["model"], job["q"]
    pcfg = PipelineConfig(S, Q)
    layout = MeshLayout(("stage", "model"), (S, M))
    base = tp_config(job)
    batch = next(token_lm_batches(batch=job["batch"], seq_len=job["seq"],
                                  vocab=base.vocab, seed=job["seed"]))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    out = {"rank": rank}

    # float32, TF32 off: the dense model, then one AdamW step
    cfg32 = dataclasses.replace(base, compute_dtype=torch.float32)
    out["f32"], g0 = _tp_check(cfg32, layout, pcfg, batch, job["seed"], 2)
    out["step_rel"], out["step_grad_rel"] = _tp_adamw_check(
        cfg32, layout, pcfg, batch, job["seed"], job["lr"], g0)
    del g0
    torch.cuda.empty_cache()

    # the MoE branch: granite-moe-3b, 2 layers, expert parallelism
    moe = dataclasses.replace(get_config(TP_MOE["arch"]),
                              num_layers=TP_MOE["layers"],
                              compute_dtype=torch.float32)
    moe_batch = next(token_lm_batches(batch=job["batch"],
                                      seq_len=job["seq"], vocab=moe.vocab,
                                      seed=job["seed"]))
    moe_batch = {k2: torch.as_tensor(v, device="cuda")
                 for k2, v in moe_batch.items()}
    out["moe"] = _tp_check(moe, layout, PipelineConfig(S, TP_MOE["q"]),
                           moe_batch, job["seed"], 1)[0]
    torch.cuda.empty_cache()

    # the heads that do not split: internvl2-1b over (stage 1 x model 4)
    out["split"] = _tp_split_cell(job)

    # bfloat16 compute (the config's), remat "layer": timed steps
    gen = torch.Generator(device="cuda").manual_seed(job["seed"])
    model = tf.init_params(base, gen, "cuda")
    tree = nest_layers({n: p.detach().clone()
                        for n, p in model.named_parameters()}, torch.stack)
    del model
    local = shard_params(tree, layout, pcfg, "cuda", cfg=base)
    del tree
    torch.cuda.empty_cache()
    opt = get_optimizer("adamw", lr=job["lr"])
    state = opt.init(local)
    step = make_pipelined_train_step(base, layout, pcfg, opt, "cuda")
    step(local, state, batch)                                  # warm-up
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_bwd)
    torch.cuda.synchronize()
    dist.barrier()
    args_bytes = torch.cuda.memory_allocated()
    reset_launches(*counters)
    torch.cuda.reset_peak_memory_stats()
    pipe = step.pipe
    pipe.seconds = dict.fromkeys(pipe.seconds, 0.0)
    pipe.bytes = dict.fromkeys(pipe.bytes, 0)
    walls, losses = [], []
    for _ in range(job["steps"]):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, met = step(local, state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # the timed steps are done: the parent's dry run may start
    open(job["timed"].format(rank=rank), "w").close()
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["launches_derived"] = {
        name: n * job["steps"] for name, n in derived_spmd_launches(
            Q, S, base.num_layers // S, base.remat).items()}
    out["allocated_before_gib"] = args_bytes / 2**30
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["step_s"], out["losses"] = walls, losses
    out["transfer_s"] = {n: v / job["steps"] for n, v in pipe.seconds.items()}
    out["transfer_bytes"] = {n: v // job["steps"]
                             for n, v in pipe.bytes.items()}
    out.update(step_busy(lambda: step(local, state, batch), TP_PROFILED))
    # one more step counted by utils/cost.py (the dry run's prediction is
    # held to it by the parent)
    dist.barrier()
    cost = step_cost(step, local, state, batch, pipe=pipe)
    out["counted"] = {"flops": cost.flops,
                      "collective_by_kind": cost.collective_by_kind,
                      "kernels": cost.kernels}
    return out


def tp_rank(rank: int, job: dict) -> None:
    """One rank of phase 29, in a process of its own: gloo over a
    FileStore, loopback sockets; writes its results as JSON."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist
    torch.set_num_threads(TP_THREADS)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = job["stages"] * job["model"]
    dist.init_process_group("gloo", store=dist.FileStore(job["store"],
                                                         world),
                            rank=rank, world_size=world)
    try:
        out = _tp_work(rank, job)
        with open(job["out"].format(rank=rank), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def stage_plan_q(run: dict) -> tuple:
    """Phase 28's choice of Q: the stage planner (H100 defaults) on
    ``run["stages"]`` GPUs and the run's batch, BCD from b0 = 8 and 1, the
    plan of least L_t; returns (plans, the best plan's fields, Q)."""
    from repro_torch.configs import arch_profile, get_config
    from repro_torch.core import plan_stages
    from repro_torch.pipeline.spmd import plan_to_pipeline_config
    prof = arch_profile(get_config(run["arch"]))
    plans = {}
    for b0 in (8, 1):
        sp = plan_stages(prof, total_chips=run["stages"],
                         stage_candidates=(run["stages"],),
                         global_batch=run["batch"], b0=b0, device="cuda")
        plans[f"b0={b0}"] = {
            "layer_ranges": sp.layer_ranges, "num_stages": sp.num_stages,
            "microbatch": sp.microbatch, "Q": sp.num_microbatches,
            "T_f": sp.T_f, "T_i": sp.T_i, "L_t": sp.L_t,
            "bubble_fraction": sp.bubble_fraction, "plan": sp}
        log(f"stage plan (H100 defaults, {run['stages']} GPUs, batch "
            f"{run['batch']}, BCD from b0 = {b0}): stages "
            f"{sp.layer_ranges}, micro-batch {sp.microbatch}, Q "
            f"{sp.num_microbatches}, T_f {sp.T_f:.6f} s, T_i {sp.T_i:.6f} "
            f"s, L_t {sp.L_t:.6f} s, bubble {sp.bubble_fraction:.4f}")
    best = min(plans.values(), key=lambda p: p["L_t"])
    pcfg = plan_to_pipeline_config(best.pop("plan"), run["batch"])
    for p in plans.values():
        p.pop("plan", None)
    if pcfg.num_stages != run["stages"]:
        raise AssertionError(f"the best plan has {pcfg.num_stages} stages")
    return plans, best, pcfg.num_microbatches


def tp_config(run: dict):
    """Phase 29's model: ``run["arch"]`` cut to ``run["layers"]``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(run["arch"]),
                               num_layers=run["layers"])


def tp_dry_run(Q: int) -> dict:
    """The dry run (launch/dryrun.py) of phase 29's cell on a fake process
    group of 4 with fake CUDA tensors, and its roofline row at the H100
    constants (predictions from shapes and data-sheet rates)."""
    from repro_torch.launch.dryrun import (_lower_pipeline_cell,
                                           fake_process_group)
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.launch.roofline import roofline_row
    run = TP_RUN
    layout = MeshLayout(("stage", "model"), (run["stages"], run["model"]))
    with fake_process_group(layout.size):
        rec = _lower_pipeline_cell(
            run["arch"], layout, num_stages=run["stages"], q=Q,
            device="cuda", cfg=tp_config(run),
            batch_override=(run["batch"], run["seq"]))
    return {"record": rec, "roofline": roofline_row(rec)}


#: phase 29's dry runs of the reduced cells the dry run's repair covers,
#: each traced on fake CUDA tensors (the kernels' fake branches charge
#: their work) and on fake CPU tensors (the plain versions): micro-batches
#: with fewer rows than the (pod, data) ranks; RWKV6's state in a decode;
#: RWKV6 training over (pod, data) (K3 / K3'); whisper's prefill with its
#: caches on the mesh; the VLM backbone in the stage pipeline; the MoE's
#: expert products on the slices of their FSDP blocks where a
#: micro-batch's rows are replicated over the data ranks (qwen3-moe-235b
#: training, jamba-1.5-large's batch-1 decode).  "kernels" are those the
#: fake CUDA trace must charge.
DRY_CELLS = [
    {"name": "small micro-batches", "arch": "qwen3-0.6b",
     "shape": "train_4k", "axes": ("pod", "data", "model"),
     "sizes": (2, 2, 2), "batch": (8, 32), "q": 4,
     "kernels": ("flash_attention", "flash_attention_bwd")},
    {"name": "rwkv6 decode", "arch": "rwkv6-1.6b", "shape": "decode_32k",
     "axes": ("data", "model"), "sizes": (2, 2), "batch": (8, 32),
     "kernels": ()},
    {"name": "rwkv6 training over pod x data", "arch": "rwkv6-1.6b",
     "shape": "train_4k", "axes": ("pod", "data", "model"),
     "sizes": (2, 2, 2), "batch": (8, 64), "q": 2,
     "kernels": ("wkv6", "wkv6_bwd")},
    {"name": "whisper prefill", "arch": "whisper-small",
     "shape": "prefill_32k", "axes": ("data", "model"), "sizes": (2, 2),
     "batch": (8, 32), "over": {"num_layers": 1, "encoder_layers": 1},
     "kernels": ("flash_attention",)},
    {"name": "vlm pipeline", "arch": "internvl2-1b", "shape": "train_4k",
     "axes": ("data", "stage", "model"), "sizes": (2, 2, 2),
     "batch": (8, 32), "q": 2, "pipeline": True, "over": {"num_layers": 4},
     "kernels": ("flash_attention", "flash_attention_bwd")},
    {"name": "moe small micro-batches", "arch": "qwen3-moe-235b-a22b",
     "shape": "train_4k", "axes": ("pod", "data", "model"),
     "sizes": (2, 2, 2), "batch": (8, 32), "q": 4,
     "kernels": ("flash_attention", "flash_attention_bwd")},
    {"name": "jamba batch-1 decode", "arch": "jamba-1.5-large-398b",
     "shape": "long_500k", "axes": ("pod", "data", "model"),
     "sizes": (2, 2, 2), "batch": (1, 256), "kernels": ()},
]


def dry_cell(cell: dict, device: str) -> dict:
    """The dry run's record of one of ``DRY_CELLS`` on ``device``'s fake
    tensors over a fake process group of its mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    cfg = dataclasses.replace(get_config(cell["arch"], reduced=True),
                              **cell.get("over", {}))
    layout = MeshLayout(cell["axes"], cell["sizes"])
    with dryrun.fake_process_group(layout.size):
        if cell.get("pipeline"):
            return dryrun._lower_pipeline_cell(
                cell["arch"], layout, num_stages=layout.shape["stage"],
                q=cell["q"], device=device, cfg=cfg,
                batch_override=cell["batch"])
        return dryrun._lower_cell(cell["arch"], cell["shape"], layout,
                                  q_override=cell.get("q"), device=device,
                                  cfg=cfg, batch_override=cell["batch"])


def dry_cells_run(path: str) -> None:
    """Every cell of ``DRY_CELLS`` traced on fake CUDA and fake CPU
    tensors (one intra-op thread, in a process of its own: host work
    only), the records' figures or each trace's error written to
    ``path``."""
    torch.set_num_threads(1)
    out = []
    for cell in DRY_CELLS:
        row = {"name": cell["name"]}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            try:
                rec = dry_cell(cell, device)
                row[device] = {
                    "flops": rec["flops_per_device"],
                    "args": rec["memory"]["argument_size_in_bytes"],
                    "hbm": rec["hbm_per_device"],
                    "kernels": {k: v["calls"]
                                for k, v in rec["kernels"].items()},
                    "cache": rec.get("cache"),
                    "seconds": time.perf_counter() - t0}
            except Exception as e:              # reported by the parent
                row[device] = {"error": repr(e)[-2000:]}
        out.append(row)
    with open(path, "w") as f:
        json.dump(out, f)


def check_dry_cells(rows: list) -> list:
    """Log each repaired cell's fake CUDA and fake CPU figures; returns
    the failures (a trace that raised, a kernel the fake CUDA trace did
    not charge)."""
    failures = []
    card = card_name()
    for cell, row in zip(DRY_CELLS, rows):
        bad = [d for d in ("cuda", "cpu") if "error" in row[d]]
        if bad:
            failures += [f"dry run of {cell['name']} on fake {d}: "
                         f"{row[d]['error']}" for d in bad]
            continue
        cu, cp = row["cuda"], row["cpu"]
        missing = [k for k in cell["kernels"] if not cu["kernels"].get(k)]
        if missing:
            failures.append(f"dry run of {cell['name']}: no charge of "
                            f"{missing}")
        log(f"phase 29 dry run, {cell['name']} ({cell['arch']} reduced, "
            f"{'x'.join(map(str, cell['sizes']))} {cell['axes']}): FLOPs a "
            f"device {cu['flops']:.6e} on fake CUDA (kernels charged "
            f"{cu['kernels']}) beside {cp['flops']:.6e} on fake CPU (the "
            f"plain versions); arguments {cu['args']} / {cp['args']} B; "
            f"traced in {cu['seconds']:.1f} / {cp['seconds']:.1f} s on the "
            f"host of {card}")
    return failures


def tp_phase(out_dir: str, flash_mod, flash_kernel) -> dict:
    """Phase 29: qwen3-0.6b (``TP_RUN``'s layers) pipelined over (stage 2 x
    model 2) on one card
    (four processes under gloo, host-staged transfers).  float32 (TF32
    off), the model blocks put back together: the loss within 1e-5 of the
    plain model's, every gradient within 1e-4 of each tensor's largest
    magnitude; one AdamW step within 1e-6 of scale of AdamW on the
    gradients it used (those within 1e-4 of the plain ones); granite-moe-3b
    (2 layers, 20 experts a rank) and internvl2-1b's split-key cell
    (``TP_SPLIT``) at the same bounds.  bfloat16: step seconds, tokens/s,
    each rank's device busy time and peak memory, Pipe.seconds and
    Pipe.bytes by kind, K2 / K2' launches per rank equal to the ticks x
    the stage's layers (twice for K2 under remat).  K2 and K2' with a key
    offset (``check_split_keys``) and at the TP-local layer held to their
    plain versions and timed beside SDPA.  The dry run of the same cell (fake CUDA tensors, a fake
    group of 4; run in this process once the ranks have timed their
    steps) beside the measured figures, and its roofline row."""
    import multiprocessing
    import shutil
    run = TP_RUN
    plans, best, Q = stage_plan_q(run)
    S, M = run["stages"], run["model"]
    T = Q + S - 1
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    job = {**run, "q": Q, "store": os.path.join(out_dir, "store"),
           "out": os.path.join(out_dir, "rank{rank}.json"),
           "timed": os.path.join(out_dir, "timed{rank}")}
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_rank, args=(r, job))
             for r in range(S * M)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    # the dry run of the same cell is host work only (fake tensors): it
    # runs in this process while the ranks run their untimed steps (the
    # profiled ones and the counted one), once every rank has timed its
    dry_out = {}

    cells_path = os.path.join(out_dir, "dry_cells.json")
    cells_proc = ctx.Process(target=dry_cells_run, args=(cells_path,))

    def dry_run():
        marks = [job["timed"].format(rank=r) for r in range(S * M)]
        while not all(os.path.exists(m) for m in marks):
            if not any(p.is_alive() for p in procs):
                return                      # the ranks failed: see below
            time.sleep(0.5)
        # the repaired cells' traces in a process of their own meanwhile
        cells_proc.start()
        try:
            dry_out.update(tp_dry_run(Q))
        except BaseException as e:          # re-raised below
            dry_out["error"] = e

    dry_thread = threading.Thread(target=dry_run)
    dry_thread.start()
    deadline = t0 + TP_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    ranks_s = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    dry_thread.join()
    if cells_proc.pid is not None:
        cells_proc.join(max(1.0, deadline + TP_TIMEOUT_S
                            - time.perf_counter()))
        if cells_proc.is_alive():
            cells_proc.kill()
            cells_proc.join()
    if "error" in dry_out:
        raise dry_out["error"]
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 29 ranks ended with "
                             f"{[p.exitcode for p in procs]}")
    ranks = []
    for r in range(S * M):
        with open(job["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    failures = []
    for o in ranks:
        for label in ("f32", "moe"):
            c = o[label]
            worst = max(c["grad_rel"], key=c["grad_rel"].get)
            log(f"phase 29 rank {o['rank']} (stage {c['stage']}, model "
                f"{c['model']}) {label}: loss {c['loss']:.6f} against plain "
                f"{c['plain_loss']:.6f} (rel {c['loss_rel']:.2e}); joined "
                f"gradients within {c['grad_rel'][worst]:.2e} of scale "
                f"(worst {worst})")
            if not (c["loss_rel"] <= SPMD_LOSS_REL
                    and c["grad_rel"][worst] <= SPMD_REL):
                failures.append(f"rank {o['rank']} {label} outside the "
                                "bounds")
        ws = max(o["step_rel"], key=o["step_rel"].get)
        wg = max(o["step_grad_rel"], key=o["step_grad_rel"].get)
        log(f"phase 29 rank {o['rank']} AdamW step: every element within "
            f"{o['step_rel'][ws]:.2e} of AdamW on its gradients (worst "
            f"{ws}), those within {o['step_grad_rel'][wg]:.2e} of the plain "
            f"blocks (worst {wg})")
        if not (o["step_rel"][ws] <= SPMD_STEP_REL
                and o["step_grad_rel"][wg] <= SPMD_REL):
            failures.append(f"rank {o['rank']} AdamW step outside the "
                            "bounds")
        log(f"phase 29 rank {o['rank']}: bf16 steps "
            f"{[round(x, 4) for x in o['step_s']]} s, peak "
            f"{o['peak_gib']:.2f} GiB (allocated before the steps "
            f"{o['allocated_before_gib']:.2f}), launches {o['launches']} "
            f"(derived {o['launches_derived']}); device busy "
            f"{[round(x, 2) for x in o['busy_sessions_ms']]} ms with "
            f"{o['busy_sessions_kernels']} kernel events; host seconds a "
            f"step by transfer {o['transfer_s']}; bytes a step by transfer "
            f"{o['transfer_bytes']}; counted FLOPs a step "
            f"{o['counted']['flops']:.6e}; top kernels "
            f"{ {n: round(v['ms'], 1) for n, v in o['top_kernels'].items()} }"
            + ("" if o["busy_sessions_agree"] else
               f"; no two sessions agree: {o['busy_sessions_differ']}"))
        if o["launches"] != o["launches_derived"]:
            failures.append(f"rank {o['rank']} launched {o['launches']}, "
                            f"derived {o['launches_derived']}")
        if not o["busy_sessions_agree"]:
            failures.append(f"rank {o['rank']}'s profiled steps counted "
                            "different kernel events every time")
        sp = o["split"]
        c = sp["f32"]
        worst = max(c["grad_rel"], key=c["grad_rel"].get)
        ws = max(sp["step_rel"], key=sp["step_rel"].get)
        wg = max(sp["step_grad_rel"], key=sp["step_grad_rel"].get)
        log(f"phase 29 rank {o['rank']} {TP_SPLIT['arch']} over (stage "
            f"{TP_SPLIT['stages']} x model {TP_SPLIT['model']}), attention "
            f"{sp['attention']}, f32: loss {c['loss']:.6f} against plain "
            f"{c['plain_loss']:.6f} (rel {c['loss_rel']:.2e}); joined "
            f"gradients within {c['grad_rel'][worst]:.2e} of scale (worst "
            f"{worst}); AdamW step within {sp['step_rel'][ws]:.2e} (worst "
            f"{ws}), its gradients within {sp['step_grad_rel'][wg]:.2e}; "
            f"bf16 steps {[round(x, 4) for x in sp['step_s']]} s, launches "
            f"{sp['launches']} (derived {sp['launches_derived']}); host "
            f"seconds a step by transfer {sp['transfer_s']}; bytes a step "
            f"by transfer {sp['transfer_bytes']}")
        if not (c["loss_rel"] <= SPMD_LOSS_REL
                and c["grad_rel"][worst] <= SPMD_REL
                and sp["step_rel"][ws] <= SPMD_STEP_REL
                and sp["step_grad_rel"][wg] <= SPMD_REL):
            failures.append(f"rank {o['rank']} {TP_SPLIT['arch']} outside "
                            "the bounds")
        if sp["launches"] != sp["launches_derived"]:
            failures.append(f"rank {o['rank']} {TP_SPLIT['arch']} launched "
                            f"{sp['launches']}, derived "
                            f"{sp['launches_derived']}")
    # K2 and K2' with a key offset: the split-key blocks
    split_keys = check_split_keys(flash_mod, flash_kernel)
    # K2 and K2' at the TP-local layer shape
    torch.backends.cuda.matmul.allow_tf32 = False
    flash = {"shape": TP_FLASH, "k2_err": 0.0, "k2_bwd_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        flash["k2_err"] = max(flash["k2_err"],
                              check_flash(TP_FLASH, dtype, flash_mod))
        flash["k2_bwd_err"] = max(flash["k2_bwd_err"], check_flash_grad(
            TP_FLASH, dtype, flash_mod, flash_kernel))
    flash["forward"] = time_flash_turns(flash_mod, TP_FLASH)
    flash["backward"] = time_flash_bwd_turns(flash_mod, flash_kernel,
                                             TP_FLASH)
    for way, t in (("K2", flash["forward"]), ("K2'", flash["backward"])):
        log(f"phase 29 {way} at the TP-local layer {TP_FLASH}, bf16: device "
            f"{t['device_ms']:.4f} ms (turns "
            f"{[round(x, 4) for x in t['device_ms_turns']]}), SDPA "
            f"{t['library_device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms "
            f"(events), bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    # the repaired cells' dry runs, fake CUDA beside fake CPU
    if not os.path.exists(cells_path):
        failures.append(f"the repaired cells' dry runs wrote nothing "
                        f"(exit code {cells_proc.exitcode})")
        cells = []
    else:
        with open(cells_path) as f:
            cells = json.load(f)
        failures += check_dry_cells(cells)
    # the dry run of the same cell beside what the ranks measured
    dry = dry_out
    dry["repaired_cells"] = cells
    rec, row = dry["record"], dry["roofline"]
    walls = [max(r["step_s"][i] for r in ranks) for i in range(run["steps"])]
    r0 = next(r for r in ranks if r["rank"] == 0)
    dry["measured"] = {
        "rank0_counted_flops": r0["counted"]["flops"],
        "flops_counted_over_predicted": r0["counted"]["flops"]
        / rec["flops_per_device"],
        "rank0_allocated_before_gib": r0["allocated_before_gib"],
        "rank0_peak_gib": r0["peak_gib"],
        "step_s": min(walls),
        "bound_share_of_step": max(row["compute_s"], row["memory_s"],
                                   row["collective_s"]) / min(walls)}
    mem = rec["memory"]
    log(f"phase 29 dry run (predicted from shapes; fake CUDA tensors, a "
        f"fake group of 4; rank 0): arguments "
        f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB (measured "
        f"allocated before the steps {r0['allocated_before_gib']:.3f}), "
        f"peak {rec['hbm_per_device'] / 2**30:.3f} GiB (measured "
        f"max_memory_allocated {r0['peak_gib']:.3f}), FLOPs a step "
        f"{rec['flops_per_device']:.6e} (counted on the card "
        f"{r0['counted']['flops']:.6e}, ratio "
        f"{dry['measured']['flops_counted_over_predicted']:.6f}); "
        f"collectives {rec['collective_breakdown']} (counted "
        f"{r0['counted']['collective_by_kind']}); roofline at the H100 "
        f"constants: compute {row['compute_s']:.3e} s, memory "
        f"{row['memory_s']:.3e} s, collective {row['collective_s']:.3e} s, "
        f"{row['dominant']}-bound; the measured step {min(walls):.4f} s is "
        f"{1 / dry['measured']['bound_share_of_step']:.1f}x its bound")
    tokens = run["batch"] * run["seq"]
    split_walls = [max(r["split"]["step_s"][i] for r in ranks)
                   for i in range(TP_SPLIT["steps"])]
    out = {"plans": plans, "Q": Q, "stages": S, "model": M, "ticks": T,
           "step_s": walls, "tokens_per_s": [tokens / w for w in walls],
           "ranks": ranks, "ranks_wall_s": ranks_s, "flash": flash,
           "split_keys": split_keys,
           "split_cell": {**TP_SPLIT, "step_s": split_walls,
                          "launches": {name: sum(r["split"]["launches"][name]
                                                 for r in ranks)
                                       for name in ranks[0]["launches"]}},
           "dry_run": dry,
           "launches": {name: sum(r["launches"][name] for r in ranks)
                        for name in ranks[0]["launches"]}}
    log(f"phase 29 {run['arch']} ({run['layers']} layers) over (stage {S} "
        f"x model {M}) on one card "
        f"(gloo, host-staged), Q {Q} (plan L_t {best['L_t']:.6f} s), T {T} "
        f"ticks; bf16 AdamW steps {[round(w, 4) for w in walls]} s "
        f"({[round(t) for t in out['tokens_per_s']]} tokens/s); device "
        f"busy a step per rank "
        f"{[[round(x, 1) for x in r['busy_ms']] for r in ranks]} ms; peak "
        f"per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB; "
        f"ranks' processes {ranks_s:.1f} s; the vocabulary-parallel head "
        f"and the model group's sums: tp_reduce "
        f"{[r['transfer_bytes']['tp_reduce'] for r in ranks]} B and "
        f"{[round(r['transfer_s']['tp_reduce'], 3) for r in ranks]} s a "
        f"step per rank; {TP_SPLIT['arch']} over (stage 1 x model 4) bf16 "
        f"steps {[round(w, 4) for w in split_walls]} s")
    if failures:
        raise AssertionError("phase 29: " + "; ".join(failures))
    return out


def timed(fn, device: str):
    """(fn(), wall seconds), the device synchronized on both sides."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def build_all(modules) -> dict:
    """Build every kernel library at once (one nvcc per source, started
    together); returns {library name: seconds}."""
    def build(mod):
        t0 = time.perf_counter()
        mod._library()
        return mod.LIB_NAME, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        return dict(pool.map(build, modules))


def bwd_libraries(flash_kernel, wkv6_kernel) -> list:
    """K2' and K3' as ``build_all`` entries (their own libraries)."""
    from types import SimpleNamespace
    return [SimpleNamespace(LIB_NAME=flash_kernel.BWD_LIB_NAME,
                            _library=flash_kernel._bwd_library),
            SimpleNamespace(LIB_NAME=wkv6_kernel.BWD_LIB_NAME,
                            _library=wkv6_kernel._bwd_library)]


def bwd_sass_and_occupancy(_build, flash_kernel, wkv6_kernel) -> tuple:
    """Phase 14: the tensor-core instructions (HMMA/HGMMA) in the SASS of
    the bf16 kernels of K2' (dk/dv and dq at every head size) and of K3'
    (its passes B1 and B2, both entries), and each one's resident blocks
    per SM;
    raises if a kernel has no tensor-core instruction."""
    k2 = {("dkdv" if "dkdv" in name else "dq") + " hd "
          + re.search(r"ILi(\d+)E", name).group(1)
          + (" window" if "Lb1E" in name else ""): n
          for name, n in _build.tensor_core_ops(
              _build.sass(flash_kernel.BWD_LIB_NAME, flash_kernel.BWD_SOURCES),
              "_mma_kernel").items()}
    # dk/dv twice a head size (without and with the window's terms), dq once
    if len(k2) != 3 * len(flash_kernel.HEAD_DIMS) or min(k2.values()) == 0:
        raise AssertionError(f"K2' bf16 kernels lack tensor-core "
                             f"instructions in their SASS: {k2}")
    k2_blocks = {f"{kern} hd {hd}": flash_kernel.blocks_per_sm(hd, kern)
                 for kern in ("dkdv", "dq") for hd in flash_kernel.HEAD_DIMS}
    k3 = {("B1" if "states" in name else "B2")
          + (" bf16" if "bfloat16" in name else " f32"): n
          for name, n in _build.tensor_core_ops(
              _build.sass(wkv6_kernel.BWD_LIB_NAME, wkv6_kernel.BWD_SOURCES),
              "wkv6_bwd").items() if "du_kernel" not in name}
    if len(k3) != 4 or min(k3.values()) == 0:
        raise AssertionError(f"K3' kernels lack tensor-core instructions "
                             f"in their SASS: {k3}")
    k3_blocks = {f"B{p} {str(dt)[6:]}":
                 wkv6_kernel.blocks_per_sm(p, dt, backward=True)
                 for p in (1, 2) for dt in (torch.bfloat16, torch.float32)}
    log(f"K2' SASS: tensor-core instructions (HMMA/HGMMA) by kernel {k2}; "
        f"resident blocks per SM {k2_blocks}")
    log(f"K3' SASS: tensor-core instructions (HMMA) by kernel {k3}; "
        f"resident blocks per SM {k3_blocks}")
    return k2, k2_blocks, k3, k3_blocks


def log_ptxas(_build, name):
    for line in _build.build_log(name).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time-k1", action="store_true",
                    help="only time K1 (time_k1) and print its JSON")
    ap.add_argument("--time-k3", action="store_true",
                    help="only time K3 (time_k3) and print its JSON")
    ap.add_argument("--grads", action="store_true",
                    help="only build and check K2' and K3' (phases 14-16) "
                    "and print their JSON")
    ap.add_argument("--dense", action="store_true",
                    help="only build K2 and K2' and run phases 19-21 (the "
                    "window, the dense models, the dense servers) and "
                    "print their JSON")
    ap.add_argument("--moe", action="store_true",
                    help="only build K2 and K2' and run phases 22-24 (K2 "
                    "and K2' at the MoE and VLM layer shapes, the MoE and "
                    "VLM models, their servers) and print their JSON")
    ap.add_argument("--hybrid-audio", action="store_true",
                    help="only build K2 and K2' and run phases 25-27 (the "
                    "hybrid and audio models, K2 and K2' at their shapes, "
                    "their servers) and print their JSON")
    ap.add_argument("--spmd", action="store_true",
                    help="only build the kernels and run phase 28 (the "
                    "stage pipeline across two ranks on the card) and print "
                    "its JSON")
    ap.add_argument("--tp", action="store_true",
                    help="only build K2 and K2' and run phase 29 (the "
                    "'model' axis inside the pipeline's stages, its dry run "
                    "and roofline) and print its JSON")
    ap.add_argument("--src", help="import repro_torch from this directory "
                    "(another checkout's src/) instead of this one's")
    opts = ap.parse_args(argv)
    if opts.src:
        global OTHER_SRC
        OTHER_SRC = True
        sys.path.insert(0, os.path.abspath(opts.src))
    # 1. device ----------------------------------------------------------
    mark_phase("1")
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs "
            "an NVIDIA GPU")
        return 1
    smi = card_name()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    if opts.time_k1:
        import repro_torch.core as core
        from repro_torch.core import shortest_path
        from repro_torch.kernels import minplus
        log(f"repro_torch from {os.path.dirname(minplus.__file__)}")
        shapes, _ = k1_shapes(core, shortest_path)
        log(json.dumps({"k1_times": time_k1(minplus, core, shapes),
                        "card": smi}))
        return 0
    if opts.time_k3:
        from repro_torch.kernels import rwkv6 as wkv6_mod
        log(f"repro_torch from {os.path.dirname(wkv6_mod.__file__)}")
        log(json.dumps({"k3_times": time_k3(wkv6_mod), "card": smi}))
        return 0
    if opts.grads:
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash as flash_mod
        from repro_torch.kernels import rwkv6 as wkv6_mod
        from repro_torch.kernels.flash import kernel as flash_kernel
        from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
        built = build_all([flash_kernel, wkv6_kernel]
                          + bwd_libraries(flash_kernel, wkv6_kernel))
        log("build: " + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()))
        for name in (flash_kernel.BWD_LIB_NAME, wkv6_kernel.BWD_LIB_NAME):
            log_ptxas(_build, name)
        log(json.dumps({"grads": grad_kernel_phases(
            flash_mod, flash_kernel, wkv6_mod, wkv6_kernel), "card": smi}))
        return 0
    if opts.dense:
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash as flash_mod
        from repro_torch.kernels import minplus
        from repro_torch.kernels import rwkv6 as wkv6_mod
        from repro_torch.kernels.flash import kernel as flash_kernel
        from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
        from repro_torch.launch.serve import BatchedServer, Request
        built = build_all([flash_kernel]
                          + bwd_libraries(flash_kernel, wkv6_kernel)[:1])
        log("build: " + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()))
        for name in (flash_kernel.LIB_NAME, flash_kernel.BWD_LIB_NAME):
            log_ptxas(_build, name)
        t0 = time.perf_counter()
        window = window_phase(flash_mod, flash_kernel)
        t1 = time.perf_counter()
        models = dense_model_phase(flash_mod)
        t2 = time.perf_counter()
        served = serve_phase(
            BatchedServer, Request, flash_mod,
            (flash_mod.flash_attention, wkv6_mod.wkv6, minplus.sweep_minplus))
        log(f"phase walls: 19 {t1 - t0:.1f} s, 20 {t2 - t1:.1f} s, 21 "
            f"{time.perf_counter() - t2:.1f} s")
        log(json.dumps({"dense": {"window": window, "models": models,
                                  "serve": served}, "card": smi}))
        return 0
    if opts.moe:
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash as flash_mod
        from repro_torch.kernels import minplus
        from repro_torch.kernels import rwkv6 as wkv6_mod
        from repro_torch.kernels.flash import kernel as flash_kernel
        from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
        from repro_torch.launch.serve import BatchedServer, Request
        built = build_all([flash_kernel]
                          + bwd_libraries(flash_kernel, wkv6_kernel)[:1])
        log("build: " + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()))
        log(json.dumps({"moe": moe_phases(
            flash_mod, flash_kernel, BatchedServer, Request,
            (flash_mod.flash_attention, wkv6_mod.wkv6,
             minplus.sweep_minplus)), "card": smi}))
        return 0
    if opts.hybrid_audio:
        from repro_torch.kernels import flash as flash_mod
        from repro_torch.kernels import minplus
        from repro_torch.kernels import rwkv6 as wkv6_mod
        from repro_torch.kernels.flash import kernel as flash_kernel
        from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
        from repro_torch.launch.serve import BatchedServer, Request
        built = build_all([flash_kernel]
                          + bwd_libraries(flash_kernel, wkv6_kernel)[:1])
        log("build: " + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()))
        log(json.dumps({"hybrid_audio": ha_phases(
            flash_mod, flash_kernel, BatchedServer, Request,
            (flash_mod.flash_attention, wkv6_mod.wkv6,
             minplus.sweep_minplus)), "card": smi}))
        return 0

    spmd_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "smoke_28")
    tp_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_29")
    if opts.tp:
        from repro_torch.kernels import flash as flash_mod
        from repro_torch.kernels.flash import kernel as flash_kernel
        from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
        mark_phase("2")
        built = build_all([flash_kernel]
                          + bwd_libraries(flash_kernel, wkv6_kernel)[:1])
        log("build: " + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()))
        mark_phase("29")
        tp_out = tp_phase(tp_dir, flash_mod, flash_kernel)
        log(json.dumps({"tp": tp_out, "card": smi}))
        log(profiler_line())
        return 0
    if opts.spmd:
        from repro_torch.kernels.flash import kernel as flash_kernel
        from repro_torch.kernels.minplus import kernel as minplus_kernel
        from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
        mark_phase("2")
        built = build_all([minplus_kernel, wkv6_kernel, flash_kernel]
                          + bwd_libraries(flash_kernel, wkv6_kernel))
        log("build: " + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()))
        mark_phase("28")
        spmd_out = spmd_phase(spmd_dir)
        log(json.dumps({"spmd": spmd_out, "card": smi}))
        log(profiler_line())
        return 0

    from repro_torch import obs
    from repro_torch.compression import make_link_hooks
    from repro_torch.core import (breakdown, evaluate_under_fluctuation,
                                  exhaustive_joint, no_pipeline, num_fills,
                                  optimal, ours, Planner, rc_op, rp_oc)
    from repro_torch.core import shortest_path
    from repro_torch.data import classification_batches
    from repro_torch.kernels import _build
    from repro_torch.kernels import minplus
    from repro_torch.kernels.minplus import kernel as minplus_kernel
    from repro_torch.kernels import rwkv6 as wkv6_mod
    from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
    from repro_torch.kernels import flash as flash_mod
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.models import vgg
    from repro_torch.pipeline import (SplitLearningExecutor,
                                      simulate_from_breakdown)

    # 2. build every kernel, in parallel --------------------------------------
    mark_phase("2")
    t0 = time.perf_counter()
    built = build_all([minplus_kernel, wkv6_kernel, flash_kernel]
                      + bwd_libraries(flash_kernel, wkv6_kernel))
    log(f"build: K1, K3, K2, K2', K3' in parallel in "
        f"{time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{n} {t:.2f} s" for n, t in built.items()) + ")")
    log_ptxas(_build, minplus_kernel.LIB_NAME)

    # 3. kernel ----------------------------------------------------------
    mark_phase("3")
    import repro_torch.core as core
    shapes, ctx = k1_shapes(core, shortest_path)
    profile, net, plan_cpu = ctx["profile"], ctx["net"], ctx["plan_cpu"]
    cpu_plan_s = ctx["cpu_plan_s"]
    fleet_prof, fleet_net = ctx["fleet_prof"], ctx["fleet_net"]
    fleet_planner, fleet_cpu = ctx["fleet_planner"], ctx["fleet_cpu"]
    k1 = {label: check_kernel(label, args, minplus)
          for label, args in shapes.items()}
    quick = k1["quickstart window"]
    # past the fleet: a graph no 16-block cluster holds in float64 (the
    # tiled route), at one threshold and at 256
    big = big_graph(core)
    for label, args in (("96-server window", (*big[:7], big[7][-1:])),
                        ("96-server all-thresholds", big)):
        if k1_route(minplus, [a.cuda() if torch.is_tensor(a) else a
                              for a in args])["launch_route"] != "tiled":
            raise AssertionError(f"K1 {label}: expected the tiled route")
        check_kernel(label, args, minplus, timed=False)
    # under beta*: no feasible path; under every beta nothing is reachable
    # and the sweep exits after its first layer
    fdp = fleet_planner._dp(16, fleet_planner.default_K(None))
    fargs = fdp._kernel_args()
    beta_star = float(minplus.sweep_plain(
        *fargs, torch.tensor([math.inf], dtype=torch.float64), mode="max")[0])
    betas = fdp.all_betas()
    under = torch.stack([betas[betas < beta_star].max(), betas.min() - 1.0])
    for mode in ("sum", "max"):
        ran = layers_run((*fargs, under), mode).tolist()
        log(f"K1 fleet under beta* = {beta_star!r} ({mode}): layers run "
            f"{ran} of {fdp.K - 1}")
        if ran[1] != 1:
            raise AssertionError("the threshold under every beta should "
                                 "stop after one layer")
    check_kernel("fleet under beta*", (*fargs, under), minplus, timed=False)
    for mode in ("sum", "max"):
        if not torch.isinf(minplus.sweep_minplus(
                *[a.cuda() if torch.is_tensor(a) else a for a in fargs],
                under.cuda(), mode=mode)).all():
            raise AssertionError(f"K1 ({mode}) found a path under beta*")

    fleet_gpu = Planner(fleet_prof, fleet_net, device="cuda").solve(16, 128)
    assert (fleet_gpu.solution.cuts, fleet_gpu.solution.placement,
            fleet_gpu.objective) == (fleet_cpu.solution.cuts,
                                     fleet_cpu.solution.placement,
                                     fleet_cpu.objective), "fleet solve"
    log(f"fleet solve (b=16, B=128) equal on cuda and cpu: "
        f"cuts={fleet_gpu.solution.cuts} obj={fleet_gpu.objective!r}")

    # 4. plan (the main path) ---------------------------------------------
    mark_phase("4")
    minplus.sweep_minplus.launches = 0
    wkv6_mod.wkv6.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = ours(profile, net, B=512, b0=20, device="cuda")
    torch.cuda.synchronize()
    gpu_plan_s = time.perf_counter() - t0
    launches = minplus.sweep_minplus.launches
    keys = ("b", "T_f", "T_i", "L_t", "objective")
    got = (plan.solution.cuts, plan.solution.placement,
           *(getattr(plan, k) for k in keys))
    want = (plan_cpu.solution.cuts, plan_cpu.solution.placement,
            *(getattr(plan_cpu, k) for k in keys))
    if got != want:
        raise AssertionError(f"ours on cuda {got} != cpu {want}")
    if launches <= 0:
        raise AssertionError("ours on cuda did not launch K1")
    log(f"plan: cuts={plan.solution.cuts} placement={plan.solution.placement}"
        f" b={plan.b} T_f={float(plan.T_f)!r} T_i={float(plan.T_i)!r} "
        f"L_t={float(plan.L_t)!r} "
        f"(bit-equal to the CPU run); K1 launches={launches}; planner wall "
        f"{gpu_plan_s:.3f} s on cuda, {cpu_plan_s:.3f} s on cpu")
    np_plan = no_pipeline(profile, net, B=512, device="cuda")
    np_cpu = no_pipeline(profile, net, B=512, device="cpu")
    assert (np_plan.solution.cuts, np_plan.L_t) == (np_cpu.solution.cuts,
                                                    np_cpu.L_t), "no_pipeline"
    log(f"no-pipeline L_t={float(np_plan.L_t)!r} -> pipelining speedup "
        f"{np_plan.L_t / plan.L_t:.2f}x")
    sim = simulate_from_breakdown(breakdown(profile, net, plan.solution,
                                            plan.b),
                                  num_fills(512, plan.b) + 1)
    if not (math.isfinite(sim.makespan) and abs(sim.rel_gap) < 1e-9):
        raise AssertionError(f"Eq. (14) check: gap {sim.rel_gap}")
    log(f"event-sim makespan {float(sim.makespan)!r} vs analytic "
        f"{float(sim.analytic)!r} "
        f"(gap {sim.rel_gap:.2e})")

    # 4b. the b-sweep and the comparison baselines (Figs. 5-7) -------------
    mark_phase("4b")
    # K1's graph axis at the shapes Planner.solve_many launches, recorded
    # from the planner on the CPU: the quickstart's exhaustive_joint(B=512,
    # b_step=4) and the fleet's b-sweep (B=128, b_step=16: 8 graphs)
    t0 = time.perf_counter()
    with recording_sweeps(shortest_path) as qcalls:
        ej_cpu = exhaustive_joint(profile, net, 512, b_step=4, device="cpu")
    ej_cpu_s = time.perf_counter() - t0
    with recording_sweeps(shortest_path) as fcalls:
        exhaustive_joint(fleet_prof, fleet_net, 128, b_step=16, device="cpu")
    graph_cases = {}
    for tag, calls in (("quickstart b-sweep", qcalls),
                       ("fleet b-sweep", fcalls)):
        stacked = [(args, graph) for args, _, graph in calls
                   if graph is not None]
        if len(stacked) != 2:
            raise AssertionError(f"{tag}: solve_many made {len(stacked)} "
                                 "graph-axis K1 calls, expected 2")
        graph_cases[f"{tag} phase B"] = stacked[0]
        graph_cases[f"{tag} phase C"] = stacked[1]
    # groups that do not fill whole tiles: the tiled route's padding
    ragged = ragged_graph_window(qcalls[0][0], (37, 1, 9, 70, 2, 5, 44, 13))
    tile = graph_route(minplus, ragged[0], ragged[1]).get("tile", 0)
    if tile < 2 or all(len(v) % tile == 0
                       for v in graph_groups(ragged[1]).values()):
        raise AssertionError(f"the ragged case should take the tiled route "
                             f"with groups that do not divide T={tile}")
    graph_cases["quickstart ragged tiles"] = ragged
    k1_graph = {label: check_graph_axis(label, args, graph, minplus)
                for label, (args, graph) in graph_cases.items()}

    def same_plan(a, b) -> bool:
        return ((a.solution.cuts, a.solution.placement,
                 *(getattr(a, k) for k in keys))
                == (b.solution.cuts, b.solution.placement,
                    *(getattr(b, k) for k in keys)))

    minplus.sweep_minplus.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ej = exhaustive_joint(profile, net, 512, b_step=4, device="cuda")
    torch.cuda.synchronize()
    ej_s = time.perf_counter() - t0
    ej_launches = minplus.sweep_minplus.launches
    if not same_plan(ej, ej_cpu):
        raise AssertionError(f"exhaustive_joint on cuda {ej} != cpu {ej_cpu}")
    if ej_launches != 2:
        raise AssertionError(f"exhaustive_joint made {ej_launches} K1 "
                             "launches, expected 2 (phases B and C)")
    log(f"exhaustive_joint(B=512, b_step=4): cuts={ej.solution.cuts} "
        f"placement={ej.solution.placement} b={ej.b} L_t={float(ej.L_t)!r} "
        f"(bit-equal to the CPU run); K1 launches={ej_launches}; wall "
        f"{ej_s:.3f} s on cuda, {ej_cpu_s:.3f} s on cpu")
    baselines = {}
    with obs.enabled_scope() as reg:
        for name, scheme in (("rc_op", rc_op), ("rp_oc", rp_oc)):
            reg.reset()
            minplus.sweep_minplus.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = scheme(profile, net, 512, seed=7, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = minplus.sweep_minplus.launches
            masked = obs.counter("planner.masked_sweeps")
            t0 = time.perf_counter()
            want = scheme(profile, net, 512, seed=7, device="cpu")
            wall_cpu = time.perf_counter() - t0
            if not same_plan(got, want):
                raise AssertionError(f"{name} on cuda {got} != cpu {want}")
            if launched != 0 or masked == 0:
                raise AssertionError(f"{name}: {launched} K1 launches, "
                                     f"{masked} masked sweeps (expected 0 "
                                     "and > 0)")
            if not plan.L_t <= got.L_t * (1 + 1e-9):
                raise AssertionError(f"ours L_t {plan.L_t} > {name} "
                                     f"{got.L_t}")
            baselines[name] = {"L_t": got.L_t, "b": got.b,
                               "masked_sweeps": masked,
                               "k1_launches": launched, "wall_s": wall,
                               "cpu_wall_s": wall_cpu}
            log(f"{name}(seed=7): cuts={got.solution.cuts} "
                f"placement={got.solution.placement} b={got.b} "
                f"L_t={float(got.L_t)!r} (bit-equal to the CPU run; ours "
                f"{plan.L_t / got.L_t:.3f}x of it); planner.masked_sweeps "
                f"{masked}, K1 launches {launched}; wall {wall:.3f} s on "
                f"cuda, {wall_cpu:.3f} s on cpu")
    obs.reset()
    minplus.sweep_minplus.launches = 0
    t0 = time.perf_counter()
    opt = optimal(profile, net, 512, device="cuda")
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    opt_launches = minplus.sweep_minplus.launches
    if not same_plan(opt, optimal(profile, net, 512, device="cpu")):
        raise AssertionError("optimal on cuda differs from the CPU run")
    gap = plan.L_t / opt.L_t - 1
    log(f"optimal (exhaustive over b = 1..512): b={opt.b} "
        f"L_t={float(opt.L_t)!r} (bit-equal to the CPU run), K1 launches "
        f"{opt_launches}, wall {opt_s:.3f} s on cuda; Fig. 7's gap "
        f"ours / optimal - 1 = {gap:.3e}")
    fluct = evaluate_under_fluctuation(profile, net, plan, 0.2, draws=16,
                                       seed=0)
    fluct_cpu = evaluate_under_fluctuation(profile, net, plan_cpu, 0.2,
                                           draws=16, seed=0)
    if dataclasses.asdict(fluct) != dataclasses.asdict(fluct_cpu):
        raise AssertionError(f"fluctuation report {fluct} != {fluct_cpu}")
    log(f"fluctuation (cv 0.2, 16 draws, seed 0) of the cuda plan equals the "
        f"CPU plan's: mean {fluct.mean_latency!r}, p95 "
        f"{fluct.p95_latency!r}, degradation {fluct.degradation!r}")

    # 4c. warm replans, the batched device planner, the coordinator -------
    mark_phase("4c")
    from repro_torch import ft
    from repro_torch.core import planner_device
    fprof, fnet = bench30_instance(core)
    bs = list(range(1, 65))
    exact_cpu, exact_cpu_s = timed(
        lambda: Planner(fprof, fnet, device="cpu").solve_many(bs, 64), "cpu")
    with recording_sweeps(planner_device) as dcalls:
        dev_cpu = Planner(fprof, fnet, device="cpu").solve_many(
            bs, 64, backend="device", dtype=torch.float64)
    if [msp_key(r) for r in dev_cpu] != [msp_key(r) for r in exact_cpu]:
        raise AssertionError("device backend (f64, cpu) != exact backend")
    if [graph is None for _, _, graph in dcalls] != [False, False]:
        raise AssertionError(f"device backend made {len(dcalls)} K1 calls, "
                             "expected 2 graph-axis calls (phases B, C)")
    k1_device = {
        f"bench30 device backend phase {ph}": check_graph_axis(
            f"bench30 device backend phase {ph}", args, graph, minplus,
            time_f32=True)
        for ph, (args, _, graph) in zip("BC", dcalls)}
    backend_runs = {}
    for name, kw in (("exact", {}),
                     ("device_f64", dict(backend="device",
                                         dtype=torch.float64)),
                     ("device_f32", dict(backend="device",
                                         dtype=torch.float32))):
        pl = Planner(fprof, fnet, device="cuda")
        walls, counts = [], []
        for _ in range(3):        # the first call builds the graph caches
            minplus.sweep_minplus.launches = 0
            res, wall = timed(lambda: pl.solve_many(bs, 64, **kw), "cuda")
            walls.append(wall)
            counts.append(minplus.sweep_minplus.launches)
        backend_runs[name] = {"results": res, "walls_s": walls,
                              "k1_launches": counts}
    want = [msp_key(r) for r in exact_cpu]
    for name in ("exact", "device_f64"):
        if [msp_key(r) for r in backend_runs[name]["results"]] != want:
            raise AssertionError(f"solve_many {name} on cuda != exact cpu")
    bad = [b for b, w, g in zip(bs, exact_cpu,
                                backend_runs["device_f32"]["results"])
           if not f32_contract(w, g)]
    if bad:
        raise AssertionError(f"device backend f32 misses the contract at "
                             f"b = {bad}")
    for name in ("device_f64", "device_f32"):
        if backend_runs[name]["k1_launches"] != [2, 2, 2]:
            raise AssertionError(f"{name}: K1 launches "
                                 f"{backend_runs[name]['k1_launches']} per "
                                 "call, expected 2 (phases B and C)")
    f32_rel = max(abs(g.objective - w.objective) / abs(w.objective)
                  for w, g in zip(exact_cpu,
                                  backend_runs["device_f32"]["results"])
                  if w.feasible)
    log(f"solve_many(b = 1..64, B = 64) on the bench30 fleet (24 servers, "
        f"30 layers; {sum(r.feasible for r in exact_cpu)} feasible b): "
        f"device f64 equal to the CPU's and to the exact backend on cuda, "
        f"f32 within the contract (max objective rel diff {f32_rel:.3e}); "
        + "; ".join(f"{n} walls {[round(w, 4) for w in r['walls_s']]} s, "
                    f"K1 launches {r['k1_launches']}"
                    for n, r in backend_runs.items())
        + f"; exact on cpu {exact_cpu_s:.4f} s")

    deltas = replan_deltas(ft, len(fnet.nodes))
    replans = {}
    with obs.enabled_scope() as reg:
        for dev in ("cuda", "cpu"):
            pl = Planner(fprof, fnet, device=dev)
            pl.solve(8, 64)                       # seeds the warm hint
            reg.reset()
            minplus.sweep_minplus.launches = 0
            res, wall = timed(lambda: [pl.update(d).solve(8, 64)
                                       for d in deltas], dev)
            replans[dev] = {"results": res, "wall_s": wall, "planner": pl,
                         "hits": obs.counter("planner.incremental_hits"),
                         "cold_solves": obs.counter("planner.cold_solves"),
                         "k1_launches": minplus.sweep_minplus.launches}
    obs.reset()
    cold_net, cold = fnet, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d in deltas:
        cold_net, _ = ft.Coordinator.preview(cold_net, None, d)
        cold.append(Planner(fprof, cold_net, device="cuda").solve(8, 64))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    for k, (w, c, p) in enumerate(zip(replans["cuda"]["results"], cold,
                                      replans["cpu"]["results"])):
        if not msp_key(w) == msp_key(c) == msp_key(p):
            raise AssertionError(f"delta {k} ({deltas[k]}): warm cuda "
                                 f"{msp_key(w)}, cold {msp_key(c)}, warm "
                                 f"cpu {msp_key(p)}")
    if replans["cuda"]["hits"] != 16 or replans["cpu"]["hits"] != 16:
        raise AssertionError(f"incremental hits {replans['cuda']['hits']} "
                             f"(cuda), {replans['cpu']['hits']} (cpu), "
                             "expected 16")
    patched = replans["cuda"]["planner"].graph(8)
    fresh = core.GraphFactory(fprof, cold_net, device="cuda").graph(8)
    on_cpu = replans["cpu"]["planner"].graph(8)
    for name in ("comm_cost", "comm_beta", "seg_cost", "seg_beta",
                 "src_cost", "src_beta"):
        got = getattr(patched, name)
        if not (torch.equal(got, getattr(fresh, name))
                and torch.equal(got.cpu(), getattr(on_cpu, name))):
            raise AssertionError(f"patched {name} != a fresh assembly")
    log(f"warm replans (16 deltas of bench_planner.py, b = 8, B = 64): "
        f"each equal to a cold solve on a fresh cuda Planner and to the "
        f"CPU's warm solve; incremental hits {replans['cuda']['hits']}; the "
        f"patched graph equal to a fresh assembly; warm "
        f"{replans['cuda']['wall_s']:.4f} s on cuda "
        f"({replans['cuda']['k1_launches']} K1 launches), "
        f"{replans['cpu']['wall_s']:.4f} s on cpu; cold on cuda "
        f"{cold_s:.4f} s")

    coord_log = []
    cc, coord_init_s = timed(
        lambda: ft.Coordinator(profile, net, B=512, device="cuda"), "cuda")
    cp = ft.Coordinator(profile, net, B=512, device="cpu")
    minplus.sweep_minplus.launches = 0
    for ev in (ft.RateChange(1, 2, 0.25),
               ft.Straggler(len(net.nodes) - 1, 3.0), ft.NodeFailure(1)):
        oc, wall = timed(lambda: cc.apply(ev), "cuda")
        op = cp.apply(ev)
        got = (cc.plan.solution.cuts, cc.plan.solution.placement, cc.plan.b,
               cc.plan.L_t)
        if got != (cp.plan.solution.cuts, cp.plan.solution.placement,
                   cp.plan.b, cp.plan.L_t) or oc.action != op.action:
            raise AssertionError(f"coordinator after {ev}: cuda {got} "
                                 f"({oc.action}) != cpu {cp.plan} "
                                 f"({op.action})")
        coord_log.append({"event": repr(ev), "action": oc.action,
                          "cuts": list(got[0]), "placement": list(got[1]),
                          "b": got[2], "L_t": got[3], "wall_s": wall,
                          "cpu_solve_s": op.solve_seconds})
        log(f"coordinator {ev}: {oc.action}, cuts={got[0]} "
            f"placement={got[1]} b={got[2]} L_t={float(got[3])!r} (equal to "
            f"the CPU coordinator's); {wall:.4f} s on cuda, "
            f"{op.solve_seconds:.4f} s on cpu")
    coord_launches = minplus.sweep_minplus.launches
    log(f"coordinator: built in {coord_init_s:.4f} s on cuda; K1 launches "
        f"over the three events {coord_launches}")

    # 4d. sim: the simulator's engines on the card ---------------------------
    mark_phase("4d")
    sim_out = sim_phase(core, minplus, profile, net, plan)

    # 4e. planning by the simulator and by tail risk, fuzz, policies ----------
    mark_phase("4e")
    t0 = time.perf_counter()
    robust_out = planning_phase(
        core, minplus, profile, net, plan,
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "smoke_4e"))
    robust_out["phase_wall_s"] = time.perf_counter() - t0
    log(f"4e: phase wall {robust_out['phase_wall_s']:.2f} s")

    # 5. train -------------------------------------------------------------
    mark_phase("5")
    # the comparison runs in full float32: cuDNN convolutions default to
    # TF32 on the card, so TF32 is switched off for this phase
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = ours(profile, net, B=16, b0=4, device="cuda")
    params = vgg.init_params(torch.Generator().manual_seed(0))
    batches = classification_batches(batch=16, seed=0)
    rounds = [next(batches) for _ in range(2)]
    ex_gpu = SplitLearningExecutor(small, profile, net, params=params,
                                   device="cuda")
    ex_cpu = SplitLearningExecutor(small, profile, net, params=params,
                                   device="cpu")
    for r, batch in enumerate(rounds):
        lg = ex_gpu.train_round(batch, lr=0.05, momentum=0.9)
        lc = ex_cpu.train_round(batch, lr=0.05, momentum=0.9)
        if not (math.isfinite(lg) and abs(lg - lc) <= LOSS_RTOL * abs(lc)):
            raise AssertionError(f"round {r}: loss cuda {lg} vs cpu {lc}")
        log(f"train round {r} (B=16, q={small.num_microbatches}, TF32 off): "
            f"loss cuda {lg!r} cpu {lc!r} (rel {abs(lg - lc) / abs(lc):.2e}, "
            f"tolerance {LOSS_RTOL})")
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(ex_gpu.full_params.parameters(),
                                ex_cpu.full_params.parameters()))
    log(f"parameters after 2 rounds: max abs diff cuda vs cpu {pdiff:.3e}")
    for codec in ("int8", "topk"):
        ex_gpu = SplitLearningExecutor(small, profile, net, params=params,
                                       hooks=make_link_hooks(codec),
                                       device="cuda")
        ex_cpu = SplitLearningExecutor(small, profile, net, params=params,
                                       hooks=make_link_hooks(codec),
                                       device="cpu")
        lg = ex_gpu.train_round(rounds[0], lr=0.05, momentum=0.9)
        lc = ex_cpu.train_round(rounds[0], lr=0.05, momentum=0.9)
        if not (math.isfinite(lg) and abs(lg - lc) <= LOSS_RTOL * abs(lc)):
            raise AssertionError(f"{codec} hooks: loss cuda {lg} vs cpu {lc}")
        log(f"train round with {codec} link hooks (TF32 off): loss cuda "
            f"{lg!r} cpu {lc!r} (rel {abs(lg - lc) / abs(lc):.2e}, tolerance "
            f"{LOSS_RTOL})")

    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults again
    ex = SplitLearningExecutor(plan, profile, net, seed=0, device="cuda")
    big = classification_batches(batch=512, seed=1)
    ex.train_round(next(big), lr=0.01, momentum=0.9)         # warm-up
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(3):
        batch = next(big)
        t0 = time.perf_counter()
        losses.append(ex.train_round(batch, lr=0.01, momentum=0.9))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"B=512 losses {losses}")
    log(f"train B=512 plan (b={plan.b}, q={plan.num_microbatches}, cuDNN "
        f"TF32 default): ms/round {[round(t, 3) for t in times]}, losses "
        f"{[round(v, 4) for v in losses]}")
    del ex, ex_gpu, ex_cpu, batch
    torch.cuda.empty_cache()

    # 6. build K3 -----------------------------------------------------------
    mark_phase("6")
    log(f"build: K3 in {built[wkv6_kernel.LIB_NAME]:.2f} s (phase 2)")
    log_ptxas(_build, wkv6_kernel.LIB_NAME)
    k3_hmma = {
        ("states" if "states" in name else "outputs")
        + (" bf16" if "bfloat16" in name else " f32"): n
        for name, n in _build.tensor_core_ops(
            _build.sass(wkv6_kernel.LIB_NAME, wkv6_kernel.SOURCES),
            "wkv6").items()}
    if len(k3_hmma) != 4 or min(k3_hmma.values()) == 0:
        raise AssertionError(f"K3's kernels lack tensor-core instructions in "
                             f"their SASS: {k3_hmma}")
    k3_blocks = {f"pass {p} {str(dt)[6:]}": wkv6_kernel.blocks_per_sm(p, dt)
                 for p in (1, 2) for dt in (torch.bfloat16, torch.float32)}
    log(f"K3 SASS: tensor-core instructions (HMMA) by kernel {k3_hmma}; "
        f"resident blocks per SM {k3_blocks}")

    # 7. K3 against its plain versions ----------------------------------------
    mark_phase("7")
    # phases 7 and 8 compare in full float32: TF32 off for every matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    k3_err = 0.0
    for shape in WKV_SHAPES + WKV_CROSSING + [SERVED_WKV, ODD_WKV]:
        for dtype in (torch.float32, torch.bfloat16):
            k3_err = max(k3_err, check_wkv6(shape, dtype, wkv6_mod))
    k3_strong_err = max(check_wkv6(shape, dtype, wkv6_mod, STRONG_DECAY)
                        for shape in STRONG_WKV
                        for dtype in (torch.float32, torch.bfloat16))
    B, S, H, hd, chunk = SERVED_WKV
    for dtype in (torch.float32, torch.bfloat16):
        r, k, v, lw, u, s0 = wkv6_inputs(B, S, H, hd, dtype, seed=11)
        y, s_fin = wkv6_mod.wkv6(r, k, v, lw, u, s0, chunk=chunk)
        h = S // 2
        y1, s1 = wkv6_mod.wkv6(r[:, :h], k[:, :h], v[:, :h], lw[:, :h], u,
                               s0, chunk=chunk)
        y2, s2 = wkv6_mod.wkv6(r[:, h:], k[:, h:], v[:, h:], lw[:, h:], u,
                               s1, chunk=chunk)
        tol = WKV_TOL[dtype]
        if not (torch.allclose(torch.cat([y1, y2], 1), y, atol=tol, rtol=tol)
                and torch.allclose(s2, s_fin, atol=tol, rtol=tol)):
            raise AssertionError(f"K3 state threading {dtype}: halves "
                                 "differ from the whole sequence")
    log(f"K3 state threading (2 x {h} tokens, state carried) equals the "
        f"whole {S}-token scan in float32 and bfloat16")
    k3_times = time_k3(wkv6_mod)

    # 8. model check: cuda (K3) vs CPU (plain), float32 ----------------------
    mark_phase("8")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import rwkv6

    full = get_config("rwkv6-1.6b")
    cfg8 = dataclasses.replace(full, num_layers=2,
                               compute_dtype=torch.float32)
    cpu_model = rwkv6.init_params(cfg8, torch.Generator().manual_seed(0),
                                  "cpu")
    gpu_model = rwkv6.RWKV6(cfg8, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompt = torch.randint(0, full.vocab, (1, 512),
                           generator=torch.Generator().manual_seed(1))
    # 512 tokens (chunk 256) and 511 (chunk 1: the kernel's tiles cross
    # every chunk; the CPU's plain version steps token by token)
    for tokens in (prompt, prompt[:, :511]):
        before = wkv6_mod.wkv6.launches
        logits_g, state_g = rwkv6.prefill(gpu_model, tokens.cuda())
        torch.cuda.synchronize()
        if wkv6_mod.wkv6.launches - before != cfg8.num_layers:
            raise AssertionError("the cuda prefill did not go through K3")
        logits_c, state_c = rwkv6.prefill(cpu_model, tokens)
        errs = {"logits": rel_err(logits_g, logits_c),
                **{k: rel_err(state_g[k], state_c[k]) for k in state_c}}
        if not (torch.isfinite(logits_g).all()
                and max(errs.values()) <= MODEL_REL_TOL):
            raise AssertionError(f"model cuda vs cpu, {tokens.shape[1]} "
                                 f"tokens: {errs}")
        log(f"model ({cfg8.num_layers} layers, d {cfg8.d_model}, "
            f"{rwkv6.num_heads(cfg8)} heads, vocab {cfg8.vocab}, f32, "
            f"{tokens.shape[1]}-token prefill, chunk "
            f"{rwkv6.wkv_chunk(cfg8, tokens.shape[1])}): cuda (K3) vs cpu "
            f"(plain) max err / max magnitude "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tolerance {MODEL_REL_TOL})")
        del logits_c, state_c
    del cpu_model
    p128 = prompt[:, :128].cuda()
    logits_128, _ = rwkv6.prefill(gpu_model, p128)
    logits_d, state = rwkv6.prefill(gpu_model, p128[:, :64])
    for t in range(64, 128):
        logits_d, state = rwkv6.decode_step(gpu_model, state,
                                            p128[:, t:t + 1], t)
    if not torch.allclose(logits_d, logits_128, atol=DECODE_TOL,
                          rtol=DECODE_TOL):
        bad = float((logits_d - logits_128).abs().max())
        raise AssertionError(f"64 decode steps vs 128-token prefill: {bad}")
    log(f"64-token prefill + 64 decode steps == 128-token prefill within "
        f"{DECODE_TOL} (max abs diff "
        f"{float((logits_d - logits_128).abs().max()):.2e})")
    del gpu_model, logits_g, state_g, logits_d, logits_128, state
    torch.cuda.empty_cache()

    # 9. serve rwkv6-1.6b at full width (the main path of K3) ----------------
    mark_phase("9")
    prefill_s = []

    class TimedServer(BatchedServer):
        """Records each prefill's time; admission and decoding unchanged."""

        def _prefill_one(self, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._prefill_one(req)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            return out

    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30   # earlier phases' state
    t0 = time.perf_counter()
    srv = TimedServer("rwkv6-1.6b", reduced=False, batch=4, cache_len=1024,
                      seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = srv.api.param_count(srv.params)
    warm = srv.api.prefill(srv.params, {"tokens": prompt[:, :64].cuda()},
                           1024)        # casts the weights to bf16 once
    del warm
    rng = np.random.default_rng(0)
    reqs = [Request(rid, rng.integers(0, full.vocab, size=512)
                    .astype(np.int32), max_new=32) for rid in range(8)]
    for req in reqs:
        srv.submit(req)
    minplus.sweep_minplus.launches = 0
    wkv6_mod.wkv6.launches = 0
    stats = srv.run()
    torch.cuda.synchronize()
    k3_launches = wkv6_mod.wkv6.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if k3_launches != len(reqs) * full.num_layers:
        raise AssertionError(f"K3 launches {k3_launches} != "
                             f"{len(reqs) * full.num_layers}")
    done = stats["completed"]
    if not (len(done) == len(reqs) and all(
            len(r.generated) == 32 and r.done
            and all(0 <= t < full.vocab for t in r.generated)
            for r in done)):
        raise AssertionError(f"served {len(done)} of {len(reqs)} requests")
    check_logits, check_state = srv.api.prefill(
        srv.params, {"tokens": torch.as_tensor(reqs[0].prompt[None],
                                               device="cuda")}, 1024)
    if not (torch.isfinite(check_logits).all()
            and torch.isfinite(check_state["wkv"]).all()
            and int(torch.argmax(check_logits[0, -1])) == reqs[0].generated[0]):
        raise AssertionError("a fresh prefill of request 0 is not finite or "
                             "disagrees with its first served token")
    prefill_ms = [round(t * 1e3, 3) for t in prefill_s]
    decode_s = stats["seconds"] - sum(prefill_s)
    log(f"serve rwkv6-1.6b full width ({n_params} parameters, f32 params, "
        f"bf16 compute; init {init_s:.2f} s): {len(done)} requests x "
        f"{len(reqs[0].prompt)} prompt tokens, {stats['tokens']} decode "
        f"tokens in "
        f"{stats['seconds']:.3f} s; prefill ms per request {prefill_ms}; "
        f"decode {stats['tokens'] / decode_s:.2f} tokens/s; K3 launches "
        f"{k3_launches}; peak device memory {peak_gib:.2f} GiB, of which "
        f"{held_gib:.2f} GiB was held before the server was built")
    del srv, stats, done, reqs, check_logits, check_state
    torch.cuda.empty_cache()

    # 10. build K2 -----------------------------------------------------------
    mark_phase("10")
    from repro_torch.models import transformer

    log(f"build: K2 in {built[flash_kernel.LIB_NAME]:.2f} s (phase 2)")
    log_ptxas(_build, flash_kernel.LIB_NAME)
    hmma = {int(re.search(r"ILi(\d+)E", name).group(1)): n
            for name, n in _build.tensor_core_ops(
                _build.sass(flash_kernel.LIB_NAME, flash_kernel.SOURCES),
                "flash_fwd_mma_kernel").items()}
    if sorted(hmma) != sorted(flash_kernel.HEAD_DIMS) or \
            min(hmma.values()) == 0:
        raise AssertionError(f"K2's bf16 kernel lacks tensor-core "
                             f"instructions in its SASS: {hmma}")
    k2_blocks = {hd: flash_kernel.blocks_per_sm(hd)
                 for hd in flash_kernel.HEAD_DIMS}
    log(f"K2 bf16 kernel SASS: tensor-core instructions (HMMA/HGMMA) by hd "
        f"{hmma}; resident blocks per SM by hd {k2_blocks}")

    # 11. K2 against its plain version (TF32 still off) ----------------------
    mark_phase("11")
    k2_err = 0.0
    for shape in FLASH_SHAPES + [SERVED_FLASH, LONG_FLASH]:
        for dtype in (torch.float32, torch.bfloat16):
            k2_err = max(k2_err, check_flash(shape, dtype, flash_mod))
    timings = {}
    for label, shape in (("served", SERVED_FLASH), ("2048", LONG_FLASH)):
        q, k, v = flash_inputs(*shape[:6], torch.bfloat16, seed=5)
        mine = flash_mod.flash_attention(q, k, v)
        lib = sdpa(q, k, v).transpose(1, 2)
        if not torch.allclose(mine.float(), lib.float(), atol=2e-2,
                              rtol=2e-2):
            raise AssertionError(f"K2 {shape} differs from "
                                 "scaled_dot_product_attention")
        q32, k32, v32 = flash_inputs(*shape[:6], torch.float32, seed=5)
        q_tile = q[:, :64].contiguous()
        timings[label] = {
            "ms": cuda_ms(lambda: flash_mod.flash_attention(q, k, v)),
            "plain_ms": cuda_ms(lambda: flash_mod.attention_plain(q, k, v)),
            "library_ms": cuda_ms(lambda: sdpa(q, k, v)),
            "ms_f32_inputs": cuda_ms(
                lambda: flash_mod.flash_attention(q32, k32, v32)),
            "chain_ms": cuda_ms(lambda: flash_mod.flash_attention(
                q_tile, k, v, causal=False)),
            "device_ms": device_ms(lambda: flash_mod.flash_attention(q, k, v)),
            "plain_device_ms": device_ms(
                lambda: flash_mod.attention_plain(q, k, v)),
            "library_device_ms": device_ms(lambda: sdpa(q, k, v)),
            "device_ms_f32_inputs": device_ms(
                lambda: flash_mod.flash_attention(q32, k32, v32)),
            "chain_device_ms": device_ms(lambda: flash_mod.flash_attention(
                q_tile, k, v, causal=False)),
        }
        if label == "served":
            timings[label]["yardsticks"] = yardstick_turns(
                lambda: flash_mod.flash_attention(q, k, v))
        bound, by = flash_bound_ms(*shape, torch.bfloat16)
        bound32, by32 = flash_bound_ms(*shape, torch.float32)
        timings[label].update(bound_ms=bound, bound_by=by,
                              bound_ms_f32=bound32, bound_by_f32=by32)
        t = timings[label]
        log(f"K2 {label} shape {shape}, bf16: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"{t['library_ms']:.4f} ms, bound {bound:.6f} ms ({by}); "
            f"f32: kernel {t['ms_f32_inputs']:.4f} ms, bound {bound32:.6f} "
            f"ms ({by32}); the longest block's chain alone (64 query rows "
            f"x {shape[2]} keys per head, bf16) {t['chain_ms']:.4f} ms")
        log(f"K2 {label}, device time per call (device_ms): kernel bf16 "
            f"{t['device_ms']:.4f} ms, f32 {t['device_ms_f32_inputs']:.4f} "
            f"ms, plain {t['plain_device_ms']:.4f} ms, "
            f"scaled_dot_product_attention {t['library_device_ms']:.4f} ms, "
            f"chain alone {t['chain_device_ms']:.4f} ms")
        if "yardsticks" in t:
            log(f"K2 {label}, bf16, the two yardsticks in turns (graph, "
                f"profiler, profiler, graph): CUDA-graph replay "
                f"{t['yardsticks']['graph_ms']} ms, profiler kernel sum "
                f"{t['yardsticks']['profiler_ms']} ms")
    del q, k, v, q32, k32, v32, q_tile, mine, lib

    # 12. model check: cuda (K2) vs CPU (plain), float32 ---------------------
    mark_phase("12")
    full_q = get_config("qwen3-0.6b")
    cfg12 = dataclasses.replace(full_q, num_layers=2,
                                compute_dtype=torch.float32)
    cpu_q = transformer.init_params(cfg12, torch.Generator().manual_seed(0),
                                    "cpu")
    gpu_q = transformer.Transformer(cfg12, "cuda")
    gpu_q.load_state_dict(cpu_q.state_dict())
    prompt_q = torch.randint(0, full_q.vocab, (1, 512),
                             generator=torch.Generator().manual_seed(1))
    before = flash_mod.flash_attention.launches
    logits_g, cache_g = transformer.prefill(gpu_q, prompt_q.cuda(), 512)
    torch.cuda.synchronize()
    if flash_mod.flash_attention.launches - before != cfg12.num_layers:
        raise AssertionError("the cuda prefill did not go through K2")
    logits_c, cache_c = transformer.prefill(cpu_q, prompt_q, 512)
    errs = {"logits": rel_err(logits_g, logits_c),
            **{k: rel_err(cache_g[k], cache_c[k]) for k in cache_c}}
    if not (torch.isfinite(logits_g).all()
            and max(errs.values()) <= MODEL_REL_TOL):
        raise AssertionError(f"qwen3 model cuda vs cpu: {errs}")
    log(f"model ({cfg12.num_layers} layers, d {cfg12.d_model}, "
        f"{cfg12.n_heads} heads / {cfg12.n_kv} kv of {cfg12.head_dim}, vocab "
        f"{cfg12.vocab}, f32, {prompt_q.shape[1]}-token prefill): cuda (K2) "
        f"vs cpu (plain) max err / max magnitude "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tolerance {MODEL_REL_TOL})")
    del cpu_q, logits_c, cache_c
    p128 = prompt_q[:, :128].cuda()
    logits_128, _ = transformer.prefill(gpu_q, p128, 128)
    logits_d, cache = transformer.prefill(gpu_q, p128[:, :64], 128)
    for t in range(64, 128):
        logits_d, cache = transformer.decode_step(gpu_q, cache,
                                                  p128[:, t:t + 1], t)
    diff = float((logits_d - logits_128).abs().max())
    if not torch.allclose(logits_d, logits_128, atol=DECODE_TOL,
                          rtol=DECODE_TOL):
        raise AssertionError(f"qwen3: 64 decode steps vs 128-token prefill: "
                             f"{diff}")
    log(f"qwen3: 64-token prefill + 64 decode steps == 128-token prefill "
        f"within {DECODE_TOL} (max abs diff {diff:.2e})")
    del gpu_q, logits_g, cache_g, logits_d, logits_128, cache
    torch.cuda.empty_cache()

    # 13. serve qwen3-0.6b at full width (the main path of K2) ---------------
    mark_phase("13")
    served_q = serve_phase(
        BatchedServer, Request, flash_mod,
        (flash_mod.flash_attention, wkv6_mod.wkv6, minplus.sweep_minplus),
        (("qwen3-0.6b", None),))
    k2_launches = served_q["qwen3-0.6b"]["launches"]["flash_attention"]

    # 14. build K2' and K3' --------------------------------------------------
    mark_phase("14")
    for name in (flash_kernel.BWD_LIB_NAME, wkv6_kernel.BWD_LIB_NAME):
        log(f"build: {name} in {built[name]:.2f} s (phase 2)")
        log_ptxas(_build, name)
    k2b_hmma, k2b_blocks, k3b_hmma, k3b_blocks = bwd_sass_and_occupancy(
        _build, flash_kernel, wkv6_kernel)

    # 15, 16. K2' and K3' against their plain versions, timed -----------------
    mark_phase("15,16")
    grads = grad_kernel_phases(flash_mod, flash_kernel, wkv6_mod, wkv6_kernel)

    # 17. model gradients: cuda (K2/K2', K3/K3') vs CPU (plain), float32 ------
    mark_phase("17")
    model_grads = model_grad_phase(flash_mod, wkv6_mod)

    # 18. train both families at full width (the main path of K2' and K3') ---
    mark_phase("18")
    trained = train_phase(
        flash_mod, wkv6_mod, minplus,
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "smoke_18"))
    if not all(trained[a]["launches"][k.__name__] > 0 for a, k in (
            ("qwen3-0.6b", flash_mod.flash_attention_bwd),
            ("rwkv6-1.6b", wkv6_mod.wkv6_bwd))):
        raise AssertionError("the training runs did not launch K2' and K3'")

    # 19. K2 and K2' with a sliding window; the padded head size ------------
    mark_phase("19")
    t0 = time.perf_counter()
    window = window_phase(flash_mod, flash_kernel)
    # 20. dense models with each option: cuda (K2/K2') vs CPU, float32 ------
    mark_phase("20")
    t1 = time.perf_counter()
    dense_models = dense_model_phase(flash_mod)
    # 21. serve the dense configs at full width (K2's main path) ------------
    mark_phase("21")
    t2 = time.perf_counter()
    dense_served = serve_phase(
        BatchedServer, Request, flash_mod,
        (flash_mod.flash_attention, wkv6_mod.wkv6, minplus.sweep_minplus))
    dense_walls = {"19": t1 - t0, "20": t2 - t1,
                   "21": time.perf_counter() - t2}
    window_runs = [r for name, r in dense_models.items() if "window" in name]
    # 22-24. the MoE configs and the VLM backbone (K2's and K2''s main path)
    mark_phase("22-24")
    moe_out = moe_phases(
        flash_mod, flash_kernel, BatchedServer, Request,
        (flash_mod.flash_attention, wkv6_mod.wkv6, minplus.sweep_minplus))
    moe_models = moe_out["models"]
    # 25-27. the hybrid and audio families (K2's and K2''s main path) -------
    mark_phase("25-27")
    ha_out = ha_phases(
        flash_mod, flash_kernel, BatchedServer, Request,
        (flash_mod.flash_attention, wkv6_mod.wkv6, minplus.sweep_minplus))

    # the one-call busy times of phases 4d and 4e, after every other
    # profiler session of the run
    mark_phase("busy")
    run_deferred_busy()

    # 28. the paper's stage pipeline across two ranks on the card ----------
    mark_phase("28")
    spmd_out = spmd_phase(spmd_dir)

    # 29. the "model" axis inside the stages; its dry run and roofline -----
    mark_phase("29")
    tp_out = tp_phase(tp_dir, flash_mod, flash_kernel)

    log(json.dumps({"sim": sim_out, "card": smi}))
    log(json.dumps({"robust": robust_out, "card": smi}))
    log(json.dumps({"train": {"model_grads": model_grads, **trained,
                              "run": TRAIN_RUN}, "card": smi}))
    log(json.dumps({"dense": {"window": window, "models": dense_models,
                              "serve": dense_served,
                              "phase_walls_s": dense_walls}, "card": smi}))
    log(json.dumps({"moe": moe_out, "card": smi}))
    log(json.dumps({"hybrid_audio": ha_out, "card": smi}))
    log(json.dumps({"spmd": spmd_out, "card": smi}))
    log(json.dumps({"tp": tp_out, "card": smi}))
    run_walls = phase_walls()
    log("phase walls (s): "
        + ", ".join(f"{k} {v}" for k, v in run_walls.items())
        + f"; total {sum(run_walls.values()):.1f}")
    log(profiler_line())

    log(json.dumps({"kernels": [{
        "name": "minplus_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:43",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        **{key: quick[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "library_ms": None,
        "device_ms": quick["device_ms"],
        **{label.replace(" ", "_").replace("-", "_"): t
           for label, t in k1.items()},
        "exhaustive_joint_launches": ej_launches,
        "sim_replan_launches": sim_out["replan"]["k1_launches"],
        "sim_refined_launches": robust_out["sim_refined"]["k1_launches"],
        "robust_bcd_launches":
            robust_out["cvar"]["robust_bcd"]["k1_launches"],
        "policy_zoo_launches": robust_out["zoo"]["k1_launches"],
        "graph_axis": {label.replace(" ", "_"): t
                       for label, t in {**k1_graph, **k1_device}.items()},
        "device_backend_launches": {
            "float64": backend_runs["device_f64"]["k1_launches"],
            "float32": backend_runs["device_f32"]["k1_launches"]},
        "replan": {
            "exact_backend_launches": backend_runs["exact"]["k1_launches"],
            "solve_many_walls_s": {name: r["walls_s"]
                                   for name, r in backend_runs.items()},
            "solve_many_exact_cpu_s": exact_cpu_s,
            "warm_replans_s": {dev: w["wall_s"]
                               for dev, w in replans.items()},
            "warm_k1_launches": replans["cuda"]["k1_launches"],
            "cold_replans_cuda_s": cold_s,
            "incremental_hits": replans["cuda"]["hits"],
            "coordinator_init_s": coord_init_s,
            "coordinator": coord_log,
            "coordinator_k1_launches": coord_launches},
    }, {
        "name": "wkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:27",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        **{key: k3_times["served"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": dict(zip(("B", "S", "H", "hd", "chunk"), SERVED_WKV)),
        "dtype": "bfloat16 r/k/v",
        "device_ms": k3_times["served"]["device_ms"],
        "ms_f32_inputs": k3_times["served"]["ms_f32"],
        "device_ms_f32_inputs": k3_times["served"]["device_ms_f32"],
        "odd_prompt_shape": dict(zip(("B", "S", "H", "hd", "chunk"),
                                     ODD_WKV)),
        "odd_prompt_ms": k3_times["odd_prompt"]["ms"],
        "odd_prompt_device_ms": k3_times["odd_prompt"]["device_ms"],
        "odd_prompt_device_ms_f32_inputs":
            k3_times["odd_prompt"]["device_ms_f32"],
        "odd_prompt_plain_ms": k3_times["odd_prompt"]["plain_ms"],
        "odd_prompt_bound_ms": k3_times["odd_prompt"]["bound_ms"],
        "strong_decay_max_abs_err": k3_strong_err,
        "sass_tensor_core_instructions": k3_hmma,
        "blocks_per_sm": k3_blocks,
        "train_launches": trained["rwkv6-1.6b"]["launches"]["wkv6"],
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash/csrc/flash.cu",
        "replaces": "src/repro/kernels/flash/kernel.py:29",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        **{key: timings["served"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
        "shape": dict(zip(("B", "S", "T", "H", "KV", "hd", "causal"),
                          SERVED_FLASH)),
        "dtype": "bfloat16",
        "ms_f32_inputs": timings["served"]["ms_f32_inputs"],
        "bound_ms_f32": timings["served"]["bound_ms_f32"],
        **{key: timings["served"][key]
           for key in ("chain_ms", "device_ms", "plain_device_ms",
                       "library_device_ms", "device_ms_f32_inputs",
                       "chain_device_ms")},
        "sass_tensor_core_instructions": hmma,
        "blocks_per_sm": k2_blocks,
        "long_2048": timings["2048"],
        "train_launches": trained["qwen3-0.6b"]["launches"][
            "flash_attention"],
        "window": {
            "windows_checked": WINDOWS, "max_abs_err": window["k2_err"],
            "padded_hd8_max_abs_err": window["padded_err"],
            "served": window["times"]["served"],
            "long_2048": window["times"]["2048"],
            "launches": sum(r["prefill_launches"] + r["launches"]["forward"]
                            for r in window_runs)},
        "dense_serve_launches": {
            arch: r["launches"]["flash_attention"]
            for arch, r in dense_served.items()},
        "dense_serve_layers": {
            arch: moe_out["flash"]["times"][arch] for arch in DENSE_TIMED},
        "moe_vlm": {
            "max_abs_err": moe_out["flash"]["k2_err"],
            "layers": {arch: moe_out["flash"]["times"][arch]
                       for arch in MOE_ARCHS},
            "model_launches": {
                arch: r["prefill_launches"]
                + r.get("launches", {}).get("forward", 0)
                + r.get("adafactor", {}).get("launches", {}).get(
                    "forward", 0) for arch, r in moe_models.items()},
            "serve_launches": {
                arch: r["launches"]["flash_attention"]
                for arch, r in moe_out["serve"].items()}},
        "hybrid_audio": {
            "max_abs_err": ha_out["flash"]["k2_err"],
            "shapes": HA_FLASH,
            "times": ha_out["flash"]["times"],
            "model_launches": {
                arch: r["prefill_launches"] + r["launches"]["forward"]
                for arch, r in ha_out["models"].items()},
            "serve_launches": {
                arch: r["launches"]["flash_attention"]
                for arch, r in ha_out["serve"].items()}},
        "spmd_launches": {
            "ranks": [r["launches"]["flash_attention"]
                      for r in spmd_out["ranks"]],
            "derived": [r["launches_derived"]["flash_attention"]
                        for r in spmd_out["ranks"]]},
        "tp_launches": {
            "ranks": [r["launches"]["flash_attention"]
                      for r in tp_out["ranks"]],
            "derived": [r["launches_derived"]["flash_attention"]
                        for r in tp_out["ranks"]]},
        "tp_layer": {"shape": dict(zip(("B", "S", "T", "H", "KV", "hd",
                                        "causal"), TP_FLASH)),
                     "max_abs_err": tp_out["flash"]["k2_err"],
                     **{key: tp_out["flash"]["forward"][key]
                        for key in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "library_device_ms")}},
        "split_keys": {
            "shape": dict(zip(("B", "S", "H", "KV", "hd"), SPLIT_FLASH)),
            "ways": SPLIT_WAYS,
            "max_abs_err": tp_out["split_keys"]["k2_err"],
            "combined_max_abs_err": tp_out["split_keys"]["combined_err"],
            "empty_rows": tp_out["split_keys"]["empty_rows"],
            "times": {label: {key: row[key] for key in (
                "offset", "keys", "device_ms", "library_device_ms",
                "plain_ms", "bound_ms", "bound_by")}
                for label, row in tp_out["split_keys"]["times"].items()},
            "cell_launches": tp_out["split_cell"]["launches"][
                "flash_attention"]},
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash/csrc/flash_bwd.cu",
        "replaces": "src/repro/models/common.py:212-289",
        "launches": trained["qwen3-0.6b"]["launches"]["flash_attention_bwd"],
        "max_abs_err": grads["k2_bwd_err"],
        **{key: grads["k2_bwd_times"][key]
           for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "library_device_ms", "ms_f32",
                       "device_ms_f32", "bound_ms_f32", "device_split",
                       "device_split_f32")},
        "shape": dict(zip(("B", "S", "T", "H", "KV", "hd", "causal"),
                          TRAIN_FLASH)),
        "dtype": "bfloat16",
        "sass_tensor_core_instructions": k2b_hmma,
        "blocks_per_sm": k2b_blocks,
        "window": {
            "windows_checked": WINDOWS, "max_abs_err": window["k2_bwd_err"],
            "train_layer": window["times"]["train_bwd"],
            "launches": sum(r["launches"]["backward"] for r in window_runs)},
        "moe_vlm": {
            "max_abs_err": moe_out["flash"]["k2_bwd_err"],
            "model_launches": {
                arch: r.get("launches", {}).get("backward", 0)
                + r.get("adafactor", {}).get("launches", {}).get(
                    "backward", 0) for arch, r in moe_models.items()}},
        "hybrid_audio": {
            "max_abs_err": ha_out["flash"]["k2_bwd_err"],
            "shapes": HA_FLASH,
            "model_launches": {
                arch: r["launches"]["backward"]
                for arch, r in ha_out["models"].items()}},
        "spmd_launches": {
            "ranks": [r["launches"]["flash_attention_bwd"]
                      for r in spmd_out["ranks"]],
            "derived": [r["launches_derived"]["flash_attention_bwd"]
                        for r in spmd_out["ranks"]]},
        "tp_launches": {
            "ranks": [r["launches"]["flash_attention_bwd"]
                      for r in tp_out["ranks"]],
            "derived": [r["launches_derived"]["flash_attention_bwd"]
                        for r in tp_out["ranks"]]},
        "tp_layer": {"shape": dict(zip(("B", "S", "T", "H", "KV", "hd",
                                        "causal"), TP_FLASH)),
                     "max_abs_err": tp_out["flash"]["k2_bwd_err"],
                     **{key: tp_out["flash"]["backward"][key]
                        for key in ("device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_device_ms")}},
        "split_keys": {
            "max_abs_err": tp_out["split_keys"]["k2_bwd_err"],
            "combined_max_abs_err": tp_out["split_keys"]["combined_bwd_err"],
            "times": {label: {key[4:] if key.startswith("bwd_") else key:
                              row[key] for key in (
                "offset", "keys", "bwd_device_ms", "library_bwd_device_ms",
                "bwd_plain_ms", "bwd_bound_ms", "bwd_bound_by")}
                for label, row in tp_out["split_keys"]["times"].items()},
            "cell_launches": tp_out["split_cell"]["launches"][
                "flash_attention_bwd"]},
    }, {
        "name": "wkv6_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/models/rwkv6.py:97-131",
        "launches": trained["rwkv6-1.6b"]["launches"]["wkv6_bwd"],
        "max_abs_err": grads["k3_bwd_err"],
        "strong_decay_max_abs_err": grads["k3_bwd_strong_err"],
        **{key: grads["k3_bwd_times"][key]
           for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                       "ms_f32", "device_ms_f32", "device_split",
                       "device_split_f32")},
        "library_ms": None,
        "shape": dict(zip(("B", "S", "H", "hd", "chunk"), TRAIN_WKV)),
        "dtype": "bfloat16 r/k/v",
        "sass_tensor_core_instructions": k3b_hmma,
        "blocks_per_sm": k3b_blocks,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
