"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); TF32 off;
  2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it, and time both with CUDA events,
     L2 flushed before each call (B3 at the prefill writes of 32,640 and
     4,096 rows, bf16, and without a matrix at the W-flush's 128 rows and
     the batch ring's 512, fp32, each beside its bound, with cuBLAS's fp32
     x @ M^T alone at 32,640 rows as context; B2 at page sizes 16 and 48,
     and at one layer of the benchmark's long-context cells (512 rows at
     G 2, 256 at G 5, their length distribution) beside the bound of
     ``perfbench.costs.b2_step_work``;
     B4 at the shapes of B3's prefill write: 32,640 rows x d 128 int4,
     and at d 64 / 128 / 256, int4 and int8, and at its serving shapes:
     the raw view of a reused 1,024-token prefix, 8,192 rows x d 128
     int4, and of the 2,048 tokens a host restore brings back, 16,384
     rows); B3 and B4 are then timed
     in alternation over B4_ROUNDS rounds and reported as the medians,
     the SM clock polled by nvidia-smi through the whole phase; B1 and
     B2 (``check_b1``, ``check_b2``, each callable alone) are also timed
     as one call captured in a CUDA graph and replayed (``graph_ms``);
     B1 is also replayed at the 517- and 4093-token requests' lengths
     with scalar lengths (a plain cache) and per-row lengths (the ragged
     cache a graph decodes), which plan their splits from the prefix and
     from s_max;
  4. check the served model (a graph decode) against the port's plain
     CPU path on a small input, under int4-srft KERNEL and int8-per-token;
  5. the main path: internlm2-1.8b at full width, its depth cut to
     MAIN_LAYERS = 8 of 24 layers (the script's time limit), random weights
     from a seed, bf16-operand / fp32-accumulate dots, answering requests
     of 517, 2055 and 4093 prompt tokens (64 new tokens each) through
     ``Engine``'s captured decode step (a CUDA graph replayed per token,
     on a ragged batch-1 cache) with the int4-srft cache (KERNEL read);
     the kernels' launch counters are zeroed just before each request
     and read just after, so they count replays;
  6. the same requests in ENGINE_ROUNDS interleaved rounds, eager loop
     and graph replay in alternating order, int4-srft KERNEL and bf16
     GATHER (and at 2055 tokens int4-srft GATHER and BLOCKWISE and bf16
     BLOCKWISE): ms per token by CUDA events around the decode loop,
     capture time; the graph's tokens must equal the eager loop's up to a
     near-tie and its logits agree within GRAPH_TOL; GATHER is held
     against KERNEL, and BLOCKWISE against GATHER; decode profiles of both
     modes (device busy ms per step, idle share, the port's kernels); and
     a replay loop inside ``torch.cuda.set_sync_debug_mode("error")``,
     which must raise nothing: the step makes no host sync;
  7. batch serving: the same model through ``BatchEngine`` (capacity 4,
     prompts of 517 / 1031 / 2055 / 4093 tokens with 40 / 24 / 32 / 16 new
     tokens, and two requests sharing a 1024-token page-aligned prefix),
     over the paged pool (int4 KERNEL read through B2) and the dense
     ragged slot cache (B1), and under bf16 GATHER both ways; paged and
     dense streams must be equal for rows that map no shared page, every
     stream must agree with the request served alone
     (``Engine.generate``) up to a near-tie, shared prefix pages must
     carry one reference per sharer, an undersized pool must preempt and
     still complete every request, and every page must come back.  Each
     run is made with the captured step (the default) and with the eager
     loop, whose streams must agree up to a near-tie; ms per step by
     CUDA events and the host clock around each chunk, capture time, and
     decode profiles of both modes.  The launch counters are zeroed just
     before each int4 graph run and read just after;
  8. chunked admission (the graph decode): the same requests with
     ``prefill_chunk`` 256 and ``prefill_budget`` 256, paged and dense,
     int4-srft KERNEL and bf16 GATHER, and the preempting pool.  Every
     stream of a request that reused nothing (and, under bf16, of the
     one that did) equals the monolithic run's up to a near-tie; the
     paged int4 run reuses the 1,024-token prefix once, launching B4 2 x
     MAIN_LAYERS times for it, and the int4 reuser's agreement with a no-reuse run
     is printed.  For each layout: the longest gap between two tokens of
     a live stream while the 4093-token request is admitted, monolithic
     against chunked, that request's time to first token, the chunks per
     admission, and the reused tokens, hits and misses; the counters are
     zeroed just before each int4 chunked run and read just after.  The
     preempting pool runs chunked with a budget of PREEMPT_BUDGET tokens
     a quantum, so that its pool runs dry as the monolithic one's does;
  9. the quality path, on fp32 operands (``common.dot_mode(False)``, as
     the reference's benchmarks run): ``kernel_quality.run`` on the card
     -- B3 (folded) and B4 against their plain versions at d 64/128/256,
     int4 and int8, plain and scaled lambda (codes equal up to .5 ties);
     smol-d128 trained 250 Adam steps (batch 8 x 128 tokens, lr 3e-3;
     the final loss must be below the first); Table 7's ladder (alpha =
     100 K outlier, 8 x 256 eval tokens: base PPL and hook dPPL of
     per_token, g32_no_lambda, scaled_g32, logged with the paper's two
     claims, which do not gate) -- with the counters zeroed just before
     and read just after; then, on a reduced smol model with the same
     params, rotations and tokens, hook PPL on the card against the CPU
     plain path for every scheme, within 1e-3 relative;
 10. speculative decoding (``spec_k`` SPEC_K = 4, greedy, graph on).
     ``Engine`` at batch 1 on the 2055-token request and on a repetitive
     prompt of the same length (a 64-token random base, tiled, so that the
     prompt-lookup drafter hits): 64 new tokens under int4-srft (the
     verify reads with GATHER's numerics: B1/B2 are single-query) and
     bf16, each held to the plain graph stream (int4: KERNEL and GATHER)
     up to a near-tie, with the bit-equal prefix printed; the counters
     zeroed just before the timed decode and read just after: B3 2 x
     MAIN_LAYERS x k launches a pass and no B1 / B2; ms per emitted token spec against
     plain, acceptance, tokens and ms per verify pass, the pass graph's
     capture time and, on the random prompt, its idle share (profiler
     busy over events); graph spec == eager spec bit for bit over 16
     tokens of the repetitive prompt; the captured pass replayed inside
     ``set_sync_debug_mode("error")``; where spec and plain part: the
     first recorded op (norms, projections, RoPE, attention reads,
     unembedding) whose output differs, for a verify pass of the batch's
     4 rows against 4 steps (``spec_op_report``) and along 32 tokens of
     the single int4 stream, decoded eagerly both ways
     (``spec_trace_report``).  ``BatchEngine`` on the batch
     requests, paged and dense, int4 KERNEL and bf16 GATHER: every stream
     and finish reason equal to phase 7's plain run up to a near-tie, no
     page leaked, every row mapping its spec_k - 1 slack; and the
     preempting pool, held to its plain run.  Lines with what users feel
     carry the card's name and power limit;
 11. the host prefix tier and the int8-per-token policy.  ``BatchEngine``
     (capacity 4, pages of 16, ``prefill_chunk`` = ``prefill_budget`` =
     256, graph) serves phase 5's 2055-token request (32 new tokens)
     under int4-srft KERNEL (B2), bf16 GATHER and int8-per-token GATHER:
     with a 256 MiB tier the request retires and spills its 128 prompt
     pages (the store holds 128 x the pool's page bytes), and the same
     prompt re-admitted restores 2048 tokens (one host hit); its stream
     must equal, bit for bit, the one an engine serves where a donor that
     shares those 128 pages stays resident (a device COW hit of the same
     depth: the same bytes, the same 7-row last chunk).  Under bf16 and
     int8 (W = 1) a resident donor with the same prompt shares 2054
     tokens and computes a 1-row chunk; that stream is printed beside the
     restore's with ``last_chunk_report`` and held to it up to a
     near-tie.  The counters are zeroed just before the
     int4 re-admission and read just after: B4 2 x MAIN_LAYERS launches
     (the raw view of the restored tokens), B2 and B3 for its decode.  No
     page leaks.  Then: a tier of DEPTH_BYTES (128 MiB at 24 layers, scaled
     with the depth) keeps all 128 int4 and int8 pages and the newest 85
     bf16 ones (the first page evicted: nothing restores);
     the int4 disk tier (RAM budget 0) restores the RAM restore's stream
     bit for bit; in OFFLOAD_ROUNDS interleaved rounds, by the host clock,
     the re-admitted request's time to first token after a host restore,
     a device hit and a cold chunked admission without a tier, the
     retire-time spill, the restore and its host-to-device copy alone;
     ``Engine`` at 2055 tokens under int8-per-token, graph and eager (ms
     per token beside phase 6's, graph == eager, cache bytes and
     compression at s_max 4608, a replay loop without host syncs); and
     ``repro_torch.examples.quickstart`` on the card (80 training steps,
     fp32 operands);
 12. training, checkpoints and learned rotations (TRAIN_ARGV, CALIB_KW;
     lines tagged with the card's name and power limit).  (a)
     ``repro_torch.launch.train.main`` in-process on internlm2-1.8b at
     full width, MAIN_LAYERS layers (``--layers``), 4 steps of 4 x 256
     tokens, bf16 operands: ms
     per step by CUDA events, each step's loss (finite), peak memory;
     ``(params, opt)`` saved with ``CheckpointManager`` under
     ``build/phase12`` and restored onto the card into a fresh tree,
     every leaf bit for bit, bytes on disk and seconds each way, then the
     directory deleted and the state freed.  (b)
     ``repro_torch.examples.train_lm`` (tiny-33m) through its CLI: two
     uninterrupted runs to step 12 compared leaf for leaf, then a run to
     step 6 started again to 12 (a resume): its step-12 checkpoint and
     iterator state equal the uninterrupted run's (held to the
     run-to-run spread, leaf by leaf, if the two uninterrupted runs
     differ).  (c) K/V of phase 5's 2055-token request (``collect_kv``)
     and every layer and side fitted by ``calibrate`` (learned lambda +
     Householder k = 64 on the SRFT base, group 32, 120 steps): every
     matrix orthogonal within ORTH_TOL, every lambda finite and positive.
     (d) ``Engine`` on that request with the cache built on the learned
     rotations, int4-srft KERNEL graph and eager and GATHER: graph ==
     eager, KERNEL vs GATHER within LOGIT_TOL, and B3 / B1 launching as
     many times as on phase 5's request (counters zeroed just before,
     read just after); ms per token beside phase 6's.  (e) B3 (the
     cache's write and the folded matrix) and B4 (``fold_and_invert``) on
     layer 0's learned K rotation and on a no-SRFT rotation (identity
     base, learned Cayley + lambda) fitted on the same vectors, held to
     their plain versions.  (f) the paper's §5.3 ablation
     (``benchmarks/calibration_ablation.py``'s five variants on smol-d64
     trained 250 steps, alpha = 20, fp32 operands): mean MSE reduction,
     hook dPPL and the four claims, logged and not gated;
 13. the serving front-end (``repro_torch.launch.server``) on phase 5's
     model, int4-srft KERNEL, capacity 4, graph on, over the closed-loop
     trace ``make_trace(8, prompt_len=512, new_tokens=32, run_len=2)``
     (prompts of 256 / 384 / 512 tokens in runs of two, so bucketed
     admission packs k = 2 prompts a prefill).  (a) ``SyncServer`` and
     ``ServingPipeline``, paged and dense, each on its own engine (the
     pipeline's decode thread captures its graph): every stream equal bit
     for bit, the counters zeroed just before each pipelined run and read
     just after (B3 and B2 paged, B3 and B1 dense); paged, tracing off
     equal to tracing on, and SERVE_ROUNDS interleaved rounds of both on
     their warm engines, each equal to the first run (req/s and tokens/s
     by the host clock); TTFT p50 / p90, ITL p50, e2e p50 from
     ``ServerMetrics``; the host ms of each packed prefill (its trace
     span) and the capture seconds; a profiled pipelined run (device busy
     over CUDA-event ms: the idle share).  (b) ``admit_packed([a, b])``
     == ``([b, a])`` bit for bit (where they part, the first recorded op
     is logged).  (c) ``CompletionServer`` on 127.0.0.1, ephemeral port,
     before the paged pipeline: the eight prompts POSTed at once as token
     lists with ``"stream": true``; each SSE stream ends in one terminal
     event, "length", with 32 tokens, equal to (a)'s up to a near-tie of
     its forced logits; /healthz answers, /metrics is strict Prometheus
     text counting 8 completed, /debug/trace passes
     ``benchmarks/check_trace.py`` with 0 dropped; two more requests and a
     cancel-shutdown return every page.  (d) ``python -m
     repro_torch.launch.serve`` (SERVE_CLI) in a subprocess: exit 0, its
     ``--stats-json`` with the compression and the pool's pages.
 14. the other configs at full width, one resident at a time, random
     weights from SEED, bf16 operands with fp32 accumulation, int4-srft
     (``P14_CONFIGS``: gemma-7b 28/28 layers, qwen3-14b 40/40,
     qwen1.5-110b 16/80, dbrx-132b 8/40, llava-next-34b 48/60,
     qwen3-moe-235b-a22b 10/94; B1 at G = 1 (d 256), 5, 6, 7, 8 and 16).
     First a reduced qwen3-moe with 16 query heads over 1 KV head on the
     card against the CPU plain path, as phase 4, on fp32 operands.  Each
     config: ``Engine`` at batch 1 on a 2055-token prompt (2048 for a MoE,
     whose routing groups want a large divisor) and 32 new tokens under
     the graph, counted (B3 and B1 > 0), profiled (device busy, idle
     share), against the eager loop (GRAPH_TOL) and GATHER (LOGIT_TOL; a
     MoE up to the first pass where the two reads route a token apart,
     which must be a near-tie of its router); a MoE replays inside
     ``set_sync_debug_mode("error")``.  gemma-7b, qwen3-14b,
     dbrx-132b and qwen3-moe also through ``BatchEngine`` (capacity 4,
     pages of 16, prompts of 512 / 2048 / 2055 / 1024, 16 new): paged ==
     dense bit for bit, every page back, B2 and B1 counted.  For a MoE,
     reported and not gated: chunked admission against monolithic, the
     batch row against the same request alone, spec (k = 4) against
     plain, and the dropped (token, expert) pairs of each prefill.
     dbrx-132b also serves phase 13's trace: pipelined == sync bit for
     bit.  llava-next-34b also prefills 1152 patch embeddings + 1024
     tokens, then 16 eager steps, KERNEL against GATHER within LOGIT_TOL.
     Phase 3 also holds B1 and B2 at these configs' (kv heads, G, d)
     and times B3 at gemma-7b's prefill write (32,768 rows x d 256).
 15. the hybrid, ssm and audio families (``P15_CONFIGS``, lines tagged
     with the card's name and power limit).  (a) reduced zamba2 (at d 112,
     B1 needing d % 8 == 0), xlstm and whisper on the card against the
     CPU plain path, as phase 4, on fp32 operands (xlstm on fp32
     activations too: at random weights its first mLSTM step turns a bf16
     ulp into a different token).  (b) each at
     full width and depth, one resident at a time, random weights from
     SEED, bf16 operands, int4-srft: zamba2-7b (81 Mamba2 blocks and one
     shared attention block firing 13 times) and xlstm-1.3b on a
     2048-token prompt (a multiple of the SSD chunk), whisper-large-v3 on
     1500 stub frames and 256 tokens; ``Engine`` at batch 1, 32 new
     tokens under the graph on a cache that keeps its lengths on the
     device: ms per token (events), prefill ms, capture s, device busy and
     idle share (profiler), peak GB, KV-cache and recurrent-state bytes,
     compression; B3 and B1 counted (> 0 for zamba2 and whisper, 0 for
     xlstm); graph == eager within GRAPH_TOL, KERNEL vs GATHER within
     LOGIT_TOL.  (c) ``python -m repro_torch.launch.serve`` on zamba2-7b
     and xlstm-1.3b ``--smoke`` in subprocesses: exit 0; ``--spec-k 4`` on
     the hybrid ends in the reference's SystemExit.  (d) two steps of the
     training CLI on the card for both ``--smoke``: finite losses; the
     hybrid's (params, opt) checkpoint restored bit for bit.  Phase 3
     also holds B1 at zamba2's (32 KV heads, G 1, d 112, group 28) over
     its 2079-token last step and at whisper's cross cache (20, 1, 64)
     over 1500 frames (1488 packed, 12 in the window), and B3 at their
     prefill writes (65,536 rows x d 112, 29,760 rows x d 64, bf16).
 16. sharded serving (ROADMAP A12a; runs after phase 13, on phase 5's
     model): the KV cache split by head over (1, m) meshes of cuda:0
     repeated (``launch/mesh.py``, ``launch/sharded_cache.py``).  (a)
     ``BatchEngine`` (capacity 4, pages of 16, graph on) on two sharers
     of a 256-token prefix and four requests of 259 / 317 / 389 / 509
     tokens (phase 13's 256-512 range; phase 7's new tokens), sharded
     against the unsharded engine on the same backend: int4-srft through
     KERNEL, dense and paged, at m = 2 and m = 8 (B1 / B2 run on each
     shard's heads with the unsplit read's split-K plan), bf16 dense and
     paged and int8-per-token dense through GATHER at m = 2.  Every
     cache leaf gathered from the shards bit-equal just before the first
     decode (the admissions' and prefills' writes, B3's bytes) and at
     the end, every stream and finish reason bit-equal, every page back,
     the two sharers at refcount 2 on every shard, per-shard KV bytes =
     global / m with the paging metadata in full, and every kernel's
     launches = m x the unsharded run's (counters zeroed before each
     run).  At the first decode, int4: layer 0's sharded KERNEL read of
     a seeded fp32 query equals the unsharded one bit for bit and the
     sharded BLOCKWISE read within B1_ATOL x max(1, its largest value).
     Also at m = 2: the undersized pool (preemptions) against the
     unsharded pool, streams and cache, and spec k = 4 against the plain
     unsharded stream up to a near-tie.  Logged: ms/step sharded vs
     unsharded (events), per-shard bytes.  (b) ``Engine(mesh=)``,
     KERNEL, at batch 1 on a 509-token request, 32 new, m = 2: graph ==
     eager (P16_EAGER_NEW tokens), tokens and cache leaves equal the
     unsharded graph run's, B1 and B3 launched twice as often.
     (c) ``pipeline_forward``: the 8 blocks in 2 and 4 stages on a
     ("pod",) mesh == the blocks run in order, 4 microbatches of 256
     tokens, bit for bit.  (d) the serve CLI on internlm2-1.8b
     ``--smoke``: ``--mesh 1`` exits 0 (a subprocess), ``--mesh 2`` ends
     in a SystemExit naming the one visible device (in this process: it
     exits before building anything).  Where a stream parts, the phase
     fails naming the first differing op of one decode step
     (``p16_op_report``, with the prefill's cache bytes held equal).
 17. sharded training (``launch/sharded_train.py``, single-controller:
     the batch split over the data axes, params gathered per data index,
     the shards' gradients weighted by their loss-mask share and summed in
     fp32, clipped, split onto the pieces, AdamW per device).  (a)
     internlm2-1.8b at all 24 layers, bf16, 2 steps of 4 x 256 tokens at
     lr 1e-3 under a seeded loss mask whose counts differ between the two
     data shards, on one device and on (2, 1), (1, 2) and (2, 2) meshes
     of cuda:0: each step's loss and grad norm within 2e-3 of the
     single-device step's, or within twice the distance of the
     single-device run with fp32 matmul operands where that is larger (a
     sharded step rounds its products otherwise, and Adam's first update
     parts at the elements whose gradient lies within that rounding of
     0); every param leaf within Adam's bound on two trajectories (2.01 lr
     a step plus a bf16 ulp a step); every piece of params and Adam state
     global / split bytes on its device; (1, 2), one data index, equal to
     one device bit for bit.  The same at MAIN_LAYERS on fp32 params and
     activations (17a-fp32) under the CPU test's tolerances: loss and
     grad norm within 1e-5, every leaf within 0.5 lr.  Logged: ms/step
     (events), peak memory, the bytes the first device holds.  (b) at
     MAIN_LAYERS: 3 steps on (2, 2), saved; restored on (2, 2), every
     piece bit-equal, and step 4 from it equal to the uninterrupted step 4
     (or within twice a rerun's spread, the differing leaves named);
     restored on (2, 1) through ``sharding_fn`` by the new mesh's specs,
     every piece on its device with the new split, every gathered leaf
     bit-equal.  (c) the (2, 1)-restored params served by
     ``Engine(mesh=)`` on (1, 2), int4-srft KERNEL, graph, 509 + 32
     tokens (phase 16b's check): tokens and cache leaves equal the
     unsharded engine's, B3 and B1 launched 2 x as often.  (d)
     ``compressed_psum`` on the card, the reference test's 8 x 512 N(0, 1)
     draw over 8 participants and layer 0's FFN up-projection gradient
     (2048 x 8192, fp32, one per batch row) over 4: codes and scales
     equal to the CPU's, every element within the participants' half
     quantization steps of the exact sum, the reference input within
     1e-2 relative.  (e) the training CLI: ``--mesh 1x1`` trains 2 steps
     in a subprocess, ``--mesh 2x1`` exits naming the one card.
 19. the cost census (``launch/cost.py``) of one eager int4-srft KERNEL
     decode step of phase 5's model on a plain cache at the 4093-token
     request, the step that fills the residual window (B1 once a layer,
     B3 twice): (a) the card's census equals the census of the same step
     on a model built on ``meta`` op for op (name, dtype, FLOPs,
     transcendentals, bytes, source line); the branches on device type
     that step passes are the kernel wrappers' (``cpu`` runs the plain
     versions, ``cuda`` and ``meta`` the launch path, which skips the
     launch on ``meta``) and ``_plan``'s SM count (``META_SMS`` on
     ``meta``); (b) its B1 and B3 records equal the launch counters'
     deltas over the step; (c) the step profiled once, device us joined
     to the census by class (B1, B3, the fp32 rotation GEMMs, the bf16
     weight GEMMs, copies and fills, elementwise ops and reductions: on
     the profiler's side, the port's kernels by name, the GEMMs in order
     against the census's, the rest by the launching op's name), each
     class's bound (``roofline.op_bound_s``) and its share of the device
     time, the step's ``step_bound`` against its ms by events (a copy
     of the same state, no census); (d) ``op_probe``'s top 10 by output
     bytes.  Lines tagged with the card's name and power limit.
The seconds of each phase are printed on one line (``phase seconds``)
before the kernels' JSON line.
Prints one JSON line describing every kernel, then, last, the line
``{"ok": true, "device": {...}}``.  Needs CUDA: without a card it exits
non-zero before building anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from datetime import datetime
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PROMPTS = (517, 2055, 4093)
NEW_TOKENS = 64
S_MAX = 4608
BATCH_PROMPTS = (517, 1031, 2055, 4093)
BATCH_NEW = (40, 24, 32, 16)
SHARED_PREFIX, SHARER_TAIL, SHARER_NEW = 1024, 8, 24
PAGE_SIZE, CAPACITY, CHUNK = 16, 4, 8
DEV = "cuda"  # the batch phase and the B2 check place everything here
SEED = 0
# the card's data-sheet rates, read from repro_torch.launch.mesh.HW by
# main() (the H100 SXM's HBM bytes/s and fp32 FLOP/s outside the tensor
# cores)
HBM_BYTES_PER_S = FP32_FLOP_PER_S = None
LOGIT_TOL = 0.05  # GATHER vs KERNEL, relative to the largest logit
B1_ATOL = 1e-4  # fp32 sums in another order (split-K) over ~4K tokens
# B1's log-sum-exp against its plain version's: the same sums' log (a
# relative error of the sums of ~1e-6 moves it ~1e-6)
LSE_ATOL = 1e-4
B4_ROUNDS = 7  # B4 and B3 timed in alternation, the SM clock sampled
PPL_RTOL = 1e-3  # hook PPL on the card vs the CPU plain path
GRAPH_TOL = 1e-5  # graph vs eager logits, relative to the largest logit
# interleaved eager / graph rounds of the Engine requests; the rounds of
# phases 6, 11 and 13 were cut (2, 2, 3 before phase 14) to keep the script
# inside its time limit
ENGINE_ROUNDS = 1
# the main path's depth (internlm2-1.8b has 24 layers): phases 5-13 run it
# at full width and this depth, and so does 12a's training CLI; cut from 24
# to keep the script well inside its time limit (phase 14 and 15 models
# stay at their depths)
MAIN_LAYERS = 8
PREFILL_CHUNK = PREFILL_BUDGET = 256  # chunked admission (phase 8)
# the preempting pool's budget: the 4093-token admission must end while the
# 517-token stream still decodes (at 256 a quantum that stream retires
# first, and the one-row pool never runs dry)
PREEMPT_BUDGET = 4096
SPEC_K = 4  # speculative passes (phase 10)
SPEC_PROMPT, SPEC_BASE = 2055, 64  # its prompts: random, and a tiled base
SPEC_EAGER_NEW = 16  # graph == eager over this many tokens
SPEC_PROFILE_TOKENS = 8
SPEC_TRACE_TOKENS = 32  # spec_trace_report: past the int4 stream's split
# (policy, backend, paged) of the speculative BatchEngine runs
SPEC_BATCH_RUNS = (("int4-srft", "kernel", True),
                   ("int4-srft", "kernel", False),
                   ("bf16", None, True), ("bf16", None, False))
# the host prefix tier (phase 11): the 2055-token request, its new tokens,
# the RAM budgets, the interleaved timing rounds and the policies
OFFLOAD_PROMPT, OFFLOAD_NEW = 2055, 32
OFFLOAD_BYTES = 256 * 2**20
DEPTH_BYTES = 128 * 2**20 * MAIN_LAYERS // 24  # 128 MiB at all 24 layers
OFFLOAD_ROUNDS = 1
OFFLOAD_RUNS = (("int4-srft", "kernel"), ("bf16", None),
                ("int8-per-token", None))
CARD = ""  # the card's name and power limit, set by main()
MAIN_SUMMARY: dict = {}  # phase 6's decode ms/token, for phases 11-12
MAIN_LAUNCHES: dict = {}  # phase 5's launches per request, for phase 12


def log(*a):
    print(*a, flush=True)


def require_card():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible; this script runs on the card")
        sys.exit(2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

class L2Flush:
    """Rewrite a buffer larger than the 50 MB L2 before each timed call: on
    the main path each layer's cache is read cold."""

    def __init__(self):
        self.buf = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        torch.bitwise_not(self.buf, out=self.buf)


def _kernel_us(prof, skip=()) -> dict:
    """Device microseconds by kernel name from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or any(k in e.key for k in skip):
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t:
            out[e.key] = out.get(e.key, 0.0) + t
    return out


# the port's kernels by source, as torch.profiler names them
OWN_KERNELS = {"srft_quant.cu": ("quant_rows_kernel", "quant_units_kernel",
                                 "srft_tile_kernel"),
               "quant_attention.cu": ("qda_",)}


def _own_ms(us, steps) -> dict:
    """Device ms per step of the port's own kernels, by source file."""
    return {src: sum(t for k, t in us.items() if any(n in k for n in names))
            / 1e3 / steps for src, names in OWN_KERNELS.items()}


TIMED = []  # (label, ms, t0, t1) of each labelled device_ms, host clock
SPIN_CYCLES = 2_000_000  # ~1 ms at 1980 MHz


def device_ms(fn, flush, iters=20, warmup=3, label=None) -> float:
    """Device time of one call, L2 flushed before each: CUDA events
    around each call, averaged.  A spin kernel ahead of each call lets
    the host queue the whole call before the device reaches it, so the
    events see device time and not the host's launch gaps.  (On the card
    torch.profiler kept 15 of 20 kernel records of such a loop, so it
    times no kernel here.)  With a ``label`` the host-clock window goes
    into TIMED."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    t0 = time.time()
    for a, b in ev:
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    t1 = time.time()
    ms = sum(a.elapsed_time(b) for a, b in ev) / iters
    if label is not None:
        TIMED.append((label, ms, t0, t1))
    return ms


def wall_ms(fn, iters=50) -> float:
    """Time per call of back-to-back calls (CUDA events): bounded by the
    host's launch overhead when that exceeds the kernels' time."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, flush, iters=20) -> float:
    """Device time of one call captured once in a CUDA graph and replayed,
    L2 flushed before each replay (``device_ms`` of the replay): the
    kernels' own time, without the host's gaps between a call's launches."""
    fn()  # first call: library load, shared-memory limits
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return device_ms(graph.replay, flush, iters=iters)


class ClockSampler:
    """The SM clock polled by nvidia-smi every 50 ms while the block runs;
    after it, ``mhz(t0, t1)`` gives the samples taken between two
    ``time.time()``s."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        # read as the lines come: a full pipe would stall nvidia-smi
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        time.sleep(0.5)
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                ts, mhz = (f.strip() for f in line.split(","))
                self.samples.append((datetime.strptime(
                    ts, "%Y/%m/%d %H:%M:%S.%f").timestamp(), int(mhz)))
            except ValueError:
                continue

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)
        return False

    def mhz(self, t0, t1) -> list[int]:
        return [m for t, m in self.samples if t0 <= t <= t1]


def _read_card_rates() -> None:
    global HBM_BYTES_PER_S, FP32_FLOP_PER_S
    from repro_torch.launch.mesh import HW

    HBM_BYTES_PER_S = HW.DATASHEET_HBM_BYTES_PER_S
    FP32_FLOP_PER_S = HW.DATASHEET_FP32_FLOP_PER_S


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(kind: str, *args, **kw) -> tuple[float, str]:
    """``bound`` of a kernel's analytic cost: ``launch/cost.py``'s
    ``kernel_cost_<kind>(*args, **kw)``, the one formula the cost census
    records too."""
    from repro_torch.launch import cost

    c = getattr(cost, f"kernel_cost_{kind}")(*args, **kw)
    return bound(c["bytes_read"] + c["bytes_written"], c["flops"])


# ---------------------------------------------------------------- kernels

def check_b3(sq_ops, ref, rot, x, *, group):
    """Kernel vs plain on the same inputs: scales rtol 1e-6, codes equal
    except +-1 flips at .5 ties of y/scale (float64 y)."""
    from repro_torch.benchmarks.kernel_quality import MAX_FLIP_SHARE, TIE_BAND
    from repro_torch.core import packing

    mat = None if rot is None else rot.matrix
    lam = None if rot is None else rot.lam
    kp, ks = sq_ops.srft_quant(x, mat, lam, group=group)
    rp, rs = ref.srft_quant_ref(x, mat, lam, group=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(ks, rs, rtol=1e-6, atol=0)
    ck = packing.unpack_int4(kp).int()
    cr = packing.unpack_int4(rp).int()
    diff = ck - cr
    y = x.double() if mat is None else x.double() @ mat.double().T
    if lam is not None:
        y = y * lam.double()
    ratio = y / rs.double().repeat_interleave(group, dim=-1)
    near_tie = ((ratio.abs() % 1.0) - 0.5).abs() < TIE_BAND
    flips = diff != 0
    assert int(diff.abs().max()) <= 1, "B3 code off by more than 1"
    assert not bool((flips & ~near_tie).any()), "B3 code flipped off a tie"
    share = flips.float().mean().item()
    assert share <= MAX_FLIP_SHARE, f"B3 flip share {share}"
    deq = lambda c, s: (c.float().reshape(*c.shape[:-1], -1, group)  # noqa
                        * s[..., None]).reshape(c.shape)
    err = (deq(ck, ks) - deq(cr, rs)).abs().max().item()
    return err, int(flips.sum())


def b3_shape(sq_ops, x, rot, group, flush, label=None, plain=False) -> dict:
    """B3 at one shape: held to its plain version (``check_b3``) and timed
    by events beside its bound (and the plain version's time, with
    ``plain``); ``rot`` None is the no-matrix route."""
    from repro_torch.kernels.srft_quant import ref

    n, d = x.shape
    err, flips = check_b3(sq_ops, ref, rot, x, group=group)
    mat = None if rot is None else rot.matrix
    lam = None if rot is None else rot.lam
    ms = device_ms(lambda: sq_ops.srft_quant(x, mat, lam, group=group),
                   flush, label=label)
    b_ms, b_by = kernel_bound("b3", n, d, group, x_itemsize=x.element_size(),
                              matrix=rot is not None, lam=rot is not None)
    rec = dict(rows=n, dtype=str(x.dtype).replace("torch.", ""),
               matrix=rot is not None, max_abs_err=err, tie_flips=flips,
               ms=ms, bound_ms=b_ms, bound_by=b_by)
    if plain:
        rec["plain_ms"] = device_ms(lambda: ref.srft_quant_ref(
            x, mat, lam, group=group), flush, iters=5, warmup=1)
    log("B3 " + json.dumps(rec))
    return rec


# (kv heads, G, d) of the configs phase 14 serves: gemma-7b, qwen3-14b,
# dbrx-132b, llava-next-34b, qwen1.5-110b, qwen3-moe-235b-a22b
SERVED_GROUPINGS = ((16, 1, 256), (8, 5, 128), (8, 6, 128), (8, 7, 128),
                    (8, 8, 128), (4, 16, 128))


def kernel_phase(flush):
    from repro_torch.core.transforms import make_rotation
    from repro_torch.kernels.srft_quant import ops as sq_ops
    from repro_torch.kernels.srft_quant import ref as sq_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    d, group, Hkv, G, W = 128, 32, 8, 2, 16
    rot = make_rotation("srft", g, d, "cuda")
    rot.lam = torch.exp(0.3 * torch.randn(d, generator=g, device="cuda"))
    out = []

    # B3, prefill bulk of the longest prompt: (4093 // W * W) * Hkv rows,
    # and of the batch path's shortest (517 // W * W) * Hkv
    n = (PROMPTS[-1] // W) * W * Hkv
    x = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
    shapes = [b3_shape(sq_ops, x, rot, group, flush, label="B3")]
    n_short = (BATCH_PROMPTS[0] // W) * W * Hkv
    x_short = torch.randn((n_short, d), generator=g,
                          device="cuda").to(torch.bfloat16)
    shapes.append(b3_shape(sq_ops, x_short, rot, group, flush))
    # without a matrix: the Engine's W-flush (Hkv * W rows) and the
    # capacity-4 batch ring (CAPACITY * Hkv * W), fp32
    for rows in (Hkv * W, CAPACITY * Hkv * W):
        xf = torch.randn((rows, d), generator=g, device="cuda")
        shapes.append(b3_shape(sq_ops, xf, None, group, flush))
    b3_call = lambda: sq_ops.srft_quant(x, rot.matrix, rot.lam,  # noqa
                                        group=group)
    ms_wall = wall_ms(b3_call)
    plain = device_ms(lambda: sq_ref.srft_quant_ref(
        x, rot.matrix, rot.lam, group=group), flush)
    # context only, never called by the port: cuBLAS's fp32 x @ M^T alone
    # (TF32 off) at the prefill write's shape
    xf32 = x.float()
    cublas = device_ms(lambda: torch.matmul(xf32, rot.matrix.T), flush)
    log(f"context: cuBLAS fp32 x @ M^T at {n} x {d} x {d} (TF32 off, "
        f"product only): {cublas:.4f} ms")
    b3 = dict(name="srft_quant", route="cuda",
              source="src/repro_torch/kernels/csrc/srft_quant.cu",
              replaces="src/repro/kernels/srft_quant/srft_quant.py:91",
              max_abs_err=max(r["max_abs_err"] for r in shapes),
              ms=shapes[0]["ms"], plain_ms=plain,
              bound_ms=shapes[0]["bound_ms"], bound_by=shapes[0]["bound_by"],
              library_ms=None, wall_ms=ms_wall, shapes=shapes,
              cublas_fp32_product_ms=cublas)
    out.append(b3)

    # B3 at gemma-7b's prefill write: 2048 tokens x 16 kv heads, d 256
    rot256 = make_rotation("srft", g, 256, "cuda")
    rot256.lam = torch.exp(0.3 * torch.randn(256, generator=g, device="cuda"))
    x256 = torch.randn((2048 * 16, 256), generator=g,
                       device="cuda").to(torch.bfloat16)
    shapes.append(b3_shape(sq_ops, x256, rot256, group, flush, plain=True))
    log(f"[{CARD}] B3 at gemma-7b's prefill write (32,768 rows x d 256 "
        f"bf16): {shapes[-1]['ms']:.4f} ms, plain {shapes[-1]['plain_ms']:.4f}"
        f" ms, bound {shapes[-1]['bound_ms']:.4f} ms "
        f"({shapes[-1]['bound_by']})")
    del x256
    b3["max_abs_err"] = max(r["max_abs_err"] for r in shapes)

    b1 = check_b1(flush, g, Hkv, G, d, group, W)
    b2 = check_b2(flush, g, Hkv, G, d, group, W)
    # the grouping of phase 14's configs: each B1 / B2 shape held to its
    # plain version and timed beside its bound (G > 8: two head groups)
    keep = ("Hkv", "G", "d", "max_abs_err", "ms", "graph_ms", "plain_ms",
            "bound_ms", "bound_by", "sdpa_context_ms")
    b1["served_shapes"], b2["served_shapes"] = [], []
    for h, gg, dd in SERVED_GROUPINGS:
        r1 = check_b1(flush, g, h, gg, dd, group, W, label=None,
                      by_prompt=False)
        r2 = check_b2(flush, g, h, gg, dd, group, W, label=None,
                      plain_iters=3)
        b1["served_shapes"].append({k: r1[k] for k in keep})
        b2["served_shapes"].append({k: r2.get(k) for k in keep
                                    if k not in ("Hkv", "sdpa_context_ms")}
                                   | {"H": h})
        b1["max_abs_err"] = max(b1["max_abs_err"], r1["max_abs_err"])
        b2["max_abs_err"] = max(b2["max_abs_err"], r2["max_abs_err"])
    # phase 15's served shapes: zamba2-7b's shared block and whisper's
    # cross cache (G 1), and their prefill writes through B3
    for h, dd, grp, S, total, what in P15_B1_SHAPES:
        r1 = check_b1_at(flush, g, h, dd, grp, S, total, W, what)
        b1["served_shapes"].append(r1)
        b1["max_abs_err"] = max(b1["max_abs_err"], r1["max_abs_err"])
    for rows, dd, grp, what in P15_B3_SHAPES:
        rot_s = make_rotation("srft", g, dd, "cuda")
        rot_s.lam = torch.exp(0.3 * torch.randn(dd, generator=g,
                                                device="cuda"))
        xs = torch.randn((rows, dd), generator=g,
                         device="cuda").to(torch.bfloat16)
        shapes.append(b3_shape(sq_ops, xs, rot_s, grp, flush, plain=True)
                      | {"what": what, "d": dd, "group": grp})
        log(f"[{CARD}] B3 at {what} ({rows} rows x d {dd}, group {grp}, "
            f"bf16): {shapes[-1]['ms']:.4f} ms, plain "
            f"{shapes[-1]['plain_ms']:.4f} ms, bound "
            f"{shapes[-1]['bound_ms']:.5f} ms ({shapes[-1]['bound_by']})")
        del xs
    b3["max_abs_err"] = max(r["max_abs_err"] for r in shapes)
    out.append(b1)
    # pages of 48 tokens: neither a divisor nor a multiple of B2's tile
    b2_48 = check_b2(flush, g, Hkv, G, d, group, W, ps=48, label=None)
    b2["page_48"] = {k: b2_48[k] for k in ("max_abs_err", "ms", "graph_ms",
                                           "b1_same_bytes_ms")}
    b2["max_abs_err"] = max(b2["max_abs_err"], b2_48["max_abs_err"])
    b2["cells"] = check_b2_cells(flush)
    b2["max_abs_err"] = max([b2["max_abs_err"]]
                            + [c["max_abs_err"] for c in b2["cells"]])
    out.append(b2)
    b4, b3_rounds = check_b4(flush, g, n, group, b3_call)
    b3["first_ms"], b3["ms"] = b3["ms"], sorted(b3_rounds)[B4_ROUNDS // 2]
    b3["ms_rounds"] = b3_rounds
    b4["raw_view"] = check_b4_raw_view(flush, g, rot, group)
    b4["restore_view"] = check_b4_raw_view(
        flush, g, rot, group, tokens=(OFFLOAD_PROMPT - 1) // PAGE_SIZE
        * PAGE_SIZE, what="restored")
    b4["max_abs_err"] = max(b4["max_abs_err"], b4["raw_view"]["max_abs_err"],
                            b4["restore_view"]["max_abs_err"])
    out.append(b4)
    return out


def check_b4_raw_view(flush, g, rot, group, tokens=SHARED_PREFIX,
                      what="reused"):
    """B4 at its serving shapes: the int4 raw view of a reused 1,024-token
    prefix, or of the 2,048 tokens a host restore brings back (8 KV heads
    x ``tokens`` rows of d 128 per leaf), on codes the cache write (B3,
    unfolded matrix and lambda epilogue) made, against its plain version
    on the same codes, within B4_RTOL x max(1, max |x|); timed."""
    from repro_torch.benchmarks.kernel_quality import B4_RTOL
    from repro_torch.kernels.srft_quant import ops as sq_ops
    from repro_torch.kernels.srft_quant import ref as sq_ref

    n, d = 8 * tokens, rot.d
    x = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
    pk, sc = sq_ops.rotate_quantize(x, rot, group=group)
    minv = sq_ref.fold_inverse_matrix(rot)
    got = sq_ops.dequantize_rotate(pk, sc, rot, group=group)
    want = sq_ref.srft_dequant_ref(pk, sc, minv, group=group)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = B4_RTOL * max(1.0, want.abs().max().item())
    assert torch.isfinite(got).all() and err <= tol, f"B4 raw view {err}"
    call = lambda: sq_ops.srft_dequant(pk, sc, minv, group=group)  # noqa
    label = "B4 raw view" + ("" if what == "reused" else f" ({what})")
    ms = device_ms(call, flush, label=label)
    plain = device_ms(lambda: sq_ref.srft_dequant_ref(pk, sc, minv,
                                                      group=group), flush)
    b_ms, b_by = kernel_bound("b4", n, d, group)
    log(f"[{CARD}] B4 at the raw view of a {what} {tokens}-token "
        f"prefix ({n} rows x d {d}, int4): max abs err {err:.3e} (tol "
        f"{tol:.3e}); {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} "
        f"ms ({b_by})")
    return dict(rows=n, d=d, bits=4, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def check_b1(flush, g, Hkv, G, d, group, W, label="B1", by_prompt=True):
    """B1 at the longest request's last decode step (batch 1, scalar
    lengths) and at per-row lengths with an empty row and tile-edge rows,
    against its plain version (B1_ATOL); then timed: CUDA events around
    each call, and each call captured once in a CUDA graph and replayed
    (``by_prompt``: also at the 517- and 4093-token requests' lengths)."""
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.quant_attention import ref as qa_ref

    total = PROMPTS[-1] + NEW_TOKENS - 1
    plen = total - total % W
    BH = Hkv
    q = torch.randn((BH, G, d), generator=g, device="cuda") * 0.1
    kp = torch.randint(0, 256, (BH, S_MAX, d // 2), generator=g,
                       device="cuda", dtype=torch.uint8)
    vp = torch.randint(0, 256, (BH, S_MAX, d // 2), generator=g,
                       device="cuda", dtype=torch.uint8)
    ks = torch.rand((BH, S_MAX, d // group), generator=g, device="cuda") * 0.3
    vs = torch.rand((BH, S_MAX, d // group), generator=g, device="cuda") * 0.3
    kr = torch.randn((BH, W, d), generator=g, device="cuda")
    vr = torch.randn((BH, W, d), generator=g, device="cuda")
    args = (q, kp, ks, vp, vs, kr, vr)
    got = qa_ops.quant_decode_attention(*args, plen, total, group=group)
    want = qa_ref.quant_decode_attention_ref(*args, plen, total, group=group)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= B1_ATOL, f"B1 err {err}"
    # per-row lengths with an empty row and a tile-edge row (the pattern
    # of 8 repeated or cut to BH rows)
    rows = torch.tensor([0, 64, 65, 1000, plen, 16, 4096, 4500],
                        dtype=torch.int32, device="cuda")
    tl = (rows + torch.tensor([0, 0, 3, 15, total - plen, 1, 16, 7],
                              device="cuda")).int()
    rows, tl = (t.repeat(-(-BH // 8))[:BH] for t in (rows, tl))
    got_r = qa_ops.quant_decode_attention(*args, rows, tl, group=group)
    want_r = qa_ref.quant_decode_attention_ref(*args, rows, tl, group=group)
    err_r = (got_r - want_r).abs().max().item()
    assert torch.isfinite(got_r).all() and err_r <= B1_ATOL, f"B1 rows {err_r}"
    log(f"B1 decode read BH={BH} G={G} d={d} plen={plen} total={total}: "
        f"max abs err {err:.3e} (per-row lengths {err_r:.3e}), "
        f"tolerance {B1_ATOL}")
    lse = check_b1_lse(args, plen, total, rows, tl, group) \
        if label == "B1" else {}
    call = lambda: qa_ops.quant_decode_attention(  # noqa: E731
        *args, plen, total, group=group)
    ms, ms_wall = device_ms(call, flush, label=label), wall_ms(call)
    if lse:
        lse["ms"] = device_ms(lambda: qa_ops.quant_decode_attention(
            *args, plen, total, group=group, return_lse=True), flush)
        log(f"[{CARD}] B1 with its log-sum-exp stored: {lse['ms']:.4f} ms "
            f"(events), without: {ms:.4f} ms")
    ms_graph = graph_ms(call, flush)
    plain = device_ms(lambda: qa_ref.quant_decode_attention_ref(
        *args, plen, total, group=group), flush)
    b_ms, b_by = kernel_bound("b1", BH, G, d, group, W, BH * plen)
    # context only: a bf16 SDPA read of a bf16 cache of the same length
    qb = torch.randn((1, BH * G, 1, d), device="cuda", dtype=torch.bfloat16)
    kb = torch.randn((1, BH, total, d), device="cuda", dtype=torch.bfloat16)
    sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, kb, enable_gqa=True), flush)
    log(f"context: bf16 SDPA over a {total}-token bf16 cache: {sdpa:.4f} ms")
    log(f"[{CARD}] B1 Hkv={Hkv} G={G} d={d}: {ms:.4f} ms (events), "
        f"{ms_graph:.4f} ms (graph replay), plain {plain:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    # the graph decodes a ragged cache: per-row lengths plan the split from
    # S = s_max, scalar lengths from the prefix
    by_length = {}
    for n in (PROMPTS[0], PROMPTS[-1]) if by_prompt else ():
        tot = n + NEW_TOKENS - 1
        pl = tot - tot % W
        rows_p = torch.full((BH,), pl, dtype=torch.int32, device="cuda")
        rows_t = torch.full((BH,), tot, dtype=torch.int32, device="cuda")
        by_length[n] = dict(
            scalar_ms=graph_ms(lambda: qa_ops.quant_decode_attention(
                *args, pl, tot, group=group), flush),
            per_row_ms=graph_ms(lambda: qa_ops.quant_decode_attention(
                *args, rows_p, rows_t, group=group), flush))
        log(f"B1 at the {n}-token request's last step (graph replay): "
            f"scalar lengths {by_length[n]['scalar_ms']:.4f} ms, per-row "
            f"lengths {by_length[n]['per_row_ms']:.4f} ms")
    return dict(name="quant_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_attention.cu",
                replaces="src/repro/kernels/quant_attention/"
                         "quant_attention.py:157",
                max_abs_err=max(err, err_r), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                wall_ms=ms_wall, graph_ms=ms_graph,
                graph_ms_by_prompt=by_length, sdpa_context_ms=sdpa,
                Hkv=Hkv, G=G, d=d, **({"lse": lse} if lse else {}))


def check_b1_lse(args, plen, total, rows, tl, group) -> dict:
    """B1's optional log-sum-exp (phase 18's split-K combine reads it)
    against its plain version's at check_b1's scalar lengths, its per-row
    lengths (an empty row among them) and at a split-K shard's shape
    (1536 positions, m = 3 at S_MAX = 4608, with the ring on its rows
    and a segment with nothing to read, whose lse must be the -1e30
    sentinel and its output finite); the outputs with the pointer equal
    those without it bit for bit."""
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.quant_attention import ref as qa_ref

    span = S_MAX // 3
    shard = tuple(a[:, :span].contiguous() if a.dim() == 3 and i in
                  range(1, 5) else a for i, a in enumerate(args))
    BH = args[0].shape[0]
    seg = torch.full((BH,), span, dtype=torch.int32, device="cuda")
    seg[BH // 2:] = 0  # the second half of the rows: an empty segment
    seg_t = seg + torch.where(seg > 0, 11, 0).int()
    errs = {}
    for what, a, pl, tt in (("scalar", args, plen, total),
                            ("per-row", args, rows, tl),
                            ("shard", shard, seg, seg_t)):
        out, lse = qa_ops.quant_decode_attention(*a, pl, tt, group=group,
                                                 return_lse=True)
        out0 = qa_ops.quant_decode_attention(*a, pl, tt, group=group)
        want_o, want = qa_ref.quant_decode_attention_ref(
            *a, pl, tt, group=group, return_lse=True)
        assert torch.equal(out, out0), f"B1 {what}: output moved by the lse"
        assert torch.isfinite(out).all(), f"B1 {what}: not finite"
        e_o = (out - want_o).abs().max().item()
        errs[what] = (lse - want).abs().max().item()
        assert e_o <= B1_ATOL and errs[what] <= LSE_ATOL, (what, e_o, errs)
        if what == "shard":
            assert (lse[BH // 2:] == -1e30).all(), "empty segment's lse"
    log(f"B1 log-sum-exp vs plain: max abs err {errs} (tolerance "
        f"{LSE_ATOL}); outputs with the pointer == without; an empty "
        f"segment's lse -1e30")
    return {"max_abs_err": max(errs.values()), "by_case": errs}


# (kv heads, d, group, s_max, total length, what) of phase 15's reads: the
# shared block of zamba2-7b at its 2048 + 32-token request's last step, and
# whisper-large-v3's cross cache over 1500 frames (1488 packed + 12)
P15_B1_SHAPES = ((32, 112, 28, 2096, 2079, "zamba2-7b's shared block"),
                 (20, 64, 32, 1520, 1500, "whisper's cross cache"))
# (rows, d, group, what) of phase 15's prefill writes, per layer and side
P15_B3_SHAPES = ((2048 * 32, 112, 28, "zamba2-7b's prefill write"),
                 (1488 * 20, 64, 32, "whisper's cross-cache write"))


def check_b1_at(flush, g, BH, d, group, S, total, W, what) -> dict:
    """B1 at one served shape with G = 1 (scalar and per-row lengths, the
    latter what a graph decode passes), against its plain version
    (B1_ATOL); timed by events and as a graph replay, beside its bound and
    the plain version's time."""
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.quant_attention import ref as qa_ref

    plen = total - total % W
    q = torch.randn((BH, 1, d), generator=g, device="cuda") * 0.1

    def u8():
        return torch.randint(0, 256, (BH, S, d // 2), generator=g,
                             device="cuda", dtype=torch.uint8)

    def sc():
        return torch.rand((BH, S, d // group), generator=g,
                          device="cuda") * 0.3

    args = (q, u8(), sc(), u8(), sc(),
            torch.randn((BH, W, d), generator=g, device="cuda"),
            torch.randn((BH, W, d), generator=g, device="cuda"))
    rows_p = torch.full((BH,), plen, dtype=torch.int32, device="cuda")
    rows_t = torch.full((BH,), total, dtype=torch.int32, device="cuda")
    err = 0.0
    for pl, tl in ((plen, total), (rows_p, rows_t)):
        got = qa_ops.quant_decode_attention(*args, pl, tl, group=group)
        want = qa_ref.quant_decode_attention_ref(*args, pl, tl, group=group)
        e = (got - want).abs().max().item()
        assert torch.isfinite(got).all() and e <= B1_ATOL, f"B1 {what} {e}"
        err = max(err, e)
    call = lambda: qa_ops.quant_decode_attention(  # noqa: E731
        *args, rows_p, rows_t, group=group)
    ms, ms_graph = device_ms(call, flush), graph_ms(call, flush)
    plain = device_ms(lambda: qa_ref.quant_decode_attention_ref(
        *args, rows_p, rows_t, group=group), flush, iters=5, warmup=1)
    b_ms, b_by = kernel_bound("b1", BH, 1, d, group, W, BH * plen,
                              per_row_lengths=True)
    log(f"[{CARD}] B1 at {what} (Hkv={BH} G=1 d={d} group={group}, "
        f"{plen} packed + {total - plen} in the window): max abs err "
        f"{err:.3e}; {ms:.4f} ms (events), {ms_graph:.4f} ms (graph "
        f"replay), plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(Hkv=BH, G=1, d=d, group=group, S=S, plen=plen, total=total,
                what=what, max_abs_err=err, ms=ms, graph_ms=ms_graph,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def check_b4(flush, g, n, group, b3_call):
    """B4 on codes the folded B3 wrote, against its plain version on the
    same codes (``kernel_quality.fold_and_invert``): at n rows x d 128
    int4 (B3's prefill write), timed, and at d 64 / 128 / 256 x int4 /
    int8, checked.  Scaled lambda inflates the outputs, so the tolerance
    is relative to max |x|.  B4's time is the median of B4_ROUNDS rounds,
    each also timing B3's prefill write (``b3_call``) with the SM clock
    sampled; returns B4's record and B3's times by round."""
    from repro_torch.benchmarks.kernel_quality import B4_RTOL, fold_and_invert
    from repro_torch.core.transforms import make_rotation
    from repro_torch.kernels.srft_quant import ops as sq_ops
    from repro_torch.kernels.srft_quant import ref as sq_ref

    checks, timed = [], None
    for d, bits in ((128, 4), (128, 8), (64, 4), (64, 8), (256, 4),
                    (256, 8)):
        rot = make_rotation("srft", g, d, "cuda")
        rot.lam = torch.exp(0.3 * torch.randn(d, generator=g, device="cuda"))
        x = torch.randn((n, d), generator=g, device="cuda")
        rt = fold_and_invert(x, rot, group=group, bits=bits)
        torch.cuda.synchronize()
        assert torch.isfinite(rt["x"]).all() and rt["err"] <= rt["tol"], \
            f"B4 d={d} bits={bits}: err {rt['err']} > {rt['tol']}"
        checks.append(dict(d=d, bits=bits, rows=n, max_abs_err=rt["err"],
                           tol=rt["tol"]))
        if timed is None:
            timed = (rt["packed"], rt["scales"], rt["minv"], d, bits,
                     rt["err"])
    pk, sc, minv, d, bits, err = timed
    call = lambda: sq_ops.srft_dequant(pk, sc, minv, group=group,  # noqa
                                       bits=bits)
    b3_rounds, b4_rounds = [], []
    for i in range(B4_ROUNDS):
        b3_rounds.append(device_ms(b3_call, flush, label=f"B3 round {i}"))
        b4_rounds.append(device_ms(call, flush, label=f"B4 round {i}"))
    ms = sorted(b4_rounds)[B4_ROUNDS // 2]
    ms_wall = wall_ms(call)
    plain = device_ms(lambda: sq_ref.srft_dequant_ref(
        pk, sc, minv, group=group, bits=bits), flush)
    b_ms, b_by = kernel_bound("b4", n, d, group, bits=bits)
    log(f"B4 dequantize + inverse rotation n={n} d={d} int4: max abs err "
        f"{err:.3e}; all shapes within {B4_RTOL} x max(1, max|x|): "
        + ", ".join(f"d{c['d']}/b{c['bits']} {c['max_abs_err']:.2e}"
                    for c in checks)
        + f"; median {ms:.4f} ms of {B4_ROUNDS} rounds (min "
        f"{min(b4_rounds):.4f}, max {max(b4_rounds):.4f}), plain "
        f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(name="srft_dequant", route="cuda",
                source="src/repro_torch/kernels/csrc/srft_quant.cu",
                replaces="src/repro/kernels/srft_quant/srft_quant.py:132",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, wall_ms=ms_wall,
                ms_rounds=b4_rounds,
                checks=checks), b3_rounds


def check_b2(flush, g, H, G, d, group, W, ps=PAGE_SIZE, label="B2",
             plain_iters=20):
    """B2 at the batch path's shapes: rows at the batch prompts' lengths
    plus a retired row of length 0, pages of ``ps`` tokens shuffled.
    Against its plain version (B1_ATOL) and against B1 on the gathered view
    (bitwise), then both timed on the same bytes (the plain version over
    ``plain_iters`` calls)."""
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.quant_attention import ref as qa_ref

    lengths = BATCH_PROMPTS + (0,)
    MP = S_MAX // ps
    need = [-(-n // ps) for n in lengths]
    n_pages = sum(need) + 1
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator()
                           .manual_seed(SEED)) + 1).tolist()
    table = torch.zeros((len(lengths), MP), dtype=torch.int32)
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
    table = table.to(DEV)
    N, BH = n_pages * H, len(lengths) * H
    q = torch.randn((BH, G, d), generator=g, device=DEV) * 0.1
    pools = []
    for _ in "kv":  # codes and scales of K, then of V
        pools += [torch.randint(0, 256, (N, ps, d // 2), generator=g,
                                device=DEV, dtype=torch.uint8),
                  torch.rand((N, ps, d // group), generator=g,
                             device=DEV) * 0.3]
    kr = torch.randn((BH, W, d), generator=g, device=DEV)
    vr = torch.randn((BH, W, d), generator=g, device=DEV)
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV
                     ).repeat_interleave(H)
    plen = (L - L % W).int()
    kw = dict(group=group, page_size=ps, n_kv_heads=H)
    args = (q, *pools, kr, vr, plen, L, table)
    got = qa_ops.quant_decode_attention_paged(*args, **kw)
    want = qa_ref.quant_decode_attention_paged_ref(
        *args, group=group, n_kv_heads=H)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= B1_ATOL, f"B2 err {err}"
    rows = [qa_ref.paged_rows(t, table, H).contiguous() for t in pools]
    dense_args = (q, *rows, kr, vr, plen, L)
    dense = qa_ops.quant_decode_attention(*dense_args, group=group)
    torch.cuda.synchronize()
    assert torch.equal(got, dense), "B2 != B1 on the gathered view"
    call = lambda: qa_ops.quant_decode_attention_paged(*args, **kw)  # noqa
    ms = device_ms(call, flush, label=label)
    ms_wall = wall_ms(call)
    ms_graph = graph_ms(call, flush)
    b1_ms = device_ms(lambda: qa_ops.quant_decode_attention(
        *dense_args, group=group), flush)
    plain = device_ms(lambda: qa_ref.quant_decode_attention_paged_ref(
        *args, group=group, n_kv_heads=H), flush, iters=plain_iters,
        warmup=min(3, plain_iters))
    n_tok = int(plen.sum())  # packed tokens this input's rows hold
    b_ms, b_by = kernel_bound("b2", BH, G, d, group, W, n_tok,
                              table.numel())
    log(f"[{CARD}] B2 paged read rows={lengths} H={H} G={G} d={d} "
        f"page_size={ps} "
        f"(shuffled table): max abs err {err:.3e} (tol {B1_ATOL}); equal "
        f"to B1 on the gathered view; B2 {ms:.4f} ms (graph replay "
        f"{ms_graph:.4f} ms), B1 on the same bytes {b1_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return dict(name="quant_decode_attention_paged", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_attention.cu",
                replaces="src/repro/kernels/quant_attention/"
                         "quant_attention.py:228",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, wall_ms=ms_wall,
                graph_ms=ms_graph, b1_same_bytes_ms=b1_ms, H=H, G=G, d=d,
                page_size=ps)


def check_b2_cells(flush, seed=SEED) -> list[dict]:
    """B2 at one layer of each long-context cell of the benchmark
    (``decode_read_parts.cell_inputs``: 64 sessions at G 2 and 32 at G 5,
    8 KV heads, d 128, group 32, pages of 16, lengths from ``seed``):
    against its plain version (B1_ATOL), counted as a tensor-core pass 1,
    and timed by events and as a graph replay beside the bound of
    ``perfbench.costs.b2_step_work`` at the same lengths."""
    from perfbench import costs
    from repro_torch.benchmarks import decode_read_parts as parts
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.quant_attention import ref as qa_ref

    out = []
    for cell, arch in (("internlm2-longctx-decode", "internlm2-1.8b"),
                       ("qwen3-14b-longctx-decode", "qwen3-14b")):
        args, kw, lengths = parts.cell_inputs(cell, seed)
        call = lambda: qa_ops.quant_decode_attention_paged(  # noqa: E731
            *args, **kw)
        tc = qa_ops.tc_launches
        got = call()
        assert qa_ops.tc_launches == tc + 1, f"{cell}: not on the tensor cores"
        want = qa_ref.quant_decode_attention_paged_ref(
            *args, group=kw["group"], n_kv_heads=kw["n_kv_heads"])
        err = (got - want).abs().max().item()
        assert torch.isfinite(got).all() and err <= B1_ATOL, \
            f"B2 {cell} err {err}"
        del want
        ms = device_ms(call, flush, label=f"B2 {cell}")
        ms_graph = graph_ms(call, flush)
        flops, nbytes = costs.b2_step_work(get_config(arch), lengths)
        b_ms = max(nbytes / costs.PEAK_HBM_BYTES_S,
                   flops / costs.PEAK_FP32_FLOPS) * 1e3
        BH, G, _ = args[0].shape
        log(f"[{CARD}] B2 at a layer of {cell}: {BH} rows, G={G}, lengths "
            f"{min(lengths)}..{max(lengths)} (mean "
            f"{sum(lengths) / len(lengths):.0f}): max abs err {err:.3e}; "
            f"{ms:.4f} ms (graph replay {ms_graph:.4f} ms), bound "
            f"{b_ms:.4f} ms: {100 * b_ms / ms:.1f}% of it")
        out.append(dict(cell=cell, rows=BH, G=G, max_abs_err=err, ms=ms,
                        graph_ms=ms_graph, bound_ms=b_ms,
                        bound_share=b_ms / ms))
    return out


def pass1_registers(log_text: str) -> list[dict]:
    """Registers, spill bytes and stack of each tensor-core pass-1
    instantiation, from ``nvcc``'s ``ptxas -v`` output."""
    import re

    rows, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            args = re.search(r"qda_split_kernel_tcINS_\d+(Paged|Dense)"
                             r"RowsELi(\d+)ELi(\d+)ELb([01])E", m.group(1))
            if args:
                cur = dict(rows=args.group(1), NW=int(args.group(2)),
                           NB=int(args.group(3)), PN=args.group(4) == "1")
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


# ------------------------------------------------------------------ model

def small_reference_phase(cfg=None, what="reduced internlm2",
                          cases=(("int4-srft", "kernel"),
                                 ("int8-per-token", None))):
    """The port on the card (kernels) against the port on the CPU (plain
    versions, themselves held against the JAX reference by the tests), on
    a small model: internlm2-shaped unless ``cfg`` is given."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import Engine
    from repro_torch.models.lm import LM

    if cfg is None:
        cfg = reduced(get_config("internlm2-1.8b"))
    cpu = LM(cfg, device="cpu")
    params = cpu.init(cpu.generator(SEED))
    gpu = LM(cfg, device="cuda")
    params_gpu = _to(params, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, 37),
                           generator=torch.Generator().manual_seed(SEED))
    for policy, backend in cases:
        res = {}
        for name, model, p in (("cpu", cpu, params),
                               ("cuda", gpu, params_gpu)):
            cache = model.init_cache(
                1, 96, policy=policy, ragged=True,
                generator=torch.Generator().manual_seed(5))
            res[name] = Engine(model, backend=backend).generate(
                p, prompt.to(model.device), cache, 24, return_logits=True)
        lc, lg = res["cpu"][1], res["cuda"][1].cpu()
        assert lg.shape == (1, 24, cfg.vocab_size) and torch.isfinite(lg).all()
        tc, tg = res["cpu"][0], res["cuda"][0].cpu()
        n_same = _agree_until(tc, tg, lc)
        err = (lc[:, :n_same] - lg[:, :n_same]).abs().max().item()
        tol = LOGIT_TOL * lc.abs().max().item()
        assert err <= tol, f"small model {policy}: card vs CPU {err} > {tol}"
        log(f"small model ({what}, 37+24 tokens, {policy} "
            f"{(backend or 'gather').upper()}): card (graph) vs CPU plain "
            f"max logit err {err:.3e} (tol {tol:.3e}), tokens agree for "
            f"{n_same}/24 steps")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _agree_until(t_ref, t_got, l_ref) -> int:
    """Steps whose logits may be compared: all if the greedy tokens agree,
    else up to the first divergence, which must be a near-tie."""
    diff = (t_ref != t_got).nonzero()
    if not len(diff):
        return t_ref.shape[1]
    b, i = diff[diff[:, 1].argmin()].tolist()
    top2 = l_ref[b, i].topk(2).values
    gap = (top2[0] - top2[1]).item()
    tol = LOGIT_TOL * l_ref.abs().max().item()
    assert gap < tol, f"tokens diverge at step {i} with top-2 gap {gap}"
    log(f"  near-tie divergence at step {i} (top-2 gap {gap:.3e})")
    return i + 1


def serve(model, params, policy, backend, prompt_len, graph=True,
          keep=False, rots=None, new_tokens=NEW_TOKENS, s_max=S_MAX):
    """One request through ``Engine`` on a ragged batch-1 cache: the
    captured step (``graph``) or the eager loop; ``rots`` (one (k, v) pair
    per layer) replaces the cache's own rotations.  The first decode call
    makes one step (under a graph it warms up and captures first); the
    other ``new_tokens`` - 2 are timed by CUDA events.  Returns (row, tokens,
    logits), plus (engine, cache) with ``keep``."""
    from repro_torch.launch.engine import GRAPH_KEY, Engine

    g = torch.Generator(device="cuda").manual_seed(SEED + prompt_len)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prompt_len),
                           generator=g, device="cuda")
    cache = model.init_cache(1, s_max, policy=policy, ragged=True, rots=rots,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend=backend, graph=graph)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = eng.prefill(params, prompt, cache)
    tok = lg[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok1, l1, cache = eng.decode(params, tok, cache, 1, return_logits=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a.record()
    toks, step_logits, cache = eng.decode(params, tok1, cache,
                                          new_tokens - 2, return_logits=True)
    b.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    toks = torch.cat([tok, tok1, toks], dim=1)
    all_logits = torch.cat([lg[:, -1:].float(), l1, step_logits], dim=1)
    assert toks.shape == (1, new_tokens)
    assert all_logits.shape == (1, new_tokens, model.cfg.vocab_size)
    assert torch.isfinite(all_logits).all(), "non-finite logits"
    pos = int(cache["pos"][0])
    assert pos == prompt_len + new_tokens - 1, pos
    assert all(int(c.length[0]) == pos for c in cache["attn"])
    attn = cache["attn"]
    n = new_tokens - 2
    row = dict(policy=policy, backend=backend or "gather", prompt=prompt_len,
               graph=graph, prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_tok=a.elapsed_time(b) / n,
               host_ms_per_tok=(t3 - t2) * 1e3 / n,
               first_step_ms=(t2 - t1) * 1e3,
               capture_s=cache[GRAPH_KEY].step.capture_s if graph else None,
               cache_bytes=sum(c.nbytes() for c in attn),
               compression=attn[0].policy.compression_ratio(attn[0]))
    out = (row, toks.cpu(), all_logits.cpu())
    return out + (eng, cache) if keep else out


def profile_decode(model, params, policy, backend, prompt_len, graph,
                   steps=4):
    """Decode steps of one request under torch.profiler: wall ms per step
    (host clock, inflated by the profiler), device-busy ms per step (sum of
    kernel durations), the device's idle share, and the kernels that take
    the most device time; then as many steps again without the profiler,
    timed by CUDA events, and the idle share against that time.  The
    eager loop runs on a plain cache (scalar lengths, the path before
    graphs); the graph on a ragged one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.engine import Engine

    g = torch.Generator(device="cuda").manual_seed(SEED + prompt_len)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prompt_len),
                           generator=g, device="cuda")
    cache = model.init_cache(1, S_MAX, policy=policy, ragged=graph,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend=backend, graph=graph)
    lg, cache = eng.prefill(params, prompt, cache)
    toks, cache = eng.decode(params, lg[:, -1].argmax(-1)[:, None], cache, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(params, toks[:, -1:], cache, steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    eng.decode(params, toks[:, -1:], cache, steps)
    b.record()
    torch.cuda.synchronize()
    ev = a.elapsed_time(b) / steps
    us = _kernel_us(prof)
    busy = sum(us.values()) / 1e3 / steps
    top = sorted(us.items(), key=lambda kv: -kv[1])[:10]
    return dict(policy=policy, backend=backend or "gather",
                prompt=prompt_len, graph=graph, wall_ms_per_step=wall,
                device_busy_ms_per_step=busy, idle_share=1 - busy / wall,
                events_ms_per_step=ev, idle_share_events=1 - busy / ev,
                top_kernels_ms_per_step=[(k[:60], v / 1e3 / steps)
                                         for k, v in top],
                own_kernels_ms_per_step=_own_ms(us, steps))


def _graph_agrees(eager, graph, what) -> None:
    """Graph tokens equal the eager loop's up to a near-tie; logits within
    GRAPH_TOL of the largest eager logit up to there."""
    (t_e, l_e), (t_g, l_g) = eager, graph
    n = _agree_until(t_e, t_g, l_e)
    err = (l_g[:, :n] - l_e[:, :n]).abs().max().item()
    tol = GRAPH_TOL * l_e.abs().max().item()
    assert err <= tol, f"{what}: graph vs eager logits {err} > {tol}"
    log(f"  {what}: graph == eager for {n}/{t_e.shape[1]} tokens, max "
        f"logit diff {err:.3e} (tol {tol:.3e})")


def main_path_phase():
    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.models.lm import LM

    assert common.BF16_DOTS, "expected REPRO_BF16_DOTS=1"
    log("dot mode: bf16 operands, fp32 accumulate (REPRO_BF16_DOTS=1)")
    full = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(full, n_layers=MAIN_LAYERS)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(model.generator(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers}/{full.n_layers} layers, d_model "
        f"{cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params, init {time.perf_counter() - t0:.1f}s")
    # warm-up requests (first-call allocations, cuBLAS handles), not counted
    for graph in (True, False):
        serve(model, params, "int4-srft", "kernel", 64, graph)
        serve(model, params, "bf16", None, 64, graph)

    # the main path: each request's counters zeroed just before, read after
    launches = dict.fromkeys(_counters(), 0)
    runs = {}
    for n in PROMPTS:
        _zero_counters()
        row, toks, logits = serve(model, params, "int4-srft", "kernel", n)
        MAIN_LAUNCHES[n] = _counters()
        for k, c in _counters().items():
            launches[k] += c
        runs["int4-srft", "kernel", n, True] = [(row, toks, logits)]
    log(f"main-path launches (graph replays): {launches}")
    for name in ("srft_quant", "quant_decode_attention"):
        assert launches[name] > 0, f"{name} never launched on the main path"

    # interleaved rounds: eager and graph in alternating order
    configs = [("int4-srft", "kernel"), ("bf16", None)]
    for r in range(ENGINE_ROUNDS):
        for i, n in enumerate(PROMPTS):
            for j, (policy, backend) in enumerate(configs):
                modes = (False, True) if (r + i + j) % 2 == 0 \
                    else (True, False)
                for graph in modes:
                    key = (policy, backend, n, graph)
                    if r == 0 and key in runs:
                        continue  # the main path's run is round 0's
                    runs.setdefault(key, []).append(
                        serve(model, params, policy, backend, n, graph))
    n_g = PROMPTS[1]  # the GATHER and BLOCKWISE reruns
    for policy, backend in (("int4-srft", "gather"),
                            ("int4-srft", "blockwise"),
                            ("bf16", "blockwise")):
        for graph in (True, False):
            runs[policy, backend, n_g, graph] = [
                serve(model, params, policy, backend, n_g, graph)]
    for key, rs in runs.items():
        for row, _, _ in rs:
            log("request " + json.dumps(row))
    for policy, backend, n, graph in runs:
        if graph:
            _, t_e, l_e = runs[policy, backend, n, False][0]
            _, t_g, l_g = runs[policy, backend, n, True][0]
            _graph_agrees((t_e, l_e), (t_g, l_g),
                          f"{policy}/{backend or 'gather'} {n} tokens")

    _, toks_g, logits_g = runs["int4-srft", "gather", n_g, True][0]
    _, toks_k, logits_k = runs["int4-srft", "kernel", n_g, True][0]
    n_same = _agree_until(toks_k, toks_g, logits_k)
    err = (logits_k[:, :n_same] - logits_g[:, :n_same]).abs().max().item()
    tol = LOGIT_TOL * logits_k.abs().max().item()
    assert err <= tol, f"GATHER vs KERNEL logits {err} > {tol}"
    log(f"GATHER vs KERNEL at the {n_g}-token request (graph): max logit "
        f"diff {err:.3e} (tol {tol:.3e}), tokens agree for "
        f"{n_same}/{NEW_TOKENS} steps")
    blockwise_vs_gather(runs, n_g)
    summary = {}
    for (policy, backend, n, graph), rs in runs.items():
        summary.setdefault(f"{policy}/{backend or 'gather'}/{n}", {})[
            "graph" if graph else "eager"] = [
            round(row["decode_ms_per_tok"], 4) for row, _, _ in rs]
    log("decode ms/token by CUDA events, per round: " + json.dumps(summary))
    MAIN_SUMMARY.update(summary)

    for policy, backend, n in (("int4-srft", "kernel", PROMPTS[-1]),
                               ("bf16", None, PROMPTS[-1]),
                               ("int4-srft", "kernel", PROMPTS[0])):
        for graph in (False, True):
            log("decode profile " + json.dumps(profile_decode(
                model, params, policy, backend, n, graph)))
    no_sync_region(model, params)
    return launches, model, params


def blockwise_vs_gather(runs, n):
    """BLOCKWISE against GATHER at the ``n``-token request, both policies,
    graph and eager: tokens equal up to a near-tie, logits within
    LOGIT_TOL (tests/test_torch_engine.py's tolerance); then ms/token of
    the four read paths side by side."""
    for policy in ("int4-srft", "bf16"):
        gather = None if policy == "bf16" else "gather"
        for graph in (True, False):
            _, t_g, l_g = runs[policy, gather, n, graph][0]
            _, t_b, l_b = runs[policy, "blockwise", n, graph][0]
            n_same = _agree_until(t_g, t_b, l_g)
            err = (l_b[:, :n_same] - l_g[:, :n_same]).abs().max().item()
            tol = LOGIT_TOL * l_g.abs().max().item()
            assert err <= tol, f"{policy} BLOCKWISE vs GATHER {err} > {tol}"
            log(f"  {policy} BLOCKWISE vs GATHER at {n} tokens "
                f"({'graph' if graph else 'eager'}): max logit diff "
                f"{err:.3e} (tol {tol:.3e}), tokens agree for "
                f"{n_same}/{NEW_TOKENS} steps")
    table = {}
    for policy, backend in (("int4-srft", "kernel"), ("int4-srft", "gather"),
                            ("int4-srft", "blockwise"), ("bf16", None),
                            ("bf16", "blockwise")):
        for graph in (True, False):
            table[f"{policy}/{backend or 'gather'}/"
                  f"{'graph' if graph else 'eager'}"] = round(
                runs[policy, backend, n, graph][0][0]["decode_ms_per_tok"], 4)
    log(f"[{CARD}] decode ms/token at the {n}-token request by read path "
        f"(CUDA events, first round): " + json.dumps(table))


def no_sync_region(model, params, n=16, policy="int4-srft",
                   backend="kernel"):
    """A captured Engine decode of ``n`` tokens inside
    ``set_sync_debug_mode("error")``: any host sync in the replay loop
    raises."""
    _, toks, _, eng, cache = serve(model, params, policy, backend,
                                   PROMPTS[0], keep=True)
    tok = toks[:, -1:].cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, cache = eng.decode(params, tok, cache, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out.shape == (1, n)
    log(f"no host sync: {n} graph replays of Engine.decode ({policy}) "
        f"under set_sync_debug_mode('error')")


# ---------------------------------------------------------- batch serving

def _counters():
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.srft_quant import ops as sq_ops

    return {"srft_quant": sq_ops.launches,
            "srft_dequant": sq_ops.dequant_launches,
            "quant_decode_attention": qa_ops.launches,
            "quant_decode_attention_paged": qa_ops.paged_launches}


def _zero_counters():
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.srft_quant import ops as sq_ops

    sq_ops.launches = sq_ops.dequant_launches = 0
    qa_ops.launches = qa_ops.paged_launches = 0


def batch_requests(vocab):
    """Two sharers of a 1024-token page-aligned prefix (submitted first,
    so both are resident after the first step), then the four ragged
    requests."""
    from repro_torch.launch.batch_engine import Request

    g = torch.Generator().manual_seed(SEED + 7)
    prefix = torch.randint(0, vocab, (SHARED_PREFIX,), generator=g)
    reqs = [Request(i, torch.cat([prefix, torch.randint(
        0, vocab, (SHARER_TAIL,), generator=g)]).numpy(), SHARER_NEW)
        for i in range(2)]
    reqs += [Request(2 + i, torch.randint(0, vocab, (n,), generator=g)
                     .numpy(), m)
             for i, (n, m) in enumerate(zip(BATCH_PROMPTS, BATCH_NEW))]
    return reqs


def serve_batch(model, params, policy, backend, paged, reqs, *,
                capacity=CAPACITY, n_pages=None, after_first_step=None,
                before_first_decode=None, graph=True, s_max=S_MAX,
                **chunking):
    """Run ``reqs`` through a BatchEngine (the captured step, or the eager
    loop; ``chunking`` takes ``prefill_chunk``, ``prefill_budget`` and
    ``prefix_reuse``).  Returns (engine, completions by rid, report):
    decode ms per step (CUDA events and the host clock around each decode
    chunk, which ends in a readback; the chunk that captures the graph is
    left out), capture time, per-request ms per token (first to last
    token), cache or pool bytes, and for the longest prompt what a user
    of the other streams feels while it is admitted (``admission``: the
    longest gap between two token events of a live stream, host clock,
    and its time to first token from the start of its admission), plus
    each request's reused tokens (``reused``).  ``before_first_decode``
    is called with the engine just before its first decode chunk (after
    the first admissions and prefills); ``after_first_step`` after its
    first step."""
    from repro_torch.launch.batch_engine import BatchEngine

    eng = BatchEngine(model, params, capacity=capacity, s_max=s_max,
                      policy=policy, backend=backend, chunk=CHUNK,
                      paged=paged, page_size=PAGE_SIZE, n_pages=n_pages,
                      device=DEV, graph=graph, **chunking)
    started, reused = {}, {}
    for name in ("_admit", "_start_pending"):
        def opening(req, *a, _fn=getattr(eng, name), **k):
            started.setdefault(req.rid, time.perf_counter())
            out = _fn(req, *a, **k)
            if eng._pending is not None and eng._pending.req is req:
                reused[req.rid] = eng._pending.reused_tokens
            return out
        setattr(eng, name, opening)
    chunks = []
    decode_chunk = eng._decode_chunk

    def timed(n):
        first = not chunks
        if first and before_first_decode is not None:
            before_first_decode(eng)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        out = decode_chunk(n)
        b.record()
        chunks.append((n, time.perf_counter() - t, (a, b), first))
        return out

    eng._decode_chunk = timed
    for r in reqs:
        eng.submit(r)
    first, last, done, arrivals = {}, {}, {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_steps = 0
    while eng.has_work:
        events, comps = eng.step()
        now = time.perf_counter()
        for rid, toks in events:
            if toks:
                first.setdefault(rid, now)
                last[rid] = now
                got = arrivals.setdefault(rid, [])
                if not got or got[-1] != now:  # one arrival a step
                    got.append(now)
        done.update({c.rid: c for c in comps})
        if n_steps == 0 and after_first_step is not None:
            after_first_step(eng)
        n_steps += 1
    wall = time.perf_counter() - t0
    for r in reqs:
        c = done[r.rid]
        assert len(c.tokens) == r.max_new_tokens, (r.rid, len(c.tokens))
        assert c.finish_reason == "length" and c.prompt_len == len(r.prompt)
    torch.cuda.synchronize()
    steady = [c for c in chunks if not c[3]]
    report = dict(
        policy=policy, backend=backend or "gather",
        layout="paged" if paged else "dense", capacity=capacity,
        graph=graph, wall_s=wall,
        decode_ms_per_step=sum(a.elapsed_time(b) for _, _, (a, b), _
                               in steady) / sum(n for n, *_ in steady),
        host_ms_per_step=sum(t for _, t, _, _ in steady) * 1e3
        / sum(n for n, *_ in steady),
        capture_s=eng._step_graph.capture_s if graph else None,
        ms_per_token={r.rid: (last[r.rid] - first[r.rid]) * 1e3
                      / max(r.max_new_tokens - 1, 1) for r in reqs},
        cache_bytes=sum(st.nbytes() for st in eng.cache["attn"]),
        admission=_admission_feel(reqs, started, first, arrivals),
        reused=reused, prefill_chunks=eng.n_prefill_chunks,
        reused_tokens=eng.n_reused_tokens)
    if paged:
        stats = eng.pool_stats()
        assert stats["pages_used"] == 0, "pages leaked"
        report.update(peak_pages=stats["peak_pages"],
                      preemptions=stats["preemptions"],
                      page_bytes=stats["pool_bytes"] / (stats["n_pages"] + 1),
                      reuse_hits=eng.n_reuse_hits_device,
                      reuse_misses=eng.n_reuse_misses)
    return eng, done, report


def _admission_feel(reqs, started, first, arrivals) -> dict:
    """For the longest prompt: its time to first token from the start of
    its admission, and the longest gap between two successive token
    events of any other stream that overlaps that window (host ms)."""
    big = max(reqs, key=lambda r: len(r.prompt)).rid
    lo, hi = started[big], first[big]
    gaps = [(b - a, rid) for rid, ts in arrivals.items() if rid != big
             for a, b in zip(ts, ts[1:]) if b > lo and a < hi]
    return dict(rid=big, ttft_ms=(hi - lo) * 1e3,
                longest_live_gap_ms=max(gaps)[0] * 1e3 if gaps else None,
                live_streams=len({rid for _, rid in gaps}))


def profile_batch_decode(model, params, policy, backend, paged, graph):
    """One decode chunk of the four ragged requests, all resident, under
    torch.profiler: wall ms per step (host clock, inflated by the
    profiler), device-busy ms per step, idle share, top kernels; then the
    same chunk again (the requests cancelled and admitted anew) without
    the profiler, timed by CUDA events, and the idle share against that
    time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.batch_engine import BatchEngine

    eng = BatchEngine(model, params, capacity=CAPACITY, s_max=S_MAX,
                      policy=policy, backend=backend, chunk=CHUNK,
                      paged=paged, page_size=PAGE_SIZE, device=DEV,
                      graph=graph)

    def admit():
        for r in batch_requests(model.cfg.vocab_size)[2:]:
            eng.submit(r)
        eng.step()  # admits all four and decodes one chunk
        torch.cuda.synchronize()

    admit()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        events, _ = eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / CHUNK
    assert len(events) == CAPACITY and eng.pending == 0
    eng.cancel_all()
    admit()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    eng.step()
    b.record()
    torch.cuda.synchronize()
    ev = a.elapsed_time(b) / CHUNK
    eng.cancel_all()
    us = _kernel_us(prof)
    busy = sum(us.values()) / 1e3 / CHUNK
    top = sorted(us.items(), key=lambda kv: -kv[1])[:10]
    return dict(policy=policy, backend=backend or "gather",
                layout="paged" if paged else "dense", rows=CAPACITY,
                graph=graph, wall_ms_per_step=wall,
                device_busy_ms_per_step=busy,
                idle_share=1 - busy / wall, events_ms_per_step=ev,
                idle_share_events=1 - busy / ev,
                top_kernels_ms_per_step=[(k[:60], v / 1e3 / CHUNK)
                                         for k, v in top],
                own_kernels_ms_per_step=_own_ms(us, CHUNK))


def forced_logits(model, params, policy, backend, prompt, toks, rots):
    """One request alone, teacher-forced on ``toks`` (eager, plain cache):
    (1, n, V) logits of every step, for the near-tie rule."""
    cache = model.init_cache(1, S_MAX, policy=policy, rots=rots)
    lg, cache = model.prefill(
        params, torch.as_tensor(prompt, device=DEV)[None].long(), cache)
    out = [lg[:, -1].float()]
    for t in toks[:-1]:
        lg, cache = model.decode_step(
            params, torch.tensor([[int(t)]], device=DEV), cache,
            backend=backend)
        out.append(lg[:, -1].float())
    return torch.stack(out, 1).cpu()


def _tie_check(ref, got, logits, what) -> int:
    n = _agree_until(torch.as_tensor(ref)[None], torch.as_tensor(got)[None],
                     logits)
    log(f"  {what}: tokens agree for {n}/{len(ref)} steps")
    return n


def batch_phase(model, params):
    """(a) paged vs dense, (b) batched vs alone, (c) COW refcounts, (d)
    preemption, (e) no page leaks, (f) graph vs eager.  Returns launches
    per kernel on the paged and dense int4 batch paths (graph runs)."""
    from repro_torch.launch.engine import Engine

    reqs = batch_requests(model.cfg.vocab_size)
    n_prefix_pages = SHARED_PREFIX // PAGE_SIZE
    sharer_b = 1  # the request that maps the first sharer's prefix pages

    def check_cow(eng):
        st = eng.pool_stats()
        slot_a = next(s for s, r in enumerate(eng._slot_req)
                      if r is not None and r.rid == 0)
        pages = eng._ptab_host[slot_a, :n_prefix_pages]
        rc = eng._refcount_host[pages]
        live = [r for r in eng._slot_req if r is not None]
        no_share = sum(eng._pages_needed(len(r.prompt), r.max_new_tokens)
                       for r in live)
        assert (rc == 2).all(), f"prefix refcounts {set(rc.tolist())} != 2"
        assert st["shared_pages"] == n_prefix_pages, st["shared_pages"]
        assert st["pages_used"] < no_share, (st["pages_used"], no_share)
        log(f"  COW: {n_prefix_pages} prefix pages at refcount 2, "
            f"{st['pages_used']} pages used vs {no_share} unshared")

    def graph_vs_eager(policy, backend, rqs, eager, graph, rots, what):
        """(f): every stream of the graph run equals the eager run's up to
        a near-tie of the request's own logits."""
        for r in rqs:
            t_e, t_g = eager[r.rid].tokens, graph[r.rid].tokens
            if not (t_e == t_g).all():
                _tie_check(t_e, t_g, forced_logits(
                    model, params, policy, backend, r.prompt, t_e, rots),
                    f"{what} request {r.rid} graph vs eager")
        log(f"  {what}: graph == eager for every request up to a near-tie")

    runs, launches, reports = {}, {}, {}
    for policy, backend in (("int4-srft", "kernel"), ("bf16", None)):
        for paged in (True, False):
            order = (True, False) if paged else (False, True)
            for graph in order:
                if graph and policy == "int4-srft":
                    _zero_counters()
                eng, done, rep = serve_batch(
                    model, params, policy, backend, paged, reqs,
                    after_first_step=check_cow if paged else None,
                    graph=graph)
                if graph and policy == "int4-srft":
                    launches["batch_paged" if paged else "batch_dense"] = \
                        _counters()
                runs[policy, paged, graph] = (eng, done)
                reports[policy, paged, graph] = rep
                log("batch " + json.dumps(rep))
            graph_vs_eager(policy, backend, reqs, runs[policy, paged, False][1],
                           runs[policy, paged, True][1],
                           runs[policy, paged, False][0]._rots,
                           f"{policy} {'paged' if paged else 'dense'}")
        (_, pag), (eng_d, den) = (runs[policy, True, True],
                                  runs[policy, False, True])
        for r in reqs:  # (a)
            if r.rid != sharer_b:
                assert (pag[r.rid].tokens == den[r.rid].tokens).all(), \
                    f"{policy}: paged != dense for request {r.rid}"
        _tie_check(den[sharer_b].tokens, pag[sharer_b].tokens, forced_logits(
            model, params, policy, backend, reqs[sharer_b].prompt,
            den[sharer_b].tokens, eng_d._rots), f"{policy} COW sharer")
        log(f"  {policy}: paged == dense for every request that maps no "
            f"shared page")
        for r in reqs:  # (b)
            cache = model.init_cache(1, S_MAX, policy=policy,
                                     rots=eng_d._rots, ragged=True)
            toks, lg, _ = Engine(model, backend=backend).generate(
                params, torch.as_tensor(r.prompt, device=DEV)[None].long(),
                cache, r.max_new_tokens, return_logits=True)
            _tie_check(toks[0].cpu(), den[r.rid].tokens, lg.cpu(),
                       f"{policy} request {r.rid} batched vs alone")
    paged_l, dense_l = launches["batch_paged"], launches["batch_dense"]
    assert paged_l["quant_decode_attention_paged"] > 0, paged_l
    assert paged_l["quant_decode_attention"] == 0, paged_l
    assert dense_l["quant_decode_attention"] > 0, dense_l
    log(f"batch-path launches (graph replays): paged {paged_l}, dense "
        f"{dense_l}")

    # (d) an undersized pool: one full row of pages, two rows' need
    small = [r for r in reqs if len(r.prompt) in (BATCH_PROMPTS[0],
                                                  BATCH_PROMPTS[-1])]
    pre = {}
    for graph in (True, False):
        eng, got, rep = serve_batch(model, params, "int4-srft", "kernel",
                                    True, small, capacity=2,
                                    n_pages=S_MAX // PAGE_SIZE + 1,
                                    graph=graph)
        log("batch " + json.dumps(rep))
        assert eng.n_preemptions > 0, "the undersized pool did not preempt"
        pre[graph] = got
    eng_d, den = runs["int4-srft", False, True]
    for r in small:
        _tie_check(den[r.rid].tokens, pre[True][r.rid].tokens, forced_logits(
            model, params, "int4-srft", "kernel", r.prompt,
            den[r.rid].tokens, eng_d._rots),
            f"preempted request {r.rid} vs dense")
    graph_vs_eager("int4-srft", "kernel", small, pre[False], pre[True],
                   eng_d._rots, "preempting pool")
    log(f"  preemption: {eng.n_preemptions} preemptions, every request "
        f"complete, no page left in use")
    mono = {(p, paged): (*runs[p, paged, True], reports[p, paged, True])
            for p in ("int4-srft", "bf16") for paged in (True, False)}
    for policy, backend, paged in (("int4-srft", "kernel", True),
                                   ("int4-srft", "kernel", False),
                                   ("bf16", None, True)):
        for graph in (False, True):
            log("batch decode profile " + json.dumps(profile_batch_decode(
                model, params, policy, backend, paged, graph)))
    return launches, mono, pre[True]


# ------------------------------------------------------ chunked admission

def chunked_phase(model, params, mono, pre_mono):
    """Phase 8: the batch requests through chunked admission (graph on),
    held to the monolithic runs of the same configuration (``mono``:
    (policy, paged) -> (engine, completions, report)) and the preempting
    pool to its monolithic run (``pre_mono``).  Returns launches per
    kernel on the paged and dense int4 chunked runs."""
    reqs = batch_requests(model.cfg.vocab_size)
    small = [r for r in reqs if len(r.prompt) in (BATCH_PROMPTS[0],
                                                  BATCH_PROMPTS[-1])]
    chunk_bytes_report(model, params)
    chunking = dict(prefill_chunk=PREFILL_CHUNK,
                    prefill_budget=PREFILL_BUDGET)
    launches, feel = {}, {}
    for policy, backend in (("int4-srft", "kernel"), ("bf16", None)):
        for paged in (True, False):
            int4 = policy == "int4-srft"
            if int4:
                _zero_counters()
            eng, got, rep = serve_batch(model, params, policy, backend,
                                        paged, reqs, **chunking)
            name = f"batch_chunked_{'paged' if paged else 'dense'}"
            if int4:
                launches[name] = _counters()
            log("batch chunked " + json.dumps(rep))
            eng_m, done_m, rep_m = mono[policy, paged]
            what = f"{policy} {'paged' if paged else 'dense'}"
            hits = eng.n_reuse_hits_device if paged else 0
            reusers = [rid for rid, n in rep["reused"].items() if n]
            for r in reqs:
                if r.rid in reusers and int4:
                    continue  # reads the dequantized prefix: see below
                _tie_check(done_m[r.rid].tokens, got[r.rid].tokens,
                           forced_logits(model, params, policy, backend,
                                         r.prompt, done_m[r.rid].tokens,
                                         eng_m._rots),
                           f"{what} request {r.rid} chunked vs monolithic")
            if paged:
                assert hits == 1 and eng.n_reused_tokens == SHARED_PREFIX, \
                    (hits, eng.n_reused_tokens)
                assert reusers == [1], rep["reused"]
            else:
                assert eng.n_reused_tokens == 0 and not reusers
            if int4:
                dq = launches[name]["srft_dequant"]
                assert dq == 2 * model.cfg.n_layers * hits, (dq, hits)
                assert launches[name]["srft_quant"] > 0
                read = ("quant_decode_attention_paged" if paged
                        else "quant_decode_attention")
                assert launches[name][read] > 0, launches[name]
            if int4 and paged:
                _, off, _ = serve_batch(model, params, policy, backend,
                                        paged, reqs, prefix_reuse=False,
                                        **chunking)
                for rid in reusers:
                    a, b = off[rid].tokens, got[rid].tokens
                    n_eq = int((a == b).sum())
                    lead = int((a != b).argmax()) if (a != b).any() \
                        else len(a)
                    log(f"[{CARD}] int4 reuse: request {rid} (its "
                        f"{SHARED_PREFIX}-token prefix read through B4) "
                        f"agrees with the no-reuse chunked run in "
                        f"{n_eq}/{len(a)} tokens, the first {lead} in a "
                        f"row (cache-consistent, not bit-exact)")
            feel[policy, paged] = (rep_m, rep)
            adm = eng.n_prefill_chunks
            n_adm = len(reqs)
            which = "but the int4 reuser" if int4 and paged else "request"
            log(f"[{CARD}] {what}: chunked == monolithic for every {which} "
                f"up to a near-tie; {adm} chunks for {n_adm} admissions "
                f"({adm / n_adm:.2f} per admission); reused tokens "
                f"{eng.n_reused_tokens}, hits {hits}, misses "
                f"{eng.n_reuse_misses if paged else 'n/a (dense)'}")
    for (policy, paged), (rm, rc) in feel.items():
        am, ac = rm["admission"], rc["admission"]
        log(f"[{CARD}] {policy} {'paged' if paged else 'dense'}: while the "
            f"{BATCH_PROMPTS[-1]}-token request is admitted, the longest gap "
            f"between two tokens of a live stream is "
            f"{_ms(am['longest_live_gap_ms'])} monolithic vs "
            f"{_ms(ac['longest_live_gap_ms'])} chunked "
            f"({am['live_streams']} / {ac['live_streams']} live streams); "
            f"its time to first token "
            f"{am['ttft_ms']:.1f} ms vs {ac['ttft_ms']:.1f} ms (host clock)")

    # the preempting pool, chunked (a budget that lets the long admission
    # end while the short stream decodes: PREEMPT_BUDGET)
    eng_d = mono["int4-srft", False][0]
    eng, got, rep = serve_batch(model, params, "int4-srft", "kernel", True,
                                small, capacity=2,
                                n_pages=S_MAX // PAGE_SIZE + 1,
                                prefill_chunk=PREFILL_CHUNK,
                                prefill_budget=PREEMPT_BUDGET)
    log("batch chunked " + json.dumps(rep))
    assert eng.n_preemptions > 0, "the undersized pool did not preempt"
    assert eng.n_reused_tokens == 0
    for r in small:
        _tie_check(pre_mono[r.rid].tokens, got[r.rid].tokens, forced_logits(
            model, params, "int4-srft", "kernel", r.prompt,
            pre_mono[r.rid].tokens, eng_d._rots),
            f"preempting pool request {r.rid} chunked vs monolithic")
    log(f"[{CARD}] preempting pool, chunked: {eng.n_preemptions} "
        f"preemptions, streams equal the monolithic pool's up to a "
        f"near-tie, no page left in use")
    return launches


def chunk_bytes_report(model, params):
    """Chunked (PREFILL_CHUNK) against monolithic prefill on the card, for
    each distinct prompt length of the batch requests, int4 KERNEL's
    cache, the same rotations: the code and scale bytes that differ, the
    first layer whose raw K differs, whether the last logits are equal,
    and layer 0's K and FFN-down products at the chunks' row counts (the
    last chunk's included) against the same rows of the whole prompt's
    (which operation differs); the host ms of each chunk (synchronized)
    against the monolithic prefill, at the longest prompt."""
    seen = set()
    for r in batch_requests(model.cfg.vocab_size):
        if len(r.prompt) not in seen:
            seen.add(len(r.prompt))
            times = _chunk_bytes_one(model, params, r.prompt)
    t_m, t_c = times
    t_c_sorted = sorted(t_c)
    log(f"[{CARD}] prefill host ms (synchronized) of the {max(seen)}-token "
        f"prompt: monolithic {t_m[0]:.1f}; chunks of {PREFILL_CHUNK}: median "
        f"{t_c_sorted[len(t_c) // 2]:.1f}, min {t_c_sorted[0]:.1f}, max "
        f"{t_c_sorted[-1]:.1f}, sum {sum(t_c):.1f} over {len(t_c)} chunks")


def _chunk_bytes_one(model, params, tokens):
    from repro_torch.models import common

    cfg = model.cfg
    prompt = torch.as_tensor(tokens, device=DEV).long()[None]
    n = prompt.shape[1]
    runs = {}
    for name, C in (("monolithic", n), ("chunked", PREFILL_CHUNK)):
        row = model.init_cache(1, S_MAX, policy="int4-srft", ragged=True)
        raw = [torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, n, cfg.head_dim),
                           dtype=torch.bfloat16, device=DEV) for _ in "kv"]
        times = []
        for lo in range(0, n, C):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, row, *raw = model.prefill_chunk(
                params, prompt[:, lo:lo + C], row, *raw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        runs[name] = (row, raw, times, logits)
    mono = model.init_cache(1, S_MAX, policy="int4-srft", ragged=True)
    mono_logits, _ = model.prefill(params, prompt, mono)
    (row_m, raw_m, t_m, lg_m), (row_c, raw_c, t_c, lg_c) = (
        runs["monolithic"], runs["chunked"])
    plen = n - n % 16
    diff = dict.fromkeys(("k_packed", "v_packed", "k_scales", "v_scales"), 0)
    total = dict.fromkeys(diff, 0)
    one_chunk_is_prefill = torch.equal(lg_m, mono_logits)
    for st_m, st_c, st_p in zip(row_m["attn"], row_c["attn"], mono["attn"]):
        for f in diff:
            a = getattr(st_m.data.kv, f)[:, :, :plen]
            diff[f] += int((a != getattr(st_c.data.kv, f)[:, :, :plen]).sum())
            total[f] += a.numel()
            one_chunk_is_prefill &= bool(torch.equal(
                a, getattr(st_p.data.kv, f)[:, :, :plen]))
    raw_diff = [int((raw_m[0][i] != raw_c[0][i]).sum())
                for i in range(cfg.n_layers)]
    first = next((i for i, d in enumerate(raw_diff) if d), None)
    # layer 0's products at the chunks' row counts against the same rows
    # at M = n: the K projection on the layer's real input, the FFN's down
    # projection on a random input of its shape
    p0 = params["blocks"][0]
    x = common.rmsnorm(p0["ln_attn"], model._embed(params, prompt),
                       eps=cfg.norm_eps)
    h = torch.randn((1, n, cfg.d_ff), generator=torch.Generator(
        device=DEV).manual_seed(SEED), device=DEV).to(torch.bfloat16)
    gemm_diff = {}
    for name, w, inp in (("K projection", p0["attn"]["wk"], x),
                         ("FFN down projection", p0["ffn"]["w_down"], h)):
        whole = common.dense(w, inp)
        parts = torch.cat([common.dense(w, inp[:, lo:lo + PREFILL_CHUNK])
                           for lo in range(0, n, PREFILL_CHUNK)], dim=1)
        gemm_diff[name] = f"{int((whole != parts).sum())} of {whole.numel()}"
    lg_diff = (lg_c - lg_m).abs().max().item()
    log(f"[{CARD}] chunked ({PREFILL_CHUNK}, last chunk {n % PREFILL_CHUNK} "
        f"tokens) vs monolithic prefill of a {n}-token prompt, int4 cache "
        f"over {cfg.n_layers} layers: codes differ in {diff['k_packed']} of "
        f"{total['k_packed']} K bytes and {diff['v_packed']} of "
        f"{total['v_packed']} V bytes, scales in {diff['k_scales']} + "
        f"{diff['v_scales']} of {total['k_scales']} + {total['v_scales']}; "
        f"raw K first differs in layer {first} (elements differing by "
        f"layer: {raw_diff}); last logits max diff {lg_diff:.3e}; layer 0's "
        f"products at the chunks' row counts vs the same rows at M = {n}, "
        f"elements differing: {gemm_diff}; one {n}-token chunk == "
        f"LM.prefill (bytes and logits): {one_chunk_is_prefill}")
    assert one_chunk_is_prefill, "a one-chunk prefill_chunk != LM.prefill"
    return t_m, t_c


def _ms(x) -> str:
    return "n/a" if x is None else f"{x:.1f} ms"


# ------------------------------------------------- speculative decoding

def spec_prompts(vocab):
    """The 2055-token request of phase 5 (``serve``'s prompt) and a
    repetitive one of the same length: a SPEC_BASE-token random base,
    tiled, so that the prompt-lookup drafter hits."""
    n = SPEC_PROMPT
    g = torch.Generator(device="cuda").manual_seed(SEED + n)
    rand = torch.randint(0, vocab, (1, n), generator=g, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    base = torch.randint(0, vocab, (1, SPEC_BASE), generator=g,
                         device="cuda")
    rep = base.repeat(1, -(-n // SPEC_BASE))[:, :n]
    return {"random": rand, "repetitive": rep}


def plain_stream(model, params, policy, backend, prompt, n_new):
    """One greedy request through ``Engine``'s graph: (tokens (1, n_new),
    logits (1, n_new, V), ms per token by CUDA events over the n_new - 2
    steps after the one that captures)."""
    from repro_torch.launch.engine import Engine

    cache = model.init_cache(1, S_MAX, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend=backend)
    lg, cache = eng.prefill(params, prompt, cache)
    tok0 = lg[:, -1].argmax(-1)[:, None]
    tok1, l1, cache = eng.decode(params, tok0, cache, 1, return_logits=True)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    a.record()
    rest, lr, cache = eng.decode(params, tok1, cache, n_new - 2,
                                 return_logits=True)
    b.record()
    torch.cuda.synchronize()
    toks = torch.cat([tok0, tok1, rest], 1).cpu()
    logits = torch.cat([lg[:, -1:].float(), l1, lr], 1).cpu()
    return toks, logits, a.elapsed_time(b) / (n_new - 2)


def spec_stream(model, params, policy, backend, prompt, n_new, *,
                graph=True, profile=False):
    """One greedy request through ``Engine.generate_spec``'s pieces, k =
    SPEC_K: prefill, a first ``decode_spec`` of one token (under a graph
    it captures the pass), then the other n_new - 2 tokens timed by CUDA
    events with the kernels' counters zeroed just before and read just
    after.  Returns (tokens (1, n_new), report)."""
    from repro_torch.launch.engine import SPEC_KEY, Engine

    k = SPEC_K
    cache = model.init_cache(1, S_MAX, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend=backend, graph=graph)
    lg, cache = eng.prefill(params, prompt, cache)
    tok0 = lg[:, -1].argmax(-1)[:, None]
    tok1, cache, st1 = eng.decode_spec(params, tok0, cache, 1,
                                       prompt=prompt, spec_k=k)
    hist = torch.cat([prompt, tok0], 1)
    _zero_counters()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    t0 = time.perf_counter()
    a.record()
    rest, cache, st = eng.decode_spec(params, tok1, cache, n_new - 2,
                                      prompt=hist, spec_k=k)
    b.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = _counters()
    toks = torch.cat([tok0, tok1, rest], 1).cpu()
    assert toks.shape == (1, n_new)
    n = n_new - 2
    L = model.cfg.n_layers
    pos = int(cache["pos"][0])
    assert pos == prompt.shape[1] + n_new - 1, pos
    assert all(int(c.length[0]) == pos for c in cache["attn"])
    drafted, accepted = st1["drafted"] + st["drafted"], \
        st1["accepted"] + st["accepted"]
    assert 0 <= accepted <= drafted, (accepted, drafted)
    int4 = policy == "int4-srft"
    passes = st["passes"]  # verify passes of the timed call, spent ones too
    ms = a.elapsed_time(b)
    rep = dict(policy=policy, backend=backend or "gather", graph=graph,
               prompt=prompt.shape[1], new=n_new, spec_k=k,
               ms_per_token=ms / n, host_ms_per_token=host_s * 1e3 / n,
               passes=passes, ms_per_pass=ms / max(passes, 1),
               tokens_per_pass=n / max(passes, 1),
               drafted=drafted, accepted=accepted,
               acceptance=accepted / max(drafted, 1), launches=counts)
    if graph:
        cap = cache[SPEC_KEY]
        rep["capture_s"] = cap.step.capture_s
        rep["per_pass_launches"] = cap.step.counts
        if int4:
            assert cap.step.counts == (0, 0, 2 * L * k, 0), cap.step.counts
    # B3 quantizes the ring at each of a pass's k appends, K and V, every
    # layer; the verify read launches no B1 / B2
    if int4:
        assert counts["srft_quant"] == passes * 2 * L * k, (counts, passes)
    assert counts["quant_decode_attention"] == 0, counts
    assert counts["quant_decode_attention_paged"] == 0, counts
    if profile:
        rep.update(profile_spec(eng, params, cache, toks, prompt))
    return toks, rep, (eng, cache)


def profile_spec(eng, params, cache, toks, prompt, n=SPEC_PROFILE_TOKENS):
    """``n`` more tokens of a captured speculative request under
    torch.profiler (device-busy ms a pass, the kernels that take the
    most), then ``n`` again timed by CUDA events: the idle share of the
    card, per verify pass (the two calls may run different numbers of
    passes)."""
    from torch.profiler import ProfilerActivity, profile

    k = SPEC_K
    hist = torch.cat([prompt, toks[:, :-1].cuda()], 1)
    tok = toks[:, -1:].cuda()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, cache, st = eng.decode_spec(params, tok, cache, n, prompt=hist,
                                         spec_k=k)
        torch.cuda.synchronize()
    hist = torch.cat([hist, tok, out[:, :-1]], 1)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    a.record()
    _, _, st2 = eng.decode_spec(params, out[:, -1:], cache, n, prompt=hist,
                                spec_k=k)
    b.record()
    torch.cuda.synchronize()
    ev = a.elapsed_time(b) / st2["passes"]
    us = _kernel_us(prof)
    busy = sum(us.values()) / 1e3 / st["passes"]
    top = sorted(us.items(), key=lambda kv: -kv[1])[:8]
    return dict(profile_busy_ms_per_pass=busy, events_ms_per_pass=ev,
                idle_share=1 - busy / ev,
                top_kernels_ms_per_pass=[(name[:60], t / 1e3 / st["passes"])
                                         for name, t in top])


def spec_no_sync(model, params, prompt, n=16):
    """The captured pass replayed ceil(n / k) times inside
    ``set_sync_debug_mode("error")``, its buffers seeded before: the
    replay loop between two readbacks makes no host sync."""
    from repro_torch.launch.engine import SPEC_KEY, Engine

    k = SPEC_K
    cache = model.init_cache(1, S_MAX, policy="int4-srft", ragged=True,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend="kernel")
    lg, cache = eng.prefill(params, prompt, cache)
    tok0 = lg[:, -1].argmax(-1)[:, None]
    tok1, cache, _ = eng.decode_spec(params, tok0, cache, 1, prompt=prompt,
                                     spec_k=k)
    cap = cache[SPEC_KEY]
    cap.buf.seed(torch.cat([prompt, tok0], 1), tok1, n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(-(-n // k)):
            cap.step.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    done = n - int(cap.buf.budget)
    assert 0 < done <= n, done
    log(f"no host sync: {-(-n // k)} replays of the captured speculative "
        f"pass under set_sync_debug_mode('error') ({done} tokens)")


# the recorded outputs of one block, in call order (_Taps)
BLOCK_OPS = ("ln_attn", "wq", "wk", "wv", "rope q", "rope k", "attention read",
             "wo", "ln_ffn", "w_gate", "w_up", "w_down")


class _Taps:
    """While the block runs, record in call order the output of every
    norm, projection, RoPE, attention read (decode's and verify's) and
    the unembedding: ``len(BLOCK_OPS)`` a layer, then the final norm and
    the unembedding.  ``out`` holds (axis of the tokens, output)."""

    def __init__(self, model, policy):
        from repro_torch.models import common
        from repro_torch.models.lm import LM

        pol = type(model.cache_policy(policy))
        self.hooks = [(common, "rmsnorm", 1), (common, "dense", 1),
                      (common, "apply_rope", 2), (pol, "attend", 2),
                      (pol, "verify_attend", 2), (LM, "_unembed", 1)]
        self.n_layers = model.cfg.n_layers
        self.out = []

    def __enter__(self):
        self.saved = [(o, n, getattr(o, n)) for o, n, _ in self.hooks]
        for (owner, name, axis), (_, _, fn) in zip(self.hooks, self.saved):
            def wrapped(*a, _fn=fn, _axis=axis, **kw):
                y = _fn(*a, **kw)
                self.out.append((_axis, y.detach().clone()))
                return y
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False

    def first_diff(self, rows, steps) -> list:
        """(layer, op, elements) of each recorded output of ``rows`` (one
        call over several tokens: (outputs, token index) per position)
        that differs from ``steps`` (one call per position), in order."""
        per = len(BLOCK_OPS)
        diffs = []
        for n in range(len(steps[0])):
            bad = sum(int((outs[n][1].narrow(outs[n][0], j, 1)
                           != st[n][1]).sum())
                      for (outs, j), st in zip(rows, steps))
            if bad:
                if n < per * self.n_layers:
                    where = (n // per, BLOCK_OPS[n % per])
                else:
                    where = ("final", "ln_final" if n == per * self.n_layers
                             else "unembed")
                diffs.append((*where, bad))
        return diffs


def _prefilled(model, params, prompt, policy, rows=1, s_max=S_MAX):
    cache = model.init_cache(rows, s_max, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(SEED))
    lg, cache = model.prefill(params, prompt, cache)
    return cache, lg[:, -1].argmax(-1)[:, None]


def spec_op_report(model, params, prompt, toks, policy) -> None:
    """The first operation of a ``BatchEngine`` verify pass whose output
    differs from the sequential steps', on the card: the same prefilled
    ragged cache of CAPACITY rows twice (the prompt's tokens shifted by
    the row), one ``LM.decode_verify`` of the block ``toks[:, :k]`` (the
    plain stream's own tokens) against k ``decode_step`` calls, every
    recorded output (``_Taps``) compared token by token (layer, op,
    elements that differ).  ``spec_trace_report`` does this for the
    single stream over a whole request."""
    k, rows = SPEC_K, CAPACITY
    shift = torch.arange(rows, device=prompt.device)[:, None]
    prompt = (prompt + shift) % model.cfg.vocab_size
    block = (toks[:, :k].to(prompt.device) + shift) % model.cfg.vocab_size
    s_max = prompt.shape[1] + 2 * k
    with _Taps(model, policy) as taps:
        cache, _ = _prefilled(model, params, prompt, policy, rows, s_max)
        taps.out.clear()
        model.decode_verify(params, block, cache)
        ver = list(taps.out)
        cache, _ = _prefilled(model, params, prompt, policy, rows, s_max)
        steps = []
        for j in range(k):
            taps.out.clear()
            model.decode_step(params, block[:, j:j + 1], cache)
            steps.append(list(taps.out))
    diffs = taps.first_diff([(ver, j) for j in range(k)], steps)
    log(f"[{CARD}] {policy}, {rows} row(s): verify pass vs {k} sequential "
        f"steps on the {prompt.shape[1]}-token random prompt's cache, op by "
        f"op ({len(ver)} recorded outputs): "
        + (f"first differing op: layer {diffs[0][0]} {diffs[0][1]} "
           f"({diffs[0][2]} elements); {len(diffs)} ops differ"
           if diffs else "every output equal bit for bit"))


def spec_trace_report(model, params, prompt, policy, n_new) -> None:
    """Where a speculative stream first computes something else than the
    plain one: both decoded eagerly (GATHER) from the same prefilled
    cache, every output recorded (``_Taps``); each position's kept verify
    row (the last pass that covered it) against the plain step at that
    position, in order: the first position and op that differ; and the
    first position whose cache bytes (int4 codes and scales, or bf16 K/V)
    differ in any layer, below the first differing token."""
    from repro_torch.launch.engine import Engine
    from repro_torch.models.lm import LM

    S = prompt.shape[1]
    with _Taps(model, policy) as taps:
        cache_p, tok = _prefilled(model, params, prompt, policy)
        plain, toks_p = {}, []
        for t in range(n_new):
            taps.out.clear()
            lg, cache_p = model.decode_step(params, tok, cache_p)
            plain[S + t] = list(taps.out)
            tok = lg[:, -1].argmax(-1)[:, None]
            toks_p.append(int(tok))
        cache_s, tok0 = _prefilled(model, params, prompt, policy)
        kept, verify = {}, LM.decode_verify

        def noted(self_, params_, tokens, cache, **kw):
            L0 = int(cache["pos"][0])
            taps.out.clear()
            out = verify(self_, params_, tokens, cache, **kw)
            outs = list(taps.out)
            for j in range(tokens.shape[1]):
                kept[L0 + j] = (outs, j)  # a later pass recomputes it
            return out

        LM.decode_verify = noted
        try:
            toks_s, _, _ = Engine(model, graph=False).decode_spec(
                params, tok0, cache_s, n_new, prompt=prompt, spec_k=SPEC_K)
        finally:
            LM.decode_verify = verify
    toks_s = toks_s[0].tolist()
    t_div = _first_diff(torch.tensor(toks_p), torch.tensor(toks_s))
    first = None
    for p in range(S, S + n_new):
        diffs = taps.first_diff([kept[p]], [plain[p]])
        if diffs:
            first = (p - S, *diffs[0])
            break
    byte_pos = None
    for st_p, st_s in zip(cache_p["attn"], cache_s["attn"]):
        a = getattr(st_p.data, "kv", st_p.data)
        b = getattr(st_s.data, "kv", st_s.data)
        n = S + t_div  # positions written before the streams part
        leaves = (("k_packed", "k_scales", "v_packed", "v_scales")
                  if hasattr(a, "k_packed") else ("k", "v"))
        if hasattr(a, "k_packed"):
            n -= n % a.window
        for f in leaves:
            d = (getattr(a, f)[0, :, :n] != getattr(b, f)[0, :, :n])
            hit = d.reshape(d.shape[0], n, -1).any(-1).any(0).nonzero()
            if len(hit):
                q = int(hit[0])
                byte_pos = q if byte_pos is None else min(byte_pos, q)
    log(f"[{CARD}] {policy}, {n_new} tokens of the {S}-token random prompt, "
        f"eager: speculative vs plain tokens first differ at token "
        f"{t_div}; first differing recorded output: "
        + ("none" if first is None else
           f"token {first[0]}, layer {first[1]} {first[2]} ({first[3]} "
           f"elements)")
        + "; first cache position whose bytes differ below that token: "
        + ("none" if byte_pos is None else f"{byte_pos - S} past the prompt"))


def _first_diff(a, b) -> int:
    d = (a != b).nonzero()
    return int(d[0]) if len(d) else len(a)


def spec_phase(model, params, mono, pre_mono):
    """Speculative decoding on the card (ROADMAP A5): ``Engine`` at batch 1
    and ``BatchEngine`` (see the module doc, phase 10).  Returns launches
    per kernel on its paths."""
    from repro_torch.core import cache_api

    vocab = model.cfg.vocab_size
    L = model.cfg.n_layers
    prompts = spec_prompts(vocab)
    launches, rows = {}, []
    streams = []  # (what, first differing step or None)
    cache_api._KERNEL_VERIFY_WARNED = False
    for name, prompt in prompts.items():
        plain = {}
        for policy, backend in (("int4-srft", "kernel"),
                                ("int4-srft", "gather"), ("bf16", None)):
            plain[policy, backend] = plain_stream(model, params, policy,
                                                  backend, prompt,
                                                  NEW_TOKENS)
        if name == "random":
            spec_op_report(model, params, prompt,
                           plain["int4-srft", "gather"][0], "int4-srft")
            spec_trace_report(model, params, prompt, "int4-srft",
                              SPEC_TRACE_TOKENS)
        for policy, backend in (("int4-srft", "kernel"), ("bf16", None)):
            toks, rep, _ = spec_stream(model, params, policy, backend,
                                       prompt, NEW_TOKENS,
                                       profile=name == "random")
            if policy == "int4-srft":
                launches[f"spec_engine_{name}"] = rep["launches"]
            refs = ((("int4-srft", "gather"), ("int4-srft", "kernel"))
                    if policy == "int4-srft" else (("bf16", None),))
            for ref in refs:
                t_p, l_p, ms_p = plain[ref]
                what = (f"{name} prompt, {policy} spec (GATHER verify) vs "
                        f"plain {(ref[1] or 'gather').upper()}")
                n_eq = _first_diff(t_p[0], toks[0])
                _tie_check(t_p[0], toks[0], l_p, what)
                streams.append((what, n_eq if n_eq < NEW_TOKENS else None))
                log(f"[{CARD}] {what}: {n_eq} of {NEW_TOKENS} tokens "
                    f"bit-equal before the first difference")
                rep[f"plain_{(ref[1] or 'gather')}_ms_per_token"] = ms_p
                rep[f"bit_equal_prefix_vs_{ref[1] or 'gather'}"] = n_eq
            rep["prompt_kind"] = name
            rows.append(rep)
            log("spec " + json.dumps(rep))

    # graph == eager, bit for bit, on the repetitive prompt
    for policy, backend in (("int4-srft", "kernel"), ("bf16", None)):
        t_g, rep_g, _ = spec_stream(model, params, policy, backend,
                                    prompts["repetitive"], SPEC_EAGER_NEW)
        t_e, rep_e, _ = spec_stream(model, params, policy, backend,
                                    prompts["repetitive"], SPEC_EAGER_NEW,
                                    graph=False)
        assert torch.equal(t_g, t_e), f"{policy}: graph spec != eager spec"
        assert (rep_g["drafted"], rep_g["accepted"]) == \
            (rep_e["drafted"], rep_e["accepted"]), (rep_g, rep_e)
        log(f"[{CARD}] {policy} spec, repetitive prompt: graph == eager for "
            f"{SPEC_EAGER_NEW}/{SPEC_EAGER_NEW} tokens; ms per verify pass "
            f"{rep_g['ms_per_pass']:.2f} graph vs {rep_e['ms_per_pass']:.2f} "
            f"eager; ms per token {rep_g['ms_per_token']:.2f} vs "
            f"{rep_e['ms_per_token']:.2f}")
    spec_no_sync(model, params, prompts["repetitive"])

    # BatchEngine: the batch requests and the preempting pool, spec_k 4
    reqs = batch_requests(vocab)
    small = [r for r in reqs if len(r.prompt) in (BATCH_PROMPTS[0],
                                                  BATCH_PROMPTS[-1])]

    def check_slack(eng):
        for s, r in enumerate(eng._slot_req):
            if r is None or eng._pending is not None \
                    and eng._pending.slot == s:
                continue
            want = -(-(len(r.prompt) + r.max_new_tokens + SPEC_K - 1)
                     // PAGE_SIZE)
            mapped = int((eng._ptab_host[s] != 0).sum())
            assert mapped == want, (r.rid, mapped, want)

    forced = {}  # the plain run's teacher-forced logits, by request

    for policy, backend, paged in SPEC_BATCH_RUNS:
        int4 = policy == "int4-srft"
        _zero_counters()
        eng, got, rep = serve_batch(
            model, params, policy, backend, paged, reqs, spec_k=SPEC_K,
            after_first_step=check_slack if paged else None)
        layout = "paged" if paged else "dense"
        if int4:
            launches[f"spec_batch_{layout}"] = _counters()
            assert _counters()["quant_decode_attention"] == 0
            assert _counters()["quant_decode_attention_paged"] == 0
            assert eng._step_graph.counts == (0, 0, 2 * L * SPEC_K, 0)
        eng_m, done_m, rep_m = mono[policy, paged]
        eq = []
        for r in reqs:
            a, b = done_m[r.rid].tokens, got[r.rid].tokens
            assert got[r.rid].finish_reason == done_m[r.rid].finish_reason
            eq.append(_first_diff(torch.as_tensor(a), torch.as_tensor(b)))
            streams.append((f"batch {policy} {layout} request {r.rid}",
                            eq[-1] if eq[-1] < len(a) else None))
            if not (a == b).all():
                key = (policy, r.rid, a.tobytes())
                if key not in forced:
                    forced[key] = forced_logits(model, params, policy,
                                                backend, r.prompt, a,
                                                eng_m._rots)
                _tie_check(a, b, forced[key],
                           f"{policy} {layout} request {r.rid} spec vs plain")
        rep.update(n_drafted=eng.n_drafted, n_accepted=eng.n_accepted,
                   acceptance=eng.n_accepted / max(eng.n_drafted, 1),
                   plain_decode_ms_per_step=rep_m["decode_ms_per_step"],
                   bit_equal_prefix=eq, spec_k=SPEC_K)
        log("batch spec " + json.dumps(rep, default=str))
        log(f"[{CARD}] BatchEngine {policy} {layout} spec_k {SPEC_K}: every "
            f"stream and finish reason equals the plain run's up to a "
            f"near-tie (bit-equal prefixes {eq} of "
            f"{[r.max_new_tokens for r in reqs]}); acceptance "
            f"{rep['acceptance']:.3f}; ms per verify pass "
            f"{rep['decode_ms_per_step']:.2f} vs plain ms per step "
            f"{rep_m['decode_ms_per_step']:.2f}"
            + ("; no page leaked, every row mapped its spec_k-1 slack"
               if paged else ""))
    eng_d = mono["int4-srft", False][0]
    eng, got, rep = serve_batch(model, params, "int4-srft", "kernel", True,
                                small, capacity=2,
                                n_pages=S_MAX // PAGE_SIZE + 1,
                                spec_k=SPEC_K)
    log("batch spec " + json.dumps(rep, default=str))
    assert eng.n_preemptions > 0, "the undersized pool did not preempt"
    for r in small:
        _tie_check(pre_mono[r.rid].tokens, got[r.rid].tokens, forced_logits(
            model, params, "int4-srft", "kernel", r.prompt,
            pre_mono[r.rid].tokens, eng_d._rots),
            f"preempting pool request {r.rid} spec vs plain")
    for r in small:
        n_eq = _first_diff(torch.as_tensor(pre_mono[r.rid].tokens),
                           torch.as_tensor(got[r.rid].tokens))
        streams.append((f"preempting pool request {r.rid}",
                        n_eq if n_eq < r.max_new_tokens else None))
    div = [(w, i) for w, i in streams if i is not None]
    log(f"[{CARD}] spec vs plain: {len(div)} of {len(streams)} streams "
        f"diverge, each at a near-tie (first differing step): "
        + json.dumps(dict(div)))
    log(f"[{CARD}] preempting pool, spec_k {SPEC_K}: {eng.n_preemptions} "
        f"preemptions, streams equal the plain pool's up to a near-tie, no "
        f"page left in use")
    summary = {f"{r['prompt_kind']}/{r['policy']}": dict(
        spec_ms_per_token=round(r["ms_per_token"], 3),
        plain_ms_per_token={k.split("_")[1]: round(v, 3)
                            for k, v in r.items()
                            if k.startswith("plain_")},
        acceptance=round(r["acceptance"], 3),
        tokens_per_pass=round(r["tokens_per_pass"], 3),
        ms_per_pass=round(r["ms_per_pass"], 3),
        capture_s=round(r["capture_s"], 3),
        idle_share=r.get("idle_share")) for r in rows}
    log(f"[{CARD}] Engine spec_k {SPEC_K} at {SPEC_PROMPT} tokens, "
        f"{NEW_TOKENS} new (ms by CUDA events, graph): "
        + json.dumps(summary))
    return launches


# ---------------------------------------------------- host prefix tier

def tier_engine(model, params, policy, backend, **kw):
    """A paged chunked ``BatchEngine`` (graph on) that records when each
    admission opens (``t_open``) and the host ms of each retire-time
    spill (``t_spill``) and host restore (``t_restore``), the device
    synchronized on both sides of each."""
    from repro_torch.launch.batch_engine import BatchEngine

    eng = BatchEngine(model, params, capacity=CAPACITY, s_max=S_MAX,
                      policy=policy, backend=backend, chunk=CHUNK,
                      paged=True, page_size=PAGE_SIZE, device=DEV,
                      prefill_chunk=PREFILL_CHUNK,
                      prefill_budget=PREFILL_BUDGET, **kw)
    eng.t_open, eng.t_spill, eng.t_restore, eng.adm_logits = {}, [], [], {}
    start, finalize = eng._start_pending, eng._finalize_pending

    def opening(req, slot):
        eng.t_open[req.rid] = time.perf_counter()
        return start(req, slot)

    def finalizing(*a):
        pend = eng._pending
        eng.adm_logits[pend.req.rid] = pend.logits.float().cpu()
        return finalize(*a)

    eng._start_pending, eng._finalize_pending = opening, finalizing
    for name, out in (("_spill", eng.t_spill), ("_restore", eng.t_restore)):
        def timed(*a, _fn=getattr(eng, name), _out=out):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = _fn(*a)
            torch.cuda.synchronize()
            _out.append((time.perf_counter() - t) * 1e3)
            return r
        setattr(eng, name, timed)
    return eng


def tier_serve(eng, reqs):
    """Run ``reqs`` to the end: (completions by rid, time to first token
    by rid, host ms from the admission's opening to the step that
    streams its first token)."""
    from repro_torch.launch.batch_engine import Request

    for rid, prompt in reqs:
        eng.submit(Request(rid, prompt, OFFLOAD_NEW))
    first, done = {}, {}
    while eng.has_work:
        events, comps = eng.step()
        now = time.perf_counter()
        for rid, toks in events:
            if toks:
                first.setdefault(rid, now)
        done.update({c.rid: c for c in comps})
    for rid, _ in reqs:
        assert len(done[rid].tokens) == OFFLOAD_NEW, rid
        assert done[rid].finish_reason == "length", rid
    assert eng.pool_stats()["pages_used"] == 0, "pages leaked"
    for st in eng.cache["attn"]:
        rc = getattr(st.data, "kv", st.data).pool.refcount
        assert int(rc[0]) == 1 and not rc[1:].any(), "a refcount leaked"
    return done, {rid: (first[rid] - eng.t_open[rid]) * 1e3
                  for rid, _ in reqs}


def tier_case(model, params, policy, backend, prompt, case, **kw):
    """One re-admission of ``prompt`` (rid 1) after a donor (rid 0):
    "host" (the donor retires and spills, rid 1 restores; ``kw`` sizes the
    tier); "device" (a donor that shares exactly the pages a restore
    brings back, the prompt's first 128 x 16 tokens, stays resident: a
    COW hit of the same depth, so the admission computes what the
    restore's computes); "same" (the donor is the same prompt, resident:
    the reference's form, deeper where W = 1); "cold" (no tier: the donor
    retires, rid 1 is chunked from nothing).  Returns (engine, rid 1's
    completion, its time to first token ms, the B1-B4 counters of rid
    1's run when ``count``)."""
    count = kw.pop("count", False)
    eng = tier_engine(model, params, policy, backend, **kw)
    if case in ("device", "same"):
        # a short request first: the step graph is captured before the
        # donor and rid 1 are admitted together (its capture would fall
        # in rid 1's first step, as it falls in the donor's in the other
        # cases)
        tier_serve(eng, [(2, (prompt[:2 * PAGE_SIZE + 1] + 7)
                          % model.cfg.vocab_size)])
        donor = prompt.copy()
        n_tok = (len(prompt) - 1) // PAGE_SIZE * PAGE_SIZE
        if case == "device":
            donor[n_tok:] = (donor[n_tok:] + 1) % model.cfg.vocab_size
        done, ttft = tier_serve(eng, [(0, donor), (1, prompt)])
        assert eng.n_reuse_hits_device == 1, eng.n_reuse_hits_device
        if case == "device":
            assert eng.n_reused_tokens == n_tok, eng.n_reused_tokens
        return eng, done[1], ttft[1], None
    tier_serve(eng, [(0, prompt)])
    if count:
        _zero_counters()
    done, ttft = tier_serve(eng, [(1, prompt)])
    launches = _counters() if count else None
    if case == "cold":
        assert eng.n_reuse_misses == 2 and eng.n_reused_tokens == 0
    return eng, done[1], ttft[1], launches


def copy_ms(eng, prompt, n_pages):
    """The spill's and the restore's copies alone, host clock,
    synchronized: the export of ``n_pages`` pool pages from every layer
    (a gather and one device-to-host copy per leaf and layer), the host
    tier's payloads of ``prompt``'s first ``n_pages`` pages stacked per
    leaf (the host's memcpy), and their copy to the card (one per leaf).
    Returns (export ms, stack ms, host-to-device ms, bytes)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for st in eng.cache["attn"]:
        eng.policy.export_pages(st, range(1, n_pages + 1))
    export = (time.perf_counter() - t) * 1e3
    payloads = [eng.prefix_store.get(prompt[:(i + 1) * PAGE_SIZE].tobytes())
                for i in range(n_pages)]
    t0 = time.perf_counter()
    stacked = [torch.stack([pl[j] for pl in payloads], dim=1)
               for j in range(len(payloads[0]))]
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    on_card = [t.to(DEV) for t in stacked]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    nbytes = sum(t.numel() * t.element_size() for t in on_card)
    return export, (t1 - t0) * 1e3, (t2 - t1) * 1e3, nbytes


def last_chunk_report(model, params, prompt, eng_h, eng_s, policy):
    """Where a restore and a device hit on the same prompt part under a
    W = 1 policy (bf16, int8): the hit shares every prompt token but the
    last and computes a 1-row chunk, the restore shares whole pages and
    computes the rest as one chunk; under int8 the hit also reads the
    tokens past the pages dequantized, where the restore's chunk reads
    them raw.  Logs whether the two admissions' last logits are equal and
    layer 0's products of the last token at the two row counts (the K
    projection on the layer's real input, the FFN's down projection on a
    random input of its shape)."""
    from repro_torch.models import common

    cfg = model.cfg
    n_h = len(prompt) - eng_h.n_restored_tokens
    toks = torch.as_tensor(prompt, device=DEV).long()[None, -n_h:]
    p0 = params["blocks"][0]
    x = common.rmsnorm(p0["ln_attn"], model._embed(params, toks),
                       eps=cfg.norm_eps)
    h = torch.randn((1, n_h, cfg.d_ff), generator=torch.Generator(
        device=DEV).manual_seed(SEED), device=DEV).to(torch.bfloat16)
    diff = {}
    for name, w, inp in (("K projection", p0["attn"]["wk"], x),
                         ("FFN down projection", p0["ffn"]["w_down"], h)):
        diff[name] = int((common.dense(w, inp)[:, -1:]
                          != common.dense(w, inp[:, -1:])).sum())
    lg_h, lg_s = eng_h.adm_logits[1], eng_s.adm_logits[1]
    log(f"[{CARD}] {policy}, the same prompt resident: the device hit "
        f"reuses {eng_s.n_reused_tokens} tokens and computes a 1-row chunk, "
        f"the restore {eng_h.n_restored_tokens} and a {n_h}-row chunk; the "
        f"admissions' last logits equal: {torch.equal(lg_h, lg_s)} (max "
        f"diff {(lg_h - lg_s).abs().max().item():.3e}); layer 0's products "
        f"of the last token at {n_h} rows vs 1, elements differing: {diff}")


def offload_phase(model, params):
    """Phase 11: the host prefix tier and the int8-per-token policy (see
    the module doc).  Returns launches per kernel on the int4 restore."""
    from repro_torch.examples import quickstart
    from repro_torch.models import common

    prompt = offload_prompt(model.cfg.vocab_size)
    n_pages = (OFFLOAD_PROMPT - 1) // PAGE_SIZE
    n_tok = n_pages * PAGE_SIZE
    L = model.cfg.n_layers
    feel = {}  # (policy, case) -> [ttft ms per round]
    spill, restore, copy = {}, {}, {}
    launches = {}
    ram_stream = {}
    for r in range(OFFLOAD_ROUNDS):
        order = OFFLOAD_RUNS if r % 2 == 0 else OFFLOAD_RUNS[::-1]
        for i, (policy, backend) in enumerate(order):
            cases = ("host", "device", "cold")
            cases = cases[(r + i) % 3:] + cases[:(r + i) % 3]
            got = {}
            for case in cases:
                kw = dict(offload_bytes=OFFLOAD_BYTES) if case == "host" \
                    else {}
                count = case == "host" and r == 0 and policy == "int4-srft"
                eng, comp, ttft, cnt = tier_case(
                    model, params, policy, backend, prompt, case,
                    count=count, **kw)
                feel.setdefault((policy, case), []).append(ttft)
                got[case] = (eng, comp)
                if case == "host":  # the donor's spill, rid 1's restore
                    spill.setdefault(policy, []).append(eng.t_spill[0])
                    restore.setdefault(policy, []).append(eng.t_restore[0])
                    stats = eng.pool_stats()
                    page_bytes = stats["pool_bytes"] // (stats["n_pages"] + 1)
                    st = stats["offload"]["store"]
                    assert eng.n_spilled_pages == n_pages, eng.n_spilled_pages
                    assert st["ram_bytes"] == n_pages * page_bytes, st
                    assert eng.n_reuse_hits_host == 1
                    assert eng.n_restored_tokens == n_tok
                    assert eng.tier_outcomes == {"miss": {"length": 1},
                                                 "host": {"length": 1}}
                    if r == 0:
                        ram_stream[policy] = comp.tokens
                        log(f"[{CARD}] {policy}: the {OFFLOAD_PROMPT}-token "
                            f"request retired and spilled {n_pages} pages "
                            f"({st['ram_bytes']} bytes, {page_bytes} a "
                            f"page); re-admitted: {eng.n_reuse_hits_host} "
                            f"host hit, {eng.n_restored_tokens} tokens "
                            f"restored; offload stats "
                            + json.dumps(stats["offload"]))
                    copy.setdefault(policy, []).append(
                        copy_ms(eng, prompt, n_pages))
                if cnt is not None:
                    launches["offload_restore"] = cnt
                    assert cnt["srft_dequant"] == 2 * L, cnt
                    assert cnt["srft_quant"] > 0, cnt
                    assert cnt["quant_decode_attention_paged"] > 0, cnt
                    assert cnt["quant_decode_attention"] == 0, cnt
                    log(f"[{CARD}] int4 restore admission and its decode: "
                        f"launches {cnt} (B4 {2 * L} = K and V x {L} "
                        f"layers: the raw view of {n_tok} restored tokens)")
            # restored == resident hit of the same depth, bit for bit
            a = got["host"][1].tokens
            n_eq = _first_diff(torch.as_tensor(a),
                               torch.as_tensor(got["device"][1].tokens))
            assert n_eq == OFFLOAD_NEW, \
                f"{policy}: restored != resident from token {n_eq}"
            log(f"[{CARD}] {policy} round {r}: restored stream == the "
                f"resident hit's of the same depth for {n_eq}/{OFFLOAD_NEW} "
                f"tokens; no page leaked on either engine")
            if r == 0 and policy != "int4-srft":
                # the reference's form: the same prompt resident (int4
                # shares 2048 tokens either way, so that is the case above)
                eng_s, comp_s, _, _ = tier_case(model, params, policy,
                                                backend, prompt, "same")
                b = comp_s.tokens
                n_eq = _first_diff(torch.as_tensor(a), torch.as_tensor(b))
                last_chunk_report(model, params, prompt, got["host"][0],
                                  eng_s, policy)
                if n_eq < OFFLOAD_NEW:
                    _tie_check(b, a, forced_logits(
                        model, params, policy, backend, prompt, b, None),
                        f"{policy} restored vs the same prompt resident")
                log(f"[{CARD}] {policy}: restored stream == the same "
                    f"prompt's resident hit for {n_eq}/{OFFLOAD_NEW} tokens")
                del eng_s
            del got

    # tier depth under one budget
    depth = {}
    for policy, backend in OFFLOAD_RUNS:
        eng = tier_engine(model, params, policy, backend,
                          offload_bytes=DEPTH_BYTES)
        tier_serve(eng, [(0, prompt)])
        st = eng.prefix_store.stats()
        kept = [prompt[:(i + 1) * PAGE_SIZE].tobytes() in eng.prefix_store
                for i in range(n_pages)]
        tier_serve(eng, [(1, prompt)])
        depth[policy] = dict(pages_kept=st["pages_ram"],
                             evictions=st["evictions"],
                             ram_bytes=st["ram_bytes"],
                             restored_tokens=eng.n_restored_tokens,
                             hits_host=eng.n_reuse_hits_host)
        if policy == "bf16":
            k = st["pages_ram"]
            assert kept == [False] * (n_pages - k) + [True] * k, kept
            assert eng.n_reuse_hits_host == 0 and k < n_pages
            assert st["evictions"] == n_pages - k
        else:
            assert all(kept) and st["evictions"] == 0
            assert eng.n_restored_tokens == n_tok
    log(f"[{CARD}] host tier under one budget of {DEPTH_BYTES} bytes: "
        + json.dumps(depth))

    # the disk tier, int4
    spill_dir = ROOT / "build" / "offload_spill"
    shutil.rmtree(spill_dir, ignore_errors=True)
    try:
        eng, comp, _, _ = tier_case(model, params, "int4-srft", "kernel",
                                    prompt, "host", offload_bytes=0,
                                    offload_dir=str(spill_dir))
        st = eng.prefix_store.stats()
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    assert st["disk_spills"] >= n_pages and st["disk_loads"] >= n_pages, st
    assert st["ram_bytes"] == 0 and eng.n_restored_tokens == n_tok
    assert torch.equal(torch.as_tensor(comp.tokens),
                       torch.as_tensor(ram_stream["int4-srft"])), \
        "disk restore != RAM restore"
    log(f"[{CARD}] int4 disk tier (RAM budget 0): {st['disk_spills']} disk "
        f"spills, {st['disk_loads']} disk loads, the restored stream == the "
        f"RAM restore's bit for bit; store " + json.dumps(st))

    # what a user feels
    summary = {}
    for policy, _ in OFFLOAD_RUNS:
        summary[policy] = dict(
            ttft_ms={c: [round(t, 1) for t in feel[policy, c]]
                     for c in ("host", "device", "cold")},
            spill_ms=[round(t, 1) for t in spill[policy]],
            export_ms=[round(c[0], 1) for c in copy[policy]],
            restore_ms=[round(t, 1) for t in restore[policy]],
            stack_ms=[round(c[1], 1) for c in copy[policy]],
            h2d_copy_ms=[round(c[2], 2) for c in copy[policy]],
            copy_bytes=copy[policy][0][3])
    log(f"[{CARD}] re-admitted {OFFLOAD_PROMPT}-token request, host clock, "
        f"{OFFLOAD_ROUNDS} interleaved rounds: time to first token by tier "
        f"(host restore, device hit, cold chunked admission without a "
        f"tier), the retire-time spill and its export alone (device to "
        f"host), the restore (stack, copy, import, all layers), its host "
        f"stack and its host-to-device copy alone: "
        + json.dumps(summary))

    # int8-per-token on Engine's main path
    rows = {}
    for graph in (True, False):
        rows[graph] = serve(model, params, "int8-per-token", None,
                            OFFLOAD_PROMPT, graph)
    for graph in (True, False):
        log("request " + json.dumps(rows[graph][0]))
    _graph_agrees(rows[False][1:], rows[True][1:],
                  f"int8-per-token/gather {OFFLOAD_PROMPT} tokens")
    no_sync_region(model, params, policy="int8-per-token", backend=None)
    r8 = rows[True][0]
    key = f"/{OFFLOAD_PROMPT}"
    log(f"[{CARD}] Engine at {OFFLOAD_PROMPT} tokens, {NEW_TOKENS} new, ms "
        f"per token by CUDA events: int8-per-token GATHER graph "
        f"{r8['decode_ms_per_tok']:.3f}, eager "
        f"{rows[False][0]['decode_ms_per_tok']:.3f}; phase 6's graph runs: "
        f"int4-srft KERNEL {MAIN_SUMMARY['int4-srft/kernel' + key]['graph']}"
        f", bf16 GATHER {MAIN_SUMMARY['bf16/gather' + key]['graph']}; "
        f"int8 cache {r8['cache_bytes']} bytes at s_max {S_MAX}, "
        f"compression {r8['compression']:.4f}")

    # the quickstart, on fp32 operands as the quality path
    with common.dot_mode(False):
        rec = quickstart.main(["--steps", "80"])
    assert rec["losses"][-1] < rec["losses"][0], "quickstart did not learn"
    ratios = {k: round(v["compression"], 4)
              for k, v in rec["policies"].items()}
    log(f"[{CARD}] quickstart on the card: loss {rec['losses'][0]:.3f} -> "
        f"{rec['losses'][-1]:.3f}; B3 codes {rec['kernel']}; compression "
        f"{ratios}")
    return launches


def offload_prompt(vocab):
    """Phase 5's 2055-token request (``serve``'s prompt), as numpy."""
    g = torch.Generator(device="cuda").manual_seed(SEED + OFFLOAD_PROMPT)
    return torch.randint(0, vocab, (1, OFFLOAD_PROMPT), generator=g,
                         device="cuda")[0].cpu().numpy().astype("int32")


# ---------------------------------------------------------------- quality

def quality_phase():
    """The quality path on the card (see the module doc, phase 8).
    Returns its launch counts."""
    from repro_torch.benchmarks import kernel_quality

    _zero_counters()
    rec = kernel_quality.run(device="cuda")
    launches = _counters()
    for r in rec["bit_exactness"]:
        log("bit_exactness " + json.dumps(r))
    kc = kernel_quality.kernel_claims(rec["bit_exactness"])
    assert all(kc.values()), f"B3/B4 against their plain versions: {kc}"
    st = rec["standin"]
    log(f"standin {st['model']}: {st['steps']} steps, loss "
        f"{st['first_loss']:.4f} -> {st['final_loss']:.4f} in "
        f"{st['seconds']:.1f}s")
    assert st["final_loss"] < st["first_loss"], "training did not learn"
    lad = rec["quality_ladder"]
    log(f"Table 7 ladder ({lad['model']}, alpha 100 on K, eval tokens "
        f"{lad['eval_tokens']}): base PPL {lad['base_ppl']:.4f}; "
        + ", ".join(f"{r['kernel_variant']} dPPL {r['dppl']:+.4f}"
                    for r in lad["rows"])
        + f"; paper claims (logged, not gated): {lad['claims']}")
    log(f"quality-path launches: {launches}; record {rec['path']}")
    assert launches["srft_quant"] > 0 and launches["srft_dequant"] > 0, \
        launches
    return launches


def quality_reference_phase():
    """Hook PPL on the card against the CPU plain path, for every scheme,
    on a reduced smol-d128 (head_dim 64, the corpus's 256 tokens) with the
    same params, rotations (static lambda for the per-channel schemes)
    and tokens."""
    from repro_torch.benchmarks.common import (
        calibrated_rots,
        eval_tokens,
        hook_ppl,
    )
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.transforms import Rotation
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(reduced(get_config("smol-d128")),
                              vocab_size=256, head_dim=64)
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device="cuda")
    params = cpu.init(cpu.generator(SEED))
    toks = eval_tokens(batch=8, seq_len=128, device="cpu")
    plain = cpu.init_rotations(cpu.generator(1))
    cal = calibrated_rots(cpu, params, toks, plain)
    mv = lambda rots: [tuple(Rotation(r.matrix.cuda(), r.lam.cuda(),  # noqa
                                      r.signs.cuda(), r.kind) for r in p)
                       for p in rots]
    on = {"cpu": (cpu, params, toks, plain, cal),
          "cuda": (gpu, _to(params, "cuda"), toks.cuda(), mv(plain), mv(cal))}
    worst = 0.0
    for scheme in (None, "per_token", "per_tensor", "per_group",
                   "per_channel", "per_channel_group"):
        kw = None if scheme is None else dict(bits=4, scheme=scheme,
                                              group=32)
        ppl = {}
        for dev, (model, p, t, rp, rc) in on.items():
            ppl[dev] = hook_ppl(model, p, t, rc if scheme and "channel" in
                                scheme else rp, kw)
        rel = abs(ppl["cuda"] - ppl["cpu"]) / ppl["cpu"]
        worst = max(worst, rel)
        log(f"  hook PPL {scheme or 'full precision'}: card "
            f"{ppl['cuda']:.6f}, CPU {ppl['cpu']:.6f} (rel {rel:.2e})")
        assert rel <= PPL_RTOL, f"{scheme}: card vs CPU hook PPL rel {rel}"
    log(f"hook PPL card vs CPU (reduced smol-d128, 8 x 128 tokens): "
        f"worst rel {worst:.2e}, tolerance {PPL_RTOL}")


# ----------------------------- phase 12: training, checkpoints, calibration

# 12a: the training CLI at full width (bf16 operands, fp32 accumulation)
TRAIN_ARGV = ("--arch", "internlm2-1.8b", "--layers", str(MAIN_LAYERS),
              "--steps", "4", "--batch", "4", "--seq", "256",
              "--log-every", "1")
# 12b: train_lm's run A and run B's first leg, both inside its 20-step
# warmup, where the cosine schedule does not depend on --steps
TRAIN_LM_STEPS = (12, 6)
# 12c / 12e: fits on the served model's K/V, at the cache's group
CALIB_KW = dict(group=32, bits=4, steps=120, lr=1e-2, learn_lambda=True,
                learn_householder=64)
NOSRFT_KW = dict(group=32, bits=4, steps=120, lr=1e-2, learn_lambda=True,
                 learn_cayley=True)
ORTH_TOL = 1e-4  # every learned matrix: max |M M^T - I|
# 12f: benchmarks/calibration_ablation.py:31-41 (-1: k = d / 2) and its
# Adam steps
ABLATION_VARIANTS = (
    ("random_srft", "srft", {}),
    ("srft_lambda", "srft", dict(learn_lambda=True)),
    ("srft_cayley_lambda", "srft", dict(learn_lambda=True,
                                        learn_cayley=True)),
    ("srft_householder_lambda", "srft", dict(learn_lambda=True,
                                             learn_householder=-1)),
    ("nosrft_cayley_lambda", "identity", dict(learn_lambda=True,
                                              learn_cayley=True)),
)
ABLATION_STEPS = 120
WORK_DIR = ROOT / "build" / "phase12"  # checkpoints, deleted after use


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers of its width: bit-for-bit
    comparison (-0.0 vs 0.0 and NaN payloads count)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _free_cuda():
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_phase() -> dict:
    """12a: ``launch.train.main`` in-process on internlm2-1.8b at full
    width and the main path's depth (TRAIN_ARGV), then ``(params, opt)`` saved with
    ``CheckpointManager`` and restored into a fresh tree on the card, every
    leaf compared bit for bit; the directory is deleted and the state
    freed."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.optim.adam import AdamState, tree_leaves, tree_map

    _free_cuda()
    log(f"[{CARD}] before 12a: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    torch.cuda.reset_peak_memory_stats()
    marks = []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, metrics["loss"]))

    t0 = time.perf_counter()
    state = train.main(list(TRAIN_ARGV), on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(loss) for _, loss in marks]
    step_ms = [a.elapsed_time(b) for (a, _), (b, _) in zip(marks,
                                                            marks[1:])]
    assert len(losses) == 4 and torch.isfinite(torch.tensor(losses)).all(), \
        losses
    leaves = tree_leaves(state)
    n_params = sum(t.numel() for t in tree_leaves(state[0]))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    path = WORK_DIR / "full"
    mgr = CheckpointManager(str(path), keep=1)
    free = shutil.disk_usage(path).free
    t0 = time.perf_counter()
    mgr.save(4, state, metadata={"data": {"step": 4}})
    save_s = time.perf_counter() - t0
    disk = _dir_bytes(path)
    example = tree_map(lambda t: torch.empty_like(t, device="meta"), state)
    t0 = time.perf_counter()
    restored, meta = mgr.restore(4, example,
                                 sharding_fn=lambda i, ex: torch.device(DEV))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = tree_leaves(restored)
    assert isinstance(restored[1], AdamState) and len(got) == len(leaves)
    for i, (a, b) in enumerate(zip(leaves, got)):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), i
        assert torch.equal(_bits(a), _bits(b)), f"leaf {i} differs"
    assert meta == {"data": {"step": 4}}
    shutil.rmtree(path)
    rec = dict(params=n_params, leaves=len(leaves), state_bytes=state_bytes,
               losses=losses, step_ms_2_to_4=step_ms, main_wall_s=wall,
               peak_bytes=peak, disk_free_bytes=free, ckpt_disk_bytes=disk,
               save_s=save_s, restore_s=restore_s)
    log("train " + json.dumps(rec))
    log(f"[{CARD}] 12a internlm2-1.8b training ({MAIN_LAYERS}/24 layers), "
        f"4 x 256 tokens a step, bf16 "
        f"operands: {n_params:,} params, ms/step (events, steps 2-4) "
        + ", ".join(f"{m:.1f}" for m in step_ms)
        + f"; losses {losses}; peak {peak / 1e9:.2f} GB allocated; "
        f"checkpoint {disk / 1e9:.3f} GB on disk, save {save_s:.1f} s, "
        f"restore {restore_s:.1f} s, {len(leaves)} leaves bit for bit")
    del state, restored, got, leaves, example
    _free_cuda()
    return rec


def _ckpt_diff(dir_a, dir_b, step) -> dict:
    """Two checkpoints of one step, leaf by leaf: the leaves whose bytes
    differ, the largest abs difference of each, and both metadata."""
    import numpy as np

    name = f"step_{step:08d}"
    metas = [json.loads((Path(d) / name / "meta.json").read_text())
             for d in (dir_a, dir_b)]
    assert metas[0]["n_leaves"] == metas[1]["n_leaves"]
    diff = {}
    with np.load(Path(dir_a) / name / "arrays.npz") as fa, \
            np.load(Path(dir_b) / name / "arrays.npz") as fb:
        for i in range(metas[0]["n_leaves"]):
            a, b = fa[f"leaf_{i}"], fb[f"leaf_{i}"]
            if a.tobytes() != b.tobytes():
                ta = _from_npz(a, metas[0]["dtypes"][i])
                tb = _from_npz(b, metas[0]["dtypes"][i])
                diff[i] = (ta - tb).abs().max().item()
    return {"n_leaves": metas[0]["n_leaves"], "differ": diff,
            "meta": [m["metadata"] for m in metas],
            "dtypes": metas[0]["dtypes"]}


def _from_npz(a, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a.copy())
    return (t.view(torch.bfloat16) if dtype == "bfloat16" else t).double()


def resume_phase() -> dict:
    """12b: ``examples.train_lm`` (tiny-33m) through its CLI on the card:
    two uninterrupted runs A and A' to TRAIN_LM_STEPS[0], and run B to
    TRAIN_LM_STEPS[1] then started again to TRAIN_LM_STEPS[0] (a resume);
    the step checkpoints compared leaf for leaf, with the iterator state."""
    from repro_torch.examples import train_lm

    n, half = TRAIN_LM_STEPS
    dirs = {k: WORK_DIR / f"train_lm_{k}" for k in ("a", "a2", "b")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    runs = {k: train_lm.main(["--steps", str(n), "--ckpt-dir", str(dirs[k])])
            for k in ("a", "a2")}
    first = train_lm.main(["--steps", str(half), "--ckpt-dir",
                           str(dirs["b"])])
    runs["b"] = train_lm.main(["--steps", str(n), "--ckpt-dir",
                               str(dirs["b"])])
    secs = time.perf_counter() - t0
    assert first["reached"] == half, first
    assert runs["b"]["start"] == half and runs["b"]["reached"] == n, runs["b"]
    rerun = _ckpt_diff(dirs["a"], dirs["a2"], n)
    resume = _ckpt_diff(dirs["a"], dirs["b"], n)
    data = {"step": n, "shard_id": 0, "num_shards": 1}
    assert rerun["meta"] == resume["meta"][::-1] == [{"data": data}] * 2, \
        (rerun["meta"], resume["meta"])
    losses_a, losses_b = runs["a"]["losses"], first["losses"] + runs["b"][
        "losses"]
    rec = dict(steps=n, resumed_at=half, leaves=rerun["n_leaves"],
               rerun_leaves_differ=len(rerun["differ"]),
               resume_leaves_differ=len(resume["differ"]),
               rerun_max_abs=max(rerun["differ"].values(), default=0.0),
               resume_max_abs=max(resume["differ"].values(), default=0.0),
               losses_a=losses_a, losses_b=losses_b, seconds=secs)
    log("resume " + json.dumps(rec))
    if rerun["differ"]:
        # the card reorders some reduction between two identical runs:
        # then the resume is held to the run-to-run spread, leaf by leaf
        log(f"  uninterrupted runs differ in leaves {rerun['differ']}")
        for i, err in resume["differ"].items():
            assert err <= 2 * rerun["differ"].get(i, 0.0), \
                f"leaf {i}: resume {err} beyond twice the rerun spread"
    else:
        assert not resume["differ"], f"resume differs: {resume['differ']}"
        assert losses_a == losses_b, (losses_a, losses_b)
    log(f"[{CARD}] 12b train_lm (tiny-33m) on the card: two uninterrupted "
        f"runs to step {n} {'equal' if not rerun['differ'] else 'DIFFER'} "
        f"bit for bit ({rerun['n_leaves']} leaves); {half} steps + resume "
        f"to {n}: {len(resume['differ'])} leaves differ, iterator state "
        f"{data}; {secs:.1f} s for the four runs")
    for d in dirs.values():
        shutil.rmtree(d)
    return rec


def calibration_phase(model, params):
    """12c: K/V of the 2,055-token request (phase 5's prompt) through
    ``collect_kv``; every layer and side fitted with ``calibrate``
    (CALIB_KW: learned lambda + Householder k = 64 on the SRFT base);
    every matrix orthogonal within ORTH_TOL, every lambda finite and
    positive.  Returns the learned (k, v) pairs and layer 0's K vectors."""
    from repro_torch.core.calibrate import calibrate

    cfg = model.cfg
    n = PROMPTS[1]
    g = torch.Generator(device=DEV).manual_seed(SEED + n)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                           device=DEV)
    with torch.no_grad():
        k_act, v_act = model.collect_kv(params, prompt)
    acts = {"k": k_act, "v": v_act}
    base = model.init_rotations(model.generator(SEED + 1))
    eye = torch.eye(cfg.head_dim, device=DEV)
    learned, red, orth, lam = [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(cfg.n_layers):
        pair = []
        for j, side in enumerate("kv"):
            x = acts[side][i].reshape(-1, cfg.head_dim).float()
            rot, diag = calibrate(base[i][j], x,
                                  generator=model.generator(SEED + 2 * i + j),
                                  **CALIB_KW)
            pair.append(rot)
            red.append(diag["mse_reduction"])
            orth.append((rot.matrix @ rot.matrix.T - eye).abs().max().item())
            lam.append((rot.lam.min().item(), rot.lam.max().item()))
            assert torch.isfinite(rot.lam).all() and (rot.lam > 0).all(), \
                f"layer {i} {side}: lambda {rot.lam}"
        learned.append(tuple(pair))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert max(orth) <= ORTH_TOL, f"orthogonality {max(orth)}"
    rec = dict(vectors_per_fit=k_act[0].numel() // cfg.head_dim,
               fits=len(red), seconds=secs,
               mse_reduction=[min(red), sum(red) / len(red), max(red)],
               max_orthogonality_err=max(orth),
               lambda_range=[min(a for a, _ in lam), max(b for _, b in lam)])
    log("calibration " + json.dumps(rec))
    log(f"[{CARD}] 12c learned lambda + Householder k = 64 on internlm2-1.8b's "
        f"own K/V ({rec['vectors_per_fit']} vectors a fit, {len(red)} fits "
        f"of {CALIB_KW['steps']} steps): {secs:.1f} s; MSE reduction min / "
        f"mean / max {min(red):.4f} / {sum(red) / len(red):.4f} / "
        f"{max(red):.4f}; orthogonality <= {max(orth):.2e}")
    return learned, acts["k"][0].reshape(-1, cfg.head_dim), rec


def learned_serve_phase(model, params, rots) -> tuple[dict, dict]:
    """12d: ``Engine`` on the 2,055-token request (64 new tokens) with the
    int4-srft cache built on the learned rotations: KERNEL under the graph
    (counters zeroed just before, read just after: the counts of phase 5's
    request) and eager, and GATHER; graph == eager within GRAPH_TOL,
    KERNEL vs GATHER within LOGIT_TOL."""
    n = PROMPTS[1]
    _zero_counters()
    row_g, t_g, l_g = serve(model, params, "int4-srft", "kernel", n, True,
                            rots=rots)
    launches = _counters()
    row_e, t_e, l_e = serve(model, params, "int4-srft", "kernel", n, False,
                            rots=rots)
    _, t_ga, l_ga = serve(model, params, "int4-srft", "gather", n, True,
                          rots=rots)
    for row in (row_g, row_e):
        log("learned request " + json.dumps(row))
    _graph_agrees((t_e, l_e), (t_g, l_g), f"learned rotations {n} tokens")
    n_same = _agree_until(t_g, t_ga, l_g)
    err = (l_g[:, :n_same] - l_ga[:, :n_same]).abs().max().item()
    tol = LOGIT_TOL * l_g.abs().max().item()
    assert err <= tol, f"learned rotations: GATHER vs KERNEL {err} > {tol}"
    want = MAIN_LAUNCHES[n]
    for name in ("srft_quant", "quant_decode_attention"):
        assert launches[name] == want[name] > 0, (launches, want)
    main_ms = MAIN_SUMMARY[f"int4-srft/kernel/{n}"]["graph"]
    rec = dict(decode_ms_per_tok=row_g["decode_ms_per_tok"],
               eager_ms_per_tok=row_e["decode_ms_per_tok"],
               phase6_graph_ms_per_tok=main_ms, kernel_vs_gather=err,
               kernel_vs_gather_tol=tol, tokens_agree=n_same,
               launches=launches)
    log("learned serve " + json.dumps(rec))
    log(f"[{CARD}] 12d Engine int4-srft KERNEL on learned rotations, {n} "
        f"tokens: {row_g['decode_ms_per_tok']:.4f} ms/token graph "
        f"(phase 6's random SRFT: {main_ms}), eager "
        f"{row_e['decode_ms_per_tok']:.3f}; KERNEL vs GATHER {err:.3e} (tol "
        f"{tol:.3e}); launches {launches}")
    return rec, launches


def learned_kernel_phase(rot_k0, x) -> tuple[list, dict]:
    """12e: B3 (the cache's write, lambda as an epilogue, and the folded
    matrix) and B4 (``kernel_quality.fold_and_invert``) on layer 0's
    learned K rotation and on a no-SRFT rotation (identity base, learned
    Cayley + lambda) fitted on the same vectors, each held to its plain
    version: B3 by ``check_b3``, B4 within B4_RTOL * max(1, max |x|).
    Counters zeroed just before and read just after."""
    from repro_torch.benchmarks.kernel_quality import fold_and_invert
    from repro_torch.core.calibrate import calibrate
    from repro_torch.core.transforms import Rotation, make_rotation
    from repro_torch.kernels.srft_quant import ops as sq_ops
    from repro_torch.kernels.srft_quant import ref

    d = x.shape[-1]
    ident = make_rotation("identity", torch.Generator().manual_seed(SEED), d,
                          DEV)
    nosrft, diag = calibrate(ident, x.float(),
                             generator=torch.Generator(device=DEV)
                             .manual_seed(SEED), **NOSRFT_KW)
    eye = torch.eye(d, device=DEV)
    rows = []
    _zero_counters()
    for name, rot in (("learned_householder_k", rot_k0),
                      ("nosrft_cayley", nosrft)):
        orth = (rot.matrix @ rot.matrix.T - eye).abs().max().item()
        assert orth <= ORTH_TOL, f"{name}: orthogonality {orth}"
        err, flips = check_b3(sq_ops, ref, rot, x, group=CALIB_KW["group"])
        folded = Rotation(ref.fold_matrix(rot), torch.ones_like(rot.lam),
                          rot.signs, rot.kind)
        err_f, flips_f = check_b3(sq_ops, ref, folded, x.float(),
                                  group=CALIB_KW["group"])
        rt = fold_and_invert(x.float(), rot, group=CALIB_KW["group"])
        assert rt["err"] <= rt["tol"], f"{name}: B4 {rt['err']} > {rt['tol']}"
        rows.append(dict(rotation=name, rows=x.shape[0],
                         lam=[rot.lam.min().item(), rot.lam.max().item()],
                         orthogonality_err=orth, b3_cache_deq_err=err,
                         b3_cache_tie_flips=flips, b3_folded_deq_err=err_f,
                         b3_folded_tie_flips=flips_f, b4_err=rt["err"],
                         b4_tol=rt["tol"]))
        log("learned kernels " + json.dumps(rows[-1]))
    launches = _counters()
    assert launches["srft_quant"] > 0 and launches["srft_dequant"] > 0
    log(f"[{CARD}] 12e B3 / B4 on learned matrices (layer 0 K, {x.shape[0]} "
        f"rows): pass, no-SRFT fit MSE reduction "
        f"{diag['mse_reduction']:.4f}; launches {launches}")
    return rows, launches


def ablation_phase() -> dict:
    """12f: the paper's §5.3 ablation (benchmarks/calibration_ablation.py)
    on fp32 operands: smol-d64 trained 250 steps, alpha = 20 outliers,
    8 x 256 eval tokens; per variant the mean MSE reduction over layers
    and sides, hook dPPL (per_channel, group 32) and the four claims,
    logged and not gated."""
    from repro_torch.benchmarks.common import (
        eval_tokens,
        hook_ppl,
        trained_standin,
    )
    from repro_torch.core.calibrate import calibrate
    from repro_torch.core.outliers import inject_kv_outliers
    from repro_torch.core.transforms import make_rotation
    from repro_torch.models import common

    t0 = time.perf_counter()
    with common.dot_mode(False):
        st = trained_standin("smol-d64", device=DEV)
        cfg, model = st.cfg, st.model
        params = inject_kv_outliers(st.params, head_dim=cfg.head_dim,
                                    alpha=20.0)
        d, L = cfg.head_dim, cfg.n_layers
        toks = eval_tokens(batch=8, device=DEV)
        base = hook_ppl(model, params, toks, None, None)
        with torch.no_grad():
            k_act, v_act = model.collect_kv(params, toks)
        acts = {"k": k_act.reshape(L, -1, d).float(),
                "v": v_act.reshape(L, -1, d).float()}
        rows = []
        for name, kind, kw in ABLATION_VARIANTS:
            kw = dict(kw)
            if kw.get("learn_householder") == -1:
                kw["learn_householder"] = d // 2
            fitted, red = {"k": [], "v": []}, []
            for which in "kv":
                for i in range(L):
                    rot = make_rotation(kind, torch.Generator().manual_seed(
                        10 + i), d, DEV)
                    if kw:  # learned variants: per layer and side (§5.1)
                        rot, diag = calibrate(
                            rot, acts[which][i], bits=4,
                            steps=ABLATION_STEPS, lr=1e-2,
                            generator=torch.Generator(device=DEV)
                            .manual_seed(10 + i), **kw)
                        red.append(diag["mse_reduction"])
                    fitted[which].append(rot)
            ppl = hook_ppl(model, params, toks,
                           list(zip(fitted["k"], fitted["v"])),
                           dict(bits=4, scheme="per_channel", group=32))
            n_params = {"random_srft": 0, "srft_lambda": d,
                        "srft_cayley_lambda": d * d + d,
                        "srft_householder_lambda": (d // 2) * d + d,
                        "nosrft_cayley_lambda": d * d + d}[name]
            rows.append(dict(variant=name, params_per_ch=n_params,
                             mse_reduction=sum(red) / len(red) if red
                             else None, dppl=ppl - base))
    r = {row["variant"]: row for row in rows}
    claims = {
        "all_learned_beat_random": all(
            r[v]["dppl"] < r["random_srft"]["dppl"]
            for v in ("srft_lambda", "srft_cayley_lambda",
                      "srft_householder_lambda")),
        "householder_half_params_of_cayley":
            r["srft_householder_lambda"]["params_per_ch"]
            < 0.6 * r["srft_cayley_lambda"]["params_per_ch"],
        "nosrft_higher_mse_reduction":
            r["nosrft_cayley_lambda"]["mse_reduction"]
            > r["srft_cayley_lambda"]["mse_reduction"],
        "nosrft_worse_ppl_than_best_srft":
            r["nosrft_cayley_lambda"]["dppl"]
            > min(r["srft_cayley_lambda"]["dppl"],
                  r["srft_householder_lambda"]["dppl"]),
    }
    rec = dict(model=cfg.name, train_loss=[st.losses[0], st.losses[-1]],
               fp_ppl=base, adam_steps=ABLATION_STEPS, rows=rows,
               claims=claims, seconds=time.perf_counter() - t0)
    log("ablation " + json.dumps(rec))
    log(f"[{CARD}] 12f §5.3 ablation (smol-d64, alpha 20, fp32 operands, "
        f"fp PPL {base:.4f}): "
        + "; ".join(f"{x['variant']} MSE red "
                    + ("-" if x["mse_reduction"] is None
                       else f"{x['mse_reduction']:.4f}")
                    + f" dPPL {x['dppl']:+.4f}" for x in rows)
        + f"; paper claims (logged, not gated): {claims}")
    return rec


def learned_phase(model, params) -> dict:
    """Phase 12 (see the module doc).  Returns launches per kernel of its
    two kernel paths."""
    t = {}
    t0 = time.perf_counter()
    train_phase()
    t["12a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resume_phase()
    t["12b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rots, x_k0, _ = calibration_phase(model, params)
    t["12c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, serve_launches = learned_serve_phase(model, params, rots)
    t["12d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, rt_launches = learned_kernel_phase(rots[0][0], x_k0)
    t["12e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ablation_phase()
    t["12f"] = time.perf_counter() - t0
    log("phase 12 seconds " + json.dumps(t))
    return {"learned_engine": serve_launches,
            "learned_roundtrip": rt_launches}


# ------------------------------------------- phase 13: the serving front-end
# the closed-loop trace: buckets of 256 / 384 / 512 tokens in runs of two,
# so bucketed admission packs k = 2 prompts a prefill
SERVE_N, SERVE_PROMPT, SERVE_NEW, SERVE_RUN = 8, 512, 32, 2
SERVE_ROUNDS = 2  # interleaved sync / pipelined rounds (paged)
SERVE_CLI = ("--arch", "internlm2-1.8b", "--paged", "--policy", "int4-srft",
             "--backend", "kernel", "--max-batch", "4", "--requests", "4",
             "--prompt-len", "256", "--new-tokens", "16")


def _check_trace_fn():
    """``benchmarks/check_trace.py``'s validator, loaded by path (stdlib
    only), as ``tests/test_tracing.py`` loads it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "benchmarks" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.check_trace


def _strict_prometheus(text) -> dict:
    """Every sample in a family declared by HELP then TYPE above it, every
    name in the Prometheus charset, every value a number; returns the
    samples by name."""
    import re

    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    families, helped, samples = {}, set(), {}
    for line in text.strip().split("\n"):
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
        elif line.startswith("# TYPE "):
            _, _, fam, typ = line.split(None, 3)
            assert fam in helped and typ in ("counter", "gauge", "summary")
            families[fam] = typ
        else:
            name = re.split(r"[{\s]", line, maxsplit=1)[0]
            assert name_re.match(name), line
            base = next((name[:-len(s)] for s in ("_count", "_sum")
                         if name.endswith(s) and name[:-len(s)] in families),
                        name)
            assert base in families, f"undeclared family: {line!r}"
            samples[line.rsplit(None, 1)[0]] = float(line.rsplit(None, 1)[1])
    return samples


def serve_engine(model, params, paged):
    from repro_torch.launch.batch_engine import BatchEngine

    return BatchEngine(model, params, capacity=CAPACITY,
                       s_max=SERVE_PROMPT + SERVE_NEW + 16, policy="int4-srft",
                       backend="kernel", chunk=CHUNK, paged=paged,
                       page_size=PAGE_SIZE, device=DEV)


def sync_replay(eng, items):
    """The closed-loop trace through ``SyncServer``: (streams by rid, host
    seconds from the first admission to the drain, metrics)."""
    from repro_torch.launch.server import SyncServer
    from repro_torch.launch.server.pipeline import drain_stream

    srv = SyncServer(eng, max_group=CAPACITY)
    streams = {it.req.rid: srv.submit(it.req) for it in items}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.run_until_drained()
    wall = time.perf_counter() - t0
    out = {rid: drain_stream(q, 60) for rid, q in streams.items()}
    srv.close()
    return out, wall, srv.metrics


def pipe_replay(eng, items, trace=None, profiled=False):
    """The same trace through ``ServingPipeline`` (everything submitted
    before the stage threads start, which pins the grouping), recorded in
    ``trace`` (default: a fresh recorder).  Returns the streams, the host
    seconds from the start to the last stream's end, the metrics, the
    trace, and (device busy ms by kernel name with ``profiled``, else None;
    the run's CUDA-event ms)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.server import ServingPipeline, TraceRecorder
    from repro_torch.launch.server.pipeline import drain_stream

    pipe = ServingPipeline(eng, max_group=CAPACITY, admit_queue=2 * SERVE_N,
                           trace=TraceRecorder() if trace is None else trace)
    streams = {it.req.rid: pipe.submit(it.req) for it in items}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if profiled else None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    a.record()
    pipe.start()
    out = {rid: drain_stream(q, 120) for rid, q in streams.items()}
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    assert pipe.shutdown(timeout=60.0), "the pipeline did not drain"
    busy = None if prof is None else {
        k: us / 1e3 for k, us in _kernel_us(prof).items()}
    return out, wall, pipe.metrics, pipe.trace, (busy, a.elapsed_time(b))


def _latency_ms(metrics) -> dict:
    """TTFT p50 / p90, ITL p50, e2e p50 in ms from ``ServerMetrics``."""
    import numpy as np

    def q(h, p):
        return float(np.percentile(np.asarray(h._v), p)) * 1e3 if h._v \
            else None

    return {"ttft_p50": q(metrics.ttft, 50), "ttft_p90": q(metrics.ttft, 90),
            "itl_p50": q(metrics.itl, 50), "e2e_p50": q(metrics.e2e, 50)}


def _span_ms(trace) -> dict:
    """Host ms summed by span name, for the spans of one serving run."""
    out = {}
    for e in trace.export()["traceEvents"]:
        if e["ph"] == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def gil_probe(eng, reqs) -> float:
    """Whether a decode chunk's device time leaves the GIL to other
    threads: a thread counts loop turns while this one runs one
    ``step()`` of four live rows (8 graph replays and the chunk's blocking
    readback), against its count while this thread sleeps as long.  The
    ratio is the share of the chunk in which another thread could run
    Python (near 0 if the replay or the readback held the GIL)."""
    for r in reqs:
        eng.submit(r)
    eng.step()  # admits the four and decodes a chunk
    torch.cuda.synchronize()
    count, stop = [0], threading.Event()

    def spin():
        while not stop.is_set():
            count[0] += 1

    spinner = threading.Thread(target=spin, daemon=True)
    spinner.start()
    time.sleep(0.01)
    n0, t0 = count[0], time.perf_counter()
    eng.step()
    n1, dt = count[0], time.perf_counter() - t0
    time.sleep(dt)
    n2 = count[0]
    stop.set()
    spinner.join(10)
    eng.cancel_all()
    return (n1 - n0) / max(n2 - n1, 1)


def _collect(eng, reqs) -> dict:
    """``admit_packed(reqs)`` then steps to the end: tokens by rid, from
    the step listeners."""
    got = {}

    def listen(events, comps):
        for rid, toks in events:
            got.setdefault(rid, []).extend(toks)

    eng.step_listeners.append(listen)
    eng.admit_packed(reqs)
    while eng.has_work:
        eng.step()
    eng.step_listeners.remove(listen)
    return got


def packed_op_report(model, params, a, b) -> None:
    """Where ``admit_packed([a, b])`` and ``([b, a])`` part: the same two
    prompts prefilled as one batch-2 staging cache in both row orders,
    every recorded output (``_Taps``: norms, projections, RoPE, the
    unembedding) of a's row compared in call order; the first that
    differs, by its index and shape."""
    outs = []
    for rows in ((a, b), (b, a)):
        prompts = torch.as_tensor([list(r.prompt) for r in rows],
                                  device=DEV)
        with _Taps(model, "int4-srft") as taps:
            _prefilled(model, params, prompts, "int4-srft", rows=2,
                       s_max=SERVE_PROMPT + SERVE_NEW + 16)
        outs.append(list(taps.out))
    first = None
    for n, ((_, x), (_, y)) in enumerate(zip(*outs)):
        if x.shape[:1] == (2,) and (x[0] != y[1]).any():
            first = (n, tuple(x.shape), int((x[0] != y[1]).sum()))
            break
    log(f"[{CARD}] packed prefill, rows (a, b) vs (b, a), {len(outs[0])} "
        f"recorded outputs: first differing output of a's row: "
        + ("none" if first is None else
           f"#{first[0]}, shape {first[1]} ({first[2]} elements)"))


def _post_sse(url, prompt, n_new) -> tuple[list, list]:
    """POST a completion with ``"stream": true``; (tokens, events)."""
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(
            {"prompt": [int(t) for t in prompt], "max_tokens": n_new,
             "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    toks, events = [], []
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                return toks, events
            ev = json.loads(line[len("data: "):])
            events.append(ev)
            toks.extend(ev["tokens"])
    raise AssertionError("SSE stream ended without [DONE]")


def http_phase(model, params, eng, items, want) -> dict:
    """13c: ``CompletionServer`` on an ephemeral port before the paged
    pipeline; the eight prompts POSTed at once; /healthz, /metrics,
    /debug/trace; then two more requests and a cancel-shutdown."""
    import urllib.request

    from repro_torch.core.paged import NULL_PAGE
    from repro_torch.launch.server import (CompletionServer, ServingPipeline,
                                           TraceRecorder)
    from repro_torch.launch.server.pipeline import drain_stream

    pipe = ServingPipeline(eng, max_group=CAPACITY, admit_queue=2 * SERVE_N,
                           trace=TraceRecorder())
    pipe.start()
    server = CompletionServer(pipe, host="127.0.0.1", port=0,
                              vocab_size=model.cfg.vocab_size)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    got, errors = {}, []

    def client(it):
        try:
            got[it.req.rid] = _post_sse(server.url, it.req.prompt, SERVE_NEW)
        except Exception as e:  # reported below: a client thread must end
            errors.append(f"rid {it.req.rid}: {e!r}")

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(it,)) for it in items]
    for c in clients:
        c.start()
    for c in clients:
        c.join(300)
    wall = time.perf_counter() - t0
    try:
        assert not errors and len(got) == len(items), errors
        n_equal = 0
        for it in items:
            toks, events = got[it.req.rid]
            finals = [e for e in events if e["finish_reason"] is not None]
            assert len(finals) == 1 and events[-1] is finals[0], events[-1:]
            assert finals[0]["finish_reason"] == "length"
            assert len(toks) == SERVE_NEW, (it.req.rid, len(toks))
            ref = want[it.req.rid][0]
            if toks == ref:
                n_equal += 1
            else:
                _tie_check(ref, toks, forced_logits(
                    model, params, "int4-srft", "kernel", it.req.prompt, ref,
                    eng._rots), f"HTTP stream of request {it.req.rid}")
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["slots_capacity"] == CAPACITY
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=60) as resp:
            samples = _strict_prometheus(resp.read().decode())
        assert samples["server_requests_completed_total"] == SERVE_N
        assert samples["server_trace_dropped_total"] == 0
        with urllib.request.urlopen(server.url + "/debug/trace",
                                    timeout=60) as resp:
            trace = json.loads(resp.read())
        problems = _check_trace_fn()(trace)
        assert not problems, problems
        assert trace["otherData"]["dropped"] == 0
        # a cancel-shutdown with two long requests live returns every page
        late = [pipe.submit(dataclasses.replace(
            it.req, rid=100 + i, max_new_tokens=SERVE_NEW))
            for i, it in enumerate(items[-2:])]
        deadline = time.monotonic() + 60
        while not eng.n_active and time.monotonic() < deadline:
            time.sleep(0.001)
        assert eng.n_active, "the late requests were never admitted"
    finally:
        server.shutdown()
    pipe.shutdown(cancel=True, timeout=60.0)
    reasons = [drain_stream(q, 60)[1] for q in late]
    rc = eng._refcount_host.copy()
    assert rc[NULL_PAGE] == 1
    rc[NULL_PAGE] = 0
    assert (rc == 0).all() and eng.n_free_slots == CAPACITY, \
        f"pages leaked: {rc.nonzero()}"
    rec = dict(streams=len(got), equal_to_sync=n_equal, wall_s=wall,
               trace_events=len(trace["traceEvents"]),
               trace_dropped=trace["otherData"]["dropped"],
               metrics_samples=len(samples), late_reasons=reasons,
               **_latency_ms(pipe.metrics))
    log(f"[{CARD}] 13c HTTP: {len(got)} concurrent SSE streams of "
        f"{SERVE_NEW} tokens in {wall:.3f} s, {n_equal}/{len(got)} equal to "
        f"sync bit for bit (the rest up to a near-tie); /metrics strict "
        f"({len(samples)} samples), /debug/trace passes check_trace "
        f"({rec['trace_events']} events, 0 dropped); after a cancel-shutdown "
        f"with 2 live ({reasons}) every page is back")
    return rec


def cli_phase() -> dict:
    """13d: ``python -m repro_torch.launch.serve`` in a subprocess."""
    out_json = ROOT / "build" / "serve_cli_stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_CLI,
         "--stats-json", str(out_json)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines()[-12:]:
        log(f"  serve CLI | {line}")
    assert res.returncode == 0, f"serve CLI rc {res.returncode}:\n" \
        f"{res.stderr[-4000:]}"
    stats = json.loads(out_json.read_text())
    out_json.unlink()
    cache = stats["cache"]
    assert stats["requests_done"] == 4 and cache["pool"]["pages_used"] == 0
    rec = dict(wall_s=wall, compression=cache["compression_ratio"],
               pool_pages=cache["pool"]["n_pages"],
               aggregate_tok_s=stats["aggregate_tok_s"])
    log(f"[{CARD}] 13d serve CLI: rc 0 in {wall:.1f} s (process start, "
        f"model init and capture included); compression "
        f"{rec['compression']}, pool {rec['pool_pages']} pages")
    return rec


def serve_phase(model, params) -> dict:
    """Phase 13 (see the module doc).  Returns launches per kernel of the
    pipelined paged and dense runs."""
    from repro_torch.launch.server import TraceRecorder, make_trace

    items = make_trace(SERVE_N, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
                       run_len=SERVE_RUN, arrival="closed")
    log(f"13: prompt lengths {[len(it.req.prompt) for it in items]}, "
        f"{SERVE_NEW} new tokens each")
    launches, engines, want, rec = {}, {}, {}, {}
    for paged in (True, False):
        layout = "paged" if paged else "dense"
        eng_s = serve_engine(model, params, paged)
        sync, wall_s, _ = sync_replay(eng_s, items)
        assert all(r == "length" and len(t) == SERVE_NEW
                   for t, r in sync.values())
        eng_p = serve_engine(model, params, paged)
        _zero_counters()
        piped, wall_p, metrics, trace, (_, ev_ms) = pipe_replay(eng_p, items)
        launches[f"serve_{layout}"] = _counters()
        assert piped == sync, f"{layout}: pipelined != sync"
        packed = [e["dur"] / 1e3 for e in trace.export()["traceEvents"]
                  if e["name"] == "prefill.packed"]
        rec[layout] = dict(sync_s=wall_s, pipelined_s=wall_p,
                           pipelined_events_ms=ev_ms,
                           capture_s_sync=eng_s._step_graph.capture_s,
                           capture_s_pipelined=eng_p._step_graph.capture_s,
                           packed_prefill_host_ms=packed,
                           **_latency_ms(metrics))
        log(f"[{CARD}] 13a {layout}: pipelined == sync bit for bit "
            f"({SERVE_N} streams); launches {launches[f'serve_{layout}']}; "
            f"packed prefills (k = 2) host ms {[round(x, 3) for x in packed]}"
            f"; capture s {rec[layout]['capture_s_pipelined']:.3f} (decode "
            f"thread) / {rec[layout]['capture_s_sync']:.3f} (main)")
        engines[paged], want[paged] = (eng_s, eng_p), sync
    paged_l, dense_l = launches["serve_paged"], launches["serve_dense"]
    assert paged_l["srft_quant"] > 0 and \
        paged_l["quant_decode_attention_paged"] > 0, paged_l
    assert dense_l["srft_quant"] > 0 and \
        dense_l["quant_decode_attention"] > 0, dense_l

    eng_s, eng_p = engines[True]
    off, *_ = pipe_replay(eng_p, items, trace=TraceRecorder(enabled=False))
    assert off == want[True], "tracing off != tracing on"
    log("  13a: tracing off == tracing on, paged, bit for bit")
    rounds = []
    for r in range(SERVE_ROUNDS):
        row = {}
        for mode in (("sync", "pipelined") if r % 2 == 0
                     else ("pipelined", "sync")):
            extra = {}
            if mode == "sync":
                got, wall, metrics = sync_replay(eng_s, items)
            else:
                got, wall, metrics, trace, (_, ev_ms) = pipe_replay(eng_p,
                                                                    items)
                extra = dict(events_ms=ev_ms, span_ms=_span_ms(trace))
            assert got == want[True], f"round {r} {mode} != the first run"
            row[mode] = dict(wall_s=wall, req_s=SERVE_N / wall,
                             tok_s=SERVE_N * SERVE_NEW / wall,
                             **_latency_ms(metrics), **extra)
        rounds.append(row)
    _, wall, _, _, (busy, ev_ms) = pipe_replay(eng_p, items, profiled=True)
    busy_ms = sum(busy.values())
    warm_ev = sorted(x["pipelined"]["events_ms"] for x in rounds)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    rec["rounds"] = rounds
    rec["profiled"] = dict(
        wall_s=wall, device_busy_ms=busy_ms, events_ms=ev_ms,
        idle_share=1 - busy_ms / ev_ms,
        idle_share_events=1 - busy_ms / warm_ev[len(warm_ev) // 2],
        top_kernels_ms=[(k[:60], v) for k, v in top])
    rec["gil_free_share"] = gil_probe(
        eng_p, [dataclasses.replace(it.req, max_new_tokens=SERVE_NEW)
                for it in items[:CAPACITY]])
    log(f"[{CARD}] 13a req/s sync vs pipelined, paged, {SERVE_ROUNDS} "
        f"interleaved rounds: "
        + "; ".join(f"{x['sync']['req_s']:.3f} vs "
                    f"{x['pipelined']['req_s']:.3f}" for x in rounds)
        + "; tokens/s "
        + "; ".join(f"{x['sync']['tok_s']:.1f} vs "
                    f"{x['pipelined']['tok_s']:.1f}" for x in rounds))
    for what, lat in (("pipelined, first run (capture included)",
                       rec["paged"]),
                      ("pipelined, last round", rounds[-1]["pipelined"]),
                      ("sync, last round", rounds[-1]["sync"])):
        log(f"[{CARD}] 13a latency, paged, {what}: TTFT p50 "
            f"{lat['ttft_p50']:.2f} ms, p90 {lat['ttft_p90']:.2f} ms; ITL "
            f"p50 {lat['itl_p50']:.3f} ms; e2e p50 {lat['e2e_p50']:.2f} ms")
    span = rounds[-1]["pipelined"]["span_ms"]
    log(f"[{CARD}] 13a host ms by span, last pipelined round ("
        f"{rounds[-1]['pipelined']['wall_s'] * 1e3:.1f} ms wall): "
        + ", ".join(f"{k} {span[k]:.1f}" for k in (
            "prefill.packed", "decode.chunk", "engine.step", "admit.sweep")
                    if k in span))
    prof = rec["profiled"]
    log(f"[{CARD}] 13a device idle share under the pipeline: profiler busy "
        f"{busy_ms:.2f} ms over the profiled run's events {ev_ms:.2f} ms: "
        f"{prof['idle_share']:.4f}; over the warm rounds' median events "
        f"ms: {prof['idle_share_events']:.4f}; top kernels "
        + json.dumps([(k, round(v, 3)) for k, v in top]))
    log(f"[{CARD}] 13a GIL: another thread ran Python for "
        f"{rec['gil_free_share']:.3f} of a decode chunk (graph replays and "
        f"the chunk's readback) relative to an idle interval")

    # (b) packed admission is order-free on the card
    a, b = (it.req for it in items[4:6])
    ab, ba = _collect(eng_s, [a, b]), _collect(eng_s, [b, a])
    if ab != ba:
        packed_op_report(model, params, a, b)
    assert ab == ba, "admit_packed([a, b]) != admit_packed([b, a])"
    log(f"[{CARD}] 13b admit_packed([a, b]) == ([b, a]) bit for bit "
        f"({len(a.prompt)}-token prompts)")
    rec["http"] = http_phase(model, params, eng_p, items, want[True])
    rec["cli"] = cli_phase()
    log("serve " + json.dumps(rec))
    return launches


# ---------------------------- phase 14: the other configs at full width
# (arch, layers run, Engine prompt): every config at its full width, the
# depth cut where the bf16 weights would not fit one 80 GB card beside the
# caches (GB at full depth: gemma-7b 17.1, qwen3-14b 29.5, qwen1.5-110b
# 222, dbrx-132b 263, llava-next-34b 68.8, qwen3-moe-235b-a22b 470).  The
# MoE prompts have a large divisor (gs = 512 at 2048 tokens): a prime
# length makes every token a group of its own (ROADMAP D).
P14_CONFIGS = (("gemma-7b", 28, 2055), ("qwen3-14b", 40, 2055),
               ("qwen1.5-110b", 16, 2055), ("dbrx-132b", 8, 2048),
               ("llava-next-34b", 48, 2055),
               ("qwen3-moe-235b-a22b", 10, 2048))
P14_NEW = 32
P14_S_MAX = 2304  # 1152 patches + 1024 tokens + 16 new, W-aligned, and room
P14_BATCH_ARCHS = ("gemma-7b", "qwen3-14b", "dbrx-132b",
                   "qwen3-moe-235b-a22b")
P14_BATCH_PROMPTS, P14_BATCH_NEW = (512, 2048, 2055, 1024), 16
P14_PATCH_TOKENS, P14_PATCH_NEW = 1024, 16
P14_PROFILE_STEPS, P14_NO_SYNC_STEPS, P14_SPEC_NEW = 4, 8, 16


def _p14_prompt(vocab, n):
    """``serve``'s prompt of ``n`` tokens (the same seed), on the card."""
    g = torch.Generator(device="cuda").manual_seed(SEED + n)
    return torch.randint(0, vocab, (1, n), generator=g, device="cuda")


class _DropLog:
    """Wraps a MoE model's ``prefill`` and ``prefill_chunk``: each call
    records (its tokens, its dropped (token, expert) pairs), read back after
    the prefill (no graph captures a prefill)."""

    def __init__(self, model):
        from repro_torch.models import moe

        self.calls = []
        for name in ("prefill", "prefill_chunk"):
            def logged(params, tokens, *a, _fn=getattr(model, name), **k):
                moe.drop_log = []
                try:
                    out = _fn(params, tokens, *a, **k)
                finally:
                    got, moe.drop_log = moe.drop_log, None
                self.calls.append((tokens.numel(), int(sum(got))))
                return out
            setattr(model, name, logged)

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


class _Routes:
    """While open, records each ``moe_apply``'s router probabilities and
    chosen experts, copied to the host (so eager runs only)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        top_k = self.orig = self.moe.top_k

        def recording(probs, k):
            vals, idx = top_k(probs, k)
            self.calls.append((probs.float().cpu(), idx.cpu()))
            return vals, idx

        self.moe.top_k = recording
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.orig
        return False


def _route_split(a, b, n_layers):
    """The first forward pass (0: the prefill; i: the step that scores
    token i) in which two runs' routers (``_Routes.calls``) choose another
    expert or order for some token, and how near a tie it was in run
    ``a``: the largest (p_j - p_{j+1}) / p_max over the tokens that part,
    j their first differing rank.  (None, 0.0) if they never part."""
    for c, ((pa, ia), (_, ib)) in enumerate(zip(a, b)):
        rows = (ia != ib).any(-1)
        if not rows.any():
            continue
        p = pa.sort(-1, descending=True).values[rows]
        j = (ia != ib)[rows].int().argmax(-1)  # first differing rank
        gap = (p.gather(-1, j[:, None]) - p.gather(-1, j[:, None] + 1))[:, 0]
        return c // n_layers, float((gap / p[:, 0]).max())
    return None, 0.0


def _p14_profile(eng, params, cache, tok, steps=P14_PROFILE_STEPS) -> dict:
    """Graph replays of a served request under torch.profiler (device busy
    ms a step), then as many again timed by CUDA events: the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        toks, cache = eng.decode(params, tok, cache, steps)
        torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    a.record()
    eng.decode(params, toks[:, -1:], cache, steps)
    b.record()
    torch.cuda.synchronize()
    ev = a.elapsed_time(b) / steps
    us = _kernel_us(prof)
    busy = sum(us.values()) / 1e3 / steps
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    return dict(events_ms_per_step=ev, device_busy_ms_per_step=busy,
                idle_share=1 - busy / ev,
                top_kernels_ms_per_step=[(k[:60], v / 1e3 / steps)
                                         for k, v in top],
                own_kernels_ms_per_step=_own_ms(us, steps))


def _first_divergence(a, b) -> int:
    """Tokens two streams share before they part (their length if equal)."""
    a, b = list(a), list(b)
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def p14_engine(model, params, arch, prompt_len, launches) -> dict:
    """``Engine`` at batch 1: KERNEL under the graph (counted, profiled;
    a MoE replays inside ``set_sync_debug_mode("error")``), the eager
    loop (graph == eager) and GATHER (KERNEL vs GATHER)."""
    kw = dict(new_tokens=P14_NEW, s_max=P14_S_MAX)
    _zero_counters()
    row, t_k, l_k, eng, cache = serve(model, params, "int4-srft", "kernel",
                                      prompt_len, keep=True, **kw)
    launches[f"p14_{arch}_engine"] = c = _counters()
    assert c["srft_quant"] > 0 and c["quant_decode_attention"] > 0, c
    tok = t_k[:, -1:].cuda()
    prof = _p14_profile(eng, params, cache, tok)
    if model.cfg.moe is not None:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, cache = eng.decode(params, tok, cache, P14_NO_SYNC_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert out.shape == (1, P14_NO_SYNC_STEPS)
        log(f"  14 {arch}: no host sync in {P14_NO_SYNC_STEPS} MoE graph "
            f"replays under set_sync_debug_mode('error')")
    del eng, cache
    moe = model.cfg.moe is not None
    with _Routes() as r_k:
        row_e, t_e, l_e = serve(model, params, "int4-srft", "kernel",
                                prompt_len, graph=False, **kw)
    _graph_agrees((t_e, l_e), (t_k, l_k), f"14 {arch} int4-srft/kernel")
    row_g, t_g, l_g = serve(model, params, "int4-srft", "gather", prompt_len,
                            **kw)
    split, margin, n = None, 0.0, P14_NEW
    if moe:
        # a MoE's router turns the reads' rounding into another expert at
        # a near-tie, after which the runs part by more than LOGIT_TOL:
        # compare up to the first pass where the eager runs route apart,
        # which must be a near-tie (gap below LOGIT_TOL of the top
        # probability, the rule tokens follow)
        with _Routes() as r_g:
            _, t_g, l_g = serve(model, params, "int4-srft", "gather",
                                prompt_len, graph=False, **kw)
        t_k, l_k = t_e, l_e
        split, margin = _route_split(r_k.calls, r_g.calls,
                                     model.cfg.n_layers)
        assert split is None or margin < LOGIT_TOL, (
            f"14 {arch}: GATHER vs KERNEL route apart at pass {split} off a "
            f"near-tie (gap {margin:.3e} of the top probability)")
        n = P14_NEW if split is None else max(split, 1)
    n_same = _agree_until(t_k[:, :n], t_g[:, :n], l_k[:, :n])
    err = (l_k[:, :n_same] - l_g[:, :n_same]).abs().max().item()
    tol = LOGIT_TOL * l_k.abs().max().item()
    assert err <= tol, f"14 {arch}: GATHER vs KERNEL logits {err} > {tol}"
    log(f"  14 {arch}: GATHER vs KERNEL max logit diff {err:.3e} (tol "
        f"{tol:.3e}), tokens agree for {n_same}/{P14_NEW} steps"
        + (f"; the routers part first at pass {split} (a near-tie: gap "
           f"{margin:.3e} of the top probability)" if split is not None
           else "; the routers never part" if moe else ""))
    return dict(kernel=row, eager=row_e, gather=row_g, profile=prof,
                gather_agree=n_same, gather_err=err, route_split=split,
                route_margin=margin, tokens=t_k)


def p14_batch(model, params, arch, launches, drops) -> dict:
    """``BatchEngine`` (capacity 4, pages of 16), paged and dense: equal
    streams (no row shares a page), every page back (``serve_batch``);
    for a MoE (``drops``, its ``_DropLog``) also chunked admission, with
    each run's dropped pairs."""
    from repro_torch.launch.batch_engine import Request

    vocab = model.cfg.vocab_size
    reqs = [Request(i, _p14_prompt(vocab, n)[0].cpu().numpy(), P14_BATCH_NEW)
            for i, n in enumerate(P14_BATCH_PROMPTS)]
    out, rep = {}, {}
    for paged in (True, False):
        layout = "paged" if paged else "dense"
        _zero_counters()
        _, done, rep[layout] = serve_batch(model, params, "int4-srft",
                                           "kernel", paged, reqs,
                                           s_max=P14_S_MAX)
        launches[f"p14_{arch}_batch_{layout}"] = c = _counters()
        read = "quant_decode_attention" + ("_paged" if paged else "")
        assert c["srft_quant"] > 0 and c[read] > 0, c
        out[layout] = {rid: list(cp.tokens) for rid, cp in done.items()}
        if drops is not None:
            rep[layout]["moe_drops"] = drops.take()
    assert out["paged"] == out["dense"], f"14 {arch}: paged != dense"
    res = dict(paged=rep["paged"], dense=rep["dense"],
               tokens_dense=out["dense"])
    log(f"[{CARD}] 14 {arch} BatchEngine (capacity {CAPACITY}, prompts "
        f"{list(P14_BATCH_PROMPTS)}, {P14_BATCH_NEW} new): paged == dense "
        f"for {len(reqs)}/{len(reqs)} streams, every page back; ms/step "
        f"paged {rep['paged']['decode_ms_per_step']:.3f} / dense "
        f"{rep['dense']['decode_ms_per_step']:.3f} (events, graph); "
        f"launches paged {launches[f'p14_{arch}_batch_paged']}, dense "
        f"{launches[f'p14_{arch}_batch_dense']}")
    if drops is None:
        return res
    _zero_counters()
    _, done, rep_c = serve_batch(
        model, params, "int4-srft", "kernel", False, reqs, s_max=P14_S_MAX,
        prefill_chunk=PREFILL_CHUNK, prefill_budget=PREFILL_BUDGET)
    launches[f"p14_{arch}_batch_chunked"] = _counters()
    rep_c["moe_drops"] = drops.take()
    chunked = {rid: list(cp.tokens) for rid, cp in done.items()}
    res["chunked"] = rep_c
    res["chunked_agree"] = {rid: _first_divergence(out["dense"][rid], t)
                            for rid, t in chunked.items()}
    return res


def p14_moe_report(model, params, arch, prompt_len, batch, t_alone,
                   drops, engine_drops) -> dict:
    """MoE rows are coupled through routing groups: chunked against
    monolithic, the batch row against the same request alone, spec against
    plain, with the dropped (token, expert) pairs of each side's prefills;
    printed, not gated."""
    from repro_torch.launch.engine import Engine

    row = P14_BATCH_PROMPTS.index(prompt_len)
    dense = batch["dense"]
    alone = t_alone[0, :P14_BATCH_NEW].tolist()
    cache = model.init_cache(1, P14_S_MAX, policy="int4-srft", ragged=True,
                             generator=torch.Generator().manual_seed(SEED))
    toks_s, _, st = Engine(model, backend="kernel").generate_spec(
        params, _p14_prompt(model.cfg.vocab_size, prompt_len), cache,
        P14_SPEC_NEW, spec_k=SPEC_K)
    spec_drops = drops.take()
    rec = dict(
        chunked_vs_monolithic=batch["chunked_agree"],
        batched_vs_alone=_first_divergence(batch["tokens_dense"][row],
                                           alone),
        spec_vs_plain=_first_divergence(toks_s[0].tolist(),
                                        t_alone[0, :P14_SPEC_NEW].tolist()),
        spec_stats=st,
        drops=dict(engine=engine_drops, spec=spec_drops,
                   batch_paged=batch["paged"]["moe_drops"],
                   batch_dense=dense["moe_drops"],
                   batch_chunked=batch["chunked"]["moe_drops"]))
    log(f"[{CARD}] 14 {arch} MoE, reported (not gated): tokens shared "
        f"before parting: chunked vs monolithic by request "
        f"{rec['chunked_vs_monolithic']} of {P14_BATCH_NEW}; the "
        f"{prompt_len}-token request batched vs alone "
        f"{rec['batched_vs_alone']}/{P14_BATCH_NEW}; spec (k = {SPEC_K}) "
        f"vs plain {rec['spec_vs_plain']}/{P14_SPEC_NEW} (acceptance "
        f"{st['accepted']}/{st['drafted']})")
    log(f"  14 {arch} dropped (token, expert) pairs, (tokens, dropped) per "
        f"prefill: " + json.dumps(rec["drops"]))
    return rec


def p14_serve(model, params, arch, launches, drops) -> dict:
    """Phase 13's closed-loop trace (packed prefills of k x L tokens, so a
    MoE routes k prompts as one group) through ``SyncServer`` and
    ``ServingPipeline``, paged: every stream equal bit for bit."""
    from repro_torch.launch.server import make_trace

    items = make_trace(SERVE_N, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
                       run_len=SERVE_RUN, arrival="closed")
    sync, wall_s, _ = sync_replay(serve_engine(model, params, True), items)
    sync_drops = drops.take() if drops is not None else None
    eng_p = serve_engine(model, params, True)
    _zero_counters()
    piped, wall_p, metrics, trace, (_, ev_ms) = pipe_replay(eng_p, items)
    launches[f"p14_{arch}_serve"] = c = _counters()
    assert piped == sync, f"14 {arch}: pipelined != sync"
    assert all(r == "length" and len(t) == SERVE_NEW for t, r in sync.values())
    assert c["srft_quant"] > 0 and c["quant_decode_attention_paged"] > 0, c
    assert eng_p.pool_stats()["pages_used"] == 0
    packed = [e["dur"] / 1e3 for e in trace.export()["traceEvents"]
              if e["name"] == "prefill.packed"]
    rec = dict(sync_s=wall_s, pipelined_s=wall_p, pipelined_events_ms=ev_ms,
               packed_prefill_host_ms=packed,
               moe_drops=dict(sync=sync_drops, pipelined=drops.take())
               if drops is not None else None, **_latency_ms(metrics))
    log(f"[{CARD}] 14 {arch} serving: pipelined == sync bit for bit "
        f"({SERVE_N} streams, paged), sync {wall_s:.3f} s, pipelined "
        f"{wall_p:.3f} s; packed prefill host ms "
        f"{[round(x, 1) for x in packed]}; launches {c}; MoE drops "
        f"(tokens, dropped) per packed prefill "
        f"{json.dumps(rec['moe_drops'])}")
    return rec


def p14_patches(model, params, arch, launches) -> dict:
    """A vlm prompt of ``n_patches`` random patch embeddings (scaled like
    the embeddings) then P14_PATCH_TOKENS tokens through ``LM.prefill``,
    then P14_PATCH_NEW - 1 eager decode steps, KERNEL (counted) against
    GATHER within LOGIT_TOL."""
    from repro_torch.launch.engine import Engine

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    patches = (torch.randn((1, cfg.n_patches, cfg.d_model), generator=g,
                           device="cuda") * 0.02).to(torch.bfloat16)
    prompt = _p14_prompt(cfg.vocab_size, P14_PATCH_TOKENS)
    res = {}
    for backend in ("kernel", "gather"):
        cache = model.init_cache(1, P14_S_MAX, policy="int4-srft",
                                 ragged=True,
                                 generator=torch.Generator().manual_seed(SEED))
        _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, prompt, cache, patches=patches)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        assert int(cache["pos"][0]) == cfg.n_patches + P14_PATCH_TOKENS
        tok0 = lg[:, -1].argmax(-1)[:, None]
        toks, logits, cache = Engine(model, backend=backend, graph=False
                                     ).decode(params, tok0, cache,
                                              P14_PATCH_NEW - 1,
                                              return_logits=True)
        torch.cuda.synchronize()
        if backend == "kernel":
            launches[f"p14_{arch}_patches"] = c = _counters()
            assert c["srft_quant"] > 0 and c["quant_decode_attention"] > 0
        all_l = torch.cat([lg[:, -1:].float(), logits], 1).cpu()
        assert torch.isfinite(all_l).all()
        res[backend] = (torch.cat([tok0, toks], 1).cpu(), all_l, pre_ms)
    (t_k, l_k, pre_k), (t_g, l_g, _) = res["kernel"], res["gather"]
    n_same = _agree_until(t_k, t_g, l_k)
    err = (l_k[:, :n_same] - l_g[:, :n_same]).abs().max().item()
    tol = LOGIT_TOL * l_k.abs().max().item()
    assert err <= tol, f"14 {arch} patches: GATHER vs KERNEL {err} > {tol}"
    log(f"[{CARD}] 14 {arch}: prefill of {cfg.n_patches} patches + "
        f"{P14_PATCH_TOKENS} tokens {pre_k:.1f} ms (host, synchronized), "
        f"{P14_PATCH_NEW} eager steps: GATHER vs KERNEL max logit diff "
        f"{err:.3e} (tol {tol:.3e}), tokens agree for {n_same}/"
        f"{P14_PATCH_NEW}; launches {launches[f'p14_{arch}_patches']}")
    return dict(prefill_ms=pre_k, gather_agree=n_same, gather_err=err)


def p14_model(arch, depth, prompt_len) -> tuple[dict, dict]:
    """Phase 14 for one config (see the module doc): (launches by path,
    record).  The model is freed when this returns."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg)
    params = model.init(model.generator(SEED))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    rec = dict(arch=arch, family=cfg.family, layers=depth,
               full_layers=full.n_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
               G=cfg.n_heads // cfg.n_kv_heads, head_dim=cfg.head_dim,
               params_b=sum(t.numel() for t in leaves) / 1e9,
               weight_gb=sum(t.numel() * t.element_size()
                             for t in leaves) / 1e9,
               init_s=time.perf_counter() - t_start)
    del leaves
    log(f"14 {arch}: {depth}/{full.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {rec['heads']} (G {rec['G']}, d {cfg.head_dim}), "
        f"{rec['params_b']:.2f}B params, {rec['weight_gb']:.1f} GB bf16, "
        f"init {rec['init_s']:.1f} s")
    drops = _DropLog(model) if cfg.moe is not None else None
    launches, secs = {}, {}
    t0 = time.perf_counter()
    eng = p14_engine(model, params, arch, prompt_len, launches)
    secs["engine"] = time.perf_counter() - t0
    t_alone = eng.pop("tokens")
    rec["engine"] = eng
    engine_drops = drops.take() if drops is not None else None
    k, prof = eng["kernel"], eng["profile"]
    log(f"[{CARD}] 14 {arch} Engine, {prompt_len} + {P14_NEW} tokens, "
        f"int4-srft KERNEL, graph: {k['decode_ms_per_tok']:.3f} ms/token "
        f"(events; eager {eng['eager']['decode_ms_per_tok']:.3f}, GATHER "
        f"graph {eng['gather']['decode_ms_per_tok']:.3f}), prefill "
        f"{k['prefill_ms']:.1f} ms, capture {k['capture_s']:.3f} s, cache "
        f"{k['cache_bytes']} B (compression {k['compression']:.4f}); one "
        f"profiled replay: device busy {prof['device_busy_ms_per_step']:.3f}"
        f" of {prof['events_ms_per_step']:.3f} ms a step, idle share "
        f"{prof['idle_share']:.3f}; launches {launches[f'p14_{arch}_engine']}"
        + (f"; MoE drops (tokens, dropped) {engine_drops}"
           if drops is not None else ""))
    log("14 engine " + json.dumps(dict(arch=arch, **{
        m: eng[m] for m in ("kernel", "eager", "gather", "profile")})))
    if arch in P14_BATCH_ARCHS:
        t0 = time.perf_counter()
        batch = p14_batch(model, params, arch, launches, drops)
        rec["batch"] = {k: v for k, v in batch.items() if k != "tokens_dense"}
        secs["batch"] = time.perf_counter() - t0
        if drops is not None:
            t0 = time.perf_counter()
            rec["moe"] = p14_moe_report(model, params, arch, prompt_len,
                                        batch, t_alone, drops, engine_drops)
            secs["moe_spec"] = time.perf_counter() - t0
    if arch == "dbrx-132b":
        t0 = time.perf_counter()
        rec["serve"] = p14_serve(model, params, arch, launches, drops)
        secs["serve"] = time.perf_counter() - t0
    if cfg.family == "vlm":
        t0 = time.perf_counter()
        rec["patches"] = p14_patches(model, params, arch, launches)
        secs["patches"] = time.perf_counter() - t0
    rec["step_seconds"] = secs
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t_start
    log(f"[{CARD}] 14 {arch}: peak allocated {rec['peak_gb']:.1f} GB, "
        f"{rec['seconds']:.1f} s")
    del model, params, drops
    return launches, rec


def _p14_summary(rec) -> dict:
    """The numbers of one config's record that PERF.md quotes."""
    eng = rec["engine"]
    out = {k: rec[k] for k in ("arch", "layers", "full_layers", "G",
                               "head_dim", "weight_gb", "init_s", "peak_gb",
                               "seconds", "step_seconds")}
    out.update({f"{m}_ms_per_tok": eng[m]["decode_ms_per_tok"]
                for m in ("kernel", "eager", "gather")},
               prefill_ms=eng["kernel"]["prefill_ms"],
               capture_s=eng["kernel"]["capture_s"],
               cache_bytes=eng["kernel"]["cache_bytes"],
               compression=eng["kernel"]["compression"],
               busy_ms_per_step=eng["profile"]["device_busy_ms_per_step"],
               idle_share=eng["profile"]["idle_share"],
               own_kernels_ms_per_step=eng["profile"][
                   "own_kernels_ms_per_step"],
               gather_agree=eng["gather_agree"], gather_err=eng["gather_err"],
               route_split=eng["route_split"],
               route_margin=eng["route_margin"])
    if "batch" in rec:
        out["batch_ms_per_step"] = {
            k: v["decode_ms_per_step"] for k, v in rec["batch"].items()
            if isinstance(v, dict) and "decode_ms_per_step" in v}
    for k in ("moe", "serve", "patches"):
        if k in rec:
            out[k] = rec[k]
    return out


def p14_phase() -> dict:
    """Phase 14 (see the module doc): the small G = 16 MoE against the
    CPU, then each config of P14_CONFIGS, one resident at a time.  Returns
    launches by path."""
    from repro_torch.configs import get_config, reduced

    from repro_torch.models import common

    small = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                                n_heads=16, n_kv_heads=1)
    # fp32 operands: with bf16 products the card's and the CPU's roundings
    # differ, and a random router's near-ties flip experts on that alone
    # (on an H100 a token parted at step 15 with a top-2 logit gap of
    # 0.76); the full-width configs below run on bf16 operands
    with common.dot_mode(False):
        small_reference_phase(small, "reduced qwen3-moe, 16 query heads "
                              "over 1 KV head, fp32 operands",
                              (("int4-srft", "kernel"),))
    launches = {}
    for arch, depth, prompt_len in P14_CONFIGS:
        _free_cuda()
        got, rec = p14_model(arch, depth, prompt_len)
        launches.update(got)
        log("14 summary " + json.dumps(_p14_summary(rec)))
    _free_cuda()
    return launches

# ------------------------- phase 15: the hybrid, ssm and audio families
# (arch, prompt tokens, audio frames): each at its full width and depth
# (bf16 weights: zamba2-7b ~13.5 GB, xlstm-1.3b ~6.7, whisper ~3.4); the
# prompts are a multiple of the SSD chunk (256), which Mamba2 needs, and
# of the xlstm chunk (64), which selects the chunkwise mLSTM
P15_CONFIGS = (("zamba2-7b", 2048, None), ("xlstm-1.3b", 2048, None),
               ("whisper-large-v3", 256, 1500))
P15_NEW = 32
P15_SMALL = (("zamba2-7b", 32), ("xlstm-1.3b", 32), ("whisper-large-v3", 32))
P15_SMALL_FRAMES, P15_SMALL_NEW = 40, 24
P15_SERVE_CLI = ("--smoke", "--max-batch", "2", "--requests", "2",
                 "--prompt-len", "64", "--new-tokens", "8", "--policy",
                 "int4-srft", "--backend", "kernel")
P15_TRAIN_ARGV = ("--smoke", "--steps", "2", "--batch", "2", "--seq", "64",
                  "--log-every", "1")
P15_DIR = ROOT / "build" / "phase15"  # a checkpoint, deleted after use


def _p15_prompt(model, n_tokens, n_frames, device="cuda"):
    """The seeded prompt: tokens (1, n), with (1, n_frames, d_model) stub
    frame embeddings first for the audio family."""
    g = torch.Generator().manual_seed(SEED + n_tokens)
    toks = torch.randint(0, model.cfg.vocab_size, (1, n_tokens),
                         generator=g).to(device)
    if n_frames is None:
        return toks
    frames = torch.randn((1, n_frames, model.cfg.d_model), generator=g)
    return (frames.to(device), toks)


def _p15_cache(model, prompt, new, policy, ragged=True):
    n = prompt[-1].shape[1] if isinstance(prompt, tuple) else prompt.shape[1]
    s_max = n + new + 16
    s_max += (-s_max) % 16
    gen = torch.Generator().manual_seed(SEED)
    if isinstance(prompt, tuple):
        return model.init_cache(1, s_max, prompt[0].shape[1], policy=policy,
                                ragged=ragged, generator=gen)
    return model.init_cache(1, s_max, policy=policy, ragged=ragged,
                            generator=gen)


def _kv_states(cache) -> list:
    return list(cache.get("attn", ())) + list(cache.get("self", ())) + \
        list(cache.get("cross", ()))


def p15_serve(model, params, prompt, backend, graph=True, keep=False,
              new=P15_NEW, policy="int4-srft"):
    """``serve`` for any family: one request through ``Engine`` on a cache
    that keeps its lengths on the device; the first decode call makes one
    step (a capture under the graph), the other ``new`` - 2 are timed by
    CUDA events.  Returns (row, tokens, logits) [+ (engine, cache)]."""
    from repro_torch.launch.engine import GRAPH_KEY, Engine

    cache = _p15_cache(model, prompt, new, policy)
    eng = Engine(model, backend=backend, graph=graph)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = eng.prefill(params, prompt, cache)
    tok = lg[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok1, l1, cache = eng.decode(params, tok, cache, 1, return_logits=True)
    torch.cuda.synchronize()
    a.record()
    toks, step_logits, cache = eng.decode(params, tok1, cache, new - 2,
                                          return_logits=True)
    b.record()
    torch.cuda.synchronize()
    toks = torch.cat([tok, tok1, toks], dim=1)
    logits = torch.cat([lg[:, -1:].float(), l1, step_logits], dim=1)
    assert torch.isfinite(logits).all(), "non-finite logits"
    n = prompt[-1].shape[1] if isinstance(prompt, tuple) else prompt.shape[1]
    assert int(cache["pos"][0]) == n + new - 1
    kv = _kv_states(cache)
    rec_bytes = sum(t.numel() * t.element_size()
                    for st in getattr(model, "recurrent_states",
                                      lambda c: [])(cache) for t in st)
    row = dict(backend=backend or "gather", graph=graph,
               prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_tok=a.elapsed_time(b) / (new - 2),
               capture_s=cache[GRAPH_KEY].step.capture_s if graph else None,
               kv_cache_bytes=sum(st.nbytes() for st in kv),
               recurrent_state_bytes=rec_bytes,
               compression=(kv[0].policy.compression_ratio(kv[0])
                            if kv else None))
    out = (row, toks.cpu(), logits.cpu())
    return out + (eng, cache) if keep else out


def p15_small():
    """(a): each reduced config on the card (graph) against the CPU plain
    path, fp32 operands; xlstm also on fp32 activations."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import Engine
    from repro_torch.models import build_model, common

    for arch, n in P15_SMALL:
        cfg = reduced(get_config(arch))
        if cfg.head_dim % 8:
            # B1 reads d % 8 == 0: reduced zamba2's d 28 becomes the full
            # config's d 112 (kv_group 28 again)
            cfg = dataclasses.replace(cfg, head_dim=112).validated()
        frames = P15_SMALL_FRAMES if cfg.family == "audio" else None
        saved = common.COMPUTE_DTYPE
        if cfg.family == "ssm":
            common.COMPUTE_DTYPE = torch.float32
        try:
            res = {}
            cpu = build_model(cfg, device="cpu")
            params = cpu.init(cpu.generator(SEED))
            for name, model, p in (("cpu", cpu, params),
                                   ("cuda", build_model(cfg),
                                    _to(params, "cuda"))):
                prompt = _p15_prompt(model, n, frames, model.device)
                cache = _p15_cache(model, prompt, P15_SMALL_NEW, None)
                res[name] = Engine(model, backend="kernel").generate(
                    p, prompt, cache, P15_SMALL_NEW, return_logits=True)
        finally:
            common.COMPUTE_DTYPE = saved
        lc, lg = res["cpu"][1], res["cuda"][1].cpu()
        assert torch.isfinite(lg).all()
        n_same = _agree_until(res["cpu"][0], res["cuda"][0].cpu(), lc)
        err = (lc[:, :n_same] - lg[:, :n_same]).abs().max().item()
        tol = LOGIT_TOL * lc.abs().max().item()
        assert err <= tol, f"15a {arch}: card vs CPU {err} > {tol}"
        log(f"15a reduced {arch} ({cfg.family}; {n} tokens"
            + (f" + {frames} frames" if frames else "") + f", "
            f"{P15_SMALL_NEW} new, "
            + ("no KV cache, fp32 activations" if cfg.family == "ssm" else
               f"int4-srft KERNEL, d {cfg.head_dim} group {cfg.kv_group}")
            + f"): card (graph) vs CPU plain max logit err {err:.3e} (tol "
            f"{tol:.3e}), tokens agree for {n_same}/{P15_SMALL_NEW} steps")


def p15_model(arch, prompt_len, n_frames, launches) -> dict:
    """(b) for one config: the graph run counted and profiled, the eager
    loop (graph == eager) and, with a KV cache, GATHER (KERNEL vs
    GATHER)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(model.generator(SEED))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    rec = dict(arch=arch, family=cfg.family, layers=cfg.n_layers,
               encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
               head_dim=cfg.head_dim, kv_group=cfg.kv_group,
               attn_layers=getattr(model, "n_attn_layers", 2 * cfg.n_layers),
               params_b=sum(t.numel() for t in leaves) / 1e9,
               weight_gb=sum(t.numel() * t.element_size()
                             for t in leaves) / 1e9,
               init_s=time.perf_counter() - t_start, prompt=prompt_len,
               frames=n_frames)
    del leaves
    log(f"15 {arch}: {cfg.n_layers} layers"
        + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, heads {rec['heads']} (d "
        f"{cfg.head_dim}, kv_group {cfg.kv_group}), {rec['params_b']:.2f}B "
        f"params, {rec['weight_gb']:.1f} GB bf16, init {rec['init_s']:.1f} s")
    prompt = _p15_prompt(model, prompt_len, n_frames)
    kv = cfg.kv_applicable
    backend = "kernel" if kv else None
    _zero_counters()
    row, t_k, l_k, eng, cache = p15_serve(model, params, prompt, backend,
                                          keep=True)
    launches[f"p15_{arch}_engine"] = c = _counters()
    if kv:
        assert c["srft_quant"] > 0 and c["quant_decode_attention"] > 0, c
    else:
        assert not any(c.values()), c
    rec["profile"] = _p14_profile(eng, params, cache, t_k[:, -1:].cuda())
    del eng, cache
    rec["kernel"] = row
    row_e, t_e, l_e = p15_serve(model, params, prompt, backend, graph=False)
    rec["eager"] = row_e
    _graph_agrees((t_e, l_e), (t_k, l_k), f"15 {arch}")
    if kv:
        row_g, t_g, l_g = p15_serve(model, params, prompt, "gather")
        rec["gather"] = row_g
        n_same = _agree_until(t_k, t_g, l_k)
        err = (l_k[:, :n_same] - l_g[:, :n_same]).abs().max().item()
        tol = LOGIT_TOL * l_k.abs().max().item()
        assert err <= tol, f"15 {arch}: GATHER vs KERNEL {err} > {tol}"
        rec["gather_agree"], rec["gather_err"] = n_same, err
        log(f"  15 {arch}: GATHER vs KERNEL max logit diff {err:.3e} (tol "
            f"{tol:.3e}), tokens agree for {n_same}/{P15_NEW} steps")
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t_start
    prof = rec["profile"]
    log(f"[{CARD}] 15 {arch} Engine, {prompt_len} tokens"
        + (f" + {n_frames} frames" if n_frames else "")
        + f" + {P15_NEW} new, graph: {row['decode_ms_per_tok']:.3f} ms/token"
        f" (events; eager {row_e['decode_ms_per_tok']:.3f}"
        + (f", GATHER {rec['gather']['decode_ms_per_tok']:.3f}" if kv
           else "") + f"), prefill {row['prefill_ms']:.1f} ms, capture "
        f"{row['capture_s']:.3f} s, device busy "
        f"{prof['device_busy_ms_per_step']:.3f} of "
        f"{prof['events_ms_per_step']:.3f} ms a step (idle "
        f"{prof['idle_share']:.3f}), peak {rec['peak_gb']:.1f} GB, KV cache "
        f"{row['kv_cache_bytes']} B, recurrent state "
        f"{row['recurrent_state_bytes']} B, compression "
        f"{row['compression']}; launches {c}; {rec['seconds']:.1f} s")
    del model, params
    return rec


def _p15_cli(arch, *extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         *P15_SERVE_CLI, *extra], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)


def p15_cli_and_train() -> dict:
    """(c) the serve CLI's single-stream path in subprocesses; (d) two
    training steps of each ``--smoke`` and the hybrid's checkpoint."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.optim.adam import tree_leaves

    out = {}
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        t0 = time.perf_counter()
        r = _p15_cli(arch)
        assert r.returncode == 0, f"15c serve {arch}: {r.stderr[-2000:]}"
        lines = [ln for ln in r.stdout.splitlines() if "decode:" in ln]
        assert lines and "one CUDA graph per step" in r.stdout, r.stdout
        out[f"serve_{arch}_s"] = time.perf_counter() - t0
        log(f"15c serve CLI {arch} --smoke: exit 0 in "
            f"{out[f'serve_{arch}_s']:.1f} s; {lines[0].strip()}")
    r = _p15_cli("zamba2-7b", "--spec-k", "4")
    assert r.returncode != 0 and "--spec-k requires" in r.stderr, r.stderr
    log(f"15c serve CLI zamba2-7b --spec-k 4: exit {r.returncode}, "
        f"{r.stderr.strip().splitlines()[-1][:100]}...")
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        losses = []
        shutil.rmtree(P15_DIR, ignore_errors=True)
        argv = ["--arch", arch, *P15_TRAIN_ARGV]
        if arch == "zamba2-7b":
            argv += ["--ckpt-dir", str(P15_DIR)]
        state = train.main(argv, on_step=lambda s, m: losses.append(
            float(m["loss"])))
        assert len(losses) == 2 and all(map(math.isfinite, losses)), losses
        out[f"train_{arch}_losses"] = losses
        log(f"15d train CLI {arch} --smoke on the card: losses {losses}")
        if arch == "zamba2-7b":
            mgr = CheckpointManager(str(P15_DIR))
            got, _ = mgr.restore(mgr.latest_step(), state)
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(state)))
            assert same, "15d hybrid checkpoint differs"
            n = len(tree_leaves(state))
            log(f"15d hybrid (params, opt) checkpoint: {n} leaves restored "
                f"bit for bit")
            shutil.rmtree(P15_DIR, ignore_errors=True)
        del state
    return out


def p15_phase() -> dict:
    """Phase 15 (see the module doc).  Returns launches by path."""
    from repro_torch.models import common

    t0 = time.perf_counter()
    with common.dot_mode(False):
        p15_small()
    log(f"15a {time.perf_counter() - t0:.1f}s")
    launches = {}
    for arch, n, frames in P15_CONFIGS:
        _free_cuda()
        rec = p15_model(arch, n, frames, launches)
        log("15 summary " + json.dumps(rec))
    _free_cuda()
    t0 = time.perf_counter()
    cli = p15_cli_and_train()
    log(f"15 cli and train {time.perf_counter() - t0:.1f}s " +
        json.dumps(cli))
    _free_cuda()
    return launches


# ----------------------------------------- phase 16: sharded serving (A12a)

P16_MESHES = (2, 8)  # 'model' sizes; internlm2-1.8b has 8 KV heads
# phase 13's prompt range (256-512 tokens), ragged, with phase 7's new
# tokens; two sharers of a page-aligned prefix are submitted first
P16_PROMPTS, P16_PREFIX = (259, 317, 389, 509), 256
P16_S_MAX = 576  # the longest prompt and its new tokens, tile-aligned
P16_ENGINE_PROMPT, P16_ENGINE_NEW = 509, 32
P16_EAGER_NEW = 8  # the eager run's tokens, held to the graph run's first
# (policy, backend, layout, m): the unsharded reference runs the same
# backend; an int4 KERNEL read runs B1 / B2 on each shard's heads
P16_RUNS = (("int4-srft", "kernel", False, 2),
            ("int4-srft", "kernel", True, 2),
            ("int4-srft", "kernel", False, 8),
            ("int4-srft", "kernel", True, 8),
            ("bf16", None, False, 2), ("bf16", None, True, 2),
            ("int8-per-token", None, False, 2))
P16_CLI = ("--smoke", "--max-batch", "2", "--requests", "2",
           "--prompt-len", "64", "--new-tokens", "8")


def _p16_mesh(m, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    dims = (1, m) if len(axes) == 2 else (m,)
    return make_mesh(dims, axes, devices=["cuda:0"] * m)


def p16_requests(vocab):
    """Two sharers of a P16_PREFIX-token page-aligned prefix, then four
    ragged requests of 259-509 tokens."""
    from repro_torch.launch.batch_engine import Request

    g = torch.Generator().manual_seed(SEED + 16)
    prefix = torch.randint(0, vocab, (P16_PREFIX,), generator=g)
    reqs = [Request(i, torch.cat([prefix, torch.randint(
        0, vocab, (SHARER_TAIL,), generator=g)]).numpy(), SHARER_NEW)
        for i in range(2)]
    reqs += [Request(2 + i, torch.randint(0, vocab, (n,), generator=g)
                     .numpy(), m)
             for i, (n, m) in enumerate(zip(P16_PROMPTS, BATCH_NEW))]
    return reqs


def _p16_flat(states) -> list:
    """Every layer's leaves, gathered from the shards, copied:
    [(path, tensor), ...] a layer."""
    from repro_torch.launch import partitioning as pt
    from repro_torch.launch import sharded_cache as sc

    return [[(p, t.clone()) for p, t in
             pt.flatten_with_path(sc.gather_state(st))] for st in states]


def _p16_same_leaves(ref, got, what) -> int:
    """``_p16_flat`` lists bit-equal, leaf by leaf; returns the leaves
    compared.  A page pool is compared without its null page: retired
    rows' masked appends all land there, at once, and which of those
    racing writes a card keeps is not defined (its bytes are never read,
    ``core/paged.py``)."""
    from repro_torch.core.paged import NULL_PAGE

    n = 0
    for i, (la, lb) in enumerate(zip(ref, got, strict=True)):
        assert [p for p, _ in la] == [p for p, _ in lb], what
        for (pth, x), (_, y) in zip(la, lb):
            if "pools" in pth:
                keep = torch.arange(x.shape[0], device=x.device) != NULL_PAGE
                x, y = x[keep], y[keep]
            if not torch.equal(x, y):
                rows = (x != y).reshape(x.shape[0], -1).any(1).nonzero()
                raise AssertionError(f"{what}: layer {i} leaf {pth}, "
                                     f"index {rows[:8, 0].tolist()} on dim 0")
            n += 1
    return n


def _p16_reads(eng) -> dict:
    """Layer 0's attention read of a seeded fp32 query on the engine's
    int4 cache, through KERNEL (B1 / B2, per shard on a mesh) and
    BLOCKWISE.  These comparison launches are taken off the counts."""
    from repro_torch.kernels.quant_attention import ops as qa_ops

    counts = qa_ops.launches, qa_ops.paged_launches
    st = eng.cache["attn"][0]
    cfg = eng.model.cfg
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    q = torch.randn((eng.capacity, cfg.n_heads, 1, cfg.head_dim),
                    generator=g, device=DEV)
    out = {b: st.policy.attend(q, st, backend=b)
           for b in ("kernel", "blockwise")}
    qa_ops.launches, qa_ops.paged_launches = counts
    return out


def _p16_parted(ref, got) -> list:
    """(rid, first step) of every stream that parts from the unsharded
    one; finish reasons must match."""
    bad = []
    for rid, c in ref.items():
        g = got[rid]
        assert g.finish_reason == c.finish_reason, (rid, g.finish_reason)
        if not (len(g.tokens) == len(c.tokens)
                and (g.tokens == c.tokens).all()):
            bad.append((rid, _first_divergence(list(c.tokens),
                                               list(g.tokens))))
    return bad


def p16_op_report(model, params, m, rows, backend) -> dict:
    """Where a sharded stream first computes something else than the
    unsharded one, on the card: ``rows`` rows of a 512-token prompt
    (shifted by the row, as ``spec_op_report``) prefilled into an
    unsharded and into a sharded int4 cache, every prefill-written leaf
    compared (B3's bytes), then one decode step each through ``backend``
    with every norm, projection, RoPE and attention read recorded, op by
    op: the first that differs is named."""
    from repro_torch.core.cache_api import Int4SRFTPolicy
    from repro_torch.launch import sharded_cache as sc
    from repro_torch.models import common

    g = torch.Generator(device="cuda").manual_seed(SEED + 18)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 512), generator=g,
                           device="cuda")
    prompt = (prompt + torch.arange(rows, device="cuda")[:, None]) \
        % model.cfg.vocab_size
    caches, taps = {}, {}
    for name, mesh in (("unsharded", None), ("sharded", _p16_mesh(m))):
        cache = sc.shard_cache(model.init_cache(
            rows, P16_S_MAX, policy="int4-srft", ragged=True,
            generator=torch.Generator().manual_seed(SEED)), mesh)
        lg, cache = model.prefill(params, prompt, cache)
        caches[name] = _p16_flat(cache["attn"])
        tok = lg[:, -1].argmax(-1)[:, None]
        owner = sc.ShardedPolicy if mesh is not None else Int4SRFTPolicy
        hooks = [(common, "rmsnorm"), (common, "dense"),
                 (common, "apply_rope"), (owner, "attend")]
        saved = [(o, n, getattr(o, n)) for o, n in hooks]
        rec = []
        for o, n, fn in saved:
            def wrapped(*a, _fn=fn, **kw):
                y = _fn(*a, **kw)
                rec.append(y.detach().clone())
                return y
            setattr(o, n, wrapped)
        try:
            model.decode_step(params, tok, cache, backend=backend)
        finally:
            for o, n, fn in saved:
                setattr(o, n, fn)
        taps[name] = rec
    _p16_same_leaves(caches["unsharded"], caches["sharded"],
                     f"16 m={m}: the prefill's cache bytes")
    per = len(BLOCK_OPS)
    first = next((i for i, (x, y) in enumerate(zip(taps["unsharded"],
                                                   taps["sharded"]))
                  if not torch.equal(x, y)), None)
    rep = dict(m=m, rows=rows, backend=backend, prefill_bytes_equal=True,
               first_op=None)
    if first is not None and first < per * model.cfg.n_layers:
        rep["first_op"] = f"layer {first // per} {BLOCK_OPS[first % per]}"
    elif first is not None:
        rep["first_op"] = "final norm or unembedding"
    log(f"[{CARD}] 16 op report m={m}, {rows} rows, {backend}: prefill "
        f"cache bytes (B3's writes) equal; one decode step op by op: "
        + (f"first differing op {rep['first_op']}" if rep["first_op"]
           else "every output equal"))
    return rep


def _p16_streams(model, params, ref, got, what, m, rows, backend) -> None:
    """Every stream and finish reason bit-equal; where one parts, the
    first differing op of one decode step is named in the failure."""
    bad = _p16_parted(ref, got)
    if bad:
        rep = p16_op_report(model, params, m, rows, backend)
        raise AssertionError(f"{what}: streams part from the unsharded "
                             f"ones {bad}; {rep}")


def _p16_bytes(eng, m) -> dict:
    """Global and per-shard bytes: K/V / m per shard, replicated paging
    metadata in full."""
    from repro_torch.core import paged as paged_mod

    states = eng.cache["attn"]
    glob = sum(st.nbytes() for st in states)
    per = sum(st.nbytes(per_shard=True) for st in states)
    assert per * m == glob, (per, glob, m)
    tot = sum(st.nbytes(persistent_only=False) for st in states)
    tot_per = sum(st.nbytes(persistent_only=False, per_shard=True)
                  for st in states)
    meta = 0
    if eng.paged:
        meta = sum(paged_mod.meta_nbytes(st.data.kv if hasattr(
            st.data, "kv") else st.data) for st in states)
    assert (tot - meta) == m * (tot_per - meta), (tot, tot_per, meta)
    return dict(kv_bytes=glob, kv_bytes_per_shard=per, total_bytes=tot,
                total_bytes_per_shard=tot_per, replicated_meta_bytes=meta)


def p16_batch(model, params) -> tuple[dict, dict]:
    """(a) ``BatchEngine`` over (1, m) meshes of cuda:0 against the
    unsharded engine on the same backend."""
    from repro_torch.core.cache_api import AttendBackend

    reqs = p16_requests(model.cfg.vocab_size)
    n_prefix_pages = P16_PREFIX // PAGE_SIZE
    launches, rows, refs = {}, [], {}

    def run(policy, backend, paged, mesh, reqs_=reqs, **kw):
        """(engine, done, report, launch counts, at the first decode: the
        cache leaves and, int4, layer 0's reads)."""
        at = []

        def first_decode(eng):
            at.append((_p16_flat(eng.cache["attn"]),
                       _p16_reads(eng) if policy == "int4-srft" else None))

        _zero_counters()
        eng, done, rep = serve_batch(
            model, params, policy, backend, paged, reqs_, mesh=mesh,
            s_max=P16_S_MAX, before_first_decode=first_decode, **kw)
        return eng, done, rep, _counters(), at[0]

    def cow(eng):
        slot = next(s for s, r in enumerate(eng._slot_req)
                    if r is not None and r.rid == 0)
        rc = eng._refcount_host[eng._ptab_host[slot, :n_prefix_pages]]
        assert (rc == 2).all(), f"sharded COW refcounts {set(rc.tolist())}"
        for st in eng.cache["attn"]:
            for s in st.shards:
                assert torch.equal(s.data.kv.pool.refcount
                                   if hasattr(s.data, "kv")
                                   else s.data.pool.refcount,
                                   st.data.kv.pool.refcount
                                   if hasattr(st.data, "kv")
                                   else st.data.pool.refcount)

    for policy, backend, paged, m in P16_RUNS:
        key = (policy, backend, paged)
        int4 = policy == "int4-srft"
        layout = "paged" if paged else "dense"
        if key not in refs:
            refs[key] = run(policy, backend, paged, None)
        ref_eng, ref_done, ref_rep, ref_counts, ref_at = refs[key]
        eng, done, rep, counts, at = run(
            policy, backend, paged, _p16_mesh(m),
            after_first_step=cow if paged else None)
        what = f"16a {policy} {layout} m={m}"
        assert eng.backend is ref_eng.backend is (
            AttendBackend.KERNEL if int4 else None), (what, eng.backend)
        n_first = _p16_same_leaves(ref_at[0], at[0],
                                   f"{what}, at the first decode")
        _p16_streams(model, params, ref_done, done, what, m, CAPACITY,
                     backend or "gather")
        n_leaves = _p16_same_leaves(_p16_flat(ref_eng.cache["attn"]),
                                    _p16_flat(eng.cache["attn"]), what)
        if paged:
            assert eng.pool_stats()["pages_used"] == 0, f"{what}: pages"
        assert all(counts[k] == m * ref_counts[k] for k in counts), \
            (what, counts, ref_counts)
        row = dict(policy=policy, backend=(eng.backend
                                           or AttendBackend.GATHER).value,
                   layout=layout, m=m,
                   ms_per_step=rep["decode_ms_per_step"],
                   unsharded_ms_per_step=ref_rep["decode_ms_per_step"],
                   host_ms_per_step=rep["host_ms_per_step"],
                   capture_s=rep["capture_s"], launches=counts,
                   launches_unsharded=ref_counts, leaves=n_leaves,
                   leaves_at_first_decode=n_first, **_p16_bytes(eng, m))
        if int4:
            read = "quant_decode_attention" + ("_paged" if paged else "")
            assert counts[read] > 0 and counts["srft_quant"] > 0, counts
            launches[f"p16_{layout}_m{m}"] = counts
            reads, ref_reads = at[1], ref_at[1]
            assert torch.equal(reads["kernel"], ref_reads["kernel"]), what
            err = float((reads["kernel"] - reads["blockwise"]).abs().max())
            scale = max(1.0, float(reads["blockwise"].abs().max()))
            assert err <= B1_ATOL * scale, (what, err, scale)
            row["kernel_vs_blockwise_max_abs"] = err
        rows.append(row)
        log("16a " + json.dumps(row))
        log(f"[{CARD}] {what}: streams, {n_first} cache leaves at the "
            f"first decode and {n_leaves} at the end equal the unsharded "
            f"{row['backend']} engine's; {row['ms_per_step']:.3f} ms/step "
            f"vs {row['unsharded_ms_per_step']:.3f} unsharded (events; the "
            f"m shards run one after another on one card); KV "
            f"{row['kv_bytes_per_shard']} B a shard of {row['kv_bytes']}"
            + (f"; launches {m} x the unsharded run's, B3 "
               f"{counts['srft_quant']}, "
               f"{'B2' if paged else 'B1'} {counts[read]}; layer 0's "
               f"sharded KERNEL read == the unsharded one, "
               f"{err:.3e} from BLOCKWISE" if int4 else ""))
        del eng, done
    # the undersized pool: preemptions on the mesh as off it
    small = [r for r in reqs if len(r.prompt) in (P16_PROMPTS[0],
                                                  P16_PROMPTS[-1])]
    pools = {}
    for mesh in (None, _p16_mesh(2)):
        pools[mesh is None] = run("int4-srft", "kernel", True, mesh, small,
                                  capacity=2,
                                  n_pages=P16_S_MAX // PAGE_SIZE + 1)
        assert pools[mesh is None][0].n_preemptions > 0, \
            "16a: the pool did not preempt"
    what = "16a preempting pool m=2"
    ref_pool, pool = pools[True], pools[False]
    _p16_streams(model, params, ref_pool[1], pool[1], what, 2, 2, "kernel")
    _p16_same_leaves(_p16_flat(ref_pool[0].cache["attn"]),
                     _p16_flat(pool[0].cache["attn"]), what)
    log(f"[{CARD}] {what}: {pool[0].n_preemptions} preemptions (unsharded "
        f"{ref_pool[0].n_preemptions}); streams and cache equal the "
        f"unsharded pool's")
    # spec k = 4 on the mesh against the plain unsharded stream
    four = reqs[2:]
    eng, spec, _, _, _ = run("int4-srft", "kernel", True, _p16_mesh(2),
                             four, spec_k=SPEC_K)
    plain = refs["int4-srft", "kernel", True][1]
    agree = {r.rid: _first_divergence(list(plain[r.rid].tokens),
                                      list(spec[r.rid].tokens))
             for r in four}
    for r in four:
        if agree[r.rid] < r.max_new_tokens:
            _tie_check(plain[r.rid].tokens, spec[r.rid].tokens,
                       forced_logits(model, params, "int4-srft", "kernel",
                                     r.prompt, plain[r.rid].tokens,
                                     eng._rots),
                       f"16a spec m=2 request {r.rid}")
    log(f"[{CARD}] 16a spec k={SPEC_K} m=2: drafted {eng.n_drafted}, "
        f"accepted {eng.n_accepted}; tokens equal to the plain unsharded "
        f"stream for {agree} of {[r.max_new_tokens for r in four]}")
    return launches, dict(rows=rows, spec_agree=agree)


def p16_engine(model, params, what="16b Engine m=2",
               key="p16_engine_m2") -> tuple[dict, dict]:
    """(b) ``Engine(mesh=)`` at batch 1, KERNEL: graph == eager ==
    unsharded, B1 and B3 launched m times as often as unsharded.  Phase
    17c runs it again on the re-meshed checkpoint's params (``what`` and
    ``key`` name its lines and its launch counts)."""
    out, launches = {}, {}
    mesh = _p16_mesh(2)

    def run(mesh_, graph, n_new=P16_ENGINE_NEW):
        from repro_torch.launch.engine import Engine

        g = torch.Generator(device="cuda").manual_seed(SEED + 16)
        prompt = torch.randint(0, model.cfg.vocab_size,
                               (1, P16_ENGINE_PROMPT), generator=g,
                               device="cuda")
        eng = Engine(model, backend="kernel", graph=graph, mesh=mesh_)
        cache = eng.shard_cache(model.init_cache(
            1, P16_S_MAX, policy="int4-srft", ragged=True,
            generator=torch.Generator().manual_seed(SEED)))
        p = eng.shard_params(params)
        _zero_counters()
        lg, cache = eng.prefill(p, prompt, cache)
        tok = lg[:, -1].argmax(-1)[:, None]
        tok1, cache = eng.decode(p, tok, cache, 1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rest, cache = eng.decode(p, tok1, cache, n_new - 2)
        b.record()
        torch.cuda.synchronize()
        toks = torch.cat([tok, tok1, rest], dim=1).cpu()
        return toks, cache, a.elapsed_time(b) / (n_new - 2), _counters()

    ref_t, ref_c, ref_ms, ref_n = run(None, True)
    t, c, ms, n = run(mesh, True)
    eager_t, _, eager_ms, _ = run(mesh, False, P16_EAGER_NEW)
    assert torch.equal(eager_t, t[:, :P16_EAGER_NEW]), f"{what}: graph != eager"
    if not torch.equal(t, ref_t):
        rep = p16_op_report(model, params, 2, 1, "kernel")
        raise AssertionError(f"{what}: tokens part from the unsharded "
                             f"run's at {_first_divergence(ref_t[0], t[0])}"
                             f"; {rep}")
    n_leaves = _p16_same_leaves(_p16_flat(ref_c["attn"]),
                                _p16_flat(c["attn"]), what)
    assert all(n[k] == 2 * ref_n[k] for k in n) and \
        n["quant_decode_attention"] > 0, (what, n, ref_n)
    launches[key] = n
    out.update(graph=ms, eager=eager_ms, unsharded=ref_ms, launches=n,
               unsharded_launches=ref_n)
    log(f"[{CARD}] {what}: graph == eager over {P16_EAGER_NEW} tokens; "
        f"{P16_ENGINE_NEW} tokens and {n_leaves} cache leaves equal the "
        f"unsharded graph run's; B1 {n['quant_decode_attention']}, B3 "
        f"{n['srft_quant']} (2 x unsharded); {ms:.3f} ms/token graph, "
        f"{eager_ms:.3f} eager, {ref_ms:.3f} unsharded (events)")
    return launches, out


def p16_pipeline(model, params) -> dict:
    """(c) the GPipe forward over the model's blocks, 2 and 4 stages on a
    ("pod",) mesh of cuda:0, against the blocks run in order."""
    from repro_torch.distributed.pipeline import pipeline_forward

    blocks = params["blocks"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x = torch.randn((4, 1, 256, model.cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)

    def layer_fn(p, h):
        return model._block_full(p, h)[0]

    with torch.inference_mode():
        ref = torch.empty_like(x)
        for mb in range(x.shape[0]):
            h = x[mb]
            for p in blocks:
                h = layer_fn(p, h)
            ref[mb] = h
        out = {}
        for stages in (2, 4):
            got = pipeline_forward(layer_fn, blocks, x,
                                   mesh=_p16_mesh(stages, ("pod",)),
                                   axis="pod", n_layers=len(blocks))
            assert torch.equal(got, ref), f"16c {stages} stages"
            out[stages] = True
    log(f"[{CARD}] 16c pipeline_forward: {len(blocks)} blocks in 2 and 4 "
        f"stages equal the sequential loop bit for bit (4 microbatches "
        f"of 256 tokens)")
    return out


def p16_cli() -> dict:
    """(d) the serve CLI: ``--mesh 1`` serves; ``--mesh 2`` on one card
    exits naming the one visible device."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(*extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "internlm2-1.8b", *P16_CLI, *extra], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)

    from repro_torch.launch import serve as serve_cli

    t0 = time.perf_counter()
    r = cli("--mesh", "1")
    assert r.returncode == 0, f"16d --mesh 1: {r.stderr[-2000:]}"
    assert r.stdout.count("[done]") == 2 and "mesh-sharded" not in r.stdout
    t1 = time.perf_counter()
    # the same argv with --mesh 2 exits before it builds anything: run
    # in this process (a subprocess's start would be most of its time)
    try:
        serve_cli.main(["--arch", "internlm2-1.8b", *P16_CLI, "--mesh", "2"])
        raise AssertionError("16d --mesh 2 did not exit")
    except SystemExit as e:
        msg = str(e.code)
    assert "than the 1 visible" in msg, msg
    log(f"[{CARD}] 16d serve CLI --mesh 1: exit 0 in {t1 - t0:.1f} s; "
        f"--mesh 2: SystemExit, {msg[:90]}...")
    return dict(mesh1_s=t1 - t0, mesh2_s=time.perf_counter() - t1)


def p16_phase(model, params) -> dict:
    """Phase 16 (see the module doc).  Returns launches by path."""
    t0 = time.perf_counter()
    launches, batch = p16_batch(model, params)
    t1 = time.perf_counter()
    engine_launches, engine = p16_engine(model, params)
    launches.update(engine_launches)
    t2 = time.perf_counter()
    p16_pipeline(model, params)
    t3 = time.perf_counter()
    cli = p16_cli()
    t4 = time.perf_counter()
    log("16 summary " + json.dumps(dict(
        batch=batch, engine=engine, cli=cli, seconds=dict(
            batch=t1 - t0, engine=t2 - t1, pipeline=t3 - t2,
            cli=t4 - t3))))
    return launches


# --------------------------------------- phase 17: sharded training (A12b)

P17_LR = 1e-3  # constant: the CLI's warmup would give step 1 no update
P17_BATCH, P17_SEQ, P17_STEPS = 4, 256, 2
P17_MESHES = ((2, 1), (1, 2), (2, 2))  # over ('data', 'model'), cuda:0
P17_RTOL = 2e-3  # the reference's sharded vs single-device loss
# tests/test_torch_sharded_train.py's, on fp32 params and activations
P17_FP32_RTOL, P17_LEAF_ATOL = 1e-5, 0.5 * P17_LR
P17_SAVE_AT = 3  # (b): save after 3 steps, resume to 4
P17_DIR = ROOT / "build" / "phase17"
P17_CLI = ("--arch", "internlm2-1.8b", "--smoke", "--steps", "2", "--batch",
           "2", "--seq", "64", "--log-every", "1")
P17_PSUM_TOL = 1e-2  # tests/test_distributed.py's compressed psum claim


def _p17_mesh(dims, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    n = math.prod(dims)
    return make_mesh(dims, axes, devices=["cuda:0"] * n)


def _p17_batch(vocab, i=0):
    """4 x 256 seeded tokens and a seeded 0/1 loss mask whose first two
    rows (data shard 0 of a 2-way split) count every target."""
    g = torch.Generator().manual_seed(SEED + 170 + i)
    tokens = torch.randint(0, vocab, (P17_BATCH, P17_SEQ), generator=g)
    mask = torch.randint(0, 2, (P17_BATCH, P17_SEQ), generator=g,
                         dtype=torch.int32)
    mask[:P17_BATCH // 2] = 1
    return {"tokens": tokens.to(DEV), "loss_mask": mask.to(DEV)}


def _p17_run(model, params0, batch, mesh, steps=P17_STEPS):
    """``steps`` of the single-device step (``mesh`` None) or the sharded
    one from ``params0``: (state, [loss, grad norm a step], [ms a step,
    CUDA events], peak bytes allocated)."""
    from repro_torch.launch.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
    )
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adam import adam_init

    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    if mesh is None:
        state = (params0, adam_init(params0))
        step = make_train_step(model, lr=P17_LR)
    else:
        state = shard_train_state(params0, adam_init(params0), mesh)
        step = make_sharded_train_step(model, mesh, lr=P17_LR)
    mets, ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        p, o, m = step(*state, batch)
        b.record()
        state = (p, o)
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        mets.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return state, mets, ms, torch.cuda.max_memory_allocated()


def _p17_pieces(tree, mesh) -> int:
    """Every piece of every ``Sharded`` leaf on its mesh device, holding
    global bytes / its dims' split (a replicated leaf in full); returns
    the bytes the first device holds."""
    from repro_torch.launch import partitioning as pt
    from repro_torch.optim.adam import tree_leaves

    import numpy as np

    first = 0
    for s in tree_leaves(tree):
        assert isinstance(s, pt.Sharded) and s.mesh is mesh, type(s)
        split = math.prod(n for _, _, n in pt._dim_splits(s.spec, mesh))
        whole = math.prod(s.shape) * s.pieces.flat[0].element_size()
        for idx in np.ndindex(mesh.devices.shape):
            t = s.pieces[idx]
            assert t.device == mesh.devices[idx], (s.spec, idx)
            assert t.numel() * t.element_size() * split == whole, s.spec
        first += s.pieces.flat[0].numel() * s.pieces.flat[0].element_size()
    return first


def _p17_paths(state) -> list:
    """The paths of a (params, AdamState) tree in checkpoint order."""
    from repro_torch.checkpoint.manager import leaves

    def walk(t, path):
        if isinstance(t, dict):
            return [p for k in sorted(t) for p in walk(t[k], path + (k,))]
        if isinstance(t, (list, tuple)):
            names = getattr(t, "_fields", range(len(t)))
            return [p for k, v in zip(names, t) for p in walk(v, path + (k,))]
        return [path]

    out = walk(state, ())
    assert len(out) == len(leaves(state))
    return out


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element (0 at 0)."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, torch.zeros_like(x, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                   e - 8))


@contextlib.contextmanager
def _fp32_model():
    """fp32 matmul operands and activations for the block."""
    from repro_torch.models import common

    saved = common.COMPUTE_DTYPE
    common.COMPUTE_DTYPE = torch.float32
    try:
        with common.dot_mode(False):
            yield
    finally:
        common.COMPUTE_DTYPE = saved


def p17_train(model, params0, label="17a") -> dict:
    """(a) 2 steps of 4 x 256 tokens under a loss mask whose counts differ
    between the data shards, on one device and on (2, 1), (1, 2) and
    (2, 2) meshes of cuda:0, every piece of params and Adam state global /
    split bytes on its device.  On fp32 params and activations (``label``
    17a-fp32), the CPU test's tolerances: each step's loss and grad norm
    within P17_FP32_RTOL, every param leaf after step 2 within
    P17_LEAF_ATOL of the single-device step's.  On bf16 params and
    activations (17a): each step's loss and grad norm within P17_RTOL, or
    within twice the distance of the single-device run with fp32 matmul
    operands where that is larger; an element whose gradient lies within
    the rounding of 0 may step the other way, so leaves are held to
    Adam's bound on two trajectories, 2 lr a step plus one bf16 ulp a
    step, and the elements past P17_LEAF_ATOL are counted."""
    from repro_torch.launch import partitioning as pt
    from repro_torch.optim.adam import tree_leaves

    fp32 = label.endswith("fp32")
    batch = _p17_batch(model.cfg.vocab_size)
    state, ref, ref_ms, ref_peak = _p17_run(model, params0, batch, None)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    want = [t.cpu() for t in tree_leaves(state[0])]
    del state
    if fp32:
        other = None
        tol = [{k: P17_FP32_RTOL * abs(w[k]) for k in w} for w in ref]
    else:
        # the same single-device steps with fp32 matmul operands: another
        # valid rounding of the same math.  Adam's first update parts at
        # the elements whose gradient lies within that rounding of 0, so
        # step 2's grad norm moves by more than the reference's 2e-3
        from repro_torch.models import common

        with common.dot_mode(False):
            _, other, _, _ = _p17_run(model, params0, batch, None)
        tol = [{k: max(P17_RTOL * abs(w[k]), 2 * abs(o[k] - w[k]))
                for k in w} for w, o in zip(ref, other)]
    rec = {"unsharded": dict(metrics=ref, ms=ref_ms, peak_bytes=ref_peak,
                             state_bytes=state_bytes, fp32_operands=other)}
    log(f"[{CARD}] {label} unsharded: loss/gnorm {ref}, ms/step (events) "
        f"{[round(m, 1) for m in ref_ms]}, peak {ref_peak / 1e9:.2f} GB, "
        f"state {state_bytes / 1e9:.2f} GB; with fp32 operands {other}")
    for dims in P17_MESHES:
        mesh = _p17_mesh(dims)
        what = f"{label} {dims[0]}x{dims[1]}"
        st, mets, ms, peak = _p17_run(model, params0, batch, mesh)
        for i, (g, w) in enumerate(zip(mets, ref)):
            for k in g:
                assert abs(g[k] - w[k]) <= tol[i][k], \
                    (what, i + 1, k, g[k], w[k], tol[i][k])
        worst, beyond, n = 0.0, 0, 0
        for j, (s, w) in enumerate(zip(tree_leaves(st[0]), want)):
            got = pt.gather_tree(s).float()
            w = w.to(got.device).float()
            diff = (got - w).abs()
            if fp32:
                bound = P17_LEAF_ATOL
            else:
                # AdamW (b1 0.9, b2 0.999) moves an element by at most
                # 1.0013 lr in each of its first two steps
                bound = 2.01 * P17_LR * P17_STEPS + P17_STEPS * torch.maximum(
                    _bf16_ulp(got), _bf16_ulp(w))
            assert bool((diff <= bound).all()), \
                (what, j, float((diff - bound).max()))
            worst = max(worst, float(diff.max()))
            beyond += int((diff > P17_LEAF_ATOL).sum())
            n += diff.numel()
            del got, w, diff, bound
        per_dev = {f: _p17_pieces(getattr(st[1], f) if f != "params"
                                  else st[0], mesh)
                   for f in ("params", "mu", "nu")}
        total = sum(per_dev.values())
        rec[f"{dims[0]}x{dims[1]}"] = dict(
            metrics=mets, ms=ms, peak_bytes=peak, leaf_max_abs=worst,
            elements_past_atol=beyond, elements=n,
            first_device_bytes=per_dev)
        log(f"[{CARD}] {what}: loss/gnorm {mets} (tolerances "
            f"{[{k: float(f'{v:.3g}') for k, v in t.items()} for t in tol]}); "
            f"leaves max |diff| {worst:.3g}, {beyond} of {n} elements past "
            f"{P17_LEAF_ATOL:g}; ms/step {[round(m, 1) for m in ms]} vs "
            f"unsharded {[round(m, 1) for m in ref_ms]}; peak "
            f"{peak / 1e9:.2f} GB; first device holds {total / 1e9:.2f} of "
            f"{state_bytes / 1e9:.2f} GB (params, mu, nu)")
        del st
    _free_cuda()
    return rec


def p17_chain(model, params0):
    """(b) at MAIN_LAYERS: 3 steps on (2, 2), saved; the uninterrupted
    run's step 4 against step 4 from the checkpoint restored on (2, 2)
    (bit for bit, or within twice the spread of a rerun of step 4, with
    the differing leaves named); the checkpoint restored on (2, 1) by its
    specs through ``sharding_fn``: each piece on its device with the new
    split, each gathered leaf bit-equal to the saved state's.  Returns
    (record, the re-meshed params gathered on the card)."""
    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager, leaves
    from repro_torch.launch import partitioning as pt
    from repro_torch.launch.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
        train_state_specs,
    )
    from repro_torch.optim.adam import adam_init

    mesh, mesh_b = _p17_mesh((2, 2)), _p17_mesh((2, 1))
    batches = [_p17_batch(model.cfg.vocab_size, 1 + i)
               for i in range(P17_SAVE_AT + 1)]
    step = make_sharded_train_step(model, mesh, lr=P17_LR)
    state = shard_train_state(params0, adam_init(params0), mesh)
    losses = []
    for b in batches[:P17_SAVE_AT]:
        p, o, m = step(*state, b)
        state = (p, o)
        losses.append(float(m["loss"]))
    shutil.rmtree(P17_DIR, ignore_errors=True)
    mgr = CheckpointManager(str(P17_DIR), keep=1)
    t0 = time.perf_counter()
    mgr.save(P17_SAVE_AT, state, metadata={"mesh": [2, 2]})
    save_s = time.perf_counter() - t0
    disk = _dir_bytes(P17_DIR)
    whole = step(*state, batches[-1])[:2]

    def differing(a, b) -> list:
        """The leaves (checkpoint order) whose pieces differ in a bit."""
        return [i for i, (x, y) in enumerate(zip(leaves(a), leaves(b)))
                if not all(torch.equal(_bits(x.pieces[k]), _bits(y.pieces[k]))
                           for k in np.ndindex(x.pieces.shape))]

    specs = leaves(train_state_specs(params0, mesh))
    t0 = time.perf_counter()
    back, meta = mgr.restore(P17_SAVE_AT, state,
                             sharding_fn=lambda i, ex: (mesh, specs[i]))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert meta == {"mesh": [2, 2]} and not differing(back, state), \
        "17b the restored state differs from the saved one"
    resumed = step(*back, batches[-1])[:2]
    differ = differing(resumed, whole)
    rerun_differ = []
    if differ:
        # the card reorders a reduction between two identical steps: hold
        # the resume to twice the spread of a rerun, leaf by leaf
        again = step(*state, batches[-1])[:2]
        rerun_differ = differing(again, whole)
        names = _p17_paths(whole)
        for i in differ:
            a, b, c = (pt.gather_tree(leaves(t)[i]).double()
                       for t in (resumed, whole, again))
            spread = float((c - b).abs().max())
            err = float((a - b).abs().max())
            log(f"  17b leaf {i} {names[i]}: resume {err:.3g}, rerun "
                f"spread {spread:.3g}")
            assert err <= 2 * spread, f"17b leaf {i} {names[i]}"
        del again
    del back, resumed, whole
    specs_b = leaves(train_state_specs(params0, mesh_b))
    t0 = time.perf_counter()
    moved, _ = mgr.restore(P17_SAVE_AT, state,
                           sharding_fn=lambda i, ex: (mesh_b, specs_b[i]))
    torch.cuda.synchronize()
    remesh_s = time.perf_counter() - t0
    for s, spec, old in zip(leaves(moved), specs_b, leaves(state)):
        assert s.mesh is mesh_b and s.spec == spec, (s.spec, spec)
        assert torch.equal(_bits(pt.gather_tree(s)),
                           _bits(pt.gather_tree(old))), spec
    first = _p17_pieces(moved, mesh_b)
    params = pt.gather_tree(moved[0])
    n_leaves = len(leaves(state))
    del moved, state
    shutil.rmtree(P17_DIR, ignore_errors=True)
    _free_cuda()
    rec = dict(losses=losses, leaves=n_leaves, ckpt_disk_bytes=disk,
               save_s=save_s, restore_s=restore_s, remesh_restore_s=remesh_s,
               resume_leaves_differ=len(differ),
               rerun_leaves_differ=len(rerun_differ),
               remesh_first_device_bytes=first)
    log(f"[{CARD}] 17b (2, 2) {P17_SAVE_AT} steps, losses {losses}; "
        f"checkpoint {disk / 1e9:.3f} GB, save {save_s:.1f} s, restore on "
        f"(2, 2) {restore_s:.1f} s: every piece bit-equal; step "
        f"{P17_SAVE_AT + 1} resumed vs uninterrupted: {len(differ)} of "
        f"{n_leaves} leaves differ (rerun {len(rerun_differ)}); restore on "
        f"(2, 1) {remesh_s:.1f} s: {n_leaves} leaves on the new mesh and "
        f"split, gathered bit for bit, first device "
        f"{first / 1e9:.2f} GB")
    return rec, params


def p17_psum(model, params) -> dict:
    """(d) ``compressed_psum`` on the card: the reference test's 8 x 512
    N(0, 1) draw over an 8-way ("pod",) mesh of cuda:0, and layer 0's FFN
    up-projection gradient (2048 x 8192, one per row of a 4 x 256 batch,
    in fp32 as the sharded step sums gradients) over a 4-way mesh: codes
    and scales equal to the CPU plain run's, every element of the sum
    within the participants' half quantization steps of the exact sum,
    and the reference input within P17_PSUM_TOL relative (the reference
    test's claim for N(0, 1) blocks; the gradient's relative error is
    logged)."""
    from repro_torch.distributed import compression as comp
    from repro_torch.optim.adam import tree_map

    g = torch.Generator().manual_seed(SEED + 18)
    cases = {"reference 8 x 512": list(torch.randn((8, 512), generator=g))}
    batch = _p17_batch(model.cfg.vocab_size)
    leaf = params["blocks"][0]["ffn"]["w_up"]["w"]
    grads = []
    for r in range(P17_BATCH):
        p = tree_map(lambda t: t, params)
        w = leaf.detach().requires_grad_(True)
        p["blocks"][0]["ffn"]["w_up"] = {"w": w}
        loss, _ = model.loss(p, {k: v[r:r + 1] for k, v in batch.items()})
        grads.append(torch.autograd.grad(loss, w)[0].float().cpu())
        del p, w, loss
    cases[f"w_up grad {tuple(leaf.shape)}"] = grads
    rec = {}
    for name, xs in cases.items():
        n = len(xs)
        mesh = _p17_mesh((n,), ("pod",))
        devs = mesh.devices_along("pod")
        on = [x.to(d) for x, d in zip(xs, devs)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs, _ = comp.compressed_psum(on, [comp.ef_init(x) for x in on])
        b.record()
        torch.cuda.synchronize()
        cpu_outs, _ = comp.compressed_psum(xs, [comp.ef_init(x) for x in xs])
        half_steps, peaks = 0.0, []
        for x, xc in zip(on, xs):
            cc = comp._quantize_blocks(xc.float())
            cg = comp._quantize_blocks(x.float())
            assert torch.equal(cg[0].cpu(), cc[0]), f"17d {name}: codes"
            assert torch.equal(cg[1].cpu(), cc[1]), f"17d {name}: scales"
            # each element's rounding is at most half its block's step
            half_steps = half_steps + (cc[1].double() / 2).expand(
                cc[0].shape).reshape(-1)[:xc.numel()]
            blocks = cc[0] * cc[1]
            peaks.append(float((blocks.abs().amax(-1) / blocks.square()
                                .mean(-1).sqrt().clamp_min(1e-30)).mean()))
        exact = torch.stack([x.double() for x in xs]).sum(0)
        got = outs[0].double().cpu()
        err = (got - exact).reshape(-1).abs()
        within = bool((err <= half_steps * (1 + 1e-5) + 1e-6 * exact.abs()
                       .reshape(-1)).all())
        rel = float((got - exact).norm() / exact.norm())
        card_vs_cpu = float((outs[0].cpu().double()
                             - cpu_outs[0].double()).abs().max())
        peak = sum(peaks) / len(peaks)
        rec[name] = dict(participants=n, rel_err=rel, ms=a.elapsed_time(b),
                         card_vs_cpu_max_abs=card_vs_cpu,
                         block_peak_over_rms=peak)
        log(f"[{CARD}] 17d compressed_psum {name} over {n}: rel err "
            f"{rel:.3g}, every element within the participants' half "
            f"steps: {within}, codes equal the CPU's, outputs "
            f"{card_vs_cpu:.3g} apart, block peak / rms {peak:.2f}, "
            f"{a.elapsed_time(b):.3f} ms")
        assert within, f"17d {name}: an element past half a step"
        # the reference's 1e-2 is a claim about N(0, 1) blocks (peak / rms
        # 2.9); a gradient's heavier blocks are held to the bound above
        if name.startswith("reference"):
            assert rel < P17_PSUM_TOL, (name, rel)
    return rec


def p17_cli() -> dict:
    """(e) the training CLI: ``--mesh 1x1`` trains 2 steps in a
    subprocess; ``--mesh 2x1`` on one card exits naming it (in this
    process: it exits before building anything)."""
    from repro_torch.launch import train

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *P17_CLI, "--mesh", "1x1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, f"17e --mesh 1x1: {r.stderr[-2000:]}"
    assert "mesh={'data': 1, 'model': 1}" in r.stdout, r.stdout
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in r.stdout.splitlines() if ln.strip().startswith("step")]
    assert len(losses) == 2 and all(map(math.isfinite, losses)), r.stdout
    try:
        train.main([*P17_CLI, "--mesh", "2x1"])
        raise AssertionError("17e --mesh 2x1 did not exit")
    except SystemExit as e:
        msg = str(e.code)
    assert "2 devices and 1 is visible (cuda:0)" in msg, msg
    log(f"[{CARD}] 17e train CLI --mesh 1x1: exit 0 in {wall:.1f} s, "
        f"losses {losses}; --mesh 2x1: SystemExit, {msg[:80]}...")
    return dict(mesh1x1_s=wall, losses=losses)


def p17_phase() -> dict:
    """Phase 17 (see the module doc).  Returns launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.optim.adam import tree_map

    t0 = time.perf_counter()
    full = get_config("internlm2-1.8b")
    model = LM(full)
    params = model.init(model.generator(SEED))
    train = p17_train(model, params)
    del model, params
    _free_cuda()
    model = LM(dataclasses.replace(full, n_layers=MAIN_LAYERS))
    params = model.init(model.generator(SEED))
    with _fp32_model():
        params32 = tree_map(lambda t: t.float(), params)
        train32 = p17_train(model, params32, "17a-fp32")
        del params32
    _free_cuda()
    t1 = time.perf_counter()
    chain, restored = p17_chain(model, params)
    t2 = time.perf_counter()
    psum = p17_psum(model, params)
    del params
    _free_cuda()
    t3 = time.perf_counter()
    launches, engine = p16_engine(
        model, restored, what="17c Engine m=2 on the (2, 1)-restored params",
        key="p17_engine_m2")
    del restored
    _free_cuda()
    t4 = time.perf_counter()
    cli = p17_cli()
    t5 = time.perf_counter()
    secs = dict(train=t1 - t0, chain=t2 - t1, psum=t3 - t2, engine=t4 - t3,
                cli=t5 - t4)
    log("17 summary " + json.dumps(dict(
        train=train, train_fp32=train32, chain=chain, psum=psum, engine=engine, cli=cli,
        seconds=secs)))
    return launches


# ------------------------------------ phase 18: split-K serving (A12d)
# internlm2-1.8b's 8 KV heads do not divide a 'model' axis of 3 or 16, so
# shard_cache(..., allow_split_k=True) splits each layer's dense cache by
# position: at S_MAX = 4608 a shard spans 1536 positions on m = 3 (the
# 1523-token request's packed length crosses shard 0's end during decode)
# and 288 on m = 16 (the 2055-token request leaves shards 8-15 empty)
P18_NEW = 32
P18_EAGER_NEW = 8  # the eager run's tokens, held to the graph run's first
# (policy, backend, m, prompt tokens, also eager)
P18_RUNS = (("int4-srft", "kernel", 3, 1523, True),
            ("int4-srft", "kernel", 16, 2055, False),
            ("bf16", "gather", 3, 1523, False),
            ("int8-per-token", "gather", 3, 1523, False))
P18_READ_TOL = 1e-4  # B1's, times max(1, max|out|): layer 0's read


def p18_prompt(vocab, prompt_len, kind="random"):
    """Phase 18's request: ``prompt_len`` random tokens, or (``kind``
    "repetitive") a SPEC_BASE-token random base tiled, as phase 10 builds
    it, so that the prompt-lookup drafter hits."""
    if kind == "random":
        g = torch.Generator(device="cuda").manual_seed(SEED + 18)
        return torch.randint(0, vocab, (1, prompt_len), generator=g,
                             device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    base = torch.randint(0, vocab, (1, SPEC_BASE), generator=g,
                         device="cuda")
    return base.repeat(1, -(-prompt_len // SPEC_BASE))[:, :prompt_len]


def _p18_engine(model, policy, backend, m, graph):
    """An ``Engine`` (over a (1, m) mesh of cuda:0 when ``m``) and a fresh
    ragged cache for it, split by position when ``m``."""
    from repro_torch.launch import sharded_cache as sc
    from repro_torch.launch.engine import Engine

    mesh = _p16_mesh(m) if m else None
    eng = Engine(model, backend=backend, graph=graph, mesh=mesh)
    cache = model.init_cache(1, S_MAX, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(SEED))
    if mesh is not None:
        cache = eng.shard_cache(cache, allow_split_k=True)
        assert all(isinstance(st, sc.ShardedState) and st.seq_split
                   for st in cache["attn"]), "split-K did not split"
    return eng, cache


def p18_run(model, params, policy, backend, m, prompt_len, graph=True,
            n_new=P18_NEW, prompt=None, held=None) -> dict:
    """One request through ``Engine`` (unsharded when ``m`` is None, else
    over a (1, m) mesh of cuda:0 with split-K): tokens, logits, the
    kernels' launches, ms/token over the decode (events, the first step
    and its capture excluded), every layer's bytes after the prefill and
    after the first decode step, the per-shard bytes, the cache, and
    ``held``.  ``prompt`` defaults to :func:`p18_prompt`'s random one;
    ``held`` is a previous run's (engine, cache, params) with the same
    arguments, whose cache the request prefills anew and whose captured
    step it replays."""
    if prompt is None:
        prompt = p18_prompt(model.cfg.vocab_size, prompt_len)
    if held is None:
        eng, cache = _p18_engine(model, policy, backend, m, graph)
        held = (eng, cache, eng.shard_params(params))
    eng, cache, p = held
    _zero_counters()
    lg, cache = eng.prefill(p, prompt, cache)
    prefilled = _p16_flat(cache["attn"])
    tok = lg[:, -1].argmax(-1)[:, None]
    tok1, l1, cache = eng.decode(p, tok, cache, 1, return_logits=True)
    first = _p16_flat(cache["attn"])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    rest, lr, cache = eng.decode(p, tok1, cache, n_new - 2,
                                 return_logits=True)
    b.record()
    torch.cuda.synchronize()
    counts = _counters()
    per_shard = sum(st.nbytes(persistent_only=False, per_shard=True)
                    for st in cache["attn"])
    return dict(toks=torch.cat([tok, tok1, rest], dim=1)[0].cpu(),
                logits=torch.cat([lg[:, -1:].float(), l1, lr], dim=1),
                ms=a.elapsed_time(b) / (n_new - 2), counts=counts,
                prefilled=prefilled, first=first, cache=cache,
                per_shard_bytes=per_shard, held=held)


def _p18_bytes_equal(ref, got, layers, what) -> int:
    """``_p16_flat`` layers ``layers`` bit-equal, leaf by leaf."""
    return _p16_same_leaves([ref[i] for i in layers],
                            [got[i] for i in layers], what)


def _p18_layer0_read(state, backend, cfg) -> float:
    """Layer 0's split-K read of a seeded fp32 query against the unsplit
    read of the same bytes (the state gathered along the sequence): the
    error over ``P18_READ_TOL * max(1, max|out|)``, which must be <= 1."""
    from repro_torch.launch import sharded_cache as sc

    g = torch.Generator(device="cuda").manual_seed(SEED + 181)
    d = cfg.head_dim
    q = torch.randn((1, cfg.n_heads, 1, d), generator=g, device="cuda")
    kw = dict(backend=backend, scale=d ** -0.5)
    got = state.policy.attend(q, state, **kw)
    whole = sc.gather_state(state)
    want = whole.policy.attend(q, whole, **kw)
    err = (got - want).abs().max().item()
    return err / (P18_READ_TOL * max(1.0, want.abs().max().item()))


def p18_case(model, params, policy, backend, m, prompt_len,
             eager) -> tuple[dict, dict]:
    """One of ``P18_RUNS`` against the unsharded run of its request."""
    what = f"18 {policy} {backend} m={m} {prompt_len}+{P18_NEW}"
    ref = p18_run(model, params, policy, backend, None, prompt_len)
    got = p18_run(model, params, policy, backend, m, prompt_len)
    n_layers = len(ref["prefilled"])
    n_pre = _p18_bytes_equal(ref["prefilled"], got["prefilled"],
                             range(n_layers), f"{what} after the prefill")
    n_first = _p18_bytes_equal(ref["first"], got["first"], [0],
                               f"{what} layer 0 at the first decode")
    # a deeper layer's first-step K/V come from the split-K read below it
    deeper = sum(int(not torch.equal(x, y))
                 for la, lb in zip(ref["first"][1:], got["first"][1:])
                 for (_, x), (_, y) in zip(la, lb))
    n_same = _agree_until(ref["toks"][None], got["toks"][None],
                          ref["logits"])
    tol = LOGIT_TOL * ref["logits"].abs().max().item()
    err = (got["logits"][:, :n_same] - ref["logits"][:, :n_same]).abs(
        ).max().item()
    assert err <= tol, f"{what}: logits {err} > {tol}"
    n, n_ref = got["counts"], ref["counts"]
    assert n["srft_quant"] == n_ref["srft_quant"], (what, n, n_ref)
    if backend == "kernel":
        assert n["quant_decode_attention"] == \
            m * n_ref["quant_decode_attention"] > 0, (what, n, n_ref)
    read = _p18_layer0_read(got["cache"]["attn"][0], backend, model.cfg)
    assert read <= 1.0, f"{what}: layer 0's read {read} x tolerance"
    rec = dict(tokens_agree=n_same, logit_err=err, logit_tol=tol,
               ms_per_token=got["ms"], unsharded_ms_per_token=ref["ms"],
               launches=n, unsharded_launches=n_ref,
               per_shard_bytes=got["per_shard_bytes"],
               unsharded_bytes=ref["per_shard_bytes"],
               layer0_read_over_tol=read, deeper_leaves_moved=deeper)
    if eager:
        e = p18_run(model, params, policy, backend, m, prompt_len,
                    graph=False, n_new=P18_EAGER_NEW)
        assert torch.equal(e["toks"], got["toks"][:P18_EAGER_NEW]), \
            f"{what}: graph != eager"
        rec["eager_ms_per_token"] = e["ms"]
    log(f"[{CARD}] {what}: tokens agree for {n_same}/{P18_NEW}, logits "
        f"within {err:.3e} (tol {tol:.3e}); {n_pre} leaves bit-equal after "
        f"the prefill, layer 0's {n_first} at the first decode ({deeper} "
        f"deeper leaves moved by the split read); layer 0's read at "
        f"{read:.3f} x its tolerance; B1 {n['quant_decode_attention']} "
        f"(unsharded {n_ref['quant_decode_attention']}), B3 "
        f"{n['srft_quant']} (= unsharded); {got['ms']:.3f} ms/token graph"
        + (f", {rec['eager_ms_per_token']:.3f} eager" if eager else "")
        + f", unsharded {ref['ms']:.3f} (events); per-shard cache "
        f"{got['per_shard_bytes'] / 2**20:.2f} MiB of "
        f"{ref['per_shard_bytes'] / 2**20:.2f} MiB")
    del ref
    return {f"split_k_{policy}_m{m}": n}, rec, got


# phase 18b: speculative decoding on the split cache (m = 3, SPEC_K): the
# 1523-token requests, random and repetitive (phase 10's tiled base), 32
# new tokens; (policy, backend, prompts); the random prompts' split-K plain
# streams are phase 18's own
P18B_RUNS = (("int4-srft", "kernel", ("random", "repetitive")),
             ("bf16", "gather", ("random", "repetitive")),
             ("int8-per-token", "gather", ("repetitive",)))
P18B_M, P18B_PROMPT = 3, 1523
P18B_EAGER_NEW = 8  # int4 eager spec over these tokens == graph spec


def p18b_spec(model, params, policy, backend, prompt, graph=True,
              n_new=P18_NEW, held=None) -> dict:
    """One greedy request through ``Engine``'s speculative path on a
    (1, P18B_M) split-K cache: prefill, a first ``decode_spec`` of one
    token (under a graph it captures the pass), then the other n_new - 2
    tokens, timed by CUDA events, the kernels' counters zeroed just
    before and read just after.  ``held``: a previous call's (engine,
    cache, params) for the same policy and backend, whose cache the
    request prefills anew and whose captured pass it replays (a capture
    costs two eager passes of host time).  Gates: B3 2 x n_layers x k a
    pass (the lead quantizes each append's ring once, as the unsharded
    pass), no B1 / B2 (the verify reads with GATHER's numerics)."""
    from repro_torch.launch.engine import SPEC_KEY

    k, L = SPEC_K, model.cfg.n_layers
    if held is None:
        eng, cache = _p18_engine(model, policy, backend, P18B_M, graph)
        held = (eng, cache, eng.shard_params(params))
    eng, cache, p = held
    lg, cache = eng.prefill(p, prompt, cache)
    tok0 = lg[:, -1].argmax(-1)[:, None]
    tok1, cache, st1 = eng.decode_spec(p, tok0, cache, 1, prompt=prompt,
                                       spec_k=k)
    hist = torch.cat([prompt, tok0], 1)
    _zero_counters()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    a.record()
    rest, cache, st = eng.decode_spec(p, tok1, cache, n_new - 2,
                                      prompt=hist, spec_k=k)
    b.record()
    torch.cuda.synchronize()
    counts = _counters()
    toks = torch.cat([tok0, tok1, rest], 1)[0].cpu()
    pos = int(cache["pos"][0])
    assert pos == prompt.shape[1] + n_new - 1, pos
    assert all(int(s.length[0]) == pos for st in cache["attn"]
               for s in st.shards), "a shard's length is off"
    passes = st["passes"]
    if policy == "int4-srft":
        assert counts["srft_quant"] == passes * 2 * L * k, (counts, passes)
    assert counts["quant_decode_attention"] == 0, counts
    assert counts["quant_decode_attention_paged"] == 0, counts
    rec = dict(ms_per_token=a.elapsed_time(b) / (n_new - 2), passes=passes,
               drafted=st1["drafted"] + st["drafted"],
               accepted=st1["accepted"] + st["accepted"], launches=counts)
    rec["acceptance"] = rec["accepted"] / max(rec["drafted"], 1)
    if graph:
        cap = cache[SPEC_KEY]
        assert cap.step.counts == (0, 0, 2 * L * k if policy == "int4-srft"
                                   else 0, 0), cap.step.counts
        rec["per_pass_launches"] = cap.step.counts
        rec["capture_s"] = cap.step.capture_s
    return dict(toks=toks, cache=cache, rec=rec, held=held)


def _p18b_readable(states) -> list:
    """Every layer's bytes a read can see, gathered along the sequence:
    each seq-major leaf below the packed length (int4) or the length,
    the residual rings, the lengths."""
    from repro_torch.launch import sharded_cache as sc

    out = []
    for st in states:
        d = sc.gather_state(st).data
        L = int(d.length.max())
        if hasattr(d, "kv"):
            n = L - L % d.kv.window
            out.append([t[:, :, :n] for t in sc._seq_leaves(d)]
                       + [d.kv.k_residual, d.kv.v_residual, d.length])
        else:
            out.append([t[:, :, :L] for t in sc._seq_leaves(d)] + [d.length])
    return out


def _p18b_verify_read(state, cfg) -> int:
    """The split verify read against the split decode read at full width,
    on layer 0's split state of a plain run: SPEC_K seeded K/V rows
    appended after a snapshot, seeded fp32 queries; query i's verify read
    must equal the decode read of a copy that appended rows 0..i, bit for
    bit.  Returns the queries compared."""
    from repro_torch.launch import partitioning as pt

    def clone(s):
        return pt.tree_map_with_path(
            lambda _, t: t.clone() if isinstance(t, torch.Tensor) else t, s)

    g = torch.Generator(device="cuda").manual_seed(SEED + 182)
    k, Hkv, d = SPEC_K, cfg.n_kv_heads, cfg.head_dim
    kv = [(torch.randn((1, Hkv, 1, d), generator=g, device="cuda")
           .to(torch.bfloat16),
           torch.randn((1, Hkv, 1, d), generator=g, device="cuda")
           .to(torch.bfloat16)) for _ in range(k)]
    q = torch.randn((1, cfg.n_heads, k, d), generator=g, device="cuda")
    pol = state.policy
    ver, seq = state.map_shards(clone), state.map_shards(clone)
    snap = pol.snapshot_rows(ver)
    for kk, vv in kv:
        pol.update(ver, kk, vv)
    got = pol.verify_attend(q, ver, snap, scale=d ** -0.5, backend="gather")
    for i, (kk, vv) in enumerate(kv):
        pol.update(seq, kk, vv)
        want = pol.attend(q[:, :, i:i + 1], seq, scale=d ** -0.5,
                          backend="gather")
        assert torch.equal(got[:, :, i:i + 1], want), \
            f"verify query {i} != the split decode read"
    return k


def p18b_phase(model, params, plain) -> tuple[dict, dict]:
    """Speculative decoding on a cache split by position (``P18B_RUNS``),
    each spec stream held to the split-K plain stream of the same request
    and backend (``plain``: phase 18's random-prompt runs by policy), the
    graph spec to the eager spec, and layer 0's split verify read to the
    split decode read."""
    from repro_torch.core import cache_api

    vocab = model.cfg.vocab_size
    cache_api._KERNEL_VERIFY_WARNED = False
    launches, recs = {}, {}
    prompts = {kind: p18_prompt(vocab, P18B_PROMPT, kind)
               for kind in ("random", "repetitive")}
    for policy, backend, kinds in P18B_RUNS:
        n_q = _p18b_verify_read(plain[policy]["cache"]["attn"][0], model.cfg)
        held = None  # one engine, cache and captured pass for both prompts
        for kind in kinds:
            what = f"18b {policy} {backend} m={P18B_M} {kind}"
            # the repetitive prompt's plain stream reuses phase 18's engine,
            # cache and captured step (after the random prompt's checks)
            ref = plain[policy] if kind == "random" else p18_run(
                model, params, policy, backend, P18B_M, P18B_PROMPT,
                prompt=prompts[kind], held=plain[policy]["held"])
            got = p18b_spec(model, params, policy, backend, prompts[kind],
                            held=held)
            held = got["held"]
            n_eq = _first_diff(ref["toks"], got["toks"])
            rec = dict(got["rec"], bit_equal_prefix=n_eq,
                       plain_ms_per_token=ref["ms"],
                       verify_queries_bit_equal=n_q)
            if backend == "gather":
                assert n_eq == len(ref["toks"]), \
                    f"{what}: spec != plain from token {n_eq}"
                layers = ref["cache"]["attn"]
            else:
                _tie_check(ref["toks"], got["toks"], ref["logits"].cpu(),
                           f"{what} spec (GATHER verify) vs plain KERNEL")
                # a deeper layer's K/V come from the read below it, which
                # is B1's in the plain stream and GATHER's in the verify;
                # layer 0's come from the tokens alone
                layers = (ref["cache"]["attn"][:1]
                          if n_eq == len(ref["toks"]) else [])
            ra = _p18b_readable(layers)
            rb = _p18b_readable(got["cache"]["attn"][:len(layers)])
            for i, (la, lb) in enumerate(zip(ra, rb, strict=True)):
                for j, (x, y) in enumerate(zip(la, lb, strict=True)):
                    assert torch.equal(x, y), f"{what}: layer {i} leaf {j}"
            rec["readable_leaves_bit_equal"] = sum(map(len, ra))
            if policy == "int4-srft" and kind == "repetitive":
                e = p18b_spec(model, params, policy, backend, prompts[kind],
                              graph=False, n_new=P18B_EAGER_NEW)
                assert torch.equal(e["toks"],
                                   got["toks"][:P18B_EAGER_NEW]), \
                    f"{what}: graph spec != eager spec"
                rec["eager_ms_per_token"] = e["rec"]["ms_per_token"]
                del e
            launches[f"split_k_spec_{policy}_{kind}"] = got["rec"]["launches"]
            recs[f"{policy}/{kind}"] = rec
            log(f"[{CARD}] {what}: spec k={SPEC_K} vs split-K plain "
                f"{backend.upper()}: {n_eq} of {len(ref['toks'])} tokens "
                f"bit-equal"
                + f", {rec['readable_leaves_bit_equal']} readable cache "
                f"leaves bit-equal ({len(ra)} layers)"
                + f"; {rec['ms_per_token']:.3f} ms per emitted token graph"
                + ("" if "capture_s" not in rec
                   else f" (pass captured in {rec['capture_s']:.2f} s)"
                   if kind == kinds[0] else " (the same captured pass)")
                + (f", {rec['eager_ms_per_token']:.3f} eager"
                   if "eager_ms_per_token" in rec else "")
                + f" vs {ref['ms']:.3f} plain (events); acceptance "
                f"{rec['acceptance']:.3f} ({rec['accepted']}/"
                f"{rec['drafted']}), {rec['passes']} passes; B3 "
                f"{rec['launches']['srft_quant']}, B1 "
                f"{rec['launches']['quant_decode_attention']}; layer 0's "
                f"verify read == the split decode read for {n_q} queries")
            del got
        del held
    return launches, recs


def p18_phase(model, params) -> dict:
    """Split-K serving on phase 5's model (``P18_RUNS``), each run held to
    the unsharded run of the same request and backend; then speculative
    decoding on the split cache (18b)."""
    launches, recs, plain = {}, {}, {}
    t0 = time.perf_counter()
    for policy, backend, m, prompt_len, eager in P18_RUNS:
        n, rec, got = p18_case(model, params, policy, backend, m, prompt_len,
                               eager)
        launches.update(n)
        recs[f"{policy}/{backend}/m{m}"] = rec
        if m == P18B_M and prompt_len == P18B_PROMPT:
            plain[policy] = got
        del got
    t1 = time.perf_counter()
    n, spec = p18b_phase(model, params, plain)
    launches.update(n)
    del plain
    torch.cuda.empty_cache()
    log(f"[{CARD}] 18 summary " + json.dumps(recs))
    log(f"[{CARD}] 18b summary " + json.dumps(spec))
    log(f"[{CARD}] 18 {t1 - t0:.1f} s, 18b {time.perf_counter() - t1:.1f} s")
    return launches


# ------------------------------------------------------ phase 19: census

P19_PROMPT = PROMPTS[-1]
P19_GEMMS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")
P19_KERNELS = {"quant_decode_attention": "B1", "srft_quant": "B3"}


def _p19_class(op, dtype, kernel=False) -> str:
    """The join table's class of a census record, or of a profiled op
    (its name as ``aten.x``)."""
    from repro_torch.launch import cost

    if kernel:
        return P19_KERNELS.get(op, op)
    if op in P19_GEMMS:
        return ("fp32 GEMMs (rotations)" if dtype == "float32"
                else f"{dtype} GEMMs (weights)")
    if op.removeprefix("aten.") in cost.DATA_MOVEMENT:
        return "copies and fills"
    return "elementwise and reductions"


def _p19_state(model, params, prompt, steps):
    """A plain int4-srft cache holding ``prompt`` and ``steps`` decoded
    tokens, and the next token."""
    from repro_torch.launch.steps import make_decode_step

    cache = model.init_cache(1, S_MAX, policy="int4-srft",
                             generator=torch.Generator().manual_seed(SEED))
    step = make_decode_step(model, backend="kernel")
    lg, cache = model.prefill(params, prompt, cache)
    tok = lg[:, -1:].argmax(-1)
    for _ in range(steps):
        lg, cache = step(params, tok, cache)
        tok = lg[:, -1:].argmax(-1)
    return cache, tok


def _p19_first_diff(a, b) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x.key() != y.key():
            return f"record {i}: card {x} != meta {y}"
    return f"lengths {len(a)} != {len(b)}"


def _p19_device_us(prof, recs) -> tuple[dict, float, int]:
    """Device us of the profiled step by join class, the total, and the
    GEMM ops the profiler kept no kernel record of.  The port's kernels by
    name (``OWN_KERNELS``; a ctypes launch has no launching op); each
    GEMM op (``aten::mm``, ...) joined in order to the census's GEMM
    records, whose dtype tells rotations from weights (the profiler
    leaves the input dtypes empty); every other kernel by the op that
    launched it.  On the chip machine the profiler drops some kernel
    records (PERF.md), so a GEMM op may come with none: its time is
    missing, and counted.  Where the GEMM ops and the census's GEMMs do
    not pair up, the GEMM time stays in one class."""
    us = _kernel_us(prof)
    out = {"B1": sum(t for k, t in us.items() if "qda_" in k),
           "B3": sum(t for k, t in us.items()
                     if any(n in k for n in OWN_KERNELS["srft_quant.cu"]))}
    own = set().union(*OWN_KERNELS.values())
    def op(e):
        return "aten." + e.name.removeprefix("aten::")

    def in_gemm(e):  # a GEMM op's own inner ops (the CPU's mm.out)
        p = e.cpu_parent
        while p is not None and op(p) not in P19_GEMMS:
            p = p.cpu_parent
        return p is not None

    def kernels(e):  # of the op and every op inside it
        return e.kernels + [k for c in e.cpu_children for k in kernels(c)]

    gemms = [r for r in recs if r.op in P19_GEMMS]
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CPU"
                     and e.name.startswith("aten::") and not in_gemm(e)),
                    key=lambda e: e.time_range.start)
    n_gemm = sum(1 for e in events if op(e) in P19_GEMMS)
    paired = n_gemm == len(gemms)
    it = iter(gemms)
    no_kernel = 0
    for e in events:
        ks = kernels(e) if op(e) in P19_GEMMS else e.kernels
        t = sum(k.duration for k in ks if not any(n in k.name for n in own))
        if op(e) in P19_GEMMS:
            no_kernel += not ks
            cl = (_p19_class(op(e), next(it).dtype) if paired else
                  f"GEMMs ({n_gemm} profiled, {len(gemms)} censused)")
        elif not ks:
            continue
        else:
            cl = _p19_class(op(e), "")
        out[cl] = out.get(cl, 0.0) + t
    return out, sum(us.values()), no_kernel


def p19_phase(model, params) -> dict:
    """The cost census of one eager int4-srft KERNEL decode step, held
    against the same step on ``meta``, the launch counters and a profile
    of the step (see the module docstring, phase 19)."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import cost, op_probe, roofline
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.lm import LM

    t0 = time.perf_counter()
    cfg = model.cfg
    meta = LM(cfg, device="meta")
    meta_params = meta.init(torch.Generator())
    W = 16  # the int4-srft policy's residual window
    steps = (W - 1 - P19_PROMPT % W) % W  # the next append fills it
    g = torch.Generator(device="cuda").manual_seed(SEED + P19_PROMPT)
    prompt = torch.randint(0, cfg.vocab_size, (1, P19_PROMPT), generator=g,
                           device="cuda")
    with torch.no_grad():
        cache, tok = _p19_state(model, params, prompt, steps)
        m_cache, m_tok = _p19_state(meta, meta_params,
                                    torch.zeros_like(prompt, device="meta"),
                                    steps)
        assert cache["pos"] == m_cache["pos"] == P19_PROMPT + steps
        assert cache["attn"][0].data.kv.window == W
        step = make_decode_step(model, backend="kernel")
        m_step = make_decode_step(meta, backend="kernel")
        timed = [copy.deepcopy(cache) for _ in range(3)]
        torch.cuda.synchronize()
        _zero_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with cost.CostCounter() as cc:
                step(params, tok, cache)
            torch.cuda.synchronize()
        launched = _counters()
        with cost.CostCounter() as m_cc:
            m_step(meta_params, m_tok, m_cache)
        ev_ms = []
        for c in timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            step(params, tok, c)
            b.record()
            torch.cuda.synchronize()
            ev_ms.append(a.elapsed_time(b))
        del timed
    recs, m_recs = cost.costed(cc.records), cost.costed(m_cc.records)
    # (a) op for op
    same = [r.key() for r in recs] == [r.key() for r in m_recs]
    assert same, "19a census card != meta: " + _p19_first_diff(recs, m_recs)
    total = cost.summarize(recs)
    log(f"[{CARD}] 19a census of the eager int4-srft KERNEL step at "
        f"{P19_PROMPT}+{steps} tokens: card == meta op for op over the "
        f"{len(recs)} costed records (of {len(cc.records)}), "
        f"{total['flops']:.6e} FLOPs, {total['bytes accessed']:.6e}"
        f" bytes, {total['transcendentals']:.6e} transcendentals; device "
        f"branches on the path: the kernel wrappers (cpu: plain; cuda, "
        f"meta: launch path, no launch on meta), _plan's SM count")
    # (b) kernel records against the launch counters
    n_rec = {name: sum(1 for r in recs if r.kernel and r.op == name)
             for name in P19_KERNELS}
    for name, n in n_rec.items():
        assert n == launched[name] > 0, \
            f"19b {name}: {n} records, {launched[name]} launches"
    assert n_rec["quant_decode_attention"] == cfg.n_layers
    assert n_rec["srft_quant"] == 2 * cfg.n_layers
    log(f"[{CARD}] 19b census kernel records == launch counters: "
        + ", ".join(f"{P19_KERNELS[k]} {n}" for k, n in n_rec.items()))
    # (c) the join table
    rows = {}
    for r in recs:
        row = rows.setdefault(_p19_class(r.op, r.dtype, r.kernel), dict(
            ops=0, bytes=0, flops=0.0, bound_ms=0.0, us=0.0))
        row["ops"] += 1
        row["bytes"] += r.nbytes
        row["flops"] += r.flops
        row["bound_ms"] += roofline.op_bound_s(r) * 1e3
    dev_us, busy_us, no_kernel = _p19_device_us(prof, recs)
    for cl, t in dev_us.items():
        rows.setdefault(cl, dict(ops=0, bytes=0, flops=0.0, bound_ms=0.0,
                                 us=0.0))["us"] += t
    rot_src = sorted({r.src for r in recs if r.op in P19_GEMMS
                      and r.dtype == "float32"})
    log(f"[{CARD}] 19c the eager step by class (device us from one "
        f"profiled step; bound = sum over the class's ops of max(bytes / "
        f"{roofline.HW.DATASHEET_HBM_BYTES_PER_S:.3g} B/s, FLOPs / the "
        f"dtype's peak)); fp32 GEMMs at {rot_src}:")
    log(f"  {'class':28s} {'ops':>5s} {'device us':>10s} {'MB':>9s} "
        f"{'GFLOP':>9s} {'bound us':>9s} {'share':>6s}")
    for cl, row in sorted(rows.items(), key=lambda kv: -kv[1]["us"]):
        share = row["bound_ms"] * 1e3 / row["us"] if row["us"] else None
        row["share"] = share
        log(f"  {cl:28s} {row['ops']:5d} {row['us']:10.1f} "
            f"{row['bytes'] / 1e6:9.3f} {row['flops'] / 1e9:9.4f} "
            f"{row['bound_ms'] * 1e3:9.2f} "
            f"{'-' if share is None else f'{share:.3f}':>6s}")
    attributed = sum(row["us"] for row in rows.values())
    bound_ms = roofline.step_bound(recs) * 1e3
    ms = sorted(ev_ms)[1]
    log(f"[{CARD}] 19c step_bound {bound_ms:.4f} ms vs {ms:.4f} ms by "
        f"events (median of {len(ev_ms)}: {[round(x, 4) for x in ev_ms]}; "
        f"share {bound_ms / ms:.3f}), device busy {busy_us / 1e3:.4f} ms "
        f"in the profiled step (share "
        f"{bound_ms * 1e3 / max(busy_us, 1e-9):.3f}; "
        f"{attributed / max(busy_us, 1e-9):.3f} of it joined to a class; "
        f"{no_kernel} GEMM ops with no kernel record kept)")
    # (d) the top ops by output bytes
    log(f"[{CARD}] 19d op_probe top 10:")
    for line in op_probe.report(recs, top=10, kinds=10):
        log("  " + line)
    summary = dict(prompt=P19_PROMPT, steps_before=steps,
                   records=len(recs), cost=total, launches=n_rec,
                   step_bound_ms=bound_ms, events_ms=ev_ms,
                   device_busy_ms=busy_us / 1e3,
                   gemms_without_kernel_record=no_kernel,
                   classes={k: {kk: (round(v, 6) if isinstance(v, float)
                                     else v) for kk, v in row.items()}
                            for k, row in rows.items()},
                   seconds=time.perf_counter() - t0)
    log(f"[{CARD}] 19 summary " + json.dumps(summary))
    return {"census": launched}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    global CARD
    require_card()
    t_start = time.perf_counter()
    secs = {}  # phase -> seconds
    os.environ["REPRO_BF16_DOTS"] = "1"  # read when repro_torch.models loads
    sys.path.insert(0, str(ROOT / "src"))
    _read_card_rates()
    card = CARD = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off, "
        f"bf16 reduced-precision reductions off")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs["build"] = time.perf_counter() - t0
    log(f"kernels built in {secs['build']:.1f}s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for r in pass1_registers(_build.BUILD_LOG.get("quant_attention", "")):
        log(f"[{card}] qda_split_kernel_tc<{r['rows']}Rows, NW {r['NW']}, "
            f"NB {r['NB']}, PN {r['PN']}>: {r.get('registers')} registers, "
            f"spill {r.get('spill_stores')}/{r.get('spill_loads')} bytes, "
            f"stack {r.get('stack')}")

    t0 = time.perf_counter()
    flush = L2Flush()
    with ClockSampler() as clock:
        kernels = kernel_phase(flush)
    secs["kernels"] = time.perf_counter() - t0
    log("SM clock during the kernel timings (nvidia-smi, 50 ms polls):")
    mhz = {}
    for label, ms, t0, t1 in TIMED:
        m = clock.mhz(t0, t1)
        mhz[label] = [min(m), max(m)] if m else None
        log(f"  {label}: {ms:.5f} ms, SM clock {mhz[label]} MHz "
            f"({len(m)} samples, {t1 - t0:.2f} s)")
    for k, label in zip(kernels, ("B3", "B1", "B2", None)):
        k["sm_mhz"] = mhz[label] if label else [
            mhz[f"B4 round {i}"] for i in range(B4_ROUNDS)]
    kernels[-1]["raw_view"]["sm_mhz"] = mhz["B4 raw view"]
    kernels[-1]["restore_view"]["sm_mhz"] = mhz["B4 raw view (restored)"]
    t0 = time.perf_counter()
    small_reference_phase()
    secs["small_reference"] = time.perf_counter() - t0
    from repro_torch.models import common

    t0 = time.perf_counter()
    with common.dot_mode(False):
        log("dot mode for the quality path: fp32 operands, TF32 off")
        quality = quality_phase()
        quality_reference_phase()
    secs["quality"] = time.perf_counter() - t0
    log(f"quality phase {secs['quality']:.1f}s")
    t0 = time.perf_counter()
    launches, model, params = main_path_phase()
    secs["main_path"] = time.perf_counter() - t0
    log(f"main path phase {secs['main_path']:.1f}s")

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t
        log(f"{name} phase {secs[name]:.1f}s")
        return out

    batch, mono, pre_mono = timed("batch", batch_phase, model, params)
    chunked = timed("chunked", chunked_phase, model, params, mono, pre_mono)
    spec = timed("spec", spec_phase, model, params, mono, pre_mono)
    offload = timed("offload", offload_phase, model, params)
    learned = timed("learned", learned_phase, model, params)
    served = timed("serve", serve_phase, model, params)
    sharded = timed("p16", p16_phase, model, params)
    split_k = timed("p18", p18_phase, model, params)
    census = timed("p19", p19_phase, model, params)
    del model, params, mono, pre_mono  # their engines hold ~10 GB
    _free_cuda()
    log(f"before phase 14: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    t0 = time.perf_counter()
    configs = p14_phase()
    secs["p14"] = time.perf_counter() - t0
    log(f"[{card}] phase 14 {secs['p14']:.1f}s")
    t0 = time.perf_counter()
    families = p15_phase()
    secs["p15"] = time.perf_counter() - t0
    log(f"[{card}] phase 15 {secs['p15']:.1f}s")
    _free_cuda()
    t0 = time.perf_counter()
    trained = p17_phase()
    secs["p17"] = time.perf_counter() - t0
    log(f"[{card}] phase 17 {secs['p17']:.1f}s")
    by_path = {"engine": launches, **batch, **chunked, **spec, **offload,
               "quality": quality, **learned, **served, **configs,
               **families, **sharded, **trained, **split_k,
               **census}
    own_path = {"quant_decode_attention_paged": "batch_paged",
                "srft_dequant": "batch_chunked_paged"}
    for k in kernels:
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in by_path.items()}
        k["launches"] = k["launches_by_path"][own_path.get(k["name"],
                                                           "engine")]
        assert k["launches"] > 0, f"{k['name']} never launched on its path"
    secs["total"] = time.perf_counter() - t_start
    log(f"[{card}] phase seconds " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
