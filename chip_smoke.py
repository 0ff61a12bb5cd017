#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py

It runs every phase, in order, each printing one JSON line:

  1. device   -- the card's name and power limit (nvidia-smi), TF32 flags;
  2. build    -- nvcc builds the kernels from ``csrc/`` (seconds);
  3. kernels  -- K1-K7 at the main path's shapes: each kernel against its
                 plain PyTorch version on the same inputs (tolerance and
                 reason stated), kernel / plain / library-call times and
                 the least time the card could take (bound); K1 on the
                 solver's own operands (a 0-d interval read at stride 0:
                 one device kernel a call, the same bits as the interval
                 materialised, which a second line times), and at 4177
                 lanes, each with the profiler's device time a launch, a
                 CUDA-graph replay and the calls back to back, beside an
                 empty launch read the same three ways (the floor); K2,
                 K4, K5 and K6 timed as CUDA-graph replays (graph_ms),
                 because a wrapper's host work can outlast its kernel,
                 with the calls back to back beside them (wrapper_ms); K2
                 and K4
                 on the tiled route and K5 on the wgmma route, with the
                 same bits from two launches (the sparse and trace phases
                 assert that every K2, K4 and K5 launch took it); K4's
                 rows route on the GMRF benchmark cell's table at 4096
                 lanes, every launch on it, with the same bits twice; K6 one
                 device kernel a call, with the same bits twice; K3 also
                 on a mid-solve state with its live-row count (the bound
                 counts the live rows), with its matvec and tail launches
                 timed apart; K7 with its route and its TFLOP/s;
  4. dense    -- RBF kernel at Abalone's N = 4177 (paper Table 1), K = 64
                 lanes: solve_batch (fused, reorth; every K3 launch gets the
                 live-row count), a greedy-MAP argmax round over stacked
                 masks (fused), judge_batch (pallas);
  5. sparse   -- ring-lattice graph Laplacian, N = 8192 (GR/HEP regime),
                 blocked-ELL bs = 128, f32 data, K = 64 lanes of f64
                 queries: solve_batch on the fused (K4) and pallas (K2 +
                 K1) backends, judge_batch (fused);
  6. trace    -- bracketed logdet of the sparse operator (f32 blocks, f64
                 probes): logdet_quad with 512 Rademacher probes as 64
                 block lanes of 8 (block-Krylov, K5 on 'pallas'; again on
                 'reference'), and with 64 scalar probes on 'fused' (K4
                 and the matrix-function eigensolve); every lane's
                 bracket holds its tr Z^T log(A) Z from a dense eigh;
  7. bilinear -- a ridge sweep over the dense phase's kernel, 16 systems
                 A_b = K + lam_b I stored as (16, 4177, 4177) f32, one lane
                 each: solve_batch and judge_batch with a MatvecFn over
                 fused_matvec on 'pallas' (K6 + K1), and with Dense on the
                 same f32 matrices on 'reference'; every bracket holds its
                 dense-solve truth;
  8. apps     -- the paper's applications on the dense phase's kernel:
                 DPP and k-DPP chains of 128 moves from a seeded mask of
                 about N/3 items on 'pallas' (K1 at one or two lanes a
                 judge), 'fused' (K3), exactly (dense solves) and
                 incrementally (a carried Cholesky factor), all with the
                 same masks and accepts, every move certified; greedy MAP
                 (k = 32, all 4177 items as lanes) over the kernel weighted
                 by seeded item qualities, on 'pallas', 'fused', exactly,
                 warm-started and incrementally, one order, every step
                 certified, the quadrature runs through K1 / K3; double
                 greedy over a 1024-item kernel on
                 'pallas' and exactly, the same selection;
  9. serve    -- the serving path, BIFEngine (continuous batching, 64
                 lanes, chunks of 8 iterations) over 256 requests (3/4
                 judges, 1/4 brackets, 1/8 masked, 8 budget partials
                 resubmitted, 4 expired at the door): serve-dense on the
                 dense operator continuous on 'pallas' (K1), 'fused' (K3)
                 and 'reference', lockstep on 'fused'; serve-sparse on the
                 blocked-ELL operator on 'pallas' (K2 + K1), 'fused' (K4)
                 and 'reference'; serve-kv, rank_blocks over one
                 llama3-405b KV head's 32768 keys (256 blocks; K1 f32 on
                 'pallas', K3's f32 route on 'fused') and a BlockRanker
                 grown by 8 blocks; the obs smoke on the card. Equal
                 decisions and flags on every backend and mode, brackets
                 holding their truths, partials resuming bit-exactly,
                 results bit-identical with telemetry on and off;
 10. sharded  -- the multi-device lanes (core/sharded.py): the dense cell's
                 solve and judge on 'pallas' (K1) and 'fused' (K3), its
                 greedy-MAP argmax round on 'fused', the sparse cell's
                 solve on 'pallas' (K2 + K1) and 'fused' (K4), each with
                 its 64 lanes split over a lane mesh: at D = 1 on NCCL in
                 this process, then at D = 2 and 4 on gloo ranks that
                 share the card (spawned; NCCL takes a card a rank; on a
                 machine with more cards, NCCL over all of them too), with
                 the dense cell again at 62 lanes (padding at D = 4), and
                 at D = 2 the block logdet (K5), the serve-dense traffic
                 through BIFEngine(mesh=) and greedy MAP (k = 32). Each
                 against the same call on one device: equal outcomes on
                 every rank, iterations within 1, brackets within the
                 stated slack and around their truths, one gather a
                 round, the expected kernel routes on every rank;
 11. attention -- one attention layer of llama3-405b (128 query heads over
                 8 kv heads, head width 128, bf16): mha_flash over a 4096-
                 token causal prefill (which must take the wgmma route), a
                 decode-shaped call (one query over the 4096 keys) and an
                 f32 call over 16 heads, each against the plain version on
                 the card row by row, and the same measure on planted
                 faults, which it must catch;
 12. coo      -- two SparseCOO matvecs on the card give identical bits;
 13. train    -- the training path: olmo-1b at its published width
                 (16 layers, d_model 2048, 16 heads, d_ff 8192, vocab
                 50304, bf16, 1,176,764,416 parameters) for 8 steps of
                 8 x 1024 tokens through the launcher's own pieces
                 (launch.train.build_run): the DPP batch selector, AdamW
                 with warmup-cosine, the GQL spectral monitor every 4
                 steps, async checkpoints; it holds (a) the card to the
                 port's CPU path (2 layers, f32), (b) bf16 to f32 at step
                 0, (c) the loss falling, (d) the monitor's brackets
                 around their dense truths, (e) every DPP selection
                 certified and equal to the exact chain's, (f) a crash at
                 step 6 resuming from step 4 with the uninterrupted run's
                 losses (2 layers), (g) no kernel launched; and prints
                 seconds a step, tokens/s, the share of the bf16 peak,
                 peak memory, the monitor's and the selector's seconds
                 and each checkpoint's seconds and bytes;
 14. generate -- the LM's serving path: olmo-1b at its published width
                 (bf16, the train phase's parameters' seed) served by
                 Engine.generate: 8 requests with prompts of 512-1024
                 tokens from the seed, left-padded, 64 new tokens each,
                 max_seq 1152, with the default f32 cache, an int8 cache
                 and at temperature 0.8 (seeded draws); it holds (a) the
                 card to the port's CPU path (2 layers, f32, prompts of
                 at most 128 tokens, 8 new tokens: logits within 1e-5,
                 tokens up to the first step whose top-2 margin is under
                 it), (b) a decode step to a prefill, request by
                 request (bf16, 2e-2; also at 4 and 8 layers, and at 16
                 with the weights in f32, 3e-5), (c)
                 int8 to f32 caches (prefill logits, the first token),
                 (d) Engine.generate to a manual prefill + decode_step
                 loop, (e) the same draws giving the same tokens, each
                 the argmax of logits / T + g, (f) no kernel launched;
                 and prints the prefill seconds, the decode seconds a
                 step, tokens/s, peak memory and a decode step's bytes
                 against its bound. Every LM phase (14-19) also reads
                 the control and the faults its limits must see: (a)
                 with TF32 matmuls on the card must exceed (a)'s limit;
                 (b) with planted faults (a MoE model's excepted: the
                 step one position early, fed the previous token, a
                 hybrid's units reading each other's KV caches, the
                 conv carries lost), each of which must exceed (b)'s
                 limit in f32, and one of which at least must at each
                 depth in bf16;
 15. moe      -- the MoE family served: llama4-maverick (d_model 5120,
                 40 / 8 heads of 128, d_ff 8192, 128 experts top-1 with a
                 shared expert, vocab 202048) cut to one unit (a dense
                 block, then a MoE block: 2 of 48 layers, 18.55e9
                 parameters), then arctic (d_model 7168, 56 / 8 heads,
                 d_ff 4864, 128 experts top-2 with a dense residual, vocab
                 32000) cut to 1 of 35 layers, both bf16 with parameters
                 from the seed, each served by Engine.generate: 8
                 requests of 512-1024 prompt tokens (the longest 1024:
                 two groups of 4096 tokens), 32 new tokens each, max_seq
                 1056, the default f32 cache; it holds (a) the card to the
                 port's CPU path (2 layers, 8 experts, f32, prompts of at
                 most 128 tokens, 8 new tokens: logits within 1e-5 and
                 dispatch masks equal up to the first step whose router
                 gap is under it, tokens up to the first router or logit
                 gap under it), (b) a decode step to a prefill (bf16,
                 2e-2) for every request whose last prompt token kept its
                 expert slots (and prints how many did not; this holds
                 for a one-unit cut only, which it asserts), and for two
                 requests whose prefills, of T - 1 and of T tokens, each
                 run alone at a capacity that drops nothing (cap = g),
                 (d) Engine.generate to a manual loop, (f) no kernel
                 launched; and prints the prefill's groups, capacity and
                 dropped share, its router inputs' cosine to their
                 group's mean beside the embedded prompt tokens', the
                 prefill seconds, the decode seconds a
                 step, tokens/s, peak memory and a decode step's bytes
                 as written (every expert, the unembedding table's f32
                 cast) and as needed (the chosen experts) against 3.35
                 TB/s;
 16. ssm      -- the SSM family served: falcon-mamba-7b at full width and
                 depth (64 mamba1 layers, d_model 4096, d_inner 8192,
                 state 16, conv 4, vocab 65024, bf16), the same traffic
                 and checks (a) (2 layers), (b) (every request; bf16 at
                 16, 32 and 64 layers, within 2e-2 sqrt(layers / 16),
                 and the 64 layers with the weights in f32, 3e-5), (d),
                 (f), and the same prints;
 17. hybrid   -- the hybrid family served: zamba2-1.2b whole (38 mamba2
                 layers in 6 units of 6 and a tail of 2, each unit closed
                 by the ONE shared attention block with its own KV cache;
                 d_model 2048, 32 heads of 64, d_ff 8192 gelu, state 64,
                 vocab 32000, window 8192, bf16), LM's traffic through
                 Engine.generate and checks (a) (one unit and its tail,
                 8 layers, within 1e-4), (b) (every request; bf16 at 8,
                 20 and 38 layers within 4e-2 sqrt(max(1, layers / 16)),
                 f32 at 38), (d), (f) (the hybrid's fixed limits:
                 FAMILY_TOL); then one request of 8704 prompt tokens, 16
                 new, whose decode steps the window cuts off from the
                 first 527 positions: served again with the weights in
                 f32, the Engine's last step (after its chunked prefill)
                 against a full-route prefill of the same 8719 tokens,
                 within 3e-4, and one decode step against it, within
                 3e-5; a prefill without the window must read above 3e-4
                 and that decode step with its window one position short
                 above 3e-5;
 18. encdec   -- the enc-dec family served: whisper-medium whole (24
                 encoder and 24 decoder layers, d_model 1024, 16 heads of
                 64, d_ff 4096 gelu, layernorm, biases, sinusoidal
                 positions, vocab 51865, bf16): 8 requests of 1500 frames
                 from the seed and decoder prompts of 4-64 tokens, left-
                 padded, 64 new, max_seq 448, as a greedy loop through
                 launch.steps (the Engine builds token-only batches; (d)
                 does not apply), each decode step re-projecting every
                 layer's cross k / v from the encoder memory, which the
                 caller makes apart (timed apart); checks (a) (2 + 2
                 layers, 256 frames), (b) (a quarter, half and all of
                 both stacks; f32), (f);
 19. vlm      -- the VLM family served: qwen2-vl-2b whole (28 layers,
                 d_model 1536, 12 / 2 heads of 128, d_ff 8960 swiglu,
                 biases, M-RoPE, vocab 151936, bf16): 8 requests of a
                 16 x 16 grid of patch embeddings from the seed and 768
                 text tokens at Qwen2-VL's positions (image tokens at
                 (0, row, col), text from 16 onward on all three streams),
                 64 new, max_seq 1088, as the greedy loop through
                 launch.steps; checks (a) (2 layers, a 4 x 4 image), (b)
                 ((B, 3, 1) decode positions; 7, 14, 28 layers; f32), (f);
                 each of the three prints the same measures as the moe and
                 ssm phases, a decode step's operations beside its bytes
                 (whisper's cross projections as written: every step; as
                 needed: kept);
 20. parallel -- data- and model-parallel training: olmo-1b at its
                 published width cut to 2 layers, 8 x 1024 tokens, 2
                 steps (f32 checks, bf16 times) under each plan of
                 PAR_PLANS: D = 1 on NCCL in this process; model = 2
                 (saving a checkpoint after step 1), data = 2 (with a
                 planted fault and the elastic restore) and data = 2 x
                 model = 2 with 2 microbatches on gloo ranks sharing the
                 card; the FSDP plan, which gloo refuses (PAR_GLOO_
                 REFUSED), on NCCL a rank a card where there are four
                 cards. It holds every rank to the same loss and shard
                 bits, each plan to the one-device run (PAR_TOL), the
                 fault above those limits, the restored arrays bit for
                 bit and step 2's loss, compressed_psum to its formula
                 at D = 2 and 4, and no kernel launched; and prints each
                 plan's seconds a step, seconds in collectives, bytes a
                 step from the placements and peak memory per rank;
                 the data = 2 x model = 2 plan's ranks record step 2's
                 collectives (utils.comms.StepCensus) for the dryrun
                 phase's (c), and the FSDP plan's ranks theirs, whose
                 all-gathers must be those par_fsdp_gathers reckons (a
                 unit of the stack gathered in its block's forward and
                 again in its recompute), with no rank's peak above
                 PAR_FSDP_PEAK; then fsdp_wide, where the machine has
                 four cards (else a line says so): WIDE_PLANS at their
                 published widths, cut in depth only (llama3-405b at 4
                 layers, arctic-480b's one MoE layer), data = 2 x model
                 = 2 with FSDP on NCCL, a card a rank, bf16, 2 steps of
                 8 x 1024 tokens, each plan's parameters drawn and
                 placed a leaf at a time; it holds (a) every rank to the
                 same loss bits and arrays, (b) step 1's loss to a
                 no_grad forward of the same parameters on one card
                 (WIDE_TOL; a planted fault, the unembedding's gather
                 dropped, must read above it), (c) the loss falling,
                 (d) each rank's allocator peak under the card's 80 GB
                 and at most WIDE_MEM above its plan's fake world-4
                 trace,
                 (e) no kernel launched, and W1's all-gathers to the
                 reckoning; and prints seconds a step, collective
                 seconds, bytes a step and the share of the bf16 peak;
 21. train_families -- falcon-mamba-7b cut to 16 layers, zamba2-1.2b to
                 20 (3 of its 6 units and the tail), whisper-medium and
                 qwen2-vl-2b whole, bf16, trained 2
                 steps on one fixed batch of 8 sequences; checks (a) one
                 f32 step at LM_CUT's depth on the card against the
                 CPU, with TF32 as the control, (b) bf16 against f32 at
                 step 0, (c) the loss falling, (g) no kernel launched;
                 prints seconds a step, positions/s, the share of the
                 bf16 peak and peak memory;
 22. dryrun   -- the tooling analogs (launch/dryrun.py, launch/roofline.py,
                 utils/comms.py, analysis/): (a) the dry-run CLI, a
                 process a cell, each standing as rank 0 of a fake group
                 of 256 (16 x 16) or 512 (2 x 16 x 16) ranks on the
                 production mesh (DRY_CELLS: olmo-1b and llama4-maverick
                 train_4k, falcon-mamba-7b long_500k, olmo-1b train_4k on
                 the multi-pod mesh): each record's compute, memory and
                 collective seconds, the dominant one, the roofline
                 fraction, HBM GB a rank against the card's 80 GB and
                 the trace seconds (every cell must be ok, and the
                 FSDP cell, DRY_FSDP_FITS, within the card's 80 GB),
                 then the roofline CLI over them; (b) the parallel
                 phase's D = 1 step (olmo-1b, 2 layers, 8 x 1024 tokens,
                 bf16) run for real on a NCCL group of one under
                 utils.comms.StepCensus, before any other process of the
                 phase starts, and traced by dryrun.run_cell on a fake
                 world of 1: the same flops and op bytes, the measured
                 step seconds beside bound_step_time_s and model_flops /
                 989e12 / seconds, the allocator's peak beside the
                 traced one; (c) each gloo rank's collectives of the
                 parallel phase's data = 2 x model = 2 plan against
                 dryrun.run_cell's trace of that plan on a fake world of
                 4: the same kinds, counts and bytes, beside par_bytes'
                 reckoning; (d) python -m
                 repro_torch.analysis src/repro_torch clean, and
                 examples/quickstart_torch.py and sensor_placement_torch.py
                 on the card (the brackets hold the printed truth, every
                 judge certified, no uncertified decision); (e) the fake
                 world-4 traces of the parallel phase's FSDP plan and of
                 fsdp_wide's W1: their all-gathers those par_fsdp_gathers
                 reckons, in count and bytes; the traced peaks a rank of
                 W1 (and of W2 where fsdp_wide ran), under the card's
                 80 GB;
 23. profile  -- each path call again (and the DPP chain and the greedy
                 MAP call on 'pallas', with K1's share, the serve-dense
                 flushes on 'pallas' and 'fused', the generate phase's
                 prefill and one decode step, and the same two calls of
                 llama4 cut as the moe phase cuts it, of falcon-mamba-7b,
                 zamba2-1.2b, whisper-medium and qwen2-vl-2b), warm: host
                 seconds beside the device time of every kernel it
                 launched (torch.profiler; CUDA events for the one-launch
                 attention call), so the card's idle share is
                 1 - device / host;
 24. yardsticks -- the library calls beside K2, K4, K5 (BSR @ dense) and
                 K6 (torch.bmm + dot), each timed in turns with its kernel
                 (kernel, library, library, kernel; three rounds; medians
                 and their factor; the kernel both as calls back to back
                 and as a CUDA-graph replay), last: the BSR calls may run
                 Triton kernels, after which the profiler misses calls
                 that launch only the port's kernels.

Every path phase holds the port against the same calls on
``backend='reference'`` on the same card and against dense solves for the
truth; every lane of a solve, on either backend, must certify before the
cap. Launch counters are zeroed just before each path phase and read
just after. Any failure raises and exits non-zero; there is no fallback
to the CPU. The last line is the device contract line.

    python3 chip_smoke.py --phases device,parallel

runs the named phases alone, in the order above, and ends with their
seconds instead of the kernels and contract lines (on four cards, the
parallel phase with its fsdp_wide part).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

try:
    import torch
except ImportError:  # no PyTorch at all: nothing to drive
    torch = None

PHASES = ("device", "build", "kernels", "dense", "sparse", "trace",
          "bilinear", "apps", "serve", "sharded", "attention", "coo",
          "train", "generate", "moe", "ssm", "hybrid", "encdec", "vlm",
          "parallel", "train_families", "dryrun", "profile", "yardsticks")
KERNELS = ("gql_update", "bell_matvec", "fused_step_dense", "fused_step_bell",
           "bell_matvec_mrhs", "fused_matvec", "flash_attention")
# the device functions of csrc/ as the profiler names them
PORT_KERNELS = ("gql_update_kernel", "bell_fma_kernel", "bell_dmma_kernel",
                "bell_lane_kernel", "dmma_matvec_kernel", "lane_matvec_kernel",
                "shared_matvec_kernel", "fused_tail_kernel",
                "bell_mrhs_kernel", "bell_mrhs_wgmma_kernel",
                "fused_matvec_kernel", "flash_fwd_fma_kernel",
                "flash_fwd_mma_kernel", "flash_fwd_wgmma_kernel")

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and
# dense flops/s for each type. f64 is the FP64 tensor-core rate, the
# highest the card has for f64 work; f32 is the rate outside the tensor
# cores (f32 must not go through TF32 here); bf16 the dense tensor-core
# rate.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12} if torch else {}

K = 64          # lanes of the main path
SEED = 0
# Each solve runs to its tolerance: at these caps every lane of both paths
# certifies before the cap (the path phases assert it).
DENSE = dict(max_iters=160, rtol=1e-6)
SPARSE = dict(max_iters=384, rtol=1e-3)
# The logdet of the sparse operator (trace phase). The caps come from a
# CPU rehearsal of this phase at N = 8192 on the plain path (the recipe
# in .claude/skills/verify/SKILL.md): at a cadence of 8 (a lane stops at
# 1 + 8k iterations) every block lane certified at 49 iterations and
# every scalar lane by 57, below the caps. The bracket's eigensolve,
# whose size the cap sets, runs once per round; its time is in the
# profile phase (PERF.md).
PROBES, BLOCK, SCALAR_PROBES = 512, 8, 64
TRACE_BLOCK = dict(max_iters=64, rtol=1e-3, decide_every=8)
TRACE_SCALAR = dict(max_iters=96, rtol=1e-3, decide_every=8)
# The K6 path (bilinear phase): a ridge sweep lam_b = 0.05 * 2^(b/4),
# b = 0..15, over the dense phase's RBF kernel, each system stored in f32
# as the kernel reads it, one f64 query lane per system. The cap and
# tolerance come from a CPU rehearsal of this phase at full size on the
# plain path (a Smoke on the CPU device, its timing helpers stubbed): at
# rtol 1e-6 every solve lane certified by 56 iterations (mean 34.4),
# every judge by 8, and the cap leaves room above them.
SYSTEMS = 16
BILINEAR = dict(max_iters=80, rtol=1e-6)
# The paper's applications (apps phase), on the dense phase's kernel:
# DPP and k-DPP chains of 128 moves from a seeded mask of about N/3
# items, greedy MAP with k = 32 over all N = 4177 candidates as lanes,
# and double greedy over a 1024-item kernel from the same builder (a depth
# cut: Alg. 8 judges the items one at a time, and 4177 sequential judges
# would not fit the run). The cap is far above what a judge needs, so
# that every decision certifies (the phase asserts it).
# Greedy MAP runs on the quality-diversity form of the kernel,
# L = diag(q) K diag(q) with log q_i ~ N(0, QUALITY_SD^2) from the seed:
# on K itself every diagonal is 1.05, so each round picks the first item
# that no selected item touches, the race resolves at its first bracket
# and no kernel runs (a CPU rehearsal at N = 2000, k = 24 on the plain
# path: 0 K1 calls on K, 9 on L).
CHAIN_STEPS, GREEDY_K, DG_N, QUALITY_SD = 128, 32, 1024, 0.5
APPS = dict(max_iters=400)
# The serving path (serve phase): BIFEngine over the dense and sparse
# phases' operators, with their intervals, SERVE_REQUESTS requests through
# a SERVE_POOL-lane pool in chunks of SERVE_CHUNK iterations: 3/4 threshold
# judges 3-8x off their dense-solve truth, 1/4 brackets to the cell's
# rtol (benchmarks/engine_throughput.py's mix); every 8th over a seeded
# principal-submatrix mask of about N/3 items; SERVE_PARTIAL unmasked
# brackets with a budget of SERVE_BUDGET iterations, resubmitted with the
# full budget; on the dense cell SERVE_EXPIRED judges whose deadline has
# passed.
SERVE_REQUESTS, SERVE_POOL, SERVE_CHUNK = 256, 64, 8
SERVE_PARTIAL, SERVE_BUDGET, SERVE_EXPIRED = 8, 4, 4
SERVE_DENSE = dict(max_iters=160, rtol=1e-6)
SERVE_SPARSE = dict(max_iters=384, rtol=1e-3)
# serve-kv: rank_blocks over the keys of one llama3-405b KV head (head
# width 128, src/repro/configs/llama3_405b.py): a 32768-token context of
# 64 segments of 512 tokens, each token its segment's seeded centre plus
# N(0, KV_NOISE^2) noise per coordinate; 256 blocks of 128 (n_pad = 256).
# Then a BlockRanker over the same keys, extended by KV_MORE keys (8
# blocks) and ranked again. The f32 slack: a CPU rehearsal of this cell on
# the plain path missed its f64 truths by at most 3.9e-7 relative.
KV_TOKENS, KV_DIM, KV_CLUSTERS, KV_BLOCK, KV_MORE = 32768, 128, 64, 128, 1024
KV_NOISE, KV_COARSE, KV_SLACK = 4.0, 8, 1e-5
KV = dict(max_iters=64, rtol=1e-3)
# The multi-device lanes (sharded phase): the dense and sparse cells'
# calls with their K lanes split over a lane mesh, each against the same
# call on one device in this process. NCCL refuses two ranks on one
# card, so NCCL runs at D = 1 in this process, and gloo ranks sharing
# card 0 run D = 2 and 4 (SHARDED_SPAWNS: spawned after the build, so
# they load the built kernels; the round's scalars through host memory).
# The dense cell again with SHARDED_PADDED_K lanes (padding at D = 4); at
# D = 2 also the trace, serve-dense and greedy-MAP calls. On a machine
# with more than one card, NCCL also runs one rank a card over all of
# them, with every call.
SHARDED_CALLS = ("dense solve pallas", "dense solve fused",
                 "dense judge pallas", "dense judge fused",
                 "dense argmax fused", "sparse solve pallas",
                 "sparse solve fused")
SHARDED_ALL = SHARDED_CALLS + ("dense62 solve pallas", "trace logdet pallas",
                               "serve flush pallas", "greedy map pallas")
SHARDED_SPAWNS = ((2, "gloo", SHARDED_ALL),
                  (4, "gloo", SHARDED_CALLS + ("dense62 solve pallas",)))
SHARDED_PADDED_K, SHARDED_TIMEOUT_S, SHARDED_THREADS = 62, 300.0, 2
# the calls a spawned rank warms and profiles (device seconds, idle share)
SHARDED_PROFILED = ("dense solve pallas", "dense solve fused",
                    "sparse solve pallas", "sparse solve fused")
# Brackets of a lane that took the same steps on D ranks and on one
# device agree within SHARDED_SLACK relative where the lane's arithmetic
# does not depend on the batch width (K1, K2's tiled route, K4, K5, the
# judges' and the race's brackets: 0 to 1.2e-13 on the card). The dense
# cell's matvec does: cuBLAS picks another gemm for (32, N) or (16, N)
# queries than for (64, N) on 'pallas', as K3's tile does on 'fused', and
# Lanczos without reorthogonalisation amplifies those last bits over the
# solve's 113 steps to 3.7e-8 (PERF.md). There the two brackets, both
# certified to the cell's rtol, are held to that width and to the
# dense-solve truth instead.
SHARDED_SLACK = 1e-12
SHARDED_WIDTH_CALLS = ("dense solve pallas", "dense solve fused",
                       "dense62 solve pallas", "serve flush pallas")
# the kernels each call must launch on every rank: {kernel: route
# counter that must equal its launches, or None}
SHARDED_KERNELS = {
    "pallas": {"gql_update": None}, "fused": {"fused_step_dense": "dmma"},
    "sparse pallas": {"gql_update": None, "bell_matvec": "tiled"},
    "sparse fused": {"fused_step_bell": "bell_dmma"},
    "trace": {"bell_matvec_mrhs": "wgmma"}}
# The K7 path (attention phase): one attention layer of llama3-405b
# (src/repro/configs/llama3_405b.py: 128 query heads over 8 kv heads,
# head width 128, bf16 weights and activations), a 4096-token prefill.
TOKENS, HEADS, KV_HEADS, HEAD_DIM = 4096, 128, 8, 128
F32_HEADS = 16    # the f32 call's heads (BH), over one kv head
PLAIN_HEADS = 16  # heads per chunk of the plain version: (16, T, S) f32
# K7 is held row by row (row_errors): for each (head, query row) the
# relative 2-norm error over the head width, the largest over rows, so a
# late causal row, whose outputs are near sqrt(e / T), is read at its own
# scale. bf16: the kernel rounds its output to bf16, 2^-9 relative (P
# enters P V as two bf16 parts, to about 2^-17); 1e-2 lies between that
# and the readings of two planted faults (FAULT_KEYS: one 64-key tile of
# the bf16 kernel left out, or the running sum not rescaled at that
# tile), which the attention phase prints and holds above the limit.
# f32: CUDA-core FMA in another order.
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-4} if torch else {}
FAULT_KEYS = (1024, 1088)
# The training path (train phase): olmo-1b as src/repro_torch/configs/
# olmo_1b.py defines it, with the launcher's settings
# (src/repro_torch/launch/train.py): DPP selection over a pool of 3x the
# batch, 2 chain moves an item; AdamW at warmup_cosine(3e-4, 1, 8); the
# monitor every save (per_example 2, sketch_dim 16). TRAIN_CUT layers is
# the depth cut of checks (a) and (f): (a) runs the port's CPU path
# beside the card, (f) writes four checkpoints (2.4 GB each at 2 layers).
TRAIN_ARCH = "olmo-1b"
TRAIN = dict(steps=8, seq=1024, batch=8, lr=3e-4, save_every=4, keep=1)
TRAIN_CUT = 2
# (a) f32 on the card against f32 on the CPU: the same sums in another
# order (cuBLAS and the CPU's BLAS, TF32 off). (b) bf16 against f32:
# bf16 parameters and activations round at 2^-9. (d) the monitor's
# operator is f32: its brackets may miss their f64 truths by f32
# rounding. (f) resumed losses against the uninterrupted run's.
TRAIN_TOL = {"cpu": 1e-5, "bf16": 2e-2, "f32": 1e-5, "resume": 1e-6}
BF16_PEAK = 989e12   # dense bf16 FLOP/s of one H100 SXM (data sheet)
# The LM served on the card (the generate, moe and ssm phases): a model at
# its published widths, cut in depth only, bf16, served by the Engine with
# its default f32 cache: `requests` prompts of prompt_lo..prompt_hi tokens
# from the seed, left-padded to the longest, `new` tokens each, max_seq
# `max_seq`. GEN is olmo-1b's traffic (generate phase; also an int8 cache
# and a run at temperature `temperature`, draws from a seeded generator);
# LM the moe and ssm phases' (the longest prompt exactly prompt_hi: 8 x
# 1024 tokens make two groups of 4096, the capacity of a full group).
# MOE_ARCHS cuts llama4 to one unit (a dense block then a MoE block) and
# arctic to one MoE layer; falcon-mamba runs whole. LM_CUT is check (a)'s
# cut: LM_CUT["layers"] layers (and at most LM_CUT["experts"] experts) in
# f32, prompts of at most LM_CUT["prompt"] tokens, LM_CUT["new"] new
# tokens, on the card and on the CPU.
GEN = dict(requests=8, prompt_lo=512, prompt_hi=1024, new=64, max_seq=1152,
           temperature=0.8)
MOE_ARCHS = (("llama4-maverick-400b-a17b", 2), ("arctic-480b", 1))
SSM_ARCH = ("falcon-mamba-7b", 64)
LM = dict(requests=8, prompt_lo=512, prompt_hi=1024, new=32, max_seq=1056)
LM_CUT = dict(layers=2, experts=8, prompt=128, new=8, hybrid_layers=8,
              frames=256, grid=4)
# The hybrid, enc-dec and VLM families (the hybrid, encdec and vlm phases),
# each whole at its published widths, bf16. zamba2 takes LM's traffic,
# then one long request whose decode crosses its window (attn_window
# 8192): 17 x attn_chunk prompt tokens (the chunked prefill the prompt
# takes at T >= 8192 wants T % 512 == 0), 16 new. whisper: 8 requests of
# 1500 frames (its audio context; the conv frontend is the config's stub)
# and decoder prompts of 4-64 tokens, left-padded, 64 new, max_seq 448
# (its text context). qwen2-vl: 8 requests of a 16 x 16 grid of patch
# embeddings (vision_tokens 256; the vision frontend is the config's stub)
# and 768 text tokens, 64 new, max_seq 1088. Check (a) cuts zamba2 to one
# unit and its tail (LM_CUT["hybrid_layers"]), whisper to 2 + 2 layers
# over LM_CUT["frames"] frames, qwen2-vl to 2 layers and a
# LM_CUT["grid"]-square image.
HYBRID_ARCH = ("zamba2-1.2b", 38)
HYBRID_LONG = dict(prompt=8704, new=16, max_seq=8720)
ENCDEC_ARCH = ("whisper-medium", 24)
ENCDEC = dict(requests=8, prompt_lo=4, prompt_hi=64, new=64, max_seq=448,
              frames=1500)
VLM_ARCH = ("qwen2-vl-2b", 28)
VLM = dict(requests=8, prompt_lo=768, prompt_hi=768, new=64, max_seq=1088,
           grid=16)
# (a) f32 on the card against f32 on the CPU (another summation order,
# TF32 off; also the router's top-(k+1) gaps); (b) a decode step against a
# prefill: "decode" bf16 weights up to 16 layers (the reference's own test
# bound, tests/test_models.py; deeper stacks: decode_tol), "decode_f32" the
# same weights in f32 at full depth, 10x the largest reading on the H100
# (3.1e-6, falcon-mamba's 64 layers; a decode fault reads 0.4 and more,
# PERF.md); (c) int8 against f32 caches: prefill attends the fresh k / v,
# so only the caches differ.
LM_TOL = {"cpu": 1e-5, "decode": 2e-2, "decode_f32": 3e-5, "int8": 1e-4}
# (b)'s requests prefilled alone at a capacity that drops nothing
LM_NODROP = (0, 7)
# Fixed limits of a family whose readings exceed LM_TOL: zamba2 (the
# hybrid). Its Mamba2 stack amplifies a perturbation of rounding's kind
# 11-27x where a dense or a Mamba1 stack of its depth amplifies 2.5x and
# 0.1-0.2x, in the reference as in the port, and at (a)'s cut the two
# packages' f32 logits lie 1.3e-5 apart on the CPU
# (tests/test_torch_rounding.py). On the H100 (PERF.md §6) (a) read
# 3.3e-5, 1.2e-2 with TF32 matmuls (``a_tf32_rel``), and (b) in bf16
# 0.014, 0.024, 0.038 at 8, 20, 38 layers, where its planted faults
# (``b_faults``) read 0.14 and 0.29 (units reading each other's caches, at
# 20 and 38) and 0.93-1.13 (the conv carries lost); so (a) 1e-4 and (b)
# twice decode_tol's. The step one position early reads 0.010-0.023 in
# bf16, within the rounding, and 6.0e-3 in f32.
FAMILY_TOL = {"hybrid": {"cpu": 1e-4, "decode": 4e-2}}
# The long request's (hybrid phase) Engine in f32 against a prefill of the
# same 8719 tokens, a chunked prefill and 15 decode steps: 8.1e-5 on the
# H100, the same bits after a full-route prefill; a windowless prefill
# 2.0e-2 (PERF.md §6)
LONG_ENGINE_TOL = 3e-4
# The parallel phase: data- and model-parallel training of PAR_ARCH at its
# published width cut to PAR_LAYERS layers, PAR's fixed batch, PAR["steps"]
# steps in f32 for the checks (AdamW at eps 1e-3) and two in bf16 for the
# times, under each plan of PAR_PLANS: (world, model-axis size, fsdp,
# microbatches), the data axis the rest. "D=1" runs on NCCL in this
# process; PAR_SPAWNS are gloo ranks sharing the card (NCCL takes a card a
# rank); PAR_FAULT's ranks also run the planted fault; PAR_SAVE writes the
# checkpoint after step 1 that PAR_RESTORE's plans (and D = 1, in this
# process) restore. PAR_TOL: those of tests/test_torch_train.py (loss
# relative, parameters and moments of each leaf's largest entry), the
# restored run's step-2 loss against the uninterrupted one's, and
# compressed_psum against its formula (PAR_COMPRESS elements a rank).
PAR_ARCH, PAR_LAYERS = TRAIN_ARCH, TRAIN_CUT
PAR = dict(seq=1024, batch=8, steps=2, lr=3e-4)
PAR_PLANS = {"D=1": (1, 1, False, 1), "data=2": (2, 1, False, 1),
             "model=2": (2, 2, False, 1),
             "data=2 x model=2 mb2": (4, 2, False, 2),
             "data=2 x model=2 fsdp mb2": (4, 2, True, 2)}
PAR_SPAWNS = ((2, ("model=2", "data=2")), (4, ("data=2 x model=2 mb2",)))
PAR_FAULT, PAR_SAVE = "data=2", "model=2"
PAR_RESTORE = ("data=2", "data=2 x model=2 fsdp mb2")
# What gloo on CUDA tensors refuses (torch 2.11 on the H100: every
# all-gather through DTensor's functional collectives ends the rank with a
# segfault, even of 16 MB; all-reduce, reduce-scatter, broadcast and
# all-to-all pass; PERF.md): the FSDP plan gathers its parameters every
# step, so it runs on NCCL, a rank a card, where the machine has 4 cards.
PAR_GLOO_REFUSED = {"data=2 x model=2 fsdp mb2":
                    "all-gather of FSDP's parameters: gloo segfaults in "
                    "all-gathers of CUDA tensors"}
PAR_NCCL = "data=2 x model=2 fsdp mb2"
# PAR_NCCL's peak a rank in its bf16 steps on four H100s while FSDP
# gathered the whole model at the start of the loss (PERF.md §6): gathering
# a unit at a time must not exceed it
PAR_FSDP_PEAK = 5_384_063_488
PAR_TOL = {"loss": 2e-5, "params": 1e-5, "m": 1e-4, "restore": 1e-6,
           "compress": 1e-6}
PAR_COMPRESS = 1 << 20
PAR_TIMEOUT_S = 600.0
# The parallel phase's fsdp_wide part: training at published widths, cut
# in depth only, over WIDE["world"] NCCL ranks, a card each (data = 2 x
# model = 2, FSDP on data; it runs where the machine has that many
# cards), bf16, warmup-cosine AdamW (lr WIDE["lr"], eps at its default),
# one fixed batch of WIDE["batch"] x WIDE["seq"] tokens from the seed,
# WIDE["steps"] steps. W1, dense: llama3-405b at 4 of 126 layers (16.95e9
# parameters); W2, MoE: arctic-480b at 1 of 35 (one MoE layer of 128
# experts, top-2, with its dense residual; 14.07e9), its experts on the
# model axis through tp_plan's "expert" rule. A plan whose traced peak a
# rank (the fake world-4 trace) is over WIDE_LEAVE_OUT is left out, its
# figure printed. WIDE_TOL: (b) step 1's loss against a no_grad forward
# of the same parameters on one card, relative: bf16 on both, the sums
# in another order, and a near-tie in arctic's router may flip; the
# planted fault (every rank's gather of the unembedding table keeping
# only its own shard) must read above it. WIDE_MEM: (d) each rank's
# allocator peak may exceed its plan's traced peak by this share at most:
# the trace is the figure a run is planned by, so it must not
# under-reckon (the allocator read 0.12% above W1's trace and 7.2% below
# W2's on four H100s; PERF.md).
WIDE_PLANS = {"W1": ("llama3-405b", 4), "W2": ("arctic-480b", 1)}
WIDE = dict(world=4, model=2, batch=8, seq=1024, steps=2, lr=3e-4)
WIDE_TOL = 1e-4
WIDE_MEM = 0.05
WIDE_LEAVE_OUT = 76e9
WIDE_TIMEOUT_S = 900.0
# The train_families phase: each model at its published widths (falcon-
# mamba cut to 16 of 64 layers: all 64 with AdamW's f32 moments need 84 GB;
# zamba2 to 3 of its 6 units and the tail, 20 of 38 layers, for the
# script's time: the whole stack took 13-16 s a step), bf16, FAM["steps"]
# steps of warmup-cosine AdamW (lr FAM["lr"]) on one fixed batch of
# FAM["batch"] sequences (2 steps, cut from 4 for the script's time;
# PERF.md): FAM["seq"] tokens (falcon-mamba,
# zamba2), FAM["frames"] stub frames and FAM["text"] tokens (whisper's
# audio and text contexts), or a FAM["grid"]-square image and
# FAM["vlm_text"] tokens (qwen2-vl). Check (a) runs one f32 step at
# LM_CUT's depth on FAM_A's batch on the card and on the CPU (the CPU's
# on a thread of its own, beside the card's work).
TRAIN_FAMILIES = (("falcon-mamba-7b", 16), ("zamba2-1.2b", 20),
                  ("whisper-medium", 24), ("qwen2-vl-2b", 28))
FAM = dict(batch=8, seq=1024, steps=2, lr=3e-4, frames=1500, text=448,
           grid=16, vlm_text=768)
FAM_A = dict(batch=2, seq=64, frames=256, grid=4)
# The dryrun phase: DRY_CELLS (arch, shape, mesh), each a `python -m
# repro_torch.launch.dryrun` process of its own, side by side; every one
# must come back ok, within the card's CARD_HBM a rank where it trains
# with FSDP (DRY_FSDP_FITS). PAR_CENSUS is the parallel phase's plan whose gloo
# ranks record their collectives in step 2 for (c); (b) times DRY_STEPS
# steps of the D = 1 plan after the counted one. CARD_HBM: the card's
# 80 GB, beside each cell's bytes a rank.
DRY_CELLS = (("olmo-1b", "train_4k", "single"),
             ("llama4-maverick-400b-a17b", "train_4k", "single"),
             ("falcon-mamba-7b", "long_500k", "single"),
             ("olmo-1b", "train_4k", "multi"))
DRY_FSDP_FITS = ("llama4-maverick-400b-a17b", "train_4k", "single")
DRY_EXAMPLES = ("quickstart_torch.py", "sensor_placement_torch.py")
DRY_STEPS = 3
DRY_TIMEOUT_S = 300.0
PAR_CENSUS = "data=2 x model=2 mb2"
CARD_HBM = 80e9


def lm_tol(cfg, key: str) -> float:
    """``LM_TOL[key]`` for ``cfg``, or its family's FAMILY_TOL entry."""
    return FAMILY_TOL.get(cfg.family, {}).get(key, LM_TOL[key])


def decode_tol(cfg, layers: int) -> float:
    """(b)'s limit for bf16 weights in a stack of ``layers``: ``lm_tol``'s
    up to 16 layers, then growing as sqrt(layers / 16), as the roundings
    of independent layers add. On the H100 (b) read 1.05e-2, 1.72e-2 and
    1.95e-2 at 16, 32 and 64 of falcon-mamba's layers, 3.1e-6 with the
    same weights in f32 (PERF.md, the depth sweep of (b))."""
    return lm_tol(cfg, "decode") * max(1.0, layers / 16) ** 0.5


def stack_depth(cfg) -> int:
    """The layers a token's logits pass through: the decoder's, and an
    enc-dec model's encoder's."""
    return cfg.n_layers + cfg.enc_layers


def depth_cut(cfg, params, frac: int):
    """``(cfg, params)`` of the first 1/``frac`` of the stack, the
    parameters as views: of its blocks (dense, SSM, VLM), of the encoder's
    and the decoder's blocks alike (enc-dec), of its units with the whole
    tail (hybrid: 6k + 2 of zamba2's 38 layers)."""
    from repro_torch import tree
    from repro_torch.models import model as M

    def head(stack, n):
        return tree.map(lambda x: x[:n], stack)

    if cfg.family == "hybrid":
        n_units, k_unit, tail = M._hybrid_shape(cfg)
        k = max(1, n_units // frac)
        return (dataclasses.replace(cfg, n_layers=k * k_unit + tail),
                dict(params, units=head(params["units"], k)))
    d = max(1, cfg.n_layers // frac)
    out = dict(params, blocks=head(params["blocks"], d))
    changes = {"n_layers": d}
    if cfg.is_encdec:
        e = max(1, cfg.enc_layers // frac)
        out["enc_blocks"] = head(params["enc_blocks"], e)
        changes["enc_layers"] = e
    return dataclasses.replace(cfg, **changes), out


def planted_decode(fault: str, cfg, caches, toks, t: int) -> tuple:
    """``(cfg, caches, last token, position)`` of (b)'s decode step at
    T - 1 (``toks`` (B, T)) with ``fault`` planted in it, ``caches`` a
    copy it may write: "early", the step one position early (its k / v
    written a slot early, its positions one early); "narrow", its window
    one position short; "token", fed the token before the last; "units",
    every unit of a hybrid reading the next unit's KV cache; "conv", every
    SSM block's conv carry lost."""
    from repro_torch import tree
    from repro_torch.models.ssm import SSMCache
    last, pos = toks[:, -1:], t - 1
    if fault == "early":
        pos = t - 2
    elif fault == "narrow":
        cfg = dataclasses.replace(cfg, attn_window=cfg.attn_window - 1)
    elif fault == "token":
        last = toks[:, -2:-1]
    elif fault == "units":
        caches["units"]["attn"] = tree.map(lambda x: torch.roll(x, 1, 0),
                                           caches["units"]["attn"])
    elif fault == "conv":
        def lose(node):
            if isinstance(node, SSMCache):
                node.conv.zero_()
            elif isinstance(node, dict):
                for v in node.values():
                    lose(v)
        lose(caches)
    else:
        raise ValueError(fault)
    return cfg, caches, last, pos


def b_faults(cfg) -> tuple:
    """The planted faults (``planted_decode``) that (b) reads for ``cfg``:
    none for a MoE model, whose two prefills drop tokens apart; "early"
    where the decode step has positions (not the SSM family); "token";
    "units" for a hybrid of more than one unit; "conv" where there are
    SSM blocks."""
    if cfg.family == "moe":
        return ()
    out = ("early",) if cfg.family != "ssm" else ()
    out += ("token",)
    if cfg.family == "hybrid" and cfg.n_layers // cfg.hybrid_attn_every > 1:
        out += ("units",)
    if cfg.family in ("ssm", "hybrid"):
        out += ("conv",)
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
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


def device_kernels(fn) -> dict:
    """For one call of ``fn``: each CUDA kernel it launched, by name, with
    its device milliseconds and its number of launches (torch.profiler,
    device activity only). The raw device events are summed directly:
    a call of the batched eigensolver launches some 10^5 kernels, and
    building the profiler's event tree over them took longer than the
    call itself."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name().replace("void ", "").replace(
            "(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
        ms, count = out.get(name, (0.0, 0))
        out[name] = (ms + e.duration_ns() / 1e6, count + 1)
    return out


def graph_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn``'s launches replayed as one CUDA graph:
    the wrapper's host work (checks, allocation, ctypes) runs once, at
    capture, so the reading is the kernels' time back to back even where
    that host work outlasts them."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, reps, warmup)


def per_launch_ms(fn, reps: int = 5) -> dict:
    """Device milliseconds per launch of each kernel that ``fn`` launches,
    over ``reps`` calls after one warm-up (torch.profiler)."""
    fn()
    kernels = device_kernels(lambda: [fn() for _ in range(reps)])
    return {k: ms / count for k, (ms, count) in kernels.items()}


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def errors(got, want) -> tuple:
    """(max abs error, max normwise relative error) over paired outputs."""
    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs().max().item()
        scale = max(w.double().abs().max().item(), 1e-300)
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / scale)
    return abs_err, rel_err


def row_errors(got, want) -> tuple:
    """(max abs error, max relative error of a row) over paired outputs:
    ||g - w||_2 / ||w||_2 along the last axis, the largest over the other
    axes (K7's measure: each (head, query row) at its own scale)."""
    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        w = w.double()
        d = g.double() - w
        abs_err = max(abs_err, d.abs().max().item())
        rel = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-300)
        rel_err = max(rel_err, rel.max().item())
    return abs_err, rel_err


def flatten_out(out):
    alpha, beta, r, raw = out
    return [alpha, beta, r, *raw]


def contains(lo, hi, truth, slack: float) -> bool:
    tol = slack * truth.abs() + 1e-300
    return bool(torch.all(lo <= truth + tol) & torch.all(hi >= truth - tol))


def bsr_of(data, cols, dtype):
    """A torch BSR tensor holding a blocked-ELL table (library yardstick
    only; the port never calls it)."""
    nr, kb, bs, _ = data.shape
    crow = torch.arange(0, nr * kb + 1, kb, device=data.device,
                        dtype=torch.int64)
    return torch.sparse_bsr_tensor(
        crow, cols.reshape(-1).long(), data.reshape(nr * kb, bs, bs).to(dtype),
        size=(nr * bs, nr * bs))


def mha_plain(q, k, v, causal: bool):
    """K7's plain version over (B, T, H, D) q and (B, S, Hkv, D) k/v: the
    reference wrapper's repeat-and-flatten, PLAIN_HEADS query heads at a
    time so that their (heads, T, S) f32 scores fit on the card."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    b, t, h, d = q.shape
    s, rep = k.shape[1], h // k.shape[2]
    out = torch.empty_like(q)
    for h0 in range(0, h, PLAIN_HEADS):
        hs = torch.arange(h0, min(h0 + PLAIN_HEADS, h), device=q.device)
        qf, kf, vf = (x[:, :, idx].transpose(1, 2).reshape(-1, n, d)
                      for x, idx, n in ((q, hs, t), (k, hs // rep, s),
                                        (v, hs // rep, s)))
        out[:, :, h0:h0 + len(hs)] = flash_attention_plain(
            qf, kf, vf, causal=causal).reshape(b, -1, t, d).transpose(1, 2)
    return out


def planted_faults(q, k, v, want) -> dict:
    """K7's row measure (row_errors against ``want``, the plain prefill)
    on wrong outputs of the first PLAIN_HEADS query heads, made without
    the kernel: the plain causal softmax over three key segments split at
    FAULT_KEYS, recombined as the online softmax does (``sound``), with
    the middle tile left out (``tile_skipped``), and with the running sum
    of the first segment not rescaled when the tile raises the row's max
    (``no_rescale``)."""
    b, t, h, d = q.shape
    s_len, rep = k.shape[1], h // k.shape[2]
    hs = torch.arange(PLAIN_HEADS, device=q.device)
    qf, kf, vf = (x[0][:, idx].transpose(0, 1).to(torch.float32)
                  for x, idx in ((q, hs), (k, hs // rep), (v, hs // rep)))
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(s_len, device=q.device)[None, :]
    lo, hi = FAULT_KEYS

    def segment(a, z):    # (m, l, acc) of keys [a, z), causal
        keep = cols[:, a:z] <= rows
        sc = torch.einsum("btd,bsd->bts", qf, kf[:, a:z]) / d ** 0.5
        sc = torch.where(keep, sc, torch.full((), -1e30, device=q.device))
        m = sc.max(-1, keepdim=True).values
        p = torch.exp(sc - m) * keep
        return m, p.sum(-1, keepdim=True), p @ vf[:, a:z]

    def merge(x, y, rescale=True):
        m = torch.maximum(x[0], y[0])
        ax, ay = torch.exp(x[0] - m), torch.exp(y[0] - m)
        return m, x[1] * ax + y[1] * ay, \
            (x[2] * ax if rescale else x[2]) + y[2] * ay

    def out(x):
        o = (x[2] / x[1].clamp_min(1e-30)).to(q.dtype)
        return o.transpose(0, 1)[None]     # (1, T, heads, D)

    pa, pb, pc = segment(0, lo), segment(lo, hi), segment(hi, s_len)
    ref = want[:, :, :PLAIN_HEADS]
    wrong = {"sound": merge(merge(pa, pb), pc),
             "tile_skipped": merge(pa, pc),
             "no_rescale": merge(merge(pa, pb, rescale=False), pc)}
    return {what: row_errors([out(x)], [ref])[1]
            for what, x in wrong.items()}


def left_pad(prompts) -> np.ndarray:
    """The prompts left-padded with token 0 to the longest, as
    ``Engine.generate`` pads them."""
    t = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), t), np.int32)
    for i, p in enumerate(prompts):
        out[i, t - len(p):] = p
    return out


def kv_caches(caches) -> list:
    """The KV caches (the tuples with a ``length``) in a cache tree: one
    stack, a dict of stacks, the hybrid's nested dict."""
    if isinstance(caches, dict):
        return [c for v in caches.values() for c in kv_caches(v)]
    return [caches] if hasattr(caches, "length") else []


def iterations_of(out) -> int:
    """The longest lane's iterations of a solver call; the total of an
    application's judges; 1 for a call that has no iterations (an
    attention forward)."""
    if isinstance(out, torch.Tensor):
        return 1
    if isinstance(out, list):            # a flush: its longest request's
        return max(r.iterations for r in out)
    if hasattr(out, "stats"):            # a chain: its judges' iterations
        return int(out.stats.quad_iterations)
    if hasattr(out, "order"):            # greedy MAP: its races' iterations
        return int(out.quad_iterations)
    its = out.state.iterations if hasattr(out, "std_error") \
        else out.iterations
    return int(its.max())


def bell_routes() -> dict:
    """K2's and K4's launches by route since the counts were zeroed."""
    from repro_torch.kernels import lanczos_step as ls
    from repro_torch.kernels import spmv_bell as sb
    return {"bell_matvec": dict(sb.ROUTES),
            "fused_step_bell": {k: v for k, v in ls.ROUTES.items()
                                if k.startswith("bell_")}}


def assert_tiled(launches, routes) -> None:
    """Every K2 and K4 launch of a path phase (all on the shared table)
    took the tiled route: K4's the FP64 tensor-core tile (f64 vectors)."""
    assert routes["bell_matvec"]["tiled"] == launches["bell_matvec"], \
        f"K2 off the tiled route: {routes}"
    assert routes["fused_step_bell"]["bell_dmma"] == \
        launches["fused_step_bell"], f"K4 off the tiled route: {routes}"


def sdpa_gqa(q, k, v):
    """PyTorch's fused attention on (B, H, T, D) views with grouped kv
    heads: the library yardstick of K7 (the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def causal_pairs(t_len: int, s_len: int) -> int:
    """(query, key) pairs a causal mask keeps, zero-aligned: key j <= i."""
    return sum(min(i + 1, s_len) for i in range(t_len))


def serve_flow(op, reqs, partial, solver, iv, *, mode="continuous",
               mesh=None, metrics=True, log=None):
    """The serve traffic through one BIFEngine: submit every request,
    flush, resubmit the budget partials ``partial`` with the full budget
    and flush again (with ``partial`` empty, one flush). Returns the
    engine, the submitted requests and the first flush's list."""
    from repro_torch.serve import BIFEngine, BIFRequest
    eng = BIFEngine(op, solver=solver, max_batch=SERVE_POOL,
                    chunk_iters=SERVE_CHUNK, lam_min=iv[0], lam_max=iv[1],
                    metrics=metrics, convergence_log=log, mesh=mesh)
    reqs = [eng.submit(BIFRequest(**r)) for r in reqs]
    out = eng.flush(mode=mode)
    for i in partial:
        reqs[i].max_iters = None
        eng.submit(reqs[i])
    if partial:
        eng.flush()
    return eng, reqs, out


def sharded_problems(job, dev) -> dict:
    """The sharded phase's inputs on ``dev``, from the numpy job the
    parent hands its ranks."""
    from repro_torch.core import SparseBELL

    def t(x):
        return torch.as_tensor(x, device=dev)

    bell = SparseBELL(t(job["bell_data"]), t(job["bell_cols"]),
                      t(job["bell_diag"]), job["bell_n"])
    return dict(
        a=t(job["a"]), u=t(job["u"]), t=t(job["t"]), masks=t(job["masks"]),
        um=t(job["um"]), shift=t(job["shift"]), bell=bell,
        trace_op=dataclasses.replace(bell, diag_vals=bell.diag_vals.to(
            torch.float64)),
        u_sparse=t(job["u_sparse"]), greedy_a=t(job["greedy_a"]),
        **{k: job[k] for k in ("iv", "iv_sparse", "greedy_iv", "reqs",
                               "partial")})


def sharded_call(name, p, mesh):
    """A zero-argument call of the sharded phase: ``name`` is
    '<cell> <what> <backend>'; ``mesh`` None gives its single-device
    twin."""
    from repro_torch.core import BIFSolver, Dense, greedy_map, logdet_quad, \
        stack_masks
    cell, what, backend = name.split()
    on = {} if mesh is None else {"mesh": mesh}
    sfx = "" if mesh is None else "_sharded"
    if cell == "trace":
        return lambda: logdet_quad(
            p["trace_op"], PROBES, block_size=BLOCK, key=SEED,
            solver=BIFSolver.create(backend=backend, **TRACE_BLOCK),
            lam_min=p["iv_sparse"][0], lam_max=p["iv_sparse"][1], **on)
    if cell == "serve":
        return lambda: serve_flow(
            Dense(p["a"]), p["reqs"], p["partial"], BIFSolver.create(
                **SERVE_DENSE, backend=backend), p["iv"], **on)[1]
    if cell == "greedy":
        return lambda: greedy_map(
            Dense(p["greedy_a"]), GREEDY_K, *p["greedy_iv"],
            max_iters=APPS["max_iters"],
            solver=BIFSolver.create(**APPS, backend=backend), **on)
    sparse = cell == "sparse"
    s = BIFSolver.create(**(SPARSE if sparse else DENSE), backend=backend)
    op = p["bell"] if sparse else Dense(p["a"])
    u = p["u_sparse"] if sparse else p["u"]
    u = u[:SHARDED_PADDED_K] if cell == "dense62" else u
    lo, hi = p["iv_sparse"] if sparse else p["iv"]
    iv = dict(lam_min=lo, lam_max=hi, **on)
    if what == "solve":
        return lambda: getattr(s, "solve_batch" + sfx)(op, u, **iv)
    if what == "judge":
        return lambda: getattr(s, "judge_batch" + sfx)(op, u, p["t"], **iv)
    return lambda: getattr(s, "judge_argmax" + sfx)(
        stack_masks(op, p["masks"]), p["um"], shift=p["shift"], scale=-1.0,
        **iv)


def sharded_view(out) -> dict:
    """A call's outcome as host numpy: the per-lane (or per-request)
    discrete outcomes and brackets."""
    def h(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    if isinstance(out, list):         # a flush: its requests
        return {"decision": np.array([-1 if r.decision is None else
                                      int(r.decision) for r in out]),
                "certified": np.array([bool(r.certified) for r in out]),
                "resolved": np.array([bool(r.resolved) for r in out]),
                "iterations": np.array([r.iterations for r in out]),
                "lower": np.array([np.nan if r.lower is None else r.lower
                                   for r in out]),
                "upper": np.array([np.nan if r.upper is None else r.upper
                                   for r in out])}
    if hasattr(out, "std_error"):     # a trace: its lanes' brackets
        st = out.state
        return {"lower": st.probe_lower, "upper": st.probe_upper,
                "iterations": st.iterations}
    if hasattr(out, "order"):         # greedy MAP
        return {"order": h(out.order), "certified": h(out.certified),
                "gains": h(out.gains)}
    keep = ("decision", "index", "certified", "iterations", "lower",
            "upper")
    return {f: h(getattr(out, f)) for f in keep if f in out._fields}


def sharded_compare(name, got, want, slack, truth=None,
                    truth_slack=None) -> dict:
    """Hold a sharded call's view against its single-device twin: the
    discrete outcomes equal, iterations within 1 per lane, and where a
    lane took the same iterations its bracket within ``slack``
    relative; with ``truth``, every bracket (NaN: a request retired
    unresolved) around it within ``truth_slack`` relative."""
    out, same = {"slack": slack}, None
    if "iterations" in want:
        diff = np.abs(got["iterations"].astype(np.int64)
                      - want["iterations"].astype(np.int64))
        same = diff == 0
        out.update(max_iter_diff=int(diff.max()),
                   lanes_iter_diff=int((~same).sum()))
        assert int(diff.max()) <= 1, f"{name}: iterations differ by >1"
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if k == "iterations":
            continue
        if k in ("lower", "upper", "gains"):
            m = np.isfinite(w)
            if same is not None and same.shape == w.shape:
                m &= same
            rel = np.abs(g[m] - w[m]) / np.maximum(np.abs(w[m]), 1e-300)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
        else:
            assert np.array_equal(g, w), f"{name}: {k} differs"
    out["max_rel_bracket_diff"] = worst
    assert worst <= slack, f"{name}: brackets differ by {worst} > {slack}"
    if truth is not None:
        lo, hi = got["lower"], got["upper"]
        m = np.isfinite(lo)
        miss = np.maximum(lo[m] - truth[m], truth[m] - hi[m]) \
            / np.abs(truth[m])
        out.update(max_rel_miss=float(miss.max()), truth_slack=truth_slack)
        assert float(miss.max()) <= truth_slack, \
            f"{name}: a bracket misses its truth by {float(miss.max())}"
    return out


def sharded_measure(name, p, mesh, *, profile: bool) -> dict:
    """One sharded call, measured: host seconds of a warm call, its
    rounds and gathers (``core.sharded.COUNTS``), its launches and routes
    by kernel, its view; with ``profile``, the device seconds of a second
    call (torch.profiler; NCCL's kernels apart) and the idle share 1 -
    device / host."""
    from repro_torch.core import sharded
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import lanczos_step as ls
    from repro_torch.kernels import spmv_bell as sb
    fn = sharded_call(name, p, mesh)
    cuda = p["a"].device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if profile:
        fn()                          # warm
    reset_launches()
    sharded.reset_counts()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    host_s = time.perf_counter() - t0
    c = dict(sharded.COUNTS)
    rec = {"seconds": host_s, "counts": c, "cuda": cuda,
           "bytes_per_gather": c["bytes"] / max(c["gathers"], 1),
           "launches": {k: v for k, v in LAUNCHES.items() if v},
           "routes": {k: v for k, v in {**ls.ROUTES, **sb.ROUTES,
                                        **sb.MRHS_ROUTES}.items() if v},
           "view": sharded_view(out)}
    if profile and cuda:
        # NCCL's gather kernels spin on the device until the slowest rank
        # arrives: counted apart, not as device work
        ms = {k: v for k, (v, _) in device_kernels(fn).items()}
        dev_s = sum(v for k, v in ms.items() if not k.startswith("nccl"))
        rec.update(device_s=dev_s / 1e3, idle_share=1.0 - dev_s / 1e3 / host_s,
                   nccl_s=sum(v for k, v in ms.items()
                              if k.startswith("nccl")) / 1e3)
    return rec


def sharded_check_rank(name, rec) -> None:
    """The collective rule and the kernel routes of one rank's call:
    gathers = boundaries + finalizes + clocks, boundaries = rounds +
    drives (a solve: rounds + 2), and every expected kernel launched,
    on its route."""
    c = rec["counts"]
    assert c["gathers"] == c["boundaries"] + c["finalizes"] + c["clocks"] \
        and c["boundaries"] == c["rounds"] + c["drives"], f"{name}: {c}"
    cell, _, backend = name.split()
    if cell in ("dense", "dense62", "sparse", "trace"):
        assert c["drives"] == c["finalizes"] == 1 \
            and c["gathers"] == c["rounds"] + 2, f"{name}: {c}"
    if not rec["cuda"]:
        return                        # a rehearsal on the CPU: no kernels
    key = "trace" if cell == "trace" else \
        f"sparse {backend}" if cell == "sparse" else backend
    for kernel, route in SHARDED_KERNELS[key].items():
        n = rec["launches"].get(kernel, 0)
        # greedy MAP's races end mostly at their first brackets: a rank
        # whose candidates all do launches nothing (the phase holds the
        # ranks' sum above 0)
        assert n > 0 or cell == "greedy", \
            f"{name}: no {kernel} launch on this rank"
        if route is not None:
            assert rec["routes"].get(route, 0) == n, \
                f"{name}: {kernel} off its {route} route {rec['routes']}"


def sharded_rank(rank: int, world: int, backend: str, calls,
                 job_dir: str) -> None:
    """One rank of the sharded phase, spawned by it: ``calls`` on this
    rank's card (gloo: card 0, shared; NCCL: a card a rank), each
    measured and checked (``sharded_measure``, ``sharded_check_rank``),
    pickled to ``job_dir``."""
    import os
    import pickle
    import traceback
    try:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        torch.set_num_threads(SHARDED_THREADS)
        torch.backends.cuda.matmul.allow_tf32 = False
        import torch.distributed as dist
        from repro_torch.launch import init_lane_group, make_lane_mesh
        job_dir = Path(job_dir)
        with open(job_dir / "job.pkl", "rb") as f:
            job = pickle.load(f)
        init_lane_group(backend, rank, world, store=dist.FileStore(
            str(job_dir / f"store_{backend}{world}"), world), timeout_s=60.0)
        try:
            mesh = make_lane_mesh(device_type=job["device_type"])
            dev = torch.device("cuda", torch.cuda.current_device()) \
                if job["device_type"] == "cuda" else torch.device("cpu")
            p = sharded_problems(job, dev)
            recs = {}
            for name in calls:
                recs[name] = sharded_measure(
                    name, p, mesh, profile=name in SHARDED_PROFILED)
                sharded_check_rank(name, recs[name])
        finally:
            dist.destroy_process_group()
        with open(job_dir / f"{backend}{world}_rank{rank}.pkl", "wb") as f:
            pickle.dump(recs, f)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


# -- the parallel phase: data- and model-parallel training -----------------


def par_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def par_peak(dev, reset: bool = False) -> int:
    """The card's peak allocation since the last reset (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def par_batch(cfg, dev) -> dict:
    """PAR's fixed batch of tokens and labels, from the seed."""
    toks = np.random.default_rng(SEED + 29).integers(
        1, cfg.vocab - 1, (PAR["batch"], PAR["seq"] + 1)).astype(np.int32)
    t = torch.as_tensor(toks, device=dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def par_opt(checks: bool = True):
    """AdamW at the launcher's warmup-cosine lr; eps 1e-3 for the checks
    (tests/test_torch_train.py: at 1e-8 an entry whose gradient is near
    zero moves by about +-lr whatever its last bits)."""
    from repro_torch.optim import AdamW, warmup_cosine
    sched = warmup_cosine(PAR["lr"], 1, PAR["steps"])
    return AdamW(lr=sched, eps=1e-3) if checks else AdamW(lr=sched)


def par_reference(cfg, dev) -> dict:
    """The one-device f32 run of PAR["steps"] steps: its losses, and its
    parameters and moments after the last step."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    opt = par_opt()
    params, _ = M.init_model(SEED, cfg, device=dev)
    state = opt.init(params)
    step = steps.build_train_step(cfg, optimizer=opt)
    batch = par_batch(cfg, dev)
    losses = []
    for _ in range(PAR["steps"]):
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": params, "m": state.m}


def par_logical(x):
    return x.full_tensor() if hasattr(x, "device_mesh") else x


def par_local(ref, like):
    """This rank's piece of the one-device tensor ``ref`` where ``like``
    is a DTensor (a slice: nothing moves), else ``ref``."""
    if not hasattr(like, "device_mesh"):
        return ref
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(ref, like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def par_errors(params, state, ref) -> dict:
    """This rank's largest error over the leaves, each relative to the
    one-device leaf's largest entry, of the parameters and the first
    moments: its shards against the same slices of the one-device arrays
    (no gather)."""
    from repro_torch import tree

    def worst(got, want):
        out = 0.0
        for g, w in zip(tree.leaves(got), tree.leaves(want)):
            loc = g.to_local() if hasattr(g, "device_mesh") else g
            out = max(out, float((loc - par_local(w, g)).abs().max()
                                 / w.abs().max().clamp(min=1e-30)))
        return out

    return {"params_err": worst(params, ref["params"]),
            "m_err": worst(state.m, ref["m"])}


def par_digest(params, state) -> list:
    """For each leaf, the coordinates of this rank's shard (None where the
    leaf is replicated) and a digest of its bits (two int64 sums, taken
    over pieces of 2^26 words: integer sums, the same whatever the
    pieces): ranks holding the same shard must hold the same bits."""
    from repro_torch import tree
    out = []
    for x in tree.leaves((params, state.m, state.v)):
        loc = x.to_local() if hasattr(x, "device_mesh") else x
        key = tuple(c if p.is_shard() else None for c, p in zip(
            x.device_mesh.get_coordinate(), x.placements)) \
            if hasattr(x, "device_mesh") else ()
        words = loc.contiguous().view(torch.int32).reshape(-1)
        s1 = s2 = 0
        for i in range(0, words.numel(), 1 << 26):
            b = words[i:i + (1 << 26)].to(torch.int64)
            w = (torch.arange(b.numel(), device=b.device) + i) % 1009 + 1
            s1 += int(b.sum())
            s2 += int((b * w).sum())
        out.append((key, s1, s2))
    return out


def par_same_arrays(digests) -> bool:
    """Whether every rank holding a leaf's shard holds the same bits."""
    for leaf in zip(*digests):
        seen = {}
        for key, a, b in leaf:
            if seen.setdefault(key, (a, b)) != (a, b):
                return False
    return True


def par_fsdp_gathers(cfg, sizes: dict, plan, microbatches: int = 1) -> dict:
    """FSDP's all-gathers of one step on a rank, reckoned from the
    placements (``sizes``: {mesh axis: size}) as the model issues them
    (``sharding.api.fsdp_gather``): a stack leaf's slices twice a unit
    with ``remat="block"`` (its block's forward and its recompute), once
    without; a leaf split on its stack dim once, gathered whole before
    the loop; every other leaf (the top-level ones, a tied table once for
    its two uses, zamba2's shared block) once at its use; all of it once
    a microbatch. ``count`` and ``census_bytes`` (the gathered buffers, as
    ``utils.comms`` counts an all-gather) are what a rank's
    ``StepCensus`` records of them; ``wire`` is the ring's (D - 1) / D of
    the buffers, and ``reduce_scatter`` the wire bytes of their
    gradients', one reduce-scatter a unit slice a microbatch."""
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi
    skeleton, axes = M._build(cfg, M._meta)
    specs = shapi.param_specs(plan, sizes, skeleton, axes)
    d = sizes.get(plan.fsdp_axis, 1)
    stacks = ("blocks", "units", "tail", "enc_blocks")
    per_unit = 2 if cfg.remat == "block" else 1
    out = {"count": 0, "census_bytes": 0, "wire": 0.0,
           "reduce_scatter": 0.0}

    def walk(p, sp, top):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], sp[k], top or k)
            return
        names = [n for e in sp for n in shapi._names(e)]
        if d <= 1 or plan.fsdp_axis not in names:
            return
        split = 1
        for n in names:
            split *= sizes[n]
        loc = p.numel() * p.element_size() // split
        if top in stacks and sp[0] != plan.fsdp_axis:
            count, passes = per_unit * p.shape[0], per_unit
        else:
            count, passes = 1, 1
        out["count"] += count * microbatches
        out["census_bytes"] += passes * microbatches * loc * d
        out["wire"] += passes * microbatches * loc * (d - 1)
        out["reduce_scatter"] += microbatches * loc * (d - 1)

    walk(skeleton, specs, None)
    return out


def par_bytes(dparams, mesh, cfg, tokens_local: int, plan,
              microbatches: int = 1) -> dict:
    """The bytes a step moves on this rank, reckoned from the placements:
    FSDP's all-gathers (``par_fsdp_gathers``: forward and recompute) and
    the reduce-scatters of their gradients, a data-replicated leaf's
    gradient all-reduce (ring: 2 (D - 1) / D of it), and, with a model
    axis, the tensor-parallel all-reduces of the (B_local, T, d)
    activations (two a block forward, two backward, two in the
    recomputed forward)."""
    from repro_torch import tree
    from repro_torch.sharding import api as shapi
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    size = dict(zip(names, mesh.shape))
    d, m = size.get("data", 1), size.get("model", 1)
    out = {"fsdp_gather": 0.0, "grad_reduce": 0.0, "tp_activations": 0.0}
    for x in tree.leaves(dparams):
        pl = dict(zip(names, x.placements))
        loc = x.to_local().numel() * x.element_size()
        if d > 1 and not isinstance(pl.get("data"), Shard):
            out["grad_reduce"] += 2 * (d - 1) / d * loc
    if plan.fsdp:
        g = par_fsdp_gathers(cfg, shapi.mesh_sizes(mesh), plan,
                             microbatches)
        out["fsdp_gather"] = g["wire"]
        out["grad_reduce"] += g["reduce_scatter"]
        out["fsdp_gathers"] = g["count"]
        out["fsdp_gather_census_bytes"] = g["census_bytes"]
    if m > 1:
        act = tokens_local * cfg.d_model * torch.finfo(
            getattr(torch, cfg.dtype)).bits // 8
        out["tp_activations"] = cfg.n_layers * 6 * 2 * (m - 1) / m * act
    out["total"] = sum(out[k] for k in ("fsdp_gather", "grad_reduce",
                                        "tp_activations"))
    return out


def par_fault_vg(cfg, mesh, plan, params, batch):
    """The planted fault: ``launch.steps._dist_value_and_grad`` with the
    data reduce skipped: each rank keeps the gradient of its own rows as
    if it were the whole batch's."""
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi
    from repro_torch import tree
    from torch.distributed.tensor import DTensor

    with shapi.activation_context(mesh, plan):
        (v, met), g = M.value_and_grad(cfg, params, batch)
        g = tree.map(lambda gg, pp: DTensor.from_local(
            gg.to_local(), mesh, pp.placements, run_check=False), g, params)
    return (par_logical(v), {k: par_logical(x) for k, x in met.items()}), g


def par_run(cfg, mesh, plan, mb, ref, dev, *, save=None, fault=False,
            census=False):
    """PAR["steps"] f32 steps of one plan from the seed's parameters:
    losses (and their bits), errors against the one-device run, the
    logical arrays' digest; ``save`` writes a checkpoint after step 1;
    ``census`` records step 2's collectives (utils.comms) beside the
    bytes reckoned from the placements."""
    from repro_torch import tree
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi
    opt = par_opt()
    dp, _ = M.init_model(SEED, cfg, device=dev,
                         place=shapi.leaf_placer(plan, mesh))
    state = opt.init(dp)
    real = steps._dist_value_and_grad
    if fault:
        steps._dist_value_and_grad = par_fault_vg
    try:
        step = steps.build_train_step(cfg, mesh, plan, opt,
                                      microbatches=mb)
        batch = par_batch(cfg, dev)
        losses, counted = [], None
        for s in range(PAR["steps"]):
            if census and s == 1:
                from repro_torch.utils import comms
                counted = comms.StepCensus()
                with counted:
                    dp, state, met = step(dp, state, batch)
            else:
                dp, state, met = step(dp, state, batch)
            losses.append(float(met["loss"]))
            if s == 0 and save is not None:
                ckpt_io.save(save, 1, (dp, state))
    finally:
        steps._dist_value_and_grad = real
    rec = {"losses": losses, "loss_hex": [x.hex() for x in losses],
           "loss_err": max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref["losses"])),
           **par_errors(dp, state, ref)}
    if counted is not None:
        d = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("data", 1)
        rec["collectives"] = {
            "bytes": comms.collective_bytes(counted.records),
            "counts": comms.collective_counts(counted.records),
            "reckoned": par_bytes(dp, mesh, cfg,
                                  PAR["batch"] * PAR["seq"] // d, plan,
                                  mb)}
    if not fault:
        rec["digest"] = par_digest(dp, state)
        rec["sharded_leaves"] = sum(
            1 for x in tree.leaves(dp) if any(
                not p.is_replicate() for p in x.placements))
    return rec


def par_times(cfg, mesh, plan, mb, dev) -> dict:
    """Two bf16 steps (AdamW at the default eps): the second timed under
    torch.profiler; seconds, seconds in collectives (the host's c10d / gloo
    / NCCL calls and the device's NCCL kernels), peak memory, and the
    bytes reckoned from the placements."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi
    opt = par_opt(checks=False)
    dp, _ = M.init_model(SEED, cfg, device=dev,
                         place=shapi.leaf_placer(plan, mesh))
    state = opt.init(dp)
    step = steps.build_train_step(cfg, mesh, plan, opt, microbatches=mb)
    batch = par_batch(cfg, dev)
    par_sync(dev)
    par_peak(dev, reset=True)
    t0 = time.perf_counter()
    dp, state, _ = step(dp, state, batch)
    par_sync(dev)
    first = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        dp, state, met = step(dp, state, batch)
        par_sync(dev)
        second = time.perf_counter() - t0
    keys = ("c10d", "gloo", "nccl", "wait_tensor", "all_reduce",
            "all_gather", "reduce_scatter", "all_to_all")
    host = sum(e.self_cpu_time_total for e in prof.key_averages()
               if any(k in e.key.lower() for k in keys)) / 1e6
    nccl = sum(e.device_time_total for e in prof.key_averages()
               if "nccl" in e.key.lower()
               and e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    d = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("data", 1)
    tokens_local = PAR["batch"] * PAR["seq"] // d
    return {"first_step_s": first, "step_s": second,
            "tokens_per_s": PAR["batch"] * PAR["seq"] / second,
            "collective_host_s": host, "nccl_device_s": nccl,
            "loss_bf16": float(met["loss"]),
            "max_memory_allocated": par_peak(dev),
            "bytes_per_step": par_bytes(dp, mesh, cfg, tokens_local,
                                        plan, mb)}


def par_compress(world: int, rank: int, dev, group=None) -> dict:
    """``compressed_psum`` over the group on CUDA tensors, against the
    formula replayed in numpy from every rank's seeded inputs: the int32
    sum of the int8 payloads times the mean scale over n, and the
    residual (x + r) - q scale."""
    from repro_torch.optim import compression as C

    def inputs(r):
        rng = np.random.default_rng(SEED + 31 + r)
        return (rng.standard_normal(PAR_COMPRESS).astype(np.float32),
                rng.standard_normal(PAR_COMPRESS).astype(np.float32) * 1e-3)

    x, res = inputs(rank)
    out, nr = C.compressed_psum(torch.as_tensor(x, device=dev), group,
                                torch.as_tensor(res, device=dev))
    qs, ss, mine = [], [], None
    for r in range(world):
        xr, rr = inputs(r)
        fb = xr + rr
        s = np.float32(np.abs(fb).max() / np.float32(127.0)
                       + np.float32(1e-12))
        q = np.clip(np.round(fb / s), -127, 127).astype(np.int32)
        qs.append(q)
        ss.append(s)
        if r == rank:
            mine = fb - q.astype(np.float32) * s
    n = np.float32(world)
    want = np.sum(qs, axis=0).astype(np.float32) * (
        np.float32(np.sum(ss, dtype=np.float32)) / n) / n
    o, m_ = out.cpu().numpy(), nr.cpu().numpy()
    return {"out_err": float(np.abs(o - want).max() / np.abs(want).max()),
            "res_err": float(np.abs(m_ - mine).max() / np.abs(mine).max()),
            "elements": int(x.size), "payload_bytes": int(x.size) + 4}


def par_restore(cfg, mesh, plan, mb, ckpt, dev) -> dict:
    """Elastic restore: the checkpoint saved under model = 2 after step 1
    restored onto ``mesh`` / ``plan``; the logical arrays against the
    checkpoint read on one device (bit for bit), then step 2's loss."""
    from repro_torch import tree
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi
    opt = par_opt()
    params, axes = M.init_model(SEED, cfg, device=dev)
    p_sh = shapi.param_shardings(plan, mesh, params, axes)
    like = shapi.distribute(params, mesh, p_sh)
    st = opt.init(like)
    o_sh = steps._opt_shardings(mesh, plan, axes, st, p_sh)
    t0 = time.perf_counter()
    rp, rs = ckpt_io.restore(ckpt, 1, (like, st), (p_sh, o_sh), mesh=mesh)
    par_sync(dev)
    restore_s = time.perf_counter() - t0
    del like, st
    plain = ckpt_io.restore(ckpt, 1, (params, opt.init(params)))
    same = all(torch.equal(a.to_local() if hasattr(a, "device_mesh")
                           else a, par_local(b, a))
               for a, b in zip(tree.leaves((rp, rs)), tree.leaves(plain)))
    del plain, params
    step = steps.build_train_step(cfg, mesh, plan, opt, microbatches=mb)
    _, _, met = step(rp, rs, par_batch(cfg, dev))
    return {"bit_equal": same, "loss2": float(met["loss"]),
            "restore_s": restore_s,
            "data_sharded_leaves": sum(
                1 for x in tree.leaves(rp) if hasattr(x, "device_mesh")
                and x.placements[0].is_shard())}


def par_plans(world: int, names, backend: str, dev, job) -> dict:
    """Every plan of ``names`` on this rank (its mesh over the default
    group): the f32 checks, the planted fault on the data-parallel plan,
    the bf16 times; and the world's compressed_psum and restore duties."""
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import make_host_mesh
    from repro_torch.sharding import api as shapi
    reset_launches()
    rank = dist.get_rank()
    cfg32 = dataclasses.replace(job["cfg"], dtype="float32")
    cfg16 = dataclasses.replace(job["cfg"], dtype="bfloat16")
    ref = par_reference(cfg32, dev)
    recs = {}
    for name in names:
        world_, model, fsdp, mb = job["plans"][name]
        assert world_ == world, (name, world)
        mesh = make_host_mesh(model=model, device_type=dev.type)
        plan = shapi.tp_plan(data_axes=("data",), model_axis="model",
                             fsdp=fsdp)
        t0 = time.perf_counter()
        rec = par_run(cfg32, mesh, plan, mb, ref, dev,
                      save=job["ckpt"] if name == PAR_SAVE else None,
                      census=name in (PAR_CENSUS, PAR_NCCL))
        if name == PAR_FAULT:
            rec["fault"] = par_run(cfg32, mesh, plan, mb, ref, dev,
                                   fault=True)
        if name in PAR_RESTORE:
            rec["restore"] = par_restore(cfg32, mesh, plan, mb,
                                         job["ckpt"], dev)
        rec["checks_s"] = time.perf_counter() - t0
        rec["times"] = par_times(cfg16, mesh, plan, mb, dev)
        recs[name] = rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if world > 1:
        recs["compress"] = par_compress(world, rank, dev)
    recs["launches"] = dict(LAUNCHES)
    return recs


def parallel_rank(rank: int, world: int, backend: str, names,
                  job_dir: str) -> None:
    """One rank of the parallel phase, spawned by it (gloo: card 0,
    shared; NCCL: a card a rank): ``par_plans``, pickled to
    ``job_dir``."""
    import faulthandler
    import os
    import pickle
    import traceback
    faulthandler.enable()
    try:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist
        from repro_torch.launch import init_lane_group
        job_dir = Path(job_dir)
        with open(job_dir / "job.pkl", "rb") as f:
            job = pickle.load(f)
        PAR.update(job["par"])   # the phase's settings, as the parent has them
        cuda = job["device_type"] == "cuda"
        if cuda and backend == "gloo":
            torch.cuda.set_device(0)
        init_lane_group(backend, rank, world, store=dist.FileStore(
            str(job_dir / f"store_{backend}{world}"), world),
            timeout_s=PAR_TIMEOUT_S)
        try:
            dev = torch.device("cuda", torch.cuda.current_device()) \
                if cuda else torch.device("cpu")
            recs = par_plans(world, names, backend, dev, job)
        finally:
            dist.destroy_process_group()
        with open(job_dir / f"{backend}{world}_rank{rank}.pkl", "wb") as f:
            pickle.dump(recs, f)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


# -- the parallel phase's fsdp_wide part ------------------------------------


def wide_config(name: str):
    """WIDE_PLANS[name]: the architecture at its published widths, bf16,
    cut to its plan's depth."""
    from repro_torch.configs import get_arch
    arch, layers = WIDE_PLANS[name]
    return dataclasses.replace(get_arch(arch), n_layers=layers)


def wide_cell():
    from repro_torch.launch import shapes
    name = f"train_{WIDE['seq']}x{WIDE['batch']}"
    return shapes.ShapeCell(name, "train", WIDE["seq"], WIDE["batch"])


def wide_batch(cfg, dev) -> dict:
    """WIDE's fixed batch of tokens and labels, from the seed."""
    toks = np.random.default_rng(SEED + 37).integers(
        1, cfg.vocab - 1, (WIDE["batch"], WIDE["seq"] + 1)).astype(np.int32)
    t = torch.as_tensor(toks, device=dev)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def wide_trace_start(out: Path, names, device_type: str) -> dict:
    """The fake world-4 traces of WIDE_PLANS ``names`` (data = 2 x model =
    2, FSDP; dryrun.run_cell in a spawned process each, side by side):
    ``{name: process}``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    model = WIDE["model"]
    mesh = f"host{WIDE['world'] // model}x{model}"
    procs = {}
    for name in names:
        cfg = wide_config(name)
        d = out / f"wide_{name}"
        d.mkdir(parents=True, exist_ok=True)
        job = dict(arch=cfg.name, shape_name=wide_cell().name,
                   mesh_kind=mesh, cfg=cfg, fsdp=True, cell=wide_cell(),
                   out_dir=d, skip_delta=True, device=device_type)
        procs[name] = ctx.Process(target=dry_cell, args=(
            job, str(out / f"wide_{name}.log")))
        procs[name].start()
    return procs


def wide_trace_read(out: Path, name: str) -> dict:
    """One plan's fake trace: its record's memory (arguments, temporaries
    and their sum, the traced peak a rank) and collectives."""
    cfg = wide_config(name)
    model = WIDE["model"]
    rec = dry_record(out / f"wide_{name}", cfg.name, wide_cell().name,
                     f"host{WIDE['world'] // model}x{model}")
    if rec["status"] != "ok":
        log = out / f"wide_{name}.log"
        tail = log.read_text()[-3000:] if log.exists() else ""
        raise AssertionError(f"fsdp_wide {name} trace: {rec.get('error')}"
                             f"\n{tail}")
    mem = rec["memory"]
    return {"args": mem["argument_size_in_bytes"],
            "temp": mem["temp_size_in_bytes"],
            "peak": mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"],
            "counts": rec["cost_raw"]["coll_counts"],
            "bytes": dict(rec["cost_raw"]["coll_detail"],
                          total=rec["cost_raw"]["coll"]),
            "trace_s": rec["trace_s"], "device": rec["device"]}


def wide_forward(cfg, dev) -> dict:
    """(b)'s reference: the loss of a no_grad forward of the seed's
    parameters (init_model, whole, on this card) on WIDE's batch."""
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    params, _ = M.init_model(SEED, cfg, device=dev)
    with torch.no_grad():
        loss, _ = M.loss_fn(cfg, params, wide_batch(cfg, dev))
    out = {"loss": float(loss), "seconds": time.perf_counter() - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else 0}
    del params, loss
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def wide_fault_loss(cfg, mesh, plan, params, batch) -> float:
    """(b)'s planted fault: the step 1 forward (no_grad) with every
    rank's all-gather of the unembedding table keeping only its own shard
    (the rest of the gathered buffer zero): a gather whose result is
    dropped. The collective still runs on every rank. The table is the
    forward's second gather of a (vocab, d_model) leaf (the embedding's
    is the first), its only one when the embeddings are tied."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi
    from torch.distributed.tensor import DTensor
    real = shapi._for_compute
    which = 1 if cfg.tie_embeddings else 2
    seen = [0]

    def dropped(plan_, x):
        out = real(plan_, x)
        if out is x or tuple(x.shape) != (cfg.vocab, cfg.d_model):
            return out      # no gather, or not a table
        seen[0] += 1
        if seen[0] != which:
            return out
        loc = out.to_local().clone()
        off, size = shapi._local_window(x)
        for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
            if name == plan.fsdp_axis and p.is_shard():
                keep = torch.zeros(loc.shape[p.dim], dtype=loc.dtype,
                                   device=loc.device)
                keep[off[p.dim]:off[p.dim] + size[p.dim]] = 1
                shape = [1] * loc.ndim
                shape[p.dim] = loc.shape[p.dim]
                loc = loc * keep.reshape(shape)
        return DTensor.from_local(loc, out.device_mesh, out.placements,
                                  run_check=False, shape=out.shape,
                                  stride=out.stride())

    shapi._for_compute = dropped
    try:
        with torch.no_grad(), shapi.activation_context(mesh, plan):
            loss, _ = M.loss_fn(cfg, params,
                                steps._place_batch(mesh, plan, batch))
        assert seen[0] >= which, f"the table's gather was not met: {seen}"
        return float(par_logical(loss))
    finally:
        shapi._for_compute = real


def wide_census(dev):
    """A ``utils.comms.StepCensus`` that also reads, at each new peak of
    its live storages, the card's allocator (``memory_allocated``) and
    the eight largest live storages: the two counts side by side."""
    from repro_torch.utils import comms

    class PeakCensus(comms.StepCensus):
        allocated_at_peak = 0
        largest_at_peak: list = []

        def _track(self, out):
            before = self.peak_bytes
            super()._track(out)
            if self.peak_bytes > before and dev.type == "cuda":
                self.allocated_at_peak = torch.cuda.memory_allocated(dev)
                if self.peak_bytes > before + (1 << 27):
                    self.largest_at_peak = sorted(self._live.values())[-8:]

    return PeakCensus()


def wide_plan(name: str, dev) -> dict:
    """One WIDE_PLANS plan on this rank: the parameters drawn and placed
    a leaf at a time, AdamW's state, WIDE["steps"] bf16 steps (step 1
    under utils.comms.StepCensus, step 2 under torch.profiler), each
    step's loss and allocator peak, the logical arrays' digest, and the
    planted fault's forward."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import make_host_mesh, steps
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.sharding import api as shapi
    from repro_torch.utils import comms
    cfg = wide_config(name)
    mesh = make_host_mesh(model=WIDE["model"], device_type=dev.type)
    plan = shapi.tp_plan(data_axes=("data",), model_axis="model", fsdp=True)
    t0 = time.perf_counter()
    params, _ = M.init_model(SEED, cfg, device=dev,
                             place=shapi.leaf_placer(plan, mesh))
    opt = AdamW(lr=warmup_cosine(WIDE["lr"], 1, WIDE["steps"]))
    state = opt.init(params)
    batch = wide_batch(cfg, dev)
    par_sync(dev)
    init_s = time.perf_counter() - t0
    step = steps.build_train_step(cfg, mesh, plan, opt)
    census = wide_census(dev)
    args = census.exclude((params, state, batch))
    rec = {"init_s": init_s, "census_args": args, "losses": [],
           "step_s": [], "before": [], "peak": []}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    prof = None
    for s in range(WIDE["steps"]):
        par_sync(dev)
        rec["before"].append(torch.cuda.memory_allocated()
                             if dev.type == "cuda" else 0)
        par_peak(dev, reset=True)
        t0 = time.perf_counter()
        if s == 0:
            with census:
                params, state, met = step(params, state, batch)
        else:
            with profile(activities=acts) as prof:
                params, state, met = step(params, state, batch)
                par_sync(dev)
        par_sync(dev)
        rec["step_s"].append(time.perf_counter() - t0)
        rec["peak"].append(par_peak(dev))
        rec["losses"].append(float(met["loss"]))
    keys = ("c10d", "gloo", "nccl", "wait_tensor", "all_reduce",
            "all_gather", "reduce_scatter", "all_to_all")
    ka = prof.key_averages()
    rec["collective_host_s"] = sum(
        e.self_cpu_time_total for e in ka
        if any(k in e.key.lower() for k in keys)) / 1e6
    rec["nccl_device_s"] = sum(
        e.device_time_total for e in ka if "nccl" in e.key.lower()
        and e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    rec["loss_hex"] = [x.hex() for x in rec["losses"]]
    rec["census"] = {"bytes": comms.collective_bytes(census.records),
                     "counts": comms.collective_counts(census.records),
                     "temp": census.peak_bytes,
                     "allocated_at_peak": census.allocated_at_peak,
                     "largest_at_peak": census.largest_at_peak}
    d = WIDE["world"] // WIDE["model"]
    rec["reckoned"] = par_bytes(params, mesh, cfg, WIDE["batch"]
                                * WIDE["seq"] // d, plan)
    rec["digest"] = par_digest(params, state)
    del state
    rec["fault_loss"] = wide_fault_loss(cfg, mesh, plan, params, batch)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def wide_rank(rank: int, world: int, names, job_dir: str) -> None:
    """One NCCL rank of the fsdp_wide part, a card each, spawned by the
    parallel phase: ``wide_plan`` for each plan of ``names``, pickled to
    ``job_dir``."""
    import faulthandler
    import os
    import pickle
    import traceback
    faulthandler.enable()
    try:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist
        from repro_torch.kernels import LAUNCHES, reset_launches
        from repro_torch.launch import init_lane_group
        torch.cuda.set_device(rank)
        job_dir = Path(job_dir)
        init_lane_group("nccl", rank, world, store=dist.FileStore(
            str(job_dir / "store_wide"), world), timeout_s=WIDE_TIMEOUT_S)
        reset_launches()
        try:
            dev = torch.device("cuda", rank)
            recs = {name: wide_plan(name, dev) for name in names}
        finally:
            dist.destroy_process_group()
        recs["launches"] = dict(LAUNCHES)
        with open(job_dir / f"wide_rank{rank}.pkl", "wb") as f:
            pickle.dump(recs, f)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


# -- the dryrun phase --------------------------------------------------------


def dry_cell(job: dict, log: str) -> None:
    """One fake-group trace of the dryrun phase, spawned by it (a
    process holds one default group): ``dryrun.run_cell(**job)`` with
    the phase's own config object over a host mesh, ``job["cell"]``
    registered as a shape first. Its output goes to ``log``; it exits 1
    unless the record is ok."""
    import os
    import traceback
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    code = 1
    try:
        torch.set_num_threads(1)
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        from repro_torch.launch import dryrun, shapes
        cell = job.pop("cell")
        shapes.SHAPES[cell.name] = cell
        code = 0 if dryrun.run_cell(**job)["status"] == "ok" else 1
    except BaseException:
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def dry_wait(proc, timeout: float) -> int:
    """The exit code of a subprocess or a spawned process, killed at
    ``timeout`` seconds."""
    if isinstance(proc, subprocess.Popen):
        try:
            return proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            return proc.wait()
    proc.join(timeout)
    if proc.is_alive():
        proc.kill()
        proc.join()
    return proc.exitcode


def dry_record(out_dir: Path, arch: str, shape: str, mesh: str) -> dict:
    """The dry-run's record of one cell (a missing one reads as an
    error, with the directory's files)."""
    p = out_dir / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return {"status": "error", "error": f"no record {p.name} in "
                f"{sorted(x.name for x in out_dir.glob('*'))}"}
    return json.loads(p.read_text())


def dry_example(text: str) -> dict:
    """The checks on an example twin's printout: quickstart's brackets
    (adaptive and auto-spectrum) hold its printed truth and both judges
    are certified; sensor placement has no uncertified decision."""
    import re
    out = {"ok": False}
    m = re.search(r"true BIF = ([-0-9.e+]+)", text)
    if m:
        truth = float(m.group(1))
        brackets = [(float(a), float(b)) for a, b in re.findall(
            r"(?:adaptive|auto-spectrum): \[([-0-9.e+]+), ([-0-9.e+]+)\]",
            text)]
        judges = re.findall(r"certified=(True|False)", text)
        # the truth prints to 6 places, the brackets to 5
        out.update(truth=truth, brackets=brackets, judges=judges,
                   ok=len(brackets) == 2 and len(judges) == 2
                   and all(j == "True" for j in judges)
                   and all(lo - 1e-5 <= truth <= hi + 1e-5
                           for lo, hi in brackets))
        return out
    m = re.search(r"uncertified decisions: (\d+)", text)
    if m:
        sel = re.search(r"selected: (\d+) sensors", text)
        out.update(uncertified=int(m.group(1)),
                   selected=int(sel.group(1)) if sel else None,
                   ok=int(m.group(1)) == 0 and sel is not None)
    return out


# -- the train_families phase ------------------------------------------------


def fam_text(cfg) -> int:
    """Text tokens a sequence of FAM's traffic: whisper's text context,
    qwen2-vl's text after the image, FAM["seq"] for the others."""
    if cfg.is_encdec:
        return FAM["text"]
    if cfg.family == "vlm":
        return FAM["vlm_text"]
    return FAM["seq"]


def fam_positions(cfg, b: int) -> int:
    """The positions a step runs through the stack: text tokens, and the
    encoder's frames or the image's patches."""
    extra = FAM["frames"] if cfg.is_encdec else \
        FAM["grid"] ** 2 if cfg.family == "vlm" else 0
    return b * (fam_text(cfg) + extra)


def fam_batch(cfg, b: int, t: int, dev, *, frames: int = 0,
              grid: int = 0) -> dict:
    """A fixed train batch from the seed: ``b`` sequences of ``t`` tokens
    and their next tokens as labels, and the family's inputs
    (``LMInputs``: ``frames`` frame embeddings, or a ``grid`` x ``grid``
    image ahead of the text at Qwen2-VL's positions)."""
    rng = np.random.default_rng(SEED + 37)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab - 1, (b, t + 1)).astype(
        np.int32), device=dev)
    inputs = TOKENS_ONLY
    if cfg.family == "encdec":
        inputs = LMInputs(frames=rng.standard_normal(
            (b, frames, cfg.d_model)).astype(np.float32))
    elif cfg.family == "vlm":
        inputs = LMInputs(vision=rng.standard_normal(
            (b, grid * grid, cfg.d_model)).astype(np.float32), grid=grid)
    batch = inputs.prefill(cfg, toks[:, :-1], dev)
    batch["labels"] = toks[:, 1:]
    return batch


def fam_a_step(a, dev) -> tuple:
    """(a)'s one f32 step (AdamW, eps 1e-3) of ``a``'s config from its
    parameters and batch on ``dev``: the loss and the parameters after the
    step, on the host."""
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW, warmup_cosine
    opt = AdamW(lr=warmup_cosine(FAM["lr"], 1, FAM["steps"]), eps=1e-3)
    p = tree.map(lambda x: x.to(dev, copy=True), a["params"])
    b = tree.map(lambda x: x.to(dev), a["batch"])
    p, _, met = steps.build_train_step(a["cut"], optimizer=opt)(
        p, opt.init(p), b)
    return float(met["loss"]), [x.cpu() for x in tree.leaves(p)]


def fam_cut(published):
    """Check (a)'s config: LM_CUT's depth (zamba2 one unit and its tail),
    whisper's encoder cut alike, f32."""
    layers = LM_CUT["hybrid_layers"] if published.family == "hybrid" \
        else LM_CUT["layers"]
    return dataclasses.replace(
        published, n_layers=layers, dtype="float32",
        enc_layers=min(published.enc_layers, LM_CUT["layers"]))


def fam_cut_text(cut) -> str:
    return (f"{cut.n_layers} layers" + (f" + {cut.enc_layers} encoder"
                                        if cut.is_encdec else "")
            + f", {FAM_A['batch']} x {FAM_A['seq']} tokens"
            + (f", {FAM_A['frames']} frames" if cut.is_encdec else "")
            + (f", a {FAM_A['grid']} x {FAM_A['grid']} image"
               if cut.family == "vlm" else "") + ", f32")


def fam_names(params) -> list:
    """Dotted leaf names in ``repro_torch.tree``'s order."""
    if isinstance(params, dict):
        return [f"{k}.{n}" if n else k for k in sorted(params)
                for n in fam_names(params[k])]
    return [""]


def fam_param_ratio(got, want, zero, names, tol) -> dict:
    """The parameters after one step against the CPU's, each leaf's error
    over its limit (the rules of tests/test_torch_parallel.py): ``tol``
    of the leaf's largest entry; a key bias (zero gradient in exact
    arithmetic) 1e-6 of the tree's largest entry; a leaf initialised to
    zero, which holds the update alone (lr m / (sqrt(v) + eps), its last
    bits moved 1 / eps times the gradient's), max(tol, 1e-4) of its
    own. ``worst`` is the largest ratio; 1 is the limit."""
    top = max(float(w.abs().max()) for w in want)
    worst, where = 0.0, None
    for g, w, z, n in zip(got, want, zero, names):
        err = float((g - w).abs().max())
        if n.endswith("wk.b"):
            r = err / (1e-6 * top)
        else:
            lim = max(tol, 1e-4) if z else tol
            r = err / (lim * max(float(w.abs().max()), 1e-30))
        if r > worst:
            worst, where = r, n
    return {"worst": worst, "leaf": where}


class RouteLog:
    """While active, records each MoE routing call (``moe._route``) as a
    summary on the host: the group, its count and the capacity, the most
    (token, choice) pairs routed to one expert of one group and the fewest
    experts a group routes to, the slots each token kept (flat over
    (batch, time)), how many experts took a token, the closest pair among
    each token's top-(k+1) router probabilities, the mean and the least
    cosine between a token's router input and its group's mean input, and
    with ``masks`` the dispatch mask as a bool tensor."""

    def __init__(self, masks: bool = False):
        self.masks = masks
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe._route

        def recording(cfg, p, x, **kw):
            r = self.real(cfg, p, x, **kw)
            xg = x.reshape(-1, r.group, x.shape[-1]).to(torch.float32)
            cos = torch.nn.functional.cosine_similarity(
                xg, xg.mean(dim=1, keepdim=True), dim=-1)
            del xg
            top = torch.topk(r.probs, min(cfg.moe_top_k + 1,
                                          cfg.moe_experts), dim=-1)
            chosen = torch.nn.functional.one_hot(
                top.indices[..., :cfg.moe_top_k], cfg.moe_experts).sum(
                dim=(1, 2))                        # (n, E) tokens routed
            top = top.values
            rec = {"group": r.group, "cap": r.cap,
                   "groups": r.dispatch.shape[0],
                   "load_max": int(chosen.max()),
                   "experts_chosen": int((chosen > 0).sum(dim=1).min()),
                   "kept": r.dispatch.sum(dim=(2, 3)).reshape(-1).to(
                       torch.int64).cpu().numpy(),
                   "experts_used": int((r.dispatch.sum(dim=(0, 1, 3)) > 0)
                                       .sum()),
                   "margin": float((top[..., :-1] - top[..., 1:]).min()),
                   "input_cos_mean": float(cos.mean()),
                   "input_cos_min": float(cos.min())}
            if self.masks:
                rec["mask"] = (r.dispatch > 0).cpu()
            self.calls.append(rec)
            return r

        moe._route = recording
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


class LMInputs:
    """A model family's inputs beside the prompt tokens, for the LM
    phases: none (token-only families, which the Engine serves), frame
    embeddings (enc-dec: the prefill encodes them, a decode step takes
    their encoder memory from ``_encode``), or patch embeddings ahead of
    the prompt with Qwen2-VL's M-RoPE positions (VLM: a ``grid`` x
    ``grid`` image at (0, row, col), text from ``grid`` onward on all
    three streams, decode steps continuing on all three). The arrays stay
    on the host in f32 and go to a device in the model's dtype."""

    def __init__(self, frames=None, vision=None, grid: int = 0):
        self.frames, self.vision, self.grid = frames, vision, grid

    @property
    def engine(self) -> bool:
        """Whether ``Engine.generate`` serves the family: it builds
        token-only batches."""
        return self.frames is None and self.vision is None

    @property
    def extra_tokens(self) -> int:
        """Cache rows ahead of the prompt (the patch embeddings)."""
        return 0 if self.vision is None else self.vision.shape[1]

    def cut(self, frames: int, grid: int) -> "LMInputs":
        """The first ``frames`` frames, or the first ``grid``**2 patches as
        a ``grid`` x ``grid`` image (check (a)'s cut)."""
        if self.frames is not None:
            return LMInputs(frames=self.frames[:, :frames])
        if self.vision is not None:
            return LMInputs(vision=self.vision[:, :grid * grid], grid=grid)
        return self

    def _on(self, x, dev, cfg):
        from repro_torch.models import common as cm
        return torch.as_tensor(x, device=dev).to(cm._dtype(cfg.dtype))

    def _text_positions(self, start: int, t: int, b: int, dev):
        return (self.grid + torch.arange(start, start + t, device=dev,
                                         dtype=torch.int32)).expand(
            b, 3, t)

    def prefill(self, cfg, tokens, dev) -> dict:
        """The prefill batch of ``tokens`` (B, T) on ``dev``."""
        batch = {"tokens": tokens}
        if self.frames is not None:
            batch["frames"] = self._on(self.frames, dev, cfg)
        if self.vision is not None:
            b, t = tokens.shape
            g = self.grid
            rows, cols = np.divmod(np.arange(g * g), g)
            img = torch.as_tensor(np.stack([np.zeros(g * g, np.int32),
                                            rows, cols]).astype(np.int32),
                                  device=dev).expand(b, 3, g * g)
            batch["vision_embeds"] = self._on(self.vision, dev, cfg)
            batch["positions"] = torch.cat(
                [img, self._text_positions(0, t, b, dev)], dim=2)
        return batch

    def memory(self, cfg, params, dev):
        """An enc-dec model's encoder memory of the frames (``_encode``),
        else None."""
        if self.frames is None:
            return None
        from repro_torch.models import model as M
        with torch.no_grad():
            return M._encode(cfg, params, self._on(self.frames, dev, cfg))

    def decode(self, tok, p: int, dev, memory=None) -> dict:
        """The decode batch of ``tok`` (B, 1), the prompt's token ``p``
        (0-based, pads included)."""
        if self.vision is not None:
            pos = self._text_positions(p, 1, tok.shape[0], dev)
        else:
            pos = torch.full((1,), p, dtype=torch.int32, device=dev)
        batch = {"tokens": tok, "position": pos}
        if memory is not None:
            batch["enc_memory"] = memory
        return batch


TOKENS_ONLY = LMInputs()


class Smoke:
    def __init__(self, rt, dev):
        self.rt = rt          # the repro_torch package
        self.dev = dev
        self.kernels = {}     # name -> kernels-line entry
        self.launches = {}    # name -> launches on the main path
        self.path_calls = []  # (iterations, launches) of each path call
        self.dense = None     # shared problem data between phases
        self.sparse = None
        self.bilinear = None
        self.apps = None
        self.serve = {}       # cell -> its requests and their truths
        self.kv = None
        self.attention = None
        self.setup_s = {}     # seconds of the problems' set-up steps
        self.late_library = []  # (name, kernel, library call): timed last
        self.kernels_per_call = {}  # name -> device kernels a call runs
        self.train_cfg = None  # the train phase's config (None: olmo-1b)
        self.gen = None       # the generate phase's model, prompts, caches
        self.par_cfg = None   # the parallel phase's config (None: PAR_ARCH)
        self.par_census = None  # PAR_CENSUS's ranks' collectives, step 2
        self.wide_traced = None  # fsdp_wide's fake traces, where it ran

    # -- problems --------------------------------------------------------

    def dense_problem(self):
        if self.dense is None:
            from repro_torch.data import rbf_kernel
            t0 = time.perf_counter()
            # The truncated RBF kernel is indefinite at this N with the
            # default 1e-3 ridge (its lowest eigenvalue is below zero);
            # the repo's own DPP example sizes the ridge at 0.05 to cover
            # the truncation (examples/dpp_sampling.py), as done here.
            a_np = rbf_kernel(4177, dim=4, sigma=0.5, ridge=0.05, seed=SEED)
            a = torch.as_tensor(a_np, device=self.dev)
            w = torch.linalg.eigvalsh(a)
            lam_lo, lam_hi = w[0].item(), w[-1].item()
            assert lam_lo > 0, f"dense operator not SPD: lambda_min={lam_lo}"
            rng = np.random.default_rng(SEED + 1)
            u = torch.as_tensor(rng.standard_normal((K, a.shape[0])),
                                device=self.dev)
            self.dense = dict(a=a, u=u, lmn=0.9 * lam_lo, lmx=1.1 * lam_hi,
                              lam=(lam_lo, lam_hi))
            self.setup_s["dense problem"] = time.perf_counter() - t0
        return self.dense

    def sparse_problem(self):
        if self.sparse is None:
            from repro_torch.core import bell_from_dense
            from repro_torch.data import graph_laplacian
            t_s = time.perf_counter()
            lap = graph_laplacian(8192, mean_degree=12, rewire=0.0, seed=SEED)
            bell = bell_from_dense(lap, bs=128, dtype=np.float32,
                                   device=self.dev)
            # the operator the f32 blocks hold, exactly, in f64, and its
            # eigenpairs (the trace phase's truths)
            a32 = torch.as_tensor(lap.astype(np.float32).astype(np.float64),
                                  device=self.dev)
            t0 = time.perf_counter()
            w, v = torch.linalg.eigh(a32)
            lam_lo, lam_hi = w[0].item(), w[-1].item()
            self.setup_s["sparse eigh"] = time.perf_counter() - t0
            assert lam_lo > 0, f"sparse operator not SPD: {lam_lo}"
            rng = np.random.default_rng(SEED + 2)
            u = torch.as_tensor(rng.standard_normal((K, lap.shape[0])),
                                device=self.dev)
            self.sparse = dict(lap=lap, bell=bell, a32=a32, u=u, w=w, v=v,
                               lmn=0.9 * lam_lo, lmx=1.1 * lam_hi,
                               lam=(lam_lo, lam_hi))
            self.setup_s["sparse problem"] = time.perf_counter() - t_s
        return self.sparse

    def trace_problem(self):
        """The sparse operator for the logdet: its f32 blocks with the
        diagonal held in f64, so the probes and Krylov vectors are f64
        (trace_quad draws probes in the diagonal's dtype); the probes of
        the Hutchinson stream of key SEED, drawn again for the truths;
        each probe's z^T log(A32) z from the eigenpairs; and the
        Cholesky logdet of A32."""
        sp = self.sparse_problem()
        if "trace_op" not in sp:
            from repro_torch.core.trace import rademacher_probe
            t0 = time.perf_counter()
            bell = sp["bell"]
            sp["trace_op"] = dataclasses.replace(
                bell, diag_vals=bell.diag_vals.to(torch.float64))
            z = torch.stack([rademacher_probe(SEED, i, bell.n)
                             for i in range(PROBES)]).to(self.dev)
            # per-probe truths z^T log(A32) z, from the eigenpairs
            c = z @ sp["v"]
            sp["probe_truth"] = torch.sum(c * c * torch.log(sp["w"]), dim=-1)
            sp["z"] = z
            chol = torch.linalg.cholesky(sp["a32"])
            sp["logdet"] = float(2.0 * torch.sum(torch.log(torch.diagonal(
                chol))))
            self.setup_s["trace probes and truths"] = \
                time.perf_counter() - t0
        return sp

    def bilinear_problem(self):
        """The K6 path's 16 systems A_b = K + lam_b I, K the dense phase's
        f64 RBF kernel, each rounded to f32 (the operand K6 reads); the
        exact f64 values of those f32 entries; seeded f64 queries; the
        per-lane interval [0.9 (lam_lo + lam_b), 1.1 (lam_hi + lam_b)]
        from K's extreme eigenvalues (rounding K + lam_b I to f32 moves
        an eigenvalue by at most |E|_F, about 1e-5 here, against a 10%
        margin of at least 6e-3); the truths u_b^T A_b^-1 u_b of the f32
        operators from dense f64 solves."""
        if self.bilinear is None:
            from repro_torch.core import MatvecFn
            from repro_torch.kernels import ops
            d = self.dense_problem()
            t0 = time.perf_counter()
            k, n = d["a"], d["a"].shape[0]
            lam = 0.05 * 2.0 ** (torch.arange(SYSTEMS, device=self.dev,
                                              dtype=torch.float64) / 4)
            eye = torch.eye(n, dtype=torch.float64, device=self.dev)
            a32 = torch.stack([(k + lb * eye).to(torch.float32)
                               for lb in lam])
            rng = np.random.default_rng(SEED + 7)
            u = torch.as_tensor(rng.standard_normal((SYSTEMS, n)),
                                device=self.dev)
            truth = torch.stack([
                u[i] @ torch.linalg.solve(a32[i].double(), u[i])
                for i in range(SYSTEMS)])
            lam_lo, lam_hi = d["lam"]
            diag = torch.diagonal(a32, dim1=1, dim2=2)
            self.bilinear = dict(
                a32=a32, u=u, truth=truth, lam=lam,
                lmn=0.9 * (lam_lo + lam), lmx=1.1 * (lam_hi + lam),
                # the K6 path's operator: the kernel's y as the matvec
                op=MatvecFn(fn=lambda x: ops.fused_matvec(a32, x)[0],
                            n_static=n, diag_vals=diag))
            self.setup_s["bilinear problem"] = time.perf_counter() - t0
        return self.bilinear

    def apps_problem(self):
        """The applications' inputs: the chains' initial mask (about N/3
        items of the dense phase's kernel) and their draws, from a seeded
        generator on the host (the steps read their items there); greedy
        MAP's quality-weighted kernel diag(q) K diag(q) and its interval
        (spec(K) scaled by the extremes of q^2, by Ostrowski's theorem);
        the double-greedy kernel (DG_N items, the same builder), its
        interval and its uniforms."""
        if self.apps is None:
            from repro_torch.core import dpp
            from repro_torch.data import rbf_kernel
            t0 = time.perf_counter()
            d = self.dense_problem()
            n = d["a"].shape[0]
            rng = np.random.default_rng(SEED + 9)
            init = torch.as_tensor(rng.random(n) < 1.0 / 3.0,
                                   dtype=torch.float32, device=self.dev)
            q = torch.as_tensor(np.exp(QUALITY_SD * rng.standard_normal(n)),
                                device=self.dev)
            q2 = (q.min().item() ** 2, q.max().item() ** 2)
            gen = torch.Generator().manual_seed(SEED + 10)
            a_dg = torch.as_tensor(rbf_kernel(DG_N, dim=4, sigma=0.5,
                                              ridge=0.05, seed=SEED),
                                   device=self.dev)
            w = torch.linalg.eigvalsh(a_dg)
            assert w[0].item() > 0, "double-greedy kernel not SPD"
            self.apps = dict(
                init=init, dpp_draws=dpp.dpp_draws(gen, n, CHAIN_STEPS),
                greedy_a=q[:, None] * d["a"] * q[None, :],
                greedy_iv=(d["lmn"] * q2[0], d["lmx"] * q2[1]),
                kdpp_draws=dpp.kdpp_draws(gen, n, CHAIN_STEPS),
                dg_a=a_dg, dg_iv=(0.9 * w[0].item(), 1.1 * w[-1].item()),
                dg_u=torch.rand(DG_N, generator=gen))
            self.setup_s["apps problem"] = time.perf_counter() - t0
        return self.apps

    def attention_problem(self):
        """q (1, T, 128, 128), k and v (1, T, 8, 128) in bf16 from a
        seeded generator on the card, and the f32 call's operands: the
        first 16 query heads (BH, T, D) with the kv head they read."""
        if self.attention is None:
            t0 = time.perf_counter()
            g = torch.Generator(device=self.dev).manual_seed(SEED + 8)

            def draw(h):
                return torch.randn((1, TOKENS, h, HEAD_DIM), generator=g,
                                   device=self.dev).to(torch.bfloat16)

            q, k, v = draw(HEADS), draw(KV_HEADS), draw(KV_HEADS)
            rep = HEADS // KV_HEADS
            hs = torch.arange(F32_HEADS, device=self.dev)

            def flat32(x, heads):
                return x[0][:, heads].transpose(0, 1).to(
                    torch.float32).contiguous()

            self.attention = dict(
                q=q, k=k, v=v, q32=flat32(q, hs), k32=flat32(k, hs // rep),
                v32=flat32(v, hs // rep))
            self.setup_s["attention problem"] = time.perf_counter() - t0
        return self.attention

    # -- phases ----------------------------------------------------------

    def phase_device(self):
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "nvidia_smi": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
              "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    def phase_build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        paths = _build.build_all()
        seconds = time.perf_counter() - t0
        # registers and shared memory of each kernel, from nvcc -Xptxas -v
        ptxas, entry = {}, None
        for name in paths:
            log = _build.build_dir() / f"{name}.log"
            for ln in log.read_text().splitlines() if log.exists() else []:
                if "Compiling entry function" in ln:
                    entry = ln.split("'")[1]
                elif "Used" in ln and "registers" in ln and entry:
                    ptxas[entry] = ln.split(":", 1)[1].strip()
        emit({"phase": "build", "seconds": seconds,
              "libraries": sorted(paths), "dir": str(_build.build_dir()),
              "built_now": list(_build.BUILT), "ptxas": ptxas})

    def _kernel_line(self, name, route_src, replaces, got, want, tol, why,
                     kernel_ms, plain_ms, bound_ms, bound_by, library_ms,
                     fn, library_note=None, err=errors, extra=None):
        """One kernels line. ``library_ms`` may be the library call itself:
        a BSR @ dense yardstick, which may run Triton kernels, is timed in
        the last phase, in turns with ``fn``, because after a Triton
        kernel the profiler records nothing of a call that launches only
        the port's own kernels (the K6 and K7 lines came back empty behind
        K5's yardstick). ``err`` is the error measure:
        normwise against each output's largest entry, or K7's per row."""
        abs_err, rel_err = err(got, want)
        per_call = sum(c for _, c in device_kernels(fn).values())
        self.kernels_per_call[name] = per_call
        if callable(library_ms):
            self.late_library.append((name, fn, library_ms))
            library_ms = None
        line = {"phase": "kernels", "name": name, "max_abs_err": abs_err,
                "max_rel_err": rel_err, "error_measure": err.__name__,
                "tolerance": tol, "reason": why,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                # device kernels that one call of the wrapper launches
                "cuda_kernels_per_call": per_call}
        if library_note:
            line["library_covers"] = library_note
        line.update(extra or {})
        emit(line)
        assert rel_err <= tol, f"{name}: rel err {rel_err} > {tol}"
        self.kernels[name] = {
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": 0, "max_abs_err": abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}

    def _k4_rows_line(self):
        """K4's rows route at the GMRF cell's shapes: the benchmark's
        table (``quadbench/problems.py`` on ``grqc-laplacian-5242``: a
        rewired ring of 5242 nodes, 41 x 31 blocks of 128, about 608 stored
        values per non-zero) under 4096 lanes of f64 queries, with K4's
        operands as the fused solver hands them over three steps in (s_out,
        s_in and t padded to R*bs rows a lane). Every K4 launch of those
        steps and of the line must take ``bell_rows``; the line holds it to
        the plain version and gives its time beside two bounds: its inputs
        and outputs as handed over, and the cell's reckoning
        (``quadbench/reckon.py``: the non-zeros once, v, v_prev and r a
        lane)."""
        from quadbench import problems, reckon
        from repro_torch.core import BIFSolver, SparseBELL
        from repro_torch.kernels import LAUNCHES
        from repro_torch.kernels import lanczos_step as ls
        from repro_torch.kernels import ops

        lanes = 4096
        cfg = json.loads((Path(__file__).resolve().parent / "quadbench"
                          / "configs" / "grqc-laplacian-5242.json")
                         .read_text())
        p = problems.build(cfg, self.dev)
        op = SparseBELL(p["data"], p["cols"], p["diag"], p["n"])
        u = torch.randn((lanes, p["n"]), dtype=torch.float64,
                        device=self.dev, generator=torch.Generator(
                            device=self.dev).manual_seed(SEED + 5))
        solver = BIFSolver.create(backend="fused", **SPARSE)
        seen, real = [], ops.fused_step_bell

        def spy(*args):
            seen.append(args)
            return real(*args)

        def counts():
            return LAUNCHES["fused_step_bell"], ls.ROUTES["bell_rows"]

        before = counts()
        ops.fused_step_bell = spy
        try:
            solver.step_n(solver.init_state(op, u, lam_min=p["lmn"],
                                            lam_max=p["lmx"]), 3)
        finally:
            ops.fused_step_bell = real
        steps = len(seen)
        args = seen.pop()
        seen.clear()
        got = flatten_out(ops.fused_step_bell(*args))
        same = all(torch.equal(x, y) for x, y in zip(
            flatten_out(ops.fused_step_bell(*args)), got))
        launched = [b - a for a, b in zip(before, counts())]
        assert steps > 0 and launched == [steps + 2] * 2, \
            f"K4 off the rows route at the GMRF shapes: {launched}"
        assert same, "K4 rows: two launches differ"
        want = flatten_out(ls.fused_step_bell_plain(*args))
        e_abs, e_rel = errors(got, want)
        del want
        data, cols = args[0], args[1]
        rows = ls.bell_route(data, cols, torch.float64, torch.cuda
                             .get_device_properties(self.dev)
                             .shared_memory_per_block_optin)[1]
        nnz, n = rows.col.numel(), data.shape[0] * data.shape[2]
        bms, bby = bound(nbytes(*rows, *args[2:7], *args[7]) + nbytes(*got),
                         2 * lanes * nnz + 10 * lanes * n, torch.float64)
        cell_ms = bound(*reckon.fused_bell_launch(lanes, n=p["n"], nnz=nnz),
                        torch.float64)[0]
        # the library's SpMV in f64 over the same non-zeros (CSR @ dense,
        # the matvec only)
        with warnings.catch_warnings():   # sparse CSR is a beta API
            warnings.simplefilter("ignore")
            csr = torch.sparse_csr_tensor(
                rows.row_ptr.long(), rows.col.long(), rows.val.double(),
                size=(n, n))
        xt = (args[3] * args[5]).T.contiguous()

        def k4():
            return ops.fused_step_bell(*args)

        emit({"phase": "kernels", "name": "fused_step_bell[rows]",
              "shapes": {"data": list(data.shape), "lanes": lanes,
                         "nnz": nnz, "stored_per_nnz": data.numel() / nnz},
              "max_abs_err": e_abs, "max_rel_err": e_rel,
              "tolerance": 1e-12,
              "reason": "f64 vectors, f32 data cast to f64; summation "
                        "order, FMA",
              "kernel_ms": graph_ms(k4),
              "plain_ms": cuda_ms(lambda: ls.fused_step_bell_plain(*args),
                                  reps=3, warmup=1),
              "library_ms": cuda_ms(lambda: torch.matmul(csr, xt)),
              "library_covers": "the SpMV (CSR @ dense in f64, 4096 "
                                "right-hand sides)",
              "bound_ms": bms, "bound_by": bby, "cell_bound_ms": cell_ms,
              "route": "bell_rows", "launches": launched[0],
              "same_bits": same, "wrapper_ms": cuda_ms(k4),
              "per_launch_ms": per_launch_ms(k4)})
        assert e_rel <= 1e-12, f"K4 rows: rel err {e_rel}"

    def phase_kernels(self):
        from repro_torch.core import BIFSolver, Masked, stack_masks
        from repro_torch.core.operators import fused_operands
        from repro_torch.kernels import gql_update as gu
        from repro_torch.kernels import lanczos_step as ls
        from repro_torch.kernels import ops
        from repro_torch.kernels import spmv_bell as sb

        # ---- dense state after a few steps, with the reorth basis
        d = self.dense_problem()
        s = BIFSolver.create(**DENSE, reorth=True)
        st = s.step_n(s.init_state(self.rt.Dense(d["a"]), d["u"],
                                   lam_min=d["lmn"], lam_max=d["lmx"]), 3)
        g = st.st
        lmn = torch.full_like(g.g, d["lmn"])
        lmx = torch.full_like(g.g, d["lmx"])
        scalars = (g.lz.beta, g.g, g.c, g.delta, g.delta_lr, g.delta_rr,
                   lmn, lmx)
        a, v, vp, basis = d["a"], g.lz.v, g.lz.v_prev, st.basis
        one = torch.ones((), dtype=a.dtype, device=self.dev)
        zero = torch.zeros((), dtype=a.dtype, device=self.dev)
        n = a.shape[0]

        # K1 at 64 lanes twice: on materialised operands (the lanes of the
        # state above with the interval as (64,) vectors, as K1's line read
        # them before it took the solver's), and on the solver's own
        # operands (recorded at the third step of a 'pallas' solve; the
        # interval 0-d, read at stride 0), whose line it is; then on the
        # solver's operands at 4177 lanes.
        # A kernel of 2 us is timed three ways, beside the same readings of
        # an empty launch (the floor): the profiler's device time a launch,
        # a CUDA-graph replay, and calls back to back
        floor = {"per_launch_ms": per_launch_ms(gu.empty_launch, reps=20)[
                     "empty_kernel"],
                 "graph_ms": graph_ms(gu.empty_launch),
                 "wrapper_ms": cuda_ms(gu.empty_launch)}
        solver_in = self.k1_operands(d["u"])
        assert solver_in[8].ndim == 0 and solver_in[9].ndim == 0
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 11)
        wide_in = self.k1_operands(torch.randn(
            (n, n), generator=gen, dtype=a.dtype, device=self.dev))
        for what, k1_in in (
                ("materialised", (g.lz.alpha, g.lz.beta, g.lz.beta_prev,
                                  g.g, g.c, g.delta, g.delta_lr,
                                  g.delta_rr, lmn, lmx)),
                ("solver", solver_in), (f"solver, {n} lanes", wide_in)):
            got = ops.gql_update(*k1_in)
            want = gu.gql_update_plain(*k1_in)
            lanes = got[0].numel()
            nb = nbytes(*k1_in) + nbytes(*got)
            bms, bby = bound(nb, 55 * lanes, torch.float64)

            def k1():
                return ops.gql_update(*k1_in)

            launch = per_launch_ms(k1, reps=20)
            ms = launch["gql_update_kernel"]
            line = dict(operands=what, lanes=lanes, per_launch_ms=launch,
                        graph_ms=graph_ms(k1), wrapper_ms=cuda_ms(k1),
                        empty_launch=floor)
            if what == "solver":
                self._kernel_line(
                    "gql_update", "src/repro_torch/kernels/csrc/gql_update.cu",
                    "src/repro/kernels/gql_update.py:76", got, want, 1e-12,
                    "f64; FMA contraction and operation order only", ms,
                    cuda_ms(lambda: gu.gql_update_plain(*k1_in)), bms, bby,
                    None, k1, extra=line)
                assert self.kernels_per_call["gql_update"] == 1, \
                    "K1 on the solver's operands is not one kernel a call"
                # the 0-d interval and its materialised copy: the same bits
                full = k1_in[:8] + tuple(x.expand(lanes).contiguous()
                                         for x in k1_in[8:])
                assert all(torch.equal(x, y) for x, y in zip(
                    got, ops.gql_update(*full))), \
                    "K1: the 0-d interval and its materialised copy differ"
            else:
                abs_err, rel_err = errors(got, want)
                emit({"phase": "kernels", "name": f"gql_update[{what}]",
                      "max_abs_err": abs_err, "max_rel_err": rel_err,
                      "tolerance": 1e-12, "kernel_ms": ms, "bound_ms": bms,
                      "cuda_kernels_per_call": sum(
                          c for _, c in device_kernels(k1).values()),
                      **line})
                assert rel_err <= 1e-12, f"K1 {what}: rel err {rel_err}"
        del wide_in

        # K3 with the banked basis (the fused solve_batch path), at step 3
        # with all M = 161 rows read (no live-row count: PR 13's line)
        args = (a, one, one, zero, v, vp, scalars, basis)
        got = flatten_out(ops.fused_step_dense(*args, shared_a=True))
        want = flatten_out(ls.fused_step_dense_plain(*args, shared_a=True))
        m = basis.shape[1]
        nb = nbytes(a, v, vp, basis, *scalars) + nbytes(*got)
        flops = 2 * K * n * n + 4 * K * m * n + 10 * K * n
        bms, bby = bound(nb, flops, torch.float64)
        xs = v.clone()
        k3_parts = per_launch_ms(lambda: ops.fused_step_dense(
            *args, shared_a=True))
        matmul_ms = cuda_ms(lambda: torch.matmul(xs, a.T))
        self._kernel_line(
            "fused_step_dense", "src/repro_torch/kernels/csrc/dense_step.cu",
            "src/repro/kernels/lanczos_step.py:135", got, want, 1e-12,
            "f64; summation order over N = 4177 and the basis, FMA",
            cuda_ms(lambda: ops.fused_step_dense(*args, shared_a=True)),
            cuda_ms(lambda: ls.fused_step_dense_plain(*args, shared_a=True)),
            bms, bby, matmul_ms,
            lambda: ops.fused_step_dense(*args, shared_a=True),
            "the matvec (A @ x for 64 lanes, torch.matmul) only",
            extra={"basis_rows_read": m, "per_launch_ms": k3_parts,
                   "matmul_64_lanes_ms": matmul_ms})
        self.k3_mid_solve(d, a, one, zero, lmn, lmx)
        # K3 without a basis, on the masked sandwich of the argmax round
        masks, um, _, _ = self.argmax_problem()
        base, so, si, tt = fused_operands(stack_masks(self.rt.Dense(a),
                                                      masks))
        sm = BIFSolver.create(**DENSE)
        gm = sm.step_n(sm.init_state(Masked(self.rt.Dense(a), masks), um,
                                     lam_min=d["lmn"], lam_max=d["lmx"]),
                       3).st
        msc = (gm.lz.beta, gm.g, gm.c, gm.delta, gm.delta_lr, gm.delta_rr,
               lmn, lmx)
        margs = (a, so, si, tt, gm.lz.v.contiguous(),
                 gm.lz.v_prev.contiguous(), msc, None)
        e_abs, e_rel = errors(
            flatten_out(ops.fused_step_dense(*margs, shared_a=True)),
            flatten_out(ls.fused_step_dense_plain(*margs, shared_a=True)))
        emit({"phase": "kernels", "name": "fused_step_dense[masked]",
              "max_abs_err": e_abs, "max_rel_err": e_rel,
              "tolerance": 1e-12})
        assert e_rel <= 1e-12, f"K3 masked: rel err {e_rel}"

        # ---- sparse: K2 on the lanes' f32 vectors, K4 on a state
        sp = self.sparse_problem()
        bell = sp["bell"]
        xs32 = sp["u"].to(torch.float32)
        got = [ops.bell_matvec(bell.data, bell.cols, xs32)]
        want = [sb.bell_matvec_plain(bell.data, bell.cols, xs32)]
        nr, kb, bs, _ = bell.data.shape
        # the flops this table needs: 2 per stored nonzero per lane (the
        # zeros inside the stored blocks are bytes to read, not work)
        nnz = int(torch.count_nonzero(bell.data))
        nb = nbytes(bell.data, bell.cols, xs32) + nbytes(*got)
        bms, bby = bound(nb, 2 * K * nnz, torch.float32)
        bsr32 = bsr_of(bell.data, bell.cols, torch.float32)
        xt32 = xs32.T.contiguous()
        # K2 and K4 on the shared table must take the tiled route, and give
        # the same bits on a second launch
        tiled = sb.ROUTES["tiled"]
        k2_same = torch.equal(ops.bell_matvec(bell.data, bell.cols, xs32),
                              got[0])
        assert sb.ROUTES["tiled"] == tiled + 1, "K2 not on the tiled route"
        assert k2_same, "K2: two launches differ"
        # K2's and K4's device time is below their wrappers' host work (the
        # checks, allocations and ctypes call of each launch), so launches
        # back to back time the host: their ms is the call replayed as a
        # CUDA graph, with the back-to-back time beside it
        def k2():
            return ops.bell_matvec(bell.data, bell.cols, xs32)

        self._kernel_line(
            "bell_matvec", "src/repro_torch/kernels/csrc/bell.cu",
            "src/repro/kernels/spmv_bell.py:44", got, want, 1e-5,
            "f32 accumulation (the kernel's contract) in another order",
            graph_ms(k2),
            cuda_ms(lambda: sb.bell_matvec_plain(bell.data, bell.cols,
                                                 xs32)),
            bms, bby, lambda: torch.matmul(bsr32, xt32), k2,
            "the SpMV (BSR @ dense, 64 right-hand sides)",
            extra={"route": sb.route(bell.data, bell.cols),
                   "same_bits": k2_same, "wrapper_ms": cuda_ms(k2),
                   "per_launch_ms": per_launch_ms(k2)})

        sf = BIFSolver.create(**SPARSE)
        gs = sf.step_n(sf.init_state(bell, sp["u"], lam_min=sp["lmn"],
                                     lam_max=sp["lmx"]), 3).st
        slmn = torch.full_like(gs.g, sp["lmn"])
        slmx = torch.full_like(gs.g, sp["lmx"])
        ssc = (gs.lz.beta, gs.g, gs.c, gs.delta, gs.delta_lr, gs.delta_rr,
               slmn, slmx)
        # the sandwich scalars in the vector dtype, as the main path
        # passes them
        one = torch.ones((), dtype=gs.lz.v.dtype, device=self.dev)
        zero = torch.zeros((), dtype=gs.lz.v.dtype, device=self.dev)
        bargs = (bell.data, bell.cols, one, one, zero, gs.lz.v,
                 gs.lz.v_prev, ssc)
        dmma = ls.ROUTES["bell_dmma"]
        got = flatten_out(ops.fused_step_bell(*bargs))
        want = flatten_out(ls.fused_step_bell_plain(*bargs))
        k4_same = all(torch.equal(x, y) for x, y in zip(
            flatten_out(ops.fused_step_bell(*bargs)), got))
        assert ls.ROUTES["bell_dmma"] == dmma + 2, \
            "K4 not on the tiled (FP64 tensor-core) route"
        assert k4_same, "K4: two launches differ"
        nb = nbytes(bell.data, bell.cols, gs.lz.v, gs.lz.v_prev, *ssc) \
            + nbytes(*got)
        bms, bby = bound(nb, 2 * K * nnz + 10 * K * nr * bs,
                         torch.float64)
        bsr64 = bsr_of(bell.data, bell.cols, torch.float64)
        xt64 = gs.lz.v.T.contiguous()
        sms = torch.cuda.get_device_properties(
            self.dev).multi_processor_count
        def k4():
            return ops.fused_step_bell(*bargs)

        self._kernel_line(
            "fused_step_bell", "src/repro_torch/kernels/csrc/bell.cu",
            "src/repro/kernels/lanczos_step.py:235", got, want, 1e-12,
            "f64 vectors, f32 data cast to f64; summation order, FMA",
            graph_ms(k4),
            cuda_ms(lambda: ls.fused_step_bell_plain(*bargs)), bms, bby,
            lambda: torch.matmul(bsr64, xt64), k4,
            "the SpMV (BSR @ dense in f64, 64 right-hand sides)",
            extra={"route": sb.route(bell.data, bell.cols),
                   "splits": ls.bell_splits(K, nr, bs, kb, sms),
                   "same_bits": k4_same, "wrapper_ms": cuda_ms(k4),
                   "per_launch_ms": per_launch_ms(k4)})
        self._k4_rows_line()
        # K5 on the block path's operands: the shared table and 64 block
        # lanes of 8 probe rows (f64, as the block recurrence hands them
        # over; the wrapper rounds them to f32 once)
        tp = self.trace_problem()
        xb = (tp["z"] / bell.n ** 0.5).reshape(PROBES // BLOCK, BLOCK, -1)
        got = [ops.bell_matvec_mrhs(bell.data, bell.cols, xb)]
        want = [sb.bell_matvec_mrhs_plain(bell.data, bell.cols, xb)]
        nb = nbytes(bell.data, bell.cols, xb) + nbytes(*got)
        bms, bby = bound(nb, 2 * PROBES * nnz, torch.float32)
        xt5 = xb.reshape(PROBES, -1).to(torch.float32).T.contiguous()

        def k5():
            return ops.bell_matvec_mrhs(bell.data, bell.cols, xb)

        # the trace path's table takes the 3xTF32 route, with the same bits
        # on a second launch
        k5_route = sb.mrhs_route(bell.data, bell.cols)
        wg_before = sb.MRHS_ROUTES["wgmma"]
        k5_same = torch.equal(k5(), got[0])
        assert k5_route == "wgmma" and sb.MRHS_ROUTES["wgmma"] == \
            wg_before + 1, "K5 not on the wgmma route"
        assert k5_same, "K5: two launches differ"
        k5_ms = graph_ms(k5)
        self._kernel_line(
            "bell_matvec_mrhs", "src/repro_torch/kernels/csrc/bell_mrhs.cu",
            "src/repro/kernels/spmv_bell.py:73", got, want, 1e-5,
            "f32 accumulation (the kernel's contract) on the tensor cores "
            "(3xTF32, about 2^-21 a product) in another order", k5_ms,
            cuda_ms(lambda: sb.bell_matvec_mrhs_plain(bell.data, bell.cols,
                                                      xb)),
            bms, bby, lambda: torch.matmul(bsr32, xt5), k5,
            "the SpMM (BSR @ dense, f32, 512 right-hand sides)",
            extra={"route": k5_route, "same_bits": k5_same,
                   "wrapper_ms": cuda_ms(k5),
                   "per_launch_ms": per_launch_ms(k5),
                   # the tensor cores' work: the dense blocks' products, 3
                   # tf32 products each (3xTF32)
                   # the tensor cores' rate: every block's dense product,
                   # three tf32 products each (3xTF32)
                   "tf32_tflops": 3 * 2 * PROBES * nr * kb * bs * bs
                   / k5_ms / 1e9})

        # K6 on the bilinear path's operands: the 16 f32 systems and the
        # f64 query lanes (the Lanczos vectors it is handed are f64; it
        # rounds them to f32 as it reads them)
        from repro_torch.kernels import bilinear_matvec as bm
        bp = self.bilinear_problem()
        a32, xq = bp["a32"], bp["u"] / bp["u"].norm(dim=-1, keepdim=True)
        got = list(ops.fused_matvec(a32, xq))
        want = list(bm.fused_matvec_plain(a32, xq))
        nsys, n6 = xq.shape
        nb = nbytes(a32, xq) + nbytes(*got)
        bms, bby = bound(nb, 2 * nsys * n6 * n6 + 2 * nsys * n6,
                         torch.float32)
        xq32 = xq.to(torch.float32)

        def bmm_dot():
            y = torch.bmm(a32, xq32[:, :, None])[:, :, 0]
            return y, torch.sum(xq32 * y, dim=-1)

        def k6():
            return ops.fused_matvec(a32, xq)

        k6_same = all(torch.equal(u, w) for u, w in zip(k6(), got))
        assert k6_same, "K6: two launches differ"
        k6_ms = graph_ms(k6)
        self._kernel_line(
            "fused_matvec", "src/repro_torch/kernels/csrc/bilinear_matvec.cu",
            "src/repro/kernels/bilinear_matvec.py:58", got, want, 1e-5,
            "f32 accumulation (the kernel's contract) in another order",
            k6_ms, cuda_ms(lambda: bm.fused_matvec_plain(a32, xq)), bms, bby,
            bmm_dot, k6,
            "torch.bmm for y and a dot product for alpha (f32 x)",
            extra={"same_bits": k6_same, "wrapper_ms": cuda_ms(k6),
                   "per_launch_ms": per_launch_ms(k6),
                   # A's bytes over the graph replay's time
                   "a_tb_per_s": nbytes(a32) / k6_ms / 1e9})
        assert self.kernels_per_call["fused_matvec"] == 1, \
            "K6 is more than one device kernel a call"

        # K7 on the attention path's prefill: q (1, 4096, 128, 128), k and
        # v (1, 4096, 8, 128) in bf16, causal; the plain version runs in
        # chunks of 16 heads
        ap = self.attention_problem()
        q, k, v = ap["q"], ap["k"], ap["v"]
        got = [ops.mha_flash(q, k, v, causal=True)]
        want = [mha_plain(q, k, v, True)]
        flops = 4 * HEADS * HEAD_DIM * causal_pairs(TOKENS, TOKENS)
        bms, bby = bound(nbytes(q, k, v) + nbytes(*got), flops,
                         torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        k7_ms = cuda_ms(lambda: ops.mha_flash(q, k, v, causal=True), reps=5,
                        warmup=1)
        from repro_torch.kernels import flash_attention as fa

        self._kernel_line(
            "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:67", got, want,
            ATTN_TOL[torch.bfloat16],
            "bf16 inputs and output, f32 accumulation in another order; "
            "per (head, query row)",
            k7_ms,
            cuda_ms(lambda: mha_plain(q, k, v, True), reps=3, warmup=1),
            bms, bby, cuda_ms(lambda: sdpa_gqa(qt, kt, vt), reps=5,
                              warmup=1),
            lambda: ops.mha_flash(q, k, v, causal=True),
            "F.scaled_dot_product_attention, causal, on the same bf16 "
            "tensors with the kv heads shared (enable_gqa)", row_errors,
            extra={"route": fa.route(q.dtype, HEAD_DIM, TOKENS),
                   "tflops": flops / k7_ms / 1e9})
        emit({"phase": "kernels", "ported": sorted(self.kernels)})
        assert sorted(self.kernels) == sorted(KERNELS)

    def k1_operands(self, u):
        """The operands the 'pallas' solver passes K1 at the third step of
        a solve of the dense problem over the lanes ``u`` (recorded at
        ``ops.gql_update``): the lanes (B,), the interval 0-d. The solver
        is capped just past that step: the first steps, and so the
        operands, are the same as under the dense phase's cap (bit-equal
        on the CPU), and no state is sized for the 160 steps it never
        takes."""
        from repro_torch.core import BIFSolver
        from repro_torch.kernels import ops
        d = self.dense_problem()
        seen, launch = [], ops.gql_update
        ops.gql_update = lambda *args: seen.append(args) or launch(*args)
        try:
            s = BIFSolver.create(max_iters=4, rtol=DENSE["rtol"],
                                 backend="pallas")
            s.step_n(s.init_state(self.rt.Dense(d["a"]), u, lam_min=d["lmn"],
                                  lam_max=d["lmx"]), 3)
        finally:
            ops.gql_update = launch
        return seen[-1]

    def k3_mid_solve(self, d, a, one, zero, lmn, lmx):
        """K3 as the fused solve calls it mid-solve: the state after 56
        steps, with the live-row count min(56 + 2, M) = 58, against the
        plain version over all M rows (the rows past the count are zeros);
        its bound counts the live rows only."""
        from repro_torch.core import BIFSolver
        from repro_torch.kernels import lanczos_step as ls
        from repro_torch.kernels import ops
        s = BIFSolver.create(**DENSE, reorth=True)
        st = s.step_n(s.init_state(self.rt.Dense(d["a"]), d["u"],
                                   lam_min=d["lmn"], lam_max=d["lmx"]), 56)
        g = st.st
        rows = torch.clamp(st.step + 2, max=st.basis.shape[-2]).to(
            torch.int32)
        live = int(rows)
        basis = st.basis
        assert int(st.step) == 56 and live == 58
        assert int(torch.count_nonzero(basis[:, live:])) == 0
        scalars = (g.lz.beta, g.g, g.c, g.delta, g.delta_lr, g.delta_rr,
                   lmn, lmx)
        args = (a, one, one, zero, g.lz.v, g.lz.v_prev, scalars, basis)
        got = flatten_out(ops.fused_step_dense(*args, shared_a=True,
                                               rows=rows))
        want = flatten_out(ls.fused_step_dense_plain(*args, shared_a=True))
        e_abs, e_rel = errors(got, want)
        n = a.shape[0]
        nb = nbytes(a, g.lz.v, g.lz.v_prev, *scalars) \
            + 8 * K * live * n + nbytes(*got)
        bms, bby = bound(nb, 2 * K * n * n + 4 * K * live * n + 10 * K * n,
                         torch.float64)
        emit({"phase": "kernels", "name": "fused_step_dense[mid-solve]",
              "step": int(st.step), "live_rows": live,
              "basis_rows": int(basis.shape[1]),
              "max_abs_err": e_abs, "max_rel_err": e_rel,
              "tolerance": 1e-12,
              "kernel_ms": cuda_ms(lambda: ops.fused_step_dense(
                  *args, shared_a=True, rows=rows)),
              "plain_ms": cuda_ms(lambda: ls.fused_step_dense_plain(
                  *args, shared_a=True)),
              "bound_ms": bms, "bound_by": bby,
              "per_launch_ms": per_launch_ms(lambda: ops.fused_step_dense(
                  *args, shared_a=True, rows=rows))})
        assert e_rel <= 1e-12, f"K3 mid-solve: rel err {e_rel}"

    def argmax_problem(self):
        """A greedy-MAP scoring round: selected set Y (512 random items),
        64 candidates i, score_i = A_ii - A_{iY} A_Y^-1 A_{Yi}.

        A candidate beyond the RBF cutoff of every item of Y has u = 0 and
        the exact score A_ii, and near-ties of such candidates resolve at
        the first iteration, which would leave the masked K3 path idle.
        So the candidates are drawn from the items that Y explains (score
        below half of A_ii): the best of them, and the 63 next best that
        trail it by at least 0.3%, in a seeded order."""
        d = self.dense_problem()
        a = d["a"]
        n = a.shape[0]
        perm = np.random.default_rng(SEED + 3).permutation(n)
        si = torch.as_tensor(perm[:512], device=self.dev)
        pool = torch.as_tensor(perm[512:], device=self.dev)
        uy = a[si][:, pool]                                  # (|Y|, pool)
        diag = a[pool, pool]
        score = diag - torch.sum(uy * torch.linalg.solve(a[si][:, si], uy),
                                 dim=0)
        score = torch.where(score < 0.5 * diag, score,
                            torch.full_like(score, -1.0))
        order = torch.argsort(score, descending=True)
        top = score[order[0]]
        rest = order[1:][(score[order[1:]] <= top - 0.003 * top.abs())
                         & (score[order[1:]] > 0)][:K - 1]
        assert rest.numel() == K - 1, f"only {rest.numel()} rivals"
        pick = torch.cat([order[:1], rest])[torch.as_tensor(
            np.random.default_rng(SEED + 6).permutation(K),
            device=self.dev)]
        ci = pool[pick]
        mask = torch.zeros(n, dtype=a.dtype, device=self.dev)
        mask[si] = 1.0
        masks = mask.expand(K, n).contiguous()
        um = a[:, ci].T * mask
        return masks, um, a[ci, ci], score[pick]

    def _compare(self, what, got, ref, truth, slack, cap=None):
        """Hold a kernel-backend run against the reference-backend run and
        the truth; returns the line's numbers. With ``cap`` (a solve's
        max_iters), every lane of both runs must certify its bracket
        before the cap."""
        it_g, it_r = got.iterations, ref.iterations
        diff = (it_g.long() - it_r.long()).abs()
        lo = got.lower
        hi = got.upper
        ok_truth = contains(lo, hi, truth, slack)
        out = {"lanes": int(it_g.numel()),
               "iterations_max": int(it_g.max()),
               "iterations_mean": float(it_g.double().mean()),
               "lanes_iter_diff": int((diff > 0).sum()),
               "max_iter_diff": int(diff.max()),
               "brackets_contain_truth": ok_truth,
               "max_rel_gap": float(((hi - lo) / truth.abs()).max()),
               # how far the bracket lies outside the truth (< 0: inside)
               "max_rel_miss": float((torch.maximum(lo - truth, truth - hi)
                                      / truth.abs()).max()),
               "slack": slack}
        if cap is not None:
            out.update(max_iters=cap, certified=int(got.certified.sum()),
                       reference_certified=int(ref.certified.sum()),
                       reference_iterations_mean=float(
                           it_r.double().mean()))
        assert ok_truth, f"{what}: bracket misses the truth"
        assert int(diff.max()) <= 1, f"{what}: iterations differ by >1"
        if cap is not None:
            lanes = int(it_g.numel())
            assert out["certified"] == lanes, f"{what}: uncertified lanes"
            assert out["reference_certified"] == lanes, \
                f"{what}: uncertified reference lanes"
            assert out["iterations_max"] < cap, f"{what}: ran to the cap"
        return out

    def path_call(self, fn):
        """One call of the main path, timed; records how many iterations
        it ran (its longest lane's; an attention call counts as one) and
        how many times it launched each kernel."""
        from repro_torch.kernels import LAUNCHES
        before = dict(LAUNCHES)
        out, seconds = self.run_timed(fn)
        self.path_calls.append((iterations_of(out), {
            k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        return out, seconds

    def per_iteration(self, name) -> float:
        """Launches of kernel ``name`` per solver iteration, over the path
        calls that launched it."""
        calls = [(it, d[name]) for it, d in self.path_calls if d[name] > 0]
        return (sum(c for _, c in calls) / sum(it for it, _ in calls)
                if calls else 0.0)

    def run_timed(self, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def phase_dense(self):
        from repro_torch.core import BIFSolver, Dense, stack_masks
        from repro_torch.kernels import LAUNCHES, reset_launches
        d = self.dense_problem()
        a, u = d["a"], d["u"]
        op = Dense(a)
        iv = dict(lam_min=d["lmn"], lam_max=d["lmx"])
        truth = torch.sum(u * torch.linalg.solve(a, u.T).T, dim=-1)
        masks, um, shift, score = self.argmax_problem()
        mop = stack_masks(op, masks)
        rng = np.random.default_rng(SEED + 4)
        delta = rng.uniform(0.05, 0.5, K) * rng.choice([-1.0, 1.0], K)
        t = truth * (1.0 + torch.as_tensor(delta, device=self.dev))

        def cfg(backend, **kw):
            return BIFSolver.create(**DENSE, backend=backend, **kw)

        from repro_torch.kernels.lanczos_step import ROUTES as K3_ROUTES
        reset_launches()
        solve_f, t_solve = self.path_call(lambda: cfg(
            "fused", reorth=True).solve_batch(op, u, **iv))
        k3_before = LAUNCHES["fused_step_dense"]
        k3_live = K3_ROUTES["live_rows"]
        arg_f, t_arg = self.path_call(lambda: cfg("fused").judge_argmax(
            mop, um, shift=shift, scale=-1.0, **iv))
        k3_masked = LAUNCHES["fused_step_dense"] - k3_before
        judge_p, t_judge = self.path_call(lambda: cfg("pallas").judge_batch(
            op, u, t, **iv))
        launches = dict(LAUNCHES)

        solve_r, t_solve_r = self.run_timed(lambda: cfg(
            "reference", reorth=True).solve_batch(op, u, **iv))
        arg_r, t_arg_r = self.run_timed(lambda: cfg(
            "reference").judge_argmax(mop, um, shift=shift, scale=-1.0, **iv))
        judge_r, t_judge_r = self.run_timed(lambda: cfg(
            "reference").judge_batch(op, u, t, **iv))

        slack = 1e-9  # f64 roundoff on brackets converged to ~1e-6
        line = {"phase": "dense", "n": int(a.shape[0]), "lanes": K,
                "lambda": d["lam"],
                "solve_batch_fused": self._compare(
                    "solve_batch fused", solve_f, solve_r, truth, slack,
                    cap=DENSE["max_iters"]),
                "judge_argmax_fused": self._compare(
                    "judge_argmax fused", arg_f, arg_r, score, slack),
                "judge_batch_pallas": {
                    "decisions_equal": bool(torch.equal(judge_p.decision,
                                                        judge_r.decision)),
                    "certified": int(judge_p.certified.sum()),
                    "decisions_true": bool(torch.all(
                        judge_p.decision[judge_p.certified]
                        == (t < truth)[judge_p.certified])),
                    "max_iter_diff": int((judge_p.iterations.long()
                                          - judge_r.iterations.long())
                                         .abs().max())},
                "argmax": {"index": int(arg_f.index),
                           "reference_index": int(arg_r.index),
                           "certified": bool(arg_f.certified),
                           "truth_index": int(torch.argmax(score)),
                           "masked_k3_launches": k3_masked},
                # K3 launches of the reorth solve that read only the live
                # basis rows (the count passed on the card)
                "k3_live_row_launches": k3_live,
                "k3_routes": dict(K3_ROUTES),
                "seconds": {"solve_batch_fused": t_solve,
                            "solve_batch_reference": t_solve_r,
                            "judge_argmax_fused": t_arg,
                            "judge_argmax_reference": t_arg_r,
                            "judge_batch_pallas": t_judge,
                            "judge_batch_reference": t_judge_r},
                "launches": launches}
        emit(line)
        assert torch.equal(solve_f.certified, solve_r.certified)
        assert torch.equal(arg_f.certified, arg_r.certified)
        assert int(arg_f.index) == int(arg_r.index), "argmax index differs"
        if bool(arg_f.certified):
            assert int(arg_f.index) == int(torch.argmax(score))
        jl = line["judge_batch_pallas"]
        assert jl["decisions_equal"] and jl["decisions_true"]
        assert jl["max_iter_diff"] <= 1
        assert torch.equal(judge_p.certified, judge_r.certified)
        assert launches["fused_step_dense"] > 0 and launches["gql_update"] > 0
        assert k3_masked > 0, "the argmax round did not reach K3"
        assert k3_live == k3_before > 0, \
            "the reorth solve did not pass its live-row count to K3"
        assert K3_ROUTES["dmma"] == launches["fused_step_dense"]
        self._count(launches)

    def phase_sparse(self):
        from repro_torch.core import BIFSolver
        from repro_torch.kernels import LAUNCHES, reset_launches
        sp = self.sparse_problem()
        bell, u = sp["bell"], sp["u"]
        iv = dict(lam_min=sp["lmn"], lam_max=sp["lmx"])
        truth = torch.sum(u * torch.linalg.solve(sp["a32"], u.T).T, dim=-1)
        rng = np.random.default_rng(SEED + 5)
        delta = rng.uniform(0.05, 0.5, K) * rng.choice([-1.0, 1.0], K)
        t = truth * (1.0 + torch.as_tensor(delta, device=self.dev))

        def cfg(backend):
            return BIFSolver.create(**SPARSE, backend=backend)

        reset_launches()
        solve_f, t_f = self.path_call(lambda: cfg("fused").solve_batch(
            bell, u, **iv))
        solve_p, t_p = self.path_call(lambda: cfg("pallas").solve_batch(
            bell, u, **iv))
        judge_f, t_j = self.path_call(lambda: cfg("fused").judge_batch(
            bell, u, t, **iv))
        launches = dict(LAUNCHES)
        routes = bell_routes()
        solve_r, t_r = self.run_timed(lambda: cfg("reference").solve_batch(
            bell, u, **iv))
        judge_r, t_jr = self.run_timed(lambda: cfg("reference").judge_batch(
            bell, u, t, **iv))

        line = {"phase": "sparse", "n": int(bell.n), "lanes": K,
                "bell": list(bell.data.shape), "lambda": sp["lam"],
                "solve_batch_fused": self._compare(
                    "solve_batch fused", solve_f, solve_r, truth, 1e-9,
                    cap=SPARSE["max_iters"]),
                # K2 accumulates in f32 (its contract): its bracket is
                # that of a matvec perturbed at f32 roundoff, which moves
                # u^T A^-1 u by up to about kappa * 2^-24 relative, kappa
                # that of the interval [lam_min, lam_max]
                "solve_batch_pallas": self._compare(
                    "solve_batch pallas", solve_p, solve_r, truth,
                    sp["lmx"] / sp["lmn"] * 2.0 ** -24,
                    cap=SPARSE["max_iters"]),
                "judge_batch_fused": {
                    "decisions_equal": bool(torch.equal(judge_f.decision,
                                                        judge_r.decision)),
                    "certified": int(judge_f.certified.sum()),
                    "max_iter_diff": int((judge_f.iterations.long()
                                          - judge_r.iterations.long())
                                         .abs().max())},
                "seconds": {"solve_batch_fused": t_f,
                            "solve_batch_pallas": t_p,
                            "solve_batch_reference": t_r,
                            "judge_batch_fused": t_j,
                            "judge_batch_reference": t_jr},
                "launches": launches, "bell_routes": routes}
        emit(line)
        assert_tiled(launches, routes)
        assert torch.equal(solve_f.certified, solve_r.certified)
        assert torch.equal(solve_p.certified, solve_r.certified)
        jl = line["judge_batch_fused"]
        assert jl["decisions_equal"] and jl["max_iter_diff"] <= 1
        assert launches["fused_step_bell"] > 0
        assert launches["bell_matvec"] > 0 and launches["gql_update"] > 0
        self._count(launches)

    def phase_trace(self):
        """Bracketed logdet of the sparse operator, the block-Krylov path:
        512 probes as 64 block lanes of 8 on 'pallas' (K5 once at init and
        once per block step, for all lanes together) and on 'reference'
        (f64 SpMM), then 64 scalar probes on 'fused' (K4 and the
        matrix-function eigensolve). Every lane certifies before its cap,
        and every lane's bracket holds its truth."""
        from repro_torch.core import BIFSolver, logdet_quad
        from repro_torch.kernels import LAUNCHES, reset_launches
        tp = self.trace_problem()
        op = tp["trace_op"]
        iv = dict(lam_min=tp["lmn"], lam_max=tp["lmx"], key=SEED)
        lanes = PROBES // BLOCK
        block_truth = tp["probe_truth"].reshape(lanes, BLOCK).sum(-1).cpu()
        scalar_truth = tp["probe_truth"][:SCALAR_PROBES].cpu()

        def block(backend):
            return lambda: logdet_quad(
                op, PROBES, block_size=BLOCK, solver=BIFSolver.create(
                    backend=backend, **TRACE_BLOCK), **iv)

        from repro_torch.kernels import spmv_bell as sb
        reset_launches()
        res_p, t_p = self.path_call(block("pallas"))
        k5 = LAUNCHES["bell_matvec_mrhs"]
        k5_routes = dict(sb.MRHS_ROUTES)
        res_f, t_f = self.path_call(lambda: logdet_quad(
            op, SCALAR_PROBES, block_size=1, solver=BIFSolver.create(
                backend="fused", **TRACE_SCALAR), **iv))
        launches = dict(LAUNCHES)
        routes = bell_routes()
        res_r, t_r = self.run_timed(block("reference"))

        # Slack of the f32 SpMM (K5's contract): the bracket is that of
        # the operator perturbed at f32 roundoff, E with |E| <= 2^-24 |A|
        # (relative, per product). The Frechet derivative of log has norm
        # 1/lambda_min, so z^T log(A) z moves by at most |z|^2 2^-24
        # lambda_max / lambda_min, which relative to |z^T log(A) z|
        # (|z|^2 times a mean log eigenvalue above 1 here) is below
        # kappa * 2^-24, kappa that of [lam_min, lam_max]. The two
        # backends' certified brackets then differ by at most their width
        # (rtol) plus that slack.
        kappa = tp["lmx"] / tp["lmn"]
        f32_slack = kappa * 2.0 ** -24

        def lane_view(res, truth, slack, cap, what):
            lo = torch.as_tensor(res.state.probe_lower)
            hi = torch.as_tensor(res.state.probe_upper)
            it = torch.as_tensor(res.state.iterations)
            cert = (hi - lo) <= cap["rtol"] * lo.abs()
            miss = torch.maximum(lo - truth, truth - hi) / truth.abs()
            se = res.std_error
            out = {"lanes": int(lo.numel()), "max_iters": cap["max_iters"],
                   "decide_every": cap["decide_every"],
                   "iterations_max": int(it.max()),
                   "iterations_mean": float(it.double().mean()),
                   "certified": int(cert.sum()),
                   "brackets_contain_truth": contains(lo, hi, truth, slack),
                   "max_rel_gap": float(((hi - lo) / truth.abs()).max()),
                   "max_rel_miss": float(miss.max()), "slack": slack,
                   "estimate": res.estimate, "std_error": se,
                   "bracket": [res.lower, res.upper],
                   "logdet": tp["logdet"],
                   "abs_err_over_se": abs(res.estimate - tp["logdet"]) / se}
            assert out["brackets_contain_truth"], f"{what}: bracket misses"
            assert out["certified"] == out["lanes"], f"{what}: uncertified"
            assert out["iterations_max"] < cap["max_iters"], \
                f"{what}: ran to the cap"
            return out, lo, hi, it

        line_p, lo_p, hi_p, it_p = lane_view(res_p, block_truth, f32_slack,
                                             TRACE_BLOCK, "block pallas")
        line_r, lo_r, hi_r, it_r = lane_view(res_r, block_truth, 1e-9,
                                             TRACE_BLOCK, "block reference")
        line_f, _, _, _ = lane_view(res_f, scalar_truth, 1e-9, TRACE_SCALAR,
                                    "scalar fused")
        cmp_slack = TRACE_BLOCK["rtol"] + f32_slack
        diff = torch.maximum((lo_p - lo_r).abs(), (hi_p - hi_r).abs()) \
            / block_truth.abs()
        line_p.update(
            k5_launches=k5, steps=int(it_p.max()) - 1,
            vs_reference={"max_rel_bracket_diff": float(diff.max()),
                          "slack": cmp_slack,
                          "max_iter_diff": int((it_p - it_r).abs().max())})
        emit({"phase": "trace", "n": int(op.n), "probes": PROBES,
              "block_size": BLOCK, "lambda": tp["lam"],
              "block_pallas": line_p, "block_reference": line_r,
              "scalar_fused": line_f,
              "seconds": {"block_pallas": t_p, "block_reference": t_r,
                          "scalar_fused": t_f},
              "launches": launches, "bell_routes": routes,
              "k5_routes": k5_routes})
        assert_tiled(launches, routes)
        assert k5_routes["wgmma"] == k5, f"K5 off the wgmma route: {k5_routes}"
        # K5: once at block_init, then once per block step of the driver;
        # every lane certifies before the cap, so the longest lane steps
        # in every round and the steps are its iterations less one
        assert k5 == 1 + line_p["steps"], f"K5 launched {k5} times"
        assert float(diff.max()) <= cmp_slack, "backends' brackets differ"
        assert launches["fused_step_bell"] > 0
        self._count(launches)

    def phase_bilinear(self):
        """The K6 path: 16 independent systems as lanes of one batched
        solve, the matvec a MatvecFn over fused_matvec (K6 once per
        iteration for all lanes) with K1 on 'pallas'; the same f32
        matrices as a Dense operator on 'reference' (computed in f64, as
        the reference's einsum promotes). Every lane of both certifies
        before the cap, decisions and certification agree, iteration
        counts differ by at most 1, and every bracket holds its truth."""
        from repro_torch.core import BIFSolver, Dense
        from repro_torch.kernels import LAUNCHES, reset_launches
        bp = self.bilinear_problem()
        u, truth = bp["u"], bp["truth"]
        iv = dict(lam_min=bp["lmn"], lam_max=bp["lmx"])
        rng = np.random.default_rng(SEED + 9)
        delta = rng.uniform(0.05, 0.5, SYSTEMS) \
            * rng.choice([-1.0, 1.0], SYSTEMS)
        t = truth * (1.0 + torch.as_tensor(delta, device=self.dev))
        dense = Dense(bp["a32"])

        def cfg(backend):
            return BIFSolver.create(**BILINEAR, backend=backend)

        reset_launches()
        solve_p, t_sp = self.path_call(lambda: cfg("pallas").solve_batch(
            bp["op"], u, **iv))
        k6_solve = LAUNCHES["fused_matvec"]
        judge_p, t_jp = self.path_call(lambda: cfg("pallas").judge_batch(
            bp["op"], u, t, **iv))
        k6_judge = LAUNCHES["fused_matvec"] - k6_solve
        launches = dict(LAUNCHES)
        solve_r, t_sr = self.run_timed(lambda: cfg("reference").solve_batch(
            dense, u, **iv))
        judge_r, t_jr = self.run_timed(lambda: cfg("reference").judge_batch(
            dense, u, t, **iv))

        # K6 accumulates in f32 (its contract): the bracket is that of an
        # operator perturbed at f32 roundoff, which moves u^T A^-1 u by up
        # to about kappa * 2^-24 relative (kappa of the lane's interval),
        # the slack of the sparse phase's f32 matvec
        kappa = float((bp["lmx"] / bp["lmn"]).max())
        f32_slack = kappa * 2.0 ** -24
        line = {"phase": "bilinear", "n": int(u.shape[-1]),
                "systems": SYSTEMS, "a": list(bp["a32"].shape),
                "a_dtype": str(bp["a32"].dtype).replace("torch.", ""),
                "ridge_sweep": [float(bp["lam"][0]), float(bp["lam"][-1])],
                "kappa_max": kappa,
                "solve_batch_pallas": self._compare(
                    "solve_batch pallas", solve_p, solve_r, truth,
                    f32_slack, cap=BILINEAR["max_iters"]),
                "solve_batch_reference_contains_truth": contains(
                    solve_r.lower, solve_r.upper, truth, 1e-9),
                "judge_batch_pallas": {
                    "decisions_equal": bool(torch.equal(judge_p.decision,
                                                        judge_r.decision)),
                    "certified": int(judge_p.certified.sum()),
                    "reference_certified": int(judge_r.certified.sum()),
                    "decisions_true": bool(torch.all(
                        judge_p.decision == (t < truth))),
                    "iterations_max": int(judge_p.iterations.max()),
                    "max_iter_diff": int((judge_p.iterations.long()
                                          - judge_r.iterations.long())
                                         .abs().max())},
                # K6 once at init, then once per step of the longest lane
                "k6_launches": {"solve_batch": k6_solve,
                                "judge_batch": k6_judge},
                "seconds": {"solve_batch_pallas": t_sp,
                            "solve_batch_reference": t_sr,
                            "judge_batch_pallas": t_jp,
                            "judge_batch_reference": t_jr},
                "launches": launches}
        emit(line)
        assert line["solve_batch_reference_contains_truth"]
        assert torch.equal(solve_p.certified, solve_r.certified)
        jl = line["judge_batch_pallas"]
        assert jl["decisions_equal"] and jl["decisions_true"]
        assert jl["certified"] == jl["reference_certified"] == SYSTEMS
        assert jl["max_iter_diff"] <= 1
        assert k6_solve == int(solve_p.iterations.max()), \
            f"K6 launched {k6_solve} times in solve_batch"
        assert k6_judge == jl["iterations_max"], \
            f"K6 launched {k6_judge} times in judge_batch"
        assert launches["gql_update"] > 0
        self._count(launches)

    def phase_apps(self):
        """The paper's applications through their entry points: each run
        on 'pallas' (K1, one or two lanes a judge; 4177 lanes a greedy
        round), on 'fused' (K3), and against the exact scorers (dense
        solves), and the chains also incrementally (the Cholesky factor of
        L_Y carried across moves). Every way must make the same decisions,
        and certify every one."""
        from repro_torch.core import BIFSolver, Dense, dpp, greedy_map, \
            run_double_greedy, update
        from repro_torch.kernels import LAUNCHES, reset_launches
        ap, d = self.apps_problem(), self.dense_problem()
        op = Dense(d["a"])
        iv = (d["lmn"], d["lmx"])
        init = ap["init"]
        count = int(init.sum())
        seconds, line = {}, {"phase": "apps", "n": op.n,
                             "initial_items": count}

        def timed(what, fn):
            before = dict(LAUNCHES)
            out, seconds[what] = self.run_timed(fn)
            return out, {k: LAUNCHES[k] - before[k] for k in
                         ("gql_update", "fused_step_dense")}

        def cfg(backend):
            return dict(max_iters=APPS["max_iters"],
                        solver=BIFSolver.create(**APPS, backend=backend))

        reset_launches()
        for kind, step, draws, cap in (
                ("dpp", dpp.dpp_step, ap["dpp_draws"], count + CHAIN_STEPS),
                ("kdpp", dpp.kdpp_step, ap["kdpp_draws"], count)):
            factor, _ = timed(f"{kind} from_mask", lambda: update.from_mask(
                op, init, capacity=cap))
            runs = {}
            for how, kw in (("pallas", cfg("pallas")),
                            ("fused", cfg("fused")),
                            ("exact", dict(max_iters=APPS["max_iters"],
                                           exact=True)),
                            ("incremental", dict(
                                max_iters=APPS["max_iters"],
                                factor=factor))):
                st, launched = timed(f"{kind} {how}", lambda: dpp.run_chain(
                    step, op, draws, init, CHAIN_STEPS, *iv, **kw))
                runs[how] = st
                line[f"{kind}_{how}"] = {
                    "accepts": int(st.stats.accepts),
                    "items": int(st.mask.sum()),
                    "quad_iterations": int(st.stats.quad_iterations),
                    "uncertified": int(st.stats.uncertified),
                    "launches": launched}
            ref = runs["exact"]
            for how, st in runs.items():
                assert torch.equal(st.mask, ref.mask), \
                    f"{kind} {how}: the chain's mask differs from exact"
                assert int(st.stats.accepts) == int(ref.stats.accepts)
                assert int(st.stats.uncertified) == 0, f"{kind} {how}"
            f = runs["incremental"].factor
            assert sorted(f.idx[:int(f.count)].tolist()) == torch.nonzero(
                ref.mask > 0.5).flatten().tolist()
            if kind == "kdpp":
                assert int(ref.mask.sum()) == count, "k-DPP lost its k"

        greedy, g_op = {}, Dense(ap["greedy_a"])
        for how, kw in (("pallas", cfg("pallas")), ("fused", cfg("fused")),
                        ("exact", dict(max_iters=APPS["max_iters"],
                                       exact=True)),
                        ("warm_start", dict(cfg("pallas"), warm_start=True)),
                        ("incremental", dict(cfg("pallas"),
                                             incremental=True))):
            res, launched = timed(f"greedy_map {how}", lambda: greedy_map(
                g_op, GREEDY_K, *ap["greedy_iv"], **kw))
            greedy[how] = res
            line[f"greedy_map_{how}"] = {
                "certified": int(res.certified.sum()),
                "quad_iterations": int(res.quad_iterations),
                "max_rel_gain_diff_vs_exact": None, "launches": launched}
        ex = greedy["exact"]
        for how, res in greedy.items():
            assert torch.equal(res.order, ex.order), \
                f"greedy_map {how}: the order differs from exact"
            assert bool(res.certified.all()), f"greedy_map {how}"
            line[f"greedy_map_{how}"]["max_rel_gain_diff_vs_exact"] = float(
                ((res.gains - ex.gains).abs() / ex.gains.abs()).max())
        assert int(greedy["incremental"].quad_iterations) <= \
            int(greedy["warm_start"].quad_iterations)
        # rounds decided by quadrature: each race past its first bracket
        # ran its kernel (the incremental race starts from exact scores)
        for how, kernel in (("pallas", "gql_update"),
                            ("warm_start", "gql_update"),
                            ("fused", "fused_step_dense")):
            assert line[f"greedy_map_{how}"]["launches"][kernel] > 0, \
                f"greedy_map {how} never launched {kernel}"
        line["greedy_map_order"] = ex.order.tolist()

        dg_op = Dense(ap["dg_a"])
        dg = {}
        for how, kw in (("pallas", cfg("pallas")),
                        ("exact", dict(max_iters=APPS["max_iters"],
                                       exact=True))):
            res, launched = timed(f"double_greedy {how}",
                                  lambda: run_double_greedy(
                                      dg_op, ap["dg_u"], *ap["dg_iv"], **kw))
            dg[how] = res
            line[f"double_greedy_{how}"] = {
                "selected": int(res.selected.sum()),
                "quad_iterations": int(res.quad_iterations),
                "uncertified": int(res.uncertified),
                "log_det": float(res.log_det), "launches": launched}
        assert torch.equal(dg["pallas"].selected, dg["exact"].selected), \
            "double greedy: the selections differ"
        assert int(dg["pallas"].uncertified) == 0

        launches = dict(LAUNCHES)
        line.update(double_greedy_n=DG_N, seconds=seconds, launches=launches)
        emit(line)
        assert launches["gql_update"] > 0, "the apps never launched K1"
        assert launches["fused_step_dense"] > 0, "the apps never launched K3"
        self._count(launches)

    # -- the serving path ---------------------------------------------------

    def serve_problem(self, cell):
        """The requests of ``cell`` ('dense' or 'sparse'; dicts of
        BIFRequest fields, host numpy) with their truths u^T A^-1 u from
        dense f64 solves on the card, over A_Y where masked; the indices
        of the budget partials and of the expired requests; the operator
        and its interval (the dense phase's, and the blocked-ELL table
        with its diagonal in f64, so that the pool is f64)."""
        if cell not in self.serve:
            t0 = time.perf_counter()
            if cell == "dense":
                d = self.dense_problem()
                a, op = d["a"], self.rt.Dense(d["a"])
                iv, seed, expired = (d["lmn"], d["lmx"]), SEED + 11, \
                    SERVE_EXPIRED
            else:
                sp = self.trace_problem()
                a, op = sp["a32"], sp["trace_op"]
                iv, seed, expired = (sp["lmn"], sp["lmx"]), SEED + 12, 0
            n, count = a.shape[0], SERVE_REQUESTS
            rng = np.random.default_rng(seed)
            us = rng.standard_normal((count, n))
            u = torch.as_tensor(us, device=self.dev)
            truth = torch.sum(u * torch.linalg.solve(a, u.T).T, dim=-1)
            reqs = [dict(u=us[i]) for i in range(count)]
            for i in range(7, count, 8):
                keep = rng.random(n) < 1.0 / 3.0
                y = torch.as_tensor(np.nonzero(keep)[0], device=self.dev)
                uy = u[i, y]
                truth[i] = uy @ torch.linalg.solve(a[y][:, y], uy)
                reqs[i]["mask"] = keep.astype(np.float64)
            truth_h = truth.cpu().numpy()
            for i in range(count):
                if i % 4:
                    f = rng.uniform(3.0, 8.0)
                    reqs[i]["t"] = float(truth_h[i] * (f if i % 2 else
                                                       1.0 / f))
            partial = [i for i in range(0, count, 4)
                       if "mask" not in reqs[i]][:SERVE_PARTIAL]
            for i in partial:
                reqs[i]["max_iters"] = SERVE_BUDGET
            late = [i for i in range(count - 1, -1, -1)
                    if i % 4 and "mask" not in reqs[i]][:expired]
            for i in late:
                reqs[i]["deadline"] = 0.0     # long past at admission
            self.serve[cell] = dict(op=op, iv=iv, reqs=reqs, truth=truth_h,
                                    partial=partial, expired=late,
                                    n=n)
            self.setup_s[f"serve {cell} problem"] = time.perf_counter() - t0
        return self.serve[cell]

    def kv_problem(self):
        """The serve-kv keys (host f32), the 8 blocks of keys that grow
        the cache, and each block's leverage against the others,
        K_ii - 1 / (K^-1)_ii, in f64 from the f32 kernel the rankers
        solve."""
        if self.kv is None:
            from repro_torch.serve.kv_select import _rbf_kernel, pool_keys
            t0 = time.perf_counter()
            rng = np.random.default_rng(SEED + 13)
            centres = rng.standard_normal((KV_CLUSTERS, KV_DIM))
            seg = np.repeat(np.arange(KV_CLUSTERS), KV_TOKENS // KV_CLUSTERS)
            keys = (centres[seg] + KV_NOISE * rng.standard_normal(
                (KV_TOKENS, KV_DIM))).astype(np.float32)
            more = (centres[rng.integers(0, KV_CLUSTERS, KV_MORE //
                                         KV_BLOCK)].repeat(KV_BLOCK, 0)
                    + KV_NOISE * rng.standard_normal((KV_MORE, KV_DIM))
                    ).astype(np.float32)
            k = _rbf_kernel(pool_keys(keys, KV_BLOCK), 1e-3, 0.5)
            k = torch.as_tensor(k.astype(np.float32).astype(np.float64),
                                device=self.dev)
            truth = torch.diagonal(k) - 1.0 / torch.diagonal(
                torch.linalg.inv(k))
            self.kv = dict(keys=keys, more=more, truth=truth.cpu().numpy())
            self.setup_s["serve kv problem"] = time.perf_counter() - t0
        return self.kv

    def serve_run(self, cell, backend, mode="continuous", *, metrics=True,
                  log=None, budgets=True):
        """One engine over ``cell``'s requests (without the partials'
        budgets when ``budgets`` is False): submit them all, flush, then
        resubmit the budget partials with the full budget and flush again
        (continuous mode); returns the engine, the requests, the flushed
        list, the wall seconds of both flushes (submission included) and
        the launches and routes of the run."""
        from repro_torch.core import BIFSolver
        from repro_torch.kernels import LAUNCHES
        from repro_torch.kernels import lanczos_step as ls
        from repro_torch.kernels import spmv_bell as sb
        sv = self.serve_problem(cell)
        cfg = SERVE_DENSE if cell == "dense" else SERVE_SPARSE
        picked = sv["reqs"] if budgets else \
            [{k: v for k, v in r.items() if k != "max_iters"}
             for r in sv["reqs"]]
        before = (dict(LAUNCHES), dict(ls.ROUTES), dict(sb.ROUTES))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, reqs, out = serve_flow(
            sv["op"], picked, sv["partial"] if mode == "continuous" and
            budgets else (), BIFSolver.create(**cfg, backend=backend),
            sv["iv"], mode=mode, metrics=metrics, log=log)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        diff = [{k: now[k] - was[k] for k in now} for now, was in
                zip((LAUNCHES, ls.ROUTES, sb.ROUTES), before)]
        return eng, reqs, out, seconds, diff

    def serve_line(self, cell, backend, mode, run):
        """The run's line: requests, pool rounds, wall seconds, requests/s,
        latency and queue-wait percentiles (engine.stats()), iterations,
        launches by kernel and route."""
        eng, reqs, _, seconds, (launches, k34, k2) = run
        st = eng.stats()
        c, h = st["counters"], st["histograms"]
        its = np.array([r.iterations for r in reqs], float)

        def pct(name, q):
            return h[name][f"p{q}"] if name in h else None

        line = {"phase": "serve", "cell": cell, "backend": backend,
                "mode": mode, "requests": len(reqs),
                "submitted": c.get("requests.submitted"),
                "rounds": c.get("flush.rounds"), "seconds": seconds,
                "requests_per_s": len(reqs) / seconds,
                "latency_p50_s": pct("request.latency_s", 50),
                "latency_p99_s": pct("request.latency_s", 99),
                "queue_wait_p50_s": pct("request.queue_wait_s", 50),
                "queue_wait_p99_s": pct("request.queue_wait_s", 99),
                "iterations_mean": float(its.mean()),
                "iterations_p95": float(np.percentile(
                    its, 95, method="inverted_cdf")),
                "iterations_max": int(its.max()),
                "counters": c,
                "launches": {k: v for k, v in launches.items() if v},
                "k3_k4_routes": {k: v for k, v in k34.items() if v},
                "k2_routes": {k: v for k, v in k2.items() if v}}
        emit(line)
        return line

    def serve_compare(self, what, reqs, ref, cell, slack, lockstep=False):
        """Hold a run's requests against the reference backend's: equal
        decisions, resolved and certified flags, iterations within 1, and
        every resolved bracket around its truth (``slack`` relative). A
        lockstep flush ignores deadlines, so the expired requests are left
        out of its comparison; a continuous one must retire them at zero
        iterations."""
        sv = self.serve_problem(cell)
        skip = set(sv["expired"]) if lockstep else set()
        misses, worst = 0, -np.inf
        for i, (g, w) in enumerate(zip(reqs, ref)):
            if i in skip:
                continue
            assert g.decision == w.decision, f"{what} {i}: decision"
            assert (g.resolved, g.certified) == (w.resolved, w.certified), \
                f"{what} {i}: flags"
            assert abs(g.iterations - w.iterations) <= 1, \
                f"{what} {i}: iterations {g.iterations} vs {w.iterations}"
            if g.resolved:
                t = sv["truth"][i]
                miss = max(g.lower - t, t - g.upper) / abs(t)
                worst = max(worst, miss)
                misses += miss > slack
        assert misses == 0, f"{what}: {misses} brackets miss their truth"
        if not lockstep:
            for i in sv["expired"]:
                assert reqs[i].iterations == 0 and reqs[i].state is None \
                    and reqs[i].resolved is False, f"{what} {i}: expired"
        return {"max_rel_miss": worst, "slack": slack}

    def serve_partials(self, cell, backend, reqs):
        """The budget partials, resumed, against an uninterrupted run of
        the same traffic without their budgets on the same backend: the
        same bits. Each partial resumes in the slot it was banked from
        (BIFEngine._place), where the uninterrupted run solves it
        throughout: on the card a lane's bits depend on its slot."""
        sv = self.serve_problem(cell)
        _, whole, _, _, _ = self.serve_run(cell, backend, budgets=False)
        for i in sv["partial"]:
            g, w = reqs[i], whole[i]
            assert g.resolved and g.state is None, f"partial {i} unresolved"
            assert (g.lower, g.upper, g.iterations) == \
                (w.lower, w.upper, w.iterations), \
                f"{cell} {backend}: partial {i} did not resume bit-exactly"
        return len(sv["partial"])

    def serve_counters(self, eng, cell):
        """engine.stats() counters against the traffic (continuous)."""
        sv = self.serve_problem(cell)
        r, p, e = SERVE_REQUESTS, len(sv["partial"]), len(sv["expired"])
        c = eng.stats()["counters"]
        want = {"requests.submitted": r + p, "requests.resubmitted": p,
                "requests.retired": r + p, "requests.resolved": r - e,
                "requests.partial": p + e, "requests.expired": e}
        got = {k: c.get(k, 0) for k in want}
        assert got == want, f"{cell} counters {got} != {want}"

    def phase_serve(self):
        """The serving path through its entry points: BIFEngine over the
        dense and sparse operators on every backend, rank_blocks and a
        streaming BlockRanker over a KV head's keys, and the obs smoke;
        see the module docstring."""
        from repro_torch import obs
        from repro_torch.core import SolverConfig
        from repro_torch.kernels import LAUNCHES
        from repro_torch.kernels import lanczos_step as ls
        from repro_torch.obs import smoke as obs_smoke
        from repro_torch.serve import BlockRanker, flush_trace_count, \
            rank_blocks
        from repro_torch.kernels import reset_launches

        out_dir = Path(__file__).resolve().parent / "build" / "obs_smoke"
        smoke = obs_smoke.run(out_dir, device=self.dev)
        reset_launches()
        launches_all = {}

        def add(diff):
            for k, v in diff.items():
                launches_all[k] = launches_all.get(k, 0) + v

        summary = {"phase": "serve", "obs_smoke": {
            k: smoke[k] for k in ("events", "retraces", "rounds", "device")}}
        for cell in ("dense", "sparse"):
            sv = self.serve_problem(cell)
            ref = self.serve_run(cell, "reference")
            self.serve_line(cell, "reference", "continuous", ref)
            self.serve_counters(ref[0], cell)
            runs = [("pallas", "continuous"), ("fused", "continuous")]
            if cell == "dense":
                runs.append(("fused", "lockstep"))
            res = {}
            for backend, mode in runs:
                tele = cell == "dense" and backend == "pallas"
                if tele:     # spans and a convergence log on this run
                    obs.enable()
                try:
                    run = self.serve_run(
                        cell, backend, mode,
                        log=obs.ConvergenceLog() if tele else None)
                finally:
                    obs.metrics.set_enabled(True)
                    obs.spans.set_enabled(False)
                eng, reqs, out, _, diff = run
                add(diff[0])
                line = self.serve_line(cell, backend, mode, run)
                assert all(a is b for a, b in zip(out, reqs)) \
                    and len(out) == len(reqs), "submission order"
                slack = 1e-9
                if cell == "sparse" and backend == "pallas":
                    # K2's f32 accumulation (ROADMAP Queue 3, Contracts)
                    slack = sv["iv"][1] / sv["iv"][0] * 2.0 ** -24
                res[(backend, mode)] = self.serve_compare(
                    f"{cell} {backend} {mode}", reqs, ref[1], cell, slack,
                    lockstep=mode == "lockstep")
                if mode == "continuous":
                    self.serve_counters(eng, cell)
                    res[(backend, mode)]["partials_bit_exact"] = \
                        self.serve_partials(cell, backend, reqs)
                launched, k34, k2 = diff
                if backend == "pallas":
                    assert launched["gql_update"] > 0, f"{cell}: no K1"
                if cell == "dense" and backend == "fused":
                    assert launched["fused_step_dense"] > 0 and \
                        k34["dmma"] == launched["fused_step_dense"], \
                        f"dense {mode}: K3 off its dmma route {k34}"
                if cell == "sparse":
                    assert_tiled(launched, {"bell_matvec": k2,
                                            "fused_step_bell": k34})
                    kernel = "bell_matvec" if backend == "pallas" \
                        else "fused_step_bell"
                    assert launched[kernel] > 0, f"sparse: no {kernel}"
                if tele:
                    # the same traffic with every piece of telemetry off
                    obs.disable()
                    try:
                        _, quiet, _, _, _ = self.serve_run(
                            cell, backend, metrics=False)
                    finally:
                        obs.metrics.set_enabled(True)
                        obs.spans.set_enabled(False)
                    assert [(r.lower, r.upper, r.decision, r.certified,
                             r.iterations, r.resolved) for r in reqs] == \
                        [(r.lower, r.upper, r.decision, r.certified,
                          r.iterations, r.resolved) for r in quiet], \
                        "telemetry changed the results"
                    assert eng.convergence_log.rounds == \
                        line["rounds"], "convergence log missed rounds"
                    res[(backend, mode)]["telemetry_bit_identical"] = True
            summary[cell] = {f"{b} {m}": v for (b, m), v in res.items()}

        # serve-kv: rank_blocks on every backend, then a streaming ranker
        kv = self.kv_problem()
        truth = kv["truth"]
        ranked = {}
        for backend in ("reference", "pallas", "fused"):
            cfg = SolverConfig(**KV, backend=backend)
            kw = dict(block=KV_BLOCK, max_batch=SERVE_POOL,
                      coarse_iters=KV_COARSE, solver_config=cfg,
                      device=self.dev)
            before, routes = dict(LAUNCHES), dict(ls.ROUTES)
            count0 = flush_trace_count()
            (order, st), seconds = self.run_timed(
                lambda: rank_blocks(kv["keys"], **kw))
            count1 = flush_trace_count()
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            k3 = {k: ls.ROUTES[k] - routes[k] for k in ls.ROUTES}
            add(launched)
            b = np.array(st["brackets"])
            miss = np.maximum(b[:, 0] - truth, truth - b[:, 1]) / truth
            # a second call in the same padding bucket (248 blocks, n_pad
            # 256) meets no new driver signature
            rank_blocks(kv["keys"][:(st["blocks"] - 8) * KV_BLOCK], **kw)
            ranked[backend] = (order, b)
            emit({"phase": "serve", "cell": "kv", "backend": backend,
                  "blocks": st["blocks"], "seconds": seconds,
                  "iterations": st["iterations"], "refined": st["refined"],
                  "resolved": st["resolved"], "certified": st["certified"],
                  "max_rel_miss": float(miss.max()), "slack": KV_SLACK,
                  "new_signatures": count1 - count0,
                  "launches": {k: v for k, v in launched.items() if v},
                  "k3_routes": {k: v for k, v in k3.items() if v}})
            assert float(miss.max()) <= KV_SLACK, \
                f"kv {backend}: a bracket misses its truth"
            assert count1 > count0 and flush_trace_count() == count1, \
                f"kv {backend}: the same-bucket call met a new signature"
            if backend == "pallas":
                assert launched["gql_update"] > 0, "kv: no K1"
            if backend == "fused":
                assert k3["fma_f32"] > 0 and \
                    k3["fma_f32"] == launched["fused_step_dense"], \
                    f"kv: K3 off its f32 route {k3}"
        ref_order, ref_b = ranked["reference"]
        gap = KV_SLACK * np.abs(truth)
        separated = 0
        for backend in ("pallas", "fused"):
            order = ranked[backend][0]
            pos = np.empty(len(order), int)
            pos[order] = np.arange(len(order))
            rpos = np.empty(len(order), int)
            rpos[ref_order] = np.arange(len(order))
            sep = (ref_b[:, None, 0] - ref_b[None, :, 1]) > gap[:, None]
            np.fill_diagonal(sep, False)
            i, j = np.nonzero(sep)
            assert np.all(pos[i] < pos[j]) and np.all(rpos[i] < rpos[j]), \
                f"kv {backend}: order differs where brackets separate"
            separated = len(i)
        before = dict(LAUNCHES)
        ranker = BlockRanker(block=KV_BLOCK, max_batch=SERVE_POOL,
                             coarse_iters=KV_COARSE,
                             solver_config=SolverConfig(**KV,
                                                        backend="pallas"),
                             device=self.dev)
        (_, first), t_first = self.run_timed(
            lambda: ranker.extend(kv["keys"]).rank())
        (_, grown), t_grown = self.run_timed(
            lambda: ranker.extend(kv["more"]).rank())
        add({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        emit({"phase": "serve", "cell": "kv", "ranker": "BlockRanker",
              "first": {k: first[k] for k in ("blocks", "solved",
                                              "iterations")},
              "grown": {k: grown[k] for k in ("blocks", "solved", "reused",
                                              "refined", "iterations")},
              "seconds": [t_first, t_grown],
              "engine_builds": ranker.stats["engine_builds"]})
        assert grown["blocks"] == first["blocks"] + KV_MORE // KV_BLOCK
        assert grown["solved"] * 4 <= grown["blocks"], \
            "the grown ranking re-solved most blocks"
        summary.update(kv_pairs_separated=separated,
                       signatures=obs.retrace_counts(),
                       launches=launches_all)
        emit(summary)
        assert smoke["events"] > 0
        self._count(launches_all)

    def phase_sharded(self):
        """The multi-device lanes: every call of SHARDED_ALL on one
        device in this process (the oracle), then at D = 1 on NCCL in this
        process, then SHARDED_SPAWNS (gloo ranks that share the card) and,
        with more than one card, NCCL a rank a card, spawned, each rank
        timing its calls. Every rank returns the same
        outcome, and it equals the oracle's: decisions, certification,
        argmax index and selections; iterations within 1 per lane; the
        brackets of lanes that took the same steps within SHARDED_SLACK
        relative (K2's and K5's f32 paths within kappa 2^-24); one gather
        per round (a solve: rounds + 2); the expected kernel routes on
        every rank."""
        import multiprocessing as mp
        import pickle
        import shutil

        import torch.distributed as dist
        from repro_torch.launch import init_lane_group, make_lane_mesh
        d, sp, sv = self.dense_problem(), self.sparse_problem(), \
            self.serve_problem("dense")
        ap = self.apps_problem()
        masks, um, shift, _ = self.argmax_problem()
        truth = torch.sum(d["u"] * torch.linalg.solve(d["a"], d["u"].T).T,
                          dim=-1)
        rng = np.random.default_rng(SEED + 14)
        delta = rng.uniform(0.05, 0.5, K) * rng.choice([-1.0, 1.0], K)
        bell = sp["bell"]

        def h(x):
            return x.detach().cpu().numpy()

        job = dict(
            device_type=self.dev.type, a=h(d["a"]), u=h(d["u"]),
            t=h(truth) * (1.0 + delta), masks=h(masks), um=h(um),
            shift=h(shift), bell_data=h(bell.data), bell_cols=h(bell.cols),
            bell_diag=h(bell.diag_vals), bell_n=bell.n, u_sparse=h(sp["u"]),
            greedy_a=h(ap["greedy_a"]), iv=(d["lmn"], d["lmx"]),
            iv_sparse=(sp["lmn"], sp["lmx"]), greedy_iv=ap["greedy_iv"],
            reqs=sv["reqs"], partial=sv["partial"])
        job_dir = Path(__file__).resolve().parent / "build" / "sharded"
        shutil.rmtree(job_dir, ignore_errors=True)
        job_dir.mkdir(parents=True)
        p = sharded_problems(job, self.dev)
        seconds = {}
        t0 = time.perf_counter()
        want = {name: sharded_view(sharded_call(name, p, None)())
                for name in SHARDED_ALL}
        seconds["oracle"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        init_lane_group("nccl" if self.dev.type == "cuda" else "gloo", 0, 1,
                        store=dist.FileStore(str(job_dir / "store1"), 1),
                        timeout_s=60.0)
        one = "nccl" if self.dev.type == "cuda" else "gloo"
        try:
            mesh = make_lane_mesh(device_type=self.dev.type)
            results = {(1, one): [{name: sharded_measure(name, p, mesh,
                                                         profile=True)
                                   for name in SHARDED_CALLS}]}
        finally:
            dist.destroy_process_group()
        seconds[f"{one} D=1"] = time.perf_counter() - t0
        with open(job_dir / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        ctx = mp.get_context("spawn")
        cards = torch.cuda.device_count() if self.dev.type == "cuda" else 0
        spawns = SHARDED_SPAWNS + (((cards, "nccl", SHARDED_ALL),)
                                   if cards > 1 else ())
        for world, backend, calls in spawns:
            t0 = time.perf_counter()
            procs = [ctx.Process(target=sharded_rank, args=(
                r, world, backend, calls, str(job_dir)))
                for r in range(world)]
            for q in procs:
                q.start()
            deadline = time.monotonic() + SHARDED_TIMEOUT_S
            for q in procs:
                q.join(max(deadline - time.monotonic(), 0.0))
            for q in procs:
                if q.is_alive():
                    q.kill()
                    q.join()
            codes = [q.exitcode for q in procs]
            assert codes == [0] * world, \
                f"sharded {backend} D={world}: rank exit codes {codes}"
            results[(world, backend)] = []
            for r in range(world):
                with open(job_dir / f"{backend}{world}_rank{r}.pkl",
                          "rb") as f:
                    results[(world, backend)].append(pickle.load(f))
            seconds[f"{backend} D={world}"] = time.perf_counter() - t0

        kappa = sp["lmx"] / sp["lmn"] * 2.0 ** -24
        u_s = sp["u"]
        truths = {"dense": h(truth), "sparse": h(torch.sum(
            u_s * torch.linalg.solve(sp["a32"], u_s.T).T, dim=-1)),
            "serve": sv["truth"]}
        truths["dense62"] = truths["dense"][:SHARDED_PADDED_K]
        launches = {}
        for (world, backend), recs_by_rank in results.items():
            for name in recs_by_rank[0]:
                recs = [r[name] for r in recs_by_rank]
                for r, rec in enumerate(recs):
                    sharded_check_rank(name, rec)
                    for k, v in rec["view"].items():
                        assert np.array_equal(v, recs[0]["view"][k],
                                              equal_nan=True), \
                            f"{backend} D={world} {name}: rank {r} {k}"
                    for k, v in rec["launches"].items():
                        launches[k] = launches.get(k, 0) + v
                cell, what, _ = name.split()
                if cell == "greedy" and recs[0]["cuda"]:
                    assert sum(r_["launches"].get("gql_update", 0)
                               for r_ in recs) > 0, \
                        f"{backend} D={world} {name}: no rank launched K1"
                f32 = name in ("sparse solve pallas", "trace logdet pallas")
                slack = kappa if f32 else DENSE["rtol"] \
                    if name in SHARDED_WIDTH_CALLS else SHARDED_SLACK
                truth = truths.get(cell) if what in ("solve", "flush") \
                    else None
                line = sharded_compare(
                    f"{backend} D={world} {name}", recs[0]["view"],
                    want[name], slack, truth, kappa if f32 else 1e-9)
                emit({"phase": "sharded", "world": world, "backend": backend,
                      "call": name, **line, "ranks": [{
                          "seconds": rec["seconds"],
                          "device_s": rec.get("device_s"),
                          "nccl_s": rec.get("nccl_s"),
                          "idle_share": rec.get("idle_share"),
                          "rounds": rec["counts"]["rounds"],
                          "gathers": rec["counts"]["gathers"],
                          "gather_s": rec["counts"]["gather_s"],
                          "bytes_per_gather": rec["bytes_per_gather"],
                          "launches": rec["launches"],
                          "routes": rec["routes"]} for rec in recs]})
        emit({"phase": "sharded", "seconds": seconds, "cards": cards,
              "worlds": [f"{b} D={w}" for w, b in results],
              "launches": launches})
        self._count(launches)

    def phase_attention(self):
        """The K7 path: mha_flash over one llama3-405b attention layer,
        a 4096-token causal prefill in bf16, then a decode-shaped call (the
        last query over all 4096 keys) and an f32 call over 16 heads,
        each against the plain version on the card, row by row (ATTN_TOL);
        then the same measure on planted faults, which must exceed the
        bf16 limit."""
        from repro_torch.kernels import LAUNCHES, ops, reset_launches
        from repro_torch.kernels.flash_attention import flash_attention_plain
        ap = self.attention_problem()
        q, k, v = ap["q"], ap["k"], ap["v"]
        from repro_torch.kernels.flash_attention import ROUTES as K7_ROUTES
        reset_launches()
        o, t_pre = self.path_call(lambda: ops.mha_flash(q, k, v, causal=True))
        routes = {"prefill": dict(K7_ROUTES)}
        o_dec, t_dec = self.path_call(lambda: ops.mha_flash(
            q[:, -1:], k, v, causal=False))
        routes["decode"] = dict(K7_ROUTES)
        o32, t_32 = self.path_call(lambda: ops.flash_attention(
            ap["q32"], ap["k32"], ap["v32"], causal=True))
        routes["f32"] = dict(K7_ROUTES)
        launches = dict(LAUNCHES)
        want_pre = mha_plain(q, k, v, True)
        checks = {
            "prefill": (o, want_pre, ATTN_TOL[torch.bfloat16]),
            "decode": (o_dec, mha_plain(q[:, -1:], k, v, False),
                       ATTN_TOL[torch.bfloat16]),
            "f32": (o32, flash_attention_plain(ap["q32"], ap["k32"],
                                               ap["v32"], causal=True),
                    ATTN_TOL[torch.float32])}
        faults = planted_faults(q, k, v, want_pre)
        line = {"phase": "attention", "q": list(q.shape),
                "kv": list(k.shape), "dtype": "bfloat16",
                "f32_call": list(ap["q32"].shape), "launches": launches,
                "seconds": {"prefill": t_pre, "decode": t_dec, "f32": t_32},
                "error_measure": "row_errors", "planted_faults": faults,
                "routes_after": routes}
        for what, (got, want, tol) in checks.items():
            abs_err, rel_err = row_errors([got], [want])
            line[what] = {"shape": list(got.shape),
                          "dtype": str(got.dtype).replace("torch.", ""),
                          "finite": bool(torch.isfinite(got.float()).all()),
                          "max_abs_err": abs_err, "max_rel_err": rel_err,
                          "tolerance": tol}
        emit(line)
        for what, (got, want, tol) in checks.items():
            assert line[what]["finite"], f"attention {what}: not finite"
            assert got.shape == want.shape and got.dtype == want.dtype
            assert line[what]["max_rel_err"] <= tol, f"attention {what}"
        assert faults["sound"] <= ATTN_TOL[torch.bfloat16]
        for what in ("tile_skipped", "no_rescale"):
            assert faults[what] > ATTN_TOL[torch.bfloat16], \
                f"the K7 check would pass a kernel with {what}"
        assert launches["flash_attention"] == 3
        assert routes["prefill"] == {"wgmma": 1, "mma_sync": 0,
                                     "fma_f32": 0}, "prefill not on wgmma"
        assert routes["decode"]["mma_sync"] == 1
        assert routes["f32"]["fma_f32"] == 1
        self._count(launches)

    def phase_coo(self):
        from repro_torch.core import sparse_from_dense
        sp = self.sparse_problem()
        op = sparse_from_dense(sp["lap"], device=self.dev)
        x = sp["u"]
        y1 = op.matvec(x)
        y2 = op.matvec(x)
        torch.cuda.synchronize()
        ref = x @ torch.as_tensor(sp["lap"], device=self.dev).T
        rel = ((y1 - ref).abs().max() / ref.abs().max()).item()
        same = bool(torch.equal(y1, y2))
        emit({"phase": "coo", "nnz": int(op.vals.numel()),
              "slots_per_row": int(op.ell.shape[-1]),
              "bit_identical": same, "rel_err_vs_dense": rel,
              "matvec_ms": cuda_ms(lambda: op.matvec(x))})
        assert same, "COO matvec is not deterministic"
        assert rel <= 1e-12

    # -- the training path --------------------------------------------------

    def train_config(self):
        """olmo-1b as the port's configs define it (a rehearsal on the CPU
        sets ``self.train_cfg`` to a small config)."""
        from repro_torch.configs import get_arch
        return self.train_cfg or get_arch(TRAIN_ARCH)

    def phase_train(self):
        """The training path end to end on the card, through the
        launcher's pieces (``launch.train.build_run``): olmo-1b at full
        width, DPP-selected batches, AdamW, the GQL monitor, async
        checkpoints; checks (a)-(g) of the module docstring. No kernel of
        the port lies on this path: every launch counter must read 0."""
        import shutil
        import tempfile

        from repro_torch.checkpoint import io as ckpt_io
        from repro_torch.kernels import LAUNCHES, reset_launches
        from repro_torch.launch import train as launch
        from repro_torch.models import model as M

        t_phase = time.perf_counter()
        cfg = self.train_config()
        module_params = sum(p.numel() for p in M.LM(
            cfg, M.param_skeleton(cfg)).parameters())
        line = {"phase": "train", "arch": cfg.name,
                "layers": cfg.n_layers, "d_model": cfg.d_model,
                "heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                "norm": cfg.norm, "dtype": cfg.dtype, "remat": cfg.remat,
                "param_count": cfg.param_count(),
                "module_params": module_params, "tokens_per_step":
                TRAIN["batch"] * TRAIN["seq"], "depth_cut_a_f": TRAIN_CUT,
                "tol": TRAIN_TOL, "nvidia_smi": nvidia_smi()}
        assert module_params == cfg.param_count(), \
            f"the module holds {module_params} parameters, the config " \
            f"{cfg.param_count()}"
        if cfg.name == "olmo-1b":
            assert cfg.param_count() == 1_176_764_416
        root = Path(__file__).resolve().parent / "build"
        root.mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=root))
        line["disk_free_gb"] = shutil.disk_usage(tmp).free / 1e9

        def run_of(c, name, monitor):
            return launch.build_run(
                c, steps=TRAIN["steps"], seq=TRAIN["seq"],
                batch=TRAIN["batch"], lr=TRAIN["lr"], selector="dpp",
                monitor=monitor, save_every=TRAIN["save_every"],
                keep_checkpoints=TRAIN["keep"], ckpt_dir=tmp / name,
                device=self.dev)

        reset_launches()
        # each save: the host snapshot (before the next step may run) and
        # the write on the saver's thread, with the bytes on disk
        saves = {}
        real_save, real_async = ckpt_io.save, ckpt_io.AsyncSaver.save

        def record(ckpt_dir, step):
            return saves.setdefault(f"{Path(ckpt_dir).parent.name}/{step}",
                                    {})

        def timed_save(ckpt_dir, step, tree_, *, extra=None):
            t0 = time.perf_counter()
            out = real_save(ckpt_dir, step, tree_, extra=extra)
            record(ckpt_dir, step).update(
                write_s=time.perf_counter() - t0,
                bytes=sum(f.stat().st_size for f in out.iterdir()))
            return out

        def timed_snapshot(saver, ckpt_dir, step, tree_, extra=None):
            t0 = time.perf_counter()
            real_async(saver, ckpt_dir, step, tree_, extra=extra)
            record(ckpt_dir, step)["snapshot_s"] = time.perf_counter() - t0

        ckpt_io.save, ckpt_io.AsyncSaver.save = timed_save, timed_snapshot
        try:
            self.train_main(cfg, run_of, line)
            self.train_cpu_parity(cfg, line)
            self.train_resume(cfg, run_of, line, tmp)
        finally:
            ckpt_io.save, ckpt_io.AsyncSaver.save = real_save, real_async
            shutil.rmtree(tmp, ignore_errors=True)
        line["checkpoint_saves"] = saves
        launches = dict(LAUNCHES)
        line["launches"] = launches
        line["seconds"] = time.perf_counter() - t_phase
        emit(line)
        # (g) nothing of this path runs a port kernel
        assert not any(launches.values()), \
            f"the training path launched port kernels: {launches}"

    def train_main(self, cfg, run_of, line):
        """The 8-step run with the selector, the monitor and checkpoints:
        (b) before it, (c), (d) and (e) over it, and its timings."""
        from repro_torch import tree
        from repro_torch.data import DPPSelector
        from repro_torch.models import model as M
        from repro_torch.train import train as train_loop
        run = run_of(cfg, "main", monitor=True)
        sel = run.stream.selector
        picks, sel_s = {}, []
        real_select = sel.select

        def select(pool_tokens, k, step=0, *, draws=None):
            t0 = time.perf_counter()
            idx = real_select(pool_tokens, k, step, draws=draws)
            torch.cuda.synchronize()
            sel_s.append(time.perf_counter() - t0)
            picks[step] = (idx, dict(sel.last_stats))
            return idx

        sel.select = select
        batch0 = run.stream.batch_at(0)
        sel_s.clear()
        self.train_first = {k: v[:1].cpu() for k, v in batch0.items()}

        # (b) the step-0 loss in bf16 against the same parameters in f32
        p0, _ = M.init_model(SEED, cfg, device=self.dev)
        with torch.no_grad():
            l16 = float(M.loss_fn(cfg, p0, batch0)[0])
            c32 = dataclasses.replace(cfg, dtype="float32")
            p32 = tree.map(lambda x: x.to(torch.float32), p0)
            del p0
            l32 = float(M.loss_fn(c32, p32, batch0)[0])
        del p32
        line["b_loss_bf16"], line["b_loss_f32"] = l16, l32
        line["b_rel"] = abs(l16 - l32) / abs(l32)
        assert line["b_rel"] <= TRAIN_TOL["bf16"], \
            f"(b) bf16 loss {l16} vs f32 {l32}"

        step_s, mon_s, checks = [], [], []

        def step_fn(params, opt_state, batch):
            if len(step_s) == 1:   # step 1, outside the median: profiled
                return self.train_profile(run.step_fn, params, opt_state,
                                          batch, step_s, line)
            t0 = time.perf_counter()
            out = run.step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        def monitor(params, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run.monitor(params, batch)
            torch.cuda.synchronize()
            mon_s.append(time.perf_counter() - t0)
            checks.append(self.train_monitor_check(cfg, params, batch, got))
            return got

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_loop(
            loop_cfg=run.loop_cfg, ckpt_dir=run.ckpt_dir,
            init_state=run.init_state, step_fn=step_fn,
            batch_fn=run.stream.batch_at, monitor_fn=monitor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()

        losses = res.losses
        # (c) the loss falls
        assert np.mean(losses[-2:]) < np.mean(losses[:2]), \
            f"(c) the loss did not fall: {losses}"
        # (e) every selection certified, the same as the exact chain's
        # under the same draws (a generator seeded with the step)
        exact = DPPSelector(pool_factor=sel.pool_factor,
                            steps_per_item=sel.steps_per_item, exact=True,
                            device=self.dev)
        same = []
        for step, (idx, stats) in sorted(picks.items()):
            assert stats["uncertified"] == 0, f"(e) step {step}: {stats}"
            pool = run.stream.pool_at(step)[:, :-1]
            want = exact.select(pool, run.stream.stream.local_batch, step)
            same.append(bool(np.array_equal(idx, want)))
        assert all(same), f"(e) selections differ from exact: {same}"

        tokens = TRAIN["batch"] * TRAIN["seq"]
        sps = float(np.median(step_s[2:]))
        line.update(
            losses=losses, loss_step0_equals_b=losses[0] == l16,
            step_s=step_s, seconds_per_step=sps, tokens_per_s=tokens / sps,
            bf16_peak_share=6 * cfg.param_count() * tokens / sps / BF16_PEAK,
            max_memory_allocated=peak, run_wall_s=wall,
            monitor_s=mon_s, monitor_s_per_call=float(np.mean(mon_s)),
            monitor=dict(res.monitor_log), d_checks=checks,
            selection_s=sel_s, selection_s_per_batch=float(np.mean(sel_s)),
            selection_stats={s: st for s, (_, st) in sorted(picks.items())},
            e_same_as_exact=same)

    def train_profile(self, step_fn, params, opt_state, batch, step_s,
                      line):
        """One train step under torch.profiler: host seconds, the device
        seconds of every kernel it ran, the idle share, and the kernels
        that took the most device time."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
        step_s.append(host)
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_time_total > 0 and not e.is_user_annotation
                and e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(ms for _, ms, _ in rows) / 1e3
        rows.sort(key=lambda r: -r[1])
        line["profile_step1"] = {
            "host_s": host, "device_s": device,
            "idle_share": 1 - device / host if host > 0 else None,
            "top_kernels_ms": [[k[:90], ms, n] for k, ms, n in rows[:14]]}
        return out

    def train_monitor_check(self, cfg, params, batch, got):
        """(d): the sketches again on the same parameters and batch, the
        dense f64 truths, and the monitor's dict against the bounds of
        those sketches."""
        from repro_torch.models import model as M
        from repro_torch.train import monitor as mon
        lam, n, k = 1e-3, 2, 16
        sk = mon.example_sketches(M.loss_fn, cfg, params, batch, n=n,
                                  sketch_dim=k)
        s64 = sk.double()
        f = s64.T @ s64 / n + lam * torch.eye(k, dtype=torch.float64,
                                              device=sk.device)
        probe = s64.mean(0)
        w = torch.linalg.eigvalsh(f)
        truth = {"nat": float(probe @ torch.linalg.solve(f, probe)),
                 "logdet": float(torch.linalg.slogdet(f)[1]),
                 "kappa": float(w[-1] / w[0])}
        bif = mon.fisher_proxy_bounds(sk, sk.mean(0), lam=lam)
        ld = mon.logdet_bounds(sk, lam=lam)
        again = {"nat_norm_lower": float(bif.lower),
                 "nat_norm_upper": float(bif.upper),
                 "quad_iters": int(bif.iterations),
                 "logdet_lower": float(ld.lower),
                 "logdet_upper": float(ld.upper),
                 **mon.condition_number_bounds(sk, lam=lam)}
        tol = TRAIN_TOL["f32"]

        def holds(lo, hi, t):
            return lo - tol * abs(t) <= t <= hi + tol * abs(t)

        out = {"truth": truth, "dict_bit_equal": got == again,
               "max_rel_diff_vs_again": max(
                   abs(got[x] - again[x]) / max(abs(again[x]), 1e-30)
                   for x in again),
               "kappa_upper_holds": got["kappa_upper"] >= truth["kappa"]}
        assert set(got) == set(again)
        assert out["max_rel_diff_vs_again"] <= tol, f"(d) {got} vs {again}"
        assert holds(got["nat_norm_lower"], got["nat_norm_upper"],
                     truth["nat"]), f"(d) nat norm {got} vs {truth}"
        assert holds(got["logdet_lower"], got["logdet_upper"],
                     truth["logdet"]), f"(d) logdet {got} vs {truth}"
        assert got["kappa_lower"] <= truth["kappa"] * (1 + tol), \
            f"(d) kappa_lower {got['kappa_lower']} vs {truth['kappa']}"
        return out

    def train_cpu_parity(self, cfg, line):
        """(a) the loss and every gradient leaf's norm of the first batch's
        first sequence, f32, TRAIN_CUT layers at full width: the card
        against the port's CPU path on the same parameters."""
        from repro_torch import tree
        from repro_torch.models import model as M
        cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT, dtype="float32")
        params, _ = M.init_model(SEED, cut, device="cpu")
        batch = self.train_first
        t0 = time.perf_counter()
        (l_cpu, _), g_cpu = M.value_and_grad(cut, params, batch)
        cpu_s = time.perf_counter() - t0
        on = lambda x: x.to(self.dev)  # noqa: E731
        (l_dev, _), g_dev = M.value_and_grad(cut, tree.map(on, params),
                                             tree.map(on, batch))
        n_cpu = [float(torch.linalg.vector_norm(g.double()))
                 for g in tree.leaves(g_cpu)]
        n_dev = [float(torch.linalg.vector_norm(g.double()))
                 for g in tree.leaves(g_dev)]
        rel = [abs(a - b) / b for a, b in zip(n_dev, n_cpu)]
        line.update(a_loss_card=float(l_dev), a_loss_cpu=float(l_cpu),
                    a_loss_rel=abs(float(l_dev) - float(l_cpu))
                    / abs(float(l_cpu)),
                    a_grad_norm_rel=rel, a_cpu_s=cpu_s)
        assert line["a_loss_rel"] <= TRAIN_TOL["cpu"], "(a) loss"
        assert max(rel) <= TRAIN_TOL["cpu"], f"(a) gradient norms {rel}"

    def train_resume(self, cfg, run_of, line, tmp):
        """(f) TRAIN_CUT layers at full width, bf16: a run stopped at step 6
        resumes from step 4 with the losses of an uninterrupted run, under
        torch.use_deterministic_algorithms (which needs the cuBLAS
        workspace variable set; on the H100 ':4096:8' is also the size
        PyTorch picks by default)."""
        import os
        import shutil
        cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            full = run_of(cut, "full", monitor=False).train()
            shutil.rmtree(tmp / "full", ignore_errors=True)
            try:
                run_of(cut, "crash", monitor=False).train(fail_at_step=6)
                raise AssertionError("(f) the run did not stop at step 6")
            except RuntimeError as e:
                assert "preemption at step 6" in str(e), e
            res = run_of(cut, "crash", monitor=False).train()
        finally:
            torch.use_deterministic_algorithms(False)
        want = full.losses[4:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, want))
        line.update(f_resumed_from=res.resumed_from,
                    f_losses_resumed=res.losses, f_losses_full=want,
                    f_bit_equal=res.losses == want, f_max_rel=rel)
        assert res.resumed_from == 4, f"(f) resumed from {res.resumed_from}"
        assert len(res.losses) == len(want) and rel <= TRAIN_TOL["resume"], \
            f"(f) {res.losses} vs {want}"

    def gen_problem(self):
        """The generate phase's model and traffic: the train phase's
        config (olmo-1b) in bf16 with parameters drawn on the card from
        SEED, GEN["requests"] prompts whose lengths and tokens come from
        the seed, and their batch left-padded with token 0."""
        if self.gen is None:
            from repro_torch.models import model as M
            t0 = time.perf_counter()
            cfg = self.train_config()
            if cfg.name == "olmo-1b":
                assert cfg.param_count() == 1_176_764_416
            params, _ = M.init_model(SEED, cfg, device=self.dev)
            rng = np.random.default_rng(SEED + 11)
            lens = rng.integers(GEN["prompt_lo"], GEN["prompt_hi"] + 1,
                                GEN["requests"])
            prompts = [rng.integers(1, cfg.vocab - 1, n).astype(np.int32)
                       for n in lens]
            init_s = time.perf_counter() - t0
            self.gen = dict(cfg=cfg, params=params, prompts=prompts,
                            padded=left_pad(prompts), rng=rng, init_s=init_s,
                            cut="none: every layer at its published width")
            self.setup_s["generate problem"] = init_s
        return self.gen

    def gen_manual(self, cfg, params, padded, new, s_max, dev, *,
                   forced=None, inputs=TOKENS_ONLY, times=None):
        """A greedy prefill + decode-step loop on ``dev`` through
        ``launch.steps``' ``build_prefill_step`` / ``build_decode_step``,
        with f32 caches of ``s_max``, as the Engine runs one: the (B, new)
        tokens and each step's last-token logits (on the host). ``inputs``
        adds the family's inputs (frames and their encoder memory, patch
        embeddings and M-RoPE positions). ``forced`` (B, new) feeds those
        tokens instead of the argmax (the logits then follow the same
        sequence on two devices). With ``times`` (a dict), each call is
        timed, synchronised before and after, into ``times["encode"]``
        (the encoder memory a decode step takes), ``["prefill"]`` and
        ``["decode"]``."""
        from repro_torch.launch import steps as S
        from repro_torch.models import model as M
        pre_step, dec_step = S.build_prefill_step(cfg), \
            S.build_decode_step(cfg)

        def run(what, fn, *args):
            if times is None:
                return fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.setdefault(what, []).append(time.perf_counter() - t0)
            return out

        b, t = padded.shape
        caches = M.make_caches(cfg, b, s_max, torch.float32, device=dev)
        memory = run("encode", inputs.memory, cfg, params, dev) \
            if not inputs.engine and inputs.frames is not None else None
        caches, logits = run("prefill", pre_step, params, inputs.prefill(
            cfg, torch.as_tensor(padded, device=dev), dev), caches)
        toks, seen = [], []
        for step in range(new):
            last = logits[:, -1, :]
            seen.append(last.cpu())
            tok = torch.argmax(last, dim=-1)
            toks.append(tok.cpu().numpy())
            if step == new - 1:
                break
            if forced is not None:
                tok = torch.as_tensor(forced[:, step], device=dev)
            caches, logits = run("decode", dec_step, params, caches,
                                 inputs.decode(tok.to(torch.int32)[:, None],
                                               t + step, dev, memory))
        return np.stack(toks, 1), seen

    def gen_engine(self, cfg, params, prompts, *, new, max_seq,
                   quantized=False, temperature=0.0, gumbel=None):
        """``Engine.generate`` over ``prompts`` with each prefill and decode
        call timed (synchronised before and after) and each step's logits
        kept (on the card): (tokens (B, new), prefill seconds, decode
        seconds a step, logits, wall seconds)."""
        from repro_torch.serve import Engine, Request
        eng = Engine(cfg, params, max_batch=len(prompts),
                     max_seq=max_seq, quantized_kv=quantized,
                     gumbel=gumbel)
        pre_s, dec_s, logits = [], [], []

        def timed(fn, into):
            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return run

        real_sample = eng._sample

        def sample(lg, t):
            logits.append(lg[:, -1, :])
            return real_sample(lg, t)

        eng._prefill = timed(eng._prefill, pre_s)
        eng._decode = timed(eng._decode, dec_s)
        eng._sample = sample
        reqs = [Request(prompt=p, max_new_tokens=new,
                        temperature=temperature) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(reqs)
        wall = time.perf_counter() - t0
        return (np.stack([r.out_tokens for r in reqs]), pre_s[0], dec_s,
                logits, wall)

    def phase_generate(self):
        """The LM's serving path on the card: olmo-1b at full width (bf16)
        served by ``Engine.generate`` through ``lm_serve``: checks (a)-(f)
        of the module docstring, (c) and (e) this phase's own. No kernel of
        the port lies on this path: every launch counter must read 0."""
        from repro_torch.kernels import reset_launches
        reset_launches()
        self.lm_serve("generate", self.gen_problem(), GEN,
                      extra=self.gen_int8_and_temperature)

    def gen_int8_and_temperature(self, g, tok32, lg32, line):
        """The generate phase's own checks on its Engine run (``tok32``,
        ``lg32``: the f32 cache's tokens and each step's logits): (c) int8
        caches against f32, (e) temperature: the same draws twice, and
        each step's token the argmax of logits / T + g recomputed from
        what it saw."""
        cfg, params, prompts = g["cfg"], g["params"], g["prompts"]
        run = dict(new=GEN["new"], max_seq=GEN["max_seq"])
        tok8, _, _, lg8, _ = self.gen_engine(cfg, params, prompts,
                                             quantized=True, **run)
        line["c_prefill_rel"] = errors([lg8[0]], [lg32[0]])[1]
        line["c_first_token_equal"] = bool(np.array_equal(tok8[:, 0],
                                                          tok32[:, 0]))
        line["c_token_share_equal"] = float(np.mean(tok8 == tok32))
        assert line["c_prefill_rel"] <= LM_TOL["int8"], "(c) prefill"
        assert line["c_first_token_equal"], "(c) first token"
        del lg8
        temp = GEN["temperature"]
        runs = []
        for _ in range(2):
            gen = torch.Generator(device=self.dev).manual_seed(SEED + 12)
            drawn = []

            def gumbel(shape, gen=gen, drawn=drawn):
                e = torch.empty(shape, dtype=torch.float32, device=self.dev)
                x = -torch.log(e.exponential_(generator=gen))
                drawn.append(x)
                return x

            tok, _, _, lg, _ = self.gen_engine(cfg, params, prompts,
                                               temperature=temp,
                                               gumbel=gumbel, **run)
            runs.append((tok, lg, drawn))
        (tok_t, lg_t, dr_t), (tok_u, _, _) = runs
        again = np.stack([torch.argmax(lg / temp + x, dim=-1).cpu().numpy()
                          for lg, x in zip(lg_t, dr_t)], 1)
        line.update(e_same_twice=bool(np.array_equal(tok_t, tok_u)),
                    e_recomputed_equal=bool(np.array_equal(again, tok_t)),
                    e_token_share_equal_greedy=float(np.mean(tok_t ==
                                                             tok32)))
        assert line["e_same_twice"], "(e) the same draws, other tokens"
        assert line["e_recomputed_equal"], "(e) argmax(logits / T + g)"

    def gen_profiled(self) -> dict:
        """The generate phase's prefill and one decode step, for the
        profile phase."""
        g = self.gen_problem()
        return self.lm_profiled("generate", g["cfg"], g["params"],
                                g["padded"], GEN["max_seq"])

    def lm_profiled(self, label, cfg, params, padded, max_seq,
                    inputs=TOKENS_ONLY) -> dict:
        """A prefill of ``padded`` (with the family's ``inputs``; an enc-dec
        prefill encodes its frames) and one decode step (at its length;
        an enc-dec step reads an encoder memory made beforehand), each on
        its own f32 caches reset before the call, for the profile
        phase."""
        from repro_torch import tree
        from repro_torch.models import model as M
        b, t = padded.shape
        toks = torch.as_tensor(padded, device=self.dev)
        caches = M.make_caches(cfg, b, max_seq, torch.float32,
                               device=self.dev)
        lengths = [c.length for c in kv_caches(caches)]
        pre = inputs.prefill(cfg, toks, self.dev)
        dec = inputs.decode(toks[:, -1:], t, self.dev,
                            inputs.memory(cfg, params, self.dev))
        filled = t + inputs.extra_tokens

        def prefill():
            for leaf in tree.leaves(caches):
                leaf.zero_()
            return M.prefill(cfg, params, pre, caches)[1]

        def decode():
            for length in lengths:
                length.fill_(filled)
            return M.decode_step(cfg, params, caches, dec)[1]

        return {f"{label} prefill": prefill,
                f"{label} decode step": decode}

    # -- the MoE and SSM families ------------------------------------------

    def free_lm(self, what) -> None:
        """Drop the models and caches an earlier phase holds, and print the
        card's free memory."""
        import gc
        self.gen = None
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"{what}: {free / 2**30:.2f} GiB free of {total / 2**30:.2f}",
              flush=True)

    def lm_problem(self, name, layers, traffic=LM):
        """``name`` at its published widths cut to ``layers`` layers (bf16),
        its parameters drawn on the card from SEED, and ``traffic``: the
        same prompts for every model of LM (tokens under arctic's vocab of
        32000, the smallest; the longest exactly prompt_hi), and for an
        enc-dec or VLM model its frames or patch embeddings (standard
        normals from the seed, after the prompts)."""
        from repro_torch.configs import get_arch
        from repro_torch.models import model as M
        t0 = time.perf_counter()
        published = get_arch(name)
        cfg = dataclasses.replace(published, n_layers=layers)
        params, _ = M.init_model(SEED, cfg, device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 13)
        n = traffic["requests"]
        lens = rng.integers(traffic["prompt_lo"], traffic["prompt_hi"] + 1,
                            n)
        lens[np.argmax(lens)] = traffic["prompt_hi"]
        prompts = [rng.integers(1, min(cfg.vocab, 32000) - 1, k).astype(
            np.int32) for k in lens]
        inputs = TOKENS_ONLY
        if cfg.family == "encdec":
            inputs = LMInputs(frames=rng.standard_normal(
                (n, traffic["frames"], cfg.d_model)).astype(np.float32))
        elif cfg.family == "vlm":
            g = traffic["grid"]
            inputs = LMInputs(vision=rng.standard_normal(
                (n, g * g, cfg.d_model)).astype(np.float32), grid=g)
        self.setup_s[f"{name} init"] = init_s
        what = f"{layers} of {published.n_layers} layers" + (
            f" (and {cfg.enc_layers} encoder layers)" if cfg.is_encdec
            else "")
        return dict(cfg=cfg, params=params, prompts=prompts,
                    padded=left_pad(prompts), rng=rng, init_s=init_s,
                    inputs=inputs,
                    cut="none: every layer at its published width"
                    if layers == published.n_layers else
                    f"depth {what}; widths as published")

    def lm_bytes(self, cfg, params, b, t, experts_used, traffic,
                 extra_tokens=0, enc_len=0) -> dict:
        """A decode step's bytes and operations, two ways, against the
        bound: the larger of the bytes at 3.35 TB/s and the operations at
        the bf16 peak. Both read every non-expert parameter once, the B
        embedding rows, the caches (KV: the whole f32 cache as written,
        its filled rows, mean over the run, as needed; SSM: the f32 state
        and conv carry, read and written) and write the f32 logits; the
        operations are 2 a weight a token (the unembedding's too) and 4 a
        query head width a cached row a token (attention's two products).
        "As written" reads every expert, which meets every token (the
        dense einsum dispatch), casts the unembedding table to f32 (read
        bf16, write and read f32: 10 bytes an entry) and, for an enc-dec
        model, projects every layer's cross k / v from the encoder's
        ``enc_len`` rows each step (the memory read twice, k and v written
        and read); "needed" reads the
        experts the step's tokens chose (``experts_used``: the mean count
        a MoE layer; each token meets its top-k), the table once in bf16
        and the cross k / v kept from the first step (their projections'
        weights are read either way). ``extra_tokens``: cache rows ahead
        of the prompt (a VLM's patches)."""
        from repro_torch import tree
        from repro_torch.models import model as M
        esz = 2 if cfg.dtype == "bfloat16" else 4
        total = sum(x.numel() * x.element_size() for x in tree.leaves(params))
        weights = sum(x.numel() for x in tree.leaves(params) if x.ndim >= 2)
        experts = experts_n = 0
        if cfg.family == "moe":
            for unit in params["units"].values():
                if "moe" in unit:
                    for k in ("wi", "wg", "wo"):
                        if k in unit["moe"]:
                            experts_n += unit["moe"][k].numel()
            experts = experts_n * esz
        n_moe = cfg.n_layers // cfg.moe_every if cfg.family == "moe" else 0
        vocab_d = cfg.vocab * cfg.d_model
        n_tables = 1 if cfg.tie_embeddings else 2
        if cfg.is_encdec:   # the encoder's, and the cross k / v's
            weights -= sum(params["enc_blocks"][k][w]["w"].numel()
                           for k in ("attn", "mlp")
                           for w in params["enc_blocks"][k])
            weights -= sum(params["blocks"]["xattn"][w]["w"].numel()
                           for w in ("wk", "wv"))
        tables = vocab_d * esz * n_tables
        rest = total - experts - tables + b * cfg.d_model * esz
        logits = b * cfg.vocab * 4
        di = cfg.ssm_expand * cfg.d_model
        # Mamba blocks and attention layers (a hybrid's attention: one a
        # unit, each with its own cache)
        n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
        n_units = M._hybrid_shape(cfg)[0] if cfg.family == "hybrid" else 0
        n_attn = {"ssm": 0, "hybrid": n_units}.get(cfg.family, cfg.n_layers)
        state = 2 * n_mamba * b * di * (cfg.ssm_state + cfg.ssm_conv - 1) * 4
        kvd = cfg.n_kv_heads * cfg.head_dim_
        qd = cfg.n_heads * cfg.head_dim_
        filled = extra_tokens + t + traffic["new"] / 2
        row = 2 * n_attn * b * kvd * 4
        per_expert = experts / max(n_moe, 1) / max(cfg.moe_experts, 1)
        used = per_expert * experts_used * n_moe
        # operations: the weights a token meets (the encoder's excluded),
        # every expert or the chosen ones, the unembedding, attention
        dense_w = weights - experts_n - vocab_d * n_tables
        ops_common = 2 * b * (dense_w + vocab_d)
        att = 4 * b * qd * n_attn
        cross_written = cross_needed = 0
        cross_ops_written = cross_ops_needed = 0
        if cfg.is_encdec:
            kv_rows = 2 * cfg.n_layers * b * enc_len * kvd * esz
            cross_written = 2 * cfg.n_layers * b * enc_len * cfg.d_model \
                * esz + 2 * kv_rows
            cross_needed = kv_rows
            cross_ops_needed = 4 * b * qd * enc_len * cfg.n_layers
            cross_ops_written = cross_ops_needed + 4 * cfg.n_layers * b \
                * enc_len * cfg.d_model * kvd
        written = rest + experts + vocab_d * 10 + row * traffic["max_seq"] \
            + state + logits + cross_written
        needed = rest + used + vocab_d * esz + row * filled + state \
            + logits + cross_needed
        ops_written = ops_common + 2 * b * experts_n + att * \
            traffic["max_seq"] + cross_ops_written
        ops_needed = ops_common + 2 * b * cfg.moe_top_k * n_moe * \
            per_expert / esz + att * filled + cross_ops_needed
        w_ms, w_by = bound(written, ops_written, torch.bfloat16)
        n_ms, n_by = bound(needed, ops_needed, torch.bfloat16)
        return dict(step_bytes_as_written=written,
                    step_bytes_needed=needed, moe_layers=n_moe,
                    experts_used_mean=experts_used,
                    step_ops_as_written=ops_written,
                    step_ops_needed=ops_needed,
                    step_as_written_ms=w_ms, step_as_written_bound_by=w_by,
                    step_needed_ms=n_ms, step_needed_bound_by=n_by)

    def phase_moe(self):
        """The MoE family served on the card: llama4-maverick (one unit:
        a dense block, then a MoE block) and arctic (one MoE layer) at
        their published widths, bf16, through ``lm_serve``: checks (a),
        (b), (d), (f) of the module docstring, the prefill's groups,
        capacity and dropped share, and a decode step's bytes as written
        and as needed."""
        from repro_torch.kernels import reset_launches
        self.free_lm("moe")
        reset_launches()
        for name, layers in MOE_ARCHS:
            self.lm_serve("moe", self.lm_problem(name, layers), LM)

    def phase_ssm(self):
        """The SSM family served on the card: falcon-mamba-7b at full width
        and depth, bf16, through ``lm_serve``: checks (a), (b), (d), (f)."""
        from repro_torch.kernels import reset_launches
        self.free_lm("ssm")
        reset_launches()
        self.lm_serve("ssm", self.lm_problem(*SSM_ARCH), LM)

    def phase_hybrid(self):
        """The hybrid family served on the card: zamba2-1.2b whole at its
        published widths (bf16) through ``lm_serve`` with LM's traffic:
        checks (a) (one unit and its tail), (b) (8, 20 and 38 layers in
        bf16, 38 in f32), (d), (f); then the long request
        (``hybrid_long``)."""
        from repro_torch.kernels import reset_launches
        self.free_lm("hybrid")
        reset_launches()
        self.lm_serve("hybrid", self.lm_problem(*HYBRID_ARCH), LM,
                      extra=self.hybrid_long)

    def hybrid_long(self, g, tok, lg, line):
        """The hybrid phase's own check: one request of HYBRID_LONG["prompt"]
        tokens from the seed served by ``Engine.generate`` (its prefill
        takes the chunked route), its prefill and decode timed; then, at
        T = 8719 tokens (the prompt and the 15 tokens the Engine fed
        back), where a decode step at T - 1 attends the last
        ``attn_window`` positions only, with the weights in f32 (in bf16
        the window's effect lies under the rounding at this length):
        the Engine's own last decode step (the same request served in f32)
        against the last-token logits of a full-route prefill of the T
        tokens, held to LONG_ENGINE_TOL, and one decode step on the caches
        of a full-route prefill of T - 1 tokens against the same, held to
        LM_TOL["decode_f32"] (``attn_impl="full"``: T is not a multiple of
        ``attn_chunk``; the (T, T) f32 scores take 9.7 GB). The faults
        each limit must see, read in the same run: a prefill without the
        window (above LONG_ENGINE_TOL), that decode step with a window one
        position short (above LM_TOL["decode_f32"]). Printed beside them:
        the bf16 Engine's last step against a bf16 prefill, the same 15
        steps after a full-route prefill, and the two prefill routes'
        distance."""
        from repro_torch import tree
        cfg, params = g["cfg"], g["params"]
        rng = np.random.default_rng(SEED + 15)
        prompt = rng.integers(1, cfg.vocab - 1, HYBRID_LONG["prompt"]
                              ).astype(np.int32)
        new, max_seq = HYBRID_LONG["new"], HYBRID_LONG["max_seq"]
        torch.cuda.reset_peak_memory_stats()
        toks, pre_s, dec_s, logits, wall = self.gen_engine(
            cfg, params, [prompt], new=new, max_seq=max_seq)
        peak = torch.cuda.max_memory_allocated()
        full = dataclasses.replace(cfg, attn_impl="full")

        def served(toks):            # the prompt and the tokens fed back
            return torch.as_tensor(np.concatenate(
                [prompt, toks[0, :new - 1]]), device=self.dev)[None]

        t0 = time.perf_counter()
        engine_bf16 = errors([logits[-1]], [self.prefill_last(
            full, params, served(toks))])[1]
        del logits
        line.update(
            long_prompt=len(prompt), long_new=new, long_max_seq=max_seq,
            long_prefill_s=pre_s, long_decode_step_s=dec_s,
            long_decode_s_per_step=float(np.median(dec_s[1:])),
            long_wall_s=wall, long_max_memory_allocated=peak,
            long_window=cfg.attn_window,
            long_rows_outside_window=len(prompt) + new - 1
            - cfg.attn_window,
            b_long_engine_rel=engine_bf16)
        f32 = tree.map(lambda x: x.to(torch.float32), params)
        c32 = dataclasses.replace(cfg, dtype="float32")
        full32 = dataclasses.replace(full, dtype="float32")
        toks32, _, _, eng, _ = self.gen_engine(c32, f32, [prompt], new=new,
                                               max_seq=max_seq)
        seq = served(toks32)
        l_dec, l_win, _, _, planted = self.decode_vs_prefill(
            full32, f32, seq, faults=("narrow",))
        l_dec, l_win = l_dec[:, -1].cpu(), l_win[:, -1].cpu()
        _, steps = self.gen_manual(full32, f32, prompt[None], new, max_seq,
                                   self.dev, forced=toks32)
        l_nowin = self.prefill_last(
            dataclasses.replace(full32, attn_window=None), f32, seq).cpu()
        line.update(
            long_tokens_f32_equal_bf16=bool(np.array_equal(toks32, toks)),
            b_long_engine_rel_f32=errors([eng[-1].cpu()], [l_win])[1],
            b_long_engine_tol_f32=LONG_ENGINE_TOL,
            b_long_rel_f32=errors([l_dec], [l_win])[1],
            long_full_route_steps_rel_f32=errors([steps[-1]], [l_win])[1],
            long_prefill_routes_rel_f32=errors([eng[0].cpu()],
                                               [steps[0]])[1],
            long_narrow_window_rel_f32=errors(
                [planted["narrow"][:, -1].cpu()], [l_win])[1],
            long_windowless_prefill_rel_f32=errors([l_nowin], [l_win])[1],
            long_check_s=time.perf_counter() - t0)
        del f32, eng, planted
        assert line["b_long_engine_rel_f32"] <= LONG_ENGINE_TOL, \
            f"(b) the long request's Engine, f32: " \
            f"{line['b_long_engine_rel_f32']}"
        assert line["b_long_rel_f32"] <= LM_TOL["decode_f32"], \
            f"(b) the long request, f32: {line['b_long_rel_f32']}"
        assert line["long_windowless_prefill_rel_f32"] > LONG_ENGINE_TOL, \
            "the long request's Engine limit does not see the window"
        assert line["long_narrow_window_rel_f32"] > LM_TOL["decode_f32"], \
            "the long request's decode step does not see its window's edge"

    def prefill_last(self, cfg, params, toks,
                     inputs=TOKENS_ONLY) -> torch.Tensor:
        """The last-token logits (B, V) of a prefill of ``toks`` (B, T)
        (with the family's ``inputs``) on f32 caches."""
        from repro_torch.models import model as M
        b, t = toks.shape
        caches = M.make_caches(cfg, b, t + inputs.extra_tokens,
                               torch.float32, device=self.dev)
        _, logits = M.prefill(cfg, params, inputs.prefill(
            cfg, torch.as_tensor(toks, device=self.dev), self.dev), caches)
        return logits[:, -1, :]

    def phase_encdec(self):
        """The enc-dec family served on the card: whisper-medium whole at its
        published widths (bf16) through ``lm_serve`` with ENCDEC's traffic:
        the timed greedy loop through ``launch.steps`` (the encoder memory
        a decode step takes timed apart), checks (a) (2 + 2 layers, 256
        frames), (b) (with the memory of the frames), (f); (d) is not
        applicable."""
        from repro_torch.kernels import reset_launches
        self.free_lm("encdec")
        reset_launches()
        self.lm_serve("encdec", self.lm_problem(*ENCDEC_ARCH, ENCDEC),
                      ENCDEC)

    def phase_vlm(self):
        """The VLM family served on the card: qwen2-vl-2b whole at its
        published widths (bf16) through ``lm_serve`` with VLM's traffic
        (patch embeddings, then text, at Qwen2-VL's M-RoPE positions):
        the timed greedy loop through ``launch.steps``, checks (a), (b)
        (with (B, 3, 1) decode positions), (f); (d) is not applicable."""
        from repro_torch.kernels import reset_launches
        self.free_lm("vlm")
        reset_launches()
        self.lm_serve("vlm", self.lm_problem(*VLM_ARCH, VLM), VLM)

    def lm_serve(self, phase, g, traffic, extra=None) -> None:
        """One model of ``g`` (``gen_problem``, ``lm_problem``) served on the
        card with ``traffic`` (GEN, LM, ENCDEC, VLM): a manual greedy loop
        (the reference of (d); it also warms the shapes), then the timed
        run with the default f32 cache: ``Engine.generate`` for the
        families it serves, else (enc-dec, VLM: the Engine builds
        token-only batches, as the reference's does) the same greedy loop
        through ``launch.steps`` with each call timed and the encoder
        memory timed apart, and (d) is not applicable; the MoE prefill's
        routes (``lm_routes``); a decode step's bytes and operations;
        ``extra(g, tokens, logits, line)``, the phase's own checks on the
        timed run, after (b) (``lm_decode_check``) and (a)
        (``lm_cpu_parity``); (f) no port kernel launched since the phase
        reset the counts. The line is printed before a failed check
        raises. The model is freed at the end."""
        from repro_torch import tree
        from repro_torch.kernels import LAUNCHES
        t_phase = time.perf_counter()
        cfg, params, prompts, padded = (g["cfg"], g["params"], g["prompts"],
                                        g["padded"])
        inputs = g.get("inputs", TOKENS_ONLY)
        b, t = padded.shape
        new, max_seq = traffic["new"], traffic["max_seq"]
        line = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
                "enc_layers": cfg.enc_layers,
                "cut": g["cut"], "d_model": cfg.d_model, "dtype": cfg.dtype,
                "params": sum(x.numel() for x in tree.leaves(params)),
                "init_s": g["init_s"], "requests": b,
                "prompt_lens": [len(p) for p in prompts], "padded_len": t,
                "extra_tokens": inputs.extra_tokens,
                "frames": 0 if inputs.frames is None else
                inputs.frames.shape[1],
                "new_tokens": new, "max_seq": max_seq, "tol": LM_TOL,
                "nvidia_smi": nvidia_smi()}
        if cfg.family == "moe":
            line.update(experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor)
        try:
            with RouteLog() as log:
                man, _ = self.gen_manual(cfg, params, padded, new, max_seq,
                                         self.dev, inputs=inputs)
            torch.cuda.reset_peak_memory_stats()
            if inputs.engine:
                tok, pre_s, dec_s, lg, wall = self.gen_engine(
                    cfg, params, prompts, new=new, max_seq=max_seq)
                line["d_equal"] = bool(np.array_equal(tok, man))
            else:
                times = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok, lg = self.gen_manual(cfg, params, padded, new, max_seq,
                                          self.dev, inputs=inputs,
                                          times=times)
                wall = time.perf_counter() - t0
                pre_s, dec_s = times["prefill"][0], times["decode"]
                line.update(
                    d_equal=None, timed_run_equal_manual=bool(
                        np.array_equal(tok, man)),
                    d_not_applicable="Engine.generate builds token-only "
                    "batches (the reference's too); the timed run is the "
                    "greedy loop through build_prefill_step / "
                    "build_decode_step",
                    encode_s=times.get("encode", [None])[0])
            peak = torch.cuda.max_memory_allocated()
            step_s = float(np.median(dec_s[1:]))
            used = self.lm_routes(cfg, params, padded, new, log.calls,
                                  line) if cfg.family == "moe" else 0.0
            line.update(self.lm_bytes(
                cfg, params, b, t, used, traffic,
                extra_tokens=inputs.extra_tokens, enc_len=line["frames"]))
            line.update(
                prefill_s=pre_s, decode_step_s=dec_s,
                decode_s_per_step=step_s, decode_tokens_per_s=b / step_s,
                e2e_tokens_per_s=b * new / wall, run_wall_s=wall,
                max_memory_allocated=peak,
                step_as_written_share=line["step_as_written_ms"] / 1e3
                / step_s,
                step_needed_share=line["step_needed_ms"] / 1e3 / step_s)
            self.lm_decode_check(cfg, params, padded, line, inputs)
            self.lm_cpu_parity(cfg, g, line)
            if extra is not None:
                extra(g, tok, lg, line)
            del lg
        except BaseException as exc:   # print what was measured, then fail
            line.update(failed=repr(exc), launches=dict(LAUNCHES))
            emit(line)
            raise
        line["seconds"] = time.perf_counter() - t_phase
        line["launches"] = dict(LAUNCHES)
        emit(line)
        if inputs.engine:
            assert line["d_equal"], "(d) Engine.generate, the manual loop"
        else:
            assert line["timed_run_equal_manual"], "the timed loop's tokens"
        depth = stack_depth(cfg)
        for key in ("b_rel_kept_max", "b_rel_nodrop_max"):
            if line.get(key) is not None:
                assert line[key] <= decode_tol(cfg, depth), \
                    f"(b) {key} {line[key]}"
        for d, rel in line.get("b_rel_by_depth", {}).items():
            assert rel <= decode_tol(cfg, d), f"(b) {d} layers: {rel}"
        if "b_rel_f32" in line:
            assert line["b_rel_f32"] <= LM_TOL["decode_f32"], \
                f"(b) f32 {line['b_rel_f32']}"
        # in f32 (b) sees every planted fault; in bf16 some lie within the
        # rounding, and each depth's limit must lie under one at least
        for fault, rel in line.get("b_faults", {}).items():
            assert rel["f32"] > LM_TOL["decode_f32"], \
                f"(b) f32: the fault {fault} reads {rel['f32']}"
        for d in line.get("b_rel_by_depth", {}) if line.get("b_faults") \
                else ():
            seen = max(r[d] for r in line["b_faults"].values() if d in r)
            assert seen > decode_tol(cfg, d), \
                f"(b) {d} layers: no planted fault reads above the limit"
        assert line.get("b_nodrop_dropped", 0) == 0, "(b) no-drop prefill"
        assert max(line["a_logits_rel"][:line["a_held_steps"]]) \
            <= line["a_tol"], f"(a) logits {line['a_logits_rel']}"
        assert line["a_tf32_rel"] > line["a_tol"], \
            f"(a) does not see TF32 matmuls: {line['a_tf32_rel']}"
        assert line["a_masks_equal_to_close"], "(a) dispatch masks"
        assert line["a_tokens_equal_to_close"], "(a) tokens"
        assert not any(line["launches"].values()), \
            f"(f) the serving path launched port kernels: {line['launches']}"
        del g, params
        self.free_lm(f"{cfg.name} done")

    def lm_routes(self, cfg, params, padded, new, calls, line) -> float:
        """From the manual loop's MoE routes (``calls``: each MoE layer's
        prefill call, then its decode steps'): the prefill's groups,
        capacity, largest load, dropped share and the cosine of each
        router input to its group's mean (beside the same for the embedded
        prompt tokens: the router sees nearly one direction when the
        blocks' outputs outweigh the embeddings), and the decode steps'
        capacity and drops. Returns the mean count of experts a decode
        step's MoE layer reads."""
        b, t = padded.shape
        n_moe = max(1, len(calls) // new)
        pre, dec = calls[:n_moe], calls[n_moe:]
        kept = sum(int(r["kept"].sum()) for r in pre)
        emb = params["embed"]["table"][torch.as_tensor(
            padded, device=self.dev).long()].to(torch.float32)
        emb = emb.reshape(-1, pre[0]["group"], cfg.d_model)
        emb_cos = torch.nn.functional.cosine_similarity(
            emb, emb.mean(dim=1, keepdim=True), dim=-1)
        line.update(
            prefill_groups=[r["groups"] for r in pre],
            prefill_group=pre[0]["group"], prefill_cap=pre[0]["cap"],
            prefill_load_max=[r["load_max"] for r in pre],
            prefill_fewest_experts_a_group=[r["experts_chosen"]
                                            for r in pre],
            prefill_dropped_share=1 - kept / (n_moe * b * t * cfg.moe_top_k),
            router_input_cos_mean=[r["input_cos_mean"] for r in pre],
            router_input_cos_min=[r["input_cos_min"] for r in pre],
            embedding_cos_mean=float(emb_cos.mean()),
            embedding_rms=float(emb.pow(2).mean().sqrt()),
            decode_cap=dec[0]["cap"] if dec else None,
            decode_dropped=sum(int(r["kept"].size * cfg.moe_top_k
                                   - r["kept"].sum()) for r in dec))
        return float(np.mean([r["experts_used"] for r in dec]))

    def decode_vs_prefill(self, cfg, params, toks, inputs=TOKENS_ONLY, *,
                          faults=()):
        """(b)'s two sides for ``toks`` (B, T) (after ``inputs``' patches;
        with its frames): the logits of a decode step at T - 1 (an enc-dec
        step with the encoder memory of the frames) on the f32 caches of a
        prefill of ``toks[:, :-1]``, the last-token logits of a prefill of
        ``toks``, the MoE routes of the two prefills (RouteLog calls), and
        for each of ``faults`` the logits of that decode step with the
        fault planted, on a copy of the caches (``planted_decode``)."""
        from repro_torch import tree
        from repro_torch.models import model as M
        b, t = toks.shape
        s_max = t + inputs.extra_tokens
        caches = M.make_caches(cfg, b, s_max, torch.float32, device=self.dev)
        with RouteLog() as part:
            caches, _ = M.prefill(cfg, params, inputs.prefill(
                cfg, toks[:, :-1], self.dev), caches)
        memory = inputs.memory(cfg, params, self.dev)
        planted = {}
        for fault in faults:
            c, copy, last, pos = planted_decode(
                fault, cfg, tree.map(torch.clone, caches), toks, t)
            planted[fault] = M.decode_step(c, params, copy, inputs.decode(
                last, pos, self.dev, memory))[1]
            del copy
        _, l_dec = M.decode_step(cfg, params, caches, inputs.decode(
            toks[:, -1:], t - 1, self.dev, memory))
        del caches
        caches = M.make_caches(cfg, b, s_max, torch.float32, device=self.dev)
        with RouteLog() as full:
            _, l_full = M.prefill(cfg, params,
                                  inputs.prefill(cfg, toks, self.dev),
                                  caches)
        return l_dec, l_full, part.calls, full.calls, planted

    def lm_decode_check(self, cfg, params, padded, line,
                        inputs=TOKENS_ONLY) -> None:
        """(b) a decode step against a prefill, request by request, in the
        model's dtype, with the family's ``inputs``: every request whose
        last prompt token kept its expert slots in the batch's prefill;
        for a MoE model also the LM_NODROP requests, each with both
        prefills run alone at a capacity that drops nothing; for a stack
        of blocks or units (dense, SSM, hybrid, enc-dec, VLM) also its
        first quarter and half (``depth_cut``), and the whole stack with
        the weights cast to f32."""
        from repro_torch import tree
        toks = torch.as_tensor(padded, device=self.dev)
        b, t = toks.shape

        def rel(l_dec, l_full):
            return [errors([l_dec[i]], [l_full[i]])[1]
                    for i in range(l_dec.shape[0])]

        # each planted fault's reading, the smallest over the requests
        faults = {}

        def read_faults(planted, l_full, at):
            for f, lg in planted.items():
                faults.setdefault(f, {})[at] = min(rel(lg, l_full))

        l_dec, l_full, _, full, planted = self.decode_vs_prefill(
            cfg, params, toks, inputs, faults=b_faults(cfg))
        read_faults(planted, l_full, stack_depth(cfg))
        del planted
        kept = np.ones(b, bool)
        for r in full:
            kept &= r["kept"].reshape(b, t)[:, -1] == cfg.moe_top_k
        got = rel(l_dec, l_full)
        line.update(b_rel=got, b_last_token_dropped=int((~kept).sum()),
                    b_rel_kept_max=max([r for r, k in zip(got, kept) if k],
                                       default=None))
        del l_dec, l_full
        print(f"{cfg.name} (b): {int((~kept).sum())} of {b} requests' last "
              f"tokens lost a slot in the prefill", flush=True)
        if cfg.family == "moe":
            # At the batch's capacity the decode reads caches written by a
            # prefill of T - 1 tokens, whose groups and drops differ from
            # the T-token prefill's. Those caches agree only while no
            # attention reads a MoE block's output: in a one-unit cut the
            # MoE block is the stack's last sub-block and feeds the logits
            # alone. A deeper cut is held by the no-drop requests only.
            assert cfg.n_layers == cfg.moe_every, \
                "(b) at the batch's capacity holds for a one-unit cut only"
            # alone, at capacity factor E / k: cap = g, no drop in either
            # prefill (the reference's dispatch is (n, g, E, cap): 8 x 1024
            # tokens at cap = g would be 2e10 entries)
            free = dataclasses.replace(
                cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
            nodrop, dropped, caps = [], 0, []
            for i in LM_NODROP:
                l_dec, l_full, part, full, _ = self.decode_vs_prefill(
                    free, params, toks[i:i + 1])
                dropped += sum(int(r["kept"].size * cfg.moe_top_k
                                   - r["kept"].sum()) for r in part + full)
                caps.append([part[0]["cap"], full[0]["cap"]])
                nodrop.extend(rel(l_dec, l_full))
                del l_dec, l_full
            line.update(b_nodrop_requests=list(LM_NODROP),
                        b_nodrop_caps=caps, b_nodrop_dropped=dropped,
                        b_rel_nodrop=nodrop, b_rel_nodrop_max=max(nodrop))
        if cfg.family != "moe":
            # bf16 rounding grows with the depth; a fault of the decode
            # path does not vanish in f32
            by_depth = {stack_depth(cfg): max(got)}
            for frac in (4, 2):
                cut, head = depth_cut(cfg, params, frac)
                d = stack_depth(cut)
                if cut.n_layers == cfg.n_layers or d in by_depth:
                    continue
                l_dec, l_full, _, _, planted = self.decode_vs_prefill(
                    cut, head, toks, inputs, faults=b_faults(cut))
                by_depth[d] = max(rel(l_dec, l_full))
                read_faults(planted, l_full, d)
                del l_dec, l_full, planted, head
            f32 = tree.map(lambda x: x.to(torch.float32), params)
            l_dec, l_full, _, _, planted = self.decode_vs_prefill(
                dataclasses.replace(cfg, dtype="float32"), f32, toks, inputs,
                faults=b_faults(cfg))
            read_faults(planted, l_full, "f32")
            line.update(b_rel_by_depth=by_depth,
                        b_tol_by_depth={d: decode_tol(cfg, d)
                                        for d in by_depth},
                        b_faults=faults,
                        b_rel_f32=max(rel(l_dec, l_full)))
            del f32, l_dec, l_full, planted

    def lm_cpu_parity(self, cfg, g, line):
        """(a) LM_CUT["layers"] layers at full width (a hybrid: one unit and
        its tail, LM_CUT["hybrid_layers"]; an enc-dec model as many encoder
        layers, over LM_CUT["frames"] frames; a VLM the first
        LM_CUT["grid"]**2 patches), at most LM_CUT["experts"] experts, in
        f32: the card's greedy loop against the port's CPU path fed the
        card's tokens, on prompts cut to at most LM_CUT["prompt"] tokens
        (patches included): logits, and every MoE call's dispatch mask, up
        to the first step whose router gap (the top-(k+1) probabilities'
        closest pair) lies under the tolerance; tokens up to the first step
        whose router or logit top-2 gap does."""
        from repro_torch import tree
        from repro_torch.models import model as M
        layers = LM_CUT["hybrid_layers"] if cfg.family == "hybrid" else \
            LM_CUT["layers"]
        cut = dataclasses.replace(
            cfg, n_layers=layers, dtype="float32",
            enc_layers=min(cfg.enc_layers, LM_CUT["layers"]),
            moe_experts=min(cfg.moe_experts, LM_CUT["experts"]))
        inputs = g.get("inputs", TOKENS_ONLY).cut(LM_CUT["frames"],
                                                 LM_CUT["grid"])
        t0 = time.perf_counter()
        params, _ = M.init_model(SEED + 1, cut, device=self.dev)
        host = tree.map(lambda x: x.cpu(), params)
        room = LM_CUT["prompt"] - inputs.extra_tokens
        lens = g["rng"].integers(room // 2, room + 1, len(g["prompts"]))
        padded = left_pad([p[:n] for p, n in zip(g["prompts"], lens)])
        new = LM_CUT["new"]
        s_max = inputs.extra_tokens + padded.shape[1] + new
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with RouteLog(masks=True) as dev_log:
            tok_dev, lg_dev = self.gen_manual(cut, params, padded, new, s_max,
                                              self.dev, inputs=inputs)
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with RouteLog(masks=True) as cpu_log:
            tok_cpu, lg_cpu = self.gen_manual(cut, host, padded, new, s_max,
                                              torch.device("cpu"),
                                              forced=tok_dev, inputs=inputs)
        cpu_s = time.perf_counter() - t0
        # the control the limit must see: the card's prefill with TF32
        # matmuls (10 mantissa bits) against the CPU's
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lg_tf32 = self.prefill_last(cut, params, padded, inputs).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        del params, host
        tol = lm_tol(cut, "cpu")
        tf32_rel = errors([lg_tf32], [lg_cpu[0]])[1]
        rel = [errors([a], [c])[1] for a, c in zip(lg_dev, lg_cpu)]
        per_step = max(1, len(dev_log.calls) // new)
        close_router = None
        for i in range(0, len(dev_log.calls), per_step):
            if min(r["margin"] for r in dev_log.calls[i:i + per_step]) < tol:
                close_router = i // per_step
                break
        close_logit = None
        for step, lg in enumerate(lg_dev):
            top = torch.topk(lg.double(), 2, dim=-1).values
            if float((top[:, 0] - top[:, 1]).min()
                     / lg.double().abs().max()) < tol:
                close_logit = step
                break
        upto = min(x for x in (close_router, close_logit, new)
                   if x is not None)
        held = new if close_router is None else close_router
        masks_equal = all(
            torch.equal(a["mask"], c["mask"]) for a, c in
            zip(dev_log.calls[:held * per_step],
                cpu_log.calls[:held * per_step]))
        line.update(a_layers=cut.n_layers, a_enc_layers=cut.enc_layers,
                    a_experts=cut.moe_experts,
                    a_extra_tokens=inputs.extra_tokens,
                    a_frames=0 if inputs.frames is None else
                    inputs.frames.shape[1],
                    a_held_steps=held,
                    a_prompt_lens=lens.tolist(), a_padded=padded.shape[1],
                    a_new=new, a_logits_rel=rel, a_tf32_rel=tf32_rel,
                    a_tol=tol,
                    a_first_router_close_step=close_router,
                    a_first_logit_close_step=close_logit,
                    a_moe_calls=len(dev_log.calls),
                    a_masks_equal_to_close=masks_equal,
                    a_tokens_equal_to_close=bool(np.array_equal(
                        tok_dev[:, :upto], tok_cpu[:, :upto])),
                    a_init_s=init_s, a_card_s=dev_s, a_cpu_s=cpu_s)
        print(f"{cfg.name} (a): router close step {close_router}, logit "
              f"close step {close_logit}", flush=True)

    def par_config(self):
        """PAR_ARCH at its published widths cut to PAR_LAYERS layers (a
        rehearsal on the CPU sets ``self.par_cfg`` to a small config)."""
        from repro_torch.configs import get_arch
        return self.par_cfg or dataclasses.replace(get_arch(PAR_ARCH),
                                                   n_layers=PAR_LAYERS)

    def phase_parallel(self):
        """Data- and model-parallel training on the card: PAR_ARCH at its
        published width cut to PAR_LAYERS layers, PAR's traffic, each plan
        of PAR_PLANS: D = 1 on NCCL in this process ((1, 1) mesh), then
        PAR_SPAWNS (gloo ranks sharing the card), and with more cards
        NCCL a rank a card. Checks: every rank the same loss bits and
        logical arrays; each plan within PAR_TOL of the one-device f32
        run; the planted fault (a rank skipping the data reduce) above
        those limits; elastic restore (saved under model = 2 after step
        1, restored under data x model with FSDP and under D = 1: the
        same bits, step 2's loss within PAR_TOL["restore"]);
        compressed_psum at D = 2 and 4 on CUDA tensors against its
        formula; the FSDP plan's gathers (fsdp_checks); no port kernel
        launched. Then the fsdp_wide part (par_wide)."""
        import multiprocessing as mp
        import pickle
        import shutil

        import torch.distributed as dist
        from repro_torch.kernels import LAUNCHES, reset_launches
        from repro_torch.launch import init_lane_group, make_host_mesh
        from repro_torch.sharding import api as shapi
        t_phase = time.perf_counter()
        job_dir = Path(__file__).resolve().parent / "build" / "parallel"
        shutil.rmtree(job_dir, ignore_errors=True)
        job_dir.mkdir(parents=True)
        backend = "nccl" if self.dev.type == "cuda" else "gloo"
        cards = torch.cuda.device_count() if self.dev.type == "cuda" else 0
        plans = dict(PAR_PLANS)
        spawns = [(w, "gloo", names) for w, names in PAR_SPAWNS]
        if cards >= plans[PAR_NCCL][0]:
            spawns.append((plans[PAR_NCCL][0], "nccl", (PAR_NCCL,)))
        for name, why in PAR_GLOO_REFUSED.items():
            emit({"phase": "parallel", "plan": name, "gloo_refuses": why,
                  "runs": "on NCCL" if cards >= plans[name][0] else
                  f"on NCCL with {plans[name][0]} cards; this machine has "
                  f"{cards}"})
        cfg = self.par_config()
        job = {"cfg": cfg, "ckpt": str(job_dir / "ckpt"), "plans": plans,
               "device_type": self.dev.type, "par": dict(PAR)}
        with open(job_dir / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        seconds, summary, launches, want = {}, {}, {}, {}
        reset_launches()

        def group(tag):
            init_lane_group(backend, 0, 1, store=dist.FileStore(
                str(job_dir / f"store_{tag}"), 1), timeout_s=PAR_TIMEOUT_S)

        def check_restore(rs, where):
            assert rs["bit_equal"], f"parallel restore {where}: {rs}"
            assert abs(rs["loss2"] - want["loss2"]) <= \
                PAR_TOL["restore"] * abs(want["loss2"]), \
                f"parallel restore {where}: {rs} vs {want['loss2']}"

        def fsdp_checks(name, recs, line):
            """FSDP's gathers a unit at a time: every rank's census of
            step 2 records the all-gathers par_fsdp_gathers reckons (count
            and bytes), and no rank's peak rises above PAR_FSDP_PEAK."""
            ag = [{"count": r["collectives"]["counts"].get("all-gather", 0),
                   "bytes": r["collectives"]["bytes"].get("all-gather",
                                                          0.0)}
                  for r in recs]
            want = {"count": recs[0]["collectives"]["reckoned"][
                "fsdp_gathers"], "bytes": recs[0]["collectives"][
                "reckoned"]["fsdp_gather_census_bytes"]}
            peaks = [t["max_memory_allocated"] for t in line["ranks"]]
            emit({"phase": "parallel", "plan": name, "fsdp_gathers": ag,
                  "reckoned": want, "peak_gb": [x / 1e9 for x in peaks],
                  "peak_limit_gb": PAR_FSDP_PEAK / 1e9,
                  "nvidia_smi": nvidia_smi()})
            for a in ag:
                assert a["count"] == want["count"] and \
                    a["bytes"] == want["bytes"], \
                    f"parallel {name}: all-gathers {a} vs reckoned {want}"
            assert max(peaks) <= PAR_FSDP_PEAK, \
                f"parallel {name}: peak {max(peaks)} over {PAR_FSDP_PEAK}"

        def report(world, bk, by_rank):
            """Emit and check one world's plans as soon as they return."""
            for name in by_rank[0]:
                if name in ("compress", "launches"):
                    continue
                recs = [r[name] for r in by_rank]
                rec = recs[0]
                _, model, fsdp, _ = plans[name]
                line = {"phase": "parallel", "plan": name, "world": world,
                        "backend": bk, "arch": cfg.name,
                        "layers": cfg.n_layers, "d_model": cfg.d_model,
                        "tokens_per_step": PAR["batch"] * PAR["seq"],
                        "tol": PAR_TOL,
                        **{k: rec[k] for k in ("losses", "loss_err",
                                                "params_err", "m_err",
                                                "sharded_leaves")},
                        "same_loss_bits": all(r["loss_hex"]
                                              == rec["loss_hex"]
                                              for r in recs),
                        "same_arrays": par_same_arrays(
                            [r["digest"] for r in recs]),
                        "params_err_ranks": max(r["params_err"]
                                                for r in recs),
                        "m_err_ranks": max(r["m_err"] for r in recs),
                        "ranks": [r["times"] for r in recs],
                        "checks_s": [r["checks_s"] for r in recs],
                        "nvidia_smi": nvidia_smi()}
                for k in ("fault", "restore"):
                    if k in rec:
                        line[k] = [r[k] for r in recs]
                emit(line)
                summary[f"{bk} D={world} {name}"] = {
                    "step_s": max(t["step_s"] for t in line["ranks"]),
                    "collective_host_s": max(t["collective_host_s"]
                                             for t in line["ranks"])}
                if name == PAR_SAVE:
                    want["loss2"] = rec["losses"][1]
                if name == PAR_CENSUS:
                    self.par_census = [r["collectives"] for r in recs]
                if name == PAR_NCCL:
                    fsdp_checks(name, recs, line)
                assert line["same_loss_bits"] and line["same_arrays"], \
                    f"parallel {name}: the ranks differ"
                assert rec["loss_err"] <= PAR_TOL["loss"], \
                    f"parallel {name}: loss {rec['loss_err']}"
                assert line["params_err_ranks"] <= PAR_TOL["params"], \
                    f"parallel {name}: params {line['params_err_ranks']}"
                assert line["m_err_ranks"] <= PAR_TOL["m"], \
                    f"parallel {name}: moments {line['m_err_ranks']}"
                assert (rec["sharded_leaves"] > 0) == (model > 1 or fsdp), \
                    f"parallel {name}: {rec['sharded_leaves']} leaves split"
                for f in line.get("fault", ()):
                    assert f["params_err"] > PAR_TOL["params"] and \
                        f["m_err"] > PAR_TOL["m"], \
                        f"parallel {name}: the planted fault read {f}"
                for rs in line.get("restore", ()):
                    assert (rs["data_sharded_leaves"] > 0) == fsdp, rs
                    check_restore(rs, f"{bk} D={world} {name}")
            if "compress" in by_rank[0]:
                comp = [r["compress"] for r in by_rank]
                emit({"phase": "parallel", "compressed_psum": comp,
                      "world": world, "backend": bk})
                for c in comp:
                    assert c["out_err"] <= PAR_TOL["compress"] and \
                        c["res_err"] <= PAR_TOL["compress"], \
                        f"compressed_psum D={world}: {c}"
            for r in by_rank:
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v

        t0 = time.perf_counter()
        group("one")
        try:
            one = par_plans(1, ("D=1",), backend, self.dev, job)
        finally:
            dist.destroy_process_group()
        seconds[f"{backend} D=1"] = time.perf_counter() - t0
        report(1, backend, [one])
        ctx = mp.get_context("spawn")
        for world, bk, names in spawns:
            t0 = time.perf_counter()
            procs = [ctx.Process(target=parallel_rank, args=(
                r, world, bk, names, str(job_dir))) for r in range(world)]
            for q in procs:
                q.start()
            deadline = time.monotonic() + PAR_TIMEOUT_S
            for q in procs:
                q.join(max(deadline - time.monotonic(), 0.0))
            for q in procs:
                if q.is_alive():
                    q.kill()
                    q.join()
            codes = [q.exitcode for q in procs]
            assert codes == [0] * world, \
                f"parallel {bk} D={world}: rank exit codes {codes}"
            by_rank = []
            for r in range(world):
                with open(job_dir / f"{bk}{world}_rank{r}.pkl", "rb") as f:
                    by_rank.append(pickle.load(f))
            seconds[f"{bk} D={world}"] = time.perf_counter() - t0
            report(world, bk, by_rank)
        # elastic restore under D = 1 (this process, NCCL)
        t0 = time.perf_counter()
        group("restore")
        try:
            mesh = make_host_mesh(device_type=self.dev.type)
            restore1 = par_restore(
                dataclasses.replace(cfg, dtype="float32"), mesh,
                shapi.tp_plan(data_axes=("data",), model_axis="model"), 1,
                job["ckpt"], self.dev)
        finally:
            dist.destroy_process_group()
        seconds[f"{backend} D=1 restore"] = time.perf_counter() - t0
        for k, v in LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        self.par_wide(cards, job_dir)
        seconds["fsdp_wide"] = time.perf_counter() - t0
        shutil.rmtree(job_dir, ignore_errors=True)
        emit({"phase": "parallel", "restore_d1": restore1,
              "uninterrupted_loss2": want["loss2"], "summary": summary,
              "cards": cards, "seconds": seconds, "launches": launches,
              "phase_s": time.perf_counter() - t_phase})
        check_restore(restore1, "D=1")
        assert not any(launches.values()), \
            f"the parallel training path launched port kernels: {launches}"

    def par_wide(self, cards: int, job_dir: Path) -> None:
        """The fsdp_wide part: WIDE_PLANS on WIDE["world"] NCCL ranks, a
        card each, where the machine has the cards (else one line a plan
        says so). First each plan's fake world-4 trace (its peak a rank
        decides whether it runs), then (b)'s one-card forwards in this
        process, then the ranks. Checks: (a) every rank the same loss bits
        and logical arrays; (b) step 1's loss within WIDE_TOL of the
        one-card forward, the planted fault above it; (c) step 2's loss
        below step 1's; (d) every rank's allocator peak under the card's
        80 GB and at most WIDE_MEM above the traced peak; (e) no port kernel
        launched; and W1's all-gathers, counted by each rank's census,
        those par_fsdp_gathers reckons."""
        import multiprocessing as mp
        import pickle

        from repro_torch.kernels import LAUNCHES, reset_launches
        world, names = WIDE["world"], list(WIDE_PLANS)
        if self.dev.type != "cuda" or cards < world:
            for name in names:
                cfg = wide_config(name)
                emit({"phase": "parallel", "plan": f"fsdp_wide {name}",
                      "arch": cfg.name, "layers": cfg.n_layers,
                      "runs": f"on NCCL with {world} cards; this machine "
                      f"has {cards}"})
            return
        t_part = time.perf_counter()
        procs = wide_trace_start(job_dir, names, self.dev.type)
        for proc in procs.values():
            dry_wait(proc, DRY_TIMEOUT_S)
        traced = {name: wide_trace_read(job_dir, name) for name in names}
        self.wide_traced = traced
        run = [n for n in names if traced[n]["peak"] <= WIDE_LEAVE_OUT]
        for name in names:
            if name not in run:
                emit({"phase": "parallel", "plan": f"fsdp_wide {name}",
                      "left_out": "its traced peak a rank is over "
                      f"{WIDE_LEAVE_OUT / 1e9} GB",
                      "traced_peak_gb": traced[name]["peak"] / 1e9})
        reset_launches()
        torch.cuda.empty_cache()
        forward = {n: wide_forward(wide_config(n), self.dev) for n in run}
        launches = dict(LAUNCHES)
        held = torch.cuda.memory_allocated()
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=wide_rank, args=(r, world, run,
                                                     str(job_dir)))
                 for r in range(world)]
        for q in procs:
            q.start()
        deadline = time.monotonic() + WIDE_TIMEOUT_S
        for q in procs:
            q.join(max(deadline - time.monotonic(), 0.0))
        for q in procs:
            if q.is_alive():
                q.kill()
                q.join()
        codes = [q.exitcode for q in procs]
        assert codes == [0] * world, f"fsdp_wide: rank exit codes {codes}"
        by_rank = []
        for r in range(world):
            with open(job_dir / f"wide_rank{r}.pkl", "rb") as f:
                by_rank.append(pickle.load(f))
        ranks_s = time.perf_counter() - t0
        for r in by_rank:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        smi = nvidia_smi()
        tokens = WIDE["batch"] * WIDE["seq"]
        for name in run:
            cfg = wide_config(name)
            recs = [r[name] for r in by_rank]
            rec, tr, fw = recs[0], traced[name], forward[name]["loss"]
            step_s = max(r["step_s"][-1] for r in recs)
            flops = 6.0 * cfg.active_param_count() * tokens
            line = {
                "phase": "parallel", "plan": f"fsdp_wide {name}",
                "arch": cfg.name, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "params": cfg.param_count(),
                "world": world, "backend": "nccl",
                "mesh": {"data": world // WIDE["model"],
                         "model": WIDE["model"]},
                "tokens_per_step": tokens, "losses": rec["losses"],
                "same_loss_bits": all(r["loss_hex"] == rec["loss_hex"]
                                      for r in recs),
                "same_arrays": par_same_arrays([r["digest"]
                                                for r in recs]),
                "forward_loss": fw, "forward_s": forward[name]["seconds"],
                "forward_max_allocated_gb":
                    forward[name]["max_memory_allocated"] / 1e9,
                "b_err": abs(rec["losses"][0] - fw) / abs(fw),
                "fault_loss": rec["fault_loss"],
                "fault_err": abs(rec["fault_loss"] - fw) / abs(fw),
                "tol": WIDE_TOL, "mem_margin": WIDE_MEM,
                "traced_gb": {k: tr[k] / 1e9 for k in ("args", "temp",
                                                       "peak")},
                "peak_gb": [[x / 1e9 for x in r["peak"]] for r in recs],
                "before_gb": [[x / 1e9 for x in r["before"]]
                              for r in recs],
                "census_temp_gb": [r["census"]["temp"] / 1e9 for r in recs],
                "census_args_gb": [r["census_args"] / 1e9 for r in recs],
                "allocated_at_census_peak_gb": [
                    r["census"]["allocated_at_peak"] / 1e9 for r in recs],
                "largest_at_census_peak_gb": [
                    x / 1e9 for x in rec["census"]["largest_at_peak"]],
                "step_s": [r["step_s"] for r in recs],
                "init_s": [r["init_s"] for r in recs],
                "seconds_per_step": step_s,
                "collective_host_s": max(r["collective_host_s"]
                                         for r in recs),
                "nccl_device_s": max(r["nccl_device_s"] for r in recs),
                "bytes_per_step": rec["census"]["bytes"],
                "collectives": rec["census"]["counts"],
                "traced_collectives": {"bytes": tr["bytes"],
                                       "counts": tr["counts"]},
                "reckoned": rec["reckoned"],
                "bf16_peak_share": flops / step_s / world / 989e12,
                "parent_held_gb": held / 1e9, "nvidia_smi": smi}
            emit(line)
            assert line["same_loss_bits"] and line["same_arrays"], \
                f"fsdp_wide {name}: the ranks differ"
            assert line["b_err"] <= WIDE_TOL, \
                f"fsdp_wide {name}: (b) {line['b_err']} over {WIDE_TOL}"
            assert line["fault_err"] > WIDE_TOL, \
                f"fsdp_wide {name}: the planted fault read " \
                f"{line['fault_err']}, not above {WIDE_TOL}"
            assert rec["losses"][1] < rec["losses"][0], \
                f"fsdp_wide {name}: (c) losses {rec['losses']}"
            for r in recs:
                peak = max(r["peak"])
                assert peak < CARD_HBM, f"fsdp_wide {name}: (d) {peak}"
                assert r["peak"][-1] <= (1 + WIDE_MEM) * tr["peak"], \
                    f"fsdp_wide {name}: (d) peak {r['peak']} over the " \
                    f"traced {tr['peak']}"
            if name == "W1":
                for r in recs:
                    got = (r["census"]["counts"].get("all-gather", 0),
                           r["census"]["bytes"].get("all-gather", 0.0))
                    want = (r["reckoned"]["fsdp_gathers"],
                            r["reckoned"]["fsdp_gather_census_bytes"])
                    assert got == want, \
                        f"fsdp_wide {name}: all-gathers {got} vs {want}"
        emit({"phase": "parallel", "part": "fsdp_wide", "plans": run,
              "launches": launches, "ranks_s": ranks_s,
              "part_s": time.perf_counter() - t_part})
        assert not any(launches.values()), \
            f"fsdp_wide launched port kernels: {launches}"

    def phase_train_families(self):
        """The SSM, hybrid, enc-dec and VLM families trained on the card
        (TRAIN_FAMILIES, FAM's traffic, bf16, AdamW warmup-cosine): (a)
        the card against the port's CPU path, f32, one step at (a)'s cut,
        with TF32 matmuls as the control that must read above the limit;
        (b) the bf16 loss at step 0 against f32 at the same depth; (c)
        the last loss below the first; (g) no port kernel launched. The
        CPU's steps of (a) run on a thread while the card trains."""
        import threading

        from repro_torch.kernels import LAUNCHES, reset_launches
        t_phase = time.perf_counter()
        reset_launches()
        jobs, cpu = [], {}

        def cpu_worker():
            for name, a in jobs:
                t0 = time.perf_counter()
                try:
                    cpu[name] = fam_a_step(a, torch.device("cpu"))
                except BaseException as e:  # raised below
                    cpu[name] = e
                a["cpu_s"] = time.perf_counter() - t0

        lines = []
        for name, layers in TRAIN_FAMILIES:
            jobs.append((name, self.family_a_inputs(name)))
        worker = threading.Thread(target=cpu_worker, daemon=True)
        worker.start()
        try:
            for (name, layers), (_, a) in zip(TRAIN_FAMILIES, jobs):
                a["card"] = fam_a_step(a, self.dev)
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    a["tf32"] = fam_a_step(a, self.dev)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
                lines.append(self.family_train(name, layers))
                self.free_lm("train_families")
        finally:
            worker.join()
        for line, (name, a) in zip(lines, jobs):
            got = cpu[name]
            if isinstance(got, BaseException):
                raise got
            self.family_a_check(a, got, line)
        launches = dict(LAUNCHES)
        emit({"phase": "train_families", "launches": launches,
              "seconds": time.perf_counter() - t_phase})
        assert not any(launches.values()), \
            f"the family training launched port kernels: {launches}"

    def family_train(self, name, layers) -> dict:
        """(b), the bf16 run of FAM["steps"] steps and (c) for one family
        (its (a) lines are added when the CPU's steps are in)."""
        from repro_torch import tree
        from repro_torch.configs import get_arch
        from repro_torch.launch import steps
        from repro_torch.models import model as M
        from repro_torch.optim import AdamW, warmup_cosine
        t0 = time.perf_counter()
        published = get_arch(name)
        cfg = dataclasses.replace(published, n_layers=layers)
        line = {"phase": "train_families", "arch": name, "family":
                cfg.family, "layers": layers, "of_layers":
                published.n_layers, "enc_layers": cfg.enc_layers,
                "d_model": cfg.d_model, "dtype": cfg.dtype,
                "param_count": cfg.param_count(), "nvidia_smi": nvidia_smi()}
        batch = fam_batch(cfg, FAM["batch"], fam_text(cfg), self.dev,
                          frames=FAM["frames"], grid=FAM["grid"])
        params, _ = M.init_model(SEED, cfg, device=self.dev)
        # (b) the step-0 loss in bf16 against f32 at the same depth
        with torch.no_grad():
            l16 = float(M.loss_fn(cfg, params, batch)[0])
            p32 = tree.map(lambda x: x.to(torch.float32), params)
            l32 = float(M.loss_fn(dataclasses.replace(
                cfg, dtype="float32"), p32, batch)[0])
            del p32
        torch.cuda.empty_cache()
        line.update(b_loss_bf16=l16, b_loss_f32=l32,
                    b_rel=abs(l16 - l32) / abs(l32))
        assert line["b_rel"] <= TRAIN_TOL["bf16"], f"(b) {name} {line}"
        opt = AdamW(lr=warmup_cosine(FAM["lr"], 1, FAM["steps"]))
        state = opt.init(params)
        step = steps.build_train_step(cfg, optimizer=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for _ in range(FAM["steps"]):
            t1 = time.perf_counter()
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
            step_s.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        del params, state
        positions = fam_positions(cfg, FAM["batch"])
        sps = float(np.median(step_s[1:]))
        line.update(
            losses=losses, step_s=step_s, seconds_per_step=sps,
            positions_per_step=positions, tokens_per_s=positions / sps,
            bf16_peak_share=6 * cfg.param_count() * positions / sps
            / BF16_PEAK, max_memory_allocated=peak,
            seconds=time.perf_counter() - t0)
        emit(line)
        # (c) the loss falls
        assert losses[-1] < losses[0], f"(c) {name}: {losses}"
        return line

    def family_a_inputs(self, name) -> dict:
        """(a)'s config, parameters (drawn on the card, then copied to the
        host) and batch for one family."""
        from repro_torch import tree
        from repro_torch.configs import get_arch
        from repro_torch.models import model as M
        cut = fam_cut(get_arch(name))
        params = tree.map(lambda x: x.cpu(), M.init_model(
            SEED, cut, device=self.dev)[0])
        return {"cut": cut, "params": params,
                "zero": [not bool(torch.any(x)) for x in tree.leaves(params)],
                "names": fam_names(params),
                "batch": fam_batch(cut, FAM_A["batch"], FAM_A["seq"],
                                   torch.device("cpu"),
                                   frames=FAM_A["frames"], grid=FAM_A["grid"])}

    def family_a_check(self, a, cpu, line) -> None:
        """(a): the card's step against the CPU's, the loss within
        ``lm_tol(cfg, "cpu")`` relative and the parameters by
        ``fam_param_ratio``'s rules; the TF32 control above the limit."""
        cut = a["cut"]
        tol = lm_tol(cut, "cpu")
        (l_dev, p_dev), (l_tf, p_tf), (l_cpu, p_cpu) = a["card"], a["tf32"], \
            cpu
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        ratio = fam_param_ratio(p_dev, p_cpu, a["zero"], a["names"], tol)
        tf_loss = abs(l_tf - l_cpu) / abs(l_cpu)
        tf_ratio = fam_param_ratio(p_tf, p_cpu, a["zero"], a["names"], tol)
        out = dict(arch=line["arch"], a_cut=fam_cut_text(cut), a_tol=tol,
                   a_loss_card=l_dev, a_loss_cpu=l_cpu, a_loss_rel=loss_rel,
                   a_params_ratio=ratio, a_tf32_loss_rel=tf_loss,
                   a_tf32_params_ratio=tf_ratio, a_cpu_s=a["cpu_s"])
        line.update(out)
        emit({"phase": "train_families", **out})
        assert loss_rel <= tol and ratio["worst"] <= 1.0, \
            f"(a) {cut.name}: loss {loss_rel}, params {ratio}"
        assert max(tf_loss / tol, tf_ratio["worst"]) > 1.0, \
            f"(a) {cut.name}: the TF32 control read within the limit"

    def phase_dryrun(self):
        """The tooling analogs: (a) the dry-run CLI on the production
        meshes (DRY_CELLS, a process a cell, side by side) and the
        roofline CLI over their records; (b) the parallel phase's D = 1
        step run for real under utils.comms.StepCensus against its fake
        trace at world 1 (the same flops and op bytes), timed, with the
        allocator's peak; (c) the collectives PAR_CENSUS's gloo ranks
        recorded (the parallel phase) against the fake trace of that
        plan at world 4; (d) the port's quadlint clean and DRY_EXAMPLES
        on the card; (e) the fake world-4 traces of PAR_NCCL and of
        fsdp_wide's plans (those the parallel phase traced, where it
        ran), the all-gathers held to par_fsdp_gathers. (b)'s real step
        runs first, alone; then every other process starts, side by
        side."""
        import multiprocessing as mp
        import os
        import shutil
        import statistics

        import torch.distributed as dist
        from repro_torch.kernels import LAUNCHES, reset_launches
        from repro_torch.launch import init_lane_group, make_host_mesh
        from repro_torch.launch import shapes, steps
        from repro_torch.models import model as M
        from repro_torch.sharding import api as shapi
        from repro_torch.utils import comms
        t_phase = time.perf_counter()
        reset_launches()
        root = Path(__file__).resolve().parent
        out = root / "build" / "dryrun"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        cfg = self.par_config()
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        shape = f"train_{PAR['seq']}x{PAR['batch']}"
        cell = shapes.ShapeCell(shape, "train", PAR["seq"], PAR["batch"])
        _, model, fsdp, mb = PAR_PLANS[PAR_CENSUS]
        world = PAR_PLANS[PAR_CENSUS][0]
        world_e, model_e, _, mb_e = PAR_PLANS[PAR_NCCL]
        cuda = self.dev.type == "cuda"

        # (b) the real D = 1 step, counted, then timed, alone
        backend = "nccl" if cuda else "gloo"
        init_lane_group(backend, 0, 1, store=dist.FileStore(
            str(out / "store"), 1), timeout_s=PAR_TIMEOUT_S)
        try:
            mesh = make_host_mesh(device_type=self.dev.type)
            plan = shapi.tp_plan(data_axes=("data",), model_axis="model")
            params, axes = M.init_model(SEED, cfg16, device=self.dev)
            dp = shapi.distribute(params, mesh, shapi.param_shardings(
                plan, mesh, params, axes))
            del params
            opt = steps.default_optimizer()
            state = opt.init(dp)
            step = steps.build_train_step(cfg16, mesh, plan, opt)
            batch = {k: v.contiguous() for k, v in
                     par_batch(cfg16, self.dev).items()}
            dp, state, _ = step(dp, state, batch)       # warm
            real = comms.StepCensus()
            real_args = real.exclude((dp, state, batch))
            par_sync(self.dev)
            before = torch.cuda.memory_allocated() if cuda else 0
            par_peak(self.dev, reset=True)
            with real:
                dp, state, _ = step(dp, state, batch)
            par_sync(self.dev)
            peak = par_peak(self.dev)
            times = []
            for _ in range(DRY_STEPS):
                t0 = time.perf_counter()
                dp, state, _ = step(dp, state, batch)
                par_sync(self.dev)
                times.append(time.perf_counter() - t0)
            del dp, state
        finally:
            dist.destroy_process_group()
        if cuda:
            torch.cuda.empty_cache()

        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        one = dict(env, OMP_NUM_THREADS="1")
        py = sys.executable
        jobs = {f"a {a} {sh} {m}": (
            [py, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape",
             sh, "--mesh", m, "--out", str(out / "a"), "--device",
             self.dev.type], one)
            for a, sh, m in DRY_CELLS}
        jobs["d lint"] = ([py, "-m", "repro_torch.analysis",
                           str(root / "src" / "repro_torch")], env)
        for ex in DRY_EXAMPLES:
            jobs[f"d {ex}"] = ([py, str(root / "examples" / ex)]
                               + ([] if cuda else ["--device", "cpu"]), env)
        traces = {
            "b": dict(arch=cfg16.name, mesh_kind="host1x1", cfg=cfg16,
                      fsdp=False),
            "c": dict(arch=cfg32.name, mesh_kind=f"host{world // model}x"
                      f"{model}", cfg=cfg32, fsdp=fsdp, microbatches=mb),
            "e": dict(arch=cfg32.name, mesh_kind=f"host{world_e // model_e}"
                      f"x{model_e}", cfg=cfg32, fsdp=True,
                      microbatches=mb_e)}
        procs, ctx = {}, mp.get_context("spawn")
        if self.wide_traced is None:    # W1's trace, for (e)
            for name, proc in wide_trace_start(out, ("W1",),
                                               self.dev.type).items():
                procs[f"wide {name}"] = (proc, None)
        for name, (argv, e) in jobs.items():
            log = open(out / f"{name.replace(' ', '_')}.log", "w")
            procs[name] = (subprocess.Popen(argv, env=e, cwd=str(root),
                                            stdout=log,
                                            stderr=subprocess.STDOUT), log)
        for name, kw in traces.items():
            job = dict(kw, shape_name=shape, cell=cell, out_dir=out / name,
                       skip_delta=True, device=self.dev.type)
            (out / name).mkdir()
            proc = ctx.Process(target=dry_cell, args=(job, str(
                out / f"{name}.log")))
            proc.start()
            procs[name] = (proc, None)

        deadline = time.monotonic() + DRY_TIMEOUT_S
        codes, logs = {}, {}
        for name, (proc, log) in procs.items():
            codes[name] = dry_wait(proc, max(deadline - time.monotonic(),
                                             1.0))
            if log is not None:
                log.close()
            logs[name] = (out / f"{name.replace(' ', '_')}.log").read_text()
        smi = nvidia_smi()

        # (a) the production cells
        cells = []
        for a, sh, m in DRY_CELLS:
            rec = dry_record(out / "a", a, sh, m)
            line = {"phase": "dryrun", "part": "a", "arch": a, "shape": sh,
                    "mesh": m, "status": rec["status"],
                    "exit_code": codes[f"a {a} {sh} {m}"]}
            if rec["status"] == "ok":
                mem = rec["memory"]
                hbm = mem["argument_size_in_bytes"] \
                    + mem["temp_size_in_bytes"]
                line.update(n_chips=rec["n_chips"], fsdp=rec["fsdp"],
                            device=rec["device"], **rec["roofline"],
                            dominant=rec["dominant"],
                            roofline_fraction=rec["roofline_fraction"],
                            useful_flops_ratio=rec["useful_flops_ratio"],
                            hbm_gb_per_rank=hbm / 1e9,
                            card_gb=CARD_HBM / 1e9,
                            fits_the_card=hbm <= CARD_HBM,
                            memory=mem, trace_s=rec["trace_s"],
                            flops_full=rec["cost_raw"]["flops"],
                            flops_extrapolated=rec["cost_corrected"][
                                "flops"],
                            collectives_traced=rec["cost_raw"][
                                "coll_counts"])
            else:
                line["error"] = rec.get("error", rec.get("reason"))
            cells.append(line)
            emit(line)
        tables = {}
        for m in sorted({m for _, _, m in DRY_CELLS}):
            r = subprocess.run([py, "-m", "repro_torch.launch.roofline",
                                "--dir", str(out / "a"), "--mesh", m],
                               env=env, cwd=str(root), capture_output=True,
                               text=True, timeout=120)
            assert r.returncode == 0, f"roofline --mesh {m}: {r.stderr}"
            tables[m] = r.stdout
            print(r.stdout, flush=True)

        # (b) fake against real at world 1
        rb = dry_record(out / "b", cfg16.name, shape, "host1x1")
        assert rb["status"] == "ok", \
            f"(b) fake trace: {rb.get('error')}\n{logs['b'][-3000:]}"
        step_s = statistics.median(times)
        mf = rb["model_flops_info"]["model_flops"]
        tmem = rb["memory"]
        b = {"phase": "dryrun", "part": "b", "arch": cfg16.name,
             "layers": cfg16.n_layers, "tokens": PAR["batch"] * PAR["seq"],
             "flops_real": real.flops, "flops_fake": rb["cost_raw"]["flops"],
             "op_bytes_real": real.op_bytes,
             "op_bytes_fake": rb["cost_raw"]["bytes"],
             "step_s": step_s, "step_s_all": times,
             "bound_step_time_s": rb["bound_step_time_s"],
             "roofline": rb["roofline"], "dominant": rb["dominant"],
             "model_flops": mf, "measured_share": mf / 989e12 / step_s,
             "useful_flops_ratio": rb["useful_flops_ratio"],
             "hbm_gb_traced": (tmem["argument_size_in_bytes"]
                               + tmem["temp_size_in_bytes"]) / 1e9,
             "traced_args_gb": tmem["argument_size_in_bytes"] / 1e9,
             "traced_temp_gb": tmem["temp_size_in_bytes"] / 1e9,
             "census_args_gb": real_args / 1e9,
             "census_temp_gb": real.peak_bytes / 1e9,
             # the allocator: what was allocated before the counted step
             # (its arguments and whatever else this process holds) and
             # its peak in that step
             "allocated_before_gb": before / 1e9,
             "max_allocated_gb": peak / 1e9,
             "allocator_temp_gb": (peak - before) / 1e9,
             "pins": comms.pins(), "nvidia_smi": smi}
        emit(b)

        # (c) each gloo rank's collectives against the fake world-4 trace
        rc = dry_record(out / "c", cfg32.name, shape,
                        f"host{world // model}x{model}")
        assert rc["status"] == "ok", \
            f"(c) fake trace: {rc.get('error')}\n{logs['c'][-3000:]}"
        fake_bytes = dict(rc["cost_raw"]["coll_detail"],
                          total=rc["cost_raw"]["coll"])
        fake_counts = rc["cost_raw"]["coll_counts"]
        ranks = self.par_census or []
        c = {"phase": "dryrun", "part": "c", "plan": PAR_CENSUS,
             "fake": {"bytes": fake_bytes, "counts": fake_counts},
             "ranks": ranks,
             "reckoned_total": [r["reckoned"]["total"] for r in ranks],
             "counted_total": fake_bytes["total"], "nvidia_smi": smi}
        emit(c)

        # (e) FSDP a unit at a time: the all-gathers of the fake world-4
        # traces of the olmo FSDP plan and W1 against par_fsdp_gathers'
        # reckoning; fsdp_wide's traced peaks a rank
        mesh_e = f"host{world_e // model_e}x{model_e}"
        re_ = dry_record(out / "e", cfg32.name, shape, mesh_e)
        assert re_["status"] == "ok", \
            f"(e) fake trace: {re_.get('error')}\n{logs['e'][-3000:]}"
        wide = self.wide_traced or {"W1": wide_trace_read(out, "W1")}
        fplan = shapi.tp_plan(data_axes=("data",), model_axis="model",
                              fsdp=True)
        held = {}
        for name, c_, counts, nbytes, sizes, m_ in (
                (PAR_NCCL, cfg32, re_["cost_raw"]["coll_counts"],
                 re_["cost_raw"]["coll_detail"],
                 {"data": world_e // model_e, "model": model_e}, mb_e),
                ("fsdp_wide W1", wide_config("W1"), wide["W1"]["counts"],
                 wide["W1"]["bytes"], {"data": WIDE["world"] // WIDE[
                     "model"], "model": WIDE["model"]}, 1)):
            g = par_fsdp_gathers(c_, sizes, fplan, m_)
            held[name] = {"traced": {"count": counts.get("all-gather", 0),
                                     "bytes": nbytes.get("all-gather", 0.0)},
                          "reckoned": {"count": g["count"],
                                       "bytes": g["census_bytes"]}}
        e = {"phase": "dryrun", "part": "e", "all_gathers": held,
             "wide_traced_gb": {n: {k: w[k] / 1e9 for k in ("args", "temp",
                                                            "peak")}
                                for n, w in wide.items()},
             "wide_trace_device": {n: w["device"] for n, w in wide.items()},
             "card_gb": CARD_HBM / 1e9, "nvidia_smi": smi}
        emit(e)

        # (d) the lint and the example twins
        d = {"phase": "dryrun", "part": "d", "lint_exit": codes["d lint"],
             "lint_output": logs["d lint"][-2000:],
             "examples": {ex: dry_example(logs[f"d {ex}"])
                          for ex in DRY_EXAMPLES},
             "example_exits": {ex: codes[f"d {ex}"] for ex in DRY_EXAMPLES},
             "launches": dict(LAUNCHES),
             "phase_s": time.perf_counter() - t_phase}
        emit(d)

        for line in cells:
            key = (line["arch"], line["shape"], line["mesh"])
            assert line["status"] == "ok" and line["exit_code"] == 0, \
                f"(a) {key}: {line}"
            if key == DRY_FSDP_FITS:
                assert line["fsdp"] and line["fits_the_card"], \
                    f"(a) {key}: {line['hbm_gb_per_rank']} GB a rank"
        for name, code in codes.items():
            assert code == 0, f"dryrun {name}: exit {code}\n" \
                              f"{logs[name][-3000:]}"
        assert (b["flops_real"], b["op_bytes_real"]) == \
            (b["flops_fake"], b["op_bytes_fake"]) and b["flops_real"] > 0, \
            f"(b) real and fake differ: {b}"
        assert len(ranks) == world, f"(c) {len(ranks)} ranks recorded"
        for r in ranks:
            assert r["bytes"] == fake_bytes and r["counts"] == fake_counts, \
                f"(c) a rank's collectives differ from the trace: {r}"
        assert fake_counts["count"] > 0, "(c) the 2 x 2 plan traced none"
        for name, h in held.items():
            assert h["traced"] == h["reckoned"], \
                f"(e) {name}: all-gathers {h['traced']} vs {h['reckoned']}"
        for name, w in e["wide_traced_gb"].items():
            assert w["peak"] < CARD_HBM / 1e9, f"(e) {name}: {w}"
        assert d["lint_exit"] == 0 and not logs["d lint"].strip(), \
            f"(d) quadlint: {logs['d lint'][-2000:]}"
        for ex, got in d["examples"].items():
            assert got["ok"], f"(d) {ex}: {got}\n{logs['d ' + ex][-2000:]}"
        assert not any(LAUNCHES.values()), \
            f"the dryrun phase launched port kernels: {dict(LAUNCHES)}"
        shutil.rmtree(out / "store", ignore_errors=True)

    def phase_profile(self):
        """Where the time goes: for each path call, warm, its host
        seconds (no profiler) beside the device time of every kernel it
        launched (torch.profiler, one more call), so the idle share of
        the card is 1 - device / host; a call the profiler records nothing
        of raises, except the attention call, one K7 launch, which CUDA
        events time. Runs after the path phases, whose launch counts it
        does not touch."""
        from repro_torch.core import BIFSolver, Dense
        from repro_torch.kernels import ops
        d, sp = self.dense_problem(), self.sparse_problem()
        div = dict(lam_min=d["lmn"], lam_max=d["lmx"])
        siv = dict(lam_min=sp["lmn"], lam_max=sp["lmx"])

        def dense(backend, **kw):
            s = BIFSolver.create(**DENSE, backend=backend, **kw)
            return lambda: s.solve_batch(Dense(d["a"]), d["u"], **div)

        def sparse(backend):
            s = BIFSolver.create(**SPARSE, backend=backend)
            return lambda: s.solve_batch(sp["bell"], sp["u"], **siv)

        tp = self.trace_problem()
        tiv = dict(lam_min=tp["lmn"], lam_max=tp["lmx"], key=SEED)

        def logdet(backend, probes, b, cap):
            from repro_torch.core import logdet_quad
            s = BIFSolver.create(backend=backend, **cap)
            return lambda: logdet_quad(tp["trace_op"], probes, block_size=b,
                                       solver=s, **tiv)

        calls = {"dense solve_batch fused reorth": dense("fused",
                                                         reorth=True),
                 "dense solve_batch pallas": dense("pallas"),
                 "sparse solve_batch fused": sparse("fused"),
                 "sparse solve_batch pallas": sparse("pallas"),
                 "trace logdet_quad block pallas": logdet(
                     "pallas", PROBES, BLOCK, TRACE_BLOCK),
                 "trace logdet_quad scalar fused": logdet(
                     "fused", SCALAR_PROBES, 1, TRACE_SCALAR)}
        bp, ap = self.bilinear_problem(), self.attention_problem()
        k6 = BIFSolver.create(**BILINEAR, backend="pallas")
        calls["bilinear solve_batch pallas"] = lambda: k6.solve_batch(
            bp["op"], bp["u"], lam_min=bp["lmn"], lam_max=bp["lmx"])
        calls["attention mha_flash prefill"] = lambda: ops.mha_flash(
            ap["q"], ap["k"], ap["v"], causal=True)
        from repro_torch.core import dpp, greedy_map
        xp = self.apps_problem()
        k1 = BIFSolver.create(**APPS, backend="pallas")
        calls["apps dpp chain pallas"] = lambda: dpp.run_chain(
            dpp.dpp_step, Dense(d["a"]), xp["dpp_draws"], xp["init"],
            CHAIN_STEPS, d["lmn"], d["lmx"], max_iters=APPS["max_iters"],
            solver=k1)
        calls["apps greedy_map pallas"] = lambda: greedy_map(
            Dense(xp["greedy_a"]), GREEDY_K, *xp["greedy_iv"],
            max_iters=APPS["max_iters"], solver=k1)
        for backend in ("pallas", "fused"):
            calls[f"serve dense flush {backend}"] = \
                lambda b=backend: self.serve_run("dense", b)[2]
        calls.update(self.gen_profiled())
        for what, fn in calls.items():
            self.profile_one(what, fn)
        # the other families' prefill and decode step, a model at a time
        # (llama4 cut as the moe phase cuts it; the others whole)
        for name, layers, traffic in ((*MOE_ARCHS[0], LM), (*SSM_ARCH, LM),
                                      (*HYBRID_ARCH, LM),
                                      (*ENCDEC_ARCH, ENCDEC),
                                      (*VLM_ARCH, VLM)):
            self.free_lm(f"profile {name}")
            g = self.lm_problem(name, layers, traffic)
            for what, fn in self.lm_profiled(
                    name, g["cfg"], g["params"], g["padded"],
                    traffic["max_seq"], g["inputs"]).items():
                self.profile_one(what, fn)
            del g, fn
        self.free_lm("profile done")

    def profile_one(self, what, fn):
        """One call of the profile phase: warm (the trace phase warmed its
        own), its host seconds, then its kernels' device time."""
        from repro_torch.kernels import LAUNCHES
        if not what.startswith("trace"):   # the trace phase warmed these
            fn()
        res, host_s = self.run_timed(fn)
        t0 = time.perf_counter()
        if what.startswith("attention"):
            # one K7 launch, which the profiler does not record
            # (PERF.md): CUDA events around the call time that launch
            before = LAUNCHES["flash_attention"]
            kernels, dev_from = {}, "cuda events"
            dev_s = cuda_ms(fn, reps=1, warmup=0) / 1e3
            assert LAUNCHES["flash_attention"] - before == 1
        else:
            kernels = {k: ms for k, (ms, _) in device_kernels(fn).items()}
            dev_from = "profiler"
            dev_s = sum(kernels.values()) / 1e3
            if not kernels:
                raise RuntimeError(f"profile: torch.profiler recorded "
                                   f"no kernel of {what}")
        prof_s = time.perf_counter() - t0
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        k1_ms = kernels.get("gql_update_kernel", 0.0)
        emit({"phase": "profile", "call": what,
              "k1_share_of_device": k1_ms / 1e3 / dev_s if dev_s else
              None,
              "iterations_max": iterations_of(res),
              "host_s": host_s, "device_s": dev_s,
              "device_s_from": dev_from,
              "idle_share": 1.0 - dev_s / host_s,
              "profiled_call_s": prof_s,
              "kernels_ms": dict(top),
              # the port's own kernels, whether or not among the top,
              # and each one's share of the device time
              "port_kernels_ms": {k: ms for k, ms in kernels.items()
                                  if k in PORT_KERNELS},
              "port_kernel_shares": {
                  k: ms / 1e3 / dev_s for k, ms in kernels.items()
                  if k in PORT_KERNELS and dev_s}})

    def phase_yardsticks(self):
        """The library yardsticks (BSR @ dense for K2, K4 and K5; torch.bmm
        + dot for K6), last, because the BSR calls may run Triton kernels:
        each kernel timed in turns with its library
        call (kernel, library, library, kernel; three rounds), since these
        yardsticks move between calls. The line's library time is the
        median of the library's six readings; the first library call (a
        Triton build) falls in the warm-up and in the wall seconds."""
        for name, kernel, library in self.late_library:
            t0 = time.perf_counter()
            ks, gs, ls_ = [], [], []
            for _ in range(3):
                ks.append(cuda_ms(kernel))
                gs.append(graph_ms(kernel))
                ls_.extend([cuda_ms(library), cuda_ms(library)])
                gs.append(graph_ms(kernel))
                ks.append(cuda_ms(kernel))
            k_med, l_med = float(np.median(ks)), float(np.median(ls_))
            g_med = float(np.median(gs))
            self.kernels[name]["library_ms"] = l_med
            emit({"phase": "yardsticks", "name": name,
                  "kernel_ms_median": k_med, "library_ms_median": l_med,
                  "factor": k_med / l_med,
                  # the kernel's launches replayed as a CUDA graph, in the
                  # same turns: its device time without the wrapper's host
                  # work between calls
                  "kernel_graph_ms_median": g_med,
                  "graph_factor": g_med / l_med, "kernel_ms": ks,
                  "kernel_graph_ms": gs, "library_ms": ls_,
                  "timing_s": time.perf_counter() - t0})

    def _count(self, launches):
        for name, cnt in launches.items():
            self.launches[name] = self.launches.get(name, 0) + cnt


def main() -> int:
    only = None
    if len(sys.argv) > 1:
        only = sys.argv[2].split(",") if len(sys.argv) == 3 \
            and sys.argv[1] == "--phases" else []
        if not only or not set(only) <= set(PHASES):
            print(__doc__, file=sys.stderr)
            return 2
    if torch is None or not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the GPU only", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port is missing ({src / 'repro_torch'}); "
              f"run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = Smoke(repro_torch, dev)
    t0 = time.perf_counter()
    phase_s = {}
    for p in PHASES:
        if only is not None and p not in only:
            continue
        t_p = time.perf_counter()
        getattr(smoke, f"phase_{p}")()
        phase_s[p] = time.perf_counter() - t_p
    if only is not None:
        print(nvidia_smi(), flush=True)
        emit({"seconds": time.perf_counter() - t0, "phases": phase_s,
              "only": only})
        return 0
    for name, entry in smoke.kernels.items():
        entry["launches"] = smoke.launches[name]
        entry["launches_per_iteration"] = smoke.per_iteration(name)
    missing = [k for k in KERNELS if smoke.launches.get(k, 0) == 0]
    assert not missing, f"the path phases never launched {missing}"
    print(nvidia_smi(), flush=True)
    emit({"seconds": time.perf_counter() - t0, "phases": phase_s,
          "set_up": smoke.setup_s})
    emit({"kernels": [smoke.kernels[k] for k in sorted(smoke.kernels)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
