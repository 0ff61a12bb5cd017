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
                 assert that every K2, K4 and K5 launch took it); K6 one
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
  9. attention -- one attention layer of llama3-405b (128 query heads over
                 8 kv heads, head width 128, bf16): mha_flash over a 4096-
                 token causal prefill (which must take the wgmma route), a
                 decode-shaped call (one query over the 4096 keys) and an
                 f32 call over 16 heads, each against the plain version on
                 the card row by row, and the same measure on planted
                 faults, which it must catch;
 10. coo      -- two SparseCOO matvecs on the card give identical bits;
 11. profile  -- each path call again (and the DPP chain and the greedy
                 MAP call on 'pallas', with K1's share), warm: host
                 seconds beside the device time of every kernel it
                 launched (torch.profiler; CUDA events for the one-launch
                 attention call), so the card's idle share is
                 1 - device / host;
 12. yardsticks -- the library calls beside K2, K4, K5 (BSR @ dense) and
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
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

try:
    import torch
except ImportError:  # no PyTorch at all: nothing to drive
    torch = None

PHASES = ("device", "build", "kernels", "dense", "sparse", "trace",
          "bilinear", "apps", "attention", "coo", "profile", "yardsticks")
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


def iterations_of(out) -> int:
    """The longest lane's iterations of a solver call; the total of an
    application's judges; 1 for a call that has no iterations (an
    attention forward)."""
    if isinstance(out, torch.Tensor):
        return 1
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
        self.attention = None
        self.setup_s = {}     # seconds of the problems' set-up steps
        self.late_library = []  # (name, kernel, library call): timed last
        self.kernels_per_call = {}  # name -> device kernels a call runs

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

    def phase_profile(self):
        """Where the time goes: for each path call, warm, its host
        seconds (no profiler) beside the device time of every kernel it
        launched (torch.profiler, one more call), so the idle share of
        the card is 1 - device / host; a call the profiler records nothing
        of raises, except the attention call, one K7 launch, which CUDA
        events time. Runs after the path phases, whose launch counts it
        does not touch."""
        from repro_torch.core import BIFSolver, Dense
        from repro_torch.kernels import LAUNCHES, ops
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
        for what, fn in calls.items():
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
                  # the port's own kernels, whether or not among the top
                  "port_kernels_ms": {k: ms for k, ms in kernels.items()
                                      if k in PORT_KERNELS}})

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
    if len(sys.argv) > 1:
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
        t_p = time.perf_counter()
        getattr(smoke, f"phase_{p}")()
        phase_s[p] = time.perf_counter() - t_p
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
