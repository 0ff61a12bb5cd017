#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py

It runs every phase, in order, each printing one JSON line:

  1. device   -- the card's name and power limit (nvidia-smi), TF32 flags;
  2. build    -- nvcc builds the kernels from ``csrc/`` (seconds);
  3. kernels  -- K1-K5 at the main path's shapes: each kernel against its
                 plain PyTorch version on the same inputs (tolerance and
                 reason stated), kernel / plain / library-call times and
                 the least time the card could take (bound);
  4. dense    -- RBF kernel at Abalone's N = 4177 (paper Table 1), K = 64
                 lanes: solve_batch (fused, reorth), a greedy-MAP argmax
                 round over stacked masks (fused), judge_batch (pallas);
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
  7. coo      -- two SparseCOO matvecs on the card give identical bits;
  8. profile  -- each path call again, warm: host seconds beside the
                 device time of every kernel it launched (torch.profiler),
                 so the card's idle share is 1 - device / host.

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

PHASES = ("device", "build", "kernels", "dense", "sparse", "trace", "coo",
          "profile")
KERNELS = ("gql_update", "bell_matvec", "fused_step_dense", "fused_step_bell",
           "bell_matvec_mrhs")

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and
# dense flops/s for each type. f64 is the FP64 tensor-core rate, the
# highest the card has for f64 work; f32 is the rate outside the tensor
# cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12} if torch else {}

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


class Smoke:
    def __init__(self, rt, dev):
        self.rt = rt          # the repro_torch package
        self.dev = dev
        self.kernels = {}     # name -> kernels-line entry
        self.launches = {}    # name -> launches on the main path
        self.path_calls = []  # (iterations, launches) of each path call
        self.dense = None     # shared problem data between phases
        self.sparse = None
        self.setup_s = {}     # seconds of the problems' set-up steps

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
                     fn, library_note=None):
        """One kernels line; ``library_ms`` may be a thunk, timed after the
        kernel's own profile (a library call that runs Triton kernels
        leaves the next profile of the process empty)."""
        abs_err, rel_err = errors(got, want)
        per_call = sum(c for _, c in device_kernels(fn).values())
        t_lib = time.perf_counter()
        if callable(library_ms):
            library_ms = library_ms()
        t_lib = time.perf_counter() - t_lib
        line = {"phase": "kernels", "name": name, "max_abs_err": abs_err,
                "max_rel_err": rel_err, "tolerance": tol, "reason": why,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                # device kernels that one call of the wrapper launches
                "cuda_kernels_per_call": per_call,
                # wall seconds of the library timing, its first call
                # (a Triton build for BSR @ dense at 512 columns) included
                "library_timing_s": t_lib}
        if library_note:
            line["library_covers"] = library_note
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

        # K1 on the recurrence inputs of the next step
        k1_in = (g.lz.alpha, g.lz.beta, g.lz.beta_prev, g.g, g.c, g.delta,
                 g.delta_lr, g.delta_rr, lmn, lmx)
        got = ops.gql_update(*k1_in)
        want = gu.gql_update_plain(*k1_in)
        nb = nbytes(*k1_in) + nbytes(*got)
        bms, bby = bound(nb, 55 * K, torch.float64)
        self._kernel_line(
            "gql_update", "src/repro_torch/kernels/csrc/gql_update.cu",
            "src/repro/kernels/gql_update.py:76", got, want, 1e-12,
            "f64; FMA contraction and operation order only",
            cuda_ms(lambda: ops.gql_update(*k1_in)),
            cuda_ms(lambda: gu.gql_update_plain(*k1_in)), bms, bby, None,
            lambda: ops.gql_update(*k1_in))

        # K3 with the banked basis (the fused solve_batch path)
        args = (a, one, one, zero, v, vp, scalars, basis)
        got = flatten_out(ops.fused_step_dense(*args, shared_a=True))
        want = flatten_out(ls.fused_step_dense_plain(*args, shared_a=True))
        m = basis.shape[1]
        nb = nbytes(a, v, vp, basis, *scalars) + nbytes(*got)
        flops = 2 * K * n * n + 4 * K * m * n + 10 * K * n
        bms, bby = bound(nb, flops, torch.float64)
        xs = v.clone()
        self._kernel_line(
            "fused_step_dense", "src/repro_torch/kernels/csrc/dense_step.cu",
            "src/repro/kernels/lanczos_step.py:135", got, want, 1e-12,
            "f64; summation order over N = 4177 and the basis, FMA",
            cuda_ms(lambda: ops.fused_step_dense(*args, shared_a=True)),
            cuda_ms(lambda: ls.fused_step_dense_plain(*args, shared_a=True)),
            bms, bby, cuda_ms(lambda: torch.matmul(xs, a.T)),
            lambda: ops.fused_step_dense(*args, shared_a=True),
            "the matvec (A @ x for 64 lanes, torch.matmul) only")
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
        self._kernel_line(
            "bell_matvec", "src/repro_torch/kernels/csrc/bell.cu",
            "src/repro/kernels/spmv_bell.py:44", got, want, 1e-5,
            "f32 accumulation (the kernel's contract) in another order",
            cuda_ms(lambda: ops.bell_matvec(bell.data, bell.cols, xs32)),
            cuda_ms(lambda: sb.bell_matvec_plain(bell.data, bell.cols,
                                                 xs32)),
            bms, bby, cuda_ms(lambda: torch.matmul(bsr32, xt32)),
            lambda: ops.bell_matvec(bell.data, bell.cols, xs32),
            "the SpMV (BSR @ dense, 64 right-hand sides)")

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
        got = flatten_out(ops.fused_step_bell(*bargs))
        want = flatten_out(ls.fused_step_bell_plain(*bargs))
        nb = nbytes(bell.data, bell.cols, gs.lz.v, gs.lz.v_prev, *ssc) \
            + nbytes(*got)
        bms, bby = bound(nb, 2 * K * nnz + 10 * K * nr * bs,
                         torch.float64)
        bsr64 = bsr_of(bell.data, bell.cols, torch.float64)
        xt64 = gs.lz.v.T.contiguous()
        self._kernel_line(
            "fused_step_bell", "src/repro_torch/kernels/csrc/bell.cu",
            "src/repro/kernels/lanczos_step.py:235", got, want, 1e-12,
            "f64 vectors, f32 data cast to f64; summation order, FMA",
            cuda_ms(lambda: ops.fused_step_bell(*bargs)),
            cuda_ms(lambda: ls.fused_step_bell_plain(*bargs)), bms, bby,
            cuda_ms(lambda: torch.matmul(bsr64, xt64)),
            lambda: ops.fused_step_bell(*bargs),
            "the SpMV (BSR @ dense in f64, 64 right-hand sides)")
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
        self._kernel_line(
            "bell_matvec_mrhs", "src/repro_torch/kernels/csrc/bell_mrhs.cu",
            "src/repro/kernels/spmv_bell.py:73", got, want, 1e-5,
            "f32 accumulation (the kernel's contract) in another order",
            cuda_ms(lambda: ops.bell_matvec_mrhs(bell.data, bell.cols, xb)),
            cuda_ms(lambda: sb.bell_matvec_mrhs_plain(bell.data, bell.cols,
                                                      xb)),
            bms, bby, lambda: cuda_ms(lambda: torch.matmul(bsr32, xt5)),
            lambda: ops.bell_matvec_mrhs(bell.data, bell.cols, xb),
            "the SpMM (BSR @ dense, f32, 512 right-hand sides)")
        emit({"phase": "kernels", "ported": sorted(self.kernels)})
        assert sorted(self.kernels) == sorted(KERNELS)

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
        it ran (its longest lane's) and how many times it launched each
        kernel."""
        from repro_torch.kernels import LAUNCHES
        before = dict(LAUNCHES)
        out, seconds = self.run_timed(fn)
        its = out.state.iterations if hasattr(out, "std_error") \
            else out.iterations
        self.path_calls.append((int(its.max()), {
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

        reset_launches()
        solve_f, t_solve = self.path_call(lambda: cfg(
            "fused", reorth=True).solve_batch(op, u, **iv))
        k3_before = LAUNCHES["fused_step_dense"]
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
                "launches": launches}
        emit(line)
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

        reset_launches()
        res_p, t_p = self.path_call(block("pallas"))
        k5 = LAUNCHES["bell_matvec_mrhs"]
        res_f, t_f = self.path_call(lambda: logdet_quad(
            op, SCALAR_PROBES, block_size=1, solver=BIFSolver.create(
                backend="fused", **TRACE_SCALAR), **iv))
        launches = dict(LAUNCHES)
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
              "launches": launches})
        # K5: once at block_init, then once per block step of the driver;
        # every lane certifies before the cap, so the longest lane steps
        # in every round and the steps are its iterations less one
        assert k5 == 1 + line_p["steps"], f"K5 launched {k5} times"
        assert float(diff.max()) <= cmp_slack, "backends' brackets differ"
        assert launches["fused_step_bell"] > 0
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
        the card is 1 - device / host. Runs after the path phases, whose
        launch counts it does not touch."""
        from repro_torch.core import BIFSolver, Dense
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
        for what, fn in calls.items():
            if not what.startswith("trace"):   # the trace phase warmed these
                fn()
            res, host_s = self.run_timed(fn)
            t0 = time.perf_counter()
            kernels = {k: ms for k, (ms, _) in device_kernels(fn).items()}
            prof_s = time.perf_counter() - t0
            dev_s = sum(kernels.values()) / 1e3
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
            its = res.state.iterations if hasattr(res, "std_error") \
                else res.iterations
            emit({"phase": "profile", "call": what,
                  "iterations_max": int(its.max()),
                  "host_s": host_s, "device_s": dev_s,
                  "idle_share": 1.0 - dev_s / host_s,
                  "profiled_call_s": prof_s,
                  "kernels_ms": dict(top)})

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
