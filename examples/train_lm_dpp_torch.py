"""End-to-end driver on the PyTorch/CUDA port: train a language model
for a few hundred steps with DPP-selected batches, the GQL spectral
monitor, and fault-tolerant checkpointing (the twin of
examples/train_lm_dpp.py).

    PYTHONPATH=src python examples/train_lm_dpp_torch.py \
        [--steps 200] [--scale 100m|small] [--selector dpp|uniform] \
        [--device cuda|cpu]

``--scale small`` (default) is a ~6M-param model that runs on a CPU in
minutes (``--device cpu``); ``--scale 100m`` is the ~100M-param config
for the card. The batches, draws and parameters come from the port's own
seeded generators, so the losses are the reference's in kind, not bit
for bit.
"""
import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.data import (DataConfig, DPPBatchStream, DPPSelector,
                              TokenStream)
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import LoopConfig, make_monitor, train


def build_cfg(scale: str) -> ArchConfig:
    if scale == "100m":
        return ArchConfig(name="lm-100m", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=12, d_ff=3072,
                          vocab=32000, dtype="float32",
                          tie_embeddings=True)
    return ArchConfig(name="lm-small", n_layers=4, d_model=256, n_heads=8,
                      n_kv_heads=8, d_ff=1024, vocab=4096,
                      dtype="float32", tie_embeddings=True,
                      logits_chunk=128)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", default="small", choices=["small", "100m"])
    ap.add_argument("--selector", default="dpp",
                    choices=["dpp", "uniform"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir())
                                          / "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    cfg = build_cfg(args.scale)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, selector=args.selector)
    stream = TokenStream(dc, device=device)
    if args.selector == "dpp":
        stream = DPPBatchStream(stream, DPPSelector(
            pool_factor=3, steps_per_item=2, device=device))

    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps))

    def init_state():
        params, _ = M.init_model(0, cfg, device=device)
        n = sum(x.numel() for x in M.LM(cfg, params).parameters())
        print(f"model: {cfg.name} ({n/1e6:.1f}M params) on {device}")
        return params, opt.init(params)

    step_fn = build_train_step(cfg, optimizer=opt)
    monitor = make_monitor(M.loss_fn, cfg, per_example=4, sketch_dim=32,
                           device=device)

    t0 = time.time()
    res = train(
        loop_cfg=LoopConfig(total_steps=args.steps, save_every=50,
                            log_every=20, monitor_every=50),
        ckpt_dir=Path(args.ckpt) / cfg.name,
        init_state=init_state, step_fn=step_fn,
        batch_fn=stream.batch_at, monitor_fn=monitor)

    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({dt/args.steps*1e3:.0f} ms/step)")
    print(f"loss: {res.losses[0]:.3f} -> {np.mean(res.losses[-10:]):.3f}")
    if res.resumed_from:
        print(f"(resumed from step {res.resumed_from})")
    for step, m in res.monitor_log:
        print(f"  monitor@{step}: nat-grad-norm in "
              f"[{m['nat_norm_lower']:.3e}, {m['nat_norm_upper']:.3e}], "
              f"kappa(F) ~ [{m['kappa_lower']:.1f}, "
              f"{m['kappa_upper']:.1f}]")
    if args.selector == "dpp" and stream.selector.last_stats:
        print(f"  dpp selector last-step stats: "
              f"{stream.selector.last_stats}")


if __name__ == "__main__":
    main()
