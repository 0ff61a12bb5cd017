"""Training launcher (counterpart of ``repro.launch.train``), on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 8 [--smoke] [--selector dpp] [--monitor] [--device cpu]

``--smoke`` uses the reduced config. The parameters are drawn on the
device from seed 0; ``--model-parallel > 1`` and ``--fsdp`` wait for
data- and model-parallel training (ROADMAP Queue 1) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional

from ..configs import get_arch
from ..core.operators import resolve_device
from ..data import DataConfig, DPPBatchStream, DPPSelector, TokenStream
from ..models import model as M
from ..optim.adamw import AdamW, warmup_cosine
from ..train import LoopConfig, make_monitor, train as run_train
from . import steps as steps_mod


@dataclasses.dataclass
class Run:
    """Everything ``train.loop.train`` takes, built as the launcher builds
    it."""
    cfg: Any
    loop_cfg: LoopConfig
    ckpt_dir: Path
    init_state: Callable
    step_fn: Callable
    stream: Any
    monitor: Optional[Callable]

    def train(self, **kw):
        return run_train(loop_cfg=self.loop_cfg, ckpt_dir=self.ckpt_dir,
                         init_state=self.init_state, step_fn=self.step_fn,
                         batch_fn=self.stream.batch_at,
                         monitor_fn=self.monitor, **kw)


def build_run(cfg, *, steps: int, seq: int = 64, batch: int = 8,
              lr: float = 3e-4, selector: str = "uniform",
              monitor: bool = False, microbatches: int = 1,
              save_every: int = 25, keep_checkpoints: int = 3,
              ckpt_dir, device="cuda") -> Run:
    dev = resolve_device(device)
    opt = AdamW(lr=warmup_cosine(lr, max(steps // 10, 1), steps))
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                    selector=selector)
    stream = TokenStream(dc, device=dev)
    if selector == "dpp":
        stream = DPPBatchStream(stream, DPPSelector(
            pool_factor=3, steps_per_item=2, device=dev))

    def init_state():
        params, _ = M.init_model(0, cfg, device=dev)
        n = sum(x.numel() for x in M.LM(cfg, params).parameters())
        print(f"[train] {cfg.name}: {n / 1e6:.1f}M params on {dev}")
        return params, opt.init(params)

    return Run(
        cfg=cfg,
        loop_cfg=LoopConfig(total_steps=steps, save_every=save_every,
                            keep_checkpoints=keep_checkpoints,
                            monitor_every=save_every if monitor else 0),
        ckpt_dir=Path(ckpt_dir) / cfg.name, init_state=init_state,
        step_fn=steps_mod.build_train_step(cfg, optimizer=opt,
                                           microbatches=microbatches),
        stream=stream,
        monitor=make_monitor(M.loss_fn, cfg, per_example=2, sketch_dim=16,
                             device=dev) if monitor else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--selector", default="uniform",
                    choices=["uniform", "dpp"])
    ap.add_argument("--monitor", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel > 1 or args.fsdp:
        raise NotImplementedError(
            "--model-parallel > 1 and --fsdp wait for data- and "
            "model-parallel training (ROADMAP Queue 1)")

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    run = build_run(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                    lr=args.lr, selector=args.selector, monitor=args.monitor,
                    microbatches=args.microbatches,
                    save_every=args.save_every, ckpt_dir=args.ckpt_dir,
                    device=args.device)
    res = run.train()
    print(f"[train] done: loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}"
          + (f" (resumed from {res.resumed_from})"
             if res.resumed_from else ""))
    for step, m in res.monitor_log:
        print(f"[monitor@{step}] {m}")
    return res


if __name__ == "__main__":
    main()
