"""Training launcher (counterpart of ``repro.launch.train``): one card,
or data x model parallel over every rank of a process group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 8 [--smoke] [--selector dpp] [--monitor] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch olmo-1b --steps 8 --model-parallel 2 --fsdp

``--smoke`` uses the reduced config. Every rank draws the parameters from
seed 0 on its device, so the logical values are the same on any mesh.
Under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` in the
environment; NCCL, one card a rank) or in ranks that the caller spawned
and whose default group it initialised (gloo with ``--device cpu``), the
ranks form ``make_host_mesh(model=--model-parallel)`` and train under
``tp_plan(data_axes=("data",), fsdp=--fsdp)``: the parameters are
distributed as ``param_shardings`` places them, the batch split over the
data axis. ``--model-parallel`` / ``--fsdp`` in a single process without
a group make a group of one. Only rank 0 prints. The spectral monitor
runs on one device (``--monitor`` with a mesh raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional

import torch.distributed as dist

from .. import tree
from ..configs import get_arch
from ..core.operators import resolve_device
from ..data import DataConfig, DPPBatchStream, DPPSelector, TokenStream
from ..models import model as M
from ..optim.adamw import AdamW, warmup_cosine
from ..sharding import api as shapi
from ..train import LoopConfig, make_monitor, train as run_train
from . import mesh as mesh_mod
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


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_group(device) -> None:
    """The default group, where none is initialised: from ``torchrun``'s
    environment (NCCL for the cards, gloo for the CPU), or a group of one
    in this process."""
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        mesh_mod.init_lane_group(backend, int(os.environ["RANK"]),
                                 int(os.environ["WORLD_SIZE"]),
                                 init_method="env://", timeout_s=600.0)
    else:
        mesh_mod.init_lane_group(backend, 0, 1, store=dist.HashStore(),
                                 timeout_s=600.0)


def build_run(cfg, *, steps: int, seq: int = 64, batch: int = 8,
              lr: float = 3e-4, selector: str = "uniform",
              monitor: bool = False, microbatches: int = 1,
              save_every: int = 25, keep_checkpoints: int = 3,
              ckpt_dir, device="cuda", mesh=None, plan=None) -> Run:
    """The launcher's run; over ``mesh`` / ``plan`` (``make_host_mesh``,
    ``tp_plan``) when given, else on ``device``."""
    dev = resolve_device(device)
    if mesh is not None:
        if monitor:
            raise ValueError("the spectral monitor runs on one device; "
                             "drop --monitor or the mesh")
        dev = mesh_mod.lane_device(mesh)
    opt = AdamW(lr=warmup_cosine(lr, max(steps // 10, 1), steps))
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                    selector=selector)
    stream = TokenStream(dc, device=dev)
    if selector == "dpp":
        stream = DPPBatchStream(stream, DPPSelector(
            pool_factor=3, steps_per_item=2, device=dev))

    def init_state():
        # over a mesh each leaf is placed as soon as it is drawn
        params, _ = M.init_model(0, cfg, device=dev, place=None if mesh is
                                 None else shapi.leaf_placer(plan, mesh))
        n = sum(x.numel() for x in tree.leaves(params))
        where = str(dev) if mesh is None else \
            f"mesh {shapi.mesh_sizes(mesh)}"
        if _rank() == 0:
            print(f"[train] {cfg.name}: {n / 1e6:.1f}M params on {where}")
        return params, opt.init(params)

    return Run(
        cfg=cfg,
        loop_cfg=LoopConfig(total_steps=steps, save_every=save_every,
                            keep_checkpoints=keep_checkpoints,
                            monitor_every=save_every if monitor else 0),
        ckpt_dir=Path(ckpt_dir) / cfg.name, init_state=init_state,
        step_fn=steps_mod.build_train_step(cfg, mesh, plan, optimizer=opt,
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

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = plan = None
    if args.model_parallel > 1 or args.fsdp or "WORLD_SIZE" in os.environ:
        init_group(args.device)
    if dist.is_initialized() and (args.model_parallel > 1 or args.fsdp
                                  or dist.get_world_size() > 1):
        mesh = mesh_mod.make_host_mesh(
            model=args.model_parallel,
            device_type=resolve_device(args.device).type)
        plan = shapi.tp_plan(data_axes=("data",), model_axis="model",
                             fsdp=args.fsdp)
    run = build_run(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                    lr=args.lr, selector=args.selector, monitor=args.monitor,
                    microbatches=args.microbatches,
                    save_every=args.save_every, ckpt_dir=args.ckpt_dir,
                    device=args.device, mesh=mesh, plan=plan)
    res = run.train()
    if _rank() != 0:
        return res
    print(f"[train] done: loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}"
          + (f" (resumed from {res.resumed_from})"
             if res.resumed_from else ""))
    for step, m in res.monitor_log:
        print(f"[monitor@{step}] {m}")
    return res


if __name__ == "__main__":
    main()
