"""Serving launcher (counterpart of ``repro.launch.serve``), on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --requests 8 --new-tokens 64 [--int8-kv] [--kv-select] \
        [--temperature T] [--smoke] [--device cpu]

``--smoke`` uses the reduced config. Enc-dec models are refused, as the
reference refuses them, and a VLM raises ``ValueError``: the Engine
builds token-only batches. The parameters are drawn on the device from
seed 0 and the prompts from a numpy generator seeded with 0, as the
reference's launcher draws them; the run uses the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_arch
from ..core.operators import resolve_device
from ..models import model as M
from ..serve import Engine, Request, select_diverse_blocks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--kv-select", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.family in ("encdec",):
        raise SystemExit("serve CLI demo supports decoder-only archs")
    if cfg.family == "vlm":
        # the reference's Engine feeds tokens alone and fails in prefill
        # (KeyError: 'vision_embeds'); there is no vision path to serve
        raise ValueError(f"{cfg.name}: the Engine serves token prompts; a "
                         f"VLM's prefill needs batch['vision_embeds'] and "
                         f"batch['positions'], which it does not build")

    params, _ = M.init_model(0, cfg, device=dev)
    eng = Engine(cfg, params, max_batch=args.requests,
                 max_seq=args.max_seq, quantized_kv=args.int8_kv)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(
                1, cfg.vocab - 1, size=int(rng.integers(8, 32)))
                .astype(np.int32),
                max_new_tokens=args.new_tokens,
                temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.time()
    out = eng.generate(reqs)
    dt = time.time() - t0
    total = sum(r.max_new_tokens for r in out)
    print(f"[serve] {cfg.name}: {args.requests} reqs, {total} tokens in "
          f"{dt:.2f}s on {dev}, int8_kv={args.int8_kv}")
    for i, r in enumerate(out):
        print(f"  req{i}: {r.out_tokens[:12].tolist()}")

    stats = None
    if args.kv_select:
        keys = rng.standard_normal((1024, cfg.head_dim_)) \
            .astype(np.float32)
        mask, stats = select_diverse_blocks(keys, block=64, device=dev)
        print(f"[kv-select] {stats}")
    return out, stats


if __name__ == "__main__":
    main()
