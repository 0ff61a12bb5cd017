"""Batched serving with KV-cache diversification (paper tie-in #3), on the
PyTorch port: the twin of examples/serve_batched.py.

Serves the same small LM (random weights from seed 0) with the same
batched requests, then picks log-det KV blocks for a long-context budget,
every keep/evict decision certified by Gauss-Radau brackets (Alg. 8/9).

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.operators import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Engine, Request, select_diverse_blocks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = ArchConfig(name="serve-demo", n_layers=4, d_model=256, n_heads=8,
                     n_kv_heads=2, d_ff=1024, vocab=4096, dtype="float32",
                     tie_embeddings=True, logits_chunk=128)
    params, _ = M.init_model(0, cfg, device=dev)
    n = sum(x.numel() for x in M.LM(cfg, params).parameters())
    print(f"model: {n/1e6:.1f}M params | GQA {cfg.n_heads}q/"
          f"{cfg.n_kv_heads}kv | {dev}")

    eng = Engine(cfg, params, max_batch=4, max_seq=256)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, 4000, size=plen).astype(np.int32),
                    max_new_tokens=24)
            for plen in (12, 31, 7, 20)]
    t0 = time.time()
    out = eng.generate(reqs)
    dt = time.time() - t0
    ntok = sum(r.max_new_tokens for r in out)
    print(f"served batch of {len(reqs)} ({ntok} new tokens) in {dt:.2f}s")
    for i, r in enumerate(out):
        print(f"  req{i} (prompt {len(r.prompt):2d} toks) -> "
              f"{r.out_tokens[:10].tolist()}...")

    # --- KV diversification under a budget ---------------------------
    print("\nKV diversification (certified log-det selection):")
    keys = rng.standard_normal((2048, 64)).astype(np.float32)
    # inject redundancy: the second half repeats the first (a looping
    # context)
    keys[1024:] = keys[:1024] + 0.01 * rng.standard_normal((1024, 64))
    mask, stats = select_diverse_blocks(keys, block=128, device=dev)
    print(f"  {stats['blocks']} key blocks -> kept {stats['kept']} "
          f"(log det {stats['log_det']:.3f})")
    print(f"  quadrature iterations: {stats['quad_iterations']} "
          f"(exact would need ~{stats['blocks']}^2/2 solve dims/decision); "
          f"uncertified: {stats['uncertified']}")
    kept_first = mask[:len(mask) // 2].sum()
    kept_second = mask[len(mask) // 2:].sum()
    print(f"  redundant second half kept: {kept_second}/{len(mask)//2} vs "
          f"first half {kept_first}/{len(mask)//2}")
    return out, stats


if __name__ == "__main__":
    main()
