"""Roofline report generator (counterpart of ``repro.launch.roofline``):
reads the dry-run's records (``experiments/dryrun_torch/*.json``, written
by ``python -m repro_torch.launch.dryrun``) and prints the roofline table
and a note a cell, with the H100's constants (``launch.dryrun``). A
record names the device its fake tensors claimed; a directory whose
records name more than one is refused, as a CPU trace's collectives and
flops are not the card's.

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        [--dir experiments/dryrun_torch] [--mesh single]

Also computes the analytic memory floor (params + optimizer + caches +
checkpointed activations) as a supplement: the traced op bytes are an
upper bound, because every aten op's inputs and outputs are counted, as
if nothing were fused.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import get_arch
from .dryrun import DEFAULT_OUT
from .shapes import SHAPES


def analytic_memory_bytes(arch: str, shape: str, n_chips: int,
                          fsdp: bool) -> float:
    """Lower-bound HBM traffic per device per step (fusion-ideal)."""
    cfg = get_arch(arch)
    cell = SHAPES[shape]
    p = cfg.param_count()
    p_active = cfg.active_param_count()
    d = cfg.d_model
    if cell.kind == "train":
        tokens = cell.seq * cell.batch / n_chips * 16  # model-shard share
        # params bf16 read (fwd+bwd) + fp32 m/v read+write + grads
        param_bytes = p / n_chips * (2 * 2 + 4 * 4 + 4)
        # remat(block): block inputs stored+read + recompute reads
        act_bytes = cfg.n_layers * tokens * d * 2 * 4
        return param_bytes + act_bytes
    if cell.kind == "prefill":
        tokens = cell.seq * cell.batch / n_chips * 16
        param_bytes = p_active / n_chips * 2
        act_bytes = cfg.n_layers * tokens * d * 2 * 2
        kv_bytes = (cfg.n_layers * cell.seq * cell.batch
                    * cfg.n_kv_heads * cfg.head_dim_ * 2 * 2) / n_chips
        return param_bytes + act_bytes + kv_bytes
    # decode: whole model + whole KV read once per token
    param_bytes = p_active / n_chips * 2
    kv_bytes = (cfg.n_layers * cell.seq * cell.batch * cfg.n_kv_heads
                * cfg.head_dim_ * 2 * 2) / n_chips
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm_expand * cfg.d_model
        kv_bytes = cfg.n_layers * cell.batch * di * cfg.ssm_state * 4 \
            / n_chips
    return param_bytes + kv_bytes


def load_records(dir_: Path, mesh: str, tag: str = ""):
    recs = []
    for p in sorted(dir_.glob(f"*__{mesh}{tag}.json")):
        recs.append(json.loads(p.read_text()))
    devices = sorted({str(r.get("device")) for r in recs})
    if len(devices) > 1:
        raise ValueError(f"{dir_} mixes records traced on {devices}; "
                         f"keep each device's records apart")
    return recs


def fmt_table(recs, markdown: bool = True):
    lines = []
    hdr = ("| arch | shape | device | compute_s | memory_s | coll_s | "
           "dominant | MODEL_FLOPS/chip | useful ratio | roofline frac | "
           "HBM GB/chip |")
    sep = "|" + "---|" * 11
    lines.append(hdr)
    lines.append(sep)
    for r in recs:
        cell = f"| {r['arch']} | {r['shape']} | {r.get('device', '?')} |"
        if r["status"] == "skipped":
            lines.append(f"{cell} — | — | — | skip | — | — | — | — |")
            continue
        if r["status"] == "error":
            lines.append(f"{cell} ERROR: {r.get('error','?')[:60]} |"
                         + " — |" * 7)
            continue
        roof = r["roofline"]
        mem_gb = (r["memory"]["argument_size_in_bytes"]
                  + r["memory"]["temp_size_in_bytes"]) / 1e9
        mf = r["model_flops_info"]["model_flops"] / r["n_chips"]
        lines.append(
            f"{cell} {roof['compute_s']:.4f} | "
            f"{roof['memory_s']:.4f} | {roof['collective_s']:.4f} | "
            f"{r['dominant'].replace('_s','')} | {mf:.3e} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {mem_gb:.1f} |")
    return "\n".join(lines)


def bottleneck_note(r) -> str:
    if r["status"] != "ok":
        return ""
    dom = r["dominant"]
    arch, shape = r["arch"], r["shape"]
    if dom == "memory_s":
        return (f"{arch}/{shape}: memory-bound — cut op bytes with fused "
                "kernels, bf16 intermediates and fewer f32 upcasts, a "
                "lighter remat policy, or (decode) int8 KV.")
    if dom == "collective_s":
        return (f"{arch}/{shape}: collective-bound — keep activation "
                "gradients sharded so DTensor does not gather weights, "
                "overlap the data reduce with compute, or compress "
                "gradients (int8 EF).")
    return (f"{arch}/{shape}: compute-bound — near the tensor cores' "
            "ceiling; improve the useful-flops ratio (less remat "
            "recompute, no replicated products).")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    try:
        recs = load_records(Path(args.dir), args.mesh, args.tag)
    except ValueError as e:
        ap.error(str(e))
    print(fmt_table(recs))
    print()
    for r in recs:
        n = bottleneck_note(r)
        if n:
            print("  *", n)


if __name__ == "__main__":
    main()
