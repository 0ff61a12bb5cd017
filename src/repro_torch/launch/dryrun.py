"""Multi-pod dry-run: trace one step of every (arch x shape) cell on the
production mesh, with no card and no memory, and record its memory,
operations and collectives (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference forces 512 host devices and compiles ahead of time. Here
one process stands as rank 0 of a FAKE process group of 256 (single pod,
16 x 16) or 512 (multi-pod, 2 x 16 x 16) ranks: the ``"fake"`` backend
over ``FakeStore``, whose collectives move nothing. The mesh is
``launch.mesh.make_production_mesh``; the parameters, optimizer state,
batch and caches are fake tensors (``FakeTensorMode``: shapes, dtypes and
strides, no storage) placed per ``sharding.api.param_shardings`` /
``launch.steps``; and ONE real step (``launch.steps.build_train_step``,
``build_prefill_step`` or ``build_decode_step``) runs on them under
``utils.comms.StepCensus``, which counts rank 0's local operations, op
bytes, collectives and live memory. A process holds one default process
group, so the fake group needs a process of its own: this CLI is one.

``--device`` (default ``cuda``) is the device the fake tensors claim.
It picks the kernels that dispatch would choose and the collectives
DTensor issues; nothing is allocated on it. The mesh needs CUDA to be
present, so a machine without a card raises unless the caller passes
``--device cpu``, whose records are not the card's (an all-to-all
becomes an all-gather, and DTensor replicates the products around it).
Each record names its device, and the roofline refuses a directory that
mixes them.

Each cell's record (``<out>/<arch>__<shape>__<mesh><tag>.json``) has the
reference's keys: ``status``, ``n_chips``, ``fsdp``, ``memory``
(``argument_size_in_bytes``: rank 0's local parameters, optimizer state,
batch and caches; ``temp_size_in_bytes``: the peak of live storages the
step made above them; ``output_size_in_bytes``, ``alias_size_in_bytes``
(outputs written in place), ``generated_code_size_in_bytes`` 0),
``cost_raw``, ``cost_corrected``, ``roofline`` (``compute_s``,
``memory_s``, ``collective_s``), ``model_flops_info``,
``useful_flops_ratio``, ``bound_step_time_s``, ``roofline_fraction`` and
``dominant``, with ``trace_s`` and the constants used. A failure inside a
cell is data (``status: "error"`` with its trace), and the exit code is 1
when any cell failed.

As the reference compiles the whole scanned step for its memory
analysis and raw cost, every cell is traced at its full depth: that
trace gives ``memory`` and ``cost_raw`` (a peak of live storages is not
linear in depth, so it is never extrapolated). Unless ``--skip-delta``,
the cell is also traced at 2 and 4 units of depth (``_delta_cfgs``), and
``cost_corrected``'s flops, op bytes and collective bytes are
extrapolated from them, ``X(2u) + (U - 2)(X(4u) - X(2u)) / 2``, as the
reference's are. The eager trace counts every layer, so the two agree
where the stack is whole units (a hybrid's tail is folded in as a
fraction of one). ``run_cell`` also takes a host mesh ``"hostDxM"`` of
D x M fake ranks and a config object of the caller's, so that one
card's real step can be held to its fake trace.
``python -m repro_torch.launch.roofline`` reads the records.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch

from .. import tree
from ..configs import get_arch, list_archs
from ..core.operators import resolve_device
from ..models import model as M
from ..sharding import api as shapi
from ..utils import comms
from . import mesh as mesh_mod
from . import shapes as shapes_mod
from . import steps as steps_mod

# NVIDIA H100 SXM5 (80 GB), the H100 datasheet's figures:
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s (chip_smoke.py's)
HBM_BW = 3.35e12           # HBM3 bytes/s
# The link term: a 16-wide mesh axis spans two 8-card nodes, so the slow
# hop is the per-GPU inter-node link, one NDR InfiniBand NIC of 400 Gb/s
# a GPU (DGX H100): 50e9 bytes/s a direction. (Inside a node NVLink 4
# gives 450e9 bytes/s a direction, 900 GB/s both ways.)
LINK_BW = 50e9

DEFAULT_OUT = "experiments/dryrun_torch"
MESH_WORLD = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    for the duration of the block. Raises if the process already has a
    default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "this process already has a default process group; the "
            "dry-run's fake group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _plan_for(cfg, *, seq_shard=False, fsdp=None, embed_shard=False,
              tp_full=False):
    if fsdp is None:
        fsdp = cfg.param_count() > 8e9
    return shapi.tp_plan(data_axes=("pod", "data"), model_axis="model",
                         fsdp=fsdp, seq_shard=seq_shard,
                         embed_shard=embed_shard, tp_full=tp_full)


def _mesh(kind: str, device: str):
    """The production mesh of ``kind`` ('single' / 'multi'), or a host
    mesh 'hostDxM', over the fake group."""
    if kind.startswith("host"):
        _, model = _host_shape(kind)
        return mesh_mod.make_host_mesh(model=model, device_type=device)
    return mesh_mod.make_production_mesh(multi_pod=kind == "multi",
                                         device_type=device)


def _host_shape(kind: str) -> tuple:
    d, m = kind[len("host"):].split("x")
    return int(d), int(m)


def _world(kind: str) -> int:
    if kind.startswith("host"):
        d, m = _host_shape(kind)
        return d * m
    return MESH_WORLD[kind]


def _single_pod_plan_axes(mesh, plan):
    """On a mesh without a 'pod' axis, strip it from the plan."""
    names = set(mesh.mesh_dim_names)

    def fix(v):
        if isinstance(v, tuple):
            t = tuple(a for a in v if a in names)
            return t if t else None
        return v if v in names else None

    rules = {k: fix(v) for k, v in plan.rules.items()}
    return shapi.Plan(rules=rules, fsdp=plan.fsdp,
                      fsdp_axis=plan.fsdp_axis,
                      fsdp_min_size=plan.fsdp_min_size)


def _own_shards(x):
    """A DTensor whose local shard owns its storage (``distribute`` of a
    whole tensor keeps a view of it), so that memory counts shards."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                              x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _placed(x, mesh, shardings):
    return tree.map(_own_shards, shapi.distribute(x, mesh, shardings))


def _fake(specs, dev: str):
    """Fake tensors on ``dev`` like the meta tensors of ``specs``."""
    return tree.map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device=dev), specs)


def _step_args(cfg, kind: str, specs, mesh, plan, dev: str,
               microbatches: int):
    """``(fn, args)`` of one cell's step on fake tensors placed on
    ``mesh``."""
    def make(shape, fan_in, scale, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    params, axes = M._build(cfg, make)
    params = _placed(params, mesh,
                     shapi.param_shardings(plan, mesh, params, axes))
    batch = _fake(specs["batch"], dev)
    if kind == "train":
        opt = steps_mod.default_optimizer()
        fn = steps_mod.build_train_step(cfg, mesh, plan, opt,
                                        microbatches=microbatches)
        return fn, (params, opt.init(params), batch)
    caches = _fake(specs["caches"], dev)
    caches = _placed(caches, mesh, steps_mod.cache_sharding(
        cfg, mesh, plan, caches))
    if kind == "prefill":
        return steps_mod.build_prefill_step(cfg, mesh, plan), \
            (params, batch, caches)
    return steps_mod.build_decode_step(cfg, mesh, plan), \
        (params, caches, batch)


def _trace_cell(cfg, shape_name: str, mesh, plan, *, microbatches: int = 1,
                quantized_kv: bool = False, device: str = "cpu"):
    """Trace one step of one cell on fake tensors over ``mesh`` (a mesh of
    the fake group): ``(census, memory, kind, trace_s)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    kind, specs = shapes_mod.input_specs(cfg, shape_name,
                                         quantized_kv=quantized_kv)
    M._skeleton(cfg)    # the module skeleton is cached: build it outside
    census = comms.StepCensus()
    with FakeTensorMode(), _strided_sizes_on_the_host():
        fn, args = _step_args(cfg, kind, specs, mesh, plan, device,
                              microbatches)
        arg_bytes = census.exclude(args)
        with census:
            out = fn(*args)
        memory = _memory(census, arg_bytes, out)
        del fn, args, out
    return census, memory, kind, time.perf_counter() - t0


@contextlib.contextmanager
def _strided_sizes_on_the_host():
    """DTensor works out a strided shard's local size and offsets from
    ``torch.arange(n)`` split and read back (``.tolist()``): index
    arithmetic on the host, which under the fake mode would become data
    it cannot read. It runs outside the mode here (where torch's
    ``_StridedShard`` has that method)."""
    import functools
    import inspect

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    fn = inspect.getattr_static(cls, name, None) if cls else None
    if not inspect.isfunction(fn):
        yield
        return

    @functools.wraps(fn)
    def on_host(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)

    setattr(cls, name, on_host)
    try:
        yield
    finally:
        setattr(cls, name, fn)


def _memory(census, arg_bytes: int, out) -> dict:
    """The reference's ``memory_analysis`` keys from a census: arguments,
    the peak of the step's own storages, and the outputs (new or written
    into an argument's storage)."""
    new = alias = 0
    seen = set()
    for t in comms._tensors(out):
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        if st._cdata in census._known:
            alias += st.nbytes()
        else:
            new += st.nbytes()
    return {"argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(new),
            "temp_size_in_bytes": int(census.peak_bytes),
            "alias_size_in_bytes": int(alias),
            "generated_code_size_in_bytes": 0}


def _measure(census) -> dict:
    """Flops (``FlopCounterMode``'s formulas), op bytes and collective
    bytes of one traced step: the reference's ``_measure`` keys, with the
    collective counts beside their bytes."""
    out = census.summary()
    out["coll_counts"] = comms.collective_counts(census.records)
    return out


def _delta_cfgs(cfg):
    """Small configs for the per-unit cost delta.

    Returns (cfg2, cfg4, u2, u4, u_full): 2 and 4 units of depth traced
    in place of the whole stack,
        X(L) = X(2u) + (U - 2) * (X(4u) - X(2u)) / 2.
    Hybrid tails are folded in as fractional units (slight attn
    overcount on the tail), as in the reference.
    """
    import dataclasses as dc
    fam = cfg.family
    if fam == "encdec":
        c2 = dc.replace(cfg, n_layers=2, enc_layers=2, scan_unroll=True)
        c4 = dc.replace(cfg, n_layers=4, enc_layers=4, scan_unroll=True)
        return c2, c4, 2, 4, float(cfg.n_layers)
    unit = {"moe": cfg.moe_every,
            "hybrid": cfg.hybrid_attn_every}.get(fam, 1) or 1
    c2 = dc.replace(cfg, n_layers=2 * unit, scan_unroll=True)
    c4 = dc.replace(cfg, n_layers=4 * unit, scan_unroll=True)
    return c2, c4, 2, 4, cfg.n_layers / unit


_DELTA_COST = ("flops", "bytes", "coll")


def _extrapolate(x2: float, x4: float, u2, u4, u_full) -> float:
    per_unit = (x4 - x2) / (u4 - u2)
    return x2 + (u_full - u2) * per_unit


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    import dataclasses as dc
    kw = {}
    for item in overrides:
        k, v = item.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "on")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        kw[k] = v
    return dc.replace(cfg, **kw)


def measure_cell(cfg, shape_name: str, mesh, plan, *, microbatches=1,
                 quantized_kv=False, skip_delta=False, device="cpu") -> dict:
    """``cost_raw``, ``cost_corrected``, ``memory``, ``trace_s`` of one
    cell on ``mesh`` (a mesh of the fake group): ``memory`` and
    ``cost_raw`` from the full-depth trace, ``cost_corrected`` from the
    2- and 4-unit traces unless ``skip_delta``."""
    kw = dict(microbatches=microbatches, quantized_kv=quantized_kv,
              device=device)
    census, memory, _, trace_s = _trace_cell(cfg, shape_name, mesh, plan,
                                             **kw)
    raw = _measure(census)
    del census
    if skip_delta:
        return {"cost_raw": raw, "cost_corrected": dict(raw),
                "memory": memory, "trace_s": trace_s}
    c2, c4, u2, u4, u_full = _delta_cfgs(cfg)
    cen2, _, _, t2 = _trace_cell(c2, shape_name, mesh, plan, **kw)
    cen4, _, _, t4 = _trace_cell(c4, shape_name, mesh, plan, **kw)
    m2, m4 = _measure(cen2), _measure(cen4)
    corrected = {k: _extrapolate(m2[k], m4[k], u2, u4, u_full)
                 for k in _DELTA_COST}
    corrected["per_unit"] = {k: (m4[k] - m2[k]) / (u4 - u2)
                             for k in _DELTA_COST}
    corrected["base_2u"] = {k: m2[k] for k in _DELTA_COST}
    return {"cost_raw": raw, "cost_corrected": corrected,
            "memory": memory, "trace_s": trace_s + t2 + t4}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             out_dir: Path, microbatches: int = 1, seq_shard: bool = False,
             fsdp=None, embed_shard: bool = False, tp_full: bool = False,
             quantized_kv: bool = False, skip_delta: bool = False,
             overrides=None, tag: str = "", device: str = "cuda",
             cfg=None) -> dict:
    """Trace one cell on a fake group of its mesh's size (opened and
    closed here) and write its record; returns the record. ``cfg`` (a
    config of the caller's, e.g. ``get_arch(arch).reduced()``) stands in
    for ``get_arch(arch)``. ``device="cuda"`` raises where CUDA is
    missing."""
    device = resolve_device(device).type
    cfg = _apply_overrides(cfg or get_arch(arch), overrides)
    ok, why = shapes_mod.cell_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "tag": tag, "device": device, "status": "skipped",
           "reason": why}
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    if not ok:
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] SKIP {arch} {shape_name} {mesh_kind}: {why}",
              flush=True)
        return rec

    with fake_world(_world(mesh_kind)):
        mesh = _mesh(mesh_kind, device)
        plan = _plan_for(cfg, seq_shard=seq_shard, fsdp=fsdp,
                         embed_shard=embed_shard, tp_full=tp_full)
        plan = _single_pod_plan_axes(mesh, plan)
        n_chips = mesh.size()
        try:
            got = measure_cell(cfg, shape_name, mesh, plan,
                               microbatches=microbatches,
                               quantized_kv=quantized_kv,
                               skip_delta=skip_delta, device=device)
        except Exception as e:  # noqa: BLE001 -- failures are data here
            rec.update(status="error", n_chips=n_chips, fsdp=plan.fsdp,
                       error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-4000:])
            out_path.write_text(json.dumps(rec, indent=2))
            print(f"[dryrun] FAIL {arch} {shape_name} {mesh_kind}: "
                  f"{type(e).__name__}: {str(e)[:300]}", flush=True)
            return rec

    corrected = got["cost_corrected"]
    mf = _model_flops(cfg, shape_name)
    roof = {
        "compute_s": corrected["flops"] / PEAK_FLOPS,
        "memory_s": corrected["bytes"] / HBM_BW,
        "collective_s": corrected["coll"] / LINK_BW,
    }
    model_flops_per_chip = mf["model_flops"] / n_chips
    rec.update(
        status="ok",
        n_chips=n_chips,
        fsdp=plan.fsdp,
        trace_s=round(got["trace_s"], 2),
        memory=got["memory"],
        cost_raw=got["cost_raw"],
        cost_corrected=corrected,
        roofline=roof,
        model_flops_info=mf,
        useful_flops_ratio=(model_flops_per_chip
                            / max(corrected["flops"], 1.0)),
        bound_step_time_s=max(roof.values()),
        roofline_fraction=(model_flops_per_chip / PEAK_FLOPS)
        / max(max(roof.values()), 1e-30),
        constants={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                   "link_bw": LINK_BW},
    )
    rec["dominant"] = max(roof, key=roof.get)
    out_path.write_text(json.dumps(rec, indent=2))
    mem_gb = (got["memory"]["argument_size_in_bytes"]
              + got["memory"]["temp_size_in_bytes"]) / 1e9
    print(f"[dryrun] OK {arch} {shape_name} {mesh_kind}{tag} "
          f"chips={n_chips} trace={got['trace_s']:.1f}s "
          f"dominant={rec['dominant']} "
          f"compute={roof['compute_s']:.4f}s "
          f"memory={roof['memory_s']:.4f}s "
          f"coll={roof['collective_s']:.4f}s "
          f"hbm={mem_gb:.2f}GB/rank "
          f"roofline_frac={rec['roofline_fraction']:.3f}", flush=True)
    return rec


def _model_flops(cfg, shape_name: str) -> dict:
    cell = shapes_mod.SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        d_tokens = cell.seq * cell.batch
        mf = 6.0 * n_active * d_tokens
    elif cell.kind == "prefill":
        d_tokens = cell.seq * cell.batch
        mf = 2.0 * n_active * d_tokens
    else:
        d_tokens = cell.batch          # one token per sequence
        mf = 2.0 * n_active * d_tokens
    return {"model_flops": mf, "tokens": d_tokens,
            "active_params": n_active}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--fsdp", default=None,
                    choices=[None, "on", "off"])
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--embed-shard", action="store_true")
    ap.add_argument("--tp-full", action="store_true")
    ap.add_argument("--skip-delta", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. --override remat=none "
                         "--override n_layers=2")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="the device the fake tensors claim; without a "
                         "card only cpu runs, and its records are not "
                         "the card's")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available: pass --device cpu to trace CPU "
                 "fake tensors (their records are not the card's)")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shps = list(shapes_mod.SHAPES) if args.all or not args.shape \
        else [args.shape]
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    failures = 0
    for mk in meshes:
        for a in archs:
            for s in shps:
                rec = run_cell(a, s, mk, out_dir=out_dir,
                               microbatches=args.microbatches,
                               seq_shard=args.seq_shard, fsdp=fsdp,
                               embed_shard=args.embed_shard,
                               tp_full=args.tp_full,
                               quantized_kv=args.quantized_kv,
                               skip_delta=args.skip_delta,
                               overrides=args.override,
                               tag=args.tag, device=args.device)
                failures += rec["status"] == "error"
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
