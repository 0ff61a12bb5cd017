"""The port's data- and model-parallel training checks: the rank side of
tests/test_torch_parallel.py.

    PYTHONPATH=src python tests/torch_parallel_ranks.py WORLD INPUTS OUT

spawns WORLD gloo ranks on the CPU (a ``FileStore`` in OUT, a 120 s group
timeout, one thread a rank). Every rank reads the pickled INPUTS (the
reference's reduced parameters and inputs for each train case, which the
test draws), runs every case of ``CASES`` over ``make_host_mesh`` and
pickles its results to ``OUT/rank<r>.pkl``: a dict ``{case: {name:
numpy array or float}}``. The test holds them to the JAX package's
single-device results. This file imports no JAX and nothing of
``repro``.

Cases: ``train_<name>``, one step of a reduced architecture under
``tp_plan`` (the mesh and the plan are the input's ``meshes[world]``;
with ``census`` set, the step runs under ``utils.comms.StepCensus`` and
the rank returns its collectives' bytes and counts);
``place``, ``init_model`` drawing leaf by leaf through ``leaf_placer``
against ``distribute`` of the whole draw;
``compress``, ``compressed_psum`` over the whole group and over a mesh
dimension; ``restore``, elastic restore (world 2 saves after one step
under model = 2 and steps on; world 4 restores that checkpoint under
data x model with FSDP, once world 2 has committed it, and takes the
same second step); ``launcher``
(world 4), ``launch.train.main`` with ``--model-parallel 2 --fsdp``.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 240.0
RESTORE_WAIT_S = 180.0


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _logical(tree_mod, t) -> list:
    """The logical arrays of a tree of DTensors (a collective)."""
    return [x.full_tensor().detach().numpy() for x in tree_mod.leaves(t)]


def _optimizer():
    from repro_torch.optim import AdamW, warmup_cosine

    return AdamW(lr=warmup_cosine(1e-2, 1, 10), eps=1e-3)


def _placed_state(cfg, leaves, mesh, plan, opt):
    """The reference's parameters distributed as ``param_shardings``
    places them, and AdamW's zero state placed like them."""
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi

    params = convert.params_from_numpy(cfg, leaves, device="cpu")
    axes = M._build(cfg, M._meta)[1]
    params = shapi.distribute(params, mesh, shapi.param_shardings(
        plan, mesh, params, axes))
    return params, opt.init(params), axes


def _mesh_plan(world, model, fsdp):
    """The host mesh and ``tp_plan``; an integer ``fsdp`` (not a bool)
    turns FSDP on with that ``fsdp_min_size``."""
    import dataclasses

    from repro_torch.launch import make_host_mesh
    from repro_torch.sharding import api as shapi

    plan = shapi.tp_plan(data_axes=("data",), model_axis="model",
                         fsdp=bool(fsdp))
    if type(fsdp) is int:
        plan = dataclasses.replace(plan, fsdp_min_size=fsdp)
    return make_host_mesh(model=model, device_type="cpu"), plan


def _batch(arrays: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in arrays.items()}


def case_train(inp, world, rank, case):
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case.get("changes", {}))
    mesh, plan = _mesh_plan(world, case["meshes"][world], case["fsdp"])
    opt = _optimizer()
    params, state, _ = _placed_state(cfg, case["params"], mesh, plan, opt)
    step = steps.build_train_step(cfg, mesh, plan, opt,
                                  microbatches=case["mb"])
    census = None
    if case.get("census"):
        from repro_torch.utils import comms
        census = comms.StepCensus()
    with census if census is not None else contextlib.nullcontext():
        params, state, met = step(params, state, _batch(case["batch"]))
    p, m, v = (_logical(tree, params), _logical(tree, state.m),
               _logical(tree, state.v))
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "digest": _digest(p + m + v),
           "placements": sorted({str(tuple(x.placements))
                                 for x in tree.leaves(params)})}
    if rank == 0:
        out.update(params=p, m=m)
    if census is not None:
        out["collectives"] = {"bytes": comms.collective_bytes(
            census.records), "counts": comms.collective_counts(
            census.records), "flops": census.flops}
    return out


def case_place(inp, world, rank, case):
    """Each arch of ``case["archs"]`` (reduced) drawn leaf by leaf through
    ``leaf_placer`` under data x model with FSDP, against the whole draw
    distributed afterwards: the same placements and local bits."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.sharding import api as shapi

    mesh, plan = _mesh_plan(world, 2, True)
    out = {}
    for arch in case["archs"]:
        cfg = get_arch(arch).reduced()
        whole, axes = M.init_model(0, cfg, device="cpu")
        want = shapi.distribute(whole, mesh, shapi.param_shardings(
            plan, mesh, whole, axes))
        got, _ = M.init_model(0, cfg, device="cpu",
                              place=shapi.leaf_placer(plan, mesh))
        pairs = list(zip(tree.leaves(got), tree.leaves(want)))
        out[arch] = {
            "same": len(pairs) == len(tree.leaves(whole)) and all(
                tuple(g.placements) == tuple(w.placements)
                and g.shape == w.shape
                and torch.equal(g.to_local(), w.to_local())
                for g, w in pairs),
            "sharded": sum(1 for g, _ in pairs if any(
                p.is_shard() for p in g.placements))}
    return out


def case_compress(inp, world, rank, case):
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh
    from repro_torch.optim import compression as C

    rng = np.random.default_rng(100 + rank)
    x = torch.as_tensor(rng.standard_normal((33, 7)).astype(np.float32))
    r = torch.as_tensor(rng.standard_normal((33, 7)).astype(np.float32)
                        * 1e-3)
    out = {}
    o, nr = C.compressed_psum(x, None, r)
    out.update(world_out=o.numpy(), world_res=nr.numpy())
    if world % 2 == 0:
        mesh = make_host_mesh(model=2, device_type="cpu")
        o, nr = C.compressed_psum(x, (mesh, "data"), r)
        out.update(data_out=o.numpy(), data_res=nr.numpy(),
                   data_group=np.array(dist.get_process_group_ranks(
                       mesh.get_group(0))))
    return out


def case_restore(inp, world, rank, case):
    from torch.distributed.tensor import Shard

    from repro_torch import tree
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    cfg = get_arch(case["arch"]).reduced()
    opt = _optimizer()
    batch = _batch(case["batch"])
    ckpt = case["ckpt"]
    if world == 2:     # save after one step under model = 2, step on
        mesh, plan = _mesh_plan(world, 2, False)
        params, state, _ = _placed_state(cfg, case["params"], mesh, plan,
                                         opt)
        step = steps.build_train_step(cfg, mesh, plan, opt)
        params, state, _ = step(params, state, batch)
        ckpt_io.save(ckpt, 1, (params, state))
        params, state, met = step(params, state, batch)
        return {"loss2": float(met["loss"])}
    # world 4: restore the world-2 checkpoint under data x model, FSDP
    # (the two worlds run side by side: wait for its commit)
    deadline = time.monotonic() + RESTORE_WAIT_S
    while ckpt_io.latest_step(ckpt) != 1:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no committed checkpoint in {ckpt}")
        time.sleep(0.2)
    mesh, plan = _mesh_plan(world, 2, True)
    params, state, axes = _placed_state(cfg, case["params"], mesh, plan, opt)
    p_sh = steps.train_shardings(cfg, mesh, plan, axes, params, state,
                                 batch)[0][0]
    o_sh = steps._opt_shardings(mesh, plan, axes, state, p_sh)
    like = (params, state)
    params, state = ckpt_io.restore(ckpt, 1, like, (p_sh, o_sh), mesh=mesh)
    plain = ckpt_io.restore(ckpt, 1, tree.map(
        lambda x: torch.empty(x.shape, dtype=x.dtype) if hasattr(
            x, "device_mesh") else x, like))
    got = [x.full_tensor() if hasattr(x, "device_mesh") else x
           for x in tree.leaves((params, state))]
    same = all(torch.equal(a, b) for a, b in zip(got, tree.leaves(plain)))
    fsdp_sharded = sum(
        1 for x in tree.leaves(params)
        if isinstance(x.placements[0], Shard))
    step = steps.build_train_step(cfg, mesh, plan, opt)
    params, state, met = step(params, state, batch)
    return {"loss2": float(met["loss"]), "bit_equal": same,
            "fsdp_sharded": fsdp_sharded}


def case_launcher(inp, world, rank, case):
    if world != 4:
        return {}
    from repro_torch.launch import train as launch

    res = launch.main(case["argv"] + ["--ckpt-dir",
                                      os.path.join(case["dir"], "ranks")])
    return {"losses": list(res.losses)}


CASES = {"train": case_train, "place": case_place,
         "compress": case_compress,
         "restore": case_restore, "launcher": case_launcher}


def _rank(rank: int, world: int, inputs_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    src = str(Path(__file__).resolve().parent.parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch.distributed as dist

    from repro_torch.launch import init_lane_group

    init_lane_group("gloo", rank, world, store=dist.FileStore(
        os.path.join(out_dir, "store"), world), timeout_s=120.0)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        results, seconds = {}, {}
        for name, case in inp["cases"].items():
            if world not in case.get("worlds", (world,)):
                continue
            t0 = time.perf_counter()
            results[name] = CASES[case["kind"]](inp, world, rank, case)
            seconds[name] = time.perf_counter() - t0
        results["_seconds"] = seconds
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _target(rank, world, inputs_path, out_dir):
    try:
        _rank(rank, world, inputs_path, out_dir)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def main(argv) -> int:
    import multiprocessing as mp
    world, inputs_path, out_dir = int(argv[0]), argv[1], argv[2]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_target, args=(r, world, inputs_path,
                                                out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5.0)
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        print(f"ranks failed: exit codes {codes}"
              f"{' (hung past the join timeout)' if hung else ''}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
