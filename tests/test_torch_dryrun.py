"""The port's dry-run, roofline and step census (launch/dryrun.py,
launch/roofline.py, utils/comms.py) against the JAX package, on the CPU.

* ``_model_flops`` and ``analytic_memory_bytes`` equal the reference's
  bit for bit for every arch x shape x n_chips in {1, 256, 512} x fsdp
  (the reference's ``_model_flops`` is run from its source: importing
  ``repro.launch.dryrun`` would set XLA_FLAGS for this process).
* ``collective_bytes`` of the census's records of five real collectives
  on a fake group of 8 equals the reference's parser on
  tests/test_dryrun_small.py's HLO of the same five, kind by kind.
* The seven (arch, kind) cells of tests/test_dryrun_small.py, reduced,
  trace on a fake world of 8 as (4, 2) with ``status: "ok"``, flops above
  0 and collectives above 0 (the model axis is 2).
* A fake trace at world 1 counts exactly the flops and op bytes of the
  same step run on CPU tensors over a real gloo group of one.
* The depth extrapolation equals a direct trace at the full (reduced)
  depth, for a dense and a MoE config.
* The rank-local ``masked_fill`` and ``index_write`` of sharding/api.py
  give each rank its slice of the one-device result.
* A cell's argument and peak temporary bytes are those of its direct
  full-depth trace, with or without the extrapolation.
* The CLIs: the dry-run on the 256-rank production mesh (cut to 2 layers)
  writes an ``ok`` record and the roofline prints its table; without a
  card the dry-run needs ``--device cpu``, and the roofline refuses a
  directory whose records name two devices.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.launch import shapes as rshapes  # noqa: E402
from repro.utils.hlo import collective_bytes as ref_collective_bytes  # noqa
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding import api as shapi  # noqa: E402
from repro_torch.utils import comms  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# tests/test_dryrun_small.py's cells and its HLO of five collectives
CELLS = [("olmo-1b", "train"), ("llama3-405b", "prefill"),
         ("falcon-mamba-7b", "decode"), ("zamba2-1.2b", "train"),
         ("whisper-medium", "prefill"), ("qwen2-vl-2b", "decode"),
         ("arctic-480b", "train")]
HLO = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %x), dims={0}
  %ar.1 = f32[256]{0} all-reduce(f32[256]{0} %y), to_apply=%sum
  %rs = f32[32]{0} reduce-scatter(f32[256]{0} %z), dimensions={0}
  %cp = f32[64]{0} collective-permute(f32[64]{0} %w)
  %a2a = bf16[4,64]{1,0} all-to-all(bf16[4,64]{1,0} %v), dimensions={0}
  %ard = f32[256]{0} all-reduce-done(f32[256]{0} %ars)
  %dot = f32[8,8]{1,0} dot(f32[8,8] %a, f32[8,8] %b)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_models.py): the shapes are
    tiny, and beside other test workers torch's default oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_model_flops():
    """The reference's ``_model_flops``, its own source run over its own
    shape table."""
    tree = ast.parse((REPO / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_model_flops")
    ns = {"shapes_mod": rshapes}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "dryrun.py",
                 "exec"), ns)
    return ns["_model_flops"]


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_reference(arch):
    ref = _ref_model_flops()
    for shape in rshapes.SHAPES:
        assert D._model_flops(get_arch(arch), shape) == \
            ref(ref_arch(arch), shape), shape


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_memory_bytes_match_reference(arch):
    for shape in rshapes.SHAPES:
        for n_chips in (1, 256, 512):
            for fsdp in (False, True):
                assert R.analytic_memory_bytes(arch, shape, n_chips, fsdp) \
                    == rroof.analytic_memory_bytes(arch, shape, n_chips,
                                                   fsdp), (shape, n_chips)


def test_collective_bytes_match_the_hlo_parser():
    import torch.distributed._functional_collectives as funcol

    bf16 = torch.bfloat16
    with D.fake_world(8):
        group = dist.group.WORLD
        census = comms.StepCensus()
        with census:
            outs = [
                funcol.all_gather_tensor(torch.zeros(1, 128, dtype=bf16), 0,
                                         group),
                funcol.all_reduce(torch.zeros(256), "sum", group),
                funcol.reduce_scatter_tensor(torch.zeros(256), "sum", 0,
                                             group),
                funcol.broadcast(torch.zeros(64), 0, group),
                # bf16[4,64]'s bytes, in rows the 8 ranks split evenly
                funcol.all_to_all_single(torch.zeros(8, 32, dtype=bf16),
                                         None, None, group)]
            shapes = [tuple(o.wait().shape) for o in outs]
    assert shapes == [(8, 128), (256,), (32,), (64,), (8, 32)]
    assert [r["kind"] for r in census.records] == [
        "all-gather", "all-reduce", "reduce-scatter", "collective-permute",
        "all-to-all"]
    got = comms.collective_bytes(census.records)
    assert got == ref_collective_bytes(HLO)
    assert comms.collective_counts(census.records) == dict(
        {k: 1 for k in got if k not in ("total", "count")}, count=5)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_reduced_cells_trace_on_a_fake_world(arch, kind, tmp_path,
                                              monkeypatch):
    shape = f"tiny_{kind}"
    monkeypatch.setitem(S.SHAPES, shape, S.ShapeCell(shape, kind, 64, 8))
    rec = D.run_cell(arch, shape, "host4x2", out_dir=tmp_path,
                     cfg=get_arch(arch).reduced(), fsdp=False,
                     skip_delta=True, device="cpu")
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["n_chips"] == 8
    cost = rec["cost_corrected"]
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["coll"] > 0 and cost["coll_counts"]["count"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["dominant"] in rec["roofline"]
    assert json.loads((tmp_path / f"{arch}__{shape}__host4x2.json")
                      .read_text())["status"] == "ok"


def _train_cell(monkeypatch, seq=64, batch=8):
    shape = f"train_{seq}x{batch}"
    monkeypatch.setitem(S.SHAPES, shape, S.ShapeCell(shape, "train", seq,
                                                     batch))
    return shape


def test_fake_trace_counts_the_real_step(tmp_path, monkeypatch):
    cfg = get_arch("olmo-1b").reduced()
    shape = _train_cell(monkeypatch)
    cell = S.SHAPES[shape]
    tmesh.init_lane_group("gloo", 0, 1, store=dist.FileStore(
        str(tmp_path / "store"), 1), timeout_s=60.0)
    try:
        mesh = tmesh.make_host_mesh(device_type="cpu")
        plan = D._single_pod_plan_axes(mesh, D._plan_for(cfg, fsdp=False))
        params, axes = M.init_model(0, cfg, device="cpu")
        params = D._placed(params, mesh, shapi.param_shardings(
            plan, mesh, params, axes))
        opt = tsteps.default_optimizer()
        state = opt.init(params)
        batch = S.make_inputs(cfg, "train", cell.seq, cell.batch,
                              device="cpu")
        step = tsteps.build_train_step(cfg, mesh, plan, opt)
        real = comms.StepCensus()
        real.exclude((params, state, batch))
        with real:
            step(params, state, batch)
    finally:
        dist.destroy_process_group()
    with D.fake_world(1):
        mesh = tmesh.make_host_mesh(device_type="cpu")
        plan = D._single_pod_plan_axes(mesh, D._plan_for(cfg, fsdp=False))
        fake, _, _, _ = D._trace_cell(cfg, shape, mesh, plan, device="cpu")
    assert real.flops > 0 and real.op_bytes > 0
    assert (fake.flops, fake.op_bytes) == (real.flops, real.op_bytes)
    assert fake.records == real.records == []


@pytest.mark.parametrize("arch,layers", [("olmo-1b", 3),
                                         ("arctic-480b", 3)])
def test_delta_extrapolation_equals_a_direct_trace(arch, layers,
                                                   monkeypatch):
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=layers)
    shape = _train_cell(monkeypatch, seq=32, batch=4)
    with D.fake_world(4):
        mesh = D._mesh("host2x2", "cpu")
        plan = D._single_pod_plan_axes(mesh, D._plan_for(cfg, fsdp=False))
        delta = D.measure_cell(cfg, shape, mesh, plan, device="cpu")
        direct = D.measure_cell(cfg, shape, mesh, plan, skip_delta=True,
                                device="cpu")
    _, _, u2, u4, u_full = D._delta_cfgs(cfg)
    assert u2 < u_full < u4 and cfg.family == ("moe" if "arctic" in arch
                                              else "dense")
    for k in ("flops", "bytes", "coll"):
        assert delta["cost_corrected"][k] == direct["cost_corrected"][k], k
        assert delta["cost_raw"][k] == direct["cost_raw"][k], k
    # memory is the full-depth trace's: a peak is not linear in depth
    # (olmo's reduced stack peaks 4% under the 2/4-layer line at 3)
    for k in ("argument_size_in_bytes", "temp_size_in_bytes"):
        assert delta["memory"][k] == direct["memory"][k], k
    assert delta["cost_corrected"]["coll"] > 0


def test_private_apis_and_flop_formulas():
    """What the census leans on (comms.pins), and its flops equal to
    FlopCounterMode's on a plain step."""
    from torch.utils.flop_counter import FlopCounterMode

    assert comms.pins()["torch"] == torch.__version__
    cfg = get_arch("olmo-1b").reduced()
    params, _ = M.init_model(0, cfg, device="cpu")
    opt = tsteps.default_optimizer()
    state = opt.init(params)
    batch = S.make_inputs(cfg, "train", 32, 2, device="cpu")
    step = tsteps.build_train_step(cfg, optimizer=opt)
    fc = FlopCounterMode(display=False)
    with fc:
        step(params, state, batch)
    census = comms.StepCensus()
    with census:
        step(params, state, batch)
    assert census.flops == fc.get_total_flops() > 0
    assert comms.op_flops_table(census)["dot_flops_estimate"] \
        == census.flops


def test_rank_local_mask_and_cache_writes():
    """Rank 0 of a (1, 2) mesh holds the first half of the split dim: its
    shard after ``masked_fill`` / ``index_write`` is that half of the
    one-device result (values real, the fake group moves nothing)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, generator=g)
    mask = torch.arange(8) % 3 == 0
    buf = torch.randn(2, 8, 1, 4, generator=g)
    val = torch.randn(2, 2, 1, 4, generator=g)
    idx = torch.tensor([2, 5])
    with D.fake_world(2):
        mesh = tmesh.make_host_mesh(model=2, device_type="cpu")
        dx = distribute_tensor(x, mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        got = shapi.masked_fill(dx, mask, -1.0)
        assert isinstance(got, DTensor)
        assert torch.equal(got.to_local(), x.masked_fill(mask, -1.0)[:, :4])
        db = distribute_tensor(buf.clone(), mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        shapi.index_write(db, 1, idx, val)
        want = buf.clone().index_copy_(1, idx, val)
        assert torch.equal(db.to_local(), want[:, :4])
        assert tuple(db.placements) == (Replicate(), Shard(1))
    plain = buf.clone()
    assert shapi.index_write(plain, 1, idx, val) is plain
    assert torch.equal(plain, want)
    assert torch.equal(shapi.masked_fill(x, mask, -1.0),
                       x.masked_fill(mask, -1.0))


def test_dryrun_and_roofline_clis(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "dryrun"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "train_4k", "--mesh", "single",
         "--skip-delta", "--override", "n_layers=2", "--out", str(out),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((out / "olmo-1b__train_4k__single.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s"}
    for k in ("argument_size_in_bytes", "temp_size_in_bytes"):
        assert rec["memory"][k] > 0
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(out)], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "| olmo-1b | train_4k | cpu |" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_dryrun_without_a_card_needs_device_cpu(tmp_path):
    """``--device`` defaults to cuda: with no card the CLI refuses rather
    than trace CPU fake tensors, and ``run_cell`` raises."""
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "olmo-1b", "--shape", "train_4k", "--out",
                str(tmp_path)])
    assert e.value.code == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.run_cell("olmo-1b", "train_4k", "single", out_dir=tmp_path)
    assert not list(tmp_path.iterdir())


def test_roofline_refuses_records_of_two_devices(tmp_path, capsys):
    rec = {"arch": "olmo-1b", "shape": "train_4k", "mesh": "single",
           "status": "skipped", "reason": "cut", "device": "cpu"}
    (tmp_path / "olmo-1b__train_4k__single.json").write_text(json.dumps(rec))
    R.main(["--dir", str(tmp_path)])
    assert "| olmo-1b | train_4k | cpu | — |" in capsys.readouterr().out
    rec.update(arch="arctic-480b", device="cuda")
    (tmp_path / "arctic-480b__train_4k__single.json").write_text(
        json.dumps(rec))
    with pytest.raises(ValueError, match="mixes records"):
        R.load_records(tmp_path, "single")
    with pytest.raises(SystemExit) as e:
        R.main(["--dir", str(tmp_path)])
    assert e.value.code == 2


def _fsdp_trace(cfg, shape, mesh_kind="host4x1"):
    """One FSDP step of ``cfg`` traced on a fake world (model = 1 on
    ``host4x1``: every all-gather is one of FSDP's): the census, the
    memory record, and the placements of the parameters."""
    with D.fake_world(D._world(mesh_kind)):
        mesh = D._mesh(mesh_kind, "cpu")
        plan = D._single_pod_plan_axes(mesh, D._plan_for(cfg, fsdp=True))
        census, memory, _, _ = D._trace_cell(cfg, shape, mesh, plan,
                                             device="cpu")
        skeleton, axes = M._build(cfg, M._meta)
        specs = shapi.param_specs(plan, shapi.mesh_sizes(mesh), skeleton,
                                  axes)
    return census, memory, skeleton, specs


def _spec_leaves(specs) -> list:
    if isinstance(specs, dict):
        return [(f"{k}.{p}" if p else k, s) for k in sorted(specs)
                for p, s in _spec_leaves(specs[k])]
    return [("", specs)]


def _expected_gathers(cfg, skeleton, specs) -> tuple:
    """All-gathers of one FSDP step, from the placements: each stack leaf
    split off its stack dim twice a unit (its block's forward and its
    recompute), a leaf split on its stack dim once (gathered whole before
    the loop), every other leaf (the top-level ones, zamba2's shared
    block) once at its use. Also the bytes one unit of the stack holds
    gathered."""
    stacks = ("blocks", "units", "tail", "enc_blocks")
    n, unit_bytes = 0, 0
    for (path, spec), x in zip(_spec_leaves(specs), tree.leaves(skeleton)):
        if "data" not in spec:
            continue
        if path.split(".")[0] not in stacks:
            n += 1
        elif spec[0] == "data":
            n += 1
        else:
            n += 2 * x.shape[0]
        if path.split(".")[0] in ("blocks", "units"):
            unit_bytes += x.numel() // x.shape[0] * x.element_size()
    return n, unit_bytes


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_fsdp_gathers_a_unit_at_a_time(arch, monkeypatch):
    """FSDP gathers a unit of the stack inside its recomputed block
    (models.model._scan_stack): the census counts each stack leaf's
    all-gather twice a unit (forward and recompute) and every other
    leaf's once, at 2 and 4 units; zamba2's nested Mamba stack gathers at
    its unit, its shared block once, and at 4 units three of its leaves are
    split on the stack dim (gathered whole, once). Going from 2 to 4
    units, olmo-1b's traced peak of temporaries grows by less than one
    unit's gathered parameters a unit (a gather of the whole model grows
    by two units' gathered weights and gradients a unit)."""
    shape = _train_cell(monkeypatch, seq=16, batch=8)
    base = get_arch(arch).reduced()
    unit = base.hybrid_attn_every or 1
    peaks, stack_axis = {}, {}
    for units in (2, 4):
        cfg = dataclasses.replace(base, n_layers=units * unit)
        census, memory, skeleton, specs = _fsdp_trace(cfg, shape)
        want, unit_bytes = _expected_gathers(cfg, skeleton, specs)
        counts = comms.collective_counts(census.records)
        assert counts["all-gather"] == want, (units, counts, want)
        peaks[units] = memory["temp_size_in_bytes"]
        stack_axis[units] = sum(
            1 for path, s in _spec_leaves(specs)
            if path.startswith(("blocks", "units")) and s[0] == "data")
    if arch == "olmo-1b":
        assert 0 < (peaks[4] - peaks[2]) / 2 < unit_bytes, (peaks,
                                                           unit_bytes)
        assert stack_axis == {2: 0, 4: 0}
    else:
        assert stack_axis == {2: 0, 4: 3}


def test_whole_heads_splits_the_batch_in_training():
    """3 heads over a model axis of 2 do not split: in training the model
    axis splits the batch instead (each rank attends whole heads of half
    the sequences), where the batch divides; otherwise, and outside
    training, the heads are gathered. Heads that split pass as they
    are."""
    from torch.distributed.tensor import Replicate, Shard, \
        distribute_tensor

    with D.fake_world(4):
        mesh = tmesh.make_host_mesh(model=2, device_type="cpu")
        x = distribute_tensor(torch.zeros(4, 8, 48), mesh,
                              [Shard(0), Shard(2)], src_data_rank=None)
        assert shapi.whole_heads(x, 3, split_batch=True).placements == (
            Shard(0), Shard(0))
        assert shapi.whole_heads(x, 3).placements == (Shard(0),
                                                      Replicate())
        odd = distribute_tensor(torch.zeros(6, 8, 48), mesh,
                                [Shard(0), Shard(2)], src_data_rank=None)
        assert shapi.whole_heads(odd, 3, split_batch=True).placements == (
            Shard(0), Replicate())
        assert shapi.whole_heads(x, 4, split_batch=True) is x


def test_recompute_gathers_on_autograd_thread():
    """The backward of CUDA tensors runs on autograd's device thread, which
    does not see the forward thread's activation context: the recomputed
    block re-enters it (models.model._maybe_remat). Here the backward
    runs on a thread of its own, and the census there counts the
    recompute's gather of every FSDP stack leaf of every unit."""
    import threading

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = dataclasses.replace(get_arch("olmo-1b").reduced(), n_layers=2)
    batch = S.make_inputs(cfg, "train", 16, 8, device="cpu")
    got = []
    with D.fake_world(4):
        mesh = D._mesh("host4x1", "cpu")
        plan = D._single_pod_plan_axes(mesh, D._plan_for(cfg, fsdp=True))
        params, axes = M.init_model(0, cfg, device="cpu")
        params = shapi.distribute(params, mesh, shapi.param_shardings(
            plan, mesh, params, axes))
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        xs = tree.unflatten(tree.flatten(params)[1], leaves)
        placed = {k: distribute_tensor(v, mesh, tsteps.batch_sharding(
            mesh, plan, {k: v})[k], src_data_rank=None)
            for k, v in batch.items()}
        with shapi.activation_context(mesh, plan):
            loss, _ = M.loss_fn(cfg, xs, placed)

            def backward():
                # the engine carries torch's thread state (DTensor's
                # implicit replication) to its thread, not Python's
                census = comms.StepCensus()
                with implicit_replication(), census:
                    torch.autograd.grad(loss, leaves)
                got.append(census)

            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        skeleton, axes = M._build(cfg, M._meta)
        specs = _spec_leaves(shapi.param_specs(
            plan, shapi.mesh_sizes(mesh), skeleton, axes))
    stack = [s for path, s in specs if path.startswith("blocks")
             and "data" in s]
    assert stack and comms.collective_counts(got[0].records)[
        "all-gather"] == len(stack) * cfg.n_layers
