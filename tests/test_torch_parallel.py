"""The port's data- and model-parallel training (sharding/api.py's model
plan, launch/mesh.py's model meshes, launch/steps.py over a mesh,
optim/adamw.py on DTensors, optim/compression.py, checkpoint/io.py's
gathered saves and elastic restore, launch/train.py's ``--model-parallel``
/ ``--fsdp``) against the JAX package, on the CPU over gloo.

Three layers:

1. Placement arithmetic, in process: the port's specs of every leaf of
   every architecture (reduced, and full through ``param_skeleton``)
   equal the reference's ``param_shardings`` on an ``AbstractMesh`` of
   (4, 2) and (2, 16, 16), with FSDP on and off, ``seq_shard`` and
   ``tp_full``; ``batch_sharding`` and ``cache_sharding`` likewise; and
   ``constrain`` is a no-op without a context.
2. A gloo group of one (a ``FileStore`` in ``tmp_path``): the meshes, and
   the train step on a (1, 1) mesh against the one-device step.
3. One spawn per world size D in {2, 4} (tests/torch_parallel_ranks.py:
   gloo ranks that import no JAX): the reference's four DIST cases of
   tests/test_sharding.py (olmo-1b, olmo-1b FSDP with 2 microbatches,
   llama4-maverick, zamba2) plus reduced falcon-mamba, whisper and
   qwen2-vl take one step, held to the reference's single-device step on
   an ``Auto`` (1, 1) mesh (the reference's own sharded step fails under
   jax 0.9.0 beyond it, ROADMAP Queue 3); ``compressed_psum`` against the
   reference's ``quantize_int8`` / ``dequantize`` replayed for each
   rank's shard; elastic restore from D = 2 to D = 4 and to one device;
   the launcher with ``--model-parallel 2 --fsdp`` on D = 4; and the
   collectives each rank records (``utils.comms.StepCensus``) over one
   data = 2 step, against the dry-run's fake world-2 trace of it.

Tolerances (those of tests/test_torch_train.py): loss within 2e-5
relative, parameters within 1e-5 and first moments within 1e-4 of each
leaf's largest entry, AdamW at eps = 1e-3, against the reference and
against the port's one-device step; every rank of a world returns the
same loss bits and the same logical arrays (a digest). Two kinds of leaf
are read otherwise, the same way in every case. A key projection's bias
has a gradient of zero in exact arithmetic (the softmax cancels it;
tests/test_torch_encdec.py): its parameter and moment are held within
1e-6 of the tree's largest entry. A leaf that the reference initialises
to zero (the biases, the Mamba conv bias) holds after one step nothing
but the update lr m / (sqrt(v) + eps), whose last bits move 1 / eps =
1000 times the gradient's: its parameter is held within 1e-4 of its
largest entry (the port's own one-device step is 1.3e-5 from the
reference on zamba2's ``conv_b`` and 1.6e-5 on qwen2-vl's ``wv.b``). Restored
logical arrays equal the saved ones bit for bit, and the second step's
loss after a restore is within 1e-6 relative of the uninterrupted run's.
``compressed_psum`` within 1e-6 of the formula (the same f32 operations
in another order)."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import shapes as rshapes  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.optim import compression as rcomp  # noqa: E402
from repro.optim import warmup_cosine as r_warmup_cosine  # noqa: E402
from repro.sharding import api as rshapi  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.sharding import api as tshapi  # noqa: E402
import torch_parallel_ranks as ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = ranks.JOIN_TIMEOUT_S + 30.0
B, T = 4, 16

# the reference's DIST cases (tests/test_sharding.py) and the other
# families: (arch, fsdp, microbatches, {world: model-axis size}); an
# integer fsdp turns FSDP on with that ``fsdp_min_size``
TRAIN = {
    "olmo": ("olmo-1b", False, 1, {2: 2, 4: 2}),
    "olmo_fsdp_mb2": ("olmo-1b", True, 2, {2: 1, 4: 2}),
    "llama4": ("llama4-maverick-400b-a17b", False, 1, {2: 2, 4: 2}),
    "zamba2": ("zamba2-1.2b", False, 1, {2: 2, 4: 2}),
    "falcon_mamba": ("falcon-mamba-7b", False, 1, {2: 1, 4: 2}),
    "whisper": ("whisper-medium", False, 1, {2: 2, 4: 2}),
    "qwen2_vl": ("qwen2-vl-2b", False, 1, {2: 1, 4: 2}),
    # FSDP a unit at a time: the MoE unit's sub-blocks, and the hybrid's
    # nested Mamba stack and shared block
    "llama4_fsdp": ("llama4-maverick-400b-a17b", True, 1, {2: 1, 4: 2}),
    "zamba2_fsdp": ("zamba2-1.2b", True, 1, {2: 1, 4: 2}),
    # FSDP down to 64 entries a leaf: the per-layer biases, split on
    # their stack dim, are gathered whole before the stack unbinds them
    "whisper_fsdp_stack": ("whisper-medium", 64, 1, {2: 1, 4: 2}),
    # 3 query heads and 1 KV head over a model axis of 2: the heads do not
    # split, so the model axis splits the batch for the attention
    # (sharding.api.whole_heads)
    "llama3_odd_heads": ("llama3-405b", True, 1, {2: 2, 4: 2}),
}
# config fields a case sets on the reduced config, in both packages
TRAIN_CFG = {"llama3_odd_heads": {"n_heads": 3, "n_kv_heads": 1}}
LAUNCH_ARGV = ["--arch", "olmo-1b", "--smoke", "--steps", "2",
               "--save-every", "2", "--seq", "16", "--batch", "4",
               "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (tier-1 shares the cores with other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hold(got, want, names, zero, tol, what):
    """``got`` against ``want`` leaf by leaf, under the module's rules:
    within ``tol`` of each leaf's largest entry; a key bias within 1e-6
    of the tree's largest entry; a zero-initialised leaf within
    max(tol, 1e-4) of its own."""
    top = max(np.abs(np.asarray(w)).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, names[i])
        err = np.abs(g - w).max()
        if names[i].endswith("wk.b"):
            assert err <= 1e-6 * top, (what, names[i], err, top)
            continue
        lim = max(tol, 1e-4) if zero[i] else tol
        assert err <= lim * max(np.abs(w).max(), 1e-30), \
            (what, names[i], err, np.abs(w).max())


def _close(got, want, tol, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), \
            (what, i, np.abs(g - w).max(), np.abs(w).max())


# ---------------------------------------------------------------------------
# 1. Placement arithmetic


def _flat(t) -> list:
    """The leaves of a tree of dicts (sorted keys) whose leaves are specs
    or placements tuples."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    return [t]


def _ref_specs(rc, plan, amesh):
    """The reference's spec of every parameter leaf (padded to the
    leaf's rank), without materialising the parameters."""
    out = {}

    def capture():
        p, a = RM.init_model(jax.random.key(0), rc)
        out["axes"] = a
        return p

    shapes = jax.eval_shape(capture)
    shard = rshapi.param_shardings(plan, amesh, shapes, out["axes"])
    return [tuple(s.spec) + (None,) * (len(x.shape) - len(s.spec))
            for s, x in zip(jax.tree.leaves(shard), jax.tree.leaves(shapes))]


MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _plans(mesh_name):
    """(name, reference plan, port plan) for a mesh: the launcher's and
    the production plans with FSDP on and off, seq_shard and tp_full."""
    da = ("data",) if mesh_name == "4x2" else ("pod", "data")
    out = []
    for kw in (dict(fsdp=False), dict(fsdp=True), dict(seq_shard=True),
               dict(tp_full=True, fsdp=True)):
        out.append((str(kw), rshapi.tp_plan(data_axes=da, **kw),
                    tshapi.tp_plan(data_axes=da, **kw)))
    return out


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, size):
    rc, cfg = ref_arch(arch), get_arch(arch)
    if size == "reduced":
        rc, cfg = rc.reduced(), cfg.reduced()
    params, axes = M._build(cfg, M._meta)
    for mname, (shape, names) in MESHES.items():
        amesh = AbstractMesh(shape, names)
        sizes = dict(zip(names, shape))
        for pname, rplan, tplan in _plans(mname):
            assert tplan == tshapi.Plan(rules=rplan.rules, fsdp=rplan.fsdp)
            want = _ref_specs(rc, rplan, amesh)
            got = _flat(tshapi.param_specs(tplan, sizes, params, axes))
            assert got == want, (arch, size, mname, pname)
            pls = _flat(tshapi.param_shardings(tplan, sizes, params, axes))
            assert pls == [tshapi.placements(s, sizes) for s in want]


def test_spec_rules_as_the_reference_tests_them():
    """tests/test_sharding.py's rules, on the port."""
    plan = tshapi.tp_plan(fsdp=False)
    shape = (4, 128, 512, 2048)
    ax = ("layers", "expert", "embed", "mlp")
    assert tshapi.spec_for_param(plan, ax, shape) == \
        (None, "model", None, None)
    assert tshapi.spec_for_param(tshapi.tp_plan(fsdp=True), ax, shape) == \
        (None, "model", None, "data")
    assert tshapi.spec_for_param(tshapi.tp_plan(fsdp=True), ("embed",),
                                 (64,)) == (None,)
    assert tshapi.tp_plan(seq_shard=True).rules["seq"] == "model"
    # a dim that does not divide is replicated; a tuple entry takes each
    # of its axes in mesh order
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert tshapi._fix_divisibility((("pod", "data"), "model"), (64, 24),
                                    sizes) == (("pod", "data"), None)
    from torch.distributed.tensor import Replicate, Shard
    assert tshapi.placements((("pod", "data"), "model"), sizes) == \
        (Shard(0), Shard(0), Shard(1))
    assert tshapi.placements((None, None), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tshapi.placements((("data", "pod"),), sizes)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_sharding_match_reference(arch):
    rc, cfg = ref_arch(arch).reduced(), get_arch(arch).reduced()
    for mname, (shape, names) in MESHES.items():
        amesh = AbstractMesh(shape, names)
        sizes = dict(zip(names, shape))
        da = ("data",) if mname == "4x2" else ("pod", "data")
        for kw in (dict(), dict(tp_full=True)):
            rplan = rshapi.tp_plan(data_axes=da, **kw)
            tplan = tshapi.tp_plan(data_axes=da, **kw)
            for batch in (8, 6, 64):
                rb = rshapes.make_inputs(rc, "train", seq=16, batch=batch)
                want = [tshapi.placements(
                    tuple(s.spec) + (None,) * (x.ndim - len(s.spec)), sizes)
                    for s, x in zip(
                        jax.tree.leaves(rsteps.batch_sharding(
                            amesh, rplan, rb)), jax.tree.leaves(rb))]
                tb = {k: torch.empty(v.shape, device="meta")
                      for k, v in rb.items()}
                got = _flat(tsteps.batch_sharding(sizes, tplan, tb))
                assert got == want, (arch, mname, kw, batch)
                for q in (False, True):
                    rc_ = jax.eval_shape(lambda: RM.make_caches(
                        rc, batch, 32, jnp.float32, quantized_kv=q))
                    rsh = rsteps.cache_sharding(rc, amesh, rplan, rc_)
                    want = [tshapi.placements(
                        tuple(s.spec) + (None,) * (len(x.shape)
                                                   - len(s.spec)), sizes)
                        for s, x in zip(jax.tree.leaves(rsh),
                                        jax.tree.leaves(rc_))]
                    tc = M.make_caches(cfg, batch, 32, torch.float32,
                                       quantized_kv=q, device="meta")
                    got = ranks_flat(tsteps.cache_sharding(cfg, sizes, tplan,
                                                           tc))
                    assert got == want, (arch, mname, kw, batch, q)


def ranks_flat(t) -> list:
    """The placements tuples of a cache-shaped tree, in tree order."""
    return tshapi._placement_leaves(t)


def _stack_axis_leaves(cfg, plan, sizes) -> list:
    """The stacked leaves whose FSDP shard falls on their stack dim."""
    params, axes = M._build(cfg, M._meta)
    specs = _flat(tshapi.param_specs(plan, sizes, params, axes))
    return [(tuple(x.shape), s) for x, a, s in zip(
        tree.leaves(params), tshapi._axes_leaves(axes), specs)
        if a[0] == "layers" and s[0] == plan.fsdp_axis]


def test_which_architectures_split_a_stack_dim():
    """FSDP picks a leaf's largest free dim, which is the stack dim for
    the per-layer biases over a model-split width and the SSM's small
    leaves: at the published widths of four architectures on 2 x 2 (the
    stack gathers those leaves whole, models.model._scan_stack), at none
    of the reduced ones."""
    plan = tshapi.tp_plan(data_axes=("data",), fsdp=True)
    # on 16 x 16 only falcon-mamba's 64 layers divide by the data axis
    for sizes, want in (({"data": 2, "model": 2}, {
            "falcon-mamba-7b", "qwen2-vl-2b", "whisper-medium",
            "zamba2-1.2b"}), ({"data": 16, "model": 16},
                              {"falcon-mamba-7b"})):
        hit = {a for a in list_archs()
               if _stack_axis_leaves(get_arch(a), plan, sizes)}
        assert hit == want, sizes
        assert not any(_stack_axis_leaves(get_arch(a).reduced(), plan,
                                          sizes) for a in list_archs())
    # the reduced whisper of TRAIN's stack case splits its biases so
    small = dataclasses.replace(plan, fsdp_min_size=64)
    got = _stack_axis_leaves(get_arch("whisper-medium").reduced(), small,
                             {"data": 2, "model": 2})
    assert got and all(s[0] == "data" for _, s in got)


def test_constrain_is_a_no_op_without_a_context():
    x = torch.randn(2, 3, 4)
    assert tshapi.constrain(x, ("batch", "seq", "embed")) is x
    assert tshapi.active() is None


def test_steps_refuse_a_mesh_without_a_plan():
    cfg = get_arch("olmo-1b").reduced()
    with pytest.raises(ValueError, match="together"):
        tsteps.build_train_step(cfg, mesh=object())


# ---------------------------------------------------------------------------
# 2. A gloo group of one


@pytest.fixture
def unit_group(tmp_path):
    tmesh.init_lane_group("gloo", 0, 1, store=dist.FileStore(
        str(tmp_path / "store"), 1), timeout_s=60.0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_of_a_unit_group(unit_group):
    mesh = tmesh.make_host_mesh(device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert tmesh.data_axes_for(mesh) == ("data",)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(model=2, device_type="cpu")
    for multi in (False, True):
        with pytest.raises(ValueError, match="world size 1"):
            tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")


def test_meshes_need_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(device_type="cpu")


def _ref_params(arch, changes=None):
    rc = dataclasses.replace(ref_arch(arch).reduced(), **(changes or {}))
    rp, _ = RM.init_model(jax.random.key(0), rc)
    return rc, rp


@pytest.mark.parametrize("fsdp,mb", [(False, 1), (True, 2)])
def test_unit_mesh_step_matches_one_device(unit_group, fsdp, mb):
    """A (1, 1) mesh against the one-device step, two steps, from the
    reference's parameters."""
    rc, rp = _ref_params("olmo-1b")
    cfg = get_arch("olmo-1b").reduced()
    leaves = [np.asarray(x) for x in jax.tree.leaves(rp)]
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in
             rshapes.make_inputs(rc, "train", seq=T, batch=B).items()}
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 10), eps=1e-3)
    mesh = tmesh.make_host_mesh(device_type="cpu")
    plan = tshapi.tp_plan(data_axes=("data",), fsdp=fsdp)
    tp = convert.params_from_numpy(cfg, leaves, device="cpu")
    axes = M._build(cfg, M._meta)[1]
    dp = tshapi.distribute(convert.params_from_numpy(cfg, leaves,
                                                     device="cpu"),
                           mesh, tshapi.param_shardings(plan, mesh, tp,
                                                        axes))
    one = tsteps.build_train_step(cfg, optimizer=opt, microbatches=mb)
    par = tsteps.build_train_step(cfg, mesh, plan, opt, microbatches=mb)
    ts, ds = opt.init(tp), opt.init(dp)
    for _ in range(2):
        tp, ts, tm = one(tp, ts, batch)
        dp, ds, dm = par(dp, ds, batch)
        assert abs(float(dm["loss"]) - float(tm["loss"])) <= \
            2e-5 * abs(float(tm["loss"]))
    _close([x.full_tensor().numpy() for x in tree.leaves(dp)],
           [x.numpy() for x in tree.leaves(tp)], 1e-5, "params")
    _close([x.full_tensor().numpy() for x in tree.leaves(ds.m)],
           [x.numpy() for x in tree.leaves(ts.m)], 1e-4, "m")


def test_unit_mesh_serve_steps_match_one_device(unit_group):
    """Prefill and two decode steps over a (1, 1) mesh give the one-device
    logits (the activations are DTensors; the caches are written in
    place)."""
    cfg = get_arch("olmo-1b").reduced()
    params, axes = M.init_model(0, cfg, device="cpu")
    mesh = tmesh.make_host_mesh(device_type="cpu")
    plan = tshapi.tp_plan(data_axes=("data",))
    dp = tshapi.distribute(params, mesh, tshapi.param_shardings(
        plan, mesh, params, axes))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 9)), dtype=torch.int32)
    logits = []
    for p, m, pl in ((params, None, None), (dp, mesh, plan)):
        caches = M.make_caches(cfg, 2, 12, torch.float32, device="cpu")
        if m is not None:
            caches = tshapi.distribute(caches, m, tsteps.cache_sharding(
                cfg, m, pl, caches))
        pre = tsteps.build_prefill_step(cfg, m, pl)
        dec = tsteps.build_decode_step(cfg, m, pl)
        caches, lg = pre(p, {"tokens": toks[:, :7]}, caches)
        out = [lg]
        for i in (7, 8):
            caches, lg = dec(p, caches, {
                "tokens": toks[:, i:i + 1],
                "position": torch.full((1,), i, dtype=torch.int32)})
            out.append(lg)
        logits.append([x.full_tensor() if hasattr(x, "full_tensor") else x
                       for x in out])
    for a, b in zip(*logits):
        assert torch.allclose(b, a, rtol=1e-5, atol=1e-5)


def test_optimizer_on_plain_leaves_keeps_its_bits():
    """No mesh: AdamW's update is the one-device arithmetic (a second
    optimizer built the same way gives the same bits)."""
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(5, 3, generator=g)}
    grads = {"w": torch.randn(5, 3, generator=g)}
    opt = AdamW(lr=1e-2)
    st = opt.init(p)
    p2, st2, m = opt.update(grads, st, {"w": p["w"].clone()})
    gn = torch.sqrt(torch.sum(grads["w"] * grads["w"]))
    assert torch.equal(m["grad_norm"], gn)
    assert p2["w"].dtype == torch.float32 and int(st2.count) == 1


# ---------------------------------------------------------------------------
# 3. Spawned worlds


def _train_case(name):
    arch, fsdp, mb, meshes = TRAIN[name]
    rc, rp = _ref_params(arch, TRAIN_CFG.get(name))
    batch = {k: np.asarray(v) for k, v in
             rshapes.make_inputs(rc, "train", seq=T, batch=B).items()}
    paths = jax.tree_util.tree_flatten_with_path(rp)[0]
    return dict(kind="train", arch=arch, fsdp=fsdp, mb=mb, meshes=meshes,
                changes=TRAIN_CFG.get(name, {}),
                params=[np.asarray(x) for x in jax.tree.leaves(rp)],
                names=[".".join(str(k.key) for k in pth)
                       for pth, _ in paths],
                batch=batch)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    cases = {f"train_{n}": _train_case(n) for n in TRAIN}
    olmo = cases["train_olmo"]
    cases["compress"] = dict(kind="compress")
    cases["restore"] = dict(kind="restore", arch="olmo-1b",
                            params=olmo["params"], batch=olmo["batch"],
                            ckpt=str(root / "ckpt"))
    cases["launcher"] = dict(kind="launcher", worlds=(4,), argv=LAUNCH_ARGV
                             + ["--model-parallel", "2", "--fsdp"],
                             dir=str(root / "launch"))
    cases["place"] = dict(kind="place", archs=("olmo-1b", "zamba2-1.2b",
                                                "llama4-maverick-400b-a17b"))
    # data = 2: the step's collectives, recorded by utils.comms
    cases["census_olmo"] = dict(olmo, worlds=(2,), meshes={2: 1},
                                census=True)
    return root, {"cases": cases}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs):
    """``spawned(D)``: every rank's results of one spawn of D ranks. Both
    worlds start before the module's first test, each rank on one thread,
    and run while this process tests the placements and the unit mesh
    and computes the reference's steps (world 4's restore waits for world
    2's checkpoint)."""
    root, inp = inputs
    path = root / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs, cache = {}, {}
    for world in WORLDS:
        out = root / f"world{world}"
        out.mkdir()
        procs[world] = (subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_parallel_ranks.py"),
             str(world), str(path), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)

    def run(world):
        if world not in cache:
            proc, out = procs[world]
            try:
                _, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            assert proc.returncode == 0, err[-4000:]
            cache[world] = []
            for r in range(world):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    cache[world].append(pickle.load(f))
        return cache[world]

    yield run
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_steps(inputs):
    """The reference's single-device step of every train case, on an
    ``Auto`` (1, 1) mesh (its activation constraints raise under jax's
    default Explicit axes, ROADMAP Queue 3)."""
    _, inp = inputs
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    out = {}
    for name in TRAIN:
        case = inp["cases"][f"train_{name}"]
        rc = dataclasses.replace(ref_arch(case["arch"]).reduced(),
                                 **case["changes"])
        rp = jax.tree.unflatten(
            jax.tree.structure(RM.init_model(jax.random.key(0), rc)[0]),
            [jnp.asarray(x) for x in case["params"]])
        plan = rshapi.tp_plan(data_axes=("data",), model_axis="model",
                              fsdp=bool(case["fsdp"]))
        ropt = RAdamW(lr=r_warmup_cosine(1e-2, 1, 10), eps=1e-3)
        step = jax.jit(rsteps.build_train_step(rc, mesh, plan, ropt,
                                               microbatches=case["mb"]))
        rb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        with mesh:
            p2, s2, m = step(rp, ropt.init(rp), rb)
        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  **case["changes"])
        opt = AdamW(lr=warmup_cosine(1e-2, 1, 10), eps=1e-3)
        tp = convert.params_from_numpy(cfg, case["params"], device="cpu")
        tp, ts, tm = tsteps.build_train_step(
            cfg, optimizer=opt, microbatches=case["mb"])(
            tp, opt.init(tp), {k: torch.as_tensor(v)
                               for k, v in case["batch"].items()})
        out[name] = {
            "reference": dict(
                loss=float(m["loss"]),
                params=[np.asarray(x) for x in jax.tree.leaves(p2)],
                m=[np.asarray(x) for x in jax.tree.leaves(s2.m)]),
            "one device": dict(
                loss=float(tm["loss"]),
                params=[x.numpy() for x in tree.leaves(tp)],
                m=[x.numpy() for x in tree.leaves(ts.m)])}
    return out


@pytest.mark.parametrize("name", list(TRAIN))
@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_reference(spawned, ref_steps, inputs, world,
                                      name):
    res = [r[f"train_{name}"] for r in spawned(world)]
    case = inputs[1]["cases"][f"train_{name}"]
    names = case["names"]
    zero = [not np.any(x) for x in case["params"]]
    # every rank: the same loss bits and the same logical arrays
    assert len({r["loss"].hex() for r in res}) == 1, [r["loss"] for r in res]
    assert len({r["digest"] for r in res}) == 1
    for what, want in ref_steps[name].items():
        assert abs(res[0]["loss"] - want["loss"]) <= \
            2e-5 * abs(want["loss"]), what
        _hold(res[0]["params"], want["params"], names, zero, 1e-5,
              f"{name} params vs {what}")
        _hold(res[0]["m"], want["m"], names, zero, 1e-4,
              f"{name} m vs {what}")
    # a model axis or FSDP really splits some leaf (a data axis alone
    # replicates every parameter)
    _, fsdp, _, meshes = TRAIN[name]
    split = any("Shard" in p for p in res[0]["placements"])
    assert split == (bool(fsdp) or meshes[world] > 1), \
        (name, res[0]["placements"])


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_matches_reference(spawned, world):
    res = [r["compress"] for r in spawned(world)]
    xs, rs = [], []
    for rank in range(world):
        rng = np.random.default_rng(100 + rank)
        xs.append(rng.standard_normal((33, 7)).astype(np.float32))
        rs.append(rng.standard_normal((33, 7)).astype(np.float32) * 1e-3)

    def replay(members):
        qs, ss, res_ = [], [], {}
        for r in members:
            fb = jnp.asarray(xs[r]) + jnp.asarray(rs[r])
            q, s = rcomp.quantize_int8(fb)
            qs.append(np.asarray(q, np.int32))
            ss.append(np.float32(s))
            res_[r] = np.asarray(fb - rcomp.dequantize(q, s))
        n = np.float32(len(members))
        total = np.sum(qs, axis=0).astype(np.float32)
        return total * (np.float32(np.sum(ss, dtype=np.float32)) / n) / n, \
            res_

    out, res_w = replay(range(world))
    for rank, r in enumerate(res):
        _close([r["world_out"], r["world_res"]], [out, res_w[rank]], 1e-6,
               "world")
        members = [int(m) for m in r["data_group"]]
        out_d, res_d = replay(members)
        _close([r["data_out"], r["data_res"]], [out_d, res_d[rank]], 1e-6,
               "data axis")
    assert len(members) == world // 2


@pytest.mark.parametrize("world", WORLDS)
def test_init_places_each_leaf_as_drawn(spawned, world):
    """``init_model(place=leaf_placer(...))`` under FSDP and a model axis
    gives each rank the shards, placements and bits of ``distribute`` over
    the whole draw, holding at most one whole leaf at a time."""
    for r in spawned(world):
        got = r["place"]
        assert set(got) == {"olmo-1b", "zamba2-1.2b",
                            "llama4-maverick-400b-a17b"}
        for arch, res in got.items():
            assert res["same"] and res["sharded"] > 0, (arch, res)


def test_elastic_restore(spawned, inputs):
    """World 2 saves after one step under model = 2; world 4 restores it
    under data x model with FSDP (bit for bit) and one device restores it
    too: the second step's loss matches the uninterrupted run's."""
    _, inp = inputs
    case = inp["cases"]["restore"]
    two = [r["restore"] for r in spawned(2)]
    four = [r["restore"] for r in spawned(4)]
    want = two[0]["loss2"]
    assert len({r["loss2"].hex() for r in two}) == 1
    for r in four:
        assert r["bit_equal"] and r["fsdp_sharded"] > 0
        assert abs(r["loss2"] - want) <= 1e-6 * abs(want)
    cfg = get_arch("olmo-1b").reduced()
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 10), eps=1e-3)
    tp = convert.params_from_numpy(cfg, case["params"], device="cpu")
    tp, ts = tio.restore(case["ckpt"], 1, (tp, opt.init(tp)))
    step = tsteps.build_train_step(cfg, optimizer=opt)
    _, _, m = step(tp, ts, {k: torch.as_tensor(v)
                            for k, v in case["batch"].items()})
    assert abs(float(m["loss"]) - want) <= 1e-6 * abs(want)


def test_collectives_match_the_fake_trace(spawned, monkeypatch):
    """Each real gloo rank's collectives over one data = 2 step (recorded
    by ``utils.comms.StepCensus``) equal the dry-run's fake world-2 trace
    of that step, kind by kind, in bytes and in counts."""
    from repro_torch.launch import dryrun as tdry
    from repro_torch.launch import shapes as tshapes

    shape = f"train_{T}x{B}"
    monkeypatch.setitem(tshapes.SHAPES, shape, tshapes.ShapeCell(
        shape, "train", T, B))
    cfg = get_arch("olmo-1b").reduced()
    with tdry.fake_world(2):
        mesh = tmesh.make_host_mesh(model=1, device_type="cpu")
        plan = tdry._single_pod_plan_axes(mesh, tdry._plan_for(
            cfg, fsdp=False))
        fake = tdry._measure(tdry._trace_cell(cfg, shape, mesh, plan,
                                              device="cpu")[0])
    ranks = [r["census_olmo"]["collectives"] for r in spawned(2)]
    assert fake["coll_counts"]["all-reduce"] > 0
    for got in ranks:
        assert got["bytes"] == dict(fake["coll_detail"],
                                    total=fake["coll"])
        assert got["counts"] == fake["coll_counts"]
        assert got["flops"] == fake["flops"]


def test_launcher_model_parallel_fsdp(spawned, inputs, tmp_path):
    """``--model-parallel 2 --fsdp`` on four gloo ranks: the losses of the
    one-device launcher, and the same on every rank."""
    four = [r["launcher"]["losses"] for r in spawned(4)]
    assert all(x == four[0] for x in four)
    one = tlaunch.main(LAUNCH_ARGV + ["--ckpt-dir", str(tmp_path)]).losses
    assert len(one) == len(four[0]) == 2
    for a, b in zip(four[0], one):
        assert abs(a - b) <= 2e-5 * abs(b), (four[0], one)
    _, inp = inputs
    saved = Path(inp["cases"]["launcher"]["dir"]) / "ranks" / \
        "olmo-1b-smoke"
    assert tio.latest_step(saved) == 2
