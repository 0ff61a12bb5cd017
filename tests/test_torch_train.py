"""The port's optimizer, train step, loop and checkpoints (optim/,
launch/steps.py, train/loop.py, checkpoint/io.py) against the JAX package
on reduced olmo-1b (f32).

Tolerances: an AdamW update, its moments and ``warmup_cosine`` within
1e-6 (relative to each leaf's largest entry); a train step's loss within
2e-5 relative, its first moments within 1e-4 (as the gradients in
tests/test_torch_models.py) and its parameters within 1e-5. The step test
runs AdamW with eps = 1e-3 on both sides: at the default 1e-8, Adam's
m / (sqrt(v) + eps) maps an entry whose gradient is near zero to about
+-lr whatever its last bits, so f32 summation order alone would move it.
Crash/resume, restores and bf16 leaves hold bit for bit (CPU)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import io as rio  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.optim import warmup_cosine as r_warmup_cosine  # noqa: E402
from repro.sharding import api as shapi  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train import LoopConfig, make_monitor, train  # noqa: E402

NAME = "olmo-1b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU
    (about 10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


@pytest.fixture(scope="module")
def ref():
    rc = ref_arch(NAME).reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    return rc, rp


def _port(rp, cfg=None):
    cfg = cfg or get_arch(NAME).reduced()
    return convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")


def _batch(vocab, b=4, t=16, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, t + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


# -- optimizer ----------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_updates_match_reference(ref, clip):
    """Two updates from the same parameters, gradients and state."""
    rc, rp = ref
    cfg = get_arch(NAME).reduced()
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(x.shape).astype(np.float32) * 0.3
             for x in jax.tree.leaves(rp)]
    ropt = RAdamW(lr=r_warmup_cosine(1e-2, 1, 10), clip_norm=clip)
    topt = AdamW(lr=warmup_cosine(1e-2, 1, 10), clip_norm=clip)
    rg = jax.tree.unflatten(jax.tree.structure(rp),
                            [jnp.asarray(g) for g in grads])
    tp = _port(rp, cfg)
    tg = convert.params_from_numpy(cfg, grads, device="cpu")
    rs, ts = ropt.init(rp), topt.init(tp)
    for _ in range(2):
        rp, rs, rm = ropt.update(rg, rs, rp)
        tp, ts, tm = topt.update(tg, ts, tp)
        assert abs(float(tm["lr"]) - float(rm["lr"])) <= 1e-6 * float(rm["lr"])
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-6 * max(float(rm["grad_norm"]), 1.0)
    _close(convert.params_to_numpy(tp), jax.tree.leaves(rp), 1e-6)
    _close(convert.params_to_numpy(ts.m), jax.tree.leaves(rs.m), 1e-6)
    _close(convert.params_to_numpy(ts.v), jax.tree.leaves(rs.v), 1e-6)
    assert int(ts.count) == int(rs.count) == 2
    state = convert.adamw_state_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rs)], device="cpu")
    assert int(state.count) == 2
    _close(convert.params_to_numpy(state.v), jax.tree.leaves(rs.v), 0.0)


def test_adamw_keeps_bf16_params_and_f32_moments():
    opt = AdamW(lr=1e-2)
    p = {"w": torch.ones(3, 4, dtype=torch.bfloat16)}
    g = {"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16)}
    st = opt.init(p)
    w = p["w"]
    p2, st2, _ = opt.update(g, st, p)
    assert p2["w"] is w and w.dtype == torch.bfloat16
    assert st2.m["w"].dtype == torch.float32 and st2.m["w"] is st.m["w"]
    assert float(w[0, 0]) < 1.0


def test_warmup_cosine_matches_reference():
    for peak, warm, total in ((3e-4, 1, 8), (1e-2, 5, 100), (1.0, 0, 3)):
        r, t = r_warmup_cosine(peak, warm, total), warmup_cosine(peak, warm,
                                                                 total)
        for step in range(0, total + 3):
            want = float(r(jnp.asarray(step, jnp.int32)))
            got = float(t(torch.tensor(step, dtype=torch.int32)))
            assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), \
                (peak, warm, total, step)


# -- train step ----------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(ref, microbatches):
    rc, rp = ref
    cfg = get_arch(NAME).reduced()
    # Auto axes: with jax's default Explicit axes the reference's
    # activation constraints raise (ROADMAP Queue 3)
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    plan = shapi.tp_plan(data_axes=("data",), model_axis="model", fsdp=False)
    ropt = RAdamW(lr=r_warmup_cosine(1e-2, 1, 10), eps=1e-3)
    rstep = rsteps.build_train_step(rc, mesh, plan, ropt,
                                    microbatches=microbatches)
    tstep = tsteps.build_train_step(cfg, optimizer=AdamW(
        lr=warmup_cosine(1e-2, 1, 10), eps=1e-3), microbatches=microbatches)
    rb, tb = _batch(cfg.vocab, seed=microbatches)
    tp = _port(rp, cfg)
    ts = AdamW(lr=1.0).init(tp)
    with mesh:
        rp2, rs2, rm = rstep(rp, ropt.init(rp), rb)
    tp2, ts2, tm = tstep(tp, ts, tb)
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= \
        2e-5 * float(rm["loss"])
    _close(convert.params_to_numpy(tp2), jax.tree.leaves(rp2), 1e-5)
    _close(convert.params_to_numpy(ts2.m), jax.tree.leaves(rs2.m), 1e-4)


# -- loop ------------------------------------------------------------------


@pytest.fixture(scope="module")
def pieces():
    cfg = get_arch(NAME).reduced()
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4), device="cpu")
    opt = AdamW(lr=warmup_cosine(1e-2, 5, 100))

    def init_state():
        params, _ = M.init_model(0, cfg, device="cpu")
        return params, opt.init(params)

    return cfg, stream, init_state, tsteps.build_train_step(cfg,
                                                            optimizer=opt)


def test_loss_decreases(pieces, tmp_path):
    _, stream, init_state, step_fn = pieces
    res = train(loop_cfg=LoopConfig(total_steps=30, save_every=15),
                ckpt_dir=tmp_path, init_state=init_state, step_fn=step_fn,
                batch_fn=stream.batch_at)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


def test_crash_resume_is_bit_exact(pieces, tmp_path):
    _, stream, init_state, step_fn = pieces
    lc = LoopConfig(total_steps=12, save_every=4)
    full = train(loop_cfg=lc, ckpt_dir=tmp_path / "ref",
                 init_state=init_state, step_fn=step_fn,
                 batch_fn=stream.batch_at)
    with pytest.raises(RuntimeError, match="preemption at step 6"):
        train(loop_cfg=lc, ckpt_dir=tmp_path / "cr", init_state=init_state,
              step_fn=step_fn, batch_fn=stream.batch_at, fail_at_step=6)
    res = train(loop_cfg=lc, ckpt_dir=tmp_path / "cr", init_state=init_state,
                step_fn=step_fn, batch_fn=stream.batch_at)
    assert res.resumed_from == 4
    assert res.losses == full.losses[4:]


def test_straggler_watchdog(pieces, tmp_path):
    _, stream, init_state, step_fn = pieces
    lc = LoopConfig(total_steps=4, save_every=100, step_time_budget_s=1e-9)
    res = train(loop_cfg=lc, ckpt_dir=tmp_path, init_state=init_state,
                step_fn=step_fn, batch_fn=stream.batch_at)
    assert res.straggler_events == 4
    assert tio.latest_step(tmp_path) == 4
    # step 4's straggler save was overwritten by the final save
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["extra"]["straggler"] is True


def test_monitor_hook(pieces, tmp_path):
    cfg, stream, init_state, step_fn = pieces
    mon = make_monitor(M.loss_fn, cfg, per_example=2, sketch_dim=16,
                       device="cpu")
    res = train(loop_cfg=LoopConfig(total_steps=6, save_every=6,
                                    monitor_every=3),
                ckpt_dir=tmp_path, init_state=init_state, step_fn=step_fn,
                batch_fn=stream.batch_at, monitor_fn=mon)
    assert [s for s, _ in res.monitor_log] == [3, 6]
    for _, m in res.monitor_log:
        assert 0 < m["nat_norm_lower"] <= m["nat_norm_upper"]
        assert m["logdet_lower"] <= m["logdet_upper"]
        assert m["kappa_lower"] <= m["kappa_upper"]


def test_launcher_runs_on_the_cpu(tmp_path, capsys):
    res = tlaunch.main(["--arch", NAME, "--smoke", "--steps", "4",
                        "--save-every", "2", "--selector", "dpp",
                        "--monitor", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)])
    assert len(res.losses) == 4 and len(res.monitor_log) == 2
    assert tio.latest_step(tmp_path / f"{NAME}-smoke") == 4
    assert "params on cpu" in capsys.readouterr().out


# -- checkpoints -----------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.randn(2, generator=g).to(torch.bfloat16)},
            "e": (torch.zeros(()), None)}


def _equal(x, y):
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree.leaves(x), tree.leaves(y)))


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    tio.save(tmp_path, 7, t)
    assert tio.latest_step(tmp_path) == 7
    assert _equal(tio.restore(tmp_path, 7, _tree(1)), t)


def test_uncommitted_ignored(tmp_path):
    """Dirs without the marker, and a save in flight (its marker is
    written into ``step_<N>.tmp`` just before the rename), are not
    checkpoints. The reference's ``latest_step`` parses the in-flight
    name and raises (ROADMAP Queue 3); the port skips it."""
    tio.save(tmp_path, 1, _tree())
    (tmp_path / "step_00000005").mkdir()
    (tmp_path / "step_00000006.tmp").mkdir()
    (tmp_path / "step_00000006.tmp" / "_COMMITTED").write_text("0")
    assert tio.latest_step(tmp_path) == 1
    tio.retain(tmp_path, keep=1)
    assert tio.latest_step(tmp_path) == 1
    with pytest.raises(ValueError, match="invalid literal"):
        rio.latest_step(tmp_path)


def test_retention(tmp_path):
    for s in (1, 2, 3, 4):
        tio.save(tmp_path, s, _tree())
    tio.retain(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000004"]


def test_async_saver_snapshots_before_returning(tmp_path):
    """The saver copies the leaves before ``save`` returns: an in-place
    update right after (the next optimizer step) is not written."""
    t = _tree()
    want = tree.map(lambda x: x.clone(), t)
    saver = tio.AsyncSaver()
    saver.save(tmp_path, 3, t)
    for x in tree.leaves(t):
        x.add_(1)
    saver.wait()
    assert saver.last_path == tmp_path / "step_00000003"
    assert _equal(tio.restore(tmp_path, 3, t), want)


def test_leaf_count_mismatch_raises(tmp_path):
    tio.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaf count mismatch"):
        tio.restore(tmp_path, 1, {"a": torch.zeros(4, 3)})


def test_bf16_leaves_restore_bit_exactly(tmp_path):
    """Every bf16 bit pattern (NaNs, infinities, subnormals, -0) is written
    as its 16-bit word and restored unchanged."""
    words = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16)
    t = {"w": words.view(torch.bfloat16).reshape(256, 256)}
    tio.save(tmp_path, 2, t)
    meta = json.loads((tmp_path / "step_00000002" / "manifest.json"
                       ).read_text())["leaves"][0]
    assert meta["dtype"] == "bfloat16"
    got = tio.restore(tmp_path, 2, {"w": torch.zeros(256, 256,
                                                     dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))


def _next_loss_ref(rc, params, batch):
    return float(RM.loss_fn(rc, params, batch)[0])


def test_checkpoints_cross_packages(ref, tmp_path):
    """A (params, AdamW state) checkpoint written by the reference restores
    in the port, and the port's in the reference, bit for bit; after one
    more train step each side gives the same next-step loss."""
    rc, rp = ref
    cfg = get_arch(NAME).reduced()
    ropt, topt = RAdamW(lr=1e-2), AdamW(lr=1e-2)
    rb, tb = _batch(cfg.vocab, seed=5)
    (_, _), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                    has_aux=True)(rp)
    rp1, rs1, _ = ropt.update(rg, ropt.init(rp), rp)
    rio.save(tmp_path / "ref", 1, (rp1, rs1))
    tp0 = _port(rp, cfg)
    tp1, ts1 = tio.restore(tmp_path / "ref", 1, (tp0, topt.init(tp0)))
    _close(convert.params_to_numpy(tp1), jax.tree.leaves(rp1), 0.0)
    _close(convert.params_to_numpy(ts1.v), jax.tree.leaves(rs1.v), 0.0)
    assert int(ts1.count) == 1

    tio.save(tmp_path / "port", 1, (tp1, ts1))
    back = rio.restore(tmp_path / "port", 1, (rp, ropt.init(rp)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((rp1, rs1))):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    rb2, tb2 = _batch(cfg.vocab, seed=6)
    step = tsteps.build_train_step(cfg, optimizer=topt)
    tp2, _, _ = step(tp1, ts1, tb)
    (_, _), rg1 = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                     has_aux=True)(back[0])
    rp2, _, _ = ropt.update(rg1, back[1], back[0])
    want = _next_loss_ref(rc, rp2, rb2)
    got = float(M.loss_fn(cfg, tp2, tb2)[0])
    assert abs(got - want) <= 2e-5 * want
