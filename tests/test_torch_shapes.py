"""The port's input-shape table (launch/shapes.py) against the JAX
package's: the same cells, the same applicability, meta tensors with the
shapes and dtypes of the reference's ``jax.ShapeDtypeStruct``s for every
batch and cache, and ``make_inputs`` arrays equal to the reference's from
the same seed (bit for bit, bf16 included)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs import list_archs as ref_archs  # noqa: E402
from repro.launch import shapes as RS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.launch import shapes as TS  # noqa: E402

# one architecture per family
BY_FAMILY = ("olmo-1b", "arctic-480b", "falcon-mamba-7b", "zamba2-1.2b",
             "whisper-medium", "qwen2-vl-2b")
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype_name(x) -> str:
    return str(x.dtype).split(".")[-1]


def test_cells_match_reference():
    assert TS.SHAPES.keys() == RS.SHAPES.keys()
    for name, cell in TS.SHAPES.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(
            RS.SHAPES[name])


@pytest.mark.parametrize("name", sorted(ref_archs()))
def test_cell_applicable_matches_reference(name):
    assert sorted(list_archs()) == sorted(ref_archs())
    for shape in RS.SHAPES:
        assert TS.cell_applicable(get_arch(name), shape) == \
            RS.cell_applicable(ref_arch(name), shape)


@pytest.mark.parametrize("name", BY_FAMILY)
@pytest.mark.parametrize("quantized", [False, True])
def test_input_specs_match_reference(name, quantized):
    """Every cell of every family at the published config: the step kind,
    and each batch and cache leaf's shape and dtype (meta tensors against
    ``ShapeDtypeStruct``s; int8 caches with their scales too)."""
    rc, cfg = ref_arch(name), get_arch(name)
    for shape in RS.SHAPES:
        rk, rs = RS.input_specs(rc, shape, quantized_kv=quantized)
        tk, ts = TS.input_specs(cfg, shape, quantized_kv=quantized)
        assert tk == rk
        assert list(ts["batch"]) == list(rs["batch"])
        for key in rs["batch"]:
            r, t = rs["batch"][key], ts["batch"][key]
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype_name(t)) == \
                (tuple(r.shape), str(r.dtype)), (shape, key)
        if "caches" in rs:
            rl = jax.tree.leaves(rs["caches"])
            tl = tree.leaves(ts["caches"])
            assert [(tuple(t.shape), _dtype_name(t)) for t in tl] == \
                [(tuple(r.shape), str(r.dtype)) for r in rl], shape
        else:
            assert "caches" not in ts


@pytest.mark.parametrize("name", BY_FAMILY)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reduced", [True, False])
def test_make_inputs_match_reference(name, kind, reduced):
    """The same seed gives the same arrays, keys and dtypes: the reduced
    configs (f32 inputs) and the published ones (bf16 frames and vision
    embeddings, rounded alike), at 16 tokens a row."""
    rc, cfg = ref_arch(name), get_arch(name)
    if reduced:
        rc, cfg = rc.reduced(), cfg.reduced()
    want = RS.make_inputs(rc, kind, 16, 2, seed=3)
    got = TS.make_inputs(cfg, kind, 16, 2, seed=3, device="cpu")
    assert list(got) == list(want)
    for key, r in want.items():
        t = got[key]
        assert (tuple(t.shape), _dtype_name(t)) == \
            (tuple(r.shape), str(r.dtype)), key
        np.testing.assert_array_equal(
            t.to(torch.float32).numpy() if t.is_floating_point()
            else t.numpy(),
            np.asarray(jnp.asarray(r, jnp.float32)) if
            jnp.issubdtype(r.dtype, jnp.floating) else np.asarray(r))


def test_make_inputs_feed_the_port():
    """A prefill and a decode step of each family on ``make_inputs``
    batches run at the reduced configs (the decode position at seq - 1)."""
    from repro_torch.models import model as M
    for name in BY_FAMILY:
        cfg = get_arch(name).reduced()
        params, _ = M.init_model(0, cfg, device="cpu")
        pre = TS.make_inputs(cfg, "prefill", 16, 2, seed=1, device="cpu")
        caches = M.make_caches(cfg, 2, 20, torch.float32, device="cpu")
        caches, lp = M.prefill(cfg, params, pre, caches)
        dec = TS.make_inputs(cfg, "decode", 16, 2, seed=2, device="cpu")
        _, ld = M.decode_step(cfg, params, caches, dec)
        assert lp.shape == ld.shape == (2, 1, cfg.vocab), name
        assert torch.isfinite(ld).all(), name
