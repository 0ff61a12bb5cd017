"""The port's synthetic token stream and DPP batch selector (data/) against
the JAX package.

Both packages draw the tokens, the embeddings, the Lanczos probe and the
chain's initial mask with numpy, so those agree bit for bit. The chain's
draws come from ``jax.random.key(step)`` in the reference; the tests
replay them from that key and feed them to the port (``draws=``), which
must then select the same indices with the same chain statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import DPPBatchStream as RStream  # noqa: E402
from repro.data import DPPSelector as RSelector  # noqa: E402
from repro.data import TokenStream as RTokens  # noqa: E402
from repro.data import sequence_embeddings as r_embed  # noqa: E402
from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.data import DataConfig, DPPBatchStream, DPPSelector, \
    TokenStream, sequence_embeddings  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU
    (about 10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kdpp_draws(key, n, steps):
    """The draws the reference's kdpp_step takes from its key, in order."""
    gv, gu, ps = [], [], []
    for _ in range(steps):
        key, k_v, k_u, k_p = jax.random.split(key, 4)
        gv.append(np.asarray(jax.random.gumbel(k_v, (n,), jnp.float32)))
        gu.append(np.asarray(jax.random.gumbel(k_u, (n,), jnp.float32)))
        ps.append(np.float32(jax.random.uniform(k_p, (), jnp.float32)))
    return tdpp.KdppDraws(g_v=torch.as_tensor(np.stack(gv)),
                          g_u=torch.as_tensor(np.stack(gu)),
                          p=torch.tensor(ps))


@pytest.mark.parametrize("hosts", [1, 2])
def test_token_stream_matches_reference(hosts):
    kw = dict(vocab=300, seq_len=48, global_batch=4, seed=3)
    for host in range(hosts):
        r = RTokens(RDataConfig(**kw), host_id=host, num_hosts=hosts)
        t = TokenStream(DataConfig(**kw), host_id=host, num_hosts=hosts,
                        device="cpu")
        for step in (0, 1, 7, 1000):
            want, got = r.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    a = TokenStream(DataConfig(**kw), 0, 2, device="cpu").batch_at(5)
    b = TokenStream(DataConfig(**kw), 1, 2, device="cpu").batch_at(5)
    assert not torch.equal(a["tokens"], b["tokens"])


def test_sequence_embeddings_match_reference():
    toks = np.random.default_rng(0).integers(0, 50304, (12, 64))
    for seed in (0, 4):
        assert np.array_equal(sequence_embeddings(toks, seed=seed),
                              r_embed(toks, seed=seed))
    e = sequence_embeddings(toks, dim=32)
    assert e.shape == (12, 32)
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(pool_factor=3, steps_per_item=2),
                                dict(pool_factor=4, steps_per_item=4)])
def test_selector_matches_reference(kw):
    toks = np.random.default_rng(1).integers(0, 1000, (4 * kw["pool_factor"],
                                                       32))
    k = 4
    ref = RSelector(**kw)
    port = DPPSelector(**kw, device="cpu")
    for step in (0, 3):
        want = ref.select(toks, k, step=step)
        draws = _kdpp_draws(jax.random.key(step), len(toks),
                            kw["steps_per_item"] * k)
        got = port.select(toks, k, step=step, draws=draws)
        assert np.array_equal(got, want)
        assert port.last_stats == ref.last_stats
        assert port.last_stats["uncertified"] == 0
        exact = DPPSelector(**kw, exact=True, device="cpu")
        assert np.array_equal(exact.select(toks, k, step=step, draws=draws),
                              got)


def test_dpp_batch_stream_matches_reference():
    kw = dict(vocab=500, seq_len=32, global_batch=4)
    ref = RStream(RTokens(RDataConfig(**kw)),
                  RSelector(pool_factor=3, steps_per_item=2))
    port = DPPBatchStream(TokenStream(DataConfig(**kw), device="cpu"),
                          DPPSelector(pool_factor=3, steps_per_item=2,
                                      device="cpu"))
    for step in (0, 2):
        want = ref.batch_at(step)
        got = port.batch_at(step, draws=_kdpp_draws(jax.random.key(step),
                                                    12, 8))
        for key in ("tokens", "labels"):
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
        assert port.selector.last_stats == ref.selector.last_stats
    # its own draws: a generator seeded with the step, every move certified
    a, b = port.batch_at(1), port.batch_at(1)
    assert torch.equal(a["tokens"], b["tokens"])
    assert port.selector.last_stats["uncertified"] == 0
    assert a["tokens"].shape == (4, 32)


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the raise on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenStream(DataConfig(vocab=10, seq_len=4, global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DPPSelector()
