"""DPP diverse-batch selection, the paper's sampler as a data-pipeline
feature (counterpart of ``repro.data.dpp_selection``).

Per step: draw a candidate pool of ``pool_factor * batch`` sequences,
embed them (a cheap random projection), build an RBF similarity kernel,
and run the retrospective k-DPP chain (Alg. 6/7, quadrature-judged) to
pick a diverse subset of size ``batch``. Every accept/reject decision is
certified by the brackets, so the selected set is the one the exact chain
selects under the same draws.

The kernel, the Lanczos probe and the initial mask are numpy draws, as in
the reference. The chain's draws are an input (``core.dpp.KdppDraws``):
by default a ``torch.Generator`` on the selector's device seeded with the
step, where the reference uses ``jax.random.key(step)``; ``select`` and
``DPPBatchStream.batch_at`` take ``draws=`` to replay another table.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dpp as dpp_mod
from ..core import operators as ops_mod
from ..core import spectrum
from .synthetic import TokenStream, sequence_embeddings, to_batch


class DPPSelector:
    def __init__(self, *, pool_factor: int = 4, bandwidth: float = 0.7,
                 ridge: float = 1e-3, steps_per_item: int = 4,
                 max_quad_iters: int = 48, seed: int = 0,
                 exact: bool = False, device="cuda"):
        self.pool_factor = pool_factor
        self.bandwidth = bandwidth
        self.ridge = ridge
        self.steps_per_item = steps_per_item
        self.max_quad_iters = max_quad_iters
        self.seed = seed
        self.exact = exact
        self.device = ops_mod.resolve_device(device)
        self.last_stats = None

    def kernel(self, emb: np.ndarray) -> np.ndarray:
        d2 = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
        k = np.exp(-d2 / (2 * self.bandwidth ** 2))
        return k + self.ridge * np.eye(len(emb))

    def select(self, pool_tokens: np.ndarray, k: int, step: int = 0, *,
               draws=None) -> np.ndarray:
        """Indices of a diverse size-k subset of the pool. ``draws``: a
        ``KdppDraws`` table of at least ``steps_per_item * k`` rows or a
        generator; default a generator seeded with ``step``."""
        n = len(pool_tokens)
        dev = self.device
        emb = sequence_embeddings(pool_tokens, seed=self.seed)
        op = ops_mod.Dense(torch.as_tensor(self.kernel(emb),
                                           dtype=torch.float32, device=dev))
        # the ridge is a certain lower spectral bound; Lanczos the top
        probe = torch.as_tensor(np.random.default_rng(step).standard_normal(n),
                                dtype=torch.float32, device=dev)
        est = spectrum.lanczos_extremal(op, probe, num_iters=12)
        lam_min = float(self.ridge) * 0.5
        lam_max = float(est.lam_max)

        init = np.zeros(n, np.float32)
        init[np.random.default_rng((self.seed, step)).choice(
            n, k, replace=False)] = 1.0
        if draws is None:
            draws = torch.Generator(device=dev).manual_seed(step)
        state = dpp_mod.sample_kdpp(
            op, draws, torch.as_tensor(init, device=dev),
            num_steps=self.steps_per_item * k, lam_min=lam_min,
            lam_max=lam_max, max_iters=self.max_quad_iters, exact=self.exact)
        self.last_stats = {f: int(x) for f, x in
                           zip(state.stats._fields, state.stats)}
        idx = np.where(state.mask.cpu().numpy() > 0.5)[0]
        return idx[:k]


class DPPBatchStream:
    """TokenStream wrapper: oversample a pool, keep the k-DPP subset."""

    def __init__(self, stream: TokenStream, selector: DPPSelector):
        self.stream = stream
        self.selector = selector

    def pool_at(self, step: int) -> np.ndarray:
        """The candidate pool of ``step``: (pool_factor * local_batch,
        seq_len + 1) token rows."""
        return np.concatenate([self.stream.tokens_at(step * 131 + i)
                               for i in range(self.selector.pool_factor)], 0)

    def batch_at(self, step: int, *, draws=None) -> dict:
        pool = self.pool_at(step)
        idx = self.selector.select(pool[:, :-1], self.stream.local_batch,
                                   step=step, draws=draws)
        return to_batch(pool[idx], self.stream.device)
