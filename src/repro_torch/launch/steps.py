"""The train and serve steps on one device (counterpart of
``repro.launch.steps``).

``build_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``, which updates the parameters and the optimizer
state in place. With ``microbatches > 1`` the batch is split along its
first axis and the f32 gradients are averaged over the pieces.
``build_prefill_step`` / ``build_decode_step`` return ``model.prefill`` /
``model.decode_step`` bound to a config; both write the caches in place
and pass the batch through as it is: a VLM's ``vision_embeds`` and
``positions``, an enc-dec model's ``frames`` (prefill) or ``enc_memory``
(decode).
The shardings (``mesh=``, ``plan=``) wait for data- and model-parallel
training (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import tree
from ..models import model as M
from ..optim.adamw import AdamW, warmup_cosine


def default_optimizer(total_steps: int = 10000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 200, total_steps))


def _one_device(mesh, plan) -> None:
    if mesh is not None or plan is not None:
        raise NotImplementedError(
            "sharded steps (mesh=, plan=) wait for data-parallel and "
            "model-parallel training (ROADMAP Queue 1 item 6)")


def build_train_step(cfg, mesh=None, plan=None,
                     optimizer: Optional[AdamW] = None,
                     microbatches: int = 1):
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)`` on
    one device. ``mesh`` / ``plan`` (model-parallel or FSDP shardings)
    wait for data- and model-parallel training (ROADMAP Queue 1)."""
    _one_device(mesh, plan)
    optimizer = optimizer or default_optimizer()

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            mbs = tree.map(lambda x: x.reshape(
                (microbatches, x.shape[0] // microbatches) + x.shape[1:]),
                batch)
            gacc = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lacc = 0.0
            for k in range(microbatches):
                mb = tree.map(lambda x: x[k], mbs)
                (loss, _), grads = M.value_and_grad(cfg, params, mb)
                gacc = tree.map(
                    lambda a, g: a + g.to(torch.float32) / microbatches,
                    gacc, grads)
                lacc = lacc + loss / microbatches
            grads, metrics = gacc, {"loss": lacc}
        else:
            (loss, metrics), grads = M.value_and_grad(cfg, params, batch)
            metrics = dict(metrics, loss=loss)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                          params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve steps


def build_prefill_step(cfg, mesh=None, plan=None):
    """``fn(params, batch, caches) -> (caches, logits)`` on one device;
    ``batch`` holds the family's prefill inputs (``model.prefill``)."""
    _one_device(mesh, plan)

    def prefill_step(params, batch, caches):
        return M.prefill(cfg, params, batch, caches)

    return prefill_step


def build_decode_step(cfg, mesh=None, plan=None):
    """``fn(params, caches, batch) -> (caches, logits)`` on one device;
    ``batch`` holds the family's decode inputs (``model.decode_step``)."""
    _one_device(mesh, plan)

    def decode_step(params, caches, batch):
        return M.decode_step(cfg, params, caches, batch)

    return decode_step
