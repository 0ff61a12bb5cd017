"""Checkpointing with async save and retention (counterpart of
``repro.checkpoint.io``), on the reference's on-disk layout:

    <dir>/step_<N>/
        manifest.json          -- structure, shapes, dtypes, step
        shard_<i>.npz          -- leaf_<i> arrays (chunked by size)
        _COMMITTED             -- written last; restore ignores dirs
                                  without it

Leaves are written in the reference's order (``repro_torch.tree``), so a
checkpoint written by either package restores in the other. numpy has no
bfloat16: a bf16 leaf is stored as its 16-bit words (uint16) with
``"dtype": "bfloat16"`` in the manifest, and restored bit for bit.
Restoring onto another mesh (elastic restore) waits for the sharded
training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import json
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .. import tree

_SHARD_BYTES = 512 * 1024 * 1024
BF16 = "bfloat16"
_STEP = re.compile(r"step_\d+")


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and the dtype name the manifest
    records."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    return t.numpy(), str(t.numpy().dtype)


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of a leaf that later in-place writes cannot reach."""
    return leaf.detach().to("cpu", copy=True)


def save(ckpt_dir: str | Path, step: int, tree_: Any, *,
         extra: Optional[dict] = None) -> Path:
    """Synchronous commit-marked save."""
    out = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = out.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, spec = tree.flatten(tree_)
    manifest = {"step": step, "treedef": repr(spec),
                "n_leaves": len(leaves), "extra": extra or {},
                "leaves": [], "shards": []}
    shard, shard_bytes, shard_idx = {}, 0, 0
    for i, leaf in enumerate(leaves):
        arr, dtype = _host(leaf)
        manifest["leaves"].append({"index": i, "shape": list(arr.shape),
                                   "dtype": dtype, "shard": shard_idx})
        shard[f"leaf_{i}"] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _SHARD_BYTES:
            np.savez(tmp / f"shard_{shard_idx}.npz", **shard)
            manifest["shards"].append(shard_idx)
            shard, shard_bytes, shard_idx = {}, 0, shard_idx + 1
    if shard:
        np.savez(tmp / f"shard_{shard_idx}.npz", **shard)
        manifest["shards"].append(shard_idx)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "_COMMITTED").write_text(str(time.time()))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


class AsyncSaver:
    """Overlap checkpoint I/O with training (one save in flight). ``save``
    copies every leaf to the host before its thread starts and before it
    returns: the next optimizer step writes the parameters in place."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[Path] = None

    def save(self, ckpt_dir, step, tree_, extra=None):
        self.wait()
        host_tree = tree.map(_snapshot, tree_)

        def run():
            try:
                self.last_path = save(ckpt_dir, step, host_tree, extra=extra)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _committed(d: Path) -> list:
    """The steps of ``d``'s committed checkpoints. A save in flight holds
    its ``_COMMITTED`` in ``step_<N>.tmp`` just before the rename; only
    ``step_<N>`` names count."""
    if not d.exists():
        return []
    return sorted(int(p.name[5:]) for p in d.iterdir()
                  if _STEP.fullmatch(p.name) and (p / "_COMMITTED").exists())


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = _committed(Path(ckpt_dir))
    return steps[-1] if steps else None


def _leaf_from(arr: np.ndarray, dtype: str, proto: torch.Tensor
               ) -> torch.Tensor:
    if dtype == BF16:
        # the port writes uint16 words; the reference's ml_dtypes bf16
        # arrays load as 2-byte records: either views as the same words
        t = torch.from_numpy(np.array(arr, order="C").view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=proto.device, dtype=proto.dtype, copy=True)


def restore(ckpt_dir: str | Path, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf in the dtype and on the device of the matching leaf of
    ``like``."""
    src = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    shards = {i: np.load(src / f"shard_{i}.npz")
              for i in manifest["shards"]}
    leaves_like, spec = tree.flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch {len(leaves_like)} vs "
                         f"{manifest['n_leaves']}")
    out = []
    for meta, proto in zip(manifest["leaves"], leaves_like):
        arr = shards[meta["shard"]][f"leaf_{meta['index']}"]
        if list(arr.shape) != list(proto.shape):
            raise ValueError(f"leaf {meta['index']}: shape mismatch "
                             f"{arr.shape} vs {tuple(proto.shape)}")
        out.append(_leaf_from(arr, meta["dtype"], proto))
    return tree.unflatten(spec, out)


def retain(ckpt_dir: str | Path, keep: int = 3):
    """Delete all but the newest ``keep`` committed checkpoints."""
    d = Path(ckpt_dir)
    for s in _committed(d)[:-keep]:
        shutil.rmtree(d / f"step_{s:08d}", ignore_errors=True)
