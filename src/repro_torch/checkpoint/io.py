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

DTensor leaves (parameters and moments placed over a mesh) are written
as their logical arrays, gathered (``_gathered``: an integer all-reduce
of the shards' bits): the gather is a collective, so every rank of the
mesh calls ``save`` (or ``AsyncSaver.save``, which gathers
before its thread starts), the mesh's first rank alone writes, and the
ranks meet at a barrier before any of them reads ``_COMMITTED`` again
(``save`` returns after it; ``AsyncSaver.wait`` holds it). Elastic
restore: ``restore(..., shardings=)`` places each logical array on a mesh
with ``distribute_tensor``, whatever mesh saved it; a DTensor ``like``
leaf is placed as itself.
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
from ..sharding.api import _placement_leaves, is_dtensor

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


def _mesh_of(leaves: list):
    """The mesh of the first DTensor leaf, or None."""
    for x in leaves:
        if is_dtensor(x):
            return x.device_mesh
    return None


def _logical(leaf: torch.Tensor) -> torch.Tensor:
    """A DTensor's logical array on every rank (a collective,
    ``_gathered``), a plain leaf as it is."""
    return _gathered(leaf) if is_dtensor(leaf) else leaf


def _gathered(x) -> torch.Tensor:
    """The logical array of a DTensor of shards and replicas, bit for bit:
    each shard's bits, as integers, written once (by the replica at
    coordinate 0 of every mesh dim that replicates it) into a zero-filled
    array, then summed over each mesh dimension in turn. An all-reduce
    of integers, which every backend takes: gloo's all-gather of CUDA
    tensors crashes (torch 2.11), and an integer sum keeps -0.0 and NaN
    payloads that a float sum of zeros would not."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, loc = x.device_mesh, x.to_local()
    word = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        loc.element_size()]
    full = torch.zeros(x.shape, dtype=torch.int64 if word == torch.int64
                       else torch.int32, device=loc.device)
    coord = mesh.get_coordinate()
    if all(c == 0 for c, p in zip(coord, x.placements) if not p.is_shard()):
        shape, offset = compute_local_shape_and_global_offset(
            x.shape, mesh, x.placements)
        region = tuple(slice(o, o + n) for o, n in zip(offset, shape))
        full[region] = loc.contiguous().view(word).to(full.dtype)
    for d in range(mesh.ndim):
        if mesh.shape[d] > 1:
            dist.all_reduce(full, group=mesh.get_group(d))
    return full.to(word).view(x.dtype)


def _writes(mesh) -> bool:
    """Whether this rank writes: always without a mesh, else the mesh's
    first rank."""
    return mesh is None or not any(mesh.get_coordinate())


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived (a barrier a mesh dimension in
    turn reaches them all)."""
    import torch.distributed as dist

    for d in range(mesh.ndim):
        if mesh.shape[d] > 1:
            dist.barrier(group=mesh.get_group(d))


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of a leaf (a DTensor's logical array) that later
    in-place writes cannot reach."""
    return _logical(leaf).detach().to("cpu", copy=True)


def save(ckpt_dir: str | Path, step: int, tree_: Any, *,
         extra: Optional[dict] = None) -> Path:
    """Synchronous commit-marked save. With DTensor leaves every rank of
    their mesh calls it; it gathers them, the first rank writes, and all
    return after a barrier."""
    leaves, spec = tree.flatten(tree_)
    mesh = _mesh_of(leaves)
    if mesh is None:
        return _write(ckpt_dir, step, leaves, spec, extra)
    leaves = [_logical(x) for x in leaves]
    out = _write(ckpt_dir, step, leaves, spec, extra) if _writes(mesh) \
        else Path(ckpt_dir) / f"step_{step:08d}"
    _barrier(mesh)
    return out


def _write(ckpt_dir, step: int, leaves: list, spec, extra) -> Path:
    out = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = out.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
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
    returns: the next optimizer step writes the parameters in place. With
    DTensor leaves every rank of their mesh calls ``save`` and ``wait``:
    each gathers, the mesh's first rank alone writes, and ``wait`` ends
    at a barrier of the mesh."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None
        self.last_path: Optional[Path] = None

    def save(self, ckpt_dir, step, tree_, extra=None):
        self.wait()
        mesh = _mesh_of(tree.leaves(tree_))
        host_tree = tree.map(_snapshot, tree_)
        self._mesh = mesh
        if not _writes(mesh):
            self.last_path = Path(ckpt_dir) / f"step_{step:08d}"
            return

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
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _barrier(mesh)
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


def restore(ckpt_dir: str | Path, step: int, like: Any,
            shardings: Any = None, *, mesh=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf in the dtype and on the device of the matching leaf of ``like``.

    Elastic restore: with ``shardings`` (a tree like ``like`` of
    placements tuples, ``sharding.param_shardings``' form) each logical
    array is placed on ``mesh`` (or on the mesh of its DTensor ``like``
    leaf) with ``distribute_tensor``, every rank keeping its own shard;
    without, a DTensor ``like`` leaf is placed as itself. A meta ``like``
    leaf takes the mesh's device."""
    src = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    shards = {i: np.load(src / f"shard_{i}.npz")
              for i in manifest["shards"]}
    leaves_like, spec = tree.flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch {len(leaves_like)} vs "
                         f"{manifest['n_leaves']}")
    pls = _placement_leaves(shardings) if shardings is not None else \
        [None] * len(leaves_like)
    if len(pls) != len(leaves_like):
        raise ValueError(f"{len(pls)} placements for {len(leaves_like)} "
                         f"leaves")
    out = []
    for meta, proto, pl in zip(manifest["leaves"], leaves_like, pls):
        arr = shards[meta["shard"]][f"leaf_{meta['index']}"]
        if list(arr.shape) != list(proto.shape):
            raise ValueError(f"leaf {meta['index']}: shape mismatch "
                             f"{arr.shape} vs {tuple(proto.shape)}")
        out.append(_placed(_leaf_from(arr, meta["dtype"],
                                      _device_proto(proto, mesh)),
                           proto, pl, mesh))
    return tree.unflatten(spec, out)


def _device_proto(proto, mesh):
    """``proto``, or an empty tensor of its dtype on ``mesh``'s device
    where ``proto`` lies on the meta device."""
    if proto.device.type != "meta" or mesh is None:
        return proto
    dev = torch.device(mesh.device_type)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return torch.empty((), dtype=proto.dtype, device=dev)


def _placed(t: torch.Tensor, proto, pl, mesh):
    from torch.distributed.tensor import distribute_tensor

    if pl is None:
        if not is_dtensor(proto):
            return t
        mesh_, pl = proto.device_mesh, proto.placements
    else:
        mesh_ = proto.device_mesh if is_dtensor(proto) and mesh is None \
            else mesh
        if mesh_ is None:
            raise ValueError("shardings= needs mesh= (or DTensor like "
                             "leaves)")
    return distribute_tensor(t, mesh_, list(pl), src_data_rank=None)


def retain(ckpt_dir: str | Path, keep: int = 3):
    """Delete all but the newest ``keep`` committed checkpoints."""
    d = Path(ckpt_dir)
    for s in _committed(d)[:-keep]:
        shutil.rmtree(d / f"step_{s:08d}", ignore_errors=True)
