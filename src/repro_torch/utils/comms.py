"""What a step runs: its collectives, operations, bytes and memory
(counterpart of ``repro.utils.hlo``).

The reference parses compiled HLO text. Here ``StepCensus``, a
``TorchDispatchMode``, records what a step actually dispatches, on real
tensors or on fake ones (``launch.dryrun``). It sits below DTensor: an op
on DTensors is handed back to DTensor (``NotImplemented``), so the census
sees each rank's local shards, the collectives that DTensor's
redistributions issue (``_c10d_functional``, ``_dtensor``) and the plain
``torch.distributed`` calls of ``sharding/api.py`` and ``optim/adamw.py``
(``c10d``). ``collective_bytes`` sums the wire bytes of the recorded
collectives with the reference's ring multipliers:

    all-reduce          2x buffer   (reduce-scatter + all-gather phases)
    all-gather          1x larger buffer
    reduce-scatter      1x larger buffer
    all-to-all          1x buffer
    collective-permute  1x buffer   (here also broadcast, send, recv)

Buffers are a rank's local tensors, so the numbers are bytes per rank on
the wire: the collective roofline numerator. The census also counts

  * flops, with the formulas of ``torch.utils.flop_counter`` (those of
    ``FlopCounterMode``), op by op (``op_flops_table``);
  * op bytes: every ``aten`` op's input and output bytes, views and
    ``empty`` factories left out. Nothing is fused, so this is an upper
    bound, as XLA's CPU-lowered "bytes accessed" is;
  * memory: the bytes of live storages that the step made, and their
    peak (storages given to ``exclude`` -- the arguments -- not counted).
    A storage leaves the count when its last reference goes
    (``weakref.finalize`` on the storage object, which torch keeps alive
    as long as the storage lives).
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter, defaultdict
from typing import Any, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}

# dispatcher op (namespace.name) -> collective kind
_KINDS = {}
for _ns in ("_c10d_functional", "c10d_functional"):
    _KINDS.update({
        f"{_ns}.all_reduce": "all-reduce",
        f"{_ns}.all_reduce_": "all-reduce",
        f"{_ns}.all_reduce_coalesced": "all-reduce",
        f"{_ns}.all_reduce_coalesced_": "all-reduce",
        f"{_ns}.all_gather_into_tensor": "all-gather",
        f"{_ns}.all_gather_into_tensor_out": "all-gather",
        f"{_ns}.all_gather_into_tensor_coalesced": "all-gather",
        f"{_ns}.reduce_scatter_tensor": "reduce-scatter",
        f"{_ns}.reduce_scatter_tensor_coalesced": "reduce-scatter",
        f"{_ns}.all_to_all_single": "all-to-all",
        f"{_ns}.broadcast": "collective-permute",
        f"{_ns}.broadcast_": "collective-permute",
    })
_KINDS.update({
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.broadcast_": "collective-permute",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
})
_NO_TRAFFIC = {"aten.empty", "aten.empty_like", "aten.empty_strided",
               "aten.new_empty", "aten.new_empty_strided"}


def op_name(func) -> str:
    """``namespace.name`` of a dispatcher op (its overload left out)."""
    return str(func._overloadpacket)


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(e) for e in x)
    return 0


def _plain(t) -> bool:
    """A tensor type the census counts at: plain, fake or a parameter
    (DTensor and other wrappers unwrap themselves first)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return t is torch.Tensor or t is torch.nn.Parameter \
        or issubclass(t, FakeTensor)


class StepCensus(TorchDispatchMode):
    """Count what runs under it: ``records`` (one dict a collective:
    ``kind``, ``op``, ``bytes`` of its larger buffer), ``flops``,
    ``op_bytes``, ``ops`` and ``op_flops`` (by op name), and
    ``live_bytes`` / ``peak_bytes`` of the storages the step made. Storages that exist before (``exclude``) are not counted.
    Ops that DTensor's sharding propagation runs to learn an output's
    global shape (once per new op signature, on fake tensors of the
    global shapes) run nowhere and are not counted.

        census = StepCensus()
        census.exclude((params, opt_state, batch))
        with census:
            step(params, opt_state, batch)
        collective_bytes(census.records)
    """

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.flops = 0
        self.op_bytes = 0
        self.ops: Counter = Counter()
        self.op_flops: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._known: set = set()

    def exclude(self, tree: Any) -> int:
        """Mark the storages of every tensor in ``tree`` (DTensors by
        their local shards) as existing before the step; returns their
        bytes, each storage counted once."""
        total = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._known:
                self._known.add(st._cdata)
                total += st.nbytes()
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not all(_plain(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _shape_inference():
            return out
        name = op_name(func)
        kind = _KINDS.get(name)
        if kind is not None:
            big = max([_nbytes(a) for a in args] + [_nbytes(out)])
            self.records.append({"kind": kind, "op": name, "bytes": big})
        elif func.namespace == "aten":
            self.ops[name] += 1
            fn = _flop_registry().get(func._overloadpacket)
            if fn is not None:
                f = fn(*args, **kwargs, out_val=out)
                self.flops += f
                self.op_flops[name] += f
            if not func.is_view and name not in _NO_TRAFFIC:
                self.op_bytes += sum(_nbytes(a) for a in tree_leaves(
                    (args, kwargs))) + sum(_nbytes(o)
                                           for o in tree_leaves(out))
        self._track(out)
        return out

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def summary(self) -> dict:
        """``flops``, op ``bytes``, collective bytes (``coll``) and their
        detail, the reference's ``_measure`` keys."""
        coll = collective_bytes(self.records)
        return {"flops": float(self.flops), "bytes": float(self.op_bytes),
                "coll": float(coll["total"]),
                "coll_detail": {k: v for k, v in coll.items()
                                if k != "total"}}


_SHAPE_INFERENCE = ("distributed/tensor/_sharding_prop.py",
                    "distributed\\tensor\\_sharding_prop.py")
# DTensor's host-side index arithmetic (a strided shard's local size)
_SHAPE_FUNCS = {"local_shard_size_and_offset"}


def _shape_inference() -> bool:
    """Whether the op being dispatched was called from DTensor's sharding
    propagator (``torch.distributed.tensor._sharding_prop``), which runs
    an op on fake tensors of the global shapes to learn its output's, or
    from its index arithmetic on the host (``_SHAPE_FUNCS``)."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_filename.endswith(_SHAPE_INFERENCE) \
                or code.co_name in _SHAPE_FUNCS:
            return True
        f = f.f_back
    return False


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    """The plain tensors of a tree: a DTensor's local shard, the rest as
    they are (dicts, lists, tuples and named tuples walked)."""
    if isinstance(tree, torch.Tensor):
        loc = getattr(tree, "_local_tensor", None)
        yield tree if loc is None else loc
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def collective_bytes(records: Iterable[dict]) -> dict:
    """Returns {op_kind: wire_bytes} plus 'total' and 'count'."""
    out: dict = defaultdict(float)
    count = 0
    for r in records:
        out[r["kind"]] += _MULT[r["kind"]] * r["bytes"]
        count += 1
    out["total"] = sum(v for k, v in out.items() if k in _COLLECTIVES)
    out["count"] = count
    return dict(out)


def collective_counts(records: Iterable[dict]) -> dict:
    """{op_kind: number of collectives} plus 'count'. A step runs every
    collective it issues (torch has no loop body compiled once), so this
    is the whole step's census, not one trip's."""
    out: dict = defaultdict(int)
    for r in records:
        out[r["kind"]] += 1
    out["count"] = sum(v for k, v in out.items() if k in _COLLECTIVES)
    return dict(out)


def op_flops_table(census: StepCensus) -> dict:
    """The census's flops, ``FlopCounterMode``'s formulas op by op:
    ``dot_flops_estimate`` (the reference's key: every counted op) and
    ``by_op``."""
    return {"dot_flops_estimate": float(census.flops),
            "by_op": {k: float(v) for k, v in census.op_flops.items()}}


def pins() -> dict:
    """Check the private torch APIs that the census and the dry-run lean
    on, loudly: the sharding propagator's module path (the shape-inference
    filter), ``FakeStore`` (the dry-run's fake group), storage objects
    that live as long as their storage (the memory count), and
    ``flop_registry``'s formulas. Returns torch's version."""
    import torch.distributed.tensor._sharding_prop as sp
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa
    from torch.utils.flop_counter import flop_registry

    path = sp.__file__.replace("\\", "/")
    assert path.endswith(_SHAPE_INFERENCE[0]), \
        f"DTensor's sharding propagator moved: {path}"
    t = torch.empty(4)
    st = t.untyped_storage()
    assert st is t.untyped_storage(), "storage objects are not kept"
    freed: list = []
    weakref.finalize(st, freed.append, 1)
    del st, t
    assert freed == [1], "a storage's finalizer did not run at its free"
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    got = flop_registry[torch.ops.aten.mm](a, b, out_val=a @ b)
    assert got == 48, f"flop_registry's mm formula gave {got}, not 48"
    return {"torch": torch.__version__}
