"""Logical-axis placement: rules, context and constraint helpers
(counterpart of ``repro.sharding.api``).

A ``Plan`` maps logical axis names (the ``axes`` tuples that
``models.model.init_model`` returns beside the parameters) to mesh axes of
the production mesh (pod, data, model). ``tp_plan`` is the model plan:
tensor-parallel over ``model``, data-parallel over (pod, data), optional
FSDP (zero-3) and sequence sharding. ``lane_plan`` maps the quadrature
``lanes`` axis onto the 1-D lane mesh.

A spec (``spec_for_param``, ``_fix_divisibility``) is a tuple with one
entry per tensor dimension, as the reference's ``PartitionSpec`` holds
them: ``None`` (whole), a mesh axis name, or a tuple of names. A mesh is
a ``torch.distributed`` ``DeviceMesh`` with named dimensions, or (for
placement arithmetic alone) a mapping ``{axis name: size}`` in mesh
order. ``placements(spec, mesh)`` turns a spec into the form
``distribute_tensor`` takes: mesh dimension j named in entry i gets
``Shard(i)``, every other one ``Replicate()``.

Model code calls ``constrain(x, ("batch", "seq", "embed"))``: a no-op
unless ``activation_context(mesh, plan)`` is active in this thread, so
the same model runs on one device in the tests and distributed under the
train step. Under a context it redistributes a DTensor to the placements
its spec gives; a plain tensor (every rank holds the same copy) passes as
it is. Three operations of the model run rank by rank on DTensors, where
DTensor's own rules would move whole tensors or refuse on some torch
versions: ``einsum`` (each rank contracts its shards; the output sharded
or partial), ``logsumexp`` over a split vocab (the maxima and the sums
reduced, the logits kept), and ``sharded_embedding`` (a vocab-split
table's rows). On plain tensors each is torch's own call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

from .. import tree

_ctx = threading.local()


@dataclasses.dataclass(frozen=True)
class Plan:
    """Logical axis -> mesh axis (or tuple of mesh axes, or None)."""
    rules: dict
    fsdp: bool = False            # additionally shard big dense dims on data
    fsdp_axis: str = "data"
    fsdp_min_size: int = 1024     # don't FSDP-shard tiny params

    def mesh_axes(self, logical: Optional[str]):
        return self.rules.get(logical) if logical else None


def tp_plan(*, data_axes=("pod", "data"), model_axis="model",
            fsdp: bool = False, seq_shard: bool = False,
            embed_shard: bool = False, tp_full: bool = False) -> Plan:
    """The production plan: TP over ``model_axis``, DP over ``data_axes``,
    optional FSDP (zero-3) and sequence sharding. ``embed_shard`` puts the
    activations' embed dim on the data axis; ``tp_full`` (serving) puts the
    weights on all mesh axes and turns FSDP off. The reference's rules,
    flag for flag."""
    data_axes = tuple(data_axes)
    wide = data_axes + (model_axis,)
    w_axis = wide if tp_full else model_axis
    rules = {
        "batch": None if (embed_shard or tp_full) else data_axes,
        "cache_batch": None if tp_full else data_axes,
        "seq": model_axis if seq_shard else None,
        "kv_seq": wide if tp_full else model_axis,   # KV cache seq dim
        "embed": "data" if embed_shard else None,
        "heads": w_axis,
        "kv_heads": w_axis,
        "mlp": w_axis,
        "vocab": w_axis,
        "expert": w_axis,
        "ssm_inner": w_axis,
        "layers": None,
        "lanes": None,   # quadrature lanes: replicated under the prod plan
    }
    return Plan(rules=rules, fsdp=fsdp and not tp_full)


def lane_plan(mesh_axis: str = "lanes") -> Plan:
    """The plan of the lane axis (DESIGN.md Sec. 7): ``lanes`` on the
    lane mesh's axis, everything else replicated."""
    return Plan(rules={"lanes": mesh_axis})


def lane_sharding(mesh, *, ndim: int = 2, plan: Optional[Plan] = None):
    """The placement of a lane-stacked (K, ...) array of rank ``ndim`` on
    ``mesh``: a tuple with one entry per mesh dimension, ``Shard(0)``
    (the leading lane dim split over the lane axis, trailing dims whole)
    where the plan maps ``lanes`` to that dimension, ``Replicate()``
    elsewhere. The form ``torch.distributed.tensor.distribute_tensor``
    takes."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError(f"a lane-stacked array has ndim >= 1, got {ndim}")
    plan = lane_plan() if plan is None else plan
    axis = plan.mesh_axes("lanes")
    names = mesh.mesh_dim_names or ()
    if axis is not None and axis not in names:
        raise ValueError(f"the plan puts lanes on {axis!r}, which is not "
                         f"an axis of the mesh {names}")
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in names)


# ---------------------------------------------------------------------------
# Parameter specs


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_for_param(plan: Plan, axes: tuple, shape: tuple) -> tuple:
    """The spec of one parameter from its logical axes tuple.

    A mesh axis appears at most once a spec: where two logical dims map
    to the same mesh axis (MoE 'expert' and 'mlp' both on model) the
    FIRST (leftmost) keeps it and later ones are replicated. FSDP shards
    the largest still-unsharded dim over the fsdp axis as well, when the
    parameter has at least ``fsdp_min_size`` elements (ZeRO-3 style)."""
    entries = [plan.mesh_axes(a) for a in axes]
    used: set = set()
    for i, e in enumerate(entries):
        names = _names(e)
        if any(n in used for n in names):
            entries[i] = None
        else:
            used.update(names)
    if plan.fsdp and plan.fsdp_axis not in used:
        size = 1
        for s in shape:
            size *= s
        if size >= plan.fsdp_min_size:
            cand = [i for i, e in enumerate(entries) if e is None]
            if cand:
                big = max(cand, key=lambda i: shape[i])
                entries[big] = plan.fsdp_axis
    return tuple(entries)


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of a
    mapping that already is one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the mesh's dimensions need names (mesh_dim_names)")
    return dict(zip(names, mesh.shape))


def _axis_size(mesh, entry) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for name in _names(entry):
        n *= sizes[name]
    return n


def _fix_divisibility(spec: tuple, shape: tuple, mesh) -> tuple:
    """``spec`` padded to ``len(shape)``, with every entry whose dim does
    not divide by its mesh axes' size replaced by None (replicated)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(None if e is not None and dim % _axis_size(mesh, e) else e
                 for dim, e in zip(shape, spec))


def placements(spec: tuple, mesh) -> tuple:
    """The ``distribute_tensor`` placements of ``spec`` on ``mesh``: one
    per mesh dimension, ``Shard(i)`` for the dimension named in entry i
    (a tuple entry shards dim i over each of its axes, which must come in
    mesh order), ``Replicate()`` for the rest and for a dimension of size
    1 (split one way, a shard is the whole tensor; DTensor's views refuse
    some reshapes of a dim sharded even one way)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    order = list(sizes)
    out = [Replicate()] * len(order)
    for i, entry in enumerate(spec):
        names = _names(entry)
        pos = [order.index(n) for n in names]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {tuple(order)}")
        for j in pos:
            if sizes[order[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def _axes_leaves(axes) -> list:
    """The axes tuples of an axes tree, in ``repro_torch.tree``'s order
    (dict keys sorted; a tuple of names is a leaf)."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    if not _is_axes(axes):
        raise TypeError(f"an axes leaf is a tuple of names, got {axes!r}")
    return [axes]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _per_param(fn, plan, mesh, params, axes):
    ps, spec = tree.flatten(params)
    ax = _axes_leaves(axes)
    if len(ax) != len(ps):
        raise ValueError(f"{len(ps)} parameters but {len(ax)} axes tuples")
    out = []
    for p, a in zip(ps, ax):
        shape = tuple(p.shape)
        out.append(fn(_fix_divisibility(spec_for_param(plan, a, shape),
                                        shape, mesh)))
    return tree.unflatten(spec, out)


def param_specs(plan: Plan, mesh, params: Any, axes: Any):
    """The spec of every leaf of a (params, axes) pair, as a tree like
    ``params``, with the divisibility fallback: a dim that does not divide
    by its mesh axes is replicated. ``params`` may hold meta tensors."""
    return _per_param(lambda s: s, plan, mesh, params, axes)


def param_shardings(plan: Plan, mesh, params: Any, axes: Any):
    """The placements of every leaf of a (params, axes) pair on ``mesh``
    (``placements`` of ``param_specs``), as a tree like ``params``."""
    return _per_param(lambda s: placements(s, mesh), plan, mesh, params,
                      axes)


def placed_map(fn, tree_: Any, shardings: Any):
    """``fn(leaf, placements)`` over the leaves of ``tree_`` and the
    matching placements tuples of ``shardings`` (a tree like ``tree_``
    with a placements tuple for each leaf)."""
    leaves, spec = tree.flatten(tree_)
    pls = _placement_leaves(shardings)
    if len(pls) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(pls)} placements")
    return tree.unflatten(spec, [fn(x, pl) for x, pl in zip(leaves, pls)])


def distribute(tree_: Any, mesh, shardings: Any):
    """Every leaf of ``tree_`` as a DTensor on ``mesh`` with the matching
    placements of ``shardings`` (``param_shardings``' form). Each rank
    holds the whole logical tensor, the same on every rank (drawn from
    one seed, or read from one checkpoint), and keeps its own shard:
    nothing moves between ranks."""
    from torch.distributed.tensor import distribute_tensor

    return placed_map(lambda x, pl: distribute_tensor(
        x, mesh, list(pl), src_data_rank=None), tree_, shardings)


def leaf_placer(plan: Plan, mesh):
    """``place(leaf, axes)`` for ``models.model.init_model``: the whole
    leaf (the same on every rank) as a DTensor on ``mesh`` placed as
    ``param_shardings`` places it, its local shard copied out so that the
    whole leaf is freed as soon as the caller drops it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(x, axes):
        shape = tuple(x.shape)
        pl = placements(_fix_divisibility(spec_for_param(plan, axes, shape),
                                          shape, mesh), mesh)
        d = distribute_tensor(x, mesh, list(pl), src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return place


def _placement_leaves(shardings) -> list:
    """The placements tuples of a tree of them, in ``repro_torch.tree``'s
    order."""
    from torch.distributed.tensor import Placement

    if shardings is None:
        return []
    if isinstance(shardings, dict):
        return [p for k in sorted(shardings)
                for p in _placement_leaves(shardings[k])]
    if isinstance(shardings, (tuple, list)) and all(
            isinstance(e, Placement) for e in shardings) and not hasattr(
            shardings, "_fields"):
        return [tuple(shardings)]
    return [p for x in shardings for p in _placement_leaves(x)]


# ---------------------------------------------------------------------------
# Activation constraints via context


@contextlib.contextmanager
def activation_context(mesh, plan: Plan):
    """Make ``constrain`` place activations on ``mesh`` under ``plan`` in
    this thread. Plain tensors that the forward makes (positions, masks,
    constants) meet the DTensor activations as replicated ones
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = getattr(_ctx, "val", None)
    _ctx.val = (mesh, plan)
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.val = prev


def active():
    """``(mesh, plan)`` of the active context, or None."""
    return getattr(_ctx, "val", None)


@contextlib.contextmanager
def reentered(ctx):
    """``ctx`` (what ``active()`` returned) active in this thread again
    for the block, without touching the implicit replication that the
    outer ``activation_context`` holds: for work that runs later on
    another thread, as a recomputed block does on autograd's device
    thread."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = ctx
    try:
        yield
    finally:
        _ctx.val = prev


def _for_compute(plan: Plan, x):
    """``x`` where the forward uses it: gathered over the FSDP axis (a
    differentiable redistribute: its gradient comes back
    reduce-scattered), or ``x`` itself."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names
    want = tuple(Replicate() if n == plan.fsdp_axis else p
                 for n, p in zip(names, x.placements))
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def fsdp_gather(params: Any):
    """``params`` (a tree, or one tensor) with every DTensor leaf gathered
    over the active plan's FSDP axis: the all-gather forward, whose
    gradient comes back reduce-scattered to the leaf's own placements.
    The model calls it where a parameter is used (a unit of the layer
    stack inside its recomputed block, a top-level leaf at its use), so
    one unit is gathered at a time, as the reference's compiled step
    gathers inside its scan. Without a context, or under a plan without
    FSDP, ``params`` itself."""
    ctx = active()
    if ctx is None or not ctx[1].fsdp:
        return params
    plan = ctx[1]
    return tree.map(lambda x: _for_compute(plan, x), params)


def fsdp_on_stack_axis(x) -> bool:
    """Whether the stacked leaf ``x`` has its FSDP shard on its leading
    (stack) dim under the active context. Its per-unit slices are then
    not rank-local, so the stack gathers such a leaf whole before it
    unbinds it (``models.model._scan_stack``), as XLA gathers a scan
    operand split on its scan axis before the loop. FSDP picks the
    stack dim where it is a leaf's largest free dim: the per-layer
    biases over a model-split width (whisper-medium, qwen2-vl-2b), the
    SSM's conv, skip and state leaves (falcon-mamba-7b, zamba2-1.2b), at
    their published widths. (The plans put no other mesh axis on a
    stack dim: ``layers`` maps to None.)"""
    ctx = active()
    if ctx is None or not ctx[1].fsdp or not is_dtensor(x):
        return False
    return any(n == ctx[1].fsdp_axis and p.is_shard() and p.dim == 0
               for n, p in zip(x.device_mesh.mesh_dim_names, x.placements))


def sharded_embedding(table, tokens):
    """Rows ``tokens`` of a DTensor ``table`` (V, d) whose vocab dim may be
    sharded: each rank looks up the ids that fall in its rows (the others
    read as zeros) and the output is partial over those mesh dims, to be
    summed by the next ``constrain``. DTensor's own lookup marks its
    output with a mask that a data-sharded batch's backward cannot carry.
    ``tokens`` is a DTensor on the same mesh (or a plain tensor, the same
    on every rank)."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, _rep(mesh),
                                    run_check=False)
    # a rank's gradient of the rows it holds covers its own tokens only:
    # partial over the mesh dims that split the batch
    loc = table.to_local(grad_placements=[
        Partial() if isinstance(tk, Shard) and tp == Replicate() else tp
        for tp, tk in zip(table.placements, tokens.placements)])
    rows, lo, split = table.shape[0], 0, 1
    for j, pl in enumerate(table.placements):
        if pl == Shard(0):
            split *= mesh.shape[j]
            lo += mesh.get_local_rank(j) * (rows // split)
    ids = tokens.to_local().long()
    out_pl = []
    for j, (tp, tk) in enumerate(zip(table.placements, tokens.placements)):
        if tp == Shard(0):
            out_pl.append(Partial())
        elif tp == Shard(1):
            out_pl.append(Shard(tokens.ndim))
        elif isinstance(tk, Shard):
            out_pl.append(tk)
        else:
            out_pl.append(Replicate())
    if split == 1:
        out = F.embedding(ids, loc)
    else:
        idx = ids - lo
        inside = (idx >= 0) & (idx < loc.shape[0])
        out = F.embedding(torch.where(inside, idx, 0), loc) \
            * inside[..., None].to(loc.dtype)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers without the
    isinstance check against the subclass)."""
    import torch

    return type(x) is not torch.Tensor and isinstance(x, _dtensor_type())


def einsum(eq: str, *ops):
    """``torch.einsum``, and over DTensors rank by rank
    (``_local_einsum``): the model's contractions call this one, so that
    plain tensors take torch's own path unchanged."""
    import torch

    if any(is_dtensor(o) for o in ops):
        return _local_einsum(eq, ops)
    return torch.einsum(eq, *ops)


def logsumexp(logits):
    """``torch.logsumexp`` over the last dim; for a DTensor whose last dim
    is split, rank by rank (``_split_logsumexp``)."""
    import torch

    if is_dtensor(logits):
        last = logits.ndim - 1
        if any(getattr(p, "dim", None) == last for p in logits.placements):
            return _split_logsumexp(logits)
    return torch.logsumexp(logits, dim=-1)


def gather_last(logits, idx):
    """``torch.gather(logits, -1, idx)``, ``idx`` (..., 1); for a DTensor
    whose last dim is split, rank by rank: each rank picks the ids that
    fall in its slice (the others read 0) and the output is partial over
    those mesh dims, to be summed by the next ``constrain``. DTensor's own
    backward of the gather builds a zero tensor of the global logits'
    shape on every rank (212 GB for llama4's (256, 1024, 202048) chunk);
    here each rank's gradient is its own slice."""
    import torch

    last = logits.ndim - 1 if is_dtensor(logits) else -1
    if last < 0 or not any(p.is_shard() and p.dim == last
                           for p in logits.placements):
        return torch.gather(logits, -1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    split = [p.is_shard() and p.dim == last for p in logits.placements]
    want = [Replicate() if s else p
            for s, p in zip(split, logits.placements)]
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, _rep(mesh), run_check=False)
    if list(idx.placements) != want:
        idx = idx.redistribute(mesh, want)
    loc = logits.to_local()
    off, _ = _local_window(logits)
    i = idx.to_local().long() - off[last]
    inside = (i >= 0) & (i < loc.shape[-1])
    got = torch.gather(loc, -1, torch.where(inside, i, 0)) \
        * inside.to(loc.dtype)
    return DTensor.from_local(got, mesh, [Partial() if s else p for s, p in
                                          zip(split, logits.placements)],
                              run_check=False, shape=idx.shape,
                              stride=_contiguous(idx.shape))


def _split_logsumexp(logits):
    """log sum exp over a last dim split across mesh dims: each rank takes
    its slice's maximum, the ranks agree on the largest (an all-reduce of
    the (..., 1) maxima), each sums exp(l - m) over its slice, and the
    partial sums are reduced: the (..., V) logits never move. (DTensor's
    own would gather them, gigabytes for a 50k vocab.)"""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = logits.device_mesh
    last = logits.ndim - 1
    split = [j for j, p in enumerate(logits.placements) if p == Shard(last)]
    loc = logits.to_local()
    m = loc.detach().amax(dim=-1, keepdim=True)
    for j in split:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(j))
    rest = [Replicate() if j in split else p
            for j, p in enumerate(logits.placements)]
    s = DTensor.from_local(torch.exp(loc - m).sum(dim=-1), mesh,
                           [Partial() if j in split else p
                            for j, p in enumerate(logits.placements)],
                           run_check=False)
    s = s.redistribute(mesh, rest)
    return DTensor.from_local(m[..., 0], mesh, rest,
                              run_check=False) + torch.log(s)


def _expand_ellipsis(eq: str, ops) -> str:
    if "..." not in eq:
        return eq
    lhs, out = eq.split("->")
    terms = lhs.split(",")
    spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n = max(o.ndim - (len(t) - 3) for t, o in zip(terms, ops) if "..." in t)
    fill = "".join(spare[:n])
    terms = [t.replace("...", fill[n - (o.ndim - (len(t) - 3)):])
             for t, o in zip(terms, ops)]
    return ",".join(terms) + "->" + out.replace("...", fill)


def _local_einsum(eq: str, ops):
    """An einsum of DTensors (and plain tensors, read as replicated), each
    rank on its local shards. For each mesh dimension the first operand
    sharded on it names an index letter L: every operand holding L is
    placed sharded on L there, every other one replicated, and the output
    is sharded on L (L kept) or partial (L summed). Partial operands are
    reduced first. Each operand's local gradient is declared partial over
    a mesh dimension where it is replicated while L is split, which is
    what its rows of the sum make it. DTensor's own propagation of
    einsum flattens sharded dims, which some torch versions refuse."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    DT = _dtensor_type()
    eq = _expand_ellipsis(eq.replace(" ", ""), ops)
    lhs, out = eq.split("->")
    terms = lhs.split(",")
    mesh = next(o.device_mesh for o in ops if isinstance(o, DT))
    ops = [o if isinstance(o, DT) else DTensor.from_local(
        o, mesh, _rep(mesh), run_check=False) for o in ops]
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    want = [[Replicate()] * mesh.ndim for _ in ops]
    grad = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = [Replicate()] * mesh.ndim
    for j in range(mesh.ndim):
        letter = next((t[o.placements[j].dim] for t, o in zip(terms, ops)
                       if isinstance(o.placements[j], Shard)), None)
        if letter is None:
            continue
        for i, t in enumerate(terms):
            if letter in t:
                want[i][j] = grad[i][j] = Shard(t.index(letter))
            else:
                grad[i][j] = Partial()
        out_pl[j] = Shard(out.index(letter)) if letter in out else Partial()
    sizes = {}
    for t, o in zip(terms, ops):
        for c, n in zip(t, o.shape):
            sizes[c] = max(sizes.get(c, 1), n)
    locs = [_contiguous_grad(o.redistribute(mesh, w).to_local(
        grad_placements=g)) for o, w, g in zip(ops, want, grad)]
    res = torch.einsum(eq, *locs).contiguous()
    shape = torch.Size(sizes[c] for c in out)
    return DTensor.from_local(res, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def _contiguous_grad(x):
    """``x``, whose gradient is made contiguous on its way back. An
    einsum's operand gradients come back permuted (batched products), and
    a DTensor made from such a local shard can carry global strides that
    the shard does not have: a later backward ``view`` across the split
    dims then refuses it (olmo-1b at one head a rank, model = 16)."""
    import torch

    class _Contiguous(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    return _Contiguous.apply(x) if x.requires_grad else x


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def whole_heads(x, n: int, split_batch: bool = False):
    """``x`` (B, ..., n * width) with its last dim whole over every mesh
    dim that splits it into parts not holding whole heads (n % parts !=
    0): llama4's 40 heads over a model axis of 16. DTensor refuses to
    split such a dim into (n, width), where GSPMD pads; the heads are
    gathered instead. With ``split_batch`` (training) such a mesh dim
    splits the batch (dim 0) where the batch divides, so that a rank
    attends whole heads of its share of the sequences (an all-to-all)
    rather than every head of all of them. Anything else passes as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    last = x.ndim - 1
    mesh = x.device_mesh
    want = list(x.placements)
    for j, p in enumerate(want):
        if not (p.is_shard() and p.dim == last and n % mesh.shape[j]):
            continue
        parts = mesh.shape[j]
        for i, q in enumerate(want):
            if q.is_shard() and q.dim == 0:
                parts *= mesh.shape[i]
        want[j] = Shard(0) if split_batch and last > 0 \
            and x.shape[0] % parts == 0 else Replicate()
    if want == list(x.placements):
        return x
    return x.redistribute(mesh, want)


def whole_heads_grad(x, n: int, split_batch: bool = False):
    """``x`` itself, whose gradient comes back with ``whole_heads``'
    placements: where the heads are merged, (..., n, width) ->
    (..., n * width), the backward splits that dim again, which DTensor
    refuses for a gradient split into parts not holding whole heads (the
    products after it leave their gradients split that way)."""
    if not is_dtensor(x):
        return x
    import torch

    class _WholeHeadsGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return whole_heads(g, n, split_batch)

    return _WholeHeadsGrad.apply(x) if x.requires_grad else x


def whole_local(x):
    """The local tensor of a DTensor that every rank holds whole (all
    placements replicated); anything else as it is."""
    if is_dtensor(x) and all(p.is_replicate() for p in x.placements):
        return x.to_local()
    return x


def _local_window(x) -> tuple:
    """``(offsets, sizes)``: where this rank's shard of the DTensor ``x``
    sits in the global tensor, dim by dim (DTensor's even chunks, the
    mesh dims splitting a tensor dim in mesh order)."""
    off, size = [0] * x.ndim, list(x.shape)
    for j, pl in enumerate(x.placements):
        if pl.is_shard():
            d, n = pl.dim, x.device_mesh.shape[j]
            chunk = -(-size[d] // n)
            start = min(x.device_mesh.get_local_rank(j) * chunk, size[d])
            off[d] += start
            size[d] = max(min(chunk, size[d] - start), 0)
    return off, size


def masked_fill(x, mask, value):
    """``x.masked_fill(mask, value)``; for a DTensor ``x`` and a mask
    that every rank holds whole (a plain tensor, or a replicated
    DTensor), broadcast against it, rank by rank: each rank fills its
    shard from its slice of the mask. DTensor's own rule leaves the
    broadcast mask whole beside a split ``x``."""
    mask = whole_local(mask)
    if not is_dtensor(x) or is_dtensor(mask):
        return x.masked_fill(mask, value)
    from torch.distributed.tensor import DTensor

    mask = mask.reshape((1,) * (x.ndim - mask.ndim) + tuple(mask.shape))
    off, size = _local_window(x)
    for d in range(x.ndim):
        if mask.shape[d] > 1:
            mask = mask.narrow(d, off[d], size[d])
    loc = x.to_local().masked_fill(mask, value)
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def index_write(buf, dim: int, idx, val):
    """``buf.index_copy_(dim, idx, val)``: rows ``idx`` (distinct) of
    ``buf`` along ``dim`` written in place. For a DTensor ``buf`` rank by
    rank: ``val`` is brought to ``buf``'s placements with ``dim`` whole,
    and each rank writes the rows that fall in its shard through a select
    over its slice of ``dim`` (DTensor's own in-place ``index_copy_`` on a
    split ``dim`` relabels ``buf`` as replicated and keeps the shard). A
    plain ``buf`` takes torch's ``index_copy_``."""
    if not is_dtensor(buf):
        return buf.index_copy_(dim, idx, val)
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    mesh = buf.device_mesh
    idx = whole_local(idx)
    want = [Replicate() if p.is_shard() and p.dim == dim else p
            for p in buf.placements]
    if not is_dtensor(val):
        val = DTensor.from_local(val, mesh, _rep(mesh), run_check=False)
    if list(val.placements) != want:
        val = val.redistribute(mesh, want)
    vloc, loc = val.to_local(), buf.to_local()
    off, size = _local_window(buf)
    pos = torch.arange(size[dim], device=loc.device) + off[dim]
    sel = pos[None, :] == idx.to(pos.dtype)[:, None]     # (len(idx), rows)
    shape = [1] * loc.ndim
    shape[dim] = size[dim]
    src = vloc.index_select(dim, sel.to(torch.int32).argmax(0))
    loc.copy_(torch.where(sel.any(0).reshape(shape), src, loc))
    return buf


def _rep(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def constrain(x, logical_axes: tuple):
    """``x`` placed as ``logical_axes`` say under the active context; ``x``
    itself without a context, or where ``x`` is not a DTensor."""
    ctx = getattr(_ctx, "val", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, plan = ctx
    entries = tuple(plan.mesh_axes(a) for a in logical_axes)
    spec = _fix_divisibility(entries, tuple(x.shape), mesh)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
