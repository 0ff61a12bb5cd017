"""Carry state across from plain numpy arrays to the port's objects.

``operator_from_numpy`` and ``state_from_numpy`` take numpy arrays and
Python metadata (the leaves of an operator or of a
``GQLState``/``LanczosState``/``CoeffHistory``/``BlockState``/
``QuadState``/``ChainFactor``/``ChainState``) and return the port's
operator or state on ``device``; ``request_from_numpy`` builds a
``BIFRequest`` whose banked per-lane state (a ``QuadState`` over a 1-D
``Masked`` mask, ``basis=None``) resumes in a port ``BIFEngine``.
``params_from_numpy`` / ``params_to_numpy`` and
``adamw_state_from_numpy`` carry a model's parameters and its AdamW state
as numpy leaves in the reference's leaf order, and ``caches_from_numpy``
/ ``caches_to_numpy`` its stacked decode caches (KV, SSM or the hybrid's
tree of both), so a decode resumes in the port from caches the reference
filled. Whoever holds another package's arrays converts them to numpy
first, so this module never sees them; it is what lets a parity test
start two implementations from identical states.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import block as _block
from .core import dpp as _dpp
from .core import gql as _gql
from .core import lanczos as _lz
from .core import matfun as _matfun
from .core import operators as _ops
from .core import solver as _solver
from .core import update as _update

_KINDS = ("dense", "coo", "bell", "masked", "shifted", "jacobi")


def _t(x, dev):
    if x is None:
        return None
    return torch.as_tensor(np.array(x), device=dev)


def operator_from_numpy(kind: str, leaves: dict, *, device="cuda"):
    """Build a port operator from numpy leaves.

    ``kind`` and its ``leaves``:
      'dense'   {'a'}
      'coo'     {'rows', 'cols', 'vals', 'diag_vals', 'n_static'}
      'bell'    {'data', 'cols', 'diag_vals', 'n_static'[, 'mode',
                 'interpret']}
      'masked'  {'base', 'mask'}
      'shifted' {'base', 'sigma'}
      'jacobi'  {'base', 'inv_sqrt_diag'}
    ``base`` is a port operator or a nested ``(kind, leaves)`` pair.
    """
    dev = _ops.resolve_device(device)
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if kind == "dense":
        return _ops.Dense(_t(leaves["a"], dev))
    if kind == "coo":
        return _ops.SparseCOO(_t(leaves["rows"], dev), _t(leaves["cols"], dev),
                              _t(leaves["vals"], dev),
                              int(leaves["n_static"]),
                              _t(leaves["diag_vals"], dev))
    if kind == "bell":
        return _ops.SparseBELL(_t(leaves["data"], dev),
                               _t(leaves["cols"], dev),
                               _t(leaves["diag_vals"], dev),
                               int(leaves["n_static"]),
                               mode=leaves.get("mode", "reference"),
                               interpret=leaves.get("interpret"))
    base = leaves["base"]
    if isinstance(base, tuple):
        base = operator_from_numpy(*base, device=dev)
    if kind == "masked":
        return _ops.Masked(base, _t(leaves["mask"], dev))
    if kind == "shifted":
        return _ops.Shifted(base, _t(leaves["sigma"], dev))
    return _ops.Jacobi(base, _t(leaves["inv_sqrt_diag"], dev))


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def state_from_numpy(fields: dict, *, device="cuda", mesh=None,
                     axis: str = "lanes"):
    """Build a ``LanczosState``, ``GQLState``, ``CoeffHistory``,
    ``BlockState`` or ``QuadState`` from a dict of numpy fields, picked by
    its keys. Nested states (``GQLState.lz``, ``QuadState.st``,
    ``QuadState.coeffs``) are dicts or already-built states;
    ``QuadState.op`` is a port operator or a ``(kind, leaves)`` pair.

    With ``mesh`` (a lane mesh) the fields are a global, padded (Kp,)-lane
    ``QuadState``, such as the reference's sharded state, and the result
    is this rank's shard of it (``sharded.shard_state``), which
    ``resume_sharded`` continues."""
    if mesh is not None:
        from .core import sharded as _sharded
        state = state_from_numpy(fields, device=device)
        if not isinstance(state, _solver.QuadState):
            raise ValueError("mesh= shards a QuadState; these fields make "
                             f"a {type(state).__name__}")
        return _sharded.shard_state(state, mesh, axis)
    dev = _ops.resolve_device(device)
    keys = set(fields)

    def sub(x):
        return state_from_numpy(x, device=dev) if isinstance(x, dict) else x

    if keys == set(_lz.LanczosState._fields):
        return _lz.LanczosState(**{k: _t(v, dev) for k, v in fields.items()})
    if keys == set(_gql.GQLState._fields):
        vals = {k: _t(v, dev) for k, v in fields.items() if k != "lz"}
        return _gql.GQLState(lz=sub(fields["lz"]), **vals)
    if keys == _fields(_matfun.CoeffHistory):
        return _matfun.CoeffHistory(**{k: _t(v, dev)
                                       for k, v in fields.items()})
    if keys == _fields(_block.BlockState):
        return _block.BlockState(**{k: _t(v, dev)
                                    for k, v in fields.items()})
    if keys <= set(_solver.QuadState._fields) and \
            {"op", "st", "lam_min", "lam_max", "basis", "step"} <= keys:
        op = fields["op"]
        if isinstance(op, tuple):
            op = operator_from_numpy(*op, device=dev)
        coeffs = fields.get("coeffs")
        return _solver.QuadState(
            op=op, st=sub(fields["st"]), lam_min=_t(fields["lam_min"], dev),
            lam_max=_t(fields["lam_max"], dev),
            basis=_t(fields["basis"], dev), step=_t(fields["step"], dev),
            coeffs=None if coeffs is None else sub(coeffs))
    if keys == _fields(_update.ChainFactor):
        return _update.ChainFactor(
            n=int(fields["n"]), **{k: _t(fields[k], dev)
                                   for k in ("idx", "chol", "count", "ok")})
    if {"mask", "stats"} <= keys <= {"mask", "stats", "factor", "key"}:
        # the reference's key is dropped: the port's steps take their
        # draws as an argument
        stats = fields["stats"]
        if isinstance(stats, dict):
            stats = [stats[k] for k in _dpp.ChainStats._fields]
        factor = fields.get("factor")
        return _dpp.ChainState(
            mask=_t(fields["mask"], dev).to(torch.float32),
            stats=_dpp.ChainStats(*(_t(x, dev).to(torch.int32)
                                    for x in stats)),
            factor=None if factor is None else sub(factor))
    raise ValueError(f"fields {sorted(keys)} match no LanczosState, "
                     f"GQLState, CoeffHistory, BlockState, QuadState, "
                     f"ChainFactor or ChainState")


def _from_numpy(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bf16: the same words
        return torch.from_numpy(np.array(arr, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.as_tensor(np.array(arr))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _leaf_tensor(arr, like, dev) -> torch.Tensor:
    t = _from_numpy(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"leaf shape {tuple(t.shape)}, the model's "
                         f"{tuple(like.shape)}")
    return t.to(device=dev, dtype=like.dtype)


def params_from_numpy(cfg, leaves, *, device="cuda"):
    """The port's parameter tree for ``cfg`` from numpy leaves in the
    reference's leaf order (``jax.tree.leaves`` of its ``init_model``),
    each cast to the model's dtype."""
    from . import tree
    from .models import model as _model

    dev = _ops.resolve_device(device)
    like, spec = tree.flatten(_model.param_skeleton(cfg))
    leaves = list(leaves)
    if len(leaves) != len(like):
        raise ValueError(f"{len(leaves)} leaves; {cfg.name} has "
                         f"{len(like)}")
    return tree.unflatten(spec, [_leaf_tensor(a, lk, dev)
                                 for a, lk in zip(leaves, like)])


def params_to_numpy(params) -> list:
    """The leaves of a port tree (parameters, gradients, moments) as numpy
    arrays in the reference's leaf order; bf16 leaves widen to f32
    (exactly)."""
    from . import tree
    return [_to_numpy(t) for t in tree.leaves(params)]


def adamw_state_from_numpy(cfg, leaves, *, device="cuda"):
    """The port's ``AdamWState`` for ``cfg``'s parameters from the
    reference's state leaves in its order: the step count, then the
    first moments, then the second (f32, shaped like the parameters)."""
    from . import tree
    from .models import model as _model
    from .optim import AdamWState

    dev = _ops.resolve_device(device)
    like, spec = tree.flatten(_model.param_skeleton(cfg))
    leaves = list(leaves)
    if len(leaves) != 1 + 2 * len(like):
        raise ValueError(f"{len(leaves)} leaves; an AdamW state of "
                         f"{cfg.name} has {1 + 2 * len(like)}")
    f32 = [torch.empty(x.shape, dtype=torch.float32, device="meta")
           for x in like]

    def moments(arrs):
        return tree.unflatten(spec, [_leaf_tensor(a, lk, dev)
                                     for a, lk in zip(arrs, f32)])

    n = len(like)
    return AdamWState(count=torch.as_tensor(np.array(leaves[0]),
                                            dtype=torch.int32),
                      m=moments(leaves[1:1 + n]),
                      v=moments(leaves[1 + n:]))


def _cache_layout(cfg) -> tuple:
    """``({quantized: leaf count}, what, kv_at)`` of ``cfg``'s stacked
    caches: the leaf counts of an f32 / bf16 and of an int8 cache, their
    description, and the index of the first KV leaf (None: no KV)."""
    kv = {False: 3, True: 5}
    kv_what = "k, v, length a KVCache; 5 with the int8 scales"
    fam = cfg.family
    if fam == "ssm":
        return {False: 2}, "2 (conv, state)", None
    if fam == "hybrid":
        from .models import model as _model
        tail = 2 if _model._hybrid_shape(cfg)[2] else 0
        counts = {q: tail + c + 2 for q, c in kv.items()}
        return (counts, f"{counts[False]} or {counts[True]} ({tail} tail "
                        f"conv, state; the units' {kv_what}; their conv, "
                        f"state)", tail)
    n_kv = cfg.moe_every if fam == "moe" else 1
    return ({q: c * n_kv for q, c in kv.items()},
            f"{3 * n_kv} (k, v, length a KVCache) or {5 * n_kv} (with the "
            f"int8 scales)", 0)


def caches_from_numpy(cfg, leaves, *, device="cuda"):
    """The port's stacked caches for ``cfg`` from the leaves of the
    reference's (``jax.tree.leaves`` of its ``make_caches`` / ``prefill``
    caches), in the structure ``model.make_caches`` builds: dense, vlm,
    encdec, one ``KVCache`` (``k``, ``v``, ``length`` (n_layers,), and
    for an int8 cache ``k_scale``, ``v_scale``); moe, ``{"sub{i}":
    KVCache}`` over (n_units,); ssm, one ``SSMCache`` (``conv``,
    ``state``); hybrid, ``{"tail": SSMCache, "units": {"attn": KVCache,
    "ssm": SSMCache}}`` (sorted keys: the tail's leaves first). Each float
    leaf keeps its dtype (a bf16 cache stays bf16); ``length`` is
    int32."""
    from . import tree
    from .models import model as _model

    dev = _ops.resolve_device(device)
    arrs = [_from_numpy(a) for a in leaves]
    counts, what, kv_at = _cache_layout(cfg)
    quantized = [q for q, c in counts.items() if c == len(arrs)]
    if not quantized:
        raise ValueError(f"{len(arrs)} leaves; {cfg.name}'s caches have "
                         f"{what}")
    shp = arrs[0].shape
    if len(shp) < 3:
        raise ValueError(f"cache shape {tuple(shp)}, {cfg.name} takes a "
                         f"leading layer axis and a batch")
    # (n, B, S_max, ...) of a KV leaf; an SSM cache has no S_max
    s_max = 1 if kv_at is None else arrs[kv_at].shape[2]
    like, spec = tree.flatten(_model.make_caches(
        cfg, shp[1], s_max, quantized_kv=quantized[0], device="meta"))
    out = []
    for a, lk in zip(arrs, like):
        want = tuple(lk.shape)
        if tuple(a.shape) != want:
            raise ValueError(f"cache shape {tuple(a.shape)}, {cfg.name} "
                             f"takes {want}")
        out.append(a.to(dev) if lk.is_floating_point() else
                   a.to(device=dev, dtype=lk.dtype))
    return tree.unflatten(spec, out)


def caches_to_numpy(caches) -> list:
    """The leaves of port caches (stacked or not; a ``KVCache``, a dict of
    them, an ``SSMCache``, the hybrid's tree of both) as numpy arrays in
    the reference's order, the None scales left out; bf16 widens to f32
    (exactly)."""
    from . import tree
    return [_to_numpy(t) for t in tree.leaves(caches)]


def request_from_numpy(fields: dict, *, device="cuda"):
    """Build a ``serve.BIFRequest`` from another package's request: its
    public fields as numpy arrays and Python values, with ``state`` a
    banked per-lane state as ``state_from_numpy`` takes it (``op`` a
    ``('masked', {'base': ..., 'mask': (N,)})`` pair, ``basis`` None), a
    built ``QuadState``, or None. A banked state resumes where the other
    package stopped when the request is submitted to a port
    ``BIFEngine`` on ``device``: the request banks the query ``u * mask``
    in the state's dtype, as a request banked by the port does, so
    ``submit`` still rejects a later change of ``u`` or ``mask``."""
    from .serve.engine import BIFRequest

    fields = dict(fields)
    state = fields.pop("state", None)
    if isinstance(state, dict):
        state = state_from_numpy(state, device=device)
    req = BIFRequest(state=state, **fields)
    if state is not None:
        dt = state.st.lz.v.detach().cpu().numpy().dtype
        u = np.asarray(req.u, dt)
        mask = np.ones(u.shape, dt) if req.mask is None \
            else np.asarray(req.mask, dt)
        req._banked_query = u * mask
    return req
