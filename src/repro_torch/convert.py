"""Carry state across from plain numpy arrays to the port's objects.

``operator_from_numpy`` and ``state_from_numpy`` take numpy arrays and
Python metadata (the leaves of an operator or of a
``GQLState``/``LanczosState``/``CoeffHistory``/``BlockState``/
``QuadState``) and return the port's
operator or state on ``device``. Whoever holds another package's arrays
converts them to numpy first, so this module never sees them; it is what
lets a parity test start two implementations from identical states.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import block as _block
from .core import gql as _gql
from .core import lanczos as _lz
from .core import matfun as _matfun
from .core import operators as _ops
from .core import solver as _solver

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


def state_from_numpy(fields: dict, *, device="cuda"):
    """Build a ``LanczosState``, ``GQLState``, ``CoeffHistory``,
    ``BlockState`` or ``QuadState`` from a dict of numpy fields, picked by
    its keys. Nested states (``GQLState.lz``, ``QuadState.st``,
    ``QuadState.coeffs``) are dicts or already-built states;
    ``QuadState.op`` is a port operator or a ``(kind, leaves)`` pair."""
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
    raise ValueError(f"fields {sorted(keys)} match no LanczosState, "
                     f"GQLState, CoeffHistory, BlockState or QuadState")
