"""The one general traffic generator: what every traffic kind shares.

A traffic file (``workloads/<traffic>.json``) names a ``kind`` and its
parameters; ``kinds/<kind>.py`` draws each call's inputs from the seed and
the call's index, makes the call through the program's public entry
point, and judges the answers against the plain reference. A new kind is
a new file there.
"""
from __future__ import annotations

import importlib
import math
from pathlib import Path

import torch

from . import problems, reference

HERE = Path(__file__).resolve().parent


class Kind:
    """What every kind shares: the solver, the seed streams, and the
    numbers of a judged call."""
    def __init__(self, cfg, traffic, problem, seed: int, dev,
                 dtype=torch.float64):
        from repro_torch.core import BIFSolver
        self.cfg, self.traffic, self.problem = cfg, traffic, problem
        self.seed, self.dev, self.dtype = seed, dev, dtype
        self.solver = BIFSolver.create(**traffic["solver"])
        self.iv = dict(lam_min=problem["lmn"], lam_max=problem["lmx"])

    def gen(self, i: int) -> torch.Generator:
        """The generator of call ``i``'s inputs, from the run's seed."""
        return problems.generator(self.dev, self.seed, "call", int(i))

    def operator(self):
        """The operator as the program takes it: a dense matrix, or the
        blocked-ELL table with its diagonal, whose type sets the program's
        vectors; in the kind's type (the control's is one lower)."""
        from repro_torch.core import Dense, SparseBELL
        p = self.problem
        if p["kind"] == "rbf":
            return Dense(p["a"].to(self.dtype))
        return SparseBELL(p["data"], p["cols"], p["diag"].to(self.dtype),
                          p["n"])

    def reference_operator(self, dtype):
        p = self.problem
        if p["kind"] == "rbf":
            return reference.rbf_operator(p["points"], self.cfg, dtype)
        return reference.laplacian_operator(p["adjacency"], self.cfg, dtype)


def bracket_miss(lo, hi, truth) -> float:
    """How far the truths lie outside their brackets, relative to each
    truth; inf where the counts differ or an answer is not a number."""
    lo, hi, truth = (torch.as_tensor(x, dtype=torch.float64).reshape(-1)
                     for x in (lo, hi, truth))
    if not lo.numel() == hi.numel() == truth.numel():
        return math.inf
    out = torch.clamp(torch.maximum(lo - truth, truth - hi), min=0.0)
    rel = torch.where(out > 0, out / truth.abs(), torch.zeros_like(out))
    bad = ~(torch.isfinite(lo) & torch.isfinite(hi))
    return math.inf if bool(bad.any()) else float(rel.max())


def bracket_gap(lo, hi) -> float:
    """The widest bracket relative to its lower end (the solver's
    tolerance rule)."""
    lo, hi = (torch.as_tensor(x, dtype=torch.float64).reshape(-1)
              for x in (lo, hi))
    if lo.numel() == 0:
        return 0.0
    width = hi - lo
    rel = torch.where(width == 0, torch.zeros_like(width),
                      width / lo.abs())
    return float(rel.max()) if bool(torch.isfinite(rel).all()) else math.inf


def make(cfg, traffic, problem, seed: int, dev,
         dtype=torch.float64) -> Kind:
    """The traffic's kind (``kinds/<kind>.py``) over ``problem``; the
    program computes in ``dtype`` (float32: the control, the program's own
    path one precision below the configuration's)."""
    path = HERE / "kinds" / f"{traffic['kind']}.py"
    if not path.exists():
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    mod = importlib.import_module(f"quadbench.kinds.{traffic['kind']}")
    return mod.KIND(cfg, traffic, problem, seed, dev, dtype)
