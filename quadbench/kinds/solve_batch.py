"""``solve_batch``: ``BIFSolver.solve_batch`` of ``lanes`` queries a call,
each either ``k(x*, X)`` for a fresh test point drawn from the point
cloud's box (``"query": "kernel_row"``, formed inside the call) or a
standard Gaussian vector (``"gaussian"``); the answers are brackets of
``u^T A^-1 u``, judged by Cholesky solves."""
from __future__ import annotations

import torch

from quadbench import problems, reckon, reference
from quadbench.traffic import Kind, bracket_gap, bracket_miss


class SolveBatch(Kind):
    def __init__(self, *args):
        super().__init__(*args)
        self.op = self.operator()

    def draw(self, i: int):
        g, t, n = self.gen(i), self.traffic, self.problem["n"]
        if t["query"] == "kernel_row":
            return problems.rbf_points(self.cfg, t["lanes"], g, self.dev)
        return torch.randn((t["lanes"], n), generator=g, device=self.dev,
                           dtype=torch.float64)

    def queries(self, inputs):
        if self.traffic["query"] == "kernel_row":
            return problems.rbf_cross(inputs, self.problem["points"],
                                      self.cfg)
        return inputs

    def call(self, inputs) -> dict:
        res = self.solver.solve_batch(
            self.op, self.queries(inputs).to(self.dtype), **self.iv)
        br = torch.stack([res.lower, res.upper]).cpu()
        return dict(lower=br[0], upper=br[1],
                    iterations=res.iterations.cpu(),
                    certified=res.certified.cpu())

    def units(self, out) -> tuple:
        return out["lower"].numel(), int(out["certified"].sum())

    def reckon(self, out) -> tuple:
        p, s = self.problem, self.solver.config
        nb, fl = reckon.krylov_call(
            out["iterations"].tolist(), n=p["n"], nnz=p["nnz"],
            op_bytes=8 if p["kind"] == "rbf" else 4, vec_bytes=8,
            reorth_rows=s.max_iters + 1 if s.reorth else 0)
        return nb, fl, "float64"

    def truths(self, draws, dtype) -> list:
        a = self.reference_operator(dtype)
        chol = torch.linalg.cholesky(a)
        out = []
        for x in draws:
            if self.traffic["query"] == "kernel_row":
                u = reference.rbf_kernel(x, self.problem["points"],
                                         self.cfg, dtype)
            else:
                u = x.to(dtype)
            v = torch.cholesky_solve(u.T, chol)
            out.append((u * v.T).sum(-1).to(torch.float64).cpu())
        return out

    def numbers(self, outs, truths) -> dict:
        miss = max((bracket_miss(o["lower"], o["upper"], t)
                    for o, t in zip(outs, truths)), default=0.0)
        gap = max((bracket_gap(o["lower"], o["upper"]) for o in outs),
                  default=0.0)
        return {"miss": miss, "gap": gap}


KIND = SolveBatch
