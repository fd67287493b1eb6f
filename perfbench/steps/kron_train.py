"""Step kind ``kron_train``: the training step of a Kron-factored layer.

One step is ``y = KronOp(ps, qs)(x, factors)``, then ``torch.autograd.grad``
of ``y`` against a fixed cotangent for ``dx`` and every factor's gradient
(``_KronFunction.backward``).  The factors cycle through
``traffic.factor_sets`` sets drawn from the seed, as an optimizer would
change them between steps; ``x`` and the cotangent stay.

The check: the last step's ``y`` and ``dx``, and every window step's factor
gradients, against the float64 reference in blocks of ``check_rows`` rows.
"""
from __future__ import annotations

import math

import torch

from perfbench import cost, inputs, reference


class Step:
    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        self.ps, self.qs = tuple(config["ps"]), tuple(config["qs"])
        self.dtype = config["dtype"]
        dtype = inputs.DTYPES[self.dtype]
        self.m = int(traffic["m"])
        self.check_rows = int(traffic["check_rows"])
        gen = inputs.generator(device, seed)
        self.x = inputs.randn(gen, (self.m, math.prod(self.ps)), dtype, device).requires_grad_()
        self.g = inputs.randn(gen, (self.m, math.prod(self.qs)), dtype, device)
        self.sets = inputs.factor_sets(gen, int(traffic["factor_sets"]), self.ps, self.qs,
                                       dtype, device, requires_grad=True)
        if impl == "program":
            from repro_torch.core import KronOp

            self.op = KronOp(self.ps, self.qs)
        elif impl == "control":
            self.op = lambda x, fs: reference.kron_apply(x, fs, tf32=True)
        else:
            raise ValueError(f"unknown impl {impl!r}")
        self.i = 0
        self.recording = False
        self.dfs: list = []
        self.last = None

    def run(self) -> None:
        s = self.i % len(self.sets)
        fs = self.sets[s]
        self.last = None
        y = self.op(self.x, fs)
        dx, *dfs = torch.autograd.grad(y, (self.x, *fs), self.g)
        if self.recording:
            self.dfs.append((s, dfs))
        self.last = (s, y.detach(), dx)
        self.i += 1

    def start_window(self) -> None:
        self.recording, self.dfs = True, []

    def cost(self) -> cost.Cost:
        return cost.kron_train_step(self.m, self.ps, self.qs, self.dtype)

    def finish(self) -> None:
        self.op = None

    def check(self) -> dict[str, list[float]]:
        s_last, y, dx = self.last
        y_rel, dx_rel = reference.MaxRel(), reference.MaxRel()
        df_ref = {}
        for s in sorted({s for s, _ in self.dfs} | {s_last}):
            fs = [f.detach().double() for f in self.sets[s]]
            want_x = s == s_last
            acc = [torch.zeros_like(f) for f in fs]
            for r in range(0, self.m, self.check_rows):
                rows = slice(r, r + self.check_rows)
                yb, dxb, dfb = reference.kron_grads(
                    self.x[rows].detach().double(), self.g[rows].double(), fs, want_x=want_x)
                if want_x:
                    y_rel.add(y[rows], yb)
                    dx_rel.add(dx[rows], dxb)
                acc = [a + d for a, d in zip(acc, dfb)]
                del yb, dxb, dfb
            df_ref[s] = acc
        df_rel = [max(reference.rel_err(d, ref) for d, ref in zip(dfs, df_ref[s]))
                  for s, dfs in self.dfs]
        return {"y_rel": [y_rel.value], "dx_rel": [dx_rel.value], "df_rel": df_rel}
