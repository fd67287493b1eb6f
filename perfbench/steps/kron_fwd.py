"""Step kind ``kron_fwd``: a forward call of a Kron-Matmul, no gradient.

One step is ``KronOp(ps, qs)(x, factors)`` under ``torch.no_grad()`` on the
next ``traffic.m`` rows of a bank of ``traffic.x_bank`` such blocks drawn
from the seed (one factor set): a stream of single predictions or
right-hand sides against one fixed Kronecker operator.

The check: the outputs of ``traffic.sampled`` window steps, drawn from the
seed among the first ``traffic.sample_range``, and of the last step,
against the float64 reference.
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
        gen = inputs.generator(device, seed)
        bank = inputs.randn(gen, (int(traffic["x_bank"]) * self.m, math.prod(self.ps)),
                            dtype, device)
        self.rows = [bank[j:j + self.m] for j in range(0, bank.shape[0], self.m)]
        self.factors = inputs.factor_sets(gen, 1, self.ps, self.qs, dtype, device)[0]
        picks = torch.randperm(int(traffic["sample_range"]), generator=inputs.host_generator(seed))
        self.sample = {int(w) for w in picks[:int(traffic["sampled"])]}
        if impl == "program":
            from repro_torch.core import KronOp

            self.op = KronOp(self.ps, self.qs)
        elif impl == "control":
            self.op = lambda x, fs: reference.kron_apply(x, fs, tf32=True)
        else:
            raise ValueError(f"unknown impl {impl!r}")
        self.i = 0
        self.w = 0
        self.recording = False
        self.kept: list = []
        self.last = None

    def run(self) -> None:
        j = self.i % len(self.rows)
        with torch.no_grad():
            y = self.op(self.rows[j], self.factors)
        if self.recording:
            if self.w in self.sample:
                self.kept.append((j, y))
            self.w += 1
        self.last = (j, y)
        self.i += 1

    def start_window(self) -> None:
        self.recording, self.kept, self.w = True, [], 0

    def cost(self) -> cost.Cost:
        return cost.kron_forward(self.m, self.ps, self.qs, self.dtype)

    def finish(self) -> None:
        self.op = None

    def check(self) -> dict[str, list[float]]:
        fs = [f.double() for f in self.factors]
        return {"y_rel": [reference.rel_err(y, reference.kron_apply(self.rows[j].double(), fs))
                          for j, y in self.kept + [self.last]]}
