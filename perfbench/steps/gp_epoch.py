"""Step kind ``gp_epoch``: a SKI Gaussian-process training epoch (paper §6.4).

One step is ``gp_train_epoch(KronKernel(factors), v)``: ``cg_iters`` CG
iterations on ``(K + noise I) x = v``, ``K`` the Kronecker product of
``dims`` RBF factors on ``points`` grid points each.  The factors cycle
through ``traffic.factor_sets`` sets of lengthscales drawn from the seed
(hyperparameters move between epochs); ``v`` (``m`` probe rows) stays.

The check judges the answer (solution and residual norms) of one window
epoch drawn from the seed among the first ``traffic.sample_range``, and of
the last, by two numbers, each the worst row's:

* ``res_true_rel``: the reported residual norm against the true residual
  ``|v - (K + noise I) x|`` of the reported solution, in float64
  (``reference.true_residual``).  Every MVM and every update of the
  solution and the residual enters one side or the other; the TF32
  control fails it.
* ``x_rel``: the solution against float64 CG's on the same factors, the
  same ``v`` and as many iterations (``reference.row_rel``).  A CG that
  returns its start, stops short or leaves rows unsolved fails it.  Ten
  float32 iterations on a long-lengthscale kernel (condition ~1e7) drift
  from float64's by rounding alone, so its limit lies between that drift
  and one iteration dropped (``PERF.md`` §2).
"""
from __future__ import annotations

import torch

from perfbench import cost, inputs, reference


class Step:
    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        self.points, self.dims = int(config["points"]), int(config["dims"])
        self.m, self.iters = int(config["m"]), int(config["cg_iters"])
        self.noise = float(config["noise"])
        self.dtype = config["dtype"]
        dtype = inputs.DTYPES[self.dtype]
        lo, hi = config["lengthscale_range"]
        gen = inputs.generator(device, seed)
        host = inputs.host_generator(seed)
        scales = lo + (hi - lo) * torch.rand((int(traffic["factor_sets"]), self.dims),
                                             generator=host)
        self.sample = int(torch.randint(int(traffic["sample_range"]), (), generator=host))
        self.sets = [tuple(reference.rbf_factor(self.points, float(ls), dtype=dtype, device=device)
                           for ls in row) for row in scales]
        self.v = inputs.randn(gen, (self.m, self.points ** self.dims), dtype, device)
        if impl == "program":
            from repro_torch.gp.ski import KronKernel, gp_train_epoch

            kernels = [KronKernel(fs) for fs in self.sets]
            self.solve = lambda s: gp_train_epoch(kernels[s], self.v, noise=self.noise,
                                                  cg_iters=self.iters)
        elif impl == "control":
            self.solve = lambda s: reference.gp_solve(self.v, self.sets[s], noise=self.noise,
                                                      iters=self.iters, tf32=True)
        else:
            raise ValueError(f"unknown impl {impl!r}")
        self.i = 0
        self.w = 0
        self.recording = False
        self.sampled = None
        self.last = None

    def run(self) -> None:
        s = self.i % len(self.sets)
        self.last = None
        x, res = self.solve(s)
        if self.recording:
            if self.w == self.sample:
                self.sampled = (s, x, res)
            self.w += 1
        self.last = (s, x, res)
        self.i += 1

    def start_window(self) -> None:
        self.recording, self.sampled, self.w = True, None, 0

    def cost(self) -> cost.Cost:
        return cost.gp_epoch(self.m, (self.points,) * self.dims, self.iters, self.dtype)

    def finish(self) -> None:
        self.solve = None

    def check(self) -> dict[str, list[float]]:
        v = self.v.double()
        out = {"res_true_rel": [], "x_rel": []}
        for s, x, res in [a for a in (self.sampled, self.last) if a is not None]:
            fs = [f.double() for f in self.sets[s]]
            true = reference.true_residual(x.double(), v, fs, noise=self.noise)
            out["res_true_rel"].append(float(((res.double() - true).abs() / true).max()))
            want, _ = reference.gp_solve(v, fs, noise=self.noise, iters=self.iters)
            out["x_rel"].append(reference.row_rel(x, want))
            del true, want
        return out
