"""Step kind ``lm_train``: AdamW training steps of a language model.

Set-up: the registry's model (``config["arch"]``) with the configuration's
published widths, its tied embeddings, Kron FFNs, dtype and remat
(``program_config``); ``train.train_state_init`` from the seed on the
device; ``train.make_train_step`` with AdamW at ``OptConfig``'s defaults.
The entry points are ``launch/train.py``'s, unpatched.

One step is one call of the train step (``loss_fn``: the forward pass
under remat and the loss; ``torch.autograd.grad`` into every leaf;
``opt_update``) on ``SyntheticLM(vocab, traffic.seq, traffic.batch,
seed).global_batch(i)``, a new batch every step, drawn on the host from
``(seed, i)``.  Drawing one takes 20-30 ms of an H100 host's time, and the
host issues a step only a little faster than the device runs it, so no
step draws one: the set-up makes its steps' batches, and ``start_window``
the window's, each in one piece on the device; the window's are as many
as ``MARGIN`` times ``run_seconds`` (``BENCHMARK.json``) over one step
timed on an idle device.  A window that outlasts them starts over at its
first.

The record, references to what a step made (the update is functional, so
nothing is copied):

* the drawn step, one window step drawn from the seed among the first
  ``traffic.sample_range``: its input parameters and AdamW's first moment
  before and after it (13.3 GB at qwen3-4b's size, held from the next step
  on; the set-up holds its first step's, so that no window step after the
  drawn one waits for the allocator to map new memory);
* the latest step: the states before and after it.  The one before is
  dropped as the next step starts, where the step would have dropped it,
  so the record of the last step costs the window nothing.

The check, against ``reference_lm_train`` (plain float32) at the step's
input parameters and tokens:

* ``grad_rel``, at the drawn and the last step: the clipped gradient as
  AdamW received it, ``c g = (m_after - b1 m_before) / (1 - b1)``, and at
  the last step its size from the second moment, ``|c g| = sqrt((v_after -
  b2 v_before) / (1 - b2))``, against the reference's gradient clipped by
  the reference's own global norm; the worst leaf's ``max |got - ref| /
  max |ref|``, layer by layer for the stacked leaves; and the program's
  grad norm against the reference's, ``|norm - ref| / ref``;
* ``param_miss``, at the last step: the worst leaf's share of entries of
  the written parameters that differ from the reference's AdamW
  (``reference_lm_train.AdamW.write``) applied to the step's input
  parameters and the moments it produced, at the schedule's learning rate
  for the step's count: the write, the learning rate, the decay and the
  bias corrections, exactly (the moments are held to the reference by
  ``grad_rel``).

The loss is not compared: the mean over 4,096 tokens evens out rounding,
and the e4m3 control's loss can lie as close to the reference's as bf16's
(about 3e-3 nats); ``readings`` gives its difference at both steps beside
the check's numbers, with every leaf's and the share of entries the last
update left as they were (``stalled``).

``impl``: ``"program"``; ``"control"``: the program's loss and gradient
replaced in the check by ``reference_lm_train`` at ``precision="e4m3"``
on the same parameters and tokens; ``"fault:<name>"``: the program with a
planted fault (``FAULTS``), for the check's own tests and calibration.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import NamedTuple

import torch

from perfbench import cost_lm_train, inputs, reference, reference_lm_train

MARGIN = 1.5  # the window's batches over the steps one set-up step's time gives

FAULTS = {
    "grad_rows": "every Kron factor gradient less the part of the last eighth of its rows",
    "kv_shift": "the KV heads grouped off by one: each query group reads its neighbour's",
    "no_qk_norm": "qk-norm left out",
    "head_only_table": "the tied table's gradient from the head alone, the lookup's part dropped",
    "stale_params": "the optimizer's new parameters not written: each step keeps the old ones",
    "norm_sum": "the global norm taken as the sum of the leaves' norms",
}


def program_config(config: dict):
    """The registry's model with the configuration's published widths, its
    tied embeddings, Kron FFNs, dtype and remat."""
    from repro_torch.configs import get_config

    c = config
    return dataclasses.replace(
        get_config(c["arch"]), n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        qkv_bias=c["attention_bias"], rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]), tie_embeddings=c["tie_word_embeddings"],
        kron_ffn=c["kron_ffn"], kron_factors=c["kron_factors"], dtype=c["dtype"],
        remat=c["remat"])


class _Patch:
    """Module attributes replaced for a planted fault, put back by ``remove``."""

    def __init__(self):
        self.saved: list = []

    def set(self, module, name: str, fn) -> None:
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def remove(self) -> None:
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)
        self.saved = []


def _plant(fault: str | None) -> _Patch:
    from repro_torch import tree
    from repro_torch.kernels import emit
    from repro_torch.models import attention
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    patch = _Patch()
    if fault == "grad_rows":
        # The stage backward's factor gradients less the last eighth of the
        # rows' part: a reduction that drops one of eight partial sums.
        twin = emit.grad_reference

        def dropped(orig):
            def grad(x, dy, *fs, **kw):
                dx, dfs = orig(x, dy, *fs, **kw)
                rows = max(x.shape[1] // 8, 1)
                _, tail = twin(x[:, -rows:], dy[:, -rows:], *fs, acc_dtype=kw.get("acc_dtype"))
                return dx, tuple(d - t.to(d.dtype) for d, t in zip(dfs, tail))
            return grad

        patch.set(emit, "grad_cuda", dropped(emit.grad_cuda))
        patch.set(emit, "grad_reference", dropped(emit.grad_reference))
    elif fault == "kv_shift":
        project = attention._project_qkv

        def shifted(cfg, p, x, positions, tp=False):
            q, k, v = project(cfg, p, x, positions, tp)
            return q, k.roll(1, dims=2), v.roll(1, dims=2)

        patch.set(attention, "_project_qkv", shifted)
    elif fault == "head_only_table":
        embed = M._embed

        def lookup_detached(cfg, params, tokens, embeds, sh=None):
            return embed(cfg, {**params, "embed": params["embed"].detach()}, tokens, embeds, sh)

        patch.set(M, "_embed", lookup_detached)
    elif fault == "stale_params":
        patch.set(adamw, "_apply", lambda p, u, lr, cfg: p)
    elif fault == "norm_sum":
        def summed(t, shardings=None):
            return sum(torch.linalg.vector_norm(leaf.float()) for leaf in tree.leaves(t))

        patch.set(adamw, "global_norm", summed)
    return patch


def reference_weights(params: dict) -> dict:
    """The program's parameter tree (or one shaped like it, as AdamW's
    moments) in ``reference_lm_train.Weights``' layout: a dense stack of
    one repeating layer."""
    if params["prelude"] or list(params["stack"]) != ["pos0"]:
        raise ValueError("lm_train runs a stack of one repeating layer")
    layer = params["stack"]["pos0"]
    w = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for k in ("ln1", "ln2"):
        w[k] = layer[k]
    for k in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
        w[k] = layer["mixer"][k]
    for k in ("w1", "w3", "w2"):
        w[k] = tuple(layer["ffn"][k]["factors"])
    return w


def kron_shapes(params: dict) -> list:
    """``(ps, qs)`` of each Kron projection a step runs, three a layer."""
    ffn = params["stack"]["pos0"]["ffn"]
    out = []
    for name in ("w1", "w3", "w2"):
        dims = [tuple(f.shape[1:]) for f in ffn[name]["factors"]]
        out.append((tuple(d[0] for d in dims), tuple(d[1] for d in dims)))
    return out * ffn["w1"]["factors"][0].shape[0]


def leaf_rel(got: torch.Tensor, ref: torch.Tensor, stacked: bool) -> float:
    """``max |got - ref| / max |ref|``, the worst layer's where ``stacked``
    (the leading axis the layers); infinite where ``got`` holds a non-finite
    value."""
    if got.shape != ref.shape:
        raise ValueError(f"shape {tuple(got.shape)} != reference {tuple(ref.shape)}")
    if not stacked:
        return reference.rel_err(got, ref)
    got, ref = got.detach().float().flatten(1), ref.detach().float().flatten(1)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    err = (got - ref).abs().amax(1).double()
    scale = ref.abs().amax(1).double()
    return float(torch.where(scale > 0, err / scale, err).max())


def leaf_rels(got: dict, ref: dict, scale: float = 1.0, magnitude: bool = False,
              suffix: str = "") -> dict[str, float]:
    """``leaf_rel`` of every leaf of two ``Weights`` trees, ``ref`` times
    ``scale`` (its absolute value where ``magnitude``), by name (``w1[0]``:
    the first factor of w1; ``suffix`` appended).  A leaf of ``got`` may be
    a function that makes it."""
    out = {}
    for key, want in ref.items():
        pairs = zip(got[key], want) if isinstance(want, tuple) else [(got[key], want)]
        for j, (g, r) in enumerate(pairs):
            r = r * scale
            rel = leaf_rel(g() if callable(g) else g, r.abs() if magnitude else r,
                           key not in ("embed", "final_norm"))
            out[(f"{key}[{j}]" if isinstance(want, tuple) else key) + suffix] = rel
    return out


def _pairs(a: dict, b: dict):
    """``(name, a's leaf, b's leaf)`` of two ``Weights`` trees."""
    for key, x in a.items():
        if isinstance(x, tuple):
            yield from ((f"{key}[{j}]", u, v) for j, (u, v) in enumerate(zip(x, b[key])))
        else:
            yield key, x, b[key]


def _lazy(fn, a: dict, b: dict) -> dict:
    """A ``Weights`` tree of functions, each making ``fn`` of the two trees'
    leaves at its place, when ``leaf_rels`` reads it."""
    def one(x, y):
        return lambda: fn(x, y)

    return {k: tuple(map(one, a[k], v)) if isinstance(v, tuple) else one(a[k], v)
            for k, v in b.items()}


def _run_seconds() -> float:
    """The benchmark's window, ``run_seconds`` of ``BENCHMARK.json``."""
    bench = Path(__file__).resolve().parents[2] / "BENCHMARK.json"
    return float(json.loads(bench.read_text())["run_seconds"])


class Record(NamedTuple):
    """What one step took and made: the optimizer's count after it, the
    tokens, the states before (0) and after (1) it (``None`` where not
    held), the program's grad norm and loss."""

    count: int
    tokens: torch.Tensor
    labels: torch.Tensor
    p0: dict
    m0: dict
    m1: dict
    gnorm: torch.Tensor
    loss: torch.Tensor
    v0: dict | None = None
    p1: dict | None = None
    v1: dict | None = None


class Step:
    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        from repro_torch.data import SyntheticLM
        from repro_torch.optim import OptConfig
        from repro_torch.train import make_train_step, train_state_init

        self.impl = impl
        fault = impl.split(":", 1)[1] if impl.startswith("fault:") else None
        if impl not in ("program", "control") and fault not in FAULTS:
            raise ValueError(f"unknown impl {impl!r}")
        self.dev = torch.device(device)
        self.lm = reference_lm_train.LMConfig.from_config(config)
        self.cfg = program_config(config)
        run_cfg = dataclasses.replace(self.cfg, qk_norm=False) if fault == "no_qk_norm" else self.cfg
        self.opt_cfg = OptConfig()
        o = self.opt_cfg
        self.adamw = reference_lm_train.AdamW(o.lr, o.warmup_steps, o.decay_steps,
                                              o.min_lr_ratio, o.b1, o.b2, o.eps, o.weight_decay)
        self.state = train_state_init(self.cfg, self.opt_cfg, inputs.generator(self.dev, seed),
                                      device=self.dev)
        self.patch = _plant(fault)
        self.step_fn = make_train_step(run_cfg, self.opt_cfg)
        self.b, self.s = int(traffic["batch"]), int(traffic["seq"])
        self.data = SyntheticLM(vocab=self.lm.vocab, seq_len=self.s, batch=self.b, seed=seed,
                                device="cpu")
        picks = torch.randperm(int(traffic["sample_range"]), generator=inputs.host_generator(seed))
        self.drawn = int(picks[0])
        self.shapes = kron_shapes(self.state.params)
        self.i = 0
        self.w = None  # window steps so far; None before the window
        # the set-up's steps: warm-up, the profiler's start-up and traced and
        # host-timed steps, and the one that sizes the window's batches
        n = sum(int(traffic[k]) for k in ("warmup_steps", "traced_steps", "host_steps")) + 2
        self._make_pool(n)
        self.kept = None  # the drawn step's Record
        self.last = None  # the latest step's Record
        self._out = None

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _make_pool(self, n: int) -> None:
        """Batches ``i`` to ``i + n - 1`` on the device, ``(n, 2, B, S)``;
        step ``j`` takes ``(j - base) mod n`` of them."""
        made = [torch.stack(self.data.global_batch(self.i + k)) for k in range(n)]
        self.pool, self.base = torch.stack(made).to(self.dev), self.i

    def batch_index(self, i: int) -> int:
        """The data stream's index of step ``i``'s batch."""
        return self.base + (i - self.base) % len(self.pool)

    def run(self) -> None:
        self.last = None  # the state before the previous step, dropped as the step would have
        pair = self.pool[self.batch_index(self.i) - self.base]
        before = self.state
        self.state, metrics = self.step_fn(before, {"tokens": pair[0], "labels": pair[1]})
        rec = Record(self.i + 1, pair[0], pair[1], before.params, before.opt["m"],
                     self.state.opt["m"], metrics["grad_norm"], metrics["loss"])
        # Before the window the first step's record is held too, so the steps
        # of the set-up reach the window's footprint and the allocator holds
        # the memory the window's record takes from the drawn step on.
        if self.w == self.drawn or (self.w is None and self.i == 0):
            self.kept = rec
        self.last = rec._replace(v0=before.opt["v"], p1=self.state.params,
                                 v1=self.state.opt["v"])
        if self.w is not None:
            self.w += 1
        self.i += 1

    def start_window(self) -> None:
        """Makes the window's batches, as many as ``MARGIN`` times the
        benchmark's window over one step timed on an idle device."""
        self._sync()
        t = time.perf_counter()
        self.run()
        self._sync()
        self._make_pool(math.ceil(MARGIN * _run_seconds() / (time.perf_counter() - t)))
        self._sync()
        self.w, self.kept, self.last = 0, None, None

    def cost(self) -> cost_lm_train.TrainCost:
        return cost_lm_train.train_step(self.lm, self.b, self.s, self.shapes, dtype=self.cfg.dtype)

    def finish(self) -> None:
        self.state = None
        self.step_fn = None
        self.patch.remove()

    def _gradient(self, rec: Record, precision: str = "float32"):
        return reference_lm_train.loss_and_grads(
            self.lm, reference_weights(rec.p0), rec.tokens, rec.labels, precision=precision)

    def _compare(self, rec: Record, out: dict) -> None:
        """Adds ``rec``'s readings to ``out``."""
        b1, b2 = self.opt_cfg.b1, self.opt_cfg.b2
        ref_loss, ref = self._gradient(rec)
        ref_norm, ref_scale = reference_lm_train.clip_scale(ref, self.opt_cfg.clip_norm)
        if self.impl == "control":
            loss, grads = self._gradient(rec, "e4m3")
            loss = float(loss)
            gnorm, scale = reference_lm_train.clip_scale(grads, self.opt_cfg.clip_norm)
            got = _lazy(lambda g, _: g * scale, grads, grads)
            sizes = _lazy(lambda g, _: g.abs() * scale, grads, grads)
        else:
            loss, gnorm = float(rec.loss), float(rec.gnorm)
            got = _lazy(lambda a, b: (b - b1 * a) / (1 - b1),
                        reference_weights(rec.m0), reference_weights(rec.m1))
            sizes = None if rec.v1 is None else _lazy(
                lambda a, b: torch.sqrt(torch.clamp((b - b2 * a) / (1 - b2), min=0)),
                reference_weights(rec.v0), reference_weights(rec.v1))
        leaves = {"grad_norm": abs(gnorm - ref_norm) / ref_norm if ref_norm > 0 else math.inf,
                  **leaf_rels(got, ref, ref_scale)}
        if rec.v1 is not None:
            leaves.update(leaf_rels(sizes, ref, ref_scale, magnitude=True, suffix=".v"))
        del ref
        tag = "last" if rec.v1 is not None else "drawn"
        out["loss_diff"].append(abs(loss - float(ref_loss)))
        out["norms"].append((gnorm, ref_norm))
        out["leaves"][tag] = leaves
        out["grad_rel"].append(max(math.inf if math.isnan(v) else v for v in leaves.values()))
        if rec.p1 is None:
            return
        p0, p1 = reference_weights(rec.p0), reference_weights(rec.p1)
        m1, v1 = reference_weights(rec.m1), reference_weights(rec.v1)
        miss, still, total = {}, 0, 0
        for (name, a, b), (_, m, v) in zip(_pairs(p0, p1), _pairs(m1, v1)):
            want = self.adamw.write(a, m, v, rec.count)
            miss[name] = float((b != want).float().mean())
            still += int((b == a).sum())
            total += b.numel()
        out["param_miss"].append(max(miss.values()))
        out["miss_leaves"] = miss
        out["stalled"] = still / total

    def readings(self) -> dict:
        """The check's numbers (``grad_rel``: the drawn step's, then the
        last's; ``param_miss``: the last's), and what the limits were set
        beside: each step's leaves (``leaves``), ``|loss - the
        reference's|`` in nats (``loss_diff``), the program's grad norm and
        the reference's (``norms``), each leaf's share of
        missed entries (``miss_leaves``) and the share of entries the last
        update left as they were (``stalled``).  A window that never
        reached the drawn step reads an infinite ``grad_rel``.  Each
        record is dropped once read."""
        if self._out is not None:
            return self._out
        out = {"grad_rel": [], "param_miss": [], "loss_diff": [], "norms": [], "leaves": {}}
        if self.kept is None and self.last is not None:
            out["grad_rel"].append(math.inf)
        for attr in ("kept", "last"):
            rec = getattr(self, attr)
            setattr(self, attr, None)
            if rec is not None:
                self._compare(rec, out)
            del rec
        self._out = out
        return out

    def check(self) -> dict[str, list[float]]:
        r = self.readings()
        return {"grad_rel": r["grad_rel"], "param_miss": r["param_miss"]}
