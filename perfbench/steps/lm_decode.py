"""Step kind ``lm_decode``: greedy decode steps of a language model served
from a prefilled cache.

Set-up: the registry's model (``config["arch"]``, its widths checked
against the configuration's published ones, below) with the
configuration's Kron FFNs and a capacity factor of ``n_experts / top_k``,
so that no token is dropped (``_capacity`` is at least the sequence
length); ``model.init_params`` from the seed on the device;
``traffic.batch`` SyntheticLM prompts of ``traffic.prompt`` tokens from
the seed, ``model.prefill`` into a cache of ``traffic.cache`` positions.
The entry points are ``launch/serve.py``'s, unpatched.

One step is ``model.decode_step`` of every sequence, one token each, and
the greedy pick of the next token, on the device.  The steps cycle over
the ``traffic.cycle`` positions after the prompt: after a cycle the
position returns to the first and the fed token to the prefill's pick.
``attn_decode`` masks the cache entries past the position, so every step
attends over the same buffers and its work is the same however fast the
program runs.  Positions and tokens stay on the device.

The record: ``moe.route_record`` hands every MoE layer's router logits to
buffers made here, the prefill's and a ring of one cycle that every step
writes; a cycle that holds a drawn step is copied aside when it ends.

The check: for ``traffic.sampled`` window steps drawn from the seed among
the first ``traffic.sample_range`` and the last step, the program's logits
against ``reference_lm.forward`` over the prompt and that cycle's fed
tokens (``logit_rel``), whose routed experts are the top-k of the
program's recorded router logits; and those router logits against the
reference's own (``router_rel``).  Each is the worst row's ``max |got -
ref| / max |ref|``.

``impl``: ``"program"``; ``"control"``: the program's outputs replaced by
``reference_lm.forward`` at ``precision="e4m3"`` on the same tokens, with
its own picks; ``"fault:<name>"``: the program with a planted fault
(``FAULTS``), for the check's own tests and calibration.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

from perfbench import cost_lm, inputs, reference, reference_lm

# name -> what is planted.  All but kv_late run the program with a config
# that differs from the one the reference is given.
FAULTS = {
    "kv_late": "each new K/V written one slot late (slot p holds position p-1's)",
    "top5": "five routed experts a token, not six",
    "renorm": "the top-k gates renormalized to sum to 1",
    "no_shared": "the shared experts left out",
    "no_dense_ffn": "the dense layer's FFN left out",
}


def program_config(config: dict):
    """The registry's model with the configuration's published widths, its
    Kron FFNs and dtype, and the dropless capacity factor ``E / k``."""
    from repro_torch.configs import get_config

    c = config
    base = get_config(c["arch"])
    moe = dataclasses.replace(
        base.moe, n_experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
        d_expert=c["moe_intermediate_size"], n_shared=c["n_shared_experts"],
        norm_topk=c["norm_topk_prob"],
        capacity_factor=c["n_routed_experts"] / c["num_experts_per_tok"])
    return dataclasses.replace(
        base, n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]), moe_skip_first=c["first_k_dense_replace"],
        tie_embeddings=c["tie_word_embeddings"], kron_ffn=c["kron_ffn"],
        kron_factors=c["kron_factors"], dtype=c["dtype"], moe=moe)


def _faulty_config(cfg, fault: str):
    moe = cfg.moe
    if fault == "top5":
        return dataclasses.replace(cfg, moe=dataclasses.replace(moe, top_k=moe.top_k - 1))
    if fault == "renorm":
        return dataclasses.replace(cfg, moe=dataclasses.replace(moe, norm_topk=not moe.norm_topk))
    if fault == "no_shared":
        return dataclasses.replace(cfg, moe=dataclasses.replace(moe, n_shared=0))
    if fault == "no_dense_ffn":
        return dataclasses.replace(cfg, d_ff=0)
    return cfg


class _LateKV:
    """The ``kv_late`` fault: each decode call's new K/V is replaced by the
    previous decode call's of the same layer (zeros on the first), as if
    every new entry landed one slot late."""

    def __init__(self, n_layers: int):
        from repro_torch.models import attention

        self.mod, self.orig = attention, attention._project_qkv
        self.n, self.calls, self.prev = n_layers, 0, {}
        attention._project_qkv = self

    def __call__(self, cfg, p, x, positions, tp=False):
        q, k, v = self.orig(cfg, p, x, positions, tp)
        if x.shape[1] != 1:  # the prefill's entries are written in place
            return q, k, v
        layer = self.calls % self.n
        self.calls += 1
        k_old, v_old = self.prev.get(layer, (torch.zeros_like(k), torch.zeros_like(v)))
        self.prev[layer] = (k, v)
        return q, k_old, v_old

    def remove(self) -> None:
        self.mod._project_qkv = self.orig


class ProgramWeights(reference_lm.Weights):
    """The program's parameter tree as the reference reads it: layer ``i``
    from the prelude or from index ``i - prelude`` of the stacked leaves."""

    def __init__(self, cfg, params: dict):
        self.cfg, self.params = cfg, params
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        self.lm_head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]

    def layer(self, i: int) -> dict:
        pre = self.cfg.prelude_len
        if i < pre:
            p = self.params["prelude"][i]
        else:
            period = self.cfg.period
            stacked = self.params["stack"][f"pos{(i - pre) % period}"]
            p = _index(stacked, (i - pre) // period)
        w = {"ln1": p["ln1"], **p["mixer"], "ln2": p["ln2"]}
        if "router" in p["ffn"]:
            w.update({k: p["ffn"][k] for k in ("router", "ew1", "ew3", "ew2")})
            w["shared"] = _ffn(p["ffn"]["shared"])
        else:
            w["ffn"] = _ffn(p["ffn"])
        return w


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


def _ffn(p: dict) -> dict:
    return {k: tuple(v["factors"]) if isinstance(v, dict) else v for k, v in p.items()}


class Step:
    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        from repro_torch.data import SyntheticLM
        from repro_torch.models import model as M
        from repro_torch.models import moe

        self.M, self.moe = M, moe
        self.impl = impl
        fault = impl.split(":", 1)[1] if impl.startswith("fault:") else None
        if impl not in ("program", "control") and fault not in FAULTS:
            raise ValueError(f"unknown impl {impl!r}")
        self.lm = reference_lm.LMConfig.from_config(config)
        self.cfg = program_config(config)
        self.run_cfg = _faulty_config(self.cfg, fault)
        b, p = int(traffic["batch"]), int(traffic["prompt"])
        self.cycle = int(traffic["cycle"])
        if p + self.cycle > int(traffic["cache"]):
            raise ValueError("the cycle runs past the cache")
        lm, dev = self.lm, torch.device(device)
        n_moe, e = lm.n_moe, lm.n_experts

        self.params = M.init_params(self.cfg, inputs.generator(dev, seed), device=dev)
        self.prompts = SyntheticLM(vocab=lm.vocab, seq_len=p, batch=b, seed=seed,
                                   device=str(dev)).global_batch(0)[0].long()
        self.prefill_routes = torch.empty(n_moe, b, p, e, device=dev)
        with moe.route_record(list(self.prefill_routes)):
            logits, self.cache = M.prefill(self.run_cfg, self.params, self.prompts,
                                           int(traffic["cache"]))
        # The ring: fed tokens (slot 0 the prefill's pick; step j writes
        # slot j + 1) and each step's router logits.
        self.toks = torch.empty(self.cycle + 1, b, 1, dtype=torch.long, device=dev)
        self.toks[0] = logits[:, -1, :lm.vocab].argmax(-1, keepdim=True)
        del logits
        self.routes = torch.empty(self.cycle, n_moe, b, 1, e, device=dev)
        self.tok_at = list(self.toks)
        self.routes_at = [list(r) for r in self.routes]
        self.pos_at = list(torch.arange(p, p + self.cycle, dtype=torch.int32, device=dev))
        n_aside = -(-int(traffic["sample_range"]) // self.cycle) + 1
        self.aside_toks = torch.empty((n_aside, *self.toks.shape), dtype=torch.long, device=dev)
        self.aside_routes = torch.empty((n_aside, *self.routes.shape), device=dev)
        self.late = _LateKV(lm.n_layers) if fault == "kv_late" else None

        picks = torch.randperm(int(traffic["sample_range"]), generator=inputs.host_generator(seed))
        self.sample = sorted(int(w) for w in picks[:int(traffic["sampled"])])
        self.b = b
        self.i = 0
        self.w = None  # window steps so far; None before the window
        self.aside: dict[int, int] = {}  # cycle -> aside slot
        self.kept: list = []
        self.last = None

    def run(self) -> None:
        j = self.i % self.cycle
        if j == 0 and self.i and (self.i // self.cycle - 1) in self.aside:
            slot = self.aside[self.i // self.cycle - 1]
            self.aside_toks[slot].copy_(self.toks)
            self.aside_routes[slot].copy_(self.routes)
        with self.moe.route_record(self.routes_at[j]):
            logits, _ = self.M.decode_step(self.run_cfg, self.params, self.cache,
                                           self.tok_at[j], self.pos_at[j])
        torch.argmax(logits[:, 0, :self.lm.vocab], dim=-1, keepdim=True, out=self.tok_at[j + 1])
        if self.w is not None:
            if self.w in self.sample_set:
                self.kept.append((self.i, logits))
            self.w += 1
        self.last = (self.i, logits)
        self.i += 1

    def start_window(self) -> None:
        self.w, self.kept = 0, []
        self.sample_set = set(self.sample)
        cycles = sorted({(self.i + w) // self.cycle for w in self.sample})
        self.aside = {c: k for k, c in enumerate(cycles)}

    def cost(self) -> cost_lm.DecodeCost:
        return cost_lm.decode_step(self.lm, self.b, self.prompts.shape[1], self.cycle,
                                   kron_shapes(self.params), dtype=self.cfg.dtype)

    def finish(self) -> None:
        self.cache = None
        if self.late is not None:
            self.late.remove()

    def check(self) -> dict[str, list[float]]:
        steps = self.kept + [self.last]
        by_cycle: dict[int, list] = defaultdict(list)
        for i, logits in steps:
            by_cycle[i // self.cycle].append((i % self.cycle, logits[:, 0, :self.lm.vocab]))
        last_cycle = self.last[0] // self.cycle
        weights = ProgramWeights(self.cfg, self.params)
        logit_rel, router_rel = [], []
        for c, rows in sorted(by_cycle.items()):
            t = max(j for j, _ in rows) + 1
            if c == last_cycle:
                toks, routes = self.toks, self.routes
            else:
                toks, routes = self.aside_toks[self.aside[c]], self.aside_routes[self.aside[c]]
            tokens = torch.cat([self.prompts, toks[:t, :, 0].T], dim=1)
            got_routes = [torch.cat([self.prefill_routes[l], routes[:t, l, :, 0].transpose(0, 1)],
                                    dim=1) for l in range(self.lm.n_moe)]
            at = torch.tensor([self.prompts.shape[1] + j for j, _ in rows],
                              device=tokens.device)
            if self.impl == "control":
                got, got_routes = reference_lm.forward(self.lm, weights, tokens, logits_at=at,
                                                       precision="e4m3")
                rows = [(j, got[:, k]) for k, (j, _) in enumerate(rows)]
            ref, ref_routes = reference_lm.forward(self.lm, weights, tokens, got_routes,
                                                   logits_at=at)
            logit_rel += [reference.row_rel(g, ref[:, k]) for k, (_, g) in enumerate(rows)]
            router_rel.append(reference.row_rel(
                torch.stack(got_routes).reshape(-1, self.lm.n_experts),
                torch.stack(ref_routes).reshape(-1, self.lm.n_experts)))
            del ref, ref_routes, got_routes
        return {"logit_rel": logit_rel, "router_rel": router_rel}


def kron_shapes(params: dict) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """``(ps, qs)`` of each Kron projection a decode step runs: the
    prelude's FFNs, then every stacked layer's shared experts."""
    def projections(ffn: dict, lead: int) -> list:
        out = []
        for name in ("w1", "w3", "w2"):
            dims = [tuple(f.shape[lead:]) for f in ffn[name]["factors"]]
            out.append((tuple(d[0] for d in dims), tuple(d[1] for d in dims)))
        return out

    def is_kron(ffn) -> bool:
        return isinstance(ffn, dict) and isinstance(ffn.get("w1"), dict)

    shapes = []
    for layer in params["prelude"]:
        if is_kron(layer.get("ffn")):
            shapes += projections(layer["ffn"], 0)
    for stacked in params["stack"].values():
        ffn = stacked.get("ffn", {})
        ffn = ffn.get("shared", ffn)
        if is_kron(ffn):
            shapes += projections(ffn, 1) * ffn["w1"]["factors"][0].shape[0]
    return shapes
