"""Serving launcher of the port: one-shot batch, or continuous batching.

    # one-shot: prefill ONE fixed batch, decode --gen tokens
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --kron-ffn --batch 4 --prompt-len 1024 --gen 64

    # continuous batching: open-loop Poisson arrivals through the pure
    # scheduler (launch/scheduler.py), bucketed prefill, slot recycling
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --kron-ffn --arrival-rate 0.5 --requests 32

``--device`` is ``cuda`` by default and raises without a card; ``--reduced
--device cpu`` runs the tiny same-family config on the CPU through the
kernels' plain twins; ``--layers N`` and ``--dtype`` keep a config's
published widths and cut its depth or change its dtype (a model that fits
the card only in part, as the training launcher's flags of the same names
do).  The port of ``repro.launch.serve`` on one device.

The continuous path has two layers.  ``launch.scheduler`` decides (a pure
state machine, device-free); ``ServeEngine`` here executes: bucketed
prefill under the guard ladder (a ``VmemOverflowError`` on the grouped
prefill degrades to per-request prefills, never drops a request),
admission of prefilled requests into the in-flight decode batch through
the slot-form cache primitives (``model.cache_to_slots``/``cache_take``/
``cache_put``), and one fixed-shape decode step per scheduler step.  Every
(batch-bucket, len-bucket) prefill shape and the decode shape map to
per-shape ``KronOp`` plans resolved at startup (``train.prebuild_kron_ops``
through ``ServeEngine.prewarm``), so steady-state serving plans nothing.

Kept differences from the reference: the decode step writes the cache in
place (the reference donates it to XLA); ``compile_shapes`` runs every
serving shape once (there is nothing to compile ahead: it builds the
kernels, resolves any plan not prewarmed and warms the libraries up);
temperature sampling draws from a ``torch.Generator`` seeded from
``(sample_seed, rid, index)`` (the reference folds the same three into a
``jax.random`` key), so a request's tokens do not depend on co-batching
but differ from the reference's at temperature > 0.

The mesh flags, as the reference's: ``--want-model-parallel N`` builds
``elastic_mesh(world, want_model=N)`` and ``--distributed`` (with
``--kron-ffn``) runs every Kron-FFN projection through the mesh
``KronOp`` inside ``kron_distributed(mesh)``, each prewarmed
(``ServeEngine.prewarm(mesh=)``, ``prebuild_kron_ops(mesh=)``).  The
reference does not shard the serving parameters, so every rank holds the
whole model and runs the same deterministic engine.  The world comes from
``torchrun``'s environment or is the one already initialised
(``launch.mesh.init_world``); a mesh flag without one raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..convert import _device
from ..core.layers import kron_distributed
from ..data import SyntheticLM
from ..models import model as M
from ..models.config import reduced as reduce_cfg
from ..runtime import chaos, guard, telemetry
from ..runtime.events import get_logger
from ..runtime.fault import StragglerMonitor, elastic_mesh
from ..train import make_prefill_step, make_serve_step, prebuild_kron_ops
from .mesh import init_world
from .scheduler import SchedulerConfig, new_state, poisson_trace
from .scheduler import step as sched_step



def batch_buckets(max_prefill: int) -> tuple[int, ...]:
    """Prefill BATCH padding buckets: powers of two up to ``max_prefill``
    (plus ``max_prefill`` itself).  A coalesced group of g requests is
    padded to the smallest bucket >= g, so every prefill launch hits one of
    a fixed, prewarmed set of (batch, seq) shapes."""
    out = []
    b = 1
    while b < max_prefill:
        out.append(b)
        b *= 2
    out.append(max_prefill)
    return tuple(out)


def _pad_batch(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class ServeReport:
    """What one ``ServeEngine.run`` produced."""

    tokens: dict[int, list[int]]          # rid -> emitted tokens
    metrics: dict[int, dict]              # rid -> wall-clock + step metrics
    steps: int
    duration_s: float
    total_tokens: int
    tokens_per_s: float
    ttft_s: list[float]                   # per finished request
    tpot_s: list[float]                   # per request with >= 2 tokens


class ServeEngine:
    """Executes scheduler actions against the model.

    The decode batch has a fixed shape: ``(max_slots, 1)`` tokens with a
    per-slot position vector (``model.decode_step``'s vector-pos mode).
    Free slots decode tokens that are never read; the fixed shape keeps
    the serve loop on one decode shape and one prefill shape per
    (batch-bucket, len-bucket), each with its plans prewarmed.  The engine
    runs where ``params`` live (the embedding's device).
    """

    def __init__(self, cfg, params, scfg: SchedulerConfig, *, max_new: int,
                 temperature: float = 0.0, eos_id: int | None = None,
                 sample_seed: int = 1):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.sample_seed = int(sample_seed)
        self.device = params["embed"].device
        self.max_len = max(scfg.buckets) + self.max_new
        self.batch_buckets = batch_buckets(scfg.max_prefill)
        self._pf = make_prefill_step(cfg, max_len=self.max_len)
        self._decode = make_serve_step(cfg)
        self.log = get_logger("repro_torch.serve")

    def _prefill(self, tokens: np.ndarray, true_lens):
        """A padded prefill: each row's logits at its last real position
        (gathered on the device: one ``(batch, vocab)`` transfer) and the
        cache in slot form, the pad entries masked."""
        tl = torch.as_tensor(np.asarray(true_lens, np.int64), device=self.device)
        logits, cache = self._pf(self.params, torch.from_numpy(tokens).to(self.device))
        rows = logits[torch.arange(tokens.shape[0], device=self.device), tl - 1]
        return rows, M.cache_to_slots(cache, true_lens=tl)

    @staticmethod
    def _move(dst: dict, src: dict, i: int, si: int) -> dict:
        """Admission: row ``i`` of a group cache into decode slot ``si`` of
        ``dst``, in place, one copy per leaf (``cache_take`` gives views)."""
        return M.cache_put(dst, M.cache_take(src, i), si)

    def _new_cache(self) -> dict:
        return M.cache_to_slots(M.init_cache(self.cfg, self.scfg.max_slots, self.max_len,
                                             device=self.device))

    def prewarm(self, mesh=None) -> tuple:
        """Resolve every serving ``KronOp`` plan before the first request:
        one per (batch-bucket, len-bucket) prefill shape plus the decode
        shape.  ``mesh``: also each projection's mesh op, what a
        ``kron_distributed(mesh)`` scope runs."""
        shapes = [(bb, lb) for lb in self.scfg.buckets for bb in self.batch_buckets]
        return prebuild_kron_ops(self.cfg, prefill_shapes=shapes,
                                 decode_batch=self.scfg.max_slots, mesh=mesh)

    def compile_shapes(self) -> int:
        """Run every serving shape once before the first request: one
        prefill per (batch-bucket, len-bucket) shape with its admission
        move, then the decode step.  On the card this builds the kernels
        and warms the libraries, so the first request to reach a cold shape
        does not pay for it in its TTFT.  The warm-up tokens are distinct
        ids, so that no two rows of a warm-up call hold the same input and
        a check held around it sees every row of a tile.  Returns the
        number of shapes run."""
        n = 0
        cache = self._new_cache()

        def ids(*shape):
            return (np.arange(np.prod(shape)) % self.cfg.vocab).astype(np.int32).reshape(shape)

        for lb in self.scfg.buckets:
            for bb in self.batch_buckets:
                rows, c = self._prefill(ids(bb, lb), np.ones(bb, np.int64))
                cache = self._move(cache, c, 0, 0)
                rows.cpu()
                n += 1
        s = self.scfg.max_slots
        logits, _ = self._decode(self.params, cache,
                                 torch.from_numpy(ids(s, 1)).to(self.device),
                                 torch.zeros(s, dtype=torch.int32, device=self.device))
        logits.cpu()
        return n + 1

    # -- model calls -------------------------------------------------------

    def _sample(self, lg: torch.Tensor, rid: int, index: int) -> int:
        """Next token from one row of host logits.  The generator's seed
        depends only on ``(sample_seed, rid, index)``: temperature sampling
        is deterministic per request, independent of co-batching."""
        lg = lg[: self.cfg.vocab]
        if self.temperature <= 0:
            return int(torch.argmax(lg))
        seed = np.random.SeedSequence([self.sample_seed, rid, index]).generate_state(1)[0]
        gen = torch.Generator().manual_seed(int(seed))
        probs = torch.softmax(lg.double() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _prefill_group(self, bucket: int, prompts: list[np.ndarray]):
        """Prefill ``prompts`` padded to ``bucket``; returns per request
        ``(first-token logits row on the host, (slot-form group cache,
        row))``.

        Guard ladder: rung 0 runs the whole group as ONE (batch-bucket,
        bucket) prefill (the ``serve_admit`` chaos site); rung 1 degrades
        to per-request (1, bucket) prefills: a capacity failure on the
        grouped shape costs throughput, never a request."""
        g = len(prompts)
        lens = [int(p.shape[0]) for p in prompts]

        def run(tokens: np.ndarray, true_lens: list[int]):
            rows, cache = self._prefill(tokens, true_lens)
            return rows.cpu(), cache

        def rung_bucket():
            chaos.maybe_fail("serve_admit")
            bb = _pad_batch(g, self.batch_buckets)
            tokens = np.zeros((bb, bucket), np.int32)
            for i, p in enumerate(prompts):
                tokens[i, : lens[i]] = p
            rows, cache = run(tokens, lens + [1] * (bb - g))
            return [(rows[i], (cache, i)) for i in range(g)]

        def rung_split():
            out = []
            for p, ln in zip(prompts, lens):
                tokens = np.zeros((1, bucket), np.int32)
                tokens[0, :ln] = p
                rows, cache = run(tokens, [ln])
                out.append((rows[0], (cache, 0)))
            return out

        return guard.run_ladder(
            f"serve_admit:{bucket}",
            [("bucket", rung_bucket), ("split", rung_split)],
        )

    # -- the serve loop ----------------------------------------------------

    def run(self, requests, *, max_steps: int = 100_000) -> ServeReport:
        """Drive ``requests`` (arrival in scheduler-step units, as from
        ``poisson_trace``) to completion.  Continuous batching: arrivals
        are fed open-loop, prefilled groups are admitted into the live
        decode batch, slots recycle on EOS/max-new."""
        scfg, cfg = self.scfg, self.cfg
        cache = self._new_cache()
        state = new_state(scfg)
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        prompts: dict[int, np.ndarray] = {}
        rng = np.random.RandomState(0)
        for r in pending:
            prompts[r.rid] = rng.randint(0, cfg.vocab, size=(r.prompt_len,)).astype(np.int32)

        slot_rid: dict[int, int] = {}            # engine mirror of the slots
        slot_tok = np.zeros((scfg.max_slots, 1), np.int32)
        slot_pos = np.zeros((scfg.max_slots,), np.int32)
        prefilled: dict[int, tuple] = {}   # rid -> (token, (group cache, i))
        tokens: dict[int, list[int]] = {}
        metrics: dict[int, dict] = {}
        eos_next: list[tuple] = []
        mon = StragglerMonitor(action="log")
        n_done, i = 0, 0
        t_start = time.perf_counter()

        while n_done < len(pending) and state.step_idx < max_steps:
            t = state.step_idx
            events = list(eos_next)
            eos_next = []
            while i < len(pending) and int(pending[i].arrival) <= t:
                req = pending[i]
                events.append(("arrive", req))
                metrics[req.rid] = {"arrival_wall": time.perf_counter(), "arrival_step": t}
                i += 1
            state, actions = sched_step(state, events)
            telemetry.gauge_set("serve.queue_depth", len(state.queued))
            telemetry.observe("serve.queue_depth", float(len(state.queued)))

            for act in actions:
                kind = act[0]
                if kind == "reject":
                    _, rid, reason = act
                    metrics[rid]["reason"] = reason
                    metrics[rid]["finish_wall"] = time.perf_counter()
                    n_done += 1
                    self.log.info(f"reject rid={rid}: {reason}")
                elif kind == "prefill":
                    _, bucket, rids = act
                    with telemetry.span("serve.prefill", bucket=bucket, group=len(rids)):
                        outs = self._prefill_group(bucket, [prompts[r] for r in rids])
                    now = time.perf_counter()
                    for rid, (lg, row) in zip(rids, outs):
                        tok = self._sample(lg, rid, 0)
                        prefilled[rid] = (tok, row)
                        tokens[rid] = [tok]
                        m = metrics[rid]
                        m["first_token_wall"] = now
                        m["first_token_step"] = t
                        telemetry.observe("serve.ttft_s", now - m["arrival_wall"])
                        if self.eos_id is not None and tok == self.eos_id:
                            eos_next.append(("eos", rid))
                elif kind == "admit":
                    _, rid, si = act
                    tok, (src, idx) = prefilled.pop(rid)
                    cache = self._move(cache, src, idx, si)
                    slot_rid[si] = rid
                    slot_tok[si, 0] = tok
                    slot_pos[si] = prompts[rid].shape[0]
                    metrics[rid]["admit_step"] = t
                elif kind == "decode":
                    (_, rids) = act
                    mon.start()
                    with telemetry.span("serve.decode_step", batch=len(rids)):
                        logits, cache = self._decode(
                            self.params, cache, torch.from_numpy(slot_tok).to(self.device),
                            torch.from_numpy(slot_pos).to(self.device))
                        lg = logits[:, -1, : cfg.vocab]
                        # greedy: one argmax on the device for the whole
                        # batch, (slots,) ints to the host
                        if self.temperature <= 0:
                            nxt_all, lg = lg.argmax(dim=-1).cpu().numpy(), None
                        else:
                            nxt_all, lg = None, lg.cpu()
                    mon.stop(t)
                    for si, rid in list(slot_rid.items()):
                        nxt = (int(nxt_all[si]) if nxt_all is not None
                               else self._sample(lg[si], rid, len(tokens[rid])))
                        tokens[rid].append(nxt)
                        slot_tok[si, 0] = nxt
                        slot_pos[si] += 1
                        if self.eos_id is not None and nxt == self.eos_id:
                            eos_next.append(("eos", rid))
                elif kind == "finish":
                    _, rid, reason = act
                    for si, r in list(slot_rid.items()):
                        if r == rid:
                            del slot_rid[si]
                    now = time.perf_counter()
                    m = metrics[rid]
                    m["finish_wall"] = now
                    m["finish_step"] = t
                    m["reason"] = reason
                    n_done += 1
                    telemetry.record_span(
                        "serve.request", m["arrival_wall"], now - m["arrival_wall"],
                        rid=rid, reason=reason, tokens=len(tokens.get(rid, ())),
                    )
            if not actions and not events and i < len(pending):
                # idle gap before the next arrival: fast-forward the clock
                state = dataclasses.replace(
                    state, step_idx=max(state.step_idx, int(pending[i].arrival)))

        duration = time.perf_counter() - t_start
        total = sum(len(v) for v in tokens.values())
        ttft, tpot = [], []
        for rid, m in metrics.items():
            if "first_token_wall" in m and "finish_wall" in m:
                ttft.append(m["first_token_wall"] - m["arrival_wall"])
                n = len(tokens[rid])
                if n >= 2:
                    tpot.append((m["finish_wall"] - m["first_token_wall"]) / (n - 1))
        tps = total / max(duration, 1e-9)
        telemetry.gauge_set("serve.tokens_per_s", tps)
        if mon.flagged_steps:
            self.log.info(f"stragglers: {len(mon.flagged_steps)} decode step(s) flagged")
        return ServeReport(
            tokens=tokens, metrics=metrics, steps=state.step_idx, duration_s=duration,
            total_tokens=total, tokens_per_s=tps, ttft_s=ttft, tpot_s=tpot,
        )


# ---------------------------------------------------------------------------
# Launcher modes
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _one_shot(args, cfg, device, log) -> dict:
    """Fixed-batch mode: prefill one batch, decode ``--gen`` tokens, report
    tokens/s.  Returns the generated tokens and the prefill's logits."""
    max_len = args.prompt_len + args.gen
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.prompt_len, batch=args.batch,
                       device=str(device))
    prompts, _ = data.global_batch(0)
    prefill = make_prefill_step(cfg, max_len=max_len)
    step = make_serve_step(cfg)
    gen = torch.Generator(device=device).manual_seed(1)

    t0 = time.perf_counter()
    with telemetry.span("prefill", batch=args.batch, prompt_len=args.prompt_len):
        logits, cache = prefill(params, prompts)
        _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    def sample(logits):
        lg = logits[:, -1, : cfg.vocab]
        if args.temperature <= 0:
            return lg.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(lg / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    tok = sample(logits)[:, None]
    out_tokens = [tok]
    pos = torch.tensor(args.prompt_len, dtype=torch.int32, device=device)
    # A persistently slow token step on a serving replica is logged, not fatal.
    mon = StragglerMonitor(action="log")
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        mon.start()
        with telemetry.span("decode_step", step=i):
            logits, cache = step(params, cache, tok, pos)
            tok = sample(logits)[:, None]
            pos += 1
            _sync(device)
        mon.stop(i)
        out_tokens.append(tok)
    t_decode = time.perf_counter() - t0

    gen_toks = torch.cat(out_tokens, dim=1).cpu()
    log.info(f"generated shape: {tuple(gen_toks.shape)}")
    log.info(f"sample row: {gen_toks[0, :12].tolist()}")
    pre_tps = args.batch * args.prompt_len / max(t_prefill, 1e-9)
    dec_tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    telemetry.gauge_set("prefill.tokens_per_s", pre_tps)
    telemetry.gauge_set("decode.tokens_per_s", dec_tps)
    log.info(f"prefill: {t_prefill:.2f}s ({pre_tps:.0f} tok/s)  "
             f"decode: {t_decode:.2f}s ({dec_tps:.0f} tok/s)")
    if mon.flagged_steps:
        log.info(f"stragglers: {len(mon.flagged_steps)} decode step(s) flagged")
    return {"tokens": gen_toks, "prefill_logits": prefill_logits}


def _pcts(xs: list[float]) -> dict:
    if not xs:
        return {}
    v = sorted(xs)
    at = lambda q: v[min(len(v) - 1, int(q * (len(v) - 1)))]  # noqa: E731
    return {"p50": at(0.5), "p95": at(0.95), "p99": at(0.99)}


def _continuous(args, cfg, device, log, mesh=None) -> None:
    """Continuous-batching mode: Poisson open-loop arrivals at
    ``--arrival-rate`` requests per scheduler step."""
    scfg = SchedulerConfig(
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_slots=args.slots, max_prefill=args.max_prefill, max_wait=args.max_wait,
    )
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    engine = ServeEngine(cfg, params, scfg, max_new=args.gen,
                         temperature=args.temperature, eos_id=args.eos_id)
    if cfg.kron_ffn:
        for op in engine.prewarm(mesh=mesh if args.distributed else None):
            print(f"kron-ffn {op.describe()}")
    with telemetry.span("serve.compile_shapes"):
        n_shapes = engine.compile_shapes()
    log.info(f"warmed {n_shapes} serving shapes ({len(scfg.buckets)}x"
             f"{len(engine.batch_buckets)} prefill shapes + decode)")
    reqs = poisson_trace(
        seed=args.seed, rate=args.arrival_rate, n=args.requests,
        prompt_lens=(max(1, args.prompt_len // 4), args.prompt_len),
        max_new=(max(1, args.gen // 4), args.gen),
    )
    rep = engine.run(reqs)
    done = [m for m in rep.metrics.values() if "finish_wall" in m]
    log.info(f"served {len(done)}/{args.requests} requests, {rep.total_tokens} tokens in "
             f"{rep.duration_s:.2f}s ({rep.tokens_per_s:.0f} tok/s, {rep.steps} scheduler steps)")
    log.info(f"ttft_s: {_pcts(rep.ttft_s)}  tpot_s: {_pcts(rep.tpot_s)}")


def main(argv=None) -> dict | None:
    """Runs the launcher; one-shot mode returns ``_one_shot``'s tokens and
    prefill logits."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config for CPU demo runs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to N layers (the widths stay)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="the model's dtype (default: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--want-model-parallel", type=int, default=None,
                    help="model-parallel width of elastic_mesh(world, want_model=N) "
                         "(default 16 with --distributed); needs a torch.distributed "
                         "world (torchrun)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (halves serving memory)")
    ap.add_argument("--kron-ffn", action="store_true",
                    help="Kron-compressed FFN projections: each projection of a "
                         "(B, T, d) activation is one KronOp call over B*T rows")
    ap.add_argument("--distributed", action="store_true",
                    help="distributed Kron-FFN: every projection through the mesh "
                         "KronOp (needs --kron-ffn and a torch.distributed world)")
    ap.add_argument("--numerics", choices=list(guard.NUMERICS_POLICIES), default=None,
                    help="non-finite guard at StageProgram boundaries "
                         "(default: FASTKRON_NUMERICS or off)")
    ap.add_argument("--telemetry", metavar="OUT.jsonl", default=None,
                    help="KronScope JSONL event sink: spans, guard/chaos "
                         "events, tokens/s gauges")
    ap.add_argument("--trace", metavar="OUT.trace.json", default=None,
                    help="Chrome-trace (Perfetto) export of the host-side "
                         "spans, written at exit")
    # continuous-batching mode
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="requests per scheduler step (Poisson open loop); "
                         "enables continuous batching")
    ap.add_argument("--requests", type=int, default=32,
                    help="number of requests in the arrival trace")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-trace seed (same seed = same trace)")
    ap.add_argument("--buckets", default="16,32,64",
                    help="prompt padding buckets, comma-separated ascending")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots (continuous-batching batch size)")
    ap.add_argument("--max-prefill", type=int, default=4,
                    help="max requests coalesced into one prefill")
    ap.add_argument("--max-wait", type=int, default=8,
                    help="starvation bound: force-schedule a queued request "
                         "after this many scheduler steps")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="token id treated as EOS (default: none; requests "
                         "run to their per-request max-new)")
    args = ap.parse_args(argv)
    if args.distributed and not args.kron_ffn:
        ap.error("--distributed requires --kron-ffn (it distributes the "
                 "Kron-FFN projections)")
    if args.numerics is not None:
        guard.set_numerics_policy(args.numerics)
    if args.telemetry or args.trace:
        telemetry.configure(jsonl=args.telemetry, trace=args.trace)
    log = get_logger("repro_torch.serve")
    device = _device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    mesh = None
    if args.distributed or args.want_model_parallel is not None:
        world = init_world(device)
        mesh = elastic_mesh(world, want_model=args.want_model_parallel or 16,
                            device_type=device.type)
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg, dtype="float32")
    if args.kv_quant or args.kron_ffn:
        cfg = dataclasses.replace(cfg, kv_quant=args.kv_quant or cfg.kv_quant,
                                  kron_ffn=args.kron_ffn or cfg.kron_ffn)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    out = None
    scope = kron_distributed(mesh) if args.distributed else contextlib.nullcontext()
    with scope:
        if args.arrival_rate is not None:
            _continuous(args, cfg, device, log, mesh)
        else:
            if cfg.kron_ffn:
                # One KronOp per FFN projection, its plan resolved for the
                # serving (batch, prompt-len) rows before the first call.
                for op in prebuild_kron_ops(cfg, batch=args.batch, seq_len=args.prompt_len,
                                            mesh=mesh if args.distributed else None):
                    print(f"kron-ffn {op.describe()}")
            out = _one_shot(args, cfg, device, log)
    # One merged exit report: guard health carries the telemetry snapshot
    # (counters, gauges, histogram percentiles) when KronScope is live.
    report = guard.health_report()
    if telemetry.active() or report["events"] or any(
        h["degraded_calls"] or h["errors"] for h in report["ops"].values()
    ):
        log.info(f"health: {report}")
    telemetry.shutdown()
    return out


__all__ = ["ServeEngine", "ServeReport", "batch_buckets", "main"]


if __name__ == "__main__":
    main()
