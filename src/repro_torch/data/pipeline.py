"""Deterministic synthetic LM data: learnable structure, O(1) state (any
batch is reproducible from ``(seed, step)``, so a restart is exact).

The port of ``repro.data.pipeline``.  The stream is the reference's noisy
affine recurrence over token ids,

    t_{i+1} = (5 t_i + 7 + jump_i) mod vocab,   jump_i != 0 with p = 0.1,

which a causal LM compresses far below uniform entropy.  The draws come from
an explicit CPU ``torch.Generator`` seeded from ``(seed, step)``, so one
seed gives the same tokens on every device; ``jax.random``'s stream cannot
be reproduced, so parity tests hand both packages numpy tokens.

On a mesh every rank draws the same global batch and takes its rows by
``token_sharding`` (``rank_rows``, which the train step calls): a local
cut, as the reference's ``host_slice`` cuts the global batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import sharding as S


def make_batch(
    generator: torch.Generator, batch: int, seq_len: int, vocab: int,
    *, device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(tokens, labels)``, each ``(batch, seq_len)`` int32 on ``device``
    (the card unless ``device="cpu"``); labels are the tokens shifted by
    one.  ``generator`` is a CPU generator, so the draws do not depend on
    the device."""
    a = 5
    t = torch.randint(0, vocab, (batch,), generator=generator, dtype=torch.int64)
    noise = torch.rand(batch, seq_len + 1, generator=generator) < 0.1
    jumps = torch.randint(0, vocab, (batch, seq_len + 1), generator=generator,
                          dtype=torch.int64) * noise
    toks = torch.empty(batch, seq_len + 1, dtype=torch.int64)
    for i in range(seq_len + 1):
        t = (a * t + 7 + jumps[:, i]) % vocab
        toks[:, i] = t
    toks = toks.to(device=device, dtype=torch.int32)
    return toks[:, :-1], toks[:, 1:]


def rank_rows(t: torch.Tensor, rows: "S.NamedSharding") -> torch.Tensor:
    """This rank's rows of a global-batch tensor ``(B, ...)`` by its
    ``token_sharding`` ``rows`` (a local cut, no collective)."""
    return S.local_shard(t, S.NamedSharding(rows.mesh, rows.spec[:1]))


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    device: str = "cuda"

    def _generator(self, step: int) -> torch.Generator:
        # The CPU generator keeps 32 bits of its seed: mix (seed, step) into
        # them rather than concatenate.
        g = torch.Generator()
        g.manual_seed(int(np.random.SeedSequence([self.seed, step]).generate_state(1)[0]))
        return g

    def global_batch(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        return make_batch(self._generator(step), self.batch, self.seq_len,
                          self.vocab, device=self.device)

    def host_slice(
        self, step: int, proc_idx: int, n_procs: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        toks, labels = self.global_batch(step)
        per = self.batch // n_procs
        sl = slice(proc_idx * per, (proc_idx + 1) * per)
        return toks[sl], labels[sl]


__all__ = ["SyntheticLM", "make_batch", "rank_rows"]
