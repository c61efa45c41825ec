"""Synthetic token pipeline: deterministic, shardable, restartable.

The PyTorch counterpart of ``repro/data/tokens.py``: batches are pure
functions of (seed, step), so a restart resumes the stream exactly, and
they equal the reference's bit for bit. ``batch_at(step)`` folds the step
into the seed's threefry key, splits it in three and draws, as
``jax.random`` does (``common.rng``): the first token of each row and a
noise token at every position (``randint`` over the vocabulary), and
whether each position follows the successor table (``bernoulli`` at
``structure``). The successor table is a numpy ``default_rng(seed)``
permutation, the same in both packages.

The reference walks the sequence with ``lax.scan``: token t is the
successor of token t - 1 where the draw says so, else the noise token.
Here the walk is taken in about log2(S) gathers: token t is the r-th
successor of the token at the last reset s <= t (a noise token; the
first token when there is none), with r = t - s (t + 1), and
``succ^r`` is composed from the tables ``succ^(2^i)``, made once from
the permutation by repeated squaring. The values are the walk's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.common import rng
from repro_torch.common.device import resolve_device


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.7  # P(next = successor(prev)); rest uniform
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        perm = np.random.default_rng(self.seed).permutation(self.vocab_size)
        succ = torch.as_tensor(perm, dtype=torch.int64, device=self._device)
        # succ^(2^i) for every bit of a run length up to seq_len
        self._powers = [succ]
        for _ in range(max(int(self.seq_len).bit_length() - 1, 0)):
            self._powers.append(self._powers[-1][self._powers[-1]])
        self._root = rng.root_key(self.seed, self._device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch for a given step (pure; identical across restarts):
        int32 ``tokens`` and ``labels`` (the tokens shifted left by one,
        the first wrapping to the end) of shape (B, S)."""
        key = rng.fold_in(self._root, int(step))
        k1, k2, k3 = rng.split(key, 3)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        first = rng.randint(k1, (B, 1), 0, V).long()
        noise = rng.randint(k2, (B, S), 0, V).long()
        use_succ = rng.bernoulli(k3, self.structure, (B, S))

        t = torch.arange(S, device=self._device).expand(B, S)
        reset = torch.where(use_succ, -1, t).cummax(dim=1).values
        base = torch.where(reset >= 0, noise.gather(1, reset.clamp_min(0)),
                           first)
        run = torch.where(reset >= 0, t - reset, t + 1)
        tokens = base
        for i, power in enumerate(self._powers):
            tokens = torch.where((run >> i) & 1 == 1, power[tokens], tokens)
        tokens = tokens.to(torch.int32)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        return {"tokens": tokens, "labels": labels}

    def iterate(self, start_step: int = 0) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def state_dict(self, step: int) -> Dict:
        return {"seed": self.seed, "step": step}

    @staticmethod
    def restore_step(state: Dict) -> int:
        return int(state["step"])
