"""Serving entry point (LM mode): slot-based prefill + decode, the port of
``repro/launch/serve.py`` (``:90-186``, ``:550-575``).

    python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --scale small --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --scale full --max-len 4112

A fixed pool of batch slots serves a request queue: a finished sequence
releases its slot, the next request prefills into it, and all slots
decode in lockstep, one ``decode_step`` per token. The reference
prefills a full batch with only the slot's row active and merges that
row into the live cache (``merge_cache_slot``); here the request is
prefilled as a batch of one straight into the slot's rows of the live
cache (``transformer.cache_rows``: views at batch axis 1 in the body,
0 in head and tail), where every layer writes its state in place
(K/V rings, conv histories, RG-LRU and xLSTM states). Rows are
independent in every layer, so the tokens are the same.

It runs on the card unless ``--device cpu`` is given, and fails when
there is no card. The Perona serving modes of the reference
(``--fingerprint``, ``--fleet``, ``--daemon``, ...) come with a later
slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    tokens: Optional[List[int]] = None
    # host clock (time.perf_counter): when the request reached the server
    # (``serve`` stamps its own start on requests that carry none)
    arrival_s: Optional[float] = None
    ttft_s: float = 0.0  # arrival -> first token on the host
    prefill_s: float = 0.0  # prefill start -> first token: one layer's part


class SlotServer:
    """Slot-based continuous batching on top of prefill/decode_step."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 512):
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = model.init_cache(n_slots, max_len, device=self.device)
        self.pos = np.zeros(n_slots, np.int64)
        self.remaining = np.zeros(n_slots, np.int64)
        self.live = np.zeros(n_slots, bool)
        self.request_of_slot: List[Optional[Request]] = [None] * n_slots
        self.last_token = np.zeros(n_slots, np.int64)
        self.decode_s = 0.0  # host clock over all decode steps
        self.decode_tokens = 0  # tokens handed to live requests by decode

    def _prefill_slot(self, slot: int, request: Request):
        """Prefill one sequence as a batch of one, into ``slot``'s rows
        of the live cache."""
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(request.prompt, np.int64)[None],
                               device=self.device)
        rows = tfm.cache_rows(self.cache, slice(slot, slot + 1))
        logits, _ = self.model.prefill(self.params, rows, tokens=toks)
        nxt = int(torch.argmax(logits[0]))
        t1 = time.perf_counter()
        request.prefill_s = t1 - t0
        request.ttft_s = t1 - request.arrival_s
        request.tokens = [nxt]
        self.last_token[slot] = nxt
        self.pos[slot] = len(request.prompt)
        self.remaining[slot] = request.max_new - 1
        self.live[slot] = True
        self.request_of_slot[slot] = request

    def step(self):
        t0 = time.perf_counter()
        toks = torch.as_tensor(self.last_token[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, _ = self.model.decode_step(self.params, toks, pos,
                                           self.cache)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        for s in range(self.n_slots):
            if not self.live[s]:
                continue
            req = self.request_of_slot[s]
            req.tokens.append(int(nxt[s]))
            self.decode_tokens += 1
            self.last_token[s] = int(nxt[s])
            self.pos[s] += 1
            self.remaining[s] -= 1
            if self.remaining[s] <= 0 or self.pos[s] >= self.max_len - 1:
                self.live[s] = False
                self.request_of_slot[s] = None

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> dict:
        start = time.perf_counter()
        for r in requests:
            if r.arrival_s is None:
                r.arrival_s = start
        queue = list(requests)
        done: List[Request] = []
        steps = 0
        while queue or self.live.any():
            for s in range(self.n_slots):
                if not self.live[s] and queue:
                    self._prefill_slot(s, queue.pop(0))
            before = [self.request_of_slot[s] for s in range(self.n_slots)]
            self.step()
            steps += 1
            for s, req in enumerate(before):
                if req is not None and self.request_of_slot[s] is None:
                    done.append(req)
        return {"completed": done, "decode_steps": steps}


def make_requests(n: int, vocab: int, max_new: int, seed: int,
                  lengths=None) -> List[Request]:
    """Prompts of seeded random tokens. Unless ``lengths`` are given,
    each request draws its length from [4, 16] and then its prompt, in
    the order of the reference's ``main``, so that one seed serves the
    same prompts in both packages."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        return [Request(rid=i, max_new=max_new,
                        prompt=rng.integers(0, vocab, rng.integers(4, 17))
                        .astype(np.int32))
                for i in range(n)]
    return [Request(rid=i, max_new=max_new,
                    prompt=rng.integers(0, vocab, s).astype(np.int32))
            for i, s in enumerate(lengths)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--scale", choices=["full", "small"], default="small")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "small":
        cfg = cfg.scaled_down(max_seq=args.max_len)
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    requests = make_requests(args.requests, cfg.vocab_size, args.max_new,
                             args.seed)
    server = SlotServer(model, params, n_slots=args.slots,
                        max_len=args.max_len)
    t0 = time.perf_counter()
    out = server.serve(requests)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens) for r in out["completed"])
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} ({args.scale}) on {where}: "
          f"{len(out['completed'])} requests, {n_tokens} tokens, "
          f"{out['decode_steps']} decode steps, {dt:.1f}s "
          f"({n_tokens / max(dt, 1e-9):.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
