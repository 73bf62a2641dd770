"""Batched serving engine with continuous batching.

The port of the JAX package's ``repro/serving/engine.py`` on its
synchronous path (no plan builder).  A fixed batch of slots; each tick
feeds every active slot its next token (a prompt token while prefilling,
its last sampled token after) through one ``decode_step`` on the device
with per-slot cache lengths.  New requests claim free slots mid-flight;
finished requests (EOS, max tokens, a full cache) free theirs.

``sparse_ffn`` (the overlay of
:func:`~repro_torch.models.sparse_ffn.sparsify_ffn_params`) runs each
overlaid FFN on its cached SpGEMM plans' device stream; the first tick
builds the plans inline.  ``aux`` gives the cross-attention families their
memory: its K/V are projected once into the cache
(:meth:`ServeEngine._install_memory`).

A tick makes one host sync: the copy of its logits to the host, where the
engine samples from ``np.random.default_rng(seed)`` as the reference does,
so the same logits give the same tokens.  The tokens and cache lengths go
up through pinned buffers without a wait (that sync has already passed the
previous tick's copies).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import CROSS_KINDS, _rep, superblock_table
from repro_torch.models.layers import dense
from repro_torch.models.lm import decode_step, init_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class ServeEngine:
    """Serve ``params`` (a param tree on ``device``, default the card) with
    ``max_batch`` slots of ``cache_len`` positions each, in an f32 cache."""

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 cache_len: int = 256, seed: int = 0, aux=None,
                 sparse_ffn=None, device=None):
        # with its index: "cuda" names the current card, as tensors do
        self.device = torch.empty(0, device=resolve_device(device)).device
        for leaf in _leaves(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"params lie on {leaf.device}, the engine serves on "
                    f"{self.device}: move them first")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.cache = init_cache(cfg, max_batch, cache_len,
                                dtype=torch.float32, device=self.device)
        if aux is not None:  # cross-attention memories (vlm/encdec)
            self._install_memory(aux)
        self.cur_len = np.zeros(max_batch, np.int32)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.prefill_pos = np.zeros(max_batch, np.int64)
        self.queue: deque[Request] = deque()
        self.finished: dict[int, Request] = {}
        self.rng = np.random.default_rng(seed)
        self._rid = 0
        self.sparse_ffn = sparse_ffn
        # the reference's keys; the background warm and its host-stream
        # fallback ticks are not ported, so fallback_ticks stays 0
        self.tick_stats = {"jit_ticks": 0, "fallback_ticks": 0,
                           "warm_submits": 0, "warm_failures": 0,
                           "health": "healthy", "host_syncs": 0}
        pin = self.device.type == "cuda"
        self._toks = torch.zeros((max_batch, 1), dtype=torch.long,
                                 pin_memory=pin)
        self._lens = torch.zeros(max_batch, dtype=torch.int32,
                                 pin_memory=pin)

    def stats(self) -> dict:
        """The tick counters: ``jit_ticks`` counts ticks of the device
        step, ``host_syncs`` the host waits they made (one a tick)."""
        return dict(self.tick_stats)

    def _install_memory(self, aux):
        """Project the memory ``aux`` [max_batch, N, D] through each cross
        sub-layer's ``xattn.wk``/``wv``, rep by rep, into the cache's
        ``xk``/``xv``.  As in the reference this is ``aux`` as given: for
        encdec the caller passes the encoder's output
        (``lm._memory_from_aux``) to decode what ``prefill`` computes."""
        if not isinstance(aux, torch.Tensor) or aux.device != self.device:
            raise ValueError(f"aux must be a tensor on {self.device}")
        if aux.dim() != 3 or aux.shape[0] != self.max_batch \
                or aux.shape[2] != self.cfg.d_model:
            raise ValueError(
                f"aux of shape {tuple(aux.shape)}: expected [{self.max_batch}"
                f", N, {self.cfg.d_model}]")
        _, kinds, n_rep, _ = superblock_table(self.cfg)
        shape = aux.shape[:2] + (self.cfg.n_kv_heads, self.cfg.d_head)
        for i, kind in enumerate(kinds):
            if kind not in CROSS_KINDS:
                continue
            key = f"l{i}"
            reps = [_rep(self.params["blocks"][key]["xattn"], r)
                    for r in range(n_rep)]
            # the cache is f32: no cast
            self.cache[key]["xk"] = torch.stack(
                [dense(p["wk"], aux).reshape(shape) for p in reps])
            self.cache[key]["xv"] = torch.stack(
                [dense(p["wv"], aux).reshape(shape) for p in reps])

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, temperature=0.0,
               eos_id=None) -> int:
        prompt = list(prompt)
        if not prompt:
            # no token to feed the first tick, and no last-generated token
            # to resample
            raise ValueError("empty prompt: a request needs >= 1 token")
        if len(prompt) > self.cache_len - 1:
            # a slot retires once cur_len reaches cache_len - 1, so a
            # longer prompt could never produce a token
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit: cache_len="
                f"{self.cache_len} leaves room for at most "
                f"{self.cache_len - 1} prompt tokens")
        self._rid += 1
        self.queue.append(Request(self._rid, prompt, max_new_tokens,
                                  temperature, eos_id))
        return self._rid

    def _admit(self):
        for b in range(self.max_batch):
            if self.slots[b] is None and self.queue:
                req = self.queue.popleft()
                self.slots[b] = req
                self.cur_len[b] = 0
                self.prefill_pos[b] = 0

    def _next_tokens(self):
        toks = np.zeros((self.max_batch, 1), np.int32)
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            pos = self.prefill_pos[b]
            if pos < len(req.prompt):
                toks[b, 0] = req.prompt[pos]
            else:
                toks[b, 0] = req.generated[-1]
        return toks

    def _decode(self, toks):
        """One device step on ``toks`` at the slots' ``cur_len``; returns
        the host copy of its logits [max_batch, vocab] (the tick's one
        host sync)."""
        self._toks.copy_(torch.from_numpy(toks))
        self._lens.copy_(torch.from_numpy(self.cur_len))
        token = self._toks.to(self.device, non_blocking=True)
        cur = self._lens.to(self.device, non_blocking=True)
        logits, self.cache = decode_step(self.params, self.cfg, token,
                                         self.cache, cur,
                                         sparse_ffn=self.sparse_ffn)
        self.tick_stats["jit_ticks"] += 1
        out = logits[:, 0, :self.cfg.vocab].cpu().numpy()
        self.tick_stats["host_syncs"] += 1
        return np.asarray(out, np.float32)

    def step(self):
        """One engine tick: admit, decode, sample, retire."""
        self._admit()
        if all(s is None for s in self.slots):
            return False
        for b, req in enumerate(self.slots):
            if req is not None and self.cur_len[b] >= self.cache_len:
                raise AssertionError(
                    f"slot {b} would write past its KV cache "
                    f"(cur_len={self.cur_len[b]}, cache_len="
                    f"{self.cache_len}); submit() bounds were bypassed")
        logits = self._decode(self._next_tokens())
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            self.cur_len[b] += 1
            if self.prefill_pos[b] < len(req.prompt) - 1:
                self.prefill_pos[b] += 1  # still prefilling; ignore logits
                continue
            self.prefill_pos[b] = len(req.prompt)
            if req.temperature > 0:
                p = np.exp((logits[b] - logits[b].max()) / req.temperature)
                tok = int(self.rng.choice(len(p), p=p / p.sum()))
            else:
                tok = int(np.argmax(logits[b]))
            req.generated.append(tok)
            full = self.cur_len[b] >= self.cache_len - 1
            if (len(req.generated) >= req.max_new_tokens or full
                    or (req.eos_id is not None and tok == req.eos_id)):
                req.done = True
                self.finished[req.rid] = req
                self.slots[b] = None
        return True

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
