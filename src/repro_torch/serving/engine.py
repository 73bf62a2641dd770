"""Batched serving engine with continuous batching.

The port of the JAX package's ``repro/serving/engine.py``.  A fixed batch
of slots; each tick feeds every active slot its next token (a prompt token
while prefilling, its last sampled token after) through one ``decode_step``
on the device with per-slot cache lengths.  New requests claim free slots
mid-flight; finished requests (EOS, max tokens, a full cache) free theirs.

``sparse_ffn`` (the overlay of
:func:`~repro_torch.models.sparse_ffn.sparsify_ffn_params`) runs each
overlaid FFN on its cached SpGEMM plans' device stream.  Without a
``plan_builder`` the first tick builds those plans inline.  With one, the
warm -- one throwaway ``decode_step`` on zeros of serving shape, which
builds every overlay plan through the locked LRU and lifts its device
stream -- runs on a builder thread, and until it lands each tick runs the
host product stream (:func:`~repro_torch.models.lm.decode_step_loop` with
``sparse_host=True``, counted in ``fallback_ticks``), so no tick waits on a
plan build.  ``aux`` gives the cross-attention families their memory: its
K/V are projected once into the cache (:meth:`ServeEngine._install_memory`).

Resilience: each background warm is governed by a
:class:`~repro_torch.serving.resilience.CircuitBreaker` -- failed or
timed-out warms degrade the engine's health (``warm_failures``, the
breaker's ``info()``), repeated failures pin it to the fallback (no more
warm submissions) until a cooldown elapses and a half-open probe warm
succeeds.  Both tick kinds sample from the same logits with the same one
draw of ``np.random.default_rng(seed)`` per sampled token, so a promotion
mid-request does not shift the sampled stream.

A device tick makes one host sync: the copy of its logits to the host.
The tokens and cache lengths go up through pinned buffers without a wait
(that sync has already passed the previous tick's copies).  A fallback
tick makes that one and five for each overlay FFN it runs (its activation
down, the three matrices' values down, its output up).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.plan_builder import device_scope
from repro_torch.device import resolve_device
from repro_torch.models.blocks import CROSS_KINDS, _n_rep, _rep, \
    superblock_table
from repro_torch.models.layers import dense
from repro_torch.models.lm import decode_step, decode_step_loop, init_cache
from repro_torch.serving.resilience import CircuitBreaker, Health


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
    ``max_batch`` slots of ``cache_len`` positions each, in an f32 cache.
    ``plan_builder`` (a :class:`~repro_torch.core.plan_builder.PlanBuilder`,
    which engines may share) takes the sparse step's warm off the tick
    path, under ``breaker`` (default a fresh :class:`CircuitBreaker`);
    ``warm_deadline`` bounds one warm, in seconds."""

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 cache_len: int = 256, seed: int = 0, aux=None,
                 sparse_ffn=None, plan_builder=None, breaker=None,
                 warm_deadline: float | None = None, device=None):
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
        self.plan_builder = plan_builder
        self.warm_deadline = warm_deadline
        self.tick_stats = {"jit_ticks": 0, "fallback_ticks": 0,
                           "warm_submits": 0, "warm_failures": 0,
                           "health": str(Health.HEALTHY), "host_syncs": 0}
        # a fallback tick's host syncs: the logits' copy, and five for each
        # overlay FFN it runs on the host stream
        self._fallback_syncs = 1 + 5 * sum(
            _n_rep(params["blocks"][key]) for key in (sparse_ffn or {}))
        pin = self.device.type == "cuda"
        self._toks = torch.zeros((max_batch, 1), dtype=torch.long,
                                 pin_memory=pin)
        self._lens = torch.zeros(max_batch, dtype=torch.int32,
                                 pin_memory=pin)
        self._sparse_ready = threading.Event()
        self._warm_lock = threading.Lock()
        self._warm_gen = 0          # invalidates stale/abandoned warm tasks
        self._warm_inflight = False
        self._warm_started = 0.0
        self._closed = False
        if sparse_ffn is None or plan_builder is None:
            # no overlay (plain dense serving) or no builder to hide the
            # warm behind: the first device tick builds the plans inline
            self.breaker = None
            self._sparse_ready.set()
        else:
            self.breaker = breaker if breaker is not None \
                else CircuitBreaker()
            self._maybe_rewarm()

    def _maybe_rewarm(self) -> None:
        """Submit a background warm if health and capacity allow.

        Called from ``__init__`` and the top of every :meth:`step`: the
        tick path is where failures surface (a warm that never lands), so
        it is also where recovery is driven -- when the breaker pins,
        submissions stop; when its cooldown elapses, the next tick's call
        here launches the half-open probe.  Never blocks.
        """
        if self._closed or self._sparse_ready.is_set() \
                or self.sparse_ffn is None or self.plan_builder is None:
            return
        with self._warm_lock:
            if self._warm_inflight:
                # engine-side deadline: if the warm wedged past the builder
                # watchdog (or no watchdog is armed), abandon it here so
                # the breaker can count it and a fresh warm can launch
                if self.warm_deadline is not None and (
                        time.monotonic() - self._warm_started
                        > self.warm_deadline + 0.25):
                    self._warm_gen += 1
                    self._warm_inflight = False
                    self.tick_stats["warm_failures"] += 1
                    self.breaker.record_failure()
                return
            if not self.breaker.allow_attempt():
                return
            self._warm_gen += 1
            gen = self._warm_gen
            self._warm_inflight = True
            self._warm_started = time.monotonic()
            self.tick_stats["warm_submits"] += 1
        status = self.plan_builder.submit_task(
            lambda: self._warm_task(gen), tag=("serve-warm", id(self), gen),
            deadline=self.warm_deadline, retries=1)
        if status == "shed":
            with self._warm_lock:
                if self._warm_gen == gen:
                    self._warm_inflight = False
            self.breaker.probe_cancelled()

    def _warm_task(self, gen: int):
        """Background warm: one throwaway device ``decode_step``.

        Runs on a PlanBuilder worker, on zeros of serving shape from a
        fresh zero cache, on the engine's device: every overlay plan the
        device tick uses builds through the locked LRU and lifts its device
        stream, so the first device tick after promotion builds and lifts
        nothing.  On success sets ``_sparse_ready`` so the next tick
        promotes from the host fallback to the device step; either outcome
        is reported to the breaker via :meth:`_warm_done` (stale
        generations -- a zombie thread finishing after the engine abandoned
        it -- are discarded there).
        """
        if self._closed:
            return
        try:
            faults.check("warm_compile", key=("serve-warm", gen))
            with device_scope(self.device):
                cache0 = init_cache(self.cfg, self.max_batch,
                                    self.cache_len, dtype=torch.float32,
                                    device=self.device)
                tok0 = torch.zeros((self.max_batch, 1), dtype=torch.long,
                                   device=self.device)
                len0 = torch.zeros(self.max_batch, dtype=torch.int32,
                                   device=self.device)
                decode_step(self.params, self.cfg, tok0, cache0, len0,
                            sparse_ffn=self.sparse_ffn)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        except BaseException as e:
            self._warm_done(gen, e)
            raise       # the builder's completion and stats still see it
        self._warm_done(gen, None)

    def _warm_done(self, gen: int, err) -> None:
        with self._warm_lock:
            if gen != self._warm_gen or self._closed:
                return      # stale generation: already abandoned/replaced
            self._warm_inflight = False
            if err is None:
                self.breaker.record_success()
                self._sparse_ready.set()
            else:
                self.tick_stats["warm_failures"] += 1
                self.breaker.record_failure()

    def close(self) -> None:
        """Detach from the (possibly shared) builder: no further warms.

        Invalidates any in-flight warm so its late completion is ignored.
        Never touches the builder itself -- other engines sharing it keep
        running.  Idempotent.
        """
        with self._warm_lock:
            self._closed = True
            self._warm_gen += 1
            self._warm_inflight = False

    def stats(self) -> dict:
        """The tick counters: ``jit_ticks`` counts ticks of the device
        step, ``fallback_ticks`` those of the host-stream fallback,
        ``host_syncs`` the host waits they made; with a builder, the
        breaker's ``info()`` and the builder's."""
        out = dict(self.tick_stats)
        if self.breaker is not None:
            out["breaker"] = self.breaker.info()
        if self.plan_builder is not None:
            out["builder"] = self.plan_builder.info()
        return out

    def sparse_ready(self) -> bool:
        """True once ticks run the device step."""
        return self._sparse_ready.is_set()

    def wait_sparse(self, timeout: float | None = None) -> bool:
        """Block until the background warm lands (tests, benchmarks)."""
        return self._sparse_ready.wait(timeout)

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
            # in the cache's dtype (f32), as the reference casts a bf16
            # memory's projections
            for name, w in (("xk", "wk"), ("xv", "wv")):
                self.cache[key][name] = torch.stack(
                    [dense(p[w], aux).reshape(shape) for p in reps]).to(
                        self.cache[key][name].dtype)

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

    def _upload(self, toks):
        """``toks`` and the slots' ``cur_len`` on the device, through the
        pinned buffers (no wait)."""
        self._toks.copy_(torch.from_numpy(toks))
        self._lens.copy_(torch.from_numpy(self.cur_len))
        return (self._toks.to(self.device, non_blocking=True),
                self._lens.to(self.device, non_blocking=True))

    def _decode(self, toks):
        """One device step on ``toks`` at the slots' ``cur_len``; returns
        the host copy of its logits [max_batch, vocab] (the tick's one
        host sync)."""
        token, cur = self._upload(toks)
        logits, self.cache = decode_step(self.params, self.cfg, token,
                                         self.cache, cur,
                                         sparse_ffn=self.sparse_ffn)
        self.tick_stats["jit_ticks"] += 1
        out = logits[:, 0, :self.cfg.vocab].cpu().numpy()
        self.tick_stats["host_syncs"] += 1
        return np.asarray(out, np.float32)

    def _decode_fallback(self, toks):
        """The fallback tick: :meth:`_decode` with the overlay FFNs on the
        host product stream (``decode_step_loop(..., sparse_host=True)``),
        which needs no device plan."""
        token, cur = self._upload(toks)
        logits, self.cache = decode_step_loop(
            self.params, self.cfg, token, self.cache, cur,
            sparse_ffn=self.sparse_ffn, sparse_host=True)
        self.tick_stats["fallback_ticks"] += 1
        out = logits[:, 0, :self.cfg.vocab].cpu().numpy()
        self.tick_stats["host_syncs"] += self._fallback_syncs
        return np.asarray(out, np.float32)

    def step(self):
        """One engine tick: admit, decode, sample, retire."""
        if self.breaker is not None:
            self._maybe_rewarm()
            self.tick_stats["health"] = str(self.breaker.health)
        self._admit()
        if all(s is None for s in self.slots):
            return False
        for b, req in enumerate(self.slots):
            if req is not None and self.cur_len[b] >= self.cache_len:
                raise AssertionError(
                    f"slot {b} would write past its KV cache "
                    f"(cur_len={self.cur_len[b]}, cache_len="
                    f"{self.cache_len}); submit() bounds were bypassed")
        toks = self._next_tokens()
        if self._sparse_ready.is_set():
            logits = self._decode(toks)
        else:
            # the background warm is still in flight: a host-stream tick,
            # which never waits on the plan build
            logits = self._decode_fallback(toks)
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
