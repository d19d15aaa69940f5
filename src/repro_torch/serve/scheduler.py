"""Continuous batching over the serve engine, PyTorch port of
``src/repro/serve/scheduler.py``: slot scheduler + weight swap.

A FIFO request queue feeds a fixed set of batch *slots*; each tick swaps
in pending weights, admits queued requests into free slots
(prefill-on-admit), decodes one token for every slot in one batched step
with per-slot positions, and evicts slots whose requests completed. The
reference gets per-slot positions by ``vmap`` over ``decode``; here one
batched ``decode`` takes a (slots,) position tensor, each row written
and masked at its own position. Inside the reference's ``vmap`` a MoE
layer routes each slot's one token alone (its own expert capacity,
``max(1, ceil(cf * top_k / E))``); the port's batched decode routes the
slots as as many groups (``decode(groups=slots)``), so no slot's token
is dropped for another's, and the tokens are the reference's.

Weight refresh: a :class:`~repro_torch.serve.publish.Subscriber` with a
pending update is applied at the tick boundary, never mid-decode.

Prefill runs per request at its exact prompt length (``prefill`` returns
only the last position's logits), straight into the slot's lane of the
cache after zeroing it: the same bits as the reference's batch-1 prefill
cache copied over the whole lane, with no residue from the previous
tenant and no second cache. Every cache write is in place.

KV-cache quantization (``kv_quant="qint8"``): each page of ``kv_page``
positions of a slot is quantized in place exactly once, when it fills
(max-abs scale per page, qint8 codes by the wire codec's hash-dither
stochastic rounding), so the storage error stays within one step. It
applies to the seq-indexed cache leaves (``shape[2] == max_seq``), as in
the reference: MLA's latent ``ckv`` and rope key ``kr`` are paged, the
split window cache's rings stay full precision.

Caches are nested dicts ({"k", "v"}, gemma3's split window cache
{"local": ..., "global": ...}, or the state-space family's {"ssm": ...,
"shared": ...}); every leaf carries the slots at axis 1. The reference's
Scheduler cannot take the split cache (its prefill refuses it); the
port's prefills into it.

The state-space family (mamba2, zamba2): a slot's lane holds each
layer's SSM state and conv windows, and for zamba2 the shared block's
KV slots; prefill scans the prompt in chunks of ``cfg.ssm_chunk``, so
:meth:`Scheduler.submit` refuses a prompt whose length is not a multiple
of it (the reference fails there too, at its prefill's assertion).
``quant_page`` picks leaves by ``shape[2] == max_seq`` as the reference
does: when ``max_seq`` equals ``cfg.ssm_heads`` the SSM's ``h`` (L, B,
H, P, N) is quantized too, one page of heads at a time. That quirk of
the reference is kept, not repaired (ROADMAP section 3).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.codecs import _hash_dither  # the wire codec's dither
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Server

# as XLA compiles the reference's ``max|z| / 127.0`` (jax 0.9.0, CPU): a
# multiply by the f32 reciprocal, as for the qint codec's ``/ qmax``
_INV_127 = float(np.float32(1.0 / 127.0))


@dataclasses.dataclass
class Request:
    """One generation request: prompt token ids + a new-token budget.

    ``output`` accumulates generated ids (greedy argmax over the real
    vocab); ``done`` flips when ``max_new_tokens`` ids are out or
    ``eos_id`` is produced.
    """

    rid: Any
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid!r}: max_new_tokens must be >= 1")


def cache_leaves(cache):
    """The tensors of a (nested) cache dict, in key order."""
    for _, x in sorted(cache.items()):
        yield from cache_leaves(x) if isinstance(x, dict) else (x,)


def quant_page(cache, slot: int, start: int, page: int, max_seq: int):
    """Quantize positions ``[start, start + page)`` of ``slot``'s lane of
    every seq-indexed float cache leaf (``shape[2] == max_seq``) in
    place: one max-abs scale over the page, ``q = clip(floor(z / s +
    dither(z)), -127, 127)``, stored as ``q * s`` in the leaf's dtype."""
    for x in cache_leaves(cache):
        if not (x.dim() >= 3 and x.shape[2] == max_seq
                and x.dtype.is_floating_point):
            continue
        pg = x[:, slot, start:start + page]
        z = pg.to(torch.float32)
        s = z.abs().amax() * _INV_127
        q = torch.clamp(torch.floor(
            z / torch.where(s > 0, s, torch.ones_like(s))
            + _hash_dither(z)), -127.0, 127.0)
        pg.copy_((q * s).to(x.dtype))
    return cache


class Scheduler:
    """Slot-based continuous batcher over a :class:`Server`.

    ``server.batch`` fixes the slot count and ``server.max_seq`` the cache
    extent; a request needs ``len(prompt) + max_new_tokens <= max_seq``.
    Encoder-decoder configs are refused, as in the reference (decode would
    need each slot's encoder output, which the scheduler does not carry);
    the vlm is served from tokens alone, each slot decoding at its own
    M-RoPE positions.
    """

    def __init__(self, server: Server, params, *,
                 subscriber=None, kv_quant: Optional[str] = None,
                 kv_page: int = 64):
        if server.cfg.enc_layers:
            raise ValueError("Scheduler does not serve encoder-decoder "
                             "configs (per-slot enc_out not supported)")
        if kv_quant not in (None, "qint8"):
            raise ValueError(f"kv_quant must be None or 'qint8', "
                             f"got {kv_quant!r}")
        if kv_quant and (kv_page < 1 or server.max_seq % kv_page != 0):
            raise ValueError(
                f"kv_page must divide max_seq ({server.max_seq}), "
                f"got {kv_page}")
        self.server = server
        self.cfg = server.cfg
        self.device = server.device
        self.params = params
        self.subscriber = subscriber
        self.n_slots = server.batch
        self.max_seq = server.max_seq
        self.kv_quant = kv_quant
        self.kv_page = kv_page
        self.cache = T.init_cache(self.cfg, self.n_slots, self.max_seq,
                                  server.cache_dtype, device=self.device)
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        self._pos = np.zeros(self.n_slots, np.int32)
        self._last_tok = np.zeros(self.n_slots, np.int32)
        self._pages_done = np.zeros(self.n_slots, np.int32)
        self.queue: Deque[Request] = deque()
        self.stats: Dict[str, int] = {
            "prefills": 0, "decode_ticks": 0, "generated": 0,
            "weight_swaps": 0, "pages_quantized": 0}
        self._prefill = server.prefill_fn()
        self._decode = server.decode_fn()
        # a list here collects each decode tick's MoE layers' metrics
        self.moe_stats: Optional[List[Dict]] = None

    # ------------------------------------------------------------------ #
    def _prefill_one(self, params, tokens, slot: int) -> int:
        """Zero the slot's lane and prefill ``tokens`` (1, L) into it;
        returns the greedy first token."""
        def lane_of(c):
            if isinstance(c, dict):
                return {k: lane_of(v) for k, v in c.items()}
            return c[:, slot:slot + 1].zero_()

        lane = lane_of(self.cache)
        logits, _ = self._prefill(params, {"tokens": tokens}, lane)
        return int(torch.argmax(logits[0, -1, :self.cfg.vocab]))

    def _decode_tick(self, params, tokens, pos):
        """One batched decode of every slot, each at its own position and
        (a MoE model) routed alone; returns the greedy tokens (slots,) on
        the host."""
        logits, _ = self._decode(params, self.cache, tokens[:, None], pos,
                                 groups=self.n_slots,
                                 moe_stats=self.moe_stats)
        return torch.argmax(logits[:, 0, :self.cfg.vocab], dim=-1).cpu()

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> Request:
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid!r}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds max_seq "
                f"({self.max_seq})")
        chunk = self.cfg.ssm_chunk
        if self.cfg.family in ("ssm", "hybrid") and len(req.prompt) % chunk:
            raise ValueError(
                f"request {req.rid!r}: prompt length {len(req.prompt)} is "
                f"not a multiple of {self.cfg.name}'s ssm_chunk ({chunk}); "
                f"the chunked scan of its prefill needs one")
        self.queue.append(req)
        return req

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and self.active == 0

    # ------------------------------------------------------------------ #
    def _maybe_swap_weights(self):
        sub = self.subscriber
        if sub is not None and sub.has_pending():
            self.params = sub.apply_pending()
            self.stats["weight_swaps"] += 1

    def _finish(self, slot: int, tok: int) -> bool:
        """Record token ``tok`` for the slot's request; evict if done."""
        req = self.slots[slot]
        req.output.append(tok)
        self.stats["generated"] += 1
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            req.done = True
            self.slots[slot] = None
            self._pos[slot] = 0
            self._last_tok[slot] = 0
            return True
        self._last_tok[slot] = tok
        return False

    def _quantize_filled_pages(self, slot: int):
        if not self.kv_quant:
            return
        filled = int(self._pos[slot]) // self.kv_page
        while int(self._pages_done[slot]) < filled:
            quant_page(self.cache, slot,
                       int(self._pages_done[slot]) * self.kv_page,
                       self.kv_page, self.max_seq)
            self._pages_done[slot] += 1
            self.stats["pages_quantized"] += 1

    def _admit(self):
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.tensor([list(req.prompt)], dtype=torch.long,
                                  device=self.device)
            tok0 = self._prefill_one(self.params, prompt, slot)
            self.stats["prefills"] += 1
            self.slots[slot] = req
            self._pos[slot] = prompt.shape[1]
            self._pages_done[slot] = 0
            if not self._finish(slot, tok0):
                self._quantize_filled_pages(slot)

    # ------------------------------------------------------------------ #
    def tick(self) -> int:
        """One scheduler step: swap weights, admit, batched decode, evict.

        Returns the number of tokens generated this tick.
        """
        self._maybe_swap_weights()
        self._admit()
        active = [i for i in range(self.n_slots)
                  if self.slots[i] is not None]
        if not active:
            return 0
        toks = self._decode_tick(
            self.params,
            torch.as_tensor(self._last_tok, dtype=torch.long,
                            device=self.device),
            torch.as_tensor(self._pos, device=self.device)).numpy()
        self.stats["decode_ticks"] += 1
        produced = 0
        for i in active:
            self._pos[i] += 1
            if not self._finish(i, int(toks[i])):
                self._quantize_filled_pages(i)
            produced += 1
        return produced

    def run(self, requests: Optional[Sequence[Request]] = None,
            max_ticks: int = 100_000) -> List[Request]:
        """Submit ``requests`` (if given) and tick until the queue drains."""
        reqs = list(requests) if requests is not None else []
        for r in reqs:
            self.submit(r)
        for _ in range(max_ticks):
            if self.idle:
                break
            self.tick()
        if not self.idle:
            raise RuntimeError(f"scheduler did not drain in "
                               f"{max_ticks} ticks")
        return reqs
