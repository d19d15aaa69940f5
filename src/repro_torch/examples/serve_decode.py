"""Continuous-batching serving: admit a handful of requests into the slot
scheduler, decode them to completion, and absorb a live codec-compressed
weight refresh mid-stream (the training->serving loop of serve/publish.py
+ serve/scheduler.py).

The port of the reference's ``examples/serve_decode.py``.
``REPRO_EXAMPLE_STEPS`` caps the per-request new-token budget so CI can
smoke this in seconds (the default exercises slot reuse: more requests
than slots, staggered lengths).

    python -m repro_torch.examples.serve_decode              # the card
    python -m repro_torch.examples.serve_decode --device cpu
"""
import time

import torch

from repro_torch import interop
from repro_torch.configs.base import get
from repro_torch.examples import example_steps, parse_args
from repro_torch.serve import (Publisher, PublishConfig, Request, Scheduler,
                               Server, Subscriber)

SLOTS, REQUESTS, PROMPT, MAXSEQ = 3, 5, 10, 64
SWAP_TICK = 2       # the tick at whose start the refreshed weights land


def prompts(vocab: int):
    """Request i's prompt: PROMPT + i token ids, seeded (the reference
    draws its own from jax's threefry)."""
    g = torch.Generator().manual_seed(1)
    return [torch.randint(0, vocab, (PROMPT + i,), generator=g).tolist()
            for i in range(REQUESTS)]


def main(device="cuda", params=None):
    """Serve REQUESTS requests of ``REPRO_EXAMPLE_STEPS`` (12) new tokens
    each over SLOTS slots on ``device``, from the port's seeded init or
    from ``params`` (an unstacked tree of arrays or tensors, the
    reference's through :mod:`repro_torch.interop`), with a qint8 delta
    of the weights times 1.001 published before tick SWAP_TICK; returns
    the requests, the scheduler's stats, the new tokens each request had
    before the swap, and the served weights after it."""
    gen = example_steps(12)
    cfg = get("chatglm3-6b").smoke
    srv = Server(cfg, batch=SLOTS, max_seq=MAXSEQ, cache_dtype=torch.float32,
                 device=device)
    params = (srv.init_params(0) if params is None
              else interop.params_from_reference(params, srv.device))

    # trainer-side publisher + replica-side subscriber: the scheduler swaps
    # weights at a tick boundary whenever a fresh payload is pending
    pc = PublishConfig(codec="qint8", bucket_mb=4.0)
    pub, sub = Publisher(params, pc), Subscriber(params, pc)
    sub.push(pub.publish(params, step=0))          # initial full snapshot
    sch = Scheduler(srv, params, subscriber=sub)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=gen)
            for i, p in enumerate(prompts(cfg.vocab))]
    for r in reqs:
        sch.submit(r)

    t0 = time.time()
    ticks, before_swap = 0, None
    while not sch.idle:
        if ticks == SWAP_TICK:   # a fine-tuning step lands mid-serve
            tuned = _scaled(params, 1.0 + 1e-3)
            sub.push(pub.publish(tuned, step=1))
            before_swap = [len(r.output) for r in reqs]
        sch.tick()
        ticks += 1
    dt = time.time() - t0

    for r in reqs:
        print(f"req {r.rid} (prompt {len(r.prompt)}): {r.output}")
    s = sch.stats
    print(f"{s['generated']} tokens over {SLOTS} slots in {dt:.2f}s "
          f"({s['generated'] / dt:.1f} tok/s, {srv.device.type}); "
          f"{s['prefills']} prefills, {s['decode_ticks']} decode ticks, "
          f"{s['weight_swaps']} live weight swap(s)")
    assert all(r.done and len(r.output) == gen for r in reqs)
    assert s["weight_swaps"] >= 1
    return {"requests": reqs, "stats": s, "before_swap": before_swap,
            "served_params": sch.params}


def _scaled(tree, c):
    if isinstance(tree, dict):
        return {k: _scaled(v, c) for k, v in tree.items()}
    return tree * c


def cli(argv=None):
    main(parse_args(__doc__, argv).device)


if __name__ == "__main__":
    cli()
