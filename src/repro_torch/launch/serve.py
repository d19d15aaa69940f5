"""Serving driver CLI, PyTorch port of ``src/repro/launch/serve.py``:
continuous batching + live weight refresh.

Builds a :class:`~repro_torch.serve.Server` + :class:`~repro_torch.serve.
Scheduler` with an f32 cache, admits ``--requests`` synthetic prompts
and decodes them to completion. With ``--publish-every N`` a
trainer-side :class:`~repro_torch.serve.Publisher` pushes a
codec-compressed delta refresh of perturbed weights every N ticks and
the scheduler swaps weights at the tick boundary. Runs on the card
unless ``--device cpu`` is given. Prompts come from a numpy generator
seeded with ``--seed + 1``, the perturbations from a torch generator
seeded with ``--seed + 2``; parameters from the port's own init.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2 --smoke \\
      --slots 4 --requests 8 --gen 16 --codec qint8 --publish-every 8 \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2 \\
      --slots 8 --max-seq 1024 --requests 16 --prompt-len 512 --gen 128 \\
      --kv-quant qint8 --kv-page 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --smoke --prompt-len 16 --device cpu   # prompts: a multiple of the
                                             # config's ssm_chunk
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --smoke --kv-quant qint8 --kv-page 8 \
      --device cpu                           # MLA's latent cache, MoE

Expert-parallel serving runs one process per worker
(:func:`serve_rank`, spawned by ``launch.train.rank_jobs`` with a job of
kind ``"serve"``): each rank takes its ``--slots`` rows of the
``--requests`` prompts, its block of the experts, and exchanges the
MoE layers' dispatch buffers with the other ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get
from repro_torch.core.codecs import CODEC_NAMES
from repro_torch.launch import mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import cut_layers
from repro_torch.models.layers import init_params
from repro_torch.serve import (Publisher, PublishConfig, Request, Scheduler,
                               Server, Subscriber)
from repro_torch.train.step import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=None, metavar="L",
                    help="cut the config to L layers, widths unchanged (an "
                         "encoder-decoder: L of each stack)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent batch slots of the scheduler")
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16,
                    help="new tokens per request")
    ap.add_argument("--codec", default="qint8", choices=list(CODEC_NAMES),
                    help="publish wire codec")
    ap.add_argument("--bucket-mb", type=float, default=4.0)
    ap.add_argument("--publish-every", type=int, default=0,
                    help="push a delta weight refresh every N ticks "
                         "(0 = serve fixed weights)")
    ap.add_argument("--kv-quant", choices=["none", "qint8"],
                    default="none",
                    help="paged qint8 KV-cache storage quantization")
    ap.add_argument("--kv-page", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions of the "
                         "kernels)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class ServeRun:
    """What :func:`build` sets up from the flags."""

    args: Any
    cfg: Any
    device: torch.device
    params: dict
    server: Server
    scheduler: Scheduler
    requests: List[Request]
    publisher: Optional[Publisher] = None
    subscriber: Optional[Subscriber] = None


def config_of(args):
    """The model config the flags name: ``--arch``, ``--smoke``,
    ``--layers``."""
    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    return cfg if args.layers is None else cut_layers(cfg, args.layers)


def prompts_of(args, cfg):
    """The ``--requests`` prompts of ``--prompt-len`` tokens, from a
    numpy generator seeded with ``--seed + 1``."""
    rng = np.random.default_rng(args.seed + 1)
    return [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
            for _ in range(args.requests)]


def build(args) -> ServeRun:
    """The model, server, scheduler (with a publisher/subscriber pair when
    ``--publish-every`` is set, its first snapshot pushed) and the
    submitted requests of ``args``."""
    cfg = config_of(args)
    dev = resolve_device(args.device)
    params = init_params(T.model_template(cfg), args.seed, device=dev)
    srv = Server(cfg, batch=args.slots, max_seq=args.max_seq,
                 cache_dtype=torch.float32, device=dev)
    pub = sub = None
    if args.publish_every:
        pc = PublishConfig(codec=args.codec, bucket_mb=args.bucket_mb)
        pub, sub = Publisher(params, pc), Subscriber(params, pc)
        sub.push(pub.publish(params, step=0))
    sch = Scheduler(srv, params, subscriber=sub,
                    kv_quant=None if args.kv_quant == "none"
                    else args.kv_quant,
                    kv_page=args.kv_page)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=args.gen)
            for i, p in enumerate(prompts_of(args, cfg))]
    for r in reqs:
        sch.submit(r)
    return ServeRun(args=args, cfg=cfg, device=dev, params=params,
                    server=srv, scheduler=sch, requests=reqs,
                    publisher=pub, subscriber=sub)


def perturb(params, gen: torch.Generator, scale: float = 1e-3):
    """``params`` plus ``scale`` times standard normal noise from
    ``gen``, leaf by leaf in sorted-key order."""
    if isinstance(params, dict):
        return {k: perturb(params[k], gen, scale) for k in sorted(params)}
    return params + scale * torch.randn(params.shape, generator=gen,
                                        device=params.device,
                                        dtype=params.dtype)


def serve(run: ServeRun) -> dict:
    """Tick the scheduler until it drains, publishing perturbed weights
    every ``--publish-every`` ticks. Returns the wall seconds and one
    record per tick: host ms of the tick (each ends in a host read of the
    tokens), the prefills it admitted, whether it swapped weights, and
    the ms of the publish before it."""
    args, sch, pub, sub = run.args, run.scheduler, run.publisher, \
        run.subscriber
    gen = torch.Generator(device=run.device).manual_seed(args.seed + 2)
    p = run.params
    records = []
    t0 = time.perf_counter()
    ticks = 0
    while not sch.idle:
        rec = {"tick": ticks}
        if pub is not None and ticks and ticks % args.publish_every == 0:
            p = perturb(p, gen)
            t = time.perf_counter()
            sub.push(pub.publish(p, step=ticks))
            rec["publish_ms"] = (time.perf_counter() - t) * 1e3
        before = dict(sch.stats)
        t = time.perf_counter()
        sch.tick()
        rec["ms"] = (time.perf_counter() - t) * 1e3
        rec["prefills"] = sch.stats["prefills"] - before["prefills"]
        rec["swapped"] = sch.stats["weight_swaps"] > before["weight_swaps"]
        records.append(rec)
        ticks += 1
    return {"seconds": time.perf_counter() - t0, "ticks": records}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve_rows(srv: Server, params, prompts, gen: int) -> dict:
    """Prefill the equal-length ``prompts`` as one batch of ``srv`` and
    decode ``gen`` greedy tokens at the positions after them, through
    ``prefill_fn`` / ``decode_fn`` (a MoE model's tokens routed over the
    whole batch, as the reference's engine routes them). Returns the
    logits over the real vocab (rows, gen + 1, vocab) and the greedy
    tokens (rows, gen + 1) on the CPU, the prefill's and each decode
    tick's host ms (each ends in a device sync), each tick's MoE dropped
    fraction (the mean over the MoE layers) and, with an expert-parallel
    comm, each tick's exchange ms (its collectives timed by CUDA events,
    or on the CPU by the host clock)."""
    cfg, dev = srv.cfg, srv.device
    V, P = cfg.vocab, len(prompts[0])
    cache = T.init_cache(cfg, len(prompts), P + gen, srv.cache_dtype, dev)
    prefill, decode = srv.prefill_fn(), srv.decode_fn()
    tokens = torch.tensor(prompts, dtype=torch.long, device=dev)
    if srv.comm is not None:
        srv.comm.ep_ms()
    _sync(dev)
    t0 = time.perf_counter()
    lg, cache = prefill(params, {"tokens": tokens}, cache)
    _sync(dev)
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "tick_ms": [],
           "ep_ms": [], "dropped_frac": []}
    if srv.comm is not None:
        out["prefill_ep_ms"] = srv.comm.ep_ms()
    logits = [lg[:, -1, :V].cpu()]
    for i in range(gen):
        tok = logits[-1].argmax(-1).to(dev)[:, None]
        stats = []
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, tok, P + i, moe_stats=stats)
        _sync(dev)
        out["tick_ms"].append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[:, 0, :V].cpu())
        if stats:
            out["dropped_frac"].append(float(torch.stack(
                [m["dropped_frac"] for m in stats]).mean()))
        if srv.comm is not None:
            out["ep_ms"].append(srv.comm.ep_ms())
    out["logits"] = torch.stack(logits, 1)
    out["tokens"] = out["logits"].argmax(-1)
    return out


def serve_rank(rank: int, argv, world_size: int, init_method: str,
               out_dir: str) -> None:
    """Entry of one spawned rank of expert-parallel serving: join the
    group (gloo on the CPU and where every rank shares one indexed card,
    ``--device cuda:0``; nccl with ``--device cuda``, a card a rank),
    build the ``Server`` over this process's comm with ``--slots`` rows
    (``--requests`` must be the world's rows) and its block of experts
    from ``--seed``'s init, and :func:`serve_rows` its rows, requests
    ``[rank * slots, (rank + 1) * slots)``, for ``--gen`` tokens. Saves
    the result, the EP degree, the device and its peak memory to
    ``rank{rank}.pt`` in ``out_dir``."""
    args = parse_args(argv)
    if args.requests != args.slots * world_size:
        raise ValueError(f"--requests {args.requests} must be --slots "
                         f"{args.slots} x {world_size} ranks")
    want = torch.device(args.device)
    backend = "nccl" if want.type == "cuda" and want.index is None \
        else "gloo"
    dev = mesh.init_workers(backend, args.device, rank=rank,
                            world_size=world_size, local_rank=rank,
                            init_method=init_method)
    try:
        cfg = config_of(args)
        srv = Server(cfg, comm=mesh.worker_comm(), batch=args.slots,
                     max_seq=args.prompt_len + args.gen,
                     cache_dtype=torch.float32, device=dev)
        params = srv.init_params(args.seed)
        rows = prompts_of(args, cfg)[rank * args.slots:
                                     (rank + 1) * args.slots]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out = serve_rows(srv, params, rows, args.gen)
        out.update(rank=rank, device=str(dev), backend=backend,
                   ep_degree=srv.ep_degree,
                   peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    run = build(args)
    out = serve(run)
    dt = out["seconds"]
    for r in run.requests:
        print(f"req {r.rid}: {len(r.output)} tokens  {r.output}")
    s = run.scheduler.stats
    print(f"# {args.requests} requests over {args.slots} slots: "
          f"{s['generated']} tokens in {dt:.2f}s "
          f"({s['generated'] / dt:.1f} tok/s), "
          f"{s['prefills']} prefills, {s['decode_ticks']} decode ticks, "
          f"{s['weight_swaps']} weight swap(s), "
          f"{s['pages_quantized']} KV page(s) quantized")


if __name__ == "__main__":
    main()
