"""Training CLI, PyTorch port of ``src/repro/launch/train.py``.

Modes: ``single`` (the default, as in the reference) runs one worker;
``sim`` ``--workers`` simulated paper-workers stacked on one device;
``dist`` one worker per process, joined by ``torch.distributed``
(``repro_torch.launch.mesh``): NCCL between cards (one card per rank), gloo on the CPU, and gloo with
every rank on one card only when asked for (``--backend gloo --device
cuda:0``). Under torchrun the launcher's ranks are used; without it the
CLI spawns ``--workers`` ranks itself. Only rank 0 prints.
``--hierarchy INNER`` (every mode) runs the two-level exchange over pods
of INNER workers: bf16 inside a pod, 1-bit only across pods (0: flat;
single mode has one worker and no pods). ``--bucket-mb MB`` fuses the
per-leaf exchange into buckets of MB MiB of f32 elements
(``core.bucketing``); ``--save PATH`` writes the final params and
optimizer state as a checkpoint both packages read (sim and single mode).
``--resize STEP:M`` (sim mode, repeatable) resizes the fleet to M workers
before STEP through ``repro_torch.elastic.FleetSim``.

Precision, as in the reference, has no flag: a caller of
:func:`make_trainer`, :func:`rank_main` or :func:`rank_jobs` passes
``configure``, a function from the (model config, optimizer config)
pair to the pair to train with; :func:`production` is the reference's
production precision (bf16 parameters, compute and state, its
``launch/dryrun.py::default_opt_cfg``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --steps 8 --batch 8 --seq 32 --mode sim --workers 4 \\
      --sync-warmup 2 --double-every 2 --kappa 1 --log-every 1 \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-base \\
      --smoke --optimizer zero_one_sgd --scale-mode row [...as above]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --mode sim --optimizer one_bit_adam --onebit-warmup 2 [...]
      # the baselines: adam (bf16 mean every step), one_bit_adam
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-base \\
      --smoke --mode sim --optimizer zero_one_lamb [...]   # or one_bit_lamb,
      # lamb
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --mode sim --codec topk --codec-arg 0.01 [...]   # or qint8, qint4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch gpt2 --smoke --mode dist --device cpu [...as above]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --mode dist --workers 4 --micro-batches 2 --device cpu [...]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --mode sim --workers 4 --hierarchy 2 --device cpu [...]  # 2 pods x 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \
      --mode sim --workers 4 --bucket-mb 4 --save build/ck.npz \
      --device cpu [...]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --mode sim --workers 4 --resize 3:2 --resize 5:4 --device cpu [...]
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-v2-236b --smoke --mode sim --workers 4 \\
      --device cpu [...]   # or llama4-scout-17b-a16e: experts split
      # over the workers; FULL with --layers 2 and --mode dist on cards
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
      --smoke --mode sim --workers 4 --seq 32 --device cpu [...]
      # or zamba2-1.2b; --seq a multiple of the config's ssm_chunk
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch whisper-large-v3 --smoke --mode sim --workers 4 \
      --device cpu [...]   # or qwen2-vl-2b; zero frames / vision
      # embeddings in every batch; FULL with --layers 8: 8 + 8 layers
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import get
from repro_torch.core import schedules as S
from repro_torch.core.api import REGISTRY_NAMES, OptimizerConfig
from repro_torch.core.codecs import CODEC_NAMES
from repro_torch.core.comm import Hierarchy, NullComm, SimComm, norm_hierarchy
from repro_torch.core.compressed import comm_accounting
from repro_torch.core.leafwise import clone_tree
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        add_model_inputs)
from repro_torch.elastic import FleetSim, ResizeEvent
from repro_torch.kernels import build
from repro_torch.launch import mesh
from repro_torch.models.config import cut_layers
from repro_torch.train.step import (DIST_SAVE, Trainer, TrainerConfig,
                                    step_record)


def production(model_cfg, opt_cfg, store_anchor=True):
    """(model config, optimizer config) at the reference's production
    precision: bf16 parameters, compute and optimizer state, with or
    without the anchor. A ``configure`` of :func:`make_trainer` (bind
    ``store_anchor`` with ``functools.partial``: it pickles, as
    :func:`rank_jobs`' jobs must)."""
    bf16 = torch.bfloat16
    return (dataclasses.replace(model_cfg, param_dtype=bf16,
                                compute_dtype=bf16),
            dataclasses.replace(opt_cfg, state_dtype=bf16,
                                store_anchor=store_anchor))


def build_opt_cfg(args) -> OptimizerConfig:
    lr = S.LinearWarmupExpDecay(peak_lr=args.lr, warmup_steps=args.lr_warmup,
                                decay=0.99,
                                decay_period=max(args.steps // 20, 1))
    return OptimizerConfig(
        name=args.optimizer, lr=lr,
        var_policy=S.AdaptiveFreezePolicy(kappa=args.kappa),
        sync_policy=S.LrProportionalSyncPolicy(
            warmup_steps=args.sync_warmup, double_every=args.double_every,
            max_interval=args.max_interval),
        onebit_warmup=args.onebit_warmup,
        scale_mode=args.scale_mode, codec=args.codec,
        codec_arg=args.codec_arg,
        hierarchy=Hierarchy(args.hierarchy) if args.hierarchy else None,
        bucket_mb=args.bucket_mb)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--optimizer", default="zero_one_adam",
                    choices=list(REGISTRY_NAMES))
    ap.add_argument("--mode", default="single",
                    choices=["single", "sim", "dist"])
    ap.add_argument("--workers", type=int, default=4,
                    help="sim: simulated workers; dist: ranks the CLI "
                         "spawns when no launcher started it")
    ap.add_argument("--backend", default=None, choices=list(mesh.BACKENDS),
                    help="dist only: nccl (the default on cuda) or gloo "
                         "(the default on cpu)")
    ap.add_argument("--layers", type=int, default=None, metavar="L",
                    help="cut the config to L layers, widths unchanged "
                         "(a MoE model keeps its dense prefix: L must "
                         "exceed first_k_dense; an encoder-decoder keeps "
                         "L encoder and L decoder layers)")
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lr-warmup", type=int, default=20)
    ap.add_argument("--kappa", type=int, default=4)
    ap.add_argument("--sync-warmup", type=int, default=20)
    ap.add_argument("--double-every", type=int, default=50)
    ap.add_argument("--max-interval", type=int, default=16)
    ap.add_argument("--onebit-warmup", type=int, default=20,
                    help="one_bit_adam: steps of full-precision gradient "
                         "means before the 1-bit stage")
    ap.add_argument("--scale-mode", default="tensor",
                    choices=["tensor", "chunk", "row"])
    ap.add_argument("--codec", default="sign1bit",
                    choices=list(CODEC_NAMES),
                    help="wire format of the compressed EF exchange "
                         "(core.codecs); sign1bit is the paper's")
    ap.add_argument("--codec-arg", type=float, default=None,
                    help="parameter for parameterized codecs "
                         "(topk: density, default 0.01)")
    ap.add_argument("--hierarchy", type=int, default=0, metavar="INNER",
                    help="workers per pod for the two-level exchange: "
                         "reduce uncompressed (bf16) inside pods, 1-bit "
                         "only across pods; 0 = flat")
    ap.add_argument("--bucket-mb", type=float, default=None, metavar="MB",
                    help="fuse the per-leaf compressed exchange into flat "
                         "buckets of MB MiB of f32 elements each "
                         "(core.bucketing): one codec encode and one "
                         "collective pair per bucket instead of per leaf. "
                         "Default: per-leaf exchange")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--resize", action="append", default=None,
                    metavar="STEP:M",
                    help="sim mode only: resize the fleet to M workers "
                         "before running STEP (repeatable). Routes the run "
                         "through repro_torch.elastic.FleetSim — EF state "
                         "and anchors are resharded, not reset; the resize "
                         "is recorded in the run summary")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions of the "
                         "kernels); dist mode with gloo may name one card "
                         "(cuda:0) for all ranks")
    args = ap.parse_args(argv)
    if args.backend is not None and args.mode != "dist":
        ap.error("--backend applies to --mode dist only")
    if args.hierarchy < 0:
        ap.error("--hierarchy must be >= 0")
    return args


def make_trainer(args, device=None, comm=None, configure=None) -> Trainer:
    """The trainer of ``args.mode`` on ``device`` (default
    ``args.device``); in dist mode the process group must be up.
    ``comm``: the comm to run on instead of the mode's own (e.g. the
    mode's comm wrapped in ``analysis.RecordingComm``); ``configure``:
    (model config, optimizer config) -> the pair to train with (e.g.
    :func:`production`), or None."""
    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if args.layers is not None:
        if args.layers <= cfg.first_k_dense:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.first_k_dense} dense layers before its "
                             f"MoE layers; ask for more")
        cfg = cut_layers(cfg, args.layers)
    if comm is None:
        comm = (SimComm(args.workers) if args.mode == "sim" else
                NullComm() if args.mode == "single" else mesh.worker_comm())
    opt_cfg = build_opt_cfg(args)
    if configure is not None:
        cfg, opt_cfg = configure(cfg, opt_cfg)
    return Trainer(cfg, opt_cfg, comm=comm,
                   trainer_cfg=TrainerConfig(args.micro_batches),
                   device=args.device if device is None else device)


def print_header(args, tr: Trainer, acct) -> None:
    """The run's first lines: model, codec, workers; the buckets and the
    pods where the exchange has them."""
    cfg = tr.model_cfg
    layers = (f" layers={cfg.n_layers}+{cfg.enc_layers}(encoder)"
              if cfg.enc_layers else f" layers={cfg.n_layers}")
    print(f"arch={cfg.name}{layers} "
          f"params(dp)={acct['dp_params']/1e6:.2f}M "
          f"codec={acct['codec']} "
          f"bits/param/sync={acct['bits_per_param_sync']:.3f} "
          f"workers={tr.n_workers} mode={args.mode} "
          f"micro_batches={args.micro_batches} "
          f"optimizer={args.optimizer} device={tr.device}", flush=True)
    if args.bucket_mb:
        print(f"bucketed exchange: {int(acct['exchange_units'])} "
              f"buckets ({args.bucket_mb}MiB budget) over "
              f"{int(acct['dp_leaves'])} DP leaves -> "
              f"{int(acct['collectives_per_sync'])} collective "
              f"phases/sync", flush=True)
    if acct["n_inner"] > 1:
        print(f"hierarchy: {int(acct['n_outer'])} pods x "
              f"{int(acct['n_inner'])} workers/pod; sync bytes/worker "
              f"intra={acct['compressed_bytes_per_sync_inner']/2**20:.2f}"
              f"MiB inter="
              f"{acct['compressed_bytes_per_sync_outer']/2**20:.2f}MiB",
              flush=True)


def train(args, tr: Trainer, kind: str = "lm", keep_step: int = None,
          start=None) -> dict:
    """Run ``args.steps`` steps of ``tr`` from ``args.seed`` on the
    synthetic stream of ``kind`` (``lm`` next-token; ``mlm`` masked-LM).
    Prints on rank 0 (every process outside dist mode). Returns the final
    params and state, one record per step (this process's workers'
    losses, the step kind, and the times of :meth:`Trainer.step`, the
    step's being their sum) and, with ``keep_step``, copies of the params
    and state that step started from, and its batch (``kept``). ``start``: (params,
    state, step) to resume from, e.g. :meth:`Trainer.restore`'s, instead
    of the seed's init and step 0. With ``args.save`` the final params
    and state are written there, at step ``args.steps`` (``save_s``: the
    seconds that took)."""
    cfg, dev = tr.model_cfg, tr.device
    is_main = int(tr.comm.index()[0]) == 0
    acct = comm_accounting(tr.opt)
    if is_main:
        print_header(args, tr, acct)

    if args.save:
        tr.checkpoint_stacked()         # raises in dist mode, before a run
    if start is None:
        params, state = tr.init(args.seed)
        first = 0
    else:
        params, state, first = start
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed,
                                  kind=kind), device=dev)
    t_start = time.time()
    comp_bytes, rounds, records, kept = 0.0, 0, [], None
    for step in range(first, args.steps):
        # as the reference's CLI: zero frames / vision embeddings, and
        # next-token batches with every position in the loss
        batch = add_model_inputs(data.batch(step), cfg, dev)
        if step == keep_step:
            # copies: the step below updates params and state in place
            kept = (clone_tree(params), state.clone(), batch)
        params, state, met = tr.step(params, state, batch)
        rec = step_record(step, met)
        records.append(rec)
        if met["synced"]:
            comp_bytes += acct["compressed_bytes_per_sync"]
            rounds += 1
        if met["var_round"]:
            comp_bytes += acct["fullprec_bytes_per_round"]
            rounds += 1
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = tr.mean_loss(met)
            if is_main:
                ex = ("" if rec["exchange_ms"] is None else
                      f", exchange {rec['exchange_ms']:.1f}")
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(met['lr']):.2e} sync={met['synced']} "
                      f"var={met['var_round']} step {rec['step_ms']:.1f} ms "
                      f"(fwd/bwd {rec['fwd_bwd_ms']:.1f}, optimizer "
                      f"{rec['optimizer_ms']:.1f}{ex}) "
                      f"[{time.time()-t_start:.1f}s]", flush=True)
    bits_pp = 8 * comp_bytes / max(acct["dp_params"], 1) / max(args.steps, 1)
    if is_main:
        print(f"DONE: {args.steps} steps, {rounds} comm rounds, "
              f"avg {bits_pp:.3f} bits/param/step "
              f"({time.time()-t_start:.1f}s)", flush=True)
    save_s = None
    if args.save:
        t0 = time.perf_counter()
        tr.save(args.save, params, state, step=args.steps,
                meta={"arch": cfg.name, "n_workers": tr.n_workers})
        save_s = time.perf_counter() - t0
        print(f"saved checkpoint to {args.save}", flush=True)
    return {"params": params, "state": state, "records": records,
            "kept": kept, "save_s": save_s}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def rank_main(rank: int, argv, world_size: int, init_method: str,
              out_dir: str = None, with_state: bool = False,
              kind: str = "lm", audit: bool = False,
              configure=None) -> None:
    """Entry of one spawned rank of ``--mode dist``: join the group, train
    on the synthetic stream of ``kind`` (see :func:`train`), and with
    ``out_dir`` save this rank's results there as ``rank{rank}.pt``: the
    step records, the final params on the CPU (and the optimizer state
    with ``with_state``), the kernel launches of the run and the peak
    device memory. With ``audit`` the rank's comm records its collectives
    (``analysis.RecordingComm``) and the file also holds the rank's audit
    report (``audit``) and its recorded collectives (``recorded``).
    ``configure``: as :func:`make_trainer`'s."""
    args = parse_args(argv)
    dev = mesh.init_workers(args.backend, args.device, rank=rank,
                            world_size=world_size, local_rank=rank,
                            init_method=init_method)
    try:
        from repro_torch import analysis

        tr = make_trainer(args, device=dev, comm=(
            analysis.RecordingComm(mesh.worker_comm()) if audit else None),
            configure=configure)
        trace = analysis.watch(tr) if audit else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        build.launch_counts.clear()
        res = train(args, tr, kind=kind)
        launches = dict(build.launch_counts)
        if out_dir is None:
            return
        out = {"rank": rank, "device": str(dev),
               "backend": dist.get_backend(), "records": res["records"],
               "params": _to_cpu(res["params"]), "launches": launches,
               "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}
        if audit:
            report = analysis.audit_trainer(tr, trace=trace)
            out["audit"] = report.to_dict()
            out["recorded"] = [c.to_dict() for c in report.collectives]
        if with_state:
            st = res["state"]
            out["state"] = {"slots": _to_cpu(st.slots), "u": _to_cpu(st.u),
                            "err_w": _to_cpu(st.err_w),
                            "err_s": _to_cpu(st.err_s)}
        del res
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rank_jobs(rank: int, jobs, world_size: int) -> None:
    """Entry of one spawned rank that runs ``jobs`` one after another,
    each ``(argv, out_dir, with_state, kind, audit, configure)`` through
    :func:`rank_main` with a rendezvous of its own in ``out_dir`` (the
    process group is made and destroyed per job): the jobs share the
    process's start-up (the torch import, the first group's setup). A job
    of kind ``"serve"`` is expert-parallel serving, ``argv`` the serve
    CLI's flags (``launch.serve.serve_rank``; ``with_state``, ``audit``
    and ``configure`` unused)."""
    for argv, out_dir, with_state, kind, audit, configure in jobs:
        init = mesh.file_rendezvous(out_dir)
        if kind == "serve":
            from repro_torch.launch.serve import serve_rank

            serve_rank(rank, argv, world_size, init, out_dir)
        else:
            rank_main(rank, argv, world_size, init, out_dir, with_state,
                      kind, audit, configure)


def _parse_resizes(specs):
    events = []
    for s in specs:
        try:
            step, m = s.split(":")
            step, m = int(step), int(m)
        except ValueError:
            raise SystemExit(f"--resize expects STEP:M, got {s!r}")
        events.append((step, m))
    return sorted(events)


def _run_elastic(args, device=None) -> dict:
    """Sim-mode run with in-run DP resizes via
    :class:`repro_torch.elastic.FleetSim` (``args.resize``), on ``device``
    (default ``args.device``). Prints the reference's lines, with each
    step's width and times; with ``args.save`` writes the final params
    and state at the final width, ``meta`` recording the resizes.
    Returns FleetSim's result and ``save_s``."""
    events = [ResizeEvent(step=s, workers=m)
              for s, m in _parse_resizes(args.resize)]
    tr = make_trainer(args, device)
    print_header(args, tr, comm_accounting(tr.opt))
    fleet = FleetSim(tr.model_cfg, tr.opt_cfg, args.workers,
                     trainer_cfg=tr.trainer_cfg, seed=args.seed,
                     device=tr.device)
    t0 = time.time()
    res = fleet.run(args.steps, global_batch=args.batch, seq=args.seq,
                    events=events)
    for t, (loss, rec) in enumerate(zip(res["losses"], res["records"])):
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"step {t:5d} loss {loss:.4f} workers={rec['workers']} "
                  f"sync={rec['sync']} var={rec['var']} step "
                  f"{rec['step_ms']:.1f} ms (fwd/bwd {rec['fwd_bwd_ms']:.1f}"
                  f", optimizer {rec['optimizer_ms']:.1f}) "
                  f"[{time.time()-t0:.1f}s]", flush=True)
    print(f"DONE: {args.steps} steps with {len(res['resizes'])} "
          f"resize(s) ({time.time()-t0:.1f}s)")
    for r in res["resizes"]:
        print(f"  resize @ step {r['step']}: {r['n_from']} -> {r['n_to']} "
              f"workers ({r['carried_entities']} EF entities carried, "
              f"{r['dead_entities']} folded, fold={r['ef_fold']}) in "
              f"{r['reshard_ms']:.1f}ms", flush=True)
    res["save_s"] = None
    if args.save:
        final = res["trainer"]
        t1 = time.perf_counter()
        final.save(args.save, res["params"], res["state"], step=args.steps,
                   meta={"arch": final.model_cfg.name,
                         "n_workers": final.n_workers,
                         "resizes": [
                             {k: r[k] for k in ("step", "n_from", "n_to")}
                             for r in res["resizes"]]})
        res["save_s"] = time.perf_counter() - t1
        print(f"saved checkpoint to {args.save} (width {final.n_workers})",
              flush=True)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.resize:
        if args.mode != "sim":
            raise SystemExit("--resize needs --mode sim (the elastic "
                             "resharding path runs over the sim trainer)")
        _run_elastic(args)
    elif args.mode != "dist":
        train(args, make_trainer(args))
    elif mesh.launched():
        dev = mesh.init_workers(args.backend, args.device)
        try:
            train(args, make_trainer(args, device=dev))
        finally:
            dist.destroy_process_group()
    else:
        # no launcher: spawn the ranks here, checked before any starts
        if args.save:
            raise NotImplementedError(DIST_SAVE)
        mesh.check_backend(
            args.backend or mesh.default_backend(args.device), args.device,
            args.workers)
        if args.hierarchy:
            norm_hierarchy(Hierarchy(args.hierarchy), args.workers)
        with tempfile.TemporaryDirectory() as tmp:
            mesh.spawn(rank_main, args.workers,
                       (argv, args.workers, mesh.file_rendezvous(tmp)))


if __name__ == "__main__":
    main()
