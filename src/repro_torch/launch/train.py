"""Training CLI, PyTorch port of the sim mode of
``src/repro/launch/train.py``: N simulated paper-workers on one GPU.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 --smoke \\
      --steps 8 --batch 8 --seq 32 --workers 4 --sync-warmup 2 \\
      --double-every 2 --kappa 1 --log-every 1 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-base \\
      --smoke --optimizer zero_one_sgd --scale-mode row [...as above]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get
from repro_torch.core import schedules as S
from repro_torch.core.api import REGISTRY_NAMES, OptimizerConfig
from repro_torch.core.compressed import comm_accounting
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.train.step import Trainer


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
        scale_mode=args.scale_mode, codec=args.codec)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--optimizer", default="zero_one_adam",
                    choices=list(REGISTRY_NAMES))
    ap.add_argument("--mode", default="sim", choices=["sim"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lr-warmup", type=int, default=20)
    ap.add_argument("--kappa", type=int, default=4)
    ap.add_argument("--sync-warmup", type=int, default=20)
    ap.add_argument("--double-every", type=int, default=50)
    ap.add_argument("--max-interval", type=int, default=16)
    ap.add_argument("--scale-mode", default="tensor",
                    choices=["tensor", "chunk", "row"])
    ap.add_argument("--codec", default="sign1bit",
                    choices=["sign1bit", "identity"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions of the "
                         "kernels)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    n = args.workers
    tr = Trainer(cfg, build_opt_cfg(args), n_workers=n, device=args.device)
    acct = comm_accounting(tr.opt)
    print(f"arch={cfg.name} params(dp)={acct['dp_params']/1e6:.2f}M "
          f"codec={acct['codec']} "
          f"bits/param/sync={acct['bits_per_param_sync']:.3f} "
          f"workers={n} optimizer={args.optimizer} device={tr.device}")

    params, state = tr.sim_init(args.seed)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed),
                       device=tr.device)
    t0 = time.time()
    comp_bytes, rounds = 0.0, 0
    for step in range(args.steps):
        batch = data.batch(step)
        if not cfg.causal:
            # as the reference's CLI: next-token batches with every
            # position in the loss
            batch["loss_mask"] = torch.ones((args.batch, args.seq),
                                            device=tr.device)
        params, state, met = tr.sim_step(params, state, batch)
        if met["synced"]:
            comp_bytes += acct["compressed_bytes_per_sync"]
            rounds += 1
        if met["var_round"]:
            comp_bytes += acct["fullprec_bytes_per_round"]
            rounds += 1
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(met['loss']):.4f} "
                  f"lr {float(met['lr']):.2e} sync={met['synced']} "
                  f"var={met['var_round']} [{time.time()-t0:.1f}s]")
    bits_pp = 8 * comp_bytes / max(acct["dp_params"], 1) / max(args.steps, 1)
    print(f"DONE: {args.steps} steps, {rounds} comm rounds, "
          f"avg {bits_pp:.3f} bits/param/step ({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
