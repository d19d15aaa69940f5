"""Quickstart: train a tiny LM with 0/1 Adam on 4 simulated workers.

The port of the reference's ``examples/quickstart.py``: the full paper
machinery runs here — adaptive variance freezing (T_v),
learning-rate-proportional local steps (T_u), error-feedback 1-bit
compressed sync — just at smoke scale. Built with the composable API: a
base step (``adam_base``) wrapped by the ``compressed_dp`` combinator;
swap the base for ``lamb_base()`` / ``momentum_sgd_base()`` to get
0/1-LAMB or 0/1-SGD with the identical sync machinery.
``--state-dtype`` keeps the optimizer state (m, v, u, the error
feedback) in bf16, or in fp16 as the paper does (f32 by default, as the
reference's example).

    python -m repro_torch.examples.quickstart                # the card
    python -m repro_torch.examples.quickstart --device cpu \
        --state-dtype float16
"""
import torch

from repro_torch import interop
from repro_torch.configs.base import get
from repro_torch.core import schedules as S
from repro_torch.core.base_steps import adam_base
from repro_torch.core.comm import SimComm
from repro_torch.core.compressed import (STATE_DTYPES, comm_accounting,
                                         compressed_dp)
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.examples import example_steps, parse_args
from repro_torch.train.step import Trainer

N_WORKERS = 4
# --state-dtype's choices: the optimizer's state dtypes by name
DTYPES_BY_NAME = {str(d).removeprefix("torch."): d for d in STATE_DTYPES}


def optimizer(state_dtype=torch.float32):
    return compressed_dp(
        adam_base(beta1=0.9, beta2=0.999),
        lr=S.LinearWarmupExpDecay(peak_lr=2e-3, warmup_steps=10,
                                  decay=0.97, decay_period=20),
        var_policy=S.AdaptiveFreezePolicy(kappa=4),
        sync_policy=S.LrProportionalSyncPolicy(warmup_steps=10,
                                               double_every=20,
                                               max_interval=4),
        state_dtype=state_dtype)


def main(device="cuda", params=None, state_dtype=torch.float32):
    """Train ``REPRO_EXAMPLE_STEPS`` (40) steps on ``device`` from the
    port's seeded init, or from ``params`` (a stacked tree, one row a
    worker, of arrays or tensors: the reference's draw comes across as
    it is, through :mod:`repro_torch.interop`); returns the accounting
    and each step's loss (the workers' mean, as the reference's
    sim step reports it) and flags."""
    steps = example_steps(40)
    cfg = get("gpt2").smoke
    trainer = Trainer(cfg, optimizer(state_dtype), comm=SimComm(N_WORKERS),
                      device=device)
    acct = comm_accounting(trainer.opt)
    header = (f"model={cfg.name}  DP params={acct['dp_params']/1e6:.2f}M  "
              f"compressed sync: {acct['bits_per_param_sync']/2:.2f} "
              f"bits/param one-way (vs 16 for bf16 AllReduce)")
    print(header)

    if params is None:
        params, state = trainer.init(0)
    else:
        params = interop.params_from_reference(params, trainer.device)
        state = trainer.opt.init(params)
    data = SyntheticLM(DataConfig(vocab=64, seq_len=32, global_batch=8),
                       device=trainer.device)
    losses, flags = [], []
    for t in range(steps):
        params, state, met = trainer.step(params, state, data.batch(t))
        losses.append(float(met["loss"]))
        flags.append((bool(met["synced"]), bool(met["var_round"])))
        if t % 5 == 0:
            print(f"step {t:3d}  loss {losses[-1]:.4f}  "
                  f"synced={flags[-1][0]}  var_refresh={flags[-1][1]}")
    print("done — loss decreasing under 1-bit compressed local-step "
          "training")
    return {"header": header, "accounting": acct, "losses": losses,
            "flags": flags, "params": params, "state": state}


def cli(argv=None):
    args = parse_args(__doc__, argv, **{"--state-dtype": dict(
        choices=list(DTYPES_BY_NAME), default="float32",
        help="the optimizer state's dtype (float32, as the reference)")})
    main(args.device, state_dtype=DTYPES_BY_NAME[args.state_dtype])


if __name__ == "__main__":
    cli()
