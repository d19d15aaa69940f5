"""Paper Fig. 2 + Fig. 4 in miniature: the uncompressed Adam baseline vs
the compressed pipelines (1-bit Adam, 0/1 Adam, 0/1 LAMB) on identical
data — sample-wise convergence parity + communication volume.

The port of the reference's ``examples/compare_optimizers.py``. Each
series is one composition of the same combinator: a *base step*
(``adam_base`` / ``lamb_base``) wrapped by ``compressed_dp`` with a sync
style — ``"mean"`` (full-precision every step), ``"gradient"`` (1-bit
two-stage), or ``"accumulate"`` (0/1 local steps). That is the entire
public optimizer API.

    python -m repro_torch.examples.compare_optimizers              # the card
    python -m repro_torch.examples.compare_optimizers --device cpu
"""
import numpy as np

from repro_torch import interop
from repro_torch.configs.base import get
from repro_torch.core import schedules as S
from repro_torch.core.base_steps import adam_base, lamb_base
from repro_torch.core.comm import SimComm
from repro_torch.core.compressed import comm_accounting, compressed_dp
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.examples import example_steps, parse_args
from repro_torch.train.step import Trainer

N_WORKERS = 4

LR = S.LinearWarmupExpDecay(peak_lr=2e-3, warmup_steps=10,
                            decay=0.97, decay_period=20)
VAR = S.AdaptiveFreezePolicy(kappa=4)
SYNC = S.LrProportionalSyncPolicy(warmup_steps=15, double_every=20,
                                  max_interval=4)

SERIES = {
    "adam": compressed_dp(adam_base(), style="mean", lr=LR),
    "one_bit_adam": compressed_dp(adam_base(), style="gradient", lr=LR,
                                  var_policy=S.FixedWarmupPolicy(15)),
    "zero_one_adam": compressed_dp(adam_base(), lr=LR, var_policy=VAR,
                                   sync_policy=SYNC),
    "zero_one_lamb": compressed_dp(lamb_base(), lr=LR, var_policy=VAR,
                                   sync_policy=SYNC),
}


def run(opt, steps, device, params=None):
    """``steps`` steps of ``opt``: (each step's loss, the workers' mean as
    the reference's sim step reports it; the bytes one worker sent; DP
    params; the accounting)."""
    tr = Trainer(get("gpt2").smoke, opt, comm=SimComm(N_WORKERS),
                 device=device)
    if params is None:
        params, state = tr.init(0)
    else:
        params = interop.params_from_reference(params, tr.device)
        state = tr.opt.init(params)
    data = SyntheticLM(DataConfig(vocab=64, seq_len=32, global_batch=8),
                       device=tr.device)
    acct = comm_accounting(tr.opt)
    losses, bytes_sent = [], 0.0
    for t in range(steps):
        params, state, met = tr.step(params, state, data.batch(t))
        losses.append(float(met["loss"]))
        # traffic model keyed on the transform's sync style, so any series
        # added to SERIES is accounted correctly
        if opt.style == "mean":
            bytes_sent += acct["fullprec_bytes_per_round"] / 2
        elif opt.style == "gradient":
            w = bool(met["var_round"])
            bytes_sent += (acct["fullprec_bytes_per_round"] if w
                           else acct["compressed_bytes_per_sync"]) / 2
        else:  # accumulate: compressed syncs + T_v full-precision rounds
            if bool(met["synced"]):
                bytes_sent += acct["compressed_bytes_per_sync"] / 2
            if bool(met["var_round"]):
                bytes_sent += acct["fullprec_bytes_per_round"] / 2
    return losses, bytes_sent, acct["dp_params"], acct


def main(device="cuda", params=None):
    """Each series for ``REPRO_EXAMPLE_STEPS`` (60) steps on ``device``,
    from the port's seeded init or from ``params`` (a stacked tree, as
    :func:`repro_torch.examples.quickstart.main` takes it); returns each
    series' row and accounting."""
    steps = example_steps(60)
    print(f"{'optimizer':16s} {'loss@0':>8s} {'loss@end':>9s} "
          f"{'MB sent/worker':>15s} {'bits/param/step':>16s}")
    out = {}
    for name, opt in SERIES.items():
        losses, b, d, acct = run(opt, steps, device, params)
        print(f"{name:16s} {losses[0]:8.4f} {np.mean(losses[-5:]):9.4f} "
              f"{b/2**20:15.2f} {8*b/d/steps:16.3f}")
        out[name] = {"losses": losses, "bytes_sent": b, "dp_params": d,
                     "accounting": acct}
    print("\nsame convergence, a fraction of the bits — the paper's claim, "
          "for every base the combinator wraps.")
    return out


def cli(argv=None):
    main(parse_args(__doc__, argv).device)


if __name__ == "__main__":
    cli()
