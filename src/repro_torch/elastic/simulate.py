"""FleetSim: elastic training with in-run resizes over the sim trainer,
PyTorch port of ``src/repro/elastic/simulate.py``.

Drives the sim trainer through a schedule of :class:`ResizeEvent`\\ s —
kill a worker and shrink, continue, rejoin and grow — rebuilding the
Trainer on ``SimComm(m)`` at each new width and routing (params, state)
through :func:`repro_torch.elastic.reshard_trainer`. The loss curve, the
per-step records of ``Trainer.step`` (times per part, with the width)
and the per-resize geometry and latency come back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.comm import SimComm
from repro_torch.data.synthetic import DataConfig, SyntheticLM, add_model_inputs
from repro_torch.elastic.reshard import reshard_report, reshard_trainer
from repro_torch.train.step import (Trainer, TrainerConfig, resolve_device,
                                    step_record)

__all__ = ["ResizeEvent", "FleetSim", "parity_gap"]


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """Resize the fleet to ``workers`` before running step ``step``.

    ``survivors`` lists the source workers that keep a slot (in
    destination-slot order); None keeps the first ``min(n, m)``. A kill
    is expressed by omitting the dead worker from ``survivors``.
    """

    step: int
    workers: int
    survivors: Optional[Tuple[int, ...]] = None


class FleetSim:
    """Elastic sim-mode training loop with in-run DP resizes, on
    ``device`` (CUDA unless the caller asks for the CPU, as ``Trainer``)."""

    def __init__(self, model_cfg, opt_cfg, n_workers: int, *,
                 trainer_cfg: Optional[TrainerConfig] = None, seed: int = 0,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.n0 = n_workers
        self.tc = trainer_cfg or TrainerConfig()
        self.seed = seed
        self.device = resolve_device(device)

    def _trainer(self, n: int) -> Trainer:
        return Trainer(self.model_cfg, self.opt_cfg, comm=SimComm(n),
                       trainer_cfg=self.tc, device=self.device)

    def run(self, steps: int, *, global_batch: int = 8, seq: int = 16,
            events: Sequence[ResizeEvent] = ()) -> dict:
        """``steps`` steps from ``seed``'s init with the resizes of
        ``events``. Returns ``losses`` (the fleet's mean loss per step),
        ``records`` (one per step: :func:`~repro_torch.train.step.step_record`
        plus ``workers``), ``resizes`` (:func:`reshard_report` plus
        ``step`` and ``reshard_ms``, the host time of the reshard between
        two device synchronizations), and the final ``params``, ``state``
        and ``trainer``."""
        ev_by_step = {}
        for ev in events:
            if not 0 <= ev.step < steps:
                raise ValueError(f"resize at step {ev.step} is outside the "
                                 f"{steps}-step run")
            if ev.step in ev_by_step:
                raise ValueError(f"two resizes scheduled at step {ev.step}")
            ev_by_step[ev.step] = ev
        for w in [self.n0] + [ev.workers for ev in events]:
            if global_batch % w:
                raise ValueError(
                    f"global_batch={global_batch} must divide over every "
                    f"fleet width in the schedule (got width {w})")

        tr = self._trainer(self.n0)
        params, state = tr.init(self.seed)
        data = SyntheticLM(DataConfig(vocab=self.model_cfg.vocab,
                                      seq_len=seq, global_batch=global_batch,
                                      seed=self.seed), device=self.device)
        losses, records, resizes = [], [], []
        for t in range(steps):
            ev = ev_by_step.get(t)
            if ev is not None:
                dst = self._trainer(ev.workers)
                rep = reshard_report(tr.opt, dst.opt, survivors=ev.survivors)
                tr._sync()
                t0 = time.perf_counter()
                params, state = reshard_trainer(tr, dst, params, state,
                                                survivors=ev.survivors)
                dst._sync()
                rep["step"] = t
                rep["reshard_ms"] = (time.perf_counter() - t0) * 1e3
                resizes.append(rep)
                tr = dst
            batch = add_model_inputs(data.batch(t), self.model_cfg,
                                     self.device)
            params, state, met = tr.step(params, state, batch)
            losses.append(float(met["loss"]))
            records.append({**step_record(t, met), "workers": tr.n_workers})
        return {"losses": losses, "records": records, "resizes": resizes,
                "params": params, "state": state, "trainer": tr}


def parity_gap(losses: Sequence[float], baseline: Sequence[float],
               tail: int = 10) -> float:
    """One-sided final-loss gap (nats, avg of the last ``tail`` steps) of
    an interrupted run vs its uninterrupted baseline."""
    k = min(tail, len(losses), len(baseline))
    return (float(np.mean(np.asarray(losses[-k:])))
            - float(np.mean(np.asarray(baseline[-k:]))))
