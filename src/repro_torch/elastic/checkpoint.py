"""Width-agnostic checkpoint restore: n-worker files into m-worker
trainers, routed through :func:`repro_torch.elastic.reshard`, PyTorch
port of ``src/repro/elastic/checkpoint.py``.

``checkpointing.io.restore`` stays strict — it validates the manifest
against the caller's tree and refuses any mismatch. This module sits on
top: it reads the manifest's recorded fleet width, rebuilds the *source*
trainer at that width, restores into its layout (``Trainer.restore``,
whose ``like`` tree lives on the ``meta`` device), and reshards the
result into the destination trainer's width.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.checkpointing import io as ckpt_io
from repro_torch.core.comm import SimComm
from repro_torch.elastic.reshard import reshard_trainer
from repro_torch.train.step import Trainer

__all__ = ["restore_resharded"]


def restore_resharded(path: str, trainer: Trainer, *,
                      survivors: Optional[Sequence[int]] = None,
                      src_workers: Optional[int] = None):
    """Restore a checkpoint saved at any DP width into ``trainer`` (sim
    layout), on the trainer's device; either package's file.

    The source width comes from the manifest's ``meta["n_workers"]``
    (written by ``launch/train.py --save``) or the ``src_workers``
    override. Returns ``(params, state, step, meta)`` in the trainer's
    width.
    """
    manifest = ckpt_io.read_manifest(path)
    n = src_workers or (manifest.get("meta") or {}).get("n_workers")
    if not n:
        raise ValueError(
            f"checkpoint {path!r} does not record its fleet width "
            f"(meta['n_workers']); pass src_workers= explicitly")
    n = int(n)
    if n == trainer.n_workers:
        return trainer.restore(path)
    src_tr = Trainer(trainer.model_cfg, trainer.opt_cfg, comm=SimComm(n),
                     trainer_cfg=trainer.trainer_cfg, device=trainer.device)
    params, state, step, meta = src_tr.restore(path)
    params, state = reshard_trainer(src_tr, trainer, params, state,
                                    survivors=survivors)
    return params, state, step, meta
