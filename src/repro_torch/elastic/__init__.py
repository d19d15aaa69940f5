"""Elastic data parallelism: DP width as a runtime variable, PyTorch port
of ``src/repro/elastic/``.

``reshard`` re-chunks worker-stacked 0/1 Adam state (EF residuals,
server chunks, anchors, accumulated updates) from n workers to m as a
pure index remap over the comm-view layouts — bitwise the identity at
m = n, mass-conserving residual folds at m != n. ``FleetSim`` drives
kill / shrink / rejoin / grow schedules over the sim trainer, and
``restore_resharded`` loads an n-worker checkpoint into an m-worker
trainer. See reshard.py's module docstring for the carry-vs-reset
policy table.
"""
from repro_torch.elastic.checkpoint import restore_resharded
from repro_torch.elastic.reshard import (reshard, reshard_report,
                                         reshard_trainer, resize_opt,
                                         worker_origin)
from repro_torch.elastic.simulate import FleetSim, ResizeEvent, parity_gap

__all__ = [
    "FleetSim", "ResizeEvent", "parity_gap", "reshard", "reshard_report",
    "reshard_trainer", "resize_opt", "restore_resharded", "worker_origin",
]
