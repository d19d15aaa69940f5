"""Checks of the port's communication and source tree, PyTorch port of
``src/repro/analysis``.

Two independent passes:

* :mod:`repro_torch.analysis.ir_audit` — records the collectives real
  train steps issue (``RecordingComm``) and verifies their schedule, wire
  bytes and dtypes against the declared contract
  (``bucketing.expected_*_schedule``, ``codec.wire_bytes`` /
  ``codec.payload_spec``, ``comm_accounting``);
* :mod:`repro_torch.analysis.lints` — stdlib-only AST rules of repo
  invariants (no raw ``torch.distributed`` collectives outside
  ``core/comm.py``, no hand-rolled comm-view reshapes, no f64 literals).
"""
from repro_torch.analysis.ir_audit import (AuditReport, RecordingComm,
                                           Violation, audit_trainer,
                                           build_manifests, check_dtypes,
                                           check_schedule, check_wire_bytes,
                                           concretize_manifest,
                                           trace_collectives, watch)
from repro_torch.analysis.lints import run_lints

__all__ = [
    "AuditReport",
    "RecordingComm",
    "Violation",
    "audit_trainer",
    "build_manifests",
    "check_dtypes",
    "check_schedule",
    "check_wire_bytes",
    "concretize_manifest",
    "trace_collectives",
    "watch",
    "run_lints",
]
