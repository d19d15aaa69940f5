"""Communication-audit CLI, PyTorch port of ``src/repro/launch/audit.py``.

Builds a sim-mode trainer (``--workers`` simulated workers on one device)
for the requested config with a :class:`RecordingComm` around its comm,
runs 8 real steps, and runs :func:`repro_torch.analysis.audit_trainer`
over what they issued: collective schedule against the declared
manifests, payload and recorded bytes against ``codec.wire_bytes`` and
``comm_accounting``, inter-pod precision, f64 discipline; plus the static
frame pre-check of the CUDA kernels
(:func:`repro_torch.kernels.dispatch.frame_precheck`) on every exchange
unit.

    python -m repro_torch.launch.audit --config gpt2 --codec sign1bit \\
        --bucket-mb 4 --hierarchy 2 --json report.jsonl
    python -m repro_torch.launch.audit --matrix --lints [--device cpu]

Runs on the card unless ``--device cpu``. Exits non-zero and prints the
first violation on any failure.

The reference traces both branches of each round's ``cond`` without
running a step; the port records the rounds its steps run. Under the
reference's production schedule (sync warm-up of 12,500 steps, 1-bit
Adam's 16,000 full-precision steps) a few steps would never leave the
first round, so the audit runs the schedule of ``chip_smoke.py``'s phase
4 instead: ``--sync-warmup 2 --double-every 2 --kappa 1 --onebit-warmup
2``, under which 8 steps run every round a style declares (0/1 Adam:
sync + variance, sync alone, local-only; 1-bit Adam: full precision,
then 1-bit; the mean style: full precision every step).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.analysis import RecordingComm, audit_trainer
from repro_torch.analysis.lints import run_lints
from repro_torch.configs.base import get, list_archs
from repro_torch.core import bucketing as BK
from repro_torch.core.api import REGISTRY_NAMES
from repro_torch.core.codecs import CODEC_NAMES
from repro_torch.core.comm import SimComm
from repro_torch.data.synthetic import DataConfig, SyntheticLM, add_model_inputs
from repro_torch.kernels import dispatch as KD
from repro_torch.launch import train as launch
from repro_torch.train.step import Trainer, TrainerConfig

STEPS = 8
SCHEDULE = ["--sync-warmup", "2", "--double-every", "2", "--kappa", "1",
            "--onebit-warmup", "2"]
TP_NOT_PORTED = ("tensor parallelism (--tp) is not ported yet (ROADMAP "
                 "queue item 3); its audit entries wait for it")


def first_violation(report_dict) -> str:
    """One-line description of the first violation in an audit report
    dict."""
    vs = report_dict.get("violations") or []
    if not vs:
        return ""
    v = vs[0]
    more = f" (+{len(vs) - 1} more)" if len(vs) > 1 else ""
    return f"[{v['code']}] {v['message']}{more}"


def audit_one(arch: str, *, optimizer="zero_one_adam", codec="sign1bit",
              codec_arg=None, scale_mode="tensor", bucket_mb=None,
              hierarchy_inner: int = 0, workers: int = 4,
              micro_batches: int = 1, pack_order: str = "flat",
              tp: int = 0, smoke: bool = True, device="cuda",
              seq: int = 16, seed: int = 0):
    """Run the audit and the frame pre-check on one config: 8 steps at a
    global batch of one sequence of ``seq`` tokens per worker and
    micro-batch. Returns a JSON-able record."""
    if tp:
        raise NotImplementedError(TP_NOT_PORTED)
    batch = workers * micro_batches
    argv = ["--arch", arch, "--mode", "sim", "--workers", str(workers),
            "--steps", str(STEPS), "--batch", str(batch), "--seq", str(seq),
            "--optimizer", optimizer, "--codec", codec, "--scale-mode",
            scale_mode, "--hierarchy", str(hierarchy_inner),
            "--micro-batches", str(micro_batches), "--seed", str(seed),
            *SCHEDULE]
    argv += ["--smoke"] * smoke
    if codec_arg is not None:
        argv += ["--codec-arg", str(codec_arg)]
    if bucket_mb is not None:
        argv += ["--bucket-mb", str(bucket_mb)]
    args = launch.parse_args(argv)
    spec = get(arch)
    cfg = spec.smoke if smoke else spec.config
    ocfg = dataclasses.replace(launch.build_opt_cfg(args),
                               pack_order=pack_order)
    tr = Trainer(cfg, ocfg, comm=RecordingComm(SimComm(workers)),
                 trainer_cfg=TrainerConfig(micro_batches), device=device)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed),
                       device=tr.device)
    batches = []
    for t in range(STEPS):
        # as launch.train: zero frames / vision embeddings, next-token
        # batches with every position in the loss
        batches.append(add_model_inputs(data.batch(t), cfg, tr.device))
    params, state = tr.init(seed)
    rep = audit_trainer(tr, params, state, batches)
    del params, state, batches
    rec = rep.to_dict()
    rec["config"] = {
        "arch": cfg.name, "optimizer": optimizer, "codec": codec,
        "codec_arg": codec_arg, "scale_mode": scale_mode,
        "bucket_mb": bucket_mb, "hierarchy_inner": hierarchy_inner,
        "workers": workers, "micro_batches": micro_batches,
        "pack_order": pack_order, "tp": tp, "device": str(tr.device),
    }
    frames = []
    for lo, _, label in BK.exchange_units(tr.opt.plan, tr.opt.bucket_plan,
                                          pack_order):
        for issue in KD.frame_precheck(lo, stack=workers):
            frames.append(f"{label}: {issue}")
    rec["frame_issues"] = frames
    rec["ok"] = rec["ok"] and not frames
    return rec


def _matrix(workers: int):
    """The reference's smoke matrix without its two tensor-parallel
    entries: flat and two-level, per leaf and bucketed, every shipped
    codec, the other two styles, and gradient accumulation
    (micro_batches=2, flat packing and readiness order)."""
    for hierarchy_inner in (0, 2):
        for bucket_mb in (None, 4.0):
            yield dict(codec="sign1bit", hierarchy_inner=hierarchy_inner,
                       bucket_mb=bucket_mb, workers=workers)
    for codec in sorted(set(CODEC_NAMES) - {"sign1bit"}):
        yield dict(codec=codec, workers=workers)
    yield dict(optimizer="one_bit_adam", workers=workers)
    yield dict(optimizer="adam", workers=workers)
    yield dict(codec="sign1bit", bucket_mb=4.0, micro_batches=2,
               workers=workers)
    yield dict(codec="sign1bit", hierarchy_inner=2, bucket_mb=4.0,
               micro_batches=2, pack_order="reverse_backward",
               workers=workers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Communication audit of the train step's recorded "
                    "collectives")
    ap.add_argument("--config", "--arch", dest="arch", default="gpt2",
                    choices=list_archs())
    ap.add_argument("--optimizer", default="zero_one_adam",
                    choices=list(REGISTRY_NAMES))
    ap.add_argument("--codec", default="sign1bit",
                    choices=list(CODEC_NAMES))
    ap.add_argument("--codec-arg", type=float, default=None)
    ap.add_argument("--scale-mode", default="tensor",
                    choices=["tensor", "chunk", "row"])
    ap.add_argument("--bucket-mb", type=float, default=None)
    ap.add_argument("--hierarchy", type=int, default=0, metavar="INNER",
                    help="two-level exchange with INNER intra-pod workers "
                         "(0 = flat)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--micro-batches", type=int, default=1,
                    help="gradient-accumulation microbatches of the "
                         "audited steps")
    ap.add_argument("--pack-order", default="flat",
                    choices=list(BK.PACK_ORDERS),
                    help="exchange-unit packing/issue order "
                         "(reverse_backward ~ backward readiness order)")
    ap.add_argument("--tp", type=int, default=0, metavar="SHARDS",
                    help="tensor parallelism: not ported yet (raises)")
    ap.add_argument("--full", action="store_true",
                    help="audit the full-size config (default: smoke)")
    ap.add_argument("--matrix", action="store_true",
                    help="run the smoke matrix on --config instead of one "
                         "configuration")
    ap.add_argument("--lints", action="store_true",
                    help="also run the AST repo-invariant lints")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="emit JSONL records; bare --json prints to stdout")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.tp:
        raise NotImplementedError(TP_NOT_PORTED)

    combos = (list(_matrix(args.workers)) if args.matrix
              else [dict(optimizer=args.optimizer, codec=args.codec,
                         codec_arg=args.codec_arg,
                         scale_mode=args.scale_mode,
                         bucket_mb=args.bucket_mb,
                         hierarchy_inner=args.hierarchy,
                         micro_batches=args.micro_batches,
                         pack_order=args.pack_order, workers=args.workers)])
    failed = 0
    for kw in combos:
        rec = audit_one(args.arch, smoke=not args.full, device=args.device,
                        **kw)
        c = rec["config"]
        label = (f"{c['arch']} opt={c['optimizer']} codec={c['codec']} "
                 f"hier={c['hierarchy_inner']} bucket={c['bucket_mb']} "
                 f"mb={c['micro_batches']}"
                 + (f" pack={c['pack_order']}"
                    if c['pack_order'] != "flat" else ""))
        if rec["ok"]:
            print(f"audit OK   {label} "
                  f"({rec['summary']['collectives_recorded']} collectives "
                  f"recorded over {rec['summary']['steps']} steps, "
                  f"{rec['summary']['sync_collectives_declared']} declared "
                  f"sync)", flush=True)
        else:
            failed += 1
            msg = first_violation(rec) or "; ".join(rec["frame_issues"][:1])
            print(f"audit FAIL {label}\n  first violation: {msg}",
                  flush=True)
        if args.json == "-":
            print(json.dumps(rec))
        elif args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if args.lints:
        findings = run_lints()
        for f in findings:
            print(f)
        if findings:
            print(f"lints: {len(findings)} finding(s)")
            failed += 1
        else:
            print("lints: clean")

    print(f"\nAUDIT SUMMARY: {len(combos) - failed}/{len(combos)} configs "
          f"clean" + (" + lints" if args.lints else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
