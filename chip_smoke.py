"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and torch/CUDA.
2. Builds the port's CUDA kernels from src/repro_torch/kernels/csrc with
   nvcc for sm_90a.
3. Checks every kernel against its plain PyTorch version on the card, on
   the frames one step of gpt2 FULL with 4 simulated workers gives it (all
   19 leaves, worker and server frames), and times both, with the byte
   bound and, where one PyTorch call computes the same function, that
   call's time.
4. Drives the main path: full-width, full-depth gpt2 trained with
   zero_one_adam by 4 simulated data-parallel workers, global batch 16,
   seq 1024, 8 steps (syncs at 0-4 and 6, variance at 0, 1, 3, local-only
   steps 5 and 7), and checks that all four kernels launched there. Then
   repeats step 6 (a sync step) under torch.profiler.
5. Checks the card against the CPU on a small input: the gpt2-smoke
   trainer from the same start on both devices.
6. Prints the kernels line, the card line and the result line.

Any failure raises; there is no CPU fallback. Exits non-zero without a
result when there is no CUDA device or the repository's src/ is missing.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth
# and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
N_WORKERS, BATCH, SEQ, STEPS = 4, 16, 1024, 8
REPS, PLAIN_REPS = 20, 5
PROFILED_STEP = 6          # a sync step without a variance refresh
# abs_rowsum: both sides sum up to 50,432 terms in different orders (the
# kernel: <= ~60 sequential adds per thread, then an 8-level tree; torch's
# reduction has a similar depth); rounding errors of random sign add like
# a random walk, so 64 ulp of the row sum bounds the gap with margin
ROWSUM_ULPS = 64
# delta = (lr*m')/sqrt(v+eps): both sides IEEE-round the product, the
# square root and the divide; held to the same 2 ulp as the reference
DELTA_ULPS = 2

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "fused_local_step": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                         "src/repro/kernels/fused_adam.py:55"),
    "abs_rowsum": ("src/repro_torch/kernels/csrc/onebit.cu",
                   "src/repro/kernels/onebit.py:120"),
    "ef_quantize": ("src/repro_torch/kernels/csrc/onebit.cu",
                    "src/repro/kernels/onebit.py:155"),
    "decompress": ("src/repro_torch/kernels/csrc/onebit.cu",
                   "src/repro/kernels/onebit.py:197"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return int((ai - bi).abs().max().item()) if a.numel() else 0


class Tally:
    """Per-kernel totals over the launches of one step (or one sync)."""

    def __init__(self):
        self.rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
                         "ops": 0.0, "library_ms": None, "max_abs_err": 0.0,
                         "launches_per_round": 0}
                     for k in KERNELS}

    def add(self, name, ms, plain_ms, nbytes, ops, err, library_ms=None,
            times=1):
        r = self.rows[name]
        r["ms"] += times * ms
        r["plain_ms"] += times * plain_ms
        r["bytes"] += times * nbytes
        r["ops"] += times * ops
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["launches_per_round"] += times
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + times * library_ms


def check_kernels(dev, tally):
    """Phase 3: every kernel vs its plain version at gpt2-FULL frames."""
    from repro_torch.configs.base import get
    from repro_torch.core import compressor as C
    from repro_torch.core.leafwise import make_plan
    from repro_torch.kernels import fused_adam as FA
    from repro_torch.kernels import onebit as OB
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tmpl = T.model_template(get("gpt2").config)
    plan = make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), N_WORKERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    lr, b1 = np.float32(1.5e-4), 0.9
    for lo in plan.layouts:
        rows, cols = C.view_rows_cols(lo)
        R = N_WORKERS * rows
        cnt = torch.as_tensor(np.tile(C.view_row_counts(lo), N_WORKERS),
                              device=dev)
        mask = torch.arange(cols, device=dev)[None, :] < cnt[:, None]

        def rnd(scale=1.0):
            return (torch.randn(R, cols, device=dev, generator=gen)
                    * scale * mask)

        # --- fused local step (once per leaf per step) ----------------
        g, m, u = rnd(), rnd(), rnd(1e-3)
        v = rnd(1e-2).square()
        fk = FA.fused_local_step(g, m, u, v, lr, b1)
        fp = FA.fused_local_step_plain(g, m, u, v, lr, b1)
        torch.cuda.synchronize()
        assert torch.equal(fk[0], fp[0]), (lo.shape, "m' differs")
        assert torch.equal(fk[1], fp[1]), (lo.shape, "u' differs")
        assert ulps(fk[2], fp[2]) <= DELTA_ULPS, (lo.shape, "delta")
        err = max(float((a - b).abs().max()) for a, b in zip(fk, fp))
        n = R * cols
        tally.add("fused_local_step",
                  time_ms(lambda: FA.fused_local_step(g, m, u, v, lr, b1),
                          REPS),
                  time_ms(lambda: FA.fused_local_step_plain(g, m, u, v, lr,
                                                            b1),
                          PLAIN_REPS),
                  28.0 * n, 7.0 * n, err)
        del g, m, u, v, fk, fp

        # --- worker and server compress (once each per leaf per sync) --
        scnt = torch.as_tensor(C.chunk_row_counts(lo).reshape(-1),
                               device=dev)
        total, _ = C.true_counts(lo)
        for frame_rows, counts in ((R, cnt), (rows, scnt)):
            fmask = (torch.arange(cols, device=dev)[None, :]
                     < counts[:, None])
            z = torch.randn(frame_rows, cols, device=dev,
                            generator=gen) * fmask
            e = torch.randn(frame_rows, cols, device=dev,
                            generator=gen) * 0.3 * fmask
            rk = OB.abs_rowsum(z, e, counts)
            rp = OB.abs_rowsum_plain(z, e, counts)
            torch.cuda.synchronize()
            assert ulps(rk, rp) <= ROWSUM_ULPS, (lo.shape, "abs_rowsum")
            true_elems = float(counts.sum())
            tally.add("abs_rowsum",
                      time_ms(lambda: OB.abs_rowsum(z, e, counts), REPS),
                      time_ms(lambda: OB.abs_rowsum_plain(z, e, counts),
                              PLAIN_REPS),
                      8.0 * true_elems + 8.0 * frame_rows, 3.0 * true_elems,
                      float((rk - rp).abs().max()),
                      library_ms=time_ms(lambda: (z + e).abs().sum(1),
                                         REPS))
            # tensor-mode scales of each stacked worker, spread over rows
            s = (rp.view(N_WORKERS, -1).sum(1) / total).repeat_interleave(
                frame_rows // N_WORKERS).contiguous()
            pk, ek = OB.ef_quantize(z, e, s, counts)
            pp, ep = OB.ef_quantize_plain(z, e, s, counts)
            torch.cuda.synchronize()
            assert torch.equal(pk, pp), (lo.shape, "packed bytes differ")
            assert torch.equal(ek, ep), (lo.shape, "err_out differs")
            n = frame_rows * cols
            tally.add("ef_quantize",
                      time_ms(lambda: OB.ef_quantize(z, e, s, counts), REPS),
                      time_ms(lambda: OB.ef_quantize_plain(z, e, s, counts),
                              PLAIN_REPS),
                      12.125 * n + 8.0 * frame_rows, 3.0 * n, 0.0)
            if frame_rows == R:
                # both decodes of a sync (the all_to_all receive and the
                # gathered results) are frames of this shape
                dk = OB.decompress(pk, s)
                dp = OB.decompress_plain(pk, s)
                torch.cuda.synchronize()
                assert torch.equal(dk, dp), (lo.shape, "decompress")
                tally.add("decompress",
                          time_ms(lambda: OB.decompress(pk, s), REPS),
                          time_ms(lambda: OB.decompress_plain(pk, s),
                                  PLAIN_REPS),
                          4.125 * n + 4.0 * frame_rows, 1.0 * n, 0.0,
                          times=2)
                del dk, dp
            del z, e, rk, rp, pk, pp, ek, ep
        torch.cuda.empty_cache()
        print(f"  leaf {lo.shape}: frame ({R}, {cols}) ok", flush=True)


def run_main_path(dev):
    """Phase 4: gpt2 FULL, 4 simulated workers, 8 steps."""
    from repro_torch.configs.base import get
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch
    from repro_torch.train.step import Trainer

    args = launch.parse_args([
        "--arch", "gpt2", "--workers", str(N_WORKERS), "--steps",
        str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
        "--sync-warmup", "2", "--double-every", "2", "--kappa", "1"])
    cfg = get("gpt2").config
    tr = Trainer(cfg, launch.build_opt_cfg(args), n_workers=N_WORKERS,
                 device=dev)
    params, state = tr.sim_init(args.seed)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=args.seed),
                       device=dev)
    batches = [data.batch(t) for t in range(STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    steps, kept = [], None
    for t in range(STEPS):
        t0 = time.perf_counter()
        losses, grads = tr.grads(params, batches[t])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if t == PROFILED_STEP:
            kept = (params, grads, state, batches[t])
        params, state, met = tr.opt.step(tr.comm, params, grads, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        loss = float(losses.mean())
        steps.append({"step": t, "loss": loss, "sync": met["synced"],
                      "var": met["var_round"],
                      "step_ms": 1e3 * (t2 - t0),
                      "fwd_bwd_ms": 1e3 * (t1 - t0),
                      "optimizer_ms": 1e3 * (t2 - t1)})
        print(f"  step {t}: loss {loss:.4f} sync={met['synced']} "
              f"var={met['var_round']} step {1e3 * (t2 - t0):.1f} ms "
              f"(fwd/bwd {1e3 * (t1 - t0):.1f}, optimizer "
              f"{1e3 * (t2 - t1):.1f})", flush=True)
    counts = dict(build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches {json.dumps(counts)}; peak memory {peak_gb:.1f} GB")

    losses = [s["loss"] for s in steps]
    assert all(np.isfinite(losses)), losses
    # random init at scale 0.02: near-uniform logits over the padded vocab
    assert abs(losses[0] - np.log(cfg.padded_vocab)) < 0.5, losses[0]
    assert [s["sync"] for s in steps] == [1, 1, 1, 1, 1, 0, 1, 0]
    assert [s["var"] for s in steps] == [1, 1, 0, 1, 0, 0, 0, 0]
    n_syncs, n_leaves = 6, len(tr.opt.layouts)
    expect = {"fused_local_step": STEPS * n_leaves,
              "abs_rowsum": n_syncs * 2 * n_leaves,
              "ef_quantize": n_syncs * 2 * n_leaves,
              "decompress": n_syncs * 2 * n_leaves}
    assert counts == expect, (counts, expect)
    del params, state
    profile = profile_step(tr, *kept)
    return steps, counts, peak_gb, profile


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_step(tr, params, grads, state, batch):
    """Phase 4b: repeat the forward/backward and the optimizer step of one
    sync step under torch.profiler; per part, the wall time, the summed
    device time of its kernels and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for part, fn in (("fwd_bwd", lambda: tr.grads(params, batch)),
                     ("optimizer_sync", lambda: tr.opt.step(
                         tr.comm, params, grads, state))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        del res
        # kernels only: an aten op's device time is its kernels' again
        evts = [(e.key, _device_us(e) / 1e3, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
        evts.sort(key=lambda x: -x[1])
        busy = sum(ms for _, ms, _ in evts)
        out[part] = {"wall_ms": wall_ms, "device_ms": busy,
                     "top": [[k[:90], round(ms, 3), c]
                             for k, ms, c in evts[:12]]}
        print(f"  profiled {part}: wall {wall_ms:.1f} ms, kernels "
              f"{busy:.1f} ms (device busy {busy / wall_ms:.0%})")
        for k, ms, c in evts[:12]:
            print(f"    {ms:9.3f} ms  x{c:<5d} {k[:90]}")
    return out


def check_small_input(dev):
    """Phase 5: the gpt2-smoke trainer on the card (kernels) against the
    same trainer on the CPU (plain versions), same start and batches.
    Losses within 1e-4 and parameters 99% within 1e-4, all within 0.05:
    the bars the CPU tests hold the CPU path to against the JAX reference,
    for the same reasons (sum order; near-zero sign flips)."""
    from repro_torch.configs.base import get
    from repro_torch.core.leafwise import flatten_tree
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.train.step import Trainer

    args = launch.parse_args([
        "--arch", "gpt2", "--smoke", "--steps", "8", "--batch", "8",
        "--seq", "32", "--sync-warmup", "2", "--double-every", "2",
        "--kappa", "1"])
    cfg = get("gpt2").smoke
    runs = {}
    for d in (dev, torch.device("cpu")):
        tr = Trainer(cfg, launch.build_opt_cfg(args), n_workers=N_WORKERS,
                     device=d)
        params, state = tr.sim_init(0)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=8, seed=0), device=d)
        losses = []
        for t in range(8):
            params, state, met = tr.sim_step(params, state, data.batch(t))
            losses.append(float(met["loss"]))
        runs[d.type] = (losses, flatten_tree(params)[1])
    (lk, pk), (lc, pc) = runs["cuda"], runs["cpu"]
    gap = max(abs(a - b) for a, b in zip(lk, lc))
    diff = torch.cat([(a.cpu() - b).abs().reshape(-1)
                      for a, b in zip(pk, pc)])
    frac = float((diff <= 1e-4).double().mean())
    print(f"  smoke losses card {[round(x, 5) for x in lk]}")
    print(f"  max loss gap card-cpu {gap:.2e}; params within 1e-4: "
          f"{frac:.5f}; max param gap {float(diff.max()):.2e}")
    assert gap < 1e-4 and frac >= 0.99 and float(diff.max()) <= 0.05


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs a "
                 "GPU")
    from repro_torch.kernels import build

    t_start = time.time()
    card = card_line()
    dev = torch.device("cuda")
    print(f"phase 1: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    build.build_all()
    print(f"phase 2: built {list(build.SOURCES)} for sm_90a in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}.cu ptxas: {regs}")

    print("phase 3: kernels vs plain versions at gpt2 FULL frames, "
          f"{N_WORKERS} stacked workers", flush=True)
    tally = Tally()
    check_kernels(dev, tally)

    print(f"phase 4: gpt2 FULL, {N_WORKERS} simulated workers, batch "
          f"{BATCH}, seq {SEQ}, {STEPS} steps", flush=True)
    steps, counts, peak_gb, profile = run_main_path(dev)

    print("phase 5: gpt2-smoke on the card vs on the CPU", flush=True)
    check_small_input(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = tally.rows[name]
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_F32_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"],
            "per": "step" if name == "fused_local_step" else "sync",
            "launches_per_round": r["launches_per_round"]})
    summary = {
        "steps": steps, "peak_memory_gb": peak_gb, "profile": profile,
        "wall_s": time.time() - t_start}
    print("summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
