"""Launch-geometry sweep and per-frame times of the redesigned onebit
kernels on one GPU.

    python3 chip_sweep.py [section ...]
    python3 chip_sweep.py --tree DIR phase3

Sections (all by default, in this order):

* ``abs_rowsum``: pass 1 with its tensor-scale groups at every distinct
  frame of one gpt2-FULL sync, flat and at 2 pods x 2 (4 workers
  stacked), at 1, 2, 4 and 8 warps per row (slices of 512-byte runs)
  and at the warps kernels/onebit.py::abs_rowsum_geometry picks, each
  checked against the plain version first, with the byte bound.
* ``ef_quantize``: pass 2 at the same frames (one warp per chunk of 256
  float4s), bit for bit against the plain version first, with the byte
  bound and the kernel's share of it.
* ``decompress``: every frame of one gpt2-FULL sync (4 workers stacked):
  the wrapper, the C entry point called directly (no wrapper), and
  Tensor.fill_ of the same output (write-only, 4 of the kernel's 4.125
  bytes per element), each with its byte bound.
* ``ef_compress``: BERT-Base's and gpt2's widest row-scale frames,
  (3072, 30720) and (3072, 50432) (4 workers stacked): the geometry
  kernels/onebit.py::ef_compress_geometry picks, then every cluster size
  from 8 down to 1 (slices of ceil(cols / n) columns rounded up to 8,
  each kept whole in shared memory; the sizes that need more than 48 KB
  come last, since allowing that changes the kernel's attributes), next
  to torch.add of the same operands (12 bytes per element against the
  kernel's 12.125). Each geometry is checked against the plain version
  first.
* ``stacked``: the reductions of a sync that see the worker stack, over
  a stack of four and over each worker alone, at every gpt2-FULL view,
  flat and at 2 pods x 2: the kernel's tensor scales (abs_rowsum with
  its groups), the torch combine they replaced
  (``rowsum.view(stack, -1).sum(1)``), the mean over senders of the
  decoded receive, and the intra-pod f32 mean of the bf16 reduce-
  scatter. Where one gives other bits, a rank of the multi-process
  regime (a stack of one) is not bitwise its simulated worker
  (chip_smoke.py phase 6).
* ``phase3``: chip_smoke.py's phases 3a and 3c alone, each kernel's
  times per round as chip_smoke.py reports them; with ``--tree DIR`` those
  of another checkout (its chip_smoke.py and src/), so that two commits
  run in turns on one card compare without phases 4-6.
* ``run4a``: chip_smoke.py's run 4a (gpt2 FULL, 4 simulated workers, 8
  steps) through the imported checkout's ``launch.train``, and a SHA-256
  of its final params (the bytes of every leaf in flatten order) with
  its step losses: run in two checkouts, equal digests show that their
  4a is the same bit for bit.
* ``memory``: where a training step's device memory goes, for
  chip_smoke.py's run 9a (granite-3-8b FULL width, 2 simulated workers,
  batch 8 x 1024, remat) at 1 and at 2 layers: the memory held after
  the init, then three steps (two sync + variance steps, a sync step)
  under the CUDA caching allocator's history, replayed to the moment of
  the most memory allocated during the steps; the blocks alive then,
  summed by the line of the port that allocated them (the innermost
  frame under ``src/repro_torch``), the largest first.

Every time is the median of 5 CUDA-event pairs around 20 calls back to
back. Prints one JSON line per frame, then the card line. Exits non-zero
without a card.
"""
from __future__ import annotations

import json
import os
import sys

import torch


def _tree(argv):
    """The checkout whose chip_smoke.py and src/ this run imports: this
    one, or the one after ``--tree`` (whose kernels the phase3 section
    then times by the same method, e.g. a parent commit's); and the
    remaining arguments."""
    if "--tree" in argv:
        i = argv.index("--tree")
        return os.path.abspath(argv[i + 1]), argv[:i] + argv[i + 2:]
    return os.path.dirname(os.path.abspath(__file__)), argv


TREE, ARGS = _tree(sys.argv[1:])
sys.path.insert(0, os.path.join(TREE, "src"))
sys.path.insert(0, TREE)

import chip_smoke as CS  # noqa: E402

EF_FRAMES = [(3072, 30720), (3072, 50432)]


def batched_ms(fn):
    return CS.time_ms(fn, CS.TIME_BATCH_REPS, CS.TIME_BATCH)


def sweep_ef_compress(dev, gen):
    from repro_torch.kernels import build
    from repro_torch.kernels import onebit as OB

    for rows, cols in EF_FRAMES:
        z = torch.randn(rows, cols, device=dev, generator=gen)
        e = torch.randn(rows, cols, device=dev, generator=gen) * 0.3
        cnt = torch.full((rows,), cols, dtype=torch.int32, device=dev)
        packed = torch.empty(rows, cols // 8, dtype=torch.uint8, device=dev)
        scales = torch.empty(rows, device=dev)
        err_out = torch.empty_like(z)
        pp, sp, _ = OB.ef_compress_plain(z, e, cnt)

        def run(geometry):
            build.launch("ef_compress", "ef_compress", dev,
                         z.data_ptr(), e.data_ptr(), cnt.data_ptr(),
                         packed.data_ptr(), scales.data_ptr(),
                         err_out.data_ptr(), rows, cols, *geometry,
                         OB.ERR_TYPES[e.dtype])

        geometries = {"host": OB.ef_compress_geometry(cols)}
        for n in range(OB.EF_MAX_CLUSTER, 0, -1):
            width = -(-cols // (8 * n)) * 8
            geometries[f"cluster {n}"] = (n, width, width)
        out = {"kernel": "ef_compress", "frame": [rows, cols],
               "bound_ms": (12.125 * rows * cols + 8.0 * rows)
               / CS.PEAK_BYTES_PER_S * 1e3}
        for name, geometry in geometries.items():
            run(geometry)
            torch.cuda.synchronize()
            assert torch.equal(packed, pp), (cols, name)
            assert CS.ulps(scales, sp) <= CS.ROWSUM_ULPS, (cols, name)
            out[name] = {"geometry": list(geometry),
                         "ms": batched_ms(lambda: run(geometry))}
        sum_out = torch.empty_like(z)
        out["torch.add_ms"] = batched_ms(lambda: torch.add(z, e, out=sum_out))
        print(json.dumps(out), flush=True)
        del z, e, packed, scales, err_out, pp, sp, sum_out
        torch.cuda.empty_cache()


def decompress_frames(dev, gen):
    from repro_torch.core import compressor as C
    from repro_torch.kernels import build
    from repro_torch.kernels import onebit as OB

    for lo in CS.full_plan("gpt2").layouts:
        rows, cols = C.view_rows_cols(lo)
        R = CS.N_WORKERS * rows
        packed = torch.randint(0, 256, (R, cols // 8), dtype=torch.uint8,
                               device=dev, generator=gen)
        s = torch.rand(R, device=dev, generator=gen)
        out = torch.empty(R, cols, device=dev)
        divisor = OB.divisor(cols // 8)

        def entry():
            build.launch("decompress", "decompress", dev,
                         packed.data_ptr(), s.data_ptr(), out.data_ptr(), R,
                         cols, *divisor)

        entry()
        torch.cuda.synchronize()
        assert torch.equal(out, OB.decompress_plain(packed, s)), lo.shape
        print(json.dumps({
            "kernel": "decompress", "frame": [R, cols],
            "bound_ms": (4.125 * R * cols + 4.0 * R)
            / CS.PEAK_BYTES_PER_S * 1e3,
            "wrapper_ms": batched_ms(lambda: OB.decompress(packed, s)),
            "entry_ms": batched_ms(entry),
            "fill_ms": batched_ms(lambda: out.fill_(1.0))}), flush=True)
        del packed, s, out
        torch.cuda.empty_cache()


def _two_pass_frames(dev):
    """(label, rows, counts, tensor-scale denominators) of every distinct
    worker-side frame of one gpt2-FULL sync, flat and at 2 pods x 2, 4
    workers stacked."""
    from repro_torch.core import compressor as C
    from repro_torch.kernels import dispatch as K

    seen, out = set(), []
    for inner in (None, CS.INNER):
        for lo in CS.full_plan("gpt2", inner).layouts:
            rows, cols = C.view_rows_cols(lo)
            idx = (None if inner is None else
                   tuple(w % inner for w in range(CS.N_WORKERS)))
            cnt, tdenom, _ = K._worker_counts(lo, CS.N_WORKERS, idx, str(dev))
            R = cnt.numel()
            if (R, cols) in seen:
                continue
            seen.add((R, cols))
            out.append(("flat" if inner is None else "2x2", R, cols, cnt,
                        tdenom))
    return out


def _operands(dev, gen, R, cols, cnt):
    m = torch.arange(cols, device=dev)[None, :] < cnt[:, None]
    z = torch.randn(R, cols, device=dev, generator=gen) * m
    return z, torch.randn(R, cols, device=dev, generator=gen) * 0.3 * m


def sweep_abs_rowsum(dev, gen):
    from repro_torch.kernels import build
    from repro_torch.kernels import onebit as OB

    for label, R, cols, cnt, denom in _two_pass_frames(dev):
        z, e = _operands(dev, gen, R, cols, cnt)
        gr = R // CS.N_WORKERS
        rp, sp = OB.abs_rowsum_scales_plain(z, e, cnt, gr, denom)
        out = torch.empty(R, device=dev)
        scales = torch.empty(CS.N_WORKERS, device=dev)
        c4 = -(-cols // 4)

        def run(warps, slice4):
            build.launch("abs_rowsum", "abs_rowsum", dev, z.data_ptr(),
                         e.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                         denom.data_ptr(), scales.data_ptr(), R, cols, warps,
                         slice4, gr, OB.ERR_TYPES[e.dtype])

        row = {"kernel": "abs_rowsum", "frames": label, "frame": [R, cols],
               "host": list(OB.abs_rowsum_geometry(cols)),
               "bound_ms": (8.0 * float(cnt.sum()) + 8.0 * (R + CS.N_WORKERS))
               / CS.PEAK_BYTES_PER_S * 1e3}
        for warps in (1, 2, 4, 8):
            slice4 = c4 if warps == 1 else -(-c4 // (32 * warps)) * 32
            run(warps, slice4)
            torch.cuda.synchronize()
            assert CS.ulps(out, rp) <= CS.ROWSUM_ULPS, (cols, warps)
            assert CS.ulps(scales, sp) <= CS.ROWSUM_ULPS, (cols, warps)
            row[f"warps {warps}"] = batched_ms(lambda: run(warps, slice4))
        print(json.dumps(row), flush=True)
        del z, e, rp, sp, out
        torch.cuda.empty_cache()


def sweep_ef_quantize(dev, gen):
    from repro_torch.kernels import onebit as OB

    for label, R, cols, cnt, denom in _two_pass_frames(dev):
        z, e = _operands(dev, gen, R, cols, cnt)
        gr = R // CS.N_WORKERS
        s = torch.rand(CS.N_WORKERS, device=dev, generator=gen)
        pp, ep = OB.ef_quantize_plain(z, e, s, cnt, gr)
        packed, err_out = OB.ef_quantize(z, e, s, cnt, gr)
        torch.cuda.synchronize()
        assert torch.equal(packed, pp) and torch.equal(err_out, ep), cols
        bound = ((12.125 * R * cols + 4.0 * (R + CS.N_WORKERS))
                 / CS.PEAK_BYTES_PER_S * 1e3)
        ms = batched_ms(lambda: OB.ef_quantize(z, e, s, cnt, gr))
        print(json.dumps({"kernel": "ef_quantize", "frames": label,
                          "frame": [R, cols], "batched_ms": ms,
                          "bound_ms": bound, "share": bound / ms}),
              flush=True)
        del z, e, pp, ep, packed, err_out
        torch.cuda.empty_cache()


def stacked_reductions(dev, gen):
    from repro_torch.core import compressor as C
    from repro_torch.kernels import onebit as OB

    n = CS.N_WORKERS
    unequal = {"kernel_tensor_scales": [], "torch_combine": [],
               "sender_means": [], "intra_pod_means": []}
    leaves = 0
    for inner in (None, CS.INNER):
        for lo in CS.full_plan("gpt2", inner).layouts:
            leaves += 1
            rows, cols = C.view_rows_cols(lo)
            ni = 1 if inner is None else inner
            R = n * rows // ni
            gr = R // n
            cnt = torch.full((R,), cols, dtype=torch.int32, device=dev)
            z, e = _operands(dev, gen, R, cols, cnt)
            d = torch.rand(n, device=dev, generator=gen) + 1.0
            rs, s4 = OB.abs_rowsum_scales(z, e, cnt, gr, d)
            s1 = torch.cat([OB.abs_rowsum_scales(
                z[w * gr:(w + 1) * gr].clone(), e[w * gr:(w + 1) * gr].clone(),
                cnt[:gr].clone(), gr, d[w:w + 1].clone())[1]
                for w in range(n)])
            t4 = rs.view(n, -1).sum(1)
            t1 = torch.cat([rs[w * gr:(w + 1) * gr].clone().view(1, -1).sum(1)
                            for w in range(n)])
            tag = [list(lo.shape), "flat" if inner is None else "2x2"]
            if not torch.equal(s4, s1):
                unequal["kernel_tensor_scales"].append(tag)
            if not torch.equal(t4, t1):
                unequal["torch_combine"].append(tag)
            del z, e, rs
            # the decoded receive of the 1-bit exchange, (stack, senders,
            # *chunk), and the intra-pod reduce-scatter receive in bf16
            x = torch.randn((n, n // ni) + lo.chunk_shape, device=dev,
                            generator=gen)
            if not torch.equal(x.mean(dim=1), torch.cat(
                    [x[w:w + 1].clone().mean(dim=1) for w in range(n)])):
                unequal["sender_means"].append(tag)
            if inner is not None:
                y = torch.randn((n, ni, n // ni) + lo.chunk_shape, device=dev,
                                generator=gen).to(torch.bfloat16)
                f = y.to(torch.float32).mean(dim=1)
                f1 = torch.cat([y[w:w + 1].clone().to(torch.float32).mean(
                    dim=1) for w in range(n)])
                if not torch.equal(f, f1):
                    unequal["intra_pod_means"].append(tag)
                del y, f, f1
            del x
            torch.cuda.empty_cache()
    print(json.dumps({"stacked_reductions": f"stack of {n} vs stacks of 1",
                      "views": leaves, "unequal": unequal}), flush=True)


def phase3(dev, gen):
    """chip_smoke.py's phases 3a and 3c of the imported checkout (gpt2-FULL
    frames flat and at 2 pods x 2, the BERT-Base slice frames of
    ef_compress): each kernel's times per round as chip_smoke.py reports
    them, with the byte bound. Run in turns in two checkouts, it compares
    their kernels on one card without phases 4-6."""
    tally = CS.Tally()
    CS.check_kernels(dev, tally)
    CS.check_hier_kernels(dev, tally)
    out = {"phase3": os.path.relpath(TREE)}
    for name, r in tally.rows.items():
        if r["launches_per_round"]:
            out[name] = {"ms": r["ms"], "batched_ms": r["batched_ms"],
                         "bound_ms": r["bytes"] / CS.PEAK_BYTES_PER_S * 1e3}
    print(json.dumps(out), flush=True)


def run4a(dev, gen):
    """Run 4a of the imported checkout; its params' SHA-256 and losses."""
    import hashlib

    from repro_torch.core.leafwise import flatten_tree
    from repro_torch.launch import train as launch

    args = launch.parse_args([
        "--arch", "gpt2", "--mode", "sim", "--workers", str(CS.N_WORKERS),
        "--steps", str(CS.STEPS), "--batch", str(CS.BATCH), "--seq",
        str(CS.SEQ), "--sync-warmup", "2", "--double-every", "2", "--kappa",
        "1", "--log-every", str(CS.STEPS)])
    res = launch.train(args, launch.make_trainer(args, device=dev))
    h = hashlib.sha256()
    for x in flatten_tree(res["params"])[1]:
        h.update(x.detach().cpu().numpy().tobytes())
    print(json.dumps({"run4a": os.path.relpath(TREE),
                      "params_sha256": h.hexdigest(),
                      "losses": [r["losses"] for r in res["records"]]}),
          flush=True)


def memory(dev, gen):
    """The ``memory`` section (module docstring). Each part of a step
    (``Trainer.grads``, the optimizer's step) is marked in the history by
    a small allocation, so that the peak and each block alive at it are
    placed in a step and a part."""
    import collections

    from repro_torch.launch import train as launch

    for layers in (1, 2):
        args = launch.parse_args([
            "--arch", "granite-3-8b", "--mode", "sim", "--workers", "2",
            "--steps", "3", "--batch", "8", "--seq", "1024",
            "--sync-warmup", "2", "--double-every", "2", "--kappa", "1",
            "--layers", str(layers)])
        tr = launch.make_trainer(args, device=dev)
        params, state = tr.init(0)
        data = launch.SyntheticLM(launch.DataConfig(
            vocab=tr.model_cfg.vocab, seq_len=args.seq,
            global_batch=args.batch, seed=0), device=dev)
        marks, keep = {}, []

        def marked(fn, part):
            def call(*a, **k):
                m = torch.empty(8 * (len(marks) + 1), dtype=torch.uint8,
                                device=dev)
                marks[m.data_ptr()] = f"step {len(marks) // 2} {part}"
                keep.append(m)
                return fn(*a, **k)
            return call

        tr.grads = marked(tr.grads, "fwd/bwd")
        tr.opt.step = marked(tr.opt.step, "optimizer")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(
            enabled="all", stacks="python", max_entries=1_000_000)
        for t in range(args.steps):
            params, state, _ = tr.step(params, state, data.batch(t))
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        trace = snap["device_traces"][dev.index or 0]
        # a marker's own event: the last allocation at its address (the
        # markers are never freed; an earlier block may have had it)
        marker_at = {}
        for k, ev in enumerate(trace):
            if ev["action"] == "alloc" and ev["addr"] in marks:
                marker_at[ev["addr"]] = k
        marker_at = {k: marks[a] for a, k in marker_at.items()}
        live, cur, peak, at_peak = {}, 0, 0, {}
        part, peak_part = "before", None
        for k, ev in enumerate(trace):
            if ev["action"] == "alloc":
                part = marker_at.get(k, part)
                live[ev["addr"]] = (ev["size"], ev["frames"], part)
                cur += ev["size"]
                if cur > peak:
                    peak, at_peak, peak_part = cur, dict(live), part
            elif (ev["action"] in ("free_requested", "free_completed")
                  and ev["addr"] in live):
                cur -= live.pop(ev["addr"])[0]
        by_line = collections.Counter()
        for size, frames, born in at_peak.values():
            where = next((f"{f['filename'].split('src/')[-1]}:{f['line']} "
                          f"{f['name']}" for f in frames
                          if "repro_torch" in f["filename"]), "other")
            by_line[f"{where} [{born}]"] += size
        print(json.dumps({
            "memory": f"granite-3-8b FULL width, {layers} layer(s) x 2 "
                      f"workers, batch 8 x 1024",
            "held_after_init_gb": held / 1e9,
            "peak_during_steps_gb": (held + peak) / 1e9,
            "allocated_at_peak_gb": peak / 1e9, "peak_in": peak_part,
            "by_line_gb": {k: round(v / 1e9, 3)
                           for k, v in by_line.most_common(15)}}),
            flush=True)
        del tr, params, state, snap, live, at_peak, keep
        torch.cuda.empty_cache()


SECTIONS = {"abs_rowsum": sweep_abs_rowsum, "ef_quantize": sweep_ef_quantize,
            "decompress": decompress_frames, "ef_compress": sweep_ef_compress,
            "stacked": stacked_reductions, "phase3": phase3, "run4a": run4a,
            "memory": memory}


def main(names):
    unknown = set(names) - set(SECTIONS)
    if unknown:
        sys.exit(f"chip_sweep: unknown sections {sorted(unknown)}; choose "
                 f"from {list(SECTIONS)}")
    if not torch.cuda.is_available():
        sys.exit("chip_sweep: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in names or SECTIONS:
        SECTIONS[name](dev, gen)
    print(CS.card_line())


if __name__ == "__main__":
    main(ARGS)
