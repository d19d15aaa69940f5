"""Launch-geometry sweep and per-frame times of the redesigned onebit
kernels on one GPU.

    python3 chip_sweep.py

1. ef_compress at BERT-Base's and gpt2's widest row-scale frames,
   (3072, 30720) and (3072, 50432) (4 workers stacked): the geometry
   kernels/onebit.py::ef_compress_geometry picks, then every cluster
   size from 8 down to 1 (slices of ceil(cols / n) columns rounded up to
   8, each kept whole in shared memory; the sizes that need more than
   48 KB come last, since allowing that changes the kernel's attributes),
   next to torch.add of the same operands (12 bytes per element against
   the kernel's 12.125). Each geometry is checked against the plain
   version first.
2. decompress at every frame of one gpt2-FULL sync (4 workers stacked):
   the wrapper, the C entry point called directly (no wrapper), and
   Tensor.fill_ of the same output (write-only, 4 of the kernel's 4.125
   bytes per element), each with its byte bound.
3. The two reductions of a sync that see the worker stack, over a stack
   of four and over each worker alone, at every gpt2-FULL view: the
   tensor-scale sum of the row sums (``_combine_scales``) and the mean
   over senders of the decoded receive. Where they give other bits, a
   rank of the multi-process regime (a stack of one) is not bitwise its
   simulated worker (chip_smoke.py phase 6).

Every time is the median of 5 CUDA-event pairs around 20 calls back to
back. Prints one JSON line per frame, then the card line. Exits non-zero
without a card.
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

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
            build.launch("ef_compress", "ef_compress_f32", dev,
                         z.data_ptr(), e.data_ptr(), cnt.data_ptr(),
                         packed.data_ptr(), scales.data_ptr(),
                         err_out.data_ptr(), rows, cols, *geometry)

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
        divisor = OB.decompress_divisor(cols // 8)

        def entry():
            build.launch("decompress", "decompress_f32", dev,
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


def stacked_reductions(dev, gen):
    from repro_torch.core import compressor as C
    from repro_torch.kernels import dispatch as K

    n = CS.N_WORKERS
    unequal = {"tensor_scales": [], "sender_means": []}
    layouts = CS.full_plan("gpt2").layouts
    def tensor_scales(lo, rs, stack):
        _, *denoms = K._worker_counts(lo, stack, None, str(dev))
        return K._combine_scales(rs, lo.view_shape, "tensor",
                                 lo.rest_factor, denoms, stack)

    for lo in layouts:
        rows, _ = C.view_rows_cols(lo)
        rs = torch.rand(n * rows, device=dev, generator=gen)
        s4 = tensor_scales(lo, rs, n)
        s1 = torch.cat([tensor_scales(lo, rs[w * rows:(w + 1) * rows].clone(),
                                      1) for w in range(n)])
        d = torch.randn((n,) + tuple(lo.view_shape), device=dev,
                        generator=gen)
        m1 = torch.cat([d[w:w + 1].clone().mean(dim=1) for w in range(n)])
        if not torch.equal(s4, s1):
            unequal["tensor_scales"].append(list(lo.shape))
        if not torch.equal(d.mean(dim=1), m1):
            unequal["sender_means"].append(list(lo.shape))
        del d, m1
    print(json.dumps({"stacked_reductions": f"stack of {n} vs stacks of 1",
                      "leaves": len(layouts), "unequal": unequal}),
          flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_sweep: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    decompress_frames(dev, gen)
    sweep_ef_compress(dev, gen)
    stacked_reductions(dev, gen)
    print(CS.card_line())


if __name__ == "__main__":
    main()
