"""Error-feedback compressed AllReduce (paper Algorithm 2), PyTorch port
of ``src/repro/core/onebit_allreduce.py``, flat and hierarchical.

  worker side   z = u + d_w ;  (payload, d_w') = codec.encode_worker(z)
  scatter       all_to_all of payload leaves: worker j receives every
                worker's chunk j
  server side   avg = mean_i decode(payload_i) ; y = avg + d_s ;
                (payload', d_s') = codec.encode_server(y)
  gather        all_gather of the compressed chunk results

With a :class:`~repro_torch.core.comm.Hierarchy` the same estimate runs
in two levels: an uncompressed reduce-scatter inside each pod (at the
wire dtype, bf16), the exchange above across pods on the slice each
worker owns, and an all_gather inside the pod.

Tensors carry the stack of workers on dim 0 (see ``core.comm``).

Each exchange is written once, as a generator of its collective phases
(:func:`onebit_phases`, :func:`fullprec_phases`): it issues a phase's
collectives through the comm's asynchronous forms, yields the number of
phases it has still to issue, and, resumed, waits for them and computes
on. :func:`run_phases` drives one to its end, each phase waited as soon
as it is issued (:func:`onebit_allreduce_view`,
:func:`fullprec_allreduce_view`); the optimizer's per-unit scheduler
interleaves the phases of two units instead
(``core.compressed.StepScheduler``). Either way every tensor op and
kernel call is the same, with the same arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import codecs as CODECS
from repro_torch.core import compressor as C
from repro_torch.core.comm import Comm, Hierarchy


class EFState(NamedTuple):
    """Per-leaf error feedback of the stacked workers, at the level that
    quantizes: the worker error covers the buffer a worker compresses
    (its full view when flat, its owned inner slice with a hierarchy),
    the server error the chunk it serves. The intra-pod phases carry no
    error feedback."""

    err_worker: torch.Tensor   # (stack, *ef_worker_shape)
    err_server: torch.Tensor   # (stack, *chunk_shape)


def init_ef_state(layout: C.LeafLayout, stack: int, device=None,
                  dtype=torch.float32) -> EFState:
    return EFState(
        err_worker=torch.zeros((stack,) + layout.ef_worker_shape,
                               dtype=dtype, device=device),
        err_server=torch.zeros((stack,) + layout.chunk_shape, dtype=dtype,
                               device=device))


@dataclasses.dataclass(frozen=True)
class OneBitConfig:
    scale_mode: C.ScaleMode = "tensor"
    codec: Any = "sign1bit"                 # a Codec or a registry name
    codec_arg: Optional[float] = None       # argument of a named codec
                                            # (topk: density)
    hierarchy: Optional[Hierarchy] = None   # two levels: reduce in pods,
                                            # compress only across them
    comm_dtype: Any = torch.bfloat16        # wire of the intra-pod phases

    def __post_init__(self):
        C.validate_scale_mode(self.scale_mode)
        object.__setattr__(self, "codec",
                           CODECS.make_codec(self.codec, self.codec_arg))


def run_phases(phases):
    """Drive a generator of collective phases to its end, waiting for
    each phase as soon as it is issued; its return value."""
    while True:
        try:
            next(phases)
        except StopIteration as stop:
            return stop.value


def _wait(handles):
    return {name: h.wait() for name, h in handles.items()}


def onebit_allreduce_view(comm: Comm, z_view: torch.Tensor, ef: EFState,
                          layout: C.LeafLayout, cfg: OneBitConfig):
    """Algorithm 2 over one leaf's stacked comm views (stack, *view_shape).

    Returns ``(mean estimate of z over workers, new EFState)``; every
    worker receives the same estimate. Exact codecs leave ``ef`` as is.
    With ``cfg.hierarchy`` the two-level schedule runs
    (:func:`_hier_phases`); the flat code is its bitwise ``n_inner == 1``
    case."""
    return run_phases(onebit_phases(comm, z_view, ef, layout, cfg))


def onebit_phases(comm: Comm, z_view: torch.Tensor, ef: EFState,
                  layout: C.LeafLayout, cfg: OneBitConfig):
    """:func:`onebit_allreduce_view` as a generator of its phases (the
    payloads' all_to_all, the server payloads' all_gather); returns its
    result."""
    if cfg.hierarchy is not None:
        if layout.n_inner != cfg.hierarchy.inner:
            raise ValueError(f"layout has n_inner={layout.n_inner}, the "
                             f"hierarchy {cfg.hierarchy}")
        return (yield from _hier_phases(comm, z_view, ef, layout, cfg))
    codec, mode = cfg.codec, cfg.scale_mode
    payload, err_w = codec.encode_worker(
        z_view, ef.err_worker if codec.needs_ef else None, layout, mode)
    sent = {name: comm.all_to_all_async(p) for name, p in payload.items()}
    del payload
    yield 1
    recv = _wait(sent)

    widx = comm.index()
    avg = codec.decode_mean(recv, layout)
    del recv
    payload_s, err_s = codec.encode_server(
        avg, ef.err_server if codec.needs_ef else None, layout, mode, widx)
    del avg
    sent = {name: comm.all_gather_async(p) for name, p in payload_s.items()}
    del payload_s
    yield 0
    out = codec.decode(_wait(sent), layout)
    if codec.needs_ef:
        ef = EFState(err_worker=err_w.to(ef.err_worker.dtype),
                     err_server=err_s.to(ef.err_server.dtype))
    return out.to(torch.float32), ef


def _hier_phases(comm: Comm, z_view: torch.Tensor, ef: EFState,
                 layout: C.LeafLayout, cfg: OneBitConfig):
    """Two-level Algorithm 2; worker ``w = k * n_inner + j`` (pod k):

      1. intra-pod reduce-scatter at ``comm_dtype``: all_to_all over the
         pod of the view as (n_inner, n_outer, A/n, *rest); the f32 mean
         over the senders leaves worker j owning the pod mean of slice j;
      2. Algorithm 2 across pods on the owned slice (worker error of the
         slice's size); worker j of pod k serves full-view chunk
         ``j * n_outer + k``;
      3. intra-pod all_gather of the decoded slice at ``comm_dtype``.

    With ``n_inner == 1`` steps 1 and 3 are skipped and step 2 is the
    flat path, bit for bit. A generator of its phases (four, or two),
    as :func:`onebit_phases`."""
    codec, mode = cfg.codec, cfg.scale_mode
    ni, no = layout.n_inner, layout.n_outer
    pods = 2 if ni > 1 else 0     # the intra-pod phases
    stack = z_view.shape[0]
    outer, inner = comm.split(ni)
    zr = z_view.reshape((stack, ni, no) + layout.chunk_shape)
    if ni > 1:
        sent = inner.all_to_all_async(zr.to(cfg.comm_dtype))
        yield 3
        own = sent.wait().to(torch.float32).mean(dim=1)
        del sent
        j = inner.index()
    else:
        own = zr[:, 0]
        j = np.zeros(stack, dtype=np.int64)

    payload, err_w = codec.encode_worker(
        own, ef.err_worker if codec.needs_ef else None, layout, mode,
        inner_index=j)
    del own
    sent = {name: outer.all_to_all_async(p) for name, p in payload.items()}
    del payload
    yield 1 + pods // 2
    recv = _wait(sent)
    widx = j * no + outer.index()
    avg = codec.decode_mean(recv, layout)
    del recv
    payload_s, err_s = codec.encode_server(
        avg, ef.err_server if codec.needs_ef else None, layout, mode, widx)
    del avg
    sent = {name: outer.all_gather_async(p) for name, p in payload_s.items()}
    del payload_s
    yield pods // 2
    out_slice = codec.decode(_wait(sent), layout)
    if codec.needs_ef:
        ef = EFState(err_worker=err_w.to(ef.err_worker.dtype),
                     err_server=err_s.to(ef.err_server.dtype))
    if ni > 1:
        sent = inner.all_gather_async(out_slice.to(cfg.comm_dtype))
        del out_slice
        yield 0
        out = sent.wait()
    else:
        out = out_slice
    return out.reshape(z_view.shape).to(torch.float32), ef


def fullprec_allreduce_view(comm: Comm, z_view: torch.Tensor,
                            comm_dtype=torch.bfloat16,
                            hierarchy: Optional[Hierarchy] = None,
                            layout: Optional[C.LeafLayout] = None
                            ) -> torch.Tensor:
    """Full-precision mean over workers on the T_v steps, at the wire
    dtype: a chunked scatter-mean / all_gather whose wire values round to
    ``comm_dtype`` (bf16) on both phases, as in the reference. With a
    ``hierarchy`` (and its ``layout``, ``n_inner > 1``) the same mean runs
    in four collectives: the intra-pod reduce-scatter, the inter-pod
    scatter-mean and all_gather of the owned slice, the intra-pod
    all_gather."""
    return run_phases(fullprec_phases(comm, z_view, comm_dtype, hierarchy,
                                      layout))


def fullprec_phases(comm: Comm, z_view: torch.Tensor,
                    comm_dtype=torch.bfloat16,
                    hierarchy: Optional[Hierarchy] = None,
                    layout: Optional[C.LeafLayout] = None):
    """:func:`fullprec_allreduce_view` as a generator of its phases (two,
    or four with the hierarchy), as :func:`onebit_phases`."""
    if hierarchy is not None and layout is not None and layout.n_inner > 1:
        ni, no = layout.n_inner, layout.n_outer
        outer, inner = comm.split(ni)
        zr = z_view.to(comm_dtype).reshape(
            (z_view.shape[0], ni, no) + layout.chunk_shape)
        sent = inner.all_to_all_async(zr)
        del zr
        yield 3
        own = sent.wait().to(torch.float32).mean(dim=1).to(comm_dtype)
        sent = outer.all_to_all_async(own)
        del own
        yield 2
        avg = sent.wait().to(torch.float32).mean(dim=1).to(comm_dtype)
        sent = outer.all_gather_async(avg[:, None])
        del avg
        yield 1
        sent = inner.all_gather_async(sent.wait())
        yield 0
        return sent.wait().reshape(z_view.shape).to(z_view.dtype)
    sent = comm.all_to_all_async(z_view.to(comm_dtype))
    yield 1
    avg = sent.wait().to(torch.float32).mean(dim=1).to(comm_dtype)
    sent = comm.all_gather_async(avg[:, None])
    del avg
    yield 0
    return sent.wait().to(z_view.dtype)
