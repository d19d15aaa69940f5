"""Error-feedback compressed AllReduce (paper Algorithm 2), PyTorch port
of the flat path of ``src/repro/core/onebit_allreduce.py``.

  worker side   z = u + d_w ;  (payload, d_w') = codec.encode_worker(z)
  scatter       all_to_all of payload leaves: worker j receives every
                worker's chunk j
  server side   avg = mean_i decode(payload_i) ; y = avg + d_s ;
                (payload', d_s') = codec.encode_server(y)
  gather        all_gather of the compressed chunk results

Tensors carry the stack of workers on dim 0 (see ``core.comm``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import codecs as CODECS
from repro_torch.core import compressor as C
from repro_torch.core.comm import Comm


class EFState(NamedTuple):
    """Per-leaf error feedback of the stacked workers."""

    err_worker: torch.Tensor   # (stack, *view_shape)
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
    codec: Any = "sign1bit"

    def __post_init__(self):
        C.validate_scale_mode(self.scale_mode)
        object.__setattr__(self, "codec", CODECS.make_codec(self.codec))


def onebit_allreduce_view(comm: Comm, z_view: torch.Tensor, ef: EFState,
                          layout: C.LeafLayout, cfg: OneBitConfig):
    """Algorithm 2 over one leaf's stacked comm views (stack, *view_shape).

    Returns ``(mean estimate of z over workers, new EFState)``; every
    worker receives the same estimate. Exact codecs leave ``ef`` as is."""
    codec, mode = cfg.codec, cfg.scale_mode
    payload, err_w = codec.encode_worker(
        z_view, ef.err_worker if codec.needs_ef else None, layout, mode)
    recv = {name: comm.all_to_all(p) for name, p in payload.items()}

    widx = comm.index()
    avg = codec.decode(recv, layout).mean(dim=1)
    payload_s, err_s = codec.encode_server(
        avg, ef.err_server if codec.needs_ef else None, layout, mode, widx)

    gathered = {name: comm.all_gather(p) for name, p in payload_s.items()}
    out = codec.decode(gathered, layout)
    if codec.needs_ef:
        ef = EFState(err_worker=err_w.to(ef.err_worker.dtype),
                     err_server=err_s.to(ef.err_server.dtype))
    return out.to(torch.float32), ef


def fullprec_allreduce_view(comm: Comm, z_view: torch.Tensor,
                            comm_dtype=torch.bfloat16) -> torch.Tensor:
    """Full-precision mean over workers on the T_v steps, at the wire
    dtype: a chunked scatter-mean / all_gather whose wire values round to
    ``comm_dtype`` (bf16) on both phases, as in the reference."""
    recv = comm.all_to_all(z_view.to(comm_dtype))
    avg = recv.to(torch.float32).mean(dim=1).to(comm_dtype)
    return comm.all_gather(avg[:, None]).to(z_view.dtype)
