"""Codec-compressed delta weight publishing, trainer -> serving replicas,
PyTorch port of ``src/repro/serve/publish.py`` in the same wire and file
format, so either package applies the other's updates.

A :class:`Publisher` lays trainer parameters onto the bucketed flat
layouts of :func:`repro_torch.core.bucketing.make_bucket_plan` (``n_chunks``
chunk rows in place of the training workers), delta-encodes them against
the **last published anchor** with one of the five codecs, and emits
numpy payloads; a :class:`Subscriber` decodes payload + anchor back into
the parameter tree.

* Both sides advance ``anchor[k]`` by ``codec.decode(payload)``, the same
  floats through the same eager op sequence, so they never drift apart;
  a codec's quantization error stays in the next delta
  (``params - anchor``) and never accumulates.
* **Snapshots** (the first publish, every ``snapshot_every``-th, or
  ``force_snapshot=True``) ship the raw f32 buffers and reset the anchor;
  an exact codec (``identity``) always ships snapshots.
* Every publish carries a versioned **manifest** (wire geometry, the
  per-leaf paths, shapes and dtypes, ``seq`` and ``anchor_seq``); a
  subscriber checks every field against its own plan before touching
  state and names the first that differs.

The codecs take and return a leading stack dim; the publisher encodes
``delta[None]`` and drops that dim from every payload leaf, so payload
shapes, and so the files, are the reference's. Payloads stay numpy on
the host (they are the wire); anchors live on the device. Under
``sign1bit`` the encode and both decodes launch kernels 2-4 on a CUDA
tensor (chunk scales), and their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpointing.io import leaf_paths
from repro_torch.core import bucketing as B
from repro_torch.core import compressor as C
from repro_torch.core.codecs import Codec, IdentityCodec, make_codec
from repro_torch.core.leafwise import flatten_tree, make_plan, unflatten_tree
from repro_torch.train.step import resolve_device

PUBLISH_FORMAT_VERSION = 1

#: bucket budget that degenerates to one (fused) bucket per leaf — the
#: "flat" per-leaf wire layout (budget computes to 1 element)
_PER_LEAF_MB = 2.0 ** -22

#: manifest fields a Subscriber must agree on before applying anything
_LAYOUT_FIELDS = ("codec", "codec_arg", "scale_mode", "n_chunks",
                  "bucket_mb", "pack_order", "n_buckets",
                  "leaf_shapes", "leaf_dtypes")


@dataclasses.dataclass(frozen=True)
class PublishConfig:
    """Wire-layout + cadence knobs shared by Publisher and Subscriber.

    ``n_chunks`` plays the role the worker count plays in training layouts:
    the bucket buffer is viewed as ``(n_chunks, bucket_elems/n_chunks)`` and
    codec scale granularity is per chunk row. ``bucket_mb=None`` keeps one
    bucket per leaf.
    """

    codec: Any = "qint8"
    codec_arg: Optional[float] = None
    scale_mode: str = "chunk"
    n_chunks: int = 16
    bucket_mb: Optional[float] = 4.0
    pack_order: str = "flat"
    snapshot_every: int = 16     # every k-th publish is a full snapshot

    def __post_init__(self):
        make_codec(self.codec, self.codec_arg)   # fail fast on bad names
        C.validate_scale_mode(self.scale_mode)
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {self.n_chunks}")
        if self.bucket_mb is not None and self.bucket_mb <= 0:
            raise ValueError(
                f"bucket_mb must be positive or None, got {self.bucket_mb}")
        if self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {self.snapshot_every}")

    def make_codec(self) -> Codec:
        return make_codec(self.codec, self.codec_arg)


@dataclasses.dataclass
class WeightUpdate:
    """One published refresh: manifest + per-bucket payload trees."""

    manifest: Dict[str, Any]
    payloads: List[Dict[str, np.ndarray]]

    @property
    def kind(self) -> str:
        return self.manifest["kind"]

    @property
    def seq(self) -> int:
        return int(self.manifest["seq"])

    def nbytes(self) -> int:
        return int(sum(a.nbytes for p in self.payloads
                       for a in p.values()))


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, ``bfloat16``, ...)."""
    return str(dtype).replace("torch.", "")


class _WirePlan:
    """The shared publisher/subscriber view of one parameter tree: a
    :class:`~repro_torch.core.leafwise.LeafPlan` with ``n_chunks`` chunk
    rows and a bucket plan over it, on ``device``. Both sides derive it
    independently and the manifest proves they agree."""

    def __init__(self, params_like, cfg: PublishConfig, device):
        self.cfg = cfg
        self.abstract = _abstract(params_like)
        paths, leaves = flatten_tree(self.abstract)
        self.plan = make_plan(unflatten_tree(
            paths, [tuple(l.shape) for l in leaves]), None, None,
            cfg.n_chunks)
        self.bp = B.make_bucket_plan(
            self.plan, cfg.bucket_mb if cfg.bucket_mb else _PER_LEAF_MB,
            pack_order=cfg.pack_order)
        self.codec = cfg.make_codec()
        self.leaf_dtypes = [l.dtype for l in leaves]
        self.device = device

    # -------------------------------------------------------------- #
    def bucketize(self, params) -> List[torch.Tensor]:
        """Parameter tree -> per-bucket f32 view buffers."""
        leaves = self.plan.flat(params)
        bufs = []
        for b in self.bp.buckets:
            views = [C.to_view(leaves[i].detach().to(torch.float32),
                               self.plan.layouts[i])[None]
                     for i in b.members]
            bufs.append(B.gather_views(b, views)[0])
        return bufs

    def unbucketize(self, bufs: List[torch.Tensor]):
        """Per-bucket buffers -> parameter tree (leaf dtypes restored)."""
        leaves = [None] * len(self.plan.layouts)
        for b, buf in zip(self.bp.buckets, bufs):
            layouts = [self.plan.layouts[i] for i in b.members]
            for i, v in zip(b.members,
                            B.scatter_views(b, buf[None], layouts)):
                leaves[i] = C.from_view(v[0], self.plan.layouts[i]).to(
                    self.leaf_dtypes[i])
        return unflatten_tree(self.plan.paths, leaves)

    # -------------------------------------------------------------- #
    def manifest_base(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "version": PUBLISH_FORMAT_VERSION,
            "codec": self.codec.name,
            "codec_arg": cfg.codec_arg,
            "scale_mode": cfg.scale_mode,
            "n_chunks": cfg.n_chunks,
            "bucket_mb": cfg.bucket_mb,
            "pack_order": cfg.pack_order,
            "n_buckets": len(self.bp.buckets),
            "leaf_paths": leaf_paths(self.abstract),
            "leaf_shapes": [list(s) for s in self.plan.shapes],
            "leaf_dtypes": [_dtype_name(d) for d in self.leaf_dtypes],
        }

    def advance_anchors(self, anchors, payloads, kind: str):
        """Advance the anchor buffers by one applied update: ``anchor +
        decode(payload)``, two roundings and no FMA, through the same op
        sequence on the publisher and on the subscriber (the reference
        keeps this step out of ``jit`` for the same reason)."""
        dev = self.device
        if kind == "snapshot":
            return [torch.tensor(p["values"], device=dev) for p in payloads]
        return [anchor + self.codec.decode(
                    {k: torch.tensor(v, device=dev)[None]
                     for k, v in p.items()}, b.layout)[0]
                for anchor, p, b in zip(anchors, payloads, self.bp.buckets)]

    def wire_bytes(self, kind: str) -> int:
        """Declared bytes of one publish: per-chunk codec bytes summed over
        every bucket's chunk rows (``codec.wire_bytes`` is per chunk, the
        same accounting the training exchange uses)."""
        codec = IdentityCodec() if kind == "snapshot" else self.codec
        total = 0
        for b in self.bp.buckets:
            wb = codec.wire_bytes(b.layout, self.cfg.scale_mode)
            total += wb["scatter"] * b.layout.n
        return int(total)

    def full_f32_bytes(self) -> int:
        """Cost of the uncompressed baseline: pushing every true parameter
        element at f32 (no padding — the raw tree, not the wire view)."""
        return 4 * int(sum(b.true_elems for b in self.bp.buckets))


def _abstract(tree):
    """A tree of tensors as ``meta`` tensors of the same shapes and
    dtypes."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _device_of(params_like, device):
    """``device`` if given, else that of the tree's tensors (CUDA for a
    tree on the ``meta`` device)."""
    if device is None:
        dev = flatten_tree(params_like)[1][0].device
        device = "cuda" if dev.type == "meta" else dev
    return resolve_device(device)


def _validate_manifest(mine: Dict[str, Any], theirs: Dict[str, Any]):
    """First mismatched field raises, naming it (and the leaf path when the
    mismatch is inside the per-leaf fingerprint)."""
    if theirs.get("version", 0) > PUBLISH_FORMAT_VERSION:
        raise ValueError(
            f"publish manifest field 'version': payload has "
            f"{theirs.get('version')}, this build reads up to "
            f"{PUBLISH_FORMAT_VERSION}")
    if mine["leaf_paths"] != theirs.get("leaf_paths"):
        a, b = mine["leaf_paths"], theirs.get("leaf_paths") or []
        for i in range(max(len(a), len(b))):
            pa = a[i] if i < len(a) else "<missing>"
            pb = b[i] if i < len(b) else "<missing>"
            if pa != pb:
                raise ValueError(
                    f"publish manifest field 'leaf_paths': leaf {i} is "
                    f"{pb!r} in the payload but {pa!r} on the subscriber "
                    f"— parameter trees diverge")
    for f in _LAYOUT_FIELDS:
        if mine[f] != theirs.get(f):
            detail = ""
            if f in ("leaf_shapes", "leaf_dtypes"):
                for i, (x, y) in enumerate(zip(mine[f], theirs.get(f))):
                    if x != y:
                        detail = (f" (leaf {mine['leaf_paths'][i]!r}: "
                                  f"payload {y} != subscriber {x})")
                        break
            raise ValueError(
                f"publish manifest field {f!r}: payload has "
                f"{theirs.get(f)!r}, subscriber expects {mine[f]!r}{detail}")


class Publisher:
    """Trainer-side: turn parameter trees into :class:`WeightUpdate`s.

    Stateful — owns the published-anchor buffers. One Publisher feeds any
    number of subscribers as long as they all apply every update in
    sequence (the manifest's ``seq``/``anchor_seq`` enforce it).
    """

    def __init__(self, params_like, cfg: PublishConfig = PublishConfig(),
                 device=None):
        self.wire = _WirePlan(params_like, cfg,
                              _device_of(params_like, device))
        self.cfg = cfg
        self._anchor: Optional[List[torch.Tensor]] = None
        self._seq = 0

    # -------------------------------------------------------------- #
    @torch.no_grad()
    def _encode(self, params, anchors, *, kind: str):
        wire = self.wire
        bufs = wire.bucketize(params)
        if kind == "snapshot":
            return [{"values": buf} for buf in bufs]
        payloads = []
        for buf, anchor, bkt in zip(bufs, anchors, wire.bp.buckets):
            delta = (buf - anchor)[None]
            payload, _ = wire.codec.encode_worker(
                delta, torch.zeros_like(delta), bkt.layout,
                wire.cfg.scale_mode)
            payloads.append({k: v[0] for k, v in payload.items()})
        return payloads

    def publish(self, params, step: int = 0,
                force_snapshot: bool = False) -> WeightUpdate:
        """Encode the current parameters as the next update in sequence."""
        exact = not self.wire.codec.needs_ef
        kind = "snapshot" if (exact or force_snapshot
                              or self._anchor is None
                              or self._seq % self.cfg.snapshot_every == 0
                              ) else "delta"
        payloads = self._encode(
            params, self._anchor if kind == "delta" else None, kind=kind)
        # a host copy of its own: a buffer may be a view of a live leaf
        payloads = [{k: v.to("cpu", memory_format=torch.contiguous_format,
                              copy=True).numpy() for k, v in p.items()}
                    for p in payloads]
        # advance the anchor by the decoded emitted payload, through the
        # subscriber's op sequence, so both sides hold the same bits and
        # the quantization error survives into the next delta
        self._anchor = self.wire.advance_anchors(self._anchor, payloads,
                                                 kind)
        manifest = self.wire.manifest_base()
        manifest.update(kind=kind, seq=self._seq,
                        anchor_seq=self._seq - 1 if kind == "delta" else None,
                        step=int(step),
                        payload_bytes=self.wire.wire_bytes(kind))
        self._seq += 1
        update = WeightUpdate(manifest=manifest, payloads=payloads)
        if update.nbytes() != manifest["payload_bytes"]:
            raise AssertionError(
                f"publish wire accounting drift: payload arrays carry "
                f"{update.nbytes()} bytes, codec.wire_bytes declares "
                f"{manifest['payload_bytes']}")
        return update

    @property
    def seq(self) -> int:
        return self._seq


class Subscriber:
    """Replica-side: decode :class:`WeightUpdate`s into parameter trees on
    ``device`` (default: that of ``params_like``'s tensors, CUDA for an
    abstract tree). ``push`` is the transport stub (an in-process queue);
    the scheduler drains it at a tick boundary."""

    def __init__(self, params_like, cfg: PublishConfig = PublishConfig(),
                 device=None):
        self.wire = _WirePlan(params_like, cfg,
                              _device_of(params_like, device))
        self.cfg = cfg
        self._anchor: Optional[List[torch.Tensor]] = None
        self._seq: Optional[int] = None
        self._pending: List[WeightUpdate] = []
        self._applied = 0

    # ------------------------------------------------------------------ #
    def push(self, update: WeightUpdate):
        self._pending.append(update)

    def has_pending(self) -> bool:
        return bool(self._pending)

    def apply_pending(self):
        """Apply every queued update in order; returns the final tree (or
        None if nothing was queued)."""
        params = None
        while self._pending:
            params = self.apply(self._pending.pop(0))
        return params

    # ------------------------------------------------------------------ #
    def _validate(self, manifest: Dict[str, Any]):
        _validate_manifest(self.wire.manifest_base(), manifest)
        kind = manifest.get("kind")
        if kind not in ("snapshot", "delta"):
            raise ValueError(
                f"publish manifest field 'kind': {kind!r} is not "
                f"'snapshot' or 'delta'")
        if kind == "delta":
            if self._anchor is None:
                raise ValueError(
                    "publish manifest field 'anchor_seq': got a delta "
                    "update but this subscriber holds no anchor yet "
                    "(no snapshot has been applied)")
            if manifest.get("anchor_seq") != self._seq:
                raise ValueError(
                    f"publish manifest field 'anchor_seq': delta applies "
                    f"to anchor seq {manifest.get('anchor_seq')!r} but "
                    f"this subscriber is at seq {self._seq!r} — updates "
                    f"must be applied in publish order")

    @torch.no_grad()
    def apply(self, update: WeightUpdate):
        """Validate + decode one update; returns the full parameter tree."""
        self._validate(update.manifest)
        nbytes = int(sum(a.nbytes for p in update.payloads
                         for a in p.values()))
        if nbytes != update.manifest["payload_bytes"]:
            raise ValueError(
                f"publish manifest field 'payload_bytes': declares "
                f"{update.manifest['payload_bytes']} but payload arrays "
                f"carry {nbytes} — truncated or tampered update")
        wire = self.wire
        self._anchor = wire.advance_anchors(self._anchor, update.payloads,
                                            update.kind)
        self._seq = update.seq
        self._applied += 1
        return wire.unbucketize(self._anchor)

    @property
    def seq(self) -> Optional[int]:
        return self._seq

    @property
    def applied(self) -> int:
        return self._applied


# ---------------------------------------------------------------------------
# File transport (same atomic-npz idiom as checkpointing.io)
# ---------------------------------------------------------------------------

def save_update(path: str, update: WeightUpdate):
    """Serialize one update to an npz (atomic rename, manifest as JSON)."""
    arrays = {}
    for k, payload in enumerate(update.payloads):
        for name, arr in payload.items():
            arrays[f"b{k}__{name}"] = np.asarray(arr)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __manifest__=json.dumps(update.manifest), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_update(path: str) -> WeightUpdate:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        payloads: List[Dict[str, np.ndarray]] = [
            {} for _ in range(int(manifest["n_buckets"]))]
        for key in z.files:
            if key == "__manifest__":
                continue
            bucket, name = key.split("__", 1)
            payloads[int(bucket[1:])][name] = z[key]
    return WeightUpdate(manifest=manifest, payloads=payloads)
