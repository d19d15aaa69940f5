"""Checkpointing: atomic save/restore of (params, optimizer state, step)
trees, PyTorch port of ``src/repro/checkpointing/io.py``, in the same
file format, so either package restores the other's checkpoints.

Format (manifest ``version`` 2): one array entry per tree leaf
(``leaf_{i}`` in flatten order) plus a JSON ``__manifest__`` carrying the
step, user meta, leaf count, and per-leaf tree paths/shapes/dtypes.
``restore`` validates the checkpoint against the caller's ``like`` tree
and names the first mismatched leaf by its tree path. Version-1
checkpoints (no ``version`` / ``leaf_paths`` fields) stay readable.

Trees are flattened as jax flattens the reference's: dict keys sorted
(path ``['key']``), lists and tuples by position (``[i]``), named tuples
and dataclasses field by field (``.field``), ``None`` dropped; a leaf is
anything with a ``shape`` and a ``dtype`` (numpy arrays, torch tensors;
a tensor on the ``meta`` device serves as an abstract ``like`` leaf).
Paths and the ``treedef`` string are the ones jax writes for the same
tree. ``Trainer.checkpoint_tree`` gives the trainer's params and state in
this form.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

FORMAT_VERSION = 2


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _fields(node) -> List[Tuple[str, Any]]:
    """(name, child) of a named tuple or dataclass node, in field order."""
    if dataclasses.is_dataclass(node):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return list(zip(node._fields, node))


def _is_record(node) -> bool:
    return (dataclasses.is_dataclass(node) and not isinstance(node, type)
            ) or (isinstance(node, tuple) and hasattr(node, "_fields"))


def _flatten(tree, prefix: str, out: list) -> str:
    """Append (path, leaf) of ``tree`` to ``out``; return its treedef
    string in jax's notation."""
    if tree is None:
        return "None"
    if _is_leaf(tree):
        out.append((prefix, tree))
        return "*"
    if isinstance(tree, dict):
        parts = [f"{k!r}: {_flatten(tree[k], f'{prefix}[{k!r}]', out)}"
                 for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    if _is_record(tree):
        parts = [_flatten(v, f"{prefix}.{k}", out) for k, v in _fields(tree)]
        return (f"CustomNode(namedtuple[{type(tree).__name__}], "
                f"[{', '.join(parts)}])")
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, f"{prefix}[{i}]", out)
                 for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    raise TypeError(f"checkpoint tree node {type(tree).__name__} at "
                    f"{prefix!r} is neither a leaf nor a container")


def flatten(tree) -> Tuple[List[str], List[Any], str]:
    """(paths, leaves, treedef string) in flatten order."""
    out: list = []
    treedef = f"PyTreeDef({_flatten(tree, '', out)})"
    return [p for p, _ in out], [leaf for _, leaf in out], treedef


def unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_record(node):
            vals = {k: build(v) for k, v in _fields(node)}
            if dataclasses.is_dataclass(node):
                return dataclasses.replace(node, **vals)
            return type(node)(**vals)
        return type(node)(build(v) for v in node)

    return build(like)


def leaf_paths(tree) -> list:
    """Per-leaf tree-path strings in flatten order (jax ``keystr``)."""
    return flatten(tree)[0]


def _dtype_name(dtype) -> str:
    """numpy's name of a leaf's dtype (a torch dtype, a numpy dtype, or
    the manifest's string): ``float32``, ``bfloat16``, ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype      # numpy knows the name only beside ml_dtypes
    return np.dtype(dtype).name


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the file holds: a bf16 tensor as its raw
    2-byte records (``|V2``), what numpy writes for the reference's
    ``ml_dtypes`` bfloat16 arrays."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _from_file(a: np.ndarray, name: str):
    """An array read from the file as the leaf of dtype ``name``: a
    bf16 leaf (numpy has no bfloat16 of its own) as a torch tensor, bit
    for bit; any other as a numpy array of that dtype."""
    if name == "bfloat16":
        bits = np.array(a, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.asarray(a, dtype=np.dtype(name))


def save(path: str, tree: Any, step: int = 0, meta: Dict | None = None):
    paths, leaves, treedef = flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    names = [_dtype_name(l.dtype) for l in leaves]
    ordered = [arrays[f"leaf_{i}"] for i in range(len(leaves))]
    payload = {
        "version": FORMAT_VERSION,
        "step": step,
        "meta": meta or {},
        "treedef": treedef,
        "n_leaves": len(leaves),
        "leaf_paths": paths,
        "leaf_shapes": [list(a.shape) for a in ordered],
        "leaf_dtypes": names,
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __manifest__=json.dumps(payload), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_manifest(path: str) -> Dict:
    """The checkpoint's JSON manifest alone (step, meta, leaf geometry),
    no arrays read."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))


def restore(path: str, like: Any) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``like`` (numpy leaves; a bf16 leaf
    as a CPU tensor).

    The manifest is validated against ``like`` before anything is
    materialized: leaf count, per-leaf tree paths (version >= 2), per-leaf
    shapes, and per-leaf dtypes (version >= 2) must all match, and the
    first mismatch raises a ``ValueError`` naming the offending leaf's
    tree path, with the reference's texts."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        version = manifest.get("version", 1)
        if version > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has format version {version}; this "
                f"build reads up to version {FORMAT_VERSION}")
        like_paths, leaves_like, _ = flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, expected "
                f"{len(leaves_like)} — the optimizer/model structure does "
                f"not match the checkpoint. A common cause is restoring "
                f"state saved under a different comm layout, e.g. a "
                f"per-leaf checkpoint into a bucketed (bucket_mb /"
                f" --bucket-mb) config or vice versa: the bucketed "
                f"exchange stores EF state and anchors per bucket, so the "
                f"state tree differs — resume with the layout the run was "
                f"saved under")
        ckpt_paths = manifest.get("leaf_paths")
        if ckpt_paths is not None:
            for i, (cp, lp) in enumerate(zip(ckpt_paths, like_paths)):
                if cp != lp:
                    raise ValueError(
                        f"checkpoint leaf {i} is {cp!r} but the target "
                        f"tree has {lp!r} at that position — tree "
                        f"structures diverge")
        shapes = manifest.get("leaf_shapes")
        dtypes = manifest.get("leaf_dtypes")
        meta_n = (manifest.get("meta") or {}).get("n_workers")
        out = []
        for i, ref in enumerate(leaves_like):
            name = (ckpt_paths[i] if ckpt_paths is not None
                    else like_paths[i])
            stored = tuple(z[f"leaf_{i}"].shape)
            shape = tuple(shapes[i]) if shapes is not None else stored
            ref_shape = tuple(ref.shape)
            ref_dtype = _dtype_name(ref.dtype)
            if shape != ref_shape:
                if (meta_n and shape and ref_shape
                        and shape[0] == meta_n and ref_shape[0] != meta_n):
                    raise ValueError(
                        f"leaf {i} ({name!r}): checkpoint shape {shape} != "
                        f"expected {ref_shape} — the checkpoint was saved "
                        f"at DP width n={meta_n} but the target tree is "
                        f"laid out for m={ref_shape[0]} workers. A width "
                        f"change re-chunks every comm view; restore "
                        f"through repro_torch.elastic (restore_resharded, "
                        f"or reshard(state, n->m)) instead of loading the "
                        f"manifest directly")
                raise ValueError(
                    f"leaf {i} ({name!r}): checkpoint shape {shape} != "
                    f"expected {ref_shape}")
            if stored != shape:
                raise ValueError(
                    f"leaf {i} ({name!r}): stored array shape {stored} != "
                    f"manifest shape {shape} — corrupt checkpoint")
            if dtypes is not None and _dtype_name(dtypes[i]) != ref_dtype:
                raise ValueError(
                    f"leaf {i} ({name!r}): checkpoint dtype {dtypes[i]} != "
                    f"expected {ref_dtype} — restoring "
                    f"would silently cast optimizer state; rebuild the "
                    f"target tree with the checkpoint's dtypes (e.g. the "
                    f"state_dtype the run was saved under) or re-save")
            out.append(_from_file(z[f"leaf_{i}"], ref_dtype))
    return unflatten(like, out), manifest["step"], manifest["meta"]


def latest(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir) if f.endswith(".npz")]
    if not cands:
        return None
    return os.path.join(ckpt_dir, sorted(cands)[-1])
