"""AST-level repo-invariant lints of the port (stdlib only), PyTorch port
of ``src/repro/analysis/lints.py``.

Rules, each an invariant the communication audit relies on:

``raw-collective``
    a ``torch.distributed`` collective (``dist.all_reduce``,
    ``all_gather``, ``all_gather_into_tensor``, ``all_to_all``,
    ``all_to_all_single``, ``reduce_scatter``, ``reduce_scatter_tensor``,
    ``broadcast``, ``send``/``recv``/``isend``/``irecv``) called outside
    ``core/comm.py``. Every collective goes through a :class:`Comm`, the
    one choke point the audit's ``RecordingComm`` sees. (The process
    group's lifecycle, ``init_process_group`` and the like, is not a
    collective.)
``comm-view-reshape``
    ``.reshape(...)`` fed a ``LeafLayout`` shape attribute
    (``view_shape`` / ``slice_shape`` / ``chunk_shape`` /
    ``ef_worker_shape``) outside the core modules that own the layout
    contract: hand-rolled view reshapes bypass the pad-exact helpers.
``statekind-registry``
    ``StateKind(...)`` constructed outside ``core/compressed.py`` (the
    registry, ``ComposedOptimizer.state_kinds``). Generic code derives
    state shapes and placements from these tags; an ad-hoc tag would
    silently mis-place state.
``float64-literal``
    ``torch.float64``, ``torch.double`` or a ``.double()`` call: the step
    stays f64-free (the audit checks the recorded side; this catches it
    at the source). The exact-rounding emulation of the kernels' plain
    versions is f64 by design, each line waived.

A finding is waived by an inline ``# audit-ok: <rule>`` comment on the
offending line. Run as ``python -m repro_torch.analysis.lints [paths...]``
(non-zero exit on findings) or via :func:`run_lints` from tests.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path
from typing import List, Optional, Sequence

_COLLECTIVE_NAMES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "send", "recv", "isend", "irecv",
}
_DIST_PREFIXES = ("dist.", "torch.distributed.")
_VIEW_SHAPE_ATTRS = {
    "view_shape", "slice_shape", "chunk_shape", "ef_worker_shape",
}
_F64_NAMES = ("torch.float64", "torch.double")

# files allowed to break a rule without a waiver comment (relative to the
# package, forward slashes)
_ALLOWED = {
    "raw-collective": ("core/comm.py",),
    "comm-view-reshape": ("core/compressor.py", "core/onebit_allreduce.py",
                          "core/bucketing.py", "core/codecs.py",
                          "kernels/dispatch.py", "elastic/reshard.py"),
    "statekind-registry": ("core/compressed.py",),
    "float64-literal": (),
}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _is_allowed(rule: str, path: str) -> bool:
    p = path.replace("\\", "/")
    return any(p.endswith(suffix) for suffix in _ALLOWED[rule])


def _attr_chain(node) -> Optional[str]:
    """Dotted name of an attribute chain ('torch.distributed.all_reduce'),
    or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_view_attr(node) -> Optional[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _VIEW_SHAPE_ATTRS:
            return sub.attr
    return None


def _lint_source(path: str, src: str) -> List[LintFinding]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintFinding("syntax", path, e.lineno or 0, str(e))]
    lines = src.splitlines()

    def waived(rule: str, lineno: int) -> bool:
        if 1 <= lineno <= len(lines):
            return f"audit-ok: {rule}" in lines[lineno - 1]
        return False

    out: List[LintFinding] = []

    def add(rule, lineno, msg):
        if not _is_allowed(rule, path) and not waived(rule, lineno):
            out.append(LintFinding(rule, path, lineno, msg))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain:
                tail = chain.rsplit(".", 1)[-1]
                if tail in _COLLECTIVE_NAMES and chain.startswith(
                        _DIST_PREFIXES):
                    add("raw-collective", node.lineno,
                        f"raw collective {chain}() - route it through "
                        f"core.comm.Comm")
                if tail == "reshape":
                    attr = _mentions_view_attr(node)
                    if attr:
                        add("comm-view-reshape", node.lineno,
                            f".reshape(...{attr}...) - use the LeafLayout "
                            f"view helpers in core.compressor")
            if isinstance(node.func, ast.Name) \
                    and node.func.id == "StateKind":
                add("statekind-registry", node.lineno,
                    "StateKind(...) constructed outside the registry "
                    "(core/compressed.py)")
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "double" and not node.args):
                add("float64-literal", node.lineno,
                    ".double() - the train step must stay f64-free")
        elif isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                               "double"):
            chain = _attr_chain(node)
            if chain in _F64_NAMES:
                add("float64-literal", node.lineno,
                    f"bare {chain} - the train step must stay f64-free")
    return out


_DEFAULT_ROOTS = ("src/repro_torch",)


def run_lints(paths: Optional[Sequence[str]] = None,
              root: Optional[str] = None) -> List[LintFinding]:
    """Lint ``paths`` (files or directories; default: the port's package
    ``src/repro_torch`` under ``root`` or the import location)."""
    if root is None:
        # .../src/repro_torch/analysis/lints.py -> repo root
        root = str(Path(__file__).resolve().parents[3])
    targets: List[Path] = []
    for p in (paths or [str(Path(root) / r) for r in _DEFAULT_ROOTS]):
        pp = Path(p)
        if pp.is_dir():
            targets.extend(sorted(pp.rglob("*.py")))
        elif pp.suffix == ".py":
            targets.append(pp)
    out: List[LintFinding] = []
    for t in targets:
        out.extend(_lint_source(str(t), t.read_text()))
    return out


def main(argv=None) -> int:
    findings = run_lints(argv if argv else None)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} lint finding(s)")
        return 1
    print("lints: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
