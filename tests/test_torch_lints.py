"""The port's AST lints (``repro_torch.analysis.lints``): the port's
package is clean, and each rule fires on a seeded offending file, with
the waiver comment and the allowed files as escape hatches. The
reference's rules hold for the port's files too (``tests/test_lints.py``
scans all of ``src/``)."""
import textwrap

import pytest

from repro.analysis.lints import run_lints as ref_run_lints

from repro_torch.analysis import lints as L
from repro_torch.analysis.lints import run_lints


def test_port_is_clean():
    findings = run_lints()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_is_clean_under_the_reference_rules():
    findings = ref_run_lints([str(L.Path(L.__file__).resolve().parents[1])])
    assert findings == [], "\n".join(str(f) for f in findings)


def _lint_snippet(tmp_path, code, name="offender.py"):
    f = tmp_path / name
    f.write_text(textwrap.dedent(code))
    return run_lints([str(f)])


@pytest.mark.parametrize("call", [
    "dist.all_reduce(x)", "dist.all_gather_into_tensor(out, x)",
    "dist.all_to_all_single(out, x)", "dist.broadcast(x, 0)",
    "dist.reduce_scatter_tensor(out, x)", "dist.isend(x, 1)",
    "torch.distributed.all_gather(xs, x)", "torch.distributed.recv(x, 0)"])
def test_raw_collective_rule(tmp_path, call):
    findings = _lint_snippet(tmp_path, f"""
        import torch
        import torch.distributed as dist

        def bad(x, xs, out):
            return {call}
    """)
    assert [f.rule for f in findings] == ["raw-collective"]
    assert call.split("(")[0] in findings[0].message
    assert findings[0].line == 6


def test_process_group_lifecycle_is_not_a_collective(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import torch.distributed as dist

        def up(rank):
            dist.init_process_group("gloo", rank=rank, world_size=2)
            dist.new_subgroups_by_enumeration([[0], [1]])
            print(dist.get_world_size(), dist.get_backend())
            dist.destroy_process_group()
    """)
    assert findings == []


def test_raw_collective_waiver(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import torch.distributed as dist

        def ok(x):
            return dist.all_reduce(x)  # audit-ok: raw-collective
    """)
    assert findings == []


def test_raw_collective_allowed_in_comm(tmp_path):
    comm_dir = tmp_path / "core"
    comm_dir.mkdir()
    f = comm_dir / "comm.py"
    f.write_text("import torch.distributed as dist\n\ndef psum(x):\n"
                 "    dist.all_reduce(x)\n    return x\n")
    assert run_lints([str(f)]) == []


def test_comm_view_reshape_rule(tmp_path):
    findings = _lint_snippet(tmp_path, """
        def bad(x, layout):
            return x.reshape((4,) + layout.chunk_shape)
    """)
    assert [f.rule for f in findings] == ["comm-view-reshape"]
    assert "chunk_shape" in findings[0].message


@pytest.mark.parametrize("path", ["core/compressor.py", "core/codecs.py",
                                  "core/onebit_allreduce.py",
                                  "core/bucketing.py", "kernels/dispatch.py",
                                  "elastic/reshard.py"])
def test_comm_view_reshape_allowed_files(tmp_path, path):
    f = tmp_path / path
    f.parent.mkdir(parents=True)
    f.write_text("def ok(x, layout):\n"
                 "    return x.reshape(layout.view_shape)\n")
    assert run_lints([str(f)]) == []


@pytest.mark.parametrize("expr", ["x.double()", "torch.float64",
                                  "torch.double",
                                  "torch.zeros(2, dtype=torch.float64)"])
def test_float64_literal_rule(tmp_path, expr):
    findings = _lint_snippet(tmp_path, f"""
        import torch

        def bad(x):
            return {expr}
    """)
    assert [f.rule for f in findings] == ["float64-literal"]


def test_float64_literal_waiver_and_lookalikes(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import numpy as np
        import torch

        def ok(x, y):
            a = x.double()  # audit-ok: float64-literal (exact emulation)
            b = np.float64(1.0) + np.zeros(2, np.float64).sum()
            return a, b, y.double(2), torch.float32
    """)
    assert findings == []


def test_statekind_rule_is_not_ported(tmp_path):
    """The port has no StateKind registry yet (ROADMAP): the rule is not
    part of the port's lints."""
    assert "statekind-registry" not in L._ALLOWED
    assert _lint_snippet(tmp_path, "k = StateKind('m')\n") == []


def test_syntax_error_is_a_finding(tmp_path):
    (f,) = _lint_snippet(tmp_path, "def broken(:\n")
    assert f.rule == "syntax"


def test_main_exit_codes(tmp_path, capsys):
    assert L.main([]) == 0
    assert "lints: clean" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nx = torch.float64\n")
    assert L.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[float64-literal]" in out and "1 lint finding(s)" in out
