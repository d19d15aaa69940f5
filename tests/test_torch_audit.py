"""The port's communication audit (``repro_torch.analysis.ir_audit``,
``repro_torch.launch.audit``) against the reference's declared
manifests, live, and its detection of seeded violations.

* Manifests: the port's ``expected_sync_schedule`` /
  ``expected_fullprec_schedule`` (shapes from its own encode helpers run
  on ``meta`` tensors) equal the reference's ``build_manifests`` entry
  for entry, exactly (the recorder's one shape rule applies to what is
  recorded, not to the manifests): the 12 entries of the audit matrix at
  gpt2-smoke, and gpt2 FULL flat, at 2 pods x 2 and at ``bucket_mb=25``
  under every codec. ``payload_spec`` equals the reference's per codec.
* ``frame_precheck`` is clean on the shipped layouts (gpt2 FULL and
  bert-base FULL, 4 stacked workers) and flags frames outside the CUDA
  kernels' launch contract.
* Recording: a ``RecordingComm`` leaves a trajectory bit for bit; the
  shape rule touches exactly the intra-pod broadcast entries; the
  optimizer state's dtypes after the audited steps equal the
  reference's, leaf for leaf.
* The audit: clean on the CPU for all 12 matrix entries, with the
  recorded bytes of each round equal to ``comm_accounting`` per level;
  each seeded violation (a smuggled inter-pod psum, a reordered
  manifest, a codec that lies about its payload dtype, a run that never
  syncs, an f64 operand) caught with the reference's code and a message
  naming the offender.
* Four gloo ranks (``rank_main(audit=True)``) each record the sequence
  of their simulated worker and pass the same checks; the CLI's exit
  codes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.analysis import build_manifests as ref_build_manifests
from repro.checkpointing import io as ref_io
from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import codecs as RCD
from repro.core import compressor as RC
from repro.core.comm import Hierarchy as RefHierarchy
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig

from repro_torch.analysis import ir_audit as IA
from repro_torch.configs.base import get
from repro_torch.core import api as TA
from repro_torch.core import bucketing as BK
from repro_torch.core import codecs as TCD
from repro_torch.core import compressor as C
from repro_torch.core.comm import Hierarchy, SimComm
from repro_torch.core.compressed import comm_accounting
from repro_torch.core.leafwise import flatten_tree
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.kernels import dispatch as KD
from repro_torch.kernels import onebit
from repro_torch.launch import audit as LA
from repro_torch.launch import mesh
from repro_torch.launch import train as TLAUNCH
from repro_torch.train.step import Trainer, TrainerConfig

torch.set_num_threads(1)

N = 4
MATRIX = list(LA._matrix(N))
MATRIX_IDS = [f"{m.get('optimizer', 'zero_one_adam')}-"
              f"{m.get('codec', 'sign1bit')}-h{m.get('hierarchy_inner', 0)}"
              f"-b{m.get('bucket_mb')}-mb{m.get('micro_batches', 1)}-"
              f"{m.get('pack_order', 'flat')}" for m in MATRIX]
CODECS = list(TCD.CODEC_NAMES)
FULL_CASES = {"flat": {}, "hier": {"hierarchy_inner": 2},
              "bucketed": {"bucket_mb": 25.0}}
SPAWN_TIMEOUT_S = 120.0


def _kw(entry):
    """(optimizer config kwargs, micro_batches) of a matrix entry."""
    kw = {k: v for k, v in entry.items()
          if k not in ("workers", "micro_batches")}
    inner = kw.pop("hierarchy_inner", 0)
    if "optimizer" in kw:
        kw["name"] = kw.pop("optimizer")
    return kw, inner, entry.get("micro_batches", 1)


def _pair(arch_cfg, ref_cfg, entry):
    """(reference trainer, port trainer) of one config; neither
    allocates parameters."""
    kw, inner, mb = _kw(entry)
    rt = RefTrainer(ref_cfg, RefOptimizerConfig(
        hierarchy=RefHierarchy(inner=inner) if inner else None, **kw),
        n_workers=N, trainer_cfg=RefTrainerConfig(micro_batches=mb))
    pt = Trainer(arch_cfg, TA.OptimizerConfig(
        hierarchy=Hierarchy(inner) if inner else None, **kw),
        comm=SimComm(N), trainer_cfg=TrainerConfig(mb), device="cpu")
    return rt, pt


def _assert_same_manifests(rt, pt):
    want = [[tuple(e) for e in m] for m in ref_build_manifests(rt.opt)]
    got = [[tuple(e) for e in m] for m in IA.build_manifests(pt.opt)]
    for name, w, g in zip(("sync", "fullprec"), want, got):
        assert len(g) == len(w), (name, len(g), len(w))
        for a, b in zip(g, w):
            assert a == b, (name, a, b)
    return got


# --------------------------------------------------------------------- #
# declared manifests against the reference
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("entry", MATRIX, ids=MATRIX_IDS)
def test_manifests_match_reference_smoke(entry):
    rt, pt = _pair(get("gpt2").smoke, ref_get("gpt2").smoke, entry)
    sync, fullprec = _assert_same_manifests(rt, pt)
    assert fullprec
    assert bool(sync) == (entry.get("optimizer") != "adam")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", list(FULL_CASES))
def test_manifests_match_reference_full(case, codec):
    rt, pt = _pair(get("gpt2").config, ref_get("gpt2").config,
                   dict(codec=codec, **FULL_CASES[case]))
    sync, _ = _assert_same_manifests(rt, pt)
    per_unit = (2 * len(TCD.make_codec(codec).payload_spec(None)["scatter"])
                + 2 * (case == "hier"))
    assert len(sync) == per_unit * len(pt.opt.units)


@pytest.mark.parametrize("codec", CODECS + ["topk@0.05"])
def test_payload_spec_matches_reference(codec):
    name, _, arg = codec.partition("@")
    arg = float(arg) if arg else None
    lo_ref, lo = RC.make_layout((4096,), None, N), C.make_layout((4096,),
                                                                 None, N)
    want = RCD.make_codec(name, arg).payload_spec(lo_ref)
    got = TCD.make_codec(name, arg).payload_spec(lo)
    assert list(got) == list(want) == ["scatter", "gather"]
    for phase in want:
        assert [(n, BK.dtype_name(d)) for n, d in got[phase]] == [
            (n, np.dtype(d).name) for n, d in want[phase]]


def test_payload_spec_order_is_the_emission_order():
    """A codec whose payload leaves come out in another order than its
    declaration is refused when the manifest is built."""
    class Unsorted(TCD.Sign1BitCodec):
        def payload_spec(self, layout):
            leaves = (("scales", torch.float32), ("packed", torch.uint8))
            return {"scatter": leaves, "gather": leaves}

    pt = Trainer(get("gpt2").smoke, TA.OptimizerConfig(codec=Unsorted()),
                 comm=SimComm(N), device="cpu")
    with pytest.raises(ValueError, match="payload_spec names"):
        IA.build_manifests(pt.opt)


# --------------------------------------------------------------------- #
# the frame pre-check against the CUDA kernels' launch contract
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
@pytest.mark.parametrize("case", list(FULL_CASES))
def test_frame_precheck_clean_on_shipped_layouts(arch, case):
    _, pt = _pair(get(arch).config, ref_get(arch).config, FULL_CASES[case])
    for lo, _, label in BK.exchange_units(pt.opt.plan, pt.opt.bucket_plan):
        assert KD.frame_precheck(lo, stack=N) == [], label


def test_frame_precheck_flags_bad_frames(monkeypatch):
    # flatten layouts pad to the n*128 quantum: clean
    assert KD.frame_precheck(C.make_layout((4096,), None, N)) == []
    # a structured view 12 wide: sign bits do not fill whole bytes
    lo = C.LeafLayout(shape=(8, 12), n=N, flatten=False, split_axis=0,
                      padded=8, view_shape=(N, 2, 12))
    issues = KD.frame_precheck(lo)
    assert any("multiple of 8" in i for i in issues), issues
    # a flatten view off the 128-element quantum
    lo = C.LeafLayout(shape=(400,), n=N, flatten=True, split_axis=0,
                      padded=400, view_shape=(N, 100))
    assert any("quantum" in i for i in KD.frame_precheck(lo))
    # a stack of 2**21 frames of 4 x 1024 (n4 = 2**31): ef_quantize
    # launches it in slabs of whole scale groups, so only one worker's
    # frame of n4 >= 2**31 float4 is refused (2**31 elements x 4 rows)
    big = C.make_layout((4096,), None, N)
    assert KD.frame_precheck(big, stack=2 ** 21) == []
    assert any("decompress" in i
               for i in KD.frame_precheck(big, stack=2 ** 22))
    wide = C.LeafLayout(shape=(8, 2 ** 30), n=N, flatten=False,
                        split_axis=0, padded=8, view_shape=(N, 2, 2 ** 30))
    assert any("one worker's frame (8, 1073741824) holds n4=2147483648" in i
               for i in KD.frame_precheck(wide)), KD.frame_precheck(wide)
    # ef_compress's columns and shared memory: a block keeping 64 Ki
    # columns needs 256 KiB, above the 227 KB a block may opt in to
    wide = C.LeafLayout(shape=(8, 2 ** 20), n=N, flatten=False,
                        split_axis=0, padded=8, view_shape=(N, 2, 2 ** 20))
    assert KD.frame_precheck(wide) == []
    monkeypatch.setattr(onebit, "EF_KEPT_COLS", 65536)
    issues = KD.frame_precheck(wide)
    assert any("262144 B of dynamic shared memory" in i and "232448" in i
               for i in issues), issues
    huge = C.LeafLayout(shape=(8, 2 ** 28), n=N, flatten=False,
                        split_axis=0, padded=8, view_shape=(N, 2, 2 ** 28))
    assert any("2**28" in i for i in KD.frame_precheck(huge))


# --------------------------------------------------------------------- #
# recording
# --------------------------------------------------------------------- #

def _batches(cfg, steps, batch=N, seq=16, seed=0):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed),
                       device="cpu")
    return [data.batch(t) for t in range(steps)]


def _trainer(comm=None, **kw):
    """gpt2-smoke sim trainer under the audit's schedule (launch.audit)."""
    opt = dataclasses.replace(TLAUNCH.build_opt_cfg(TLAUNCH.parse_args(
        ["--arch", "gpt2", *LA.SCHEDULE])), **kw)
    return Trainer(get("gpt2").smoke, opt,
                   comm=comm if comm is not None else SimComm(N),
                   device="cpu")


def _run(tr, steps=LA.STEPS):
    params, state = tr.init(0)
    batches = _batches(tr.model_cfg, steps)
    for b in batches:
        params, state, _ = tr.step(params, state, b)
    return params, state


def test_recording_comm_is_bitwise_transparent():
    """Four steps (syncs and variance rounds, 2 pods x 2) with and without
    the recorder: the same params and state, bit for bit."""
    plain = _run(_trainer(hierarchy=Hierarchy(2)), 4)
    tr = _trainer(IA.RecordingComm(SimComm(N)), hierarchy=Hierarchy(2))
    rec = _run(tr, 4)
    for a, b in zip(flatten_tree(plain[0])[1], flatten_tree(rec[0])[1]):
        assert torch.equal(a, b)
    for a, b in zip(plain[1].err_w + plain[1].slots["v"],
                    rec[1].err_w + rec[1].slots["v"]):
        assert torch.equal(a, b)
    levels = {c.level for c in tr.comm.log}
    assert levels == {"inner", "outer"}, levels


def test_split_levels_are_cached_and_tagged():
    rc = IA.RecordingComm(SimComm(N))
    outer, inner = rc.split(2)
    assert rc.split(2) == (outer, inner)
    assert (outer.level, inner.level) == ("outer", "inner")
    assert outer.book is inner.book is rc.book
    assert (outer.size(), inner.size()) == (2, 2)
    x = torch.arange(N * 6, dtype=torch.float32).reshape(N, 2, 3)
    assert torch.equal(inner.all_gather(x), rc.split(2)[1].comm.all_gather(x))
    (c,) = rc.log
    # the shape rule: an intra-pod gather gains a leading unit dim
    assert (c.op, c.level, c.shape, c.elems, c.nbytes) == (
        "all_gather", "inner", (1, 2, 3), 6, 24)
    assert c.sent_bytes == 24


def test_shape_rule_touches_only_the_broadcast_entries():
    """The rule (an inner all_gather recorded with a leading 1) applies to
    exactly the manifests' intra-pod broadcast entries: the port's operand
    there is (n_outer, *chunk), the reference's (1, n_outer, *chunk); no
    other entry is an inner all_gather."""
    tr = _trainer(IA.RecordingComm(SimComm(N)), hierarchy=Hierarchy(2),
                  bucket_mb=4.0)
    sync, fullprec = IA.build_manifests(tr.opt)
    touched = [e for e in sync + fullprec
               if e.op == "all_gather" and e.level == "inner"]
    assert touched == [e for e in sync + fullprec if e.phase == "broadcast"]
    assert len(touched) == 2 * len(tr.opt.units)
    for e in touched:
        lo = tr.opt.units[e.unit].layout
        assert e.shape == (1, lo.n_outer) + lo.chunk_shape
    trace = IA.trace_collectives(tr, *tr.init(0), _batches(tr.model_cfg, 1))
    gathered = [c for c in trace.collectives
                if c.op == "all_gather" and c.level == "inner"]
    assert [c.shape for c in gathered] == [e.shape for e in touched]


def test_state_dtypes_match_reference():
    tr = _trainer()
    trace = IA.trace_collectives(tr, *tr.init(0), _batches(tr.model_cfg, 2))
    rt = RefTrainer(ref_get("gpt2").smoke, RefOptimizerConfig(),
                    n_workers=N)
    _, rs = rt.sim_init(jax.random.PRNGKey(0))
    want = list(zip(ref_io.leaf_paths(rs),
                    [np.dtype(x.dtype).name for x in jax.tree.leaves(rs)]))
    assert trace.state_dtypes == want
    assert IA.check_dtypes(trace) == []


# --------------------------------------------------------------------- #
# the audit: clean passes and seeded violations
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("entry", MATRIX, ids=MATRIX_IDS)
def test_clean_audit_matrix(entry):
    kw = dict(entry)
    rec = LA.audit_one("gpt2", device="cpu", **kw)
    assert rec["ok"], (rec["violations"][:3], rec["frame_issues"][:3])
    s = rec["summary"]
    acct = s["accounting"]
    rounds = set(s["rounds"])
    if entry.get("optimizer") == "adam":
        assert rounds == {"fullprec"}
    elif entry.get("optimizer") == "one_bit_adam":
        assert rounds == {"fullprec", "sync"}
    else:
        assert rounds == {"sync+fullprec", "sync", "local-only"}
    for name, key in (("sync", "compressed_bytes_per_sync"),
                      ("fullprec", "fullprec_bytes_per_round")):
        got = s["recorded_bytes"].get(name)
        if got is None:
            continue
        assert (got["inner"], got["outer"]) == (acct[f"{key}_inner"],
                                                acct[f"{key}_outer"])
    if entry.get("hierarchy_inner"):
        assert s["interpod_sync_bytes"] > 0
        assert s["recorded_bytes"]["sync"]["outer"] < s["recorded_bytes"][
            "sync"]["inner"]


def _audit(tr, steps=LA.STEPS, **kw):
    return IA.audit_trainer(tr, *tr.init(0), _batches(tr.model_cfg, steps),
                            **kw)


def test_smuggled_interpod_psum_is_caught():
    tr = _trainer(hierarchy=Hierarchy(2))

    def wrap(step):
        def evil(params, state, batch):
            outer, _ = tr.comm.split(2)
            outer.psum(torch.zeros((N, 1024), dtype=torch.float32))
            return step(params, state, batch)
        return evil

    rep = _audit(tr, 3, wrap_step=wrap)
    assert not rep.ok
    codes = [v.code for v in rep.violations]
    assert "interpod-bytes" in codes, codes
    msg = next(v.message for v in rep.violations
               if v.code == "interpod-bytes")
    # names the op, the level it crossed, the dtype, and the position
    assert "psum" in msg and "outer" in msg and "float32" in msg
    assert "position 0 of step 0" in msg
    # the rest of each step still matches its manifests
    assert set(codes) <= {"interpod-bytes", "schedule"}
    assert codes.count("interpod-bytes") == 3


def test_reordered_schedule_is_caught():
    tr = _trainer(hierarchy=Hierarchy(2))
    trace = IA.trace_collectives(tr, *tr.init(0),
                                 _batches(tr.model_cfg, LA.STEPS))
    sync_m, fp_m = IA.build_manifests(tr.opt)
    sync_c = IA.concretize_manifest(sync_m, tr)
    fp_c = IA.concretize_manifest(fp_m, tr)
    # control: the unmodified manifests match
    assert IA.check_schedule(trace, sync_c, fp_c, tr) == []
    bad = list(sync_c)
    bad[2], bad[3] = bad[3], bad[2]
    vs = IA.check_schedule(trace, bad, fp_c, tr)
    assert vs and vs[0].code == "schedule"
    # names the position, the expected entry's unit/leaf, and the found
    # collective with its step
    assert "position 2" in vs[0].message
    assert "leaf[0]" in vs[0].message or "bucket[0]" in vs[0].message
    assert "step 0" in vs[0].message
    assert "leaf 'packed'" in vs[0].message


def test_payload_dtype_lie_is_caught():
    class LyingSign1Bit(TCD.Sign1BitCodec):
        def payload_spec(self, layout):
            leaves = (("packed", torch.uint8), ("scales", torch.float16))
            return {"scatter": leaves, "gather": leaves}

    rep = _audit(_trainer(codec=LyingSign1Bit()))
    assert not rep.ok
    assert {v.code for v in rep.violations} == {"payload-dtype"}
    msg = rep.violations[0].message
    # names the declared vs recorded dtype and the payload leaf
    assert "float16" in msg and "float32" in msg and "scales" in msg


@pytest.mark.parametrize("case", ["never_syncs", "never_local"])
def test_round_never_ran(case):
    """A run that never reaches a round its style declares is reported:
    1-bit Adam inside its 20 full-precision steps never runs the 1-bit
    sync; two steps of 0/1 Adam's warm-up never run a local-only step."""
    if case == "never_syncs":
        tr = _trainer(name="one_bit_adam", onebit_warmup=20)
        name = "sync"
    else:
        tr = _trainer()
        name = "local-only"
    rep = _audit(tr, 2)
    assert [v.code for v in rep.violations] == ["schedule"]
    assert f"the {name} round never ran in the 2 audited steps" in (
        rep.violations[0].message)


def test_float64_operand_is_caught():
    tr = _trainer()

    def wrap(step):
        def evil(params, state, batch):
            tr.comm.all_gather(torch.zeros((N, 1, 2), dtype=torch.float64))
            return step(params, state, batch)
        return evil

    rep = _audit(tr, 1, wrap_step=wrap)
    codes = [v.code for v in rep.violations]
    assert "f64" in codes and codes[0] == "schedule", codes
    assert any("float64" in v.message for v in rep.violations
               if v.code == "f64")
    # a gather the manifests do not hold breaks the step's sequence
    assert ("position 0: expected all_to_all on flat uint8"
            in rep.violations[0].message)
    assert "found all_gather on flat float64(1, 2)" in (
        rep.violations[0].message)


def test_recorded_bytes_reconcile_with_accounting(monkeypatch):
    """The flat full-precision headline is the ring over the true
    parameters; the recorded round sends the padded views (its _outer
    level exactly): F * P_padded == S * P_true."""
    tr = _trainer()
    rep = _audit(tr)
    acct = comm_accounting(tr.opt)
    s = rep.summary["recorded_bytes"]["fullprec"]["total"]
    padded = sum(int(np.prod(u.layout.view_shape)) for u in tr.opt.units)
    assert s == acct["fullprec_bytes_per_round_outer"]
    assert acct["fullprec_bytes_per_round"] * padded == s * acct["dp_params"]
    assert padded > acct["dp_params"]
    # a tampered accounting is a wire-bytes violation
    bad = dict(acct, compressed_bytes_per_sync_outer=acct[
        "compressed_bytes_per_sync_outer"] + 1)
    monkeypatch.setattr("repro_torch.core.compressed.comm_accounting",
                        lambda opt: bad)
    vs = IA.check_wire_bytes(tr.opt, tr.step.audit_trace)
    assert vs and {v.code for v in vs} == {"wire-bytes"}
    assert "sync round" in vs[0].message


# --------------------------------------------------------------------- #
# processes: each gloo rank records its simulated worker's sequence
# --------------------------------------------------------------------- #

ARGV = ["--arch", "gpt2", "--smoke", "--steps", str(LA.STEPS), "--batch",
        str(N), "--seq", "16", "--log-every", "1", "--device", "cpu",
        *LA.SCHEDULE]


RANK_RUNS = {"flat": [], "hier": ["--hierarchy", "2"]}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Both runs of RANK_RUNS in one spawn of N gloo ranks, one after
    another (``launch.train.rank_jobs``), each rank recording and
    auditing its collectives: name -> the directory of its rank files."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    dirs = {k: tmp_path_factory.mktemp(k) for k in RANK_RUNS}
    try:
        mesh.spawn(TLAUNCH.rank_jobs, N, ([
            (ARGV + extra + ["--mode", "dist"], str(dirs[k]), False, "lm",
             True, None) for k, extra in RANK_RUNS.items()], N),
            timeout_s=SPAWN_TIMEOUT_S * len(RANK_RUNS))
    finally:
        mp.undo()
    return dirs


@pytest.mark.parametrize("name", list(RANK_RUNS))
def test_gloo_ranks_record_their_workers_sequence(rank_runs, name):
    argv = ARGV + RANK_RUNS[name]
    args = TLAUNCH.parse_args(argv + ["--mode", "sim", "--workers", str(N)])
    tr = TLAUNCH.make_trainer(args, comm=IA.RecordingComm(SimComm(N)))
    trace = IA.watch(tr)
    TLAUNCH.train(args, tr)
    sim = IA.audit_trainer(tr, trace=trace)
    assert sim.ok, sim.violations[:3]
    want = [c.to_dict() for c in sim.collectives]
    for r in range(N):
        res = torch.load(rank_runs[name] / f"rank{r}.pt")
        assert res["audit"]["ok"], res["audit"]["violations"][:3]
        assert res["recorded"] == want, r
        assert res["audit"]["summary"]["recorded_bytes"] == (
            sim.summary["recorded_bytes"])


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #

def test_audit_cli_exit_codes(capsys, monkeypatch):
    assert LA.main(["--config", "gpt2", "--workers", "2", "--device",
                    "cpu"]) == 0
    out = capsys.readouterr().out
    assert "audit OK" in out and "AUDIT SUMMARY: 1/1 configs clean" in out

    def failing(arch, **kw):
        return {"ok": False, "config": dict(
            arch=arch, optimizer="zero_one_adam", codec="sign1bit",
            hierarchy_inner=0, bucket_mb=None, micro_batches=1,
            pack_order="flat"), "frame_issues": [], "violations": [
            {"code": "interpod-bytes",
             "message": "psum on outer float32(1024,)"}]}

    monkeypatch.setattr(LA, "audit_one", failing)
    assert LA.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "audit FAIL" in out and "[interpod-bytes]" in out
    assert "AUDIT SUMMARY: 0/1 configs clean" in out
    with pytest.raises(NotImplementedError, match="ROADMAP queue item 3"):
        LA.main(["--tp", "2", "--device", "cpu"])


def test_audit_cli_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LA.main(["--config", "gpt2"])
