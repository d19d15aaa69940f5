"""The port's checkpoints (``repro_torch.checkpointing.io``,
``Trainer.save``/``restore``, ``--save``) against the reference's, live.

* The file: the manifest (paths, shapes, dtypes, the treedef string,
  step, meta) is the one the reference's ``io.save`` writes for the same
  gpt2-smoke trainer tree, in sim and single mode, per leaf and
  bucketed, under every optimizer style, and under ``zero_one_lamb``
  (its trust slot: one scalar per worker and leaf in sim mode, a ()
  array in single mode).
* Validation: each of the reference's ``ValueError``s, raised by both
  packages on the same files with the same text (the width mismatch
  names ``repro_torch.elastic`` where the reference's names
  ``repro.elastic``).
* Across packages: a reference checkpoint (taken after 4 steps)
  restores into the port, a port checkpoint into the reference
  (``io.restore(path, like=jax.eval_shape(tr.sim_init, ...))``), and
  each package continues for 4 steps against the other package's
  continuation of the same file, at lr 3e-4 (the rate of
  ``test_torch_dist.py``): losses within 1e-5 (measured worst 2.4e-6:
  the two forward passes differ by ~5e-7 on the logits), at least 99.9%
  of params within 1e-6 and all within 0.05, the slice bars of
  ``test_torch_slice.py`` tightened. Measured: all params within 1.2e-7
  in five of the six continuations; in the per-leaf one from the
  reference's file a near-zero ``u + err`` flips its sign bit between
  the packages, and 99.951% of params are within 1e-6, the worst 3.2e-3
  off. An elementwise ``_close`` (relative to each leaf's largest
  magnitude) does not hold here: the attention biases start at zero and
  stay near it, so their ~1e-8 differences are 1% of their largest
  magnitude.
* Resuming inside the port is bit for bit the uninterrupted run.
* MoE (llama4-smoke, deepseek-smoke, 4 simulated workers, EP 4): a
  trainer's file after two steps, written by either package and read by
  the other, every leaf (the expert blocks, which the state keeps
  without EF state, anchor or ``u``) bit for bit.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import io as ref_io
from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import schedules as RS
from repro.core.comm import Hierarchy as RefHierarchy
from repro.train import Trainer as RefTrainer

from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import Hierarchy, NullComm, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.data import synthetic as TD
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import step as TSTEP

torch.set_num_threads(1)

N, STEPS, B, S = 4, 8, 8, 32
LR = 3e-4
CASES = {"per_leaf": {}, "bucketed": {"bucket_mb": 4.0},
         "bucketed_hier": {"bucket_mb": 4.0, "inner": 2},
         "one_bit_adam": {"name": "one_bit_adam"},
         "adam": {"name": "adam"},
         "zero_one_lamb": {"name": "zero_one_lamb"}}
ARGV = ["--arch", "gpt2", "--smoke", "--batch", str(B), "--seq", str(S),
        "--sync-warmup", "2", "--double-every", "2", "--kappa", "1",
        "--lr", "3e-4", "--log-every", str(STEPS), "--onebit-warmup", "2",
        "--device", "cpu"]


def _cfgs(name="zero_one_adam", inner=None, bucket_mb=None):
    ref = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(LR),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2), onebit_warmup=2,
        hierarchy=RefHierarchy(inner=inner) if inner else None,
        bucket_mb=bucket_mb)
    port = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(LR),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), onebit_warmup=2,
        hierarchy=Hierarchy(inner) if inner else None, bucket_mb=bucket_mb)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref_trainer(case, single=False):
    """The reference's gpt2-smoke trainer of ``case``, made once: the
    manifest and continue cases share it and its jitted step."""
    return RefTrainer(ref_get("gpt2").smoke, _cfgs(**CASES[case])[0],
                      n_workers=1 if single else N)


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    return _ref_trainer(case).sim_step_fn()


def _port_trainer(case, single=False):
    return TSTEP.Trainer(port_get("gpt2").smoke, _cfgs(**CASES[case])[1],
                         comm=NullComm() if single else SimComm(N),
                         device="cpu")


def _trainers(case, single=False):
    return _ref_trainer(case, single), _port_trainer(case, single)


def _batches():
    data = TD.SyntheticLM(TD.DataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    return [data.batch(t) for t in range(STEPS)]


def _ref_batch(b):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()}


def _manifest(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))


# --------------------------------------------------------------------- #
# the file
# --------------------------------------------------------------------- #

# single mode has one worker, so no pods
MANIFEST_CASES = [(case, single) for case in CASES for single in (False, True)
                  if not (single and "inner" in CASES[case])]


@pytest.mark.parametrize("case,single", MANIFEST_CASES,
                         ids=[f"{c}-{'single' if s else 'sim'}"
                              for c, s in MANIFEST_CASES])
def test_manifest_equals_reference(case, single, tmp_path):
    rt, pt = _trainers(case, single)
    key = jax.random.PRNGKey(0)
    # jitted: one compile, not an eager dispatch of every init op
    rp, rs = jax.jit(rt.single_init if single else rt.sim_init)(key)
    ref_path, port_path = tmp_path / "ref.npz", tmp_path / "port.npz"
    meta = {"arch": "gpt2-smoke", "n_workers": 1 if single else N}
    ref_io.save(str(ref_path), {"params": rp, "state": rs}, step=3,
                meta=meta)
    params, state = pt.init(0)
    pt.save(str(port_path), params, state, step=3, meta=meta)
    want, got = _manifest(ref_path), _manifest(port_path)
    assert list(got) == list(want)
    assert got == want
    n_units = 15 if "bucket_mb" in CASES[case] else 19
    if case in ("per_leaf", "bucketed") and not single:
        assert got["n_leaves"] == {19: 139, 15: 127}[n_units]
    for p in ("['params']['blocks']['attn']['bk']", "['state'].step",
              "['state'].slots['m'][5]", "['state'].err_w[14]"):
        if case != "adam":
            assert p in got["leaf_paths"]
    # the reference's init is the port's for the same draw: the state
    # leaves (params come from two generators) hold the same values
    with np.load(ref_path) as a, np.load(port_path) as b:
        for i, path in enumerate(want["leaf_paths"]):
            if path.startswith("['state']") and "anchor" not in path:
                np.testing.assert_array_equal(a[f"leaf_{i}"],
                                              b[f"leaf_{i}"], err_msg=path)


def test_latest_and_read_manifest(tmp_path):
    assert port_io.latest(str(tmp_path / "none")) is None
    assert port_io.latest(str(tmp_path)) is None
    for step in (3, 12):
        port_io.save(str(tmp_path / f"ck_{step:04d}.npz"),
                     {"a": np.ones((2,), np.float32)}, step=step,
                     meta={"arch": "x"})
    latest = port_io.latest(str(tmp_path))
    assert latest.endswith("ck_0012.npz")
    assert port_io.read_manifest(latest) == ref_io.read_manifest(latest)
    assert port_io.read_manifest(latest)["step"] == 12
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# --------------------------------------------------------------------- #
# validation: the reference's errors, word for word
# --------------------------------------------------------------------- #

def _tree(**shapes):
    return {k: np.zeros(s, np.float32) for k, s in shapes.items()}


def _v1(path, tree, step=11):
    leaves = [tree[k] for k in sorted(tree)]
    payload = {"step": step, "meta": {"arch": "x"}, "treedef": "",
               "n_leaves": len(leaves)}
    with open(path, "wb") as f:
        np.savez(f, __manifest__=json.dumps(payload),
                 **{f"leaf_{i}": l for i, l in enumerate(leaves)})


def _tampered(path, tree, **manifest):
    """A file whose manifest fields are overridden (a payload that no
    longer matches its manifest, or a future version)."""
    port_io.save(path, tree)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
        man = json.loads(str(z["__manifest__"]))
    man.update(manifest)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=json.dumps(man), **arrays)


VALIDATION = {
    # name: (write(path), like tree, expected fragment)
    "count": (lambda p: port_io.save(p, _tree(a=(2,), b=(2,))),
              _tree(a=(2,)), "2 leaves, expected 1"),
    "path": (lambda p: port_io.save(p, _tree(a=(2,), b=(3,))),
             _tree(a=(2,), z=(3,)), "tree structures diverge"),
    "shape": (lambda p: port_io.save(p, {"a": _tree(a=(2, 3))["a"],
                                         "b": _tree(c=(4,))}),
              {"a": _tree(a=(2, 3))["a"], "b": _tree(c=(5,))},
              "(4,) != expected (5,)"),
    "dp_width": (lambda p: port_io.save(p, _tree(a=(4, 6)),
                                        meta={"n_workers": 4}),
                 _tree(a=(2, 6)), "saved at DP width n=4"),
    "corrupt": (lambda p: _tampered(p, _tree(a=(2, 3)),
                                    leaf_shapes=[[3, 2]]),
                _tree(a=(3, 2)), "corrupt checkpoint"),
    "dtype": (lambda p: port_io.save(p, _tree(a=(2,))),
              {"a": np.zeros(2, np.int32)}, "would silently cast"),
    "future": (lambda p: _tampered(p, _tree(a=(1,)),
                                   version=port_io.FORMAT_VERSION + 1),
               _tree(a=(1,)), "format version 3"),
    "v1_shape": (lambda p: _v1(p, _tree(a=(2, 3))), _tree(a=(3, 3)),
                 "checkpoint shape (2, 3) != expected (3, 3)"),
}


@pytest.mark.parametrize("kind", list(VALIDATION))
def test_validation_errors_are_the_references(kind, tmp_path):
    write, like, fragment = VALIDATION[kind]
    path = str(tmp_path / "ck.npz")
    write(path)
    with pytest.raises(ValueError) as ref_err:
        ref_io.restore(path, jax.tree.map(jnp.asarray, like))
    with pytest.raises(ValueError) as port_err:
        port_io.restore(path, like)
    want = str(ref_err.value)
    if kind == "dp_width":
        # the width change restores through the port's own elastic package
        want = want.replace("repro.elastic", "repro_torch.elastic")
        assert want != str(ref_err.value)
    assert str(port_err.value) == want
    assert fragment in str(port_err.value)


def test_version1_checkpoints_restore_in_both(tmp_path):
    path = str(tmp_path / "v1.npz")
    tree = {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3)}
    _v1(path, tree)
    got, step, meta = port_io.restore(path, tree)
    assert (step, meta) == (11, {"arch": "x"})
    np.testing.assert_array_equal(got["a"], tree["a"])


@pytest.mark.parametrize("saved,target", [("per_leaf", "bucketed"),
                                          ("bucketed", "per_leaf")])
def test_layout_mismatch_names_bucket_mb(saved, target, tmp_path):
    """A per-leaf checkpoint into a bucketed trainer (or the reverse)
    fails with the reference's hint, in both packages."""
    path = str(tmp_path / "ck.npz")
    _, pt = _trainers(saved)
    pt.save(path, *pt.init(0), step=1)
    rt, pt2 = _trainers(target)
    with pytest.raises(ValueError, match="bucket_mb") as port_err:
        pt2.restore(path)
    like = jax.eval_shape(lambda: dict(zip(
        ("params", "state"), rt.sim_init(jax.random.PRNGKey(0)))))
    with pytest.raises(ValueError) as ref_err:
        ref_io.restore(path, like)
    assert str(port_err.value) == str(ref_err.value)


def test_restore_refuses_disagreeing_worker_scalars(tmp_path):
    path = str(tmp_path / "ck.npz")
    _, pt = _trainers("per_leaf")
    tree = pt.checkpoint_tree(*pt.init(0))
    tree["state"].step = np.array([3, 3, 4, 3], np.int32)
    port_io.save(path, tree, step=3)
    with pytest.raises(ValueError, match="step differs across workers"):
        pt.restore(path)


def test_dist_mode_save_raises():
    with pytest.raises(NotImplementedError, match="--mode dist"):
        TLAUNCH.main(ARGV + ["--steps", "1", "--mode", "dist", "--workers",
                             "2", "--save", "unused.npz"])


# --------------------------------------------------------------------- #
# across packages: restore and continue
# --------------------------------------------------------------------- #

def _ref_like(rt):
    return jax.eval_shape(lambda: dict(zip(
        ("params", "state"), rt.sim_init(jax.random.PRNGKey(0)))))


@pytest.mark.parametrize("case", ["per_leaf", "bucketed", "bucketed_hier",
                                  "zero_one_lamb"])
def test_checkpoints_cross_packages_and_continue(case, tmp_path):
    """Steps 0-3 in each package from one draw, a checkpoint of each; the
    port continues steps 4-7 from the reference's file and the reference
    from the port's, each against the other package continuing its own
    file."""
    rt, pt = _trainers(case)
    batches = _batches()
    ref_step = _ref_step(case)
    params, state = pt.init(0)
    # a copy: the port's step updates params in place, and jax may alias
    # a numpy buffer on the CPU
    rp = jax.tree.map(lambda x: jnp.asarray(np.array(x.numpy())), params)
    rs = jax.vmap(lambda i: rt.opt.init(jax.tree.map(lambda x: x[i], rp)))(
        jnp.arange(N))
    for t in range(4):
        rp, rs, _ = ref_step(rp, rs, _ref_batch(batches[t]))
        params, state, _ = pt.step(params, state, batches[t])
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "p.npz")
    meta = {"arch": "gpt2-smoke", "n_workers": N}
    ref_io.save(ref_path, {"params": rp, "state": rs}, step=4, meta=meta)
    pt.save(port_path, params, state, step=4, meta=meta)

    def port_continues(path):
        p, s, step, got_meta = pt.restore(path)
        assert (step, got_meta) == (4, meta) and s.step == 4
        losses = []
        for t in range(4, STEPS):
            p, s, m = pt.step(p, s, batches[t])
            losses.append(m["losses"].numpy())
        return np.stack(losses), [x.numpy() for x in flatten_tree(p)[1]]

    def ref_continues(path):
        tree, step, _ = ref_io.restore(path, _ref_like(rt))
        p, s = tree["params"], tree["state"]
        assert step == 4
        losses = []
        for t in range(4, STEPS):
            p, s, m = ref_step(p, s, _ref_batch(batches[t]))
            losses.append(np.asarray(m["loss"]))
        return np.stack(losses), [np.asarray(x) for x in jax.tree.leaves(p)]

    for path in (ref_path, port_path):
        (pl, pp), (rl, rpp) = port_continues(path), ref_continues(path)
        np.testing.assert_allclose(pl.mean(1), rl[:, 0], rtol=0, atol=1e-5)
        d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(pp, rpp)])
        assert d.size == N * 346_880
        assert (d <= 1e-6).mean() >= 0.999, os.path.basename(path)
        assert d.max() <= 0.05, os.path.basename(path)


# --------------------------------------------------------------------- #
# resuming inside the port
# --------------------------------------------------------------------- #

RESUME = {"per_leaf": ["--mode", "sim"],
          "bucketed": ["--mode", "sim", "--bucket-mb", "4"],
          "bucketed_hier": ["--mode", "sim", "--bucket-mb", "4",
                            "--hierarchy", "2"],
          "one_bit_adam": ["--mode", "sim", "--optimizer", "one_bit_adam"],
          "single_bucketed": ["--mode", "single", "--bucket-mb", "4"]}


@pytest.mark.parametrize("case", list(RESUME))
def test_resume_is_the_uninterrupted_run(case, tmp_path, capsys):
    """``--save`` after 4 steps, ``Trainer.restore`` into a fresh trainer,
    steps 4-7: losses, params and every state tensor bit for bit the 8
    uninterrupted steps."""
    path = str(tmp_path / "ck.npz")
    argv = ARGV + RESUME[case]
    whole = TLAUNCH.parse_args(argv + ["--steps", str(STEPS)])
    ref = TLAUNCH.train(whole, TLAUNCH.make_trainer(whole))
    first = TLAUNCH.parse_args(argv + ["--steps", "4", "--save", path])
    head = TLAUNCH.train(first, TLAUNCH.make_trainer(first))
    assert f"saved checkpoint to {path}" in capsys.readouterr().out
    assert port_io.read_manifest(path)["step"] == 4
    tr = TLAUNCH.make_trainer(whole)
    params, state, step, meta = tr.restore(path)
    assert meta == {"arch": "gpt2-smoke", "n_workers": tr.n_workers}
    tail = TLAUNCH.train(whole, tr, start=(params, state, step))
    got = [r["losses"] for r in head["records"] + tail["records"]]
    assert got == [r["losses"] for r in ref["records"]]
    for a, b in zip(flatten_tree(tail["params"])[1],
                    flatten_tree(ref["params"])[1]):
        assert torch.equal(a, b)
    sa, sb = tail["state"], ref["state"]
    assert (sa.step, sa.gamma_acc, sa.sync_pstate, sa.var_pstate) == (
        sb.step, sb.gamma_acc, sb.sync_pstate, sb.var_pstate)
    for name in ("u", "err_w", "err_s", "anchor"):
        for a, b in zip(getattr(sa, name), getattr(sb, name)):
            assert (a is None and b is None) or torch.equal(a, b), name
    for name in sa.slots:
        for a, b in zip(sa.slots[name], sb.slots[name]):
            assert torch.equal(a, b), name


def test_state_dtypes_and_scalar_shapes():
    """Sim-mode scalars are arrays over the workers, single-mode ones 0-d,
    with the reference's dtypes (int32 counters, float32 gamma, bool)."""
    pt = _port_trainer("per_leaf")
    st = pt.checkpoint_like()["state"]
    assert st.step.shape == (N,) and st.step.dtype == np.int32
    assert st.gamma_acc.dtype == np.float32
    assert [x.dtype for x in st.var_pstate] == [np.int32, np.int32, np.bool_]
    ps = _port_trainer("per_leaf", single=True)
    st1 = ps.checkpoint_tree(*ps.init(0))["state"]
    assert st1.step.shape == () and st1.slots["m"][0].shape == (1, 2, 128)
    assert dataclasses.is_dataclass(st1)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-236b"])
def test_moe_checkpoints_cross_packages(arch, tmp_path):
    """A sim trainer (EP 4) after two steps, written by each package and
    read by the other: every params and state leaf bit for bit."""
    check_cross_packages(arch, tmp_path)


def test_ssm_checkpoints_cross_packages(tmp_path):
    """mamba2-smoke's sim trainer (4 workers) after two steps, written by
    each package and read by the other: every params and state leaf (the
    stacked SSM leaves among them) bit for bit."""
    check_cross_packages("mamba2-2.7b", tmp_path)


def check_cross_packages(arch, tmp_path):
    """The reference's sim trainer of ``arch``-smoke (4 workers) after two
    steps, saved by the reference and restored by the port, then saved
    by the port and restored by the reference: every leaf bit for
    bit."""
    rcfg, pcfg = _cfgs()
    rt = RefTrainer(ref_get(arch).smoke, rcfg, n_workers=4)
    key = jax.random.PRNGKey(1)
    rp, rs = jax.jit(rt.sim_init)(key)     # one compile, not eager ops
    step = rt.sim_step_fn()
    for b in _batches()[:2]:
        rp, rs, _ = step(rp, rs, _ref_batch(b))
    pt = TSTEP.Trainer(port_get(arch).smoke, pcfg, comm=SimComm(4),
                       device="cpu")
    ref_path = str(tmp_path / "ref.npz")
    ref_io.save(ref_path, {"params": rp, "state": rs}, step=2)
    p, s, step_no, _ = pt.restore(ref_path)
    assert step_no == 2
    want = jax.tree.leaves(jax.device_get({"params": rp, "state": rs}))
    got = port_io.flatten(pt.checkpoint_tree(p, s))[1]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    port_path = str(tmp_path / "port.npz")
    pt.save(port_path, p, s, step=2)
    like = jax.eval_shape(lambda: dict(zip(("params", "state"),
                                           rt.sim_init(key))))
    tree, step_no, _ = ref_io.restore(port_path, like)
    assert step_no == 2
    for a, b in zip(jax.tree.leaves(tree), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))

