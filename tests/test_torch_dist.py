"""The port's multi-process regime on the CPU: gloo, one worker per
process, against the port's own simulated workers and against the JAX
reference, live.

The ranks run ``repro_torch.launch.train.rank_main`` (or
``repro_torch.launch.mesh.check_exchange``), spawned fresh, so they never
import JAX; they write their results under ``tmp_path`` and meet through
a file there (no port to collide on under pytest-xdist). Every 4-rank
run of the file (the gpt2-smoke cases, micro-batches, the MoE, SSM and
encoder-decoder runs) is a job of one module-scoped spawn of 4 ranks
(``launch.train.rank_jobs``: the jobs one after another, a process group
each), so the ranks' start-up is paid once. Every spawn has a join
timeout. One intra-op thread in the ranks and here, so that the bitwise
comparisons compare the same arithmetic.

Tolerances, with their reasons:
* against the port's sim run of the same settings: bit for bit (losses,
  params, m, v, u and both EF errors, where the optimizer keeps them:
  the baselines ``adam`` and ``one_bit_adam`` keep no u). The exchange collectives move data
  and reduce nothing, and every kernel or torch op a rank runs is the one
  the stacked sim runs on that worker's rows;
* against the reference (gpt2-smoke from the port's own draw, on the
  port's batches): step losses within 1e-4 and at least 99% of params
  within 1e-4, all within 0.05, the bars of ``test_torch_slice.py`` for
  the same reasons (f32 sums in another order; near-zero sign flips).
  At a peak lr of 3e-4 (lr 1.5e-5 to 1.2e-4 over the 8 warm-up steps):
  the measured worst loss gap is 1.4e-5 (single mode) and at least
  99.995% of params are within 1e-4. At the CLI's default peak of 3e-3 a
  sign flip at a sync grows instead: worst gaps 2.5e-5 (tensor scales),
  2.8e-4 (chunk), 6.7e-4 (row, 90.8% of params within 1e-4, since a flip
  moves its whole row's server scale) and 7.3e-4 (single mode, where no
  mean over workers damps a flip), with the port's sim and dist runs
  bitwise equal throughout, so the difference lies between the packages'
  forward and backward passes (~5e-7 on the logits), not in the regime;
* MoE (llama4-smoke, deepseek-smoke) ranks exchanging their tokens for
  real against the port's simulated workers, which run each worker
  against the merged experts: an expert's weight gradient is summed
  over the workers' rows in another order (and its forward batches
  other rows together), so step losses within 1e-5 (measured <= 9.6e-7)
  and every param within 1e-4 (measured <= 1.0e-5); each rank audited
  clean. With pods below the expert count's reach (8 ranks, pods of 4,
  4 experts) the replicas of an expert are equal bit for bit;
* the state-space family (mamba2-smoke) and the encoder-decoder
  (whisper-smoke, its frames sliced per rank as its tokens): every rank
  bit for bit its simulated worker, as gpt2's.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import schedules as RS
from repro.core.comm import Hierarchy as RefHierarchy
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig

from repro_torch.configs.base import get as get_arch
from repro_torch.core.leafwise import flatten_tree
from repro_torch.data import synthetic as TD
from repro_torch.launch import mesh
from repro_torch.launch import train as TLAUNCH

# bitwise comparisons need the same arithmetic on both sides: one thread
# here, and in the ranks through OMP_NUM_THREADS (see the env fixture)
torch.set_num_threads(1)

N, STEPS, B, S = 4, 8, 8, 32
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGV = ["--arch", "gpt2", "--smoke", "--steps", str(STEPS), "--batch",
        str(B), "--seq", str(S), "--sync-warmup", "2", "--double-every",
        "2", "--kappa", "1", "--lr", "3e-4", "--log-every", str(STEPS),
        "--device", "cpu"]
CASES = {"tensor": [], "chunk": ["--scale-mode", "chunk"],
         "row": ["--scale-mode", "row"],
         "sgd": ["--optimizer", "zero_one_sgd"],
         "hier": ["--hierarchy", "2"],      # 2 pods x 2 ranks
         # the baselines: a bf16 mean every step; 1-bit Adam's
         # full-precision stage of 2 steps, then its 1-bit exchange
         "adam": ["--optimizer", "adam"],
         "one_bit": ["--optimizer", "one_bit_adam", "--onebit-warmup", "2"],
         # the bucketed exchange: 15 units, three multi-leaf buckets
         "bucketed": ["--bucket-mb", "4"],
         # 0/1 LAMB (its trust norms summed per worker); the dense codecs,
         # whose payloads cross gloo as int8 and f32, and int32 and f32
         "lamb": ["--optimizer", "zero_one_lamb"],
         "qint8": ["--codec", "qint8"],
         "topk": ["--codec", "topk", "--codec-arg", "0.05"]}
# T_u steps of each case's 8: the accumulate schedule, or every step
SYNCS = {case: ([1] * STEPS if case in ("adam", "one_bit") else
                [1, 1, 1, 1, 1, 0, 1, 0]) for case in CASES}
# qint8 dithers from a hash of each value's bits, so its trajectory is
# chaotic in the last bit of its inputs: the reference itself, from
# params one ulp away, moves by 2.3e-3 in loss within 8 steps (see
# test_torch_codecs.py). Against the reference it is held to losses
# within 1e-2 and every param within 0.05; against the port's sim run,
# bit for bit like every case.
NEAR_REF = {"qint8": dict(loss_atol=1e-2, share=0.0)}
SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


def _spawn_ranks(tmp, argv, n=N):
    """``--mode dist`` in ``n`` gloo ranks; each rank's saved results."""
    argv = argv + ["--mode", "dist"]
    mesh.spawn(TLAUNCH.rank_main, n,
               (argv, n, mesh.file_rendezvous(tmp), str(tmp), True),
               timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt") for r in range(n)]


def _port_run(argv):
    args = TLAUNCH.parse_args(argv)
    return TLAUNCH.train(args, TLAUNCH.make_trainer(args))


def _ref_run(argv, params_stacked, mb=1, single=False):
    """The reference's trajectory (sim mode, or single mode), started
    from the port's draw and fed the port's batches: the per-step loss
    (the mean over workers, as the reference reports it) and the final
    params (n, ...) as numpy."""
    a = TLAUNCH.parse_args(argv)
    cfg = RefOptimizerConfig(
        name=a.optimizer,
        lr=RS.LinearWarmupExpDecay(peak_lr=a.lr, warmup_steps=a.lr_warmup,
                                   decay=0.99,
                                   decay_period=max(a.steps // 20, 1)),
        var_policy=RS.AdaptiveFreezePolicy(kappa=a.kappa),
        sync_policy=RS.LrProportionalSyncPolicy(
            warmup_steps=a.sync_warmup, double_every=a.double_every,
            max_interval=a.max_interval),
        onebit_warmup=a.onebit_warmup, scale_mode=a.scale_mode,
        codec=a.codec, codec_arg=a.codec_arg,
        hierarchy=RefHierarchy(inner=a.hierarchy) if a.hierarchy else None,
        bucket_mb=a.bucket_mb)
    n = 1 if single else a.workers
    rt = RefTrainer(ref_get("gpt2").smoke, cfg, n_workers=n,
                    trainer_cfg=RefTrainerConfig(micro_batches=mb))
    rp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params_stacked)
    if single:
        rs = rt.opt.init(jax.tree.map(lambda x: x[0], rp))
        step = rt.single_step_fn()
    else:
        rs = jax.vmap(lambda i: rt.opt.init(
            jax.tree.map(lambda x: x[i], rp)))(jnp.arange(n))
        step = rt.sim_step_fn()
    data = TD.SyntheticLM(TD.DataConfig(vocab=512, seq_len=a.seq,
                                        global_batch=a.batch, seed=a.seed))
    losses = []
    for t in range(a.steps):
        b = {k: jnp.asarray(v.numpy().astype(np.int32))
             for k, v in data.batch(t).items()}
        rp, rs, rm = step(rp, rs, b)
        losses.append(float(np.asarray(rm["loss"]).reshape(-1)[0]))
    return np.array(losses), [np.asarray(x) for x in jax.tree.leaves(rp)]


def _init_params(argv):
    args = TLAUNCH.parse_args(argv)
    return TLAUNCH.make_trainer(args).init(args.seed)[0]


def _assert_near_reference(ranks, ref_losses, ref_params, loss_atol=1e-4,
                           share=0.99):
    got = np.mean([[rec["losses"][0] for rec in res["records"]]
                   for res in ranks], axis=0)
    np.testing.assert_allclose(got, ref_losses, rtol=0, atol=loss_atol)
    diff = np.concatenate([
        np.abs(np.stack([flatten_tree(res["params"])[1][i][0].numpy()
                         for res in ranks]) - want).ravel()
        for i, want in enumerate(ref_params)])
    assert diff.size == N * 346_880
    assert (diff <= 1e-4).mean() >= share
    assert diff.max() <= 0.05


def _assert_ranks_equal_sim(ranks, sim):
    """Every rank bit for bit the simulated worker of its index."""
    state = sim["state"]
    for r, res in enumerate(ranks):
        assert [rec["losses"][0] for rec in res["records"]] == [
            rec["losses"][r] for rec in sim["records"]], r
        assert [(rec["sync"], rec["var"]) for rec in res["records"]] == [
            (rec["sync"], rec["var"]) for rec in sim["records"]]
        for a, b in zip(flatten_tree(res["params"])[1],
                        flatten_tree(sim["params"])[1]):
            assert torch.equal(a[0], b[r]), r
        pairs = [(res["state"]["slots"][k], state.slots[k])
                 for k in state.slots]
        pairs += [(res["state"][k], getattr(state, k))
                  for k in ("u", "err_w", "err_s")]
        for got, want in pairs:
            for a, b in zip(got, want):
                if b is None:   # a leaf the style keeps no state for
                    assert a is None, r
                    continue
                assert torch.equal(a[0], b[r]), r


# --- (a) the collectives ------------------------------------------------

@pytest.fixture(scope="module")
def exchange_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exchange")
    mesh.spawn(mesh.check_exchange, N,
               (N, mesh.file_rendezvous(tmp), "gloo", "cpu", str(tmp), 2),
               timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(tmp / f"exchange{r}.pt") for r in range(N)]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "uint8", "int8",
                                   "int32"])
def test_dist_comm_matches_sim_comm(exchange_results, dtype):
    """all_to_all and all_gather of every rank, bit for bit what SimComm
    gives the worker of that index, from contiguous and strided views."""
    want = mesh.exchange_reference(mesh.exchange_payloads(N, "cpu"))
    for name in (dtype, dtype + "_strided"):
        for r, got in enumerate(exchange_results):
            for op in ("all_to_all", "all_gather"):
                a, b = got[name][op], want[name][op]
                assert a.shape == (1,) + tuple(b.shape[1:]), (name, op)
                assert a.dtype == b.dtype and torch.equal(a[0], b[r]), (
                    name, op, r)


def test_dist_split_matches_sim_split(exchange_results):
    """DistComm.split(2) over gloo subgroups (2 pods x 2 ranks): each
    level's all_to_all and all_gather, bit for bit what SimComm.split
    gives the worker of that index."""
    want = mesh.exchange_reference(mesh.exchange_payloads(N, "cpu"), 2)
    ops = [f"{lv} {op}" for lv in ("outer", "inner")
           for op in ("all_to_all", "all_gather")]
    for name in want:
        for r, got in enumerate(exchange_results):
            for op in ops:
                a, b = got[name][op], want[name][op]
                assert a.shape == (1,) + tuple(b.shape[1:]), (name, op)
                assert a.dtype == b.dtype and torch.equal(a[0], b[r]), (
                    name, op, r)


def test_refused_dtype_raises_naming_it(tmp_path, monkeypatch):
    """A collective the backend refuses for a payload's dtype raises,
    naming the backend, the collective and the dtype (a world of one
    over gloo, the refusal simulated)."""
    import torch.distributed as dist
    from repro_torch.core.comm import DistComm

    dist.init_process_group("gloo", init_method=mesh.file_rendezvous(
        tmp_path), rank=0, world_size=1)
    try:
        def refuse(*a, **k):
            raise RuntimeError("Unsupported dtype")

        refuse.__name__ = "all_to_all_single"
        monkeypatch.setattr(dist, "all_to_all_single", refuse)
        with pytest.raises(RuntimeError, match="gloo refused "
                           "all_to_all_single of a torch.int8 tensor"):
            DistComm().all_to_all(torch.zeros((1, 1, 4), dtype=torch.int8))
    finally:
        dist.destroy_process_group()


# --- every 4-rank run of the file, in one spawn --------------------------

MOE_ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]
MOE_ARGV = ARGV[2:]      # ARGV without its arch
AUDITED = ["--mode", "dist", "--workers", str(N)]
# name -> (argv of the dist run, audited): the gpt2-smoke cases and
# micro-batches as _spawn_ranks runs them; the MoE, SSM and
# encoder-decoder runs recording and auditing their collectives
JOBS = {**{case: (ARGV + extra + ["--mode", "dist"], False)
           for case, extra in CASES.items()},
        "micro_batches": (ARGV + ["--micro-batches", "2", "--mode", "dist"],
                          False),
        **{f"moe_{arch}": (["--arch", arch] + MOE_ARGV + AUDITED, True)
           for arch in MOE_ARCHS},
        "ssm": (["--arch", "mamba2-2.7b"] + MOE_ARGV + AUDITED, True),
        "encdec": (["--arch", "whisper-large-v3"] + MOE_ARGV + AUDITED,
                   True)}


@pytest.fixture(scope="module")
def shared_ranks(tmp_path_factory):
    """Every job of JOBS in one spawn of N gloo ranks (each job its own
    process group and rendezvous): name -> each rank's saved results."""
    dirs = {name: tmp_path_factory.mktemp(name) for name in JOBS}
    jobs = [(argv, str(dirs[name]), True, "lm", audit, None)
            for name, (argv, audit) in JOBS.items()]
    mesh.spawn(TLAUNCH.rank_jobs, N, (jobs, N),
               timeout_s=SPAWN_TIMEOUT_S * len(jobs) / 4)
    return {name: [torch.load(d / f"rank{r}.pt") for r in range(N)]
            for name, d in dirs.items()}


# --- (b), (c) gpt2-smoke in four ranks -----------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def case_runs(request, shared_ranks):
    argv = ARGV + CASES[request.param]
    return argv, shared_ranks[request.param], SYNCS[request.param], \
        NEAR_REF.get(request.param, {})


def test_dist_matches_port_sim_bitwise(case_runs):
    argv, ranks, _, _ = case_runs
    sim = _port_run(argv + ["--mode", "sim", "--workers", str(N)])
    _assert_ranks_equal_sim(ranks, sim)
    assert [r["records"][0]["sync"] for r in ranks] == [True] * N
    # the ranks time their collectives: some time on every sync step,
    # none where nothing is exchanged; the sim's exchange is in process
    for res in ranks:
        for rec in res["records"]:
            assert (rec["exchange_ms"] > 0) == bool(rec["sync"]), rec
            if "--hierarchy" in argv:
                # every collective is intra-pod or inter-pod
                parts = rec["exchange_ms_intra"] + rec["exchange_ms_inter"]
                assert parts == pytest.approx(rec["exchange_ms"]), rec
                assert (rec["exchange_ms_inter"] > 0) == bool(rec["sync"])
    assert all(rec["exchange_ms"] is None for rec in sim["records"])


def test_dist_matches_reference(case_runs):
    argv, ranks, syncs, bars = case_runs
    ref_losses, ref_params = _ref_run(argv, _init_params(
        argv + ["--mode", "sim"]))
    _assert_near_reference(ranks, ref_losses, ref_params, **bars)
    assert [rec["sync"] for rec in ranks[0]["records"]] == syncs


# --- (d) micro-batches, (e) single mode ----------------------------------

def test_dist_micro_batches_match_sim_and_reference(shared_ranks):
    argv = ARGV + ["--micro-batches", "2"]
    ranks = shared_ranks["micro_batches"]
    _assert_ranks_equal_sim(ranks, _port_run(argv + ["--mode", "sim"]))
    ref_losses, ref_params = _ref_run(argv, _init_params(
        argv + ["--mode", "sim"]), mb=2)
    _assert_near_reference(ranks, ref_losses, ref_params)


def test_single_mode_matches_reference():
    argv = ARGV + ["--mode", "single", "--batch", "2"]
    port = _port_run(argv)
    params = _init_params(argv)
    assert flatten_tree(params)[1][0].shape[0] == 1
    ref_losses, ref_params = _ref_run(argv, params, single=True)
    got = np.array([rec["losses"][0] for rec in port["records"]])
    np.testing.assert_allclose(got, ref_losses, rtol=0, atol=1e-4)
    diff = np.concatenate([
        np.abs(a.numpy() - b).ravel()
        for a, b in zip(flatten_tree(port["params"])[1], ref_params)])
    assert diff.size == 346_880
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 0.05


# --- no fallback ----------------------------------------------------------

@pytest.mark.parametrize("backend,device,ranks,match", [
    ("nccl", "cuda", 2, "CUDA card"),
    ("nccl", "cpu", 2, "CUDA devices"),
    ("nccl", "cuda:0", 2, "two ranks on one card"),
    ("gloo", "cuda:0", 4, "CUDA card")])
def test_backend_refuses_what_it_cannot_run(backend, device, ranks, match,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises((RuntimeError, ValueError), match=match):
        mesh.check_backend(backend, device, ranks)


def test_cli_dist_on_cuda_without_cards_raises_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(mesh, "spawn", lambda *a, **k: pytest.fail(
        "spawned ranks that cannot run"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        TLAUNCH.main(ARGV[:-2] + ["--mode", "dist"])
    assert ARGV[-2:] == ["--device", "cpu"]


def test_failing_rank_fails_the_launcher(tmp_path):
    # a global batch of 6 does not split over 4 ranks: every rank raises
    with pytest.raises(Exception, match="not divisible"):
        _spawn_ranks(tmp_path, ARGV + ["--batch", "6", "--steps", "1"])


# --------------------------------------------------------------------- #
# (f) MoE: the real expert exchange
# --------------------------------------------------------------------- #

def _spawn_audited(tmp, argv, n):
    """``--mode dist`` in ``n`` gloo ranks, each recording and auditing
    its collectives; each rank's saved results."""
    argv = argv + ["--mode", "dist", "--workers", str(n)]
    mesh.spawn(TLAUNCH.rank_main, n,
               (argv, n, mesh.file_rendezvous(str(tmp)), str(tmp), True,
                "lm", True), timeout_s=SPAWN_TIMEOUT_S)
    return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt") for r in range(n)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ranks_match_their_simulated_workers(arch, shared_ranks):
    """4 gloo ranks, one worker each, exchanging their tokens for real
    (both directions of the forward and the backward through the
    recording comm), each against its simulated worker, and audited:
    the exchanges classified as expert-parallel dispatch, the optimizer's
    manifest exact."""
    argv = ["--arch", arch] + MOE_ARGV
    ranks = shared_ranks[f"moe_{arch}"]
    args = TLAUNCH.parse_args(argv + ["--mode", "sim", "--workers", "4"])
    sim = TLAUNCH.train(args, TLAUNCH.make_trainer(args))
    moe_layers = (get_arch(arch).smoke.n_layers
                  - get_arch(arch).smoke.first_k_dense)
    for r, res in enumerate(ranks):
        for got, want in zip(res["records"], sim["records"]):
            assert abs(got["losses"][0] - want["losses"][r]) <= 1e-5
            assert (got["sync"], got["var"]) == (want["sync"], want["var"])
            assert got["ep_a2a_ms"] > 0 and "ep_a2a_ms" not in want
        for a, b in zip(flatten_tree(res["params"])[1],
                        flatten_tree(sim["params"])[1]):
            assert float((a[0] - b[r]).abs().max()) <= 1e-4, r
        audit = res["audit"]
        assert audit["ok"], audit["violations"]
        assert audit["summary"]["allowed"]["expert-parallel dispatch"] == (
            STEPS * moe_layers * 4)


def test_moe_pods_average_the_expert_replicas(tmp_path):
    """8 ranks in 2 pods of 4 with llama4-smoke's 4 experts: the experts
    split over each pod (EP 4), the two pods hold replicas whose
    gradients are averaged across them (the residual mean, audited as
    such), so every rank's experts equal its replica's, bit for bit."""
    argv = ["--arch", "llama4-scout-17b-a16e", "--hierarchy", "4"] + MOE_ARGV
    ranks = _spawn_audited(tmp_path, argv, 8)
    tr = TLAUNCH.make_trainer(TLAUNCH.parse_args(
        argv + ["--mode", "sim", "--workers", "4"]))
    ep = sorted(tr.ep_leaf_axes)
    for r in range(4):
        a = flatten_tree(ranks[r]["params"])[1]
        b = flatten_tree(ranks[r + 4]["params"])[1]
        for i in ep:
            assert torch.equal(a[i], b[i]), (r, i)
    for res in ranks:
        assert res["audit"]["ok"], res["audit"]["violations"]
        allowed = res["audit"]["summary"]["allowed"]
        assert allowed["EP residual-axis gradient mean"] == STEPS * len(ep)
        assert all(np.isfinite(rec["losses"][0]) for rec in res["records"])


# --------------------------------------------------------------------- #
# (g) the state-space family
# --------------------------------------------------------------------- #

def test_ssm_ranks_match_their_simulated_workers(shared_ranks):
    """4 gloo ranks of mamba2-smoke (seq 32, four chunks of 8), each
    recording and auditing its collectives, bit for bit its simulated
    worker as in 6a: losses, params, m, v, u and both EF errors."""
    argv = ["--arch", "mamba2-2.7b"] + MOE_ARGV
    ranks = shared_ranks["ssm"]
    sim = _port_run(argv + ["--mode", "sim", "--workers", str(N)])
    _assert_ranks_equal_sim(ranks, sim)
    for res in ranks:
        assert res["audit"]["ok"], res["audit"]["violations"]


# --------------------------------------------------------------------- #
# (h) the encoder-decoder
# --------------------------------------------------------------------- #

def test_encdec_ranks_match_their_simulated_workers(shared_ranks):
    """4 gloo ranks of whisper-smoke, each encoding its quarter of the
    CLI's zero frames beside its quarter of the tokens, recording and
    auditing its collectives, bit for bit its simulated worker as in 6a:
    losses, params (the always-zero cross biases among them), m, v, u and
    both EF errors."""
    argv = ["--arch", "whisper-large-v3"] + MOE_ARGV
    ranks = shared_ranks["encdec"]
    sim = _port_run(argv + ["--mode", "sim", "--workers", str(N)])
    _assert_ranks_equal_sim(ranks, sim)
    for res in ranks:
        assert res["audit"]["ok"], res["audit"]["violations"]
        assert not res["params"]["cross"]["attn"]["bk"].any()


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_sweep.py"]
    assert len(files) > 30
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, name)
