"""The port's examples (``repro_torch.examples``: ``quickstart``,
``compare_optimizers``, ``serve_decode``) on the CPU against the
reference's, live in one process, from the reference's initial params
through ``repro_torch.interop``.

* ``quickstart`` and ``compare_optimizers``: every printed accounting
  number (DP params, bits per param a sync, the bytes of a sync and of a
  full-precision round) equals the reference's ``comm_accounting`` of the
  same composition; ``quickstart``'s header line is the reference's,
  character for character; its step-0 loss within 1e-5 of one jitted
  reference step's on the same params and batch (the two packages' f32
  products sum in other orders), at f32 and fp16 state.
* ``serve_decode`` at ``REPRO_EXAMPLE_STEPS=3``, the fewest new tokens a
  request with which the refreshed weights land mid-stream (at 2 every
  request is done before tick 2, so only the first snapshot is swapped
  in, in the reference as in the port): the three requests served before the
  refresh, token for token the reference Scheduler's on the same params
  and prompts; the two admitted after it, token for token a port
  Scheduler's started from the refreshed weights; every request done
  (the example asserts it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as RC
from repro.configs import get as ref_get
from repro.core import schedules as RS
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer
from repro.train import Trainer as RefTrainer

from repro_torch.configs.base import get as port_get
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.examples import compare_optimizers, quickstart, serve_decode
from repro_torch.serve import Request, Scheduler, Server

torch.set_num_threads(1)

N = 4
ACCOUNTED = ("dp_params", "bits_per_param_sync", "compressed_bytes_per_sync",
             "fullprec_bytes_per_round")


def _ref_draw(arch, stack=None):
    """The reference's init of ``arch``'s smoke config (key 0, jitted),
    as numpy, with ``stack`` rows of it (one a worker) when given."""
    tmpl = RT.model_template(ref_get(arch).smoke)
    p = jax.device_get(jax.jit(lambda k: RL.init_params(tmpl, k))(
        jax.random.PRNGKey(0)))
    if stack is None:
        return p
    return jax.tree.map(lambda a: np.broadcast_to(a, (stack,) + a.shape)
                        .copy(), p)


def _ref_series(state_dtype=jnp.float32):
    """The reference's compositions of the two examples, by name."""
    lr = RS.LinearWarmupExpDecay(peak_lr=2e-3, warmup_steps=10, decay=0.97,
                                 decay_period=20)
    var = RS.AdaptiveFreezePolicy(kappa=4)
    sync = RS.LrProportionalSyncPolicy(warmup_steps=15, double_every=20,
                                       max_interval=4)
    return {
        "quickstart": RC.compressed_dp(
            RC.adam_base(beta1=0.9, beta2=0.999), lr=lr, var_policy=var,
            sync_policy=RS.LrProportionalSyncPolicy(
                warmup_steps=10, double_every=20, max_interval=4),
            state_dtype=state_dtype),
        "adam": RC.compressed_dp(RC.adam_base(), style="mean", lr=lr),
        "one_bit_adam": RC.compressed_dp(
            RC.adam_base(), style="gradient", lr=lr,
            var_policy=RS.FixedWarmupPolicy(15)),
        "zero_one_adam": RC.compressed_dp(RC.adam_base(), lr=lr,
                                          var_policy=var, sync_policy=sync),
        "zero_one_lamb": RC.compressed_dp(RC.lamb_base(), lr=lr,
                                          var_policy=var, sync_policy=sync),
    }


@pytest.fixture(scope="module")
def gpt2_draw():
    return _ref_draw("gpt2", N)


@pytest.fixture(scope="module")
def quickstart_step0(gpt2_draw):
    """The reference's quickstart composition, one jitted sim step on the
    draw and the port's batch 0: (its loss, synced, var_round). Step 0's
    loss and flags come before the optimizer touches its state, so one
    step holds every state dtype's case."""
    rt = RefTrainer(ref_get("gpt2").smoke, _ref_series()["quickstart"],
                    n_workers=N)
    params = jax.tree.map(jnp.asarray, gpt2_draw)
    rs = jax.jit(jax.vmap(rt.opt.init))(params)
    batch = SyntheticLM(DataConfig(vocab=64, seq_len=32,
                                   global_batch=8)).batch(0)
    _, _, met = rt.sim_step_fn()(
        params, rs, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return (float(met["loss"][0]), bool(met["synced"][0]),
            bool(met["var_round"][0]))


@pytest.mark.parametrize("state", ["float32", "float16"])
def test_quickstart_matches_reference(gpt2_draw, quickstart_step0,
                                      monkeypatch, state):
    monkeypatch.setenv("REPRO_EXAMPLE_STEPS", "2")
    jdt = getattr(jnp, state)
    rt = RefTrainer(ref_get("gpt2").smoke, _ref_series(jdt)["quickstart"],
                    n_workers=N)
    acct = RC.comm_accounting(rt.opt)
    out = quickstart.main("cpu", gpt2_draw, quickstart.DTYPES_BY_NAME[state])
    assert out["header"] == (
        f"model=gpt2-smoke  DP params={acct['dp_params']/1e6:.2f}M  "
        f"compressed sync: {acct['bits_per_param_sync']/2:.2f} "
        f"bits/param one-way (vs 16 for bf16 AllReduce)")
    for k in ACCOUNTED:
        assert out["accounting"][k] == acct[k], k
    assert len(out["losses"]) == 2
    assert all(x.dtype == getattr(torch, state)
               for x in out["state"].slots["m"])
    # one jitted reference step on the same params and the port's batch 0
    loss, *flags = quickstart_step0
    assert abs(out["losses"][0] - loss) <= 1e-5
    assert out["flags"][0] == tuple(flags)


def test_compare_optimizers_accounting_matches_reference(gpt2_draw,
                                                         monkeypatch):
    monkeypatch.setenv("REPRO_EXAMPLE_STEPS", "3")
    out = compare_optimizers.main("cpu", gpt2_draw)
    ref = _ref_series()
    assert list(out) == list(compare_optimizers.SERIES)
    for name, row in out.items():
        acct = RC.comm_accounting(RefTrainer(ref_get("gpt2").smoke,
                                             ref[name], n_workers=N).opt)
        for k in ACCOUNTED:
            assert row["accounting"][k] == acct[k], (name, k)
        assert row["dp_params"] == acct["dp_params"]
        assert len(row["losses"]) == 3 and np.isfinite(row["losses"]).all()
    # every series starts from the same params and batch
    assert len({row["losses"][0] for row in out.values()}) == 1


def test_serve_decode_matches_reference(monkeypatch):
    monkeypatch.setenv("REPRO_EXAMPLE_STEPS", "3")
    arch = "chatglm3-6b"
    draw = _ref_draw(arch)
    out = serve_decode.main("cpu", draw)
    reqs, before = out["requests"], out["before_swap"]
    # the first snapshot's (at tick 0: the same weights) and the delta's
    assert out["stats"]["weight_swaps"] == 2
    served = [i for i, n in enumerate(before) if n]
    after = [i for i, n in enumerate(before) if not n]
    assert served == [0, 1, 2] and after == [3, 4]
    assert [before[i] for i in served] == [3, 3, 3]
    # before the refresh: the reference's Scheduler on the same params
    rc = ref_get(arch).smoke
    rsch = RefScheduler(RefServer(rc, batch=serve_decode.SLOTS,
                                  max_seq=serve_decode.MAXSEQ,
                                  cache_dtype=jnp.float32),
                        jax.tree.map(jnp.asarray, draw))
    rreqs = [RefRequest(rid=r.rid, prompt=list(r.prompt), max_new_tokens=3)
             for r in reqs]
    for r in rreqs:
        rsch.submit(r)
    for _ in range(serve_decode.SWAP_TICK):
        rsch.tick()
    for i in served:
        assert rreqs[i].output == reqs[i].output, i
    # after it: a port Scheduler started from the refreshed weights
    sch = Scheduler(Server(port_get(arch).smoke, batch=serve_decode.SLOTS,
                           max_seq=serve_decode.MAXSEQ,
                           cache_dtype=torch.float32, device="cpu"),
                    out["served_params"])
    fresh = sch.run([Request(rid=reqs[i].rid, prompt=list(reqs[i].prompt),
                             max_new_tokens=3) for i in after])
    for i, r in zip(after, fresh):
        assert r.output == reqs[i].output, i
