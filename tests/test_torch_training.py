"""The port's training path (kubedl_tpu_torch.training) against the JAX
reference on the CPU.

- The optimizer: three steps of ``make_optimizer`` against the optax
  chain on the same params and grads — params, mu and nu (values and
  dtypes) within 1e-6 in float32, and within 1e-2 in bf16 (two bf16 ulps
  at |x| ~ 1: the port takes the global norm in float32); the first
  step is an exact no-op (optax counts from 0: lr = schedule(0) = 0).
- The trainer: the JAX ``Trainer`` (dense attention, one-device mesh)
  and the port's (flash route on the CPU: the operators' plain versions)
  from the same parameters on the same ``SyntheticTokens`` batches; the
  six losses and grad norms agree within 1e-4 relative.
- The entry point, and every knob this slice rejects.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.training import trainer as tt  # noqa: E402
from kubedl_tpu_torch.training.data import SyntheticTokens  # noqa: E402


# ---- optimizer ------------------------------------------------------------------

@pytest.mark.parametrize("warmup,steps", [(10, 50), (1, 8), (0, 6), (3, 3)])
def test_schedule_matches_optax(warmup, steps):
    import optax

    kw = dict(init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
              decay_steps=max(steps, warmup + 1), end_value=3e-5)
    ref = optax.warmup_cosine_decay_schedule(**kw)
    mine = tt.warmup_cosine_decay_schedule(**kw)
    for c in range(0, steps + 5):
        assert abs(mine(c) - float(ref(c))) <= 1e-6 * 3e-4 + 1e-12, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_optax_chain(dtype):
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.training import trainer as jt

    cfg = tt.TrainConfig(steps=6, warmup_steps=2, learning_rate=1e-2,
                         grad_clip=1.0, weight_decay=0.1)
    jcfg = jt.TrainConfig(steps=6, warmup_steps=2, learning_rate=1e-2,
                          grad_clip=1.0, weight_decay=0.1)
    rng = np.random.RandomState(0)
    shapes = {"w": (4, 8), "norm": (8,), "big": (3, 5, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i == 1 else 0.05))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]  # step 1 is clipped, the others are not
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    tx = jt.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    js = tx.init(jp)
    opt = tt.make_optimizer(cfg)
    tp = [torch.from_numpy(params[k]).to(tdt) for k in shapes]
    ts = opt.init(tp)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        upd, js = tx.update(jg, js, jp)
        jp = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), jp, upd)
        opt.update([torch.from_numpy(g[k]).to(tdt) for k in shapes], ts, tp)
        adam = js[1][0]
        for j, k in enumerate(shapes):
            if i == 0:  # lr = schedule(0) = 0: an exact no-op
                assert torch.equal(tp[j], torch.from_numpy(params[k]).to(tdt))
            assert tp[j].dtype == tdt
            assert ts["mu"][j].dtype == torch.float32
            assert ts["nu"][j].dtype == tdt  # nu keeps the params' dtype
            assert adam.mu[k].dtype == jnp.float32 and adam.nu[k].dtype == jdt
            for mine, ref in ((tp[j], jp[k]), (ts["mu"][j], adam.mu[k]),
                              (ts["nu"][j], adam.nu[k])):
                np.testing.assert_allclose(mine.float().numpy(),
                                           np.asarray(ref, np.float32),
                                           atol=tol, rtol=tol, err_msg=k)
    assert ts["count"] == 3


def test_bf16_first_moment_option():
    opt = tt.make_optimizer(tt.TrainConfig(opt_moment_dtype="bfloat16"))
    st = opt.init([torch.zeros(3, dtype=torch.float32)])
    assert st["mu"][0].dtype == torch.bfloat16
    assert st["nu"][0].dtype == torch.float32


# ---- trainer vs the JAX trainer ---------------------------------------------------

def _jax_trainer(cfg_kw):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    model = dataclasses.replace(jl.TINY, **cfg_kw.pop("model", {}))
    return jt.Trainer(jt.TrainConfig(model=model, attn_impl="dense",
                                     **cfg_kw), mesh)


@pytest.mark.parametrize("accum,remat", [(1, False), (2, False), (1, True)],
                         ids=["plain", "grad_accum2", "remat"])
def test_trainer_reproduces_jax_trajectory(accum, remat):
    """Six train steps on tiny from the same parameters and batches: the
    JAX trainer (dense) and the port's (flash operators, CPU) agree on
    every loss and grad norm within 1e-4 relative."""
    import jax

    kw = dict(global_batch=4, seq_len=64, steps=6, warmup_steps=2,
              learning_rate=1e-2, grad_accum=accum)
    jtr = _jax_trainer(dict(kw, model={"remat": remat}))
    jstate = jtr.init_state()
    model = dataclasses.replace(tl.TINY, remat=remat)
    ttr = tt.Trainer(tt.TrainConfig(model=model, attn_impl="flash", **kw),
                     device="cpu")
    assert ttr.attn_impl == "flash"
    tstate = ttr.init_state()
    tstate["params"] = tl.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), model, "cpu")
    tstate["opt_state"] = ttr.tx.init(tt.tree_leaves(tstate["params"]))
    data = SyntheticTokens(4, 64, tl.TINY.vocab_size, seed=7)
    for _ in range(6):
        batch = next(data)
        jstate, jm = jtr.train_step(jstate, jtr.shard_batch(batch))
        tstate, tm = ttr.train_step(tstate, batch)
        for key in ("loss", "grad_norm"):
            a, b = float(tm[key]), float(jm[key])
            assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    assert tstate["step"] == 6


#: what the long-context policy applies to a remat'ing Llama config
LONG_POLICY = "loss_chunk=512,remat_policy=flash_rope"
#: the flash operators' plain versions, by the operator they implement
PLAIN_VERSIONS = {"_plain_fwd": "flash_fwd",
                  "_plain_bwd_fused": "flash_bwd_fused",
                  "_plain_bwd_dq": "flash_bwd_dq",
                  "_plain_bwd_dkdv_per_head": "flash_bwd_dkdv"}


@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of each flash operator's plain version (on the CPU, what the
    operator runs in place of its kernel), counted by operator."""
    from kubedl_tpu_torch.ops import flash_attention as tfa

    counts = dict.fromkeys(PLAIN_VERSIONS.values(), 0)
    for name, op in PLAIN_VERSIONS.items():
        def counted(*a, _real=getattr(tfa, name), _op=op, **kw):
            counts[_op] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    return counts


def test_long_context_split_trajectory_matches_jax(plain_calls, monkeypatch):
    """The long-context path on tiny: the policy applied by a lowered
    threshold (seq_len 64 >= 32: "flash_rope" remat, a 512-token loss
    chunk) and the backward forced to the split pair, as a 32k-token run
    takes it. Four steps from the same parameters and batches: the JAX
    trainer (dense attention, the same policy) and the port's (the split
    operators' plain versions) agree on every loss and grad norm within
    1e-4 relative. Per step the port runs each split operator once a
    layer and the fused one never, and the forward once a layer: the
    policy saves the forward's outputs, so remat does not re-run it."""
    import jax

    from kubedl_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setattr(tfa, "_FUSED_BWD_SCRATCH_BYTES", 0)
    kw = dict(global_batch=2, seq_len=64, steps=4, warmup_steps=1,
              learning_rate=1e-2, long_context_threshold=32)
    jtr = _jax_trainer(dict(kw, model={"remat": True}))
    assert jtr.long_context_policy_applied == LONG_POLICY
    jstate = jtr.init_state()
    model = dataclasses.replace(tl.TINY, remat=True)
    ttr = tt.Trainer(tt.TrainConfig(model=model, attn_impl="flash", **kw),
                     device="cpu")
    assert ttr.long_context_policy_applied == LONG_POLICY
    assert tfa.bwd_route(64, model.head_dim) == "split"
    tstate = ttr.init_state()
    tstate["params"] = tl.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), model, "cpu")
    tstate["opt_state"] = ttr.tx.init(tt.tree_leaves(tstate["params"]))
    data = SyntheticTokens(2, 64, tl.TINY.vocab_size, seed=11)
    layers = model.n_layers
    for _ in range(4):
        before = dict(plain_calls)
        batch = next(data)
        jstate, jm = jtr.train_step(jstate, jtr.shard_batch(batch))
        tstate, tm = ttr.train_step(tstate, batch)
        for key in ("loss", "grad_norm"):
            a, b = float(tm[key]), float(jm[key])
            assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
        assert {op: plain_calls[op] - before[op] for op in plain_calls} == {
            "flash_fwd": layers, "flash_bwd_fused": 0,
            "flash_bwd_dq": layers, "flash_bwd_dkdv": layers}


def test_train_main_long_context_policy(capsys, clean_env, monkeypatch,
                                        plain_calls):
    """train_main on the CPU at the long-context configuration above (a
    remat'ing tiny, the policy's threshold lowered to 32, the split route
    forced): its worker summary carries the policy it applied, and the
    split operators ran on every layer of every step."""
    from kubedl_tpu_torch.ops import flash_attention as tfa
    from kubedl_tpu_torch.training import entry

    @dataclasses.dataclass(frozen=True)
    class LowThreshold(tt.TrainConfig):
        long_context_threshold: int = 32

    monkeypatch.setattr(tt, "TrainConfig", LowThreshold)
    monkeypatch.setitem(tl.PRESETS, "tiny-remat",
                        dataclasses.replace(tl.TINY, remat=True))
    monkeypatch.setattr(tfa, "_FUSED_BWD_SCRATCH_BYTES", 0)
    cfg = {"model": "tiny-remat", "steps": 2, "seq_len": 64,
           "global_batch": 2, "device": "cpu", "attn_impl": "flash"}
    assert entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg)}) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"worker_summary"')]
    s = json.loads(lines[-1])["worker_summary"]
    assert s["long_context_policy"] == LONG_POLICY
    assert np.isfinite(s["final_loss"]) and s["sanity_violations"] == []
    n = 2 * tl.TINY.n_layers
    assert plain_calls == {"flash_fwd": n, "flash_bwd_fused": 0,
                           "flash_bwd_dq": n, "flash_bwd_dkdv": n}


def test_loss_falls_on_a_repeated_batch():
    """Overfitting one fixed batch (uniform tokens carry no signal across
    batches): the check the reference's dry run makes."""
    cfg = tt.TrainConfig(global_batch=4, seq_len=32, steps=8,
                         warmup_steps=1, learning_rate=1e-2,
                         attn_impl="flash")
    tr = tt.Trainer(cfg, device="cpu")
    batch = next(iter(SyntheticTokens(4, 32, tl.TINY.vocab_size)))
    _, summary = tr.fit(itertools.repeat(batch))
    assert np.isfinite(summary["final_loss"])
    assert summary["final_loss"] < summary["first_loss"]
    assert summary["sanity_violations"] == []
    assert summary["steps"] == 8 and summary["attn_impl"] == "flash"


def test_fit_log_every_and_summary_keys():
    from kubedl_tpu.training import trainer as jt

    tr = tt.Trainer(tt.TrainConfig(global_batch=2, seq_len=16, steps=5,
                                   log_every=2), device="cpu")
    before = tt.SCALAR_FETCHES
    _, summary = tr.fit(iter(SyntheticTokens(2, 16, 256)))
    # first step + steps 2 and 4 + the final step
    assert tt.SCALAR_FETCHES - before == 4
    assert [s for s, _ in summary["loss_log"]] == [2, 4]
    assert summary["attn_impl"] == "dense"  # "auto" on the CPU
    assert summary["warm_compile_s"] is None and summary["mfu"] == 0.0
    import inspect

    ref_keys = set(inspect.getsource(jt.Trainer.fit).split("summary = {")[1]
                   .split("}")[0].replace('"', " ").split())
    assert {k for k in summary if k in ref_keys} >= {
        "first_loss", "final_loss", "tokens_per_sec", "step_time_ms", "mfu",
        "hbm_floor_ms", "attn_impl", "n_params", "loss_log"}


@pytest.mark.parametrize("kw", [
    {"mesh": {"data": 2}}, {"mesh": {"sp": 2}}, {"mesh": {"pipe": 2}},
    {"cfg": {"ckpt_every": 5}},
], ids=["data2", "sp2", "pipe2", "ckpt_every"])
def test_trainer_rejects_later_slices(kw):
    cfg = tt.TrainConfig(**kw.get("cfg", {}))
    with pytest.raises(ValueError, match="slice"):
        tt.Trainer(cfg, mesh=kw.get("mesh"), device="cpu")


def test_fit_checkpoint_and_ps_raise():
    tr = tt.Trainer(tt.TrainConfig(global_batch=2, seq_len=16, steps=1),
                    device="cpu")
    data = iter(SyntheticTokens(2, 16, 256))
    with pytest.raises(ValueError, match="slice"):
        tr.fit(data, ckpt_dir="/nonexistent")
    with pytest.raises(ValueError, match="slice"):
        tr.fit_ps(data, None, "w0")
    with pytest.raises(ValueError, match="MoE"):
        tt.moe_family(object())
    # shard_update / overlap_comm are accepted no-ops on one device
    tr2 = tt.Trainer(tt.TrainConfig(global_batch=2, seq_len=16, steps=1,
                                    shard_update=False, overlap_comm=False),
                     device="cpu")
    assert tr2.tx.weight_decay == 0.1


def test_long_context_policy_matches_reference():
    cfg = tt.TrainConfig(model=dataclasses.replace(tl.TINY, remat=True),
                         seq_len=4096)
    tr = tt.Trainer(cfg, device="cpu")
    assert tr.cfg.model.remat_policy == "flash_rope"
    assert tr.cfg.model.loss_chunk == 512
    assert tr.long_context_policy_applied == \
        "loss_chunk=512,remat_policy=flash_rope"


# ---- the entry point ------------------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    """train_main reads the process environment: clear every name it
    reads that an earlier in-process entry (of either package) may have
    left there."""
    from kubedl_tpu_torch.training import entry

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)


def test_train_main_prints_worker_summary(capsys, clean_env):
    from kubedl_tpu_torch.training import entry

    cfg = {"model": "tiny", "steps": 3, "seq_len": 64, "device": "cpu",
           "attn_impl": "flash"}
    assert entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg)}) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"worker_summary"')]
    assert len(lines) == 1
    s = json.loads(lines[0])["worker_summary"]
    assert np.isfinite(s["first_loss"]) and np.isfinite(s["final_loss"])
    assert s["attn_impl"] == "flash" and s["sanity_violations"] == []
    assert s["steps"] == 3 and entry.LAST_SUMMARY["steps"] == 3


@pytest.mark.parametrize("env,opts", [
    ({"KUBEDL_NUM_PROCESSES": "2"}, {}),
    ({"KUBEDL_MESH_AXES": "data=2"}, {}),
    ({"KUBEDL_CKPT_DIR": "/tmp/x"}, {}),
    ({"KUBEDL_MODEL_PATH": "/tmp/m"}, {}),
    ({"KUBEDL_PS_ADDR": "localhost:1"}, {}),
    ({"KUBEDL_ELASTIC_BASE_WORLD": "4"}, {}),
    ({"KUBEDL_ELASTIC_BASE_DP": "2"}, {}),
    ({"KUBEDL_FAULT_ONCE_AT_STEP": "1"}, {}),
    ({"KUBEDL_FAULT_MARKER": "/tmp/f"}, {}),
    ({"KUBEDL_BEACON_FILE": "/tmp/b"}, {}),
    ({}, {"data_path": "/tmp/tokens.bin"}),
    ({}, {"train_mode": "ps"}),
    ({}, {"ckpt_every": 2}),
    ({}, {"model": "moe-tiny"}),
], ids=lambda x: ",".join(f"{k}" for k in x) or "-")
def test_train_main_rejects_what_this_slice_does_not_run(env, opts,
                                                       clean_env):
    from kubedl_tpu_torch.training import entry

    cfg = dict({"model": "tiny", "steps": 1, "seq_len": 16, "device": "cpu"},
               **opts)
    with pytest.raises(ValueError, match="slice"):
        entry.train_main(dict(env, KUBEDL_TRAIN_CONFIG=json.dumps(cfg)))


def test_train_main_device_from_env(monkeypatch, clean_env):
    from kubedl_tpu_torch.training import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = json.dumps({"model": "tiny", "steps": 1, "seq_len": 16})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.train_main({"KUBEDL_TRAIN_CONFIG": cfg})
    assert entry.train_main({"KUBEDL_TRAIN_CONFIG": cfg,
                             "KUBEDL_TRAIN_DEVICE": "cpu"}) == 0


def test_data_streams_equal_reference(tmp_path):
    """The port's copies of SyntheticTokens and ByteCorpus give the
    reference's batches for the same seed."""
    from kubedl_tpu.training import data as jd
    from kubedl_tpu_torch.training import data as td

    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(range(256)) * 3)
    pairs = [(td.SyntheticTokens(3, 16, 1000, seed=5),
              jd.SyntheticTokens(3, 16, 1000, seed=5)),
             (td.ByteCorpus(str(corpus), 2, 32, seed=4),
              jd.ByteCorpus(str(corpus), 2, 32, seed=4))]
    for mine, ref in pairs:
        for _ in range(3):
            a, b = next(mine), next(ref)
            assert a.dtype == np.int32 and np.array_equal(a, b)
    with pytest.raises(ValueError, match="shorter"):
        td.ByteCorpus(str(corpus), 1, 10_000)


def test_topology_rates():
    from kubedl_tpu_torch.api.topology import (
        hbm_bandwidth_for_device_kind, peak_flops_for_device_kind,
    )

    assert peak_flops_for_device_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert hbm_bandwidth_for_device_kind("NVIDIA H100 SXM5") == 3.35e12
    assert peak_flops_for_device_kind("cpu") == 0.0
    assert hbm_bandwidth_for_device_kind("") == 0.0
