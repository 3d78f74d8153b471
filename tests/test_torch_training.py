"""The port's training path (kubedl_tpu_torch.training) against the JAX
reference on the CPU.

- The optimizer: three steps of ``make_optimizer`` against the optax
  chain called eagerly on the same params and grads — params, mu and nu
  (values and dtypes) within 1e-6 in float32, and within 1e-2 in bf16
  (two bf16 ulps at |x| ~ 1: the eager chain rounds where the compiled
  one does not); the first step is an exact no-op (optax counts from 0:
  lr = schedule(0) = 0). And five steps against the chain under
  ``jax.jit``, which is the reference's arithmetic (tolerances in
  ``test_optimizer_matches_jitted_optax_chain``).
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


#: (param dtype, mu dtype, grad_clip): the main path's bf16 parameters with
#: a float32 first moment, float32 (the CPU trajectory tests), both bf16
#: moments; grad_clip 1.0 clips steps 1 and 3 only, 0.3 every step
JIT_CASES = [("bfloat16", "float32", 1.0), ("bfloat16", "float32", 0.3),
             ("float32", "float32", 1.0), ("float32", "float32", 0.3),
             ("bfloat16", "bfloat16", 1.0), ("float32", "bfloat16", 0.3)]


@pytest.mark.parametrize("pd,md,clip", JIT_CASES,
                         ids=[f"{p}-mu_{m}-clip{c}" for p, m, c in JIT_CASES])
def test_optimizer_matches_jitted_optax_chain(pd, md, clip):
    """Five updates of the port's optimizer (its plain version on the CPU)
    against the reference's optax chain under ``jax.jit``, which is how
    the reference's train step runs it: XLA rounds a Python scalar to the
    tensor's type and drops bf16 roundings that feed float32 (so the
    eager chain is not the reference's arithmetic; see ops/adamw.py).
    Tolerances: the global norm within 1e-6 relative; bf16 entries (p,
    nu, a bf16 mu) within one bf16 ulp (2^-7 relative) and at most 0.1 %
    of them off their bits; float32 entries within 1e-5 relative plus
    1e-6 of the leaf's largest magnitude. Why not bit for bit: the CPU
    backend contracts some multiply-adds into FMAs (LLVM's choice, not
    the graph's, e.g. ``mu' = fma(g, 0.1, mu * 0.9)``), which the port
    leaves to separate float32 operations, one float32 rounding apart."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubedl_tpu.training import trainer as jt

    kw = dict(steps=6, warmup_steps=2, learning_rate=1e-2, grad_clip=clip,
              weight_decay=0.1, opt_moment_dtype=md)
    rng = np.random.RandomState(0)
    shapes = {"w": (64, 128), "norm": (128,), "big": (3, 50, 70)}
    keys = sorted(shapes)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i in (1, 3) else 3e-3))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(5)]
    jdt, tdt = jnp.dtype(pd), getattr(torch, pd)
    tx = jt.make_optimizer(jt.TrainConfig(**kw))

    @jax.jit
    def step(g, s, p):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, optax.global_norm(g)

    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    js = tx.init(jp)
    opt = tt.make_optimizer(tt.TrainConfig(**kw))
    tp = [torch.from_numpy(params[k]).to(tdt) for k in keys]
    ts = opt.init(tp)

    def close(mine, ref, what):
        a = mine.float().numpy()
        b = np.asarray(ref.astype(jnp.float32))
        if mine.dtype == torch.bfloat16:
            assert np.all(np.abs(a - b) <= 2.0**-7 * np.abs(b)), what
            assert (a != b).mean() <= 1e-3, what
        else:
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(), err_msg=what)

    for i, g in enumerate(grads):
        jp, js, jn = step({k: jnp.asarray(v, jdt) for k, v in g.items()},
                          js, jp)
        n = opt.update([torch.from_numpy(g[k]).to(tdt) for k in keys], ts,
                       tp)
        assert abs(float(n) - float(jn)) <= 1e-6 * float(jn), i
        adam = js[1][0]
        for j, k in enumerate(keys):
            close(tp[j], jp[k], f"step {i} {k} p")
            close(ts["mu"][j], adam.mu[k], f"step {i} {k} mu")
            close(ts["nu"][j], adam.nu[k], f"step {i} {k} nu")
            assert ts["mu"][j].dtype == getattr(torch, md)


def test_bf16_first_moment_option():
    opt = tt.make_optimizer(tt.TrainConfig(opt_moment_dtype="bfloat16"))
    st = opt.init([torch.zeros(3, dtype=torch.float32)])
    assert st["mu"][0].dtype == torch.bfloat16
    assert st["nu"][0].dtype == torch.float32


# ---- trainer vs the JAX trainer ---------------------------------------------------

def _jax_trainer(cfg_kw, preset="tiny"):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    model = dataclasses.replace(jl.preset(preset), **cfg_kw.pop("model", {}))
    return jt.Trainer(jt.TrainConfig(model=model, attn_impl="dense",
                                     **cfg_kw), mesh)


#: (preset, grad_accum, remat): tiny, and tiny-gemma (Gemma-2B's family:
#: MQA, GeGLU, (1+w) norms, scaled tied embeddings) the same three ways
TRAJECTORY_CASES = {
    "plain": ("tiny", 1, False), "grad_accum2": ("tiny", 2, False),
    "remat": ("tiny", 1, True),
    "tiny-gemma-plain": ("tiny-gemma", 1, False),
    "tiny-gemma-grad_accum2": ("tiny-gemma", 2, False),
    "tiny-gemma-remat": ("tiny-gemma", 1, True),
}


@pytest.mark.parametrize("preset,accum,remat", list(TRAJECTORY_CASES.values()),
                         ids=list(TRAJECTORY_CASES))
def test_trainer_reproduces_jax_trajectory(preset, accum, remat):
    """Six train steps on the preset from the same parameters and
    batches: the JAX trainer (dense) and the port's (flash operators,
    CPU) agree on every loss and grad norm within 1e-4 relative."""
    import jax

    kw = dict(global_batch=4, seq_len=64, steps=6, warmup_steps=2,
              learning_rate=1e-2, grad_accum=accum)
    jtr = _jax_trainer(dict(kw, model={"remat": remat}), preset)
    jstate = jtr.init_state()
    model = dataclasses.replace(tl.preset(preset), remat=remat)
    ttr = tt.Trainer(tt.TrainConfig(model=model, attn_impl="flash", **kw),
                     device="cpu")
    assert ttr.attn_impl == "flash"
    tstate = ttr.init_state()
    tstate["params"] = tl.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), model, "cpu")
    tstate["opt_state"] = ttr.tx.init(tt.tree_leaves(tstate["params"]))
    data = SyntheticTokens(4, 64, model.vocab_size, seed=7)
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


@pytest.mark.parametrize("preset", ["tiny", "tiny-gemma"])
def test_long_context_split_trajectory_matches_jax(plain_calls, monkeypatch,
                                                   preset):
    """The long-context path on tiny, and on tiny-gemma (Gemma-2B's
    family: MQA, GeGLU, (1+w) norms, a scaled tied embedding; a Gemma-2B
    run at its 8192-token context takes this route): the policy applied by
    a lowered threshold (seq_len 64 >= 32: "flash_rope" remat, a 512-token
    loss chunk) and the backward forced to the split pair, as a
    long-context run takes it. Four steps from the same parameters and
    batches: the JAX trainer (dense attention, the same policy) and the
    port's (the split operators' plain versions) agree on every loss and
    grad norm within 1e-4 relative. Per step the port runs each split
    operator once a layer and the fused one never, and the forward once a
    layer: the policy saves the forward's outputs, so remat does not
    re-run it."""
    import jax

    from kubedl_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setattr(tfa, "_FUSED_BWD_SCRATCH_BYTES", 0)
    kw = dict(global_batch=2, seq_len=64, steps=4, warmup_steps=1,
              learning_rate=1e-2, long_context_threshold=32)
    jtr = _jax_trainer(dict(kw, model={"remat": True}), preset)
    assert jtr.long_context_policy_applied == LONG_POLICY
    jstate = jtr.init_state()
    model = dataclasses.replace(tl.preset(preset), remat=True)
    ttr = tt.Trainer(tt.TrainConfig(model=model, attn_impl="flash", **kw),
                     device="cpu")
    assert ttr.long_context_policy_applied == LONG_POLICY
    assert tfa.bwd_route(64, model.head_dim) == "split"
    tstate = ttr.init_state()
    tstate["params"] = tl.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), model, "cpu")
    tstate["opt_state"] = ttr.tx.init(tt.tree_leaves(tstate["params"]))
    data = SyntheticTokens(2, 64, model.vocab_size, seed=11)
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


def test_gemma_2b_full_context_takes_the_split_route():
    """Gemma-2B at its published 8192-token context (the configuration
    chip_smoke.py trains through train_main): the trainer applies the
    long-context policy, as the reference's trainer does for the same
    config, and the backward at hd 256 takes the split pair (its
    whole-sequence fused scratch, 8192 * 256 * 8 bytes, is over the 8 MiB
    cap). Only the trainers are built, never Gemma-2B's parameters."""
    from kubedl_tpu_torch.ops import flash_attention as tfa

    kw = dict(global_batch=1, seq_len=tl.GEMMA_2B.max_seq, steps=4)
    assert kw["seq_len"] == 8192
    ttr = tt.Trainer(tt.TrainConfig(model=tl.GEMMA_2B, attn_impl="flash",
                                    **kw), device="cpu")
    assert ttr.long_context_policy_applied == LONG_POLICY
    assert (ttr.cfg.model.remat_policy, ttr.cfg.model.loss_chunk) == \
        ("flash_rope", 512)
    assert ttr.attn_impl == "flash"
    assert _jax_trainer(dict(kw), "gemma-2b").long_context_policy_applied \
        == LONG_POLICY
    hd = ttr.cfg.model.head_dim
    assert hd == 256 and tfa.bwd_route(8192, hd) == "split"
    # the lengths where Gemma-2B's backward turns: fused through 4096 keys
    assert tfa.bwd_route(4096, hd) == "fused"
    assert tfa.bwd_route(4097, hd) == "split"


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
], ids=["data2", "sp2", "pipe2"])
def test_trainer_rejects_later_slices(kw):
    cfg = tt.TrainConfig(**kw.get("cfg", {}))
    with pytest.raises(ValueError, match="slice"):
        tt.Trainer(cfg, mesh=kw.get("mesh"), device="cpu")


def test_fit_checkpoint_and_ps_raise(tmp_path):
    """fit(ckpt_dir=...) saves (ported); fit_ps still raises; an MoE
    config builds the MoE family (ported)."""
    from kubedl_tpu_torch.models import moe as tm

    tr = tt.Trainer(tt.TrainConfig(global_batch=2, seq_len=16, steps=1),
                    device="cpu")
    data = iter(SyntheticTokens(2, 16, 256))
    _, summary = tr.fit(data, ckpt_dir=str(tmp_path))
    assert summary["ckpt_saves"] == 1 and (tmp_path / "latest").exists()
    with pytest.raises(ValueError, match="slice"):
        tr.fit_ps(data, None, "w0")
    fam = tt.moe_family(tm.TINY_MOE)
    assert fam.name == "moe" and fam.vocab_size == tm.TINY_MOE.vocab_size
    assert fam.num_params == tm.TINY_MOE.num_params()
    assert tt.family_for(tm.TINY_MOE).name == "moe"
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
    ({"KUBEDL_PS_ADDR": "localhost:1"}, {}),
    ({"KUBEDL_ELASTIC_BASE_WORLD": "4"}, {}),
    ({"KUBEDL_ELASTIC_BASE_DP": "2"}, {}),
    ({}, {"train_mode": "ps"}),
    ({}, {"chaos": {"trainer.step_stall": [{"nth": 1}]}}),
], ids=lambda x: ",".join(f"{k}" for k in x) or "-")
def test_train_main_rejects_what_this_slice_does_not_run(env, opts,
                                                       clean_env):
    from kubedl_tpu_torch.training import entry

    cfg = dict({"model": "tiny", "steps": 1, "seq_len": 16, "device": "cpu"},
               **opts)
    with pytest.raises(ValueError, match="slice"):
        entry.train_main(dict(env, KUBEDL_TRAIN_CONFIG=json.dumps(cfg)))


def test_train_main_moe_names_as_the_reference(capsys, clean_env):
    """A model name containing "moe" is an MoE preset, as in the
    reference: "moe-tiny" is none and raises KeyError there and here;
    "tiny-moe" trains."""
    from kubedl_tpu.training import entry as jentry
    from kubedl_tpu_torch.training import entry

    for mod in (entry, jentry):
        with pytest.raises(KeyError):
            mod._model_preset("moe-tiny")
    cfg = {"model": "moe-tiny", "steps": 1, "seq_len": 16, "device": "cpu"}
    with pytest.raises(KeyError):
        entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg)})
    cfg["model"] = "tiny-moe"
    assert entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg)}) == 0
    s = entry.LAST_SUMMARY
    assert s["model_family"] == "moe" and np.isfinite(s["final_loss"])


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
