"""The port's Llama model functions (kubedl_tpu_torch.models.llama)
against the JAX reference on the same parameters.

Parameters are the reference's ``llama_init(PRNGKey(0), cfg)`` carried
over with ``params_from_numpy``; inputs are numpy arrays fed to both.
Tolerances: float32 logits within 1e-4 max abs and pools within 1e-5
(reordered float32 sums over a few layers sit near 1e-6); greedy token
chains identical; the bf16 case within 0.15 max abs on logits (bf16
activations carry ~3 significant digits through two layers of both
frameworks, which round at different places) with identical argmax.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
B, MAX_SEQ, BS = 2, 64, 4
MBK = MAX_SEQ // BS
NB = 1 + B * MBK


def _setup(name, dtype=None):
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    jcfg = jl.preset(name)
    tcfg = tl.preset(name)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jc = jl.init_paged_cache(jcfg, B, MAX_SEQ, NB, BS)
    jc["bt"] = jnp.arange(1, NB, dtype=jnp.int32).reshape(B, MBK)
    tc = tl.init_paged_cache(tcfg, B, MAX_SEQ, NB, BS, "cpu")
    tc["bt"] = torch.arange(1, NB, dtype=torch.int32).reshape(B, MBK)
    return jl, jcfg, jp, jc, tcfg, tp, tc


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _clone(c):
    return {k: v.clone() for k, v in c.items()}


def _prefill(jl, jcfg, jp, jc, tcfg, tp, tc):
    import jax.numpy as jnp

    toks = np.array([[5, 9, 13, 0], [1, 2, 0, 0]], np.int32)
    lens = np.array([3, 2], np.int32)
    jlog, jc = jl.paged_prefill_batched(jp, jc, jnp.asarray(toks),
                                        jnp.asarray(lens), jcfg)
    tlog, tc = tl.paged_prefill_batched(tp, tc, torch.tensor(toks),
                                        torch.tensor(lens), tcfg)
    return jlog, jc, tlog, tc


def _assert_cache(jc, tc):
    for f in ("k", "v"):
        a, b = _np(jc[f]), _np(tc[f])
        assert np.abs(a - b).max() < POOL_TOL, f
        # the same slots were written (the rest is still zero on both)
        assert np.array_equal(a != 0, b != 0), f
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_prefill_batched_matches(name):
    jl, jcfg, jp, jc, tcfg, tp, tc = _setup(name)
    jlog, jc, tlog, tc = _prefill(jl, jcfg, jp, jc, tcfg, tp, tc)
    assert np.abs(_np(jlog) - _np(tlog)).max() < LOGIT_TOL
    _assert_cache(jc, tc)


@pytest.mark.parametrize("kern", ["gather", "blocked"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_prefill_from_matches(name, kern):
    import jax.numpy as jnp

    jl, jcfg, jp, jc, tcfg, tp, tc = _setup(name)
    _, jc, _, tc = _prefill(jl, jcfg, jp, jc, tcfg, tp, tc)
    st = np.asarray(jc["pos"])
    sfx = np.array([[7, 7, 0, 0, 0, 0], [3, 4, 5, 6, 8, 9]], np.int32)
    sl = np.array([2, 6], np.int32)  # row 1 crosses two block boundaries
    a, jc = jl.paged_prefill_from(jp, jc, jnp.asarray(sfx), jnp.asarray(sl),
                                  jnp.asarray(st), jcfg, kv_attention=kern)
    b, tc = tl.paged_prefill_from(tp, tc, torch.tensor(sfx), torch.tensor(sl),
                                  torch.tensor(st), tcfg, kv_attention=kern)
    assert np.abs(_np(a) - _np(b)).max() < LOGIT_TOL
    _assert_cache(jc, tc)


@pytest.mark.parametrize("kern", ["gather", "blocked"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_decode_step_matches(name, kern):
    import jax.numpy as jnp

    jl, jcfg, jp, jc, tcfg, tp, tc = _setup(name)
    jlog, jc, _, tc = _prefill(jl, jcfg, jp, jc, tcfg, tp, tc)
    nxt = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    a, jc = jl.paged_decode_step_batched(jp, jc, jnp.asarray(nxt), jcfg,
                                         kv_attention=kern)
    b, tc = tl.paged_decode_step_batched(tp, tc, torch.tensor(nxt), tcfg,
                                         kv_attention=kern)
    assert np.abs(_np(a) - _np(b)).max() < LOGIT_TOL
    _assert_cache(jc, tc)


@pytest.mark.parametrize("kern", ["gather", "blocked"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_greedy_segment_chain_identical(name, kern):
    import jax
    import jax.numpy as jnp

    jl, jcfg, jp, jc, tcfg, tp, tc = _setup(name)
    jlog, jc, _, tc = _prefill(jl, jcfg, jp, jc, tcfg, tp, tc)
    nxt = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    ja, jlast, _, _ = jl.paged_decode_segment(
        jp, jc, jnp.asarray(nxt), jnp.zeros((B,), jnp.float32),
        jax.random.PRNGKey(1), jcfg, n_steps=16, greedy=True,
        kv_attention=kern,
    )
    ta, tlast, _ = tl.paged_decode_segment(
        tp, tc, torch.tensor(nxt), torch.zeros(B), None, tcfg, n_steps=16,
        greedy=True, kv_attention=kern,
    )
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jlast), tlast.numpy())


def test_bf16_decode_within_stated_tolerance():
    import jax.numpy as jnp

    jl, jcfg, jp, jc, tcfg, tp, tc = _setup("tiny", dtype="bf16")
    jlog, jc, tlog, tc = _prefill(jl, jcfg, jp, jc, tcfg, tp, tc)
    assert np.abs(_np(jlog) - _np(tlog)).max() < 0.15
    nxt = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    a, _ = jl.paged_decode_step_batched(jp, jc, jnp.asarray(nxt), jcfg,
                                        kv_attention="blocked")
    b, _ = tl.paged_decode_step_batched(tp, tc, torch.tensor(nxt), tcfg,
                                        kv_attention="blocked")
    assert np.abs(_np(a) - _np(b)).max() < 0.15
    assert np.array_equal(np.argmax(_np(a), -1), np.argmax(_np(b), -1))


def test_sampled_segment_deterministic_per_generator_seed():
    """Temperature > 0: the Gumbel noise is keyed off the explicit
    generator alone — same seed, same stream, across kernels."""
    _, _, _, _, tcfg, tp, tc0 = _setup("tiny")
    toks = torch.tensor([[5], [1]], dtype=torch.int32)
    temps = torch.full((B,), 0.8)

    def run(seed, kern):
        g = torch.Generator().manual_seed(seed)
        t, _, _ = tl.paged_decode_segment(tp, _clone(tc0), toks, temps, g,
                                          tcfg, n_steps=12,
                                          kv_attention=kern)
        return t.numpy()

    a, b, c = run(1, "gather"), run(1, "gather"), run(1, "blocked")
    assert np.array_equal(a, b) and np.array_equal(a, c)
    assert not np.array_equal(a, run(7, "gather"))


def test_nonfinite_counter_and_merge_chain():
    _, _, _, _, tcfg, tp, tc = _setup("tiny")
    bad = torch.zeros((), dtype=torch.int64)
    tl.paged_decode_segment(tp, tc, torch.tensor([[5], [1]], dtype=torch.int32),
                            torch.zeros(B), None, tcfg, n_steps=2,
                            greedy=True, nonfinite=bad)
    assert int(bad) == 0
    last = torch.tensor([[3], [4], [5]], dtype=torch.int32)
    ids = torch.tensor([7, 8, 9], dtype=torch.int32)
    mask = torch.tensor([True, False, True])
    assert tl.merge_chain_tokens(last, ids, mask)[:, 0].tolist() == [7, 4, 9]


def test_params_from_numpy_copies():
    tree = {"embed": np.ones((4, 2), np.float32),
            "layers": {"wq": np.zeros((1, 2, 2), np.float32)}}
    out = tl.params_from_numpy(tree, tl.preset("tiny"), "cpu")
    tree["embed"][:] = 5.0
    assert float(out["embed"].max()) == 1.0


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma", "tiny-deep"])
def test_init_tree_matches_reference_shapes(name):
    import jax

    from kubedl_tpu.models import llama as jl

    shapes = jax.eval_shape(lambda: jl.llama_init(jax.random.PRNGKey(0),
                                                  jl.preset(name)))
    cfg = tl.preset(name)
    got = tl.llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_ref = {k: v.shape for k, v in _flatten(shapes).items()}
    assert {k: tuple(v.shape) for k, v in _flatten(got).items()} == \
        {k: tuple(s) for k, s in flat_ref.items()}
    assert all(v.dtype == cfg.dtype for v in _flatten(got).values())
    if cfg.zero_init_deep_from:
        d = cfg.zero_init_deep_from
        assert float(got["layers"]["wo"][d:].abs().max()) == 0.0
        assert float(got["layers"]["wo"][:d].abs().max()) > 0.0
    norm = 0.0 if cfg.norm_plus_one else 1.0
    assert float(got["final_norm"][0]) == norm
    # N(0, 1/fan_in): the embedding's std is ~1/sqrt(dim)
    std = float(got["embed"].float().std())
    assert abs(std * np.sqrt(cfg.dim) - 1.0) < 0.1


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def test_presets_match_reference():
    from kubedl_tpu.models import llama as jl

    for name, cfg in tl.PRESETS.items():
        ref = jl.preset(name)
        for f in dataclasses.fields(cfg):
            if f.name == "dtype":
                assert str(cfg.dtype).split(".")[-1] == \
                    np.dtype(ref.dtype).name, name
                continue
            assert getattr(cfg, f.name) == getattr(ref, f.name), (name, f.name)
        assert cfg.head_dim == ref.head_dim
        assert cfg.num_params() == ref.num_params()


def test_llama3_8b_preset_shape():
    cfg = tl.preset("llama3-8b")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.vocab_size) == \
        (4096, 32, 32, 8, 128, 14336, 128256)
    assert cfg.dtype == torch.bfloat16
    assert abs(cfg.num_params() * 2 / 1e9 - 16.06) < 0.01  # GB in bf16


def test_paged_cache_layout_and_guard():
    cfg = tl.preset("tiny")
    c = tl.init_paged_cache(cfg, 3, 32, 9, 8, "cpu")
    assert tuple(c["k"].shape) == (2, 9, 8, 2, 16)
    assert tuple(c["bt"].shape) == (3, 4) and c["bt"].dtype == torch.int32
    with pytest.raises(ValueError):
        tl.init_paged_cache(cfg, 1, 30, 9, 8, "cpu")
    with pytest.raises(ValueError):
        tl.paged_decode_step_batched({}, c, torch.zeros((3, 1)), cfg,
                                     kv_attention="dense")


# ---- the training path: presets, forward, loss, gradients, remat -----------

@pytest.mark.parametrize("name", sorted(tl.PRESETS))
def test_preset_asdict_equals_reference(name):
    """Every field of every preset, the training fields included (dtype by
    name), so the port's config cannot drift from the reference's."""
    from kubedl_tpu.models import llama as jl

    mine = dataclasses.asdict(tl.preset(name))
    ref = dataclasses.asdict(jl.preset(name))
    assert set(mine) == set(ref)
    for key in ref:
        if key == "dtype":
            assert str(mine[key]).split(".")[-1] == np.dtype(ref[key]).name
        else:
            assert mine[key] == ref[key], (name, key)
    assert tl.preset(name).flops_per_token() == jl.preset(name).flops_per_token()


def _entry_cfgs():
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    kw = dict(vocab_size=2048, dim=256, n_layers=4, n_heads=8, n_kv_heads=4,
              ffn_dim=768, max_seq=512, remat=False)
    return (jl.LlamaConfig(dtype=jnp.bfloat16, **kw),
            tl.LlamaConfig(dtype=torch.bfloat16, **kw))


def _model_setup(name):
    import jax

    from kubedl_tpu.models import llama as jl

    if name == "entry":
        jcfg, tcfg = _entry_cfgs()
    else:
        jcfg, tcfg = jl.preset(name), tl.preset(name)
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 64)).astype(np.int32)
    return jl, jcfg, jp, tcfg, tp, toks


def _attn_fns():
    from kubedl_tpu_torch.ops import flash_attention as tfa

    def flash_unfused(q, k, v, causal=True, mask=None):
        return tfa.flash_attention(q, k, v, causal=causal, mask=mask)

    return {"dense": None, "flash": flash_unfused,
            "flash-fused-rope": tfa.make_flash_attention()}


#: f32 logits 1e-4 max abs (reordered float32 sums over a few layers sit
#: near 1e-6); the bf16 entry config 0.25: bf16 activations carry ~3
#: digits through 4 layers of two frameworks that round at different
#: places, against logits of magnitude ~10
MODEL_TOL = {"tiny": 1e-4, "tiny-gemma": 1e-4, "entry": 0.25}


@pytest.mark.parametrize("attn", ["dense", "flash", "flash-fused-rope"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma", "entry"])
def test_forward_and_loss_match_reference(name, attn):
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp, toks = _model_setup(name)
    want = np.asarray(jl.llama_forward(jp, jnp.asarray(toks), jcfg),
                      np.float32)
    fn = _attn_fns()[attn]
    got = tl.llama_forward(tp, torch.from_numpy(toks), tcfg, fn)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < MODEL_TOL[name]
    lw = float(jl.llama_loss(jp, jnp.asarray(toks), jcfg))
    lg = float(tl.llama_loss(tp, torch.from_numpy(toks), tcfg, fn))
    assert abs(lw - lg) < MODEL_TOL[name] * 0.1 * max(1.0, abs(lw))


def test_entry_hook_runs_the_forward_on_request_device():
    from kubedl_tpu_torch.entry import entry

    fn, (params, tokens) = entry(device="cpu")
    assert tuple(tokens.shape) == (2, 256) and fn.cfg.dtype == torch.bfloat16
    logits = fn(params, tokens)
    assert tuple(logits.shape) == (2, 256, 2048)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("knob", ["loss_chunk", "fuse_projections"])
def test_loss_chunk_and_fused_projections_change_nothing(knob):
    _, _, _, tcfg, tp, toks = _model_setup("tiny")
    t = torch.from_numpy(toks)
    base = tl.llama_loss(tp, t, tcfg, _attn_fns()["flash-fused-rope"])
    value = 24 if knob == "loss_chunk" else True
    other = dataclasses.replace(tcfg, **{knob: value})
    got = tl.llama_loss(tp, t, other, _attn_fns()["flash-fused-rope"])
    assert abs(float(got) - float(base)) < 1e-5


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_gradients_match_reference(remat):
    """d llama_loss / d every leaf, f32 tiny, within 1e-4 of jax.grad
    (with and without the per-layer checkpoint)."""
    import jax
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp, toks = _model_setup("tiny")
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    gj = jax.grad(lambda p: jl.llama_loss(p, jnp.asarray(toks), jcfg))(jp)
    flat = _leaves(tp)
    for v in flat.values():
        v.requires_grad_(True)
    loss = tl.llama_loss(tp, torch.from_numpy(toks), tcfg,
                         _attn_fns()["flash-fused-rope"])
    grads = torch.autograd.grad(loss, list(flat.values()))
    ref = {k: np.asarray(v) for k, v in _leaves(gj).items()}
    assert set(ref) == set(flat)
    for (k, _), g in zip(flat.items(), grads):
        np.testing.assert_allclose(g.numpy(), ref[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("policy,per_layer", [
    ("flash_rope", 1), ("flash", 1), ("dots_flash", 1), ("attn_flash", 1),
    ("dots", 2), ("nothing", 2),
])
def test_remat_never_reruns_the_forward_kernel(policy, per_layer, monkeypatch):
    """Forward-kernel calls per llama_loss forward+backward on tiny with
    remat: once per layer under the flash policies (the checkpoint saves
    the operator's out/lse), twice under "dots"/"nothing" (the documented
    rerun) — the counterpart of the reference's TestRematKernelCounts."""
    from kubedl_tpu_torch.ops import flash_attention as tfa

    cfg = dataclasses.replace(tl.TINY, remat=True, remat_policy=policy)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = list(_leaves(params).values())
    for v in leaves:
        v.requires_grad_(True)
    calls = []
    real = tfa._plain_fwd
    monkeypatch.setattr(tfa, "_plain_fwd", lambda *a: calls.append(1) or real(*a))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32))
    loss = tl.llama_loss(params, toks, cfg, tfa.make_flash_attention())
    torch.autograd.grad(loss, leaves)
    assert len(calls) == per_layer * cfg.n_layers


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tl.remat_policy_for("everything")
