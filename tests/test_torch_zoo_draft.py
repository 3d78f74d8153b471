"""Trained zoo drafts in the port (``kubedl_tpu_torch/planner/costmodel.py``,
``serving/speculative.py::ModelDraft.from_zoo`` / ``distill_draft``, the
engine's ``spec_draft="zoo:<name>"``) and the Adam update they train with
(``ops/adamw.py::Adam``), against the JAX package on the CPU.

Tolerances, float32 unless said:

- the zoo and ``from_zoo``'s config: equal, entry by entry and field by
  field;
- ``Adam`` against a jitted ``optax.adam`` over 6 steps: bf16 parameters
  with bf16 moments bit for bit; float32 parameters within 1 ulp of each
  leaf's largest magnitude, the moments within 4 (the CPU backend
  contracts some multiply-adds into FMAs, e.g. ``mu' = fma(g, 0.1, mu *
  0.9)``, which the port leaves as separate float32 roundings, and the
  moments carry those differences from step to step);
- a non-finite gradient entry: the same elements non-finite as in
  ``optax.adam``, with the same values, the rest as the float32 case;
- drafts restored from one npz: proposals identical;
- ``distill_draft``: the teacher's rollouts identical, each of 5 losses
  within 1e-4 relative, the final parameters within 1e-4 (max abs
  difference over the largest magnitude), the proposals afterwards
  identical;
- the engine with ``zoo:tiny`` and ``KUBEDL_SPEC_DRAFT_CKPT``: greedy
  streams identical to the JAX model functions' chain.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.ops.adamw import Adam  # noqa: E402
from kubedl_tpu_torch.planner import costmodel as tcm  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402
from kubedl_tpu_torch.serving import speculative as tsp  # noqa: E402

LOSS_RTOL = 1e-4
PARAM_TOL = 1e-4
PROMPTS = [[5, 9, 13, 5, 9, 13, 5, 9], [7, 3, 3, 11, 2], [1, 2, 3, 4, 5, 6],
           [200, 17, 17, 40]]


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def tiny():
    """(jl, jcfg, jp, tcfg, tp): the reference's tiny target in both."""
    import jax

    from kubedl_tpu.models import llama as jl

    jcfg = jl.preset("tiny")
    tcfg = tl.preset("tiny")
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jl, jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def zoo_npz(tiny, tmp_path_factory):
    """A reference ``zoo:tiny`` draft (seed 0) saved to npz: both
    packages' drafts start from it."""
    from kubedl_tpu.serving import speculative as jsp

    _jl, jcfg, _jp, _tcfg, _tp = tiny
    path = str(tmp_path_factory.mktemp("zoo") / "zoo_tiny.npz")
    jsp.ModelDraft.from_zoo("tiny", jcfg, max_context=64).save(path)
    return path


# ---- the planner's zoo ------------------------------------------------------

def test_model_zoo_has_the_reference_names():
    from kubedl_tpu.planner import costmodel as jcm

    assert sorted(tcm.MODEL_ZOO) == sorted(jcm.MODEL_ZOO)
    assert [f.name for f in dataclasses.fields(tcm.ModelDesc)] == \
        [f.name for f in dataclasses.fields(jcm.ModelDesc)]


@pytest.mark.parametrize("name", ["tiny", "gpt-350m", "llama-1b", "llama-4b"])
def test_model_zoo_entry_matches_reference(name):
    from kubedl_tpu.planner import costmodel as jcm

    mine, ref = tcm.MODEL_ZOO[name], jcm.MODEL_ZOO[name]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.num_params() == ref.num_params()
    # a given count wins over the derived one, in both
    assert tcm.ModelDesc(params=123, layers=2, hidden=8).num_params() == \
        jcm.ModelDesc(params=123, layers=2, hidden=8).num_params() == 123


# ---- from_zoo -----------------------------------------------------------------

@pytest.mark.parametrize("target", ["tiny", "tiny-gemma", "llama3-8b"])
@pytest.mark.parametrize("name", ["tiny", "gpt-350m", "llama-1b", "llama-4b"])
def test_from_zoo_config_matches_reference(name, target, monkeypatch):
    """The draft's config, field by field, for every zoo entry under three
    targets; the inits are stubbed out in both packages (the larger
    entries would build hundreds of millions of parameters)."""
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.serving import speculative as jsp

    monkeypatch.setattr(jl, "llama_init", lambda key, cfg: {})
    monkeypatch.setattr(tl, "llama_init", lambda cfg, gen, dev: {})
    jd = jsp.ModelDraft.from_zoo(name, jl.preset(target))
    td = tsp.ModelDraft.from_zoo(name, tl.preset(target), device="cpu")
    mine, ref = dataclasses.asdict(td.cfg), dataclasses.asdict(jd.cfg)
    assert mine.pop("dtype") == {jnp.float32: torch.float32,
                                 jnp.bfloat16: torch.bfloat16}[
        ref.pop("dtype")]
    assert mine == ref
    assert td.name == jd.name == f"zoo:{name}"
    assert td.max_context == jd.max_context


def test_unknown_zoo_name_raises_the_reference_message(tiny):
    from kubedl_tpu.serving import speculative as jsp

    _jl, jcfg, _jp, tcfg, _tp = tiny
    with pytest.raises(ValueError) as want:
        jsp.ModelDraft.from_zoo("no-such", jcfg)
    with pytest.raises(ValueError) as got:
        tsp.ModelDraft.from_zoo("no-such", tcfg, device="cpu")
    assert str(got.value) == str(want.value)


def test_from_zoo_needs_a_card_unless_the_cpu_is_asked_for(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.ModelDraft.from_zoo("tiny", tiny[3])


def test_zoo_draft_checkpoints_cross_packages(tiny, zoo_npz, tmp_path):
    """A reference-saved zoo draft restores into the port (and the
    port's into the reference): proposals identical both ways."""
    from kubedl_tpu.serving import speculative as jsp

    _jl, jcfg, _jp, tcfg, _tp = tiny
    jd = jsp.ModelDraft.from_zoo("tiny", jcfg, ckpt_path=zoo_npz,
                                 max_context=64)
    td = tsp.ModelDraft.from_zoo("tiny", tcfg, ckpt_path=zoo_npz,
                                 max_context=64, device="cpu", seed=5)
    for k in (1, 4):
        assert td.propose_batch(PROMPTS, k) == jd.propose_batch(PROMPTS, k)
    # the port's own seeded init, saved, restored by the reference
    fresh = tsp.ModelDraft.from_zoo("tiny", tcfg, max_context=64,
                                    device="cpu", seed=3)
    fresh.save(str(tmp_path / "port.npz"))
    jd2 = jsp.ModelDraft.from_zoo("tiny", jcfg, ckpt_path=str(
        tmp_path / "port.npz"), max_context=64)
    assert fresh.propose_batch(PROMPTS, 3) == jd2.propose_batch(PROMPTS, 3)


# ---- the Adam update ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_matches_jitted_optax_adam(dtype):
    import jax
    import jax.numpy as jnp
    import optax

    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.RandomState(0)
    shapes = [(64, 32), (7,), (33, 5)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(6)]
    tx = optax.adam(3e-3)

    @jax.jit
    def step(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    jp = [jnp.asarray(a, jdt) for a in p0]
    js = tx.init(jp)
    tp = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt) for a in jp]
    opt = Adam(tp, 3e-3)
    assert [m.dtype for m in opt.mu + opt.nu] == [tdt] * 6
    for g in grads:
        jg = [jnp.asarray(a, jdt) for a in g]
        jp, js = step(jp, js, jg)
        opt.step([torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt)
                  for a in jg])
        adam = js[0]
        for ulps, pairs in ((1, zip(tp, jp)), (4, zip(opt.mu, adam.mu)),
                            (4, zip(opt.nu, adam.nu))):
            for mine, ref in pairs:
                a, b = _np(mine), np.asarray(ref.astype(jnp.float32))
                if dtype == "bfloat16":
                    assert np.array_equal(a, b)
                else:
                    ulp = np.spacing(np.float32(np.abs(b).max()))
                    assert np.abs(a - b).max() <= ulps * ulp
    assert opt.count == 6


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_adam_nonfinite_gradient_poisons_only_its_element(bad):
    """One leaf's gradient holds one non-finite entry: ``optax.adam``
    (no clipping stage, no norm) turns only that element's parameter and
    moments non-finite; every other element, in that leaf and the
    others, takes its finite update. ``Adam`` gives the same elements,
    finite ones within the float32 tolerance of the test above and
    non-finite ones at the same places with the same values."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(1)
    shapes = [(16, 8), (5,), (9, 3)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [(rng.randn(*s) * 1e-2).astype(np.float32) for s in shapes]
    grads[1][3] = bad
    tx = optax.adam(3e-3)
    jp = [jnp.asarray(a) for a in p0]
    u, js = jax.jit(tx.update)([jnp.asarray(g) for g in grads],
                               tx.init(jp), jp)
    jp = optax.apply_updates(jp, u)
    tp = [torch.tensor(a) for a in p0]
    opt = Adam(tp, 3e-3)
    assert opt.step([torch.tensor(g) for g in grads]) is None
    adam = js[0]
    for pairs, ulps in ((zip(tp, jp), 1), (zip(opt.mu, adam.mu), 4),
                        (zip(opt.nu, adam.nu), 4)):
        for mine, ref in pairs:
            a, b = _np(mine), np.asarray(ref)
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin)
            np.testing.assert_array_equal(a[~fin], b[~fin])
            ulp = np.spacing(np.float32(np.abs(b[fin]).max()))
            assert np.abs(a[fin] - b[fin]).max() <= ulps * ulp
    assert int((~np.isfinite(_np(tp[1]))).sum()) == 1
    assert all(np.isfinite(_np(t)).all() for t in (tp[0], tp[2]))


# ---- distillation --------------------------------------------------------------

def test_distill_draft_matches_reference(tiny, zoo_npz):
    """From one npz start and the converted target: the rollouts, each
    of 5 losses, the final parameters and the proposals afterwards."""
    import jax

    from kubedl_tpu.serving import speculative as jsp

    _jl, jcfg, jp, tcfg, tp = tiny
    prompts, gen_len, steps, lr = PROMPTS[:3], 8, 5, 1e-2
    want_roll = jsp.ModelDraft(jp, jcfg, max_context=jcfg.max_seq) \
        .propose_batch(prompts, gen_len)
    got_roll = tsp.ModelDraft(tp, tcfg, max_context=tcfg.max_seq) \
        .propose_batch(prompts, gen_len)
    assert got_roll == want_roll
    jd = jsp.ModelDraft.from_zoo("tiny", jcfg, ckpt_path=zoo_npz,
                                 max_context=64)
    td = tsp.ModelDraft.from_zoo("tiny", tcfg, ckpt_path=zoo_npz,
                                 max_context=64, device="cpu")
    want = jsp.distill_draft(jd, jp, jcfg, prompts, gen_len=gen_len,
                             steps=steps, lr=lr)
    got = tsp.distill_draft(td, tp, tcfg, prompts, gen_len=gen_len,
                            steps=steps, lr=lr)
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    for a, b in zip(_leaves(td.params), jax.tree_util.tree_leaves(jd.params)):
        b = np.asarray(b, np.float32)
        assert np.abs(_np(a) - b).max() <= PARAM_TOL * max(np.abs(b).max(),
                                                           1.0)
        assert not a.requires_grad
    for k in (1, 4):
        assert td.propose_batch(PROMPTS, k) == jd.propose_batch(PROMPTS, k)


def _leaves(tree):
    from kubedl_tpu_torch.training.trainer import tree_leaves

    return tree_leaves(tree)


def test_distill_draft_leaves_the_target_as_it_was(tiny):
    """An early-exit draft is built from the target's own tensors (views
    of its stacked layers); distilling it must leave every leaf of the
    target equal, as the reference's does, with the losses unchanged."""
    from kubedl_tpu.serving import speculative as jsp

    _jl, jcfg, jp, tcfg, tp = tiny
    prompts = [list(range(1, 9)), list(range(3, 11))]
    before = [a.clone() for a in _leaves(tp)]
    td = tsp.ModelDraft.from_target(tp, tcfg, 1)
    got = tsp.distill_draft(td, tp, tcfg, prompts, gen_len=4, steps=2,
                            lr=1e-2)
    for a, b in zip(_leaves(tp), before):
        assert torch.equal(a, b)
    jd = jsp.ModelDraft.from_target(jp, jcfg, 1)
    want = jsp.distill_draft(jd, jp, jcfg, prompts, gen_len=4, steps=2,
                             lr=1e-2)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# ---- the engine ---------------------------------------------------------------

MAX_TOKENS = 12
ENGINE_KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
                 kv_block_size=4, kv_attention="blocked")


@pytest.fixture(scope="module")
def distilled(tiny, zoo_npz, tmp_path_factory):
    """The zoo draft distilled on the target's rollouts of PROMPTS,
    saved; and the JAX model functions' greedy chain of each prompt."""
    import jax
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    td = tsp.ModelDraft.from_zoo("tiny", tcfg, ckpt_path=zoo_npz,
                                 max_context=64, device="cpu")
    losses = tsp.distill_draft(td, tp, tcfg, PROMPTS, gen_len=MAX_TOKENS,
                               steps=30, lr=1e-2)
    path = str(tmp_path_factory.mktemp("zoo") / "distilled.npz")
    td.save(path)
    mbk = 16
    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jp, c, t, jcfg, kv_attention="blocked"))

    def chain(prompt, n):
        c = jl.init_paged_cache(jcfg, 1, 64, 1 + mbk, 4)
        c["bt"] = jnp.arange(1, 1 + mbk, dtype=jnp.int32)[None]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        lg, c = jl.paged_prefill_batched(
            jp, c, jnp.asarray(toks), jnp.asarray([len(prompt)], jnp.int32),
            jcfg)
        out = [int(jnp.argmax(lg[0]))]
        while len(out) < n:
            lg, c = step(c, jnp.asarray([[out[-1]]], jnp.int32))
            out.append(int(jnp.argmax(lg[0])))
        return out

    return path, losses, {tuple(p): chain(p, MAX_TOKENS) for p in PROMPTS}


@pytest.mark.parametrize("concurrent", [False, True])
def test_engine_zoo_draft_streams_match_jax_chain(tiny, distilled, monkeypatch,
                                                  concurrent):
    """``spec_draft="zoo:tiny"`` with ``KUBEDL_SPEC_DRAFT_CKPT`` naming the
    distilled draft: greedy streams identical to the chain's, and the
    trained draft is accepted on the prompts it was distilled on."""
    path, losses, want = distilled
    assert losses[-1] < losses[0]
    monkeypatch.setenv("KUBEDL_SPEC_DRAFT_CKPT", path)
    eng = srv.LlamaEngine(**ENGINE_KW, params=tiny[4], spec_k=4,
                          spec_draft="zoo:tiny")
    try:
        assert eng._draft.name == "zoo:tiny"
        assert eng._draft.max_context == eng.max_seq
        outs = [None] * len(PROMPTS)

        def one(j):
            outs[j] = eng.generate(PROMPTS[j], max_tokens=MAX_TOKENS)

        if concurrent:
            ths = [threading.Thread(target=one, args=(j,))
                   for j in range(len(PROMPTS))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=300)
        else:
            for j in range(len(PROMPTS)):
                one(j)
        st = eng.stats()
    finally:
        eng.close()
    assert [o["token_ids"] for o in outs] == \
        [want[tuple(p)] for p in PROMPTS]
    sp = st["speculative"]
    assert sp["draft_kind"] == "zoo:tiny"
    assert sp["verifies"] > 0 and sp["accepted"] > 0


def test_serve_main_zoo_draft_restores_the_checkpoint(tiny, distilled,
                                                      monkeypatch):
    """Through ``serve_main``'s config mapping: the engine it builds
    carries the distilled weights (the npz's leaves)."""
    path, _losses, _want = distilled
    monkeypatch.setenv("KUBEDL_SPEC_DRAFT_CKPT", path)
    kw = srv.engine_kwargs({"preset": "tiny", "spec_k": 3,
                            "spec_draft": "zoo:tiny", "device": "cpu",
                            "max_seq": 64}, "")
    eng = srv.LlamaEngine(**kw)
    try:
        with np.load(path) as z:
            for i, leaf in enumerate(_leaves(eng._draft.params)):
                assert np.array_equal(_np(leaf), z[f"leaf_{i}"])
    finally:
        eng.close()
