"""The port's speculative decoding (kubedl_tpu_torch.serving.speculative,
the verify functions of kubedl_tpu_torch.models.llama and the read-only
attention modes) against the JAX reference on the CPU.

Parameters are the reference's ``llama_init(PRNGKey(0))`` carried over
with ``params_from_numpy``; inputs are numpy arrays made from seeds and
fed to both packages. Tolerances, float32 throughout:

- read-only attention modes against ``_lax_paged_attention`` with
  ``self_k``/``self_mask``: max abs 1e-5 (reordered float32 sums sit
  near 1e-7 at these sizes);
- verify hidden states 1e-5 max abs, greedy ids identical;
- the contiguous functions: logits 1e-4 max abs (two layers of float32
  matmuls in two frameworks sit near 1e-6), cache K/V 1e-5, positions
  and greedy ids identical;
- drafts, trees, acceptance and ``SpecStats``: identical.

The engine cases compare greedy streams with a chain built from the JAX
model functions (``paged_prefill_batched`` + ``paged_decode_step_batched``
with the lax kernel), never with the JAX engine.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.models import paged_attention as tpa  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402
from kubedl_tpu_torch.serving import speculative as tsp  # noqa: E402

ATT_TOL = 1e-5
HID_TOL = 1e-5
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
B, MAX_SEQ, BS = 2, 64, 4
MBK = MAX_SEQ // BS
NB = 1 + B * MBK


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def tiny():
    """(jl, jcfg, jp, tcfg, tp): the reference's tiny params in both."""
    import jax

    from kubedl_tpu.models import llama as jl

    jcfg = jl.preset("tiny")
    tcfg = tl.preset("tiny")
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jl, jcfg, jp, tcfg, tp


def _paged_caches(jcfg, seed):
    """A JAX and a port paged cache holding the same random pools (every
    row's blocks written, as after a prefill), rows owning blocks 1..."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    shape = (jcfg.n_layers, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    bt = np.arange(1, NB, dtype=np.int32).reshape(B, MBK)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "pos": jnp.zeros((B,), jnp.int32), "bt": jnp.asarray(bt)}
    tc = {"k": torch.tensor(k), "v": torch.tensor(v),
          "pos": torch.zeros((B,), dtype=torch.int32),
          "bt": torch.tensor(bt)}
    return jc, tc


# ---- read-only attention modes ----------------------------------------------

@pytest.mark.parametrize("starts,masked", [
    ([0, 0], False),  # no history at all: the -1e29 fold guard's case
    ([5, 16], False),  # history ending mid-block and at a block boundary
    ([31, 3], True),  # a trie mask
    ([0, 9], True),
])
def test_read_only_modes_match_jax_lax(starts, masked):
    import jax.numpy as jnp

    from kubedl_tpu.models import paged_attention as pa

    rng = np.random.RandomState(sum(starts) + masked)
    b, mb, bs, kv, h, hd, S = 2, 8, 4, 2, 4, 16, 5
    nb = 1 + b * mb
    kp = rng.randn(nb, bs, kv, hd).astype(np.float32)
    vp = rng.randn(nb, bs, kv, hd).astype(np.float32)
    kp[0], vp[0] = 37.0, -29.0  # poisoned trash block
    bt = np.arange(1, nb, dtype=np.int32).reshape(b, mb)
    q = rng.randn(b, S, h, hd).astype(np.float32)
    sk = rng.randn(b, S, kv, hd).astype(np.float32)
    sv = rng.randn(b, S, kv, hd).astype(np.float32)
    st = np.asarray(starts, np.int32)
    mask = None
    if masked:  # node m sees itself and a random subset of earlier nodes
        mask = np.tril(rng.rand(b, S, S) > 0.4)
        mask[:, np.arange(S), np.arange(S)] = True
    want = pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(st), self_k=jnp.asarray(sk), self_v=jnp.asarray(sv),
        self_mask=None if mask is None else jnp.asarray(mask), kernel="lax")
    got = tpa.paged_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp), torch.tensor(bt),
        torch.tensor(st), self_k=torch.tensor(sk), self_v=torch.tensor(sv),
        self_mask=None if mask is None else torch.tensor(mask))
    assert np.abs(_np(got) - np.asarray(want)).max() < ATT_TOL
    assert np.isfinite(_np(got)).all()


def test_read_only_mode_leaves_the_pool_alone():
    rng = np.random.RandomState(3)
    kp = torch.tensor(rng.randn(9, 4, 2, 16).astype(np.float32))
    vp = kp.clone()
    before = kp.clone()
    tpa.paged_attention(
        torch.zeros((1, 3, 4, 16)), kp, vp,
        torch.arange(1, 9, dtype=torch.int32)[None],
        torch.tensor([6], dtype=torch.int32),
        self_k=torch.ones((1, 3, 2, 16)), self_v=torch.ones((1, 3, 2, 16)))
    assert torch.equal(kp, before) and torch.equal(vp, before)


# ---- the verify functions ---------------------------------------------------

def test_paged_verify_matches_jax(tiny):
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    jc, tc = _paged_caches(jcfg, seed=1)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 256, size=(B, 5)).astype(np.int32)
    lens = np.array([5, 5], np.int32)
    starts = np.array([7, 16], np.int32)
    jx, jc2 = jl._paged_suffix_forward(
        jp, dict(jc), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(starts), jcfg, kv_attention="blocked")
    tx, _ = tl._paged_suffix_forward(
        tp, {k: v.clone() for k, v in tc.items()}, torch.tensor(toks),
        torch.tensor(lens), torch.tensor(starts), tcfg,
        kv_attention="blocked")
    assert np.abs(_np(tx) - np.asarray(jx)).max() < HID_TOL
    for kern in ("blocked", "gather"):
        jids, jc3 = jl.paged_verify(jp, dict(jc), jnp.asarray(toks),
                                    jnp.asarray(lens), jnp.asarray(starts),
                                    jcfg, kv_attention=kern)
        tc3 = {k: v.clone() for k, v in tc.items()}
        tids, tc3 = tl.paged_verify(tp, tc3, torch.tensor(toks),
                                    torch.tensor(lens), torch.tensor(starts),
                                    tcfg, kv_attention=kern)
        assert np.array_equal(np.asarray(jids), tids.numpy())
        for f in ("k", "v"):
            assert np.abs(_np(tc3[f]) - np.asarray(jc3[f])).max() < POOL_TOL
        assert np.array_equal(np.asarray(jc3["pos"]), tc3["pos"].numpy())


@pytest.mark.parametrize("kern", ["blocked", "gather"])
def test_paged_verify_multi_matches_jax(tiny, kern):
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    jc, tc = _paged_caches(jcfg, seed=2)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 256, size=(B, 3, 4)).astype(np.int32)
    lens = np.array([4, 4], np.int32)
    starts = np.array([0, 21], np.int32)
    want = jl.paged_verify_multi(jp, jc, jnp.asarray(toks),
                                 jnp.asarray(lens), jnp.asarray(starts),
                                 jcfg, kv_attention=kern)
    k_before = tc["k"].clone()
    got = tl.paged_verify_multi(tp, tc, torch.tensor(toks),
                                torch.tensor(lens), torch.tensor(starts),
                                tcfg, kv_attention=kern)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert torch.equal(tc["k"], k_before)  # read-only
    # the hidden states of the flattened read-only forward
    rep = lambda a: np.repeat(a, 3, axis=0)  # noqa: E731
    jflat = {"k": jc["k"], "v": jc["v"], "pos": jnp.asarray(rep(np.zeros(B))),
             "bt": jnp.asarray(rep(np.asarray(jc["bt"])))}
    tflat = {"k": tc["k"], "v": tc["v"], "pos": torch.zeros((B * 3,)),
             "bt": torch.tensor(rep(tc["bt"].numpy()))}
    jx, _ = jl._paged_suffix_forward(
        jp, jflat, jnp.asarray(toks.reshape(B * 3, 4)),
        jnp.asarray(rep(lens)), jnp.asarray(rep(starts)), jcfg,
        kv_attention=kern, self_contained=True)
    tx, _ = tl._paged_suffix_forward(
        tp, tflat, torch.tensor(toks.reshape(B * 3, 4)),
        torch.tensor(rep(lens)), torch.tensor(rep(starts)), tcfg,
        kv_attention=kern, self_contained=True)
    assert np.abs(_np(tx) - np.asarray(jx)).max() < HID_TOL


@pytest.mark.parametrize("kern", ["blocked", "gather"])
def test_paged_verify_tree_matches_jax_and_the_chain(tiny, kern):
    """A trie of three chains scored in one read-only forward: ids equal
    the reference's, and along the greedy chain they equal a chain
    verify of that chain alone (the trie's key-set contract)."""
    import jax.numpy as jnp

    from kubedl_tpu.serving import speculative as jsp

    jl, jcfg, jp, tcfg, tp = tiny
    jc, tc = _paged_caches(jcfg, seed=6)
    k, M = 3, 10
    chains = [[11, 12, 13], [11, 40, 41], [50, 51, 52]]
    starts = np.array([9, 30], np.int32)
    toks = np.zeros((B, M), np.int32)
    pos = np.zeros((B, M), np.int32)
    mask = np.zeros((B, M, M), bool)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        tr = tsp.build_tree(7 + b, chains, k, M)
        t_toks, t_dep, t_mask = tr.arrays(M)
        jt = jsp.build_tree(7 + b, chains, k, M).arrays(M)
        assert all(np.array_equal(x, y) for x, y in zip(jt, tr.arrays(M)))
        toks[b], pos[b], mask[b] = t_toks, starts[b] + t_dep, t_mask
        lens[b] = tr.size
    want = jl.paged_verify_tree(jp, jc, *(jnp.asarray(a) for a in (
        toks, pos, mask, lens, starts)), jcfg, kv_attention=kern)
    got = tl.paged_verify_tree(tp, tc, *(torch.tensor(a) for a in (
        toks, pos, mask, lens, starts)), tcfg, kv_attention=kern)
    assert np.array_equal(np.asarray(want), got.numpy())
    jx, _ = jl._paged_suffix_forward(
        jp, jc, *(jnp.asarray(a) for a in (toks, lens, starts)), jcfg,
        kv_attention=kern, self_contained=True, positions=jnp.asarray(pos),
        self_mask=jnp.asarray(mask))
    tx, _ = tl._paged_suffix_forward(
        tp, tc, *(torch.tensor(a) for a in (toks, lens, starts)), tcfg,
        kv_attention=kern, self_contained=True, positions=torch.tensor(pos),
        self_mask=torch.tensor(mask))
    assert np.abs(_np(tx) - np.asarray(jx)).max() < HID_TOL
    # nodes 0..3 are the root and chain 0: a chain verify sees the same keys
    chain = np.array([[7 + b] + chains[0] for b in range(B)], np.int32)
    cids, _ = tl.paged_verify(tp, {k_: v.clone() for k_, v in tc.items()},
                              torch.tensor(chain), torch.tensor([4, 4]),
                              torch.tensor(starts), tcfg, kv_attention=kern)
    assert np.array_equal(cids.numpy(), got.numpy()[:, :4])


def test_read_only_suffix_forward_rejects_write_path_options(tiny):
    jl, jcfg, jp, tcfg, tp = tiny
    _jc, tc = _paged_caches(jcfg, seed=0)
    with pytest.raises(ValueError):
        tl._paged_suffix_forward(
            tp, tc, torch.zeros((B, 2), dtype=torch.int32),
            torch.tensor([2, 2]), torch.tensor([0, 0]), tcfg,
            positions=torch.zeros((B, 2), dtype=torch.int32))


# ---- the contiguous functions the model draft runs ----------------------------

def test_contiguous_functions_match_jax(tiny):
    import jax
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    T = 32
    jc = jl.init_batched_cache(jcfg, B, T)
    tc = tl.init_batched_cache(tcfg, B, T, "cpu")
    for f in ("k", "v", "pos"):
        assert tuple(jc[f].shape) == tuple(tc[f].shape)
    toks = np.array([[5, 9, 13, 2, 0, 0, 0, 0], [1, 2, 3, 4, 5, 6, 7, 8]],
                    np.int32)
    lens = np.array([4, 8], np.int32)
    jlog, jc = jl.prefill_batched(jp, jc, jnp.asarray(toks),
                                  jnp.asarray(lens), jcfg)
    tlog, tc = tl.prefill_batched(tp, tc, torch.tensor(toks),
                                  torch.tensor(lens), tcfg)
    assert np.abs(_np(tlog) - np.asarray(jlog)).max() < LOGIT_TOL

    def same_cache():
        for f in ("k", "v"):
            assert np.abs(_np(tc[f]) - np.asarray(jc[f])).max() < POOL_TOL
        assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())

    same_cache()
    step = np.array([[3], [4]], np.int32)
    jlog, jc = jl.decode_step_batched(jp, jc, jnp.asarray(step), jcfg)
    tlog, tc = tl.decode_step_batched(tp, tc, torch.tensor(step), tcfg)
    assert np.abs(_np(tlog) - np.asarray(jlog)).max() < LOGIT_TOL
    same_cache()
    jt, jlast, _key, jc = jl.decode_segment(
        jp, jc, jnp.asarray(step), jnp.zeros((B,), jnp.float32),
        jax.random.PRNGKey(0), jcfg, 6, greedy=True)
    tt, tlast, tc = tl.decode_segment(
        tp, tc, torch.tensor(step), torch.zeros((B,)), None, tcfg, 6,
        greedy=True)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jlast), tlast.numpy())
    same_cache()


@pytest.mark.parametrize("pos,S", [([0, 5], 1), ([30, 31], 3), ([2, 29], 4)])
def test_row_update_matches_jax(pos, S):
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    rng = np.random.RandomState(S)
    layer = rng.randn(B, 32, 2, 8).astype(np.float32)
    new = rng.randn(B, S, 2, 8).astype(np.float32)
    want = jl._row_update(jnp.asarray(layer), jnp.asarray(new),
                          jnp.asarray(pos, jnp.int32))
    got = tl._row_update(torch.tensor(layer), torch.tensor(new),
                         torch.tensor(pos, dtype=torch.int32))
    assert np.array_equal(np.asarray(want), got.numpy())


# ---- drafts, trees, acceptance ---------------------------------------------------

def _contexts(seed, n=12):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = rng.randint(0, 6, size=rng.randint(1, 30)).tolist()
        out.append(base + base[: rng.randint(0, len(base) + 1)])
    return out + [[], [4], [4, 4]]


@pytest.mark.parametrize("k", [1, 4])
def test_simple_drafts_match_reference(k):
    from kubedl_tpu.serving import speculative as jsp

    for ctx in _contexts(k):
        for name in ("ngram", "repeat"):
            assert tsp.make_draft(name).propose(ctx, k) == \
                jsp.make_draft(name).propose(ctx, k), (name, ctx)
        nd = dict(max_ngram=2, window=8)
        assert tsp.NgramDraft(**nd).propose(ctx, k) == \
            jsp.NgramDraft(**nd).propose(ctx, k)
    script = [[1, 2, 3], [9], []]
    js, ts = jsp.ScriptedDraft(script), tsp.ScriptedDraft(script)
    for ctx in ([5, 6], [7], [8, 8], [1]):
        assert ts.propose(ctx, k) == js.propose(ctx, k)
    with pytest.raises(ValueError):
        tsp.make_draft("model")
    with pytest.raises(ValueError):
        tsp.make_draft("oracle")


def test_trees_and_accept_length_match_reference():
    from kubedl_tpu.serving import speculative as jsp

    rng = np.random.RandomState(7)
    for _ in range(40):
        k = int(rng.randint(1, 5))
        n = int(rng.randint(1, 4))
        m = 1 + n * k
        chains = [rng.randint(0, 4, size=rng.randint(0, k + 1)).tolist()
                  for _ in range(n)]
        root = int(rng.randint(0, 4))
        jt = jsp.build_tree(root, chains, k, m)
        tt = tsp.build_tree(root, chains, k, m)
        for a, b in zip(jt.arrays(m), tt.arrays(m)):
            assert np.array_equal(a, b)
        ids = rng.randint(0, 4, size=m).tolist()
        assert tt.walk(ids) == jt.walk(ids)
        assert tt.size == jt.size
        d = rng.randint(0, 3, size=k).tolist()
        g = rng.randint(0, 3, size=k).tolist()
        assert tsp.accept_length(d, g) == jsp.accept_length(d, g)
    with pytest.raises(ValueError):
        tsp.DraftTree(0).arrays(0)


def test_spec_stats_snapshot_matches_reference():
    from kubedl_tpu.serving import speculative as jsp

    js, ts = jsp.SpecStats(), tsp.SpecStats()
    rng = np.random.RandomState(8)
    for _ in range(25):
        a = int(rng.randint(0, 5))
        for st in (js, ts):
            st.record(4, a, a + 1)
            st.record_candidates(3, bool(a % 2))
            st.record_draft_ms(float(a))
    assert ts.snapshot() == js.snapshot()
    assert ts.acceptance_rate() == js.acceptance_rate()


def test_model_draft_from_target_proposals_match_reference(tiny):
    from kubedl_tpu.serving import speculative as jsp

    jl, jcfg, jp, tcfg, tp = tiny
    jd = jsp.ModelDraft.from_target(jp, jcfg, n_layers=1, max_context=64)
    td = tsp.ModelDraft.from_target(tp, tcfg, n_layers=1, max_context=64)
    assert td.cfg.n_layers == 1
    assert td.params["layers"]["wq"].data_ptr() == \
        tp["layers"]["wq"].data_ptr()  # a view of the target's weights
    ctxs = [c for c in _contexts(9, n=5) if c]
    for k in (1, 4):
        assert td.propose_batch(ctxs, k) == jd.propose_batch(ctxs, k)
    assert td.propose(ctxs[0], 3) == jd.propose(ctxs[0], 3)
    assert td.propose_candidates(ctxs[1], 3, 3) == \
        jd.propose_candidates(ctxs[1], 3, 3)
    assert td.propose_batch([], 3) == []
    # the zoo knows no "llama-125m" (the reference's message); a zoo
    # draft distils (its own weights: distilling the early-exit draft
    # would move the target's, which it views)
    with pytest.raises(ValueError, match="unknown zoo draft 'llama-125m'"):
        tsp.ModelDraft.from_zoo("llama-125m", tcfg, device="cpu")
    zd = tsp.ModelDraft.from_zoo("tiny", tcfg, device="cpu")
    losses = tsp.distill_draft(zd, tp, tcfg, [[1, 2], [3, 4, 5]], gen_len=3,
                               steps=2)
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_model_draft_checkpoints_cross_packages(tiny, tmp_path):
    """The flat-npz format keeps the reference's leaf order: each package
    restores what the other saved."""
    from kubedl_tpu.serving import speculative as jsp

    jl, jcfg, jp, tcfg, tp = tiny
    jd = jsp.ModelDraft.from_target(jp, jcfg, n_layers=2, max_context=64)
    td = tsp.ModelDraft.from_target(tp, tcfg, n_layers=2, max_context=64)
    td.params["final_norm"] = td.params["final_norm"] * 3.0
    td.save(str(tmp_path / "t.npz"))
    jd.load(str(tmp_path / "t.npz"))
    assert np.array_equal(np.asarray(jd.params["final_norm"]),
                          td.params["final_norm"].numpy())
    assert np.array_equal(np.asarray(jd.params["layers"]["w_up"]),
                          td.params["layers"]["w_up"].numpy())
    jd.save(str(tmp_path / "j.npz"))
    td2 = tsp.ModelDraft.from_target(tp, tcfg, n_layers=2, max_context=64)
    td2.load(str(tmp_path / "j.npz"))
    assert torch.equal(td2.params["final_norm"], td.params["final_norm"])
    bad = tsp.ModelDraft.from_target(tp, tcfg, n_layers=1, max_context=64)
    with pytest.raises(ValueError, match="shape"):
        bad.load(str(tmp_path / "j.npz"))


# ---- the engine ---------------------------------------------------------------

#: prompts with repetition, so the n-gram draft gets accepted tokens
PROMPTS = [[5, 9, 13, 5, 9, 13, 5, 9], [7, 3, 3, 11, 2], [1],
           [2, 4, 6, 8, 2, 4, 6, 8, 2, 4], list(range(3, 23))]
MAX_TOKENS = 12
ENGINE_KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
                 kv_block_size=4, kv_attention="blocked")


@pytest.fixture(scope="module")
def chains(tiny):
    """Greedy chains of the JAX model functions for every prompt."""
    import jax
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jp, c, t, jcfg, kv_attention="blocked"))

    def chain(prompt, n):
        c = jl.init_paged_cache(jcfg, 1, 64, 1 + MBK, 4)
        c["bt"] = jnp.arange(1, 1 + MBK, dtype=jnp.int32)[None]
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

    return tp, {tuple(p): chain(p, 40) for p in PROMPTS}


def _run(params, prompts, max_tokens, concurrent=False, **kw):
    eng = srv.LlamaEngine(**{**ENGINE_KW, **kw}, params=params)
    try:
        if concurrent:
            outs = [None] * len(prompts)

            def one(j):
                outs[j] = eng.generate(prompts[j], max_tokens=max_tokens)

            ths = [threading.Thread(target=one, args=(j,))
                   for j in range(len(prompts))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=300)
        else:
            outs = [eng.generate(p, max_tokens=max_tokens) for p in prompts]
        st = eng.stats()
    finally:
        eng.close()
    return [o["token_ids"] for o in outs], st


@pytest.mark.parametrize("kw", [
    dict(spec_k=4),
    dict(spec_k=3, spec_draft="repeat"),
    dict(spec_k=3, spec_draft="model", spec_draft_layers=1),
    dict(spec_k=3, spec_candidates=3),
    dict(spec_k=3, spec_candidates=3, spec_tree=True),
    dict(spec_k=3, spec_draft="model", spec_candidates=2, spec_tree=True),
    dict(spec_k=2, kv_attention="gather"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_spec_engine_streams_match_jax_chain(chains, kw):
    params, want = chains
    got, st = _run(params, PROMPTS, MAX_TOKENS, **kw)
    assert got == [want[tuple(p)][:MAX_TOKENS] for p in PROMPTS]
    sp = st["speculative"]
    # every token after the prefill's first came out of a verify round
    assert sp["verifies"] > 0
    assert sp["emitted"] == sum(len(g) - 1 for g in got)
    assert sp["draft_kind"] == kw.get("spec_draft", "ngram")
    if kw.get("spec_candidates", 1) > 1:
        assert sp["candidates_scored"] > 0
    # a round verifies every greedy decoding row at once
    assert 0 < st["pipeline"]["spec_rounds"] <= sp["verifies"]
    # rejected suffixes were trimmed and every row freed its blocks
    assert st["prefix_cache"]["inserts"] == 0
    assert st["kv_blocks"]["used"] == 0


def test_spec_accepts_drafts_on_repetitive_output(chains):
    """The n-gram draft must be accepted somewhere on these prompts (the
    tiny model's greedy output repeats), so verify emits more than one
    token per round on average — and the streams stay the chain's."""
    params, want = chains
    got, st = _run(params, PROMPTS, 30, spec_k=4)
    assert got == [want[tuple(p)][:30] for p in PROMPTS]
    sp = st["speculative"]
    assert sp["accepted"] > 0 and sp["tokens_per_verify"] > 1.0
    assert sp["emitted"] == sum(len(g) - 1 for g in got)


def test_spec_with_chunked_prefill_and_prefix_cache(chains):
    """Chunked admission, speculation and the prefix cache together:
    repeated prompts graft their cached prefix and prefill the rest in
    chunks, verify runs on every greedy row, streams stay the chain's."""
    params, want = chains
    prompts = [PROMPTS[4], PROMPTS[4] + [1, 2], PROMPTS[4], PROMPTS[3],
               PROMPTS[4] + [1, 2]]
    for p in prompts:
        want.setdefault(tuple(p), None)
    got, st = _run(params, prompts, MAX_TOKENS, spec_k=3,
                   prefill_chunk_tokens=8, prefix_cache_mb=1.0,
                   kv_blocks=40)
    assert got[0] == got[2] == want[tuple(PROMPTS[4])][:MAX_TOKENS]
    assert got[3] == want[tuple(PROMPTS[3])][:MAX_TOKENS]
    assert got[1] == got[4]
    assert st["prefix_cache"]["hits"] >= 1
    assert st["prefix_cache"]["tokens_saved"] > 0
    assert st["pipeline"]["prefill_chunks"] > len(prompts)
    assert st["speculative"]["verifies"] > 0


def test_preemption_mid_speculation_keeps_streams(chains):
    """Four long greedy requests through two rows of a pool that holds
    little more than one max_seq row, speculating: verify's S appends run
    the pool dry, the youngest row is preempted and requeued, rejected
    suffixes are trimmed — and the streams stay the chain's."""
    params, want = chains
    prompts = PROMPTS[1:]
    got, st = _run(params, prompts, 40, concurrent=True, spec_k=4,
                   prefill_chunk_tokens=8, kv_blocks=18, prefix_cache_mb=0.0)
    assert got == [want[tuple(p)][:40] for p in prompts]
    assert st["kv_preemptions"] >= 1
    assert st["kv_blocks"]["used"] == 0
    assert st["speculative"]["verifies"] > 0


def test_sampled_rows_take_the_segment_path(chains):
    """Speculation serves greedy rows only: a sampled request decodes by
    segments (and still returns its budget of tokens)."""
    params, _ = chains
    eng = srv.LlamaEngine(**ENGINE_KW, params=params, spec_k=3)
    try:
        out = eng.generate(PROMPTS[0], max_tokens=8, temperature=0.9)
        st = eng.stats()
    finally:
        eng.close()
    assert len(out["token_ids"]) == 8
    assert st["speculative"]["verifies"] == 0
    assert st["pipeline"]["segments"] > 0


def test_contiguous_layout_still_raises():
    """Speculation needs the paged layout: the reference's message."""
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        srv.LlamaEngine(preset="tiny", device="cpu", max_seq=64,
                        kv_layout="contiguous", spec_k=2)


def test_model_draft_engine_default_depth_is_half_the_target(chains):
    params, _ = chains
    eng = srv.LlamaEngine(**ENGINE_KW, params=params, spec_k=2,
                          spec_draft="model")
    try:
        assert eng._draft.cfg.n_layers == tl.preset("tiny").n_layers // 2
    finally:
        eng.close()
