"""The contiguous KV layout in the port (``models/llama.py``'s contiguous
functions and ``LlamaEngine(kv_layout="contiguous")``) against the JAX
package on the CPU.

The layout runs no Pallas kernel in the reference, so its JAX engine
runs here and the port's engine is held against it directly (and against
the port's own paged engine). Parameters are the reference's
``llama_init(PRNGKey(0))`` carried over with ``params_from_numpy``;
inputs are numpy arrays made from seeds. Tolerances, float32:

- the model functions: logits within 1e-4 max abs (a few layers of
  float32 matmuls in two frameworks sit near 1e-6), cache K/V within
  1e-5, positions identical; the prefix copy and extract bit for bit;
- the engines: greedy streams identical, and the prefix cache's grafts
  (each request's ``cached_prefix_len``) identical to the reference's.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
B = 2


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


def _same_cache(tc, jc):
    for f in ("k", "v"):
        assert np.abs(_np(tc[f]) - np.asarray(jc[f])).max() < KV_TOL
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _random_caches(jcfg, T, seed, pos):
    """A JAX and a port batched cache holding the same random K/V."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    shape = (jcfg.n_layers, B, T, jcfg.n_kv_heads, jcfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    p = np.asarray(pos, np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(p)}
    tc = {"k": torch.tensor(k), "v": torch.tensor(v), "pos": torch.tensor(p)}
    return jc, tc


# ---- the model functions ---------------------------------------------------------

@pytest.mark.parametrize("T,steps", [(16, 5), (6, 8)])
def test_init_cache_and_decode_step_match_jax(tiny, T, steps):
    """The single-position cache and its decode step; at T=6 the steps
    run past the cache, where the write and the RoPE table clamp and
    ``pos`` keeps counting, as in the reference."""
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    jc = jl.init_cache(jcfg, B, T)
    tc = tl.init_cache(tcfg, B, T, "cpu")
    for f in ("k", "v", "pos"):
        assert tuple(tc[f].shape) == tuple(jc[f].shape)
        assert tc[f].dtype == {"float32": torch.float32,
                               "int32": torch.int32}[str(jc[f].dtype)]
    rng = np.random.RandomState(T)
    for _ in range(steps):
        tok = rng.randint(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jlog, jc = jl.decode_step(jp, jc, jnp.asarray(tok), jcfg)
        tlog, tc = tl.decode_step(tp, tc, torch.tensor(tok), tcfg)
        assert np.abs(_np(tlog) - np.asarray(jlog)).max() < LOGIT_TOL
        _same_cache(tc, jc)
    assert int(tc["pos"]) == steps


def test_copy_and_extract_prefix_match_jax(tiny):
    import jax.numpy as jnp

    jl, jcfg, _jp, _tcfg, _tp = tiny
    jc, tc = _random_caches(jcfg, 32, 0, [7, 19])
    jk, jv = jl.extract_prefix_from_row(jc, 1, 16)
    tk, tv = tl.extract_prefix_from_row(tc, 1, 16)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    # a copy, not a view: later writes into the row leave the entry alone
    tc["k"][:, 1] = 0.0
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    jc = jl.copy_prefix_into_row(jc, jk, jv, 0, 11)
    tc = tl.copy_prefix_into_row(tc, tk, tv, 0, 11)
    assert np.array_equal(tc["k"][:, 0].numpy(), np.asarray(jc["k"][:, 0]))
    assert np.array_equal(tc["v"].numpy(), np.asarray(jc["v"]))
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].tolist() == [11, 19]
    assert jnp.array_equal(jc["pos"], jnp.asarray([11, 19], jnp.int32))


@pytest.mark.parametrize("starts,lens,S", [
    ([0, 0], [5, 8], 8),  # whole prompts: prefill_batched's case
    ([7, 0], [4, 0], 8),  # a grafted prefix; row 1 untouched (mid-decode)
    ([12, 3], [6, 8], 8),  # both rows ride a prefix
    ([28, 20], [3, 5], 8),  # start + S past T = 32: the write clamps
])
def test_prefill_batched_from_matches_jax(tiny, starts, lens, S):
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = tiny
    T = 32
    jc, tc = _random_caches(jcfg, T, sum(starts), starts)
    rng = np.random.RandomState(S + sum(lens))
    toks = rng.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    args = (np.asarray(lens, np.int32), np.asarray(starts, np.int32))
    jlog, jc = jl.prefill_batched_from(
        jp, jc, jnp.asarray(toks), *map(jnp.asarray, args), jcfg)
    tlog, tc = tl.prefill_batched_from(
        tp, tc, torch.tensor(toks), *map(torch.tensor, args), tcfg)
    active = np.asarray(lens) > 0
    err = np.abs(_np(tlog) - np.asarray(jlog)).max(axis=-1)
    assert (err[active] < LOGIT_TOL).all()
    _same_cache(tc, jc)


def test_prefill_from_at_zero_is_whole_prompt_prefill(tiny):
    """``starts == 0`` gives prefill_batched's logits and cache."""
    _jl, jcfg, _jp, tcfg, tp = tiny
    rng = np.random.RandomState(3)
    toks = torch.tensor(rng.randint(0, 256, size=(B, 8)).astype(np.int32))
    lens = torch.tensor([6, 8], dtype=torch.int32)
    a = tl.init_batched_cache(tcfg, B, 32, "cpu")
    b = tl.init_batched_cache(tcfg, B, 32, "cpu")
    la, a = tl.prefill_batched(tp, a, toks, lens, tcfg)
    lb, b = tl.prefill_batched_from(tp, b, toks, lens,
                                    torch.zeros(B, dtype=torch.int32), tcfg)
    assert np.abs(_np(la) - _np(lb)).max() < KV_TOL
    for f in ("k", "v"):
        assert np.abs(_np(a[f]) - _np(b[f])).max() < KV_TOL
    assert torch.equal(a["pos"], b["pos"])


# ---- the engine ---------------------------------------------------------------

def _requests(seed=0):
    """Seven greedy requests, five sharing a 40-token system prompt."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, 256, size=40).tolist()
    reqs = [system + rng.randint(0, 256, size=int(n)).tolist()
            for n in rng.randint(3, 30, size=5)]
    reqs += [rng.randint(0, 256, size=int(n)).tolist() for n in (9, 50)]
    return reqs


def _waves(eng, reqs, waves, max_tokens):
    """Each wave's requests concurrently, the waves one after another."""
    outs = [None] * len(reqs)

    def one(j):
        outs[j] = eng.generate(reqs[j], max_tokens=max_tokens)

    for wave in waves:
        ths = [threading.Thread(target=one, args=(j,)) for j in wave]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
    return outs


CASES = {
    # prefix-cache hits: two requests walk the system prompt, then the
    # rest graft it; 3 rows for 7 requests (more requests than rows)
    "prefix": dict(kw=dict(prefix_cache_mb=64.0),
                   waves=[[0, 1], [2, 3, 4, 5, 6]]),
    # chunking asked for: a contiguous engine prefills whole prompts
    # (the reference's rule), so the streams are the same
    "chunked": dict(kw=dict(prefix_cache_mb=64.0, prefill_chunk_tokens=16),
                    waves=[[0, 1], [2, 3, 4, 5, 6]]),
    "no_prefix": dict(kw=dict(prefix_cache_mb=0.0),
                      waves=[[0, 1, 2, 3, 4, 5, 6]]),
}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's contiguous LlamaEngine on every case (its params
    are ``llama_init(PRNGKey(0))``): streams and graft lengths."""
    from kubedl_tpu.serving import server as jsrv

    reqs = _requests()
    out = {}
    params = None
    for name, case in CASES.items():
        eng = jsrv.LlamaEngine(preset="tiny", max_batch=3, max_seq=128,
                               kv_layout="contiguous", **case["kw"])
        try:
            outs = _waves(eng, reqs, case["waves"], 12)
            params = eng.params
        finally:
            eng.close()
        out[name] = ([o["token_ids"] for o in outs],
                     [o["cached_prefix_len"] for o in outs])
    return reqs, params, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_contiguous_engine_matches_reference_engine(reference_runs, case):
    import jax

    reqs, jparams, want = reference_runs
    cfg = tl.preset("tiny")
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")
    kw = dict(preset="tiny", device="cpu", max_batch=3, max_seq=128,
              params=params, **CASES[case]["kw"])
    streams = {}
    for layout in ("contiguous", "paged"):
        eng = srv.LlamaEngine(kv_layout=layout, **kw)
        try:
            outs = _waves(eng, reqs, CASES[case]["waves"], 12)
            st = eng.stats()
        finally:
            eng.close()
        streams[layout] = [o["token_ids"] for o in outs]
        if layout == "contiguous":
            assert [o["cached_prefix_len"] for o in outs] == want[case][1]
            assert "kv_blocks" not in st
            assert st["nonfinite_logits"] == 0
            assert st["pipeline"]["prefill_chunks"] == 0
            assert eng.kv_attention == "gather"
            if case != "no_prefix":
                assert st["prefix_cache"]["hits"] > 0
                assert st["prefix_cache"]["tokens_saved"] > 0
    assert streams["contiguous"] == want[case][0]
    assert streams["paged"] == want[case][0]


def test_contiguous_graft_that_would_spill_prefills_whole(tiny):
    """A graft whose start + bucket passes max_seq is dropped and the row
    prefilled whole (the reference's overflow fixup): the stream is the
    no-cache engine's."""
    tp = tiny[4]
    rng = np.random.RandomState(5)
    system = rng.randint(0, 256, size=40).tolist()
    # 40 + a 30-token suffix: bucket 32 from start 40 passes max_seq 64
    reqs = [system + [1, 2], system + [3, 4],
            system + rng.randint(0, 256, size=20).tolist()]
    kw = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
              params=tp, kv_layout="contiguous")
    got = {}
    for mb in (64.0, 0.0):
        eng = srv.LlamaEngine(prefix_cache_mb=mb, **kw)
        try:
            outs = _waves(eng, reqs, [[0, 1], [2]], 2)
            st = eng.stats()
        finally:
            eng.close()
        got[mb] = outs
        if mb:
            assert st["prefix_cache"]["hits"] == 1  # matched, then dropped
            assert st["prefix_cache"]["tokens_saved"] == 0
    assert [o["token_ids"] for o in got[64.0]] == \
        [o["token_ids"] for o in got[0.0]]
    assert got[64.0][2]["cached_prefix_len"] == 0


@pytest.mark.parametrize("call", ["spec", "load_version", "prefill_handoff",
                                  "adopt_handoff"])
def test_paged_only_features_raise_the_reference_messages(call, tmp_path):
    msg = {"spec": "speculative decoding requires kv_layout='paged'",
           "load_version": "weight hot-swap requires kv_layout='paged'",
           "prefill_handoff": "disaggregated prefill requires "
                              "kv_layout='paged'",
           "adopt_handoff": "adopting a KV handoff requires "
                            "kv_layout='paged'"}[call]
    kw = dict(preset="tiny", device="cpu", max_seq=64,
              kv_layout="contiguous")
    if call == "spec":
        with pytest.raises(ValueError, match=msg):
            srv.LlamaEngine(spec_k=2, **kw)
        return
    eng = srv.LlamaEngine(**kw)
    try:
        with pytest.raises(ValueError, match=msg):
            if call == "load_version":
                eng.load_version("v2", str(tmp_path))
            elif call == "prefill_handoff":
                eng.prefill_handoff([1, 2, 3], max_tokens=4)
            else:
                eng.adopt_handoff(None)
    finally:
        eng.close()


def test_contiguous_engine_recovers_from_a_failed_tick(tiny, monkeypatch):
    """A decode segment that raises fails the rows in flight; the engine
    rebuilds a contiguous cache and serves the next request as a fresh
    engine would."""
    tp = tiny[4]
    eng = srv.LlamaEngine(preset="tiny", device="cpu", max_seq=64,
                          params=tp, kv_layout="contiguous")
    real = tl.decode_segment
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device fault")
        return real(*a, **kw)

    monkeypatch.setattr(tl, "decode_segment", flaky)
    try:
        bad = eng.generate([5, 6, 7], max_tokens=6)
        good = eng.generate([5, 6, 7], max_tokens=6)
        st = eng.stats()
        cache = eng._cache
    finally:
        eng.close()
    assert "injected device fault" in bad["error"]
    fresh = srv.LlamaEngine(preset="tiny", device="cpu", max_seq=64,
                            params=tp, kv_layout="contiguous")
    try:
        want = fresh.generate([5, 6, 7], max_tokens=6)
    finally:
        fresh.close()
    assert good["token_ids"] == want["token_ids"]
    assert st["pipeline"]["errors"] == 1
    assert set(cache) == {"k", "v", "pos"}
