"""The port's prefix cache (kubedl_tpu_torch.serving.prefix_cache, the
block ops of kubedl_tpu_torch.models.llama and the engine's share /
copy-on-write / graft admission) against the JAX reference on the CPU.

- The copied ``PrefixCache`` and ``prefix_digest``: the same operations
  on seeded prompts give identical results and stats, and the copy
  differs from the reference's source in docstrings only.
- ``copy_kv_block`` and ``paged_graft_prefix``: pools bit-identical to
  the JAX functions' (a copy and a scatter: no arithmetic, so no
  tolerance).
- The engine: greedy streams with grafted prefixes (with and without a
  partial tail block, under eviction, with chunked prefill) identical to
  a chain built from the JAX model functions (``paged_prefill_batched`` +
  ``paged_decode_step_batched``, lax kernel), never to the JAX engine.
"""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.serving import prefix_cache as tpc  # noqa: E402
from kubedl_tpu_torch.serving import router_policy as trp  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ---- the copied host modules --------------------------------------------------

def _strip_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(getattr(body[0], "value", None), ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_prefix_cache_is_a_docstring_only_copy():
    ref = ROOT / "kubedl_tpu" / "serving" / "prefix_cache.py"
    port = ROOT / "kubedl_tpu_torch" / "serving" / "prefix_cache.py"
    assert _strip_docstrings(ast.parse(ref.read_text())) == \
        _strip_docstrings(ast.parse(port.read_text()))


def _ops(seed, n=300):
    """A seeded stream of prefix-cache operations over shared prompts."""
    rng = np.random.RandomState(seed)
    systems = [rng.randint(0, 50, size=rng.randint(4, 30)).tolist()
               for _ in range(4)]
    ops = []
    for _ in range(n):
        p = systems[rng.randint(4)] + rng.randint(
            0, 50, size=rng.randint(0, 6)).tolist()
        ops.append((int(rng.randint(6)), p, bool(rng.randint(2)),
                    int(rng.randint(1, 9))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_matches_reference(seed):
    from kubedl_tpu.serving import prefix_cache as jpc

    evicted = {"j": [], "t": []}
    caches = {
        "j": jpc.PrefixCache(400, min_len=3, on_evict=lambda e: evicted[
            "j"].append(e.tokens)),
        "t": tpc.PrefixCache(400, min_len=3, on_evict=lambda e: evicted[
            "t"].append(e.tokens)),
    }
    pins = {"j": [], "t": []}
    log = {"j": [], "t": []}
    for op, p, tag, nblk in _ops(seed):
        for name, c in caches.items():
            if op == 0:
                c.observe(p)
                log[name].append(("obs",))
            elif op == 1:
                e, n = c.match(p)
                log[name].append(("match", n, None if e is None
                                  else e.tokens))
                if e is not None:
                    pins[name].append(e)
            elif op == 2:
                cand = c.insert_candidate(p, tag)
                ok = c.insert(p[:cand], None, None, cand,
                              blocks=tuple(range(1, nblk + 1)),
                              nbytes=nblk * 32) if cand else False
                log[name].append(("insert", cand, ok))
            elif op == 3 and pins[name]:
                c.unpin(pins[name].pop(0))
            elif op == 4:
                log[name].append(("reclaim", c.reclaim(nblk * 32)))
            else:
                c.add_tokens_saved(nblk)
                log[name].append(("keys", c.prefix_keys(limit=8), len(c)))
    assert log["t"] == log["j"]
    assert evicted["t"] == evicted["j"]
    assert caches["t"].stats() == caches["j"].stats()
    caches["t"].clear()
    assert len(caches["t"]) == 0 and caches["t"].stats()["bytes"] == 0


def test_prefix_digest_matches_reference():
    from kubedl_tpu.serving import router_policy as jrp

    rng = np.random.RandomState(3)
    for _ in range(50):
        p = rng.randint(0, 128256, size=rng.randint(0, 20)).tolist()
        for plen in (0, 1, 8, 16):
            assert trp.prefix_digest(p, plen) == jrp.prefix_digest(p, plen)
        data = str(p[:3]).encode()
        assert trp._stable_hash(data) == jrp._stable_hash(data)


# ---- the block ops -----------------------------------------------------------

L, NB, BS, KV, HD, B, MB = 2, 12, 4, 2, 8, 2, 5


def _pools(seed):
    rng = np.random.RandomState(seed)
    k = rng.randn(L, NB, BS, KV, HD).astype(np.float32)
    v = rng.randn(L, NB, BS, KV, HD).astype(np.float32)
    bt = np.array([[3, 7, 1, 0, 0], [2, 4, 9, 11, 5]], np.int32)
    pos = np.array([6, 13], np.int32)
    return k, v, bt, pos


def _both(k, v, bt, pos):
    import jax.numpy as jnp

    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos),
          "bt": jnp.asarray(bt)}
    tc = {"k": torch.tensor(k), "v": torch.tensor(v),
          "pos": torch.tensor(pos), "bt": torch.tensor(bt)}
    return jc, tc


def _bit_identical(jc, tc):
    for f in ("k", "v", "pos", "bt"):
        a, b = np.asarray(jc[f]), tc[f].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("src,dst", [(3, 10), (7, 7), (1, 6), (11, 0)])
def test_copy_kv_block_bit_identical(src, dst):
    from kubedl_tpu.models import llama as jl

    jc, tc = _both(*_pools(src + dst))
    jc = jl.copy_kv_block(jc, src, dst)
    out = tl.copy_kv_block(tc, src, dst)
    assert out is tc and out["k"].data_ptr() == tc["k"].data_ptr()  # in place
    _bit_identical(jc, tc)


@pytest.mark.parametrize("row,P,length", [(0, 12, 9), (1, 20, 20),
                                          (1, 8, 5), (0, 4, 4)])
def test_paged_graft_prefix_bit_identical(row, P, length):
    """Positions [0, P) scatter through row's table; positions whose
    table entry is the trash block 0 vanish there (row 0 owns 3 blocks,
    so P=12 fills them and P > 12 would spill into trash)."""
    from kubedl_tpu.models import llama as jl

    rng = np.random.RandomState(P + row)
    ek = rng.randn(L, P, KV, HD).astype(np.float32)
    ev = rng.randn(L, P, KV, HD).astype(np.float32)
    jc, tc = _both(*_pools(row))
    jc = jl.paged_graft_prefix(jc, ek, ev, row, length)
    tl.paged_graft_prefix(tc, torch.tensor(ek), torch.tensor(ev), row, length)
    _bit_identical(jc, tc)


# ---- the engine ------------------------------------------------------------------

SYS18 = [(7 * j + 3) % 200 for j in range(18)]  # 4 full blocks + 2 tokens
SYS20 = [(11 * j + 5) % 200 for j in range(20)]  # 5 full blocks
MAX_TOKENS = 10
ENGINE_KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
                 kv_block_size=4, kv_attention="blocked")


@pytest.fixture(scope="module")
def chain_fn():
    """(params, chain(prompt, n)): greedy chains of the JAX model
    functions, memoized."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    cfg = jl.preset("tiny")
    jp = jl.llama_init(jax.random.PRNGKey(0), cfg)
    mb = 64 // 4
    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jp, c, t, cfg, kv_attention="blocked"))
    memo = {}

    def chain(prompt, n):
        key = (tuple(prompt), n)
        if key in memo:
            return memo[key]
        c = jl.init_paged_cache(cfg, 1, 64, 1 + mb, 4)
        c["bt"] = jnp.arange(1, 1 + mb, dtype=jnp.int32)[None]
        toks = np.zeros((1, 64), np.int32)
        toks[0, :len(prompt)] = prompt
        lg, c = jl.paged_prefill_batched(
            jp, c, jnp.asarray(toks), jnp.asarray([len(prompt)], jnp.int32),
            cfg)
        out = [int(jnp.argmax(lg[0]))]
        while len(out) < n:
            lg, c = step(c, jnp.asarray([[out[-1]]], jnp.int32))
            out.append(int(jnp.argmax(lg[0])))
        memo[key] = out
        return out

    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  tl.preset("tiny"), "cpu")
    return params, chain


def _engine(params, **kw):
    return srv.LlamaEngine(**{**ENGINE_KW, **kw}, params=params)


@pytest.mark.parametrize("system,chunk", [(SYS18, 0), (SYS20, 0),
                                          (SYS18, 8), (SYS20, 8)],
                         ids=["tail-whole", "full-whole", "tail-chunked",
                              "full-chunked"])
def test_grafted_prefix_streams_match_jax_chain(chain_fn, system, chunk):
    """A tagged request stores its prompt (less one token) as an entry;
    the next requests graft it — sharing its full blocks, copying its
    partial tail block on write — and prefill only their suffix at
    ``starts = cached_len``. Streams stay the chain's."""
    params, chain = chain_fn
    warm = system + [1]
    users = [system + [9, 8, 7], system + [42], system + [3, 5, 5, 5, 2]]
    eng = _engine(params, prefill_chunk_tokens=chunk)
    try:
        first = eng.generate(warm, max_tokens=MAX_TOKENS, cache_prefix=True)
        outs = [eng.generate(p, max_tokens=MAX_TOKENS) for p in users]
        st = eng.stats()
        entry_blocks = eng._pcache.stats()["entries"]
    finally:
        eng.close()
    assert first["token_ids"] == chain(warm, MAX_TOKENS)
    assert first["cached_prefix_len"] == 0
    for p, o in zip(users, outs):
        assert o["token_ids"] == chain(p, MAX_TOKENS)
        assert o["cached_prefix_len"] == len(system)
    pc = st["prefix_cache"]
    assert pc["inserts"] == 1 and pc["hits"] == len(users)
    assert pc["tokens_saved"] == len(system) * len(users)
    assert entry_blocks == 1 and pc["pinned"] == 0
    # only the entry's blocks stay allocated: the full ones and, with a
    # partial tail, its frozen copy
    assert st["kv_blocks"]["used"] == -(-len(system) // 4)
    assert len(pc["advertised"]) == 1


def test_observed_prefix_is_inserted_and_hit(chain_fn):
    """Without tagging: two requests walking the same 20 tokens make it
    shared traffic; the prefix is stored at their prefill harvest and a
    third request grafts it."""
    params, chain = chain_fn
    users = [SYS20 + [3, 1], SYS20 + [4, 4, 4], SYS20 + [2]]
    eng = _engine(params)
    try:
        outs = [eng.generate(p, max_tokens=MAX_TOKENS) for p in users]
        st = eng.stats()
    finally:
        eng.close()
    assert [o["token_ids"] for o in outs] == \
        [chain(p, MAX_TOKENS) for p in users]
    assert [o["cached_prefix_len"] for o in outs] == [0, 0, 20]
    assert st["prefix_cache"]["hits"] == 1


def test_prefix_entries_evicted_under_pool_pressure(chain_fn):
    """A pool that cannot hold a cached prefix beside two long rows: the
    reserve evicts the unpinned entry before it preempts anyone, its
    blocks go back to the allocator, and streams stay the chain's."""
    params, chain = chain_fn
    warm = SYS18 + [1]
    long_rows = [[7, 3, 3, 11, 2], [2, 4, 6, 8, 10, 12, 14]]
    eng = _engine(params, kv_blocks=26, prefill_chunk_tokens=8)
    try:
        eng.generate(warm, max_tokens=2, cache_prefix=True)
        held = eng.stats()["kv_blocks"]["used"]
        outs = [None, None]

        def one(j):
            outs[j] = eng.generate(long_rows[j], max_tokens=40)

        ths = [threading.Thread(target=one, args=(j,)) for j in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        st = eng.stats()
    finally:
        eng.close()
    assert held == 5  # the entry: 4 shared blocks + the tail's copy
    assert [o["token_ids"] for o in outs] == \
        [chain(p, 40) for p in long_rows]
    assert st["prefix_cache"]["evictions"] >= 1
    assert st["prefix_cache"]["entries"] == 0
    assert st["kv_blocks"]["used"] == 0


def test_concurrent_shared_prefix_traffic(chain_fn):
    """Four rows of shared-prefix traffic, two at a time, chunked: hits
    pin the entry while their suffix prefills, and the pins all come
    back."""
    params, chain = chain_fn
    users = [SYS18 + [j, j + 1] for j in range(4)]
    eng = _engine(params, prefill_chunk_tokens=8)
    try:
        eng.generate(SYS18 + [1], max_tokens=2, cache_prefix=True)
        outs = [None] * 4

        def one(j):
            outs[j] = eng.generate(users[j], max_tokens=MAX_TOKENS)

        ths = [threading.Thread(target=one, args=(j,)) for j in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        st = eng.stats()
    finally:
        eng.close()
    assert [o["token_ids"] for o in outs] == \
        [chain(p, MAX_TOKENS) for p in users]
    assert st["prefix_cache"]["hits"] == 4
    assert st["prefix_cache"]["pinned"] == 0


def test_prefix_cache_sizes_the_pool_like_the_reference(chain_fn):
    params, _ = chain_fn
    cfg = tl.preset("tiny")
    block_bytes = 2 * cfg.n_layers * 4 * cfg.n_kv_heads * cfg.head_dim * 4
    for mb_, extra in ((0.0, 0), (0.001, -(-1000 // block_bytes)),
                       (64.0, 2 * 16)):
        eng = _engine(params, prefix_cache_mb=mb_)
        try:
            assert eng._block_bytes == block_bytes
            assert eng.kv_blocks == 1 + 2 * 16 + extra
            assert ("prefix_cache" in eng.stats()) == (mb_ > 0)
        finally:
            eng.close()
