"""Disaggregated prefill/decode in the port (kubedl_tpu_torch.serving.disagg
and the engine's prefill_handoff / fetch_handoff / adopt_handoff, the
/v1/prefill and /v1/adopt routes) against the reference on the CPU.

- the KVH1 wire: the port's bytes equal the reference's for the same
  fields and payload (bf16 and float32), and each package reads the
  other's;
- ``export_kv_blocks`` / ``import_kv_blocks``: pools equal to the JAX
  functions' (exact: they move values);
- a prefill-role -> decode-role engine pair gives greedy streams
  IDENTICAL to the port's colocated engine and to a chain built from the
  jitted JAX model functions (float32 ``tiny``), in process, over HTTP
  and through the reference router;
- block conservation: each pool's free count returns to where it began
  after success, TTL expiry and a refused adopt;
- the weight version crosses the seam; an unknown one is a 400;
- the QoS queue and the coordinator behave as the reference's copies.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.serving import disagg as tdg  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402
from kubedl_tpu_torch.training import checkpoint as tck  # noqa: E402

PROMPTS = [[5, 9, 13], [7, 3, 3, 11, 2], list(range(3, 23)),
           [1, 2, 3, 4, 5, 6, 7, 8, 9]]
MAX_TOKENS = 10
KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
          kv_block_size=4, kv_blocks=40, prefix_cache_mb=0.0)


@pytest.fixture(scope="module")
def ref():
    """(port params, JAX greedy chains of PROMPTS) from the reference's
    tiny init; the JAX model functions jitted, as its engine runs them."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    cfg = jl.preset("tiny")
    jp = jl.llama_init(jax.random.PRNGKey(0), cfg)
    mb = 64 // 4
    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jp, c, t, cfg, kv_attention="blocked"))
    prefill = jax.jit(lambda c, t, n: jl.paged_prefill_batched(
        jp, c, t, n, cfg))
    chains = []
    for prompt in PROMPTS:
        c = jl.init_paged_cache(cfg, 1, 64, 1 + mb, 4)
        c["bt"] = jnp.arange(1, 1 + mb, dtype=jnp.int32)[None]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        lg, c = prefill(c, jnp.asarray(toks),
                        jnp.asarray([len(prompt)], jnp.int32))
        out = [int(jnp.argmax(lg[0]))]
        while len(out) < MAX_TOKENS:
            lg, c = step(c, jnp.asarray([[out[-1]]], jnp.int32))
            out.append(int(jnp.argmax(lg[0])))
        chains.append(out)
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  tl.preset("tiny"), "cpu")
    return params, chains


def _free(eng):
    return eng.stats()["kv_blocks"]["free"]


# ---- the wire -------------------------------------------------------------------

def _fields():
    return dict(model="tiny", prompt_ids=[1, 2, 3], first_token=7, pos=3,
                block_size=4, max_tokens=5, temperature=0.5,
                request_id="r1", cache_prefix=True, ttft_ms=1.25,
                trace="", model_version="v2")


def test_kvh1_bytes_equal_the_references_f32():
    from kubedl_tpu.serving import disagg as jdg

    rng = np.random.RandomState(0)
    k = rng.randn(2, 3, 4, 2, 16).astype(np.float32)
    v = rng.randn(2, 3, 4, 2, 16).astype(np.float32)
    pb = tdg.KVHandoff(k=k, v=v, **_fields()).to_bytes()
    rb = jdg.KVHandoff(k=k, v=v, **_fields()).to_bytes()
    assert pb == rb
    back = tdg.KVHandoff.from_bytes(rb)
    assert np.array_equal(back.k, k) and np.array_equal(back.v, v)
    assert back.model_version == "v2" and back.dtype_name == "float32"
    back = jdg.KVHandoff.from_bytes(pb)
    assert np.array_equal(back.k, k) and back.first_token == 7


def test_kvh1_bytes_equal_the_references_bf16():
    """bf16 payloads: the port carries their uint16 bits and writes the
    reference's "bfloat16" header; bytes equal, each reads the other's."""
    import ml_dtypes

    from kubedl_tpu.serving import disagg as jdg

    rng = np.random.RandomState(1)
    kb = rng.randn(2, 3, 4, 1, 8).astype(ml_dtypes.bfloat16)
    vb = rng.randn(2, 3, 4, 1, 8).astype(ml_dtypes.bfloat16)
    rb = jdg.KVHandoff(k=kb, v=vb, **_fields()).to_bytes()
    pb = tdg.KVHandoff(k=kb.view(np.uint16), v=vb.view(np.uint16),
                       dtype="bfloat16", **_fields()).to_bytes()
    assert pb == rb
    back = tdg.KVHandoff.from_bytes(rb)
    assert back.k.dtype == np.uint16 and back.dtype_name == "bfloat16"
    assert np.array_equal(back.k, kb.view(np.uint16))
    assert back.nbytes == 2 * kb.nbytes
    back = jdg.KVHandoff.from_bytes(pb)
    assert back.k.dtype == kb.dtype
    assert np.array_equal(back.v.view(np.uint16), vb.view(np.uint16))
    with pytest.raises(ValueError):
        tdg.KVHandoff.from_bytes(b"XXXX" + pb[4:])
    with pytest.raises(ValueError):
        tdg.KVHandoff.from_bytes(pb[:-8])


def test_export_import_match_jax():
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    rng = np.random.RandomState(2)
    shape = (2, 9, 4, 2, 16)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    blocks = [5, 2, 7]
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "pos": jnp.zeros((2,), jnp.int32), "bt": jnp.zeros((2, 4), jnp.int32)}
    tc = {"k": torch.tensor(k), "v": torch.tensor(v),
          "pos": torch.zeros(2, dtype=torch.int32),
          "bt": torch.zeros((2, 4), dtype=torch.int32)}
    jk, jv = jl.export_kv_blocks(jc, blocks)
    tk, tv = tl.export_kv_blocks(tc, blocks)
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
    tk_before = tk.clone()
    tc["k"].zero_()  # a fresh gather: the export survives later writes
    assert torch.equal(tk, tk_before)
    dst = [1, 8, 3]
    zeros = np.zeros(shape, np.float32)
    jz = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros),
          "pos": jc["pos"], "bt": jc["bt"]}
    tz = {"k": torch.zeros(shape), "v": torch.zeros(shape),
          "pos": tc["pos"], "bt": tc["bt"]}
    jz = jl.import_kv_blocks(jz, jk, jv, dst)
    tz = tl.import_kv_blocks(tz, tk, tv, torch.tensor(dst))
    assert np.array_equal(np.asarray(jz["k"]), tz["k"].numpy())
    assert np.array_equal(np.asarray(jz["v"]), tz["v"].numpy())


# ---- the engine pair ------------------------------------------------------------

def test_pair_streams_equal_colocated_and_jax_chain(ref):
    params, chains = ref
    col = srv.LlamaEngine(**KW, params=params)
    pre = srv.LlamaEngine(**KW, params=params, role="prefill")
    dec = srv.LlamaEngine(**KW, params=params, role="decode")
    try:
        free0 = (_free(pre), _free(dec))
        colocated = [col.generate(p, MAX_TOKENS)["token_ids"] for p in PROMPTS]
        co = tdg.DisaggCoordinator(pre, dec)
        pair = [co.generate(p, max_tokens=MAX_TOKENS)["token_ids"]
                for p in PROMPTS]
        # concurrent requests through the pair
        outs = [None] * len(PROMPTS)

        def one(j):
            outs[j] = co.generate(PROMPTS[j], max_tokens=MAX_TOKENS)

        ths = [threading.Thread(target=one, args=(j,))
               for j in range(len(PROMPTS))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        st_p, st_d = pre.stats(), dec.stats()
        assert (_free(pre), _free(dec)) == free0
    finally:
        for e in (col, pre, dec):
            e.close()
    assert pair == colocated == chains
    assert [o["token_ids"] for o in outs] == chains
    assert st_p["role"] == "prefill" and st_d["role"] == "decode"
    assert st_p["handoffs_out"] == st_d["handoffs_in"] == 2 * len(PROMPTS)
    assert st_p["handoff_failures"] == st_d["handoff_failures"] == 0
    assert st_p["handoffs_parked"] == 0


def test_reference_coordinator_drives_port_engines(ref):
    """The reference's DisaggCoordinator (its own KVH1 class on the wire)
    over two port engines gives the port coordinator's streams."""
    from kubedl_tpu.serving.disagg import DisaggCoordinator

    params, chains = ref
    pre = srv.LlamaEngine(**KW, params=params, role="prefill")
    dec = srv.LlamaEngine(**KW, params=params, role="decode")
    try:
        got = [DisaggCoordinator(pre, dec).generate(
            p, max_tokens=MAX_TOKENS)["token_ids"] for p in PROMPTS[:2]]
    finally:
        pre.close()
        dec.close()
    assert got == chains[:2]


def test_adopt_shares_prefix_cache_blocks(ref):
    """A decode engine whose prefix cache holds the prompt's prefix shares
    those full blocks and imports only the rest; streams unchanged."""
    params, chains = ref
    kw = dict(KW, prefix_cache_mb=64.0)
    pre = srv.LlamaEngine(**kw, params=params)
    dec = srv.LlamaEngine(**kw, params=params)
    prompt = PROMPTS[2]  # 20 tokens: 5 blocks
    try:
        dec.generate(prompt, 2, cache_prefix=True)  # caches 16 tokens
        h = pre.prefill_handoff(prompt, max_tokens=MAX_TOKENS)
        res = dec.adopt_handoff(h)
        st = dec.stats()
    finally:
        pre.close()
        dec.close()
    assert res["token_ids"] == chains[2]
    assert res["cached_prefix_len"] == 16
    assert st["prefix_cache"]["hits"] >= 1


def test_ttl_expiry_frees_blocks(ref):
    params, _ = ref
    pre = srv.LlamaEngine(**KW, params=params, handoff_ttl_s=0.0)
    try:
        free0 = _free(pre)
        with pytest.raises(tdg.HandoffError):
            pre.prefill_handoff(PROMPTS[1], max_tokens=4)
        deadline = time.time() + 10
        while _free(pre) != free0 and time.time() < deadline:
            time.sleep(0.05)
        st = pre.stats()
    finally:
        pre.close()
    assert _free(pre) == free0
    assert st["handoff_failures"] >= 1 and st["handoffs_parked"] == 0


def test_geometry_mismatch_adopt_is_refused(ref):
    params, _ = ref
    gem = srv.LlamaEngine(**dict(KW, preset="tiny-gemma"))
    dec = srv.LlamaEngine(**KW, params=params)
    try:
        h = gem.prefill_handoff(PROMPTS[0], max_tokens=4)
        free0 = _free(dec)
        with pytest.raises(ValueError, match="geometry"):
            dec.adopt_handoff(h)
        h.block_size = 8
        with pytest.raises(ValueError, match="block_size"):
            dec.adopt_handoff(h)
        assert _free(dec) == free0
        assert dec.stats()["handoffs_in"] == 0
    finally:
        gem.close()
        dec.close()


def test_version_crosses_the_seam(ref, tmp_path):
    """The handoff carries the version its prefill ran on; the decode
    engine decodes on that version, or refuses an unknown one."""
    params, chains = ref
    p2 = tl.llama_init(tl.preset("tiny"), torch.Generator().manual_seed(5),
                       "cpu")
    tck.save_checkpoint(str(tmp_path), {"params": p2}, 1)
    single = srv.LlamaEngine(**KW, params=p2)
    pre = srv.LlamaEngine(**KW, params=params, role="prefill")
    dec = srv.LlamaEngine(**KW, params=params, role="decode")
    try:
        want = single.generate(PROMPTS[3], MAX_TOKENS)["token_ids"]
        pre.load_version("v2", str(tmp_path))
        h = pre.prefill_handoff(PROMPTS[3], max_tokens=MAX_TOKENS,
                                model_version="v2")
        assert h.model_version == "v2"
        free0 = _free(dec)
        with pytest.raises(srv.UnknownModelVersion):
            dec.adopt_handoff(h)
        assert _free(dec) == free0
        dec.load_version("v2", str(tmp_path))
        got = dec.adopt_handoff(h)
        base = tdg.DisaggCoordinator(pre, dec).generate(
            PROMPTS[3], max_tokens=MAX_TOKENS)
    finally:
        for e in (single, pre, dec):
            e.close()
    assert got["token_ids"] == want
    assert got["model_version"] == "v2"
    assert base["token_ids"] == chains[3] and base["model_version"] == "base"


# ---- over HTTP ------------------------------------------------------------------

def _serve(engine):
    s = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(engine, "tiny"))
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return s


def _post(port, path, body, ctype="application/json", headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_prefill_then_adopt(ref):
    params, chains = ref
    pre = srv.LlamaEngine(**KW, params=params, role="prefill")
    dec = srv.LlamaEngine(**KW, params=params, role="decode")
    sp, sd = _serve(pre), _serve(dec)
    try:
        code, blob = _post(sp.server_port, "/v1/prefill",
                           {"prompt_ids": PROMPTS[2],
                            "max_tokens": MAX_TOKENS})
        assert code == 200 and blob[:4] == b"KVH1"
        code, body = _post(sd.server_port, "/v1/adopt", blob,
                           "application/octet-stream")
        assert code == 200, body
        assert json.loads(body)["token_ids"] == chains[2]
        # an unknown version is a client error
        code, body = _post(sp.server_port, "/v1/prefill",
                           {"prompt_ids": PROMPTS[0], "max_tokens": 4,
                            "model_version": "nope"})
        assert code == 400 and json.loads(body)["unknown_version"]
        h = tdg.KVHandoff.from_bytes(blob)
        h.model_version = "nope"
        code, body = _post(sd.server_port, "/v1/adopt", h.to_bytes(),
                           "application/octet-stream")
        assert code == 400 and json.loads(body)["unknown_version"]
        # an expired deadline is a 504; a bad body a 400
        code, _ = _post(sp.server_port, "/v1/prefill",
                        {"prompt_ids": PROMPTS[0]},
                        headers={"X-Deadline-Ms": "0"})
        assert code == 504
        code, _ = _post(sd.server_port, "/v1/adopt", b"junk",
                        "application/octet-stream")
        assert code == 400
        # a draining prefill engine sheds with 503 + Retry-After
        pre.drain()
        req = urllib.request.Request(
            f"http://127.0.0.1:{sp.server_port}/v1/prefill",
            data=json.dumps({"prompt_ids": PROMPTS[0]}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 503 and ei.value.headers["Retry-After"]
    finally:
        for s in (sp, sd):
            s.shutdown()
            s.server_close()
        pre.close()
        dec.close()


def test_reference_router_drives_a_port_pair(ref):
    """The unchanged reference router runs its two-leg dispatch against a
    port prefill/decode pair over the same wire."""
    from kubedl_tpu.serving.router import ServingRouter

    params, chains = ref
    pre = srv.LlamaEngine(**KW, params=params, role="prefill")
    dec = srv.LlamaEngine(**KW, params=params, role="decode")
    sp, sd = _serve(pre), _serve(dec)
    try:
        r = ServingRouter(
            [{"name": "pre-0", "host": "127.0.0.1",
              "port": sp.server_port, "role": "prefill"},
             {"name": "dec-0", "host": "127.0.0.1",
              "port": sd.server_port, "role": "decode"}],
            hedge_enabled=False,
        )
        code, payload, _ = r.handle_generate(
            {"prompt_ids": PROMPTS[1], "max_tokens": MAX_TOKENS,
             "temperature": 0.0}, 30_000)
        assert code == 200, payload
        assert payload["token_ids"] == chains[1]
        assert r.metrics.disagg_requests.value() == 1
        assert pre.stats()["handoffs_out"] == dec.stats()["handoffs_in"] == 1
    finally:
        for s in (sp, sd):
            s.shutdown()
            s.server_close()
        pre.close()
        dec.close()


# ---- the QoS queue, as the reference's ---------------------------------------------

def _grant_order(mod):
    """Queue 12 waiters over three classes with capacity 1 held, then
    release one at a time: the smooth weighted round-robin's order."""
    q = mod.WeightedFairQueue(
        classes={"gold": mod.QoSClassSpec(weight=5, priority=0),
                 "silver": mod.QoSClassSpec(weight=2, priority=1),
                 "bronze": mod.QoSClassSpec(weight=1, priority=2)},
        capacity=1, max_queue=64)
    assert q.acquire("gold") == "gold"
    waiters = []
    for j in range(12):
        w = mod._Waiter(("gold", "silver", "bronze")[j % 3])
        q._queues[w.cls].append(w)
        waiters.append(w)
    order = []
    for _ in range(12):
        q.release("gold")
        for j, w in enumerate(waiters):
            if w.admitted and j not in order:
                order.append(j)
    return order, dict(q.admits), q.resolve("acme", {"acme": "silver"}), \
        q.resolve("zzz"), q.default_class


def test_weighted_fair_queue_as_the_references():
    from kubedl_tpu.serving import disagg as jdg

    assert _grant_order(tdg) == _grant_order(jdg)


def test_qos_shed_and_config_as_the_references():
    from kubedl_tpu.serving import disagg as jdg

    cfg = {"classes": {"gold": {"weight": 8, "priority": 0},
                       "bronze": {"weight": 1, "priority": 2}},
           "tenants": {"acme": "gold"}, "capacity": 1, "max_queue": 1}
    outs = []
    for mod in (tdg, jdg):
        q = mod.qos_from_config(cfg)
        assert q.acquire("bronze") == "bronze"
        w = mod._Waiter("bronze")
        q._queues["bronze"].append(w)  # the queue is full
        with pytest.raises(mod.QoSShed):
            q.acquire("bronze", timeout_s=0.01)  # the arrival absorbs it
        got = []
        th = threading.Thread(
            target=lambda: got.append(q.acquire("gold", timeout_s=5)))
        th.start()
        deadline = time.time() + 10  # gold evicts the queued bronze
        while q.queue_depths()["gold"] != 1 and time.time() < deadline:
            time.sleep(0.01)
        q.release("bronze")
        th.join(timeout=5)
        outs.append((w.shed, got, dict(q.sheds), dict(q.admits),
                     q.queue_depths()))
    assert outs[0] == outs[1]
    assert mod.qos_from_config(None) is None and tdg.qos_from_config({}) \
        is None
