"""The port's serving engine and HTTP surface
(kubedl_tpu_torch.serving.server) on the CPU.

The engine serves the reference's ``llama_init(PRNGKey(0))`` tiny
parameters (carried over with ``params_from_numpy``); its greedy token
streams must be IDENTICAL to a chain built from the JAX model functions
(``paged_prefill_batched`` + ``paged_decode_step_batched`` with
``kv_attention="blocked"``, the lax kernel) — with and without chunked
prefill, in both attention modes. The chain is built from the model
functions, not from a JAX engine run.
"""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

#: the reference engine-parity prompts, plus one that spans 3 chunks
PROMPTS = [[5, 9, 13], [7, 3, 3, 11, 2], [1], [2, 4, 6, 8, 10, 12, 14],
           list(range(3, 23))]
MAX_TOKENS = 10
#: chain length the fixture builds (the preemption case decodes longer)
CHAIN_TOKENS = 40
ENGINE_KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
                 kv_block_size=4, kv_blocks=40)


@pytest.fixture(scope="module")
def ref():
    """JAX params + greedy chains from the JAX model functions."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    cfg = jl.preset("tiny")
    jp = jl.llama_init(jax.random.PRNGKey(0), cfg)
    mb = 64 // 4
    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jp, c, t, cfg, kv_attention="blocked"))

    def chain(prompt, n):
        c = jl.init_paged_cache(cfg, 1, 64, 1 + mb, 4)
        c["bt"] = jnp.arange(1, 1 + mb, dtype=jnp.int32)[None]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        lg, c = jl.paged_prefill_batched(
            jp, c, jnp.asarray(toks), jnp.asarray([len(prompt)], jnp.int32),
            cfg,
        )
        out = [int(jnp.argmax(lg[0]))]
        while len(out) < n:
            lg, c = step(c, jnp.asarray([[out[-1]]], jnp.int32))
            out.append(int(jnp.argmax(lg[0])))
        return out

    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  tl.preset("tiny"), "cpu")
    return params, [chain(p, CHAIN_TOKENS) for p in PROMPTS]


def _engine(params, **kw):
    return srv.LlamaEngine(**{**ENGINE_KW, **kw}, params=params)


@pytest.mark.parametrize("kern,chunk", [("blocked", 8), ("gather", 0),
                                        ("blocked", 0), ("gather", 8)])
def test_greedy_streams_match_jax_chain(ref, kern, chunk):
    params, chains = ref
    want = [c[:MAX_TOKENS] for c in chains]
    eng = _engine(params, kv_attention=kern, prefill_chunk_tokens=chunk)
    try:
        got = [eng.generate(p, max_tokens=MAX_TOKENS)["token_ids"]
               for p in PROMPTS]
        st = eng.stats()
    finally:
        eng.close()
    assert got == want
    assert st["kv_blocks"]["used"] == 0  # every block came back
    assert st["nonfinite_logits"] == 0
    if chunk:
        assert st["pipeline"]["prefill_chunks"] >= len(PROMPTS) + 2
    else:
        assert st["pipeline"]["prefills"] == len(PROMPTS)


def test_concurrent_rows_and_preemption_keep_streams(ref):
    """Four 40-token requests through two rows of a pool that holds
    little more than one max_seq row: rows share forwards, the pool runs
    dry, the youngest row is preempted and requeued — and greedy output
    stays the chain's."""
    params, want = ref
    eng = _engine(params, kv_attention="blocked", prefill_chunk_tokens=8,
                  kv_blocks=18)
    outs = [None] * 4
    try:
        def one(j):
            outs[j] = eng.generate(PROMPTS[j + 1], max_tokens=CHAIN_TOKENS)

        ths = [threading.Thread(target=one, args=(j,)) for j in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    assert [o["token_ids"] for o in outs] == want[1:]
    assert st["kv_preemptions"] >= 1
    assert st["kv_blocks"]["used"] == 0


def _serve(eng):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                srv.make_handler(eng, "tiny"))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_http_concurrent_equals_sequential(ref):
    params, chains = ref
    want = [c[:MAX_TOKENS] for c in chains]
    eng = _engine(params, kv_attention="blocked", prefill_chunk_tokens=8)
    httpd, base = _serve(eng)
    try:
        seq = [_post(base + "/v1/generate",
                     {"prompt_ids": p, "max_tokens": MAX_TOKENS})
               for p in PROMPTS[:4]]
        conc = [None] * 4

        def one(j):
            conc[j] = _post(base + "/v1/generate",
                            {"prompt_ids": PROMPTS[j], "max_tokens": MAX_TOKENS})

        ths = [threading.Thread(target=one, args=(j,)) for j in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert [c for c, _, _ in seq] == [200] * 4
        assert [c for c, _, _ in conc] == [200] * 4
        assert [b["token_ids"] for _, _, b in conc] == \
            [b["token_ids"] for _, _, b in seq] == want[:4]
        assert _get(base + "/healthz") == (200, {"status": "ok"})
        code, models = _get(base + "/v1/models")
        assert code == 200 and models["models"][0]["name"] == "tiny"
        code, st = _get(base + "/v1/stats")
        assert code == 200 and st["requests"] == 8
        assert st["kv_blocks"]["attention_kernel"] == "blocked"
        assert st["pipeline"]["harvest"] == "synchronous"
        assert "ttft_ms_p50" in st
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def test_http_block_exhaustion_sheds_503(ref):
    params, _ = ref
    eng = _engine(params)
    httpd, base = _serve(eng)
    try:
        held = eng._alloc.alloc(eng._alloc.free_count)
        code, headers, body = _post(base + "/v1/generate",
                                    {"prompt_ids": [1, 2], "max_tokens": 4})
        assert code == 503 and body["shed"] and body["reason"] == "overloaded"
        assert int(headers["Retry-After"]) >= 1
        eng._alloc.free(held)
        code, _, body = _post(base + "/v1/generate",
                              {"prompt_ids": [1, 2], "max_tokens": 4})
        assert code == 200 and len(body["token_ids"]) == 4
        assert eng.stats()["kv_sheds"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def test_http_drain_and_unknown_version(ref):
    params, _ = ref
    eng = _engine(params)
    httpd, base = _serve(eng)
    try:
        code, _, body = _post(base + "/v1/generate",
                              {"prompt_ids": [1], "model_version": "v9"})
        assert code == 400 and body["unknown_version"]
        code, _, body = _post(base + "/admin/drain", {})
        assert code == 200 and body["draining"]
        code, headers, body = _post(base + "/v1/generate", {"prompt_ids": [1]})
        assert code == 503 and body["reason"] == "draining"
        assert "Retry-After" in headers
        assert eng.wait_drained(5.0)
        code, _, _ = _post(base + "/v1/nope", {})
        assert code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def test_queue_depth_shed_and_cancel(ref):
    params, _ = ref
    eng = _engine(params, max_queue_depth=1)
    try:
        with eng._cv:  # hold the scheduler so the queue cannot drain
            first = srv._Slot([1], 4, 0.0, request_id="r1")
            eng._waiting.append(first)
            eng._requests["r1"] = first
            with pytest.raises(srv.EngineOverloaded) as e:
                eng.generate([2], max_tokens=2, timeout_s=0.1)
            assert e.value.reason == "overloaded"
        assert eng.cancel("r1")
        assert first.result == {"error": "cancelled", "cancelled": True}
        assert not eng.cancel("r1")
        assert eng.stats()["shed"] == 1
    finally:
        eng.close()


@pytest.mark.parametrize("need,cap,want", [(31, 32, 32), (7, 32, 4),
                                           (100, 4, 4), (1, 32, 1),
                                           (3, 32, 4), (20, 32, 4)])
def test_segment_size_policy(need, cap, want):
    assert srv.LlamaEngine.segment_size(need, cap) == want


def test_engine_kwargs_reads_serve_config():
    kw = srv.engine_kwargs({"preset": "llama3-8b", "max_batch": 8,
                            "max_seq": 2048, "kv_block_size": 16,
                            "kv_attention": "blocked",
                            "prefill_chunk_tokens": 512}, "")
    assert kw["preset"] == "llama3-8b" and kw["max_batch"] == 8
    assert kw["max_seq"] == 2048 and kw["prefill_chunk_tokens"] == 512
    assert kw["kv_attention"] == "blocked" and kw["kv_layout"] == "paged"
    # the prefix cache is a later slice: off unless asked for (which raises)
    assert kw["prefix_cache_mb"] == 0.0
    assert kw["device"] is None  # the engine's default: the card


def test_serve_main_serves_and_stops(monkeypatch):
    """serve_main's path end to end on the CPU: config from the
    environment, a real socket, graceful stop through the cancel event."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = {"preset": "tiny", "max_batch": 2, "max_seq": 64,
           "kv_block_size": 4, "kv_attention": "blocked",
           "prefill_chunk_tokens": 8, "device": "cpu", "port": port}
    # serve_main reads the process environment: clear what an earlier
    # in-process serve_main (of either package) may have left there
    for name in [k for k in os.environ if k.startswith("KUBEDL_SERVE_")] \
            + ["KUBEDL_MODEL_PATH"]:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG", json.dumps(cfg))
    cancel = threading.Event()
    th = threading.Thread(target=srv.serve_main,
                          args=({"_KUBEDL_CANCEL": cancel},), daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(200):
            try:
                if _get(base + "/healthz")[0] == 200:
                    break
            except OSError:
                threading.Event().wait(0.05)
        code, _, body = _post(base + "/v1/generate",
                              {"prompt_ids": list(range(1, 20)),
                               "max_tokens": 5})
        assert code == 200 and len(body["token_ids"]) == 5
    finally:
        cancel.set()
        th.join(timeout=30)
    assert not th.is_alive()
