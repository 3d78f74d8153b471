"""The port's model lifecycle on the CPU: weights restored from a
checkpoint (written by the port or by the JAX package, through
``ckpt_dir`` and ``serve_main``'s ``KUBEDL_MODEL_PATH``), versions loaded
beside the serving one, requests naming each, activate / retire with
rows in flight, eviction after the drain, failed loads, the /admin/*
routes.

Streams are compared exactly: every version's greedy stream must equal a
single-version engine's on the same weights (float32 ``tiny``), and a
restored engine's the JAX model-function chain's. The prefix cache is
off but in one test, which shares a prefix across two versions: the
port keys the cache by version (the reference does not).
"""

import gc
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
import weakref
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402
from kubedl_tpu_torch.training import checkpoint as tck  # noqa: E402

PROMPTS = [[5, 9, 13], [7, 3, 3, 11, 2], [40, 41, 42, 43]]
MAX_TOKENS = 10
KW = dict(preset="tiny", device="cpu", max_batch=4, max_seq=64,
          kv_block_size=4, kv_blocks=80, prefix_cache_mb=0.0)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Three checkpoints: the reference's tiny init written by the JAX
    package ("jax"), and two port inits of other seeds written by the
    port ("v2", "v3"); with each one's single-version greedy streams."""
    import jax

    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.training import checkpoint as jck

    root = tmp_path_factory.mktemp("ckpts")
    jp = jl.llama_init(jax.random.PRNGKey(0), jl.preset("tiny"))
    jck.save_checkpoint(str(root / "jax"), {"params": jp}, 7)
    out = {"jax": (str(root / "jax"), tl.params_from_numpy(
        jax.tree.map(np.asarray, jp), tl.preset("tiny"), "cpu"))}
    for name, seed in (("v2", 5), ("v3", 9)):
        p = tl.llama_init(tl.preset("tiny"),
                          torch.Generator().manual_seed(seed), "cpu")
        tck.save_checkpoint(str(root / name), {"params": p}, 2)
        out[name] = (str(root / name), p)
    streams = {}
    for name, (_, p) in out.items():
        eng = srv.LlamaEngine(**KW, params=p)
        try:
            streams[name] = [eng.generate(q, MAX_TOKENS)["token_ids"]
                             for q in PROMPTS]
        finally:
            eng.close()
    return out, streams


def _jax_chain(prompt):
    """The JAX model-function chain (jitted) on the reference's tiny."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    cfg = jl.preset("tiny")
    jp = jl.llama_init(jax.random.PRNGKey(0), cfg)
    c = jl.init_paged_cache(cfg, 1, 64, 17, 4)
    c["bt"] = jnp.arange(1, 17, dtype=jnp.int32)[None]
    toks = np.zeros((1, 32), np.int32)
    toks[0, :len(prompt)] = prompt
    lg, c = jax.jit(lambda c, t, n: jl.paged_prefill_batched(
        jp, c, t, n, cfg))(c, jnp.asarray(toks),
                           jnp.asarray([len(prompt)], jnp.int32))
    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jp, c, t, cfg, kv_attention="blocked"))
    out = [int(jnp.argmax(lg[0]))]
    while len(out) < MAX_TOKENS:
        lg, c = step(c, jnp.asarray([[out[-1]]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def test_restore_from_jax_and_port_checkpoints(ckpts):
    out, streams = ckpts
    assert streams["jax"] == [_jax_chain(p) for p in PROMPTS]
    for name in ("jax", "v2"):
        for quant in ("", "int8"):
            eng = srv.LlamaEngine(**KW, ckpt_dir=out[name][0], quantize=quant)
            try:
                got = [eng.generate(p, MAX_TOKENS)["token_ids"]
                       for p in PROMPTS]
                if quant:
                    ref = srv.LlamaEngine(**KW, params=out[name][1],
                                          quantize="int8")
                    try:
                        want = [ref.generate(p, MAX_TOKENS)["token_ids"]
                                for p in PROMPTS]
                    finally:
                        ref.close()
                    assert tl.is_quantized(eng.params["layers"]["wq"])
                else:
                    want = streams[name]
            finally:
                eng.close()
            assert got == want, (name, quant)


def test_missing_checkpoint_at_init_serves_the_init(tmp_path):
    """The reference's permissive init: no checkpoint under ckpt_dir
    serves the seeded init (a hot-swap load is strict, below)."""
    a = srv.LlamaEngine(**KW, ckpt_dir=str(tmp_path / "none"))
    b = srv.LlamaEngine(**KW)
    try:
        assert a.generate(PROMPTS[0], 5)["token_ids"] == \
            b.generate(PROMPTS[0], 5)["token_ids"]
    finally:
        a.close()
        b.close()


def test_requests_name_each_version(ckpts):
    out, streams = ckpts
    eng = srv.LlamaEngine(**KW, ckpt_dir=out["jax"][0])
    try:
        eng.load_version("v2", out["v2"][0])
        eng.load_version("v2", out["v2"][0])  # idempotent
        assert eng.versions()["loaded"] == ["base", "v2"]
        got = {}

        def one(j, v):
            got[(j, v)] = eng.generate(PROMPTS[j], MAX_TOKENS,
                                       model_version=v)

        ths = [threading.Thread(target=one, args=(j, v))
               for j in range(len(PROMPTS)) for v in ("base", "v2", "")]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    for j in range(len(PROMPTS)):
        assert got[(j, "base")]["token_ids"] == streams["jax"][j]
        assert got[(j, "")]["token_ids"] == streams["jax"][j]
        assert got[(j, "v2")]["token_ids"] == streams["v2"][j]
        assert got[(j, "v2")]["model_version"] == "v2"
    assert st["weights"]["resident_bytes"] == 2 * st["weights"]["bytes"]
    # one version a tick, and rows of the other keep their device chain
    # token: alternating never rebuilds the feed from the host
    assert st["pipeline"]["chain_rebuilds"] == 0


def test_activate_and_retire_with_rows_in_flight(ckpts, monkeypatch):
    """Rows of the retiring version finish on its weights; new requests
    naming it are refused; its tree is evicted once they drain."""
    out, streams = ckpts
    gate = threading.Event()
    real = srv.llama.paged_decode_segment

    def held(*a, **k):
        gate.wait(timeout=60)
        return real(*a, **k)

    eng = srv.LlamaEngine(**KW, ckpt_dir=out["jax"][0])
    try:
        eng.load_version("v2", out["v2"][0])
        leaf = weakref.ref(eng._versions["base"]["layers"]["wq"])
        monkeypatch.setattr(srv.llama, "paged_decode_segment", held)
        got = {}

        def one(j):
            got[j] = eng.generate(PROMPTS[j], MAX_TOKENS,
                                  model_version="base")

        ths = [threading.Thread(target=one, args=(j,)) for j in range(2)]
        for t in ths:
            t.start()
        # one row admitted and held in its decode segment, the other
        # queued behind it: both reference "base"

        def refs():
            with eng._cv:
                return eng._version_refs_locked("base")

        deadline = time.time() + 30
        while refs() < 2 or not eng.versions()["active_rows"].get("base"):
            assert time.time() < deadline
            time.sleep(0.01)
        assert eng.activate_version("v2") == "base"
        with pytest.raises(ValueError, match="default"):
            eng.retire_version("v2")
        assert eng.retire_version("base") is True
        assert eng.retire_version("never-loaded") is False
        inv = eng.versions()
        assert inv["default"] == "v2" and inv["retiring"] == ["base"]
        assert inv["active_rows"]["base"] >= 1 and refs() == 2
        with pytest.raises(srv.UnknownModelVersion):
            eng.generate(PROMPTS[2], 2, model_version="base")
        with pytest.raises(ValueError, match="retiring"):
            eng.load_version("base", out["jax"][0])
        gate.set()
        for t in ths:
            t.join(timeout=120)
        deadline = time.time() + 30
        while eng.versions()["loaded"] != ["v2"]:
            assert time.time() < deadline
            time.sleep(0.01)
        # the default is v2 now
        new = eng.generate(PROMPTS[2], MAX_TOKENS)
    finally:
        gate.set()
        eng.close()
    assert [got[j]["token_ids"] for j in range(2)] == streams["jax"][:2]
    assert new["token_ids"] == streams["v2"][2]
    assert new["model_version"] == "v2"
    del eng
    gc.collect()
    assert leaf() is None  # the retired tree is freed


def test_prefix_cache_is_keyed_by_version(ckpts):
    """With the cache on and versions resident, a prefix stored by one
    version's request is grafted by the same version's next request and
    never by another's, nor by a version loaded after the storing one
    was evicted: each stream equals its version's engine with the cache
    off. Only the default version's prefixes are advertised."""
    out, _ = ckpts
    system = list(range(20, 38))  # 18 tokens: 4 full blocks and a tail
    warm, user = system + [1], system + [9, 8, 7]
    want = {}
    for name in ("jax", "v2", "v3"):
        eng = srv.LlamaEngine(**KW, params=out[name][1])
        try:
            want[name] = [eng.generate(p, MAX_TOKENS)["token_ids"]
                          for p in (warm, user)]
        finally:
            eng.close()
    eng = srv.LlamaEngine(**dict(KW, prefix_cache_mb=64.0),
                          ckpt_dir=out["jax"][0])
    try:
        eng.load_version("v2", out["v2"][0])
        first = eng.generate(warm, MAX_TOKENS, cache_prefix=True)
        other = eng.generate(user, MAX_TOKENS, model_version="v2")
        same = eng.generate(user, MAX_TOKENS, model_version="base")
        v2_warm = eng.generate(warm, MAX_TOKENS, cache_prefix=True,
                               model_version="v2")
        v2_user = eng.generate(user, MAX_TOKENS, model_version="v2")
        adv_base = eng.stats()["prefix_cache"]["advertised"]
        # v2's entry outlives v2: a version loaded after it must not
        # match it
        assert eng.retire_version("v2") is True
        deadline = time.time() + 30
        while eng.versions()["loaded"] != ["base"]:
            assert time.time() < deadline
            time.sleep(0.01)
        eng.load_version("v3", out["v3"][0])
        v3_user = eng.generate(user, MAX_TOKENS, model_version="v3")
        eng.activate_version("v3")
        adv_v3 = eng.stats()["prefix_cache"]["advertised"]
    finally:
        eng.close()
    assert first["token_ids"] == want["jax"][0]
    assert other["cached_prefix_len"] == 0
    assert other["token_ids"] == want["v2"][1]
    assert same["cached_prefix_len"] == len(system)
    assert same["token_ids"] == want["jax"][1]
    assert v2_warm["cached_prefix_len"] == 0
    assert v2_warm["token_ids"] == want["v2"][0]
    assert v2_user["cached_prefix_len"] == len(system)
    assert v2_user["token_ids"] == want["v2"][1]
    assert v3_user["cached_prefix_len"] == 0
    assert v3_user["token_ids"] == want["v3"][1]
    assert len(adv_base) == 1 and adv_v3 == []


def test_failed_load_leaves_versions_untouched(ckpts, tmp_path):
    out, streams = ckpts
    torn = tmp_path / "torn"
    tck.save_checkpoint(str(torn), {"params": out["v2"][1]}, 1)
    (torn / "step-00000001" / "meta.json").unlink()
    eng = srv.LlamaEngine(**KW, ckpt_dir=out["jax"][0])
    try:
        before = eng.versions()
        with pytest.raises(ValueError, match="no checkpoint"):
            eng.load_version("v3", str(tmp_path / "missing"))
        with pytest.raises(ValueError, match="torn"):
            eng.load_version("v3", str(torn))
        with pytest.raises(ValueError):
            eng.load_version("", out["v3"][0])
        assert eng.versions() == before
        assert eng.generate(PROMPTS[1], MAX_TOKENS)["token_ids"] == \
            streams["jax"][1]
        with pytest.raises(srv.UnknownModelVersion):
            eng.activate_version("v3")
    finally:
        eng.close()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_routes(ckpts):
    out, streams = ckpts
    eng = srv.LlamaEngine(**KW, ckpt_dir=out["jax"][0])
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                srv.make_handler(eng, "tiny"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        code, body = _post(base, "/admin/load_version",
                           {"version": "v3", "ckpt_dir": out["v3"][0]})
        assert code == 200 and body["loaded"] == ["base", "v3"]
        code, body = _post(base, "/admin/load_version",
                           {"version": "v4", "ckpt_dir": "/nonexistent"})
        assert code == 400 and body["load_failed"]
        code, body = _post(base, "/v1/generate",
                           {"prompt_ids": PROMPTS[0], "max_tokens": MAX_TOKENS,
                            "model_version": "v3"})
        assert code == 200 and body["token_ids"] == streams["v3"][0]
        code, body = _post(base, "/admin/activate_version", {"version": "v3"})
        assert code == 200 and body["previous"] == "base"
        assert body["default"] == "v3"
        code, body = _post(base, "/admin/activate_version", {"version": "v9"})
        assert code == 400
        code, body = _post(base, "/admin/retire_version", {"version": "base"})
        assert code == 200 and body["retired"] is True
        code, body = _post(base, "/admin/retire_version", {"version": "v3"})
        assert code == 400  # the default cannot retire
        code, body = _post(base, "/v1/generate",
                           {"prompt_ids": PROMPTS[1], "max_tokens": MAX_TOKENS})
        assert code == 200 and body["token_ids"] == streams["v3"][1]
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
            models = json.loads(r.read())
        assert models["models"][0]["versions"]["default"] == "v3"
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def _clean_env(monkeypatch):
    # serve_main reads the process environment: clear what an earlier
    # in-process serve_main (of either package) may have left there
    for name in [k for k in os.environ if k.startswith("KUBEDL_SERVE_")] \
            + ["KUBEDL_MODEL_PATH"]:
        monkeypatch.delenv(name, raising=False)


def test_serve_main_restores_model_path(ckpts, monkeypatch):
    """KUBEDL_MODEL_PATH naming a local JAX-written checkpoint: the
    replica serves those weights (the JAX chain's streams), int8 too."""
    out, streams = ckpts
    _clean_env(monkeypatch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = {"preset": "tiny", "max_batch": 2, "max_seq": 64,
           "kv_block_size": 4, "prefix_cache_mb": 0, "device": "cpu",
           "port": port, "quantize": "int8"}
    # through monkeypatch, so the process environment is restored after
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG", json.dumps(cfg))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", out["jax"][0])
    cancel = threading.Event()
    th = threading.Thread(target=srv.serve_main, daemon=True,
                          args=({"_KUBEDL_CANCEL": cancel},))
    th.start()
    base = f"http://127.0.0.1:{port}"
    ref = srv.LlamaEngine(**KW, params=out["jax"][1], quantize="int8")
    try:
        want = ref.generate(PROMPTS[2], MAX_TOKENS)["token_ids"]
        for _ in range(400):
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.05)
        code, body = _post(base, "/v1/generate",
                           {"prompt_ids": PROMPTS[2],
                            "max_tokens": MAX_TOKENS})
        assert code == 200 and body["token_ids"] == want
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["weights"]["quantize"] == "int8"
    finally:
        cancel.set()
        th.join(timeout=30)
        ref.close()
    assert not th.is_alive()


def test_serve_main_rejects_a_remote_model_root(monkeypatch, tmp_path):
    """A remote model root is mirrored before any engine is built, so one
    that cannot be fetched fails serve_main with the blob client's error
    (serving it is held in ``test_torch_lifecycle.py``)."""
    from kubedl_tpu_torch.remote.client import RemoteError

    _clean_env(monkeypatch)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG",
                       json.dumps({"preset": "tiny", "device": "cpu"}))
    monkeypatch.setenv("KUBEDL_MODEL_PATH",
                       "http://127.0.0.1:1/blobs/models/m1")
    built = []
    monkeypatch.setattr(srv, "LlamaEngine", lambda **kw: built.append(kw))
    with pytest.raises(RemoteError):
        srv.serve_main({})
    assert built == []
    assert srv.is_remote_root("https://h:1/blobs/a")
    assert not srv.is_remote_root("/data/models/m1")


def test_engine_kwargs_reads_quantize(monkeypatch):
    _clean_env(monkeypatch)
    assert srv.engine_kwargs({}, "")["quantize"] == ""
    monkeypatch.setenv("KUBEDL_SERVE_QUANTIZE", "int8")
    assert srv.engine_kwargs({}, "/m")["quantize"] == "int8"
    assert srv.engine_kwargs({}, "/m")["ckpt_dir"] == "/m"
    assert srv.engine_kwargs({"quantize": ""}, "")["quantize"] == ""
