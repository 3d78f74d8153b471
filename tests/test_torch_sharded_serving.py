"""Serving over a mesh in the port (``models/llama.py``'s
``serving_shardings`` and ``ServingSplit``, ``parallel/mesh.py``'s
``ServingMesh``, ``LlamaEngine(mesh_axes=...)`` and ``serve_main`` with
``"mesh"``) against the JAX package on the CPU.

The reference shards the serving weights with ``NamedSharding`` over a
mesh of conftest's forced host devices and lets XLA place the
collectives; the port cuts the same leaves into each rank's shards in
one process. Parameters are the reference's ``llama_init(PRNGKey(0))``
carried over with ``params_from_numpy`` (an int8 tree: the reference's
``q8`` / ``s8`` arrays as they are). Tolerances, float32:

- the spec trees equal the reference's, raw and int8, tied and untied
  heads; each rank's shards equal the reference's shards bit for bit
  wherever the port keeps the reference's layout (everywhere but
  ``wk`` / ``wv`` when ``n_kv_heads`` does not divide by ``tensor``,
  which the port cuts by whole KV heads);
- the sharded ``prefill_batched`` / ``decode_step_batched`` logits
  within 1e-5 max abs of the reference's sharded ones (the row-parallel
  partials are summed in another order than XLA's psum);
- the engines: greedy streams equal to the reference's mesh engine,
  token for token (tiny at ``tensor=4``, tiny-gemma at ``tensor=4`` on
  several prompts, int8 at ``tensor=2``); the reference's normalization
  (paged -> contiguous, ``spec_k`` -> 0) and its error for an explicit
  contiguous layout with speculation; a prefix-cache hit with the same
  tokens as an engine without the cache; ``serve_main`` over HTTP.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.api.topology import MeshSpec  # noqa: E402
from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.parallel.mesh import ServingMesh  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

LOGIT_TOL = 1e-5
MESHES = {
    "tensor2": {"tensor": 2},
    "tensor4": {"tensor": 4},
    "fsdp2-tensor2": {"fsdp": 2, "tensor": 2},
    "data2": {"data": 2},
}
PRESETS = ("tiny", "tiny-gemma")


def _jax_mesh(axes):
    import jax

    from kubedl_tpu.api.topology import MeshSpec as JMeshSpec
    from kubedl_tpu.parallel.mesh import build_mesh

    n = int(np.prod(list(axes.values())))
    return build_mesh(JMeshSpec(dict(axes)), jax.devices()[:n])


@pytest.fixture(scope="module")
def models():
    """preset -> (jl, jcfg, jp, tcfg, tp): the reference's params in both
    packages."""
    import jax

    from kubedl_tpu.models import llama as jl

    out = {}
    for name in PRESETS:
        jcfg, tcfg = jl.preset(name), tl.preset(name)
        jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
        tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        out[name] = (jl, jcfg, jp, tcfg, tp)
    return out


def _int8_both(jl, jcfg, jp):
    """The reference's int8 tree, and the same arrays as a port tree."""
    import jax

    jq = jl.quantize_params(jp, jcfg)

    def carry(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy())
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)

    return jq, jax.tree.map(carry, jq)


def _split(cfg, axes):
    return tl.ServingSplit(cfg, ServingMesh(MeshSpec(axes), "cpu"))


# ---- the spec trees and the shards ----------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("preset", PRESETS)
def test_serving_shardings_match_reference(models, preset, int8):
    """``serving_shardings`` is the reference's tree of specs, on every
    mesh, for the raw and the int8 tree (tiny's head is untied,
    tiny-gemma's tied)."""
    import jax
    from jax.sharding import NamedSharding

    jl, jcfg, jp, tcfg, tp = models[preset]
    jtree, ttree = _int8_both(jl, jcfg, jp) if int8 else (jp, tp)
    assert ("lm_head" in ttree) == (not tcfg.tie_embeddings)
    for axes in MESHES.values():
        want = jl.serving_shardings(jtree, jcfg, _jax_mesh(axes))
        got = tl.serving_shardings(ttree, tcfg, ServingMesh(MeshSpec(axes),
                                                              "cpu"))
        flat = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, NamedSharding))
        mine = dict(tl.named_leaves(got))
        assert len(flat) == len(mine)
        for path, sh in flat:
            key = "/".join(k.key for k in path)
            assert mine[key] == tuple(sh.spec), (axes, key)


@pytest.mark.parametrize("int8", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_rank_shards_match_reference(models, preset, mesh, int8):
    """Each rank's shards (``ServingSplit.shard``) are the reference's
    ``shard_serving_params`` shards on the device of the same mesh
    position, bit for bit, where the port keeps its layout; ``wk`` /
    ``wv`` with fewer KV heads than tensor ranks hold the KV heads the
    rank's q heads read."""
    import jax

    jl, jcfg, jp, tcfg, tp = models[preset]
    axes = MESHES[mesh]
    jtree, ttree = _int8_both(jl, jcfg, jp) if int8 else (jp, tp)
    jmesh = _jax_mesh(axes)
    placed = jl.shard_serving_params(jtree, jcfg, jmesh)
    split = _split(tcfg, axes)
    ranks = split.shard(ttree)
    devices = list(jmesh.devices.flat)
    tp_n = axes.get("tensor", 1)
    hd, kv = tcfg.head_dim, tcfg.n_kv_heads
    for r, mine in enumerate(ranks):
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            key = "/".join(k.key for k in path)
            got = _at_path(mine, path)
            ref = next(s for s in leaf.addressable_shards
                       if s.device == devices[r])
            name = "/".join(k.key for k in path[:2] if k.key not in
                            ("q8", "s8"))
            if name in ("layers/wk", "layers/wv") and kv % tp_n:
                # whole KV heads: the heads this rank's q heads read
                c = split.mesh.coords[r]
                lo, hi = split.kv_heads[c["tensor"]]
                want = np.asarray(jax.device_get(leaf))[..., lo * hd:hi * hd]
                for d, a in enumerate(leaf.sharding.spec):
                    if a == "fsdp":  # the fsdp cut, as the reference's
                        k = want.shape[d] // axes["fsdp"]
                        want = np.take(want, range(c["fsdp"] * k,
                                                   (c["fsdp"] + 1) * k), d)
                np.testing.assert_array_equal(_np(got), want.astype(
                    _np(got).dtype), err_msg=key)
                continue
            np.testing.assert_array_equal(
                _np(got), np.asarray(ref.data).astype(_np(got).dtype),
                err_msg=key)


def _at_path(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---- the model functions under the split ------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_prefill_and_decode_match_reference(models, preset, mesh):
    """``prefill_batched`` then four ``decode_step_batched`` steps on the
    split against the reference's jitted functions on its sharded
    params: logits within 1e-5, positions equal."""
    import jax
    import jax.numpy as jnp

    jl, jcfg, jp, tcfg, tp = models[preset]
    axes = MESHES[mesh]
    jps = jl.shard_serving_params(jp, jcfg, _jax_mesh(axes))
    split = _split(tcfg, axes)
    tps = split.shard(tp)
    B, S, T = 2, 8, 32
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.asarray([8, 5], np.int32)
    prefill = jax.jit(lambda p, c, t, n: jl.prefill_batched(p, c, t, n, jcfg))
    step = jax.jit(lambda p, c, t: jl.decode_step_batched(p, c, t, jcfg))
    jc = jl.init_batched_cache(jcfg, B, T)
    tc = tl.init_batched_cache(tcfg, B, T, split=split)
    jlog, jc = prefill(jps, jc, jnp.asarray(toks), jnp.asarray(lens))
    tlog, tc = tl.prefill_batched(tps, tc, torch.from_numpy(toks),
                                  torch.from_numpy(lens), tcfg, split)
    assert np.abs(tlog.numpy() - np.asarray(jlog)).max() < LOGIT_TOL
    for _ in range(4):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
        jlog, jc = step(jps, jc, jnp.asarray(nxt))
        tlog, tc = tl.decode_step_batched(tps, tc, torch.from_numpy(nxt),
                                          tcfg, split)
        assert np.abs(tlog.numpy() - np.asarray(jlog)).max() < LOGIT_TOL
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    # each computing rank's cache holds its KV heads only
    for j, (lo, hi) in enumerate(split.kv_heads):
        assert tc["k"][j].shape[3] == hi - lo
        np.testing.assert_allclose(
            tc["k"][j].numpy(), np.asarray(jc["k"])[:, :, :, lo:hi],
            atol=LOGIT_TOL, rtol=0)


def test_uneven_kv_grouping_matches_unsharded():
    """Six q heads over three KV heads on two tensor ranks: a rank's q
    heads read one and a half KV heads each, so its held heads are
    indexed per q head; the split's prefill and decode logits agree with
    the unsharded functions' within 1e-5."""
    import dataclasses

    cfg = dataclasses.replace(tl.preset("tiny"), n_heads=6, n_kv_heads=3,
                              dim=96, ffn_dim=128)
    p = tl.llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    split = _split(cfg, {"tensor": 2})
    assert split.kv_heads == [(0, 2), (1, 3)]
    ps = split.shard(p)
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1)).int()
    lens = torch.tensor([6, 3], dtype=torch.int32)
    c0 = tl.init_batched_cache(cfg, 2, 16)
    c1 = tl.init_batched_cache(cfg, 2, 16, split=split)
    l0, c0 = tl.prefill_batched(p, c0, toks, lens, cfg)
    l1, c1 = tl.prefill_batched(ps, c1, toks, lens, cfg, split)
    assert (l0 - l1).abs().max() < LOGIT_TOL
    nxt = l0.argmax(-1).int()[:, None]
    l0, _ = tl.decode_step_batched(p, c0, nxt, cfg)
    l1, _ = tl.decode_step_batched(ps, c1, nxt, cfg, split)
    assert (l0 - l1).abs().max() < LOGIT_TOL


# ---- the engine -------------------------------------------------------------------

def _ref_streams(preset, prompts, n, **kw):
    from kubedl_tpu.serving.server import LlamaEngine

    eng = LlamaEngine(preset=preset, max_batch=2, max_seq=64, **kw)
    try:
        return [eng.generate(p, max_tokens=n)["token_ids"] for p in prompts]
    finally:
        eng.close()


def _port_engine(models, preset, **kw):
    return srv.LlamaEngine(preset=preset, max_batch=2, max_seq=64,
                           device="cpu", params=models[preset][4], **kw)


@pytest.mark.parametrize("preset,axes,quantize,prompts", [
    ("tiny", {"tensor": 4}, "", [[5, 9, 13]]),
    ("tiny-gemma", {"tensor": 4}, "",
     [[5, 9, 13], [3, 7, 11, 2], [100, 4], [17, 250, 31, 8, 8]]),
    ("tiny", {"tensor": 2}, "int8", [[3, 7], [5, 9, 13]]),
    ("tiny", {"fsdp": 2, "tensor": 2}, "", [[5, 9, 13], [42, 1]]),
    ("tiny-gemma", {"data": 2}, "", [[3, 7, 11, 2]]),
], ids=["tiny-tensor4", "tiny-gemma-tensor4", "tiny-int8-tensor2",
        "tiny-fsdp2-tensor2", "tiny-gemma-data2"])
def test_mesh_engine_streams_match_reference(models, preset, axes, quantize,
                                             prompts):
    """Greedy streams of the port's mesh engine equal the reference's
    mesh engine's on the same prompts; the engine holds only its shards
    (per rank, less than the whole tree on a tensor split) and says so
    in ``stats()["mesh"]``."""
    want = _ref_streams(preset, prompts, 6, mesh_axes=axes,
                        quantize=quantize)
    eng = _port_engine(models, preset, mesh_axes=axes, quantize=quantize)
    try:
        got = [eng.generate(p, max_tokens=6)["token_ids"] for p in prompts]
        st = eng.stats()
    finally:
        eng.close()
    assert got == want
    if preset == "tiny" and axes == {"tensor": 4}:
        assert got[0] == [39, 21, 39, 21, 244, 188]
    m = st["mesh"]
    n = int(np.prod(list(axes.values())))
    assert m["axes"] == axes and len(m["devices"]) == n == len(
        m["weight_bytes"]) == len(m["kv_bytes"])
    assert m["devices"] == ["cpu"] * n and m["ranks_per_device"] == n
    whole = tl.params_nbytes(tl.quantize_params(models[preset][4],
                                                tl.preset(preset))
                             if quantize else models[preset][4])
    tp_n = axes.get("tensor", 1)
    split_axes = tp_n * axes.get("fsdp", 1)
    for b in m["weight_bytes"]:
        assert (b < whole) if split_axes > 1 else (b == whole)
    computing = [r for r, b in enumerate(m["kv_bytes"]) if b]
    assert computing == m["computing_ranks"] and len(computing) == tp_n
    assert st["weights"]["bytes"] == sum(m["weight_bytes"])


def test_mesh_normalization_and_errors(models):
    """The reference's normalization: a mesh engine's paged layout
    becomes contiguous and its ``spec_k`` 0; an explicit contiguous
    layout with ``spec_k`` raises the reference's error; a mesh engine
    cannot hot-load (paged only); an axis that does not divide a
    dimension raises."""
    from kubedl_tpu.serving.server import LlamaEngine as JEngine

    eng = _port_engine(models, "tiny", mesh_axes={"tensor": 2}, spec_k=4)
    try:
        assert eng.kv_layout == "contiguous" and eng.spec_k == 0
        assert "kv_blocks" not in eng.stats()
        with pytest.raises(ValueError, match="requires kv_layout='paged'"):
            eng.load_version("v2", "/nonexistent")
    finally:
        eng.close()
    with pytest.raises(ValueError) as ref:
        JEngine(preset="tiny", max_seq=64, mesh_axes={"tensor": 2},
                kv_layout="contiguous", spec_k=4)
    with pytest.raises(ValueError) as got:
        _port_engine(models, "tiny", mesh_axes={"tensor": 2},
                     kv_layout="contiguous", spec_k=4)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="n_heads=4 not divisible by "
                                         "tensor=3"):
        _port_engine(models, "tiny", mesh_axes={"tensor": 3})


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_mesh_engine_roles_serve(models, role):
    """The advisory roles serve generate on a tensor=2 mesh as the
    unsharded contiguous engine does."""
    eng = _port_engine(models, "tiny", mesh_axes={"tensor": 2}, role=role)
    base = _port_engine(models, "tiny", kv_layout="contiguous")
    try:
        assert eng.generate([5, 9, 13], max_tokens=4)["token_ids"] == \
            base.generate([5, 9, 13], max_tokens=4)["token_ids"]
        assert eng.stats()["role"] == role
    finally:
        eng.close()
        base.close()


def test_mesh_prefix_cache_hit_keeps_tokens(models):
    """A prompt inserted on its first request grafts its prefix into the
    next request that shares it (each rank's KV heads), with the tokens
    of an engine without the cache."""
    shared = list(range(3, 23))
    # the first entry is its prompt less one token: the shared prefix
    prompts = [shared + [30], shared + [40, 41]]
    plain = _port_engine(models, "tiny", mesh_axes={"tensor": 2},
                         prefix_cache_mb=0.0)
    eng = _port_engine(models, "tiny", mesh_axes={"tensor": 2})
    try:
        want = [plain.generate(p, max_tokens=5)["token_ids"]
                for p in prompts]
        first = eng.generate(prompts[0], max_tokens=5, cache_prefix=True)
        second = eng.generate(prompts[1], max_tokens=5)
        st = eng.stats()["prefix_cache"]
    finally:
        plain.close()
        eng.close()
    assert [first["token_ids"], second["token_ids"]] == want
    assert first["cached_prefix_len"] == 0
    assert second["cached_prefix_len"] == len(shared) and st["hits"] == 1


def test_serve_main_serves_a_mesh(monkeypatch):
    """serve_main with ``{"mesh": {"tensor": 2}}`` in the config answers
    over HTTP on the CPU and reports the mesh in its stats."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = {"preset": "tiny", "max_batch": 2, "max_seq": 64,
           "mesh": {"tensor": 2}, "device": "cpu", "port": port}
    for name in [k for k in os.environ if k.startswith("KUBEDL_SERVE_")] \
            + ["KUBEDL_MODEL_PATH"]:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG", json.dumps(cfg))
    assert srv.engine_kwargs(cfg, "")["mesh_axes"] == {"tensor": 2}
    cancel = threading.Event()
    th = threading.Thread(target=srv.serve_main,
                          args=({"_KUBEDL_CANCEL": cancel},), daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(400):
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5):
                    break
            except OSError:
                threading.Event().wait(0.05)
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"prompt_ids": [5, 9, 13],
                             "max_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        with urllib.request.urlopen(base + "/v1/stats", timeout=10) as r:
            stats = json.loads(r.read())
    finally:
        cancel.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert len(body["token_ids"]) == 5
    assert stats["mesh"]["axes"] == {"tensor": 2}
    assert len(stats["mesh"]["weight_bytes"]) == 2


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_mesh_engine_restores_a_checkpoint(models, tmp_path, quantize):
    """A checkpoint restored into a mesh engine is cut as each leaf lands
    (quantized first under int8): the streams equal the unsharded
    contiguous engine's restored from the same checkpoint, and no rank
    holds a whole tensor-split leaf."""
    from kubedl_tpu_torch.training.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path), {"params": models["tiny"][4]}, 1)
    kw = dict(preset="tiny", max_batch=2, max_seq=64, device="cpu",
              ckpt_dir=str(tmp_path), quantize=quantize)
    base = srv.LlamaEngine(kv_layout="contiguous", **kw)
    eng = srv.LlamaEngine(mesh_axes={"tensor": 2}, **kw)
    try:
        for p in ([5, 9, 13], [42, 1, 7]):
            assert eng.generate(p, max_tokens=5)["token_ids"] == \
                base.generate(p, max_tokens=5)["token_ids"]
        whole = base.params["layers"]["wq"]
        for rank in eng.params:
            wq = rank["layers"]["wq"]
            got = wq["q8"] if quantize else wq
            want = whole["q8"] if quantize else whole
            assert got.shape[-1] * 2 == want.shape[-1]
    finally:
        base.close()
        eng.close()
