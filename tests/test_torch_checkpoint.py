"""The port's checkpoint module (kubedl_tpu_torch.training.checkpoint)
against the reference's (kubedl_tpu.training.checkpoint): the same tree
path strings, each package restoring the other's checkpoints, sharded
entries assembled whole, torn-step fallback, and the same fingerprint.

Every comparison here is exact: a checkpoint moves bits, so restored
values must equal the saved ones bit for bit (float32 and bf16 alike).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubedl_tpu.models import llama as jl  # noqa: E402
from kubedl_tpu.training import checkpoint as jck  # noqa: E402
from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.training import checkpoint as tck  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _keystrs(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_params(name, dtype=None):
    cfg = jl.preset(name)
    p = jl.llama_init(jax.random.PRNGKey(0), cfg)
    if dtype is not None:
        p = jax.tree.map(lambda a: a.astype(dtype), p)
    return p


def _torch_tree(jtree, dtype):
    """The same values as torch tensors of ``dtype`` (exact: bf16 values
    go through float32)."""
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(dtype),
        jtree)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _same(jtree, ttree):
    """Bit-equal leaves, compared in float32 (exact for bf16)."""
    jl_ = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl_ = list(tck._leaf_items(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl_] == [k for k, _ in tl_]
    for (_, a), (_, b) in zip(jl_, tl_):
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(a).astype(jnp.float32)), _np(b).astype(
                np.float32))


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma", "tiny-deep"])
def test_leaf_items_match_keystr_on_llama_tree(name):
    jp = _jax_params(name)
    tp = tl.llama_init(tl.preset(name), torch.Generator().manual_seed(0),
                       "cpu")
    want = _keystrs({"params": jp})
    assert [k for k, _ in tck._leaf_items({"params": tp})] == want


def test_leaf_items_match_keystr_on_jax_trainer_state():
    """The JAX Trainer's whole state: params, the optax chain's named
    tuples (``.count``, ``.mu``, ``.nu``), empty states and the step."""
    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    tr = jt.Trainer(jt.TrainConfig(model=jl.TINY, attn_impl="dense",
                                   global_batch=2, seq_len=16), mesh)
    state = tr.init_state()
    got = [k for k, _ in tck._leaf_items(state)]
    assert got == _keystrs(state)
    assert any(".mu" in k for k in got) and any(".count" in k for k in got)


def test_leaf_items_order_and_unflatten_round_trip():
    import collections

    NT = collections.namedtuple("NT", "count mu")
    tree = {"b": [1, (2, 3)], "a": {"z": 4, "y": NT(5, {"q": 6})},
            "n": None, "e": ()}
    items = list(tck._leaf_items(tree))
    assert [k for k, _ in items] == _keystrs(tree)
    back = tck._unflatten(tree, iter(v for _, v in items))
    assert back == tree and list(back) == list(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    jp = _jax_params("tiny", getattr(jnp, dtype))
    jck.save_checkpoint(str(tmp_path), {"params": jp}, 3)
    like = {"params": tl.param_like(dataclasses.replace(
        tl.preset("tiny"), dtype=getattr(torch, dtype)))}
    got = tck.restore_checkpoint(str(tmp_path), like, device="cpu")
    assert got["params"]["layers"]["wq"].dtype == getattr(torch, dtype)
    _same({"params": jp}, got)
    assert tck.latest_step(str(tmp_path)) == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jp = _jax_params("tiny")
    tp = _torch_tree(jp, torch.float32)
    tck.save_checkpoint(str(tmp_path), {"params": tp}, 5)
    assert jck.latest_step(str(tmp_path)) == 5
    got = jck.restore_checkpoint(str(tmp_path), {"params": jp})
    _same(got, {"params": tp})


def test_port_bf16_entries_are_the_references_bits(tmp_path):
    """bf16 leaves: the port writes the reference's manifest and the same
    two-byte entries (the bits), so the reference reads a port checkpoint
    exactly as it reads its own."""
    jp = _jax_params("tiny", jnp.bfloat16)
    jck.save_checkpoint(str(tmp_path / "ref"), {"params": jp}, 1)
    tck.save_checkpoint(str(tmp_path / "port"),
                        {"params": _torch_tree(jp, torch.bfloat16)}, 1)
    metas = [json.loads((tmp_path / d / "step-00000001" / "meta.json")
                        .read_text()) for d in ("ref", "port")]
    assert metas[0] == metas[1]
    zr = np.load(tmp_path / "ref" / "step-00000001" / "shards-p0.npz")
    zp = np.load(tmp_path / "port" / "step-00000001" / "shards-p0.npz")
    assert sorted(zr.files) == sorted(zp.files)
    for k in zr.files:
        assert zr[k].dtype.itemsize == zp[k].dtype.itemsize == 2
        assert zr[k].tobytes() == zp[k].tobytes(), k
    # and the port restores both
    like = {"params": tl.param_like(dataclasses.replace(
        tl.preset("tiny"), dtype=torch.bfloat16))}
    a = tck.restore_checkpoint(str(tmp_path / "ref"), like, device="cpu")
    b = tck.restore_checkpoint(str(tmp_path / "port"), like, device="cpu")
    for (_, x), (_, y) in zip(tck._leaf_items(a), tck._leaf_items(b)):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def test_sharded_jax_checkpoint_restores_whole(tmp_path):
    """A leaf sharded over a 4-device CPU mesh is saved as
    ``key@offs+shape`` entries; the port assembles it whole."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("a", "b"))
    rng = np.random.RandomState(0)
    w = rng.randn(8, 6).astype(np.float32)
    v = rng.randn(4).astype(np.float32)
    state = {"w": jax.device_put(w, NamedSharding(mesh, P("a", "b"))),
             "v": jax.device_put(v, NamedSharding(mesh, P()))}
    jck.save_checkpoint(str(tmp_path), state, 2)
    files = np.load(tmp_path / "step-00000002" / "shards-p0.npz").files
    assert any(k.startswith("['w']@") and "+" in k for k in files), files
    like = {"w": torch.empty(8, 6, device="meta"),
            "v": torch.empty(4, device="meta")}
    got = tck.restore_checkpoint(str(tmp_path), like, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), w)
    np.testing.assert_array_equal(got["v"].numpy(), v)


def test_hand_written_shard_entries(tmp_path):
    """Shard entries written by hand (and one legacy key with no shape),
    assembled whole; a missing piece is an incomplete checkpoint."""
    d = tmp_path / "step-00000001"
    d.mkdir()
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    top = tck._shard_key("['x']", (slice(0, 2), slice(0, 6)), (2, 6))
    assert top == "['x']@0,0+2x6"
    np.savez(d / "shards-p0.npz", **{
        top: a[:2], tck._shard_key("['x']", (slice(2, 4), slice(0, 6))): a[2:]})
    (d / "meta.json").write_text(json.dumps(
        {"step": 1, "nprocs": 1,
         "leaves": {"['x']": {"shape": [4, 6], "dtype": "float32"}}}))
    (tmp_path / "latest").write_text("step-00000001")
    got = tck.restore_checkpoint(str(tmp_path),
                                 {"x": torch.empty(4, 6, device="meta")},
                                 device="cpu")
    np.testing.assert_array_equal(got["x"].numpy(), a)
    np.savez(d / "shards-p0.npz", **{"['x']@0,0+2x6": a[:2]})
    with pytest.raises(tck.IncompleteCheckpoint):
        tck.restore_checkpoint(str(tmp_path),
                               {"x": torch.empty(4, 6, device="meta")},
                               step=1, device="cpu")


def test_torn_step_falls_back_and_gc(tmp_path):
    good = {"x": torch.arange(6, dtype=torch.float32)}
    tck.save_checkpoint(str(tmp_path), good, 1)
    tck.save_checkpoint(str(tmp_path),
                        {"x": torch.zeros(6, dtype=torch.float32)}, 2)
    (tmp_path / "step-00000002" / "meta.json").unlink()  # torn save
    (tmp_path / "step-00000003").mkdir()  # a dir with nothing in it
    like = {"x": torch.empty(6, device="meta")}
    got = tck.restore_checkpoint(str(tmp_path), like, device="cpu")
    assert torch.equal(got["x"], good["x"])
    assert (tmp_path / "step-00000002").exists()
    with pytest.raises(tck.IncompleteCheckpoint):
        tck.restore_checkpoint(str(tmp_path), like, step=2, device="cpu")
    got = tck.restore_checkpoint(str(tmp_path), like, gc_torn=True,
                                 device="cpu")
    assert torch.equal(got["x"], good["x"])
    assert not (tmp_path / "step-00000002").exists()
    assert not (tmp_path / "step-00000003").exists()
    # the reference agrees on the fallback
    jgot = jck.restore_checkpoint(str(tmp_path), {"x": jnp.zeros(6)})
    np.testing.assert_array_equal(np.asarray(jgot["x"]), good["x"].numpy())
    assert tck.restore_checkpoint(str(tmp_path / "none"), like) is None


def test_leaf_fn_maps_each_leaf_as_it_lands(tmp_path):
    """The serving restore quantizes each leaf as it lands: the result
    equals quantize_params over the restored float tree."""
    jp = _jax_params("tiny")
    jck.save_checkpoint(str(tmp_path), {"params": jp}, 1)
    like = {"params": tl.param_like(tl.preset("tiny"))}
    q = tck.restore_checkpoint(str(tmp_path), like, device="cpu",
                               leaf_fn=tl.quantize_leaf_at)["params"]
    f = tck.restore_checkpoint(str(tmp_path), like, device="cpu")["params"]
    want = tl.quantize_params(f, tl.preset("tiny"))
    for key in ("embed", "lm_head"):
        assert torch.equal(q[key]["q8"], want[key]["q8"])
        assert torch.equal(q[key]["s8"], want[key]["s8"])
    for key in tl._QUANT_KEYS:
        assert torch.equal(q["layers"][key]["q8"], want["layers"][key]["q8"])
    assert torch.equal(q["layers"]["attn_norm"], f["layers"]["attn_norm"])


def test_fingerprint_equals_the_references(tmp_path):
    jp = _jax_params("tiny")
    jck.save_checkpoint(str(tmp_path / "ref"), {"params": jp}, 1)
    tck.save_checkpoint(str(tmp_path / "port"),
                        {"params": _torch_tree(jp, torch.float32)}, 1)
    for d in ("ref", "port"):
        fp = tck.checkpoint_fingerprint(str(tmp_path / d))
        assert len(fp) == 64
        assert fp == jck.checkpoint_fingerprint(str(tmp_path / d))
        assert fp == tck.checkpoint_fingerprint(str(tmp_path / d), step=1)
    assert tck.checkpoint_fingerprint(str(tmp_path / "missing")) == ""
    (tmp_path / "port" / "step-00000001" / "meta.json").unlink()
    assert tck.checkpoint_fingerprint(str(tmp_path / "port")) == "" == \
        jck.checkpoint_fingerprint(str(tmp_path / "port"))


def test_bf16_restore_without_ml_dtypes(tmp_path):
    """A process that never imported ml_dtypes (as on a machine without
    it) restores a JAX bf16 checkpoint through the entries' bits."""
    jp = _jax_params("tiny", jnp.bfloat16)
    jck.save_checkpoint(str(tmp_path), {"params": jp}, 1)
    want = np.asarray(jp["layers"]["wq"].astype(jnp.float32))
    code = (
        "import sys, dataclasses, torch, numpy as np\n"
        "from kubedl_tpu_torch.models import llama as tl\n"
        "from kubedl_tpu_torch.training import checkpoint as ck\n"
        "cfg = dataclasses.replace(tl.preset('tiny'), dtype=torch.bfloat16)\n"
        f"st = ck.restore_checkpoint({str(tmp_path)!r}, "
        "{'params': tl.param_like(cfg)}, device='cpu')\n"
        "w = st['params']['layers']['wq']\n"
        f"np.save({str(tmp_path / 'wq.npy')!r}, w.float().numpy())\n"
        "print('ml_dtypes' in sys.modules, w.dtype)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "torch.bfloat16"]
    np.testing.assert_array_equal(np.load(tmp_path / "wq.npy"), want)


def test_serve_main_restores_a_jax_checkpoint(tmp_path, monkeypatch):
    """serve_main with KUBEDL_MODEL_PATH naming a checkpoint the JAX
    package wrote serves exactly those weights: its greedy stream equals
    an engine's built from the same params carried over in memory."""
    import socket
    import threading
    import time
    import urllib.request

    from kubedl_tpu_torch.serving import server as srv

    jp = _jax_params("tiny")
    jck.save_checkpoint(str(tmp_path), {"params": jp}, 4)
    for name in [k for k in os.environ if k.startswith("KUBEDL_SERVE_")] \
            + ["KUBEDL_MODEL_PATH"]:
        monkeypatch.delenv(name, raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = {"preset": "tiny", "max_batch": 2, "max_seq": 64,
           "kv_block_size": 4, "device": "cpu", "port": port}
    # through monkeypatch, so the process environment is restored after
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG", json.dumps(cfg))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(tmp_path))
    cancel = threading.Event()
    th = threading.Thread(target=srv.serve_main, daemon=True,
                          args=({"_KUBEDL_CANCEL": cancel},))
    th.start()
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  tl.preset("tiny"), "cpu")
    ref = srv.LlamaEngine(preset="tiny", device="cpu", max_batch=2,
                          max_seq=64, kv_block_size=4, params=params)
    prompt = [11, 22, 33, 44, 55]
    try:
        want = ref.generate(prompt, 8)["token_ids"]
        base = f"http://127.0.0.1:{port}"
        for _ in range(400):
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.05)
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"prompt_ids": prompt, "max_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())["token_ids"]
    finally:
        cancel.set()
        th.join(timeout=30)
        ref.close()
    assert not th.is_alive()
    assert got == want
