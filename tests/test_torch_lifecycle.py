"""The port's training-job lifecycle against the reference's, on the CPU.

- Train-state checkpoints both ways: the port resumes from a step-2
  checkpoint that the JAX ``Trainer.fit(ckpt_dir=...)`` wrote, and the JAX
  trainer resumes from the port's; the next four losses of each resumed
  run match the other package's own continuation within the trainer's
  1e-4 relative (``tiny``, float32: the two step functions round their
  float32 sums differently).
- ``AsyncCheckpointer``: one save in flight, the snapshot taken at save
  time (the step updates the state in place), the writer's error
  re-raised at the barrier, a kill mid-``fit`` leaving a restorable step,
  a peer replica restored by ``restore_from_best`` through the
  reference's blob server.
- ``train_main`` end to end: ``KUBEDL_FAULT_ONCE_AT_STEP`` 3 exits 137
  after the fourth step, before its save, with a complete step-2
  checkpoint; the restart resumes at step 2, runs to step
  6, publishes (to a directory and to a blob root); the port's engine
  serves exactly the published weights; the beacon shows step 6; the
  resumed run's losses and final parameters equal an in-process chain of
  2 steps, save, restore, 4 steps on a fresh iterator (the reference
  restarts the data stream on resume; so does the port) within 1e-6
  relative (losses) and 1e-5 relative + 1e-7 (parameters): on the CPU two
  runs of the same float32 step need not give the same gradient bits
  (seen: the first step's gradient sums 1e-8 relative apart between two
  runs in one process), so the runs drift apart by float32 roundings. On
  the card ``chip_smoke.py`` holds the same identity bit for bit.
- The beacon and the token-file loaders against the reference's.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.training import checkpoint as tck  # noqa: E402
from kubedl_tpu_torch.training import trainer as tt  # noqa: E402
from kubedl_tpu_torch.training.data import SyntheticTokens  # noqa: E402

KW = dict(global_batch=2, seq_len=32, steps=6, warmup_steps=2,
          learning_rate=1e-2, log_every=1)


def _losses(summary):
    """Every step's loss of a ``log_every=1`` fit: the first, the logged
    ones, the final."""
    return [summary["first_loss"]] + [l for _, l in summary["loss_log"]] \
        + [summary["final_loss"]]


def _jax_trainer():
    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    return jt.Trainer(jt.TrainConfig(model=jl.TINY, attn_impl="dense", **KW),
                      mesh)


def _port_trainer(**kw):
    return tt.Trainer(tt.TrainConfig(**dict(KW, **kw)), device="cpu")


def _data():
    return iter(SyntheticTokens(2, 32, tl.TINY.vocab_size, seed=7))


def _keystrs(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---- train-state checkpoints across the packages --------------------------------

def test_train_state_tree_has_the_references_keys():
    jstate = _jax_trainer().init_state()
    state = _port_trainer().init_state()
    mine = [k for k, _ in tck._leaf_items(tck.train_state_tree(state))]
    assert mine == _keystrs(jstate)
    assert "['opt_state'][1][0].count" in mine
    assert "['opt_state'][1][2].count" in mine and "['step']" in mine
    like = tck.train_state_like(state)
    assert all(t.device.type == "meta" for _, t in tck._leaf_items(like)
               if isinstance(t, torch.Tensor))
    back = tck.train_state_from_tree(tck.train_state_tree(state))
    assert back["step"] == 0 and back["opt_state"]["count"] == 0
    assert all(a is b for a, b in zip(back["opt_state"]["mu"],
                                      state["opt_state"]["mu"]))


def test_port_resumes_the_references_checkpoint(tmp_path):
    """The JAX trainer saves step 2 (fit's final save); the port restores
    it and trains steps 3-6 on a fresh stream; the JAX trainer does the
    same from its own checkpoint. Losses within 1e-4 relative."""
    from kubedl_tpu.training import checkpoint as jck

    jtr = _jax_trainer()
    jtr.fit(_data(), steps=2, ckpt_dir=str(tmp_path))
    assert jck.latest_step(str(tmp_path)) == 2
    jstate = jck.restore_checkpoint(str(tmp_path), jtr.init_state())
    _, jsum = jtr.fit(_data(), state=jstate)

    tr = _port_trainer()
    restored = tck.restore_checkpoint(
        str(tmp_path), tck.train_state_like(tr.init_state()), device="cpu")
    state = tck.train_state_from_tree(restored)
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    _, tsum = tr.fit(_data(), state=state)
    assert tsum["start_step"] == 2 and tsum["steps"] == 4
    np.testing.assert_allclose(_losses(tsum), _losses(jsum), rtol=1e-4)


def test_reference_resumes_the_ports_checkpoint(tmp_path):
    from kubedl_tpu.training import checkpoint as jck

    tr = _port_trainer()
    tr.fit(_data(), steps=2, ckpt_dir=str(tmp_path))
    assert tck.latest_step(str(tmp_path)) == 2
    restored = tck.restore_checkpoint(
        str(tmp_path), tck.train_state_like(tr.init_state()), device="cpu")
    _, tsum = tr.fit(_data(), state=tck.train_state_from_tree(restored))

    jtr = _jax_trainer()
    jstate = jck.restore_checkpoint(str(tmp_path), jtr.init_state())
    assert int(jstate["step"]) == 2
    _, jsum = jtr.fit(_data(), state=jstate)
    assert jsum["start_step"] == 2
    np.testing.assert_allclose(_losses(jsum), _losses(tsum), rtol=1e-4)


# ---- AsyncCheckpointer -----------------------------------------------------------

def _small_state():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": np.int32(1)}


def test_async_one_save_in_flight_and_snapshot_at_save(tmp_path,
                                                       monkeypatch):
    real = tck.write_snapshot
    gate = threading.Event()

    def slow(*a, **kw):
        gate.wait(5)
        return real(*a, **kw)

    monkeypatch.setattr(tck, "write_snapshot", slow)
    state = _small_state()
    want = state["params"]["w"].clone()
    acp = tck.AsyncCheckpointer(str(tmp_path))
    acp.save(state, 1)
    state["params"]["w"].add_(100.0)  # the next step, in place
    t = threading.Timer(0.3, gate.set)
    t.start()
    t0 = time.perf_counter()
    acp.save(state, 2)  # waits for the first write: one in flight
    assert time.perf_counter() - t0 >= 0.25
    acp.wait_for_pending()
    assert acp.saves == 2 and acp.stall_seconds >= 0.25
    like = {"params": {"w": torch.empty(3, 4), "b": torch.empty(
        4, dtype=torch.bfloat16)}, "step": np.int32(0)}
    one = tck.restore_checkpoint(str(tmp_path), like, step=1)
    assert torch.equal(one["params"]["w"], want)
    two = tck.restore_checkpoint(str(tmp_path), like, step=2)
    assert torch.equal(two["params"]["w"], want + 100.0)
    assert tck.latest_step(str(tmp_path)) == 2


def test_async_writer_error_is_raised_at_the_barrier(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tck, "write_snapshot", boom)
    acp = tck.AsyncCheckpointer(str(tmp_path))
    acp.save(_small_state(), 1)  # the caller does not see it yet
    with pytest.raises(OSError, match="disk full"):
        acp.wait_for_pending()
    acp.wait_for_pending()  # raised once


def test_kill_mid_fit_leaves_a_restorable_step(tmp_path, monkeypatch):
    """SystemExit after step 3 while step 2's write is still running:
    fit joins the writer before re-raising, so step 2 restores."""
    real = tck.write_snapshot

    def slow(*a, **kw):
        time.sleep(0.3)
        return real(*a, **kw)

    monkeypatch.setattr(tck, "write_snapshot", slow)
    tr = _port_trainer(ckpt_every=2)

    def kill(i, _m):
        if i == 2:
            raise SystemExit(137)

    with pytest.raises(SystemExit):
        tr.fit(_data(), on_step=kill, ckpt_dir=str(tmp_path))
    assert tck.latest_step(str(tmp_path)) == 2
    like = tck.train_state_like(tr.init_state())
    assert tck.restore_checkpoint(str(tmp_path), like)["step"] == 2


def test_fit_checkpoint_summary_and_final_save(tmp_path):
    """Saves at 2 and 4 and a final one at 5 (the state's real step); the
    async summary keys; no save when nothing is left to train."""
    tr = _port_trainer(ckpt_every=2, steps=5)
    state, s = tr.fit(_data(), ckpt_dir=str(tmp_path))
    assert s["ckpt_async"] is True and s["ckpt_saves"] == 3
    assert s["ckpt_stall_s"] >= 0.0
    assert sorted(os.listdir(tmp_path)) == [
        "latest", "step-00000002", "step-00000004", "step-00000005"]
    _, s2 = tr.fit(_data(), state=state, ckpt_dir=str(tmp_path))
    assert s2["steps"] == 0 and s2["ckpt_saves"] == 0
    sync = _port_trainer(ckpt_every=2, steps=4, ckpt_async=False)
    _, s3 = sync.fit(_data(), ckpt_dir=str(tmp_path / "sync"))
    assert s3["ckpt_async"] is False and "ckpt_saves" not in s3
    assert sorted(os.listdir(tmp_path / "sync")) == [
        "latest", "step-00000002", "step-00000004"]


def test_restore_from_best_pulls_the_peer_replica(tmp_path):
    from kubedl_tpu.remote import RemoteStoreServer, list_blobs

    tr = _port_trainer(steps=2)
    state, _ = tr.fit(_data())
    local = tmp_path / "ck"
    with RemoteStoreServer(str(tmp_path / "peer-root")) as srv:
        peer = f"{srv.base_url}/blobs/replicas/w0"
        with tck.AsyncCheckpointer(str(local), peer_url=peer) as acp:
            acp.save(tck.train_state_tree(state), 2)
        assert acp.peer_pushes == 1
        blobs = list_blobs(srv.base_url, "replicas/w0")
        assert any(b.endswith("latest") for b in blobs)
        assert any("step-00000002/shards-p0" in b for b in blobs)
        shutil.rmtree(local)
        like = tck.train_state_like(state)
        restored = tck.restore_from_best(str(local), like, sources=[peer],
                                         device="cpu")
    assert restored is not None
    back = tck.train_state_from_tree(restored)
    assert back["step"] == 2
    for a, b in zip(tt.tree_leaves(back["params"]),
                    tt.tree_leaves(state["params"])):
        assert torch.equal(a, b)
    # local first: an intact dir never touches the (unreachable) source
    again = tck.restore_from_best(str(local), like, device="cpu",
                                  sources=["http://127.0.0.1:1/blobs/x"])
    assert again is not None
    assert tck.restore_from_best(str(tmp_path / "none"), like, device="cpu",
                                 sources=["http://127.0.0.1:1/blobs/x"]) \
        is None


# ---- train_main end to end ---------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    """train_main / serve_main read the process environment: clear every
    name an earlier in-process entry (of either package) may have left."""
    from kubedl_tpu_torch.training import entry

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)
    for name in [k for k in os.environ if k.startswith("KUBEDL_SERVE_")]:
        monkeypatch.delenv(name, raising=False)


def _token_file(path, n=20000, vocab=256, dtype=np.int32, seed=0):
    np.random.default_rng(seed).integers(0, vocab, n).astype(dtype).tofile(
        path)
    return str(path)


class _Capture:
    """Records every fit's returned state and each step's loss."""

    def __init__(self, monkeypatch):
        self.states, self.losses = [], []
        real_fit, real_step = tt.Trainer.fit, tt.Trainer.train_step
        cap = self

        def fit(self, *a, **kw):
            state, s = real_fit(self, *a, **kw)
            cap.states.append(state)
            return state, s

        def step(self, state, batch):
            state, m = real_step(self, state, batch)
            cap.losses.append(m["loss"].clone())
            return state, m

        monkeypatch.setattr(tt.Trainer, "fit", fit)
        monkeypatch.setattr(tt.Trainer, "train_step", step)


CFG = {"model": "tiny", "steps": 6, "seq_len": 32, "global_batch": 2,
       "device": "cpu", "ckpt_every": 2, "token_bytes": 4,
       "learning_rate": 1e-2}


def _job_env(tmp_path, out):
    cfg = dict(CFG, data_path=_token_file(tmp_path / "tokens.bin"))
    return {"KUBEDL_TRAIN_CONFIG": json.dumps(cfg),
            "KUBEDL_MODEL_PATH": out,
            "KUBEDL_FAULT_ONCE_AT_STEP": "3",
            "KUBEDL_FAULT_MARKER": str(tmp_path / "fault-marker"),
            "KUBEDL_BEACON_FILE": str(tmp_path / "beacon" / "w0.json"),
            "KUBEDL_BEACON_INTERVAL": "0.05"}


def test_train_main_fault_resume_publish_serve(tmp_path, clean_env, capsys,
                                               monkeypatch):
    from kubedl_tpu_torch.serving.server import LlamaEngine
    from kubedl_tpu_torch.training import entry
    from kubedl_tpu_torch.watchdog.beacon import read_beacon

    out = str(tmp_path / "model")
    env = _job_env(tmp_path, out)
    cap = _Capture(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        entry.train_main(env)
    assert exc.value.code == 137
    ck = os.path.join(out, "checkpoints")
    assert tck.latest_step(ck) == 2 and tck.checkpoint_fingerprint(ck)
    assert entry.train_main(env) == 0
    lines = capsys.readouterr().out.splitlines()
    assert '{"resumed_from_step": 2}' in lines
    s = entry.LAST_SUMMARY
    assert s["start_step"] == 2 and s["steps"] == 4
    assert s["data_loader"] == "native" and s["ckpt_async"] is True
    assert tck.latest_step(out) == 6 and tck.latest_step(ck) == 6
    assert read_beacon(env["KUBEDL_BEACON_FILE"])["step"] == 6.0
    final = cap.states[-1]
    eng = LlamaEngine(preset="tiny", device="cpu", max_batch=2, max_seq=64,
                      kv_block_size=4, ckpt_dir=out)
    for a, b in zip(tt.tree_leaves(eng.params),
                    tt.tree_leaves(final["params"])):
        assert torch.equal(a, b)

    # the identity: 2 steps, save, restore, 4 steps on a fresh iterator
    from kubedl_tpu_torch.data.native import TokenFileDataset

    cfg = json.loads(env["KUBEDL_TRAIN_CONFIG"])
    # the first run trained four steps (the fault fires after step index 3)
    resumed_losses = [float(x) for x in cap.losses[4:]]
    assert len(resumed_losses) == 4
    tr = tt.Trainer(tt.TrainConfig(
        model=tl.TINY, global_batch=2, seq_len=32, steps=6, ckpt_every=2,
        learning_rate=1e-2), device="cpu")
    data = TokenFileDataset(cfg["data_path"], 2, 32)
    state, _ = tr.fit(iter(data), steps=2, ckpt_dir=str(tmp_path / "chain"))
    data.close()
    restored = tck.restore_checkpoint(
        str(tmp_path / "chain"), tck.train_state_like(state), device="cpu")
    n_before = len(cap.losses)
    data = TokenFileDataset(cfg["data_path"], 2, 32)
    state, _ = tr.fit(iter(data), state=tck.train_state_from_tree(restored))
    data.close()
    np.testing.assert_allclose([float(x) for x in cap.losses[n_before:]],
                               resumed_losses, rtol=1e-6)
    for a, b in zip(tt.tree_leaves(state["params"]),
                    tt.tree_leaves(final["params"])):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def _serve_greedy(monkeypatch, model_path, prompt, max_tokens):
    """``serve_main`` (in a thread, on a free port) with
    ``KUBEDL_MODEL_PATH=model_path``: one greedy request's token ids; the
    replica is stopped through its cancel event."""
    import socket
    import urllib.request

    from kubedl_tpu_torch.serving import server

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG", json.dumps(
        {"preset": "tiny", "max_batch": 2, "max_seq": 64, "kv_block_size": 4,
         "prefix_cache_mb": 0, "device": "cpu", "port": port}))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", model_path)
    cancel = threading.Event()
    th = threading.Thread(target=server.serve_main, daemon=True,
                          args=({"_KUBEDL_CANCEL": cancel},))
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(400):
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.05)
        req = urllib.request.Request(
            base + "/v1/generate", method="POST",
            data=json.dumps({"prompt_ids": prompt, "max_tokens": max_tokens,
                             "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["token_ids"]
    finally:
        cancel.set()
        th.join(timeout=30)
        assert not th.is_alive()


def test_train_main_publishes_to_a_blob_root(tmp_path, clean_env,
                                             monkeypatch):
    """A remote model root: interval saves go to the hashed temporary
    dir, the final state is uploaded through the blob client, and the
    downloaded tree restores to the trained parameters. ``serve_main`` on
    the URL mirrors it into ``<tmp>/kubedl-serve-cache-<uid>/<sha256[:16]>``
    and serves the same greedy stream as on the local copy."""
    import hashlib

    from kubedl_tpu.remote import RemoteStoreServer
    from kubedl_tpu_torch.remote.client import download_tree
    from kubedl_tpu_torch.training import entry

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    cap = _Capture(monkeypatch)
    cfg = dict(CFG, steps=3, ckpt_every=0)
    prompt = [5, 17, 3, 99, 42, 7, 1, 250]
    with RemoteStoreServer(str(tmp_path / "blobs")) as srv:
        root = f"{srv.base_url}/blobs/models/m1"
        assert entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg),
                                 "KUBEDL_MODEL_PATH": root}) == 0
        n = download_tree(root, str(tmp_path / "pulled"))
        remote_stream = _serve_greedy(monkeypatch, root, prompt, 8)
    local_stream = _serve_greedy(monkeypatch, str(tmp_path / "pulled"),
                                 prompt, 8)
    assert len(remote_stream) == 8 and remote_stream == local_stream
    cache = tmp_path / "tmp" / f"kubedl-serve-cache-{os.getuid()}" / \
        hashlib.sha256(root.encode()).hexdigest()[:16]
    assert sorted(p.name for p in cache.iterdir()) == \
        sorted(p.name for p in (tmp_path / "pulled").iterdir())
    assert n == 3  # latest, meta.json, shards-p0.npz
    assert entry.LAST_SUMMARY["data_loader"] == "synthetic"
    final = cap.states[-1]
    got = tck.restore_checkpoint(str(tmp_path / "pulled"),
                                 tck.train_state_like(final), device="cpu")
    assert int(got["step"]) == 3
    for a, b in zip(tt.tree_leaves(got["params"]),
                    tt.tree_leaves(final["params"])):
        assert torch.equal(a, b)
    assert not os.path.exists("http:")  # no literal URL tree in the cwd


def test_ckpt_dir_resolution(tmp_path):
    from kubedl_tpu_torch.training import entry

    assert entry._ckpt_dir({"KUBEDL_CKPT_DIR": "/c"}, "/m", 2) == "/c"
    assert entry._ckpt_dir({}, "/m", 2) == os.path.join("/m", "checkpoints")
    assert entry._ckpt_dir({}, "/m", 0) == ""
    remote = entry._ckpt_dir({}, "http://h:1/blobs/m", 2)
    assert remote.startswith(os.path.join(
        __import__("tempfile").gettempdir(), "kubedl-ckpt-"))


def test_train_main_resumes_from_the_peer(tmp_path, clean_env):
    """KUBEDL_CKPT_PEER: interval saves push to the peer; with the local
    dir gone the restart pulls the replica and resumes."""
    from kubedl_tpu.remote import RemoteStoreServer
    from kubedl_tpu_torch.training import entry

    cfg = dict(CFG, steps=2, ckpt_every=2)
    local = str(tmp_path / "ck")
    with RemoteStoreServer(str(tmp_path / "peer")) as srv:
        env = {"KUBEDL_TRAIN_CONFIG": json.dumps(cfg),
               "KUBEDL_CKPT_DIR": local,
               "KUBEDL_CKPT_PEER": f"{srv.base_url}/blobs/replicas/w0"}
        assert entry.train_main(env) == 0
        shutil.rmtree(local)
        env["KUBEDL_TRAIN_CONFIG"] = json.dumps(dict(cfg, steps=3))
        assert entry.train_main(env) == 0
    s = entry.LAST_SUMMARY
    assert s["start_step"] == 2 and s["steps"] == 1


# ---- the beacon and the token files ------------------------------------------------

def test_beacon_matches_the_reference(tmp_path):
    from kubedl_tpu.watchdog import beacon as jb
    from kubedl_tpu_torch.watchdog import beacon as tb

    assert tb.beacon_path("/r", "ns", "p") == jb.beacon_path("/r", "ns", "p")
    path = str(tmp_path / "ns" / "p.json")
    clock = iter(range(100, 1000)).__next__
    b = tb.ProgressBeacon(path, interval=0.05, clock=clock).start()
    b.step(3, tokens=96.0)
    time.sleep(0.2)
    b.stop()
    assert tb.read_beacon(path) == jb.read_beacon(path)
    got = tb.read_beacon(path)
    assert got["step"] == 3.0 and got["tokens"] == 96.0 and b.writes >= 2
    assert tb.read_beacon(str(tmp_path / "missing.json")) is None
    (tmp_path / "torn.json").write_text("{\"ste")
    assert tb.read_beacon(str(tmp_path / "torn.json")) is None


@pytest.mark.parametrize("token_bytes", [4, 2])
def test_token_file_loaders_match_the_reference(tmp_path, token_bytes):
    """The port's native loader gives the reference's native batches, and
    its numpy path the reference's numpy batches, for the same seed (one
    fill thread: ``prefetch`` 1)."""
    from kubedl_tpu.data import native as jn
    from kubedl_tpu_torch.data import native as tn

    dtype = np.int32 if token_bytes == 4 else np.uint16
    path = _token_file(tmp_path / "t.bin", n=5000, vocab=60000, dtype=dtype)
    mine = tn.TokenFileDataset(path, 3, 64, seed=5, token_bytes=token_bytes)
    assert mine.kind == "native" and mine.n_tokens == 5000
    ref = jn.NativeTokenLoader(path, 3, 64, seed=5, prefetch=1,
                               token_bytes=token_bytes)
    npy = tn._NumpyTokenLoader(path, 3, 64, seed=5, token_bytes=token_bytes)
    jnpy = jn._NumpyTokenLoader(path, 3, 64, seed=5, token_bytes=token_bytes)
    for _ in range(4):
        a, b = next(mine), ref.next()
        assert a.dtype == np.int32 and a.shape == (3, 64)
        assert np.array_equal(a, b)
        assert np.array_equal(next(npy), jnpy.next())
    mine.close()
    ref.close()
    assert str(tn.BUILD_DIR) in str(tn._lib_path())
    with pytest.raises(FileNotFoundError):
        tn.TokenFileDataset(str(tmp_path / "nope.bin"), 1, 8)


def test_token_file_numpy_path_without_a_compiler(tmp_path, monkeypatch):
    from kubedl_tpu_torch.data import native as tn

    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_lib_tried", False)
    monkeypatch.setattr(tn, "_build_lib", lambda: None)
    path = _token_file(tmp_path / "t.bin", n=500)
    ds = tn.TokenFileDataset(path, 2, 16, seed=1)
    assert ds.kind == "numpy" and next(ds).shape == (2, 16)
