"""The chaos plan in the port (kubedl_tpu_torch.chaos) and its sites in
the engine, the blob client, the checkpoint writer and train_main,
against the reference on the CPU at tiny sizes.

- every ``chaos.check`` / ``chaos.should_fail`` literal of the reference's
  serving modules (those the port has counterparts of), ``remote/
  client.py``, ``training/checkpoint.py`` and ``training/entry.py`` is
  consulted at the port's counterpart, as many times; the registry is the
  reference's;
- ``plan_from_config`` accepts the reference's drill configs and yields
  the same seeded trace, and rejects what it rejects;
- each serving site keeps the reference's reaction, with the greedy
  streams that complete IDENTICAL to a chain built from the jitted JAX
  model functions (never from the JAX engine, whose greedy streams race:
  ROADMAP Queue C); the metrics agree with ``stats()``;
- ``remote.request`` retries through ``first(2)`` and gives up on
  ``always()``; ``checkpoint.torn`` restores the previous step;
  ``trainer.step_stall`` in latency mode keeps the unarmed run's losses
  within 1e-6 relative, and a fault wedges the loop until the cancel.

Every test that arms a plan disarms it (``with FaultPlan(...)`` or a
``finally``): the plan is a process-wide singleton.
"""

import ast
import json
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kubedl_tpu.chaos as jc  # noqa: E402
from kubedl_tpu_torch import chaos  # noqa: E402
from kubedl_tpu_torch.chaos import plan as tplan  # noqa: E402
from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[5, 9, 13], [7, 3, 3, 11, 2], list(range(3, 23)), [1, 2]]
CHAIN_TOKENS = 40
KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
          kv_block_size=4, kv_blocks=40, kv_attention="blocked")


@pytest.fixture(scope="module")
def ref():
    """(port params, greedy chains of PROMPTS) from the reference's tiny
    init and its jitted model functions."""
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
        while len(out) < CHAIN_TOKENS:
            lg, c = step(c, jnp.asarray([[out[-1]]], jnp.int32))
            out.append(int(jnp.argmax(lg[0])))
        chains.append(out)
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  tl.preset("tiny"), "cpu")
    return params, chains


@pytest.fixture(autouse=True)
def disarmed():
    """No plan leaks into or out of a test."""
    chaos.disarm()
    yield
    chaos.disarm()


# ---- where the sites are ---------------------------------------------------------------

def _sites(path: Path) -> Counter:
    out: Counter = Counter()
    for node in ast.walk(ast.parse(path.read_text())):
        f = getattr(node, "func", None)
        if (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                and f.attr in ("check", "should_fail")
                and isinstance(f.value, ast.Name) and f.value.id == "chaos"
                and node.args and isinstance(node.args[0], ast.Constant)):
            out[(f.attr, node.args[0].value)] += 1
    return out


SITE_FILES = sorted(
    [f"serving/{p.name}"
     for p in (ROOT / "kubedl_tpu_torch" / "serving").glob("*.py")
     if (ROOT / "kubedl_tpu" / "serving" / p.name).exists()]
    + ["remote/client.py", "training/checkpoint.py", "training/entry.py"])


@pytest.mark.parametrize("rel", SITE_FILES)
def test_every_reference_site_is_consulted_by_the_port(rel):
    want = _sites(ROOT / "kubedl_tpu" / rel)
    got = _sites(ROOT / "kubedl_tpu_torch" / rel)
    assert got == want


def test_registry_is_the_reference_s():
    assert tplan.SITES == jc.plan.SITES
    assert chaos.sites() == jc.sites()
    assert sorted(chaos.__all__) == sorted(jc.__all__)
    used = set()
    for path in (ROOT / "kubedl_tpu_torch").rglob("*.py"):
        used |= {site for _, site in _sites(path)}
    assert used <= set(tplan.SITES)
    assert {"serving.dispatch", "serving.canary_dispatch",
            "serving.kv_alloc", "serving.kv_handoff", "serving.chunk_admit",
            "serving.weight_swap", "remote.request", "checkpoint.torn",
            "trainer.step_stall"} <= used


#: the reference's drill configs (its chaos suite's, the rollout drill's
#: canary latency) and a seeded draw over every site
DRILLS = {
    "canary-latency": {"seed": 17, "sites": {"serving.canary_dispatch": [
        {"mode": "latency", "latency_ms": 250.0, "every": 1}]}},
    "modes": {"sites": {
        "serving.dispatch": [{"mode": "nth", "n": 3}],
        "serving.kv_alloc": [{"mode": "first", "k": 2}],
        "node.heartbeat": [{"mode": "prob", "p": 0.5, "k": 4}],
        "store.update": [{"mode": "always"}]}},
    "handoff-prob": {"seed": 7, "sites": {"serving.kv_handoff": [
        {"mode": "prob", "p": 0.25, "k": 400}]}},
    "every-site": {"seed": 23, "sites": {
        site: [{"mode": "prob", "p": 0.3, "k": 30},
               {"mode": "latency", "latency_ms": 1, "every": 4}]
        for site in sorted(jc.plan.SITES)}},
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_plan_from_config_yields_the_reference_trace(name):
    cfg = DRILLS[name]
    ours = chaos.plan_from_config(cfg, sleep=lambda s: None)
    theirs = jc.plan_from_config(cfg, sleep=lambda s: None)
    assert ours.seed == theirs.seed
    rng = np.random.RandomState(0)
    sites = sorted(cfg["sites"])
    for site in rng.choice(sites, size=200):
        assert ours.evaluate(site)[::2] == theirs.evaluate(site)[::2]
    assert ours.trace_tuples() == theirs.trace_tuples()
    assert ours.faults() == theirs.faults()


@pytest.mark.parametrize("bad", [
    {"sites": {"no.such.site": [{"mode": "always"}]}},
    {"sites": {"serving.dispatch": [{"mode": "sideways"}]}},
])
def test_plan_from_config_rejects_as_the_reference(bad):
    with pytest.raises(ValueError) as ours:
        chaos.plan_from_config(bad)
    with pytest.raises(ValueError) as theirs:
        jc.plan_from_config(bad)
    assert str(ours.value) == str(theirs.value)


# ---- the serving sites' reactions -------------------------------------------------------

def _concurrent(eng, idx, n):
    outs = [None] * len(idx)

    def one(j):
        outs[j] = eng.generate(PROMPTS[idx[j]], max_tokens=n, timeout_s=300)

    ths = [threading.Thread(target=one, args=(j,)) for j in range(len(idx))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ths)
    return outs


def test_kv_alloc_fault_preempts_and_requeues(ref):
    """Armed while two greedy rows decode (speculative rounds harvest
    synchronously, so no row has tokens in flight): the injected
    exhaustion preempts the younger row, which is requeued and
    recomputed; both streams stay the JAX chains', and the preemption
    counter equals stats()."""
    params, chains = ref
    eng = srv.LlamaEngine(**KW, params=params, spec_k=3, spec_draft="repeat",
                          prefix_cache_mb=0.0)
    outs = [None] * 2
    try:
        def one(j):
            outs[j] = eng.generate(PROMPTS[j], max_tokens=CHAIN_TOKENS)

        ths = [threading.Thread(target=one, args=(j,)) for j in range(2)]
        for t in ths:
            t.start()
        deadline = time.time() + 120
        while time.time() < deadline:  # both rows past their prefill
            with eng._cv:
                rows = [s for s in eng._slots if s is not None]
                if len(rows) == 2 and all(
                        s.fed >= len(s.prompt) and len(s.out_ids) < 20
                        for s in rows):
                    chaos.arm(chaos.FaultPlan(5, {
                        "serving.kv_alloc": [chaos.FaultSpec.nth(1)]}))
                    break
            time.sleep(0.001)
        for t in ths:
            t.join(timeout=300)
        plan = chaos.active()
        st = eng.stats()
    finally:
        chaos.disarm()
        eng.close()
    assert plan is not None and plan.faults("serving.kv_alloc") == 1
    assert [o["token_ids"] for o in outs] == chains[:2]
    assert st["kv_preemptions"] >= 1
    assert eng.metrics.kv_preemptions.value() == st["kv_preemptions"]
    assert st["kv_blocks"]["used"] == 0


def test_kv_alloc_fault_under_concurrent_rows(ref):
    """The reference's scenario: one injected failure while three
    requests share two rows of the pipelined engine; every stream the
    chain's, every block back."""
    params, chains = ref
    eng = srv.LlamaEngine(**KW, params=params, prefix_cache_mb=0.0)
    try:
        with chaos.FaultPlan(3, {"serving.kv_alloc": [
                chaos.FaultSpec.nth(1)]}) as plan:
            outs = _concurrent(eng, [0, 3, 1], 12)
        st = eng.stats()
    finally:
        eng.close()
    assert plan.faults("serving.kv_alloc") == 1
    assert [o["token_ids"] for o in outs] == [chains[i][:12]
                                              for i in (0, 3, 1)]
    assert eng.metrics.kv_preemptions.value() == st["kv_preemptions"]
    assert st["kv_blocks"]["used"] == 0


@pytest.mark.parametrize("site,kw", [
    ("serving.dispatch", {}),
    ("serving.chunk_admit", {"prefill_chunk_tokens": 8}),
])
def test_dispatch_faults_fail_in_flight_and_recover(ref, site, kw):
    """An injected dispatch (or chunk dispatch) fault fails the in-flight
    request with the reference's error, resets the pipeline (one
    scheduler error), and the next request is served: the chain's
    stream."""
    params, chains = ref
    eng = srv.LlamaEngine(**KW, **kw, params=params, prefix_cache_mb=0.0)
    try:
        with chaos.FaultPlan(4, {site: [chaos.FaultSpec.nth(1)]}) as plan:
            hit = eng.generate(PROMPTS[2], max_tokens=8)
        ok = eng.generate(PROMPTS[2], max_tokens=8)
        st = eng.stats()
    finally:
        eng.close()
    assert plan.faults(site) == 1
    assert hit == {"error": f"chaos: injected fault at {site} (call #1)"}
    assert ok["token_ids"] == chains[2][:8]
    assert eng.metrics.scheduler_errors.value() == 1
    assert st["pipeline"]["errors"] == 1
    assert st["kv_blocks"]["used"] == 0


def test_weight_swap_fault_keeps_the_old_version(ref, tmp_path):
    """A failed hot load leaves the serving versions untouched; the same
    load then succeeds; an engine whose build faults does not start."""
    from kubedl_tpu_torch.training.checkpoint import save_checkpoint

    params, chains = ref
    save_checkpoint(str(tmp_path), {"params": params}, 1)
    eng = srv.LlamaEngine(**KW, params=params)
    try:
        with chaos.FaultPlan(1, {"serving.weight_swap": [
                chaos.FaultSpec.nth(1)]}) as plan:
            with pytest.raises(chaos.FaultInjected):
                eng.load_version("v2", str(tmp_path))
        assert plan.faults("serving.weight_swap") == 1
        assert eng.versions()["loaded"] == ["base"]
        assert eng.generate(PROMPTS[0], max_tokens=8)["token_ids"] == \
            chains[0][:8]
        eng.load_version("v2", str(tmp_path))
        r = eng.generate(PROMPTS[0], max_tokens=8, model_version="v2")
        assert r["token_ids"] == chains[0][:8] and r["model_version"] == "v2"
    finally:
        eng.close()
    with chaos.FaultPlan(1, {"serving.weight_swap": [chaos.FaultSpec.nth(1)]}):
        with pytest.raises(chaos.FaultInjected):
            srv.LlamaEngine(**KW, ckpt_dir=str(tmp_path))


def test_canary_dispatch_fault_hits_only_canary_ticks(ref, tmp_path):
    from kubedl_tpu_torch.training.checkpoint import save_checkpoint

    params, chains = ref
    save_checkpoint(str(tmp_path), {"params": params}, 1)
    eng = srv.LlamaEngine(**KW, params=params)
    try:
        eng.load_version("v2", str(tmp_path))
        with chaos.FaultPlan(2, {"serving.canary_dispatch": [
                chaos.FaultSpec.always()]}) as plan:
            base = eng.generate(PROMPTS[1], max_tokens=8)
            assert plan.calls("serving.canary_dispatch") == 0
            canary = eng.generate(PROMPTS[1], max_tokens=8,
                                  model_version="v2")
        ok = eng.generate(PROMPTS[1], max_tokens=8, model_version="v2")
    finally:
        eng.close()
    assert base["token_ids"] == chains[1][:8]
    assert canary["error"].startswith(
        "chaos: injected fault at serving.canary_dispatch")
    assert ok["token_ids"] == chains[1][:8]


def test_kv_handoff_faults_on_both_legs(ref):
    """``serving.kv_handoff``: an export fault fails the fetch with a
    HandoffError, an adopt fault returns ``handoff_failed``; every block
    comes home on both pools, and an unfaulted pair serves the chain."""
    from kubedl_tpu_torch.serving.disagg import DisaggCoordinator, HandoffError

    params, chains = ref
    kw = dict(KW, prefix_cache_mb=0.0)
    pre = srv.LlamaEngine(**kw, params=params, role="prefill")
    dec = srv.LlamaEngine(**kw, params=params, role="decode")
    co = DisaggCoordinator(pre, dec)
    try:
        free = [pre.stats()["kv_blocks"]["free"],
                dec.stats()["kv_blocks"]["free"]]
        with chaos.FaultPlan(1, {"serving.kv_handoff": [
                chaos.FaultSpec.nth(1)]}):
            with pytest.raises(HandoffError, match="injected fault"):
                co.generate(PROMPTS[2], max_tokens=8)
        with chaos.FaultPlan(1, {"serving.kv_handoff": [
                chaos.FaultSpec.nth(2)]}) as plan:
            r = co.generate(PROMPTS[2], max_tokens=8)
        assert plan.trace_tuples() == [("serving.kv_handoff", 1, "pass"),
                                       ("serving.kv_handoff", 2, "fault")]
        assert r == {"error": "handoff transfer failed (injected)",
                     "handoff_failed": True}
        ok = co.generate(PROMPTS[2], max_tokens=8)
        sts = [pre.stats(), dec.stats()]
    finally:
        pre.close()
        dec.close()
    assert ok["token_ids"] == chains[2][:8]
    assert [st["kv_blocks"]["free"] for st in sts] == free
    assert sts[0]["handoff_failures"] == 1 and sts[1]["handoff_failures"] == 1
    assert pre.metrics.handoff_total.value(direction="export") == 2
    assert dec.metrics.handoff_total.value(direction="adopt") == 1


# ---- the blob client, the checkpoint writer, the step loop ------------------------------

@pytest.mark.parametrize("spec,ok", [("first2", True), ("always", False)])
def test_remote_request_retries_as_the_reference(tmp_path, spec, ok):
    from kubedl_tpu.remote import RemoteStoreServer
    from kubedl_tpu_torch.remote.client import get_blob, put_blob

    fs = chaos.FaultSpec.first(2) if ok else chaos.FaultSpec.always()
    with RemoteStoreServer(str(tmp_path / "root")) as server:
        put_blob(server.base_url, "m/w.bin", b"weights")
        with chaos.FaultPlan(2, {"remote.request": [fs]}) as plan:
            if ok:
                assert get_blob(server.base_url, "m/w.bin") == b"weights"
            else:
                with pytest.raises(chaos.FaultInjected):
                    get_blob(server.base_url, "m/w.bin")
    assert plan.faults("remote.request") == (2 if ok else 4)
    assert plan.calls("remote.request") == (3 if ok else 4)


def test_checkpoint_torn_restores_the_previous_step(tmp_path):
    """A save that dies between its shards and its manifest leaves the
    previous step the latest; both packages restore step 1."""
    from kubedl_tpu.training import checkpoint as jck
    from kubedl_tpu_torch.training import checkpoint as ck

    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, {"w": torch.arange(8.0)}, 1)
    with chaos.FaultPlan(9, {"checkpoint.torn": [chaos.FaultSpec.nth(1)]}):
        with pytest.raises(chaos.FaultInjected):
            ck.save_checkpoint(d, {"w": torch.arange(8.0) * 2}, 2)
    assert (tmp_path / "ckpt" / "step-00000002").is_dir()
    assert ck.latest_step(d) == jck.latest_step(d) == 1
    got = ck.restore_checkpoint(d, {"w": torch.zeros(8)})
    assert torch.equal(got["w"], torch.arange(8.0))
    theirs = jck.restore_checkpoint(d, {"w": np.zeros(8, np.float32)})
    np.testing.assert_array_equal(np.asarray(theirs["w"]), np.arange(8.0))


@pytest.fixture
def clean_env(monkeypatch):
    from kubedl_tpu_torch.training import entry

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)


STALL_CFG = {"model": "tiny", "steps": 4, "seq_len": 32, "global_batch": 2,
             "device": "cpu", "log_every": 1}


def _losses(summary):
    return [summary["first_loss"]] + [v for _, v in summary["loss_log"]] \
        + [summary["final_loss"]]


def test_step_stall_latency_keeps_the_losses(clean_env, capsys):
    from kubedl_tpu_torch.training import entry

    env = {"KUBEDL_TRAIN_CONFIG": json.dumps(STALL_CFG)}
    assert entry.train_main(env) == 0
    plain = _losses(entry.LAST_SUMMARY)
    slept = []
    with chaos.FaultPlan(3, {"trainer.step_stall": [
            chaos.FaultSpec.latency(5.0, every=1)]},
            sleep=slept.append) as plan:
        assert entry.train_main(env) == 0
    armed = _losses(entry.LAST_SUMMARY)
    assert plan.calls("trainer.step_stall") == 4 and slept == [0.005] * 4
    np.testing.assert_allclose(armed, plain, rtol=1e-6)


def test_step_stall_fault_wedges_until_cancel(clean_env, capsys):
    """A fault wedges the step loop (no exit) until the cancel event is
    set, then train_main exits retryably (137)."""
    from kubedl_tpu_torch.training import entry

    cancel = threading.Event()
    box = {}

    def run():
        try:
            entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(STALL_CFG),
                              "_KUBEDL_CANCEL": cancel})
        except SystemExit as e:
            box["code"] = e.code

    with chaos.FaultPlan(3, {"trainer.step_stall": [
            chaos.FaultSpec.nth(2)]}) as plan:
        th = threading.Thread(target=run, daemon=True)
        th.start()
        deadline = time.time() + 120
        while plan.faults("trainer.step_stall") == 0 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert th.is_alive() and plan.calls("trainer.step_stall") == 2
        cancel.set()
        th.join(timeout=60)
    assert not th.is_alive() and box.get("code") == 137
