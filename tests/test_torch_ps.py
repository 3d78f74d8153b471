"""The port's parameter-service tier (``kubedl_tpu_torch/ps`` on
``kubedl_tpu_torch/core``) and ``Trainer.fit_ps`` against the reference's,
on the CPU at ``tiny`` sizes.

- Partitioning: ``shard_for`` / ``partition`` give the reference's shards
  for the converted ``tiny`` / ``tiny-moe`` leaf names.
- One op script a case of ``tests/test_ps.py`` runs through both
  packages' ``ParameterService``: every result, exception, snapshot,
  ``stats()`` and ``PSMetrics.render()`` must be equal, arrays bit for bit.
- A shard WAL (and a store WAL of leases) written by either package
  replays in the other.
- Over loopback HTTP each package's ``PSClient`` talks to the other's
  ``PSServer`` (409 / 410 / 503 / a dead server / the admin routes), and
  the two servers answer the same requests with the same bytes.
- ``fit_ps``: 6 steps of ``tiny`` from the reference's params, pushing
  every 2, each package against its own tier: losses within 1e-4
  relative, final params and snapshots within 1e-4, the ``ps_*``
  counters and the summary keys exactly equal.
- ``train_main`` in ``"ps"`` mode: two CPU workers against the port's
  ``PSServer`` through a push drop, a silent-death eviction and a shard
  failover; the tier's snapshot is its init plus the committed weighted
  deltas, bit for bit.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    """The tier's modules of one package, under common names."""
    if name == "ref":
        from kubedl_tpu import chaos
        from kubedl_tpu.core import leases, store, wal
        from kubedl_tpu.observability import metrics
        from kubedl_tpu.ps import server, service, shards
    else:
        from kubedl_tpu_torch import chaos
        from kubedl_tpu_torch.core import leases, store, wal
        from kubedl_tpu_torch.observability import metrics
        from kubedl_tpu_torch.ps import server, service, shards
    return types.SimpleNamespace(
        name=name, chaos=chaos, store=store, wal=wal, leases=leases,
        metrics=metrics, server=server, svc=service, shards=shards)


PKGS = ("ref", "torch")

_rng = np.random.default_rng(21)
INIT = {"w.a": _rng.standard_normal(4).astype(np.float32),
        "w.b": _rng.standard_normal(3).astype(np.float32),
        "w.c": _rng.standard_normal(2).astype(np.float32)}
#: fractional deltas, so that every weighted sum rounds
DELTA = {k: (0.1 * _rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in INIT.items()}


class Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def make_ps(P, num_shards=2, max_staleness=2, clock=None, params=None,
            **kw):
    cfg = P.svc.PSConfig(num_shards=num_shards, max_staleness=max_staleness,
                         **kw)
    return P.svc.ParameterService(
        INIT if params is None else params, cfg, store=P.store.ObjectStore(),
        metrics=P.metrics.PSMetrics(), clock=clock or time.time)


def _res(r):
    return ("push", r.outcome, r.weight, r.staleness, list(r.versions))


def _exc(e):
    return ("exc", type(e).__name__, str(e), getattr(e, "versions", None))


def _final(svc):
    return [("snap", svc.snapshot()), ("versions", svc.versions()),
            ("stats", svc.stats()), ("members", svc.members()),
            ("render", svc.metrics.registry.render())]


def _raises(o, fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:  # noqa: BLE001 — the case records it
        o.append(_exc(e))
        return
    raise AssertionError(f"{fn.__name__} did not raise")


# ---- the op script: one function a case of tests/test_ps.py ---------------------

def case_fresh(P, tmp):
    svc, o = make_ps(P), []
    _, v = svc.register("w0")
    o.append(_res(svc.push("w0", 1, DELTA, versions=v)))
    return o + _final(svc)


def case_decayed(P, tmp):
    svc, o = make_ps(P, max_staleness=4), []
    _, v0 = svc.register("slow")
    svc.register("fast")
    _, vf = svc.pull("fast")
    vf = svc.push("fast", 1, DELTA, versions=vf).versions
    svc.push("fast", 2, DELTA, versions=vf)
    o.append(_res(svc.push("slow", 1, DELTA, versions=v0)))
    return o + _final(svc)


def case_rejected_then_repull(P, tmp):
    svc, o = make_ps(P, max_staleness=1), []
    _, v0 = svc.register("slow")
    svc.register("fast")
    _, vf = svc.pull("fast")
    for step in range(3):
        vf = svc.push("fast", step, DELTA, versions=vf).versions
    _raises(o, svc.push, "slow", 1, DELTA, versions=v0)
    pulled, v1 = svc.pull("slow")
    o += [("pulled", pulled, v1), _res(svc.push("slow", 2, DELTA, versions=v1))]
    return o + _final(svc)


def case_straggler_decay(P, tmp):
    svc, o = make_ps(P, straggler_decay=0.5), []
    _, v = svc.register("w0")
    svc.mark_straggler("w0", True)
    r = svc.push("w0", 1, DELTA, versions=v)
    svc.mark_straggler("w0", False)
    o += [_res(r), _res(svc.push("w0", 2, DELTA, versions=r.versions))]
    return o + _final(svc)


def case_preemption_commits(P, tmp):
    svc, o = make_ps(P), []
    svc.register("victim")
    svc.stage_push("victim", DELTA, weight=0.75)
    svc.handle_preemption_notice("victim")
    return o + _final(svc)


def case_silent_death_discards(P, tmp):
    class FakeWatchdog:
        def __init__(self):
            self.listeners = []

    svc, o = make_ps(P), []
    svc.register("zombie")
    svc.register("w1")
    svc.stage_push("zombie", DELTA)
    svc.evict_silent_death("zombie")
    _raises(o, svc.push, "zombie", 5, DELTA)
    _raises(o, svc.pull, "zombie")
    wd = FakeWatchdog()
    svc.stage_push("w1", DELTA)
    svc.bind_watchdog(wd, worker_for_pod=lambda pod: pod.replace("p", "w"))
    for fn in wd.listeners:
        fn("p1", "silent_death")
    return o + _final(svc)


def case_late_joiner(P, tmp):
    svc, o = make_ps(P), []
    _, v = svc.register("w0")
    svc.push("w0", 1, DELTA, versions=v)
    snap, versions = svc.register("late")
    o.append(("warm", snap, versions))
    return o + _final(svc)


def case_failover_replay(P, tmp):
    t = Clock()
    svc, o = make_ps(P, wal_root=str(tmp), lease_ttl=2.0, clock=t), []
    _, v = svc.register("w0")
    v = svc.push("w0", 1, DELTA, versions=v).versions
    v = svc.push("w0", 2, DELTA, versions=v).versions
    o.append(("fences", [sh.fence for sh in svc.shards]))
    svc.fail_shard(0)
    t.now += 10.0
    o.append(("fence", svc.recover_shard(0)))
    o.append(("fences", [sh.fence for sh in svc.shards]))
    o.append(_res(svc.push("w0", 3, DELTA, versions=v)))
    return o + _final(svc)


def case_deposed_fenced_out(P, tmp):
    t = Clock(0.0)
    sh = P.shards.ShardState(0, P.store.ObjectStore(), wal_dir=str(tmp),
                             lease_ttl=2.0, clock=t)
    o = [("token", sh.open("owner-a"))]
    sh.init_params({"w.a": INIT["w.a"]})
    stale = sh.fence
    sh.kill()
    t.now += 10.0
    o.append(("token", sh.open("owner-b")))
    _raises(o, sh.apply, "w0", 1.0, {"w.a": DELTA["w.a"]}, fence=stale)
    o.append(("applied", sh.apply("w0", 0.5, {"w.a": DELTA["w.a"]},
                                  fence=sh.fence)))
    o.append(("shard", sh.snapshot(), sh.failovers))
    return o


def case_dead_shard_no_autorecover(P, tmp):
    svc, o = make_ps(P, auto_recover=False), []
    svc.register("w0")
    svc.fail_shard(0)
    _raises(o, svc.pull, "w0")
    _raises(o, svc.push, "w0", 1, DELTA)
    _raises(o, svc.snapshot)
    o.append(("stats", svc.stats()))
    return o


def case_push_pull_drop(P, tmp):
    svc, o = make_ps(P), []
    _, v = svc.register("w0")
    FS = P.chaos.FaultSpec
    with P.chaos.FaultPlan(7, sites={"ps.push": [FS.nth(1)],
                                     "ps.pull": [FS.nth(1)]}) as plan:
        _raises(o, svc.push, "w0", 1, DELTA, versions=v)
        o.append(("snap", svc.snapshot()))
        o.append(_res(svc.push("w0", 1, DELTA, versions=v)))
        _raises(o, svc.pull, "w0")
        o.append(("pulled",) + svc.pull("w0"))
    o.append(("trace", plan.trace_tuples()))
    return o + _final(svc)


def case_chaos_failover(P, tmp):
    t = Clock(0.0)
    svc, o = make_ps(P, wal_root=str(tmp), lease_ttl=0.5, clock=t), []
    _, v = svc.register("w0")
    v = svc.push("w0", 1, DELTA, versions=v).versions
    FS = P.chaos.FaultSpec
    with P.chaos.FaultPlan(3, sites={"ps.shard_failover": [FS.nth(1)]}):
        t.now += 5.0
        o.append(_res(svc.push("w0", 2, DELTA, versions=v)))
    return o + _final(svc)


CASES = {f.__name__[5:]: f for f in (
    case_fresh, case_decayed, case_rejected_then_repull,
    case_straggler_decay, case_preemption_commits,
    case_silent_death_discards, case_late_joiner, case_failover_replay,
    case_deposed_fenced_out, case_dead_shard_no_autorecover,
    case_push_pull_drop, case_chaos_failover)}


def assert_same(a, b, path="$"):
    """Equal structures; numpy arrays equal bit for bit, dtype included."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_tier_op_script_matches_reference(case, tmp_path):
    """The case's ops through both packages: every observation equal,
    arrays bit for bit, ``PSMetrics.render()`` byte for byte."""
    obs = {}
    for name in PKGS:
        d = tmp_path / name
        d.mkdir()
        obs[name] = CASES[case](_pkg(name), d)
    assert_same(obs["ref"], obs["torch"])


def test_metrics_render_byte_identical():
    """A longer script (decays, a rejection, evictions of both kinds, a
    failover) leaves both ``PSMetrics`` rendering the same bytes."""
    out = {}
    for name in PKGS:
        P = _pkg(name)
        svc = make_ps(P, max_staleness=3)
        _, v = svc.register("a")
        _, vb = svc.register("b")
        for step in range(4):
            v = svc.push("a", step, DELTA, versions=v).versions
            try:
                svc.push("b", step, DELTA, versions=vb)
            except P.svc.PushRejected as e:
                vb = e.versions
        svc.handle_preemption_notice("b")
        svc.register("c")
        svc.evict_silent_death("c")
        svc.fail_shard(1)
        svc.pull("a")
        out[name] = svc.metrics.registry.render()
    assert "kubedl_tpu_ps_push_staleness_steps_bucket" in out["torch"]
    assert out["ref"] == out["torch"]


# ---- partitioning -----------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_shard_for_matches_reference_on_model_names(preset):
    from kubedl_tpu.ps import shards as js
    from kubedl_tpu_torch.ps import shards as ts
    from kubedl_tpu_torch.training import trainer as tt

    model = tt.family_for(_preset(preset)).name
    tr = tt.Trainer(tt.TrainConfig(model=_preset(preset), global_batch=2,
                                   seq_len=16), device="cpu")
    names = list(tr._host_params(tr.init_state()["params"]))
    assert names and all(n.startswith("['") for n in names), model
    for n in (1, 2, 3, 8):
        assert [ts.shard_for(k, n) for k in names] == \
            [js.shard_for(k, n) for k in names]
        assert ts.partition(names, n) == js.partition(names, n)


def _preset(name):
    from kubedl_tpu_torch.models import llama, moe

    return moe.preset(name) if "moe" in name else llama.preset(name)


# ---- durability both ways --------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("ref", "torch"), ("torch", "ref")])
def test_shard_wal_replays_across_packages(writer, reader, tmp_path):
    """Shards written by one package (an init, pushes, a snapshot-and-
    truncate compaction) recover in the other to the same params and
    version; a push applied there replays back in the writer's."""
    W, R = _pkg(writer), _pkg(reader)
    svc = make_ps(W, wal_root=str(tmp_path), fsync="off")
    for sh in svc.shards:
        sh._wal.snapshot_every = 2  # exercise snapshot + truncate too
    _, v = svc.register("w0")
    for step in range(3):
        v = svc.push("w0", step, DELTA, versions=v).versions
    want = [(sh.version, sh.params) for sh in svc.shards]
    for i, (version, params) in enumerate(want):
        sh = R.shards.ShardState(i, R.store.ObjectStore(),
                                 wal_dir=str(tmp_path), fsync="off")
        sh.open("reader")
        assert sh.version == version
        assert_same(sh.params, params)
        sh.apply("w1", 0.5, {k: DELTA[k] for k in params}, fence=sh.fence)
        got = (sh.version, {k: a.copy() for k, a in sh.params.items()})
        sh.kill()
        back = W.shards.ShardState(i, W.store.ObjectStore(),
                                   wal_dir=str(tmp_path), fsync="off")
        back.open("writer-again")
        assert back.version == got[0]
        assert_same(back.params, got[1])
        back.kill()


@pytest.mark.parametrize("writer,reader", [("ref", "torch"), ("torch", "ref")])
def test_store_wal_of_leases_replays_across_packages(writer, reader,
                                                     tmp_path):
    W, R = _pkg(writer), _pkg(reader)
    st = W.store.ObjectStore(wal_dir=str(tmp_path))
    lease = W.leases.Lease(holder="a", renewed_at=5.0, transitions=2)
    lease.metadata.name = "ps-shard-0"
    lease.metadata.namespace = W.leases.LEASE_NAMESPACE
    st.create(lease)
    st.update_with_retry("Lease", "ps-shard-0", W.leases.LEASE_NAMESPACE,
                         lambda o: setattr(o, "transitions", 3))
    st.close()
    back = R.store.ObjectStore(wal_dir=str(tmp_path))
    got = back.get("Lease", "ps-shard-0", R.leases.LEASE_NAMESPACE)
    assert type(got).__module__.startswith(
        "kubedl_tpu_torch" if reader == "torch" else "kubedl_tpu.")
    assert (got.holder, got.renewed_at, got.transitions) == ("a", 5.0, 3)
    assert back.revision == 2 and back.replayed_records == 2


# ---- the wire both ways -------------------------------------------------------------

@pytest.mark.parametrize("client,server", [("torch", "ref"), ("ref", "torch")])
def test_client_talks_to_the_other_packages_server(client, server, tmp_path):
    C, S = _pkg(client), _pkg(server)
    t = Clock(0.0)
    svc = make_ps(S, max_staleness=0, wal_root=str(tmp_path),
                  lease_ttl=0.2, clock=t, auto_recover=False)
    with S.server.PSServer(svc) as srv:
        c = C.server.PSClient(srv.addr)
        snap, v = c.register("w0")
        assert_same(snap, svc.snapshot())
        res = c.push("w0", 1, DELTA, versions=v)
        assert isinstance(res, C.svc.PushResult) and res.outcome == "fresh"
        pulled, v2 = c.pull("w0")
        assert_same(pulled, svc.snapshot())
        assert v2 == res.versions == svc.versions()
        # 409 -> PushRejected with the head's versions
        _, vf = c.register("fast")
        c.push("fast", 1, DELTA, versions=vf)
        with pytest.raises(C.svc.PushRejected) as ei:
            c.push("w0", 2, DELTA, versions=v2)
        assert ei.value.versions == svc.versions()
        # 410 -> MemberEvicted
        svc.evict_silent_death("w0")
        with pytest.raises(C.svc.MemberEvicted):
            c.push("w0", 2, DELTA)
        # 503 (a fault injected in the server's process) -> PSUnavailable
        _, v = c.register("w0")
        FS = S.chaos.FaultSpec
        with S.chaos.FaultPlan(7, sites={"ps.push": [FS.nth(1)]}):
            with pytest.raises(C.server.PSUnavailable):
                c.push("w0", 3, DELTA, versions=v)
        assert c.push("w0", 3, DELTA, versions=v).outcome == "fresh"
        # the admin routes: a dead shard is a 503 until recovered
        c._post("/ps/admin", {"op": "fail_shard", "shard": 0})
        with pytest.raises(C.server.PSUnavailable):
            c.pull("w0")
        t.now += 5.0
        assert c._post("/ps/admin", {"op": "recover_shard",
                                     "shard": 0})["fence"] >= 1
        pulled, _ = c.pull("w0")
        assert_same(pulled, svc.snapshot())
        assert c.stats() == json.loads(json.dumps(svc.stats()))
        c.deregister("fast", commit_in_flight=False, reason="departed")
        assert svc.members() == ["w0"]
        addr = srv.addr
    with pytest.raises(C.server.PSUnavailable):
        C.server.PSClient(addr, timeout=0.5).register("w0")


def _post_raw(addr, path, body):
    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_servers_answer_with_the_same_bytes(tmp_path):
    """The same requests to both packages' servers over the same state:
    the same status codes and response bodies, byte for byte."""
    wire = {k: v.tolist() for k, v in DELTA.items()}
    script = [("/ps/register", {"worker": "w0"}),
              ("/ps/register", {"worker": "w1"}),
              ("/ps/push", {"worker": "w0", "step": 1, "deltas": wire,
                            "versions": [0, 0]}),
              ("/ps/push", {"worker": "w1", "step": 1, "deltas": wire,
                            "versions": [0, 0]}),
              ("/ps/push", {"worker": "w1", "step": 2, "deltas": wire}),
              ("/ps/pull", {"worker": "w1"}),
              ("/ps/deregister", {"worker": "w1", "commit": False,
                                  "reason": "silent_death"}),
              ("/ps/push", {"worker": "w1", "step": 3, "deltas": wire}),
              ("/ps/admin", {"op": "fail_shard", "shard": 1}),
              ("/ps/admin", {"op": "bogus"}),
              ("/ps/nowhere", {})]
    answers = {}
    for name in PKGS:
        P = _pkg(name)
        svc = make_ps(P, max_staleness=1, auto_recover=False)
        with P.server.PSServer(svc) as srv:
            answers[name] = [_post_raw(srv.addr, p, b) for p, b in script]
            with urllib.request.urlopen(f"http://{srv.addr}/ps/stats") as r:
                answers[name].append((r.status, r.read()))
    assert [a[0] for a in answers["torch"]][:4] == [200, 200, 200, 200]
    assert {a[0] for a in answers["torch"]} >= {200, 409, 410, 500}
    assert answers["ref"] == answers["torch"]


# ---- fit_ps against the reference's ---------------------------------------------------

def _jax_trainer(kw):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    return jt.Trainer(jt.TrainConfig(model=jl.TINY, attn_impl="dense", **kw),
                      mesh)


class RacingPS:
    """Duck-typed wrapper (``tests/test_ps.py``'s): a rival member
    advances the head just before every push of the worker, so that at
    ``max_staleness=0`` each of them is rejected."""

    def __init__(self, svc, rival_delta):
        self.svc, self.rival_delta = svc, rival_delta
        _, self.v = svc.register("rival")

    def register(self, w):
        return self.svc.register(w)

    def pull(self, w):
        return self.svc.pull(w)

    def push(self, w, step, deltas, versions=None):
        self.v = self.svc.push("rival", step, self.rival_delta,
                               versions=self.v).versions
        return self.svc.push(w, step, deltas, versions=versions)

    def deregister(self, *a, **k):
        return self.svc.deregister(*a, **k)


FIT_CASES = ("plain", "push_drop", "rejected", "evicted")


@pytest.mark.parametrize("case", FIT_CASES)
def test_fit_ps_matches_reference(case):
    import jax

    from kubedl_tpu.training.data import SyntheticTokens
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.training import trainer as tt

    kw = dict(global_batch=4, seq_len=16, steps=6, warmup_steps=2,
              learning_rate=1e-2)
    jtr = _jax_trainer(kw)
    jstate = jtr.init_state()
    ttr = tt.Trainer(tt.TrainConfig(model=tl.TINY, attn_impl="dense", **kw),
                     device="cpu")
    tstate = ttr.init_state()
    tstate["params"] = tl.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), tl.TINY, "cpu")
    tstate["opt_state"] = ttr.tx.init(tt.tree_leaves(tstate["params"]))
    runs = {}
    for name, tr, state in (("ref", jtr, jstate), ("torch", ttr, tstate)):
        P = _pkg(name)
        init = tr._host_params(state["params"])
        svc = make_ps(P, max_staleness=0 if case == "rejected" else 4,
                      params=init)
        ps = svc
        if case == "rejected":
            ps = RacingPS(svc, {k: np.full_like(a, 0.01)
                                for k, a in init.items()})
        losses = []

        def on_step(i, m, svc=svc):
            losses.append(float(m["loss"]))
            if case == "evicted" and i == 2:  # between pushes 1 and 2
                svc.evict_silent_death("w0")

        FS = P.chaos.FaultSpec
        plan = P.chaos.FaultPlan(5, sites={"ps.push": [FS.nth(2)]}
                                 if case == "push_drop" else {})
        with plan:
            state, summary = tr.fit_ps(
                iter(SyntheticTokens(4, 16, tl.TINY.vocab_size, seed=7)),
                ps, "w0", state=state, on_step=on_step, push_every=2)
        runs[name] = (losses, tr._host_params(state["params"]),
                      svc.snapshot(), summary)
    (jl, jp, js, jsum), (tl_, tp, ts, tsum) = runs["ref"], runs["torch"]
    assert len(jl) == len(tl_) == 6
    for a, b in zip(tl_, jl):
        assert abs(a - b) <= 1e-4 * abs(b), (tl_, jl)
    assert list(tp) == list(jp) and list(ts) == list(js)
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 1e-4, k
        assert np.abs(ts[k] - js[k]).max() <= 1e-4, k
    assert sorted(tsum) == sorted(jsum)
    keys = [k for k in jsum if k.startswith("ps_")]
    assert len(keys) == 7
    assert {k: tsum[k] for k in keys} == {k: jsum[k] for k in keys}
    assert tsum["train_mode"] == "ps" and tsum["steps"] == 6
    want = {"plain": ("ps_pushes", 3), "push_drop": ("ps_dropped", 1),
            "rejected": ("ps_rejected", 3), "evicted": ("ps_rejoins", 1)}
    k, n = want[case]
    assert tsum[k] == n, tsum


def test_fit_ps_pinned_slots_do_not_alias():
    """``_host_params`` with a slot on the CPU returns copies that later
    steps do not change (on CUDA: views of the slot's pinned buffers,
    which fit_ps alternates so that the anchor is never overwritten)."""
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.training import trainer as tt
    from kubedl_tpu_torch.training.data import SyntheticTokens

    tr = tt.Trainer(tt.TrainConfig(model=tl.TINY, global_batch=2, seq_len=16,
                                   steps=2), device="cpu")
    state = tr.init_state()
    before = tr._host_params(state["params"], 0)
    kept = {k: a.copy() for k, a in before.items()}
    data = SyntheticTokens(2, 16, 256)
    for _ in range(2):  # the first step's learning rate is 0
        state, _ = tr.train_step(state, next(data))
    assert all(np.array_equal(before[k], kept[k]) for k in kept)
    after = tr._host_params(state["params"], 0)
    assert any(not np.array_equal(after[k], kept[k]) for k in kept)
    tr._load_params(state["params"], kept)
    again = tr._host_params(state["params"])
    assert all(np.array_equal(again[k], kept[k]) for k in kept)
    assert tr._load_params(state["params"], {}) is state["params"]


# ---- train_main in "ps" mode, two workers ----------------------------------------------

def recording_service(P):
    """A ``ParameterService`` that records every committed push (its
    versions after the commit, its weight, its deltas), and runs
    ``hooks[(worker, n)]`` before the worker's n-th push."""

    class Recording(P.svc.ParameterService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.committed, self.hooks = [], {}
            self._n, self._n_lock = {}, threading.Lock()

        def push(self, worker, step, deltas, versions=None):
            with self._n_lock:
                n = self._n[worker] = self._n.get(worker, 0) + 1
            hook = self.hooks.pop((worker, n), None)
            if hook is not None:
                hook()
            res = super().push(worker, step, deltas, versions=versions)
            with self._n_lock:
                self.committed.append((list(res.versions), res.weight,
                                       deltas))
            return res

    return Recording


def conserved(init, svc, num_shards):
    """The tier's snapshot against its init plus every committed weighted
    delta, each shard's in its version order (float32, the tier's own
    expression): equal bit for bit, or the first key that differs."""
    from kubedl_tpu_torch.ps.shards import shard_for

    want = {k: v.astype(np.float32).copy() for k, v in init.items()}
    for s in range(num_shards):
        for _, w, deltas in sorted(svc.committed, key=lambda c: c[0][s]):
            for k, d in deltas.items():
                if shard_for(k, num_shards) == s:
                    want[k] = want[k] + w * np.asarray(d, np.float32)
    snap = svc.snapshot()
    for k in want:
        if want[k].tobytes() != snap[k].tobytes():
            return k
    return None


def test_train_main_ps_two_workers_conserve(tmp_path):
    """Two ``train_main`` workers (CPU) against the port's ``PSServer``
    with a WAL: a seeded ``ps.push`` fault in the tier (a 503, so a drop),
    worker-1 evicted as silently dead at its 2nd push, and shard 0 failed
    through ``/ps/admin`` at worker-0's 3rd push (the next op fails it
    over: fence bump, WAL replay). Both finish every step; worker-1
    rejoins once; the snapshot is the init plus the committed deltas."""
    from kubedl_tpu_torch import chaos
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.observability.metrics import PSMetrics
    from kubedl_tpu_torch.ps import service, server
    from kubedl_tpu_torch.core.store import ObjectStore
    from kubedl_tpu_torch.training import trainer as tt

    steps, every = 12, 2
    cfg = {"model": "tiny", "global_batch": 4, "seq_len": 16, "steps": steps,
           "learning_rate": 3e-3, "train_mode": "ps", "device": "cpu"}
    tr = tt.Trainer(tt.TrainConfig(model=tl.TINY, global_batch=4, seq_len=16,
                                   steps=steps), device="cpu")
    init = tr._host_params(tr.init_state()["params"])
    Recording = recording_service(_pkg("torch"))
    svc = Recording(init, service.PSConfig(
        num_shards=2, max_staleness=4, wal_root=str(tmp_path / "wal"),
        fsync="off", lease_ttl=0.5), store=ObjectStore(), metrics=PSMetrics())
    plan = chaos.FaultPlan(21, {"ps.push": [chaos.FaultSpec.nth(5)]})
    with server.PSServer(svc) as srv:
        svc.hooks[("worker-1", 2)] = lambda: svc.evict_silent_death(
            "worker-1")
        svc.hooks[("worker-0", 3)] = lambda: server.PSClient(srv.addr)._post(
            "/ps/admin", {"op": "fail_shard", "shard": 0})
        env = dict(os.environ, PYTHONPATH=ROOT,
                   KUBEDL_TRAIN_CONFIG=json.dumps(cfg),
                   KUBEDL_PS_ADDR=srv.addr,
                   KUBEDL_PS_PUSH_EVERY=str(every))
        env.pop("KUBEDL_NUM_PROCESSES", None)
        chaos.arm(plan)
        procs = []
        try:
            for i in range(2):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "kubedl_tpu_torch.training.entry"],
                    env=dict(env, KUBEDL_PROCESS_ID=str(i),
                             KUBEDL_BEACON_FILE=str(tmp_path / f"b{i}")),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            chaos.disarm()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert [p.returncode for p in procs] == [0, 0], outs
        summaries = [json.loads(ln)["worker_summary"] for o in outs
                     for ln in o.splitlines() if '"worker_summary"' in ln]
        assert len(summaries) == 2, outs
        assert all(s["train_mode"] == "ps" and s["steps"] == steps
                   and np.isfinite(s["final_loss"]) for s in summaries)
        assert summaries[1]["ps_rejoins"] == 1
        assert sum(s["ps_dropped"] for s in summaries) == \
            plan.faults("ps.push") == 1
        assert svc.metrics.ps_evictions.value(reason="silent_death") == 1
        assert svc.stats()["failovers"] >= 1
        assert svc.shards[0].fence >= 1
        assert len(svc.committed) == sum(s["ps_pushes"] for s in summaries)
        assert conserved(init, svc, 2) is None
