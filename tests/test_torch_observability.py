"""The engine's observability in the port (kubedl_tpu_torch.observability
and the sites of kubedl_tpu_torch/serving) against the reference, on the
CPU at tiny sizes.

- ``ServingMetrics.render()`` is byte-identical to the reference's, empty
  and after one scripted sequence of calls (labels, exemplars, callbacks);
- every ``ServingMetrics`` family the reference's serving modules touch
  is touched by the port's, with the same method and label keys (an AST
  scan), and the span names emitted are the same both ways. The scan
  covers the serving modules the port has counterparts of: the router,
  controller and rollout are the control plane's, which stays the
  reference's;
- a traced request's span tree holds the catalog's engine spans
  (``docs/observability.md``) with their attributes, parented under the
  request span, inside the request's wall time: whole and chunked
  prefill, speculation, and a disaggregated pair (both legs one trace);
- ``/metrics`` and ``/v1/trace`` through ``serve_main``, the counters
  agreeing with ``/v1/stats``;
- the unchanged reference ``ServingRouter`` carries a ``debug.trace``
  request through a port replica, and its merged tree holds the port's
  ``engine.*`` spans under its ``router.forward``.
"""

import ast
import json
import re
import socket
import threading
import time
import urllib.request
from collections import Counter
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu.observability import metrics as jm  # noqa: E402
from kubedl_tpu.observability import tracing as jt  # noqa: E402
from kubedl_tpu_torch.observability import metrics as tm  # noqa: E402
from kubedl_tpu_torch.observability import tracing as tt  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_SERVING = ROOT / "kubedl_tpu" / "serving"
PORT_SERVING = ROOT / "kubedl_tpu_torch" / "serving"
#: the reference's serving modules the port has a counterpart of
SERVING_FILES = sorted(p.name for p in PORT_SERVING.glob("*.py")
                       if (REF_SERVING / p.name).exists())
#: the engine spans of the catalog's table: name -> attribute keys
ENGINE_KW = dict(preset="tiny", device="cpu", max_batch=2, max_seq=64,
                 kv_block_size=4, kv_blocks=40)
PROMPT = list(range(3, 23))


def _catalog():
    """``{name: set of attr keys}`` of the engine rows of the span
    catalog in docs/observability.md."""
    out = {}
    for line in (ROOT / "docs" / "observability.md").read_text().splitlines():
        m = re.match(r"\| `(engine\.[a-z_]+)` \| engine \| (.*) \|$", line)
        if m:
            out[m.group(1)] = set(re.findall(r"`([a-z_]+)`", m.group(2))) \
                - {"generate", "prefill", "adopt"}
    return out


CATALOG = _catalog()


# ---- the Prometheus family ------------------------------------------------------------

def _script(m, with_exemplar: bool):
    """One scripted sequence over a ServingMetrics: every metric kind,
    labelled and not, a callback gauge and (optionally) exemplars."""
    m.segments.inc(3)
    m.segments.inc()
    m.scheduler_errors.inc()
    m.spec_proposed.inc(4, draft="ngram")
    m.spec_accepted.inc(2, draft="ngram")
    m.spec_proposed.inc(8, draft="zoo:tiny")
    m.handoff_bytes.inc(1024, direction="export")
    m.handoff_total.inc(direction="adopt")
    for v in (0.01, 0.3, 7.0, 900.0):
        m.dispatch_ms.observe(v)
    m.ttft_ms.observe(12.5, exemplar="ab" * 16 if with_exemplar else None)
    m.ttft_ms.observe(40000.0, exemplar="cd" * 16 if with_exemplar else None)
    m.handoff_ms.observe(3.0, direction="adopt")
    m.spec_draft_ms.observe(0.2, draft="ngram")
    m.queue_depth.set(5.0)
    m.overlap_ratio.set(0.25)
    m.kv_blocks_free.set(12.0, attention_kernel="blocked", role="decode")
    m.kv_blocks_total.set(39.0, attention_kernel="gather", role="colocated")
    m.prefix_entries.set_function(lambda: 3.0)
    m.replicas_not_ready.set(1.0)
    m.probe_failures.inc(pod="p-0")


@pytest.mark.parametrize("case", ["empty", "scripted", "exemplars"])
def test_serving_metrics_render_byte_identical(case, monkeypatch):
    """The port's family renders the reference's exposition text byte for
    byte: names, HELP strings, label keys and order, buckets, values."""
    for mod in (jm, tm):  # the exemplar's wall-clock stamp
        monkeypatch.setattr(mod.time, "time", lambda: 1.7e9)
    ours, theirs = tm.ServingMetrics(), jm.ServingMetrics()
    if case != "empty":
        for m in (ours, theirs):
            _script(m, case == "exemplars")
    assert ours.registry.render() == theirs.registry.render()
    assert [type(x).__name__ for x in ours.registry._metrics] == \
        [type(x).__name__ for x in theirs.registry._metrics]
    for name in vars(theirs):
        if name == "registry":
            continue
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.snapshot() == b.snapshot(), name


def _family_uses(path: Path, family) -> Counter:
    """``Counter[(metric, method, label keys)]`` of the calls on a
    ServingMetrics attribute in ``path``; ``**kw`` labels resolve through
    a dict literal bound to ``kw`` in the same function."""
    tree = ast.parse(path.read_text())
    uses: Counter = Counter()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        dicts = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Dict)):
                dicts[node.targets[0].id] = [
                    k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)]
        for node in ast.walk(fn):
            f = getattr(node, "func", None)
            if not (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                    and f.attr in ("inc", "observe", "set", "set_function")
                    and isinstance(f.value, ast.Attribute)
                    and f.value.attr in family):
                continue
            labels = set()
            for kw in node.keywords:
                if kw.arg is None:
                    labels |= set(dicts[kw.value.id])
                elif kw.arg != "exemplar":
                    labels.add(kw.arg)
            uses[(f.value.attr, f.attr, tuple(sorted(labels)))] += 1
    return uses


def test_engine_touches_every_reference_metric():
    family = {k for k in vars(jm.ServingMetrics()) if k != "registry"}
    ref, port = Counter(), Counter()
    for name in SERVING_FILES:
        ref.update(_family_uses(REF_SERVING / name, family))
        port.update(_family_uses(PORT_SERVING / name, family))
    assert set(ref) == set(port), (set(ref) ^ set(port))
    # the whole family of the engine's sites: not a subset of it
    assert {m for m, _, _ in port} >= family - {
        "probe_failures", "replicas_not_ready"}  # the controller's


def _span_names(path: Path) -> Counter:
    tree = ast.parse(path.read_text())
    out: Counter = Counter()
    for node in ast.walk(tree):
        f = getattr(node, "func", None)
        if (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                and f.attr in ("record", "span", "begin")
                and isinstance(f.value, ast.Name) and f.value.id == "TRACER"
                and node.args and isinstance(node.args[0], ast.Constant)):
            out[node.args[0].value] += 1
    return out


def test_span_names_match_reference_both_ways():
    ref, port = Counter(), Counter()
    for name in SERVING_FILES:
        ref.update(_span_names(REF_SERVING / name))
        port.update(_span_names(PORT_SERVING / name))
    assert set(ref) == set(port) == set(CATALOG)
    assert ref == port  # and at as many sites


# ---- the tracer -------------------------------------------------------------------------

def test_tracer_dump_is_what_tracemerge_reads(tmp_path):
    """The port's Chrome dump, and its header format, are the
    reference's: ``scripts/tracemerge.py`` merges the port's dump beside
    a reference one on one timeline."""
    import importlib.util

    ctx = tt.TraceContext(tt.new_trace_id(), tt.new_span_id())
    assert jt.parse_trace_header(ctx.to_header()) == jt.TraceContext(
        ctx.trace_id, ctx.span_id, True)
    assert tt.parse_trace_header("00-zz-11-01") is None
    assert tt.TRACE_HEADER == jt.TRACE_HEADER == "X-Trace-Context"
    tr, jtr = tt.Tracer(capacity=8), jt.Tracer(capacity=8)
    for t in (tr, jtr):
        with t.span("engine.request", parent=ctx, kind="generate") as a:
            a["tokens"] = 3
        t.record("engine.prefill", start=time.perf_counter(), duration=1e-3,
                 trace=ctx, prompt_len=4)
    assert [tt.span_to_dict(s)["name"] for s in tr.spans()] == \
        [jt.span_to_dict(s)["name"] for s in jtr.spans()]
    tree = tr.span_tree(ctx.trace_id)
    assert [n["name"] for n in tree] == ["engine.request", "engine.prefill"]
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    tr.dump(str(a), pid=2, process_name="port")
    jtr.dump(str(b), pid=1, process_name="ref")
    spec = importlib.util.spec_from_file_location(
        "tracemerge", ROOT / "scripts" / "tracemerge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    merged = mod.merge([a, b], trace_id=ctx.trace_id)
    names = [e["name"] for e in merged["traceEvents"] if e["ph"] == "X"]
    assert sorted(names) == sorted(["engine.request", "engine.prefill"] * 2)


def test_xprof_trace_writes_a_chrome_trace(tmp_path):
    """``xprof_trace`` on ``torch.profiler``: a Chrome trace under logdir."""
    with tt.xprof_trace(str(tmp_path / "prof")):
        torch.ones(4) @ torch.ones(4)
    files = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())
    with tt.xprof_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# ---- a traced request's tree ------------------------------------------------------------

def _flatten(nodes):
    for n in nodes:
        yield n
        yield from _flatten(n["children"])


def _check_request_tree(roots, kind, want, parent=""):
    """One engine.request root (under ``parent``), every other span its
    child, each with the catalog's attributes, inside its wall time."""
    req = [n for n in roots if n["name"] == "engine.request"
           and n["attrs"]["kind"] == kind]
    assert len(req) == 1, [n["name"] for n in roots]
    req = req[0]
    assert req["parent_id"] == parent
    assert set(req["attrs"]) == CATALOG["engine.request"]
    # a later leg's request (the adopt under the prefill) is checked alone
    kids = [c for c in req["children"] if c["name"] != "engine.request"]
    names = Counter(c["name"] for c in kids)
    assert set(names) == set(want), names
    t0, t1 = req["ts"], req["ts"] + req["duration_ms"] / 1e3
    for c in kids:
        assert c["parent_id"] == req["span_id"] and not c["children"]
        assert set(c["attrs"]) == CATALOG[c["name"]], c
        end = c["ts"] + c["duration_ms"] / 1e3
        assert t0 - 1e-6 <= c["ts"] <= end, c
        # the export runs at the fetch, after the prefill request closed
        assert c["name"] == "engine.handoff_export" or end <= t1 + 1e-6, c
    return req, names


@pytest.mark.parametrize("case", ["whole", "chunked", "spec"])
def test_traced_request_tree_matches_catalog(case):
    kw = dict(ENGINE_KW, kv_attention="blocked")
    if case == "chunked":
        kw["prefill_chunk_tokens"] = 8
    if case == "spec":
        kw.update(spec_k=3, spec_draft="repeat")
    caller = tt.TraceContext(tt.new_trace_id(), tt.new_span_id())
    eng = srv.LlamaEngine(**kw)
    try:
        r = eng.generate(PROMPT, max_tokens=9, trace=caller, debug_trace=True)
        plain = eng.generate(PROMPT, max_tokens=9)
        st = eng.stats()
    finally:
        eng.close()
    assert r["token_ids"] == plain["token_ids"]
    assert r["trace_id"] == r["trace"]["trace_id"] == caller.trace_id
    assert "trace_id" not in plain  # untraced requests record nothing
    want = {"engine.queue_wait", "engine.admission", "engine.kv_alloc",
            "engine.prefill",
            "engine.spec_round" if case == "spec" else "engine.decode_segment"}
    req, names = _check_request_tree(r["trace"]["spans"], "generate", want,
                                     parent=caller.span_id)
    assert req["attrs"]["tokens"] == 9
    if case == "spec":
        assert names["engine.spec_round"] >= 1
        rounds = [c for c in req["children"]
                  if c["name"] == "engine.spec_round"]
        assert sum(c["attrs"]["emitted"] for c in rounds) == 8
    else:
        segs = [c for c in req["children"]
                if c["name"] == "engine.decode_segment"]
        assert sum(c["attrs"]["tokens"] for c in segs) == 8
    assert st["pipeline"]["errors"] == 0


def test_disaggregated_legs_join_one_trace():
    """prefill_handoff under a caller's context, the handoff's embedded
    header carrying the prefill request span, adopt_handoff without any
    context of its own: both legs' spans in the caller's one trace, and
    the handoff metrics on both sides equal to the KVH1 payload bytes."""
    from kubedl_tpu_torch.serving.disagg import DisaggCoordinator

    caller = tt.TraceContext(tt.new_trace_id(), tt.new_span_id())
    kw = dict(ENGINE_KW, prefix_cache_mb=0.0)
    pre = srv.LlamaEngine(**kw, role="prefill")
    dec = srv.LlamaEngine(**kw, role="decode")
    try:
        h = pre.prefill_handoff(PROMPT, max_tokens=6, trace=caller)
        assert tt.parse_trace_header(h.trace).trace_id == caller.trace_id
        r = DisaggCoordinator(pre, dec).decode.adopt_handoff(
            type(h).from_bytes(h.to_bytes()), debug_trace=True)
        tree = tt.TRACER.span_tree(caller.trace_id)
        for eng in (pre, dec):
            assert eng.metrics.handoff_total.value(
                direction="export" if eng is pre else "adopt") == 1
        assert pre.metrics.handoff_bytes.value(direction="export") == \
            dec.metrics.handoff_bytes.value(direction="adopt") == h.nbytes
        assert pre.metrics.handoff_ms.summary(direction="export")[0] == 1
    finally:
        pre.close()
        dec.close()
    assert r["trace_id"] == caller.trace_id and len(r["token_ids"]) == 6
    prefill_req, _ = _check_request_tree(
        tree, "prefill",
        {"engine.queue_wait", "engine.admission", "engine.kv_alloc",
         "engine.prefill", "engine.handoff_export"},
        parent=caller.span_id)
    # the adopt leg's request parents under the prefill request's span
    adopt = [n for n in _flatten(tree) if n["name"] == "engine.request"
             and n["attrs"]["kind"] == "adopt"]
    assert len(adopt) == 1
    assert adopt[0]["parent_id"] == prefill_req["span_id"]
    names = {c["name"] for c in adopt[0]["children"]}
    assert {"engine.queue_wait", "engine.admission", "engine.handoff_adopt",
            "engine.decode_segment"} <= names
    exp = [c for c in prefill_req["children"]
           if c["name"] == "engine.handoff_export"][0]
    assert exp["attrs"]["nbytes"] == h.nbytes


# ---- /metrics and /v1/trace through serve_main -----------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.headers, r.read()


def _post(base, path, body, headers=None):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def parse_exposition(text):
    """``{(name, labels): value}`` of Prometheus exposition text."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"([a-zA-Z_:]+)(\{[^}]*\})? (\S+)", line)
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


@pytest.fixture
def served(monkeypatch):
    """serve_main on a free port in a thread (tiny, CPU, paged blocked,
    chunked prefill); yields the base URL, stops it through the cancel
    event."""
    for k in ("KUBEDL_MODEL_PATH", "KUBEDL_SERVE_DEVICE", "KUBEDL_SERVE_ROLE"):
        monkeypatch.delenv(k, raising=False)
    port = _free_port()
    monkeypatch.setenv("KUBEDL_SERVE_CONFIG", json.dumps(dict(
        ENGINE_KW, port=port, kv_attention="blocked",
        prefill_chunk_tokens=8)))
    cancel = threading.Event()
    box = {}

    def run():
        try:
            box["rc"] = srv.serve_main({"_KUBEDL_CANCEL": cancel})
        except BaseException as e:  # surfaced by the health wait
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(600):
        assert "error" not in box, box
        try:
            if _get(base, "/healthz")[0] == 200:
                break
        except OSError:
            time.sleep(0.05)
    try:
        yield base
    finally:
        cancel.set()
        th.join(timeout=60)
        assert not th.is_alive() and box.get("rc") == 0, box


def test_metrics_and_trace_routes_through_serve_main(served):
    base = served
    traced = []
    for j in range(4):
        hdr = {}
        if j % 2 == 0:
            ctx = tt.TraceContext(tt.new_trace_id(), tt.new_span_id())
            hdr[tt.TRACE_HEADER] = ctx.to_header()
            traced.append(ctx)
        body = {"prompt_ids": PROMPT[j:], "max_tokens": 5}
        if j == 3:
            body["debug"] = {"trace": True}
        code, res = _post(base, "/v1/generate", body, hdr)
        assert code == 200 and len(res["token_ids"]) == 5
        if j % 2 == 0:
            assert res["trace_id"] == traced[-1].trace_id
            assert "trace" not in res
        elif j == 3:
            assert res["trace"]["trace_id"] == res["trace_id"]
            _check_request_tree(res["trace"]["spans"], "generate",
                                {"engine.queue_wait", "engine.admission",
                                 "engine.kv_alloc", "engine.prefill",
                                 "engine.decode_segment"})
        else:
            assert "trace_id" not in res
    code, headers, raw = _get(base, "/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    text = raw.decode()
    assert text.startswith("# HELP kubedl_tpu_serving_segments ")
    exp = parse_exposition(text)

    def m(name, labels=()):  # a counter never incremented is not rendered
        return exp.get((name, labels), 0.0)

    _, _, st_raw = _get(base, "/v1/stats")
    st = json.loads(st_raw)
    pipe = st["pipeline"]
    assert m("kubedl_tpu_serving_ttft_ms_count") == st["requests"] == 4
    assert m("kubedl_tpu_serving_queue_wait_ms_count") == 4
    assert m("kubedl_tpu_serving_segments") == pipe["segments"]
    assert m("kubedl_tpu_serving_deferred_harvests") == \
        pipe["deferred_harvests"]
    assert m("kubedl_tpu_serving_pipeline_flushes") == pipe["flushes"]
    assert m("kubedl_tpu_serving_dispatch_ms_count") == pipe["ticks"]
    assert m("kubedl_tpu_serving_admission_chunks") == \
        pipe["prefill_chunks"]
    kern = (("attention_kernel", "blocked"), ("role", "colocated"))
    for key in ("total", "free", "shared"):
        assert m(f"kubedl_tpu_serving_kv_blocks_{key}", kern) == \
            st["kv_blocks"][key]
    pc = st["prefix_cache"]
    assert m("kubedl_tpu_serving_prefix_cache_misses") == pc["misses"]
    assert m("kubedl_tpu_serving_prefix_cache_hits") == pc["hits"]
    # /v1/trace: one trace's spans, and the limit
    for ctx in traced:
        _, _, raw = _get(base, f"/v1/trace?trace_id={ctx.trace_id}")
        out = json.loads(raw)
        assert out["enabled"] is True
        spans = out["spans"]
        assert {s["trace_id"] for s in spans} == {ctx.trace_id}
        req = [s for s in spans if s["name"] == "engine.request"]
        assert len(req) == 1 and req[0]["parent_id"] == ctx.span_id
    _, _, raw = _get(base, "/v1/trace?limit=3")
    assert len(json.loads(raw)["spans"]) == 3


def test_reference_router_flight_records_port_spans():
    """The unchanged reference router carries a ``debug.trace`` request
    through a port replica: its merged tree is router.request ->
    router.forward -> engine.request -> the port's engine spans (pulled
    from the replica's /v1/trace)."""
    from kubedl_tpu.serving.router import ServingRouter

    eng = srv.LlamaEngine(**ENGINE_KW)
    s = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(eng, "tiny"))
    threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        r = ServingRouter([{"name": "rep-0", "host": "127.0.0.1",
                            "port": s.server_port}], hedge_enabled=False)
        code, payload, _ = r.handle_generate(
            {"prompt_ids": PROMPT, "max_tokens": 6,
             "debug": {"trace": True}}, 60_000)
    finally:
        s.shutdown()
        s.server_close()
        eng.close()
    assert code == 200, payload
    roots = payload["trace"]["spans"]
    assert [n["name"] for n in roots] == ["router.request"]
    fwd = [n for n in roots[0]["children"] if n["name"] == "router.forward"]
    assert len(fwd) == 1 and fwd[0]["attrs"]["replica"] == "rep-0"
    req = [n for n in fwd[0]["children"] if n["name"] == "engine.request"]
    assert len(req) == 1
    assert {c["name"] for c in req[0]["children"]} >= {
        "engine.queue_wait", "engine.admission", "engine.kv_alloc",
        "engine.prefill", "engine.decode_segment"}
