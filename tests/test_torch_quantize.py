"""Weight-only int8 serving in the port (``quantize_params``, ``deq``,
``gather_embed``, ``lm_head_of`` and every paged consumer through
``llama._mm`` -> ``ops/w8a16.py``) against the JAX reference on the CPU.

The float parameters are the reference's ``llama_init(PRNGKey(0))``
carried over with ``params_from_numpy``; each package quantizes its own
copy. Tolerances, float32 models throughout:

- ``q8`` bit-equal, ``s8`` equal, ``deq`` and ``gather_embed`` equal
  (the same int8 values and bf16 scales, one bf16 rounding each);
- a float32 consumer of an int8 weight takes the exact product
  ``q8 * s8`` unrounded — through the tied head rounded to bf16 — as the
  compiled reference does (XLA's excess precision drops ``deq``'s bf16
  rounding, except where the dequantized embed is transposed into the
  head): the head matmul equals the jitted reference's within 1e-5;
- paged logits 1e-4 max abs (two layers of float32 matmuls against the
  same weights, summed in two frameworks' orders: ~1e-6), verify hidden
  states 1e-5, greedy ids identical — the JAX functions jitted, as the
  reference engine runs them;
- the int8 engine's greedy streams IDENTICAL to a chain built from the
  JAX model functions over the reference's quantized params (not a JAX
  engine run).

On the card (``cuda`` marker, skipped here) the W8A16 kernel is held
against its plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.ops import w8a16  # noqa: E402
from kubedl_tpu_torch.serving import server as srv  # noqa: E402

LOGIT_TOL = 1e-4
HID_TOL = 1e-5
B, MAX_SEQ, BS = 2, 64, 4
MBK = MAX_SEQ // BS
NB = 1 + B * MBK
PROMPTS = [[5, 9, 13], [7, 3, 3, 11, 2], list(range(3, 23))]
MAX_TOKENS = 10


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.fixture(scope="module", params=["tiny", "tiny-gemma"])
def model(request):
    """(name, jl, jcfg, jq, tcfg, tq, tp): the reference's params, each
    package's int8 copy, and the port's float copy."""
    import jax

    from kubedl_tpu.models import llama as jl

    name = request.param
    jcfg, tcfg = jl.preset(name), tl.preset(name)
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return (name, jl, jcfg, jl.quantize_params(jp, jcfg), tcfg,
            tl.quantize_params(tp, tcfg), tp)


def _leaves(q):
    yield "embed", q["embed"]
    if "lm_head" in q:
        yield "lm_head", q["lm_head"]
    for k in tl._QUANT_KEYS:
        yield k, q["layers"][k]


def test_quantize_params_bit_equal(model):
    import jax.numpy as jnp

    _, jl, _, jq, tcfg, tq, tp = model
    jleaves = dict(_leaves(jq))
    for key, t in _leaves(tq):
        j = jleaves[key]
        assert t["q8"].dtype == torch.int8 and t["s8"].dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(j["q8"]), t["q8"].numpy())
        np.testing.assert_array_equal(
            np.asarray(j["s8"].astype(jnp.float32)), t["s8"].float().numpy())
        np.testing.assert_array_equal(
            np.asarray(jl.deq(j).astype(jnp.float32)),
            tl.deq(t).float().numpy())
    # norms stay float, untouched
    assert torch.equal(tq["layers"]["attn_norm"], tp["layers"]["attn_norm"])
    assert not tl.is_quantized(tq["final_norm"])
    assert tl.params_nbytes(tq) < tl.params_nbytes(tp) // 2


def test_gather_embed_and_lm_head(model):
    import jax.numpy as jnp

    name, jl, jcfg, jq, tcfg, tq, _ = model
    toks = np.random.RandomState(0).randint(0, 256, size=(2, 7))
    want = jl.gather_embed(jq["embed"], jnp.asarray(toks))
    got = tl.gather_embed(tq["embed"], torch.tensor(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  got.float().numpy())
    import jax

    x = np.random.RandomState(1).randn(3, jcfg.dim).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, p: a @ jl.lm_head_of(p, jcfg))(
        jnp.asarray(x), jq))
    head = tl.lm_head_of(tq, tcfg)
    assert tl.is_quantized(head)
    assert bool(head.get("transposed", False)) == tcfg.tie_embeddings
    got = tl._mm(torch.tensor(x), head).numpy()
    assert np.abs(got - want).max() < HID_TOL


def test_w8a16_plain_equals_matmul_on_deq():
    """The plain version, both layouts: h @ deq(w) in h's dtype (the
    tied head's weight through bf16)."""
    rng = np.random.RandomState(2)
    w = torch.tensor(rng.randn(48, 32).astype(np.float32))
    h = torch.tensor(rng.randn(5, 48).astype(np.float32))
    q = tl._quant_leaf(w)
    y = w8a16.w8a16_matmul(h, q["q8"], q["s8"])
    torch.testing.assert_close(y, h @ tl.deq(q, torch.float32), rtol=0,
                               atol=0)
    e = tl._quant_leaf(w.T.contiguous(), axis=-1)  # [N, K], per row
    y = w8a16.w8a16_matmul(h, e["q8"], e["s8"], transposed=True)
    torch.testing.assert_close(y, h @ tl.deq(e).float().T, rtol=0, atol=0)
    # bf16 h: the weight rounded once to bf16, i.e. the reference's deq
    hb = h.to(torch.bfloat16)
    torch.testing.assert_close(w8a16.w8a16_matmul(hb, q["q8"], q["s8"]),
                               hb @ tl.deq(q), rtol=0, atol=0)
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(h, q["q8"], q["s8"].float())
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(h[:, :40], q["q8"], q["s8"])
    assert w8a16.LAUNCHES["w8a16"] == 0  # the CPU never launches


def test_compiled_reference_keeps_deq_unrounded():
    """Why a float32 consumer takes the exact product: jitted, the
    reference's ``h @ deq(w)`` equals ``h @ (q8 * s8)`` in float32, and
    differs from the eager (bf16-rounded) one."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jl

    rng = np.random.RandomState(3)
    w = jnp.asarray(rng.randn(64, 128).astype(np.float32))
    h = jnp.asarray(rng.randn(3, 64).astype(np.float32))
    q = jl._quant_leaf(w)
    jit = np.asarray(jax.jit(lambda a, p: a @ jl.deq(p))(h, q))
    exact = np.asarray(h) @ (np.asarray(q["q8"], np.float32)
                             * np.asarray(q["s8"].astype(jnp.float32)))
    assert np.abs(jit - exact).max() < 1e-5
    assert np.abs(np.asarray(h @ jl.deq(q)) - exact).max() > 1e-3
    tq = {"q8": torch.tensor(np.asarray(q["q8"])),
          "s8": torch.tensor(np.asarray(q["s8"].astype(jnp.float32))).to(
              torch.bfloat16)}
    got = tl._mm(torch.tensor(np.asarray(h)), tq).numpy()
    assert np.abs(got - jit).max() < 1e-5
    # the tied head keeps the rounding: deq(embed).T, jitted
    e = jl._quant_leaf(w.T, axis=-1)  # [N, K], per row
    jit_t = np.asarray(jax.jit(lambda a, p: a @ jl.deq(p).T)(h, e))
    rounded = np.asarray(h) @ np.asarray(jl.deq(e).astype(jnp.float32)).T
    assert np.abs(jit_t - rounded).max() < 1e-5
    te = {"q8": torch.tensor(np.asarray(e["q8"])),
          "s8": torch.tensor(np.asarray(e["s8"].astype(jnp.float32))).to(
              torch.bfloat16), "transposed": True}
    got = tl._mm(torch.tensor(np.asarray(h)), te).numpy()
    assert np.abs(got - jit_t).max() < 1e-5


def _caches(jcfg, seed):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    shape = (jcfg.n_layers, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    bt = np.arange(1, NB, dtype=np.int32).reshape(B, MBK)
    pos = np.array([7, 16], np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos),
          "bt": jnp.asarray(bt)}
    tc = {"k": torch.tensor(k), "v": torch.tensor(v),
          "pos": torch.tensor(pos), "bt": torch.tensor(bt)}
    return jc, tc


def test_paged_prefill_with_int8_matches_jax(model):
    import jax
    import jax.numpy as jnp

    _, jl, jcfg, jq, tcfg, tq, _ = model
    jc, tc = _caches(jcfg, 3)
    toks = np.random.RandomState(4).randint(0, 256, size=(B, 8)).astype(
        np.int32)
    lens = np.array([8, 5], np.int32)
    jlg, jc2 = jax.jit(lambda p, c, t, n: jl.paged_prefill_batched(
        p, c, t, n, jcfg))(jq, dict(jc), jnp.asarray(toks), jnp.asarray(lens))
    tlg, tc2 = tl.paged_prefill_batched(tq, tc, torch.tensor(toks),
                                        torch.tensor(lens), tcfg)
    assert np.abs(_np(tlg) - np.asarray(jlg)).max() < LOGIT_TOL
    assert np.abs(_np(tc2["k"]) - np.asarray(jc2["k"])).max() < HID_TOL
    assert np.array_equal(np.asarray(jc2["pos"]), tc2["pos"].numpy())


@pytest.mark.parametrize("kern", ["blocked", "gather"])
def test_paged_decode_with_int8_matches_jax(model, kern):
    import jax
    import jax.numpy as jnp

    _, jl, jcfg, jq, tcfg, tq, _ = model
    jc, tc = _caches(jcfg, 5)
    toks = np.array([[3], [200]], np.int32)
    jlg, jc2 = jax.jit(lambda p, c, t: jl.paged_decode_step_batched(
        p, c, t, jcfg, kv_attention=kern))(jq, dict(jc), jnp.asarray(toks))
    tlg, tc2 = tl.paged_decode_step_batched(tq, tc, torch.tensor(toks), tcfg,
                                            kv_attention=kern)
    assert np.abs(_np(tlg) - np.asarray(jlg)).max() < LOGIT_TOL
    assert np.array_equal(np.asarray(jnp.argmax(jlg, -1)),
                          tlg.argmax(-1).numpy())
    assert np.abs(_np(tc2["v"]) - np.asarray(jc2["v"])).max() < HID_TOL


def test_paged_verify_with_int8_matches_jax(model):
    import jax
    import jax.numpy as jnp

    _, jl, jcfg, jq, tcfg, tq, _ = model
    jc, tc = _caches(jcfg, 6)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 256, size=(B, 5)).astype(np.int32)
    lens = np.array([5, 5], np.int32)
    starts = np.array([7, 16], np.int32)
    jx, _ = jax.jit(lambda p, c, *a: jl._paged_suffix_forward(
        p, c, *a, jcfg, kv_attention="blocked"))(
        jq, dict(jc), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(starts))
    tx, _ = tl._paged_suffix_forward(
        tq, {k: v.clone() for k, v in tc.items()}, torch.tensor(toks),
        torch.tensor(lens), torch.tensor(starts), tcfg,
        kv_attention="blocked")
    assert np.abs(_np(tx) - np.asarray(jx)).max() < HID_TOL
    jids, _ = jax.jit(lambda p, c, *a: jl.paged_verify(
        p, c, *a, jcfg, kv_attention="blocked"))(
        jq, dict(jc), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(starts))
    tids, _ = tl.paged_verify(tq, tc, torch.tensor(toks), torch.tensor(lens),
                              torch.tensor(starts), tcfg,
                              kv_attention="blocked")
    assert np.array_equal(np.asarray(jids), tids.numpy())


def _jax_chains(jl, jcfg, jq, n):
    """Greedy chains from the JAX model functions over int8 params,
    jitted as the reference engine runs them."""
    import jax
    import jax.numpy as jnp

    step = jax.jit(lambda c, t: jl.paged_decode_step_batched(
        jq, c, t, jcfg, kv_attention="blocked"))
    prefill = jax.jit(lambda c, t, n: jl.paged_prefill_batched(
        jq, c, t, n, jcfg))
    out = []
    for prompt in PROMPTS:
        c = jl.init_paged_cache(jcfg, 1, MAX_SEQ, 1 + MBK, BS)
        c["bt"] = jnp.arange(1, 1 + MBK, dtype=jnp.int32)[None]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        lg, c = prefill(c, jnp.asarray(toks),
                        jnp.asarray([len(prompt)], jnp.int32))
        ids = [int(jnp.argmax(lg[0]))]
        while len(ids) < n:
            lg, c = step(c, jnp.asarray([[ids[-1]]], jnp.int32))
            ids.append(int(jnp.argmax(lg[0])))
        out.append(ids)
    return out


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
def test_int8_engine_streams_match_jax_chain(model, chunk):
    name, jl, jcfg, jq, tcfg, tq, tp = model
    want = _jax_chains(jl, jcfg, jq, MAX_TOKENS)
    # the engine quantizes the float params it is given
    eng = srv.LlamaEngine(preset=name, device="cpu", max_batch=2,
                          max_seq=MAX_SEQ, kv_block_size=BS, kv_blocks=40,
                          kv_attention="blocked", quantize="int8",
                          prefill_chunk_tokens=chunk, params=tp)
    try:
        got = [eng.generate(p, MAX_TOKENS)["token_ids"] for p in PROMPTS]
        st = eng.stats()
    finally:
        eng.close()
    assert got == want
    assert st["weights"]["quantize"] == "int8"
    assert st["weights"]["bytes"] == tl.params_nbytes(tq)


def test_quantize_leaf_at_follows_quantize_params():
    cfg = tl.preset("tiny")
    p = tl.llama_init(cfg, torch.Generator().manual_seed(1), "cpu")
    q = tl.quantize_params(p, cfg)
    for key, want in (("['params']['embed']", q["embed"]),
                      ("['params']['lm_head']", q["lm_head"]),
                      ("['params']['layers']['w_up']", q["layers"]["w_up"])):
        name = key.split("'")[-2]
        leaf = p["layers"][name] if "layers" in key else p[name]
        got = tl.quantize_leaf_at(key, leaf)
        assert torch.equal(got["q8"], want["q8"])
        assert torch.equal(got["s8"], want["s8"])
    norm = p["layers"]["mlp_norm"]
    assert tl.quantize_leaf_at("['params']['layers']['mlp_norm']", norm) \
        is norm


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: (h dtype, route forced or None): bf16 through its static route and each
#: bf16 route forced; float32 through its one (CUDA-core) route
W8_ROUTES = [(torch.bfloat16, None), (torch.bfloat16, "decode"),
             (torch.bfloat16, "prefill"), (torch.float32, None)]
#: (K, N, tied): small shapes of both layouts, a K that is not a multiple
#: of the kernels' k-steps, and Llama-3-8B's w_down / wk widths (K = 14336,
#: N = 1024: the decode route splits K)
W8_CASES = [(256, 512, False), (512, 256, False), (256, 384, True),
            (2064, 1040, False), (2064, 1040, True), (14336, 1024, False)]


def _w8_case(K, N, tied, M, dtype, cuda):
    rng = np.random.RandomState(M + K + N)
    w = torch.tensor(rng.randn(K, N).astype(np.float32) / np.sqrt(K))
    q = tl._quant_leaf(w.T.contiguous(), axis=-1) if tied else \
        tl._quant_leaf(w)
    h = torch.tensor(rng.randn(M, K).astype(np.float32)).to(cuda, dtype)
    return h, q["q8"].to(cuda), q["s8"].to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", W8_ROUTES,
                         ids=["bf16", "bf16-decode", "bf16-prefill", "f32"])
@pytest.mark.parametrize("M", [1, 8, 40, 64, 65, 130, 512])
@pytest.mark.parametrize("K,N,tied", W8_CASES,
                         ids=[f"{K}x{N}{'-tied' if t else ''}"
                              for K, N, t in W8_CASES])
def test_cuda_w8a16_matches_plain(cuda, monkeypatch, dtype, route, M, K, N,
                                  tied):
    """Each route's kernel (forced, or the static route) against its plain
    version on the same inputs. Tolerances relative to the largest output:
    bf16 1e-2 (both sum in float32 and round once to bf16: ~2 ulps),
    float32 2e-5 (the same exact weight, float32 sums reordered over K)."""
    h, q8, s8 = _w8_case(K, N, tied, M, dtype, cuda)
    want = w8a16.plain_w8a16_matmul(h, q8, s8, tied)
    monkeypatch.setattr(w8a16, "plain_w8a16_matmul", None)
    took = route or w8a16.w8a16_route(M, N, K, dtype, tied)
    before = dict(w8a16.LAUNCHES)
    got = w8a16.w8a16_matmul(h, q8, s8, tied, route=route)
    torch.cuda.synchronize()
    assert w8a16.LAUNCHES["w8a16"] == before["w8a16"] + 1
    assert w8a16.LAUNCHES[f"w8a16_{took}"] == before[f"w8a16_{took}"] + 1
    tol = (1e-2 if dtype == torch.bfloat16 else 2e-5) * \
        want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["decode", "prefill"])
@pytest.mark.parametrize("M", [8, 40, 512])
def test_cuda_w8a16_bit_identical_calls(cuda, route, M):
    """Two calls on the same inputs give the same bits: the decode route's
    split-K partials are summed in split order by a second kernel (no
    float atomics). K = 14336, N = 1024 splits K at every M here."""
    h, q8, s8 = _w8_case(14336, 1024, False, M, torch.bfloat16, cuda)
    if route == "decode":
        assert w8a16.w8a16_split_plan(M, 1024, 14336)[0] > 1
    a = w8a16.w8a16_matmul(h, q8, s8, route=route)
    b = w8a16.w8a16_matmul(h, q8, s8, route=route)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_w8a16_route_table_matches_source(cuda):
    """The wrapper's static route against the source's ``route_of`` (the C
    entry ``kdl_w8a16_route``), and a route the dtype cannot take raises."""
    from kubedl_tpu_torch.ops.build import load_w8a16_kernels

    lib = load_w8a16_kernels()
    code = {"cuda_core": 0, "decode": 1, "prefill": 2}
    for M in (1, 8, 40, 63, 64, 65, 512):
        for dtype, d in ((torch.float32, 0), (torch.bfloat16, 1)):
            for tied in (0, 1):
                want = code[w8a16.w8a16_route(M, 4096, 4096, dtype, tied)]
                assert lib.kdl_w8a16_route(M, 4096, 4096, d, tied) == want
    h, q8, s8 = _w8_case(256, 512, False, 8, torch.float32, cuda)
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(h, q8, s8, route="decode")
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(h.to(torch.bfloat16), q8, s8, route="cuda_core")
