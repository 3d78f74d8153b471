"""The port's flash attention (kubedl_tpu_torch.ops.flash_attention)
against the reference's Pallas kernels run in interpret mode on the CPU.

The same numpy inputs go through JAX ``flash_attention(..., interpret=
True)`` and the port's ``flash_attention`` (whose operators run their
plain PyTorch versions on CPU tensors). Tolerances, float32: forward and
lse 2e-5 abs/rel (reordered float32 sums at S <= 128 sit near 1e-7);
gradients 1e-4 (the reference's own gradient tolerance), 2e-3 on the
long odd sequence (as the reference's test). Each JAX reference is
computed once per case (its interpret compile dominates the cost).

The CUDA kernels are held against the plain versions on the card (the
``cuda`` cases, skipped without one; ``chip_smoke.py`` does it at the
training shapes).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.ops import flash_attention as tfa  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(seed, B=2, S=64, H=4, KV=2, hd=16):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _rope(hd, S):
    from kubedl_tpu.models import llama as jl

    cos, sin = jl.rope_table(hd, 10000.0, S)
    return np.array(cos), np.array(sin)


@functools.lru_cache(maxsize=None)
def _jax_case(seed, B, S, H, KV, hd, causal, block, rope, split=False):
    """JAX out and d/d(q,k,v) of (o*o).sum() through the reference's
    interpret-mode flash kernels (``split`` forces the split backward)."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.ops import flash_attention_module as jfa

    q, k, v = _qkv(seed, B, S, H, KV, hd)
    kw = dict(causal=causal, block_q=block, block_k=block,
              bwd_block_q=block, bwd_block_k=block, interpret=True)
    if rope:
        cos, sin = _rope(hd, S)
        kw.update(rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, **kw)
        return (o * o).sum(), o

    old = jfa._FUSED_BWD_SCRATCH_BYTES
    if split:
        jfa._FUSED_BWD_SCRATCH_BYTES = 0
    try:
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(*map(jnp.asarray,
                                                          (q, k, v)))
    finally:
        jfa._FUSED_BWD_SCRATCH_BYTES = old
    return np.asarray(o), tuple(np.asarray(x) for x in g)


def _port_case(seed, B, S, H, KV, hd, causal, block, rope):
    assert tfa.fit_block(S, block) > 0  # the flash route, not the oracle
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(seed, B, S, H, KV, hd))
    kw = dict(causal=causal, block_q=block, block_k=block,
              bwd_block_q=block, bwd_block_k=block)
    if rope:
        cos, sin = (torch.from_numpy(t) for t in _rope(hd, S))
        kw.update(rope_cos=cos, rope_sin=sin)
    o = tfa.flash_attention(q, k, v, **kw)
    g = torch.autograd.grad((o * o).sum(), (q, k, v))
    return o.detach().numpy(), tuple(x.numpy() for x in g)


#: (seed, B, S, H, KV, hd, causal, block, rope). Every case tiles (a
#: block below S must be a multiple of 128, else both sides would take
#: the dense oracle): one block at S <= block, 2 x 2 tiles at S = 256.
CASES = {
    "causal-group2": (0, 2, 64, 4, 2, 16, True, 64, False),
    "noncausal-group2": (1, 2, 64, 4, 2, 16, False, 64, False),
    "causal-group4": (2, 1, 64, 8, 2, 16, True, 64, False),
    "causal-mqa": (3, 1, 64, 8, 1, 16, True, 64, False),
    "noncausal-mqa": (4, 1, 48, 4, 1, 16, False, 1024, False),
    "multi-block": (5, 1, 256, 4, 2, 16, True, 128, False),
    "rope-gqa": (6, 1, 256, 4, 2, 16, True, 128, True),
    "rope-mqa": (7, 1, 64, 8, 1, 32, True, 64, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case):
    o_ref, _ = _jax_case(*CASES[case])
    o, _ = _port_case(*CASES[case])
    np.testing.assert_allclose(o, o_ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(case):
    _, g_ref = _jax_case(*CASES[case])
    _, g = _port_case(*CASES[case])
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_fused_rope_matches_explicit_rope():
    """Fused rope takes PRE-rope q/k and returns pre-rope gradients: it
    equals rotating outside and attending, forward and backward."""
    from kubedl_tpu_torch.models import llama as tl

    seed, B, S, H, KV, hd, causal, block, _ = CASES["rope-gqa"]
    o_fused, g_fused = _port_case(seed, B, S, H, KV, hd, causal, block, True)
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(seed, B, S, H, KV, hd))
    cos, sin = (torch.from_numpy(t) for t in _rope(hd, S))
    o = tfa.flash_attention(tl.apply_rope(q, cos, sin),
                            tl.apply_rope(k, cos, sin), v, causal=causal)
    g = torch.autograd.grad((o * o).sum(), (q, k, v))
    np.testing.assert_allclose(o_fused, o.detach().numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)
    for a, b in zip(g_fused, g):
        np.testing.assert_allclose(a, b.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_fused_rope_split_backward_path(monkeypatch):
    """The reference's monkeypatch of the fused-scratch cap to 0 on both
    sides: the split pair with in-kernel rope matches the reference's
    split kernels, and the port's own fused route."""
    case = CASES["rope-gqa"]
    _, g_fused = _port_case(*case)
    _, g_ref = _jax_case(*case, split=True)
    monkeypatch.setattr(tfa, "_FUSED_BWD_SCRATCH_BYTES", 0)
    assert tfa.bwd_route(case[2], case[5]) == "split"
    calls = {"dq": 0, "dkdv": 0}
    real_dq, real_dkdv = tfa._plain_bwd_dq, tfa._plain_bwd_dkdv_per_head

    def dq(*a):
        calls["dq"] += 1
        return real_dq(*a)

    def dkdv(*a):
        calls["dkdv"] += 1
        return real_dkdv(*a)

    monkeypatch.setattr(tfa, "_plain_bwd_dq", dq)
    monkeypatch.setattr(tfa, "_plain_bwd_dkdv_per_head", dkdv)
    _, g_split = _port_case(*case)
    assert calls == {"dq": 1, "dkdv": 1}
    for a, b, c in zip(g_split, g_ref, g_fused):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_allclose(a, c, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_lse_is_base2_and_matches_reference_fwd():
    """The plain forward's lse is the reference kernel's: base 2,
    [B, H, Sq, 1] float32 (checked with fused rope)."""
    import jax.numpy as jnp

    from kubedl_tpu.ops import flash_attention_module as jfa

    seed, B, S, H, KV, hd, causal, block, _ = CASES["rope-gqa"]
    q, k, v = _qkv(seed, B, S, H, KV, hd)
    cos, sin = _rope(hd, S)
    _, lse_ref = jfa._fwd(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal, block, block, True, cos=jnp.asarray(cos),
        sin=jnp.asarray(sin))
    out, lse = tfa._plain_fwd(*(torch.from_numpy(x) for x in (q, k, v, cos,
                                                            sin)), causal)
    assert tuple(lse.shape) == (B, H, S, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               atol=FWD_TOL, rtol=FWD_TOL)
    # base 2: the first query sees only key 0 (causal), so its lse is its
    # one score in log2 units, s * log2(e) / sqrt(hd)
    qr = tfa._rope_rotate(torch.from_numpy(q), torch.from_numpy(cos),
                          torch.from_numpy(sin))
    kr = tfa._rope_rotate(torch.from_numpy(k), torch.from_numpy(cos),
                          torch.from_numpy(sin))
    s00 = float((qr[0, 0, 0] * kr[0, 0, 0]).sum()) / np.sqrt(hd)
    assert abs(float(lse[0, 0, 0, 0]) - s00 * np.log2(np.e)) < 1e-5


def test_mask_falls_back_to_dense():
    from kubedl_tpu_torch.models import llama as tl

    q, k, v = (torch.from_numpy(x) for x in _qkv(8, S=32))
    mask = torch.ones((1, 1, 1, 32, 32), dtype=torch.bool)
    mask[..., 5:] = False
    calls = []
    real = tfa._plain_fwd
    try:
        tfa._plain_fwd = lambda *a: calls.append(1) or real(*a)
        got = tfa.flash_attention(q, k, v, causal=False, mask=mask)
    finally:
        tfa._plain_fwd = real
    assert not calls
    want = tl.attention(q, k, v, causal=False, mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_untileable_shape_falls_back_to_oracle():
    import jax.numpy as jnp

    from kubedl_tpu.ops import flash_attention_module as jfa

    q, k, v = _qkv(9, S=48)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=32,
                               block_k=32)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=32,
                              block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_odd_long_seq_refit_gradients(monkeypatch):
    """The reference's long odd-sequence re-fit case (S=5376, hd=16, its
    shrunken thresholds): both sides take the fused route with a re-fit
    512-tile and agree on the gradients (2e-3, the reference's tolerance
    there)."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.ops import flash_attention_module as jfa

    S, hd = 5376, 16
    for mod in (jfa, tfa):
        monkeypatch.setattr(mod, "_FUSED_BWD_SMALL_TILE_BYTES", 256 << 10)
        monkeypatch.setattr(mod, "_FUSED_BWD_SCRATCH_BYTES", 1 << 20)
    assert tfa.bwd_route(S, hd) == "fused" and tfa.fit_block(S, 512) == 384
    q, k, v = _qkv(5, B=1, S=S, H=2, KV=1, hd=hd)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=True, interpret=True)
        return (o * o).sum()

    g_ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, causal=True)
    g = torch.autograd.grad((o * o).sum(), (qt, kt, vt))
    for a, b in zip(g, g_ref):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3,
                                   rtol=2e-3)


#: the sequence lengths each routing case sweeps: 1..9000 at every hd,
#: and the long-context lengths around the split route's threshold (every
#: S > 16384 at hd 64, S > 8192 at hd 128)
ROUTING_CASES = {
    "16": (16, range(1, 9001)),
    "64": (64, range(1, 9001)),
    "128": (128, range(1, 9001)),
    "256": (256, range(1, 9001)),
    "64-long": (64, (16384, 16385, 24576, 32768)),
    "128-long": (128, (16384, 16385, 24576, 32768)),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES), ids=list(ROUTING_CASES))
def test_routing_equals_reference(case):
    """fit_block, supports and the fused/split choice against the
    reference's, over each case's lengths."""
    from kubedl_tpu.ops import flash_attention_module as jfa

    hd, lengths = ROUTING_CASES[case]
    for S in lengths:
        for want in (512, 1024):
            assert tfa.fit_block(S, want) == jfa.fit_block(S, want), (S, want)
        assert tfa.supports(S) == jfa.supports(S), S
        scratch = S * hd * 8
        ref_fused = scratch <= jfa._FUSED_BWD_SCRATCH_BYTES and (
            scratch <= jfa._FUSED_BWD_SMALL_TILE_BYTES
            or jfa.fit_block(S, 512) > 0)
        assert tfa.bwd_route(S, hd) == ("fused" if ref_fused else "split"), S


def test_long_context_lengths_take_the_split_pair():
    """At the long-context training lengths the reference's predicate picks
    the split pair (the lengths the tensor-core pair exists for)."""
    for S in (16385, 24576, 32768):
        assert tfa.bwd_route(S, 64) == "split"
    assert tfa.bwd_route(16384, 64) == "fused"
    assert tfa.bwd_route(8193, 128) == "split"
    assert tfa.bwd_route(8192, 128) == "fused"


def _source_route_table():
    """({(dtype, hd)} that the source's ``TcRoute`` sends to the tensor
    cores, {operator: whether its case in ``launch`` reads TcRoute})."""
    import re
    from pathlib import Path

    src = (Path(tfa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    m = re.search(r"struct TcRoute \{\s*static constexpr bool value =\s*"
                  r"std::is_same<T, __nv_bfloat16>::value && "
                  r"\(([^)]*)\);", src)
    assert m, "TcRoute is no longer 'bf16 && (HD == a || HD == b ...)'"
    pairs = {(torch.bfloat16, int(x))
             for x in re.findall(r"HD == (\d+)", m.group(1))}
    launch = src[src.index("cudaError_t launch(Which w"):]
    launch = launch[:launch.index("\n}\n")]
    ops = {"kFwd": "flash_fwd", "kBwdFused": "flash_bwd_fused",
           "kBwdDq": "flash_bwd_dq", "kBwdDkdv": "flash_bwd_dkdv"}
    reads = {ops[case]: "if constexpr (TcRoute<T, HD>::value)" in body
             for case, body in re.findall(r"case (k\w+):(.*?)(?=case k|\Z)",
                                          launch, re.S)}
    return pairs, reads


def test_tensor_core_route_matches_source_table():
    """tensor_core_route and the source's TcRoute name the same (type, hd)
    pairs, and each of the four operators' launches reads that table."""
    pairs, reads = _source_route_table()
    assert reads == dict.fromkeys(
        ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkdv"),
        True)
    for dtype in (torch.bfloat16, torch.float32):
        for hd in tfa.KERNEL_HEAD_DIMS:
            assert tfa.tensor_core_route(dtype, hd) == ((dtype, hd) in pairs)
    assert pairs == {(torch.bfloat16, 64), (torch.bfloat16, 128)}


def test_make_flash_attention_single_device_only():
    fn = tfa.make_flash_attention(None)
    assert fn.fused_rope is True
    assert tfa.make_flash_attention({"data": 1}).fused_rope is True
    with pytest.raises(ValueError, match="multi-chip"):
        tfa.make_flash_attention({"data": 2})


def test_kernel_wrapper_rejects_uninstantiated_head_dim():
    """An hd with no compiled kernel raises in the wrapper's checks; it is
    never routed to the plain version."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, S=16, hd=32))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_cuda_inputs(q, k, v, None, None)
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, S=16, hd=64))
    tfa._check_cuda_inputs(q, k, v, None, None)
    with pytest.raises(TypeError):
        tfa._check_cuda_inputs(q.double(), k.double(), v.double(), None, None)


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch, split):
    """A CUDA tensor on the flash route launches the kernels: every plain
    version is replaced by a tripwire, and the kernel results still match
    the plain versions computed beforehand (the port's own rope tables:
    this case needs no JAX)."""
    from kubedl_tpu_torch.models.llama import rope_table

    seed, B, S, H, KV, hd = 11, 1, 128, 8, 2, 64
    qn, kn, vn = _qkv(seed, B, S, H, KV, hd)
    cos, sin = rope_table(hd, 10000.0, S, device=cuda)
    q, k, v = (torch.from_numpy(x).to(cuda).requires_grad_(True)
               for x in (qn, kn, vn))
    o_ref = tfa.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                rope_cos=cos.cpu(), rope_sin=sin.cpu()).detach()

    def tripwire(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("_plain_fwd", "_plain_bwd_fused", "_plain_bwd_dq",
                 "_plain_bwd_dkdv_per_head"):
        monkeypatch.setattr(tfa, name, tripwire)
    if split:
        monkeypatch.setattr(tfa, "_FUSED_BWD_SCRATCH_BYTES", 0)
    before = dict(tfa.LAUNCHES)
    o = tfa.flash_attention(q, k, v, rope_cos=cos, rope_sin=sin)
    torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))
    torch.cuda.synchronize()
    launched = {n: tfa.LAUNCHES[n] - before[n] for n in before}
    assert launched["flash_fwd"] == 1
    if split:
        assert launched["flash_bwd_dq"] == launched["flash_bwd_dkdv"] == 1
    else:
        assert launched["flash_bwd_fused"] == 1
    np.testing.assert_allclose(o.detach().cpu().numpy(), o_ref.numpy(),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(*(torch.from_numpy(x).to(cuda)
                              for x in _qkv(seed, S=16, hd=32)))


#: tolerances on the card, kernel against plain version on the same inputs
#: (those of chip_smoke.py's phase 7): out max abs, lse max abs, gradients
#: max abs over max |grad|. bf16: both sides sum in float32 and round at
#: the same points, so they differ by about one bf16 ulp of |out| <= 4 and
#: of a rounded P or dS; float32: reordered float32 sums (the fused dq by
#: atomics or bulk reductions in run-to-run order).
CARD_TOL = {"bfloat16": {"out": 2e-2, "lse": 1e-4, "grad": 2e-2},
            "float32": {"out": 1e-5, "lse": 1e-4, "grad": 1e-4}}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["causal-S256", "ragged-noncausal-S200"])
@pytest.mark.parametrize("rope", [False, True], ids=["norope", "rope"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_kernels_match_plain_versions(cuda, hd, dtype, rope, shape):
    """All four operators' kernels (tensor-core or CUDA-core, as the route
    table says) against their plain versions on the same CUDA inputs, and
    the split route against the fused one."""
    from kubedl_tpu_torch.models.llama import rope_table

    causal = shape.startswith("causal")
    B, S, H, KV = (1, 256, 4, 2) if causal else (2, 200, 4, 1)
    dt = getattr(torch, dtype)
    tol = CARD_TOL[dtype]
    rng = np.random.RandomState(hd + S)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda, dt) for s in ((B, S, H, hd), (B, S, KV, hd),
                                           (B, S, KV, hd), (B, S, H, hd)))
    cos = sin = None
    if rope:
        cos, sin = rope_table(hd, 500000.0, S, device=cuda)
    out, lse = tfa.flash_fwd(q, k, v, cos, sin, causal)
    args = (q, k, v, cos, sin, out, lse, do, causal)
    fused = tfa.flash_bwd_fused(*args)
    dq_s = tfa.flash_bwd_dq(*args)
    dk_h, dv_h = tfa.flash_bwd_dkdv(*args)
    torch.cuda.synchronize()
    p_out, p_lse = tfa._plain_fwd(q, k, v, cos, sin, causal)
    assert (out.float() - p_out.float()).abs().max().item() <= tol["out"]
    assert (lse - p_lse).abs().max().item() <= tol["lse"]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    p_grads = tfa._plain_bwd_fused(*args)
    p_dk_h, p_dv_h = tfa._plain_bwd_dkdv_per_head(*args)
    split = (dq_s, dk_h.reshape(B, S, KV, H // KV, hd).sum(3).to(dt),
             dv_h.reshape(B, S, KV, H // KV, hd).sum(3).to(dt))
    for a, b in zip(fused, p_grads):
        assert rel(a, b) <= tol["grad"]
    assert rel(dq_s, tfa._plain_bwd_dq(*args)) <= tol["grad"]
    assert rel(dk_h, p_dk_h) <= tol["grad"]
    assert rel(dv_h, p_dv_h) <= tol["grad"]
    for a, b in zip(fused, split):
        assert rel(a, b) <= tol["grad"]


#: the split pair on the card: (B, S, H, KV, hd, causal, rope) over GQA
#: groups 1, 4 and 8, both tensor-core widths, RoPE on and off, causal
#: and not, ragged lengths (not a multiple of any tile)
SPLIT_CARD_CASES = {
    "hd64-g1-causal-rope": (1, 512, 4, 4, 64, True, True),
    "hd64-g4-ragged-noncausal": (1, 1000, 8, 2, 64, False, False),
    "hd64-g8-ragged-causal-rope": (1, 1000, 8, 1, 64, True, True),
    "hd128-g1-noncausal-rope": (1, 512, 4, 4, 128, False, True),
    "hd128-g4-causal": (2, 384, 8, 2, 128, True, False),
    "hd128-g8-ragged-causal-rope": (1, 1000, 8, 1, 128, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_CARD_CASES))
def test_cuda_split_pair_matches_plain_versions(cuda, monkeypatch, case):
    """The split pair (bf16: the tensor-core dq and dk/dv kernels) against
    the plain versions on the same CUDA inputs, and flash_backward on the
    split route against the plain fused backward (CARD_TOL bf16)."""
    from kubedl_tpu_torch.models.llama import rope_table

    B, S, H, KV, hd, causal, rope = SPLIT_CARD_CASES[case]
    tol = CARD_TOL["bfloat16"]["grad"]
    rng = np.random.RandomState(S + hd + H)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda, torch.bfloat16)
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                             (B, S, H, hd)))
    cos = sin = None
    if rope:
        cos, sin = rope_table(hd, 500000.0, S, device=cuda)
    out, lse = tfa.flash_fwd(q, k, v, cos, sin, causal)
    args = (q, k, v, cos, sin, out, lse, do, causal)
    before = dict(tfa.LAUNCHES)
    dq = tfa.flash_bwd_dq(*args)
    dk_h, dv_h = tfa.flash_bwd_dkdv(*args)
    monkeypatch.setattr(tfa, "_FUSED_BWD_SCRATCH_BYTES", 0)
    grads = tfa.flash_backward(*args)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_bwd_dq"] - before["flash_bwd_dq"] == 2
    assert tfa.LAUNCHES["flash_bwd_fused"] == before["flash_bwd_fused"]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    assert rel(dq, tfa._plain_bwd_dq(*args)) <= tol
    p_dk_h, p_dv_h = tfa._plain_bwd_dkdv_per_head(*args)
    assert rel(dk_h, p_dk_h) <= tol and rel(dv_h, p_dv_h) <= tol
    for a, b in zip(grads, tfa._plain_bwd_fused(*args)):
        assert rel(a, b) <= tol


@pytest.mark.cuda
def test_cuda_route_table_matches_source(cuda):
    """The source's route (kdl_flash_route, the TcRoute every launch reads)
    and tensor_core_route agree for every type and head width."""
    from kubedl_tpu_torch.ops.build import load_flash_kernels

    lib = load_flash_kernels()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for hd in tfa.KERNEL_HEAD_DIMS:
            assert lib.kdl_flash_route(code, hd) == \
                int(tfa.tensor_core_route(dtype, hd)), (dtype, hd)
    assert lib.kdl_flash_route(1, 32) == -1
