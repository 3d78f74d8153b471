"""The W8A16 kernels' host side and arithmetic, on the CPU.

The CUDA kernels (``kubedl_tpu_torch/csrc/w8a16.cu``) do not run here;
what surrounds them and what they compute is pinned from Python:

- ``w8a16_route`` over Llama-3-8B's five layer shapes, its head and
  Gemma-2B's tied head: float32 always ``"cuda_core"``; bf16 ``"decode"``
  up to ``DECODE_MAX_M`` rows (decode's 8, verify's 40), ``"prefill"``
  above (a prefill chunk's 512);
- ``w8a16_split_plan``: the K-slices tile K exactly, in multiples of the
  decode kernel's k-step, none empty; the grid fills the SMs where K
  allows; the float32 workspace matches and stays within the weight's
  bytes;
- the bit-level int8 -> bf16 dequantization both bf16 routes use (the
  int8 byte, sign-flipped, in the float32 magic number 2^23; the magic
  subtracted; the upper half taken as bf16; one bf16 x bf16 multiply by
  the scale, rounded to nearest even), written out below in torch integer
  and bit operations, equals ``deq_weight(q8, s8, torch.bfloat16)`` BIT
  FOR BIT (no tolerance) for every int8 value times thousands of seeded
  scales, the quantizer's floor 1e-8 and the largest scale a Llama-width
  weight gives, on both layouts.

On the card the kernels are held against the plain version
(``tests/test_torch_quantize.py``, ``cuda`` marker).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import llama as tl  # noqa: E402
from kubedl_tpu_torch.ops import w8a16  # noqa: E402

M_ROWS = (1, 8, 40, 64, 65, 130, 512)


def _shapes():
    """(K, N, transposed): Llama-3-8B's five layer shapes and its head,
    then Gemma-2B's tied head (the embedding [vocab, dim] read as
    [dim, vocab])."""
    c = tl.preset("llama3-8b")
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    out = [(c.dim, q, False), (c.dim, kv, False), (q, c.dim, False),
           (c.dim, c.ffn_dim, False), (c.ffn_dim, c.dim, False),
           (c.dim, c.vocab_size, False)]
    g = tl.preset("gemma-2b")
    assert g.tie_embeddings
    return out + [(g.dim, g.vocab_size, True)]


SHAPES = _shapes()
IDS = [f"{K}x{N}{'-tied' if t else ''}" for K, N, t in SHAPES]


@pytest.mark.parametrize("K,N,tied", SHAPES, ids=IDS)
def test_route_table(K, N, tied):
    for M in (1, 8, 40, 64, 65, 512):
        assert w8a16.w8a16_route(M, N, K, torch.float32, tied) == "cuda_core"
        want = "decode" if M <= 40 else "prefill" if M >= 65 else None
        got = w8a16.w8a16_route(M, N, K, torch.bfloat16, tied)
        if want is not None:
            assert got == want, (M, got)
        assert got == ("decode" if M <= w8a16.DECODE_MAX_M else "prefill")


@pytest.mark.parametrize("route", ["decode", "prefill"])
@pytest.mark.parametrize("K,N,tied", SHAPES, ids=IDS)
def test_split_plan_tiles_k(K, N, tied, route):
    step = w8a16.DEC_BK if route == "decode" else w8a16.PRE_BK
    ksteps = -(-K // step)
    for M in M_ROWS:
        splits, k_slice, ws_shape = w8a16.w8a16_split_plan(M, N, K, route)
        assert splits >= 1 and k_slice % step == 0
        # the slices [s * k_slice, min(K, (s + 1) * k_slice)) tile K
        # exactly, none empty
        bounds = [(s * k_slice, min(K, (s + 1) * k_slice))
                  for s in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == K
        assert all(lo < hi for lo, hi in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert ws_shape == ((splits, M, N) if splits > 1 else (0,))
        if route == "decode":
            tiles = -(-N // w8a16.DEC_BN) * -(-M // w8a16.DEC_ROWS)
            # float32 partials within the weight's own bytes, and the
            # grid on at least half the SMs where K and that cap allow
            assert splits == 1 or splits * M * N * 4 <= K * N
            cap = max(1, K // (4 * M))
            assert (2 * tiles * splits >= w8a16.SM_COUNT
                    or splits == ksteps or 2 * splits >= cap), (M, splits)
        else:
            rows = 128 if M <= w8a16.PRE_WIDE_M else 256
            tiles = -(-N // w8a16.PRE_BN) * -(-M // rows)
            slots = w8a16.SM_COUNT * (2 if rows == 128 else 1)
            # split only into SMs the tiles leave free: one wave at most,
            # and at least half of it where K allows
            assert splits == 1 or tiles * splits <= slots
            assert (2 * tiles * splits >= slots or splits == ksteps
                    or tiles >= slots), (M, splits)


def test_split_plan_at_decode_shapes():
    """Llama-3-8B at M=8: K split where the column strips alone leave SMs
    idle (4096 x 1024: 8 strips of 128 columns), not at the head."""
    c = tl.preset("llama3-8b")
    kv = c.n_kv_heads * c.head_dim
    assert w8a16.w8a16_split_plan(8, kv, c.dim)[0] >= 16
    assert w8a16.w8a16_split_plan(8, c.dim, c.ffn_dim)[0] > 1
    assert w8a16.w8a16_split_plan(8, c.vocab_size, c.dim)[0] == 1


def magic_deq_bf16_bits(q8: torch.Tensor, s8: torch.Tensor) -> torch.Tensor:
    """The kernels' dequantization of int8 ``q8`` by bf16 scales ``s8``
    (broadcast), in integer and bit operations: the bf16 bits as int64."""
    u = (q8.to(torch.int32) ^ 0x80) & 0xFF  # the byte XOR 0x80 (prmt/lop3)
    f = (u | 0x4B000000).view(torch.float32) - 8388736.0  # 2^23 + 128
    q_hi = (f.view(torch.int32).to(torch.int64) >> 16) & 0xFFFF  # bf16(q)
    assert torch.equal(f, q8.float())  # the subtraction is exact
    # mul.rn.bf16x2: the exact product of two bf16 values (8 x 8
    # significant bits fit float32), rounded once to nearest even
    qf = (q_hi << 16).to(torch.int32).view(torch.float32)
    sf = ((s8.view(torch.int16).to(torch.int64) & 0xFFFF) << 16).to(
        torch.int32).view(torch.float32)
    bits = (qf * sf).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF


def _scales(n: int) -> torch.Tensor:
    """n seeded bf16 scales: log-uniform over the quantizer's range, its
    floor 1e-8, and the largest scale of a Llama-3-8B weight at its
    narrowest fan-in (N(0, 1/4096), per column over K=4096)."""
    rng = np.random.RandomState(8)
    s = 10.0 ** rng.uniform(-8, 0, size=n - 2)
    w = torch.tensor(rng.randn(4096, 1024).astype(np.float32) / 64.0)
    big = tl._quant_leaf(w)["s8"].float().max().item()
    s = np.concatenate([s, [1e-8, big]]).astype(np.float32)
    return torch.tensor(s).to(torch.bfloat16)


@pytest.mark.parametrize("tied", [False, True], ids=["layer", "tied"])
def test_magic_dequant_bit_equal(tied):
    s = _scales(3000)
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    if tied:  # [N, K] with a scale a row, read as its transpose
        q8 = q[None, :].repeat(s.numel(), 1).contiguous()
        s8 = s[:, None].contiguous()
        want = w8a16.deq_weight(q8, s8, torch.bfloat16, transposed=True)
        got = magic_deq_bf16_bits(q8, s8).T
    else:  # [K, N] with a scale a column
        q8 = q[:, None].repeat(1, s.numel()).contiguous()
        s8 = s[None, :].contiguous()
        want = w8a16.deq_weight(q8, s8, torch.bfloat16)
        got = magic_deq_bf16_bits(q8, s8)
    assert want.dtype == torch.bfloat16
    want_bits = want.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    assert torch.equal(got.contiguous(), want_bits)


def test_cpu_route_argument():
    """On the CPU the plain version runs whatever route is asked for; an
    unknown route name is refused on either device."""
    rng = np.random.RandomState(3)
    w = torch.tensor(rng.randn(64, 32).astype(np.float32))
    q = tl._quant_leaf(w)
    h = torch.tensor(rng.randn(5, 64).astype(np.float32)).to(torch.bfloat16)
    want = w8a16.plain_w8a16_matmul(h, q["q8"], q["s8"])
    for route in (None, "decode", "prefill"):
        got = w8a16.w8a16_matmul(h, q["q8"], q["s8"], route=route)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(h, q["q8"], q["s8"], route="tensor_core")
