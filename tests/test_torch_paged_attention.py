"""The port's paged attention (kubedl_tpu_torch.models.paged_attention)
against the JAX reference and a float64 dense oracle.

On the CPU the port runs its plain PyTorch version; it is held against
JAX ``paged_attention(kernel="lax")`` (the reference's Pallas path does
not start on this jax version) and against the gather + dense softmax
oracle, at max abs 1e-5 in float32 — the reordered online-softmax sums
sit around 1e-7 at these sizes. The fused write must leave the pools
bit-identical to a numpy scatter. The CUDA kernels are held against the
plain version on the card (the ``cuda`` cases, skipped without one).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import paged_attention as tpa  # noqa: E402

F32_TOL = 1e-5


def _dense_reference(q, k_pool, v_pool, bt, starts, max_s):
    """Gather + masked dense softmax in float64 — the oracle."""
    B, S, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    group = H // KV
    kf = k_pool[bt].reshape(B, max_s, KV, hd)
    vf = v_pool[bt].reshape(B, max_s, KV, hd)
    posq = np.minimum(starts[:, None] + np.arange(S)[None, :], max_s - 1)
    qg = q.reshape(B, S, KV, group, hd).astype(np.float64)
    scores = np.einsum("bskgh,btkh->bkgst", qg, kf.astype(np.float64))
    scores /= math.sqrt(hd)
    mask = np.arange(max_s)[None, None, :] <= posq[:, :, None]  # [B,S,T]
    scores = np.where(mask[:, None, None], scores, -1e30)
    scores -= scores.max(axis=-1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=-1, keepdims=True)
    out = np.einsum("bkgst,btkh->bskgh", p, vf.astype(np.float64))
    return out.reshape(B, S, H, hd)


def _random_pool(seed, B, MB, BS, KV, hd, trash_garbage=True):
    rng = np.random.RandomState(seed)
    NB = 1 + B * MB
    kp = rng.randn(NB, BS, KV, hd).astype(np.float32)
    vp = rng.randn(NB, BS, KV, hd).astype(np.float32)
    if trash_garbage:
        # poison the trash block: any leak through the mask blows the check
        kp[0] = 37.0
        vp[0] = -29.0
    bt = np.arange(1, 1 + B * MB, dtype=np.int32).reshape(B, MB)
    return kp, vp, bt


def _t(a):
    return torch.tensor(a)


B, MB, BS, KV, H, HD = 4, 4, 16, 2, 4, 16


@pytest.mark.parametrize("starts,S,trash_rows", [
    ([0, 15, 16, 47], 1, ()),  # block boundaries
    ([3, 19, 35, 60], 1, ()),  # partial tail blocks
    ([0, 0, 22, 63], 1, (0, 1)),  # fresh rows: all-trash tables
    ([0, 5, 17, 40], 8, ()),  # suffix queries (a prefill chunk)
    ([60, 2, 31, 9], 8, (1,)),  # queries clamped at max_s - 1
])
def test_plain_matches_jax_lax_and_dense(starts, S, trash_rows):
    import jax.numpy as jnp

    from kubedl_tpu.models import paged_attention as pa

    kp, vp, bt = _random_pool(0, B, MB, BS, KV, HD)
    for r in trash_rows:
        bt[r, :] = 0
    q = np.random.RandomState(1).randn(B, S, H, HD).astype(np.float32)
    st = np.asarray(starts, np.int32)
    ref = _dense_reference(q, kp, vp, bt, st, MB * BS)
    jax_out = np.asarray(pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(st), kernel="lax",
    ))
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(st)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got.astype(np.float64) - ref).max() < F32_TOL
    assert np.abs(got - jax_out).max() < F32_TOL


@pytest.mark.parametrize("tile", [16, 64, 256])
def test_plain_chunking_is_tile_invariant(tile):
    """Folding 1, 4 or all blocks per step gives the same answer."""
    kp, vp, bt = _random_pool(2, B, MB, BS, KV, HD)
    q = np.random.RandomState(3).randn(B, 2, H, HD).astype(np.float32)
    st = np.array([1, 17, 33, 49], np.int32)
    ref = _dense_reference(q, kp, vp, bt, st, MB * BS)
    got = tpa.plain_paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(st),
                                    tile=tile).numpy()
    assert np.abs(got.astype(np.float64) - ref).max() < F32_TOL


def test_plain_bf16_within_stated_tolerance():
    """bf16 inputs, float32 accumulation, one rounding of the output:
    within 2e-2 of the float64 oracle for N(0,1) data (bf16 ulp at 2 is
    2^-7, plus the input rounding)."""
    kp, vp, bt = _random_pool(4, B, MB, BS, KV, HD)
    q = np.random.RandomState(5).randn(B, 4, H, HD).astype(np.float32)
    st = np.array([0, 15, 16, 47], np.int32)
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    got = tpa.paged_attention(tb(q), tb(kp), tb(vp), _t(bt), _t(st))
    assert got.dtype == torch.bfloat16
    # oracle on the bf16-rounded inputs: the point is the algorithm
    r = lambda a: tb(a).float().numpy()  # noqa: E731
    ref = _dense_reference(r(q), r(kp), r(vp), bt, st, MB * BS)
    assert np.abs(got.float().numpy() - ref).max() < 2e-2


@pytest.mark.parametrize("starts,seed", [
    ([0, 15, 16, 47], 0),  # write lands in slot 0 and slot BS-1
    ([3, 19, 35, 60], 7),
])
def test_fused_write_bit_identical_to_scatter(starts, seed):
    import jax.numpy as jnp

    from kubedl_tpu.models import paged_attention as pa

    kp, vp, bt = _random_pool(seed, B, MB, BS, KV, HD)
    rng = np.random.RandomState(seed + 1)
    q = rng.randn(B, 1, H, HD).astype(np.float32)
    nk = rng.randn(B, KV, HD).astype(np.float32)
    nv = rng.randn(B, KV, HD).astype(np.float32)
    st = np.asarray(starts, np.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(B):
        kp2[bt[b, st[b] // BS], st[b] % BS] = nk[b]
        vp2[bt[b, st[b] // BS], st[b] % BS] = nv[b]
    tk, tv = _t(kp), _t(vp)
    before = dict(tpa.LAUNCHES)
    out, ko, vo = tpa.paged_attention(_t(q), tk, tv, _t(bt), _t(st),
                                      new_k=_t(nk), new_v=_t(nv))
    assert tpa.LAUNCHES == before  # CPU tensors never count a launch
    assert ko is tk and vo is tv  # updated in place
    assert np.array_equal(ko.numpy(), kp2)
    assert np.array_equal(vo.numpy(), vp2)
    plain = tpa.paged_attention(_t(q), _t(kp2), _t(vp2), _t(bt), _t(st))
    assert torch.equal(out, plain)
    jout, _, _ = pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(st), kernel="lax", new_k=jnp.asarray(nk),
        new_v=jnp.asarray(nv),
    )
    assert np.abs(out.numpy() - np.asarray(jout)).max() < F32_TOL


def test_fused_trash_rows_touch_only_the_trash_block():
    """Vacant rows (all-trash tables) write block 0 only; every owned
    block still matches the scatter exactly."""
    kp, vp, bt = _random_pool(9, B, MB, BS, KV, HD)
    bt[1, :] = 0
    bt[3, :] = 0
    rng = np.random.RandomState(10)
    q = rng.randn(B, 1, H, HD).astype(np.float32)
    nk = rng.randn(B, KV, HD).astype(np.float32)
    nv = rng.randn(B, KV, HD).astype(np.float32)
    st = np.array([5, 0, 33, 7], np.int32)
    tk, tv = _t(kp), _t(vp)
    out, _, _ = tpa.paged_attention(_t(q), tk, tv, _t(bt), _t(st),
                                    new_k=_t(nk), new_v=_t(nv))
    kp2 = kp.copy()
    for b in (0, 2):
        kp2[bt[b, st[b] // BS], st[b] % BS] = nk[b]
    assert np.array_equal(tk.numpy()[1:], kp2[1:])
    assert np.isfinite(out.numpy()).all()


def test_blocks_per_chunk():
    assert tpa.blocks_per_chunk(32, 16, 256) == 16
    assert tpa.blocks_per_chunk(4, 16, 256) == 4
    assert tpa.blocks_per_chunk(5, 16, 64) == 1
    assert tpa.blocks_per_chunk(1, 512, 256) == 1
    assert tpa.blocks_per_chunk(128, 16) == 16  # the Llama serving shape


@pytest.mark.parametrize("kw", ["self_k", "self_v", "self_mask"])
def test_read_only_verify_modes_not_ported(kw):
    kp, vp, bt = _random_pool(0, 1, 2, 16, 2, 16)
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(NotImplementedError):
        tpa.paged_attention(q, _t(kp), _t(vp), _t(bt),
                            torch.zeros((1,), dtype=torch.int32),
                            **{kw: torch.zeros((1, 2, 2, 16))})


def test_fused_requires_single_query():
    kp, vp, bt = _random_pool(0, 1, 2, 16, 2, 16)
    with pytest.raises(ValueError):
        tpa.paged_attention(
            torch.zeros((1, 2, 4, 16)), _t(kp), _t(vp), _t(bt),
            torch.zeros((1,), dtype=torch.int32),
            new_k=torch.zeros((1, 2, 16)), new_v=torch.zeros((1, 2, 16)),
        )


def test_unsupported_device_raises():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    q = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError):
        tpa.paged_attention(q, q, q, q, q)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd,kv,h", [(1, 128, 2, 8), (8, 128, 2, 8),
                                       (1, 256, 1, 8), (8, 64, 2, 4)])
def test_cuda_blocked_kernel_matches_plain(cuda, monkeypatch, S, hd, kv, h):
    kp, vp, bt = _random_pool(11, B, MB, BS, kv, hd)
    bt[2, :] = 0
    q = np.random.RandomState(12).randn(B, S, h, hd).astype(np.float32)
    st = np.array([0, 15, 0, 47], np.int32)
    args = [_t(a).to(cuda) for a in (q, kp, vp, bt, st)]
    ref = tpa.plain_paged_attention(*args)

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tpa, "plain_paged_attention", no_plain)
    before = tpa.LAUNCHES["blocked"]
    got = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["blocked"] == before + 1
    assert (got - ref).abs().max().item() < F32_TOL


@pytest.mark.cuda
def test_cuda_fused_kernel_matches_scatter(cuda, monkeypatch):
    kp, vp, bt = _random_pool(13, B, MB, BS, KV, 128)
    rng = np.random.RandomState(14)
    q = _t(rng.randn(B, 1, H, 128).astype(np.float32)).to(cuda)
    nk = _t(rng.randn(B, KV, 128).astype(np.float32)).to(cuda)
    nv = _t(rng.randn(B, KV, 128).astype(np.float32)).to(cuda)
    st = _t(np.array([0, 15, 16, 47], np.int32)).to(cuda)
    btc = _t(bt).to(cuda)
    kr, vr = _t(kp).to(cuda), _t(vp).to(cuda)
    tpa.plain_fused_write(kr, vr, btc, st, nk, nv)
    ref = tpa.plain_paged_attention(q, kr, vr, btc, st)
    monkeypatch.setattr(tpa, "plain_fused_write", None)
    monkeypatch.setattr(tpa, "plain_paged_attention", None)
    kk, vk = _t(kp).to(cuda), _t(vp).to(cuda)
    out, _, _ = tpa.paged_attention(q, kk, vk, btc, st, new_k=nk, new_v=nv)
    torch.cuda.synchronize()
    assert torch.equal(kk, kr) and torch.equal(vk, vr)
    assert (out - ref).abs().max().item() < F32_TOL
