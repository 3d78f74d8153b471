"""The port's paged attention (kubedl_tpu_torch.models.paged_attention)
against the JAX reference and a float64 dense oracle.

On the CPU the port runs its plain PyTorch version; it is held against
JAX ``paged_attention(kernel="lax")`` (the reference's Pallas path does
not start on this jax version) and against the gather + dense softmax
oracle, at max abs 1e-5 in float32 — the reordered online-softmax sums
sit around 1e-7 at these sizes. The fused write must leave the pools
bit-identical to a numpy scatter. The split-K route's merge is held
there too, as the plain ``combine_splits`` over ``plain_split_partials``.
The CUDA kernels are held against the plain version on the card (the
``cuda`` cases, skipped without one): bf16 at max abs 2e-2 (both sides sum
in float32 and round the output to bf16 once; the tensor-core route also
rounds P to bf16, as the reference does), float32 at 1e-5.
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


# ---- routes and the split-K merge (CPU) -------------------------------------

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,S,group,BS,fused,want", [
    (BF, 128, 1, 4, 16, True, "split_k"),  # Llama-3-8B decode
    (BF, 256, 1, 8, 16, True, "split_k"),  # Gemma-2B decode
    (F32, 64, 1, 4, 16, True, "split_k"),
    (BF, 128, 1, 64, 16, True, "split_k"),  # fused is split-K at any R
    (BF, 128, 1, 4, 16, False, "split_k"),  # R = 4
    (BF, 128, 15, 4, 16, False, "split_k"),  # R = 60
    (F32, 128, 8, 4, 16, False, "split_k"),
    (BF, 128, 16, 4, 16, False, "tensor_core"),  # R = 64
    (BF, 128, 512, 4, 16, False, "tensor_core"),  # the prefill chunk
    (BF, 64, 64, 1, 8, False, "tensor_core"),
    (BF, 64, 32, 2, 32, False, "tensor_core"),
    (BF, 128, 64, 8, 64, False, "tensor_core"),
    (F32, 128, 512, 4, 16, False, "cuda_core"),  # f32 prefill
    (BF, 256, 64, 8, 16, False, "cuda_core"),  # hd 256 prefill
    (BF, 128, 64, 4, 12, False, "cuda_core"),  # BS not a multiple of 8
    (BF, 128, 64, 4, 128, False, "cuda_core"),  # BS does not divide 64
    (BF, 128, 64, 3, 16, False, "cuda_core"),  # group does not divide 64
    (torch.float16, 128, 64, 4, 16, False, "cuda_core"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_paged_route_table(dtype, hd, S, group, BS, fused, want):
    assert tpa.paged_route(dtype, hd, S, group, BS, fused) == want


@pytest.mark.parametrize("max_s,rows_kv", [(2048, 64), (2048, 8), (8192, 64),
                                           (64, 8), (16, 2), (1000, 3)])
def test_split_plan_covers_keys_and_fills_the_card(max_s, rows_kv):
    nsplit, length = tpa.split_plan(max_s, rows_kv)
    assert length % tpa.SPLIT_QUANTUM == 0 and length >= tpa.SPLIT_QUANTUM
    assert (nsplit - 1) * length < max_s <= nsplit * length
    # twice the SMs, unless the key range has fewer quanta than that
    assert nsplit * rows_kv >= min(2 * tpa.SM_COUNT,
                                   rows_kv * (max_s // tpa.SPLIT_QUANTUM))
    assert length <= max(tpa.SPLIT_TARGET_KEYS, tpa.SPLIT_QUANTUM)


@pytest.mark.parametrize("starts,S,trash_rows", [
    ([0, 200, 31, 255], 1, ()),  # a short row beside long ones
    ([3, 0, 96, 64], 1, (1,)),  # an all-trash row; split boundaries
    ([0, 37, 250, 120], 4, ()),  # suffix queries, one clamped at max_s-1
    ([255, 1, 32, 95], 4, (3,)),
])
def test_combine_splits_matches_jax_lax_and_dense(starts, S, trash_rows):
    """Cut 256 positions into 8 splits of 32: the merge of the splits'
    partials matches the reference at 1e-5, and the splits that a row
    never reaches are the empty partial and add exact zeros."""
    import jax.numpy as jnp

    from kubedl_tpu.models import paged_attention as pa

    mb, split_len = 16, 32
    kp, vp, bt = _random_pool(21, B, mb, BS, KV, HD)
    for r in trash_rows:
        bt[r, :] = 0
    q = np.random.RandomState(22).randn(B, S, H, HD).astype(np.float32)
    st = np.asarray(starts, np.int32)
    m, l, acc = tpa.plain_split_partials(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(st), split_len)
    assert m.shape == (B, KV, H // KV, S, 8) and acc.shape[-2:] == (8, HD)
    out = tpa.combine_splits(m, l, acc)  # [B, KV, group, S, hd]
    got = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, HD).numpy()
    ref = _dense_reference(q, kp, vp, bt, st, mb * BS)
    jax_out = np.asarray(pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(st), kernel="lax",
    ))
    assert np.abs(got.astype(np.float64) - ref).max() < F32_TOL
    assert np.abs(got - jax_out).max() < F32_TOL
    n_keys = np.minimum(st + S - 1, mb * BS - 1) + 1
    for b in range(B):
        used = -(-int(n_keys[b]) // split_len)
        assert torch.all(m[b, ..., used:] == tpa.M_FLOOR)
        assert not l[b, ..., used:].any() and not acc[b, ..., used:, :].any()
        # under the clamp their weighted terms are exact zeros
        mm = torch.clamp(m[b].amax(dim=-1), min=tpa.M_FLOOR)
        w = torch.exp(m[b] - mm[..., None])
        assert not (l[b] * w)[..., used:].any()
        assert not (acc[b] * w[..., None])[..., used:, :].any()
        only = tpa.combine_splits(m[b, ..., :used], l[b, ..., :used],
                                  acc[b, ..., :used, :])
        assert (only - out[b]).abs().max().item() < 1e-6


def test_lib_hash_covers_shared_headers(tmp_path):
    """An edited header renames every library built from the sources that
    may include it, so a stale build is never loaded."""
    import shutil

    from kubedl_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    assert (csrc / "hopper.cuh").exists()
    before = {n: build._lib_path(csrc / n).name
              for n in ("paged_attention.cu", "flash_attention.cu")}
    assert before == {n: build._lib_path(build.CSRC_DIR / n).name
                      for n in before}
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text()
                                     + "\n// edited\n")
    after = {n: build._lib_path(csrc / n).name for n in before}
    assert all(after[n] != before[n] for n in before)
    assert all(after[n].startswith(f"lib{n[:-3]}-") for n in after)


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


def _card_case(seed, b, mb, bs, kv, h, hd, S, starts, trash_rows, dtype,
               dev):
    """Seeded inputs on the card: a shuffled block table (rows' blocks are
    not contiguous), a poisoned trash block and the given all-trash rows."""
    rng = np.random.RandomState(seed)
    nb = 1 + b * mb
    kp = rng.randn(nb, bs, kv, hd).astype(np.float32)
    vp = rng.randn(nb, bs, kv, hd).astype(np.float32)
    kp[0], vp[0] = 37.0, -29.0
    bt = (rng.permutation(nb - 1) + 1).astype(np.int32).reshape(b, mb)
    for r in trash_rows:
        bt[r, :] = 0
    q = rng.randn(b, S, h, hd).astype(np.float32)
    nk = rng.randn(b, kv, hd).astype(np.float32)
    nv = rng.randn(b, kv, hd).astype(np.float32)
    fl = lambda a: _t(a).to(dev, dtype)  # noqa: E731
    it = lambda a: _t(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    return fl(q), fl(kp), fl(vp), it(bt), it(starts), fl(nk), fl(nv)


_CARD_TOL = {torch.bfloat16: 2e-2, torch.float32: F32_TOL}

#: (id, b, mb, bs, kv, h, hd, S, starts, trash rows): each route at ragged
#: starts, block boundaries, an all-trash row and queries clamped at
#: max_s - 1, block sizes 16 and 32
_BLOCKED_CASES = [
    ("split S1 hd128", 4, 8, 16, 2, 8, 128, 1, [0, 15, 16, 127], (2,)),
    ("split S8 hd64 bs32", 4, 4, 32, 2, 8, 64, 8, [0, 31, 124, 40], (3,)),
    ("split S3 hd256", 3, 8, 16, 1, 8, 256, 3, [17, 0, 126], (1,)),
    ("tc-or-cc S64 hd128", 3, 16, 16, 2, 8, 128, 64, [0, 47, 250], (1,)),
    ("tc-or-cc S40 hd64 bs32", 3, 8, 32, 2, 4, 64, 40, [31, 0, 230], ()),
    ("tc-or-cc S100 hd128 bs32 g8", 2, 8, 32, 1, 8, 128, 100, [5, 200],
     (1,)),
    ("cc S16 hd256", 2, 8, 16, 1, 8, 256, 16, [0, 120], ()),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", _BLOCKED_CASES, ids=lambda c: c[0])
def test_cuda_blocked_routes_match_plain(cuda, monkeypatch, case, dtype):
    _, b, mb, bs, kv, h, hd, S, starts, trash = case
    q, kp, vp, bt, st, _, _ = _card_case(31, b, mb, bs, kv, h, hd, S,
                                         starts, trash, dtype, cuda)
    ref = tpa.plain_paged_attention(q, kp, vp, bt, st)
    route = tpa.paged_route(dtype, hd, S, h // kv, bs)
    monkeypatch.setattr(tpa, "plain_paged_attention", None)
    before = dict(tpa.ROUTE_LAUNCHES)
    got = tpa.paged_attention(q, kp, vp, bt, st)
    torch.cuda.synchronize()
    assert tpa.ROUTE_LAUNCHES[route] == before[route] + 1
    err = (got.float() - ref.float()).abs().max().item()
    assert err < _CARD_TOL[dtype], (route, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd,bs,mb,starts", [
    (128, 16, 8, [0, 15, 16, 127]),  # slot 0, slot BS-1, last position
    (64, 32, 4, [31, 32, 5, 100]),
    (256, 16, 8, [64, 1, 0, 99]),
    (128, 16, 512, [0, 17, 300, 8190]),  # long context: most splits empty
], ids=["hd128", "hd64-bs32", "hd256", "long-context"])
def test_cuda_fused_split_k_matches_scatter(cuda, monkeypatch, dtype, hd, bs,
                                            mb, starts):
    b, kv, h, trash = 4, 2, 8, 2
    q, kp, vp, bt, st, nk, nv = _card_case(41, b, mb, bs, kv, h, hd, 1,
                                           starts, (trash,), dtype, cuda)
    kr, vr = kp.clone(), vp.clone()
    tpa.plain_fused_write(kr, vr, bt, st, nk, nv)
    ref = tpa.plain_paged_attention(q, kr, vr, bt, st)
    monkeypatch.setattr(tpa, "plain_fused_write", None)
    monkeypatch.setattr(tpa, "plain_paged_attention", None)
    before = dict(tpa.ROUTE_LAUNCHES)
    out, ko, vo = tpa.paged_attention(q, kp, vp, bt, st, new_k=nk, new_v=nv)
    torch.cuda.synchronize()
    assert ko is kp and vo is vp
    assert tpa.ROUTE_LAUNCHES["split_k"] == before["split_k"] + 1
    # block 0 takes the trash row's (colliding) write
    assert torch.equal(kp[1:], kr[1:]) and torch.equal(vp[1:], vr[1:])
    own = [r for r in range(b) if r != trash]
    err = (out[own].float() - ref[own].float()).abs().max().item()
    assert err < _CARD_TOL[dtype]


@pytest.mark.cuda
def test_cuda_route_table_matches_source(cuda):
    """The source's route_of and paged_route agree everywhere."""
    from kubedl_tpu_torch.ops.build import load_kernels

    lib = load_kernels()
    codes = {torch.float32: 0, torch.bfloat16: 1}
    route_codes = {"split_k": 0, "tensor_core": 1, "cuda_core": 2}
    for dtype in codes:
        for hd in (64, 128, 256):
            for S in (1, 3, 16, 512):
                for group in (1, 3, 4, 8, 64):
                    for bs in (8, 12, 16, 32, 64, 128):
                        for fused in (False, True):
                            want = route_codes[tpa.paged_route(
                                dtype, hd, S, group, bs, fused)]
                            got = lib.kdl_paged_route(codes[dtype], hd, S,
                                                      group, bs, int(fused))
                            assert got == want, (dtype, hd, S, group, bs,
                                                 fused)
