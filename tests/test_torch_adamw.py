"""The port's optimizer-update operator (kubedl_tpu_torch/ops/adamw.py).

On the CPU: the host scalars carry the constants XLA folds into the
reference's compiled update (a Python scalar rounded to the tensor's
type), the operator updates in place and returns ``[norm, S_i]``,
and it rejects what neither implementation takes. The plain version
against the jitted optax chain is
``tests/test_torch_training.py::test_optimizer_matches_jitted_optax_chain``.

On the card (``cuda`` marker, skipped without one): the kernels against
the plain version on the same inputs. At a step that does not clip, p,
mu and nu must be BIT-identical (the kernels do the plain version's
float32 operations in its order); where it clips, bit-identical when
the two norms agree (they sum in other orders, so the float32 leaf sums
may differ in their last bits; a bf16 norm usually absorbs that), and
else within one bf16 ulp (2^-7 relative) for bf16 entries and 1e-5
relative for float32 ones. The leaf sums within 1e-6 relative; two calls
give the same bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.ops import adamw  # noqa: E402

HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _leaves(shapes, p_dtype, mu_dtype, grad_scale, seed, device="cpu"):
    rng = np.random.RandomState(seed)

    def t(arr, dtype):
        return torch.tensor(arr.astype(np.float32)).to(device, dtype)

    ps = [t(rng.standard_normal(s) * 0.02, p_dtype) for s in shapes]
    gs = [t(rng.standard_normal(s) * grad_scale, p_dtype) for s in shapes]
    mus = [t(rng.standard_normal(s) * 1e-3, mu_dtype) for s in shapes]
    nus = [t(np.abs(rng.standard_normal(s)) * 1e-6, p_dtype) for s in shapes]
    return gs, ps, mus, nus


def test_step_scalars_carry_xlas_constants():
    """The constants the reference's compiled update uses (read from its
    optimized HLO on the CPU): bf16(0.1) = 0.100097656, bf16(0.05) =
    0.0500488281, bf16(0.95) = 0.94921875, bf16(1e-8) = 1.00117177e-08,
    a bf16 first moment's bf16(0.9) = 0.8984375; float32 otherwise."""
    bf, f32 = torch.bfloat16, torch.float32
    c = adamw.step_scalars(3e-4, 5, 0.9, 0.95, 1e-8, 0.1, 1.0, bf, f32, bf)
    assert (c.a1, c.d1, c.a2, c.d2) == (0.10009765625, 0.8999999761581421,
                                        0.05004882812500, 0.94921875)
    assert abs(c.eps - 1.00117177e-08) < 1e-15 and c.wd == 0.10009765625
    assert c.bc1 == float(torch.tensor(1.0) - torch.tensor(0.9) ** 5)
    assert c.bc2 == float((1.0 - torch.tensor(0.95) ** 5).to(bf))
    assert c.neg_lr == float(torch.tensor(-3e-4, dtype=f32))
    b = adamw.step_scalars(3e-4, 5, 0.9, 0.95, 1e-8, 0.1, 1.0, bf, bf, bf)
    assert b.d1 == 0.8984375 and b.neg_lr == float(torch.tensor(-3e-4).to(bf))
    f = adamw.step_scalars(3e-4, 5, 0.9, 0.95, 1e-8, 0.1, 1.0, f32, f32, f32)
    assert f.a1 == float(torch.tensor(0.1)) and f.eps == float(
        torch.tensor(1e-8))


@pytest.mark.parametrize("pd,md", [(torch.bfloat16, torch.float32),
                                   (torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16)])
def test_update_in_place_and_stats(pd, md):
    shapes = [(4, 8), (9,), (3, 5, 7)]
    gs, ps, mus, nus = _leaves(shapes, pd, md, 1.0, 0)
    ids = [id(t) for t in ps + mus + nus]
    before = [p.clone() for p in ps]
    stats = adamw.adamw_update(gs, ps, mus, nus, lr=1e-2, t=3, clip=1.0,
                               **HP)
    assert [id(t) for t in ps + mus + nus] == ids
    assert all(not torch.equal(a, b) for a, b in zip(ps, before))
    assert stats.shape == (1 + len(shapes),) and stats.dtype == torch.float32
    sums = [g.float().square().sum() for g in gs]
    assert torch.allclose(stats[1:], torch.stack(sums), rtol=1e-6)
    want = torch.sqrt(sum(sums))
    assert abs(float(stats[0]) - float(want)) <= 2**-7 * float(want)
    assert [m.dtype for m in mus] == [md] * 3
    assert [v.dtype for v in nus] == [pd] * 3


def test_zero_learning_rate_moves_nothing():
    gs, ps, mus, nus = _leaves([(16, 16)], torch.bfloat16, torch.float32,
                               3.0, 1)
    before = ps[0].clone()
    adamw.adamw_update(gs, ps, mus, nus, lr=0.0, t=1, clip=1.0, **HP)
    assert torch.equal(ps[0], before)


def test_clip_scales_the_gradient():
    """A clipped step equals the same step on the gradient pre-scaled to
    norm ``clip`` (float32: the scale is exact up to float32 rounding)."""
    shapes = [(32, 8), (8,)]
    gs, ps, mus, nus = _leaves(shapes, torch.float32, torch.float32, 5.0, 2)
    norm = float(torch.sqrt(sum(g.square().sum() for g in gs)))
    assert norm > 1.0
    ps2, mus2, nus2 = ([t.clone() for t in x] for x in (ps, mus, nus))
    adamw.adamw_update(gs, ps, mus, nus, lr=1e-2, t=2, clip=1.0, **HP)
    scaled = [g / norm for g in gs]
    adamw.adamw_update(scaled, ps2, mus2, nus2, lr=1e-2, t=2, clip=1.0,
                       **HP)
    for a, b in zip(ps + mus + nus, ps2 + mus2 + nus2):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-9)


def test_update_rejects_mismatches():
    gs, ps, mus, nus = _leaves([(4, 4)], torch.float32, torch.float32, 1.0, 3)
    kw = dict(lr=1e-3, t=1, clip=1.0, **HP)
    with pytest.raises(ValueError, match="equal"):
        adamw.adamw_update(gs, ps, mus, [], **kw)
    with pytest.raises(ValueError, match="share a type"):
        adamw.adamw_update([gs[0].bfloat16()], ps, mus, nus, **kw)
    with pytest.raises(ValueError, match="shapes"):
        adamw.adamw_update([gs[0].T.contiguous()[:2]], ps, mus, nus, **kw)
    with pytest.raises(ValueError, match="tensors on"):
        adamw.adamw_update(gs, ps, [mus[0].to("meta")], nus, **kw)


@pytest.mark.parametrize("n,blocks", [(1, 1), (8, 1), (2048, 1), (2049, 2),
                                      (262_668_288, 528)])
def test_norm_blocks(n, blocks):
    assert adamw.norm_blocks(n) == blocks


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: leaf shapes: a tail that is not a multiple of 8, a one-element leaf, a
#: leaf larger than the norm's CTA cap covers in one sweep
CARD_SHAPES = [(64, 128), (1000,), (3, 5, 7), (1,), (2048, 1100)]
DTYPES = [(torch.bfloat16, torch.float32), (torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)]


def _run(gs, ps, mus, nus, clip, plain):
    ps, mus, nus = ([t.clone() for t in x] for x in (ps, mus, nus))
    if plain:
        scal = [adamw.step_scalars(1e-2, 7, 0.9, 0.95, 1e-8, 0.1, clip,
                                   p.dtype, m.dtype,
                                   adamw._chain_dtype([g.dtype for g in gs]))
                for p, m in zip(ps, mus)]
        stats = adamw.adamw_update_plain(gs, ps, mus, nus, scal)
    else:
        stats = adamw.adamw_update(gs, ps, mus, nus, lr=1e-2, t=7, clip=clip,
                                   **HP)
    torch.cuda.synchronize()
    return stats, ps, mus, nus


@pytest.mark.cuda
@pytest.mark.parametrize("pd,md", DTYPES,
                         ids=[f"{p}-mu_{m}".replace("torch.", "")
                              for p, m in DTYPES])
@pytest.mark.parametrize("clipped", [False, True], ids=["keep", "clip"])
def test_cuda_adamw_matches_plain(cuda, pd, md, clipped):
    gs, ps, mus, nus = _leaves(CARD_SHAPES, pd, md, 0.3 if clipped else 1e-4,
                               11, cuda)
    before = dict(adamw.LAUNCHES)
    s_k, p_k, m_k, v_k = _run(gs, ps, mus, nus, 1.0, plain=False)
    L = len(CARD_SHAPES)
    assert adamw.LAUNCHES["adamw_norm"] == before["adamw_norm"] + L
    assert adamw.LAUNCHES["adamw_update"] == before["adamw_update"] + L
    assert adamw.LAUNCHES["adamw_norm_finish"] == \
        before["adamw_norm_finish"] + 1
    s_p, p_p, m_p, v_p = _run(gs, ps, mus, nus, 1.0, plain=True)
    assert (float(s_k[0]) >= 1.0) == clipped == (float(s_p[0]) >= 1.0)
    assert torch.allclose(s_k[1:], s_p[1:], rtol=1e-6, atol=0)
    exact = not clipped or torch.equal(s_k[0], s_p[0])
    for a, b in zip(p_k + m_k + v_k, p_p + m_p + v_p):
        if exact:
            assert torch.equal(a, b)
        else:
            rtol = 2**-7 if a.dtype == torch.bfloat16 else 1e-5
            assert torch.allclose(a.float(), b.float(), rtol=rtol, atol=1e-12)
    again = _run(gs, ps, mus, nus, 1.0, plain=False)
    for a, b in zip([s_k] + p_k + m_k + v_k,
                    [again[0]] + again[1] + again[2] + again[3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_adamw_unaligned_views(cuda):
    """Leaves at an odd element offset take the scalar path: the same bits
    as the plain version."""
    base = _leaves([(4099,)], torch.bfloat16, torch.float32, 1e-4, 12, cuda)
    gs, ps, mus, nus = ([t[0][3:]] for t in base)
    s_k, p_k, m_k, v_k = _run(gs, ps, mus, nus, 1.0, plain=False)
    s_p, p_p, m_p, v_p = _run(gs, ps, mus, nus, 1.0, plain=True)
    for a, b in zip(p_k + m_k + v_k, p_p + m_p + v_p):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_adamw_norm_blocks_match_source(cuda):
    from kubedl_tpu_torch.ops.build import load_adamw_kernels

    lib = load_adamw_kernels()
    for n in (1, 8, 2048, 2049, 1 << 20, 262_668_288):
        assert lib.kdl_adamw_norm_blocks(n) == adamw.norm_blocks(n)


@pytest.mark.cuda
def test_cuda_adamw_rejects_non_contiguous(cuda):
    gs, ps, mus, nus = _leaves([(8, 8)], torch.float32, torch.float32, 1.0,
                               13, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.adamw_update([gs[0].T], [ps[0].T], [mus[0].T], [nus[0].T],
                           lr=1e-3, t=1, clip=1.0, **HP)
