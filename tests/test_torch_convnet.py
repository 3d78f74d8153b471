"""The port's convnet family (``kubedl_tpu_torch/models/convnet.py``)
against ``kubedl_tpu/models/convnet.py`` on the CPU.

Parameters are the reference's ``convnet_init`` carried over as they are
(the port keeps the HWIO / ``[flat, hidden]`` tree); batches are the
reference's ``SyntheticDigits`` draws. Tolerances, float32:

- the forward's logits within 1e-5 max abs; the loss within 1e-6
  relative and every gradient within 1e-5 of its leaf's largest
  magnitude (convolutions summed in another order);
- ``fit`` over 20 steps: each step's loss within 1e-4 relative, the final
  parameters within 1e-4 of each leaf's largest magnitude;
- the port's own ``SyntheticDigits`` (the same task drawn with
  ``torch.Generator``): held-out accuracy above 0.9 after ``fit``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubedl_tpu_torch.models import convnet as tc  # noqa: E402

LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5
FIT_RTOL = 1e-4

CONFIGS = {
    "width8": dict(width=8, hidden=16),
    "rgb16": dict(image_size=16, channels=3, classes=5, width=4, hidden=8),
    "odd": dict(image_size=14, width=4, hidden=8),  # a 7x7 map pools to 3x3
}


def _both(**kw):
    from kubedl_tpu.models import convnet as jc

    return jc, jc.ConvNetConfig(**kw), tc.ConvNetConfig(**kw)


def _carry(jparams):
    return {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}


def test_config_matches_reference():
    from kubedl_tpu.models import convnet as jc

    mine = dataclasses.asdict(tc.ConvNetConfig())
    ref = dataclasses.asdict(jc.ConvNetConfig())
    assert mine.pop("dtype") == torch.float32
    assert str(ref.pop("dtype").__name__) == "float32"
    assert mine == ref


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_tree_matches_reference(name):
    import jax

    jc, jcfg, tcfg = _both(**CONFIGS[name])
    jp = jc.convnet_init(jax.random.PRNGKey(0), jcfg)
    tp = tc.convnet_init(torch.Generator().manual_seed(0), tcfg)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert tp[k].dtype == torch.float32
    # He-normal: each kernel's spread near sqrt(2 / fan_in), biases zero
    assert float(tp["dense"].std()) == pytest.approx(
        float(np.asarray(jp["dense"]).std()), rel=0.2)
    assert not any(float(tp[b].abs().max()) for b in ("b1", "b2", "b3", "b4"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_loss_match_reference(name):
    import jax
    import jax.numpy as jnp

    jc, jcfg, tcfg = _both(**CONFIGS[name])
    jp = jc.convnet_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    imgs = rng.rand(6, jcfg.image_size, jcfg.image_size,
                    jcfg.channels).astype(np.float32)
    labels = rng.randint(0, jcfg.classes, size=6).astype(np.int32)
    want = np.asarray(jc.convnet_forward(jp, jnp.asarray(imgs), jcfg))
    tp = _carry(jp)
    got = tc.convnet_forward(tp, torch.tensor(imgs), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() < LOGIT_TOL
    jl, jg = jax.value_and_grad(jc.convnet_loss)(
        jp, (jnp.asarray(imgs), jnp.asarray(labels)), jcfg)
    for p in tp.values():
        p.requires_grad_(True)
    loss = tc.convnet_loss(tp, (torch.tensor(imgs), torch.tensor(labels)),
                           tcfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    for k, g in jg.items():
        g = np.asarray(g)
        assert np.abs(tp[k].grad.numpy() - g).max() <= \
            GRAD_TOL * max(np.abs(g).max(), 1e-30), k
    assert tc.accuracy(tp, imgs, labels, tcfg) == pytest.approx(
        jc.accuracy(jp, imgs, labels, jcfg))


def test_fit_matches_reference_step_by_step():
    """20 steps on batches materialised from the reference's
    SyntheticDigits, from its init: the reference's loop (``fit``'s body,
    jitted once) gives each step's loss; the port's ``fit`` run for k
    steps from the same start gives its k-th."""
    import jax
    import optax

    jc, jcfg, tcfg = _both(width=4, hidden=16)
    steps, lr = 20, 3e-3
    data = jc.SyntheticDigits(jcfg, batch=32)
    batches = [tuple(np.asarray(a) for a in next(data)) for _ in range(steps)]
    jp0 = jc.convnet_init(jax.random.PRNGKey(0), jcfg)
    tx = optax.adam(lr)

    @jax.jit
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(jc.convnet_loss)(params, batch, jcfg)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    jp, opt, want = jp0, tx.init(jp0), []
    for b in batches:
        jp, opt, loss = step(jp, opt, b)
        want.append(float(loss))
    _, summary = jc.fit(jcfg, iter(batches), steps=steps, learning_rate=lr,
                        params=jp0)
    assert summary["final_loss"] == pytest.approx(want[-1], rel=1e-6)
    got = []
    for k in range(1, steps + 1):
        tp, s = tc.fit(tcfg, iter([tuple(map(torch.tensor, b))
                                   for b in batches]),
                       steps=k, learning_rate=lr, params=_carry(jp0))
        assert s["first_loss"] == pytest.approx(want[0], rel=FIT_RTOL)
        got.append(s["final_loss"])
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)
    for k, v in jp.items():
        v = np.asarray(v)
        assert np.abs(tp[k].numpy() - v).max() <= \
            FIT_RTOL * np.abs(v).max(), k
        assert not tp[k].requires_grad


def test_fit_leaves_the_callers_params_as_they_were():
    """``fit(params=p)`` trains a copy: ``p`` is equal before and after,
    the returned tree is another, and the losses are those of a run from
    its own copy of the same start."""
    cfg = tc.ConvNetConfig(width=8, hidden=32)
    p = tc.convnet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    before = {k: v.clone() for k, v in p.items()}

    def run(params):
        data = tc.SyntheticDigits(cfg, 16, device="cpu")
        return tc.fit(cfg, data, steps=3, params=params)

    out, summary = run(p)
    assert out is not p
    for k, v in p.items():
        assert torch.equal(v, before[k]), k
        assert not torch.equal(out[k], v), k
    _, again = run({k: v.clone() for k, v in before.items()})
    assert summary == again


def test_synthetic_digits_is_the_reference_task():
    cfg = tc.ConvNetConfig(width=8, hidden=32)
    a = tc.SyntheticDigits(cfg, batch=16, seed=0, device="cpu")
    b = tc.SyntheticDigits(cfg, batch=16, seed=7, device="cpu")
    # the templates are the task: uniform, fixed by template_seed alone
    assert torch.equal(a.templates, b.templates)
    assert tuple(a.templates.shape) == (10, 28, 28, 1)
    assert 0.0 <= float(a.templates.min()) and float(a.templates.max()) < 1.0
    imgs, labels = next(a)
    assert tuple(imgs.shape) == (16, 28, 28, 1)
    assert imgs.dtype == torch.float32 and labels.dtype == torch.int32
    assert 0 <= int(labels.min()) and int(labels.max()) < 10
    # noise x N(0, 1) around each image's class template
    resid = imgs - a.templates[labels.long()]
    assert float(resid.std()) == pytest.approx(0.3, rel=0.1)
    # ``seed`` drives the stream; the same seed draws the same batches
    again = next(tc.SyntheticDigits(cfg, batch=16, seed=0, device="cpu"))
    assert torch.equal(again[0], imgs) and torch.equal(again[1], labels)
    assert not torch.equal(next(b)[0], imgs)


def test_converges_on_its_own_synthetic_digits():
    """The reference's convergence check (``tests/test_models.py``'s
    width 8 / hidden 32, batch 64, accuracy > 0.9 on 256 held-out draws)
    on the port's own data, with ``fit``'s defaults (seed 0, learning
    rate 1e-3) over 200 steps. At the reference test's 3e-3 for 120
    steps both packages' loops stall from some seed pairs (a sweep of
    4 init x 2 data seeds: 3 of 8 in each), so this check runs at
    ``fit``'s own rate, which is also the card's phase 28."""
    cfg = tc.ConvNetConfig(width=8, hidden=32)
    data = tc.SyntheticDigits(cfg, batch=64, device="cpu")
    params, s = tc.fit(cfg, iter(data), steps=200, device="cpu")
    assert s["final_loss"] < s["first_loss"]
    imgs, labels = next(tc.SyntheticDigits(cfg, 256, seed=7, device="cpu"))
    acc = tc.accuracy(params, imgs, labels, cfg)
    assert acc > 0.9, acc  # chance is 0.1


def test_fit_and_data_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tc.ConvNetConfig(width=4, hidden=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.SyntheticDigits(cfg, batch=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.fit(cfg, iter([]), steps=1)
