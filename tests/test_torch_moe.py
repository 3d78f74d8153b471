"""The port's switch-MoE family (kubedl_tpu_torch.models.moe) and its
training path against the JAX reference (kubedl_tpu.models.moe) on the
CPU, float32, at ``tiny-moe`` width. Inputs come from numpy with a seed;
JAX runs on the CPU.

Each check states its tolerance:

- presets: ``dataclasses.asdict`` equal to the reference's (dtype
  mapped), the parameter and FLOPs counts equal;
- ``moe_ffn`` (index dispatch) against the reference's ``moe_ffn`` with
  no drops, heavy drops (a zero router: everything to expert 0), the
  default capacity and drops from every expert: the routing choice
  equal token for token, ``out`` and ``aux`` within 1e-6 absolute (the
  expert products sum in another order; every dispatch and combine
  element is one product plus exact zeros on both sides);
- ``moe_ffn`` against the port's plain version (the reference's one-hot
  formula): the forward bit for bit; gradients to ``w_in`` / ``w_out``
  bit for bit, to ``x`` and the router within 1e-6 of the largest (the
  gate's gradient sums over D in another order);
- ``moe_forward`` / ``moe_loss`` against the reference on converted
  parameters, dense and flash routes: within 1e-5; loss gradients
  against ``jax.grad`` within 1e-4 of each leaf's largest;
- the port's ``Trainer`` against the JAX ``Trainer``: six losses and grad
  norms within 1e-4 relative, with and without ``grad_accum``; remat on
  against remat off: gradients equal;
- train-state checkpoints both ways: 3 steps, save, restore in the other
  package, 3 more steps, against the saving package's 6 continuous
  steps within 1e-4 relative; bf16 entries byte for byte.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubedl_tpu.models import moe as jm  # noqa: E402
from kubedl_tpu_torch.models import moe as tm  # noqa: E402
from kubedl_tpu_torch.training import checkpoint as tck  # noqa: E402
from kubedl_tpu_torch.training import trainer as tt  # noqa: E402
from kubedl_tpu_torch.training.data import SyntheticTokens  # noqa: E402

B, S = 2, 32


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ffn_inputs(seed=0, zero_router=False):
    """x [B, S, D], router [D, E], w_in [E, D, F], w_out [E, F, D] at
    tiny-moe width (fan-in scaled, as the init draws them)."""
    cfg = tm.TINY_MOE
    D, E, Fd = cfg.dim, cfg.n_experts, cfg.ffn_dim
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if zero_router:
        router[:] = 0.0
    w_in = (rng.standard_normal((E, D, Fd)) / np.sqrt(D)).astype(np.float32)
    w_out = (rng.standard_normal((E, Fd, D)) / np.sqrt(Fd)).astype(np.float32)
    return x, router, w_in, w_out


def _jax_choice(x, router):
    """The reference's routing lines (``moe.py:189-193``): its choice and
    the smallest gap between a token's top-1 and top-2 probability."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ jnp.asarray(router)).astype(jnp.float32),
                           axis=-1)
    top2 = np.sort(np.asarray(probs), axis=-1)[:, -2:]
    return np.asarray(probs.argmax(axis=-1)), float((top2[:, 1]
                                                     - top2[:, 0]).min())


#: (capacity_factor, zero router): cap = int(cf * 64 / 4) of 64 tokens;
#: "drops" routes over every expert with some of each queue dropped
FFN_CASES = {"no-drops": (4.0, False), "heavy-drops": (0.25, True),
             "default": (1.25, False), "drops": (0.5, False)}


@pytest.mark.parametrize("name", ["tiny-moe", "bench-moe"])
def test_presets_equal_the_references(name):
    mine, ref = tm.preset(name), jm.preset(name)
    a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
    assert a.pop("dtype") == getattr(torch, jnp.dtype(b.pop("dtype")).name)
    assert a == b
    assert mine.num_params() == ref.num_params()
    assert mine.flops_per_token() == ref.flops_per_token()
    assert mine.head_dim == ref.head_dim
    with pytest.raises(KeyError):
        tm.preset("moe-tiny")
    with pytest.raises(KeyError):
        jm.preset("moe-tiny")


@pytest.mark.parametrize("cf,zero", list(FFN_CASES.values()),
                         ids=list(FFN_CASES))
def test_moe_ffn_matches_reference(cf, zero):
    x, r, wi, wo = _ffn_inputs(zero_router=zero)
    jcfg = dataclasses.replace(jm.TINY_MOE, capacity_factor=cf)
    cfg = dataclasses.replace(tm.TINY_MOE, capacity_factor=cf)
    cap = tm.capacity(cfg, B * S, cfg.n_experts)
    assert cap == max(1, int(cf * B * S / cfg.n_experts))
    want_choice, gap = _jax_choice(x, r)
    print(f"cf {cf}: smallest top-1/top-2 probability gap {gap:.3e}")
    _, _, choice, pos, keep = tm.route(_t(x).reshape(B * S, -1), _t(r), cap)
    np.testing.assert_array_equal(choice.numpy(), want_choice)
    j_out, j_aux = jm.moe_ffn(*map(jnp.asarray, (x, r, wi, wo)), jcfg)
    out, aux = tm.moe_ffn(_t(x), _t(r), _t(wi), _t(wo), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-6)
    assert abs(float(aux) - float(j_aux)) <= 1e-6
    rows = int((out.reshape(B * S, -1).abs().sum(-1) > 0).sum())
    assert rows == int(keep.sum())
    if zero:  # uniform probabilities: every token picks expert 0
        assert rows == cap and int(choice.max()) == 0
    if cf == 4.0:
        assert bool(keep.all())
    if cf == 0.5:  # every expert takes tokens, and drops some
        assert int(choice.unique().numel()) == cfg.n_experts
        assert rows == cap * cfg.n_experts


@pytest.mark.parametrize("cf,zero", list(FFN_CASES.values()),
                         ids=list(FFN_CASES))
def test_index_dispatch_equals_one_hot_formula(cf, zero):
    cfg = dataclasses.replace(tm.TINY_MOE, capacity_factor=cf)
    arrays = _ffn_inputs(seed=1, zero_router=zero)
    w = _t(np.random.RandomState(2).standard_normal((B, S, cfg.dim)))
    runs = []
    for fn in (tm.moe_ffn, tm.moe_ffn_plain):
        ins = [_t(a).requires_grad_(True) for a in arrays]
        out, aux = fn(*ins, cfg)
        ((out * w).sum() + 3.0 * aux).backward()
        runs.append((out.detach(), aux.detach(), [t.grad for t in ins]))
    (o_i, a_i, g_i), (o_p, a_p, g_p) = runs
    assert torch.equal(o_i, o_p) and torch.equal(a_i, a_p)
    for name, a, b in zip(("x", "router", "w_in", "w_out"), g_i, g_p):
        if name in ("w_in", "w_out"):
            assert torch.equal(a, b), name
        else:
            assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name


class _RankOfSplit:
    """One rank of an expert=2 x tensor=2 split whose sums the test does
    itself: ``index`` is the rank's place, and every collective is left
    out (``size`` 1 makes ``copy_to`` / ``reduce_from`` the identity)."""

    def __init__(self, expert, tensor):
        self.coords = {"expert": expert, "tensor": tensor}

    def active(self, axes):
        return tuple(axes)

    def size(self, axes):
        return 1

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * 2 + self.coords[a]
        return i


def test_parallel_axes_raise():
    """The expert and tensor splits run (they raised before the
    multi-device slice): each rank of expert=2 (x tensor=2) routes on the
    full E, dispatches only its experts' tokens through its slice of the
    ffn columns, and the ranks' partial outputs sum to the unsplit layer
    (bit for bit over experts, where one rank holds each token's value;
    within 1e-6 over the tensor split's two halves of F); the aux loss
    is the unsplit one on every rank."""
    cfg = tm.TINY_MOE
    x, r, wi, wo = map(_t, _ffn_inputs(seed=4))
    want, want_aux = tm.moe_ffn(x, r, wi, wo, cfg)
    El, Fl = cfg.n_experts // 2, cfg.ffn_dim // 2
    for tensor in (1, 2):
        total = torch.zeros_like(want)
        for e, t in itertools.product(range(2), range(tensor)):
            mesh = _RankOfSplit(e, t)
            f = slice(t * Fl, (t + 1) * Fl) if tensor == 2 else slice(None)
            out, aux = tm.moe_ffn(
                x, r, wi[e * El:(e + 1) * El, :, f],
                wo[e * El:(e + 1) * El, f], cfg, ep_axis=(mesh, ("expert",)),
                tp_axis=(mesh, ("tensor",)) if tensor == 2 else None)
            assert torch.equal(aux, want_aux)
            total += out
        if tensor == 1:
            assert torch.equal(total, want)
        else:
            assert (total - want).abs().max() <= 1e-6


# ---- the model --------------------------------------------------------------------

def _jax_params(cfg=jm.TINY_MOE, seed=0):
    return jm.moe_init(jax.random.PRNGKey(seed), cfg)


def _tokens(seed=3, batch=B, seq=64):
    rng = np.random.RandomState(seed)
    return rng.randint(0, tm.TINY_MOE.vocab_size, (batch, seq)).astype(
        np.int32)


def _attn(route):
    from kubedl_tpu_torch.ops import flash_attention as tfa

    return tfa.make_flash_attention() if route == "flash" else None


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_forward_and_loss_match_reference(route):
    jp = _jax_params()
    tokens = _tokens()
    j_logits, j_aux = jm.moe_forward(jp, jnp.asarray(tokens), jm.TINY_MOE)
    j_loss = jm.moe_loss(jp, jnp.asarray(tokens), jm.TINY_MOE)
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tm.TINY_MOE,
                                  "cpu")
    tok = torch.from_numpy(tokens)
    logits, aux = tm.moe_forward(params, tok, tm.TINY_MOE, _attn(route))
    loss = tm.moe_loss(params, tok, tm.TINY_MOE, _attn(route))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=1e-5)
    assert abs(float(aux) - float(j_aux)) <= 1e-5
    assert abs(float(loss) - float(j_loss)) <= 1e-5


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_loss_gradients_match_jax_grad(route):
    jp = _jax_params(seed=1)
    tokens = _tokens(seed=4)
    j_grads = jax.grad(lambda p: jm.moe_loss(p, jnp.asarray(tokens),
                                             jm.TINY_MOE))(jp)
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tm.TINY_MOE,
                                  "cpu")
    tr = tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE, attn_impl=route),
                    device="cpu")
    _, grads = tr.value_and_grad(params, torch.from_numpy(tokens))
    want = jax.tree_util.tree_leaves(j_grads)  # dict keys sorted: same order
    assert len(grads) == len(want) == 12
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_remat_gives_the_same_gradients():
    """Remat replays each layer (routing included) in the backward under
    the "dots_flash" policy: the gradients equal the remat-off ones."""
    jp = _jax_params(seed=2)
    batch = torch.from_numpy(_tokens(seed=5))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tm.TINY_MOE, remat=remat)
        params = tm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
        tr = tt.Trainer(tt.TrainConfig(model=cfg, attn_impl="flash"),
                        device="cpu")
        grads[remat] = tr.value_and_grad(params, batch)
    (l0, g0), (l1, g1) = grads[False], grads[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# ---- the trainer --------------------------------------------------------------------

def _jax_trainer(**kw):
    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    return jt.Trainer(jt.TrainConfig(model=jm.TINY_MOE, attn_impl="dense",
                                     **kw), mesh)


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "grad_accum2"])
def test_trainer_reproduces_jax_trajectory(accum):
    """Six steps from the same parameters and batches: the JAX trainer
    (dense) and the port's (flash operators' plain versions): every loss
    and grad norm within 1e-4 relative. With grad_accum 2 each
    microbatch routes its own 64 tokens (cap from the microbatch)."""
    kw = dict(global_batch=4, seq_len=32, steps=6, warmup_steps=2,
              learning_rate=1e-2, grad_accum=accum)
    jtr = _jax_trainer(**kw)
    jstate = jtr.init_state()
    ttr = tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE, attn_impl="flash",
                                    **kw), device="cpu")
    assert ttr.family.name == "moe" and ttr.attn_impl == "flash"
    tstate = ttr.init_state()
    tstate["params"] = tm.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), tm.TINY_MOE, "cpu")
    tstate["opt_state"] = ttr.tx.init(tt.tree_leaves(tstate["params"]))
    data = SyntheticTokens(4, 32, tm.TINY_MOE.vocab_size, seed=7)
    for _ in range(6):
        batch = next(data)
        jstate, jmet = jtr.train_step(jstate, jtr.shard_batch(batch))
        tstate, tmet = ttr.train_step(tstate, batch)
        for key in ("loss", "grad_norm"):
            a, b = float(tmet[key]), float(jmet[key])
            assert abs(a - b) <= 1e-4 * abs(b), (key, a, b)
    assert tstate["step"] == 6


# ---- checkpoints across the packages ------------------------------------------------

KW = dict(global_batch=2, seq_len=32, steps=6, warmup_steps=2,
          learning_rate=1e-2, log_every=1)


def _port_trainer():
    return tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE, **KW), device="cpu")


def _data(skip=0):
    it = iter(SyntheticTokens(2, 32, tm.TINY_MOE.vocab_size, seed=7))
    for _ in range(skip):
        next(it)
    return it


def _losses(summary):
    return [summary["first_loss"]] + [v for _, v in summary["loss_log"]] \
        + [summary["final_loss"]]


def _keystrs(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_train_state_tree_has_the_references_keys():
    jstate = _jax_trainer(**KW).init_state()
    state = _port_trainer().init_state()
    tree = tck.train_state_tree(state)
    assert [k for k, _ in tck._leaf_items(tree)] == _keystrs(jstate)
    shapes = {k: tuple(v.shape) for k, v in tck._leaf_items(tree)
              if isinstance(v, torch.Tensor)}
    jshapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert all(jshapes[k] == s for k, s in shapes.items())
    E, D, Fd = (tm.TINY_MOE.n_experts, tm.TINY_MOE.dim, tm.TINY_MOE.ffn_dim)
    assert shapes["['params']['layers']['w_in']"] == (2, E, D, Fd)
    assert shapes["['opt_state'][1][0].mu['layers']['w_out']"] == (2, E, Fd, D)


def test_port_resumes_the_references_checkpoint(tmp_path):
    """The JAX trainer saves step 3; the port restores it and trains steps
    4-6 on the stream's batches 3-5: the losses equal the JAX trainer's
    own 6 continuous steps' last three within 1e-4 relative."""
    from kubedl_tpu.training import checkpoint as jck

    jtr = _jax_trainer(**KW)
    _, jfull = jtr.fit(_data())
    jtr.fit(_data(), steps=3, ckpt_dir=str(tmp_path))
    assert jck.latest_step(str(tmp_path)) == 3
    tr = _port_trainer()
    restored = tck.restore_checkpoint(
        str(tmp_path), tck.train_state_like(tr.init_state()), device="cpu")
    state = tck.train_state_from_tree(restored)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    _, tsum = tr.fit(_data(skip=3), state=state)
    assert tsum["start_step"] == 3 and tsum["steps"] == 3
    np.testing.assert_allclose(_losses(tsum), _losses(jfull)[3:], rtol=1e-4)


def test_reference_resumes_the_ports_checkpoint(tmp_path):
    from kubedl_tpu.training import checkpoint as jck

    _, tfull = _port_trainer().fit(_data())
    tr = _port_trainer()
    tr.fit(_data(), steps=3, ckpt_dir=str(tmp_path))
    assert tck.latest_step(str(tmp_path)) == 3
    jtr = _jax_trainer(**KW)
    jstate = jck.restore_checkpoint(str(tmp_path), jtr.init_state())
    assert int(jstate["step"]) == 3
    _, jsum = jtr.fit(_data(skip=3), state=jstate)
    assert jsum["start_step"] == 3
    np.testing.assert_allclose(_losses(jsum), _losses(tfull)[3:], rtol=1e-4)


def test_bf16_moe_entries_are_the_references_bytes(tmp_path):
    """bf16 MoE parameters: the port writes the reference's manifest and
    the same two-byte entries, and restores the reference's."""
    from kubedl_tpu.training import checkpoint as jck

    jcfg = dataclasses.replace(jm.TINY_MOE, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(tm.TINY_MOE, dtype=torch.bfloat16)
    jp = _jax_params(jcfg)
    jck.save_checkpoint(str(tmp_path / "ref"), {"params": jp}, 1)
    mine = tm.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), cfg,
        "cpu")
    tck.save_checkpoint(str(tmp_path / "port"), {"params": mine}, 1)
    metas = [json.loads((tmp_path / d / "step-00000001" / "meta.json")
                        .read_text()) for d in ("ref", "port")]
    assert metas[0] == metas[1]
    zr = np.load(tmp_path / "ref" / "step-00000001" / "shards-p0.npz")
    zp = np.load(tmp_path / "port" / "step-00000001" / "shards-p0.npz")
    assert sorted(zr.files) == sorted(zp.files)
    for k in zr.files:
        assert zr[k].dtype.itemsize == zp[k].dtype.itemsize == 2
        assert zr[k].tobytes() == zp[k].tobytes(), k
    got = tck.restore_checkpoint(str(tmp_path / "ref"),
                                 {"params": tm.param_like(cfg)}, device="cpu")
    for (_, a), (_, b) in zip(tck._leaf_items(got),
                              tck._leaf_items({"params": mine})):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---- the entry point ------------------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    from kubedl_tpu_torch.training import entry

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)


def test_train_main_trains_tiny_moe(capsys, clean_env, tmp_path):
    """``train_main`` with "tiny-moe" on the CPU: one worker summary with
    finite losses from the MoE family; the published state is the
    reference's tree, which the JAX package restores."""
    from kubedl_tpu.training import checkpoint as jck
    from kubedl_tpu_torch.training import entry

    cfg = {"model": "tiny-moe", "steps": 3, "seq_len": 32,
           "global_batch": 2, "device": "cpu", "attn_impl": "flash",
           "remat_policy": "dots", "loss_chunk": 16}
    out = tmp_path / "model"
    assert entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg),
                             "KUBEDL_MODEL_PATH": str(out)}) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"worker_summary"')]
    assert len(lines) == 1
    s = json.loads(lines[0])["worker_summary"]
    assert s["model_family"] == "moe" and s["steps"] == 3
    assert s["n_params"] == tm.TINY_MOE.num_params()
    assert np.isfinite(s["first_loss"]) and np.isfinite(s["final_loss"])
    assert s["attn_impl"] == "flash" and s["sanity_violations"] == []
    assert s["long_context_policy"] == ""
    jstate = jck.restore_checkpoint(str(out), _jax_trainer(**KW).init_state())
    assert int(jstate["step"]) == 3


def test_fit_on_a_repeated_batch_lowers_the_loss():
    tr = tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE, global_batch=4,
                                   seq_len=32, steps=8, warmup_steps=1,
                                   learning_rate=1e-2, attn_impl="flash"),
                    device="cpu")
    batch = next(iter(SyntheticTokens(4, 32, tm.TINY_MOE.vocab_size)))
    _, summary = tr.fit(itertools.repeat(batch))
    assert summary["final_loss"] < summary["first_loss"]
    assert summary["sanity_violations"] == []
