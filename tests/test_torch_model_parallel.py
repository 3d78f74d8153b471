"""The model sharded across processes in the port — ``fsdp``, the Megatron
``tensor`` split and ``sp`` (ring / Ulysses) sequence parallelism
(``parallel/mesh.py``'s collectives, ``parallel/ring.py``,
``models/llama.py``'s ``TrainShard``, ``training/trainer.py``,
``training/checkpoint.py``, ``train_main``) — against the JAX package on
the CPU.

The ranks are gloo processes (``tests/torch_dist_worker.py``, started by
``parallel/launch.py``), held against the reference on the same mesh of
conftest's forced host devices, from the reference's initial parameters
(saved by the reference, restored whole by each rank, which keeps its
shards) on the same ``SyntheticTokens`` batches. Every rank job of the
trajectory cases starts when the module's first such case runs, so they
train side by side while the reference compiles.

Tolerances, float32, ``tiny``:

- context attention (``sp=2``, ring and Ulysses, causal and not): the
  output and the q/k/v gradients within 1e-5 (absolute and relative) of
  the reference's ``make_context_attention``;
- ``param_pspecs`` equal to the reference's specs, and each rank's
  shards equal to the reference's ``NamedSharding`` shards, bit for bit;
- the 6-step loss and grad-norm trajectory within 1e-4 relative of the
  reference ``Trainer`` on the same mesh (``fsdp=2``, ``tensor=2``,
  ``sp=2`` ring and Ulysses, ``data=2 x sp=2``, ``fsdp=2 x tensor=2``),
  the same on every rank; the final params, assembled from the shards,
  within 1e-4 absolute of the reference's; ``opt_state_bytes_per_device``
  equal to the reference's ``state_bytes_per_device``;
- checkpoints both ways at ``fsdp=2`` and ``tensor=2``: the restored
  tensors equal to the saved ones bit for bit, the continued trajectory
  within 1e-4; the ``fsdp=2`` save restored at world 1 by both packages,
  bit for bit;
- ``train_main`` as 2 processes at ``fsdp=2``, then a world-1 resume;
- the divisibility errors: the reference's message.

The reference's ``data=4 x fsdp=2`` mesh is not used: its partitioner
miscompiles it (``kubedl_tpu/training/trainer.py:359-366``).
"""

import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, __import__("os").path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402

RTOL = 1e-4
ATTN_TOL = 1e-5
KW = dict(global_batch=4, seq_len=32, steps=6, warmup_steps=2,
          learning_rate=1e-2)

#: id -> (mesh, TrainConfig overrides): the trajectory cases
MESHES = {
    "fsdp2": ({"fsdp": 2}, {}),
    "tensor2": ({"tensor": 2}, {}),
    "sp2-ring": ({"sp": 2}, {"context_parallel_impl": "ring"}),
    "sp2-ulysses": ({"sp": 2}, {"context_parallel_impl": "ulysses"}),
    "data2-sp2": ({"data": 2, "sp": 2}, {}),
    "fsdp2-tensor2": ({"fsdp": 2, "tensor": 2}, {}),
}


def _jax_mesh(axes):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.parallel.mesh import build_mesh

    n = int(np.prod(list(axes.values())))
    return build_mesh(MeshSpec(dict(axes)), jax.devices()[:n])


def _jax_trainer(mesh_axes, model="tiny", **kw):
    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.training import trainer as jt

    cfg = jt.TrainConfig(model=jl.preset(model), attn_impl="dense",
                         **dict(KW, **kw))
    return jt.Trainer(cfg, _jax_mesh(mesh_axes))


def _jax_steps(jtr, jstate, n, skip=0):
    """``n`` steps of the reference on the stream the ranks read (its
    first ``skip`` batches passed over); (state, [[loss, norm]])."""
    from kubedl_tpu_torch.training.data import SyntheticTokens

    data = SyntheticTokens(KW["global_batch"], KW["seq_len"],
                           jtr.family.vocab_size, seed=7)
    for _ in range(skip):
        next(data)
    out = []
    for _ in range(n):
        jstate, m = jtr.train_step(jstate, jtr.shard_batch(next(data)))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return jstate, out


def _save_init(jstate, path):
    from kubedl_tpu.training import checkpoint as jck

    jck.save_checkpoint(str(path), {"params": jstate["params"]}, 0)
    return str(path)


def _world(mesh):
    return math.prod(mesh.values())


def _start(spec, world):
    return w.start_ranks([sys.executable, w.__file__, json.dumps(spec)],
                         world)


def _results(spec, procs):
    w.join_ranks(procs)
    return [json.load(open(f"{spec['out']}-{r}.json"))
            for r in range(len(procs))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL)


# ---- context attention ---------------------------------------------------------

ATTN = dict(B=2, S=64, H=4, KV=2, hd=16)


@pytest.fixture(scope="module")
def attention_ranks(tmp_path_factory):
    """One 2-rank job (sp=2) that runs every attention case."""
    spec = {"attention": ATTN, "mesh": {"sp": 2},
            "out": str(tmp_path_factory.mktemp("attn") / "rank")}
    w.join_ranks(_start(spec, 2))
    return [dict(np.load(f"{spec['out']}-{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("impl,causal", [
    ("ring", True), ("ring", False), ("ulysses", True), ("ulysses", False),
], ids=["ring-causal", "ring-full", "ulysses-causal", "ulysses-full"])
def test_context_attention_matches_reference(impl, causal, attention_ranks):
    """Each rank's block of the output and of the q/k/v gradients of
    ``sum(out * w)`` against the reference's ``make_context_attention`` on
    an sp=2 mesh (the worker also holds the direct functions against the
    wrapper, bit for bit)."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.parallel import ring as jring

    q, k, v, wt = map(jnp.asarray, w.attention_inputs(**ATTN))
    attn = jring.make_context_attention(_jax_mesh({"sp": 2}), impl=impl,
                                        causal=causal)

    def f(q, k, v):
        return (attn(q, k, v) * wt).sum()

    out = np.asarray(jax.jit(attn)(q, k, v))
    grads = [np.asarray(g) for g in jax.jit(jax.grad(f, (0, 1, 2)))(q, k, v)]
    Sl = ATTN["S"] // 2
    for r, got in enumerate(attention_ranks):
        for name, want in zip(("out", "dq", "dk", "dv"), [out] + grads):
            np.testing.assert_allclose(
                got[f"{impl}/{causal}/{name}"], want[:, r * Sl:(r + 1) * Sl],
                atol=ATTN_TOL, rtol=ATTN_TOL, err_msg=f"rank {r} {name}")


def test_context_attention_checks_as_reference():
    """No sp axis: None; an unknown impl, a mask or another causal flag
    raise (as the reference's wrapper does)."""
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.parallel import ring
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh

    assert ring.make_context_attention(None) is None
    assert ring.make_context_attention({"data": 2}) is None
    with pytest.raises(ValueError, match="unknown context-parallel impl"):
        ring.make_context_attention({"sp": 2}, impl="star")
    mesh = ProcessMesh(MeshSpec({"sp": 2}), torch.device("cpu"), alone=True)
    fn = ring.make_context_attention(mesh, causal=True)
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="arbitrary masks"):
        fn(x, x, x, mask=torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="causal=True"):
        fn(x, x, x, causal=False)
    with pytest.raises(ValueError, match="divisible"):
        ring.ulysses_attention(torch.zeros(1, 4, 3, 8),
                               torch.zeros(1, 4, 3, 8),
                               torch.zeros(1, 4, 3, 8), mesh)


# ---- parameter specs and shards --------------------------------------------------

def test_param_pspecs_and_shards_match_reference():
    """``param_pspecs`` is the reference's tree of specs; on an fsdp=2 x
    tensor=2 mesh each rank's shards (``TrainShard.shard``) are the
    reference's ``NamedSharding`` shards of the same leaves, and
    ``regions`` says where they sit."""
    import jax
    from jax.sharding import NamedSharding

    from kubedl_tpu.models import llama as jl
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh

    for name in ("tiny", "tiny-gemma"):
        want = jax.tree_util.tree_leaves_with_path(
            jl.param_pspecs(jl.preset(name)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = dict(tl.named_leaves(tl.param_pspecs(tl.preset(name))))
        assert len(got) == len(want)
        for path, spec in want:
            key = "/".join(k.key for k in path)
            assert got[key] == tuple(spec), key
    axes = {"fsdp": 2, "tensor": 2}
    jmesh = _jax_mesh(axes)
    jparams = jl.llama_init(jax.random.PRNGKey(0), jl.TINY)
    specs = jl.param_pspecs(jl.TINY)
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)), jparams,
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    whole = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 tl.TINY, "cpu")
    devices = list(jmesh.devices.flat)
    for rank in range(4):
        mesh = ProcessMesh(MeshSpec(axes), torch.device("cpu"), alone=True)
        mesh.rank = rank
        mesh.coords = dict(zip(mesh.axis_names, divmod(rank, 2)))
        shard = tl.TrainShard(tl.TINY, mesh)
        mine = dict(tl.named_leaves(shard.shard(whole)))
        regions = dict(zip([n for n, _ in tl.named_leaves(whole)],
                           shard.regions(whole)))
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            key = "/".join(k.key for k in path)
            ref = next(s for s in leaf.addressable_shards
                       if s.device == devices[rank])
            np.testing.assert_array_equal(mine[key].numpy(),
                                          np.asarray(ref.data), err_msg=key)
            r = regions[key]
            idx = tuple(slice(0, n) for n in leaf.shape) if r is None \
                else r.index
            assert [(s.start or 0, s.stop) for s in idx] == [
                (s.start or 0, n if s.stop is None else s.stop)
                for s, n in zip(ref.index, leaf.shape)], key


# ---- training ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectory_jobs(tmp_path_factory):
    """Every trajectory case's rank job, started at once from the
    reference's initial params on that case's mesh; case -> (spec, procs,
    reference trainer, its initial state)."""
    root = tmp_path_factory.mktemp("mp")
    jobs = {}
    try:
        for case, (mesh, kw) in MESHES.items():
            jtr = _jax_trainer(mesh, **kw)
            jstate = jtr.init_state()
            spec = {"train": dict(KW, model="tiny", attn_impl="dense", **kw),
                    "mesh": mesh, "final_params": True,
                    "init": _save_init(jstate, root / case / "init"),
                    "out": str(root / case / "rank")}
            jobs[case] = (spec, _start(spec, _world(mesh)), jtr, jstate)
        yield jobs
    finally:
        for spec, procs, *_ in jobs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.mark.parametrize("case", list(MESHES), ids=list(MESHES))
def test_trajectory_matches_reference_mesh(case, trajectory_jobs):
    """The ranks against the reference ``Trainer`` on the same mesh: 6
    losses and grad norms, the update layout, the optimizer bytes a
    device, the attention route, the final params."""
    import jax

    from kubedl_tpu.training import trainer as jt

    spec, procs, jtr, jstate = trajectory_jobs[case]
    jstate, want = _jax_steps(jtr, jstate, KW["steps"])
    ranks = _results(spec, procs)
    for r in ranks:
        _close(r["steps"], want)
        assert r["steps"] == ranks[0]["steps"]
        assert r["world"] == _world(spec["mesh"])
        assert r["mesh"] == spec["mesh"]
        assert r["attn_impl"] == jtr.attn_impl
        assert r["shard_update"] == (jtr.update_shardings is not None)
        assert r["opt_state_bytes_per_device"] == \
            jt.state_bytes_per_device(jstate)
    final = np.load(f"{spec['out']}-final.npz")
    for i, ref in enumerate(jax.tree_util.tree_leaves(jstate["params"])):
        np.testing.assert_allclose(final[str(i)], np.asarray(ref), atol=1e-4,
                                   rtol=0)


def _assert_state_equals(dump, jstate):
    """A rank's dumped tensors (its shards where it holds shards) equal to
    the reference state's, bit for bit."""
    import jax

    adam = jstate["opt_state"][1][0]
    regions = json.load(open(dump + ".json"))
    arrays = np.load(dump + ".npz")
    trees = {"params": jstate["params"], "mu": adam.mu, "nu": adam.nu}
    for name, tree in trees.items():
        for i, ref in enumerate(jax.tree_util.tree_leaves(tree)):
            ref = np.asarray(ref, np.float32)
            if regions[name][i] is not None:
                starts, stops = regions[name][i]
                ref = ref[tuple(slice(a, b) for a, b in zip(starts, stops))]
            np.testing.assert_array_equal(arrays[f"{name}/{i}"], ref)


@pytest.mark.parametrize("case", ["fsdp2", "tensor2"])
def test_checkpoints_cross_packages_both_ways(case, tmp_path):
    """The port's 2-rank save (``shards-p0/p1.npz``, shard keys in every
    dimension) resumes the reference on the same mesh, and the
    reference's save resumes the port's 2 ranks: restored tensors equal,
    trajectories within 1e-4. At fsdp=2 the save also restores at world
    1, in both packages, bit for bit."""
    import jax

    from kubedl_tpu.training import checkpoint as jck
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.training import checkpoint as ck
    from kubedl_tpu_torch.training import trainer as tt

    mesh = MESHES[case][0]
    jtr = _jax_trainer(mesh)
    jstate0 = jtr.init_state()
    init = _save_init(jstate0, tmp_path / "init")
    to_ref = {"train": dict(KW, model="tiny"), "init": init, "mesh": mesh,
              "ckpt_dir": str(tmp_path / "port"), "ckpt_every": 3,
              "dump_at": 3, "out": str(tmp_path / "a")}
    procs = _start(to_ref, 2)
    jstate, want = _jax_steps(jtr, jstate0, 3)
    jck.save_checkpoint(str(tmp_path / "ref"), jstate, 3)
    port_a = _results(to_ref, procs)
    from_ref = {"train": dict(KW, model="tiny"), "mesh": mesh,
                "resume": str(tmp_path / "ref"), "dump_at": 0,
                "out": str(tmp_path / "b")}
    procs = _start(from_ref, 2)

    step3 = tmp_path / "port" / "step-00000003"
    assert sorted(p.name for p in step3.iterdir()) == [
        "meta.json", "shards-p0.npz", "shards-p1.npz"]
    assert (tmp_path / "port" / "latest").read_text() == "step-00000006"
    _close(port_a[0]["steps"][:3], want)
    restored = jck.restore_checkpoint(str(tmp_path / "port"),
                                      jtr.init_state(), step=3)
    for r in range(2):
        _assert_state_equals(f"{to_ref['out']}-{r}-dump", restored)
    if case == "fsdp2":  # world 1, in either package
        whole = jax.tree_util.tree_map(np.asarray, restored)
        one = tt.Trainer(tt.TrainConfig(model=tl.TINY, **KW), device="cpu")
        mine = ck.restore_checkpoint(
            str(tmp_path / "port"), ck.train_state_like(one.init_state()),
            step=3, device="cpu")
        jone = _jax_trainer({"data": 1})
        ref1 = jck.restore_checkpoint(str(tmp_path / "port"),
                                      jone.init_state(), step=3)
        for tree in (mine, ref1):
            got = [np.asarray(t, np.float32) for t in
                   jax.tree_util.tree_leaves(tree)]
            assert len(got) == len(jax.tree_util.tree_leaves(whole))
            for a, b in zip(got, jax.tree_util.tree_leaves(whole)):
                np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    _, ref_tail = _jax_steps(jtr, restored, 3, skip=3)
    _close(ref_tail, port_a[0]["steps"][3:])

    port_b = _results(from_ref, procs)
    for r in range(2):
        _assert_state_equals(f"{from_ref['out']}-{r}-dump", jstate)
    # a resumed stream starts afresh: its steps 4-6 read batches 1-3
    want = _jax_steps(jtr, jstate, 3)[1]
    for r in port_b:
        _close(r["steps"], want)


def test_train_main_two_processes_fsdp2_then_world1(tmp_path, capsys,
                                                   monkeypatch):
    """``train_main`` as 2 processes at ``KUBEDL_MESH_AXES=fsdp=2``: the
    ranks train in step on half the optimizer bytes each and save their
    shards; then ``train_main`` at world 1 resumes from them."""
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.training import entry

    cfg = {"model": "tiny", "steps": 3, "seq_len": 32, "global_batch": 4,
           "device": "cpu", "ckpt_every": 2}
    out = tmp_path / "model"
    outs = w.join_ranks(w.start_ranks(
        [sys.executable, "-m", "kubedl_tpu_torch.training.entry"], 2,
        KUBEDL_MESH_AXES="fsdp=2", KUBEDL_TRAIN_CONFIG=json.dumps(cfg),
        KUBEDL_MODEL_PATH=str(out)))
    sums = [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith('{"worker_summary"')))
            ["worker_summary"] for o in outs]
    one_rank = 8 + 2 * 4 * tl.TINY.num_params()
    for s in sums:
        assert s["world"] == 2 and s["mesh"] == {"fsdp": 2}
        assert s["steps"] == 3 and s["attn_impl"] == "dense"
        assert s["final_loss"] == sums[0]["final_loss"]
        assert not s["shard_update"]  # no data axis: the moments are the
        # params' fsdp shards, half of one rank's (the norms whole)
        assert one_rank / 2 < s["opt_state_bytes_per_device"] < \
            0.6 * one_rank
    ck = out / "checkpoints"
    assert sorted(p.name for p in (ck / "step-00000002").iterdir()) == [
        "meta.json", "shards-p0.npz", "shards-p1.npz"]
    assert (out / "latest").read_text() == "step-00000003"

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)
    monkeypatch.setenv("KUBEDL_TRAIN_CONFIG", json.dumps(dict(cfg, steps=5)))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(out))
    capsys.readouterr()
    assert entry.train_main() == 0
    assert '{"resumed_from_step": 3}' in capsys.readouterr().out.splitlines()
    assert entry.LAST_SUMMARY["steps"] == 2
    assert entry.LAST_SUMMARY["mesh"] == {"data": 1}
    assert np.isfinite(entry.LAST_SUMMARY["final_loss"])


@pytest.mark.parametrize("preset,over", [
    ("tiny", {"n_heads": 6, "n_kv_heads": 3}), ("gemma-2b", {}),
], ids=["kv3-tensor2", "gemma-2b-kv1-tensor2"])
def test_divisibility_errors_as_reference(preset, over):
    """A head count the tensor axis does not divide raises the
    reference's message (``_validate_pipe_divisibility``; Gemma-2B's one
    KV head at tensor=2), at the port's ``Trainer``."""
    import dataclasses

    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.training import trainer as jt
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh
    from kubedl_tpu_torch.training import trainer as tt

    jmodel = dataclasses.replace(jl.preset(preset), **over)
    with pytest.raises(ValueError, match="divisible") as ref:
        jt.Trainer(jt.TrainConfig(model=jmodel, global_batch=8, seq_len=16),
                   _jax_mesh({"pipe": 2, "tensor": 2, "data": 2}))
    model = dataclasses.replace(tl.preset(preset), **over)
    mesh = ProcessMesh(MeshSpec({"tensor": 2}), torch.device("cpu"),
                       alone=True)
    with pytest.raises(ValueError) as got:
        tt.Trainer(tt.TrainConfig(model=model, global_batch=8, seq_len=16),
                   mesh)
    assert str(got.value) == str(ref.value)


def test_moe_and_later_axes_raise_naming_their_slice():
    """MoE on a model-sharding axis and pipe / expert on any model build
    (they raised before the multi-device slice; ``tests/
    test_torch_expert_parallel.py`` and ``tests/test_torch_pipeline.py``
    train on them): a process alone is told only that the mesh needs
    more processes. MoE on an sp axis is built now too (routing over the
    sequence blocks); with pipe it raises the reference's message."""
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.models import moe as tm
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh
    from kubedl_tpu_torch.training import trainer as tt

    for axes in ({"fsdp": 2}, {"tensor": 2}, {"expert": 2}, {"pipe": 2}):
        mesh = ProcessMesh(MeshSpec(axes), torch.device("cpu"), alone=True)
        tr = tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE), mesh)
        assert isinstance(tr.shard, tm.MoEShard)
        assert tr.family.name == "moe"
    for axes in ({"pipe": 2}, {"expert": 2}):
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            tt.Trainer(tt.TrainConfig(), axes, device="cpu")
    mesh = ProcessMesh(MeshSpec({"sp": 2}), torch.device("cpu"), alone=True)
    tr = tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE), mesh)
    assert isinstance(tr.shard, tm.MoEShard) and tr.shard.dp.axes == ("sp",)
    mesh = ProcessMesh(MeshSpec({"pipe": 2, "sp": 2}), torch.device("cpu"),
                       alone=True)
    with pytest.raises(ValueError, match="cannot be combined with a >1 'sp'"):
        tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE), mesh)
