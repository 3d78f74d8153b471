"""GPipe pipeline parallelism in the port — ``parallel/pipeline.py``, the
families' ``pipeline_hooks``, the trainer's ``_pipe_pspecs`` and
pipeline loss, checkpoints of a pipe- and expert-split model — against
the JAX package on the CPU.

The ranks are gloo processes (``tests/torch_dist_worker.py``, started by
``parallel/launch.py``), held against the reference ``Trainer`` on the
same mesh of conftest's forced host devices, from the reference's initial
parameters on that mesh (saved by the reference, restored whole by each
rank, which keeps its shards) on the same ``SyntheticTokens`` batches.
Every rank job of the trajectory cases starts when the module's first
such case runs.

Tolerances, float32:

- the 6-step loss and grad-norm trajectory within 1e-4 relative of the
  reference ``Trainer`` on the same mesh, the same on every rank; the
  final params, assembled from the shards, within 1e-4 absolute. Llama
  (4 layers: two a stage) at ``pipe=2``, ``data=2 x pipe=2`` (also with
  ``grad_accum`` 2) and ``pipe=2 x tensor=2`` (remat on), tied
  Gemma-style embeddings at
  ``pipe=2``; ``tiny-moe`` at ``pipe=2`` and ``pipe=2 x expert=2`` at
  the reference's default capacity and aux weight, where the pipelined
  MoE routes per microbatch and data rank (a different function from
  the unpipelined one: its loss differs from the one-device loss by
  more than the tolerance);
- a ``pipe=2 x expert=2`` save: each rank's tensors equal to the
  reference's restore of it, bit for bit; restored at world 1 by both
  packages, bit for bit; the reference's save on that mesh restored into
  the port's ranks, bit for bit, and both continued within 1e-4;
- what still raises: ``pipe x sp`` and the indivisible ``n_layers``
  with the reference's messages, and a batch the microbatches do not
  split.
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
KW = dict(global_batch=8, seq_len=32, steps=6, warmup_steps=2,
          learning_rate=1e-2, microbatches=4)

#: id -> (preset, its overrides, mesh, TrainConfig overrides): the
#: trajectory cases
CASES = {
    "llama-pipe2": ("tiny", {"n_layers": 4}, {"pipe": 2}, {}),
    "llama-data2-pipe2": ("tiny", {"n_layers": 4}, {"data": 2, "pipe": 2},
                          {}),
    "llama-data2-pipe2-accum2": ("tiny", {"n_layers": 4},
                                 {"data": 2, "pipe": 2},
                                 {"grad_accum": 2, "microbatches": 2}),
    "llama-pipe2-tensor2": ("tiny", {"n_layers": 4, "remat": True},
                            {"pipe": 2, "tensor": 2}, {}),
    "gemma-pipe2": ("tiny-gemma", {}, {"pipe": 2}, {}),
    "moe-pipe2": ("tiny-moe", {}, {"pipe": 2}, {}),
    "moe-pipe2-expert2": ("tiny-moe", {}, {"pipe": 2, "expert": 2}, {}),
}


def _jax_mesh(axes):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.parallel.mesh import build_mesh

    n = int(np.prod(list(axes.values())))
    return build_mesh(MeshSpec(dict(axes)), jax.devices()[:n])


def _jax_model(preset, over):
    import dataclasses

    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.models import moe as jm

    return dataclasses.replace((jm if "moe" in preset else jl).preset(preset),
                               **over)


def _jax_trainer(preset, over, mesh_axes, **kw):
    from kubedl_tpu.training import trainer as jt

    cfg = jt.TrainConfig(model=_jax_model(preset, over), attn_impl="dense",
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


def _start(spec, world):
    return w.start_ranks([sys.executable, w.__file__, json.dumps(spec)],
                         world)


def _results(spec, procs):
    w.join_ranks(procs)
    return [json.load(open(f"{spec['out']}-{r}.json"))
            for r in range(len(procs))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL)


@pytest.fixture(scope="module")
def trajectory_jobs(tmp_path_factory):
    """Every trajectory case's rank job, started at once from the
    reference's initial params on that case's mesh; case -> (spec, procs,
    reference trainer, its initial state)."""
    root = tmp_path_factory.mktemp("pp")
    jobs = {}
    try:
        for case, (preset, over, mesh, kw) in CASES.items():
            jtr = _jax_trainer(preset, over, mesh, **kw)
            jstate = jtr.init_state()
            spec = {"train": dict(KW, model=preset, attn_impl="dense", **kw),
                    "model_over": over, "mesh": mesh, "final_params": True,
                    "init": _save_init(jstate, root / case / "init"),
                    "out": str(root / case / "rank")}
            jobs[case] = (spec, _start(spec, math.prod(mesh.values())), jtr,
                          jstate)
        yield jobs
    finally:
        for spec, procs, *_ in jobs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_trajectory_matches_reference_pipeline(case, trajectory_jobs):
    """The ranks against the reference ``Trainer`` on the same mesh: 6
    losses and grad norms, the replicated update, the optimizer bytes a
    device, the final params. The pipelined MoE's first loss is not the
    one-device loss (routing per microbatch and data rank)."""
    import jax

    from kubedl_tpu.training import trainer as jt

    spec, procs, jtr, jstate = trajectory_jobs[case]
    if "moe" in case:
        one = _jax_trainer(*CASES[case][:2], {"data": 1})
        params = jax.tree_util.tree_map(np.asarray, jstate["params"])
        _, flat = _jax_steps(one, dict(one.init_state(), params=params), 1)
    jstate, want = _jax_steps(jtr, jstate, KW["steps"])
    if "moe" in case:
        assert abs(flat[0][0] - want[0][0]) > RTOL * abs(want[0][0])
    ranks = _results(spec, procs)
    for r in ranks:
        _close(r["steps"], want)
        assert r["steps"] == ranks[0]["steps"]
        assert r["mesh"] == spec["mesh"] and r["attn_impl"] == "dense"
        assert not r["shard_update"] and jtr.update_shardings is None
        assert r["opt_state_bytes_per_device"] == \
            jt.state_bytes_per_device(jstate)
    final = np.load(f"{spec['out']}-final.npz")
    for i, ref in enumerate(jax.tree_util.tree_leaves(jstate["params"])):
        np.testing.assert_allclose(final[str(i)], np.asarray(ref), atol=1e-4,
                                   rtol=0)


# ---- checkpoints of a pipe- and expert-split model ------------------------------

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


def test_pipe_expert_checkpoints_cross_packages(tmp_path):
    """``tiny-moe`` at ``pipe=2 x expert=2``: the port's 4-rank save
    (each rank's stage and experts as shard entries) resumes the
    reference on the same mesh and restores at world 1 in both packages;
    the reference's save on that mesh resumes the port's 4 ranks."""
    import jax

    from kubedl_tpu.training import checkpoint as jck
    from kubedl_tpu_torch.models import moe as tm
    from kubedl_tpu_torch.training import checkpoint as ck
    from kubedl_tpu_torch.training import trainer as tt

    mesh = {"pipe": 2, "expert": 2}
    jtr = _jax_trainer("tiny-moe", {}, mesh)
    jstate0 = jtr.init_state()
    init = _save_init(jstate0, tmp_path / "init")
    to_ref = {"train": dict(KW, model="tiny-moe", attn_impl="dense"),
              "init": init, "mesh": mesh, "ckpt_dir": str(tmp_path / "port"),
              "ckpt_every": 3, "dump_at": 3, "out": str(tmp_path / "a")}
    procs = _start(to_ref, 4)
    jstate, want = _jax_steps(jtr, jstate0, 3)
    jck.save_checkpoint(str(tmp_path / "ref"), jstate, 3)
    port_a = _results(to_ref, procs)
    from_ref = {"train": dict(KW, model="tiny-moe", attn_impl="dense"),
                "mesh": mesh, "resume": str(tmp_path / "ref"), "dump_at": 0,
                "out": str(tmp_path / "b")}
    procs = _start(from_ref, 4)

    step3 = tmp_path / "port" / "step-00000003"
    assert sorted(p.name for p in step3.iterdir()) == [
        "meta.json"] + [f"shards-p{r}.npz" for r in range(4)]
    _close(port_a[0]["steps"][:3], want)
    restored = jck.restore_checkpoint(str(tmp_path / "port"),
                                      jtr.init_state(), step=3)
    for r in range(4):
        _assert_state_equals(f"{to_ref['out']}-{r}-dump", restored)
    whole = jax.tree_util.tree_map(np.asarray, restored)
    one = tt.Trainer(tt.TrainConfig(model=tm.TINY_MOE, **KW), device="cpu")
    mine = ck.restore_checkpoint(
        str(tmp_path / "port"), ck.train_state_like(one.init_state()),
        step=3, device="cpu")
    jone = _jax_trainer("tiny-moe", {}, {"data": 1})
    ref1 = jck.restore_checkpoint(str(tmp_path / "port"), jone.init_state(),
                                  step=3)
    for tree in (mine, ref1):
        got = [np.asarray(t, np.float32) for t in
               jax.tree_util.tree_leaves(tree)]
        assert len(got) == len(jax.tree_util.tree_leaves(whole))
        for a, b in zip(got, jax.tree_util.tree_leaves(whole)):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    _, ref_tail = _jax_steps(jtr, restored, 3, skip=3)
    _close(ref_tail, port_a[0]["steps"][3:])

    port_b = _results(from_ref, procs)
    for r in range(4):
        _assert_state_equals(f"{from_ref['out']}-{r}-dump", jstate)
    # a resumed stream starts afresh: its steps 4-6 read batches 1-3
    want = _jax_steps(jtr, jstate, 3)[1]
    for r in port_b:
        _close(r["steps"], want)


# ---- what still raises -------------------------------------------------------------

def _port_trainer(model, axes, **kw):
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh
    from kubedl_tpu_torch.training import trainer as tt

    mesh = ProcessMesh(MeshSpec(axes), torch.device("cpu"), alone=True)
    return tt.Trainer(tt.TrainConfig(model=model, **dict(KW, **kw)), mesh)


@pytest.mark.parametrize("axes,over", [
    ({"pipe": 2, "sp": 2}, {}),
    ({"pipe": 4}, {"n_layers": 6}),
    ({"pipe": 2, "tensor": 2}, {"n_heads": 6, "n_kv_heads": 3}),
], ids=["pipe2-sp2", "layers6-pipe4", "kv3-pipe2-tensor2"])
def test_pipe_refusals_as_reference(axes, over):
    """``pipe x sp`` and a dimension the mesh does not divide raise the
    reference's message at the port's ``Trainer``."""
    import dataclasses

    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.training import trainer as jt
    from kubedl_tpu_torch.models import llama as tl

    with pytest.raises(ValueError) as ref:
        jt.Trainer(jt.TrainConfig(model=dataclasses.replace(jl.TINY, **over),
                                  **KW), _jax_mesh(axes))
    with pytest.raises(ValueError) as got:
        _port_trainer(dataclasses.replace(tl.TINY, **over), axes)
    assert str(got.value) == str(ref.value)


def test_pipe_batch_must_split_into_microbatches():
    """A batch the microbatches do not divide raises the reference's
    message; microbatches that leave a data rank no whole row raise."""
    from kubedl_tpu_torch.models import llama as tl

    with pytest.raises(ValueError, match="must divide into microbatches=3"):
        _port_trainer(tl.TINY, {"pipe": 2}, microbatches=3)
    with pytest.raises(ValueError, match="does not split over 2 data"):
        _port_trainer(tl.TINY, {"data": 2, "pipe": 2}, microbatches=8)
    tr = _port_trainer(tl.TINY, {"pipe": 2}, microbatches=0)
    assert tr.microbatches == 8 and tr.shard.specs["layers/wq"] == (
        "pipe", None, None)
    assert tr.update_dims == [None] * len(tr.update_dims)
