"""Data-parallel training across processes in the port
(``kubedl_tpu_torch/parallel/mesh.py``, ``training/trainer.py``'s
data-parallel step, ``training/buckets.py``, ``elastic/resize.py``, the
per-process checkpoint shards, ``train_main`` from the job's env) against
the JAX package on the CPU.

Each multi-process case runs 2 gloo ranks as subprocesses
(``tests/torch_dist_worker.py``, started by ``parallel/launch.py``: a
free port, a timeout on every rank)
and holds them against the reference ``Trainer`` on a data=2 (or
replica=2) CPU mesh of conftest's forced host devices, from the same
initial parameters (the reference's init, saved by the reference and
restored by the ranks) on the same ``SyntheticTokens`` batches.

Tolerances, float32:

- the 6-step loss and grad-norm trajectory within 1e-4 relative (the
  one-device gate's), the same on both ranks;
- ``opt_state_bytes_per_device`` equal to the reference's
  ``state_bytes_per_device`` on the same mesh, and the bucket plan equal
  to the reference's (host only);
- checkpoints both ways: the restored tensors equal to the saved ones
  bit for bit, the continued trajectory within 1e-4;
- ``train_main`` as 2 processes through the env; and at world 1 with
  ``KUBEDL_ELASTIC_BASE_WORLD=2``, the reference's ``elastic_grad_accum``
  line, byte for byte.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, __import__("os").path.dirname(__file__))

import torch_dist_worker as w  # noqa: E402

RTOL = 1e-4
KW = dict(global_batch=4, seq_len=32, steps=6, warmup_steps=2,
          learning_rate=1e-2)


def _jax_trainer(preset, mesh_axes, **kw):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.models import llama as jl
    from kubedl_tpu.models import moe as jm
    from kubedl_tpu.parallel.mesh import build_mesh
    from kubedl_tpu.training import trainer as jt

    model = (jm if "moe" in preset else jl).preset(preset)
    n = int(np.prod(list(mesh_axes.values())))
    mesh = build_mesh(MeshSpec(dict(mesh_axes)), jax.devices()[:n])
    return jt.Trainer(jt.TrainConfig(model=model, attn_impl="dense",
                                     **dict(KW, **kw)), mesh)


def _jax_steps(jtr, jstate, n, skip=0):
    """``n`` steps of the reference on the stream the ranks read (its
    first ``skip`` batches are passed over); (state, [[loss, norm]])."""
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


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL)


def _save_init(jstate, path):
    from kubedl_tpu.training import checkpoint as jck

    jck.save_checkpoint(str(path), {"params": jstate["params"]}, 0)
    return str(path)


#: id -> (preset, mesh, TrainConfig overrides)
CASES = {
    "replicated": ("tiny", {"data": 2}, dict(shard_update=False)),
    "sharded-flash": ("tiny", {"data": 2},
                      dict(shard_update=True, attn_impl="flash")),
    "grad_accum2-overlap": ("tiny", {"data": 2},
                            dict(shard_update=True, overlap_comm=True,
                                 grad_accum=2)),
    "replica2": ("tiny", {"replica": 2}, dict(shard_update=True)),
    "tiny-moe-sharded": ("tiny-moe", {"data": 2},
                         dict(shard_update=True, grad_accum=2)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_two_ranks_reproduce_reference_mesh_trajectory(case, tmp_path):
    """Two gloo ranks against the reference's 2-device mesh: 6 losses and
    grad norms, the update layout and the optimizer bytes a device."""
    from kubedl_tpu.training import trainer as jt

    preset, mesh, kw = CASES[case]
    jtr = _jax_trainer(preset, mesh, **{k: v for k, v in kw.items()
                                        if k != "attn_impl"})
    jstate = jtr.init_state()
    spec = {"train": dict(KW, model=preset, **dict({"attn_impl": "dense"},
                                                    **kw)),
            "mesh": mesh, "init": _save_init(jstate, tmp_path / "init"),
            "out": str(tmp_path / "rank")}
    procs = w.start_ranks([sys.executable, w.__file__, json.dumps(spec)])
    jstate, want = _jax_steps(jtr, jstate, KW["steps"])
    w.join_ranks(procs)
    ranks = [json.load(open(f"{spec['out']}-{r}.json")) for r in range(2)]
    for r in ranks:
        _close(r["steps"], want)
        assert r["steps"] == ranks[0]["steps"]
        assert r["dist_backend"] == "gloo" and r["world"] == 2
        assert r["shard_update"] == (jtr.update_shardings is not None)
        assert r["overlap_comm"] == (jtr.update_shardings is not None
                                     and jtr.cfg.overlap_comm)
        assert r["grad_buckets"] == jtr.grad_bucket_plan.n_buckets
        assert r["opt_state_bytes_per_device"] == \
            jt.state_bytes_per_device(jstate)
        assert set(r["collective_ms"]) >= {"all_reduce"}


def _assert_state_equals(dump, jstate):
    """A rank's dumped tensors (params whole, moments its shards) equal to
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


def test_checkpoints_cross_packages_both_ways(tmp_path):
    """The reference's data=2 save resumes the port's 2 ranks, and the
    port's 2-rank save (``shards-p0/p1.npz``) resumes the reference's
    data=2 trainer: restored tensors equal, trajectories within 1e-4."""
    from kubedl_tpu.training import checkpoint as jck

    jtr = _jax_trainer("tiny", {"data": 2}, shard_update=True)
    jstate0 = jtr.init_state()
    init = _save_init(jstate0, tmp_path / "init")
    # the port saves at step 3 (and 6); its dump at step 3
    to_ref = {"train": dict(KW, model="tiny", shard_update=True), "init": init,
              "mesh": {"data": 2}, "ckpt_dir": str(tmp_path / "port"),
              "ckpt_every": 3, "dump_at": 3, "out": str(tmp_path / "a")}
    procs = w.start_ranks([sys.executable, w.__file__, json.dumps(to_ref)])
    # the reference saves at step 3
    jstate, want = _jax_steps(jtr, jstate0, 3)
    jck.save_checkpoint(str(tmp_path / "ref"), jstate, 3)
    w.join_ranks(procs)
    from_ref = {"train": dict(KW, model="tiny", shard_update=True),
                "mesh": {"data": 2}, "resume": str(tmp_path / "ref"),
                "dump_at": 0, "out": str(tmp_path / "b")}
    procs = w.start_ranks([sys.executable, w.__file__, json.dumps(from_ref)])

    step3 = tmp_path / "port" / "step-00000003"
    assert sorted(p.name for p in step3.iterdir()) == [
        "meta.json", "shards-p0.npz", "shards-p1.npz"]
    assert (tmp_path / "port" / "latest").read_text() == "step-00000006"
    port_a = [json.load(open(f"{to_ref['out']}-{r}.json")) for r in range(2)]
    _close(port_a[0]["steps"][:3], want)
    restored = jck.restore_checkpoint(str(tmp_path / "port"),
                                      jtr.init_state(), step=3)
    for r in range(2):
        _assert_state_equals(f"{to_ref['out']}-{r}-dump", restored)
    _, ref_tail = _jax_steps(jtr, restored, 3, skip=3)
    _close(ref_tail, port_a[0]["steps"][3:])

    w.join_ranks(procs)
    for r in range(2):
        _assert_state_equals(f"{from_ref['out']}-{r}-dump", jstate)
    # a resumed stream starts afresh: its steps 4-6 read batches 1-3
    want = _jax_steps(jtr, jstate, 3)[1]
    for r in range(2):
        _close(json.load(open(f"{from_ref['out']}-{r}.json"))["steps"], want)


def test_train_main_two_processes_then_elastic_resume(tmp_path, capsys,
                                                      monkeypatch):
    """``train_main`` as 2 processes from the job's env (data=2, saves
    from both ranks), then at world 1 with ``KUBEDL_ELASTIC_BASE_WORLD=2``:
    the reference's ``elastic_grad_accum`` line, a resume from the 2-rank
    shards, and training on."""
    from kubedl_tpu.training import entry as jentry
    from kubedl_tpu_torch.training import entry

    cfg = {"model": "tiny", "steps": 3, "seq_len": 32, "global_batch": 4,
           "device": "cpu", "ckpt_every": 2}
    out = tmp_path / "model"
    procs = w.start_ranks(
        [sys.executable, "-m", "kubedl_tpu_torch.training.entry"],
        KUBEDL_MESH_AXES="data=2", KUBEDL_TRAIN_CONFIG=json.dumps(cfg),
        KUBEDL_MODEL_PATH=str(out))
    outs = w.join_ranks(procs)
    summaries = [json.loads(next(ln for ln in o.splitlines()
                                 if ln.startswith('{"worker_summary"')))
                 ["worker_summary"] for o in outs]
    for s in summaries:
        assert s["dist_backend"] == "gloo" and s["world"] == 2
        assert s["shard_update"] and s["steps"] == 3
        assert s["final_loss"] == summaries[0]["final_loss"]
    ck = out / "checkpoints"
    assert sorted(p.name for p in (ck / "step-00000002").iterdir()) == [
        "meta.json", "shards-p0.npz", "shards-p1.npz"]
    assert (ck / "latest").read_text() == "step-00000003"
    assert (out / "latest").read_text() == "step-00000003"

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)
    monkeypatch.setenv("KUBEDL_ELASTIC_BASE_WORLD", "2")
    monkeypatch.setenv("KUBEDL_TRAIN_CONFIG",
                       json.dumps(dict(cfg, steps=5)))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(out))
    capsys.readouterr()
    assert entry.train_main() == 0
    lines = capsys.readouterr().out.splitlines()
    elastic = [ln for ln in lines if ln.startswith('{"elastic_grad_accum"')]
    assert json.loads(elastic[0]) == {"elastic_grad_accum": 2, "world": 1,
                                      "base_world": 2}
    assert '{"resumed_from_step": 3}' in lines
    assert entry.LAST_SUMMARY["steps"] == 2
    assert entry.LAST_SUMMARY["dist_backend"] is None
    # the reference prints the same line for the same resize (its batch
    # spans conftest's 8 host devices: 16 rows, 2 microbatches of 8)
    monkeypatch.setenv("KUBEDL_TRAIN_CONFIG", json.dumps(
        {"model": "tiny", "steps": 1, "seq_len": 16, "global_batch": 16}))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(tmp_path / "ref"))
    assert jentry.train_main() == 0
    ref = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith('{"elastic_grad_accum"')]
    assert ref == elastic[:1]


def test_bucket_plan_and_resize_math_match_reference():
    """Host only: the port's copies of ``plan_grad_buckets``,
    ``grad_accum_for_world``, ``data_parallel_world`` and ``MeshSpec``
    give the reference's answers; the trainer's plan on ``tiny``'s and
    ``tiny-moe``'s leaves is the reference trainer's."""
    from kubedl_tpu.api.topology import MeshSpec as JMeshSpec
    from kubedl_tpu.elastic import resize as jr
    from kubedl_tpu.training import buckets as jb
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.elastic import resize as tr
    from kubedl_tpu_torch.training import buckets as tb
    from kubedl_tpu_torch.training import trainer as tt
    from kubedl_tpu_torch.models import llama as tl, moe as tm

    def plan(p):
        return p.buckets, p.scatter, p.total_bytes, p.scattered_bytes, \
            p.n_buckets, p.scattered_fraction

    for model in (tl.TINY, tm.TINY_MOE):
        sizes = [t.numel() * t.element_size()
                 for t in tt.tree_leaves(tt.family_for(model).like())]
        for mb in (4.0, 0.01, 0.001):
            assert plan(tb.plan_grad_buckets(sizes, int(mb * 2**20))) == \
                plan(jb.plan_grad_buckets(sizes, int(mb * 2**20)))
    preset = {"tiny": tl.TINY, "tiny-moe": tm.TINY_MOE}
    for name in preset:
        jtr = _jax_trainer(name, {"data": 1})
        ttr = tt.Trainer(tt.TrainConfig(model=preset[name], **KW),
                         device="cpu")
        assert plan(ttr.grad_bucket_plan) == plan(jtr.grad_bucket_plan)
    assert tb.MIN_SCATTER_BYTES == jb.MIN_SCATTER_BYTES
    assert tb.DEFAULT_BUCKET_BYTES == jb.DEFAULT_BUCKET_BYTES
    for base_acc in (1, 2, 3):
        for base in (1, 2, 4, 8):
            for world in (1, 2, 3, 4, 16):
                for gb in (1, 4, 6, 8, 12):
                    assert tr.grad_accum_for_world(base_acc, base, world, gb) \
                        == jr.grad_accum_for_world(base_acc, base, world, gb)
    for env in ("data=2", "replica=2,data=4", "data=2,tensor=4,fsdp=2", ""):
        mine, ref = MeshSpec.from_env(env), JMeshSpec.from_env(env)
        assert mine.ordered() == ref.ordered()
        assert mine.to_env() == ref.to_env() and mine.size() == ref.size()
        assert tr.data_parallel_world(mine) == jr.data_parallel_world(ref)


@pytest.mark.parametrize("axes", ["fsdp=2", "tensor=2", "sp=2", "pipe=2",
                                  "expert=2"])
def test_model_sharding_axes_raise_naming_their_slice(axes):
    """Every model-sharding axis runs (``tests/test_torch_model_parallel.py``,
    ``test_torch_expert_parallel.py`` and ``test_torch_pipeline.py``
    train on them): the mesh passes, and a process alone is told only
    that the mesh needs more processes than its job has. An axis no rule
    names still raises."""
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.parallel import mesh

    spec = MeshSpec.from_env("data=2," + axes)
    mesh.check_axes(spec)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        mesh.build_mesh(spec, "cpu")
    with pytest.raises(ValueError, match="not an axis the trainer"):
        mesh.build_mesh(MeshSpec.from_env(axes.replace("=", "x=")), "cpu")
    assert mesh.batch_axes(mesh.build_mesh(None, "cpu")) == ("data",)


@pytest.mark.parametrize("rank_code,timeout,match", [
    ("import sys; sys.exit(3 if __import__('os').environ"
     "['KUBEDL_PROCESS_ID'] == '1' else 0)", 60, "rank 1 exited 3"),
    ("import time; time.sleep(120)", 2, "rank 0 timed out after 2 s"),
], ids=["rank-exits-nonzero", "rank-times-out"])
def test_launcher_fails_the_job_and_stops_every_rank(rank_code, timeout,
                                                     match):
    """The one launcher (tests and ``chip_smoke.py`` phase 29): each rank
    gets the job's env; a rank that fails or runs over raises, and no
    rank is left running."""
    from kubedl_tpu_torch.parallel import launch

    procs = launch.start_ranks([sys.executable, "-c", rank_code], 2)
    with pytest.raises(RuntimeError, match=match):
        launch.join_ranks(procs, timeout)
    assert all(p.poll() is not None for p in procs)
    env = launch.job_env(1, 2, 1234, EXTRA="x")
    assert (env["KUBEDL_NUM_PROCESSES"], env["KUBEDL_PROCESS_ID"],
            env["KUBEDL_COORDINATOR_ADDRESS"], env["EXTRA"]) == \
        ("2", "1", "127.0.0.1:1234", "x")


@pytest.mark.parametrize("mesh_arg", [None, {"data": 1, "fsdp": 1}],
                         ids=["no-mesh", "one-device-mapping"])
def test_one_process_trainer_runs_the_one_step_on_a_local_mesh(mesh_arg):
    """Without a process group, a ``Trainer`` given no mesh or a mesh of
    one device runs on a one-process mesh: no rank splits, no shards, no
    backend in the summary, and its step is the data-parallel step with
    every collective the identity."""
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.training import trainer as tt
    from kubedl_tpu_torch.training.data import SyntheticTokens

    tr = tt.Trainer(tt.TrainConfig(model=tl.TINY, **dict(KW, steps=2)),
                    mesh_arg, device="cpu")
    assert (tr.mesh.world, tr.dp, tr.update_axes) == (1, 1, ())
    assert not any(tr.shard_specs)
    _, s = tr.fit(SyntheticTokens(KW["global_batch"], KW["seq_len"],
                                  tl.TINY.vocab_size, seed=7))
    assert s["dist_backend"] is None and s["collective_ms"] is None
    assert s["world"] == 1 and np.isfinite(s["final_loss"])
