"""Switch-MoE sharded across processes in the port, unpipelined — the
``expert`` axis, the Megatron ``tensor`` split, ``fsdp`` and the ``sp``
sequence split (``models/moe.py``'s ``param_pspecs``, ``MoEShard``,
``BatchRouting`` and ``moe_ffn``'s expert / tensor splits,
``training/trainer.py``) — against the JAX package on the CPU.

The ranks are gloo processes (``tests/torch_dist_worker.py``), held
against the reference ``Trainer`` on the same mesh of conftest's forced
host devices, from the reference's initial parameters on that mesh, on
the same ``SyntheticTokens`` batches. Every rank job starts when the
module's first trajectory case runs. On these meshes the reference's
global arrays route over the whole global batch in its ``(b, s)`` order,
as one device does: the port's ranks span it with ``BatchRouting``,
whose scan over every rank's per-row counts puts each token at its
one-device place in its expert's queue.

Tolerances, float32, ``tiny-moe``:

- ``param_pspecs`` equal to the reference's specs; each rank's shards
  on an ``expert=2 x tensor=2`` mesh equal to the reference's
  ``NamedSharding`` shards, bit for bit;
- the routing scan (:func:`block_offsets`) in one process: each
  ``(data, sp)`` block's queue places and drops equal the one-device
  ``route``'s on that block, integer for integer;
- the 6-step loss and grad-norm trajectory within 1e-4 relative of the
  reference ``Trainer`` on the same mesh (``expert=2``,
  ``data=2 x expert=2``, ``tensor=2``, ``fsdp=2``,
  ``expert=2 x tensor=2``; on ``sp``: ``sp=2`` ring and Ulysses,
  ``data=2 x sp=2``, ``expert=2 x sp=2``, ``tensor=2 x sp=2``,
  ``fsdp=2 x sp=2``, ``sp=4``), the same on every rank; the final
  params, assembled from every rank's shards, within 1e-4 absolute;
- what raises: ``n_experts`` indivisible by ``expert`` (the reference's
  message), and ``pipe`` with ``sp`` (the reference's message).
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
KW = dict(global_batch=4, seq_len=32, steps=6, warmup_steps=2,
          learning_rate=1e-2)

#: id -> (mesh, TrainConfig fields beside KW): the trajectory cases
CASES = {
    "expert2": ({"expert": 2}, {}),
    "data2-expert2": ({"data": 2, "expert": 2}, {}),
    "tensor2": ({"tensor": 2}, {}),
    "fsdp2": ({"fsdp": 2}, {}),
    "expert2-tensor2": ({"expert": 2, "tensor": 2}, {}),
    "sp2": ({"sp": 2}, {}),
    "sp2-ulysses": ({"sp": 2}, {"context_parallel_impl": "ulysses"}),
    "data2-sp2": ({"data": 2, "sp": 2}, {}),
    "expert2-sp2": ({"expert": 2, "sp": 2}, {}),
    "tensor2-sp2": ({"tensor": 2, "sp": 2}, {}),
    "fsdp2-sp2": ({"fsdp": 2, "sp": 2}, {}),
    "sp4": ({"sp": 4}, {}),
}


def _jax_mesh(axes):
    import jax

    from kubedl_tpu.api.topology import MeshSpec
    from kubedl_tpu.parallel.mesh import build_mesh

    n = int(np.prod(list(axes.values())))
    return build_mesh(MeshSpec(dict(axes)), jax.devices()[:n])


def _jax_trainer(mesh_axes, **kw):
    from kubedl_tpu.models import moe as jm
    from kubedl_tpu.training import trainer as jt

    cfg = jt.TrainConfig(model=jm.TINY_MOE, attn_impl="dense",
                         **dict(KW, **kw))
    return jt.Trainer(cfg, _jax_mesh(mesh_axes))


def _jax_steps(jtr, jstate, n):
    from kubedl_tpu_torch.training.data import SyntheticTokens

    data = SyntheticTokens(KW["global_batch"], KW["seq_len"],
                           jtr.family.vocab_size, seed=7)
    out = []
    for _ in range(n):
        jstate, m = jtr.train_step(jstate, jtr.shard_batch(next(data)))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return jstate, out


# ---- parameter specs and shards --------------------------------------------------

def test_param_pspecs_and_shards_match_reference():
    """``param_pspecs`` is the reference's tree of specs; on an expert=2 x
    tensor=2 mesh each rank's shards (``MoEShard.shard``) are the
    reference's ``NamedSharding`` shards of the same leaves, and
    ``regions`` says where they sit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from kubedl_tpu.models import moe as jm
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.models import llama as tl
    from kubedl_tpu_torch.models import moe as tm
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh

    specs = jm.param_pspecs(jm.TINY_MOE)
    want = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    got = dict(tl.named_leaves(tm.param_pspecs(tm.TINY_MOE)))
    assert len(got) == len(want)
    for path, spec in want:
        assert got["/".join(k.key for k in path)] == tuple(spec)
    axes = {"expert": 2, "tensor": 2}
    jmesh = _jax_mesh(axes)
    jparams = jm.moe_init(jax.random.PRNGKey(0), jm.TINY_MOE)
    pruned = jax.tree_util.tree_map(
        lambda s: PartitionSpec(*(a if a in axes else None for a in s)),
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)), jparams,
        pruned, is_leaf=lambda x: isinstance(x, PartitionSpec))
    whole = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 tm.TINY_MOE, "cpu")
    devices = list(jmesh.devices.flat)
    for rank in range(4):
        mesh = ProcessMesh(MeshSpec(axes), torch.device("cpu"), alone=True)
        mesh.rank = rank
        mesh.coords = dict(zip(mesh.axis_names, divmod(rank, 2)))
        shard = tm.MoEShard(tm.TINY_MOE, mesh)
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
    reference's initial params on that case's mesh."""
    from kubedl_tpu.training import checkpoint as jck

    root = tmp_path_factory.mktemp("ep")
    jobs = {}
    try:
        for case, (mesh, extra) in CASES.items():
            jtr = _jax_trainer(mesh, **extra)
            jstate = jtr.init_state()
            init = str(root / case / "init")
            jck.save_checkpoint(init, {"params": jstate["params"]}, 0)
            spec = {"train": dict(KW, model="tiny-moe", attn_impl="dense",
                                  **extra),
                    "mesh": mesh, "final_params": True, "init": init,
                    "out": str(root / case / "rank")}
            procs = w.start_ranks([sys.executable, w.__file__,
                                   json.dumps(spec)], math.prod(mesh.values()))
            jobs[case] = (spec, procs, jtr, jstate)
        yield jobs
    finally:
        for spec, procs, *_ in jobs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_trajectory_matches_reference_mesh(case, trajectory_jobs):
    """The ranks against the reference ``Trainer`` on the same mesh: 6
    losses and grad norms, the update layout, the optimizer bytes a
    device, the final params assembled from the shards. On ``sp`` the
    attention is the context attention of ``context_parallel_impl``."""
    import jax

    from kubedl_tpu.training import trainer as jt

    spec, procs, jtr, jstate = trajectory_jobs[case]
    jstate, want = _jax_steps(jtr, jstate, KW["steps"])
    w.join_ranks(procs)
    ranks = [json.load(open(f"{spec['out']}-{r}.json"))
             for r in range(len(procs))]
    impl = spec["train"].get("context_parallel_impl", "ring")
    attn = f"context-{impl}" if "sp" in spec["mesh"] else "dense"
    for r in ranks:
        np.testing.assert_allclose(np.asarray(r["steps"]), np.asarray(want),
                                   rtol=RTOL)
        assert r["steps"] == ranks[0]["steps"]
        assert r["mesh"] == spec["mesh"] and r["attn_impl"] == attn
        assert r["shard_update"] == (jtr.update_shardings is not None)
        assert r["opt_state_bytes_per_device"] == \
            jt.state_bytes_per_device(jstate)
    final = np.load(f"{spec['out']}-final.npz")
    for i, ref in enumerate(jax.tree_util.tree_leaves(jstate["params"])):
        np.testing.assert_allclose(final[str(i)], np.asarray(ref), atol=1e-4,
                                   rtol=0)


# ---- what raises -----------------------------------------------------------------------

def _port_trainer(model, axes):
    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.parallel.mesh import ProcessMesh
    from kubedl_tpu_torch.training import trainer as tt

    mesh = ProcessMesh(MeshSpec(axes), torch.device("cpu"), alone=True)
    return tt.Trainer(tt.TrainConfig(model=model, **KW), mesh)


def test_expert_replicas_average_their_gradients():
    """On an expert split every leaf but the experts' is computed alike on
    each expert rank: its gradient is averaged over the expert axis
    (``replica_axes``), so a backward whose sums land in a run-to-run
    order cannot set the replicas apart; a tensor split runs each rank's
    own heads and needs none."""
    from kubedl_tpu_torch.models import moe as tm

    tr = _port_trainer(tm.TINY_MOE, {"expert": 2, "sp": 2})
    got = dict(zip(tr.leaf_paths, tr.replica_axes))
    assert got.pop("layers/w_in") == got.pop("layers/w_out") == ()
    assert set(got.values()) == {("expert",)}
    tr = _port_trainer(tm.TINY_MOE, {"tensor": 2})
    assert set(tr.replica_axes) == {()}


def test_pipe_with_sp_keeps_reference_message():
    """MoE on pipe x sp raises the reference's message, as Llama does."""
    from kubedl_tpu_torch.models import moe as tm

    with pytest.raises(ValueError, match="pipe axis cannot be combined"):
        _port_trainer(tm.TINY_MOE, {"pipe": 2, "sp": 2})


# ---- the routing scan across (data, sp) blocks --------------------------------------

def _blocks_against_route(choice, E, dp, sp, cap):
    """Split a routed microbatch ``choice`` [B, S] over dp x sp ranks;
    every block's places (``route``'s local count plus
    :func:`block_offsets` of the gathered counts) and keep decisions
    against the one-device ``route`` restricted to that block."""
    from kubedl_tpu_torch.models import moe as tm

    B, S = choice.shape
    rows, Sl = B // dp, S // sp
    D = E  # a router that is the identity on one-hot rows routes as told
    router = torch.eye(E, dtype=torch.float64) * 50.0
    onehot = torch.nn.functional.one_hot(choice, E).double()
    _, _, ch, pos, keep = tm.route(onehot.reshape(B * S, D), router, cap)
    assert torch.equal(ch.view(B, S), choice)
    want_pos, want_keep = pos.view(B, S), keep.view(B, S)
    blocks = {}
    for i in range(dp):
        for c in range(sp):
            part = onehot[i * rows:(i + 1) * rows, c * Sl:(c + 1) * Sl]
            _, _, bch, bpos, _ = tm.route(part.reshape(-1, D), router, cap)
            r = torch.arange(rows * Sl) // Sl
            hits = torch.bincount(r * E + bch, minlength=rows * E)
            blocks[i, c] = (bch, bpos, r, hits.view(rows, E))
    every = torch.stack([torch.stack([blocks[i, c][3] for c in range(sp)])
                         for i in range(dp)])
    for (i, c), (bch, bpos, r, _) in blocks.items():
        got = bpos + tm.block_offsets(every, i, c)[r, bch]
        want = want_pos[i * rows:(i + 1) * rows, c * Sl:(c + 1) * Sl]
        assert torch.equal(got.view(rows, Sl), want), (i, c)
        assert torch.equal((got < cap).view(rows, Sl),
                           want_keep[i * rows:(i + 1) * rows,
                                     c * Sl:(c + 1) * Sl]), (i, c)
    return want_keep


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2), (1, 4), (2, 4), (4, 1)],
                         ids=["sp2", "data2-sp2", "sp4", "data2-sp4",
                              "data4"])
def test_routing_scan_matches_one_device(dp, sp):
    """Uneven routing (expert 0 takes about half the tokens, expert 3
    none of one block) and a full expert (every token to expert 1, far
    past capacity): each block's queue places and drops equal the
    one-device ``route``'s, token for token."""
    E, B, S = 4, 4, 16
    rng = np.random.default_rng(dp * 10 + sp)
    skew = rng.choice(E, size=(B, S), p=[0.5, 0.25, 0.15, 0.10])
    skew[0, :S // sp] = np.where(skew[0, :S // sp] == 3, 2,
                                 skew[0, :S // sp])
    cap = int(1.25 * B * S / E)
    keep = _blocks_against_route(torch.from_numpy(skew), E, dp, sp, cap)
    assert not bool(keep.all())  # expert 0 overflows: some drops
    full = np.ones((B, S), np.int64)
    keep = _blocks_against_route(torch.from_numpy(full), E, dp, sp, cap)
    assert int(keep.sum()) == cap  # the first cap tokens, globally


def test_routing_spans_the_batch_axes():
    """The trainer routes an unpipelined MoE over every rank that holds
    other tokens of the microbatch: the data axes and sp."""
    from kubedl_tpu_torch.models import moe as tm

    for axes, size in (({"sp": 2}, 2), ({"data": 2, "sp": 2}, 4),
                       ({"expert": 2, "sp": 2}, 2), ({"fsdp": 2}, 2),
                       ({"expert": 2}, None)):
        tr = _port_trainer(tm.TINY_MOE, axes)
        dp = tr.shard.dp if tr.shard is not None else None
        assert (dp.size if dp else None) == size, axes
        if dp:
            assert dp.axes == tuple(a for a in ("data", "fsdp", "sp")
                                    if a in axes)


@pytest.mark.parametrize("axes", [{"expert": 3}, {"pipe": 2, "expert": 3}],
                         ids=["expert3", "pipe2-expert3"])
def test_indivisible_experts_as_reference(axes):
    """Four experts over three expert ranks raise the reference's message
    (its ``_validate_pipe_divisibility``), with and without a pipe axis."""
    import dataclasses

    from kubedl_tpu.models import moe as jm
    from kubedl_tpu.training import trainer as jt
    from kubedl_tpu_torch.models import moe as tm

    with pytest.raises(ValueError) as ref:
        jt.Trainer(jt.TrainConfig(model=jm.TINY_MOE, **KW),
                   _jax_mesh({"pipe": 2, "expert": 3}))
    with pytest.raises(ValueError) as got:
        _port_trainer(dataclasses.replace(tm.TINY_MOE), axes)
    assert str(got.value) == str(ref.value) == \
        "n_experts=4 not divisible by expert=3"
