"""One rank of a multi-process run of the port, for the CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_training.py``,
``tests/test_torch_model_parallel.py``).

Run as ``python tests/torch_dist_worker.py '<json spec>'`` with the job's
env (``KUBEDL_NUM_PROCESSES``, ``KUBEDL_PROCESS_ID``,
``KUBEDL_COORDINATOR_ADDRESS``); :func:`run_ranks` starts the ranks and
returns what each wrote. It imports torch and the port only, never JAX.

The spec: ``train`` (``TrainConfig`` fields, ``model`` a preset name),
``model_over`` (fields of the preset's config replaced), ``mesh`` (axes), ``init`` (a checkpoint dir whose whole ``params`` start
the run, each rank keeping its shards of a sharded model), ``resume`` (a checkpoint dir whose train state resumes it),
``ckpt_dir`` / ``ckpt_every`` (``fit``'s saves), ``dump_at`` (after that
many steps of the run, or right after the resume when 0, each rank
writes its state's tensors to ``<out>-<rank>-dump.npz``),
``final_params`` (rank 0 writes the whole params at the end, assembled
from every rank's shards, to ``<out>-final.npz``) and ``out`` (each
rank's JSON: per step loss and grad norm, the summary's keys). A spec
with ``attention`` (``B, S, H, KV, hd``) runs the context attention
instead (:func:`_attention`).
"""

from __future__ import annotations

import json
import os
import sys
from typing import List

from kubedl_tpu_torch.parallel import launch

#: seconds a rank may take before the test gives up on it
RANK_TIMEOUT_S = 240


def start_ranks(argv: List[str], world: int = 2, **extra: str):
    """Start ``world`` processes of ``argv`` as one job (two threads of
    their own each, so that the CPU tests' ranks do not crowd the box)."""
    return launch.start_ranks(argv, world, OMP_NUM_THREADS="2", **extra)


def join_ranks(procs, timeout: float = RANK_TIMEOUT_S) -> List[str]:
    return launch.join_ranks(procs, timeout)


def run_ranks(spec: dict, world: int = 2) -> List[dict]:
    """Run ``spec`` as ``world`` ranks; each rank's JSON result."""
    join_ranks(start_ranks([sys.executable, os.path.abspath(__file__),
                            json.dumps(spec)], world))
    return [json.load(open(f"{spec['out']}-{r}.json")) for r in range(world)]


def _dump(path: str, state) -> None:
    """The rank's state tensors (``<path>.npz``: ``params/i``, ``mu/i``,
    ``nu/i``, its shards where it holds shards) and where each shard sits
    (``<path>.json``: per name, per leaf ``[starts, stops]`` or null)."""
    import numpy as np

    from kubedl_tpu_torch.training.trainer import tree_leaves

    opt = state["opt_state"]
    where = {"params": state.get("param_shards"), "mu": opt.get("shards"),
             "nu": opt.get("shards")}
    arrays, regions = {}, {}
    for name, ts in (("params", tree_leaves(state["params"])),
                     ("mu", opt["mu"]), ("nu", opt["nu"])):
        specs = where[name] or [None] * len(ts)
        regions[name] = [None if s is None else [s.starts, s.stops]
                         for s in specs]
        for i, t in enumerate(ts):
            arrays[f"{name}/{i}"] = t.detach().float().cpu().numpy()
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(regions, f)


def attention_inputs(B, S, H, KV, hd, seed=0):
    """Seeded float32 q, k, v and a cotangent w (numpy), the same in the
    test and in every rank."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                          (B, S, H, hd))]


def _attention(spec: dict, mesh) -> None:
    """The ``attention`` mode: ring and Ulysses attention (direct and
    through ``make_context_attention``, which must agree bit for bit) on
    this rank's block of the sequence, causal and not; writes each
    case's output and q/k/v gradients of ``sum(out * w)``."""
    import numpy as np
    import torch

    from kubedl_tpu_torch.parallel import ring

    a = spec["attention"]
    q, k, v, w = attention_inputs(**a)
    n, c = mesh.shape["sp"], mesh.coords["sp"]
    Sl = a["S"] // n
    block = [torch.from_numpy(x[:, c * Sl:(c + 1) * Sl].copy())
             for x in (q, k, v, w)]
    out = {}
    for impl, fn in (("ring", ring.ring_attention),
                     ("ulysses", ring.ulysses_attention)):
        for causal in (True, False):
            got = []
            for direct in (True, False):
                ins = [t.clone().requires_grad_(True) for t in block[:3]]
                attn = (lambda *x: fn(*x, mesh, "sp", causal)) if direct \
                    else ring.make_context_attention(mesh, impl=impl,
                                                     causal=causal)
                o = attn(*ins)
                (o * block[3]).sum().backward()
                got.append([o.detach()] + [t.grad for t in ins])
            assert all(torch.equal(x, y) for x, y in zip(*got))
            for name, t in zip(("out", "dq", "dk", "dv"), got[0]):
                out[f"{impl}/{causal}/{name}"] = t.numpy()
    np.savez(f"{spec['out']}-{mesh.rank}.npz", **out)


def main(spec: dict) -> None:
    import dataclasses

    import torch.distributed as dist

    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.models import llama, moe
    from kubedl_tpu_torch.parallel.mesh import build_mesh, initialize_from_env
    from kubedl_tpu_torch.training import checkpoint as ck
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import (
        TrainConfig, Trainer, tree_leaves,
    )

    initialize_from_env(timeout_s=RANK_TIMEOUT_S / 2)
    try:
        if "attention" in spec:
            return _attention(spec, build_mesh(MeshSpec(spec["mesh"]), "cpu"))
        kw = dict(spec["train"])
        name = kw.pop("model")
        model = (moe if "moe" in name else llama).preset(name)
        model = dataclasses.replace(model, **spec.get("model_over", {}))
        cfg = TrainConfig(model=model, **kw)
        trainer = Trainer(cfg, build_mesh(MeshSpec(spec["mesh"]), "cpu"))
        rank = trainer.mesh.rank
        state = trainer.init_state()
        if spec.get("init"):  # a whole tree: this rank keeps its shards
            params = ck.restore_checkpoint(
                spec["init"], {"params": trainer.family.like()},
                device="cpu")["params"]
            state["params"] = params if trainer.shard is None \
                else trainer.shard.shard(params)
        if spec.get("resume"):
            state = ck.train_state_from_tree(ck.restore_checkpoint(
                spec["resume"], ck.train_state_like(state), device="cpu"))
        dump = f"{spec['out']}-{rank}-dump"
        if spec.get("dump_at") == 0:
            _dump(dump, state)
        data = SyntheticTokens(cfg.global_batch, cfg.seq_len,
                               model.vocab_size, seed=7)
        steps: list = []

        def on_step(i, metrics):
            steps.append([float(metrics["loss"]),
                          float(metrics["grad_norm"])])
            if spec.get("dump_at") == len(steps):
                _dump(dump, state)

        state, summary = trainer.fit(
            data, state=state, on_step=on_step,
            ckpt_dir=spec.get("ckpt_dir"),
            ckpt_every=spec.get("ckpt_every"))
        keep = ("shard_update", "overlap_comm", "grad_buckets", "world",
                "opt_state_bytes_per_device", "dist_backend", "collective_ms",
                "first_loss", "final_loss", "attn_impl", "mesh")
        if spec.get("final_params"):  # the whole params, from every shard
            import numpy as np

            params = state["params"] if trainer.shard is None \
                else trainer.shard.assemble(state["params"])
            if rank == 0:
                np.savez(f"{spec['out']}-final.npz", **{
                    str(i): t.detach().numpy()
                    for i, t in enumerate(tree_leaves(params))})
        with open(f"{spec['out']}-{rank}.json", "w") as f:
            json.dump({"steps": steps, "rank": rank,
                       **{k: summary[k] for k in keep}}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
