"""One rank of a data-parallel run of the port, for the CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_training.py``).

Run as ``python tests/torch_dist_worker.py '<json spec>'`` with the job's
env (``KUBEDL_NUM_PROCESSES``, ``KUBEDL_PROCESS_ID``,
``KUBEDL_COORDINATOR_ADDRESS``); :func:`run_ranks` starts the ranks and
returns what each wrote. It imports torch and the port only, never JAX.

The spec: ``train`` (``TrainConfig`` fields, ``model`` a preset name),
``mesh`` (axes), ``init`` (a checkpoint dir whose ``params`` start the
run), ``resume`` (a checkpoint dir whose train state resumes it),
``ckpt_dir`` / ``ckpt_every`` (``fit``'s saves), ``dump_at`` (after that
many steps of the run, or right after the resume when 0, each rank
writes its state's tensors to ``<out>-<rank>-dump.npz``) and ``out`` (each
rank's JSON: per step loss and grad norm, the summary's keys).
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
    import numpy as np

    from kubedl_tpu_torch.training.trainer import tree_leaves

    opt = state["opt_state"]
    specs = opt.get("shards") or [None] * len(opt["mu"])
    arrays = {}
    for name, ts in (("params", tree_leaves(state["params"])),
                     ("mu", opt["mu"]), ("nu", opt["nu"])):
        for i, t in enumerate(ts):
            arrays[f"{name}/{i}"] = t.detach().float().cpu().numpy()
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump([None if s is None else [s.dim, s.start, s.stop]
                   for s in specs], f)


def main(spec: dict) -> None:
    import torch.distributed as dist

    from kubedl_tpu_torch.api.topology import MeshSpec
    from kubedl_tpu_torch.models import llama, moe
    from kubedl_tpu_torch.parallel.mesh import build_mesh, initialize_from_env
    from kubedl_tpu_torch.training import checkpoint as ck
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    initialize_from_env(timeout_s=RANK_TIMEOUT_S / 2)
    try:
        kw = dict(spec["train"])
        name = kw.pop("model")
        model = (moe if "moe" in name else llama).preset(name)
        cfg = TrainConfig(model=model, **kw)
        trainer = Trainer(cfg, build_mesh(MeshSpec(spec["mesh"]), "cpu"))
        rank = trainer.mesh.rank
        state = trainer.init_state()
        if spec.get("init"):
            state["params"] = ck.restore_checkpoint(
                spec["init"], {"params": trainer.family.like()},
                device="cpu")["params"]
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
                "first_loss", "final_loss", "attn_impl")
        with open(f"{spec['out']}-{rank}.json", "w") as f:
            json.dump({"steps": steps, "rank": rank,
                       **{k: summary[k] for k in keep}}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
