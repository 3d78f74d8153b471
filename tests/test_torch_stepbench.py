"""The port's step bench (``kubedl_tpu_torch/training/stepbench.py``)
against the reference's, on the CPU.

Both CLIs run as subprocesses, side by side: the reference's on two
forced host devices (``python -m kubedl_tpu.training.stepbench --devices
2 --timed-steps 2``), the port's as two gloo ranks started through
``parallel/launch.py`` (``--device cpu``). Their result JSON has the same
keys at every level; the run's shape, each arm's gradient buckets,
whether its update is sharded and its optimizer bytes a device are
equal; the port's arms agree with its replicated arm within 1e-5; and
the replicated arm's final loss is within 1e-6 of one port ``Trainer``
on one process from the same init and data (the two inits differ
between the packages, so losses are not compared across them).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMED_STEPS = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stepbench")
    base = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = {
        "ref": ([sys.executable, "-m", "kubedl_tpu.training.stepbench",
                 "--devices", "2", "--timed-steps", str(TIMED_STEPS),
                 "--json", str(tmp / "ref.json")],
                dict(base, JAX_PLATFORMS="cpu")),
        # two ranks share the host: two threads each keep them off each
        # other's cores
        "port": ([sys.executable, "-m", "kubedl_tpu_torch.training.stepbench",
                  "--devices", "2", "--timed-steps", str(TIMED_STEPS),
                  "--device", "cpu", "--json", str(tmp / "port.json")],
                 dict(base, OMP_NUM_THREADS="2")),
    }
    procs = {k: subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, (argv, env) in runs.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, f"{k}: {stderr[-3000:]}"
            out[k] = json.loads((tmp / f"{k}.json").read_text())
            out[k + "_stdout"] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _keys(node, path=""):
    if not isinstance(node, dict):
        return set()
    out = set()
    for k, v in node.items():
        out.add(f"{path}/{k}")
        out |= _keys(v, f"{path}/{k}")
    return out


def test_result_has_the_references_keys_at_every_level(results):
    assert _keys(results["port"]) == _keys(results["ref"])
    assert set(results["port"]["arms"]) == {"replicated", "sharded",
                                            "sharded_overlap"}


@pytest.mark.parametrize("key", ["devices", "mesh", "model_params",
                                 "global_batch", "seq_len", "grad_accum",
                                 "timed_steps"])
def test_run_shape_equals_reference(results, key):
    assert results["port"][key] == results["ref"][key]


@pytest.mark.parametrize("key", ["grad_buckets", "shard_update_compiled",
                                 "opt_state_bytes_per_device"])
@pytest.mark.parametrize("arm", ["replicated", "sharded", "sharded_overlap"])
def test_arm_layout_equals_reference(results, arm, key):
    assert results["port"]["arms"][arm][key] == results["ref"]["arms"][arm][key]


def test_arms_agree_and_the_update_is_sharded(results):
    port = results["port"]
    proxy = port["proxy"]
    assert proxy["max_loss_delta"] <= 1e-5
    assert proxy["opt_state_bytes_reduced"] is True
    for arm in port["arms"].values():
        assert np.isfinite(arm["final_loss"])
        assert arm["step_ms"] > 0 and arm["update_ms"] > 0
        assert arm["exposed_comm_ms"] >= 0.0
    assert port["compute_ms"] > 0
    ranks = [json.loads(ln)["stepbench_rank"]
             for ln in results["port_stdout"].splitlines()
             if ln.startswith('{"stepbench_rank"')]
    assert sorted(r["rank"] for r in ranks) == [0, 1]
    assert all(r["device"] == "cpu" for r in ranks)


def test_replicated_arm_matches_one_process_trainer(results):
    """The replicated arm's final loss (2 warmup + 2 timed steps) against
    one port Trainer on one process from the same generator and data."""
    from kubedl_tpu_torch.training import stepbench as sb
    from kubedl_tpu_torch.training.data import SyntheticTokens
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    port = results["port"]
    cfg = TrainConfig(model=sb._bench_model(),
                      global_batch=port["global_batch"],
                      seq_len=port["seq_len"], steps=TIMED_STEPS,
                      grad_accum=port["grad_accum"], shard_update=False,
                      overlap_comm=False)
    tr = Trainer(cfg, device="cpu")
    state = tr.init_fn(torch.Generator(device="cpu").manual_seed(0))
    data = SyntheticTokens(cfg.global_batch, cfg.seq_len,
                           cfg.model.vocab_size, seed=7)
    for _ in range(sb.WARMUP_STEPS + TIMED_STEPS):
        state, metrics = tr.train_step(state, next(data))
    assert abs(float(metrics["loss"])
               - port["arms"]["replicated"]["final_loss"]) <= 1e-6
