"""Analytical per-step cost model for one candidate mesh layout.

The port of ``kubedl_tpu/planner/costmodel.py``, formula for formula and
constant for constant (``tests/test_torch_planner.py`` holds every
estimate within 1e-9 of the reference's on the reference's catalog), on
the port's node shapes (``api/topology.py``: H100 NVLink domains, whose
``ici_gbps`` is the card's NVLink rate and ``dcn_gbps`` its InfiniBand
share). The one change is :func:`calibrated_flops_efficiency`, which
reads a measured MFU only from an artifact that names an NVIDIA card.

Three ingredients, all closed-form (AMP, arXiv 2210.07297, §4 — an
alpha-beta cost model is enough to rank layouts; exactness only matters
within a candidate set priced by the SAME model):

- **Compute**: dense-transformer training flops (6 * params per token,
  matching ``LlamaConfig.flops_per_token``) spread over every device, at
  a fixed fraction of ``SliceTopology.peak_bf16_tflops``. Constant across
  candidates, so it anchors predictions without changing the ranking.
- **Communication**: per-axis collective volume — gradient all-reduce on
  the data/replica axes, param all-gather + gradient reduce-scatter on the
  fsdp axis (ZeRO-3), per-layer activation all-reduces on the tensor axis
  (megatron), ring K/V exchange on the sp axis — priced against
  ``ici_gbps`` for intra-slice axes and ``dcn_gbps`` for the slice-crossing
  replica axis. No overlap is assumed beyond the sharded update's:
  modeled step time is compute + exposed comm.
- **Memory**: params + gradients + Adam moments sharded over (fsdp x
  tensor) and replicated over the batch axes, plus remat-resident
  activations and the loss-chunk logits buffer, against
  ``hbm_gib_per_chip`` with a runtime reserve.

It prices step time and HBM, never money.
"""

from __future__ import annotations

import glob
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubedl_tpu_torch.api.topology import MeshSpec, SliceTopology

#: bytes per element for the dtypes the trainer supports
DTYPE_BYTES = {
    "bfloat16": 2, "bf16": 2,
    "float16": 2, "fp16": 2,
    "float32": 4, "fp32": 4,
}

#: Adam keeps two fp32 moments per parameter (training/trainer.py default
#: opt_moment_dtype="float32").
OPT_BYTES_PER_PARAM = 8

#: Fraction of peak flops an honest dense step achieves. The FALLBACK
#: when no committed bench artifact carries a measured MFU —
#: :func:`calibrated_flops_efficiency` reads the real number from
#: BENCH_*.json history and ``workloads/tpujob.py`` feeds it to
#: :func:`plan` at admission; this constant keeps ``estimate()``
#: deterministic for the formula-pinning unit tests.
MODEL_FLOPS_EFFICIENCY = 0.4

#: Price the trainer's ZeRO-style cross-replica sharded weight update
#: (arXiv 2004.13336; TrainConfig.shard_update, on by default): gradient
#: reduce-scatter + param all-gather on the data axis move the same bytes
#: as the all-reduce they replace, but optimizer state and the update
#: compute drop to 1/data per chip.
UPDATE_SHARDING = True

#: Fraction of the data/replica-axis gradient collective hidden under
#: backward compute by the overlapped microbatch loop
#: (TrainConfig.overlap_comm; arXiv 2011.03641 measures TPU collectives
#: hiding 70-90% under compute once scheduled concurrently — 0.7 is the
#: conservative end). Only the non-hidden remainder counts toward step
#: time; hiding is capped by the compute it hides under.
OVERLAP_FRACTION = 0.7

#: Fraction of HBM the planner may budget; the rest covers the CUDA
#: context, collective scratch, and the caching allocator's fragmentation.
HBM_USABLE_FRACTION = 0.9

#: Residual-stream-sized tensors the remat policy keeps live per layer
#: (models/llama.py: scan + checkpoint saves a handful of per-layer
#: activations; everything else is recomputed in backward).
ACT_SAVED_PER_LAYER = 4.0

#: Live microbatch the memory model assumes: gradient accumulation caps
#: resident activations at one sequence per chip regardless of the
#: per-replica batch (comm volume still counts every sequence — all
#: microbatches cross the wire each step).
ACT_MICROBATCH_SEQS = 1

#: Positions the chunked LM loss materializes at fp32 logits at once
#: (models/llama.py loss_chunk rationale).
LOSS_CHUNK_POSITIONS = 512


@dataclass
class ModelDesc:
    """What the planner needs to know about a training workload.

    Riding ``TPUJob.model_desc``: either give ``params`` directly or the
    transformer dims (``layers``/``hidden``/...) and let the planner derive
    the count. ``global_batch`` is sequences per optimizer step — it fixes
    both the tokens each step must push through the chips and how far the
    batch axes can be stretched.
    """

    params: int = 0  # total parameter count; 0 = derive from the dims
    layers: int = 0
    hidden: int = 0
    ffn: int = 0  # 0 -> 4 * hidden
    vocab: int = 32000
    seq_len: int = 2048
    global_batch: int = 8
    dtype: str = "bfloat16"

    def num_params(self) -> int:
        """``params`` when given, else the standard dense-decoder count:
        4h^2 attention + 3h*ffn gated MLP per layer, plus embeddings."""
        if self.params > 0:
            return self.params
        ffn = self.ffn or 4 * self.hidden
        per_layer = 4 * self.hidden * self.hidden + 3 * self.hidden * ffn
        return self.layers * per_layer + self.vocab * self.hidden

    def flops_per_token(self) -> float:
        """Training flops per token (fwd+bwd), 6*N — the same accounting
        ``LlamaConfig.flops_per_token`` uses for MFU."""
        return 6.0 * self.num_params()

    def bytes_per_param(self) -> int:
        return DTYPE_BYTES[self.dtype]

    def validate(self, prefix: str = "modelDesc") -> List[str]:
        errs: List[str] = []
        if self.params <= 0 and (self.layers <= 0 or self.hidden <= 0):
            errs.append(
                f"{prefix} must give params, or layers+hidden to derive them"
            )
        for name in ("params", "layers", "hidden", "ffn"):
            if getattr(self, name) < 0:
                errs.append(f"{prefix}.{name} must be >= 0")
        if self.vocab < 1:
            errs.append(f"{prefix}.vocab must be >= 1")
        if self.seq_len < 1:
            errs.append(f"{prefix}.seqLen must be >= 1")
        if self.global_batch < 1:
            errs.append(f"{prefix}.globalBatch must be >= 1")
        if self.dtype not in DTYPE_BYTES:
            errs.append(
                f"{prefix}.dtype {self.dtype!r} unknown; one of "
                + ", ".join(sorted(DTYPE_BYTES))
            )
        return errs


#: Small model zoo shared by the golden-plan tests, the planner microbench
#: and the bench section. Batch sizes are chosen so the pure-data-parallel
#: candidate stays *structurally* legal up to 256 chips (512 % 256 == 0) —
#: when DP loses it must lose on memory or comm, not on divisibility.
MODEL_ZOO: Dict[str, ModelDesc] = {
    # matches models/llama.py TINY (the CPU-testable config)
    "tiny": ModelDesc(layers=2, hidden=64, ffn=256, vocab=256,
                      seq_len=128, global_batch=8),
    "gpt-350m": ModelDesc(layers=24, hidden=1024, ffn=4096, vocab=32000,
                          seq_len=2048, global_batch=512),
    "llama-1b": ModelDesc(layers=16, hidden=2048, ffn=8192, vocab=128256,
                          seq_len=2048, global_batch=512),
    "llama-4b": ModelDesc(layers=24, hidden=3072, ffn=12288, vocab=32000,
                          seq_len=2048, global_batch=512),
}


# ---- collective volume primitives (bytes ONE chip sends) -----------------
# Ring-algorithm costs for an n-way collective over a buffer of ``nbytes``
# (the full, unsharded-on-this-axis buffer): these are the standard
# 2(n-1)/n and (n-1)/n factors every topology-aware cost model uses.


def allreduce_bytes(n: int, nbytes: float) -> float:
    return 0.0 if n <= 1 else 2.0 * (n - 1) / n * nbytes


def allgather_bytes(n: int, nbytes: float) -> float:
    return 0.0 if n <= 1 else (n - 1) / n * nbytes


def reduce_scatter_bytes(n: int, nbytes: float) -> float:
    return 0.0 if n <= 1 else (n - 1) / n * nbytes


@dataclass
class CostBreakdown:
    """One candidate layout, fully priced."""

    mesh: MeshSpec
    step_ms: float = math.inf
    compute_ms: float = 0.0
    comm_ms: float = 0.0
    #: per-axis comm cost, e.g. {"data": 1.2, "fsdp": 3.4} (ms)
    comm_ms_by_axis: Dict[str, float] = field(default_factory=dict)
    #: comm left on the critical path after overlap hides part of the
    #: data/replica gradient collective under backward compute;
    #: == comm_ms when the update is not sharded/overlapped
    exposed_comm_ms: float = 0.0
    hbm_gib: float = 0.0
    feasible: bool = False
    reason: str = ""  # why infeasible, when it is


def _axis_sizes(mesh: MeshSpec) -> Dict[str, int]:
    get = mesh.axes.get
    return {
        "replica": get("replica", 1), "data": get("data", 1),
        "fsdp": get("fsdp", 1), "sp": get("sp", 1),
        "tensor": get("tensor", 1),
    }


def hbm_per_chip_gib(
    model: ModelDesc,
    mesh: MeshSpec,
    update_sharding: bool = UPDATE_SHARDING,
) -> float:
    """Per-chip HBM under the candidate sharding: model state sharded over
    (fsdp x tensor), activations over (batch axes x sp), logits over
    tensor. With ``update_sharding`` the gradient accumulator and Adam
    moments additionally shard over the data axis (the trainer's
    cross-replica update; params stay gathered between steps)."""
    ax = _axis_sizes(mesh)
    p = model.num_params()
    state_shard = p / (ax["fsdp"] * ax["tensor"])
    upd = ax["data"] if update_sharding else 1
    state = state_shard * (
        model.bytes_per_param()  # params (gathered between steps)
        + model.bytes_per_param() / upd  # grads (scattered accumulator)
        + OPT_BYTES_PER_PARAM / upd  # Adam moments track the update shard
    )
    seq_local = model.seq_len / ax["sp"]
    act_bytes = DTYPE_BYTES[model.dtype]
    acts = (
        ACT_SAVED_PER_LAYER * model.layers
        * ACT_MICROBATCH_SEQS * seq_local * model.hidden * act_bytes
    ) if model.hidden else 0.0
    logits = (
        ACT_MICROBATCH_SEQS
        * min(LOSS_CHUNK_POSITIONS, seq_local)
        * model.vocab * 4 / ax["tensor"]
    )
    return (state + acts + logits) / 2**30


def estimate(
    model: ModelDesc,
    topo: SliceTopology,
    mesh: MeshSpec,
    num_slices: int = 1,
    update_sharding: bool = UPDATE_SHARDING,
    overlap_fraction: float = OVERLAP_FRACTION,
    efficiency: Optional[float] = None,
) -> CostBreakdown:
    """Price one candidate layout: modeled step time + per-chip HBM.

    The replica axis is the only one allowed to cross slices (search
    guarantees replica == num_slices when num_slices > 1), so it is priced
    at DCN bandwidth; every other axis rides ICI.

    ``update_sharding``/``overlap_fraction`` mirror the trainer's sharded
    weight update and comm/compute overlap: the data/replica gradient
    collective (reduce-scatter + all-gather, same ring bytes as the
    all-reduce it replaces) is partially hidden under backward compute, so
    ``step_ms = compute_ms + exposed_comm_ms``. ``efficiency`` overrides
    MODEL_FLOPS_EFFICIENCY (pass
    ``calibrated_flops_efficiency()[0]`` to price with measured MFU).
    """
    ax = _axis_sizes(mesh)
    out = CostBreakdown(mesh=mesh)

    # ---- memory feasibility ------------------------------------------
    out.hbm_gib = hbm_per_chip_gib(model, mesh, update_sharding)
    budget = topo.hbm_gib_per_chip * HBM_USABLE_FRACTION
    if out.hbm_gib > budget:
        out.reason = (
            f"needs {out.hbm_gib:.1f} GiB/chip, budget {budget:.1f} "
            f"(={HBM_USABLE_FRACTION:.0%} of {topo.hbm_gib_per_chip})"
        )
        return out

    # ---- compute ------------------------------------------------------
    chips = topo.chips * num_slices
    tokens = model.global_batch * model.seq_len
    flops_per_chip = model.flops_per_token() * tokens / chips
    eff = MODEL_FLOPS_EFFICIENCY if efficiency is None else efficiency
    out.compute_ms = flops_per_chip / (
        topo.peak_bf16_tflops * 1e12 * eff
    ) * 1e3

    # ---- communication ------------------------------------------------
    ici = topo.ici_gbps * 1e9
    dcn = topo.dcn_gbps * 1e9
    p_bytes = model.num_params() * model.bytes_per_param()
    # gradient shard each chip owns after fsdp/tensor sharding
    grad_shard = p_bytes / (ax["fsdp"] * ax["tensor"])
    by_axis: Dict[str, float] = {}
    # data axis: grad all-reduce over ICI
    by_axis["data"] = allreduce_bytes(ax["data"], grad_shard) / ici
    # replica axis: the same all-reduce, but over DCN when multislice
    by_axis["replica"] = allreduce_bytes(ax["replica"], grad_shard) / (
        dcn if num_slices > 1 else ici
    )
    # fsdp axis (ZeRO-3): all-gather params fwd + bwd, reduce-scatter grads
    fsdp_buf = p_bytes / ax["tensor"]
    by_axis["fsdp"] = (
        2 * allgather_bytes(ax["fsdp"], fsdp_buf)
        + reduce_scatter_bytes(ax["fsdp"], fsdp_buf)
    ) / ici
    # tensor axis (megatron): 2 activation all-reduces per layer, fwd+bwd.
    # Every sequence crosses the wire each step (grad accum does not shave
    # comm), so the buffer uses the full per-replica batch.
    batch_local = model.global_batch / (ax["replica"] * ax["data"] * ax["fsdp"])
    act_buf = (
        batch_local * (model.seq_len / ax["sp"]) * model.hidden
        * DTYPE_BYTES[model.dtype]
    )
    by_axis["tensor"] = (
        4 * model.layers * allreduce_bytes(ax["tensor"], act_buf) / ici
    )
    # sp axis (ring attention): K and V circulate the ring, fwd + bwd
    by_axis["sp"] = 0.0
    if ax["sp"] > 1:
        kv_buf = act_buf * 2  # K and V, same shape class as the act buffer
        by_axis["sp"] = (
            2 * model.layers * (ax["sp"] - 1) / ax["sp"] * kv_buf / ici
        )
    out.comm_ms_by_axis = {k: v * 1e3 for k, v in by_axis.items() if v > 0}
    out.comm_ms = sum(out.comm_ms_by_axis.values())
    # ---- overlap ------------------------------------------------------
    # The sharded update turns the data/replica grad all-reduce into
    # reduce-scatter + all-gather (same ring bytes); the overlapped
    # microbatch loop hides overlap_fraction of it under backward compute,
    # capped by the compute actually available to hide under. fsdp/tensor/
    # sp collectives stay on the critical path (they gate the very next
    # matmul).
    hidden_ms = 0.0
    if update_sharding and overlap_fraction > 0.0:
        grad_coll_ms = out.comm_ms_by_axis.get("data", 0.0) + (
            out.comm_ms_by_axis.get("replica", 0.0)
        )
        hidden_ms = min(overlap_fraction * grad_coll_ms, out.compute_ms)
    out.exposed_comm_ms = out.comm_ms - hidden_ms
    out.step_ms = out.compute_ms + out.exposed_comm_ms
    out.feasible = True
    return out


# ---- efficiency calibration from bench history ---------------------------


def _walk_mfu(node) -> List[float]:
    """Every dense-MFU number in an artifact, any vintage of layout:
    ``summary.mfu.median``, ``summary.mfu`` (plain float),
    ``parsed.detail.mfu``, ``runs[i].detail.mfu`` — the key is always
    literally "mfu"; long_context_mfu is NOT calibration input (the
    efficiency constant anchors the dense regime)."""
    found: List[float] = []
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "mfu":
                if isinstance(v, (int, float)):
                    found.append(float(v))
                elif isinstance(v, dict) and isinstance(
                    v.get("median"), (int, float)
                ):
                    found.append(float(v["median"]))
            else:
                found.extend(_walk_mfu(v))
    elif isinstance(node, list):
        for v in node:
            found.extend(_walk_mfu(v))
    return found


#: keys whose string value names the device an artifact ran on (the
#: port's results carry ``torch.cuda.get_device_name``, e.g. "NVIDIA H100
#: 80GB HBM3", under "kind")
_DEVICE_NAME_KEYS = ("kind", "device_kind", "device_name")


def _names_nvidia_card(node) -> bool:
    """Whether an artifact names an NVIDIA card under one of
    ``_DEVICE_NAME_KEYS``, at any depth."""
    if isinstance(node, dict):
        return any(
            (k in _DEVICE_NAME_KEYS and isinstance(v, str)
             and "nvidia" in v.lower()) or _names_nvidia_card(v)
            for k, v in node.items()
        )
    if isinstance(node, list):
        return any(_names_nvidia_card(v) for v in node)
    return False


def calibrated_flops_efficiency(repo_root: Optional[str] = None):
    """(efficiency, source): dense MFU measured by the NEWEST committed
    BENCH_*.json that names an NVIDIA card and carries a plausible one,
    else (MODEL_FLOPS_EFFICIENCY, "default").

    The port's rule: a GPU plan is priced only with an MFU measured on a
    GPU. An artifact counts only if it names an NVIDIA card (a string
    holding "nvidia" under a "kind" / "device_kind" / "device_name" key);
    every other one (a TPU or CPU run: all of the repo's artifacts so
    far, so today this returns (0.4, "default")) is skipped whatever MFU
    it carries. Plausible means 0.05 < mfu <= 1.0 — CPU-CI artifacts
    report mfu ~0 and must not drag admission-time step estimates to
    garbage. Medians win over single runs (``_walk_mfu``); multiple
    values in one artifact reduce by median. Reads are cheap (a handful
    of small json files) but the result is cached per repo_root for the
    admission hot path.
    """
    import json
    import statistics

    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    key = os.path.abspath(root)
    if key in _EFFICIENCY_CACHE:
        return _EFFICIENCY_CACHE[key]
    result = (MODEL_FLOPS_EFFICIENCY, "default")
    try:
        arts = sorted(glob.glob(os.path.join(root, "BENCH_*.json")))
    except OSError:
        arts = []
    for path in reversed(arts):  # newest naming first (BENCH_rNN sorts)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not _names_nvidia_card(doc):
            continue
        vals = [v for v in _walk_mfu(doc) if 0.05 < v <= 1.0]
        if vals:
            result = (statistics.median(vals), os.path.basename(path))
            break
    _EFFICIENCY_CACHE[key] = result
    return result


_EFFICIENCY_CACHE: Dict[str, tuple] = {}


__all__ = [
    "DTYPE_BYTES", "OPT_BYTES_PER_PARAM", "MODEL_FLOPS_EFFICIENCY",
    "UPDATE_SHARDING", "OVERLAP_FRACTION", "HBM_USABLE_FRACTION",
    "ACT_SAVED_PER_LAYER", "ACT_MICROBATCH_SEQS", "LOSS_CHUNK_POSITIONS",
    "ModelDesc", "MODEL_ZOO", "allreduce_bytes", "allgather_bytes",
    "reduce_scatter_bytes", "CostBreakdown", "hbm_per_chip_gib", "estimate",
    "calibrated_flops_efficiency",
]
