"""Single-device trainer: the port of ``kubedl_tpu/training/trainer.py``.

One device, eager PyTorch: the train step runs forward and backward
through the model family's loss, then the optimizer updates the
parameters IN PLACE (the reference donates its state buffers to a jitted
step; here the state dict keeps the same tensors and rewrites them).

What a one-device port keeps of the reference, and how:

- ``TrainConfig`` has every field of the reference. ``shard_update`` and
  ``overlap_comm`` are accepted and are no-ops, as they are in the
  reference on a one-device mesh (there is no data axis to scatter over);
  ``grad_bucket_mb`` and ``init_rng_impl`` are accepted and unused (there
  are no collectives, and a ``torch.Generator`` has one implementation).
- :func:`make_optimizer` is a plain-PyTorch port of the optax chain
  ``clip_by_global_norm -> adamw(warmup_cosine_decay_schedule)``, step
  for step: optax counts from 0, so the FIRST update runs at
  ``lr = schedule(0)`` (0.0 with the trainer's warmup); the first moment
  ``mu`` is kept in ``opt_moment_dtype`` but the second moment ``nu`` in
  the PARAMETERS' dtype (bf16 for bf16 models); weight decay applies to
  every leaf, norms included. The global norm is taken in float32.
- ``fit`` keeps the reference's timing discipline: the clock after the
  first step and at the end stops on a scalar ``.item()`` of the loss, a
  true barrier; steps between logs issue no host sync. Summary keys with
  no counterpart here (``warm_compile_s`` and the other ahead-of-time
  compile keys, ``grad_buckets``, ``flash_trace_count``) are None;
  ``flash_launches`` carries the kernels' launch counts instead.

What it rejects with a ValueError naming the later port slice, never
silently: a mesh of more than one device (or any ``sp``/``pipe`` axis
above 1), ``ckpt_every > 0``, ``fit(ckpt_dir=...)``, ``fit_ps`` and MoE.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch import resolve_device
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.ops import flash_attention as fa

MULTI_CHIP = "the multi-chip port slice"
LATER = "a later port slice"


@dataclass(frozen=True)
class ModelFamily:
    """Adapter the trainer uses to stay model-agnostic: init/loss
    functions plus FLOPs accounting."""

    name: str
    init: Callable[[torch.Generator, torch.device], Any]
    loss: Callable[..., torch.Tensor]  # (params, batch, attn_fn=) -> scalar
    num_params: int
    flops_per_token: float
    vocab_size: int


def llama_family(cfg: llama.LlamaConfig) -> ModelFamily:
    return ModelFamily(
        name="llama",
        init=lambda gen, device: llama.llama_init(cfg, gen, device),
        loss=lambda params, batch, attn_fn=None: llama.llama_loss(
            params, batch, cfg, attn_fn
        ),
        num_params=cfg.num_params(),
        flops_per_token=cfg.flops_per_token(),
        vocab_size=cfg.vocab_size,
    )


def moe_family(cfg) -> ModelFamily:
    raise ValueError(f"MoE training is not ported yet: it belongs to the "
                     f"MoE port slice ({type(cfg).__name__})")


def family_for(model_cfg) -> ModelFamily:
    if isinstance(model_cfg, llama.LlamaConfig):
        return llama_family(model_cfg)
    if isinstance(model_cfg, ModelFamily):
        return model_cfg
    if hasattr(model_cfg, "n_experts"):
        return moe_family(model_cfg)
    raise TypeError(f"unknown model config type {type(model_cfg)!r}")


@dataclass(frozen=True)
class TrainConfig:
    model: Any = field(default_factory=lambda: llama.TINY)
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 50
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: microbatches per step (gradient accumulation); 1 = off
    grad_accum: int = 1
    #: "auto" (flash on CUDA, dense on the CPU), "dense", or "flash"
    #: (forced: the kernels on CUDA, their plain versions on the CPU)
    attn_impl: str = "auto"
    context_parallel_impl: str = "ring"
    microbatches: int = 0
    #: periodic checkpoints: not ported yet (must stay 0)
    ckpt_every: int = 0
    ckpt_async: bool = True
    #: dtype of the adam FIRST moment (mu); nu keeps the params' dtype
    opt_moment_dtype: str = "float32"
    init_rng_impl: str = "rbg"
    shard_update: bool = True
    overlap_comm: bool = True
    grad_bucket_mb: float = 4.0
    #: fetch the loss to the host every N steps in ``fit`` (plus the first
    #: and the final step); every fetch is a device barrier
    log_every: int = 0
    long_context_policy: str = "auto"
    long_context_threshold: int = 4096
    seed: int = 0


# ---- optimizer: the optax chain, in plain PyTorch ---------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps``. count -> float."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps, weight_decay, mu_dtype))`` over a list of parameter tensors.

    State: ``{"count": int, "mu": [...], "nu": [...]}``. ``update``
    rewrites the parameters (and the moments) in place and returns the
    float32 global norm of the incoming gradients. Per leaf, with t the
    number of updates before this one:

        g   = clip(g)                       (in g's dtype)
        mu  = (1 - b1) g + b1 mu            (promoted; stored as mu_dtype)
        nu  = (1 - b2) g^2 + b2 nu          (in the params' dtype)
        u   = mu / (1 - b1^(t+1)) / (sqrt(nu / (1 - b2^(t+1))) + eps)
        p   = p - schedule(t) (u + weight_decay p)

    so the first update, at schedule(0), moves nothing when the warmup
    starts from 0."""

    def __init__(self, schedule, grad_clip: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32) -> None:
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, leaves: List[torch.Tensor]) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
        }

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               leaves: List[torch.Tensor]) -> torch.Tensor:
        gnorm = self.global_norm(grads)
        keep = gnorm < self.grad_clip  # stays on the device: no host sync
        lr = self.schedule(state["count"])
        state["count"] += 1
        t = state["count"]
        corrections: Dict[Tuple[float, torch.dtype], float] = {}

        def bias_correction(decay: float, dtype: torch.dtype) -> float:
            # optax: 1 - decay**t in float32, cast to the moment's dtype;
            # kept a host scalar (a CPU tensor copied to the card would
            # synchronise the stream at every leaf)
            key = (decay, dtype)
            if key not in corrections:
                bc = 1.0 - torch.tensor(decay, dtype=torch.float32) ** t
                corrections[key] = float(bc.to(dtype))
            return corrections[key]

        for i, (g, p) in enumerate(zip(grads, leaves)):
            g = torch.where(keep, g, (g / gnorm.to(g.dtype)) * self.grad_clip)
            mu = (1 - self.b1) * g + self.b1 * state["mu"][i]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][i]
            mu_hat = mu / bias_correction(self.b1, mu.dtype)
            nu_hat = nu / bias_correction(self.b2, nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + u * (-lr))
            state["mu"][i] = mu.to(self.mu_dtype)
            state["nu"][i] = nu
        return gnorm


def make_optimizer(cfg: TrainConfig) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.1,
    )
    return AdamW(schedule, cfg.grad_clip, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=cfg.weight_decay,
                 mu_dtype=_DTYPES[cfg.opt_moment_dtype])


# ---- parameter trees (nested dicts of tensors) -------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


#: count of host scalar fetches (each a device barrier), as in the reference
SCALAR_FETCHES = 0


def _fetch_scalar(x: torch.Tensor) -> float:
    """True device barrier: bring one scalar to the host."""
    global SCALAR_FETCHES
    SCALAR_FETCHES += 1
    return float(x.item())


def state_bytes_per_device(state, key: str = "opt_state") -> int:
    """Bytes of the optimizer moments (one device holds them all)."""
    opt = state[key]
    return sum(t.numel() * t.element_size() for t in opt["mu"] + opt["nu"])


class Trainer:
    """The reference's ``Trainer`` on one device (see the module
    docstring for what is ported and what raises)."""

    def __init__(self, cfg: TrainConfig, mesh=None, device=None) -> None:
        self.device = resolve_device(device)
        axes = fa.mesh_axes(mesh)
        if fa.mesh_size(mesh) > 1 or any(
                axes.get(a, 1) > 1 for a in ("sp", "pipe")):
            raise ValueError(
                f"mesh {axes}: training over more than one device (data, "
                f"fsdp, tensor, sequence or pipeline axes) belongs to "
                f"{MULTI_CHIP}"
            )
        if cfg.ckpt_every > 0:
            raise ValueError(f"ckpt_every={cfg.ckpt_every}: checkpointing "
                             f"(training/checkpoint.py) belongs to {LATER}")
        if cfg.global_batch % cfg.grad_accum:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split into grad_accum={cfg.grad_accum}")
        self.mesh = mesh
        self.cfg = cfg
        cfg = self._apply_long_context_policy(cfg)
        self.family = family_for(cfg.model)
        self.tx = make_optimizer(cfg)
        self.attn_impl = "dense"
        self.attn_fn = self._select_attn()

    def _apply_long_context_policy(self, cfg: TrainConfig) -> TrainConfig:
        """At seq_len >= long_context_threshold a remat'ing Llama config is
        upgraded to the "flash_rope" policy and a chunked loss (the
        reference's pass); what changed rides the fit summary."""
        self.long_context_policy_applied = ""
        if (
            cfg.long_context_policy != "auto"
            or cfg.seq_len < cfg.long_context_threshold
            or not isinstance(cfg.model, llama.LlamaConfig)
        ):
            return cfg
        m = cfg.model
        changes: Dict[str, Any] = {}
        if m.remat and m.remat_policy not in ("flash", "flash_rope"):
            changes["remat_policy"] = "flash_rope"
        if m.loss_chunk == 0:
            changes["loss_chunk"] = 512
        if not changes:
            return cfg
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(m, **changes))
        self.cfg = cfg
        self.long_context_policy_applied = ",".join(
            f"{k}={v}" for k, v in sorted(changes.items())
        )
        return cfg

    def _select_attn(self):
        """Pick the attention path once: "auto" is flash on CUDA and dense
        on the CPU; "flash" forces the kernel route (on the CPU its
        operators run their plain versions)."""
        cfg = self.cfg
        if cfg.attn_impl == "dense":
            return None
        on_cuda = self.device.type == "cuda"
        if cfg.attn_impl == "flash" or (cfg.attn_impl == "auto" and on_cuda):
            if not fa.supports(cfg.seq_len):
                if cfg.attn_impl == "flash":
                    raise ValueError(
                        f"flash attention cannot tile seq_len={cfg.seq_len}"
                    )
                return None
            self.attn_impl = "flash"
            return fa.make_flash_attention(self.mesh)
        return None

    # ------------------------------------------------------------------

    def init_fn(self, generator: torch.Generator) -> Dict[str, Any]:
        """The whole train state from an explicit generator (on the
        trainer's device): params, optimizer state, step 0."""
        params = self.family.init(generator, self.device)
        return {"params": params,
                "opt_state": self.tx.init(tree_leaves(params)), "step": 0}

    def init_state(self) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return self.init_fn(gen)

    def shard_batch(self, batch) -> torch.Tensor:
        """A host batch (numpy) or tensor, on the trainer's device. A host
        batch goes up from pinned memory without blocking, so the upload
        does not wait for the previous step (as ``device_put`` does not)."""
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        host = torch.from_numpy(np.asarray(batch))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def value_and_grad(self, params, batch: torch.Tensor):
        """(loss, grads as a list in ``tree_leaves(params)`` order)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = self.family.loss(tree_unflatten(params, leaves), batch,
                                    attn_fn=self.attn_fn)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def train_step(self, state: Dict[str, Any], batch):
        """One optimizer step (with ``grad_accum`` microbatches); updates
        ``state`` in place and returns it with ``{"loss", "grad_norm"}``
        (device scalars: reading them is a host sync)."""
        batch = self.shard_batch(batch)
        params = state["params"]
        n = self.cfg.grad_accum
        if n > 1:
            micro = batch.reshape(n, batch.shape[0] // n, batch.shape[1])
            loss, grads = self.value_and_grad(params, micro[0])
            for mb in micro[1:]:
                l_i, g_i = self.value_and_grad(params, mb)
                loss = loss + l_i
                grads = [a + b for a, b in zip(grads, g_i)]
            grads = [g / n for g in grads]
            loss = loss / n
        else:
            loss, grads = self.value_and_grad(params, batch)
        gnorm = self.tx.update(grads, state["opt_state"], tree_leaves(params))
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        data: Iterator,
        state: Optional[Dict[str, Any]] = None,
        steps: Optional[int] = None,
        on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: Optional[int] = None,
        ckpt_peer: str = "",
        warm_join_timeout: Optional[float] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Run the loop; returns (state, summary) with the reference's
        metrics (first-step latency, tokens/s, MFU, ...). ``steps`` is the
        TOTAL budget: a state whose step is already k trains steps-k
        more."""
        del ckpt_peer, warm_join_timeout
        if ckpt_dir or ckpt_every:
            raise ValueError(f"checkpoints (ckpt_dir={ckpt_dir!r}, "
                             f"ckpt_every={ckpt_every}) belong to {LATER}")
        steps = steps or self.cfg.steps
        state = state or self.init_state()
        t_sync = time.perf_counter()
        self._sync()
        start = int(state["step"])
        pre_loop_sync_s = time.perf_counter() - t_sync
        tokens_per_step = self.cfg.global_batch * self.cfg.seq_len
        log_every = self.cfg.log_every
        loss_log: List[Tuple[int, float]] = []
        steps_run = 0
        last_loss_arr = None
        first_loss = None
        first_step_s = 0.0
        t0 = time.perf_counter()
        t_run = t0
        for i in range(start, steps):
            state, metrics = self.train_step(state, next(data))
            last_loss_arr = metrics["loss"]
            steps_run += 1
            if i == start:
                first_loss = _fetch_scalar(metrics["loss"])
                first_step_s = time.perf_counter() - t0
                t_run = time.perf_counter()
            elif log_every and (i + 1) % log_every == 0 and i + 1 < steps:
                loss_log.append((i + 1, _fetch_scalar(metrics["loss"])))
            if on_step is not None:
                on_step(i, metrics)
        if steps_run:
            last_loss = _fetch_scalar(last_loss_arr)
        else:
            last_loss = first_loss = float("nan")
        total = time.perf_counter() - t_run
        steady = steps_run - 1
        tps = tokens_per_step * steady / total if total > 0 and steady > 0 \
            else 0.0
        summary: Dict[str, Any] = {
            "warm_compile_join_s": None,
            "warm_compile_s": None,
            "warm_join_timed_out": None,
            "pre_loop_sync_s": pre_loop_sync_s,
            "first_step_seconds": first_step_s,
            "steps": steps_run,
            "total_steps": steps,
            "start_step": start,
            "first_loss": first_loss,
            "final_loss": last_loss,
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps,
            "step_time_ms": total / steady * 1e3 if steady > 0 else 0.0,
            "mfu": self._mfu(tps, 1),
            "hbm_floor_ms": self.hbm_floor_ms(),
            "attn_impl": self.attn_impl,
            "model_family": self.family.name,
            "n_params": self.family.num_params,
            "shard_update": False,
            "overlap_comm": False,
            "long_context_policy": self.long_context_policy_applied,
            "grad_buckets": None,
            "opt_state_bytes_per_device": state_bytes_per_device(state),
            "log_every": log_every,
            "loss_log": loss_log,
            "device": str(self.device),
            "device_kind": self._device_kind(),
            "flash_trace_count": None,
            "flash_launches": dict(fa.LAUNCHES),
        }
        summary["sanity_violations"] = self.sanity_check(summary)
        summary["ckpt_async"] = False
        return state, summary

    def fit_ps(self, *args, **kwargs):
        raise ValueError(f"parameter-service training (fit_ps) belongs to "
                         f"{LATER}")

    # ------------------------------------------------------------------

    def _device_kind(self) -> str:
        if self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    def _mfu(self, tokens_per_sec: float, n_chips: int) -> float:
        """Model FLOPs utilization against the device's peak (0.0 where
        the peak is unknown, e.g. on the CPU)."""
        from kubedl_tpu_torch.api.topology import peak_flops_for_device_kind

        peak = peak_flops_for_device_kind(self._device_kind())
        if peak <= 0 or tokens_per_sec <= 0:
            return 0.0
        return self.family.flops_per_token * tokens_per_sec / (peak * n_chips)

    def hbm_floor_ms(self) -> float:
        """Lower bound on step time: one read and one write of the bf16
        params at the device's memory rate."""
        from kubedl_tpu_torch.api.topology import hbm_bandwidth_for_device_kind

        bw = hbm_bandwidth_for_device_kind(self._device_kind())
        if bw <= 0:
            return 0.0
        return 2.0 * self.family.num_params * 2 / bw * 1e3

    def sanity_check(self, summary: Dict[str, Any]) -> List[str]:
        """Hard plausibility gates; returns violations (empty = sane)."""
        v: List[str] = []
        mfu = summary.get("mfu", 0.0)
        if mfu > 1.0:
            v.append(f"mfu {mfu:.3f} > 1.0 is physically impossible")
        floor = self.hbm_floor_ms()
        st = summary.get("step_time_ms", 0.0)
        if floor > 0 and 0 < st < floor:
            v.append(
                f"step_time {st:.3f}ms below HBM param-read floor {floor:.3f}ms"
            )
        steps = summary.get("steps", 0)
        fl, ll = summary.get("first_loss"), summary.get("final_loss")
        if steps >= 8 and fl is not None and ll is not None and not ll < fl:
            v.append(f"loss did not decrease over {steps} steps ({fl} -> {ll})")
        return v


__all__ = [
    "ModelFamily", "llama_family", "moe_family", "family_for", "TrainConfig",
    "AdamW", "make_optimizer", "warmup_cosine_decay_schedule", "Trainer",
    "tree_leaves", "tree_unflatten", "state_bytes_per_device",
]
