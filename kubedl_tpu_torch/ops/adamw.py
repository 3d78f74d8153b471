"""The optimizer update as one operator: clip by global norm, then AdamW.

The reference gets this pass from XLA, not from a Pallas kernel: its
jitted train step (``kubedl_tpu/training/trainer.py:675-735``) compiles
the optax chain ``clip_by_global_norm -> adamw``
(``trainer.py:193-211``) into a few fusions. Eager PyTorch would run
about fourteen passes a leaf with float32 temporaries; the port writes
the fused pass by hand (``csrc/adamw.cu``).

What it computes is what the COMPILED reference computes, which is not
its source read eagerly. A Python scalar takes the type of the tensor it
meets (``0.1 * g`` multiplies a bf16 ``g`` by bf16(0.1) = 0.10009765625),
and XLA drops a bf16 rounding wherever the rounded value would only be
widened to float32 again (excess precision). Per leaf, with P the
parameters' type (also the gradient's and ``nu``'s), M the first
moment's, Q = promote(P, M), R_X rounding to X (nothing for float32) and
every other operation one float32 operation::

    norm = R_C(sqrt(R_C(...R_C(R_P0(S0) + R_P1(S1)) ... )))
           S_i = sum of f32(g)^2 over leaf i, in float32; the leaves in
           the order given (the reference's tree order), C the chain's
           type (bf16 while every leaf so far is bf16)
    keep = norm < R_C(clip)
    gc   = g                                  if keep
           R_P(R_P(g / R_P(norm)) * R_P(clip))  otherwise
    mu'  = R_Q(R_Q(gc * R_P(1 - b1)) + R_Q(mu * R_M(b1)))
    nu'  = R_P(R_P(R_P(gc * gc) * R_P(1 - b2)) + R_P(nu * R_P(b2)))
    den  = R_Q(R_P(sqrt(R_P(nu' / bc2))) + R_P(eps))
    u    = mu' / (bc1 * den)                  if Q is float32 (XLA's form
                                              of mu' / bc1 / den)
           R_Q(R_Q(mu' / bc1) / den)          if Q is bf16
    w    = R_Q(u + R_Q(p * R_P(wd)))
    p'   = R_P(p + R_Q(R_Q(-lr) * w));  mu <- R_M(mu');  nu <- nu'

with ``bc1 = R_Q(1 - b1^t)`` and ``bc2 = R_P(1 - b2^t)`` (``b^t`` in
float32) and ``lr = schedule(t - 1)`` host scalars (:func:`step_scalars`).
With ``clip=None`` there is no clipping stage at all: no norm is taken,
``gc = g``, and ``stats`` is ``None`` (``optax.adam``; :class:`Adam`).

Two implementations behind :func:`adamw_update`, picked by where the
tensors live: CPU tensors take :func:`adamw_update_plain` (each line
above one PyTorch operation), CUDA tensors launch the kernels or raise.
The kernels do the same float32 operations in the same order, so at a
step that does not clip they give the plain version's bits; the norm's
float32 sums run in another order, so where it clips the scale may
differ in its last bits. Both update p, mu and nu IN PLACE (the
reference donates them to its jitted step) and return the float32
``stats`` ``[norm, S_0, ..., S_{L-1}]`` as a device tensor: nothing is
read back to the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence

import torch

from kubedl_tpu_torch.ops.build import (
    check_launch, float_workspace, load_adamw_kernels, stream_handle,
)

#: the sharded update's cross-rank sum of the norm's partial sums: float32
#: ``[S_0, ..., S_{L-1}]`` of this rank's shards in, their sums over the
#: ranks that share the update out (see :func:`adamw_update`)
SumPartials = Callable[[torch.Tensor], torch.Tensor]

#: kernel launches, by kernel, read by a run to show its main path went
#: through them: per step one "adamw_norm" and one "adamw_update" a leaf,
#: one "adamw_norm_finish" (with ``clip=None`` only the updates)
LAUNCHES = {"adamw_norm": 0, "adamw_norm_finish": 0, "adamw_update": 0}

#: leaves one call takes (the finish kernel's table; the source's
#: kMaxLeaves)
MAX_LEAVES = 256
#: the kernels' CTA width and elements a thread takes a step (the
#: source's kThreads, kVec), and the norm's CTA cap a leaf
THREADS, VEC, NORM_BLOCK_CAP = 256, 8, 528


def norm_blocks(n: int) -> int:
    """The CTAs (and float32 slots) the norm of an ``n``-element leaf
    takes. Mirrors the source's ``kdl_adamw_norm_blocks``."""
    chunks = -(-n // VEC)
    return max(1, min(-(-chunks // THREADS), NORM_BLOCK_CAP))


def _round(x: float, dtype: torch.dtype) -> float:
    """``x`` (a Python float) rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _f32(x: float) -> float:
    return _round(x, torch.float32)


@dataclasses.dataclass(frozen=True)
class StepScalars:
    """A leaf's host scalars for one step, each a float32 value: the
    kernel takes them in this order (the source's ``Scalars``)."""

    clip_cmp: float  # R_C(clip): compared with the norm
    clip: float  # R_P(clip)
    a1: float  # R_P(1 - b1)
    d1: float  # R_M(b1)
    a2: float  # R_P(1 - b2)
    d2: float  # R_P(b2)
    eps: float  # R_P(eps)
    wd: float  # R_P(weight_decay)
    bc1: float  # R_Q(1 - b1^t)
    bc2: float  # R_P(1 - b2^t)
    neg_lr: float  # R_Q(-lr)

    def as_floats(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@functools.lru_cache(maxsize=64)
def step_scalars(lr: float, t: int, b1: float, b2: float, eps: float,
                 weight_decay: float, clip: Optional[float],
                 p_dtype: torch.dtype,
                 mu_dtype: torch.dtype,
                 chain_dtype: torch.dtype) -> StepScalars:
    """The scalars of update ``t`` (1-based) of a leaf of type
    ``p_dtype`` with its first moment in ``mu_dtype``; ``chain_dtype``:
    the norm's type (:func:`_chain_dtype`); ``clip`` None: no clipping
    stage."""
    q = torch.promote_types(p_dtype, mu_dtype)

    if clip is None:  # no clipping stage: clip_cmp and clip go unread
        clip = math.inf

    def bias(decay, dtype):
        # optax: 1 - decay**count in float32, cast to the moment's type
        return _round(float(1.0 - torch.tensor(decay, dtype=torch.float32)
                            ** t), dtype)

    return StepScalars(
        clip_cmp=_round(clip, chain_dtype), clip=_round(clip, p_dtype),
        a1=_round(1 - b1, p_dtype), d1=_round(b1, mu_dtype),
        a2=_round(1 - b2, p_dtype), d2=_round(b2, p_dtype),
        eps=_round(eps, p_dtype), wd=_round(weight_decay, p_dtype),
        bc1=bias(b1, q), bc2=bias(b2, p_dtype),
        neg_lr=_round(-_f32(lr), q),
    )


def _chain_dtype(dtypes: Sequence[torch.dtype]) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def _rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 tensor rounded to ``dtype`` (kept as float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


# ---- the plain version ------------------------------------------------------

def global_norm_plain(grads: Sequence[torch.Tensor],
                      sum_partials: Optional[SumPartials] = None
                      ) -> torch.Tensor:
    """``[norm, S_0, ...]`` (see the module docstring); ``sum_partials``
    as in :func:`adamw_update`."""
    sums = torch.stack([g.float().square().sum() for g in grads])
    if sum_partials is not None:
        sums = sum_partials(sums)
    chain, cdt = _rnd(sums[0], grads[0].dtype), grads[0].dtype
    for g, s in zip(grads[1:], sums[1:]):
        cdt = torch.promote_types(cdt, g.dtype)
        chain = _rnd(chain + _rnd(s, g.dtype), cdt)
    norm = _rnd(torch.sqrt(chain), cdt)
    return torch.cat([norm[None], sums])


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device: a divisor. (On
    CUDA, PyTorch divides by a Python scalar as a multiplication by its
    reciprocal, which is not the division's rounding.)"""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _leaf_plain(g, p, mu, nu, norm, c: StepScalars) -> None:
    """One leaf's update; ``norm`` None: no clipping stage."""
    P, M = p.dtype, mu.dtype
    Q = torch.promote_types(P, M)
    gf, pf = g.float(), p.float()
    bc1, bc2 = _scalar(c.bc1, gf), _scalar(c.bc2, gf)
    if norm is None:
        gc = gf
    else:
        keep = norm < c.clip_cmp  # a device bool: no host sync
        gc = torch.where(keep, gf,
                         _rnd(_rnd(gf / _rnd(norm, P), P) * c.clip, P))
    t1 = _rnd(gc * c.a1, Q)
    t2 = _rnd(mu.float() * c.d1, Q)
    m = _rnd(t1 + t2, Q)
    sq = _rnd(gc * gc, P)
    v = _rnd(_rnd(sq * c.a2, P) + _rnd(nu.float() * c.d2, P), P)
    nu_hat = _rnd(v / bc2, P)
    s = _rnd(torch.sqrt(nu_hat), P)
    den = _rnd(s + c.eps, Q)
    if Q == torch.float32:
        u = m / (bc1 * den)
    else:
        u = _rnd(_rnd(m / bc1, Q) / den, Q)
    w = _rnd(u + _rnd(pf * c.wd, Q), Q)
    step = _rnd(c.neg_lr * w, Q)
    p.copy_(pf + step)
    mu.copy_(m)
    nu.copy_(v)


def adamw_update_plain(grads, params, mus, nus,
                       scalars: Sequence[StepScalars],
                       clip: bool = True,
                       sum_partials: Optional[SumPartials] = None
                       ) -> Optional[torch.Tensor]:
    """The plain PyTorch version: the module docstring's lines, one
    PyTorch operation each; updates ``params``, ``mus`` and ``nus`` in
    place and returns ``stats``. ``clip`` False: no clipping stage, no
    norm, returns None."""
    stats = global_norm_plain(grads, sum_partials) if clip else None
    for g, p, m, v, c in zip(grads, params, mus, nus, scalars):
        _leaf_plain(g, p, m, v, None if stats is None else stats[0], c)
    return stats


# ---- the kernels ------------------------------------------------------------

_LIB: list = []
#: the norm's float32 slots of each (device, stream)
_WS: dict = {}


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _cuda_update(grads, params, mus, nus, scalars, clip: bool,
                 sum_partials: Optional[SumPartials] = None
                 ) -> Optional[torch.Tensor]:
    dev = grads[0].device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):  # the kernels launch on it
            return _cuda_update(grads, params, mus, nus, scalars, clip,
                                sum_partials)
    L = len(grads)
    if L > MAX_LEAVES:
        raise ValueError(f"adamw kernel takes at most {MAX_LEAVES} leaves, "
                         f"got {L}")
    for g, p, m, v in zip(grads, params, mus, nus):
        if p.dtype not in _KERNEL_DTYPES or m.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"adamw kernel: parameters and mu must be bf16 "
                             f"or float32, got {p.dtype} / {m.dtype}")
        if not all(t.is_contiguous() for t in (g, p, m, v)):
            raise ValueError("adamw kernel needs contiguous g, p, mu and nu")
        if g.numel() >= 2**31:
            raise ValueError(f"adamw kernel: a leaf of {g.numel()} elements "
                             f"(at most 2^31 - 1)")
    if not _LIB:
        _LIB.append(load_adamw_kernels())
    lib = _LIB[0]
    stream = stream_handle(dev)
    stats = _cuda_norm(lib, grads, dev, stream) if clip else None
    if stats is not None and sum_partials is not None:
        # the finish again, on the summed partials: one slot a leaf
        stats = _norm_finish(lib, sum_partials(stats[1:].clone()),
                             list(range(L + 1)), grads, dev, stream)
    norm_ptr = 0 if stats is None else stats.data_ptr()  # NULL: no clip
    for g, p, m, v, c in zip(grads, params, mus, nus, scalars):
        err = lib.kdl_adamw_update(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            norm_ptr, p.numel(), int(p.dtype == torch.bfloat16),
            int(m.dtype == torch.bfloat16), int(_aligned(g, p, m, v)),
            (ctypes.c_float * 11)(*c.as_floats()), stream)
        if err:
            check_launch(err, "adamw_update")
        LAUNCHES["adamw_update"] += 1
    return stats


def _cuda_norm(lib, grads, dev, stream) -> torch.Tensor:
    """``stats`` on the card: one sum-of-squares launch a leaf, then the
    finish."""
    L = len(grads)
    blocks = [norm_blocks(g.numel()) for g in grads]
    offsets = [0]
    for b in blocks:
        offsets.append(offsets[-1] + b)
    slots = float_workspace(_WS, dev, stream, offsets[-1])
    base = slots.data_ptr()
    for g, off in zip(grads, offsets):
        err = lib.kdl_adamw_sumsq(g.data_ptr(), g.numel(),
                                  int(g.dtype == torch.bfloat16),
                                  int(_aligned(g)), base + 4 * off, stream)
        if err:
            check_launch(err, "adamw_sumsq")
        LAUNCHES["adamw_norm"] += 1
    return _norm_finish(lib, slots, offsets, grads, dev, stream)


def _norm_finish(lib, slots: torch.Tensor, offsets, grads, dev,
                 stream) -> torch.Tensor:
    """``stats`` from the float32 ``slots`` (leaf i's in
    ``[offsets[i], offsets[i + 1])``): the finish kernel."""
    L = len(grads)
    stats = torch.empty(1 + L, dtype=torch.float32, device=dev)
    err = lib.kdl_adamw_norm_finish(
        slots.data_ptr(), (ctypes.c_int * (L + 1))(*offsets),
        (ctypes.c_int * L)(*[int(g.dtype == torch.bfloat16) for g in grads]),
        L, stats.data_ptr(), stream)
    if err:
        check_launch(err, "adamw_norm_finish")
    LAUNCHES["adamw_norm_finish"] += 1
    return stats


def adamw_update(grads: List[torch.Tensor], params: List[torch.Tensor],
                 mus: List[torch.Tensor], nus: List[torch.Tensor], *,
                 lr: float, t: int, b1: float, b2: float, eps: float,
                 weight_decay: float,
                 clip: Optional[float],
                 sum_partials: Optional[SumPartials] = None
                 ) -> Optional[torch.Tensor]:
    """Update ``t`` (1-based) of the leaves ``params`` with ``grads``:
    ``params``, ``mus`` and ``nus`` in place (see the module docstring);
    returns the float32 ``stats`` ``[norm, S_0, ...]`` on the
    leaves' device, or None with ``clip=None`` (no clipping stage, no
    norm). The kernels for CUDA tensors, the plain version for CPU
    tensors.

    The sharded update passes each rank's shards of the leaves, and
    ``sum_partials``: it takes the float32 per-leaf sums of squares of
    this rank's shards and returns them summed over the ranks that share
    the update (a leaf every rank holds whole counted once). Each leaf's
    ``S_i`` in the lines above is then that sum, and the norm chains them
    as before: the kernels take the finish again, one slot a leaf."""
    if not (len(grads) == len(params) == len(mus) == len(nus)) or not grads:
        raise ValueError("adamw: grads, params, mu and nu must be equal, "
                         "non-empty lists")
    for g, p, m, v in zip(grads, params, mus, nus):
        if g.dtype != p.dtype or v.dtype != p.dtype:
            raise ValueError(f"adamw: g, p and nu must share a type, got "
                             f"{g.dtype}, {p.dtype}, {v.dtype}")
        if not (g.shape == p.shape == m.shape == v.shape):
            raise ValueError(f"adamw: shapes {tuple(g.shape)}, "
                             f"{tuple(p.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
    devices = {t_.device for leaf in (grads, params, mus, nus) for t_ in leaf}
    if len(devices) != 1:
        raise ValueError(f"adamw: tensors on {sorted(map(str, devices))}")
    chain = _chain_dtype([g.dtype for g in grads])
    scalars = [step_scalars(float(lr), int(t), b1, b2, eps, weight_decay,
                            clip, p.dtype, m.dtype, chain)
               for p, m in zip(params, mus)]
    dev = devices.pop()
    if dev.type == "cuda":
        return _cuda_update(grads, params, mus, nus, scalars,
                            clip is not None, sum_partials)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return adamw_update_plain(grads, params, mus, nus, scalars,
                              clip is not None, sum_partials)


# ---- optax.adam: the update outside the trainer -------------------------------

class Adam:
    """``optax.adam(lr)`` over a list of parameter tensors, updated in
    place, the optimizer the reference uses outside its ``Trainer``
    (draft distillation, the convnet): optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, ``eps_root`` 0) and ``mu_dtype`` None, so both
    moments are zeros in each parameter's type.

    ``step(grads)`` is :func:`adamw_update` with ``weight_decay=0`` and
    ``clip=None``: no norm is taken, so a non-finite gradient entry
    poisons only its own element, as in ``optax.adam``. ``optax.adamw``
    differs from ``optax.adam`` only by ``add_decayed_weights``, which
    here adds ``R_Q(p * 0)``, an exact zero, to a finite update: ``w =
    R_Q(u + 0) = u``, and the lines of the module docstring reduce to the
    jitted ``optax.adam``'s roundings (``tests/test_torch_zoo_draft.py``
    holds 6 steps against a jitted ``optax.adam``: float32 within 1 ulp,
    bf16 with bf16 moments bit for bit, and a non-finite gradient leaf
    element for element)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float) -> None:
        self.leaves = list(leaves)
        self.lr = float(lr)
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        adamw_update([g.contiguous() for g in grads], self.leaves, self.mu,
                     self.nu, lr=self.lr, t=self.count, b1=self.b1,
                     b2=self.b2, eps=self.eps, weight_decay=0.0, clip=None)


__all__ = ["adamw_update", "adamw_update_plain", "global_norm_plain",
           "step_scalars", "StepScalars", "norm_blocks", "LAUNCHES",
           "MAX_LEAVES", "Adam", "SumPartials"]
