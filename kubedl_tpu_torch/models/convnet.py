"""Small convnet family: the MNIST-class convergence workload.

Port of ``kubedl_tpu/models/convnet.py``. The parameter tree is the
reference's: HWIO convolution kernels, a ``[flat, hidden]`` dense layer
over the NHWC flattening, so a tree carried over with
``llama.params_from_numpy`` needs no transposes; images are ``[B, H, W,
C]`` at the call, as there. Inside, the convolutions run NCHW / OIHW
(``F.conv2d`` with "same" padding, the counterpart of the reference's
``lax.conv_general_dilated``, which no Pallas kernel replaces) and the
activations go back to NHWC before the flatten. ``fit`` trains with
``optax.adam``'s update (:class:`~kubedl_tpu_torch.ops.adamw.Adam`: the
optimizer kernels on the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from kubedl_tpu_torch import resolve_device

Params = Dict[str, Any]


@dataclass(frozen=True)
class ConvNetConfig:
    image_size: int = 28
    channels: int = 1
    classes: int = 10
    width: int = 32  # first conv's filters; second doubles it
    hidden: int = 128
    dtype: Any = torch.float32


def convnet_init(generator: torch.Generator, cfg: ConvNetConfig,
                 device="cpu") -> Params:
    """He-normal kernels and zero biases, the reference's shapes and
    scales, drawn from ``generator`` (on ``device``)."""

    def he(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * math.sqrt(2.0 / fan_in)).to(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    w1, w2 = cfg.width, cfg.width * 2
    flat = (cfg.image_size // 4) ** 2 * w2  # two 2x2 pools
    return {
        "conv1": he((3, 3, cfg.channels, w1), 9 * cfg.channels),
        "b1": zeros(w1),
        "conv2": he((3, 3, w1, w2), 9 * w1),
        "b2": zeros(w2),
        "dense": he((flat, cfg.hidden), flat),
        "b3": zeros(cfg.hidden),
        "head": he((cfg.hidden, cfg.classes), cfg.hidden),
        "b4": zeros(cfg.classes),
    }


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """NCHW activations, an HWIO kernel: same-padded 3x3 convolution,
    bias, ReLU, then a 2x2 max pool of stride 2 (the reference's VALID
    ``reduce_window``: a trailing odd row or column is dropped)."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding="same")
    y = F.relu(y + b[None, :, None, None])
    return F.max_pool2d(y, 2, 2)


def convnet_forward(params: Params, images: torch.Tensor,
                    cfg: ConvNetConfig) -> torch.Tensor:
    """images [B, H, W, C] -> logits [B, classes] (float32)."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    x = _conv_relu_pool(x, params["conv1"], params["b1"])
    x = _conv_relu_pool(x, params["conv2"], params["b2"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
    x = F.relu(x @ params["dense"] + params["b3"])
    return (x @ params["head"] + params["b4"]).float()


def convnet_loss(params: Params, batch: Tuple[torch.Tensor, torch.Tensor],
                 cfg: ConvNetConfig) -> torch.Tensor:
    images, labels = batch
    logp = torch.log_softmax(convnet_forward(params, images, cfg), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


@torch.no_grad()
def accuracy(params: Params, images, labels, cfg: ConvNetConfig) -> float:
    dev = params["head"].device
    logits = convnet_forward(params, torch.as_tensor(images).to(dev), cfg)
    labels = torch.as_tensor(labels).to(dev)
    return float((logits.argmax(-1) == labels.long()).float().mean())


class SyntheticDigits:
    """MNIST-shaped synthetic data with learnable structure, the
    reference's task: class k is a fixed uniform template (from
    ``template_seed``) plus ``noise`` x N(0, 1), so a correct training
    loop reaches high accuracy and a broken one stays at chance. Drawn
    with ``torch.Generator`` on ``device`` (the card unless the caller
    asks for the CPU): the same task, not the reference's random
    stream."""

    def __init__(self, cfg: ConvNetConfig, batch: int, seed: int = 0,
                 noise: float = 0.3, template_seed: int = 1234,
                 device=None) -> None:
        self.cfg = cfg
        self.batch = batch
        self.noise = noise
        self.device = resolve_device(device)
        # the templates are the TASK (fixed across train / eval splits);
        # ``seed`` drives only the sampling and noise stream
        tg = torch.Generator(device=self.device).manual_seed(template_seed)
        self.templates = torch.rand(
            (cfg.classes, cfg.image_size, cfg.image_size, cfg.channels),
            generator=tg, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        labels = torch.randint(0, self.cfg.classes, (self.batch,),
                               generator=self._gen, device=self.device)
        images = self.templates[labels]
        images = images + self.noise * torch.randn(
            images.shape, generator=self._gen, device=self.device)
        return images, labels.to(torch.int32)


def fit(cfg: ConvNetConfig, data: Iterator, steps: int = 100,
        learning_rate: float = 1e-3, seed: int = 0,
        params: Optional[Params] = None,
        device=None) -> Tuple[Params, Dict[str, float]]:
    """The reference's minimal Adam loop: ``steps`` of
    :func:`convnet_loss` and ``optax.adam(learning_rate)`` over the tree
    (dict keys sorted, the reference's leaf order): in place on its own
    tree, on a copy of ``params`` when the caller passes them. Batches are
    moved to the parameters' device. Returns the parameters and the first
    and final losses."""
    from kubedl_tpu_torch.ops.adamw import Adam

    if params is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = convnet_init(gen, cfg, dev)
    else:  # the caller's tree stays as it was, as in the reference
        params = {k: v.detach().clone() for k, v in params.items()}
    dev = params["head"].device
    leaves = [params[k] for k in sorted(params)]
    opt = Adam(leaves, learning_rate)
    losses = []
    try:
        for p in leaves:
            p.requires_grad_(True)
        for _ in range(steps):
            images, labels = next(data)
            loss = convnet_loss(params, (torch.as_tensor(images).to(dev),
                                         torch.as_tensor(labels).to(dev)),
                                cfg)
            opt.step(torch.autograd.grad(loss, leaves))
            losses.append(loss.detach())
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return params, {"first_loss": float(losses[0]),
                    "final_loss": float(losses[-1]), "steps": steps}


__all__ = ["ConvNetConfig", "convnet_init", "convnet_forward", "convnet_loss",
           "accuracy", "SyntheticDigits", "fit"]
