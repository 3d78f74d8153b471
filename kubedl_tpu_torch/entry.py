"""The port's counterpart of the repository's ``entry()`` hook: a forward
step of the flagship Llama decoder at a small size."""

from __future__ import annotations

import torch

from kubedl_tpu_torch import resolve_device


def entry(device=None):
    """Returns (fn, example_args): the Llama forward (dense attention) with
    the reference hook's config (vocab 2048, dim 256, 4 layers, 8/4 heads,
    bf16, no remat) on tokens [2, 256], params seeded from 0. Runs on
    CUDA unless ``device="cpu"``."""
    from kubedl_tpu_torch.models import llama

    dev = resolve_device(device)
    cfg = llama.LlamaConfig(
        vocab_size=2048, dim=256, n_layers=4, n_heads=8, n_kv_heads=4,
        ffn_dim=768, max_seq=512, dtype=torch.bfloat16, remat=False,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.llama_init(cfg, gen, dev)
    tokens = torch.zeros((2, 256), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return llama.llama_forward(params, tokens, cfg)

    fn.cfg = cfg
    return fn, (params, tokens)


__all__ = ["entry"]
