"""The planner's model descriptor and small model zoo.

A copy of ``ModelDesc`` and ``MODEL_ZOO`` from
``kubedl_tpu/planner/costmodel.py``: the port's trained drafts
(``serving/speculative.py::ModelDraft.from_zoo``) take their depth and
widths from a zoo entry. The cost model, the collective primitives and
the pricing are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class ModelDesc:
    """What the planner needs to know about a training workload: either
    ``params`` directly or the transformer dims (``layers``/``hidden``/...)
    to derive the count from. ``global_batch`` is sequences per optimizer
    step."""

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


#: the reference's small model zoo, entry for entry
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

__all__ = ["ModelDesc", "MODEL_ZOO"]
