"""Kernel ops: the compute hot paths of the port.

Counterpart of ``synapseml_tpu/ops``: :mod:`attention` holds the
hand-written CUDA flash-attention forward and backward
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd_{bf16,f32}.cu``) beside their plain PyTorch
versions; :mod:`ring_attention` and :mod:`ulysses_attention` shard the
tokens over the mesh's ``seq`` axis.
"""

from .attention import (flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
                        flash_attention_fwd, flash_attention_fwd_plain, reference_attention)
from .ring_attention import ring_attention, ring_attention_sharded
from .ulysses_attention import ulysses_attention, ulysses_attention_sharded

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain", "reference_attention",
           "ring_attention", "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded"]
