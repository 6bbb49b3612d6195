"""Kernel ops: the compute hot paths of the port.

Counterpart of ``synapseml_tpu/ops``: :mod:`attention` holds the
hand-written CUDA flash-attention forward and backward
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd_{bf16,f32}.cu``) beside their plain PyTorch
versions. Ring and Ulysses attention come with the multi-GPU slice.
"""

from .attention import (flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
                        flash_attention_fwd, flash_attention_fwd_plain, reference_attention)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain", "reference_attention"]
