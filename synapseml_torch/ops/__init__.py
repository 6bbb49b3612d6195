"""Kernel ops: the compute hot paths of the port.

Counterpart of ``synapseml_tpu/ops``: :mod:`attention` holds the
hand-written CUDA flash-attention forward (``csrc/flash_fwd.cu``) beside
its plain PyTorch version. Ring and Ulysses attention come with the
multi-GPU slice.
"""

from .attention import (flash_attention, flash_attention_fwd,
                        flash_attention_fwd_plain, reference_attention)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_fwd_plain",
           "reference_attention"]
