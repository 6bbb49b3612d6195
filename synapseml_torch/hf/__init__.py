"""HuggingFace-style transformers: batch causal-LM generation and sentence
embeddings as DataFrame transformers.

Counterpart of ``synapseml_tpu/hf/``: :class:`HuggingFaceCausalLM` with the
dense and paged decode engines, and :class:`HuggingFaceSentenceEmbedder`
(``hf/embedder.py`` there). Both take a preset or a local HuggingFace
checkpoint directory.
"""

from .causal_lm import HuggingFaceCausalLM
from .embedder import HuggingFaceSentenceEmbedder

__all__ = ["HuggingFaceCausalLM", "HuggingFaceSentenceEmbedder"]
