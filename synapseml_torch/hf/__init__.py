"""HuggingFace-style LLM transformers: batch causal-LM generation as a
DataFrame transformer.

Counterpart of ``synapseml_tpu/hf/``: :class:`HuggingFaceCausalLM` with the
dense and paged decode engines. ``HuggingFaceSentenceEmbedder``
(``hf/embedder.py`` there) is not ported yet (ROADMAP.md queue A item 8).
"""

from .causal_lm import HuggingFaceCausalLM

__all__ = ["HuggingFaceCausalLM"]
