from .batching import pad_sequences

__all__ = ["pad_sequences"]
