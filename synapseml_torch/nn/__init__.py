"""Nearest neighbors (reference ``core/.../nn/``).

Counterpart of ``synapseml_tpu/nn/``: where the reference walks a BallTree,
one [Q, N] distance matmul and a top-k on the card does the work, the index
being the feature matrix on the device (:mod:`.knn`).
"""

from .knn import KNN, KNNModel, ConditionalKNN, ConditionalKNNModel

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel"]
