"""The model-path convention of a multi-model fleet.

Counterpart of ``synapseml_tpu/fleet/residency.py``: ``model_path`` and
``model_from_path``, the ``/m/<model>`` request path that the routing front
keys model affinity, admission and per-model metrics on. The rest of that
module, ``ResidencyManager`` (N registry models behind per-model
``PipelineHolder`` slots with a byte-budgeted LRU), ``serve_multi_model``
and ``artifact_nbytes``, waits for the fleet slice (ROADMAP.md queue A item
10).
"""

from __future__ import annotations

__all__ = ["model_path", "model_from_path"]


def model_path(model: str) -> str:
    """The canonical request path for a model on a multi-model fleet."""
    return f"/m/{model}"


def model_from_path(path: str) -> str | None:
    """Extract the model segment from ``/m/<model>[/...][?query]``; None
    when the path does not address a model (health/admin/default
    traffic). Query/fragment suffixes are stripped — ``/m/x?k=v`` must
    route (and key admission/metrics) as ``x``, never as ``x?k=v``."""
    bare = str(path).split("?", 1)[0].split("#", 1)[0]
    parts = bare.split("/")
    if len(parts) >= 3 and parts[1] == "m" and parts[2]:
        return parts[2]
    return None
