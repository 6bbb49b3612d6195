"""The small MLP of the gang, supervisor and continual tests, in both
packages, with the JAX initial parameters bridged into the port.

``TorchMLP`` (``fc1``: 4 -> 16, ReLU, ``fc2``: 16 -> classes) and
``flax_mlp()`` compute the same function; ``flax_init(seed)`` draws the
Flax initial parameters and adds seeded noise (as the trainer tests do),
``bridge(params)`` turns them into the torch module's ``state_dict`` with
``convert_jax``'s dense helper. ``numpy_forward`` is the numpy mirror the
continual tests' ``eval_fn`` and ``MLPScorer`` (a servable stage) score
with. Worker subprocesses import this module, so it imports flax and jax
lazily.
"""

import numpy as np
import torch

from synapseml_torch.core.params import ComplexParam
from synapseml_torch.core.pipeline import Transformer

D_IN, HIDDEN = 4, 16


class TorchMLP(torch.nn.Module):
    def __init__(self, n_classes: int = 2):
        super().__init__()
        self.fc1 = torch.nn.Linear(D_IN, HIDDEN)
        self.fc2 = torch.nn.Linear(HIDDEN, n_classes)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def flax_mlp(n_classes: int = 2):
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(n_classes, name="fc2")(nn.relu(nn.Dense(HIDDEN, name="fc1")(x)))

    return MLP()


def flax_init(seed: int = 0, n_classes: int = 2, noise: float = 0.05) -> dict:
    import jax

    params = flax_mlp(n_classes).init(jax.random.PRNGKey(seed),
                                      np.zeros((1, D_IN), np.float32))["params"]
    rs = np.random.default_rng(seed + 1000)
    return {layer: {k: (np.asarray(v) + noise * rs.normal(size=np.shape(v))).astype(np.float32)
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


def bridge(params: dict) -> dict:
    from synapseml_torch.models.convert_jax import _dense

    out: dict = {}
    for layer in ("fc1", "fc2"):
        _dense(out, layer, params[layer])
    return out


def unbridge(state_dict: dict) -> dict:
    """The torch module's tensors in the Flax layout (numpy)."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items()}
    return {layer: {"kernel": sd[f"{layer}.weight"].T, "bias": sd[f"{layer}.bias"]}
            for layer in ("fc1", "fc2")}


def numpy_forward(params: dict, X: np.ndarray) -> np.ndarray:
    h = np.maximum(X @ np.asarray(params["fc1"]["kernel"]) + np.asarray(params["fc1"]["bias"]), 0)
    return h @ np.asarray(params["fc2"]["kernel"]) + np.asarray(params["fc2"]["bias"])


def gang_rows(n: int = 4096, seed: int = 7) -> dict:
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, D_IN)).astype(np.float32)
    return {"x": X, "labels": (X[:, 0] > 0).astype(np.int32)}


class MLPScorer(Transformer):
    """A servable classifier over MLP params in the Flax layout: replies
    ``{"pred": argmax}`` to each body ``{"x": [...]}`` (the port's twin of
    ``tests/test_continual.py``'s ``MLPScorer``)."""

    params = ComplexParam("params", "weights in the Flax layout", default=None)

    def _transform(self, df):
        W = self.get("params")

        def per_part(p):
            out = dict(p)
            reply = np.empty(len(p["body"]), dtype=object)
            reply[:] = [{"pred": int(np.argmax(numpy_forward(
                W, np.asarray(b["x"], dtype=np.float32)[None, :])))} for b in p["body"]]
            out["reply"] = reply
            return out

        return df.map_partitions(per_part)
