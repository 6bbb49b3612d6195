"""Boosting objectives: gradients/hessians + eval metrics, on torch tensors.

Counterpart of ``synapseml_tpu/gbdt/objectives.py`` (reference: LightGBM's
native objective functions selected via the ``objective`` train param, and
the metrics used for early stopping). Every objective of the JAX package
but ``lambdarank`` (its ranker comes in a later slice). Scores are (N, K)
float32, labels (N,) float32; everything stays float32 on the scores'
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["Objective", "get_objective"]


class Objective(NamedTuple):
    name: str
    num_model_out: int  # trees grown per boosting iteration (K for multiclass)
    init_score: Callable  # labels -> (K,) initial raw score
    grad_hess: Callable  # (scores (N,K), labels (N,)) -> (grad (N,K), hess (N,K))
    transform: Callable  # raw scores (N,K) -> predictions (prob etc.)
    metric: Callable  # (scores (N,K), labels (N,)) -> scalar (lower is better)
    metric_name: str


# ---------------- regression ----------------

def _reg_init(y):
    return torch.mean(y)[None]


def _l2_grad_hess(s, y):
    return s[:, 0] - y, torch.ones_like(y)


def _l1_grad_hess(s, y):
    return torch.sign(s[:, 0] - y), torch.ones_like(y)


def _huber_grad_hess(s, y, delta=1.0):
    r = s[:, 0] - y
    return torch.clamp(r, -delta, delta), torch.ones_like(y)


def _poisson_grad_hess(s, y):
    mu = torch.exp(s[:, 0])
    return mu - y, mu


def _quantile_grad_hess(s, y, alpha=0.5):
    r = s[:, 0] - y
    return (torch.where(r >= 0, 1.0 - alpha, -alpha).to(torch.float32),
            torch.ones_like(y))


def _gamma_grad_hess(s, y):
    # gamma deviance with log link (LightGBM RegressionGammaLoss):
    # grad = 1 - y e^{-s}, hess = y e^{-s}
    e = y * torch.exp(-s[:, 0])
    return 1.0 - e, e


def _mape_grad_hess(s, y):
    # mean absolute percentage error: |r|/max(|y|,1) with L1-style grad;
    # the per-row 1/|y| factor rides the hessian-side weight like LightGBM
    w = 1.0 / torch.clamp(torch.abs(y), min=1.0)
    r = s[:, 0] - y
    return torch.sign(r) * w, w


def _tweedie_grad_hess(s, y, rho=1.5):
    # LightGBM tweedie (1 <= rho < 2, log link): deviance
    # -y e^{(1-rho)s}/(1-rho) + e^{(2-rho)s}/(2-rho); d/ds and d2/ds2
    a = torch.exp((1.0 - rho) * s[:, 0])
    b = torch.exp((2.0 - rho) * s[:, 0])
    grad = -y * a + b
    hess = -y * (1.0 - rho) * a + (2.0 - rho) * b
    return grad, hess


def _rmse(s, y):
    return torch.sqrt(torch.mean((s[:, 0] - y) ** 2))


def _rmse_exp_link(s, y):
    # log-link objectives carry raw scores on the log scale; the validation
    # metric compares on the mean scale
    return torch.sqrt(torch.mean((torch.exp(s[:, 0]) - y) ** 2))


def _log_mean_init(y):
    return torch.log(torch.clamp(torch.mean(y), min=1e-6))[None]


def _mae(s, y):
    return torch.mean(torch.abs(s[:, 0] - y))


def _quantile_init(y, q):
    # torch.quantile interpolates linearly, as jnp.quantile and jnp.median
    # do; torch.median would return the lower middle value
    return torch.quantile(y, q)[None]


def _mape_init(y):
    # MAPE's optimum is the 1/max(|y|,1)-weighted median (LightGBM inits
    # from the weighted percentile too)
    w = 1.0 / torch.clamp(torch.abs(y), min=1.0)
    order = torch.argsort(y, stable=True)
    cw = torch.cumsum(w[order], dim=0)
    idx = torch.searchsorted(cw, (cw[-1] / 2.0)[None])
    return y[order][torch.clamp(idx, max=y.shape[0] - 1)]


# ---------------- binary ----------------

def _binary_init(y):
    p = torch.clamp(torch.mean(y), 1e-6, 1 - 1e-6)
    return torch.log(p / (1 - p))[None]


def _binary_grad_hess(s, y):
    p = torch.sigmoid(s[:, 0])
    return p - y, p * (1 - p)


def _binary_logloss(s, y):
    p = torch.clamp(torch.sigmoid(s[:, 0]), 1e-12, 1 - 1e-12)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))


# ---------------- multiclass ----------------

def _multi_init(y, k):
    # +1 smoothing: an absent class gets a finite log prior
    counts = torch.bincount(y.to(torch.int64), minlength=k)[:k].to(torch.float32) + 1.0
    return torch.log(counts / counts.sum())


def _multi_grad_hess(s, y, k):
    p = torch.softmax(s, dim=1)
    onehot = torch.nn.functional.one_hot(y.to(torch.int64), k).to(torch.float32)
    return p - onehot, p * (1 - p)


def _multi_logloss(s, y, k):
    p = torch.clamp(torch.softmax(s, dim=1), 1e-12, 1.0)
    return -torch.mean(torch.log(torch.gather(p, 1, y.to(torch.int64)[:, None])[:, 0]))


# ---------------- registry ----------------

def _first(s):
    return s[:, 0]


def _exp_first(s):
    return torch.exp(s[:, 0])


def get_objective(name: str, num_class: int = 1, **kw) -> Objective:
    name = name.lower()
    if name in ("regression", "regression_l2", "l2", "mse", "rmse"):
        return Objective("regression", 1, _reg_init, _l2_grad_hess, _first, _rmse, "rmse")
    if name in ("regression_l1", "l1", "mae"):
        return Objective("regression_l1", 1, lambda y: _quantile_init(y, 0.5),
                         _l1_grad_hess, _first, _mae, "mae")
    if name == "huber":
        delta = float(kw.get("alpha", 1.0))
        return Objective("huber", 1, _reg_init,
                         lambda s, y: _huber_grad_hess(s, y, delta), _first, _rmse, "rmse")
    if name == "poisson":
        return Objective("poisson", 1, _log_mean_init, _poisson_grad_hess,
                         _exp_first, _rmse_exp_link, "rmse")
    if name == "quantile":
        alpha = float(kw.get("alpha", 0.5))
        return Objective("quantile", 1, lambda y: _quantile_init(y, alpha),
                         lambda s, y: _quantile_grad_hess(s, y, alpha), _first, _mae, "mae")
    if name == "gamma":
        return Objective("gamma", 1, _log_mean_init, _gamma_grad_hess,
                         _exp_first, _rmse_exp_link, "rmse")
    if name == "mape":
        return Objective("mape", 1, _mape_init, _mape_grad_hess, _first,
                         lambda s, y: torch.mean(torch.abs(s[:, 0] - y)
                                                 / torch.clamp(torch.abs(y), min=1.0)),
                         "mape")
    if name == "tweedie":
        rho = float(kw.get("tweedie_variance_power", 1.5))
        if not 1.0 <= rho < 2.0:  # LightGBM's bound; rho=1 = poisson limit
            raise ValueError(f"tweedie_variance_power must be in [1, 2), got {rho}")
        return Objective("tweedie", 1, _log_mean_init,
                         lambda s, y: _tweedie_grad_hess(s, y, rho),
                         _exp_first, _rmse_exp_link, "rmse")
    if name == "binary":
        return Objective("binary", 1, _binary_init, _binary_grad_hess,
                         lambda s: torch.sigmoid(s[:, 0]), _binary_logloss, "binary_logloss")
    if name in ("multiclass", "softmax"):
        k = int(num_class)
        if k < 2:
            raise ValueError("multiclass requires num_class >= 2")
        return Objective("multiclass", k, lambda y: _multi_init(y, k),
                         lambda s, y: _multi_grad_hess(s, y, k),
                         lambda s: torch.softmax(s, dim=1),
                         lambda s, y: _multi_logloss(s, y, k), "multi_logloss")
    if name == "lambdarank":
        raise NotImplementedError("objective 'lambdarank' (LightGBMRanker) is not "
                                  "ported yet: its padded-group lambdas come in a "
                                  "later slice")
    raise ValueError(f"unknown objective {name!r}")
