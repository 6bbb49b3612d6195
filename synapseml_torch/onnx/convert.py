"""ONNX graph -> a callable over torch tensors on one device.

Counterpart of ``synapseml_tpu/onnx/convert.py``. The JAX package lowers
each node to ``jnp``/``lax`` and lets XLA compile the graph; here each node
runs eagerly as the torch op that computes the same function: convolutions
through ``torch.nn.functional.conv*d`` (cuDNN on the card), products
through ``torch.matmul``/``einsum`` (cuBLAS). No hand-written kernel is on
this path, as no Pallas kernel is on the reference's.

The weights are the ONNX bytes themselves: this converter and the
reference's read the same initializers from the same bytes, so no weight
bridge is needed (as ``models/convert_jax.py`` is for the text stack).
:class:`ConvertedModel` decodes them once, as the reference does, and moves
the float ones to a device once for each device it runs on. The graph
computes in its own dtypes (f32 for the torchvision and BERT exports); the
process's TF32 flags are left as they are, as in the rest of the port. Host-side int64 shape arithmetic
(``Shape``, ``Reshape`` targets, ``Slice`` ends, ``Unsqueeze`` axes, int64
initializers and Constants) stays numpy, as in the reference, so a call
reads nothing back from the device to find a shape.

Values in a graph's environment are either host numpy arrays (shape math,
Constants, int64 initializers) or torch tensors. An op registered with
``raw=True`` takes its inputs as they come and keeps all-host inputs on the
host; ``raw=(i, ...)`` leaves those input positions as they come (shape and
axis arguments); every other input is moved to the call's device first.

Ported: the convnet group (what a torchvision-style ResNet export emits),
the encoder group (a BERT export) and the stock opset the reference defines
at ``convert.py:67-272``, ``:316-407`` and ``:635-930``. What waits
(``If``/``Loop``/``Scan``, ``ConvTranspose``, ``InstanceNormalization``,
``Resize``, ``LSTM``/``GRU``, ``Trilu``, ``GatherElements``, the
``com.microsoft`` contrib ops and the quantized, random, detection and
signal ops) is refused when a graph is converted, with the op names and
their ROADMAP item.
"""

from __future__ import annotations

import contextvars
import operator
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from . import proto as P
from .proto import ModelProto, parse_model, tensor_to_numpy

__all__ = ["convert_graph", "ConvertedModel", "OP_REGISTRY"]

OP_REGISTRY: dict[str, Callable] = {}
_RAW: dict[str, object] = {}  # op -> True (every input as it comes) or positions
_DEVICE: contextvars.ContextVar = contextvars.ContextVar("onnx_device")
_WAITING = "ROADMAP.md queue A item 6"


def op(name, raw=()):
    def deco(fn):
        OP_REGISTRY[name] = fn
        _RAW[name] = raw
        return fn
    return deco


def _device() -> torch.device:
    """The device of the running call (for ops that make a tensor from host
    arguments alone)."""
    return _DEVICE.get()


def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def _host(v) -> np.ndarray:
    """A shape/axis argument as numpy. One computed on the device is read
    back (a device-to-host sync); the exporters' shape chains stay host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _to(x, device):
    """``x`` as a tensor on ``device`` (host arrays copied there)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    x = np.asarray(x)
    # a read-only buffer (decoded initializers) is copied, not shared
    return torch.as_tensor(x, device=device) if x.flags.writeable else torch.tensor(x, device=device)


def _mix(xs, scalars: bool):
    """Tensors on one device for an op over host and device inputs: the
    first non-CPU tensor's device. With ``scalars``, a 0-d host value
    stays a CPU scalar tensor, which elementwise ops take beside a CUDA
    tensor without a copy."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor) and x.device.type != "cpu"),
               torch.device("cpu"))
    out = []
    for x in xs:
        if scalars and _is_host(x) and np.ndim(x) == 0:
            out.append(torch.from_numpy(np.array(x)))
        else:
            out.append(_to(x, dev))
    return out


def _binary(np_fn, torch_fn):
    """An elementwise op: all-host inputs stay numpy (shape math), else
    torch with host scalars taken as CPU scalars."""
    def handler(ins, attrs):
        a, b = ins[0], ins[1]
        if _is_host(a) and _is_host(b):
            return np_fn(a, b)
        return torch_fn(*_mix([a, b], scalars=True))
    return handler


def _unary(fn):
    return lambda ins, attrs: fn(ins[0])


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


_TORCH_DTYPES = {P.FLOAT: torch.float32, P.INT64: torch.int64, P.INT32: torch.int32,
                 P.DOUBLE: torch.float64, P.BOOL: torch.bool, P.FLOAT16: torch.float16,
                 P.BFLOAT16: torch.bfloat16, P.UINT8: torch.uint8, P.INT8: torch.int8,
                 P.INT16: torch.int16}


def _conv_pads(attrs, spatial_rank):
    """ONNX pads = [x1_begin, x2_begin, ..., x1_end, x2_end, ...]."""
    pads = attrs.get("pads")
    auto = attrs.get("auto_pad", "NOTSET")
    if auto and auto not in ("NOTSET",):
        return auto  # SAME_UPPER / SAME_LOWER / VALID
    if pads is None:
        return [(0, 0)] * spatial_rank
    half = len(pads) // 2
    return list(zip(pads[:half], pads[half:]))


def _same_explicit_pads(in_sizes, kernel, strides, lower: bool):
    out = []
    for i, k, s in zip(in_sizes, kernel, strides):
        o = -(-i // s)
        total = max((o - 1) * s + k - i, 0)
        a, b = total // 2, total - total // 2
        out.append((b, a) if lower else (a, b))
    return out


def _explicit_pads(attrs, in_sizes, kernel, strides) -> list[tuple[int, int]]:
    """(begin, end) pads of each spatial dim, ``auto_pad`` resolved against
    the (dilated) ``kernel``, as XLA's SAME / SAME_LOWER / VALID are."""
    pads = _conv_pads(attrs, len(kernel))
    if pads == "VALID":
        return [(0, 0)] * len(kernel)
    if isinstance(pads, str):
        return _same_explicit_pads(in_sizes, kernel, strides, lower=pads == "SAME_LOWER")
    return [(int(b), int(e)) for b, e in pads]


def _flat_pads(pads) -> list[int]:
    """``F.pad``'s order: the last dim's (begin, end) first."""
    return [v for b, e in reversed(pads) for v in (b, e)]


# ---------------- math / activation ----------------

def _np_div(a, b):
    if np.issubdtype(np.asarray(a).dtype, np.integer) and np.issubdtype(np.asarray(b).dtype,
                                                                         np.integer):
        # ONNX integer Div truncates toward zero (C semantics): torch's
        # chunk/split exports rely on it for Slice bounds
        q = a // b
        r = a - q * b
        return q + ((r != 0) & ((a < 0) != (b < 0)))
    return a / b


def _torch_div(a, b):
    if not (a.is_floating_point() or b.is_floating_point()):
        return torch.div(a, b, rounding_mode="trunc")
    return a / b


for _name, _np_fn, _torch_fn in (("Add", operator.add, operator.add),
                                  ("Sub", operator.sub, operator.sub),
                                  ("Mul", operator.mul, operator.mul),
                                  ("Div", _np_div, _torch_div),
                                  ("Pow", np.power, torch.pow),
                                  ("Equal", np.equal, torch.eq),
                                  ("Greater", np.greater, torch.gt),
                                  ("Less", np.less, torch.lt)):
    op(_name, raw=True)(_binary(_np_fn, _torch_fn))

for _name, _fn in {"Abs": torch.abs, "Sqrt": torch.sqrt, "Exp": torch.exp, "Log": torch.log,
                   "Erf": torch.erf, "Relu": torch.relu, "Sigmoid": torch.sigmoid,
                   "Tanh": torch.tanh, "Sin": torch.sin, "Cos": torch.cos,
                   "HardSwish": F.hardswish, "Not": torch.logical_not}.items():
    op(_name)(_unary(_fn))


@op("Neg", raw=True)
def _neg(ins, attrs):
    return -ins[0]


@op("LeakyRelu")
def _leaky(ins, attrs):
    return F.leaky_relu(ins[0], attrs.get("alpha", 0.01))


@op("Gelu")
def _gelu(ins, attrs):
    return F.gelu(ins[0], approximate="tanh" if attrs.get("approximate", "none") == "tanh"
                  else "none")


@op("Softmax")
def _softmax(ins, attrs):
    return torch.softmax(ins[0], dim=attrs.get("axis", -1))


@op("LogSoftmax")
def _log_softmax(ins, attrs):
    return torch.log_softmax(ins[0], dim=attrs.get("axis", -1))


def _bound(v, x):
    if v is None or isinstance(v, torch.Tensor):
        return _to(v, x.device)
    return np.asarray(v).reshape(-1)[0].item()


@op("Clip", raw=(1, 2))
def _clip(ins, attrs):
    x = ins[0]
    lo = ins[1] if len(ins) > 1 and ins[1] is not None else attrs.get("min")
    hi = ins[2] if len(ins) > 2 and ins[2] is not None else attrs.get("max")
    if lo is not None:
        x = torch.clamp_min(x, _bound(lo, x))
    if hi is not None:
        x = torch.clamp_max(x, _bound(hi, x))
    return x


@op("HardSigmoid")
def _hardsigmoid(ins, attrs):
    return torch.clamp(attrs.get("alpha", 0.2) * ins[0] + attrs.get("beta", 0.5), 0.0, 1.0)


@op("Where", raw=True)
def _where(ins, attrs):
    if all(_is_host(x) for x in ins[:3]):
        # shape-math select (torch's expand exports Where(shape==-1, ...))
        return np.where(ins[0], ins[1], ins[2])
    cond, a, b = _mix(ins[:3], scalars=False)
    return torch.where(cond.bool(), a, b)


# ---------------- linear algebra ----------------

@op("MatMul")
def _matmul(ins, attrs):
    return torch.matmul(ins[0], ins[1])


@op("Einsum")
def _einsum(ins, attrs):
    eq = attrs["equation"]
    return torch.einsum(eq.decode("utf-8") if isinstance(eq, bytes) else eq, *ins)


@op("Gemm")
def _gemm(ins, attrs):
    a, b = ins[0], ins[1]
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = a @ b
    if attrs.get("alpha", 1.0) != 1.0:
        y = attrs["alpha"] * y
    if len(ins) > 2 and ins[2] is not None:
        beta = attrs.get("beta", 1.0)
        y = y + (ins[2] if beta == 1.0 else beta * ins[2])
    return y


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@op("Conv")
def _conv(ins, attrs):
    x, w = ins[0], ins[1]
    rank = x.ndim - 2
    strides = list(attrs.get("strides") or [1] * rank)
    dilations = list(attrs.get("dilations") or [1] * rank)
    kernel = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
    pads = _explicit_pads(attrs, x.shape[2:], kernel, strides)
    if all(b == e for b, e in pads):
        padding = [b for b, _ in pads]
    else:
        x, padding = F.pad(x, _flat_pads(pads)), [0] * rank
    bias = ins[2] if len(ins) > 2 else None
    return _CONV[rank](x, w, bias, strides, padding, dilations, attrs.get("group", 1))


@op("BatchNormalization")
def _batchnorm(ins, attrs):
    x, scale, bias, mean, var = ins[:5]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var.reshape(shape) + attrs.get("epsilon", 1e-5))
    return (x - mean.reshape(shape)) * inv * scale.reshape(shape) + bias.reshape(shape)


@op("LayerNormalization")
def _layernorm(ins, attrs):
    x = ins[0]
    axis = attrs.get("axis", -1) % x.ndim
    # ONNX normalizes over [axis, rank); the reference reduces `axis` alone,
    # which is the same for the exporters' axis = -1
    var, mean = torch.var_mean(x, dim=tuple(range(axis, x.ndim)), keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + attrs.get("epsilon", 1e-5))
    if len(ins) > 1 and ins[1] is not None:
        y = y * ins[1]
    if len(ins) > 2 and ins[2] is not None:
        y = y + ins[2]
    return y


# ---------------- pooling ----------------

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_geometry(x, attrs, dilations):
    """(kernel, strides, pads, ceil extension): explicit (begin, end) pads
    of each spatial dim, and with ``ceil_mode`` the extra end padding that
    the last window needs (a window must start inside the input or its
    begin padding, as in torch and ONNX opset 19)."""
    kernel = [(k - 1) * d + 1 for k, d in zip(attrs["kernel_shape"], dilations)]
    strides = list(attrs.get("strides") or [1] * len(kernel))
    pads = _explicit_pads(attrs, x.shape[2:], kernel, strides)
    extra = [0] * len(kernel)
    if attrs.get("ceil_mode", 0):
        for i, (size, k, s, (b, e)) in enumerate(zip(x.shape[2:], kernel, strides, pads)):
            out = -(-(size + b + e - k) // s) + 1
            if (out - 1) * s >= size + b:
                out -= 1
            extra[i] = max((out - 1) * s + k - (size + b + e), 0)
    return list(attrs["kernel_shape"]), strides, pads, extra


def _lowest(dtype):
    return -torch.inf if dtype.is_floating_point else torch.iinfo(dtype).min


@op("MaxPool")
def _maxpool(ins, attrs):
    x = ins[0]
    rank = x.ndim - 2
    dilations = list(attrs.get("dilations") or [1] * rank)
    kernel, strides, pads, extra = _pool_geometry(x, attrs, dilations)
    eff = [(k - 1) * d + 1 for k, d in zip(kernel, dilations)]
    if any(extra) or any(b != e or 2 * b > k for (b, e), k in zip(pads, eff)):
        # padded with the lowest value, so a pad never wins a window
        ends = [(b, e + x_) for (b, e), x_ in zip(pads, extra)]
        x, padding = F.pad(x, _flat_pads(ends), value=_lowest(x.dtype)), [0] * rank
    else:
        padding = [b for b, _ in pads]
    return _MAXPOOL[rank](x, kernel, strides, padding, dilations)


@op("AveragePool")
def _avgpool(ins, attrs):
    x = ins[0]
    rank = x.ndim - 2
    if any(d != 1 for d in attrs.get("dilations") or []):
        raise NotImplementedError(f"AveragePool with dilations: {_WAITING}")
    kernel, strides, pads, extra = _pool_geometry(x, attrs, [1] * rank)
    pool = _AVGPOOL[rank]
    ends = [(b, e + x_) for (b, e), x_ in zip(pads, extra)]
    num = pool(F.pad(x, _flat_pads(ends)) if any(map(any, ends)) else x, kernel, strides)
    include = bool(attrs.get("count_include_pad", 0))
    if include and not any(extra):
        return num
    # the divisor of each window: its input cells, and with
    # count_include_pad its explicit pads, never the ceil_mode extension
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    mask = F.pad(ones, _flat_pads(pads), value=float(include))
    mask = F.pad(mask, _flat_pads([(0, e) for e in extra]))
    return num / pool(mask, kernel, strides)


@op("GlobalAveragePool")
def _gap(ins, attrs):
    x = ins[0]
    return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)


@op("GlobalMaxPool")
def _gmp(ins, attrs):
    x = ins[0]
    return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)


# ---------------- shape / structure ----------------

@op("Reshape", raw=True)
def _reshape(ins, attrs):
    x = ins[0]
    shape = [int(s) for s in _host(ins[1])]
    if not attrs.get("allowzero", 0):
        # 0 = copy the input dim; -1 = infer
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return np.reshape(x, shape) if _is_host(x) else x.reshape(shape)


@op("Flatten")
def _flatten(ins, attrs):
    x = ins[0]
    ax = attrs.get("axis", 1)
    if ax < 0:
        ax += x.ndim
    lead = int(np.prod(x.shape[:ax])) if ax > 0 else 1
    return x.reshape(lead, -1)


@op("Transpose")
def _transpose(ins, attrs):
    x = ins[0]
    perm = attrs.get("perm")
    return x.permute(*(perm if perm is not None else reversed(range(x.ndim))))


@op("Concat", raw=True)
def _concat(ins, attrs):
    xs = [x for x in ins if x is not None]
    if all(_is_host(x) for x in xs):
        return np.concatenate(xs, axis=attrs["axis"])
    return torch.cat(_mix(xs, scalars=False), dim=attrs["axis"])


@op("Split", raw=(1,))
def _split(ins, attrs):
    x = ins[0]
    axis = attrs.get("axis", 0)
    if len(ins) > 1 and ins[1] is not None:
        sizes = [int(s) for s in _host(ins[1])]
    elif attrs.get("split"):
        sizes = list(attrs["split"])
    else:
        # opset 18's num_outputs: chunks of ceil(dim / n), the last smaller
        n = attrs.get("num_outputs") or 2
        size = -(-x.shape[axis] // n)
        sizes = [size] * (n - 1) + [x.shape[axis] - size * (n - 1)]
    return tuple(torch.split(x, sizes, dim=axis))


def _axes_arg(ins, attrs):
    if len(ins) > 1 and ins[1] is not None:
        return tuple(int(a) for a in _host(ins[1]))
    axes = attrs.get("axes")
    return tuple(axes) if axes is not None else None


@op("Squeeze", raw=True)
def _squeeze(ins, attrs):
    x, axes = ins[0], _axes_arg(ins, attrs)
    if _is_host(x):
        return np.squeeze(x, axis=axes or None)
    return x.squeeze(tuple(a % x.ndim for a in axes)) if axes else x.squeeze()


@op("Unsqueeze", raw=True)
def _unsqueeze(ins, attrs):
    x, axes = ins[0], _axes_arg(ins, attrs)
    rank = np.ndim(x) + len(axes)  # negative axes count from the output's end
    for a in sorted(a % rank for a in axes):
        x = np.expand_dims(x, a) if _is_host(x) else x.unsqueeze(a)
    return x


@op("Slice", raw=True)
def _slice(ins, attrs):
    x = ins[0]
    if len(ins) > 1:  # opset >= 10: starts/ends/axes/steps as inputs
        starts = [int(v) for v in _host(ins[1])]
        ends = [int(v) for v in _host(ins[2])]
        axes = ([int(v) for v in _host(ins[3])] if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in _host(ins[4])] if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
    else:
        starts, ends = attrs["starts"], attrs["ends"]
        axes = attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    for s, e, a, st in zip(starts, ends, axes, steps):
        # Python ints: the exporters' "to the end" sentinels (INT32_MAX up
        # to INT64_MAX, INT64_MIN with a negative step) clamp, never wrap
        a %= np.ndim(x)
        dim = x.shape[a]
        start, stop, step = slice(s, e, st).indices(dim)
        lead = (slice(None),) * a
        if _is_host(x):
            x = x[lead + (slice(start, stop if stop >= 0 else None, step),)]
        elif step > 0:
            x = x[lead + (slice(start, stop, step),)]
        else:  # torch slices take no negative step: flip, then step forward
            x = x.flip(a)[lead + (slice(dim - 1 - start, dim - 1 - stop, -step),)]
    return x


@op("Gather", raw=True)
def _gather(ins, attrs):
    data, idx = ins[0], ins[1]
    axis = attrs.get("axis", 0)
    if _is_host(data) and _is_host(idx):
        # shape-math chain (Shape -> Gather -> Range/Reshape): stay host
        return np.asarray(np.take(data, np.asarray(idx).astype(np.int64), axis=axis))
    if _is_host(data):
        data = _to(data, idx.device)
    axis %= data.ndim
    dim = data.shape[axis]
    if _is_host(idx):  # ONNX allows negative indices: wrap from the end
        idx = np.asarray(idx).astype(np.int64)
        flat = _to(np.where(idx < 0, idx + dim, idx).reshape(-1), data.device)
    else:
        flat = idx.to(device=data.device, dtype=torch.int64).reshape(-1)
        flat = torch.where(flat < 0, flat + dim, flat)
    out = data.index_select(axis, flat)
    return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape) + tuple(data.shape[axis + 1:]))


@op("Expand", raw=True)
def _expand(ins, attrs):
    x = ins[0]
    shape = np.broadcast_shapes(tuple(x.shape), tuple(int(s) for s in _host(ins[1])))
    return np.broadcast_to(x, shape) if _is_host(x) else x.expand(shape)


@op("Pad", raw=(1, 2, 3))
def _pad(ins, attrs):
    x = ins[0]
    pads = ([int(p) for p in _host(ins[1])] if len(ins) > 1 and ins[1] is not None
            else list(attrs["pads"]))
    value = (_host(ins[2]).reshape(-1)[0].item() if len(ins) > 2 and ins[2] is not None
             else attrs.get("value", 0.0))
    half = len(pads) // 2
    flat = _flat_pads(list(zip(pads[:half], pads[half:])))
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return F.pad(x, flat, value=value)
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]  # reflect/replicate pad only the trailing dims
    return F.pad(x, flat, mode={"reflect": "reflect", "edge": "replicate"}[mode])


@op("Cast", raw=True)
def _cast(ins, attrs):
    x, to = ins[0], attrs["to"]
    if _is_host(x) and to != P.BFLOAT16:
        return np.asarray(x).astype(P._DTYPE_TO_NP[to])  # host stays host (sentinel-safe)
    return (torch.from_numpy(np.array(x)) if _is_host(x) else x).to(_TORCH_DTYPES[to])


@op("Shape", raw=True)
def _shape(ins, attrs):
    return np.asarray(tuple(ins[0].shape), np.int64)[attrs.get("start", 0):attrs.get("end")]


@op("ConstantOfShape", raw=True)
def _constant_of_shape(ins, attrs):
    shape = [int(s) for s in _host(ins[0])]
    val = attrs.get("value")
    if isinstance(val, torch.Tensor):  # a bfloat16 fill
        return torch.full(shape, val.reshape(-1)[0].item(), dtype=val.dtype, device=_device())
    val = np.asarray(val) if val is not None else np.zeros(1, np.float32)
    if np.issubdtype(val.dtype, np.integer) and val.dtype.itemsize == 8:
        # int64 fills are shape/index constants: stay host, like int64
        # initializers and Constants
        return np.full(shape, val.reshape(-1)[0], dtype=val.dtype)
    return torch.full(shape, val.reshape(-1)[0].item(), dtype=_torch_dtype(val.dtype),
                      device=_device())


@op("Range", raw=True)
def _range(ins, attrs):
    start, limit, delta = (_host(v).reshape(-1)[0] for v in ins[:3])
    return torch.arange(start.item(), limit.item(), delta.item(),
                        dtype=_torch_dtype(np.asarray(start).dtype), device=_device())


@op("Identity", raw=True)
def _identity(ins, attrs):
    return ins[0]


@op("Dropout", raw=True)
def _dropout(ins, attrs):
    return ins[0]  # inference mode


@op("Constant", raw=True)
def _constant(ins, attrs):
    # host numpy (a bfloat16 tensor as torch): device ops take it on demand
    for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        if key in attrs and attrs[key] is not None:
            v = attrs[key]
            return v if isinstance(v, torch.Tensor) else np.asarray(v)
    raise ValueError("Constant node without value attribute")


# ---------------- reductions ----------------

def _prod(x, dims, keep):
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


_REDUCERS = {
    "ReduceMean": lambda x, dims, keep: torch.mean(x, dim=dims, keepdim=keep),
    "ReduceSum": lambda x, dims, keep: torch.sum(x, dim=dims, keepdim=keep),
    "ReduceMax": lambda x, dims, keep: torch.amax(x, dim=dims, keepdim=keep),
    "ReduceMin": lambda x, dims, keep: torch.amin(x, dim=dims, keepdim=keep),
    "ReduceProd": _prod,
}


def _reducer(fn):
    def handler(ins, attrs):
        x, axes = ins[0], _axes_arg(ins, attrs)
        # opset-18 axes-as-input: an EMPTY (or omitted) axes tensor with
        # noop_with_empty_axes=1 means identity, not reduce-all
        if not axes and attrs.get("noop_with_empty_axes"):
            return x
        return fn(x, tuple(axes) if axes else tuple(range(x.ndim)),
                  bool(attrs.get("keepdims", 1)))
    return handler


for _name, _fn in _REDUCERS.items():
    op(_name, raw=(1,))(_reducer(_fn))


@op("TopK", raw=(1,))
def _topk(ins, attrs):
    x = ins[0]
    k = int(_host(ins[1]).reshape(-1)[0])
    axis = attrs.get("axis", -1) % x.ndim
    # a stable sort: equal values keep the lower index first, as
    # lax.top_k does; smallest-k ascending, so unsigned dtypes never wrap
    vals, idx = torch.sort(x, dim=axis, descending=bool(attrs.get("largest", 1)), stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)


@op("ArgMax")
def _argmax(ins, attrs):
    if attrs.get("select_last_index"):
        raise NotImplementedError("ArgMax select_last_index=1")
    return torch.argmax(ins[0], dim=attrs.get("axis", 0), keepdim=bool(attrs.get("keepdims", 1)))


@op("Tile", raw=(1,))
def _tile(ins, attrs):
    return ins[0].repeat(*(int(r) for r in _host(ins[1])))


# ---------------------------------------------------------------------------
# graph executor
# ---------------------------------------------------------------------------

def _tensor_value(t: P.TensorProto):
    """A TensorProto's value: numpy, or a CPU ``torch.bfloat16`` tensor for
    BFLOAT16 (numpy has no such dtype)."""
    arr = tensor_to_numpy(t)
    if t.data_type == P.BFLOAT16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return arr


def _node_attrs(node) -> dict:
    return {a.name: _tensor_value(a.t) if a.type == P.ATTR_TENSOR else a.value
            for a in node.attribute}


def _exec_nodes(nodes, env: dict, device: torch.device) -> None:
    """Run ``(node, attrs)`` pairs of a flat graph over ``env`` in place."""
    token = _DEVICE.set(device)
    try:
        for node, attrs in nodes:
            ins = [env[i] if i else None for i in node.input]
            raw = _RAW[node.op_type]
            if raw is not True:
                ins = [x if i in raw else _to(x, device) for i, x in enumerate(ins)]
            out = OP_REGISTRY[node.op_type](ins, attrs)
            for name, val in zip(node.output, out if isinstance(out, tuple) else (out,)):
                if name:
                    env[name] = val
    finally:
        _DEVICE.reset(token)


def _resolved(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _all_op_types(graph) -> set:
    """Op types in a graph, subgraphs included (registry validation)."""
    ops = set()
    for node in graph.node:
        ops.add(node.op_type)
        for a in node.attribute:
            if a.g is not None:
                ops |= _all_op_types(a.g)
    return ops


class ConvertedModel:
    """A parsed + converted ONNX model: ``run(inputs, device) -> {name:
    tensor}``, or ``model(**inputs)`` on the inputs' device (the CPU for
    numpy inputs).

    ``input_names``/``output_names``/``input_shapes``/``input_types`` are
    the session-style metadata, as in the reference."""

    def __init__(self, model: ModelProto):
        self.model = model
        g = model.graph
        missing = sorted(o for o in _all_op_types(g) if o not in OP_REGISTRY)
        if missing:
            raise NotImplementedError(
                f"ONNX ops not ported to synapseml_torch yet: {missing} ({_WAITING}; "
                f"ported: {sorted(OP_REGISTRY)})")
        init_names = {t.name for t in g.initializer}
        # decoded once: re-decoding ~100 MB of ResNet-50 a call would cost
        # more than the call
        self.weights = {t.name: _tensor_value(t) for t in g.initializer}
        self.input_names = [vi.name for vi in g.input if vi.name not in init_names]
        self.output_names = [vi.name for vi in g.output]
        self.input_shapes = {vi.name: tuple(vi.dims) for vi in g.input
                             if vi.name not in init_names}
        self.input_types = {vi.name: vi.elem_type for vi in g.input
                            if vi.name not in init_names}
        self._nodes = [(n, _node_attrs(n)) for n in g.node]
        self._on_device: dict[torch.device, dict] = {}

    def weights_on(self, device) -> dict:
        """The initializers as graph values for ``device``: int64 ones host
        numpy (shape constants), the rest tensors moved there once."""
        device = _resolved(device)
        env = self._on_device.get(device)
        if env is None:
            env = {k: v if _is_host(v) and v.dtype in (np.int64, np.uint64) else _to(v, device)
                   for k, v in self.weights.items()}
            self._on_device[device] = env
        return env

    def run(self, inputs: Mapping, device) -> dict:
        """The graph's outputs, as tensors on ``device``, for ``inputs``
        (numpy arrays or tensors, by model input name)."""
        device = _resolved(device)
        env = dict(self.weights_on(device))
        for name in self.input_names:
            if name not in inputs:
                raise KeyError(f"missing input {name!r}; expects {self.input_names}")
            env[name] = _to(inputs[name], device)
        _exec_nodes(self._nodes, env, device)
        missing = [o for o in self.output_names if o not in env]
        if missing:
            raise ValueError(f"graph did not produce outputs {missing}")
        return {o: _to(env[o], device) for o in self.output_names}

    def __call__(self, **inputs):
        """``run`` on the device of the first tensor input; with none (numpy
        inputs only) on the card, which a host without one refuses."""
        device = next((x.device for x in inputs.values() if isinstance(x, torch.Tensor)),
                      None)
        if device is None:
            device = resolve_device("ConvertedModel", "cuda")
        return self.run(inputs, device)


def convert_graph(model_bytes: bytes) -> ConvertedModel:
    return ConvertedModel(parse_model(model_bytes))
