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

The registry holds the reference's whole opset, its 165 op types: the stock
opset, the convnet, encoder, decoder, recurrent, vision, quantized,
detection, signal, loss and random groups, and the ``com.microsoft``
contrib ops of :mod:`.contrib` (ORT's transformer fusions). ``If``,
``Loop`` and ``Scan`` run in the executor with the reference's eager
semantics: each subgraph reads the outer scope read-only and brings its own
initializers. An op in neither (a subgraph's included) is refused when the
graph is converted, naming it.

The host reads the device back, one sync each, only where a value decides
what runs or how large an output is:

  * a shape or axis argument computed on the device (``Reshape`` targets,
    ``Slice`` bounds, ``Resize`` scales; the exporters' chains stay host);
  * ``If``'s condition, once an ``If``; ``Loop``'s condition once an
    iteration and its trip count once a ``Loop``;
  * ``NonZero`` (``torch.nonzero``), ``Compress``'s condition and
    ``Unique``'s input: outputs whose shape depends on the data (the
    reference's ``_require_concrete`` rule).

Exact integer products: CUDA has no integer matmul or convolution, so
``MatMulInteger``, ``QLinearMatMul`` and ``QLinearConv`` accumulate in
float64, exact while the sums of products stay under 2**53 (K · 255² for
8-bit operands), and the card computes them bitwise as the CPU does. The
random ops draw from a ``torch.Generator`` seeded from the node's ``seed``
(the float32 value's bits, as the reference keys ``jax.random``), or from a
fixed base plus a counter of draws: the same laws, not ``jax.random``'s
bits.
"""

from __future__ import annotations

import contextvars
import itertools
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


def _binary(np_fn, torch_fn, scalars=True):
    """An elementwise op: all-host inputs stay numpy (shape math), else
    torch with host scalars taken as CPU scalars (``scalars``) or copied to
    the device."""
    def handler(ins, attrs):
        a, b = ins[0], ins[1]
        if _is_host(a) and _is_host(b):
            return np_fn(a, b)
        return torch_fn(*_mix([a, b], scalars=scalars))
    return handler


def _unary(fn):
    return lambda ins, attrs: fn(ins[0])


def _opt(ins, i):
    """Optional input ``i`` (None when omitted or past the end)."""
    return ins[i] if len(ins) > i else None


def _s(v):
    """A string attribute (the reference's direct calls pass bytes)."""
    return v.decode() if isinstance(v, bytes) else v


def _scalar_int(v) -> int:
    return int(_host(v).reshape(-1)[0])


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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _conv_transpose_pads(attrs, x, strides, out_pad, full) -> list[tuple[int, int]]:
    """(begin, end) pads of each spatial dim. ``output_shape`` and
    ``auto_pad`` SAME_* fix the output's size and give the pads by the ONNX
    spec (the reference refuses both)."""
    rank = len(full)
    auto = attrs.get("auto_pad", "NOTSET") or "NOTSET"
    if attrs.get("output_shape") or auto in ("SAME_UPPER", "SAME_LOWER"):
        target = (list(attrs["output_shape"])[-rank:] if attrs.get("output_shape")
                  else [i * s for i, s in zip(x.shape[2:], strides)])
        total = [f + p - t for f, p, t in zip(full, out_pad, target)]
        if auto == "SAME_UPPER":
            return [(t // 2, t - t // 2) for t in total]
        return [(t - t // 2, t // 2) for t in total]
    if auto == "VALID":
        return [(0, 0)] * rank
    pads = attrs.get("pads") or [0] * (2 * rank)
    return [(int(b), int(e)) for b, e in zip(pads[:rank], pads[rank:])]


@op("ConvTranspose")
def _conv_transpose(ins, attrs):
    """The UNet upsampling op: torch's transposed convolution (weights
    ``[C_in, C_out/group, *k]``, as ONNX lays them out) without padding,
    then each spatial dim cut by its begin and end pads and extended by
    ``output_padding`` (zeros before the bias): the ONNX output size
    ``(in-1)*s + (k-1)*d + 1 - pad_begin - pad_end + output_padding``."""
    x, w = ins[0], ins[1]
    rank = x.ndim - 2
    strides = [int(s) for s in (attrs.get("strides") or [1] * rank)]
    dilations = [int(d) for d in (attrs.get("dilations") or [1] * rank)]
    out_pad = [int(p) for p in (attrs.get("output_padding") or [0] * rank)]
    full = [(i - 1) * s + (k - 1) * d + 1
            for i, s, k, d in zip(x.shape[2:], strides, w.shape[2:], dilations)]
    pads = _conv_transpose_pads(attrs, x, strides, out_pad, full)
    y = _CONV_T[rank](x, w, None, strides, 0, 0, int(attrs.get("group", 1)), dilations)
    y = F.pad(y, _flat_pads([(-b, p - e) for (b, e), p in zip(pads, out_pad)]))
    bias = _opt(ins, 2)
    return y if bias is None else y + bias.reshape((1, -1) + (1,) * rank)


@op("InstanceNormalization")
def _instance_norm(ins, attrs):
    # also the lowering torch emits for GroupNorm (reshape -> IN -> reshape)
    x, scale, bias = ins[0], ins[1], ins[2]
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.ndim)), keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean) / torch.sqrt(var + attrs.get("epsilon", 1e-5)) * scale.reshape(shape)
            + bias.reshape(shape))


def _resize_coords(out_len: int, in_len: int, scale: float, ct: str):
    i = np.arange(out_len, dtype=np.float64)
    if ct == "asymmetric":
        return i / scale
    if ct in ("half_pixel", "pytorch_half_pixel"):
        x = (i + 0.5) / scale - 0.5
        if ct == "pytorch_half_pixel" and out_len == 1:
            x = np.zeros_like(x)
        return x
    if ct == "align_corners":
        return i * ((in_len - 1) / max(out_len - 1, 1))
    raise NotImplementedError(f"Resize coordinate mode {ct!r}")


@op("Resize", raw=(1, 2, 3))
def _resize(ins, attrs):
    """Nearest / linear resize (torch ``F.interpolate`` exports): the
    source coordinates of each axis computed on the host per
    ``coordinate_transformation_mode``, then one gather (nearest) or two
    gathers and a lerp (linear) an axis on the device."""
    x = ins[0]

    def arg(i):
        v = None if _opt(ins, i) is None else _host(ins[i])
        return v if v is not None and v.size else None

    scales, sizes = (_host(ins[1]), None) if len(ins) == 2 else (arg(2), arg(3))
    if scales is None and sizes is None:
        raise NotImplementedError("Resize needs scales or sizes")
    if attrs.get("antialias", 0):
        raise NotImplementedError("Resize antialias=1 is not supported")
    mode = _s(attrs.get("mode", "nearest"))
    ct = _s(attrs.get("coordinate_transformation_mode", "half_pixel"))
    nearest_mode = _s(attrs.get("nearest_mode", "round_prefer_floor"))
    if sizes is not None:
        out_shape = [int(s) for s in sizes]
        scale_list = [o / i for o, i in zip(out_shape, x.shape)]
    else:
        scale_list = [float(s) for s in scales]
        out_shape = [int(np.floor(i * s)) for i, s in zip(x.shape, scale_list)]
    out = x
    for ax, (o, n, sc) in enumerate(zip(out_shape, x.shape, scale_list)):
        if o == n:
            continue
        coords = _resize_coords(o, n, sc, ct)
        if mode == "nearest":
            if nearest_mode == "floor":
                idx = np.floor(coords)
            elif nearest_mode == "ceil":
                idx = np.ceil(coords)
            elif nearest_mode == "round_prefer_ceil":
                idx = np.floor(coords + 0.5)
            else:  # round_prefer_floor
                idx = np.ceil(coords - 0.5)
            out = out.index_select(ax, _to(np.clip(idx, 0, n - 1).astype(np.int64), x.device))
        elif mode == "linear":
            lo = np.clip(np.floor(coords), 0, n - 1).astype(np.int64)
            hi = np.clip(lo + 1, 0, n - 1)
            w = np.clip(coords - lo, 0.0, 1.0).astype(np.float32)
            shape = [o if a == ax else 1 for a in range(out.ndim)]
            out = (out.index_select(ax, _to(lo, x.device)) * _to((1.0 - w).reshape(shape), x.device)
                   + out.index_select(ax, _to(hi, x.device)) * _to(w.reshape(shape), x.device))
        else:
            raise NotImplementedError(f"Resize mode {mode!r}")
    return out


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


def _window_sum(x, kernel, strides, dilations):
    """Each window's sum over a dilated kernel: one strided slice of ``x``
    a kernel offset, added in offset order (torch has no dilated average
    pool)."""
    sizes = [(n - (k - 1) * d - 1) // s + 1
             for n, k, d, s in zip(x.shape[2:], kernel, dilations, strides)]
    total = None
    for offs in itertools.product(*(range(k) for k in kernel)):
        idx = (slice(None), slice(None)) + tuple(
            slice(o * d, o * d + (m - 1) * s + 1, s)
            for o, d, s, m in zip(offs, dilations, strides, sizes))
        total = x[idx] if total is None else total + x[idx]
    return total


@op("AveragePool")
def _avgpool(ins, attrs):
    x = ins[0]
    rank = x.ndim - 2
    dilations = list(attrs.get("dilations") or [1] * rank)
    dilated = any(d != 1 for d in dilations)
    kernel, strides, pads, extra = _pool_geometry(x, attrs, dilations)
    pool = (lambda t, k, s: _window_sum(t, k, s, dilations)) if dilated else _AVGPOOL[rank]
    ends = [(b, e + x_) for (b, e), x_ in zip(pads, extra)]
    num = pool(F.pad(x, _flat_pads(ends)) if any(map(any, ends)) else x, kernel, strides)
    include = bool(attrs.get("count_include_pad", 0))
    if include and not any(extra) and not dilated:
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
    "ReduceL1": lambda x, dims, keep: torch.sum(torch.abs(x), dim=dims, keepdim=keep),
    "ReduceL2": lambda x, dims, keep: torch.sqrt(torch.sum(x * x, dim=dims, keepdim=keep)),
    "ReduceSumSquare": lambda x, dims, keep: torch.sum(x * x, dim=dims, keepdim=keep),
    "ReduceLogSum": lambda x, dims, keep: torch.log(torch.sum(x, dim=dims, keepdim=keep)),
    "ReduceLogSumExp": lambda x, dims, keep: torch.logsumexp(x, dim=dims, keepdim=keep),
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


def _arg_reducer(name, fn):
    def handler(ins, attrs):
        if attrs.get("select_last_index"):
            raise NotImplementedError(f"{name} select_last_index=1")
        return fn(ins[0], dim=attrs.get("axis", 0), keepdim=bool(attrs.get("keepdims", 1)))
    return handler


op("ArgMax")(_arg_reducer("ArgMax", torch.argmax))
op("ArgMin")(_arg_reducer("ArgMin", torch.argmin))


@op("Tile", raw=(1,))
def _tile(ins, attrs):
    return ins[0].repeat(*(int(r) for r in _host(ins[1])))


# ---------------- elementwise / logic / layout tail ----------------
# (the long tail of ORT's opset behind the reference ONNXModel; the
# reference's convert.py:938-1178, :1437-1502 and :1713-1732)

def _variadic(pair):
    """An n-ary op folded left to right over a binary handler."""
    def handler(ins, attrs):
        out = ins[0]
        for x in ins[1:]:
            out = pair([out, x], attrs)
        return out
    return handler


for _name, _np_fn, _torch_fn in (("Min", np.minimum, torch.minimum),
                                  ("Max", np.maximum, torch.maximum),
                                  ("Sum", np.add, torch.add),
                                  ("And", np.logical_and, torch.logical_and),
                                  ("Or", np.logical_or, torch.logical_or),
                                  ("Xor", np.logical_xor, torch.logical_xor)):
    op(_name, raw=True)(_variadic(_binary(_np_fn, _torch_fn, scalars=False)))

for _name, _np_fn, _torch_fn in (("GreaterOrEqual", np.greater_equal, torch.ge),
                                  ("LessOrEqual", np.less_equal, torch.le),
                                  ("BitwiseAnd", np.bitwise_and, torch.bitwise_and),
                                  ("BitwiseOr", np.bitwise_or, torch.bitwise_or),
                                  ("BitwiseXor", np.bitwise_xor, torch.bitwise_xor)):
    op(_name, raw=True)(_binary(_np_fn, _torch_fn, scalars=False))


@op("Mean", raw=True)
def _mean_variadic(ins, attrs):
    return OP_REGISTRY["Sum"](ins, attrs) / len(ins)


for _name, _fn in {"Floor": torch.floor, "Ceil": torch.ceil,
                   "Round": torch.round,  # half to even, as the spec and jnp.round
                   "Sign": torch.sign, "Reciprocal": torch.reciprocal,
                   "Softplus": F.softplus, "Softsign": F.softsign, "Mish": F.mish,
                   "IsNaN": torch.isnan, "Tan": torch.tan, "Asin": torch.asin,
                   "Acos": torch.acos, "Atan": torch.atan, "Sinh": torch.sinh,
                   "Cosh": torch.cosh, "Asinh": torch.asinh, "Acosh": torch.acosh,
                   "Atanh": torch.atanh, "BitwiseNot": torch.bitwise_not}.items():
    op(_name)(_unary(_fn))

_MOD = _binary(np.mod, torch.remainder, scalars=False)  # the sign of the divisor
_FMOD = _binary(np.fmod, torch.fmod, scalars=False)     # the sign of the dividend


@op("Mod", raw=True)
def _mod(ins, attrs):
    return (_FMOD if attrs.get("fmod") else _MOD)(ins, attrs)


@op("BitShift", raw=True)
def _bit_shift(ins, attrs):
    if _s(attrs.get("direction")) == "LEFT":
        return _binary(np.left_shift, torch.bitwise_left_shift, scalars=False)(ins, attrs)
    return _binary(np.right_shift, torch.bitwise_right_shift, scalars=False)(ins, attrs)


@op("PRelu")
def _prelu(ins, attrs):
    x, slope = ins[0], ins[1]
    return torch.where(x < 0, slope * x, x)


@op("Elu")
def _elu(ins, attrs):
    x = ins[0]
    return torch.where(x < 0, attrs.get("alpha", 1.0) * (torch.exp(x) - 1.0), x)


@op("Selu")
def _selu(ins, attrs):
    x = ins[0]
    a = attrs.get("alpha", 1.67326319217681884765625)
    g = attrs.get("gamma", 1.05070102214813232421875)
    return g * torch.where(x < 0, a * (torch.exp(x) - 1.0), x)


@op("Celu")
def _celu(ins, attrs):
    x, a = ins[0], attrs.get("alpha", 1.0)
    return torch.clamp_min(x, 0) + torch.clamp_max(a * (torch.exp(x / a) - 1.0), 0)


@op("ThresholdedRelu")
def _thresholded_relu(ins, attrs):
    x = ins[0]
    return torch.where(x > attrs.get("alpha", 1.0), x, 0.0)


@op("Shrink")
def _shrink(ins, attrs):
    x, lambd, bias = ins[0], attrs.get("lambd", 0.5), attrs.get("bias", 0.0)
    return torch.where(x < -lambd, x + bias, torch.where(x > lambd, x - bias, 0.0))


@op("IsInf")
def _isinf(ins, attrs):
    x = ins[0]
    out = torch.zeros_like(x, dtype=torch.bool)
    if attrs.get("detect_positive", 1):
        out = out | torch.isposinf(x)
    if attrs.get("detect_negative", 1):
        out = out | torch.isneginf(x)
    return out


@op("CumSum", raw=(1,))
def _cumsum(ins, attrs):
    x = ins[0]
    axis = _scalar_int(ins[1]) % x.ndim
    if attrs.get("reverse"):
        x = x.flip(axis)
    out = torch.cumsum(x, axis, dtype=x.dtype)
    if attrs.get("exclusive"):
        out = F.pad(out, [0, 0] * (x.ndim - 1 - axis) + [1, 0]).narrow(axis, 0, x.shape[axis])
    return out.flip(axis) if attrs.get("reverse") else out


@op("OneHot", raw=(1,))
def _one_hot(ins, attrs):
    idx, depth, values = ins[0].long(), _scalar_int(ins[1]), ins[2].reshape(-1)
    idx = torch.where(idx < 0, idx + depth, idx)  # negative indices wrap, per the spec
    # a comparison, not F.one_hot: an index past the depth gives an all-off
    # row (as jax.nn.one_hot), never a device assert; off/on values keep
    # their dtype (int64 values above 2**24 stay exact)
    hot = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
    hot = hot.movedim(-1, attrs.get("axis", -1) % (idx.ndim + 1))
    return torch.where(hot, values[1], values[0])


@op("DepthToSpace")
def _depth_to_space(ins, attrs):
    x, b = ins[0], int(attrs["blocksize"])
    N, C, H, W = x.shape
    if _s(attrs.get("mode", "DCR")) == "CRD":
        t = x.reshape(N, C // (b * b), b, b, H, W).permute(0, 1, 4, 2, 5, 3)
    else:
        t = x.reshape(N, b, b, C // (b * b), H, W).permute(0, 3, 4, 1, 5, 2)
    return t.reshape(N, C // (b * b), H * b, W * b)


@op("SpaceToDepth")
def _space_to_depth(ins, attrs):
    x, b = ins[0], int(attrs["blocksize"])
    N, C, H, W = x.shape
    t = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return t.reshape(N, C * b * b, H // b, W // b)


@op("ReverseSequence")
def _reverse_sequence(ins, attrs):
    x, lens = ins[0], ins[1].long()
    axes = (attrs.get("batch_axis", 1), attrs.get("time_axis", 0))
    xb = x.movedim(axes, (0, 1))
    t = torch.arange(xb.shape[1], device=x.device)[None, :]
    # per batch row: the first len[b] steps reversed, the rest untouched
    rev = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    rev = rev.reshape(rev.shape + (1,) * (xb.ndim - 2)).expand(xb.shape)
    return torch.gather(xb, 1, rev).movedim((0, 1), axes)


@op("EyeLike", raw=True)
def _eye_like(ins, attrs):
    x = ins[0]
    if "dtype" in attrs:
        dtype = _TORCH_DTYPES[attrs["dtype"]]
    else:
        dtype = _torch_dtype(x.dtype) if _is_host(x) else x.dtype
    dev = x.device if isinstance(x, torch.Tensor) else _device()
    rows = torch.arange(x.shape[0], device=dev)[:, None]
    cols = torch.arange(x.shape[1], device=dev)[None, :]
    return (cols - rows == attrs.get("k", 0)).to(dtype)


@op("Size", raw=True)
def _size(ins, attrs):
    return np.asarray(int(np.prod(tuple(ins[0].shape))), np.int64)


@op("Hardmax")
def _hardmax(ins, attrs):
    """One-hot of the argmax along ``axis`` (ties to the first index, as
    ORT and the reference)."""
    x = ins[0]
    axis = attrs.get("axis", -1) % x.ndim
    dtype = x.dtype if x.is_floating_point() else torch.float32
    idx = torch.argmax(x, dim=axis, keepdim=True)
    return torch.zeros(x.shape, dtype=dtype, device=x.device).scatter_(axis, idx, 1.0)


@op("LRN")
def _lrn(ins, attrs):
    """Local response normalization over the channel axis: ``x / (bias +
    alpha/size * sum_window x^2)^beta``, the window sum as ``size``
    channel-shifted slices in f32."""
    x, size = ins[0], int(attrs["size"])
    alpha, beta, bias = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75), attrs.get("bias", 1.0)
    C, lo = x.shape[1], (size - 1) // 2  # window: [c - lo, c + (size - 1 - lo)]
    sq = F.pad(torch.square(x.float()), [0, 0] * (x.ndim - 2) + [lo, size - 1 - lo])
    acc = sq.narrow(1, 0, C)
    for i in range(1, size):
        acc = acc + sq.narrow(1, i, C)
    return (x / torch.pow(bias + (alpha / size) * acc, beta)).to(x.dtype)


@op("LpNormalization")
def _lp_normalization(ins, attrs):
    x, axis, p = ins[0], attrs.get("axis", -1), attrs.get("p", 2)
    if p == 1:
        return x / torch.sum(torch.abs(x), dim=axis, keepdim=True)
    if p == 2:
        return x / torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    raise NotImplementedError(f"LpNormalization p={p} (spec allows 1 or 2)")


@op("GlobalLpPool")
def _global_lp_pool(ins, attrs):
    x, p = ins[0], attrs.get("p", 2)
    out = torch.sum(torch.abs(x.float()) ** p, dim=tuple(range(2, x.ndim)), keepdim=True)
    return (out ** (1.0 / p)).to(x.dtype)


# ---------------- index ops ----------------
# (the reference's :749-766 and :1303-1358; indices wrap from the end when
# negative, as ONNX allows)

@op("Trilu", raw=(1,))
def _trilu(ins, attrs):
    # causal masks: torch.tril/triu export (GPT-style decoders)
    k = _scalar_int(ins[1]) if _opt(ins, 1) is not None else 0
    return torch.triu(ins[0], k) if attrs.get("upper", 1) else torch.tril(ins[0], k)


def _wrapped(idx, dim):
    idx = idx.long()
    return torch.where(idx < 0, idx + dim, idx)


@op("GatherElements")
def _gather_elements(ins, attrs):
    x = ins[0]
    axis = attrs.get("axis", 0) % x.ndim
    return torch.gather(x, axis, _wrapped(ins[1], x.shape[axis]))


@op("GatherND")
def _gather_nd(ins, attrs):
    """``x[idx]`` over the last index dim, with ``batch_dims`` leading dims
    shared: those flattened into one batch index beside the index tuple."""
    x, idx = ins[0], ins[1].long()
    b, k = attrs.get("batch_dims", 0), idx.shape[-1]
    nb = int(np.prod(x.shape[:b]))
    xf = x.reshape((nb,) + tuple(x.shape[b:]))
    idxf = idx.reshape(nb, -1, k)
    rows = torch.arange(nb, device=x.device)[:, None].expand(idxf.shape[:2])
    out = xf[(rows,) + tuple(idxf[..., j] for j in range(k))]
    return out.reshape(tuple(idx.shape[:-1]) + tuple(x.shape[b + k:]))


_SCATTER_REDUCE = {"add": "sum", "mul": "prod", "min": "amin", "max": "amax"}


def _scatter_reduction(attrs):
    red = _s(attrs.get("reduction", "none"))
    if red in ("none", None, ""):
        return None
    if red not in _SCATTER_REDUCE:
        raise NotImplementedError(f"scatter reduction {red!r}")
    return _SCATTER_REDUCE[red]


@op("ScatterElements")
def _scatter_elements(ins, attrs):
    x, updates = ins[0], ins[2].to(ins[0].dtype)
    red = _scatter_reduction(attrs)
    axis = attrs.get("axis", 0) % x.ndim
    idx = _wrapped(ins[1], x.shape[axis])
    if red is None:
        return x.scatter(axis, idx, updates)
    return x.scatter_reduce(axis, idx, updates, red, include_self=True)


@op("ScatterND")
def _scatter_nd(ins, attrs):
    """Updates of whole slices ``x[idx[..., :k]]``: the k leading index
    dims flattened into one row index of ``x`` viewed ``[rows, *rest]``."""
    x, idx = ins[0], ins[1].long()
    red = _scatter_reduction(attrs)
    k = idx.shape[-1]
    rest = tuple(x.shape[k:])
    row = torch.zeros(idx.shape[:-1], dtype=torch.long, device=x.device)
    for j, n in enumerate(x.shape[:k]):
        row = row * n + _wrapped(idx[..., j], n)
    flat = x.reshape((-1,) + rest).clone()
    row, updates = row.reshape(-1), ins[2].to(x.dtype).reshape((-1,) + rest)
    if red is None:
        flat[row] = updates
    elif red == "sum":
        flat.index_add_(0, row, updates)
    else:
        flat.index_reduce_(0, row, updates, red, include_self=True)
    return flat.reshape(x.shape)


# ---------------- spatial sampling / normalization / opset-18 tail ----------------
# (the reference's :1503-1712, :1733-1754 and :1886-1926)

def _denorm_coord(g, size, align_corners):
    # normalized [-1, 1] -> pixel coordinates per the GridSample spec
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def _reflect_coord(c, lo, hi):
    # reflect into [lo, hi] with period 2*(hi-lo); a degenerate span (a
    # size-1 dim under align_corners) maps everything to its one coordinate
    span = hi - lo
    if span <= 0:
        return torch.full_like(c, lo)
    c = torch.remainder(torch.abs(c - lo), 2 * span)
    return torch.where(c > span, 2 * span - c, c) + lo


@op("GridSample")
def _grid_sample(ins, attrs):
    """Spatial-transformer sampling (opset 16+, 4D): each output pixel
    samples the input at its grid coordinate, by advanced-index gathers of
    the clamped corners."""
    x, grid = ins[0], ins[1]
    mode = _s(attrs.get("mode", "bilinear"))
    mode = "bilinear" if mode == "linear" else mode
    pad = _s(attrs.get("padding_mode", "zeros"))
    align = bool(attrs.get("align_corners", 0))
    if x.ndim != 4:
        raise NotImplementedError("GridSample: only 4D (NCHW) supported")
    N, C, H, W = x.shape
    gx = _denorm_coord(grid[..., 0].float(), W, align)  # [N, Ho, Wo]
    gy = _denorm_coord(grid[..., 1].float(), H, align)
    if pad == "reflection":
        if align:
            gx, gy = _reflect_coord(gx, 0.0, W - 1), _reflect_coord(gy, 0.0, H - 1)
        else:
            gx = _reflect_coord(gx, -0.5, W - 0.5).clamp(0, W - 1)
            gy = _reflect_coord(gy, -0.5, H - 0.5).clamp(0, H - 1)
        pad = "border"  # reflected coordinates are in range: sample as border
    n_idx = torch.arange(N, device=x.device)[:, None, None]

    def sample_int(ix, iy):
        vals = x[n_idx, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)].movedim(-1, 1)
        if pad == "zeros":
            inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            vals = vals * inb[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return sample_int(torch.round(gx).long(), torch.round(gy).long())
    if mode != "bilinear":
        raise NotImplementedError(f"GridSample mode {mode!r}")
    if pad == "border":
        # the continuous coordinate clamped first, so that the two corners
        # straddle the clamped point (ORT's border semantics)
        gx, gy = gx.clamp(0, W - 1), gy.clamp(0, H - 1)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    wx, wy = (gx - x0)[:, None].to(x.dtype), (gy - y0)[:, None].to(x.dtype)
    return (sample_int(x0, y0) * (1 - wx) * (1 - wy)
            + sample_int(x0 + 1, y0) * wx * (1 - wy)
            + sample_int(x0, y0 + 1) * (1 - wx) * wy
            + sample_int(x0 + 1, y0 + 1) * wx * wy)


@op("AffineGrid", raw=(1,))
def _affine_grid(ins, attrs):
    """Opset-20 AffineGrid (torch's ``affine_grid``): batched affine maps
    over a normalized base grid, feeding GridSample."""
    theta = ins[0].float()
    size = [int(v) for v in _host(ins[1])]
    align = bool(attrs.get("align_corners", 0))
    dev = theta.device

    def coords(n):
        if align:
            return (torch.linspace(-1.0, 1.0, n, device=dev) if n > 1
                    else torch.zeros(1, device=dev))
        return (2.0 * torch.arange(n, device=dev) + 1.0) / n - 1.0

    if len(size) == 4:                       # 2D: [N, C, H, W] -> [N, H, W, 2]
        gy, gx = torch.meshgrid(coords(size[2]), coords(size[3]), indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwk,nik->nhwi", base, theta)
    if len(size) == 5:                       # 3D: [N, C, D, H, W]
        gz, gy, gx = torch.meshgrid(coords(size[2]), coords(size[3]), coords(size[4]),
                                    indexing="ij")
        base = torch.stack([gx, gy, gz, torch.ones_like(gx)], dim=-1)
        return torch.einsum("dhwk,nik->ndhwi", base, theta)
    raise NotImplementedError(f"AffineGrid size rank {len(size)}")


@op("RoiAlign")
def _roi_align(ins, attrs):
    """Mask-R-CNN ROI pooling (opset 16): bilinear samples on a fixed grid a
    bin, averaged (or the max of the weighted corners), every ROI at once.
    ``sampling_ratio=0`` takes a 2x2 grid a bin, as the reference (whose
    static shapes cannot take ORT's adaptive grid)."""
    x, rois, bidx = ins[0], ins[1], ins[2].long()
    out_h, out_w = int(attrs.get("output_height", 1)), int(attrs.get("output_width", 1))
    ratio = int(attrs.get("sampling_ratio", 0)) or 2
    half_pixel = _s(attrs.get("coordinate_transformation_mode", "half_pixel")) == "half_pixel"
    N, C, H, W = x.shape
    r = rois.float() * float(attrs.get("spatial_scale", 1.0)) - (0.5 if half_pixel else 0.0)
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = x2 - x1, y2 - y1
    if not half_pixel:  # ORT applies the legacy >= 1 clamp only here
        rw, rh = rw.clamp_min(1.0), rh.clamp_min(1.0)
    dev, R = x.device, r.shape[0]
    # sample centres: ``ratio`` a bin along each axis
    sx = (x1[:, None]
          + (torch.arange(out_w * ratio, device=dev) + 0.5) * (rw / out_w / ratio)[:, None])
    sy = (y1[:, None]
          + (torch.arange(out_h * ratio, device=dev) + 0.5) * (rh / out_h / ratio)[:, None])
    gx = sx[:, None, :].expand(R, out_h * ratio, out_w * ratio)
    gy = sy[:, :, None].expand(R, out_h * ratio, out_w * ratio)
    # a sample past the 1-pixel halo contributes zero; any other is clamped
    # into the image (border pixels at full weight), never corner-zeroed
    live = ~((gx < -1.0) | (gx > W) | (gy < -1.0) | (gy > H))
    gx, gy = gx.clamp(0.0, W - 1), gy.clamp(0.0, H - 1)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    live = live[:, None].to(x.dtype)
    b = bidx[:, None, None]

    def corner(ix, iy):
        return x[b, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)].movedim(-1, 1)

    contribs = (corner(x0, y0) * (1 - wx) * (1 - wy) * live,
                corner(x0 + 1, y0) * wx * (1 - wy) * live,
                corner(x0, y0 + 1) * (1 - wx) * wy * live,
                corner(x0 + 1, y0 + 1) * wx * wy * live)
    if _s(attrs.get("mode", "avg")) == "max":
        # ORT's max mode: the max over every sample's weighted corners
        vals = torch.stack(contribs).amax(0).reshape(R, C, out_h, ratio, out_w, ratio)
        return vals.amax(dim=(3, 5))
    vals = (contribs[0] + contribs[1] + contribs[2] + contribs[3])
    return vals.reshape(R, C, out_h, ratio, out_w, ratio).mean(dim=(3, 5))


@op("GroupNormalization")
def _group_norm(ins, attrs):
    """Opset-18 GroupNormalization (the diffusion-UNet norm), with the
    opset-18 per-group and the opset-21 per-channel scale/bias shapes."""
    x, scale, bias = ins[0], ins[1], ins[2]
    G = int(attrs["num_groups"])
    N, C = x.shape[0], x.shape[1]
    xg = x.reshape((N, G, C // G) + tuple(x.shape[2:]))
    var, mean = torch.var_mean(xg, dim=tuple(range(2, xg.ndim)), keepdim=True, correction=0)
    y = ((xg - mean) / torch.sqrt(var + attrs.get("epsilon", 1e-5))).reshape(x.shape)
    if scale.shape[0] == G != C:  # opset-18 per-group parameters
        scale, bias = scale.repeat_interleave(C // G), bias.repeat_interleave(C // G)
    shape = (1, C) + (1,) * (x.ndim - 2)
    return y * scale.reshape(shape) + bias.reshape(shape)


@op("MeanVarianceNormalization")
def _mvn(ins, attrs):
    x = ins[0]
    var, mean = torch.var_mean(x, dim=tuple(attrs.get("axes", (0, 2, 3))), keepdim=True,
                               correction=0)
    return (x - mean) / (torch.sqrt(var) + 1e-9)


@op("CenterCropPad", raw=(1,))
def _center_crop_pad(ins, attrs):
    """Opset-18: center-crop dims larger than the target (the extra element
    off the end), center-pad smaller ones with zeros."""
    x = ins[0]
    axes = attrs.get("axes")
    axes = list(range(x.ndim)) if axes is None else [int(a) % x.ndim for a in axes]
    for a, t in zip(axes, _host(ins[1]).astype(np.int64).tolist()):
        cur = x.shape[a]
        if cur > t:
            x = x.narrow(a, (cur - t) // 2, t)
        elif cur < t:
            pads = [(0, 0)] * x.ndim
            pads[a] = ((t - cur) // 2, t - cur - (t - cur) // 2)
            x = F.pad(x, _flat_pads(pads))
    return x


@op("Col2Im", raw=(1, 2))
def _col2im(ins, attrs):
    """Opset-18 inverse im2col: column blocks added back into the image
    (overlaps accumulate), one strided-slice add a kernel offset."""
    cols = ins[0]                                   # [N, C*kh*kw, L]
    image_shape = [int(v) for v in _host(ins[1])]
    block_shape = [int(v) for v in _host(ins[2])]
    if len(image_shape) != 2:
        raise NotImplementedError("Col2Im: only 2D images supported")
    (H, W), (kh, kw) = image_shape, block_shape
    dh, dw = attrs.get("dilations") or (1, 1)
    sh, sw = attrs.get("strides") or (1, 1)
    pt, pl, pb, pr = (int(p) for p in attrs.get("pads", (0, 0, 0, 0)))
    N = cols.shape[0]
    C = cols.shape[1] // (kh * kw)
    n_h = (H + pt + pb - (dh * (kh - 1) + 1)) // sh + 1
    n_w = (W + pl + pr - (dw * (kw - 1) + 1)) // sw + 1
    blocks = cols.reshape(N, C, kh, kw, n_h, n_w)
    out = torch.zeros((N, C, H + pt + pb, W + pl + pr), dtype=cols.dtype, device=cols.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + (n_h - 1) * sh + 1:sh,
                j * dw:j * dw + (n_w - 1) * sw + 1:sw] += blocks[:, :, i, j]
    return out[:, :, pt:pt + H, pl:pl + W]


# ---------------- recurrent (a time loop on the device) ----------------
# (the reference's :491-634, which scans with lax.scan: each direction here
# is a Python loop over T steps of tensors on the call's device)

def _seq_mask(seq_lens, T: int, device):
    """``[T, B, 1]`` validity mask from ONNX ``sequence_lens`` (None = all
    valid)."""
    if seq_lens is None:
        return None
    t = torch.arange(T, device=device)[:, None]
    return (t < seq_lens.to(device)[None, :]).float()[..., None]


def _steps(T: int, reverse: bool):
    return reversed(range(T)) if reverse else range(T)


def _lstm_direction(x, w, r, b, h0, c0, mask, reverse: bool):
    """One LSTM direction. ONNX gate order i, o, f, c; sigmoid / tanh /
    tanh. x: [T, B, I]; w: [4H, I]; r: [4H, H]; b: [8H]."""
    H = r.shape[1]
    xw = torch.matmul(x, w.T)                        # the input projection at once
    if b is not None:
        xw = xw + b[:4 * H] + b[4 * H:]
    rT, h, c, ys = r.T, h0, c0, [None] * x.shape[0]
    for t in _steps(x.shape[0], reverse):
        gates = xw[t] + h @ rT
        i, o, f, g = (gates[:, k * H:(k + 1) * H] for k in range(4))
        i, o, f = torch.sigmoid(i), torch.sigmoid(o), torch.sigmoid(f)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        if mask is not None:
            m = mask[t]
            h_new = m * h_new + (1 - m) * h          # frozen past the sequence's end
            c_new = m * c_new + (1 - m) * c
            ys[t] = m * h_new                        # ONNX: padded steps output 0
        else:
            ys[t] = h_new
        h, c = h_new, c_new
    return torch.stack(ys), h, c


def _rnn_checks(name, ins, attrs, peephole: bool = False):
    if attrs.get("activations"):
        raise NotImplementedError(f"{name} custom activations")
    if attrs.get("layout", 0):
        raise NotImplementedError(f"{name} layout=1 (batch-first)")
    if attrs.get("clip") is not None:
        raise NotImplementedError(f"{name} cell clipping")
    if peephole and _opt(ins, 7) is not None:
        raise NotImplementedError(f"{name} peephole connections (input P)")


def _directions(attrs, n_dir):
    return [d == 1 or _s(attrs.get("direction")) == "reverse" for d in range(n_dir)]


@op("LSTM")
def _lstm(ins, attrs):
    x, W, R, B_ = ins[0], ins[1], ins[2], _opt(ins, 3)  # [T,B,I], [D,4H,I], [D,4H,H], [D,8H]
    _rnn_checks("LSTM", ins, attrs, peephole=True)
    n_dir, H = W.shape[0], R.shape[2]
    zeros = torch.zeros((n_dir, x.shape[1], H), dtype=x.dtype, device=x.device)
    h0 = zeros if _opt(ins, 5) is None else ins[5]
    c0 = zeros if _opt(ins, 6) is None else ins[6]
    mask = _seq_mask(_opt(ins, 4), x.shape[0], x.device)
    outs = [_lstm_direction(x, W[d], R[d], None if B_ is None else B_[d], h0[d], c0[d], mask, rev)
            for d, rev in enumerate(_directions(attrs, n_dir))]
    return (torch.stack([o[0] for o in outs], dim=1),   # Y: [T, D, B, H]
            torch.stack([o[1] for o in outs]),          # Y_h: [D, B, H]
            torch.stack([o[2] for o in outs]))          # Y_c: [D, B, H]


def _gru_direction(x, w, r, b, h0, mask, linear_before_reset, reverse: bool):
    """One GRU direction. ONNX gate order z, r, h. x: [T, B, I]; w: [3H,
    I]; r: [3H, H]; b: [6H] (Wb zrh + Rb zrh)."""
    H = r.shape[1]
    zeros = torch.zeros(3 * H, dtype=x.dtype, device=x.device)
    wb, rb = (zeros, zeros) if b is None else (b[:3 * H], b[3 * H:])
    xw = torch.matmul(x, w.T) + wb
    rT, h, ys = r.T, h0, [None] * x.shape[0]
    for t in _steps(x.shape[0], reverse):
        xt, hr = xw[t], h @ rT
        z = torch.sigmoid(xt[:, :H] + hr[:, :H] + rb[:H])
        rt = torch.sigmoid(xt[:, H:2 * H] + hr[:, H:2 * H] + rb[H:2 * H])
        if linear_before_reset:
            hh = torch.tanh(xt[:, 2 * H:] + rt * (hr[:, 2 * H:] + rb[2 * H:]))
        else:
            hh = torch.tanh(xt[:, 2 * H:] + (rt * h) @ rT[:, 2 * H:] + rb[2 * H:])
        h_new = (1 - z) * hh + z * h
        if mask is not None:
            m = mask[t]
            h_new = m * h_new + (1 - m) * h
            ys[t] = m * h_new
        else:
            ys[t] = h_new
        h = h_new
    return torch.stack(ys), h


@op("GRU")
def _gru(ins, attrs):
    x, W, R, B_ = ins[0], ins[1], ins[2], _opt(ins, 3)
    _rnn_checks("GRU", ins, attrs)
    n_dir, H = W.shape[0], R.shape[2]
    h0 = (torch.zeros((n_dir, x.shape[1], H), dtype=x.dtype, device=x.device)
          if _opt(ins, 5) is None else ins[5])
    mask = _seq_mask(_opt(ins, 4), x.shape[0], x.device)
    lbr = attrs.get("linear_before_reset", 0)
    outs = [_gru_direction(x, W[d], R[d], None if B_ is None else B_[d], h0[d], mask, lbr, rev)
            for d, rev in enumerate(_directions(attrs, n_dir))]
    return torch.stack([o[0] for o in outs], dim=1), torch.stack([o[1] for o in outs])


# ---------------- quantization family ----------------
# (the reference's :1180-1302: rounding half to even, saturation to the
# zero point's dtype; the integer products exact, in float64 here, as
# CUDA has no integer matmul or convolution)

def _per_axis(scale, zp, ndim, axis):
    """Per-axis scale / zero point broadcast to the tensor's rank."""
    scale = scale.float()
    if scale.ndim == 1 and scale.numel() > 1:
        shape = [1] * ndim
        shape[axis] = scale.numel()
        scale = scale.reshape(shape)
        if zp is not None and zp.ndim == 1:
            zp = zp.reshape(shape)
    return scale, zp


def _saturate(x, dtype):
    info = torch.iinfo(dtype)
    return torch.clamp(x, info.min, info.max).to(dtype)


@op("QuantizeLinear")
def _quantize_linear(ins, attrs):
    x, scale, zp = ins[0], ins[1], _opt(ins, 2)
    dtype = zp.dtype if zp is not None else torch.uint8
    scale, zp = _per_axis(scale, zp, x.ndim, attrs.get("axis", 1))
    q = torch.round(x.float() / scale)
    if zp is not None:
        q = q + zp.float()
    return _saturate(q, dtype)


@op("DequantizeLinear")
def _dequantize_linear(ins, attrs):
    x, scale, zp = ins[0], ins[1], _opt(ins, 2)
    scale, zp = _per_axis(scale, zp, x.ndim, attrs.get("axis", 1))
    xf = x.float()
    if zp is not None:
        xf = xf - zp.float()
    return xf * scale


@op("DynamicQuantizeLinear")
def _dynamic_quantize_linear(ins, attrs):
    x = ins[0].float()
    # the spec: the range includes 0, so the zero point is representable
    lo, hi = torch.clamp_max(x.min(), 0.0), torch.clamp_min(x.max(), 0.0)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, not the correctly rounded quotient the CPU gives
    scale = (hi - lo) / torch.tensor(255.0, device=x.device)
    scale = torch.where(scale == 0, 1.0, scale)  # an all-zero input
    zp = _saturate(torch.round(-lo / scale), torch.uint8)
    return _saturate(torch.round(x / scale) + zp.float(), torch.uint8), scale, zp


def _int_matmul(a, a_zp, b, b_zp):
    """``(a - a_zp) @ (b - b_zp)`` as int32, exact: the products summed in
    float64 (every partial sum an integer under 2**53 up to K = 2**37 for
    8-bit operands), the same on the card, where CUDA has no integer
    matmul, as on the CPU. A per-row ``a_zp`` ([M]) applies along a's
    second-to-last axis; a per-column ``b_zp`` ([N]) broadcasts as it is."""
    a64, b64 = a.double(), b.double()
    if a_zp is not None:
        z = a_zp.double()
        a64 = a64 - (z[..., :, None] if z.ndim >= 1 and z.numel() > 1 else z)
    if b_zp is not None:
        b64 = b64 - b_zp.double()
    return torch.matmul(a64, b64).to(torch.int32)


@op("MatMulInteger")
def _matmul_integer(ins, attrs):
    return _int_matmul(ins[0], _opt(ins, 2), ins[1], _opt(ins, 3))


def _requantize(acc, mult, y_zp):
    """``round(acc * mult) + y_zp`` saturated to ``y_zp``'s dtype, in f32
    as the reference (one quantization step off ORT once |acc| > 2**24)."""
    return _saturate(torch.round(acc * mult) + y_zp.float(), y_zp.dtype)


@op("QLinearMatMul")
def _qlinear_matmul(ins, attrs):
    a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp = ins[:8]
    acc = _int_matmul(a, a_zp, b, b_zp).float()
    a_s = a_scale.float()
    if a_s.ndim >= 1 and a_s.numel() > 1:  # per-row: along the M axis
        a_s = a_s[..., :, None]
    return _requantize(acc, a_s * b_scale.float() / y_scale.float(), y_zp)


@op("QLinearConv")
def _qlinear_conv(ins, attrs):
    x, x_scale, x_zp, w, w_scale, w_zp, y_scale, y_zp = ins[:8]
    bias = _opt(ins, 8)
    wz = w_zp.double()
    if wz.ndim == 1 and wz.numel() > 1:  # a per-output-channel zero point
        wz = wz.reshape((-1,) + (1,) * (w.ndim - 1))
    # the integer convolution exact in float64 (cuDNN has no integer one),
    # then f32 as the reference's accumulator
    acc = _conv([x.double() - x_zp.double(), w.double() - wz], attrs).float()
    if bias is not None:  # int32, at scale x_scale * w_scale
        acc = acc + bias.float().reshape((1, -1) + (1,) * (acc.ndim - 2))
    mult = x_scale.float() * w_scale.float() / y_scale.float()
    if mult.ndim == 1 and mult.numel() > 1:  # a per-output-channel scale
        mult = mult.reshape((1, -1) + (1,) * (acc.ndim - 2))
    return _requantize(acc, mult, y_zp)


# ---------------- detection and data-dependent shapes ----------------
# (the reference's :1359-1436 and :1999-2053)

@op("NonMaxSuppression", raw=(2,))
def _non_max_suppression(ins, attrs):
    """Greedy NMS of every (batch, class) at once on the device, in the
    reference's static layout: ``B * C * min(max_output_boxes_per_class,
    N)`` int32 rows of consecutive (batch, class) blocks, each block's
    unused slots ``[-1, -1, -1]``. One step a selected box, no host read."""
    boxes, scores = ins[0], ins[1]                     # [B, N, 4], [B, C, N]
    max_out = _scalar_int(ins[2]) if _opt(ins, 2) is not None else 0
    dev = boxes.device
    iou_thr = (ins[3].float().reshape(()) if _opt(ins, 3) is not None
               else torch.zeros((), device=dev))
    score_thr = (ins[4].float().reshape(()) if _opt(ins, 4) is not None
                 else torch.full((), -torch.inf, device=dev))
    (B, N), C = boxes.shape[:2], scores.shape[1]
    if max_out <= 0 or N == 0:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    max_out = min(max_out, N)
    if attrs.get("center_point_box", 0):
        xc, yc, w, h = boxes.unbind(-1)
        y1, x1, y2, x2 = yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2
    else:  # corners in either order, per the spec
        a, b = boxes[..., :2], boxes[..., 2:]
        (y1, x1), (y2, x2) = torch.minimum(a, b).unbind(-1), torch.maximum(a, b).unbind(-1)
    area = (y2 - y1) * (x2 - x1)                       # [B, N]
    alive = torch.ones((B, C, N), dtype=torch.bool, device=dev)
    picked = torch.empty((B, C, max_out), dtype=torch.long, device=dev)
    ids = torch.arange(N, device=dev)

    def at(t, i):                                      # t[b, i[b, c]] -> [B, C, 1]
        return t.gather(1, i)[..., None]

    for k in range(max_out):
        masked = torch.where(alive, scores, -torch.inf)
        i = masked.argmax(-1)                          # [B, C]: ties to the first
        ok = masked.gather(-1, i[..., None])[..., 0] > score_thr
        inter = (torch.clamp_min(torch.minimum(y2[:, None], at(y2, i))
                                 - torch.maximum(y1[:, None], at(y1, i)), 0)
                 * torch.clamp_min(torch.minimum(x2[:, None], at(x2, i))
                                   - torch.maximum(x1[:, None], at(x1, i)), 0))
        iou = inter / torch.clamp_min(area[:, None] + at(area, i) - inter, 1e-12)
        alive = alive & ~(iou > iou_thr) & (ids != i[..., None]) & ok[..., None]
        picked[..., k] = torch.where(ok, i, -1)
    sel = picked >= 0
    rows = torch.stack([torch.where(sel, torch.arange(B, device=dev)[:, None, None], -1),
                        torch.where(sel, torch.arange(C, device=dev)[None, :, None], -1),
                        picked], dim=-1)
    return rows.reshape(-1, 3).to(torch.int32)


@op("NonZero", raw=True)
def _nonzero(ins, attrs):
    x = ins[0]
    if _is_host(x):
        return np.stack(np.nonzero(x)).astype(np.int64)
    # the output's length is the data's: torch.nonzero reads the count back
    return torch.nonzero(x).T.contiguous()


@op("Compress", raw=(1,))
def _compress(ins, attrs):
    # only the condition is read back (the output's shape is its count);
    # the data stays on the device
    x = ins[0]
    idx = _to(np.nonzero(_host(ins[1]).astype(bool))[0].astype(np.int64), x.device)
    axis = attrs.get("axis")
    if axis is None:
        return x.reshape(-1).index_select(0, idx)
    return x.index_select(int(axis) % x.ndim, idx)


@op("Unique", raw=True)
def _unique(ins, attrs):
    """Y, indices, inverse_indices, counts (int64) of the input read back
    once, by numpy as in the reference; ``sorted=0`` reorders the uniques
    to first-occurrence order. Outputs live where the input did."""
    x, axis = ins[0], attrs.get("axis")
    xh = _host(x)
    vals, index, inverse, counts = np.unique(
        xh if axis is not None else xh.ravel(), axis=axis,
        return_index=True, return_inverse=True, return_counts=True)
    if not attrs.get("sorted", 1):
        order = np.argsort(index, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        vals = np.take(vals, order, axis=0 if axis is None else axis)
        index, counts, inverse = index[order], counts[order], rank[inverse]
    outs = (vals, index.astype(np.int64), inverse.ravel().astype(np.int64),
            counts.astype(np.int64))
    return outs if _is_host(x) else tuple(_to(np.ascontiguousarray(o), x.device) for o in outs)


# ---------------- losses ----------------
# (the reference's :1755-1796)

def _nll_core(log_prob, labels, weights, reduction, ignore_index):
    """NegativeLogLikelihoodLoss / SoftmaxCrossEntropyLoss: gather -log
    p[label], class weights, ``ignore_index`` masked, reduced (the weighted
    mean by default)."""
    labels = labels.long()
    valid = (torch.ones_like(labels, dtype=torch.bool) if ignore_index is None
             else labels != ignore_index)
    safe = torch.where(valid, labels, 0)
    picked = -torch.gather(log_prob, 1, safe.unsqueeze(1)).squeeze(1)
    w = (torch.ones(log_prob.shape[1], dtype=log_prob.dtype, device=log_prob.device)
         if weights is None else weights.to(log_prob.dtype))
    wl = w[safe] * valid.to(log_prob.dtype)
    loss = picked * wl
    reduction = _s(reduction)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.sum(loss) / torch.clamp_min(torch.sum(wl), 1e-9)


@op("NegativeLogLikelihoodLoss")
def _nll_loss(ins, attrs):
    return _nll_core(ins[0], ins[1], _opt(ins, 2), attrs.get("reduction", "mean"),
                     attrs.get("ignore_index"))


@op("SoftmaxCrossEntropyLoss")
def _softmax_ce_loss(ins, attrs):
    log_prob = torch.log_softmax(ins[0], dim=1)
    loss = _nll_core(log_prob, ins[1], _opt(ins, 2), attrs.get("reduction", "mean"),
                     attrs.get("ignore_index"))
    return loss, log_prob  # the second output is optional


# ---------------- signal ----------------
# (the reference's :1798-1882: a trailing dim of 1 is a real signal, of 2
# a complex one, re/im; the output is [..., 2] re/im)

def _re_im(spec):
    return torch.stack([spec.real, spec.imag], dim=-1)


@op("DFT", raw=(1,))
def _dft(ins, attrs):
    """The opset-17 DFT: axis, inverse and onesided as attributes, an
    optional ``dft_length`` input."""
    x = ins[0]
    inverse, onesided = bool(attrs.get("inverse", 0)), bool(attrs.get("onesided", 0))
    if inverse and onesided:
        raise NotImplementedError("DFT: inverse and onesided are exclusive")
    # the axis counts against the full rank, the component dim included
    axis = int(attrs.get("axis", 1)) % x.ndim
    if axis == x.ndim - 1:
        raise NotImplementedError("DFT axis must not be the trailing re/im component dimension")
    if x.shape[-1] == 2:
        if onesided:
            raise NotImplementedError("DFT: onesided=1 requires a real input (ORT rejects the "
                                      "complex combination too)")
        sig = torch.complex(x[..., 0], x[..., 1])
    elif x.shape[-1] == 1:
        sig = x[..., 0]
    else:
        raise NotImplementedError(f"DFT input trailing dim must be 1 (real) or 2 (complex), "
                                  f"got {x.shape[-1]}")
    if _opt(ins, 1) is not None:
        n, cur = _scalar_int(ins[1]), sig.shape[axis]
        if n < cur:
            sig = sig.narrow(axis, 0, n)
        elif n > cur:
            shape = list(sig.shape)
            shape[axis] = n - cur
            sig = torch.cat([sig, sig.new_zeros(shape)], dim=axis)
    fft = torch.fft.ifft if inverse else torch.fft.rfft if onesided else torch.fft.fft
    return _re_im(fft(sig, dim=axis))


@op("STFT", raw=(1, 3))
def _stft(ins, attrs):
    """The opset-17 STFT: frames of the signal, windowed, an FFT a frame;
    ``[B, frames, bins, 2]`` out."""
    signal, step, window = ins[0], _scalar_int(ins[1]), _opt(ins, 2)
    if _opt(ins, 3) is not None:
        frame_len = _scalar_int(ins[3])
    elif window is not None:
        frame_len = window.shape[0]
    else:
        raise NotImplementedError("STFT needs window or frame_length")
    if signal.ndim == 3:
        signal = (torch.complex(signal[..., 0], signal[..., 1]) if signal.shape[-1] == 2
                  else signal[..., 0])
    frames = signal.unfold(-1, frame_len, step)        # [B, frames, frame_len]
    if window is not None:
        frames = frames * window.to(frames.dtype)
    onesided = bool(attrs.get("onesided", 1))
    if onesided and frames.is_complex():
        raise NotImplementedError("STFT: onesided=1 requires a real input (ORT rejects the "
                                  "complex combination too)")
    return _re_im((torch.fft.rfft if onesided else torch.fft.fft)(frames, dim=-1))


# ---------------- random sampling ----------------
# (the reference's :1916-1994. torch cannot draw jax.random's bits: each
# node draws from its own torch.Generator on the call's device, seeded from
# the node's float `seed` (its float32 bits, as the reference keys its
# PRNGKey) or, unseeded, from a fixed base plus a process-wide counter of
# draws, so that two unseeded nodes, and two runs of one, decorrelate as
# ORT's independent draws do)

_UNSEEDED_DRAWS = itertools.count()
_UNSEEDED_BASE = 0x5EED_0000_0000


def _generator(attrs, device) -> torch.Generator:
    seed = attrs.get("seed")
    g = torch.Generator(device=device)
    if seed is not None:
        return g.manual_seed(int(np.float32(seed).view(np.uint32)))
    return g.manual_seed(_UNSEEDED_BASE + next(_UNSEEDED_DRAWS))


def _rand_dtype(attrs, default):
    return _TORCH_DTYPES[attrs["dtype"]] if "dtype" in attrs else default


def _like(x):
    """(shape, dtype, device) of a ``*Like`` op's input."""
    if _is_host(x):
        return tuple(x.shape), _torch_dtype(x.dtype), _device()
    return tuple(x.shape), x.dtype, x.device


def _normal(shape, dtype, device, attrs):
    x = torch.randn(shape, generator=_generator(attrs, device), dtype=dtype, device=device)
    return x * attrs.get("scale", 1.0) + attrs.get("mean", 0.0)


def _uniform(shape, dtype, device, attrs):
    low, high = attrs.get("low", 0.0), attrs.get("high", 1.0)
    x = torch.rand(shape, generator=_generator(attrs, device), dtype=dtype, device=device)
    return x * (high - low) + low


@op("RandomNormal", raw=True)
def _random_normal(ins, attrs):
    return _normal(tuple(int(s) for s in attrs["shape"]), _rand_dtype(attrs, torch.float32),
                   _device(), attrs)


@op("RandomUniform", raw=True)
def _random_uniform(ins, attrs):
    return _uniform(tuple(int(s) for s in attrs["shape"]), _rand_dtype(attrs, torch.float32),
                    _device(), attrs)


@op("RandomNormalLike", raw=True)
def _random_normal_like(ins, attrs):
    shape, dtype, device = _like(ins[0])
    return _normal(shape, _rand_dtype(attrs, dtype), device, attrs)


@op("RandomUniformLike", raw=True)
def _random_uniform_like(ins, attrs):
    shape, dtype, device = _like(ins[0])
    return _uniform(shape, _rand_dtype(attrs, dtype), device, attrs)


@op("Bernoulli")
def _bernoulli(ins, attrs):
    x = ins[0]
    out = torch.bernoulli(x.float(), generator=_generator(attrs, x.device))
    return out.to(_rand_dtype(attrs, x.dtype))


@op("Multinomial")
def _multinomial(ins, attrs):
    """Class indices drawn from unnormalized log probabilities (the spec's
    input), ``sample_size`` a row, with replacement."""
    x = ins[0]                                    # [batch, classes]
    probs = torch.softmax(x.float(), dim=-1)
    out = torch.multinomial(probs, int(attrs.get("sample_size", 1)), replacement=True,
                            generator=_generator(attrs, x.device))
    return out.to(_rand_dtype(attrs, torch.int32))


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


def _attr_value(a):
    if a.type == P.ATTR_TENSOR:
        return _tensor_value(a.t)
    if a.type == P.ATTR_GRAPH:
        return _Graph(a.g)
    return a.value


def _node_attrs(node) -> dict:
    return {a.name: _attr_value(a) for a in node.attribute}


class _Graph:
    """A graph decoded once: its nodes with their attributes (subgraphs in
    turn), its initializers, and its formal inputs and outputs; the
    initializers move to a device once for each device it runs on."""

    def __init__(self, g: P.GraphProto):
        # decoded once: re-decoding ~100 MB of ResNet-50 a call would cost
        # more than the call
        self.weights = {t.name: _tensor_value(t) for t in g.initializer}
        self.nodes = [(n, _node_attrs(n)) for n in g.node]
        self.inputs = [vi.name for vi in g.input]
        self.outputs = [vi.name for vi in g.output]
        self._on_device: dict[torch.device, dict] = {}

    def weights_on(self, device: torch.device) -> dict:
        """The initializers as graph values for ``device``: int64 ones host
        numpy (shape constants), the rest tensors moved there once."""
        env = self._on_device.get(device)
        if env is None:
            env = {k: v if _is_host(v) and v.dtype in (np.int64, np.uint64) else _to(v, device)
                   for k, v in self.weights.items()}
            self._on_device[device] = env
        return env


def _exec_nodes(nodes, env: dict, device: torch.device) -> None:
    """Run ``(node, attrs)`` pairs over ``env`` in place (the top-level
    graph and subgraphs, which read outer-scope names per ONNX scoping)."""
    token = _DEVICE.set(device)
    try:
        for node, attrs in nodes:
            ins = [env[i] if i else None for i in node.input]
            control = _CONTROL.get(node.op_type)
            if control is not None:
                out = control(ins, attrs, env, device)
            else:
                raw = _RAW[node.op_type]
                if raw is not True:
                    ins = [x if i in raw else _to(x, device) for i, x in enumerate(ins)]
                out = OP_REGISTRY[node.op_type](ins, attrs)
            for name, val in zip(node.output, out if isinstance(out, tuple) else (out,)):
                if name:
                    env[name] = val
    finally:
        _DEVICE.reset(token)


# ---------------- control flow ----------------
# (the reference's :2084-2349 in its eager form: every graph here runs
# eagerly, so the forms the reference refuses only under jax.jit, If
# branches of different shapes and a data-dependent early exit with scan
# outputs, run as its eager path runs them)

def _run_subgraph(body: _Graph, env: dict, bound: dict, device) -> list:
    """``body``'s outputs, in declaration order, run with ``bound`` formal
    inputs over a copy of the outer scope (read only) and its own
    initializers."""
    sub = dict(env)
    sub.update(body.weights_on(device))
    sub.update(bound)
    _exec_nodes(body.nodes, sub, device)
    return [sub[name] for name in body.outputs]


def _flag(v) -> bool:
    """A condition as a Python bool: a device value is read back (a sync)."""
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(-1)[0].item())
    return bool(np.asarray(v).reshape(-1)[0])


def _stack(rows):
    if all(_is_host(r) for r in rows):
        return np.stack([np.asarray(r) for r in rows])
    return torch.stack(_mix(rows, scalars=False))


def _empty_rows(template, device):
    """A zero-length scan output with ``template``'s row shape and dtype."""
    if _is_host(template):
        return np.zeros((0,) + np.shape(template), np.asarray(template).dtype)
    return torch.zeros((0,) + tuple(template.shape), dtype=template.dtype, device=device)


def _exec_if(ins, attrs, env, device):
    """ONNX If: the branch its condition names (a condition on the device
    is read back once)."""
    branch = attrs["then_branch"] if _flag(ins[0]) else attrs["else_branch"]
    return tuple(_run_subgraph(branch, env, {}, device))


def _exec_loop(ins, attrs, env, device):
    """ONNX Loop as an exact Python loop: the trip count ``M`` (read once),
    the condition (read back once an iteration when the body computes it on
    the device), early exit, scan outputs as long as the iterations run,
    zero-trip loops and torch's ``M = INT64_MAX`` while-loops."""
    body = attrs["body"]
    M, cond0 = ins[0], ins[1]
    states = list(ins[2:])
    n_state = len(states)
    n_scan_out = len(body.outputs) - 1 - n_state
    trips = None if M is None else _host(M).reshape(-1)
    max_trip = int(trips[0]) if trips is not None and trips.size else None
    keep = True if cond0 is None else _flag(cond0)

    def bound(i, keep, states):
        out = {body.inputs[0]: np.asarray(i, np.int64), body.inputs[1]: np.asarray(keep)}
        out.update(zip(body.inputs[2:], states))
        return out

    rows: list[list] = [[] for _ in range(n_scan_out)]
    i = 0
    while keep and (max_trip is None or i < max_trip):
        outs = _run_subgraph(body, env, bound(i, keep, states), device)
        keep = _flag(outs[0])
        states = outs[1:1 + n_state]
        for j in range(n_scan_out):
            rows[j].append(outs[1 + n_state + j])
        i += 1
    if n_scan_out and not rows[0]:
        # zero trips: each scan output's row shape and dtype from one
        # speculative run of the body (nothing of it is kept)
        try:
            templates = _run_subgraph(body, env, bound(0, True, states), device)[1 + n_state:]
        except Exception:  # noqa: BLE001 -- rank-1 empties, as the reference
            templates = [torch.zeros((), device=device)] * n_scan_out
        return tuple(states) + tuple(_empty_rows(t, device) for t in templates)
    return tuple(states) + tuple(_stack(r) for r in rows)


def _exec_scan(ins, attrs, env, device):
    """ONNX Scan: the body once a step over the scan inputs (sliced along
    ``scan_input_axes``, reversed by ``scan_input_directions``), the loop
    state carried in its first dtype, the per-step outputs stacked on
    ``scan_output_axes`` (reversed by ``scan_output_directions``)."""
    body = attrs["body"]
    n_scan = int(attrs["num_scan_inputs"])
    n_state = len(ins) - n_scan
    n_scan_out = len(body.outputs) - n_state
    in_axes = attrs.get("scan_input_axes") or [0] * n_scan
    in_dirs = attrs.get("scan_input_directions") or [0] * n_scan
    out_axes = attrs.get("scan_output_axes") or [0] * n_scan_out
    out_dirs = attrs.get("scan_output_directions") or [0] * n_scan_out
    states = [_to(s, device) for s in ins[:n_state]]
    xs = []
    for x, ax, d in zip(ins[n_state:], in_axes, in_dirs):
        x = _to(x, device).movedim(int(ax), 0)
        xs.append(x.flip(0) if d else x)
    rows: list[list] = [[] for _ in range(n_scan_out)]
    for t in range(xs[0].shape[0]):
        bound = dict(zip(body.inputs[:n_state], states))
        bound.update(zip(body.inputs[n_state:], (x[t] for x in xs)))
        outs = _run_subgraph(body, env, bound, device)
        states = [_to(o, device).to(s.dtype) for o, s in zip(outs[:n_state], states)]
        for j, o in enumerate(outs[n_state:]):
            rows[j].append(_to(o, device))
    outs = list(states)
    for r, ax, d in zip(rows, out_axes, out_dirs):
        y = torch.stack(r)
        outs.append((y.flip(0) if d else y).movedim(0, int(ax)))
    return tuple(outs)


_CONTROL = {"If": _exec_if, "Loop": _exec_loop, "Scan": _exec_scan}


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
        missing = sorted(o for o in _all_op_types(g) if o not in OP_REGISTRY and o not in _CONTROL)
        if missing:
            raise NotImplementedError(
                f"ONNX ops not supported by the converter: {missing} (supported: "
                f"{sorted(OP_REGISTRY)} and {sorted(_CONTROL)})")
        init_names = {t.name for t in g.initializer}
        self._graph = _Graph(g)
        self.weights = self._graph.weights
        self.input_names = [vi.name for vi in g.input if vi.name not in init_names]
        self.output_names = [vi.name for vi in g.output]
        self.input_shapes = {vi.name: tuple(vi.dims) for vi in g.input
                             if vi.name not in init_names}
        self.input_types = {vi.name: vi.elem_type for vi in g.input
                            if vi.name not in init_names}

    def weights_on(self, device) -> dict:
        """The initializers as graph values for ``device``: int64 ones host
        numpy (shape constants), the rest tensors moved there once."""
        return self._graph.weights_on(_resolved(device))

    def run(self, inputs: Mapping, device) -> dict:
        """The graph's outputs, as tensors on ``device``, for ``inputs``
        (numpy arrays or tensors, by model input name)."""
        device = _resolved(device)
        env = dict(self.weights_on(device))
        for name in self.input_names:
            if name not in inputs:
                raise KeyError(f"missing input {name!r}; expects {self.input_names}")
            env[name] = _to(inputs[name], device)
        _exec_nodes(self._graph.nodes, env, device)
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


# the com.microsoft contrib opset (ORT's transformer fusions) registers
# itself into OP_REGISTRY; imported last so that the registry exists
from . import contrib  # noqa: E402,F401  (registration side effect)
