"""Minimal ONNX protobuf wire codec (no `onnx` package dependency).

Counterpart of ``synapseml_tpu/onnx/proto.py``, a copy kept in this
package so that it never imports the JAX package: the same hand-rolled
varint / length-delimited reader and writer over the public, frozen
onnx.proto field numbers, the same dataclasses, and byte for byte the same
encoding. Only fields the converter consumes are modeled; unknown fields
are skipped on read and omitted on write.

One difference: numpy has no bfloat16 and this package does not depend on
``ml_dtypes``, so :func:`tensor_to_numpy` returns a BFLOAT16 tensor as its
uint16 bit patterns (the converter views them as ``torch.bfloat16``);
:func:`numpy_to_tensor` writes an array whose dtype is named ``bfloat16``
(``ml_dtypes``, where installed) as BFLOAT16.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator

import numpy as np

__all__ = ["ModelProto", "GraphProto", "NodeProto", "TensorProto",
           "AttributeProto", "ValueInfoProto", "OperatorSetId",
           "tensor_to_numpy", "numpy_to_tensor", "parse_model", "encode_model"]

# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
        elif wire == _WIRE_I64:
            v = buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        elif wire == _WIRE_I32:
            v = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
        yield field, wire, v


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _w_varint_field(out: bytearray, field: int, v: int) -> None:
    _tag(out, field, _WIRE_VARINT)
    _write_varint(out, v)


def _w_bytes_field(out: bytearray, field: int, data: bytes) -> None:
    _tag(out, field, _WIRE_LEN)
    _write_varint(out, len(data))
    out.extend(data)


def _w_str_field(out: bytearray, field: int, s: str) -> None:
    _w_bytes_field(out, field, s.encode("utf-8"))


def _unpack_packed(buf: bytes, fmt: str, size: int) -> list:
    return [struct.unpack_from(f"<{fmt}", buf, i)[0] for i in range(0, len(buf), size)]


def _unpack_packed_varints(buf: bytes) -> list[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_signed(v))
    return out


# ---------------------------------------------------------------------------
# messages (onnx.proto field numbers)
# ---------------------------------------------------------------------------

# TensorProto.DataType
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = 1, 2, 3, 4, 5, 6, 7, 8, 9
FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
BFLOAT16 = 16

_DTYPE_TO_NP = {
    FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8, UINT16: np.uint16,
    INT16: np.int16, INT32: np.int32, INT64: np.int64, BOOL: np.bool_,
    FLOAT16: np.float16, DOUBLE: np.float64, UINT32: np.uint32, UINT64: np.uint64,
    BFLOAT16: np.uint16,  # bit patterns: numpy has no bfloat16
}
_NP_TO_DTYPE = {np.dtype(v): k for k, v in _DTYPE_TO_NP.items() if k != BFLOAT16}


@dataclasses.dataclass
class TensorProto:
    dims: list = dataclasses.field(default_factory=list)          # field 1
    data_type: int = FLOAT                                        # field 2
    float_data: list = dataclasses.field(default_factory=list)    # field 4
    int32_data: list = dataclasses.field(default_factory=list)    # field 5
    int64_data: list = dataclasses.field(default_factory=list)    # field 7
    name: str = ""                                                # field 8
    raw_data: bytes = b""                                         # field 9
    double_data: list = dataclasses.field(default_factory=list)   # field 10

    @staticmethod
    def parse(buf: bytes) -> "TensorProto":
        t = TensorProto()
        for field, wire, v in _fields(buf):
            if field == 1:
                if wire == _WIRE_LEN:
                    t.dims.extend(_unpack_packed_varints(v))
                else:
                    t.dims.append(_signed(v))
            elif field == 2:
                t.data_type = v
            elif field == 4:
                t.float_data.extend(_unpack_packed(v, "f", 4) if wire == _WIRE_LEN
                                    else [struct.unpack("<f", v)[0]])
            elif field == 5:
                t.int32_data.extend(_unpack_packed_varints(v) if wire == _WIRE_LEN
                                    else [_signed(v)])
            elif field == 7:
                t.int64_data.extend(_unpack_packed_varints(v) if wire == _WIRE_LEN
                                    else [_signed(v)])
            elif field == 8:
                t.name = v.decode("utf-8")
            elif field == 9:
                t.raw_data = bytes(v)
            elif field == 10:
                t.double_data.extend(_unpack_packed(v, "d", 8) if wire == _WIRE_LEN
                                     else [struct.unpack("<d", v)[0]])
        return t

    def encode(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            _w_varint_field(out, 1, d)
        _w_varint_field(out, 2, self.data_type)
        for f in self.float_data:
            _tag(out, 4, _WIRE_I32)
            out.extend(struct.pack("<f", f))
        for i in self.int32_data:
            _w_varint_field(out, 5, i)
        for i in self.int64_data:
            _w_varint_field(out, 7, i)
        if self.name:
            _w_str_field(out, 8, self.name)
        if self.raw_data:
            _w_bytes_field(out, 9, self.raw_data)
        for d in self.double_data:
            _tag(out, 10, _WIRE_I64)
            out.extend(struct.pack("<d", d))
        return bytes(out)


def tensor_to_numpy(t: TensorProto) -> np.ndarray:
    """The tensor as a numpy array; BFLOAT16 as its uint16 bit patterns."""
    np_dtype = _DTYPE_TO_NP.get(t.data_type)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor data_type {t.data_type} ({t.name})")
    shape = tuple(t.dims)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=np_dtype)
    elif t.float_data:
        arr = np.asarray(t.float_data, dtype=np_dtype)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, dtype=np_dtype)
    elif t.int32_data:
        if t.data_type in (FLOAT16, BFLOAT16):
            # ONNX stores fp16/bf16 in int32_data as uint16 bit patterns
            arr = np.asarray(t.int32_data, dtype=np.uint16).view(np_dtype)
        else:
            arr = np.asarray(t.int32_data, dtype=np_dtype)
    elif t.double_data:
        arr = np.asarray(t.double_data, dtype=np_dtype)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 1, dtype=np_dtype)
    return arr.reshape(shape)


def numpy_to_tensor(arr: np.ndarray, name: str = "") -> TensorProto:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array, written as its bits
        return TensorProto(dims=list(arr.shape), data_type=BFLOAT16, name=name,
                           raw_data=arr.view(np.uint16).tobytes())
    dt = _NP_TO_DTYPE.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    return TensorProto(dims=list(arr.shape), data_type=dt, name=name,
                       raw_data=arr.tobytes())


# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


@dataclasses.dataclass
class AttributeProto:
    name: str = ""                                                # 1
    f: float = 0.0                                                # 2
    i: int = 0                                                    # 3
    s: bytes = b""                                                # 4
    t: TensorProto | None = None                                  # 5
    g: "GraphProto | None" = None                                 # 6
    floats: list = dataclasses.field(default_factory=list)        # 7
    ints: list = dataclasses.field(default_factory=list)          # 8
    strings: list = dataclasses.field(default_factory=list)       # 9
    type: int = 0                                                 # 20

    @property
    def value(self):
        if self.type == ATTR_FLOAT:
            return self.f
        if self.type == ATTR_INT:
            return self.i
        if self.type == ATTR_STRING:
            return self.s.decode("utf-8", "replace")
        if self.type == ATTR_TENSOR:
            return tensor_to_numpy(self.t)
        if self.type == ATTR_FLOATS:
            return list(self.floats)
        if self.type == ATTR_INTS:
            return list(self.ints)
        if self.type == ATTR_STRINGS:
            return [s.decode("utf-8", "replace") for s in self.strings]
        if self.type == ATTR_GRAPH:
            return self.g
        return None

    @staticmethod
    def parse(buf: bytes) -> "AttributeProto":
        a = AttributeProto()
        for field, wire, v in _fields(buf):
            if field == 1:
                a.name = v.decode("utf-8")
            elif field == 2:
                a.f = struct.unpack("<f", v)[0]
            elif field == 3:
                a.i = _signed(v)
            elif field == 4:
                a.s = bytes(v)
            elif field == 5:
                a.t = TensorProto.parse(v)
            elif field == 6:
                a.g = GraphProto.parse(v)
            elif field == 7:
                a.floats.extend(_unpack_packed(v, "f", 4) if wire == _WIRE_LEN
                                else [struct.unpack("<f", v)[0]])
            elif field == 8:
                a.ints.extend(_unpack_packed_varints(v) if wire == _WIRE_LEN
                              else [_signed(v)])
            elif field == 9:
                a.strings.append(bytes(v))
            elif field == 20:
                a.type = v
        return a

    def encode(self) -> bytes:
        out = bytearray()
        _w_str_field(out, 1, self.name)
        if self.type == ATTR_FLOAT:
            _tag(out, 2, _WIRE_I32)
            out.extend(struct.pack("<f", self.f))
        elif self.type == ATTR_INT:
            _w_varint_field(out, 3, self.i)
        elif self.type == ATTR_STRING:
            _w_bytes_field(out, 4, self.s)
        elif self.type == ATTR_TENSOR:
            _w_bytes_field(out, 5, self.t.encode())
        elif self.type == ATTR_GRAPH:
            _w_bytes_field(out, 6, self.g.encode())
        elif self.type == ATTR_FLOATS:
            for f in self.floats:
                _tag(out, 7, _WIRE_I32)
                out.extend(struct.pack("<f", f))
        elif self.type == ATTR_INTS:
            for i in self.ints:
                _w_varint_field(out, 8, i)
        elif self.type == ATTR_STRINGS:
            for s in self.strings:
                _w_bytes_field(out, 9, s)
        _w_varint_field(out, 20, self.type)
        return bytes(out)

    # convenience constructors
    @staticmethod
    def make(name: str, value) -> "AttributeProto":
        a = AttributeProto(name=name)
        if isinstance(value, bool):
            a.type, a.i = ATTR_INT, int(value)
        elif isinstance(value, int):
            a.type, a.i = ATTR_INT, value
        elif isinstance(value, float):
            a.type, a.f = ATTR_FLOAT, value
        elif isinstance(value, str):
            a.type, a.s = ATTR_STRING, value.encode("utf-8")
        elif isinstance(value, np.ndarray):
            a.type, a.t = ATTR_TENSOR, numpy_to_tensor(value)
        elif isinstance(value, GraphProto):
            a.type, a.g = ATTR_GRAPH, value
        elif isinstance(value, (list, tuple)):
            if all(isinstance(x, int) for x in value):
                a.type, a.ints = ATTR_INTS, list(value)
            elif all(isinstance(x, (int, float)) for x in value):
                a.type, a.floats = ATTR_FLOATS, [float(x) for x in value]
            elif all(isinstance(x, str) for x in value):
                a.type, a.strings = ATTR_STRINGS, [x.encode() for x in value]
            else:
                raise ValueError(f"unsupported attribute list {value!r}")
        else:
            raise ValueError(f"unsupported attribute value {value!r}")
        return a


@dataclasses.dataclass
class NodeProto:
    input: list = dataclasses.field(default_factory=list)         # 1
    output: list = dataclasses.field(default_factory=list)        # 2
    name: str = ""                                                # 3
    op_type: str = ""                                             # 4
    attribute: list = dataclasses.field(default_factory=list)     # 5
    domain: str = ""                                              # 7

    def attrs(self) -> dict:
        return {a.name: a.value for a in self.attribute}

    @staticmethod
    def parse(buf: bytes) -> "NodeProto":
        n = NodeProto()
        for field, _, v in _fields(buf):
            if field == 1:
                n.input.append(v.decode("utf-8"))
            elif field == 2:
                n.output.append(v.decode("utf-8"))
            elif field == 3:
                n.name = v.decode("utf-8")
            elif field == 4:
                n.op_type = v.decode("utf-8")
            elif field == 5:
                n.attribute.append(AttributeProto.parse(v))
            elif field == 7:
                n.domain = v.decode("utf-8")
        return n

    def encode(self) -> bytes:
        out = bytearray()
        for s in self.input:
            _w_str_field(out, 1, s)
        for s in self.output:
            _w_str_field(out, 2, s)
        if self.name:
            _w_str_field(out, 3, self.name)
        _w_str_field(out, 4, self.op_type)
        for a in self.attribute:
            _w_bytes_field(out, 5, a.encode())
        if self.domain:
            _w_str_field(out, 7, self.domain)
        return bytes(out)


@dataclasses.dataclass
class ValueInfoProto:
    """name (1) + TypeProto (2) -> tensor_type (1) -> elem_type (1), shape (2)."""

    name: str = ""
    elem_type: int = FLOAT
    dims: list = dataclasses.field(default_factory=list)  # ints or str dim_params

    @staticmethod
    def parse(buf: bytes) -> "ValueInfoProto":
        vi = ValueInfoProto()
        for field, _, v in _fields(buf):
            if field == 1:
                vi.name = v.decode("utf-8")
            elif field == 2:  # TypeProto
                for f2, _, v2 in _fields(v):
                    if f2 == 1:  # tensor_type
                        for f3, _, v3 in _fields(v2):
                            if f3 == 1:
                                vi.elem_type = v3
                            elif f3 == 2:  # TensorShapeProto
                                for f4, _, v4 in _fields(v3):
                                    if f4 == 1:  # Dimension
                                        dim = None
                                        for f5, _, v5 in _fields(v4):
                                            if f5 == 1:
                                                dim = _signed(v5)
                                            elif f5 == 2:
                                                dim = v5.decode("utf-8")
                                        vi.dims.append(dim)
        return vi

    def encode(self) -> bytes:
        shape = bytearray()
        for d in self.dims:
            dim = bytearray()
            if isinstance(d, str):
                _w_str_field(dim, 2, d)
            elif d is not None:
                _w_varint_field(dim, 1, d)
            _w_bytes_field(shape, 1, bytes(dim))
        tt = bytearray()
        _w_varint_field(tt, 1, self.elem_type)
        _w_bytes_field(tt, 2, bytes(shape))
        tp = bytearray()
        _w_bytes_field(tp, 1, bytes(tt))
        out = bytearray()
        _w_str_field(out, 1, self.name)
        _w_bytes_field(out, 2, bytes(tp))
        return bytes(out)


@dataclasses.dataclass
class GraphProto:
    node: list = dataclasses.field(default_factory=list)          # 1
    name: str = ""                                                # 2
    initializer: list = dataclasses.field(default_factory=list)   # 5
    input: list = dataclasses.field(default_factory=list)         # 11
    output: list = dataclasses.field(default_factory=list)        # 12
    value_info: list = dataclasses.field(default_factory=list)    # 13

    @staticmethod
    def parse(buf: bytes) -> "GraphProto":
        g = GraphProto()
        for field, _, v in _fields(buf):
            if field == 1:
                g.node.append(NodeProto.parse(v))
            elif field == 2:
                g.name = v.decode("utf-8")
            elif field == 5:
                g.initializer.append(TensorProto.parse(v))
            elif field == 11:
                g.input.append(ValueInfoProto.parse(v))
            elif field == 12:
                g.output.append(ValueInfoProto.parse(v))
            elif field == 13:
                g.value_info.append(ValueInfoProto.parse(v))
        return g

    def encode(self) -> bytes:
        out = bytearray()
        for n in self.node:
            _w_bytes_field(out, 1, n.encode())
        if self.name:
            _w_str_field(out, 2, self.name)
        for t in self.initializer:
            _w_bytes_field(out, 5, t.encode())
        for vi in self.input:
            _w_bytes_field(out, 11, vi.encode())
        for vi in self.output:
            _w_bytes_field(out, 12, vi.encode())
        for vi in self.value_info:
            _w_bytes_field(out, 13, vi.encode())
        return bytes(out)


@dataclasses.dataclass
class OperatorSetId:
    domain: str = ""   # 1
    version: int = 0   # 2

    @staticmethod
    def parse(buf: bytes) -> "OperatorSetId":
        o = OperatorSetId()
        for field, _, v in _fields(buf):
            if field == 1:
                o.domain = v.decode("utf-8")
            elif field == 2:
                o.version = _signed(v)
        return o

    def encode(self) -> bytes:
        out = bytearray()
        if self.domain:
            _w_str_field(out, 1, self.domain)
        _w_varint_field(out, 2, self.version)
        return bytes(out)


@dataclasses.dataclass
class ModelProto:
    ir_version: int = 8                                           # 1
    producer_name: str = ""                                       # 2
    graph: GraphProto = dataclasses.field(default_factory=GraphProto)  # 7
    opset_import: list = dataclasses.field(default_factory=list)  # 8

    @staticmethod
    def parse(buf: bytes) -> "ModelProto":
        m = ModelProto()
        for field, _, v in _fields(buf):
            if field == 1:
                m.ir_version = _signed(v)
            elif field == 2:
                m.producer_name = v.decode("utf-8")
            elif field == 7:
                m.graph = GraphProto.parse(v)
            elif field == 8:
                m.opset_import.append(OperatorSetId.parse(v))
        return m

    def encode(self) -> bytes:
        out = bytearray()
        _w_varint_field(out, 1, self.ir_version)
        if self.producer_name:
            _w_str_field(out, 2, self.producer_name)
        _w_bytes_field(out, 7, self.graph.encode())
        for o in self.opset_import or [OperatorSetId(version=17)]:
            _w_bytes_field(out, 8, o.encode())
        return bytes(out)


def parse_model(data: bytes) -> ModelProto:
    return ModelProto.parse(data)


def encode_model(model: ModelProto) -> bytes:
    return model.encode()
