"""Minimal ONNX protobuf codec — writer and reader, zero dependencies.

A copy of the JAX package's framework-free ``tpuseg/export/onnx_proto.py``
(the port imports nothing of that package), so that both exporters write
the same bytes. The deployment artifact is an ONNX opset-12 graph with a
dynamic batch axis; neither the ``onnx`` package nor onnxruntime is
needed: a dozen message schemas (ModelProto, GraphProto, NodeProto,
TensorProto, ...) are hand-encoded per the protobuf encoding spec (varint /
64-bit / length-delimited / 32-bit wire types).

The reader half parses the same subset back into plain dicts so the export
self-check can round-trip the file without onnx installed: parse -> walk
the graph -> execute with ``tpuseg_torch.export.onnx_run`` -> compare
against the live model.

Only the fields the exporter emits are supported; unknown fields are
preserved by the generic parser (they land in the raw field map) but have
no typed view. ``producer_name`` stays "tpuseg", the JAX exporter's.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------
# ONNX enum constants (onnx.proto)

# TensorProto.DataType
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

NUMPY_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}
ONNX_TO_NUMPY = {v: k for k, v in NUMPY_TO_ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8

# --------------------------------------------------------------------------
# Wire-format writer primitives


def _varint(n: int) -> bytes:
    """Unsigned LEB128. Negative int64 values use the 10-byte two's
    complement form, per the protobuf spec."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_int(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(value))


def _f_bytes(field: int, value: Union[bytes, str]) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _key(field, 2) + _varint(len(value)) + value


def _f_packed_ints(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return _key(field, 2) + _varint(len(payload)) + payload


def _f_packed_floats(field: int, values: Sequence[float]) -> bytes:
    payload = struct.pack(f"<{len(values)}f", *[float(v) for v in values])
    return _key(field, 2) + _varint(len(payload)) + payload


# --------------------------------------------------------------------------
# Message builders (field numbers from onnx.proto)


def tensor_proto(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    # np.asarray, NOT ascontiguousarray: the latter silently promotes 0-d
    # scalars to shape (1,), which would serialize Clip's min/max as 1-d
    # tensors where the ONNX spec requires scalars. tobytes() below copies
    # in C order regardless of the input's contiguity.
    array = np.asarray(array)
    if array.dtype not in NUMPY_TO_ONNX:
        raise TypeError(f"unsupported initializer dtype {array.dtype}")
    out = bytearray()
    for d in array.shape:
        out += _f_int(1, d)
    out += _f_int(2, NUMPY_TO_ONNX[array.dtype])
    out += _f_bytes(8, name)
    # little-endian raw bytes — the portable encoding onnx itself prefers
    out += _f_bytes(9, array.astype(array.dtype.newbyteorder("<")).tobytes())
    return bytes(out)


def attribute_proto(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    out = bytearray(_f_bytes(1, name))
    if isinstance(value, bool):
        raise TypeError("ONNX has no bool attribute; use int")
    if isinstance(value, int):
        out += _f_int(3, value) + _f_int(20, ATTR_INT)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_int(20, ATTR_FLOAT)
    elif isinstance(value, (str, bytes)):
        out += _f_bytes(4, value) + _f_int(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, tensor_proto("", value)) + _f_int(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        # ONNX writes repeated attr fields unpacked, but packed is also
        # legal proto3; readers (incl. ours) accept both
        out += _f_packed_floats(7, value) + _f_int(20, ATTR_FLOATS)
    elif isinstance(value, (list, tuple)):
        out += _f_packed_ints(8, [int(v) for v in value]) + _f_int(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attribute type {type(value)}")
    return bytes(out)


def node_proto(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    **attrs: Any,
) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = bytearray()
    for i in inputs:
        out += _f_bytes(1, i)
    for o in outputs:
        out += _f_bytes(2, o)
    if name:
        out += _f_bytes(3, name)
    out += _f_bytes(4, op_type)
    for k, v in attrs.items():
        out += _f_bytes(5, attribute_proto(k, v))
    return bytes(out)


def value_info_proto(
    name: str, elem_type: int, dims: Sequence[Union[int, str]]
) -> bytes:
    """ValueInfoProto{name=1, type=2} / TypeProto{tensor_type=1} /
    Tensor{elem_type=1, shape=2} / TensorShapeProto{dim=1} /
    Dimension{dim_value=1 | dim_param=2}."""
    shape = bytearray()
    for d in dims:
        if isinstance(d, str):
            dim = _f_bytes(2, d)
        else:
            dim = _f_int(1, int(d))
        shape += _f_bytes(1, dim)
    tensor = _f_int(1, elem_type) + _f_bytes(2, bytes(shape))
    type_proto = _f_bytes(1, tensor)
    return _f_bytes(1, name) + _f_bytes(2, type_proto)


def graph_proto(
    nodes: Sequence[bytes],
    name: str,
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
    initializers: Sequence[bytes],
) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = bytearray()
    for n in nodes:
        out += _f_bytes(1, n)
    out += _f_bytes(2, name)
    for t in initializers:
        out += _f_bytes(5, t)
    for i in inputs:
        out += _f_bytes(11, i)
    for o in outputs:
        out += _f_bytes(12, o)
    return bytes(out)


def model_proto(
    graph: bytes,
    opset_version: int = 12,
    ir_version: int = 7,
    producer_name: str = "tpuseg",
    producer_version: str = "1.0",
) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    graph=7, opset_import=8 (OperatorSetIdProto{domain=1, version=2})."""
    opset = _f_bytes(1, "") + _f_int(2, opset_version)
    out = bytearray()
    out += _f_int(1, ir_version)
    out += _f_bytes(2, producer_name)
    out += _f_bytes(3, producer_version)
    out += _f_bytes(7, graph)
    out += _f_bytes(8, opset)
    return bytes(out)


# --------------------------------------------------------------------------
# Wire-format reader


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_fields(data: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Generic protobuf message parse: field -> [(wire_type, raw value)]."""
    fields: Dict[int, List[Tuple[int, Any]]] = {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value = data[pos : pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire == 5:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append((wire, value))
    return fields


def _one_int(fields, field: int, default: int = 0) -> int:
    return fields[field][0][1] if field in fields else default


def _one_str(fields, field: int, default: str = "") -> str:
    return fields[field][0][1].decode("utf-8") if field in fields else default


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_packed_ints(entries) -> List[int]:
    out: List[int] = []
    for wire, value in entries:
        if wire == 0:
            out.append(_signed64(value))
        else:  # packed
            pos = 0
            while pos < len(value):
                v, pos = _read_varint(value, pos)
                out.append(_signed64(v))
    return out


def parse_tensor(data: bytes) -> Tuple[str, np.ndarray]:
    f = parse_fields(data)
    dims = _parse_packed_ints(f.get(1, []))
    data_type = _one_int(f, 2, FLOAT)
    name = _one_str(f, 8)
    dtype = ONNX_TO_NUMPY[data_type]
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0][1], dtype=dtype.newbyteorder("<"))
        arr = arr.astype(dtype)
    elif 4 in f and data_type == FLOAT:  # float_data
        floats: List[float] = []
        for wire, value in f[4]:
            if wire == 5:
                floats.append(struct.unpack("<f", value)[0])
            else:
                floats.extend(
                    struct.unpack(f"<{len(value) // 4}f", value)
                )
        arr = np.asarray(floats, np.float32)
    elif 7 in f and data_type == INT64:  # int64_data
        arr = np.asarray(_parse_packed_ints(f[7]), np.int64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims)


def parse_attribute(data: bytes) -> Tuple[str, Any]:
    f = parse_fields(data)
    name = _one_str(f, 1)
    atype = _one_int(f, 20)
    if atype == ATTR_INT:
        return name, _signed64(_one_int(f, 3))
    if atype == ATTR_FLOAT:
        return name, struct.unpack("<f", f[2][0][1])[0]
    if atype == ATTR_STRING:
        return name, f[4][0][1].decode("utf-8")
    if atype == ATTR_TENSOR:
        return name, parse_tensor(f[5][0][1])[1]
    if atype == ATTR_INTS:
        return name, _parse_packed_ints(f.get(8, []))
    if atype == ATTR_FLOATS:
        floats: List[float] = []
        for wire, value in f.get(7, []):
            if wire == 5:
                floats.append(struct.unpack("<f", value)[0])
            else:
                floats.extend(struct.unpack(f"<{len(value) // 4}f", value))
        return name, floats
    raise ValueError(f"unsupported attribute type {atype} for {name!r}")


def parse_value_info(data: bytes) -> Dict[str, Any]:
    f = parse_fields(data)
    name = _one_str(f, 1)
    elem_type, dims = None, []
    if 2 in f:
        tp = parse_fields(f[2][0][1])
        if 1 in tp:  # tensor_type
            tt = parse_fields(tp[1][0][1])
            elem_type = _one_int(tt, 1)
            if 2 in tt:
                shape = parse_fields(tt[2][0][1])
                for _, dim_bytes in shape.get(1, []):
                    d = parse_fields(dim_bytes)
                    if 2 in d:
                        dims.append(d[2][0][1].decode("utf-8"))
                    else:
                        dims.append(_one_int(d, 1))
    return {"name": name, "elem_type": elem_type, "dims": dims}


def parse_node(data: bytes) -> Dict[str, Any]:
    f = parse_fields(data)
    return {
        "input": [v.decode("utf-8") for _, v in f.get(1, [])],
        "output": [v.decode("utf-8") for _, v in f.get(2, [])],
        "name": _one_str(f, 3),
        "op_type": _one_str(f, 4),
        "attrs": dict(parse_attribute(v) for _, v in f.get(5, [])),
    }


def parse_graph(data: bytes) -> Dict[str, Any]:
    f = parse_fields(data)
    return {
        "name": _one_str(f, 2),
        "nodes": [parse_node(v) for _, v in f.get(1, [])],
        "initializers": dict(parse_tensor(v) for _, v in f.get(5, [])),
        "inputs": [parse_value_info(v) for _, v in f.get(11, [])],
        "outputs": [parse_value_info(v) for _, v in f.get(12, [])],
    }


def parse_model(data: bytes) -> Dict[str, Any]:
    f = parse_fields(data)
    opsets = []
    for _, v in f.get(8, []):
        op = parse_fields(v)
        opsets.append(
            {"domain": _one_str(op, 1), "version": _one_int(op, 2)}
        )
    return {
        "ir_version": _one_int(f, 1),
        "producer_name": _one_str(f, 2),
        "producer_version": _one_str(f, 3),
        "graph": parse_graph(f[7][0][1]),
        "opset_import": opsets,
    }
