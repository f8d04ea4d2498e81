"""SavedModel and TFLite export of the port's models.

The port of ``tpuseg/export/tf_export.py``, with its API: ``export_savedmodel``,
``export_tflite``, ``run_savedmodel`` and ``run_tflite``. The JAX package
converts its jitted forward with ``jax2tf``; the port has no such
converter, so the TF function is built from the port's own ONNX graph
(``export/onnx_export.py``, the JAX exporter's bytes) with BatchNorm
folded first, as the JAX export folds it (``make_serving_fn``): the graph
is parsed back (``onnx_proto.parse_model``) and each node lowered to the
TF op that computes it, in NHWC, the layout TF's CPU convolutions take.
So the TF function takes ``input`` [b, H, W, 3] float32 and returns NHWC
logits, the JAX artifact's signature.

    Conv                 tf.nn.conv2d / tf.nn.depthwise_conv2d (group ==
                         channels), explicit pads by tf.pad
    BatchNormalization   (x - mean) * factor + bias, the factor
                         scale / sqrt(var + eps) in float64, rounded once
                         (an identity after folding: x + shift)
    Relu / Clip          tf.nn.relu / tf.clip_by_value
    Add / Concat         tf.add / tf.concat (the NCHW axis moved to NHWC)
    MaxPool              tf.nn.max_pool2d
    GlobalAveragePool    tf.reduce_mean over H and W
    Resize               separable gathers with constant indices and
                         fractions from ``onnx_run._linear_coords`` (linear:
                         align_corners and pytorch_half_pixel) or floor
                         indices (nearest, asymmetric), so the coordinates
                         are ``onnx_run.run_model``'s
    Identity             the output

The graph computes in float32 from the folded float32 weights. A model
with ``compute_dtype="bfloat16"`` therefore exports its float32 function,
where the JAX SavedModel of such a model rounds where the model casts:
the two agree within bf16's rounding, not float32's, and ``convert``
checks the artifact against the model's fp32 compute (ROADMAP.md C19).
``batch=-1`` gives the SavedModel a polymorphic
batch and TFLite batch 1; ``dtype="float16"`` stores TFLite's weights in
float16 (the converter's weight quantization), ``"bfloat16"`` is refused.
The ONNX exporter's size contract holds: H and W multiples of 32 for the
MobileNetV2 families and 8 for the UNet.

TensorFlow is imported inside these functions only; a host without it
raises ImportError naming it.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch

from tpuseg_torch.export.onnx_run import _linear_coords

# the axis of an NHWC tensor that holds NCHW's axis i
_NHWC_AXIS = {0: 0, 1: 3, 2: 1, 3: 2}


def _tf():
    try:
        import tensorflow as tf  # lazy: only export paths need TF
    except ImportError as e:
        raise ImportError(
            f"SavedModel/TFLite export needs TensorFlow, which does not import here ({e})"
        ) from e
    return tf


def _graph(model, state_dict: Mapping[str, torch.Tensor], height: int, width: int) -> dict:
    """The parsed ONNX graph of ``model`` with BatchNorm folded."""
    from tpuseg_torch.export.onnx_export import export_onnx
    from tpuseg_torch.export.onnx_proto import parse_model
    from tpuseg_torch.export.quantize import fold_batchnorm

    state = fold_batchnorm({k: v.float() if v.is_floating_point() else v
                            for k, v in state_dict.items()})
    return parse_model(export_onnx(model, state, height, width))["graph"]


def _conv(tf, consts, node) -> Callable:
    attrs = node["attrs"]
    w = consts[node["input"][1]]                      # OIHW
    b = consts[node["input"][2]] if len(node["input"]) > 2 else None
    top, left, bottom, right = attrs.get("pads", [0, 0, 0, 0])
    strides = [1, *attrs.get("strides", [1, 1]), 1]
    dilations = list(attrs.get("dilations", [1, 1]))
    group = int(attrs.get("group", 1))
    if group == 1:
        kernel = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        conv = lambda x: tf.nn.conv2d(x, kernel, strides, "VALID", dilations=dilations)
    elif w.shape[1] == 1 and group == w.shape[0]:
        kernel = np.ascontiguousarray(w.transpose(2, 3, 0, 1))   # (kh, kw, C, 1)
        conv = lambda x: tf.nn.depthwise_conv2d(x, kernel, strides, "VALID",
                                                dilations=dilations)
    else:
        raise NotImplementedError(f"Conv {node['name']}: group {group} is not depthwise")

    def run(x):
        if top or left or bottom or right:
            x = tf.pad(x, [[0, 0], [top, bottom], [left, right], [0, 0]])
        y = conv(x)
        return y if b is None else tf.nn.bias_add(y, b)

    return run


def _batch_norm(consts, node) -> Callable:
    scale, bias, mean, var = (consts[i] for i in node["input"][1:5])
    eps = node["attrs"].get("epsilon", 1e-5)
    factor = (scale.astype(np.float64) * (1.0 / np.sqrt(var.astype(np.float64) + eps))
              ).astype(np.float32)
    # skip the steps that are identities (every BatchNorm after folding)
    center = bool(mean.any())
    rescale = not bool((factor == 1.0).all())

    def run(x):
        if center:
            x = x - mean
        if rescale:
            x = x * factor
        return x + bias

    return run


def _resize(tf, consts, node) -> Callable:
    attrs = node["attrs"]
    scales = consts[node["input"][2]].astype(np.float64).tolist()
    if not scales[0] == scales[1] == 1.0:
        raise NotImplementedError("batch/channel Resize scales must be 1")
    coord = attrs.get("coordinate_transformation_mode", "half_pixel")
    mode = attrs.get("mode", "nearest")
    if mode == "nearest" and (coord != "asymmetric" or attrs.get("nearest_mode") != "floor"):
        raise NotImplementedError("only asymmetric/floor nearest Resize is emitted")
    if mode not in ("nearest", "linear"):
        raise NotImplementedError(f"Resize mode {mode!r}")

    def run(x):
        # H and W are static (only the batch is polymorphic): the indices
        # and fractions are constants of the traced graph
        h, w = int(x.shape[1]), int(x.shape[2])
        oh, ow = int(round(h * scales[2])), int(round(w * scales[3]))
        if mode == "nearest":
            rows = np.clip(np.floor(np.arange(oh) / scales[2]), 0, h - 1).astype(np.int32)
            cols = np.clip(np.floor(np.arange(ow) / scales[3]), 0, w - 1).astype(np.int32)
            return tf.gather(tf.gather(x, rows, axis=1), cols, axis=2)
        r0, r1, rf = _linear_coords(oh, h, scales[2], coord)
        c0, c1, cf = _linear_coords(ow, w, scales[3], coord)
        rf, cf = rf.reshape(1, -1, 1, 1), cf.reshape(1, 1, -1, 1)
        # rows then columns, each tap blended in float32 as onnx_run does
        x = (tf.gather(x, r0.astype(np.int32), axis=1) * (np.float32(1.0) - rf)
             + tf.gather(x, r1.astype(np.int32), axis=1) * rf)
        return (tf.gather(x, c0.astype(np.int32), axis=2) * (np.float32(1.0) - cf)
                + tf.gather(x, c1.astype(np.int32), axis=2) * cf)

    return run


def _lower(tf, graph: dict) -> Callable:
    """``graph`` as a function of NHWC TF tensors: each node becomes a
    closure over its constants, built once; ``fn(x)`` chains them."""
    consts: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in graph["initializers"].items()}
    (inp,) = graph["inputs"]
    (out,) = graph["outputs"]
    steps: List[tuple] = []
    for node in graph["nodes"]:
        op, ins, attrs = node["op_type"], node["input"], node["attrs"]
        args = ins[:1]
        if op == "Conv":
            fn = _conv(tf, consts, node)
        elif op == "BatchNormalization":
            fn = _batch_norm(consts, node)
        elif op == "Relu":
            fn = tf.nn.relu
        elif op == "Clip":
            lo, hi = float(consts[ins[1]]), float(consts[ins[2]])
            fn = lambda x, lo=lo, hi=hi: tf.clip_by_value(x, lo, hi)
        elif op == "Add":
            fn, args = tf.add, ins
        elif op == "Concat":
            axis = _NHWC_AXIS[int(attrs["axis"])]
            fn, args = (lambda *xs, axis=axis: tf.concat(list(xs), axis)), ins
        elif op == "MaxPool":
            k = list(attrs["kernel_shape"])
            s = list(attrs.get("strides", k))
            fn = lambda x, k=k, s=s: tf.nn.max_pool2d(x, k, s, "VALID")
        elif op == "GlobalAveragePool":
            fn = lambda x: tf.reduce_mean(x, axis=[1, 2], keepdims=True)
        elif op == "Resize":
            fn = _resize(tf, consts, node)
        elif op == "Identity":
            fn = tf.identity
        else:
            raise NotImplementedError(f"op {op!r}")
        steps.append((fn, args, node["output"][0]))

    def fn(x):
        env = {inp["name"]: x}
        for step, args, name in steps:
            env[name] = step(*(env[a] for a in args))
        return env[out["name"]]

    return fn


def _tf_fn(model, state_dict, height: int, width: int, batch: int):
    tf = _tf()
    fn = _lower(tf, _graph(model, state_dict, height, width))
    bdim = None if batch == -1 else batch
    return tf.function(
        fn,
        input_signature=[tf.TensorSpec((bdim, height, width, 3), tf.float32, name="input")],
        autograph=False,
    )


def export_savedmodel(model, state_dict: Mapping[str, torch.Tensor], height: int, width: int,
                      path: str, batch: int = -1) -> str:
    """Write a TF SavedModel whose serving_default runs the forward."""
    tf = _tf()
    tf_f = _tf_fn(model, state_dict, height, width, batch)
    module = tf.Module()
    module.f = tf_f
    os.makedirs(path, exist_ok=True)
    tf.saved_model.save(module, path,
                        signatures={"serving_default": tf_f.get_concrete_function()})
    return path


def export_tflite(model, state_dict: Mapping[str, torch.Tensor], height: int, width: int,
                  path: str, batch: int = 1, dtype: str = "float32") -> bytes:
    """Write a .tflite flatbuffer. batch must be static (>=1; -1 means 1);
    dtype "float16" enables fp16 weight quantization."""
    tf = _tf()
    if batch == -1:
        batch = 1  # TFLite needs static shapes
    if dtype == "bfloat16":
        raise ValueError(
            "TFLite weight quantization is float16-only; pass "
            "dtype='float16' explicitly (bf16 and fp16 round/overflow "
            "differently, so a silent substitution would mislead)"
        )
    tf_f = _tf_fn(model, state_dict, height, width, batch)
    converter = tf.lite.TFLiteConverter.from_concrete_functions([tf_f.get_concrete_function()])
    if dtype == "float16":
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
        converter.target_spec.supported_types = [tf.float16]
    data = converter.convert()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return data


def run_savedmodel(path: str, x: np.ndarray) -> np.ndarray:
    """Load + run a SavedModel's serving signature (round-trip check)."""
    tf = _tf()
    sig = tf.saved_model.load(path).signatures["serving_default"]
    out = sig(tf.constant(np.asarray(x, np.float32)))
    return list(out.values())[0].numpy()


def run_tflite(path_or_bytes, x: np.ndarray) -> np.ndarray:
    """Run a TFLite flatbuffer with the TF interpreter (round-trip check)."""
    tf = _tf()
    if isinstance(path_or_bytes, (bytes, bytearray)):
        interp = tf.lite.Interpreter(model_content=bytes(path_or_bytes))
    else:
        interp = tf.lite.Interpreter(model_path=path_or_bytes)
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]
    out = interp.get_output_details()[0]
    interp.set_tensor(inp["index"], np.asarray(x, np.float32))
    interp.invoke()
    return interp.get_tensor(out["index"])
