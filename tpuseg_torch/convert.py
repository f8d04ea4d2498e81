"""Export entry point of the PyTorch port — the counterpart of ``convert.py``.

    python -m tpuseg_torch.convert --export.checkpoint=checkpoints \\
        --export.output=exported/model.pt2 --export.dtype=float16
    python -m tpuseg_torch.convert --export.format=quantized \\
        --export.output=exported/int8 --model.up_subpixel=false
    python -m tpuseg_torch.convert --platform=cpu --export.format=onnx \\
        --export.output=exported/model.onnx

The flags of the JAX package's ``convert.py`` (``load_config``), plus
``--platform=cpu``; it runs on the CUDA card unless ``--platform=cpu`` is
given (fp32 is fp32 there: TF32 off). Formats, each with the same
self-check as the JAX tool:

- ``stablehlo`` (the config default, kept so the config equals the JAX
  one): a ``torch.export`` program (``export/torch_export.py``), not
  StableHLO; neither package serves the other's file. A symbolic batch
  with ``--export.batch=-1``. Round trip on the device at rel < 1e-5 in
  fp32 (1e-2 for fp16/bf16 weights or bf16 compute).
  ``--model.use_pallas=true`` is refused (the CUDA kernels cannot be
  serialized, ROADMAP.md C16).
- ``quantized``: calibrate on ``--export.calib_batches`` x 8 seeded
  synthetic scenes (seed 77), write an int8 checkpoint directory that
  ``Predictor`` serves in int8, and require int8 and fp32 class maps to
  agree on at least 0.9 of 8 held-out scenes (seed 123).
- ``onnx``: fp32 only; the JAX exporter's bytes (``export/onnx_export.py``),
  checked structurally and executed back (``export/onnx_run.py``) against
  the live model at rel < 1e-5.
- ``savedmodel``/``tflite``: a TF SavedModel (a polymorphic batch with
  ``--export.batch=-1``) or a TFLite flatbuffer (batch 1 for -1;
  ``--export.dtype=float16`` stores fp16 weights, ``bfloat16`` is
  refused), built from the port's ONNX graph with BatchNorm folded
  (``export/tf_export.py``) and run back by TensorFlow on the CPU against
  the live model at rel < 1e-3 (1e-2 for fp16 weights), as the JAX tool
  checks. The graph computes the fp32 function of the weights, so a
  bf16-compute model is checked against its fp32 compute, as ONNX is
  (the JAX SavedModel of such a model rounds in bf16: ROADMAP.md C19),
  and its distance from the served bf16 model is printed beside, with a
  note naming C19.
  A SavedModel ignores ``--export.dtype``, as the JAX one does. They need
  TensorFlow: on a host without it, rc 1 naming it, and no other format
  is written instead.

``--export.dtype=int8`` exports dequantize(quantize(weights)) in an fp32
graph. A checkpoint that carries an int8 ``quant`` collection is refused
for every format but ``quantized`` (its fp32 weights would ship as the
validated artifact). Returns 0 on success, 1 on a refused or failed check.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Optional, Sequence

import numpy as np
import torch

CALIB_SEED, CHECK_SEED, CALIB_BATCH = 77, 123, 8


def _rel(out: torch.Tensor, direct: torch.Tensor) -> tuple:
    err = float((out.float() - direct.float()).abs().max())
    return err, err / max(float(direct.abs().max()), 1e-9)


def _live(model, state, x: torch.Tensor, device) -> torch.Tensor:
    """``model``'s eval logits (NHWC) with ``state`` on ``device``."""
    model.load_state_dict(state)
    model.to(device, memory_format=torch.channels_last).eval()
    with torch.no_grad():
        return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    from tpuseg_torch.configs import load_config
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.infer.predictor import load_checkpoint
    from tpuseg_torch.main import device_for_platform, split_platform_flag
    from tpuseg_torch.models.registry import build_model

    platform, argv = split_platform_flag(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device_for_platform(platform))
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(argv)
    model = build_model(cfg.model)
    state, quant = load_checkpoint(cfg.export.checkpoint, model.state_dict)
    fmt = cfg.export.format
    if quant and fmt != "quantized":
        print("ERROR: checkpoint carries a calibrated 'quant' collection (full-int8 "
              f"artifact) — format {fmt!r} would silently export its fp32 weights "
              "instead. Serve it directly with python -m tpuseg_torch.inference "
              "--infer.checkpoint=<dir>, or re-export from the original fp32 checkpoint.")
        return 1
    if cfg.export.dtype == "int8":
        from tpuseg_torch.export.quantize import dequantize_int8, quantize_int8

        state = dequantize_int8(quantize_int8(state))
        export_dtype = "float32"   # int8 is weight storage; the graph runs fp32
    else:
        export_dtype = cfg.export.dtype

    if fmt in ("savedmodel", "tflite"):
        return _export_tf(cfg, model, state, export_dtype, device)
    if fmt == "quantized":
        return _export_quantized(cfg, state, device)
    if fmt == "onnx":
        return _export_onnx(cfg, model, state, export_dtype, device)
    if fmt != "stablehlo":
        print(f"ERROR: unknown export format {fmt!r}")
        return 1
    return _export_program(cfg, model, state, export_dtype, device)


def _export_program(cfg, model, state, export_dtype: str, device) -> int:
    """The ``torch.export`` artifact and its round-trip check."""
    from tpuseg_torch.export.torch_export import export_model, load_exported

    try:
        data, _ = export_model(model, state, cfg.data.height, cfg.data.width,
                               cfg.export.output, batch=cfg.export.batch,
                               dtype=export_dtype, fold_bn=cfg.export.fold_bn)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    print(f"Exported {len(data)} bytes of a torch.export program to {cfg.export.output}")

    # a static-batch artifact takes exactly its batch size
    call = load_exported(cfg.export.output, device)
    check_batch = 2 if cfg.export.batch == -1 else cfg.export.batch
    x = torch.from_numpy(np.random.RandomState(0).rand(
        check_batch, cfg.data.height, cfg.data.width, 3).astype(np.float32)).to(device)
    with torch.no_grad():
        out = call(x)
    err, rel = _rel(out, _live(model, state, x, device))
    print(f"Round-trip check: max diff {err:.3e} (rel {rel:.3e})")
    # folding moves fp32 rounding; reduced weights or bf16 compute round further
    exact = export_dtype == "float32" and cfg.model.compute_dtype == "float32"
    if not (rel < 1e-5 if exact else rel < 1e-2):
        print("ERROR: exported model diverges from source model")
        return 1
    print("Export is valid!")
    return 0


def _fp32_compute(cfg, model):
    """``model``, or a twin computing in fp32: the ONNX and TF graphs are the
    fp32 function of the weights, so their checks compare with fp32 compute
    (ROADMAP.md C19)."""
    if cfg.model.compute_dtype == "float32":
        return model
    from tpuseg_torch.models.registry import build_model

    return build_model(dataclasses.replace(cfg.model, compute_dtype="float32"))


def _export_tf(cfg, model, state, export_dtype: str, device) -> int:
    """SavedModel / TFLite export with the JAX tool's round-trip check."""
    from tpuseg_torch.export import tf_export

    served = model
    model = _fp32_compute(cfg, model)
    h, w = cfg.data.height, cfg.data.width
    fmt = cfg.export.format
    try:
        if fmt == "savedmodel":
            tf_export.export_savedmodel(model, state, h, w, cfg.export.output,
                                        batch=cfg.export.batch)
            print(f"Exported SavedModel to {cfg.export.output}")
            run = lambda x: tf_export.run_savedmodel(cfg.export.output, x)
            check_batch = 2
        else:
            batch = cfg.export.batch if cfg.export.batch != -1 else 1
            data = tf_export.export_tflite(model, state, h, w, cfg.export.output,
                                           batch=batch, dtype=export_dtype)
            print(f"Exported {len(data)} bytes of TFLite to {cfg.export.output}")
            run = lambda x: tf_export.run_tflite(cfg.export.output, x)
            check_batch = batch
    except (ImportError, ValueError) as e:
        print(f"ERROR: format {fmt!r}: {e}")
        return 1
    x = np.random.RandomState(0).rand(check_batch, h, w, 3).astype(np.float32)
    out = torch.from_numpy(run(x))
    err, rel = _rel(out, _live(model, state, torch.from_numpy(x).to(device), device).cpu())
    print(f"Round-trip check: max diff {err:.3e} (rel {rel:.3e})")
    if not (rel < 1e-3 if export_dtype == "float32" else rel < 1e-2):
        print("ERROR: exported model diverges from source model")
        return 1
    if served is not model:
        err, rel = _rel(out, _live(served, state, torch.from_numpy(x).to(device), device).cpu())
        print(f"Against the served {cfg.model.compute_dtype} model: max diff {err:.3e} "
              f"(rel {rel:.3e})")
        print(f"NOTE: the artifact computes in float32, not {cfg.model.compute_dtype}; the "
              "check above holds it to the float32-compute model (ROADMAP.md C19)")
    print("Export is valid!")
    return 0


def synthetic_batches(n_batches: int, batch: int, width: int, height: int, seed: int,
                      device) -> list:
    """``n_batches`` normalized NHWC batches of the seeded synthetic scenes."""
    from tpuseg_torch.data.augment import normalize_images
    from tpuseg_torch.data.sources import SyntheticSource

    src = SyntheticSource(batch * n_batches, width, height, seed=seed)
    return [normalize_images(torch.from_numpy(np.stack(
        [src.load(i)[0] for i in range(b, b + batch)])).to(device))
        for b in range(0, batch * n_batches, batch)]


def _export_quantized(cfg, state, device) -> int:
    """Full int8: calibrate the activation scales, save a checkpoint with
    the ``quant`` collection, check the class maps against fp32."""
    from tpuseg_torch.export.int8_full import (bind_quant, calibrate,
                                               count_quantized_convs, save_quantized)
    from tpuseg_torch.models.registry import build_model

    # calibrate with the apply-time rewrites off, so that every conv sees its
    # input; the artifact serves under any configuration
    model = build_model(dataclasses.replace(cfg.model, up_subpixel=False, use_pallas=False))
    model.to(device, memory_format=torch.channels_last)
    h, w = cfg.data.height, cfg.data.width
    calib = synthetic_batches(cfg.export.calib_batches, CALIB_BATCH, w, h, CALIB_SEED, device)
    quant = calibrate(model, state, calib)
    save_quantized(cfg.export.output, state, quant)
    print(f"Calibrated {count_quantized_convs(quant)} convs; wrote int8 checkpoint to "
          f"{cfg.export.output}")

    (x,) = synthetic_batches(1, CALIB_BATCH, w, h, CHECK_SEED, device)
    with torch.no_grad():
        fp32_pred = model.eval()(x.permute(0, 3, 1, 2)).argmax(dim=1)
        int8_pred = bind_quant(model, quant)(x.permute(0, 3, 1, 2)).argmax(dim=1)
    bind_quant(model, None)
    agreement = float((fp32_pred == int8_pred).float().mean())
    print(f"Round-trip check: int8 vs fp32 mask agreement {agreement:.4f}")
    # a broken artifact agrees near chance; quantization noise flips near-ties
    if agreement < 0.9:
        print("ERROR: int8 masks diverge from fp32 beyond tolerance")
        return 1
    print("Export is valid!")
    return 0


def _export_onnx(cfg, model, state, export_dtype: str, device) -> int:
    """ONNX opset 12, checked structurally and executed back."""
    from tpuseg_torch.export.onnx_export import export_onnx
    from tpuseg_torch.export.onnx_run import check_model, run_model

    if export_dtype != "float32":
        print("ERROR: the ONNX exporter emits float32 graphs only; downstream "
              "toolchains own FP16/int8")
        return 1
    model = _fp32_compute(cfg, model)
    h, w = cfg.data.height, cfg.data.width
    try:
        data = export_onnx(model, state, h, w, path=cfg.export.output,
                           batch=cfg.export.batch)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    print(f"Exported {len(data)} bytes of ONNX to {cfg.export.output}")
    problems = check_model(data)
    if problems:
        print("ERROR: structural check failed: " + "; ".join(problems))
        return 1
    check_batch = 2 if cfg.export.batch == -1 else cfg.export.batch
    x = torch.from_numpy(np.random.RandomState(0).rand(
        check_batch, h, w, 3).astype(np.float32)).to(device)
    out = torch.from_numpy(run_model(data, {"input": x.permute(0, 3, 1, 2)})["output"])
    direct = _live(model, state, x, device).permute(0, 3, 1, 2).cpu()
    err, rel = _rel(out, direct)
    print(f"Round-trip check: max diff {err:.3e} (rel {rel:.3e})")
    if not rel < 1e-5:
        print("ERROR: exported model diverges from source model")
        return 1
    print("Export is valid!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
