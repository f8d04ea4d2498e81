"""Quantization and export of the port's models (the JAX package's ``tpuseg/export``)."""

from tpuseg_torch.export.int8_full import calibrate, quantized_apply_fn
from tpuseg_torch.export.onnx_export import export_onnx
from tpuseg_torch.export.quantize import dequantize_int8, fold_batchnorm, quantize_int8
from tpuseg_torch.export.torch_export import export_model, load_exported

__all__ = [
    "export_onnx",
    "fold_batchnorm",
    "quantize_int8",
    "dequantize_int8",
    "export_model",
    "load_exported",
    "calibrate",
    "quantized_apply_fn",
]
