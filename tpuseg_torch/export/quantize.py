"""Inference-time surgery on the port's state_dict: BN folding, int8 weights, fp16/bf16 weights.

The port of ``tpuseg/export/quantize.py``, on a state_dict instead of a
flax variable tree; applied to ``state_dict_from_flax(v)`` each function
gives ``state_dict_from_flax`` of the JAX function's result, bit for bit.

- ``fold_batchnorm``: every conv followed by a BatchNorm (``conv_bn_pairs``)
  takes the BatchNorm's scale into its weight, and the BatchNorm becomes a
  pass-through plus shift (weight 1, bias = the shift, running mean 0,
  running var 1 - eps); a conv bias that exists is zeroed. The shift lives
  in the BatchNorm's bias, not a conv bias, since most convs have none.
  The math runs in float64 and is rounded to float32 once. The keys and
  shapes stay those of the model, so ``load_state_dict`` takes it.
- ``quantize_int8`` / ``dequantize_int8``: symmetric per-output-channel
  int8 weights (weight-only PTQ) of every conv weight (dim 0 of OIHW, the
  last axis of the JAX package's HWIO): scale ``absmax / 127`` in float32,
  1.0 for an all-zero channel. BatchNorm and bias tensors stay float32.
- ``cast_params``: the parameters (not the BatchNorm statistics) in
  float16 or bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import torch

BN_EPS = 1e-5

StateDict = Dict[str, torch.Tensor]
# the BatchNorm statistics: buffers, where the JAX package has batch_stats
STAT_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def conv_bn_pairs(state_dict: Mapping[str, torch.Tensor]) -> List[Tuple[str, str]]:
    """(conv, BatchNorm) module names of every conv followed by a BatchNorm:
    a 4-D ``<seq>.<i>.weight`` whose ``<seq>.<i+1>`` has a running variance
    (the port's ``nn.Sequential`` pairs, the JAX package's ``ConvBNAct``)."""
    out = []
    for key, value in state_dict.items():
        if not key.endswith(".weight") or value.ndim != 4:
            continue
        conv = key[: -len(".weight")]
        seq, _, idx = conv.rpartition(".")
        if idx.isdigit():
            bn = f"{seq}.{int(idx) + 1}" if seq else str(int(idx) + 1)
            if f"{bn}.running_var" in state_dict:
                out.append((conv, bn))
    return out


def fold_batchnorm(state_dict: Mapping[str, torch.Tensor], eps: float = BN_EPS) -> StateDict:
    """Fold every conv -> BatchNorm pair (see the module); a new state_dict.

    weight' = weight * gamma / sqrt(var + eps)              (per out-channel)
    shift   = beta + (bias - mean) * gamma / sqrt(var + eps)"""
    out = dict(state_dict)
    for conv, bn in conv_bn_pairs(state_dict):
        w = state_dict[f"{conv}.weight"].to(torch.float64)
        c = w.shape[0]
        has_bias = f"{conv}.bias" in state_dict
        bias = (state_dict[f"{conv}.bias"].to(torch.float64) if has_bias
                else torch.zeros(c, dtype=torch.float64))
        gamma, beta, mean, var = (state_dict[f"{bn}.{k}"].to(torch.float64) for k in
                                  ("weight", "bias", "running_mean", "running_var"))
        factor = gamma / torch.sqrt(var + eps)
        out[f"{conv}.weight"] = (w * factor.view(-1, 1, 1, 1)).to(torch.float32)
        if has_bias:
            out[f"{conv}.bias"] = torch.zeros(c, dtype=torch.float32)
        out[f"{bn}.weight"] = torch.ones(c, dtype=torch.float32)
        out[f"{bn}.bias"] = (beta + (bias - mean) * factor).to(torch.float32)
        out[f"{bn}.running_mean"] = torch.zeros(c, dtype=torch.float32)
        out[f"{bn}.running_var"] = torch.full((c,), 1.0 - eps, dtype=torch.float32)
    return out


def _is_conv_weight(key: str, value: torch.Tensor) -> bool:
    return key.endswith(".weight") and value.ndim == 4


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, float32 per-output-channel scale) of an OIHW conv
    weight, as ``int8_full.calibrate`` and ``quantize_int8`` of the JAX
    package compute them."""
    w = weight.to(torch.float32)
    absmax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(w / scale.view(-1, *(1,) * (w.ndim - 1))), -127, 127)
    return q.to(torch.int8), scale


def quantize_int8(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Union[torch.Tensor, dict]]:
    """Every conv weight -> ``{"__int8__": int8 OIHW, "__scale__": float32
    [Cout]}``; every other tensor as it is."""
    out: Dict[str, Union[torch.Tensor, dict]] = {}
    for key, value in state_dict.items():
        if _is_conv_weight(key, value):
            q, scale = quantize_weight(value)
            out[key] = {"__int8__": q, "__scale__": scale}
        else:
            out[key] = value
    return out


def dequantize_int8(qstate: Mapping[str, Union[torch.Tensor, dict]]) -> StateDict:
    """Inverse of ``quantize_int8``: a float32 state_dict."""
    out = {}
    for key, value in qstate.items():
        if isinstance(value, dict):
            q = value["__int8__"]
            value = q.to(torch.float32) * value["__scale__"].view(-1, *(1,) * (q.ndim - 1))
        out[key] = value
    return out


def cast_params(state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype) -> StateDict:
    """The floating parameters in ``dtype`` (float16 or bfloat16); the
    BatchNorm statistics and integer tensors as they are."""
    return {k: v.to(dtype) if v.is_floating_point() and not k.endswith(STAT_SUFFIXES) else v
            for k, v in state_dict.items()}
