"""A ``torch.export`` artifact of the forward, with a symbolic batch dimension.

The counterpart of ``tpuseg/export/stablehlo.py``: the eval forward is
exported by ``torch.export`` (a symbolic batch ``Dim``, or a static one)
and written with ``torch.export.save``; ``load_exported`` reads it back as
a callable on the CPU or the card. The program takes normalized NHWC
float32 images at the model size and returns NHWC logits, the contract of
the JAX artifact, so ``Predictor(artifact=)`` serves either package's
file the same way; but the file is a ``torch.export`` program, not
StableHLO, and neither package serves the other's.

Export dtypes follow the JAX exporter: ``"float32"``; ``"float16"`` or
``"bfloat16"``, whose program stores its parameters in that dtype (the
BatchNorm statistics stay float32) and widens them to float32 in the
graph, so it computes in float32 on rounded weights, as the JAX artifact
does. BatchNorm is folded first (``fold_bn``), the cast second, so the
folded weights are rounded once.

JAX's ``platforms`` has no meaning here: the program is exported on the
CPU and moved to the device it is loaded on. It holds plain PyTorch ops
only; the port's CUDA kernels are bound by ctypes (``ops/_build.py``) and
cannot be serialized into it. So ``use_pallas=True`` is refused rather
than exported through another route (ROADMAP.md C16); the subpixel
decoder (``up_subpixel``) is plain ops and exports.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.func import functional_call

from tpuseg_torch.export.quantize import cast_params, fold_batchnorm

StateDict = Dict[str, torch.Tensor]
EXPORT_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


class _Program(nn.Module):
    """The serving forward: NHWC images -> NHWC logits of ``model`` with
    ``state``'s tensors, held as this module's buffers in their own dtype
    and widened to float32 where the model reads them. The model is held
    outside the module tree, so its own tensors stay out of an exported
    program."""

    def __init__(self, model: nn.Module, state: StateDict):
        super().__init__()
        self.__dict__["model"] = model
        self.names = list(state)
        for i, k in enumerate(self.names):
            self.register_buffer(f"t{i}", state[k])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tensors = {}
        for i, k in enumerate(self.names):
            t = getattr(self, f"t{i}")
            tensors[k] = t.float() if t.is_floating_point() else t
        return functional_call(self.model, tensors, (x.permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)


def make_serving_fn(model: nn.Module, state_dict: StateDict, fold_bn: bool = True
                    ) -> Tuple[StateDict, nn.Module]:
    """(state_dict, serving(x) -> logits) with BatchNorm folded for
    inference; ``serving`` takes and returns NHWC."""
    if fold_bn:
        state_dict = fold_batchnorm(state_dict)
    return state_dict, _Program(model, state_dict)


def export_model(model: nn.Module, state_dict: StateDict, height: int, width: int,
                 path: str, batch: int = -1, dtype: str = "float32",
                 fold_bn: bool = True) -> Tuple[bytes, "torch.export.ExportedProgram"]:
    """Export the eval forward of ``model`` with ``state_dict``; batch=-1
    gives a symbolic batch dimension. Writes ``path`` (when given) and
    returns (the file's bytes, the ExportedProgram).

    ValueError for ``use_pallas=True`` (the CUDA kernels cannot be
    serialized: export with ``--model.use_pallas=false``) and for an
    unknown dtype."""
    if getattr(model, "use_pallas", False):
        raise ValueError("the port's CUDA kernels cannot be serialized into a torch.export "
                         "program: export with --model.use_pallas=false (the same function "
                         "in plain PyTorch ops)")
    if dtype not in EXPORT_DTYPES:
        raise ValueError(f"unknown export dtype {dtype!r} ({' | '.join(EXPORT_DTYPES)})")
    # fold FIRST, cast SECOND: the folded weights are made in float32 from
    # the float32 weights and rounded once
    state, _ = make_serving_fn(model, state_dict, fold_bn=fold_bn)
    if dtype != "float32":
        state = cast_params(state, EXPORT_DTYPES[dtype])
    model = copy.deepcopy(model).cpu().eval()
    _, program = make_serving_fn(model, {k: v.detach().cpu() for k, v in state.items()},
                                 fold_bn=False)
    x = torch.zeros(2 if batch == -1 else batch, height, width, 3)
    with torch.no_grad():
        # one eager call first: the resize taps and subpixel constants are
        # made and cached as real tensors, then traced as constants
        program(x)
        dynamic = ({0: torch.export.Dim("batch", min=1)},) if batch == -1 else None
        exported = torch.export.export(program, (x,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    data = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return data, exported


def load_exported(path: str, device: Optional[Union[str, torch.device]] = "cpu"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The artifact at ``path`` as a callable (NHWC images -> NHWC logits)
    on ``device``."""
    from torch.export.passes import move_to_device_pass

    exported = torch.export.load(path)
    if torch.device(device).type != "cpu":
        exported = move_to_device_pass(exported, torch.device(device))
    return exported.module()
