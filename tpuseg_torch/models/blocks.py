"""UNet building blocks as PyTorch modules (NCHW, torch idiom).

The port of ``tpuseg/models/blocks.py``. Module and ``state_dict`` layout
follow the reference and torchvision, so a reference ``.pth`` loads
directly:

- ``ConvBNAct`` is torchvision's ConvBNActivation, ``Sequential(Conv2d,
  BatchNorm2d, act)`` with keys ``0.*``/``1.*``;
- ``DoubleConv.conv`` is the reference's flat ``Sequential(Conv, BN, ReLU,
  Conv, BN, ReLU)`` (keys ``0,1,3,4``);
- ``Up`` concatenates the skip FIRST, then the upsampled input
  (bilinear x2, ``align_corners=False``);
- ``OutConv.conv`` is ``Sequential(Conv1x1, BN, ReLU, Conv1x1)`` (keys
  ``0,1,3``);
- ``InConv.conv`` and ``Down.mpconv.1`` hold the UNet's DoubleConvs, as the
  reference's ``inconv`` and ``down`` do.

BatchNorm eps is 1e-5 and momentum 0.1 (torch's defaults, the same
statistics as the JAX package's flax decay 0.9).

bf16 compute (``core/dtypes.py::set_compute_dtype``) rounds where the
JAX package's ``ConvBNAct`` rounds: every ``Conv2d`` below casts its input,
weight and bias to the compute dtype and adds the bias to the rounded
conv, as flax's ``nn.Conv(dtype=)``; BatchNorm runs on the input promoted
to at least fp32 and returns the compute dtype; the activations run in
it; the fused decoder kernel's and the subpixel rewrite's fp32 outputs are
rounded to it before BatchNorm. The parameters stay fp32 and the
state_dict keys do not change. Every BatchNorm is
``BatchNorm2d`` below, which follows flax in train mode: the running
variance takes the biased batch variance, where ``nn.BatchNorm2d`` takes
the unbiased n/(n-1) one. Inside ``frozen_running_stats()`` (the
recomputation of a remat forward) it normalizes the same way and leaves
the running statistics where they are.

``upconcat_conv`` keeps the JAX routing of an up block's first conv
(``ConvBNAct.upconcat_impl`` there): ``"subpixel"`` in train and eval;
``"pallas"`` -> the CUDA kernel ``fused_upsample_concat_conv`` in eval only;
the materialized upsample+concat otherwise, and in training under QAT
(the deployed graph's shape).

QAT (``tpuseg_torch.ops.fake_quant.set_qat``): a marked ``Conv2d`` in
train mode convolves the fake-quantized input and weight in the compute
dtype and adds the bias, as the JAX ``ConvBNAct._qat_conv``; its
activation range spans the mesh that ``set_mesh`` gave it.

Spatial mode (``tpuseg_torch/parallel/spatial.py``; the spatially sharded
train step switches it on): every module takes this rank's H-slab of its
input and returns its owned rows of its output. A ``Conv2d`` fetches the
input rows its owned output rows read under its own padding (``dilation *
(k - 1) // 2`` each side at stride 1; the rows ``2i - 1 .. 2i + 1`` of output
row ``i`` for the 3x3 stride-2 convs, whose explicit padding is flax's
``((1, 1), (1, 1))``) and convolves them with H padding 0, so zero rows
appear only beyond the frame; ``MaxPool2d`` fetches its windows the same
way. Train-mode BatchNorm sums its statistics over the whole mesh, and a
QAT conv's activation range spans it too.

Full int8 (``tpuseg_torch.export.int8_full.bind_quant``): a ``Conv2d``
that carries calibrated ``int8`` data runs, in eval, as the JAX
``ConvBNAct._quantized_conv``: the input quantized with the per-tensor
activation scale, an exact int8 x int8 -> int32 conv
(``ops/int8_conv.py``), the sums rescaled by ``act_scale * kernel_scale``
(the product formed first), the bias added, the result in the compute
dtype. Such a conv in an up block takes the materialized up-concat, as
the JAX block does whenever ``quant`` is bound.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.core.mesh import all_reduce_
from tpuseg_torch.ops.fake_quant import fake_quant_act, fake_quant_kernel
from tpuseg_torch.ops.int8_conv import int8_conv, quantize_act
from tpuseg_torch.ops.resize import upsample2x_bilinear
from tpuseg_torch.parallel import spatial

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# > 0 while a remat forward is recomputed in the backward. A process-wide
# count, not a thread-local one: the autograd engine may recompute on its
# own device thread.
_frozen_stats = [0]


@contextlib.contextmanager
def frozen_running_stats() -> Iterator[None]:
    """Train-mode BatchNorm that does not move its running statistics (they
    moved once already, in the forward that is being recomputed)."""
    _frozen_stats[0] += 1
    try:
        yield
    finally:
        _frozen_stats[0] -= 1


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode running statistics.

    Train mode normalizes with the batch mean and biased variance, as
    torch does, and moves ``running_mean``/``running_var`` by ``momentum``
    towards the batch mean and the *biased* batch variance, as flax's
    ``nn.BatchNorm`` does (torch moves the variance towards the unbiased
    one). Eval mode is ``nn.BatchNorm2d``'s, unchanged; so is the
    state_dict.

    The batch statistics are computed once, by ``F.batch_norm``, which
    also moves the running buffers; the running variance's move is then
    scaled by (n-1)/n, from the unbiased variance to the biased one.

    Over a mesh (``mesh`` set by ``set_mesh``; the data axis) train mode
    normalizes with the global batch's statistics, as flax's BatchNorm
    under a data-sharded jit: see ``_GlobalBatchNorm``. The running
    statistics then move alike on every rank.

    With ``compute_dtype`` set, the input is promoted to at least fp32
    and the output cast to ``compute_dtype``, as the JAX ``ConvBNAct``'s
    BatchNorm runs."""

    mesh = None
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._normalize(x.to(torch.promote_types(torch.float32, x.dtype)))
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        frame = spatial.active()
        if frame is not None:
            return self._global_forward(x, frame.mesh, frame.mesh.group)
        if self.mesh is not None and self.mesh.data_group is not None:
            return self._global_forward(x, self.mesh, self.mesh.data_group)
        if _frozen_stats[0]:
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            moved = self.running_var.clone()    # the backward keeps it: not edited after
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_((moved - kept) * ((n - 1) / n) + kept)
        return y

    def _global_forward(self, x: torch.Tensor, mesh, group) -> torch.Tensor:
        mean, var, y = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, mesh, group)
        if not _frozen_stats[0]:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
                self.num_batches_tracked.add_(1)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm on the statistics of the global batch.

    Forward: per-channel sums of x and x^2 and the element count, ONE
    all_reduce of them over ``group`` (the data axis; the whole mesh when
    H is sharded too), then flax's formulas: mean =
    E[x], var = max(E[x^2] - mean^2, 0), y = (x - mean) rsqrt(var + eps)
    gamma + beta. Backward: with x_hat the normalized input,

        dx = gamma rsqrt(var + eps) (dy - S1 / N - x_hat S2 / N),
        S1 = sum dy,  S2 = sum dy x_hat  over the GLOBAL batch,

    so ONE all_reduce of the local (S1, S2) carries the other ranks' terms
    (this rank's dy is its whole gradient; the statistics feed every
    rank's outputs). dgamma and dbeta are this rank's parts, summed with
    the other parameter gradients in the train step."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh, group):
        dims = [0, 2, 3]
        c = x.shape[1]
        stats = torch.cat([x.sum(dims), (x * x).sum(dims),
                           x.new_full((1,), x.numel() // c)])
        all_reduce_(stats, mesh, group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c, 1, 1)
        # in place where a temporary would be a copy of the whole slab
        x_hat = (x - mean.view(shape)).mul_(invstd.view(shape))
        y = (x_hat * weight.view(shape)).add_(bias.view(shape))
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.mesh, ctx.group = mesh, group
        ctx.mark_non_differentiable(mean, var)
        return mean, var, y

    @staticmethod
    def backward(ctx, _dmean, _dvar, dy):
        x_hat, weight, invstd, n = ctx.saved_tensors
        dims = [0, 2, 3]
        c = x_hat.shape[1]
        shape = (1, c, 1, 1)
        local = torch.cat([dy.sum(dims), (dy * x_hat).sum(dims)])
        dbeta, dgamma = local[:c].clone(), local[c:].clone()
        sums = all_reduce_(local, ctx.mesh, ctx.group)
        dx = (dy - (sums[:c] / n).view(shape)).sub_(x_hat * (sums[c:] / n).view(shape))
        return dx.mul_((weight * invstd).view(shape)), dgamma, dbeta, None, None, None


def set_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every BatchNorm2d and Conv2d of ``model`` the mesh whose data
    axis its train-mode statistics (a QAT conv's activation range) span
    (None: this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, Conv2d)):
            m.mesh = mesh
    return model


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (free when it is channels_last)."""
    return t.permute(0, 2, 3, 1).contiguous()


def nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last strides)."""
    return t.permute(0, 3, 1, 2)


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> contiguous HWIO (the JAX kernel layout)."""
    return weight.permute(2, 3, 1, 0).contiguous()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` when it is set, as
    flax's ``nn.Conv(dtype=...)``: the input, the weight and the bias cast
    to it, the bias added to the conv's rounded result. None: the
    parameters' dtype (``nn.Conv2d``'s own forward). With ``qat`` set, in
    train mode, the input and the weight are fake-quantized first. With
    ``int8`` set (``kernel_q``, ``act_scale``, ``scale`` = act_scale *
    kernel_scale, optional ``bias``, on the weight's device), in eval, the
    conv runs in int8 (see the module)."""

    compute_dtype: Optional[torch.dtype] = None
    qat = False
    mesh = None
    int8: Optional[dict] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.int8 is not None and not self.training:
            q = self.int8
            acc = int8_conv(quantize_act(x, q["act_scale"]), q["kernel_q"], self.stride,
                            self.padding, self.dilation, self.groups)
            y = acc.to(torch.float32) * q["scale"].view(-1, 1, 1)
            if "bias" in q:
                y = y + q["bias"].view(-1, 1, 1)
            return y.to(torch.float32 if dt is None else dt)
        frame = spatial.active()
        qat = self.qat and self.training
        if frame is None and not qat and dt is None:
            return super().forward(x)
        w = self.weight
        if qat:
            mesh = self.mesh if frame is None else frame.mesh
            x, w = fake_quant_act(x, mesh, spatial=frame is not None), fake_quant_kernel(w)
        padding = self.padding
        if frame is not None:
            x, rows = self._fetch(frame, x)
            padding = (0, self.padding[1])
            if rows == 0:
                return spatial.empty_rows((x, w), self._out_shape(x, rows),
                                          x.dtype if dt is None else dt)
        if dt is not None:
            x, w = x.to(dt), w.to(dt)
        if not qat and dt is None:
            return F.conv2d(x, w, self.bias, self.stride, padding, self.dilation, self.groups)
        y = F.conv2d(x, w, None, self.stride, padding, self.dilation, self.groups)
        return y if self.bias is None else y + self.bias.to(y.dtype).view(-1, 1, 1)

    def _fetch(self, frame, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(the input rows this rank's owned output rows read, how many
        output rows it owns) in the spatial mode."""
        (k, _), (st, _), (p, _), (d, _) = (self.kernel_size, self.stride, self.padding,
                                           self.dilation)
        if k == 1 and st == 1 and p == 0:
            return x, x.shape[2]            # row-local: nothing to fetch
        h = spatial.layer_height(frame, x.shape[3])
        h_out = (h + 2 * p - d * (k - 1) - 1) // st + 1
        x, start, stop = spatial.fetch_window(
            frame, x, h, h_out, lambda s, e: (s * st - p, (e - 1) * st - p + d * (k - 1) + 1))
        return x, stop - start

    def _out_shape(self, x: torch.Tensor, rows: int) -> Tuple[int, ...]:
        (_, kw), (_, sw), (_, pw), (_, dw) = (self.kernel_size, self.stride, self.padding,
                                              self.dilation)
        return (x.shape[0], self.out_channels, rows, (x.shape[3] + 2 * pw - dw * (kw - 1) - 1)
                // sw + 1)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` (no padding) that in the spatial mode pools this
    rank's owned output rows from the input rows their windows read."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frame = spatial.active()
        if frame is None:
            return super().forward(x)
        k, st = self.kernel_size, self.stride
        if self.padding or self.dilation != 1 or self.ceil_mode:
            raise NotImplementedError("the spatial mode pools only unpadded windows")
        h = spatial.layer_height(frame, x.shape[3])
        x, start, stop = spatial.fetch_window(frame, x, h, (h - k) // st + 1,
                                              lambda s, e: (s * st, (e - 1) * st + k))
        if stop == start:
            return spatial.empty_rows(x, (x.shape[0], x.shape[1], 0, (x.shape[3] - k) // st + 1),
                                      x.dtype)
        return super().forward(x)


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> activation (torchvision's ConvBNActivation).

    ``dilation`` pads by ``dilation * (kernel - 1) // 2`` (the ASPP's
    explicit padding ``r`` for a 3x3 at rate ``r``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, bias: bool = False,
                 act: Optional[Type[nn.Module]] = nn.ReLU6, dilation: int = 1):
        layers = [
            Conv2d(cin, cout, kernel, stride, dilation * (kernel - 1) // 2,
                   dilation=dilation, groups=groups, bias=bias),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
        ]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


def upconcat_conv(conv: Conv2d, skip: torch.Tensor, x: torch.Tensor,
                  impl: str, training: bool) -> torch.Tensor:
    """``conv(cat([skip, up2x(x)]))`` (NCHW in, NCHW out, before BN).

    impl "subpixel": exact composite-kernel rewrite (train and eval);
    "pallas": the fused CUDA kernel in eval (its plain version for CPU
    tensors); otherwise, or "pallas" in training, or any impl in training
    under QAT, the materialized upsample + concat + conv. The first two
    give fp32, rounded to the conv's compute dtype when it has one
    (``blocks.py:182, 203, 212`` of the JAX package)."""
    if (conv.qat and training) or conv.int8 is not None:
        impl = "materialize"
    if impl == "pallas" and not training and spatial.active() is not None:
        raise ValueError("the fused decoder kernel runs whole frames: the spatial mode "
                         "takes the subpixel or the materialized up-concat")
    if impl == "subpixel" or (impl == "pallas" and not training):
        from tpuseg_torch.ops.kernels import fused_upsample_concat_conv
        from tpuseg_torch.ops.subpixel import up_concat_conv_subpixel

        fn = up_concat_conv_subpixel if impl == "subpixel" else fused_upsample_concat_conv
        y = fn(nhwc(skip), nhwc(x), hwio(conv.weight), conv.bias)
        return nchw(y if conv.compute_dtype is None else y.to(conv.compute_dtype))
    if impl not in ("pallas", "materialize"):
        raise ValueError(f"unknown upconcat_impl {impl!r}")
    up = nchw(upsample2x_bilinear(x.permute(0, 2, 3, 1), align_corners=False))
    return conv(torch.cat([skip, up], dim=1))


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2 — the reference double_conv.

    ``upconcat_pair=(skip, x)`` routes the first conv through
    ``upconcat_conv`` (state_dict unchanged)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU(),
            Conv2d(cout, cout, 3, padding=1),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU(),
        )

    def forward(self, x: Optional[torch.Tensor],
                upconcat_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                upconcat_impl: str = "pallas") -> torch.Tensor:
        if upconcat_pair is None:
            return self.conv(x)
        skip, up_in = upconcat_pair
        y = upconcat_conv(self.conv[0], skip, up_in, upconcat_impl,
                          self.training)
        for layer in self.conv[1:]:
            y = layer(y)
        return y


class InConv(nn.Module):
    """The reference inconv: a DoubleConv under ``.conv`` (keys
    ``inc.conv.conv.*``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Down(nn.Module):
    """MaxPool(2) then DoubleConv — the reference down, whose
    ``mpconv = Sequential(MaxPool2d, double_conv)`` gives the keys
    ``downK.mpconv.1.conv.*``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv(x)


class Up(nn.Module):
    """Bilinear x2 (align_corners=False), concat [skip, upsampled], DoubleConv.

    ``subpixel`` takes precedence over ``use_pallas``, as in the JAX
    package; both are chosen per call, so they never change the
    state_dict."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                use_pallas: bool = False, subpixel: bool = False) -> torch.Tensor:
        impl = "subpixel" if subpixel else "pallas" if use_pallas else "materialize"
        return self.conv(None, upconcat_pair=(skip, x), upconcat_impl=impl)


class OutConv(nn.Module):
    """Head: Conv1x1(in->in/2) -> BN -> ReLU -> Conv1x1(in/2->classes)."""

    def __init__(self, cin: int, classes: int):
        super().__init__()
        half = cin // 2
        self.conv = nn.Sequential(
            Conv2d(cin, half, 1),
            BatchNorm2d(half, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU(),
            Conv2d(half, classes, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
