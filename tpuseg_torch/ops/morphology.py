"""Binary morphology on tensors: the port of ``tpuseg/ops/morphology.py``.

The road cleanup of the postprocess opens with a 5x5 rect MORPH_CLOSE;
``Predictor(device_close=True)`` runs it on the device, on the class map
at frame resolution, before the fetch. cv2 parity: MORPH_CLOSE is dilate
then erode, and cv2's default border value makes out-of-image pixels a
no-op for each pass. ``F.max_pool2d`` pads with -inf, which is that no-op
for a max, so dilate is a max-pool of the mask and erode is
1 - max-pool(1 - mask). A k x k rect window is separable: each pass is a
k x 1 and a 1 x k pool. The JAX package uses ``lax.reduce_window`` here,
not a Pallas kernel, so plain PyTorch is the counterpart.

``max_pool2d`` takes no bool or uint8: the masks pool as float32 0/1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable k x k max over the last two axes of a float32 [..., H, W]."""
    if k % 2 != 1 or k < 1:
        raise ValueError(f"kernel_size must be odd and positive, got {k}")
    lead = x.shape[:-2]
    y = x.reshape(-1, 1, *x.shape[-2:])
    y = F.max_pool2d(y, (k, 1), stride=1, padding=(k // 2, 0))
    y = F.max_pool2d(y, (1, k), stride=1, padding=(0, k // 2))
    return y.reshape(*lead, *x.shape[-2:])


def dilate(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Binary dilation with a rect kernel (cv2.dilate, border no-op)."""
    return _max_pool(mask.to(torch.float32), kernel_size) > 0.5


def erode(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Binary erosion with a rect kernel (cv2.erode, border no-op)."""
    return _max_pool(1.0 - mask.to(torch.float32), kernel_size) < 0.5


def morph_close(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """cv2.morphologyEx(mask, MORPH_CLOSE, k x k rect), bit-exact.

    ``mask``: bool (or 0/1) [..., H, W]. Returns bool of the same shape."""
    return erode(dilate(mask, kernel_size), kernel_size)
