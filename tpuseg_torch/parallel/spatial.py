"""Spatial parallelism: image-height sharding, exact per layer.

The port of what the JAX package's spatially sharded train step gets from
GSPMD (``tpuseg/train/train_step.py``, ``spatial=True``): the H dim of
every activation is split over the mesh's "spatial" axis, and each layer
that reads rows beyond its own fetches them from the ranks that own them.

Ownership. A layer of global height ``h`` over ``S`` spatial ranks is cut
as GSPMD cuts it: ``ceil(h / S)`` rows per rank, in order, the last ranks
short or empty (``owned``). Every op computes the rows of its OUTPUT layer
that this rank owns, from the input rows those rows read.

Fetches. ``fetch_rows(x, h, requests, mesh)`` returns the global rows
``requests[j]`` (``[lo, hi)``, for this rank ``j``) of a layer of which
``x`` is this rank's owned slab: zero rows outside ``[0, h)`` (a conv's
padding) or, with ``clamp``, the edge row (a bilinear clamp). Every rank
passes every rank's request, so each knows which of its rows the others
read; each rank sends those rows alone (one all_gather over the spatial
group, of as many rows as the largest such set), so a 3x3 conv moves one
row each way, and a halo wider than a slab (the ASPP's rate-6 conv on a
4-row layer) reaches past the neighbours. The backward sends each fetched
row's gradient back to its owner (one all_reduce of the same shape),
which adds it to its own: the gradient convention of ``train/loss.py``.
Its autograd node keeps the index plan, not the gathered rows: what a
layer saves is its own halo'd slab.

The spatial mode (``spatial_mode(mesh, height, width)``) is what the
model's modules read (``models/blocks.py``, ``ops/resize.py``,
``ops/subpixel.py`` and the families): the train step switches it on for
the forward and backward of a step. A layer's global height comes from its
width, which is never split: every activation of the five families keeps
the frame's aspect ratio, so a layer ``w`` wide is ``height * w / width``
high (``layer_height``; an activation that breaks the rule raises).
``replicated()`` switches it off inside, for a branch every spatial rank
computes whole (the ASPP's image pooling).

``halo_exchange`` and ``spatial_shard_apply`` are the port of
``tpuseg/parallel/spatial.py`` (its route 2): each rank holds an H-slab of
the frame, takes ``halo`` rows from each side (zero rows at the frame's
edges), runs ``fn`` on the padded slab and crops. With ``halo`` at least
``fn``'s receptive-field half-width,

    spatial_shard_apply(fn)(x) == crop(fn(zero_pad_H(x, halo)))

so the slab boundaries inside the frame are exact against the unsharded
forward; the outermost rows of the frame see one input-level zero
extension in place of per-layer padding, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from tpuseg_torch.core.mesh import Mesh, all_gather, all_reduce_

Request = Tuple[int, int]


def owned(h: int, parts: int, at: int) -> Tuple[int, int]:
    """Global rows ``[start, stop)`` of a layer of height ``h`` that the
    spatial rank ``at`` of ``parts`` owns: ``ceil(h / parts)`` each, the
    last ranks short or empty."""
    c = -(-h // parts)
    start = min(at * c, h)
    return start, min(start + c, h)


def window_requests(h_out: int, parts: int,
                    rows: Callable[[int, int], Request]) -> Tuple[Request, ...]:
    """Every spatial rank's input rows: ``rows(start, stop)`` of its owned
    output rows of a layer ``h_out`` high; ``(0, 0)`` for a rank that owns
    none."""
    out = []
    for q in range(parts):
        s, e = owned(h_out, parts, q)
        out.append(rows(s, e) if e > s else (0, 0))
    return tuple(out)


@dataclass(frozen=True)
class _Plan:
    """The indices of one fetch on one rank (see ``_plan``)."""

    n: int                      # rows this rank owns
    k: int                      # rows each rank sends (the largest set, padded)
    send: Tuple[int, ...]       # rows of [x; zero] this rank sends, k of them
    n_send: int                 # how many of them the others read
    take: Tuple[int, ...]       # rows of [x; zero; bands] that make the output


@functools.lru_cache(maxsize=None)
def _plan(h: int, parts: int, at: int, requests: Tuple[Request, ...], clamp: bool) -> _Plan:
    """Which rows each rank sends and where each requested row comes from."""
    own = [owned(h, parts, q) for q in range(parts)]
    c = -(-h // parts)

    def source(g: int) -> Optional[int]:
        if clamp:
            return min(max(g, 0), h - 1)
        return g if 0 <= g < h else None

    needed: List[List[int]] = [[] for _ in range(parts)]
    for q, (lo, hi) in enumerate(requests):
        for g in range(lo, hi):
            g = source(g)
            r = None if g is None else g // c
            if r is not None and r != q and g not in needed[r]:
                needed[r].append(g)
    for rows in needed:
        rows.sort()
    k = max(len(rows) for rows in needed)
    start, stop = own[at]
    n = stop - start
    send = [g - start for g in needed[at]] + [n] * (k - len(needed[at]))
    take = []
    lo, hi = requests[at]
    for g in range(lo, hi):
        g = source(g)
        if g is None:
            take.append(n)                              # the zero row
        elif start <= g < stop:
            take.append(g - start)
        else:
            r = g // c
            take.append(n + 1 + r * k + needed[r].index(g))
    return _Plan(n, k, tuple(send), len(needed[at]), tuple(take))


_INDEX: Dict[Tuple[_Plan, torch.device], Tuple[torch.Tensor, ...]] = {}


def _index(plan: _Plan, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(send, the sent rows the others read, take) as index tensors on
    ``device``, made once per plan."""
    key = (plan, device)
    if key not in _INDEX:
        with torch.inference_mode(False):
            _INDEX[key] = tuple(torch.tensor(v, dtype=torch.int64, device=device)
                                for v in (plan.send, plan.send[:plan.n_send], plan.take))
    return _INDEX[key]


def _rows_like(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


def _row_major(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, int, bool]:
    """(x, dim, permuted): a channels_last NCHW slab through its NHWC view,
    whose rows are contiguous blocks, so gathering rows keeps the layout
    and copies nothing else."""
    if (x.ndim == 4 and dim == 2 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return x.permute(0, 2, 3, 1), 1, True
    return x, dim, False


class _FetchRows(torch.autograd.Function):
    """Forward: the requested rows, from this rank's slab, the others' sent
    rows and a zero row. Backward: the gradient of each row fetched from
    another rank goes back to it (one all_reduce of the sent rows' slots
    over the spatial group), and each rank adds what came back for its sent
    rows to its own rows' gradient. What goes over the wire is contiguous
    in ``x``'s own indexing, whatever each rank's layout (a slab of one row
    is both channels_last and contiguous)."""

    @staticmethod
    def forward(ctx, x, plan, mesh, dim):
        send, _, take = _index(plan, x.device)
        xv, d, permuted = _row_major(x, dim)
        parts = [xv, _rows_like(xv, d, 1)]
        if plan.k:
            # a padding slot of the sent rows is never read: any row will do
            band = (x.index_select(dim, send.clamp(max=plan.n - 1)) if plan.n
                    else _rows_like(x, dim, plan.k))
            parts += [b.permute(0, 2, 3, 1) if permuted else b
                      for b in all_gather(band.contiguous(), mesh, mesh.spatial_group)]
        ctx.plan, ctx.mesh, ctx.dim, ctx.permuted = plan, mesh, dim, permuted
        ctx.rows = sum(p.shape[d] for p in parts)
        out = torch.cat(parts, d).index_select(d, take)
        return out.permute(0, 3, 1, 2) if permuted else out

    @staticmethod
    def backward(ctx, g):
        plan, dim, permuted = ctx.plan, ctx.dim, ctx.permuted
        _, sent, take = _index(plan, g.device)
        gv, d = (g.permute(0, 2, 3, 1), 1) if permuted else (g, dim)
        full = _rows_like(gv, d, ctx.rows).index_add_(d, take, gv)
        if permuted:
            full = full.permute(0, 3, 1, 2)
        gx = full.narrow(dim, 0, plan.n)
        if plan.k:
            bands = all_reduce_(full.narrow(dim, plan.n + 1, ctx.rows - plan.n - 1).contiguous(),
                                ctx.mesh, ctx.mesh.spatial_group)
            j = ctx.mesh.coords["spatial"]
            gx.index_add_(dim, sent, bands.narrow(dim, j * plan.k, plan.n_send))
        return gx, None, None, None


def fetch_rows(x: torch.Tensor, h: int, requests: Sequence[Request], mesh: Mesh,
               dim: int = 2, clamp: bool = False) -> torch.Tensor:
    """Global rows ``requests[j]`` (``[lo, hi)``, ``j`` this rank's spatial
    coordinate) of a layer ``h`` high along ``dim``, of which ``x`` is this
    rank's owned slab (``owned``): zero rows outside ``[0, h)``, or with
    ``clamp`` the nearest edge row. ``requests`` holds every spatial rank's
    request, alike on every rank. Differentiable: each row's gradient
    reaches its owner (see the module)."""
    requests = tuple((int(lo), int(hi)) for lo, hi in requests)
    plan = _plan(int(h), mesh.spatial, mesh.coords["spatial"], requests, bool(clamp))
    if x.shape[dim] != plan.n:
        raise ValueError(f"a slab of {x.shape[dim]} rows where spatial rank "
                         f"{mesh.coords['spatial']} owns {plan.n} of {h}")
    return _FetchRows.apply(x, plan, mesh, dim)


# ---------------------------------------------------------------------------
# the spatial mode


@dataclass(frozen=True)
class Frame:
    """The frame a spatial step shards: its mesh and its global size."""

    mesh: Mesh
    height: int
    width: int


_frame: List[Optional[Frame]] = [None]


def active() -> Optional[Frame]:
    """The frame of the spatial mode in force, or None."""
    return _frame[0]


@contextlib.contextmanager
def _set(frame: Optional[Frame]) -> Iterator[None]:
    # process-wide, not thread-local: the autograd engine may recompute a
    # remat forward on its own device thread
    before, _frame[0] = _frame[0], frame
    try:
        yield
    finally:
        _frame[0] = before


def spatial_mode(mesh: Mesh, height: int, width: int):
    """Within: the model's modules compute this rank's rows of a frame
    ``height`` x ``width`` sharded over ``mesh``'s spatial axis."""
    return _set(Frame(mesh, int(height), int(width)))


def replicated():
    """Within: the spatial mode off (a branch that every spatial rank
    computes whole, alike)."""
    return _set(None)


def layer_height(frame: Frame, width: int) -> int:
    """The global height of a layer ``width`` wide (see the module)."""
    h, rem = divmod(frame.height * width, frame.width)
    if rem:
        raise ValueError(f"a layer {width} wide does not keep the {frame.height}x"
                         f"{frame.width} frame's aspect ratio: the spatial step cannot "
                         "tell its global height")
    return h


def owned_rows(frame: Frame, h: int) -> Tuple[int, int]:
    """This rank's rows of a layer ``h`` high."""
    return owned(h, frame.mesh.spatial, frame.mesh.coords["spatial"])


def fetch_window(frame: Frame, x: torch.Tensor, h_in: int, h_out: int,
                 rows: Callable[[int, int], Request], dim: int = 2,
                 clamp: bool = False) -> Tuple[torch.Tensor, int, int]:
    """(the input rows ``rows(start, stop)`` that this rank's owned rows
    ``[start, stop)`` of the output layer read, start, stop): ``fetch_rows``
    with every rank's request from ``window_requests``."""
    mesh = frame.mesh
    requests = window_requests(h_out, mesh.spatial, rows)
    start, stop = owned_rows(frame, h_out)
    return fetch_rows(x, h_in, requests, mesh, dim, clamp), start, stop


def empty_rows(inputs, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A result of no rows (a rank that owns none of a layer), joined to the
    autograd graph of ``inputs`` (a tensor or a tuple), so the backward
    reaches their collectives on this rank as on the others."""
    inputs = inputs if isinstance(inputs, tuple) else (inputs,)
    anchor = sum(t.sum() for t in inputs) * 0
    return torch.zeros(shape, dtype=dtype, device=inputs[0].device) + anchor.to(dtype)


class _SumOverSpatial(torch.autograd.Function):
    """Forward: the sum over the spatial group. Backward: the sum of the
    cotangents: the result feeds every spatial rank's own rows, so each
    rank's cotangent is its part of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.clone(), mesh, mesh.spatial_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.mesh.spatial_group), None


def sum_over_spatial(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the spatial group, differentiable (a statistic of
    the whole frame that each rank then applies to its own rows)."""
    return _SumOverSpatial.apply(t, mesh)


# ---------------------------------------------------------------------------
# route 2: an explicit halo around a function of the slab


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """This rank's H-slab [B, h, W, C] with ``halo`` rows of the spatial
    neighbours above and below it (zero rows at the global edges), the
    slabs being equal: ``fetch_rows`` of ``[j*h - halo, (j+1)*h + halo)``."""
    h = x.shape[1]
    requests = [(q * h - halo, (q + 1) * h + halo) for q in range(mesh.spatial)]
    return fetch_rows(x, h * mesh.spatial, requests, mesh, dim=1)


def spatial_shard_apply(fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh, halo: int,
                        downscale: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap ``fn`` (NHWC -> NHWC, H kept up to ``downscale``, its total H
    reduction) to run H-sharded over the mesh's spatial axis with an
    explicit halo exchange. The wrapped function takes the whole frame
    batch (alike on every rank), runs this rank's slab, and returns the
    whole output, gathered from the slabs. ``halo`` must be a multiple of
    ``downscale``."""
    if halo % downscale:
        raise ValueError(f"halo {halo} not a multiple of downscale {downscale}")

    def apply(x: torch.Tensor) -> torch.Tensor:
        n, j = mesh.spatial, mesh.coords["spatial"]
        if x.shape[1] % n:
            raise ValueError(f"height {x.shape[1]} is not divisible by the spatial axis of "
                             f"{n} ranks")
        h = x.shape[1] // n
        out = fn(halo_exchange(x[:, j * h:(j + 1) * h], halo, mesh))
        crop = halo // downscale
        out = out[:, crop:out.shape[1] - crop].contiguous()
        return torch.cat(all_gather(out, mesh, mesh.spatial_group), dim=1)

    return apply
