"""The device mesh of the port: a ``torch.distributed`` process group.

The port of ``tpuseg/core/mesh.py``. The JAX package's mesh is a grid of
devices with the named axes ``("data", "spatial")`` inside one program;
here it is one process per rank, and a rank's place in the grid is
``(rank // spatial, rank % spatial)``, the order of
``devices.reshape(data, spatial)``. ``create_mesh`` builds, over the ranks
of the default process group, one group for the whole mesh and one for
each axis through this rank, so a collective over "data" or "spatial"
runs inside the ranks of that axis, as ``psum`` over an axis name does.

The mesh takes the first ``data * spatial`` ranks, as JAX's ``create_mesh``
takes the first ``data * spatial`` devices and leaves the rest idle: its
collectives run over those ranks' own group, and a rank beyond them gets a
mesh marked ``idle`` that belongs to no group (it still creates every
group, since creating one is collective over the default group);
``tpuseg_torch.main`` returns on such a rank without training.

Backends: NCCL when each rank has a card of its own, gloo when the ranks
share a card or run on the CPU (``choose_backend``). gloo stages a CUDA
tensor through host memory; the collectives below do so themselves
(``host_staged``), so every collective here runs the same way on every torch
build. A collective syncs the host with the card there, so a step that
holds one cannot be captured in a CUDA graph.

Collectives that a loss differentiates through (``sum_across``,
``gather_blocks``) feed results that every rank holds alike (the global
loss): the cotangent that reaches them on a rank is already the whole
gradient, so their backward passes it through (the sum) or keeps this
rank's block of it (the gather), and no collective runs there. See
``tpuseg_torch/train/loss.py`` for the gradient convention.

A step over a mesh with a spatial axis above one splits each image's
height over the ranks of ``spatial_group`` (``batch_slice(...,
spatial_dim=1)``); its layers fetch the rows they read from the ranks that
own them over that group (``tpuseg_torch/parallel/spatial.py``), and its
statistics, losses and gradients are summed over ``group``, the whole mesh
(``axis_group(spatial=True)``).

``launch_local(fn, world, device)`` starts ``world`` ranks on this host
(the ``spawn`` start method and a ``FileStore`` in a temporary directory,
so no TCP port is taken) and returns each rank's result; its join has a
deadline that raises and kills the ranks. It is what the tests and
``chip_smoke.py`` use, as the JAX tests use the 8-device CPU mesh.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

MESH_AXES = ("data", "spatial")


@dataclass(eq=False)
class Mesh:
    """This rank's view of a ``data x spatial`` grid of ranks.

    ``group`` is the whole mesh; ``data_group`` the ranks that share this
    rank's spatial coordinate (the "data" axis through it) and
    ``spatial_group`` those that share its data coordinate. An axis of one
    rank has no group (None): a collective over it is the identity."""

    data: int
    spatial: int
    rank: int
    backend: str
    group: Optional[Any] = None
    data_group: Optional[Any] = None
    spatial_group: Optional[Any] = None
    idle: bool = False      # a rank beyond data x spatial: in no group, no work

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "spatial": self.spatial}

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def coords(self) -> Dict[str, int]:
        return {"data": self.rank // self.spatial, "spatial": self.rank % self.spatial}

    def axis_group(self, spatial: bool = False):
        """The group of the data axis, or of the whole mesh (``spatial``):
        where a statistic over a batch sharded on data (and H) is summed."""
        return self.group if spatial else self.data_group

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, spatial={self.spatial}, rank={self.rank}, "
                f"backend={self.backend!r})")


def _new_group(ranks: List[int], world: int):
    """A group of ``ranks``; None for one rank, the default group for all."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def create_mesh(data: int = -1, spatial: int = 1) -> Mesh:
    """The ``(data, spatial)`` mesh over the first ``data * spatial`` ranks of
    the default process group (one rank when no group is initialized);
    ``data=-1`` takes every rank that ``spatial`` leaves. A rank beyond the
    mesh gets one marked ``idle``. Every rank must call it, in the same
    order as any other group creation."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if spatial <= 0:
        spatial = 1
    if data == -1:
        if n % spatial != 0:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        data = n // spatial
    size = data * spatial
    if size > n:
        raise ValueError(f"mesh {data}x{spatial} needs {size} devices, have {n}")
    mesh = Mesh(data, spatial, rank, dist.get_backend() if dist.is_initialized() else "",
                idle=rank >= size)
    if n == 1:
        return mesh
    # every rank creates every group, in one order (new_group is collective),
    # an idle rank too; it keeps none of them
    groups = [_new_group(list(range(size)), n)]
    groups += [_new_group([i * spatial + j for i in range(data)], n) for j in range(spatial)]
    groups += [_new_group([i * spatial + j for j in range(spatial)], n) for i in range(data)]
    if not mesh.idle:
        mesh.group = groups[0]
        mesh.data_group = groups[1 + mesh.coords["spatial"]]
        mesh.spatial_group = groups[1 + spatial + mesh.coords["data"]]
    return mesh


# ---------------------------------------------------------------------------
# placement


def batch_slice(mesh: Optional[Mesh], shape: Union[int, Sequence[int]],
                spatial_dim: Optional[int] = None) -> Tuple[slice, ...]:
    """The index of this rank's block of a batch of ``shape`` (or of ``n``
    rows): the batch dim split over "data", and dim ``spatial_dim`` over
    "spatial" when given. The counterpart of ``batch_sharding``."""
    dims = [int(shape)] if isinstance(shape, int) else [int(s) for s in shape]
    index = [slice(None)] * len(dims)
    if spatial_dim == 0:
        # it would overwrite the "data" split and drop data parallelism
        raise ValueError("spatial_dim must be >= 1 (dim 0 is the batch)")
    if mesh is None:
        return tuple(index)
    splits = [(0, mesh.data, mesh.coords["data"])]
    if spatial_dim is not None:
        splits.append((spatial_dim, mesh.spatial, mesh.coords["spatial"]))
    for dim, parts, at in splits:
        if dims[dim] % parts:
            raise ValueError(f"dim {dim} of size {dims[dim]} is not divisible by the "
                             f"mesh axis of {parts} ranks")
        step = dims[dim] // parts
        index[dim] = slice(at * step, (at + 1) * step)
    return tuple(index)


def host_staged(mesh: Optional[Mesh], t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through host memory (gloo, CUDA)."""
    return mesh is not None and mesh.backend == "gloo" and t.is_cuda


def all_reduce_(t: torch.Tensor, mesh: Optional[Mesh], group,
                op=None) -> torch.Tensor:
    """Sum (or ``op``) ``t`` in place over ``group``'s ranks; a CUDA tensor
    goes through host memory under gloo. No group: ``t`` unchanged."""
    if group is None:
        return t
    op = dist.ReduceOp.SUM if op is None else op
    if host_staged(mesh, t):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        with torch.no_grad():
            t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def all_gather(t: torch.Tensor, mesh: Optional[Mesh], group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on all), in the group's rank order."""
    if group is None:
        return [t]
    src = t.detach().cpu() if host_staged(mesh, t) else t.detach().contiguous()
    # gloo has no unsigned types wider than a byte: move their bits as signed
    wire = _SIGNED.get(src.dtype, src.dtype)
    out = [torch.empty_like(src, dtype=wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src.view(wire), group=group)
    return [o.view(t.dtype).to(t.device) for o in out]


def broadcast_(t: torch.Tensor, mesh: Optional[Mesh], src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` into ``t`` on every rank of the mesh."""
    if mesh is None or mesh.group is None:
        return t
    if host_staged(mesh, t):
        host = t.detach().cpu()
        dist.broadcast(host, src=src, group=mesh.group)
        with torch.no_grad():
            t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=mesh.group)
    return t


def replicate(module_or_tensors, mesh: Optional[Mesh]):
    """Rank 0's parameters and buffers (or tensors) on every rank: the
    counterpart of ``replicated_sharding``. One broadcast of them all."""
    if mesh is None or mesh.group is None:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = broadcast_(torch.cat([t.detach().reshape(-1) for t in group]), mesh)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return module_or_tensors


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# collectives a loss differentiates through


class _SumAcross(torch.autograd.Function):
    """Forward: the sum over the group's ranks. Backward: the cotangent
    unchanged: the sum is used alike on every rank, so each rank's
    cotangent is the whole gradient of the global loss with respect to
    it, and so with respect to this rank's addend."""

    @staticmethod
    def forward(ctx, t, mesh, group):
        return all_reduce_(t.clone(), mesh, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_across(t: torch.Tensor, mesh: Optional[Mesh], group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, differentiable (see _SumAcross)."""
    if group is None:
        return t
    return _SumAcross.apply(t, mesh, group)


def _block_order(mesh: Mesh, spatial: bool) -> List[Tuple[int, int]]:
    """(data, spatial) coordinates of the group's ranks, in rank order."""
    if spatial:
        return [(r // mesh.spatial, r % mesh.spatial) for r in range(mesh.size)]
    return [(i, mesh.coords["spatial"]) for i in range(mesh.data)]


def _assemble(blocks: List[torch.Tensor], mesh: Mesh, spatial: bool,
              spatial_dim: int) -> torch.Tensor:
    order = _block_order(mesh, spatial)
    rows = []
    for i in range(mesh.data):
        if spatial:
            row = [b for (di, _), b in zip(order, blocks) if di == i]
            rows.append(torch.cat(row, dim=spatial_dim))
        else:
            rows.append(blocks[i])
    return torch.cat(rows, dim=0)


class _GatherBlocks(torch.autograd.Function):
    """Forward: the global tensor from every rank's block. Backward: this
    rank's block of the cotangent (the global tensor is used alike on every
    rank, so its cotangent there is already the whole gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, spatial, spatial_dim):
        group = mesh.axis_group(spatial)
        out = _assemble(all_gather(t, mesh, group), mesh, spatial, spatial_dim)
        ctx.index = batch_slice(mesh, out.shape, spatial_dim if spatial else None)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None, None


def gather_blocks(t: torch.Tensor, mesh: Optional[Mesh], spatial: bool = False,
                  spatial_dim: int = 1) -> torch.Tensor:
    """The global batch from the blocks that ``batch_slice`` gave each rank:
    rows over "data", and dim ``spatial_dim`` over "spatial" when
    ``spatial``. Differentiable (see _GatherBlocks)."""
    if mesh is None or mesh.axis_group(spatial) is None:
        return t
    return _GatherBlocks.apply(t, mesh, spatial, spatial_dim)


# ---------------------------------------------------------------------------
# process groups


def choose_backend(device: torch.device, local_world: int) -> Tuple[str, torch.device]:
    """(backend, this rank's device): NCCL when each of the host's
    ``local_world`` ranks has a card of its own, gloo when they share one
    card (``cuda:0``) or run on the CPU."""
    if device.type != "cuda":
        return "gloo", torch.device("cpu")
    if torch.cuda.device_count() >= local_world > 0:
        return "nccl", torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return "gloo", torch.device("cuda", 0)


def maybe_initialize_distributed(device: torch.device) -> Optional[torch.device]:
    """Join torchrun's process group when launched under it (``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR`` set; ``env://`` rendezvous) and
    return this rank's device; None (no group started) otherwise, or when
    a group is already initialized. The counterpart of
    ``jax.distributed.initialize``."""
    if dist.is_initialized() or not all(
            k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return None
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    os.environ.setdefault("LOCAL_RANK", os.environ["RANK"])
    backend, dev = choose_backend(device, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world)
    if dist.get_rank() == 0:
        log.info("mesh: %d ranks over %s on %s", world, backend,
                 "one card each" if backend == "nccl" else dev)
    return dev


def _rank_entry(fn, rank: int, world: int, device: str, store_dir: str, results,
                timeout_s: float) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(store_dir, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        backend, dev = choose_backend(torch.device(device), world)
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                                              world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_local(fn: Callable, world: int, device: str = "cpu", timeout_s: float = 300.0,
                 args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(rank_device, *args)`` on ``world`` ranks of this host, each
    in a spawned process that has joined one process group, and return
    their results in rank order. ``fn`` and ``args`` must pickle (``fn``
    by its import path: put it in a module that a fresh interpreter can
    import cheaply). A rank that raises or exits fails the launch with its
    traceback; past ``timeout_s`` the launch raises TimeoutError. Either
    way every rank still running is killed."""
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="tpuseg_mesh_")
    # the arguments go through a file: a start() that pipes megabytes to a
    # rank which dies before reading them would block for good
    with open(os.path.join(store_dir, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, device, store_dir, results, timeout_s))
             for r in range(world)]
    done: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch_local: ranks {sorted(set(range(world)) - set(done))}"
                                   f" gave no result within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"launch_local: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"launch_local: rank {rank} failed:\n{value}")
            done[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [done[r] for r in range(world)]
