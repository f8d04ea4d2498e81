"""Spatial parallelism: image-height sharding with an explicit halo exchange.

The port of ``tpuseg/parallel/spatial.py`` (its route 2): each rank of the
mesh's "spatial" axis holds an H-slab of the frame, takes ``halo``
boundary rows from each neighbour (two neighbour shifts; zero rows at the
global edges), runs ``fn`` on the padded slab and crops. With ``halo`` at
least ``fn``'s receptive-field half-width,

    spatial_shard_apply(fn)(x) == crop(fn(zero_pad_H(x, halo)))

so the slab boundaries inside the frame are exact against the unsharded
forward; the outermost rows of the frame see one input-level zero
extension in place of per-layer padding, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from tpuseg_torch.core.mesh import Mesh, host_staged, all_gather


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """This rank's H-slab [B, h, W, C] with ``halo`` rows of each neighbour
    along the spatial axis above and below it (zero rows at the global
    edges): the previous rank's last rows and the next rank's first ones."""
    n, j = mesh.spatial, mesh.coords["spatial"]
    top, bot = x[:, :halo].contiguous(), x[:, -halo:].contiguous()
    from_above, from_below = torch.zeros_like(bot), torch.zeros_like(top)
    if n > 1:
        # the spatial neighbours are the adjacent global ranks (rank = i * S + j)
        pairs = []
        if j > 0:
            pairs.append((top, from_above, mesh.rank - 1))
        if j < n - 1:
            pairs.append((bot, from_below, mesh.rank + 1))
        stage = host_staged(mesh, x)
        host = [(s.cpu(), r.cpu(), peer) if stage else (s, r, peer) for s, r, peer in pairs]
        ops = [op for s, r, peer in host for op in (dist.P2POp(dist.isend, s, peer),
                                                    dist.P2POp(dist.irecv, r, peer))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if stage:
            for (_, dst, _), (_, got, _) in zip(pairs, host):
                dst.copy_(got)
    return torch.cat([from_above, x, from_below], dim=1)


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
