"""Rank workers for tests/test_torch_port_mesh.py.

``core.mesh.launch_local`` spawns each rank as a fresh interpreter that
imports the worker by its module path. This module imports neither JAX nor
the JAX package, so a rank starts in the time torch takes to import; the
test module computes the JAX oracles in its own process and passes every
input here as numpy arrays. Each worker returns numpy arrays, and the
test assembles the ranks' blocks.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from tpuseg_torch.core.mesh import barrier, batch_slice, create_mesh, sum_across

LOSS_NAMES = ("ce", "focal", "dice", "ce+dice", "lovasz", "ce+lovasz")
# the pure surrogates refuse class weights (as the JAX factory does)
WEIGHTED = ("ce", "focal", "ce+dice", "ce+lovasz")


def params_digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes: equal digests on two
    ranks mean bit-equal states."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _local_grad(fn, logits: np.ndarray, targets: np.ndarray, index):
    lg = torch.from_numpy(logits[index]).requires_grad_(True)
    v = fn(lg, torch.from_numpy(targets[index[:3]]))
    v.backward()
    return float(v.detach()), lg.grad.numpy()


def suite(device, inputs: dict) -> dict:
    """Every check of one rank group: the module's functions on ``inputs``
    (keyed by function name: its arguments after ``device``)."""
    return {name: globals()[name](device, *args) for name, args in inputs.items()}


def sharded_lovasz(device, data: int, spatial: int, logits, targets):
    """The sharded Lovász on this rank's block, spatial off and on (where
    the mesh has a spatial axis), ignore_index None and 255:
    {(spatial, ignore): (value, local grad, block index)}."""
    from tpuseg_torch.ops.lovasz import make_sharded_lovasz

    mesh = create_mesh(data, spatial)
    out = {}
    for sp in ((False, True) if spatial > 1 else (False,)):
        index = batch_slice(mesh, logits.shape, 1 if sp else None)
        for ign in (None, 255):
            out[(sp, ign)] = (*_local_grad(make_sharded_lovasz(mesh, sp, ign), logits,
                                           targets, index), index)
    return out


def losses(device, logits, targets, weights, data: int = 2, spatial: int = 1):
    """Every loss name over a ``data x spatial`` mesh (H sharded too where
    ``spatial`` > 1), with class weights where the loss takes them and
    ignore_index 255, and the Lovász at 64 and 0 bins: {name: (value,
    local logits grad, block index)}."""
    from tpuseg_torch.train.loss import make_loss_fn

    mesh = create_mesh(data, spatial)
    sp = spatial > 1
    index = batch_slice(mesh, logits.shape, 1 if sp else None)
    out = {}
    cases = [(name, name, 256) for name in LOSS_NAMES] + [
        ("lovasz@64", "lovasz", 64), ("lovasz@0", "lovasz", 0)]
    for key, name, bins in cases:
        fn = make_loss_fn(name, class_weights=weights if name in WEIGHTED else None,
                          ignore_index=255, lovasz_bins=bins, mesh=mesh, spatial=sp)
        out[key] = (*_local_grad(fn, logits, targets, index), index)
    return out


def batchnorm(device, x: np.ndarray, r: np.ndarray, weight, bias):
    """A BatchNorm2d with global statistics over a world-2 data mesh: y,
    the input gradient of the global sum of y * r, this rank's parts of
    the affine gradients and the moved running statistics."""
    from tpuseg_torch.models.blocks import BatchNorm2d, set_mesh

    mesh = create_mesh(2, 1)
    bn = BatchNorm2d(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    set_mesh(bn, mesh).train()
    rows = batch_slice(mesh, x.shape[0])[0]
    xl = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(xl)
    loss = sum_across((y * torch.from_numpy(r[rows])).sum(), mesh, mesh.data_group)
    loss.backward()
    return dict(rows=rows, y=y.detach().numpy(), dx=xl.grad.numpy(),
                dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(), running_var=bn.running_var.numpy(),
                loss=float(loss.detach()))


def clip(device, grads, clip_norm: float, lr: float):
    """sum_grads then the global-norm clip and one SGD update, from this
    rank's share of the gradient (``grads[rank]``)."""
    from tpuseg_torch.train.optim import Optimizer

    mesh = create_mesh(2, 1)
    params = [torch.nn.Parameter(torch.zeros(g.shape, dtype=torch.float64))
              for g in grads[mesh.rank]]
    for p, g in zip(params, grads[mesh.rank]):
        p.grad = torch.from_numpy(g.copy())
    opt = Optimizer(params, optimizer="sgd", lr=lr, momentum=0.0, clip_norm=clip_norm)
    opt.sum_grads(mesh)
    summed = [p.grad.numpy().copy() for p in params]
    opt.step()
    return summed, [p.detach().numpy() for p in params]


def trajectory(device, state: dict, batches, width: float, lr: float):
    """3 f64 train steps over a world-2 data mesh from ``state`` (the
    port's state_dict as numpy) on the global ``batches``, materialized
    decoder, for the CE and the Lovász: {loss: (losses, final state_dict,
    digest)}."""
    return {loss: _trajectory(state, batches, loss, width, lr) for loss in ("ce", "lovasz")}


def _trajectory(state: dict, batches, loss: str, width: float, lr: float):
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.blocks import set_mesh
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.train.loss import make_loss_fn
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step

    mesh = create_mesh(2, 1)
    model = build_model(ModelConfig(width_mult=width, up_subpixel=False)).to(torch.float64)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    set_mesh(model, mesh)
    step = make_train_step(model, Optimizer(model.parameters(), lr=lr),
                           loss_fn=make_loss_fn(loss, mesh=mesh), mesh=mesh)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
              for x, y in batches]
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}, params_digest(model)


def trainer(device, argv, ck: str):
    """A world-2 Trainer run through the entry point, then a fresh
    Trainer on every rank resuming rank 0's checkpoint: the run's history
    and losses, the files rank 0 wrote, and digests of the trained, saved
    and resumed states."""
    from tpuseg_torch.main import main
    from tpuseg_torch.train.trainer import Trainer

    tr = main(["--platform=cpu", *argv, f"--train.checkpoint_dir={ck}"])
    trained = params_digest(tr.model)
    barrier(tr.mesh)
    files = sorted(os.listdir(ck))
    again = Trainer(tr.cfg, device="cpu")
    resumed = again.maybe_resume()
    return dict(rank=tr.mesh.rank, history=tr.history, losses=tr.step_losses, step=tr.step,
                trained=trained, files=files, resumed=resumed, resumed_step=again.step,
                resumed_digest=params_digest(again.model),
                sampler=again.pipeline.state() == tr.pipeline.state())


def bf16_trainer(device, argv):
    """A world-2 Trainer run in bf16 with a bf16 mu and bf16 gradients:
    the losses, the parameters' digest and the state's dtypes."""
    from tpuseg_torch.main import main

    tr = main(["--platform=cpu", *argv, "--model.compute_dtype=bfloat16",
               "--train.mu_dtype=bfloat16", "--train.grads_bf16=true",
               "--train.checkpoint_dir="])
    return dict(losses=tr.step_losses, trained=params_digest(tr.model),
                mu={str(t.dtype) for t in tr.optimizer.state["mu"]},
                params={str(p.dtype) for p in tr.model.parameters()})


def predictor(device, frames, width: float, hw):
    """A Predictor over a world-2 data mesh on the whole batch of
    ``frames``: the class maps, then (colorize on) the class maps and
    packed colours, every rank's."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.infer.predictor import Predictor

    mesh = create_mesh(2, 1)
    kw = dict(input_hw=hw, batch_size=frames.shape[0], mesh=mesh, device="cpu")
    plain = Predictor(ModelConfig(width_mult=width), **kw)(frames)
    classes, colours = Predictor(ModelConfig(width_mult=width), colorize_on_device=True,
                                 **kw)(frames)
    return plain, classes, colours


def spatial(device, x_rows, x_stack, kernels, x_wide, wide_kernel):
    """The halo exchange and spatial_shard_apply over a 2x2 mesh's spatial
    axis: the padded slab of rows, a 3-conv stack at halo 4, and one 9x9
    conv at halo 1 (too small)."""
    import torch.nn.functional as F

    from tpuseg_torch.parallel.spatial import halo_exchange, spatial_shard_apply

    mesh = create_mesh(2, 2)
    h = x_rows.shape[1] // mesh.spatial
    j = mesh.coords["spatial"]
    slab = torch.from_numpy(x_rows[:, j * h:(j + 1) * h])
    rows = halo_exchange(slab, 2, mesh).numpy()

    def conv(x, k):       # NHWC, HWIO, SAME
        w = torch.from_numpy(k).permute(3, 2, 0, 1)
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=k.shape[0] // 2).permute(0, 2, 3, 1)

    def stack(x):
        for k in kernels:
            x = torch.relu(conv(x, k))
        return x

    out = spatial_shard_apply(stack, mesh, halo=4)(torch.from_numpy(x_stack)).numpy()
    wide = spatial_shard_apply(lambda x: conv(x, wide_kernel), mesh, halo=1)(
        torch.from_numpy(x_wide)).numpy()
    return dict(coords=mesh.coords, rows=rows, stack=out, wide=wide)


def fetch(device, cases):
    """``fetch_rows`` over a 2x2 mesh's spatial axis, in float64: for each
    case ``(layers, halo, clamp, weights)`` (one [B, h, W, C] layer per data
    row) this rank's rows ``[start - halo, stop + halo)`` of its data row's
    layer, and the gradient of the global sum of each rank's rows times
    its ``weights`` with respect to this rank's owned slab."""
    from tpuseg_torch.parallel.spatial import fetch_rows, owned, window_requests

    mesh = create_mesh(2, 2)
    i, j = mesh.coords["data"], mesh.coords["spatial"]
    out = []
    for layers, halo, clamp, weights in cases:
        layer = layers[i]
        h = layer.shape[1]
        start, stop = owned(h, mesh.spatial, j)
        x = torch.from_numpy(layer[:, start:stop].copy()).requires_grad_(True)
        requests = window_requests(h, mesh.spatial, lambda s, e: (s - halo, e + halo))
        rows = fetch_rows(x, h, requests, mesh, dim=1, clamp=clamp)
        (rows * torch.from_numpy(weights[i][j])).sum().backward()
        out.append(dict(rows=rows.detach().numpy(), grad=x.grad.numpy(), start=start,
                        stop=stop, request=requests[j]))
    return out


def _spatial_model(kw: dict, state: dict):
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.blocks import set_mesh
    from tpuseg_torch.models.registry import build_model

    mesh = create_mesh(2, 2)
    model = build_model(ModelConfig(**kw)).to(torch.float64)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return mesh, set_mesh(model, mesh)


def spatial_trajectory(device, state: dict, batches, width: float, lr: float):
    """3 f64 train steps of the flagship (materialized decoder) over a 2x2
    mesh with the image height sharded (``spatial=True``), for the CE and
    the Lovász: {loss: (losses, final state_dict, digest)}."""
    from tpuseg_torch.train.loss import make_loss_fn
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step

    out = {}
    for loss in ("ce", "lovasz"):
        mesh, model = _spatial_model(dict(width_mult=width, up_subpixel=False), state)
        step = make_train_step(model, Optimizer(model.parameters(), lr=lr),
                               loss_fn=make_loss_fn(loss, mesh=mesh, spatial=True), mesh=mesh,
                               spatial=True)
        losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
                  for x, y in batches]
        out[loss] = (losses, {k: v.numpy() for k, v in model.state_dict().items()},
                     params_digest(model))
    return out


def spatial_families(device, cases: dict, lr: float):
    """One f64 spatial train step of each family over a 2x2 mesh:
    {name: family_step's result}."""
    mesh = create_mesh(2, 2)
    return {name: family_step(*case, lr, mesh) for name, case in cases.items()}


def family_step(kw: dict, state: dict, loss_name: str, opts: dict, x, y, lr: float,
                mesh=None):
    """One f64 train step of a family from ``state`` on the global batch
    (x, y), over ``mesh`` with the image height sharded when given, with
    ``opts``: ``remat``, ``qat`` (every conv+BatchNorm conv), ``teacher``
    ((config, state): distilled at alpha 0.5, T 2). Returns (loss, the
    (summed) gradients, the state after the update, its digest). The
    models are channels_last, as the Trainer's."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.blocks import set_mesh
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.ops.fake_quant import set_qat
    from tpuseg_torch.train.distill import make_distill_loss, make_teacher_fn
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step

    def load(kw, state):
        # channels_last, as the Trainer runs it: a slab of one row is both
        # layouts, so the ranks' layouts differ where a layer is uneven
        model = build_model(ModelConfig(**kw)).to(torch.float64).to(
            memory_format=torch.channels_last)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        return model

    model = set_mesh(load(kw, state), mesh)
    if opts.get("qat"):
        set_qat(model)
    loss_fn, teacher_fn = family_loss(loss_name, mesh), None
    if "teacher" in opts:
        teacher_fn = make_teacher_fn(load(*opts["teacher"]))
        loss_fn = make_distill_loss(loss_fn, 0.5, 2.0, mesh=mesh, spatial=mesh is not None)
    step = make_train_step(model, Optimizer(model.parameters(), lr=lr), loss_fn=loss_fn,
                           mesh=mesh, spatial=mesh is not None,
                           remat=opts.get("remat", False), teacher_fn=teacher_fn)
    loss = float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
    return (loss, {n: p.grad.numpy() for n, p in model.named_parameters()},
            {k: v.numpy() for k, v in model.state_dict().items()}, params_digest(model))


def family_loss(name: str, mesh=None):
    """``make_loss_fn(name)``, or for "mse" (a one-channel model, whose
    softmax losses are constant) the mean squared error of its logit
    against the label: the global batch's over ``mesh`` with H sharded."""
    from tpuseg_torch.train.loss import _global, make_loss_fn

    if name != "mse":
        return make_loss_fn(name, mesh=mesh, spatial=mesh is not None)

    def mse(logits, labels):
        err = (logits[..., 0] - labels.to(logits.dtype)) ** 2
        num, den = _global(mesh, True, err.sum(), err.new_full((), err.numel()))
        return num / den

    return mse


def spatial_trainer(device, argv):
    """A Trainer run through the entry point over a 2x2 mesh with the image
    height sharded: its history, losses and digest; then the same flags at
    height 15, which must raise before the model is built."""
    from tpuseg_torch.main import main

    tr = main(["--platform=cpu", *argv, "--train.checkpoint_dir="])
    try:
        main(["--platform=cpu", *argv, "--train.checkpoint_dir=", "--data.height=15"])
        raised = None
    except ValueError as e:
        raised = str(e)
    return dict(history=tr.history, losses=tr.step_losses, step=tr.step,
                trained=params_digest(tr.model), spatial=tr.spatial, raised=raised)


def fail_on_rank1(device):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    mesh = create_mesh(2, 1)
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    barrier(mesh)


def hang_on_rank1(device, seconds: float):
    """Rank 1 sleeps past the launch's deadline; rank 0 waits for it."""
    import time

    mesh = create_mesh(2, 1)
    if mesh.rank == 1:
        time.sleep(seconds)
    barrier(mesh)


def sharded_lovasz_card(device, logits, targets):
    """The sharded Lovász's kernel route on this rank's rows, on the card
    (two ranks sharing one over gloo): (value, coef, grad, rows, launches)."""
    from tpuseg_torch.ops import kernels
    from tpuseg_torch.ops.lovasz import lovasz_histograms, lovasz_lookup, sharded_lovasz_parts

    mesh = create_mesh(2, 1)
    rows = batch_slice(mesh, logits.shape[0])[0]
    kernels.reset_launches()
    value, coef, grad = sharded_lovasz_parts(
        torch.from_numpy(logits[rows]).to(device), torch.from_numpy(targets[rows]).to(device),
        mesh, False, None, lovasz_histograms, lovasz_lookup)
    return (float(value), coef.cpu().numpy(), grad.cpu().numpy(), rows,
            {k: v for k, v in kernels.launches.items() if v})



def fused_lovasz_card(device, logits, targets):
    """The fused Lovász region on this rank's rows, on the card (two ranks
    sharing one over gloo): (value, global histograms, grad, rows,
    launches)."""
    from tpuseg_torch.ops import kernels
    from tpuseg_torch.ops.lovasz import lovasz_logits_parts

    mesh = create_mesh(2, 1)
    rows = batch_slice(mesh, logits.shape[0])[0]
    kernels.reset_launches()
    value, hist, grad = lovasz_logits_parts(
        torch.from_numpy(logits[rows]).to(device), torch.from_numpy(targets[rows]).to(device),
        mesh, False, None)
    return (float(value), hist.cpu().numpy(), grad.cpu().numpy(), rows,
            {k: v for k, v in kernels.launches.items() if v})

def qat_distill(device, state: dict, teacher_state: dict, batches, base_filters: int,
                lr: float):
    """f64 train steps of a UNet over a world-2 data mesh with QAT on and a
    UNet teacher distilled at alpha 0.5, T 2 (CE base, ignore_index 255):
    (losses, final state_dict, digest)."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.blocks import set_mesh
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.ops.fake_quant import set_qat
    from tpuseg_torch.train.distill import make_distill_loss, make_teacher_fn
    from tpuseg_torch.train.loss import make_loss_fn
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step

    mesh = create_mesh(2, 1)
    model, teacher = (build_model(ModelConfig(name="unet", base_filters=base_filters))
                      .to(torch.float64) for _ in range(2))
    for m, sd in ((model, state), (teacher, teacher_state)):
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    set_qat(set_mesh(model, mesh))
    loss = make_distill_loss(make_loss_fn("ce", ignore_index=255, mesh=mesh), 0.5, 2.0,
                             ignore_index=255, mesh=mesh)
    step = make_train_step(model, Optimizer(model.parameters(), lr=lr), loss_fn=loss,
                           mesh=mesh, teacher_fn=make_teacher_fn(teacher))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
              for x, y in batches]
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}, params_digest(model)


def idle_or_trained(device, argv):
    """``tpuseg_torch.main`` on this rank: 0 where the mesh leaves the rank
    idle, else its losses and the digest of its trained state."""
    from tpuseg_torch.main import main

    out = main(["--platform=cpu", *argv])
    if out == 0:
        return 0
    return dict(losses=out.step_losses, trained=params_digest(out.model), mesh=str(out.mesh))
