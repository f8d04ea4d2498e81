"""The Trainer's step options in the port (tpuseg_torch/train/optim.py,
tpuseg_torch/train/train_step.py) against the JAX package's.

3-step trajectories in float64 at the settings of
tests/test_torch_port_train.py (mobilenetv2_unet at width_mult 0.25,
64x128, batch 2, the same Flax init with non-trivial BatchNorm statistics
in both packages, made once: ``_variables`` caches it; augment off):
losses at rtol 1e-9, parameters (and the EMA) at rtol 1e-6 / atol 1e-8,
BatchNorm running statistics at rtol 1e-9.
The JAX side builds its optax chain with the JAX Trainer's own
``_build_optimizer`` from the same flags that build the port's
``build_optimizer``, and runs JAX's ``make_train_step`` (or
``make_train_multi_step``) with its remat and EMA options.

Then the eval step's TTA ladder against JAX's ``make_eval_step`` on a
padded last batch (f32: the confusion matrices equal, the loss sum at rtol
1e-5), and debug_nans in both packages. On the CPU no step is captured;
the captured route is held to the eager one on the card by chip_smoke.py.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import (BATCH, HW, WIDTH, _FlaxUNetF64Head, _variables)
from tpuseg.configs import load_config as jax_load_config
from tpuseg.models.mobilenetv2_unet import MobileNetV2UNet as FlaxUNet
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg.train.train_step import TrainState
from tpuseg.train.train_step import make_eval_step as jax_make_eval_step
from tpuseg.train.train_step import make_train_multi_step as jax_make_train_multi_step
from tpuseg.train.train_step import make_train_step as jax_make_train_step
from tpuseg.train.trainer import Trainer as JaxTrainer
from tpuseg_torch.configs import ModelConfig, load_config
from tpuseg_torch.core import graphs
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.train.loss import make_loss_fn
from tpuseg_torch.train.optim import Optimizer, build_optimizer
from tpuseg_torch.train.train_step import (make_eval_step, make_step_body,
                                           make_train_multi_step, make_train_step)

LR = 1e-3
TOTAL = 6           # the cosine horizon: epochs * steps_per_epoch below
BASE = ["--train.epochs=2", "--train.steps_per_epoch=3", f"--train.lr={LR}"]
# case -> (flags, loss, steps)
CASES = {
    "adamw": (["--train.optimizer=adamw", "--train.weight_decay=0.05"], "ce", 3),
    "sgd_momentum": (["--train.optimizer=sgd", "--train.momentum=0.9", "--train.lr=0.05"],
                     "ce", 3),
    "cosine_warmup": (["--train.lr_schedule=cosine", "--train.warmup_steps=2"], "ce", 3),
    "grad_clip": (["--train.optimizer=sgd", "--train.momentum=0.0", "--train.lr=0.1",
                   "--train.grad_clip_norm=0.05"], "ce", 3),
    "grad_accum": (["--train.grad_accum=2"], "ce", 3),
    "ema": (["--train.ema_decay=0.5"], "ce", 3),
    "ema_grad_accum": (["--train.ema_decay=0.5", "--train.grad_accum=2"], "ce", 3),
    "remat": (["--train.remat=true"], "lovasz", 3),
    "steps_per_dispatch": (["--train.steps_per_dispatch=2"], "lovasz", 4),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads (the suite runs several workers on a few cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batches(seed, dtype, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, *HW, 3).astype(dtype), rng.randint(0, 10, (BATCH, *HW)))
            for _ in range(n)]


def _jax_tx(flags):
    """The JAX Trainer's optax chain for ``flags`` (plain Adam when it
    builds none, as create_train_state then does)."""
    import optax

    cfg = jax_load_config(BASE + flags)
    fake = types.SimpleNamespace(cfg=cfg, steps_per_epoch=lambda: cfg.train.steps_per_epoch)
    tx = JaxTrainer._build_optimizer(fake)
    return cfg.train, tx or optax.adam(cfg.train.lr, b1=cfg.train.b1, b2=cfg.train.b2,
                                       eps=cfg.train.eps)


def _jax_run(variables, batches, flags, loss):
    t, tx = _jax_tx(flags)
    fm = _FlaxUNetF64Head(output_channels=10, width_mult=WIDTH, up_subpixel=False,
                          dtype=jnp.float64)
    cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
    params = cast(variables["params"])
    state = TrainState.create(apply_fn=fm.apply, params=params,
                              batch_stats=cast(variables["batch_stats"]), tx=tx,
                              ema_params=cast(variables["params"]) if t.ema_decay > 0 else None)
    kw = dict(donate=False, loss_fn=jax_make_loss_fn(loss), remat=t.remat,
              ema_decay=t.ema_decay)
    k = t.steps_per_dispatch
    losses = []
    if k > 1:
        step = jax_make_train_multi_step(k, **kw)
        for i in range(0, len(batches), k):
            xs = jnp.stack([jnp.asarray(x) for x, _ in batches[i:i + k]])
            ys = jnp.stack([jnp.asarray(y) for _, y in batches[i:i + k]])
            state, m = step(state, xs, ys, jnp.zeros((k, 2), jnp.uint32))
            losses += np.asarray(m["loss"]).tolist()
    else:
        step = jax_make_train_step(**kw)
        for x, y in batches:
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(m["loss"]))
    want = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats},
                                dtype=torch.float64)
    ema = None
    if state.ema_params is not None:
        ema = state_dict_from_flax({"params": state.ema_params,
                                    "batch_stats": state.batch_stats}, dtype=torch.float64)
    return losses, want, ema


def _port_model(variables, dtype=torch.float64, subpixel=False):
    model = build_model(ModelConfig(width_mult=WIDTH, up_subpixel=subpixel)).to(dtype)
    model.load_state_dict(state_dict_from_flax(variables, dtype=dtype), strict=True)
    return model


def _port_run(variables, batches, flags, loss):
    """(losses, state_dict, ema or None, the parameters after each dispatch)."""
    t = load_config(BASE + flags).train
    model = _port_model(variables)
    opt = build_optimizer(model, t, TOTAL)
    kw = dict(loss_fn=make_loss_fn(loss), remat=t.remat)
    k = t.steps_per_dispatch
    step = make_train_multi_step(k, model, opt, **kw) if k > 1 else \
        make_train_step(model, opt, **kw)
    losses, after = [], []
    for i in range(0, len(batches), k):
        group = batches[i:i + k]
        if k > 1:
            xs = torch.stack([torch.from_numpy(x) for x, _ in group])
            ys = torch.stack([torch.from_numpy(y) for _, y in group])
            losses += step(xs, ys)["loss"].tolist()
        else:
            losses.append(float(step(torch.from_numpy(group[0][0]),
                                     torch.from_numpy(group[0][1]))["loss"]))
        after.append({n: p.detach().clone() for n, p in model.named_parameters()})
    ema = opt.ema_state_dict(model) if t.ema_decay > 0 else None
    return losses, model.state_dict(), ema, after, opt


def _assert_state(got, want, keys=None):
    n_stats = 0
    for k in keys or want:
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].detach().numpy(), want[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10, err_msg=k)
            n_stats += 1
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8, err_msg=k)
    return n_stats


@pytest.mark.parametrize("case", list(CASES))
def test_f64_trajectory_with_option_matches_jax(case):
    flags, loss, steps = CASES[case]
    variables, batches = _variables(), _batches(3, np.float64, steps)
    jax.config.update("jax_enable_x64", True)
    try:
        want_losses, want, want_ema = _jax_run(variables, batches, flags, loss)
    finally:
        jax.config.update("jax_enable_x64", False)
    got_losses, got, got_ema, after, opt = _port_run(variables, batches, flags, loss)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-9)
    assert _assert_state(got, want) > 100
    if want_ema is not None:
        _assert_state(got_ema, want_ema, keys=list(got_ema))
    init = state_dict_from_flax(variables, dtype=torch.float64)
    moved = lambda i: any(not torch.equal(after[i][n], init[n]) for n in after[i])
    if case == "cosine_warmup":       # optax's warmup starts at lr 0
        assert not moved(0) and moved(1)
    if case in ("grad_accum", "ema_grad_accum"):   # MultiSteps applies every 2nd
        assert not moved(0) and moved(1)
        assert int(opt.state["count"]) == 1 and int(opt.state["mini_step"]) == 1
    if case == "ema_grad_accum":
        assert got_ema is not None
    if case == "grad_clip":
        # the clip acted: the last step's raw gradient norm exceeds the bound
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in opt.params))
        assert float(norm) > 0.05


def test_ema_moves_only_on_micro_step_boundaries():
    """ema = d*ema + (1-d)*params once per applied update: frozen on the
    first micro-step of two, one application on the second (the JAX
    package's test_ema_with_grad_accum_updates_on_boundaries_only)."""
    variables, batches = _variables(), _batches(4, np.float64, 2)
    model = _port_model(variables)
    opt = build_optimizer(model, load_config(
        BASE + ["--train.ema_decay=0.5", "--train.grad_accum=2"]).train, TOTAL)
    step = make_train_step(model, opt)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(*map(torch.from_numpy, batches[0]))
    ema = opt.ema_state_dict(model)
    assert all(torch.equal(ema[n], p0[n]) for n in p0)
    step(*map(torch.from_numpy, batches[1]))
    p1 = dict(model.named_parameters())
    ema = opt.ema_state_dict(model)
    for n in p0:
        torch.testing.assert_close(ema[n], 0.5 * p0[n] + 0.5 * p1[n].detach(),
                                   rtol=1e-12, atol=0)


def test_remat_equals_the_step_without_it():
    """remat recomputes the forward in the backward: the same losses,
    parameters and BatchNorm statistics (the statistics move once)."""
    variables, batches = _variables(), _batches(5, np.float64, 2)
    runs = [_port_run(variables, batches, flags, "ce")
            for flags in ([], ["--train.remat=true"])]
    (la, sa, *_), (lb, sb, *_) = runs
    np.testing.assert_allclose(lb, la, rtol=1e-12)
    for k in sa:
        torch.testing.assert_close(sb[k], sa[k], rtol=1e-12, atol=1e-15, msg=k)


def test_steps_per_dispatch_equals_single_steps():
    variables, batches = _variables(), _batches(6, np.float64, 4)
    la, sa, *_ = _port_run(variables, batches, [], "lovasz")
    lb, sb, *_ = _port_run(variables, batches, ["--train.steps_per_dispatch=2"], "lovasz")
    assert lb == la
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_eager_context_and_cpu_path_equal_the_plain_step():
    """On the CPU the captured step runs its body; graphs.eager() runs it
    too: the three routes give the same numbers from the same state."""
    variables, batches = _variables(), _batches(7, np.float64, 2)
    results = []
    for route in ("body", "step", "eager"):
        model = _port_model(variables)
        opt = build_optimizer(model, load_config(BASE).train, TOTAL)
        if route == "body":
            run = make_step_body(model, opt)
        else:
            step = make_train_step(model, opt)
            run = lambda x, y, step=step: step(x, y)["loss"]
        losses = []
        with graphs.eager() if route == "eager" else contextlib.nullcontext():
            for x, y in batches:
                losses.append(float(run(torch.from_numpy(x), torch.from_numpy(y))))
        results.append((losses, model.state_dict()))
    for losses, sd in results[1:]:
        assert losses == results[0][0]
        assert all(torch.equal(sd[k], results[0][1][k]) for k in sd)
    assert not graphs.is_eager()
    with graphs.eager():
        with graphs.eager():
            assert graphs.is_eager()
        assert graphs.is_eager()
    assert not graphs.is_eager()


def test_clip_update_is_the_scaled_gradient():
    """SGD(lr=1) with the clip at 0.5 and a gradient of norm 5: the update
    is exactly -g * 0.5/5 (the JAX package's test_grad_clip_norm)."""
    w = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    opt = Optimizer([w], optimizer="sgd", lr=1.0, momentum=0.0, clip_norm=0.5)
    w.grad = torch.tensor([3.0, 4.0, 0.0], dtype=torch.float64)
    opt.step()
    torch.testing.assert_close(w.detach(), -torch.tensor([3.0, 4.0, 0.0],
                                                         dtype=torch.float64) * 0.1)


def test_optimizer_state_loads_in_place():
    """load_state_dict copies into the tensors a captured step points at."""
    w = torch.nn.Parameter(torch.ones(4))
    opt = Optimizer([w], optimizer="adamw", lr_schedule="cosine", warmup_steps=1,
                    total_steps=5, accum=2, ema_decay=0.9)
    before = [id(t) for t in (opt.state["count"], *opt.state["mu"], *opt.state["acc"])]
    for _ in range(3):
        w.grad = torch.full((4,), 0.5)
        opt.step()
    saved = {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
             for k, v in opt.state_dict().items()}
    assert "ema" not in saved and int(saved["count"]) == 1
    fresh = Optimizer([torch.nn.Parameter(torch.ones(4))], optimizer="adamw",
                      lr_schedule="cosine", warmup_steps=1, total_steps=5, accum=2,
                      ema_decay=0.9)
    ids = [id(t) for t in (fresh.state["count"], *fresh.state["mu"], *fresh.state["acc"])]
    fresh.load_state_dict(saved)
    assert [id(t) for t in (fresh.state["count"], *fresh.state["mu"],
                            *fresh.state["acc"])] == ids
    assert all(torch.equal(a, b) for a, b in zip(fresh.state["mu"], opt.state["mu"]))
    assert before == [id(t) for t in (opt.state["count"], *opt.state["mu"],
                                      *opt.state["acc"])]
    with pytest.raises(KeyError, match="optimizer state lacks"):
        Optimizer([torch.nn.Parameter(torch.ones(4))], optimizer="sgd").load_state_dict(saved)


def test_cosine_schedule_equals_optax():
    import optax

    sched = optax.warmup_cosine_decay_schedule(0.0, 0.01, 3, 11)
    opt = Optimizer([torch.nn.Parameter(torch.zeros(1))], lr=0.01, lr_schedule="cosine",
                    warmup_steps=3, total_steps=11)
    got = [float(opt.learning_rate(torch.tensor(c), torch.float64)) for c in range(14)]
    np.testing.assert_allclose(got, [float(sched(c)) for c in range(14)], rtol=1e-6,
                               atol=1e-12)
    with pytest.raises(ValueError, match="cosine decay needs"):
        Optimizer([torch.nn.Parameter(torch.zeros(1))], lr_schedule="cosine",
                  warmup_steps=4, total_steps=4)


@pytest.mark.parametrize("tta", ["", "flip", "ms", "flip+ms"])
def test_eval_step_tta_matches_jax_on_a_padded_batch(tta):
    """f32, batch 3 of which 2 are valid (the third zero-padded, as the
    pipeline pads the last batch): the confusion matrices equal, the loss
    sum at rtol 1e-5, n = 2."""
    variables = _variables(2)
    rng = np.random.RandomState(8)
    images = rng.randint(0, 256, (3, *HW, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (3, *HW)).astype(np.uint8)
    images[2], labels[2] = 0, 0
    norm = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    fm = FlaxUNet(output_channels=10, width_mult=WIDTH)
    state = TrainState.create(apply_fn=fm.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=__import__("optax").adam(1e-3))
    want = jax_make_eval_step(10, normalize=norm, tta=tta)(
        state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(2))
    model = _port_model(variables, torch.float32, subpixel=True)
    got = make_eval_step(model, 10, normalize=norm, tta=tta)(
        torch.from_numpy(images), torch.from_numpy(labels), 2)
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    assert int(got["confusion"].sum()) == 2 * HW[0] * HW[1]
    assert float(got["n"]) == float(want["n"]) == 2.0
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    assert model.training          # the step restores the mode it found


def test_debug_nans_raises_in_both_packages():
    """A NaN input: JAX's debug-nans mode (on for every test, tests/conftest.py)
    raises FloatingPointError from the jitted step; the port's step with
    debug_nans runs op by op and raises before the update."""
    variables = _variables()
    x = np.full((BATCH, *HW, 3), np.nan, np.float32)
    y = np.zeros((BATCH, *HW), np.int64)
    fm = FlaxUNet(output_channels=10, width_mult=WIDTH)
    import optax

    state = TrainState.create(apply_fn=fm.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=optax.adam(1e-3))
    with pytest.raises(FloatingPointError):
        jax_make_train_step(donate=False)(state, jnp.asarray(x), jnp.asarray(y))
    model = _port_model(variables, torch.float32, subpixel=True)
    opt = build_optimizer(model, load_config(BASE + ["--train.debug_nans=true"]).train, TOTAL)
    step = make_train_step(model, opt, debug_nans=True)
    assert not isinstance(step, graphs.Captured)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FloatingPointError, match="debug_nans"):
        step(torch.from_numpy(x), torch.from_numpy(y))
    assert int(opt.state["count"]) == 0
    params = dict(model.named_parameters())
    assert all(torch.equal(params[k], before[k]) for k in params)
