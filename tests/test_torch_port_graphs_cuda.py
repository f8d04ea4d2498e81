"""Card-only tests of the capture helper (tpuseg_torch/core/graphs.py).

Without a CUDA card every test here skips (the decision is taken inside
the ``card`` fixture, so every worker collects the same tests). On the
machine with the card, whose Python has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_graphs_cuda.py
"""

import contextlib

import pytest
import torch

from tpuseg_torch.core import graphs
from tpuseg_torch.data.class_maps import COLOR_MAP_BGR
from tpuseg_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: there is nothing to capture on the CPU")
    return torch.device("cuda")


def test_replays_equal_eager_calls_and_count_launches(card):
    def fn(logits, scale):
        return kernels.argmax_colorize(logits * scale, COLOR_MAP_BGR)

    step = graphs.Captured(fn, "colorize")
    gen = torch.Generator(device=card).manual_seed(0)
    inputs = [(torch.randn(2, 8, 16, 10, generator=gen, device=card),
               torch.rand(1, generator=gen, device=card) + 0.5) for _ in range(4)]
    kernels.reset_launches()
    got = [tuple(t.clone() for t in step(*a)) for a in inputs]
    assert kernels.launches["argmax_colorize"] == len(inputs)
    assert step.replays() == len(inputs) - 1
    with graphs.eager():
        want = [fn(*a) for a in inputs]
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    # another shape is another graph
    step(torch.randn(1, 4, 4, 10, device=card), inputs[0][1])
    assert len(step.entries) == 2


def test_a_capture_survives_garbage_graphs_of_earlier_captures(card):
    """A graph that only a reference cycle holds (a dropped Trainer's step)
    is collected before the next capture, not inside it, where destroying
    it would invalidate that capture. The warm-up call leaves such a cycle;
    the captured call collects garbage, as an automatic collection that
    falls inside the capture would."""
    import gc

    class Holder:
        pass

    calls = []

    def fn(x):
        if not calls:
            holder = Holder()
            holder.me = holder
            holder.step = graphs.Captured(lambda y: y * 2.0, "garbage")
            holder.step(torch.ones(8, device=x.device))
        else:
            gc.collect()
        calls.append(1)
        return x + 1.0

    step = graphs.Captured(fn, "after_garbage")
    x = torch.zeros(8, device=card)
    step(x)
    assert torch.equal(step(x), x + 1.0) and step.replays() == 1


def test_registered_generator_draws_as_eager(card):
    def fn(x, gen):
        return x + torch.rand(x.shape, generator=gen, device=x.device)

    outs = []
    for eager in (False, True):
        gen = torch.Generator(device=card).manual_seed(3)
        step = graphs.Captured(lambda x: fn(x, gen), "draw", generators=(gen,))
        x = torch.zeros(1000, device=card)
        with graphs.eager() if eager else contextlib.nullcontext():
            outs.append([step(x).clone() for _ in range(3)] + [gen.get_state()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_a_failed_capture_raises(card):
    state = torch.zeros(4, device=card)
    gen = torch.Generator(device=card).manual_seed(0)

    def fn(x):
        state.add_(x + torch.rand(x.shape, generator=gen, device=card))
        return x * float(state.sum())

    step = graphs.Captured(fn, "syncs", generators=(gen,))
    with pytest.raises(RuntimeError, match="capture of syncs failed"):
        step(torch.ones(4, device=card))
    # the warm-up's update stays applied, ordered before the current stream
    want = 1 + torch.rand(4, generator=torch.Generator(device=card).manual_seed(0), device=card)
    assert torch.equal(state, want)
    assert not step.entries
    # the generators draw again, the default one and the registered one
    # from where the warm-up left it
    torch.rand(4, device=card)
    after = torch.Generator(device=card).manual_seed(0)
    torch.rand(4, generator=after, device=card)
    assert torch.equal(torch.rand(4, generator=gen, device=card),
                       torch.rand(4, generator=after, device=card))
    torch.cuda.synchronize()


def _reserved_after_release(card) -> int:
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(card)


def test_keys_past_max_keys_are_dropped_with_their_memory(card):
    def fn(x):
        return ((x * 2).exp() + 1).sum()

    step = graphs.Captured(fn, "bounded", max_keys=2)
    inputs = [torch.rand((1 << 22) + 1024 * i, device=card) for i in range(8)]
    base = _reserved_after_release(card)
    for x in inputs[:2]:
        step(x)
    two = _reserved_after_release(card) - base
    for x in inputs[2:]:
        step(x)
    eight = _reserved_after_release(card) - base
    assert list(step.entries) == [graphs._key((x,)) for x in inputs[-2:]]
    assert step.captures == len(inputs) and step.replays() == 0
    # six more graphs captured, four dropped: the memory of two kept
    assert eight < 1.5 * two, (two, eight)
    # a dropped key is captured again, and answers as eager
    got = step(inputs[0]).clone()
    assert step.captures == len(inputs) + 1
    with graphs.eager():
        assert torch.equal(got, fn(inputs[0]))


def test_predictor_keeps_at_most_max_graphs(card):
    import numpy as np

    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.infer.predictor import Predictor

    p = Predictor(ModelConfig(name="mobilenetv2_unet", width_mult=0.25, num_classes=10),
                  input_hw=(32, 64), device="cuda")
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (1, 40 + 2 * i, 80, 3), np.uint8)
              for i in range(p.MAX_GRAPHS + 2)]
    got = [p(f) for f in frames]
    assert len(p._device_forward.entries) == p.MAX_GRAPHS
    assert p._device_forward.captures == len(frames)
    again = p(frames[0])           # dropped, captured again
    assert p._device_forward.captures == len(frames) + 1
    with graphs.eager():
        want = [p(f) for f in frames]
    assert all(np.array_equal(g, w) for g, w in zip(got + [again], want + want[:1]))
