#!/usr/bin/env python
"""How far apart bf16 serving routes are, in both packages, at the card's size.

The flagship (mobilenetv2_unet, full width, 10 classes) at batch 8 and a
128x256 model input, with the weights and the first batch of frames that
``chip_smoke.py`` serves (``init_weights`` with random BatchNorm
statistics, seed 0; 360x640 frames, seed 0, resized and normalized as the
Predictor does). The port's weights are carried into the JAX package's
variables, and one model input goes through:

- the JAX package's bf16 forward on its kernel route (``use_pallas``,
  ``up_subpixel=False``: the Pallas decoder kernel in interpret mode) and on
  its plain route (``use_pallas=False``), and its fp32 plain forward;
- the port's same three forwards on the CPU (the kernels' plain versions).

For each pair it prints the share of pixels whose class (argmax) agrees and
the largest logit gap, as one JSON object. Seeded, untrained weights leave
many near-ties, so two routes that round at other places do not agree on
every pixel: this gives the bar that the port's bf16 routes on the card
are held to (``chip_smoke.py``'s bf16 phase). Runs on the CPU in about a
minute:

    JAX_PLATFORMS=cpu python tools/bf16_route_agreement.py
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, MODEL_HW, FRAME_HW, SEED = 8, (128, 256), (360, 640), 0
ROUTES = {"kernels": True, "plain": False}       # use_pallas


def flax_variables(state_dict, template):
    """The port's ``state_dict`` as the JAX package's variables: each flax
    leaf gathered from the tensor that ``state_dict_from_flax`` maps it to
    (found by mapping a tree of element ids)."""
    import jax
    import numpy as np

    from tpuseg_torch.core.weights import state_dict_from_flax

    leaves, tree = jax.tree_util.tree_flatten(template)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    offs = np.cumsum([0] + sizes)
    assert offs[-1] < 2 ** 24, "ids must be exact in float32"
    ids = [np.arange(o + 1, o + n + 1, dtype=np.float32).reshape(leaf.shape)
           for o, n, leaf in zip(offs, sizes, leaves)]
    vals = np.zeros(offs[-1], np.float32)
    for k, t in state_dict_from_flax(jax.tree_util.tree_unflatten(tree, ids)).items():
        if t.is_floating_point():
            vals[t.numpy().reshape(-1).astype(np.int64) - 1] = state_dict[k].numpy().reshape(-1)
    return jax.tree_util.tree_unflatten(
        tree, [vals[o:o + n].reshape(leaf.shape) for o, n, leaf in zip(offs, sizes, leaves)])


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tpuseg.configs import ModelConfig as JaxModelConfig
    from tpuseg.models.registry import build_model as jax_build_model
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.core.prng import make_generator
    from tpuseg_torch.core.weights import init_weights
    from tpuseg_torch.data.augment import normalize_images
    from tpuseg_torch.data.class_maps import IMAGENET_MEAN, IMAGENET_STD
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.ops.resize import resize_bilinear

    model = build_model(ModelConfig())
    init_weights(model, make_generator(SEED), random_bn=True)
    state_dict = model.state_dict()
    frames = np.random.RandomState(SEED).randint(0, 256, (BATCH, *FRAME_HW, 3), np.uint8)
    x = normalize_images(resize_bilinear(torch.from_numpy(frames).float(), *MODEL_HW),
                         tuple(IMAGENET_MEAN.tolist()), tuple(IMAGENET_STD.tolist()))

    init = jax_build_model(JaxModelConfig()).init
    template = jax.jit(lambda k: init(k, jnp.zeros((1, *MODEL_HW, 3)), train=False))(
        jax.random.PRNGKey(0))
    variables = flax_variables(state_dict, {"params": template["params"],
                                            "batch_stats": template["batch_stats"]})
    logits = {}
    for dtype, routes in (("bfloat16", ("kernels", "plain")), ("float32", ("plain",))):
        for route in routes:
            kw = dict(compute_dtype=dtype, use_pallas=ROUTES[route], up_subpixel=False)
            jm = jax_build_model(JaxModelConfig(**kw))
            logits[("jax", route, dtype)] = np.asarray(jax.jit(
                lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x.numpy())))
            pm = build_model(ModelConfig(**kw))
            pm.load_state_dict(state_dict)
            with torch.no_grad():
                logits[("port", route, dtype)] = pm.eval()(x.permute(0, 3, 1, 2)).permute(
                    0, 2, 3, 1).numpy()

    def pair(a, b):
        a, b = logits[a], logits[b]
        return {"class_agreement": float((a.argmax(-1) == b.argmax(-1)).mean()),
                "max_logit_gap": float(np.abs(a - b).max()),
                "max_abs_logit": float(np.abs(b).max())}

    bf, f32 = "bfloat16", "float32"
    print(json.dumps({
        "jax_bf16_kernels_vs_plain": pair(("jax", "kernels", bf), ("jax", "plain", bf)),
        "port_bf16_kernels_vs_plain": pair(("port", "kernels", bf), ("port", "plain", bf)),
        "port_vs_jax_bf16_plain": pair(("port", "plain", bf), ("jax", "plain", bf)),
        "port_vs_jax_bf16_kernels": pair(("port", "kernels", bf), ("jax", "kernels", bf)),
        "jax_bf16_vs_fp32_plain": pair(("jax", "plain", bf), ("jax", "plain", f32)),
        "port_bf16_vs_fp32_plain": pair(("port", "plain", bf), ("port", "plain", f32)),
        "port_vs_jax_fp32_plain": pair(("port", "plain", f32), ("jax", "plain", f32)),
        "shape": [BATCH, *MODEL_HW], "seed": SEED}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
