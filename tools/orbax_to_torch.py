#!/usr/bin/env python
"""Convert a JAX package checkpoint (Orbax) into a checkpoint of the PyTorch port.

The PyTorch port (``tpuseg_torch``) imports neither JAX nor orbax, so it
cannot read the JAX Trainer's Orbax directories. Run this once where JAX
is:

    python tools/orbax_to_torch.py --checkpoint checkpoints --out checkpoints_torch
    python tools/orbax_to_torch.py --checkpoint checkpoints/best --out best_torch \\
        --platform cpu

It restores a step (default: the latest) as host arrays
(``CheckpointManager.restore_host``), takes the EMA parameters in place of
the raw ones when the checkpoint has them (what the JAX Predictor serves),
maps the tree with the port's ``state_dict_from_flax`` and writes
``<out>/step_<N>.pt`` holding ``{"model": state_dict, "step": N}``, at the
same step. A calibrated int8 checkpoint (the JAX ``save_quantized``, as
``convert.py --export.format=quantized`` writes it) keeps its ``quant``
tree, mapped onto the port's conv names by ``quant_from_flax``, as
``"quant"`` beside the weights. The port loads that directory wherever it
takes a checkpoint: ``--train.init_checkpoint``, ``--infer.checkpoint``
(in int8 where it has ``quant``), ``--train.distill_checkpoint`` and
``python -m tpuseg_torch.tools.eval_miou --checkpoint`` (these two refuse
``quant``, as the JAX ones do).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(checkpoint: str, out: str, step: Optional[int] = None) -> int:
    """Convert ``step`` (None: the latest) of the Orbax directory
    ``checkpoint`` into the port's checkpoint directory ``out``; returns
    the step."""
    from tpuseg.core.checkpoint import CheckpointManager
    from tpuseg_torch.core.checkpoint import CheckpointManager as PortCheckpointManager
    from tpuseg_torch.core.weights import quant_from_flax, state_dict_from_flax

    with CheckpointManager(checkpoint) as mgr:
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no Orbax checkpoint in {checkpoint!r}")
        restored = mgr.restore_host(step)
    state = restored["state"] if "state" in restored else restored
    params = state["ema_params"] if state.get("ema_params") else state["params"]
    variables = {"params": params, "batch_stats": state.get("batch_stats", {})}
    payload = {"model": state_dict_from_flax(variables), "step": int(step)}
    if state.get("quant"):
        payload["quant"] = quant_from_flax({**variables, "quant": state["quant"]})
    PortCheckpointManager(out, max_to_keep=1).save(step, payload)
    return int(step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True, help="Orbax checkpoint directory")
    ap.add_argument("--out", required=True, help="output directory (the port's format)")
    ap.add_argument("--step", type=int, default=None, help="step to convert (default: latest)")
    ap.add_argument("--platform", default="", help="force a jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    from tpuseg.core.platform import env_platform_override

    platform = args.platform or env_platform_override()
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    step = convert(args.checkpoint, args.out, args.step)
    print(f"Wrote {os.path.join(args.out, f'step_{step}.pt')} from {args.checkpoint} "
          f"(step {step})")
    print(f"Use with: python -m tpuseg_torch.main --train.init_checkpoint={args.out}  "
          "(or --infer.checkpoint)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
