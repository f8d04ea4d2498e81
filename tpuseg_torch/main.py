"""Training entry point of the PyTorch port:

    python -m tpuseg_torch.main [--config file.yaml] [--section.key=value ...]
    python -m tpuseg_torch.main --platform=cpu --train.epochs=1 ...

The same flags as the JAX package's ``main.py``. Training runs on the
CUDA card; ``--platform=cpu`` (the JAX package's flag) selects the CPU
instead, where the kernels' plain versions run. Without a card and
without ``--platform=cpu`` it raises. When no ``--data.sources`` is given
and none of the reference's dataset directories exists under ``data/``,
it trains on 256 synthetic road scenes. fp32 compute is fp32: TF32 is
turned off for cuDNN convolutions and matmuls.

Data-parallel training runs one process per rank under ``torchrun``:

    torchrun --standalone --nproc_per_node=2 -m tpuseg_torch.main --mesh.data=2 ...

Each rank joins torchrun's process group (NCCL when every rank has a card
of its own, gloo when they share one or run on the CPU;
``core.mesh.maybe_initialize_distributed``), and ``--mesh.data=-1`` takes
every rank. One process (no torchrun, ``--mesh.data`` -1 or 1) trains as
before.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional, Sequence, Tuple


def split_platform_flag(argv: Sequence[str]) -> Tuple[Optional[str], List[str]]:
    """(the ``--platform=`` value or None, the other arguments)."""
    platform, rest = None, []
    for a in argv:
        if a.startswith("--platform="):
            platform = a.split("=", 1)[1]
        else:
            rest.append(a)
    return platform, rest


def device_for_platform(platform: Optional[str]) -> Optional[str]:
    """None or "gpu"/"cuda" -> the card (None); "cpu" -> "cpu"."""
    if platform in (None, "", "gpu", "cuda"):
        return None
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"--platform={platform!r}: the port runs on 'cuda' (default) or 'cpu'")


def default_sources(cfg):
    """The reference's three sources with its 50/20/30 mix where their
    directories exist, else 256 synthetic scenes."""
    from tpuseg_torch.configs import DatasetSourceConfig

    candidates = (
        DatasetSourceConfig(kind="bdd100k", img_dir="data/bdd100k/images",
                            mask_dir="data/bdd100k/masks", weight=cfg.data.mix[0]),
        DatasetSourceConfig(kind="seame", img_dir="data/seame",
                            annotation_file="data/seame/annotations.jsonl",
                            weight=cfg.data.mix[1]),
        DatasetSourceConfig(kind="carla", img_dir="data/carla/images",
                            mask_dir="data/carla/masks", weight=cfg.data.mix[2]),
    )
    present = tuple(s for s in candidates if os.path.isdir(s.img_dir))
    if present:
        return present
    print("No dataset directories found under data/ — training on synthetic "
          "road scenes (pass --data.sources=... for real data).")
    return (DatasetSourceConfig(kind="synthetic", num_samples=256, weight=1.0),)


def main(argv: Optional[Sequence[str]] = None):
    """Train as configured; returns the Trainer."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    import torch.distributed as dist

    from tpuseg_torch.configs import load_config
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.core.mesh import maybe_initialize_distributed

    platform, argv = split_platform_flag(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device_for_platform(platform))
    cfg = load_config(argv)
    rank_device = maybe_initialize_distributed(device)
    try:
        return _train(cfg, rank_device or device)
    finally:
        if rank_device is not None:
            dist.destroy_process_group()


def _train(cfg, device):
    import torch

    from tpuseg_torch.train.trainer import Trainer

    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    if not cfg.data.sources:
        cfg.data.sources = default_sources(cfg)
    if cfg.model.name == "mobilenetv2_unet" and not cfg.train.init_checkpoint \
            and not cfg.train.resume:
        # the reference starts from a torchvision ImageNet-pretrained encoder
        print("WARNING: training MobileNetV2UNet from RANDOM init. The reference "
              "uses an ImageNet-pretrained encoder; to match it, convert a "
              "torchvision checkpoint once:\n"
              "    python -m tpuseg_torch.tools.import_pretrained --pth mobilenet_v2.pth "
              "--out pretrained/mnv2\n"
              "then pass --train.init_checkpoint=pretrained/mnv2")
    trainer = Trainer(cfg, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
    sys.exit(0)
