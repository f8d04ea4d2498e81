"""Video inference entry point of the PyTorch port:

    python -m tpuseg_torch.inference --infer.video=assets/demo.mp4 \
        --model.use_pallas=true --model.up_subpixel=false --infer.car_boxes=false
    python -m tpuseg_torch.inference --platform=cpu --infer.max_frames=8 ...

The flags of the JAX package's ``inference.py`` (``load_config``), plus
``--platform=cpu``. It runs on the CUDA card unless ``--platform=cpu`` is
given, and raises without a card otherwise. The batched, pipelined
``VideoPipeline`` reads the video, and the stats line (frames, seconds,
fps, cars, phases, tunnel_ok, fps_ex_fetch) is printed as JSON. Reading a
video file needs cv2; on a host without it, car boxes need cv2 too, so
pass ``--infer.car_boxes=false`` there. fp32 compute is fp32: TF32 is off
for cuDNN convolutions and matmuls.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    import torch

    from tpuseg_torch.configs import load_config
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.infer.predictor import Predictor
    from tpuseg_torch.infer.video import VideoPipeline
    from tpuseg_torch.main import device_for_platform, split_platform_flag

    platform, argv = split_platform_flag(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device_for_platform(platform))
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(argv)
    predictor = Predictor(
        cfg.model,
        checkpoint=cfg.infer.checkpoint,
        artifact=cfg.infer.artifact,
        input_hw=(cfg.data.height, cfg.data.width),
        batch_size=cfg.infer.batch_size,
        colorize_on_device=cfg.infer.colorize_on_device,
        upscale_on_host=cfg.infer.upscale_on_host,
        preprocess_on_host=cfg.infer.preprocess_on_host,
        device_close=cfg.infer.device_close,
        fetch_pack4=cfg.infer.fetch_pack4,
        normalize_mean=cfg.data.normalize_mean,
        normalize_std=cfg.data.normalize_std,
        device=device,
    )
    pipeline = VideoPipeline(
        predictor,
        road_cleanup=cfg.infer.road_cleanup,
        car_boxes=cfg.infer.car_boxes,
        min_car_area=cfg.infer.min_car_area,
        blend_alpha=cfg.infer.blend_alpha,
        pipeline_depth=cfg.infer.pipeline_depth,
    )
    stats = pipeline.run(
        cfg.infer.video,
        output_path=cfg.infer.output,
        display=cfg.infer.display,
        max_frames=cfg.infer.max_frames or None,
    )
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
