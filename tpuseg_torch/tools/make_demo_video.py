"""Generate the repo's demo video (assets/demo.mp4).

The port's copy of ``tools/make_demo_video.py``: a synthetic driving clip
(the port's ``SyntheticSource`` scene, two cars drifting across it,
brightness flicker and seeded noise) written by cv2's ``VideoWriter``, so
``python -m tpuseg_torch.inference`` has an input with no download:

    python -m tpuseg_torch.tools.make_demo_video [path [frames [w h]]]

It raises where cv2 does not import (the card's host: ROADMAP.md A9).
"""

from __future__ import annotations

import os
import sys

import numpy as np

CV2_HINT = (" (ROADMAP.md A9: the port writes and decodes video files with cv2 only); "
            "run this tool where cv2 is installed")


def main(path: str = "assets/demo.mp4", frames: int = 120,
         w: int = 320, h: int = 180) -> int:
    from tpuseg_torch.data.sources import SyntheticSource
    from tpuseg_torch.infer.postprocess import require_cv2

    cv2 = require_cv2("make_demo_video", CV2_HINT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
    src = SyntheticSource(1, w, h, seed=7)
    base, _ = src.load(0)
    rng = np.random.RandomState(0)
    car_x = [40.0, 200.0]
    car_v = [1.7, -1.2]
    for t in range(frames):
        frame = base.copy()
        # drifting brightness = day/night flicker
        frame = np.clip(frame.astype(np.int16) + int(10 * np.sin(t / 15)), 0, 255
                        ).astype(np.uint8)
        for i, (x, v) in enumerate(zip(car_x, car_v)):
            cw, ch = 44, 24
            y0 = h - 60 - i * 18
            x0 = int(x) % (w - cw)
            color = (30, 30, 200) if i == 0 else (200, 120, 30)
            frame[y0:y0 + ch, x0:x0 + cw] = color
            car_x[i] += v
        noise = rng.randint(-6, 6, frame.shape)
        frame = np.clip(frame.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        writer.write(frame[..., ::-1])
    writer.release()
    print(f"wrote {path} ({os.path.getsize(path)} bytes, {frames} frames)")
    return 0


def _cli(argv):
    """path [frames [w h]]."""
    args = list(argv)
    kwargs = {}
    if len(args) >= 2:
        kwargs["frames"] = int(args[1])
    if len(args) >= 4:
        kwargs["w"], kwargs["h"] = int(args[2]), int(args[3])
    return main(args[0], **kwargs) if args else main()


if __name__ == "__main__":
    raise SystemExit(_cli(sys.argv[1:]))
