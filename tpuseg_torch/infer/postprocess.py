"""Host-side postprocess: the reference overlay, with or without cv2.

The port of ``tpuseg/infer/postprocess.py``: road-mask cleanup (5x5 rect
MORPH_CLOSE + keep-largest connected component), per-class recolouring,
car contour boxes with the distance label ``int(50 * (1 - y_bottom/H))``,
and the 0.6/0.4 blend, on BGR frames. cv2 is imported inside functions
only. The routes, each bit-equal to the JAX package's on the same class
map:

- road cleanup: cv2 where it imports (as the JAX package); else the
  native library (``native_post.clean_road``, or ``keep_largest`` after a
  device close, ``closed_road``);
- colorize and blend: the native library where it loads (as the JAX
  package), else numpy and ``cv2.addWeighted``;
- car boxes: cv2 only. ``findContours``, ``contourArea`` and ``putText``
  have no cv2-exact replacement, so ``car_boxes=True`` without cv2 raises
  ``Cv2Missing``.

Without cv2 and without the native library, the cleanup and the blend
raise ``Cv2Missing`` naming both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from tpuseg_torch.data.class_maps import COLOR_MAP_BGR
from tpuseg_torch.ops import native_post

ROAD_CLASS = 1
CAR_CLASS = 2
# Reserved class-plane id for box strokes in the fused colorize+blend path:
# strokes are rasterized into the class plane, then one LUT pass blends the
# colour of each id. 254 cannot collide with a 10-way argmax.
BOX_CLASS = 254
BOX_COLOR_BGR = (0, 255, 0)

_LUT_CACHE: Dict[float, np.ndarray] = {}
_PALETTE256: Optional[np.ndarray] = None


class Cv2Missing(RuntimeError):
    """A postprocess step that needs cv2 (or the native library) on a host
    that has neither."""


def cv2_or_none():
    """The cv2 module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def require_cv2(what: str, hint: str = ""):
    """The cv2 module; raises Cv2Missing naming ``what`` where it does not
    import."""
    cv2 = cv2_or_none()
    if cv2 is None:
        raise Cv2Missing(f"{what} needs cv2, which does not import on this host{hint}")
    return cv2


def _cv2_for_boxes():
    return require_cv2("car boxes", " (findContours, contourArea and putText have no "
                                    "cv2-exact replacement); pass --infer.car_boxes=false "
                                    "(car_boxes=False) on such a host")


def _palette256() -> np.ndarray:
    """The 10-class palette extended to all 256 ids: unknown ids take class
    0's colour; BOX_CLASS is the stroke green."""
    global _PALETTE256
    if _PALETTE256 is None:
        pal = np.empty((256, 3), np.uint8)
        pal[:] = COLOR_MAP_BGR[0]
        pal[: len(COLOR_MAP_BGR)] = COLOR_MAP_BGR
        pal[BOX_CLASS] = BOX_COLOR_BGR
        _PALETTE256 = pal
    return _PALETTE256


def _blend_lut(alpha: float) -> np.ndarray:
    """[256,3,256] fused colorize+blend LUT over _palette256()."""
    lut = _LUT_CACHE.get(alpha)
    if lut is None:
        lut = native_post.make_blend_lut(_palette256(), alpha)
        _LUT_CACHE[alpha] = lut
    return lut


def clean_road_mask(classes: np.ndarray, kernel_size: int = 5,
                    closed_road: Optional[np.ndarray] = None) -> np.ndarray:
    """Morph-close the road mask, keep only its largest connected component,
    and stamp it back into the class map.

    ``closed_road``: the already-closed road mask (bool or 0/255 uint8) when
    the close ran on the device (Predictor ``device_close``); only the
    connected-component step runs here."""
    cv2 = cv2_or_none()
    if cv2 is None:
        if not native_post.available():
            raise Cv2Missing("road cleanup needs cv2 or the native postprocess library; "
                             f"neither loads here ({native_post.unavailable_reason()})")
        if closed_road is None:
            return native_post.clean_road(classes, ROAD_CLASS, kernel_size)
        road = native_post.keep_largest((np.asarray(closed_road) != 0).astype(np.uint8) * 255)
    else:
        if closed_road is not None:
            road = (np.asarray(closed_road) != 0).astype(np.uint8) * 255
        else:
            road = (classes == ROAD_CLASS).astype(np.uint8) * 255
            kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (kernel_size, kernel_size))
            road = cv2.morphologyEx(road, cv2.MORPH_CLOSE, kernel)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(road, connectivity=8,
                                                               ltype=cv2.CV_32S)
        if n > 1:
            largest = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
            road = np.where(labels == largest, np.uint8(255), np.uint8(0))
    cleaned = classes.copy()
    cleaned[road == 255] = ROAD_CLASS
    return cleaned


def _car_contour_boxes(classes: np.ndarray, min_area: float, frame_height: int):
    """[(x, y, w, h, distance_m)] of car contours with contourArea > min_area."""
    cv2 = _cv2_for_boxes()
    car_mask = (classes == CAR_CLASS).astype(np.uint8) * 255
    contours, _ = cv2.findContours(car_mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    boxes = []
    for contour in contours:
        if cv2.contourArea(contour) > min_area:
            x, y, w, hh = cv2.boundingRect(contour)
            boxes.append((x, y, w, hh, int(50 * (1.0 - (y + hh) / frame_height))))
    return boxes


def _draw_rects(target: np.ndarray, boxes, color) -> None:
    """Box outlines; the same geometry on BGR overlays and on 1-channel
    class planes (cv2 rectangles are crisp)."""
    cv2 = _cv2_for_boxes()
    for x, y, w, hh, _distance in boxes:
        cv2.rectangle(target, (x, y), (x + w, y + hh), color, 2)


def _draw_texts(target: np.ndarray, boxes, color, dx: int = 0, dy: int = 0) -> None:
    """The distance labels (anti-aliased glyphs) in box order, optionally
    offset into an ROI."""
    cv2 = _cv2_for_boxes()
    for x, y, _w, _hh, distance in boxes:
        cv2.putText(target, f"{distance}m", (x - dx, y - 5 - dy), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, color, 1)


def _draw_boxes(target: np.ndarray, boxes, color) -> None:
    """Boxes then labels: for same-colour strokes, the same pixels as the
    reference's per-box interleaving."""
    _draw_rects(target, boxes, color)
    _draw_texts(target, boxes, color)


def _repair_text_rois(result, frame_bgr, plane, boxes, alpha) -> None:
    """Exact re-blend of the distance-label regions for the fused path:
    glyphs anti-alias against the overlay, so each label's padded (and
    transitively merged) region is redone the reference way, overlay =
    palette[plane] with all labels drawn, then the LUT's double-precision
    rint blend."""
    cv2 = _cv2_for_boxes()
    h, w = plane.shape
    rois = []
    for x, y, _bw, _bh, distance in boxes:
        (tw, th), base = cv2.getTextSize(f"{distance}m", cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        x0, x1 = max(0, x - 3), min(w, x + tw + 3)
        y0, y1 = max(0, y - 5 - th - 3), min(h, y - 5 + base + 3)
        if x0 < x1 and y0 < y1:
            rois.append((x0, y0, x1, y1))
    merged = []
    for r in rois:
        changed = True
        while changed:
            changed = False
            for m in merged:
                if r[0] < m[2] and m[0] < r[2] and r[1] < m[3] and m[1] < r[3]:
                    merged.remove(m)
                    r = (min(r[0], m[0]), min(r[1], m[1]), max(r[2], m[2]), max(r[3], m[3]))
                    changed = True
                    break
        merged.append(r)
    pal = _palette256()
    for x0, y0, x1, y1 in merged:
        ov = pal[plane[y0:y1, x0:x1]]
        _draw_texts(ov, boxes, BOX_COLOR_BGR, dx=x0, dy=y0)
        mix = (frame_bgr[y0:y1, x0:x1].astype(np.float64) * (1.0 - alpha)
               + ov.astype(np.float64) * alpha)
        result[y0:y1, x0:x1] = np.clip(np.rint(mix), 0, 255).astype(np.uint8)


def detect_cars(overlay: np.ndarray, classes: np.ndarray, min_area: float = 300.0,
                frame_height: int = 0) -> int:
    """Draw green boxes + distance labels on ``overlay``; return the count."""
    boxes = _car_contour_boxes(classes, min_area, frame_height or overlay.shape[0])
    _draw_boxes(overlay, boxes, BOX_COLOR_BGR)
    return len(boxes)


def colorize(classes: np.ndarray) -> np.ndarray:
    """Class map -> BGR image by one palette gather (native when loaded,
    numpy otherwise; the same bytes)."""
    if native_post.available():
        return native_post.colorize(classes, COLOR_MAP_BGR)
    return COLOR_MAP_BGR[classes]


def blend(frame_bgr: np.ndarray, overlay: np.ndarray, alpha: float) -> np.ndarray:
    """cv2.addWeighted(frame, 1-a, overlay, a, 0): native when loaded, cv2
    otherwise."""
    if native_post.available():
        return native_post.blend(frame_bgr, overlay, alpha)
    cv2 = cv2_or_none()
    if cv2 is None:
        raise Cv2Missing("the blend needs cv2 or the native postprocess library; neither "
                         f"loads here ({native_post.unavailable_reason()})")
    return cv2.addWeighted(frame_bgr, 1.0 - alpha, overlay, alpha, 0)


def overlay_predictions(
    frame_bgr: np.ndarray,
    classes: np.ndarray,
    road_cleanup: bool = True,
    car_boxes: bool = True,
    min_car_area: float = 300.0,
    blend_alpha: float = 0.4,
    precolored_bgr: Optional[np.ndarray] = None,
    closed_road: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """frame [H,W,3] BGR + class map [H,W] -> (blended frame, {'cars': n}).

    ``precolored_bgr``: the overlay already colorized on the device from
    the pre-cleanup class map; the cleanup only turns pixels into road, so
    the fix-up is one masked store of the road colour."""
    if car_boxes:
        _cv2_for_boxes()
    cleaned = clean_road_mask(classes, closed_road=closed_road) if road_cleanup else classes
    if precolored_bgr is None and native_post.has_colorize_blend():
        # fused: box outlines stroked into the class plane as BOX_CLASS, one
        # LUT pass blends, the label regions are re-blended exactly
        boxes = _car_contour_boxes(cleaned, min_car_area, frame_bgr.shape[0]) if car_boxes \
            else []
        if boxes:
            plane = cleaned.copy() if cleaned is classes else cleaned
            _draw_rects(plane, boxes, int(BOX_CLASS))
        else:
            plane = cleaned
        result = native_post.colorize_blend(frame_bgr, plane, _blend_lut(blend_alpha))
        if boxes:
            _repair_text_rois(result, frame_bgr, plane, boxes, blend_alpha)
        return result, {"cars": len(boxes)}
    if precolored_bgr is not None:
        overlay = precolored_bgr
        if road_cleanup:
            changed = cleaned != classes
            overlay = overlay.copy()
            overlay[changed] = COLOR_MAP_BGR[ROAD_CLASS]
    else:
        overlay = colorize(cleaned)
    return _finish(frame_bgr, cleaned, overlay, car_boxes, min_car_area, blend_alpha)


def _finish(frame_bgr, classes, overlay, car_boxes, min_car_area, blend_alpha):
    detected = {"cars": 0}
    if car_boxes:
        detected["cars"] = detect_cars(overlay, classes, min_area=min_car_area,
                                       frame_height=frame_bgr.shape[0])
    return blend(frame_bgr, overlay, blend_alpha), detected
