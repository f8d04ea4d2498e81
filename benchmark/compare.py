"""The numbers that decide ``correct``; each cell's workload file names the
ones it compares and their limits, and PERF.md the readings they were set
from.

Training: the window's first dispatch, which starts from the seeded state,
against the plain reference from the same state on the same rows; and
the rows of a seeded sample of the window's later dispatches.

- ``rows_foreign``: kept rows that are no scene of the set (limit 0);
- ``steps_repeated``: kept steps whose rows, in order, are another kept
  step's (a batch fed twice; limit 0; ``steps_kept`` says how many);
- ``grad_rms_gap``: the gap between the root of the sum of Adam's second
  moment over the kept leaves after the dispatch, program against
  reference, over the reference's: the gradients' size as the optimizer
  got them, step by step, which no sign or order of rounding cancels;
  ``grad_rms_gap_median`` the median leaf's gap of the same;
- ``moment_gap``: by the worst leaf, the gap between the norms of Adam's
  first moment after the dispatch (the gradients as the optimizer got
  them), program against reference, over the reference leaf's norm or the
  median leaf's, whichever is larger; ``moment_gap_median`` the median
  leaf's;
- ``update_gap``, ``update_gap_median``: the same for each parameter's
  change over the dispatch;
- ``loss_gap``, ``loss1_gap``: the largest relative gap of a step's loss,
  and the first step's.

Leaves whose reference first moment is under a thousandth of the median
leaf's (biases in front of a BatchNorm, whose gradient is nought but
rounding) are left out of the norm gaps.

Serving: over every pixel of the sampled batches, the gap by which the
reference's logit of the served class lies below its best logit there:
the widest (``class_gap``) and the mean (``class_gap_mean``), in logits,
and the share of pixels with a gap (``class_mismatch``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

NEGLIGIBLE = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Sequence[str]) -> List[float]:
    """Each kept leaf's |norm gap| over max(its reference norm, the median's)."""
    floor = _median([reference[k] for k in keep])
    return [abs(program[k] - reference[k]) / max(reference[k], floor, 1e-30) for k in keep]


def train_numbers(program: Dict, reference: Dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``program`` and ``reference``: {"losses", "mu", "nu", "params"} by name;
    ``start``: the parameters both began from. Besides the numbers above,
    the first step's loss gap and the median leaf's gaps (``*_median``)."""
    ref_mu = _norms(reference["mu"])
    floor = _median(list(ref_mu.values()))
    keep = [k for k, v in ref_mu.items() if v >= NEGLIGIBLE * floor]
    delta_p = _norms({k: program["params"][k].double() - start[k].double() for k in keep})
    delta_r = _norms({k: reference["params"][k].double() - start[k].double() for k in keep})
    losses_p, losses_r = program["losses"], reference["losses"]
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_p, losses_r)]
    if len(losses_p) != len(losses_r) or not gaps:
        gaps = [float("inf")]
    moment = leaf_gaps(_norms({k: program["mu"][k] for k in keep}), ref_mu, keep)
    update = leaf_gaps(delta_p, delta_r, keep)
    rms_p = {k: float(program["nu"][k].double().sum().sqrt()) for k in keep}
    rms_r = {k: float(reference["nu"][k].double().sum().sqrt()) for k in keep}
    total_p = sum(v * v for v in rms_p.values()) ** 0.5
    total_r = sum(v * v for v in rms_r.values()) ** 0.5
    return {"grad_rms_gap": abs(total_p - total_r) / max(total_r, 1e-30),
            "grad_rms_gap_median": _median(leaf_gaps(rms_p, rms_r, keep)),
            "loss_gap": max(gaps), "loss1_gap": gaps[0],
            "moment_gap": max(moment), "moment_gap_median": _median(moment),
            "update_gap": max(update), "update_gap_median": _median(update),
            "leaves_left_out": float(len(ref_mu) - len(keep))}


def worst_leaves(program: Dict, reference: Dict, top: int = 3) -> List:
    """The leaves of the largest first-moment norm gaps, with their gap and
    their norms, program then reference (for the record of a look)."""
    ref_mu = _norms(reference["mu"])
    prog_mu = _norms(program["mu"])
    floor = _median(list(ref_mu.values()))
    keep = [k for k, v in ref_mu.items() if v >= NEGLIGIBLE * floor]
    rows = sorted(((abs(prog_mu[k] - ref_mu[k]) / max(ref_mu[k], floor), k, prog_mu[k], ref_mu[k])
                   for k in keep), reverse=True)
    return rows[:top]


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> Dict[str, float]:
    """The served classes [B, H, W] under the reference's logits [B, C, h,
    w], through the nearest upscale floor(i * h / H): the widest logit gap
    (``class_gap``), and the pixels whose class is not the reference's best
    (``mismatched``) of ``pixels``."""
    from benchmark.reference.steps import nearest_index

    b, c, h, w = ref_logits.shape
    if int(served.max()) >= c:
        return {"class_gap": float("inf"), "mismatched": float(served.numel()),
                "gap_sum": float("inf"), "pixels": float(served.numel())}
    rows = nearest_index(h, served.shape[1], ref_logits.device)
    cols = nearest_index(w, served.shape[2], ref_logits.device)
    worst, mismatched, total = 0.0, 0, 0.0
    for i in range(b):
        # one frame at a time: [C, H, W] at frame size
        lg = ref_logits[i][:, rows][:, :, cols]
        gap = lg.amax(0) - lg.gather(0, served[i].to(torch.int64)[None])[0]
        worst = max(worst, float(gap.max()))
        mismatched += int((gap > 0).sum())
        total += float(gap.double().sum())
    return {"class_gap": worst, "mismatched": float(mismatched), "gap_sum": total,
            "pixels": float(served.numel())}


def add_served(total: Dict[str, float], got: Dict[str, float]) -> None:
    """Fold one batch's ``served_gaps`` into ``total``."""
    total["class_gap"] = max(total.get("class_gap", 0.0), got["class_gap"])
    for k in ("mismatched", "gap_sum", "pixels"):
        total[k] = total.get(k, 0.0) + got[k]


def served_numbers(total: Dict[str, float]) -> Dict[str, float]:
    """The served numbers over every sampled pixel: the widest gap
    (``class_gap``), the mean gap (``class_gap_mean``) and the share of
    pixels whose class is not the reference's best (``class_mismatch``)."""
    n = max(total.get("pixels", 0.0), 1.0)
    return {"class_gap": total.get("class_gap", float("inf")),
            "class_gap_mean": total.get("gap_sum", float("inf")) / n,
            "class_mismatch": total.get("mismatched", n) / n}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number with a limit at or under it (a missing number fails)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {k}: {numbers.get(k, float('nan'))!r} limit {lim!r}"
            for k, lim in limits.items()]
