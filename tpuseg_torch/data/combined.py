"""Multi-source combination: seeded split + weighted mixing.

The port of ``tpuseg/data/combined.py``, numpy only, with the same RNG
streams: ``CombinedDataset`` shuffles each source with one
``RandomState(seed)`` and splits off ``val_split`` of it;
``WeightedMixSampler`` draws, with replacement, a source with probability
proportional to its weight (renormalized over non-empty sources) and then
a uniform position within it. ``state``/``restore`` carry the sampler's
MT19937 position, so a resumed run draws the same indices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class CombinedDataset:
    """Seeded per-source shuffle + train/val split + index routing."""

    def __init__(self, sources: Sequence, weights: Optional[Sequence[float]] = None,
                 val_split: float = 0.0, seed: int = 42):
        if not sources:
            raise ValueError("need at least one source")
        self.sources = list(sources)
        self.weights = list(weights if weights is not None else [1.0] * len(sources))
        if len(self.weights) != len(self.sources):
            raise ValueError("weights/sources length mismatch")
        rng = np.random.RandomState(seed)
        self.train_indices: List[np.ndarray] = []
        self.val_indices: List[np.ndarray] = []
        for src in self.sources:
            idx = rng.permutation(len(src))
            n_val = int(len(src) * val_split)
            self.val_indices.append(idx[:n_val])
            self.train_indices.append(idx[n_val:])

    @property
    def train_size(self) -> int:
        return sum(len(i) for i in self.train_indices)

    @property
    def val_size(self) -> int:
        return sum(len(i) for i in self.val_indices)

    def load_train(self, source_id: int, pos: int):
        return self.sources[source_id].load(int(self.train_indices[source_id][pos]))

    def iter_val(self):
        """Deterministic pass over the validation split of every source."""
        for sid, idx in enumerate(self.val_indices):
            for i in idx:
                sample = self.sources[sid].load(int(i))
                if sample is not None:
                    yield sample

    def summary(self) -> str:
        lines = ["Combined dataset:"]
        for src, tr, va in zip(self.sources, self.train_indices, self.val_indices):
            lines.append(f"  {type(src).__name__}: {len(tr)} train, {len(va)} val")
        lines.append(f"  Total: {self.train_size} train, {self.val_size} val")
        return "\n".join(lines)


class WeightedMixSampler:
    """Infinite sampler of (source_id, position) pairs with replacement:
    P(source s) = w_s / sum(w over non-empty sources), uniform within it."""

    def __init__(self, combined: CombinedDataset, seed: int = 0):
        self.combined = combined
        sizes = np.array([len(i) for i in combined.train_indices], dtype=np.int64)
        w = np.array(combined.weights, dtype=np.float64)
        w = np.where(sizes > 0, w, 0.0)
        if w.sum() <= 0:
            w = sizes.astype(np.float64)   # size-proportional
        if w.sum() <= 0:
            w = np.ones_like(w)            # empty train split: sample() is never called
        self.probs = w / w.sum()
        self.sizes = sizes
        self.rng = np.random.RandomState(seed)

    def sample(self, n: int) -> List[Tuple[int, int]]:
        sids = self.rng.choice(len(self.probs), size=n, p=self.probs)
        return [(int(s), int(self.rng.randint(self.sizes[s]))) for s in sids]

    def state(self) -> dict:
        """Serializable RNG position (checkpointed for an exact resume)."""
        st = self.rng.get_state()
        return {"key": st[1].tolist(), "pos": int(st[2]),
                "has_gauss": int(st[3]), "cached": float(st[4])}

    def restore(self, state: dict) -> None:
        self.rng.set_state(("MT19937", np.array(state["key"], dtype=np.uint32),
                            state["pos"], state["has_gauss"], state["cached"]))
