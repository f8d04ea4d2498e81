"""Typed dataclass config system with YAML + CLI-flag overrides.

The same dataclasses, field names, defaults and dotted flags as the JAX
package's ``tpuseg/configs.py``, so that one flag set or one ``--config``
file drives both packages and ``to_dict`` of both is equal:

    cfg = load_config(["--model.use_pallas=true", "--model.up_subpixel=false"])

``mesh.data`` is the number of ranks of a process group that train one
model (``torchrun``; ``tpuseg_torch.core.mesh``); ``mesh.spatial`` above
one also splits the image height over that many ranks (the spatial train
step). What the port does not run yet raises where it is used
(``Predictor``, ``build_model``, the Trainer), naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    """Model architecture selection and hyperparameters."""

    name: str = "mobilenetv2_unet"  # one of tpuseg_torch.models.registry
    num_classes: int = 10
    # UNet width; 0 = the model's reference default.
    base_filters: int = 0
    width_mult: float = 1.0         # MobileNetV2 width multiplier
    # params always fp32; "bfloat16" computes the activations in bf16
    # (tpuseg_torch/core/dtypes.py).
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # Route the decoder's upsample+concat+conv (eval) and the Predictor's
    # argmax+colorize through the hand-written CUDA kernels.
    use_pallas: bool = False
    # The JAX package's exact space-to-depth stem rewrite (a TPU layout
    # choice): taken, and the stem runs as the plain conv, the same function.
    stem_s2d: bool = False
    # Exact subpixel/d2s rewrite of decoder conv1s (tpuseg_torch.ops.subpixel).
    # Takes precedence over use_pallas, as in the JAX package.
    up_subpixel: bool = True
    # fp32 final-upsample contraction (the exact-parity convention).
    head_fp32: bool = True


@dataclass
class DatasetSourceConfig:
    """One data source (BDD100K / CARLA / SEAME). ``kind`` selects the loader."""

    kind: str = ""     # "bdd100k" | "carla" | "seame" | "synthetic" | "packed"
    img_dir: str = ""
    mask_dir: str = ""                   # bdd100k/carla
    annotation_file: str = ""            # seame (JSON-lines polygons)
    weight: float = 0.0                  # target sampling fraction
    num_samples: int = 64                # synthetic only
    car_prob: float = 1.0                # synthetic only
    car_scale: float = 1.0               # synthetic only
    packed_dir: str = ""                 # "packed" only


@dataclass
class DataConfig:
    """Input pipeline configuration (tpuseg_torch/data)."""

    width: int = 256
    height: int = 128
    sources: Tuple[DatasetSourceConfig, ...] = ()
    mix: Tuple[float, float, float] = (0.5, 0.2, 0.3)  # bdd / seame / carla
    val_split: float = 0.0
    seed: int = 42
    prefetch: int = 2
    cache_bytes: int = 0
    augment: bool = True
    heavy_augment: bool = False
    normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclass
class TrainConfig:
    """Training hyperparameters (the JAX package's; see train/trainer.py)."""

    batch_size: int = 8
    lr: float = 1.5e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    lr_schedule: str = ""                # "" (constant) | "cosine"
    warmup_steps: int = 0
    optimizer: str = "adam"              # "adam" | "adamw" | "sgd"
    mu_dtype: str = ""
    grads_bf16: bool = False
    weight_decay: float = 1e-4           # adamw only
    momentum: float = 0.9                # sgd only
    # "ce" | "focal" | "dice" | "ce+dice" | "lovasz" | "ce+lovasz"
    loss: str = "ce"
    class_weights: Tuple[float, ...] = ()
    label_smoothing: float = 0.0
    focal_gamma: float = 2.0
    dice_weight: float = 0.5
    lovasz_bins: int = 256
    ignore_index: int = -1
    progress: bool = False
    debug_nans: bool = False
    epochs: int = 200
    steps_per_epoch: int = 0
    log_every: int = 50
    eval_every_epochs: int = 1
    eval_tta: str = ""
    eval_tta_scales: Tuple[float, ...] = (0.75, 1.25)
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    ema_decay: float = 0.0
    qat: bool = False
    distill_checkpoint: str = ""
    distill_model: str = ""
    distill_base_filters: int = 0
    distill_width_mult: float = 0.0
    distill_alpha: float = 0.5
    distill_temperature: float = 2.0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 5
    save_every_epochs: int = 1
    resume: bool = False
    init_checkpoint: str = ""
    remat: bool = False
    # steps per captured graph (one host dispatch); epochs round up to whole groups
    steps_per_dispatch: int = 1
    grad_accum: int = 1
    grad_clip_norm: float = 0.0
    profile_dir: str = ""
    tensorboard_dir: str = ""
    history_file: str = ""
    seed: int = 0


@dataclass
class MeshConfig:
    """The mesh of ranks (``tpuseg_torch.core.mesh``): ``data`` ranks train
    one model on their rows of each global batch (-1: every rank that
    ``spatial`` leaves); ``spatial`` ranks of each data row hold an H-slab
    of its images, each layer fetching the rows it reads from the others
    (``tpuseg_torch/parallel/spatial.py``)."""

    data: int = -1
    spatial: int = 1


@dataclass
class InferConfig:
    """Video/batch inference (see tpuseg_torch.infer.predictor)."""

    checkpoint: str = ""
    artifact: str = ""
    video: str = "assets/demo.mp4"
    output: str = ""
    batch_size: int = 8
    display: bool = False
    colorize_on_device: bool = False
    upscale_on_host: bool = True
    fetch_pack4: bool = False
    device_close: bool = False
    preprocess_on_host: bool = False
    pipeline_depth: int = 3
    max_frames: int = 0
    road_cleanup: bool = True
    car_boxes: bool = True
    min_car_area: float = 300.0
    blend_alpha: float = 0.4


@dataclass
class ExportConfig:
    """Export/quantization."""

    checkpoint: str = ""
    output: str = "exported/model.stablehlo"
    format: str = "stablehlo"
    dtype: str = "float32"               # "float32" | "float16" | "int8"
    batch: int = -1
    calib_batches: int = 8
    fold_bn: bool = True


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    export: ExportConfig = field(default_factory=ExportConfig)


# ---------------------------------------------------------------------------
# Loading / overriding


def _coerce(value: str, target_type: Any) -> Any:
    """Parse a CLI string into the annotated field type."""
    if target_type is bool or isinstance(target_type, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type is str:
        return value
    # tuples and other structured values: JSON
    try:
        parsed = json.loads(value)
        if isinstance(parsed, list):
            return tuple(parsed)
        if target_type is tuple and isinstance(parsed, (int, float)):
            # --train.class_weights=2 parses to a bare scalar: wrap it
            return (float(parsed),)
        return parsed
    except json.JSONDecodeError:
        if target_type is tuple:
            # bare comma form for numeric tuples: --train.class_weights=1,2,3
            try:
                return tuple(
                    float(p) for p in value.split(",") if p.strip()
                )
            except ValueError:
                pass
        return value


def _set_dotted(cfg: Any, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"Unknown config section {p!r} in --{dotted}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not dataclasses.is_dataclass(obj) or leaf not in {
        f.name for f in dataclasses.fields(obj)
    }:
        raise KeyError(f"Unknown config key {leaf!r} in --{dotted}")
    ftype = {f.name: f.type for f in dataclasses.fields(obj)}[leaf]
    current = getattr(obj, leaf)
    target = type(current) if current is not None else ftype
    coerced = _coerce(value, target)
    if leaf == "sources":
        if not isinstance(coerced, tuple):
            coerced = (coerced,)
        coerced = tuple(
            DatasetSourceConfig(**s) if isinstance(s, dict) else s
            for s in coerced
        )
        bad = [s for s in coerced if not isinstance(s, DatasetSourceConfig)]
        if bad:
            raise ValueError(
                f"--{dotted} must be a JSON list of objects, got {bad!r}; "
                'e.g. --data.sources=\'[{"kind":"synthetic",'
                '"num_samples":256,"weight":1.0}]\''
            )
    setattr(obj, leaf, coerced)


def _apply_dict(obj: Any, d: dict) -> None:
    names = {f.name for f in dataclasses.fields(obj)}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"Unknown config key {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v)
        elif k == "sources" and isinstance(v, list):
            setattr(obj, k, tuple(DatasetSourceConfig(**src) for src in v))
        elif isinstance(v, list):
            setattr(obj, k, tuple(v))
        else:
            setattr(obj, k, v)


def load_config(argv: Optional[Sequence[str]] = None) -> Config:
    """Build a Config from an optional YAML file plus --dotted.key=value flags.

    ``--config path.yaml`` loads a YAML (or JSON) file first; remaining flags
    override individual fields, e.g. ``--model.use_pallas=true``.
    """
    cfg = Config()
    argv = list(argv or [])
    remaining = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--config" or a.startswith("--config="):
            path = a.split("=", 1)[1] if "=" in a else argv[i + 1]
            i += 1 if "=" in a else 2
            with open(path) as f:
                text = f.read()
            try:
                import yaml  # type: ignore

                d = yaml.safe_load(text)
            except ImportError:  # no yaml on this host: JSON files only
                d = json.loads(text)
            _apply_dict(cfg, d or {})
        else:
            remaining.append(a)
            i += 1
    for a in remaining:
        if not a.startswith("--"):
            raise ValueError(f"Unrecognized argument {a!r} (expected --key=value)")
        body = a[2:]
        if "=" not in body:
            raise ValueError(f"Flag {a!r} needs =value")
        key, value = body.split("=", 1)
        _set_dotted(cfg, key, value)
    return cfg


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
