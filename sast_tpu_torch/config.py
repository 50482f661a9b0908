"""Typed configuration tree for the PyTorch/CUDA port.

The port's own copy of ``sast_tpu/config.py`` (same dataclasses, same
``get_config`` / ``get_test_config``), so that one configuration means the
same model in both packages. Resolution rounding to a multiple of
``32 * partition_split_32``, derivation of attention partition sizes from the
model resolution, per-dataset class counts, and the tiny/small/base/large
experiment overlays.

How the port reads the kernel switches of ``BackboneConfig``:

- ``stem_pallas``: the 7x7/stride-4 stem goes through the hand-written stem
  kernel (``ops/stem_conv.py``) where its static gate holds.
- ``ratio_pallas``: the standalone density pyramid goes through the density
  kernel (``ops/density.py``) where its static gate holds.
- ``fuse_stem_density``: the stem kernel also emits the density ratio from
  its own input read (needs both switches above).
- ``stem_raw_fetch``: no effect in the port; its stem kernel always reads
  the native uint8 tensor.

How the port reads the attention switches of ``AttentionConfig``
(``models/sast.py`` has the dispatch): ``fused_block`` sends the block
through the dense fused kernel (``ops/fused_block.py``), ``gather_budget``
through the masked torch-op math on a gathered prefix of kept windows, and
``pallas_density_threshold`` is the window density up to which the
window-skipping kernel (``ops/sparse_block.py``) runs when the model was
built with ``sparse_kernel`` (the JAX package's ``use_pallas``).

Two backbones: ``BackboneConfig.name`` ``"SASTRNN"`` (the default, SAST's
scene-adaptive backbone, ``models/backbone.py``, whose layers have a gated
MLP) and ``"MaxViTRNN"`` (RVT's dense window-and-grid backbone,
``models/maxvit.py``, whose layers have an ungated one; the JAX package has
no such backbone): ``get_config(..., **{"model.backbone.name":
"MaxViTRNN"})`` is RVT.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple


def _round_up(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

# Native sensor resolutions (reference: data/utils/spatial.py:5-27).
DATASET_RES_HW: Dict[str, Tuple[int, int]] = {
    "gen1": (240, 304),
    "gen4": (720, 1280),
}
DATASET_NUM_CLASSES: Dict[str, int] = {"gen1": 2, "gen4": 3}
# gen1: (car, pedestrian); gen4: (pedestrian, two-wheeler, car)
DATASET_CLASSES: Dict[str, Tuple[str, ...]] = {
    "gen1": ("car", "pedestrian"),
    "gen4": ("pedestrian", "two-wheeler", "car"),
}


@dataclass(frozen=True)
class ZoomAugConfig:
    prob: float = 0.8
    zoom_in_weight: float = 8.0
    zoom_out_weight: float = 2.0
    zoom_in_min: float = 1.0
    zoom_in_max: float = 1.5
    zoom_out_min: float = 1.0
    zoom_out_max: float = 1.2


@dataclass(frozen=True)
class AugmentConfig:
    """Spatial augmentation (reference: config/dataset/base.yaml data_augmentation)."""

    prob_hflip: float = 0.5
    rotate_prob: float = 0.0
    rotate_min_angle_deg: float = 2.0
    rotate_max_angle_deg: float = 6.0
    zoom: ZoomAugConfig = field(default_factory=ZoomAugConfig)
    # Stream-mode zoom only zooms out (reference base.yaml stream group).
    zoom_out_only: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "gen1"
    path: str = ""
    # 'random' | 'stream' | 'mixed'
    train_sampling: str = "mixed"
    eval_sampling: str = "stream"
    mixed_w_stream: float = 1.0
    mixed_w_random: float = 1.0
    weighted_sampling: bool = False
    ev_repr_name: str = "stacked_histogram_dt=50_nbins=10"
    sequence_length: int = 21  # gen1 experiment overlay; gen4 uses 5
    downsample_by_factor_2: bool = False  # gen4: True
    only_load_end_labels: bool = False
    data_augmentation_random: AugmentConfig = field(default_factory=AugmentConfig)
    data_augmentation_stream: AugmentConfig = field(
        default_factory=lambda: AugmentConfig(
            zoom=ZoomAugConfig(prob=0.5, zoom_in_weight=0.0, zoom_out_weight=1.0),
            zoom_out_only=True,
        )
    )

    # Test/synthetic hook: force a native sensor resolution instead of the
    # dataset's real one (tiny geometries compile in seconds on CPU).
    resolution_hw_override: Optional[Tuple[int, int]] = None

    @property
    def resolution_hw(self) -> Tuple[int, int]:
        if self.resolution_hw_override is not None:
            return self.resolution_hw_override
        hw = DATASET_RES_HW[self.name]
        if self.downsample_by_factor_2:
            return (hw[0] // 2, hw[1] // 2)
        return hw

    @property
    def num_classes(self) -> int:
        return DATASET_NUM_CLASSES[self.name]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    # Spatial size (h, w) of one attention window == grid cell layout.
    # Derived: partition_size = model_hw // (32 * partition_split_32).
    partition_size: Tuple[int, int] = (8, 10)
    dim_head: int = 32
    attention_bias: bool = True
    mlp_activation: str = "gelu"
    mlp_bias: bool = True
    mlp_ratio: int = 4
    drop_mlp: float = 0.0
    drop_path: float = 0.0
    ls_init_value: float = 1e-5
    enable_cb: bool = False  # Context Broadcasting
    # Opt-in execution paths of the attention block (see the module
    # docstring).
    pallas_density_threshold: float = 1.0
    fused_block: bool = False
    gather_budget: float = 0.0
    amp: float = 2e-4       # 'AMP' selection amplification constant
    bounce: float = 1e-3    # 'BOUNCE' threshold slack
    norm_eps: float = 1e-5
    # An XLA layout hint in the JAX package; no effect in the port.
    pin_partition_layout: bool = True


@dataclass(frozen=True)
class LstmConfig:
    dws_conv: bool = False
    dws_conv_only_hidden: bool = True
    dws_conv_kernel_size: int = 3
    drop_cell_update: float = 0.0


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "SASTRNN"  # or "MaxViTRNN" (module docstring)
    input_channels: int = 20
    enable_masking: bool = False
    partition_split_32: int = 1  # gen1: 1, gen4: 2
    embed_dim: int = 64
    dim_multiplier: Tuple[int, ...] = (1, 2, 4, 8)
    num_blocks: Tuple[int, ...] = (1, 1, 1, 1)
    stem_patch_size: int = 4
    downsample_overlap: bool = True
    downsample_norm_affine: bool = True
    # Kernel switches; the module docstring says how the port reads them.
    stem_pallas: bool = True
    ratio_pallas: bool = True
    fuse_stem_density: bool = True
    stem_raw_fetch: bool = True
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    lstm: LstmConfig = field(default_factory=LstmConfig)
    in_res_hw: Tuple[int, int] = (256, 320)

    @property
    def num_stages(self) -> int:
        return len(self.num_blocks)

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * m for m in self.dim_multiplier)

    @property
    def stage_strides(self) -> Tuple[int, ...]:
        strides = []
        s = 1
        for i in range(self.num_stages):
            s *= self.stem_patch_size if i == 0 else 2
            strides.append(s)
        return tuple(strides)


@dataclass(frozen=True)
class FpnConfig:
    name: str = "PAFPN"
    depth: float = 0.67
    in_stages: Tuple[int, ...] = (2, 3, 4)
    depthwise: bool = False
    act: str = "silu"


@dataclass(frozen=True)
class HeadConfig:
    name: str = "YoloX"
    num_classes: int = 2
    depthwise: bool = False
    act: str = "silu"
    # Static-shape SimOTA budgets (TPU reformulation of the reference's
    # dynamic per-image loops, yolo_head.py:452-606).
    max_gt: int = 40          # padded ground-truth budget per frame
    simota_topk: int = 10     # n_candidate_k for dynamic-k estimation


@dataclass(frozen=True)
class PostprocessConfig:
    confidence_threshold: float = 0.01
    nms_threshold: float = 0.45
    # Static budgets for the on-device NMS (TPU has no dynamic-output NMS).
    pre_nms_topk: int = 1000
    max_detections: int = 300


@dataclass(frozen=True)
class ModelConfig:
    name: str = "rnndet"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    fpn: FpnConfig = field(default_factory=FpnConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    postprocess: PostprocessConfig = field(default_factory=PostprocessConfig)
    # Computation dtype for the forward pass; params stay fp32.
    compute_dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LRSchedulerConfig:
    use: bool = True
    total_steps: int = 600_000
    pct_start: float = 0.005
    div_factor: float = 20.0       # init_lr = max_lr / div_factor
    final_div_factor: float = 10_000.0  # final_lr = max_lr / final_div_factor


@dataclass(frozen=True)
class TrainingConfig:
    precision: str = "bfloat16"
    max_steps: int = 600_000
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    gradient_clip_val: float = 1.0  # clip by value, reference train.py:169
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    batch_size_train: int = 8
    batch_size_eval: int = 8
    num_workers_train: int = 6
    num_workers_eval: int = 2
    # Per-lane labeled-frame budget (static): frames with labels inside a clip
    # that participate in the detection loss.
    max_labeled_frames_per_lane: int = 5
    ema_decay: float = 0.0  # 0 disables EMA
    seed: Optional[int] = None
    # BPTT rematerialization policy of the JAX trainer ("full", "dots", "none").
    remat_policy: str = "full"


@dataclass(frozen=True)
class ExperimentConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    @property
    def in_res_hw(self) -> Tuple[int, int]:
        return self.model.backbone.in_res_hw


# ---------------------------------------------------------------------------
# Dynamic modification (reference: config/modifier.py:10-48)
# ---------------------------------------------------------------------------


def resolve_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """Derive model resolution / partition sizes / class count from the dataset.

    Mirrors ``dynamically_modify_train_config``: rounds the dataloading H, W up
    to a multiple of ``32 * partition_split_32``, sets
    ``attention.partition_size = hw // (32 * partition_split_32)`` and the head
    class count.
    """
    ds = cfg.dataset
    bb = cfg.model.backbone
    split = bb.partition_split_32
    if split not in (1, 2, 4):
        raise ValueError(f"partition_split_32 must be 1, 2 or 4, not {split}")
    multiple = 32 * split
    hw = ds.resolution_hw
    mdl_hw = (_round_up(hw[0], multiple), _round_up(hw[1], multiple))
    partition_size = (mdl_hw[0] // multiple, mdl_hw[1] // multiple)
    if (mdl_hw[0] // 32) % partition_size[0] or (mdl_hw[1] // 32) % partition_size[1]:
        raise ValueError(f"partition {partition_size} does not tile {mdl_hw}")

    backbone = dataclasses.replace(
        bb,
        in_res_hw=mdl_hw,
        attention=dataclasses.replace(bb.attention, partition_size=partition_size),
    )
    head = dataclasses.replace(cfg.model.head, num_classes=ds.num_classes)
    model = dataclasses.replace(cfg.model, backbone=backbone, head=head)
    return dataclasses.replace(cfg, model=model)


# ---------------------------------------------------------------------------
# Presets (reference: config/experiment/{gen1,gen4}/{tiny,small,base,large}.yaml)
# ---------------------------------------------------------------------------

_SIZE_OVERLAYS: Dict[str, Dict[str, Any]] = {
    "tiny": {"embed_dim": 32, "fpn_depth": 0.33},
    # small overrides dim_head to 24 (reference
    # config/experiment/{gen1,gen4}/small.yaml:10): embed 48 is not
    # divisible by the default dim_head 32 — stage 1 would get 1.5 heads.
    "small": {"embed_dim": 48, "fpn_depth": 0.33, "dim_head": 24},
    "base": {"embed_dim": 64, "fpn_depth": 0.67},
    "large": {"embed_dim": 96, "fpn_depth": 0.67},
}


def get_config(dataset: str = "gen1", size: str = "base", **overrides: Any) -> ExperimentConfig:
    """Build a resolved experiment config.

    ``get_config('gen1', 'base')`` reproduces the reference gen1/base.yaml
    experiment; ``get_config('gen4', 'base')`` the gen4 one (downsample-by-2,
    sequence length 5, lr 3.46e-4, batch 12, partition split 2).
    """
    if dataset not in DATASET_RES_HW:
        raise ValueError(f"unknown dataset {dataset!r}")
    overlay = _SIZE_OVERLAYS[size]

    if dataset == "gen1":
        ds = DatasetConfig(name="gen1", sequence_length=21)
        split = 1
        train = TrainingConfig(max_labeled_frames_per_lane=5)
    else:
        ds = DatasetConfig(name="gen4", sequence_length=5, downsample_by_factor_2=True)
        split = 2
        train = TrainingConfig(
            learning_rate=3.46e-4,
            batch_size_train=12,
            batch_size_eval=12,
            max_labeled_frames_per_lane=3,
        )

    backbone = BackboneConfig(embed_dim=overlay["embed_dim"], partition_split_32=split)
    if "dim_head" in overlay:
        backbone = dataclasses.replace(
            backbone,
            attention=dataclasses.replace(
                backbone.attention, dim_head=overlay["dim_head"]
            ),
        )
    model = ModelConfig(backbone=backbone, fpn=FpnConfig(depth=overlay["fpn_depth"]))
    cfg = ExperimentConfig(dataset=ds, model=model, training=train)
    cfg = _apply_overrides(cfg, overrides)
    return resolve_config(cfg)


def get_test_config(in_res_hw: Tuple[int, int] = (64, 96)) -> ExperimentConfig:
    """A miniature config for fast unit tests (CPU-compilable in seconds).

    Every stage resolution must be divisible by the partition size; with
    in_res (64, 96), stage maps are (16,24)/(8,12)/(4,6)/(2,3) and partition
    (2, 3) divides them all.
    """
    backbone = BackboneConfig(
        embed_dim=32,
        in_res_hw=in_res_hw,
        attention=AttentionConfig(partition_size=(2, 3), dim_head=16),
    )
    model = ModelConfig(
        backbone=backbone,
        fpn=FpnConfig(depth=0.33),
        head=HeadConfig(num_classes=2, max_gt=8),
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=16),
        compute_dtype="float32",
    )
    ds = DatasetConfig(name="gen1", sequence_length=4)
    train = TrainingConfig(
        batch_size_train=2,
        batch_size_eval=2,
        max_labeled_frames_per_lane=2,
        max_steps=100,
    )
    return ExperimentConfig(dataset=ds, model=model, training=train)


def _apply_overrides(cfg: ExperimentConfig, overrides: Mapping[str, Any]) -> ExperimentConfig:
    """Apply dotted-path overrides, e.g. ``_apply_overrides(cfg, {"model.backbone.embed_dim": 32})``."""
    for key, value in overrides.items():
        parts = key.split(".")
        cfg = _replace_path(cfg, parts, value)
    return cfg


def _replace_path(obj: Any, parts: list, value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(child, parts[1:], value)})
