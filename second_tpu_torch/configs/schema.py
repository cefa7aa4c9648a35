"""Typed config schema mirroring the reference proto surface.

Message/field names match the reference protos (second/protos/*.proto:
pipeline.proto, second.proto, input_reader.proto, optimizer.proto,
train.proto, target.proto, anchors.proto, similarity.proto,
box_coder.proto, losses.proto, sampler.proto, preprocess.proto,
voxel_generator.proto) so that the reference ``.config`` text-proto
files parse unchanged — the config surface is the public API.  The
implementation is a fresh dataclass-style schema builder on top of
:mod:`.textproto`; no protoc codegen.

proto3 semantics implemented here:
  - unset scalars default to 0 / 0.0 / False / ""
  - unset singular (non-oneof) message fields read as a default instance
  - oneof members (annotated ``Optional[Msg]``) default to ``None``;
    ``WhichOneof(group)`` reports which member is set
  - repeated fields default to ``[]``; ``map<string, T>`` to ``{}``
  - scalars use last-one-wins when repeated in the text
"""

from __future__ import annotations

import enum
import typing
from typing import Dict, List, Optional

from . import textproto


class ConfigError(ValueError):
    pass


def _convert_scalar(tok: str, typ, field: str):
    if isinstance(tok, dict):
        raise ConfigError(f"field {field!r}: expected scalar, got message")
    if typ is str:
        if not tok.startswith('"'):
            raise ConfigError(f"field {field!r}: expected string, got {tok!r}")
        return tok[1:]
    if tok.startswith('"'):
        raise ConfigError(f"field {field!r}: expected {typ}, got string {tok[1:]!r}")
    if typ is bool:
        low = tok.lower()
        if low in ("true", "1"):
            return True
        if low in ("false", "0"):
            return False
        raise ConfigError(f"field {field!r}: bad bool {tok!r}")
    if typ is int:
        try:
            return int(tok, 0)
        except ValueError:
            # accept float-looking ints like "1e3"
            f = float(tok)
            if f != int(f):
                raise ConfigError(f"field {field!r}: bad int {tok!r}")
            return int(f)
    if typ is float:
        return float(tok)
    if isinstance(typ, type) and issubclass(typ, enum.IntEnum):
        try:
            return typ[tok]
        except KeyError:
            try:
                return typ(int(tok))
            except ValueError:
                raise ConfigError(f"field {field!r}: bad enum value {tok!r}")
    raise ConfigError(f"field {field!r}: unsupported scalar type {typ}")


def _fmt_scalar(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, enum.IntEnum):
        return v.name
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, float):
        return repr(v)
    return str(v)


class Message:
    """Base class; subclasses declare fields via class annotations."""

    _hints_cache: dict = {}

    def __setattr__(self, name, value):
        # Reject typo'd field names (e.g. `sigmoid_focal` instead of
        # `weighted_sigmoid_focal`) which would otherwise be silently
        # ignored by every consumer of the config.
        if not name.startswith("_") and name not in self._hints():
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r} "
                f"(known: {sorted(self._hints())})")
        object.__setattr__(self, name, value)

    def __init__(self, **kwargs):
        hints = self._hints()
        for name, typ in hints.items():
            if name in kwargs:
                setattr(self, name, kwargs.pop(name))
            else:
                setattr(self, name, self._default_for(typ))
        if kwargs:
            raise ConfigError(f"{type(self).__name__}: unknown fields {sorted(kwargs)}")

    @classmethod
    def _hints(cls):
        cached = Message._hints_cache.get(cls)
        if cached is None:
            hints = {
                k: v
                for k, v in typing.get_type_hints(cls).items()
                if not k.startswith("_")
            }
            cached = Message._hints_cache[cls] = hints
        return cached

    @staticmethod
    def _default_for(typ):
        origin = typing.get_origin(typ)
        if origin in (list, List):
            return []
        if origin in (dict, Dict):
            return {}
        if origin is typing.Union:  # Optional[Msg] — oneof member
            return None
        if isinstance(typ, type) and issubclass(typ, Message):
            return typ()
        if isinstance(typ, type) and issubclass(typ, enum.IntEnum):
            return typ(0)
        return typ()  # int/float/bool/str zero values

    @classmethod
    def from_raw(cls, raw: textproto.RawMessage) -> "Message":
        obj = cls()
        hints = cls._hints()
        for name, values in raw.items():
            if name not in hints:
                raise ConfigError(f"{cls.__name__}: unknown field {name!r}")
            typ = hints[name]
            origin = typing.get_origin(typ)
            if origin in (list, List):
                (elem,) = typing.get_args(typ)
                if isinstance(elem, type) and issubclass(elem, Message):
                    setattr(obj, name, [elem.from_raw(v) for v in values])
                else:
                    setattr(
                        obj, name, [_convert_scalar(v, elem, name) for v in values]
                    )
            elif origin in (dict, Dict):
                kt, vt = typing.get_args(typ)
                out = {}
                for entry in values:
                    if not isinstance(entry, dict):
                        raise ConfigError(f"map field {name!r}: expected message entry")
                    key = _convert_scalar(entry["key"][-1], kt, name + ".key")
                    val = _convert_scalar(entry["value"][-1], vt, name + ".value")
                    out[key] = val
                setattr(obj, name, out)
            elif origin is typing.Union:  # Optional[Msg]
                args = [a for a in typing.get_args(typ) if a is not type(None)]
                (msg_t,) = args
                setattr(obj, name, msg_t.from_raw(values[-1]))
            elif isinstance(typ, type) and issubclass(typ, Message):
                setattr(obj, name, typ.from_raw(values[-1]))
            else:
                setattr(obj, name, _convert_scalar(values[-1], typ, name))
        return obj

    # ---- oneof support -------------------------------------------------
    _ONEOFS: Dict[str, tuple] = {}

    def WhichOneof(self, group: str) -> Optional[str]:
        members = self._ONEOFS.get(group)
        if members is None:
            raise ConfigError(f"{type(self).__name__}: no oneof group {group!r}")
        for m in members:
            if getattr(self, m) is not None:
                return m
        return None

    def HasField(self, name: str) -> bool:
        return getattr(self, name) is not None

    # ---- text-format serialization ------------------------------------
    def to_text(self, indent=0) -> str:
        """Serialize back to protobuf text format (parseable by both this
        parser and protobuf's text_format)."""
        pad = "  " * indent
        lines = []
        hints = self._hints()
        for name, typ in hints.items():
            v = getattr(self, name)
            origin = typing.get_origin(typ)
            if v is None:
                continue
            if origin in (list, List):
                (elem,) = typing.get_args(typ)
                if not v:
                    continue
                if isinstance(elem, type) and issubclass(elem, Message):
                    for item in v:
                        lines.append(pad + name + " {")
                        lines.append(item.to_text(indent + 1).rstrip("\n"))
                        lines.append(pad + "}")
                else:
                    vals = ", ".join(_fmt_scalar(x) for x in v)
                    lines.append(f"{pad}{name}: [{vals}]")
            elif origin in (dict, Dict):
                for key, val in v.items():
                    lines.append(pad + name + " {")
                    lines.append(f"{pad}  key: {_fmt_scalar(key)}")
                    lines.append(f"{pad}  value: {_fmt_scalar(val)}")
                    lines.append(pad + "}")
            elif isinstance(v, Message):
                body = v.to_text(indent + 1).rstrip("\n")
                if not body and origin is not typing.Union:
                    continue  # default singular message: omit
                lines.append(pad + name + " {")
                if body:
                    lines.append(body)
                lines.append(pad + "}")
            else:
                if v == self._default_for(typ) and origin is not typing.Union:
                    continue  # proto3: omit default scalars
                lines.append(f"{pad}{name}: {_fmt_scalar(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def __repr__(self):
        parts = []
        for name in self._hints():
            v = getattr(self, name)
            if v is None or v == self._default_for(self._hints()[name]):
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(
            getattr(self, n) == getattr(other, n) for n in self._hints()
        )


# ---------------------------------------------------------------------------
# voxel_generator.proto
# ---------------------------------------------------------------------------


class VoxelGenerator(Message):
    voxel_size: List[float]
    point_cloud_range: List[float]
    max_number_of_points_per_voxel: int
    full_empty_part_with_mean: bool
    block_filtering: bool
    block_factor: int
    block_size: int
    height_threshold: float


# ---------------------------------------------------------------------------
# anchors.proto
# ---------------------------------------------------------------------------


class AnchorGeneratorStride(Message):
    sizes: List[float]
    strides: List[float]
    offsets: List[float]
    rotations: List[float]
    custom_values: List[float]


class AnchorGeneratorRange(Message):
    sizes: List[float]
    anchor_ranges: List[float]
    rotations: List[float]
    custom_values: List[float]


class NoAnchor(Message):
    pass


# ---------------------------------------------------------------------------
# similarity.proto
# ---------------------------------------------------------------------------


class RotateIouSimilarity(Message):
    pass


class NearestIouSimilarity(Message):
    pass


class DistanceSimilarity(Message):
    distance_norm: float
    with_rotation: bool
    rotation_alpha: float


class RegionSimilarityCalculator(Message):
    rotate_iou_similarity: Optional[RotateIouSimilarity]
    nearest_iou_similarity: Optional[NearestIouSimilarity]
    distance_similarity: Optional[DistanceSimilarity]

    _ONEOFS = {
        "region_similarity": (
            "rotate_iou_similarity",
            "nearest_iou_similarity",
            "distance_similarity",
        )
    }


# ---------------------------------------------------------------------------
# box_coder.proto
# ---------------------------------------------------------------------------


class GroundBox3dCoder(Message):
    linear_dim: bool
    encode_angle_vector: bool


class BevBoxCoder(Message):
    linear_dim: bool
    encode_angle_vector: bool
    z_fixed: float
    h_fixed: float


class BoxCoder(Message):
    ground_box3d_coder: Optional[GroundBox3dCoder]
    bev_box_coder: Optional[BevBoxCoder]

    _ONEOFS = {"box_coder": ("ground_box3d_coder", "bev_box_coder")}


# ---------------------------------------------------------------------------
# target.proto
# ---------------------------------------------------------------------------


class ClassSetting(Message):
    anchor_generator_stride: Optional[AnchorGeneratorStride]
    anchor_generator_range: Optional[AnchorGeneratorRange]
    no_anchor: Optional[NoAnchor]
    region_similarity_calculator: RegionSimilarityCalculator
    use_multi_class_nms: bool
    use_rotate_nms: bool
    nms_pre_max_size: int
    nms_post_max_size: int
    nms_score_threshold: float
    nms_iou_threshold: float
    matched_threshold: float
    unmatched_threshold: float
    class_name: str
    feature_map_size: List[int]

    _ONEOFS = {
        "anchor_generator": (
            "anchor_generator_stride",
            "anchor_generator_range",
            "no_anchor",
        )
    }


class TargetAssigner(Message):
    class_settings: List[ClassSetting]
    sample_positive_fraction: float
    sample_size: int
    assign_per_class: bool
    nms_pre_max_sizes: List[int]
    nms_post_max_sizes: List[int]
    nms_score_thresholds: List[int]
    nms_iou_thresholds: List[int]


# ---------------------------------------------------------------------------
# losses.proto
# ---------------------------------------------------------------------------


class WeightedL2LocalizationLoss(Message):
    anchorwise_output: bool
    code_weight: List[float]


class WeightedSmoothL1LocalizationLoss(Message):
    anchorwise_output: bool
    sigma: float
    code_weight: List[float]


class WeightedGHMLocalizationLoss(Message):
    anchorwise_output: bool
    mu: float
    bins: int
    momentum: float
    code_weight: List[float]


class LocalizationLoss(Message):
    weighted_l2: Optional[WeightedL2LocalizationLoss]
    weighted_smooth_l1: Optional[WeightedSmoothL1LocalizationLoss]
    weighted_ghm: Optional[WeightedGHMLocalizationLoss]
    encode_rad_error_by_sin: bool

    _ONEOFS = {
        "localization_loss": ("weighted_l2", "weighted_smooth_l1", "weighted_ghm")
    }


class WeightedSigmoidClassificationLoss(Message):
    anchorwise_output: bool


class SigmoidFocalClassificationLoss(Message):
    anchorwise_output: bool
    gamma: float
    alpha: float


class SoftmaxFocalClassificationLoss(Message):
    anchorwise_output: bool
    gamma: float
    alpha: float


class GHMClassificationLoss(Message):
    anchorwise_output: bool
    bins: int
    momentum: float


class WeightedSoftmaxClassificationLoss(Message):
    anchorwise_output: bool
    logit_scale: float


class BootstrappedSigmoidClassificationLoss(Message):
    alpha: float
    hard_bootstrap: bool
    anchorwise_output: bool


class ClassificationLoss(Message):
    weighted_sigmoid: Optional[WeightedSigmoidClassificationLoss]
    weighted_softmax: Optional[WeightedSoftmaxClassificationLoss]
    bootstrapped_sigmoid: Optional[BootstrappedSigmoidClassificationLoss]
    weighted_sigmoid_focal: Optional[SigmoidFocalClassificationLoss]
    weighted_softmax_focal: Optional[SoftmaxFocalClassificationLoss]
    weighted_ghm: Optional[GHMClassificationLoss]

    _ONEOFS = {
        "classification_loss": (
            "weighted_sigmoid",
            "weighted_softmax",
            "bootstrapped_sigmoid",
            "weighted_sigmoid_focal",
            "weighted_softmax_focal",
            "weighted_ghm",
        )
    }


class HardExampleMiner(Message):
    class LossType(enum.IntEnum):
        BOTH = 0
        CLASSIFICATION = 1
        LOCALIZATION = 2

    num_hard_examples: int
    iou_threshold: float
    loss_type: "HardExampleMiner.LossType"
    max_negatives_per_positive: int
    min_negatives_per_image: int


class Loss(Message):
    localization_loss: LocalizationLoss
    classification_loss: ClassificationLoss
    hard_example_miner: HardExampleMiner
    classification_weight: float
    localization_weight: float


# ---------------------------------------------------------------------------
# second.proto
# ---------------------------------------------------------------------------


class LossNormType(enum.IntEnum):
    NormByNumExamples = 0
    NormByNumPositives = 1
    NormByNumPosNeg = 2
    DontNorm = 3


class VoxelFeatureExtractor(Message):
    module_class_name: str
    num_filters: List[int]
    with_distance: bool
    num_input_features: int


class MiddleFeatureExtractor(Message):
    module_class_name: str
    num_filters_down1: List[int]
    num_filters_down2: List[int]
    num_input_features: int
    downsample_factor: int


class RPN(Message):
    module_class_name: str
    layer_nums: List[int]
    layer_strides: List[int]
    num_filters: List[int]
    upsample_strides: List[float]
    num_upsample_filters: List[int]
    use_groupnorm: bool
    num_groups: int
    num_input_features: int


class VoxelNet(Message):
    network_class_name: str
    voxel_generator: VoxelGenerator
    voxel_feature_extractor: VoxelFeatureExtractor
    middle_feature_extractor: MiddleFeatureExtractor
    rpn: RPN
    num_point_features: int
    use_sigmoid_score: bool
    loss: Loss
    encode_rad_error_by_sin: bool
    encode_background_as_zeros: bool
    use_direction_classifier: bool
    direction_loss_weight: float
    pos_class_weight: float
    neg_class_weight: float
    loss_norm_type: LossNormType
    box_coder: BoxCoder
    target_assigner: TargetAssigner
    post_center_limit_range: List[float]
    direction_offset: float
    sin_error_factor: float
    nms_class_agnostic: bool
    num_direction_bins: int
    direction_limit_offset: float
    lidar_input: bool


class DetectionModel(Message):
    second: Optional[VoxelNet]

    _ONEOFS = {"model": ("second",)}


# ---------------------------------------------------------------------------
# preprocess.proto / sampler.proto
# ---------------------------------------------------------------------------


class DBFilterByDifficulty(Message):
    removed_difficulties: List[int]


class DBFilterByMinNumPointInGroundTruth(Message):
    min_num_point_pairs: Dict[str, int]


class DatabasePreprocessingStep(Message):
    filter_by_difficulty: Optional[DBFilterByDifficulty]
    filter_by_min_num_points: Optional[DBFilterByMinNumPointInGroundTruth]

    _ONEOFS = {
        "database_preprocessing_step": (
            "filter_by_difficulty",
            "filter_by_min_num_points",
        )
    }


class Group(Message):
    name_to_max_num: Dict[str, int]


class Sampler(Message):
    database_info_path: str
    sample_groups: List[Group]
    database_prep_steps: List[DatabasePreprocessingStep]
    global_random_rotation_range_per_object: List[float]
    rate: float


# ---------------------------------------------------------------------------
# input_reader.proto
# ---------------------------------------------------------------------------


class DatasetConfig(Message):
    kitti_info_path: str
    kitti_root_path: str
    dataset_class_name: str


class Preprocess(Message):
    shuffle_points: bool
    max_number_of_voxels: int
    groundtruth_localization_noise_std: List[float]
    groundtruth_rotation_uniform_noise: List[float]
    global_rotation_uniform_noise: List[float]
    global_scaling_uniform_noise: List[float]
    global_translate_noise_std: List[float]
    remove_unknown_examples: bool
    num_workers: int
    anchor_area_threshold: float
    remove_points_after_sample: bool
    groundtruth_points_drop_percentage: float
    groundtruth_drop_max_keep_points: int
    remove_environment: bool
    global_random_rotation_range_per_object: List[float]
    database_prep_steps: List[DatabasePreprocessingStep]
    database_sampler: Sampler
    use_group_id: bool
    min_num_of_points_in_gt: int
    random_flip_x: bool
    random_flip_y: bool
    sample_importance: float


class InputReader(Message):
    batch_size: int
    dataset: DatasetConfig
    preprocess: Preprocess
    max_num_epochs: int
    prefetch_size: int


# ---------------------------------------------------------------------------
# optimizer.proto
# ---------------------------------------------------------------------------


class MultiPhase(Message):
    class LearningRatePhase(Message):
        start: float
        lambda_func: str
        momentum_lambda_func: str

    phases: List["MultiPhase.LearningRatePhase"]


class OneCycle(Message):
    lr_max: float
    moms: List[float]
    div_factor: float
    pct_start: float


class ExponentialDecay(Message):
    initial_learning_rate: float
    decay_length: float
    decay_factor: float
    staircase: bool


class ManualStepping(Message):
    boundaries: List[float]
    rates: List[float]


class LearningRate(Message):
    multi_phase: Optional[MultiPhase]
    one_cycle: Optional[OneCycle]
    exponential_decay: Optional[ExponentialDecay]
    manual_stepping: Optional[ManualStepping]

    _ONEOFS = {
        "learning_rate": (
            "multi_phase",
            "one_cycle",
            "exponential_decay",
            "manual_stepping",
        )
    }


class RMSPropOptimizer(Message):
    learning_rate: LearningRate
    momentum_optimizer_value: float
    decay: float
    epsilon: float
    weight_decay: float


class MomentumOptimizer(Message):
    learning_rate: LearningRate
    momentum_optimizer_value: float
    weight_decay: float


class AdamOptimizer(Message):
    learning_rate: LearningRate
    weight_decay: float
    amsgrad: bool


class Optimizer(Message):
    rms_prop_optimizer: Optional[RMSPropOptimizer]
    momentum_optimizer: Optional[MomentumOptimizer]
    adam_optimizer: Optional[AdamOptimizer]
    use_moving_average: bool
    moving_average_decay: float
    fixed_weight_decay: bool

    _ONEOFS = {
        "optimizer": ("rms_prop_optimizer", "momentum_optimizer", "adam_optimizer")
    }


# ---------------------------------------------------------------------------
# train.proto / pipeline.proto
# ---------------------------------------------------------------------------


class TrainConfig(Message):
    optimizer: Optimizer
    steps: int
    steps_per_eval: int
    save_checkpoints_secs: int
    save_summary_steps: int
    enable_mixed_precision: bool
    loss_scale_factor: float
    clear_metrics_every_epoch: bool


class TrainEvalPipelineConfig(Message):
    model: DetectionModel
    train_input_reader: InputReader
    train_config: TrainConfig
    eval_input_reader: InputReader


def load_pipeline_config(path) -> TrainEvalPipelineConfig:
    """Parse a SECOND-style text-proto pipeline ``.config`` file."""
    raw = textproto.parse_file(path)
    return TrainEvalPipelineConfig.from_raw(raw)


def loads_pipeline_config(text: str) -> TrainEvalPipelineConfig:
    return TrainEvalPipelineConfig.from_raw(textproto.parse(text))
