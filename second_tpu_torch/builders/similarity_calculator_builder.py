"""Region similarity calculator from proto config (reference
second/builder/similarity_calculator_builder.py:7-31).

The port's copy of ``second_tpu/builders/similarity_calculator_builder.py``."""

from ..configs import schema
from ..core import region_similarity


def build(similarity_config: schema.RegionSimilarityCalculator):
    which = similarity_config.WhichOneof("region_similarity")
    if which == "rotate_iou_similarity":
        return region_similarity.RotateIouSimilarity()
    if which == "nearest_iou_similarity":
        return region_similarity.NearestIouSimilarity()
    if which == "distance_similarity":
        cfg = similarity_config.distance_similarity
        return region_similarity.DistanceSimilarity(
            distance_norm=cfg.distance_norm,
            with_rotation=cfg.with_rotation,
            rotation_alpha=cfg.rotation_alpha,
        )
    raise ValueError("unknown similarity type")
