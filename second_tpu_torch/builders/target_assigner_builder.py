"""TargetAssigner from proto config (reference
second/builder/target_assigner_builder.py:8-53).

The port's copy of ``second_tpu/builders/target_assigner_builder.py``."""

from ..configs import schema
from ..core.target_assigner import TargetAssigner
from . import anchor_generator_builder, similarity_calculator_builder


def build(target_assigner_config: schema.TargetAssigner, box_coder):
    classes = []
    anchor_generators = []
    similarity_calcs = []
    feature_map_sizes = []
    for class_setting in target_assigner_config.class_settings:
        anchor_generator = anchor_generator_builder.build(class_setting)
        if anchor_generator is not None:
            anchor_generators.append(anchor_generator)
        else:
            # no_anchor: the class contributes no anchors (it still
            # takes a class-settings slot for names/similarity); only
            # valid with assign_all, where thresholds ride per-anchor
            # arrays (reference target_assigner_builder.py:30-33 —
            # no_anchor classes must come last so the generator<->
            # feature_map_size zip stays aligned, as in
            # all.pp.largea.config)
            assert not target_assigner_config.assign_per_class, (
                "no_anchor requires assign_per_class: false")
        similarity_calcs.append(
            similarity_calculator_builder.build(
                class_setting.region_similarity_calculator
            )
        )
        classes.append(class_setting.class_name)
        feature_map_sizes.append(list(class_setting.feature_map_size))

    positive_fraction = target_assigner_config.sample_positive_fraction
    if positive_fraction < 0:
        positive_fraction = None
    return TargetAssigner(
        box_coder=box_coder,
        anchor_generators=anchor_generators,
        classes=classes,
        feature_map_sizes=feature_map_sizes,
        positive_fraction=positive_fraction,
        region_similarity_calculators=similarity_calcs,
        sample_size=target_assigner_config.sample_size,
        assign_per_class=target_assigner_config.assign_per_class,
    )
