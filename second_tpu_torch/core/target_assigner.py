"""TargetAssigner: per-class anchor generation + gt matching.

Reference: second/core/target_assigner.py. Holds one anchor generator +
similarity calculator per class; anchors for all classes are generated
once per run and cached by the dataset builder.
"""

from collections import OrderedDict

import numpy as np

from .target_ops import create_target_np


class TargetAssigner:
    def __init__(self,
                 box_coder,
                 anchor_generators,
                 classes,
                 feature_map_sizes,
                 positive_fraction=None,
                 region_similarity_calculators=None,
                 sample_size=512,
                 assign_per_class=True):
        self._box_coder = box_coder
        self._anchor_generators = anchor_generators
        self._sim_calcs = region_similarity_calculators
        box_ndims = [a.ndim for a in anchor_generators]
        assert all(e == box_ndims[0] for e in box_ndims)
        self._positive_fraction = positive_fraction
        self._sample_size = sample_size
        self._classes = classes
        self._assign_per_class = assign_per_class
        self._feature_map_sizes = feature_map_sizes

    @property
    def box_coder(self):
        return self._box_coder

    @property
    def classes(self):
        return self._classes

    @property
    def box_ndim(self):
        return self._anchor_generators[0].ndim

    @property
    def num_anchors_per_location(self):
        return sum(
            a.num_anchors_per_localization for a in self._anchor_generators
        )

    def assign(self,
               anchors,
               anchors_dict,
               gt_boxes,
               anchors_mask=None,
               gt_classes=None,
               gt_names=None,
               matched_thresholds=None,
               unmatched_thresholds=None,
               importance=None):
        if self._assign_per_class:
            return self.assign_per_class(
                anchors_dict, gt_boxes, anchors_mask, gt_classes, gt_names,
                importance=importance)
        return self.assign_all(
            anchors, gt_boxes, anchors_mask, gt_classes,
            matched_thresholds, unmatched_thresholds, importance=importance)

    def assign_all(self,
                   anchors,
                   gt_boxes,
                   anchors_mask=None,
                   gt_classes=None,
                   matched_thresholds=None,
                   unmatched_thresholds=None,
                   importance=None):
        prune_anchor_fn = (
            (lambda _: np.where(anchors_mask)[0]) if anchors_mask is not None else None
        )

        def similarity_fn(anchors, gt_boxes):
            anchors_rbv = anchors[:, [0, 1, 3, 4, 6]]
            gt_boxes_rbv = gt_boxes[:, [0, 1, 3, 4, 6]]
            return self._sim_calcs[0].compare(anchors_rbv, gt_boxes_rbv)

        return create_target_np(
            anchors,
            gt_boxes,
            similarity_fn,
            self._box_coder.encode,
            prune_anchor_fn=prune_anchor_fn,
            gt_classes=gt_classes,
            matched_threshold=matched_thresholds,
            unmatched_threshold=unmatched_thresholds,
            positive_fraction=self._positive_fraction,
            rpn_batch_size=self._sample_size,
            norm_by_num_examples=False,
            box_code_size=self._box_coder.code_size,
            gt_importance=importance)

    def assign_per_class(self,
                         anchors_dict,
                         gt_boxes,
                         anchors_mask=None,
                         gt_classes=None,
                         gt_names=None,
                         importance=None):
        """Assign targets independently per class (multi-class nets)."""
        targets_list = []
        for idx, (class_name, anchor_dict) in enumerate(anchors_dict.items()):
            sim_calc = self._sim_calcs[idx]

            def similarity_fn(anchors, gt_boxes, _sim=sim_calc):
                anchors_rbv = anchors[:, [0, 1, 3, 4, 6]]
                gt_boxes_rbv = gt_boxes[:, [0, 1, 3, 4, 6]]
                return _sim.compare(anchors_rbv, gt_boxes_rbv)

            mask = np.array([c == class_name for c in gt_names], dtype=np.bool_)
            if anchors_mask is not None:
                flat_mask = anchors_mask.reshape(-1)
                a_range = self.anchors_range(class_name)
                anchors_mask_class = flat_mask[a_range[0]:a_range[1]].reshape(-1)
                prune_anchor_fn = (
                    lambda _, m=anchors_mask_class: np.where(m)[0]
                )
            else:
                prune_anchor_fn = None
            targets = create_target_np(
                anchor_dict["anchors"].reshape(-1, self.box_ndim),
                gt_boxes[mask],
                similarity_fn,
                self._box_coder.encode,
                prune_anchor_fn=prune_anchor_fn,
                gt_classes=gt_classes[mask],
                matched_threshold=anchor_dict["matched_thresholds"],
                unmatched_threshold=anchor_dict["unmatched_thresholds"],
                positive_fraction=self._positive_fraction,
                rpn_batch_size=self._sample_size,
                norm_by_num_examples=False,
                box_code_size=self._box_coder.code_size,
                gt_importance=importance)
            targets_list.append(targets)

        return {
            "labels": np.concatenate(
                [t["labels"].reshape(-1) for t in targets_list], axis=0),
            "bbox_targets": np.concatenate(
                [t["bbox_targets"].reshape(-1, self._box_coder.code_size)
                 for t in targets_list], axis=0),
            "importance": np.concatenate(
                [t["importance"].reshape(-1) for t in targets_list], axis=0),
        }

    def generate_anchors(self, feature_map_size):
        anchors_list, match_list, unmatch_list = [], [], []
        feature_map_sizes = self._resolve_fmap_sizes(feature_map_size)
        ndim = len(feature_map_size)
        for gen, fsize in zip(self._anchor_generators, feature_map_sizes):
            anchors = gen.generate(fsize)
            anchors = anchors.reshape([*fsize, -1, self.box_ndim])
            # move the per-location anchor axis out front:
            # [*fsize, nloc, ndim] -> [nloc, *fsize, ndim]
            anchors = anchors.transpose(ndim, *range(0, ndim), ndim + 1)
            anchors_list.append(anchors.reshape(-1, self.box_ndim))
            num = np.prod(anchors.shape[:-1])
            match_list.append(np.full([num], gen.match_threshold, anchors.dtype))
            unmatch_list.append(np.full([num], gen.unmatch_threshold, anchors.dtype))
        return {
            "anchors": np.concatenate(anchors_list, axis=0),
            "matched_thresholds": np.concatenate(match_list, axis=0),
            "unmatched_thresholds": np.concatenate(unmatch_list, axis=0),
        }

    def generate_anchors_dict(self, feature_map_size):
        anchors_dict = OrderedDict(
            (a.class_name, {}) for a in self._anchor_generators
        )
        feature_map_sizes = self._resolve_fmap_sizes(feature_map_size)
        ndim = len(feature_map_size)
        for gen, fsize in zip(self._anchor_generators, feature_map_sizes):
            anchors = gen.generate(fsize)
            anchors = anchors.reshape([*fsize, -1, self.box_ndim])
            anchors = anchors.transpose(ndim, *range(0, ndim), ndim + 1)
            num = np.prod(anchors.shape[:-1])
            d = anchors_dict[gen.class_name]
            d["anchors"] = anchors.reshape(-1, self.box_ndim)
            d["matched_thresholds"] = np.full(
                [num], gen.match_threshold, anchors.dtype)
            d["unmatched_thresholds"] = np.full(
                [num], gen.unmatch_threshold, anchors.dtype)
        return anchors_dict

    def _resolve_fmap_sizes(self, feature_map_size):
        if self._feature_map_sizes is None:
            return [feature_map_size] * len(self._anchor_generators)
        out = []
        for idx, fsize in enumerate(self._feature_map_sizes):
            if fsize is None or len(fsize) == 0:
                fsize = feature_map_size
                self._feature_map_sizes[idx] = feature_map_size
            out.append(fsize)
        return out

    def num_anchors(self, class_name):
        if isinstance(class_name, int):
            class_name = self._classes[class_name]
        class_idx = self._classes.index(class_name)
        if class_idx >= len(self._anchor_generators):
            # no_anchor class (trailing by contract — see
            # target_assigner_builder): contributes zero anchors
            return 0
        ag = self._anchor_generators[class_idx]
        feature_map_size = self._feature_map_sizes[class_idx]
        return np.prod(feature_map_size) * ag.num_anchors_per_localization

    def anchors_range(self, class_name):
        if isinstance(class_name, int):
            class_name = self._classes[class_name]
        start = 0
        for name in self._classes:
            n = self.num_anchors(name)
            if name == class_name:
                return (start, start + n)
            start += n
        raise ValueError(f"unknown class {class_name}")

    def num_anchors_per_location_class(self, class_name):
        if isinstance(class_name, int):
            class_name = self._classes[class_name]
        class_idx = self._classes.index(class_name)
        return self._anchor_generators[class_idx].num_anchors_per_localization
