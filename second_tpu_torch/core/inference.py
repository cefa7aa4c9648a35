"""Single-frame inference API (twin of ``second_tpu/core/inference.py``).

Usage:

    ctx = InferenceContext()
    ctx.build("configs/car.fhd.config", device="cuda")
    ctx.init_random(0)              # or ctx.load_flax_variables(tree)
    example = ctx.get_inference_input_dict(info, points)
    dets = ctx.inference(example)   # ragged per-frame dicts

The host side (voxelizer, anchors, rulebook planner) is the port's copy
of the JAX package's framework-free numpy and C++; the network, decode
and NMS run in PyTorch on ``device``.
"""

import numpy as np
import torch

from ..builders.dataset_builder import build_prep_func
from ..builders.network_builder import build_network
from ..configs import load_pipeline_config
from ..data import merge_second_batch
from ..models.voxelnet import init_weights, predict
from ..utils.from_flax import from_flax


def example_to_device(example, device):
    """The network's inputs (and the training targets, where the batch
    has them) of a host batch as tensors on ``device``; rulebooks as
    int32."""
    dtypes = {"voxels": np.float32, "num_points": np.int32,
              "coordinates": np.int32, "anchors": np.float32,
              "anchors_mask": np.bool_, "labels": np.int64,
              "reg_targets": np.float32, "importance": np.float32}
    out = {}
    for k, v in example.items():
        if k in dtypes:
            out[k] = np.ascontiguousarray(v, dtype=dtypes[k])
        elif k.startswith("plan_"):
            out[k] = np.ascontiguousarray(v, dtype=np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


class InferenceContext:
    def __init__(self):
        self.config = None
        self.parts = None
        self.prep_func = None
        self.device = None

    def build(self, config_path_or_config, device):
        if isinstance(config_path_or_config, str):
            self.config = load_pipeline_config(config_path_or_config)
        else:
            self.config = config_path_or_config
        self.device = torch.device(device)
        self.parts = build_network(self.config, self.device)
        self.prep_func = build_prep_func(
            self.config.eval_input_reader, self.parts, training=False)

    def get_inference_input_dict(self, info, points):
        if self.parts is None:
            raise RuntimeError("call build first")
        input_dict = {
            "lidar": {"type": "lidar", "points": points},
            "metadata": {
                "image_idx": info["image"]["image_idx"]
                if "image" in info else 0,
            },
        }
        if "calib" in info:
            calib = info["calib"]
            input_dict["calib"] = {
                "rect": calib["R0_rect"],
                "Trv2c": calib["Tr_velo_to_cam"],
                "P2": calib["P2"],
            }
            input_dict["image"] = info.get("image")
        example = self.prep_func(input_dict=input_dict)
        example["metadata"] = input_dict["metadata"]
        return merge_second_batch([example])

    def init_random(self, seed=0):
        init_weights(self.parts["net"], torch.Generator().manual_seed(seed))

    def load_flax_variables(self, variables):
        """Load the JAX package's variables ({"params", "batch_stats"}
        trees of arrays) through :func:`from_flax`."""
        self.parts["net"].load_state_dict(from_flax(variables), strict=True)

    def run(self, example):
        """A host batch (``get_inference_input_dict``) -> the network's
        preds and ``predict``'s fixed-size detections, on the device."""
        ex = example_to_device(example, self.device)
        plan = {k: v for k, v in ex.items() if k.startswith("plan_")}
        with torch.no_grad():
            preds = self.parts["net"](
                ex["voxels"], ex["num_points"], ex["coordinates"], plan)
            dets = predict(self.parts["spec"], preds, ex)
        return preds, dets

    def inference(self, example):
        """Returns ragged per-frame detection dicts."""
        _, dets = self.run(example)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        out = []
        for b in range(dets["box3d_lidar"].shape[0]):
            valid = dets["valid"][b]
            out.append({
                "box3d_lidar": dets["box3d_lidar"][b][valid],
                "scores": dets["scores"][b][valid],
                "label_preds": dets["label_preds"][b][valid],
                "metadata": example.get("metadata", [None])[b],
            })
        return out
