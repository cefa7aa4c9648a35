"""Single-frame inference API (twin of ``second_tpu/core/inference.py``).

Usage:

    ctx = InferenceContext()
    ctx.build("configs/car.fhd.config", device="cuda")
    ctx.init_random(0)              # or ctx.load_flax_variables(tree),
                                    # ctx.restore_latest(model_dir)
    example = ctx.get_inference_input_dict(info, points)
    dets = ctx.inference(example)   # ragged per-frame dicts

The host side (voxelizer, anchors) is the port's copy of the JAX
package's framework-free numpy and C++; the network, decode and NMS run
in PyTorch on ``device``. What a request ships and how the device reads
it is its route (``builders.route``). A sparse middle (car.fhd) builds
its rulebooks on the device (``models.sparse_middle.build_device_plan``,
inside ``net.middle``), the JAX package's route when its planner is
absent: the example ships the host voxelizer's voxels, counts and
coordinates, sorted by linear id on the host, and no ``plan_*``
rulebooks. The C++ planner (``build_host_plan``) stays with the
training and evaluation loaders, where loader threads hide it behind
the step. With ``build(..., device_voxelize=True)`` the example ships
the in-range points instead, and the device voxelizes them too.

A PillarFeatureNet encoder on a dense middle (PointPillars) runs the
flat pillar path (``models.pp_fast``), as the JAX package serves it:
the example ships the points inside the range, padded to the eval
reader's ``points_capacity`` rows (``data.preprocess.pad_points``, as
training ships them: 32768 for KITTI, 393216 for nuScenes' 10 sweeps),
instead of the voxels, and the device pillarizes them. The host still
voxelizes once where the reader sets an anchor mask (PointPillars),
and not at all where it sets none. The nuScenes multi-head network
runs this path too (its ``rpn_preds`` applies both heads), without a
mask.

The anchors are a constant of the config. Every request's host batch
holds the anchor cache itself (``builders.network_builder
.make_anchor_cache``, read-only; a batch of one is a view of it), and
the device path reads a copy that ``build`` uploaded once in its place.
A batch whose anchors are any other array uploads them.

``get_inference_input_dict`` takes a KITTI info (image index and
calibration) or a nuScenes one (its sample ``token``, no image or
calibration) beside the points.

Stages (``utils.timer``; off unless collection is on or a profiler
records): ``get_inference_input_dict`` runs "prep.voxelize",
"prep.anchor_mask" (in ``prep_pointcloud``), "prep.plan" (sparse
middles on host voxels: the linear-id sort) and "prep.pack";
``inference`` runs "upload" (counting "upload_bytes", the bytes copied
up, and "anchors_resident", 1 where the device read its own anchors and
0 where the batch's were uploaded), "net.encode",
"net.middle" (a middle's stage above 64 channels inside it, as
"net.middle.wide"), "net.rpn" (the multi-head network's heads inside
it, as "net.heads") and "net.predict", and counts a sparse middle's
"sparse_rows_active" / "sparse_rows_capacity" / "sparse_rows_overflow"
(the active sites beyond a stage's capacity) from the device's stage
counts. A request that ships points counts "points_shipped" (the
in-range points ``pad_points`` kept) and "points_capacity" (the
buffer's rows) on the host, in "prep.voxelize". With collection on,
the batch carries its request's id under ``timer.REQUEST_KEY`` and both
halves record under it.
"""

import numpy as np
import torch

from ..builders.dataset_builder import build_prep_func
from ..builders.network_builder import build_network
from ..builders.route import infer, make_route
from ..configs import load_pipeline_config
from ..data import merge_second_batch
from ..models.sparse_middle import warn_overflow
from ..models.voxelnet import init_weights
from ..utils import timer
from ..utils.from_flax import from_flax

# the device-bound keys of a host batch and their dtypes (rulebooks,
# "plan_*", as int32)
DEVICE_DTYPES = {
    "voxels": np.float32, "num_points": np.int32, "coordinates": np.int32,
    "points": np.float32, "points_count": np.int32, "anchors": np.float32,
    "anchors_mask": np.bool_, "labels": np.int64, "reg_targets": np.float32,
    "importance": np.float32, "labels_i8": np.int8, "pos_idx": np.int32,
    "pos_targets": np.float32, "pos_count": np.int32}


def example_convert(example):
    """Select and cast the device-bound keys of a host batch (numpy)."""
    out = {}
    for k, v in example.items():
        if k in DEVICE_DTYPES:
            out[k] = np.ascontiguousarray(v, dtype=DEVICE_DTYPES[k])
        elif k.startswith("plan_"):
            out[k] = np.ascontiguousarray(v, dtype=np.int32)
    return out


def to_tensor(array, device):
    """A host array as a tensor on ``device``. A read-only array (the
    anchor cache, and a batch's view of it) is copied: ``torch.from_numpy``
    would hand out its memory as writable, and warns."""
    if array.flags.writeable:
        return torch.from_numpy(array).to(device)
    return torch.tensor(array, device=device)


def example_to_device(example, device):
    """The network's inputs (and the training targets, where the batch
    has them) of a host batch as tensors on ``device``."""
    with timer.span("upload"):
        host = example_convert(example)
        timer.count("upload_bytes", sum(v.nbytes for v in host.values()))
        return {k: to_tensor(v, device) for k, v in host.items()}


def _is_batch_of(batch, array):
    """Whether the host array ``batch`` is ``array[None]``, a batch of one
    in ``array``'s own memory: told from the layouts and the data
    pointer, not from the values."""
    return (batch.shape == (1,) + array.shape and batch.dtype == array.dtype
            and batch.strides[1:] == array.strides
            and batch.__array_interface__["data"][0]
            == array.__array_interface__["data"][0])


class InferenceContext:
    def __init__(self):
        self.config = None
        self.parts = None
        self.route = None
        self.prep_func = None
        self.device = None
        # the anchor cache's read-only array and its copy on the device
        self.anchors_host = None
        self.anchors_device = None

    def build(self, config_path_or_config, device, device_voxelize=False):
        """device_voxelize: ship the request's in-range points
        (``points_capacity`` rows) and voxelize them on the device; False
        ships the host's voxels, for a sparse middle sorted by linear id.
        A sparse middle builds its rulebooks on the device either way.
        PointPillars networks run the flat pillar path on points either
        way (``builders.route.make_route``)."""
        if isinstance(config_path_or_config, str):
            self.config = load_pipeline_config(config_path_or_config)
        else:
            self.config = config_path_or_config
        self.device = torch.device(device)
        self.parts = build_network(self.config, self.device)
        reader = self.config.eval_input_reader
        self.route = make_route(self.parts, reader, "request",
                                device_voxelize)
        self.prep_func = build_prep_func(reader, self.parts, training=False,
                                         route=self.route)
        # a constant of the config: uploaded once, read by every request
        # whose batch holds the cache itself
        self.anchors_host = self.parts["anchor_cache"]["anchors"]
        self.anchors_device = torch.tensor(self.anchors_host,
                                           device=self.device)

    def get_inference_input_dict(self, info, points):
        if self.parts is None:
            raise RuntimeError("call build first")
        # a nuScenes info names its sample by token
        metadata = ({"token": info["token"]} if "token" in info else
                    {"image_idx": info["image"]["image_idx"]
                     if "image" in info else 0})
        input_dict = {
            "lidar": {"type": "lidar", "points": points},
            "metadata": metadata,
        }
        if "calib" in info:
            calib = info["calib"]
            input_dict["calib"] = {
                "rect": calib["R0_rect"],
                "Trv2c": calib["Tr_velo_to_cam"],
                "P2": calib["P2"],
            }
            input_dict["image"] = info.get("image")
        rid = timer.new_request()
        with timer.request(rid):
            example = self.prep_func(input_dict=input_dict)
            self.route.sort_request(example)
            with timer.span("prep.pack"):
                example["metadata"] = input_dict["metadata"]
                batch = merge_second_batch([example])
        if rid is not None:
            batch[timer.REQUEST_KEY] = rid
        return batch

    def init_random(self, seed=0):
        init_weights(self.parts["net"], torch.Generator().manual_seed(seed))

    def load_flax_variables(self, variables):
        """Load the JAX package's variables ({"params", "batch_stats"}
        trees of arrays) through :func:`from_flax`."""
        self.parts["net"].load_state_dict(from_flax(variables), strict=True)

    def restore(self, ckpt_path):
        """Load the network's weights and buffers of a checkpoint
        written by ``train`` (``train/checkpoint.py``, imported here and
        in :meth:`restore_latest` alone: serving loads nothing else of
        the training package)."""
        from ..train import checkpoint

        checkpoint.restore_net(ckpt_path, self.parts["net"])

    def restore_latest(self, model_dir):
        """Load the latest checkpoint of ``model_dir``; returns its step,
        or None when there is none (the weights stay as they are)."""
        from ..train import checkpoint

        path = checkpoint.latest_checkpoint(model_dir, "voxelnet")
        if path is None:
            return None
        self.restore(path)
        return int(path.rsplit("-", 1)[1].split(".")[0])

    def run(self, example):
        """A host batch (``get_inference_input_dict``) -> the network's
        preds and ``predict``'s fixed-size detections, on the device."""
        return self._run(example)[:2]

    def _run(self, example):
        """(preds, detections, a sparse middle's stage counts [B, S, 2]
        on the device, else None)."""
        with timer.request(example.get(timer.REQUEST_KEY)):
            anchors = example.get("anchors")
            resident = anchors is not None and _is_batch_of(
                anchors, self.anchors_host)
            if resident:
                example = {k: v for k, v in example.items()
                           if k != "anchors"}
            ex = example_to_device(example, self.device)
            timer.count("anchors_resident", int(resident))
            if resident:
                ex["anchors"] = self.anchors_device[None]
            return infer(self.route, self.parts["net"], self.parts["spec"],
                         ex)

    def inference(self, example):
        """Returns ragged per-frame detection dicts. A sparse middle's
        stage counts follow the detections to the host: they count as
        the request's "sparse_rows_active" / "sparse_rows_capacity" /
        "sparse_rows_overflow" (the sites each stage dropped, summed),
        and a stage that dropped voxels warns, as the host planner
        does."""
        _, dets, active = self._run(example)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        if active is not None:
            active = active.cpu().numpy()
            with timer.request(example.get(timer.REQUEST_KEY)):
                timer.count("sparse_rows_active", int(active[..., 0].sum()))
                timer.count("sparse_rows_capacity",
                            int(active[..., 1].sum()))
                if timer.collecting():
                    timer.count("sparse_rows_overflow", int(np.maximum(
                        active[..., 0] - active[..., 1], 0).sum()))
            for i, (total, cap) in enumerate(active.max(0)):
                if total > cap:
                    warn_overflow(i, int(total), int(cap))
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
