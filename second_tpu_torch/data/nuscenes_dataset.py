"""NuScenes dataset family (reference second/data/nuscenes_dataset.py).

Ports: 10-sweep accumulation with per-sweep pose transform + time-lag
channel (reference :165-185), velocity-extended gt boxes (:199-206),
KITTI-style eval with num_lidar_pts difficulty tiers (:213-305, runs
WITHOUT the nuscenes devkit), the official NuScenes eval json writer +
subprocess (:307-420, requires the devkit, like upstream), subsampled
D2..D8 / Velo variants (:423-519), and info creation (:640-780,
devkit-gated).

The official eval + info creation import the nuscenes devkit lazily —
exactly as upstream — so everything else works without it; without
the devkit (and ``pyquaternion``) they raise ``ImportError``, and
``evaluation`` falls back to the kitti-style eval.

The port's copy of ``second_tpu/data/nuscenes_dataset.py``; it adds
``PointsCapacity``.
"""

import json
import pickle
import subprocess
from copy import deepcopy
from pathlib import Path

import numpy as np

from ..utils.eval import get_coco_eval_result, get_official_eval_result
from . import kitti_common as kitti
from .dataset import Dataset, register_dataset
from .kitti_dataset import _to_ragged


@register_dataset
class NuScenesDataset(Dataset):
    NumPointFeatures = 4  # x, y, z, time-lag (set 4 to reuse kitti nets)
    # rows of a frame's shipped point buffer (data.preprocess.pad_points):
    # the key frame and its 9 sweeps of the HDL-32E's ~34 700 points
    # (32 beams x ~1 085 azimuth steps at 20 Hz) are ~347 000 points;
    # 12 x 32 768 holds them all with 13% to spare, even before the
    # range cut drops the points past +-50 m
    PointsCapacity = 393216
    NameMapping = {
        "movable_object.barrier": "barrier",
        "vehicle.bicycle": "bicycle",
        "vehicle.bus.bendy": "bus",
        "vehicle.bus.rigid": "bus",
        "vehicle.car": "car",
        "vehicle.construction": "construction_vehicle",
        "vehicle.motorcycle": "motorcycle",
        "human.pedestrian.adult": "pedestrian",
        "human.pedestrian.child": "pedestrian",
        "human.pedestrian.construction_worker": "pedestrian",
        "human.pedestrian.police_officer": "pedestrian",
        "movable_object.trafficcone": "traffic_cone",
        "vehicle.trailer": "trailer",
        "vehicle.truck": "truck",
    }
    DefaultAttribute = {
        "car": "vehicle.parked",
        "pedestrian": "pedestrian.moving",
        "trailer": "vehicle.parked",
        "truck": "vehicle.parked",
        "bus": "vehicle.parked",
        "motorcycle": "cycle.without_rider",
        "construction_vehicle": "vehicle.parked",
        "bicycle": "cycle.without_rider",
        "barrier": "",
        "traffic_cone": "",
    }

    def __init__(self,
                 root_path,
                 info_path,
                 class_names=None,
                 prep_func=None,
                 num_point_features=None):
        self._root_path = Path(root_path)
        with open(info_path, "rb") as f:
            data = pickle.load(f)
        self._nusc_infos = list(
            sorted(data["infos"], key=lambda e: e["timestamp"]))
        self._metadata = data["metadata"]
        self._class_names = class_names
        self._prep_func = prep_func
        self._kitti_name_mapping = {
            "car": "car",
            "pedestrian": "pedestrian",
        }
        self.version = self._metadata["version"]
        self.eval_version = "cvpr_2019"
        self._with_velocity = False

    def __len__(self):
        return len(self._nusc_infos)

    def __getitem__(self, idx):
        input_dict = self.get_sensor_data(idx)
        example = self._prep_func(input_dict=input_dict)
        example["metadata"] = input_dict["metadata"]
        if "anchors_mask" in example:
            example["anchors_mask"] = example["anchors_mask"].astype(np.uint8)
        return example

    def get_sensor_data(self, query):
        idx = query
        read_test_image = False
        if isinstance(query, dict):
            assert "lidar" in query
            idx = query["lidar"]["idx"]
            read_test_image = "cam" in query
        info = self._nusc_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None},
            "metadata": {"token": info["token"]},
        }
        lidar_path = Path(info["lidar_path"])
        points = np.fromfile(
            str(lidar_path), dtype=np.float32).reshape([-1, 5])
        points[:, 3] /= 255
        points[:, 4] = 0
        sweep_points_list = [points]
        ts = info["timestamp"] / 1e6
        for sweep in info["sweeps"]:
            points_sweep = np.fromfile(
                str(sweep["lidar_path"]), dtype=np.float32).reshape([-1, 5])
            sweep_ts = sweep["timestamp"] / 1e6
            points_sweep[:, 3] /= 255
            points_sweep[:, :3] = (
                points_sweep[:, :3] @ sweep["sweep2lidar_rotation"].T)
            points_sweep[:, :3] += sweep["sweep2lidar_translation"]
            points_sweep[:, 4] = ts - sweep_ts
            sweep_points_list.append(points_sweep)
        points = np.concatenate(sweep_points_list, axis=0)[:, [0, 1, 2, 4]]
        if read_test_image:
            image_str = None
            if Path(info["cam_front_path"]).exists():
                with open(str(info["cam_front_path"]), "rb") as f:
                    image_str = f.read()
            res["cam"] = {
                "type": "camera",
                "data": image_str,
                "datatype": Path(info["cam_front_path"]).suffix[1:],
            }
        res["lidar"]["points"] = points
        if "gt_boxes" in info:
            mask = info["num_lidar_pts"] > 0
            gt_boxes = info["gt_boxes"][mask]
            if self._with_velocity:
                gt_velocity = info["gt_velocity"][mask]
                nan_mask = np.isnan(gt_velocity[:, 0])
                gt_velocity[nan_mask] = [0.0, 0.0]
                gt_boxes = np.concatenate([gt_boxes, gt_velocity], axis=-1)
            res["lidar"]["annotations"] = {
                "boxes": gt_boxes,
                "names": info["gt_names"][mask],
            }
        return res

    @property
    def ground_truth_annotations(self):
        if "gt_boxes" not in self._nusc_infos[0]:
            return None
        cls_range_map = _eval_class_range(self.eval_version)
        gt_annos = []
        for info in self._nusc_infos:
            gt_names = info["gt_names"]
            gt_boxes = info["gt_boxes"]
            num_lidar_pts = info["num_lidar_pts"]
            mask = num_lidar_pts > 0
            gt_names, gt_boxes = gt_names[mask], gt_boxes[mask]
            num_lidar_pts = num_lidar_pts[mask]
            mask = np.array(
                [n in self._kitti_name_mapping for n in gt_names],
                dtype=np.bool_)
            gt_names, gt_boxes = gt_names[mask], gt_boxes[mask]
            num_lidar_pts = num_lidar_pts[mask]
            gt_names_mapped = [self._kitti_name_mapping[n] for n in gt_names]
            det_range = np.array([cls_range_map[n] for n in gt_names_mapped])
            det_range = det_range[..., np.newaxis] @ np.array([[-1, -1, 1, 1]])
            mask = (gt_boxes[:, :2] >= det_range[:, :2]).all(1)
            mask &= (gt_boxes[:, :2] <= det_range[:, 2:]).all(1)
            gt_names, gt_boxes = gt_names[mask], gt_boxes[mask]
            num_lidar_pts = num_lidar_pts[mask]
            occluded = np.full(num_lidar_pts.shape[0], 2)
            occluded[num_lidar_pts > 7] = 1
            occluded[num_lidar_pts > 15] = 0
            n = len(gt_boxes)
            gt_annos.append({
                "bbox": np.tile(np.array([[0, 0, 50, 50]]), [n, 1]),
                "alpha": np.full(n, -10),
                "occluded": occluded,
                "truncated": np.zeros(n),
                "name": gt_names,
                "location": gt_boxes[:, :3],
                "dimensions": gt_boxes[:, 3:6],
                "rotation_y": gt_boxes[:, 6],
            })
        return gt_annos

    def evaluation_kitti(self, detections, output_dir):
        """KITTI-style eval with num_lidar_pts difficulty tiers
        (devkit-free)."""
        class_names = self._class_names
        gt_annos = self.ground_truth_annotations
        if gt_annos is None:
            return None
        gt_annos = deepcopy(gt_annos)
        dt_annos = []
        for det_raw in detections:
            det = _to_ragged(det_raw)
            final_box_preds = np.asarray(det["box3d_lidar"])
            label_preds = np.asarray(det["label_preds"])
            scores = np.asarray(det["scores"])
            anno = kitti.get_start_result_anno()
            for j in range(final_box_preds.shape[0]):
                anno["bbox"].append(np.array([0, 0, 50, 50]))
                anno["alpha"].append(-10)
                anno["dimensions"].append(final_box_preds[j, 3:6])
                anno["location"].append(final_box_preds[j, :3])
                anno["rotation_y"].append(final_box_preds[j, 6])
                anno["name"].append(class_names[int(label_preds[j])])
                anno["truncated"].append(0.0)
                anno["occluded"].append(0)
                anno["score"].append(scores[j])
            if len(anno["name"]) != 0:
                anno = {n: np.stack(v) for n, v in anno.items()}
                dt_annos.append(anno)
            else:
                dt_annos.append(kitti.empty_result_anno())
            dt_annos[-1]["metadata"] = det.get("metadata")

        def map_names(annos):
            for anno in annos:
                anno["name"] = np.array([
                    self.NameMapping.get(n, n) for n in anno["name"].tolist()
                ])

        map_names(gt_annos)
        map_names(dt_annos)
        mapped_class_names = [
            self.NameMapping.get(n, n) for n in self._class_names
        ]
        z_axis, z_center = 2, 0.5
        result_official = get_official_eval_result(
            gt_annos, dt_annos, mapped_class_names,
            z_axis=z_axis, z_center=z_center)
        result_coco = get_coco_eval_result(
            gt_annos, dt_annos, mapped_class_names,
            z_axis=z_axis, z_center=z_center)
        return {
            "results": {
                "official": result_official["result"],
                "coco": result_coco["result"],
            },
            "detail": {
                "official": result_official["detail"],
                "coco": result_coco["detail"],
            },
        }

    def evaluation_nusc(self, detections, output_dir):
        """Official NuScenes eval (requires the nuscenes devkit; writes
        the submission json and runs nusc_eval in a subprocess like
        upstream)."""
        version = self.version
        eval_set_map = {
            "v1.0-mini": "mini_train",
            "v1.0-trainval": "val",
        }
        gt_annos = self.ground_truth_annotations
        if gt_annos is None:
            return None
        nusc_annos = {}
        mapped_class_names = self._class_names
        token2info = {info["token"]: info for info in self._nusc_infos}
        for det_raw in detections:
            det = _to_ragged(det_raw)
            annos = []
            boxes = _second_det_to_nusc_box(det)
            token = det["metadata"]["token"]
            for box in boxes:
                velocity = box.velocity[:2].tolist()
                if len(token2info[token]["sweeps"]) == 0:
                    velocity = (np.nan, np.nan)
                box.velocity = np.array([*velocity, 0.0])
            boxes = _lidar_nusc_box_to_global(
                token2info[token], boxes, mapped_class_names,
                self.eval_version)
            for box in boxes:
                name = mapped_class_names[box.label]
                nusc_annos.setdefault(token, [])
                annos.append({
                    "sample_token": token,
                    "translation": box.center.tolist(),
                    "size": box.wlh.tolist(),
                    "rotation": box.orientation.elements.tolist(),
                    "velocity": box.velocity[:2].tolist(),
                    "detection_name": name,
                    "detection_score": box.score,
                    "attribute_name": self.DefaultAttribute[name],
                })
            nusc_annos[token] = annos
        nusc_submissions = {
            "meta": {
                "use_camera": False,
                "use_lidar": False,
                "use_radar": False,
                "use_map": False,
                "use_external": False,
            },
            "results": nusc_annos,
        }
        res_path = Path(output_dir) / "results_nusc.json"
        with open(res_path, "w") as f:
            json.dump(nusc_submissions, f)
        eval_main_file = Path(__file__).resolve().parent / "nusc_eval.py"
        cmd = (
            f'python {str(eval_main_file)} --root_path="{self._root_path}"'
            f" --version={self.version} --eval_version={self.eval_version}"
            f' --res_path="{res_path}" --eval_set={eval_set_map[self.version]}'
            f' --output_dir="{output_dir}"')
        subprocess.check_output(cmd, shell=True)
        with open(Path(output_dir) / "metrics_summary.json", "r") as f:
            metrics = json.load(f)
        res_path.unlink()
        detail = {}
        result = f"Nusc {version} Evaluation\n"
        for name in mapped_class_names:
            detail[name] = {}
            for k, v in metrics["label_aps"][name].items():
                detail[name][f"dist@{k}"] = v
            tp_errs, tp_names = [], []
            for k, v in metrics["label_tp_errors"][name].items():
                detail[name][k] = v
                tp_errs.append(f"{v:.4f}")
                tp_names.append(k)
            threshs = ", ".join(list(metrics["label_aps"][name].keys()))
            scores = ", ".join(
                f"{s * 100:.2f}"
                for s in metrics["label_aps"][name].values())
            result += f"{name} Nusc dist AP@{threshs} and TP errors\n"
            result += scores + "\n"
            result += ", ".join(tp_names) + ": " + ", ".join(tp_errs) + "\n"
        return {"results": {"nusc": result}, "detail": {"nusc": detail}}

    def evaluation(self, detections, output_dir):
        try:
            res_nusc = self.evaluation_nusc(detections, output_dir)
        except ImportError:
            # no devkit in this environment: fall back to the kitti-style
            # eval (upstream keeps the same fallback commented in)
            res_kitti = self.evaluation_kitti(detections, output_dir)
            return {
                "results": {"kitti.official": res_kitti["results"]["official"]},
                "detail": {"eval.kitti": res_kitti["detail"]},
            }
        return {
            "results": {"nusc": res_nusc["results"]["nusc"]},
            "detail": {"eval.nusc": res_nusc["detail"]["nusc"]},
        }


def _subsample(infos, step):
    if len(infos) > 28000:
        infos = list(sorted(infos, key=lambda e: e["timestamp"]))
        infos = infos[::step]
    return infos


def _make_variant(step, velo=False):
    class _Variant(NuScenesDataset):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            if step > 1:
                self._nusc_infos = _subsample(self._nusc_infos, step)
            if velo:
                self._with_velocity = True

    return _Variant


for _step in range(2, 9):
    cls = _make_variant(_step)
    cls.__name__ = f"NuScenesDatasetD{_step}"
    register_dataset(cls, cls.__name__)
NuScenesDatasetVelo = _make_variant(1, velo=True)
NuScenesDatasetVelo.__name__ = "NuScenesDatasetVelo"
register_dataset(NuScenesDatasetVelo, "NuScenesDatasetVelo")
NuScenesDatasetD8Velo = _make_variant(8, velo=True)
NuScenesDatasetD8Velo.__name__ = "NuScenesDatasetD8Velo"
register_dataset(NuScenesDatasetD8Velo, "NuScenesDatasetD8Velo")
NuScenesDatasetD2Velo = _make_variant(2, velo=True)
NuScenesDatasetD2Velo.__name__ = "NuScenesDatasetD2Velo"
register_dataset(NuScenesDatasetD2Velo, "NuScenesDatasetD2Velo")


def _eval_class_range(eval_version):
    """Per-class eval range; uses the devkit's table when present."""
    try:
        from nuscenes.eval.detection.config import eval_detection_configs

        return eval_detection_configs[eval_version]["class_range"]
    except ImportError:
        # cvpr_2019 defaults (public NuScenes detection eval spec)
        return {
            "car": 50, "truck": 50, "bus": 50, "trailer": 50,
            "construction_vehicle": 50, "pedestrian": 40,
            "motorcycle": 40, "bicycle": 40, "traffic_cone": 30,
            "barrier": 30,
        }


def _second_det_to_nusc_box(detection):
    from nuscenes.utils.data_classes import Box
    import pyquaternion

    box3d = np.asarray(detection["box3d_lidar"]).copy()
    scores = np.asarray(detection["scores"])
    labels = np.asarray(detection["label_preds"])
    box3d[:, 6] = -box3d[:, 6] - np.pi / 2
    box_list = []
    for i in range(box3d.shape[0]):
        quat = pyquaternion.Quaternion(axis=[0, 0, 1], radians=box3d[i, 6])
        velocity = (np.nan, np.nan, np.nan)
        if box3d.shape[1] == 9:
            velocity = (*box3d[i, 7:9], 0.0)
        box_list.append(Box(
            box3d[i, :3], box3d[i, 3:6], quat, label=labels[i],
            score=scores[i], velocity=velocity))
    return box_list


def _lidar_nusc_box_to_global(info, boxes, classes, eval_version="cvpr_2019"):
    import pyquaternion

    cls_range_map = _eval_class_range(eval_version)
    box_list = []
    for box in boxes:
        box.rotate(pyquaternion.Quaternion(info["lidar2ego_rotation"]))
        box.translate(np.array(info["lidar2ego_translation"]))
        radius = np.linalg.norm(box.center[:2], 2)
        if radius > cls_range_map[classes[box.label]]:
            continue
        box.rotate(pyquaternion.Quaternion(info["ego2global_rotation"]))
        box.translate(np.array(info["ego2global_translation"]))
        box_list.append(box)
    return box_list


# ---------------------------------------------------------------------------
# info creation (devkit-gated, reference :640-780)
# ---------------------------------------------------------------------------


def _get_available_scenes(nusc):
    available_scenes = []
    for scene in nusc.scene:
        sample_rec = nusc.get("sample", scene["first_sample_token"])
        sd_rec = nusc.get("sample_data", sample_rec["data"]["LIDAR_TOP"])
        lidar_path, _, _ = nusc.get_sample_data(sd_rec["token"])
        if Path(lidar_path).exists():
            available_scenes.append(scene)
    return available_scenes


def _fill_trainval_infos(nusc, train_scenes, val_scenes, test=False,
                         max_sweeps=10):
    from pyquaternion import Quaternion

    train_nusc_infos, val_nusc_infos = [], []
    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd_rec = nusc.get("sample_data", lidar_token)
        cs_record = nusc.get(
            "calibrated_sensor", sd_rec["calibrated_sensor_token"])
        pose_record = nusc.get("ego_pose", sd_rec["ego_pose_token"])
        lidar_path, boxes, _ = nusc.get_sample_data(lidar_token)
        cam_front_token = sample["data"]["CAM_FRONT"]
        cam_path, _, _ = nusc.get_sample_data(cam_front_token)
        info = {
            "lidar_path": lidar_path,
            "cam_front_path": cam_path,
            "token": sample["token"],
            "sweeps": [],
            "lidar2ego_translation": cs_record["translation"],
            "lidar2ego_rotation": cs_record["rotation"],
            "ego2global_translation": pose_record["translation"],
            "ego2global_rotation": pose_record["rotation"],
            "timestamp": sample["timestamp"],
        }
        l2e_r = Quaternion(info["lidar2ego_rotation"]).rotation_matrix
        l2e_t = np.array(info["lidar2ego_translation"])
        e2g_r = Quaternion(info["ego2global_rotation"]).rotation_matrix
        e2g_t = np.array(info["ego2global_translation"])

        sweeps = []
        cur_sd_rec = sd_rec
        while len(sweeps) < max_sweeps:
            if cur_sd_rec["prev"] == "":
                break
            cur_sd_rec = nusc.get("sample_data", cur_sd_rec["prev"])
            cs = nusc.get(
                "calibrated_sensor", cur_sd_rec["calibrated_sensor_token"])
            pose = nusc.get("ego_pose", cur_sd_rec["ego_pose_token"])
            lidar_path = nusc.get_sample_data_path(cur_sd_rec["token"])
            sl2e_r = Quaternion(cs["rotation"]).rotation_matrix
            sl2e_t = np.array(cs["translation"])
            se2g_r = Quaternion(pose["rotation"]).rotation_matrix
            se2g_t = np.array(pose["translation"])
            # sweep lidar -> global -> key-frame lidar
            M_sweep = np.eye(4)
            M_sweep[:3, :3] = se2g_r @ sl2e_r
            M_sweep[:3, 3] = se2g_r @ sl2e_t + se2g_t
            M_key = np.eye(4)
            M_key[:3, :3] = e2g_r @ l2e_r
            M_key[:3, 3] = e2g_r @ l2e_t + e2g_t
            M = np.linalg.inv(M_key) @ M_sweep
            sweeps.append({
                "lidar_path": lidar_path,
                "sample_data_token": cur_sd_rec["token"],
                "lidar2ego_translation": cs["translation"],
                "lidar2ego_rotation": cs["rotation"],
                "ego2global_translation": pose["translation"],
                "ego2global_rotation": pose["rotation"],
                "timestamp": cur_sd_rec["timestamp"],
                "sweep2lidar_rotation": M[:3, :3],
                "sweep2lidar_translation": M[:3, 3],
            })
        info["sweeps"] = sweeps
        if not test:
            annotations = [
                nusc.get("sample_annotation", token)
                for token in sample["anns"]
            ]
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array(
                [b.orientation.yaw_pitch_roll[0] for b in boxes]
            ).reshape(-1, 1)
            velocity = np.array(
                [nusc.box_velocity(token)[:2] for token in sample["anns"]])
            # convert velocity from global to lidar frame
            for i in range(len(boxes)):
                velo = np.array([*velocity[i], 0.0])
                velo = velo @ np.linalg.inv(e2g_r).T @ np.linalg.inv(l2e_r).T
                velocity[i] = velo[:2]
            names = np.array([
                NuScenesDataset.NameMapping.get(b.name, b.name) for b in boxes
            ])
            gt_boxes = np.concatenate(
                [locs, dims, -rots - np.pi / 2], axis=1)
            info["gt_boxes"] = gt_boxes
            info["gt_names"] = names
            info["gt_velocity"] = velocity.reshape(-1, 2)
            info["num_lidar_pts"] = np.array(
                [a["num_lidar_pts"] for a in annotations])
            info["num_radar_pts"] = np.array(
                [a["num_radar_pts"] for a in annotations])
        if sample["scene_token"] in train_scenes:
            train_nusc_infos.append(info)
        else:
            val_nusc_infos.append(info)
    return train_nusc_infos, val_nusc_infos


def create_nuscenes_infos(root_path, version="v1.0-trainval", max_sweeps=10):
    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    available_vers = ["v1.0-trainval", "v1.0-test", "v1.0-mini"]
    assert version in available_vers
    if version == "v1.0-trainval":
        train_scenes, val_scenes = splits.train, splits.val
    elif version == "v1.0-test":
        train_scenes, val_scenes = splits.test, []
    else:
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    test = "test" in version
    root_path = Path(root_path)
    available_scenes = _get_available_scenes(nusc)
    available_scene_names = [s["name"] for s in available_scenes]
    train_scenes = set(
        available_scenes[available_scene_names.index(s)]["token"]
        for s in train_scenes if s in available_scene_names)
    val_scenes = set(
        available_scenes[available_scene_names.index(s)]["token"]
        for s in val_scenes if s in available_scene_names)
    train_nusc_infos, val_nusc_infos = _fill_trainval_infos(
        nusc, train_scenes, val_scenes, test, max_sweeps=max_sweeps)
    metadata = {"version": version}
    if test:
        with open(root_path / "infos_test.pkl", "wb") as f:
            pickle.dump({"infos": train_nusc_infos, "metadata": metadata}, f)
    else:
        with open(root_path / "infos_train.pkl", "wb") as f:
            pickle.dump({"infos": train_nusc_infos, "metadata": metadata}, f)
        with open(root_path / "infos_val.pkl", "wb") as f:
            pickle.dump({"infos": val_nusc_infos, "metadata": metadata}, f)


def get_box_mean(info_path, class_name="vehicle.car",
                 eval_version="cvpr_2019"):
    with open(info_path, "rb") as f:
        nusc_infos = pickle.load(f)["infos"]
    cls_range_map = _eval_class_range(eval_version)
    gt_boxes_list = []
    for info in nusc_infos:
        mask = np.array(
            [s == class_name for s in info["gt_names"]], dtype=np.bool_)
        gt_boxes = info["gt_boxes"][mask]
        det_range = cls_range_map[
            NuScenesDataset.NameMapping.get(class_name, class_name)]
        mask = np.abs(gt_boxes[:, :2]).max(1) <= det_range
        gt_boxes_list.append(gt_boxes[mask])
    gt_boxes_list = np.concatenate(gt_boxes_list, axis=0)
    return gt_boxes_list.mean(0)
