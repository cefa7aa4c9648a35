"""KITTI dataset (reference second/data/kitti_dataset.py); the port's copy
of ``second_tpu/data/kitti_dataset.py``, less the label-file writer.

Same info-pkl format, same get_sensor_data contract (z-CENTER lidar
boxes), same detection->KITTI-anno conversion with image-plane
projection/clipping, evaluation via the official + coco AP blocks.
Detections arriving from the jitted predict step are numpy dicts with
fixed-size arrays + a ``valid`` mask OR already-ragged arrays; both are
accepted.
"""

import pickle
from pathlib import Path

import numpy as np

from ..core import box_ops
from ..utils.eval import get_coco_eval_result, get_official_eval_result
from . import kitti_common as kitti
from .dataset import Dataset, register_dataset


def _to_ragged(det):
    """Fixed-size detection dict (with 'valid') -> ragged numpy."""
    det = {k: np.asarray(v) for k, v in det.items() if k != "metadata"} | (
        {"metadata": det.get("metadata")} if "metadata" in det else {})
    if "valid" in det:
        v = det["valid"].astype(bool)
        out = {
            "box3d_lidar": det["box3d_lidar"][v],
            "scores": det["scores"][v],
            "label_preds": det["label_preds"][v],
        }
        if "metadata" in det:
            out["metadata"] = det["metadata"]
        return out
    return det


@register_dataset
class KittiDataset(Dataset):
    NumPointFeatures = 4
    # rows of a frame's shipped point buffer (data.preprocess.pad_points):
    # the reduced clouds the readers load (the points in the camera's
    # view) hold ~15-20k points
    PointsCapacity = 32768

    def __init__(self,
                 root_path,
                 info_path,
                 class_names=None,
                 prep_func=None,
                 num_point_features=None):
        assert info_path is not None
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        self._root_path = Path(root_path)
        self._kitti_infos = infos
        self._class_names = class_names
        self._prep_func = prep_func

    def __len__(self):
        return len(self._kitti_infos)

    def __getitem__(self, idx):
        input_dict = self.get_sensor_data(idx)
        example = self._prep_func(input_dict=input_dict)
        example["metadata"] = input_dict.get("metadata", {})
        if "anchors_mask" in example:
            example["anchors_mask"] = example["anchors_mask"].astype(np.uint8)
        return example

    def get_sensor_data(self, query):
        read_image = False
        idx = query
        if isinstance(query, dict):
            read_image = "cam" in query
            assert "lidar" in query
            idx = query["lidar"]["idx"]
        info = self._kitti_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None},
            "metadata": {
                "image_idx": info["image"]["image_idx"],
                "image_shape": info["image"]["image_shape"],
            },
            "calib": None,
            "cam": {},
        }
        pc_info = info["point_cloud"]
        velo_path = Path(pc_info["velodyne_path"])
        if not velo_path.is_absolute():
            velo_path = self._root_path / pc_info["velodyne_path"]
        velo_reduced_path = velo_path.parent.parent / (
            velo_path.parent.stem + "_reduced") / velo_path.name
        if velo_reduced_path.exists():
            velo_path = velo_reduced_path
        points = np.fromfile(
            str(velo_path), dtype=np.float32).reshape(
            [-1, self.NumPointFeatures])
        res["lidar"]["points"] = points
        image_info = info["image"]
        if read_image:
            image_path = self._root_path / image_info["image_path"]
            with open(str(image_path), "rb") as f:
                res["cam"] = {
                    "type": "camera",
                    "data": f.read(),
                    "datatype": image_path.suffix[1:],
                }
        calib = info["calib"]
        res["calib"] = {
            "rect": calib["R0_rect"],
            "Trv2c": calib["Tr_velo_to_cam"],
            "P2": calib["P2"],
        }
        if "annos" in info:
            annos = kitti.remove_dontcare(info["annos"])
            locs = annos["location"]
            dims = annos["dimensions"]
            rots = annos["rotation_y"]
            gt_names = annos["name"]
            gt_boxes = np.concatenate(
                [locs, dims, rots[..., np.newaxis]], axis=1).astype(np.float32)
            gt_boxes = box_ops.box_camera_to_lidar(
                gt_boxes, calib["R0_rect"], calib["Tr_velo_to_cam"])
            # kitti [0.5, 0.5, 0] -> center format [0.5, 0.5, 0.5]
            box_ops.change_box3d_center_(
                gt_boxes, [0.5, 0.5, 0], [0.5, 0.5, 0.5])
            res["lidar"]["annotations"] = {
                "boxes": gt_boxes,
                "names": gt_names,
            }
            res["cam"]["annotations"] = {
                "boxes": annos["bbox"],
                "names": gt_names,
            }
        return res

    def convert_detection_to_kitti_annos(self, detection):
        class_names = self._class_names
        annos = []
        for i in range(len(detection)):
            det = _to_ragged(detection[i])
            info = self._kitti_infos[i]
            calib = info["calib"]
            rect = calib["R0_rect"]
            Trv2c = calib["Tr_velo_to_cam"]
            P2 = calib["P2"]
            final_box_preds = np.asarray(det["box3d_lidar"], np.float64).copy()
            label_preds = np.asarray(det["label_preds"])
            scores = np.asarray(det["scores"])
            anno = kitti.get_start_result_anno()
            num_example = 0
            if final_box_preds.shape[0] != 0:
                final_box_preds[:, 2] -= final_box_preds[:, 5] / 2
                box3d_camera = box_ops.box_lidar_to_camera(
                    final_box_preds, rect, Trv2c)
                locs = box3d_camera[:, :3]
                dims = box3d_camera[:, 3:6]
                angles = box3d_camera[:, 6]
                box_corners = box_ops.center_to_corner_box3d(
                    locs, dims, angles, (0.5, 1.0, 0.5), axis=1)
                box_corners_in_image = box_ops.project_to_image(
                    box_corners, P2)
                minxy = np.min(box_corners_in_image, axis=1)
                maxxy = np.max(box_corners_in_image, axis=1)
                bbox = np.concatenate([minxy, maxxy], axis=1)
                image_shape = info["image"]["image_shape"]
                for j in range(final_box_preds.shape[0]):
                    if bbox[j, 0] > image_shape[1] or bbox[j, 1] > image_shape[0]:
                        continue
                    if bbox[j, 2] < 0 or bbox[j, 3] < 0:
                        continue
                    bbox[j, 2:] = np.minimum(bbox[j, 2:], image_shape[::-1])
                    bbox[j, :2] = np.maximum(bbox[j, :2], [0, 0])
                    anno["bbox"].append(bbox[j])
                    anno["alpha"].append(
                        -np.arctan2(-final_box_preds[j, 1],
                                    final_box_preds[j, 0])
                        + box3d_camera[j, 6])
                    anno["dimensions"].append(box3d_camera[j, 3:6])
                    anno["location"].append(box3d_camera[j, :3])
                    anno["rotation_y"].append(box3d_camera[j, 6])
                    anno["name"].append(class_names[int(label_preds[j])])
                    anno["truncated"].append(0.0)
                    anno["occluded"].append(0)
                    anno["score"].append(scores[j])
                    num_example += 1
            if num_example != 0:
                anno = {n: np.stack(v) for n, v in anno.items()}
                annos.append(anno)
            else:
                annos.append(kitti.empty_result_anno())
            annos[-1]["metadata"] = det.get("metadata")
        return annos

    def evaluation(self, detections, output_dir):
        if "annos" not in self._kitti_infos[0]:
            return None
        gt_annos = [info["annos"] for info in self._kitti_infos]
        dt_annos = self.convert_detection_to_kitti_annos(detections)
        # KITTI camera format: y is the height axis, box origin y=bottom
        z_axis, z_center = 1, 1.0
        result_official = get_official_eval_result(
            gt_annos, dt_annos, self._class_names,
            z_axis=z_axis, z_center=z_center)
        result_coco = get_coco_eval_result(
            gt_annos, dt_annos, self._class_names,
            z_axis=z_axis, z_center=z_center)
        return {
            "results": {
                "official": result_official["result"],
                "coco": result_coco["result"],
            },
            "detail": {
                "eval.kitti": {
                    "official": result_official["detail"],
                    "coco": result_coco["detail"],
                }
            },
        }


def _calculate_num_points_in_gt(data_path, infos, relative_path,
                                remove_outside=True, num_features=4):
    for info in infos:
        pc_info = info["point_cloud"]
        calib = info["calib"]
        if relative_path:
            v_path = str(Path(data_path) / pc_info["velodyne_path"])
        else:
            v_path = pc_info["velodyne_path"]
        points_v = np.fromfile(
            v_path, dtype=np.float32).reshape([-1, num_features])
        rect = calib["R0_rect"]
        Trv2c = calib["Tr_velo_to_cam"]
        P2 = calib["P2"]
        if remove_outside:
            points_v = box_ops.remove_outside_points(
                points_v, rect, Trv2c, P2, info["image"]["image_shape"])
        annos = info["annos"]
        num_obj = len([n for n in annos["name"] if n != "DontCare"])
        dims = annos["dimensions"][:num_obj]
        loc = annos["location"][:num_obj]
        rots = annos["rotation_y"][:num_obj]
        gt_boxes_camera = np.concatenate(
            [loc, dims, rots[..., np.newaxis]], axis=1)
        gt_boxes_lidar = box_ops.box_camera_to_lidar(
            gt_boxes_camera, rect, Trv2c)
        indices = box_ops.points_in_rbbox(points_v[:, :3], gt_boxes_lidar)
        num_points_in_gt = indices.sum(0)
        num_ignored = len(annos["dimensions"]) - num_obj
        num_points_in_gt = np.concatenate(
            [num_points_in_gt, -np.ones([num_ignored])])
        annos["num_points_in_gt"] = num_points_in_gt.astype(np.int32)


# KITTI's split files (copies of the JAX package's)
IMAGESETS = Path(__file__).resolve().parent / "ImageSets"


def read_imageset_file(path):
    """The frame ids of a split file, one per line."""
    with open(path, "r") as f:
        return [int(line) for line in f.readlines()]


def create_kitti_info_file(data_path, train_img_ids, val_img_ids,
                           test_img_ids=(), save_path=None,
                           relative_path=True):
    """Build kitti_infos_{train,val,trainval,test}.pkl for the given frame
    ids (the JAX package reads its ImageSets split files when no ids are
    given; here the caller passes them, ``read_imageset_file`` reads a
    split file)."""
    print("Generate info. this may take several minutes.")
    save_path = Path(save_path) if save_path is not None else Path(data_path)
    kitti_infos_train = kitti.get_kitti_image_info(
        data_path, training=True, velodyne=True, calib=True,
        image_ids=train_img_ids, relative_path=relative_path)
    _calculate_num_points_in_gt(data_path, kitti_infos_train, relative_path)
    with open(save_path / "kitti_infos_train.pkl", "wb") as f:
        pickle.dump(kitti_infos_train, f)
    print(f"Kitti info train file is saved to {save_path}")
    kitti_infos_val = kitti.get_kitti_image_info(
        data_path, training=True, velodyne=True, calib=True,
        image_ids=val_img_ids, relative_path=relative_path)
    _calculate_num_points_in_gt(data_path, kitti_infos_val, relative_path)
    with open(save_path / "kitti_infos_val.pkl", "wb") as f:
        pickle.dump(kitti_infos_val, f)
    with open(save_path / "kitti_infos_trainval.pkl", "wb") as f:
        pickle.dump(kitti_infos_train + kitti_infos_val, f)
    if len(test_img_ids) > 0:
        kitti_infos_test = kitti.get_kitti_image_info(
            data_path, training=False, label_info=False, velodyne=True,
            calib=True, image_ids=test_img_ids, relative_path=relative_path)
        with open(save_path / "kitti_infos_test.pkl", "wb") as f:
            pickle.dump(kitti_infos_test, f)


def _create_reduced_point_cloud(data_path, info_path, save_path=None,
                                back=False):
    with open(info_path, "rb") as f:
        kitti_infos = pickle.load(f)
    for info in kitti_infos:
        pc_info = info["point_cloud"]
        calib = info["calib"]
        v_path = Path(data_path) / pc_info["velodyne_path"]
        points_v = np.fromfile(
            str(v_path), dtype=np.float32).reshape([-1, 4])
        rect = calib["R0_rect"]
        Trv2c = calib["Tr_velo_to_cam"]
        P2 = calib["P2"]
        if back:
            points_v[:, 0] = -points_v[:, 0]
        points_v = box_ops.remove_outside_points(
            points_v, rect, Trv2c, P2, info["image"]["image_shape"])
        if save_path is None:
            save_filename = (
                v_path.parent.parent / (v_path.parent.stem + "_reduced")
                / v_path.name)
        else:
            save_filename = str(Path(save_path) / v_path.name)
        if back:
            save_filename = str(save_filename) + "_back"
        Path(save_filename).parent.mkdir(parents=True, exist_ok=True)
        with open(save_filename, "w") as f:
            points_v.tofile(f)


def create_reduced_point_cloud(data_path,
                               train_info_path=None,
                               val_info_path=None,
                               test_info_path=None,
                               save_path=None,
                               with_back=False):
    data_path = Path(data_path)
    if train_info_path is None:
        train_info_path = data_path / "kitti_infos_train.pkl"
    if val_info_path is None:
        val_info_path = data_path / "kitti_infos_val.pkl"
    if test_info_path is None:
        test_info_path = data_path / "kitti_infos_test.pkl"
    _create_reduced_point_cloud(data_path, train_info_path, save_path)
    _create_reduced_point_cloud(data_path, val_info_path, save_path)
    if test_info_path.exists():
        _create_reduced_point_cloud(data_path, test_info_path, save_path)
    if with_back:
        _create_reduced_point_cloud(
            data_path, train_info_path, save_path, back=True)
        _create_reduced_point_cloud(
            data_path, val_info_path, save_path, back=True)
