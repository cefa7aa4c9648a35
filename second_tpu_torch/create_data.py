"""Offline data preparation CLI (twin of ``second_tpu/create_data.py``;
reference second/create_data.py):

    python -m second_tpu_torch.create_data kitti_data_prep --root_path=/data/kitti

It writes the info files, the reduced point clouds (the points inside
the camera's image) and the GT database that the train reader's
sampler reads (``gt_database/`` and ``kitti_dbinfos_train.pkl``).

    python -m second_tpu_torch.create_data nuscenes_data_prep \
        --root_path=/data/nuscenes --version=v1.0-trainval

needs the nuScenes devkit for its infos; the GT database of existing
nuScenes infos is ``data.gt_database.create_groundtruth_database(
"NuScenesDataset", root, info_path)``.
"""

from pathlib import Path

from .data.gt_database import create_groundtruth_database
from .data.kitti_dataset import (
    IMAGESETS,
    create_kitti_info_file,
    create_reduced_point_cloud,
    read_imageset_file,
)
from .data.nuscenes_dataset import create_nuscenes_infos


def kitti_data_prep(root_path, imageset_dir=None):
    """Infos, reduced point clouds and the GT database of the KITTI tree
    at ``root_path``. The frames of each split come from
    ``imageset_dir``'s train.txt, val.txt and test.txt (KITTI's split by
    default; a missing test.txt means no test split)."""
    folder = Path(imageset_dir) if imageset_dir is not None else IMAGESETS
    ids = {split: read_imageset_file(folder / f"{split}.txt")
           if (folder / f"{split}.txt").exists() else []
           for split in ("train", "val", "test")}
    create_kitti_info_file(root_path, ids["train"], ids["val"], ids["test"])
    create_reduced_point_cloud(root_path)
    # the database is cut from the training frames, as upstream's
    # create_data.py does (the JAX package passes no info file here)
    create_groundtruth_database(
        "KittiDataset", root_path,
        str(Path(root_path) / "kitti_infos_train.pkl"))


def nuscenes_data_prep(root_path, version, max_sweeps=10):
    """Infos and the GT database of the nuScenes tree at ``root_path``,
    as the JAX package makes them. Its first step,
    ``create_nuscenes_infos``, reads the tree through the nuScenes
    devkit, so without the devkit (and ``pyquaternion``) it raises
    ``ImportError``, naming it."""
    try:
        create_nuscenes_infos(root_path, version=version,
                              max_sweeps=max_sweeps)
    except ImportError as err:
        raise ImportError(
            f"nuscenes_data_prep reads the tree through the nuScenes devkit "
            f"(packages nuscenes-devkit and pyquaternion): {err}") from err
    name = "infos_test.pkl" if version == "v1.0-test" else "infos_train.pkl"
    create_groundtruth_database(
        "NuScenesDataset", root_path, str(Path(root_path) / name))


def main():
    from .utils.fire_lite import fire

    fire({
        "kitti_data_prep": kitti_data_prep,
        "nuscenes_data_prep": nuscenes_data_prep,
    })


if __name__ == "__main__":
    main()
