"""The KITTI multi-class SECOND (``configs/all.fhd.config``: Car, Cyclist,
Pedestrian, Van on SpMiddleFHD + RPNV2) in the port against the JAX
package on the CPU.

* Both packages parse the published config and build equal
  ``ModelSpec``s (per-class anchor ranges included), with single-set
  and with multi-class NMS.
* all.fhd reduced: its topology and its four classes' anchors, matching
  thresholds and NMS settings, over a 12.8 m x 12.8 m range at 0.2 m
  (a [41, 64, 64] grid; the published one is [41, 1600, 1408] at
  0.05 m) with a narrow RPNV2 (2 + 2 layers of 16 and 32 filters, 16 +
  16 upsampled; published 5 + 5 of 128 and 256, 256 + 256) and 3000
  voxels. The JAX package's random variables go to the port through
  ``from_flax`` (batch-norm statistics and affine parameters perturbed).
  A frame with one object of each class: the port's training example
  (per-class anchors, ``assign_per_class``, compact targets) equals the
  JAX package's exactly; the preds agree within atol = rtol = 1e-4 and
  the training loss within 1e-4 relative (fp32 sums in another order);
  the detections of the published single-set NMS within 1e-4 on boxes
  and scores, labels and counts equal.
* Multi-class NMS on the same preds, class-aware and class-agnostic,
  with each class's own sizes and thresholds: boxes and scores within
  1e-5, validity and labels equal.
* The train reader with the published four sample groups, on a fixture
  tree whose frames hold all four classes and its GT database: the
  examples equal the JAX package's exactly.

Then the port alone: the reduced all.fhd on the device route (points
in, voxels and rulebooks built on the device) gives the host route's
preds within 1e-5 and its detections; ``train`` runs one step of it at
batch 2 with the four sample groups on a four-class fixture tree, and
``evaluate`` reports the official AP of each of the four classes.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.builders import dbsampler_builder as jdbs
from second_tpu.builders import network_builder as jnb
from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.data.preprocess import prep_pointcloud as jprep
from second_tpu.models import sparse_middle as jsm
from second_tpu.models import voxelnet as jvoxelnet
from second_tpu.train.__main__ import example_convert
from second_tpu.train.state import _expand_targets as jexpand

from second_tpu_torch.builders import network_builder as tnb
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.configs import load_pipeline_config, schema
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core import box_ops
from second_tpu_torch.core.inference import InferenceContext, example_to_device
from second_tpu_torch.data import gt_database as tgt
from second_tpu_torch.data import kitti_dataset as tkd
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.models import voxelnet as tvoxelnet
from second_tpu_torch.tools import kitti_fixture as tfixture
from second_tpu_torch.train.__main__ import evaluate, train
from second_tpu_torch.train.state import forward_loss
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_slice import host_plan_of, random_variables

CONFIG = "configs/all.fhd.config"
CLASSES = ("Car", "Cyclist", "Pedestrian", "Van")
RANGE = [0.0, -6.4, -3.0, 12.8, 6.4, 1.0]
VOXELS = 3000
# one object of each class (lidar, z at the centre), apart from each
# other and near the sensor, so the published global rotation (up to
# 45 degrees about the sensor) keeps them in range
BOXES = np.array([
    [3.5, -2.2, -1.0, 1.6, 3.9, 1.56, 0.1],                      # Car
    [3.2, 2.0, -0.6, 0.6, 1.76, 1.73, 0.4],                      # Cyclist
    [5.8, 0.6, -0.6, 0.6, 0.8, 1.73, 2.0],                       # Pedestrian
    [7.6, -1.2, -1.41, 1.87103749, 5.02808195, 2.20964255, 1.5],  # Van
], np.float32)


def reduced_text(multiclass_nms=False):
    """all.fhd cut to ``RANGE`` at 0.2 m with a narrow RPN (module
    docstring), as config text both packages parse; the train reader's
    sampler cleared (these frames have no database)."""
    cfg = load_pipeline_config(CONFIG)
    model = cfg.model.second
    model.voxel_generator.point_cloud_range = list(RANGE)
    model.voxel_generator.voxel_size = [0.2, 0.2, 0.1]
    for cls in model.target_assigner.class_settings:
        ranges = cls.anchor_generator_range.anchor_ranges
        cls.anchor_generator_range.anchor_ranges = [
            RANGE[0], RANGE[1], ranges[2], RANGE[3], RANGE[4], ranges[5]]
        cls.use_multi_class_nms = multiclass_nms
    model.post_center_limit_range = [RANGE[0], RANGE[1], -2.2, RANGE[3],
                                      RANGE[4], 0.8]
    model.rpn.layer_nums = [2, 2]
    model.rpn.num_filters = [16, 32]
    model.rpn.num_upsample_filters = [16, 16]
    for reader in (cfg.train_input_reader, cfg.eval_input_reader):
        reader.preprocess.max_number_of_voxels = VOXELS
    cfg.train_input_reader.preprocess.database_sampler = (
        schema.Sampler.from_raw({}))
    return cfg.to_text()


def box_points(rng, box, n):
    """``n`` points uniform inside a lidar box (z at its centre)."""
    x, y, z, w, l, h, yaw = box
    local = rng.uniform([-w / 2, -l / 2, -h / 2], [w / 2, l / 2, h / 2],
                        (n, 3))
    pts = box_ops.rotation_points_single_angle(local, -yaw, axis=2)
    pts += [x, y, z]
    return np.concatenate([pts, rng.uniform(0, 1, (n, 1))], 1)


def frame_points(seed, n_ground=3000, n_object=250):
    rng = np.random.RandomState(seed)
    ground = np.stack([rng.uniform(RANGE[0], RANGE[3], n_ground),
                       rng.uniform(RANGE[1], RANGE[4], n_ground),
                       rng.normal(-1.7, 0.05, n_ground),
                       rng.uniform(0, 1, n_ground)], 1)
    parts = [ground] + [box_points(rng, b, n_object) for b in BOXES]
    return np.concatenate(parts).astype(np.float32)


def train_input(seed):
    return {"lidar": {"points": frame_points(seed),
                      "annotations": {"boxes": BOXES.copy(),
                                      "names": np.array(CLASSES)}}}


def _spec_fields(spec):
    """A ModelSpec's fields, its loss functions by name and arguments."""
    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if isinstance(v, functools.partial):
            v = (v.func.__name__, sorted(v.keywords.items()))
        elif callable(v):
            v = v.__name__
        out[f.name] = v
    return out


@pytest.mark.parametrize("multiclass_nms", [False, True])
def test_all_fhd_config_builds_equal_specs(multiclass_nms):
    text = open(CONFIG).read()
    if multiclass_nms:
        text = text.replace("use_multi_class_nms: false",
                            "use_multi_class_nms: true")
    tparts = tnb.build_network(tloads(text), "cpu")
    jparts = jnb.build_network(jloads(text))
    tspec, jspec = tparts["spec"], jparts["spec"]
    assert _spec_fields(tspec) == _spec_fields(jspec)
    assert tspec.multiclass_nms is multiclass_nms
    assert tspec.num_class == 4
    assert tspec.anchors_ranges == ((0, 70400), (70400, 140800),
                                    (140800, 211200), (211200, 281600))
    assert list(tparts["target_assigner"].classes) == list(CLASSES)
    np.testing.assert_array_equal(tparts["anchor_cache"]["anchors"],
                                  jparts["anchor_cache"]["anchors"])
    net = tparts["net"]
    assert net.rpn.conv_cls.out_channels == 8 * 4  # 2 rotations x 4 classes


@pytest.fixture(scope="module")
def reduced():
    """Both packages' parts on the reduced config, the JAX variables and
    the port's network loaded from them."""
    text = reduced_text()
    tparts = tnb.build_network(tloads(text), "cpu")
    jparts = jnb.build_network(jloads(text), use_banded=False)
    variables = random_variables(jparts["net"], VOXELS, seed=5)
    tparts["net"].load_state_dict(from_flax(variables), strict=True)
    return text, tparts, jparts, variables


def test_reduced_all_fhd_preds_and_detections_match_jax(reduced):
    text, tparts, jparts, variables = reduced
    ctx = InferenceContext()
    ctx.build(tloads(text), device="cpu")
    ctx.parts["net"].load_state_dict(tparts["net"].state_dict())
    example = ctx.get_inference_input_dict({}, frame_points(0))
    preds, dets = ctx.run(example)
    ex = {k: jnp.asarray(v) for k, v in example_convert(example).items()}
    assert not any(k.startswith("plan_") for k in ex)
    plan = {k: jnp.asarray(v)
            for k, v in host_plan_of(ctx, example).items()}
    assert plan, "the config must exercise the host planner"
    jpreds = jax.jit(lambda v, e, p: jparts["net"].apply(
        v, e["voxels"], e["num_points"], e["coordinates"], train=False,
        sparse_plan=p))(variables, ex, plan)
    assert preds["cls_preds"].shape[1:] == (64 // 8 * 64 // 8 * 8, 4)
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        ref = np.asarray(jpreds[key])
        assert np.abs(ref).max() > 1e-3, key
        np.testing.assert_allclose(preds[key].numpy(), ref, atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    jdets = jax.jit(functools.partial(jvoxelnet.predict, jparts["spec"]))(
        jpreds, {"anchors": ex["anchors"]})
    valid = np.asarray(jdets["valid"])
    assert valid.sum() > 0, "the frame must produce detections"
    np.testing.assert_array_equal(dets["valid"].numpy(), valid)
    np.testing.assert_allclose(dets["box3d_lidar"].numpy()[valid],
                               np.asarray(jdets["box3d_lidar"])[valid],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dets["scores"].numpy(),
                               np.asarray(jdets["scores"]), atol=1e-4)
    np.testing.assert_array_equal(dets["label_preds"].numpy()[valid],
                                  np.asarray(jdets["label_preds"])[valid])


def test_four_class_example_and_loss_match_jax(reduced):
    text, tparts, jparts, variables = reduced
    cfg = tloads(text)
    tprep = build_prep_func(cfg.train_input_reader, tparts, training=True,
                            compact_targets=True)
    jkw = dict(tprep.keywords)
    jkw.update(root_path="", voxel_generator=jparts["voxel_generator"],
               target_assigner=jparts["target_assigner"],
               anchor_cache=jparts["anchor_cache"],
               sparse_plan_scales=jsm.plan_scales(
                   "SpMiddleFHD", jparts["dense_shape"], VOXELS))
    np.random.seed(3)
    batch = merge_second_batch([tprep(input_dict=train_input(s))
                                for s in range(2)])
    np.random.seed(3)
    jbatch = merge_second_batch([jprep(input_dict=train_input(s), **jkw)
                                 for s in range(2)])
    for key in batch:
        if key not in ("metrics", "gt_names"):
            np.testing.assert_array_equal(
                batch[key], np.asarray(jbatch[key]).astype(batch[key].dtype),
                err_msg=key)
    # the published augmentation keeps the objects in range, and each
    # class's anchors match its object
    labels = batch["labels_i8"]
    assert {1, 2, 3, 4} == set(labels[labels > 0].tolist())
    assert (batch["pos_count"][:, 0] == (labels > 0).sum(1)).all()

    loss = forward_loss(copy.deepcopy(tparts["net"]), tparts["spec"],
                        example_to_device(batch, "cpu"))["loss"]
    ex = jexpand({k: jnp.asarray(v)
                  for k, v in example_convert(jbatch).items()},
                 jparts["spec"].box_code_size)
    plan = {k: v for k, v in ex.items() if k.startswith("plan_")}

    def jloss(v):
        preds, _ = jparts["net"].apply(
            v, ex["voxels"], ex["num_points"], ex["coordinates"], train=True,
            sparse_plan=plan, mutable=["batch_stats"])
        return jvoxelnet.compute_loss(jparts["spec"], preds, ex)["loss"]

    ref = float(jax.jit(jloss)(variables))
    np.testing.assert_allclose(loss.item(), ref, rtol=1e-4)


@pytest.mark.parametrize("agnostic", [False, True],
                         ids=["class_aware", "class_agnostic"])
def test_multiclass_nms_matches_jax(reduced, agnostic):
    """predict on the same random preds over the reduced config's four
    classes' anchors, one NMS per class with its own pre/post sizes and
    thresholds."""
    _, tparts, jparts, _ = reduced
    spec = dict(
        multiclass_nms=True, nms_class_agnostic=agnostic,
        nms_pre_max_sizes=(200, 150, 100, 120),
        nms_post_max_sizes=(40, 30, 20, 10),
        nms_score_thresholds=(0.3, 0.35, 0.4, 0.3),
        nms_iou_thresholds=(0.01, 0.1, 0.2, 0.05))
    tspec = dataclasses.replace(tparts["spec"], **spec)
    jspec = dataclasses.replace(jparts["spec"], **spec)
    anchors = tparts["anchor_cache"]["anchors"].astype(np.float32)[None]
    a = anchors.shape[1]
    rng = np.random.RandomState(6)
    preds = {
        "box_preds": (rng.randn(1, a, 7) * 0.3).astype(np.float32),
        "cls_preds": (rng.randn(1, a, 4) * 1.5).astype(np.float32),
        "dir_cls_preds": rng.randn(1, a, 2).astype(np.float32),
    }
    mask = rng.uniform(size=(1, a)) < 0.9
    ref = jax.jit(functools.partial(jvoxelnet.predict, jspec))(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {"anchors": jnp.asarray(anchors), "anchors_mask": jnp.asarray(mask)})
    out = tvoxelnet.predict(
        tspec, {k: torch.from_numpy(v) for k, v in preds.items()},
        {"anchors": torch.from_numpy(anchors),
         "anchors_mask": torch.from_numpy(mask)})
    valid = np.asarray(ref["valid"])
    assert out["valid"].shape == (1, 100)  # the four post sizes
    np.testing.assert_array_equal(out["valid"].numpy(), valid)
    labels = np.asarray(ref["label_preds"])[valid]
    assert sorted(set(labels.tolist())) == [0, 1, 2, 3]
    for c, post in enumerate(spec["nms_post_max_sizes"]):
        assert 0 < (labels == c).sum() <= post
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[valid],
                               np.asarray(ref["box3d_lidar"])[valid],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5)
    np.testing.assert_array_equal(out["label_preds"].numpy()[valid], labels)


def test_reduced_all_fhd_device_route_matches_host_route(reduced):
    text, tparts, _, _ = reduced
    runs = []
    for device_voxelize in (False, True):
        ctx = InferenceContext()
        ctx.build(tloads(text), device="cpu", device_voxelize=device_voxelize)
        ctx.parts["net"].load_state_dict(tparts["net"].state_dict())
        runs.append(ctx.run(ctx.get_inference_input_dict({},
                                                         frame_points(1))))
    (preds_h, dets_h), (preds_d, dets_d) = runs
    for key in preds_h:
        np.testing.assert_allclose(preds_d[key].numpy(),
                                   preds_h[key].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    valid = dets_h["valid"].numpy()
    assert valid.sum() > 0
    np.testing.assert_array_equal(dets_d["valid"].numpy(), valid)
    np.testing.assert_array_equal(dets_d["label_preds"].numpy()[valid],
                                  dets_h["label_preds"].numpy()[valid])


def _four_class_tree(root, frames):
    """A fixture tree of four-class frames, its infos, reduced clouds and
    GT database."""
    ids = tfixture.build_kitti_dir(root, num_frames=frames, seed=0,
                                   scene_kwargs=dict(
        classes={"Car": 3, "Cyclist": 2, "Pedestrian": 2, "Van": 1},
        num_bg_points=3000, points_per_object=60, x_range=(0.0, 22.8),
        y_range=(-11.4, 11.4)))
    tkd.create_kitti_info_file(str(root), train_img_ids=ids,
                               val_img_ids=ids, test_img_ids=[])
    tkd.create_reduced_point_cloud(str(root))
    tgt.create_groundtruth_database(
        "KittiDataset", str(root),
        info_path=str(root / "kitti_infos_train.pkl"))
    return ids


def test_train_and_evaluate_reduced_all_fhd_on_cpu(tmp_path):
    root = tmp_path / "kitti"
    _four_class_tree(root, 2)
    cfg = tloads(reduced_text())
    cfg.train_input_reader.preprocess.database_sampler = load_pipeline_config(
        CONFIG).train_input_reader.preprocess.database_sampler
    cfg.train_input_reader.preprocess.database_sampler.database_info_path = (
        str(root / "kitti_dbinfos_train.pkl"))
    for reader, split in ((cfg.train_input_reader, "train"),
                          (cfg.eval_input_reader, "val")):
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(root / f"kitti_infos_{split}.pkl")
        reader.batch_size = 2
        reader.preprocess.num_workers = 0
    cfg.train_config.steps = 1
    config = tmp_path / "all_fhd.config"
    config.write_text(cfg.to_text())
    np.random.seed(0)
    train(str(config), str(tmp_path / "model"), device="cpu")
    assert (tmp_path / "model" / "voxelnet-1.ckpt").is_file()
    res = evaluate(str(config), str(tmp_path / "model"), device="cpu")
    official = res["results"]["official"]
    for name in CLASSES:
        assert f"{name} AP" in official, name


def test_four_sample_groups_prep_matches_jax(tmp_path):
    """The published four sample groups (Car 11, Pedestrian 6, Cyclist 6,
    Van 2, min 5 points each) through ``prep_pointcloud`` on a fixture
    tree of four-class frames and its GT database, which both packages'
    samplers read: the same np.random seeds give equal examples."""
    root = tmp_path / "kitti"
    ids = _four_class_tree(root, 3)
    cfg = load_pipeline_config(CONFIG)
    sampler_cfg = cfg.train_input_reader.preprocess.database_sampler
    reduced_cfg = tloads(reduced_text())
    reduced_cfg.train_input_reader.preprocess.database_sampler = sampler_cfg
    sampler_cfg.database_info_path = str(root / "kitti_dbinfos_train.pkl")
    reduced_cfg.train_input_reader.dataset.kitti_root_path = str(root)
    groups = [dict(g.name_to_max_num) for g in sampler_cfg.sample_groups]
    assert groups == [{"Car": 11}, {"Pedestrian": 6}, {"Cyclist": 6},
                      {"Van": 2}]
    tparts = tnb.build_network(reduced_cfg, "cpu")
    jparts = jnb.build_network(jloads(reduced_cfg.to_text()),
                               use_banded=False)
    np.random.seed(11)
    tprep = build_prep_func(reduced_cfg.train_input_reader, tparts,
                            training=True, compact_targets=True)
    np.random.seed(11)
    jsampler = jdbs.build(jloads(reduced_cfg.to_text())
                          .train_input_reader.preprocess.database_sampler)
    jkw = dict(tprep.keywords)
    jkw.update(db_sampler=jsampler,
               voxel_generator=jparts["voxel_generator"],
               target_assigner=jparts["target_assigner"],
               anchor_cache=jparts["anchor_cache"],
               sparse_plan_scales=jsm.plan_scales(
                   "SpMiddleFHD", jparts["dense_shape"], VOXELS))
    dataset = tkd.KittiDataset(root_path=str(root), info_path=str(
        root / "kitti_infos_train.pkl"))
    # what the port's sampler pastes into each frame
    sampler, draws = tprep.keywords["db_sampler"], []
    sample_all = sampler.sample_all
    sampler.sample_all = lambda *a, **k: draws.append(
        sample_all(*a, **k)) or draws[-1]
    for i in range(len(ids)):
        info = dataset.get_sensor_data(i)
        np.random.seed(20 + i)
        tex = tprep(input_dict=copy.deepcopy(info))
        np.random.seed(20 + i)
        jex = jprep(input_dict=copy.deepcopy(info), **jkw)
        assert sorted(k for k in tex if k != "metrics") == sorted(
            k for k in jex if k != "metrics")
        for key in tex:
            if key == "metrics":
                continue
            pairs = ([(f"{key}.{k}", tex[key][k], jex[key][k])
                      for k in tex[key]] if isinstance(tex[key], dict)
                     else [(key, tex[key], jex[key])])
            for name, t, j in pairs:
                t = np.asarray(t)
                np.testing.assert_array_equal(
                    t, np.asarray(j).astype(t.dtype), err_msg=name)
    sampled = {n for d in draws if d is not None for n in d["gt_names"]}
    # Van (at most 2, one in each frame already) may find no free place
    assert sampled >= {"Car", "Cyclist", "Pedestrian"}
