"""The port's PointPillars inference slice against the JAX package on the
CPU, module by module and end to end.

The config is xyres_16's topology at a small size, inline: range
[0, -10.24, 20.48, 10.24] with 0.16 m pillars (a 128 x 128 grid), T =
100, PillarFeatureNetOld with 64 filters, PointPillarsScatter, a narrow
RPNV2, standup NMS. Inputs are drawn with numpy from a seed; weights go
from the JAX variable tree to the port through ``from_flax``, with the
batch-norm statistics and affine parameters perturbed so they matter.
JAX's K4 runs its ``fori_loop`` reference here, the port's its plain
version.

Tolerances: exact for the voxelizer's and the pillarizer's outputs
(integer outputs, and the same float32 rows sorted the same way), for
the scatter (a copy) and for detection counts and labels; 1e-5 on the
pillar encoders in eval mode (fp32 sums of the same products in another
order) and 1e-4 in training mode (batch statistics add sums over every
slot); 2e-4 on the flat path's canvas against the module path's and
against JAX's (the affine form of batch norm and scatter sums, as the
JAX package's own ``test_pp_fast.py``); 1e-4 on the whole slice's preds
and on its detections' boxes and scores.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.configs import load_pipeline_config, loads_pipeline_config
from second_tpu.core.inference import InferenceContext as JaxContext
from second_tpu.models import pp_fast as jpp
from second_tpu.models.registry import get_middle_class as jget_middle
from second_tpu.models.registry import get_vfe_class as jget_vfe
from second_tpu.models.voxelnet import predict as jpredict
from second_tpu.ops import voxelize as jvox
from second_tpu.ops.nms import nms_bev as jnms_bev
from second_tpu.train.__main__ import example_convert
from second_tpu.train.state import TrainState

from second_tpu_torch import configs as port_configs
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models import pp_fast as tpp
from second_tpu_torch.models.middle import PointPillarsScatter
from second_tpu_torch.models.registry import get_vfe_class
from second_tpu_torch.ops import voxelize as tvox
from second_tpu_torch.ops.nms import nms_bev
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_slice import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_PP_CONFIG = """
model: {
  second: {
    network_class_name: "VoxelNet"
    voxel_generator {
      point_cloud_range : [0, -10.24, -3, 20.48, 10.24, 1]
      voxel_size : [0.16, 0.16, 4]
      max_number_of_points_per_voxel : 100
    }
    voxel_feature_extractor: {
      module_class_name: "PillarFeatureNetOld"
      num_filters: [64]
      with_distance: false
      num_input_features: 4
    }
    middle_feature_extractor: {
      module_class_name: "PointPillarsScatter"
      downsample_factor: 1
      num_input_features: 64
    }
    rpn: {
      module_class_name: "RPNV2"
      layer_nums: [1, 2, 2]
      layer_strides: [2, 2, 2]
      num_filters: [16, 16, 32]
      upsample_strides: [1, 2, 4]
      num_upsample_filters: [16, 16, 16]
      num_input_features: 64
    }
    loss: {
      classification_loss: {
        weighted_sigmoid_focal: { alpha: 0.25 gamma: 2.0 anchorwise_output: true }
      }
      localization_loss: {
        weighted_smooth_l1: { sigma: 3.0 code_weight: [1, 1, 1, 1, 1, 1, 1] }
      }
      classification_weight: 1.0
      localization_weight: 2.0
    }
    num_point_features: 4
    use_sigmoid_score: true
    encode_background_as_zeros: true
    encode_rad_error_by_sin: true
    sin_error_factor: 1.0
    use_direction_classifier: true
    direction_loss_weight: 0.2
    num_direction_bins: 2
    direction_limit_offset: 1
    pos_class_weight: 1.0
    neg_class_weight: 1.0
    loss_norm_type: NormByNumPositives
    post_center_limit_range: [0, -10.24, -5, 20.48, 10.24, 5]
    box_coder: {
      ground_box3d_coder: { linear_dim: false encode_angle_vector: false }
    }
    target_assigner: {
      class_settings: {
        anchor_generator_stride: {
          sizes: [1.6, 3.9, 1.56]
          strides: [0.32, 0.32, 0.0]
          offsets: [0.16, -10.08, -1.78]
          rotations: [0, 1.57]
        }
        matched_threshold : 0.6
        unmatched_threshold : 0.45
        class_name: "Car"
        use_rotate_nms: false
        use_multi_class_nms: false
        nms_pre_max_size: 1000
        nms_post_max_size: 300
        nms_score_threshold: 0.05
        nms_iou_threshold: 0.5
        region_similarity_calculator: { nearest_iou_similarity: { } }
      }
      sample_positive_fraction : -1
      sample_size : 512
      assign_per_class: true
    }
  }
}
train_input_reader: {
  batch_size: 2
  preprocess: {
    max_number_of_voxels: 2000
    shuffle_points: true
    anchor_area_threshold: 1
  }
}
train_config: {
  optimizer: {
    adam_optimizer: {
      learning_rate: {
        one_cycle: { lr_max: 3e-3 moms: [0.95, 0.85] div_factor: 10.0 pct_start: 0.4 }
      }
      weight_decay: 0.01
    }
    fixed_weight_decay: true
  }
  steps: 100
  enable_mixed_precision: false
}
eval_input_reader: {
  preprocess: {
    max_number_of_voxels: 2000
    anchor_area_threshold: 1
  }
}
"""

VOXEL_SIZE = (0.16, 0.16, 4.0)
RANGE = (0.0, -10.24, -3.0, 20.48, 10.24, 1.0)
GRID = (128, 128, 1)
T = 100
PILLAR_CLASSES = ["PillarFeatureNet", "PillarFeatureNetOld",
                  "PillarFeatureNetRadius", "PillarFeatureNetRadiusHeight"]


def small_pp_points(seed=0, n=3000, boundary=True):
    """A frame inside (and a little outside) the small range: ground up
    to x = 12 m (the anchors past it are masked), two car-sized
    clusters, 150 points in one 0.16 m pillar (cell [4.96, 5.12) x
    [0.96, 1.12)), more than its T = 100 slots, and (``boundary``) 100
    points on cell boundaries (float32 multiples of 0.16 m from the
    range's corner)."""
    rng = np.random.RandomState(seed)
    ground = np.stack([rng.uniform(-1, 12, n), rng.uniform(-11, 11, n),
                       rng.normal(-1.7, 0.05, n), rng.uniform(0, 1, n)], 1)
    parts = [ground]
    for cx, cy in ((8.0, -3.0), (14.5, 4.0)):
        m = 400
        parts.append(np.stack([rng.uniform(cx - 0.8, cx + 0.8, m),
                               rng.uniform(cy - 1.9, cy + 1.9, m),
                               rng.uniform(-1.7, -0.2, m),
                               rng.uniform(0, 1, m)], 1))
    parts.append(rng.uniform([4.97, 0.97, -1.5, 0], [5.11, 1.11, 0.5, 1],
                             (150, 4)))
    cells = rng.randint(0, 128, (100, 2))
    if boundary:
        parts.append(np.stack([
            np.float32(0.16) * cells[:, 0].astype(np.float32),
            np.float32(-10.24)
            + np.float32(0.16) * cells[:, 1].astype(np.float32),
            rng.uniform(-1.7, -0.2, 100), rng.uniform(0, 1, 100)], 1))
    points = np.concatenate(parts).astype(np.float32)
    return points[rng.permutation(len(points))]


def padded(points, rows=8192):
    buf = np.zeros((rows, points.shape[1]), np.float32)
    buf[:len(points)] = points
    return buf, len(points)


def _by_coords(coords, *arrays):
    """The valid rows of ``coords`` (zyx, -1 padding) and ``arrays``,
    ordered by coordinate: a voxel set, whatever order it came in."""
    valid = coords[:, 0] >= 0
    order = np.lexsort(coords[valid].T[::-1])
    return [coords[valid][order]] + [a[valid][order] for a in arrays]


# max_voxels 2000: the frame fits; 64: it overflows (first come, first
# served); T 5: most pillars are cut to their first 5 points
@pytest.mark.parametrize("max_voxels,t", [(2000, T), (64, T), (2000, 5)])
def test_voxelize_matches_jax(max_voxels, t):
    buf, n = padded(small_pp_points())
    jv, jc, jn, jnv = jvox.voxelize(
        jnp.asarray(buf), n, VOXEL_SIZE[:3], RANGE[:3], grid_size=GRID,
        max_voxels=max_voxels, max_points_per_voxel=t)
    tv, tc, tn, tnv = tvox.voxelize(
        torch.from_numpy(buf), n, VOXEL_SIZE[:3], RANGE[:3], GRID,
        max_voxels, t)
    assert int(tnv) == int(jnv) == int((np.asarray(jc)[:, 0] >= 0).sum())
    assert int(np.asarray(jn).max()) == t  # the T cap engages
    if max_voxels == 64:
        assert int(jnv) == 64
    ref = _by_coords(np.asarray(jc), np.asarray(jn), np.asarray(jv))
    out = _by_coords(tc.numpy(), tn.numpy(), tv.numpy())
    for name, a, b in zip(("coords", "counts", "voxels"), out, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("max_voxels", [2000, 64])
def test_flat_pillarize_matches_jax(max_voxels):
    buf, n = padded(small_pp_points(1))
    ref = jpp.flat_pillarize(
        jnp.asarray(buf), n, VOXEL_SIZE, RANGE[:3], grid_size=GRID,
        max_voxels=max_voxels, max_points_per_voxel=T)
    out = tpp.flat_pillarize(torch.from_numpy(buf), n, VOXEL_SIZE, RANGE[:3],
                             GRID, max_voxels, T)
    names = ("pts_s", "coords_pt", "vrank", "pillar_coords", "counts",
             "num_voxels")
    for name, a, b in zip(names, out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(out[4].max()) == T


def _jax_vfe(name, num_filters):
    return jget_vfe(name)(num_input_features=4, use_norm=True,
                          num_filters=num_filters, with_distance=False,
                          voxel_size=VOXEL_SIZE, pc_range=RANGE)


def _port_vfe(name, num_filters):
    return get_vfe_class(name)(num_input_features=4, num_filters=num_filters,
                               with_distance=False, voxel_size=VOXEL_SIZE,
                               pc_range=RANGE)


def _pillar_inputs(seed, max_voxels=600):
    buf, n = padded(small_pp_points(seed))
    voxels, coords, counts, _ = tvox.voxelize(
        torch.from_numpy(buf), n, VOXEL_SIZE, RANGE[:3], GRID, max_voxels, T)
    return voxels.numpy(), coords.numpy(), counts.numpy()


def _vfe_variables(vfe, v, seed):
    shapes = jax.eval_shape(
        vfe.init, jax.random.PRNGKey(0), jnp.zeros((1, v, T, 4)),
        jnp.zeros((1, v), jnp.int32), jnp.full((1, v, 3), -1, jnp.int32))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("mean", "bias"):
            val = rng.uniform(-0.1, 0.1, shape)
        elif name in ("var", "scale"):
            val = rng.uniform(0.5, 1.5, shape)
        else:  # Dense kernels [in, out]
            val = rng.randn(*shape) / np.sqrt(shape[0])
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", PILLAR_CLASSES)
def test_pillar_encoder_matches_jax(name, train):
    """Two PFN layers (32, 64), so the repeated max of a middle layer
    is covered; in training mode the batch statistics and the running
    statistics they update too."""
    voxels, coords, counts = _pillar_inputs(2)
    v = voxels.shape[0]
    jvfe = _jax_vfe(name, (32, 64))
    variables = _vfe_variables(jvfe, v, seed=3)
    tvfe = _port_vfe(name, (32, 64))
    tvfe.load_state_dict(from_flax(variables), strict=True)
    tvfe.train(train)
    args = (voxels[None], counts[None], coords[None])
    if train:
        ref, updates = jvfe.apply(variables, *args, train=True,
                                  mutable=["batch_stats"])
    else:
        ref = jvfe.apply(variables, *args, train=False)
    out = tvfe(*(torch.from_numpy(a) for a in args))
    tol = 1e-4 if train else 1e-5
    assert np.abs(np.asarray(ref)).max() > 1e-2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)
    if train:
        state = tvfe.state_dict()
        for key, val in from_flax({"params": {},
                                   "batch_stats": updates["batch_stats"]}
                                  ).items():
            np.testing.assert_allclose(state[key].numpy(), val.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=key)


def test_pointpillars_scatter_matches_jax():
    rng = np.random.RandomState(4)
    b, v, c = 2, 300, 8
    coords = np.full((b, v, 3), -1, np.int32)
    for i in range(b):
        n = 200 + 50 * i
        lin = rng.choice(GRID[0] * GRID[1], n, replace=False)
        coords[i, :n] = np.stack([np.zeros(n), lin // GRID[0],
                                  lin % GRID[0]], 1)
    feats = rng.randn(b, v, c).astype(np.float32)
    shape = (1, 1, GRID[1], GRID[0], c)
    ref = jget_middle("PointPillarsScatter")(output_shape=shape).apply(
        {}, jnp.asarray(feats), jnp.asarray(coords))
    out = PointPillarsScatter(shape)(torch.from_numpy(feats),
                                     torch.from_numpy(coords))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(ref).transpose(0, 3, 1, 2))


def _flags(name):
    return dict(radius="Radius" in name, height="Height" in name,
                center_replaces_xy=name.endswith("Old"))


@pytest.mark.parametrize("name", PILLAR_CLASSES)
def test_flat_pfn_bev_matches_jax(name):
    buf, n = padded(small_pp_points(5))
    maxv = 2000
    jvfe = _jax_vfe(name, (64,))
    vfe_vars = _vfe_variables(jvfe, maxv, seed=6)
    variables = {k: {"voxel_feature_extractor": vfe_vars[k]}
                 for k in ("params", "batch_stats")}
    flat = jpp.flat_pillarize(
        jnp.asarray(buf), n, VOXEL_SIZE, RANGE[:3], grid_size=GRID,
        max_voxels=maxv, max_points_per_voxel=T)
    ref = jpp.flat_pfn_bev(
        variables, *flat[:5], num_filters=(64,), max_points_per_voxel=T,
        voxel_size=VOXEL_SIZE, pc_range=RANGE, grid_size=GRID,
        num_input_features=4, **_flags(name))
    tvfe = _port_vfe(name, (64,)).eval()
    tvfe.load_state_dict(from_flax(vfe_vars), strict=True)
    tflat = tpp.flat_pillarize(torch.from_numpy(buf), n, VOXEL_SIZE,
                               RANGE[:3], GRID, maxv, T)
    with torch.no_grad():
        out = tpp.flat_pfn_bev(tvfe, *tflat[:5], max_points_per_voxel=T,
                               grid_size=GRID)
    ref = np.asarray(ref).transpose(2, 0, 1)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", PILLAR_CLASSES)
@pytest.mark.parametrize("max_voxels", [2000, 64])
def test_flat_path_matches_module_path(name, max_voxels):
    """The port's flat canvas against its own voxelize -> encoder ->
    scatter, with the frame's overfull pillar, and with the capacity
    overflowing."""
    buf, n = padded(small_pp_points(6))
    pts = torch.from_numpy(buf)
    vfe = _port_vfe(name, (64,)).eval()
    vfe.load_state_dict(
        from_flax(_vfe_variables(_jax_vfe(name, (64,)), 8, seed=7)),
        strict=True)
    voxels, coords, counts, _ = tvox.voxelize(
        pts, n, VOXEL_SIZE, RANGE[:3], GRID, max_voxels, T)
    assert int(counts.max()) == T  # the cap engages
    scatter = PointPillarsScatter((1, 1, GRID[1], GRID[0], 64))
    with torch.no_grad():
        mod = scatter(vfe(voxels[None], counts[None], coords[None]),
                      coords[None])[0]
        flat = tpp.flat_pfn_bev(
            vfe, *tpp.flat_pillarize(pts, n, VOXEL_SIZE, RANGE[:3], GRID,
                                     max_voxels, T)[:5],
            max_points_per_voxel=T, grid_size=GRID)
    np.testing.assert_allclose(flat.numpy(), mod.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_standup_nms_matches_jax_at_xyres16_shapes():
    """predict's NMS at xyres_16's settings (standup IoU, 1000
    candidates, 300 kept at IoU 0.5), boxes spread as car anchors."""
    rng = np.random.RandomState(9)
    a = 6000
    boxes = np.stack([rng.uniform(0, 69.12, a), rng.uniform(-39.68, 39.68, a),
                      rng.uniform(1.4, 1.8, a), rng.uniform(3.5, 4.3, a),
                      rng.choice([0.0, 1.57], a) + rng.normal(0, 0.1, a)],
                     1).astype(np.float32)
    scores = rng.uniform(0, 1, a).astype(np.float32)
    kwargs = dict(pre_max_size=1000, post_max_size=300, iou_threshold=0.5,
                  score_threshold=0.05, rotated=False)
    ref_idx, ref_valid = jnms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                  **kwargs)
    idx, valid = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                         **kwargs)
    assert 100 < int(np.asarray(ref_valid).sum()) <= 300
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_from_flax_loads_xyres16_at_full_width():
    """The JAX package's variables of the published xyres_16 network
    (PFNLayer_0/LinearBNReLU_0/{Dense_0, MaskedBatchNorm_0}, the RPN)
    load into the port's with strict=True; the tree's shapes come from
    ``jax.eval_shape``, which compiles nothing."""
    from second_tpu.builders import build_network as jbuild

    from second_tpu_torch.builders.network_builder import build_network

    path = os.path.join(REPO, "configs", "pointpillars", "car",
                        "xyres_16.config")
    jnet = jbuild(load_pipeline_config(path).model.second)["net"]
    variables = random_variables(jnet, 16)
    tnet = build_network(port_configs.load_pipeline_config(path), "cpu")["net"]
    tnet.load_state_dict(from_flax(variables), strict=True)
    w = variables["params"]["voxel_feature_extractor"]["PFNLayer_0"][
        "LinearBNReLU_0"]["Dense_0"]["kernel"]
    assert w.shape == (9, 64)
    np.testing.assert_array_equal(
        tnet.voxel_feature_extractor.pfn_layers[0].linear_bn_relu.linear
        .weight.detach().numpy(), w.T)


@pytest.fixture(scope="module")
def both():
    cfg = loads_pipeline_config(SMALL_PP_CONFIG)
    jctx = JaxContext()
    jctx.build(cfg)
    variables = random_variables(
        jctx.parts["net"], cfg.eval_input_reader.preprocess.max_number_of_voxels)
    jctx._state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=(), global_step=jnp.zeros((), jnp.int32))
    tctx = InferenceContext()
    tctx.build(port_configs.loads_pipeline_config(SMALL_PP_CONFIG),
               device="cpu")
    tctx.load_flax_variables(variables)
    # no point on a cell boundary: see test_boundary_points_divide
    return jctx, tctx, small_pp_points(7, boundary=False)


def test_examples_match(both):
    """Both ship the padded points and the same anchors and anchor mask,
    and no voxels."""
    jctx, tctx, points = both
    assert tctx.flat_pp
    jex = jctx.get_inference_input_dict({}, points)
    tex = tctx.get_inference_input_dict({}, points)
    assert "voxels" not in tex and "voxels" not in jex
    for key in ("points", "points_count", "anchors", "anchors_mask"):
        np.testing.assert_array_equal(tex[key], jex[key], err_msg=key)
    assert 0 < tex["anchors_mask"].sum() < tex["anchors_mask"].size


def test_preds_match(both):
    jctx, tctx, points = both
    jex = jctx.get_inference_input_dict({}, points)
    ex = {k: jnp.asarray(v) for k, v in example_convert(jex).items()}
    variables = {"params": jctx._state.params,
                 "batch_stats": jctx._state.batch_stats}
    gen = jctx.parts["voxel_generator"]
    flat = jpp.flat_pillarize(
        ex["points"][0], ex["points_count"][0, 0],
        tuple(float(x) for x in gen.voxel_size),
        tuple(float(x) for x in gen.point_cloud_range[:3]),
        grid_size=GRID, max_voxels=2000, max_points_per_voxel=T)
    bev = jpp.flat_pfn_bev(
        variables, *flat[:5], num_filters=(64,), max_points_per_voxel=T,
        voxel_size=VOXEL_SIZE, pc_range=RANGE, grid_size=GRID,
        num_input_features=4, center_replaces_xy=True)
    jpreds = jctx.parts["net"].apply(
        variables, bev[None], method=lambda m, x: m.rpn(x, train=False))
    tpreds, _ = tctx.run(tctx.get_inference_input_dict({}, points))
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        ref = np.asarray(jpreds[key]).reshape(tpreds[key].shape)
        assert np.abs(ref).max() > 1e-3, key  # not a trivially zero map
        np.testing.assert_allclose(tpreds[key].numpy(), ref, atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_detections_match(both):
    jctx, tctx, points = both
    jdets = jctx.inference(jctx.get_inference_input_dict({}, points))[0]
    tdets = tctx.inference(tctx.get_inference_input_dict({}, points))[0]
    assert len(jdets["scores"]) > 0, "the frame must produce detections"
    assert len(tdets["scores"]) == len(jdets["scores"])
    np.testing.assert_allclose(tdets["box3d_lidar"], jdets["box3d_lidar"],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tdets["scores"], jdets["scores"], atol=1e-4)
    np.testing.assert_array_equal(tdets["label_preds"], jdets["label_preds"])


def test_boundary_points_divide(both):
    """Points on cell boundaries land where floor((p - rmin) / vs) puts
    them, a float32 division as in the host voxelizer and in the JAX
    package's voxelize and pp_fast functions: the port's request on
    such a frame matches JAX's ``pointpillars_infer`` called on its own.
    (JAX's jitted eval step, the one its InferenceContext serves, folds
    the division by the constant voxel size into a product by its
    reciprocal, so some of these points land one cell over there.)"""
    jctx, tctx, _ = both
    points = small_pp_points(7)
    jex = jctx.get_inference_input_dict({}, points)
    ex = {k: jnp.asarray(v) for k, v in example_convert(jex).items()}
    flat_pp = jctx._flat_pp
    ref = jpp.pointpillars_infer(
        {"params": jctx._state.params,
         "batch_stats": jctx._state.batch_stats},
        jctx.parts["net"], jctx.parts["spec"], jpredict, ex["anchors"],
        ex["points"], ex["points_count"][:, 0], gen=flat_pp["gen"],
        model_cfg=flat_pp["model_cfg"], max_voxels=flat_pp["max_voxels"],
        predict_example={"anchors_mask": ex["anchors_mask"]})
    tex = tctx.get_inference_input_dict({}, points)
    _, out = tctx.run(tex)
    # the host voxelizer (kept for the anchor mask) finds the same pillars
    flat = tpp.flat_pillarize(torch.from_numpy(tex["points"][0]),
                              int(tex["points_count"][0, 0]), VOXEL_SIZE,
                              RANGE[:3], GRID, 2000, T)
    assert int(flat[5]) == int(tex["num_voxels"][0, 0])
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(out["valid"].numpy(), valid)
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[valid],
                               np.asarray(ref["box3d_lidar"])[valid],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]),
                               atol=1e-4)
    np.testing.assert_array_equal(out["label_preds"].numpy()[valid],
                                  np.asarray(ref["label_preds"])[valid])


def test_batch_of_two_matches_single_frames(both):
    """Two frames merged into one request give each frame's own
    detections and preds."""
    _, tctx, points = both
    frames = [points, small_pp_points(8)]
    singles = [tctx.run(tctx.get_inference_input_dict({}, p)) for p in frames]
    batch = tctx.get_inference_input_dict({}, frames[0])
    other = tctx.get_inference_input_dict({}, frames[1])
    batch = {k: np.concatenate([v, other[k]]) if isinstance(v, np.ndarray)
             else v + other[k] for k, v in batch.items()}
    preds, dets = tctx.run(batch)
    for b, (p1, d1) in enumerate(singles):
        for key in p1:
            torch.testing.assert_close(preds[key][b], p1[key][0], rtol=1e-6,
                                       atol=1e-6)
        for key in d1:
            torch.testing.assert_close(dets[key][b], d1[key][0], rtol=1e-6,
                                       atol=1e-6)
