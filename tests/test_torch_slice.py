"""The port's car.fhd slice against the JAX package, end to end on the CPU.

Both ``InferenceContext``s read the same small car.fhd-shaped config
(the published topology, SpMiddleFHD at a [41, 64, 64] grid, a narrow
RPNV2), the JAX one's random weights (batch-norm statistics and affine
parameters perturbed so they matter) go to the port through
``from_flax``, and one frame of points runs through both. The port's
kernels run as their plain PyTorch versions here.

Tolerances: network preds 1e-4 (fp32 sums in another order; the JAX
middle runs the same gathers as one matmul per conv); detections 1e-4
on boxes and scores, exact on labels and counts (the frame's scores are
distinct, so top-k order is the same).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from second_tpu.configs import loads_pipeline_config
from second_tpu.core.inference import InferenceContext as JaxContext
from second_tpu.train.__main__ import example_convert
from second_tpu.train.state import TrainState

from second_tpu_torch import configs as port_configs
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models.sparse_middle import build_host_plan, plan_scales

SMALL_FHD_CONFIG = """
model: {
  second: {
    network_class_name: "VoxelNet"
    voxel_generator {
      point_cloud_range : [0, -3.2, -3, 6.4, 3.2, 1]
      voxel_size : [0.1, 0.1, 0.1]
      max_number_of_points_per_voxel : 5
    }
    voxel_feature_extractor: {
      module_class_name: "SimpleVoxel"
      num_filters: [16]
      num_input_features: 4
    }
    middle_feature_extractor: {
      module_class_name: "SpMiddleFHD"
      downsample_factor: 8
      num_input_features: 4
    }
    rpn: {
      module_class_name: "RPNV2"
      layer_nums: [2, 2]
      layer_strides: [1, 2]
      num_filters: [16, 32]
      upsample_strides: [1, 2]
      num_upsample_filters: [16, 16]
      num_input_features: 128
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
    use_direction_classifier: true
    direction_loss_weight: 0.2
    num_direction_bins: 2
    direction_limit_offset: 1
    sin_error_factor: 1.0
    pos_class_weight: 1.0
    neg_class_weight: 1.0
    loss_norm_type: NormByNumPositives
    post_center_limit_range: [0, -3.2, -2.2, 6.4, 3.2, 0.8]
    box_coder: {
      ground_box3d_coder: { linear_dim: false encode_angle_vector: false }
    }
    target_assigner: {
      class_settings: {
        anchor_generator_range: {
          sizes: [1.6, 3.9, 1.56]
          anchor_ranges: [0, -3.2, -1.0, 6.4, 3.2, -1.0]
          rotations: [0, 1.57]
        }
        matched_threshold : 0.6
        unmatched_threshold : 0.45
        class_name: "Car"
        use_rotate_nms: true
        use_multi_class_nms: false
        nms_pre_max_size: 1000
        nms_post_max_size: 100
        nms_score_threshold: 0.3
        nms_iou_threshold: 0.01
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
    max_number_of_voxels: 3000
    shuffle_points: true
    groundtruth_localization_noise_std: [1.0, 1.0, 0.5]
    groundtruth_rotation_uniform_noise: [-0.78539816, 0.78539816]
    global_rotation_uniform_noise: [-0.78539816, 0.78539816]
    global_scaling_uniform_noise: [0.95, 1.05]
    global_random_rotation_range_per_object: [0, 0]
    global_translate_noise_std: [0, 0, 0]
    anchor_area_threshold: -1
    random_flip_x: false
    random_flip_y: true
  }
}
train_config: {
  optimizer: {
    adam_optimizer: {
      learning_rate: {
        one_cycle: { lr_max: 2.25e-3 moms: [0.95, 0.85] div_factor: 10.0 pct_start: 0.4 }
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
    max_number_of_voxels: 3000
    anchor_area_threshold: -1
  }
}
"""


def small_fhd_points(seed=0, n=2500):
    """A frame of points inside the small config's range: a ground
    plane plus two car-sized clusters."""
    rng = np.random.RandomState(seed)
    ground = np.stack([rng.uniform(0, 6.4, n), rng.uniform(-3.2, 3.2, n),
                       rng.normal(-1.7, 0.05, n), rng.uniform(0, 1, n)], 1)
    cars = []
    for cx, cy in ((2.0, -1.0), (4.5, 1.5)):
        m = 300
        cars.append(np.stack([rng.uniform(cx - 0.8, cx + 0.8, m),
                              rng.uniform(cy - 1.9, cy + 1.9, m),
                              rng.uniform(-1.7, -0.2, m),
                              rng.uniform(0, 1, m)], 1))
    return np.concatenate([ground] + cars).astype(np.float32)


def random_variables(net, voxels_per_frame, seed=1):
    """Random JAX variables for ``net``: weights with variance
    1/fan_in, batch-norm statistics and affine parameters away from
    identity (so a layout error cannot hide). The tree's structure
    comes from ``jax.eval_shape`` of the init, which traces but does
    not compile."""
    shapes = jax.eval_shape(
        net.init, jax.random.PRNGKey(0),
        jnp.zeros((1, voxels_per_frame, 5, 4), jnp.float32),
        jnp.zeros((1, voxels_per_frame), jnp.int32),
        jnp.full((1, voxels_per_frame, 3), -1, jnp.int32))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "mean":
            v = rng.uniform(-0.1, 0.1, shape)
        elif name in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
        else:  # conv kernels: HWIO or [K, Cin, Cout]
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def host_plan_of(ctx, example):
    """The loaders' host plan (``build_host_plan``) of a request's voxels,
    which the host sorts by linear id, batched [1, ...]: a request ships
    none, since the device builds its rulebooks."""
    name = ctx.parts["model_cfg"].middle_feature_extractor.module_class_name
    scales = plan_scales(name, ctx.parts["dense_shape"],
                         example["voxels"].shape[1])
    return {k: v[None] for k, v in
            build_host_plan(example["coordinates"][0], scales).items()}


@pytest.fixture(scope="module")
def both():
    cfg = loads_pipeline_config(SMALL_FHD_CONFIG)
    jctx = JaxContext()
    jctx.build(cfg)
    variables = random_variables(
        jctx.parts["net"], cfg.eval_input_reader.preprocess.max_number_of_voxels)
    jctx._state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=(), global_step=jnp.zeros((), jnp.int32))
    tctx = InferenceContext()
    tctx.build(port_configs.loads_pipeline_config(SMALL_FHD_CONFIG),
               device="cpu")
    tctx.load_flax_variables(variables)
    return jctx, tctx, small_fhd_points()


def test_examples_match(both):
    """The port's host path (the linear-id sort) gives the JAX package's
    example: same voxels and coordinates; the port's planner on them
    gives the JAX package's rulebooks (the port's request ships none:
    its device builds them)."""
    jctx, tctx, points = both
    jex = jctx.get_inference_input_dict({}, points)
    tex = tctx.get_inference_input_dict({}, points)
    for key in ("voxels", "coordinates", "num_points", "anchors"):
        np.testing.assert_array_equal(tex[key], jex[key], err_msg=key)
    assert not any(k.startswith("plan_") for k in tex)
    tplan = host_plan_of(tctx, tex)
    plan_keys = sorted(k for k in jex if k.startswith("plan_"))
    assert plan_keys == sorted(tplan)
    assert plan_keys, "the config must exercise the host planner"
    for key in plan_keys:
        np.testing.assert_array_equal(
            tplan[key], jex[key].astype(np.int32), err_msg=key)


def test_preds_match(both):
    jctx, tctx, points = both
    jex = jctx.get_inference_input_dict({}, points)
    ex = {k: jnp.asarray(v) for k, v in example_convert(jex).items()}
    plan = {k: v for k, v in ex.items() if k.startswith("plan_")}
    variables = {"params": jctx._state.params,
                 "batch_stats": jctx._state.batch_stats}
    jpreds = jctx.parts["net"].apply(
        variables, ex["voxels"], ex["num_points"], ex["coordinates"],
        train=False, sparse_plan=plan)
    tpreds, _ = tctx.run(tctx.get_inference_input_dict({}, points))
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        ref = np.asarray(jpreds[key])
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
