"""The port's PointPillars training slice against the JAX package on the
CPU: the point-shipping, compact-target prep, the device voxelizer, the
target expansion, three train steps and the flat-pillar eval step.

Both packages read ``SMALL_PP_CONFIG`` (xyres_16's topology at a
128 x 128 grid, ``test_torch_pointpillars``). Frames have no point on a
cell boundary (``small_pp_points(boundary=False)``): JAX's jitted steps
fold the division by the voxel size into a product by its reciprocal
(ROADMAP section 3), the port divides.

Tolerances: the prep's arrays exactly, overflow warnings included
(same ``np.random`` draws, the same numpy); the voxelizer's voxel sets
and the target expansion exactly (copies); three steps as
``test_torch_train`` holds car.fhd's: every gradient within 1e-4 of its
own largest magnitude (every ReLU opened by batch-norm biases in
[5, 6], the port re-synced to JAX's state before each step), the losses
and metrics within rtol 1e-5, counts and classification stats exactly;
the eval step's detections as ``test_detections_match``: the same
count and labels, boxes and scores within 1e-4.
"""

import copy
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.builders import network_builder as jnb
from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.data.preprocess import prep_pointcloud as jprep
from second_tpu.models.voxelnet import compute_loss as jcompute_loss
from second_tpu.train import optimizer as jopt
from second_tpu.train.__main__ import example_convert as jconvert
from second_tpu.train.state import TrainState as JaxTrainState
from second_tpu.train.state import _expand_targets as jexpand
from second_tpu.train.state import make_eval_step as jmake_eval_step
from second_tpu.train.state import make_train_step as jmake_train_step
from second_tpu.train.state import make_voxelizer_fn as jmake_voxelizer

from second_tpu_torch.builders import network_builder as tnb
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.data.kitti_dataset import KittiDataset
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import example_to_device
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.train import optimizer as topt
from second_tpu_torch.train.state import (
    _expand_targets,
    forward_loss,
    make_eval_step,
    make_train_step,
    make_voxelizer_fn,
)
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_pointpillars import SMALL_PP_CONFIG, small_pp_points
from test_torch_slice import random_variables
from test_torch_train import _sync_to_jax, train_variables

# the rows a KITTI frame's point buffer holds (the dataset's capacity)
POINTS_BUFFER = KittiDataset.PointsCapacity

MAX_VOXELS = 2000
# as in test_torch_train: a gradient whose JAX fp32 value lies further
# than this share of its own largest magnitude from the port's float64
# gradient is not resolved by fp32 to the 1e-4 tolerance, and the port's
# must lie within twice JAX's distance of float64. On these inputs JAX's
# error reaches 1.8e-4 of the size on the batch norms and convolutions
# of the first two RPN blocks and the pillar encoder's norm (the port's
# stays closer to float64); each step's such set must lie in this one
UNRESOLVED = 5e-5
UNRESOLVED_GRADS = {
    "rpn.layers.0.bn.bias", "rpn.layers.1.bn.bias", "rpn.layers.1.bn.weight",
    "rpn.layers.1.conv.weight", "rpn.layers.2.bn.weight",
    "rpn.layers.2.conv.weight",
    "voxel_feature_extractor.pfn_layers.0.linear_bn_relu.bn.weight"}
# the two car-sized clusters of small_pp_points, as annotated boxes
PP_BOXES = np.array([[8.0, -3.0, -0.95, 1.6, 3.8, 1.5, 1.5708],
                     [14.5, 4.0, -0.95, 1.6, 3.8, 1.5, 1.5708]], np.float32)


def pp_train_input(seed):
    return {"lidar": {"points": small_pp_points(seed, boundary=False),
                      "annotations": {"boxes": PP_BOXES.copy(),
                                      "names": np.array(["Car", "Car"])}}}


@pytest.fixture(scope="module")
def setup():
    cfg = tloads(SMALL_PP_CONFIG)
    tparts = tnb.build_network(cfg, "cpu")
    jparts = jnb.build_network(jloads(SMALL_PP_CONFIG), use_banded=False)
    return cfg, tparts, jparts


def _preps(tparts, jparts, cfg, **kwargs):
    tprep = build_prep_func(cfg.train_input_reader, tparts, training=True,
                            **kwargs)
    jkw = dict(tprep.keywords)
    jkw.update(root_path="", voxel_generator=jparts["voxel_generator"],
               target_assigner=jparts["target_assigner"],
               anchor_cache=jparts["anchor_cache"])
    return tprep, jkw


@pytest.mark.parametrize("emit,pos_capacity", [
    (POINTS_BUFFER, 1024),  # everything fits
    (2000, 1024),  # more in-range points than the buffer
    (POINTS_BUFFER, 8),  # more positive anchors than the capacity
])
def test_prep_emit_points_compact_targets_match_jax(setup, emit,
                                                    pos_capacity):
    cfg, tparts, jparts = setup
    tprep, jkw = _preps(tparts, jparts, cfg, emit_points=emit,
                        compact_targets=True)
    for seed in (0, 1):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            np.random.seed(100 + seed)
            tex = tprep(input_dict=pp_train_input(seed),
                        pos_capacity=pos_capacity)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            np.random.seed(100 + seed)
            jex = jprep(input_dict=pp_train_input(seed),
                        pos_capacity=pos_capacity, **jkw)
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        # both attributed to the caller of prep_pointcloud
        assert {w.filename for w in tw + jw} <= {__file__}
        assert len(tw) == (emit < POINTS_BUFFER) + (pos_capacity < 100)
        assert sorted(k for k in tex if k != "metrics") == sorted(
            k for k in jex if k != "metrics")
        assert "voxels" not in tex and "labels" not in tex
        assert 0 < int(tex["pos_count"][0])
        for key in tex:
            if key in ("metrics", "gt_names"):
                continue
            np.testing.assert_array_equal(tex[key], np.asarray(jex[key]),
                                          err_msg=key)
            assert tex[key].dtype == np.asarray(jex[key]).dtype, key


def test_quantize_points_raises(setup):
    cfg, tparts, _ = setup
    prep = build_prep_func(cfg.train_input_reader, tparts, training=True,
                           emit_points=POINTS_BUFFER)
    with pytest.raises(NotImplementedError):
        prep(input_dict=pp_train_input(0), quantize_points=True)


def _by_coords(coords, *arrays):
    valid = coords[:, 0] >= 0
    order = np.lexsort(coords[valid].T[::-1])
    return [coords[valid][order]] + [a[valid][order] for a in arrays]


def _point_batch(cfg, tparts, jparts, seeds=(0, 1), pos_capacity=1024):
    tprep, _ = _preps(tparts, jparts, cfg, emit_points=8192,
                      compact_targets=True)
    np.random.seed(7)
    return merge_second_batch([
        tprep(input_dict=pp_train_input(s), pos_capacity=pos_capacity)
        for s in seeds])


@pytest.mark.parametrize("max_voxels", [MAX_VOXELS, 64])
def test_voxelizer_fn_and_expand_targets_match_jax(setup, max_voxels):
    cfg, tparts, jparts = setup
    batch = _point_batch(cfg, tparts, jparts)
    tex = example_to_device(batch, "cpu")
    jex = {k: jnp.asarray(v) for k, v in jconvert(batch).items()}
    tvox = make_voxelizer_fn(tparts["voxel_generator"], max_voxels)
    jvox = jmake_voxelizer(jparts["voxel_generator"], max_voxels)
    out = tvox(tex["points"], tex["points_count"])
    ref = jax.jit(jvox)(jex["points"], jex["points_count"])
    for b in range(2):
        got = _by_coords(out[2][b].numpy(), out[1][b].numpy(),
                         out[0][b].numpy())
        want = _by_coords(np.asarray(ref[2][b]), np.asarray(ref[1][b]),
                          np.asarray(ref[0][b]))
        assert len(got[0]) == (max_voxels if max_voxels == 64
                               else len(got[0]))
        for name, a, w in zip(("coords", "counts", "voxels"), got, want):
            np.testing.assert_array_equal(a, w, err_msg=name)

    code = tparts["spec"].box_code_size
    texp = _expand_targets(tex, code)
    jexp = jax.jit(lambda e: jexpand(e, code))(jex)
    assert (texp["labels"] > 0).sum() > 0
    for key in ("labels", "reg_targets"):
        np.testing.assert_array_equal(texp[key].numpy(),
                                      np.asarray(jexp[key]), err_msg=key)
    assert "labels_i8" not in texp and "pos_idx" not in texp


def pp_train_variables(net):
    """``train_variables`` (every ReLU opened by batch-norm biases in
    [5, 6]) with the heads' kernels scaled by 0.05: the open ReLUs
    otherwise drive the logits to ~10, where the positives' focal loss
    (~1e-7) is a difference of numbers near 1 that fp32 resolves only to
    ~1e-4 of itself."""
    variables = train_variables(net, MAX_VOXELS)
    for head in ("conv_cls", "conv_box", "conv_dir_cls"):
        k = variables["params"]["rpn"][head]["kernel"]
        variables["params"]["rpn"][head]["kernel"] = k * np.float32(0.05)
    return variables


def _grads(net, spec, example, voxelizer):
    """The loss's gradients of a copy of ``net`` (a forward in training
    mode moves the batch statistics)."""
    net = copy.deepcopy(net)
    loss = forward_loss(net, spec, example, voxelizer)["loss"]
    names, params = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_pp_train_steps_match_jax(setup):
    cfg, tparts, jparts = setup
    batch = _point_batch(cfg, tparts, jparts)
    jnet, jspec = jparts["net"], jparts["spec"]
    variables = pp_train_variables(jnet)
    tx, _, _ = jopt.build(cfg.train_config.optimizer, cfg.train_config.steps)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                         variables), tx)
    jvox = jmake_voxelizer(jparts["voxel_generator"], MAX_VOXELS)
    jstep = jmake_train_step(jnet, jspec, tx, voxelizer=jvox)
    jex = {k: jnp.asarray(v) for k, v in jconvert(batch).items()}

    @jax.jit
    def jgrads(state):
        ex = jexpand(jex, jspec.box_code_size)
        voxels, num_points, coords = jvox(ex["points"], ex["points_count"])

        def loss_fn(params):
            preds, _ = jnet.apply(
                {"params": params, "batch_stats": state.batch_stats},
                voxels, num_points, coords, train=True,
                mutable=["batch_stats"])
            return jcompute_loss(jspec, preds, ex)["loss"]
        return jax.grad(loss_fn)(state.params)

    net, spec = tparts["net"], tparts["spec"]
    net.load_state_dict(from_flax(variables), strict=True)
    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer,
                                    cfg.train_config.steps,
                                    list(net.parameters()))
    tvox = make_voxelizer_fn(tparts["voxel_generator"], MAX_VOXELS)
    step = make_train_step(net, spec, opt, lr_fn, mom_fn, voxelizer=tvox)
    tex = example_to_device(batch, "cpu")
    assert "labels_i8" in tex and "voxels" not in tex
    tex64 = {k: v.double() if v.is_floating_point() else v
             for k, v in tex.items()}

    for i in range(3):
        _sync_to_jax(net, opt, jstate)
        ref_grads = from_flax({"params": jgrads(jstate)})
        grads = _grads(net, spec, tex, tvox)
        grads64 = _grads(copy.deepcopy(net).double(), spec, tex64, tvox)
        assert sorted(grads) == sorted(ref_grads)
        unresolved = set()  # fp32 leaves JAX's own gradient off float64
        for name, g in grads.items():
            g, ref = g.numpy(), ref_grads[name].numpy()
            exact = grads64[name].numpy()
            own = np.abs(exact).max()
            ref_err = np.abs(ref - exact).max()
            if ref_err <= UNRESOLVED * own:
                np.testing.assert_allclose(
                    g, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                    err_msg=f"step {i} grad {name}")
            else:
                unresolved.add(name)
                assert np.abs(g - exact).max() <= 2 * ref_err, (
                    f"step {i} grad {name}: port further from float64 than "
                    f"twice JAX's {ref_err / own:.3e} of its magnitude")
        assert unresolved <= UNRESOLVED_GRADS, f"step {i}: {unresolved}"

        jstate, jm = jstep(jstate, jex)
        m = step(tex)
        assert step.state.global_step == int(jstate.global_step) == i + 1
        for key in ("loss", "cls_loss", "loc_loss", "cls_pos_loss",
                    "cls_neg_loss", "dir_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        for key in ("num_pos", "num_neg"):
            assert int(m[key]) == int(jm[key]), key
        assert int(m["num_pos"]) > 0
        for key, v in jm["cls_stats"].items():
            np.testing.assert_array_equal(m["cls_stats"][key].numpy(),
                                          np.asarray(v), err_msg=key)


def test_pp_eval_step_matches_jax(setup):
    """The flat pillar path through ``make_eval_step`` against JAX's
    jitted eval step on the same weights and a batch of 2 frames."""
    cfg, tparts, jparts = setup
    prep = build_prep_func(cfg.eval_input_reader, tparts, training=False,
                  emit_points=POINTS_BUFFER)
    batch = merge_second_batch([
        prep(input_dict={"lidar": {"points": small_pp_points(
            s, boundary=False)}}) for s in (7, 8)])
    variables = jax.tree_util.tree_map(
        jnp.asarray, random_variables(jparts["net"], MAX_VOXELS))
    jstate = JaxTrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=(), global_step=jnp.zeros((), jnp.int32))
    gen = jparts["voxel_generator"]
    jstep = jmake_eval_step(
        jparts["net"], jparts["spec"],
        voxelizer=jmake_voxelizer(gen, MAX_VOXELS),
        flat_pp=dict(gen=gen, model_cfg=jparts["model_cfg"],
                     max_voxels=MAX_VOXELS))
    ref = jstep(jstate, {k: jnp.asarray(v)
                         for k, v in jconvert(batch).items()})
    net = tparts["net"]
    net.load_state_dict(from_flax(variables), strict=True)
    tgen = tparts["voxel_generator"]
    step = make_eval_step(net, tparts["spec"],
                          voxelizer=make_voxelizer_fn(tgen, MAX_VOXELS),
                          flat_pp=dict(gen=tgen, max_voxels=MAX_VOXELS))
    out = step(example_to_device(batch, "cpu"))
    for b in range(2):
        valid = np.asarray(ref["valid"][b])
        assert valid.sum() > 0, "the frame must produce detections"
        np.testing.assert_array_equal(out["valid"][b].numpy(), valid)
        for key, tol in (("box3d_lidar", 1e-4), ("scores", 1e-4)):
            np.testing.assert_allclose(
                out[key][b].numpy()[valid], np.asarray(ref[key][b])[valid],
                atol=tol, rtol=tol, err_msg=key)
        np.testing.assert_array_equal(
            out["label_preds"][b].numpy()[valid],
            np.asarray(ref["label_preds"][b])[valid])
