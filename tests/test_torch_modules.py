"""The port's modules against their JAX counterparts on the CPU: the
weight bridge (``from_flax``), SpMiddleFHD on the host-plan path, a
narrow RPNV2, ``predict`` fed the same preds, and the training slice's
modules: the masked batch norm in training mode, the losses,
``compute_loss``, the schedules and the optimizer.

Weights are drawn with numpy into the JAX variable tree (structure from
``jax.eval_shape``) and bridged with ``from_flax``; batch-norm
statistics and affine parameters are random so a layout error shows.
Tolerances: 1e-4 on activations (fp32 sums in another order); exact on
detection counts and labels, 1e-5 on their boxes and scores (the same
fp32 preds go in, and the scores are distinct); 1e-6 on the batch
norm, the losses and the optimizer's parameters; 1e-7 of the largest
value on the schedules (float32 on both sides, other cos/pow/exp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.models import layers as jlayers
from second_tpu.models import voxelnet as jvoxelnet
from second_tpu.ops import losses as jlosses
from second_tpu.models import sparse_middle as jsm
from second_tpu.models.registry import get_middle_class, get_rpn_class

from second_tpu_torch.models import layers as tlayers
from second_tpu_torch.models import sparse_middle as tsm
from second_tpu_torch.models import voxelnet as tvoxelnet
from second_tpu_torch.models.rpn import RPNV2
from second_tpu_torch.ops import losses as tlosses
from second_tpu_torch.utils.from_flax import from_flax


def _random_variables(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("mean", "bias"):
            v = rng.uniform(-0.1, 0.1, shape)
        elif name in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # kernels: HWIO or [K, Cin, Cout]
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _load(module, variables):
    module.load_state_dict(from_flax(variables), strict=True)
    return module.eval()


def test_from_flax_layouts():
    """Each layout rule of the bridge on a hand-made tree."""
    rng = np.random.RandomState(0)
    conv = rng.randn(3, 3, 4, 8).astype(np.float32)        # HWIO
    deconv = rng.randn(2, 2, 8, 6).astype(np.float32)      # HWIO
    sparse_w = rng.randn(27, 4, 16).astype(np.float32)
    state = from_flax({
        "params": {
            "rpn": {"ConvBNReLU_3": {
                "Conv_0": {"kernel": conv},
                "MaskedBatchNorm_0": {"scale": np.ones(8, np.float32),
                                      "bias": np.zeros(8, np.float32)}},
                "ConvBNReLU_4": {"ConvTranspose_0": {"kernel": deconv}},
                "conv_box": {"kernel": conv[:1, :1], "bias": np.zeros(8)}},
            "middle_feature_extractor": {"subm0_w": sparse_w},
            "Dense_0": {"kernel": conv[0, 0]},
        },
        "batch_stats": {"rpn": {"ConvBNReLU_3": {"MaskedBatchNorm_0": {
            "mean": np.zeros(8, np.float32),
            "var": np.ones(8, np.float32)}}}},
    })
    np.testing.assert_array_equal(state["rpn.layers.3.conv.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["rpn.layers.4.conv.weight"].numpy(),
                                  deconv[::-1, ::-1].transpose(2, 3, 0, 1))
    assert state["rpn.conv_box.weight"].shape == (8, 4, 1, 1)
    np.testing.assert_array_equal(
        state["middle_feature_extractor.subm0_w"].numpy(), sparse_w)
    np.testing.assert_array_equal(state["linear.weight"].numpy(),
                                  conv[0, 0].T)
    assert {"rpn.layers.3.bn.weight", "rpn.layers.3.bn.bias",
            "rpn.layers.3.bn.running_mean",
            "rpn.layers.3.bn.running_var"} <= set(state)


def test_spmiddle_fhd_plan_path():
    """SpMiddleFHD on host rulebooks at a [41, 64, 64] grid, sparse
    scales 0-2 plus the dense tail, as the JAX package's own
    banded-vs-gather test."""
    rng = np.random.RandomState(7)
    v, c = 600, 16
    output_shape = (1, 40, 64, 64, c)
    shape = (41, 64, 64)
    n_active = 400
    lin = np.sort(rng.choice(np.prod(shape), size=n_active, replace=False))
    coords = np.full((v, 3), -1, np.int32)
    coords[:n_active] = np.stack(
        [lin // (shape[1] * shape[2]), (lin % (shape[1] * shape[2])) // shape[2],
         lin % shape[2]], -1)
    feats = np.zeros((v, c), np.float32)
    feats[:n_active] = rng.randn(n_active, c)

    jmid = get_middle_class("SpMiddleFHD")(output_shape=output_shape,
                                           num_input_features=c)
    fj, cj = jnp.asarray(feats)[None], jnp.asarray(coords)[None]
    variables = _random_variables(jax.eval_shape(
        jmid.init, jax.random.PRNGKey(0), fj, cj), seed=1)
    jplan = jsm.build_host_plan(coords, jsm.plan_scales(
        "SpMiddleFHD", output_shape, v))
    ref = np.asarray(jmid.apply(
        variables, fj, cj,
        plan={k: jnp.asarray(x)[None] for k, x in jplan.items()}))

    tplan = tsm.build_host_plan(coords, tsm.plan_scales(
        "SpMiddleFHD", output_shape, v))
    assert sorted(tplan) == sorted(jplan)
    for k in jplan:
        np.testing.assert_array_equal(tplan[k], jplan[k].astype(np.int32))
    tmid = _load(tsm.SpMiddleFHD(output_shape=output_shape,
                                 num_input_features=c), variables)
    with torch.no_grad():
        out = tmid(torch.from_numpy(feats)[None],
                   torch.from_numpy(coords)[None],
                   {k: torch.from_numpy(x)[None] for k, x in tplan.items()})
    out = out.permute(0, 2, 3, 1).numpy()  # NCHW -> the JAX NHWC
    assert ref.shape == out.shape == (1, 8, 8, 128)  # 64 / 8, 64 * 2
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("strides,ups", [
    ((1, 2), (1, 2)),      # car.fhd's shape: transpose-conv deblocks
    ((2, 2), (0.5, 1)),    # strided-conv deblock for a fractional stride
])
def test_rpnv2_narrow(strides, ups):
    kwargs = dict(num_class=1, layer_nums=(1, 2), layer_strides=strides,
                  num_filters=(8, 16), upsample_strides=ups,
                  num_upsample_filters=(8, 8), num_input_features=12,
                  num_anchor_per_loc=2, box_code_size=7,
                  num_direction_bins=2)
    jrpn = get_rpn_class("RPNV2")(**kwargs)
    x = np.random.RandomState(3).randn(2, 16, 16, 12).astype(np.float32)
    variables = _random_variables(
        jax.eval_shape(jrpn.init, jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    ref = jrpn.apply(variables, jnp.asarray(x))
    trpn = _load(RPNV2(**kwargs), variables)
    with torch.no_grad():
        out = trpn(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


SPEC_FIELDS = dict(
    num_class=1, box_code_size=7, num_anchor_per_loc=2,
    use_direction_classifier=True, num_direction_bins=2,
    dir_limit_offset=1.0, nms_score_thresholds=(0.3,),
    nms_pre_max_sizes=(300,), nms_post_max_sizes=(60,),
    nms_iou_thresholds=(0.01,),
    post_center_range=(0.0, -20.0, -2.2, 40.0, 20.0, 0.8))


@pytest.mark.parametrize("rotated", [True, False])
def test_predict_same_preds(rotated):
    rng = np.random.RandomState(5)
    a = 2000
    anchors = np.stack([
        rng.uniform(0, 40, a), rng.uniform(-20, 20, a), np.full(a, -1.0),
        np.full(a, 1.6), np.full(a, 3.9), np.full(a, 1.56),
        rng.choice([0.0, 1.57], a)], 1).astype(np.float32)[None]
    preds = {
        "box_preds": (rng.randn(1, a, 7) * 0.3).astype(np.float32),
        "cls_preds": rng.randn(1, a, 1).astype(np.float32),
        "dir_cls_preds": rng.randn(1, a, 2).astype(np.float32),
    }
    mask = rng.uniform(size=(1, a)) < 0.9
    jspec = jvoxelnet.ModelSpec(**SPEC_FIELDS, use_rotate_nms=rotated)
    tspec = tvoxelnet.ModelSpec(**SPEC_FIELDS, use_rotate_nms=rotated)
    ref = jvoxelnet.predict(
        jspec, {k: jnp.asarray(v) for k, v in preds.items()},
        {"anchors": jnp.asarray(anchors), "anchors_mask": jnp.asarray(mask)})
    out = tvoxelnet.predict(
        tspec, {k: torch.from_numpy(v) for k, v in preds.items()},
        {"anchors": torch.from_numpy(anchors),
         "anchors_mask": torch.from_numpy(mask)})
    valid = np.asarray(ref["valid"])
    assert 1 < valid.sum() < 60  # NMS both keeps and suppresses
    np.testing.assert_array_equal(out["valid"].numpy(), valid)
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[valid],
                               np.asarray(ref["box3d_lidar"])[valid],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5)
    np.testing.assert_array_equal(out["label_preds"].numpy()[valid],
                                  np.asarray(ref["label_preds"])[valid])


def test_nms_ties_follow_jax_top_k():
    """Equal scores are ranked lower index first on both sides, so the
    kept set does not depend on the device's top-k tie order."""
    from second_tpu.ops.nms import nms_bev as jnms_bev

    from second_tpu_torch.ops.nms import nms_bev

    rng = np.random.RandomState(8)
    a = 400
    boxes = np.stack([rng.uniform(0, 20, a), rng.uniform(0, 20, a),
                      np.full(a, 1.6), np.full(a, 3.9),
                      rng.choice([0.0, 1.57], a)], 1).astype(np.float32)
    scores = rng.choice([0.2, 0.5, 0.9], a).astype(np.float32)  # all tied
    kwargs = dict(pre_max_size=150, post_max_size=40, iou_threshold=0.01,
                  score_threshold=0.3)
    ref_idx, ref_valid = jnms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                  **kwargs)
    idx, valid = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                         **kwargs)
    assert 1 < int(np.asarray(ref_valid).sum()) < 40
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_simple_voxel_both_inputs():
    """Point means from [B, V, T, F] voxels (empty slots zero, counts
    may be 0) and the pass-through of precomputed [B, V, F] means."""
    from second_tpu.models.voxel_encoders import SimpleVoxel as JSimpleVoxel

    from second_tpu_torch.models.voxel_encoders import SimpleVoxel

    rng = np.random.RandomState(9)
    counts = rng.randint(0, 6, (2, 30)).astype(np.int32)
    voxels = rng.randn(2, 30, 5, 4).astype(np.float32)
    voxels *= (np.arange(5)[None, None, :, None] < counts[..., None, None])
    coords = np.zeros((2, 30, 3), np.int32)
    jvfe, tvfe = JSimpleVoxel(num_input_features=4), SimpleVoxel(4)
    for x in (voxels, voxels.sum(axis=2)):  # [B, V, T, F], then [B, V, F]
        ref = jvfe.apply({}, jnp.asarray(x), jnp.asarray(counts),
                         jnp.asarray(coords))
        out = tvfe(torch.from_numpy(x), torch.from_numpy(counts),
                   torch.from_numpy(coords))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


# ------------------------------------------------ the training slice's modules


@pytest.mark.parametrize("kind", ["sparse", "dense", "nomask"])
def test_masked_batchnorm_train_matches_flax(kind):
    """Training mode: batch statistics over the masked rows (n counted
    over the whole batch) normalise, the unbiased variance updates the
    running statistics; output and statistics at 1e-6."""
    rng = np.random.RandomState(21)
    c = 8
    if kind == "sparse":
        x = rng.randn(2, 50, c).astype(np.float32) * 2 + 0.5
        mask = rng.uniform(size=(2, 50)) < 0.6
        to_t, channel_dim = (lambda a: a), -1
    elif kind == "dense":  # JAX [B, D, H, W, C], the port's C on dim 1
        x = rng.randn(2, 3, 5, 4, c).astype(np.float32) * 2 + 0.5
        mask = rng.uniform(size=(2, 3, 5, 4)) < 0.3
        to_t, channel_dim = (lambda a: a.permute(0, 4, 1, 2, 3)), 1
    else:
        x = rng.randn(2, 6, 5, c).astype(np.float32) * 2 + 0.5
        mask = None
        to_t, channel_dim = (lambda a: a.permute(0, 3, 1, 2)), 1
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    ref, updated = jlayers.MaskedBatchNorm().apply(
        variables, jnp.asarray(x), mask=None if mask is None else
        jnp.asarray(mask), use_running_average=False, mutable=["batch_stats"])

    bn = tlayers.MaskedBatchNorm(c)
    bn.load_state_dict(from_flax(variables))
    bn.train()
    out = bn(to_t(torch.from_numpy(x)),
             mask=None if mask is None else torch.from_numpy(mask),
             channel_dim=channel_dim)
    np.testing.assert_allclose(out.detach().numpy(),
                               to_t(torch.from_numpy(np.array(ref))).numpy(),
                               atol=1e-6, rtol=1e-6)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               atol=1e-6, rtol=1e-6)


def _loss_inputs(seed=22, b=2, a=40, c=3):
    rng = np.random.RandomState(seed)
    labels = rng.randint(-1, c + 1, size=(b, a)).astype(np.int32)
    onehot = np.eye(c + 1, dtype=np.float32)[np.maximum(labels, 0)]
    return {
        "preds": (rng.randn(b, a, c + 1) * 2).astype(np.float32),
        "onehot": onehot,
        "boxes": rng.randn(b, a, 7).astype(np.float32),
        "targets": rng.randn(b, a, 7).astype(np.float32),
        "weights": rng.uniform(0, 1, (b, a)).astype(np.float32),
        "labels": labels,
    }


LOSS_CASES = {
    "sigmoid_focal": lambda m, d: m.sigmoid_focal_loss(
        d["preds"], d["onehot"], d["weights"], gamma=2.0, alpha=0.25),
    "sigmoid_focal_no_alpha": lambda m, d: m.sigmoid_focal_loss(
        d["preds"], d["onehot"], d["weights"], gamma=2.0, alpha=None),
    "softmax_focal": lambda m, d: m.softmax_focal_loss(
        d["preds"], d["onehot"], d["weights"], gamma=2.0, alpha=0.25),
    "weighted_sigmoid": lambda m, d: m.weighted_sigmoid_loss(
        d["preds"], d["onehot"], d["weights"]),
    "bootstrapped_soft": lambda m, d: m.bootstrapped_sigmoid_loss(
        d["preds"], d["onehot"], d["weights"], alpha=0.4),
    "bootstrapped_hard": lambda m, d: m.bootstrapped_sigmoid_loss(
        d["preds"], d["onehot"], d["weights"], alpha=0.4,
        hard_bootstrap=True),
    "weighted_softmax": lambda m, d: m.weighted_softmax_loss(
        d["preds"], d["onehot"], d["weights"], logit_scale=1.5),
    "smooth_l1": lambda m, d: m.weighted_smooth_l1_loss(
        d["boxes"], d["targets"], d["weights"], sigma=3.0,
        code_weights=[1, 1, 1, 1, 1, 1, 2.0]),
    "smooth_l1_summed": lambda m, d: m.weighted_smooth_l1_loss(
        d["boxes"], d["targets"], d["weights"], sigma=1.0, codewise=False),
    "l2": lambda m, d: m.weighted_l2_loss(
        d["boxes"], d["targets"], d["weights"], code_weights=[0.5] * 7),
    "sin_difference": lambda m, d: m.add_sin_difference(
        d["boxes"], d["targets"], 2.0),
    "direction_target": lambda m, d: m.get_direction_target(
        d["boxes"], d["targets"], dir_offset=0.78, num_bins=2),
    "direction_target_bins": lambda m, d: m.get_direction_target(
        d["boxes"], d["targets"], num_bins=4, one_hot=False),
    **{f"prepare_weights_{t}": (
        lambda m, d, t=t: m.prepare_loss_weights(
            d["labels"], pos_cls_weight=2.0, neg_cls_weight=0.5,
            loss_norm_type=t)) for t in range(4)},
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    d = _loss_inputs()
    ref = LOSS_CASES[name](jlosses, {k: jnp.asarray(v) for k, v in d.items()})
    out = LOSS_CASES[name](tlosses, {k: torch.from_numpy(v)
                                     for k, v in d.items()})
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-6)


def test_compute_loss_matches_jax():
    """The whole loss of the small car.fhd config, both ModelSpecs built
    from the same text, on random preds and targets."""
    from second_tpu.builders import network_builder as jnb
    from second_tpu.configs import loads_pipeline_config as jloads
    from second_tpu_torch.builders import network_builder as tnb
    from second_tpu_torch.configs import loads_pipeline_config as tloads
    from test_torch_slice import SMALL_FHD_CONFIG

    jparts = jnb.build_network(jloads(SMALL_FHD_CONFIG))
    tparts = tnb.build_network(tloads(SMALL_FHD_CONFIG), "cpu")
    rng = np.random.RandomState(23)
    anchors = jparts["anchor_cache"]["anchors"].astype(np.float32)
    b, a = 2, anchors.shape[0]
    labels = rng.choice([-1, 0, 0, 0, 1], size=(b, a)).astype(np.int32)
    preds = {"box_preds": rng.randn(b, a, 7), "cls_preds": rng.randn(b, a, 1),
             "dir_cls_preds": rng.randn(b, a, 2)}
    example = {"anchors": np.broadcast_to(anchors, (b, a, 7)),
               "labels": labels,
               "reg_targets": rng.randn(b, a, 7) * (labels > 0)[..., None],
               "importance": rng.uniform(0.5, 1, (b, a))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    example = {k: np.asarray(v, np.int32 if k == "labels" else np.float32)
               for k, v in example.items()}
    ref = jvoxelnet.compute_loss(
        jparts["spec"], {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in example.items()})
    out = tvoxelnet.compute_loss(
        tparts["spec"], {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in example.items()})
    assert sorted(out) == sorted(ref)
    for key in ("loss", "cls_loss_reduced", "loc_loss_reduced",
                "cls_pos_loss", "cls_neg_loss", "dir_loss_reduced"):
        assert float(ref[key]) != 0.0, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out["cared"].numpy(), ref["cared"])


SCHEDULE_TEXT = {
    "one_cycle": "one_cycle: { lr_max: 2.25e-3 moms: [0.95, 0.85] "
                 "div_factor: 10.0 pct_start: 0.4 }",
    "exponential_staircase": "exponential_decay: { initial_learning_rate: "
                             "2e-4 decay_length: 0.1 decay_factor: 0.8 "
                             "staircase: true }",
    "exponential_smooth": "exponential_decay: { initial_learning_rate: "
                          "2e-4 decay_length: 0.1 decay_factor: 0.8 "
                          "staircase: false }",
    "manual_stepping": "manual_stepping: { boundaries: [0.3, 0.7] "
                       "rates: [1e-3, 5e-4, 1e-4] }",
    "multi_phase": 'multi_phase: { phases: { start: 0.0 lambda_func: '
                   '"lambda x: annealing_cos(1e-4, 1e-3, x)" '
                   'momentum_lambda_func: "lambda x: 0.95 - 0.1 * x" } '
                   'phases: { start: 0.4 lambda_func: '
                   '"lambda x: 1e-3 * exp(-2 * x) + max(0, 1e-5 - x)" '
                   'momentum_lambda_func: "lambda x: 0.85 + sin(pi * x / 2) '
                   '* 0.1" } }',
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_TEXT))
def test_schedules_match_jax(name):
    """Every schedule at steps 0..N against the JAX package's: both
    compute in float32, with other transcendental implementations, so
    they agree to 1e-7 of the schedule's largest value."""
    from second_tpu.configs import schema as jschema
    from second_tpu.configs.textproto import parse as jparse
    from second_tpu.train import schedules as jsched
    from second_tpu_torch.configs import schema as tschema
    from second_tpu_torch.configs.textproto import parse as tparse
    from second_tpu_torch.train import schedules as tsched

    total = 100
    text = SCHEDULE_TEXT[name]
    jlr, jmom = jsched.build(
        jschema.LearningRate.from_raw(jparse(text)), total)
    tlr, tmom = tsched.build(
        tschema.LearningRate.from_raw(tparse(text)), total)
    steps = np.arange(total + 3)
    for jfn, tfn in ((jlr, tlr), (jmom, tmom)):
        ref = np.array([float(jfn(s)) for s in steps])
        out = np.array([tfn(int(s)) for s in steps])
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-7 * np.abs(ref).max())


OPTIMIZER_TEXT = """
adam_optimizer: {{
  learning_rate: {{ one_cycle: {{ lr_max: 2.25e-3 moms: [0.95, 0.85]
                                 div_factor: 10.0 pct_start: 0.4 }} }}
  weight_decay: 0.01
}}
fixed_weight_decay: {fixed}
use_moving_average: {ema}
"""


@pytest.mark.parametrize("fixed,ema", [(True, False), (False, False),
                                       (True, True)])
def test_optimizer_matches_optax(fixed, ema):
    """Three updates on the same gradients against the optax ``tx`` of
    the JAX package's ``train.optimizer.build``; the second step's
    gradients exceed the clip norm of 10."""
    from second_tpu.configs import schema as jschema
    from second_tpu.configs.textproto import parse as jparse
    from second_tpu.train import optimizer as jopt
    from second_tpu_torch.configs import schema as tschema
    from second_tpu_torch.configs.textproto import parse as tparse
    from second_tpu_torch.train import optimizer as topt
    import optax

    text = OPTIMIZER_TEXT.format(fixed=str(fixed).lower(),
                                 ema=str(ema).lower())
    rng = np.random.RandomState(24)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.5, 20.0, 1e-3)]
    tx, _, _ = jopt.build(jschema.Optimizer.from_raw(jparse(text)), 50)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt, lr_fn, mom_fn = topt.build(
        tschema.Optimizer.from_raw(tparse(text)), 50, tparams)
    assert lr_fn(0) == pytest.approx(2.25e-4)
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = opt.step([torch.from_numpy(g[k].copy()) for k in ("a", "b")],
                        lr_fn(opt.count), mom_fn(opt.count))
        assert (float(norm) > topt.GRAD_CLIP_NORM) == (i == 1)
        for k, p in zip(("a", "b"), tparams):
            np.testing.assert_allclose(p.numpy(), jparams[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    if ema:
        jema = jopt.ema_params(jstate)
        for k, e in zip(("a", "b"), opt.ema):
            np.testing.assert_allclose(e.numpy(), jema[k], rtol=1e-6,
                                       atol=1e-6)
