"""The rest of the detection-head zoo against the JAX package on the CPU:
the VFE encoders (``VoxelFeatureExtractor``, ``VoxelFeatureExtractorV2``,
``SimpleVoxelRadius``), the RPN zoo (RPNV2 with GroupNorm, ``RPNNoHead``,
``ResNetRPN``), ``bev_box_decode`` and the BEV coder's decode, and the
GHM losses.

Weights are drawn with numpy into the JAX variable tree (batch-norm
statistics and affine parameters away from identity) and bridged with
``from_flax``. Each module runs in eval mode and in training mode (batch
statistics over the real voxels' slots, or the whole map); the input
gradient is that of sum(out * g) for a fixed random g.

Tolerances: forward atol = rtol = 1e-4 (fp32 sums in another order);
the input gradient within 1e-4 of its norm in L2; ``bev_box_decode`` and
the BEV decode 1e-6; the GHM losses and their gradients 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.models import voxelnet as jvoxelnet
from second_tpu.models.registry import get_rpn_class as jget_rpn
from second_tpu.models.registry import get_vfe_class as jget_vfe
from second_tpu.ops import box_ops_jax
from second_tpu.ops import losses as jlosses

from second_tpu_torch.models import voxelnet as tvoxelnet
from second_tpu_torch.models.registry import get_rpn_class as tget_rpn
from second_tpu_torch.models.registry import get_vfe_class as tget_vfe
from second_tpu_torch.ops import box_ops_torch
from second_tpu_torch.ops import losses as tlosses
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_modules import _random_variables

GRAD_L2_TOL = 1e-4


def _l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run_jax(module, variables, args, train, cotangent=None):
    """The module's output (a dict) and, given the cotangent g (a dict
    like the output), the gradient of sum(out * g) w.r.t. its first
    argument; one jitted trace."""
    def f(x):
        if train:
            out, _ = module.apply(variables, x, *args[1:], train=True,
                                  mutable=["batch_stats"])
        else:
            out = module.apply(variables, x, *args[1:], train=False)
        return out if isinstance(out, dict) else {"out": out}

    x = jnp.asarray(args[0])
    if cotangent is None:
        return {k: np.asarray(v) for k, v in jax.jit(f)(x).items()}, None

    def out_and_grad(x):
        out, vjp = jax.vjp(f, x)
        return out, vjp({k: jnp.asarray(v) for k, v in cotangent.items()})[0]

    out, grad = jax.jit(out_and_grad)(x)
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(grad)


def _run_port(module, args, train, cotangent, to_port, from_port):
    """As :func:`_run_jax` for the port's module; ``to_port`` and
    ``from_port`` move the first argument and the outputs between the
    JAX layout and the port's."""
    module.train(train)
    x = to_port(torch.from_numpy(args[0])).requires_grad_(True)
    out = module(x, *(torch.from_numpy(a) for a in args[1:]))
    flat = out if isinstance(out, dict) else {"out": out}
    loss = sum((flat[k] * to_port(torch.from_numpy(cotangent[k]))).sum()
               for k in cotangent)
    (grad,) = torch.autograd.grad(loss, x)
    return ({k: from_port(v).detach().numpy() for k, v in flat.items()},
            from_port(grad).numpy())


def _compare(ref, out, ref_grad, grad, rows=None):
    """``rows``: where to compare the gradients (all where None)."""
    if rows is not None:
        ref_grad, grad = ref_grad[rows], grad[rows]
    assert sorted(ref) == sorted(out)
    for key in ref:
        assert np.abs(ref[key]).max() > 1e-3, key  # not a zero map
        np.testing.assert_allclose(out[key], ref[key], atol=1e-4, rtol=1e-4,
                                   err_msg=key)
    assert np.abs(ref_grad).max() > 0
    assert _l2(grad, ref_grad) <= GRAD_L2_TOL


def _cotangent(ref, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*v.shape).astype(np.float32) for k, v in ref.items()}


# ------------------------------------------------------------- the encoders

ENCODERS = {
    "VoxelFeatureExtractor": dict(num_filters=(16, 32)),
    "VoxelFeatureExtractor_distance": dict(num_filters=(16, 32),
                                           with_distance=True),
    "VoxelFeatureExtractorV2": dict(num_filters=(8, 16, 24)),
    "SimpleVoxelRadius": dict(),
}


def _voxel_inputs(seed=31, b=2, v=40, t=6, f=4):
    """Voxels [B, V, T, F] with zero empty slots, counts 0..T (padding
    voxels with 0 points among them) and zyx coords."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, t + 1, (b, v)).astype(np.int32)
    voxels = (rng.randn(b, v, t, f) * 2 + 0.5).astype(np.float32)
    voxels *= (np.arange(t)[None, None, :, None] < counts[..., None, None])
    coords = rng.randint(0, 10, (b, v, 3)).astype(np.int32)
    return voxels, counts, coords


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoders_match_jax(case, train):
    name = case.split("_")[0]
    kwargs = dict(num_input_features=4, **ENCODERS[case])
    args = _voxel_inputs()
    jmod = jget_vfe(name)(**kwargs)
    tmod = tget_vfe(name)(**kwargs)
    jargs = tuple(jnp.asarray(a) for a in args)
    variables = (_random_variables(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), *jargs), seed=32)
        if name != "SimpleVoxelRadius" else {})
    if variables:
        tmod.load_state_dict(from_flax(variables), strict=True)
    else:
        assert not list(tmod.state_dict())
    probe = jax.eval_shape(lambda *a: jmod.apply(
        variables, *a, train=False), *jargs)
    cot = _cotangent({"out": probe}, 33)
    ref, ref_grad = _run_jax(jmod, variables, args, train, cot)
    ident = lambda t: t  # noqa: E731
    out, grad = _run_port(tmod, args, train, cot, ident, ident)
    # the norm of a zero point (an empty voxel's mean, a padded slot's
    # distance) has no derivative (JAX gives NaN there, torch 0): those
    # gradients are compared on the real voxels or slots only
    rows = None
    if name == "SimpleVoxelRadius":
        rows = args[1] > 0
    elif kwargs.get("with_distance"):
        rows = np.arange(args[0].shape[2]) < args[1][..., None]
    _compare(ref, out, ref_grad, grad, rows)
    if name == "SimpleVoxelRadius":  # precomputed [B, V, F] means pass too
        means = args[0].sum(axis=2) / np.maximum(args[1], 1)[..., None]
        ref = jmod.apply({}, jnp.asarray(means), *jargs[1:])
        out = tmod(torch.from_numpy(means), *(torch.from_numpy(a)
                                               for a in args[1:]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


# ------------------------------------------------------------ the RPN zoo

RPN_BASE = dict(num_class=4, layer_nums=(1, 2), layer_strides=(1, 2),
                num_filters=(8, 16), upsample_strides=(1, 2),
                num_upsample_filters=(8, 8), num_input_features=12,
                num_anchor_per_loc=8, box_code_size=7, num_direction_bins=2)
RPNS = {
    "RPNV2_groupnorm": ("RPNV2", dict(use_groupnorm=True, num_groups=4)),
    "RPNV2_groupnorm_fractional": ("RPNV2", dict(
        use_groupnorm=True, num_groups=2, layer_strides=(2, 2),
        upsample_strides=(0.5, 1))),
    "RPNNoHead": ("RPNNoHead", dict()),
    "ResNetRPN": ("ResNetRPN", dict()),
    "ResNetRPN_fractional": ("ResNetRPN", dict(
        layer_nums=(0, 2), layer_strides=(2, 2), upsample_strides=(0.5, 1),
        num_filters=(12, 16))),
}


def _nchw(t):
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(RPNS))
def test_rpn_zoo_matches_jax(case, train):
    name, extra = RPNS[case]
    kwargs = {**RPN_BASE, **extra}
    x = np.random.RandomState(34).randn(2, 16, 16, 12).astype(np.float32)
    jmod, tmod = jget_rpn(name)(**kwargs), tget_rpn(name)(**kwargs)
    variables = _random_variables(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=35)
    tmod.load_state_dict(from_flax(variables), strict=True)
    probe = jax.eval_shape(lambda a: jmod.apply(variables, a),
                           jnp.asarray(x))
    cot = _cotangent(probe, 36)
    ref, ref_grad = _run_jax(jmod, variables, (x,), train, cot)

    def to_port(t):  # heads [B, nloc, H, W, size] keep their layout
        return _nchw(t)

    out, grad = _run_port(tmod, (x,), train, cot, to_port, _nhwc)
    _compare(ref, out, ref_grad, grad)


def test_groupnorm_groups_contiguous_channels():
    """flax groups the channel-last axis in contiguous blocks, as torch
    groups NCHW channels: a map whose groups differ only by a constant
    normalises to the same values in each group's channels."""
    import flax.linen as fnn

    rng = np.random.RandomState(37)
    x = rng.randn(1, 5, 5, 8).astype(np.float32)
    ref = fnn.GroupNorm(num_groups=2, epsilon=1e-3).apply(
        {"params": {"scale": np.ones(8, np.float32),
                    "bias": np.zeros(8, np.float32)}}, jnp.asarray(x))
    gn = torch.nn.GroupNorm(2, 8, eps=1e-3)
    out = _nhwc(gn(_nchw(torch.from_numpy(x)))).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------- the BEV coder

@pytest.mark.parametrize("vec,linear", [(False, False), (True, False),
                                        (False, True)])
def test_bev_box_decode_matches_jax(vec, linear):
    rng = np.random.RandomState(38)
    n = 500
    anchors = np.stack([
        rng.uniform(0, 70, n), rng.uniform(-40, 40, n), rng.uniform(-2, 0, n),
        rng.uniform(0.5, 2, n), rng.uniform(0.8, 5, n), rng.uniform(1, 2, n),
        rng.choice([0.0, 1.57], n)], 1).astype(np.float32)
    enc = (rng.randn(n, 6 if vec else 5) * 0.3).astype(np.float32)
    bev = anchors[:, [0, 1, 3, 4, 6]]
    ref = box_ops_jax.bev_box_decode(jnp.asarray(enc), jnp.asarray(bev),
                                     vec, linear)
    out = box_ops_torch.bev_box_decode(torch.from_numpy(enc),
                                       torch.from_numpy(bev), vec, linear)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    fields = dict(num_class=1, box_code_size=enc.shape[1],
                  num_anchor_per_loc=2, bev_coder=True, bev_z_fixed=-0.8,
                  bev_h_fixed=1.7, vec_encode=vec, linear_dim=linear)
    ref = jvoxelnet.ModelSpec(**fields).decode(jnp.asarray(enc),
                                               jnp.asarray(anchors))
    out = tvoxelnet.ModelSpec(**fields).decode(torch.from_numpy(enc),
                                               torch.from_numpy(anchors))
    assert out.shape == (n, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


# -------------------------------------------------------- the GHM losses

def _ghm_inputs(seed=39, b=2, a=300, c=4):
    rng = np.random.RandomState(seed)
    labels = rng.randint(-1, c + 1, (b, a))
    weights = (labels >= 0).astype(np.float32) * rng.uniform(0.5, 1.5, (b, a))
    weights = weights.astype(np.float32)
    logits = (rng.randn(b, a, c) * 2).astype(np.float32)
    onehot = np.eye(c + 1, dtype=np.float32)[np.maximum(labels, 0)][..., 1:]
    box = (rng.randn(b, a, 7) * 0.5).astype(np.float32)
    tgt = (rng.randn(b, a, 7) * 0.5).astype(np.float32)
    return logits, onehot, weights, box, tgt


@pytest.mark.parametrize("case", ["c", "c_no_weights", "r", "r_code_weights"])
def test_ghm_losses_match_jax(case):
    logits, onehot, weights, box, tgt = _ghm_inputs()
    w = None if case == "c_no_weights" else weights
    if case.startswith("c"):
        pred, target = logits, onehot
        jfn = lambda p, t, w: jlosses.ghm_c_loss(p, t, w, bins=10)  # noqa
        tfn = lambda p, t, w: tlosses.ghm_c_loss(p, t, w, bins=10)  # noqa
    else:
        pred, target = box, tgt
        cw = [1, 1, 1, 2, 2, 2, 0.5] if case == "r_code_weights" else None
        jfn = lambda p, t, w: jlosses.ghm_r_loss(  # noqa: E731
            p, t, w, mu=0.02, bins=10, code_weights=cw)
        tfn = lambda p, t, w: tlosses.ghm_r_loss(  # noqa: E731
            p, t, w, mu=0.02, bins=10, code_weights=cw)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    ref = np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target), jw))
    ref_grad = np.asarray(jax.grad(lambda p: jfn(
        p, jnp.asarray(target), jw).sum())(jnp.asarray(pred)))
    x = torch.from_numpy(pred).requires_grad_(True)
    out = tfn(x, torch.from_numpy(target), tw)
    (grad,) = torch.autograd.grad(out.sum(), x)
    assert ref.sum() > 0 and np.abs(ref_grad).max() > 0
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-5, rtol=1e-5)


# ------------------------------------------------ what is still unported

@pytest.mark.parametrize("what", ["mixed_precision", "multi_head",
                                  "use_norm"])
def test_still_unported_raise_naming_the_roadmap(what):
    """Mixed precision builds in bf16, and what stays outside the port of
    it, a sparse middle's bf16 train step, raises NotImplementedError
    pointing at ROADMAP.md. The multi-head network and use_norm=False
    are ported now: the network builds from its 10-class config and
    refuses any other class count (ValueError), and use_norm=False
    builds biased layers without norms. None falls back."""
    from second_tpu_torch.builders.network_builder import build_network
    from second_tpu_torch.configs import (
        load_pipeline_config,
        loads_pipeline_config,
    )
    from second_tpu_torch.train import optimizer as topt
    from second_tpu_torch.train.state import make_train_step

    from test_torch_slice import SMALL_FHD_CONFIG

    cfg = loads_pipeline_config(SMALL_FHD_CONFIG)
    if what == "use_norm":
        net = tvoxelnet.VoxelNet(output_shape=(1, 40, 64, 64, 16),
                                 middle_num_input_features=4,
                                 rpn_num_input_features=128, use_norm=False)
        names = [n for n, _ in net.named_parameters()]
        assert "middle_feature_extractor.subm0_b" in names
        assert "rpn.layers.0.conv.bias" in names
        assert not any(".bn" in n or n.startswith("bn") for n in names)
        return
    if what == "multi_head":
        parts = build_network(load_pipeline_config(
            "configs/nuscenes/all.pp.mhead.config"), "cpu")
        assert type(parts["net"]).__name__ == "VoxelNetNuscenesMultiHead"
        cfg.model.second.network_class_name = "VoxelNetNuscenesMultiHead"
        with pytest.raises(ValueError, match="10 classes"):
            build_network(cfg, "cpu")
        return
    cfg.train_config.enable_mixed_precision = True
    parts = build_network(cfg, "cpu")
    assert parts["net"].compute_dtype == torch.bfloat16
    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer, 10,
                                    list(parts["net"].parameters()))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(parts["net"], parts["spec"], opt, lr_fn, mom_fn)