"""Train state, the train step and the eval step (twin of
``second_tpu/train/state.py``)."""

import dataclasses

import torch
from torch import nn

from ..models.pp_fast import pointpillars_infer
from ..models.sparse_middle import SparseMiddleBase
from ..models.voxelnet import compute_loss, predict
from ..ops.voxelize import voxelize
from ..parallel import mesh
from ..utils.metrics import classification_metrics
from .optimizer import AdamW


def make_voxelizer_fn(voxel_generator, max_voxels):
    """The device voxelizer of point-shipping examples: maps a padded
    point batch ("points" [B, N, F] + "points_count" [B, 1]) to
    (voxels [B, V, T, F], num_points [B, V], coordinates [B, V, 3]),
    frame by frame through ``ops.voxelize.voxelize`` (the twin of the
    host C++ voxelizer), with no host sync. The generator's
    ``full_empty_part_with_mean`` (its ``_full_mean``) fills each
    voxel's empty slots with its mean, as the host voxelizer does; the
    JAX package's function reads a ``full_mean`` attribute the generator
    does not have, and never fills them (``ROADMAP.md`` section 3)."""
    full_mean = bool(voxel_generator._full_mean)
    voxel_size = tuple(float(v) for v in voxel_generator.voxel_size)
    range_min = tuple(
        float(v) for v in voxel_generator.point_cloud_range[:3])
    grid = tuple(int(v) for v in voxel_generator.grid_size)
    t = int(voxel_generator.max_num_points_per_voxel)

    def fn(points, points_count):
        frames = [voxelize(p, c[0], voxel_size, range_min, grid,
                           int(max_voxels), t, full_mean)
                  for p, c in zip(points, points_count)]
        voxels, coords, counts, _ = zip(*frames)
        return torch.stack(voxels), torch.stack(counts), torch.stack(coords)

    return fn


def _network_inputs(example, voxelizer):
    if "points" in example:
        assert voxelizer is not None, (
            "example ships raw points; build the step with "
            "voxelizer=make_voxelizer_fn(...)")
        return voxelizer(example["points"], example["points_count"])
    return (example["voxels"], example["num_points"],
            example["coordinates"])


def _expand_targets(example, code_size):
    """Dense labels [B, A] and reg_targets [B, A, code] from the compact
    form (int8 labels and the positive anchors' rows,
    ``data/preprocess.py`` compact_targets), on the device. Padding rows
    of ``pos_idx`` hold A and land in a dump row that is cut off."""
    if "labels_i8" not in example:
        return example
    ex = dict(example)
    labels = ex.pop("labels_i8").long()
    pos_idx = ex.pop("pos_idx").long()
    pos_tgt = ex.pop("pos_targets")
    ex.pop("pos_count")
    b, a = labels.shape
    reg = pos_tgt.new_zeros(b, a + 1, code_size)
    reg.scatter_(1, pos_idx[..., None].expand(-1, -1, code_size), pos_tgt)
    ex["labels"] = labels
    ex["reg_targets"] = reg[:, :a]
    return ex


@dataclasses.dataclass
class TrainState:
    """The network's parameters and buffers (batch-norm statistics), the
    optimizer's state and the number of steps taken."""

    net: nn.Module
    optimizer: AdamW
    global_step: int = 0


def plan_of(example):
    """The example's host plan, or None where it ships none (the JAX
    package's ``plan or None``): a sparse middle then builds its
    rulebooks on the device."""
    return {k: v for k, v in example.items() if k.startswith("plan_")} or None


def forward_loss(net, spec, example, voxelizer=None):
    """The network in training mode (its batch statistics move) and
    ``compute_loss`` on a device batch (see :func:`make_train_step`):
    voxels, or points voxelized on the device by ``voxelizer``; dense
    or compact targets. A sparse middle without a host plan adds its
    stages' counts [B, S, 2] as "sparse_active_counts"."""
    example = _expand_targets(example, spec.box_code_size)
    voxels, num_points, coords = _network_inputs(example, voxelizer)
    net.train()
    inter = {}
    preds = net(voxels, num_points, coords, plan_of(example), inter)
    res = compute_loss(spec, preds, example)
    res.update(inter)
    return res


def refuse_bf16_sparse_training(net):
    """Raise ``NotImplementedError`` for a VoxelNet in bf16 with a sparse
    middle: the JAX package cannot train one (the bf16 gradient of its
    dense tail raises TypeError), so the port has no reference for it."""
    if net.compute_dtype is not None and isinstance(
            net.middle_feature_extractor, SparseMiddleBase):
        raise NotImplementedError(
            "training a sparse middle in bf16 is outside the port: the JAX "
            "package's own bf16 step raises TypeError in the dense tail's "
            "gradient (second_tpu/models/sparse_middle.py:656-660), so it "
            "has no reference; see ROADMAP.md section 3. Train in f32; "
            "inference runs in bf16.")


def make_train_step(net, spec, optimizer, lr_fn, mom_fn, voxelizer=None):
    """Returns ``step(example) -> metrics``; ``step.state`` is the
    :class:`TrainState` it updates.

    example: dict of tensors on the network's device: voxels
    [B, V, T, F], num_points [B, V], coordinates [B, V, 3] sorted by
    linear id and the host plan's ``plan_*`` rulebooks (or "points"
    [B, N, F] + "points_count" [B, 1] when built with a ``voxelizer``),
    anchors [B, A, 7], labels [B, A] and reg_targets [B, A, code] (or
    their compact form: labels_i8, pos_idx, pos_targets, pos_count) and
    optional importance [B, A]. Each call runs the network in training
    mode (batch statistics), the loss and its backward (K1 and K2 in the
    sparse middle), clips the global gradient norm to 10 and steps the
    optimizer at ``lr_fn`` / ``mom_fn`` of its update count, as optax's
    ``inject_hyperparams`` does (the first step uses ``lr_fn(0)``). No
    host sync. A sparse middle on an example without ``plan_*`` keys
    builds its rulebooks on the device; its stages' counts [B, S, 2]
    (true active, capacity) are then in the metrics as
    "sparse_active_counts", on the device.

    A network in bf16 (``compute_dtype``) trains where its middle is
    dense (PointPillars): parameters, gradients and the optimizer's
    state stay f32. With a sparse middle it raises before any step, as
    the JAX package's bf16 sparse training does.

    Under a process group (``parallel.make_mesh``) each rank steps on
    its shard of the global batch and the step computes what JAX's
    sharded step computes: the batch norms' and GHM losses' statistics
    are the global batch's, the gradients are averaged over the ranks
    (:func:`loss_and_global_grads`) before the clip sees them, and the
    metrics are the global batch's (:func:`_global_metrics`); the ranks'
    parameters and batch statistics stay equal, with no broadcast. The
    step is not wrapped in ``DistributedDataParallel``: its reducer
    fires on ``.backward()``, and this step takes ``torch.autograd.grad``
    (no ``.grad`` fields), so it all-reduces the gradients itself. At
    world size 1 no collective runs.
    """
    refuse_bf16_sparse_training(net)
    state = TrainState(net, optimizer)
    params = optimizer.params

    def step(example):
        example = _expand_targets(example, spec.box_code_size)
        res, grads = loss_and_global_grads(net, spec, example, params,
                                           voxelizer)
        count = optimizer.count
        lr, b1 = lr_fn(count), mom_fn(count)
        grad_norm = optimizer.step(list(grads), lr, b1)
        state.global_step += 1
        labels = example["labels"]
        metrics = {
            "loss": res["loss"].detach(),
            "cls_loss": res["cls_loss_reduced"].detach(),
            "loc_loss": res["loc_loss_reduced"].detach(),
            "cls_pos_loss": res["cls_pos_loss"].detach(),
            "cls_neg_loss": res["cls_neg_loss"].detach(),
            "num_pos": (labels > 0).sum(),
            "num_neg": (labels == 0).sum(),
            "lr": lr,
            "grad_norm": grad_norm,
        }
        if "dir_loss_reduced" in res:
            metrics["dir_loss"] = res["dir_loss_reduced"].detach()
        if "sparse_active_counts" in res:
            metrics["sparse_active_counts"] = res["sparse_active_counts"]
        with torch.no_grad():
            metrics["cls_stats"] = classification_metrics(
                res["cls_preds"], labels,
                encode_background_as_zeros=spec.encode_background_as_zeros)
        return _global_metrics(metrics)

    step.state = state
    return step


def loss_and_global_grads(net, spec, example, params, voxelizer=None):
    """``forward_loss`` on this rank's examples and the gradients of its
    loss with respect to ``params``, averaged over the process group's
    ranks (the gradients themselves without a group). With the batch
    norms' and GHM losses' statistics summed over the ranks in both
    directions, the mean of the ranks' gradients is the gradient of the
    global batch's loss: every normaliser of the loss is per example."""
    res = forward_loss(net, spec, example, voxelizer)
    grads = torch.autograd.grad(res["loss"], params)
    return res, mesh.all_reduce_grads(grads)


# the step's metrics that are means over the batch, and those that count
_MEAN_METRICS = ("loss", "cls_loss", "loc_loss", "cls_pos_loss",
                 "cls_neg_loss", "dir_loss")
_SUM_METRICS = ("num_pos", "num_neg")


def _global_metrics(metrics):
    """The step's metrics over the global batch, as JAX's sharded step
    reports them: the loss terms averaged over the ranks, the counts and
    ``cls_stats`` summed (one all-reduce in float64, exact for counts),
    the sparse stages' counts gathered in rank order. All on the device:
    no host sync. ``metrics`` itself without a group."""
    w = mesh.world()
    if w == 1:
        return metrics
    out = dict(metrics)
    stats = dict(metrics["cls_stats"])
    keys = [k for k in _MEAN_METRICS + _SUM_METRICS if k in metrics]
    flat = [metrics[k].reshape(-1) for k in keys] + [
        v.reshape(-1) for v in stats.values()]
    sums = mesh.all_reduce_sum(torch.cat([t.double() for t in flat]))
    pieces = sums.split([t.numel() for t in flat])
    for k, total in zip(keys, pieces):
        total = total / w if k in _MEAN_METRICS else total
        out[k] = total.reshape(metrics[k].shape).to(metrics[k].dtype)
    for (k, v), total in zip(stats.items(), pieces[len(keys):]):
        stats[k] = total.reshape(v.shape).to(v.dtype)
    out["cls_stats"] = stats
    if "sparse_active_counts" in metrics:
        out["sparse_active_counts"] = mesh.all_gather_cat(
            metrics["sparse_active_counts"])
    return out


def make_eval_step(net, spec, voxelizer=None, flat_pp=None):
    """Returns ``step(example) -> predict``'s fixed-size detections, with
    the network in eval mode.

    flat_pp: optional dict(gen=..., max_voxels=...): PillarFeatureNet
    networks on point-shipping examples run the flat pillar path
    (``models.pp_fast.pointpillars_infer``: no [V, T, F] buffer); every
    other example runs the network's modules, on the voxels it ships or
    on those ``voxelizer`` makes of its points (a sparse middle builds
    its rulebooks on the device where the example ships no plan).
    """

    @torch.no_grad()
    def step(example):
        net.eval()
        if flat_pp is not None and "points" in example:
            return pointpillars_infer(net, spec, example, gen=flat_pp["gen"],
                                      max_voxels=flat_pp["max_voxels"])[1]
        voxels, num_points, coords = _network_inputs(example, voxelizer)
        return predict(spec, net(voxels, num_points, coords, plan_of(example)),
                       example)

    return step
