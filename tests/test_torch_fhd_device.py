"""car.fhd on the device route (points in, voxels and rulebooks built on
the device) against the JAX package's plan-less route on the CPU.

Both packages read the small car.fhd-shaped config of
``test_torch_slice`` (SpMiddleFHD at a [41, 64, 64] grid); examples ship
the in-range points (``POINTS_BUFFER`` rows) and no ``plan_*`` keys, and
each step voxelizes with its package's ``make_voxelizer_fn``. The
port's kernels run as their plain PyTorch versions here.

* The train reader's examples equal the JAX package's exactly (points,
  compact targets), and carry no plan.
* One training step from the same flax variables (``from_flax``) and
  the JAX package's ``make_train_step(..., voxelizer=...)``: the loss
  and metrics within 1e-5 (fp32 sums in another order), the counts
  exact, every gradient within 1e-4 of its largest magnitude where fp32
  resolves it (the rule of ``test_torch_train``); the stages' counts in
  the step's metrics equal the host planner's on the same frames.
* ``InferenceContext.build(..., device_voxelize=True)`` against the JAX
  package's ``make_eval_step`` with its voxelizer on the same example:
  preds 1e-4, detections 1e-4 on boxes and scores, exact on counts and
  labels; the port's host-voxel route on the same frame within 1e-5.
* ``InferenceContext.build(...)`` on host voxels: the example ships no
  plan, its voxels are the host-planned prep's (sorted by linear id)
  element by element, and the rulebooks built on the device give
  bitwise the preds and detections of the network on
  ``build_host_plan``'s rulebooks.
* With the GT-database sampler: the first sampled loss within 1e-4
  (relative) of the JAX package's on the same frames, then ``train``
  (``device_voxelize=True``) for 2 steps and 1 resumed step of car.fhd's
  published config clipped to [41, 512, 512], and ``evaluate``.
"""

import copy
import json

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
from second_tpu.train.__main__ import example_convert
from second_tpu.train.state import TrainState as JaxTrainState
from second_tpu.train.state import _expand_targets as jexpand
from second_tpu.train.state import make_eval_step as jmake_eval_step
from second_tpu.train.state import make_train_step as jmake_train_step
from second_tpu.train.state import make_voxelizer_fn as jmake_voxelizer_fn

from second_tpu_torch.builders import network_builder as tnb
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.builders.route import make_route
from second_tpu_torch.data.kitti_dataset import KittiDataset
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import InferenceContext, example_to_device
from second_tpu_torch.data import kitti_dataset as tkd
from second_tpu_torch.data import gt_database as tgt
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.data.preprocess import sort_by_linear_id
from second_tpu_torch.models import voxelnet as tvoxelnet
from second_tpu_torch.tools import kitti_fixture as tfixture
from second_tpu_torch.train import optimizer as topt
from second_tpu_torch.train.__main__ import evaluate, train
from second_tpu_torch.train.state import forward_loss, make_train_step
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_fhd_train import (  # noqa: F401 - trees is a fixture
    SCENE,
    _fhd_config,
    _inputs,
    _preps,
    _train_config,
    trees,
)
from test_torch_slice import (
    SMALL_FHD_CONFIG,
    random_variables,
    small_fhd_points,
)
from test_torch_train import (
    UNRESOLVED,
    UNRESOLVED_GRADS,
    train_input,
    train_variables,
)

# the rows a KITTI frame's point buffer holds (the dataset's capacity)
POINTS_BUFFER = KittiDataset.PointsCapacity

METRICS = ("loss", "cls_loss", "loc_loss", "cls_pos_loss", "cls_neg_loss",
           "dir_loss")


@pytest.fixture(scope="module")
def setup():
    cfg = tloads(SMALL_FHD_CONFIG)
    tparts = tnb.build_network(cfg, "cpu")
    jparts = jnb.build_network(jloads(SMALL_FHD_CONFIG), use_banded=False)
    route = make_route(tparts, cfg.train_input_reader, "train", True)
    tprep = build_prep_func(cfg.train_input_reader, tparts, training=True,
                            route=route)
    assert tprep.keywords["emit_points"] == POINTS_BUFFER
    assert tprep.keywords["compact_targets"]
    jkw = dict(tprep.keywords)
    jkw.update(root_path="", voxel_generator=jparts["voxel_generator"],
               target_assigner=jparts["target_assigner"],
               anchor_cache=jparts["anchor_cache"])
    host_prep = build_prep_func(cfg.train_input_reader, tparts, training=True)
    return cfg, tparts, jparts, tprep, jkw, host_prep, route


def _port_grads(net, spec, example, route):
    """The loss's gradients of a copy of ``net`` (a forward in training
    mode moves the batch statistics)."""
    net = copy.deepcopy(net)
    loss = forward_loss(net, spec, example, route)["loss"]
    names, params = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def _batch(prep, **kwargs):
    np.random.seed(7)
    return merge_second_batch([prep(input_dict=train_input(s), **kwargs)
                               for s in range(2)])


def test_device_route_prep_matches_jax(setup):
    cfg, _, _, tprep, jkw, _, _ = setup
    assert tprep.keywords["sparse_plan_scales"] is None
    tex, jex = _batch(tprep), _batch(jprep, **jkw)
    assert not any(k.startswith("plan_") for k in tex)
    assert "points" in tex and "voxels" not in tex
    # no anchor mask reads host voxels here: the port skips the host
    # voxelizer and ships no "num_voxels", the JAX package's count of them
    assert sorted(k for k in tex if k != "metrics") == sorted(
        k for k in jex if k not in ("metrics", "num_voxels"))
    for key in tex:
        if key not in ("metrics", "gt_names"):
            np.testing.assert_array_equal(
                tex[key], np.asarray(jex[key]).astype(tex[key].dtype),
                err_msg=key)
    assert int(tex["pos_count"].sum()) > 0


def test_train_step_device_route_matches_jax(setup):
    cfg, tparts, jparts, tprep, jkw, host_prep, route = setup
    cap = cfg.train_input_reader.preprocess.max_number_of_voxels
    assert route.max_voxels == cap
    batch = _batch(tprep)
    jnet, jspec = jparts["net"], jparts["spec"]
    variables = train_variables(jnet, cap)
    tx, _, _ = jopt.build(cfg.train_config.optimizer, cfg.train_config.steps)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                         variables), tx)
    jvox = jmake_voxelizer_fn(jparts["voxel_generator"], cap)
    jex = {k: jnp.asarray(v) for k, v in example_convert(batch).items()}

    @jax.jit
    def jgrads(state):
        ex = jexpand(jex, jspec.box_code_size)
        voxels, num_points, coords = jvox(ex["points"], ex["points_count"])

        def loss_fn(params):
            preds, _ = jnet.apply(
                {"params": params, "batch_stats": state.batch_stats},
                voxels, num_points, coords, train=True, sparse_plan=None,
                mutable=["batch_stats"])
            return jcompute_loss(jspec, preds, ex)["loss"]
        return jax.grad(loss_fn)(state.params)

    net, spec = tparts["net"], tparts["spec"]
    net.load_state_dict(from_flax(variables), strict=True)
    tex = example_to_device(batch, "cpu")
    tex64 = {k: v.double() if v.is_floating_point() else v
             for k, v in tex.items()}
    ref_grads = from_flax({"params": jgrads(jstate)})
    grads = _port_grads(net, spec, tex, route)
    grads64 = _port_grads(copy.deepcopy(net).double(), spec, tex64, route)
    unresolved = set()
    for name, g in grads.items():
        g, ref, exact = (g.numpy(), ref_grads[name].numpy(),
                         grads64[name].numpy())
        ref_err = np.abs(ref - exact).max()
        if ref_err <= UNRESOLVED * np.abs(exact).max():
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
        else:
            unresolved.add(name)
            assert np.abs(g - exact).max() <= 2 * ref_err, name
    assert unresolved <= UNRESOLVED_GRADS, unresolved

    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer,
                                    cfg.train_config.steps,
                                    list(net.parameters()))
    m = make_train_step(net, spec, opt, lr_fn, mom_fn, route=route)(tex)
    _, jm = jmake_train_step(jnet, jspec, tx, voxelizer=jvox)(jstate, jex)
    for key in METRICS:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    for key in ("num_pos", "num_neg"):
        assert int(m[key]) == int(jm[key]), key
    # the same frames through the host planner: the same stage counts
    host = _batch(host_prep)
    np.testing.assert_array_equal(m["sparse_active_counts"].numpy(),
                                  host["sparse_active_counts"])


def test_inference_context_device_route_matches_jax(setup):
    cfg = tloads(SMALL_FHD_CONFIG)
    jparts = setup[2]
    cap = cfg.eval_input_reader.preprocess.max_number_of_voxels
    variables = random_variables(jparts["net"], cap)
    ctx = InferenceContext()
    ctx.build(cfg, device="cpu", device_voxelize=True)
    ctx.load_flax_variables(variables)
    points = small_fhd_points()
    example = ctx.get_inference_input_dict({}, points)
    assert "points" in example and not any(
        k.startswith("plan_") for k in example)
    preds, _ = ctx.run(example)
    tdets = ctx.inference(example)[0]

    jkw = dict(ctx.prep_func.keywords)
    jkw.update(root_path="", voxel_generator=jparts["voxel_generator"],
               target_assigner=jparts["target_assigner"],
               anchor_cache=jparts["anchor_cache"])
    jex = jprep(input_dict={"lidar": {"type": "lidar", "points": points},
                            "metadata": {"image_idx": 0}}, **jkw)
    jex = {k: jnp.asarray(v) for k, v in example_convert(
        merge_second_batch([jex])).items()}
    assert not any(k.startswith("plan_") for k in jex)
    jstate = JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=(), global_step=jnp.zeros((), jnp.int32))
    jvox = jmake_voxelizer_fn(jparts["voxel_generator"], cap)
    jpreds = jax.jit(lambda state, ex: jparts["net"].apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        *jvox(ex["points"], ex["points_count"]), train=False))(jstate, jex)
    jdets = jax.tree_util.tree_map(np.asarray, jmake_eval_step(
        jparts["net"], jparts["spec"], voxelizer=jvox)(jstate, jex))
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(preds[key].numpy(), np.asarray(jpreds[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    valid = jdets["valid"][0]
    assert valid.sum() > 0, "the frame must produce detections"
    assert len(tdets["scores"]) == valid.sum()
    np.testing.assert_allclose(tdets["box3d_lidar"],
                               jdets["box3d_lidar"][0][valid], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tdets["scores"], jdets["scores"][0][valid],
                               atol=1e-4)
    np.testing.assert_array_equal(tdets["label_preds"],
                                  jdets["label_preds"][0][valid])

    # the port's host-voxel route on the same frame (sorted voxels, the
    # rulebooks built on the device)
    host = InferenceContext()
    host.build(cfg, device="cpu")
    host.load_flax_variables(variables)
    host_example = host.get_inference_input_dict({}, points)
    assert "voxels" in host_example and not any(
        k.startswith("plan_") for k in host_example)
    host_preds, _ = host.run(host_example)
    for key, value in preds.items():
        np.testing.assert_allclose(value.numpy(), host_preds[key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


def test_inference_context_host_voxels_match_host_plan(setup):
    """A request on host voxels ships them sorted by linear id and no
    plan; the device's rulebooks give bitwise what ``build_host_plan``'s
    give, the planner the loaders keep."""
    cfg = tloads(SMALL_FHD_CONFIG)
    cap = cfg.eval_input_reader.preprocess.max_number_of_voxels
    ctx = InferenceContext()
    ctx.build(cfg, device="cpu")
    ctx.load_flax_variables(random_variables(setup[2]["net"], cap))
    points = small_fhd_points()
    example = ctx.get_inference_input_dict({}, points)
    assert not any(k.startswith("plan_") for k in example)
    assert "sparse_active_counts" not in example

    planned_prep = build_prep_func(cfg.eval_input_reader, ctx.parts,
                                   training=False)
    assert planned_prep.keywords["sparse_plan_scales"] is not None
    planned = merge_second_batch([planned_prep(input_dict={
        "lidar": {"type": "lidar", "points": points},
        "metadata": {"image_idx": 0}})])
    assert any(k.startswith("plan_") for k in planned)
    n = int(example["num_voxels"][0, 0])
    assert n > 0 and (np.diff(example["coordinates"][0, :n, 0]) >= 0).all()
    for key in ("voxels", "num_points", "coordinates", "num_voxels",
                "anchors"):
        np.testing.assert_array_equal(example[key], planned[key],
                                      err_msg=key)

    preds, dets = ctx.run(example)
    net, spec = ctx.parts["net"], ctx.parts["spec"]
    ex = example_to_device(planned, "cpu")
    plan = {k: v for k, v in ex.items() if k.startswith("plan_")}
    with torch.no_grad():
        ref = net(ex["voxels"], ex["num_points"], ex["coordinates"], plan)
        ref_dets = tvoxelnet.predict(spec, ref, ex)
    assert sorted(preds) == sorted(ref)
    for key in ref:
        assert torch.equal(preds[key], ref[key]), key
    for key in ref_dets:
        assert torch.equal(dets[key], ref_dets[key]), key
    assert int(ref_dets["valid"].sum()) > 0, "the frame must detect"
    out = ctx.inference(example)[0]
    valid = ref_dets["valid"][0].numpy()
    np.testing.assert_array_equal(out["box3d_lidar"],
                                  ref_dets["box3d_lidar"][0].numpy()[valid])
    np.testing.assert_array_equal(out["scores"],
                                  ref_dets["scores"][0].numpy()[valid])


@pytest.mark.parametrize("padding", ["last", "anywhere"])
def test_sort_by_linear_id_is_the_stable_sort(padding):
    """The request's (and the loaders') sort gives the stable argsort of
    the linear ids, padding (the grid's size) last in row order."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        d, h, w = (int(x) for x in rng.integers(1, 40, 3))
        rows = int(rng.integers(1, 2000))
        n = min(int(rng.integers(0, rows + 1)), d * h * w)
        lin = rng.choice(d * h * w, n, replace=False)
        coords = np.full((rows, 3), -1, np.int32)
        coords[:n] = np.stack([lin // (h * w), lin // w % h, lin % w], 1)
        if padding == "anywhere":
            coords = coords[rng.permutation(rows)]
        example = {"voxels": rng.standard_normal((rows, 5, 4)),
                   "num_points": rng.integers(0, 6, rows),
                   "coordinates": coords}
        ref = {k: v.copy() for k, v in example.items()}
        keys = np.where(coords[:, 0] >= 0, (coords[:, 0].astype(np.int64)
                        * h + coords[:, 1]) * w + coords[:, 2], d * h * w)
        order = np.argsort(keys, kind="stable")
        out = sort_by_linear_id(example, (d, h, w))
        assert out is example["coordinates"]
        for key, value in ref.items():
            np.testing.assert_array_equal(example[key], value[order],
                                          err_msg=key)


def test_first_sampled_loss_device_route_matches_jax(trees):
    port, jroot = trees["port"], trees["jax"]
    cfg = _fhd_config(port)
    tparts, jparts, tprep, jkw = _preps(cfg, jroot, device_voxelize=True)
    assert jkw["sparse_plan_scales"] is None
    assert jkw["emit_points"] == POINTS_BUFFER and jkw["compact_targets"]
    inputs = _inputs(port)[:2]
    np.random.seed(7)
    batch = merge_second_batch([tprep(input_dict=copy.deepcopy(d))
                                for d in inputs])
    np.random.seed(7)
    jbatch = merge_second_batch([jprep(input_dict=copy.deepcopy(d), **jkw)
                                 for d in inputs])
    assert int(batch["pos_count"].sum()) > 0
    cap = cfg.train_input_reader.preprocess.max_number_of_voxels
    variables = random_variables(jparts["net"], cap, seed=3)
    tx, _, _ = jopt.build(cfg.train_config.optimizer, cfg.train_config.steps)
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jex = {k: jnp.asarray(v) for k, v in example_convert(jbatch).items()}
    _, jm = jmake_train_step(
        jparts["net"], jparts["spec"], tx,
        voxelizer=jmake_voxelizer_fn(jparts["voxel_generator"], cap))(
            jstate, jex)
    net = tparts["net"]
    net.load_state_dict(from_flax(variables), strict=True)
    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer,
                                    cfg.train_config.steps,
                                    list(net.parameters()))
    m = make_train_step(
        net, tparts["spec"], opt, lr_fn, mom_fn,
        route=make_route(tparts, cfg.train_input_reader, "train", True))(
            example_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert int(m["num_pos"]) == int(jm["num_pos"]) > 0


def test_train_resume_evaluate_device_route_on_cpu(tmp_path):
    """car.fhd through ``train(device_voxelize=True)`` with the sampler:
    2 steps, 1 more resumed, then ``evaluate(device_voxelize=True)``;
    the stages' utilisation comes from the step's device counts."""
    root = tmp_path / "kitti"
    ids = tfixture.build_kitti_dir(root, num_frames=2, seed=1,
                                   scene_kwargs=SCENE)
    tkd.create_kitti_info_file(str(root), ids, ids)
    tgt.create_groundtruth_database(
        "KittiDataset", str(root), str(root / "kitti_infos_train.pkl"))
    model_dir = tmp_path / "model"
    np.random.seed(0)
    train(_train_config(root, tmp_path / "fhd.config", 2), str(model_dir),
          display_step=1, device_voxelize=True, device="cpu")
    train(_train_config(root, tmp_path / "fhd3.config", 3), str(model_dir),
          resume=True, display_step=1, device_voxelize=True, device="cpu")
    records = [json.loads(line) for line in
               (model_dir / "log.json.lst").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    for r in records:
        assert np.isfinite(r["runtime.loss"])
        assert 0 < r["runtime.sparse_util_max"] <= 1.0
    text = (model_dir / "log.txt").read_text()
    assert text.count("Evaluation official") == 2
    assert "OVERFLOW" not in text
    res = evaluate(str(tmp_path / "fhd3.config"), str(model_dir),
                   result_path=str(tmp_path / "eval"), device_voxelize=True,
                   device="cpu")
    assert "3d   AP:" in res["results"]["official"]
    with pytest.raises(ValueError, match="device_voxelize"):
        evaluate(str(tmp_path / "fhd3.config"), str(model_dir),
                 device_voxelize="yes", device="cpu")
