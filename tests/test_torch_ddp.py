"""Data-parallel training of the port (``second_tpu_torch.parallel``) on
the CPU: gloo ranks spawned by ``parallel.run_ranks`` against the JAX
package's sharded step and against one process.

- The 2-rank step on 2 distinct examples (small car.fhd on the host
  plan, small PointPillars on shipped points) against JAX's
  ``make_train_step(mesh=make_mesh(jax.devices()[:2]))``: the loss and
  metrics at ``test_torch_train``'s tolerances (1e-5, counts exactly),
  every gradient within 1e-4 of its largest magnitude (or, where fp32
  does not resolve it, within twice JAX's distance of the ranks' float64
  gradient), the running statistics after the step within 1e-5; both
  ranks' gradients and states bitwise equal. The negative control, each
  rank alone on its shard with its gradients averaged by hand, misses
  those tolerances on the batch norms.
- A world-1 group's step is bitwise the step without a group.
- ``MaskedBatchNorm`` (masked and unmasked, at 2 and 3 ranks, float64)
  and the GHM-C/GHM-R histograms (2 ranks) against one process on the
  whole batch (JAX's losses for GHM).
- ``train`` over 2 ranks and a resume, ``train`` over 2 ranks launched
  by ``torchrun``, ``evaluate`` over 2 ranks against one process, the
  loader's shards, and the dry run.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.builders import network_builder as jnb
from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.ops import losses as jlosses
from second_tpu.parallel import make_mesh as jax_make_mesh
from second_tpu.parallel import put_sharded as jax_put_sharded
from second_tpu.train import optimizer as jopt
from second_tpu.train.__main__ import example_convert as jconvert
from second_tpu.train.state import TrainState as JaxTrainState
from second_tpu.train.state import make_train_step as jmake_train_step
from second_tpu.train.state import make_voxelizer_fn as jmake_voxelizer

from second_tpu_torch.builders import network_builder as tnb
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import example_convert
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.data.kitti_dataset import create_kitti_info_file
from second_tpu_torch.data.loader import DataLoader
from second_tpu_torch.parallel import dryrun, mesh
from second_tpu_torch.tools.kitti_fixture import build_kitti_dir
from second_tpu_torch.train.__main__ import evaluate, train
from second_tpu_torch.utils.from_flax import from_flax

import test_torch_pp_train as pp
import test_torch_train as fhd
import torch_ddp_ranks
from test_torch_runtime import _tiny_config
from test_torch_slice import SMALL_FHD_CONFIG
from test_torch_pointpillars import SMALL_PP_CONFIG
from test_torch_zoo import _ghm_inputs

TIMEOUT = 300.0
REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts 6 workers on the cores);
    ``run_ranks`` pins its ranks to one thread too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------- the sharded step against JAX

def _fhd_case():
    cfg = tloads(SMALL_FHD_CONFIG)
    tparts = tnb.build_network(cfg, "cpu")
    jparts = jnb.build_network(jloads(SMALL_FHD_CONFIG), use_banded=False)
    tprep = build_prep_func(cfg.train_input_reader, tparts, training=True)
    np.random.seed(7)
    batch = merge_second_batch([tprep(input_dict=fhd.train_input(s))
                                for s in range(2)])
    variables = fhd.train_variables(
        jparts["net"], cfg.train_input_reader.preprocess.max_number_of_voxels)
    return (SMALL_FHD_CONFIG, cfg, jparts, batch, variables, None,
            fhd.UNRESOLVED_GRADS)


def _pp_case():
    cfg = tloads(SMALL_PP_CONFIG)
    tparts = tnb.build_network(cfg, "cpu")
    jparts = jnb.build_network(jloads(SMALL_PP_CONFIG), use_banded=False)
    batch = pp._point_batch(cfg, tparts, jparts)
    variables = pp.pp_train_variables(jparts["net"])
    return (SMALL_PP_CONFIG, cfg, jparts, batch, variables,
            jmake_voxelizer(jparts["voxel_generator"], pp.MAX_VOXELS),
            pp.UNRESOLVED_GRADS)


def _write_inputs(tmp_path, text, host, state):
    config = tmp_path / "model.config"
    config.write_text(text)
    with open(tmp_path / "batch.pkl", "wb") as f:
        pickle.dump(host, f)
    torch.save(state, tmp_path / "weights.pt")
    return str(config), str(tmp_path / "batch.pkl"), str(
        tmp_path / "weights.pt")


def _is_norm(name):
    return ".bn." in name or name.endswith(("bn.weight", "bn.bias"))


@pytest.mark.parametrize("model", ["fhd", "pp"])
def test_sharded_step_matches_jax(model, tmp_path):
    text, cfg, jparts, batch, variables, jvox, unresolved_ok = (
        _fhd_case() if model == "fhd" else _pp_case())
    host = example_convert(batch)
    assert (batch["labels"] if "labels" in batch
            else batch["pos_count"]).sum() > 0
    jnet, jspec = jparts["net"], jparts["spec"]
    tx, _, _ = jopt.build(cfg.train_config.optimizer, cfg.train_config.steps)
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jmesh = jax_make_mesh(jax.devices()[:2])
    jstep = jmake_train_step(jnet, jspec, tx, mesh=jmesh, voxelizer=jvox)
    jex = jax_put_sharded({k: jnp.asarray(v) for k, v in jconvert(
        batch).items()}, jmesh)
    state = from_flax(variables)
    ref_grads = from_flax({"params": jax.jit(jax.grad(
        lambda p: _jax_loss(jnet, jspec, jvox, jstate, p, jex)))(
            jstate.params)})
    jstate, jm = jstep(jstate, jex)
    ref_state = from_flax({"params": jstate.params,
                           "batch_stats": jstate.batch_stats})

    paths = _write_inputs(tmp_path, text, host, state)
    ranks = mesh.run_ranks(dryrun.step_rank, 2, args=(
        "cpu", "gloo", *paths, str(tmp_path / "out"), True),
        timeout=TIMEOUT)
    outs = [torch.load(r["path"], weights_only=False) for r in ranks]
    for key in ("grads", "grads64", "state"):
        for name, v in outs[0][key].items():
            assert torch.equal(v, outs[1][key][name]), (key, name)
    assert outs[0]["metrics"] == outs[1]["metrics"]
    m = outs[0]["metrics"]
    for key in ("loss", "cls_loss", "loc_loss", "cls_pos_loss",
                "cls_neg_loss", "dir_loss"):
        np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    for key in ("num_pos", "num_neg"):
        assert m[key] == int(jm[key]), key
    for key, v in jm["cls_stats"].items():
        np.testing.assert_array_equal(outs[0]["cls_stats"][key],
                                      np.asarray(v), err_msg=key)

    grads, grads64 = outs[0]["grads"], outs[0]["grads64"]
    assert sorted(grads) == sorted(ref_grads)
    unresolved = set()
    for name, g in grads.items():
        g, ref = g.numpy(), ref_grads[name].numpy()
        exact = grads64[name].numpy()
        own = np.abs(exact).max()
        ref_err = np.abs(ref - exact).max()
        if ref_err <= fhd.UNRESOLVED * own:
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f"grad {name}")
        else:
            unresolved.add(name)
            assert np.abs(g - exact).max() <= 2 * ref_err, name
    assert unresolved <= unresolved_ok, unresolved
    stats = [k for k in ref_state if k.endswith(("running_mean",
                                                 "running_var"))]
    assert stats
    for name in stats:
        np.testing.assert_allclose(outs[0]["state"][name].numpy(),
                                   ref_state[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)

    # the negative control: each rank alone on its shard, no group, the
    # gradients averaged by hand
    alone = []
    for r in range(2):
        parts = tnb.build_network(cfg, "cpu")
        parts["net"].load_state_dict(state)
        shard = {k: torch.from_numpy(v[r:r + 1]) for k, v in host.items()}
        alone.append(dryrun.step_outputs(
            parts["net"], parts["spec"], cfg, shard,
            dryrun._voxelizer(cfg, parts, shard)))
    missed = [name for name in grads if _is_norm(name) and np.abs(
        (alone[0]["grads"][name] + alone[1]["grads"][name]).numpy() / 2
        - ref_grads[name].numpy()).max()
        > 1e-4 * np.abs(ref_grads[name].numpy()).max()]
    assert len(missed) > len([n for n in grads if _is_norm(n)]) // 2, missed


def _jax_loss(jnet, jspec, jvox, jstate, params, jex):
    from second_tpu.models.voxelnet import compute_loss
    from second_tpu.train.state import _expand_targets, _network_inputs

    ex = _expand_targets(jex, jspec.box_code_size)
    plan = {k: v for k, v in ex.items() if k.startswith("plan_")}
    voxels, num_points, coords = _network_inputs(ex, jvox)
    preds, _ = jnet.apply(
        {"params": params, "batch_stats": jstate.batch_stats},
        voxels, num_points, coords, train=True, sparse_plan=plan or None,
        mutable=["batch_stats"])
    return compute_loss(jspec, preds, ex)["loss"]


def test_world1_group_step_is_bitwise_the_ungrouped_step(tmp_path):
    cfg = tloads(SMALL_PP_CONFIG)
    parts = tnb.build_network(cfg, "cpu")
    jparts = jnb.build_network(jloads(SMALL_PP_CONFIG), use_banded=False)
    batch = pp._point_batch(cfg, parts, jparts)
    host = example_convert(batch)
    state = from_flax(pp.pp_train_variables(jparts["net"]))
    paths = _write_inputs(tmp_path, SMALL_PP_CONFIG, host, state)
    (rank,) = mesh.run_ranks(dryrun.step_rank, 1, args=(
        "cpu", "gloo", *paths, str(tmp_path / "out")), timeout=TIMEOUT)
    grouped = torch.load(rank["path"], weights_only=False)
    parts["net"].load_state_dict(state)
    example = {k: torch.from_numpy(v) for k, v in host.items()}
    alone = dryrun.step_outputs(parts["net"], parts["spec"], cfg, example,
                                dryrun._voxelizer(cfg, parts, example))
    assert grouped["metrics"] == alone["metrics"]
    for name, g in alone["grads"].items():
        assert torch.equal(g, grouped["grads"][name]), name
    for name, v in parts["net"].state_dict().items():
        assert torch.equal(v, grouped["state"][name]), name


# ------------------------------------------------ the collectives alone

@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("masked", [True, False])
def test_masked_batch_norm_sync_matches_one_process(world, masked):
    """The ranks' rows through the synced norm against one process's norm
    over the concatenated rows (float64): the output and the input
    gradient of each rank's rows, the sum of the ranks' scale and bias
    gradients (each rank's loss is its rows' share of the total), the
    running statistics on every rank."""
    rng = np.random.RandomState(world + 10 * masked)
    c = 3
    if masked:  # [B, V, C] voxels, each rank a different active count
        x = rng.normal(1.0, 2.0, (2 * world, 7, c))
        mask = rng.uniform(size=(2 * world, 7)) < np.linspace(
            0.2, 0.9, 2 * world)[:, None]
        channel_dim = -1
    else:  # [B, C, H, W] maps
        x = rng.normal(1.0, 2.0, (world, c, 4, 5))
        mask = None
        channel_dim = 1
    g = rng.normal(size=x.shape)
    weight, bias = rng.uniform(0.5, 1.5, c), rng.normal(size=c)
    ref = torch_ddp_ranks.norm_outputs(x, mask, g, weight, bias, channel_dim)
    outs = mesh.run_ranks(torch_ddp_ranks.norm_rank, world, args=(
        x, mask, g, weight, bias, channel_dim), timeout=TIMEOUT)
    for key in ("y", "x"):
        np.testing.assert_allclose(np.concatenate([o[key] for o in outs]),
                                   ref[key], rtol=1e-10, atol=1e-10,
                                   err_msg=key)
    for key in ("weight", "bias"):
        np.testing.assert_allclose(sum(o[key] for o in outs), ref[key],
                                   rtol=1e-10, atol=1e-10, err_msg=key)
    for o in outs:
        for key in ("running_mean", "running_var"):
            np.testing.assert_array_equal(o[key], outs[0][key])
            np.testing.assert_allclose(o[key], ref[key], rtol=1e-12,
                                       err_msg=key)
    # unsynced, a rank's statistics are its own rows'
    rows = slice(0, len(x) // world)
    alone = torch_ddp_ranks.norm_outputs(
        x[rows], None if mask is None else mask[rows], g[rows], weight,
        bias, channel_dim)
    assert np.abs(alone["running_var"] - ref["running_var"]).max() > 1e-3


@pytest.mark.parametrize("kind", ["c", "r"])
def test_ghm_histograms_over_two_ranks_match_jax(kind):
    logits, onehot, weights, box, tgt = _ghm_inputs(b=4)
    preds, targets = (logits, onehot) if kind == "c" else (box, tgt)
    jfn = (jlosses.ghm_c_loss if kind == "c" else
           lambda p, t, w, bins: jlosses.ghm_r_loss(p, t, w, mu=0.02,
                                                    bins=bins))
    ref = np.asarray(jfn(jnp.asarray(preds), jnp.asarray(targets),
                         jnp.asarray(weights), bins=10))
    outs = mesh.run_ranks(torch_ddp_ranks.ghm_rank, 2, args=(
        kind, preds, targets, weights), timeout=TIMEOUT)
    got = np.concatenate(outs)
    assert ref.sum() > 0
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # the histogram of one rank's half alone weighs differently
    half =np.asarray(jfn(jnp.asarray(preds[:2]), jnp.asarray(targets[:2]),
                          jnp.asarray(weights[:2]), bins=10))
    assert np.abs(half - ref[:2]).max() > 1e-3 * np.abs(ref).max()


# ------------------------------------------- the entry points and loader

def test_loader_shards_cover_each_global_batch_in_order():
    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"x": np.full(1, i)}

    def batches(rank, world):
        loader = DataLoader(Items(), 4, shuffle=True, num_workers=1,
                            seed=5, rank=rank, world_size=world)
        return [b["x"][:, 0].tolist() for b in loader]

    whole = batches(0, 1)
    assert len(whole) == 2 and all(len(b) == 4 for b in whole)
    shards = [batches(r, 2) for r in range(2)]
    assert [len(s) for s in shards] == [2, 2]
    for i, b in enumerate(whole):
        assert shards[0][i] + shards[1][i] == b
        assert not set(shards[0][i]) & set(shards[1][i])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp") / "kitti"
    ids = build_kitti_dir(root, num_frames=4, seed=0)
    create_kitti_info_file(str(root), train_img_ids=ids, val_img_ids=ids)
    return root


def test_train_over_two_ranks_then_resume(tree, tmp_path):
    config = _tiny_config(tree, tmp_path / "pp.config", steps=3)
    resume = _tiny_config(tree, tmp_path / "pp4.config", steps=4)
    model_dir = tmp_path / "model"
    calls = [("train", dict(config_path=str(config),
                            model_dir=str(model_dir), display_step=1)),
             ("train", dict(config_path=str(resume),
                            model_dir=str(model_dir), display_step=1,
                            resume=True))]
    outs = mesh.run_ranks(dryrun.entry_rank, 2, args=(
        "cpu", "gloo", calls), timeout=TIMEOUT)
    assert len(outs) == 2
    # one log, one set of checkpoints: rank 0 alone writes
    records = [json.loads(line) for line in
               (model_dir / "log.json.lst").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(np.isfinite(r["runtime.loss"]) for r in records)
    log = (model_dir / "log.txt").read_text()
    assert log.count("second_tpu_torch train:") == 2
    assert log.count("ranks=2") == 2 and log.count("batch=2") == 2
    assert log.count("Evaluation official") == 2
    info = json.loads((model_dir / "checkpoints.json").read_text())
    assert info["all_ckpts"]["voxelnet"] == ["voxelnet-3.ckpt",
                                             "voxelnet-4.ckpt"]
    assert sorted(p.name for p in model_dir.iterdir()) == sorted([
        "checkpoints.json", "log.json.lst", "log.txt", "pipeline.config",
        "results", "voxelnet-3.ckpt", "voxelnet-4.ckpt"])


def test_torchrun_train_over_two_ranks(tree, tmp_path):
    """The documented launch: ``torchrun`` (its standalone rendezvous on
    a free loopback port) starts two ranks of ``python -m
    second_tpu_torch.train train``, which join the group from
    ``RANK``/``WORLD_SIZE``/``MASTER_*`` (env://) and leave it at
    exit."""
    config = _tiny_config(tree, tmp_path / "pp.config", steps=3)
    model_dir = tmp_path / "model"
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "second_tpu_torch.train", "train",
         f"--config_path={config}", f"--model_dir={model_dir}",
         "--device=cpu", "--display_step=1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    records = [json.loads(line) for line in
               (model_dir / "log.json.lst").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["runtime.loss"]) for r in records)
    log = (model_dir / "log.txt").read_text()
    assert log.count("second_tpu_torch train:") == 1
    assert log.count("ranks=2") == 1 and log.count("batch=2") == 1
    assert log.count("Evaluation official") == 1
    info = json.loads((model_dir / "checkpoints.json").read_text())
    assert info["all_ckpts"]["voxelnet"] == ["voxelnet-3.ckpt"]
    assert sorted(p.name for p in model_dir.iterdir()) == sorted([
        "checkpoints.json", "log.json.lst", "log.txt", "pipeline.config",
        "results", "voxelnet-3.ckpt"])


def test_evaluate_over_two_ranks_equals_one_process(tree, tmp_path):
    config = _tiny_config(tree, tmp_path / "pp.config", steps=2)
    model_dir = tmp_path / "model"
    train(str(config), str(model_dir), device="cpu")
    single = evaluate(str(config), str(model_dir),
                      result_path=str(tmp_path / "one"), device="cpu")
    outs = mesh.run_ranks(dryrun.entry_rank, 2, args=("cpu", "gloo", [(
        "evaluate", dict(config_path=str(config), model_dir=str(model_dir),
                         result_path=str(tmp_path / "two")))]),
        timeout=TIMEOUT)
    assert outs[1][0]["result"] is None
    sharded = outs[0][0]["result"]
    assert sharded["results"] == single["results"]
    dets = [pickle.loads((tmp_path / d / "result.pkl").read_bytes())
            for d in ("one", "two")]
    assert len(dets[0]) == len(dets[1]) == 4
    for a, b in zip(*dets):
        np.testing.assert_equal(a["metadata"], b["metadata"])
        for key in dryrun.DET_KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-4,
                                       err_msg=key)


def test_dryrun_multichip_two_ranks():
    out = dryrun.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    assert np.isfinite(out["loss"]) and out["num_det"] > 0
    assert out["launches"]["greedy_nms"] == 0  # the CPU runs plain versions
