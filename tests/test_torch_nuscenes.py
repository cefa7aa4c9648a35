"""The port's nuScenes dataset, its points capacity and the device
voxelizer's ``full_mean`` against the JAX package on the CPU, and the
multi-head PointPillars through ``train`` and ``evaluate`` on a
nuScenes-format fixture tree.

* ``data.nuscenes_dataset`` on fake infos built as
  ``tests/test_nuscenes.py`` builds them: ``get_sensor_data`` (the
  accumulated sweeps with their time lag, the annotations), the Velo
  variant's boxes, the D2..D8 / Velo variants, the ground truth and the
  kitti-style ``evaluation_kitti`` / ``evaluation`` fallback, all equal
  to the JAX package's; the devkit functions raise ``ImportError`` in
  both without the devkit.
* The GT database of fixture infos (``tools/nusc_fixture.py``) equals
  the JAX package's: the same db infos and object clouds.
* ``full_mean`` (fault 2, ROADMAP.md section 3): the JAX package's
  ``make_voxelizer_fn`` ignores the generator's
  ``full_empty_part_with_mean``; the port's fills as the host
  voxelizer and JAX's ``ops.voxelize(full_mean=True)`` do, exactly.
* The host voxelizer under the loader's threads: each concurrent call
  on one generator takes a workspace of its own (found in this slice:
  calls that shared one wrote each other's voxel ids).
* The points capacity (fault 3): a 10-sweep cloud of more than 32768
  in-range points reaches the port's pillars whole, without an overflow
  warning; the JAX package's request ships its first 32768 raw points.
* ``train`` 2 steps at batch 2 of the reduced mhead config of
  ``test_torch_mhead`` with the published sample groups, a resumed
  step, then ``evaluate``: checkpoints, ``result.pkl`` and the
  kitti-style official AP of the 10 classes.
"""

import pickle
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.core.inference import InferenceContext as JaxContext
from second_tpu.data import gt_database as jgt
from second_tpu.data.dataset import get_dataset_class as jget
from second_tpu.data.voxelizer import VoxelGenerator as JVoxelGenerator
from second_tpu.ops.voxelize import voxelize as jvoxelize
from second_tpu.train.state import make_voxelizer_fn as jmake_voxelizer

from second_tpu_torch import create_data
from second_tpu_torch.builders.dataset_builder import points_capacity
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.data import gt_database as tgt
from second_tpu_torch.data import nuscenes_dataset as tnd
from second_tpu_torch.data.dataset import get_dataset_class as tget
from second_tpu_torch.data.voxelizer import VoxelGenerator
from second_tpu_torch.models.multi_head import LARGE_CLASSES, SMALL_CLASSES
from second_tpu_torch.tools.nusc_fixture import build_nusc_dir
from second_tpu_torch.train.__main__ import evaluate, train
from second_tpu_torch.train.state import make_voxelizer_fn

from test_nuscenes import make_nusc_infos
from test_torch_mhead import R, reduced_text, small_tree

CLASSES = ["car", "pedestrian", "bus"]
VARIANTS = [f"NuScenesDatasetD{n}" for n in range(2, 9)] + [
    "NuScenesDatasetVelo", "NuScenesDatasetD8Velo", "NuScenesDatasetD2Velo"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: the tier-1 run puts
    6 workers on the cores, and torch's threads then oversubscribe them
    (6 concurrent copies of the train test took 180 s each with torch's
    default threads, 7 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_nusc")
    info_path = make_nusc_infos(root)
    return root, info_path


def _pair(fake, name="NuScenesDataset"):
    root, info_path = fake
    return (tget(name)(root_path=root, info_path=info_path,
                       class_names=CLASSES),
            jget(name)(root_path=root, info_path=info_path,
                       class_names=CLASSES))


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("name", ["NuScenesDataset", "NuScenesDatasetVelo"])
def test_sensor_data_matches_jax(fake, name):
    tds, jds = _pair(fake, name)
    assert len(tds) == len(jds) == 3
    for i in range(len(tds)):
        got, ref = tds.get_sensor_data(i), jds.get_sensor_data(i)
        _assert_tree_equal(got, ref)
        pts = got["lidar"]["points"]
        # key frame lag 0, the sweeps' lags positive
        assert pts.shape == (2000 + 2 * 500, 4)
        assert (pts[:2000, 3] == 0).all() and (pts[2000:, 3] > 0).all()
        width = 9 if name.endswith("Velo") else 7
        assert got["lidar"]["annotations"]["boxes"].shape == (4, width)


def test_variants_registered_as_in_jax():
    for name in VARIANTS:
        assert issubclass(tget(name), tnd.NuScenesDataset)
        jget(name)
        assert tget(name).PointsCapacity == tnd.NuScenesDataset.PointsCapacity


def test_kitti_style_evaluation_matches_jax(fake):
    tds, jds = _pair(fake)
    _assert_tree_equal(tds.ground_truth_annotations,
                       jds.ground_truth_annotations)
    dets = []
    for i in range(len(tds)):
        annos = tds.get_sensor_data(i)["lidar"]["annotations"]
        dets.append({
            "box3d_lidar": annos["boxes"] + 0.05,
            "scores": np.linspace(0.9, 0.5, len(annos["boxes"])),
            "label_preds": np.array([CLASSES.index(n)
                                     for n in annos["names"]]),
            "metadata": {"token": f"tok{i}"}})
    got, ref = tds.evaluation_kitti(dets, None), jds.evaluation_kitti(dets,
                                                                       None)
    assert got["results"] == ref["results"]
    _assert_tree_equal(got["detail"], ref["detail"])
    assert "car AP" in got["results"]["official"]
    # without the devkit evaluation() falls back to the kitti-style eval
    got, ref = tds.evaluation(dets, None), jds.evaluation(dets, None)
    assert got["results"] == ref["results"]
    assert list(got["results"]) == ["kitti.official"]
    for module in (tnd, ):
        with pytest.raises(ImportError):
            module._second_det_to_nusc_box(dets[0])
        with pytest.raises(ImportError):
            module._lidar_nusc_box_to_global(tds._nusc_infos[0], [], CLASSES)
        with pytest.raises(ImportError):
            module.create_nuscenes_infos(str(fake[0]))
    with pytest.raises(ImportError, match="nuScenes devkit"):
        create_data.nuscenes_data_prep(str(fake[0]), "v1.0-mini")


def test_gt_database_of_fixture_infos_matches_jax(tmp_path):
    roots = {}
    for pkg, make in (("port", tgt), ("jax", jgt)):
        root = tmp_path / pkg
        info_path = small_tree(root, frames=2)
        make.create_groundtruth_database("NuScenesDataset", str(root),
                                         str(info_path))
        roots[pkg] = root
    dbs = {}
    for pkg, root in roots.items():
        with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
            dbs[pkg] = pickle.load(f)
    assert sorted(dbs["port"]) == sorted(LARGE_CLASSES + SMALL_CLASSES)
    _assert_tree_equal(dbs["port"], dbs["jax"])
    for infos in dbs["port"].values():
        for info in infos:
            got = np.fromfile(roots["port"] / info["path"], np.float32)
            ref = np.fromfile(roots["jax"] / info["path"], np.float32)
            np.testing.assert_array_equal(got, ref)
            assert got.size == 4 * info["num_points_in_gt"] > 0


def test_device_voxelizer_full_mean():
    """Fault 2: JAX's make_voxelizer_fn reads ``full_mean``, a name the
    generator does not have (it keeps ``_full_mean``), so its voxels
    keep their empty slots zero; the port's fill them with each voxel's
    mean, as the host voxelizer does."""
    kw = dict(voxel_size=[0.5, 0.5, 8.0], point_cloud_range=[
        -8.0, -8.0, -5.0, 8.0, 8.0, 3.0], max_num_points=6,
        full_mean=True)
    gen, jgen = VoxelGenerator(**kw), JVoxelGenerator(**kw)
    assert gen._full_mean and not hasattr(jgen, "full_mean")
    rng = np.random.RandomState(0)
    n, cap, max_voxels = 1500, 2048, 400
    pts = rng.uniform([-9, -9, -4, 0], [9, 9, 2, 1], (n, 4)).astype(
        np.float32)
    buf = np.zeros((cap, 4), np.float32)
    buf[:n] = pts
    host = gen.generate_multi_gpu(pts, max_voxels)
    hv = host["voxel_num"]
    assert (host["num_points_per_voxel"][:hv] < 6).any()

    voxels, counts, coords = (t[0].numpy() for t in make_voxelizer_fn(
        gen, max_voxels)(torch.from_numpy(buf[None]),
                         torch.tensor([[n]], dtype=torch.int32)))
    jv, jcounts, jcoords = (np.asarray(t)[0] for t in jmake_voxelizer(
        jgen, max_voxels)(jnp.asarray(buf[None]),
                          jnp.asarray([[n]], jnp.int32)))
    ref, _, rc, _ = (np.asarray(t) for t in jvoxelize(
        jnp.asarray(buf), n, tuple(kw["voxel_size"]),
        tuple(kw["point_cloud_range"][:3]), grid_size=(32, 32, 1),
        max_voxels=max_voxels, max_points_per_voxel=6, full_mean=True))

    def by_coords(c, *arrays):
        keep = c[:, 0] >= 0
        order = np.lexsort(c[keep].T[::-1])
        return [a[keep][order] for a in (c,) + arrays]

    hc, hvox = by_coords(host["coordinates"][:hv], host["voxels"][:hv])
    c, v = by_coords(coords, voxels)
    np.testing.assert_array_equal(c, hc)
    np.testing.assert_allclose(v, hvox, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(voxels, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(counts, rc)
    # JAX's route left the empty slots of the same voxels zero
    np.testing.assert_array_equal(jcounts, counts)
    empty = np.arange(6)[None, :] >= jcounts[:, None]
    assert (jv[empty] == 0).all() and (voxels[empty & (counts > 0)[:, None]]
                                       != 0).any()


def test_host_voxelizer_is_thread_safe():
    """The loader's threads voxelize with one generator, whose native
    kernel keeps its voxel ids in a workspace the generator owns: 16
    threads (more than the cores) on 64 clouds, the interpreter
    switching threads every microsecond, give each cloud the voxels it
    gets alone. With one workspace shared by the threads every one came
    out wrong, and a thread of a smaller capacity could write past its
    buffers (train() at the mhead's 25000 train and 30000 eval voxels)."""
    gen = VoxelGenerator(voxel_size=[0.25, 0.25, 8.0], point_cloud_range=[
        -50.0, -50.0, -5.0, 50.0, 50.0, 3.0], max_num_points=20)
    rng = np.random.RandomState(0)
    clouds = [rng.uniform([-50, -50, -4, 0], [50, 50, 2, 1],
                          (20000, 4)).astype(np.float32) for _ in range(16)]
    alone = [gen.generate_multi_gpu(c, 8000) for c in clouds]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(gen.generate_multi_gpu, c, 8000)
                       for c in clouds * 4]
            got = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for g, ref in zip(got, alone * 4):
        for key in ("voxels", "coordinates", "num_points_per_voxel"):
            np.testing.assert_array_equal(g[key], ref[key], err_msg=key)


def test_ten_sweeps_reach_the_pillars_whole(tmp_path):
    """Fault 3: a 10-sweep frame holds more than 32768 points in range;
    the port's request ships all of them (the nuScenes capacity) with no
    overflow warning, the JAX package's its first 32768 raw points."""
    root = tmp_path / "nusc"
    info_path = build_nusc_dir(root, num_frames=1, points_per_sweep=4000,
                               half_range=9.0, max_radius=16.0)
    ds = tnd.NuScenesDataset(root, info_path)
    points = ds.get_sensor_data(0)["lidar"]["points"]
    lo, hi = np.array([-R, -R, -5.0]), np.array([R, R, 3.0])
    in_range = int(((points[:, :3] >= lo) & (points[:, :3] < hi)).all(1)
                   .sum())
    assert points.shape[0] == 40000 and 32768 < in_range < 40000
    cfg = tloads(reduced_text())
    assert points_capacity(cfg.eval_input_reader) == 393216
    ctx = InferenceContext()
    ctx.build(cfg, device="cpu")
    ctx.init_random(0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        example = ctx.get_inference_input_dict(ds._nusc_infos[0], points)
    assert int(example["points_count"][0, 0]) == in_range
    assert example["points"].shape == (1, 393216, 4)
    assert len(ctx.inference(example)) == 1

    jctx = JaxContext()
    jctx.build(jloads(reduced_text()))
    jex = jctx.get_inference_input_dict(ds._nusc_infos[0], points)
    assert int(jex["points_count"][0, 0]) == 32768


def _mhead_tree_config(root, tmp_path):
    """The reduced mhead config on a 4-frame fixture tree with its GT
    database and the published sample groups, batch 2, 2 steps."""
    info_path = small_tree(root, frames=4)
    tgt.create_groundtruth_database("NuScenesDataset", str(root),
                                    str(info_path))
    cfg = tloads(reduced_text())
    published = tloads(open("configs/nuscenes/all.pp.mhead.config").read())
    sampler = published.train_input_reader.preprocess.database_sampler
    sampler.database_info_path = str(root / "kitti_dbinfos_train.pkl")
    cfg.train_input_reader.preprocess.database_sampler = sampler
    for reader in (cfg.train_input_reader, cfg.eval_input_reader):
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(info_path)
        reader.preprocess.num_workers = 0
    cfg.eval_input_reader.batch_size = 2
    cfg.train_config.steps = 2
    cfg.train_config.steps_per_eval = 100
    path = tmp_path / "mhead.config"
    path.write_text(cfg.to_text())
    return path


def test_mhead_train_and_evaluate_on_fixture_infos(tmp_path, monkeypatch):
    # these frames hold ~4 500 points: a buffer of 8192 rows, not the
    # 393 216 a real 10-sweep frame needs (the test above), keeps the CPU
    # steps' sorts small
    monkeypatch.setattr(tnd.NuScenesDataset, "PointsCapacity", 8192)
    config = _mhead_tree_config(tmp_path / "nusc", tmp_path)
    model_dir = tmp_path / "model"
    train(str(config), str(model_dir), device="cpu")
    assert (model_dir / "voxelnet-2.ckpt").is_file()
    assert (model_dir / "results" / "final" / "result.pkl").is_file()
    cfg = tloads(config.read_text())
    cfg.train_config.steps = 3
    config.write_text(cfg.to_text())
    train(str(config), str(model_dir), resume=True, device="cpu")
    assert (model_dir / "voxelnet-3.ckpt").is_file()
    log = (model_dir / "log.txt").read_text()
    # the final eval of each run
    assert log.count("Evaluation kitti.official") == 2
    res = evaluate(str(config), str(model_dir), device="cpu")
    # the eval prints pedestrian under KITTI's "Pedestrian", as in JAX
    text = res["results"]["kitti.official"].lower()
    for name in LARGE_CLASSES + SMALL_CLASSES:
        assert f"\n{name} ap(average precision)" in "\n" + text
    with open(model_dir / "eval_results" / "step_3" / "result.pkl",
              "rb") as f:
        dets = pickle.load(f)
    assert len(dets) == 4
    assert all(d["metadata"]["token"].startswith("sample") for d in dets)
