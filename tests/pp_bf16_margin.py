"""PointPillars' bf16 error against f32, in the JAX package and in the
port, on the same weights and frames, on the CPU.

    JAX_PLATFORMS=cpu python tests/pp_bf16_margin.py [--frames 4]

Builds ``configs/pointpillars/car/xyres_16.config`` at its published
width in f32 and under ``enable_mixed_precision``, in both packages,
with one set of random weights (``test_torch_slice.random_variables``:
weights of variance 1/fan_in, batch norms away from identity, as
``chip_smoke.py`` phase 13 draws them; the port loads them through
``from_flax``). Runs ``make_kitti_scene(RandomState(i))`` frames 0..N-1
through the flat pillar path (JAX: ``flat_pillarize``, ``flat_pfn_bev``
and the RPN; the port: ``InferenceContext.run``) and prints, per frame
and pred, max |bf16 - f32| over the largest |f32| value of each package
and of the port's bf16 preds against JAX's, as one JSON line a frame.
``margins`` is the same measurement on any PillarFeatureNet config;
``tests/test_torch_bf16.py`` runs it at a reduced width.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.core.inference import InferenceContext as JaxContext
from second_tpu.models import pp_fast as jpp
from second_tpu.train.__main__ import example_convert

from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.data import make_kitti_scene

from test_torch_slice import random_variables

CONFIG = (Path(__file__).resolve().parents[1] / "configs" / "pointpillars"
          / "car" / "xyres_16.config")
PREDS = ("box_preds", "cls_preds", "dir_cls_preds")


def mixed(text):
    """A pipeline config's text with ``enable_mixed_precision`` set."""
    cfg = tloads(text)
    cfg.train_config.enable_mixed_precision = True
    return cfg.to_text()


def rel(a, b):
    """max |a - b| over max |b|, in f32."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_preds(ctx, variables, points):
    """The JAX package's flat pillar path on one frame: the RPN's preds
    as f32 numpy."""
    gen = ctx.parts["voxel_generator"]
    max_voxels = ctx.config.eval_input_reader.preprocess.max_number_of_voxels
    jex = ctx.get_inference_input_dict({}, points)
    ex = {k: jnp.asarray(v) for k, v in example_convert(jex).items()}
    grid = tuple(int(g) for g in gen.grid_size)
    t = int(gen.max_num_points_per_voxel)
    flat = jpp.flat_pillarize(
        ex["points"][0], ex["points_count"][0, 0],
        tuple(float(x) for x in gen.voxel_size),
        tuple(float(x) for x in gen.point_cloud_range[:3]),
        grid_size=grid, max_voxels=max_voxels, max_points_per_voxel=t)
    vfe = ctx.config.model.second.voxel_feature_extractor
    bev = jpp.flat_pfn_bev(
        variables, *flat[:5], num_filters=tuple(vfe.num_filters),
        max_points_per_voxel=t, voxel_size=tuple(gen.voxel_size),
        pc_range=tuple(gen.point_cloud_range), grid_size=grid,
        num_input_features=4, center_replaces_xy=True)
    net = ctx.parts["net"]
    preds = jax.jit(lambda v, x: net.apply(
        v, x, method=lambda m, a: m.rpn(a, train=False)))(variables,
                                                          bev[None])
    return {k: np.asarray(jnp.asarray(preds[k]).astype(jnp.float32))
            for k in PREDS}


def margins(text, frames):
    """Per frame, {pred: {"jax": bf16 vs f32 in JAX, "port": bf16 vs f32
    in the port, "port_vs_jax": the two packages' bf16}} for the config
    ``text`` on the point clouds ``frames``."""
    jctx = {}
    for name, t in (("f32", text), ("bf16", mixed(text))):
        jctx[name] = JaxContext()
        jctx[name].build(jloads(t))
    max_voxels = (jctx["f32"].config.eval_input_reader.preprocess
                  .max_number_of_voxels)
    variables = random_variables(jctx["f32"].parts["net"], max_voxels)
    tctx = {}
    for name, t in (("f32", text), ("bf16", mixed(text))):
        tctx[name] = InferenceContext()
        tctx[name].build(tloads(t), device="cpu")
        tctx[name].load_flax_variables(variables)
    assert tctx["bf16"].parts["net"].rpn.compute_dtype == torch.bfloat16
    rows = []
    for points in frames:
        j = {n: _jax_preds(c, variables, points) for n, c in jctx.items()}
        example = tctx["f32"].get_inference_input_dict({}, points)
        t = {n: {k: v.float().numpy() for k, v in c.run(example)[0].items()}
             for n, c in tctx.items()}
        row = {}
        for k in PREDS:
            jk = {n: j[n][k].reshape(t["f32"][k].shape) for n in j}
            row[k] = {"jax": rel(jk["bf16"], jk["f32"]),
                      "port": rel(t["bf16"][k], t["f32"][k]),
                      "port_vs_jax": rel(t["bf16"][k], jk["bf16"])}
        rows.append(row)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=4)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    frames = [make_kitti_scene(np.random.RandomState(i))[0]
              for i in range(args.frames)]
    rows = margins(CONFIG.read_text(), frames)
    for i, row in enumerate(rows):
        print(json.dumps({"frame": i, **row}), flush=True)
    worst = {side: max(r[k][side] for r in rows for k in PREDS)
             for side in ("jax", "port", "port_vs_jax")}
    print(json.dumps({"worst": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
