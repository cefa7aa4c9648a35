"""second_tpu_torch — the PyTorch / CUDA port of second_tpu for NVIDIA
Hopper (H100).

The JAX package ``second_tpu`` stays the reference. This package imports
``torch`` and never ``jax``, ``flax``, ``optax`` or ``second_tpu``: it
keeps its own copies of the framework-free host modules it uses
(configs, core, data, native, utils.config_tool), at the same relative
paths. Each Pallas TPU kernel is a hand-written CUDA kernel here, built
with nvcc at first use.

Layout (mirrors ``second_tpu``):
  csrc/      CUDA sources (*.cu) and their nvcc/ctypes build
  ops/       kernel wrappers (cuda_*.py) with plain PyTorch versions,
             sparse grids, box math, NMS
  models/    nn.Modules: SimpleVoxel, SpMiddleFHD, RPNV2, VoxelNet
  builders/  config -> network, ModelSpec, anchors, losses
  configs/   text-proto config parser + typed schema
  core/      host numpy: boxes, anchors, targets, augmentation;
             InferenceContext (points -> detections)
  data/      prep_pointcloud, voxelizer, synthetic scenes
  native/    C++ host kernels (voxelizer, rulebook planner), g++ at first use
  train/     schedules, optimizer, the train step
  tools/     measurement scripts (train-step determinism)
  utils/     from_flax (JAX variables -> state_dict), config_tool, metrics
"""

__version__ = "0.1.0"
