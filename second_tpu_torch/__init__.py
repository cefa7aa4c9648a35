"""second_tpu_torch — the PyTorch / CUDA port of second_tpu for NVIDIA
Hopper (H100).

The JAX package ``second_tpu`` stays the reference. This package imports
``torch`` and never ``jax``, ``flax``, ``optax`` or ``second_tpu``: it
keeps its own copies of the framework-free host modules it uses
(configs, core, data, native, utils), at the same relative
paths. Each Pallas TPU kernel is a hand-written CUDA kernel here, built
with nvcc at first use.

Layout (mirrors ``second_tpu``):
  csrc/      CUDA sources (*.cu) and their nvcc/ctypes build
  ops/       kernel wrappers (cuda_*.py) with plain PyTorch versions,
             sparse grids and their device rulebook builders, box math,
             NMS
  models/    nn.Modules: SimpleVoxel, the sparse middles, the sparse
             residual blocks, RPNV2, VoxelNet
  builders/  config -> network, ModelSpec, anchors, losses
  configs/   text-proto config parser + typed schema
  core/      host numpy: boxes, anchors, targets, augmentation;
             InferenceContext (points -> detections)
  data/      prep_pointcloud, voxelizer, synthetic scenes, KittiDataset,
             DataLoader, DevicePrefetcher
  native/    C++ host kernels (voxelizer, rulebook planner, KITTI eval
             matcher), g++ at first use
  train/     schedules, optimizer, the train and eval steps, checkpoints,
             the train/evaluate entry points (python -m second_tpu_torch.train)
  tools/     measurement scripts, the learning proof (overfit_ap) and its
             mini-KITTI fixture
  utils/     from_flax (JAX variables -> state_dict), config_tool, metrics,
             eval (official KITTI AP), timer, log_tool, fire_lite
"""

__version__ = "0.1.0"
