"""Is the port's car.fhd train step run-to-run deterministic on the card,
and if not, where does it part?

    python -m second_tpu_torch.tools.train_determinism [--steps 3]

Builds the full-width car.fhd network on GPU 0 with random weights from
seed 0 and the batch of 8 ``make_kitti_scene`` frames that
``chip_smoke.py``'s training phases use (TF32 off). Under each of three
settings it then

  * computes one step's loss and gradients twice from the same state
    and names the gradient tensors that differ bitwise, and
  * runs ``--steps`` train steps twice from the same state and prints
    both loss sequences and the largest parameter difference after them.

Settings: ``default`` (as the smoke runs), ``cudnn_deterministic``
(``torch.backends.cudnn.deterministic``) and ``deterministic_algorithms``
(``torch.use_deterministic_algorithms(True)``; an op without a
deterministic implementation raises and is reported by name). The
kernels K1 and K2 are deterministic by design under every setting.
"""

import argparse
import copy
import os
import subprocess

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ..builders.dataset_builder import build_prep_func  # noqa: E402
from ..builders.network_builder import build_network  # noqa: E402
from ..configs import load_pipeline_config  # noqa: E402
from ..core.inference import example_to_device  # noqa: E402
from ..data import make_kitti_scene, merge_second_batch  # noqa: E402
from ..models.voxelnet import init_weights  # noqa: E402
from ..train import optimizer as opt_builder  # noqa: E402
from ..train.state import forward_loss, make_train_step  # noqa: E402

CONFIG = "configs/car.fhd.config"
BATCH = 8


def train_batch(prep):
    np.random.seed(0)
    frames = []
    for i in range(BATCH):
        points, boxes, names = make_kitti_scene(np.random.RandomState(i))
        frames.append(prep(input_dict={"lidar": {
            "points": points,
            "annotations": {"boxes": boxes, "names": names}}}))
    return merge_second_batch(frames)


def loss_and_grads(net, spec, ex):
    net = copy.deepcopy(net)
    loss = forward_loss(net, spec, ex)["loss"]
    names, params = zip(*net.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def run_steps(cfg, parts, state0, ex, steps):
    net, spec = parts["net"], parts["spec"]
    net.load_state_dict(state0)
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(net.parameters()))
    step = make_train_step(net, spec, opt, lr_fn, mom_fn)
    losses = [step(ex)["loss"].item() for _ in range(steps)]
    return losses, {k: v.clone() for k, v in net.state_dict().items()}


def check_setting(name, cfg, parts, state0, ex, steps):
    print(f"[{name}]", flush=True)
    net, spec = parts["net"], parts["spec"]
    net.load_state_dict(state0)
    try:
        (l1, g1), (l2, g2) = (loss_and_grads(net, spec, ex),
                              loss_and_grads(net, spec, ex))
        differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
        print(f"  one step's loss bitwise equal: {torch.equal(l1, l2)}; "
              f"gradients differing bitwise: {len(differ)} of {len(g1)}")
        for k in differ:
            d = (g1[k] - g2[k]).abs().max().item()
            print(f"    {k}: max diff {d:.3e} of "
                  f"{g1[k].abs().max().item():.3e}")
        a, sa = run_steps(cfg, parts, state0, ex, steps)
        b, sb = run_steps(cfg, parts, state0, ex, steps)
        worst = max((sa[k].double() - sb[k].double()).abs().max().item()
                    for k in sa if sa[k].is_floating_point())
        print(f"  {steps} steps, run 1 losses {a}")
        print(f"  {steps} steps, run 2 losses {b}")
        print(f"  largest state difference after {steps} steps: {worst:.3e}")
    except RuntimeError as err:
        print(f"  raised: {str(err).splitlines()[0]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_determinism: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = load_pipeline_config(CONFIG)
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    state0 = copy.deepcopy(parts["net"].state_dict())
    ex = example_to_device(train_batch(build_prep_func(
        cfg.train_input_reader, parts, training=True)), device)

    check_setting("default", cfg, parts, state0, ex, args.steps)
    torch.backends.cudnn.deterministic = True
    check_setting("cudnn_deterministic", cfg, parts, state0, ex, args.steps)
    torch.use_deterministic_algorithms(True)
    check_setting("deterministic_algorithms", cfg, parts, state0, ex,
                  args.steps)


if __name__ == "__main__":
    main()
