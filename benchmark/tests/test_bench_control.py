"""The control on the card at a small size: the reference computed with
TF32 products, put in the port's place, must fail the cell's limits,
while the port's own requests pass them. Marked ``cuda``; on the card:

    python3 -m pytest -m cuda benchmark/tests/test_bench_control.py

The cells' readings at their own size come from ``python3 -m
benchmark.control``.
"""

import pytest
import torch

from benchmark import common, control
from benchmark.tests.small import small_config


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_control_fails_and_program_passes(name, tmp_path):
    device = _device()
    cfg = small_config(name, tmp_path)
    mix = common.load_mix("sweep")
    limits = common.load_limits(f"{name}.sweep")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control.readings(cfg, mix, seed, "program", 4, device)
        assert all(got[k] <= limits[k] for k in limits), got
        got = control.readings(cfg, mix, seed, "control", 4, device)
        assert any(got[k] > limits[k] for k in limits), got
