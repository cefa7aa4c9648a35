"""The training cell on the CPU at a small size, past the harness's look
for a card: the reference follows the port's first steps (the same first
loss to rounding, the same first gradients), and ``correct`` comes out
false for each fault a training cell on one card can have: a step that
leaves the state unchanged, half of the batch left out (the mean taken
over the rest), the loss altered where it is produced."""

import time

import pytest
import torch

from benchmark import common
from benchmark.kinds import train
from benchmark.tests.small import small_config
from second_tpu_torch.train import optimizer as port_opt
from second_tpu_torch.train import state as port_state

# the first step's loss: the same fp32 sums in another order
LOSS1_TOL = 1e-5


def _run(tmp_path):
    cfg = small_config("car_fhd", tmp_path)
    mix = dict(common.load_mix("train"), frames=8, repeat=2)
    return train.run({
        "config": cfg, "mix": mix, "seed": 2 ** 31 + 21, "seconds": 1.0,
        "trace": False, "limits": common.load_limits("car_fhd.train"),
        "tmp": tmp_path, "t_process": time.perf_counter(),
        "device": torch.device("cpu")})


def test_reference_follows_the_port(tmp_path):
    rec = _run(tmp_path)
    assert rec["correct"], rec["numbers"]
    assert rec["numbers"]["loss1_err"] < LOSS1_TOL
    assert rec["attempted"] >= 1 and rec["frames"] > 0


def _unchanged(monkeypatch):
    monkeypatch.setattr(port_opt.AdamW, "_update",
                        lambda self, grads, lr, b1: None)


def _half_batch(monkeypatch):
    inner = port_state.loss_and_global_grads

    def half(net, spec, example, params, voxelizer=None):
        b = example["voxels"].shape[0]
        cut = {k: v[:b // 2] if torch.is_tensor(v) and v.dim()
               and v.shape[0] == b else v for k, v in example.items()}
        res, grads = inner(net, spec, cut, params, voxelizer)
        # the step's metrics still read the whole batch's labels
        res["cls_preds"] = torch.cat([res["cls_preds"]] * 2)[:b]
        return res, grads

    monkeypatch.setattr(port_state, "loss_and_global_grads", half)


def _loss_altered(monkeypatch):
    inner = port_state.loss_and_global_grads

    def altered(*args, **kwargs):
        res, grads = inner(*args, **kwargs)
        res["loss"] = res["loss"] * 1.01
        return res, grads

    monkeypatch.setattr(port_state, "loss_and_global_grads", altered)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "loss_altered": _loss_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    rec = _run(tmp_path)
    assert not rec["correct"], rec["numbers"]
