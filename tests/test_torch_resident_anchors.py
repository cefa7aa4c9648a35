"""The anchors a request ships by reference (``core.inference``): a
constant of the config, made once (``make_anchor_cache``, read-only),
held by every request's host batch as the cache itself, and read on the
device from a copy that ``InferenceContext.build`` uploaded once.

For each benchmark configuration, cut to a small patch of ground at its
published widths (``benchmark/tests/small*.py``), on the CPU:

* the host batch's ``anchors`` share the cache's memory, are read-only,
  and equal the per-request copy the batch held before, bit for bit;
* a request counts ``anchors_resident`` 1 and uploads A x 7 x 4 bytes
  fewer than the whole batch;
* the same batch with its anchors replaced by a writable copy uploads
  them, counts 0, and gives the same preds and detections bit for bit;
* the resident copy still equals the cache after the requests;
* ``merge_second_batch`` of one example holds views of its arrays, and
  of two, copies equal to ``np.stack``.
"""

import numpy as np
import pytest
import torch

from benchmark.tests.small import small_config, small_sweep
from benchmark.tests.small_mhead import small_frame, small_mhead_config
from benchmark.tests.small_res8x import small_res8x_config, small_res8x_frame
from second_tpu_torch.core.inference import InferenceContext, example_convert
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.utils import timer

CPU = torch.device("cpu")
SEED = 2 ** 31 + 24


def _kitti(name):
    def make(tmp_path):
        cfg = small_config(name, tmp_path)
        return cfg, {}, lambda rng: small_sweep(cfg, rng)
    return make


def _mhead(tmp_path):
    cfg = small_mhead_config(tmp_path)
    return cfg, {"token": "t"}, lambda rng: small_frame(cfg, rng)


def _res8x(tmp_path):
    return (small_res8x_config(tmp_path), {"token": "t"},
            small_res8x_frame)


# the repo config each benchmark configuration runs -> (its small
# config dict, the request's info, a frame from a generator)
CASES = {"car.fhd": _kitti("car_fhd"), "xyres_16": _kitti("pointpillars"),
         "all.pp.mhead": _mhead, "all.res8x": _res8x}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request, tmp_path_factory):
    """(the context on the CPU with seeded random weights, the request's
    info, two frames)."""
    cfg, info, frame = CASES[request.param](
        tmp_path_factory.mktemp(request.param))
    ctx = InferenceContext()
    ctx.build(cfg["repo_config"], CPU, **cfg["build"])
    ctx.init_random(0)
    ctx.parts["net"].eval()
    frames = [frame(np.random.default_rng([SEED, i])) for i in (1, 2)]
    return ctx, info, frames


def _cache(ctx):
    return ctx.parts["anchor_cache"]["anchors"]


def _run_counted(ctx, batch):
    """``ctx.run(batch)`` as a request of its own with collection on:
    (preds, detections, its counts)."""
    was = timer.collect(True)
    try:
        rid = timer.new_request()
        preds, dets = ctx.run(dict(batch, **{timer.REQUEST_KEY: rid}))
        return preds, dets, timer.snapshot()["counts"][rid]
    finally:
        timer.collect(was)
        timer.reset()


def _example(ctx, info, points):
    """A request's example before ``merge_second_batch``, as
    ``get_inference_input_dict`` makes it."""
    example = ctx.prep_func(input_dict={
        "lidar": {"type": "lidar", "points": points},
        "metadata": dict(info)})
    ctx.route.sort_request(example)
    return example


def test_host_batch_holds_the_cache(served):
    ctx, info, frames = served
    cache = _cache(ctx)
    assert not cache.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        cache[0, 0] = 1.0
    for points in frames:
        anchors = ctx.get_inference_input_dict(info, points)["anchors"]
        assert np.shares_memory(anchors, cache)
        assert not anchors.flags.writeable
        # the copy every request made before: astype, then np.stack
        old = np.stack([cache.astype(np.float32)], axis=0)
        assert anchors.dtype == old.dtype and anchors.shape == old.shape
        assert anchors.tobytes() == old.tobytes()


def test_request_reads_the_resident_anchors(served):
    ctx, info, frames = served
    for points in frames:
        batch = ctx.get_inference_input_dict(info, points)
        whole = sum(v.nbytes for v in example_convert(batch).values())
        _, _, counts = _run_counted(ctx, batch)
        assert counts["anchors_resident"] == 1
        assert counts["upload_bytes"] == whole - _cache(ctx).shape[0] * 7 * 4


def test_copied_anchors_take_the_upload_and_give_the_same_result(served):
    ctx, info, frames = served
    for points in frames:
        batch = ctx.get_inference_input_dict(info, points)
        copy = dict(batch, anchors=np.array(batch["anchors"]))
        assert copy["anchors"].flags.writeable
        whole = sum(v.nbytes for v in example_convert(batch).values())
        preds, dets, counts = _run_counted(ctx, batch)
        preds_up, dets_up, counts_up = _run_counted(ctx, copy)
        assert (counts["anchors_resident"], counts_up["anchors_resident"]) \
            == (1, 0)
        assert counts_up["upload_bytes"] == whole
        for got, want in ((preds, preds_up), (dets, dets_up)):
            assert set(got) == set(want)
            for key in got:
                assert torch.equal(got[key], want[key]), key


def test_resident_copy_is_unchanged_by_requests(served):
    ctx, info, frames = served
    for points in frames:
        ctx.inference(ctx.get_inference_input_dict(info, points))
    resident = ctx.anchors_device
    assert resident.device == CPU and resident.dtype == torch.float32
    assert resident.numpy().tobytes() == _cache(ctx).tobytes()
    # the device's copy is its own memory, writable
    assert not np.shares_memory(resident.numpy(), _cache(ctx))


@pytest.mark.parametrize("batch_size", (1, 2))
def test_merge_views_one_example_and_stacks_two(served, batch_size):
    ctx, info, frames = served
    examples = [_example(ctx, info, points)
                for points in frames[:batch_size]]
    batch = merge_second_batch(examples)
    assert set(batch) == set(examples[0])
    arrays = [k for k in batch if isinstance(batch[k], np.ndarray)]
    assert "anchors" in arrays
    for key in arrays:
        want = np.stack([e[key] for e in examples], axis=0)
        assert batch[key].dtype == want.dtype, key
        assert batch[key].shape == want.shape, key
        assert batch[key].tobytes() == want.tobytes(), key
        shared = [np.shares_memory(batch[key], e[key]) for e in examples]
        if batch_size == 1:
            assert shared == [True], key
        else:
            assert not any(shared), key
