"""The port's device sparse-conv engine against the JAX package on the CPU.

The same inputs, drawn with numpy from a seed, go through
``second_tpu.ops.sparse`` / ``second_tpu.models`` (the plan-less route,
XLA's gathers: no Pallas kernel) and their twins in
``second_tpu_torch`` (K1 and K2 as their plain versions here):

* the rulebook builders, exactly: ``from_voxel_coords``,
  ``build_subm_rulebook`` for kernels (3, 3, 3) and (3, 1, 1),
  ``downsample_active_set`` for every (kernel, stride, pad) of the six
  sparse middles with its capacity above and below the true count,
  ``sparse_conv_queries`` through ``lookup_many``;
* the port's device rulebooks against its host plan (the C++ planner),
  every scale of every middle, exactly, overflow included;
* every sparse middle's forward without a plan, in eval and training
  mode (batch statistics), from the same flax variables through
  ``from_flax``: outputs and updated statistics within 1e-4 (fp32 sums
  in another order), the stages' counts exactly; the port's two routes
  (host plan, device rulebooks) bitwise equal;
* ``SparseBasicBlock`` and ``SparseBottleneck`` in both modes, 1e-4.

The train step, ``InferenceContext`` and ``train``/``evaluate`` on the
device route are held to the JAX package in
``tests/test_torch_fhd_device.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.models import sparse_resnet as jsr
from second_tpu.models.registry import get_middle_class as jget_middle
from second_tpu.ops import sparse as jsp

from second_tpu_torch.models import sparse_middle as tsm
from second_tpu_torch.models import sparse_resnet as tsr
from second_tpu_torch.ops import sparse as tsp
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_modules import _random_variables

# each middle at a z that its topology accepts: the HRZ variants and 2K
# collapse car.fhd's 41 cells (nz = 40) before their last stage
MIDDLE_NZ = {"SpMiddleFHD": 40, "SpMiddleFHDPeople": 40,
             "SpMiddleFHDLite": 40, "SpMiddleFHDLiteHRZ": 80,
             "SpMiddleFHDHRZ": 80, "SpMiddle2K": 80}
# every (kernel, stride, pad) of a strided conv in the six topologies
DOWN_OPS = [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
            ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
            ((3, 1, 1), (2, 1, 1), (0, 0, 0))]
XY = 32
CAPACITY = 300
ACTIVE = 200
CHANNELS = 4


def random_coords(shape, active, capacity, seed, shuffle=False):
    """``active`` distinct zyx coords of ``shape`` in ``capacity`` rows,
    -1 padding: sorted by linear id with the padding last, or shuffled
    (padding rows among them)."""
    rng = np.random.RandomState(seed)
    lin = np.sort(rng.choice(int(np.prod(shape)), size=active,
                             replace=False))
    coords = np.full((capacity, 3), -1, np.int32)
    coords[:active] = np.stack(
        [lin // (shape[1] * shape[2]), lin // shape[2] % shape[1],
         lin % shape[2]], -1)
    if shuffle:
        coords = coords[rng.permutation(capacity)]
    return coords


def grids(shape, coords, features=None):
    """The same batch of one frame as a JAX and a port SparseGrid."""
    if features is None:
        features = np.zeros(coords.shape[:1] + (1,), np.float32)
    return (jsp.from_voxel_coords(jnp.asarray(features)[None],
                                  jnp.asarray(coords)[None], shape),
            tsp.from_voxel_coords(torch.from_numpy(features)[None],
                                  torch.from_numpy(coords)[None], shape))


def same(port, ref, what):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=what)


def test_from_voxel_coords_matches_jax():
    shape = (41, XY, XY)
    coords = random_coords(shape, ACTIVE, CAPACITY, 0, shuffle=True)
    feats = np.random.RandomState(1).randn(CAPACITY, 3).astype(np.float32)
    jgrid, tgrid = grids(shape, coords, feats)
    same(tgrid.lin, jgrid.lin, "lin")
    same(tgrid.coords, jgrid.coords, "coords")
    same(tgrid.features, jgrid.features, "features")
    assert tgrid.shape == jgrid.shape


@pytest.mark.parametrize("kernel", [(3, 3, 3), (3, 1, 1)])
def test_build_subm_rulebook_matches_jax(kernel):
    shape = (41, XY, XY)
    # dense enough that many voxels have neighbours
    coords = random_coords((41, 8, 8), ACTIVE, CAPACITY, 2, shuffle=True)
    jgrid, tgrid = grids(shape, coords)
    jslots, jfound = jsp.build_subm_rulebook(jgrid, kernel)
    slots, found = tsp.build_subm_rulebook(tgrid, kernel)
    assert slots.dtype == torch.int32
    assert int((found.sum(-1) > 1).sum()) >= 20
    same(slots, jslots, "slots")
    same(found, jfound, "found")


@pytest.mark.parametrize("fits", [True, False], ids=["fits", "overflow"])
@pytest.mark.parametrize("op", DOWN_OPS, ids=["k3s2p1", "k3s2p011",
                                              "k311s211p0"])
def test_downsample_active_set_matches_jax(op, fits):
    kernel, stride, pad = op
    shape = (41, XY, XY)
    coords = random_coords(shape, ACTIVE, CAPACITY, 3, shuffle=True)
    jgrid, tgrid = grids(shape, coords)
    _, jtotal = jsp.downsample_active_set(jgrid, kernel, stride, pad,
                                          return_count=True)
    cap = 1024 if fits else int(jtotal[0]) - 37
    jout, jtotal = jsp.downsample_active_set(
        jgrid, kernel, stride, pad, out_capacity=cap, return_count=True)
    out, total = tsp.downsample_active_set(
        tgrid, kernel, stride, pad, out_capacity=cap, return_count=True)
    assert (int(total[0]) <= cap) == fits
    same(total, jtotal, "true count")
    same(out.lin, jout.lin, "lin")
    same(out.coords, jout.coords, "coords")
    assert out.shape == jout.shape and out.lin.shape == (1, cap)


def test_sparse_conv_queries_lookup_many_matches_jax():
    """One lookup per scale answers the subm kernel and the strided
    conv, as the middles ask it."""
    shape = (41, XY, XY)
    coords = random_coords((41, 12, 12), ACTIVE, CAPACITY, 4, shuffle=True)
    answers = []
    for ops, grid in zip((jsp, tsp), grids(shape, coords)):
        out = ops.downsample_active_set(grid, *DOWN_OPS[0], out_capacity=768)
        qs, qok, _ = ops.subm_queries(grid, (3, 3, 3))
        ds, dok, _ = ops.sparse_conv_queries(grid, out, *DOWN_OPS[0])
        answers.append((qs, qok, ds, dok, ops.lookup_many(
            grid.lin, [(qs, qok), (ds, dok)], grid.sentinel)))
    (*ref, jres), (*port, tres) = answers
    for name, a, b in zip(("subm ids", "subm valid", "conv ids",
                           "conv valid"), port, ref):
        same(a, b, name)
    for (slots, found), (jslots, jfound) in zip(tres, jres):
        assert slots.dtype == torch.int32
        same(slots, jslots, "slots")
        same(found, jfound, "found")
    assert int(tres[1][1].sum()) > 0


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["fits", "overflow"])
@pytest.mark.parametrize("name", sorted(MIDDLE_NZ))
def test_device_plan_equals_host_plan(name, overflow):
    """Every scale's coords, subm and conv slots and counts of the device
    builders equal the C++ planner's. Overflow: every row active and
    spread over the grid, so stage 0's dilated set outgrows its
    capacity."""
    nz = MIDDLE_NZ[name]
    shape = (nz + 1, 64, 64)
    active = CAPACITY if overflow else ACTIVE
    if overflow:
        # voxels 4 cells apart at coords 1 mod 4: each reaches 8 outputs
        # of the first stride-2 conv, and none shares one
        lattice = np.stack(np.meshgrid(*[np.arange(1, n, 4) for n in shape],
                                       indexing="ij"), -1).reshape(-1, 3)
        pick = np.random.RandomState(5).choice(len(lattice), active, False)
        coords = lattice[np.sort(pick)].astype(np.int32)
    else:
        coords = random_coords(shape, active, CAPACITY, 5)
    scales = tsm.plan_scales(name, (1, nz, 64, 64, CHANNELS), CAPACITY)
    plan, counts = tsm.build_host_plan(coords, scales, return_counts=True)
    # a batch of two: the frame in the planner's order and reversed
    batch = torch.from_numpy(np.stack([coords, coords[::-1]]))
    dplan, dcounts = tsm.build_device_plan(tsp.from_voxel_coords(
        torch.zeros(2, CAPACITY, 1), batch, shape), scales)
    assert sorted(dplan) == sorted(plan)
    for key, value in plan.items():
        assert dplan[key].dtype == torch.int32, key
        assert dplan[key].is_contiguous(), key  # as K1 takes its slots
        for b in range(2):
            same(dplan[key][b], value, key)
    for b in range(2):
        same(dcounts[b], [counts[i] for i in sorted(counts)], "counts")
    assert (counts[0][0] > counts[0][1]) == overflow


def _middle_inputs(name, shuffle):
    nz = MIDDLE_NZ[name]
    shape = (nz + 1, XY, XY)
    coords = random_coords(shape, ACTIVE, CAPACITY, 6, shuffle=shuffle)
    feats = np.where(coords[:, :1] >= 0, np.random.RandomState(7).randn(
        CAPACITY, CHANNELS), 0).astype(np.float32)
    return (1, nz, XY, XY, CHANNELS), coords, feats


@functools.lru_cache(maxsize=None)
def _jax_middle(name):
    """The JAX middle's variables and its plan-less forward in eval and
    in training mode, one compiled program for both."""
    output_shape, coords, feats = _middle_inputs(name, shuffle=True)
    jmid = jget_middle(name)(output_shape=output_shape,
                             num_input_features=CHANNELS)
    fj, cj = jnp.asarray(feats)[None], jnp.asarray(coords)[None]
    variables = _random_variables(jax.eval_shape(
        jmid.init, jax.random.PRNGKey(0), fj, cj), seed=8)

    @jax.jit
    def both(v):
        return {train: jmid.apply(v, fj, cj, train=train,
                                  mutable=["batch_stats", "intermediates"])
                for train in (False, True)}

    return variables, jax.tree_util.tree_map(np.asarray, both(variables))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MIDDLE_NZ))
def test_middle_without_plan_matches_jax(name, train):
    output_shape, coords, feats = _middle_inputs(name, shuffle=True)
    variables, outs = _jax_middle(name)
    ref, updated = outs[train]
    assert np.abs(ref).max() > 1e-2

    tmid = getattr(tsm, name)(output_shape=output_shape,
                              num_input_features=CHANNELS)
    tmid.load_state_dict(from_flax(variables), strict=True)
    tmid.train(train)
    inter = {}
    out = tmid(torch.from_numpy(feats)[None], torch.from_numpy(coords)[None],
               None, inter)
    out_nhwc = out.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out_nhwc, ref, atol=1e-4, rtol=1e-4)
    sown = updated["intermediates"]
    jcounts = np.stack([sown[k][0] for k in sorted(
        sown, key=lambda k: int(k[len("active_scale"):]))], 1)
    same(inter["sparse_active_counts"], jcounts, "counts")
    if train:
        ref_state = from_flax({"params": variables["params"],
                               "batch_stats": updated["batch_stats"]})
        for key, value in tmid.state_dict().items():
            np.testing.assert_allclose(value.numpy(), ref_state[key].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=key)

    # the host-plan route on the same voxels, sorted: bitwise equal
    tmid.load_state_dict(from_flax(variables), strict=True)
    order = np.argsort(np.where(coords[:, 0] >= 0, (
        coords[:, 0].astype(np.int64) * XY + coords[:, 1]) * XY
        + coords[:, 2], np.iinfo(np.int64).max), kind="stable")
    scoords = coords[order]
    plan = tsm.build_host_plan(scoords, tsm.plan_scales(
        name, output_shape, CAPACITY))
    host = tmid(torch.from_numpy(feats[order])[None],
                torch.from_numpy(scoords)[None],
                {k: torch.from_numpy(v)[None] for k, v in plan.items()})
    assert torch.equal(host, out)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block", ["SparseBasicBlock", "SparseBottleneck"])
def test_sparse_resnet_block_matches_jax(block, train):
    shape = (41, 16, 16)
    coords = random_coords(shape, ACTIVE, CAPACITY, 9, shuffle=True)
    feats = np.where(coords[:, :1] >= 0, np.random.RandomState(10).randn(
        CAPACITY, 8), 0).astype(np.float32)
    jgrid, tgrid = grids(shape, coords, feats)
    jblock = getattr(jsr, block)(planes=16)
    jrule = jsp.build_subm_rulebook(jgrid, (3, 3, 3))
    variables = _random_variables(jax.eval_shape(
        lambda: jblock.init(jax.random.PRNGKey(0), jgrid, jrule)), seed=11)
    ref, updated = jblock.apply(variables, jgrid, jrule, train=train,
                                mutable=["batch_stats"])

    inplanes = 8
    tblock = getattr(tsr, block)(inplanes, 16)
    tblock.load_state_dict(from_flax(variables), strict=True)
    tblock.train(train)
    slots, _ = tsp.build_subm_rulebook(tgrid, (3, 3, 3))
    out = tblock(tgrid, slots)
    assert np.abs(np.asarray(ref.features)).max() > 1e-2
    np.testing.assert_allclose(out.features.detach().numpy(),
                               np.asarray(ref.features), atol=1e-4,
                               rtol=1e-4)
    ref_state = from_flax({"params": variables["params"],
                           "batch_stats": updated["batch_stats"]})
    for key, value in tblock.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref_state[key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
