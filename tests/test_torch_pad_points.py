"""The port's native ``pad_points`` against the NumPy formula it replaced.

The oracle below is the NumPy body ``data.preprocess.pad_points`` had
before the native pass: the buffers must be equal element for element
(NaN never survives the filter) and the counts the same."""

import inspect
import warnings

import numpy as np
import pytest

from second_tpu_torch.data.preprocess import pad_points

RANGE = np.array([-50.0, -50.0, -5.0, 50.0, 50.0, 3.0], np.float32)


def numpy_pad_points(points, pc_range, capacity, dtype=np.float32):
    in_range = np.all(
        (points[:, :3] >= pc_range[:3]) & (points[:, :3] < pc_range[3:]),
        axis=1)
    points = points[in_range]
    count = min(len(points), capacity)
    buf = np.zeros((capacity, points.shape[1]), dtype)
    buf[:count] = points[:count]
    return buf, count, len(points)


def _cloud(n, f, dtype, seed):
    """Points spread past every face of RANGE, with rows on each face."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60.0, 60.0, (n, f))
    pts[:, 2] = rng.uniform(-8.0, 6.0, n)
    for axis in range(3):
        pts[axis::7, axis] = RANGE[axis]        # on a min face: kept
        pts[axis + 3::7, axis] = RANGE[axis + 3]  # on a max face: dropped
    return pts.astype(dtype)


def _check(points, pc_range, capacity, dtype=np.float32):
    want, want_count, _ = numpy_pad_points(points, pc_range, capacity, dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        buf, count = pad_points(points, pc_range, capacity, dtype)
    assert buf.dtype == np.dtype(dtype) and buf.shape == want.shape
    assert np.array_equal(buf, want)
    assert count == want_count
    return buf, count


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("f", [4, 5])
def test_matches_numpy(dtype, f):
    pts = _cloud(5000, f, dtype, seed=f)
    buf, count = _check(pts, RANGE, 6000, dtype)
    assert 0 < count < len(pts)
    assert not buf[count:].any()


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_faces(axis, dtype):
    pts = np.zeros((4, 4), dtype)
    pts[0, axis] = RANGE[axis]
    pts[1, axis] = RANGE[axis + 3]
    pts[2, axis] = np.nextafter(RANGE[axis + 3], np.float32(-np.inf))
    pts[3, axis] = np.nextafter(RANGE[axis], np.float32(-np.inf))
    pts[:, 3] = np.arange(4)
    buf, count = _check(pts, RANGE, 8, dtype)
    assert count == 2
    assert buf[:2, 3].tolist() == [0.0, 2.0]


def test_float32_points_compare_in_double_against_a_float64_range():
    # 0.7 as a float32 point lies below 0.7 as a double: NumPy compares
    # the two in double and keeps it, and in float it sits on the face
    rng64 = np.array([-1.0, -1.0, -1.0, 0.7, 1.0, 1.0])
    pts = np.zeros((2, 4), np.float32)
    pts[0, 0] = 0.7
    _, count = _check(pts, rng64, 4)
    assert count == 2
    _, count = _check(pts, rng64.tolist(), 4)
    assert count == 2
    _, count = _check(pts, rng64.astype(np.float32), 4)
    assert count == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nan_and_inf(dtype):
    pts = np.zeros((9, 4), dtype)
    for axis in range(3):
        pts[3 * axis, axis] = np.nan
        pts[3 * axis + 1, axis] = np.inf
        pts[3 * axis + 2, axis] = -np.inf
    pts[0, 3] = np.nan  # the row is dropped for its x, whatever the rest
    _check(np.vstack([pts, np.ones((1, 4), dtype)]), RANGE, 4, dtype)


def test_nan_in_a_feature_column_is_copied():
    pts = np.zeros((2, 4), np.float32)
    pts[1, 3] = np.nan
    buf, count = pad_points(pts, RANGE, 3)
    assert count == 2 and np.isnan(buf[1, 3]) and not buf[2].any()


@pytest.mark.parametrize("f", [4, 5])
def test_empty_input(f):
    buf, count = _check(np.zeros((0, f), np.float32), RANGE, 16)
    assert count == 0 and buf.shape == (16, f)


def test_all_out_of_range():
    pts = _cloud(500, 4, np.float32, seed=3)
    pts[:, 2] = 10.0
    buf, count = _check(pts, RANGE, 64)
    assert count == 0 and not buf.any()


def _overflowing_call(points, capacity):
    return pad_points(points, RANGE, capacity)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_overflow(dtype):
    pts = _cloud(3000, 4, dtype, seed=7)
    want, want_count, total = numpy_pad_points(pts, RANGE, 100)
    assert total > 100
    with pytest.warns(UserWarning) as record:
        line = inspect.currentframe().f_lineno + 1
        buf, count = _overflowing_call(pts, 100)
    assert len(record) == 1
    assert str(record[0].message) == (
        f"emit_points buffer overflow: {total} in-range points > "
        f"capacity 100; {total - 100} dropped (raise emit_points)")
    # stacklevel=3: the warning names the caller of pad_points' caller
    assert record[0].filename == __file__ and record[0].lineno == line
    assert count == want_count == 100
    assert np.array_equal(buf, want)


def test_non_contiguous_column_view():
    wide = _cloud(2000, 8, np.float32, seed=11)
    view = wide[::2, 1:5]
    assert not view.flags.c_contiguous
    _check(view, RANGE, 1200)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tail_is_zero_in_a_reused_heap(dtype):
    # the buffer starts from np.empty: fill the allocator with garbage
    # of the same size first, so an unwritten tail would show
    for _ in range(3):
        junk = np.empty((4096, 4), dtype)
        junk.fill(7.0)
        del junk
    pts = _cloud(300, 4, np.float32, seed=5)
    buf, count = _check(pts, RANGE, 4096, dtype)
    assert count < 300 and not buf[count:].any()


def test_rejects_what_it_cannot_compare():
    with pytest.raises(TypeError):
        pad_points(np.zeros((2, 4), np.int32), RANGE, 4)
    with pytest.raises(ValueError):
        pad_points(np.zeros((2, 2), np.float32), RANGE, 4)
