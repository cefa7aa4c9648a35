"""Host-side (numpy) 3D box operations.

Framework-free box math shared by the data pipeline, target assignment
and evaluation.  Semantics pinned by the reference implementation
second/core/box_np_ops.py (SECOND box conventions):

  * lidar boxes are ``[x, y, z, w, l, h, yaw]`` (+ optional custom dims
    such as velocity); z is the box BOTTOM in the data pipeline
    (origin (0.5, 0.5, 0) when expanding corners) and the box CENTER
    inside encode/decode.
  * camera boxes are ``[x, y, z, l, h, w, ry]`` with origin
    (0.5, 1.0, 0.5) and rotation about the camera y axis.
"""

import numpy as np

from . import geometry


# ---------------------------------------------------------------------------
# encode / decode (reference: box_np_ops.py:36-133 second_box_*;
# :136-205 bev_box_*)
# ---------------------------------------------------------------------------


def second_box_encode(boxes, anchors, encode_angle_to_vector=False, smooth_dim=False):
    """SECOND residual encoding of ``boxes`` against ``anchors``.

    boxes/anchors: [N, 7+c] (x, y, z, w, l, h, r, custom...).  Custom
    dims (e.g. velocities) are encoded as plain differences.
    """
    ndim = anchors.shape[-1]
    xa, ya, za, wa, la, ha, ra = (anchors[..., i : i + 1] for i in range(7))
    xg, yg, zg, wg, lg, hg, rg = (boxes[..., i : i + 1] for i in range(7))
    diag = np.sqrt(wa**2 + la**2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    zt = (zg - za) / ha
    if smooth_dim:
        wt, lt, ht = wg / wa - 1, lg / la - 1, hg / ha - 1
    else:
        wt, lt, ht = np.log(wg / wa), np.log(lg / la), np.log(hg / ha)
    custom = [boxes[..., 7:ndim] - anchors[..., 7:ndim]] if ndim > 7 else []
    if encode_angle_to_vector:
        rot = [np.cos(rg) - np.cos(ra), np.sin(rg) - np.sin(ra)]
    else:
        rot = [rg - ra]
    return np.concatenate([xt, yt, zt, wt, lt, ht, *rot, *custom], axis=-1)


def second_box_decode(encodings, anchors, encode_angle_to_vector=False, smooth_dim=False):
    """Inverse of :func:`second_box_encode`."""
    ndim = anchors.shape[-1]
    xa, ya, za, wa, la, ha, ra = (anchors[..., i : i + 1] for i in range(7))
    xt, yt, zt, wt, lt, ht = (encodings[..., i : i + 1] for i in range(6))
    diag = np.sqrt(wa**2 + la**2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        wg, lg, hg = (wt + 1) * wa, (lt + 1) * la, (ht + 1) * ha
    else:
        wg, lg, hg = np.exp(wt) * wa, np.exp(lt) * la, np.exp(ht) * ha
    if encode_angle_to_vector:
        rtx, rty = encodings[..., 6:7], encodings[..., 7:8]
        rg = np.arctan2(rty + np.sin(ra), rtx + np.cos(ra))
        rest = encodings[..., 8 : ndim + 1]
    else:
        rg = encodings[..., 6:7] + ra
        rest = encodings[..., 7:ndim]
    custom = [rest + anchors[..., 7:ndim]] if ndim > 7 else []
    return np.concatenate([xg, yg, zg, wg, lg, hg, rg, *custom], axis=-1)


def bev_box_encode(boxes, anchors, encode_angle_to_vector=False, smooth_dim=False):
    """BEV-only encoding. boxes/anchors: [N, 5] (x, y, w, l, r)."""
    xa, ya, wa, la, ra = (anchors[..., i : i + 1] for i in range(5))
    xg, yg, wg, lg, rg = (boxes[..., i : i + 1] for i in range(5))
    diag = np.sqrt(wa**2 + la**2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    if smooth_dim:
        wt, lt = wg / wa - 1, lg / la - 1
    else:
        wt, lt = np.log(wg / wa), np.log(lg / la)
    if encode_angle_to_vector:
        rot = [np.cos(rg) - np.cos(ra), np.sin(rg) - np.sin(ra)]
    else:
        rot = [rg - ra]
    return np.concatenate([xt, yt, wt, lt, *rot], axis=-1)


def bev_box_decode(encodings, anchors, encode_angle_to_vector=False, smooth_dim=False):
    xa, ya, wa, la, ra = (anchors[..., i : i + 1] for i in range(5))
    xt, yt, wt, lt = (encodings[..., i : i + 1] for i in range(4))
    diag = np.sqrt(wa**2 + la**2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    if smooth_dim:
        wg, lg = (wt + 1) * wa, (lt + 1) * la
    else:
        wg, lg = np.exp(wt) * wa, np.exp(lt) * la
    if encode_angle_to_vector:
        rtx, rty = encodings[..., 4:5], encodings[..., 5:6]
        rg = np.arctan2(rty + np.sin(ra), rtx + np.cos(ra))
    else:
        rg = encodings[..., 4:5] + ra
    return np.concatenate([xg, yg, wg, lg, rg], axis=-1)


# ---------------------------------------------------------------------------
# corners / rotations (reference: box_np_ops.py:207-470)
# ---------------------------------------------------------------------------

# 2D corner order: x0y0, x0y1, x1y1, x1y0 (clockwise from min corner).
_CORNERS2D = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], dtype=np.float64)
# 3D corner order (the reference's [0,1,3,2,4,5,7,6] unravel permutation):
# bottom face then top face is NOT the layout — x is the outer bit.
_CORNERS3D = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 1],
        [0, 1, 0],
        [1, 0, 0],
        [1, 0, 1],
        [1, 1, 1],
        [1, 1, 0],
    ],
    dtype=np.float64,
)


def corners_nd(dims, origin=0.5):
    """Per-box corner offsets from dims. dims: [N, ndim] -> [N, 2**ndim, ndim]."""
    ndim = dims.shape[1]
    template = {2: _CORNERS2D, 3: _CORNERS3D}[ndim].astype(dims.dtype)
    corners_norm = template - np.asarray(origin, dtype=dims.dtype)
    return dims[:, np.newaxis, :] * corners_norm[np.newaxis]


def rotation_2d(points, angles):
    """Rotate [N, P, 2] point sets by [N] angles (reference convention:
    x' = x cos + y sin, y' = -x sin + y cos, i.e. clockwise for positive
    angle in standard orientation)."""
    rot_sin, rot_cos = np.sin(angles), np.cos(angles)
    # row-major rot_mat_T[i] = [[cos, -sin], [sin, cos]] applied as p @ R_T
    rot = np.stack(
        [
            np.stack([rot_cos, -rot_sin], axis=-1),
            np.stack([rot_sin, rot_cos], axis=-1),
        ],
        axis=-2,
    )  # [N, 2, 2]
    return np.einsum("npj,njk->npk", points, rot)


def rotation_3d_in_axis(points, angles, axis=0):
    """Rotate [N, P, 3] point sets by [N] angles about the given axis."""
    s, c = np.sin(angles), np.cos(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif axis in (2, -1):
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    elif axis == 0:
        rows = [[zero, c, -s], [zero, s, c], [one, zero, zero]]
    else:
        raise ValueError("axis should be in range")
    rot = np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)  # [N, 3, 3]
    return np.einsum("npj,njk->npk", points, rot)


def rotation_points_single_angle(points, angle, axis=0):
    """Rotate [N, 3] points by a scalar angle about the given axis."""
    return rotation_3d_in_axis(
        points[np.newaxis], np.asarray([angle], dtype=points.dtype), axis=axis
    )[0]


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 0.5, 0.5), axis=2):
    """[N, 3]x[N, 3]x[N] -> [N, 8, 3] corners. lidar: origin (.5, .5, 0),
    axis 2; camera: origin (.5, 1., .5), axis 1."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers[:, np.newaxis, :]


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers[:, np.newaxis, :]


def corner_to_standup_nd(boxes_corner):
    """[N, P, ndim] corners -> [N, 2*ndim] axis-aligned (min..., max...)."""
    return np.concatenate(
        [boxes_corner.min(axis=1), boxes_corner.max(axis=1)], axis=-1
    )


def center_to_minmax_2d(centers, dims, origin=0.5):
    if origin == 0.5:
        return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)
    corners = center_to_corner_box2d(centers, dims, origin=origin)
    return corners[:, [0, 2]].reshape([-1, 4])


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rbbox2d_to_near_bbox(rbboxes):
    """[N, 5(x, y, w, l, r)] -> nearest axis-aligned [N, 4(xyxy)] boxes.

    Swaps w/l when the yaw is closer to +-pi/2 than to 0 (reference:
    box_np_ops.py:286-298).
    """
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., np.newaxis]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(bboxes_center[:, :2], bboxes_center[:, 2:])


# ---------------------------------------------------------------------------
# anchors (reference: box_np_ops.py:561-645)
# ---------------------------------------------------------------------------


def create_anchors_3d_stride(
    feature_size,
    sizes=(1.6, 3.9, 1.56),
    anchor_strides=(0.4, 0.4, 0.0),
    anchor_offsets=(0.2, -39.8, -1.78),
    rotations=(0, np.pi / 2),
    dtype=np.float32,
):
    """Anchors on a strided grid.

    feature_size: [D, H, W] (zyx). Returns [D, H, W, num_sizes, num_rots, 7]
    with last dim (x, y, z, w, l, h, rot).
    """
    nz, ny, nx = feature_size
    z = np.arange(nz, dtype=dtype) * anchor_strides[2] + anchor_offsets[2]
    y = np.arange(ny, dtype=dtype) * anchor_strides[1] + anchor_offsets[1]
    x = np.arange(nx, dtype=dtype) * anchor_strides[0] + anchor_offsets[0]
    return _assemble_anchors(z, y, x, sizes, rotations, dtype)


def create_anchors_3d_range(
    feature_size,
    anchor_range,
    sizes=(1.6, 3.9, 1.56),
    rotations=(0, np.pi / 2),
    dtype=np.float32,
):
    """Anchors with centers linspaced over anchor_range (inclusive ends).

    anchor_range: [xmin, ymin, zmin, xmax, ymax, zmax].
    Returns [D, H, W, num_sizes, num_rots, 7].
    """
    anchor_range = np.asarray(anchor_range, dtype)
    nz, ny, nx = feature_size
    z = np.linspace(anchor_range[2], anchor_range[5], nz, dtype=dtype)
    y = np.linspace(anchor_range[1], anchor_range[4], ny, dtype=dtype)
    x = np.linspace(anchor_range[0], anchor_range[3], nx, dtype=dtype)
    return _assemble_anchors(z, y, x, sizes, rotations, dtype)


def _assemble_anchors(z, y, x, sizes, rotations, dtype):
    nz, ny, nx = len(z), len(y), len(x)
    sizes = np.reshape(np.asarray(sizes, dtype=dtype), [-1, 3])
    rotations = np.asarray(rotations, dtype=dtype)
    ns, nr = sizes.shape[0], len(rotations)
    shape = (nz, ny, nx, ns, nr)
    out = np.empty(shape + (7,), dtype=dtype)
    out[..., 0] = x.reshape(1, 1, nx, 1, 1)
    out[..., 1] = y.reshape(1, ny, 1, 1, 1)
    out[..., 2] = z.reshape(nz, 1, 1, 1, 1)
    out[..., 3:6] = sizes.reshape(1, 1, 1, ns, 1, 3)
    out[..., 6] = rotations.reshape(1, 1, 1, 1, nr)
    return out


# ---------------------------------------------------------------------------
# camera <-> lidar (reference: box_np_ops.py:643-698)
# ---------------------------------------------------------------------------


def camera_to_lidar(points, r_rect, velo2cam):
    if points.shape[-1] == 3:
        points = np.concatenate(
            [points, np.ones_like(points[..., :1])], axis=-1
        )
    lidar_points = points @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar_points[..., :3]


def projection_matrix_to_CRT_kitti(proj):
    """Decompose P = C @ [R|T] via QR (stable for KITTI projections)."""
    CR = proj[0:3, 0:3]
    CT = proj[0:3, 3]
    RinvCinv = np.linalg.inv(CR)
    Rinv, Cinv = np.linalg.qr(RinvCinv)
    C = np.linalg.inv(Cinv)
    R = np.linalg.inv(Rinv)
    T = Cinv @ CT
    return C, R, T


def get_frustum(bbox_image, C, near_clip=0.001, far_clip=100):
    """Camera-frame frustum corners [8, 3] for an image-plane bbox."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    z_points = np.array(
        [near_clip] * 4 + [far_clip] * 4, dtype=C.dtype
    )[:, np.newaxis]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]], dtype=C.dtype
    )
    near_box_corners = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype
    )
    far_box_corners = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype
    )
    ret_xy = np.concatenate([near_box_corners, far_box_corners], axis=0)
    return np.concatenate([ret_xy, z_points], axis=1)


def get_frustum_v2(bboxes, C, near_clip=0.001, far_clip=100):
    """Batched :func:`get_frustum`: [N, 4] image bboxes -> [N, 8, 3]
    camera-frame frustum corners (reference box_np_ops.py:541-559)."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    num_box = bboxes.shape[0]
    z_points = np.tile(
        np.array([near_clip] * 4 + [far_clip] * 4,
                 dtype=C.dtype)[np.newaxis, :, np.newaxis],
        [num_box, 1, 1])
    box_corners = bboxes[..., [0, 1, 0, 3, 2, 3, 2, 1]].reshape(-1, 4, 2)
    near_box_corners = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype)
    far_box_corners = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype)
    ret_xy = np.concatenate([near_box_corners, far_box_corners], axis=1)
    return np.concatenate([ret_xy, z_points], axis=-1)


def image_bboxes_to_lidar_frustums(bboxes, rect, Trv2c, P2,
                                   near_clip=0.001, far_clip=100):
    """[N, 4] image-plane bboxes -> [N, 8, 3] lidar-frame frustum
    corners (the camera-decompose + rotate + camera_to_lidar sequence
    shared by the reference's random_crop (core/preprocess.py:109-135)
    and reference_detections culling (data/preprocess.py:162-171))."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    frustums = get_frustum_v2(bboxes, C, near_clip, far_clip)
    frustums -= T
    frustums = np.einsum("ij, akj->aki", np.linalg.inv(R), frustums)
    return camera_to_lidar(frustums, rect, Trv2c)


def mask_points_in_corners(points, box_corners):
    """[P] x [N, 8, 3] -> bool [P, N] point-in-(frustum/box) mask."""
    surfaces = corner_to_surfaces_3d(box_corners)
    return geometry.points_in_convex_polygon_3d(points[:, :3], surfaces)


def remove_outside_points(points, rect, Trv2c, P2, image_shape):
    """Frustum-cull lidar points outside the camera image."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    image_bbox = [0, 0, image_shape[1], image_shape[0]]
    frustum = get_frustum(image_bbox, C)
    frustum -= T
    frustum = np.linalg.inv(R) @ frustum.T
    frustum = camera_to_lidar(frustum.T, rect, Trv2c)
    frustum_surfaces = corner_to_surfaces_3d(frustum[np.newaxis, ...])
    indices = geometry.points_in_convex_polygon_3d(points[:, :3], frustum_surfaces)
    return points[indices.reshape([-1])]


# ---------------------------------------------------------------------------
# IoU and point-in-box (reference: box_np_ops.py:696-760)
# ---------------------------------------------------------------------------


def iou(boxes, query_boxes, eps=1.0):
    """Axis-aligned [N, 4]x[K, 4] -> [N, K] IoU (xyxy, optional +eps area)."""
    boxes = np.asarray(boxes)
    query_boxes = np.asarray(query_boxes)
    if boxes.shape[0] * query_boxes.shape[0] >= 1 << 16:
        # large matrices: the C++ kernel avoids numpy's temporaries
        from ..native import host_ops

        return host_ops.iou_matrix(boxes, query_boxes, eps).astype(
            boxes.dtype)
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    ) + eps
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    ) + eps
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area1 = (boxes[:, 2] - boxes[:, 0] + eps) * (boxes[:, 3] - boxes[:, 1] + eps)
    area2 = (query_boxes[:, 2] - query_boxes[:, 0] + eps) * (
        query_boxes[:, 3] - query_boxes[:, 1] + eps
    )
    union = area1[:, None] + area2[None, :] - inter
    return np.where(inter > 0, inter / union, 0.0).astype(boxes.dtype)


def corner_to_surfaces_3d(corners):
    """[N, 8, 3] corners -> [N, 6, 4, 3] surfaces with inward normals."""
    idx = np.array(
        [
            [0, 1, 2, 3],
            [7, 6, 5, 4],
            [0, 3, 7, 4],
            [1, 5, 6, 2],
            [0, 4, 5, 1],
            [3, 2, 6, 7],
        ]
    )
    return corners[:, idx, :]


def points_in_rbbox(points, rbbox, z_axis=2, origin=(0.5, 0.5, 0.5)):
    """[num_points, num_boxes] bool membership of points in rotated boxes."""
    rbbox_corners = center_to_corner_box3d(
        rbbox[:, :3], rbbox[:, 3:6], rbbox[:, 6], origin=origin, axis=z_axis
    )
    surfaces = corner_to_surfaces_3d(rbbox_corners)
    return geometry.points_in_convex_polygon_3d(points[:, :3], surfaces)


def points_count_rbbox(points, rbbox, z_axis=2, origin=(0.5, 0.5, 0.5)):
    return points_in_rbbox(points, rbbox, z_axis=z_axis, origin=origin).sum(axis=0)


def distance_similarity(points, qpoints, dist_norm, with_rotation=False, rot_alpha=0.5):
    """Negated-distance similarity matrix [N, K] (reference
    box_np_ops.py:925-949): zero outside the dist_norm chebyshev window."""
    diff = points[:, None, :2] - qpoints[None, :, :2]
    window = np.all(np.abs(diff) <= dist_norm, axis=-1)
    dist = np.sum(diff**2, axis=-1)
    dist_normed = np.minimum(dist / dist_norm, dist_norm)
    if with_rotation:
        dist_rot = np.abs(np.sin(points[:, None, -1] - qpoints[None, :, -1]))
        sim = 1 - (1 - rot_alpha) * dist_normed - rot_alpha * dist_rot
    else:
        sim = 1 - dist_normed
    return np.where(window, sim, 0.0).astype(points.dtype)


# ---------------------------------------------------------------------------
# anchors mask via BEV summed-area table (reference: box_np_ops.py:908-947)
# ---------------------------------------------------------------------------


def sparse_sum_for_anchors_mask(coors, shape):
    """Scatter-count voxel coords into a dense [H, W] BEV occupancy map.

    coors: [V, 3] zyx int coords.
    """
    ret = np.zeros(shape, dtype=np.float32)
    np.add.at(ret, (coors[:, 1], coors[:, 2]), 1)
    return ret


def fused_get_anchors_area(dense_map, anchors_bv, stride, offset, grid_size):
    """Occupied-voxel count under each anchor's BEV footprint.

    dense_map: [H, W] cumsum'd (both axes) occupancy. anchors_bv: [N, 4]
    xyxy metric. Uses the summed-area identity ID - IB - IC + IA.
    """
    c0 = np.clip(
        np.floor((anchors_bv[:, 0] - offset[0]) / stride[0]).astype(np.int64),
        0, None)
    c1 = np.clip(
        np.floor((anchors_bv[:, 1] - offset[1]) / stride[1]).astype(np.int64),
        0, None)
    # upstream's numba kernel leaves the max corners unclamped below 0 and
    # silently wraps on negative indices; clamp instead (anchors fully
    # outside the grid then read a zero-area table cell)
    c2 = np.clip(
        np.floor((anchors_bv[:, 2] - offset[0]) / stride[0]).astype(np.int64),
        0, grid_size[0] - 1)
    c3 = np.clip(
        np.floor((anchors_bv[:, 3] - offset[1]) / stride[1]).astype(np.int64),
        0, grid_size[1] - 1)
    ID = dense_map[c3, c2]
    IA = dense_map[c1, c0]
    IB = dense_map[c3, c0]
    IC = dense_map[c1, c2]
    return ID - IB - IC + IA
