"""Vectorized host-side computational geometry (numpy).

Semantics match second/core/geometry.py in the reference (which uses
numba jit loops); everything here is vectorized numpy so no JIT compiler
is needed on the host.  Convention notes (pinned by the reference):

  * ``surface_equ_3d`` (reference second/core/geometry.py:84-95): for a
    surface with vertices (p0, p1, p2, ...), normal = cross(p0 - p1,
    p1 - p2), plane offset d = -normal . p0; a point is INSIDE the
    convex polyhedron iff normal . p + d < 0 for every surface (surfaces
    are wound so normals point inward, see
    box_ops.corner_to_surfaces_3d).
  * 2D point-in-polygon (reference second/core/geometry.py:273-330):
    clockwise polygons, point inside iff every cross(edge, vertex-point)
    is < 0 ... with the jit version using ``cross >= 0 -> outside``.
"""

import numpy as np


def surface_equ_3d(polygon_surfaces):
    """Plane equations for polygon surfaces.

    Args:
        polygon_surfaces: [num_polygon, num_surfaces, num_pts>=3, 3].

    Returns:
        normal_vec: [num_polygon, num_surfaces, 3]
        d: [num_polygon, num_surfaces] such that plane is n.x + d = 0.
    """
    sv0 = polygon_surfaces[:, :, 0, :] - polygon_surfaces[:, :, 1, :]
    sv1 = polygon_surfaces[:, :, 1, :] - polygon_surfaces[:, :, 2, :]
    normal_vec = np.cross(sv0, sv1)
    d = -np.einsum("asd,asd->as", normal_vec, polygon_surfaces[:, :, 0, :])
    return normal_vec, d


def points_in_convex_polygon_3d(points, polygon_surfaces, num_surfaces=None):
    """Check which points fall inside which convex polyhedra.

    Args:
        points: [num_points, 3].
        polygon_surfaces: [num_polygon, max_num_surfaces, max_pts, 3],
            surface normals must point inward.
        num_surfaces: [num_polygon] number of valid surfaces per polygon.

    Returns:
        [num_points, num_polygon] bool.
    """
    num_polygons, max_num_surfaces = polygon_surfaces.shape[:2]
    normal_vec, d = surface_equ_3d(polygon_surfaces[:, :, :3, :])
    # sign[i, j, k] = n_jk . p_i + d_jk ; inside iff all signs < 0
    sign = np.einsum("pd,jsd->pjs", points[:, :3], normal_vec) + d[np.newaxis]
    if num_surfaces is not None:
        surf_ids = np.arange(max_num_surfaces)
        valid = surf_ids[np.newaxis, np.newaxis, :] < num_surfaces.reshape(1, -1, 1)
        sign = np.where(valid, sign, -1.0)
    return np.all(sign < 0, axis=-1)
