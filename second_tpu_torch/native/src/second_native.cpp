// Native host kernels of second_tpu_torch (the port's copy of the JAX
// package's host library, less its banded planner).
//
// Replaces the reference's numba-JIT CPU hot loops and the external spconv
// C++ voxelizer and rulebook builder:
//   * compute_statistics / fused_compute_statistics: the sequential
//     greedy TP/FP matcher of the official KITTI evaluator
//     (reference second/utils/eval.py:182-341).
//   * points_to_voxel: first-come-first-serve voxelization
//     (reference spconv VoxelGeneratorV2 semantics, called from
//     second/data/preprocess.py:302-315).
//   * pad_points: the flat pillar path's range filter and padding.
//   * iou_matrix, noise_per_box: the augmentation's hot loops.
//   * subm_plan, down_plan: the sparse-conv rulebooks.
//
// Build: g++ -O3 -shared -fPIC (see second_tpu_torch/native/build.py).
// Plain C ABI so ctypes can bind without pybind11.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KITTI eval matcher
// ---------------------------------------------------------------------------

static const double NO_DETECTION = -10000000.0;

// image-plane overlap of one dt bbox against one dc bbox, criterion 0
// (intersection / dt area), KITTI convention without +1.
static double dt_dc_overlap(const double* dt_bbox, const double* dc_bbox) {
  double iw = std::fmin(dt_bbox[2], dc_bbox[2]) -
              std::fmax(dt_bbox[0], dc_bbox[0]);
  if (iw <= 0) return 0.0;
  double ih = std::fmin(dt_bbox[3], dc_bbox[3]) -
              std::fmax(dt_bbox[1], dc_bbox[1]);
  if (ih <= 0) return 0.0;
  double area = (dt_bbox[2] - dt_bbox[0]) * (dt_bbox[3] - dt_bbox[1]);
  if (area == 0) return 0.0;
  return iw * ih / area;
}

// One image, one threshold. overlaps is [num_dt, num_gt] row-major.
// gt_datas: [num_gt, 5] (bbox, alpha); dt_datas: [num_dt, 6]
// (bbox, alpha, score). Outputs: counts[3] = tp, fp, fn; similarity;
// thresholds buffer (size >= num_gt) + count.
void compute_statistics(const double* overlaps, int64_t num_dt,
                        int64_t num_gt, const double* gt_datas,
                        const double* dt_datas, const int64_t* ignored_gt,
                        const int64_t* ignored_det, const double* dc_bboxes,
                        int64_t num_dc, int64_t metric, double min_overlap,
                        double thresh, int64_t compute_fp,
                        int64_t compute_aos, int64_t* counts,
                        double* similarity, double* out_thresholds,
                        int64_t* out_num_thresholds) {
  std::vector<char> assigned(num_dt, 0);
  std::vector<char> ignored_threshold(num_dt, 0);
  if (compute_fp) {
    for (int64_t i = 0; i < num_dt; ++i) {
      if (dt_datas[i * 6 + 5] < thresh) ignored_threshold[i] = 1;
    }
  }
  int64_t tp = 0, fp = 0, fn = 0;
  double sim = 0.0;
  std::vector<double> delta;
  delta.reserve(num_gt);
  int64_t thresh_idx = 0;

  for (int64_t i = 0; i < num_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int64_t j = 0; j < num_dt; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
        continue;
      double overlap = overlaps[j * num_gt + i];
      double dt_score = dt_datas[j * 6 + 5];
      if (!compute_fp && overlap > min_overlap &&
          dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == NO_DETECTION && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != NO_DETECTION &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != NO_DETECTION) {
      tp += 1;
      out_thresholds[thresh_idx++] = dt_datas[det_idx * 6 + 5];
      if (compute_aos) {
        delta.push_back(gt_datas[i * 5 + 4] - dt_datas[det_idx * 6 + 4]);
      }
      assigned[det_idx] = 1;
    }
  }
  if (compute_fp) {
    for (int64_t j = 0; j < num_dt; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j]))
        fp += 1;
    }
    int64_t nstuff = 0;
    if (metric == 0 && num_dc > 0) {
      for (int64_t i = 0; i < num_dc; ++i) {
        for (int64_t j = 0; j < num_dt; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ignored_threshold[j])
            continue;
          if (dt_dc_overlap(&dt_datas[j * 6], &dc_bboxes[i * 4]) >
              min_overlap) {
            assigned[j] = 1;
            nstuff += 1;
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      if (tp > 0 || fp > 0) {
        sim = 0.0;
        for (double d : delta) sim += (1.0 + std::cos(d)) / 2.0;
      } else {
        sim = -1.0;
      }
    }
  }
  counts[0] = tp;
  counts[1] = fp;
  counts[2] = fn;
  *similarity = sim;
  *out_num_thresholds = thresh_idx;
}

// One image across all thresholds; accumulates into pr [num_thresh, 4].
void fused_compute_statistics(const double* overlaps, int64_t num_dt,
                              int64_t num_gt, const double* gt_datas,
                              const double* dt_datas,
                              const int64_t* ignored_gt,
                              const int64_t* ignored_det,
                              const double* dc_bboxes, int64_t num_dc,
                              int64_t metric, double min_overlap,
                              const double* thresholds, int64_t num_thresh,
                              int64_t compute_aos, double* pr) {
  std::vector<double> th_buf(num_gt > 0 ? num_gt : 1);
  for (int64_t t = 0; t < num_thresh; ++t) {
    int64_t counts[3];
    double sim;
    int64_t nth;
    compute_statistics(overlaps, num_dt, num_gt, gt_datas, dt_datas,
                       ignored_gt, ignored_det, dc_bboxes, num_dc, metric,
                       min_overlap, thresholds[t], 1, compute_aos, counts,
                       &sim, th_buf.data(), &nth);
    pr[t * 4 + 0] += counts[0];
    pr[t * 4 + 1] += counts[1];
    pr[t * 4 + 2] += counts[2];
    if (sim != -1.0) pr[t * 4 + 3] += sim;
  }
}

// ---------------------------------------------------------------------------
// FCFS voxelizer
// ---------------------------------------------------------------------------

// coor_to_voxelidx: workspace [nz*ny*nx] pre-filled with -1 on first use;
// this function restores touched entries before returning.
// Returns number of voxels produced (<= max_voxels). Voxels beyond
// max_voxels and points beyond max_points are dropped (FCFS).
int64_t points_to_voxel(const float* points, int64_t num_points,
                        int64_t num_features, const float* voxel_size,
                        const float* coors_range, int64_t max_points,
                        int64_t max_voxels, int64_t nx, int64_t ny,
                        int64_t nz, float* voxels, int32_t* coors,
                        int32_t* num_points_per_voxel,
                        int32_t* coor_to_voxelidx) {
  int64_t voxel_num = 0;
  for (int64_t p = 0; p < num_points; ++p) {
    const float* pt = &points[p * num_features];
    int64_t cx = (int64_t)std::floor((pt[0] - coors_range[0]) / voxel_size[0]);
    int64_t cy = (int64_t)std::floor((pt[1] - coors_range[1]) / voxel_size[1]);
    int64_t cz = (int64_t)std::floor((pt[2] - coors_range[2]) / voxel_size[2]);
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
      continue;
    int64_t lin = cz * (ny * nx) + cy * nx + cx;
    int32_t vid = coor_to_voxelidx[lin];
    if (vid == -1) {
      if (voxel_num >= max_voxels) continue;
      vid = (int32_t)voxel_num++;
      coor_to_voxelidx[lin] = vid;
      coors[vid * 3 + 0] = (int32_t)cz;
      coors[vid * 3 + 1] = (int32_t)cy;
      coors[vid * 3 + 2] = (int32_t)cx;
      num_points_per_voxel[vid] = 0;
    }
    int32_t n = num_points_per_voxel[vid];
    if (n < max_points) {
      std::memcpy(&voxels[(vid * max_points + n) * num_features], pt,
                  sizeof(float) * num_features);
      num_points_per_voxel[vid] = n + 1;
    }
  }
  // restore workspace
  for (int64_t v = 0; v < voxel_num; ++v) {
    int64_t cz = coors[v * 3 + 0], cy = coors[v * 3 + 1],
            cx = coors[v * 3 + 2];
    coor_to_voxelidx[cz * (ny * nx) + cy * nx + cx] = -1;
  }
  return voxel_num;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// range filter + padding of the flat pillar path's point buffer
// ---------------------------------------------------------------------------

// One pass over points [n, f]: a row is kept when lo <= xyz < hi on all
// three axes, compared in Cmp (NaN fails every comparison, so it is
// dropped; the & keeps the six tests free of branches). Kept rows are
// copied in order into out [capacity, f] until it is full; the count runs
// on. The rows past the copied ones are zeroed. Returns the in-range count.
template <typename In, typename Cmp, typename Out>
static int64_t pad_rows(const In* points, int64_t n, int64_t f,
                        const double* range, Out* out, int64_t capacity) {
  const Cmp lo0 = (Cmp)range[0], lo1 = (Cmp)range[1], lo2 = (Cmp)range[2];
  const Cmp hi0 = (Cmp)range[3], hi1 = (Cmp)range[4], hi2 = (Cmp)range[5];
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    const In* p = points + i * f;
    const Cmp x = p[0], y = p[1], z = p[2];
    const bool in = (x >= lo0) & (x < hi0) & (y >= lo1) & (y < hi1) &
                    (z >= lo2) & (z < hi2);
    if (!in) continue;
    if (kept < capacity) {
      Out* o = out + kept * f;
      for (int64_t j = 0; j < f; ++j) o[j] = (Out)p[j];
    }
    ++kept;
  }
  const int64_t rows = std::min(kept, capacity);
  std::memset(out + rows * f, 0, sizeof(Out) * (capacity - rows) * f);
  return kept;
}

template <typename In, typename Cmp>
static int64_t pad_rows_to(const In* points, int64_t n, int64_t f,
                           const double* range, void* out, int32_t out_f64,
                           int64_t capacity) {
  if (out_f64)
    return pad_rows<In, Cmp, double>(points, n, f, range, (double*)out,
                                     capacity);
  return pad_rows<In, Cmp, float>(points, n, f, range, (float*)out, capacity);
}

extern "C" {

// points [n, f >= 3] float32 (in_f64 = 0) or float64 rows; range [6] the
// (x, y, z) minima then maxima; cmp_f64 compares in double, else in float
// (float rows only); out [capacity, f] float32 or float64 (out_f64).
int64_t pad_points(const void* points, int64_t n, int64_t f, int32_t in_f64,
                   const double* range, int32_t cmp_f64, void* out,
                   int32_t out_f64, int64_t capacity) {
  if (in_f64)
    return pad_rows_to<double, double>((const double*)points, n, f, range,
                                       out, out_f64, capacity);
  if (cmp_f64)
    return pad_rows_to<float, double>((const float*)points, n, f, range, out,
                                      out_f64, capacity);
  return pad_rows_to<float, float>((const float*)points, n, f, range, out,
                                   out_f64, capacity);
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// axis-aligned IoU matrix (reference box_np_ops.iou_jit, numba)
// ---------------------------------------------------------------------------

void iou_matrix(const double* boxes, int64_t n, const double* query,
                int64_t k, double eps, double* out) {
  for (int64_t j = 0; j < k; ++j) {
    double qarea = (query[j * 4 + 2] - query[j * 4 + 0] + eps) *
                   (query[j * 4 + 3] - query[j * 4 + 1] + eps);
    for (int64_t i = 0; i < n; ++i) {
      const double* b = &boxes[i * 4];
      double iw = std::fmin(b[2], query[j * 4 + 2]) -
                  std::fmax(b[0], query[j * 4 + 0]) + eps;
      double v = 0.0;
      if (iw > 0) {
        double ih = std::fmin(b[3], query[j * 4 + 3]) -
                    std::fmax(b[1], query[j * 4 + 1]) + eps;
        if (ih > 0) {
          double ua =
              (b[2] - b[0] + eps) * (b[3] - b[1] + eps) + qarea - iw * ih;
          v = iw * ih / ua;
        }
      }
      out[i * k + j] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// per-object noise search (reference numba noise_per_box,
// core/preprocess.py:245-273) with rotated-rect collision testing
// ---------------------------------------------------------------------------

struct Quad {
  double x[4];
  double y[4];
};

static void box_to_quad(double cx, double cy, double w, double l, double ang,
                        Quad* q) {
  // ring order matching core.rotated_iou.box_to_corners
  static const double DX[4] = {-0.5, -0.5, 0.5, 0.5};
  static const double DY[4] = {-0.5, 0.5, 0.5, -0.5};
  double c = std::cos(ang), s = std::sin(ang);
  for (int k = 0; k < 4; ++k) {
    double dx = DX[k] * w, dy = DY[k] * l;
    q->x[k] = dx * c + dy * s + cx;
    q->y[k] = -dx * s + dy * c + cy;
  }
}

static bool point_in_quad(double px, double py, const Quad* q) {
  // inclusive projection test on the rectangle's edge basis
  double abx = q->x[1] - q->x[0], aby = q->y[1] - q->y[0];
  double adx = q->x[3] - q->x[0], ady = q->y[3] - q->y[0];
  double apx = px - q->x[0], apy = py - q->y[0];
  double dab = apx * abx + apy * aby;
  double dad = apx * adx + apy * ady;
  return dab >= 0 && dab <= abx * abx + aby * aby && dad >= 0 &&
         dad <= adx * adx + ady * ady;
}

static bool segs_intersect(double ax, double ay, double bx, double by,
                           double cx, double cy, double dx, double dy) {
  auto ccw = [](double px, double py, double qx, double qy, double rx,
                double ry) {
    return (ry - py) * (qx - px) > (qy - py) * (rx - px);
  };
  return ccw(ax, ay, cx, cy, dx, dy) != ccw(bx, by, cx, cy, dx, dy) &&
         ccw(ax, ay, bx, by, cx, cy) != ccw(ax, ay, bx, by, dx, dy);
}

static bool quads_collide(const Quad* a, const Quad* b) {
  // standup gate
  double aminx = a->x[0], amaxx = a->x[0], aminy = a->y[0], amaxy = a->y[0];
  double bminx = b->x[0], bmaxx = b->x[0], bminy = b->y[0], bmaxy = b->y[0];
  for (int k = 1; k < 4; ++k) {
    aminx = std::fmin(aminx, a->x[k]); amaxx = std::fmax(amaxx, a->x[k]);
    aminy = std::fmin(aminy, a->y[k]); amaxy = std::fmax(amaxy, a->y[k]);
    bminx = std::fmin(bminx, b->x[k]); bmaxx = std::fmax(bmaxx, b->x[k]);
    bminy = std::fmin(bminy, b->y[k]); bmaxy = std::fmax(bmaxy, b->y[k]);
  }
  if (amaxx < bminx || bmaxx < aminx || amaxy < bminy || bmaxy < aminy)
    return false;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      if (segs_intersect(a->x[i], a->y[i], a->x[(i + 1) % 4],
                         a->y[(i + 1) % 4], b->x[j], b->y[j],
                         b->x[(j + 1) % 4], b->y[(j + 1) % 4]))
        return true;
  if (point_in_quad(b->x[0], b->y[0], a)) return true;
  if (point_in_quad(a->x[0], a->y[0], b)) return true;
  return false;
}

// boxes_bv: [N, 5] (x, y, w, l, ang); loc_noises [N, M, 3];
// rot_noises [N, M]; valid [N] bytes. Writes success [N] (try idx or -1).
void noise_per_box(const double* boxes_bv, int64_t n, int64_t m,
                   const uint8_t* valid, const double* loc_noises,
                   const double* rot_noises, int64_t* success) {
  std::vector<Quad> current(n);
  for (int64_t i = 0; i < n; ++i) {
    const double* b = &boxes_bv[i * 5];
    box_to_quad(b[0], b[1], b[2], b[3], b[4], &current[i]);
    success[i] = -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const double* b = &boxes_bv[i * 5];
    for (int64_t t = 0; t < m; ++t) {
      Quad cand;
      box_to_quad(b[0] + loc_noises[(i * m + t) * 3 + 0],
                  b[1] + loc_noises[(i * m + t) * 3 + 1], b[2], b[3],
                  b[4] + rot_noises[i * m + t], &cand);
      bool coll = false;
      for (int64_t j = 0; j < n && !coll; ++j) {
        if (j == i) continue;
        coll = quads_collide(&cand, &current[j]);
      }
      if (!coll) {
        success[i] = t;
        current[i] = cand;
        break;
      }
    }
  }
}

}  // extern "C"
// ---------------------------------------------------------------------------
// Host-side sparse-convolution planning (the reference's spconv builds its
// rulebooks on CPU per call; we do the same so the TPU program is pure
// gather-GEMMs with no device-side hash/sort work).
//
// Both the active set and every per-offset query sequence are sorted by
// linearized coordinate, so all lookups are two-pointer merges — no hash
// tables, ~2ns per query.
// ---------------------------------------------------------------------------

extern "C" {

// Submanifold-conv neighbor slots.
// coords: [v_cap, 3] int32 zyx SORTED by linear id, -1 padding rows last.
// offsets: [k, 3] int32 CENTERED neighbor offsets (coord + off).
// slots out: [v_cap, k] int32; miss / padding row -> v_cap (zero dump row).
void subm_plan(const int32_t* coords, int64_t v_cap,
               int64_t d, int64_t h, int64_t w,
               const int32_t* offsets, int64_t k,
               int32_t* slots) {
  const int32_t miss = (int32_t)v_cap;
  const int64_t hw = h * w;
  int64_t n = 0;
  std::vector<int64_t> lin(v_cap);
  for (; n < v_cap && coords[n * 3] >= 0; ++n) {
    lin[n] = (int64_t)coords[n * 3] * hw +
             (int64_t)coords[n * 3 + 1] * w + coords[n * 3 + 2];
  }
  std::vector<int64_t> dlin(k);
  for (int64_t j = 0; j < k; ++j) {
    dlin[j] = (int64_t)offsets[j * 3] * hw +
              (int64_t)offsets[j * 3 + 1] * w + offsets[j * 3 + 2];
  }
  // Centered full-cube offsets are antisymmetric (offs[j] ==
  // -offs[k-1-j], center == 0): a hit slots[i, j] = t implies the
  // mirrored hit slots[t, k-1-j] = i, so only the lower half of the
  // offsets needs the merge.
  bool symmetric = (k % 2) == 1;
  for (int64_t j = 0; symmetric && j < k; ++j) {
    symmetric = offsets[j * 3] == -offsets[(k - 1 - j) * 3] &&
                offsets[j * 3 + 1] == -offsets[(k - 1 - j) * 3 + 1] &&
                offsets[j * 3 + 2] == -offsets[(k - 1 - j) * 3 + 2];
  }
  if (symmetric) {
    for (int64_t i = 0; i < v_cap * k; ++i) slots[i] = miss;
    const int64_t half = k / 2;
    std::vector<int64_t> ti(half, 0);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t z0 = coords[i * 3], y0 = coords[i * 3 + 1],
                    x0 = coords[i * 3 + 2];
      const int64_t li = lin[i];
      int32_t* row = slots + i * k;
      row[half] = (int32_t)i;  // center offset is the row itself
      for (int64_t j = 0; j < half; ++j) {
        const int64_t z = z0 + offsets[j * 3],
                      y = y0 + offsets[j * 3 + 1],
                      x = x0 + offsets[j * 3 + 2];
        if (z < 0 || y < 0 || x < 0 || z >= d || y >= h || x >= w)
          continue;
        const int64_t q = li + dlin[j];  // increasing over valid i
        int64_t t = ti[j];
        while (t < n && lin[t] < q) ++t;
        ti[j] = t;
        if (t < n && lin[t] == q) {
          row[j] = (int32_t)t;
          slots[t * k + (k - 1 - j)] = (int32_t)i;
        }
      }
    }
    return;
  }
  for (int64_t i = n * k; i < v_cap * k; ++i) slots[i] = miss;
  // i-outer / j-inner keeps the slot writes contiguous; one monotone
  // merge cursor per kernel offset
  std::vector<int64_t> ti(k, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t z0 = coords[i * 3], y0 = coords[i * 3 + 1],
                  x0 = coords[i * 3 + 2];
    const int64_t li = lin[i];
    int32_t* row = slots + i * k;
    for (int64_t j = 0; j < k; ++j) {
      const int64_t z = z0 + offsets[j * 3], y = y0 + offsets[j * 3 + 1],
                    x = x0 + offsets[j * 3 + 2];
      if (z < 0 || y < 0 || x < 0 || z >= d || y >= h || x >= w) {
        row[j] = miss;
        continue;
      }
      const int64_t q = li + dlin[j];  // strictly increasing over valid i
      int64_t t = ti[j];
      while (t < n && lin[t] < q) ++t;
      ti[j] = t;
      row[j] = (t < n && lin[t] == q) ? (int32_t)t : miss;
    }
  }
}

// Strided-conv output active set + input gather slots.
// coords: [v_cap, 3] input (sorted by lin, -1 pad last). offsets: [k, 3]
// UNCENTERED kernel offsets (input = out*stride - pad + off).
// out_coords: [out_cap, 3] (-1 pad), conv_slots: [out_cap, k]
// (miss -> v_cap). Output active set = every in-bounds position whose
// kernel window touches an input voxel, sorted by linear id; overflow
// beyond out_cap drops the HIGHEST ids (matches
// ops/sparse.downsample_active_set). Returns the pre-truncation count.
int64_t down_plan(const int32_t* coords, int64_t v_cap,
                  int64_t d, int64_t h, int64_t w,
                  int64_t kz, int64_t ky, int64_t kx,
                  int64_t sz, int64_t sy, int64_t sx,
                  int64_t pz, int64_t py, int64_t px,
                  const int32_t* offsets, int64_t k,
                  int64_t out_cap,
                  int32_t* out_coords, int32_t* conv_slots) {
  const int64_t od = (d + 2 * pz - kz) / sz + 1;
  const int64_t oh = (h + 2 * py - ky) / sy + 1;
  const int64_t ow = (w + 2 * px - kx) / sx + 1;
  const int64_t ohw = oh * ow;
  const int64_t hw = h * w;
  const int32_t miss = (int32_t)v_cap;

  int64_t n = 0;
  std::vector<int64_t> lin(v_cap);
  for (; n < v_cap && coords[n * 3] >= 0; ++n) {
    lin[n] = (int64_t)coords[n * 3] * hw +
             (int64_t)coords[n * 3 + 1] * w + coords[n * 3 + 2];
  }

  auto ceil_div = [](int64_t a, int64_t b) {
    return a >= 0 ? (a + b - 1) / b : -((-a) / b);
  };
  // Mark candidate outputs in a bitmap over the output grid, then scan
  // set bits in order: sorted + deduped for free, O(n*8 + grid/64) —
  // the candidate sort this replaces dominated the planner.
  const int64_t ncells = od * ohw;
  std::vector<uint64_t> bitmap((ncells + 63) / 64, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t z = coords[i * 3], y = coords[i * 3 + 1],
                  x = coords[i * 3 + 2];
    const int64_t oz0 = std::max<int64_t>(ceil_div(z + pz - kz + 1, sz), 0);
    const int64_t oz1 = std::min((z + pz) / sz, od - 1);
    const int64_t oy0 = std::max<int64_t>(ceil_div(y + py - ky + 1, sy), 0);
    const int64_t oy1 = std::min((y + py) / sy, oh - 1);
    const int64_t ox0 = std::max<int64_t>(ceil_div(x + px - kx + 1, sx), 0);
    const int64_t ox1 = std::min((x + px) / sx, ow - 1);
    for (int64_t oz = oz0; oz <= oz1; ++oz)
      for (int64_t oy = oy0; oy <= oy1; ++oy) {
        const int64_t base = oz * ohw + oy * ow;
        for (int64_t ox = ox0; ox <= ox1; ++ox) {
          const int64_t lin2 = base + ox;
          bitmap[lin2 >> 6] |= (uint64_t)1 << (lin2 & 63);
        }
      }
  }
  int64_t total = 0, kept = 0;
  for (size_t wi = 0; wi < bitmap.size(); ++wi) {
    uint64_t bits = bitmap[wi];
    while (bits) {
      const int64_t olin = ((int64_t)wi << 6) + __builtin_ctzll(bits);
      bits &= bits - 1;
      if (total < out_cap) {
        out_coords[total * 3] = (int32_t)(olin / ohw);
        out_coords[total * 3 + 1] = (int32_t)((olin % ohw) / ow);
        out_coords[total * 3 + 2] = (int32_t)(olin % ow);
      }
      ++total;
    }
  }
  kept = std::min(total, out_cap);
  for (int64_t o = kept; o < out_cap; ++o) {
    out_coords[o * 3] = out_coords[o * 3 + 1] = out_coords[o * 3 + 2] = -1;
    for (int64_t j = 0; j < k; ++j) conv_slots[o * k + j] = miss;
  }
  // conv slots: for a fixed kernel offset the input ids are strictly
  // increasing over the sorted outputs -> two-pointer merge per offset;
  // o-outer / j-inner keeps the writes contiguous
  std::vector<int64_t> ti(k, 0);
  for (int64_t o = 0; o < kept; ++o) {
    const int64_t bz = (int64_t)out_coords[o * 3] * sz - pz;
    const int64_t by = (int64_t)out_coords[o * 3 + 1] * sy - py;
    const int64_t bx = (int64_t)out_coords[o * 3 + 2] * sx - px;
    int32_t* row = conv_slots + o * k;
    for (int64_t j = 0; j < k; ++j) {
      const int64_t iz = bz + offsets[j * 3];
      const int64_t iy = by + offsets[j * 3 + 1];
      const int64_t ix = bx + offsets[j * 3 + 2];
      if (iz < 0 || iy < 0 || ix < 0 || iz >= d || iy >= h || ix >= w) {
        row[j] = miss;
        continue;
      }
      const int64_t q = iz * hw + iy * w + ix;
      int64_t t = ti[j];
      while (t < n && lin[t] < q) ++t;
      ti[j] = t;
      row[j] = (t < n && lin[t] == q) ? (int32_t)t : miss;
    }
  }
  return total;
}

}  // extern "C"
