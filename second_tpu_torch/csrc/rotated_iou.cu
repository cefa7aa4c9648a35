// K3: pairwise rotated-rectangle IoU, [N, 5] x [M, 5] -> [N, M], fp32.
//
// Replaces the Pallas TPU kernel second_tpu/ops/pallas_iou.py
// `rotated_iou_matrix_pallas` (body `_iou_kernel`), with the same
// clipping arithmetic: boxes are (x, y, w, l, angle); the intersection
// area comes from Green's theorem over each box's edges clipped to the
// other box (Liang-Barsky), with no sort. An edge exactly on a clip
// plane is kept by the first box only when both run the same way
// (identical boxes count once), and by both when they run opposite ways
// (touching boxes cancel). A union <= 0 divides by 1.
//
// One change of frame: each pair is computed relative to the centre of
// its first box. The Pallas kernel works in scene coordinates, where at
// 70 m from the sensor the cross terms of the Green's sum reach ~1e3 and
// fp32 cancellation moves the IoU by up to ~3e-3, enough to flip NMS
// decisions at car.fhd's 0.01 threshold; centred, the terms stay at the
// boxes' own size.
//
// What bounds it on the card: arithmetic, and only for the pairs that
// can overlap. The clipping costs about 400 operations and 32 IEEE
// divisions (subroutines of several instructions each) per pair, yet
// NMS candidates spread over a 70 x 80 m scene are mostly far apart and
// their IoU is exactly 0. A tile is 32 rows strided by the grid's
// height (rows y, y + G, ...) by 32 consecutive columns: boxes close in
// rank and in space (near-tied scores keep anchor order) then spread
// their overlapping pairs over many tiles instead of piling them into
// the diagonal ones, while each warp still writes 32 consecutive
// floats. Three steps per tile (256 threads, 4 pairs each):
//   1. the centred corners, outward half-planes, area and circumradius
//      of the tile's 32 + 32 boxes, once each, into shared memory;
//   2. `far_pair`: a pair whose centres lie farther apart than the sum
//      of the circumradii (with a relative margin of 2^-10, far beyond
//      fp32 rounding) writes 0.0; the Python twin
//      `ops/cuda_iou.far_pairs` holds the same arithmetic, and the CPU
//      tests check that the full arithmetic gives exactly 0.0 on every
//      pair it rejects. Boxes with a side under 2^-10 are never
//      rejected: a box of zero size has only trivial half-planes and
//      scores IoU = area of the other box wherever it lies;
//   3. the survivors are compacted into a list in shared memory (one
//      ballot and one shared atomic per warp) and the threads take
//      them from the list, so whole warps run `pair_iou` together
//      instead of diverging pair by pair. The list's order
//      varies from run to run; the values do not, since each pair is
//      computed alone by the same code.
// Built with -fmad=false: the boundary rules test products for exact
// zero, which a fused multiply-add would break, and `far_pair` must
// round as its Python twin does.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;                    // boxes per side of a tile
constexpr int THREADS = 256;
constexpr int PAIRS_PER_THREAD = TILE * TILE / THREADS;
constexpr float FAR_SCALE = 1.0f + 0x1p-10f;  // as ops/cuda_iou.py
constexpr float SIZE_MIN = 0x1p-10f;

// One box in its own frame: corners and outward half-planes relative
// to its centre.
struct BoxGeom {
  float x, y;                // centre
  float cx[4], cy[4];        // corners in ring order, centre-relative
  float nx[4], ny[4], d[4];  // outward half-planes n.p <= d, centre-relative
  float area;
  float radius;  // circumradius, 0.5 * sqrt(w^2 + l^2)
  bool sized;    // both sides >= SIZE_MIN: the reject may apply
};

__device__ void box_geom(const float* __restrict__ b, BoxGeom* g) {
  const float DX[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  const float DY[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
  const float w = b[2], l = b[3], r = b[4];
  const float c = cosf(r), s = sinf(r);
  g->x = b[0];
  g->y = b[1];
  for (int k = 0; k < 4; ++k) {
    const float dx = DX[k] * w;
    const float dy = DY[k] * l;
    g->cx[k] = dx * c + dy * s;
    g->cy[k] = -dx * s + dy * c;
  }
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    float nx = -(g->cy[k2] - g->cy[k]);
    float ny = g->cx[k2] - g->cx[k];
    if (nx * -g->cx[k] + ny * -g->cy[k] > 0.f) {  // point at the centre
      nx = -nx;
      ny = -ny;
    }
    g->nx[k] = nx;
    g->ny[k] = ny;
    g->d[k] = nx * g->cx[k] + ny * g->cy[k];
  }
  g->area = w * l;
  g->radius = 0.5f * sqrtf(w * w + l * l);
  g->sized = w >= SIZE_MIN && l >= SIZE_MIN;
}

// True when the two boxes cannot intersect: their circumcircles, grown
// by FAR_SCALE, are apart. Mirrors ops/cuda_iou.py `far_pairs`.
__device__ bool far_pair(const BoxGeom& a, const BoxGeom& b) {
  const float dx = b.x - a.x, dy = b.y - a.y;
  const float reach = (a.radius + b.radius) * FAR_SCALE;
  return a.sized && b.sized && dx * dx + dy * dy > reach * reach;
}

// Sum over the subject's edges (corners px, py) of cross(P, Q) of each
// edge clipped to the half-planes (nx, ny, d) of the other box.
__device__ float edge_contrib(const float* px_, const float* py_,
                              const float* nx_, const float* ny_,
                              const float* d_, bool keep_boundary) {
  const float big = 1e30f;
  float total = 0.f;
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    const float px = px_[k], py = py_[k];
    const float rx = px_[k2] - px;
    const float ry = py_[k2] - py;
    float t0 = 0.f, t1 = 1.f;
    bool par_out = false;
    for (int p = 0; p < 4; ++p) {
      const float nx = nx_[p], ny = ny_[p];
      const float denom = rx * nx + ry * ny;
      const float numer = d_[p] - (px * nx + py * ny);
      const float t_of = numer / (denom == 0.f ? 1.f : denom);
      t1 = fminf(t1, denom > 0.f ? t_of : big);
      t0 = fmaxf(t0, denom < 0.f ? t_of : -big);
      if (keep_boundary) {
        par_out = par_out || (denom == 0.f && numer < 0.f);
      } else {
        const bool same_dir = (rx * ny - ry * nx) > 0.f;
        par_out = par_out ||
                  (denom == 0.f && (numer < 0.f || (numer == 0.f && same_dir)));
      }
    }
    if (t0 <= t1 && !par_out) {
      const float pcx = px + t0 * rx, pcy = py + t0 * ry;
      const float qcx = px + t1 * rx, qcy = py + t1 * ry;
      total += pcx * qcy - pcy * qcx;
    }
  }
  return total;
}

__device__ float pair_iou(const BoxGeom& a, const BoxGeom& b) {
  // work in a frame centred on box a: box b moves by (ox, oy), its
  // half-plane offsets by n.o
  const float ox = b.x - a.x, oy = b.y - a.y;
  float bx[4], by[4], bd[4];
  for (int k = 0; k < 4; ++k) {
    bx[k] = b.cx[k] + ox;
    by[k] = b.cy[k] + oy;
    bd[k] = b.d[k] + (b.nx[k] * ox + b.ny[k] * oy);
  }
  const float s = edge_contrib(a.cx, a.cy, b.nx, b.ny, bd, true) +
                  edge_contrib(bx, by, a.nx, a.ny, a.d, false);
  const float inter = 0.5f * fabsf(s);
  const float uni = a.area + b.area - inter;
  return inter / (uni <= 0.f ? 1.f : uni);
}

__global__ void __launch_bounds__(THREADS)
rotated_iou_kernel(const float* __restrict__ boxes1,
                   const float* __restrict__ boxes2,
                   float* __restrict__ out, int n, int m) {
  __shared__ BoxGeom gi[TILE];
  __shared__ BoxGeom gj[TILE];
  __shared__ unsigned short survivors[TILE * TILE];  // ti * TILE + tj
  __shared__ int n_survivors;
  const int i0 = blockIdx.y, istep = gridDim.y;  // rows i0 + istep * t
  const int j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < TILE) {
    if (j0 + tid < m) box_geom(boxes2 + 5 * (j0 + tid), &gj[tid]);
  } else if (tid < 2 * TILE) {
    const int t = tid - TILE;
    const int i = i0 + istep * t;
    if (i < n) box_geom(boxes1 + 5 * i, &gi[t]);
  }
  if (tid == 0) n_survivors = 0;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PAIRS_PER_THREAD; ++q) {
    const int p = q * THREADS + tid;  // a warp covers one row of the tile
    const int ti = p / TILE, tj = p % TILE;
    const int i = i0 + istep * ti, j = j0 + tj;
    bool survive = false;
    if (i < n && j < m) {
      if (far_pair(gi[ti], gj[tj])) {
        out[static_cast<size_t>(i) * m + j] = 0.f;
      } else {
        survive = true;
      }
    }
    const unsigned vote = __ballot_sync(0xffffffffu, survive);
    int base = 0;
    if (lane == 0 && vote) base = atomicAdd(&n_survivors, __popc(vote));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (survive) {
      survivors[base + __popc(vote & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(p);
    }
  }
  __syncthreads();
  const int count = n_survivors;
  for (int s = tid; s < count; s += THREADS) {
    const int p = survivors[s];
    const int ti = p / TILE, tj = p % TILE;
    out[static_cast<size_t>(i0 + istep * ti) * m + j0 + tj] =
        pair_iou(gi[ti], gj[tj]);
  }
}

}  // namespace

extern "C" {

// boxes1 [n, 5], boxes2 [m, 5], out [n, m]; contiguous fp32 on the
// device. Returns cudaGetLastError() after the launch.
int rotated_iou_launch(const float* boxes1, const float* boxes2, float* out,
                       int n, int m, cudaStream_t stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  rotated_iou_kernel<<<grid, THREADS, 0, stream>>>(boxes1, boxes2, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
