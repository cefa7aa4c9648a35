// K4: greedy NMS suppression sweep over a score-ordered IoU matrix.
//
// Replaces the Pallas TPU kernel second_tpu/ops/pallas_nms.py
// `greedy_suppress_pallas` (body `_greedy_kernel`), same semantics: in
// rank order i = 0..n-1, keep[i] = alive[i]; a kept i kills every later
// j with iou[i, j] > threshold (NaN compares false).
//
// What bounds it on the card: the sweep is a chain of n dependent
// decisions (n = 1000 on the main path), not the 4 MB of IoU it reads:
// one warp's instruction latency, ~25 ns a candidate. Two launches:
//   1. `suppression_mask_kernel`, over the grid: one warp per (row i,
//      64-column word w) with w >= i / 64 reads 64 floats of row i and
//      turns them into mask[w][i] with two ballots, bit b set when
//      j = 64 w + b has j > i, j < n and iou[i, j] > threshold. Words
//      left of the diagonal are never read and not written. The warp of
//      row 64 w also writes mask[w][n] = ~valid (bits past n set). The
//      mask, word-major so that consecutive rows are adjacent, is a
//      [ceil(n / 64), n + 1] workspace the wrapper allocates.
//   2. `bitmask_sweep_kernel`, one warp; removed[w] lives in shared
//      memory. For word w, lane l holds rows 64 w + l and 64 w + 32 + l:
//      their diagonal words and their next CHUNK words, loaded one word
//      ahead, so no load sits on the chain. The chain visits the word's
//      candidates still alive in rank order; each is kept and ORs in its
//      diagonal word, fetched by a shuffle from the lane that holds it
//      (register operations only). Then every later word takes the OR
//      of the kept rows' words, one warp reduction (`__reduce_or_sync`)
//      each; past the first CHUNK later words (n > 1024) their loads are
//      issued CHUNK words at a time.
// Deterministic: no atomics, and every OR is order-free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MASK_WARPS = 8;  // rows per block of the mask build
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 16;  // later words a lane's rows hold in registers

__global__ void __launch_bounds__(MASK_WARPS * 32)
suppression_mask_kernel(const float* __restrict__ iou,
                        const uint8_t* __restrict__ valid,
                        uint64_t* __restrict__ mask, int n, int words,
                        float threshold) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.y * MASK_WARPS + (threadIdx.x >> 5);
  const int w = blockIdx.x;
  if (i >= n || w < i / 64) return;  // whole warps leave together
  const float* row = iou + static_cast<size_t>(i) * n;
  const int j0 = 64 * w + lane, j1 = j0 + 32;
  const bool s0 = j0 < n && j0 > i && row[j0] > threshold;
  const bool s1 = j1 < n && j1 > i && row[j1] > threshold;
  const unsigned lo = __ballot_sync(FULL, s0);
  const unsigned hi = __ballot_sync(FULL, s1);
  if (lane == 0) {
    mask[static_cast<size_t>(w) * (n + 1) + i] =
        static_cast<uint64_t>(hi) << 32 | lo;
  }
  if (i == 64 * w) {  // one warp a word: row n holds removed = ~valid
    const unsigned r0 = __ballot_sync(FULL, !(j0 < n && valid[j0]));
    const unsigned r1 = __ballot_sync(FULL, !(j1 < n && valid[j1]));
    if (lane == 0) {
      mask[static_cast<size_t>(w) * (n + 1) + n] =
          static_cast<uint64_t>(r1) << 32 | r0;
    }
  }
}

// Words `col` .. `col` + CHUNK - 1 of the rows 64 w + lane (lo) and
// 64 w + 32 + lane (hi), 0 past n or past the last word: 2 * CHUNK
// loads issued together.
__device__ __forceinline__ void load_chunk(
    const uint64_t* __restrict__ mask, int n, int words, int w, int col,
    int lane, uint64_t* lo, uint64_t* hi) {
  const int r0 = 64 * w + lane, r1 = r0 + 32;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    const int c = col + u;
    const uint64_t* p = mask + static_cast<size_t>(c) * (n + 1);
    lo[u] = r0 < n && c < words ? p[r0] : 0;
    hi[u] = r1 < n && c < words ? p[r1] : 0;
  }
}

// The diagonal words (word w) of rows 64 w + lane and 64 w + 32 + lane,
// 0 past n.
__device__ __forceinline__ void load_diagonal(
    const uint64_t* __restrict__ mask, int n, int w, int lane, uint64_t* d) {
  const uint64_t* p = mask + static_cast<size_t>(w) * (n + 1);
  const int r0 = 64 * w + lane, r1 = r0 + 32;
  d[0] = r0 < n ? p[r0] : 0;
  d[1] = r1 < n ? p[r1] : 0;
}

__global__ void __launch_bounds__(32)
bitmask_sweep_kernel(const uint64_t* __restrict__ mask,
                     uint8_t* __restrict__ keep, int n, int words) {
  extern __shared__ uint64_t removed[];
  const int lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) {
    removed[w] = mask[static_cast<size_t>(w) * (n + 1) + n];
  }
  uint64_t diag[2], next_diag[2], row_lo[CHUNK], row_hi[CHUNK];
  load_diagonal(mask, n, 0, lane, next_diag);
  load_chunk(mask, n, words, 0, 1, lane, row_lo, row_hi);
  for (int w = 0; w < words; ++w) {
    __syncwarp();  // the last word's ORs are in shared memory
    diag[0] = next_diag[0];
    diag[1] = next_diag[1];
    if (w + 1 < words) load_diagonal(mask, n, w + 1, lane, next_diag);
    // the chain; rows 32..63 of the word reach only its high half
    const uint64_t start = removed[w];
    uint32_t lo = static_cast<uint32_t>(start);
    uint32_t hi = static_cast<uint32_t>(start >> 32);
    for (uint32_t todo = ~lo; todo;) {
      const int b = __ffs(todo) - 1;
      const uint64_t d = __shfl_sync(FULL, diag[0], b);
      lo |= static_cast<uint32_t>(d);
      hi |= static_cast<uint32_t>(d >> 32);
      todo = ~lo & (0xfffffffeu << b);
    }
    const uint32_t diag_hi = static_cast<uint32_t>(diag[1] >> 32);
    for (uint32_t todo = ~hi; todo;) {
      const int b = __ffs(todo) - 1;
      hi |= __shfl_sync(FULL, diag_hi, b);
      todo = ~hi & (0xfffffffeu << b);
    }
    // bits past n start removed, so they are never kept
    const uint64_t kept = ~(static_cast<uint64_t>(hi) << 32 | lo);
    const int j0 = 64 * w + lane, j1 = j0 + 32;
    if (j0 < n) keep[j0] = static_cast<uint8_t>(kept >> lane & 1);
    if (j1 < n) keep[j1] = static_cast<uint8_t>(kept >> (lane + 32) & 1);
    // the kept rows' masks into the later words
    if (kept) {
      const uint64_t m0 = (kept >> lane & 1) ? ~uint64_t{0} : 0;
      const uint64_t m1 = (kept >> (lane + 32) & 1) ? ~uint64_t{0} : 0;
      for (int col = w + 1; col < words; col += CHUNK) {
        if (col > w + 1) load_chunk(mask, n, words, w, col, lane, row_lo,
                                    row_hi);
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          const uint64_t v = (row_lo[u] & m0) | (row_hi[u] & m1);
          const uint32_t vlo =
              __reduce_or_sync(FULL, static_cast<uint32_t>(v));
          const uint32_t vhi =
              __reduce_or_sync(FULL, static_cast<uint32_t>(v >> 32));
          if (lane == u && col + u < words) {
            removed[col + u] |= static_cast<uint64_t>(vhi) << 32 | vlo;
          }
        }
      }
    }
    if (w + 1 < words) {  // for the next word's ORs, off its chain
      load_chunk(mask, n, words, w + 1, w + 2, lane, row_lo, row_hi);
    }
  }
}

}  // namespace

extern "C" {

// iou [n, n] fp32, valid [n] and keep [n] as bytes (torch.bool), mask
// [ceil(n / 64), n + 1] uint64 scratch; contiguous on the device,
// n >= 1. Launches the mask build and the sweep on `stream`. Returns
// cudaGetLastError() after the launches.
int greedy_nms_launch(const float* iou, const uint8_t* valid, uint8_t* keep,
                      uint64_t* mask, int n, float threshold,
                      cudaStream_t stream) {
  const int words = (n + 63) / 64;
  const dim3 grid(words, (n + MASK_WARPS - 1) / MASK_WARPS);
  suppression_mask_kernel<<<grid, MASK_WARPS * 32, 0, stream>>>(
      iou, valid, mask, n, words, threshold);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bitmask_sweep_kernel<<<1, 32, static_cast<size_t>(words) * 8, stream>>>(
      mask, keep, n, words);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
