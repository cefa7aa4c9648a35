// K2: sparse-conv weight gradient, fp32, deterministic.
//
// Replaces the Pallas TPU kernel second_tpu/ops/banded_sparse.py
// `_banded_dw_call` (body `_make_dw_kernel`, reached through `_banded_dw`).
// It computes what `_banded_dw` computes and none of its TPU workaround
// (banded windows, one-hot MXU gathers, the CSR correction pass): rows are
// gathered straight from the [B, Vout, K] rulebook.
//
//   dW[k, :, :] = sum_{b, o} feat[b, slots[b, o, k], :]^T dout[b, o, :]
//
// A slot outside [0, vin) is a miss and contributes nothing (the JAX
// package's dump row is slot == vin).
//
// For each offset k it is the GEMM dout^T [Cout, rows] x A_k [rows, Cin]
// reduced over all B*Vout rule rows. What bounds it on the card, as K1:
// after the skips, the instructions that feed the MMAs, and here also
// each tile's restart (slot staging, the dout split, barriers) once per
// offset group (second_tpu_torch/tools/kernel_variants.py). Design:
//   * The first launch's grid runs over (offset group, row split). A block
//     owns G offsets (as many as its registers hold: G * Cout * Cin <=
//     ACC_TILES * 128 accumulators over 8 warps) and walks its split's
//     rows in tiles of TR = 64. For each tile it stages the slots of its
//     offsets and the dout rows once, for all G offsets, votes
//     (__syncthreads_or) and skips a tile where no slot hits, and loops
//     only over the offsets with a hit. The next tile's slots are loaded
//     into registers while the current tile runs.
//   * The gathered feature rows of each offset come through a cp.async
//     ring of two stages, as in K1 (zero-filled on a miss); the dout tile
//     lands with the first stage.
//   * The products run on the tensor cores with the 3xTF32 split of
//     gather_mma.cuh: M = Cout (m16 tiles, dout^T from shared memory), N =
//     Cin (n8 tiles), the reduction over the tile's rows in k8 steps; a
//     warp skips an 8-row step where every row misses at that offset.
//     Each warp keeps a fixed set of the block's (offset, m16, n8) tiles
//     in registers, all of one n8 tile. Each operand is split once: the
//     dout tile into (hi, lo) pairs in shared memory when it lands (read
//     back as float2), a warp's gathered-row fragments once per offset
//     for all its m16 tiles.
//   * The tensor cores' fp32 accumulation rounds toward zero. Chained over
//     a split's thousands of MMAs it drifts past the 1e-5 of the largest
//     magnitude that tests/test_torch_cuda.py holds K2 to at car.fhd's
//     batch-8 shapes. So each (tile, offset) sums its 8 k8 steps in a
//     fresh accumulator, added to the running fp32 sum with a
//     round-to-nearest FADD.
//   * Each block writes its partials to partial[s, k]; a second launch
//     sums the S partials of every element in split order. No atomics:
//     two calls give bitwise-equal dW.

#include "gather_mma.cuh"

extern "C" int sparse_conv_dw_groups(int k, int cin, int cout);

namespace {

using namespace gather_mma;

constexpr int TR = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int HEADER_BYTES = 64;  // per-warp offset masks, 16-byte aligned
// MMA accumulator tiles (m16 x n8, 4 floats a thread) a block keeps: 8
// per warp, so that 2 blocks of 256 threads fit an SM without spills
constexpr int ACC_TILES = 64;

// offsets per block for a layer of TPO accumulator tiles per offset
__host__ __device__ constexpr int group_of(int tpo) {
  return ACC_TILES / tpo < 32 ? ACC_TILES / tpo : 32;
}

template <int CIN_P, int COUT_P>
struct Shape {
  static constexpr int NT = CIN_P / 8;    // n8 tiles over Cin
  static constexpr int MT = COUT_P / 16;  // m16 tiles over Cout
  static constexpr int TPO = NT * MT;     // MMA tiles per offset
  static constexpr int G = group_of(TPO);  // offsets per block
  static constexpr int MAXT = (G * TPO + WARPS - 1) / WARPS;  // per warp
  static constexpr int SS = G | 1;                   // slots [TR][SS]
  static constexpr int SD = COUT_P + 4;              // dout [TR][SD]
  static constexpr int SD2 = COUT_P + 4;  // dout split, float2 [TR][SD2]
  static constexpr int SG = kmajor_stride(CIN_P);    // gathered [TR][SG]
};

int cout_width(int cout) { return pad_width(cout) < 16 ? 16 : pad_width(cout); }

int group_size(int cin_p, int cout_p) {
  return group_of((cin_p / 8) * (cout_p / 16));
}

int block_smem_bytes(int cin_p, int cout_p) {
  const int slots = (TR * (group_size(cin_p, cout_p) | 1) * 4 + 15) / 16 * 16;
  return HEADER_BYTES + slots +
         (3 * TR * (cout_p + 4) + STAGES * TR * kmajor_stride(cin_p)) *
             static_cast<int>(sizeof(float));
}

template <int CIN_P, int COUT_P>
__global__ void __launch_bounds__(THREADS, 2)
sparse_conv_dw_partial(const float* __restrict__ feat,
                       const int32_t* __restrict__ slots,
                       const float* __restrict__ dout,
                       float* __restrict__ partial,
                       int batch, int vin, int vout, int k, int cin,
                       int cout, long long rows_per_split, bool a_vec,
                       bool d_vec) {
  using S = Shape<CIN_P, COUT_P>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* warp_mask = reinterpret_cast<unsigned*>(smem);
  // global feature row b * vin + slot of (row, offset), -1 on a miss
  int32_t* slot_s = reinterpret_cast<int32_t*>(smem + HEADER_BYTES);
  float* d_s = reinterpret_cast<float*>(
      smem + HEADER_BYTES + (TR * S::SS * 4 + 15) / 16 * 16);
  float2* d2 = reinterpret_cast<float2*>(d_s + TR * S::SD);
  float* g_s = reinterpret_cast<float*>(d2 + TR * S::SD2);  // [STAGES][TR][SG]

  const int gsize = min(S::G, k);
  const int k0 = blockIdx.x * gsize;
  const int gk = min(gsize, k - k0);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long total = static_cast<long long>(batch) * vout;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(total, r_begin + rows_per_split);

  if (cin < CIN_P) {  // MMA padding of Cin: zeros cp.async never overwrites
    for (int i = tid; i < STAGES * TR * S::SG; i += THREADS) g_s[i] = 0.f;
  }
  if (cout < COUT_P) {
    for (int i = tid; i < TR * S::SD; i += THREADS) d_s[i] = 0.f;
  }

  float acc[S::MAXT][4];
#pragma unroll
  for (int i = 0; i < S::MAXT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // the slots of a tile at the block's offsets, loaded one tile ahead
  // into registers so that their latency overlaps the current tile
  constexpr int SPT = (TR * S::G + THREADS - 1) / THREADS;
  int32_t next[SPT];
  auto fetch = [&](long long r0) {
#pragma unroll
    for (int m = 0; m < SPT; ++m) {
      const int i = tid + m * THREADS;
      const int r = i / gk;
      const long long row = r0 + r;
      next[m] = i < TR * gk && row < r_end
                    ? slots[row * k + k0 + (i - r * gk)]
                    : -1;
    }
  };
  fetch(r_begin);

  for (long long row0 = r_begin; row0 < r_end; row0 += TR) {
    // the tile's slots as global feature rows (-1 on a miss), and the
    // offsets with a hit
    unsigned mask = 0;
#pragma unroll
    for (int m = 0; m < SPT; ++m) {
      const int i = tid + m * THREADS;
      if (i >= TR * gk) continue;
      const int r = i / gk;
      const int j = i - r * gk;
      const int s = next[m];
      int gr = -1;
      if (s >= 0 && s < vin) {
        gr = static_cast<int>((row0 + r) / vout) * vin + s;
        mask |= 1u << j;
      }
      slot_s[r * S::SS + j] = gr;
    }
    fetch(row0 + TR);
    const int rows = static_cast<int>(min(static_cast<long long>(TR),
                                          r_end - row0));
    mask = __reduce_or_sync(0xffffffffu, mask);
    if (lane == 0) warp_mask[warp] = mask;
    if (!__syncthreads_or(mask != 0)) continue;  // no slot of the tile hits
    mask = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mask |= warp_mask[w];

    // the dout rows, zero past the split's end (they meet zero rows of
    // the gather, but garbage could be inf or nan)
    gather_rows_async(d_s, S::SD, TR, cout, d_vec, dout,
                      [&](int r) { return r < rows ? row0 + r : -1ll; }, tid,
                      THREADS);
    auto load = [&](int stage, int j) {
      gather_rows_async(g_s + stage * TR * S::SG, S::SG, TR, cin, a_vec, feat,
                        [&](int r) { return slot_s[r * S::SS + j]; }, tid,
                        THREADS);
    };
    uint64_t to_load = mask;
    uint64_t to_run = mask;
    const int n_active = __popc(mask);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (to_load) load(s, pop_lowest(to_load));
      cp_async_commit();  // the dout rows land with stage 0
    }
    for (int it = 0; it < n_active; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage `it` landed; stage it - 1 is free again
      if (it == 0) {
        // the dout tile, split once into (hi, lo) for all the offsets
        for (int i = tid; i < TR * COUT_P; i += THREADS) {
          const int r = i / COUT_P;
          const int c = i - r * COUT_P;
          uint32_t hi, lo;
          split_tf32(d_s[r * S::SD + c], hi, lo);
          d2[r * S::SD2 + c] = make_float2(__uint_as_float(hi),
                                           __uint_as_float(lo));
        }
        __syncthreads();
      }
      if (to_load) load((it + STAGES - 1) % STAGES, pop_lowest(to_load));
      cp_async_commit();
      const int j = pop_lowest(to_run);
      // rows of the tile that hit at offset j, 8 per k8 step
      const uint64_t live =
          __ballot_sync(0xffffffffu, slot_s[lane * S::SS + j] >= 0) |
          (static_cast<uint64_t>(__ballot_sync(
               0xffffffffu, slot_s[(lane + 32) * S::SS + j] >= 0))
           << 32);
      // the warp's tiles of offset j share one n8 tile (WARPS % NT == 0):
      // its gathered-row fragments, split once for the 8 k8 steps
      const int q0 = ((warp - j * S::TPO) % WARPS + WARPS) % WARPS;
      if (q0 >= S::TPO) continue;  // no tile of offset j is this warp's
      const float* a =
          g_s + (it % STAGES) * TR * S::SG + (warp % S::NT) * 8 + g;
      uint32_t a_hi[TR / 8][2], a_lo[TR / 8][2];
#pragma unroll
      for (int ks = 0; ks < TR / 8; ++ks) {
        split_tf32(a[(ks * 8 + t) * S::SG], a_hi[ks][0], a_lo[ks][0]);
        split_tf32(a[(ks * 8 + t + 4) * S::SG], a_hi[ks][1], a_lo[ks][1]);
      }
#pragma unroll
      for (int i = 0; i < S::MAXT; ++i) {
        const int idx = warp + WARPS * i;
        if (idx / S::TPO != j) continue;  // not this warp's tile of offset j
        const float2* d = d2 + (idx % S::TPO) / S::NT * 16 + g;
        float tile[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < TR / 8; ++ks) {
          if (((live >> (ks * 8)) & 0xffu) == 0) continue;
          const int r = ks * 8 + t;
          const float2 v0 = d[r * S::SD2];
          const float2 v1 = d[r * S::SD2 + 8];
          const float2 v2 = d[(r + 4) * S::SD2];
          const float2 v3 = d[(r + 4) * S::SD2 + 8];
          const uint32_t d_hi[4] = {
              __float_as_uint(v0.x), __float_as_uint(v1.x),
              __float_as_uint(v2.x), __float_as_uint(v3.x)};
          const uint32_t d_lo[4] = {
              __float_as_uint(v0.y), __float_as_uint(v1.y),
              __float_as_uint(v2.y), __float_as_uint(v3.y)};
          mma_3xtf32(tile, d_hi, d_lo, a_hi[ks], a_lo[ks]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += tile[e];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile overwrites slots, dout and stages
  }

  // acc[i] holds dW^T tile (co = mt*16 + g (+8), ci = nt*8 + 2t (+1))
  float* part = partial + (static_cast<size_t>(split) * k + k0) * cin * cout;
#pragma unroll
  for (int i = 0; i < S::MAXT; ++i) {
    const int idx = warp + WARPS * i;
    if (idx >= gk * S::TPO) continue;
    const int j = idx / S::TPO;
    const int co = (idx % S::TPO) / S::NT * 16 + g;
    const int ci = (idx % S::TPO) % S::NT * 8 + 2 * t;
    float* p = part + static_cast<size_t>(j) * cin * cout;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c_o = co + (e >> 1) * 8;
      const int c_i = ci + (e & 1);
      if (c_i < cin && c_o < cout) p[c_i * cout + c_o] = acc[i][e];
    }
  }
}

// dw[e] = sum_s partial[s, e] over the splits in order (fixed order: the
// result does not depend on how the blocks were scheduled).
__global__ void sparse_conv_dw_reduce(const float* __restrict__ partial,
                                      float* __restrict__ dw, int splits,
                                      int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[static_cast<size_t>(p) * n + e];
  dw[e] = s;
}

template <int CIN_P, int COUT_P>
int launch_partial(const float* feat, const int32_t* slots, const float* dout,
                   float* partial, int batch, int vin, int vout, int k,
                   int cin, int cout, int splits, long long rows_per_split,
                   cudaStream_t stream) {
  auto kernel = sparse_conv_dw_partial<CIN_P, COUT_P>;
  const int smem = block_smem_bytes(CIN_P, COUT_P);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool a_vec =
      cin % 4 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const bool d_vec =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const dim3 grid(sparse_conv_dw_groups(k, cin, cout), splits);
  kernel<<<grid, THREADS, smem, stream>>>(feat, slots, dout, partial, batch,
                                          vin, vout, k, cin, cout,
                                          rows_per_split, a_vec, d_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory bytes one block of the first launch needs (the kernel
// opts in above 48 KB; the wrapper refuses shapes above 227 KB).
int sparse_conv_dw_smem_bytes(int cin, int cout) {
  return block_smem_bytes(pad_width(cin), cout_width(cout));
}

// Offset groups of the first launch's grid (its x extent): the wrapper
// sizes the row splits from it.
int sparse_conv_dw_groups(int k, int cin, int cout) {
  const int group = group_size(pad_width(cin), cout_width(cout));
  const int gsize = group < k ? group : k;
  return (k + gsize - 1) / gsize;
}

// feat [batch, vin, cin], slots [batch, vout, k] int32, dout
// [batch, vout, cout], partial [splits, k, cin, cout] scratch, dw
// [k, cin, cout]; all contiguous fp32 (slots int32) on the device. cin <=
// 64, cout a power of two in [4, 64], batch * vin < 2^31; splits *
// rows_per_split must cover batch * vout. Returns the CUDA error code of
// the two launches.
int sparse_conv_dw_launch(const float* feat, const int32_t* slots,
                          const float* dout, float* partial, float* dw,
                          int batch, int vin, int vout, int k, int cin,
                          int cout, int splits, long long rows_per_split,
                          cudaStream_t stream) {
  const int code = dispatch_widths<16>(
      pad_width(cin), cout_width(cout), [&](auto ci, auto co) {
        return launch_partial<decltype(ci)::value, decltype(co)::value>(
            feat, slots, dout, partial, batch, vin, vout, k, cin, cout,
            splits, rows_per_split, stream);
      });
  if (code != 0) return code;
  const int n = k * cin * cout;
  sparse_conv_dw_reduce<<<(n + 255) / 256, 256, 0, stream>>>(partial, dw,
                                                              splits, n);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
