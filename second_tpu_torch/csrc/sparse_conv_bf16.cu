// K1-bf16: gather-GEMM sparse convolution (submanifold and strided) in
// bf16 with f32 accumulation, built for Hopper (sm_90a).
//
// Replaces the bf16 instantiation of the Pallas TPU kernel
// second_tpu/ops/banded_sparse.py:295 `_banded_call_fused` (body
// `_make_fused_kernel`), which the JAX package's mixed precision
// (compute_dtype="bfloat16") runs: rows gathered in bf16, products in
// the weights' bf16, sums in an f32 accumulator, the output rounded once
// to bf16 (banded_sparse.py:286; ops/sparse.py's gather path rounds at
// the same place).
//
//   out[b, o, :] = bf16( sum_k sum_c f32(feat[b, slots[b, o, k], c])
//                                      * f32(W[k, c, :]) )
//
// A slot outside [0, vin) is a miss and reads a zero row. No bias: the
// port's convs have none (batch norm follows each).
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W; device-only
// ms of tools/kernel_variants.py on car.fhd's subm6_w, 64 -> 64, 2134
// tiles of which 649 have a hit, 14 534 (tile, offset) pairs; bytes
// bound 0.0149 ms): memory latency, not the tensor cores. Without the
// wgmma issue the time stays (0.0575 against 0.0568); without W[k]'s
// bulk copies it falls 9% (0.0519). Two parts take it:
//   * the pass over every tile's slots (14.7 MB of int32 read, 12 MB of
//     zeros written for the empty tiles): 0.0186 ("slots only"), of
//     which 0.0042 launches the arrangement and the grid; each block
//     waits one round trip for its slots before it can start;
//   * the ring's ~22 offsets a tile: its rows re-read each input row at
//     every offset where it is a neighbour (60 MB for subm6_w's 17.5 MB
//     of features) and each stage waits out a gather's latency. The
//     blocks that fit an SM (3 at 64 -> 64) hold 12 stages in flight;
//     without reads (every row a zero-fill) the conv takes 0.0366.
// More stages in fewer blocks (0.0594), 128-row tiles with two consumer
// warpgroups sharing W[k] (0.0612), the rows through L1 (0.0598) and one
// producer warp (0.0672) are all slower.
//
// Design. One block owns TM = 64 output rows and all Cout columns: one
// consumer warpgroup (warps 0-3) and a producer warpgroup (warps 4-7).
//   * Products: wgmma.mma_async m64nNk16 bf16 x bf16 -> f32 with both
//     operands read from shared memory through matrix descriptors
//     (sm90.cuh: K-major core matrices, no swizzle), N = Cout padded to
//     8, 16, 32 or 64 and Cin padded with zeros to 16, 32 or 64; no
//     fragment loads. Each offset's products go to a fresh accumulator
//     (scale-d = 0 on its first k16 step), added to the running f32 sum
//     with a round-to-nearest FADD, offsets ascending: the tensor
//     cores' own accumulation rounds toward zero (sparse_conv.cu's
//     header). The f32 sums are rounded once, to nearest even.
//   * Gathers: the producers keep a ring of S stages in flight (S from
//     the widths, stages_for: 4 at 64 -> 64, up to 8). A stage holds the
//     tile's rows at the next offset with a hit, each row's chunks
//     copied by cp.async straight to the bytes the A descriptor reads
//     (16-byte copies where Cin % 8 == 0, else 8/4-byte ones, else
//     2-byte loads and stores; a miss zero-fills and reads nothing).
//     Eight threads of a copy step cover the 8 rows of one core matrix,
//     so the shared-memory writes are free of bank conflicts; for full
//     16-byte rows each thread's copies are fixed at compile time (a
//     loop with a division per copy made the producers the bottleneck).
//     Each producer thread arrives on the stage's full mbarrier when its
//     copies land (cp.async.mbarrier.arrive.noinc); the consumers
//     release the stage on its empty mbarrier after their wgmma has
//     read it. No block-wide barrier inside the offset loop.
//   * Weights: W[k] arrives in the stage by one bulk copy (TMA without
//     a tensor map, complete_tx on the same full mbarrier) from a copy
//     of the weight laid out as the B descriptor reads it, made per
//     call by arrange_weight_kernel into a scratch the wrapper
//     allocates (the port casts its weights to bf16 at each use, so
//     there is no weight version to cache on).
//   * Chains: a block stages the tile's [TM, K] slots once (every load
//     issued before the first is used), writes zeros for a tile with no
//     hit and runs only the offsets with a hit in the tile (a 64-bit
//     mask, K <= 64); the slots' offset-major rows are TM + 1 words
//     apart, so the staging's stores spread over the banks. At <= 81 KB
//     of shared memory 3-5 blocks share an SM, each with its own ring,
//     so one tile's gather latency hides behind the others' and behind
//     its own ring. Persistent blocks over all tiles, or over a list of
//     the tiles with a hit, were slower when tried (not kept). A finer
//     skip than the tile has no unit under a 64-row wgmma. setmaxnreg is
//     not used: at most 79 registers a thread and no spills, so there
//     are none to move.
// No atomics; every output element is summed in a fixed order, so two
// calls give bitwise-equal results.

#include <cuda_bf16.h>

#include <algorithm>

#include "gather_mma.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using gather_mma::pad_width;
using gather_mma::pop_lowest;
using gather_mma::warp_or;
using gather_mma::Width;
using bf16 = __nv_bfloat16;

constexpr int CONSUMER_WGS = 1;  // consumer warpgroups, 64 rows each
constexpr int TM = 64 * CONSUMER_WGS;  // rows of a tile
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int PRODUCER_WARPS = 4;
constexpr int PRODUCERS = 32 * PRODUCER_WARPS;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 4;
constexpr int RING_BYTES = 48 * 1024;  // the ring's target size
constexpr bool ROWS_VIA_L1 = false;    // 16-byte row copies through L1
// full[MAX_STAGES], empty[MAX_STAGES] mbarriers, per-warp offset masks
constexpr int HEADER_BYTES = 256;
static_assert(2 * MAX_STAGES * 8 + WARPS * 8 <= HEADER_BYTES, "header");
constexpr int FULL_ARRIVALS = PRODUCERS + 1;  // + the expect_tx arrival
constexpr int EMPTY_ARRIVALS = 4 * CONSUMER_WGS;  // one per consumer warp

__host__ __device__ constexpr int a_bytes(int cin_p) {
  return TM * cin_p * 2;
}
__host__ __device__ constexpr int b_bytes(int cin_p, int cout_p) {
  return cin_p * cout_p * 2;
}
// The tile's slots, offset-major with a row stride of TM + 1 words (the
// staging writes offset after offset of one row: an odd stride puts
// them on distinct banks), rounded up to 128 bytes.
constexpr int SLOT_STRIDE = TM + 1;
__host__ __device__ constexpr int slot_bytes(int k) {
  return (k * SLOT_STRIDE * 4 + 127) / 128 * 128;
}

// Stages of the ring: as many as fit RING_BYTES, within [4, 8].
__host__ __device__ constexpr int stages_for(int cin_p, int cout_p) {
  const int s = RING_BYTES / (a_bytes(cin_p) + b_bytes(cin_p, cout_p));
  return s < MIN_STAGES ? MIN_STAGES : (s > MAX_STAGES ? MAX_STAGES : s);
}

// The header, the slots and the ring.
__host__ __device__ constexpr int smem_bytes(int k, int cin_p, int cout_p) {
  return HEADER_BYTES + slot_bytes(k) +
         stages_for(cin_p, cout_p) *
             (a_bytes(cin_p) + b_bytes(cin_p, cout_p));
}

// warr[kk][n / 8][c / 8][n % 8][c % 8] = W[kk][c][n], zero where
// c >= cin or n >= cout: each W[kk] as the B descriptor reads it
// (K-major core matrices, stride byte offset cin_p * 16).
__global__ void arrange_weight_kernel(const bf16* __restrict__ w,
                                      bf16* __restrict__ warr, int k,
                                      int cin, int cout, int cin_p,
                                      int cout_p) {
  const int per_k = cin_p * cout_p;
  const int total = k * per_k;
  const int cblocks = cin_p / 8;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int kk = i / per_k;
    const int rem = i - kk * per_k;
    const int blk = rem >> 6;
    const int e = rem & 63;
    const int n = (blk / cblocks) * 8 + (e >> 3);
    const int c = (blk % cblocks) * 8 + (e & 7);
    warr[i] = c < cin && n < cout
                  ? w[(static_cast<size_t>(kk) * cin + c) * cout + n]
                  : __float2bfloat16(0.f);
  }
}

// Block (x, b) owns tile x of batch element b: output rows
// [TM x, TM x + TM).
template <int CIN_P, int COUT_P>
__global__ void __launch_bounds__(THREADS)
sparse_conv_bf16_kernel(const bf16* __restrict__ feat,
                        const int32_t* __restrict__ slots,
                        const bf16* __restrict__ warr,
                        bf16* __restrict__ out, int vin, int vout, int k,
                        int cin, int cout, int a_chunk) {
  constexpr int A_BYTES = a_bytes(CIN_P);
  constexpr int B_BYTES = b_bytes(CIN_P, COUT_P);
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  constexpr int S = stages_for(CIN_P, COUT_P);
  constexpr int SBO = CIN_P * 16;  // between 8-row groups, A and B
  constexpr int R = COUT_P / 2;    // accumulator registers a thread
  // slots a thread stages: at most TM * 64 over THREADS
  constexpr int SLOTS_PER_THREAD = (TM * 64 + THREADS - 1) / THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* warp_mask = empty + MAX_STAGES;  // [WARPS]
  int32_t* slot_s = reinterpret_cast<int32_t*>(smem + HEADER_BYTES);
  unsigned char* ring = smem + HEADER_BYTES + slot_bytes(k);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, vout - row0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int32_t* slots_t =
      slots + (static_cast<size_t>(b) * vout + row0) * k;
  bf16* out_t = out + (static_cast<size_t>(b) * vout + row0) * cout;
  const bf16 zero = __float2bfloat16(0.f);

  // the tile's slots, offset-major (a miss as -1), and the offsets with
  // a hit: every load issued before the first is used
  int sl[SLOTS_PER_THREAD];
  const int n_slots = rows * k;
#pragma unroll
  for (int j = 0; j < SLOTS_PER_THREAD; ++j) {
    const int i = tid + THREADS * j;
    sl[j] = i < n_slots ? slots_t[i] : -1;
  }
  uint64_t mask = 0;
  {
    const int dr = THREADS / k;
    const int dk = THREADS - dr * k;
    int r = tid / k;  // slot i is row r, offset o (i = r * k + o)
    int o = tid - r * k;
#pragma unroll
    for (int j = 0; j < SLOTS_PER_THREAD; ++j) {
      if (r < TM) {
        int v = sl[j];
        if (v >= 0 && v < vin) {
          mask |= 1ull << o;
        } else {
          v = -1;
        }
        slot_s[o * SLOT_STRIDE + r] = v;
      }
      r += dr;
      o += dk;
      if (o >= k) {
        o -= k;
        ++r;
      }
    }
  }
  mask = warp_or(mask);
  if (lane == 0) warp_mask[warp] = mask;
  if (!__syncthreads_or(mask != 0)) {
    // no slot of the tile hits: its rows are zero
    for (int i = tid; i < rows * cout; i += THREADS) out_t[i] = zero;
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], FULL_ARRIVALS);
      mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    mbar_init_fence();
  }
  if (cin < CIN_P) {
    // the MMA padding of Cin: zeros that the gathers never overwrite
    for (int s = 0; s < S; ++s) {
      uint4* a = reinterpret_cast<uint4*>(ring + s * STAGE_BYTES);
      for (int i = tid; i < A_BYTES / 16; i += THREADS)
        a[i] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  mask = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mask |= warp_mask[w];
  const int n_active = __popcll(mask);

  if (tid >= CONSUMERS) {
    // ---- producers: W[kk] by bulk copy, the rows by cp.async ---------
    const int pt = tid - CONSUMERS;
    const bf16* feat_b = feat + static_cast<size_t>(b) * vin * cin;
    // every offset with a hit: wait until its stage is free, W[kk] (one
    // thread), the rows (copy_rows(a_s, slot_k) on every producer
    // thread; true when it used cp.async only), then arrive
    auto produce = [&](auto copy_rows) {
      uint64_t todo = mask;
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_active; ++it) {
        const int kk = pop_lowest(todo);
        mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
        unsigned char* a_s = ring + s * STAGE_BYTES;
        if (pt == 0) {
          mbar_arrive_expect_tx(&full[s], B_BYTES);
          bulk_copy(a_s + A_BYTES,
                    warr + static_cast<size_t>(kk) * (B_BYTES / 2), B_BYTES,
                    &full[s]);
        }
        if (copy_rows(a_s, slot_s + kk * SLOT_STRIDE)) {
          mbar_arrive_cp_async(&full[s]);
        } else {
          fence_proxy_async();  // plain stores: visible to wgmma
          mbar_arrive(&full[s]);
        }
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      cp_async_wait_all();
    };
    // A copy step covers (row group, chunk) pairs: the 8 threads of a
    // pair take the 8 rows of one core matrix, the others the next pairs
    const int rsub = pt & 7;
    constexpr int STEP = PRODUCERS / 8;  // pairs a copy step
    if (cin == CIN_P && a_chunk == 8) {
      // full 16-byte rows: each thread's pairs are fixed at compile time
      // up to the thread, so their offsets stay in registers
      constexpr int CPR = CIN_P / 8;
      constexpr int J = TM / 8 * CPR / STEP;
      static_assert(TM / 8 * CPR % STEP == 0, "copy steps");
      int soff[J], coff[J];
      uint32_t doff[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = (pt >> 3) + STEP * j;
        const int rg = p / CPR;
        const int q = p % CPR;
        soff[j] = rg * 8 + rsub;
        coff[j] = q * 8;
        doff[j] = rg * SBO + q * 128 + rsub * 16;
      }
      produce([&](unsigned char* a_s, const int32_t* slot_k) {
        int row[J];
#pragma unroll
        for (int j = 0; j < J; ++j) row[j] = slot_k[soff[j]];
#pragma unroll
        for (int j = 0; j < J; ++j)
          cp_async<16, ROWS_VIA_L1>(a_s + doff[j],
                       feat_b + (row[j] >= 0
                                     ? static_cast<size_t>(row[j]) * CIN_P +
                                           coff[j]
                                     : 0),
                       row[j] >= 0);
        return true;
      });
    } else {
      const int cpr = cin / a_chunk;  // copies per row
      produce([&](unsigned char* a_s, const int32_t* slot_k) {
        for (int p = pt >> 3; p < TM / 8 * cpr; p += STEP) {
          const int rg = p / cpr;
          const int c = (p - rg * cpr) * a_chunk;
          const int row = slot_k[rg * 8 + rsub];
          const bf16* src =
              feat_b + (row >= 0 ? static_cast<size_t>(row) * cin + c : 0);
          unsigned char* dst =
              a_s + rg * SBO + (c >> 3) * 128 + rsub * 16 + (c & 7) * 2;
          switch (a_chunk) {
            case 8: cp_async<16, ROWS_VIA_L1>(dst, src, row >= 0); break;
            case 4: cp_async<8>(dst, src, row >= 0); break;
            case 2: cp_async<4>(dst, src, row >= 0); break;
            default: *reinterpret_cast<bf16*>(dst) = row >= 0 ? *src : zero;
          }
        }
        return a_chunk > 1;
      });
    }
  } else {
    // ---- consumers: one wgmma chain per offset, warpgroup wg on rows
    // [64 wg, 64 wg + 64) ---------------------------------------------
    const int wg = tid >> 7;
    float acc[R];
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_active; ++it) {
      mbar_wait(&full[s], phase);
      fence_proxy_async();  // the stage's cp.async and st.shared rows
      const uint32_t a_addr = smem_addr(ring + s * STAGE_BYTES);
      const uint64_t da = kmajor_desc(a_addr + wg * 8 * SBO, SBO);
      const uint64_t db = kmajor_desc(a_addr + A_BYTES, SBO);
      float part[R];  // this offset's products, added below
#pragma unroll
      for (int e = 0; e < R; ++e) part[e] = 0.f;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < CIN_P / 16; ++j)
        Wgmma<COUT_P>::run(part, da + j * kDescK16, db + j * kDescK16, j > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] += part[e];
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }

    // one rounding, to nearest even, of each f32 sum
    const int r0 = warp * 16 + (lane >> 2);  // warp 4 wg + w: 64 wg + 16 w
#pragma unroll
    for (int j = 0; j < COUT_P / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (col >= cout) continue;
      if (r0 < rows)
        *reinterpret_cast<__nv_bfloat162*>(
            out_t + static_cast<size_t>(r0) * cout + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r0 + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(
            out_t + static_cast<size_t>(r0 + 8) * cout + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

int arrange(const bf16* weight, bf16* warr, int k, int cin, int cout,
            int cin_p, int cout_p, cudaStream_t stream) {
  const int total = k * cin_p * cout_p;
  const int blocks = std::min((total + 255) / 256, 1024);
  arrange_weight_kernel<<<blocks, 256, 0, stream>>>(weight, warr, k, cin,
                                                    cout, cin_p, cout_p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel at these widths and K resident on one SM, or the
// negated CUDA error code.
template <int CIN_P, int COUT_P>
int blocks_per_sm(int k) {
  auto kernel = sparse_conv_bf16_kernel<CIN_P, COUT_P>;
  const int smem = smem_bytes(k, CIN_P, COUT_P);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <int CIN_P, int COUT_P>
int launch(const bf16* feat, const int32_t* slots, const bf16* weight,
           bf16* warr, bf16* out, int batch, int vin, int vout, int k,
           int cin, int cout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_bf16_kernel<CIN_P, COUT_P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(k, CIN_P, COUT_P));
  if (err != cudaSuccess) return static_cast<int>(err);
  int code = arrange(weight, warr, k, cin, cout, CIN_P, COUT_P, stream);
  if (code != 0) return code;
  // the widest copy (in bf16 elements) that the rows' length and the
  // features' alignment allow
  int a_chunk = 8;
  while (a_chunk > 1 &&
         (cin % a_chunk != 0 ||
          reinterpret_cast<uintptr_t>(feat) % (2 * a_chunk) != 0))
    a_chunk /= 2;
  const dim3 grid((vout + TM - 1) / TM, batch);
  sparse_conv_bf16_kernel<CIN_P, COUT_P>
      <<<grid, THREADS, smem_bytes(k, CIN_P, COUT_P), stream>>>(
          feat, slots, warr, out, vin, vout, k, cin, cout, a_chunk);
  return static_cast<int>(cudaGetLastError());
}

inline int cin_pad(int cin) {
  return pad_width(cin) < 16 ? 16 : pad_width(cin);
}

// f(Width<CIN_P>, Width<COUT_P>) for CIN_P in {16, 32, 64} (the wgmma
// depth is 16) and COUT_P in {8, 16, 32, 64}
template <typename F>
int dispatch(int cin_p, int cout_p, F&& f) {
  auto by_cout = [&](auto ci) -> int {
    switch (cout_p) {
      case 8: return f(ci, Width<8>{});
      case 16: return f(ci, Width<16>{});
      case 32: return f(ci, Width<32>{});
      case 64: return f(ci, Width<64>{});
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  switch (cin_p) {
    case 16: return by_cout(Width<16>{});
    case 32: return by_cout(Width<32>{});
    case 64: return by_cout(Width<64>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// feat [batch, vin, cin] bf16, slots [batch, vout, k] int32, weight
// [k, cin, cout] bf16, warr a scratch of k * cin_p * cout_p bf16 (the
// weight as the kernel reads it; cin_p = max(16, pad(cin)), cout_p =
// pad(cout), pads to powers of two), out [batch, vout, cout] bf16; all
// contiguous on the device. cin <= 64, cout a power of two in [4, 64],
// k <= 64. Launches the weight arrangement, then the kernel. Returns the
// CUDA error code of the launches.
int sparse_conv_bf16_launch(const void* feat, const int32_t* slots,
                            const void* weight, void* warr, void* out,
                            int batch, int vin, int vout, int k, int cin,
                            int cout, cudaStream_t stream) {
  return dispatch(cin_pad(cin), pad_width(cout), [&](auto ci, auto co) {
    return launch<decltype(ci)::value, decltype(co)::value>(
        static_cast<const bf16*>(feat), slots,
        static_cast<const bf16*>(weight), static_cast<bf16*>(warr),
        static_cast<bf16*>(out), batch, vin, vout, k, cin, cout, stream);
  });
}

// The weight arrangement alone (warr as above).
int sparse_conv_bf16_arrange(const void* weight, void* warr, int k, int cin,
                             int cout, cudaStream_t stream) {
  return arrange(static_cast<const bf16*>(weight), static_cast<bf16*>(warr),
                 k, cin, cout, cin_pad(cin), pad_width(cout), stream);
}

// The ring's stages and the block's shared memory for these widths.
int sparse_conv_bf16_stages(int cin, int cout) {
  return stages_for(cin_pad(cin), pad_width(cout));
}

int sparse_conv_bf16_smem_bytes(int k, int cin, int cout) {
  return smem_bytes(k, cin_pad(cin), pad_width(cout));
}

// Blocks of the kernel resident on one SM at these widths and K, or
// the negated CUDA error code.
int sparse_conv_bf16_blocks_per_sm(int k, int cin, int cout) {
  return dispatch(cin_pad(cin), pad_width(cout), [&](auto ci, auto co) {
    return blocks_per_sm<decltype(ci)::value, decltype(co)::value>(k);
  });
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
