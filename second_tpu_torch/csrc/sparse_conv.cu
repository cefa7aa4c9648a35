// K1: gather-GEMM sparse convolution (submanifold and strided), fp32.
//
// Replaces the Pallas TPU kernel second_tpu/ops/banded_sparse.py
// `_banded_call_fused` (body `_make_fused_kernel`). It computes what that
// kernel computes and none of its TPU workaround (banded windows, one-hot
// MXU gathers, CSR corrections): a Hopper SM gathers rows straight from
// the [Vout, K] rulebook.
//
//   out[b, o, :] = bias + sum_k feat[b, slots[b, o, k], :] @ W[k]
//
// A slot outside [0, vin) is a miss and reads a zero row (the JAX
// package's dump row is slot == vin). The same kernel serves the forward
// and the input gradient (a mirrored or transposed rulebook).
//
// What bounds it on the card. At car.fhd widths (Cin, Cout <= 64) a row
// is 16-256 bytes and most rulebook entries miss: the static capacities
// leave ~65% of the rows as padding, and a submanifold row hits ~1/3 of
// its 27 offsets. So the design first skips what misses. What bounds it
// then is the instruction stream that feeds the MMAs (fragment loads,
// the 3xTF32 split, the barriers), not the gathers nor the tensor cores'
// rate: without its products it runs in about half the time
// (second_tpu_torch/tools/kernel_variants.py). Design:
//   * One block owns TM = 64 output rows and all Cout columns (4 warps of
//     16 rows). It stages the tile's [TM, K] slots once and votes
//     (__syncthreads_or): a tile with no hit writes its rows as the bias
//     (or zero) and returns. Active rows need not form a prefix.
//   * It loops only over the offsets with at least one hit in the tile
//     (a 64-bit mask from the staged slots, so K <= 64), and a warp skips
//     the products of an offset where all of its 16 rows miss.
//   * The gathers run through a ring of two shared-memory stages, each
//     holding the tile's rows at one offset, filled with cp.async (16-byte
//     copies, zero-filled with no read on a miss) while the tensor cores
//     work on the other stage. W[k] comes from L2 into registers one
//     offset ahead and is stored split into (hi, lo) pairs, so the four
//     warps read their B fragments as float2 and none splits W again.
//   * Products on the tensor cores at fp32 accuracy: mma.sync m16n8k8
//     TF32 with the 3xTF32 split (gather_mma.cuh), fp32 accumulators in
//     registers. One TF32 pass would miss the 1e-4 tolerance
//     (tests/test_torch_kernels.py). Each offset's products go to a fresh
//     accumulator, added to the running sum with a round-to-nearest
//     FADD: the tensor cores' fp32 accumulation rounds toward zero and
//     drifts when chained (K2's header). wgmma is not used: with N = Cout
//     <= 64, mma.sync's rate is not the limit; a wgmma version reading
//     both operands from shared memory would remove most of the feeding
//     instructions, and is later work.
//   * Cin and Cout are padded to the MMA widths (8, 16, 32, 64) in shared
//     memory with zeros; shared-memory strides keep every fragment read
//     free of bank conflicts.
//   * Cout = 128 (the residual nuScenes middle's 64 -> 128 and 128 -> 128
//     convs) splits its columns over two blocks of 64, neighbours in the
//     grid so that both gather the tile's rows while L2 holds them: a
//     block keeping all 128 columns would hold 128 accumulators, 128
//     products and a 128-wide W[k] in registers (they spill), and its
//     split W[k] alone would take 132 KB of shared memory at Cin = 128.
//     Only (64, 128) and (128, 128) are instantiated.
// No atomics; every output element is summed in a fixed order (offsets
// ascending, then Cin), so two calls give bitwise-equal results.

#include "gather_mma.cuh"

namespace {

using namespace gather_mma;

constexpr int TM = 64;
constexpr int WARPS = 4;  // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;  // gathered-row stages
constexpr int HEADER_BYTES = 64;  // per-warp offset masks, 16-byte aligned

constexpr int MAX_CT = 64;  // a block's columns at most

template <int CIN_P, int COUT_P>
struct Shape {
  // the block's columns: all of Cout up to 64, else a slice of 64
  static constexpr int CT = COUT_P < MAX_CT ? COUT_P : MAX_CT;
  static constexpr bool WIDE = COUT_P > MAX_CT;
  static constexpr int NCOL = COUT_P / CT;  // blocks per row tile
  static constexpr int SA = CIN_P + 4;   // gathered rows [TM][SA]
  static constexpr int SB = CT + 4;      // W[k] split, float2 [CIN_P][SB]
  static constexpr int STAGE = TM * SA;  // floats per stage
  // float4 chunks of W[k] each thread loads
  static constexpr int WV = (CIN_P * CT / 4 + THREADS - 1) / THREADS;
};

inline int slot_bytes(int k) { return (TM * k * 4 + 15) / 16 * 16; }

int block_smem_bytes(int k, int cin_p, int cout_p) {
  const int ct = cout_p < MAX_CT ? cout_p : MAX_CT;
  return HEADER_BYTES + slot_bytes(k) +
         (STAGES * TM * (cin_p + 4) + 2 * cin_p * (ct + 4)) *
             static_cast<int>(sizeof(float));
}

template <int CIN_P, int COUT_P>
__global__ void __launch_bounds__(THREADS)
sparse_conv_kernel(const float* __restrict__ feat,
                   const int32_t* __restrict__ slots,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias,
                   float* __restrict__ out,
                   int vin, int vout, int k, int cin, int cout,
                   int slot_bytes_k, bool a_vec, bool w_vec) {
  using S = Shape<CIN_P, COUT_P>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* warp_mask = reinterpret_cast<uint64_t*>(smem);
  int32_t* slot_s = reinterpret_cast<int32_t*>(smem + HEADER_BYTES);  // [TM, k]
  float* stages =
      reinterpret_cast<float*>(smem + HEADER_BYTES + slot_bytes_k);
  float2* w2 = reinterpret_cast<float2*>(stages + STAGES * S::STAGE);

  const int b = blockIdx.y;
  const int row0 = (blockIdx.x / S::NCOL) * TM;
  // the first of the block's CT columns (0 unless Cout is split)
  const int col0 = (blockIdx.x % S::NCOL) * S::CT;
  // W[k]'s columns the block loads: Cout's, or its slice's
  const int w_cols = S::WIDE ? S::CT : cout;
  const int rows = min(TM, vout - row0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* feat_b = feat + static_cast<size_t>(b) * vin * cin;
  const int32_t* slots_t =
      slots + (static_cast<size_t>(b) * vout + row0) * k;
  float* out_t = out + (static_cast<size_t>(b) * vout + row0) * cout;

  // the tile's slots (a miss as -1) and the offsets with a hit
  uint64_t mask = 0;
  for (int i = tid; i < TM * k; i += THREADS) {
    const int r = i / k;
    int s = r < rows ? slots_t[i] : -1;
    if (s >= 0 && s < vin) {
      mask |= 1ull << (i - r * k);
    } else {
      s = -1;
    }
    slot_s[i] = s;
  }
  mask = warp_or(mask);
  if (lane == 0) warp_mask[warp] = mask;
  if (cin < CIN_P) {
    // MMA padding of Cin: zeros that cp.async never overwrites
    for (int i = tid; i < STAGES * S::STAGE; i += THREADS) stages[i] = 0.f;
  }
  if (cin < CIN_P || cout < COUT_P) {  // and of W's rows and columns
    for (int i = tid; i < CIN_P * S::SB; i += THREADS)
      w2[i] = make_float2(0.f, 0.f);
  }
  if (!__syncthreads_or(mask != 0)) {
    // no slot of the tile hits: its rows are the bias (or zero)
    if constexpr (S::WIDE) {
      for (int i = tid; i < rows * S::CT; i += THREADS) {
        const int c = col0 + i % S::CT;
        out_t[(i / S::CT) * cout + c] = bias != nullptr ? bias[c] : 0.f;
      }
    } else {
      for (int i = tid; i < rows * cout; i += THREADS)
        out_t[i] = bias != nullptr ? bias[i % cout] : 0.f;
    }
    return;
  }
  mask = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mask |= warp_mask[w];

  // offset kk's rows into a stage (cp.async), and W[kk] into registers
  float4 w_reg[S::WV];
  const int w_chunks = cin * w_cols / 4;  // cout is a multiple of 4
  auto load = [&](int stage, int kk) {
    gather_rows_async(stages + stage * S::STAGE, S::SA, TM, cin, a_vec,
                      feat_b, [&](int r) { return slot_s[r * k + kk]; }, tid,
                      THREADS);
    const float* w_k = weight + static_cast<size_t>(kk) * cin * cout;
#pragma unroll
    for (int v = 0; v < S::WV; ++v) {
      const int c = tid + v * THREADS;
      if (c >= w_chunks) continue;
      if constexpr (S::WIDE) {  // row 4c / CT of the block's slice
        const int row = 4 * c / S::CT;
        const float* src = w_k + row * cout + col0 + (4 * c - row * S::CT);
        w_reg[v] = w_vec ? *reinterpret_cast<const float4*>(src)
                         : make_float4(src[0], src[1], src[2], src[3]);
      } else {
        w_reg[v] = w_vec ? reinterpret_cast<const float4*>(w_k)[c]
                         : make_float4(w_k[4 * c], w_k[4 * c + 1],
                                       w_k[4 * c + 2], w_k[4 * c + 3]);
      }
    }
  };
  // W[kk] from the registers into shared memory, split into (hi, lo)
  // once for the block's warps
  auto store_w = [&]() {
#pragma unroll
    for (int v = 0; v < S::WV; ++v) {
      const int c = tid + v * THREADS;
      if (c >= w_chunks) continue;
      const int row = 4 * c / w_cols;
      float2* dst = w2 + row * S::SB + (4 * c - row * w_cols);
      const float x[4] = {w_reg[v].x, w_reg[v].y, w_reg[v].z, w_reg[v].w};
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split_tf32(x[e], hi, lo);
        h[e] = __uint_as_float(hi);
        l[e] = __uint_as_float(lo);
      }
      reinterpret_cast<float4*>(dst)[0] = make_float4(h[0], l[0], h[1], l[1]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(h[2], l[2], h[3], l[3]);
    }
  };

  float acc[S::CT / 8][4];
#pragma unroll
  for (int j = 0; j < S::CT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_active = __popcll(mask);
  uint64_t to_load = mask;
  uint64_t to_run = mask;
  load(0, pop_lowest(to_load));
  cp_async_commit();
  for (int it = 0; it < n_active; ++it) {
    __syncthreads();  // the warps are done with stage it - 1 and with W
    store_w();
    if (to_load) load((it + 1) % STAGES, pop_lowest(to_load));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage `it` landed, W[k] split in shared memory
    const int kk = pop_lowest(to_run);
    const bool hit = lane < 16 && slot_s[(warp * 16 + lane) * k + kk] >= 0;
    if (!__any_sync(0xffffffffu, hit)) continue;  // this warp's rows all miss
    const float* a_s = stages + (it % STAGES) * S::STAGE + warp * 16 * S::SA;

    float part[S::CT / 8][4];  // this offset's products, added below
#pragma unroll
    for (int j = 0; j < S::CT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < CIN_P; c0 += 8) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(a_s[g * S::SA + c0 + t], a_hi[0], a_lo[0]);
      split_tf32(a_s[(g + 8) * S::SA + c0 + t], a_hi[1], a_lo[1]);
      split_tf32(a_s[g * S::SA + c0 + t + 4], a_hi[2], a_lo[2]);
      split_tf32(a_s[(g + 8) * S::SA + c0 + t + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < S::CT / 8; ++j) {
        const float2 w0 = w2[(c0 + t) * S::SB + j * 8 + g];
        const float2 w1 = w2[(c0 + t + 4) * S::SB + j * 8 + g];
        const uint32_t b_hi[2] = {__float_as_uint(w0.x), __float_as_uint(w1.x)};
        const uint32_t b_lo[2] = {__float_as_uint(w0.y), __float_as_uint(w1.y)};
        mma_3xtf32(part[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int j = 0; j < S::CT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  cp_async_wait<0>();

  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < S::CT / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col >= cout) continue;
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
    if (r0 < rows)
      *reinterpret_cast<float2*>(out_t + static_cast<size_t>(r0) * cout + col) =
          make_float2(acc[j][0] + b0, acc[j][1] + b1);
    if (r0 + 8 < rows)
      *reinterpret_cast<float2*>(out_t + static_cast<size_t>(r0 + 8) * cout +
                                 col) =
          make_float2(acc[j][2] + b0, acc[j][3] + b1);
  }
}

template <int CIN_P, int COUT_P>
int launch(const float* feat, const int32_t* slots, const float* weight,
           const float* bias, float* out, int batch, int vin, int vout, int k,
           int cin, int cout, cudaStream_t stream) {
  auto kernel = sparse_conv_kernel<CIN_P, COUT_P>;
  const int smem = block_smem_bytes(k, CIN_P, COUT_P);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool a_vec =
      cin % 4 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const bool w_vec = reinterpret_cast<uintptr_t>(weight) % 16 == 0;
  const dim3 grid((vout + TM - 1) / TM * Shape<CIN_P, COUT_P>::NCOL, batch);
  kernel<<<grid, THREADS, smem, stream>>>(feat, slots, weight, bias, out, vin,
                                          vout, k, cin, cout, slot_bytes(k),
                                          a_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory bytes one block needs (the kernel opts in above 48 KB;
// the wrapper refuses shapes above the 227 KB a block can have).
int sparse_conv_smem_bytes(int k, int cin, int cout) {
  return block_smem_bytes(k, pad_width(cin), pad_width(cout));
}

// feat [batch, vin, cin], slots [batch, vout, k] int32, weight
// [k, cin, cout], bias [cout] or null, out [batch, vout, cout]; all
// contiguous fp32 on the device. cin <= 64 and cout a power of two in
// [4, 64], or cout 128 and 32 < cin <= 128; k <= 64. Returns the CUDA
// error code of the launch.
int sparse_conv_launch(const float* feat, const int32_t* slots,
                       const float* weight, const float* bias, float* out,
                       int batch, int vin, int vout, int k, int cin,
                       int cout, cudaStream_t stream) {
  if (pad_width(cout) == 128) {
    const int cin_p = pad_width(cin);
    if (cin_p == 64)
      return launch<64, 128>(feat, slots, weight, bias, out, batch, vin, vout,
                             k, cin, cout, stream);
    if (cin_p == 128)
      return launch<128, 128>(feat, slots, weight, bias, out, batch, vin,
                              vout, k, cin, cout, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_widths<8>(
      pad_width(cin), pad_width(cout), [&](auto ci, auto co) {
        return launch<decltype(ci)::value, decltype(co)::value>(
            feat, slots, weight, bias, out, batch, vin, vout, k, cin, cout,
            stream);
      });
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
