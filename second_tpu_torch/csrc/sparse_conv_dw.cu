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
// What bounds it on the card: like K1, the random row gathers and one
// shared-memory load per FMA; the work is a [K*Cin, Cout] product reduced
// over B*Vout rows, so it is a reduction across the whole rulebook.
// Design: the grid runs over (offset k, row split s). A block walks its
// split's rows in tiles of TR = 64: it stages the tile's slots at offset
// k, skips the tile when every slot misses (padding rows, offsets with no
// neighbour), else gathers the TR feature rows and the TR dout rows into
// shared memory and accumulates its [Cin, Cout] partial in fp32 registers
// (Cin * Cout / 256 <= 16 outputs per thread). Each block writes its
// partial to partial[s, k]; a second launch sums the S partials of every
// element in split order. No atomics: two calls give bitwise-equal dW.
// wgmma, TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;
constexpr int THREADS = 256;
constexpr int MAX_ACC = 16;  // Cin * Cout / THREADS for Cin, Cout <= 64

__global__ void __launch_bounds__(THREADS)
sparse_conv_dw_partial(const float* __restrict__ feat,
                       const int32_t* __restrict__ slots,
                       const float* __restrict__ dout,
                       float* __restrict__ partial,
                       int batch, int vin, int vout, int k, int cin,
                       int cout, long long rows_per_split) {
  extern __shared__ float smem[];
  float* a_s = smem;                 // [TR, cin] gathered input rows
  float* d_s = a_s + TR * cin;       // [TR, cout] output-gradient rows
  int32_t* g_s = reinterpret_cast<int32_t*>(d_s + TR * cout);  // [TR]

  const int kk = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const long long total = static_cast<long long>(batch) * vout;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(total, r_begin + rows_per_split);

  // thread owns outputs (ci0 + i * ci_step, co): cout divides THREADS
  const int co = tid % cout;
  const int ci0 = tid / cout;
  const int ci_step = THREADS / cout;
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;

  for (long long row0 = r_begin; row0 < r_end; row0 += TR) {
    const int rows = static_cast<int>(min(static_cast<long long>(TR),
                                          r_end - row0));
    int hit = 0;
    if (tid < TR) {
      int g = -1;  // global feature row b * vin + slot, -1 on a miss
      if (tid < rows) {
        const long long r = row0 + tid;
        const int b = static_cast<int>(r / vout);
        const int s = slots[r * k + kk];
        if (s >= 0 && s < vin) g = b * vin + s;
      }
      g_s[tid] = g;
      hit = g >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // the whole tile misses
    for (int i = tid; i < TR * cin; i += THREADS) {
      const int r = i / cin;
      const int g = g_s[r];
      a_s[i] = g >= 0 ? feat[static_cast<size_t>(g) * cin + (i - r * cin)]
                      : 0.f;
    }
    const float* dout_t = dout + static_cast<size_t>(row0) * cout;
    for (int i = tid; i < TR * cout; i += THREADS) {
      d_s[i] = i < rows * cout ? dout_t[i] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < TR; ++r) {
      const float dv = d_s[r * cout + co];
      const float* a_r = a_s + r * cin;
#pragma unroll
      for (int i = 0; i < MAX_ACC; ++i) {
        const int ci = ci0 + i * ci_step;
        if (ci < cin) acc[i] += a_r[ci] * dv;
      }
    }
    __syncthreads();
  }

  float* part = partial + (static_cast<size_t>(split) * k + kk) * cin * cout;
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int ci = ci0 + i * ci_step;
    if (ci < cin) part[ci * cout + co] = acc[i];
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

}  // namespace

extern "C" {

// Shared memory bytes one block of the first launch needs; the wrapper
// refuses shapes above the 48 KB a block gets without opting in.
int sparse_conv_dw_smem_bytes(int cin, int cout) {
  return static_cast<int>(sizeof(float)) * TR * (cin + cout) +
         static_cast<int>(sizeof(int32_t)) * TR;
}

// feat [batch, vin, cin], slots [batch, vout, k] int32, dout
// [batch, vout, cout], partial [splits, k, cin, cout] scratch, dw
// [k, cin, cout]; all contiguous fp32 (slots int32) on the device. cout
// must divide 256 and cin * cout <= 4096; splits * rows_per_split must
// cover batch * vout. Returns cudaGetLastError() after the two launches.
int sparse_conv_dw_launch(const float* feat, const int32_t* slots,
                          const float* dout, float* partial, float* dw,
                          int batch, int vin, int vout, int k, int cin,
                          int cout, int splits, long long rows_per_split,
                          cudaStream_t stream) {
  const dim3 grid(k, splits);
  const size_t smem = static_cast<size_t>(sparse_conv_dw_smem_bytes(cin, cout));
  sparse_conv_dw_partial<<<grid, THREADS, smem, stream>>>(
      feat, slots, dout, partial, batch, vin, vout, k, cin, cout,
      rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = k * cin * cout;
  sparse_conv_dw_reduce<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      partial, dw, splits, n);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
