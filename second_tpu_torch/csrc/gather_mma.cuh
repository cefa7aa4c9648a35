// Building blocks shared by K1 (sparse_conv.cu) and K2 (sparse_conv_dw.cu):
// cp.async row copies into shared memory, the 3xTF32 split and the TF32
// tensor-core product mma.sync.m16n8k8.
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
// exact in TF32's 10-bit mantissa; a product of two TF32 values is exact
// in fp32, so a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, accumulated in fp32,
// loses only a_lo*b_lo (~2^-22 of |a b|): fp32 accuracy from three
// tensor-core passes. One pass (a_hi*b_hi) keeps ~2^-11.
//
// Fragment layouts of m16n8k8 (.tf32), with g = lane / 4, t = lane % 4:
//   A [16 x 8] row-major: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                         a3 (g+8, t+4)
//   B [8 x 8]  col-major: b0 (t, g), b1 (t+4, g)
//   C [16 x 8]:           c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                         c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gather_mma {

// Row stride (floats) of a shared-memory tile whose fragments are read at
// (row t, column g): the 32 lanes hit 32 banks when the stride is 8 or 24
// mod 32. c is a multiple of 8.
__host__ __device__ constexpr int kmajor_stride(int c) {
  return c % 16 == 0 ? c + 8 : c;
}

// Round up to the next power of two >= 8 (the MMA tile widths).
inline int pad_width(int c) {
  int p = 8;
  while (p < c) p *= 2;
  return p;
}

template <int N>
using Width = std::integral_constant<int, N>;

// f(Width<CIN_P>, Width<COUT_P>) for padded widths in {8, 16, 32, 64}
// (cout_p >= MIN_COUT); cudaErrorInvalidValue for any other width.
template <int MIN_COUT, typename F>
int dispatch_widths(int cin_p, int cout_p, F&& f) {
  auto by_cout = [&](auto ci) -> int {
    switch (cout_p) {
      case 8:
        if constexpr (MIN_COUT <= 8) return f(ci, Width<8>{});
        break;
      case 16: return f(ci, Width<16>{});
      case 32: return f(ci, Width<32>{});
      case 64: return f(ci, Width<64>{});
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  switch (cin_p) {
    case 8: return by_cout(Width<8>{});
    case 16: return by_cout(Width<16>{});
    case 32: return by_cout(Width<32>{});
    case 64: return by_cout(Width<64>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 16-byte (cg) or 4-byte (ca) asynchronous copy global -> shared. When
// !valid the source size is 0: the destination is zero-filled and no
// byte is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Gather `rows` rows of n floats into dst (row stride `stride`), spread
// over the block's threads: row r is base[row_of(r) * n, +n), or zeros
// where row_of(r) < 0. vec: 16-byte copies (n % 4 == 0 and base 16-byte
// aligned), else 4-byte ones.
template <typename RowOf>
__device__ __forceinline__ void gather_rows_async(float* dst, int stride,
                                                  int rows, int n, bool vec,
                                                  const float* base,
                                                  RowOf row_of, int tid,
                                                  int threads) {
  const int w = vec ? 4 : 1;
  const int chunks = n / w;
  for (int i = tid; i < rows * chunks; i += threads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * w;
    const long long row = row_of(r);
    const float* src = row >= 0 ? base + row * n + c : base;
    if (vec) {
      cp_async16(dst + r * stride + c, src, row >= 0);
    } else {
      cp_async4(dst + r * stride + c, src, row >= 0);
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at fp32 accuracy: the two small terms first, then hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// Index of the lowest set bit of m, which it clears (m != 0).
__device__ __forceinline__ int pop_lowest(uint64_t& m) {
  const int i = __ffsll(static_cast<long long>(m)) - 1;
  m &= m - 1;
  return i;
}

__device__ __forceinline__ uint64_t warp_or(uint64_t m) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(m));
  const unsigned hi =
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(m >> 32));
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

}  // namespace gather_mma
