// The bfloat16 instances of the multigrid kernels: K1 (poisson_separable.cu),
// K4/K5 (line_sweep.cu) and K6/K7 (tridiag_pcr.cu) on the low-precision
// hierarchy of the mixed-precision V-cycle (mg: {dtype: bfloat16}).
//
// bf16 is a bfloat16 value (two bytes, the bits of __nv_bfloat16) whose
// arithmetic is the rounding policy of those instances: every +, -, * and /
// is done in float32 and its result rounded to bfloat16 to nearest even
// (__float2bfloat16_rn), as PyTorch computes op by op on bfloat16 tensors
// (the plain twins) and as the JAX package's kernels compute on them.  A
// float32 result of two bfloat16 operands rounded once more to bfloat16 is
// the correctly rounded bfloat16 result (24 >= 2 * 8 + 2 bits), so the
// order of operations of the twin alone fixes every bit.  The float32 and
// float64 instances keep their own types, whose operators round once: one
// kernel source serves all three.
//
// The C entries of the bfloat16 instances take the values' bits as
// unsigned short and cast them with as_bf16: a function whose parameter
// types are local to this translation unit (this anonymous namespace) is
// not exported from the library.
//
// opmath_t<T> is the type a kernel takes a scalar argument in (omega):
// float for bf16, as PyTorch multiplies a bfloat16 tensor by a Python
// float in float32 and rounds the product once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

struct bf16 {
  unsigned short bits;

  bf16() = default;
  __host__ __device__ explicit bf16(float v) : bits(round_bits(v)) {}
  __host__ __device__ explicit bf16(int v)
      : bits(round_bits(static_cast<float>(v))) {}

  __device__ __forceinline__ float f() const {
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }

  // float to bfloat16, to nearest even (NaN stays NaN)
  static __host__ __device__ __forceinline__ unsigned short round_bits(
      float v) {
#ifdef __CUDA_ARCH__
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
#else
    unsigned u;
    std::memcpy(&u, &v, sizeof(u));
    if ((u & 0x7fffffffu) > 0x7f800000u)
      return static_cast<unsigned short>((u >> 16) | 0x40u);
    u += 0x7fffu + ((u >> 16) & 1u);
    return static_cast<unsigned short>(u >> 16);
#endif
  }

  static __device__ __forceinline__ bf16 from_bits(unsigned short b) {
    bf16 r;
    r.bits = b;
    return r;
  }
};

static_assert(sizeof(bf16) == 2, "bf16 is stored in two bytes");

__device__ __forceinline__ bf16 operator+(bf16 a, bf16 b) {
  return bf16(a.f() + b.f());
}
__device__ __forceinline__ bf16 operator-(bf16 a, bf16 b) {
  return bf16(a.f() - b.f());
}
__device__ __forceinline__ bf16 operator*(bf16 a, bf16 b) {
  return bf16(a.f() * b.f());
}
__device__ __forceinline__ bf16 operator/(bf16 a, bf16 b) {
  return bf16(a.f() / b.f());
}
// negation flips the sign bit, exactly
__device__ __forceinline__ bf16 operator-(bf16 a) {
  return bf16::from_bits(static_cast<unsigned short>(a.bits ^ 0x8000u));
}
__device__ __forceinline__ bf16& operator+=(bf16& a, bf16 b) {
  return a = a + b;
}
// a float32 scalar times a bfloat16 value, the product rounded once
__device__ __forceinline__ bf16 operator*(float s, bf16 v) {
  return bf16(s * v.f());
}

inline const bf16* as_bf16(const unsigned short* p) {
  return reinterpret_cast<const bf16*>(p);
}
inline bf16* as_bf16(unsigned short* p) { return reinterpret_cast<bf16*>(p); }
inline const bf16* const* as_bf16(const unsigned short* const* p) {
  return reinterpret_cast<const bf16* const*>(p);
}

template <typename T>
struct opmath {
  using type = T;
};
template <>
struct opmath<bf16> {
  using type = float;
};
template <typename T>
using opmath_t = typename opmath<T>::type;

// A read-only load through the texture path, bf16 included.
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  return __ldg(p);
}
__device__ __forceinline__ bf16 ldg(const bf16* p) {
  return bf16::from_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// A warp shuffle of one value, bf16 included (its bits in the low half).
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ bf16 shfl(bf16 v, int src) {
  return bf16::from_bits(static_cast<unsigned short>(
      __shfl_sync(0xffffffffu, static_cast<unsigned>(v.bits), src)));
}

}  // namespace
