// K9 md_step and K10 verlet_top2: the MD step's per-atom work around the
// force call, one launch each.
//
// K9 is the velocity-Verlet kick and drift: v' = v + (c f) / m, then
// x' = x + dt v' (the mode, a template parameter, says which of the two run),
// and where asked step' = step + 1. K10 is the Verlet check's top-2 rule: the
// largest and second largest squared displacement d2 = (d0 d0 + d1 d1) + d2 d2
// of d = x - ref over the (real) rows, counted with multiplicity, written as
// [m1, m2] or tested as sqrt(m1) + sqrt(m2) + shrink > skin and OR-ed into a
// device flag in place.
//
// Neither replaces a Pallas kernel: the JAX package's integrator
// (mtp_tpu/md/integrators.py) and Verlet check (mtp_tpu/md/simulation.py)
// are XLA code, which XLA fuses. In the port they were chains of plain torch
// operations: 3 launches a half kick, 2 a drift, 1 the step count and 14 the
// check, each launch some 15-18 us of the host's time against well under a
// microsecond of the device's work. Their plain twins are in ops/md_step.py.
//
// Bound: a launch's latency. K9 moves ~64 B an atom as kick and drift (x, v,
// f and m read, x' and v' written): 2.0 MB at 32,000 atoms, 0.6 us at
// 3.35 TB/s. K10 reads 24 B an atom (x and ref): 0.8 MB at 32k, 3.1 MB at
// 131k, ~1 us. What the design does about it: one launch each, no scratch
// traffic past one partial a block, and no memset launch:
// - K9 runs a thread per element of the (N, 3) arrays; thread 0 also writes
//   the step count;
// - K10 keeps each thread's top two (and a count of NaNs) in registers,
//   merges them by warp shuffles and shared memory, and the last block to
//   finish (an atomic ticket in a scratch buffer that the wrapper keeps per
//   device and stream) merges the blocks' partials, writes the result and
//   sets the ticket back to 0 for the next launch.
//
// Arithmetic is __fmul_rn/__fdiv_rn/__fadd_rn/__fsub_rn/__fsqrt_rn (and
// their double forms), never contracted into FMAs, in the plain twins'
// order; the scalars c, dt, skin arrive as doubles and are rounded to the
// positions' type, as torch does with a Python scalar. So every output is
// bit-equal to the plain twin's. NaN as in the twin (torch.max propagates
// it, torch.argmax picks it): one NaN d2 gives [NaN, the largest other d2],
// two or more [NaN, NaN], and a NaN leaves the flag as it was.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K10's scratch: the ticket, then each block's NaN count and (m1, m2)
constexpr int kTop2MaxBlocks = 1024;
constexpr long long kNanOffset = 256;
constexpr long long kTopOffset = kNanOffset + 4LL * kTop2MaxBlocks;
constexpr long long kScratchBytes = kTopOffset + 16LL * kTop2MaxBlocks;

constexpr int kKick = 1, kDrift = 2;

template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
};

// ---------------------------------------------------------------- K9 ----

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    md_step_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ f,
                   const T* __restrict__ m, T* __restrict__ x_out, T* __restrict__ v_out,
                   const long long* __restrict__ step, long long* __restrict__ step_out, T c,
                   T dt, int n3) {
  using O = Ieee<T>;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (step != nullptr && e == 0) *step_out = *step + 1;
  if (e >= n3) return;
  T ve = v[e];
  if (kMode & kKick) {
    ve = O::add(ve, O::div(O::mul(c, f[e]), __ldg(m + e / 3)));
    v_out[e] = ve;
  }
  if (kMode & kDrift) x_out[e] = O::add(x[e], O::mul(dt, ve));
}

template <typename T>
int launch_md_step(int mode, const void* x, const void* v, const void* f, const void* m,
                   void* x_out, void* v_out, const void* step, void* step_out, double c,
                   double dt, int n3, cudaStream_t s) {
  int blocks = (n3 + kThreads - 1) / kThreads;
  if (blocks == 0) {
    if (step == nullptr) return 0;
    blocks = 1;  // the step count alone
  }
  const T* xt = (const T*)x;
  const T* vt = (const T*)v;
  const T* ft = (const T*)f;
  const T* mt = (const T*)m;
  const long long* st = (const long long*)step;
  long long* so = (long long*)step_out;
  if (mode == kKick) {
    md_step_kernel<T, kKick><<<blocks, kThreads, 0, s>>>(xt, vt, ft, mt, (T*)x_out, (T*)v_out,
                                                          st, so, (T)c, (T)dt, n3);
  } else if (mode == kDrift) {
    md_step_kernel<T, kDrift><<<blocks, kThreads, 0, s>>>(xt, vt, ft, mt, (T*)x_out, (T*)v_out,
                                                           st, so, (T)c, (T)dt, n3);
  } else if (mode == (kKick | kDrift)) {
    md_step_kernel<T, kKick | kDrift><<<blocks, kThreads, 0, s>>>(
        xt, vt, ft, mt, (T*)x_out, (T*)v_out, st, so, (T)c, (T)dt, n3);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- K10 ----

// the two largest values seen (with multiplicity; 0 before any, as every d2
// is >= 0) and the NaNs seen, at most 2
template <typename T>
struct Top2 {
  T m1, m2;
  int nan;
};

template <typename T>
__device__ __forceinline__ void push(Top2<T>& t, T x) {
  if (x != x) {
    t.nan = min(t.nan + 1, 2);
  } else if (x > t.m1) {
    t.m2 = t.m1;
    t.m1 = x;
  } else if (x > t.m2) {
    t.m2 = x;
  }
}

// the top two of the union of two multisets, each given by its top two
template <typename T>
__device__ __forceinline__ void merge(Top2<T>& t, T m1, T m2, int nan) {
  const T lo = t.m1 > m1 ? m1 : t.m1;
  const T second = t.m2 > m2 ? t.m2 : m2;
  t.m1 = t.m1 > m1 ? t.m1 : m1;
  t.m2 = lo > second ? lo : second;
  t.nan = min(t.nan + nan, 2);
}

// the block's top two, in thread 0
template <typename T>
__device__ __forceinline__ void block_merge(Top2<T>& t) {
  __shared__ T s1[kWarps], s2[kWarps];
  __shared__ int sn[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T m1 = __shfl_down_sync(kFull, t.m1, o);
    const T m2 = __shfl_down_sync(kFull, t.m2, o);
    const int nan = __shfl_down_sync(kFull, t.nan, o);
    merge(t, m1, m2, nan);
  }
  if (lane == 0) {
    s1[warp] = t.m1;
    s2[warp] = t.m2;
    sn[warp] = t.nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) merge(t, s1[w], s2[w], sn[w]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    verlet_top2_kernel(const T* __restrict__ x, const T* __restrict__ ref,
                       const unsigned char* __restrict__ real, int n,
                       unsigned char* __restrict__ scratch, T* __restrict__ tops,
                       unsigned char* __restrict__ flag, const T* __restrict__ shrink, T skin) {
  using O = Ieee<T>;
  unsigned* ticket = (unsigned*)scratch;
  int* part_nan = (int*)(scratch + kNanOffset);
  T* part_top = (T*)(scratch + kTopOffset);
  __shared__ bool last;

  Top2<T> t{T(0), T(0), 0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    if (real != nullptr && !real[i]) continue;  // the twin's where(real, d2, 0)
    const T d0 = O::sub(x[3 * i], ref[3 * i]);
    const T d1 = O::sub(x[3 * i + 1], ref[3 * i + 1]);
    const T d2 = O::sub(x[3 * i + 2], ref[3 * i + 2]);
    push(t, O::add(O::add(O::mul(d0, d0), O::mul(d1, d1)), O::mul(d2, d2)));
  }
  block_merge(t);
  if (threadIdx.x == 0) {
    part_top[2 * blockIdx.x] = t.m1;
    part_top[2 * blockIdx.x + 1] = t.m2;
    part_nan[blockIdx.x] = t.nan;
    __threadfence();  // the partial is visible before the ticket counts it
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  Top2<T> u{T(0), T(0), 0};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    merge(u, __ldcg(part_top + 2 * b), __ldcg(part_top + 2 * b + 1), __ldcg(part_nan + b));
  }
  block_merge(u);
  if (threadIdx.x == 0) {
    const T m1 = u.nan > 0 ? O::nan() : u.m1;
    const T m2 = u.nan > 1 ? O::nan() : u.nan == 1 ? u.m1 : u.m2;
    if (tops != nullptr) {
      tops[0] = m1;
      tops[1] = m2;
    }
    if (flag != nullptr && u.nan == 0) {
      T s = O::add(O::sqrt(m1), O::sqrt(m2));
      if (shrink != nullptr) s = O::add(s, *shrink);
      if (s > skin) *flag = 1;  // NaN (a NaN shrink) compares false
    }
    *ticket = 0u;  // ready for the next launch on this scratch
  }
}

}  // namespace

extern "C" long long mtp_verlet_top2_scratch_bytes() { return kScratchBytes; }

extern "C" int mtp_md_step(int mode, const void* x, const void* v, const void* f, const void* m,
                           void* x_out, void* v_out, const void* step, void* step_out, double c,
                           double dt, int n3, int is_double, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch_md_step<double>(mode, x, v, f, m, x_out, v_out, step, step_out, c, dt, n3, s)
             : launch_md_step<float>(mode, x, v, f, m, x_out, v_out, step, step_out, c, dt, n3, s);
}

extern "C" int mtp_verlet_top2(const void* x, const void* ref, const void* real, int n,
                               void* scratch, long long scratch_bytes, void* tops, void* flag,
                               const void* shrink, double skin, int is_double, void* stream) {
  if (n <= 0 || scratch_bytes < kScratchBytes) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kTop2MaxBlocks) blocks = kTop2MaxBlocks;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* re = (const unsigned char*)real;
  unsigned char* sc = (unsigned char*)scratch;
  unsigned char* fl = (unsigned char*)flag;
  if (is_double) {
    verlet_top2_kernel<double><<<blocks, kThreads, 0, s>>>(
        (const double*)x, (const double*)ref, re, n, sc, (double*)tops, fl,
        (const double*)shrink, skin);
  } else {
    verlet_top2_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)ref, re, n, sc, (float*)tops, fl, (const float*)shrink,
        (float)skin);
  }
  return (int)cudaGetLastError();
}
