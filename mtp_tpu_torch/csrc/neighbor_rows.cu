// K8: the neighbor list's row phase in one kernel: for every centre row, the
// candidates of its bin stencil filtered by the minimum-image distance, kept
// ascending and padded with the row's own index, as (centers, J) int32 rows;
// beside them the largest kept count of any row (atomicMax), from which the
// caller makes the overflow flag on the device.
//
// Replaces no Pallas kernel: the JAX package's row phase is XLA code
// (mtp_tpu/ops/neighbors.py). Its plain twin is `neighbor_rows_plain` in
// ops/neighbors.py, a loop over blocks of rows of torch gathers, elementwise
// passes and two sorts (some 1,300 launches a rebuild at 131,072 atoms).
//
// Bound: operations. At 131,072 atoms, 27 bins of ~14 atoms a row make ~50 M
// candidate tests of 45 operations (2.3 GFLOP, 34 us at 67 TFLOP/s); it
// reads the cell table (3.3 MB), bin coordinates (3.1 MB) and positions
// (1.6 MB) and writes the rows (33.6 MB), 12 us at 3.35 TB/s. What the
// design does about it:
// - one warp per centre row, consecutive rows in neighbouring warps: on the
//   MD path the rows are bin-sorted, so the warps of a block read the same
//   stencil's table rows and positions (L1/L2 hits; at 131k all of it fits
//   in L2);
// - the row's candidates are one list: lane q holds stencil bin q's table
//   row and filled slots (the bin counts), a warp scan gives each bin's
//   start, and the lanes walk the list 32 at a time, each finding its bin by
//   a binary search over the starts (shuffles). So every lane of a pass
//   tests a candidate (~12 passes a row at 131k, where walking bin by bin
//   took 27 half-empty ones), and shared memory does not grow with the bin
//   capacity times the stencil: a small box of one or two bins an axis has
//   a capacity over 1,000;
// - __ballot_sync + __popc append the kept indices to the warp's J-entry
//   buffer in shared memory, counting every kept candidate, those past J
//   included (the count is what flags overflow);
// - the buffer, its empty entries set to the row's own index, is sorted in
//   the warp (bitonic over the next power of two of J, so any J works) and
//   stored coalesced.
// Measured on an H100 at 131,072 bin-sorted atoms: 0.44 ms, against 0.87 ms
// walking the stencil bin by bin.
//
// Arithmetic is __fsub_rn/__fmul_rn/__fadd_rn (and their double forms),
// never contracted into FMAs, in the plain twin's order: the fractional
// displacement (cell_product with the inverse), f - rint(f) (half to even, as
// torch.round), cell_product with the cell, (r0 r0 + r1 r1) + r2 r2, tested
// against cut2 in the positions' type, as torch does with the Python scalar.
// So with no capacity exceeded the rows equal the plain twin's bit for bit.
// Under overflow only the count has to agree (the kernel keeps the first J
// in walk order, the twin the J smallest indices); callers discard such a
// list and rebuild larger.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;            // rows a block
constexpr int kSmemBudget = 47 * 1024;  // the J-entry buffers' bytes, under the 48 KB default

template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float rnd(float a) { return rintf(a); }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double rnd(double a) { return rint(a); }
};

// (x0 m[a] + x1 m[3 + a]) + x2 m[6 + a]: column a of a row-major (3, 3) matrix
template <typename T>
__device__ __forceinline__ T column(T x0, T x1, T x2, const T* m, int a) {
  using O = Ieee<T>;
  return O::add(O::add(O::mul(x0, m[a]), O::mul(x1, m[3 + a])), O::mul(x2, m[6 + a]));
}

// the k-th bin coordinate of an axis's stencil (g bins, the centre in bin
// b): b - 1, b, b + 1 (mod g) for g >= 3, every bin once for g of 1 or 2
__device__ __forceinline__ long long stencil_bin(long long b, int k, int g) {
  return g < 3 ? k : (b - 1 + k + g) % g;
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    neighbor_rows_kernel(const T* __restrict__ pos, const long long* __restrict__ bin3,
                         const long long* __restrict__ table,
                         const long long* __restrict__ counts,
                         const unsigned char* __restrict__ real, const T* __restrict__ cell,
                         const T* __restrict__ inv_cell, int* __restrict__ idx,
                         int* __restrict__ max_count, int centers, int j, int p2, int cap,
                         int gx, int gy, int gz, T cut2, int self_image) {
  using O = Ieee<T>;
  extern __shared__ int smem[];
  __shared__ int block_max;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* buf = smem + warp * p2;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (threadIdx.x == 0) block_max = 0;
  __syncthreads();
  if (row < centers) {  // uniform over the warp
    for (int s = lane; s < p2; s += 32) buf[s] = s < j ? row : INT_MAX;
    __syncwarp();
    int* out = idx + (long long)row * j;
    int count = 0;
    if (real == nullptr || real[row]) {
      T c[9], ic[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        c[k] = __ldg(cell + k);
        ic[k] = __ldg(inv_cell + k);
      }
      const T x0 = pos[3LL * row], x1 = pos[3LL * row + 1], x2 = pos[3LL * row + 2];
      // lane q < K holds stencil bin q: its table row and filled slots, and
      // where its slots start in the row's candidate list
      const int n1 = min(gy, 3), n2 = min(gz, 3), nk = min(gx, 3) * n1 * n2;
      long long slots = 0;
      int filled = 0;
      if (lane < nk) {
        const long long b = (stencil_bin(bin3[3LL * row], lane / (n1 * n2), gx) * gy +
                             stencil_bin(bin3[3LL * row + 1], lane / n2 % n1, gy)) * gz +
                            stencil_bin(bin3[3LL * row + 2], lane % n2, gz);
        slots = b * cap;
        filled = (int)min((long long)cap, __ldg(counts + b));  // a bin over cap flags overflow
      }
      int end = filled;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, end, d);
        if (lane >= d) end += v;
      }
      const int total = __shfl_sync(kFull, end, 31);
      const int first = lane < nk ? end - filled : INT_MAX;
      const T eps = (T)1e-12;
      for (int t0 = 0; t0 < total; t0 += 32) {
        const int t = t0 + lane;
        int q = 0;  // the last stencil bin whose slots start at or before t
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(kFull, first, q + step) <= t) q += step;
        }
        const long long at_q = __shfl_sync(kFull, slots, q) - __shfl_sync(kFull, first, q);
        bool keep = false;
        long long cand = -1;
        if (t < total) {
          cand = __ldg(table + at_q + t);
          const T d0 = O::sub(__ldg(pos + 3 * cand), x0);
          const T d1 = O::sub(__ldg(pos + 3 * cand + 1), x1);
          const T d2 = O::sub(__ldg(pos + 3 * cand + 2), x2);
          T f[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const T fa = column(d0, d1, d2, ic, a);
            f[a] = O::sub(fa, O::rnd(fa));
          }
          const T r0 = column(f[0], f[1], f[2], c, 0);
          const T r1 = column(f[0], f[1], f[2], c, 1);
          const T r2 = column(f[0], f[1], f[2], c, 2);
          const T rr = O::add(O::add(O::mul(r0, r0), O::mul(r1, r1)), O::mul(r2, r2));
          keep = rr <= cut2 && (cand != row || (self_image && rr > eps));
        }
        const unsigned kept = __ballot_sync(kFull, keep);
        const int at = count + __popc(kept & below);
        if (keep && at < j) buf[at] = (int)cand;
        count += __popc(kept);
      }
      __syncwarp();
      // bitonic sort of buf[0, p2) ascending; the INT_MAX pads stay past j
      for (int k = 2; k <= p2; k <<= 1) {
        for (int h = k >> 1; h > 0; h >>= 1) {
          for (int t = lane; t < (p2 >> 1); t += 32) {
            const int lo = 2 * t - (t & (h - 1)), hi = lo + h;
            const int a = buf[lo], b = buf[hi];
            if ((a > b) == ((lo & k) == 0)) {
              buf[lo] = b;
              buf[hi] = a;
            }
          }
          __syncwarp();
        }
      }
    }
    for (int s = lane; s < j; s += 32) out[s] = buf[s];
    if (lane == 0 && count > 0) atomicMax(&block_max, count);
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_max > 0) atomicMax(max_count, block_max);
}

int pow2_at_least(int v) {
  int p = 32;
  while (p < v) p <<= 1;
  return p;
}

// rows a block for a J: as many warps (at most 8) as the J-entry buffers
// leave room for; 0 when one buffer does not fit (J over 8,192)
int warps_for(int j) {
  const int fit = kSmemBudget / (pow2_at_least(j) * (int)sizeof(int));
  return fit < kMaxWarps ? fit : kMaxWarps;
}

}  // namespace

extern "C" int mtp_neighbor_rows(const void* pos, const void* bin3, const void* table,
                                 const void* counts, const void* real, const void* cell,
                                 const void* inv_cell, void* idx, void* max_count, int centers,
                                 int j, int cap, int gx, int gy, int gz, double cut2,
                                 int self_image, int is_double, void* stream) {
  if (centers == 0 || j == 0) return 0;
  const int warps = warps_for(j);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int p2 = pow2_at_least(j);
  const dim3 grid((centers + warps - 1) / warps), block(32 * warps);
  const size_t smem = (size_t)warps * p2 * sizeof(int);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* b3 = (const long long*)bin3;
  const long long* tab = (const long long*)table;
  const long long* cnt = (const long long*)counts;
  const unsigned char* re = (const unsigned char*)real;
  if (is_double) {
    neighbor_rows_kernel<double><<<grid, block, smem, s>>>(
        (const double*)pos, b3, tab, cnt, re, (const double*)cell, (const double*)inv_cell,
        (int*)idx, (int*)max_count, centers, j, p2, cap, gx, gy, gz, cut2, self_image);
  } else {
    neighbor_rows_kernel<float><<<grid, block, smem, s>>>(
        (const float*)pos, b3, tab, cnt, re, (const float*)cell, (const float*)inv_cell,
        (int*)idx, (int*)max_count, centers, j, p2, cap, gx, gy, gz, (float)cut2, self_image);
  }
  return (int)cudaGetLastError();
}
