// K11: the neighbor list's bin sort and cell table, one call of four kernels
// and a memset a build. From positions, the cell, the bin grid, the bin
// capacity and an optional real mask it makes the cell's inverse, each
// atom's bin, the stable order of the atoms by bin (non-real rows last, in a
// trash bin), the per-bin counts, the (bins, cap) cell table and the
// capacity-and-geometry flag; on the MD path (`sorted`) also the inverse
// order and the positions, real mask and bin coordinates in bin order, which
// is what K8 (neighbor_rows.cu) reads.
//
// Replaces no Pallas kernel: the JAX package's bin sort (mtp_tpu/ops/
// neighbors.py) is XLA code. Its plain twin is `cell_list_plain` in
// ops/neighbors.py, a chain of torch operations with a stable argsort and an
// index_put (some 100 launches; the MD path ran it twice a build, 195).
//
// Bound: a launch's latency. At 131,072 atoms it reads the positions
// (1.6 MB) and writes ~12 MB (order, inverse order, sorted positions and
// bin coordinates, a 9,261 x 44 table): ~4 us at 3.35 TB/s. What the design
// does about it:
// - a memset and four launches whatever N, with O(N + bins) scratch (a bin,
//   a slot and a segment entry an atom, a start a bin), so a box of 10^6
//   atoms fits as one of 10^3;
// - cell_list_bins: a thread an atom computes its bin and takes a slot in it
//   by atomicAdd on the counts; cell_list_scan: one block scans the counts
//   into bin starts and writes the flag; cell_list_fill: a thread an atom
//   puts its index at start + slot (the bin's segment, in the atomics'
//   order) and a thread a table entry writes the holes; cell_list_rank: a
//   thread an atom counts the smaller indices in its segment, which is its
//   place in the stable order, and writes every output at that place. The
//   count is a loop over the segment's own length as read on the device:
//   some 16 entries for a bin at 131k, thousands for the trash bin of the
//   sharded path, each warp's lanes reading one address where they share a
//   bin. So the result is deterministic whatever order the atomics took.
//
// Arithmetic is __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn (and
// their double forms), never contracted into FMAs, in the plain twin's
// order: the inverse in inverse_cell's closed form, the fractional
// coordinate as cell_product's column sum, f - floor(f), times the bin count,
// truncated and clamped; the plane spacings 1 / sqrt((a0 a0 + a1 a1) + a2 a2)
// of the inverse's columns over max(g, 2) against the threshold in the
// positions' type, as torch does with the Python scalar. So every output is
// bit-equal to the twin's, the table too: both fill a bin's first `cap`
// slots, and a bin past its capacity sets the flag.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;  // 32 warps: the scan's second level is one warp

template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float flr(float a) { return floorf(a); }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double flr(double a) { return floor(a); }
};

// (x0 m[a] + x1 m[3 + a]) + x2 m[6 + a]: column a of a row-major (3, 3) matrix
template <typename T>
__device__ __forceinline__ T column(T x0, T x1, T x2, const T* m, int a) {
  using O = Ieee<T>;
  return O::add(O::add(O::mul(x0, m[a]), O::mul(x1, m[3 + a])), O::mul(x2, m[6 + a]));
}

// inv = adj(cell) / det(cell), with A[r][k] = C[k+1][r+1] C[k+2][r+2] -
// C[k+1][r+2] C[k+2][r+1] (indices mod 3) and det = (C00 A00 + C01 A10) +
// C02 A20, as inverse_cell (ops/window_disp.py) and K1
template <typename T>
__device__ __forceinline__ void cell_inverse(const T* __restrict__ cell, T* inv) {
  using O = Ieee<T>;
  T c[9], a[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = __ldg(cell + k);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int k1 = (k + 1) % 3, k2 = (k + 2) % 3, r1 = (r + 1) % 3, r2 = (r + 2) % 3;
      a[3 * r + k] = O::sub(O::mul(c[3 * k1 + r1], c[3 * k2 + r2]),
                            O::mul(c[3 * k1 + r2], c[3 * k2 + r1]));
    }
  }
  const T det = O::add(O::add(O::mul(c[0], a[0]), O::mul(c[1], a[3])), O::mul(c[2], a[6]));
#pragma unroll
  for (int k = 0; k < 9; ++k) inv[k] = O::div(a[k], det);
}

// the bin of each atom and its slot in its sort bin (the trash bin `ncells`
// for a non-real row); thread 0 writes the inverse, and on the unsorted
// path each thread its bin coordinates in the atoms' own order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cell_list_bins(const T* __restrict__ pos, const T* __restrict__ cell,
                   const unsigned char* __restrict__ real, T* __restrict__ inv_out,
                   long long* __restrict__ bin3, unsigned long long* __restrict__ counts,
                   int* __restrict__ bin_of, int* __restrict__ slot, int n, int gx, int gy,
                   int gz) {
  using O = Ieee<T>;
  T ic[9];
  cell_inverse(cell, ic);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) inv_out[k] = ic[k];
  }
  if (i >= n) return;
  const T x0 = pos[3LL * i], x1 = pos[3LL * i + 1], x2 = pos[3LL * i + 2];
  const int g[3] = {gx, gy, gz};
  long long b[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T f = column(x0, x1, x2, ic, a);
    const T w = O::sub(f, O::flr(f));  // wrapped to [0, 1]
    // truncated toward zero, as torch's cast, and clamped: any input lands in the grid
    const long long v = (long long)O::mul(w, (T)g[a]);
    b[a] = v < 0 ? 0 : (v > g[a] - 1 ? g[a] - 1 : v);
  }
  const long long geo = (b[0] * gy + b[1]) * gz + b[2];
  if (bin3 != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) bin3[3LL * i + a] = b[a];
  }
  const long long sb = (real != nullptr && !real[i]) ? (long long)gx * gy * gz : geo;
  bin_of[i] = (int)geo;
  slot[i] = (int)atomicAdd(counts + sb, 1ULL);
}

// one block: the bins' starts (an exclusive scan of the counts), and the
// flag: a real bin over `cap`, or a binned axis narrower than the cutoff
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    cell_list_scan(const long long* __restrict__ counts, const T* __restrict__ inv,
                   long long* __restrict__ start, unsigned char* __restrict__ flag, int nbins,
                   int ncells, int cap, int gx, int gy, int gz, T thresh) {
  using O = Ieee<T>;
  __shared__ long long warp_end[32];
  __shared__ int warp_over[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nbins + kScanThreads - 1) / kScanThreads;
  const int lo = min(nbins, t * per), hi = min(nbins, lo + per);
  long long sum = 0;
  int over = 0;
  for (int b = lo; b < hi; ++b) {
    const long long c = counts[b];
    sum += c;
    over |= b < ncells && c > cap;
  }
  long long end = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += v;
  }
  over = __any_sync(kFull, over);
  if (lane == 31) warp_end[warp] = end;
  if (lane == 0) warp_over[warp] = over;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_end[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += v;
    }
    const int any = __any_sync(kFull, warp_over[lane]);
    warp_end[lane] = w;
    if (lane == 0) warp_over[0] = any;
  }
  __syncthreads();
  long long base = end - sum + (warp > 0 ? warp_end[warp - 1] : 0);
  for (int b = lo; b < hi; ++b) {
    start[b] = base;
    base += counts[b];
  }
  if (t == 0) {
    const int g[3] = {gx, gy, gz};
    int geom = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T s = O::add(O::add(O::mul(inv[a], inv[a]), O::mul(inv[3 + a], inv[3 + a])),
                         O::mul(inv[6 + a], inv[6 + a]));
      const T width = O::div((T)1, O::sqrt(s));  // the spacing of the planes across axis a
      geom |= O::div(width, (T)(g[a] > 2 ? g[a] : 2)) < thresh;
    }
    flag[0] = (unsigned char)(warp_over[0] || geom);
  }
}

// each atom's index into its bin's segment at start + slot; the table's
// holes (slot r of bin b with r >= count) set to -1
__global__ void __launch_bounds__(kThreads)
    cell_list_fill(const unsigned char* __restrict__ real, const int* __restrict__ bin_of,
                   const int* __restrict__ slot, const long long* __restrict__ start,
                   const long long* __restrict__ counts, int* __restrict__ segments,
                   long long* __restrict__ table, int n, int ncells, long long entries,
                   int cap) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const int i = (int)t;
    const int sb = (real != nullptr && !real[i]) ? ncells : bin_of[i];
    segments[start[sb] + slot[i]] = i;
  }
  if (t < entries) {
    const long long b = t / cap;
    if (t - b * cap >= counts[b]) table[t] = -1;
  }
}

// each atom's place in the stable order: its bin's start plus the number of
// smaller indices in its segment; every output written at that place
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cell_list_rank(const T* __restrict__ pos, const unsigned char* __restrict__ real,
                   const int* __restrict__ bin_of, const long long* __restrict__ start,
                   const long long* __restrict__ counts, const int* __restrict__ segments,
                   long long* __restrict__ order, long long* __restrict__ inv_order,
                   T* __restrict__ pos_sorted, unsigned char* __restrict__ real_sorted,
                   long long* __restrict__ bin3_sorted, long long* __restrict__ table, int n,
                   int ncells, int cap, int gy, int gz, int sorted) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int geo = bin_of[i];
  const int sb = (real != nullptr && !real[i]) ? ncells : geo;
  const long long s0 = start[sb];
  const long long len = counts[sb];
  const int* seg = segments + s0;
  int r0 = 0, r1 = 0, r2 = 0, r3 = 0;  // four sums in flight
  long long k = 0;
  for (; k + 4 <= len; k += 4) {
    r0 += __ldg(seg + k) < i;
    r1 += __ldg(seg + k + 1) < i;
    r2 += __ldg(seg + k + 2) < i;
    r3 += __ldg(seg + k + 3) < i;
  }
  for (; k < len; ++k) r0 += __ldg(seg + k) < i;
  const int rank = (r0 + r1) + (r2 + r3);
  const long long at = s0 + rank;
  if (!sorted) {
    if (rank < cap) table[(long long)sb * cap + rank] = i;
    return;
  }
  if (rank < cap) table[(long long)sb * cap + rank] = at;
  order[at] = i;
  inv_order[i] = at;
#pragma unroll
  for (int a = 0; a < 3; ++a) pos_sorted[3 * at + a] = pos[3LL * i + a];
  if (real_sorted != nullptr) real_sorted[at] = real[i];
  bin3_sorted[3 * at] = geo / (gy * gz);
  bin3_sorted[3 * at + 1] = geo / gz % gy;
  bin3_sorted[3 * at + 2] = geo % gz;
}

template <typename T>
int launch(const T* pos, const T* cell, const unsigned char* real, T* inv, long long* order,
           long long* inv_order, T* pos_sorted, unsigned char* real_sorted, long long* bin3,
           long long* counts, long long* table, unsigned char* flag, int* scratch,
           long long* start, int n, int gx, int gy, int gz, int cap, double thresh, int sorted,
           cudaStream_t s) {
  const int ncells = gx * gy * gz, nbins = ncells + (real != nullptr);
  const long long entries = (long long)nbins * cap;
  int* bin_of = scratch;
  int* slot = scratch + n;
  int* segments = scratch + 2LL * n;
  const cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(long long) * nbins, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;  // one writes the inverse
  cell_list_bins<T><<<blocks, kThreads, 0, s>>>(
      pos, cell, real, inv, sorted ? nullptr : bin3, (unsigned long long*)counts, bin_of, slot,
      n, gx, gy, gz);
  cell_list_scan<T><<<1, kScanThreads, 0, s>>>(counts, inv, start, flag, nbins, ncells, cap, gx,
                                                gy, gz, (T)thresh);
  const long long threads = entries > n ? entries : n;
  cell_list_fill<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      real, bin_of, slot, start, counts, segments, table, n, ncells, entries, cap);
  if (n > 0) {
    cell_list_rank<T><<<blocks, kThreads, 0, s>>>(pos, real, bin_of, start, counts, segments,
                                                  order, inv_order, pos_sorted, real_sorted,
                                                  bin3, table, n, ncells, cap, gy, gz, sorted);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sorted != 0: order, inv_order, pos_sorted and (with real) real_sorted are
// written, bin3 is in bin order and the table holds sorted rows; sorted == 0:
// those four are unused (may be null), bin3 is in the atoms' own order and
// the table holds their indices. scratch: 3 n ints; start: nbins long longs.
extern "C" int mtp_cell_list(const void* pos, const void* cell, const void* real, void* inv,
                             void* order, void* inv_order, void* pos_sorted, void* real_sorted,
                             void* bin3, void* counts, void* table, void* flag, void* scratch,
                             void* start, int n, int gx, int gy, int gz, int cap, double thresh,
                             int sorted, int is_double, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* re = (const unsigned char*)real;
  long long* o = (long long*)order;
  long long* io = (long long*)inv_order;
  unsigned char* rs = (unsigned char*)real_sorted;
  long long* b3 = (long long*)bin3;
  long long* cn = (long long*)counts;
  long long* tb = (long long*)table;
  unsigned char* fl = (unsigned char*)flag;
  int* sc = (int*)scratch;
  long long* st = (long long*)start;
  if (is_double) {
    return launch<double>((const double*)pos, (const double*)cell, re, (double*)inv, o, io,
                          (double*)pos_sorted, rs, b3, cn, tb, fl, sc, st, n, gx, gy, gz, cap,
                          thresh, sorted, s);
  }
  return launch<float>((const float*)pos, (const float*)cell, re, (float*)inv, o, io,
                       (float*)pos_sorted, rs, b3, cn, tb, fl, sc, st, n, gx, gy, gz, cap, thresh,
                       sorted, s);
}
