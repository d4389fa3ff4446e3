// K3: Newton give-back, forces F[i] = sum_s (T[:, s, i] - T[:, mirror(s, i)]).
//
// Replaces the TPU kernel mtp_tpu/ops/window_giveback.py:173 `_gb_kernel`
// (called through `window_giveback`, :242) together with its XLA spill
// gather (:292-298), and fuses in the own-slot sum of
// mtp_tpu/models/mtp.py:404-425. The TPU has no atomics and no 2-D in-VMEM
// gather, so that kernel needs octant-aligned slots, band tables and a spill
// path for misaligned pairs. Hopper gathers any address, so this reads the
// mirrored pair force directly through mirror_t (J, N), a per-rebuild
// constant holding each slot's mirror as a flat offset sq * N + iq into one
// (J, N) plane of T (3, J, N).
//
// Bound: memory. Per pair it reads a 4-byte offset and 12 bytes of own pair
// force, coalesced, and gathers the mirrored 12 bytes: three scattered
// 4-byte loads, one 32-byte sector each, from the three planes of T. Those
// sector requests, not the bytes, set the time (on an H100 at 32k atoms,
// skipping the ~30% of slots that are pads or beyond the cutoff saved
// almost nothing, while the gathers' L1 reuse decided it). Every element of
// T is gathered once, and the pairs that gather one sector's 8 elements
// belong to atoms close in the bin-sorted order. What the design does:
// - mirror_t and T's own rows are read with consecutive atoms on
//   consecutive lanes (whole sectors);
// - a 512-thread block covers a contiguous range of atoms, so the gathers
//   that share a sector tend to meet in one SM's L1;
// - while T and mirror_t fit in L2 (32k atoms at J = 64: 33 MB of a 50 MB
//   L2), the gathers are L2 hits and L1 reuse is what is left to win: a warp
//   holds 16 atoms in each of 2 slot groups (lane = 16 g + a), 256 atoms per
//   block, about one block per SM; past L2 the gathers go to device memory
//   and one thread per atom (512 atoms per block) keeps more of them in
//   flight per byte of L1. Both were the fastest of the layouts tried at
//   their sizes (32k-55k and 70k-108k atoms; 1-16 slot groups, 128-1024
//   threads, persistent blocks, L1-bypassing streams);
// - the slot groups' partial sums are added with a butterfly shuffle in a
//   fixed order: no atomics, so two launches are bit-equal.
//
// Masked slots of T are zero and padding entries mirror among themselves
// (ops/neighbors.py mirror_permutation), so no mask is needed here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <int kGroups>  // slot groups per atom; a warp holds 32 / kGroups atoms
__global__ void __launch_bounds__(kThreads)
    giveback_kernel(const float* __restrict__ T, const int* __restrict__ mirror_t,
                    float* __restrict__ out, int n, int j) {
  constexpr int kAtomsPerWarp = 32 / kGroups;
  const int lane = threadIdx.x & 31;
  const int a = lane % kAtomsPerWarp;
  const int g = lane / kAtomsPerWarp;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int i = warp * kAtomsPerWarp + a;
  const bool live = i < n;
  const long long jn = (long long)j * n;
  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  if (live) {
#pragma unroll 4
    for (int s = g; s < j; s += kGroups) {
      const long long own = (long long)s * n + i;
      const int q = __ldg(mirror_t + own);
      f0 += __fsub_rn(__ldg(T + own), __ldg(T + q));
      f1 += __fsub_rn(__ldg(T + jn + own), __ldg(T + jn + q));
      f2 += __fsub_rn(__ldg(T + 2 * jn + own), __ldg(T + 2 * jn + q));
    }
  }
#pragma unroll
  for (int off = kAtomsPerWarp; off < 32; off <<= 1) {
    f0 += __shfl_xor_sync(0xffffffffu, f0, off);
    f1 += __shfl_xor_sync(0xffffffffu, f1, off);
    f2 += __shfl_xor_sync(0xffffffffu, f2, off);
  }
  if (live && g == 0) {
    out[3LL * i] = f0;
    out[3LL * i + 1] = f1;
    out[3LL * i + 2] = f2;
  }
}

template <int kGroups>
int launch(const void* pair_T, const void* mirror_t, void* out, int n, int j, void* stream) {
  const long long threads = (long long)n * kGroups;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  giveback_kernel<kGroups><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pair_T, (const int*)mirror_t, (float*)out, n, j);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mtp_window_giveback(const void* pair_T, const void* mirror_t, void* out, int n,
                                   int j, void* stream) {
  if (n == 0) return 0;
  int dev = 0, l2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return (int)err;
  // pair_T (12 bytes per slot) and mirror_t (4) fit in L2: two slot groups
  if (16LL * j * n <= l2) return launch<2>(pair_T, mirror_t, out, n, j, stream);
  return launch<1>(pair_T, mirror_t, out, n, j, stream);
}
