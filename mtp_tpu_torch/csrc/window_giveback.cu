// K3: Newton give-back, forces F[i] = sum_s (T[:, s, i] - T[:, mirror(i*J+s)]).
//
// Replaces the TPU kernel mtp_tpu/ops/window_giveback.py:173 `_gb_kernel`
// (called through `window_giveback`, :242) together with its XLA spill
// gather (:292-298), and fuses in the own-slot sum of
// mtp_tpu/models/mtp.py:404-425. The TPU has no atomics and no 2-D in-VMEM
// gather, so that kernel needs octant-aligned slots, band tables and a spill
// path for misaligned pairs. Hopper gathers any address: one thread per atom
// reads its J own pair forces and the J mirrored ones through the flat
// mirror permutation. No atomics, so the sum is deterministic.
//
// Bound: memory (and gather latency). Per atom it reads J indices, J own and
// J mirrored 3-vectors of pair_T (3, J, N). The own reads T[c, s, i] are
// coalesced across the warp (i fastest); the mirrored reads are scattered,
// but the mirrored atoms of a bin-sorted list are close, so they hit L2.
//
// Masked slots of T are zero and padding entries mirror among themselves
// (ops/neighbors.py mirror_permutation), so no mask is needed here.

#include <cuda_runtime.h>

namespace {

__global__ void giveback_kernel(const float* __restrict__ T, const int* __restrict__ mirror,
                                float* __restrict__ out, int n, int j) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long jn = (long long)j * n;
  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  for (int s = 0; s < j; ++s) {
    const int q = mirror[(long long)i * j + s];
    const int iq = q / j;
    const int sq = q - iq * j;
    const long long own = (long long)s * n + i;
    const long long oth = (long long)sq * n + iq;
    f0 += T[own] - T[oth];
    f1 += T[jn + own] - T[jn + oth];
    f2 += T[2 * jn + own] - T[2 * jn + oth];
  }
  out[3LL * i] = f0;
  out[3LL * i + 1] = f1;
  out[3LL * i + 2] = f2;
}

}  // namespace

extern "C" int mtp_window_giveback(const void* pair_T, const void* mirror, void* out, int n,
                                   int j, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  giveback_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pair_T, (const int*)mirror, (float*)out, n, j);
  return (int)cudaGetLastError();
}
