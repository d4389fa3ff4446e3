// K1: the window path's whole pair geometry in one kernel: minimum-image
// displacements dispT (3, J, N) and the pair mask maskf (J, N).
//
// Replaces the TPU kernel mtp_tpu/ops/window_disp.py:121 `_disp_kernel`
// (called through `window_disp`, :171) together with the mask that its
// caller builds from it (mtp_tpu/models/mtp.py:396-400). The TPU has no
// general in-VMEM gather, so that kernel walks per-tile worklists of 128-atom
// chunks and resolves each with lane shuffles. Hopper loads any address, so
// this is a direct indexed gather; the worklists are not ported.
//
// Bound: memory. Per pair it reads a 4-byte index and a 1-byte validity flag
// and writes 12 bytes of displacement and a 4-byte mask; the 12-byte
// neighbor position is a gather that the bin sort keeps close in memory (L1
// and L2 hits). What the design does about it:
// - every index and flag load and every store is coalesced: the list comes
//   transposed, idx_t (J, N) (a per-rebuild constant, as the TPU kernel reads
//   idxT), and a warp runs 32 consecutive atoms i of one slot s;
// - a block stages its 128 atoms' own positions in shared memory once and
//   walks a group of slots, so each thread has several independent gathers
//   in flight (neighbor positions through the read-only path);
// - the cell's inverse is computed in each thread in a fixed closed form
//   (adjugate over determinant) from the cell it is given: no per-step host
//   operations, and a changed cell is honoured.
//
// Arithmetic is written with __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn, which
// nvcc never contracts into FMAs, in the operation order of the plain twin
// (ops/window_disp.py `inverse_cell`, `image_components`, `window_geometry_plain`),
// so displacements and mask are bit-identical to it: the distance test at
// d == cutoff agrees between the two. rintf rounds half to even, as
// jnp.round and torch.round do.

#include <cuda_runtime.h>

namespace {

constexpr int kTileAtoms = 128;  // atoms per block (threadIdx.x)
constexpr int kSlotRows = 2;     // slot rows per block (threadIdx.y)
constexpr int kSlotsPerBlock = 16;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// inv = adj(cell) / det(cell), with A[r][k] = C[k+1][r+1] C[k+2][r+2] -
// C[k+1][r+2] C[k+2][r+1] (indices mod 3) and det = (C00 A00 + C01 A10) + C02 A20
__device__ __forceinline__ void cell_inverse(const float* c, float* inv) {
  float a[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int k1 = (k + 1) % 3, k2 = (k + 2) % 3, r1 = (r + 1) % 3, r2 = (r + 2) % 3;
      a[3 * r + k] = __fsub_rn(__fmul_rn(c[3 * k1 + r1], c[3 * k2 + r2]),
                               __fmul_rn(c[3 * k1 + r2], c[3 * k2 + r1]));
    }
  }
  const float det = dot3(c[0], c[1], c[2], a[0], a[3], a[6]);
#pragma unroll
  for (int k = 0; k < 9; ++k) inv[k] = __fdiv_rn(a[k], det);
}

__global__ void __launch_bounds__(kTileAtoms* kSlotRows)
    window_geometry_kernel(const float* __restrict__ pos, const int* __restrict__ idx_t,
                           const unsigned char* __restrict__ valid_t,
                           const float* __restrict__ cell, float* __restrict__ disp,
                           float* __restrict__ mask, int n, int j, float cut2) {
  __shared__ float own[3 * kTileAtoms];
  const int i0 = blockIdx.x * kTileAtoms;
  const int rows = min(kTileAtoms, n - i0);
  const int tid = threadIdx.y * kTileAtoms + threadIdx.x;
  for (int t = tid; t < 3 * rows; t += kTileAtoms * kSlotRows) own[t] = pos[3LL * i0 + t];
  float c[9], ic[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = __ldg(cell + k);
  cell_inverse(c, ic);
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const int i = i0 + threadIdx.x;
  const float x0 = own[3 * threadIdx.x], x1 = own[3 * threadIdx.x + 1],
              x2 = own[3 * threadIdx.x + 2];
  const long long jn = (long long)j * n;
  const int s_end = min(j, (int)(blockIdx.y + 1) * kSlotsPerBlock);
#pragma unroll 4
  for (int s = blockIdx.y * kSlotsPerBlock + threadIdx.y; s < s_end; s += kSlotRows) {
    const long long p = (long long)s * n + i;
    const int nb = __ldg(idx_t + p);
    const bool ok = __ldg(valid_t + p) != 0;
    const float d0 = __fsub_rn(__ldg(pos + 3LL * nb), x0);
    const float d1 = __fsub_rn(__ldg(pos + 3LL * nb + 1), x1);
    const float d2 = __fsub_rn(__ldg(pos + 3LL * nb + 2), x2);
    float f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fa = dot3(d0, d1, d2, ic[a], ic[3 + a], ic[6 + a]);
      f[a] = __fsub_rn(fa, rintf(fa));
    }
    const float r0 = dot3(f[0], f[1], f[2], c[0], c[3], c[6]);
    const float r1 = dot3(f[0], f[1], f[2], c[1], c[4], c[7]);
    const float r2 = dot3(f[0], f[1], f[2], c[2], c[5], c[8]);
    disp[p] = r0;
    disp[jn + p] = r1;
    disp[2 * jn + p] = r2;
    mask[p] = (ok && dot3(r0, r1, r2, r0, r1, r2) <= cut2) ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int mtp_window_geometry(const void* pos, const void* idx_t, const void* valid_t,
                                   const void* cell, void* disp, void* mask, int n, int j,
                                   float cut2, void* stream) {
  if (n == 0 || j == 0) return 0;
  const dim3 block(kTileAtoms, kSlotRows);
  const dim3 grid((n + kTileAtoms - 1) / kTileAtoms, (j + kSlotsPerBlock - 1) / kSlotsPerBlock);
  window_geometry_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const int*)idx_t, (const unsigned char*)valid_t,
      (const float*)cell, (float*)disp, (float*)mask, n, j, cut2);
  return (int)cudaGetLastError();
}
