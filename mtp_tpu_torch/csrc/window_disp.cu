// K1: per-pair minimum-image displacements, dispT (3, J, N).
//
// Replaces the TPU kernel mtp_tpu/ops/window_disp.py:121 `_disp_kernel`
// (called through `window_disp`, :171). The TPU has no general in-VMEM
// gather, so that kernel walks per-tile worklists of 128-atom chunks and
// resolves each with lane shuffles. Hopper loads any address, so this is a
// direct indexed gather from the (N, J) neighbor list; the worklists are not
// ported.
//
// Bound: memory. Per pair it reads one 4-byte index and a 12-byte position
// (cached: neighbors of bin-sorted atoms are close in memory) and writes 12
// bytes. One thread per (slot s, atom i) with i fastest, so the dispT[c,s,i]
// stores of a warp are coalesced; the idx[i,s] loads are strided by J.
//
// Arithmetic is written with __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, in the operation order of models/mtp.py:106-116:
// the result is bit-identical to the plain PyTorch version, so the distance
// mask at d == cutoff agrees between the two. rintf rounds half to even, as
// jnp.round and torch.round do.

#include <cuda_runtime.h>

namespace {

__global__ void window_disp_kernel(const float* __restrict__ pos,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ cell18,
                                   float* __restrict__ out, int n, int j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * j) return;
  const int i = (int)(t % n);
  const int s = (int)(t / n);
  const int nb = idx[(long long)i * j + s];
  // cell rows c[r][k] = cell18[3r+k]; inverse rows ic[r][k] = cell18[9+3r+k]
  float c[9], ic[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    c[k] = cell18[k];
    ic[k] = cell18[9 + k];
  }
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(pos[3 * nb + k], pos[3 * i + k]);
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float fa = __fadd_rn(__fadd_rn(__fmul_rn(d[0], ic[a]), __fmul_rn(d[1], ic[3 + a])),
                         __fmul_rn(d[2], ic[6 + a]));
    f[a] = __fsub_rn(fa, rintf(fa));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[((long long)a * j + s) * n + i] =
        __fadd_rn(__fadd_rn(__fmul_rn(f[0], c[a]), __fmul_rn(f[1], c[3 + a])),
                  __fmul_rn(f[2], c[6 + a]));
  }
}

}  // namespace

extern "C" int mtp_window_disp(const void* pos, const void* idx, const void* cell18,
                               void* out, int n, int j, void* stream) {
  const long long total = (long long)n * j;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  window_disp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const int*)idx, (const float*)cell18, (float*)out, n, j);
  return (int)cudaGetLastError();
}
