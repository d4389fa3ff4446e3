// K4 site energies and K2 pair forces: the whole per-atom MTP chain in one
// kernel each (per-pair stage, basic moments, product DAG, readout, and for
// K2 the reverse DAG and the per-pair force tail).
//
// Replaces the TPU kernels mtp_tpu/ops/pallas_moments.py:439
// `_mega_fwd_kernel` (K4, through `site_energies_mega` :507) and :463
// `_mega_bwd_kernel` (K2, through `_mega_bwd_vjp` :553 and
// `pair_forces_mega` :739). The per-pair math follows `_geometry` :110,
// `_cheb_vals(_ders)` :50-72, `_pair_radials` :75, the power tables :101 and
// `_pair_force_terms` :152.
//
// Design. One warp per atom (kWarps atoms per block); lane l handles the
// neighbor slots s = l, l+32, ... The per-slot values (mask, unit vector,
// 1/d, f_mu, f'_mu, unit-vector power tables) go to the warp's slice of
// shared memory as [item][slot] rows, so every later loop over the basic
// index k (uniform across the warp) reads consecutive slots: no bank
// conflicts. Basic moments are reduced across slots with warp shuffles.
// The TPU ran the product DAG as one-hot MXU matmuls (`_dag_tile` :400);
// here it runs as the sparse product list m[a3] += mult*m[a0]*m[a1] on a
// per-atom moment vector in shared memory (331 floats at level 16), wave by
// wave. Duplicate a3 targets accumulate WITHOUT atomics: the host groups a
// wave's products by target (one lane per target walks its segment), and
// groups the reverse pass by input node (dm[n] += mult*dm[a3]*m[other] over
// the node's segment), so every sum runs in a fixed order and the kernel is
// deterministic. The schedule lives in a device int32 table read at run
// time, so one binary serves every MTP level.
//
// Bound: issue rate on the FP32 pipes and shared-memory traffic. At level 16
// each pair costs ~B=130 products in the forward moments and ~4B terms in
// the force tail, each atom ~620 DAG products forward and ~1240 reverse; the
// (3, J, N) inputs and outputs are ~1 KB per atom, far below the bandwidth
// roof. No tensor cores and no TF32 anywhere: every dot is IEEE fp32 FMA.
//
// Masked slots get d2 = 1 before sqrtf: pads and self pairs have disp = 0,
// and 0*inf would poison the sums with NaN. Their weight w is 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // atoms per block, one warp each

// int32 table header: offsets of each section within the table
enum {
  kBasic = 0,     // (B, 4): mu, ax, ay, az
  kFwdWave = 1,   // (n_waves + 1): target-list range of each wave
  kFwdTarget = 2, // (T): target node of each segment
  kFwdSeg = 3,    // (T + 1): product range of each target
  kFwdProd = 4,   // (P, 3): a0, a1, mult
  kRevWave = 5,   // (n_waves + 1): node-list range of each wave
  kRevNode = 6,   // (Q): node receiving each reverse segment
  kRevSeg = 7,    // (Q + 1): entry range of each node
  kRevEnt = 8,    // (E, 3): a3, other input, mult
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool BWD>
__global__ void __launch_bounds__(kWarps * 32)
mega_kernel(const float* __restrict__ dispT, const float* __restrict__ mask,
            const int* __restrict__ itypes, const int* __restrict__ jtypes_t,
            const float* __restrict__ radial, const float* __restrict__ xi,
            const float* __restrict__ esp_or_de, const int* __restrict__ tab,
            float* __restrict__ out, int n, int j, int S, int MU, int RB, int R, int B,
            int M, int n_waves, float lo, float hi, float scaling) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // whole warp; only __syncwarp below

  const int jp = (j + 31) & ~31;
  const int per_warp = jp * (5 + 2 * MU + 3 * (R + 1)) + 2 * M;
  float* sw = smem + warp * per_warp;
  float* sux = sw + jp;
  float* suy = sux + jp;
  float* suz = suy + jp;
  float* sinv = suz + jp;
  float* sf = sinv + jp;        // [MU][jp]
  float* sfp = sf + MU * jp;    // [MU][jp]
  float* spx = sfp + MU * jp;   // [R+1][jp]
  float* spy = spx + (R + 1) * jp;
  float* spz = spy + (R + 1) * jp;
  float* m = spz + (R + 1) * jp;  // [M]
  float* dm = m + M;              // [M]

  const long long jn = (long long)j * n;
  const int it = itypes[i];
  const float mult_c = 2.f / (hi - lo);

  // ---- per-slot stage: geometry, radial functions, power tables
  for (int s = lane; s < jp; s += 32) {
    float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
    int jt = 0;
    if (s < j) {
      const long long p = (long long)s * n + i;
      x = dispT[p];
      y = dispT[jn + p];
      z = dispT[2 * jn + p];
      w = mask[p];
      jt = jtypes_t[p];
    }
    float d2 = x * x + y * y + z * z;
    if (!(w > 0.f)) d2 = 1.f;
    const float d = sqrtf(d2);
    const float inv_d = 1.f / d;
    const float ux = x * inv_d, uy = y * inv_d, uz = z * inv_d;
    sw[s] = w;
    sux[s] = ux;
    suy[s] = uy;
    suz[s] = uz;
    sinv[s] = inv_d;

    const float ksi = (2.f * d - (lo + hi)) / (hi - lo);
    const float dh = d - hi;
    const float env = scaling * (dh * dh);
    const float* crow = radial + (long long)(it * S + jt) * MU * RB;
    for (int mu = 0; mu < MU; ++mu) {
      const float* cm = crow + mu * RB;
      float v0 = env, v1 = ksi * env;
      float f = cm[0] * v0 + cm[1] * v1;
      float g0 = 0.f, g1 = 0.f, fp = 0.f;
      if (BWD) {
        g0 = scaling * 2.f * dh;
        g1 = scaling * (mult_c * (dh * dh) + 2.f * ksi * dh);
        fp = cm[0] * g0 + cm[1] * g1;
      }
      for (int r = 2; r < RB; ++r) {
        const float v2 = 2.f * ksi * v1 - v0;
        f += cm[r] * v2;
        if (BWD) {
          const float g2 = 2.f * (mult_c * v1 + ksi * g1) - g0;
          fp += cm[r] * g2;
          g0 = g1;
          g1 = g2;
        }
        v0 = v1;
        v1 = v2;
      }
      sf[mu * jp + s] = f;
      if (BWD) sfp[mu * jp + s] = fp;
    }
    float px = 1.f, py = 1.f, pz = 1.f;
    for (int r = 0; r <= R; ++r) {
      spx[r * jp + s] = px;
      spy[r * jp + s] = py;
      spz[r * jp + s] = pz;
      px *= ux;
      py *= uy;
      pz *= uz;
    }
  }
  __syncwarp();

  // ---- basic moments m_k = sum_s w f_mu U_k, reduced across the warp
  const int* basic = tab + tab[kBasic];
  for (int k = 0; k < B; ++k) {
    const int mu = basic[4 * k], ax = basic[4 * k + 1];
    const int ay = basic[4 * k + 2], az = basic[4 * k + 3];
    float acc = 0.f;
    for (int s = lane; s < jp; s += 32)
      acc += (sf[mu * jp + s] * sw[s]) *
             (spx[ax * jp + s] * (spy[ay * jp + s] * spz[az * jp + s]));
    acc = warp_sum(acc);
    if (lane == 0) m[k] = acc;
  }
  for (int k = B + lane; k < M; k += 32) m[k] = 0.f;
  __syncwarp();

  // ---- forward DAG, wave by wave: one lane per target segment
  const int* fwave = tab + tab[kFwdWave];
  const int* ftgt = tab + tab[kFwdTarget];
  const int* fseg = tab + tab[kFwdSeg];
  const int* fprod = tab + tab[kFwdProd];
  for (int wv = 0; wv < n_waves; ++wv) {
    for (int t = fwave[wv] + lane; t < fwave[wv + 1]; t += 32) {
      float acc = 0.f;
      for (int p = fseg[t]; p < fseg[t + 1]; ++p) {
        const int* q = fprod + 3 * p;
        acc += m[q[0]] * m[q[1]] * (float)q[2];
      }
      m[ftgt[t]] += acc;
    }
    __syncwarp();
  }

  if (!BWD) {
    // ---- readout: site energy = esp + xi . m
    float e = 0.f;
    for (int k = lane; k < M; k += 32) e += xi[k] * m[k];
    e = warp_sum(e);
    if (lane == 0) out[i] = e + esp_or_de[i];
    return;
  }

  // ---- reverse DAG from dm = xi * de: one lane per receiving node
  const float de = esp_or_de ? esp_or_de[i] : 1.f;
  for (int k = lane; k < M; k += 32) dm[k] = xi[k] * de;
  __syncwarp();
  const int* rwave = tab + tab[kRevWave];
  const int* rnode = tab + tab[kRevNode];
  const int* rseg = tab + tab[kRevSeg];
  const int* rent = tab + tab[kRevEnt];
  for (int wv = n_waves - 1; wv >= 0; --wv) {
    for (int t = rwave[wv] + lane; t < rwave[wv + 1]; t += 32) {
      float acc = 0.f;
      for (int p = rseg[t]; p < rseg[t + 1]; ++p) {
        const int* q = rent + 3 * p;
        acc += dm[q[0]] * m[q[1]] * (float)q[2];
      }
      dm[rnode[t]] += acc;
    }
    __syncwarp();
  }

  // ---- pair forces from gamma = dm[:B] (`_pair_force_terms`):
  // T_a = u_a sum_k g_k W1_k U_k + sum_k g_k W2_k alpha_a u^(alpha - e_a),
  // W2 = f/d, W1 = f' - rank f/d
  for (int s = lane; s < j; s += 32) {
    const float inv_d = sinv[s];
    float P = 0.f, Dx = 0.f, Dy = 0.f, Dz = 0.f;
    for (int k = 0; k < B; ++k) {
      const int mu = basic[4 * k], ax = basic[4 * k + 1];
      const int ay = basic[4 * k + 2], az = basic[4 * k + 3];
      const int rank = ax + ay + az;
      const float g = dm[k];
      const float W2 = sf[mu * jp + s] * inv_d;
      const float fp = sfp[mu * jp + s];
      const float W1 = rank ? fp - (float)rank * W2 : fp;
      const float px = spx[ax * jp + s];
      const float py = spy[ay * jp + s];
      const float pz = spz[az * jp + s];
      P += (g * W1) * (px * (py * pz));
      if (rank) {
        const float gw2 = g * W2;
        if (ax > 0) Dx += gw2 * ((float)ax * (spx[(ax - 1) * jp + s] * (py * pz)));
        if (ay > 0) Dy += gw2 * ((float)ay * (px * (spy[(ay - 1) * jp + s] * pz)));
        if (az > 0) Dz += gw2 * ((float)az * (px * (py * spz[(az - 1) * jp + s])));
      }
    }
    const float w = sw[s];
    const long long p = (long long)s * n + i;
    out[p] = (P * sux[s] + Dx) * w;
    out[jn + p] = (P * suy[s] + Dy) * w;
    out[2 * jn + p] = (P * suz[s] + Dz) * w;
  }
}

template <bool BWD>
int launch(const void* dispT, const void* mask, const void* itypes, const void* jtypes_t,
           const void* radial, const void* xi, const void* esp_or_de, const void* tab,
           void* out, int n, int j, int S, int MU, int RB, int R, int B, int M,
           int n_waves, float lo, float hi, float scaling, void* stream) {
  if (n == 0) return 0;
  const int jp = (j + 31) & ~31;
  const size_t per_warp = (size_t)jp * (5 + 2 * MU + 3 * (R + 1)) + 2 * (size_t)M;
  const size_t smem = kWarps * per_warp * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_kernel<BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  mega_kernel<BWD><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)dispT, (const float*)mask, (const int*)itypes, (const int*)jtypes_t,
      (const float*)radial, (const float*)xi, (const float*)esp_or_de, (const int*)tab,
      (float*)out, n, j, S, MU, RB, R, B, M, n_waves, lo, hi, scaling);
  return (int)cudaGetLastError();
}

}  // namespace

// site energies (N,) = esp + xi . m
extern "C" int mtp_site_energies_mega(const void* dispT, const void* mask, const void* itypes,
                                      const void* jtypes_t, const void* radial,
                                      const void* xi, const void* esp, const void* tab,
                                      void* out, int n, int j, int S, int MU, int RB, int R,
                                      int B, int M, int n_waves, float lo, float hi,
                                      float scaling, void* stream) {
  return launch<false>(dispT, mask, itypes, jtypes_t, radial, xi, esp, tab, out, n, j, S,
                       MU, RB, R, B, M, n_waves, lo, hi, scaling, stream);
}

// pair forces (3, J, N) = de_i * d(site_e_i)/d(dispT); de == NULL means 1
extern "C" int mtp_pair_forces_mega(const void* dispT, const void* mask, const void* itypes,
                                    const void* jtypes_t, const void* radial,
                                    const void* xi, const void* de, const void* tab,
                                    void* out, int n, int j, int S, int MU, int RB, int R,
                                    int B, int M, int n_waves, float lo, float hi,
                                    float scaling, void* stream) {
  return launch<true>(dispT, mask, itypes, jtypes_t, radial, xi, de, tab, out, n, j, S,
                      MU, RB, R, B, M, n_waves, lo, hi, scaling, stream);
}
