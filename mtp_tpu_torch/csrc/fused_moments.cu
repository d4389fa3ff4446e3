// The per-atom MTP chain, one kernel template with five modes:
//   K4 site energies, K2 pair forces (the main path), K5 the fused grade
//   step of active learning, K6 basic moments and K7 their vjp.
//
// Replaces the TPU kernels of mtp_tpu/ops/pallas_moments.py:
//   K4 :439 `_mega_fwd_kernel` (through `site_energies_mega` :507),
//   K2 :463 `_mega_bwd_kernel` (through `_mega_bwd_vjp` :553 and
//      `pair_forces_mega` :739),
//   K5 :589 `_mega_cand_kernel` (through `candidates_mega` :674),
//   K6 :196 `_fwd_kernel` (through `_fwd`, `basic_moments_fused` :271),
//   K7 :219 `_bwd_kernel` (K6's vjp, through `_fused_bwd` :330).
// The per-pair math follows `_geometry` :110, `_cheb_vals(_ders)` :50-72,
// `_pair_radials` :75, the power tables :101 and `_pair_force_terms` :152.
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
// The modes share every stage; each runs the stages it needs:
//   K6: per-slot stage, basic moments -> m[:B] as (B, N).
//   K4: ... forward DAG, readout esp + xi.m.
//   K2: ... reverse DAG from dm = de*xi, force tail -> (3, J, N).
//   K5: K2 with de = 1, plus: the readout (site energies) and the scalar
//       basis members m[mapping] before the reverse pass; the enveloped
//       Chebyshev values cheb_r(s) kept per slot; Gmu[mu](s) =
//       sum_{k: mu_k = mu} gamma_k U_k(s) accumulated in the force tail's k
//       loop (a [MU][slot] shared row per warp: each lane owns its slots);
//       and the radial-Jacobian rows rad[s2, mu, r] = sum_s [jt(s) = s2]
//       w(s) cheb_r(s) Gmu[mu](s), S*MU*RB warp reductions per atom.
//   K7: per-slot stage, gamma (B, N) read from memory, force tail.
//
// Bound: issue rate on the FP32 pipes and shared-memory traffic. At level 16
// each pair costs ~B=130 products in the forward moments and ~4B terms in
// the force tail, each atom ~620 DAG products forward and ~1240 reverse; the
// (3, J, N) inputs and outputs are ~1 KB per atom, far below the bandwidth
// roof. K5 adds one shared read-modify-write per (slot, k) for Gmu and 32
// warp reductions per atom (level 16, one species). No tensor cores and no
// TF32 anywhere: every dot is IEEE fp32 FMA.
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

// kernel modes (template argument)
constexpr int kSite = 0;         // K4
constexpr int kForces = 1;       // K2
constexpr int kCand = 2;         // K5
constexpr int kBasicOnly = 3;    // K6
constexpr int kGammaForces = 4;  // K7

struct Params {
  const float* dispT;     // (3, J, N)
  const float* mask;      // (J, N)
  const int* itypes;      // (N,)
  const int* jtypes_t;    // (J, N)
  const float* radial;    // (S, S, MU, RB)
  const float* xi;        // (M,) readout vector (K4, K2, K5)
  const float* per_atom;  // esp (N,) for K4/K5, de (N,) or NULL for K2, gamma (B, N) for K7
  const int* tab;         // the schedule table
  const int* mapping;     // (n_scal,) moment slot of each scalar basis member (K5)
  float* out;             // K4 (N,); K2, K5, K7 (3, J, N); K6 (B, N)
  float* site;            // K5 (N,)
  float* bm;              // K5 (N, n_scal)
  float* rad;             // K5 (N, S*MU*RB), (s2, mu, r) row-major
  int n, j, S, MU, RB, R, B, M, n_waves, n_scal;
  float lo, hi, scaling;
};

// floats of shared memory per warp; the kernel carves its slice in this order
__host__ __device__ inline int per_warp_floats(int mode, int jp, int MU, int RB, int R,
                                               int M) {
  int f = jp * (5 + 2 * MU + 3 * (R + 1)) + 2 * M;
  if (mode == kCand) f += jp * (RB + MU + 1);
  return f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The pointers are separate __restrict__ parameters (not a struct) so the
// compiler may keep the read-only operands in the non-coherent cache path.
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
mega_kernel(const float* __restrict__ dispT, const float* __restrict__ mask,
            const int* __restrict__ itypes, const int* __restrict__ jtypes_t,
            const float* __restrict__ radial, const float* __restrict__ xi,
            const float* __restrict__ per_atom, const int* __restrict__ tab,
            const int* __restrict__ mapping, float* __restrict__ out,
            float* __restrict__ site, float* __restrict__ bm, float* __restrict__ rad,
            int n, int j, int S, int MU, int RB, int R, int B, int M, int n_waves,
            int n_scal, float lo, float hi, float scaling) {
  constexpr bool kDeriv = MODE == kForces || MODE == kCand || MODE == kGammaForces;
  constexpr bool kDag = MODE == kSite || MODE == kForces || MODE == kCand;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // whole warp; only __syncwarp below

  const int jp = (j + 31) & ~31;
  float* sw = smem + warp * per_warp_floats(MODE, jp, MU, RB, R, M);
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
  float* scheb = dm + M;          // K5: [RB][jp] enveloped Chebyshev values
  float* sgmu = scheb + RB * jp;  // K5: [MU][jp] Gmu
  int* sjt = reinterpret_cast<int*>(sgmu + MU * jp);  // K5: [jp] neighbor types

  const long long jn = (long long)j * n;
  const int it = itypes[i];
  const float mult_c = 2.f / (hi - lo);

  // ---- per-slot stage: geometry, radial functions, power tables
  for (int s = lane; s < jp; s += 32) {
    float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
    int jt = 0;
    if (s < j) {
      const long long q = (long long)s * n + i;
      x = dispT[q];
      y = dispT[jn + q];
      z = dispT[2 * jn + q];
      w = mask[q];
      jt = jtypes_t[q];
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
    if constexpr (MODE == kCand) {
      sjt[s] = jt;
      float v0 = env, v1 = ksi * env;
      scheb[s] = v0;
      scheb[jp + s] = v1;
      for (int r = 2; r < RB; ++r) {
        const float v2 = 2.f * ksi * v1 - v0;
        scheb[r * jp + s] = v2;
        v0 = v1;
        v1 = v2;
      }
    }
    const float* crow = radial + (long long)(it * S + jt) * MU * RB;
    for (int mu = 0; mu < MU; ++mu) {
      const float* cm = crow + mu * RB;
      float v0 = env, v1 = ksi * env;
      float f = cm[0] * v0 + cm[1] * v1;
      float g0 = 0.f, g1 = 0.f, fp = 0.f;
      if constexpr (kDeriv) {
        g0 = scaling * 2.f * dh;
        g1 = scaling * (mult_c * (dh * dh) + 2.f * ksi * dh);
        fp = cm[0] * g0 + cm[1] * g1;
      }
      for (int r = 2; r < RB; ++r) {
        const float v2 = 2.f * ksi * v1 - v0;
        f += cm[r] * v2;
        if constexpr (kDeriv) {
          const float g2 = 2.f * (mult_c * v1 + ksi * g1) - g0;
          fp += cm[r] * g2;
          g0 = g1;
          g1 = g2;
        }
        v0 = v1;
        v1 = v2;
      }
      sf[mu * jp + s] = f;
      if constexpr (kDeriv) sfp[mu * jp + s] = fp;
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

  const int* basic = tab + tab[kBasic];
  if constexpr (MODE != kGammaForces) {
    // ---- basic moments m_k = sum_s w f_mu U_k, reduced across the warp
    for (int k = 0; k < B; ++k) {
      const int mu = basic[4 * k], ax = basic[4 * k + 1];
      const int ay = basic[4 * k + 2], az = basic[4 * k + 3];
      float acc = 0.f;
      for (int s = lane; s < jp; s += 32)
        acc += (sf[mu * jp + s] * sw[s]) *
               (spx[ax * jp + s] * (spy[ay * jp + s] * spz[az * jp + s]));
      acc = warp_sum(acc);
      if (lane == 0) {
        m[k] = acc;
        if constexpr (MODE == kBasicOnly) out[(long long)k * n + i] = acc;
      }
    }
    if constexpr (MODE == kBasicOnly) return;
    for (int k = B + lane; k < M; k += 32) m[k] = 0.f;
    __syncwarp();
  }

  if constexpr (kDag) {
    // ---- forward DAG, wave by wave: one lane per target segment
    const int* fwave = tab + tab[kFwdWave];
    const int* ftgt = tab + tab[kFwdTarget];
    const int* fseg = tab + tab[kFwdSeg];
    const int* fprod = tab + tab[kFwdProd];
    for (int wv = 0; wv < n_waves; ++wv) {
      for (int t = fwave[wv] + lane; t < fwave[wv + 1]; t += 32) {
        float acc = 0.f;
        for (int q = fseg[t]; q < fseg[t + 1]; ++q) {
          const int* e = fprod + 3 * q;
          acc += m[e[0]] * m[e[1]] * (float)e[2];
        }
        m[ftgt[t]] += acc;
      }
      __syncwarp();
    }
  }

  if constexpr (MODE == kSite || MODE == kCand) {
    // ---- readout: site energy = esp + xi . m
    float e = 0.f;
    for (int k = lane; k < M; k += 32) e += xi[k] * m[k];
    e = warp_sum(e);
    float* se = MODE == kSite ? out : site;
    if (lane == 0) se[i] = e + per_atom[i];
    if constexpr (MODE == kSite) return;
    // ---- scalar basis members m[mapping] (the candidate vector's tail)
    for (int q = lane; q < n_scal; q += 32)
      bm[(long long)i * n_scal + q] = m[mapping[q]];
  }

  if constexpr (MODE == kForces || MODE == kCand) {
    // ---- reverse DAG from dm = xi * de (K5: de = 1): one lane per node
    float de = 1.f;
    if constexpr (MODE == kForces) de = per_atom ? per_atom[i] : 1.f;
    for (int k = lane; k < M; k += 32) dm[k] = xi[k] * de;
    __syncwarp();
    const int* rwave = tab + tab[kRevWave];
    const int* rnode = tab + tab[kRevNode];
    const int* rseg = tab + tab[kRevSeg];
    const int* rent = tab + tab[kRevEnt];
    for (int wv = n_waves - 1; wv >= 0; --wv) {
      for (int t = rwave[wv] + lane; t < rwave[wv + 1]; t += 32) {
        float acc = 0.f;
        for (int q = rseg[t]; q < rseg[t + 1]; ++q) {
          const int* e = rent + 3 * q;
          acc += dm[e[0]] * m[e[1]] * (float)e[2];
        }
        dm[rnode[t]] += acc;
      }
      __syncwarp();
    }
  }

  if constexpr (MODE == kGammaForces) {
    // ---- gamma = dE/d(basic moments) from memory, (B, N)
    for (int k = lane; k < B; k += 32) dm[k] = per_atom[(long long)k * n + i];
    __syncwarp();
  }

  // ---- pair forces from gamma = dm[:B] (`_pair_force_terms`):
  // T_a = u_a sum_k g_k W1_k U_k + sum_k g_k W2_k alpha_a u^(alpha - e_a),
  // W2 = f/d, W1 = f' - rank f/d
  for (int s = lane; s < j; s += 32) {
    if constexpr (MODE == kCand)
      for (int mu = 0; mu < MU; ++mu) sgmu[mu * jp + s] = 0.f;
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
      const float U = px * (py * pz);
      P += (g * W1) * U;
      if constexpr (MODE == kCand) sgmu[mu * jp + s] += g * U;
      if (rank) {
        const float gw2 = g * W2;
        if (ax > 0) Dx += gw2 * ((float)ax * (spx[(ax - 1) * jp + s] * (py * pz)));
        if (ay > 0) Dy += gw2 * ((float)ay * (px * (spy[(ay - 1) * jp + s] * pz)));
        if (az > 0) Dz += gw2 * ((float)az * (px * (py * spz[(az - 1) * jp + s])));
      }
    }
    const float w = sw[s];
    const long long q = (long long)s * n + i;
    out[q] = (P * sux[s] + Dx) * w;
    out[jn + q] = (P * suy[s] + Dy) * w;
    out[2 * jn + q] = (P * suz[s] + Dz) * w;
  }

  if constexpr (MODE == kCand) {
    // ---- radial-Jacobian rows, (s2, mu, r) order; real slots s < j only
    __syncwarp();
    const int nrad = S * MU * RB;
    for (int q = 0; q < nrad; ++q) {
      const int s2 = q / (MU * RB), mu = (q / RB) % MU, r = q % RB;
      float acc = 0.f;
      for (int s = lane; s < j; s += 32)
        if (sjt[s] == s2) acc += (sw[s] * scheb[r * jp + s]) * sgmu[mu * jp + s];
      acc = warp_sum(acc);
      if (lane == 0) rad[(long long)i * nrad + q] = acc;
    }
  }
}

template <int MODE>
int launch(const Params& p, void* stream) {
  if (p.n == 0) return 0;
  const int jp = (p.j + 31) & ~31;
  const size_t smem =
      kWarps * (size_t)per_warp_floats(MODE, jp, p.MU, p.RB, p.R, p.M) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((p.n + kWarps - 1) / kWarps);
  mega_kernel<MODE><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      p.dispT, p.mask, p.itypes, p.jtypes_t, p.radial, p.xi, p.per_atom, p.tab, p.mapping,
      p.out, p.site, p.bm, p.rad, p.n, p.j, p.S, p.MU, p.RB, p.R, p.B, p.M, p.n_waves,
      p.n_scal, p.lo, p.hi, p.scaling);
  return (int)cudaGetLastError();
}

Params params(const void* dispT, const void* mask, const void* itypes, const void* jtypes_t,
              const void* radial, const void* xi, const void* per_atom, const void* tab,
              void* out, int n, int j, int S, int MU, int RB, int R, int B, int M,
              int n_waves, float lo, float hi, float scaling) {
  Params p = {};
  p.dispT = (const float*)dispT;
  p.mask = (const float*)mask;
  p.itypes = (const int*)itypes;
  p.jtypes_t = (const int*)jtypes_t;
  p.radial = (const float*)radial;
  p.xi = (const float*)xi;
  p.per_atom = (const float*)per_atom;
  p.tab = (const int*)tab;
  p.out = (float*)out;
  p.n = n;
  p.j = j;
  p.S = S;
  p.MU = MU;
  p.RB = RB;
  p.R = R;
  p.B = B;
  p.M = M;
  p.n_waves = n_waves;
  p.lo = lo;
  p.hi = hi;
  p.scaling = scaling;
  return p;
}

}  // namespace

// The K4, K2, K6 and K7 entry points share one argument list; per_atom is
// esp (K4), de or NULL for 1 (K2), unused (K6), gamma (B, N) (K7).
#define MTP_ARGS                                                                    \
  const void *dispT, const void *mask, const void *itypes, const void *jtypes_t,   \
      const void *radial, const void *xi, const void *per_atom, const void *tab,   \
      void *out, int n, int j, int S, int MU, int RB, int R, int B, int M,         \
      int n_waves, float lo, float hi, float scaling, void *stream
#define MTP_PARAMS                                                                  \
  params(dispT, mask, itypes, jtypes_t, radial, xi, per_atom, tab, out, n, j, S, MU, \
         RB, R, B, M, n_waves, lo, hi, scaling)

// K4: site energies (N,) = esp + xi . m
extern "C" int mtp_site_energies_mega(MTP_ARGS) { return launch<kSite>(MTP_PARAMS, stream); }

// K2: pair forces (3, J, N) = de_i * d(site_e_i)/d(dispT); de == NULL means 1
extern "C" int mtp_pair_forces_mega(MTP_ARGS) { return launch<kForces>(MTP_PARAMS, stream); }

// K6: basic moments (B, N)
extern "C" int mtp_basic_moments_fused(MTP_ARGS) {
  return launch<kBasicOnly>(MTP_PARAMS, stream);
}

// K7: pair forces (3, J, N) = gamma . d(basic moments)/d(dispT), gamma (B, N)
extern "C" int mtp_basic_moments_vjp(MTP_ARGS) {
  return launch<kGammaForces>(MTP_PARAMS, stream);
}

// K5: site energies (N,), basis members (N, n_scal), radial rows
// (N, S*MU*RB) and pair forces (3, J, N) of one grade step
extern "C" int mtp_candidates_mega(const void* dispT, const void* mask, const void* itypes,
                                   const void* jtypes_t, const void* radial, const void* xi,
                                   const void* esp, const void* tab, const void* mapping,
                                   void* site, void* bm, void* rad, void* pair, int n, int j,
                                   int S, int MU, int RB, int R, int B, int M, int n_waves,
                                   int n_scal, float lo, float hi, float scaling,
                                   void* stream) {
  Params p = params(dispT, mask, itypes, jtypes_t, radial, xi, esp, tab, pair, n, j, S, MU,
                    RB, R, B, M, n_waves, lo, hi, scaling);
  p.mapping = (const int*)mapping;
  p.site = (float*)site;
  p.bm = (float*)bm;
  p.rad = (float*)rad;
  p.n_scal = n_scal;
  return launch<kCand>(p, stream);
}
