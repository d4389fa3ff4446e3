// The per-atom MTP chain on Hopper: three stage kernels behind five entry
// points, K4 site energies, K2 pair forces (the main path), K5 the fused
// grade step of active learning, K6 basic moments and K7 their vjp.
//
// Replaces the TPU kernels of mtp_tpu/ops/pallas_moments.py:
//   K4 :439 `_mega_fwd_kernel` (through `site_energies_mega` :507),
//   K2 :463 `_mega_bwd_kernel` (through `_mega_bwd_vjp` :553 and
//      `pair_forces_mega` :739),
//   K5 :589 `_mega_cand_kernel` (through `candidates_mega` :674),
//   K6 :196 `_fwd_kernel` (through `_fwd`, `basic_moments_fused` :271),
//   K7 :219 `_bwd_kernel` (K6's vjp, through `_fused_bwd` :330).
// The per-pair math follows `_geometry` :110, `_cheb_vals(_ders)` :50-72,
// `_pair_radials` :75, `_u_tables` :122 and `_pair_force_terms` :152.
//
// Stages (each entry point runs the ones it needs, in this order):
//   basic   float_kernel<Sh, kStageBasic> for a specialised shape (levels 8
//           and 16), pair_kernel<General, kStageBasic> for every other
//           schedule: per-pair stage and basic moments m_k = sum_s w f_mu
//           U_k -> (B, N). K6 alone; K4, K2 into a (B, N) scratch buffer;
//           K5 into a double one (cand_kernel below).
//   dag     dag_kernel<MODE>: the product DAG forward; K4 the readout
//           esp + xi.m; K2 the reverse DAG from dm = de*xi, gamma = dm[:B]
//           written over the scratch; K5 both, with de = 1, plus the scalar
//           basis members m[mapping].
//   tail    float_kernel<Sh, kStageTail> (specialised) or
//           pair_kernel<General, kStageTail>: per-pair stage with
//           derivatives and the force tail from gamma (B, N) -> (3, J, N).
//           K7 alone (gamma from the caller), K2 after the dag.
// The (B, N) intermediates (16.6 MB at 32k atoms, level 16) stay in the
// 50 MB L2 between stages: the per-atom DAG state (m and dm, 2.6 KB at
// level 16) and the per-thread pair state want different thread layouts,
// and one kernel holding both would be bound by the larger footprint.
//
// Bound on an H100 SXM: fp32 operations outside the tensor cores (67
// TFLOP/s). K2 at level 16 needs ~1,930 fp32 operations per live pair (mask
// > 0) and ~5,300 per atom in the DAG, each quantity counted once
// (chip_smoke.py `kernel_work`); at 32k atoms and ~34 live pairs per atom
// that is ~2.3 GFLOP, 0.034 ms, against 0.020 ms for its 66 MB of (3, J, N)
// input and output at 3.35 TB/s. The kernels do more: the tail stage
// rebuilds the basic stage's geometry, radial functions and monomials
// rather than pass them through memory. No tensor cores and no TF32 anywhere:
// every product and sum is an IEEE fp32 operation, except on K5's path.
//
// K5, the grade step, computes in double: the grades multiply the candidate
// vector by the inverse active set, whose conditioning turns fp32 rounding
// of the per-pair sums into grade errors near 1e-2 of the largest grade.
// The float inputs (displacements, coefficients, readout) are widened
// before their first operation; site energies and pair forces are written
// as floats, the basis members and radial rows as doubles. For a
// specialised shape (levels 8 and 16) with RB <= kCandRB it runs
// cand_kernel<Sh, kStageBasic>, dag_kernel<kCand, staged, double> and
// cand_kernel<Sh, kStageTailCand>, which also gathers Gmu[mu](s) =
// sum_{k: mu_k = mu} gamma_k U_k(s) and the radial-Jacobian rows
// rad[s2, mu, r] = sum_s [jt(s) = s2] w(s) cheb_r(s) Gmu[mu](s); every other
// schedule runs pair_kernel<General, STAGE, double> around the same DAG. Its
// bound on an H100 SXM is its float64 operations at 34 TFLOP/s: ~2.66 GFLOP
// at 32k atoms and level 16, 0.0782 ms (chip_smoke.py `kernel_work`,
// `bound`; its 94 MB of I/O would take 0.028 ms). What cand_kernel and the
// DAG do about the costs of K5 on the General stages (3.54 ms at 32k):
// - Registers. 130 double sums would take 260 registers, so the General
//   stages keep every per-thread value in shared-memory columns (4
//   resident warps per SM for the tail). A cand_kernel block is kSubs warps
//   over the same 32 atoms (atom = lane), warp w holding the sums or gamma
//   values of the terms of monomial group w in registers; each warp
//   rebuilds the pair's geometry (1/d by rsqrt, no double division) and
//   radial functions. Resident warps per SM at level 16: 8 (basic, 2
//   groups), 12 (tail, 4 groups).
// - Terms. As in the float stages, the terms and derivative monomials are
//   unrolled at compile time from unit-vector powers in registers: no table
//   is read in the inner loop (the General stages read (mu, ax, ay, az) and
//   4-6 shared doubles per term).
// - Radial rows. The Chebyshev values of a pair are computed once per warp
//   and kept in registers for f_mu, f'_mu and the rows. The tail's warps
//   walk the live slots in lockstep: each writes its group's partial T and
//   Gmu of the pair to shared memory, and after one barrier warps 0-2 sum
//   T's components in group order and write them, and warp w adds w Gmu[mu]
//   cheb_r for mu = w (mod kSubs) to the rows in shared memory: RB
//   read-modify-writes per pair, not S * MU * RB.
// - The DAG. m and dm of 32 atoms in double would take 169 KB, so a block
//   keeps 16 (W = 16, 2 blocks per SM); each warp runs two groups of 16
//   lanes, each group on its own target of the wave, so every lane carries
//   an atom (the General DAG left lanes 16-31 idle).
// - Whole-line output. The radial rows leave shared memory, and the basis
//   members a [W][n_scal | 1] staging in dm, as contiguous runs of rad (N,
//   S*MU*RB) and bm (N, n_scal): a warp's stores cover whole lines.
// Every sum of K5 keeps a fixed order (slots ascending; T and Gmu over the
// groups in group order), no atomics: two launches agree bit for bit.
//
// How the design meets the costs of the one-warp-per-atom kernel it
// replaces (130 serial warp reductions per atom, int table loads and
// shared loads per term, 32-sector strided I/O, 20 resident warps per SM,
// full work on padded slots):
// - The basic stages take one thread per atom, atoms along a warp's
//   lanes: the basic moments of the thread's atom are summed in registers
//   over its own slots, with no cross-thread reduction at all. The float
//   tail for a specialised shape shares each block's live pairs out over
//   its 12 warps (float_kernel below); the General tail is one thread per
//   atom. Every (B, N) access of a warp is one 128-byte line.
// - Specialised shapes (MTP_SHAPES: the basic set is every monomial of rank
//   <= R_mu for each radial function mu) are template parameters. Each
//   distinct monomial u^(ax, ay, az), and each derivative monomial, is built
//   once per pair from the unit-vector components in registers; the (mu,
//   monomial) terms are unrolled at compile time, so the inner loops read no
//   table. One host table (the shell map) puts the canonical term c =
//   off(mu) + t at its schedule row k. Every other schedule runs the
//   General instantiation: the same stages with the term table (B, 4)
//   staged in shared memory and per-thread values in thread-private shared
//   columns.
// - The force tail is regrouped by monomial: G_t = sum_mu g f_mu, then T =
//   w (u (P - Q/d) + D/d) with P = sum_t G'_t U_t (G'_t = sum_mu g f'_mu),
//   Q = sum_t rank_t G_t U_t and D_a = sum_t G_t alpha_a U_(t - e_a).
// - Padded and out-of-cutoff slots cost one coalesced mask load: a 64-bit
//   live mask per chunk of 64 slots, and a basic-stage thread walks only its
//   live slots (the next slot's operands are loaded before the current one
//   is contracted); the float tail lists only the live pairs. The tails
//   write zeros at the dead slots.
// - The DAG runs with one atom per lane and the warps of a block splitting
//   each wave's targets (the host orders them longest segment first), m and
//   dm as [node][atom] rows in shared memory: every table entry is read at
//   one warp-uniform address (two, one per group of 16 lanes, where a block
//   holds 16 atoms), from a copy of the DAG sections in shared memory when
//   it fits beside m and dm (otherwise, from level 18 up, through `__ldg`),
//   every m and dm access is conflict-free, and the (B, N) rows load and
//   store as whole lines.
// - Occupancy: the specialised basic stage takes 254 registers, 8 warps per
//   SM, which holds every warp of a 32k-atom launch (1,000, ~7.6 per SM) in
//   one wave; each thread has ~130 independent accumulations per slot to
//   issue while its next slot's loads are in flight. The specialised tail
//   keeps gamma in shared memory: 80 registers, 24 warps per SM. The DAG
//   keeps m and dm of 32 atoms (85 KB at level 16) and its table (19 KB) per
//   16-warp block: 2 blocks, 32 warps per SM (chip_smoke.py prints every
//   stage's from the occupancy calculator).
// - Determinism: every sum runs in a fixed order (slots ascending within a
//   thread; a pair's terms in monomial order; a DAG target's products in
//   table order), no atomics.
//
// Masked slots are never contracted (their d2 would need the d2 = 1 guard
// of the plain path: pads have disp = 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

// int32 table header: offsets of each section within the table
enum {
  kBasic = 0,      // (B, 4): mu, ax, ay, az
  kShellMap = 1,   // (B,): schedule row k of canonical term c (specialised shapes)
  kFwdWave = 2,    // (n_waves + 1): target-list range of each wave
  kFwdTarget = 3,  // (T): target node of each segment
  kFwdSeg = 4,     // (T + 1): product range of each target
  kFwdProd = 5,    // (P, 2): a0 | a1 << 16, mult (8-byte aligned)
  kRevWave = 6,    // (n_waves + 1): node-list range of each wave
  kRevNode = 7,    // (Q): node receiving each reverse segment
  kRevSeg = 8,     // (Q + 1): entry range of each node
  kRevEnt = 9,     // (E, 2): a3 | other << 16, mult (8-byte aligned)
};

// Specialised shapes: id, then the top rank R_mu of each radial function's
// basic moments. mtp_tpu_torch/ops/fused_moments.py SHAPES lists the same.
#define MTP_SHAPES(X) \
  X(1, 2, 0)          \
  X(2, 6, 4, 2, 0)

// dag_kernel modes
constexpr int kSite = 0;    // K4
constexpr int kForces = 1;  // K2
constexpr int kCand = 2;    // K5

// pair_kernel stages
constexpr int kStageBasic = 0;     // basic moments (B, N)
constexpr int kStageTail = 1;      // force tail from gamma (B, N)
constexpr int kStageTailCand = 2;  // force tail, Gmu and the radial rows (K5)

constexpr int kPairThreads = 64;  // launch bound of the General pair stages (run with 32)
constexpr int kDagThreads = 512;  // 16 warps, one atom per lane
constexpr int kDagWarps = kDagThreads / 32;

// A DAG block of W atoms runs 32 / W groups of W lanes in each warp: the
// workers, each with its own targets.
__host__ __device__ inline int dag_workers(int W) { return kDagWarps * (32 / W); }
// row stride of K5's basis members staged in dm, [W][stride]: odd, so that
// both the gather from m and the whole-line store read without conflicts
__host__ __device__ inline int bm_stride(int n_scal) { return n_scal | 1; }
// values of a DAG block's m [M][W] and dm [max(M, workers + extra)][W]
// (K4's and K5's readout keeps each worker's partial sums [workers][W] in
// dm's rows, K5's basis members the `extra` rows after them), rounded up to
// even so that the staged table behind them is 8-byte aligned
__host__ __device__ inline long long dag_floats(int M, int W, int extra) {
  const int rows = dag_workers(W) + extra;
  const long long f = (long long)(M + (M > rows ? M : rows)) * W;
  return f + (f & 1);
}

// ---- monomials u^(ax, ay, az) of rank <= r: rank-major, then ax and ay
// descending (mtp_tpu_torch/ops/fused_moments.py `monomials`)
__host__ __device__ constexpr int n_mono(int r) {
  return r < 0 ? 0 : (r + 1) * (r + 2) * (r + 3) / 6;
}
__host__ __device__ constexpr int mono_rank(int t) {
  int r = 0;
  while (n_mono(r) <= t) ++r;
  return r;
}
__host__ __device__ constexpr int mono_ax(int t) {
  const int r = mono_rank(t);
  int q = t - n_mono(r - 1), ax = r;
  while (q > r - ax) {
    q -= r - ax + 1;
    --ax;
  }
  return ax;
}
__host__ __device__ constexpr int mono_ay(int t) {
  const int r = mono_rank(t);
  int q = t - n_mono(r - 1), ax = r;
  while (q > r - ax) {
    q -= r - ax + 1;
    --ax;
  }
  return r - ax - q;
}

// index t of monomial u^(ax, ay, az) in that order
__host__ __device__ constexpr int mono_index(int ax, int ay, int az) {
  const int r = ax + ay + az;
  int q = 0;
  for (int b = r; b > ax; --b) q += r - b + 1;
  return n_mono(r - 1) + q + (r - ax - ay);
}

// A specialised shape: radial function mu carries every monomial of rank
// <= R_mu; canonical term c = off(mu) + t.
template <int... Rs>
__host__ __device__ constexpr int shell_rank(int mu) {
  const int a[] = {Rs...};
  return a[mu];
}
template <int... Rs>
__host__ __device__ constexpr int shell_off(int mu) {
  const int a[] = {Rs...};
  int o = 0;
  for (int q = 0; q < mu; ++q) o += n_mono(a[q]);
  return o;
}
// the same with each shell's terms padded to a multiple of 4 (the float
// tail's gamma rows, read 4 at a time)
template <int... Rs>
__host__ __device__ constexpr int shell_poff(int mu) {
  const int a[] = {Rs...};
  int o = 0;
  for (int q = 0; q < mu; ++q) o += (n_mono(a[q]) + 3) & ~3;
  return o;
}
template <int... Rs>
__host__ __device__ constexpr int shell_rmax() {
  const int a[] = {Rs...};
  int m = 0;
  for (int q = 0; q < (int)sizeof...(Rs); ++q) m = a[q] > m ? a[q] : m;
  return m;
}
template <int... Rs>
struct Shells {
  static constexpr bool kSpecial = true;
  static constexpr int MU = sizeof...(Rs);
  __host__ __device__ static constexpr int r(int mu) { return shell_rank<Rs...>(mu); }
  __host__ __device__ static constexpr int off(int mu) { return shell_off<Rs...>(mu); }
  __host__ __device__ static constexpr int poff(int mu) { return shell_poff<Rs...>(mu); }
  static constexpr int B = shell_off<Rs...>(sizeof...(Rs));
  static constexpr int BP = shell_poff<Rs...>(sizeof...(Rs));
  static constexpr int RMAX = shell_rmax<Rs...>();
  static constexpr int NT = n_mono(RMAX);
};

// Every other schedule: sizes and terms at run time.
struct General {
  static constexpr bool kSpecial = false;
};

template <class F, int... I>
__device__ __forceinline__ void static_for_(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
// f(std::integral_constant<int, i>) for i = 0 .. N-1, unrolled at compile time
template <int N, class F>
__device__ __forceinline__ void static_for(F f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// ---- one pair's operands, and the live slots of one atom

struct Pair {
  float x, y, z, w;
  int jt;
};

__device__ __forceinline__ Pair load_pair(const float* __restrict__ dispT,
                                          const float* __restrict__ mask,
                                          const int* __restrict__ jtypes_t, long long jn,
                                          long long o) {
  Pair p;
  p.x = __ldg(dispT + o);
  p.y = __ldg(dispT + jn + o);
  p.z = __ldg(dispT + 2 * jn + o);
  p.w = __ldg(mask + o);
  p.jt = __ldg(jtypes_t + o);
  return p;
}

// The live slots of atom i, ascending: next() returns o = s * n + i of the
// next slot with mask > 0, or -1 past the last, after calling dead(o) for
// every slot with mask <= 0 that it passed. The mask is read 64 slots at a
// time into a word of bits.
template <class Dead>
struct LiveSlots {
  const float* __restrict__ mask;
  int n, j, i;
  Dead dead;
  int base = -64;
  uint64_t bits = 0;
  __device__ __forceinline__ long long next() {
    while (bits == 0) {
      base += 64;
      if (base >= j) return -1;
      const int cnt = min(64, j - base);
#pragma unroll 16
      for (int q = 0; q < cnt; ++q) {
        const long long o = (long long)(base + q) * n + i;
        if (__ldg(mask + o) > 0.f)
          bits |= 1ull << q;
        else
          dead(o);
      }
    }
    const int q = __ffsll((long long)bits) - 1;
    bits &= bits - 1;
    return (long long)(base + q) * n + i;
  }
};

// load(o) of a slot's five operands
__device__ __forceinline__ auto pair_loads(const float* dispT, const float* mask,
                                           const int* jtypes_t, int n, int j) {
  const long long jn = (long long)j * n;
  return [=](long long o) { return load_pair(dispT, mask, jtypes_t, jn, o); };
}

// Calls body(pair, o) for every slot of atom i with mask > 0, slots
// ascending (o = s * n + i), and dead(o) for every other slot. The next live
// slot's operands, load(o), are loaded before body runs on the current one.
template <class Load, class Dead, class Body>
__device__ __forceinline__ void for_live_slots(const float* __restrict__ mask, int n, int j,
                                               int i, Load load, Dead dead, Body body) {
  LiveSlots<Dead> scan{mask, n, j, i, dead};
  long long o = scan.next();
  Pair cur = {};
  if (o >= 0) cur = load(o);
  while (o >= 0) {
    const long long o2 = scan.next();
    Pair nxt = {};
    if (o2 >= 0) nxt = load(o2);
    body(cur, o);
    cur = nxt;
    o = o2;
  }
}

// for_live_slots in lockstep across the warps of a block whose warps all
// hold the same atoms (atom = lane): every iteration runs body(pair, o, buf)
// on the lanes that still have a live slot, one __syncthreads(), then
// after(pair, o, buf) on them; buf alternates 0, 1. All warps see the same
// live slots, so they leave the loop together. Atoms past n (`on` false)
// have no slot but keep to the barriers.
template <class Dead, class Body, class After>
__device__ __forceinline__ void for_live_slots_lockstep(const float* __restrict__ dispT,
                                                        const float* __restrict__ mask,
                                                        const int* __restrict__ jtypes_t, int n,
                                                        int j, int i, bool on, Dead dead,
                                                        Body body, After after) {
  const auto load = pair_loads(dispT, mask, jtypes_t, n, j);
  LiveSlots<Dead> scan{mask, n, j, i, dead};
  long long o = on ? scan.next() : -1;
  Pair cur = {};
  if (o >= 0) cur = load(o);
  for (int buf = 0;; buf ^= 1) {
    const bool have = o >= 0;
    if (!__any_sync(0xffffffffu, have)) break;
    const long long o2 = have ? scan.next() : -1;
    Pair nxt = {};
    if (o2 >= 0) nxt = load(o2);
    if (have) body(cur, o, buf);
    __syncthreads();
    if (have) after(cur, o, buf);
    cur = nxt;
    o = o2;
  }
}

// one pair's geometry in the arithmetic type R: float on the force path,
// double on K5's (the displacements are widened before the first operation)
template <class R>
struct GeoT {
  R ux, uy, uz, inv_d, ksi, dh, env;
};
using Geo = GeoT<float>;

template <class R>
__device__ __forceinline__ GeoT<R> geometry(const Pair& p, R lo, R hi, R scaling) {
  GeoT<R> g;
  const R x = p.x, y = p.y, z = p.z;
  const R d2 = x * x + y * y + z * z;
  const R d = sqrt(d2);
  g.inv_d = R(1) / d;
  g.ux = x * g.inv_d;
  g.uy = y * g.inv_d;
  g.uz = z * g.inv_d;
  g.ksi = (R(2) * d - (lo + hi)) / (hi - lo);
  g.dh = d - hi;
  g.env = scaling * (g.dh * g.dh);
  return g;
}

// c[mu] = p[mu], mu < MU, by vector loads (p 4 * MU-byte aligned)
template <int MU>
__device__ __forceinline__ void load_mu(const float* p, float (&c)[MU]) {
  if constexpr (MU % 4 == 0) {
#pragma unroll
    for (int k = 0; k < MU / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      c[4 * k] = v.x;
      c[4 * k + 1] = v.y;
      c[4 * k + 2] = v.z;
      c[4 * k + 3] = v.w;
    }
  } else if constexpr (MU % 2 == 0) {
#pragma unroll
    for (int k = 0; k < MU / 2; ++k) {
      const float2 v = reinterpret_cast<const float2*>(p)[k];
      c[2 * k] = v.x;
      c[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) c[mu] = p[mu];
  }
}

// f_mu (and f'_mu) of one pair from its coefficient row crow, transposed to
// (RB, MU) in shared memory: the Chebyshev recursion once, all MU radial
// functions per step, their MU coefficients by vector loads
template <int MU, bool kDeriv>
__device__ __forceinline__ void radial_funcs(const float* crow, int RB, const Geo& g, float hi,
                                             float lo, float scaling, float (&f)[MU],
                                             float (&fp)[MU]) {
  const float mult_c = 2.f / (hi - lo);
  float v0 = g.env, v1 = g.ksi * g.env;
  float g0 = 0.f, g1 = 0.f;
  if constexpr (kDeriv) {
    g0 = scaling * 2.f * g.dh;
    g1 = scaling * (mult_c * (g.dh * g.dh) + 2.f * g.ksi * g.dh);
  }
  float c0[MU], c1[MU];
  load_mu<MU>(crow, c0);
  load_mu<MU>(crow + MU, c1);
#pragma unroll
  for (int mu = 0; mu < MU; ++mu) {
    f[mu] = c0[mu] * v0 + c1[mu] * v1;
    if constexpr (kDeriv) fp[mu] = c0[mu] * g0 + c1[mu] * g1;
  }
  for (int r = 2; r < RB; ++r) {
    const float v2 = 2.f * g.ksi * v1 - v0;
    float g2 = 0.f;
    if constexpr (kDeriv) g2 = 2.f * (mult_c * v1 + g.ksi * g1) - g0;
    float c[MU];
    load_mu<MU>(crow + r * MU, c);
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) {
      f[mu] += c[mu] * v2;
      if constexpr (kDeriv) fp[mu] += c[mu] * g2;
    }
    v0 = v1;
    v1 = v2;
    g0 = g1;
    g1 = g2;
  }
}

// the same for a run-time MU, into thread-private shared columns (stride bd)
template <class R>
__device__ __forceinline__ void radial_funcs_rt(const float* crow, int MU, int RB,
                                                const GeoT<R>& g, R hi, R lo, R scaling,
                                                bool deriv, R* sf, R* sfp, int bd) {
  const R mult_c = R(2) / (hi - lo);
  for (int mu = 0; mu < MU; ++mu) {
    const float* cm = crow + mu * RB;
    R v0 = g.env, v1 = g.ksi * g.env;
    R f = cm[0] * v0 + cm[1] * v1;
    R g0 = 0, g1 = 0, fp = 0;
    if (deriv) {
      g0 = scaling * R(2) * g.dh;
      g1 = scaling * (mult_c * (g.dh * g.dh) + R(2) * g.ksi * g.dh);
      fp = cm[0] * g0 + cm[1] * g1;
    }
    for (int r = 2; r < RB; ++r) {
      const R v2 = R(2) * g.ksi * v1 - v0;
      f += cm[r] * v2;
      if (deriv) {
        const R g2 = R(2) * (mult_c * v1 + g.ksi * g1) - g0;
        fp += cm[r] * g2;
        g0 = g1;
        g1 = g2;
      }
      v0 = v1;
      v1 = v2;
    }
    sf[mu * bd] = f;
    if (deriv) sfp[mu * bd] = fp;
  }
}

// K5: rad[s2 = jt, mu, r] += (w cheb_r) Gmu[mu] for one pair, into
// thread-private shared columns; gmu(mu) gives Gmu
template <class R, class Gmu>
__device__ __forceinline__ void rad_rows(R* srad, int bd, int jt, int MU, int RB,
                                         const GeoT<R>& g, R w, Gmu gmu) {
  R* row = srad + (long long)jt * MU * RB * bd;
  R v0 = g.env, v1 = g.ksi * g.env;
  for (int r = 0; r < RB; ++r) {
    R c = v0;
    if (r == 1) c = v1;
    if (r >= 2) {
      c = R(2) * g.ksi * v1 - v0;
      v0 = v1;
      v1 = c;
    }
    const R wc = w * c;
    for (int mu = 0; mu < MU; ++mu) row[(mu * RB + r) * bd] += wc * gmu(mu);
  }
}

// acc[off(mu) + T] += fw[mu] * U for every mu whose shell holds monomial T
template <class Sh, int T, int MU_ = 0>
__device__ __forceinline__ void basic_terms(float (&acc)[Sh::B], const float (&fw)[Sh::MU],
                                            float U) {
  if constexpr (MU_ < Sh::MU) {
    if constexpr (mono_rank(T) <= Sh::r(MU_)) acc[Sh::off(MU_) + T] += fw[MU_] * U;
    basic_terms<Sh, T, MU_ + 1>(acc, fw, U);
  }
}

// values of type R in the thread-private columns of one pair_kernel
// thread; the block's dynamic shared memory holds the radial coefficients
// (floats) and the term table before them (`pair_head` floats)
__host__ __device__ inline int pair_head(int S, int MU, int RB, int B) {
  const int h = S * S * MU * RB + 4 * B;
  return h + (h & 1);  // columns of doubles start 8-byte aligned
}
template <class Sh, int STAGE>
__host__ __device__ inline int pair_cols(int S, int MU, int RB, int R, int B) {
  int c = 3 * (R + 1) + B + MU;                        // powers, accumulators or gamma, f
  if (STAGE != kStageBasic) c += MU;                   // f'
  if (STAGE == kStageTailCand) c += MU + S * MU * RB;  // Gmu, radial rows
  return c;
}

// The General pair stages, one thread per atom (module comment), for every
// schedule without a specialised shape (those run float_kernel below, and
// K5's double stages cand_kernel). R is the type of every operation and
// sum: float, or double on K5's path, where the basic moments (B, N) and
// gamma are doubles too. The pair forces are written as floats.
template <class Sh, int STAGE, class R = float>
__global__ void __launch_bounds__(kPairThreads)
pair_kernel(const float* __restrict__ dispT, const float* __restrict__ mask,
            const int* __restrict__ itypes, const int* __restrict__ jtypes_t,
            const float* __restrict__ radial, const int* __restrict__ tab,
            const R* __restrict__ gamma,
            std::conditional_t<STAGE == kStageBasic, R, float>* __restrict__ out,
            R* __restrict__ rad, int n, int j, int S, int MU, int RB, int RK, int B, R lo,
            R hi, R scaling) {
  static_assert(!Sh::kSpecial, "specialised shapes run float_kernel and cand_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, bd = blockDim.x;
  const int ncoef = S * S * MU * RB;
  for (int q = tid; q < ncoef; q += bd) smem[q] = radial[q];
  int* sbasic = reinterpret_cast<int*>(smem + ncoef);
  const int nb = 4 * B;
  for (int q = tid; q < nb; q += bd) sbasic[q] = tab[tab[kBasic] + q];
  __syncthreads();
  const int i = blockIdx.x * bd + tid;
  if (i >= n) return;  // no barrier below

  // this thread's columns, stride bd
  R* col = reinterpret_cast<R*>(smem + pair_head(S, MU, RB, B)) + tid;
  const long long jn = (long long)j * n;
  const float* crow0 = smem + (long long)itypes[i] * S * MU * RB;
  R* srad = col;  // K5: S * MU * RB columns first
  if constexpr (STAGE == kStageTailCand) {
    for (int q = 0; q < S * MU * RB; ++q) srad[q * bd] = 0;
    col += S * MU * RB * bd;
  }
  auto dead = [&](long long o) {
    if constexpr (STAGE != kStageBasic) {
      out[o] = 0.f;
      out[jn + o] = 0.f;
      out[2 * jn + o] = 0.f;
    }
  };

  // per-thread values in shared columns, terms from sbasic
  R* spx = col;
  R* spy = spx + (RK + 1) * bd;
  R* spz = spy + (RK + 1) * bd;
  R* sacc = spz + (RK + 1) * bd;  // basic moments, or gamma (tail)
  R* sf = sacc + B * bd;
  R* sfp = sf + MU * bd;
  R* sgmu = sfp + MU * bd;
  for (int k = 0; k < B; ++k)
    sacc[k * bd] = STAGE != kStageBasic ? __ldg(gamma + (long long)k * n + i) : R(0);
  const auto load = pair_loads(dispT, mask, jtypes_t, n, j);
  for_live_slots(mask, n, j, i, load, dead, [&](const Pair& p, long long o) {
    const GeoT<R> g = geometry<R>(p, lo, hi, scaling);
    radial_funcs_rt<R>(crow0 + p.jt * MU * RB, MU, RB, g, hi, lo, scaling,
                       STAGE != kStageBasic, sf, sfp, bd);
    R x = 1, y = 1, z = 1;
    for (int r = 0; r <= RK; ++r) {
      spx[r * bd] = x;
      spy[r * bd] = y;
      spz[r * bd] = z;
      x *= g.ux;
      y *= g.uy;
      z *= g.uz;
    }
    if constexpr (STAGE == kStageBasic) {
      for (int k = 0; k < B; ++k) {
        const int mu = sbasic[4 * k], ax = sbasic[4 * k + 1];
        const int ay = sbasic[4 * k + 2], az = sbasic[4 * k + 3];
        sacc[k * bd] += (sf[mu * bd] * R(p.w)) * (spx[ax * bd] * (spy[ay * bd] * spz[az * bd]));
      }
    } else {
      // `_pair_force_terms`: T_a = u_a sum_k g W1 U + sum_k g W2 alpha_a
      // u^(alpha - e_a), W2 = f/d, W1 = f' - rank f/d
      if constexpr (STAGE == kStageTailCand)
        for (int mu = 0; mu < MU; ++mu) sgmu[mu * bd] = 0;
      R P = 0, Dx = 0, Dy = 0, Dz = 0;
      for (int k = 0; k < B; ++k) {
        const int mu = sbasic[4 * k], ax = sbasic[4 * k + 1];
        const int ay = sbasic[4 * k + 2], az = sbasic[4 * k + 3];
        const int rank = ax + ay + az;
        const R gk = sacc[k * bd];
        const R W2 = sf[mu * bd] * g.inv_d;
        const R fpm = sfp[mu * bd];
        const R W1 = rank ? fpm - (R)rank * W2 : fpm;
        const R qx = spx[ax * bd], qy = spy[ay * bd], qz = spz[az * bd];
        const R U = qx * (qy * qz);
        P += (gk * W1) * U;
        if constexpr (STAGE == kStageTailCand) sgmu[mu * bd] += gk * U;
        if (rank) {
          const R gw2 = gk * W2;
          if (ax > 0) Dx += gw2 * ((R)ax * (spx[(ax - 1) * bd] * (qy * qz)));
          if (ay > 0) Dy += gw2 * ((R)ay * (qx * (spy[(ay - 1) * bd] * qz)));
          if (az > 0) Dz += gw2 * ((R)az * (qx * (qy * spz[(az - 1) * bd])));
        }
      }
      const R w = p.w;
      out[o] = (float)((P * g.ux + Dx) * w);
      out[jn + o] = (float)((P * g.uy + Dy) * w);
      out[2 * jn + o] = (float)((P * g.uz + Dz) * w);
      if constexpr (STAGE == kStageTailCand)
        rad_rows<R>(srad, bd, p.jt, MU, RB, g, w, [&](int mu) { return sgmu[mu * bd]; });
    }
  });
  if constexpr (STAGE == kStageBasic)
    for (int k = 0; k < B; ++k) out[(long long)k * n + i] = sacc[k * bd];
  if constexpr (STAGE == kStageTailCand) {
    const int nrad = S * MU * RB;
    for (int q = 0; q < nrad; ++q) rad[(long long)i * nrad + q] = srad[q * bd];
  }
}

// ---- The specialised float stages (float_kernel), levels 8 and 16: the
// basic stage of K2, K4 and K6, and the tail of K2 and K7; a block takes 32
// atoms. Chosen on an H100 at 32k atoms, level 16, J = 64 (PERF.md §6 lists
// the variants tried):
// - The tail lists the block's live (slot, atom) pairs, slot major, one
//   ballot per slot row, and its 12 warps take them round-robin (thread t:
//   pairs t, t + blockDim, ...). Its outputs do not cross slots, so no lane
//   waits for the atom with the most neighbours, and a warp's 32 pairs lie
//   on one or two rows: its loads of dispT, the mask and jtypes_t and its
//   stores of the forces touch one or two 128-byte lines each. No thread
//   holds gamma (the parent's 254 registers, 8 warps per SM): the block
//   copies its atoms' gamma rows by cp.async into [BP/4][32] float4s (each
//   shell padded to a multiple of 4 terms), read 4 terms at a time,
//   conflict-free (the threads of a warp read one address per atom); 80
//   registers, 24 warps per SM. Before the first pair no thread waits on a
//   chain of global loads: the mask rows and gamma fly as two cp.async
//   groups, each warp loading the shell map of its gamma rows at once and
//   handing it round by shuffles, and the pair list is built while gamma is
//   in flight. (Ballots on global mask rows and a shell-map load per gamma
//   row took half of each block's time; the pair loop itself issues ~3
//   warp instructions a cycle per SM.) Per pair, each monomial U_t is a
//   lower one times one unit-vector component; P = sum_mu f'_mu A_mu with
//   A_mu = sum_t gamma U_t, D_a is summed by exponent and weighted once, and
//   Q = u . D (Euler: U_t is homogeneous of degree rank_t). The zeros of
//   the dead slots are written from the row masks before the pairs start.
//   0.111-0.114 ms -> 0.063-0.069 (chip_smoke.py phase 7, H100 SXM at
//   700 W); tiles of 32 slots, an atom's slots split over warps and
//   persistent double-buffered blocks were slower.
// - The basic stage's sums cross slots, so a thread keeps one atom's B sums
//   in registers and walks its live slots ascending (the parent's scan),
//   loading a live slot's displacement and, with more than one species, its
//   type: three gathers, not five (the moments count a slot by mask > 0, so
//   the mask is read once, in the scan). 0.044 -> 0.041 ms; the slots
//   staged by cp.async, the terms or slots split over 2-4 warps, the warp
//   walking the slot rows in lockstep and a 3-deep prefetch ring were all
//   slower, none beating the scattered gathers' L1 cost.
// The radial coefficients sit transposed, (RB, MU) per species pair, so
// that f_mu's MU coefficients of one Chebyshev step are one vector load.
// Each output element is computed by one thread in one fixed order (a
// basic moment over the slots ascending), the same whatever the block, the
// atom's row or N; no atomics.
// warps of a float_kernel block (32 atoms), and the blocks per SM its
// register budget is set for: the basic stage one warp (254 registers, 8
// warps per SM), the tail 12 (80 registers, 2 blocks, 24 warps per SM)
template <int STAGE>
constexpr int kFloatWarps = STAGE == kStageBasic ? 1 : 12;
template <int STAGE>
constexpr int kFloatBlocks = STAGE == kStageBasic ? 8 : 2;
// floats of a float_kernel block's shared memory: the radial coefficients
// (rounded up to 4), then the tail's mask rows [J][32] (once they are
// read, its pair list [J * 32] of 16-bit slot * 32 + atom), gamma [BP][32],
// the atoms' types [32], live pairs per warp [32] and row masks [J]. The
// tail's 33 floats a slot cap J: 4 (head + 32 BP + 64 + 33 J) bytes must fit
// the 227 KB a block may have, J <= 1,626 at level 16 (BP = 136) with one
// species and RB = 8. Beyond it the launch fails and the wrapper raises.
__host__ __device__ inline int float_head(int S, int MU, int RB) {
  return (S * S * MU * RB + 3) & ~3;
}
template <int STAGE>
__host__ __device__ inline long long float_floats(int S, int MU, int RB, int BP, int j) {
  const long long tail = STAGE == kStageTail ? j * 32LL + BP * 32 + 64 + j : 0;
  return float_head(S, MU, RB) + tail;
}

// a 4-byte copy from global to shared memory, in flight until
// cp_async_wait (zero when !valid: src is then not read but must be an
// address of the tensor)
__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
#else
  *dst = valid ? *src : 0.f;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
// wait until at most `pending` of this thread's newest copy groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
#endif
}

// the monomials U_t = u^(ax, ay, az), t < NT, of one pair, each a lower one
// times one unit-vector component
template <int NT>
__device__ __forceinline__ void monomials_of(const Geo& g, float (&U)[NT]) {
  U[0] = 1.f;
  static_for<NT - 1>([&](auto T) {
    constexpr int t = decltype(T)::value + 1;
    constexpr int ax = mono_ax(t), ay = mono_ay(t), az = mono_rank(t) - ax - ay;
    if constexpr (ax > 0)
      U[t] = U[mono_index(ax - 1, ay, az)] * g.ux;
    else if constexpr (ay > 0)
      U[t] = U[mono_index(ax, ay - 1, az)] * g.uy;
    else
      U[t] = U[mono_index(ax, ay, az - 1)] * g.uz;
  });
}

template <int k>
__device__ __forceinline__ float lane4(const float4& v) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// one pair's force T = w (u (P - Q/d) + D/d) (module comment) with P =
// sum_mu f'_mu A_mu, A_mu = sum_t gamma U_t, and Q = u . D; gamma of shell
// mu, monomial t at g4[32 (poff(mu) + t) / 4], component t % 4
template <class Sh>
__device__ __forceinline__ void tail_pair(const Pair& p, const float* crow, int RB, float lo,
                                          float hi, float scaling, const float4* g4,
                                          float (&out)[3]) {
  constexpr int MU = Sh::MU, RM = Sh::RMAX;
  const Geo g = geometry(p, lo, hi, scaling);
  float f[MU], fp[MU];
  radial_funcs<MU, true>(crow, RB, g, hi, lo, scaling, f, fp);
  float U[Sh::NT];
  monomials_of(g, U);
  // A_mu = sum_t gamma U_t; D_a by exponent e, D[a][e - 1]
  float A[MU], D[3][RM];
#pragma unroll
  for (int mu = 0; mu < MU; ++mu) A[mu] = 0.f;
#pragma unroll
  for (int r = 0; r < RM; ++r) D[0][r] = D[1][r] = D[2][r] = 0.f;
  float4 gq[MU];  // gamma of terms t .. t + 3 of each shell
  static_for<Sh::NT>([&](auto T) {
    constexpr int t = decltype(T)::value;
    constexpr int rank = mono_rank(t);
    constexpr int ax = mono_ax(t), ay = mono_ay(t), az = rank - ax - ay;
    float G = 0.f;
    static_for<MU>([&](auto M) {
      constexpr int mu = decltype(M)::value;
      if constexpr (rank <= Sh::r(mu)) {
        if constexpr (t % 4 == 0) gq[mu] = g4[(Sh::poff(mu) + t) / 4 * 32];
        const float gk = lane4<t % 4>(gq[mu]);
        G += gk * f[mu];
        A[mu] += gk * U[t];
      }
    });
    if constexpr (ax > 0) D[0][ax - 1] += G * U[mono_index(ax - 1, ay, az)];
    if constexpr (ay > 0) D[1][ay - 1] += G * U[mono_index(ax, ay - 1, az)];
    if constexpr (az > 0) D[2][az - 1] += G * U[mono_index(ax, ay, az - 1)];
  });
  float Dx = 0.f, Dy = 0.f, Dz = 0.f;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    Dx += (float)(r + 1) * D[0][r];
    Dy += (float)(r + 1) * D[1][r];
    Dz += (float)(r + 1) * D[2][r];
  }
  // P = sum_t G'_t U_t = sum_mu f'_mu A_mu; Q = sum_t rank_t G_t U_t = u . D
  // (Euler: U_t is homogeneous of degree rank_t)
  float P = 0.f;
#pragma unroll
  for (int mu = 0; mu < MU; ++mu) P += fp[mu] * A[mu];
  const float Q = g.ux * Dx + g.uy * Dy + g.uz * Dz;
  const float Pr = P - Q * g.inv_d;
  out[0] = (Pr * g.ux + Dx * g.inv_d) * p.w;
  out[1] = (Pr * g.uy + Dy * g.inv_d) * p.w;
  out[2] = (Pr * g.uz + Dz * g.inv_d) * p.w;
}

// gamma row (shell mu, monomial t) of canonical term c in the padded order
template <class Sh>
__device__ __forceinline__ int padded_term(int c) {
  int p = c;
  static_for<Sh::MU>([&](auto Q) {
    constexpr int q = decltype(Q)::value;
    if (c >= Sh::off(q)) p = Sh::poff(q) + c - Sh::off(q);
  });
  return p;
}

// one pair's basic moments, acc[off(mu) + t] += f_mu U_t (a slot counts
// by mask > 0, as in the plain twin)
template <class Sh>
__device__ __forceinline__ void basic_pair(const Pair& p, const float* crow, int RB, float lo,
                                           float hi, float scaling, float (&acc)[Sh::B]) {
  const Geo g = geometry(p, lo, hi, scaling);
  float f[Sh::MU], fp[Sh::MU];
  radial_funcs<Sh::MU, false>(crow, RB, g, hi, lo, scaling, f, fp);
  float px[Sh::RMAX + 1], py[Sh::RMAX + 1], pz[Sh::RMAX + 1];
  px[0] = py[0] = pz[0] = 1.f;
#pragma unroll
  for (int r = 1; r <= Sh::RMAX; ++r) {
    px[r] = px[r - 1] * g.ux;
    py[r] = py[r - 1] * g.uy;
    pz[r] = pz[r - 1] * g.uz;
  }
  static_for<Sh::NT>([&](auto T) {
    constexpr int t = decltype(T)::value;
    constexpr int ax = mono_ax(t), ay = mono_ay(t), az = mono_rank(t) - ax - ay;
    basic_terms<Sh, t>(acc, f, px[ax] * (py[ay] * pz[az]));
  });
}

template <class Sh, int STAGE>
__global__ void __launch_bounds__(32 * kFloatWarps<STAGE>, kFloatBlocks<STAGE>)
float_kernel(const float* __restrict__ dispT, const float* __restrict__ mask,
             const int* __restrict__ itypes, const int* __restrict__ jtypes_t,
             const float* __restrict__ radial, const int* __restrict__ tab,
             const float* __restrict__ gamma, float* __restrict__ out, int n, int j, int S,
             int RB, float lo, float hi, float scaling) {
  constexpr int MU = Sh::MU, B = Sh::B, KW = kFloatWarps<STAGE>;
  static_assert(STAGE == kStageBasic || STAGE == kStageTail, "");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* scoef = reinterpret_cast<float*>(smem_raw);  // [S][S][RB][MU]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long jn = (long long)j * n;
  const int* kmap = tab + tab[kShellMap];
  // the coefficients (S, S, MU, RB) transposed to (S, S, RB, MU)
  for (int q = threadIdx.x; q < S * S * MU * RB; q += blockDim.x) {
    const int r = q % RB, mu = (q / RB) % MU, row = q / (RB * MU);
    scoef[(row * RB + r) * MU + mu] = radial[q];
  }

  if constexpr (STAGE == kStageBasic) {
    __syncthreads();
    const int i = blockIdx.x * 32 + lane;
    if (i >= n) return;  // no barrier below
    const float* crow0 = scoef + __ldg(itypes + i) * S * RB * MU;
    float acc[B];
#pragma unroll
    for (int c = 0; c < B; ++c) acc[c] = 0.f;
    // a live slot's displacement and, with more than one species, its type:
    // its mask is not read again (w = 1: the basic moments count a slot by
    // mask > 0), three gathers a slot, not five
    auto load = [&](long long o) {
      Pair p;
      p.x = __ldg(dispT + o);
      p.y = __ldg(dispT + jn + o);
      p.z = __ldg(dispT + 2 * jn + o);
      p.w = 1.f;
      p.jt = S > 1 ? __ldg(jtypes_t + o) : 0;
      return p;
    };
    for_live_slots(mask, n, j, i, load, [](long long) {}, [&](const Pair& p, long long) {
      basic_pair<Sh>(p, crow0 + p.jt * RB * MU, RB, lo, hi, scaling, acc);
    });
#pragma unroll
    for (int c = 0; c < B; ++c) out[(long long)__ldg(kmap + c) * n + i] = acc[c];
  } else {
    const int base = blockIdx.x * 32;
    const int valid = min(32, n - base);  // atoms of this block
    const bool on = lane < valid;
    const int l = min(lane, valid - 1);
    float* smask = scoef + float_head(S, MU, RB);                     // [J][32]
    unsigned short* list = reinterpret_cast<unsigned short*>(smask);  // over it: [J * 32]
    float4* sgam = reinterpret_cast<float4*>(smask + j * 32);         // [BP / 4][32]
    int* sit = reinterpret_cast<int*>(sgam + Sh::BP / 4 * 32);        // the atoms' types [32]
    int* scount = sit + 32;                                  // live pairs of each warp's rows
    unsigned* rows = reinterpret_cast<unsigned*>(scount + 32);  // live atoms of each slot [J]
    // the mask rows (one copy group), then gamma (a second): warp w takes
    // the gamma rows c = w (mod KW), its lanes loading their shell map 32
    // rows at a time and handing it round; row kmap[c] of gamma (B, N) goes
    // to its padded row p, [p / 4][lane][p % 4]
    for (int s = warp; s < j; s += KW)
      copy4_async(smask + s * 32 + lane, mask + (long long)s * n + base + l, on);
    cp_async_commit();
    if (warp == 0) sit[lane] = __ldg(itypes + base + l);
    float* sg = reinterpret_cast<float*>(sgam);
    for (int c0 = warp; c0 < B; c0 += 32 * KW) {
      const int cl = c0 + KW * lane;
      const int km = cl < B ? __ldg(kmap + cl) : 0, pl = cl < B ? padded_term<Sh>(cl) : 0;
      for (int r = 0; r < 32 && c0 + KW * r < B; ++r) {
        const int k = __shfl_sync(0xffffffffu, km, r), pr = __shfl_sync(0xffffffffu, pl, r);
        copy4_async(sg + ((pr >> 2) * 32 + lane) * 4 + (pr & 3),
                    gamma + (long long)k * n + base + l, on);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the mask rows are in place; gamma may still be in flight
    // the live atoms of each slot row, warp w taking the rows [r0, r1)
    const int per = (j + KW - 1) / KW;
    const int r0 = min(j, warp * per), r1 = min(j, r0 + per);
    int count = 0;
    for (int s = r0; s < r1; ++s) {
      const unsigned bits = __ballot_sync(0xffffffffu, smask[s * 32 + lane] > 0.f);
      if (lane == 0) rows[s] = bits;
      count += __popc(bits);
    }
    if (lane == 0) scount[warp] = count;
    __syncthreads();  // the mask rows are read: the list goes over them
    int at = 0, total = 0;
    for (int w = 0; w < KW; ++w) {
      at += w < warp ? scount[w] : 0;
      total += scount[w];
    }
    // the pair list, and zeros at the dead slots of the rows
    for (int s = r0; s < r1; ++s) {
      const unsigned bits = rows[s];
      const long long o = (long long)s * n + base + lane;
      if ((bits >> lane) & 1u) {
        list[at + __popc(bits & ((1u << lane) - 1))] = (unsigned short)(s * 32 + lane);
      } else if (on) {
        out[o] = 0.f;
        out[jn + o] = 0.f;
        out[2 * jn + o] = 0.f;
      }
      at += __popc(bits);
    }
    cp_async_wait<0>();
    __syncthreads();  // the list and gamma are in place
    // the pairs, thread t taking t, t + blockDim, ...; the next one's
    // operands are loaded before the current one is contracted
    auto slot = [&](int sa) { return (long long)(sa >> 5) * n + base + (sa & 31); };
    int e = threadIdx.x, sa = e < total ? list[e] : 0;
    Pair cur = {};
    if (e < total) cur = load_pair(dispT, mask, jtypes_t, jn, slot(sa));
    while (e < total) {
      const int e2 = e + blockDim.x, sa2 = e2 < total ? list[e2] : 0;
      Pair nxt = {};
      if (e2 < total) nxt = load_pair(dispT, mask, jtypes_t, jn, slot(sa2));
      const int a = sa & 31;
      float f3[3];
      tail_pair<Sh>(cur, scoef + (sit[a] * S + cur.jt) * RB * MU, RB, lo, hi, scaling, sgam + a,
                    f3);
      const long long o = slot(sa);
      out[o] = f3[0];
      out[jn + o] = f3[1];
      out[2 * jn + o] = f3[2];
      e = e2;
      sa = sa2;
      cur = nxt;
    }
  }
}

// ---- K5's specialised stages in double (cand_kernel). A thread cannot
// keep 130 double sums (260 registers), so a block is kSubs warps over the
// same 32 atoms (atom = lane in every warp) and warp w takes the terms of
// monomial group w: its share of the basic moments, or of gamma, stays in
// registers. The groups are cut at compile time (make_split): monomials in
// their order, each to the group with the least work so far.

// warps (term groups) of a cand_kernel block, and the blocks per SM its
// register budget is set for. Measured at level 16 (the module comment):
// the basic stage, 2 groups of ~65 sums in 254 registers, 8 warps per SM;
// the tail, 4 groups of ~33 gamma values in 168 registers, 12 warps per SM.
// More groups cost more than the occupancy they buy: every warp rebuilds
// the pair's geometry and radial functions.
template <int STAGE>
constexpr int kSubs = STAGE == kStageBasic ? 2 : 4;
template <int STAGE>
constexpr int kCandBlocks = STAGE == kStageBasic ? 4 : 3;
constexpr int kCandRB = 8;  // Chebyshev functions kept in registers
constexpr int kLd = 33;     // row stride of the radial rows (odd: no conflicts)

template <class Sh>
__host__ __device__ constexpr int n_shells(int t) {
  int c = 0;
  for (int mu = 0; mu < Sh::MU; ++mu) c += mono_rank(t) <= Sh::r(mu);
  return c;
}

template <class Sh, int STAGE>
struct SplitTable {
  int sub[Sh::NT];          // group of monomial t
  int loc[Sh::B];           // index of canonical term c among its group's terms
  int count[kSubs<STAGE>];  // terms of each group
};

// work per monomial: the basic stage builds U_t and adds one FMA per term;
// the tail builds U_t and its derivative monomials, adds P, Q and D_a, and
// three FMAs per term (G_t, G'_t, Gmu)
template <class Sh, int STAGE>
constexpr SplitTable<Sh, STAGE> make_split() {
  SplitTable<Sh, STAGE> x{};
  const int cm = STAGE == kStageBasic ? 2 : 9, ct = STAGE == kStageBasic ? 1 : 3;
  int load[kSubs<STAGE>] = {};
  for (int t = 0; t < Sh::NT; ++t) {
    int s = 0;
    for (int q = 1; q < kSubs<STAGE>; ++q)
      if (load[q] < load[s]) s = q;
    x.sub[t] = s;
    load[s] += cm + ct * n_shells<Sh>(t);
  }
  for (int mu = 0; mu < Sh::MU; ++mu)
    for (int t = 0; t < n_mono(Sh::r(mu)); ++t) x.loc[Sh::off(mu) + t] = x.count[x.sub[t]]++;
  return x;
}
// the cut as compile-time scalars (each evaluates make_split once)
template <class Sh, int STAGE, int T>
constexpr int kSubOf = make_split<Sh, STAGE>().sub[T];  // group of monomial T
template <class Sh, int STAGE, int C>
constexpr int kLocOf = make_split<Sh, STAGE>().loc[C];  // slot of term C in its group
template <class Sh, int STAGE>
constexpr int group_max() {
  const SplitTable<Sh, STAGE> x = make_split<Sh, STAGE>();
  int m = 1;
  for (int w = 0; w < kSubs<STAGE>; ++w) m = x.count[w] > m ? x.count[w] : m;
  return m;
}
template <class Sh, int STAGE, int W, int MU_>
constexpr bool group_has_mu() {
  const SplitTable<Sh, STAGE> x = make_split<Sh, STAGE>();
  for (int t = 0; t < n_mono(Sh::r(MU_)); ++t)
    if (x.sub[t] == W) return true;
  return false;
}
template <class Sh, int STAGE>
constexpr int kGroupMax = group_max<Sh, STAGE>();  // most terms of one group
template <class Sh, int STAGE, int W, int MU_>
constexpr bool kHasMu = group_has_mu<Sh, STAGE, W, MU_>();  // group W uses f_MU_

// f(mu, t, c) for every canonical term c = off(mu) + t of group W, mu-major
template <class Sh, int STAGE, int W, class F>
__device__ __forceinline__ void for_group_terms(F f) {
  static_for<Sh::MU>([&](auto M) {
    constexpr int mu = decltype(M)::value;
    static_for<n_mono(Sh::r(mu))>([&](auto T) {
      constexpr int t = decltype(T)::value;
      if constexpr (kSubOf<Sh, STAGE, t> == W)
        f(M, T, std::integral_constant<int, Sh::off(mu) + t>{});
    });
  });
}

// cand_kernel's radial constants: hi, lo + hi, 1 / (hi - lo), its double,
// and the envelope's scaling
struct Radial {
  double hi, lh, inv_span, mult_c, scaling;
};

// One pair's geometry in double for cand_kernel: 1/d by rsqrt, d = d2/d and
// the span by its reciprocal (a double division or square root costs ~20
// operations, and every warp of the block rebuilds the geometry)
__device__ __forceinline__ GeoT<double> cand_geometry(const Pair& p, const Radial& rc) {
  GeoT<double> g;
  const double x = p.x, y = p.y, z = p.z;
  const double d2 = x * x + y * y + z * z;
  g.inv_d = rsqrt(d2);
  const double d = d2 * g.inv_d;
  g.ux = x * g.inv_d;
  g.uy = y * g.inv_d;
  g.uz = z * g.inv_d;
  g.ksi = (2.0 * d - rc.lh) * rc.inv_span;
  g.dh = d - rc.hi;
  g.env = rc.scaling * (g.dh * g.dh);
  return g;
}

// One pair's Chebyshev values cheb[r] (r < RB <= kCandRB) in double, and
// f_mu (and f'_mu) of the radial functions group W uses, from the float
// coefficient row crow (MU, RB): the recursion once
template <class Sh, int STAGE, int W, bool kDeriv>
__device__ __forceinline__ void cand_radial(const float* crow, int RB, const GeoT<double>& g,
                                            const Radial& rc, double (&cheb)[kCandRB],
                                            double (&f)[Sh::MU], double (&fp)[Sh::MU]) {
  const double mult_c = rc.mult_c;
  double v0 = g.env, v1 = g.ksi * g.env, g0 = 0, g1 = 0;
  if constexpr (kDeriv) {
    g0 = rc.scaling * 2.0 * g.dh;
    g1 = rc.scaling * (mult_c * (g.dh * g.dh) + 2.0 * g.ksi * g.dh);
  }
#pragma unroll
  for (int mu = 0; mu < Sh::MU; ++mu) f[mu] = fp[mu] = 0;
#pragma unroll
  for (int r = 0; r < kCandRB; ++r) {
    if (r >= RB) break;
    double v = v0, gd = g0;
    if (r == 1) {
      v = v1;
      gd = g1;
    } else if (r >= 2) {
      v = 2.0 * g.ksi * v1 - v0;
      if constexpr (kDeriv) gd = 2.0 * (mult_c * v1 + g.ksi * g1) - g0;
      v0 = v1;
      v1 = v;
      g0 = g1;
      g1 = gd;
    }
    cheb[r] = v;
    static_for<Sh::MU>([&](auto M) {
      constexpr int mu = decltype(M)::value;
      if constexpr (kHasMu<Sh, STAGE, W, mu>) {
        const double c = crow[mu * RB + r];
        f[mu] += c * v;
        if constexpr (kDeriv) fp[mu] += c * gd;
      }
    });
  }
}

// powers u_a^e, e <= RMAX, of one pair's unit vector
template <int RMAX>
struct Powers {
  double x[RMAX + 1], y[RMAX + 1], z[RMAX + 1];
  __device__ __forceinline__ Powers(const GeoT<double>& g) {
    x[0] = y[0] = z[0] = 1.0;
#pragma unroll
    for (int r = 1; r <= RMAX; ++r) {
      x[r] = x[r - 1] * g.ux;
      y[r] = y[r - 1] * g.uy;
      z[r] = z[r - 1] * g.uz;
    }
  }
};

// Group W's work on one pair. Basic stage: acc[loc(c)] += w f_mu U_t.
// Tail: the group's share of T = w (u (P - Q/d) + D/d) and of Gmu[mu],
// written to its row of the block's partial sums (stride 32: [3 + MU][32]).
template <class Sh, int STAGE, int W>
__device__ __forceinline__ void cand_group_pair(const Pair& p, const float* crow, int RB,
                                                const Radial& rc,
                                                double (&acc)[kGroupMax<Sh, STAGE>],
                                                double (&cheb)[kCandRB], double* part) {
  constexpr int MU = Sh::MU;
  constexpr bool kTail = STAGE != kStageBasic;
  const GeoT<double> g = cand_geometry(p, rc);
  double f[MU], fp[MU];
  cand_radial<Sh, STAGE, W, kTail>(crow, RB, g, rc, cheb, f, fp);
  const Powers<Sh::RMAX> pw(g);
  if constexpr (!kTail) {
    const double w = p.w;
    for_group_terms<Sh, STAGE, W>([&](auto M, auto T, auto C) {
      constexpr int mu = decltype(M)::value, t = decltype(T)::value;
      constexpr int ax = mono_ax(t), ay = mono_ay(t), az = mono_rank(t) - ax - ay;
      constexpr int l = kLocOf<Sh, STAGE, decltype(C)::value>;
      acc[l] += (f[mu] * w) * (pw.x[ax] * (pw.y[ay] * pw.z[az]));
    });
  } else {
    double P = 0, Q = 0, Dx = 0, Dy = 0, Dz = 0, gmu[MU];
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) gmu[mu] = 0;
    static_for<Sh::NT>([&](auto T) {
      constexpr int t = decltype(T)::value;
      if constexpr (kSubOf<Sh, STAGE, t> == W) {
        constexpr int rank = mono_rank(t);
        constexpr int ax = mono_ax(t), ay = mono_ay(t), az = rank - ax - ay;
        const double yz = pw.y[ay] * pw.z[az];
        const double U = pw.x[ax] * yz;
        double G = 0, Gp = 0;
        static_for<MU>([&](auto M) {
          constexpr int mu = decltype(M)::value;
          if constexpr (rank <= Sh::r(mu)) {
            constexpr int l = kLocOf<Sh, STAGE, Sh::off(mu) + t>;
            G += acc[l] * f[mu];
            Gp += acc[l] * fp[mu];
            gmu[mu] += acc[l] * U;
          }
        });
        P += Gp * U;
        if constexpr (rank > 0) Q += (double)rank * (G * U);
        if constexpr (ax > 0) Dx += G * ((double)ax * (pw.x[ax - 1] * yz));
        if constexpr (ay > 0) Dy += G * ((double)ay * (pw.x[ax] * (pw.y[ay - 1] * pw.z[az])));
        if constexpr (az > 0) Dz += G * ((double)az * (pw.x[ax] * (pw.y[ay] * pw.z[az - 1])));
      }
    });
    const double Pr = P - Q * g.inv_d, w = p.w;
    part[0] = (Pr * g.ux + Dx * g.inv_d) * w;
    part[32] = (Pr * g.uy + Dy * g.inv_d) * w;
    part[64] = (Pr * g.uz + Dz * g.inv_d) * w;
#pragma unroll
    for (int mu = 0; mu < MU; ++mu) part[(3 + mu) * 32] = gmu[mu];
  }
}

// shared memory of a cand_kernel block: the radial coefficients (floats,
// rounded up to even), then for the tail the partial sums [2][kSubs][3 +
// MU][32] and the radial rows [S * MU * RB][kLd] as doubles
__host__ __device__ inline int cand_head(int S, int MU, int RB) {
  const int h = S * S * MU * RB;
  return h + (h & 1);
}
__host__ __device__ inline int cand_doubles(int STAGE, int S, int MU, int RB) {
  return STAGE == kStageBasic ? 0 : 2 * kSubs<kStageTailCand> * (3 + MU) * 32 + S * MU * RB * kLd;
}

// K5's basic stage and tail with the radial rows for a specialised shape,
// in double: a block of kSubs warps over 32 atoms (the comment above).
// Basic: warp w sums its group's moments over the atom's live slots and
// writes them as (B, N) rows. Tail: the warps walk the live slots in
// lockstep; each writes its group's partial T and Gmu of the pair, then
// after one barrier warp a < 3 sums component a of T over the groups in
// group order and writes it, and warp w sums Gmu[mu] for mu = w (mod
// kSubs) and adds w Gmu[mu] cheb_r to the radial rows in shared memory,
// written at the end as whole lines of rad (N, S*MU*RB).
template <class Sh, int STAGE>
__global__ void __launch_bounds__(32 * kSubs<STAGE>, kCandBlocks<STAGE>)
cand_kernel(const float* __restrict__ dispT, const float* __restrict__ mask,
            const int* __restrict__ itypes, const int* __restrict__ jtypes_t,
            const float* __restrict__ radial, const int* __restrict__ tab,
            const double* __restrict__ gamma,
            std::conditional_t<STAGE == kStageBasic, double, float>* __restrict__ out,
            double* __restrict__ rad, int n, int j, int S, int RB, double lo, double hi,
            double scaling) {
  constexpr int MU = Sh::MU, SUBS = kSubs<STAGE>;
  static_assert(STAGE == kStageBasic || SUBS >= 3, "the tail's warps 0-2 sum T's components");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* scoef = reinterpret_cast<float*>(smem_raw);
  double* part = reinterpret_cast<double*>(scoef + cand_head(S, MU, RB));
  const int nrad = S * MU * RB;
  double* srad = part + 2 * SUBS * (3 + MU) * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = threadIdx.x; q < S * S * MU * RB; q += blockDim.x) scoef[q] = radial[q];
  if constexpr (STAGE != kStageBasic)
    for (int q = threadIdx.x; q < nrad * kLd; q += blockDim.x) srad[q] = 0;
  __syncthreads();
  const int base = blockIdx.x * 32, i = base + lane;
  const bool on = i < n;
  const long long jn = (long long)j * n;
  const int* kmap = tab + tab[kShellMap];
  const float* crow0 = scoef + (on ? itypes[i] : 0) * S * MU * RB;
  const double inv_span = 1.0 / (hi - lo);
  const Radial rc = {hi, lo + hi, inv_span, 2.0 * inv_span, scaling};
  double acc[kGroupMax<Sh, STAGE>];  // the group's basic moments, or its gamma
  double cheb[kCandRB];

  if constexpr (STAGE == kStageBasic) {
    static_for<SUBS>([&](auto Wc) {
      constexpr int W = decltype(Wc)::value;
      if (warp != W || !on) return;
#pragma unroll
      for (int l = 0; l < kGroupMax<Sh, STAGE>; ++l) acc[l] = 0;
      for_live_slots(mask, n, j, i, pair_loads(dispT, mask, jtypes_t, n, j), [](long long) {},
                     [&](const Pair& p, long long) {
                       cand_group_pair<Sh, STAGE, W>(p, crow0 + p.jt * MU * RB, RB, rc, acc,
                                                     cheb, nullptr);
                     });
      for_group_terms<Sh, STAGE, W>([&](auto, auto, auto C) {
        constexpr int c = decltype(C)::value;
        constexpr int l = kLocOf<Sh, STAGE, c>;
        out[(long long)__ldg(kmap + c) * n + i] = acc[l];
      });
    });
  } else {
    static_for<SUBS>([&](auto Wc) {
      constexpr int W = decltype(Wc)::value;
      if (warp != W || !on) return;
      for_group_terms<Sh, STAGE, W>([&](auto, auto, auto C) {
        constexpr int c = decltype(C)::value;
        constexpr int l = kLocOf<Sh, STAGE, c>;
        acc[l] = __ldg(gamma + (long long)__ldg(kmap + c) * n + i);
      });
    });
    // warps 0-2 write the zeros of component `warp` at the dead slots
    auto dead = [&](long long o) {
      if (warp < 3) out[warp * jn + o] = 0.f;
    };
    const int prow = (3 + MU) * 32;  // one group's partial sums
    for_live_slots_lockstep(
        dispT, mask, jtypes_t, n, j, i, on, dead,
        [&](const Pair& p, long long, int buf) {
          double* mine = part + (buf * SUBS + warp) * prow + lane;
          static_for<SUBS>([&](auto Wc) {
            constexpr int W = decltype(Wc)::value;
            if (warp == W)
              cand_group_pair<Sh, STAGE, W>(p, crow0 + p.jt * MU * RB, RB, rc, acc, cheb,
                                            mine);
          });
        },
        [&](const Pair& p, long long o, int buf) {
          const double* ps = part + buf * SUBS * prow + lane;
          if (warp < 3) {
            double T = 0;
#pragma unroll
            for (int s = 0; s < SUBS; ++s) T += ps[s * prow + warp * 32];
            out[warp * jn + o] = (float)T;
          }
#pragma unroll
          for (int mu = 0; mu < MU; ++mu) {
            if (mu % SUBS != warp) continue;
            double G = 0;
#pragma unroll
            for (int s = 0; s < SUBS; ++s) G += ps[s * prow + (3 + mu) * 32];
            const double h = (double)p.w * G;
            double* row = srad + (p.jt * MU + mu) * RB * kLd + lane;
#pragma unroll
            for (int r = 0; r < kCandRB; ++r)
              if (r < RB) row[r * kLd] += h * cheb[r];
          }
        });
    __syncthreads();
    const int valid = min(32, n - base);
    for (int q = threadIdx.x; q < valid * nrad; q += blockDim.x) {
      const int a = q / nrad;
      rad[(long long)base * nrad + q] = srad[(q - a * nrad) * kLd + a];
    }
  }
}

// sum over q in [q0, q1) of x[i0(q)] * y[i1(q)] * mult(q), entries (i0 | i1
// << 16, mult), in table order; four products are loaded and formed at a
// time so that their shared-memory reads overlap
template <class R>
__device__ __forceinline__ R segment_sum(const int2* e, int q0, int q1, const R* x, const R* y,
                                         int W, int a) {
  R acc = 0;
  int q = q0;
  for (; q + 4 <= q1; q += 4) {
    R p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int2 v = e[q + u];
      p[u] = x[(v.x & 0xffff) * W + a] * y[((unsigned)v.x >> 16) * W + a] * (R)v.y;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += p[u];
  }
  for (; q < q1; ++q) {
    const int2 v = e[q];
    acc += x[(v.x & 0xffff) * W + a] * y[((unsigned)v.x >> 16) * W + a] * (R)v.y;
  }
  return acc;
}

// The product DAG of W atoms per block, one atom per lane of each worker
// (a group of W lanes; 32 / W of them in a warp, so no lane idles when m and
// dm of 32 atoms do not fit); the workers split each wave's targets, which
// the host orders longest segment first so that round-robin shares them out
// evenly and the groups of a warp take segments of about one length (module
// comment). mbg holds the basic moments (B, N) on entry; K2 and K5 write
// gamma = dm[:B] over them. R is the type of m, dm and every operation:
// float, or double on K5's path.
template <int MODE, bool kStaged, class R = float>
__global__ void __launch_bounds__(kDagThreads)
dag_kernel(R* mbg, const float* __restrict__ xi, const float* __restrict__ per_atom,
           const int* __restrict__ tab, const int* __restrict__ mapping,
           float* __restrict__ site, R* __restrict__ bm, int n, int B, int M, int n_waves,
           int n_scal, int W, int n_dag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* smem = reinterpret_cast<R*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = 32 / W, grp = lane / W, a = lane - grp * W;
  const int wk = warp * groups + grp, nwk = (blockDim.x >> 5) * groups;  // worker, workers
  const int i = blockIdx.x * W + a;
  const bool on = i < n;
  const int extra = MODE == kCand ? bm_stride(n_scal) : 0;
  R* m = smem;                         // [M][W]
  R* dm = smem + (long long)M * W;  // [max(M, nwk + extra)][W]
  // the DAG sections (n_dag ints from an even offset) in shared memory when
  // they fit beside m and dm (kStaged), so that table reads are shared
  // loads and wait on no cache
  const int base = tab[kFwdWave] & ~1;
  const int* dag = tab + base;
  if constexpr (kStaged) {
    int2* st = reinterpret_cast<int2*>(smem + dag_floats(M, W, extra));  // 8-byte aligned
    const int2* src = reinterpret_cast<const int2*>(tab + base);
#pragma unroll 4
    for (int q = threadIdx.x; q < n_dag / 2; q += blockDim.x) st[q] = __ldg(src + q);
    dag = reinterpret_cast<const int*>(st);
  }
#pragma unroll 8
  for (int k = wk; k < B; k += nwk) m[k * W + a] = on ? __ldcg(mbg + (long long)k * n + i) : R(0);
  for (int k = B + wk; k < M; k += nwk) m[k * W + a] = 0;
  __syncthreads();

  const int* fwave = dag + (tab[kFwdWave] - base);
  const int* ftgt = dag + (tab[kFwdTarget] - base);
  const int* fseg = dag + (tab[kFwdSeg] - base);
  const int2* fprod = reinterpret_cast<const int2*>(dag + (tab[kFwdProd] - base));
  for (int wv = 0; wv < n_waves; ++wv) {
    for (int t = fwave[wv] + wk; t < fwave[wv + 1]; t += nwk)
      m[ftgt[t] * W + a] += segment_sum<R>(fprod, fseg[t], fseg[t + 1], m, m, W, a);
    __syncthreads();
  }

  if constexpr (MODE == kSite || MODE == kCand) {
    // readout: site energy = esp + xi . m, each worker over its strided part
    // of the nodes, the parts summed in worker order (dm is not in use yet)
    R e = 0;
#pragma unroll 8
    for (int k = wk; k < M; k += nwk) {
      const R x = __ldg(xi + k);
      if (x != R(0)) e += x * m[k * W + a];
    }
    R* part = dm;  // [nwk][W], within dm's rows
    part[wk * W + a] = e;
    // K5: the scalar basis members m[mapping] (the candidate vector's tail),
    // gathered into [W][ld] rows after the parts, then stored as whole lines
    R* stage = dm + (long long)nwk * W;
    const int ld = bm_stride(n_scal);
    if constexpr (MODE == kCand) {
      for (int q = threadIdx.x; q < n_scal * W; q += blockDim.x) {
        const int s = q / W, at = q - s * W;
        stage[at * ld + s] = m[__ldg(mapping + s) * W + at];
      }
    }
    __syncthreads();
    if (wk == 0 && on) {
      R sum = 0;
      for (int w = 0; w < nwk; ++w) sum += part[w * W + a];
      site[i] = (float)(sum + R(per_atom[i]));
    }
    if constexpr (MODE == kSite) return;
    const long long b0 = (long long)blockIdx.x * W;
    const int valid = (int)min((long long)W, n - b0);
    for (int q = threadIdx.x; q < valid * n_scal; q += blockDim.x) {
      const int at = q / n_scal;
      bm[b0 * n_scal + q] = stage[at * ld + (q - at * n_scal)];
    }
    __syncthreads();  // the parts and the staged members are read before dm is written
  }

  if constexpr (MODE == kForces || MODE == kCand) {
    // reverse DAG from dm = xi * de (K5: de = 1), grouped by written node
    R de = 1;
    if constexpr (MODE == kForces) de = (per_atom && on) ? per_atom[i] : 1.f;
#pragma unroll 8
    for (int k = wk; k < M; k += nwk) dm[k * W + a] = R(__ldg(xi + k)) * de;
    __syncthreads();
    const int* rwave = dag + (tab[kRevWave] - base);
    const int* rnode = dag + (tab[kRevNode] - base);
    const int* rseg = dag + (tab[kRevSeg] - base);
    const int2* rent = reinterpret_cast<const int2*>(dag + (tab[kRevEnt] - base));
    for (int wv = n_waves - 1; wv >= 0; --wv) {
      for (int t = rwave[wv] + wk; t < rwave[wv + 1]; t += nwk)
        dm[rnode[t] * W + a] += segment_sum<R>(rent, rseg[t], rseg[t + 1], dm, m, W, a);
      __syncthreads();
    }
    if (on)
      for (int k = wk; k < B; k += nwk) __stcg(mbg + (long long)k * n + i, dm[k * W + a]);
  }
}

// ---- launchers

struct Args {
  const float *dispT, *mask;
  const int *itypes, *jtypes_t;
  const float *radial, *xi, *per_atom;
  const int *tab, *mapping;
  float *out, *scratch;
  int n, j, S, MU, RB, R, B, M, n_waves, n_dag, n_scal, shape;
  double lo, hi, scaling;  // float kernels take them as floats
  cudaStream_t stream;
};

// a kernel's dynamic shared memory; an error (more than the block may have)
// is returned and cleared, so that the next launch's cudaGetLastError does
// not report it
int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)bytes);
  if (e) cudaGetLastError();
  return e;
}

// block size and dynamic shared memory of a General pair stage
template <class Sh, int STAGE, class R = float>
void pair_config(const Args& a, int* bd, size_t* smem) {
  *bd = 32;
  *smem = sizeof(float) * pair_head(a.S, a.MU, a.RB, a.B) +
          sizeof(R) * (size_t)*bd * pair_cols<Sh, STAGE>(a.S, a.MU, a.RB, a.R, a.B);
}

// the specialised float stages: dynamic shared memory of a float_kernel block
template <class Sh, int STAGE>
size_t float_smem(const Args& a) {
  return sizeof(float) * (size_t)float_floats<STAGE>(a.S, Sh::MU, a.RB, Sh::BP, a.j);
}

template <class Sh, int STAGE>
int launch_float_as(const Args& a, const float* gamma, float* out) {
  const size_t smem = float_smem<Sh, STAGE>(a);
  if (const int e = set_smem((const void*)float_kernel<Sh, STAGE>, smem)) return e;
  const unsigned blocks = (unsigned)((a.n + 31) / 32);
  float_kernel<Sh, STAGE><<<blocks, 32 * kFloatWarps<STAGE>, smem, a.stream>>>(
      a.dispT, a.mask, a.itypes, a.jtypes_t, a.radial, a.tab, gamma, out, a.n, a.j, a.S,
      a.RB, (float)a.lo, (float)a.hi, (float)a.scaling);
  return (int)cudaGetLastError();
}

template <class Sh, int STAGE>
int float_warps_as(const Args& a, int* warps) {
  const size_t smem = float_smem<Sh, STAGE>(a);
  int blocks = 0;
  if (const int e = set_smem((const void*)float_kernel<Sh, STAGE>, smem)) return e;
  const int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, float_kernel<Sh, STAGE>, 32 * kFloatWarps<STAGE>, smem);
  *warps = blocks * kFloatWarps<STAGE>;
  return e;
}

// atoms per DAG block: as many (up to 32) as keep two blocks per SM; the
// block's dynamic shared memory (m and dm, and the DAG sections of the table
// when they fit beside them)
template <int MODE, class R = float>
void dag_config(const Args& a, int* W, size_t* smem, bool* staged) {
  constexpr size_t kBudget = 113 * 1024;
  const int extra = MODE == kCand ? bm_stride(a.n_scal) : 0;
  *W = 32;
  while (*W > 1 && (size_t)dag_floats(a.M, *W, extra) * sizeof(R) > kBudget) *W >>= 1;
  *smem = (size_t)dag_floats(a.M, *W, extra) * sizeof(R);
  *staged = *smem + (size_t)a.n_dag * sizeof(int) <= kBudget;
  if (*staged) *smem += (size_t)a.n_dag * sizeof(int);
}

// K5's specialised stages: dynamic shared memory of a cand_kernel block
template <int STAGE>
size_t cand_smem(const Args& a) {
  return sizeof(float) * cand_head(a.S, a.MU, a.RB) +
         sizeof(double) * cand_doubles(STAGE, a.S, a.MU, a.RB);
}

template <class Sh, int STAGE>
int launch_cand_as(const Args& a, const double* gamma,
                   std::conditional_t<STAGE == kStageBasic, double, float>* out, double* rad) {
  const size_t smem = cand_smem<STAGE>(a);
  if (const int e = set_smem((const void*)cand_kernel<Sh, STAGE>, smem)) return e;
  const unsigned blocks = (unsigned)((a.n + 31) / 32);
  cand_kernel<Sh, STAGE><<<blocks, 32 * kSubs<STAGE>, smem, a.stream>>>(
      a.dispT, a.mask, a.itypes, a.jtypes_t, a.radial, a.tab, gamma, out, rad, a.n, a.j, a.S,
      a.RB, a.lo, a.hi, a.scaling);
  return (int)cudaGetLastError();
}

template <class Sh, int STAGE>
int cand_warps_as(const Args& a, int* warps) {
  const size_t smem = cand_smem<STAGE>(a);
  int blocks = 0;
  if (const int e = set_smem((const void*)cand_kernel<Sh, STAGE>, smem)) return e;
  const int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, cand_kernel<Sh, STAGE>, 32 * kSubs<STAGE>, smem);
  *warps = blocks * kSubs<STAGE>;
  return e;
}

template <class Sh, int STAGE, class R = float>
int launch_pair_as(const Args& a, const R* gamma,
                   std::conditional_t<STAGE == kStageBasic, R, float>* out, R* rad) {
  if (a.n == 0) return 0;
  int bd;
  size_t smem;
  pair_config<Sh, STAGE, R>(a, &bd, &smem);
  if (const int e = set_smem((const void*)pair_kernel<Sh, STAGE, R>, smem)) return e;
  const unsigned blocks = (unsigned)((a.n + bd - 1) / bd);
  pair_kernel<Sh, STAGE, R><<<blocks, bd, smem, a.stream>>>(
      a.dispT, a.mask, a.itypes, a.jtypes_t, a.radial, a.tab, gamma, out, rad, a.n, a.j, a.S,
      a.MU, a.RB, a.R, a.B, (R)a.lo, (R)a.hi, (R)a.scaling);
  return (int)cudaGetLastError();
}

// resident warps per SM of a pair stage (cudaOccupancy...), into *warps
template <class Sh, int STAGE, class R = float>
int pair_warps_as(const Args& a, int* warps) {
  int bd, blocks = 0;
  size_t smem;
  pair_config<Sh, STAGE, R>(a, &bd, &smem);
  if (const int e = set_smem((const void*)pair_kernel<Sh, STAGE, R>, smem)) return e;
  const int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pair_kernel<Sh, STAGE, R>, bd, smem);
  *warps = blocks * bd / 32;
  return e;
}

// a float pair stage: float_kernel for a specialised shape, else General
template <int STAGE>
int launch_pair(const Args& a, const float* gamma, float* out) {
  if (a.n == 0) return 0;
  switch (a.shape) {
#define MTP_CASE(id, ...) \
  case id:                \
    return launch_float_as<Shells<__VA_ARGS__>, STAGE>(a, gamma, out);
    MTP_SHAPES(MTP_CASE)
#undef MTP_CASE
    default:
      return launch_pair_as<General, STAGE, float>(a, gamma, out, nullptr);
  }
}

template <int STAGE>
int pair_warps(const Args& a, int* warps) {
  switch (a.shape) {
#define MTP_CASE(id, ...) \
  case id:                \
    return float_warps_as<Shells<__VA_ARGS__>, STAGE>(a, warps);
    MTP_SHAPES(MTP_CASE)
#undef MTP_CASE
    default:
      return pair_warps_as<General, STAGE>(a, warps);
  }
}

// K5's pair stage STAGE in double: its specialised instantiation when the
// schedule has a specialised shape and RB <= kCandRB, else General
__host__ inline int k5_shape(const Args& a) { return a.RB <= kCandRB ? a.shape : 0; }

template <int STAGE>
int launch_k5_pair(const Args& a, const double* gamma,
                   std::conditional_t<STAGE == kStageBasic, double, float>* out, double* rad) {
  if (a.n == 0) return 0;
  switch (k5_shape(a)) {
#define MTP_CASE(id, ...) \
  case id:                \
    return launch_cand_as<Shells<__VA_ARGS__>, STAGE>(a, gamma, out, rad);
    MTP_SHAPES(MTP_CASE)
#undef MTP_CASE
    default:
      return launch_pair_as<General, STAGE, double>(a, gamma, out, rad);
  }
}

template <int STAGE>
int k5_pair_warps(const Args& a, int* warps) {
  switch (k5_shape(a)) {
#define MTP_CASE(id, ...) \
  case id:                \
    return cand_warps_as<Shells<__VA_ARGS__>, STAGE>(a, warps);
    MTP_SHAPES(MTP_CASE)
#undef MTP_CASE
    default:
      return pair_warps_as<General, STAGE, double>(a, warps);
  }
}

// the DAG keeps two blocks of m and dm per SM: ask for the largest carveout
template <int MODE, bool kStaged, class R = float>
int dag_smem(size_t smem) {
  const void* k = (const void*)dag_kernel<MODE, kStaged, R>;
  if (const int e = set_smem(k, smem)) return e;
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
}

// mbg: the (B, N) basic moments in, gamma out (K2, K5); bm: K5's basis
// members (N, n_scal)
template <int MODE, class R = float>
int launch_dag(const Args& a, R* mbg, float* site, R* bm = nullptr) {
  if (a.n == 0) return 0;
  int W;
  size_t smem;
  bool staged;
  dag_config<MODE, R>(a, &W, &smem, &staged);
  const unsigned blocks = (unsigned)((a.n + W - 1) / W);
  if (staged) {
    if (const int e = dag_smem<MODE, true, R>(smem)) return e;
    dag_kernel<MODE, true, R><<<blocks, kDagThreads, smem, a.stream>>>(
        mbg, a.xi, a.per_atom, a.tab, a.mapping, site, bm, a.n, a.B, a.M, a.n_waves,
        a.n_scal, W, a.n_dag);
  } else {
    if (const int e = dag_smem<MODE, false, R>(smem)) return e;
    dag_kernel<MODE, false, R><<<blocks, kDagThreads, smem, a.stream>>>(
        mbg, a.xi, a.per_atom, a.tab, a.mapping, site, bm, a.n, a.B, a.M, a.n_waves,
        a.n_scal, W, a.n_dag);
  }
  return (int)cudaGetLastError();
}

Args args(const void* dispT, const void* mask, const void* itypes, const void* jtypes_t,
          const void* radial, const void* xi, const void* per_atom, const void* tab, void* out,
          void* scratch, int n, int j, int S, int MU, int RB, int R, int B, int M, int n_waves,
          int n_dag, int shape, float lo, float hi, float scaling, void* stream) {
  Args a = {};
  a.dispT = (const float*)dispT;
  a.mask = (const float*)mask;
  a.itypes = (const int*)itypes;
  a.jtypes_t = (const int*)jtypes_t;
  a.radial = (const float*)radial;
  a.xi = (const float*)xi;
  a.per_atom = (const float*)per_atom;
  a.tab = (const int*)tab;
  a.out = (float*)out;
  a.scratch = (float*)scratch;
  a.n = n;
  a.j = j;
  a.S = S;
  a.MU = MU;
  a.RB = RB;
  a.R = R;
  a.B = B;
  a.M = M;
  a.n_waves = n_waves;
  a.n_dag = n_dag;
  a.shape = shape;
  a.lo = lo;
  a.hi = hi;
  a.scaling = scaling;
  a.stream = (cudaStream_t)stream;
  return a;
}

// resident warps per SM of a DAG stage, its atoms per block and 1 if its
// table is staged in shared memory, into out[0..2]
template <int MODE, class R>
int dag_warps(const Args& a, int* out) {
  int W, blocks = 0;
  size_t smem;
  bool staged;
  dag_config<MODE, R>(a, &W, &smem, &staged);
  const void* k = staged ? (const void*)dag_kernel<MODE, true, R>
                         : (const void*)dag_kernel<MODE, false, R>;
  if (const int e = staged ? dag_smem<MODE, true, R>(smem) : dag_smem<MODE, false, R>(smem))
    return e;
  const int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kDagThreads, smem);
  out[0] = blocks * kDagThreads / 32;
  out[1] = W;
  out[2] = staged;
  return e;
}

}  // namespace

// The K4, K2, K6 and K7 entry points share one argument list; per_atom is
// esp (K4), de or NULL for 1 (K2), unused (K6), gamma (B, N) (K7); scratch
// is a (B, N) fp32 buffer (K4, K2; unused by K6, K7); n_dag is the length of
// the table from its fwd_wave section, rounded down to an even offset, to
// its end; shape is the specialised shape id of the schedule, 0 for General.
#define MTP_ARGS                                                                     \
  const void *dispT, const void *mask, const void *itypes, const void *jtypes_t,    \
      const void *radial, const void *xi, const void *per_atom, const void *tab,    \
      void *out, void *scratch, int n, int j, int S, int MU, int RB, int R, int B,  \
      int M, int n_waves, int n_dag, int shape, float lo, float hi, float scaling,  \
      void *stream
#define MTP_PARAMS                                                                    \
  args(dispT, mask, itypes, jtypes_t, radial, xi, per_atom, tab, out, scratch, n, j, S, \
       MU, RB, R, B, M, n_waves, n_dag, shape, lo, hi, scaling, stream)

// Resident warps per SM of each stage kernel for this schedule and J slots
// per atom (the float tail's pair list grows with J): warps[0]
// basic, [1] tail, [2] DAG (K2), [3] the DAG's atoms per block, [4] 1 if its
// table is staged in shared memory; K5's in double: [5] basic, [6] tail with
// the radial rows, [7] DAG, [8] its atoms per block, [9] its table staged,
// [10] 1 if K5 runs its specialised stages, 0 for General; [11] 1 if the
// float basic and tail stages are float_kernel's (a specialised shape), 0
// for General.
extern "C" int mtp_fused_occupancy(int S, int MU, int RB, int R, int B, int M, int n_dag,
                                   int n_scal, int shape, int j, int* warps) {
  Args a = {};
  a.j = j;
  a.S = S;
  a.MU = MU;
  a.RB = RB;
  a.R = R;
  a.B = B;
  a.M = M;
  a.n_dag = n_dag;
  a.n_scal = n_scal;
  a.shape = shape;
  if (const int e = pair_warps<kStageBasic>(a, warps)) return e;
  if (const int e = pair_warps<kStageTail>(a, warps + 1)) return e;
  if (const int e = dag_warps<kForces, float>(a, warps + 2)) return e;
  if (const int e = k5_pair_warps<kStageBasic>(a, warps + 5)) return e;
  if (const int e = k5_pair_warps<kStageTailCand>(a, warps + 6)) return e;
  if (const int e = dag_warps<kCand, double>(a, warps + 7)) return e;
  warps[10] = k5_shape(a) != 0;
  warps[11] = a.shape != 0;
  return 0;
}

// K4: site energies (N,) = esp + xi . m
extern "C" int mtp_site_energies_mega(MTP_ARGS) {
  const Args a = MTP_PARAMS;
  if (const int e = launch_pair<kStageBasic>(a, nullptr, a.scratch)) return e;
  return launch_dag<kSite>(a, a.scratch, a.out);
}

// K2: pair forces (3, J, N) = de_i * d(site_e_i)/d(dispT); de == NULL means 1
extern "C" int mtp_pair_forces_mega(MTP_ARGS) {
  const Args a = MTP_PARAMS;
  if (const int e = launch_pair<kStageBasic>(a, nullptr, a.scratch)) return e;
  if (const int e = launch_dag<kForces>(a, a.scratch, nullptr)) return e;
  return launch_pair<kStageTail>(a, a.scratch, a.out);
}

// K6: basic moments (B, N)
extern "C" int mtp_basic_moments_fused(MTP_ARGS) {
  const Args a = MTP_PARAMS;
  return launch_pair<kStageBasic>(a, nullptr, a.out);
}

// K7: pair forces (3, J, N) = gamma . d(basic moments)/d(dispT), gamma (B, N)
extern "C" int mtp_basic_moments_vjp(MTP_ARGS) {
  const Args a = MTP_PARAMS;
  return launch_pair<kStageTail>(a, a.per_atom, a.out);
}

// K5: site energies (N,) and pair forces (3, J, N) as floats, basis
// members (N, n_scal) and radial rows (N, S*MU*RB) as doubles, of one grade
// step. Every stage runs in double from the float displacements,
// coefficients and readout: the grades multiply the candidate vector by the
// inverse active set, whose conditioning turns the float path's rounding
// into grade errors near 1e-2 of the largest grade. The pair stages are the
// specialised cand_kernel instantiations for a specialised shape with RB <=
// kCandRB, else the General pair_kernel ones; the DAG is dag_kernel<kCand>.
// scratch is a (B, N) double buffer; shape as for the other entry points.
extern "C" int mtp_candidates_mega(const void* dispT, const void* mask, const void* itypes,
                                   const void* jtypes_t, const void* radial, const void* xi,
                                   const void* esp, const void* tab, const void* mapping,
                                   void* site, void* bm, void* rad, void* pair, void* scratch,
                                   int n, int j, int S, int MU, int RB, int R, int B, int M,
                                   int n_waves, int n_dag, int n_scal, int shape, double lo,
                                   double hi, double scaling, void* stream) {
  Args a = args(dispT, mask, itypes, jtypes_t, radial, xi, esp, tab, pair, nullptr, n, j, S,
                MU, RB, R, B, M, n_waves, n_dag, shape, 0.f, 0.f, 0.f, stream);
  a.mapping = (const int*)mapping;
  a.n_scal = n_scal;
  a.lo = lo;
  a.hi = hi;
  a.scaling = scaling;
  double* work = (double*)scratch;
  if (const int e = launch_k5_pair<kStageBasic>(a, nullptr, work, nullptr)) return e;
  if (const int e = launch_dag<kCand, double>(a, work, (float*)site, (double*)bm)) return e;
  return launch_k5_pair<kStageTailCand>(a, work, a.out, (double*)rad);
}
