// Anti-diagonal Gotoh fills for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (sequencealigning_tpu.cuda registers them).
//
// Two kernels, one skeleton: a thread block sweeps one independent DP
// problem (a stream row of pipelined pairs, or one banded pair) one
// anti-diagonal per step.  The diagonal's lanes are spread over the block,
// LPT contiguous lanes per thread, and all state lives in registers.  The
// one-lane shift every Gotoh step needs is a register rename inside a
// thread plus one warp shuffle at the thread edge; a warp edge hands its
// value over in shared memory behind one __syncthreads per step.
//
// Each kernel is bit-exact with its lax.scan twin in the ops module (the
// plain reference): same recurrence, same sentinels, same tie order, same
// packed direction words.  Only integer arithmetic is involved.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -32768;        // config.NEG_INF
constexpr int kNegBig = -(1 << 24); // nw_banded_diag.NEGBIG
// ops/dirbits.py
constexpr int kHM = 1, kHI = 2, kHD = 4, kIEXT = 8, kIOPEN = 16, kDEXT = 32,
              kDOPEN = 64;

// Threads per block each lane count can run without spilling registers
// (7 int32 state arrays of LPT lanes, plus the packed dirs words).
template <int LPT>
struct Block {
  static constexpr int kMaxThreads = LPT == 4 ? 1024 : (LPT == 8 ? 512 : 384);
};

inline int max_threads(int lpt) {
  return lpt == 4 ? Block<4>::kMaxThreads
                  : (lpt == 8 ? Block<8>::kMaxThreads : Block<16>::kMaxThreads);
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    *reinterpret_cast<uint4*>(dst + i) =
        make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  }
}

// ---------------------------------------------------------------------------
// Streamed fill (twin: ops.nw_affine_stream.gotoh_fill_stream_lax)
//
// Block r sweeps stream row r: t_total steps over P = blockDim.x * LPT
// lanes.  Slot k's pair enters at step k * S; at local diagonal p its query
// char enters at lane 0 and its db char at lane p.  The lane shift is
// circular over the row (lane 0 reads lane P - 1), as jnp.roll is.
// ---------------------------------------------------------------------------

template <int LPT, int DIRS, bool WILD>
__global__ void __launch_bounds__(Block<LPT>::kMaxThreads)
    stream_fill_kernel(const uint8_t* __restrict__ q,      // (R, NP, L1)
                       const uint8_t* __restrict__ d,      // (R, NP, L2)
                       const int32_t* __restrict__ dsum,   // (NP, R)
                       const int32_t* __restrict__ n2,     // (NP, R)
                       int32_t* __restrict__ fin,          // (3, NP, R)
                       uint32_t* __restrict__ dirs,        // (T, R, P)
                       int R, int NP, int L1, int L2, int S, int T, int P,
                       int match, int mismatch, int go, int ge, int compat) {
  extern __shared__ uint8_t chars[];  // [2][L1 + L2], slot parity
  __shared__ int3 xb[2][32];
  constexpr int UN = DIRS == 2 ? 4 : 8;  // steps per packed word
  constexpr int SH = DIRS == 2 ? 8 : 4;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int x0 = tid * LPT;
  const int CL = L1 + L2;
  const size_t plane = (size_t)NP * R;

  int H2[LPT], H1[LPT], M1[LPT], I1[LPT], D1[LPT], s1[LPT], s2[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    H2[i] = H1[i] = M1[i] = I1[i] = D1[i] = kNeg;
    s1[i] = s2[i] = 0;
  }
  for (int k = tid; k < NP; k += blockDim.x) {
    fin[k * R + r] = 0;
    fin[plane + k * R + r] = 0;
    fin[2 * plane + k * R + r] = 0;
  }

  int k = -1, p = S;
  int Ty = -1, Ly = -1, To = -1, Lo = -1;
  for (int tg = 0; tg < T; tg += UN) {
    if (p == S) {  // a new slot enters (S is a multiple of UN)
      p = 0;
      ++k;
      if (k < NP) {
        uint8_t* buf = chars + (k & 1) * CL;
        const uint8_t* qs = q + ((size_t)r * NP + k) * L1;
        const uint8_t* ds = d + ((size_t)r * NP + k) * L2;
        for (int j = tid; j < L1; j += blockDim.x) buf[j] = qs[j];
        for (int j = tid; j < L2; j += blockDim.x) buf[L1 + j] = ds[j];
      }
      __syncthreads();
      Ty = k < NP ? k * S + dsum[k * R + r] : -1;
      Ly = k < NP ? n2[k * R + r] : -1;
      To = (k >= 1 && k - 1 < NP) ? (k - 1) * S + dsum[(k - 1) * R + r] : -1;
      Lo = (k >= 1 && k - 1 < NP) ? n2[(k - 1) * R + r] : -1;
    }
    const uint8_t* cq = chars + (k & 1) * CL;
    const bool live = k < NP;
    uint32_t acc[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) acc[i] = 0u;

#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int t = tg + u;
      const int pp = p + u;
      int qc = 0, dc = 0;
      if (live && pp >= 1) {
        if (pp <= L1) qc = cq[pp - 1];
        if (pp <= L2) dc = cq[L1 + pp - 1];
      }
      // What lane x0 needs from lane x0 - 1: H two steps back, the D
      // source max(M + o, D) and the query char (+ the D parent bits).
      const int tl = M1[LPT - 1] + go;
      const int oh = H2[LPT - 1];
      const int od = max(tl, D1[LPT - 1]);
      int oc = s1[LPT - 1];
      if (DIRS == 1) oc |= (D1[LPT - 1] >= tl ? 1 : 0) << 8;
      if (DIRS == 2)
        oc |= ((D1[LPT - 1] >= tl ? kDEXT : 0) | (tl >= D1[LPT - 1] ? kDOPEN : 0))
              << 8;
      const int src = (lane + 31) & 31;
      int ih = __shfl_sync(kFull, oh, src);
      int id = __shfl_sync(kFull, od, src);
      int ic = __shfl_sync(kFull, oc, src);
      if (nw > 1) {
        if (lane == 31) xb[t & 1][warp] = make_int3(oh, od, oc);
        __syncthreads();
        if (lane == 0) {
          const int3 v = xb[t & 1][warp == 0 ? nw - 1 : warp - 1];
          ih = v.x;
          id = v.y;
          ic = v.z;
        }
      }
      // Boundary cells of the younger pair (nw_affine._boundary_scalars).
      const bool origin = pp == 0;
      const int mb = origin ? 0 : kNeg;
      int rI, rD, cI, cD;
      if (compat) {
        const int ch = go + (pp + 1) * ge;
        rI = kNeg;
        rD = origin ? kNeg : ch;
        cI = origin ? kNeg : ch;
        cD = kNeg;
      } else {
        const int ch = go + pp * ge;
        rI = origin ? kNeg : ch;
        rD = kNeg;
        cI = kNeg;
        cD = origin ? kNeg : ch;
      }
      // Descending lanes: lane i - 1 still holds the previous step.
#pragma unroll
      for (int i = LPT - 1; i >= 0; --i) {
        const int x = x0 + i;
        int pH, pD, pS, pB;
        if (i == 0) {
          pH = ih;
          pD = id;
          pS = ic & 0xff;
          pB = ic >> 8;
        } else {
          const int tp = M1[i - 1] + go;
          pH = H2[i - 1];
          pD = max(tp, D1[i - 1]);
          pS = s1[i - 1];
          pB = DIRS == 1   ? (D1[i - 1] >= tp ? 1 : 0)
               : DIRS == 2 ? ((D1[i - 1] >= tp ? kDEXT : 0) |
                              (tp >= D1[i - 1] ? kDOPEN : 0))
                           : 0;
        }
        const int s1n = x == 0 ? qc : pS;
        const int s2n = x == pp ? dc : s2[i];
        const bool eq = WILD ? ((s1n & s2n) != 0) : (s1n == s2n);
        const int t0 = M1[i] + go;
        int M = pH + (eq ? match : mismatch);
        const bool ci = I1[i] >= t0;
        int I = (ci ? I1[i] : t0) + ge;
        int D = pD + ge;
        if (x == pp) {
          M = mb;
          I = cI;
          D = cD;
        }
        if (x == 0) {
          M = mb;
          I = rI;
          D = rD;
        }
        const int H = max(M, max(I, D));
        if (DIRS == 2) {
          const int b = (M == H ? kHM : 0) | (I == H ? kHI : 0) |
                        (D == H ? kHD : 0) | (ci ? kIEXT : 0) |
                        (t0 >= I1[i] ? kIOPEN : 0) | pB;
          acc[i] |= (uint32_t)b << (SH * u);
        } else if (DIRS == 1) {
          const int c = (M == H ? 0 : (I == H ? 1 : 2)) | (ci ? 4 : 0) |
                        (pB << 3);
          acc[i] |= (uint32_t)c << (SH * u);
        }
        H2[i] = H1[i];
        H1[i] = H;
        M1[i] = M;
        I1[i] = I;
        D1[i] = D;
        s1[i] = s1n;
        s2[i] = s2n;
      }
      // Corner capture: slot k at step k * S + n1 + n2, lane n2.
      if (t == Ty) {
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          if (x0 + i == Ly) {
            fin[k * R + r] = M1[i];
            fin[plane + k * R + r] = I1[i];
            fin[2 * plane + k * R + r] = D1[i];
          }
        }
      }
      if (t == To) {
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          if (x0 + i == Lo) {
            fin[(k - 1) * R + r] = M1[i];
            fin[plane + (k - 1) * R + r] = I1[i];
            fin[2 * plane + (k - 1) * R + r] = D1[i];
          }
        }
      }
    }
    if (DIRS) store_words<LPT>(dirs + ((size_t)(tg / UN) * R + r) * P + x0, acc);
    p += UN;
  }
}

// ---------------------------------------------------------------------------
// Banded anti-diagonal fill (twin: ops.nw_banded_diag._banded_diag_lax)
//
// Block b sweeps pair b, parity-packed: lane l of wavefront a holds
// diagonal k_lo_even + 2l + (a & 1).  Odd wavefronts read lane l + 1,
// even ones lane l - 1; band edges are masked, so lanes past L (a thread
// count rounded up to whole warps) are never read by a live lane.
// ---------------------------------------------------------------------------

template <int LPT, int DIRS, bool WILD>
__global__ void __launch_bounds__(Block<LPT>::kMaxThreads)
    banded_fill_kernel(const int8_t* __restrict__ seq1,  // (B, Lq)
                       const int8_t* __restrict__ seq2,  // (B, Ld)
                       const int32_t* __restrict__ n1v,  // (B,)
                       const int32_t* __restrict__ n2v,  // (B,)
                       int32_t* __restrict__ fin,        // (B, 3)
                       uint32_t* __restrict__ dirs,      // (Aw, B, L)
                       int B, int Lq, int Ld, int L, int n_iters,
                       int k_lo_even, int k_hi_eff, int Aw, int match,
                       int mismatch, int go, int ge, int compat, int stdm) {
  __shared__ int3 xb[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int x0 = tid * LPT;
  const int he = k_lo_even / 2;  // k_lo_even is even and <= 0
  const int8_t* s1p = seq1 + (size_t)b * Lq;
  const int8_t* s2p = seq2 + (size_t)b * Ld;
  const int n1 = n1v[b], n2 = n2v[b];
  const int cap_a = n1 + n2;
  const int lim1 = (k_hi_eff - k_lo_even - 1) / 2;
  const int lim0 = (k_hi_eff - k_lo_even) / 2;
  const int a_end = 2 * n_iters;

  int M1[LPT], I1[LPT], D1[LPT], H1[LPT], H2[LPT], sw1[LPT], sw2[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int l = x0 + i;
    const int i1 = l + he - 1;
    const int i2 = -he - l - 1;
    sw1[i] = (i1 >= 0 && i1 < Lq) ? s1p[i1] : -1;
    sw2[i] = (i2 >= 0 && i2 < Ld) ? s2p[i2] : -1;
    const int m0 = l == -he ? 0 : kNegBig;
    M1[i] = m0;
    H1[i] = m0;
    I1[i] = D1[i] = H2[i] = kNegBig;
  }
  if (tid == 0) fin[b * 3] = fin[b * 3 + 1] = fin[b * 3 + 2] = 0;

  // Entering chars: c1 = seq1[i + he + L - 1] (odd wavefront 2i + 1),
  // c2 = seq2[i - he] (even wavefront 2i + 2); -1 outside the sequence.
  auto c1_at = [&](int i) {
    const int j = i + he + L - 1;
    return (j >= 0 && j < Lq) ? (int)s1p[j] : -1;
  };
  auto c2_at = [&](int i) {
    const int j = i - he;
    return j < Ld ? (int)s2p[j] : -1;
  };
  int nc1[4], nc2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    nc1[j] = c1_at(j);
    nc2[j] = c2_at(j);
  }

  for (int g = 0; 8 * g < a_end; ++g) {
    int c1s[4], c2s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c1s[j] = nc1[j];
      c2s[j] = nc2[j];
      nc1[j] = c1_at(4 * g + 4 + j);
      nc2[j] = c2_at(4 * g + 4 + j);
    }
    uint32_t w0[LPT], w1[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) w0[i] = w1[i] = 0u;

#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int a = 8 * g + u + 1;
      const int par = (u & 1) ? 0 : 1;  // a = 8g + u + 1
      const int qd = (a - par) / 2 - he;
      const int lim = par ? lim1 : lim0;
      // Neighbour values: odd steps read lane l + 1, even steps lane l - 1.
      int es, ei, em;  // outgoing: char window, gap source, M-open source
      if (par) {
        es = sw1[0];
        ei = D1[0];
        em = (stdm ? H1[0] : M1[0]) + go;
      } else {
        es = sw2[LPT - 1];
        ei = I1[LPT - 1];
        em = (stdm ? H1[LPT - 1] : M1[LPT - 1]) + go;
      }
      const int src = par ? ((lane + 1) & 31) : ((lane + 31) & 31);
      int ns = __shfl_sync(kFull, es, src);
      int ni = __shfl_sync(kFull, ei, src);
      int nm = __shfl_sync(kFull, em, src);
      if (nw > 1) {
        const bool writer = par ? lane == 0 : lane == 31;
        if (writer) xb[a & 1][warp] = make_int3(es, ei, em);
        __syncthreads();
        if (par && lane == 31 && warp + 1 < nw) {
          const int3 v = xb[a & 1][warp + 1];
          ns = v.x;
          ni = v.y;
          nm = v.z;
        } else if (!par && lane == 0 && warp > 0) {
          const int3 v = xb[a & 1][warp - 1];
          ns = v.x;
          ni = v.y;
          nm = v.z;
        }
      }
      const int cin = par ? c1s[u >> 1] : c2s[u >> 1];
      const bool emit = a <= a_end;

#pragma unroll
      for (int jj = 0; jj < LPT; ++jj) {
        // Odd steps ascend (lane i + 1 still old), even steps descend.
        const int i = par ? jj : LPT - 1 - jj;
        const int l = x0 + i;
        const int xv = qd - l;
        const int yv = a - xv;
        const int m1o = (stdm ? H1[i] : M1[i]) + go;
        int s1c = sw1[i], s2c = sw2[i];
        int I_src, D_src, Mi, Md;
        if (par) {
          s1c = l == L - 1 ? cin : (i == LPT - 1 ? ns : sw1[i + 1]);
          const int dn = i == LPT - 1 ? ni : D1[i + 1];
          const int mn =
              i == LPT - 1 ? nm : (stdm ? H1[i + 1] : M1[i + 1]) + go;
          I_src = I1[i];
          Mi = m1o;
          D_src = l == L - 1 ? kNegBig : dn;
          Md = l == L - 1 ? kNegBig : mn;
        } else {
          s2c = l == 0 ? cin : (i == 0 ? ns : sw2[i - 1]);
          const int in_ = i == 0 ? ni : I1[i - 1];
          const int mp = i == 0 ? nm : (stdm ? H1[i - 1] : M1[i - 1]) + go;
          I_src = l == 0 ? kNegBig : in_;
          Mi = l == 0 ? kNegBig : mp;
          D_src = D1[i];
          Md = m1o;
        }
        const bool eq = WILD ? ((s1c & s2c) != 0) : (s1c == s2c);
        int M = H2[i] + (eq ? match : mismatch);
        int I = max(Mi, I_src) + ge;
        int D = max(Md, D_src) + ge;
        const bool valid = xv >= 1 && xv <= n2 && l <= lim && yv >= 1 &&
                           yv <= n1;
        if (!valid) M = I = D = kNegBig;
        const bool row0 = xv == 0 && yv >= 0 && yv <= n1;
        const bool col0 = yv == 0 && xv >= 1 && xv <= n2;
        if (row0) {
          const bool origin = yv == 0;
          M = origin ? 0 : kNeg;
          I = origin ? kNeg : (compat ? kNeg : go + yv * ge);
          D = origin ? kNeg : (compat ? go + (yv + 1) * ge : kNeg);
        }
        if (col0) {
          M = kNeg;
          I = compat ? go + (xv + 1) * ge : kNeg;
          D = compat ? kNeg : go + xv * ge;
        }
        const int H = max(M, max(I, D));
        if (DIRS && emit) {
          int c;
          if (DIRS == 1) {
            c = (M == H ? 0 : (I == H ? 1 : 2)) | (I == I_src + ge ? 4 : 0) |
                (D == D_src + ge ? 8 : 0);
            w0[i] |= (uint32_t)c << (4 * u);
          } else {
            c = (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
                (I == I_src + ge ? kIEXT : 0) | (I == Mi + ge ? kIOPEN : 0) |
                (D == D_src + ge ? kDEXT : 0) | (D == Md + ge ? kDOPEN : 0);
            if (u < 4)
              w0[i] |= (uint32_t)c << (8 * u);
            else
              w1[i] |= (uint32_t)c << (8 * (u - 4));
          }
        }
        H2[i] = H1[i];
        H1[i] = H;
        M1[i] = M;
        I1[i] = I;
        D1[i] = D;
        sw1[i] = s1c;
        sw2[i] = s2c;
      }
      if (a == cap_a) {
        const int lc = qd - n2;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          if (x0 + i == lc && lc < L) {
            fin[b * 3] = M1[i];
            fin[b * 3 + 1] = I1[i];
            fin[b * 3 + 2] = D1[i];
          }
        }
      }
    }
    if (DIRS && x0 < L) {
      if (DIRS == 1) {
        if (g < Aw) store_words<LPT>(dirs + ((size_t)g * B + b) * L + x0, w0);
      } else {
        if (2 * g < Aw)
          store_words<LPT>(dirs + ((size_t)(2 * g) * B + b) * L + x0, w0);
        if (2 * g + 1 < Aw)
          store_words<LPT>(dirs + ((size_t)(2 * g + 1) * B + b) * L + x0, w1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Dispatch over the compile-time variants
// ---------------------------------------------------------------------------

template <int LPT, int DIRS, bool WILD>
void launch_stream(cudaStream_t st, int R, int threads, size_t smem,
                   const uint8_t* q, const uint8_t* d, const int32_t* dsum,
                   const int32_t* n2, int32_t* fin, uint32_t* dirs, int NP,
                   int L1, int L2, int S, int T, int P, int match, int mis,
                   int go, int ge, int compat) {
  // 16 lanes a thread spill registers here; StreamFillImpl rejects it.
  if constexpr (LPT != 16) {
    stream_fill_kernel<LPT, DIRS, WILD><<<R, threads, smem, st>>>(
        q, d, dsum, n2, fin, dirs, R, NP, L1, L2, S, T, P, match, mis, go,
        ge, compat);
  }
}

template <int LPT, int DIRS, bool WILD>
void launch_banded(cudaStream_t st, int B, int threads, const int8_t* s1,
                   const int8_t* s2, const int32_t* n1v, const int32_t* n2v,
                   int32_t* fin, uint32_t* dirs, int Lq, int Ld, int L,
                   int n_iters, int klo, int khi, int Aw, int match, int mis,
                   int go, int ge, int compat, int stdm) {
  banded_fill_kernel<LPT, DIRS, WILD><<<B, threads, 0, st>>>(
      s1, s2, n1v, n2v, fin, dirs, B, Lq, Ld, L, n_iters, klo, khi, Aw, match,
      mis, go, ge, compat, stdm);
}

#define SEQALIGN_DISPATCH(FN, LPT_, DIRS_, WILD_, ...)                      \
  do {                                                                     \
    bool ok_ = true;                                                       \
    auto pick_ = [&](auto lpt_c, auto dirs_c) {                            \
      constexpr int l_ = decltype(lpt_c)::value;                           \
      constexpr int d_ = decltype(dirs_c)::value;                          \
      if (WILD_)                                                           \
        FN<l_, d_, true>(__VA_ARGS__);                                     \
      else                                                                 \
        FN<l_, d_, false>(__VA_ARGS__);                                    \
    };                                                                     \
    auto by_dirs_ = [&](auto lpt_c) {                                      \
      if (DIRS_ == 0)                                                      \
        pick_(lpt_c, std::integral_constant<int, 0>{});                    \
      else if (DIRS_ == 1)                                                 \
        pick_(lpt_c, std::integral_constant<int, 1>{});                    \
      else if (DIRS_ == 2)                                                 \
        pick_(lpt_c, std::integral_constant<int, 2>{});                    \
      else                                                                 \
        ok_ = false;                                                       \
    };                                                                     \
    if (LPT_ == 4)                                                         \
      by_dirs_(std::integral_constant<int, 4>{});                          \
    else if (LPT_ == 8)                                                    \
      by_dirs_(std::integral_constant<int, 8>{});                          \
    else if (LPT_ == 16)                                                   \
      by_dirs_(std::integral_constant<int, 16>{});                         \
    else                                                                   \
      ok_ = false;                                                         \
    if (!ok_) return ffi::Error::InvalidArgument("bad lanes/dirs variant"); \
  } while (0)

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error StreamFillImpl(cudaStream_t st, ffi::Buffer<ffi::U8> q,
                          ffi::Buffer<ffi::U8> d, ffi::Buffer<ffi::S32> dsum,
                          ffi::Buffer<ffi::S32> n2,
                          ffi::ResultBuffer<ffi::S32> fin,
                          ffi::ResultBuffer<ffi::U32> dirs, int32_t s,
                          int32_t t_total, int32_t p, int32_t dirs_mode,
                          int32_t compat, int32_t wildcard, int32_t lpt,
                          int32_t match, int32_t mismatch, int32_t gap_open,
                          int32_t gap_extend) {
  const auto dq = q.dimensions();
  const auto dd = d.dimensions();
  if (dq.size() != 3 || dd.size() != 3)
    return ffi::Error::InvalidArgument("q/d must be (R, NP, L)");
  const int R = (int)dq[0], NP = (int)dq[1], L1 = (int)dq[2];
  const int L2 = (int)dd[2];
  if ((lpt != 4 && lpt != 8) || p % lpt || (p / lpt) % 32 ||
      p / lpt > max_threads(lpt))
    return ffi::Error::InvalidArgument("lane width does not fit the block");
  const int threads = p / lpt;
  const size_t smem = 2 * (size_t)(L1 + L2);
  SEQALIGN_DISPATCH(launch_stream, lpt, dirs_mode, wildcard, st, R, threads,
                    smem, q.typed_data(), d.typed_data(), dsum.typed_data(),
                    n2.typed_data(), fin->typed_data(), dirs->typed_data(), NP,
                    L1, L2, s, t_total, p, match, mismatch, gap_open,
                    gap_extend, compat);
  return launch_status();
}

ffi::Error BandedFillImpl(cudaStream_t st, ffi::Buffer<ffi::S8> seq1,
                          ffi::Buffer<ffi::S8> seq2, ffi::Buffer<ffi::S32> n1v,
                          ffi::Buffer<ffi::S32> n2v,
                          ffi::ResultBuffer<ffi::S32> fin,
                          ffi::ResultBuffer<ffi::U32> dirs, int32_t lanes,
                          int32_t n_iters, int32_t k_lo_even, int32_t k_hi_eff,
                          int32_t aw, int32_t dirs_mode, int32_t compat,
                          int32_t wildcard, int32_t std_model, int32_t lpt,
                          int32_t match, int32_t mismatch, int32_t gap_open,
                          int32_t gap_extend) {
  const auto d1 = seq1.dimensions();
  const auto d2 = seq2.dimensions();
  if (d1.size() != 2 || d2.size() != 2)
    return ffi::Error::InvalidArgument("seq1/seq2 must be (B, L)");
  const int B = (int)d1[0], Lq = (int)d1[1], Ld = (int)d2[1];
  if (lpt <= 0 || lanes % lpt) return ffi::Error::InvalidArgument("bad lpt");
  const int threads = ((lanes / lpt + 31) / 32) * 32;
  if (threads > max_threads(lpt))
    return ffi::Error::InvalidArgument("band lanes do not fit the block");
  SEQALIGN_DISPATCH(launch_banded, lpt, dirs_mode, wildcard, st, B, threads,
                    seq1.typed_data(), seq2.typed_data(), n1v.typed_data(),
                    n2v.typed_data(), fin->typed_data(), dirs->typed_data(),
                    Lq, Ld, lanes, n_iters, k_lo_even, k_hi_eff, aw, match,
                    mismatch, gap_open, gap_extend, compat, std_model);
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SeqalignStreamFill, StreamFillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("s")
                                  .Attr<int32_t>("t_total")
                                  .Attr<int32_t>("p")
                                  .Attr<int32_t>("dirs_mode")
                                  .Attr<int32_t>("compat")
                                  .Attr<int32_t>("wildcard")
                                  .Attr<int32_t>("lpt")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(SeqalignBandedFill, BandedFillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("lanes")
                                  .Attr<int32_t>("n_iters")
                                  .Attr<int32_t>("k_lo_even")
                                  .Attr<int32_t>("k_hi_eff")
                                  .Attr<int32_t>("aw")
                                  .Attr<int32_t>("dirs_mode")
                                  .Attr<int32_t>("compat")
                                  .Attr<int32_t>("wildcard")
                                  .Attr<int32_t>("std_model")
                                  .Attr<int32_t>("lpt")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));
