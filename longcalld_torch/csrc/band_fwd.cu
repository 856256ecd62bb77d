// Forward banded gap-affine-2p DP for Hopper (sm_90a).
//
// Replaces the Pallas kernel longcalld_tpu/ops/pallas_band.py:_dp_rows_kernel
// (entered through banded_dp_pallas, pallas_band.py:285-341) with the same
// contract, bit for bit, at every band width the Pallas kernel takes
// (B = 128 k, 128 <= B <= 4096):
//   in : P (batch, Lp) int8 padded with 4; Tband (batch, Lp+B) int8,
//        pre-shifted so Tband[k, c] = T[k, c + dlo_k], sentinel 127;
//        plen, tlen, dlo (batch,) int32
//   out: tbs (Lp+1, batch, B) uint8 = src | i1_ext<<3 | i2_ext<<4 |
//        d1_ext<<5 | d2_ext<<6; finals (batch, 5) int32 in PERM order
//        [I1, I2, D1, D2, M]; edge_min (batch,) int32.
//
// Per row i, for each band column b: M takes the same column of row i-1
// (first minimum in PERM order), D takes column b+1 of row i-1, I is an
// exclusive prefix-min of nM - b*e along the row, and the adjacency term
// takes nM at b-1.  All values saturate at BIG.
//
// What bounds it on the card: integer issue.  The column body below does
// 36 int32 operations per DP cell (compares, mins, selects, Hopper's
// fused add-and-min counted once; PERF.md lists them), which the compiler
// turns into about 54 ALU-pipe instructions at C = 8; the card issues 64
// int32 lanes per SM per clock, and the traceback stream (one byte per
// cell) is far below HBM bandwidth at that rate.  The row loop is a
// serial chain, so the design keeps it free of block-wide barriers.
//
// Two designs:
//
// band_fwd_warp (B <= 512, the main path's widths).  A pair is owned by
// WPP warps (a "pair group"), each lane holding C = B / (32 WPP) columns
// in registers.  The b+1 neighbour and nM at b-1 come by warp shuffles;
// the I prefix-min is serial over a lane's C columns, then a 5-step
// shuffle scan.  With WPP = 1 the row loop has no barrier and no shared
// memory at all; with WPP > 1 the warp seams exchange through a
// double-buffered shared array under one named barrier per row that only
// the pair's own warps join (bar.sync id, 32 WPP).  Several pair groups
// share a CTA (PPC pairs), each on its own barrier id.  The text is a
// sliding register window: row i reads Tband[k, i-1+b], so a lane needs
// one new byte per row, loaded a row ahead, as is the pattern byte.
// Traceback bytes leave as one C-byte store per lane (256 contiguous
// bytes per warp and row at B = 256).  WPP trades issue slots against
// chain latency: one warp per pair issues every instruction of a row on
// one SM sub-partition, so when the pairs are fewer than the SMs a pair
// is split over the 4 sub-partitions of its SM (ops/band.py:
// band_fwd_config; PERF.md has the times of every configuration).
//
// band_fwd_kernel (B > 512).  One CTA per pair, C = 4 columns per thread,
// T = B / 4 threads; the b+1 neighbour and the prefix-min carry cross warps
// through shared memory under two __syncthreads per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// inclusive prefix-min over the lanes of a warp
__device__ __forceinline__ int warp_scan_min(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = imin(v, u);
  }
  return v;
}

// the same scan without the lane test: below `off` __shfl_up_sync returns
// the lane's own value, and min(v, v) = v
__device__ __forceinline__ int warp_scan_min_nolane(int v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v = imin(v, __shfl_up_sync(FULL, v, off));
  return v;
}

// min(a, b) and whether a <= b (Hopper's DPX __vibmin_s32)
__device__ __forceinline__ int min_le(int a, int b, bool* a_le) {
  return __vibmin_s32(a, b, a_le);
}

// the C traceback bytes of one lane, stored at once
template <int C> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };

template <int C>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t* wd) {
  if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)wd[0];
  } else if constexpr (C == 4) {
    *reinterpret_cast<uint32_t*>(p) = wd[0];
  } else if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(wd[0], wd[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// ---------------------------------------------------------------------
// band_fwd_warp: WPP warps per pair, C columns per lane, B = 32 C WPP.

// warps of one CTA of band_fwd_warp: 256 threads let a lane keep up to
// 255 registers (C = 16 columns of state)
constexpr int MAX_GROUP_WARPS = 8;

// named barrier over the WPP warps of one pair group (id 0 is
// __syncthreads)
template <int WPP>
__device__ __forceinline__ void group_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "n"(WPP * 32)
               : "memory");
}

// what one warp publishes per row for the other warps of its pair:
// its totals of nM - b*e and its last nM (this row), and its first
// column's A1, A2, D1, D2 (read by the warp to the left in the next row)
struct Seam {
  int tot1, tot2, nm_last, a1, a2, d10, d20;
};

template <int C, int WPP>
__global__ void __launch_bounds__(MAX_GROUP_WARPS * 32, 1)
band_fwd_warp(const int8_t* __restrict__ P, const int8_t* __restrict__ Tband,
              const int32_t* __restrict__ plen_a,
              const int32_t* __restrict__ tlen_a,
              const int32_t* __restrict__ dlo_a, uint8_t* __restrict__ tbs,
              int32_t* __restrict__ finals, int32_t* __restrict__ edge_min,
              int batch, int ppc, int Lp, int x, int o1, int e1, int o2,
              int e2) {
  constexpr int B = 32 * C * WPP;
  constexpr int NW = (C + 3) / 4;       // 32-bit words of a lane's bytes
  // [slot][row parity][warp of the pair]; unused when WPP == 1
  __shared__ Seam s_seam[WPP > 1 ? MAX_GROUP_WARPS : 1][2][WPP];
  __shared__ int s_edge[WPP > 1 ? MAX_GROUP_WARPS : 1];

  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) / WPP;
  const int w = (threadIdx.x >> 5) % WPP;   // warp within the pair group
  const int k = blockIdx.x * ppc + slot;
  if (k >= batch) return;                   // the whole pair group leaves
  const int b0 = (w * 32 + lane) * C;       // first band column of the lane
  const bool first_lane = w == 0 && lane == 0;        // owns column 0
  const bool last_lane = w == WPP - 1 && lane == 31;  // owns column B-1
  const int pl = plen_a[k], tl = tlen_a[k], dl = dlo_a[k];
  const int8_t* prow = P + (size_t)k * Lp;
  const int8_t* trow = Tband + (size_t)k * (Lp + B) + b0;
  const size_t tb_stride = (size_t)batch * B;  // bytes between rows
  uint8_t* tb = tbs + (size_t)k * B + b0;
  const int oe1 = o1 + e1, oe2 = o2 + e2;

  // per column: -b*e (the I prefix-min runs over nM - b*e) and b*e + o
  // (I = that prefix-min + b*e + o), so each update is one add-and-min
  int nb1[C], nb2[C], bo1[C], bo2[C];
  // row i-1: the five states, and A = min(M + o + e, BIG), which is both
  // the D-open term of column b-1 in row i and the adjacency term of
  // column b+1 in row i-1 (the one add-and-min serves both)
  int M[C], I1[C], I2[C], D1[C], D2[C], A1[C], A2[C], txt[C];
  uint32_t wd[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) wd[q] = 0;
  // the text window one row before row 1 (every row shifts it by one
  // byte; its column 0 byte, Tband[k, b0-1], is never read)
  txt[0] = 0;
#pragma unroll
  for (int c = 1; c < C; ++c) txt[c] = trow[c - 1];
  // row 0 (ops/wfa.py:69-76)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = b0 + c;
    nb1[c] = -b * e1;
    nb2[c] = -b * e2;
    bo1[c] = b * e1 + o1;
    bo2[c] = b * e2 + o2;
    const int j0 = dl + b;
    M[c] = j0 == 0 ? 0 : BIG;
    I1[c] = j0 > 0 ? o1 + e1 * j0 : BIG;
    I2[c] = j0 > 0 ? o2 + e2 * j0 : BIG;
    D1[c] = BIG;
    D2[c] = BIG;
    A1[c] = imin(M[c] + oe1, BIG);
    A2[c] = imin(M[c] + oe2, BIG);
    wd[c / 4] |= (uint32_t)(j0 > 1 ? 24 : 0) << (8 * (c % 4));
  }
  store_bytes<C>(tb, wd);

  const int b_final = tl - pl - dl;
  const int min_e = imin(e1, e2);
  const int bl = abs(b_final) * min_e;
  const int br = abs((B - 1) - b_final) * min_e;
  // the band-edge metric reads columns 0 and B-1 only; every lane tracks
  // its first column if it owns column 0, else its last
  const int suffix = first_lane ? bl : br;
  int edge = first_lane ? imin(imin(M[0], I1[0]), I2[0]) + suffix
                        : imin(imin(M[C - 1], I1[C - 1]), I2[C - 1]) + suffix;
  // finals: plen == 0 pairs finish on row 0 (ops/wfa.py:170-177)
  int f0 = BIG, f1 = BIG, f2 = BIG, f3 = BIG, f4 = BIG;
  if (pl == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (b0 + c == b_final) { f0 = I1[c]; f1 = I2[c]; f4 = M[c]; }
    }
  }
  if constexpr (WPP > 1) {
    if (lane == 0) {
      Seam& sm = s_seam[slot][0][w];
      sm.a1 = A1[0]; sm.a2 = A2[0]; sm.d10 = D1[0]; sm.d20 = D2[0];
    }
    group_sync<WPP>(slot);
  }

  // the pattern byte and the lane's one new text byte of each row, loaded
  // a row ahead: row i reads Tband[k, i-1+b] for its C columns
  int nxt_pat = prow[0];
  int nxt_txt = trow[C - 1];
  for (int i = 1; i <= Lp; ++i) {
    const int pat = nxt_pat;
#pragma unroll
    for (int c = 0; c + 1 < C; ++c) txt[c] = txt[c + 1];
    txt[C - 1] = nxt_txt;
    if (i < Lp) {
      nxt_pat = prow[i];
      nxt_txt = trow[i + C - 1];
    }

    // (i-1, b0+C): the next lane's first column; past the band, BIG
    int rA1 = __shfl_down_sync(FULL, A1[0], 1);
    int rA2 = __shfl_down_sync(FULL, A2[0], 1);
    int rD1 = __shfl_down_sync(FULL, D1[0], 1);
    int rD2 = __shfl_down_sync(FULL, D2[0], 1);
    if (lane == 31) {
      rA1 = BIG; rA2 = BIG; rD1 = BIG; rD2 = BIG;
      if constexpr (WPP > 1) {
        if (w + 1 < WPP) {
          const Seam& sm = s_seam[slot][(i - 1) & 1][w + 1];
          rA1 = sm.a1; rA2 = sm.a2; rD1 = sm.d10; rD2 = sm.d20;
        }
      }
    }

    // bit c of vmask: column b0+c reads text (1 <= j <= tlen, i <= plen)
    const int jb = i + dl + b0;
    const int c_lo = max(1 - jb, 0);
    const int c_hi = min(i <= pl ? tl - jb : -1, C - 1);
    const uint32_t vmask = c_hi >= c_lo ? (2u << c_hi) - (1u << c_lo) : 0u;
    int nM[C], nD1[C], nD2[C], nA1[C], nA2[C];
    int tot1 = BIG, tot2 = BIG;         // the lane's min of nM - b*e
#pragma unroll
    for (int q = 0; q < NW; ++q) wd[q] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int sh = 8 * (c % 4);
      // M from the diagonal (same b); the first minimum in PERM order
      // [I1, I2, D1, D2, M] wins: a later state only on a strict <
      bool keep;
      int best = min_le(I1[c], I2[c], &keep);
      uint32_t src = keep ? 1u << sh : 2u << sh;
      best = min_le(best, D1[c], &keep);
      src = keep ? src : 3u << sh;
      best = min_le(best, D2[c], &keep);
      src = keep ? src : 4u << sh;
      best = min_le(best, M[c], &keep);
      src = keep ? src : 0u;
      const int sub = (vmask >> c) & 1u ? (pat == txt[c] ? 0 : x) : BIG;
      nM[c] = imin(best + sub, BIG);

      // D from (i-1, b+1): open from its M, extend from its D; the
      // extension bit is set when extend < open
      const int open1 = c + 1 < C ? A1[c + 1] : rA1;
      const int open2 = c + 1 < C ? A2[c + 1] : rA2;
      const int ext1 = imin((c + 1 < C ? D1[c + 1] : rD1) + e1, BIG);
      const int ext2 = imin((c + 1 < C ? D2[c + 1] : rD2) + e2, BIG);
      bool open1_le, open2_le;
      nD1[c] = min_le(open1, ext1, &open1_le);
      nD2[c] = min_le(open2, ext2, &open2_le);
      wd[c / 4] |= src | (open1_le ? 0u : 32u << sh) |
                   (open2_le ? 0u : 64u << sh);
      tot1 = imin(tot1, nM[c] + nb1[c]);
      tot2 = imin(tot2, nM[c] + nb2[c]);
      nA1[c] = imin(nM[c] + oe1, BIG);
      nA2[c] = imin(nM[c] + oe2, BIG);
    }

    // I: exclusive prefix-min of the lane totals within the warp ...
    const int inc1 = warp_scan_min_nolane(tot1);
    const int inc2 = warp_scan_min_nolane(tot2);
    int run1 = __shfl_up_sync(FULL, inc1, 1);
    int run2 = __shfl_up_sync(FULL, inc2, 1);
    int lnM = __shfl_up_sync(FULL, nM[C - 1], 1);  // nM at b0-1
    if (lane == 0) { run1 = BIG; run2 = BIG; lnM = BIG; }
    if constexpr (WPP > 1) {
      // ... and across the pair's warps, through the seam array
      Seam* row_seam = s_seam[slot][i & 1];
      if (lane == 31) {
        row_seam[w].tot1 = inc1;
        row_seam[w].tot2 = inc2;
        row_seam[w].nm_last = nM[C - 1];
      }
      if (lane == 0) {
        row_seam[w].a1 = nA1[0];
        row_seam[w].a2 = nA2[0];
        row_seam[w].d10 = nD1[0];
        row_seam[w].d20 = nD2[0];
      }
      group_sync<WPP>(slot);
      int carry1 = BIG, carry2 = BIG;
#pragma unroll
      for (int q = 0; q + 1 < WPP; ++q) {
        if (q < w) {
          carry1 = imin(carry1, row_seam[q].tot1);
          carry2 = imin(carry2, row_seam[q].tot2);
        }
      }
      run1 = imin(run1, carry1);
      run2 = imin(run2, carry2);
      if (lane == 0 && w > 0) lnM = row_seam[w - 1].nm_last;
    }

    const int act = i <= pl ? 0 : BIG;
    int nI1[C], nI2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int sh = 8 * (c % 4);
      nI1[c] = imin(run1 + bo1[c], BIG);
      nI2[c] = imin(run2 + bo2[c], BIG);
      run1 = imin(run1, nM[c] + nb1[c]);
      run2 = imin(run2, nM[c] + nb2[c]);
      // adjacency: nM at b-1 plus o + e (column 0 has no b-1: lnM is BIG)
      const int adj1 = c == 0 ? imin(lnM + oe1, BIG) : nA1[c - 1];
      const int adj2 = c == 0 ? imin(lnM + oe2, BIG) : nA2[c - 1];
      wd[c / 4] |= (nI1[c] < adj1 ? 8u << sh : 0u) |
                   (nI2[c] < adj2 ? 16u << sh : 0u);
    }
    store_bytes<C>(tb + (size_t)i * tb_stride, wd);

    if (i == pl) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (b0 + c == b_final) {
          f0 = nI1[c]; f1 = nI2[c]; f2 = nD1[c]; f3 = nD2[c]; f4 = nM[c];
        }
      }
    }
    // the lane's edge column: 0 for the owner of column 0, else its last
    const int e5 = first_lane
        ? imin(imin(imin(nM[0], nI1[0]), imin(nI2[0], nD1[0])), nD2[0])
        : imin(imin(imin(nM[C - 1], nI1[C - 1]), imin(nI2[C - 1], nD1[C - 1])),
               nD2[C - 1]);
    edge = imin(edge, imin(e5 + suffix + act, BIG));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      M[c] = nM[c]; I1[c] = nI1[c]; I2[c] = nI2[c];
      D1[c] = nD1[c]; D2[c] = nD2[c]; A1[c] = nA1[c]; A2[c] = nA2[c];
    }
  }

  // the captured finals, or BIG when b_final lies outside the band
  const bool in_band = b_final >= 0 && b_final < B;
  if (in_band ? (b_final >= b0 && b_final < b0 + C) : first_lane) {
    int32_t* f = finals + (size_t)k * 5;
    f[0] = f0; f[1] = f1; f[2] = f2; f[3] = f3; f[4] = f4;
  }
  if constexpr (WPP > 1) {
    if (last_lane) s_edge[slot] = edge;
    group_sync<WPP>(slot);
    if (first_lane) edge_min[k] = imin(edge, s_edge[slot]);
  } else {
    const int right = __shfl_sync(FULL, edge, 31);
    if (first_lane) edge_min[k] = imin(edge, right);
  }
}

// ---------------------------------------------------------------------
// band_fwd_kernel: one CTA per pair, C columns per thread, at most MAXT
// threads per CTA, B read at run time (B > 512).

template <int C, int MAXT>
__global__ void __launch_bounds__(MAXT)
band_fwd_kernel(const int8_t* __restrict__ P, const int8_t* __restrict__ Tband,
                const int32_t* __restrict__ plen_a,
                const int32_t* __restrict__ tlen_a,
                const int32_t* __restrict__ dlo_a, uint8_t* __restrict__ tbs,
                int32_t* __restrict__ finals, int32_t* __restrict__ edge_min,
                int batch, int B_arg, int Lp, int x, int o1, int e1,
                int o2, int e2) {
  const int B = B_arg;
  __shared__ int s_prev[3][MAX_WARPS];  // lane-0 M, D1, D2 of the previous row
  __shared__ int s_tot[2][MAX_WARPS];   // per-warp inclusive min of base1/base2
  __shared__ int s_nm[MAX_WARPS];       // lane-31 last-column nM of this row
  using W = typename Word<C>::T;

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;             // B / C
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = T >> 5;
  const int b0 = t * C;                 // first band column of this thread
  const int pl = plen_a[k], tl = tlen_a[k], dl = dlo_a[k];
  const int8_t* prow = P + (size_t)k * Lp;
  const int8_t* trow = Tband + (size_t)k * (Lp + B) + b0;
  const size_t tb_stride = (size_t)batch * B;  // bytes between rows
  uint8_t* tb = tbs + (size_t)k * B + b0;

  // row 0 (ops/wfa.py:69-76)
  int M[C], I1[C], I2[C], D1[C], D2[C], be1[C], be2[C];
  unsigned word = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    be1[c] = (b0 + c) * e1;
    be2[c] = (b0 + c) * e2;
    const int j0 = dl + b0 + c;
    M[c] = j0 == 0 ? 0 : BIG;
    I1[c] = j0 > 0 ? o1 + e1 * j0 : BIG;
    I2[c] = j0 > 0 ? o2 + e2 * j0 : BIG;
    D1[c] = BIG;
    D2[c] = BIG;
    word |= (unsigned)(j0 > 1 ? 24 : 0) << (8 * c);
  }
  *reinterpret_cast<W*>(tb) = (W)word;

  const int b_final = tl - pl - dl;
  const int min_e = imin(e1, e2);
  const int bl = abs(b_final) * min_e;
  const int br = abs((B - 1) - b_final) * min_e;
  // the band-edge metric reads columns 0 (thread 0) and B-1 (thread T-1)
  // only; each thread tracks its first column if it is thread 0, else its
  // last (min distributes over the row's min(edge0 + bl, edge1 + br) + act)
  const bool left = t == 0;
  const int suffix = left ? bl : br;
  int edge = left ? imin(imin(M[0], I1[0]), I2[0]) + suffix
                  : imin(imin(M[C - 1], I1[C - 1]), I2[C - 1]) + suffix;
  // finals: plen == 0 pairs finish on row 0 (ops/wfa.py:170-177)
  int f0 = BIG, f1 = BIG, f2 = BIG, f3 = BIG, f4 = BIG;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (pl == 0 && b0 + c == b_final) { f0 = I1[c]; f1 = I2[c]; f4 = M[c]; }
  }

  for (int i = 1; i <= Lp; ++i) {
    if (lane == 0) {
      s_prev[0][warp] = M[0];
      s_prev[1][warp] = D1[0];
      s_prev[2][warp] = D2[0];
    }
    const int pat = prow[i - 1];
    int txt[C];
#pragma unroll
    for (int c = 0; c < C; ++c) txt[c] = __ldg(trow + i - 1 + c);
    __syncthreads();

    // (i-1, b0+C): the next thread's first column
    int rM = __shfl_down_sync(FULL, M[0], 1);
    int rD1 = __shfl_down_sync(FULL, D1[0], 1);
    int rD2 = __shfl_down_sync(FULL, D2[0], 1);
    if (lane == 31) {
      const bool last = warp == n_warps - 1;
      rM = last ? BIG : s_prev[0][warp + 1];
      rD1 = last ? BIG : s_prev[1][warp + 1];
      rD2 = last ? BIG : s_prev[2][warp + 1];
    }

    int nM[C], nD1[C], nD2[C];
    int tot1, tot2;                     // the thread's min of nM - b*e
    word = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // M from the diagonal (same b); first minimum in PERM order wins
      int best = I1[c], src = 1;
      if (I2[c] < best) { best = I2[c]; src = 2; }
      if (D1[c] < best) { best = D1[c]; src = 3; }
      if (D2[c] < best) { best = D2[c]; src = 4; }
      if (M[c] < best) { best = M[c]; src = 0; }
      const int b = b0 + c;
      const int jv = i + dl + b;
      const bool valid = jv >= 1 && jv <= tl && i <= pl;
      const int sub = valid ? (pat == txt[c] ? 0 : x) : BIG;
      nM[c] = imin(best + sub, BIG);

      // D from (i-1, b+1)
      const int xM = c + 1 < C ? M[c + 1] : rM;
      const int xD1 = c + 1 < C ? D1[c + 1] : rD1;
      const int xD2 = c + 1 < C ? D2[c + 1] : rD2;
      const int open1 = imin(xM + o1 + e1, BIG);
      const int ext1 = imin(xD1 + e1, BIG);
      nD1[c] = imin(open1, ext1);
      const int open2 = imin(xM + o2 + e2, BIG);
      const int ext2 = imin(xD2 + e2, BIG);
      nD2[c] = imin(open2, ext2);

      word |= (unsigned)(src | ((ext1 < open1) << 5) | ((ext2 < open2) << 6))
              << (8 * c);
      tot1 = c == 0 ? nM[0] - be1[0] : imin(tot1, nM[c] - be1[c]);
      tot2 = c == 0 ? nM[0] - be2[0] : imin(tot2, nM[c] - be2[c]);
    }

    // I: inclusive prefix-min of the thread totals within the warp ...
    const int inc1 = warp_scan_min(tot1, lane);
    const int inc2 = warp_scan_min(tot2, lane);
    int ex1 = __shfl_up_sync(FULL, inc1, 1);      // exclusive prefix-min
    int ex2 = __shfl_up_sync(FULL, inc2, 1);
    int lnM = __shfl_up_sync(FULL, nM[C - 1], 1); // nM at b0-1 (adjacency)
    if (lane == 31) {
      s_tot[0][warp] = inc1;
      s_tot[1][warp] = inc2;
      s_nm[warp] = nM[C - 1];
    }
    __syncthreads();
    // ... plus the carry of the warps to the left
    int carry1 = BIG, carry2 = BIG;
    if constexpr (MAXT <= 256) {        // up to 8 warps: a serial loop
      for (int w = 0; w < warp; ++w) {
        carry1 = imin(carry1, s_tot[0][w]);
        carry2 = imin(carry2, s_tot[1][w]);
      }
    } else {                            // up to 32: a scan of warp totals
      int w1 = lane < n_warps ? s_tot[0][lane] : BIG;
      int w2 = lane < n_warps ? s_tot[1][lane] : BIG;
      w1 = warp_scan_min(w1, lane);
      w2 = warp_scan_min(w2, lane);
      const int prev_warp = warp == 0 ? 0 : warp - 1;
      const int u1 = __shfl_sync(FULL, w1, prev_warp);
      const int u2 = __shfl_sync(FULL, w2, prev_warp);
      if (warp > 0) {
        carry1 = u1;
        carry2 = u2;
      }
    }
    if (lane == 0) {
      ex1 = BIG;
      ex2 = BIG;
      lnM = warp == 0 ? BIG : s_nm[warp - 1];
    }
    int run1 = imin(carry1, ex1);       // min over the columns left of b
    int run2 = imin(carry2, ex2);

    const int act = i <= pl ? 0 : BIG;
    int e5_first = BIG, e5_last = BIG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int b = b0 + c;
      const int nI1 = imin(run1 + be1[c] + o1, BIG);
      const int nI2 = imin(run2 + be2[c] + o2, BIG);
      run1 = imin(run1, nM[c] - be1[c]);
      run2 = imin(run2, nM[c] - be2[c]);
      const int lm = c == 0 ? lnM : nM[c - 1];
      const int adj1 = b == 0 ? BIG : imin(lm + o1 + e1, BIG);
      const int adj2 = b == 0 ? BIG : imin(lm + o2 + e2, BIG);
      word |= (unsigned)(((nI1 < adj1) << 3) | ((nI2 < adj2) << 4)) << (8 * c);

      if (i == pl && b == b_final) {
        f0 = nI1; f1 = nI2; f2 = nD1[c]; f3 = nD2[c]; f4 = nM[c];
      }
      const int e5 = imin(imin(imin(nM[c], nI1), imin(nI2, nD1[c])), nD2[c]);
      if (c == 0) e5_first = e5;
      if (c == C - 1) e5_last = e5;

      M[c] = nM[c]; I1[c] = nI1; I2[c] = nI2; D1[c] = nD1[c]; D2[c] = nD2[c];
    }
    *reinterpret_cast<W*>(tb + (size_t)i * tb_stride) = (W)word;
    edge = imin(edge, imin((left ? e5_first : e5_last) + suffix + act, BIG));
  }

  // the captured finals, or BIG when b_final lies outside the band
  const bool in_band = b_final >= 0 && b_final < B;
  if (t == (in_band ? b_final / C : 0)) {
    int32_t* f = finals + (size_t)k * 5;
    f[0] = f0; f[1] = f1; f[2] = f2; f[3] = f3; f[4] = f4;
  }
  __syncthreads();  // s_tot is free again: reuse it for the edge pair
  if (t == 0) s_tot[0][0] = edge;
  if (t == T - 1) s_tot[1][0] = edge;
  __syncthreads();
  if (t == 0) edge_min[k] = imin(s_tot[0][0], s_tot[1][0]);
}

template <int C, int MAXT>
void launch(const void* P, const void* Tband, const void* plen,
            const void* tlen, const void* dlo, void* tbs, void* finals,
            void* edge_min, int batch, int B, int Lp, int x, int o1, int e1,
            int o2, int e2, cudaStream_t stream) {
  band_fwd_kernel<C, MAXT><<<batch, B / C, 0, stream>>>(
      (const int8_t*)P, (const int8_t*)Tband, (const int32_t*)plen,
      (const int32_t*)tlen, (const int32_t*)dlo, (uint8_t*)tbs,
      (int32_t*)finals, (int32_t*)edge_min, batch, B, Lp, x, o1, e1, o2, e2);
}

// one configuration of band_fwd_warp: columns per lane, warps per pair
template <int C, int WPP>
int launch_warp(const void* P, const void* Tband, const void* plen,
                const void* tlen, const void* dlo, void* tbs, void* finals,
                void* edge_min, int batch, int ppc, int Lp, int x, int o1,
                int e1, int o2, int e2, cudaStream_t stream) {
  if (ppc < 1 || ppc * WPP > MAX_GROUP_WARPS)
    return (int)cudaErrorInvalidValue;
  const int grid = (batch + ppc - 1) / ppc;
  band_fwd_warp<C, WPP><<<grid, ppc * WPP * 32, 0, stream>>>(
      (const int8_t*)P, (const int8_t*)Tband, (const int32_t*)plen,
      (const int32_t*)tlen, (const int32_t*)dlo, (uint8_t*)tbs,
      (int32_t*)finals, (int32_t*)edge_min, batch, ppc, Lp, x, o1, e1, o2,
      e2);
  return (int)cudaGetLastError();
}

// band_fwd_warp at band width B with wpp warps per pair and ppc pairs per
// CTA; cudaErrorInvalidValue for a (B, wpp) without an instantiation
int launch_warp_cfg(const void* P, const void* Tband, const void* plen,
                    const void* tlen, const void* dlo, void* tbs,
                    void* finals, void* edge_min, int batch, int B, int wpp,
                    int ppc, int Lp, int x, int o1, int e1, int o2, int e2,
                    cudaStream_t s) {
#define LCD_WARP_CFG(BB, C, W)                                              \
  if (B == BB && wpp == W)                                                 \
    return launch_warp<C, W>(P, Tband, plen, tlen, dlo, tbs, finals,       \
                             edge_min, batch, ppc, Lp, x, o1, e1, o2, e2, s);
  LCD_WARP_CFG(128, 4, 1)
  LCD_WARP_CFG(256, 8, 1)
  LCD_WARP_CFG(256, 2, 4)
  LCD_WARP_CFG(384, 4, 3)
  LCD_WARP_CFG(512, 16, 1)
  LCD_WARP_CFG(512, 4, 4)
#undef LCD_WARP_CFG
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B must be a multiple of 128 in [128, 4096] (the Pallas kernel's rule,
// pallas_band.py:18) and tbs 16-byte aligned.  B <= 512 runs band_fwd_warp
// with wpp warps per pair and ppc pairs per CTA (ops/band.py:
// band_fwd_config picks them), B > 512 band_fwd_kernel with wpp = 0;
// anything else is cudaErrorInvalidValue.
extern "C" int lcd_band_fwd(const void* P, const void* Tband, const void* plen,
                            const void* tlen, const void* dlo, void* tbs,
                            void* finals, void* edge_min, int batch, int B,
                            int Lp, int x, int o1, int e1, int o2, int e2,
                            int wpp, int ppc, void* stream) {
  if (B < 128 || B > 4096 || B % 128 != 0 || (uintptr_t)tbs % 16 != 0 ||
      (B <= 512) != (wpp > 0))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 512)
    return launch_warp_cfg(P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
                           batch, B, wpp, ppc, Lp, x, o1, e1, o2, e2, s);
  launch<4, MAX_THREADS>(P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
                         batch, B, Lp, x, o1, e1, o2, e2, s);
  return (int)cudaGetLastError();
}
