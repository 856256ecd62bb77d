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
// serial chain: every row waits for the I prefix-min of the row, so the
// designs keep each row to one barrier at most and spread a pair over as
// many SMs as it takes to keep the card busy.
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
// band_fwd_wide (B > 512).  The same column body, text window and stores,
// at C = 8 columns per lane (4 in a cluster of 8, and with B read at run
// time), with a pair split over NCTA CTAs of one thread-block cluster
// (NCTA = 1: a plain CTA), each CTA holding B / NCTA contiguous columns
// on its own SM.  A row crosses a slice edge in three ways only: D reads
// (i-1, b+1), the first column of the slice to the right; the I
// prefix-min needs the min of nM - b*e over every column to the left;
// the adjacency term reads nM at b-1, the last column of the slice to
// the left.  So each warp publishes one seam a row -- its total of
// nM - b*e for both gap kinds (one redux.sync each), its last nM, its
// first column's A1, A2, D1, D2 -- into the shared memory of the CTAs
// that read it: the totals to every CTA (those on the right read them;
// the others are held to the same row by them), nM to the warp on its
// right, the first column to the warp on its left.  The seam array is
// double-buffered by row parity, so one wait a row suffices; after it
// every read is local, and a warp takes the min of the totals to its
// left in one redux.sync.  Within a CTA the seam is shared stores and
// the wait a __syncthreads.  Across a cluster the stores to other CTAs
// are st.async, each completing its bytes on the receiving CTA's
// mbarrier of the row's parity, on which each local warp also arrives;
// a CTA waits for its row's bytes and warps alone.  A cluster barrier
// instead (barrier.cluster.arrive.release) waits for every traceback
// store to device memory before it as well: ~1700 clocks a row on the
// H100 (PERF.md, PR 9).  nM, nD and the seam of a row need only the row
// before, so the seam leaves before the warp's own prefix scan, which
// runs while the exchange is in flight.
//
// What binds it: issue on each SM sub-partition (about 54 instructions
// a cell, 16 int32 lanes a sub-partition, for B / NCTA columns a row),
// plus, in a cluster, the exchange's latency a row (~850 clocks), which
// no other work of the pair can hide: row i+1 needs row i's I.  So one
// CTA of 8 columns a lane is the fastest wherever the pairs fill the
// SMs, and a cluster only where a pair's CTA would hold several warps a
// sub-partition and its CTAs fit on idle SMs (ops/band.py:
// band_fwd_config).  The compiled widths are the ones launched: 1024
// and 4096 (the aligner's band buckets) and 2048 (bench.py's shape);
// every other multiple of 128 above 512 runs one CTA per pair, C = 4,
// with B read at run time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// inclusive prefix-min over the lanes of a warp: below `off`
// __shfl_up_sync returns the lane's own value, and min(v, v) = v
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
// band_fwd_wide: a pair over NCTA CTAs of a cluster, NT threads of C
// columns each (B = C NT NCTA); NT = 0 reads B and the thread count at
// run time (B = C blockDim.x, NCTA = 1).

constexpr int MAX_PAIR_WARPS = MAX_THREADS / 32;  // warps of one pair

// what one warp of band_fwd_wide publishes per row: tot1, tot2 and
// nm_last of this row, and its first column's A1, A2, D1, D2 (read by
// the warp to the left in the next row); 16-byte aligned for v2 and v4
// stores
struct __align__(16) WideSeam {
  int tot1, tot2, nm_last, pad;
  int a1, a2, d10, d20;
};

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the shared::cluster address of this CTA's shared address `a` in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// the seam's stores into CTA `rank`'s copy of `p`: a shared store when
// that is this CTA (`own`), else an st.async that completes its bytes on
// that CTA's copy of the mbarrier `bar`.  An st.async releases only
// itself, so a row's exchange never waits for the traceback stores to
// device memory, as a release of the whole thread (barrier.cluster's)
// would.
__device__ __forceinline__ void send1(int* p, int rank, int own, uint32_t bar,
                                      int v) {
  if (rank == own) {
    *p = v;
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1,"
        " [%2];"
        :: "r"(cluster_addr(smem_addr(p), rank)), "r"(v),
           "r"(cluster_addr(bar, rank))
        : "memory");
  }
}

__device__ __forceinline__ void send2(int* p, int rank, int own, uint32_t bar,
                                      int v0, int v1) {
  if (rank == own) {
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0],"
        " {%1, %2}, [%3];"
        :: "r"(cluster_addr(smem_addr(p), rank)), "r"(v0), "r"(v1),
           "r"(cluster_addr(bar, rank))
        : "memory");
  }
}

__device__ __forceinline__ void send4(int* p, int rank, int own, uint32_t bar,
                                      int v0, int v1, int v2, int v3) {
  if (rank == own) {
    *reinterpret_cast<int4*>(p) = make_int4(v0, v1, v2, v3);
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0],"
        " {%1, %2, %3, %4}, [%5];"
        :: "r"(cluster_addr(smem_addr(p), rank)), "r"(v0), "r"(v1), "r"(v2),
           "r"(v3), "r"(cluster_addr(bar, rank))
        : "memory");
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// a warp's arrival on a row's phase (release at CTA scope: the warp's
// shared stores before it), the first warp's with the bytes the phase
// waits for from the other CTAs
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// polls of mbar_wait before it traps: a row's phase completes within
// microseconds, so a phase that never completes (a byte count that does
// not match the sends) ends the kernel with an error instead of hanging
constexpr uint32_t MAX_POLLS = 1u << 20;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == MAX_POLLS) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// a barrier over the pair's threads, used at its start and end: the
// cluster's (release and acquire at cluster scope), or the CTA's
template <int NCTA>
__device__ __forceinline__ void pair_sync() {
  if constexpr (NCTA == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

template <int C, int NT, int NCTA>
__global__ void __launch_bounds__(NT > 0 ? NT : MAX_THREADS, 1)
band_fwd_wide(const int8_t* __restrict__ P, const int8_t* __restrict__ Tband,
              const int32_t* __restrict__ plen_a,
              const int32_t* __restrict__ tlen_a,
              const int32_t* __restrict__ dlo_a, uint8_t* __restrict__ tbs,
              int32_t* __restrict__ finals, int32_t* __restrict__ edge_min,
              int batch, int B_arg, int Lp, int x, int o1, int e1, int o2,
              int e2) {
  static_assert(NT > 0 || NCTA == 1, "run-time B takes one CTA per pair");
  constexpr int NW = (C + 3) / 4;       // 32-bit words of a lane's bytes
  const int B = NT > 0 ? C * NT * NCTA : B_arg;
  const int nw = NT > 0 ? NT / 32 : (int)(blockDim.x >> 5);  // CTA's warps
  const int nwg = nw * NCTA;            // the pair's warps
  // [row parity][warp of the pair], and per row parity the mbarrier its
  // seam stores complete on (NCTA > 1)
  __shared__ WideSeam s_seam[2][MAX_PAIR_WARPS];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_edge;

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int rank = NCTA > 1 ? cluster_rank() : 0;
  const int k = blockIdx.x / NCTA;
  const int g = rank * nw + w;          // warp within the pair
  const int b0 = (g * 32 + lane) * C;   // first band column of the lane
  const bool first_lane = g == 0 && lane == 0;          // owns column 0
  const bool last_lane = g == nwg - 1 && lane == 31;    // owns column B-1
  const int pl = plen_a[k], tl = tlen_a[k], dl = dlo_a[k];
  const int8_t* prow = P + (size_t)k * Lp;
  const int8_t* trow = Tband + (size_t)k * (Lp + B) + b0;
  const size_t tb_stride = (size_t)batch * B;  // bytes between rows
  uint8_t* tb = tbs + (size_t)k * B + b0;
  const int oe1 = o1 + e1, oe2 = o2 + e2;

  // as in band_fwd_warp: -b*e and b*e + o per column, row i-1's states
  // and A = min(M + o + e, BIG), the text window
  int nb1[C], nb2[C], bo1[C], bo2[C];
  int M[C], I1[C], I2[C], D1[C], D2[C], A1[C], A2[C], txt[C];
  uint32_t wd[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) wd[q] = 0;
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
  const int suffix = first_lane ? bl : br;
  int edge = first_lane ? imin(imin(M[0], I1[0]), I2[0]) + suffix
                        : imin(imin(M[C - 1], I1[C - 1]), I2[C - 1]) + suffix;
  int f0 = BIG, f1 = BIG, f2 = BIG, f3 = BIG, f4 = BIG;
  if (pl == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (b0 + c == b_final) { f0 = I1[c]; f1 = I2[c]; f4 = M[c]; }
    }
  }
  // row 0 of the first column right of the lane's warp needs no
  // exchange: M is 0 at j = 0 and D is BIG
  if (lane == 31 && g + 1 < nwg) {
    const int m0 = dl + b0 + C == 0 ? 0 : BIG;
    *reinterpret_cast<int4*>(&s_seam[0][g + 1].a1) =
        make_int4(imin(m0 + oe1, BIG), imin(m0 + oe2, BIG), BIG, BIG);
  }
  // each row's phase of the mbarriers waits for one arrival a warp of
  // the CTA (after its shared stores) and the bytes the other CTAs send:
  // the totals of all their warps, nM from the last warp of the CTA on
  // the left, the first column of the CTA on the right.  The totals go to
  // every CTA, not only to those on the right that read them, so that no
  // CTA completes a row before every other has sent it: a CTA can then
  // be at most one row ahead of any other, and the double-buffered seam
  // and mbarriers are never written for row i + 2 while a CTA still
  // reads row i
  const int rx_bytes = 8 * (NCTA - 1) * nw + (rank > 0 ? 4 : 0) +
                       (rank < NCTA - 1 ? 16 : 0);
  if constexpr (NCTA > 1) {
    if (threadIdx.x == 0) {
      mbar_init(smem_addr(&s_bar[0]), nw);
      mbar_init(smem_addr(&s_bar[1]), nw);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // every CTA of the cluster runs, with its mbarriers set, before any
  // peer sends to it
  pair_sync<NCTA>();

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

    // (i-1, b0+C): the next lane's first column, across a warp edge from
    // the seam of row i-1; past the band, BIG
    int rA1 = __shfl_down_sync(FULL, A1[0], 1);
    int rA2 = __shfl_down_sync(FULL, A2[0], 1);
    int rD1 = __shfl_down_sync(FULL, D1[0], 1);
    int rD2 = __shfl_down_sync(FULL, D2[0], 1);
    if (lane == 31) {
      rA1 = BIG; rA2 = BIG; rD1 = BIG; rD2 = BIG;
      if (g + 1 < nwg) {
        const int4 s = *reinterpret_cast<const int4*>(
            &s_seam[(i - 1) & 1][g + 1].a1);
        rA1 = s.x; rA2 = s.y; rD1 = s.z; rD2 = s.w;
      }
    }

    const int jb = i + dl + b0;
    const int c_lo = max(1 - jb, 0);
    const int c_hi = min(i <= pl ? tl - jb : -1, C - 1);
    const uint32_t vmask = c_hi >= c_lo ? (2u << c_hi) - (1u << c_lo) : 0u;
    int nM[C], nD1[C], nD2[C], nA1[C], nA2[C];
    int tot1 = BIG, tot2 = BIG;
#pragma unroll
    for (int q = 0; q < NW; ++q) wd[q] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int sh = 8 * (c % 4);
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

    // the seam of row i: the warp's totals, its last nM, its first
    // column.  It goes out before the warp's own prefix scan, so that the
    // exchange runs under the scan, except with B read at run time: there
    // a CTA may hold 1024 threads, whose 64 registers each do not hold
    // the totals across the scan (the seam waits for the scan's last
    // lane instead)
    WideSeam* rs = s_seam[i & 1];
    const uint32_t bar = smem_addr(&s_bar[i & 1]);
    constexpr bool EARLY = NT > 0;
    auto publish = [&](int wt1, int wt2) {
      if constexpr (NCTA == 1) {
        if (lane == 0)
          *reinterpret_cast<int2*>(&rs[g].tot1) = make_int2(wt1, wt2);
        if (lane == 31 && g + 1 < nwg) rs[g].nm_last = nM[C - 1];
        if (lane == 0 && g > 0)
          *reinterpret_cast<int4*>(&rs[g].a1) =
              make_int4(nA1[0], nA2[0], nD1[0], nD2[0]);
      } else {
        if (lane < NCTA) send2(&rs[g].tot1, lane, rank, bar, wt1, wt2);
        if (lane == 31 && g + 1 < nwg)
          send1(&rs[g].nm_last, w + 1 < nw ? rank : rank + 1, rank, bar,
                nM[C - 1]);
        if (lane == 0 && g > 0)
          send4(&rs[g].a1, w > 0 ? rank : rank - 1, rank, bar, nA1[0],
                nA2[0], nD1[0], nD2[0]);
        __syncwarp();
        if (lane == 0) {
          if (w == 0) {
            mbar_arrive_expect(bar, rx_bytes);
          } else {
            mbar_arrive(bar);
          }
        }
      }
    };
    if constexpr (EARLY)
      publish(__reduce_min_sync(FULL, tot1), __reduce_min_sync(FULL, tot2));
    // I: exclusive prefix-min of the lane totals within the warp ...
    const int inc1 = warp_scan_min_nolane(tot1);
    const int inc2 = warp_scan_min_nolane(tot2);
    int run1 = __shfl_up_sync(FULL, inc1, 1);
    int run2 = __shfl_up_sync(FULL, inc2, 1);
    int lnM = __shfl_up_sync(FULL, nM[C - 1], 1);  // nM at b0-1
    if (lane == 0) { run1 = BIG; run2 = BIG; lnM = BIG; }
    if constexpr (!EARLY)
      publish(__shfl_sync(FULL, inc1, 31), __shfl_sync(FULL, inc2, 31));
    // ... and across the pair's warps, once every seam of the row is in
    if constexpr (NCTA == 1) {
      __syncthreads();
    } else {
      // mbarrier 1 serves rows 1, 3, 5, ..., mbarrier 0 rows 2, 4, ...:
      // row i is its use (i - 1) / 2, whose phase parity it waits for
      mbar_wait(bar, ((i - 1) >> 1) & 1);
    }
    const int2 t = lane < g ? *reinterpret_cast<const int2*>(&rs[lane].tot1)
                            : make_int2(BIG, BIG);
    run1 = imin(run1, __reduce_min_sync(FULL, t.x));
    run2 = imin(run2, __reduce_min_sync(FULL, t.y));
    if (lane == 0 && g > 0) lnM = rs[g - 1].nm_last;

    const int act = i <= pl ? 0 : BIG;
    int nI1[C], nI2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int sh = 8 * (c % 4);
      nI1[c] = imin(run1 + bo1[c], BIG);
      nI2[c] = imin(run2 + bo2[c], BIG);
      run1 = imin(run1, nM[c] + nb1[c]);
      run2 = imin(run2, nM[c] + nb2[c]);
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
  // edge_min: column B-1's edge goes to the first CTA; the barrier also
  // keeps every CTA alive until no peer reads or writes its shared memory
  if (last_lane) {
    if constexpr (NCTA == 1) {
      s_edge = edge;
    } else {
      asm volatile("st.shared::cluster.s32 [%0], %1;"
                   :: "r"(cluster_addr(smem_addr(&s_edge), 0)), "r"(edge)
                   : "memory");
    }
  }
  pair_sync<NCTA>();
  if (first_lane) edge_min[k] = imin(edge, s_edge);
}

// one configuration of band_fwd_wide: columns per lane, threads per CTA (0:
// B / C, read at run time), CTAs per pair
template <int C, int NT, int NCTA>
int launch_wide(const void* P, const void* Tband, const void* plen,
                const void* tlen, const void* dlo, void* tbs, void* finals,
                void* edge_min, int batch, int B, int Lp, int x, int o1,
                int e1, int o2, int e2, cudaStream_t stream) {
  const int threads = NT > 0 ? NT : B / C;
  if (threads % 32 != 0 || threads > MAX_THREADS ||
      (long long)batch * NCTA > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * NCTA);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCTA;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = NCTA > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, band_fwd_wide<C, NT, NCTA>, (const int8_t*)P,
      (const int8_t*)Tband, (const int32_t*)plen, (const int32_t*)tlen,
      (const int32_t*)dlo, (uint8_t*)tbs, (int32_t*)finals,
      (int32_t*)edge_min, batch, B, Lp, x, o1, e1, o2, e2);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
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

// band_fwd_wide at band width B with cpl columns per lane and ncta CTAs
// per pair: the configurations of the compiled widths, and at every other
// width (4, 1) with B read at run time; cudaErrorInvalidValue otherwise
int launch_wide_cfg(const void* P, const void* Tband, const void* plen,
                    const void* tlen, const void* dlo, void* tbs,
                    void* finals, void* edge_min, int batch, int B, int cpl,
                    int ncta, int Lp, int x, int o1, int e1, int o2, int e2,
                    cudaStream_t s) {
#define LCD_WIDE_CFG(BB, C, N)                                              \
  if (B == BB && cpl == C && ncta == N)                                    \
    return launch_wide<C, BB / (C * N), N>(P, Tband, plen, tlen, dlo, tbs,  \
                                           finals, edge_min, batch, B, Lp,  \
                                           x, o1, e1, o2, e2, s);
  LCD_WIDE_CFG(1024, 8, 1)
  LCD_WIDE_CFG(2048, 8, 1)
  LCD_WIDE_CFG(2048, 4, 8)
  LCD_WIDE_CFG(4096, 8, 1)
  LCD_WIDE_CFG(4096, 8, 2)
  LCD_WIDE_CFG(4096, 4, 8)
#undef LCD_WIDE_CFG
  if (B != 1024 && B != 2048 && B != 4096 && cpl == 4 && ncta == 1)
    return launch_wide<4, 0, 1>(P, Tband, plen, tlen, dlo, tbs, finals,
                                edge_min, batch, B, Lp, x, o1, e1, o2, e2, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B must be a multiple of 128 in [128, 4096] (the Pallas kernel's rule,
// pallas_band.py:18) and tbs 16-byte aligned.  The two configuration
// arguments (ops/band.py:band_fwd_config picks them) are, at B <= 512,
// band_fwd_warp's warps per pair and pairs per CTA, and at B > 512
// band_fwd_wide's columns per lane and CTAs per pair (the cluster size);
// a configuration without an instantiation is cudaErrorInvalidValue, and
// a cluster launch the card refuses returns its error.
extern "C" int lcd_band_fwd(const void* P, const void* Tband, const void* plen,
                            const void* tlen, const void* dlo, void* tbs,
                            void* finals, void* edge_min, int batch, int B,
                            int Lp, int x, int o1, int e1, int o2, int e2,
                            int cfg0, int cfg1, void* stream) {
  if (B < 128 || B > 4096 || B % 128 != 0 || (uintptr_t)tbs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 512)
    return launch_warp_cfg(P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
                           batch, B, cfg0, cfg1, Lp, x, o1, e1, o2, e2, s);
  return launch_wide_cfg(P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
                         batch, B, cfg0, cfg1, Lp, x, o1, e1, o2, e2, s);
}
