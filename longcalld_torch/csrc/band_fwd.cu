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
// Design.  One CTA per pair.  Each thread owns C consecutive band columns
// (C = 1 up to B = 256, 2 up to 512, 4 up to 4096), so a CTA has
// T = B / C <= 1024 threads, a whole number of warps.  Fewer threads with
// more columns each were faster at every width measured on the H100
// (PERF.md): the row chain's barriers and cross-warp steps cost per
// warp.  The five state values of a column live in registers across
// the whole row sweep.  Per row:
//   * M takes the same column of the previous row (registers only);
//   * D needs column b+1 of the previous row: inside the thread but for
//     its last column, which takes the next thread's first column by a
//     warp shuffle, with the warp-boundary value passed through shared
//     memory;
//   * I is an exclusive prefix-min of nM - b*e along the row: serial over
//     the thread's C columns, a warp shuffle scan of the thread totals,
//     and a carry across warps from the warp totals in shared memory: a
//     serial loop over the warps to the left in CTAs of up to 8 warps, a
//     warp scan of the warp totals in CTAs of up to 32;
//   * the adjacency term takes nM at b-1 the same way (thread, warp
//     shuffle, shared memory at the warp seam);
//   * the row's traceback bytes are written as one C-byte store per
//     thread, coalesced across the warp.
// Two __syncthreads per row order the shared-memory exchanges.  The main
// path's B = 256 has its own instantiation with B fixed at compile time:
// with B read at run time the same code was 8-9% slower at batch >= 512
// on the H100 (PERF.md).
//
// What bounds it on the card: the row loop is a serial dependency chain
// (two block barriers and ~100 integer ops per column per row), and one
// CTA per pair leaves SMs idle when batch < 132 x (CTAs per SM).  The
// traceback stream is batch * (Lp+1) * B bytes of writes, well under HBM
// bandwidth at these row rates.  The text window of row i overlaps row
// i-1's by B-1 bytes, so its loads hit L1.

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

// the C traceback bytes of one thread, stored at once
template <int C> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };

// C columns per thread, at most MAXT threads per CTA; FIXED_B > 0 makes
// B that compile-time constant, else B is the run-time argument
template <int C, int MAXT, int FIXED_B>
__global__ void __launch_bounds__(MAXT)
band_fwd_kernel(const int8_t* __restrict__ P, const int8_t* __restrict__ Tband,
                const int32_t* __restrict__ plen_a,
                const int32_t* __restrict__ tlen_a,
                const int32_t* __restrict__ dlo_a, uint8_t* __restrict__ tbs,
                int32_t* __restrict__ finals, int32_t* __restrict__ edge_min,
                int batch, int B_arg, int Lp, int x, int o1, int e1,
                int o2, int e2) {
  const int B = FIXED_B > 0 ? FIXED_B : B_arg;
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

template <int C, int MAXT, int FIXED_B = 0>
void launch(const void* P, const void* Tband, const void* plen,
            const void* tlen, const void* dlo, void* tbs, void* finals,
            void* edge_min, int batch, int B, int Lp, int x, int o1, int e1,
            int o2, int e2, cudaStream_t stream) {
  band_fwd_kernel<C, MAXT, FIXED_B><<<batch, B / C, 0, stream>>>(
      (const int8_t*)P, (const int8_t*)Tband, (const int32_t*)plen,
      (const int32_t*)tlen, (const int32_t*)dlo, (uint8_t*)tbs,
      (int32_t*)finals, (int32_t*)edge_min, batch, B, Lp, x, o1, e1, o2, e2);
}

}  // namespace

// B must be a multiple of 128 in [128, 4096] (the Pallas kernel's rule,
// pallas_band.py:18) and tbs 4-byte aligned; else cudaErrorInvalidValue.
extern "C" int lcd_band_fwd(const void* P, const void* Tband, const void* plen,
                            const void* tlen, const void* dlo, void* tbs,
                            void* finals, void* edge_min, int batch, int B,
                            int Lp, int x, int o1, int e1, int o2, int e2,
                            void* stream) {
  if (B < 128 || B > 4096 || B % 128 != 0 || (uintptr_t)tbs % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 256)  // the main path's width (ops/wfa.py:submit routes only it)
    launch<1, 256, 256>(P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
                        batch, B, Lp, x, o1, e1, o2, e2, s);
  else if (B < 256)
    launch<1, 256>(P, Tband, plen, tlen, dlo, tbs, finals, edge_min, batch, B,
                   Lp, x, o1, e1, o2, e2, s);
  else if (B <= 512)
    launch<2, 256>(P, Tband, plen, tlen, dlo, tbs, finals, edge_min, batch, B,
                   Lp, x, o1, e1, o2, e2, s);
  else
    launch<4, MAX_THREADS>(P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
                           batch, B, Lp, x, o1, e1, o2, e2, s);
  return (int)cudaGetLastError();
}
