// Forward banded gap-affine-2p DP for Hopper (sm_90a).
//
// Replaces the Pallas kernel longcalld_tpu/ops/pallas_band.py:_dp_rows_kernel
// (entered through banded_dp_pallas, pallas_band.py:285-341) with the same
// contract, bit for bit:
//   in : P (batch, Lp) int8 padded with 4; Tband (batch, Lp+B) int8,
//        pre-shifted so Tband[k, c] = T[k, c + dlo_k], sentinel 127;
//        plen, tlen, dlo (batch,) int32
//   out: tbs (Lp+1, batch, B) uint8 = src | i1_ext<<3 | i2_ext<<4 |
//        d1_ext<<5 | d2_ext<<6; finals (batch, 5) int32 in PERM order
//        [I1, I2, D1, D2, M]; edge_min (batch,) int32.
//
// Design.  One CTA per pair, one thread per band column b (B = 256 = 8
// warps).  The five state values of a column live in registers across the
// whole row sweep.  Per row:
//   * M takes the same column of the previous row (registers only);
//   * D needs column b+1 of the previous row: a warp shuffle, with the
//     warp-boundary value passed through shared memory;
//   * I is an exclusive prefix-min of nM - b*e along the row: a warp
//     shuffle scan with a cross-warp carry in shared memory;
//   * the row's 256 traceback bytes are written coalesced.
// Two __syncthreads per row order the shared-memory exchanges.
//
// What bounds it on the card: the row loop is a serial dependency chain
// (two block barriers and ~100 integer ops per row), and one CTA per pair
// leaves SMs idle when batch < 132 x (CTAs per SM).  The traceback stream
// is batch * (Lp+1) * 256 bytes of writes, well under HBM bandwidth at
// these row rates.  The text window of row i overlaps row i-1's by 255
// bytes, so its loads hit L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int BAND = 256;
constexpr int WARPS = BAND / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__global__ void __launch_bounds__(BAND)
band_fwd_kernel(const int8_t* __restrict__ P, const int8_t* __restrict__ Tband,
                const int32_t* __restrict__ plen_a,
                const int32_t* __restrict__ tlen_a,
                const int32_t* __restrict__ dlo_a, uint8_t* __restrict__ tbs,
                int32_t* __restrict__ finals, int32_t* __restrict__ edge_min,
                int batch, int Lp, int x, int o1, int e1, int o2, int e2) {
  __shared__ int s_prev[3][WARPS];  // lane-0 M, D1, D2 of the previous row
  __shared__ int s_tot[2][WARPS];   // per-warp inclusive min of base1/base2
  __shared__ int s_nm[WARPS];       // lane-31 nM of the current row

  const int k = blockIdx.x;
  const int b = threadIdx.x;
  const int lane = b & 31;
  const int warp = b >> 5;
  const int pl = plen_a[k], tl = tlen_a[k], dl = dlo_a[k];
  const int8_t* prow = P + (size_t)k * Lp;
  const int8_t* trow = Tband + (size_t)k * (Lp + BAND);
  const size_t tb_stride = (size_t)batch * BAND;  // bytes between rows
  uint8_t* tb = tbs + (size_t)k * BAND + b;

  // row 0 (ops/wfa.py:69-76)
  const int j0 = dl + b;
  int M = j0 == 0 ? 0 : BIG;
  int I1 = j0 > 0 ? o1 + e1 * j0 : BIG;
  int I2 = j0 > 0 ? o2 + e2 * j0 : BIG;
  int D1 = BIG, D2 = BIG;
  tb[0] = j0 > 1 ? 24 : 0;

  const int b_final = tl - pl - dl;
  const int min_e = imin(e1, e2);
  const int bl = abs(b_final) * min_e;
  const int br = abs((BAND - 1) - b_final) * min_e;
  // per-column share of the band-edge metric; only b = 0 and B-1 use it
  // (min distributes over the row's min(edge0 + bl, edge1 + br) + act)
  const int suffix = b == 0 ? bl : br;
  int edge = imin(imin(M, I1), I2) + suffix;      // row-0 term, unclamped
  // finals: plen == 0 pairs finish on row 0 (ops/wfa.py:170-177)
  int f0 = BIG, f1 = BIG, f2 = BIG, f3 = BIG, f4 = BIG;
  if (pl == 0 && b == b_final) { f0 = I1; f1 = I2; f4 = M; }

  const int be1 = b * e1, be2 = b * e2;
  for (int i = 1; i <= Lp; ++i) {
    if (lane == 0) {
      s_prev[0][warp] = M;
      s_prev[1][warp] = D1;
      s_prev[2][warp] = D2;
    }
    const int pat = prow[i - 1];
    const int txt = __ldg(trow + i - 1 + b);
    __syncthreads();

    // M from the diagonal (same b); first minimum in PERM order wins
    int best = I1, src = 1;
    if (I2 < best) { best = I2; src = 2; }
    if (D1 < best) { best = D1; src = 3; }
    if (D2 < best) { best = D2; src = 4; }
    if (M < best) { best = M; src = 0; }
    const int jv = i + dl + b;
    const bool valid = jv >= 1 && jv <= tl && i <= pl;
    const int sub = valid ? (pat == txt ? 0 : x) : BIG;
    const int nM = imin(best + sub, BIG);

    // D from (i-1, b+1)
    int rM = __shfl_down_sync(FULL, M, 1);
    int rD1 = __shfl_down_sync(FULL, D1, 1);
    int rD2 = __shfl_down_sync(FULL, D2, 1);
    if (lane == 31) {
      const bool last = warp == WARPS - 1;
      rM = last ? BIG : s_prev[0][warp + 1];
      rD1 = last ? BIG : s_prev[1][warp + 1];
      rD2 = last ? BIG : s_prev[2][warp + 1];
    }
    const int open1 = imin(rM + o1 + e1, BIG);
    const int ext1 = imin(rD1 + e1, BIG);
    const int nD1 = imin(open1, ext1);
    const int open2 = imin(rM + o2 + e2, BIG);
    const int ext2 = imin(rD2 + e2, BIG);
    const int nD2 = imin(open2, ext2);

    // I: inclusive prefix-min of nM - b*e within the warp ...
    int r1 = nM - be1, r2 = nM - be2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u1 = __shfl_up_sync(FULL, r1, off);
      const int u2 = __shfl_up_sync(FULL, r2, off);
      if (lane >= off) { r1 = imin(r1, u1); r2 = imin(r2, u2); }
    }
    int lnM = __shfl_up_sync(FULL, nM, 1);       // nM at b-1 (adjacency)
    int c1 = __shfl_up_sync(FULL, r1, 1);        // exclusive prefix-min
    int c2 = __shfl_up_sync(FULL, r2, 1);
    if (lane == 31) {
      s_tot[0][warp] = r1;
      s_tot[1][warp] = r2;
      s_nm[warp] = nM;
    }
    __syncthreads();
    // ... plus the carry of the warps to the left
    int carry1 = BIG, carry2 = BIG;
    for (int w = 0; w < warp; ++w) {
      carry1 = imin(carry1, s_tot[0][w]);
      carry2 = imin(carry2, s_tot[1][w]);
    }
    if (lane == 0) {
      c1 = carry1;
      c2 = carry2;
      lnM = warp == 0 ? BIG : s_nm[warp - 1];
    } else {
      c1 = imin(c1, carry1);
      c2 = imin(c2, carry2);
    }
    const int nI1 = imin(c1 + be1 + o1, BIG);
    const int nI2 = imin(c2 + be2 + o2, BIG);
    const int adj1 = b == 0 ? BIG : imin(lnM + o1 + e1, BIG);
    const int adj2 = b == 0 ? BIG : imin(lnM + o2 + e2, BIG);

    tb[(size_t)i * tb_stride] =
        (uint8_t)(src | ((nI1 < adj1) << 3) | ((nI2 < adj2) << 4) |
                  ((ext1 < open1) << 5) | ((ext2 < open2) << 6));

    if (i == pl && b == b_final) {
      f0 = nI1; f1 = nI2; f2 = nD1; f3 = nD2; f4 = nM;
    }
    const int act = i <= pl ? 0 : BIG;
    const int e5 = imin(imin(imin(nM, nI1), imin(nI2, nD1)), nD2);
    edge = imin(edge, imin(e5 + suffix + act, BIG));

    M = nM; I1 = nI1; I2 = nI2; D1 = nD1; D2 = nD2;
  }

  // the captured finals, or BIG when b_final lies outside the band
  const bool in_band = b_final >= 0 && b_final < BAND;
  if ((in_band && b == b_final) || (!in_band && b == 0)) {
    int32_t* f = finals + (size_t)k * 5;
    f[0] = f0; f[1] = f1; f[2] = f2; f[3] = f3; f[4] = f4;
  }
  __syncthreads();  // s_tot is free again: reuse it for the edge pair
  if (b == 0) s_tot[0][0] = edge;
  if (b == BAND - 1) s_tot[1][0] = edge;
  __syncthreads();
  if (b == 0) edge_min[k] = imin(s_tot[0][0], s_tot[1][0]);
}

}  // namespace

extern "C" int lcd_band_fwd(const void* P, const void* Tband, const void* plen,
                            const void* tlen, const void* dlo, void* tbs,
                            void* finals, void* edge_min, int batch, int B,
                            int Lp, int x, int o1, int e1, int o2, int e2,
                            void* stream) {
  if (B != BAND) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  band_fwd_kernel<<<batch, BAND, 0, (cudaStream_t)stream>>>(
      (const int8_t*)P, (const int8_t*)Tband, (const int32_t*)plen,
      (const int32_t*)tlen, (const int32_t*)dlo, (uint8_t*)tbs,
      (int32_t*)finals, (int32_t*)edge_min, batch, Lp, x, o1, e1, o2, e2);
  return (int)cudaGetLastError();
}
