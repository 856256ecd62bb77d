// Traceback walk over the forward kernel's bytes, for Hopper (sm_90a).
//
// Replaces the Pallas kernel longcalld_tpu/ops/pallas_band.py:_bwd_rows_kernel
// (entered through backward_resolve_pallas, pallas_band.py:451-495) with the
// same contract, bit for bit, at every band width the Pallas kernel takes
// (B = 128 k, 128 <= B <= 4096):
//   in : tbs (Lp+1, batch, B) uint8; plen, tlen, dlo (batch,) int32;
//        finals (batch, 5) int32 in PERM order [I1, I2, D1, D2, M]
//   out: packed (Lp, batch) int32 = op<<14 | min(n_ins, 16383) for rows
//        Lp..1 (op 0 inactive, 1 M, 2 D); b0 (batch,) int32.
//
// Design.  One warp per pair walks rows Lp..1 with the band position and
// state as scalars (the Pallas/lax forms carry them one-hot, a TPU way
// around gathers).  Every lane holds the same position and state, so
// control flow is warp-uniform.  An insertion row collapses its chain to
// the highest column <= entry whose extension bit is 0: the warp tests 32
// columns per step (at most B/32 steps) and picks the stop with
// __ballot_sync / __ffs.
//
// Off-band state.  In the one-hot reference the position can fall off the
// band: after an I chain that stops at b = 0 or finds no stop (the left
// shift drops the one-hot), or after a D step from b = B-1 (the right shift
// drops it).  From then on the one-hot is all zeros and every read under it
// gives 0.  Here that is pos = OFF (-1): an I row then emits n_ins = 1, a D
// row ends its chain, the source state read is 0 (M), and b0 is 0.
//
// What bounds it on the card: one dependent byte load per row and pair
// (latency, not bandwidth: batch * Lp bytes of reads in all), so the walk
// time is about Lp load latencies regardless of batch until the warps
// outnumber what the SMs can keep in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OFF = -1;
constexpr int WARPS_PER_CTA = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
band_bwd_kernel(const uint8_t* __restrict__ tbs,
                const int32_t* __restrict__ plen_a,
                const int32_t* __restrict__ tlen_a,
                const int32_t* __restrict__ dlo_a,
                const int32_t* __restrict__ finals,
                int32_t* __restrict__ packed, int32_t* __restrict__ b0,
                int batch, int B, int Lp) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (k >= batch) return;  // whole warp leaves together
  const int pl = plen_a[k];
  const int b_final = tlen_a[k] - pl - dlo_a[k];

  // start state: first minimum of finals (PERM order) -> canonical id
  const int32_t* f = finals + (size_t)k * 5;
  int first = 0, fmin = f[0];
  for (int c = 1; c < 5; ++c) {
    if (f[c] < fmin) { fmin = f[c]; first = c; }
  }
  const int s_final = (first + 1) % 5;

  const size_t row_stride = (size_t)batch * B;
  const uint8_t* col0 = tbs + (size_t)k * B;
  int pos = OFF, s = 0;
  for (int r = 0; r < Lp; ++r) {
    const int i = Lp - r;
    int out = 0;
    if (i <= pl) {
      if (i == pl) {
        pos = (b_final >= 0 && b_final < B) ? b_final : OFF;
        s = s_final;
      }
      const uint8_t* row = col0 + (size_t)i * row_stride;
      int n_ins = 0;
      int op = 1;
      if (s == 3 || s == 4) {                     // D: extend or back to M
        const int ext = pos == OFF ? 0 : (row[pos] >> (s == 3 ? 5 : 6)) & 1;
        if (!ext) s = 0;
        pos = (pos == OFF || pos + 1 >= B) ? OFF : pos + 1;
        op = 2;
      } else {
        if (s == 1 || s == 2) {                   // I: collapse the chain
          if (pos == OFF) {
            n_ins = 1;
          } else {
            const int bit = s == 1 ? 3 : 4;
            int stop = OFF;
            for (int hi = pos; hi >= 0 && stop == OFF; hi -= 32) {
              const int c = hi - lane;
              const bool hit = c >= 0 && !((row[c] >> bit) & 1);
              const unsigned m = __ballot_sync(FULL, hit);
              if (m) stop = hi - (__ffs(m) - 1);
            }
            // no stop found counts as a stop at b = 0 (the one-hot sum)
            n_ins = pos - (stop == OFF ? 0 : stop) + 1;
            pos = stop == OFF ? OFF : stop - 1;   // stop 0 falls off too
          }
        }
        s = pos == OFF ? 0 : (row[pos] & 7);     // M: source state
      }
      out = (op << 14) | (n_ins < 16383 ? n_ins : 16383);
    }
    if (lane == 0) packed[(size_t)r * batch + k] = out;
  }
  if (lane == 0) b0[k] = pos == OFF ? 0 : pos;
}

}  // namespace

// B must be a multiple of 128 in [128, 4096] (the Pallas kernel's rule,
// pallas_band.py:18); else cudaErrorInvalidValue.
extern "C" int lcd_band_bwd(const void* tbs, const void* plen,
                            const void* tlen, const void* dlo,
                            const void* finals, void* packed, void* b0,
                            int batch, int B, int Lp, void* stream) {
  if (B < 128 || B > 4096 || B % 128 != 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const int ctas = (batch + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  band_bwd_kernel<<<ctas, 32 * WARPS_PER_CTA, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tbs, (const int32_t*)plen, (const int32_t*)tlen,
      (const int32_t*)dlo, (const int32_t*)finals, (int32_t*)packed,
      (int32_t*)b0, batch, B, Lp);
  return (int)cudaGetLastError();
}
