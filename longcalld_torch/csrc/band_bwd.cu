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
// The walk.  One warp per pair walks rows plen..1 with the band position
// and state as scalars (the Pallas/lax forms carry them one-hot, a TPU way
// around gathers).  Every lane holds the same position and state, so
// control flow is warp-uniform.  An M row keeps the position and reads
// the next state under it, a D row moves it one column right, and an
// insertion row collapses its chain to the highest column <= entry whose
// extension bit is 0 (the warp tests 32 columns per step and picks the
// stop with __ballot_sync / __ffs), then reads the source state left of
// the stop.  Rows above plen emit 0; once the position is off the band
// every later row is an M row.
//
// Off-band state.  In the one-hot reference the position can fall off the
// band: after an I chain that stops at b = 0 or finds no stop (the left
// shift drops the one-hot), or after a D step from b = B-1 (the right shift
// drops it).  From then on the one-hot is all zeros and every read under it
// gives 0.  Here that is pos = OFF (-1): an I row then emits n_ins = 1, a D
// row ends its chain, the source state read is 0 (M), and b0 is 0.
//
// What bounds it on the card.  Each row's read depends on the previous
// row's position and state.  Read straight from device memory, as an
// earlier form of this kernel did, every row cost one memory round trip
// (0.287 us a row on the H100, about 570 cycles, whatever the batch).
// Over K rows the walk stays in a narrow column range (M keeps the
// position, D moves it right, an insertion left), so each warp walks out
// of a window of K = WIN_ROWS rows x W = WIN_COLS columns in shared
// memory, filled with 16-byte cp.async copies (a pair's row starts at
// i*batch*B + k*B, a multiple of 128 bytes, and the window's origin is a
// multiple of 16).  The windows are double-buffered: when the walk enters
// one, it issues the next K rows' copies at its current position and
// waits for them only when it gets there.  A window is placed for the
// state it is placed in: in a D state with the position near its left
// edge (a D run drifts right), else with room for an insertion chain on
// the left.  A position outside the window's columns reloads the window
// synchronously at the new position: one memory round trip, counted when
// the caller passes a counter.  An insertion chain scans the window and
// reads device memory only for columns left of it.
//
// Even from shared memory a row's chain (load, state test, branch, next
// address) took 0.18 us, so the walk goes by runs: a run of M rows stays
// in one column and a run of D rows steps one column right a row, so lane
// l reads row i - l of the run at once, and the first row that ends the
// run (a source state other than M; an extension bit of 0) comes from one
// __ballot_sync.  A step then costs one shared-memory load and one ballot
// for up to 32 rows (as far as the window's rows and columns reach), and
// its rows leave in one store instruction; an I row is a step of its own.
// What bounds the kernel now: that step's dependent chain times the steps
// of the longest walk of the batch (one per 32 rows, and about two per
// indel), a window switch every K rows, whose copies are in flight for
// only a few steps, and a memory round trip per reload (PERF.md has the
// times).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OFF = -1;
constexpr int WARPS_PER_CTA = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WIN_ROWS = 64;                  // K: rows of a window
constexpr int WIN_COLS = 128;                 // W: columns of a window
// columns a window keeps right of the position it is placed at: in an M
// or I state 40 (the rest, 73-88 columns, lies left of it for insertion
// chains), in a D state all but 16
constexpr int DRIFT_M = 40, DRIFT_D = WIN_COLS - 16;
// a window row's pitch in shared memory: 16 bytes of padding spread 32
// rows of one column over 8 banks (a 16-byte copy needs a pitch of 16k)
constexpr int ROW_PITCH = WIN_COLS + 16;
constexpr int WIN_BYTES = WIN_ROWS * ROW_PITCH;
constexpr int ROW_CHUNKS = WIN_COLS / 16;     // 16-byte copies per row
// two windows per warp: 18 KiB, 36 KiB a CTA (static shared memory)

__device__ __forceinline__ void cp_async16(uint8_t* smem, const uint8_t* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Column origin of a window placed at pos in state s: it holds pos and
// the drift - 1 columns right of it (c0 + W >= pos + drift), starts at a
// multiple of 16 and lies inside the band (B >= W).
__device__ __forceinline__ int window_c0(int pos, int s, int B) {
  const int drift = s == 3 || s == 4 ? DRIFT_D : DRIFT_M;
  const int c = (pos + drift - WIN_COLS + 15) & ~15;
  return min(max(c, 0), B - WIN_COLS);
}

// The two windows of one warp.  A window holds rows hi down to lo
// (slot hi - i) and columns c0 .. c0 + W - 1.
struct Ring {
  uint8_t* buf;          // 2 * WIN_BYTES of shared memory
  const uint8_t* col0;   // tbs + k * B: the pair's column 0 of row 0
  size_t row_stride;     // batch * B
  int B, lane;
  int cur;               // buffer of the window being walked (0 or 1)
  int hi, lo, c0;        // the walked window
  int n_hi, n_lo, n_c0;  // the prefetched one (n_hi < 1: none)
  int reloads;

  __device__ __forceinline__ void fill(int b, int whi, int wlo, int wc0) {
    uint8_t* dst = buf + b * WIN_BYTES;
    const int n = (whi - wlo + 1) * ROW_CHUNKS;
    for (int q = lane; q < n; q += 32) {
      const int slot = q / ROW_CHUNKS, ch = q % ROW_CHUNKS;
      cp_async16(dst + slot * ROW_PITCH + ch * 16,
                 col0 + (size_t)(whi - slot) * row_stride + wc0 + ch * 16);
    }
    cp_async_commit();
  }

  // issue the copies of the K rows below the walked window
  __device__ __forceinline__ void prefetch(int pos, int s) {
    n_hi = lo - 1;
    if (n_hi < 1) return;
    n_lo = max(n_hi - WIN_ROWS + 1, 1);
    n_c0 = window_c0(pos, s, B);
    fill(cur ^ 1, n_hi, n_lo, n_c0);
  }

  // load the window of rows i.. around pos and wait for it (and for a
  // prefetch still in flight, which the new one then replaces)
  __device__ __forceinline__ void load(int i, int pos, int s) {
    __syncwarp();                 // every lane is done with this buffer
    hi = i;
    lo = max(i - WIN_ROWS + 1, 1);
    c0 = window_c0(pos, s, B);
    fill(cur, hi, lo, c0);
    cp_async_wait_all();
    __syncwarp();
    prefetch(pos, s);
  }

  // make row i (the walk's row or the row below the window) and column
  // pos readable from the walked window
  __device__ __forceinline__ void ensure(int i, int pos, int s) {
    if (i < lo) {                 // the prefetched window takes over
      cp_async_wait_all();
      __syncwarp();
      cur ^= 1;
      hi = n_hi;
      lo = n_lo;
      c0 = n_c0;
      if ((unsigned)(pos - c0) < (unsigned)WIN_COLS) {
        prefetch(pos, s);
        return;
      }
    } else if ((unsigned)(pos - c0) < (unsigned)WIN_COLS) {
      return;
    }
    ++reloads;
    load(i, pos, s);
  }

  // the byte at (row i, column c) of the walked window
  __device__ __forceinline__ int at(int i, int c) const {
    return buf[cur * WIN_BYTES + (hi - i) * ROW_PITCH + (c - c0)];
  }
};

__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
band_bwd_kernel(const uint8_t* __restrict__ tbs,
                const int32_t* __restrict__ plen_a,
                const int32_t* __restrict__ tlen_a,
                const int32_t* __restrict__ dlo_a,
                const int32_t* __restrict__ finals,
                int32_t* __restrict__ packed, int32_t* __restrict__ b0,
                int32_t* __restrict__ reload_count,
                int batch, int B, int Lp) {
  __shared__ __align__(16) uint8_t ring[WARPS_PER_CTA][2 * WIN_BYTES];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * WARPS_PER_CTA + warp;
  if (k >= batch) return;  // whole warp leaves together
  const int pl = plen_a[k];
  const int b_final = tlen_a[k] - pl - dlo_a[k];

  // start state: first minimum of finals (PERM order) -> canonical id
  const int32_t* f = finals + (size_t)k * 5;
  int first = 0, fmin = f[0];
  for (int c = 1; c < 5; ++c) {
    if (f[c] < fmin) { fmin = f[c]; first = c; }
  }

  // rows Lp..top+1 are inactive: zeros, stored in bulk
  const int top = max(0, min(pl, Lp));
  for (int r = lane; r < Lp - top; r += 32) packed[(size_t)r * batch + k] = 0;

  const size_t row_stride = (size_t)batch * B;
  const uint8_t* col0 = tbs + (size_t)k * B;
  Ring w;
  w.buf = ring[warp];
  w.col0 = col0;
  w.row_stride = row_stride;
  w.B = B;
  w.lane = lane;
  w.cur = 0;
  w.reloads = 0;
  int pos = OFF, s = 0;
  if (top >= 1 && top == pl) {    // the walk starts on row plen
    pos = (b_final >= 0 && b_final < B) ? b_final : OFF;
    s = (first + 1) % 5;
    if (pos != OFF) w.load(top, pos, s);
  }

  constexpr int M_ROW = 1 << 14, D_ROW = 2 << 14;
  int i = top;
  while (i >= 1) {
    const size_t r = (size_t)(Lp - i);
    if (pos == OFF) {
      // off the band: this row by its state, then M rows to the end
      const int out = s == 3 || s == 4 ? D_ROW : M_ROW + (s == 1 || s == 2);
      if (lane == 0) packed[r * batch + k] = out;
      for (size_t q = r + 1 + lane; q < (size_t)Lp; q += 32)
        packed[q * batch + k] = M_ROW;
      break;
    }
    if (s == 1 || s == 2) {                     // I: collapse the chain
      w.ensure(i, pos, s);
      const int bit = s == 1 ? 3 : 4;
      const uint8_t* grow = col0 + (size_t)i * row_stride;
      int stop = OFF;
      for (int hi = pos; hi >= 0 && stop == OFF; hi -= 32) {
        const int c = hi - lane;
        bool hit = false;
        if (c >= 0) {
          const int v = c >= w.c0 ? w.at(i, c) : grow[c];
          hit = !((v >> bit) & 1);
        }
        const unsigned m = __ballot_sync(FULL, hit);
        if (m) stop = hi - (__ffs(m) - 1);
      }
      // no stop found counts as a stop at b = 0 (the one-hot sum)
      const int n_ins = pos - (stop == OFF ? 0 : stop) + 1;
      pos = stop == OFF ? OFF : stop - 1;       // stop 0 falls off too
      s = 0;
      if (pos != OFF) {                         // source state left of it
        w.ensure(i, pos, s);
        s = w.at(i, pos) & 7;
      }
      if (lane == 0) packed[r * batch + k] = M_ROW + min(n_ins, 16383);
      --i;
      continue;
    }
    // A run of M rows (same column, until a source state other than M)
    // or of D rows (one column right a row, until the extension bit is
    // 0), lane l reading row i - l, within the window's rows and columns.
    w.ensure(i, pos, s);
    const bool d = s == 3 || s == 4;
    int n = min(32, i - w.lo + 1);
    if (d) n = min(n, w.c0 + WIN_COLS - pos);
    int v = 0;
    bool ends = false;
    if (lane < n) {
      v = w.at(i - lane, d ? pos + lane : pos);
      ends = d ? !((v >> (s == 3 ? 5 : 6)) & 1) : (v & 7) != 0;
    }
    const unsigned m = __ballot_sync(FULL, ends);
    const int len = m ? __ffs(m) : n;           // the ending row included
    if (lane < len) packed[(r + lane) * batch + k] = d ? D_ROW : M_ROW;
    if (d) {
      if (m) s = 0;
      pos = pos + len >= B ? OFF : pos + len;
    } else {                                    // the last row's source
      s = __shfl_sync(FULL, v, len - 1) & 7;
    }
    i -= len;
  }
  if (lane == 0) {
    b0[k] = pos == OFF ? 0 : pos;
    if (reload_count != nullptr && w.reloads) atomicAdd(reload_count,
                                                        w.reloads);
  }
}

}  // namespace

// B must be a multiple of 128 in [128, 4096] (the Pallas kernel's rule,
// pallas_band.py:18) and tbs 16-byte aligned; else cudaErrorInvalidValue.
// reload_count is null or one int32 on the device, to which the launch adds
// its synchronous window reloads.
extern "C" int lcd_band_bwd(const void* tbs, const void* plen,
                            const void* tlen, const void* dlo,
                            const void* finals, void* packed, void* b0,
                            void* reload_count, int batch, int B, int Lp,
                            void* stream) {
  if (B < 128 || B > 4096 || B % 128 != 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)tbs % 16 != 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const int ctas = (batch + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  band_bwd_kernel<<<ctas, 32 * WARPS_PER_CTA, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tbs, (const int32_t*)plen, (const int32_t*)tlen,
      (const int32_t*)dlo, (const int32_t*)finals, (int32_t*)packed,
      (int32_t*)b0, (int32_t*)reload_count, batch, B, Lp);
  return (int)cudaGetLastError();
}
