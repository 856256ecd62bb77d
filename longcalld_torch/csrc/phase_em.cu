// Phasing fixpoint EM for Hopper (sm_90a): one launch a window.
//
// Replaces the XLA program longcalld_tpu/ops/phase_kernel.py:_phase_fixpoint
// (:83-256, jitted at :259), the EM of assign_hap.c:530-542, bit for bit:
//   in : A (R, V) int8 in {-2, -1, 0, 1}; starts, ends (R,) int32; cons0
//        (2, V) int8; haps0 (R,) int8; scoreable, clean_snp, valid, hp_het,
//        hp_ont (V,) bool (one byte, 0 or 1); w_score (V,) int32
//   out: one packed int32 buffer (ops/phase_kernel.py:pack_phase_out):
//        cons (2, V) | haps (R) | ps_start (V) | agree (R) | conflict (R) |
//        profile (2, V, 2) | n_iter.
// The JAX form is one dispatch with a static trip count: max_iter
// select-masked rounds of a lax.scan.  Here the rounds run in one kernel
// and stop in the first round that changes nothing (later rounds of the
// scan are no-ops), so the outputs and n_iter are the same, and the host
// waits once, for the packed buffer.
//
// Shape of the kernel.  The grid is one cooperative launch of 1024-thread
// CTAs, at most one an SM, all resident at once (ops/phase_kernel.py:
// em_ctas sizes it by R x V).  A round is six phases, separated by grid
// barriers (every thread's __threadfence, then an arrival counter and a
// generation word in the call's scratch, zeroed before the launch):
//   1. CTA 0: het and prev_het, the exclusive cummax of the het vars'
//      indices, one 1024-var chunk at a time with a carried prefix; every
//      CTA zeroes n_agree / n_conflict;
//   2. all CTAs, a sum over reads a var (iter_update_var_hap_cons_phase_set,
//      assign_hap.c:345-422): n_agree, n_conflict;
//   3. CTA 0: the phase-set scan (phase_kernel.py:149-164) as two prefix
//      operations, a cummax of segment starts and the xor parity of the
//      flips (never reset at a new segment), per chunk with carried
//      prefixes; ps_start, the flipped consensus, the complement fill
//      (assign_hap.c:139-143) and each var's scoring weights; zeroes the
//      profile;
//   4. all CTAs, a sum over vars a read (iter_update_var_hap_to_cons_alle,
//      assign_hap.c:425-467), a warp four reads at once: s1, s2, n_used
//      and the clean-SNP agree/conflict counts, then the read's hap;
//   5. all CTAs, a sum over reads a var: the per-hap allele counts p10,
//      p11, p20, p21 (the profile);
//   6. all CTAs, each var: the consensus update (assign_hap.c:244-268) and
//      the changed flag.
// After the last barrier every thread reads the round's changed flag (a
// word of its own, written only in that round) and every CTA leaves in the
// same round.
//
// Exactness.  The JAX form's dots are float32 at HIGHEST precision and
// exact because every sum is an integer count below 2^24
// (phase_kernel.py:24-28).  Here every sum is an int32 add (a register,
// then one atomicAdd a var or a warp shuffle reduction), exact in any
// order, so the results are those counts with no TF32 hazard.  The ONT
// 67% rule compares float(max_cov) < __fmul_rn(float(p0 + p1), 0.67f),
// as the float32 multiply of the reference, and nvcc may not contract it.
//
// What bounds it on the card.  A round reads the allele matrix three
// times (two sums over reads, one over vars), R x V bytes each, and a
// byte of it is a handful of integer operations, so memory binds: at
// 3.35 TB/s a round at (R, V) = (2048, 2048) is ~0.004 ms, at (8192,
// 8192) ~0.06 ms.  The torch op chain it replaces took 9-24 ms a window,
// most of it ~250 launches and three host waits a round.  This design
// keeps the whole EM in one launch: the state (consensus, phase sets,
// per-read haps and counters, the profile) lives in the output buffer and
// a scratch buffer in device memory (L2-resident at the main path's
// sizes; V may exceed 8192, so nothing is sized for shared memory).  A
// pass over A is byte loads and a score of integer operations a cell, so
// it is bound by the SMs' instruction rate: a thread-block cluster (at
// most 8 SMs) took 16.8 ms at (8192, 8192), more than half the torch
// form's time, so the grid spans the card.  The passes keep many rows'
// loads in flight: in the sums over reads (phases 2 and 5) a warp's lanes
// share their reads, whose hap, start and end the warp loads once for 32
// reads and broadcasts by shuffles, and the loop is branch-free, every
// lane loading its bytes of each row; phase 4 sums four reads a warp at
// once.  The var-axis phases run in one CTA.  The kernel keeps no static
// state: concurrent EMs on one card (the in-process path's threads) are
// independent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

struct EmArgs {
  const int8_t* A;
  const int32_t* starts;
  const int32_t* ends;
  const int8_t* cons0;
  const int8_t* haps0;
  const uint8_t* scoreable;
  const int32_t* w;
  const uint8_t* clean;
  const uint8_t* valid;
  const uint8_t* hp_het;
  const uint8_t* hp_ont;
  int32_t* out;
  int32_t* scratch;
  int R, V, max_iter;
};

// Offsets into the packed output (ints); ops/phase_kernel.py:
// pack_phase_out writes the same layout.
struct OutLayout {
  int32_t *cons, *haps, *ps, *agree, *conflict, *prof, *n_iter;
  __device__ OutLayout(int32_t* o, int R, int V)
      : cons(o), haps(o + 2 * (size_t)V), ps(haps + R), agree(ps + V),
        conflict(agree + R), prof(conflict + R), n_iter(prof + 4 * (size_t)V) {}
  // profile (2, V, 2): var v's two allele counts in hap 1 and in hap 2
  __device__ int32_t* hap1_prof(int v) const { return prof + 2 * (size_t)v; }
  __device__ int32_t* hap2_prof(int V, int v) const {
    return prof + 2 * ((size_t)V + v);
  }
};

__device__ __forceinline__ void zero_profile(const OutLayout& o, int V,
                                             int v) {
  int32_t* pv = o.hap1_prof(v);
  int32_t* pw = o.hap2_prof(V, v);
  pv[0] = pv[1] = pw[0] = pw[1] = 0;
}

// Scratch (ints): the grid barrier's arrivals and generation (2, zeroed
// before the launch), prev_het, n_agree, n_conflict, sv1, sv2, vflags,
// scored (V each), first valid var (1), a changed flag per round
// (max_iter).
constexpr int BARRIER_WORDS = 2;
struct Scratch {
  uint32_t* barrier;
  int32_t *prev, *nag, *ncf, *sv1, *sv2, *vflags, *scored, *first, *changed;
  __device__ Scratch(int32_t* base, int V)
      : barrier((uint32_t*)base), prev(base + BARRIER_WORDS),
        nag(prev + (size_t)V), ncf(prev + 2 * (size_t)V),
        sv1(prev + 3 * (size_t)V), sv2(prev + 4 * (size_t)V),
        vflags(prev + 5 * (size_t)V), scored(prev + 6 * (size_t)V),
        first(prev + 7 * (size_t)V), changed(first + 1) {}
};

// vflags of a var: bit 0 used (cons_set & w > 0), bit 1 cs (clean_snp &
// cons_set), byte 1 the filled f1, byte 2 the filled f2 (int8)
__device__ __forceinline__ int pack_vflags(bool used, bool cs, int f1,
                                           int f2) {
  return (used ? 1 : 0) | (cs ? 2 : 0) | ((f1 & 0xff) << 8) |
         ((f2 & 0xff) << 16);
}
__device__ __forceinline__ int vflag_f1(int fl) { return (int8_t)(fl >> 8); }
__device__ __forceinline__ int vflag_f2(int fl) { return (int8_t)(fl >> 16); }

// Every thread of every CTA of the grid, all resident (a cooperative
// launch).  Each thread fences its writes; thread 0 of each CTA reads the
// generation, then arrives; the last to arrive resets the count and
// moves the generation on, which the others wait for.  A thread reads the
// generation before it arrives, so the last arrival cannot move it first.
__device__ __forceinline__ void grid_barrier(uint32_t* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile uint32_t* gen = bar + 1;
    const uint32_t g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// state written inside the kernel is read from L2 (ld.global.cg), never
// from an SM's L1, which other CTAs' writes do not reach
__device__ __forceinline__ int ld_state(const int32_t* p) { return __ldcg(p); }

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct XorOp {
  __device__ int operator()(int a, int b) const { return a ^ b; }
};

// Inclusive scan of x over the CTA's 1024 threads in thread order; *total
// is the whole CTA's.  Every thread of the CTA calls it.
template <class Op>
__device__ int block_scan(int x, Op op, int* total) {
  __shared__ int s_warp[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(t, y);
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x = op(s_warp[warp - 1], x);
  *total = s_warp[WARPS - 1];
  __syncthreads();  // s_warp is free for the next call
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__device__ __forceinline__ bool is_het(const EmArgs& a, int c1, int c2,
                                       int v) {
  return a.valid[v] && c1 != -1 && c2 != -1 && c1 != c2 && !a.hp_het[v];
}

// update_var_hap_to_cons_alle core (phase_kernel.py:_cons_update)
__device__ __forceinline__ int cons_update(int p0, int p1, bool hp_ont) {
  const int max_i = p1 > p0 ? 1 : (p0 > 0 ? 0 : -1);
  const int max_cov = max_i == 1 ? p1 : (max_i == 0 ? p0 : 0);
  const bool weak =
      hp_ont && ((float)max_cov < __fmul_rn((float)(p0 + p1), 0.67f));
  return weak ? -1 : max_i;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int READS_PER_WARP = 4;   // phase 4: reads a warp sums at once

// The (var, read slice) items of a sum over reads: Vp x n_slices items of
// `rs` reads each, spread over the grid's threads, the var fastest (a
// warp reads consecutive bytes of a row).  Vp is V rounded up to a
// multiple of 32, so the 32 lanes of a warp share one slice; lanes past V
// idle.
struct ColSplit {
  int Vp, n_slices, rs;
  long long items;
  __device__ ColSplit(int R, int V, int threads) {
    Vp = (V + 31) & ~31;
    n_slices = threads / Vp;
    n_slices = n_slices < 1 ? 1 : (n_slices > R ? R : n_slices);
    rs = (R + n_slices - 1) / n_slices;
    items = (long long)Vp * n_slices;
  }
};

__global__ void __launch_bounds__(THREADS, 1) phase_em_kernel(EmArgs a) {
  const int R = a.R, V = a.V;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int nctas = gridDim.x;
  const int gtid = rank * THREADS + tid;
  const int gthreads = nctas * THREADS;
  const OutLayout o(a.out, R, V);
  const Scratch s(a.scratch, V);
  const int lane = tid & 31;
  const ColSplit cols(R, V, gthreads);

  // ---- prologue: the state at round 0 (the scan's init,
  // phase_kernel.py:244-248); CTA 0 finds the first valid var
  for (int v = gtid; v < V; v += gthreads) {
    o.cons[v] = a.cons0[v];
    o.cons[V + v] = a.cons0[V + v];
    o.ps[v] = -1;
    zero_profile(o, V, v);
    s.scored[v] = 0;
  }
  for (int r = gtid; r < R; r += gthreads) {
    o.haps[r] = a.haps0[r];
    o.agree[r] = 0;
    o.conflict[r] = 0;
  }
  for (int k = gtid; k < a.max_iter; k += gthreads) s.changed[k] = 0;
  if (rank == 0) {
    int first = V;
    for (int v = tid; v < V; v += THREADS)
      if (a.valid[v]) {
        first = v;
        break;
      }
    int total;
    block_scan(first, MinOp(), &total);
    if (tid == 0) *s.first = total;
  }
  grid_barrier(s.barrier);

  // scored_any's read half: a var some valid read has a 0 or 1 at
  for (long long i = gtid; i < cols.items; i += gthreads) {
    const int v = (int)(i % cols.Vp);
    if (v >= V) continue;
    const int r0 = (int)(i / cols.Vp) * cols.rs;
    const int r1 = min(R, r0 + cols.rs);
    for (int r = r0; r < r1; ++r) {
      const int x = a.A[(size_t)r * V + v];
      if (a.starts[r] >= 0 && (x == 0 || x == 1)) {
        atomicOr(&s.scored[v], 1);
        break;
      }
    }
  }
  grid_barrier(s.barrier);

  const int first_valid = ld_state(s.first);
  int n_iter = 0;
  for (int round = 0; round < a.max_iter; ++round) {
    // ---- 1. prev_het[v] = the last het var before v (cummax of the het
    // indices, shifted by one: the key of var v is var v-1's)
    for (int v = gtid; v < V; v += gthreads) {
      s.nag[v] = 0;
      s.ncf[v] = 0;
    }
    if (rank == 0) {
      int carry = -1;
      for (int base = 0; base < V; base += THREADS) {
        const int v = base + tid;
        int key = -1;
        if (v >= 1 && v < V) {
          const int u = v - 1;
          if (is_het(a, ld_state(o.cons + u), ld_state(o.cons + V + u), u))
            key = u;
        }
        int total;
        const int incl = block_scan(key, MaxOp(), &total);
        if (v < V) s.prev[v] = max(carry, incl);
        carry = max(carry, total);
      }
    }
    grid_barrier(s.barrier);

    // ---- 2. n_agree / n_conflict: reads of a hap that cover [prev_het,
    // v] and hold their own consensus allele at prev_het.  The loop is
    // warp-uniform and branch-free: the warp loads 32 reads' hap, start
    // and end (a read a lane) and broadcasts them, and every lane loads
    // its two bytes of each row whatever the read, so the loads of many
    // rows are in flight at once.
    for (long long i = gtid; i < cols.items; i += gthreads) {
      const int v = (int)(i % cols.Vp);
      const int p = v < V ? ld_state(s.prev + v) : -1;
      if (!__any_sync(FULL, p >= 0)) continue;
      const int vc = min(v, V - 1), pc = max(p, 0);  // addresses in a row
      const int c1 = ld_state(o.cons + vc), c2 = ld_state(o.cons + V + vc);
      const int c1p = ld_state(o.cons + pc), c2p = ld_state(o.cons + V + pc);
      const int r0 = (int)(i / cols.Vp) * cols.rs;
      const int r1 = min(R, r0 + cols.rs);
      int ag = 0, cf = 0;
      for (int rb = r0; rb < r1; rb += 32) {
        const int rr = rb + lane;
        int h_l = 0, st_l = 0, en_l = -1;  // past r1: hap 0, never active
        if (rr < r1) {
          h_l = ld_state(o.haps + rr);
          st_l = a.starts[rr];
          en_l = a.ends[rr];
        }
        const int n = min(32, r1 - rb);
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const int h = __shfl_sync(FULL, h_l, j);
          const int st = __shfl_sync(FULL, st_l, j);
          const int en = __shfl_sync(FULL, en_l, j);
          const size_t row = (size_t)(rb + j) * V;
          const int x = a.A[row + vc];
          const int xp = a.A[row + pc];
          const bool act = p >= 0 && h != 0 && st <= p && en >= v;
          const int own = h == 1 ? c1 : c2, oth = h == 1 ? c2 : c1;
          const int own_p = h == 1 ? c1p : c2p;
          const bool own_m = x >= 0 && x == own;
          const bool oth_m = x >= 0 && x == oth;
          const bool prev_own = xp >= 0 && xp == own_p;
          ag += act && prev_own && own_m;
          cf += act && prev_own && !own_m && oth_m;
        }
      }
      if (ag) atomicAdd(s.nag + v, ag);
      if (cf) atomicAdd(s.ncf + v, cf);
    }
    grid_barrier(s.barrier);

    // ---- 3. phase sets and flips, then the fill and the scoring weights
    if (rank == 0) {
      int carry_start = -1, carry_par = 0, any_flip = 0;
      for (int base = 0; base < V; base += THREADS) {
        const int v = base + tid;
        int seg_key = -1, tog = 0;
        int c1 = -1, c2 = -1;
        bool vv = false, het = false, not_first = false;
        if (v < V) {
          c1 = ld_state(o.cons + v);
          c2 = ld_state(o.cons + V + v);
          vv = a.valid[v];
          het = is_het(a, c1, c2, v);
          const int na = ld_state(s.nag + v), nc = ld_state(s.ncf + v);
          const bool is_first = v == first_valid;
          const bool new_seg = het && na < 2 && nc < 2;
          const bool do_flip = het && !new_seg && nc > na;
          not_first = !is_first;
          if (vv && (is_first || new_seg)) seg_key = v;
          tog = vv && not_first && do_flip;
        }
        int t_start, t_par;
        const int start = max(carry_start,
                              block_scan(seg_key, MaxOp(), &t_start));
        const int par = carry_par ^ block_scan(tog, XorOp(), &t_par);
        carry_start = max(carry_start, t_start);
        carry_par ^= t_par;
        if (v < V) {
          const bool flip = vv && not_first && het && par;
          any_flip |= flip;
          o.ps[v] = vv ? start : -1;
          if (flip) {
            const int t = c1;
            c1 = c2;
            c2 = t;
            o.cons[v] = c1;
            o.cons[V + v] = c2;
          }
          // read_to_cons_allele_score's one-sided fill
          const bool scored_any =
              a.scoreable[v] && ld_state(s.scored + v) != 0;
          const int f1 = scored_any && c1 == -1 && c2 != -1 ? 1 - c2 : c1;
          const int f2 = scored_any && c2 == -1 && c1 != -1 ? 1 - c1 : c2;
          const bool cons_set = a.scoreable[v] && f1 != -1;
          const int wv = a.w[v];
          const int wf = cons_set ? wv : 0;
          s.sv1[v] = wf * (1 - 2 * f1);
          s.sv2[v] = wf * (1 - 2 * f2);
          s.vflags[v] = pack_vflags(cons_set && wv > 0,
                                    a.clean[v] && cons_set, f1, f2);
          zero_profile(o, V, v);
        }
      }
      if (__syncthreads_or(any_flip) && tid == 0)
        atomicOr(s.changed + round, 1);
    }
    grid_barrier(s.barrier);

    // ---- 4. read re-assignment: a warp sums READS_PER_WARP reads at
    // once, the lanes over the vars, so a var's weights are loaded once
    // for them and their rows' loads are in flight together
    {
      const int gwarps = gthreads / 32;
      for (int rq = (gtid / 32) * READS_PER_WARP; rq < R;
           rq += gwarps * READS_PER_WARP) {
        // per read: s1, s2, n_used, ag1, cf1, ag2, cf2
        int acc[READS_PER_WARP][7] = {};
        for (int v = lane; v < V; v += 32) {
          const int sv1 = ld_state(s.sv1 + v), sv2 = ld_state(s.sv2 + v);
          const int fl = ld_state(s.vflags + v);
          const int f1 = vflag_f1(fl), f2 = vflag_f2(fl);
          const bool used = fl & 1, cs = fl & 2;
#pragma unroll
          for (int k = 0; k < READS_PER_WARP; ++k) {
            const int x = rq + k < R ? a.A[(size_t)(rq + k) * V + v] : -1;
            const bool ok = x == 0 || x == 1;
            const int d = ok ? 1 - 2 * x : 0;
            const bool c = ok && cs;
            const int y = 1 - x;  // a 0 counts against a 1 and back
            acc[k][0] += d * sv1;
            acc[k][1] += d * sv2;
            acc[k][2] += ok && used;
            acc[k][3] += c && x == f1;
            acc[k][4] += c && y == f1;
            acc[k][5] += c && x == f2;
            acc[k][6] += c && y == f2;
          }
        }
#pragma unroll
        for (int k = 0; k < READS_PER_WARP; ++k) {
          const int r = rq + k;
          if (r >= R) break;
          const int s1 = warp_sum(acc[k][0]), s2 = warp_sum(acc[k][1]);
          const int used = warp_sum(acc[k][2]);
          const int ag1 = warp_sum(acc[k][3]), cf1 = warp_sum(acc[k][4]);
          const int ag2 = warp_sum(acc[k][5]), cf2 = warp_sum(acc[k][6]);
          if (lane == 0) {
            const bool rv = a.starts[r] >= 0;
            const int max_s = max(s1, s2), min_s = min(s1, s2);
            const int max_hap = s1 >= s2 ? 1 : 2;
            const int min_hap = s1 <= s2 ? 1 : 2;
            int hap = max_s > 0 ? max_hap : (min_s < 0 ? 3 - min_hap : 0);
            if (used == 0 || !rv) hap = 0;
            const bool pos = max_s > 0 && rv;
            o.haps[r] = hap;
            o.agree[r] = pos ? (max_hap == 1 ? ag1 : ag2) : 0;
            o.conflict[r] = pos ? (max_hap == 1 ? cf1 : cf2) : 0;
          }
        }
      }
    }
    grid_barrier(s.barrier);

    // ---- 5. the profile: each valid var's allele counts over the reads
    // of hap 1 (or unphased) and of hap 2 (or unphased), warp-uniform and
    // branch-free as phase 2
    for (long long i = gtid; i < cols.items; i += gthreads) {
      const int v = (int)(i % cols.Vp);
      const bool live = v < V && a.valid[v];
      if (!__any_sync(FULL, live)) continue;
      const int vc = min(v, V - 1);
      const int r0 = (int)(i / cols.Vp) * cols.rs;
      const int r1 = min(R, r0 + cols.rs);
      int p10 = 0, p11 = 0, p20 = 0, p21 = 0;
      for (int rb = r0; rb < r1; rb += 32) {
        const int rr = rb + lane;
        int h_l = 3;  // 3: in neither hap (a padding read, or past r1)
        if (rr < r1 && a.starts[rr] >= 0) h_l = ld_state(o.haps + rr);
        const int n = min(32, r1 - rb);
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const int h = __shfl_sync(FULL, h_l, j);
          const int x = a.A[(size_t)(rb + j) * V + vc];
          const bool h1 = h == 1 || h == 0, h2 = h == 2 || h == 0;
          p10 += h1 && x == 0;
          p11 += h1 && x == 1;
          p20 += h2 && x == 0;
          p21 += h2 && x == 1;
        }
      }
      if (!live) continue;
      int32_t* pv = o.hap1_prof(v);
      int32_t* pw = o.hap2_prof(V, v);
      if (p10) atomicAdd(pv, p10);
      if (p11) atomicAdd(pv + 1, p11);
      if (p20) atomicAdd(pw, p20);
      if (p21) atomicAdd(pw + 1, p21);
    }
    grid_barrier(s.barrier);

    // ---- 6. the consensus update; changed against the pre-fill consensus
    {
      int changed = 0;
      for (int v = gtid; v < V; v += gthreads) {
        const int c1 = ld_state(o.cons + v), c2 = ld_state(o.cons + V + v);
        int n1, n2;
        if (a.valid[v]) {
          const int32_t* pv = o.hap1_prof(v);
          const int32_t* pw = o.hap2_prof(V, v);
          const bool ont = a.hp_ont[v];
          n1 = cons_update(ld_state(pv), ld_state(pv + 1), ont);
          n2 = cons_update(ld_state(pw), ld_state(pw + 1), ont);
          changed |= n1 != c1 || n2 != c2;
        } else {
          const int fl = ld_state(s.vflags + v);
          n1 = vflag_f1(fl);
          n2 = vflag_f2(fl);
        }
        o.cons[v] = n1;
        o.cons[V + v] = n2;
      }
      if (__syncthreads_or(changed) && tid == 0)
        atomicOr(s.changed + round, 1);
    }
    grid_barrier(s.barrier);

    n_iter = round + 1;
    if (!ld_state(s.changed + round)) break;
  }
  if (rank == 0 && tid == 0) *o.n_iter = n_iter;
}

}  // namespace

// The EM of one window in one launch: a cooperative grid of `ctas` CTAs
// (at most one an SM).  scratch holds 2 + 7 V + 1 + max(max_iter, 1)
// int32, out 7 V + 3 R + 1; the barrier's two words are zeroed here.
extern "C" int lcd_phase_em(const void* A, const void* starts,
                            const void* ends, const void* cons0,
                            const void* haps0, const void* scoreable,
                            const void* w_score, const void* clean_snp,
                            const void* valid, const void* hp_het,
                            const void* hp_ont, void* out, void* scratch,
                            int R, int V, int max_iter, int ctas,
                            void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || V < 1 || max_iter < 0 || ctas < 1 || ctas > sms)
    return (int)cudaErrorInvalidValue;
  EmArgs args;
  args.A = (const int8_t*)A;
  args.starts = (const int32_t*)starts;
  args.ends = (const int32_t*)ends;
  args.cons0 = (const int8_t*)cons0;
  args.haps0 = (const int8_t*)haps0;
  args.scoreable = (const uint8_t*)scoreable;
  args.w = (const int32_t*)w_score;
  args.clean = (const uint8_t*)clean_snp;
  args.valid = (const uint8_t*)valid;
  args.hp_het = (const uint8_t*)hp_het;
  args.hp_ont = (const uint8_t*)hp_ont;
  args.out = (int32_t*)out;
  args.scratch = (int32_t*)scratch;
  args.R = R;
  args.V = V;
  args.max_iter = max_iter;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaMemsetAsync(scratch, 0, BARRIER_WORDS * sizeof(int32_t),
                        cfg.stream);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, phase_em_kernel, args);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
