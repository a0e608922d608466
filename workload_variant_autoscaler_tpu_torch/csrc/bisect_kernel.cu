// SLO-sizing bisection over the state-dependent M/M/1/K queue, for Hopper.
//
// Replaces the TPU kernel `_bisect_kernel` of the reference package's
// ops/pallas_kernel.py (launched through `pl.pallas_call` by
// `_run_bisect_kernel`), in both of its forms: the mean form (TTFT or ITL
// mean target, entry `size_batch_pallas`) and the tail form (TTFT held at a
// percentile through the Erlang-mixture wait tail, `size_batch_tail_pallas`).
//
// What bounds it. A row is one bisection of up to 48 (float32) or 100
// (float64) trips. A trip is a chain of dependent steps over the row's
// states: a max, then five sums (six in the tail form), and in the tail
// form a CDF count, two chained prefix scans for the partial Poisson sums
// Q(k, x) and one more sum. The arithmetic is small (one exp and about ten
// flops per state and trip, one more exp per Poisson index in the tail
// form), so the card is not short of throughput: a row is held back by
// latency, since every reduction across threads is a barrier, and a trip
// cannot start before the last one ends. There is no matrix product, so
// the tensor cores have no part in it.
//
// Design.
// - Teams by row length. A row's states 1..n_top are cut into contiguous
//   runs, one per thread. A row of at most 32 * RUN states gets one warp,
//   one of at most 128 * RUN states a 128-thread block (the short teams:
//   runs of at most RUN states), and a longer row a 256-thread block whose
//   runs have any length (the long team: a second launch, made only when
//   k_max admits such rows). The team follows from the row's own n_top.
//   One launch serves the two short teams: its first blocks take one row
//   each with 128 threads, the rest take four rows each, one per warp; a
//   team whose row belongs to another team returns at once.
// - One barrier per reduction or scan. A thread reduces or scans its own
//   run in registers, the warp combines the run totals with shuffles, and
//   the team's warps combine through shared memory after one barrier; a
//   scan's carry is then added back in the thread. Sums over the same
//   states share one pass and one barrier. A trip takes 2 barriers in the
//   mean form and at most 6 in the tail form (the max; the sums, which also
//   carry the CDF; the quantile count; the two Q(k, x) scans; the
//   Erlang-mixture sum), where the 256-thread blocks of the first port took
//   4 and, on a row of 2816 states, about 70. A warp team takes none, and
//   rows never wait on each other.
// - Latency within a thread. A short team's run is walked in chunks of
//   CHUNK states with one branch per chunk and branch-free bodies, so that
//   a chunk's shared loads and exps overlap; its p_n (and, in the tail
//   form, its Poisson terms) stay in registers through a trip. The long
//   team recomputes them from clm in each pass instead, so that no
//   per-state array outgrows the registers and only shared memory bounds
//   the row. float32 takes its exps as one ex2.approx of an exponent kept
//   in base 2. The float32 short-team kernel is compiled for 5 resident
//   blocks per SM.
// - Shared memory. Each thread's clm, and in the tail form its log(i),
//   sit in its own slice, laid out [state in run][thread], so that a warp's
//   loads fall in distinct banks and no thread reads another's slice. clm
//   arrives by cp.async, issued before the row's scalar prologue; log(i) is
//   taken once per row, not per trip. A long row takes k_max rounded up to
//   256 elements of each, so that with the 226 KB the wrapper allows, k_max
//   reaches 57856 (float32) and 28928 (float64) in the mean form, 28928 and
//   14336 in the tail form.
// - Lane independence. The team, the runs and the order of every sum and
//   scan follow from the row's own n_top (and n_max for the Poisson
//   indices), never from k_max, the batch, blockIdx or the other rows of a
//   block, so a row gives the same bits in any batch and under any k_max
//   bucket (System._dedup_rows relies on it).
// - A frozen row stops early; the result is the full trip count's.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (ops/_build.py), called through ctypes
// from ops/bisect_kernel.py, whose plain PyTorch version (`bisect_plain`)
// is the same computation.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cfloat>
#include <climits>
#include <cstddef>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int RUN = 24;                // states a short team's thread holds
constexpr int WARP_STATES = 32 * RUN;  // longest row of a warp team
constexpr int SMALL_THREADS = 128;     // block of the short teams
constexpr int BLOCK_STATES = SMALL_THREADS * RUN;
constexpr int LONG_THREADS = 256;      // block of the long team
constexpr int WARP_ROWS = SMALL_THREADS / 32;   // rows of a warp-team block
// Resident blocks per SM the short-team kernel is compiled for: in float32
// the register cap this sets (102) let 5 blocks in where 4 fitted and
// measured faster on the main path's launches; 6 (85 registers) was slower.
// (The long-team kernel's registers stay uncapped, 96 in the float64 mean
// form, 2 blocks per SM: a cap for 3 gained 4-7% there on rows of 5632
// states and lost 7-12% on rows of 11264, where shared memory holds 2
// blocks anyway.)
template <typename T>
constexpr int SMALL_MIN_BLOCKS = sizeof(T) == 4 ? 5 : 1;
// above this much dynamic shared memory a launch needs the opt-in (the
// default limit of 48 KB also counts the static arrays)
constexpr size_t SMEM_OPT_IN = 32 * 1024;

// per-row float columns (ops/bisect_kernel.py F_* constants)
enum {
  F_ALPHA, F_BETA, F_GAMMA, F_DELTA, F_IN, F_OUT, F_TARGET, F_LO, F_HI,
  F_X0, F_SLO, F_MUN
};
constexpr int NF_MEAN = 10;
constexpr int NF_TAIL = 12;
// per-row int32 columns (ops/bisect_kernel.py I_* constants)
enum { I_NMAX, I_KOCC, I_TTFT, I_INC, I_DONE, NI };

__host__ __device__ constexpr int team_threads(int n_top) {
  return n_top <= WARP_STATES ? 32
       : n_top <= BLOCK_STATES ? SMALL_THREADS : LONG_THREADS;
}

// the long team's slots per array: k_max rounded up to whole rows of
// LONG_THREADS
__host__ __device__ constexpr size_t long_slots(int k_max) {
  return (static_cast<size_t>(k_max) + LONG_THREADS - 1) / LONG_THREADS *
         LONG_THREADS;
}

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// The exponentials of a trip. float32 keeps its exponents in base 2:
// log2 e is folded once into clm and log i (per row) and into log(mid) and
// log x (per trip), and each state then takes one ex2.approx (2^x, flushing
// results below FLT_MIN, which are far below the row's largest p = 1).
// float64 keeps exp, with a scale of 1.
template <typename T> struct Exp;
template <> struct Exp<float> {
  static constexpr float scale = 1.4426950408889634f;   // log2 e
  static __device__ __forceinline__ float of(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
};
template <> struct Exp<double> {
  static constexpr double scale = 1.0;
  static __device__ __forceinline__ double of(double x) { return exp(x); }
};

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double neg_inf() { return -CUDART_INF; }
};

template <typename T>
__device__ __forceinline__ T max2(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T min2(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ bool within_tol(T y, T target) {
  if (y == target) return true;
  if (target == T(0)) return false;
  T r = (y - target) / target;
  r = r < T(0) ? -r : r;
  return r <= T(1e-6);  // ops/search.py TOLERANCE
}

// One element (4 or 8 bytes) from device memory into shared memory,
// asynchronously; the issuing thread waits with cp_async_wait_all.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Hide a value from the optimizer: what a stage derives per state from a
// run's bounds is then recomputed in the stage, not kept in registers for
// every state of the run from one trip to the next.
__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void opaque(double& v) { asm volatile("" : "+d"(v)); }

// A thread's run: states j0 + k + 1 for k < cnt, with the kinds of state
// as bounds on k: head states (n <= n_max) for k < kh, accepted states
// (n < k_occ) for k < ka, the blocking state (n == k_occ) at k == ka, and
// waiting states (Poisson index n - n_max >= 0) for kw <= k < ka, whose
// index is >= 1 for k >= kh.
template <typename T>
struct Run {
  int cnt, kh, ka, kw;
  T nf0;   // n of the run's first state

  __device__ Run fresh() const {
    Run r = *this;
    opaque(r.cnt);
    opaque(r.kh);
    opaque(r.ka);
    opaque(r.kw);
    opaque(r.nf0);
    return r;
  }
};

// Calls body(k, in, n) for the states k < cnt of a run, n = nf0 + k the
// state's n. A short team's run (REG) goes in chunks of CHUNK: one branch
// per chunk; within a chunk the bodies are branch-free (a state past the
// run has in = false and is masked by a select), so that their loads and
// exps overlap. (A second, unmasked copy of the loop for whole chunks
// measured slower: the kernel's code outgrows the instruction cache.) The
// long team's run, of any length, goes in a plain loop that counts n in
// floating point (exact for integers), since an int-to-float conversion
// per state costs as much as several FMAs.
constexpr int CHUNK = 6;
static_assert(RUN % CHUNK == 0, "a run is a whole number of chunks");

template <bool REG, typename T, typename F>
__device__ __forceinline__ void each_state(int cnt, T nf0, F&& body) {
  if constexpr (REG) {
#pragma unroll
    for (int k0 = 0; k0 < RUN; k0 += CHUNK) {
      if (k0 >= cnt) break;
#pragma unroll
      for (int k = k0; k < k0 + CHUNK; ++k) body(k, k < cnt, nf0 + T(k));
    }
  } else {
    T nf = nf0;
    for (int k = 0; k < cnt; ++k, nf += T(1)) body(k, true, nf);
  }
}

// Butterfly reductions: every lane gets the same bits (each step adds the
// same two values in either lane).
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max2(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Exclusive prefix of v over the warp's lanes, in lane order; `incl`
// receives the inclusive one.
template <typename T>
__device__ __forceinline__ T warp_excl(T v, int lane, T& incl) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += u;
  }
  incl = v;
  const T e = __shfl_up_sync(FULL_MASK, v, 1);
  return lane == 0 ? T(0) : e;
}

// Shared scratch of one team's cross-warp combines: one slice per stage
// of a trip, so a stage never overwrites values that readers of another
// stage may still need (two barriers separate two writes of one slice).
template <typename T, int WARPS>
struct Scratch {
  T max_[WARPS];
  T sums[WARPS * 6];
  T scan1[WARPS];
  T scan2[WARPS];
  T erl[WARPS];
  int below[WARPS];
};

// A team of NT threads: one warp (NT == 32) or a whole block.
template <typename T, int NT>
struct Team {
  static constexpr int WARPS = NT / 32;
  int t, lane, warp;
  Scratch<T, WARPS>* s;   // unused by a warp team

  __device__ T vmax(T v) const {
    v = warp_max(v);
    if constexpr (NT > 32) {
      if (lane == 0) s->max_[warp] = v;
      __syncthreads();
      v = s->max_[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v = max2(v, s->max_[w]);
    }
    return v;
  }

  // Sums of NV values at once, the same bits in every thread; the warp
  // partials stay in `slot[w * NV + i]` until the next write of the slot.
  template <typename V, int NV>
  __device__ void sum(V (&v)[NV], V* slot) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
    if constexpr (NT > 32) {
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) slot[warp * NV + i] = v[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        V a = slot[i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) a += slot[w * NV + i];
        v[i] = a;
      }
    }
  }

  // Exclusive prefix, in thread order, of each thread's v.
  __device__ T carry(T v, T* slot) const {
    T incl;
    T c = warp_excl(v, lane, incl);
    if constexpr (NT > 32) {
      if (lane == 31) slot[warp] = incl;
      __syncthreads();
      T pre = T(0);
      for (int w = 0; w < warp; ++w) pre += slot[w];
      c = pre + c;
    }
    return c;
  }
};

// One bisection row on a team of NT threads; the caller has checked that
// the row belongs to this team. clm_s and logi_s are this team's slices of
// shared memory, [RUN][NT] for the short teams (so a state past a run is
// read without a guard and masked), as many rows of NT as k_max needs for
// the long team.
template <typename T, bool TAIL, int NT>
__device__ __forceinline__ void solve_row(
    const T* __restrict__ fcols, const int* __restrict__ icols,
    const T* __restrict__ clm, T* __restrict__ x_star, int row, int clm_rows,
    int k_max, int trips, T tail_pct, T* clm_s, T* logi_s,
    const Team<T, NT>& team) {
  constexpr int NS = TAIL ? 6 : 5;
  // a short team keeps its run's p and Poisson terms in registers; the
  // long team recomputes them from clm (and log i) where a pass reads them
  constexpr bool REG = NT <= SMALL_THREADS;
  const int t = team.t;
  const T* f = fcols + static_cast<size_t>(row) * (TAIL ? NF_TAIL : NF_MEAN);
  const int* ic = icols + static_cast<size_t>(row) * NI;
  const int n_max = ic[I_NMAX];
  const int k_occ = ic[I_KOCC];
  const int n_top = min(k_occ, k_max);   // states 1..n_top are in range
  bool done = ic[I_DONE] > 0;
  T xs = f[F_X0];
  if (done) {
    if (t == 0) x_star[row] = xs;
    return;
  }

  // this thread's run: states j0+1 .. j0+cnt
  const int len = n_top > 0 ? (n_top + NT - 1) / NT : 0;
  const int j0 = t * len;
  const int cnt = max(min(n_top - j0, len), 0);
  const T* clm_row = clm + static_cast<size_t>(row % clm_rows) * k_max;
  for (int k = 0; k < cnt; ++k) cp_async(clm_s + k * NT + t, clm_row + j0 + k);
  const Run<T> run{cnt, min(max(n_max - j0, 0), cnt),
                   min(max(k_occ - 1 - j0, 0), cnt),
                   min(max(n_max - 1 - j0, 0), cnt), static_cast<T>(j0 + 1)};

  const T alpha = f[F_ALPHA], beta = f[F_BETA], gamma = f[F_GAMMA];
  const T delta = f[F_DELTA], in_tok = f[F_IN], out_tok = f[F_OUT];
  const T target = f[F_TARGET];
  const bool is_ttft = ic[I_TTFT] > 0;
  const bool increasing = ic[I_INC] > 0;
  T lo = f[F_LO], hi = f[F_HI];
  const T n_max_f = static_cast<T>(n_max);
  // tail form: Poisson indices 0..n_wait-1, index n - n_max for waiting
  // state n
  const int n_wait = min(k_occ - 1, n_top) - n_max + 1;
  T slo = T(0), mun = T(0);
  if constexpr (TAIL) {
    slo = f[F_SLO];
    mun = f[F_MUN];
    for (int k = run.kh; k < cnt; ++k)
      logi_s[k * NT + t] = lg(static_cast<T>(j0 + k + 1 - n_max)) * Exp<T>::scale;
  }
  cp_async_wait_all();
  if constexpr (Exp<T>::scale != T(1)) {
    for (int k = 0; k < cnt; ++k) clm_s[k * NT + t] *= Exp<T>::scale;
  }

  // a run's clm and log i at state k (a short team's slices hold RUN
  // states, the long team reads none past its run)
  const auto clm_at = [&](int k) { return clm_s[k * NT + t]; };
  const auto logi_at = [&](int k) { return logi_s[k * NT + t]; };

  T p[REG ? RUN : 1];
  T w[TAIL && REG ? RUN : 1];
  for (int trip = 0; trip < trips && !done; ++trip) {
    const T mid = T(0.5) * (lo + hi);
    const T lm = lg(mid) * Exp<T>::scale;

    // steady state at rate mid: logp[n] = n log(mid) - clm[n-1] (float32:
    // in base 2, as are m and the exponents below)
    T mx = Num<T>::neg_inf();
    {
      const Run<T> r = run.fresh();
      each_state<REG>(r.cnt, r.nf0, [&](int k, bool in, T nf) {
        const T lp = lm * nf - clm_at(k);
        const T lpk = in ? lp : Num<T>::neg_inf();   // p = 0 past the run
        if constexpr (REG) p[k] = lpk;
        mx = max2(mx, lpk);
      });
    }
    const T m = max2(team.vmax(mx), T(0));
    // p at state k of a run, once the sums below have taken it
    const auto p_at = [&](int k, T nf) {
      if constexpr (REG) return p[k];
      else return Exp<T>::of(lm * nf - clm_at(k) - m);
    };

    // sum p, sum n p, head n p, head p, p at K (tail form: accepted p)
    T acc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[i] = T(0);
    {
      const Run<T> r = run.fresh();
      if constexpr (REG) {
        each_state<REG>(r.cnt, r.nf0, [&](int k, bool, T nf) {
          const T pk = Exp<T>::of(p[k] - m);
          p[k] = pk;
          acc[0] += pk;
          acc[1] += nf * pk;
          if constexpr (TAIL) acc[5] += k < r.ka ? pk : T(0);
        });
        // the head states (n <= n_max) open the row, so only the first
        // threads have any
        each_state<REG>(r.kh, r.nf0, [&](int k, bool in, T nf) {
          const T head = in ? p[k] : T(0);
          acc[2] += nf * head;
          acc[3] += head;
        });
      } else {
        // the long team takes the head's sums in the same pass
        each_state<REG>(r.cnt, r.nf0, [&](int k, bool, T nf) {
          const T pk = p_at(k, nf);
          acc[0] += pk;
          acc[1] += nf * pk;
          if constexpr (TAIL) acc[5] += k < r.ka ? pk : T(0);
          if (k < r.kh) {
            acc[2] += nf * pk;
            acc[3] += pk;
          }
        });
      }
      // the blocking state is one thread's: its p again, by the same steps
      if (r.ka < r.cnt)
        acc[4] = Exp<T>::of(lm * (r.nf0 + T(r.ka)) - clm_at(r.ka) - m);
    }
    // tail form: the run's CDF carry within the warp, before the sums
    // replace acc[0] by the row total
    T p_carry = T(0);
    if constexpr (TAIL) {
      T incl;
      p_carry = warp_excl(acc[0], team.lane, incl);
    }
    team.sum(acc, team.s ? team.s->sums : nullptr);

    const T p0 = Exp<T>::of(-m);
    const T z = p0 + acc[0];
    // the mean TTFT or ITL at mid (a tail-form TTFT row's y is the wait
    // tail below instead, so such a row does not take this)
    const auto mean_y = [&] {
      const T avg_n = acc[1] / z;
      const T head_np = acc[2] / z;
      const T head_p = (p0 + acc[3]) / z;
      const T in_serv = head_np + (T(1) - head_p) * n_max_f;
      const T p_k = acc[4] / z;
      const T x = mid * (T(1) - p_k);
      const bool pos = x > T(0);
      const T safe_x = pos ? x : T(1);
      const T tt = pos ? avg_n / safe_x : T(0);
      const T ss = pos ? in_serv / safe_x : T(0);
      const T wq = max2(tt - ss, T(0));

      // effective concurrency inversion, then TTFT / ITL
      const T tokens = out_tok - T(1);
      const T numer = ss - (gamma + alpha * tokens);
      const T denom = delta * in_tok + beta * tokens;
      T conc = denom != T(0) ? numer / denom : (numer > T(0) ? n_max_f : T(0));
      conc = min2(max2(conc, T(0)), n_max_f);
      const T pre = in_tok > T(0) ? gamma + delta * in_tok * conc : T(0);
      return is_ttft ? wq + pre : alpha + beta * conc;
    };

    T y = TAIL && is_ttft ? T(0) : mean_y();
    if constexpr (TAIL) {
      if (is_ttft) {
        // occupancy quantile: states whose CDF is below pct * z (state 0
        // counts through p0); the warps before this one carry in their sums
        const T tail_z = tail_pct * z;
        T run_p = p_carry;
        if constexpr (NT > 32) {
          T before = T(0);
          for (int v = 0; v < team.warp; ++v) before += team.s->sums[v * NS];
          run_p = before + run_p;
        }
        int below[1] = {0};
        {
          const Run<T> r = run.fresh();
          each_state<REG>(r.cnt, r.nf0, [&](int k, bool in, T nf) {
            run_p += p_at(k, nf);
            below[0] += in && p0 + run_p < tail_z ? 1 : 0;
          });
        }
        team.sum(below, team.s ? team.s->below : nullptr);
        const T nq = (p0 < tail_z ? T(1) : T(0)) + static_cast<T>(below[0]);
        const T bq = min2(nq, n_max_f);
        const T prefill_q = in_tok > T(0) ? gamma + delta * in_tok * bq : T(0);
        const T threshold = max2(slo - prefill_q, T(0));
        const T xx = mun * threshold;
        const T safe_xx = max2(xx, Num<T>::tiny());
        const T lx = lg(safe_xx) * Exp<T>::scale;
        const T xx_e = safe_xx * Exp<T>::scale;

        if (prefill_q >= slo) {
          y = T(1);
        } else {
          // Erlang mixture: P(W > threshold | accepted), with the waiting
          // state n read at Q(n - n_max + 1, x)
          T num[1] = {T(0)};
          if (n_wait > 0) {
            if (xx <= T(0)) {   // Q(k, 0) = 1
              const Run<T> r = run.fresh();
              each_state<REG>(r.ka, r.nf0, [&](int k, bool in, T nf) {
                num[0] += in && k >= r.kw ? p_at(k, nf) : T(0);
              });
            } else {
              // Q(k, x) for this run's indices: a scan of small log
              // increments, exp, then a second scan (the long team takes
              // the first scan and the exps again in the last pass)
              const auto incr = [&](const Run<T>& r, int k, bool in) {
                // index 0 and the states before it add no increment
                return in && k >= r.kh ? lx - logi_at(k) : T(0);
              };
              T s1 = T(0);
              {
                const Run<T> r = run.fresh();
                each_state<REG>(r.ka, r.nf0, [&](int k, bool in, T) {
                  const T v = incr(r, k, in);
                  if constexpr (REG) w[k] = v;
                  s1 += v;
                });
              }
              const T c1 = team.carry(s1, team.s ? team.s->scan1 : nullptr);
              T r1 = c1;
              T s2 = T(0);
              {
                const Run<T> r = run.fresh();
                each_state<REG>(r.ka, r.nf0, [&](int k, bool in, T) {
                  if constexpr (REG) r1 += w[k];
                  else r1 += incr(r, k, in);
                  const T h = Exp<T>::of(-xx_e + r1);
                  const T hk = in && k >= r.kw ? h : T(0);
                  if constexpr (REG) w[k] = hk;
                  s2 += hk;
                });
              }
              T r2 = team.carry(s2, team.s ? team.s->scan2 : nullptr);
              {
                const Run<T> r = run.fresh();
                T r1k = c1;
                each_state<REG>(r.ka, r.nf0, [&](int k, bool in, T nf) {
                  if constexpr (REG) {
                    r2 += w[k];
                  } else {
                    r1k += incr(r, k, in);
                    const T h = Exp<T>::of(-xx_e + r1k);
                    r2 += in && k >= r.kw ? h : T(0);
                  }
                  const T pw = in && k >= r.kw ? p_at(k, nf) : T(0);
                  num[0] += pw * min2(max2(r2, T(0)), T(1));
                });
              }
            }
          }
          team.sum(num, team.s ? team.s->erl : nullptr);
          y = num[0] / max2(p0 + acc[5], Num<T>::tiny());
        }
      }
    }

    const bool conv = within_tol(y, target);
    const bool go_down = (increasing && target < y) || (!increasing && target > y);
    if (go_down) hi = mid; else lo = mid;
    xs = mid;
    done = conv;
  }
  if (t == 0) x_star[row] = xs;
}

// Rows of at most BLOCK_STATES states. Blocks [0, long_blocks) take row
// blockIdx.x with all 128 threads when it is longer than a warp team's;
// the blocks after them take WARP_ROWS rows each, one per warp.
template <typename T, bool TAIL>
__global__ void __launch_bounds__(SMALL_THREADS, SMALL_MIN_BLOCKS<T>) bisect_small(
    const T* __restrict__ fcols, const int* __restrict__ icols,
    const T* __restrict__ clm, T* __restrict__ x_star, int rows,
    int clm_rows, int k_max, int trips, T tail_pct, int long_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch<T, SMALL_THREADS / 32> scratch;
  T* base = reinterpret_cast<T*>(smem_raw);
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int row = blockIdx.x;
    if (team_threads(min(icols[row * NI + I_KOCC], k_max)) != SMALL_THREADS)
      return;
    const Team<T, SMALL_THREADS> team{static_cast<int>(threadIdx.x),
                                      static_cast<int>(threadIdx.x & 31),
                                      static_cast<int>(threadIdx.x >> 5),
                                      &scratch};
    solve_row<T, TAIL>(fcols, icols, clm, x_star, row, clm_rows, k_max, trips,
                       tail_pct, base, base + BLOCK_STATES, team);
  } else {
    const int warp = threadIdx.x >> 5;
    const int row = (blockIdx.x - long_blocks) * WARP_ROWS + warp;
    if (row >= rows || team_threads(min(icols[row * NI + I_KOCC], k_max)) != 32)
      return;
    T* mine = base + warp * WARP_STATES * (TAIL ? 2 : 1);
    const Team<T, 32> team{static_cast<int>(threadIdx.x & 31),
                           static_cast<int>(threadIdx.x & 31), 0, nullptr};
    solve_row<T, TAIL>(fcols, icols, clm, x_star, row, clm_rows, k_max, trips,
                       tail_pct, mine, mine + WARP_STATES, team);
  }
}

// Rows longer than BLOCK_STATES, one LONG_THREADS block each.
template <typename T, bool TAIL>
__global__ void __launch_bounds__(LONG_THREADS) bisect_long(
    const T* __restrict__ fcols, const int* __restrict__ icols,
    const T* __restrict__ clm, T* __restrict__ x_star, int rows,
    int clm_rows, int k_max, int trips, T tail_pct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch<T, LONG_THREADS / 32> scratch;
  T* base = reinterpret_cast<T*>(smem_raw);
  const int row = blockIdx.x;
  if (team_threads(min(icols[row * NI + I_KOCC], k_max)) != LONG_THREADS) return;
  const Team<T, LONG_THREADS> team{static_cast<int>(threadIdx.x),
                                   static_cast<int>(threadIdx.x & 31),
                                   static_cast<int>(threadIdx.x >> 5), &scratch};
  solve_row<T, TAIL>(fcols, icols, clm, x_star, row, clm_rows, k_max, trips,
                     tail_pct, base, base + long_slots(k_max), team);
}

// Dynamic shared memory of each kernel at k_max: every thread's slice of
// clm (and, in the tail form, of log i), whole for the short teams.
template <typename T, bool TAIL>
size_t smem_small(int) {
  static_assert(WARP_ROWS * WARP_STATES == BLOCK_STATES, "one slice size");
  return sizeof(T) * (TAIL ? 2 : 1) * static_cast<size_t>(BLOCK_STATES);
}

template <typename T, bool TAIL>
size_t smem_long(int k_max) {
  if (k_max <= BLOCK_STATES) return 0;
  return sizeof(T) * (TAIL ? 2 : 1) * long_slots(k_max);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= SMEM_OPT_IN) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool TAIL>
int launch(const void* fcols, const void* icols, const void* clm, void* x_star,
           int rows, int clm_rows, int k_max, int trips, double tail_pct,
           void* stream) {
  if (rows <= 0) return 0;
  if (k_max < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* f = static_cast<const T*>(fcols);
  const int* ic = static_cast<const int*>(icols);
  const T* c = static_cast<const T*>(clm);
  T* out = static_cast<T*>(x_star);
  const size_t small = smem_small<T, TAIL>(k_max);
  cudaError_t err = allow_smem(bisect_small<T, TAIL>, small);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int long_blocks = k_max > WARP_STATES ? rows : 0;
  const int grid = long_blocks + (rows + WARP_ROWS - 1) / WARP_ROWS;
  bisect_small<T, TAIL><<<grid, SMALL_THREADS, small, st>>>(
      f, ic, c, out, rows, clm_rows, k_max, trips, static_cast<T>(tail_pct),
      long_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess || k_max <= BLOCK_STATES) return static_cast<int>(err);
  const size_t smem = smem_long<T, TAIL>(k_max);
  err = allow_smem(bisect_long<T, TAIL>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bisect_long<T, TAIL><<<rows, LONG_THREADS, smem, st>>>(
      f, ic, c, out, rows, clm_rows, k_max, trips, static_cast<T>(tail_pct));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int kernel_occupancy(K kernel, int threads, size_t smem, int* blocks_per_sm) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, smem));
}

template <typename T, bool TAIL>
int occupancy(int k_max, int long_team, int* blocks_per_sm) {
  if (long_team)
    return kernel_occupancy(bisect_long<T, TAIL>, LONG_THREADS,
                     smem_long<T, TAIL>(k_max), blocks_per_sm);
  return kernel_occupancy(bisect_small<T, TAIL>, SMALL_THREADS,
                   smem_small<T, TAIL>(k_max), blocks_per_sm);
}

}  // namespace

extern "C" {

int wva_bisect_mean_f32(const void* fcols, const void* icols, const void* clm,
                        void* x_star, int rows, int clm_rows, int k_max,
                        int trips, double tail_pct, void* stream) {
  return launch<float, false>(fcols, icols, clm, x_star, rows, clm_rows, k_max,
                              trips, tail_pct, stream);
}

int wva_bisect_mean_f64(const void* fcols, const void* icols, const void* clm,
                        void* x_star, int rows, int clm_rows, int k_max,
                        int trips, double tail_pct, void* stream) {
  return launch<double, false>(fcols, icols, clm, x_star, rows, clm_rows, k_max,
                               trips, tail_pct, stream);
}

int wva_bisect_tail_f32(const void* fcols, const void* icols, const void* clm,
                        void* x_star, int rows, int clm_rows, int k_max,
                        int trips, double tail_pct, void* stream) {
  return launch<float, true>(fcols, icols, clm, x_star, rows, clm_rows, k_max,
                             trips, tail_pct, stream);
}

int wva_bisect_tail_f64(const void* fcols, const void* icols, const void* clm,
                        void* x_star, int rows, int clm_rows, int k_max,
                        int trips, double tail_pct, void* stream) {
  return launch<double, true>(fcols, icols, clm, x_star, rows, clm_rows, k_max,
                              trips, tail_pct, stream);
}

// Bytes of dynamic shared memory the largest block of a launch at k_max
// takes (at most INT_MAX), or -1 when k_max is not a state count.
int wva_bisect_smem_bytes(int tail, int f64, int k_max) {
  if (k_max < 1) return -1;
  const size_t small = tail ? (f64 ? smem_small<double, true>(k_max)
                                   : smem_small<float, true>(k_max))
                            : (f64 ? smem_small<double, false>(k_max)
                                   : smem_small<float, false>(k_max));
  const size_t lng = tail ? (f64 ? smem_long<double, true>(k_max)
                                 : smem_long<float, true>(k_max))
                          : (f64 ? smem_long<double, false>(k_max)
                                 : smem_long<float, false>(k_max));
  const size_t most = small > lng ? small : lng;
  return most > INT_MAX ? INT_MAX : static_cast<int>(most);
}

// Resident blocks per SM at k_max of the short-team kernel (each block is
// one row of more than WARP_STATES states or WARP_ROWS shorter rows) or,
// with long_team, of the long-team kernel (one row each).
int wva_bisect_occupancy(int tail, int f64, int k_max, int long_team,
                         int* blocks_per_sm) {
  if (k_max < 1) return cudaErrorInvalidValue;
  return tail ? (f64 ? occupancy<double, true>(k_max, long_team, blocks_per_sm)
                     : occupancy<float, true>(k_max, long_team, blocks_per_sm))
              : (f64 ? occupancy<double, false>(k_max, long_team, blocks_per_sm)
                     : occupancy<float, false>(k_max, long_team,
                                               blocks_per_sm));
}

const char* wva_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
