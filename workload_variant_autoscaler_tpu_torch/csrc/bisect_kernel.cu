// SLO-sizing bisection over the state-dependent M/M/1/K queue, for Hopper.
//
// Replaces the TPU kernel `_bisect_kernel` of the reference package's
// ops/pallas_kernel.py (launched by `_run_bisect_kernel`), in both of its
// forms: the mean form (TTFT or ITL mean target) and the tail form (TTFT
// held at a percentile through the Erlang-mixture wait tail).
//
// Layout. One thread block per row (one bisection), BLOCK threads. The
// row's prefix log service rates `clm` are loaded once into shared memory
// and stay there for every trip, as VMEM residency did on the TPU; the
// trip loop runs inside the kernel, and a block stops as soon as its row
// is frozen (a frozen x_star never changes again, so the result is the
// full trip count's). Each trip is one max reduction and one fused
// five-way sum reduction (warp shuffles, then shared memory). The tail
// form adds block-wide inclusive scans, walked tile by tile with a
// carried prefix, and keeps p and Q(k, x) in shared memory so the
// alignment by N-1 is a read at n - N.
//
// Lane independence. A row's result depends only on its own values: a
// thread walks states j = tid, tid + BLOCK, ... up to the row's own
// occupancy (never the grid width k_max), and the scans carry from tile
// to tile, so the same row gives the same bits in any batch and under
// any k_max bucket.
//
// What bounds it on this card: per valid state and trip, one exp (the
// special-function units) and about ten flops; `clm` is read from device
// memory once. So it is bound by compute (SFU and FP32), not by memory.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (ops/_build.py), called through ctypes
// from ops/bisect_kernel.py, whose plain PyTorch version
// (`bisect_plain`) is the same computation.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cfloat>
#include <cstddef>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
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

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

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

// Block max; every thread returns the same value.
template <typename T>
__device__ T block_max(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = max2(v, __shfl_xor_sync(FULL_MASK, v, o));
  __syncthreads();  // earlier readers of scratch are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = scratch[0];
  for (int w = 1; w < WARPS; ++w) m = max2(m, scratch[w]);
  return m;
}

// Block sum of NV values at once; scratch holds WARPS * NV values. Every
// thread sums the warp partials in the same order, so all threads return
// the same bits.
template <typename T, int NV>
__device__ void block_sum(T (&v)[NV], T* scratch) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(FULL_MASK, v[i], o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) scratch[(threadIdx.x >> 5) * NV + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T s = scratch[i];
    for (int w = 1; w < WARPS; ++w) s += scratch[w * NV + i];
    v[i] = s;
  }
}

// Inclusive scan of one BLOCK-wide tile: returns this thread's prefix and
// sets `total` to the tile's sum (the same bits in every thread).
template <typename T>
__device__ T block_scan(T v, T* scratch, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  T pre = T(0);
  for (int w = 0; w < warp; ++w) pre += scratch[w];
  T tot = T(0);
  for (int w = 0; w < WARPS; ++w) tot += scratch[w];
  total = tot;
  return pre + v;
}

template <typename T>
__device__ __forceinline__ bool within_tol(T y, T target) {
  if (y == target) return true;
  if (target == T(0)) return false;
  T r = (y - target) / target;
  r = r < T(0) ? -r : r;
  return r <= T(1e-6);  // ops/search.py TOLERANCE
}

template <typename T, bool TAIL>
__global__ void __launch_bounds__(BLOCK) bisect_kernel(
    const T* __restrict__ fcols, const int* __restrict__ icols,
    const T* __restrict__ clm, T* __restrict__ x_star,
    int clm_rows, int k_max, int trips, T tail_pct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* clm_s = reinterpret_cast<T*>(smem_raw);
  T* p_s = clm_s + k_max;   // tail form: p_n of the current trip
  T* q_s = p_s + k_max;     // tail form: Q(k+1, x), k = 0..
  __shared__ T red[WARPS * 5];
  __shared__ T scan_s[WARPS];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* f = fcols + static_cast<size_t>(row) * (TAIL ? NF_TAIL : NF_MEAN);
  const int* ic = icols + static_cast<size_t>(row) * NI;
  const T alpha = f[F_ALPHA], beta = f[F_BETA], gamma = f[F_GAMMA];
  const T delta = f[F_DELTA], in_tok = f[F_IN], out_tok = f[F_OUT];
  const T target = f[F_TARGET];
  const int n_max = ic[I_NMAX];
  const int k_occ = ic[I_KOCC];
  const bool is_ttft = ic[I_TTFT] > 0;
  const bool increasing = ic[I_INC] > 0;
  bool done = ic[I_DONE] > 0;
  T lo = f[F_LO], hi = f[F_HI], xs = f[F_X0];
  const T n_max_f = static_cast<T>(n_max);
  const int n_top = min(k_occ, k_max);   // states 1..n_top are in range
  const T* clm_row = clm + static_cast<size_t>(row % clm_rows) * k_max;

  for (int j = tid; j < n_top; j += BLOCK) clm_s[j] = clm_row[j];
  __syncthreads();

  for (int trip = 0; trip < trips && !done; ++trip) {
    const T mid = T(0.5) * (lo + hi);
    const T lm = lg(mid);

    // steady state at rate mid: logp[n] = n log(mid) - clm[n-1]
    T mx = Num<T>::neg_inf();
    for (int j = tid; j < n_top; j += BLOCK)
      mx = max2(mx, lm * static_cast<T>(j + 1) - clm_s[j]);
    const T m = max2(block_max(mx, scan_s), T(0));

    // sum p, sum n p, head n p, head p, p at K
    T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
    for (int j = tid; j < n_top; j += BLOCK) {
      const int n = j + 1;
      const T nf = static_cast<T>(n);
      const T p = ex((lm * nf - clm_s[j]) - m);
      acc[0] += p;
      acc[1] += nf * p;
      if (n <= n_max) {
        acc[2] += nf * p;
        acc[3] += p;
      }
      if (n == k_occ) acc[4] += p;
      if (TAIL) p_s[j] = p;
    }
    block_sum<T, 5>(acc, red);

    const T p0 = ex(-m);
    const T z = p0 + acc[0];
    const T avg_n = acc[1] / z;
    const T head_np = acc[2] / z;
    const T head_p = (p0 + acc[3]) / z;
    const T in_serv = head_np + (T(1) - head_p) * n_max_f;
    const T p_k = acc[4] / z;
    const T x = mid * (T(1) - p_k);
    const bool pos = x > T(0);
    const T safe_x = pos ? x : T(1);
    const T t = pos ? avg_n / safe_x : T(0);
    const T s = pos ? in_serv / safe_x : T(0);
    const T w = max2(t - s, T(0));

    // effective concurrency inversion, then TTFT / ITL
    const T tokens = out_tok - T(1);
    const T numer = s - (gamma + alpha * tokens);
    const T denom = delta * in_tok + beta * tokens;
    T conc = denom != T(0) ? numer / denom : (numer > T(0) ? n_max_f : T(0));
    conc = min2(max2(conc, T(0)), n_max_f);
    const T pre = in_tok > T(0) ? gamma + delta * in_tok * conc : T(0);
    const T ttft = w + pre;
    const T itl = alpha + beta * conc;

    T y = is_ttft ? ttft : itl;
    if (TAIL && is_ttft) {
      const T tail_z = tail_pct * z;
      // occupancy quantile: states whose CDF is below pct * z (state 0
      // counts through p0)
      T cnt[1] = {T(0)};
      T carry = T(0);
      for (int base = 0; base < n_top; base += BLOCK) {
        const int j = base + tid;
        T tot;
        const T inc = block_scan(j < n_top ? p_s[j] : T(0), scan_s, tot);
        if (j < n_top && p0 + (carry + inc) < tail_z) cnt[0] += T(1);
        carry += tot;
      }
      block_sum<T, 1>(cnt, red);
      const T nq = (p0 < tail_z ? T(1) : T(0)) + cnt[0];
      const T bq = min2(nq, n_max_f);
      const T slo = f[F_SLO];
      const T prefill_q = in_tok > T(0) ? gamma + delta * in_tok * bq : T(0);
      const T threshold = max2(slo - prefill_q, T(0));
      const T xx = f[F_MUN] * threshold;
      const T safe_xx = max2(xx, Num<T>::tiny());
      const T lx = lg(safe_xx);

      // Q(k, x) for every k: a scan of small log increments, exp, then a
      // second scan; only the indices the waiting states read
      const int n_wait = min(k_occ - 1, n_top) - n_max + 1;
      T carry1 = T(0), carry2 = T(0);
      for (int base = 0; base < n_wait; base += BLOCK) {
        const int i = base + tid;
        const T incr = i >= 1 ? lx - lg(static_cast<T>(i)) : T(0);
        T tot1;
        const T log_term = -safe_xx + (carry1 + block_scan(incr, scan_s, tot1));
        carry1 += tot1;
        T tot2;
        const T qc = carry2 + block_scan(ex(log_term), scan_s, tot2);
        carry2 += tot2;
        if (i < n_wait) q_s[i] = min2(max2(qc, T(0)), T(1));
      }
      __syncthreads();

      // Erlang mixture: P(W > threshold | accepted)
      T nd[2] = {T(0), T(0)};   // waiting p * Q, accepted p
      for (int j = tid; j < n_top; j += BLOCK) {
        const int n = j + 1;
        if (n < k_occ) {
          const T p = p_s[j];
          nd[1] += p;
          if (n >= n_max) nd[0] += p * (xx <= T(0) ? T(1) : q_s[n - n_max]);
        }
      }
      block_sum<T, 2>(nd, red);
      const T den = p0 + nd[1];
      y = prefill_q >= slo ? T(1) : nd[0] / max2(den, Num<T>::tiny());
    }

    const bool conv = within_tol(y, target);
    const bool go_down = (increasing && target < y) || (!increasing && target > y);
    if (go_down) hi = mid; else lo = mid;
    xs = mid;
    done = conv;
  }
  if (tid == 0) x_star[row] = xs;
}

template <typename T, bool TAIL>
int launch(const void* fcols, const void* icols, const void* clm, void* x_star,
           int rows, int clm_rows, int k_max, int trips, double tail_pct,
           void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = static_cast<size_t>(k_max) * sizeof(T) * (TAIL ? 3 : 1);
  if (smem > SMEM_OPT_IN) {
    const cudaError_t err = cudaFuncSetAttribute(
        bisect_kernel<T, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bisect_kernel<T, TAIL><<<rows, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fcols), static_cast<const int*>(icols),
      static_cast<const T*>(clm), static_cast<T*>(x_star), clm_rows, k_max,
      trips, static_cast<T>(tail_pct));
  return static_cast<int>(cudaGetLastError());
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

const char* wva_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
