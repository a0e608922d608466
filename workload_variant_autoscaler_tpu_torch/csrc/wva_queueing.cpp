// Native state-dependent M/M/1 queueing kernel: analyze + SLO sizing.
//
// Host C++ with a C ABI, a verbatim copy of the reference package's
// native/wva_queueing.cpp from its first include directive on (tests pin the copy
// byte for byte). It mirrors the port's scalar analyzer
// (workload_variant_autoscaler_tpu_torch/ops/{queueing,search,analyzer}.py):
// log-space probability recursion over occupancy K, effective-concurrency
// inversion, monotone binary search with relative tolerance. It is the
// host backend of `System.calculate(backend="native")`, bound by
// ops/native.py and built by ops/_build.py (`host_library`).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libwva_queueing.so wva_queueing.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kEpsilon = 1e-3;              // stable-range disturbance
constexpr double kStabilitySafetyFraction = 0.1;  // TPS sizing margin
constexpr double kTolerance = 1e-6;            // binary-search rel. tolerance
constexpr int kMaxIterations = 100;

struct Params {
  double alpha, beta, gamma, delta;
  int in_tokens, out_tokens, max_batch, occupancy;
};

struct Stats {
  double throughput;        // req/msec
  double avg_num_in_system;
  double avg_num_in_servers;
  double avg_resp_time;     // msec
  double avg_serv_time;     // msec
  double avg_wait_time;     // msec
  double rho;               // 1 - p0
  double p_loss;            // p[K]
};

double prefill_time(const Params& p, double batch) {
  if (p.in_tokens == 0) return 0.0;
  return p.gamma + p.delta * p.in_tokens * batch;
}

double decode_time(const Params& p, double batch) {
  return p.alpha + p.beta * batch;
}

// serv_rate[n-1] for n = 1..max_batch (req/msec)
std::vector<double> service_rates(const Params& p) {
  std::vector<double> rates(p.max_batch);
  double num_decode = p.out_tokens - 1;
  if (p.in_tokens == 0 && p.out_tokens == 1) num_decode = 1.0;
  for (int i = 0; i < p.max_batch; ++i) {
    double n = i + 1;
    double pre = prefill_time(p, n);
    double dec = num_decode * decode_time(p, n);
    rates[i] = n / (pre + dec);
  }
  return rates;
}

// Steady state in log space: logp[n] = n log(lam) - sum_{k<n} log(mu_k),
// shifted by the max and normalised (ops/queueing.py:54-74).
std::vector<double> state_probs(double lam, const std::vector<double>& serv_rate,
                                int K) {
  const int num = static_cast<int>(serv_rate.size());
  std::vector<double> logp(K + 1);
  logp[0] = 0.0;
  double acc = 0.0;
  const double log_lam = std::log(lam);
  for (int n = 0; n < K; ++n) {
    const double mu = serv_rate[std::min(n, num - 1)];
    acc += log_lam - std::log(mu);
    logp[n + 1] = acc;
  }
  const double mx = *std::max_element(logp.begin(), logp.end());
  double total = 0.0;
  std::vector<double> prob(K + 1);
  for (int n = 0; n <= K; ++n) {
    prob[n] = std::exp(logp[n] - mx);
    total += prob[n];
  }
  for (int n = 0; n <= K; ++n) prob[n] /= total;
  return prob;
}

Stats solve(double lam, const std::vector<double>& serv_rate, int K) {
  const int num = static_cast<int>(serv_rate.size());
  std::vector<double> prob = state_probs(lam, serv_rate, K);

  Stats s{};
  double en = 0.0;
  for (int n = 0; n <= K; ++n) en += n * prob[n];
  s.avg_num_in_system = en;

  const int m = std::min(num, K);
  double head = 0.0, head_p = 0.0;
  for (int n = 0; n <= m; ++n) {
    head += n * prob[n];
    head_p += prob[n];
  }
  s.avg_num_in_servers = head + (1.0 - head_p) * num;

  s.p_loss = prob[K];
  s.throughput = lam * (1.0 - s.p_loss);
  if (s.throughput > 0.0) {
    s.avg_resp_time = s.avg_num_in_system / s.throughput;
    s.avg_serv_time = s.avg_num_in_servers / s.throughput;
  }
  s.avg_wait_time = std::max(s.avg_resp_time - s.avg_serv_time, 0.0);
  s.rho = 1.0 - prob[0];
  return s;
}

// Invert prefill(n) + (out-1)*decode(n) = S for n (ops/analyzer.py:131-143).
double effective_concurrency(const Params& p, double avg_service_time) {
  const double tokens = p.out_tokens - 1;
  const double numerator = avg_service_time - (p.gamma + p.alpha * tokens);
  const double denominator = p.delta * p.in_tokens + p.beta * tokens;
  if (denominator == 0.0) return numerator > 0 ? p.max_batch : 0.0;
  return std::min(std::max(numerator / denominator, 0.0),
                  static_cast<double>(p.max_batch));
}

double ttft_at(const Params& p, const std::vector<double>& rates, double lam) {
  Stats s = solve(lam, rates, p.occupancy);
  double conc = effective_concurrency(p, s.avg_serv_time);
  return s.avg_wait_time + prefill_time(p, conc);
}

double itl_at(const Params& p, const std::vector<double>& rates, double lam) {
  Stats s = solve(lam, rates, p.occupancy);
  double conc = effective_concurrency(p, s.avg_serv_time);
  return decode_time(p, conc);
}

// P(TTFT exceeds its percentile budget) at rate lam — the native twin of
// ops/batched.py _tail_problem: prefill at the PERCENTILE of the
// occupancy distribution plus the PASTA/Erlang queueing-wait tail. For
// integer k the Erlang survival is the partial Poisson sum
// Q(k, x) = e^-x sum_{i<k} x^i/i!, advanced by one term per state — the
// whole mixture costs O(K), no special functions.
double ttft_tail_at(const Params& p, const std::vector<double>& rates,
                    double lam, double slo_ttft, double percentile) {
  const int K = p.occupancy;
  const int N = p.max_batch;
  std::vector<double> prob = state_probs(lam, rates, K);

  // occupancy percentile: #states whose cumulative prob stays below pct
  double cum = 0.0;
  int nq = 0;
  for (int n = 0; n <= K; ++n) {
    cum += prob[n];
    if (cum < percentile) nq = n + 1;
  }
  const double bq = std::min(nq, N);
  const double prefill_q = prefill_time(p, bq);
  if (prefill_q >= slo_ttft) return 1.0;
  const double threshold = slo_ttft - prefill_q;

  double den = 0.0;  // accepted arrivals: states < K (state K is blocked)
  for (int n = 0; n < K; ++n) den += prob[n];
  if (den <= 0.0) return 0.0;

  const double mu_n = rates.back();        // full-batch departure rate
  const double x = mu_n * threshold;
  double num_sum = 0.0;
  if (x <= 0.0) {
    for (int n = N; n < K; ++n) num_sum += prob[n];  // Q(k, 0) = 1
  } else {
    const double log_x = std::log(x);
    double log_term = -x;  // log(e^-x x^0 / 0!)
    double q = 0.0;        // Q(0, x) = 0
    int k = 0;
    for (int n = N; n < K; ++n) {
      while (k < n - N + 1) {
        q += std::exp(log_term);
        ++k;
        log_term += log_x - std::log(static_cast<double>(k));
      }
      num_sum += prob[n] * std::min(q, 1.0);
    }
  }
  return num_sum / den;
}

bool within_tolerance(double x, double value) {
  if (x == value) return true;
  if (value == 0.0) return false;
  return std::fabs((x - value) / value) <= kTolerance;
}

enum Region { kBelow = -1, kIn = 0, kAbove = 1 };

struct SearchResult {
  double x_star;
  Region indicator;
};

// Monotone bisection with boundary/region semantics (ops/search.py:39-81).
// force_increasing: a tail probability can be 0 at BOTH boundaries, which
// would mis-infer 'decreasing' and brand an always-satisfiable lane
// infeasible (same guard as ops/batched.py _assemble_problem).
template <typename F>
SearchResult binary_search(double x_min, double x_max, double y_target, F eval,
                           bool force_increasing = false) {
  const double y_lo = eval(x_min);
  if (within_tolerance(y_lo, y_target)) return {x_min, kIn};
  const double y_hi = eval(x_max);
  if (within_tolerance(y_hi, y_target)) return {x_max, kIn};

  const bool increasing = force_increasing || y_lo < y_hi;
  if ((increasing && y_target < y_lo) || (!increasing && y_target > y_lo))
    return {x_min, kBelow};
  if ((increasing && y_target > y_hi) || (!increasing && y_target < y_hi))
    return {x_max, kAbove};

  double x_star = 0.5 * (x_min + x_max);
  for (int i = 0; i < kMaxIterations; ++i) {
    x_star = 0.5 * (x_min + x_max);
    const double y_star = eval(x_star);
    if (within_tolerance(y_star, y_target)) break;
    if ((increasing && y_target < y_star) || (!increasing && y_target > y_star))
      x_max = x_star;
    else
      x_min = x_star;
  }
  return {x_star, kIn};
}

void fill_metrics(const Params& p, const std::vector<double>& rates,
                  double lam, double lambda_max, double* out) {
  Stats s = solve(lam, rates, p.occupancy);
  const double conc = effective_concurrency(p, s.avg_serv_time);
  out[0] = s.throughput * 1000.0;                       // req/sec
  out[1] = s.avg_resp_time;                             // msec
  out[2] = s.avg_wait_time;                             // msec
  out[3] = s.avg_num_in_servers;
  out[4] = prefill_time(p, conc);                       // msec
  out[5] = decode_time(p, conc);                        // msec (ITL)
  out[6] = lambda_max * 1000.0;                         // max rate req/sec
  out[7] = std::clamp(s.avg_num_in_servers / p.max_batch, 0.0, 1.0);  // rho
}

}  // namespace

extern "C" {

// stats_out: [throughput_rps, resp_ms, wait_ms, num_in_serv, prefill_ms,
//            itl_ms, max_rate_rps, rho]. Returns 0 ok, -1 invalid input,
// -2 rate above the stable range.
int wva_analyze(double alpha, double beta, double gamma, double delta,
                int32_t in_tokens, int32_t out_tokens, int32_t max_batch,
                int32_t occupancy, double rate_rps, double* stats_out) {
  if (max_batch <= 0 || out_tokens < 1 || in_tokens < 0 || rate_rps <= 0)
    return -1;
  Params p{alpha, beta, gamma, delta, in_tokens, out_tokens, max_batch,
           occupancy};
  auto rates = service_rates(p);
  const double lambda_max = rates.back() * (1.0 - kEpsilon);
  if (rate_rps > lambda_max * 1000.0) return -2;
  fill_metrics(p, rates, rate_rps / 1000.0, lambda_max, stats_out);
  return 0;
}

// out: [rate_ttft_rps, rate_itl_rps, rate_tps_rps, then the 8 metric slots
// at the binding rate]. Targets <= 0 are disabled. Returns 0 ok,
// 1 TTFT infeasible, 2 ITL infeasible, -1 invalid input.
int wva_size(double alpha, double beta, double gamma, double delta,
             int32_t in_tokens, int32_t out_tokens, int32_t max_batch,
             int32_t occupancy, double ttft_target, double itl_target,
             double tps_target, double* out) {
  if (max_batch <= 0 || out_tokens < 1 || in_tokens < 0) return -1;
  Params p{alpha, beta, gamma, delta, in_tokens, out_tokens, max_batch,
           occupancy};
  auto rates = service_rates(p);
  const double lambda_min = rates.front() * kEpsilon;
  const double lambda_max = rates.back() * (1.0 - kEpsilon);

  double lam_ttft = lambda_max;
  if (ttft_target > 0) {
    auto r = binary_search(lambda_min, lambda_max, ttft_target,
                           [&](double x) { return ttft_at(p, rates, x); });
    if (r.indicator == kBelow) return 1;
    lam_ttft = r.x_star;
  }
  double lam_itl = lambda_max;
  if (itl_target > 0) {
    auto r = binary_search(lambda_min, lambda_max, itl_target,
                           [&](double x) { return itl_at(p, rates, x); });
    if (r.indicator == kBelow) return 2;
    lam_itl = r.x_star;
  }
  double lam_tps = lambda_max;
  if (tps_target > 0) lam_tps = lambda_max * (1.0 - kStabilitySafetyFraction);

  const double lam = std::min({lam_ttft, lam_itl, lam_tps});
  out[0] = lam_ttft * 1000.0;
  out[1] = lam_itl * 1000.0;
  out[2] = lam_tps * 1000.0;
  fill_metrics(p, rates, lam, lambda_max, out + 3);
  return 0;
}

// Batched sizing: n independent candidates, arrays of length n per
// parameter; out is n x 11 row-major. Infeasible candidates get
// feasible_out[i] = 0 and zeroed rows. OpenMP-free (deterministic, small n).
void wva_size_batch(const double* alpha, const double* beta,
                    const double* gamma, const double* delta,
                    const int32_t* in_tokens, const int32_t* out_tokens,
                    const int32_t* max_batch, const int32_t* occupancy,
                    const double* ttft, const double* itl, const double* tps,
                    int32_t n, double* out, int32_t* feasible_out) {
  for (int32_t i = 0; i < n; ++i) {
    int rc = wva_size(alpha[i], beta[i], gamma[i], delta[i], in_tokens[i],
                      out_tokens[i], max_batch[i], occupancy[i], ttft[i],
                      itl[i], tps[i], out + 11 * i);
    feasible_out[i] = rc == 0 ? 1 : 0;
    if (rc != 0)
      for (int k = 0; k < 11; ++k) out[11 * i + k] = 0.0;
  }
}

// Percentile-aware sizing (ops/batched.py size_batch_tail, natively): the
// TTFT lane holds P(TTFT > slo) <= 1 - ttft_percentile instead of the
// mean. Same out layout as wva_size.
int wva_size_tail(double alpha, double beta, double gamma, double delta,
                  int32_t in_tokens, int32_t out_tokens, int32_t max_batch,
                  int32_t occupancy, double ttft_target, double itl_target,
                  double tps_target, double ttft_percentile, double* out) {
  if (max_batch <= 0 || out_tokens < 1 || in_tokens < 0) return -1;
  if (!(ttft_percentile > 0.0 && ttft_percentile < 1.0)) return -1;
  Params p{alpha, beta, gamma, delta, in_tokens, out_tokens, max_batch,
           occupancy};
  auto rates = service_rates(p);
  const double lambda_min = rates.front() * kEpsilon;
  const double lambda_max = rates.back() * (1.0 - kEpsilon);

  double lam_ttft = lambda_max;
  if (ttft_target > 0) {
    auto r = binary_search(
        lambda_min, lambda_max, 1.0 - ttft_percentile,
        [&](double x) {
          return ttft_tail_at(p, rates, x, ttft_target, ttft_percentile);
        },
        /*force_increasing=*/true);
    if (r.indicator == kBelow) return 1;
    lam_ttft = r.x_star;
  }
  double lam_itl = lambda_max;
  if (itl_target > 0) {
    auto r = binary_search(lambda_min, lambda_max, itl_target,
                           [&](double x) { return itl_at(p, rates, x); });
    if (r.indicator == kBelow) return 2;
    lam_itl = r.x_star;
  }
  double lam_tps = lambda_max;
  if (tps_target > 0) lam_tps = lambda_max * (1.0 - kStabilitySafetyFraction);

  const double lam = std::min({lam_ttft, lam_itl, lam_tps});
  out[0] = lam_ttft * 1000.0;
  out[1] = lam_itl * 1000.0;
  out[2] = lam_tps * 1000.0;
  fill_metrics(p, rates, lam, lambda_max, out + 3);
  return 0;
}

void wva_size_tail_batch(const double* alpha, const double* beta,
                         const double* gamma, const double* delta,
                         const int32_t* in_tokens, const int32_t* out_tokens,
                         const int32_t* max_batch, const int32_t* occupancy,
                         const double* ttft, const double* itl,
                         const double* tps, double ttft_percentile, int32_t n,
                         double* out, int32_t* feasible_out) {
  for (int32_t i = 0; i < n; ++i) {
    int rc = wva_size_tail(alpha[i], beta[i], gamma[i], delta[i],
                           in_tokens[i], out_tokens[i], max_batch[i],
                           occupancy[i], ttft[i], itl[i], tps[i],
                           ttft_percentile, out + 11 * i);
    feasible_out[i] = rc == 0 ? 1 : 0;
    if (rc != 0)
      for (int k = 0; k < 11; ++k) out[11 * i + k] = 0.0;
  }
}

}  // extern "C"
