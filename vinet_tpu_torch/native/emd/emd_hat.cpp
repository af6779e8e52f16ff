// emd_hat: Earth Mover's Distance with unmatched-mass penalty, the metric the
// reference computes through FastEMD's MATLAB mex
// (the reference's code_for_Metrics/EMD.m -> emd_hat_gd_metric_mex, algorithm
// described in Pele & Werman, ICCV 2009). This is a fresh implementation of
// the same mathematical objective:
//
//   emd_hat(P, Q, D) = min_F sum_ij F_ij D_ij
//                      s.t. F >= 0, row sums <= P, col sums <= Q,
//                           total flow = min(|P|, |Q|),
//                      + extra_mass_penalty * | |P| - |Q| |
//   (extra_mass_penalty = -1 means max(D))
//
// Solver: transportation problem via successive shortest augmenting paths
// with Johnson potentials (Dijkstra on reduced costs). Two EMD-hat
// accelerations are applied first:
//   * zero-cost diagonal pre-flow: common mass P_i∧Q_i ships bin-to-itself
//     for free (histograms are aligned), shrinking the active problem
//   * optional distance threshold: D_ij := min(D_ij, threshold), which turns
//     far-apart interactions into a constant and is what makes thresholded
//     EMD robust (Pele-Werman); threshold <= 0 disables it.
//
// Exposed with a C ABI and loaded with ctypes (no binding library needed).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

// Mass is integerized (like FastEMD, which computes on integer types): float
// capacities produce subtractive-cancellation "dust" augmentations of ~1e-17
// that make successive shortest paths livelock. Integer capacities guarantee
// every augmentation ships >= 1 unit.
namespace {

using Cap = long long;

struct Edge {
    int to;
    Cap cap;
    double cost;
    int rev;  // index of reverse edge in graph[to]
};

class MinCostFlow {
  public:
    explicit MinCostFlow(int n)
        : graph_(n), potential_(n, 0.0), dist_(n), prev_edge_(n), prev_node_(n), done_(n) {}

    void add_edge(int from, int to, Cap cap, double cost) {
        graph_[from].push_back({to, cap, cost, static_cast<int>(graph_[to].size())});
        graph_[to].push_back({from, 0, -cost, static_cast<int>(graph_[from].size()) - 1});
    }

    // Sends up to max_flow from s to t, returns (flow_sent, total_cost).
    std::pair<Cap, double> solve(int s, int t, Cap max_flow) {
        const double INF = std::numeric_limits<double>::infinity();
        Cap flow = 0;
        double cost = 0.0;
        while (flow < max_flow) {
            // Dijkstra on reduced costs
            std::fill(dist_.begin(), dist_.end(), INF);
            dist_[s] = 0.0;
            using QE = std::pair<double, int>;
            std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
            pq.push({0.0, s});
            std::fill(done_.begin(), done_.end(), 0);
            while (!pq.empty()) {
                auto [d, u] = pq.top();
                pq.pop();
                if (done_[u]) continue;
                done_[u] = 1;  // settled: each node is expanded once
                for (int ei = 0; ei < static_cast<int>(graph_[u].size()); ++ei) {
                    const Edge& e = graph_[u][ei];
                    if (e.cap <= 0 || done_[e.to]) continue;
                    // Reduced costs are >= 0 in exact arithmetic; rounding in
                    // the potentials leaves some at -1e-14 on the zero-cost
                    // residual cycles that augmentations create. Relaxing those
                    // never ends (each lap "improves" a distance), so they are
                    // taken as 0, which changes no path's cost beyond rounding.
                    double nd = d + std::max(0.0, e.cost + potential_[u] - potential_[e.to]);
                    if (nd < dist_[e.to]) {
                        dist_[e.to] = nd;
                        prev_node_[e.to] = u;
                        prev_edge_[e.to] = ei;
                        pq.push({nd, e.to});
                    }
                }
            }
            if (dist_[t] == INF) break;  // no augmenting path
            // Johnson update, capped at dist[t] for unreached/far nodes —
            // otherwise stale potentials create negative reduced costs and
            // Dijkstra degrades into exponential re-relaxation.
            for (size_t v = 0; v < potential_.size(); ++v)
                potential_[v] += std::min(dist_[v], dist_[t]);

            Cap push = max_flow - flow;
            for (int v = t; v != s; v = prev_node_[v])
                push = std::min(push, graph_[prev_node_[v]][prev_edge_[v]].cap);
            for (int v = t; v != s; v = prev_node_[v]) {
                Edge& e = graph_[prev_node_[v]][prev_edge_[v]];
                e.cap -= push;
                graph_[v][e.rev].cap += push;
                cost += static_cast<double>(push) * e.cost;
            }
            flow += push;
        }
        return {flow, cost};
    }

    const std::vector<std::vector<Edge>>& graph() const { return graph_; }

  private:
    std::vector<std::vector<Edge>> graph_;
    std::vector<double> potential_, dist_;
    std::vector<int> prev_edge_, prev_node_;
    std::vector<char> done_;
};

}  // namespace

extern "C" {

// P, Q: histograms of length n (non-negative). D: n*n row-major ground
// distances (D[i*n+j] = cost of moving mass from P bin i to Q bin j).
// extra_mass_penalty: cost per unit of unmatched mass; -1 => max(D).
// threshold: if > 0, distances are clamped to it first.
// flow_out: optional n*n buffer receiving the optimal flow (may be null).
// Returns emd_hat; returns NaN on invalid input.
double emd_hat_compute(const double* P, const double* Q, const double* D, int n,
                       double extra_mass_penalty, double threshold, double* flow_out) {
    if (n <= 0) return std::nan("");
    std::vector<double> p(P, P + n), q(Q, Q + n);
    double sum_p = 0.0, sum_q = 0.0, max_d = 0.0;
    for (int i = 0; i < n; ++i) {
        if (p[i] < 0 || q[i] < 0) return std::nan("");
        sum_p += p[i];
        sum_q += q[i];
    }
    for (int i = 0; i < n * n; ++i) max_d = std::max(max_d, D[i]);
    if (threshold > 0.0) max_d = std::min(max_d, threshold);
    if (extra_mass_penalty < 0.0) extra_mass_penalty = max_d;

    if (flow_out != nullptr) std::memset(flow_out, 0, sizeof(double) * n * n);

    // Integerize mass: MASS_UNITS units == max(|P|,|Q|).
    const double MASS_UNITS = 1e9;
    const double unit = std::max(sum_p, sum_q) / MASS_UNITS;
    if (unit <= 0.0) return std::abs(sum_p - sum_q) * extra_mass_penalty;
    std::vector<Cap> pi(n), qi(n);
    for (int i = 0; i < n; ++i) {
        pi[i] = static_cast<Cap>(std::llround(p[i] / unit));
        qi[i] = static_cast<Cap>(std::llround(q[i] / unit));
    }

    // Zero-cost diagonal pre-flow (aligned histograms: D_ii == 0).
    for (int i = 0; i < n; ++i) {
        if (D[i * n + i] == 0.0) {
            Cap m = std::min(pi[i], qi[i]);
            if (m > 0) {
                pi[i] -= m;
                qi[i] -= m;
                if (flow_out != nullptr) flow_out[i * n + i] += static_cast<double>(m) * unit;
            }
        }
    }

    std::vector<int> srcs, dsts;
    Cap rem_p = 0, rem_q = 0;
    for (int i = 0; i < n; ++i) {
        if (pi[i] > 0) { srcs.push_back(i); rem_p += pi[i]; }
        if (qi[i] > 0) { dsts.push_back(i); rem_q += qi[i]; }
    }
    Cap to_ship = std::min(rem_p, rem_q);
    double penalty = std::abs(sum_p - sum_q) * extra_mass_penalty;
    if (to_ship <= 0) return penalty;

    const int ns = static_cast<int>(srcs.size()), nd = static_cast<int>(dsts.size());
    const int S = ns + nd, T = ns + nd + 1;
    const Cap CAP_INF = std::numeric_limits<Cap>::max() / 4;
    MinCostFlow mcf(ns + nd + 2);
    for (int a = 0; a < ns; ++a) mcf.add_edge(S, a, pi[srcs[a]], 0.0);
    for (int b = 0; b < nd; ++b) mcf.add_edge(ns + b, T, qi[dsts[b]], 0.0);
    for (int a = 0; a < ns; ++a) {
        for (int b = 0; b < nd; ++b) {
            double d = D[srcs[a] * n + dsts[b]];
            if (threshold > 0.0) d = std::min(d, threshold);
            mcf.add_edge(a, ns + b, CAP_INF, d);
        }
    }
    auto [flow, cost] = mcf.solve(S, T, to_ship);
    (void)flow;

    if (flow_out != nullptr) {
        // recover flows: reverse-edge capacities on src->dst arcs
        const auto& g = mcf.graph();
        for (int a = 0; a < ns; ++a) {
            for (const Edge& e : g[a]) {
                if (e.to >= ns && e.to < ns + nd) {
                    double shipped = static_cast<double>(g[e.to][e.rev].cap) * unit;
                    if (shipped > 0.0) flow_out[srcs[a] * n + dsts[e.to - ns]] += shipped;
                }
            }
        }
    }
    return cost * unit + penalty;
}

}  // extern "C"
