// Native K-open first-fit-decreasing packer: the host half of the
// port's provisioning solve (a copy of karpenter_core_tpu/native/pack.cc).
//
// Exact per-pod mirror of the JAX package's device scan
// (karpenter_core_tpu/solver/pack.py::ffd_pack, itself the tensorized
// Scheduler.add loop, scheduler.go:238-285):
//   - pods arrive sorted descending; each goes to the open slot with the
//     fewest pods (ties to the oldest claim) whose accumulated usage
//     still fits under some Pareto-frontier allocatable point
//     (scheduler.go:247-254 "fewest pods first"),
//   - when none fits but a fresh node would, the slot with the least
//     primary-axis headroom is closed and a new node opens,
//   - pods that fit no frontier point emit node_id = -1.
//
// Why native: the pack is inherently sequential scalar work (each pod's
// placement depends on every prior placement), ~500 int ops per pod in
// C++. The card computes the signature x type masks; this packer owns
// the serial tail. Built by native/__init__.py (g++ -O3) into the
// port's build directory and loaded with ctypes.

#include <cstdint>
#include <vector>

extern "C" {

// requests: (P, R) int32 row-major, pre-sorted descending by primary.
// frontier: (F, R) int32 Pareto-maximal allocatable vectors.
// node_ids_out: (P,) int32, -1 => unschedulable.
// Returns the number of nodes opened.
int32_t ffd_pack_native(const int32_t* requests, int64_t P, int64_t R,
                        const int32_t* frontier, int64_t F,
                        int32_t max_pods_per_node, int32_t k_open,
                        int32_t* node_ids_out) {
  const int64_t K = k_open;
  std::vector<int64_t> usage(K * R, 0);
  std::vector<int64_t> count(K, 0);
  std::vector<int64_t> node_id(K, -1);
  int32_t next_id = 0;

  // frontier max on the primary axis, for eviction headroom
  int64_t fmax0 = 0;
  for (int64_t f = 0; f < F; ++f) {
    if (frontier[f * R] > fmax0) fmax0 = frontier[f * R];
  }

  for (int64_t p = 0; p < P; ++p) {
    const int32_t* req = requests + p * R;

    // best fitting slot: fewest pods, ties to oldest claim. The order
    // score replicates the device scan's float32 arithmetic exactly
    // (pack.py: count.f32 + node_id.f32 * 1e-7, first-min argmin) so the
    // two engines stay bit-identical even where f32 rounding collapses
    // nearby node ids.
    int64_t best_k = -1;
    float best_order = 0.0f;
    for (int64_t k = 0; k < K; ++k) {
      if (node_id[k] < 0 || count[k] >= max_pods_per_node) continue;
      const int64_t* u = usage.data() + k * R;
      bool fits = false;
      for (int64_t f = 0; f < F && !fits; ++f) {
        const int32_t* fr = frontier + f * R;
        bool ok = true;
        for (int64_t r = 0; r < R; ++r) {
          if (u[r] + req[r] > fr[r]) { ok = false; break; }
        }
        fits = ok;
      }
      if (!fits) continue;
      float order = static_cast<float>(count[k]) +
                    static_cast<float>(node_id[k]) * 1e-7f;
      if (best_k < 0 || order < best_order) {
        best_k = k;
        best_order = order;
      }
    }

    if (best_k >= 0) {
      int64_t* u = usage.data() + best_k * R;
      for (int64_t r = 0; r < R; ++r) u[r] += req[r];
      count[best_k] += 1;
      node_ids_out[p] = static_cast<int32_t>(node_id[best_k]);
      continue;
    }

    // fresh-node feasibility
    bool fresh = false;
    for (int64_t f = 0; f < F && !fresh; ++f) {
      const int32_t* fr = frontier + f * R;
      bool ok = true;
      for (int64_t r = 0; r < R; ++r) {
        if (req[r] > fr[r]) { ok = false; break; }
      }
      fresh = ok;
    }
    if (!fresh) {
      node_ids_out[p] = -1;
      continue;
    }

    // slot to (re)use: first inactive, else least primary headroom
    int64_t k_new = -1;
    for (int64_t k = 0; k < K; ++k) {
      if (node_id[k] < 0) { k_new = k; break; }
    }
    if (k_new < 0) {
      int64_t best_head = INT64_MAX;
      for (int64_t k = 0; k < K; ++k) {
        int64_t head = fmax0 - usage[k * R];
        if (head < best_head) { best_head = head; k_new = k; }
      }
    }
    int64_t* u = usage.data() + k_new * R;
    for (int64_t r = 0; r < R; ++r) u[r] = req[r];
    count[k_new] = 1;
    node_id[k_new] = next_id;
    node_ids_out[p] = next_id;
    ++next_id;
  }
  return next_id;
}

// First-fit onto EXISTING nodes in fixed order — the reference tries
// in-flight/real nodes before opening any new claim (scheduler.go:
// 241-246, existingnode.go:64-120), in initialized-then-name order.
// requests: (P, R) int32, pre-sorted descending by primary axis.
// sig_ids: (P,) int32 signature-group index per pod.
// compat: (S, M) uint8 — signature x node admissibility (taints
//   tolerated + node labels satisfy the pod's requirements).
// free_caps: (M, R) int32 remaining capacity, MUTATED in place.
// assign_out: (P,) int32 node index or -1 (pod left for new-node pack).
// Returns the number of pods assigned.
int64_t pack_existing_native(const int32_t* requests, int64_t P, int64_t R,
                             const int32_t* sig_ids, const uint8_t* compat,
                             int64_t S, int32_t* free_caps, int64_t M,
                             int32_t* assign_out) {
  (void)S;
  int64_t assigned = 0;
  for (int64_t p = 0; p < P; ++p) {
    const int32_t* req = requests + p * R;
    const uint8_t* row = compat + static_cast<int64_t>(sig_ids[p]) * M;
    int64_t chosen = -1;
    for (int64_t m = 0; m < M; ++m) {
      if (!row[m]) continue;
      int32_t* f = free_caps + m * R;
      if (f[0] < req[0]) continue;  // cheap primary-axis reject
      bool ok = true;
      for (int64_t r = 1; r < R; ++r) {
        if (req[r] > f[r]) { ok = false; break; }
      }
      if (!ok) continue;
      for (int64_t r = 0; r < R; ++r) f[r] -= req[r];
      chosen = m;
      break;
    }
    assign_out[p] = static_cast<int32_t>(chosen);
    if (chosen >= 0) ++assigned;
  }
  return assigned;
}

// Cheapest viable instance type per packed node
// (fake/cloudprovider.go:105-110 launch decision): for each node's
// summed usage, the min-price type whose allocatable holds it.
// usage: (N, R) int64; allocatable: (T, R) int32; prices: (T,) double.
// out: (N,) int32 type index, -1 if none fits.
void cheapest_types_native(const int64_t* usage, int64_t N, int64_t R,
                           const int32_t* allocatable, int64_t T,
                           const double* prices, int32_t* out) {
  for (int64_t n = 0; n < N; ++n) {
    const int64_t* u = usage + n * R;
    double best_price = 0;
    int64_t best_t = -1;
    for (int64_t t = 0; t < T; ++t) {
      const int32_t* a = allocatable + t * R;
      bool ok = true;
      for (int64_t r = 0; r < R; ++r) {
        if (u[r] > a[r]) { ok = false; break; }
      }
      if (!ok) continue;
      if (best_t < 0 || prices[t] < best_price) {
        best_t = t;
        best_price = prices[t];
      }
    }
    out[n] = static_cast<int32_t>(best_t);
  }
}

}  // extern "C"
