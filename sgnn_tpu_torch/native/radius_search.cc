// Host-side fixed-radius neighbor search (cell list), C++ core.
//
// The PyTorch port's own copy of the host-side search: the reference
// outsources its neighbor search to the torch_cluster C++/CUDA extension
// (learned_simulator.py:116, multi_scale_graph.py:222); here the
// *device-side* searches are the port's (sgnn_tpu_torch/ops/neighbors.py)
// and this C++ path serves the host-side users — the multi-scale static-graph builder
// (one graph per trajectory at load time) and the dataset builder's
// max-degree scan — where a tight native loop beats numpy/scipy by an order
// of magnitude and avoids any torch/scipy dependency.
//
// Semantics match the reference exactly (SURVEY.md §2.2): strict dist < r,
// optional self loops, per-receiver cap keeping the lowest sender indices.
//
// Build: python -m sgnn_tpu_torch.native.build   (g++ -O3 -shared -fPIC,
// into build/native/)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct CellGrid {
  float lo[3];
  float inv_cell;
  int dims;
  int shape[3];
  std::vector<int> cell_start;  // size ncells+1
  std::vector<int> order;       // particle indices sorted by cell

  int64_t cell_of(const float* p) const {
    int64_t id = 0;
    for (int d = 0; d < dims; ++d) {
      int c = static_cast<int>(std::floor((p[d] - lo[d]) * inv_cell));
      c = std::max(0, std::min(shape[d] - 1, c));
      id = id * shape[d] + c;
    }
    return id;
  }
};

void build_grid(const float* pos, int n, int dims, float cell, CellGrid* g) {
  g->dims = dims;
  g->inv_cell = 1.0f / cell;
  float hi[3];
  for (int d = 0; d < dims; ++d) {
    g->lo[d] = pos[d];
    hi[d] = pos[d];
  }
  for (int i = 1; i < n; ++i)
    for (int d = 0; d < dims; ++d) {
      g->lo[d] = std::min(g->lo[d], pos[i * dims + d]);
      hi[d] = std::max(hi[d], pos[i * dims + d]);
    }
  int64_t ncells = 1;
  for (int d = 0; d < dims; ++d) {
    g->shape[d] = std::max(1, static_cast<int>(std::ceil((hi[d] - g->lo[d]) * g->inv_cell)) + 1);
    ncells *= g->shape[d];
  }
  std::vector<int> counts(ncells + 1, 0);
  std::vector<int64_t> cid(n);
  for (int i = 0; i < n; ++i) {
    cid[i] = g->cell_of(pos + i * dims);
    counts[cid[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  g->cell_start = counts;
  g->order.resize(n);
  std::vector<int> cursor(counts.begin(), counts.end() - 1);
  for (int i = 0; i < n; ++i) g->order[cursor[cid[i]]++] = i;
}

}  // namespace

extern "C" {

// Fills senders/receivers (capacity n*max_neighbors each); returns edge count.
// Neighbor lists per receiver are ascending in sender index; when more than
// max_neighbors candidates exist, the lowest indices win (reference cap rule).
int64_t radius_search(const float* pos, int n, int dims, float radius,
                      int max_neighbors, int include_self,
                      int32_t* senders, int32_t* receivers) {
  if (n == 0 || dims < 1 || dims > 3) return 0;
  CellGrid g;
  build_grid(pos, n, dims, radius, &g);
  const float r2 = radius * radius;
  int64_t e = 0;
  std::vector<int> nbrs;
  nbrs.reserve(64);

  for (int i = 0; i < n; ++i) {
    const float* pi = pos + i * dims;
    nbrs.clear();
    int base[3];
    for (int d = 0; d < dims; ++d) {
      base[d] = static_cast<int>(std::floor((pi[d] - g.lo[d]) * g.inv_cell));
    }
    int lo_d[3], hi_d[3];
    for (int d = 0; d < dims; ++d) {
      lo_d[d] = std::max(0, base[d] - 1);
      hi_d[d] = std::min(g.shape[d] - 1, base[d] + 1);
    }
    int c[3] = {lo_d[0], dims > 1 ? lo_d[1] : 0, dims > 2 ? lo_d[2] : 0};
    while (true) {
      int64_t id = 0;
      for (int d = 0; d < dims; ++d) id = id * g.shape[d] + c[d];
      for (int s = g.cell_start[id]; s < g.cell_start[id + 1]; ++s) {
        int j = g.order[s];
        if (!include_self && j == i) continue;
        float d2 = 0;
        const float* pj = pos + j * dims;
        for (int d = 0; d < dims; ++d) {
          float dd = pj[d] - pi[d];
          d2 += dd * dd;
        }
        if (d2 < r2) nbrs.push_back(j);
      }
      // advance odometer over the 3^dims cell window
      int d = dims - 1;
      while (d >= 0) {
        if (++c[d] <= hi_d[d]) break;
        c[d] = lo_d[d];
        --d;
      }
      if (d < 0) break;
    }
    std::sort(nbrs.begin(), nbrs.end());
    int keep = std::min<int>(nbrs.size(), max_neighbors);
    for (int k = 0; k < keep; ++k) {
      senders[e] = nbrs[k];
      receivers[e] = i;
      ++e;
    }
  }
  return e;
}

// Max real degree over the dataset (for adaptive neighbor_slots sizing).
int32_t max_degree(const float* pos, int n, int dims, float radius,
                   int include_self) {
  if (n == 0) return 0;
  CellGrid g;
  build_grid(pos, n, dims, radius, &g);
  const float r2 = radius * radius;
  int32_t best = 0;
  for (int i = 0; i < n; ++i) {
    const float* pi = pos + i * dims;
    int deg = 0;
    int base[3];
    for (int d = 0; d < dims; ++d)
      base[d] = static_cast<int>(std::floor((pi[d] - g.lo[d]) * g.inv_cell));
    int lo_d[3], hi_d[3];
    for (int d = 0; d < dims; ++d) {
      lo_d[d] = std::max(0, base[d] - 1);
      hi_d[d] = std::min(g.shape[d] - 1, base[d] + 1);
    }
    int c[3] = {lo_d[0], dims > 1 ? lo_d[1] : 0, dims > 2 ? lo_d[2] : 0};
    while (true) {
      int64_t id = 0;
      for (int d = 0; d < dims; ++d) id = id * g.shape[d] + c[d];
      for (int s = g.cell_start[id]; s < g.cell_start[id + 1]; ++s) {
        int j = g.order[s];
        if (!include_self && j == i) continue;
        float d2 = 0;
        const float* pj = pos + j * dims;
        for (int d = 0; d < dims; ++d) {
          float dd = pj[d] - pi[d];
          d2 += dd * dd;
        }
        if (d2 < r2) ++deg;
      }
      int d = dims - 1;
      while (d >= 0) {
        if (++c[d] <= hi_d[d]) break;
        c[d] = lo_d[d];
        --d;
      }
      if (d < 0) break;
    }
    best = std::max(best, deg);
  }
  return best;
}

}  // extern "C"
