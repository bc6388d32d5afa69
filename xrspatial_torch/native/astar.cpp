// Native A* over a blocked-cell raster.
//
// Semantics are EXACTLY those of xrspatial_torch/pathfinding.py::_astar
// (a copy of xrspatial_tpu/native/astar.cpp; both mirror the reference
// xrspatial/pathfinding.py:68-230):
//   - heap ordered by (f = g + heuristic, y, x): row-major first-minimum
//     tie-breaking, matching the reference's full-grid min scan;
//   - euclidean heuristic + per-step hypot(dy, dx) costs in double;
//   - `nd <= d` re-parenting: the last expanded equal-cost predecessor
//     wins (reference pathfinding.py:207-230);
//   - stale heap entries skipped via the g+h+1e-12 check.
//
// Built on demand by xrspatial_torch/native/__init__.py (g++ -O2 -shared);
// the Python heapq implementation remains as a fallback.

#include <cmath>
#include <cstdint>
#include <queue>
#include <tuple>
#include <vector>

namespace {

struct Node {
  double f;
  int64_t y, x;
};

struct NodeGreater {
  bool operator()(const Node &a, const Node &b) const {
    if (a.f != b.f) return a.f > b.f;
    if (a.y != b.y) return a.y > b.y;
    return a.x > b.x;
  }
};

}  // namespace

extern "C" int64_t xrspatial_astar(
    const uint8_t *blocked, int64_t h, int64_t w,
    int64_t start_y, int64_t start_x, int64_t goal_y, int64_t goal_x,
    int32_t connectivity,
    double *d_from_start,   // h*w, caller-prefilled with +inf
    int64_t *path_out,      // capacity h*w*2, written as (y, x) pairs
    int64_t *path_len) {    // out: number of pairs written
  *path_len = 0;
  if (blocked[start_y * w + start_x]) return 1;

  const int64_t dy8[] = {-1, 0, 1, -1, 1, -1, 0, 1};
  const int64_t dx8[] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int64_t dy4[] = {0, -1, 1, 0};
  const int64_t dx4[] = {-1, 0, 0, 1};
  const int64_t *dys = (connectivity == 8) ? dy8 : dy4;
  const int64_t *dxs = (connectivity == 8) ? dx8 : dx4;
  const int nn = (connectivity == 8) ? 8 : 4;

  auto heuristic = [&](int64_t py, int64_t px) {
    return std::hypot(static_cast<double>(px - goal_x),
                      static_cast<double>(py - goal_y));
  };

  std::vector<int64_t> parent(static_cast<size_t>(h) * w * 2, -1);
  std::vector<uint8_t> closed(static_cast<size_t>(h) * w, 0);

  d_from_start[start_y * w + start_x] = 0.0;
  parent[(start_y * w + start_x) * 2] = start_y;
  parent[(start_y * w + start_x) * 2 + 1] = start_x;

  std::priority_queue<Node, std::vector<Node>, NodeGreater> open;
  open.push({heuristic(start_y, start_x), start_y, start_x});

  while (!open.empty()) {
    Node n = open.top();
    open.pop();
    const int64_t idx = n.y * w + n.x;
    if (closed[idx]) continue;
    if (n.f > d_from_start[idx] + heuristic(n.y, n.x) + 1e-12) continue;
    closed[idx] = 1;
    if (n.y == goal_y && n.x == goal_x) {
      // reconstruct goal -> start, then reverse into path_out
      std::vector<int64_t> rev;
      int64_t cy = goal_y, cx = goal_x;
      while (!(cy == start_y && cx == start_x)) {
        rev.push_back(cy);
        rev.push_back(cx);
        const int64_t ci = (cy * w + cx) * 2;
        const int64_t py = parent[ci], px = parent[ci + 1];
        cy = py;
        cx = px;
      }
      rev.push_back(start_y);
      rev.push_back(start_x);
      const int64_t npairs = static_cast<int64_t>(rev.size()) / 2;
      for (int64_t i = 0; i < npairs; ++i) {
        path_out[i * 2] = rev[(npairs - 1 - i) * 2];
        path_out[i * 2 + 1] = rev[(npairs - 1 - i) * 2 + 1];
      }
      *path_len = npairs;
      return 0;
    }
    for (int k = 0; k < nn; ++k) {
      const int64_t ny = n.y + dys[k], nx = n.x + dxs[k];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      const int64_t ni = ny * w + nx;
      if (blocked[ni] || closed[ni]) continue;
      const double nd =
          d_from_start[idx] + std::hypot(static_cast<double>(dxs[k]),
                                         static_cast<double>(dys[k]));
      if (nd <= d_from_start[ni]) {
        d_from_start[ni] = nd;
        parent[ni * 2] = n.y;
        parent[ni * 2 + 1] = n.x;
        open.push({nd + heuristic(ny, nx), ny, nx});
      }
    }
  }
  return 1;
}
