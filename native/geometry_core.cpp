// Native geometry core: median-dual control-volume construction.
//
// C++ implementation of the hot mesh-preprocessing path (the reference's
// CPhysicalGeometry::SetControlVolume pipeline, Common/src/
// geometry_structure.cpp:10457 + orientation checks :8542/:8825 + adjacency
// build), exposed through a plain C ABI for ctypes.  The Python dual-grid
// builder (su2_tpu/geometry/dual_grid.py) is the reference implementation;
// this module applies the same formulas with the same edge numbering and
// adjacency slot ordering (float accumulation order may differ in the last
// ulp) at native speed for large meshes.
//
// Build: see native/Makefile (produces libsu2_geom.so).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct EdgeKey {
  int64_t a, b;
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};

struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    return std::hash<int64_t>()(k.a * 1000003 ^ k.b);
  }
};

// faces (local node pairs) of 2D elements in winding order
void elem_faces(int type, const int64_t* nodes, int* nfaces,
                int64_t face[4][2]) {
  if (type == 5) {  // triangle
    *nfaces = 3;
    int f[3][2] = {{0, 1}, {1, 2}, {2, 0}};
    for (int k = 0; k < 3; ++k) {
      face[k][0] = nodes[f[k][0]];
      face[k][1] = nodes[f[k][1]];
    }
  } else {  // quad (9)
    *nfaces = 4;
    int f[4][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0}};
    for (int k = 0; k < 4; ++k) {
      face[k][0] = nodes[f[k][0]];
      face[k][1] = nodes[f[k][1]];
    }
  }
}

}  // namespace

extern "C" {

// Build the 2D median-dual grid.
//
// Inputs:
//   npoint, coords (npoint*2), nelem, elem_types (nelem),
//   elem_nodes (nelem*4, -1 padded)
// Outputs (caller-allocated; sizes via query call below):
//   edges (nedge*2), edge_normal (nedge*2), volume (npoint)
// Returns nedge, or -1 on error.
//
// Orientation fixes (interior CCW, boundary handled in Python) are applied
// to a local copy of elem_nodes exactly like Check_IntElem_Orientation.
int64_t su2geom_build_dual_2d(int64_t npoint, const double* coords,
                             int64_t nelem, const int32_t* elem_types,
                             const int64_t* elem_nodes_in,
                             int64_t* edges_out, double* edge_normal_out,
                             double* volume_out, int64_t max_edges) {
  std::vector<int64_t> elem_nodes(elem_nodes_in,
                                  elem_nodes_in + nelem * 4);
  // --- interior orientation: flip to CCW (shoelace) ---
  for (int64_t e = 0; e < nelem; ++e) {
    int64_t* nn = &elem_nodes[e * 4];
    int cnt = (elem_types[e] == 5) ? 3 : 4;
    double area = 0.0;
    for (int k = 0; k < cnt; ++k) {
      int64_t a = nn[k], b = nn[(k + 1) % cnt];
      area += coords[a * 2] * coords[b * 2 + 1] -
              coords[b * 2] * coords[a * 2 + 1];
    }
    if (area < 0.0) {
      for (int k = 0; k < cnt / 2; ++k) std::swap(nn[k], nn[cnt - 1 - k]);
    }
  }

  // --- unique edges, numbered in sorted (i, j) order like the Python
  //     builder (np.unique on i*npoint+j keys) ---
  std::vector<int64_t> keys;
  keys.reserve(nelem * 4);
  for (int64_t e = 0; e < nelem; ++e) {
    int nf;
    int64_t face[4][2];
    elem_faces(elem_types[e], &elem_nodes[e * 4], &nf, face);
    for (int k = 0; k < nf; ++k) {
      int64_t i = face[k][0], j = face[k][1];
      keys.push_back(std::min(i, j) * npoint + std::max(i, j));
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  int64_t nedge = static_cast<int64_t>(keys.size());
  if (nedge > max_edges) return -1;
  std::unordered_map<EdgeKey, int64_t, EdgeKeyHash> edge_id;
  edge_id.reserve(nedge * 2);
  for (int64_t k = 0; k < nedge; ++k) {
    int64_t a = keys[k] / npoint, b = keys[k] % npoint;
    edges_out[k * 2] = a;
    edges_out[k * 2 + 1] = b;
    edge_id.emplace(EdgeKey{a, b}, k);
  }

  std::memset(edge_normal_out, 0, sizeof(double) * nedge * 2);
  std::memset(volume_out, 0, sizeof(double) * npoint);

  // --- accumulate dual-face normals and volumes (SetControlVolume 2D) ---
  for (int64_t e = 0; e < nelem; ++e) {
    int nf;
    int64_t face[4][2];
    elem_faces(elem_types[e], &elem_nodes[e * 4], &nf, face);
    int cnt = (elem_types[e] == 5) ? 3 : 4;
    double cgx = 0.0, cgy = 0.0;
    for (int k = 0; k < cnt; ++k) {
      cgx += coords[elem_nodes[e * 4 + k] * 2];
      cgy += coords[elem_nodes[e * 4 + k] * 2 + 1];
    }
    cgx /= cnt;
    cgy /= cnt;
    for (int k = 0; k < nf; ++k) {
      int64_t i = face[k][0], j = face[k][1];
      bool swap = i > j;
      EdgeKey key{std::min(i, j), std::max(i, j)};
      int64_t eid = edge_id[key];
      double mx = 0.5 * (coords[i * 2] + coords[j * 2]);
      double my = 0.5 * (coords[i * 2 + 1] + coords[j * 2 + 1]);
      double dx = swap ? (mx - cgx) : (cgx - mx);
      double dy = swap ? (my - cgy) : (cgy - my);
      edge_normal_out[eid * 2] += dy;
      edge_normal_out[eid * 2 + 1] += -dx;
      // dual volume: triangle (P, edge CG, elem CG) per endpoint
      for (int s = 0; s < 2; ++s) {
        int64_t p = face[k][s];
        double ax = cgx - coords[p * 2], ay = cgy - coords[p * 2 + 1];
        double bx = mx - coords[p * 2], by = my - coords[p * 2 + 1];
        volume_out[p] += 0.5 * std::fabs(ax * by - ay * bx);
      }
    }
  }

  // zero-area guard (geometry_structure.cpp:10553)
  for (int64_t k = 0; k < nedge; ++k) {
    double nx = edge_normal_out[k * 2], ny = edge_normal_out[k * 2 + 1];
    if (nx * nx + ny * ny == 0.0) {
      edge_normal_out[k * 2] = 1e-32;
      edge_normal_out[k * 2 + 1] = 1e-32;
    }
  }
  return nedge;
}

// Node->edge adjacency (gather-based scatter tables).
// Outputs: node_edges (npoint*maxdeg, pad=nedge), node_sign, node_nbrs.
// Returns max degree found, or -1 if it exceeds maxdeg.
int64_t su2geom_adjacency(int64_t npoint, int64_t nedge, const int64_t* edges,
                         int64_t maxdeg, int64_t* node_edges,
                         double* node_sign, int64_t* node_nbrs) {
  for (int64_t p = 0; p < npoint; ++p) {
    for (int64_t k = 0; k < maxdeg; ++k) {
      node_edges[p * maxdeg + k] = nedge;
      node_sign[p * maxdeg + k] = 0.0;
      node_nbrs[p * maxdeg + k] = p;
    }
  }
  std::vector<int64_t> deg(npoint, 0);
  int64_t maxseen = 0;
  // side-0 pass then side-1 pass, edges ascending — matches the Python
  // builder's slot ordering exactly (deterministic gather-sum order)
  for (int s = 0; s < 2; ++s) {
    for (int64_t e = 0; e < nedge; ++e) {
      int64_t p = edges[e * 2 + s];
      int64_t d = deg[p]++;
      if (d >= maxdeg) return -1;
      node_edges[p * maxdeg + d] = e;
      node_sign[p * maxdeg + d] = (s == 0) ? 1.0 : -1.0;
      node_nbrs[p * maxdeg + d] = edges[e * 2 + (1 - s)];
      if (deg[p] > maxseen) maxseen = deg[p];
    }
  }
  return maxseen;
}

}  // extern "C"
