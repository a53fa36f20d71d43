// graph_builder.cpp — native host library for sequential/irregular mesh &
// deformation-graph construction.
//
// TPU-native replacement for the reference's three C++ extensions
// (csrc/ "NeuralNRT._C", NonRigidICP/cxx "MVRegC", and skimage's marching
// cubes): the operations here are inherently sequential or irregular
// (greedy sampling, Dijkstra, connected components, surface extraction)
// and run on the host at keyframes / graph-growth only — everything
// per-frame and data-parallel lives in JAX/Pallas instead.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
// All buffers are caller-allocated; functions return element counts.
//
// Reference behaviors re-implemented (see SURVEY.md §2.1 N2/N3):
//   * mesh_from_depth   — pixel-grid triangulation with max-edge cutoff
//                         (csrc/cpu/image_proc.cpp:405)
//   * erode_mesh        — iterative boundary-vertex erosion
//                         (csrc/cpu/graph_proc.cpp:17)
//   * sample_nodes      — greedy coverage-radius node subsampling
//                         (csrc/cpu/graph_proc.cpp:79)
//   * geodesic_edges    — per-node k nearest nodes by mesh geodesic
//                         distance, Dijkstra with a binary heap
//                         (csrc/cpu/graph_proc.cpp:155-260)
//   * compute_clusters  — connected components over node edges
//                         (csrc/cpu/graph_proc.cpp:440)
//   * marching_cubes    — standard Lorensen-Cline tables (classic
//                         public-domain tables; the reference defers to
//                         skimage, tsdf.py:770-809)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <random>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// mesh_from_depth: triangulate a [H,W,3] point image.
// Each pixel quad (p00,p01,p10,p11) yields up to 2 triangles; a triangle is
// kept iff all three points are valid (z > 0) and all edges are shorter than
// max_edge_len. Vertices are compacted; vertex_map gives pixel->vertex.
// Returns n_vertices; writes n_faces via out param.
int mesh_from_depth(
    const float* points, int height, int width, float max_edge_len,
    float* out_vertices /* [H*W,3] cap */, int* out_faces /* [2*H*W,3] cap */,
    int* out_vertex_map /* [H*W] pixel -> vertex id or -1 */,
    int* out_n_faces) {
  const float max_e2 = max_edge_len * max_edge_len;
  std::vector<int> vmap((size_t)height * width, -1);
  int nv = 0, nf = 0;

  auto P = [&](int y, int x, int c) -> float {
    return points[((size_t)y * width + x) * 3 + c];
  };
  auto valid = [&](int y, int x) -> bool { return P(y, x, 2) > 0.0f; };
  auto d2 = [&](int y0, int x0, int y1, int x1) -> float {
    float dx = P(y0, x0, 0) - P(y1, x1, 0);
    float dy = P(y0, x0, 1) - P(y1, x1, 1);
    float dz = P(y0, x0, 2) - P(y1, x1, 2);
    return dx * dx + dy * dy + dz * dz;
  };
  auto get_vertex = [&](int y, int x) -> int {
    int& id = vmap[(size_t)y * width + x];
    if (id < 0) {
      id = nv++;
      out_vertices[(size_t)id * 3 + 0] = P(y, x, 0);
      out_vertices[(size_t)id * 3 + 1] = P(y, x, 1);
      out_vertices[(size_t)id * 3 + 2] = P(y, x, 2);
    }
    return id;
  };

  for (int y = 0; y + 1 < height; ++y) {
    for (int x = 0; x + 1 < width; ++x) {
      bool v00 = valid(y, x), v01 = valid(y, x + 1);
      bool v10 = valid(y + 1, x), v11 = valid(y + 1, x + 1);
      // triangle (00, 10, 01)
      if (v00 && v10 && v01 && d2(y, x, y + 1, x) < max_e2 &&
          d2(y, x, y, x + 1) < max_e2 && d2(y + 1, x, y, x + 1) < max_e2) {
        int a = get_vertex(y, x), b = get_vertex(y + 1, x),
            c = get_vertex(y, x + 1);
        out_faces[(size_t)nf * 3] = a;
        out_faces[(size_t)nf * 3 + 1] = b;
        out_faces[(size_t)nf * 3 + 2] = c;
        ++nf;
      }
      // triangle (01, 10, 11)
      if (v01 && v10 && v11 && d2(y, x + 1, y + 1, x) < max_e2 &&
          d2(y, x + 1, y + 1, x + 1) < max_e2 &&
          d2(y + 1, x, y + 1, x + 1) < max_e2) {
        int a = get_vertex(y, x + 1), b = get_vertex(y + 1, x),
            c = get_vertex(y + 1, x + 1);
        out_faces[(size_t)nf * 3] = a;
        out_faces[(size_t)nf * 3 + 1] = b;
        out_faces[(size_t)nf * 3 + 2] = c;
        ++nf;
      }
    }
  }
  std::memcpy(out_vertex_map, vmap.data(), sizeof(int) * vmap.size());
  *out_n_faces = nf;
  return nv;
}

// ---------------------------------------------------------------------------
// erode_mesh: mark vertices eroded if within `iterations` hops of a boundary
// vertex (a vertex on an edge bordering < 2 triangles) or with fewer than
// min_neighbors neighbors. Writes out_valid[nv] (1 = kept).
void erode_mesh(
    const float* vertices, int n_vertices, const int* faces, int n_faces,
    int iterations, int min_neighbors, uint8_t* out_valid) {
  // adjacency + edge face counts
  std::vector<std::vector<int>> adj(n_vertices);
  // count edge multiplicity with a hash of sorted pair
  std::vector<std::vector<std::pair<int, int>>> edge_count(n_vertices);
  auto bump_edge = [&](int a, int b) {
    if (a > b) std::swap(a, b);
    for (auto& e : edge_count[a])
      if (e.first == b) {
        e.second++;
        return;
      }
    edge_count[a].push_back({b, 1});
  };
  for (int f = 0; f < n_faces; ++f) {
    int a = faces[(size_t)f * 3], b = faces[(size_t)f * 3 + 1],
        c = faces[(size_t)f * 3 + 2];
    adj[a].push_back(b);
    adj[a].push_back(c);
    adj[b].push_back(a);
    adj[b].push_back(c);
    adj[c].push_back(a);
    adj[c].push_back(b);
    bump_edge(a, b);
    bump_edge(b, c);
    bump_edge(a, c);
  }
  for (auto& v : adj) {
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
  }
  std::vector<uint8_t> eroded(n_vertices, 0);
  // boundary seed: vertex on an edge with face count != 2
  for (int a = 0; a < n_vertices; ++a)
    for (auto& e : edge_count[a])
      if (e.second != 2) {
        eroded[a] = 1;
        eroded[e.first] = 1;
      }
  for (int v = 0; v < n_vertices; ++v)
    if ((int)adj[v].size() < min_neighbors) eroded[v] = 1;
  // expand `iterations` rings
  for (int it = 1; it < iterations; ++it) {
    std::vector<uint8_t> next = eroded;
    for (int v = 0; v < n_vertices; ++v)
      if (!eroded[v])
        for (int nb : adj[v])
          if (eroded[nb]) {
            next[v] = 1;
            break;
          }
    eroded.swap(next);
  }
  for (int v = 0; v < n_vertices; ++v) out_valid[v] = eroded[v] ? 0 : 1;
}

// ---------------------------------------------------------------------------
// sample_nodes: greedy coverage sampling over valid vertices (deterministic
// given `seed`; seed < 0 = keep natural vertex order, matching the
// reference's use_only_non_eroded_indices path).
// Writes node vertex ids; returns node count (<= max_nodes).
int sample_nodes(
    const float* vertices, const uint8_t* vertex_valid, int n_vertices,
    float node_coverage, int max_nodes, int64_t seed, int* out_node_ids) {
  std::vector<int> order;
  order.reserve(n_vertices);
  for (int i = 0; i < n_vertices; ++i)
    if (!vertex_valid || vertex_valid[i]) order.push_back(i);
  if (seed >= 0) {
    std::mt19937_64 rng((uint64_t)seed);
    std::shuffle(order.begin(), order.end(), rng);
  }
  const float r2 = node_coverage * node_coverage;
  std::vector<int> accepted;
  for (int vid : order) {
    if ((int)accepted.size() >= max_nodes) break;
    const float* p = &vertices[(size_t)vid * 3];
    bool covered = false;
    for (size_t j = 0; j < accepted.size() && !covered; ++j) {
      const float* q = &vertices[(size_t)accepted[j] * 3];
      float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
      if (dx * dx + dy * dy + dz * dz < r2) covered = true;
    }
    if (!covered) accepted.push_back(vid);
  }
  for (size_t i = 0; i < accepted.size(); ++i) out_node_ids[i] = accepted[i];
  return (int)accepted.size();
}

// ---------------------------------------------------------------------------
// geodesic_edges: for each node (given by its mesh vertex id), run Dijkstra
// over the mesh edge graph until the k nearest *other nodes* are settled.
// Outputs: out_edges [n_nodes*k] (node indices, -1 padded),
//          out_dists [n_nodes*k] geodesic distances (inf padded).
// max_influence: stop expanding beyond this distance (<=0: unlimited).
void geodesic_edges(
    const float* vertices, int n_vertices, const int* faces, int n_faces,
    const int* node_ids, int n_nodes, int k, float max_influence,
    int* out_edges, float* out_dists) {
  // build weighted adjacency (CSR)
  std::vector<std::vector<std::pair<int, float>>> adj(n_vertices);
  auto add_edge = [&](int a, int b) {
    float dx = vertices[(size_t)a * 3] - vertices[(size_t)b * 3];
    float dy = vertices[(size_t)a * 3 + 1] - vertices[(size_t)b * 3 + 1];
    float dz = vertices[(size_t)a * 3 + 2] - vertices[(size_t)b * 3 + 2];
    float w = std::sqrt(dx * dx + dy * dy + dz * dz);
    adj[a].push_back({b, w});
    adj[b].push_back({a, w});
  };
  for (int f = 0; f < n_faces; ++f) {
    int a = faces[(size_t)f * 3], b = faces[(size_t)f * 3 + 1],
        c = faces[(size_t)f * 3 + 2];
    add_edge(a, b);
    add_edge(b, c);
    add_edge(a, c);
  }
  std::vector<int> vertex_to_node(n_vertices, -1);
  for (int n = 0; n < n_nodes; ++n) vertex_to_node[node_ids[n]] = n;

  std::vector<float> dist(n_vertices);
  for (int n = 0; n < n_nodes; ++n) {
    std::fill(dist.begin(), dist.end(), INFINITY);
    using QE = std::pair<float, int>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    int src = node_ids[n];
    dist[src] = 0.f;
    pq.push({0.f, src});
    int found = 0;
    for (int s = 0; s < k; ++s) {
      out_edges[(size_t)n * k + s] = -1;
      out_dists[(size_t)n * k + s] = INFINITY;
    }
    while (!pq.empty() && found < k) {
      auto [d, v] = pq.top();
      pq.pop();
      if (d > dist[v]) continue;
      if (max_influence > 0 && d > max_influence) break;
      int node_here = vertex_to_node[v];
      if (node_here >= 0 && node_here != n) {
        out_edges[(size_t)n * k + found] = node_here;
        out_dists[(size_t)n * k + found] = d;
        ++found;
        if (found == k) break;
      }
      for (auto& [u, w] : adj[v]) {
        float nd = d + w;
        if (nd < dist[u]) {
          dist[u] = nd;
          pq.push({nd, u});
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// geodesic_anchors: for every mesh vertex, its k geodesically nearest
// graph nodes (+ distances). One bounded Dijkstra per node, maintaining a
// per-vertex running top-k — the machinery behind pixel-anchor skinning
// (compute_pixel_anchors_geodesic, csrc/cpu/graph_proc.cpp:533).
// max_influence <= 0 disables the radius bound.
void geodesic_anchors(
    const float* vertices, int n_vertices, const int* faces, int n_faces,
    const int* node_ids, int n_nodes, int k, float max_influence,
    int* out_anchors /* [n_vertices*k], -1 pad */,
    float* out_dists /* [n_vertices*k], inf pad */) {
  std::vector<std::vector<std::pair<int, float>>> adj(n_vertices);
  auto add_edge = [&](int a, int b) {
    float dx = vertices[(size_t)a * 3] - vertices[(size_t)b * 3];
    float dy = vertices[(size_t)a * 3 + 1] - vertices[(size_t)b * 3 + 1];
    float dz = vertices[(size_t)a * 3 + 2] - vertices[(size_t)b * 3 + 2];
    float w = std::sqrt(dx * dx + dy * dy + dz * dz);
    adj[a].push_back({b, w});
    adj[b].push_back({a, w});
  };
  for (int f = 0; f < n_faces; ++f) {
    int a = faces[(size_t)f * 3], b = faces[(size_t)f * 3 + 1],
        c = faces[(size_t)f * 3 + 2];
    add_edge(a, b);
    add_edge(b, c);
    add_edge(a, c);
  }
  for (size_t i = 0; i < (size_t)n_vertices * k; ++i) {
    out_anchors[i] = -1;
    out_dists[i] = INFINITY;
  }
  std::vector<float> dist(n_vertices);
  for (int nidx = 0; nidx < n_nodes; ++nidx) {
    std::fill(dist.begin(), dist.end(), INFINITY);
    using QE = std::pair<float, int>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    int src = node_ids[nidx];
    dist[src] = 0.f;
    pq.push({0.f, src});
    while (!pq.empty()) {
      auto [d, v] = pq.top();
      pq.pop();
      if (d > dist[v]) continue;
      if (max_influence > 0 && d > max_influence) continue;
      // insert (nidx, d) into vertex v's top-k (sorted by distance)
      float* vd = &out_dists[(size_t)v * k];
      int* va = &out_anchors[(size_t)v * k];
      if (d < vd[k - 1]) {
        int pos = k - 1;
        while (pos > 0 && vd[pos - 1] > d) {
          vd[pos] = vd[pos - 1];
          va[pos] = va[pos - 1];
          --pos;
        }
        vd[pos] = d;
        va[pos] = nidx;
      }
      for (auto& [u, w] : adj[v]) {
        float nd = d + w;
        if (nd < dist[u]) {
          dist[u] = nd;
          pq.push({nd, u});
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// compute_clusters: connected components over the node edge lists
// (edges [n_nodes*k], -1 padded). Writes component id per node; returns
// number of components. Also writes component sizes into out_sizes (cap
// n_nodes).
int compute_clusters(
    const int* edges, int n_nodes, int k, int* out_cluster, int* out_sizes) {
  std::vector<int> comp(n_nodes, -1);
  int n_comp = 0;
  std::vector<int> stack;
  for (int s = 0; s < n_nodes; ++s) {
    if (comp[s] >= 0) continue;
    int c = n_comp++;
    int size = 0;
    stack.push_back(s);
    comp[s] = c;
    while (!stack.empty()) {
      int v = stack.back();
      stack.pop_back();
      ++size;
      for (int j = 0; j < k; ++j) {
        int u = edges[(size_t)v * k + j];
        if (u >= 0 && comp[u] < 0) {
          comp[u] = c;
          stack.push_back(u);
        }
      }
    }
    out_sizes[c] = size;
  }
  // symmetric closure: also follow reverse edges (edges are directed lists)
  // run a second union pass: nodes pointing to a different component merge
  // (repeat to fixpoint; k and n are small)
  bool changed = true;
  while (changed) {
    changed = false;
    for (int v = 0; v < n_nodes; ++v)
      for (int j = 0; j < k; ++j) {
        int u = edges[(size_t)v * k + j];
        if (u >= 0 && comp[u] != comp[v]) {
          int lo = std::min(comp[u], comp[v]);
          comp[u] = comp[v] = lo;
          changed = true;
        }
      }
  }
  // compact component ids
  std::vector<int> remap(n_comp, -1);
  int out_n = 0;
  std::vector<int> sizes;
  for (int v = 0; v < n_nodes; ++v) {
    if (remap[comp[v]] < 0) {
      remap[comp[v]] = out_n++;
      sizes.push_back(0);
    }
    out_cluster[v] = remap[comp[v]];
    sizes[out_cluster[v]]++;
  }
  for (int c = 0; c < out_n; ++c) out_sizes[c] = sizes[c];
  return out_n;
}

// ---------------------------------------------------------------------------
// Marching cubes (Lorensen–Cline). Classic public-domain edge/tri tables.
static const int kEdgeTable[256] = {
0x0,0x109,0x203,0x30a,0x406,0x50f,0x605,0x70c,0x80c,0x905,0xa0f,0xb06,0xc0a,0xd03,0xe09,0xf00,
0x190,0x99,0x393,0x29a,0x596,0x49f,0x795,0x69c,0x99c,0x895,0xb9f,0xa96,0xd9a,0xc93,0xf99,0xe90,
0x230,0x339,0x33,0x13a,0x636,0x73f,0x435,0x53c,0xa3c,0xb35,0x83f,0x936,0xe3a,0xf33,0xc39,0xd30,
0x3a0,0x2a9,0x1a3,0xaa,0x7a6,0x6af,0x5a5,0x4ac,0xbac,0xaa5,0x9af,0x8a6,0xfaa,0xea3,0xda9,0xca0,
0x460,0x569,0x663,0x76a,0x66,0x16f,0x265,0x36c,0xc6c,0xd65,0xe6f,0xf66,0x86a,0x963,0xa69,0xb60,
0x5f0,0x4f9,0x7f3,0x6fa,0x1f6,0xff,0x3f5,0x2fc,0xdfc,0xcf5,0xfff,0xef6,0x9fa,0x8f3,0xbf9,0xaf0,
0x650,0x759,0x453,0x55a,0x256,0x35f,0x55,0x15c,0xe5c,0xf55,0xc5f,0xd56,0xa5a,0xb53,0x859,0x950,
0x7c0,0x6c9,0x5c3,0x4ca,0x3c6,0x2cf,0x1c5,0xcc,0xfcc,0xec5,0xdcf,0xcc6,0xbca,0xac3,0x9c9,0x8c0,
0x8c0,0x9c9,0xac3,0xbca,0xcc6,0xdcf,0xec5,0xfcc,0xcc,0x1c5,0x2cf,0x3c6,0x4ca,0x5c3,0x6c9,0x7c0,
0x950,0x859,0xb53,0xa5a,0xd56,0xc5f,0xf55,0xe5c,0x15c,0x55,0x35f,0x256,0x55a,0x453,0x759,0x650,
0xaf0,0xbf9,0x8f3,0x9fa,0xef6,0xfff,0xcf5,0xdfc,0x2fc,0x3f5,0xff,0x1f6,0x6fa,0x7f3,0x4f9,0x5f0,
0xb60,0xa69,0x963,0x86a,0xf66,0xe6f,0xd65,0xc6c,0x36c,0x265,0x16f,0x66,0x76a,0x663,0x569,0x460,
0xca0,0xda9,0xea3,0xfaa,0x8a6,0x9af,0xaa5,0xbac,0x4ac,0x5a5,0x6af,0x7a6,0xaa,0x1a3,0x2a9,0x3a0,
0xd30,0xc39,0xf33,0xe3a,0x936,0x83f,0xb35,0xa3c,0x53c,0x435,0x73f,0x636,0x13a,0x33,0x339,0x230,
0xe90,0xf99,0xc93,0xd9a,0xa96,0xb9f,0x895,0x99c,0x69c,0x795,0x49f,0x596,0x29a,0x393,0x99,0x190,
0xf00,0xe09,0xd03,0xc0a,0xb06,0xa0f,0x905,0x80c,0x70c,0x605,0x50f,0x406,0x30a,0x203,0x109,0x0};

static const int8_t kTriTable[256][16] = {
{-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,8,3,9,8,1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,1,2,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,2,10,0,2,9,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,8,3,2,10,8,10,9,8,-1,-1,-1,-1,-1,-1,-1},
{3,11,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,11,2,8,11,0,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,9,0,2,3,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,11,2,1,9,11,9,8,11,-1,-1,-1,-1,-1,-1,-1},
{3,10,1,11,10,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,10,1,0,8,10,8,11,10,-1,-1,-1,-1,-1,-1,-1},
{3,9,0,3,11,9,11,10,9,-1,-1,-1,-1,-1,-1,-1},
{9,8,10,10,8,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,7,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,3,0,7,3,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,8,4,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,1,9,4,7,1,7,3,1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,8,4,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,4,7,3,0,4,1,2,10,-1,-1,-1,-1,-1,-1,-1},
{9,2,10,9,0,2,8,4,7,-1,-1,-1,-1,-1,-1,-1},
{2,10,9,2,9,7,2,7,3,7,9,4,-1,-1,-1,-1},
{8,4,7,3,11,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,4,7,11,2,4,2,0,4,-1,-1,-1,-1,-1,-1,-1},
{9,0,1,8,4,7,2,3,11,-1,-1,-1,-1,-1,-1,-1},
{4,7,11,9,4,11,9,11,2,9,2,1,-1,-1,-1,-1},
{3,10,1,3,11,10,7,8,4,-1,-1,-1,-1,-1,-1,-1},
{1,11,10,1,4,11,1,0,4,7,11,4,-1,-1,-1,-1},
{4,7,8,9,0,11,9,11,10,11,0,3,-1,-1,-1,-1},
{4,7,11,4,11,9,9,11,10,-1,-1,-1,-1,-1,-1,-1},
{9,5,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,5,4,0,8,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,5,4,1,5,0,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,5,4,8,3,5,3,1,5,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,9,5,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,0,8,1,2,10,4,9,5,-1,-1,-1,-1,-1,-1,-1},
{5,2,10,5,4,2,4,0,2,-1,-1,-1,-1,-1,-1,-1},
{2,10,5,3,2,5,3,5,4,3,4,8,-1,-1,-1,-1},
{9,5,4,2,3,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,11,2,0,8,11,4,9,5,-1,-1,-1,-1,-1,-1,-1},
{0,5,4,0,1,5,2,3,11,-1,-1,-1,-1,-1,-1,-1},
{2,1,5,2,5,8,2,8,11,4,8,5,-1,-1,-1,-1},
{10,3,11,10,1,3,9,5,4,-1,-1,-1,-1,-1,-1,-1},
{4,9,5,0,8,1,8,10,1,8,11,10,-1,-1,-1,-1},
{5,4,0,5,0,11,5,11,10,11,0,3,-1,-1,-1,-1},
{5,4,8,5,8,10,10,8,11,-1,-1,-1,-1,-1,-1,-1},
{9,7,8,5,7,9,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,3,0,9,5,3,5,7,3,-1,-1,-1,-1,-1,-1,-1},
{0,7,8,0,1,7,1,5,7,-1,-1,-1,-1,-1,-1,-1},
{1,5,3,3,5,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,7,8,9,5,7,10,1,2,-1,-1,-1,-1,-1,-1,-1},
{10,1,2,9,5,0,5,3,0,5,7,3,-1,-1,-1,-1},
{8,0,2,8,2,5,8,5,7,10,5,2,-1,-1,-1,-1},
{2,10,5,2,5,3,3,5,7,-1,-1,-1,-1,-1,-1,-1},
{7,9,5,7,8,9,3,11,2,-1,-1,-1,-1,-1,-1,-1},
{9,5,7,9,7,2,9,2,0,2,7,11,-1,-1,-1,-1},
{2,3,11,0,1,8,1,7,8,1,5,7,-1,-1,-1,-1},
{11,2,1,11,1,7,7,1,5,-1,-1,-1,-1,-1,-1,-1},
{9,5,8,8,5,7,10,1,3,10,3,11,-1,-1,-1,-1},
{5,7,0,5,0,9,7,11,0,1,0,10,11,10,0,-1},
{11,10,0,11,0,3,10,5,0,8,0,7,5,7,0,-1},
{11,10,5,7,11,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{10,6,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,5,10,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,0,1,5,10,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,8,3,1,9,8,5,10,6,-1,-1,-1,-1,-1,-1,-1},
{1,6,5,2,6,1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,6,5,1,2,6,3,0,8,-1,-1,-1,-1,-1,-1,-1},
{9,6,5,9,0,6,0,2,6,-1,-1,-1,-1,-1,-1,-1},
{5,9,8,5,8,2,5,2,6,3,2,8,-1,-1,-1,-1},
{2,3,11,10,6,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,0,8,11,2,0,10,6,5,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,2,3,11,5,10,6,-1,-1,-1,-1,-1,-1,-1},
{5,10,6,1,9,2,9,11,2,9,8,11,-1,-1,-1,-1},
{6,3,11,6,5,3,5,1,3,-1,-1,-1,-1,-1,-1,-1},
{0,8,11,0,11,5,0,5,1,5,11,6,-1,-1,-1,-1},
{3,11,6,0,3,6,0,6,5,0,5,9,-1,-1,-1,-1},
{6,5,9,6,9,11,11,9,8,-1,-1,-1,-1,-1,-1,-1},
{5,10,6,4,7,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,3,0,4,7,3,6,5,10,-1,-1,-1,-1,-1,-1,-1},
{1,9,0,5,10,6,8,4,7,-1,-1,-1,-1,-1,-1,-1},
{10,6,5,1,9,7,1,7,3,7,9,4,-1,-1,-1,-1},
{6,1,2,6,5,1,4,7,8,-1,-1,-1,-1,-1,-1,-1},
{1,2,5,5,2,6,3,0,4,3,4,7,-1,-1,-1,-1},
{8,4,7,9,0,5,0,6,5,0,2,6,-1,-1,-1,-1},
{7,3,9,7,9,4,3,2,9,5,9,6,2,6,9,-1},
{3,11,2,7,8,4,10,6,5,-1,-1,-1,-1,-1,-1,-1},
{5,10,6,4,7,2,4,2,0,2,7,11,-1,-1,-1,-1},
{0,1,9,4,7,8,2,3,11,5,10,6,-1,-1,-1,-1},
{9,2,1,9,11,2,9,4,11,7,11,4,5,10,6,-1},
{8,4,7,3,11,5,3,5,1,5,11,6,-1,-1,-1,-1},
{5,1,11,5,11,6,1,0,11,7,11,4,0,4,11,-1},
{0,5,9,0,6,5,0,3,6,11,6,3,8,4,7,-1},
{6,5,9,6,9,11,4,7,9,7,11,9,-1,-1,-1,-1},
{10,4,9,6,4,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,10,6,4,9,10,0,8,3,-1,-1,-1,-1,-1,-1,-1},
{10,0,1,10,6,0,6,4,0,-1,-1,-1,-1,-1,-1,-1},
{8,3,1,8,1,6,8,6,4,6,1,10,-1,-1,-1,-1},
{1,4,9,1,2,4,2,6,4,-1,-1,-1,-1,-1,-1,-1},
{3,0,8,1,2,9,2,4,9,2,6,4,-1,-1,-1,-1},
{0,2,4,4,2,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,3,2,8,2,4,4,2,6,-1,-1,-1,-1,-1,-1,-1},
{10,4,9,10,6,4,11,2,3,-1,-1,-1,-1,-1,-1,-1},
{0,8,2,2,8,11,4,9,10,4,10,6,-1,-1,-1,-1},
{3,11,2,0,1,6,0,6,4,6,1,10,-1,-1,-1,-1},
{6,4,1,6,1,10,4,8,1,2,1,11,8,11,1,-1},
{9,6,4,9,3,6,9,1,3,11,6,3,-1,-1,-1,-1},
{8,11,1,8,1,0,11,6,1,9,1,4,6,4,1,-1},
{3,11,6,3,6,0,0,6,4,-1,-1,-1,-1,-1,-1,-1},
{6,4,8,11,6,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,10,6,7,8,10,8,9,10,-1,-1,-1,-1,-1,-1,-1},
{0,7,3,0,10,7,0,9,10,6,7,10,-1,-1,-1,-1},
{10,6,7,1,10,7,1,7,8,1,8,0,-1,-1,-1,-1},
{10,6,7,10,7,1,1,7,3,-1,-1,-1,-1,-1,-1,-1},
{1,2,6,1,6,8,1,8,9,8,6,7,-1,-1,-1,-1},
{2,6,9,2,9,1,6,7,9,0,9,3,7,3,9,-1},
{7,8,0,7,0,6,6,0,2,-1,-1,-1,-1,-1,-1,-1},
{7,3,2,6,7,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,3,11,10,6,8,10,8,9,8,6,7,-1,-1,-1,-1},
{2,0,7,2,7,11,0,9,7,6,7,10,9,10,7,-1},
{1,8,0,1,7,8,1,10,7,6,7,10,2,3,11,-1},
{11,2,1,11,1,7,10,6,1,6,7,1,-1,-1,-1,-1},
{8,9,6,8,6,7,9,1,6,11,6,3,1,3,6,-1},
{0,9,1,11,6,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,8,0,7,0,6,3,11,0,11,6,0,-1,-1,-1,-1},
{7,11,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,6,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,0,8,11,7,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,11,7,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,1,9,8,3,1,11,7,6,-1,-1,-1,-1,-1,-1,-1},
{10,1,2,6,11,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,3,0,8,6,11,7,-1,-1,-1,-1,-1,-1,-1},
{2,9,0,2,10,9,6,11,7,-1,-1,-1,-1,-1,-1,-1},
{6,11,7,2,10,3,10,8,3,10,9,8,-1,-1,-1,-1},
{7,2,3,6,2,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,0,8,7,6,0,6,2,0,-1,-1,-1,-1,-1,-1,-1},
{2,7,6,2,3,7,0,1,9,-1,-1,-1,-1,-1,-1,-1},
{1,6,2,1,8,6,1,9,8,8,7,6,-1,-1,-1,-1},
{10,7,6,10,1,7,1,3,7,-1,-1,-1,-1,-1,-1,-1},
{10,7,6,1,7,10,1,8,7,1,0,8,-1,-1,-1,-1},
{0,3,7,0,7,10,0,10,9,6,10,7,-1,-1,-1,-1},
{7,6,10,7,10,8,8,10,9,-1,-1,-1,-1,-1,-1,-1},
{6,8,4,11,8,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,6,11,3,0,6,0,4,6,-1,-1,-1,-1,-1,-1,-1},
{8,6,11,8,4,6,9,0,1,-1,-1,-1,-1,-1,-1,-1},
{9,4,6,9,6,3,9,3,1,11,3,6,-1,-1,-1,-1},
{6,8,4,6,11,8,2,10,1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,3,0,11,0,6,11,0,4,6,-1,-1,-1,-1},
{4,11,8,4,6,11,0,2,9,2,10,9,-1,-1,-1,-1},
{10,9,3,10,3,2,9,4,3,11,3,6,4,6,3,-1},
{8,2,3,8,4,2,4,6,2,-1,-1,-1,-1,-1,-1,-1},
{0,4,2,4,6,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,9,0,2,3,4,2,4,6,4,3,8,-1,-1,-1,-1},
{1,9,4,1,4,2,2,4,6,-1,-1,-1,-1,-1,-1,-1},
{8,1,3,8,6,1,8,4,6,6,10,1,-1,-1,-1,-1},
{10,1,0,10,0,6,6,0,4,-1,-1,-1,-1,-1,-1,-1},
{4,6,3,4,3,8,6,10,3,0,3,9,10,9,3,-1},
{10,9,4,6,10,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,9,5,7,6,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,4,9,5,11,7,6,-1,-1,-1,-1,-1,-1,-1},
{5,0,1,5,4,0,7,6,11,-1,-1,-1,-1,-1,-1,-1},
{11,7,6,8,3,4,3,5,4,3,1,5,-1,-1,-1,-1},
{9,5,4,10,1,2,7,6,11,-1,-1,-1,-1,-1,-1,-1},
{6,11,7,1,2,10,0,8,3,4,9,5,-1,-1,-1,-1},
{7,6,11,5,4,10,4,2,10,4,0,2,-1,-1,-1,-1},
{3,4,8,3,5,4,3,2,5,10,5,2,11,7,6,-1},
{7,2,3,7,6,2,5,4,9,-1,-1,-1,-1,-1,-1,-1},
{9,5,4,0,8,6,0,6,2,6,8,7,-1,-1,-1,-1},
{3,6,2,3,7,6,1,5,0,5,4,0,-1,-1,-1,-1},
{6,2,8,6,8,7,2,1,8,4,8,5,1,5,8,-1},
{9,5,4,10,1,6,1,7,6,1,3,7,-1,-1,-1,-1},
{1,6,10,1,7,6,1,0,7,8,7,0,9,5,4,-1},
{4,0,10,4,10,5,0,3,10,6,10,7,3,7,10,-1},
{7,6,10,7,10,8,5,4,10,4,8,10,-1,-1,-1,-1},
{6,9,5,6,11,9,11,8,9,-1,-1,-1,-1,-1,-1,-1},
{3,6,11,0,6,3,0,5,6,0,9,5,-1,-1,-1,-1},
{0,11,8,0,5,11,0,1,5,5,6,11,-1,-1,-1,-1},
{6,11,3,6,3,5,5,3,1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,9,5,11,9,11,8,11,5,6,-1,-1,-1,-1},
{0,11,3,0,6,11,0,9,6,5,6,9,1,2,10,-1},
{11,8,5,11,5,6,8,0,5,10,5,2,0,2,5,-1},
{6,11,3,6,3,5,2,10,3,10,5,3,-1,-1,-1,-1},
{5,8,9,5,2,8,5,6,2,3,8,2,-1,-1,-1,-1},
{9,5,6,9,6,0,0,6,2,-1,-1,-1,-1,-1,-1,-1},
{1,5,8,1,8,0,5,6,8,3,8,2,6,2,8,-1},
{1,5,6,2,1,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,3,6,1,6,10,3,8,6,5,6,9,8,9,6,-1},
{10,1,0,10,0,6,9,5,0,5,6,0,-1,-1,-1,-1},
{0,3,8,5,6,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{10,5,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,5,10,7,5,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,5,10,11,7,5,8,3,0,-1,-1,-1,-1,-1,-1,-1},
{5,11,7,5,10,11,1,9,0,-1,-1,-1,-1,-1,-1,-1},
{10,7,5,10,11,7,9,8,1,8,3,1,-1,-1,-1,-1},
{11,1,2,11,7,1,7,5,1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,1,2,7,1,7,5,7,2,11,-1,-1,-1,-1},
{9,7,5,9,2,7,9,0,2,2,11,7,-1,-1,-1,-1},
{7,5,2,7,2,11,5,9,2,3,2,8,9,8,2,-1},
{2,5,10,2,3,5,3,7,5,-1,-1,-1,-1,-1,-1,-1},
{8,2,0,8,5,2,8,7,5,10,2,5,-1,-1,-1,-1},
{9,0,1,5,10,3,5,3,7,3,10,2,-1,-1,-1,-1},
{9,8,2,9,2,1,8,7,2,10,2,5,7,5,2,-1},
{1,3,5,3,7,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,7,0,7,1,1,7,5,-1,-1,-1,-1,-1,-1,-1},
{9,0,3,9,3,5,5,3,7,-1,-1,-1,-1,-1,-1,-1},
{9,8,7,5,9,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{5,8,4,5,10,8,10,11,8,-1,-1,-1,-1,-1,-1,-1},
{5,0,4,5,11,0,5,10,11,11,3,0,-1,-1,-1,-1},
{0,1,9,8,4,10,8,10,11,10,4,5,-1,-1,-1,-1},
{10,11,4,10,4,5,11,3,4,9,4,1,3,1,4,-1},
{2,5,1,2,8,5,2,11,8,4,5,8,-1,-1,-1,-1},
{0,4,11,0,11,3,4,5,11,2,11,1,5,1,11,-1},
{0,2,5,0,5,9,2,11,5,4,5,8,11,8,5,-1},
{9,4,5,2,11,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,5,10,3,5,2,3,4,5,3,8,4,-1,-1,-1,-1},
{5,10,2,5,2,4,4,2,0,-1,-1,-1,-1,-1,-1,-1},
{3,10,2,3,5,10,3,8,5,4,5,8,0,1,9,-1},
{5,10,2,5,2,4,1,9,2,9,4,2,-1,-1,-1,-1},
{8,4,5,8,5,3,3,5,1,-1,-1,-1,-1,-1,-1,-1},
{0,4,5,1,0,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,4,5,8,5,3,9,0,5,0,3,5,-1,-1,-1,-1},
{9,4,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,11,7,4,9,11,9,10,11,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,4,9,7,9,11,7,9,10,11,-1,-1,-1,-1},
{1,10,11,1,11,4,1,4,0,7,4,11,-1,-1,-1,-1},
{3,1,4,3,4,8,1,10,4,7,4,11,10,11,4,-1},
{4,11,7,9,11,4,9,2,11,9,1,2,-1,-1,-1,-1},
{9,7,4,9,11,7,9,1,11,2,11,1,0,8,3,-1},
{11,7,4,11,4,2,2,4,0,-1,-1,-1,-1,-1,-1,-1},
{11,7,4,11,4,2,8,3,4,3,2,4,-1,-1,-1,-1},
{2,9,10,2,7,9,2,3,7,7,4,9,-1,-1,-1,-1},
{9,10,7,9,7,4,10,2,7,8,7,0,2,0,7,-1},
{3,7,10,3,10,2,7,4,10,1,10,0,4,0,10,-1},
{1,10,2,8,7,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,9,1,4,1,7,7,1,3,-1,-1,-1,-1,-1,-1,-1},
{4,9,1,4,1,7,0,8,1,8,7,1,-1,-1,-1,-1},
{4,0,3,7,4,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,8,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,10,8,10,11,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,0,9,3,9,11,11,9,10,-1,-1,-1,-1,-1,-1,-1},
{0,1,10,0,10,8,8,10,11,-1,-1,-1,-1,-1,-1,-1},
{3,1,10,11,3,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,2,11,1,11,9,9,11,8,-1,-1,-1,-1,-1,-1,-1},
{3,0,9,3,9,11,1,2,9,2,11,9,-1,-1,-1,-1},
{0,2,11,8,0,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,2,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,3,8,2,8,10,10,8,9,-1,-1,-1,-1,-1,-1,-1},
{9,10,2,0,9,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,3,8,2,8,10,0,1,8,1,10,8,-1,-1,-1,-1},
{1,10,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,3,8,9,1,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,9,1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,3,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1}};

// cube corner offsets (x,y,z) and the 12 edges as corner pairs
static const int kCorner[8][3] = {{0,0,0},{1,0,0},{1,1,0},{0,1,0},
                                  {0,0,1},{1,0,1},{1,1,1},{0,1,1}};
static const int kEdgeCorners[12][2] = {{0,1},{1,2},{2,3},{3,0},
                                        {4,5},{5,6},{6,7},{7,4},
                                        {0,4},{1,5},{2,6},{3,7}};

// marching_cubes over a [X,Y,Z] f32 volume (C order, z fastest) with an
// optional uint8 cell mask [X,Y,Z] (cell included iff mask at its origin
// voxel). iso: level set value. Outputs capped by caller (cap_v, cap_f).
// Returns n_vertices, writes *out_n_faces. Vertices are in voxel units
// (caller applies origin + scale).
int marching_cubes(
    const float* vol, int X, int Y, int Z, const uint8_t* mask, float iso,
    float* out_vertices, int cap_v, int* out_faces, int cap_f,
    int* out_n_faces) {
  auto V = [&](int x, int y, int z) -> float {
    return vol[((size_t)x * Y + y) * Z + z];
  };
  int nv = 0, nf = 0;
  // dedupe vertices shared across cell edges: hash on canonical edge id
  // (lower corner voxel coords + axis)
  struct EdgeMap {
    std::vector<std::vector<std::pair<int64_t, int>>> buckets;
    explicit EdgeMap(size_t n) : buckets(n) {}
    int* find_or_insert(int64_t key, int value_if_new, bool& inserted) {
      auto& b = buckets[(size_t)key % buckets.size()];
      for (auto& kv : b)
        if (kv.first == key) {
          inserted = false;
          return &kv.second;
        }
      b.push_back({key, value_if_new});
      inserted = true;
      return &b.back().second;
    }
  };
  EdgeMap emap((size_t)X * Y * 4 + 1024);

  for (int x = 0; x + 1 < X; ++x)
    for (int y = 0; y + 1 < Y; ++y)
      for (int z = 0; z + 1 < Z; ++z) {
        if (mask && !mask[((size_t)x * Y + y) * Z + z]) continue;
        float c[8];
        int cube = 0;
        for (int i = 0; i < 8; ++i) {
          c[i] = V(x + kCorner[i][0], y + kCorner[i][1], z + kCorner[i][2]);
          if (c[i] < iso) cube |= (1 << i);
        }
        int edges = kEdgeTable[cube];
        if (!edges) continue;
        int edge_vert[12];
        for (int e = 0; e < 12; ++e) {
          if (!(edges & (1 << e))) continue;
          int a = kEdgeCorners[e][0], b = kEdgeCorners[e][1];
          int ax = x + kCorner[a][0], ay = y + kCorner[a][1],
              az = z + kCorner[a][2];
          int bx = x + kCorner[b][0], by = y + kCorner[b][1],
              bz = z + kCorner[b][2];
          // canonical edge id: lower corner + axis
          int ox = std::min(ax, bx), oy = std::min(ay, by),
              oz = std::min(az, bz);
          int axis = (ax != bx) ? 0 : (ay != by) ? 1 : 2;
          int64_t key = (((int64_t)ox * (Y + 1) + oy) * (Z + 1) + oz) * 3 + axis;
          bool inserted;
          int* slot = emap.find_or_insert(key, nv, inserted);
          if (inserted) {
            if (nv >= cap_v) { *out_n_faces = nf; return nv; }
            float va = c[a], vb = c[b];
            float denom = vb - va;
            float t = (std::fabs(denom) < 1e-12f) ? 0.5f : (iso - va) / denom;
            if (t < 0.f) t = 0.f;
            if (t > 1.f) t = 1.f;
            out_vertices[(size_t)nv * 3 + 0] = ax + t * (bx - ax);
            out_vertices[(size_t)nv * 3 + 1] = ay + t * (by - ay);
            out_vertices[(size_t)nv * 3 + 2] = az + t * (bz - az);
            ++nv;
          }
          edge_vert[e] = *slot;
        }
        const int8_t* tri = kTriTable[cube];
        for (int t = 0; tri[t] != -1; t += 3) {
          if (nf >= cap_f) { *out_n_faces = nf; return nv; }
          out_faces[(size_t)nf * 3 + 0] = edge_vert[tri[t]];
          out_faces[(size_t)nf * 3 + 1] = edge_vert[tri[t + 1]];
          out_faces[(size_t)nf * 3 + 2] = edge_vert[tri[t + 2]];
          ++nf;
        }
      }
  *out_n_faces = nf;
  return nv;
}

}  // extern "C"
