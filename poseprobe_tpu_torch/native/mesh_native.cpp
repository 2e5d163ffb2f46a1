// Native mesh utilities: isosurface extraction + chamfer nearest-neighbour.
//
// Host-side mesh tooling of the PyTorch port (a copy of the JAX package's
// native library, built into poseprobe_tpu_torch/build/ by eval/mesh.py):
//  * mcubes.marching_cubes used by `extract_geometry` (lib/dvgo_ori.py:695-703)
//    -> marching tetrahedra here (table-free, same isosurface up to
//       triangulation), on the CPU since meshing is off the device hot path.
//  * sklearn KDTree nearest-neighbour queries inside the DTU chamfer eval
//    (lib/dtu_eval.py:37-100) -> a uniform-grid hash with ring search.
//
// Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libmesh_native.so mesh_native.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>

namespace {

struct V3 { float x, y, z; };

inline V3 lerp_edge(const V3& p0, const V3& p1, float v0, float v1, float iso) {
    float denom = v1 - v0;
    float t = (std::fabs(denom) < 1e-12f) ? 0.5f : (iso - v0) / denom;
    t = std::max(0.0f, std::min(1.0f, t));
    return {p0.x + t * (p1.x - p0.x), p0.y + t * (p1.y - p0.y), p0.z + t * (p1.z - p0.z)};
}

// The 6-tetrahedra decomposition of a cube (corner indices 0..7, where corner
// bit0 = +x, bit1 = +y, bit2 = +z).
const int TETS[6][4] = {
    {0, 5, 1, 3}, {0, 5, 3, 6}, {0, 6, 3, 2},
    {0, 6, 2, 4}, {5, 6, 0, 4}, {5, 6, 4, 7},
};

}  // namespace

extern "C" {

// Marching tetrahedra over a dense volume vol[nx*ny*nz] (C order, x-major:
// index = (x*ny + y)*nz + z). Emits vertices in index space.
// Returns 0 on success, 1 if output buffers were too small (results truncated).
int marching_tetrahedra(
    const float* vol, int nx, int ny, int nz, float iso,
    float* out_verts /* [max_verts*3] */, int32_t* out_tris /* [max_tris*3] */,
    int64_t max_verts, int64_t max_tris,
    int64_t* n_verts, int64_t* n_tris) {
    int64_t nv = 0, nt = 0;
    int truncated = 0;

    auto val = [&](int x, int y, int z) -> float {
        return vol[((int64_t)x * ny + y) * nz + z];
    };

    for (int x = 0; x + 1 < nx; ++x) {
        for (int y = 0; y + 1 < ny; ++y) {
            for (int z = 0; z + 1 < nz; ++z) {
                V3 cp[8];
                float cv[8];
                for (int c = 0; c < 8; ++c) {
                    int dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
                    cp[c] = {(float)(x + dx), (float)(y + dy), (float)(z + dz)};
                    cv[c] = val(x + dx, y + dy, z + dz);
                }
                // quick reject: all same side
                bool any_lo = false, any_hi = false;
                for (int c = 0; c < 8; ++c) { any_lo |= cv[c] < iso; any_hi |= cv[c] >= iso; }
                if (!any_lo || !any_hi) continue;

                for (const auto& tet : TETS) {
                    int idx[4] = {tet[0], tet[1], tet[2], tet[3]};
                    int mask = 0;
                    for (int k = 0; k < 4; ++k)
                        if (cv[idx[k]] >= iso) mask |= 1 << k;
                    if (mask == 0 || mask == 15) continue;

                    // collect crossing edges of the tetrahedron
                    static const int TE[6][2] = {{0,1},{0,2},{0,3},{1,2},{1,3},{2,3}};
                    V3 pts[6];
                    int np = 0;
                    // deterministic edge order for a consistent winding
                    for (const auto& e : TE) {
                        int a = idx[e[0]], b = idx[e[1]];
                        bool sa = cv[a] >= iso, sb = cv[b] >= iso;
                        if (sa != sb)
                            pts[np++] = lerp_edge(cp[a], cp[b], cv[a], cv[b], iso);
                    }
                    auto emit_tri = [&](const V3& a, const V3& b, const V3& c) {
                        if (nv + 3 > max_verts || nt + 1 > max_tris) { truncated = 1; return; }
                        out_verts[nv * 3 + 0] = a.x; out_verts[nv * 3 + 1] = a.y; out_verts[nv * 3 + 2] = a.z;
                        out_verts[nv * 3 + 3] = b.x; out_verts[nv * 3 + 4] = b.y; out_verts[nv * 3 + 5] = b.z;
                        out_verts[nv * 3 + 6] = c.x; out_verts[nv * 3 + 7] = c.y; out_verts[nv * 3 + 8] = c.z;
                        out_tris[nt * 3 + 0] = (int32_t)nv;
                        out_tris[nt * 3 + 1] = (int32_t)(nv + 1);
                        out_tris[nt * 3 + 2] = (int32_t)(nv + 2);
                        nv += 3; nt += 1;
                    };
                    if (np == 3) {
                        emit_tri(pts[0], pts[1], pts[2]);
                    } else if (np == 4) {
                        emit_tri(pts[0], pts[1], pts[2]);
                        emit_tri(pts[1], pts[3], pts[2]);
                    }
                    if (truncated) { *n_verts = nv; *n_tris = nt; return 1; }
                }
            }
        }
    }
    *n_verts = nv;
    *n_tris = nt;
    return truncated;
}

// For each query point, squared distance to the nearest reference point,
// using a uniform grid hash with expanding ring search.
void nearest_neighbor_sqdist(
    const float* query /* [nq*3] */, int64_t nq,
    const float* ref /* [nr*3] */, int64_t nr,
    float cell_size, float* out_sqdist /* [nq] */) {
    if (nr == 0) {
        for (int64_t i = 0; i < nq; ++i) out_sqdist[i] = INFINITY;
        return;
    }
    // bounding box of reference
    float lo[3] = {ref[0], ref[1], ref[2]};
    for (int64_t i = 0; i < nr; ++i)
        for (int d = 0; d < 3; ++d) lo[d] = std::min(lo[d], ref[i * 3 + d]);

    auto cell_of = [&](const float* p, int out[3]) {
        for (int d = 0; d < 3; ++d)
            out[d] = (int)std::floor((p[d] - lo[d]) / cell_size);
    };
    auto key_of = [](const int c[3]) -> int64_t {
        return ((int64_t)c[0] * 73856093LL) ^ ((int64_t)c[1] * 19349663LL)
             ^ ((int64_t)c[2] * 83492791LL);
    };

    std::unordered_map<int64_t, std::vector<int32_t>> grid;
    grid.reserve((size_t)nr * 2);
    for (int64_t i = 0; i < nr; ++i) {
        int c[3]; cell_of(ref + i * 3, c);
        grid[key_of(c)].push_back((int32_t)i);
    }

    #pragma omp parallel for schedule(dynamic, 256)
    for (int64_t i = 0; i < nq; ++i) {
        const float* q = query + i * 3;
        int qc[3]; cell_of(q, qc);
        float best = INFINITY;
        for (int ring = 0; ring < 1024; ++ring) {
            // once we have a candidate, only rings that could beat it matter
            if (best < INFINITY) {
                float safe = (float)(ring - 1) * cell_size;
                if (safe > 0 && safe * safe > best) break;
            }
            bool found_any = false;
            for (int dx = -ring; dx <= ring; ++dx)
                for (int dy = -ring; dy <= ring; ++dy)
                    for (int dz = -ring; dz <= ring; ++dz) {
                        if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != ring)
                            continue;  // shell only
                        int c[3] = {qc[0] + dx, qc[1] + dy, qc[2] + dz};
                        auto it = grid.find(key_of(c));
                        if (it == grid.end()) continue;
                        found_any = true;
                        for (int32_t j : it->second) {
                            const float* r = ref + (int64_t)j * 3;
                            float d0 = q[0] - r[0], d1 = q[1] - r[1], d2 = q[2] - r[2];
                            float d = d0 * d0 + d1 * d1 + d2 * d2;
                            best = std::min(best, d);
                        }
                    }
            (void)found_any;
        }
        out_sqdist[i] = best;
    }
}

}  // extern "C"
