// Native mesh utilities: isosurface extraction.
//
// Host-side mesh tooling of the PyTorch port (a copy of the JAX package's
// native library, built into poseprobe_tpu_torch/build/ by eval/mesh.py):
//  * mcubes.marching_cubes used by `extract_geometry` (lib/dvgo_ori.py:695-703)
//    -> marching tetrahedra here (table-free, same isosurface up to
//       triangulation), on the CPU since meshing is off the device hot path.
// The JAX package's copy also has a grid-hash nearest-neighbour search; the
// port's chamfer uses a KD-tree instead (eval/mesh.py, nearest_sqdist).
//
// Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libmesh_native.so mesh_native.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
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

}  // extern "C"
