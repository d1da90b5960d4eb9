// Isosurface extraction by marching tetrahedra over a dense scalar
// field, with vertex deduplication.  Native-runtime replacement for the
// reference's PyMCubes dependency (`model/extract_geometry.py:3,24`):
// the table-light tetrahedral decomposition (6 tets per cube) yields a
// watertight triangulation of the same isosurface with exact linear
// interpolation along edges.
//
// C ABI (ctypes):
//   mt_extract(field, nx, ny, nz, iso, &verts, &n_verts, &tris, &n_tris)
//   mt_free(ptr)
// Vertices are in index space ([0, n-1] per axis); the Python wrapper
// rescales into world space like `model/extract_geometry.py:28`.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

// The 6-tetrahedra decomposition of a unit cube (corner indices into
// the standard 8-corner ordering below).
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// corner offsets (x, y, z)
static const int CORNER[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

struct EdgeKey {
    uint64_t a, b;
    bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};

struct EdgeKeyHash {
    size_t operator()(const EdgeKey& k) const {
        uint64_t h = k.a * 0x9E3779B97F4A7C15ull ^ (k.b + 0x7F4A7C15u);
        h ^= h >> 29;
        h *= 0xBF58476D1CE4E5B9ull;
        h ^= h >> 32;
        return (size_t)h;
    }
};

class Mesher {
  public:
    Mesher(const float* field, int64_t nx, int64_t ny, int64_t nz, float iso)
        : f_(field), nx_(nx), ny_(ny), nz_(nz), iso_(iso) {}

    inline float val(int64_t x, int64_t y, int64_t z) const {
        return f_[(x * ny_ + y) * nz_ + z];
    }

    inline uint64_t node_id(int64_t x, int64_t y, int64_t z) const {
        return (uint64_t)((x * ny_ + y) * nz_ + z);
    }

    // interpolated vertex on the edge between two grid nodes
    int64_t edge_vertex(int64_t ax, int64_t ay, int64_t az, float va,
                        int64_t bx, int64_t by, int64_t bz, float vb) {
        uint64_t ia = node_id(ax, ay, az), ib = node_id(bx, by, bz);
        EdgeKey key = ia < ib ? EdgeKey{ia, ib} : EdgeKey{ib, ia};
        auto it = cache_.find(key);
        if (it != cache_.end()) return it->second;
        float denom = vb - va;
        float t = denom == 0.0f ? 0.5f : (iso_ - va) / denom;
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        V3 v{(float)ax + t * (bx - ax), (float)ay + t * (by - ay),
             (float)az + t * (bz - az)};
        int64_t idx = (int64_t)verts_.size();
        verts_.push_back(v);
        cache_.emplace(key, idx);
        return idx;
    }

    void do_tet(const int64_t p[4][3], const float v[4]) {
        int inside = 0;
        int code = 0;
        for (int i = 0; i < 4; ++i)
            if (v[i] > iso_) { code |= 1 << i; ++inside; }
        if (inside == 0 || inside == 4) return;

        // enumerate the (inside, outside) crossing edges; emit 1 or 2
        // triangles with orientation following the sign pattern.
        int in_idx[4], out_idx[4];
        int ni = 0, no = 0;
        for (int i = 0; i < 4; ++i)
            (code >> i & 1) ? in_idx[ni++] = i : out_idx[no++] = i;

        auto ev = [&](int a, int b) {
            return edge_vertex(p[a][0], p[a][1], p[a][2], v[a],
                               p[b][0], p[b][1], p[b][2], v[b]);
        };

        if (ni == 1) {
            int64_t e0 = ev(in_idx[0], out_idx[0]);
            int64_t e1 = ev(in_idx[0], out_idx[1]);
            int64_t e2 = ev(in_idx[0], out_idx[2]);
            tris_.push_back(e0); tris_.push_back(e1); tris_.push_back(e2);
        } else if (ni == 3) {
            int64_t e0 = ev(in_idx[0], out_idx[0]);
            int64_t e1 = ev(in_idx[1], out_idx[0]);
            int64_t e2 = ev(in_idx[2], out_idx[0]);
            tris_.push_back(e0); tris_.push_back(e2); tris_.push_back(e1);
        } else {  // 2-2: quad -> two triangles
            int64_t e00 = ev(in_idx[0], out_idx[0]);
            int64_t e01 = ev(in_idx[0], out_idx[1]);
            int64_t e10 = ev(in_idx[1], out_idx[0]);
            int64_t e11 = ev(in_idx[1], out_idx[1]);
            tris_.push_back(e00); tris_.push_back(e01); tris_.push_back(e11);
            tris_.push_back(e00); tris_.push_back(e11); tris_.push_back(e10);
        }
    }

    void run() {
        for (int64_t x = 0; x + 1 < nx_; ++x)
            for (int64_t y = 0; y + 1 < ny_; ++y)
                for (int64_t z = 0; z + 1 < nz_; ++z) {
                    float cv[8];
                    int64_t cp[8][3];
                    bool any_in = false, any_out = false;
                    for (int c = 0; c < 8; ++c) {
                        cp[c][0] = x + CORNER[c][0];
                        cp[c][1] = y + CORNER[c][1];
                        cp[c][2] = z + CORNER[c][2];
                        cv[c] = val(cp[c][0], cp[c][1], cp[c][2]);
                        (cv[c] > iso_ ? any_in : any_out) = true;
                    }
                    if (!any_in || !any_out) continue;
                    for (int t = 0; t < 6; ++t) {
                        int64_t tp[4][3];
                        float tv[4];
                        for (int i = 0; i < 4; ++i) {
                            int c = TETS[t][i];
                            tp[i][0] = cp[c][0];
                            tp[i][1] = cp[c][1];
                            tp[i][2] = cp[c][2];
                            tv[i] = cv[c];
                        }
                        do_tet(tp, tv);
                    }
                }
    }

    std::vector<V3> verts_;
    std::vector<int64_t> tris_;

  private:
    const float* f_;
    int64_t nx_, ny_, nz_;
    float iso_;
    std::unordered_map<EdgeKey, int64_t, EdgeKeyHash> cache_;
};

}  // namespace

extern "C" {

int mt_extract(const float* field, int64_t nx, int64_t ny, int64_t nz,
               float iso, float** out_verts, int64_t* n_verts,
               int64_t** out_tris, int64_t* n_tris) {
    Mesher m(field, nx, ny, nz, iso);
    m.run();
    *n_verts = (int64_t)m.verts_.size();
    *n_tris = (int64_t)(m.tris_.size() / 3);
    *out_verts = (float*)malloc(sizeof(float) * 3 * m.verts_.size());
    *out_tris = (int64_t*)malloc(sizeof(int64_t) * m.tris_.size());
    if ((*out_verts == nullptr && !m.verts_.empty()) ||
        (*out_tris == nullptr && !m.tris_.empty()))
        return 1;
    if (!m.verts_.empty())
        memcpy(*out_verts, m.verts_.data(), sizeof(float) * 3 * m.verts_.size());
    if (!m.tris_.empty())
        memcpy(*out_tris, m.tris_.data(), sizeof(int64_t) * m.tris_.size());
    return 0;
}

void mt_free(void* p) { free(p); }

}  // extern "C"
