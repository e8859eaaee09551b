// Native support library: fast exact EDT oracles + zlib codec.
//
// This is the framework's CPU-side native runtime piece (validation oracles
// and IO codecs); the device compute path is JAX/Pallas. Built as a plain C
// ABI shared library loaded via ctypes (sdf_tools_tpu/native.py).
//
// Contents:
//  * edt_exact_i64: exact squared EDT via per-axis lower-envelope passes
//    (Felzenszwalb/Huttenlocher), used to validate the device kernels at sizes
//    far beyond the NumPy oracle (512^3 runs in seconds).
//  * edt_reference_i64: behavioral re-implementation of the reference's
//    bucket-queue brushfire (/root/reference/include/sdf_tools/
//    sdf_generation.hpp:95-207) for studying its rare overestimates.
//    Written from the behavioral spec in SURVEY.md; not a code copy.
//  * zlib compress/decompress passthroughs for the SDFZ/CMGZ/TCMZ codecs.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Exact EDT (Felzenszwalb 1-D envelope, separable)
// ---------------------------------------------------------------------------

static void envelope_1d(const int64_t* f, int64_t* d, int32_t* v, double* z,
                        int64_t n) {
  // standard lower envelope of parabolas over already-squared heights;
  // boundaries kept in double (queries are at integer positions)
  const double DINF = std::numeric_limits<double>::infinity();
  int32_t k = 0;
  v[0] = 0;
  z[0] = -DINF;
  z[1] = DINF;
  for (int64_t q = 1; q < n; q++) {
    while (true) {
      const int64_t vk = v[k];
      const double s =
          (double(f[q] + q * q) - double(f[vk] + vk * vk)) / (2.0 * (q - vk));
      if (s <= z[k]) {
        k--;
        if (k < 0) break;
      } else {
        k++;
        v[k] = (int32_t)q;
        z[k] = s;
        z[k + 1] = DINF;
        break;
      }
    }
    if (k < 0) {
      k = 0;
      v[0] = (int32_t)q;
      z[0] = -DINF;
      z[1] = DINF;
    }
  }
  k = 0;
  for (int64_t q = 0; q < n; q++) {
    while (z[k + 1] < (double)q) k++;
    const int64_t vk = v[k];
    d[q] = (q - vk) * (q - vk) + f[vk];
  }
}

// mask: uint8 [nx*ny*nz] (x-major, z-fastest). out: int64 squared distances.
// Returns 0 on success.
int edt_exact_i64(const uint8_t* mask, int64_t nx, int64_t ny, int64_t nz,
                  int64_t* out) {
  const int64_t INF = std::numeric_limits<int64_t>::max() / 4;
  const int64_t n = nx * ny * nz;
  // pass 1 along z (contiguous): two sweeps
  for (int64_t xy = 0; xy < nx * ny; xy++) {
    const uint8_t* m = mask + xy * nz;
    int64_t* o = out + xy * nz;
    int64_t dist = INF;
    for (int64_t zi = 0; zi < nz; zi++) {
      if (m[zi])
        dist = 0;
      else if (dist < INF)
        dist++;
      o[zi] = dist;
    }
    dist = INF;
    for (int64_t zi = nz - 1; zi >= 0; zi--) {
      if (m[zi])
        dist = 0;
      else if (dist < INF)
        dist++;
      if (dist < o[zi]) o[zi] = dist;
    }
    for (int64_t zi = 0; zi < nz; zi++)
      o[zi] = (o[zi] >= INF) ? INF : o[zi] * o[zi];
  }
  // envelope passes along y then x
  std::vector<int64_t> f(std::max(nx, ny));
  std::vector<int64_t> d(std::max(nx, ny));
  std::vector<int32_t> v(std::max(nx, ny) + 1);
  std::vector<double> z(std::max(nx, ny) + 2);
  // y pass
  for (int64_t x = 0; x < nx; x++) {
    for (int64_t zi = 0; zi < nz; zi++) {
      for (int64_t y = 0; y < ny; y++) f[y] = out[(x * ny + y) * nz + zi];
      envelope_1d(f.data(), d.data(), v.data(), z.data(), ny);
      for (int64_t y = 0; y < ny; y++) out[(x * ny + y) * nz + zi] = d[y];
    }
  }
  // x pass
  for (int64_t y = 0; y < ny; y++) {
    for (int64_t zi = 0; zi < nz; zi++) {
      for (int64_t x = 0; x < nx; x++) f[x] = out[(x * ny + y) * nz + zi];
      envelope_1d(f.data(), d.data(), v.data(), z.data(), nx);
      for (int64_t x = 0; x < nx; x++) out[(x * ny + y) * nz + zi] = d[x];
    }
  }
  (void)n;
  return 0;
}

// ---------------------------------------------------------------------------
// Reference-faithful bucket-queue EDT (behavioral re-implementation)
// ---------------------------------------------------------------------------

struct QueueEntry {
  int32_t x, y, z;       // cell location
  int32_t cpx, cpy, cpz; // propagated closest point
  int32_t dir;           // arrival direction number 0..26
};

int edt_reference_i64(const uint8_t* mask, int64_t nx, int64_t ny, int64_t nz,
                      int64_t* out) {
  const int64_t INF = std::numeric_limits<int64_t>::max() / 4;
  const int64_t n = nx * ny * nz;
  const int64_t max_d2 = nx * nx + ny * ny + nz * nz;
  std::vector<int64_t>& d2v = *(new std::vector<int64_t>());  // avoid copy
  d2v.assign(n, INF);
  int64_t* d2 = d2v.data();

  // neighborhood tables per arrival direction: level 0 = all 26, level 1 =
  // face-adjacent not opposing arrival (sdf_generation.hpp:34-85 semantics)
  static int8_t hoods[2][27][26][3];
  static int hood_len[2][27];
  static bool init = false;
  if (!init) {
    for (int lvl = 0; lvl < 2; lvl++) {
      for (int dx = -1; dx <= 1; dx++)
        for (int dy = -1; dy <= 1; dy++)
          for (int dz = -1; dz <= 1; dz++) {
            const int dirno = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
            int cnt = 0;
            for (int tx = -1; tx <= 1; tx++)
              for (int ty = -1; ty <= 1; ty++)
                for (int tz = -1; tz <= 1; tz++) {
                  if (tx == 0 && ty == 0 && tz == 0) continue;
                  if (lvl >= 1) {
                    if (abs(tx) + abs(ty) + abs(tz) != 1) continue;
                    if (dx * tx < 0 || dy * ty < 0 || dz * tz < 0) continue;
                  }
                  hoods[lvl][dirno][cnt][0] = (int8_t)tx;
                  hoods[lvl][dirno][cnt][1] = (int8_t)ty;
                  hoods[lvl][dirno][cnt][2] = (int8_t)tz;
                  cnt++;
                }
            hood_len[lvl][dirno] = cnt;
          }
    }
    init = true;
  }

  std::vector<std::vector<QueueEntry>> buckets((size_t)max_d2 + 1);
  const int init_dir = 13;  // (0,0,0)
  for (int32_t x = 0; x < nx; x++)
    for (int32_t y = 0; y < ny; y++)
      for (int32_t z = 0; z < nz; z++) {
        const int64_t i = (x * ny + y) * nz + z;
        if (mask[i]) {
          d2[i] = 0;
          buckets[0].push_back({x, y, z, x, y, z, init_dir});
        }
      }

  for (int64_t b = 0; b <= max_d2; b++) {
    std::vector<QueueEntry>& q = buckets[b];
    for (size_t qi = 0; qi < q.size(); qi++) {
      const QueueEntry cur = q[qi];
      const int lvl = (b == 0) ? 0 : 1;
      const int len = hood_len[lvl][cur.dir];
      for (int h = 0; h < len; h++) {
        const int tx = hoods[lvl][cur.dir][h][0];
        const int ty = hoods[lvl][cur.dir][h][1];
        const int tz = hoods[lvl][cur.dir][h][2];
        const int32_t nxi = cur.x + tx, nyi = cur.y + ty, nzi = cur.z + tz;
        if (nxi < 0 || nyi < 0 || nzi < 0 || nxi >= nx || nyi >= ny ||
            nzi >= nz)
          continue;
        const int64_t ddx = nxi - cur.cpx, ddy = nyi - cur.cpy,
                      ddz = nzi - cur.cpz;
        const int64_t nd2 = ddx * ddx + ddy * ddy + ddz * ddz;
        if (nd2 > max_d2) continue;
        const int64_t ni = ((int64_t)nxi * ny + nyi) * nz + nzi;
        if (nd2 < d2[ni]) {
          d2[ni] = nd2;
          const int ndir = (tx + 1) * 9 + (ty + 1) * 3 + (tz + 1);
          buckets[(size_t)nd2].push_back(
              {nxi, nyi, nzi, cur.cpx, cur.cpy, cur.cpz, ndir});
        }
      }
    }
    q.clear();
    q.shrink_to_fit();
  }
  std::memcpy(out, d2, sizeof(int64_t) * (size_t)n);
  delete &d2v;
  return 0;
}

// ---------------------------------------------------------------------------
// zlib codec
// ---------------------------------------------------------------------------

int64_t zlib_compress_bound(int64_t n) { return (int64_t)compressBound((uLong)n); }

int64_t zlib_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t dst_cap) {
  uLongf dlen = (uLongf)dst_cap;
  if (compress2(dst, &dlen, src, (uLong)n, Z_BEST_SPEED) != Z_OK) return -1;
  return (int64_t)dlen;
}

int64_t zlib_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t dst_cap) {
  uLongf dlen = (uLongf)dst_cap;
  if (uncompress(dst, &dlen, src, (uLong)n) != Z_OK) return -1;
  return (int64_t)dlen;
}

}  // extern "C"
