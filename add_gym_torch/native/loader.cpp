// Native data loader of add_gym_torch: motion-CSV and binary-STL parsing.
//
// The host-side data path in C++: a single-pass CSV float parser (the
// clips' ``.motion`` text) and a binary STL AABB scan used by the physics
// model builder.  Exposed as plain C symbols and bound with ctypes
// (add_gym_torch/native/__init__.py builds it with g++ at first use into
// build/add_gym_torch/).  A copy of the JAX package's loader, so the port
// depends on nothing of that package.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse a comma/whitespace-separated float text file.
// Returns a malloc'd row-major double buffer via *out (caller frees with
// agt_free), with *rows/*cols set.  Returns 0 on success, nonzero on error.
// Ragged rows are an error (returns 3).
int agt_parse_motion_csv(const char* path, double** out, int64_t* rows,
                         int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);
  buf[size] = '\0';

  std::vector<double> vals;
  vals.reserve(static_cast<size_t>(size) / 8);
  int64_t ncols = -1, col = 0, nrows = 0;

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    // skip separators (commas, spaces, tabs, CR)
    while (p < end && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r'))
      ++p;
    if (p >= end) break;
    if (*p == '\n') {
      if (col > 0) {
        if (ncols < 0) ncols = col;
        else if (col != ncols) return 3;  // ragged row
        ++nrows;
        col = 0;
      }
      ++p;
      continue;
    }
    char* next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) return 4;  // unparsable token
    vals.push_back(v);
    ++col;
    p = next;
  }
  if (col > 0) {  // last line without trailing newline
    if (ncols < 0) ncols = col;
    else if (col != ncols) return 3;
    ++nrows;
  }

  double* data = static_cast<double*>(std::malloc(vals.size() * sizeof(double)));
  if (!data) return 5;
  std::memcpy(data, vals.data(), vals.size() * sizeof(double));
  *out = data;
  *rows = nrows;
  *cols = ncols < 0 ? 0 : ncols;
  return 0;
}

void agt_free(void* p) { std::free(p); }

// Axis-aligned bounding box of a binary STL mesh.
// lo/hi are float[3].  Returns 0 on success.
int agt_stl_aabb(const char* path, float* lo, float* hi) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char header[84];
  if (std::fread(header, 1, 84, f) != 84) {
    std::fclose(f);
    return 2;
  }
  uint32_t ntri;
  std::memcpy(&ntri, header + 80, 4);

  for (int k = 0; k < 3; ++k) {
    lo[k] = 3.4e38f;
    hi[k] = -3.4e38f;
  }
  // record: normal 3f, v0 3f, v1 3f, v2 3f, attr u16  (50 bytes)
  std::vector<char> rec(50 * 4096);
  uint32_t done = 0;
  while (done < ntri) {
    uint32_t batch = ntri - done;
    if (batch > 4096) batch = 4096;
    if (std::fread(rec.data(), 50, batch, f) != batch) {
      std::fclose(f);
      return 3;
    }
    for (uint32_t t = 0; t < batch; ++t) {
      const char* r = rec.data() + 50 * t;
      for (int v = 0; v < 3; ++v) {
        float xyz[3];
        std::memcpy(xyz, r + 12 + 12 * v, 12);
        for (int k = 0; k < 3; ++k) {
          if (xyz[k] < lo[k]) lo[k] = xyz[k];
          if (xyz[k] > hi[k]) hi[k] = xyz[k];
        }
      }
    }
    done += batch;
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
