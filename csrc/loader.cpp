// Native text-format parser for tahoe_tpu.
//
// The reference's model/data loaders are C++ (BaseTahoeTest.h:267-352,
// 354-402) and its model compilation is host-side C++ (Struct.h:1756-1986);
// this library is the framework's native runtime counterpart: a fast
// mmap-based parser for the same text formats, exposed through a C ABI and
// bound from Python with ctypes (no pybind11 in this environment).
//
// Formats (byte-compatible with the reference):
//   model: num_trees\n depth+1\n then per node 5 lines
//          (fid, value, def_left, weight, is_leaf)
//   data:  num_rows\n num_cols\n missing\n then one value per line
//
// Build: make -C csrc   → libtahoe_io.so

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

// Skip whitespace (including newlines), return false at EOF.
inline bool skip_ws(Cursor& c) {
  while (c.p < c.end &&
         (*c.p == ' ' || *c.p == '\n' || *c.p == '\r' || *c.p == '\t'))
    ++c.p;
  return c.p < c.end;
}

// Parse the next double token. Returns false on EOF/garbage.
inline bool next_double(Cursor& c, double* out) {
  if (!skip_ws(c)) return false;
  char* endp = nullptr;
  errno = 0;
  double v = strtod(c.p, &endp);
  if (endp == c.p) return false;
  c.p = endp;
  *out = v;
  return true;
}

inline bool next_long(Cursor& c, long* out) {
  double v;
  if (!next_double(c, &v)) return false;
  *out = static_cast<long>(v);
  return true;
}

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Model loading. Two-phase: header query, then fill preallocated buffers.
// ---------------------------------------------------------------------------

// Returns 0 on success; fills num_trees and depth (file stores depth+1,
// mirroring the reference's atoi-1, BaseTahoeTest.h:282).
int tahoe_model_header(const char* path, int64_t* num_trees, int64_t* depth) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Cursor c{m.data, m.data + m.size};
  long t = 0, d = 0;
  int rc = (next_long(c, &t) && next_long(c, &d)) ? 0 : -2;
  unmap(m);
  if (rc == 0) {
    *num_trees = t;
    *depth = d - 1;
  }
  return rc;
}

// Fills caller-allocated arrays of length num_trees * (2^(depth+1)-1).
// Layout matches ForestSpec: per tree, per node in heap order.
int tahoe_model_load(const char* path, int64_t expect_nodes, int32_t* fids,
                     float* values, uint8_t* def_left, float* weights,
                     uint8_t* is_leaf) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Cursor c{m.data, m.data + m.size};
  long t = 0, d = 0;
  if (!next_long(c, &t) || !next_long(c, &d)) {
    unmap(m);
    return -2;
  }
  int rc = 0;
  for (int64_t i = 0; i < expect_nodes; ++i) {
    long fid, dl, lf;
    double val, w;
    if (!next_long(c, &fid) || !next_double(c, &val) || !next_long(c, &dl) ||
        !next_double(c, &w) || !next_long(c, &lf)) {
      rc = -3;  // truncated
      break;
    }
    fids[i] = static_cast<int32_t>(fid);
    values[i] = static_cast<float>(val);
    def_left[i] = dl ? 1 : 0;
    weights[i] = static_cast<float>(w);
    is_leaf[i] = lf ? 1 : 0;
  }
  unmap(m);
  return rc;
}

// ---------------------------------------------------------------------------
// Data loading.
// ---------------------------------------------------------------------------

int tahoe_data_header(const char* path, int64_t* num_rows, int64_t* num_cols,
                      double* missing) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Cursor c{m.data, m.data + m.size};
  long r = 0, k = 0;
  double miss = 0.0;
  int rc = (next_long(c, &r) && next_long(c, &k) && next_double(c, &miss))
               ? 0
               : -2;
  unmap(m);
  if (rc == 0) {
    *num_rows = r;
    *num_cols = k;
    *missing = miss;
  }
  return rc;
}

int tahoe_data_load(const char* path, int64_t expect_values, float* out) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Cursor c{m.data, m.data + m.size};
  long r, k;
  double miss;
  if (!next_long(c, &r) || !next_long(c, &k) || !next_double(c, &miss)) {
    unmap(m);
    return -2;
  }
  int rc = 0;
  for (int64_t i = 0; i < expect_values; ++i) {
    double v;
    if (!next_double(c, &v)) {
      rc = -3;
      break;
    }
    out[i] = static_cast<float>(v);
  }
  unmap(m);
  return rc;
}

}  // extern "C"
