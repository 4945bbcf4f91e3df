// Native data-plane for hnsw-slim-tpu: fvecs/ivecs I/O and the patch codec.
//
// The reference implements its entire runtime in C++ (ifstream loops in
// include/util.h:52-168, writeBinaryPOD patch streams in
// hnswalg_slim.h:1384-1476). Here the device compute path is JAX/XLA; this
// library keeps the host data-plane native: mmap'd vector-file readers and
// the binary patch record codec, exposed through a plain C ABI consumed via
// ctypes (hnsw_slim_tpu/utils/native.py).
//
// Build: make -C native (produces libdataplane.so).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// fvecs/ivecs: rows of [int32 dim][dim * 4-byte payload] (util.h:52-168)
// ---------------------------------------------------------------------------

// Returns 0 on success; fills dim and num.
int vecs_size(const char* path, int32_t* dim, int64_t* num) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int32_t d = 0;
  if (fread(&d, sizeof(d), 1, f) != 1) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (d <= 0) return -3;
  const int64_t row = 4 + static_cast<int64_t>(d) * 4;
  if (st.st_size % row != 0) return -4;
  *dim = d;
  *num = st.st_size / row;
  return 0;
}

// Reads up to max_num rows into out[num*dim] (payload only, headers
// stripped) using one mmap + strided copies. Returns rows read, < 0 on error.
int64_t vecs_read(const char* path, float* out, int64_t max_num) {
  int32_t dim;
  int64_t num;
  if (vecs_size(path, &dim, &num) != 0) return -1;
  if (max_num > 0 && max_num < num) num = max_num;

  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  const int64_t row = 4 + static_cast<int64_t>(dim) * 4;
  const int64_t bytes = row * num;
  void* base = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -2;

  const char* src = static_cast<const char*>(base);
  for (int64_t i = 0; i < num; ++i) {
    std::memcpy(out + i * dim, src + i * row + 4, dim * 4);
  }
  munmap(base, bytes);
  return num;
}

// Writes rows of [dim][payload]. data is row-major [num, dim] int32/float32.
int64_t vecs_write(const char* path, const void* data, int64_t num,
                   int32_t dim) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const char* src = static_cast<const char*>(data);
  for (int64_t i = 0; i < num; ++i) {
    if (fwrite(&dim, 4, 1, f) != 1 ||
        fwrite(src + i * static_cast<int64_t>(dim) * 4, 4, dim, f) !=
            static_cast<size_t>(dim)) {
      fclose(f);
      return -2;
    }
  }
  fclose(f);
  return num;
}

// ---------------------------------------------------------------------------
// Patch record codec (persist/patch.py wire format):
//   u8 is_new | i32 id | i32 level | i32 total | u32 rel_end[level+1]
//   | i32 nbr[total] | (f32 vec[dim] if is_new && has_vec)
// ---------------------------------------------------------------------------

// Encodes n_records node records into out. Inputs are flat CHAL arrays.
// Returns bytes written, < 0 on error (out_cap too small).
int64_t patch_encode(const int32_t* node_ids, int64_t n_records,
                     const int32_t* levels, const int32_t* lvl_off,
                     int32_t off_stride, const int32_t* nbr,
                     const float* vectors, int32_t dim,
                     const uint8_t* is_new_flags, char* out,
                     int64_t out_cap) {
  char* p = out;
  char* end = out + out_cap;
  for (int64_t r = 0; r < n_records; ++r) {
    const int32_t v = node_ids[r];
    const int32_t lv = levels[v];
    const int32_t* off = lvl_off + static_cast<int64_t>(v) * off_stride;
    const int32_t start = off[0];
    const int32_t total = off[lv + 1] - start;
    const uint8_t isn = is_new_flags ? is_new_flags[r] : 0;
    const bool with_vec = isn && vectors != nullptr;
    const int64_t need = 1 + 12 + 4 * (lv + 1) + 4 * total +
                         (with_vec ? 4 * static_cast<int64_t>(dim) : 0);
    if (p + need > end) return -1;
    *p++ = static_cast<char>(isn);
    std::memcpy(p, &v, 4);
    p += 4;
    std::memcpy(p, &lv, 4);
    p += 4;
    std::memcpy(p, &total, 4);
    p += 4;
    for (int32_t l = 0; l <= lv; ++l) {
      const uint32_t rel = static_cast<uint32_t>(off[l + 1] - start);
      std::memcpy(p, &rel, 4);
      p += 4;
    }
    std::memcpy(p, nbr + start, 4 * static_cast<int64_t>(total));
    p += 4 * static_cast<int64_t>(total);
    if (with_vec) {
      std::memcpy(p, vectors + static_cast<int64_t>(v) * dim, 4 * dim);
      p += 4 * static_cast<int64_t>(dim);
    }
  }
  return p - out;
}

// Decodes records: fills parallel output arrays. Caller sizes outputs from
// patch_count. Returns records decoded, < 0 on malformed input.
int64_t patch_decode(const char* buf, int64_t len, int32_t has_vec,
                     int32_t dim, int32_t max_level_cap, int32_t* out_ids,
                     int32_t* out_levels, int32_t* out_rel,  // [n, cap+2]
                     int32_t* out_nbr, int64_t nbr_cap, int64_t* out_nbr_off,
                     float* out_vecs, uint8_t* out_is_new,
                     int64_t max_records) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t n = 0;
  int64_t nbr_pos = 0;
  while (p < end && n < max_records) {
    if (p + 13 > end) return -1;
    const uint8_t isn = static_cast<uint8_t>(*p++);
    int32_t v, lv, total;
    std::memcpy(&v, p, 4);
    p += 4;
    std::memcpy(&lv, p, 4);
    p += 4;
    std::memcpy(&total, p, 4);
    p += 4;
    if (lv < 0 || lv > max_level_cap || total < 0) return -2;
    if (p + 4 * (lv + 1) + 4 * static_cast<int64_t>(total) > end) return -3;
    out_ids[n] = v;
    out_levels[n] = lv;
    out_is_new[n] = isn;
    int32_t* rel = out_rel + n * (max_level_cap + 2);
    for (int32_t l = 0; l <= lv; ++l) {
      std::memcpy(rel + l, p, 4);
      p += 4;
    }
    for (int32_t l = lv + 1; l < max_level_cap + 2; ++l) rel[l] = rel[lv];
    if (nbr_pos + total > nbr_cap) return -4;
    std::memcpy(out_nbr + nbr_pos, p, 4 * static_cast<int64_t>(total));
    p += 4 * static_cast<int64_t>(total);
    out_nbr_off[n] = nbr_pos;
    nbr_pos += total;
    if (isn && has_vec) {
      if (p + 4 * static_cast<int64_t>(dim) > end) return -5;
      std::memcpy(out_vecs + n * static_cast<int64_t>(dim), p, 4 * dim);
      p += 4 * static_cast<int64_t>(dim);
    }
    ++n;
  }
  out_nbr_off[n] = nbr_pos;
  return n;
}

// ---------------------------------------------------------------------------
// Reference graph-dump parsers (parity/ref_harness.cc dump formats). The
// Python struct loops cost ~17 min at 1M nodes; these mmap scans are <1 s.
// ---------------------------------------------------------------------------

namespace {
struct MappedFile {
  const uint8_t* data = nullptr;
  int64_t size = 0;
  int fd = -1;
  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = st.st_size;
    data = static_cast<const uint8_t*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    return data != MAP_FAILED;
  }
  ~MappedFile() {
    if (data && data != MAP_FAILED) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) close(fd);
  }
};
}  // namespace

// Slim dump: u32 'HSLG' | u32 n | i32 maxlevel | u32 entry | i32 Lt |
// u32 maxM | u32 maxM0 | per node: i32 level | u32 total |
// u32 end_off[level+1] | i32 ids[total].
// Fills levels[n], lvl_off[n*(maxlevel+2)] (prefix offsets into nbr), and —
// when nbr != null — nbr[total_edges]. Returns total_edges, or <0 on error.
// Call once with nbr=null to size the edge array, then again to fill.
int64_t slim_graph_parse(const char* path, int32_t* levels, int32_t* lvl_off,
                         int32_t* nbr) {
  MappedFile f;
  if (!f.open(path)) return -1;
  if (f.size < 28) return -2;
  const uint8_t* p = f.data;
  uint32_t magic, n, entry, maxm, maxm0;
  int32_t maxlevel, lt;
  std::memcpy(&magic, p, 4);
  std::memcpy(&n, p + 4, 4);
  std::memcpy(&maxlevel, p + 8, 4);
  std::memcpy(&entry, p + 12, 4);
  std::memcpy(&lt, p + 16, 4);
  std::memcpy(&maxm, p + 20, 4);
  std::memcpy(&maxm0, p + 24, 4);
  if (magic != 0x48534C47u) return -3;
  p += 28;
  const uint8_t* end = f.data + f.size;
  const int32_t stride = maxlevel + 2;
  int64_t total_edges = 0;
  for (uint32_t v = 0; v < n; ++v) {
    if (p + 8 > end) return -4;
    int32_t lv;
    uint32_t total;
    std::memcpy(&lv, p, 4);
    std::memcpy(&total, p + 4, 4);
    p += 8;
    if (lv < 0 || lv > maxlevel) return -5;
    if (p + 4 * (lv + 1) + 4 * static_cast<int64_t>(total) > end) return -6;
    if (levels) levels[v] = lv;
    if (lvl_off) {
      int32_t* row = lvl_off + static_cast<int64_t>(v) * stride;
      row[0] = static_cast<int32_t>(total_edges);
      const uint8_t* ends = p;
      for (int32_t l = 0; l <= maxlevel; ++l) {
        uint32_t e;
        std::memcpy(&e, ends + 4 * (l <= lv ? l : lv), 4);
        row[l + 1] = static_cast<int32_t>(total_edges + e);
      }
    }
    p += 4 * (lv + 1);
    if (nbr)
      std::memcpy(nbr + total_edges, p, 4 * static_cast<int64_t>(total));
    p += 4 * static_cast<int64_t>(total);
    total_edges += total;
  }
  return total_edges;
}

// CHAL packing (hnswalg_slim.h:1088-1106): flatten per-level neighbor row
// arrays into one contiguous id stream with per-node per-level prefix
// offsets. rows: lcnt pointers to int32[n, widths[l]] arrays (-1 = empty
// slot); levels[v] < l disables level l for node v (level -1 = padding row).
// Fills lvl_off[n*(lcnt+1)] and — when nbr != null — nbr[..]. Returns total
// edge count (call with nbr=null to size, then again to fill).
int64_t chal_pack(const int32_t** rows, const int32_t* widths, int32_t lcnt,
                  const int32_t* levels, int64_t n, int32_t* lvl_off,
                  int32_t* nbr) {
  int64_t pos = 0;
  for (int64_t v = 0; v < n; ++v) {
    int32_t* off = lvl_off + v * (lcnt + 1);
    off[0] = static_cast<int32_t>(pos);
    const int32_t lv = levels[v];
    for (int32_t l = 0; l < lcnt; ++l) {
      if (lv >= l) {
        const int32_t w = widths[l];
        const int32_t* r = rows[l] + v * w;
        for (int32_t j = 0; j < w; ++j) {
          if (r[j] >= 0) {
            if (nbr) nbr[pos] = r[j];
            ++pos;
          }
        }
      }
      off[l + 1] = static_cast<int32_t>(pos);
    }
  }
  return pos;
}

// HNSW dump: u32 'HNSG' | u32 n | i32 maxlevel | u32 entry | u32 maxM |
// u32 maxM0 | per node: i32 level | per l in 0..level: u32 cnt | i32 ids.
// adjs: array of maxlevel+1 pointers, adjs[l] -> int32[n, l==0?maxm0:maxm]
// buffers PRE-FILLED with -1. Returns n, or <0 on error.
int64_t hnsw_graph_parse(const char* path, int32_t* levels, int32_t** adjs) {
  MappedFile f;
  if (!f.open(path)) return -1;
  if (f.size < 24) return -2;
  const uint8_t* p = f.data;
  uint32_t magic, n, entry, maxm, maxm0;
  int32_t maxlevel;
  std::memcpy(&magic, p, 4);
  std::memcpy(&n, p + 4, 4);
  std::memcpy(&maxlevel, p + 8, 4);
  std::memcpy(&entry, p + 12, 4);
  std::memcpy(&maxm, p + 16, 4);
  std::memcpy(&maxm0, p + 20, 4);
  if (magic != 0x484E5347u) return -3;
  p += 24;
  const uint8_t* end = f.data + f.size;
  for (uint32_t v = 0; v < n; ++v) {
    if (p + 4 > end) return -4;
    int32_t lv;
    std::memcpy(&lv, p, 4);
    p += 4;
    if (lv < 0 || lv > maxlevel) return -5;
    levels[v] = lv;
    for (int32_t l = 0; l <= lv; ++l) {
      if (p + 4 > end) return -6;
      uint32_t cnt;
      std::memcpy(&cnt, p, 4);
      p += 4;
      const uint32_t cap = l == 0 ? maxm0 : maxm;
      if (cnt > cap || p + 4 * static_cast<int64_t>(cnt) > end) return -7;
      std::memcpy(adjs[l] + static_cast<int64_t>(v) * cap, p, 4 * cnt);
      p += 4 * static_cast<int64_t>(cnt);
    }
  }
  return n;
}

}  // extern "C"
