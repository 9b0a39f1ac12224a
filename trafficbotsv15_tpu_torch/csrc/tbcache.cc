// TBCache: memory-mapped fixed-record episode cache with threaded batch fill.
//
// The reference feeds training from gzip-compressed h5 via 4 torch DataLoader
// workers (data_h5_womd.py:206-216) — decompression-bound at ~10s of MB/s.
// TBCache stores the packed episodes uncompressed in one flat file of
// fixed-size records; batches are assembled by parallel memcpy straight out
// of the page cache. The file is produced by
// data/tbcache.py::write_cache (from h5 or synthetic episodes).
//
// Layout:
//   [u64 magic = 0x54424341434845]["u32 version"]["u32 n_fields"]["u64 n_episodes"]
//   ["u64 record_bytes"] then per field: [u32 name_len][name bytes]
//   [u32 dtype_code][u32 ndim][u64 dims...][u64 offset_in_record][u64 field_bytes]
//   then n_episodes records back-to-back, 64-byte aligned start.
//
// C API (ctypes-friendly):
//   tbc_open(path) -> handle (0 on failure)
//   tbc_n_episodes(h), tbc_n_fields(h), tbc_record_bytes(h)
//   tbc_field_info(h, i, name_out, cap, dtype_out, ndim_out, dims_out)
//   tbc_fill_batch(h, indices, n, field_idx, out)        -- one field
//   tbc_fill_batch_multi(h, indices, n, field_idx[], n_f, out_ptrs[], n_threads)
//   tbc_close(h)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x54424341434845ULL;  // "TBCACHE"

struct Field {
  std::string name;
  uint32_t dtype_code;  // numpy-ish: 0=f32 1=f16 2=i64 3=bool 4=i32 5=f64
  std::vector<uint64_t> dims;
  uint64_t offset;
  uint64_t nbytes;
};

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  uint64_t n_episodes = 0;
  uint64_t record_bytes = 0;
  uint64_t data_offset = 0;
  std::vector<Field> fields;
};

template <typename T>
T read_pod(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

}  // namespace

extern "C" {

void* tbc_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_WILLNEED);

  auto* c = new Cache();
  c->fd = fd;
  c->base = static_cast<const uint8_t*>(mem);
  c->file_bytes = st.st_size;

  const uint8_t* p = c->base;
  if (read_pod<uint64_t>(p) != kMagic) {
    delete c;
    return nullptr;
  }
  (void)read_pod<uint32_t>(p);  // version
  uint32_t n_fields = read_pod<uint32_t>(p);
  c->n_episodes = read_pod<uint64_t>(p);
  c->record_bytes = read_pod<uint64_t>(p);
  for (uint32_t i = 0; i < n_fields; ++i) {
    Field f;
    uint32_t name_len = read_pod<uint32_t>(p);
    f.name.assign(reinterpret_cast<const char*>(p), name_len);
    p += name_len;
    f.dtype_code = read_pod<uint32_t>(p);
    uint32_t ndim = read_pod<uint32_t>(p);
    for (uint32_t d = 0; d < ndim; ++d) f.dims.push_back(read_pod<uint64_t>(p));
    f.offset = read_pod<uint64_t>(p);
    f.nbytes = read_pod<uint64_t>(p);
    c->fields.push_back(std::move(f));
  }
  uint64_t header_end = p - c->base;
  c->data_offset = (header_end + 63) & ~uint64_t(63);
  return c;
}

int64_t tbc_n_episodes(void* h) { return static_cast<Cache*>(h)->n_episodes; }
int64_t tbc_n_fields(void* h) { return static_cast<Cache*>(h)->fields.size(); }
int64_t tbc_record_bytes(void* h) { return static_cast<Cache*>(h)->record_bytes; }

int tbc_field_info(void* h, int i, char* name_out, int name_cap, int* dtype_out,
                   int* ndim_out, int64_t* dims_out) {
  auto* c = static_cast<Cache*>(h);
  if (i < 0 || i >= (int)c->fields.size()) return -1;
  const Field& f = c->fields[i];
  std::snprintf(name_out, name_cap, "%s", f.name.c_str());
  *dtype_out = f.dtype_code;
  *ndim_out = f.dims.size();
  for (size_t d = 0; d < f.dims.size(); ++d) dims_out[d] = f.dims[d];
  return 0;
}

// Copy one field for n episodes into out (contiguous [n, *dims]).
int tbc_fill_batch(void* h, const int64_t* indices, int64_t n, int field_idx, uint8_t* out) {
  auto* c = static_cast<Cache*>(h);
  if (field_idx < 0 || field_idx >= (int)c->fields.size()) return -1;
  const Field& f = c->fields[field_idx];
  for (int64_t i = 0; i < n; ++i) {
    int64_t ep = indices[i];
    if (ep < 0 || ep >= (int64_t)c->n_episodes) return -2;
    const uint8_t* src = c->base + c->data_offset + ep * c->record_bytes + f.offset;
    std::memcpy(out + i * f.nbytes, src, f.nbytes);
  }
  return 0;
}

// Parallel fill of many fields; work items are (episode, field) pairs striped
// over the pool so big fields (map/pos ~240 KB) don't serialize the batch.
int tbc_fill_batch_multi(void* h, const int64_t* indices, int64_t n,
                         const int32_t* field_idx, int64_t n_f, uint8_t** out_ptrs,
                         int n_threads) {
  auto* c = static_cast<Cache*>(h);
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  const int64_t total = n * n_f;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&]() {
    for (;;) {
      int64_t w = next.fetch_add(1);
      if (w >= total) return;
      int64_t i = w / n_f;
      int64_t fi = w % n_f;
      int idx = field_idx[fi];
      if (idx < 0 || idx >= (int)c->fields.size()) {
        err.store(-1);
        return;
      }
      const Field& f = c->fields[idx];
      int64_t ep = indices[i];
      if (ep < 0 || ep >= (int64_t)c->n_episodes) {
        err.store(-2);
        return;
      }
      const uint8_t* src = c->base + c->data_offset + ep * c->record_bytes + f.offset;
      std::memcpy(out_ptrs[fi] + i * f.nbytes, src, f.nbytes);
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return err.load();
}

void tbc_close(void* h) {
  auto* c = static_cast<Cache*>(h);
  if (c->base) munmap(const_cast<uint8_t*>(c->base), c->file_bytes);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

}  // extern "C"
