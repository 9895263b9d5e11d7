// Native mmap core for safetensors reading (effort-tpu's PyTorch port; the
// same source and C ABI as the JAX package's effort_tpu/native/, so the two
// packages read each other's files alike).
//
// One mapping covers the whole file; Python wraps the pointer as a
// zero-copy numpy view (runtime/safetensors_io.py).
//
// Exposed C ABI (ctypes):
//   effort_mmap_open(path, *size) -> handle (0 on failure)
//   effort_mmap_ptr(handle)       -> base pointer
//   effort_mmap_advise_sequential(handle)
//   effort_mmap_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapping {
  void* base;
  uint64_t size;
};

}  // namespace

extern "C" {

void* effort_mmap_open(const char* path, uint64_t* size_out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                      MAP_PRIVATE, fd, 0);
  ::close(fd);  // mapping survives the fd
  if (base == MAP_FAILED) return nullptr;
  ::madvise(base, static_cast<size_t>(st.st_size), MADV_WILLNEED);
  auto* m = new Mapping{base, static_cast<uint64_t>(st.st_size)};
  if (size_out) *size_out = m->size;
  return m;
}

void* effort_mmap_ptr(void* handle) {
  return handle ? static_cast<Mapping*>(handle)->base : nullptr;
}

void effort_mmap_advise_sequential(void* handle) {
  if (!handle) return;
  auto* m = static_cast<Mapping*>(handle);
  ::madvise(m->base, m->size, MADV_SEQUENTIAL);
}

void effort_mmap_close(void* handle) {
  if (!handle) return;
  auto* m = static_cast<Mapping*>(handle);
  ::munmap(m->base, m->size);
  delete m;
}

}  // extern "C"
