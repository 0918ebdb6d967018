// Native frame I/O of the PyTorch/CUDA port: raw YUV luma read, the int32
// frame write with u8 narrowing, and the 5-frame stacked output with its
// |a-b| difference frames. The host-side pieces around the search, as in
// the reference's C frame layer.
//
// Reads are mmap'd and copied in one pass; the writer narrows with a plain
// cast (mod 256), as the reference's yuvWriteFrame does. A C ABI for
// ctypes: every function returns 0 on success and a negative errno on
// failure (-EINVAL for a file shorter than one frame).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// out = |a - b| elementwise.
void abs_diff(const int32_t* a, const int32_t* b, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t d = a[i] - b[i];
    out[i] = d < 0 ? -d : d;
  }
}

}  // namespace

extern "C" {

// Read the first h*w bytes of a raw YUV file into out_u8 (mmap + memcpy).
int me_read_frame_u8(const char* path, int64_t h, int64_t w,
                     uint8_t* out_u8) {
  const int64_t n = h * w;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int e = -errno;
    close(fd);
    return e;
  }
  if (st.st_size < n) {
    close(fd);
    return -EINVAL;
  }
  if (n == 0) {
    close(fd);
    return 0;
  }
  void* m = mmap(nullptr, static_cast<size_t>(n), PROT_READ, MAP_PRIVATE,
                 fd, 0);
  if (m == MAP_FAILED) {
    int e = -errno;
    close(fd);
    return e;
  }
  memcpy(out_u8, m, static_cast<size_t>(n));
  munmap(m, static_cast<size_t>(n));
  close(fd);
  return 0;
}

// Write an int32 frame as u8 bytes, plain-cast narrowing (mod 256).
int me_write_frame_i32(const char* path, const int32_t* in_i32, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -errno;
  constexpr int64_t kChunk = 1 << 20;
  std::vector<uint8_t> buf(static_cast<size_t>(n < kChunk ? n : kChunk));
  for (int64_t off = 0; off < n; off += kChunk) {
    const int64_t m = (n - off < kChunk) ? (n - off) : kChunk;
    for (int64_t i = 0; i < m; ++i)
      buf[i] = static_cast<uint8_t>(in_i32[off + i]);
    if (fwrite(buf.data(), 1, static_cast<size_t>(m), f) !=
        static_cast<size_t>(m)) {
      fclose(f);
      return -EIO;
    }
  }
  if (fclose(f) != 0) return -errno;
  return 0;
}

// The 5-frame stack [ref, cur, comp, |ref-cur|, |comp-cur|] straight into
// out (5*h*w entries).
int me_stack_output(const int32_t* ref, const int32_t* cur,
                    const int32_t* comp, int64_t h, int64_t w,
                    int32_t* out) {
  const int64_t n = h * w;
  memcpy(out, ref, sizeof(int32_t) * n);
  memcpy(out + n, cur, sizeof(int32_t) * n);
  memcpy(out + 2 * n, comp, sizeof(int32_t) * n);
  abs_diff(ref, cur, n, out + 3 * n);
  abs_diff(comp, cur, n, out + 4 * n);
  return 0;
}

}  // extern "C"
