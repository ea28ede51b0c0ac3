// Native data-loader core: parallel .npy read + crop into batch buffers.
//
// Counterpart of latent_diffusion_speech_tpu/data/native/npy_batch.cc (the
// port keeps its own copy and builds it itself).  The hot path (parse the npy
// header, pread the cropped frame range, scatter into the batch buffer) is
// C++ with a persistent pthread pool, exposed through a plain C ABI for
// ctypes.  No Python objects cross the boundary; the GIL is released for the
// whole batch read.
//
// Supported payloads: little-endian f32/f16/i32/i64 C-order arrays (the
// pipeline's units/mel/semantic_token files).  Crops are row ranges on axis 0.
//
// One change from the JAX package's copy: a batch call counts its finished
// files down under `done_mu`, so the caller cannot see the count reach zero
// and return (destroying the mutex and condition variable on its stack)
// while the last worker is still about to lock them.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct NpyInfo {
  uint64_t header_bytes = 0;  // offset of payload
  uint64_t rows = 0;          // shape[0]
  uint64_t row_bytes = 0;     // product(shape[1:]) * itemsize
  char dtype = 0;             // 'f' f32, 'e' f16, 'i' i32, 'q' i64
  bool ok = false;
};

// Parse just enough of the npy v1/v2 header.
NpyInfo parse_header(int fd) {
  NpyInfo info;
  unsigned char magic[10];
  if (pread(fd, magic, 10, 0) != 10) return info;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  int major = magic[6];
  uint32_t hlen;
  uint64_t header_start;
  if (major == 1) {
    hlen = magic[8] | (magic[9] << 8);
    header_start = 10;
  } else {
    unsigned char ext[4];
    if (pread(fd, ext, 4, 8) != 4) return info;
    hlen = ext[0] | (ext[1] << 8) | (ext[2] << 16) | ((uint32_t)ext[3] << 24);
    header_start = 12;
  }
  std::string header(hlen, '\0');
  if (pread(fd, header.data(), hlen, header_start) != (ssize_t)hlen) return info;
  info.header_bytes = header_start + hlen;

  // dtype
  size_t dp = header.find("'descr':");
  if (dp == std::string::npos) return info;
  size_t q1 = header.find('\'', dp + 8);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  uint64_t itemsize = 0;
  if (descr == "<f4") { info.dtype = 'f'; itemsize = 4; }
  else if (descr == "<f2") { info.dtype = 'e'; itemsize = 2; }
  else if (descr == "<i4") { info.dtype = 'i'; itemsize = 4; }
  else if (descr == "<i8") { info.dtype = 'q'; itemsize = 8; }
  else return info;

  if (header.find("'fortran_order': True") != std::string::npos) return info;

  // shape tuple
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return info;
  size_t p1 = header.find('(', sp);
  size_t p2 = header.find(')', p1);
  std::string shape_s = header.substr(p1 + 1, p2 - p1 - 1);
  std::vector<uint64_t> dims;
  uint64_t cur = 0;
  bool have = false;
  for (char c : shape_s) {
    if (c >= '0' && c <= '9') { cur = cur * 10 + (c - '0'); have = true; }
    else if (c == ',') { if (have) dims.push_back(cur); cur = 0; have = false; }
  }
  if (have) dims.push_back(cur);
  if (dims.empty()) return info;

  info.rows = dims[0];
  uint64_t inner = 1;
  for (size_t i = 1; i < dims.size(); ++i) inner *= dims[i];
  info.row_bytes = inner * itemsize;
  info.ok = true;
  return info;
}

struct Task {
  std::function<void()> fn;
};

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          Task task;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task.fn();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push(Task{std::move(fn)});
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<Task> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

void* npy_pool_create(int num_threads) {
  if (num_threads <= 0) num_threads = 4;
  return new ThreadPool(num_threads);
}

void npy_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

// Inspect one file: returns 0 on success; fills rows/row_bytes/dtype.
int npy_probe(const char* path, uint64_t* rows, uint64_t* row_bytes, char* dtype) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  NpyInfo info = parse_header(fd);
  close(fd);
  if (!info.ok) return -2;
  *rows = info.rows;
  *row_bytes = info.row_bytes;
  *dtype = info.dtype;
  return 0;
}

// Read rows [start, start+count) of each f32 file, converting to bfloat16
// (round-to-nearest-even, matching ml_dtypes/XLA) fused into the read pass:
// each worker preads into a thread-local f32 staging buffer and writes bf16
// to out + i*count*row_bytes_f32/2.  Saves the separate numpy astype pass
// (and its extra full-size write) that a read-then-cast host pipeline pays.
// Same failure contract as npy_read_batch.
int npy_read_batch_bf16(void* pool_ptr, const char** paths,
                        const int64_t* starts, int64_t count, int64_t n_files,
                        uint64_t row_bytes_f32, unsigned char* out) {
  auto* pool = static_cast<ThreadPool*>(pool_ptr);
  std::atomic<int64_t> failed{0};
  int64_t remaining = n_files;  // guarded by done_mu
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int64_t i = 0; i < n_files; ++i) {
    pool->submit([&, i] {
      int fd = open(paths[i], O_RDONLY);
      bool ok = fd >= 0;
      if (ok) {
        NpyInfo info = parse_header(fd);
        ok = info.ok && info.dtype == 'f' && info.row_bytes == row_bytes_f32 &&
             (uint64_t)(starts[i] + count) <= info.rows;
        if (ok) {
          uint64_t nbytes = (uint64_t)count * row_bytes_f32;
          uint64_t off = info.header_bytes + (uint64_t)starts[i] * row_bytes_f32;
          uint16_t* dst =
              reinterpret_cast<uint16_t*>(out + (uint64_t)i * (nbytes / 2));
          // stream in L2-sized chunks: pread f32 -> convert -> bf16 out
          constexpr uint64_t kChunk = 1 << 18;  // 256 KiB staging
          thread_local std::vector<unsigned char> stage;
          if (stage.size() < kChunk) stage.resize(kChunk);
          uint64_t done = 0;
          while (ok && done < nbytes) {
            uint64_t want = nbytes - done < kChunk ? nbytes - done : kChunk;
            uint64_t got = 0;
            while (got < want) {
              ssize_t r = pread(fd, stage.data() + got, want - got,
                                off + done + got);
              if (r <= 0) { ok = false; break; }
              got += r;
            }
            if (!ok) break;
            const uint32_t* src = reinterpret_cast<const uint32_t*>(stage.data());
            uint64_t n = want / 4;
            uint16_t* o = dst + done / 4;
            for (uint64_t k = 0; k < n; ++k) {
              uint32_t u = src[k];
              if ((u & 0x7FFFFFFFu) > 0x7F800000u) {
                // canonical qNaN, matching ml_dtypes/Eigen (which canonicalize
                // every NaN payload) so the fused read stays bit-identical to
                // .astype(ml_dtypes.bfloat16) even for non-canonical inputs
                o[k] = (u >> 31) ? (uint16_t)0xFFC0 : (uint16_t)0x7FC0;
              } else {
                uint32_t bias = 0x7FFFu + ((u >> 16) & 1u);  // RNE
                o[k] = (uint16_t)((u + bias) >> 16);
              }
            }
            done += want;
          }
        }
        close(fd);
      }
      if (!ok) {
        int64_t expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
      std::lock_guard<std::mutex> lk(done_mu);
      if (--remaining == 0) done_cv.notify_one();
    });
  }

  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining == 0; });
  return failed.load() ? (int)-failed.load() : 0;
}

// Read rows [start, start+count) of each file into out + i*count*row_bytes.
// All files must share row_bytes (checked).  Returns 0 on success, else the
// (1-based) index of the first failing file negated.
int npy_read_batch(void* pool_ptr, const char** paths, const int64_t* starts,
                   int64_t count, int64_t n_files, uint64_t row_bytes,
                   unsigned char* out) {
  auto* pool = static_cast<ThreadPool*>(pool_ptr);
  std::atomic<int64_t> failed{0};
  int64_t remaining = n_files;  // guarded by done_mu
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int64_t i = 0; i < n_files; ++i) {
    pool->submit([&, i] {
      int fd = open(paths[i], O_RDONLY);
      bool ok = fd >= 0;
      if (ok) {
        NpyInfo info = parse_header(fd);
        ok = info.ok && info.row_bytes == row_bytes &&
             (uint64_t)(starts[i] + count) <= info.rows;
        if (ok) {
          uint64_t nbytes = (uint64_t)count * row_bytes;
          uint64_t off = info.header_bytes + (uint64_t)starts[i] * row_bytes;
          unsigned char* dst = out + (uint64_t)i * nbytes;
          uint64_t got = 0;
          while (got < nbytes) {
            ssize_t r = pread(fd, dst + got, nbytes - got, off + got);
            if (r <= 0) { ok = false; break; }
            got += r;
          }
        }
        close(fd);
      }
      if (!ok) {
        int64_t expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
      std::lock_guard<std::mutex> lk(done_mu);
      if (--remaining == 0) done_cv.notify_one();
    });
  }

  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining == 0; });
  return failed.load() ? (int)-failed.load() : 0;
}

}  // extern "C"
