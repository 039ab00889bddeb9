// Native clip loader: threaded .npy batch reader for the EEG data pipeline.
// The port's copy of csrc/clip_loader.cc, built by data/native_loader.py.
//
// The reference starves its GPU with per-item np.load in Dataset.__getitem__
// (utils/reader.py:270, 16 worker processes). Here a C++ thread pool reads,
// dtype-converts, channel-slices/pads and time-clips/pads whole batches
// directly into the caller's pinned [B, modal_ch, n_samples] float32 buffer,
// bypassing the Python allocator and GIL for the signal path.
//
// npy support: v1/v2 headers, C-order, 2-D arrays, dtypes <f4 and <f8.
//
// C ABI (ctypes-friendly):
//   void* clip_loader_create(int num_threads);
//   void  clip_loader_destroy(void*);
//   int   clip_loader_load_batch(void*, const char** paths, int n,
//             int ch_start, int ch_stop, int modal_ch,
//             long n_samples, float* out);
//     ch_stop < 0  -> slice [:modal_ch] (reference default);
//     returns 0 on success, (i+1) if file i failed.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  std::vector<char> data;
  size_t rows = 0, cols = 0;
  size_t word = 0;  // 4 or 8
};

bool parse_npy(FILE* f, NpyArray* out) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  if (header.find("'fortran_order': True") != std::string::npos) return false;
  size_t word = 0;
  if (header.find("'<f4'") != std::string::npos) word = 4;
  else if (header.find("'<f8'") != std::string::npos) word = 8;
  else return false;

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t open = header.find('(', sp);
  size_t close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = header.substr(open + 1, close - open - 1);
  size_t rows = 0, cols = 0;
  if (sscanf(shape.c_str(), "%zu , %zu", &rows, &cols) != 2 &&
      sscanf(shape.c_str(), "%zu, %zu", &rows, &cols) != 2 &&
      sscanf(shape.c_str(), "%zu,%zu", &rows, &cols) != 2)
    return false;

  out->rows = rows;
  out->cols = cols;
  out->word = word;
  out->data.resize(rows * cols * word);
  return fread(out->data.data(), 1, out->data.size(), f) == out->data.size();
}

// Load one clip into out[modal_ch * n_samples], applying channel slice/pad
// and time clip/pad (parity with utils/reader.py:496-516 + 269-277).
bool load_clip(const char* path, int ch_start, int ch_stop, int modal_ch,
               long n_samples, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyArray arr;
  bool ok = parse_npy(f, &arr);
  fclose(f);
  if (!ok) return false;

  long src_ch_begin = ch_start;
  long src_ch_end = (ch_stop < 0) ? (long)arr.rows : ch_stop;
  if (src_ch_end > (long)arr.rows) src_ch_end = (long)arr.rows;
  long n_src_ch = src_ch_end - src_ch_begin;
  if (n_src_ch < 0) n_src_ch = 0;
  if (n_src_ch > modal_ch) n_src_ch = modal_ch;  // silent truncate (parity)
  long n_src_t = (long)arr.cols < n_samples ? (long)arr.cols : n_samples;

  memset(out, 0, sizeof(float) * (size_t)modal_ch * (size_t)n_samples);
  for (long c = 0; c < n_src_ch; ++c) {
    const char* row = arr.data.data() + ((size_t)(src_ch_begin + c) * arr.cols) * arr.word;
    float* dst = out + (size_t)c * n_samples;
    if (arr.word == 4) {
      memcpy(dst, row, sizeof(float) * (size_t)n_src_t);
    } else {
      const double* src = reinterpret_cast<const double*>(row);
      for (long t = 0; t < n_src_t; ++t) dst[t] = (float)src[t];
    }
  }
  return true;
}

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !tasks.empty(); });
            if (stop && tasks.empty()) return;
            task = std::move(tasks.front());
            tasks.pop();
          }
          task();
        }
      });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks.push(std::move(f));
    }
    cv.notify_one();
  }
};

}  // namespace

extern "C" {

void* clip_loader_create(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new Pool(num_threads);
}

void clip_loader_destroy(void* p) { delete static_cast<Pool*>(p); }

int clip_loader_load_batch(void* p, const char** paths, int n, int ch_start,
                           int ch_stop, int modal_ch, long n_samples,
                           float* out) {
  Pool* pool = static_cast<Pool*>(p);
  std::atomic<int> remaining(n);
  std::atomic<int> failed(0);
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    float* dst = out + (size_t)i * modal_ch * n_samples;
    pool->submit([=, &remaining, &failed, &done_mu, &done_cv] {
      if (!load_clip(path, ch_start, ch_stop, modal_ch, n_samples, dst)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return failed.load();
}

}  // extern "C"
