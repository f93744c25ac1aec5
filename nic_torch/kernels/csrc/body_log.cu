// The launch log of the per-pixel bodies, train (mlp_pixel, mlp_pixel_mma,
// ff_pixel_mma, ff_pixel_tf32, ff3_pixel, ff3_pixel_mma, ff3_pixel_tf32,
// ...) and decode. Each launcher calls nic_note_body with the very
// function pointer it launched, once the launch has succeeded; the log
// keeps the CUDA runtime's name of
// that __global__ (cudaFuncGetName) and a count per name. A check on the
// card reads which body ran from here: unlike a profiler trace, the log
// cannot come back without the launch.

#include <cuda_runtime.h>

#include <cstring>
#include <mutex>

namespace {

constexpr int kSlots = 32;     // distinct names kept
constexpr int kNameCap = 512;  // bytes kept of each name

struct BodyLog {
  char name[kSlots][kNameCap];
  long long count[kSlots];
  int n = 0;
  long long dropped = 0;  // launches of names past the kSlots-th
  std::mutex mu;
};

BodyLog& body_log() {
  static BodyLog log;
  return log;
}

}  // namespace

extern "C" void nic_note_body(const void* kernel) {
  const char* name = nullptr;
  if (cudaFuncGetName(&name, kernel) != cudaSuccess || name == nullptr)
    name = "(unnamed)";
  BodyLog& log = body_log();
  std::lock_guard<std::mutex> hold(log.mu);
  for (int i = 0; i < log.n; ++i) {
    if (std::strncmp(log.name[i], name, kNameCap - 1) == 0) {
      ++log.count[i];
      return;
    }
  }
  if (log.n == kSlots) {
    ++log.dropped;
    return;
  }
  std::strncpy(log.name[log.n], name, kNameCap - 1);
  log.name[log.n][kNameCap - 1] = '\0';
  log.count[log.n] = 1;
  ++log.n;
}

// Entry i of the log: its name into name[cap] and its count into *count.
// Returns the number of entries, or -1 if launches were dropped because
// the log was full (the caller then cannot trust it).
extern "C" int nic_body_log(int i, char* name, int cap, long long* count) {
  BodyLog& log = body_log();
  std::lock_guard<std::mutex> hold(log.mu);
  if (i >= 0 && i < log.n && cap > 0) {
    std::strncpy(name, log.name[i], cap - 1);
    name[cap - 1] = '\0';
    *count = log.count[i];
  }
  return log.dropped > 0 ? -1 : log.n;
}

extern "C" void nic_body_log_clear() {
  BodyLog& log = body_log();
  std::lock_guard<std::mutex> hold(log.mu);
  log.n = 0;
  log.dropped = 0;
}
