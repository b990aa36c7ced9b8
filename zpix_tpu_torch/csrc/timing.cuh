// The card's time in one C entry's work, for runtime.launch while spans
// are recorded (utils/profiling.py): zpix_event_arm (events.cu) hands the
// calling thread a pair of CUDA events for its next entry, and the
// entry's TimedEntry, its first statement, records the first event where
// the entry starts and the second where it returns, on the entry's
// stream.  Between them lies nothing but the entry itself: its kernels,
// and where the stream was idle, the card's wait for the entry's own host
// code to issue them (microseconds a launch); no Python, and no wait of
// the calling thread for the interpreter lock.  Unarmed (the usual case),
// a TimedEntry reads one thread-local pointer.
#pragma once

#include <cuda_runtime.h>

namespace zpix {

struct ArmedEvents {
  cudaEvent_t start = nullptr;
  cudaEvent_t end = nullptr;
  cudaError_t err = cudaSuccess;  // the first record that failed
  bool recorded = false;          // an entry recorded the pair
};

extern thread_local ArmedEvents armed_events;

class TimedEntry {
 public:
  explicit TimedEntry(void* stream) : stream_(static_cast<cudaStream_t>(stream)) {
    if (armed_events.start != nullptr) record(armed_events.start);
  }
  ~TimedEntry() {
    if (armed_events.start == nullptr) return;
    record(armed_events.end);
    armed_events.start = armed_events.end = nullptr;
    armed_events.recorded = true;
  }
  TimedEntry(const TimedEntry&) = delete;
  TimedEntry& operator=(const TimedEntry&) = delete;

 private:
  void record(cudaEvent_t event) {
    const cudaError_t e = cudaEventRecord(event, stream_);
    if (e != cudaSuccess && armed_events.err == cudaSuccess) armed_events.err = e;
  }
  cudaStream_t stream_;
};

}  // namespace zpix
