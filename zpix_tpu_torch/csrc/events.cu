// Timing events for runtime.launch while spans are recorded
// (utils/profiling.py): a pair of CUDA events around one C entry's work,
// recorded by the entry itself (timing.cuh), and the card's time between
// them read once the second has completed.  Each extern "C" function
// returns a cudaError_t.  runtime.py calls all but zpix_event_synchronize
// without letting go of the interpreter lock: none of them waits, and
// each let-go would be a chance for another Python thread to take the
// lock from the launching thread for a switch interval.
#include <cuda_runtime.h>

#include "timing.cuh"

namespace zpix {
thread_local ArmedEvents armed_events;
}  // namespace zpix

extern "C" int zpix_event_create(void** event) {
  return static_cast<int>(cudaEventCreate(reinterpret_cast<cudaEvent_t*>(event)));
}

// The calling thread's next entry records ``start`` where it starts and
// ``end`` where it returns.
extern "C" int zpix_event_arm(void* start, void* end) {
  zpix::armed_events = {static_cast<cudaEvent_t>(start), static_cast<cudaEvent_t>(end),
                        cudaSuccess, false};
  return 0;
}

// After that entry: the first of its records that failed, or
// cudaErrorNotReady where no entry recorded the pair (the arming is
// cleared either way).
extern "C" int zpix_event_disarm() {
  const zpix::ArmedEvents done = zpix::armed_events;
  zpix::armed_events = {};
  if (!done.recorded) return static_cast<int>(cudaErrorNotReady);
  return static_cast<int>(done.err);
}

extern "C" int zpix_event_synchronize(void* event) {
  return static_cast<int>(cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
}

// The card's ms from ``start`` to ``end``: cudaErrorNotReady, never waiting,
// while ``end`` has not completed.
extern "C" int zpix_event_read(void* start, void* end, float* ms) {
  const cudaError_t e = cudaEventQuery(static_cast<cudaEvent_t>(end));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaEventElapsedTime(ms, static_cast<cudaEvent_t>(start), static_cast<cudaEvent_t>(end)));
}
