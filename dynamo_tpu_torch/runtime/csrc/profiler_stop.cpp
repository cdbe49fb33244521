// Stop the calling thread's Kineto profiler session and write its Chrome
// trace, in C++ alone. Called through ctypes, which lets go of the GIL for
// the call: the stop turns every record of the capture into a trace event,
// tens of microseconds a record and seconds for a capture of a loaded
// worker, and torch.autograd's own binding of it holds the GIL throughout,
// which stalls every other thread of the process.
//
// No PyTorch header is included, so the build takes a second: the two
// functions called are declared as torch/csrc/autograd/profiler_kineto.h
// declares them (libtorch_cpu exports both), and the result is used only
// through its pointer. Built with -fno-sized-deallocation, so that its
// delete passes no size of this declaration's making.
#include <cstdio>
#include <exception>
#include <memory>
#include <string>

namespace torch::autograd::profiler {
struct ProfilerResult {
  ~ProfilerResult();
  void save(const std::string& path);
};
std::unique_ptr<ProfilerResult> disableProfiler();
}  // namespace torch::autograd::profiler

// Returns 0, or 1 with the exception's text in ``error``.
extern "C" int profiler_stop_and_save(const char* path, char* error, int error_len) {
  try {
    auto result = torch::autograd::profiler::disableProfiler();
    if (result) result->save(path);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(error, error_len, "%s", e.what());
    return 1;
  }
}
