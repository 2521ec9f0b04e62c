// A host-side step done once per CUDA device, such as the opt-in of a
// kernel to more than 48 KB of dynamic shared memory:
// cudaFuncSetAttribute acts on the current device only, so a process that
// launches on two devices (the pipeline stages of one rank) must set the
// attribute on each of them before its first launch there.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace atoma {

// The most devices one process addresses.
constexpr int kMaxDevices = 64;

// One flag and one result per device; keep one static instance per step.
struct PerDevice {
  std::once_flag once[kMaxDevices];
  cudaError_t result[kMaxDevices];
};

// Run ``step`` (a callable returning cudaError_t) once on the current
// device and return its result there, every call after the first included.
template <typename Step>
inline cudaError_t once_per_device(PerDevice& state, Step step) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(state.once[device], [&] { state.result[device] = step(); });
  return state.result[device];
}

}  // namespace atoma
