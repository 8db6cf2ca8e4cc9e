// Launch on the device that holds a wrapper's tensors, whatever device is
// current in the calling thread, and restore the caller's device after.
// cudaGetDevice and cudaSetDevice do not synchronise; when the devices
// already match this costs one cudaGetDevice.
#pragma once

#include <cuda_runtime.h>

struct VptDeviceGuard {
  int previous = -1;
  explicit VptDeviceGuard(int device) {
    int current = 0;
    cudaGetDevice(&current);
    if (current != device) {
      cudaSetDevice(device);
      previous = current;
    }
  }
  ~VptDeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};
