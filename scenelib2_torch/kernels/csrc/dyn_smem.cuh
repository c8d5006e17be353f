// The dynamic shared memory of a kernel: the most it may take on the
// current device, and the opt-in above what a kernel has without one.
//
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize) belongs
// to the current device; it is set only where a launch needs more than the
// 48 KB a block has without opting in, and then to the most the device
// allows (K2 over 640 features at radius 110 ran the same with the launch's
// own 54 KB, PERF.md section 6). Launches that fit keep the kernel's default.
// Included by search.cu (K2, K8), shi_tomasi.cu (K6) and particle_search.cu
// (K13).
#pragma once

#include <cuda_runtime.h>

#define DS_DEVICES 64
#define DS_DEFAULT (48 * 1024)  // a block's shared memory, static and dynamic, without opting in

struct DynSmem {
  const void* fn;
  int max[DS_DEVICES];  // bytes of dynamic shared memory fn may take on device d (0: not yet read)
  int set[DS_DEVICES];  // the opt-in set on device d (0: none)
  int stat;             // fn's static shared memory
};

// *bytes: the most dynamic shared memory ds->fn may take on the current device
static cudaError_t ds_max(DynSmem* ds, int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= DS_DEVICES) return cudaErrorInvalidDevice;
  if (ds->max[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, ds->fn);
    if (e != cudaSuccess) return e;
    ds->stat = (int)fa.sharedSizeBytes;
    ds->max[dev] = optin - ds->stat;
  }
  *bytes = ds->max[dev];
  return cudaSuccess;
}

// opts ds->fn in to the most dynamic shared memory the current device
// allows where a launch of `bytes` needs it, back to the default where it
// does not (after ds_max)
static cudaError_t ds_prepare(DynSmem* ds, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int want = ds->stat + bytes > DS_DEFAULT ? ds->max[dev] : 0;
  if (want == ds->set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(ds->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           want ? want : DS_DEFAULT - ds->stat);
  if (e == cudaSuccess) ds->set[dev] = want;
  return e;
}
