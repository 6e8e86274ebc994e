/* multiviewnative_jax — C ABI for JNA/Fiji-style clients.
 *
 * Drop-in ABI match for the reference library's public surface
 * (reference inc/multiviewnative.h:15-109): identical struct layouts
 * and function names, so a JNA client switches engines by swapping the
 * shared library.  The implementation (src/bridge.cpp) hosts an embedded
 * CPython interpreter and dispatches into the JAX engine
 * (libmultiviewnative_jax.native_entry); psi/image buffers are mutated in
 * place exactly as the reference contract requires.
 *
 * Dims arrays are int[3] in (z, y, x) C order, matching the reference's
 * image_stack convention (/root/reference/inc/image_stack_utils.h:10-21).
 */
#ifndef MULTIVIEWNATIVE_JAX_H
#define MULTIVIEWNATIVE_JAX_H

#include <stddef.h>

typedef float imageType;

#ifdef __cplusplus
#define MVN_API extern "C"
#else
#define MVN_API
#endif

struct view_data {
  imageType* image_;
  imageType* kernel1_;
  imageType* kernel2_;
  imageType* weights_;

  int* image_dims_;
  int* kernel1_dims_;
  int* kernel2_dims_;
  int* weights_dims_;
};

struct workspace {
  struct view_data* data_;
  unsigned short num_views_;
  double lambda_;
  float minValue_;
  int num_iterations_;
};

/* full multi-view RL deconvolution; psi is read as the start estimate and
 * overwritten with the result.  nthreads is accepted for ABI parity; the
 * JAX engine ignores it (XLA owns parallelism). */
MVN_API void inplace_cpu_deconvolve(imageType* psi, struct workspace input,
                                    int nthreads);

/* single 3D FFT convolution, image overwritten (circular boundary). */
MVN_API void inplace_cpu_convolution(imageType* im, int* imDim,
                                     imageType* kernel, int* kernelDim,
                                     int nthreads);

/* GPU-named entry points of the reference map to the same JAX engine; the
 * device argument selects a jax device index (pass 0). */
MVN_API void inplace_gpu_deconvolve(imageType* psi, struct workspace input,
                                    int device);
MVN_API void inplace_gpu_convolution(imageType* im, int* imDim,
                                     imageType* kernel, int* kernelDim,
                                     int device);
MVN_API void convolution3DfftCUDAInPlace(imageType* im, int* imDim,
                                         imageType* kernel, int* kernelDim,
                                         int devCUDA);
/* _core variant of the legacy path (reference .h:79-84 operates on
 * device-resident pointers; no host/device split exists here, so it is the
 * same operation). */
MVN_API void convolution3DfftCUDAInPlace_core(imageType* im, int* imDim,
                                              imageType* kernel,
                                              int* kernelDim, int devCUDA);

/* single-step helpers (reference .h:84-97) */
MVN_API void compute_quotient(imageType* input, imageType* output, size_t size,
                              int device);
MVN_API void compute_final_values(imageType* image, imageType* integral,
                                  imageType* weight, size_t size,
                                  float minValue, double lambda, int device);
MVN_API void iterate_fft_plain(imageType* input, imageType* kernel,
                               imageType* output, int* input_dims,
                               int* kernel_dims, int device);
MVN_API void iterate_fft_tikhonov(imageType* input, imageType* kernel,
                                  imageType* output, int* input_dims,
                                  int* kernel_dims, size_t size,
                                  float minValue, double lambda, int device);

/* device queries (reference .h:99-109) */
MVN_API int selectDeviceWithHighestComputeCapability(void);
MVN_API int getNumDevicesCUDA(void);
MVN_API void getNameDeviceCUDA(int device, char* name); /* name: >=256 bytes */
MVN_API long long int getMemDeviceCUDA(int device);
MVN_API int getCUDAcomputeCapabilityMajorVersion(int device);
MVN_API int getCUDAcomputeCapabilityMinorVersion(int device);

/* Extras: explicit interpreter lifecycle for host applications
 * that want deterministic startup/teardown (optional — every call above
 * initializes lazily). */
MVN_API int mvn_jax_initialize(void);
MVN_API void mvn_jax_finalize(void);
MVN_API const char* mvn_jax_last_error(void);

#endif /* MULTIVIEWNATIVE_JAX_H */
