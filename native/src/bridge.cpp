/* bridge.cpp — native runtime host for the JAX deconvolution engine.
 *
 * The reference implements its C ABI with FFTW/cuFFT C++ underneath
 * (reference src/multiviewnative.cpp, multiviewnative.cu).  This
 * equivalent keeps the same ABI but hosts an embedded CPython
 * interpreter whose process owns the XLA runtime: this file handles
 * interpreter lifecycle, GIL discipline, and zero-copy address marshaling;
 * libmultiviewnative_jax/native_entry.py wraps the raw pointers as numpy
 * arrays (in place) and dispatches into the JAX engine.
 *
 * Threading: every entry point is safe to call from arbitrary native
 * threads (PyGILState_Ensure).  Errors never cross the ABI: they are
 * recorded for mvn_jax_last_error() and printed to stderr, and outputs are
 * left untouched (the reference's error style is exit(); we prefer to keep
 * the host JVM alive).
 */

#include "../include/multiviewnative_jax.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_init_mutex;
bool g_we_initialized = false;
std::mutex g_error_mutex;
std::string g_last_error;
/* stable buffer returned by mvn_jax_last_error (the std::string may be
 * reallocated by a concurrent writer; callers get a snapshot) */
char g_error_snapshot[1024];

void set_last_error(const std::string& msg) {
  {
    std::lock_guard<std::mutex> lock(g_error_mutex);
    g_last_error = msg;
  }
  std::fprintf(stderr, "[multiviewnative_jax] %s\n", msg.c_str());
}

/* Ensure an interpreter exists.  If this library is loaded INTO a Python
 * process (e.g. ctypes tests), reuse it; otherwise (JNA/JVM host) start
 * one. Returns 0 on success. */
int ensure_python() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (Py_IsInitialized()) return 0;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    set_last_error("failed to initialize embedded Python");
    return -1;
  }
  g_we_initialized = true;
  /* Release the GIL acquired by Py_Initialize so worker threads can take
   * it via PyGILState_Ensure. */
  PyEval_SaveThread();
  return 0;
}

/* RAII GIL holder for arbitrary native threads. */
class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

void record_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = std::string(where) + ": python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* utf8 = PyUnicode_AsUTF8(s);
      if (utf8) {
        msg += ": ";
        msg += utf8;
      } else {
        PyErr_Clear(); /* conversion failure must not clobber the original */
        msg += ": <unprintable exception>";
      }
      Py_DECREF(s);
    }
  }
  set_last_error(msg);
  PyErr_Restore(type, value, trace);
  PyErr_Print();
}

/* Call libmultiviewnative_jax.native_entry.<fn>(*args). Steals args ref.
 * Returns the result object (new ref) or nullptr. */
PyObject* call_entry(const char* fn, PyObject* args) {
  PyObject* mod = PyImport_ImportModule("libmultiviewnative_jax.native_entry");
  if (!mod) {
    record_py_error("import libmultiviewnative_jax.native_entry");
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (!f) {
    record_py_error(fn);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!res) record_py_error(fn);
  return res;
}

PyObject* dims_tuple(const int* dims) {
  return Py_BuildValue("(iii)", dims[0], dims[1], dims[2]);
}

inline unsigned long long addr(const void* p) {
  return (unsigned long long)(uintptr_t)p;
}

}  // namespace

extern "C" {

int mvn_jax_initialize(void) { return ensure_python(); }

void mvn_jax_finalize(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_we_initialized && Py_IsInitialized()) {
    PyGILState_Ensure();
    Py_Finalize();
    g_we_initialized = false;
  }
}

const char* mvn_jax_last_error(void) {
  std::lock_guard<std::mutex> lock(g_error_mutex);
  std::snprintf(g_error_snapshot, sizeof(g_error_snapshot), "%s",
                g_last_error.c_str());
  return g_error_snapshot;
}

void inplace_cpu_deconvolve(imageType* psi, struct workspace input,
                            int nthreads) {
  (void)nthreads;
  if (!psi || input.num_views_ == 0 || input.data_ == nullptr) {
    set_last_error("inplace_cpu_deconvolve: empty workspace");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* views = PyList_New(input.num_views_);
  if (!views) return;
  for (int v = 0; v < input.num_views_; ++v) {
    const view_data& d = input.data_[v];
    PyObject* item = Py_BuildValue(
        "(KNKNKNKN)", addr(d.image_), dims_tuple(d.image_dims_),
        addr(d.kernel1_), dims_tuple(d.kernel1_dims_), addr(d.kernel2_),
        dims_tuple(d.kernel2_dims_), addr(d.weights_),
        dims_tuple(d.weights_dims_));
    if (!item) {
      Py_DECREF(views);
      record_py_error("inplace_cpu_deconvolve:marshal");
      return;
    }
    PyList_SET_ITEM(views, v, item);
  }
  /* psi shares the first view's image dims (reference semantics,
   * src/multiviewnative.cpp:180). */
  PyObject* args = Py_BuildValue(
      "(KNNdfi)", addr(psi), dims_tuple(input.data_[0].image_dims_), views,
      input.lambda_, (double)input.minValue_, input.num_iterations_);
  if (!args) {
    record_py_error("inplace_cpu_deconvolve:args");
    return;
  }
  PyObject* res = call_entry("inplace_deconvolve", args);
  Py_XDECREF(res);
}

void inplace_gpu_deconvolve(imageType* psi, struct workspace input,
                            int device) {
  (void)device; /* one engine; jax owns device placement */
  inplace_cpu_deconvolve(psi, input, 1);
}

void inplace_cpu_convolution(imageType* im, int* imDim, imageType* kernel,
                             int* kernelDim, int nthreads) {
  (void)nthreads;
  if (!im || !imDim || !kernel || !kernelDim) {
    set_last_error("inplace_cpu_convolution: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(KNKN)", addr(im), dims_tuple(imDim),
                                 addr(kernel), dims_tuple(kernelDim));
  if (!args) {
    record_py_error("inplace_cpu_convolution:args");
    return;
  }
  PyObject* res = call_entry("inplace_convolution", args);
  Py_XDECREF(res);
}

void inplace_gpu_convolution(imageType* im, int* imDim, imageType* kernel,
                             int* kernelDim, int device) {
  (void)device;
  inplace_cpu_convolution(im, imDim, kernel, kernelDim, 1);
}

void convolution3DfftCUDAInPlace(imageType* im, int* imDim, imageType* kernel,
                                 int* kernelDim, int devCUDA) {
  /* legacy Fiji entry point (reference src/multiviewnative.cu:199-238) */
  inplace_cpu_convolution(im, imDim, kernel, kernelDim, devCUDA);
}

void convolution3DfftCUDAInPlace_core(imageType* im, int* imDim,
                                      imageType* kernel, int* kernelDim,
                                      int devCUDA) {
  inplace_cpu_convolution(im, imDim, kernel, kernelDim, devCUDA);
}

void compute_quotient(imageType* input, imageType* output, size_t size,
                      int device) {
  (void)device;
  if (!input || !output) {
    set_last_error("compute_quotient: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* args =
      Py_BuildValue("(KKK)", addr(input), addr(output), (unsigned long long)size);
  PyObject* res = call_entry("compute_quotient", args);
  Py_XDECREF(res);
}

void compute_final_values(imageType* image, imageType* integral,
                          imageType* weight, size_t size, float minValue,
                          double lambda, int device) {
  (void)device;
  if (!image || !integral || !weight) {
    set_last_error("compute_final_values: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(KKKKfd)", addr(image), addr(integral),
                                 addr(weight), (unsigned long long)size,
                                 (double)minValue, lambda);
  PyObject* res = call_entry("compute_final_values", args);
  Py_XDECREF(res);
}

void iterate_fft_plain(imageType* input, imageType* kernel, imageType* output,
                       int* input_dims, int* kernel_dims, int device) {
  (void)device;
  if (!input || !kernel || !output || !input_dims || !kernel_dims) {
    set_last_error("iterate_fft_plain: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* args =
      Py_BuildValue("(KKKNN)", addr(input), addr(kernel), addr(output),
                    dims_tuple(input_dims), dims_tuple(kernel_dims));
  PyObject* res = call_entry("iterate_fft_plain", args);
  Py_XDECREF(res);
}

void iterate_fft_tikhonov(imageType* input, imageType* kernel,
                          imageType* output, int* input_dims, int* kernel_dims,
                          size_t size, float minValue, double lambda,
                          int device) {
  (void)device;
  (void)size;
  if (!input || !kernel || !output || !input_dims || !kernel_dims) {
    set_last_error("iterate_fft_tikhonov: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* args = Py_BuildValue(
      "(KKKNNfd)", addr(input), addr(kernel), addr(output),
      dims_tuple(input_dims), dims_tuple(kernel_dims), (double)minValue, lambda);
  PyObject* res = call_entry("iterate_fft_tikhonov", args);
  Py_XDECREF(res);
}

int getNumDevicesCUDA(void) {
  if (ensure_python()) return 0;
  GilGuard gil;
  PyObject* res = call_entry("get_num_devices", PyTuple_New(0));
  int n = res ? (int)PyLong_AsLong(res) : 0;
  Py_XDECREF(res);
  return n;
}

void getNameDeviceCUDA(int device, char* name) {
  if (!name) return;
  name[0] = '\0';
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* res = call_entry("get_device_name", Py_BuildValue("(i)", device));
  if (res) {
    const char* s = PyUnicode_AsUTF8(res);
    if (s) {
      std::strncpy(name, s, 255);
      name[255] = '\0';
    }
    Py_DECREF(res);
  }
}

long long int getMemDeviceCUDA(int device) {
  if (ensure_python()) return 0;
  GilGuard gil;
  PyObject* res = call_entry("get_device_mem", Py_BuildValue("(i)", device));
  long long n = res ? PyLong_AsLongLong(res) : 0;
  Py_XDECREF(res);
  return n;
}

int selectDeviceWithHighestComputeCapability(void) {
  if (ensure_python()) return 0;
  GilGuard gil;
  PyObject* res = call_entry("select_device", PyTuple_New(0));
  int n = res ? (int)PyLong_AsLong(res) : 0;
  Py_XDECREF(res);
  return n;
}

/* Compute-capability queries are not forwarded; report 0.0 (the
 * reference returns the CUDA properties, inc/cuda_helpers.cuh:70-82). */
int getCUDAcomputeCapabilityMajorVersion(int device) {
  (void)device;
  return 0;
}
int getCUDAcomputeCapabilityMinorVersion(int device) {
  (void)device;
  return 0;
}

} /* extern "C" */
