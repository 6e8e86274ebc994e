/* abi_smoke — drives the shim from a pure C host (the JNA scenario):
 * the shared library must boot its own embedded interpreter, run a
 * 2-view deconvolution in-place, and report device info.
 *
 * Mirrors in spirit the reference's API-level smoke usage
 * (/root/reference/tests/test_cpu_asymm_convolve.cpp's C-ABI calls).
 * Run with PYTHONPATH pointing at the repo root.
 */
#include "../include/multiviewnative_jax.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define N 8
#define K 3
#define VOL (N * N * N)
#define KVOL (K * K * K)

static void fill_gaussian(float* k) {
  double s = 0.0;
  for (int z = 0; z < K; ++z)
    for (int y = 0; y < K; ++y)
      for (int x = 0; x < K; ++x) {
        double r2 = (z - 1) * (z - 1) + (y - 1) * (y - 1) + (x - 1) * (x - 1);
        double v = exp(-r2 / 2.0);
        k[(z * K + y) * K + x] = (float)v;
        s += v;
      }
  for (int i = 0; i < KVOL; ++i) k[i] /= (float)s;
}

int main(void) {
  if (mvn_jax_initialize() != 0) {
    fprintf(stderr, "init failed: %s\n", mvn_jax_last_error());
    return 1;
  }
  char name[256];
  getNameDeviceCUDA(0, name);
  printf("devices=%d name=%s mem=%lld\n", getNumDevicesCUDA(), name,
         getMemDeviceCUDA(0));

  int img_dims[3] = {N, N, N};
  int k_dims[3] = {K, K, K};

  static float images[2][VOL], weights[2][VOL], k1[2][KVOL], k2[2][KVOL];
  static float psi[VOL];
  for (int v = 0; v < 2; ++v) {
    fill_gaussian(k1[v]);
    for (int i = 0; i < KVOL; ++i) k2[v][i] = k1[v][KVOL - 1 - i];
    for (int i = 0; i < VOL; ++i) {
      images[v][i] = 100.0f + (float)((i * 7 + v * 13) % 50);
      weights[v][i] = 0.5f;
    }
  }
  for (int i = 0; i < VOL; ++i) psi[i] = 100.0f;

  struct view_data views[2];
  for (int v = 0; v < 2; ++v) {
    views[v].image_ = images[v];
    views[v].kernel1_ = k1[v];
    views[v].kernel2_ = k2[v];
    views[v].weights_ = weights[v];
    views[v].image_dims_ = img_dims;
    views[v].kernel1_dims_ = k_dims;
    views[v].kernel2_dims_ = k_dims;
    views[v].weights_dims_ = img_dims;
  }
  struct workspace ws;
  ws.data_ = views;
  ws.num_views_ = 2;
  ws.lambda_ = 0.006;
  ws.minValue_ = 1e-4f;
  ws.num_iterations_ = 2;

  inplace_cpu_deconvolve(psi, ws, 1);

  double mean = 0.0;
  int finite = 1;
  for (int i = 0; i < VOL; ++i) {
    if (!isfinite((double)psi[i])) finite = 0;
    mean += psi[i];
  }
  mean /= VOL;
  printf("psi mean=%.3f finite=%d changed=%d\n", mean, finite,
         fabs(mean - 100.0) > 1e-3);

  /* single convolution with an identity kernel must be a no-op */
  static float im2[VOL];
  for (int i = 0; i < VOL; ++i) im2[i] = (float)i;
  static float ident[KVOL];
  memset(ident, 0, sizeof(ident));
  ident[13] = 1.0f; /* center of 3x3x3 */
  inplace_cpu_convolution(im2, img_dims, ident, k_dims, 1);
  double err = 0.0;
  for (int i = 0; i < VOL; ++i) err += fabs(im2[i] - (double)i);
  printf("identity convolution L1 err=%.5f\n", err / VOL);

  mvn_jax_finalize();
  printf("OK\n");
  return 0;
}
