// Hierarchical cluster traversal for Hopper (sm_90a): closest hit and any
// hit over a two-level tree of <= 128 supers of S <= 32 clusters each.
//
// closest_hier_kernel replaces the TPU kernel _closest_kernel and
// any_hier_kernel replaces _any_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, trace_closest / trace_any on
// scenes with more than 128 padded clusters, launched through
// _pallas_trace).  The TPU kernels walk a block of 128-512 rays over the
// union of their supers, then of each super's clusters, by extract-min over
// (boxes x rays) score tiles.  Here every ray walks alone, one thread per
// ray, as the flat kernels of trace_flat.cu do, with a second level:
//
//   take the nearest unvisited super whose slab entry is below the running
//   best; inside it take the nearest unvisited cluster whose entry is below
//   the best, dense-test its cluster_size slots, repeat until the super's
//   clusters drain; mark the super visited (it is never re-entered) and
//   pick again.
//
// Super visits live in a 128-bit mask and cluster visits of the current
// super in a 32-bit mask, both in registers.  The super boxes and all
// cluster boxes sit in shared memory (dragon: 43 x 24 B plus 344 x 24 B,
// 9.3 KB; at most 128 x 24 B plus 4096 x 24 B).
//
// What bounds these kernels on an H100: as for the flat kernels, divergent
// per-ray loops and the triangle-plane reads (dragon's planes are 6.3 MB,
// L2-resident in the 50 MB L2), not HBM.  The second level cuts the boxes a
// ray slab-tests from every cluster to the supers plus the clusters of the
// supers it enters.  Options of the TPU kernels that the default config
// leaves off (baked origins, the partial-cluster chunk skip, pair visits,
// visit counts) are not here.
//
// Numerics and the packed key: see trace_common.cuh.

#include "trace_common.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kMaxSupers = 128;
constexpr int kMaxPerSuper = 32;

// Closest hit (replaces _closest_kernel, trace_pallas.py:1139).  Starts
// from the host seed key (the global set's best hit) with base g_base, or
// with the ray's own seed_base (the TPU kernel's host_seed_base: the rank
// walk's best key and its cluster base), as the TPU kernel's host-seed path;
// a cluster's key replaces the best only when strictly smaller.  Writes the
// best key's chopped t and its slot (-1 on a miss).
__global__ void __launch_bounds__(kThreads)
closest_hier_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ seed,
                    const int* __restrict__ seed_base,
                    const float* __restrict__ sup,
                    const float* __restrict__ clu,
                    const float* __restrict__ tri, int n, int n_sup,
                    int s_per, int c_size, int T, int g_base,
                    float* __restrict__ t_out, int* __restrict__ tri_out) {
  extern __shared__ float s_mem[];
  float* s_sup = s_mem;
  float* s_clu = s_mem + n_sup * 6;
  load_shared(sup, n_sup * 6, s_sup);
  load_shared(clu, n_sup * s_per * 6, s_clu);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  int key = seed ? seed[r] : init_key();
  int base = seed_base ? seed_base[r] : g_base;
  if (mask[r]) {
    Ray ray = load_ray(o, d, r);
    unsigned svis[4] = {0u, 0u, 0u, 0u};
    while (true) {
      int s = pick_box(s_sup, n_sup, ray, kBigT, key_to_t(key), svis);
      if (s < 0) break;
      mark(svis, s);
      const float* boxes = s_clu + 6 * s * s_per;
      unsigned cvis[1] = {0u};
      while (true) {
        int k = pick_box(boxes, s_per, ray, kBigT, key_to_t(key), cvis);
        if (k < 0) break;
        mark(cvis, k);
        int cbase = (s * s_per + k) * c_size;
        int vkey = dense_closest(tri, T, cbase, c_size, ray);
        if (vkey < key) {
          key = vkey;
          base = cbase;
        }
      }
    }
  }
  t_out[r] = key_to_t(key);
  tri_out[r] = key < miss_key() ? base + (key & kIdxMask) : -1;
}

// Any hit (replaces _any_kernel, trace_pallas.py:1653).  One thread per ray
// segment (1e-6, max_t]: the global slots first, as the TPU kernel does
// under seed_global=False, then the two-level walk in entry order with the
// max_t slab bound, stopping at the first occluder.
__global__ void __launch_bounds__(kThreads)
any_hier_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ max_t,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ sup, const float* __restrict__ clu,
                const float* __restrict__ tri, int n, int n_sup, int s_per,
                int c_size, int T, int g_base, int g_slots,
                bool* __restrict__ occ_out) {
  extern __shared__ float s_mem[];
  float* s_sup = s_mem;
  float* s_clu = s_mem + n_sup * 6;
  load_shared(sup, n_sup * 6, s_sup);
  load_shared(clu, n_sup * s_per * 6, s_clu);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  bool occ = false;
  if (mask[r]) {
    Ray ray = load_ray(o, d, r);
    float tmax = max_t[r];
    occ = dense_any(tri, T, g_base, g_slots, ray, tmax);
    unsigned svis[4] = {0u, 0u, 0u, 0u};
    while (!occ) {
      int s = pick_box(s_sup, n_sup, ray, tmax, kBigT, svis);
      if (s < 0) break;
      mark(svis, s);
      const float* boxes = s_clu + 6 * s * s_per;
      unsigned cvis[1] = {0u};
      while (!occ) {
        int k = pick_box(boxes, s_per, ray, tmax, kBigT, cvis);
        if (k < 0) break;
        mark(cvis, k);
        occ = dense_any(tri, T, (s * s_per + k) * c_size, c_size, ray, tmax);
      }
    }
  }
  occ_out[r] = occ;
}

size_t shared_bytes(int n_sup, int s_per) {
  return sizeof(float) * 6 * (size_t)n_sup * (1 + s_per);
}

bool bad_layout(int n_sup, int s_per) {
  return n_sup < 1 || n_sup > kMaxSupers || s_per < 1 || s_per > kMaxPerSuper;
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  `sup` holds the n_sup real super boxes
// (n_sup, 6) and `clu` their clusters (n_sup, s_per, 6); `seed` and
// `seed_base` may be null (no seed; base g_base).  Each launches on
// the given stream, allocates nothing, and returns the launch's
// cudaGetLastError().

int launch_closest_hier(const void* o, const void* d, const void* mask,
                        const void* seed, const void* seed_base,
                        const void* sup, const void* clu, const void* tri,
                        int n, int n_sup, int s_per, int c_size, int T,
                        int g_base, void* t_out, void* tri_out,
                        void* stream) {
  if (bad_layout(n_sup, s_per)) return (int)cudaErrorInvalidValue;
  size_t smem = shared_bytes(n_sup, s_per);
  cudaError_t err = allow_shared(closest_hier_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_hier_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const int*)seed, (const int*)seed_base, (const float*)sup,
      (const float*)clu, (const float*)tri, n, n_sup, s_per, c_size, T,
      g_base, (float*)t_out, (int*)tri_out);
  return (int)cudaGetLastError();
}

int launch_any_hier(const void* o, const void* d, const void* max_t,
                    const void* mask, const void* sup, const void* clu,
                    const void* tri, int n, int n_sup, int s_per, int c_size,
                    int T, int g_base, int g_slots, void* occ_out,
                    void* stream) {
  if (bad_layout(n_sup, s_per)) return (int)cudaErrorInvalidValue;
  size_t smem = shared_bytes(n_sup, s_per);
  cudaError_t err = allow_shared(any_hier_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kThreads - 1) / kThreads;
  any_hier_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)max_t,
      (const unsigned char*)mask, (const float*)sup, (const float*)clu,
      (const float*)tri, n, n_sup, s_per, c_size, T, g_base, g_slots,
      (bool*)occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
