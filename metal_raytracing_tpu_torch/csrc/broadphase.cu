// Fused per-ray broad phase for Hopper (sm_90a).
//
// broadphase_kernel replaces the TPU kernel _broadphase_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, launched by broadphase_keys).
// Per ray, in one pass:
//
//   - with_clusters: the packed keys (bits(t_entry) & ~0xFFF) | cluster id
//     of the nearest and (want2) second-nearest slab-hit cluster over the
//     flat cluster table (<= 4096 clusters), or the sentinel
//     (bits(1e30) & ~0xFFF) | 0xFFF where there is none;
//   - with a global set: the closest-hit seed key over its slots (the
//     packed (bits(t) & ~0x1FF) | slot key, init key on a miss), or in
//     any_mode the 0/1 occlusion flag within (1e-6, max_t].
//
// In any_mode max_t also bounds the cluster slab test.  A masked-off ray
// writes the sentinel keys and the miss results.  Only the global set's
// real slots are tested: its padding slots are degenerate triangles that
// never hit, which the TPU kernel tests anyway in whole 128-slot chunks.
//
// What bounds it on an H100: with clusters, the per-ray loop of slab tests
// over the shared-memory box table (FP32 throughput; dragon: 344 boxes);
// without them, the ray reads and key writes (bytes: 25-29 B in, 4 B out
// per ray) against a handful of plane tests.  Every ray does the same work, so the
// loops do not diverge; the boxes sit in shared memory and the few global
// plane rows are read through the read-only cache.
//
// Numerics: see trace_common.cuh.

#include "trace_common.cuh"

namespace {

using namespace mrt;

constexpr int kMaxClusters = 4096;
constexpr int kNcIdMask = 0xFFF;

__device__ __forceinline__ int nc_sentinel() {
  return (__float_as_int(kBigT) & ~kNcIdMask) | kNcIdMask;
}

__global__ void broadphase_kernel(const float* __restrict__ o,
                                  const float* __restrict__ d,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ max_t,
                                  const float* __restrict__ clu,
                                  const float* __restrict__ tri, int n,
                                  int ncp, int T, int g_base, int g_slots,
                                  int any_mode, int* __restrict__ key1_out,
                                  int* __restrict__ key2_out,
                                  int* __restrict__ g_out) {
  extern __shared__ float s_box[];
  if (key1_out) load_shared(clu, ncp * 6, s_box);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  bool live = mask[r];
  Ray ray = load_ray(o, d, r);
  float tmax = any_mode ? max_t[r] : kBigT;
  if (key1_out) {
    int k1 = nc_sentinel(), k2 = nc_sentinel();
    for (int c = 0; live && c < ncp; ++c) {
      float tn;
      if (slab(s_box + 6 * c, ray, tmax, &tn)) {
        int key = (__float_as_int(tn) & ~kNcIdMask) | c;
        if (key < k1) {
          k2 = k1;
          k1 = key;
        } else if (key < k2) {
          k2 = key;
        }
      }
    }
    key1_out[r] = k1;
    if (key2_out) key2_out[r] = k2;
  }
  if (g_out) {
    if (any_mode)
      g_out[r] = live && dense_any(tri, T, g_base, g_slots, ray, tmax);
    else
      g_out[r] = live ? dense_closest(tri, T, g_base, g_slots, ray)
                      : init_key();
  }
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes.  Null key1_out skips the cluster keys,
// null key2_out the second-nearest key, null g_out the global set; max_t
// is read only in any_mode.  Launches `threads` threads per block on the
// given stream, allocates nothing, and returns cudaGetLastError().
int launch_broadphase(const void* o, const void* d, const void* mask,
                      const void* max_t, const void* clu, const void* tri,
                      int n, int ncp, int T, int g_base, int g_slots,
                      int any_mode, void* key1_out, void* key2_out,
                      void* g_out, int threads, void* stream) {
  if (ncp > kMaxClusters || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  size_t smem = key1_out ? sizeof(float) * 6 * (size_t)ncp : 0;
  cudaError_t err = allow_shared(broadphase_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + threads - 1) / threads;
  broadphase_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const float*)max_t, (const float*)clu, (const float*)tri, n, ncp, T,
      g_base, g_slots, any_mode, (int*)key1_out, (int*)key2_out,
      (int*)g_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
