// Rank-directed closest walk for Hopper (sm_90a).
//
// closest_rank_kernel replaces the TPU kernel _rank_closest_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, launched by
// trace_closest_rank).  Each ray arrives with its K nearest candidate
// clusters as packed (bits(t_entry) & ~0xFFF) | cluster id keys from the
// exact broad phase, rank 1 first, and with the host seed key (the global
// set's best hit).  The kernel tests only those clusters: no super level,
// no slab test.  Its caller certifies each ray against the rank-(K+1) entry
// and sends the rest to closest_hier_kernel, seeded with this kernel's key
// and base.
//
// The TPU kernel works on a tile of 128 rays: it takes the minimum pending
// key of the whole tile, dense-tests that cluster against every lane, and
// retires it, so a lane also sees clusters that only its neighbours asked
// for.  Here one thread owns one ray and walks only its own K candidates in
// rank order (they come sorted by entry), skipping one whose chopped entry
// is not below the chopped best so far.  On a ray that the certificate
// accepts both give the minimum packed key over every cluster that could
// hold it; on other rays the TPU lane's key can be smaller, and the fallback
// settles those.
//
// What bounds it on an H100: the plane reads of up to K x cluster_size
// slots a ray (L2-resident tables, as for the other walks) and FP32
// throughput of the 39-operation plane test; neighbouring threads hold
// neighbouring rays of the compaction sort, which leads with the rank-1 and
// rank-2 cluster ids, so a warp mostly reads the same slots in step.
//
// Numerics and the packed key: see trace_common.cuh.

#include "trace_common.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kNcIdMask = 0xFFF;  // cluster-id bits of a broad-phase key

__device__ __forceinline__ int nc_sentinel() {
  return (__float_as_int(kBigT) & ~kNcIdMask) | kNcIdMask;
}

// keys: (ranks, n) packed candidate keys, rank 1 first.  seed may be null:
// then a ray starts from the init key with base 0, as the TPU kernel; with
// a seed its base is g_base.  A masked-off ray writes its start values.
__global__ void __launch_bounds__(kThreads)
closest_rank_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ seed,
                    const int* __restrict__ keys,
                    const float* __restrict__ tri, int n, int ranks,
                    int c_size, int T, int g_base,
                    int* __restrict__ key_out, int* __restrict__ base_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  int key = seed ? seed[r] : init_key();
  int base = seed ? g_base : 0;
  if (mask[r]) {
    Ray ray = load_ray(o, d, r);
    for (int k = 0; k < ranks; ++k) {
      int pk = keys[(size_t)k * n + r];
      if (pk == nc_sentinel()) continue;
      // a hit inside the box has t >= entry >= chopped entry, so it cannot
      // give a key below a best whose chopped t is not above that entry
      if (!(__int_as_float(pk & ~kNcIdMask) < key_to_t(key))) continue;
      int cbase = (pk & kNcIdMask) * c_size;
      int vkey = dense_closest(tri, T, cbase, c_size, ray);
      if (vkey < key) {
        key = vkey;
        base = cbase;
      }
    }
  }
  key_out[r] = key;
  base_out[r] = base;
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes.  `keys` is (ranks, n) int32, `seed` (n,)
// int32 or null.  Launches on the given stream, allocates nothing, and
// returns the launch's cudaGetLastError().  Cluster ids are not checked
// against T here: the wrapper checks the tables.
int launch_closest_rank(const void* o, const void* d, const void* mask,
                        const void* seed, const void* keys, const void* tri,
                        int n, int ranks, int c_size, int T, int g_base,
                        void* key_out, void* base_out, void* stream) {
  if (ranks < 1 || c_size < 1) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_rank_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const int*)seed, (const int*)keys, (const float*)tri, n, ranks,
      c_size, T, g_base, (int*)key_out, (int*)base_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
