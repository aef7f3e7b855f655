// Flat cluster traversal for Hopper (sm_90a): closest hit and any hit.
//
// closest_flat_kernel replaces the TPU kernel _closest_flat_kernel and
// any_flat_kernel replaces _any_flat_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, trace_closest / trace_any on
// scenes with <= 128 padded clusters).  The TPU kernels walk a block of
// 128-512 rays together: one (clusters x rays) slab test per block, then an
// extract-min over clusters whose dense test runs on every ray of the block.
// Here every ray walks alone, one thread per ray: Hopper schedules threads,
// not vector lanes, so a ray needs neither its block's union of clusters
// nor a cross-lane reduction to pick the next one.
//
// What bounds these kernels on an H100: per-ray loops of unequal length
// (warp divergence) and the triangle-plane reads.  The planes of a scene
// that takes the flat path are at most 128 clusters x 384 slots x 12 floats
// (2.4 MB; coatball: 0.7 MB), so they stay in the 50 MB L2 and each dense
// test is L2 bandwidth and FP32 issue, not HBM.  The simple design does
// this about it: the cluster boxes (<= 3 KB) sit in shared memory, each
// thread keeps a 128-bit visited mask in registers and picks its nearest
// unvisited cluster whose slab entry is below its current best, and the
// plane rows are read through the read-only cache (__ldg).  Neighbouring
// camera rays pick the same clusters, so their plane reads coalesce into
// broadcasts.  Warp-cooperative walks, persistent blocks, TMA staging of
// the planes and wgmma are later work.
//
// Numerics and the packed key: see trace_common.cuh.  The closest hit is
// the minimum packed key (bits(t) & ~0x1FF) | in-cluster index, the TPU
// kernels' contract.

#include "trace_common.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kMaxClusters = 128;

// Closest hit (replaces _closest_flat_kernel, trace_pallas.py:1848).  One
// thread per ray: start from the host seed key (the global set's best hit,
// base g_base), then repeatedly dense-test the nearest unvisited cluster
// whose slab entry is below t(best key); t_out is the best key's chopped t,
// tri_out its slot (-1 on a miss).  Bound by divergent walks and L2 reads
// of the planes (see the file comment).
__global__ void __launch_bounds__(kThreads)
closest_flat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ seed,
                    const float* __restrict__ clu,
                    const float* __restrict__ tri, int n, int ncp,
                    int c_size, int T, int g_base, float* __restrict__ t_out,
                    int* __restrict__ tri_out) {
  __shared__ float s_box[kMaxClusters * 6];
  load_shared(clu, ncp * 6, s_box);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  int key = seed ? seed[r] : init_key();
  int base = g_base;
  if (mask[r]) {
    Ray ray = load_ray(o, d, r);
    unsigned visited[4] = {0u, 0u, 0u, 0u};
    while (true) {
      int k = pick_box(s_box, ncp, ray, kBigT, key_to_t(key), visited);
      if (k < 0) break;
      mark(visited, k);
      int cbase = k * c_size;
      int vkey = dense_closest(tri, T, cbase, c_size, ray);
      if (vkey < key) {
        key = vkey;
        base = cbase;
      }
    }
  }
  t_out[r] = key_to_t(key);
  tri_out[r] = key < miss_key() ? base + (key & kIdxMask) : -1;
}

// Any hit (replaces _any_flat_kernel, trace_pallas.py:1957).  One thread
// per ray segment (1e-6, max_t]: the global slots first, as the TPU kernel
// does even after the host fold, then every slab-hit cluster, nearest
// first, stopping at the first occluder.  Bound like the closest kernel;
// the early exit shortens occluded rays' loops only.
__global__ void __launch_bounds__(kThreads)
any_flat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ max_t,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ clu,
                const float* __restrict__ tri, int n, int ncp, int c_size,
                int T, int g_base, int g_slots,
                bool* __restrict__ occ_out) {
  __shared__ float s_box[kMaxClusters * 6];
  load_shared(clu, ncp * 6, s_box);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  bool occ = false;
  if (mask[r]) {
    Ray ray = load_ray(o, d, r);
    float tmax = max_t[r];
    // The global slots first, as the TPU kernel's dense global chunk test.
    occ = dense_any(tri, T, g_base, g_slots, ray, tmax);
    unsigned visited[4] = {0u, 0u, 0u, 0u};
    while (!occ) {
      int k = pick_box(s_box, ncp, ray, tmax, kBigT, visited);
      if (k < 0) break;
      mark(visited, k);
      occ = dense_any(tri, T, k * c_size, c_size, ray, tmax);
    }
  }
  occ_out[r] = occ;
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  Each launches on the given stream,
// allocates nothing, and returns cudaGetLastError() of its launch.

int launch_closest_flat(const void* o, const void* d, const void* mask,
                        const void* seed, const void* clu, const void* tri,
                        int n, int ncp, int c_size, int T, int g_base,
                        void* t_out, void* tri_out, void* stream) {
  if (ncp > kMaxClusters) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_flat_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const int*)seed, (const float*)clu, (const float*)tri, n, ncp, c_size,
      T, g_base, (float*)t_out, (int*)tri_out);
  return (int)cudaGetLastError();
}

int launch_any_flat(const void* o, const void* d, const void* max_t,
                    const void* mask, const void* clu, const void* tri, int n,
                    int ncp, int c_size, int T, int g_base, int g_slots,
                    void* occ_out, void* stream) {
  if (ncp > kMaxClusters) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  any_flat_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)max_t,
      (const unsigned char*)mask, (const float*)clu, (const float*)tri, n,
      ncp, c_size, T, g_base, g_slots, (bool*)occ_out);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
