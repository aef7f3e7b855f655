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
// What bounds it on an H100: with clusters, instruction issue for the
// sweep of every ray over every box (dragon: 344 boxes, 27 counted
// operations a slab test, most of them min/max and compares); without
// them, the ray reads and key writes (bytes: 25-29 B in, 4 B out per ray)
// against a handful of plane tests.  One ray a thread pays six scalar
// shared loads and a compare-and-branch top-2 update on top of each slab
// test.
//
// What the design does about it:
//
//   * Each thread holds kRays rays (consecutive threads on consecutive
//     rays, for coalesced reads and writes), so each box read from shared
//     memory serves kRays slab tests.  This is what pays: on dragon's
//     primary pass one ray a thread with the rest of this design measured
//     the old kernel's time, two and four rays 15% less, four a little
//     faster in the global modes (PERF.md).
//   * The box table sits in shared memory as a float4 (lo, hi.x) and a
//     float2 (hi.y, hi.z) a box: two loads a box, broadcast to the warp.
//   * The top-2 update has no branch: k2 = min(k2, max(k1, key)),
//     k1 = min(k1, key), with the sentinel for a box the ray misses.  It
//     equals the compare-and-branch form because the keys of one ray are
//     distinct (their id bits differ) and no key exceeds the sentinel that
//     both start from.
//   * The slab test keeps slab()'s floating-point op order, so the keys
//     equal the plain version's bit for bit.  The three reciprocals of a
//     ray are computed only for the cluster sweep; the global test needs
//     none.
//   * A thread whose rays are all masked off skips the sweep; the ragged
//     tail of n (a block past the last ray) masks its rays off.
//
// Numerics: see trace_common.cuh.

#include "trace_common.cuh"

namespace {

using namespace mrt;

constexpr int kMaxClusters = 4096;
constexpr int kNcIdMask = 0xFFF;
constexpr int kRays = 4;  // rays a thread

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
  extern __shared__ float4 s_lo[];  // (lo.x, lo.y, lo.z, hi.x) a box
  float2* s_hi = (float2*)(s_lo + ncp);  // (hi.y, hi.z) a box
  if (key1_out) {
    for (int i = threadIdx.x; i < ncp; i += blockDim.x) {
      const float* b = clu + 6 * i;
      s_lo[i] = make_float4(b[0], b[1], b[2], b[3]);
      s_hi[i] = make_float2(b[4], b[5]);
    }
    __syncthreads();
  }

  const int r0 = blockIdx.x * blockDim.x * kRays + threadIdx.x;
  Ray ray[kRays];
  float tmax[kRays];
  bool live[kRays];
  bool any_live = false;
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    int r = r0 + j * blockDim.x;
    live[j] = r < n && mask[r];
    any_live = any_live || live[j];
    ray[j] = Ray{};
    tmax[j] = kBigT;
    if (r < n) {
      ray[j].ox = o[3 * r + 0];
      ray[j].oy = o[3 * r + 1];
      ray[j].oz = o[3 * r + 2];
      ray[j].dx = d[3 * r + 0];
      ray[j].dy = d[3 * r + 1];
      ray[j].dz = d[3 * r + 2];
      if (any_mode) tmax[j] = max_t[r];
    }
  }

  if (key1_out) {
    int k1[kRays], k2[kRays];
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      k1[j] = k2[j] = nc_sentinel();
      ray[j].ix = safe_inv(ray[j].dx);
      ray[j].iy = safe_inv(ray[j].dy);
      ray[j].iz = safe_inv(ray[j].dz);
    }
    for (int c = 0; any_live && c < ncp; ++c) {
      float4 a = s_lo[c];
      float2 b = s_hi[c];
      const float box[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float tn;
        bool hit = slab(box, ray[j], tmax[j], &tn);
        int key =
            hit ? (__float_as_int(tn) & ~kNcIdMask) | c : nc_sentinel();
        k2[j] = min(k2[j], max(k1[j], key));
        k1[j] = min(k1[j], key);
      }
    }
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      int r = r0 + j * blockDim.x;
      if (r < n) {
        key1_out[r] = live[j] ? k1[j] : nc_sentinel();
        if (key2_out) key2_out[r] = live[j] ? k2[j] : nc_sentinel();
      }
    }
  }

  if (g_out) {
    // the global slots in order, each slot's planes read once for the
    // thread's rays: the minimum packed key, or the OR of the flags
    int g[kRays];
#pragma unroll
    for (int j = 0; j < kRays; ++j) g[j] = any_mode ? 0 : init_key();
    for (int s = 0; any_live && s < g_slots; ++s) {
      float p[12];
      load_planes(tri, T, g_base + s, true, p);
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float t;
        bool hit = plane_hit(p, ray[j].ox, ray[j].oy, ray[j].oz, ray[j].dx,
                             ray[j].dy, ray[j].dz, &t);
        if (any_mode)
          g[j] |= hit && t <= tmax[j];
        else if (hit)
          g[j] = min(g[j], (__float_as_int(t) & ~kIdxMask) | s);
      }
    }
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      int r = r0 + j * blockDim.x;
      if (r < n) g_out[r] = live[j] ? g[j] : (any_mode ? 0 : init_key());
    }
  }
}

// nearest_cluster_kernel: the exact broad phase of the compaction sort keys
// (ops/broadphase_cuda.py: nearest_cluster, nearest_cluster_pair).  It
// replaces no TPU kernel: the reference leaves this (rays x boxes) slab
// chain to XLA, which fuses it into one reduce (trace_pallas.nearest_cluster
// and nearest_cluster_pair); eager PyTorch ran it as some thirty-five
// passes over (rays x boxes) temporaries.  Per ray, in one pass over the
// box table, the kRanks smallest packed keys (bits(max(t_entry, 0)) &
// ~0xFFF) | box id of the slab-hit boxes, ascending, the sentinel where
// there are fewer:
//
//   - kBounded: only boxes entered at or before max_t count;
//   - kPair: a second direction from the same origin, the shadow segment's
//     (d_sh, mask_sh, max_t_sh): its rank-1 key, bounded, beside the kRanks
//     unbounded keys of the first direction (the next bounce's).
//
// What bounds it on an H100: as broadphase_kernel's cluster modes,
// instruction issue for a slab test of every ray against every box (27
// counted operations a test, most of them min/max and compares) and the
// top-k update (two operations a rank).
//
// What the design does about it: the design of broadphase_kernel's cluster
// sweep, whose keys it equals on ranks 1-2 (same slab(), same key, same
// branch-free update, boxes in shared memory, kRays rays a thread).  The
// third rank adds k3 = min(k3, max(k2, key)) before the two updates.  The
// pair calls slab() twice on one origin, so the compiler computes the six
// box - o differences once; it takes kPairRays rays a thread, so a box read
// from shared memory still serves four slab tests.  The unbounded forms
// pass +inf as the bound: tn <= +inf holds for every tn that can hit.
//
// Numerics: slab() keeps the plain chain's op order (trace_common.cuh), so
// for finite rays the keys equal the plain PyTorch chain's bit for bit.
constexpr int kPairRays = 2;  // rays a thread of the pair instances

template <int kRanks, bool kBounded, bool kPair>
__global__ void nearest_cluster_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ mask, const float* __restrict__ max_t,
    const float* __restrict__ d_sh, const unsigned char* __restrict__ mask_sh,
    const float* __restrict__ max_t_sh, const float* __restrict__ boxes,
    int n, int nc, int* __restrict__ k1_out, int* __restrict__ k2_out,
    int* __restrict__ k3_out, int* __restrict__ ks_out) {
  constexpr int kR = kPair ? kPairRays : kRays;
  extern __shared__ float4 s_lo[];  // (lo.x, lo.y, lo.z, hi.x) a box
  float2* s_hi = (float2*)(s_lo + nc);  // (hi.y, hi.z) a box
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const float* b = boxes + 6 * i;
    s_lo[i] = make_float4(b[0], b[1], b[2], b[3]);
    s_hi[i] = make_float2(b[4], b[5]);
  }
  __syncthreads();

  const float unbounded = __int_as_float(0x7f800000);  // +inf
  const int r0 = blockIdx.x * blockDim.x * kR + threadIdx.x;
  Ray ray[kR], sh[kR];
  float tmax[kR], tmax_sh[kR];
  bool live[kR], live_sh[kR];
  bool any_live = false;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    int r = r0 + j * blockDim.x;
    bool in = r < n;
    live[j] = in && mask[r];
    live_sh[j] = kPair && in && mask_sh[r];
    any_live = any_live || live[j] || live_sh[j];
    ray[j] = in ? load_ray(o, d, r) : Ray{};
    tmax[j] = kBounded && in ? max_t[r] : unbounded;
    if (kPair) {
      sh[j] = in ? load_ray(o, d_sh, r) : Ray{};
      tmax_sh[j] = in ? max_t_sh[r] : unbounded;
    }
  }

  int k1[kR], k2[kR], k3[kR], ks[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) k1[j] = k2[j] = k3[j] = ks[j] = nc_sentinel();
  for (int c = 0; any_live && c < nc; ++c) {
    float4 a = s_lo[c];
    float2 b = s_hi[c];
    const float box[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      float tn;
      bool hit = slab(box, ray[j], tmax[j], &tn);
      int key = hit ? (__float_as_int(tn) & ~kNcIdMask) | c : nc_sentinel();
      if (kRanks >= 3) k3[j] = min(k3[j], max(k2[j], key));
      if (kRanks >= 2) k2[j] = min(k2[j], max(k1[j], key));
      k1[j] = min(k1[j], key);
      if (kPair) {
        bool hit_sh = slab(box, sh[j], tmax_sh[j], &tn);
        ks[j] = min(ks[j], hit_sh ? (__float_as_int(tn) & ~kNcIdMask) | c
                                  : nc_sentinel());
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    int r = r0 + j * blockDim.x;
    if (r >= n) continue;
    k1_out[r] = live[j] ? k1[j] : nc_sentinel();
    if (kRanks >= 2) k2_out[r] = live[j] ? k2[j] : nc_sentinel();
    if (kRanks >= 3) k3_out[r] = live[j] ? k3[j] : nc_sentinel();
    if (kPair) ks_out[r] = live_sh[j] ? ks[j] : nc_sentinel();
  }
}

template <int kRanks, bool kBounded, bool kPair>
cudaError_t launch_nearest(const float* o, const float* d,
                           const unsigned char* mask, const float* max_t,
                           const float* d_sh, const unsigned char* mask_sh,
                           const float* max_t_sh, const float* boxes, int n,
                           int nc, int* k1, int* k2, int* k3, int* ks,
                           int threads, cudaStream_t stream) {
  auto kernel = nearest_cluster_kernel<kRanks, kBounded, kPair>;
  size_t smem = (sizeof(float4) + sizeof(float2)) * (size_t)nc;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_block = threads * (kPair ? kPairRays : kRays);
  int blocks = (n + per_block - 1) / per_block;
  kernel<<<blocks, threads, smem, stream>>>(o, d, mask, max_t, d_sh, mask_sh,
                                            max_t_sh, boxes, n, nc, k1, k2,
                                            k3, ks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes.  Null key1_out skips the cluster keys,
// null key2_out the second-nearest key, null g_out the global set; max_t
// is read only in any_mode.  Launches `threads` threads per block, each on
// kRays rays, on the given stream, allocates nothing, and returns
// cudaGetLastError().
int launch_broadphase(const void* o, const void* d, const void* mask,
                      const void* max_t, const void* clu, const void* tri,
                      int n, int ncp, int T, int g_base, int g_slots,
                      int any_mode, void* key1_out, void* key2_out,
                      void* g_out, int threads, void* stream) {
  if (ncp > kMaxClusters || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  size_t smem = key1_out ? (sizeof(float4) + sizeof(float2)) * (size_t)ncp
                         : 0;
  cudaError_t err = allow_shared(broadphase_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int per_block = threads * kRays;
  int blocks = (n + per_block - 1) / per_block;
  broadphase_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const float*)max_t, (const float*)clu, (const float*)tri, n, ncp, T,
      g_base, g_slots, any_mode, (int*)key1_out, (int*)key2_out,
      (int*)g_out);
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes: nearest_cluster_kernel over the (nc, 6)
// box table.  `ranks` (1-3) keys of the rays along d go to key1_out ..
// key3_out (the unused ones null); a non-null max_t bounds them.  A
// non-null d_sh selects the pair: max_t is then null, ranks 2 or 3, and the
// shadow segments' (d_sh, mask_sh, max_t_sh) rank-1 key goes to ksh_out.
// Launches `threads` threads per block on the given stream, allocates
// nothing, and returns cudaGetLastError().
int launch_nearest_cluster(const void* o, const void* d, const void* mask,
                           const void* max_t, const void* d_sh,
                           const void* mask_sh, const void* max_t_sh,
                           const void* boxes, int n, int nc, int ranks,
                           void* key1_out, void* key2_out, void* key3_out,
                           void* ksh_out, int threads, void* stream) {
  if (nc > kMaxClusters || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const bool pair = d_sh != nullptr;
  const bool bounded = max_t != nullptr;
  if (pair && (bounded || !max_t_sh || !mask_sh || !ksh_out))
    return (int)cudaErrorInvalidValue;
  const float* fo = (const float*)o;
  const float* fd = (const float*)d;
  const unsigned char* m = (const unsigned char*)mask;
  const float* mt = (const float*)max_t;
  const float* fds = (const float*)d_sh;
  const unsigned char* ms = (const unsigned char*)mask_sh;
  const float* mts = (const float*)max_t_sh;
  const float* b = (const float*)boxes;
  int* k1 = (int*)key1_out;
  int* k2 = (int*)key2_out;
  int* k3 = (int*)key3_out;
  int* ks = (int*)ksh_out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define MRT_NEAREST(R, B, P)                                                \
  err = launch_nearest<R, B, P>(fo, fd, m, mt, fds, ms, mts, b, n, nc, k1, \
                                k2, k3, ks, threads, s)
  if (pair) {
    if (ranks == 2) MRT_NEAREST(2, false, true);
    if (ranks == 3) MRT_NEAREST(3, false, true);
  } else if (bounded) {
    if (ranks == 1) MRT_NEAREST(1, true, false);
    if (ranks == 2) MRT_NEAREST(2, true, false);
    if (ranks == 3) MRT_NEAREST(3, true, false);
  } else {
    if (ranks == 1) MRT_NEAREST(1, false, false);
    if (ranks == 2) MRT_NEAREST(2, false, false);
    if (ranks == 3) MRT_NEAREST(3, false, false);
  }
#undef MRT_NEAREST
  return (int)err;
}

}  // extern "C"
