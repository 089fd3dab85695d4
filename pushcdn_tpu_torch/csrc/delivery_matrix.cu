// Dense delivery matrix: the router's inner loop for every (user, frame).
//
//   deliver[u, n] = local[u] & ( kind[n] == BROADCAST & OR_w(umask[u, w] & tmask[n, w]) != 0
//                              | kind[n] == DIRECT    & dest[n] == u )
//
// Replaces pushcdn_tpu/ops/delivery_kernel.py::delivery_matrix_pallas
// (kernel body _make_kernel). Inputs: umask int32[U, W] (the u32 topic
// words as bit-views), local uint8[U] (0/1), tmask int32[N, W], kind and
// dest int32[N] (kind already 0 on invalid slots). Output: uint8[U, N]
// of 0/1, the storage of a torch bool tensor. W is 1..8.
//
// What bounds it on an H100: the U*N-byte write. Counted for the inputs
// the deployment has (a frame carries 1-2 topics, so 1-2 non-zero mask
// words of 8; a user 3 topics), a cell needs its byte and, for a local
// user, an operation per non-zero word of its frame; at the card's
// 32-bit integer rate (64 a clock per SM) that takes less time than HBM
// takes for the bytes. A kernel that ANDs all W words of every cell
// does not: at W=8 that is about 11 instructions a cell, more time than
// the write of the deployment's 4096 x 2048 matrix.
//
// The design makes the work per cell follow the inputs, and the write
// wide and continuous:
//   - a tile is 512 frames x 64 users. For its 512 frames the block
//     builds a topic -> frame bitset table in shared memory: for each of
//     the 32*W topics, one 32-bit word per 32-frame group marking the
//     broadcast frames that carry it. Each frame sets its own bits, one
//     shared-memory OR (red.shared) per topic it carries, so the build
//     costs what the frames' topics need. Rows are padded to 17 words so
//     a row's lanes read the table free of bank conflicts;
//   - the tile's direct frames whose dest is a real user go into a list
//     in the same pass; per 64-user chunk they are scattered into a
//     per-user hit table, so a direct frame costs one operation per
//     chunk and not one per row. The table is double-buffered: a chunk
//     scatters its directs into one buffer while it clears the previous
//     chunk's out of the other, and a tile without directs skips both;
//   - each user row ORs the bitsets of its own topics (found by walking
//     the set bits of its W words) with its direct hits, and ANDs the
//     result with local[u]: per lane one shared load per topic for 32
//     frames. The hit bits become bytes with one multiply per 4 frames,
//     written with two 16-byte streaming stores (__stcs: the host reads
//     the matrix once), so 16 lanes write a 512-byte run of one row. A
//     tile narrower than 512 frames (N=64, the wide lane) gives a row
//     only the lanes it needs and packs more rows into a warp;
//   - persistent blocks (at most two per SM) walk a contiguous run of
//     tiles, user chunk by user chunk within one frame tile, so a block
//     builds the table once per frame tile. cp.async (16 bytes a
//     copy where the tables are 16-byte aligned, else 4) brings the next
//     frame tile, and the next user chunk's mask words, into shared
//     memory while the current chunk is computed and stored;
//   - any U and any N: frames past N are zero-filled by cp.async (kind 0
//     delivers nothing), users past U are skipped, and a row that does
//     not start on a 16-byte boundary (N % 16 != 0) is written with
//     4-byte stores where aligned and byte stores at its edges.
// What still holds it above the write: every block stages its frame
// tile and user chunk and builds its table before its first store, and
// at the deployment's shape all blocks run at once, so that time is not
// hidden behind other blocks' stores (PERF.md has the measured split).
// Where the bitset walk loses: a user with many topics pays one shared
// load per topic per 32 frames, where an all-words test pays W ANDs per
// frame; past about 32*W topics a user (every topic at W=8 is 256) the
// all-words form is cheaper for that row. The deployment's users have
// 3, so the kernel keeps one path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_DIRECT = 4;
constexpr int KIND_BROADCAST = 5;
constexpr int TILE_N = 512;           // frames per tile
constexpr int GSTRIDE = TILE_N / 32 + 1;  // padded table row (words)
constexpr int TILE_U = 64;            // users per chunk
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
// Blocks per SM at most: fewer, longer-running blocks overlap the next
// chunk's copy with this chunk's stores (more of them only start in
// step and pay their staging at the same time).
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_DEVICES = 64;

template <int W>
struct Smem {
  alignas(16) uint32_t table[32 * W * GSTRIDE];  // topic -> broadcast frames
  alignas(16) int32_t raw_tm[TILE_N * W];        // frame tile masks
  alignas(16) int32_t raw_kind[TILE_N];
  alignas(16) int32_t raw_dest[TILE_N];
  alignas(16) int32_t um[2][TILE_U * W];         // user chunk masks, 2 buffers
  uint32_t dhit[2][TILE_U * GSTRIDE];            // chunk row -> direct frames
  int2 dlist[TILE_N];                            // (dest, frame) of real directs
  uint8_t loc[2][TILE_U];
  int ndirect;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `size` (4 or 16) bytes, of which the first src_bytes come
// from src and the rest are zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `bytes` bytes of 4-byte words from src to dst and zero-fill dst up
// to `cap` bytes: 16 bytes a copy where src is 16-byte aligned (`vec`),
// else 4.
__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           int bytes, int cap, bool vec,
                                           int tid) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int step = vec ? 16 : 4;
  for (int off = tid * step; off < cap; off += THREADS * step) {
    const int n = min(step, max(0, bytes - off));
    if (vec)
      cp_async16(d + off, n ? s + off : s, n);
    else
      cp_async4(d + off, n ? s + off : s, n);
  }
}

// Fire-and-forget OR into shared memory: a shared-space RED (a generic
// atomic on a shared address costs several times as much here).
__device__ __forceinline__ void red_or_shared(uint32_t* p, uint32_t v) {
  asm volatile("red.shared.or.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
}

// Four hit bits -> four 0/1 bytes of a little-endian word.
__device__ __forceinline__ uint32_t expand4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// Write `cnt` (1..16) delivery bytes from `bits` at p.
__device__ __forceinline__ void store_bits(uint8_t* p, uint32_t bits,
                                           int cnt) {
  if (cnt == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(expand4(bits & 15u), expand4((bits >> 4) & 15u),
                      expand4((bits >> 8) & 15u), expand4((bits >> 12) & 15u)));
    return;
  }
  int j = 0;
  for (; j < cnt && (reinterpret_cast<uintptr_t>(p + j) & 3); ++j)
    p[j] = (uint8_t)((bits >> j) & 1u);
  for (; j + 4 <= cnt; j += 4)
    __stcs(reinterpret_cast<unsigned int*>(p + j), expand4((bits >> j) & 15u));
  for (; j < cnt; ++j) p[j] = (uint8_t)((bits >> j) & 1u);
}

// Write `cnt` (1..32) delivery bytes from one hit word at p.
__device__ __forceinline__ void store_word(uint8_t* p, uint32_t hit,
                                           int cnt) {
  if (cnt == 32 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(expand4(hit & 15u), expand4((hit >> 4) & 15u),
                      expand4((hit >> 8) & 15u), expand4((hit >> 12) & 15u)));
    __stcs(reinterpret_cast<uint4*>(p + 16),
           make_uint4(expand4((hit >> 16) & 15u), expand4((hit >> 20) & 15u),
                      expand4((hit >> 24) & 15u), expand4(hit >> 28)));
    return;
  }
  store_bits(p, hit & 0xFFFFu, min(cnt, 16));
  if (cnt > 16) store_bits(p + 16, hit >> 16, cnt - 16);
}

// W mask words from shared memory (16-byte loads where W allows).
template <int W>
__device__ __forceinline__ void load_words(const int32_t* p, uint32_t (&m)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + i);
      m[i] = v.x;
      m[i + 1] = v.y;
      m[i + 2] = v.z;
      m[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) m[i] = (uint32_t)p[i];
  }
}

struct Args {
  const int32_t* umask;
  const uint8_t* local;
  const int32_t* tmask;
  const int32_t* kind;
  const int32_t* dest;
  uint8_t* out;
  int U, N;
  int lanes_per_row;  // power of two, 1..16: 32 frames a lane
  bool vec;           // every input table is 16-byte aligned
};

// Start the copy of frame tile ft (masks, kinds, dests) into raw_*.
template <int W>
__device__ __forceinline__ void prefetch_frames(const Args& a, Smem<W>& s,
                                                int ft, int tid) {
  const int f0 = ft * TILE_N;
  const int width = min(TILE_N, a.N - f0);
  copy_words(s.raw_tm, a.tmask + (size_t)f0 * W, width * W * 4,
             TILE_N * W * 4, a.vec, tid);
  copy_words(s.raw_kind, a.kind + f0, width * 4, TILE_N * 4, a.vec, tid);
  copy_words(s.raw_dest, a.dest + f0, width * 4, TILE_N * 4, a.vec, tid);
}

// Start the copy of user chunk uc's mask words into um[buf].
template <int W>
__device__ __forceinline__ void prefetch_users(const Args& a, Smem<W>& s,
                                               int uc, int buf, int tid) {
  const int u0 = uc * TILE_U;
  copy_words(s.um[buf], a.umask + (size_t)u0 * W,
             min(TILE_U, a.U - u0) * W * 4, TILE_U * W * 4, a.vec, tid);
}

// Turn the frame tile in raw_* into the topic table and the direct list,
// and clear both direct-hit buffers. Waits for every copy in flight;
// ends with a block barrier.
template <int W>
__device__ __forceinline__ void build_table(const Args& a, Smem<W>& s,
                                            int ft, int tid) {
  const int lane = tid & 31;
  cp_async_wait_all();
  {
    uint4* t = reinterpret_cast<uint4*>(s.table);
    for (int i = tid; i < 32 * W * GSTRIDE / 4; i += THREADS)
      t[i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < 2 * TILE_U * GSTRIDE; i += THREADS)
      (&s.dhit[0][0])[i] = 0u;
  }
  if (tid == 0) s.ndirect = 0;
  __syncthreads();
  const int width = min(TILE_N, a.N - ft * TILE_N);
  const int span = (width + 31) & ~31;
  for (int n = tid; n < span; n += THREADS) {  // warp-uniform trip count
    const int k = s.raw_kind[n];
    if (k == KIND_BROADCAST) {
      uint32_t m[W];
      load_words<W>(&s.raw_tm[n * W], m);
      const uint32_t bit = 1u << (n & 31);
      uint32_t* col = s.table + (n >> 5);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        while (m[i]) {
          const int b = __ffs(m[i]) - 1;
          m[i] &= m[i] - 1u;
          red_or_shared(col + (i * 32 + b) * GSTRIDE, bit);
        }
      }
    }
    const int d = s.raw_dest[n];
    const bool direct = k == KIND_DIRECT && d >= 0 && d < a.U;
    const unsigned bal = __ballot_sync(0xffffffffu, direct);
    if (bal) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s.ndirect, __popc(bal));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (direct)
        s.dlist[base + __popc(bal & ((1u << lane) - 1u))] = make_int2(d, n);
    }
  }
  __syncthreads();
}

template <int W>
__global__ void __launch_bounds__(THREADS)
delivery_matrix_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<W>& s = *reinterpret_cast<Smem<W>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // this block's run of tiles: user chunks within one frame tile first
  const int n_uchunks = (a.U + TILE_U - 1) / TILE_U;
  const int total = ((a.N + TILE_N - 1) / TILE_N) * n_uchunks;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * per;
  const int t1 = min(total, t0 + per);
  if (t0 >= t1) return;  // uniform across the block

  // this lane's place: L lanes a row, 32 frames a lane, R rows a pass
  const int L = a.lanes_per_row;
  const int R = 32 / L;
  const int sub = lane / L;
  const int g = lane % L;  // its 32-frame group
  const int fb = g * 32;   // its first frame in the tile

  int ft = t0 / n_uchunks, uc = t0 - ft * n_uchunks;
  int cur_ft = -1, buf = 0;
  int prev_u0 = -1;  // the chunk whose directs sit in dhit[buf ^ 1]
  prefetch_frames<W>(a, s, ft, tid);
  prefetch_users<W>(a, s, uc, buf, tid);
  cp_async_commit();
  uint8_t next_loc = 0;
  if (tid < TILE_U && uc * TILE_U + tid < a.U)
    next_loc = __ldg(a.local + uc * TILE_U + tid);

  for (int t = t0; t < t1; ++t) {
    const int f0 = ft * TILE_N;
    const int u0 = uc * TILE_U;
    if (tid < TILE_U) s.loc[buf][tid] = next_loc;
    if (ft != cur_ft) {
      build_table<W>(a, s, ft, tid);  // waits for the copies; barrier
      cur_ft = ft;
      prev_u0 = -1;
      if ((t1 - 1) / n_uchunks > ft) prefetch_frames<W>(a, s, ft + 1, tid);
    } else {
      cp_async_wait_all();
    }
    // the next chunk's user data, while this chunk is computed and stored
    if (t + 1 < t1) {
      const int nuc = uc + 1 == n_uchunks ? 0 : uc + 1;
      prefetch_users<W>(a, s, nuc, buf ^ 1, tid);
      next_loc = 0;
      if (tid < TILE_U && nuc * TILE_U + tid < a.U)
        next_loc = __ldg(a.local + nuc * TILE_U + tid);
    }
    cp_async_commit();

    const int nd = s.ndirect;
    if (nd) {
      // this chunk's direct hits into dhit[buf]; the previous chunk's out
      // of dhit[buf ^ 1] (its rows are done: barrier at the loop's end)
      for (int j = tid; j < nd; j += THREADS) {
        const int2 e = s.dlist[j];
        const int r = e.x - u0;
        if (r >= 0 && r < TILE_U)
          red_or_shared(&s.dhit[buf][r * GSTRIDE + (e.y >> 5)],
                        1u << (e.y & 31));
        const int rp = e.x - prev_u0;
        if (prev_u0 >= 0 && rp >= 0 && rp < TILE_U)
          s.dhit[buf ^ 1][rp * GSTRIDE + (e.y >> 5)] = 0u;
      }
    }
    __syncthreads();

    const int cnt = min(32, min(TILE_N, a.N - f0) - fb);
    if (cnt > 0) {
      for (int r = warp * R + sub; r < TILE_U; r += WARPS * R) {
        const int u = u0 + r;
        if (u >= a.U) break;
        uint32_t hit = 0;
        if (s.loc[buf][r]) {
          uint32_t m[W];
          load_words<W>(&s.um[buf][r * W], m);
#pragma unroll
          for (int i = 0; i < W; ++i) {
            while (m[i]) {
              const int b = __ffs(m[i]) - 1;
              m[i] &= m[i] - 1u;
              hit |= s.table[(i * 32 + b) * GSTRIDE + g];
            }
          }
          if (nd) hit |= s.dhit[buf][r * GSTRIDE + g];
        }
        store_word(a.out + (size_t)u * a.N + f0 + fb, hit, cnt);
      }
    }
    prev_u0 = u0;
    buf ^= 1;
    if (++uc == n_uchunks) {
      uc = 0;
      ++ft;
    }
    __syncthreads();  // the chunk's buffers are free for the next one
  }
}

// Blocks per SM that fit, and the SM count, per device (read once).
int g_blocks_per_sm[MAX_DEVICES][9];
int g_sms[MAX_DEVICES];

template <int W>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const int smem = (int)sizeof(Smem<W>);
  cudaError_t err;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int& per_sm = g_blocks_per_sm[device][W];
  if (per_sm == 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(delivery_matrix_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, delivery_matrix_kernel<W>, THREADS, smem);
    if (err != cudaSuccess) return err;
    per_sm = per_sm < 1 ? 1 : per_sm > BLOCKS_PER_SM ? BLOCKS_PER_SM : per_sm;
  }
  const long long tiles = (long long)((a.N + TILE_N - 1) / TILE_N) *
                          ((a.U + TILE_U - 1) / TILE_U);
  const long long resident = (long long)g_sms[device] * per_sm;
  const int grid = (int)(tiles < resident ? tiles : resident);
  delivery_matrix_kernel<W><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t) of device `device`. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a W
// outside 1..8 or more tiles than a 32-bit index holds.
extern "C" int delivery_matrix_launch(const void* umask, const void* local,
                                      const void* tmask, const void* kind,
                                      const void* dest, void* out, int U,
                                      int N, int W, int device,
                                      void* stream) {
  if (U <= 0 || N <= 0) return 0;
  if ((long long)((N + TILE_N - 1) / TILE_N) * ((U + TILE_U - 1) / TILE_U) >
      0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.umask = static_cast<const int32_t*>(umask);
  a.local = static_cast<const uint8_t*>(local);
  a.tmask = static_cast<const int32_t*>(tmask);
  a.kind = static_cast<const int32_t*>(kind);
  a.dest = static_cast<const int32_t*>(dest);
  a.out = static_cast<uint8_t*>(out);
  a.U = U;
  a.N = N;
  // lanes a row needs at 32 frames a lane, rounded up to a power of two
  const int need = ((N < TILE_N ? N : TILE_N) + 31) / 32;
  int L = 1;
  while (L < need) L <<= 1;
  a.lanes_per_row = L;
  a.vec = ((reinterpret_cast<uintptr_t>(umask) |
            reinterpret_cast<uintptr_t>(tmask) |
            reinterpret_cast<uintptr_t>(kind) |
            reinterpret_cast<uintptr_t>(dest)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return (int)launch<1>(a, device, s);
    case 2: return (int)launch<2>(a, device, s);
    case 3: return (int)launch<3>(a, device, s);
    case 4: return (int)launch<4>(a, device, s);
    case 5: return (int)launch<5>(a, device, s);
    case 6: return (int)launch<6>(a, device, s);
    case 7: return (int)launch<7>(a, device, s);
    case 8: return (int)launch<8>(a, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
