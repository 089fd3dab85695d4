// Ragged paged delivery: confirm every packed (candidate user, frame) pair.
//
// For walk row w and lane l:
//   cand = pages[walk_page[w], l],  f = walk_frame[w]
//   ok   = 0 <= cand < U & local[cand]
//          & ( kind[f] == BROADCAST ? OR_k(umask[cand, k] & tmask[f, k]) != 0
//            : kind[f] == DIRECT    ? cand == dest[f] : false )
//   out_user[w, l] = ok ? cand : -1,   counts[w] = popcount over l of ok
//
// Replaces pushcdn_tpu/ops/ragged_delivery.py::ragged_delivery_pallas
// (kernel body _ragged_kernel). Inputs: pages int32[G, 128] (page 0 all
// -1), walk_page/walk_frame int32[Wp], local uint8[U], umask int32[U, W],
// tmask int32[N, W], kind/dest int32[N] (kind already 0 on invalid
// slots). Outputs: out_user int32[Wp, 128], counts int32[Wp]. U is the
// SLICED user count: a candidate at or past it never delivers, even
// when it is a direct frame's own (garbage) dest. A walk row whose page
// or frame index lies outside the tables writes an empty row and a
// count of 0.
//
// What bounds it on an H100. Counted for the inputs the walk really
// has, the bytes are the distinct pages it visits, the table rows of
// its candidates and frames, and 516 bytes written per row; the
// operations, a few compares per candidate plus one per non-zero mask
// word of its frame (1-2 of 8 on the deployment's traffic). The bytes
// bound it, at under 2 us for the deployment's zipf walk. What holds a
// kernel above that is the candidates' user-table reads: two scattered
// reads per candidate (local[cand] and a mask word), each its own cache
// line, behind a chain of dependent loads per row (walk indices -> page
// row -> user tables).
//
// The design keeps the chains short and the scattered reads few:
//   - one warp per walk row; each lane holds 4 candidates, read with one
//     16-byte load of the page row and written with one 16-byte store
//     (4-byte loads where the page table's base is not 16-byte aligned);
//   - counts[w] is a warp reduction (__reduce_add_sync), no block barrier;
//   - persistent blocks (as many as fit on the card) stride over the
//     rows, and each warp keeps three rows in flight: the walk indices of
//     row r+2, the page row and frame data of row r+1, and the user-table
//     reads of row r;
//   - the frame's W mask words ride one per lane (lane i holds word i)
//     and a ballot marks the non-zero ones; only those words are read
//     from the candidates' rows, each broadcast with one shuffle, so a
//     one-topic frame costs one 4-byte read per candidate instead of W,
//     and a candidate that is not local reads no mask word at all. W is
//     a run-time value, which keeps the kernel one small body.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_DIRECT = 4;
constexpr int KIND_BROADCAST = 5;
constexpr int PAGE = 128;
constexpr int WARPS = 8;  // warps per block
constexpr int MAX_DEVICES = 64;

// One walk row's page candidates and frame data, held in registers
// while the pipeline carries it from one stage to the next; lane i < W
// holds the frame's mask word i in `tm`.
struct Row {
  int4 cand;
  int kind;
  int dest;
  int32_t tm;
};

struct Args {
  const int32_t* pages;
  const int32_t* walk_page;
  const int32_t* walk_frame;
  const uint8_t* local;
  const int32_t* umask;
  const int32_t* tmask;
  const int32_t* kind;
  const int32_t* dest;
  int32_t* out_user;
  int32_t* counts;
  int G, Wp, U, N, W;
  bool vec_pages;  // the page table's base is 16-byte aligned
};

__device__ __forceinline__ void load_row(const Args& a, int pg, int f,
                                         int lane, Row& r) {
  r.tm = 0;
  if (pg >= 0 && pg < a.G && f >= 0 && f < a.N) {
    const int32_t* p = a.pages + (size_t)pg * PAGE + 4 * lane;
    if (a.vec_pages) {
      r.cand = __ldg(reinterpret_cast<const int4*>(p));
    } else {
      r.cand = make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
    r.kind = __ldg(a.kind + f);
    r.dest = __ldg(a.dest + f);
    if (lane < a.W) r.tm = __ldg(a.tmask + (size_t)f * a.W + lane);
  } else {  // out-of-range walk indices: an empty row
    r.cand = make_int4(-1, -1, -1, -1);
    r.kind = 0;
    r.dest = -1;
  }
}

__device__ __forceinline__ void confirm(const Args& a, const Row& r, int w,
                                       int lane) {
  const int c[4] = {r.cand.x, r.cand.y, r.cand.z, r.cand.w};
  const bool bcast = r.kind == KIND_BROADCAST;
  const unsigned nz = __ballot_sync(0xffffffffu, r.tm != 0);
  uint8_t loc[4];
  int32_t acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    loc[j] = (c[j] >= 0 && c[j] < a.U) ? __ldg(a.local + c[j]) : (uint8_t)0;
    acc[j] = 0;
  }
  if (bcast) {
    // only the frame's non-zero words (a warp-uniform loop)
    for (unsigned bits = nz; bits; bits &= bits - 1u) {
      const int i = __ffs(bits) - 1;
      const int32_t t = __shfl_sync(0xffffffffu, r.tm, i);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (loc[j]) acc[j] |= __ldg(a.umask + (size_t)c[j] * a.W + i) & t;
    }
  }
  int o[4];
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = loc[j] && (bcast ? acc[j] != 0
                               : r.kind == KIND_DIRECT && c[j] == r.dest);
    o[j] = ok ? c[j] : -1;
    n += ok;
  }
  __stcs(reinterpret_cast<int4*>(a.out_user + (size_t)w * PAGE) + lane,
         make_int4(o[0], o[1], o[2], o[3]));
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) a.counts[w] = n;
}

__global__ void __launch_bounds__(32 * WARPS)
ragged_delivery_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  // all control flow below is uniform across the warp (one row each)
  int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= a.Wp) return;
  Row cur;
  load_row(a, __ldg(a.walk_page + w), __ldg(a.walk_frame + w), lane, cur);
  int wn = w + stride;
  int pgn = 0, fn = 0;
  if (wn < a.Wp) {
    pgn = __ldg(a.walk_page + wn);
    fn = __ldg(a.walk_frame + wn);
  }
  while (true) {
    const bool more = wn < a.Wp;
    Row nxt;
    if (more) load_row(a, pgn, fn, lane, nxt);
    const int w2 = wn + stride;
    int pg2 = 0, f2 = 0;
    if (w2 < a.Wp) {
      pg2 = __ldg(a.walk_page + w2);
      f2 = __ldg(a.walk_frame + w2);
    }
    confirm(a, cur, w, lane);
    if (!more) break;
    cur = nxt;
    w = wn;
    wn = w2;
    pgn = pg2;
    fn = f2;
  }
}

// Blocks per SM that fit, and the SM count, per device (read once).
int g_blocks_per_sm[MAX_DEVICES];
int g_sms[MAX_DEVICES];

cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int& per_sm = g_blocks_per_sm[device];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ragged_delivery_kernel, 32 * WARPS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long rows_blocks = ((long)a.Wp + WARPS - 1) / WARPS;
  const long resident = (long)g_sms[device] * per_sm;
  const int grid = (int)(rows_blocks < resident ? rows_blocks : resident);
  ragged_delivery_kernel<<<grid, 32 * WARPS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t) of device `device`. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a W
// outside 1..8.
extern "C" int ragged_delivery_launch(const void* pages, int G,
                                      const void* walk_page,
                                      const void* walk_frame, int Wp,
                                      const void* local, const void* umask,
                                      int U, const void* tmask,
                                      const void* kind, const void* dest,
                                      int N, int W, void* out_user,
                                      void* counts, int device,
                                      void* stream) {
  if (Wp <= 0) return 0;
  if (W < 1 || W > 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.pages = static_cast<const int32_t*>(pages);
  a.walk_page = static_cast<const int32_t*>(walk_page);
  a.walk_frame = static_cast<const int32_t*>(walk_frame);
  a.local = static_cast<const uint8_t*>(local);
  a.umask = static_cast<const int32_t*>(umask);
  a.tmask = static_cast<const int32_t*>(tmask);
  a.kind = static_cast<const int32_t*>(kind);
  a.dest = static_cast<const int32_t*>(dest);
  a.out_user = static_cast<int32_t*>(out_user);
  a.counts = static_cast<int32_t*>(counts);
  a.G = G;
  a.Wp = Wp;
  a.U = U;
  a.N = N;
  a.W = W;
  a.vec_pages = (reinterpret_cast<uintptr_t>(pages) & 15) == 0;
  return (int)launch(a, device, static_cast<cudaStream_t>(stream));
}
