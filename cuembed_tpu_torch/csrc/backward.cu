// Sorted-COO embedding backward for Hopper (sm_90a), with a plain C interface.
//
// K3 replaces the Pallas kernel
// cuembed_tpu/ops/pallas_backward.py::_make_bwd_kernel:
//     grad[t_idx[p]] += coeff[p] * grad_y[t_sid[p]]    for p < live
// over a COO sorted by index, so that each index's positions form one run.
//
// Full mode writes a [num_rows, W] gradient: each run is summed in fp32, in
// position order, and its row becomes old + sum, rounded once to grad_y's
// type (the Pallas flush). Runs whose index is out of [0, num_rows) (the
// int32-max sentinel of padding) are dropped, and so are positions >= live.
// When the wrapper zeroed the output itself (`zeroed`), the old row is not
// read: the row is stored as __fadd_rn(0, sum), the bits of adding to +0.
// Compressed mode writes run r's sum to rows[r] and its index to uniq[r],
// for every run of the live prefix, out-of-range ones included (the
// contract of lookup_xla._compressed_scatter); run_count_kernel and
// run_scan_kernel give each tile the rank of its first run, and the total.
//
// What bounds it on this card. Every position gathers one grad_y row: at the
// flagship batch 4,194,304 rows of 1 KiB (fp32) out of a 67 MB array, more
// than the 50 MB L2 holds, so the gather streams from L2 and HBM. Every
// distinct output row is read and written once (571,818 rows, 1.17 GB in
// fp32). The first design (one thread row walking 256 positions, four row
// loads in flight behind a dependent t_sid load, a blocking read of each
// run's old row) waited on latency. Measured on an H100 (PERF.md, PR 3), what
// bounds this design is the rate at which an SM's copies of scattered 0.5-1
// KiB rows complete, about 3.7 TB/s in all whether the rows come by bulk
// copy or cp.async, and higher when the rows gathered at a time fit in L2.
//
// The design keeps the bytes in flight in shared memory, not in registers:
//  1. A block is one warp. It owns a tile of kTile sorted positions and one
//     kSliceBytes column slice of the rows (grid.y; all tiles of slice 0 run
//     before slice 1, so the grad_y columns gathered at a time, 33.5 MB at
//     the flagship in fp32, fit in L2). It stages the tile's t_idx, t_sid
//     and coeff in shared memory with coalesced loads, marks each position's
//     run end, owner and old-row need in one pass, and cuts the tile into
//     ring stages (a warp scan per stage): no dependent index load is left
//     on the path of a row copy, and the summing loop reads a flag byte and
//     a slot byte per position.
//  2. The grad_y rows are copied asynchronously into a ring of kStages
//     stages of kSlots row slots. Where the row slice is a multiple of 16
//     bytes at 16-byte-aligned addresses, each lane issues one bulk copy
//     (cp.async.bulk, the TMA unit's non-tensor copy) for its position's
//     row, completing on the stage's mbarrier; below that each lane copies
//     its column vectors with cp.async of 8 or 4 bytes, and 2-byte rows use
//     plain loads. The route is chosen by alignment (vec_bytes), as the
//     forward's load width is.
//  3. In full mode the old output row of every run that a stage ends, and
//     that this block writes, takes a slot of the same stage, by the same
//     copy: the read-modify-write finds its old row in shared memory. A
//     stage holds as many positions as their rows fit in its slots, so old
//     rows take room only where runs end.
//  4. Lane l sums the column vectors l, l + 32, ... of the slice in fp32, in
//     position order, from shared memory, and writes each finished row once.
//     Runs that cross a tile edge leave fp32 pieces: the tile where the run
//     starts keeps its piece in `tail`, each later tile its piece in `head`;
//     coo_backward_fixup_kernel adds, for each such run, the pieces in tile
//     order and writes the row once. No atomics: every output row has one
//     writer, and two launches give the same bits.
// Per block the work is a chain of stages (wait, sum, refill), so the time
// falls with blocks per SM rather than with ring depth: two stages of eight
// 512-byte slots and a 256-position tile keep a block at 12 KB of shared
// memory and 17 blocks on an SM.
//
// ptxas (-Xptxas -v, chip_smoke.py's [build] lines, an NVIDIA H100 build):
// the flagship instantiations (fp32 and bf16 grad_y, int64 indices, the
// bulk route) use 44-48 registers and spill nothing; no instantiation of K3
// spills. Shared memory is dynamic (bwd_smem): 12,306 bytes a block
// unweighted, 13,330 weighted, with 17 and 16 blocks resident per SM.

#include "common.cuh"

#include <cassert>
#include <cstdint>

namespace cuembed {

constexpr int kTile = 256;       // sorted positions per block
constexpr int kStages = 2;       // stages in the ring
constexpr int kSlots = 8;        // row slots per stage
static_assert(kSlots < 15, "a slot index and 'none' (15) share a nibble");
constexpr int kSliceBytes = 512;  // row bytes per block; wider rows take grid.y
static_assert(kSliceBytes % (32 * 16) == 0, "a warp's lanes split a slice evenly");
constexpr int kFixupCols = 256;  // columns per pass of a fix-up warp, 8 a lane
constexpr int kFixupFloats = 64;  // head floats in flight per lane of the fix-up

struct BwdArgs {
  const void* grad_y;       // [gy_rows, width] of T
  const void* t_idx;        // [>= live] of IdxT, sorted
  const int32_t* t_sid;     // [>= live]
  const float* coeff;       // [>= live] or null
  void* out;                // full: [num_rows, width]; compressed: [>= runs, width]
  void* uniq;               // compressed: [>= runs] of IdxT
  float* head;              // [num_tiles, width] partials of runs from earlier tiles
  float* tail;              // [num_tiles, width] partials of runs that go on
  int64_t* ranks;           // compressed: [num_tiles] runs before each tile
  int64_t* tail_rank;       // compressed: [num_tiles] rank of the tile's tail run
  int64_t* num_unique;      // compressed: [1]
  int64_t num_rows, gy_rows, live, width, num_tiles;
  int64_t slice_vecs;       // vectors of a row per column slice
  int compressed;
  int zeroed;               // full mode: the output is all +0, skip the old rows
  cudaStream_t stream;
};

template <typename IdxT>
__device__ __forceinline__ IdxT index_at(const BwdArgs& a, int64_t p) {
  return __ldg(static_cast<const IdxT*>(a.t_idx) + p);
}

// Tile c covers positions [*cs, *ce) of the live prefix. left: its first
// run began in an earlier tile; right: its last run goes on into the next.
template <typename IdxT>
__device__ __forceinline__ void tile_edges(const BwdArgs& a, int64_t c, int64_t* cs,
                                           int64_t* ce, bool* left, bool* right) {
  *cs = c * kTile;
  *ce = imin(*cs + kTile, a.live);
  *left = *cs > 0 && index_at<IdxT>(a, *cs - 1) == index_at<IdxT>(a, *cs);
  *right = *ce < a.live && index_at<IdxT>(a, *ce) == index_at<IdxT>(a, *ce - 1);
}

// Compressed mode, pass 1: the number of runs that start in each tile.
template <typename IdxT>
__global__ void __launch_bounds__(kThreads) run_count_kernel(BwdArgs a) {
  const int64_t c = blockIdx.x;
  const int64_t cs = c * kTile, ce = imin(cs + kTile, a.live);
  int count = 0;
  for (int64_t p0 = cs; p0 < ce; p0 += blockDim.x) {
    const int64_t p = p0 + threadIdx.x;
    const bool start =
        p < ce && (p == 0 || index_at<IdxT>(a, p) != index_at<IdxT>(a, p - 1));
    count += __syncthreads_count(start);
  }
  if (threadIdx.x == 0) a.ranks[c] = count;
}

// Compressed mode, pass 2 (one block): the counts become the exclusive
// prefix sum in place, the number of runs before each tile; the total is
// num_unique.
__global__ void __launch_bounds__(1024) run_scan_kernel(BwdArgs a) {
  __shared__ int64_t s[1024];
  const int t = threadIdx.x;
  const int64_t per = (a.num_tiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = imin(t * per, a.num_tiles), hi = imin(lo + per, a.num_tiles);
  int64_t mine = 0;
  for (int64_t i = lo; i < hi; ++i) mine += a.ranks[i];
  s[t] = mine;
  __syncthreads();
  for (int off = 1; off < static_cast<int>(blockDim.x); off <<= 1) {
    const int64_t v = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += v;
    __syncthreads();
  }
  int64_t run = s[t] - mine;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t c = a.ranks[i];
    a.ranks[i] = run;
    run += c;
  }
  if (t == static_cast<int>(blockDim.x) - 1) *a.num_unique = s[t];
}

// N consecutive floats of a head or tail piece (N * 4 bytes aligned), in
// 16- or 8-byte accesses.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      v[i] = x.x, v[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <typename IdxT>
__device__ __forceinline__ bool in_range(const BwdArgs& a, IdxT row) {
  return row >= 0 && static_cast<int64_t>(row) < a.num_rows;
}

// --- Asynchronous copies into shared memory --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned),
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async copies 4 or 8 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How a route moves row slices: one bulk copy per row (16-byte vectors),
// cp.async per column vector (8 or 4 bytes), or plain loads (2 bytes).
template <int BYTES>
struct Route {
  static constexpr bool kBulk = BYTES == 16;
  static constexpr bool kCpAsync = BYTES == 8 || BYTES == 4;
};

// Shared memory of the main kernel, in this order: the ring of row slots,
// the stage barriers, then the tile's t_idx, t_sid, coeff, per-position
// flags and slots, and the first position of each stage.
struct BwdSmem {
  int64_t slot;  // bytes per row slot, a multiple of 16
  int64_t bars, idx, sid, coeff, meta, slots, first, total;
};

template <typename IdxT, bool HAS_W, int BYTES>
__host__ __device__ __forceinline__ BwdSmem bwd_smem(int64_t slice_vecs) {
  BwdSmem s;
  s.slot = (slice_vecs * BYTES + 15) / 16 * 16;
  s.bars = kStages * kSlots * s.slot;
  s.idx = s.bars + kStages * static_cast<int64_t>(sizeof(uint64_t));
  s.sid = s.idx + kTile * static_cast<int64_t>(sizeof(IdxT));
  s.coeff = s.sid + kTile * static_cast<int64_t>(sizeof(int32_t));
  s.meta = s.coeff + (HAS_W ? kTile * static_cast<int64_t>(sizeof(float)) : 0);
  s.slots = s.meta + kTile;
  s.first = s.slots + kTile;
  s.total = s.first + (kTile + 1) * static_cast<int64_t>(sizeof(uint16_t));
  return s;
}

// Flags of a staged position.
enum : uint8_t {
  kGathers = 1,   // its grad_y row is summed (full mode drops out-of-range runs)
  kEnds = 2,      // its run ends here
  kOwned = 4,     // ...and this block writes that run (not a tile-edge piece)
  kNeedsOld = 8,  // ...into an old output row, which the ring brings in
  kHead = 16,     // ...or its run is the piece of a run from the previous tile
};

// Pass 3. Block: one warp; lane l sums the column vectors l, l + 32, ...
// of the slice. Grid: (tile, column slice).
template <typename T, typename IdxT, bool HAS_W, int BYTES>
__global__ void __launch_bounds__(32) coo_backward_kernel(BwdArgs a) {
  using V = Vec<T, BYTES>;
  using R = Route<BYTES>;
  using Raw = typename V::Raw;
  constexpr int N = V::N;
  constexpr int kVpt = kSliceBytes / (32 * BYTES);  // column vectors per lane
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem L = bwd_smem<IdxT, HAS_W, BYTES>(a.slice_vecs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  IdxT* s_idx = reinterpret_cast<IdxT*>(smem + L.idx);
  int32_t* s_sid = reinterpret_cast<int32_t*>(smem + L.sid);
  float* s_coeff = reinterpret_cast<float*>(smem + L.coeff);
  uint8_t* s_meta = smem + L.meta;
  uint8_t* s_slots = smem + L.slots;
  uint16_t* s_first = reinterpret_cast<uint16_t*>(smem + L.first);

  const int64_t c = blockIdx.x;
  const int64_t cs = c * kTile;
  const int n = static_cast<int>(imin(kTile, a.live - cs));
  const int64_t nvec = a.width / N;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * a.slice_vecs;
  const int my_vecs = static_cast<int>(imin(a.slice_vecs, nvec - col0));
  const int lane = threadIdx.x;
  const bool full = !a.compressed;
  const bool read_old = full && !a.zeroed;
  const T* gy = static_cast<const T*>(a.grad_y);
  T* out = static_cast<T*>(a.out);

  // 1. Stage the tile's COO, and mark each position's run.
  for (int i = lane; i < n; i += 32) {
    s_idx[i] = index_at<IdxT>(a, cs + i);
    s_sid[i] = __ldg(a.t_sid + cs + i);
    if (HAS_W) s_coeff[i] = __ldg(a.coeff + cs + i);
  }
  bool left = false, right = false;
  if (lane == 0) {
    int64_t ts, te;
    tile_edges<IdxT>(a, c, &ts, &te, &left, &right);
    if (R::kBulk) {
      for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  left = __shfl_sync(kAll, left, 0);
  right = __shfl_sync(kAll, right, 0);
  __syncwarp();
  const IdxT first_row = s_idx[0], last_row = s_idx[n - 1];
  for (int i = lane; i < n; i += 32) {
    const IdxT row = s_idx[i];
    const bool head = left && row == first_row;
    const bool tail = !head && right && row == last_row;
    const bool ends = i == n - 1 || s_idx[i + 1] != row;
    const bool gathers = !full || in_range(a, row);
    const bool owned = ends && !head && !tail;
    s_meta[i] = (gathers ? kGathers : 0) | (ends ? kEnds : 0) | (owned ? kOwned : 0) |
                (owned && read_old && in_range(a, row) ? kNeedsOld : 0) |
                (ends && head ? kHead : 0);
  }
  __syncwarp();
  // 2. Cut the tile into ring stages: from each stage's first position, as
  // many positions (up to 32) as their grad_y and old rows fit in kSlots
  // slots; each position's slots go to s_slots (grad_y low nibble, old row
  // high nibble; 15 for none).
  int num_stages = 0;
  for (int first = 0; first < n; ++num_stages) {
    const int j = first + lane;
    const uint8_t m = j < n ? s_meta[j] : 0;
    const int g = (m & kGathers) ? 1 : 0, o = (m & kNeedsOld) ? 1 : 0;
    int pre = g + o;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAll, pre, d);
      if (lane >= d) pre += v;
    }
    const int count = __popc(__ballot_sync(kAll, j < n && pre <= kSlots));
    if (lane < count) {
      s_slots[j] = static_cast<uint8_t>((g ? pre - g - o : 15) | ((o ? pre - 1 : 15) << 4));
    }
    if (lane == 0) s_first[num_stages] = static_cast<uint16_t>(first);
    first += count;
  }
  if (lane == 0) s_first[num_stages] = static_cast<uint16_t>(n);
  __syncwarp();

  const auto slot_of = [&](int stage, int slot) {
    return smem + (static_cast<int64_t>(stage % kStages) * kSlots + slot) * L.slot;
  };

  // 3. Fill ring stage k with the grad_y rows of its positions and the old
  // rows of the runs it ends: on the bulk route one bulk copy per row, each
  // from its own lane; otherwise each lane copies its column vectors.
  const auto lsu_copy = [&](unsigned char* slot, const T* src, bool rw) {
    T* dst = reinterpret_cast<T*>(slot);
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int cv = lane + 32 * v;
      if (cv < my_vecs) {
        if constexpr (R::kCpAsync) {
          cp_async<BYTES>(dst + cv * N, src + cv * N);
        } else {
          *reinterpret_cast<Raw*>(dst + cv * N) = rw ? V::load_rw(src + cv * N)
                                                     : V::load(src + cv * N);
        }
      }
    }
  };
  const auto issue = [&](int k) {
    if (k >= num_stages) {
      if (R::kCpAsync) cp_async_commit();  // keeps one group per stage
      return;
    }
    const int first = s_first[k], count = s_first[k + 1] - first;
    if constexpr (R::kBulk) {
      const int j = first + lane;
      const uint32_t slice = static_cast<uint32_t>(my_vecs) * BYTES;
      const int sl = lane < count ? s_slots[j] : 0xff;
      const bool g = slice > 0 && (sl & 15) != 15;
      const bool o = slice > 0 && (sl >> 4) != 15;
      const uint32_t total = __reduce_add_sync(kAll, (g ? slice : 0u) + (o ? slice : 0u));
      if (lane == 0) mbar_arrive_expect_tx(&bars[k % kStages], total);
      __syncwarp();
      if (g) {
        const int64_t s = s_sid[j];
        assert(s >= 0 && s < a.gy_rows);
        bulk_copy(slot_of(k, sl & 15), gy + s * a.width + col0 * N, slice, &bars[k % kStages]);
      }
      if (o) {
        bulk_copy(slot_of(k, sl >> 4), out + static_cast<int64_t>(s_idx[j]) * a.width + col0 * N,
                  slice, &bars[k % kStages]);
      }
    } else {
      for (int j = first; j < first + count; ++j) {
        const int sl = s_slots[j];
        if ((sl & 15) != 15) {
          const int64_t s = s_sid[j];
          assert(s >= 0 && s < a.gy_rows);
          lsu_copy(slot_of(k, sl & 15), gy + s * a.width + col0 * N, false);
        }
        if ((sl >> 4) != 15) {
          lsu_copy(slot_of(k, sl >> 4),
                   out + static_cast<int64_t>(s_idx[j]) * a.width + col0 * N, true);
        }
      }
      if (R::kCpAsync) cp_async_commit();
    }
  };

  for (int k = 0; k < kStages; ++k) issue(k);

  // 4. Sum the runs in position order.
  float acc[kVpt][N];
#pragma unroll
  for (int v = 0; v < kVpt; ++v) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[v][i] = 0.f;
  }
  int64_t rank = a.compressed ? a.ranks[c] - (left ? 1 : 0) : 0;

  for (int k = 0; k < num_stages; ++k) {
    if constexpr (R::kBulk) mbar_wait(&bars[k % kStages], (k / kStages) & 1);
    if constexpr (R::kCpAsync) cp_async_wait<kStages - 1>();
    const int last = s_first[k + 1];
#pragma unroll 2
    for (int j = s_first[k]; j < last; ++j) {
      const int m = s_meta[j], sl = s_slots[j];
      if (m & kGathers) {
        const unsigned char* row = slot_of(k, sl & 15);
        const float w = HAS_W ? s_coeff[j] : 1.f;
#pragma unroll
        for (int v = 0; v < kVpt; ++v) {
          const int cv = lane + 32 * v;
          if (cv < my_vecs) {
            float x[N];
            V::unpack(*reinterpret_cast<const Raw*>(row + cv * BYTES), x);
#pragma unroll
            for (int i = 0; i < N; ++i) {
              acc[v][i] = __fadd_rn(acc[v][i], HAS_W ? __fmul_rn(x[i], w) : x[i]);
            }
          }
        }
      }
      if (m & kEnds) {
        const IdxT id = s_idx[j];
#pragma unroll
        for (int v = 0; v < kVpt; ++v) {
          const int cv = lane + 32 * v;
          const int64_t col = (col0 + cv) * N;
          if (cv < my_vecs) {
            if (!(m & kOwned)) {
              store_floats<N>(((m & kHead) ? a.head : a.tail) + c * a.width + col, acc[v]);
            } else if (a.compressed) {
              V::store(out + rank * a.width + col, acc[v]);
            } else if (in_range(a, id)) {
              // The old row came with the stage; a zeroed output adds +0.
              float o[N];
              if (m & kNeedsOld) {
                V::unpack(*reinterpret_cast<const Raw*>(slot_of(k, sl >> 4) + cv * BYTES), o);
              } else {
#pragma unroll
                for (int i = 0; i < N; ++i) o[i] = 0.f;
              }
#pragma unroll
              for (int i = 0; i < N; ++i) o[i] = __fadd_rn(o[i], acc[v][i]);
              V::store(out + static_cast<int64_t>(id) * a.width + col, o);
            }
          }
#pragma unroll
          for (int i = 0; i < N; ++i) acc[v][i] = 0.f;
        }
        if (a.compressed && blockIdx.y == 0 && lane == 0 && !(m & kHead)) {
          if (!(m & kOwned)) a.tail_rank[c] = rank;
          static_cast<IdxT*>(a.uniq)[rank] = id;
        }
        ++rank;
      }
    }
    __syncwarp();  // every lane is done with stage k's slots
    issue(k + kStages);
  }
  if (R::kCpAsync) cp_async_wait<0>();
}

// Write a finished run's fp32 sum: full mode adds it to the row's old value
// (dropping out-of-range rows), compressed mode stores it at its rank.
template <typename T, typename IdxT, int BYTES>
__device__ __forceinline__ void write_run(const BwdArgs& a, IdxT row, int64_t rank,
                                          int64_t col, const float (&acc)[Vec<T, BYTES>::N]) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  if (a.compressed) {
    V::store(static_cast<T*>(a.out) + rank * a.width + col * N, acc);
    if (col == 0) static_cast<IdxT*>(a.uniq)[rank] = row;
    return;
  }
  if (!in_range(a, row)) return;
  T* dst = static_cast<T*>(a.out) + static_cast<int64_t>(row) * a.width + col * N;
  float old[N] = {};
  if (!a.zeroed) V::unpack(V::load_rw(dst), old);
#pragma unroll
  for (int i = 0; i < N; ++i) old[i] = __fadd_rn(old[i], acc[i]);
  V::store(dst, old);
}

// Pass 4. For each run that crosses a tile edge, the tile where it starts
// adds its own piece and then each later tile's head piece, in tile order,
// and writes the row once. One warp per tile: the lanes find the run's last
// tile together, then lane l sums the column vectors l, l + 32, ... of each
// kFixupCols columns with the head pieces of several tiles in flight
// (kFixupFloats floats a lane).
template <typename T, typename IdxT, int BYTES>
__global__ void __launch_bounds__(kThreads) coo_backward_fixup_kernel(BwdArgs a) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  constexpr int kVpt = kFixupCols / (32 * N);
  constexpr int kAhead = kFixupFloats / (kFixupCols / 32);  // tiles in flight
  static_assert(kVpt >= 1 && kAhead >= 1, "a lane holds whole vectors of each tile");
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= a.num_tiles) return;
  int64_t cs, ce;
  bool left, right;
  tile_edges<IdxT>(a, c, &cs, &ce, &left, &right);
  const IdxT row = index_at<IdxT>(a, ce - 1);
  // Only the tile where a crossing run starts owns it.
  if (!right || (left && index_at<IdxT>(a, cs) == row)) return;
  if (!a.compressed && !in_range(a, row)) return;
  // Tiles c + 1 .. last hold head pieces: the run goes on past tile k only
  // if it also ends tile k and the next tile begins with it.
  int64_t last = c + 1;
  for (int64_t base = c + 1;; base += 32) {
    const int64_t k = base + lane;
    const int64_t ke = imin((k + 1) * kTile, a.live);
    const bool on = k < a.num_tiles && ke < a.live && index_at<IdxT>(a, ke) == row;
    const unsigned stop = __ballot_sync(kAll, !on);
    if (stop) {
      last = base + __ffs(stop) - 1;
      break;
    }
  }
  const int64_t rank = a.compressed ? a.tail_rank[c] : 0;
  const int64_t nvec = a.width / N;
  for (int64_t col0 = 0; col0 < nvec; col0 += 32 * kVpt) {
    float acc[kVpt][N] = {};
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int64_t col = col0 + lane + 32 * v;
      if (col < nvec) load_floats<N>(a.tail + c * a.width + col * N, acc[v]);
    }
    for (int64_t k0 = c + 1; k0 <= last; k0 += kAhead) {
      float h[kAhead][kVpt][N];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
#pragma unroll
        for (int v = 0; v < kVpt; ++v) {
          const int64_t col = col0 + lane + 32 * v;
          if (k0 + u <= last && col < nvec) {
            load_floats<N>(a.head + (k0 + u) * a.width + col * N, h[u][v]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (k0 + u <= last) {
#pragma unroll
          for (int v = 0; v < kVpt; ++v) {
#pragma unroll
            for (int i = 0; i < N; ++i) acc[v][i] = __fadd_rn(acc[v][i], h[u][v][i]);
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int64_t col = col0 + lane + 32 * v;
      if (col < nvec) write_run<T, IdxT, BYTES>(a, row, rank, col, acc[v]);
    }
  }
}

template <typename T, typename IdxT, bool HAS_W, int BYTES>
cudaError_t launch_backward(const BwdArgs& a) {
  if (a.compressed) {
    run_count_kernel<IdxT><<<static_cast<unsigned>(a.num_tiles), kThreads, 0, a.stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    run_scan_kernel<<<1, 1024, 0, a.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int N = Vec<T, BYTES>::N;
  const int64_t nvec = a.width / N;
  const int64_t slices = (nvec + a.slice_vecs - 1) / a.slice_vecs;
  if (slices > 65535) return cudaErrorInvalidConfiguration;
  const BwdSmem L = bwd_smem<IdxT, HAS_W, BYTES>(a.slice_vecs);
  auto* kernel = coo_backward_kernel<T, IdxT, HAS_W, BYTES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(a.num_tiles), static_cast<unsigned>(slices)), 32,
           static_cast<size_t>(L.total), a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The fix-up: one warp per tile.
  const int64_t fixup_blocks = (a.num_tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (fixup_blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  coo_backward_fixup_kernel<T, IdxT, BYTES>
      <<<static_cast<unsigned>(fixup_blocks), kThreads, 0, a.stream>>>(a);
  return cudaGetLastError();
}

// Vectors of a row per column slice: kSliceBytes.
inline int64_t slice_vecs_of(int64_t nvec, int vec_bytes) {
  return imin(nvec, kSliceBytes / vec_bytes);
}

// The main kernel's launch shape for `a`: dynamic shared memory per block,
// threads per block, resident blocks per SM and column slices (grid.y), into
// shape[0..3].
template <typename T, typename IdxT, bool HAS_W, int BYTES>
cudaError_t backward_shape(const BwdArgs& a, int64_t* shape) {
  const BwdSmem L = bwd_smem<IdxT, HAS_W, BYTES>(a.slice_vecs);
  auto* kernel = coo_backward_kernel<T, IdxT, HAS_W, BYTES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32,
                                                      static_cast<size_t>(L.total));
  shape[0] = L.total;
  shape[1] = 32;
  shape[2] = blocks;
  shape[3] = (a.width / Vec<T, BYTES>::N + a.slice_vecs - 1) / a.slice_vecs;
  return err;
}

// Launches K3, or with `shape` only reports its launch shape.
template <typename T, typename IdxT, bool HAS_W, int BYTES>
cudaError_t launch_or_shape(const BwdArgs& a, int64_t* shape) {
  return shape ? backward_shape<T, IdxT, HAS_W, BYTES>(a, shape)
               : launch_backward<T, IdxT, HAS_W, BYTES>(a);
}

template <typename T, typename IdxT, bool HAS_W>
cudaError_t backward_by_vec(int vec_bytes, BwdArgs a, int64_t* shape) {
  a.slice_vecs = imax(1, slice_vecs_of(a.width * static_cast<int64_t>(sizeof(T)) / vec_bytes,
                                       vec_bytes));
  if (vec_bytes == 16) return launch_or_shape<T, IdxT, HAS_W, 16>(a, shape);
  if (vec_bytes == 8) return launch_or_shape<T, IdxT, HAS_W, 8>(a, shape);
  if (vec_bytes == 4) return launch_or_shape<T, IdxT, HAS_W, 4>(a, shape);
  if constexpr (sizeof(T) == 2) {
    if (vec_bytes == 2) return launch_or_shape<T, IdxT, HAS_W, 2>(a, shape);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t backward_by_index(int index_bytes, bool has_w, int vec_bytes, const BwdArgs& a,
                              int64_t* shape) {
  if (index_bytes == 4) {
    return has_w ? backward_by_vec<T, int32_t, true>(vec_bytes, a, shape)
                 : backward_by_vec<T, int32_t, false>(vec_bytes, a, shape);
  }
  if (index_bytes == 8) {
    return has_w ? backward_by_vec<T, int64_t, true>(vec_bytes, a, shape)
                 : backward_by_vec<T, int64_t, false>(vec_bytes, a, shape);
  }
  return cudaErrorInvalidValue;
}

inline cudaError_t backward_by_dtype(int dtype, int index_bytes, bool has_w, int vec_bytes,
                                     const BwdArgs& a, int64_t* shape) {
  switch (dtype) {
    case 0:
      return backward_by_index<float>(index_bytes, has_w, vec_bytes, a, shape);
    case 1:
      return backward_by_index<__half>(index_bytes, has_w, vec_bytes, a, shape);
    case 2:
      return backward_by_index<__nv_bfloat16>(index_bytes, has_w, vec_bytes, a, shape);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace cuembed

extern "C" {

// Sorted positions per tile: the wrapper sizes head, tail, ranks and
// tail_rank by it.
int cuembed_coo_backward_tile() { return cuembed::kTile; }

// dtype (of grad_y and the output): 0 fp32, 1 fp16, 2 bf16. index_bytes: 4
// or 8 (t_idx, and uniq in compressed mode); t_sid is int32; coeff is fp32 or
// null. vec_bytes: 16, 8, 4 or the element size; the row stride and the
// grad_y and output pointers must be multiples of it. head and tail hold
// num_tiles * width floats, ranks and tail_rank num_tiles int64 (compressed
// mode only, else null), num_tiles = ceil(live / cuembed_coo_backward_tile()).
// zeroed (full mode): the output holds only +0. live >= 1. Returns the
// cudaError_t of the launches (0 on success).
int cuembed_coo_backward(const void* grad_y, const void* t_idx, const void* t_sid,
                         const void* coeff, void* out, void* uniq, void* head, void* tail,
                         void* ranks, void* tail_rank, void* num_unique, int64_t num_rows,
                         int64_t gy_rows, int64_t live, int64_t width, int dtype,
                         int index_bytes, int vec_bytes, int compressed, int zeroed,
                         void* stream) {
  if (live < 1) return static_cast<int>(cudaErrorInvalidValue);
  cuembed::BwdArgs a;
  a.grad_y = grad_y;
  a.t_idx = t_idx;
  a.t_sid = static_cast<const int32_t*>(t_sid);
  a.coeff = static_cast<const float*>(coeff);
  a.out = out;
  a.uniq = uniq;
  a.head = static_cast<float*>(head);
  a.tail = static_cast<float*>(tail);
  a.ranks = static_cast<int64_t*>(ranks);
  a.tail_rank = static_cast<int64_t*>(tail_rank);
  a.num_unique = static_cast<int64_t*>(num_unique);
  a.num_rows = num_rows;
  a.gy_rows = gy_rows;
  a.live = live;
  a.width = width;
  a.num_tiles = (live + cuembed::kTile - 1) / cuembed::kTile;
  if (a.num_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.slice_vecs = 0;
  a.compressed = compressed;
  a.zeroed = zeroed && !compressed;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cuembed::backward_by_dtype(dtype, index_bytes, coeff != nullptr,
                                                      vec_bytes, a, nullptr));
}

// The launch shape K3 takes for these arguments (as cuembed_coo_backward's),
// without launching: shape[0] dynamic shared memory bytes per block,
// shape[1] threads per block, shape[2] resident blocks per SM, shape[3]
// column slices a row. Returns a cudaError_t.
int cuembed_coo_backward_shape(int64_t width, int dtype, int index_bytes, int has_w,
                               int vec_bytes, int compressed, int zeroed, void* shape) {
  cuembed::BwdArgs a = {};
  a.width = width;
  a.compressed = compressed;
  a.zeroed = zeroed && !compressed;
  return static_cast<int>(cuembed::backward_by_dtype(dtype, index_bytes, has_w != 0, vec_bytes,
                                                      a, static_cast<int64_t*>(shape)));
}

}  // extern "C"
