// The COO transpose for Hopper (sm_90a), with a plain C interface: K5.
//
// K5 sorts a lookup's COO by row, stably, and writes the sorted COO that K3
// sums:
//     key(p)     = clamp(ids[p], -1, num_rows) + 1          in 0 .. num_rows + 1
//     order      = the positions by key, equal keys in position order
//     t_idx[r]   = ids[order[r]]
//     t_sid[r]   = order[r] / hotness, or sample_ids[order[r]]
//     t_coeff[r] = coeff[order[r]]                          (where given)
// A negative id falls into bucket 0 and an id at or past num_rows (the
// int32-max sentinel of padding and masks among them) into bucket
// num_rows + 1. So the order is the stable sort by id wherever at most one
// value lies below 0 and one at or past num_rows; several distinct
// out-of-range values keep position order within their bucket, and each
// keeps its own value in t_idx.
//
// It replaces no Pallas kernel: the JAX package sorts with lax.sort. The port
// did with torch.sort(stable=True) of the int64 ids (cub's radix sort over all
// 64 key bits, carrying int64 positions), an arange and a division for the
// sample ids, and two gathers that permuted the sample ids and coefficients.
//
// What bounds it on this card: bytes. A radix sort over the b =
// bit_length(num_rows + 1) bits the keys use, in P = ceil(b / 8) passes of
// 8-bit digits, reads the ids once for every pass's digit counts, then in each
// pass reads and writes 4-byte keys and 4-byte positions (the first reads the
// ids instead, the last writes the ids and the sample ids instead). At the
// flagship (4,194,304 int64 ids, 10M rows: 24 bits, 3 passes) that is about
// 0.25 GB, 0.075 ms at 3.35 TB/s, where torch.sort moved 8 passes of 32 bytes a
// key (1.07 GB), and most of the 33.5 MB of keys and positions a pass
// writes stays in the 50 MB L2 for the next pass.
// The design (onesweep: Adinets and Merrill, 2022):
//  1. histogram_kernel reads the ids once, 16 bytes a thread, and counts every
//     pass's digits (shared-memory atomics into a count a warp, then one
//     global atomic a bin a block).
//  2. One digit_pass_kernel a pass, with as many blocks as the card holds at
//     once. They take tiles of 4096 keys by an atomic ticket, so that tiles
//     start in order. A block counts its tile's digits a warp at a time and
//     publishes the tile's count of each digit at once; ranks its keys stably
//     into shared memory (each warp its 512 keys, 32 a step in position
//     order, the lanes of a digit found by __match_any_sync); then loads its
//     next tile while it finds the counts of the tiles before this one by
//     decoupled look-back (one thread a digit, kAhead tiles' words a read)
//     and writes each digit's run out as one contiguous stretch. Each
//     warp-wide load is one contiguous 128- or 256-byte line; the runs'
//     starts fall anywhere, so stores go one element a thread.
//  3. The last pass writes t_idx (the key less one, or for the two
//     out-of-range buckets the id itself), t_sid and t_coeff in their final
//     places: no gather kernel follows.
// This file alone decides the key bits, the passes and the scratch's layout
// (plan()); cuembed_coo_transpose_plan tells the wrapper how many bytes to
// hand over: the look-back words, digit counts and tickets, which the call
// zeroes on the stream, and the double-buffered keys and positions. Nothing
// is allocated here and nothing is read back to the host.

#include "common.cuh"

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace cuembed {
namespace {

constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kMaxPasses = 4;             // keys of at most 31 bits
constexpr int kSortThreads = kBins;       // one thread a bin in the scans
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 16;                // keys a thread
constexpr int kWarpKeys = 32 * kItems;
constexpr int kTileKeys = kSortThreads * kItems;
constexpr uint64_t kAggregate = 1ull << 62;  // a look-back word holds a tile's own count
constexpr uint64_t kInclusive = 1ull << 63;  // ... the count of every tile up to it
constexpr uint64_t kFlags = kAggregate | kInclusive;
constexpr int kAhead = 4;  // look-back words a thread reads at a time

struct TransposeArgs {
  const void* ids;             // [n] of IdT
  int64_t n, num_rows;
  uint32_t hotness;            // >= 1: the sample id is position / hotness; 0: sample_ids
  uint32_t div_magic;          // position / hotness as a multiply and shifts
  int div_shift1, div_shift2;  // (Granlund and Montgomery's unsigned division)
  const void* sample_ids;      // [n] of sid_bytes, or null
  const void* coeff;           // [n] of coeff_bytes, or null
  int sid_bytes, coeff_bytes;  // 4 or 8; 0, 2, 4 or 8
  void* t_idx;                 // [n] of IdT
  void* t_sid;                 // [n] of sid_bytes
  void* t_coeff;               // [n] of coeff_bytes, or null
  uint32_t* keys[2];           // [n] each: the passes' keys, double-buffered
  uint32_t* vals[2];           // [n] each: their positions
  uint64_t* lookback;          // [passes][tiles][kBins]
  uint32_t* hist;              // [passes][kBins]
  uint32_t* tickets;           // [passes]
  int64_t tiles;
};

template <typename IdT>
__device__ __forceinline__ uint32_t key_of(IdT id, int64_t num_rows) {
  const int64_t v = static_cast<int64_t>(id);
  return static_cast<uint32_t>((v < 0 ? -1 : (v > num_rows ? num_rows : v)) + 1);
}

__device__ __forceinline__ int64_t load_id(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ int32_t load_id(const int32_t* p) { return __ldcs(p); }

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One key's digit of every pass counted into bins[pass * kBins + digit].
__device__ __forceinline__ void count_digits(uint32_t* bins, uint32_t key, int passes) {
  for (int p = 0; p < passes; ++p) {
    atomicAdd(&bins[p * kBins + ((key >> (p * kRadixBits)) & (kBins - 1))], 1u);
  }
}

template <typename IdT>
__global__ void __launch_bounds__(kSortThreads) histogram_kernel(TransposeArgs a, int passes) {
  // A count of every pass's digits for each warp, so that warps do not
  // contend for the hot digits' counters.
  __shared__ uint32_t warp_bins[kSortWarps][kMaxPasses * kBins];
  for (int i = threadIdx.x; i < kSortWarps * kMaxPasses * kBins; i += kSortThreads) {
    warp_bins[i / (kMaxPasses * kBins)][i % (kMaxPasses * kBins)] = 0;
  }
  uint32_t* bins = warp_bins[threadIdx.x / 32];
  __syncthreads();
  constexpr int kVec = 16 / static_cast<int>(sizeof(IdT));
  const IdT* ids = static_cast<const IdT*>(a.ids);
  // 16-byte loads from the first 16-byte boundary; the ids before it and after
  // the last whole vector, fewer than 2 * kVec, go one a thread below.
  const int64_t misaligned = ((16 - (reinterpret_cast<uintptr_t>(ids) & 15)) & 15) / sizeof(IdT);
  const int64_t head = imin(a.n, misaligned);
  const int64_t vecs = (a.n - head) / kVec;
  const uint4* body = reinterpret_cast<const uint4*>(ids + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSortThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kSortThreads + threadIdx.x; v < vecs;
       v += stride) {
    IdT x[kVec];
    const uint4 raw = __ldcs(body + v);
    memcpy(x, &raw, sizeof(raw));
#pragma unroll
    for (int j = 0; j < kVec; ++j) count_digits(bins, key_of(x[j], a.num_rows), passes);
  }
  if (blockIdx.x == 0 && threadIdx.x < 2 * kVec) {
    const int64_t tail = head + vecs * kVec;
    const int64_t i = threadIdx.x < head ? threadIdx.x : tail + (threadIdx.x - head);
    if (i < a.n) count_digits(bins, key_of(ids[i], a.num_rows), passes);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kBins; i += kSortThreads) {
    uint32_t c = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) c += warp_bins[w][i];
    if (c != 0) atomicAdd(&a.hist[i], c);
  }
}

// The exclusive prefix sum of x over the block's threads in thread order;
// every thread calls it.
__device__ __forceinline__ uint32_t exclusive_scan(uint32_t x, uint32_t* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) warp_sums[warp] = s;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();
  return before + s - x;
}

// pos / hotness, exact for every 32-bit pos.
__device__ __forceinline__ uint32_t sample_of(const TransposeArgs& a, uint32_t pos) {
  const uint32_t t = __umulhi(a.div_magic, pos);
  return (t + ((pos - t) >> a.div_shift1)) >> a.div_shift2;
}

// The last pass's writes for the key at sorted place `at`, from position pos.
template <typename IdT>
__device__ __forceinline__ void write_sorted(const TransposeArgs& a, uint32_t at, uint32_t key,
                                             uint32_t pos) {
  static_cast<IdT*>(a.t_idx)[at] = key >= 1 && key <= a.num_rows
                                       ? static_cast<IdT>(key - 1)
                                       : static_cast<const IdT*>(a.ids)[pos];
  if (a.sid_bytes == 4) {
    static_cast<int32_t*>(a.t_sid)[at] =
        a.hotness ? static_cast<int32_t>(sample_of(a, pos))
                  : static_cast<const int32_t*>(a.sample_ids)[pos];
  } else {
    static_cast<int64_t*>(a.t_sid)[at] =
        a.hotness ? static_cast<int64_t>(sample_of(a, pos))
                  : static_cast<const int64_t*>(a.sample_ids)[pos];
  }
  switch (a.coeff_bytes) {
    case 2:
      static_cast<uint16_t*>(a.t_coeff)[at] = static_cast<const uint16_t*>(a.coeff)[pos];
      break;
    case 4:
      static_cast<uint32_t*>(a.t_coeff)[at] = static_cast<const uint32_t*>(a.coeff)[pos];
      break;
    case 8:
      static_cast<uint64_t*>(a.t_coeff)[at] = static_cast<const uint64_t*>(a.coeff)[pos];
      break;
    default:
      break;
  }
}

struct PassShared {
  uint32_t keys[kTileKeys];  // the tile's keys, sorted by digit
  uint32_t vals[kTileKeys];  // their positions
  uint32_t warp_bins[kSortWarps][kBins + 1];  // a warp's digit counts, then its places
  uint32_t out_base[kBins];  // a digit's output place less its place in the tile
  uint32_t warp_sums[kSortWarps];
  uint32_t tile;
};

// A tile's keys and positions, as thread (warp, lane) holds them: positions
// first + 32 * i. The first pass holds the ids' low and high words until
// ids_to_keys turns them into keys and positions.
template <typename IdT, bool kFirst>
__device__ __forceinline__ void load_tile(const TransposeArgs& a, int pass, int64_t first,
                                          uint32_t (&key)[kItems], uint32_t (&val)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = first + i * 32;
    key[i] = 0;
    val[i] = 0;
    if (p < a.n) {
      if constexpr (kFirst) {
        const uint64_t id = static_cast<uint64_t>(load_id(static_cast<const IdT*>(a.ids) + p));
        key[i] = static_cast<uint32_t>(id);
        val[i] = static_cast<uint32_t>(id >> 32);
      } else {
        key[i] = __ldcs(a.keys[(pass + 1) & 1] + p);
        val[i] = __ldcs(a.vals[(pass + 1) & 1] + p);
      }
    }
  }
}

template <typename IdT>
__device__ __forceinline__ void ids_to_keys(const TransposeArgs& a, int64_t first,
                                            uint32_t (&key)[kItems], uint32_t (&val)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint64_t bits = (static_cast<uint64_t>(val[i]) << 32) | key[i];
    const IdT id = sizeof(IdT) == 8 ? static_cast<IdT>(bits) : static_cast<IdT>(key[i]);
    key[i] = key_of(id, a.num_rows);
    val[i] = static_cast<uint32_t>(first + i * 32);
  }
}

// One pass over the digit at bits [8 * pass, 8 * pass + 8): the first reads the
// ids, the last writes the outputs. A block takes tiles by ticket until none
// is left, and loads its next tile while it finds and writes the current
// one's place.
template <typename IdT, bool kFirst, bool kLast>
__global__ void __launch_bounds__(kSortThreads) digit_pass_kernel(TransposeArgs a, int pass) {
  __shared__ PassShared s;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, d = tid;
  const uint32_t lane_lt = (1u << lane) - 1;
  const int shift = pass * kRadixBits;
  const int64_t n = a.n;
  uint64_t* words = a.lookback + static_cast<int64_t>(pass) * a.tiles * kBins + d;
  uint32_t* bins = s.warp_bins[warp];
  if (tid == 0) s.tile = atomicAdd(&a.tickets[pass], 1u);
  for (int i = tid; i < kSortWarps * (kBins + 1); i += kSortThreads) {
    s.warp_bins[i / (kBins + 1)][i % (kBins + 1)] = 0;
  }
  // Where this pass writes digit d's keys, and the block's first tile.
  const uint32_t bin_base = exclusive_scan(a.hist[pass * kBins + d], s.warp_sums);
  int64_t tile = s.tile;
  uint32_t key[kItems], val[kItems];
  const int64_t offset = warp * kWarpKeys + lane;  // the thread's first position in a tile
  if (tile < a.tiles) load_tile<IdT, kFirst>(a, pass, tile * kTileKeys + offset, key, val);

  while (tile < a.tiles) {
    // Warp w holds the tile's positions w * 512 + i * 32 + lane: ranked item
    // by item, lane by lane, they are visited in position order.
    const int64_t base = tile * kTileKeys;
    const int64_t first = base + offset;
    if constexpr (kFirst) ids_to_keys<IdT>(a, first, key, val);

    // The tile's count of each digit, published at once for the tiles after
    // it; each warp's place for it in the tile's sorted order.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (first + i * 32 < n) atomicAdd(&bins[(key[i] >> shift) & (kBins - 1)], 1u);
    }
    __syncthreads();
    uint32_t count = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const uint32_t c = s.warp_bins[w][d];
      s.warp_bins[w][d] = count;
      count += c;
    }
    store_relaxed(words + tile * kBins, (tile == 0 ? kInclusive : kAggregate) | count);
    const uint32_t start = exclusive_scan(count, s.warp_sums);
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) s.warp_bins[w][d] += start;
    __syncthreads();

    // Each key's place in the tile: its warp's place for its digit plus the
    // keys of the digit before it in the warp. The first lane of each digit's
    // group reads and advances the warp's place. Lanes without a key (in the
    // last tile) take the extra digit kBins.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool ok = first + i * 32 < n;
      const uint32_t dig = ok ? (key[i] >> shift) & (kBins - 1) : kBins;
      const unsigned peers = __match_any_sync(0xffffffffu, dig);
      const uint32_t below = __popc(peers & lane_lt);
      uint32_t before = 0;
      if (below == 0) {
        before = bins[dig];
        bins[dig] = before + __popc(peers);
      }
      const uint32_t at = __shfl_sync(0xffffffffu, before, __ffs(peers) - 1) + below;
      if (ok) {
        s.keys[at] = key[i];
        s.vals[at] = val[i];
      }
      __syncwarp();
    }
    __syncthreads();
    if (tid == 0) s.tile = atomicAdd(&a.tickets[pass], 1u);
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) s.warp_bins[w][d] = 0;
    if (tid < kSortWarps) s.warp_bins[tid][kBins] = 0;
    __syncthreads();
    const int64_t next = s.tile;
    if (next < a.tiles) load_tile<IdT, kFirst>(a, pass, next * kTileKeys + offset, key, val);

    // Decoupled look-back: digit d's keys in the tiles before this one, from
    // the nearest tile back that holds its inclusive count, reading kAhead
    // tiles' words at a time.
    uint32_t before_tiles = 0;
    if (tile > 0) {
      bool found = false;
      for (int64_t t = tile - 1; !found; t -= kAhead) {
        uint64_t w[kAhead];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          w[j] = t - j >= 0 ? load_relaxed(words + (t - j) * kBins) : 0;
        }
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          if (found) break;
          while ((w[j] & kFlags) == 0) w[j] = load_relaxed(words + (t - j) * kBins);
          before_tiles += static_cast<uint32_t>(w[j]);
          found = (w[j] & kInclusive) != 0;
        }
      }
      store_relaxed(words + tile * kBins, kInclusive | (before_tiles + count));
    }
    s.out_base[d] = bin_base + before_tiles - start;  // modulo 2^32; the sum lies below n
    __syncthreads();

    const int valid = static_cast<int>(imin(kTileKeys, n - base));
    for (int j = tid; j < valid; j += kSortThreads) {
      const uint32_t k = s.keys[j], v = s.vals[j];
      const uint32_t at = s.out_base[(k >> shift) & (kBins - 1)] + j;
      if constexpr (kLast) {
        write_sorted<IdT>(a, at, k, v);
      } else {
        a.keys[pass & 1][at] = k;
        a.vals[pass & 1][at] = v;
      }
    }
    tile = next;
  }
}

// K5's plan for n positions into num_rows rows: the bits its keys use
// (bit_length(num_rows + 1), at most 31 since num_rows + 2 <= 2^31), the digit
// passes they need, and the scratch's offsets in bytes: the zeroed look-back
// words, digit counts and tickets, then the keys and positions of the passes
// (none for one pass, one pair for two, two pairs past that).
struct Plan {
  int key_bits, passes;
  int64_t tiles, hist, tickets, zeroed, total;
};
static_assert(kMaxPasses * kRadixBits >= 31, "31-bit keys must fit the passes");

inline Plan plan(int64_t n, int64_t num_rows) {
  Plan l;
  l.key_bits = 0;
  while (((num_rows + 1) >> l.key_bits) != 0) ++l.key_bits;
  l.passes = (l.key_bits + kRadixBits - 1) / kRadixBits;
  l.tiles = (n + kTileKeys - 1) / kTileKeys;
  l.hist = l.passes * l.tiles * kBins * 8;
  l.tickets = l.hist + l.passes * kBins * 4;
  l.zeroed = (l.tickets + l.passes * 4 + 15) / 16 * 16;
  l.total = l.zeroed + std::min(l.passes - 1, 2) * 2 * n * 4;
  return l;
}

// What K5 takes: n < 2^31 positions and num_rows + 2 <= 2^31 rows.
inline bool in_range(int64_t n, int64_t num_rows) {
  const int64_t limit = int64_t{1} << 31;
  return n >= 0 && n < limit && num_rows >= 0 && num_rows + 2 <= limit;
}

template <typename IdT>
cudaError_t run(const TransposeArgs& a, int passes, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t hist_blocks = std::max<int64_t>(1, std::min<int64_t>(a.tiles, 4 * sms));
  histogram_kernel<IdT><<<static_cast<unsigned>(hist_blocks), kSortThreads, 0, stream>>>(a, passes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int p = 0; p < passes; ++p) {
    const bool first = p == 0, last = p == passes - 1;
    auto kernel = first ? (last ? digit_pass_kernel<IdT, true, true>
                                : digit_pass_kernel<IdT, true, false>)
                        : (last ? digit_pass_kernel<IdT, false, true>
                                : digit_pass_kernel<IdT, false, false>);
    // As many blocks as the card holds at once, each taking tiles in turn.
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSortThreads, 0);
    if (err != cudaSuccess) return err;
    const int64_t blocks = std::max<int64_t>(1, std::min<int64_t>(a.tiles, int64_t{sms} * per_sm));
    kernel<<<static_cast<unsigned>(blocks), kSortThreads, 0, stream>>>(a, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace cuembed

extern "C" {

// K5's plan (see plan()) for n positions into num_rows rows: out[0] the key
// bits, out[1] the digit passes, out[2] the scratch bytes that
// cuembed_coo_transpose needs. cudaErrorInvalidValue where K5 does not take
// n or num_rows.
int cuembed_coo_transpose_plan(int64_t n, int64_t num_rows, int64_t* out) {
  if (!cuembed::in_range(n, num_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const cuembed::Plan l = cuembed::plan(n, num_rows);
  out[0] = l.key_bits;
  out[1] = l.passes;
  out[2] = l.total;
  return static_cast<int>(cudaSuccess);
}

// The sorted COO of n ids (id_bytes 4 or 8) of a table of num_rows rows. The
// sample ids: position / hotness (hotness >= 1, sample_ids null) or
// sample_ids[p] (hotness 0); t_sid has sid_bytes (4 or 8) elements, as
// sample_ids does. coeff (coeff_bytes 2, 4 or 8; null and 0 for none) rides
// along. scratch: at least the bytes cuembed_coo_transpose_plan gives,
// 16-byte aligned. n < 2^31 and num_rows + 2 <= 2^31. All on the current
// device, contiguous. Returns the cudaError_t of the zero fill or of the
// first launch that failed.
int cuembed_coo_transpose(const void* ids, int id_bytes, int64_t n, int64_t num_rows,
                          int64_t hotness, const void* sample_ids, int sid_bytes,
                          const void* coeff, int coeff_bytes, void* t_idx, void* t_sid,
                          void* t_coeff, void* scratch, int64_t scratch_bytes, void* stream) {
  if (!cuembed::in_range(n, num_rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);  // empty tensors may have null pointers
  if ((id_bytes != 4 && id_bytes != 8) || (sid_bytes != 4 && sid_bytes != 8) ||
      (coeff_bytes != 0 && coeff_bytes != 2 && coeff_bytes != 4 && coeff_bytes != 8) ||
      ((coeff_bytes == 0) != (coeff == nullptr)) || ((coeff == nullptr) != (t_coeff == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sample_ids == nullptr ? (hotness < 1 || hotness > UINT32_MAX) : hotness != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cuembed::Plan l = cuembed::plan(n, num_rows);
  if (scratch == nullptr || scratch_bytes < l.total ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  cudaError_t err = cudaMemsetAsync(base, 0, l.zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cuembed::TransposeArgs a = {};
  a.ids = ids;
  a.n = n;
  a.num_rows = num_rows;
  a.hotness = static_cast<uint32_t>(hotness);
  if (a.hotness != 0) {
    int lg = 0;  // ceil(log2(hotness))
    while ((uint64_t{1} << lg) < a.hotness) ++lg;
    a.div_magic = static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << lg) - a.hotness)) /
                                        a.hotness + 1);
    a.div_shift1 = std::min(lg, 1);
    a.div_shift2 = std::max(lg - 1, 0);
  }
  a.sample_ids = sample_ids;
  a.coeff = coeff;
  a.sid_bytes = sid_bytes;
  a.coeff_bytes = coeff_bytes;
  a.t_idx = t_idx;
  a.t_sid = t_sid;
  a.t_coeff = t_coeff;
  uint32_t* buf = reinterpret_cast<uint32_t*>(base + l.zeroed);
  a.keys[0] = buf;
  a.vals[0] = buf + n;
  a.keys[1] = buf + 2 * n;
  a.vals[1] = buf + 3 * n;
  a.lookback = reinterpret_cast<uint64_t*>(base);
  a.hist = reinterpret_cast<uint32_t*>(base + l.hist);
  a.tickets = reinterpret_cast<uint32_t*>(base + l.tickets);
  a.tiles = l.tiles;
  err = id_bytes == 4 ? cuembed::run<int32_t>(a, l.passes, s)
                      : cuembed::run<int64_t>(a, l.passes, s);
  return static_cast<int>(err);
}

}  // extern "C"
