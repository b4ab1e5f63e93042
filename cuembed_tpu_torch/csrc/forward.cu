// Forward embedding-bag kernels for Hopper (sm_90a), with a plain C interface.
//
// K1 `fixed_forward_kernel` replaces the Pallas gather-reduce kernel
// cuembed_tpu/ops/pallas_forward.py::_make_fwd_kernel:
//     out[b] = sum_j c[b, j] * table[idx[b, j]]   (MEAN: x rounded 1/hotness after the sum)
// K2 `csr_forward_kernel` replaces the ragged CSR kernel
// cuembed_tpu/ops/pallas_forward.py::_make_csr_fwd_kernel:
//     out[s] = sum_{p in [off[s], off[s+1])} c[p] * table[idx[p]]   (MEAN: x rounded 1/h_s)
//
// Both run one core, `combine_items`: a fixed batch is a CSR batch whose bag
// b holds positions [b * hotness, (b + 1) * hotness). A worker of `lanes`
// threads (a warp, or 8 or 16 lanes of one for narrow rows) takes one work
// item at a time, a bag and a slab of up to `lanes` column vectors of its
// rows, and adds the bag's rows in position order, one column vector a lane.
//
// Each lookup reads one table row and does one add per element. Power-law
// ids repeat, so most rows come from L1 or L2, not device memory. What
// bounds the kernels on an H100 is the SM side: the instructions a row costs
// a lane (its load and address, a conversion and an add per element) and
// the row loads each SM keeps in flight, which registers cap (PERF.md §6,
// tools/fwd_sweep.py). The design:
// * A block owns a run of work items and its workers pull them one at a time
//   from a counter in shared memory, so a worker that finishes a short bag
//   takes the next one: no warp slot waits on another bag (K2's ragged bags
//   are U{0..64} at the flagship), and a block retires when its items are.
// * A worker stages `lanes` positions at a time: each lane loads one index
//   and weight, checks the index's range once, and writes the row's offset
//   into the worker's slots in dynamic shared memory. The slots, and a K2
//   block's bag offsets, are all the shared memory a block holds (2-4 KB),
//   so L1 keeps the rest of the SM's 256 KB for rows.
// * Nothing waits on an index: a worker takes its next item an item ahead,
//   and the next chunk's indices, this item's or the next one's, load while
//   this chunk's rows are in flight.
// * Each lane issues kFixedUnroll (K1) or kCsrUnroll (K2) independent row
//   loads, the widest vector the row stride and pointers allow (16, 8 bytes
//   or one element), before it adds any; a chunk's last group is one
//   predicated group. Each load in flight holds its bytes in registers:
//   kMinBlocks caps them at 64 a thread, so 4 blocks of 8 warps fit an SM.
// Rows are addressed in 64 bits: a 10M x 256 table holds more than 2^31
// elements. Every output row is written once, by one worker; a zero-hotness
// bag writes zeros (the output comes from torch.empty).
//
// Rounding follows the plain PyTorch version in ops/lookup_torch.py exactly,
// so the kernels equal it bit for bit: adds and products are taken one at a
// time in position order, in fp32 (__fadd_rn / __fmul_rn, no fused
// multiply-add). Under low-precision math they are taken in the storage type,
// two elements at a time, by the packed add.rn / mul.rn .f16x2 and .bf16x2
// instructions: each rounds once, correctly, which gives the bits of the
// fp32 op followed by one rounding to the storage type (what a storage-dtype
// sum in PyTorch or JAX computes), because fp32 holds every fp16/bf16 sum
// and product of two such values before that rounding (24 >= 2 * 11 + 2
// bits). Where a row is read from (L1, L2 or memory) changes no bit.

#include "common.cuh"

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace cuembed {

constexpr int kFixedUnroll = 6;  // row loads in flight a lane, K1
constexpr int kCsrUnroll = 5;    // and K2
constexpr int kMinBlocks = 4;    // blocks of kThreads resident per SM: at most 64 registers

// Round to the accumulation type: identity for fp32 accumulation, a round
// trip through the storage type under low-precision math.
template <typename T, bool LPM>
__device__ __forceinline__ float acc_round(float x) {
  if constexpr (LPM) {
    return to_float(from_float<T>(x));
  } else {
    return x;
  }
}

// Packed pairs of T in 32-bit words: the correctly rounded add and product,
// never contracted into a fused multiply-add (an explicit .rn forbids it).
template <typename T>
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b);
template <typename T>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b);
template <>
__device__ __forceinline__ uint32_t add2<__half>(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <>
__device__ __forceinline__ uint32_t mul2<__half>(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <>
__device__ __forceinline__ uint32_t add2<__nv_bfloat16>(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <>
__device__ __forceinline__ uint32_t mul2<__nv_bfloat16>(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// One lane's sums over a column vector of BYTES, in the accumulation type.
// A coefficient (weight or MEAN factor) travels as 32 bits: an fp32 value,
// or under low-precision math its storage-type rounding in both halves.
// fp32 accumulation:
template <typename T, bool LPM, int BYTES>
struct Acc {
  using V = Vec<T, BYTES>;
  static constexpr int N = V::N;
  float v[N];

  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ static uint32_t coeff(float c) { return __float_as_uint(c); }
  template <bool HAS_W>
  __device__ __forceinline__ void add(const typename V::Raw& raw, uint32_t w) {
    float x[N];
    V::unpack(raw, x);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = __fadd_rn(v[i], HAS_W ? __fmul_rn(x[i], __uint_as_float(w)) : x[i]);
    }
  }
  __device__ __forceinline__ void scale(uint32_t c) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __fmul_rn(v[i], __uint_as_float(c));
  }
  __device__ __forceinline__ void store(T* p) const { V::store(p, v); }
};

// Low-precision math: pairs of T in 32-bit words. A one-element vector
// (BYTES == 2) rides in the low half of one word; its high half adds zeros.
template <typename T, int BYTES>
struct Acc<T, true, BYTES> {
  using V = Vec<T, BYTES>;
  using Raw = typename V::Raw;
  static constexpr int W = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t v[W];

  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = 0u;
  }
  __device__ __forceinline__ static uint32_t coeff(float c) {
    const T h = from_float<T>(c);
    uint16_t bits;
    memcpy(&bits, &h, sizeof(bits));
    return bits | (static_cast<uint32_t>(bits) << 16);
  }
  template <bool HAS_W>
  __device__ __forceinline__ void add(const Raw& raw, uint32_t w) {
    uint32_t x[W];
    if constexpr (BYTES >= 4) {
      memcpy(x, &raw, BYTES);
    } else {
      x[0] = raw;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = add2<T>(v[i], HAS_W ? mul2<T>(x[i], w) : x[i]);
  }
  __device__ __forceinline__ void scale(uint32_t c) {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = mul2<T>(v[i], c);
  }
  __device__ __forceinline__ void store(T* p) const {
    Raw raw;
    if constexpr (BYTES >= 4) {
      memcpy(&raw, v, BYTES);
    } else {
      raw = static_cast<Raw>(v[0]);
    }
    *reinterpret_cast<Raw*>(p) = raw;
  }
};

struct FwdArgs {
  const void* table;
  const void* indices;
  const void* offsets;  // K2 only
  const void* weights;  // fp32, or null
  void* out;
  int64_t num_rows, batch, hotness, capacity, width;
  int64_t items;            // batch * slabs
  int64_t items_per_block;  // work items a block owns
  int lanes;                // threads of a worker: 8, 16 or 32
  int slabs;                // column slabs of `lanes` vectors a row
  int mean;
  float mean_scale;  // K1's MEAN factor, rounded to the accumulation type
};

template <typename OffT>
__device__ __forceinline__ int64_t load_offset(const void* offsets, int64_t i) {
  return static_cast<int64_t>(__ldg(static_cast<const OffT*>(offsets) + i));
}

// Bag b of a fixed batch: positions [b * hotness, (b + 1) * hotness), MEAN
// by the wrapper's factor.
struct FixedBags {
  static constexpr int kUnroll = kFixedUnroll;
  __device__ __forceinline__ void stage(const FwdArgs&, int64_t, int64_t, int64_t*) {}
  __device__ __forceinline__ int64_t lo(const FwdArgs& a, int64_t b) const {
    return b * a.hotness;
  }
  __device__ __forceinline__ int64_t hi(const FwdArgs& a, int64_t b) const {
    return (b + 1) * a.hotness;
  }
  template <typename T, bool LPM>
  __device__ __forceinline__ float scale(const FwdArgs& a, int64_t) const {
    return a.mean_scale;
  }
};

// Bag s of a CSR batch: [off[s], off[s+1]) clipped to the live positions
// (below offsets[batch] and the capacity: padding is never read); MEAN sums
// first, then x acc(1 / acc(h_s)), and h_s = 0 gives a row of zeros. A
// block stages its bags' offsets in shared memory once.
template <typename OffT>
struct CsrBags {
  static constexpr int kUnroll = kCsrUnroll;
  int64_t live_end, b0;
  const int64_t* off;  // offsets[b0 ...] in shared memory
  __device__ __forceinline__ explicit CsrBags(const FwdArgs& a)
      : live_end(imin(load_offset<OffT>(a.offsets, a.batch), a.capacity)) {}
  // Offsets b0 .. b_last + 1, by the block's threads together.
  __device__ __forceinline__ void stage(const FwdArgs& a, int64_t first_bag, int64_t last_bag,
                                        int64_t* smem) {
    b0 = first_bag;
    off = smem;
    for (int64_t j = threadIdx.x; j <= last_bag + 1 - first_bag; j += blockDim.x)
      smem[j] = load_offset<OffT>(a.offsets, first_bag + j);
  }
  __device__ __forceinline__ int64_t lo(const FwdArgs&, int64_t s) const {
    return imax(off[s - b0], 0);
  }
  __device__ __forceinline__ int64_t hi(const FwdArgs&, int64_t s) const {
    return imin(off[s - b0 + 1], live_end);
  }
  template <typename T, bool LPM>
  __device__ __forceinline__ float scale(const FwdArgs&, int64_t s) const {
    const int64_t first = off[s - b0], last = off[s - b0 + 1];
    const float h = acc_round<T, LPM>(static_cast<float>(last - first));
    return last == first ? 0.f : acc_round<T, LPM>(__fdiv_rn(1.f, h));
  }
};

// acc += c * row for the n staged positions of a chunk, in order: groups of
// UNROLL loads issued before their adds (no more: each load in flight holds
// BYTES of registers), the last group predicated. `base` is this lane's
// column in row 0, `rows` the rows' byte offsets.
template <int UNROLL, typename T, bool HAS_W, bool LPM, int BYTES>
__device__ __forceinline__ void combine_chunk(Acc<T, LPM, BYTES>& acc, const char* base,
                                              const int64_t* rows, const uint32_t* ws,
                                              int n) {
  using V = Vec<T, BYTES>;
  const auto row = [&](int j) { return reinterpret_cast<const T*>(base + rows[j]); };
  typename V::Raw raw[UNROLL];
  int j = 0;
#pragma unroll 1
  for (; j + UNROLL <= n; j += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = V::load(row(j + u));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc.template add<HAS_W>(raw[u], HAS_W ? ws[j + u] : 0u);
  }
  if (j < n) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j + u < n) raw[u] = V::load(row(j + u));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j + u < n) acc.template add<HAS_W>(raw[u], HAS_W ? ws[j + u] : 0u);
    }
  }
}

// The core of K1 and K2 (see the top of the file). Dynamic shared memory:
// one row's byte offset (int64) and, weighted, one coefficient (32 bits)
// for each thread of the block, each worker's `lanes` slots side by side;
// then a K2 block's bag offsets (int64).
template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES, typename Bags>
__device__ __forceinline__ void combine_items(const FwdArgs& a, Bags& bags) {
  using V = Vec<T, BYTES>;
  using A = Acc<T, LPM, BYTES>;
  constexpr int N = V::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_next;  // the block's next work item
  int64_t* s_row = reinterpret_cast<int64_t*>(smem);
  uint32_t* s_w = reinterpret_cast<uint32_t*>(s_row + blockDim.x);

  const IdxT* indices = static_cast<const IdxT*>(a.indices);
  const float* weights = static_cast<const float*>(a.weights);
  const int L = a.lanes;
  const int gl = threadIdx.x & (L - 1);          // lane in the worker
  const int leader = (threadIdx.x & 31) - gl;    // its first lane in the warp
  const unsigned mask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << leader;
  const int slot0 = threadIdx.x - gl;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * a.items_per_block;
  const unsigned count = static_cast<unsigned>(imin(a.items_per_block, a.items - first));
  const int nvec = static_cast<int>(a.width / N);
  // Item first + i is bag (first + i) / slabs, over the slab of column
  // vectors (first + i) % slabs: 32-bit division from the block's first bag,
  // none for rows of one slab.
  const int64_t b0 = first / a.slabs;
  const unsigned s0 = static_cast<unsigned>(first - b0 * a.slabs);
  const unsigned slabs = static_cast<unsigned>(a.slabs);
  const auto bag_of = [&](unsigned i) { return b0 + (slabs == 1 ? i : (s0 + i) / slabs); };
  const auto slab_of = [&](unsigned i) { return slabs == 1 ? 0u : (s0 + i) % slabs; };
  // Worker w's first item is item w; the rest are taken from the counter.
  if (threadIdx.x == 0) s_next = blockDim.x / L;
  bags.stage(a, b0, bag_of(count - 1),
             reinterpret_cast<int64_t*>(s_w + (HAS_W ? blockDim.x : 0)));
  __syncthreads();

  const auto pull = [&]() {
    unsigned got = 0;
    if (gl == 0) got = atomicAdd(&s_next, 1u);
    return __shfl_sync(mask, got, leader);
  };
  // This lane's index and weight of bag b's chunk at q.
  IdxT id = 0;
  float w = 0.f;
  const auto fetch = [&](int64_t q, int64_t b) {
    id = 0;
    if (q + gl < bags.hi(a, b)) {
      id = __ldg(indices + q + gl);
      if constexpr (HAS_W) w = __ldg(weights + q + gl);
    }
  };

  unsigned k = threadIdx.x / L;
  if (k >= count) return;
  int64_t b = bag_of(k);
  unsigned k_next = pull();
  int64_t b_next = k_next < count ? bag_of(k_next) : b;
  fetch(bags.lo(a, b), b);
  for (;;) {
    const int col = static_cast<int>(slab_of(k)) * L + gl;
    const int64_t hi = bags.hi(a, b);
    int64_t p = bags.lo(a, b);
    const bool had_chunks = p < hi;
    const bool active = col < nvec;
    const char* base = static_cast<const char*>(a.table) + static_cast<int64_t>(col) * BYTES;
    A acc;
    while (p < hi) {
      const int n = static_cast<int>(imin(L, hi - p));
      // An index out of range stops the kernel (the launch then fails).
      if (gl < n && (id < 0 || static_cast<int64_t>(id) >= a.num_rows)) __trap();
      __syncwarp(mask);  // the worker has read the previous chunk's slots
      s_row[slot0 + gl] = static_cast<int64_t>(id) * a.width * static_cast<int64_t>(sizeof(T));
      if constexpr (HAS_W) s_w[slot0 + gl] = A::coeff(w);
      __syncwarp(mask);
      // The next chunk's indices, this item's or the next item's first,
      // load while this chunk's rows are in flight.
      p += L;
      if (p < hi) {
        fetch(p, b);
      } else if (k_next < count) {
        fetch(bags.lo(a, b_next), b_next);
      }
      if (active) {
        combine_chunk<Bags::kUnroll, T, HAS_W, LPM, BYTES>(acc, base, s_row + slot0,
                                                            s_w + slot0, n);
      }
    }
    if (active) {
      if (a.mean) acc.scale(A::coeff(bags.template scale<T, LPM>(a, b)));
      acc.store(static_cast<T*>(a.out) + b * a.width + static_cast<int64_t>(col) * N);
    }
    if (k_next >= count) return;
    k = k_next;
    b = b_next;
    if (!had_chunks) fetch(bags.lo(a, b), b);
    k_next = pull();
    if (k_next < count) b_next = bag_of(k_next);
  }
}

template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fixed_forward_kernel(const FwdArgs a) {
  FixedBags bags;
  combine_items<T, IdxT, HAS_W, LPM, BYTES>(a, bags);
}

template <typename T, typename IdxT, typename OffT, bool HAS_W, bool LPM, int BYTES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) csr_forward_kernel(const FwdArgs a) {
  CsrBags<OffT> bags(a);
  combine_items<T, IdxT, HAS_W, LPM, BYTES>(a, bags);
}

// A launch, or (shape != null) the report of its shape without launching.
struct Launch {
  FwdArgs a;
  int csr, offset_bytes, threads, smem_bytes;
  cudaStream_t stream;
  int64_t* shape;
};

// The plan (ops/cuda_forward.py::launch_plan) is checked, not trusted: the
// `nvec` column vectors of a row must fit in its slabs.
template <typename Kernel>
cudaError_t run_kernel(Kernel kernel, int64_t nvec, const Launch& l) {
  const FwdArgs& a = l.a;
  const bool lanes_ok = a.lanes == 8 || a.lanes == 16 || a.lanes == 32;
  if (!lanes_ok || l.threads < 32 || l.threads > kThreads || l.threads % 32 != 0 ||
      nvec > 0x7fffffff || a.slabs < 1 || static_cast<int64_t>(a.slabs) * a.lanes < nvec ||
      a.items_per_block < 1 || a.items_per_block > 0x7fffffff ||
      l.smem_bytes < l.threads * static_cast<int>(sizeof(int64_t) + (a.weights ? 4 : 0)) +
                         (l.csr ? 8 * static_cast<int>(a.items_per_block + 2) : 0))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (l.smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  if (l.shape) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, l.threads,
                                                        static_cast<size_t>(l.smem_bytes));
    l.shape[0] = attr.numRegs;
    l.shape[1] = static_cast<int64_t>(attr.localSizeBytes);
    l.shape[2] = static_cast<int64_t>(attr.sharedSizeBytes) + l.smem_bytes;
    l.shape[3] = blocks;
    return err;
  }
  const int64_t blocks = (a.items + a.items_per_block - 1) / a.items_per_block;
  if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), l.threads, static_cast<size_t>(l.smem_bytes),
           l.stream>>>(a);
  return cudaGetLastError();
}

struct Launcher {
  template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
  static cudaError_t run(const Launch& l) {
    const int64_t nvec = l.a.width / Vec<T, BYTES>::N;
    if (!l.csr) return run_kernel(fixed_forward_kernel<T, IdxT, HAS_W, LPM, BYTES>, nvec, l);
    if (l.offset_bytes == 4)
      return run_kernel(csr_forward_kernel<T, IdxT, int32_t, HAS_W, LPM, BYTES>, nvec, l);
    if (l.offset_bytes == 8)
      return run_kernel(csr_forward_kernel<T, IdxT, int64_t, HAS_W, LPM, BYTES>, nvec, l);
    return cudaErrorInvalidValue;
  }
};

// The by_* functions turn the run-time choices into template arguments, then
// call Launcher::run<T, IdxT, HAS_W, LPM, BYTES>(launch).
template <typename T, typename IdxT, bool HAS_W, bool LPM>
cudaError_t by_vec(int vec_bytes, const Launch& l) {
  switch (vec_bytes) {
    case 16:
      return Launcher::run<T, IdxT, HAS_W, LPM, 16>(l);
    case 8:
      return Launcher::run<T, IdxT, HAS_W, LPM, 8>(l);
    case static_cast<int>(sizeof(T)):
      return Launcher::run<T, IdxT, HAS_W, LPM, static_cast<int>(sizeof(T))>(l);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename IdxT, bool HAS_W>
cudaError_t by_lpm(int lpm, int vec_bytes, const Launch& l) {
  if constexpr (std::is_same_v<T, float>) {
    // fp32 storage always accumulates in fp32.
    return by_vec<T, IdxT, HAS_W, false>(vec_bytes, l);
  } else {
    return lpm ? by_vec<T, IdxT, HAS_W, true>(vec_bytes, l)
               : by_vec<T, IdxT, HAS_W, false>(vec_bytes, l);
  }
}

template <typename T>
cudaError_t by_index(int index_bytes, bool has_w, int lpm, int vec_bytes, const Launch& l) {
  if (index_bytes == 4) {
    return has_w ? by_lpm<T, int32_t, true>(lpm, vec_bytes, l)
                 : by_lpm<T, int32_t, false>(lpm, vec_bytes, l);
  }
  if (index_bytes == 8) {
    return has_w ? by_lpm<T, int64_t, true>(lpm, vec_bytes, l)
                 : by_lpm<T, int64_t, false>(lpm, vec_bytes, l);
  }
  return cudaErrorInvalidValue;
}

cudaError_t by_dtype(int dtype, int index_bytes, bool has_w, int lpm, int vec_bytes,
                     const Launch& l) {
  switch (dtype) {
    case 0:
      return by_index<float>(index_bytes, has_w, lpm, vec_bytes, l);
    case 1:
      return by_index<__half>(index_bytes, has_w, lpm, vec_bytes, l);
    case 2:
      return by_index<__nv_bfloat16>(index_bytes, has_w, lpm, vec_bytes, l);
    default:
      return cudaErrorInvalidValue;
  }
}

// int64 words of a descriptor of cuembed_fixed_forward_many.
constexpr int kFixedDescWords = 20;

}  // namespace cuembed

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16. index_bytes / offset_bytes: 4 or 8.
// vec_bytes: 16, 8 or the element size; the row stride and the table and
// output pointers must be multiples of it. weights: fp32 or null.
// lanes, slabs, items_per_block, threads, smem_bytes: the launch plan of
// ops/cuda_forward.py::launch_plan.
// Returns the cudaError_t of the launch (0 on success).
int cuembed_fixed_forward(const void* table, const void* indices, const void* weights,
                          void* out, int64_t num_rows, int64_t batch, int64_t hotness,
                          int64_t width, int dtype, int index_bytes,
                          int low_precision_math, int vec_bytes, float mean_scale, int mean,
                          int lanes, int slabs, int64_t items_per_block, int threads,
                          int smem_bytes, void* stream) {
  cuembed::Launch l = {};
  l.a = {table, indices, nullptr, weights, out, num_rows, batch, hotness, 0, width,
         batch * slabs, items_per_block, lanes, slabs, mean, mean_scale};
  l.threads = threads;
  l.smem_bytes = smem_bytes;
  l.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cuembed::by_dtype(dtype, index_bytes, weights != nullptr,
                                            low_precision_math, vec_bytes, l));
}

// K1 for `n` lookups, launched one after the other on `stream`, each as
// cuembed_fixed_forward launches it. `desc` holds n descriptors of
// kFixedDescWords int64 words (ops/cuda_forward.py::pack_fixed_many):
//   0-3   table, indices, weights (0: none), out
//   4-7   num_rows, batch, hotness, width
//   8-9   index_bytes, vec_bytes
//   10-13 dtype, low_precision_math, the bits of the float mean_scale, mean
//   14-19 the launch plan as launch_plan returns it: lanes, slabs, threads,
//         items_per_block, blocks (checked against the others), smem_bytes
// Returns the first error (0 when every launch succeeded); the lookups after
// it are not launched.
int cuembed_fixed_forward_many(const int64_t* desc, int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    const int64_t* d = desc + static_cast<int64_t>(i) * cuembed::kFixedDescWords;
    if (d[17] < 1 || d[18] != (d[5] * d[15] + d[17] - 1) / d[17])
      return static_cast<int>(cudaErrorInvalidValue);
    const uint32_t bits = static_cast<uint32_t>(d[12]);
    float mean_scale;
    std::memcpy(&mean_scale, &bits, sizeof(mean_scale));
    const int err = cuembed_fixed_forward(
        reinterpret_cast<const void*>(d[0]), reinterpret_cast<const void*>(d[1]),
        reinterpret_cast<const void*>(d[2]), reinterpret_cast<void*>(d[3]), d[4], d[5], d[6],
        d[7], static_cast<int>(d[10]), static_cast<int>(d[8]), static_cast<int>(d[11]),
        static_cast<int>(d[9]), mean_scale, static_cast<int>(d[13]), static_cast<int>(d[14]),
        static_cast<int>(d[15]), d[17], static_cast<int>(d[16]), static_cast<int>(d[19]),
        stream);
    if (err != 0) return err;
  }
  return 0;
}

int cuembed_csr_forward(const void* table, const void* indices, const void* offsets,
                        const void* weights, void* out, int64_t num_rows, int64_t batch,
                        int64_t capacity, int64_t width, int dtype, int index_bytes,
                        int offset_bytes, int low_precision_math, int vec_bytes, int mean,
                        int lanes, int slabs, int64_t items_per_block, int threads,
                        int smem_bytes, void* stream) {
  cuembed::Launch l = {};
  l.a = {table, indices, offsets, weights, out, num_rows, batch, 0, capacity, width,
         batch * slabs, items_per_block, lanes, slabs, mean, 1.f};
  l.csr = 1;
  l.offset_bytes = offset_bytes;
  l.threads = threads;
  l.smem_bytes = smem_bytes;
  l.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cuembed::by_dtype(dtype, index_bytes, weights != nullptr,
                                            low_precision_math, vec_bytes, l));
}

// The shape of such a launch, without launching: shape[0] registers a
// thread, shape[1] local (spill) bytes a thread, shape[2] shared memory
// bytes a block (static and dynamic), shape[3] resident blocks per SM on the
// current card. Returns a cudaError_t.
int cuembed_forward_shape(int csr, int dtype, int index_bytes, int offset_bytes, int has_w,
                          int low_precision_math, int vec_bytes, int lanes, int threads,
                          int smem_bytes, void* shape) {
  cuembed::Launch l = {};
  static const float kWeight = 0.f;
  l.a.weights = has_w ? &kWeight : nullptr;
  l.a.lanes = lanes;
  l.a.slabs = 1;
  l.a.items_per_block = 1;
  l.csr = csr;
  l.offset_bytes = offset_bytes;
  l.threads = threads;
  l.smem_bytes = smem_bytes;
  l.shape = static_cast<int64_t*>(shape);
  return static_cast<int>(cuembed::by_dtype(dtype, index_bytes, has_w != 0,
                                            low_precision_math, vec_bytes, l));
}

}  // extern "C"
