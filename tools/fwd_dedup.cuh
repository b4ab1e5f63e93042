// K1 with each block's rows de-duplicated in shared memory: the `dedup`
// variant of tools/fwd_sweep.py, which pastes this file into
// cuembed_tpu_torch/csrc/forward.cu ahead of fixed_forward_kernel and makes
// that kernel call dedup_items. It is a design under test, not a kernel of
// the package.
//
// A block owns kDedupBags consecutive bags of a fixed batch (S bags of H
// positions, n = S * H):
// 1. its threads load the n indices, check each one's range, and insert it
//    into an open-addressing hash table in shared memory, counting lookups;
// 2. each distinct row looked up at least kDedupMin times gets a cache
//    entry, up to kDedupRows of them; the rest are read from the table;
// 3. then, one column slice of kDedupSliceBytes at a time, the block loads
//    each cached row's slice once (plain vector loads, kDedupUnroll in flight
//    a thread) into shared memory, and each thread sums one (bag, column
//    vector) pair over the bag's positions in order, from the cache or the
//    table. The adds, products and their order are those of combine_chunk,
//    so the sums keep their bits.
//
// Dynamic shared memory (tools/fwd_sweep.py::dedup_plan sizes it for the
// batch's hotness): pos int32[n], row int32[kDedupRows], then, 16-byte
// aligned, the hash table (key and count, int32[hs] each, hs the least power
// of two >= max(2n, 32)), which the row cache (kDedupRows x
// kDedupSliceBytes) overwrites once it is read. Row ids must be below 2^31.

constexpr int kDedupBags = 32;         // S, bags a block
constexpr int kDedupSliceBytes = 128;  // row bytes a pass caches
constexpr int kDedupRows = 1536;       // distinct rows a block caches
constexpr int kDedupMin = 1;           // lookups in the block a row needs to be cached
constexpr int kDedupUnroll = 4;        // row loads in flight a thread

template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
__device__ __forceinline__ void dedup_items(const FwdArgs& a) {
  using V = Vec<T, BYTES>;
  using A = Acc<T, LPM, BYTES>;
  using Raw = typename V::Raw;
  constexpr int N = V::N;
  constexpr int CL = kDedupSliceBytes / BYTES;  // column vectors a slice
  constexpr int U = kDedupUnroll;
  static_assert(CL >= 1 && (CL & (CL - 1)) == 0, "a slice holds a power of two of vectors");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int H = static_cast<int>(a.hotness);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * a.items_per_block;
  const int nb = static_cast<int>(imin(a.items_per_block, a.batch - b0));
  const int n = nb * H;
  const int nvec = static_cast<int>(a.width / N);
  const int64_t row_bytes = a.width * static_cast<int64_t>(sizeof(T));
  int hs = 32;
  while (hs < 2 * static_cast<int>(a.items_per_block) * H) hs <<= 1;
  const int shift = __clz(hs) + 1;  // the hash's top log2(hs) bits
  const int n_full = static_cast<int>(a.items_per_block) * H;
  const int64_t region = (4 * static_cast<int64_t>(n_full) + 4 * kDedupRows + 15) / 16 * 16;
  const int64_t need =
      region + imax(8 * static_cast<int64_t>(hs),
                    static_cast<int64_t>(kDedupRows) * kDedupSliceBytes);
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if (need > dyn || a.num_rows > 0x7fffffff) __trap();

  int* pos = reinterpret_cast<int*>(smem);
  int* row = pos + n_full;
  int* key = reinterpret_cast<int*>(smem + region);
  int* cnt = key + hs;
  Raw* cache = reinterpret_cast<Raw*>(smem + region);

  for (int s = tid; s < hs; s += blockDim.x) {
    key[s] = -1;
    cnt[s] = 0;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  // 1. Insert the block's ids.
  const IdxT* indices = static_cast<const IdxT*>(a.indices) + b0 * H;
  for (int p = tid; p < n; p += blockDim.x) {
    const int64_t id = static_cast<int64_t>(__ldg(indices + p));
    if (id < 0 || id >= a.num_rows) __trap();
    const int k = static_cast<int>(id);
    unsigned h = (static_cast<unsigned>(k) * 2654435761u) >> shift;
    for (;;) {
      const int prev = atomicCAS(&key[h], -1, k);
      if (prev == -1 || prev == k) break;
      h = (h + 1) & (hs - 1);
    }
    if constexpr (kDedupMin > 1) atomicAdd(&cnt[h], 1);
    pos[p] = static_cast<int>(h);
  }
  __syncthreads();

  // 2. Cache entries for the rows that earn one.
  for (int s = tid; s < hs; s += blockDim.x) {
    const int k = key[s];
    int c = -1;
    if (k != -1 && (kDedupMin <= 1 || cnt[s] >= kDedupMin)) {
      c = atomicAdd(&s_count, 1);
      if (c < kDedupRows) {
        row[c] = k;
      } else {
        c = -1;
      }
    }
    cnt[s] = c;
  }
  __syncthreads();
  // Each position: its cache entry, or ~row for a row read from the table.
  for (int p = tid; p < n; p += blockDim.x) {
    const int h = pos[p];
    pos[p] = cnt[h] >= 0 ? cnt[h] : ~key[h];
  }
  const int cached = min(s_count, kDedupRows);
  __syncthreads();

  const char* table = static_cast<const char*>(a.table);
  const float* weights = static_cast<const float*>(a.weights);
  for (int c0 = 0; c0 < nvec; c0 += CL) {
    // 3a. The cached rows' slice, each loaded once.
    const int fills = cached * CL;
#pragma unroll 1
    for (int e0 = tid; e0 < fills; e0 += blockDim.x * U) {
      Raw r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * blockDim.x;
        const int col = c0 + (e & (CL - 1));
        if (e < fills && col < nvec) {
          r[u] = V::load(reinterpret_cast<const T*>(
              table + static_cast<int64_t>(row[e / CL]) * row_bytes +
              static_cast<int64_t>(col) * BYTES));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < fills && c0 + (e & (CL - 1)) < nvec) cache[e] = r[u];
      }
    }
    __syncthreads();
    // 3b. Each (bag, column vector) pair sums its positions in order.
    for (int q = tid; q < nb * CL; q += blockDim.x) {
      const int s = q / CL, v = q & (CL - 1), col = c0 + v;
      if (col >= nvec) continue;
      const int* P = pos + s * H;
      const char* base = table + static_cast<int64_t>(col) * BYTES;
      const int64_t first = (b0 + s) * H;
      const auto load = [&](int j) {
        const int x = P[j];
        return x >= 0 ? cache[x * CL + v]
                      : V::load(reinterpret_cast<const T*>(base + static_cast<int64_t>(~x) *
                                                                      row_bytes));
      };
      const auto coeff = [&](int j) { return HAS_W ? A::coeff(weights[first + j]) : 0u; };
      A acc;
      Raw raw[U];
      int j = 0;
#pragma unroll 1
      for (; j + U <= H; j += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) raw[u] = load(j + u);
#pragma unroll
        for (int u = 0; u < U; ++u) acc.template add<HAS_W>(raw[u], coeff(j + u));
      }
      if (j < H) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < H) raw[u] = load(j + u);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < H) acc.template add<HAS_W>(raw[u], coeff(j + u));
        }
      }
      if (a.mean) acc.scale(A::coeff(a.mean_scale));
      acc.store(static_cast<T*>(a.out) + (b0 + s) * a.width + static_cast<int64_t>(col) * N);
    }
    __syncthreads();
  }
}
