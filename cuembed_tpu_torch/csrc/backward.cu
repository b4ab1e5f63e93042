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
// Compressed mode writes run r's sum to rows[r] and its index to uniq[r],
// for every run of the live prefix, out-of-range ones included (the
// contract of lookup_xla._compressed_scatter); run_count_kernel and
// run_scan_kernel give each chunk the rank of its first run, and the total.
//
// The TPU kernel walks the grid in order and carries the open run from block
// to block in scratch. On Hopper blocks run in no order, so nothing carries:
// the live prefix is cut into fixed chunks of positions and one row of
// threads sums each chunk's runs (coo_backward_kernel). A run wholly inside a
// chunk is written directly. A run that crosses a chunk edge leaves an fp32
// partial per chunk: the chunk where the run starts keeps its piece in
// `tail`, each later chunk its piece in `head`. coo_backward_fixup_kernel
// then adds, for each such run, the pieces in chunk order and writes the row
// once. No atomics: every output row has one writer, and two launches on the
// same inputs give the same bits. A run of 65,530 positions (the flagship
// batch's longest) is spread over 256 chunks instead of one thread row.
//
// The kernel is bound by device-memory bytes: one grad_y row read per
// position, the sorted COO streams, and one read-modify-write per distinct
// output row. In the power-law tail most runs are one position long, so a
// thread mostly waits on row loads: on grad_y rows, and on each run's old
// output row before it writes the run. More warps in flight hide that wait
// better than more loads per thread, which cost registers: the main kernel
// is capped at 64 registers (four blocks per SM) and each thread issues
// kBwdUnroll grad_y row loads at a time, with the widest vector load the
// row stride and the pointers allow.

#include "common.cuh"

#include <cassert>
#include <cstdint>

namespace cuembed {

constexpr int kBwdUnroll = 4;  // grad_y row loads in flight per thread
constexpr int kBwdBlocksPerSM = 4;  // caps the main kernel at 64 registers

struct BwdArgs {
  const void* grad_y;       // [gy_rows, width] of T
  const void* t_idx;        // [>= live] of IdxT, sorted
  const int32_t* t_sid;     // [>= live]
  const float* coeff;       // [>= live] or null
  void* out;                // full: [num_rows, width]; compressed: [>= runs, width]
  void* uniq;               // compressed: [>= runs] of IdxT
  float* head;              // [num_chunks, width] partials of runs from earlier chunks
  float* tail;              // [num_chunks, width] partials of runs that go on
  int64_t* ranks;           // compressed: [num_chunks] runs before each chunk
  int64_t* tail_rank;       // compressed: [num_chunks] rank of the chunk's tail run
  int64_t* num_unique;      // compressed: [1]
  int64_t num_rows, gy_rows, live, width, chunk, num_chunks;
  int compressed;
  cudaStream_t stream;
};

template <typename IdxT>
__device__ __forceinline__ IdxT index_at(const BwdArgs& a, int64_t p) {
  return __ldg(static_cast<const IdxT*>(a.t_idx) + p);
}

// Chunk c covers positions [*cs, *ce) of the live prefix. left: its first
// run began in an earlier chunk; right: its last run goes on into the next.
template <typename IdxT>
__device__ __forceinline__ void chunk_edges(const BwdArgs& a, int64_t c, int64_t* cs,
                                            int64_t* ce, bool* left, bool* right) {
  *cs = c * a.chunk;
  *ce = imin(*cs + a.chunk, a.live);
  *left = *cs > 0 && index_at<IdxT>(a, *cs - 1) == index_at<IdxT>(a, *cs);
  *right = *ce < a.live && index_at<IdxT>(a, *ce) == index_at<IdxT>(a, *ce - 1);
}

// Compressed mode, pass 1: the number of runs that start in each chunk.
template <typename IdxT>
__global__ void __launch_bounds__(kThreads) run_count_kernel(BwdArgs a) {
  const int64_t c = blockIdx.x;
  const int64_t cs = c * a.chunk, ce = imin(cs + a.chunk, a.live);
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
// prefix sum in place, the number of runs before each chunk; the total is
// num_unique.
__global__ void __launch_bounds__(1024) run_scan_kernel(BwdArgs a) {
  __shared__ int64_t s[1024];
  const int t = threadIdx.x;
  const int64_t per = (a.num_chunks + blockDim.x - 1) / blockDim.x;
  const int64_t lo = imin(t * per, a.num_chunks), hi = imin(lo + per, a.num_chunks);
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

template <typename IdxT>
__device__ __forceinline__ bool in_range(const BwdArgs& a, IdxT row) {
  return row >= 0 && static_cast<int64_t>(row) < a.num_rows;
}

// Write a finished run's fp32 sum: full mode adds it to the row's old value
// (dropping out-of-range rows), compressed mode stores it at its rank.
template <typename T, typename IdxT, int BYTES>
__device__ __forceinline__ void write_run(const BwdArgs& a, IdxT row, int64_t rank,
                                          int64_t col,
                                          float (&acc)[Vec<T, BYTES>::N]) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  if (a.compressed) {
    V::store(static_cast<T*>(a.out) + rank * a.width + col * N, acc);
    if (col == 0) static_cast<IdxT*>(a.uniq)[rank] = row;
    return;
  }
  if (!in_range(a, row)) return;
  T* dst = static_cast<T*>(a.out) + static_cast<int64_t>(row) * a.width + col * N;
  float old[N];
  V::unpack(V::load_rw(dst), old);
#pragma unroll
  for (int i = 0; i < N; ++i) old[i] = __fadd_rn(old[i], acc[i]);
  V::store(dst, old);
}

// Pass 3. Block: blockDim.x threads across the row's vectors, one
// blockDim.y row of threads per chunk.
template <typename T, typename IdxT, bool HAS_W, int BYTES>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM) coo_backward_kernel(BwdArgs a) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (c >= a.num_chunks) return;
  int64_t cs, ce;
  bool left, right;
  chunk_edges<IdxT>(a, c, &cs, &ce, &left, &right);
  const T* gy = static_cast<const T*>(a.grad_y);
  const int64_t nvec = a.width / N;
  const int64_t first_rank = a.compressed ? a.ranks[c] - (left ? 1 : 0) : 0;

  for (int64_t col = threadIdx.x; col < nvec; col += blockDim.x) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    IdxT cur = index_at<IdxT>(a, cs);
    int64_t seg = cs, rank = first_rank;

    // The run [seg, end) of index `cur` is complete.
    const auto flush = [&](int64_t end) {
      float* part = nullptr;
      if (seg == cs && left) {
        part = a.head;
      } else if (end == ce && right) {
        part = a.tail;
        if (a.compressed && col == 0) {
          a.tail_rank[c] = rank;
          static_cast<IdxT*>(a.uniq)[rank] = cur;
        }
      }
      if (part != nullptr) {
#pragma unroll
        for (int i = 0; i < N; ++i) part[c * a.width + col * N + i] = acc[i];
      } else {
        write_run<T, IdxT, BYTES>(a, cur, rank, col, acc);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = 0.f;
    };

    for (int64_t p0 = cs; p0 < ce; p0 += kBwdUnroll) {
      const int n = static_cast<int>(imin(kBwdUnroll, ce - p0));
      IdxT ids[kBwdUnroll];
      float w[kBwdUnroll];
      typename V::Raw raw[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (u < n) {
          ids[u] = index_at<IdxT>(a, p0 + u);
          w[u] = HAS_W ? __ldg(a.coeff + p0 + u) : 1.f;
          // Full mode never reads the rows of a run it drops.
          raw[u] = typename V::Raw{};
          if (a.compressed || in_range(a, ids[u])) {
            const int64_t s = __ldg(a.t_sid + p0 + u);
            assert(s >= 0 && s < a.gy_rows);
            raw[u] = V::load(gy + s * a.width + col * N);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (u < n) {
          if (ids[u] != cur) {
            flush(p0 + u);
            cur = ids[u];
            seg = p0 + u;
            ++rank;
          }
          float v[N];
          V::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            acc[i] = __fadd_rn(acc[i], HAS_W ? __fmul_rn(v[i], w[u]) : v[i]);
          }
        }
      }
    }
    flush(ce);
  }
}

// Pass 4. For each run that crosses a chunk edge, the chunk where it starts
// adds its own piece and then each later chunk's head piece, in chunk order,
// and writes the row once.
template <typename T, typename IdxT, int BYTES>
__global__ void __launch_bounds__(kThreads) coo_backward_fixup_kernel(BwdArgs a) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (c >= a.num_chunks) return;
  int64_t cs, ce;
  bool left, right;
  chunk_edges<IdxT>(a, c, &cs, &ce, &left, &right);
  const IdxT row = index_at<IdxT>(a, ce - 1);
  // Only the chunk where a crossing run starts owns it.
  if (!right || (left && index_at<IdxT>(a, cs) == row)) return;
  if (!a.compressed && !in_range(a, row)) return;
  const int64_t rank = a.compressed ? a.tail_rank[c] : 0;
  const int64_t nvec = a.width / N;
  for (int64_t col = threadIdx.x; col < nvec; col += blockDim.x) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = a.tail[c * a.width + col * N + i];
    for (int64_t k = c + 1; k < a.num_chunks; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = __fadd_rn(acc[i], a.head[k * a.width + col * N + i]);
      }
      // The run goes on past chunk k only if it also ends chunk k and the
      // next chunk begins with it.
      const int64_t ke = imin((k + 1) * a.chunk, a.live);
      if (!(ke < a.live && index_at<IdxT>(a, ke) == row)) break;
    }
    write_run<T, IdxT, BYTES>(a, row, rank, col, acc);
  }
}

template <typename T, typename IdxT, bool HAS_W, int BYTES>
cudaError_t launch_backward(const BwdArgs& a) {
  if (a.compressed) {
    run_count_kernel<IdxT><<<static_cast<unsigned>(a.num_chunks), kThreads, 0, a.stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    run_scan_kernel<<<1, 1024, 0, a.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 block = block_shape(a.width / Vec<T, BYTES>::N);
  dim3 grid;
  cudaError_t err = grid_of(a.num_chunks, block, &grid);
  if (err != cudaSuccess) return err;
  coo_backward_kernel<T, IdxT, HAS_W, BYTES><<<grid, block, 0, a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  coo_backward_fixup_kernel<T, IdxT, BYTES><<<grid, block, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename IdxT, bool HAS_W>
cudaError_t backward_by_vec(int vec_bytes, const BwdArgs& a) {
  switch (vec_bytes) {
    case 16:
      return launch_backward<T, IdxT, HAS_W, 16>(a);
    case 8:
      return launch_backward<T, IdxT, HAS_W, 8>(a);
    case static_cast<int>(sizeof(T)):
      return launch_backward<T, IdxT, HAS_W, static_cast<int>(sizeof(T))>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward_by_index(int index_bytes, bool has_w, int vec_bytes, const BwdArgs& a) {
  if (index_bytes == 4) {
    return has_w ? backward_by_vec<T, int32_t, true>(vec_bytes, a)
                 : backward_by_vec<T, int32_t, false>(vec_bytes, a);
  }
  if (index_bytes == 8) {
    return has_w ? backward_by_vec<T, int64_t, true>(vec_bytes, a)
                 : backward_by_vec<T, int64_t, false>(vec_bytes, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace cuembed

extern "C" {

// dtype (of grad_y and the output): 0 fp32, 1 fp16, 2 bf16. index_bytes: 4
// or 8 (t_idx, and uniq in compressed mode); t_sid is int32; coeff is fp32 or
// null. vec_bytes: 16, 8 or the element size; the row stride and the grad_y
// and output pointers must be multiples of it. head and tail hold
// num_chunks * width floats, ranks and tail_rank num_chunks int64 (compressed
// mode only, else null). live >= 1. Returns the cudaError_t of the launches
// (0 on success).
int cuembed_coo_backward(const void* grad_y, const void* t_idx, const void* t_sid,
                         const void* coeff, void* out, void* uniq, void* head, void* tail,
                         void* ranks, void* tail_rank, void* num_unique, int64_t num_rows,
                         int64_t gy_rows, int64_t live, int64_t width, int64_t chunk,
                         int dtype, int index_bytes, int vec_bytes, int compressed,
                         void* stream) {
  if (live < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  a.chunk = chunk;
  a.num_chunks = (live + chunk - 1) / chunk;
  if (a.num_chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.compressed = compressed;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool has_w = coeff != nullptr;
  switch (dtype) {
    case 0:
      return static_cast<int>(cuembed::backward_by_index<float>(index_bytes, has_w, vec_bytes, a));
    case 1:
      return static_cast<int>(cuembed::backward_by_index<__half>(index_bytes, has_w, vec_bytes, a));
    case 2:
      return static_cast<int>(
          cuembed::backward_by_index<__nv_bfloat16>(index_bytes, has_w, vec_bytes, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
