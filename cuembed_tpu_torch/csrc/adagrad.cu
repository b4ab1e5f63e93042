// Row-wise AdaGrad's apply for Hopper (sm_90a), with a plain C interface.
//
// K4 applies one row-wise AdaGrad step from K3's compressed output, as it
// lies on the card, and reads the number of its rows there too:
//     for every rank r < min(*num_unique, cap) with 0 <= uniq[r] < num_rows:
//       u = uniq[r]
//       g2 = (sum over c of rows[r][c]^2) / width             fp32
//       a = accum[u] + g2;  accum[u] = a
//       s = -lr / sqrt(a + eps)                                IEEE, no fast math
//       table[u][c] = T(float(table[u][c]) + float(T(rows[r][c] * s)))
// Ranks at or past the count are never read, so K3's compressed buffers need
// no zeroing, and a rank whose index is out of range (the int32-max sentinel
// run of padding and zero coefficients, or a negative index) changes nothing.
// The uniq entries below the count are distinct: every row has one writer,
// there are no atomics, and two launches give the same bits. The host never
// learns the count, so the update needs no read back to the host.
//
// It replaces no Pallas kernel: the JAX package applies the step with XLA
// gathers and scatters (cuembed_tpu/train.py, apply_compressed), and the
// port did with a chain of torch index ops (index_select, mean, index_copy_,
// sqrt, divide, multiply, a cast and index_add_).
//
// What bounds it on this card: bytes. Each applied row reads its fp32
// gradient row, its table row, its index and its accumulator, and writes the
// table row and the accumulator: U * (width * (4 + 2 * sizeof(T)) + 8 +
// index bytes) for U rows, about 1.1 GB at the flagship's 0.57 M distinct
// 256-wide fp16 rows, 0.33 ms at 3.35 TB/s. The table rows are scattered,
// each 256-512 bytes, so what matters is how many such rows are in flight.
// The design:
//  1. One warp per row. Lane l holds the 16-byte vectors l, l + 32, ... of
//     the fp32 gradient row and the matching 4 elements of the table row, in
//     registers (rows of up to 512 columns; wider rows take a second pass
//     over the gradient row). Widths that are not a multiple of 4, or
//     misaligned rows, take one element a lane.
//  2. A warp keeps rows_in_flight() rows (4 at width 128, 2 at 256) in flight:
//     it issues every load of its group, gradient rows (streamed, evict
//     first) and table rows and accumulators, before the first shuffle
//     reduction; the next group's indices are loaded while this group sums.
//  3. A persistent grid of the blocks resident on the card strides over the
//     ranks: the host knows only the capacity, and a grid sized by it would
//     launch mostly idle blocks. Each block reads *num_unique once.
// The per-row sum of squares runs in lane order and then a butterfly of
// shuffles, which gives every lane the same bits.

#include "common.cuh"

#include <cstdint>

namespace cuembed {

constexpr int kApplyThreads = 256;
constexpr int kApplyWarps = kApplyThreads / 32;

struct ApplyArgs {
  const float* rows;          // [cap, width] fp32
  const void* uniq;           // [cap] of IdxT
  const int64_t* num_unique;  // 0-dim, on the device
  void* table;                // [num_rows, width] of T
  float* accum;               // [num_rows]
  int64_t cap, num_rows, width;
  float lr, eps;
};

// Rows a warp keeps in flight for CHUNKS register chunks of a row.
template <int CHUNKS>
__host__ __device__ constexpr int rows_in_flight() {
  return CHUNKS == 1 ? 4 : CHUNKS == 2 ? 2 : 1;
}

// VEC consecutive fp32 gradient elements: one 16-byte streaming load, or one
// element.
template <int VEC>
__device__ __forceinline__ void load_grad(const float* p, float (&g)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  } else {
    g[0] = __ldcs(p);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
  return s;
}

template <typename IdxT>
__device__ __forceinline__ int64_t row_at(const ApplyArgs& a, int64_t r, int64_t count) {
  if (r >= count) return -1;
  const int64_t id = static_cast<int64_t>(__ldg(static_cast<const IdxT*>(a.uniq) + r));
  return (id >= 0 && id < a.num_rows) ? id : -1;
}

// The accumulator and the row's scale; lane 0 stores the accumulator.
__device__ __forceinline__ float row_scale(const ApplyArgs& a, int64_t u, float old,
                                           float sum, int lane) {
  const float g2 = __fdiv_rn(sum, static_cast<float>(a.width));
  const float acc = __fadd_rn(old, g2);
  if (lane == 0) a.accum[u] = acc;
  return __fdiv_rn(-a.lr, __fsqrt_rn(__fadd_rn(acc, a.eps)));
}

template <typename T, int VEC>
__device__ __forceinline__ void update(T* trow, const float (&g)[VEC], const float (&t)[VEC],
                                       float s) {
  using V = Vec<T, VEC * static_cast<int>(sizeof(T))>;
  float o[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float upd = to_float(from_float<T>(__fmul_rn(g[i], s)));
    o[i] = __fadd_rn(t[i], upd);
  }
  V::store(trow, o);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_table(const T* trow, float (&t)[VEC]) {
  using V = Vec<T, VEC * static_cast<int>(sizeof(T))>;
  V::unpack(V::load_rw(trow), t);
}

// CHUNKS > 0: a row's CHUNKS * 32 * VEC columns in registers, rows_in_flight()
// rows a warp at a time. CHUNKS == 0: one row a warp, in two passes over the
// gradient row (any width).
template <typename T, typename IdxT, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kApplyThreads) rowwise_adagrad_apply_kernel(ApplyArgs a) {
  constexpr int R = rows_in_flight<CHUNKS>();
  constexpr int kSpan = 32 * VEC;  // columns a warp covers per chunk
  __shared__ int64_t s_count;
  if (threadIdx.x == 0) s_count = imax(0, imin(*a.num_unique, a.cap));
  __syncthreads();
  const int64_t count = s_count;
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kApplyWarps;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kApplyWarps + threadIdx.x / 32) * R;
  T* table = static_cast<T*>(a.table);

  int64_t u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) u[i] = row_at<IdxT>(a, first + i, count);

  for (int64_t r0 = first; r0 < count; r0 += warps * R) {
    const float* grow[R];
#pragma unroll
    for (int i = 0; i < R; ++i) grow[i] = a.rows + (r0 + i) * a.width;

    if constexpr (CHUNKS == 0) {
      // One row (R == 1), any width: sum its squares, then apply.
      float old = 0.f, sum = 0.f;
      if (u[0] >= 0) old = a.accum[u[0]];
      if (u[0] >= 0) {
        for (int64_t c = static_cast<int64_t>(lane) * VEC; c < a.width; c += kSpan) {
          float g[VEC];
          load_grad<VEC>(grow[0] + c, g);
#pragma unroll
          for (int k = 0; k < VEC; ++k) sum = __fadd_rn(sum, __fmul_rn(g[k], g[k]));
        }
      }
      const int64_t row = u[0];
      u[0] = row_at<IdxT>(a, r0 + warps * R, count);
      sum = warp_sum(sum);
      if (row >= 0) {
        const float s = row_scale(a, row, old, sum, lane);
        T* trow = table + row * a.width;
        for (int64_t c = static_cast<int64_t>(lane) * VEC; c < a.width; c += kSpan) {
          float g[VEC], t[VEC];
          load_grad<VEC>(grow[0] + c, g);
          load_table<T, VEC>(trow + c, t);
          update<T, VEC>(trow + c, g, t, s);
        }
      }
    } else {
      float g[R][CHUNKS][VEC], t[R][CHUNKS][VEC], old[R];
      // Every load of the group before the first reduction.
#pragma unroll
      for (int i = 0; i < R; ++i) {
        old[i] = u[i] >= 0 ? a.accum[u[i]] : 0.f;
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
          const int64_t c = static_cast<int64_t>(j) * kSpan + lane * VEC;
          if (u[i] >= 0 && c < a.width) {
            load_grad<VEC>(grow[i] + c, g[i][j]);
            load_table<T, VEC>(table + u[i] * a.width + c, t[i][j]);
          }
        }
      }
      int64_t row[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        row[i] = u[i];
        u[i] = row_at<IdxT>(a, r0 + warps * R + i, count);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
          const int64_t c = static_cast<int64_t>(j) * kSpan + lane * VEC;
          if (row[i] >= 0 && c < a.width) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) sum = __fadd_rn(sum, __fmul_rn(g[i][j][k], g[i][j][k]));
          }
        }
        sum = warp_sum(sum);
        if (row[i] < 0) continue;
        const float s = row_scale(a, row[i], old[i], sum, lane);
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
          const int64_t c = static_cast<int64_t>(j) * kSpan + lane * VEC;
          if (c < a.width) update<T, VEC>(table + row[i] * a.width + c, g[i][j], t[i][j], s);
        }
      }
    }
  }
}

// The register chunks for a width: the fewest of the compiled counts that
// hold the row, else 0 (two passes).
inline int apply_chunks(int64_t width, int vec) {
  const int64_t need = (width + 32 * vec - 1) / (32 * vec);
  if (need <= 1) return 1;
  if (vec != 4) return 0;
  return need <= 2 ? 2 : need <= 4 ? 4 : 0;
}

// Launch (shape == nullptr) or describe the launch: shape[0] threads a
// block, shape[1] resident blocks per SM, shape[2] rows a warp keeps in
// flight, shape[3] register chunks of a row (0: two passes).
template <typename T, typename IdxT, int VEC, int CHUNKS>
cudaError_t launch_apply(const ApplyArgs& a, cudaStream_t stream, int64_t* shape) {
  auto* kernel = rowwise_adagrad_apply_kernel<T, IdxT, VEC, CHUNKS>;
  constexpr int R = rows_in_flight<CHUNKS>();
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kApplyThreads, 0);
  if (err != cudaSuccess) return err;
  if (shape != nullptr) {
    shape[0] = kApplyThreads;
    shape[1] = per_sm;
    shape[2] = R;
    shape[3] = CHUNKS;
    return cudaSuccess;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t groups = (a.cap + R - 1) / R;
  const int64_t needed = (groups + kApplyWarps - 1) / kApplyWarps;
  const int64_t blocks = imax(1, imin(static_cast<int64_t>(sms) * imax(per_sm, 1), needed));
  kernel<<<static_cast<unsigned>(blocks), kApplyThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename IdxT, int VEC>
cudaError_t apply_by_chunks(const ApplyArgs& a, cudaStream_t stream, int64_t* shape) {
  switch (apply_chunks(a.width, VEC)) {
    case 1:
      return launch_apply<T, IdxT, VEC, 1>(a, stream, shape);
    case 2:
      if constexpr (VEC == 4) return launch_apply<T, IdxT, VEC, 2>(a, stream, shape);
      break;
    case 4:
      if constexpr (VEC == 4) return launch_apply<T, IdxT, VEC, 4>(a, stream, shape);
      break;
    default:
      return launch_apply<T, IdxT, VEC, 0>(a, stream, shape);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename IdxT>
cudaError_t apply_by_vec(int vec, const ApplyArgs& a, cudaStream_t stream, int64_t* shape) {
  if (vec == 4) return apply_by_chunks<T, IdxT, 4>(a, stream, shape);
  if (vec == 1) return apply_by_chunks<T, IdxT, 1>(a, stream, shape);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t apply_by_index(int index_bytes, int vec, const ApplyArgs& a, cudaStream_t stream,
                           int64_t* shape) {
  if (index_bytes == 4) return apply_by_vec<T, int32_t>(vec, a, stream, shape);
  if (index_bytes == 8) return apply_by_vec<T, int64_t>(vec, a, stream, shape);
  return cudaErrorInvalidValue;
}

inline cudaError_t apply_by_dtype(int dtype, int index_bytes, int vec, const ApplyArgs& a,
                                  cudaStream_t stream, int64_t* shape) {
  switch (dtype) {
    case 0:
      return apply_by_index<float>(index_bytes, vec, a, stream, shape);
    case 1:
      return apply_by_index<__half>(index_bytes, vec, a, stream, shape);
    case 2:
      return apply_by_index<__nv_bfloat16>(index_bytes, vec, a, stream, shape);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace cuembed

extern "C" {

// dtype (of the table): 0 fp32, 1 fp16, 2 bf16. index_bytes: 4 or 8 (uniq).
// vec: 4 where width is a multiple of 4, rows is 16-byte aligned and table
// 4-element aligned, else 1. rows [cap, width] fp32, uniq [cap], num_unique
// one int64 on the device, table [num_rows, width], accum [num_rows] fp32, all
// contiguous. cap >= 1. Returns the cudaError_t of the launch (0 on success).
int cuembed_rowwise_adagrad_apply(const void* rows, const void* uniq, const void* num_unique,
                                  void* table, void* accum, int64_t cap, int64_t num_rows,
                                  int64_t width, int dtype, int index_bytes, int vec, float lr,
                                  float eps, void* stream) {
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cuembed::ApplyArgs a;
  a.rows = static_cast<const float*>(rows);
  a.uniq = uniq;
  a.num_unique = static_cast<const int64_t*>(num_unique);
  a.table = table;
  a.accum = static_cast<float*>(accum);
  a.cap = cap;
  a.num_rows = num_rows;
  a.width = width;
  a.lr = lr;
  a.eps = eps;
  return static_cast<int>(cuembed::apply_by_dtype(dtype, index_bytes, vec, a,
                                                  static_cast<cudaStream_t>(stream), nullptr));
}

// The launch K4 takes for these arguments (as cuembed_rowwise_adagrad_apply's),
// without launching: shape[0] threads a block, shape[1] resident blocks per
// SM, shape[2] rows a warp keeps in flight, shape[3] register chunks of a row
// (0: two passes over the gradient row). Returns a cudaError_t.
int cuembed_rowwise_adagrad_apply_shape(int64_t width, int dtype, int index_bytes, int vec,
                                        void* shape) {
  cuembed::ApplyArgs a = {};
  a.width = width;
  return static_cast<int>(cuembed::apply_by_dtype(dtype, index_bytes, vec, a, nullptr,
                                                  static_cast<int64_t*>(shape)));
}

}  // extern "C"
