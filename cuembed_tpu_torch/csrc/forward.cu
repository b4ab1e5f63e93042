// Forward embedding-bag kernels for Hopper (sm_90a), with a plain C interface.
//
// K1 `fixed_forward_kernel` replaces the Pallas gather-reduce kernel
// cuembed_tpu/ops/pallas_forward.py::_make_fwd_kernel:
//     out[b] = sum_j c[b, j] * table[idx[b, j]]   (MEAN: x rounded 1/hotness after the sum)
// K2 `csr_forward_kernel` replaces the ragged CSR kernel
// cuembed_tpu/ops/pallas_forward.py::_make_csr_fwd_kernel:
//     out[s] = sum_{p in [off[s], off[s+1])} c[p] * table[idx[p]]   (MEAN: x rounded 1/h_s)
//
// Both are bound by device-memory bytes: each lookup reads one table row and
// does one add per element. What matters is how many row loads each warp keeps
// in flight, so threads run across the width with the widest vector load that
// the row stride and the pointers allow (16, 8 bytes or one element), and the
// loop over a sample's rows issues kUnroll independent row loads before it
// adds any of them. Rows are addressed in 64 bits: a 10M x 256 table holds
// more than 2^31 elements.
//
// The TPU kernels' DMA pipeline, SMEM scalar prefetch and carry across grid
// steps are not carried over. K2 gives each sample its own row of threads,
// which reads its own [off[s], off[s+1]) range, so nothing carries between
// blocks and every output row is written exactly once (a zero-hotness sample
// writes zeros: the output comes from torch.empty).
//
// Rounding follows the plain PyTorch version in ops/lookup_torch.py exactly:
// adds and products are taken one at a time in fp32 (__fadd_rn / __fmul_rn, no
// fused multiply-add), and under low-precision math every result is rounded to
// the storage type, as a storage-dtype sum in PyTorch or JAX rounds each add.

#include "common.cuh"

#include <cassert>
#include <cstdint>
#include <type_traits>

namespace cuembed {

constexpr int kUnroll = 8;     // row loads in flight per thread
constexpr int kTile = 2048;    // (index, weight) pairs staged per K1 block

// Round to the accumulation type: identity for fp32 accumulation, a round
// trip through the storage type under low-precision math. fp32 holds every
// fp16/bf16 sum and product of two such values before this one rounding
// (24 >= 2 * 11 + 2 bits), so the result is the correctly rounded half op.
template <typename T, bool LPM>
__device__ __forceinline__ float acc_round(float x) {
  if constexpr (LPM) {
    return to_float(from_float<T>(x));
  } else {
    return x;
  }
}

// acc += w * row, in the order and rounding of the plain version.
template <typename T, bool HAS_W, bool LPM, int N>
__device__ __forceinline__ void accumulate(float (&acc)[N], const float (&row)[N],
                                           float w) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = row[i];
    if constexpr (HAS_W) x = acc_round<T, LPM>(__fmul_rn(x, w));
    acc[i] = acc_round<T, LPM>(__fadd_rn(acc[i], x));
  }
}

template <typename OffT>
__device__ __forceinline__ int64_t load_offset(const void* offsets, int64_t i) {
  return static_cast<int64_t>(__ldg(static_cast<const OffT*>(offsets) + i));
}

// K1. Block: blockDim.x threads across the row's vectors, blockDim.y samples.
// The block's indices (and weights) are staged in shared memory, kTile pairs
// at a time, then each thread walks its sample's rows kUnroll at a time.
template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
__global__ void __launch_bounds__(kThreads)
    fixed_forward_kernel(const T* __restrict__ table,
                         const IdxT* __restrict__ indices,
                         const float* __restrict__ weights, T* __restrict__ out,
                         int64_t num_rows, int64_t batch, int64_t hotness,
                         int64_t width, float mean_scale, int has_scale) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  __shared__ int64_t s_idx[kTile];
  __shared__ float s_w[HAS_W ? kTile : 1];

  const int ty = blockDim.y;
  const int tile_h = kTile / ty;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * ty;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * ty;
  const int64_t sample = first + threadIdx.y;
  const int64_t nvec = width / N;

  for (int64_t c0 = 0; c0 < nvec; c0 += blockDim.x) {
    const int64_t col = c0 + threadIdx.x;
    const bool active = sample < batch && col < nvec;
    const T* base = table + col * N;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;

    for (int64_t h0 = 0; h0 < hotness; h0 += tile_h) {
      const int th = static_cast<int>(imin(tile_h, hotness - h0));
      __syncthreads();  // the previous tile has been read by every thread
      for (int e = tid; e < ty * th; e += nthreads) {
        const int r = e / th;
        const int j = e - r * th;
        const int64_t s = first + r;
        if (s < batch) {
          const int64_t src = s * hotness + h0 + j;
          const int64_t row = static_cast<int64_t>(indices[src]);
          assert(row >= 0 && row < num_rows);
          s_idx[r * tile_h + j] = row;
          if constexpr (HAS_W) s_w[r * tile_h + j] = acc_round<T, LPM>(weights[src]);
        }
      }
      __syncthreads();
      if (!active) continue;

      const int64_t* my_idx = s_idx + threadIdx.y * tile_h;
      const float* my_w = s_w + (HAS_W ? threadIdx.y * tile_h : 0);
      int j = 0;
      for (; j + kUnroll <= th; j += kUnroll) {
        typename V::Raw raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) raw[u] = V::load(base + my_idx[j + u] * width);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float v[N];
          V::unpack(raw[u], v);
          accumulate<T, HAS_W, LPM, N>(acc, v, HAS_W ? my_w[j + u] : 1.f);
        }
      }
      for (; j < th; ++j) {
        float v[N];
        V::unpack(V::load(base + my_idx[j] * width), v);
        accumulate<T, HAS_W, LPM, N>(acc, v, HAS_W ? my_w[j] : 1.f);
      }
    }
    if (active) {
      if (has_scale) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = acc_round<T, LPM>(__fmul_rn(acc[i], mean_scale));
      }
      V::store(out + sample * width + col * N, acc);
    }
  }
}

// K2. Block: blockDim.x threads across the row's vectors, one blockDim.y row
// of threads per sample. Positions at or past offsets[batch] (capacity
// padding) are never read.
template <typename T, typename IdxT, typename OffT, bool HAS_W, bool LPM, int BYTES>
__global__ void __launch_bounds__(kThreads)
    csr_forward_kernel(const T* __restrict__ table,
                       const IdxT* __restrict__ indices,
                       const void* __restrict__ offsets,
                       const float* __restrict__ weights, T* __restrict__ out,
                       int64_t num_rows, int64_t batch, int64_t capacity,
                       int64_t width, int mean) {
  using V = Vec<T, BYTES>;
  constexpr int N = V::N;
  const int64_t sample = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (sample >= batch) return;

  const int64_t live_end = imin(load_offset<OffT>(offsets, batch), capacity);
  const int64_t lo = load_offset<OffT>(offsets, sample);
  const int64_t hi = load_offset<OffT>(offsets, sample + 1);
  const int64_t start = imax(lo, 0);
  const int64_t end = imin(hi, live_end);
  float scale = 1.f;
  if (mean) {
    // Sum first, then x acc(1 / acc(h_s)); h_s = 0 gives a row of zeros.
    const float h = acc_round<T, LPM>(static_cast<float>(hi - lo));
    scale = hi == lo ? 0.f : acc_round<T, LPM>(__fdiv_rn(1.f, h));
  }

  const int64_t nvec = width / N;
  for (int64_t col = threadIdx.x; col < nvec; col += blockDim.x) {
    const T* base = table + col * N;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    int64_t p = start;
    for (; p + kUnroll <= end; p += kUnroll) {
      int64_t row[kUnroll];
      typename V::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        row[u] = static_cast<int64_t>(__ldg(indices + p + u));
        assert(row[u] >= 0 && row[u] < num_rows);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = V::load(base + row[u] * width);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[N];
        V::unpack(raw[u], v);
        accumulate<T, HAS_W, LPM, N>(
            acc, v, HAS_W ? acc_round<T, LPM>(__ldg(weights + p + u)) : 1.f);
      }
    }
    for (; p < end; ++p) {
      const int64_t r = static_cast<int64_t>(__ldg(indices + p));
      assert(r >= 0 && r < num_rows);
      float v[N];
      V::unpack(V::load(base + r * width), v);
      accumulate<T, HAS_W, LPM, N>(acc, v,
                                   HAS_W ? acc_round<T, LPM>(__ldg(weights + p)) : 1.f);
    }
    if (mean) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = acc_round<T, LPM>(__fmul_rn(acc[i], scale));
    }
    V::store(out + sample * width + col * N, acc);
  }
}

struct FixedArgs {
  const void* table;
  const void* indices;
  const void* weights;
  void* out;
  int64_t num_rows, batch, hotness, width;
  float mean_scale;
  int has_scale;
  cudaStream_t stream;
};

struct CsrArgs {
  const void* table;
  const void* indices;
  const void* offsets;
  const void* weights;
  void* out;
  int64_t num_rows, batch, capacity, width;
  int offset_bytes, mean;
  cudaStream_t stream;
};

template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
cudaError_t launch_fixed(const FixedArgs& a) {
  const dim3 block = block_shape(a.width / Vec<T, BYTES>::N);
  dim3 grid;
  cudaError_t err = grid_of(a.batch, block, &grid);
  if (err != cudaSuccess) return err;
  fixed_forward_kernel<T, IdxT, HAS_W, LPM, BYTES><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.table), static_cast<const IdxT*>(a.indices),
      static_cast<const float*>(a.weights), static_cast<T*>(a.out), a.num_rows,
      a.batch, a.hotness, a.width, a.mean_scale, a.has_scale);
  return cudaGetLastError();
}

template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
cudaError_t launch_csr(const CsrArgs& a) {
  const dim3 block = block_shape(a.width / Vec<T, BYTES>::N);
  dim3 grid;
  cudaError_t err = grid_of(a.batch, block, &grid);
  if (err != cudaSuccess) return err;
  const auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, a.stream>>>(
        static_cast<const T*>(a.table), static_cast<const IdxT*>(a.indices), a.offsets,
        static_cast<const float*>(a.weights), static_cast<T*>(a.out), a.num_rows,
        a.batch, a.capacity, a.width, a.mean);
    return cudaGetLastError();
  };
  if (a.offset_bytes == 4)
    return launch(csr_forward_kernel<T, IdxT, int32_t, HAS_W, LPM, BYTES>);
  if (a.offset_bytes == 8)
    return launch(csr_forward_kernel<T, IdxT, int64_t, HAS_W, LPM, BYTES>);
  return cudaErrorInvalidValue;
}

// The by_* functions turn the run-time choices into template arguments, then
// call Launcher::run<T, IdxT, HAS_W, LPM, BYTES>(args).
template <typename T, typename IdxT, bool HAS_W, bool LPM, typename Launcher, typename Args>
cudaError_t by_vec(int vec_bytes, const Args& a) {
  switch (vec_bytes) {
    case 16:
      return Launcher::template run<T, IdxT, HAS_W, LPM, 16>(a);
    case 8:
      return Launcher::template run<T, IdxT, HAS_W, LPM, 8>(a);
    case static_cast<int>(sizeof(T)):
      return Launcher::template run<T, IdxT, HAS_W, LPM, static_cast<int>(sizeof(T))>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename IdxT, bool HAS_W, typename Launcher, typename Args>
cudaError_t by_lpm(int lpm, int vec_bytes, const Args& a) {
  if constexpr (std::is_same_v<T, float>) {
    // fp32 storage always accumulates in fp32.
    return by_vec<T, IdxT, HAS_W, false, Launcher>(vec_bytes, a);
  } else {
    return lpm ? by_vec<T, IdxT, HAS_W, true, Launcher>(vec_bytes, a)
               : by_vec<T, IdxT, HAS_W, false, Launcher>(vec_bytes, a);
  }
}

template <typename T, typename Launcher, typename Args>
cudaError_t by_index(int index_bytes, bool has_w, int lpm, int vec_bytes, const Args& a) {
  if (index_bytes == 4) {
    return has_w ? by_lpm<T, int32_t, true, Launcher>(lpm, vec_bytes, a)
                 : by_lpm<T, int32_t, false, Launcher>(lpm, vec_bytes, a);
  }
  if (index_bytes == 8) {
    return has_w ? by_lpm<T, int64_t, true, Launcher>(lpm, vec_bytes, a)
                 : by_lpm<T, int64_t, false, Launcher>(lpm, vec_bytes, a);
  }
  return cudaErrorInvalidValue;
}

template <typename Launcher, typename Args>
cudaError_t by_dtype(int dtype, int index_bytes, bool has_w, int lpm, int vec_bytes,
                     const Args& a) {
  switch (dtype) {
    case 0:
      return by_index<float, Launcher>(index_bytes, has_w, lpm, vec_bytes, a);
    case 1:
      return by_index<__half, Launcher>(index_bytes, has_w, lpm, vec_bytes, a);
    case 2:
      return by_index<__nv_bfloat16, Launcher>(index_bytes, has_w, lpm, vec_bytes, a);
    default:
      return cudaErrorInvalidValue;
  }
}

struct FixedLauncher {
  template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
  static cudaError_t run(const FixedArgs& a) {
    return launch_fixed<T, IdxT, HAS_W, LPM, BYTES>(a);
  }
};

struct CsrLauncher {
  template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>
  static cudaError_t run(const CsrArgs& a) {
    return launch_csr<T, IdxT, HAS_W, LPM, BYTES>(a);
  }
};

}  // namespace cuembed

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16. index_bytes / offset_bytes: 4 or 8.
// vec_bytes: 16, 8 or the element size; the row stride and the table and
// output pointers must be multiples of it. weights: fp32 or null.
// Returns the cudaError_t of the launch (0 on success).
int cuembed_fixed_forward(const void* table, const void* indices, const void* weights,
                          void* out, int64_t num_rows, int64_t batch, int64_t hotness,
                          int64_t width, int dtype, int index_bytes,
                          int low_precision_math, int vec_bytes, float mean_scale,
                          int has_scale, void* stream) {
  const cuembed::FixedArgs a{table,   indices, weights,    out,       num_rows,
                             batch,   hotness, width,      mean_scale, has_scale,
                             static_cast<cudaStream_t>(stream)};
  return static_cast<int>(cuembed::by_dtype<cuembed::FixedLauncher>(
      dtype, index_bytes, weights != nullptr, low_precision_math, vec_bytes, a));
}

int cuembed_csr_forward(const void* table, const void* indices, const void* offsets,
                        const void* weights, void* out, int64_t num_rows, int64_t batch,
                        int64_t capacity, int64_t width, int dtype, int index_bytes,
                        int offset_bytes, int low_precision_math, int vec_bytes,
                        int mean, void* stream) {
  const cuembed::CsrArgs a{table, indices,  offsets, weights,      out,
                           num_rows, batch, capacity, width,       offset_bytes,
                           mean,  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(cuembed::by_dtype<cuembed::CsrLauncher>(
      dtype, index_bytes, weights != nullptr, low_precision_math, vec_bytes, a));
}

}  // extern "C"
