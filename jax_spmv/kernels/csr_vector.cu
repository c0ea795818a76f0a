// Vector CSR SpMV for Hopper (sm_90a), called from JAX through its foreign
// function interface (XLA FFI).  Built by jax_spmv/kernels/csr_vector.py.
//
// The design is the reference's vector CSR kernel (one warp per row, a
// __shfl_down_sync reduction, x read through the read-only cache) with the
// group width adapted to the matrix.  One launch has two kinds of block:
//
//   * the first n_long blocks each sum one long row (the list is built on
//     the host) with all their threads, so a hub row does not stall a
//     small lane group; they come first so the longest work starts first;
//   * every other block holds groups of TPR lanes (a power of two, at most
//     32, chosen from the mean row length); a group walks one row with
//     coalesced loads of values and column indices, then reduces with
//     warp shuffles.  Rows longer than `long_row` are skipped here.
//
// Every row of y is written by exactly one block.  The kernel is enqueued
// on XLA's stream; the handler neither synchronises nor allocates.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

__device__ void long_row_sum(int row, const int32_t* __restrict__ row_ptrs,
                             const int32_t* __restrict__ cols,
                             const float* __restrict__ vals,
                             const float* __restrict__ x,
                             float* __restrict__ y) {
  __shared__ float partial[32];
  const int start = __ldg(row_ptrs + row);
  const int end = __ldg(row_ptrs + row + 1);
  float sum = 0.0f;
  for (int j = start + threadIdx.x; j < end; j += blockDim.x) {
    sum += __ldg(vals + j) * __ldg(x + __ldg(cols + j));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) partial[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = (threadIdx.x < blockDim.x / 32) ? partial[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    }
    if (threadIdx.x == 0) y[row] = sum;
  }
}

template <int TPR>
__global__ void csr_vector_kernel(int num_rows, int n_long,
                                  const int32_t* __restrict__ long_rows,
                                  const int32_t* __restrict__ row_ptrs,
                                  const int32_t* __restrict__ cols,
                                  const float* __restrict__ vals,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, int long_row) {
  if (static_cast<int>(blockIdx.x) < n_long) {  // uniform across the block
    long_row_sum(long_rows[blockIdx.x], row_ptrs, cols, vals, x, y);
    return;
  }
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x - n_long) * blockDim.x + threadIdx.x;
  const int64_t row = gid / TPR;
  const int lane = static_cast<int>(gid % TPR);
  int start = 0;
  int end = 0;
  bool mine = false;
  if (row < num_rows) {
    start = __ldg(row_ptrs + row);
    end = __ldg(row_ptrs + row + 1);
    mine = end - start <= long_row;
    if (!mine) end = start;  // a long-row block writes this row
  }
  float sum = 0.0f;
  for (int j = start + lane; j < end; j += TPR) {
    sum += __ldg(vals + j) * __ldg(x + __ldg(cols + j));
  }
  // every lane of the warp reaches the shuffles: no early return above
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off, TPR);
  }
  if (lane == 0 && mine) y[row] = sum;
}

template <int TPR>
void launch(cudaStream_t stream, int num_rows, int n_long, int block_size,
            const int32_t* long_rows, const int32_t* row_ptrs,
            const int32_t* cols, const float* vals, const float* x,
            float* y, int long_row) {
  const int64_t threads = static_cast<int64_t>(num_rows) * TPR;
  const int64_t blocks = n_long + (threads + block_size - 1) / block_size;
  if (blocks == 0) return;
  csr_vector_kernel<TPR><<<static_cast<unsigned>(blocks), block_size, 0,
                           stream>>>(num_rows, n_long, long_rows, row_ptrs,
                                     cols, vals, x, y, long_row);
}

}  // namespace

ffi::Error CsrVectorImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> row_ptrs,
                         ffi::Buffer<ffi::S32> cols,
                         ffi::Buffer<ffi::F32> vals, ffi::Buffer<ffi::F32> x,
                         ffi::Buffer<ffi::S32> long_rows,
                         ffi::ResultBuffer<ffi::F32> y,
                         int32_t threads_per_row, int32_t long_row,
                         int32_t block_size) {
  // y holds the true rows; row_ptrs may be padded past them
  const int num_rows = static_cast<int>(y->element_count());
  if (row_ptrs.element_count() < static_cast<size_t>(num_rows) + 1) {
    return ffi::Error::InvalidArgument("row_ptrs needs rows + 1 entries");
  }
  if (block_size < 32 || block_size % 32 != 0 || block_size > 1024) {
    return ffi::Error::InvalidArgument("block_size: a multiple of 32, <= 1024");
  }
  const int n_long = static_cast<int>(long_rows.element_count());
  const int32_t* lr = long_rows.typed_data();
  const int32_t* rp = row_ptrs.typed_data();
  const int32_t* ci = cols.typed_data();
  const float* va = vals.typed_data();
  const float* xv = x.typed_data();
  float* yv = y->typed_data();
  switch (threads_per_row) {
    case 1: launch<1>(stream, num_rows, n_long, block_size, lr, rp, ci, va, xv, yv, long_row); break;
    case 2: launch<2>(stream, num_rows, n_long, block_size, lr, rp, ci, va, xv, yv, long_row); break;
    case 4: launch<4>(stream, num_rows, n_long, block_size, lr, rp, ci, va, xv, yv, long_row); break;
    case 8: launch<8>(stream, num_rows, n_long, block_size, lr, rp, ci, va, xv, yv, long_row); break;
    case 16: launch<16>(stream, num_rows, n_long, block_size, lr, rp, ci, va, xv, yv, long_row); break;
    case 32: launch<32>(stream, num_rows, n_long, block_size, lr, rp, ci, va, xv, yv, long_row); break;
    default:
      return ffi::Error::InvalidArgument("threads_per_row: 1, 2, 4, ..., 32");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(CsrVector, CsrVectorImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // row_ptrs
                                  .Arg<ffi::Buffer<ffi::S32>>()  // cols
                                  .Arg<ffi::Buffer<ffi::F32>>()  // vals
                                  .Arg<ffi::Buffer<ffi::F32>>()  // x
                                  .Arg<ffi::Buffer<ffi::S32>>()  // long_rows
                                  .Ret<ffi::Buffer<ffi::F32>>()  // y
                                  .Attr<int32_t>("threads_per_row")
                                  .Attr<int32_t>("long_row")
                                  .Attr<int32_t>("block_size"));
