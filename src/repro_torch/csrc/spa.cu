// K2 SPA SpGEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spa.py, _spa_kernel (the Pallas TPU kernel behind
// spa_spgemm) and its vmapped form spa_spgemm_batched.  Same operands (padded
// columns: rows/vals [n, Z] and nnz [n] for A and for one group of B columns),
// same output: the dense accumulator tile out [m, n_b], f32, row-major.  The
// batched form takes B value sets of one pattern, vals [B, n, Z], and writes
// out [B, m, n_b].
//
// What bounds it on this card: bytes.  Each product is one multiply and one
// add against an 8-byte A entry read and a 4-byte read-modify-write of an
// accumulator cell, so the arithmetic is negligible next to the memory
// traffic; the least time is the bytes the group must move (the B entries,
// the A columns they reference, and the dense tile, written once) over the
// card's memory rate.
//
// Design: the paper's SPA vectorizes over one A column, so one warp owns one
// C column.  The warp walks its column's B entries e < b_nnz[col] in order;
// for each, its 32 threads stride over the z < a_nnz[k] entries of A column k
// and each adds a_vals[k, z] * bv into out[a_rows[k, z], col].  Rows within
// one A column are distinct, so no two threads of a warp touch the same cell,
// and no other warp touches this column: no atomics.  A __syncwarp() between
// entries orders the read-modify-writes, so every cell takes its products
// with e ascending — the reference kernel's order — and __fmul_rn/__fadd_rn
// keep nvcc from contracting them into an FMA, so the result equals the
// plain PyTorch version bit for bit.  Reads of A are real gathers (the TPU
// kernel's one-hot matmuls stood in for them).  The tile lives in device
// memory; the wrapper zeroes it.  A CTA holds kWarpsPerBlock warps: 128
// warps (one per lane of the reference's 128-column block) would be 4096
// threads, above the 1024-thread limit, and 8 warps (256 threads) keep
// enough CTAs in flight to cover the latency of the dependent gathers.
// Shared-memory accumulators and asynchronous copies are later work.
//
// Batch: blockIdx.y is the batch element, as vmap makes the batch a leading
// grid axis on the TPU.  Element b reads a_vals + b*n_a*za and
// b_vals + b*n_b*zb and writes out + b*m*n_b (int64 offsets: at iprob the
// padded A operand alone holds 9.0M slots per element); the index operands
// are shared.  Each slice runs exactly the unbatched arithmetic, so batched
// equals looped bit for bit, and the unbatched launch is batch = 1.  The
// extra grid axis, not a loop inside a thread, multiplies the CTAs in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void spa_kernel(const int* __restrict__ a_rows,
                           const float* __restrict__ a_vals,
                           const int* __restrict__ a_nnz, int n_a, int za,
                           const int* __restrict__ b_rows,
                           const float* __restrict__ b_vals,
                           const int* __restrict__ b_nnz, int n_b, int zb,
                           int m, float* __restrict__ out) {
  const int64_t elem = blockIdx.y;
  a_vals += elem * n_a * za;
  b_vals += elem * n_b * zb;
  out += elem * m * n_b;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (col >= n_b) return;  // the whole warp shares col, so it exits together
  const int nb = b_nnz[col];
  const int64_t b_base = static_cast<int64_t>(col) * zb;
  for (int e = 0; e < nb; ++e) {
    const int k = b_rows[b_base + e];
    const float bv = b_vals[b_base + e];
    const int na = a_nnz[k];
    const int64_t a_base = static_cast<int64_t>(k) * za;
    for (int z = lane; z < na; z += 32) {
      float* cell = out + static_cast<int64_t>(a_rows[a_base + z]) * n_b + col;
      *cell = __fadd_rn(*cell, __fmul_rn(a_vals[a_base + z], bv));
    }
    __syncwarp();  // entry e's updates land before entry e + 1 reads a cell
  }
}

}  // namespace

extern "C" int repro_spa_launch(const void* a_rows, const void* a_vals,
                                const void* a_nnz, int n_a, int za,
                                const void* b_rows, const void* b_vals,
                                const void* b_nnz, int n_b, int zb, int m,
                                int batch, void* out, void* stream) {
  if (n_b > 0 && batch > 0) {
    const dim3 grid((n_b + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
    spa_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_nnz), n_a, za,
        static_cast<const int*>(b_rows), static_cast<const float*>(b_vals),
        static_cast<const int*>(b_nnz), n_b, zb, m, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
