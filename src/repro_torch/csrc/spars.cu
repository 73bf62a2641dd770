// K3 SPARS SpGEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spars.py, _spars_kernel (the Pallas TPU kernel
// behind spars_spgemm) and its vmapped form spars_spgemm_batched: the paper's
// Algorithm 3, lanes in lock-step, one product per lane per step.  Same
// operands as K2 plus steps [n_b / block_cols] (the trip count of each lane
// block); outputs acc and flags, both f32 [m, n_b] row-major, or [B, m, n_b]
// for B value sets of one pattern.
//
// What bounds it on this card: bytes.  A step is one multiply and one add
// against three dependent gathers (B entry, A column length, A entry) and a
// read-modify-write of one accumulator cell; the least time is the bytes the
// group must move (B entries, the A columns they reference, and the two dense
// tiles, written once) over the card's memory rate.
//
// Design: the paper's SPARS computes several C columns in parallel, one per
// vector lane, so here one thread owns one lane (C column).  Each thread runs
// steps[lane / block_cols] iterations of the cursor state machine of the
// reference (spars.py:42-68) exactly, on its private column of acc and flags:
// no two threads share a cell, so there are no atomics, and each cell takes
// its products in the reference's order.  __fmul_rn/__fadd_rn keep nvcc from
// fusing them into an FMA.  The reference's behaviour on a B entry that names
// an *empty* A column is kept: the step still runs, reads the padding slot
// a_rows[k, 0] = 0 with value 0, adds that ±0 product to acc[0, col] and sets
// flags[0, col] = 1.  A lane whose cursor passed its last B entry only idles
// in the reference, so the thread leaves its loop early.  Threads of a warp
// are neighbouring lanes, so their writes to one row of a tile fall in one
// segment.  Tiles live in device memory (the wrapper zeroes them); shared
// memory for the accumulators is later work.
//
// Batch: blockIdx.y is the batch element (vmap's leading grid axis on the
// TPU).  Element b reads a_vals + b*n_a*za and b_vals + b*n_b*zb and writes
// acc and flags + b*m*n_b (int64 offsets); indices and trip counts are
// shared, so every element walks the same cursors and its slice equals the
// unbatched kernel bit for bit (the unbatched launch is batch = 1).  A group
// is one CTA of 128 lanes, so the batch axis is what puts B CTAs in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void spars_kernel(const int* __restrict__ a_rows,
                             const float* __restrict__ a_vals,
                             const int* __restrict__ a_nnz, int n_a, int za,
                             const int* __restrict__ b_rows,
                             const float* __restrict__ b_vals,
                             const int* __restrict__ b_nnz, int n_b, int zb,
                             const int* __restrict__ steps, int block_cols,
                             int m, float* __restrict__ acc,
                             float* __restrict__ flags) {
  const int64_t elem = blockIdx.y;
  a_vals += elem * n_a * za;
  b_vals += elem * n_b * zb;
  acc += elem * m * n_b;
  flags += elem * m * n_b;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_b) return;
  const int n_steps = steps[lane / block_cols];
  const int nb = b_nnz[lane];
  const int64_t b_base = static_cast<int64_t>(lane) * zb;
  int vidx_b = 0;  // cursor into this lane's B column (vIndices_B)
  int vcnt_a = 0;  // cursor into the current A column (vCounter_A)
  for (int s = 0; s < n_steps && vidx_b < nb; ++s) {
    const int k = b_rows[b_base + vidx_b];
    const float bv = b_vals[b_base + vidx_b];
    const int na = a_nnz[k];
    const int64_t a_at = static_cast<int64_t>(k) * za + vcnt_a;
    const int64_t cell = static_cast<int64_t>(a_rows[a_at]) * n_b + lane;
    acc[cell] = __fadd_rn(acc[cell], __fmul_rn(a_vals[a_at], bv));
    flags[cell] = 1.0f;
    if (vcnt_a + 1 >= na) {  // last entry of A column k (or k is empty)
      vcnt_a = 0;
      ++vidx_b;
    } else {
      ++vcnt_a;
    }
  }
}

}  // namespace

extern "C" int repro_spars_launch(const void* a_rows, const void* a_vals,
                                  const void* a_nnz, int n_a, int za,
                                  const void* b_rows, const void* b_vals,
                                  const void* b_nnz, int n_b, int zb,
                                  const void* steps, int block_cols, int m,
                                  int batch, void* acc, void* flags,
                                  void* stream) {
  if (n_b > 0 && batch > 0) {
    const dim3 grid((n_b + kThreads - 1) / kThreads, batch);
    spars_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_nnz), n_a, za,
        static_cast<const int*>(b_rows), static_cast<const float*>(b_vals),
        static_cast<const int*>(b_nnz), n_b, zb,
        static_cast<const int*>(steps), block_cols, m,
        static_cast<float*>(acc), static_cast<float*>(flags));
  }
  return static_cast<int>(cudaGetLastError());
}
