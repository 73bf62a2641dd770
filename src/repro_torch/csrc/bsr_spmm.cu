// K5 padded-BSR x dense (SpMM) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bsr_spmm.py, _bsr_kernel (the Pallas TPU kernel
// behind bsr_spmm) and its vmapped form in src/repro/models/sparse_ffn.py
// (SparseMatmul.batched, K5-b).  Same operands: padded BSR weight
// block_idx [n_rb, max_nb] int32, block_nnz [n_rb] int32,
// blocks [n_rb, max_nb, bm, bk] f32, and dense activations x [K, N] f32; same
// output out [n_rb * bm, N] f32.  The batched form takes B activation sets
// x [B, K, N] against one weight and writes out [B, n_rb * bm, N].
//
// What bounds it on this card: operations.  Every kept block does
// 2 * bm * bk * N flops against bm * bk weights and bk * N activations read;
// at the sparse FFN's widths (K = 6144, N = 2048) that is hundreds of flops
// per byte of the operands, far above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte).  The least time is 2 * kept blocks *
// bm * bk * N flops over the f32 rate outside the tensor cores.
//
// Design: one CTA per (block-row i, 128-column tile, batch element), one
// thread per output column; a thread accumulates kRows rows of the block-row
// in registers (bm > kRows runs the block-row in chunks of kRows rows, bm not
// a multiple of kRows pads the last chunk with zero weights it never writes).
// The CTA walks the block-row's nb < block_nnz[i] kept blocks in order,
// staging up to kStage weights of them at a time in shared memory, transposed
// to [block][kk][row] so that a thread reads one kk's kRows weights as two
// 16-byte broadcasts; for each kk it reads its column of activation row
// block_idx[i, nb] * bk + kk (neighbouring threads, neighbouring addresses)
// and adds w * x into each row's sum.  Padded blocks (nb >= block_nnz[i]) are
// skipped, never multiplied by zero, and a block-row with no kept block
// writes zeros.  Every output element takes its products with nb ascending,
// then kk ascending, through __fmul_rn/__fadd_rn (no FMA contraction, no
// TF32, no atomics: one thread owns each output element), which is the plain
// PyTorch version's order, so the two agree bit for bit.  The grid walks the
// block-rows fastest, so the CTAs in flight share one column tile of x
// (K * 128 * 4 bytes, 3 MB at K = 6144), which stays in L2.  The cost of the
// exact order is that a multiply-add is two instructions instead of one FMA:
// at best half the f32 rate.  Tensor cores (wgmma) and a warp-level tile over
// several block-rows are later work.
//
// Batch: blockIdx.z is the batch element, as vmap makes the batch a leading
// grid axis on the TPU.  Element b reads x + b * K * N and writes
// out + b * n_rb * bm * N (int64 offsets); the weight is shared.  Each slice
// runs exactly the unbatched arithmetic, so batched equals looped bit for
// bit, and the unbatched launch is batch = 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;    // output columns of one CTA, one per thread
constexpr int kRows = 8;      // rows of the block-row a thread sums at once
constexpr int kStage = 2048;  // weights staged in shared memory at a time
constexpr int kMaxChunk = 64; // blocks staged at a time, at most

__global__ void __launch_bounds__(kCols)
bsr_kernel(const int* __restrict__ block_idx,
           const int* __restrict__ block_nnz,
           const float* __restrict__ blocks, int max_nb, int bm, int bk,
           const float* __restrict__ x, int k_dim, int n,
           float* __restrict__ out) {
  __shared__ __align__(16) float stage[kStage];  // [block][kk][kRows]
  __shared__ int stage_idx[kMaxChunk];
  const int64_t elem = blockIdx.z;
  const int64_t i = blockIdx.x;
  x += elem * k_dim * n;
  out += elem * gridDim.x * bm * n;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const bool live = col < n;
  const int nnz = block_nnz[i];
  const int chunk = min(kMaxChunk, kStage / (kRows * bk));
  for (int r0 = 0; r0 < bm; r0 += kRows) {
    const int rows = min(kRows, bm - r0);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int nb0 = 0; nb0 < nnz; nb0 += chunk) {
      const int nc = min(chunk, nnz - nb0);
      __syncthreads();  // the previous chunk is consumed before it is replaced
      for (int t = threadIdx.x; t < nc * bk * kRows; t += kCols) {
        const int r = t % kRows;
        const int kk = (t / kRows) % bk;
        const int c = t / (kRows * bk);
        stage[t] = r < rows
            ? blocks[((i * max_nb + nb0 + c) * bm + r0 + r) * bk + kk]
            : 0.0f;
      }
      for (int t = threadIdx.x; t < nc; t += kCols) {
        stage_idx[t] = block_idx[i * max_nb + nb0 + t];
      }
      __syncthreads();
      if (live) {
        for (int c = 0; c < nc; ++c) {
          const float* xc = x + static_cast<int64_t>(stage_idx[c]) * bk * n + col;
          const float4* w = reinterpret_cast<const float4*>(stage + c * bk * kRows);
#pragma unroll 4
          for (int kk = 0; kk < bk; ++kk) {
            const float xv = __ldg(xc + static_cast<int64_t>(kk) * n);
            const float4 lo = w[2 * kk];
            const float4 hi = w[2 * kk + 1];
            const float wr[kRows] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[r] = __fadd_rn(acc[r], __fmul_rn(wr[r], xv));
            }
          }
        }
      }
    }
    if (live) {
      for (int r = 0; r < rows; ++r) {
        out[(i * bm + r0 + r) * n + col] = acc[r];
      }
    }
  }
}

}  // namespace

extern "C" int repro_bsr_launch(const void* block_idx, const void* block_nnz,
                                const void* blocks, int n_rb, int max_nb,
                                int bm, int bk, const void* x, int k_dim,
                                int n, int batch, void* out, void* stream) {
  if (n_rb > 0 && n > 0 && batch > 0 && bm > 0) {
    const dim3 grid(n_rb, (n + kCols - 1) / kCols, batch);
    bsr_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(block_idx), static_cast<const int*>(block_nnz),
        static_cast<const float*>(blocks), max_nb, bm, bk,
        static_cast<const float*>(x), k_dim, n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
