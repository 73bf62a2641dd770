// K3 SPARS SpGEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spars.py:27, _spars_kernel (the Pallas TPU
// kernel behind spars_spgemm), and :124, its vmapped form
// spars_spgemm_batched: the paper's Algorithm 3, lanes in lock-step, one
// product per lane per step.  Same operands as K2 plus steps [n_b /
// block_cols] (the trip count of each lane block); outputs acc and flags,
// both f32 [m, n_b] row-major, or [B, m, n_b] for B value sets of one
// pattern, every cell written.
//
// What bounds it on this card: bytes.  A step is one multiply and one add
// against an 8-byte A entry; the least time is the bytes the group must move
// (B entries, the A columns they reference, and the two dense tiles, written
// once) over the card's memory rate.  The first design transliterated the
// reference's skeleton: one thread a lane (C column), 128 lanes a CTA, each
// step a chain of dependent global loads (B entry, A column length, A entry)
// and a read-modify-write of acc in device memory, the tiles zero-filled by
// the wrapper first.  A group of 128 columns was one CTA on one of the 132
// SMs, and iprob's arrow lane walked its 9,000 steps one after another at
// about 0.28 us a step: 2.552 ms at iprob's largest SPARS group on the H100
// (NVIDIA H100 80GB HBM3, 700 W), 149 times torch.sparse.mm of the same
// columns.
//
// Design: SPARS adds each cell's products in the order SPA does, since a
// step's cell is its A row and a lane takes its steps in (B entry, A entry)
// order.  So K3 is K2's slice kernel (slice_kernel.cuh) instantiated with
// kLockStep: kCols columns x one slice of kThreads rows a CTA, a phase-mode
// and a list-mode CTA a (column group, slice), the lane's walk staged in
// chunks and rounds of independent loads.  The three differences from SPA
// (the header's note has them in full): an entry on an empty A column takes
// one step on that column's slot 0 (max(na, 1) products an entry); column c
// keeps only its first steps[c / block_cols] steps; and the flags tile marks
// each cell that took a product, only from the product's own row.
// __fmul_rn/__fadd_rn and one owner per cell keep the kernel bit for bit
// equal to the plain PyTorch version, and every cell of both tiles is stored
// once, so the wrapper allocates them with torch.empty.  On the H100
// (NVIDIA H100 80GB HBM3, 700 W) the group above takes 0.055 ms
// (chip_smoke.py; benchmarks/torch_spa_shapes.py --kernel spars), 46 times
// less, and K3-b at B = 8 0.200 ms (2.988 before).  Its time is K2's: the
// list-mode CTA of the arrow's slice, whose warp owning the arrow row adds
// that row's 3000 products one after another.
//
// Batch: blockIdx.y is the batch element; indices and trip counts are
// shared, so every element's slice equals the unbatched kernel bit for bit
// (the unbatched launch is batch = 1).

#include "slice_kernel.cuh"

extern "C" int repro_spars_launch(const void* a_rows, const void* a_vals,
                                  const void* a_nnz, int n_a, int za,
                                  const void* b_rows, const void* b_vals,
                                  const void* b_nnz, int n_b, int zb,
                                  const void* steps, int block_cols, int m,
                                  int batch, void* acc, void* flags,
                                  void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      slice_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(LockStepSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_b > 0 && m > 0 && batch > 0) {
    const int n_slices = (m + kThreads - 1) / kThreads;
    const dim3 grid(2 * n_slices * ((n_b + kCols - 1) / kCols), batch);
    slice_kernel<true><<<grid, kThreads, sizeof(LockStepSmem),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_nnz), n_a, za,
        static_cast<const int*>(b_rows), static_cast<const float*>(b_vals),
        static_cast<const int*>(b_nnz), n_b, zb,
        static_cast<const int*>(steps), block_cols, m, n_slices,
        static_cast<float*>(acc), static_cast<float*>(flags));
  }
  return static_cast<int>(cudaGetLastError());
}
