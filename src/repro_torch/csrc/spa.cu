// K2 SPA SpGEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spa.py:28, _spa_kernel (the Pallas TPU kernel
// behind spa_spgemm), and :92, its vmapped form spa_spgemm_batched.  Same
// operands (padded columns: rows/vals [n, Z] and nnz [n] for A and for one
// group of B columns), same output: the dense accumulator tile out [m, n_b],
// f32, row-major, every cell written.  The batched form takes B value sets of
// one pattern, vals [B, n, Z], and writes out [B, m, n_b].
//
// What bounds it on this card: bytes.  Each product is one multiply and one
// add against an 8-byte A entry, so the least time is the bytes the group
// must move (the B entries, the A columns they name, the tile written once)
// over the card's memory rate.  The first design (one warp per C column, its
// lanes over one A column, the tile in device memory) was bound by neither:
// on the H100 it took 1.479 ms at iprob's largest SPA group, 3000 times its
// byte bound of 0.49 us, because one warp walked the arrow's dense column,
// 3000 B entries one after another, each a chain of dependent global loads
// and a global read-modify-write (0.49 us an entry), while 16 CTAs left
// most of the card idle.
//
// Design (slice_kernel.cuh, shared with K3 SPARS): the unit of work is
// kCols adjacent C columns x one slice of kThreads rows, so a long column is
// split over m / kThreads slices and every cell of the slice has one owner;
// a column with at most kPhaseEntries B entries adds its products in shared
// memory phase by phase, a longer one gets a CTA of its own, in which each
// row's owner adds them in a register (the header's note has the whole
// design).  Every cell takes its products starting from 0.0f with e
// ascending, the reference's order, and __fmul_rn/__fadd_rn keep nvcc from
// contracting them into an FMA: the result equals the plain PyTorch version
// bit for bit.  Every cell is stored once, so the wrapper allocates the
// output with torch.empty.  On the H100 the group above takes 0.046 ms
// (benchmarks/torch_spa_shapes.py): its time is the list-mode CTA of the
// arrow's slice, whose warp owning the arrow row adds that row's 3000
// products one after another, and the uncoalesced gathers of its filter
// rounds.  The constants were chosen with that script over the Table-1
// matrices.
//
// Batch: blockIdx.y is the batch element, as vmap makes the batch a leading
// grid axis on the TPU; each element runs exactly the unbatched arithmetic,
// so batched equals looped bit for bit, and the unbatched launch is
// batch = 1.

#include "slice_kernel.cuh"

extern "C" int repro_spa_launch(const void* a_rows, const void* a_vals,
                                const void* a_nnz, int n_a, int za,
                                const void* b_rows, const void* b_vals,
                                const void* b_nnz, int n_b, int zb, int m,
                                int batch, void* out, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      slice_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(Smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_b > 0 && m > 0 && batch > 0) {
    const int n_slices = (m + kThreads - 1) / kThreads;
    const dim3 grid(2 * n_slices * ((n_b + kCols - 1) / kCols), batch);
    slice_kernel<false><<<grid, kThreads, sizeof(Smem),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_nnz), n_a, za,
        static_cast<const int*>(b_rows), static_cast<const float*>(b_vals),
        static_cast<const int*>(b_nnz), n_b, zb, nullptr, 1, m, n_slices,
        static_cast<float*>(out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
