// K4 HASH SpGEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hash_spgemm.py, _hash_kernel (the Pallas TPU
// kernel behind hash_spgemm) and its vmapped form hash_spgemm_batched: the
// SPARS lock-step skeleton with a linear-probed hash table of h slots per
// lane (Section 3.2).  Same operands as K3; outputs keys (int32, -1 = empty)
// and vals (f32), both [h, n_b] row-major, slot for slot as the reference
// lays them out, or [B, h, n_b] for B value sets of one pattern.
//
// What a lane computes.  Lane j walks its steps in order: for each B entry
// (k, b) of column j, the rows r and values a of A's column k (one step with
// row a_rows[k, 0] and product +-0 when the column is empty), at most
// steps[j / block_cols] steps in all.  Step s probes from (r * HASH_C) mod h
// for the first slot that holds r or is empty (slot 0 when none is found,
// the reference's pos_final = 0), adds a*b to it and writes r there.  While
// the table has an empty slot no key is ever removed, so the table is the
// linear-probe insertion of the lane's distinct rows in order of first
// appearance, and each slot's sum is +0.0f plus its products in step order.
//
// What bounds it: neither bytes nor operations but the longest lane's chain
// of dependent steps.  The least time is the bytes the group must move (B
// entries, the A columns they name, both tables written once) over the
// memory rate, 5 us at iprob's largest group (390,252 products, h = 16384),
// whose longest lane takes 8998 steps: 3001 new rows, 3000 products on one
// row.  The first design (one thread a lane, a group's 128 lanes on one SM,
// the tables strided by n_b in device memory, three dependent gathers and a
// read-modify-write of device memory a step) took 4.0 ms there.
//
// Design: two warps a lane, its table on chip, the lanes over the card.
// - Tiers, by h alone (kernels/hash_spgemm.py::hash_layout chooses, and the
//   wrapper counts launches per tier).  "shared": while a lane's keys and
//   one set of values (8 h bytes, h <= 16384) fit beside its staging, the
//   table lives in dynamic shared memory, keys [h] and one vals [h] for each
//   of the CTA's `sets` value sets; a CTA holds `lanes` lanes (1, 2 or 4)
//   and `sets` sets (1 to 8) as fit 227 KB, so at h = 16384 a CTA is one
//   lane and a group's 128 lanes run on 128 SMs.  "global": the same code on
//   a workspace in device memory, each lane's table contiguous, one value
//   set a CTA.
// - A producer warp stages the lane's steps, in rounds of 32, into a ring
//   of kStages rounds in shared memory.  It loads 32 B entries at once
//   (row, values and the A column's length, prefetched two windows ahead),
//   turns the lengths into step offsets with a warp scan, and thread t of a
//   round finds the entry of its step from one ballot and one OR-reduction
//   of the entries' start offsets.  A's column is contiguous in [n_a, za],
//   so each thread gathers its row and A values with cp.async, kStages
//   rounds in flight; a round's mbarrier completes when its gathers and its
//   B values have landed, and the consumer's arrival on another frees the
//   stage.
// - The consumer warp commits a round of 32 consecutive steps at a time.
//   Each thread probes its row in the table; rows found are final.  A new
//   row's candidate is the first empty slot of its probe path; every earlier
//   slot of the path is taken and stays taken, so only a new row earlier in
//   the round with the same candidate and another row can change it.  A pass
//   groups the threads by candidate (each writes its index into the slot's
//   key and reads back one of the group's; five ballots on its bits give
//   the group), commits every new row up to the first thread whose group's
//   lowest thread has another row, and lets the rest probe on from their
//   candidates: the slots are exactly those of inserting one step after
//   another.  When the round's new rows could fill the table (or a row is
//   -1, the empty key), one thread takes the round's steps one by one, the
//   reference's probe and fallback to slot 0 included.
// - The sums: the threads that share a slot (grouped as above) leave their
//   products to the lowest of them, which adds them in step order to the
//   slot's running sum, four loaded at a time (+0.0f past the last, which
//   leaves a sum bit for bit as it is: it starts at +0.0f and a sum rounded
//   to nearest never becomes -0.0f).  __fadd_rn on __fmul_rn products: no
//   FMA, no atomics, so each slot equals the plain version's bit for bit.
// - Every slot is stored once: a thread block cluster holds kClusterLanes
//   adjacent lanes, and each of its CTAs stores a share of their slots
//   (tier "shared": read from the other CTAs' shared memory), the cluster's
//   lanes side by side, so the wrapper allocates the outputs with
//   torch.empty.  Clusters are taken lane-major, the value-set blocks of a
//   lane cluster side by side and the group's heaviest lanes (the planner
//   sorts a group's columns by work) first.
// What it costs (benchmarks/torch_hash_shapes.py on the H100, PERF.md): a
// round is a few shared-memory probes and three or four groupings of five
// ballots each, and the leader's serial adds (iprob's arrow row: about ten a
// round).  At iprob's largest group the consumer's rounds are the critical
// path, the sums about two fifths of them; the stores at the end a tenth.
//
// Batch: a CTA's `sets` value sets (blockIdx.y picks the block of them)
// share its slots, found once, and each set's table takes its products
// exactly as the unbatched launch (batch = 1) does: slice b equals it bit
// for bit, and every set's keys are the same.  Element offsets are int64.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kHashC = 0x1E3779B1u;  // HASH_C & 0x7FFFFFFF
constexpr int kEmpty = -1;
constexpr int kMinThreads = 256;          // threads a CTA, at least
constexpr int kMaxLanes = 4;              // lanes (two warps each) a CTA
constexpr int kMaxThreads = 64 * kMaxLanes;
constexpr int kMaxSmem = 232448;          // a block's dynamic shared memory
constexpr int kStages = 4;                // rounds in a lane's ring
constexpr int kClusterLanes = 8;          // lanes a cluster writes side by side

struct Operands {
  const int* a_rows;
  const float* a_vals;
  const int* a_nnz;
  int n_a, za;
  const int* b_rows;
  const float* b_vals;
  const int* b_nnz;
  int n_b, zb;
  const int* steps;
  int block_cols, h, batch, lanes;
  int* keys;
  float* vals;
  int* ws_keys;     // tier "global": [batch, n_b, h]
  float* ws_vals;   // tier "global": [batch, n_b, h]
};

// The warp's threads (`on`, `on_mask`) whose slot `pos` is this thread's:
// each writes its index into the slot's key, and the index read back (one
// of the threads that wrote it) names the group, whose five bits five
// ballots compare.  The caller writes the keys back.
__device__ __forceinline__ unsigned same_slot(int* keys, unsigned pos,
                                              bool on, unsigned on_mask,
                                              int t) {
  if (on) keys[pos] = t;
  __syncwarp();
  const int w = on ? keys[pos] : 0;
  unsigned group = on_mask;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const unsigned bits = __ballot_sync(kFull, on && (w >> b & 1));
    group &= (w >> b & 1) ? bits : ~bits;
  }
  return on ? group : 0u;
}

// One round: up to 32 consecutive steps of one lane, thread t holding step
// t (`active`) with row r, the A values a and the B values b of the CTA's
// value sets.  All 32 threads call it.  keys [h] and vals (set e at vals +
// e * vstride) are the lane's table; sprod [E][32] and srow [32] the warp's
// staging.
template <int E>
__device__ __forceinline__ void round_commit(int* keys, float* vals,
                                             int64_t vstride, int h, int ne,
                                             int& count, float* sprod,
                                             int* srow, int t, int r,
                                             const float (&a)[E],
                                             const float (&b)[E],
                                             bool active) {
  const unsigned mask = static_cast<unsigned>(h - 1);
  const unsigned lt = (1u << t) - 1u;
  const unsigned act = __ballot_sync(kFull, active);
#pragma unroll
  for (int e = 0; e < E; ++e) sprod[e * 32 + t] = __fmul_rn(a[e], b[e]);
  unsigned pos = 0;
  bool fresh = false;
  if (active) {
    pos = (static_cast<unsigned>(r) * kHashC) & mask;
    int n = 0;
    for (; n < h; ++n) {
      const int key = keys[pos];
      if (key == r) break;
      if (key == kEmpty) {
        fresh = true;
        break;
      }
      pos = (pos + 1) & mask;
    }
    fresh = fresh || n == h;
  }
  const unsigned news = __ballot_sync(kFull, fresh);
  if (count + __popc(news) > h ||
      __ballot_sync(kFull, active && r == kEmpty) != 0) {
    srow[t] = r;
    __syncwarp();
    if (t == 0) {
      for (unsigned m = act; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const int rr = srow[j];
        unsigned q = (static_cast<unsigned>(rr) * kHashC) & mask;
        unsigned slot = 0;
        for (int n = 0; n < h; ++n) {
          const int key = keys[q];
          if (key == rr || key == kEmpty) {
            slot = q;
            break;
          }
          q = (q + 1) & mask;
        }
        if (keys[slot] == kEmpty && rr != kEmpty) ++count;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e < ne)
            vals[e * vstride + slot] =
                __fadd_rn(vals[e * vstride + slot], sprod[e * 32 + j]);
        keys[slot] = rr;
      }
    }
    count = __shfl_sync(kFull, count, 0);
    __syncwarp();
    return;
  }
  // insert the round's new rows, in order of first appearance: a pass
  // commits every new row up to the first thread whose candidate an earlier
  // thread of another row holds (its group's lowest thread has another row)
  unsigned pending = news;
  while (pending) {
    const bool mine = pending >> t & 1u;
    const unsigned group = same_slot(keys, pos, mine, pending, t);
    const int lead = mine ? __ffs(group) - 1 : t;
    const int r_lead = __shfl_sync(kFull, r, lead);
    const unsigned clashes = __ballot_sync(kFull, mine && r != r_lead);
    const unsigned now =
        clashes ? pending & ((1u << (__ffs(clashes) - 1)) - 1u) : pending;
    const bool inserts = now >> lead & 1u;
    if (mine) keys[pos] = inserts ? r_lead : kEmpty;
    count += __popc(__ballot_sync(kFull, mine && inserts && lead == t));
    __syncwarp();
    bool later = false;
    if ((pending & ~now) >> t & 1u) {
      for (int n = 0; n < h; ++n) {
        const int key = keys[pos];
        if (key == r) break;
        if (key == kEmpty) {
          later = true;
          break;
        }
        pos = (pos + 1) & mask;
      }
    }
    pending = __ballot_sync(kFull, later);
  }
  // add the products, each slot's in step order by its lowest thread
  const unsigned peers = same_slot(keys, pos, active, act, t);
  if (active) {
    keys[pos] = r;
    if (!(peers & lt)) {
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = e < ne ? vals[e * vstride + pos] : 0.0f;
      // four products a pass, loaded together; past the last, +0.0f, which
      // leaves a sum bit for bit as it is (it starts at +0.0f and a sum
      // rounded to nearest never becomes -0.0f)
      for (unsigned m = peers; m;) {
        float x[4][E];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
#pragma unroll
          for (int e = 0; e < E; ++e)
            x[i][e] = j >= 0 ? sprod[e * 32 + j] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = __fadd_rn(v[e], x[i][e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < ne) vals[e * vstride + pos] = v[e];
    }
  }
  __syncwarp();
}

// A lane's shared-memory staging: the ring's barriers, a round's products
// (for the sums) and rows (for the serial path), and the ring of kStages
// rounds that the producer's cp.async gathers fill ahead of the commits.
template <int E>
struct WarpStage {
  unsigned long long full[kStages];   // a round's gathers and stores landed
  unsigned long long empty[kStages];  // the consumer took a round out
  float sprod[E][32];
  int srow[32];
  int rows[kStages][32];
  float a[kStages][E][32];
  float b[kStages][E][32];
  int count[kStages];  // the round's steps; 0: the lane has no more
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void gather4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(n)
               : "memory");
}

// an arrival, releasing this thread's earlier stores
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// an arrival once this thread's cp.async gathers so far have landed
__device__ __forceinline__ void bar_arrive_gathers(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the phase of parity `parity` to complete; a wait of 2^30 polls
// (seconds) means a broken count, and traps rather than hanging the card
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The producer warp of lane `lane`: its steps, in rounds of 32, into the
// ring, up to kStages rounds of gathers in flight; round n is in stage
// n % kStages, whose `full` barrier (32 gather arrivals and 32 plain ones)
// completes once the round's gathers and stores have landed; a round of 0
// steps ends the lane.
template <int E>
__device__ __forceinline__ void produce_lane(const Operands& o, int lane,
                                             int e0, int ne,
                                             WarpStage<E>& st, int t) {
  const int n_steps = o.steps[lane / o.block_cols];
  const int nb = o.b_nnz[lane];
  const int64_t b_base = static_cast<int64_t>(lane) * o.zb;
  const int64_t a_set = static_cast<int64_t>(o.n_a) * o.za;
  const int64_t b_set = static_cast<int64_t>(o.n_b) * o.zb;
  // B entry j: A column k and the value sets' b values (0 past the column)
  auto entry = [&](int j, int& k, float (&bv)[E]) {
    k = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) bv[e] = 0.0f;
    if (j < nb) {
      k = o.b_rows[b_base + j];
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < ne) bv[e] = o.b_vals[(e0 + e) * b_set + b_base + j];
    }
  };
  // windows of 32 B entries, thread t holding entry j0 + t: the current
  // one's A column, b values and step offsets; the next one's entries and
  // A column lengths and the one after's entries, loaded ahead
  int kw = 0, excl = 0;
  float bw[E];
  int k1, k2;
  float b1[E], b2[E];
  entry(t, k1, b1);
  entry(32 + t, k2, b2);
  int na1 = t < nb ? o.a_nnz[k1] : 0;
  int j0 = -32, done = 0, wsteps = 0, q = 0;
  auto next_window = [&]() -> bool {
    done += wsteps;
    j0 += 32;
    if (j0 >= nb || done >= n_steps) return false;
    kw = k1;
#pragma unroll
    for (int e = 0; e < E; ++e) bw[e] = b1[e];
    const int cnt = j0 + t < nb ? max(na1, 1) : 0;  // an empty column: 1
    k1 = k2;
#pragma unroll
    for (int e = 0; e < E; ++e) b1[e] = b2[e];
    na1 = j0 + 32 + t < nb ? o.a_nnz[k1] : 0;
    entry(j0 + 64 + t, k2, b2);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (t >= d) incl += v;
    }
    excl = incl - cnt;
    wsteps = min(__shfl_sync(kFull, incl, 31), n_steps - done);
    q = 0;
    return true;
  };
  bool live = next_window();
  for (int n = 0;; ++n) {
    const int s = n & (kStages - 1);
    if (n >= kStages) bar_wait(&st.empty[s], (n / kStages - 1) & 1);
    // the current window's next round: thread t takes step q + t, whose
    // entry is the last to start at or before it (the entries starting
    // before the round, and those starting at its steps 0..t in a mask of
    // start offsets), and gathers its row and A values, which lie in A's
    // column contiguously
    int cnt = 0;
    if (live) {
      cnt = min(32, wsteps - q);
      const unsigned starts = __reduce_or_sync(
          kFull, excl >= q && excl < q + 32 ? 1u << (excl - q) : 0u);
      const int at_e = __popc(__ballot_sync(kFull, excl < q)) +
                       __popc(starts & ((2u << t) - 1u)) - 1;
      const int ke = __shfl_sync(kFull, kw, at_e);
      const int i = q + t - __shfl_sync(kFull, excl, at_e);
      float bq[E];
#pragma unroll
      for (int e = 0; e < E; ++e) bq[e] = __shfl_sync(kFull, bw[e], at_e);
      if (t < cnt) {
        const int64_t at = static_cast<int64_t>(ke) * o.za + i;
        gather4(&st.rows[s][t], o.a_rows + at);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e < ne)
            gather4(&st.a[s][e][t], o.a_vals + (e0 + e) * a_set + at);
          st.b[s][e][t] = bq[e];
        }
      }
      q += cnt;
      if (q == wsteps) live = next_window();
    }
    if (t == 0) st.count[s] = cnt;
    bar_arrive_gathers(&st.full[s]);
    bar_arrive(&st.full[s]);
    if (cnt == 0) return;
  }
}

// The consumer warp of a lane: the ring's rounds, in order, into the table.
template <int E>
__device__ __forceinline__ void consume_lane(int h, int ne, int* keys,
                                             float* vals, int64_t vstride,
                                             WarpStage<E>& st, int t) {
  int count = 0;  // occupied slots
  for (int n = 0;; ++n) {
    const int s = n & (kStages - 1);
    bar_wait(&st.full[s], (n / kStages) & 1);
    const int cnt = st.count[s];
    const bool active = t < cnt;
    const int r = active ? st.rows[s][t] : 0;
    float a[E], b[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a[e] = active && e < ne ? st.a[s][e][t] : 0.0f;
      b[e] = active ? st.b[s][e][t] : 0.0f;
    }
    __syncwarp();
    if (t == 0) bar_arrive(&st.empty[s]);
    if (cnt == 0) return;
    round_commit<E>(keys, vals, vstride, h, ne, count, &st.sprod[0][0],
                    st.srow, t, r, a, b, active);
  }
}

template <int E, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads, 1)
    hash_kernel(const Operands o) {
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = o.h;
  const int lanes = o.lanes;
  // clusters are handed out along x first; taken in order, the value-set
  // blocks of one cluster of lanes run side by side, the heaviest lanes
  // (the planner sorts a group's columns by work) first
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int in_order = blockIdx.y * (gridDim.x / csize) + blockIdx.x / csize;
  const int lane0 = ((in_order / gridDim.y) * csize + crank) * lanes;
  const int set_block = in_order % gridDim.y;
  const int e0 = set_block * E;
  const int ne = min(E, o.batch - e0);
  const int n_here = max(0, min(lanes, o.n_b - lane0));
  // lane l's table (l counted from the CTA's first lane; in tier "shared",
  // `base` is the shared memory of the CTA that holds it): keys, and vals
  // of set e at vals + e * vstride
  const int64_t vstride = kGlobal ? 0 : h;
  // shared memory: the lanes' staging, then (tier "shared") their tables
  constexpr int kStageWords = sizeof(WarpStage<E>) / 4;
  auto keys_of = [&](int* base, int l) -> int* {
    if (kGlobal)
      return o.ws_keys +
             (static_cast<int64_t>(set_block) * o.n_b + lane0 + l) * h;
    return base + lanes * kStageWords + static_cast<int64_t>(l) * (1 + E) * h;
  };
  auto vals_of = [&](int* base, int l) -> float* {
    if (kGlobal)
      return o.ws_vals +
             (static_cast<int64_t>(set_block) * o.n_b + lane0 + l) * h;
    return reinterpret_cast<float*>(keys_of(base, l) + h);
  };
  auto* stage = reinterpret_cast<WarpStage<E>*>(smem);
  if (threadIdx.x < lanes * kStages) {
    WarpStage<E>& st = stage[threadIdx.x / kStages];
    bar_init(&st.full[threadIdx.x % kStages], 64);
    bar_init(&st.empty[threadIdx.x % kStages], 1);
  }
  for (int l = 0; l < n_here; ++l) {
    int* keys = keys_of(smem, l);
    float* vals = vals_of(smem, l);
    for (int s = threadIdx.x; s < h; s += blockDim.x) {
      keys[s] = kEmpty;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < ne) vals[e * vstride + s] = 0.0f;
    }
  }
  __syncthreads();
  // warp w < lanes commits lane w's rounds, warp lanes + w produces them
  const int warp = threadIdx.x >> 5;
  if (warp < n_here)
    consume_lane<E>(h, ne, keys_of(smem, warp), vals_of(smem, warp), vstride,
                    stage[warp], threadIdx.x & 31);
  else if (warp >= lanes && warp - lanes < n_here)
    produce_lane<E>(o, lane0 + warp - lanes, e0, ne, stage[warp - lanes],
                    threadIdx.x & 31);
  // the cluster's tables are complete: each CTA stores a share of their
  // slots, every lane of the cluster side by side
  cluster.sync();
  const int c_lane0 = lane0 - crank * lanes;
  const int c_lanes = max(0, min(csize * lanes, o.n_b - c_lane0));
  const int64_t out_set = static_cast<int64_t>(h) * o.n_b;
  // four cells a thread a pass, their reads of the cluster's tables in
  // flight together
  const int stride = csize * blockDim.x;
  for (int i0 = crank * blockDim.x + threadIdx.x; i0 < c_lanes * h;
       i0 += 4 * stride) {
    int key[4];
    float val[4][E];
    int64_t at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * stride;
      at[u] = -1;
      if (i < c_lanes * h) {
        const int s = i / c_lanes;
        const int l = i - s * c_lanes;  // the cluster's lane
        const int owner = l / lanes;    // the CTA that holds it
        int* base = kGlobal ? smem : cluster.map_shared_rank(smem, owner);
        const int ll = kGlobal ? l : l - owner * lanes;
        key[u] = keys_of(base, ll)[s];
        const float* v = vals_of(base, ll);
#pragma unroll
        for (int e = 0; e < E; ++e)
          val[u][e] = e < ne ? v[e * vstride + s] : 0.0f;
        at[u] = static_cast<int64_t>(s) * o.n_b + c_lane0 + l;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e < ne) {
          o.keys[(e0 + e) * out_set + at[u]] = key[u];
          o.vals[(e0 + e) * out_set + at[u]] = val[u][e];
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while another reads its tables
}

template <int E, bool kGlobal>
int launch(const Operands& o, int sets, cudaStream_t stream) {
  int64_t words = static_cast<int64_t>(o.lanes) * sizeof(WarpStage<E>) / 4;
  if (!kGlobal) words += static_cast<int64_t>(o.lanes) * (1 + sets) * o.h;
  const int64_t bytes = 4 * words;
  if (bytes > kMaxSmem || static_cast<int64_t>(o.h) * kClusterLanes > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      hash_kernel<E, kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned n_ctas = (o.n_b + o.lanes - 1) / o.lanes;
  // a cluster of CTAs holds kClusterLanes lanes (tier "shared" only)
  unsigned csize = 1;
  while (!kGlobal && csize * 2 * o.lanes <= kClusterLanes &&
         n_ctas % (csize * 2) == 0)
    csize *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas, (o.batch + sets - 1) / sets);
  cfg.blockDim =
      dim3(64 * o.lanes > kMinThreads ? 64 * o.lanes : kMinThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = csize;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, hash_kernel<E, kGlobal>, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tier 0 ("shared"): sets 1, 2, 4 or 8; tier 1 ("global"): sets 1 and the
// workspaces ws_keys / ws_vals [batch, n_b, h]
extern "C" int repro_hash_launch(const void* a_rows, const void* a_vals,
                                 const void* a_nnz, int n_a, int za,
                                 const void* b_rows, const void* b_vals,
                                 const void* b_nnz, int n_b, int zb,
                                 const void* steps, int block_cols, int h,
                                 int batch, int tier, int lanes, int sets,
                                 void* keys, void* vals, void* ws_keys,
                                 void* ws_vals, void* stream) {
  if (h < 1 || (h & (h - 1)) || lanes < 1 || lanes > kMaxLanes ||
      block_cols < 1 || !(tier == 0 || (tier == 1 && sets == 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_b <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  const Operands o{static_cast<const int*>(a_rows),
                   static_cast<const float*>(a_vals),
                   static_cast<const int*>(a_nnz),
                   n_a,
                   za,
                   static_cast<const int*>(b_rows),
                   static_cast<const float*>(b_vals),
                   static_cast<const int*>(b_nnz),
                   n_b,
                   zb,
                   static_cast<const int*>(steps),
                   block_cols,
                   h,
                   batch,
                   lanes,
                   static_cast<int*>(keys),
                   static_cast<float*>(vals),
                   static_cast<int*>(ws_keys),
                   static_cast<float*>(ws_vals)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (tier == 1) return launch<1, true>(o, 1, s);
  switch (sets) {
    case 1:
      return launch<1, false>(o, 1, s);
    case 2:
      return launch<2, false>(o, 2, s);
    case 4:
      return launch<4, false>(o, 4, s);
    case 8:
      return launch<8, false>(o, 8, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
