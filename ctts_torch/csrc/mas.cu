// Monotonic alignment search (width-1 Viterbi over mel frames, then a
// backtrack to a {0, 1} alignment), for Hopper.
//
// Replaces the Pallas pair ctts_tpu/ops/mas.py:131 (_fwd_kernel) and :174
// (_bwd_kernel), launched by b_mas_pallas at :236 and :249. There the whole
// batch rides one sequential grid in frame chunks, the step to the left is a
// lane rotate and the backtrack carries a one-hot column vector, because the
// TPU has no dynamic lane index. None of that is needed here. Like the
// Pallas forward, the kernel takes the probabilities and computes their
// logarithm itself.
//
// What bounds it on the H100: not bytes (the probabilities below out_len
// read once and B*T_m*T_s {0, 1} floats written once: 11.6 MB at B=16,
// T_m=896, T_s=128 with the train lengths, about 3.5 us at 3.35 TB/s) but
// the chain of T_m dependent frames, and beside it the logarithms: T_m*T_s
// full-precision logf calls, each several times a chain step's work, more
// than the SM that carries a chain can issue at the chain's pace.
//
// Design: one launch, two kinds of block: n_log log blocks and B chain
// blocks, one an utterance. A block's kind comes from a ticket drawn as it
// starts, so every log block is running before any chain block waits.
// - The chain warp (warp 0 of a chain block) carries the chain with no
//   block-wide barrier in its frame loop. Lane L owns K adjacent columns,
//   [L*K, L*K + K), and runs kSkew steps behind lane L-1: at step s it works
//   on frame s - kSkew*L. Its lowest column's left neighbour is lane L-1's
//   highest column of the frame before, which one __shfl_up_sync a step
//   brings kSkew steps ahead of its use, off the chain. A step is compare ->
//   select -> add on K independent columns. An utterance takes mel_len +
//   kSkew*(ceil(text_len/K) - 1) steps, run in blocks of 32.
// - The chain warp reads a ring of step rows in shared memory: step row s
//   holds, for each lane L, frame s - kSkew*L of its columns, so a step is
//   one row, K floats a lane from one 16-byte word when K = 4. A row holds
//   logf(max(p, eps)), the wrapper's torch.log(torch.clamp(p, eps)) at full
//   precision (the file is built without fast-math). The chain block's
//   warps 2.. compute the first kFillChunks chunks of rows; the log blocks
//   compute the others into a device scratch in the same layout, chunk by
//   chunk across the batch, and flag each (the launch zeroes the flags
//   first); warp 1 of the chain block (the stager) copies flagged chunks
//   into free ring slots with cp.async. Each ring slot has a full and a
//   consumed mbarrier, all in the chain block, so the chain warp syncs at
//   block scope only. The log blocks wait for nothing. They also zero the
//   output slabs, which the chain block waits for before writing ones. (The
//   chain block's own warps cannot issue the logarithms at the chain's
//   pace: with them in the chain block in place of the log blocks, the
//   kernel took 1.7 times as long on the card.)
// Move bits ("came from the left column") never reach device memory. Lane L
// ORs its K columns' bits of a 32-step block into registers and stores them
// as one word a column (bit s % 32 of word s / 32 is the move of frame
// s - kSkew*L). At T_s = 128, T_m = 896 the words take 15 KB.
// After the chain, lane 0 of the chain warp backtracks by column, not by
// frame: from (i, c) the path stays in column c down to the highest frame f
// in [1, i] whose move bit is set and enters column c - 1 at frame f - 1;
// with no bit set it stays down to frame 0. Each step is one masked word
// and one more word for each 32 frames the run spans below it. The run
// starts are the durations' prefix. The block then writes one 1.0 per
// frame below mel_len from the runs, over the zeros.
//
// Move bits in device memory. The warp kernel holds an utterance's move
// bits beside its ring in one block's shared memory, which caps T_m (1442
// frames at T_s in (768, 1024], 10306 at T_s <= 128). Past that cap, at any
// T_m with T_s <= 1024, the same kernel runs with GBITS set: the chain warp
// stores each 32-step block's words to a [B, chain_rows/32, 32K] array of
// the scratch instead (the same words, by column, coalesced), and warp 0
// backtracks 32 frames a round from device memory: in a round that starts
// at frame i0 in column c the path can only be in columns c - 31 .. c, so
// lane j loads the two words of column c - j that hold frames i0 - 31 .. i0
// (shifted by the lane's skew), all 32 loads at once, and the warp walks
// the round's runs by shuffles (one masked count of leading zeros a run);
// each lane then writes its frame's 1.0. The log blocks zero the output
// as for the shared instance, off the chain, and nothing in the chain
// block waits on a block-wide barrier. The shared-memory instances (the
// train and VCTK shapes) compile as before: GBITS only adds code under
// `if constexpr`.
//
// Past 1024 columns, up to 1024*kWideMax, mas_wide_kernel spreads the
// chain over several chain warps (see its section below).
//
// The long route. Past those, mas_rows_kernel, a simpler design
// whose limits are device memory's: one block an utterance, a thread for
// each column (K = ceil(T_s/1024) columns a thread, c = tid + k*blockDim,
// so that a warp's columns are one word of move bits), the previous frame's
// row double-buffered in shared memory (8*T_s bytes; past what a block may
// hold, in a global scratch of the same layout) and one barrier a frame.
// Each frame reads its probabilities one frame ahead (the first kRowsAhead
// columns of a thread) and takes their logarithm as mas_log does. The move
// bits go to a global scratch [B, T_m, ceil(T_s/32)] of 32-bit words, one
// __ballot_sync a warp and a frame. The block zeroes each output row as it
// passes it; after the chain warp 0 backtracks 32 frames at a time: lane j
// loads the two words frame i0 - j can need (the column moves at most one
// a frame, so it stays in word w or w - 1 of the round's first), the warp
// walks the 32 frames by shuffles, and each lane writes its frame's 1.0.
// At T_m = 10307, T_s = 128 its chain is 10307 barriers; the warp kernel's
// skewed warp has none, which is why the train shape keeps it.
//
// Arithmetic: float32 adds and compares only, after the logarithm. The
// result is bit-identical to b_mas_plain whatever the schedule: sentinel
// -1e30 (not -inf) for columns at or past text_len, row 0 reachable only at
// column 0, and `left >= here` with the tie going to the diagonal; mel_len
// and text_len are clamped to [0, T_m] and [0, T_s]. Columns at or past
// text_len and frames at or past mel_len may hold anything in the kernel:
// a column feeds only the columns to its right, and the backtrack reads no
// move past mel_len - 1 and no column past text_len - 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarp = 32;            // lanes of the chain warp; bits a word
constexpr int kSkew = 2;             // steps lane L runs behind lane L-1
// blocks of 32 steps in which a lane meets its frame 0 (at step kSkew*L)
constexpr int kFirstBlocks = kSkew * (kWarp - 1) / kWarp + 1;
constexpr int kMaxShared = 232448;   // bytes one block may use on sm_90
constexpr int kRowsThreads = 1024;   // the long route's most threads a block
constexpr int kRowsAhead = 8;        // its columns a thread read ahead
// The wide kernel (T_s > 1024): chain warps of 1024 columns (K = 32), warp
// w kWarpGap steps behind lane 31 of warp w-1 past the lanes' skew, at most
// kWideMax of them (its ring's shared memory); kEdge steps of lane 31's
// highest column a warp keeps for the next.
constexpr int kWideK = 32;
constexpr int kWarpGap = 32;
constexpr int kWideMax = 6;
constexpr int kEdge = 128;

// Columns a lane owns: the smallest instantiated K >= ceil(T_s / 32).
__host__ __device__ constexpr int cols_per_lane(int t_s) {
  return t_s <= 32 ? 1 : t_s <= 64 ? 2 : t_s <= 96 ? 3 : t_s <= 128 ? 4
       : t_s <= 192 ? 6 : t_s <= 256 ? 8 : t_s <= 384 ? 12 : t_s <= 512 ? 16
       : t_s <= 768 ? 24 : 32;
}

// Step rows a chunk of the ring: 64/K rounded down to a power of two, in
// [2, 32], so that a chunk divides a 32-step block.
__host__ __device__ constexpr int chunk_steps(int k) {
  return k <= 2 ? 32 : k <= 4 ? 16 : k <= 8 ? 8 : k <= 16 ? 4 : 2;
}

// Chunks of step rows in the ring: 8 (64 KB) up to K = 8, else 4. The
// chain block computes the first kFillChunks itself, so that its chain
// starts before any log block has written one.
__host__ __device__ constexpr int ring_chunks(int k) { return k <= 8 ? 8 : 4; }
constexpr int kFillChunks = 4;

// Warps a block: 16, or 8 from K = 24 on, whose chain warp needs more than
// the 128 registers a thread of 16 warps may hold.
__host__ __device__ constexpr int block_warps(int k) { return k >= 24 ? 8 : 16; }

// Step rows of an utterance's scratch, and of its chain: mel_len +
// kSkew*31 at most, whole blocks of 32.
__host__ __device__ constexpr long long chain_rows(long long t_m) {
  return (t_m + kSkew * (kWarp - 1) + kWarp - 1) / kWarp * kWarp;
}

template <int K>
struct Cfg {
  static constexpr int warps = block_warps(K);
  static constexpr int threads = warps * kWarp;
  static constexpr int C = chunk_steps(K);
  static constexpr int cols = kWarp * K;
  static constexpr int cells = C * cols;               // a chunk's
  static constexpr int cells_per_thread = (cells + threads - 1) / threads;
  // the chain block's warps 2.. fill the first kFillChunks chunks
  static constexpr int fillers = threads - 2 * kWarp;
  static constexpr int fill_cells = (cells + fillers - 1) / fillers;  // a chunk
  static constexpr int ring = ring_chunks(K);
};

struct Layout {
  long long ring_off, bits_off, bytes;
};

// Shared memory of a chain block (a log block uses its role's int alone):
// 2*8 mbarriers, the run starts (32K ints, one for the column the path
// holds at frame 0 and one for the block's role), the ring and the move
// bits (one word a column for each 32 steps).
__host__ __device__ inline Layout layout(long long t_m, int k) {
  const long long cols = 32LL * k;
  const long long words = chain_rows(t_m) / kWarp;
  Layout l;
  l.ring_off = 2 * 8 * 8 + (cols + 4) * 4;
  l.bits_off = l.ring_off + ring_chunks(k) * chunk_steps(k) * cols * 4;
  l.bytes = l.bits_off + words * cols * 4;
  return l;
}

// Scratch in device memory: per utterance the logarithms in step rows
// (chain_rows x 32K floats); then per utterance a flag a chunk and one for
// the zeroed output, each set to 1 when written; then the ticket.
__host__ __device__ inline long long scratch_floats(long long t_m, int k) {
  return chain_rows(t_m) * 32LL * k;
}
__host__ __device__ inline long long n_flags(long long t_m, int k) {
  return chain_rows(t_m) / chunk_steps(k) + 1;
}

__device__ __forceinline__ float mas_log(float p, float eps) {
  // torch.clamp(p, min=eps) keeps a NaN, as this select does
  return logf(p < eps ? eps : p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// The mbarrier counts one arrival when this thread's earlier cp.async
// copies have landed.
__device__ __forceinline__ void bar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait for the completion of the mbarrier phase of the given parity.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ unsigned load_flag(const unsigned* f) {
  return *reinterpret_cast<const volatile unsigned*>(f);
}

// A flag read with acquire semantics: what its writer released before
// setting it is visible to this thread's later reads.
__device__ __forceinline__ unsigned load_flag_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(f) : "memory");
  return v;
}

// Publish what this block wrote (after a __syncthreads).
__device__ __forceinline__ void set_flag(unsigned* f) {
  __threadfence();
  *reinterpret_cast<volatile unsigned*>(f) = 1u;
}

template <int K>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + k);
      v[k] = x.x; v[k + 1] = x.y; v[k + 2] = x.z; v[k + 3] = x.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + k);
      v[k] = x.x; v[k + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = src[k];
  }
}

template <int K>
__device__ __forceinline__ void store_words(unsigned* dst, const unsigned (&w)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<uint4*>(dst + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2)
      *reinterpret_cast<uint2*>(dst + k) = make_uint2(w[k], w[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = w[k];
  }
}

// Chunks of ring rows an utterance's chain reads: its mel_len +
// kSkew*(ceil(text_len/K) - 1) steps in whole blocks of 32; none where no
// column past 0 can be reached.
template <int K>
__device__ __forceinline__ int n_chunks_of(int text_len, int mel_len) {
  if (mel_len <= 0 || text_len <= 1) return 0;
  const int steps = mel_len + kSkew * ((text_len + K - 1) / K - 1);
  return (steps + kWarp - 1) / kWarp * (kWarp / chunk_steps(K));
}

// Cell e of chunk q (row r = e / 32K, column c = e % 32K) is lane c/K's
// frame q*C + r - kSkew*(c/K): its logarithm, or nothing where the chain does not
// read it (a column at or past text_len, a frame outside [0, mel_len)).
template <int K>
__device__ __forceinline__ bool cell_source(int q, int e, int text_len,
                                            int mel_len, int* f, int* c) {
  using G = Cfg<K>;
  const int r = e / G::cols;
  *c = e % G::cols;
  *f = q * G::C + r - kSkew * (*c / K);
  return e < G::cells && *c < text_len &&
         static_cast<unsigned>(*f) < static_cast<unsigned>(mel_len);
}

// 32 steps of the chain warp, from step 32*blk. FIRST marks the blocks in
// which lanes meet their frame 0. A chunk of the ring is ready on `full` and
// is handed back on `consumed`. `lefts` holds the lane's left neighbours for
// the next kSkew steps, oldest first.
template <int K, bool FIRST>
__device__ __forceinline__ void chain_block(
    const float* ring, unsigned* bits, uint64_t* full,
    uint64_t* consumed, float (&lp)[K], float (&lefts)[kSkew],
    int blk, int lane) {
  constexpr int C = chunk_steps(K);
  constexpr int R = ring_chunks(K);
  constexpr int kRows = R * C;
  constexpr int cols = kWarp * K;
  const int base_row = (blk * kWarp) % kRows;   // 0 when kRows <= 32
  unsigned acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0u;
#pragma unroll
  for (int u = 0; u < kWarp; ++u) {
    const int q = (blk * kWarp + u) / C;        // chunk of this step
    if (u % C == 0) bar_wait(&full[q % R], (q / R) & 1);
    float la[K];
    load_cols<K>(ring + (base_row + u % kRows) * cols + lane * K, la);
    // lane L-1's highest column after the previous step: used kSkew steps
    // on, when this lane reaches the frame after it
    const float nxt = __shfl_up_sync(0xffffffffu, lp[K - 1], 1);
    float sh = lefts[0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float here = lp[k];
      const bool move = sh >= here;               // tie -> diagonal
      acc[k] |= move ? (1u << u) : 0u;
      lp[k] = la[k] + (move ? sh : here);
      sh = here;
    }
    if (FIRST && blk * kWarp + u == kSkew * lane) {   // frame 0 of this lane
#pragma unroll
      for (int k = 0; k < K; ++k) lp[k] = (lane * K + k == 0) ? la[k] : kNeg;
    }
#pragma unroll
    for (int j = 0; j + 1 < kSkew; ++j) lefts[j] = lefts[j + 1];
    lefts[kSkew - 1] = lane == 0 ? kNeg : nxt;
    if (u % C == C - 1) {                         // the chunk's rows are read
      __syncwarp();
      if (lane == 0) bar_arrive(&consumed[q % R]);
    }
  }
  if (FIRST) {
    // bits at or below a lane's frame 0 (its first steps) mean nothing:
    // clear them, so that no search needs a lower bound
    const int g = kSkew * lane - blk * kWarp;     // frame 0's bit in this word
    const unsigned keep = g < 0 ? 0xffffffffu : g >= 31 ? 0u : ~((2u << g) - 1u);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] &= keep;
  }
  store_words<K>(bits + blk * cols + lane * K, acc);
}

// The stager warp: copies chunks kFillChunks.. of the utterance's scratch
// into the ring as the log blocks flag them, each into a slot the chain
// warp has handed back. Lane j reads chunk q+j's flag with acquire
// semantics; a __syncwarp() then orders every lane's copies after those
// reads (no fence, which would wait for the copies already in flight).
template <int K>
__device__ void stage(const float* scratch, const unsigned* flags,
                      float* ring, uint64_t* full,
                      uint64_t* consumed, int n_chunks, int lane) {
  using G = Cfg<K>;
  constexpr int R = G::ring;
  constexpr int kCopies = G::cells * 4 / 16 / kWarp;   // 16-byte copies a lane
  int ready = kFillChunks;                             // chunks flagged so far
  for (int q = kFillChunks; q < n_chunks; ++q) {
    if (q >= ready) {
      while (q >= ready) {
        const int j = q + lane;
        const bool set = j >= n_chunks || load_flag_acquire(&flags[j]) != 0u;
        const unsigned mask = __ballot_sync(0xffffffffu, set);
        ready = q + (mask == 0xffffffffu ? kWarp : __ffs(~mask) - 1);
        if (q >= ready) __nanosleep(128);
      }
      __syncwarp();
    }
    const int slot = q % R;
    if (q >= R) bar_wait(&consumed[slot], (q / R - 1) & 1);
    const float* src = scratch + static_cast<long long>(q) * G::cells;
    float* dst = ring + slot * G::cells;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = (i * kWarp + lane) * 4;
      cp_async16(dst + e, src + e);
    }
    bar_arrive_on_copies(&full[slot]);
  }
}

// From (mel_len-1, text_len-1) down to frame 0: start[c] is the first frame
// of column c's run; returns the column the path holds at frame 0. Frame f
// of column c is bit f + kSkew*(c/K) of the column's words, and no bit below
// frame 1 is set.
template <int K>
__device__ int backtrack(const unsigned* bits, int* start, int text_len,
                         int mel_len) {
  constexpr int cols = kWarp * K;
  int c = max(text_len - 1, 0);
  if (c > 0 && mel_len > 1) {
    int L = kSkew * (c / K);
    int bit = mel_len - 1 + L;                    // frame mel_len-1, column c
    while (true) {
      // the highest set bit at or below `bit` in column c
      int w = bit >> 5;
      unsigned m = bits[w * cols + c] & (0xffffffffu >> (~bit & 31));
      while (m == 0u && w > 0) m = bits[--w * cols + c];
      const int fb = m ? w * 32 + 31 - __clz(m) : -1;
      const int f = fb - L;                       // the run's first frame
      if (fb < 0 || c == 1 || f <= 1) {
        if (fb >= 0) start[c--] = f;              // else down to frame 0
        break;
      }
      start[c--] = f;
      const int Ln = kSkew * (c / K);
      bit = fb - 1 - (L - Ln);                    // frame f-1 in column c
      L = Ln;
    }
  }
  start[c] = 0;
  return c;
}

// Log block `block`: chunks (q from kFillChunks on) of every utterance,
// chunk by chunk across the batch, one at a time, each flagged when
// written; then the zeroed output slabs of utterances block, block + n_log,
// ..., flagged too. It waits for nothing. One chunk a block at a time,
// across the SMs the chain blocks leave, keeps the chunks ahead of the
// chains.
template <int K>
__device__ void log_block(const float* __restrict__ attn,
                          const int* __restrict__ in_lens,
                          const int* __restrict__ out_lens,
                          float* __restrict__ out, float* scratch,
                          unsigned* flags, int b_total, int n_log, int t_m,
                          int t_s, float eps, int block) {
  using G = Cfg<K>;
  constexpr int N = G::cells_per_thread;
  const long long nq = n_flags(t_m, K) - 1;
  const long long slab = static_cast<long long>(t_m) * t_s;
  const long long n_items =
      (nq > kFillChunks ? nq - kFillChunks : 0) * b_total;
  const int tid = threadIdx.x;
  for (long long k = block; k < n_items; k += n_log) {
    const int q = static_cast<int>(k / b_total) + kFillChunks;
    const int b = static_cast<int>(k % b_total);
    const int text_len = min(max(in_lens[b], 0), t_s);
    const int mel_len = min(max(out_lens[b], 0), t_m);
    if (q >= n_chunks_of<K>(text_len, mel_len)) continue;   // past its chain
    const float* pb = attn + b * slab;
    float* rows = scratch + b * scratch_floats(t_m, K) +
                  static_cast<long long>(q) * G::cells;
    float v[N];
    int dst[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int f, c;
      const int e = tid + j * G::threads;
      const bool live = cell_source<K>(q, e, text_len, mel_len, &f, &c);
      dst[j] = live ? e : -1;
      v[j] = live ? pb[static_cast<long long>(f) * t_s + c] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (dst[j] >= 0) rows[dst[j]] = mas_log(v[j], eps);
    __syncthreads();
    if (tid == 0) set_flag(&flags[b * (nq + 1) + q]);
  }
  for (int b = block; b < b_total; b += n_log) {
    float* ob = out + b * slab;
    if (slab % 4 == 0) {
      float4* o4 = reinterpret_cast<float4*>(ob);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long e = tid; e < slab / 4; e += G::threads) o4[e] = zero;
    } else {
      for (long long e = tid; e < slab; e += G::threads) ob[e] = 0.f;
    }
    __syncthreads();
    if (tid == 0) set_flag(&flags[b * (nq + 1) + nq]);
  }
}

// Where the device-memory move words start in the scratch: past the ticket,
// 16-byte aligned; chain_rows(t_m) * K words (chain_rows/32 words of each
// of the 32K columns) an utterance.
__host__ __device__ inline long long moves_off(long long b, long long t_m, int k) {
  return ((b * (scratch_floats(t_m, k) + n_flags(t_m, k)) + 1) * 4 + 15) / 16 * 16;
}

// The backtrack from device memory (GBITS, and the wide kernel), 32 frames
// a round: frame f of column c is bit f + skew(c) of the column's words in
// rows of `cols` words, skew(c) = kSkew*(c/K) + kWarpGap*(c/(32K)) (the
// second term is the wide kernel's gap between chain warps; one warp's
// columns have none), no bit below frame 1 is set, and the path falls at
// most one column a frame. Each lane writes the 1.0 of its frame of the
// round.
template <int K>
__device__ void walk(const unsigned* bits, float* ob, int text_len,
                     int mel_len, int t_s, int cols, int lane) {
  int c = max(text_len - 1, 0);
  for (int i0 = mel_len - 1; i0 >= 0; i0 -= kWarp) {
    const int base = i0 - (kWarp - 1);           // the window's bit 0
    const int lo_f = max(base, 0);
    // lane j: frames base .. i0 of column c - j (column 0 never moves)
    const int cj = c - lane;
    unsigned win = 0u;
    if (cj > 0) {
      const int pos = base + kSkew * (cj / K) + kWarpGap * (cj / (kWarp * K));
      const int w = pos >> 5, sh = pos & 31;     // floor, also below 0
      const unsigned lo = w >= 0 ? bits[w * cols + cj] : 0u;
      const unsigned hi = sh ? bits[(w + 1) * cols + cj] : 0u;
      win = sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
    }
    const int mine_f = i0 - lane;                // this lane's frame
    int mine = 0, d = 0, i = i0;
    while (true) {
      const unsigned wd = __shfl_sync(0xffffffffu, win, d);
      const int col = c - d;
      const unsigned m = wd & (0xffffffffu >> (31 - (i - base)));
      // the run in col: frames f .. i, f the highest with its move bit set
      const int f = m ? base + 31 - __clz(m) : lo_f;
      if (mine_f >= f && mine_f <= i) mine = col;
      if (m == 0u) {                             // down past the round
        c = col;
        break;
      }
      i = f - 1;                                 // frame f-1 in col - 1
      ++d;
      if (i < lo_f) {
        c = col - 1;
        break;
      }
    }
    if (mine_f >= 0) ob[static_cast<long long>(mine_f) * t_s + mine] = 1.f;
  }
}

// A block takes its role from a ticket in the order blocks start, not
// from blockIdx: tickets [0, n_log) make log blocks, the next B chain
// blocks (ticket n_log + b carries utterance b). A chain block waits only
// on log blocks, and those took their tickets before it, so they are
// already running whatever order the card dispatches the grid in. GBITS:
// the move words in the scratch (moves_off), the backtrack by walk().
template <int K, bool GBITS>
__global__ void __launch_bounds__(Cfg<K>::threads, 1)
mas_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
           const int* __restrict__ out_lens, float* __restrict__ out,
           float* scratch, unsigned* flags, unsigned* ticket, int b_total,
           int n_log, int t_m, int t_s, float eps) {
  using G = Cfg<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* consumed = full + 8;
  int* start = reinterpret_cast<int*>(consumed + 8);
  int* first_col = start + G::cols;
  int* role = first_col + 1;
  if (threadIdx.x == 0) *role = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  if (*role < n_log) {
    log_block<K>(attn, in_lens, out_lens, out, scratch, flags, b_total, n_log,
                 t_m, t_s, eps, *role);
    return;
  }
  const Layout lay = layout(t_m, K);
  float* ring = reinterpret_cast<float*>(smem_raw + lay.ring_off);
  unsigned* bits = reinterpret_cast<unsigned*>(smem_raw + lay.bits_off);

  const int b = *role - n_log;
  if constexpr (GBITS)
    bits = reinterpret_cast<unsigned*>(reinterpret_cast<unsigned char*>(scratch) +
                                       moves_off(b_total, t_m, K)) +
           b * chain_rows(t_m) * K;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int text_len = min(max(in_lens[b], 0), t_s);
  const int mel_len = min(max(out_lens[b], 0), t_m);
  const long long slab = static_cast<long long>(t_m) * t_s;
  const long long nq = n_flags(t_m, K) - 1;
  const float* pb = attn + b * slab;
  float* ob = out + b * slab;
  const unsigned* uflags = flags + b * (nq + 1);
  const int n_chunks = n_chunks_of<K>(text_len, mel_len);
  const int n_blk = n_chunks / (kWarp / G::C);

  if (tid == 0) {
    for (int j = 0; j < G::ring; ++j) {
      bar_init(&full[j], kWarp);                  // the stager's lanes
      bar_init(&consumed[j], 1);
    }
  }
  __syncthreads();

  if (warp == 0) {
    int c0 = 0;
    if (n_blk > 0) {
      float lp[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lp[k] = kNeg;
      float lefts[kSkew];
#pragma unroll
      for (int j = 0; j < kSkew; ++j) lefts[j] = kNeg;
      for (int blk = 0; blk < n_blk; ++blk) {
        if (blk < kFirstBlocks)
          chain_block<K, true>(ring, bits, full, consumed, lp, lefts,
                               blk, lane);
        else
          chain_block<K, false>(ring, bits, full, consumed, lp, lefts,
                                blk, lane);
      }
      __syncwarp();
      if constexpr (!GBITS)
        if (lane == 0) c0 = backtrack<K>(bits, start, text_len, mel_len);
    } else if (lane == 0) {
      start[0] = 0;                               // column 0 holds every frame
    }
    if (lane == 0) *first_col = c0;
  } else if (warp == 1) {
    if (n_chunks > kFillChunks)
      stage<K>(scratch + b * scratch_floats(t_m, K), uflags, ring, full,
               consumed, n_chunks, lane);
  } else if (n_blk > 0) {
    // the first kFillChunks chunks, computed here, so that the chain starts
    // before any log block has written one: every load first, then the
    // logarithms chunk by chunk, each chunk handed over when written
    constexpr int F = G::fill_cells;
    const int t = tid - 2 * kWarp;
    float v[kFillChunks][F];
    int dst[kFillChunks][F];
#pragma unroll
    for (int q = 0; q < kFillChunks; ++q)
#pragma unroll
      for (int j = 0; j < F; ++j) {
        int f, c;
        const int e = t + j * G::fillers;
        const bool live = cell_source<K>(q, e, text_len, mel_len, &f, &c);
        dst[q][j] = live ? q * G::cells + e : -1;
        v[q][j] = live ? pb[static_cast<long long>(f) * t_s + c] : 1.f;
      }
#pragma unroll
    for (int q = 0; q < kFillChunks; ++q) {
#pragma unroll
      for (int j = 0; j < F; ++j)
        if (dst[q][j] >= 0) ring[dst[q][j]] = mas_log(v[q][j], eps);
      asm volatile("bar.sync 1, %0;\n" :: "n"(G::fillers) : "memory");
      if (t == 0) bar_arrive(&full[q], kWarp);
    }
  }
  if constexpr (GBITS) {
    // warp 0 alone: after the log blocks have zeroed the slab, the walk
    if (warp == 0) {
      if (lane == 0) {
        while (load_flag(&uflags[nq]) == 0u) __nanosleep(256);
        __threadfence();
      }
      __syncwarp();
      walk<K>(bits, ob, text_len, mel_len, t_s, kWarp * K, lane);
    }
    return;
  }
  // the log blocks have zeroed the slab
  if (tid == 0) {
    while (load_flag(&uflags[nq]) == 0u) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();

  // one 1.0 a frame below mel_len, from the runs: frame f's column is the
  // last whose run starts at or before f
  const int c0 = *first_col, c1 = max(text_len - 1, 0);
  for (int f = tid; f < mel_len; f += G::threads) {
    int lo = c0, hi = c1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= f) lo = mid;
      else hi = mid - 1;
    }
    ob[static_cast<long long>(f) * t_s + lo] = 1.f;
  }
}

// The long route's shape: columns a thread, threads a block (whole warps),
// words of move bits a frame, and whether the two rows fit shared memory.
__host__ __device__ inline int rows_cols(int t_s) {
  return (t_s + kRowsThreads - 1) / kRowsThreads;
}
__host__ __device__ inline int rows_threads(int t_s) {
  const int k = rows_cols(t_s);
  return ((t_s + k - 1) / k + kWarp - 1) / kWarp * kWarp;
}
__host__ __device__ inline long long rows_words(long long t_s) {
  return (t_s + kWarp - 1) / kWarp;
}
__host__ __device__ inline bool rows_shared(long long t_s) {
  return 8 * t_s <= kMaxShared;
}

// The kernel a shape takes: 0 the warp kernel, 2 the warp kernel with its
// move words in device memory (T_s <= 1024 whose shared memory does not
// fit), 3 the wide kernel (T_s in (1024, 1024*kWideMax]), 1 the long route
// (past it).
inline int mas_route(long long t_m, long long t_s) {
  if (t_s > kWarp * kWideK * kWideMax) return 1;
  if (t_s > 1024) return 3;
  return layout(t_m, cols_per_lane(static_cast<int>(t_s))).bytes <= kMaxShared
             ? 0 : 2;
}

// One utterance a block, columns over threads, one barrier a frame (the
// long route; see the head of the file). moves: [B, T_m, words] words, rows:
// a global scratch of 2*T_s floats a block where shared memory cannot hold
// them, else null.
__global__ void __launch_bounds__(kRowsThreads)
mas_rows_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
                const int* __restrict__ out_lens, float* __restrict__ out,
                unsigned* __restrict__ moves, float* scratch_rows, int t_m,
                int t_s, float eps) {
  extern __shared__ float shared_rows[];
  const int b = blockIdx.x, tid = threadIdx.x, n = blockDim.x;
  const int lane = tid % kWarp;
  const int kn = (t_s + n - 1) / n;
  const long long words = rows_words(t_s);
  const int text_len = min(max(in_lens[b], 0), t_s);
  const int mel_len = min(max(out_lens[b], 0), t_m);
  const long long slab = static_cast<long long>(t_m) * t_s;
  const float* pb = attn + b * slab;
  float* ob = out + b * slab;
  unsigned* mb = moves + b * static_cast<long long>(t_m) * words;
  float* rows = scratch_rows ? scratch_rows + 2LL * b * t_s : shared_rows;

  // frame 0: only column 0 is reachable
  for (int k = 0; k < kn; ++k) {
    const int c = tid + k * n;
    if (c >= t_s) break;
    rows[c] = (c == 0 && text_len > 0) ? mas_log(pb[0], eps) : kNeg;
    ob[c] = 0.f;
  }
  __syncthreads();
  float cur[kRowsAhead], nxt[kRowsAhead];
#pragma unroll
  for (int k = 0; k < kRowsAhead; ++k) {
    const int c = tid + k * n;
    cur[k] = (k < kn && c < text_len && 1 < mel_len) ? pb[t_s + c] : 1.f;
  }
  for (int i = 1; i < mel_len; ++i) {
    const float* prev = rows + ((i - 1) & 1) * t_s;
    float* row = rows + (i & 1) * t_s;
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) {
      const int c = tid + k * n;
      nxt[k] = (k < kn && c < text_len && i + 1 < mel_len)
                   ? pb[static_cast<long long>(i + 1) * t_s + c] : 1.f;
    }
    for (int k = 0; k < kn; ++k) {
      const int c = tid + k * n;
      bool move = false;
      if (c < text_len) {
        float p = 1.f;
#pragma unroll
        for (int j = 0; j < kRowsAhead; ++j)
          if (j == k) p = cur[j];
        if (k >= kRowsAhead) p = pb[static_cast<long long>(i) * t_s + c];
        const float here = prev[c];
        const float left = c > 0 ? prev[c - 1] : kNeg;
        move = left >= here;                        // tie -> diagonal
        row[c] = mas_log(p, eps) + (move ? left : here);
      }
      const unsigned w = __ballot_sync(0xffffffffu, move);
      if (lane == 0 && c < t_s) mb[i * words + c / kWarp] = w;
      if (c < t_s) ob[static_cast<long long>(i) * t_s + c] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) cur[k] = nxt[k];
  }
  // the rows the chain did not pass
  for (long long e = static_cast<long long>(max(mel_len, 1)) * t_s + tid;
       e < slab; e += n)
    ob[e] = 0.f;
  __syncthreads();

  // the backtrack, from (mel_len-1, text_len-1): 32 frames a round
  if (tid < kWarp) {
    int curr = max(text_len - 1, 0);
    for (int i0 = mel_len - 1; i0 >= 0; i0 -= kWarp) {
      const int i = i0 - lane;                      // this lane's frame
      const int w0 = curr / kWarp;
      unsigned hi = 0u, lo = 0u;
      if (i >= 1) {
        hi = mb[i * words + w0];
        if (w0 > 0) lo = mb[i * words + w0 - 1];
      }
      int mine = 0;
      for (int j = 0; j < kWarp && i0 - j >= 0; ++j) {
        const unsigned h = __shfl_sync(0xffffffffu, hi, j);
        const unsigned l = __shfl_sync(0xffffffffu, lo, j);
        if (lane == j) mine = curr;
        const unsigned word = curr / kWarp == w0 ? h : l;
        if (i0 - j > 0 && curr > 0 && ((word >> (curr % kWarp)) & 1u)) --curr;
      }
      if (i >= 0) ob[static_cast<long long>(i) * t_s + mine] = 1.f;
    }
  }
}


// ---- the wide kernel: W chain warps, T_s in (1024, 1024*kWideMax] --------- //
//
// The warp kernel's design spread over W = ceil(T_s/1024) chain warps of one
// block, so that its chain has no block-wide barrier a frame past 1024
// columns either. Virtual lane L' = 32w + L owns columns [32L', 32L' + 32)
// and runs at skew(L') = kSkew*L' + kWarpGap*w steps: at step s it works on
// frame s - skew. Inside a warp the left neighbour comes by shuffle, as in
// the warp kernel; lane 0 of warp w > 0 takes it from the edge ring that
// lane 31 of warp w-1 writes (its highest column after each step): with the
// gap, the value a step needs was written 33 steps before, in an earlier
// 32-step block, so a warp waits only at the start of a block, for the
// previous warp to have finished the block before (a counter in shared
// memory; the previous warp in turn waits before it overwrites ring
// entries not yet read). The logarithms come from log blocks into a device
// scratch of step rows (1024*W columns), flagged chunk by chunk and staged
// into a shared ring by a stager warp, as in the warp kernel (every chunk,
// no fillers); each chunk is handed back once all W chain warps read it.
// The move words go to device memory ([B, rows/32, 1024*W], by column) and
// warp 0 backtracks them by walk() once every chain warp has finished.

__host__ __device__ inline int wide_warps(long long t_s) {
  return static_cast<int>((t_s + kWarp * kWideK - 1) / (kWarp * kWideK));
}
__host__ __device__ inline int wide_skew(int c) {
  return kSkew * (c / kWideK) + kWarpGap * (c / (kWarp * kWideK));
}
// step rows of an utterance's scratch: t_m + the largest skew, whole blocks
__host__ __device__ inline long long wide_rows(long long t_m, int w) {
  return (t_m + kSkew * (kWarp * w - 1) + kWarpGap * (w - 1) + kWarp - 1) /
         kWarp * kWarp;
}

struct WideLayout {
  long long edge_off, ring_off, bytes;
};

// Shared memory: 2*4 mbarriers, the warps' block counters and the role,
// the edge rings ((W-1) x kEdge floats), the ring (4 chunks of 2 step rows
// of 1024*W floats).
__host__ __device__ inline WideLayout wide_layout(int w) {
  WideLayout l;
  l.edge_off = 2 * 4 * 8 + 64;
  l.ring_off = l.edge_off + (w - 1) * kEdge * 4LL;
  l.bytes = l.ring_off + ring_chunks(kWideK) * chunk_steps(kWideK) * 1024LL * w * 4;
  return l;
}

// The scratch: the logs (rows x 1024W floats an utterance), a flag a chunk
// and one for the zeroed output an utterance, the ticket, then (16-byte
// aligned) the move words, rows/32 x 1024W an utterance.
__host__ __device__ inline long long wide_moves_off(long long b, long long t_m,
                                                    int w) {
  const long long rows = wide_rows(t_m, w);
  return ((b * (rows * 1024 * w + rows / chunk_steps(kWideK) + 1)) + 1) * 4 /
         16 * 16 + 16;
}

// Chunks an utterance's chain reads: mel_len + skew of its last column.
__device__ __forceinline__ int wide_chunks(int text_len, int mel_len) {
  if (mel_len <= 0 || text_len <= 1) return 0;
  const int steps = mel_len + wide_skew(text_len - 1);
  return (steps + kWarp - 1) / kWarp * (kWarp / chunk_steps(kWideK));
}

__device__ void wide_log_block(const float* __restrict__ attn,
                               const int* __restrict__ in_lens,
                               const int* __restrict__ out_lens,
                               float* __restrict__ out, float* scratch,
                               unsigned* flags, int b_total, int n_log,
                               int t_m, int t_s, float eps, int block) {
  constexpr int C = chunk_steps(kWideK);
  const int w = wide_warps(t_s), cols = kWarp * kWideK * w, cells = C * cols;
  const long long rows = wide_rows(t_m, w), nq = rows / C;
  const long long slab = static_cast<long long>(t_m) * t_s;
  const int tid = threadIdx.x, n = blockDim.x;
  for (long long k = block; k < nq * b_total; k += n_log) {
    const int q = static_cast<int>(k / b_total);
    const int b = static_cast<int>(k % b_total);
    const int text_len = min(max(in_lens[b], 0), t_s);
    const int mel_len = min(max(out_lens[b], 0), t_m);
    if (q >= wide_chunks(text_len, mel_len)) continue;     // past its chain
    const float* pb = attn + b * slab;
    float* dst = scratch + b * rows * cols + static_cast<long long>(q) * cells;
    for (int e0 = 0; e0 < cells; e0 += 8 * n) {            // 8 loads, 8 logs
      float v[8];
      int at[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = e0 + i * n + tid, c = e % cols;
        const int f = q * C + e / cols - wide_skew(c);
        const bool live = e < cells && c < text_len &&
                          static_cast<unsigned>(f) < static_cast<unsigned>(mel_len);
        at[i] = live ? e : -1;
        v[i] = live ? pb[static_cast<long long>(f) * t_s + c] : 1.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (at[i] >= 0) dst[at[i]] = mas_log(v[i], eps);
    }
    __syncthreads();
    if (tid == 0) set_flag(&flags[b * (nq + 1) + q]);
  }
  for (int b = block; b < b_total; b += n_log) {
    float* ob = out + b * slab;
    for (long long e = tid; e < slab; e += n) ob[e] = 0.f;
    __syncthreads();
    if (tid == 0) set_flag(&flags[b * (nq + 1) + nq]);
  }
}

__device__ __forceinline__ int load_count(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// Roles from a ticket as the warp kernel's: [0, n_log) log blocks, then a
// chain block an utterance. A chain block: warps [0, W) the chain, warp W
// the stager.
__global__ void __launch_bounds__(256, 1)
mas_wide_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
                const int* __restrict__ out_lens, float* __restrict__ out,
                float* scratch, unsigned* flags, unsigned* ticket, int b_total,
                int n_log, int t_m, int t_s, float eps) {
  constexpr int K = kWideK, C = chunk_steps(K), R = ring_chunks(K);
  constexpr int kRows = R * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* consumed = full + R;
  int* done = reinterpret_cast<int*>(consumed + R);
  int* role = done + kWideMax;
  if (threadIdx.x == 0) *role = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  if (*role < n_log) {
    wide_log_block(attn, in_lens, out_lens, out, scratch, flags, b_total,
                   n_log, t_m, t_s, eps, *role);
    return;
  }
  const int W = wide_warps(t_s), cols = kWarp * K * W;
  const WideLayout lay = wide_layout(W);
  float* edge = reinterpret_cast<float*>(smem_raw + lay.edge_off);
  float* ring = reinterpret_cast<float*>(smem_raw + lay.ring_off);
  const int b = *role - n_log;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int text_len = min(max(in_lens[b], 0), t_s);
  const int mel_len = min(max(out_lens[b], 0), t_m);
  const long long rows = wide_rows(t_m, W), nq = rows / C;
  const long long slab = static_cast<long long>(t_m) * t_s;
  float* ob = out + b * slab;
  const unsigned* uflags = flags + b * (nq + 1);
  unsigned* bits = reinterpret_cast<unsigned*>(reinterpret_cast<unsigned char*>(scratch) +
                                               wide_moves_off(b_total, t_m, W)) +
                   b * (rows / kWarp) * cols;
  const int n_chunks = wide_chunks(text_len, mel_len);
  const int n_blk = n_chunks / (kWarp / C);

  if (tid == 0) {
    for (int j = 0; j < R; ++j) {
      bar_init(&full[j], kWarp);                  // the stager's lanes
      bar_init(&consumed[j], W);                  // each chain warp's lane 0
    }
    for (int w = 0; w < kWideMax; ++w) done[w] = 0;
  }
  __syncthreads();

  if (warp < W) {
    const int lv = kWarp * warp + lane;           // the virtual lane
    const int skew = kSkew * lv + kWarpGap * warp;
    float lp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) lp[k] = kNeg;
    float lefts[kSkew];
#pragma unroll
    for (int j = 0; j < kSkew; ++j) lefts[j] = kNeg;
    const float* up = edge + (warp - 1) * kEdge;  // warp w-1's lane 31
    float* mine = edge + warp * kEdge;
    for (int blk = 0; blk < n_blk; ++blk) {
      // the previous warp's block blk-1, and room in this warp's edge ring
      if (lane == 0) {
        while ((warp > 0 && load_count(&done[warp - 1]) < blk) ||
               (warp + 1 < W && load_count(&done[warp + 1]) < blk - 1))
          __nanosleep(64);
        __threadfence_block();
      }
      __syncwarp();
      unsigned acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0u;
#pragma unroll
      for (int u = 0; u < kWarp; ++u) {
        const int s = blk * kWarp + u;
        const int q = s / C;
        if (u % C == 0) bar_wait(&full[q % R], (q / R) & 1);
        float la[K];
        load_cols<K>(ring + (s % kRows) * cols + lv * K, la);
        const float nxt = __shfl_up_sync(0xffffffffu, lp[K - 1], 1);
        float sh = lefts[0];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float here = lp[k];
          const bool move = sh >= here;           // tie -> diagonal
          acc[k] |= move ? (1u << u) : 0u;
          lp[k] = la[k] + (move ? sh : here);
          sh = here;
        }
        if (s == skew) {                          // frame 0 of this lane
#pragma unroll
          for (int k = 0; k < K; ++k) lp[k] = (lv == 0 && k == 0) ? la[k] : kNeg;
        }
#pragma unroll
        for (int j = 0; j + 1 < kSkew; ++j) lefts[j] = lefts[j + 1];
        // lane 0 of warp w > 0: warp w-1's highest column after step
        // s - 33 (its skew is 34 below this lane's), the frame before the
        // one this lane takes at step s+2
        float left = nxt;
        if (lane == 0)
          left = (warp == 0 || s < kSkew + kWarpGap - 1) ? kNeg
               : up[(s - kSkew - kWarpGap + 1) % kEdge];
        lefts[kSkew - 1] = left;
        if (lane == kWarp - 1 && warp + 1 < W) mine[s % kEdge] = lp[K - 1];
        if (u % C == C - 1) {                     // the chunk's rows are read
          __syncwarp();
          if (lane == 0) bar_arrive(&consumed[q % R]);
        }
      }
      // bits at or below a lane's frame 0 mean nothing
      const int g = skew - blk * kWarp;
      const unsigned keep = g < 0 ? 0xffffffffu : g >= 31 ? 0u : ~((2u << g) - 1u);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] &= keep;
      store_words<K>(bits + blk * cols + lv * K, acc);
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *reinterpret_cast<volatile int*>(&done[warp]) = blk + 1;
      }
    }
    if (warp == 0) {
      // every chain warp's move words, and the zeroed slab
      if (lane == 0) {
        for (int w = 1; w < W; ++w)
          while (load_count(&done[w]) < n_blk) __nanosleep(64);
        while (load_flag(&uflags[nq]) == 0u) __nanosleep(256);
        __threadfence();
      }
      __syncwarp();
      walk<K>(bits, ob, text_len, mel_len, t_s, cols, lane);
    }
  } else if (warp == W && n_chunks > 0) {
    // the stager: every chunk, as the log blocks flag it
    const float* src0 = scratch + b * rows * cols;
    const int copies = C * cols * 4 / 16 / kWarp;  // 16-byte copies a lane
    int ready = 0;
    for (int q = 0; q < n_chunks; ++q) {
      while (q >= ready) {
        const int j = q + lane;
        const bool set = j >= n_chunks || load_flag_acquire(&uflags[j]) != 0u;
        const unsigned mask = __ballot_sync(0xffffffffu, set);
        ready = q + (mask == 0xffffffffu ? kWarp : __ffs(~mask) - 1);
        if (q >= ready) __nanosleep(128);
      }
      __syncwarp();
      const int slot = q % R;
      if (q >= R) bar_wait(&consumed[slot], (q / R - 1) & 1);
      const float* src = src0 + static_cast<long long>(q) * C * cols;
      float* dst = ring + slot * C * cols;
      for (int i = 0; i < copies; ++i) {
        const int e = (i * kWarp + lane) * 4;
        cp_async16(dst + e, src + e);
      }
      bar_arrive_on_copies(&full[slot]);
    }
  }
}

// Applies mas_log elementwise: the kernel's logarithm, for a test to hold
// against torch.log(torch.clamp(p, eps)).
__global__ void mas_log_kernel(const float* __restrict__ p, float* __restrict__ out,
                               long long n, float eps) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x)
    out[e] = mas_log(p[e], eps);
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return cached[dev];
}

template <int K, bool GBITS>
cudaError_t launch(const float* attn, const int* in_lens, const int* out_lens,
                   float* out, void* scratch, int b, int t_m, int t_s,
                   float eps, cudaStream_t stream) {
  const long long bytes = GBITS ? layout(t_m, K).bits_off : layout(t_m, K).bytes;
  static int opted[64] = {};                      // bytes opted into, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024 && (dev >= 64 || opted[dev] < bytes)) {
    err = cudaFuncSetAttribute(mas_kernel<K, GBITS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = static_cast<int>(bytes);
  }
  // log blocks: the SMs the chain blocks leave, at least 8
  const long long nq = n_flags(t_m, K) - 1;
  const long long items = (nq > kFillChunks ? nq - kFillChunks : 0) * b + b;
  long long n_log = sm_count() - b;
  if (n_log < 8) n_log = 8;
  if (n_log > items) n_log = items;
  // the flags and the ticket start at zero
  float* logs = static_cast<float*>(scratch);
  unsigned* flags = reinterpret_cast<unsigned*>(logs + b * scratch_floats(t_m, K));
  unsigned* ticket = flags + b * n_flags(t_m, K);
  err = cudaMemsetAsync(flags, 0, (b * n_flags(t_m, K) + 1) * sizeof(unsigned),
                        stream);
  if (err != cudaSuccess) return err;
  mas_kernel<K, GBITS><<<static_cast<unsigned>(n_log + b), Cfg<K>::threads,
                  static_cast<size_t>(bytes), stream>>>(
      attn, in_lens, out_lens, out, logs, flags, ticket, b,
      static_cast<int>(n_log), t_m, t_s, eps);
  return cudaGetLastError();
}


cudaError_t launch_wide(const float* attn, const int* in_lens,
                        const int* out_lens, float* out, void* scratch, int b,
                        int t_m, int t_s, float eps, cudaStream_t stream) {
  const int w = wide_warps(t_s);
  const long long bytes = wide_layout(w).bytes;
  static int opted[64] = {};                      // bytes opted into, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024 && (dev >= 64 || opted[dev] < bytes)) {
    err = cudaFuncSetAttribute(mas_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = static_cast<int>(bytes);
  }
  const long long rows = wide_rows(t_m, w);
  const long long nq = rows / chunk_steps(kWideK);
  const long long items = nq * b + b;
  long long n_log = sm_count() - b;
  if (n_log < 8) n_log = 8;
  if (n_log > items) n_log = items;
  float* logs = static_cast<float*>(scratch);
  unsigned* flags = reinterpret_cast<unsigned*>(logs + b * rows * 1024 * w);
  unsigned* ticket = flags + b * (nq + 1);
  err = cudaMemsetAsync(flags, 0, (b * (nq + 1) + 1) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  mas_wide_kernel<<<static_cast<unsigned>(n_log + b), 256,
                    static_cast<size_t>(bytes), stream>>>(
      attn, in_lens, out_lens, out, logs, flags, ticket, b,
      static_cast<int>(n_log), t_m, t_s, eps);
  return cudaGetLastError();
}

}  // namespace

// Columns a lane of the chain warp owns at T_s (the K of the instance run).
extern "C" int ctts_mas_cols_per_lane(int t_s) { return cols_per_lane(t_s); }

// Bytes of shared memory a chain block of the warp kernel needs for
// [t_m, t_s] (its ring and its move bits).
extern "C" long long ctts_mas_shared_bytes(long long t_m, long long t_s) {
  return layout(t_m, cols_per_lane(static_cast<int>(t_s))).bytes;
}

// The kernel a shape takes: 0 the warp kernel, 1 the long route, 2 the
// warp kernel with its move words in device memory, 3 the wide kernel.
extern "C" int ctts_mas_route(long long t_m, long long t_s) {
  return mas_route(t_m, t_s);
}

// Bytes of device scratch a call needs for [b, t_m, t_s]: for the warp
// kernel the logarithms in step rows, the flags and the ticket (and, with
// its move words in device memory, those past them); for the long route
// the move words, then the rows where shared memory cannot hold them.
extern "C" long long ctts_mas_scratch_bytes(long long b, long long t_m,
                                            long long t_s) {
  const int route = mas_route(t_m, t_s);
  if (route == 1)
    return b * t_m * rows_words(t_s) * 4 + (rows_shared(t_s) ? 0 : b * 2 * t_s * 4);
  if (route == 3) {
    const int w = wide_warps(t_s);
    return wide_moves_off(b, t_m, w) + b * wide_rows(t_m, w) / kWarp * 1024 * w * 4;
  }
  const int k = cols_per_lane(static_cast<int>(t_s));
  if (route == 2) return moves_off(b, t_m, k) + b * chain_rows(t_m) * k * 4;
  return b * (scratch_floats(t_m, k) + n_flags(t_m, k)) * 4 + 4;
}

// attn [B, T_m, T_s] float32 probabilities, in_lens/out_lens [B] int32, out
// [B, T_m, T_s] float32 (every element is written), scratch of
// ctts_mas_scratch_bytes (16-byte aligned, any content; the warp kernel's
// launch zeroes its flags and ticket on the stream first). Any shape: the
// kernel mas_route picks. Returns a cudaError_t (0 = launched).
extern "C" int ctts_mas(const float* attn, const int* in_lens,
                        const int* out_lens, float* out, void* scratch, int b,
                        int t_m, int t_s, float eps, void* stream) {
  if (b < 0 || t_m < 0 || t_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || t_s == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = mas_route(t_m, t_s);
  if (route == 1) {
    unsigned* moves = static_cast<unsigned*>(scratch);
    float* rows = nullptr;
    size_t bytes = 0;
    if (rows_shared(t_s)) {
      bytes = 2 * static_cast<size_t>(t_s) * sizeof(float);
      if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            mas_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return err;
      }
    } else {
      rows = reinterpret_cast<float*>(moves + static_cast<long long>(b) * t_m *
                                                  rows_words(t_s));
    }
    mas_rows_kernel<<<b, rows_threads(t_s), bytes, s>>>(
        attn, in_lens, out_lens, out, moves, rows, t_m, t_s, eps);
    return cudaGetLastError();
  }
  if (route == 3)
    return launch_wide(attn, in_lens, out_lens, out, scratch, b, t_m, t_s, eps, s);
  switch (cols_per_lane(t_s)) {
#define CTTS_MAS_CASE(K)                                                     \
    case K:                                                                  \
      return route == 0                                                      \
          ? launch<K, false>(attn, in_lens, out_lens, out, scratch, b, t_m,  \
                             t_s, eps, s)                                    \
          : launch<K, true>(attn, in_lens, out_lens, out, scratch, b, t_m,   \
                            t_s, eps, s);
    CTTS_MAS_CASE(1) CTTS_MAS_CASE(2) CTTS_MAS_CASE(3) CTTS_MAS_CASE(4)
    CTTS_MAS_CASE(6) CTTS_MAS_CASE(8) CTTS_MAS_CASE(12) CTTS_MAS_CASE(16)
    CTTS_MAS_CASE(24) CTTS_MAS_CASE(32)
#undef CTTS_MAS_CASE
    default: return cudaErrorInvalidValue;
  }
}

// out[e] = the kernel's logf(max(p[e], eps)) for e < n.
extern "C" int ctts_mas_log(const float* p, float* out, long long n, float eps,
                            void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + 255) / 256;
  mas_log_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(p, out, n, eps);
  return cudaGetLastError();
}
