// The CTC lattice of the ForwardSum alignment loss, for Hopper: the alpha
// and beta recursions in one launch (forward), and the gradient as one
// elementwise pass (backward).
//
// Replaces the Pallas pair ctts_tpu/ops/forward_sum.py:157 (_ctc_fwd_kernel)
// and :196 (_ctc_bwd_kernel) behind the custom VJP _ctc_state_nll_padded
// (:261). There the batch rides one sequential grid in frame chunks, the
// states are padded to 128 lanes and the transitions are lane rotates, and
// the backward runs the beta recursion before it can emit the gradient.
// Here beta needs only em and the lengths, not the cotangent, so the
// forward runs both chains side by side and the backward is elementwise.
//
// The lattice: state s is the blank for even s and label (s+1)/2 for odd s.
// alpha[t, s] = logsumexp(alpha[t-1, s], alpha[t-1, s-1], alpha[t-1, s-2] if
// s is odd and >= 3) + em[t, s]; frame 0 holds em[0, s] at s in {0, 1} and
// the sentinel elsewhere; frames at or past out_len copy the frozen row.
// beta[t, s] = logsumexp over q = em[t+1] + beta[t+1] at s, s+1 and s+2 if
// s is odd; frames at or past out_len - 1 hold the final row, 0 at
// {2*in_len, 2*in_len - 1} and the sentinel elsewhere. The gradient is
// d(-logL)/d em[t, s] = -exp(alpha[t, s] + beta[t, s] - logL), times the
// cotangent, zero at or past out_len. The sentinel is -1e9 and the
// log-sum-exp is written max-first, as in the reference.
//
// What bounds them on the H100: by bytes the Pallas pair's function reads
// em below out_len and writes alpha (2 * B*T_m*S*4 at most, 29 MB at B=16,
// T_m=896, S=257: 9 us at 3.35 TB/s; beta, written here, is the Pallas
// backward's on-chip state, so it is not counted), and the gradient reads
// two lattices below out_len and writes every row (44 MB, 13 us). What
// binds the lattice is its chain of T_m dependent frames; the gradient is
// bound by bytes.
//
// Design of the lattice: 2*B blocks, alpha in blocks [0, B) and beta in
// blocks [B, 2B) (B blocks, alpha alone, where no gradient is wanted), one
// utterance each, one thread per state up to S = 640. A frame's row
// (alpha; beta's q = em + beta) goes into a shared double buffer, so a
// frame needs one __syncthreads(); em is read kChunk frames ahead, off the
// chain. Each log-sum-exp is the plain version's, m + log(exp(a - m) +
// exp(b - m) + exp(c - m)) with an absent input at the sentinel, in its
// order and with the full-precision expf and logf (the file is built
// without fast-math), so the lattices and the gradient are the plain
// version's bits on the card. Of the layouts measured at the train shape
// (PERF.md §6) this one was the fastest: two states a thread with
// the neighbours' values by warp shuffles and edge slots took 1.19x its
// time, one state a thread by shuffles 1.12x; a log2-domain lattice with
// ex2.approx and lg2.approx was slower still and moved the gradient by
// 6.0e-3 of its largest entry, past CTC_GRAD_TOL against the plain
// version.
//
// Past kClusterFrom = 640 states (a text axis past 319 tokens; one block
// a chain up to there, measured faster) a chain runs on a thread
// block cluster of up to kClusterMax CTAs (the portable maximum), one
// cluster a chain, so the long step's 8 chains take 64 SMs instead of 8 and
// each SM issues an eighth of a frame's log-sum-exps. CTA r owns the
// contiguous tile of states [r*tile, r*tile + tile) and computes, beside
// it, the kGhost = 2*kSpan "ghost" states just upstream of it (alpha's
// left, beta's right): a state at frame t needs two states upstream at
// t-1, so with the ghosts a CTA runs kSpan frames on its own and needs its
// upstream neighbour only once every kSpan frames, for that neighbour's
// kGhost edge states. Cell q of a row holds position p = q - kGhost along
// the chain's direction (alpha: s = lo + p; beta: s = hi - 1 - p), so alpha
// and beta read the same cells: the own value at q, the neighbour at q - 1
// and the skip at q - 2. kSpan frames after a handoff the ghosts are spent
// (cell q is valid k frames on only for q >= 2k) and the next handoff
// refills them. A handoff goes over distributed shared memory: each of the
// kGhost edge threads stores its state into the downstream CTA's halo ring
// with st.async, which counts its 4 bytes on that CTA's "full" mbarrier
// for the slot; warp 0 of the receiving CTA waits on it, copies the slot
// into its row, re-arms it and hands it back by one st.async onto the
// sender's "empty" mbarrier. No thread issues a release fence or a remote
// arrive in the frame loop, and there is no cluster-wide barrier a frame:
// the cluster runs as a pipeline, kHalo handoffs deep, with one
// __syncthreads() a frame inside each CTA. (PERF.md has the handoffs the
// measurements compared: one cluster barrier a frame, and a remote
// mbarrier arrive or an st.async every frame without ghosts.) A ghost is
// the same expression on the same inputs as the state it copies, so the
// lattices stay the plain version's bits. em never waits on the chain:
// each thread stages its own cells of em kEmRing - 1 frames ahead into a
// shared ring by 4-byte cp.async (em's rows start at odd multiples of 4
// bytes, which no 16-byte bulk copy takes), one commit group a frame.
// Frozen and final rows are written after the chain, off it; every CTA of a
// cluster runs the same frames, and a final cluster barrier keeps each
// CTA's shared memory alive until no neighbour can write into it. Where
// the rows and the ring do not fit one CTA's shared memory the ring goes
// (em is read on the chain), and past that the rows move to a device
// scratch of the same layout. A cluster that cannot be resident
// (cudaOccupancyMaxActiveClusters) fails the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kChunk = 8;                // frames of em read ahead
constexpr int kMaxThreads = 1024;        // a block's threads
constexpr long long kMaxShared = 232448; // bytes one block may use on sm_90
constexpr int kClusterMax = 8;           // CTAs a cluster chain (portable)
// states past which a cluster chain beats one block: measured on the H100
// at 577 states (one block faster) and 641-1023 (the cluster faster; PERF.md)
constexpr int kClusterFrom = 640;
constexpr int kEmRing = 8;               // cluster: frames of em in the ring
constexpr int kSpan = 8;                 // cluster: frames a handoff covers
constexpr int kGhost = 2 * kSpan;        // cluster: ghost states a CTA
constexpr int kHalo = 8;                 // cluster: handoffs in flight

// the plain version's log-sum-exp (_lse3), term for term
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// em[t, s], or the sentinel where s is no state
__device__ __forceinline__ float em_at(const float* eb, int t, int s, int n_s) {
  return s < n_s ? eb[static_cast<size_t>(t) * n_s + s] : kNeg;
}

// alpha of utterance b, thread s owning state s: frame t reads frame t-1's
// row from the shared buffer of its parity; frames 0 .. olen-1 by the
// recursion, the rest frozen
__device__ void alpha_chain(const float* __restrict__ eb, float* __restrict__ ab,
                            int olen, int t_m, int n_s, float* rows) {
  const int s = threadIdx.x, n = blockDim.x;
  const bool active = s < n_s, skip = (s & 1) && s >= 3;
  float a = (s < 2 && active) ? eb[s] : kNeg;
  rows[s] = a;
  if (active) ab[s] = a;
  __syncthreads();
  float ahead[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = 1 + c;
    ahead[c] = t < olen ? em_at(eb, t, s, n_s) : 0.f;
  }
  for (int t0 = 1; t0 < olen; t0 += kChunk) {
    float cur[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cur[c] = ahead[c];
      const int t = t0 + kChunk + c;
      ahead[c] = t < olen ? em_at(eb, t, s, n_s) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      if (t >= olen) break;
      const float* prev = rows + ((t - 1) & 1) * n;
      const float p1 = s >= 1 ? prev[s - 1] : kNeg;
      const float p2 = skip ? prev[s - 2] : kNeg;
      a = lse3(a, p1, p2) + cur[c];
      rows[(t & 1) * n + s] = a;
      if (active) ab[static_cast<size_t>(t) * n_s + s] = a;
      __syncthreads();
    }
  }
  if (active)
    for (int t = max(olen, 1); t < t_m; ++t) ab[static_cast<size_t>(t) * n_s + s] = a;
}

// beta of utterance b, thread s owning state s: frame t reads q = em[t+1]
// + beta[t+1] of states s+1 and s+2 from the shared buffer of its parity;
// the recursion below frame olen-1, the final row from there on (written
// after the chain, so that the chain starts at once)
__device__ void beta_chain(const float* __restrict__ eb, float* __restrict__ bb,
                           int ilen, int olen, int t_m, int n_s, float* rows) {
  const int s = threadIdx.x, n = blockDim.x;
  const bool active = s < n_s, can2 = (s & 1) && s + 2 < n_s, can1 = s + 1 < n_s;
  const int last = 2 * ilen;
  float bt = (active && (s == last || s == last - 1)) ? 0.f : kNeg;
  if (olen < 2) {
    if (active)
      for (int t = 0; t < t_m; ++t) bb[static_cast<size_t>(t) * n_s + s] = bt;
    return;
  }
  float q = em_at(eb, olen - 1, s, n_s) + bt;
  rows[((olen - 2) & 1) * n + s] = q;
  __syncthreads();
  const float fin = bt;
  float ahead[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = olen - 2 - c;
    ahead[c] = t >= 0 ? em_at(eb, t, s, n_s) : 0.f;
  }
  for (int t0 = olen - 2; t0 >= 0; t0 -= kChunk) {
    float cur[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cur[c] = ahead[c];
      const int t = t0 - kChunk - c;
      ahead[c] = t >= 0 ? em_at(eb, t, s, n_s) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 - c;
      if (t < 0) break;
      const float* next = rows + (t & 1) * n;
      bt = lse3(q, can1 ? next[s + 1] : kNeg, can2 ? next[s + 2] : kNeg);
      if (active) bb[static_cast<size_t>(t) * n_s + s] = bt;
      q = cur[c] + bt;                  // at t = 0 unused: one branch less
      rows[((t - 1) & 1) * n + s] = q;
      __syncthreads();
    }
  }
  if (active)
    for (int t = olen - 1; t < t_m; ++t) bb[static_cast<size_t>(t) * n_s + s] = fin;
}

// ---- the cluster lattice (S > 640) --------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// The address of this CTA's shared `p` in the shared memory of CTA `rank`.
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// 4 bytes into another CTA's shared memory, counted on completion as 4
// transaction bytes on that CTA's mbarrier `bar`; the thread does not wait.
__device__ __forceinline__ void peer_store_tx(uint32_t addr, float v,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// This thread's arrival on a local mbarrier, with `bytes` transaction bytes
// that the phase waits for.
__device__ __forceinline__ void bar_arm(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Wait for the phase of the given parity (the st.async data counted on it
// visible), acquiring at cluster scope. (A CTA-scope acquire measured the
// same: PERF.md.)
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory of a cluster CTA: the halo ring's full and empty mbarriers,
// its kHalo slots of kGhost floats and the kHalo floats the receiver's
// hand-backs land in, the two rows (kGhost + tile floats each; in the device
// scratch where they do not fit), then the em ring (kEmRing rows alike).
struct ClusterLayout {
  long long rows_off, ring_off, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(long long tile,
                                                        bool rows_shared,
                                                        bool ring) {
  ClusterLayout l;
  l.rows_off = 2 * kHalo * 8 + (kGhost + 1) * kHalo * 4;
  l.ring_off = l.rows_off + (rows_shared ? 2 * (kGhost + tile) * 4 : 0);
  l.bytes = l.ring_off + (ring ? kEmRing * (kGhost + tile) * 4 : 0);
  return l;
}

// One chain (alpha or beta of one utterance) over the cluster; see the head
// of the file. RING: em staged in the shared ring, else read on the chain.
// `rows`: this CTA's two rows.
template <bool BETA, bool RING>
__device__ __forceinline__ void cluster_chain(
    const float* __restrict__ eb, float* __restrict__ out, int ilen, int olen,
    int t_m, int n_s, int tile, float* rows, unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kHalo;
  float* halo = reinterpret_cast<float*>(empty + kHalo);
  float* ack = halo + kHalo * kGhost;
  float* ring = reinterpret_cast<float*>(smem + cluster_layout(tile, true, false).ring_off);
  const int rank = cluster_rank(), n_cta = cluster_ctas();
  const int lo = rank * tile, nt = min(tile, n_s - lo), w = kGhost + tile;
  const int nq = kGhost + nt, tid = threadIdx.x, n = blockDim.x;
  const int last = 2 * ilen;
  // alpha: frames 1 .. max(olen,1)-1; beta: olen-2 .. 0 (none below 2)
  const int steps = BETA ? (olen >= 2 ? olen - 1 : 0) : max(olen, 1) - 1;
  // handoffs after steps kSpan, 2*kSpan, .. below `steps` (step 0's ghosts
  // are computed here)
  const int n_hand = steps > 0 ? (steps - 1) / kSpan : 0;
  const int to = BETA ? rank - 1 : rank + 1, from = BETA ? rank + 1 : rank - 1;
  const bool sends = to >= 0 && to < n_cta, receives = from >= 0 && from < n_cta;
  // the first cell this CTA computes: ghosts only where a CTA is upstream
  const int q0 = receives ? 0 : kGhost;
  auto state = [&](int q) {
    return BETA ? lo + nt - 1 - (q - kGhost) : lo + q - kGhost;
  };
  auto frame = [&](int j) { return BETA ? olen - 1 - j : j; };
  // em of step j into ring slot j % kEmRing; one commit group a step
  auto stage = [&](int j) {
    if (j <= steps)
      for (int q = q0 + tid; q < nq; q += n)
        cp_async4(ring + (j % kEmRing) * w + q,
                  eb + static_cast<size_t>(frame(j)) * n_s + state(q));
    cp_commit();
  };

  if (!receives)                                  // no CTA upstream
    for (int q = tid; q < kGhost; q += n) rows[q] = rows[w + q] = kNeg;
  if (tid == 0) {
    for (int j = 0; j < kHalo; ++j) {
      bar_init(&full[j], 1);
      bar_init(&empty[j], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kHalo; ++j) {
      bar_arm(&full[j], kGhost * 4);             // the kGhost edge states
      bar_arm(&empty[j], 4);                     // the receiver's hand-back
    }
  }
  if (RING)
    for (int j = 1; j < kEmRing; ++j) stage(j);
  cluster_sync();

  // step 0: alpha's frame 0, beta's q of frame olen-1, ghosts included
  if (!BETA || olen >= 2) {
    for (int q = q0 + tid; q < nq; q += n) {
      const int s = state(q);
      float v;
      if (BETA) {
        v = eb[static_cast<size_t>(olen - 1) * n_s + s] +
            ((s == last || s == last - 1) ? 0.f : kNeg);
      } else {
        v = s < 2 ? eb[s] : kNeg;
        if (q >= kGhost) out[s] = v;
      }
      rows[q] = v;
    }
  }
  __syncthreads();

  for (int j = 1; j <= steps; ++j) {
    float* prev = rows + ((j - 1) & 1) * w;
    float* cur = rows + (j & 1) * w;
    const int j0 = (j - 1) / kSpan * kSpan;      // the last handoff's step
    if (receives && j0 > 0 && j == j0 + 1 && tid < 32) {
      // handoff u: the upstream CTA's kGhost edge states of step j0
      const int u = j0 / kSpan - 1, slot = u % kHalo;
      if (tid < kGhost) {
        bar_wait(&full[slot], (u / kHalo) & 1);
        prev[tid] = halo[slot * kGhost + tid];
      }
      __syncwarp();
      if (tid == 0) {
        bar_arm(&full[slot], kGhost * 4);        // the slot's next use
        // handed back where the sender reuses the slot (no st.async is
        // then in flight when the cluster ends)
        if (u + kHalo < n_hand)
          peer_store_tx(peer(&ack[slot], from), prev[0],
                        peer(&empty[slot], from));
      }
      __syncwarp();
    }
    // cell q is valid k = j - j0 frames after the handoff for q >= 2k
    const int q_lo = receives ? 2 * (j - j0) : kGhost;
    const bool hand = sends && j % kSpan == 0 && j < steps;
    const int u = j / kSpan - 1, slot = u % kHalo;
    if (RING) cp_wait<kEmRing - 2>();
    const int t = frame(j);
    const float* et = eb + static_cast<size_t>(t) * n_s;
    float* ot = out + static_cast<size_t>(t) * n_s;
    for (int q = q0 + tid; q < nq; q += n) {
      if (q < q_lo) continue;
      const int s = state(q);
      const float e = RING ? ring[(j % kEmRing) * w + q] : et[s];
      const bool two = BETA ? (s & 1) : ((s & 1) && s >= 3);
      const float x = lse3(prev[q], prev[q - 1], two ? prev[q - 2] : kNeg);
      float v;
      if (BETA) {
        if (q >= kGhost) ot[s] = x;
        v = e + x;                         // at t = 0 unused: one branch less
      } else {
        v = x + e;
        if (q >= kGhost) ot[s] = v;
      }
      cur[q] = v;
      if (hand && q >= nt) {               // an edge state, downstream
        if (u >= kHalo) {                  // the slot's use u - kHalo read
          bar_wait(&empty[slot], ((u / kHalo) - 1) & 1);
          if (q == nq - 1) bar_arm(&empty[slot], 4);
        }
        peer_store_tx(peer(&halo[slot * kGhost + q - nt], to), v,
                      peer(&full[slot], to));
      }
    }
    if (RING) stage(j + kEmRing - 1);
    __syncthreads();
  }
  if (RING) cp_wait<0>();

  // the frozen (alpha) and final (beta) rows, after the chain
  for (int q = kGhost + tid; q < nq; q += n) {
    const int s = state(q);
    if (BETA) {
      const float fin = (s == last || s == last - 1) ? 0.f : kNeg;
      for (int t = olen >= 2 ? olen - 1 : 0; t < t_m; ++t)
        out[static_cast<size_t>(t) * n_s + s] = fin;
    } else {
      const float a = rows[(steps & 1) * w + q];
      for (int t = steps + 1; t < t_m; ++t)
        out[static_cast<size_t>(t) * n_s + s] = a;
    }
  }
  cluster_sync();   // no neighbour writes into this CTA's memory past here
}

__device__ __forceinline__ void lattice_block(
    const float* __restrict__ em, const int* __restrict__ in_lens,
    const int* __restrict__ out_lens, float* __restrict__ alpha,
    float* __restrict__ beta, int n_b, int t_m, int n_s) {
  extern __shared__ float rows[];        // two rows of the chain
  const bool is_beta = static_cast<int>(blockIdx.x) >= n_b;
  const int b = is_beta ? blockIdx.x - n_b : blockIdx.x;
  const int olen = min(max(out_lens[b], 0), t_m);
  const size_t at = static_cast<size_t>(b) * t_m * n_s;
  if (is_beta)
    beta_chain(em + at, beta + at, in_lens[b], olen, t_m, n_s, rows);
  else
    alpha_chain(em + at, alpha + at, olen, t_m, n_s, rows);
}

// Blocks of up to 512 threads (the train shape's S = 257 takes 288) run
// without a launch bound: the chain takes 71 registers, and a bound
// (even one that 71 fits) made nvcc cut them to 40 and the chain 8 %
// slower. Past 512 threads a block must fit the SM's 65536 registers at up
// to 1024 threads (S <= 1024), 64 a thread: that instance has the bound.
__global__ void ctc_lattice_kernel(const float* __restrict__ em,
                                   const int* __restrict__ in_lens,
                                   const int* __restrict__ out_lens,
                                   float* __restrict__ alpha,
                                   float* __restrict__ beta, int n_b, int t_m,
                                   int n_s) {
  lattice_block(em, in_lens, out_lens, alpha, beta, n_b, t_m, n_s);
}

__global__ void __launch_bounds__(1024)
ctc_lattice_kernel_1024(const float* __restrict__ em,
                        const int* __restrict__ in_lens,
                        const int* __restrict__ out_lens,
                        float* __restrict__ alpha, float* __restrict__ beta,
                        int n_b, int t_m, int n_s) {
  lattice_block(em, in_lens, out_lens, alpha, beta, n_b, t_m, n_s);
}

// Past 640 states: a cluster a chain (blocks [0, B*C) alpha, [B*C, 2B*C)
// beta, C CTAs each), tile = ceil(S/C) states a CTA.
template <bool RING>
__global__ void __launch_bounds__(kMaxThreads)
ctc_cluster_kernel(const float* __restrict__ em,
                   const int* __restrict__ in_lens,
                   const int* __restrict__ out_lens, float* __restrict__ alpha,
                   float* __restrict__ beta, int n_b, int t_m, int n_s,
                   int tile, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chain = blockIdx.x / cluster_ctas();
  const bool is_beta = chain >= n_b;
  const int b = is_beta ? chain - n_b : chain;
  const int olen = min(max(out_lens[b], 0), t_m);
  const size_t at = static_cast<size_t>(b) * t_m * n_s;
  float* rows =
      (RING || scratch == nullptr)
          ? reinterpret_cast<float*>(smem + cluster_layout(tile, true, false).rows_off)
          : scratch + 2LL * (kGhost + tile) * blockIdx.x;
  if (is_beta)
    cluster_chain<true, RING>(em + at, beta + at, in_lens[b], olen, t_m, n_s,
                              tile, rows, smem);
  else
    cluster_chain<false, RING>(em + at, alpha + at, in_lens[b], olen, t_m,
                               n_s, tile, rows, smem);
}

// The elementwise gradient; I is unsigned below 2^31 elements (the train
// shape's instance), size_t past it.
template <typename I>
__global__ void ctc_grad_kernel(const float* __restrict__ alpha,
                                const float* __restrict__ beta,
                                const float* __restrict__ log_l,
                                const float* __restrict__ g_out,
                                const int* __restrict__ out_lens,
                                float* __restrict__ dem, I t_m,
                                I n_s, I total) {
  const I idx = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const I row = idx / n_s, b = row / t_m;
  const int t = static_cast<int>(row - b * t_m);
  dem[idx] = t < out_lens[b]
                 ? -expf(alpha[idx] + beta[idx] - log_l[b]) * g_out[b]
                 : 0.f;
}

// The cluster lattice's shape for S states over c CTAs: states a CTA,
// threads a CTA (one cell, a state or a ghost, a thread up to 1024; whole
// warps), and whether its rows and its em ring, or its rows alone, fit
// shared memory.
int cluster_tile(int n_s, int c) { return (n_s + c - 1) / c; }
int cluster_threads(int tile) {
  const int cells = kGhost + tile;
  const int k = (cells + kMaxThreads - 1) / kMaxThreads;
  return ((cells + k - 1) / k + 31) / 32 * 32;
}
bool cluster_ring(int tile) {
  return cluster_layout(tile, true, true).bytes <= kMaxShared;
}
bool cluster_rows_shared(int tile) {
  return cluster_layout(tile, true, false).bytes <= kMaxShared;
}

// The kernel S states take: 0 ctc_lattice_kernel, 1 ctc_lattice_kernel_1024,
// 2 the cluster kernel with its em ring, 3 the cluster kernel without.
int route(int n_s) {
  if (n_s <= kClusterFrom) return (n_s + 31) / 32 * 32 <= 512 ? 0 : 1;
  return cluster_ring(cluster_tile(n_s, kClusterMax)) ? 2 : 3;
}

int device_id() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// One launch of the cluster lattice: `ctas` CTAs a chain (1..kClusterMax,
// each tile at least kGhost states), checked to be resident first.
template <bool RING>
cudaError_t launch_cluster(const float* em, const int* in_lens,
                           const int* out_lens, float* alpha, float* beta,
                           int b, int t_m, int n_s, float* scratch, int ctas,
                           cudaStream_t stream) {
  const int tile = cluster_tile(n_s, ctas);
  const bool rows_shared = RING || cluster_rows_shared(tile);
  const long long bytes = cluster_layout(tile, rows_shared, RING).bytes;
  if (!rows_shared && scratch == nullptr) return cudaErrorInvalidValue;
  const auto kernel = ctc_cluster_kernel<RING>;
  static int opted[64] = {};                      // bytes opted into, per device
  const int dev = device_id();
  if (bytes > 48 * 1024 && (dev < 0 || dev >= 64 || opted[dev] < bytes)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) opted[dev] = static_cast<int>(bytes);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((beta ? 2 * b : b) * ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(cluster_threads(tile)));
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of this shape must fit the card; one that cannot is an error,
  // never a smaller cluster (checked once per shape and device)
  static long long checked[64] = {};
  const long long key = (bytes << 16) ^ (cfg.blockDim.x << 4) ^ ctas;
  if (dev < 0 || dev >= 64 || checked[dev] != key) {
    int resident = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
    if (dev >= 0 && dev < 64) checked[dev] = key;
  }
  float* rows = rows_shared ? nullptr : scratch;
  return cudaLaunchKernelEx(&cfg, kernel, em, in_lens, out_lens, alpha, beta,
                            b, t_m, n_s, tile, rows);
}

cudaError_t lattice_cluster(const float* em, const int* in_lens,
                            const int* out_lens, float* alpha, float* beta,
                            int b, int t_m, int n_s, float* scratch, int ctas,
                            cudaStream_t stream) {
  if (ctas < 1 || ctas > kClusterMax) return cudaErrorInvalidValue;
  const int tile = cluster_tile(n_s, ctas);
  if (n_s - (ctas - 1) * tile < kGhost) return cudaErrorInvalidValue;
  return cluster_ring(tile)
             ? launch_cluster<true>(em, in_lens, out_lens, alpha, beta, b, t_m,
                                    n_s, scratch, ctas, stream)
             : launch_cluster<false>(em, in_lens, out_lens, alpha, beta, b,
                                     t_m, n_s, scratch, ctas, stream);
}

}  // namespace

// The kernel a lattice of S states takes (route above), and the CTAs a
// chain of the cluster kernel (0 for the one-block instances).
extern "C" int ctts_ctc_route(int n_s) { return route(n_s); }
extern "C" int ctts_ctc_cluster_ctas(int n_s) {
  return n_s <= kClusterFrom ? 0 : kClusterMax;
}

// Bytes of global scratch a lattice of S states needs for n_chains chains
// (2B, or B for alpha alone): 0 where its rows fit shared memory. `ctas`:
// the CTAs a chain (0: as the route picks).
extern "C" long long ctts_ctc_scratch_bytes(long long n_chains, int n_s,
                                            int ctas) {
  if (ctas <= 0) ctas = n_s <= kClusterFrom ? 1 : kClusterMax;
  if (n_s <= kMaxThreads && ctas == 1) return 0;
  const int tile = cluster_tile(n_s, ctas);
  if (cluster_rows_shared(tile)) return 0;
  return n_chains * ctas * 2 * (kGhost + static_cast<long long>(tile)) *
         static_cast<long long>(sizeof(float));
}

// em [B, T_m, S] float32 state log-emissions, in_lens and out_lens [B]
// int32, alpha and beta [B, T_m, S] float32 (every element is written).
// A null beta launches the alpha chains alone (no gradient to come).
// scratch: ctts_ctc_scratch_bytes of device memory (null where that is
// 0). Any S. Returns a cudaError_t (0 = launched).
extern "C" int ctts_ctc_lattice(const float* em, const int* in_lens,
                                const int* out_lens, float* alpha,
                                float* beta, int b, int t_m, int n_s,
                                float* scratch, void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  if (n_s <= kClusterFrom) {
    const int threads = (n_s + 31) / 32 * 32;
    const auto kernel =
        threads <= 512 ? ctc_lattice_kernel : ctc_lattice_kernel_1024;
    kernel<<<beta ? 2 * b : b, threads, (2 * threads + 2) * sizeof(float),
             static_cast<cudaStream_t>(stream)>>>(
        em, in_lens, out_lens, alpha, beta, b, t_m, n_s);
    return cudaGetLastError();
  }
  return lattice_cluster(em, in_lens, out_lens, alpha, beta, b, t_m, n_s,
                         scratch, kClusterMax,
                         static_cast<cudaStream_t>(stream));
}

// The cluster lattice at a chosen cluster size (1..8 CTAs a chain, each
// tile at least kGhost states), at any S: for the tests and for measuring
// it where the route keeps the one-block instances. The wrapper's route
// never calls it.
extern "C" int ctts_ctc_lattice_cluster(const float* em, const int* in_lens,
                                        const int* out_lens, float* alpha,
                                        float* beta, int b, int t_m, int n_s,
                                        float* scratch, int ctas,
                                        void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  return lattice_cluster(em, in_lens, out_lens, alpha, beta, b, t_m, n_s,
                         scratch, ctas, static_cast<cudaStream_t>(stream));
}

// dem[b, t, s] = -exp(alpha + beta - log_l[b]) * g_out[b] below out_lens[b],
// 0 at or past it (every element is written). Same shapes as
// ctts_ctc_lattice; log_l, g_out [B] float32.
extern "C" int ctts_ctc_grad(const float* alpha, const float* beta,
                             const float* log_l, const float* g_out,
                             const int* out_lens, float* dem, int b, int t_m,
                             int n_s, void* stream) {
  if (b < 0 || t_m < 0 || n_s < 0) return cudaErrorInvalidValue;
  if (b == 0 || t_m == 0 || n_s == 0) return cudaSuccess;
  const size_t total = static_cast<size_t>(b) * t_m * n_s;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  const auto st = static_cast<cudaStream_t>(stream);
  if (total < (1u << 31))
    ctc_grad_kernel<unsigned><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        alpha, beta, log_l, g_out, out_lens, dem, t_m, n_s,
        static_cast<unsigned>(total));
  else
    ctc_grad_kernel<size_t><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        alpha, beta, log_l, g_out, out_lens, dem, t_m, n_s, total);
  return cudaGetLastError();
}
