// Spawn placement: the reset's candidate draw and the in-turn placement of
// every env's agents, in one launch for the whole batch.
//
// The port's counterpart of `env/reset.py::spawn_positions` (and of
// `_spawn_positions_compact`, which runs it over the resetting envs only);
// the JAX package does this step in XLA (`sigmarl_tpu/env/reset.py`), the
// plain PyTorch version in about 16 small operations per agent placed.
//
// Per env with a reset, from its row of candidate uniforms [N, T]:
// - candidate (n, t) takes path p = the idx-th valid path of the env's
//   scenario group, idx = min(int(u_path * n_valid), n_valid - 1) (inverse
//   CDF; path 0 where the group has none), and point id
//   3 + int(u_point * (end - 3)), end = max(min(n_points[p] / 2, w), 4),
//   where the testing mode's window w = 3 + (t + 1)(t + 2) / 2 grows with
//   the try t (elsewhere no window); its pose is long_term[p, point] and
//   center_line_yaw[p, point];
// - agents are placed in order n = 0..N-1: a candidate is feasible when
//   (cx - px)^2 + (cy - py)^2 >= min_d2 for every placed agent (the agents
//   without a reset count as placed from the start, at their previous
//   position); agent n takes its first feasible candidate, or candidate
//   T - 1 when none is, and keeps its previous position without a reset.
// Every agent's path id, point id and yaw are those of its chosen
// candidate, with or without a reset, as in the plain version.
//
// Rows: at full width (first < 0) env b reads row b of the draws and every
// env is placed, so every output equals the plain version's. Compacted
// (first >= 0), the s-th resetting env in env order reads row first + s,
// and an env without a reset keeps its previous positions with yaw, path
// and point id 0, as the plain compaction's scatter leaves them; the
// outputs are written at env b directly, with no gather or scatter.
//
// Bit for bit with the plain version: each difference, square and sum is
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn, as PyTorch's
// `diff * diff` then `.sum(-1)` over two terms round them), the threshold
// is the float32 that `dist2 >= min_d2` compares with, and every
// float-to-int conversion truncates toward zero as `.to(torch.int32)`
// does. A point id outside the table gives NaN poses instead of reading
// outside it; a scenario id outside the group table counts as a group
// without paths.
//
// What bounds it on an H100: its launch. The main path resets about 164 of
// 1024 envs a step (N = 15, T = 12): about 2,700 distance checks and 180
// candidate draws per env, some 3 MB of table and draw reads in all, a few
// microseconds of the card's time against a launch of similar length; the
// plain version took about 290 launches for the same work.
//
// Design: one warp per env, kWarps envs per block. The warp first draws all
// N x T candidates (lanes over candidates, independent loads) into shared
// memory, with the group's valid paths as ballot words in registers; then
// it places the agents in turn, lane t testing candidate t against the
// placed positions (a shared tile, read as broadcasts), and a ballot with
// __ffs picks the first feasible one. Compacted, each block first counts
// the resetting envs before its first env (the whole block over the mask),
// then the warps of the block in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // envs per block, one warp each
constexpr int kMaxTries = 32;    // candidates per agent: one lane each
constexpr int kMaxAgents = 32;   // placed agents as the bits of one word
constexpr int kMaxPathWords = 4; // valid paths of a group as ballot words: K <= 128
constexpr unsigned kFull = 0xffffffffu;

struct Sizes {
    int B, N, T, G, K, P;
    long long mask_sb, mask_sn;          // the reset mask's strides (elements)
    long long pos_sb, pos_sn, pos_sc;    // the previous positions' strides
    int first, count;            // compacted rows [first, first + count); first < 0: full width
    int testing;
    float min_d2;
};

// Bytes of one warp's shared memory, a multiple of 16: the candidates'
// positions [N * T] and the placed positions [N] (8-byte entries first),
// then the candidates' yaws, path and point ids [N * T] and the choices [N].
__host__ __device__ inline size_t warp_smem(int N, int T) {
    const size_t bytes = (size_t)(N * T + N) * sizeof(float2) + (size_t)(3 * N * T + N) * 4;
    return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ bool resets(const uint8_t* mask, const Sizes& s, int b, int n) {
    return mask[b * s.mask_sb + n * s.mask_sn] != 0;
}

__device__ __forceinline__ float2 prev(const float* pos, const Sizes& s, int b, int n) {
    const float* p = pos + b * s.pos_sb + n * s.pos_sn;
    return make_float2(p[0], p[s.pos_sc]);
}

// Whether env b has an agent with a reset.
__device__ __forceinline__ bool env_resets(const uint8_t* mask, const Sizes& s, int b) {
    for (int n = 0; n < s.N; ++n)
        if (resets(mask, s, b, n)) return true;
    return false;
}

// The n-th set bit of the words (n < their population).
__device__ __forceinline__ int nth_set_bit(const unsigned (&words)[kMaxPathWords], int n) {
#pragma unroll
    for (int w = 0; w < kMaxPathWords; ++w) {
        const int c = __popc(words[w]);
        if (n < c) {
            unsigned m = words[w];
            for (int i = 0; i < n; ++i) m &= m - 1u;
            return 32 * w + __ffs(m) - 1;
        }
        n -= c;
    }
    return 0;
}

__device__ __forceinline__ int floor_div2(int x) { return x >= 0 ? x / 2 : -((1 - x) / 2); }

__global__ void __launch_bounds__(32 * kWarps)
spawn_place_kernel(const float* __restrict__ path_u, const float* __restrict__ point_u,
                   const int* __restrict__ scenario_id, const float* __restrict__ prev_pos,
                   const uint8_t* __restrict__ mask, const uint8_t* __restrict__ group_mask,
                   const int* __restrict__ n_points, const float* __restrict__ long_term,
                   const float* __restrict__ yaw, float* __restrict__ pos_out,
                   float* __restrict__ rot_out, int* __restrict__ path_out,
                   int* __restrict__ point_out, const Sizes s) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int warp_before[kWarps], warp_any[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b0 = blockIdx.x * kWarps, b = b0 + warp;
    const int N = s.N, T = s.T, NT = s.N * s.T;
    const bool compact = s.first >= 0;

    // Lane n < N holds agent n (N <= 32); the agents with a reset.
    const bool live = b < s.B && lane < N;
    const unsigned todo = __ballot_sync(kFull, live && resets(mask, s, b, lane));

    int row = b;
    if (compact) {
        // This env's rank among the resetting envs: those before the
        // block's first env, then those of the warps before this one.
        int before = 0;
        for (int e = threadIdx.x; e < b0; e += blockDim.x) before += env_resets(mask, s, e);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(kFull, before, off);
        if (lane == 0) {
            warp_before[warp] = before;
            warp_any[warp] = todo != 0u;
        }
        __syncthreads();
        row = 0;
        for (int w = 0; w < kWarps; ++w) row += warp_before[w] + (w < warp ? warp_any[w] : 0);
    }
    if (b >= s.B) return;
    const long long at = (long long)b * N;
    float2* pos2 = reinterpret_cast<float2*>(pos_out) + at;
    if (compact && (todo == 0u || row >= s.count)) {
        if (lane < N) {
            pos2[lane] = prev(prev_pos, s, b, lane);
            rot_out[at + lane] = 0.0f;
            path_out[at + lane] = 0;
            point_out[at + lane] = 0;
        }
        return;
    }
    if (compact) row += s.first;

    unsigned char* mine = smem + warp * warp_smem(N, T);
    float2* c_pos = reinterpret_cast<float2*>(mine);
    float2* placed = c_pos + NT;
    float* c_yaw = reinterpret_cast<float*>(placed + N);
    int* c_path = reinterpret_cast<int*>(c_yaw + NT);
    int* c_point = c_path + NT;
    int* choice = c_point + NT;

    // The group's valid paths as ballot words.
    const int sid = scenario_id[b];
    const bool good_sid = sid >= 0 && sid < s.G;
    unsigned words[kMaxPathWords];
    int n_valid = 0;
#pragma unroll
    for (int w = 0; w < kMaxPathWords; ++w) {
        const int k = 32 * w + lane;
        const bool valid = good_sid && k < s.K && group_mask[(long long)sid * s.K + k];
        words[w] = __ballot_sync(kFull, valid);
        n_valid += __popc(words[w]);
    }
    const float nv = (float)n_valid;

    // Draw the candidates (n, t) = (i / T, i % T) of this env's row.
    const float* pu = path_u + (long long)row * NT;
    const float* qu = point_u + (long long)row * NT;
#pragma unroll 4
    for (int i = lane; i < NT; i += 32) {
        const int t = i % T;
        const int idx = min((int)__fmul_rn(pu[i], nv), n_valid - 1);
        const int p = (idx >= 0 && idx < n_valid) ? nth_set_bit(words, idx) : 0;
        int end = floor_div2(n_points[p]);
        if (s.testing) end = min(3 + floor_div2((t + 1) * (t + 2)), end);
        end = max(end, 4);
        const int q = 3 + (int)__fmul_rn(qu[i], (float)(end - 3));
        float2 xy = make_float2(nanf(""), nanf(""));
        float yw = nanf("");
        if (q >= 0 && q < s.P) {
            xy = reinterpret_cast<const float2*>(long_term)[(long long)p * s.P + q];
            yw = yaw[(long long)p * s.P + q];
        }
        c_pos[i] = xy;
        c_yaw[i] = yw;
        c_path[i] = p;
        c_point[i] = q;
    }
    // Every agent starts at its previous position; those without a reset
    // are placed from the start.
    if (lane < N) placed[lane] = prev(prev_pos, s, b, lane);
    unsigned done = ~todo & (N == 32 ? kFull : (1u << N) - 1u);
    __syncwarp();

    // Place the agents in turn.
    for (int n = 0; n < N; ++n) {
        bool ok = false;
        if (lane < T) {
            const float2 c = c_pos[n * T + lane];
            ok = true;
            for (unsigned m = done; m != 0u; m &= m - 1u) {
                const float2 p = placed[__ffs(m) - 1];
                const float dx = __fsub_rn(c.x, p.x), dy = __fsub_rn(c.y, p.y);
                ok &= __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) >= s.min_d2;
            }
        }
        const unsigned feasible = __ballot_sync(kFull, ok);
        const int pick = feasible != 0u ? __ffs(feasible) - 1 : T - 1;
        if (lane == 0) {
            choice[n] = pick;
            if ((todo >> n) & 1u) placed[n] = c_pos[n * T + pick];
        }
        done |= 1u << n;
        __syncwarp();
    }

    if (lane < N) {
        const int c = lane * T + choice[lane];
        pos2[lane] = placed[lane];
        rot_out[at + lane] = c_yaw[c];
        path_out[at + lane] = c_path[c];
        point_out[at + lane] = c_point[c];
    }
}

}  // namespace

extern "C" int spawn_place_launch(const float* path_u, const float* point_u,
                                  const int* scenario_id, const float* prev_pos,
                                  long long pos_sb, long long pos_sn, long long pos_sc,
                                  const uint8_t* reset_mask, long long mask_sb, long long mask_sn,
                                  const uint8_t* group_mask, const int* n_points,
                                  const float* long_term, const float* yaw, float* pos,
                                  float* rot, int* path_id, int* point_id, int B, int N, int T,
                                  int G, int K, int P, int first, int count, int testing,
                                  float min_d2, void* stream) {
    if (B == 0) return 0;
    if (N < 1 || N > kMaxAgents || T < 1 || T > kMaxTries || K > 32 * kMaxPathWords)
        return (int)cudaErrorInvalidValue;
    const Sizes s{B, N, T, G, K, P, mask_sb, mask_sn, pos_sb, pos_sn, pos_sc,
                  first, count, testing, min_d2};
    const size_t smem = kWarps * warp_smem(N, T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            spawn_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
    spawn_place_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        path_u, point_u, scenario_id, prev_pos, reset_mask, group_mask, n_points, long_term, yaw,
        pos, rot, path_id, point_id, s);
    return (int)cudaGetLastError();
}
