// Pseudo-distance stencil: distance of each query point to the left and
// right lane boundary of its row's reference path.
//
// Replaces the TPU kernel `sigmarl_tpu/ops/boundary_pallas.py::
// pseudo_distance_stencil` (`_stencil_kernel`), and on the main path the
// chunk-pruned XLA sweep `topk_chunk_rows` + `pseudo_distance_seg` that the
// JAX filter runs in its place (`safety/cbf_qp.py::_lane_terms`).
//
// Per (row, query, side) and per segment row (pbx, pby, cos_t, sin_t, len,
// m_b, m_t, valid): rotate the query into the segment frame,
// lambda = (x + y m_b) / (len - y (m_t - m_b)), d2 = (x - lambda len)^2 + y^2;
// the segment counts if it is valid and lambda in [-1e-3, 1 + 1e-3). The
// result is sqrt(min d2), 1000 where no segment counts.
//
// What bounds it on an H100: at the main path's shapes (R = 15,360 rows,
// Q = 27 queries, 2 sides, 3 chunks x 16 segments) the full sweep is about
// 40 M segment evaluations of ~25 float operations and one IEEE division
// each, against ~7 MB of queries and outputs: operations. Pruned as below,
// the work that is left is a few times smaller than that and the ~7 MB of
// memory traffic sets a floor of the same order.
//
// Design: one warp per row, both sides in one launch. A row's queries are
// the 9-point stencils around one agent's circle centers, a few cm apart,
// and only the few segments they project onto can count: of the 48 per
// side, fewer than one in ten counts for any of the row's queries. So the
// warp first tests the segments, one per lane (32 at a time per side),
// against a disk that holds all of the row's queries: a segment is ruled
// out only where lambda stays surely outside its window over the whole
// disk (`may_count`). The tested segment rows go to shared memory (with
// m_t - m_b in place of m_t) and a ballot gives the ones left; for each of
// those every lane reads the same staged row (a broadcast) and evaluates
// it exactly for its queries, IEEE division included. A segment ruled out
// would have left every
// query's min as it was, and the min does not depend on the order of the
// segments, so the result is that of the full sweep bit for bit. The TPU
// kernel's one-hot matmul gather of the path's table is a plain indexed
// load here. Out-of-range path or chunk indices give NaN instead of
// reading outside the tables.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLamEps = 1e-3f;
constexpr float kBig2 = 1.0e6f;  // squared fill, sqrt -> 1000
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // rows per block, one warp each

// A query in one segment's frame: x along the segment, y across it, and
// lambda's numerator and denominator.
struct Frame {
    float x, y, num, den;
};

// a = (pbx, pby, cos_t, sin_t), b = (len, m_b, m_t - m_b, valid)
__device__ __forceinline__ Frame frame(const float4 a, const float4 b, float qx, float qy) {
    const float rx = qx - a.x;
    const float ry = qy - a.y;
    Frame f;
    f.x = a.z * rx + a.w * ry;
    f.y = -a.w * rx + a.z * ry;
    f.den = b.x - f.y * b.z;
    f.num = f.x + f.y * b.y;
    return f;
}

__device__ __forceinline__ float segment_d2(const Frame& f, const float4 b) {
    const float lam = f.num / f.den;
    const float nx = f.x - lam * b.x;
    const float d2 = nx * nx + f.y * f.y;
    const bool ok = (b.w > 0.5f) && (lam >= -kLamEps) && (lam < 1.0f + kLamEps);
    return ok ? d2 : kBig2;
}

// Whether the segment can count for some query within rho of (cx, cy).
// num and den are affine in the query: over the disk they move from their
// values at the centre by at most reach (1 + |m_b|) and reach |m_t - m_b|,
// reach = rho (|cos_t| + |sin_t|), each widened by `slack`, which is more
// than a thousand times the float rounding of a query's own num and den
// (`scale` bounds the coordinates' size). Where den keeps one sign over the
// disk, lambda = (s num) / |den| with s that sign, and lambda >= -1e-3 needs
// s num >= -1e-3 |den| > -0.01 max|den|, lambda < 1.001 needs
// s num < 1.001 |den| < 1.01 max|den|; where den may reach 0, the segment
// is kept.
__device__ __forceinline__ bool may_count(const float4 a, const float4 b, float cx, float cy,
                                          float rho, float scale) {
    const Frame c = frame(a, b, cx, cy);
    const float reach = rho * (fabsf(a.z) + fabsf(a.w));
    const float slack = 1e-4f * (scale + fabsf(a.x) + fabsf(a.y) + fabsf(b.x)) *
                        (1.0f + fabsf(b.y) + fabsf(b.z));
    const float dn = reach * (1.0f + fabsf(b.y)) + slack;
    const float dd = reach * fabsf(b.z) + slack;
    const float d_lo = c.den - dd, d_hi = c.den + dd;
    const bool neg = d_hi < 0.0f;
    const float a_hi = neg ? -d_lo : d_hi;
    const float sn_hi = neg ? dn - c.num : c.num + dn;
    const float sn_lo = neg ? -dn - c.num : c.num - dn;
    const bool window = sn_hi >= -0.01f * a_hi && sn_lo <= 1.01f * a_hi;
    return b.w > 0.5f && (!(d_lo > 0.0f || neg) || window);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

// NQ: query slots per lane (1 when Q <= 32, as on the main path, else 4).
template <int NQ>
__global__ void __launch_bounds__(32 * kWarps)
pd_stencil_kernel(const float* __restrict__ q, const int* __restrict__ path_id,
                  const float* __restrict__ left_seg, const float* __restrict__ right_seg,
                  const int* __restrict__ left_chunks, const int* __restrict__ right_chunks,
                  float* __restrict__ d_left, float* __restrict__ d_right, int R, int Q, int K,
                  int S, int k, int chunk) {
    // One round of 32 tested segment rows per side: [warp][side][lane].
    __shared__ float4 seg_a[kWarps][2][32], seg_b[kWarps][2][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * kWarps + warp;
    if (r >= R) return;
    const float4* tables[2] = {reinterpret_cast<const float4*>(left_seg),
                               reinterpret_cast<const float4*>(right_seg)};
    const int* chunks[2] = {left_chunks, right_chunks};
    float* outs[2] = {d_left + (long long)r * Q, d_right + (long long)r * Q};
    const float2* qr = reinterpret_cast<const float2*>(q) + (long long)r * Q;
    const bool chunked = left_chunks != nullptr;

    // The path id, and the chunk indices one per lane (lane c < k: left
    // chunk c, lane k + c: right chunk c), all loaded at once.
    const int p = path_id[r];
    const bool bad_path = p < 0 || p >= K;
    const int n_chunks = chunk > 0 ? S / chunk : 0;
    int ci = 0;
    if (chunked && lane < 2 * k)
        ci = lane < k ? chunks[0][(long long)r * k + lane] : chunks[1][(long long)r * k + lane - k];
    const unsigned bad_ci =
        __ballot_sync(kFull, chunked && lane < 2 * k && (ci < 0 || ci >= n_chunks));
    const unsigned left_lanes = (1u << k) - 1u;  // k <= 16
    const bool bad[2] = {bad_path || (bad_ci & left_lanes) != 0,
                         bad_path || (bad_ci & ~left_lanes) != 0};

    // Lane l holds queries l, l + 32, ...; a lane past Q computes on a
    // dummy query and writes nothing. The queries' bounding box gives the
    // disk for the segment test: its centre and half diagonal.
    float qx[NQ], qy[NQ], best[2][NQ];
    float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        const int qi = lane + 32 * j;
        const float2 v = qi < Q ? qr[qi] : make_float2(0.0f, 0.0f);
        qx[j] = v.x;
        qy[j] = v.y;
        best[0][j] = best[1][j] = kBig2;
        if (qi < Q) {
            xmin = fminf(xmin, v.x);
            xmax = fmaxf(xmax, v.x);
            ymin = fminf(ymin, v.y);
            ymax = fmaxf(ymax, v.y);
        }
    }
    xmin = warp_min(xmin);
    xmax = warp_max(xmax);
    ymin = warp_min(ymin);
    ymax = warp_max(ymax);
    const float cx = 0.5f * (xmin + xmax), cy = 0.5f * (ymin + ymax);
    const float wx = xmax - xmin, wy = ymax - ymin;
    const float rho = 0.5f * sqrtf(wx * wx + wy * wy);
    const float scale = 1.0f + fabsf(cx) + fabsf(cy) + 2.0f * rho;

    // Segment rows of this row: the selected chunks in order, or all S rows
    // of the path; a side with a bad index tests nothing and ends as NaN.
    const int total = chunked ? k * chunk : S;
    if (!(bad[0] && bad[1])) {
        for (int t0 = 0; t0 < total; t0 += 32) {
            const int i = t0 + lane;
            unsigned live[2];
            __syncwarp();
#pragma unroll
            for (int sd = 0; sd < 2; ++sd) {
                int src = i;
                if (chunked) {
                    const int c = i / chunk;
                    src = __shfl_sync(kFull, ci, min(sd * k + c, 31)) * chunk + (i - c * chunk);
                }
                float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
                bool may = false;
                if (i < total && !bad[sd]) {
                    const float4* row = tables[sd] + ((long long)p * S + src) * 2;
                    a = row[0];
                    b = row[1];
                    b.z = b.z - b.y;  // m_t - m_b
                    may = may_count(a, b, cx, cy, rho, scale);
                }
                seg_a[warp][sd][lane] = a;
                seg_b[warp][sd][lane] = b;
                live[sd] = __ballot_sync(kFull, may);
            }
            __syncwarp();
#pragma unroll
            for (int sd = 0; sd < 2; ++sd) {
                for (unsigned m = live[sd]; m != 0u; m &= m - 1u) {
                    const int s = __ffs(m) - 1;
                    const float4 a = seg_a[warp][sd][s], b = seg_b[warp][sd][s];
#pragma unroll
                    for (int j = 0; j < NQ; ++j)
                        best[sd][j] = fminf(best[sd][j], segment_d2(frame(a, b, qx[j], qy[j]), b));
                }
            }
        }
    }
#pragma unroll
    for (int sd = 0; sd < 2; ++sd)
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            const int qi = lane + 32 * j;
            if (qi < Q) outs[sd][qi] = bad[sd] ? nanf("") : sqrtf(best[sd][j]);
        }
}

}  // namespace

extern "C" int pd_stencil_launch(const float* q, const int* path_id,
                                 const float* left_seg, const float* right_seg,
                                 const int* left_chunks, const int* right_chunks,
                                 float* d_left, float* d_right,
                                 int R, int Q, int K, int S, int k, int chunk,
                                 void* stream) {
    if (R == 0 || Q == 0) return 0;
    if (Q > 128) return (int)cudaErrorInvalidValue;  // four queries per lane at most
    if (left_chunks != nullptr && 2 * k > 32) return (int)cudaErrorInvalidValue;  // a lane each
    const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
    if (Q <= 32) {
        pd_stencil_kernel<1><<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
            q, path_id, left_seg, right_seg, left_chunks, right_chunks, d_left, d_right,
            R, Q, K, S, k, chunk);
    } else {
        pd_stencil_kernel<4><<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
            q, path_id, left_seg, right_seg, left_chunks, right_chunks, d_left, d_right,
            R, Q, K, S, k, chunk);
    }
    return (int)cudaGetLastError();
}
