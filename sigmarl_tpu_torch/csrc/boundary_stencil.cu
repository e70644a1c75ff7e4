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
// What bounds it on an H100: operations. At the main path's shapes
// (R = 15,360 rows, Q = 27 queries, 2 sides, 3 chunks x 16 segments) it
// does about 40 M segment evaluations of ~23 float operations each against
// ~7 MB of queries and outputs, so the fp32 rate, not the 3.35 TB/s of
// memory, sets the floor.
//
// Design: one thread per (row, query, side), looping over its segments.
// Neighbouring threads hold neighbouring queries of the same row and side,
// so the query loads coalesce and every thread of a row reads the same
// segment rows, which the L1/L2 caches serve (both tables together are
// about 450 KB at K = 40 paths). The TPU kernel's one-hot matmul gather of
// the path's table is a plain indexed load here. With chunk indices the
// thread sweeps only the selected chunks' segments; without them, all S.
// Out-of-range path or chunk indices give NaN instead of reading outside
// the tables.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLamEps = 1e-3f;
constexpr float kBig2 = 1.0e6f;  // squared fill, sqrt -> 1000

__device__ __forceinline__ float segment_d2(const float* __restrict__ row,
                                            float qx, float qy) {
    const float4 a = *reinterpret_cast<const float4*>(row);
    const float4 b = *reinterpret_cast<const float4*>(row + 4);
    // a = (pbx, pby, cos_t, sin_t), b = (len, m_b, m_t, valid)
    const float rx = qx - a.x;
    const float ry = qy - a.y;
    const float x = a.z * rx + a.w * ry;
    const float y = -a.w * rx + a.z * ry;
    const float denom = b.x - y * (b.z - b.y);
    const float lam = (x + y * b.y) / denom;
    const float nx = x - lam * b.x;
    const float d2 = nx * nx + y * y;
    const bool ok = (b.w > 0.5f) && (lam >= -kLamEps) && (lam < 1.0f + kLamEps);
    return ok ? d2 : kBig2;
}

__global__ void pd_stencil_kernel(const float* __restrict__ q,
                                  const int* __restrict__ path_id,
                                  const float* __restrict__ left_seg,
                                  const float* __restrict__ right_seg,
                                  const int* __restrict__ left_chunks,
                                  const int* __restrict__ right_chunks,
                                  float* __restrict__ d_left,
                                  float* __restrict__ d_right,
                                  int R, int Q, int K, int S, int k, int chunk) {
    const long long RQ = (long long)R * Q;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= 2 * RQ) return;
    const int side = (int)(t / RQ);
    const long long rq = t - side * RQ;
    const int r = (int)(rq / Q);
    const float* table = side ? right_seg : left_seg;
    const int* chunks = side ? right_chunks : left_chunks;
    float* out = side ? d_right : d_left;

    const float qx = q[2 * rq];
    const float qy = q[2 * rq + 1];
    const int p = path_id[r];
    if (p < 0 || p >= K) {
        out[rq] = nanf("");
        return;
    }
    const float* base = table + (long long)p * S * 8;
    float best = kBig2;
    if (chunks == nullptr) {
        for (int s = 0; s < S; ++s) best = fminf(best, segment_d2(base + 8 * s, qx, qy));
    } else {
        const int n_chunks = S / chunk;
        for (int c = 0; c < k; ++c) {
            const int ci = chunks[(long long)r * k + c];
            if (ci < 0 || ci >= n_chunks) {
                best = nanf("");
                break;
            }
            const float* rows = base + (long long)ci * chunk * 8;
            for (int s = 0; s < chunk; ++s) best = fminf(best, segment_d2(rows + 8 * s, qx, qy));
        }
    }
    out[rq] = sqrtf(best);
}

}  // namespace

extern "C" int pd_stencil_launch(const float* q, const int* path_id,
                                 const float* left_seg, const float* right_seg,
                                 const int* left_chunks, const int* right_chunks,
                                 float* d_left, float* d_right,
                                 int R, int Q, int K, int S, int k, int chunk,
                                 void* stream) {
    const long long n = 2LL * R * Q;
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    pd_stencil_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        q, path_id, left_seg, right_seg, left_chunks, right_chunks, d_left, d_right,
        R, Q, K, S, k, chunk);
    return (int)cudaGetLastError();
}
