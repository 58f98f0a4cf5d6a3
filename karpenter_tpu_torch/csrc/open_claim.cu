// Step 2 of the FFD pack step (the open-claim fill) in two launches, for L
// independent problems (lanes) at once.
//
// For each lane, one pod group with demand vec[R], per-node cap `cap`, origin
// row `og` and `rem` pods left after the existing nodes:
//
//   nodefeas[n,t,s] = optmask[n,t,s] & feas[plane(n),t,s] & active[n]
//   q[n,t]   = min over r with vec[r] > 0 of floor((alloc[t,r] - used[n,r]) / vec[r])
//              (INT_BIG when nothing is demanded, -1 for negative availability,
//              clipped to [-1, INT_BIG]; then the min with the kubelet pods-cap
//              quotient when pods_cap is given)
//   qmax[n]  = max over t with any_s nodefeas[n,t,s] of q[n,t], else -1
//   fill[n]  = clip(min(qmax[n], cap - claim_placed[og,n]), 0, INT_BIG)
//   m[n]     = first-fit waterfall of rem over fill (exclusive prefix sum)
//   where m[n] > 0:  optmask[n,t,s] = nodefeas[n,t,s] & (q[n,t] >= m[n])
//                    used[n,:]     += m[n] * vec
//   rem_out  = rem - sum(m)
//
// All int32 arithmetic wraps exactly as the plain PyTorch version's tensor
// arithmetic does (karpenter_tpu_torch/ops/open_claim.py::
// open_claim_fill_reference), so the outputs are bit-identical to it, lane
// by lane.
//
// The lane axis is the batch axis that vmap gives the JAX pack: K tenant
// problems of a solve_many wave (karpenter_tpu/solver/core.py:1025-1040) or C
// candidate lanes of the consolidation sweep (karpenter_tpu/ops/
// consolidate.py:321-331). The single solve is L = 1. Every per-problem
// operand has a lane stride, in elements; a stride of 0 shares one copy
// across the lanes (consolidation shares alloc and the pods cap). used,
// optmask, m, rem_out and the scratch are dense [L, ...] arrays.
//
// Replaces the TPU kernel karpenter_tpu/ops/pallas_kernels.py:101
// (quotient_nt, the open-claim quotient of karpenter_tpu/ops/packer.py::_step
// at :253) together with the tensor code around it (:245-279). The quotient
// alone is csrc/quotient.cu; this is its redesign for the H100.
//
// What bounds it: launch latency. At the pack's shapes (N = 32..2048 slots,
// T = 603 types, S = 6 options, R = 4) the bytes the step must move (the
// [N, T, S] option mask, read once and written where rows are placed) take
// well under a microsecond at 3.35 TB/s, and the divisions less. The
// standalone quotient kernel took several microseconds a call anyway, and its
// [N, T] result went through device memory to about eight elementwise
// launches. So the design minimises launches and latency per launch:
//   * Launch 1 (open_claim_qmax_kernel) computes q in registers and reduces it
//     straight to qmax: the [N, T] quotient is never stored. Its grid is
//     (T tiles x N rows x L lanes), 5 x 32 = 160 CTAs for one problem at the
//     main path's smallest bucket, so every SM has work; a wave or a sweep
//     multiplies that by its lanes. One thread is one (n, t); it ORs the S
//     option bytes of optmask & feas as whole words (S = 6 is three 16-bit
//     words). Each CTA reduces its tile to a partial row max; the partials of
//     a row are combined by atomicMax into a zeroed per-solve scratch (the
//     integer max does not depend on order, so the result is deterministic);
//     each lane has its own scratch row [ticket, row max + 1 per slot].
//     A thread block cluster whose rank 0 reads its peers' shared memory was
//     measured as the alternative and was slower on an H100 at the pack's
//     shapes (its extra barriers cost more than the atomics; PERF.md).
//     One CTA per type tile covers any T. The last CTA of a lane to finish
//     (threadfence + the lane's atomic ticket, counted over the lane's
//     gridDim.x * gridDim.y CTAs) runs that lane's waterfall over its N rows,
//     writes its m, rem_out and new used rows, and zeroes its scratch row
//     and ticket for the next step, so no memset launch is needed.
//   * Launch 2 (open_claim_apply_kernel), same grid, shrinks optmask in
//     place. Rows with m = 0 (most rows on most steps) return at once. For
//     m > 0, q[n,t] >= m holds exactly when every demanded r has
//     alloc[t,r] - used_old[n,r] >= m * vec[r] (compared in 64 bits), and
//     likewise the pods cap; used_old is recovered from the new used row as
//     used - m * vec in wrapping int32, which undoes launch 1's wrapping add
//     exactly. So launch 2 divides nothing, and launch 1 may overwrite used
//     because no CTA of launch 1 still reads it when the last CTA writes it.
//   * Division by vec[r], the same for every thread, is a multiply-high and a
//     shift: each CTA computes its R multipliers once into shared memory.
//     For 0 <= x < 2**31 and 1 <= d < 2**31, with l = ceil(log2 d) and
//     M = ceil(2**(31+l) / d) (which is below 2**32),
//     floor(x / d) = (x * M) >> (31 + l) exactly (Granlund and Montgomery,
//     PLDI 1994, theorem 4.2 with N = 31). Negative numerators are masked to
//     -1 before it, so the quotient is exact on the whole int32 domain.
//   * What does not apply: tensor cores (there is no matrix product, only
//     integer divide, min and max), and TMA or cp.async (a CTA reads a few
//     KB, which plain coalesced loads bring in within one latency).
//
// The row-max mode, for the multi-rank mesh (karpenter_tpu_torch/parallel/
// sharded.py), where each rank holds a slice of the slots and a slice of the
// types. There launch 1 would run the waterfall on a partial row max (the max
// over this rank's types only), so its row-max mode (open_claim_rowmax_launch)
// stops after the row max: the lane's last CTA writes qmax[n] for this rank's
// slots into the `m` buffer and zeroes its scratch row and ticket as launch 1
// does. The caller all-reduces qmax over the ranks of the types axis; the
// fill, the first-fit waterfall over every rank's slots, m, rem_out and the
// `used` update then run as tensor code on [L, N_local] (they are a few
// hundred integers a step, and the waterfall needs the other ranks' fills
// first); launch 2 then runs unchanged on the new used and m. The
// single-card path never takes this mode: it keeps its two launches a step.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (karpenter_tpu_torch/ops/_build.py).
// C entry points: open_claim_qmax_launch, open_claim_rowmax_launch,
// open_claim_apply_launch, bound with ctypes
// (karpenter_tpu_torch/ops/open_claim.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INT_BIG = 1 << 30;
constexpr int TILE_T = 128;              // threads per CTA, one type each
constexpr int WARPS = TILE_T / 32;
constexpr unsigned FULL = 0xffffffffu;

// One lane's operands (the comments give a lane's shapes), and the lane
// strides of the inputs, in elements (0 = shared by every lane).
struct Step {
    const int* alloc_rt;         // [R, T] type-major allocatable
    const int* vec;              // [R] the group's demand
    const int* cap;              // [] the group's per-node cap
    const uint8_t* feas;         // [Pv, T, S] the group's feasibility planes
    const long long* og;         // [] origin row of the group
    const int* claim_placed;     // [G, N] pods placed per (origin row, slot)
    const int* pods_cap;         // [Pv, T] kubelet pods cap, or null
    const int* nprov;            // [N]
    const uint8_t* active;       // [N]
    const int* rem;              // [] pods left after the existing nodes
    int* used;                   // [N, R], updated by launch 1
    uint8_t* optmask;            // [N, T, S], updated by launch 2
    int* m;                      // [N] pods placed per slot (launch 1 writes)
    int* rem_out;                // [] pods left after this fill
    int* ws;                     // [1 + N]: ticket, then row max + 1; zero between steps
    int N, T, S, Pv, pods_i, word;
    long long ls_alloc, ls_vec, ls_cap, ls_feas, ls_og, ls_placed, ls_pods_cap, ls_nprov,
        ls_active, ls_rem;
};

// lane l's operands: every pointer moved to the lane, offsets in 64 bits
template <int R>
__device__ __forceinline__ Step lane_view(const Step& a, long long l) {
    Step b = a;
    b.alloc_rt += l * a.ls_alloc;
    b.vec += l * a.ls_vec;
    b.cap += l * a.ls_cap;
    b.feas += l * a.ls_feas;
    b.og += l * a.ls_og;
    b.claim_placed += l * a.ls_placed;
    if (a.pods_cap != nullptr) {
        b.pods_cap += l * a.ls_pods_cap;
    }
    b.nprov += l * a.ls_nprov;
    b.active += l * a.ls_active;
    b.rem += l * a.ls_rem;
    b.used += l * a.N * R;
    b.optmask += l * a.N * static_cast<long long>(a.T) * a.S;
    b.m += l * a.N;
    b.rem_out += l;
    b.ws += l * (a.N + 1);
    return b;
}

// int32 arithmetic that wraps, as the plain version's tensor arithmetic does
__device__ __forceinline__ int wsub(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wadd(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

struct Magic {
    unsigned mul;
    int shift;
};

// multiplier and shift for floor(x / d), 1 <= d < 2**31 (see the header note)
__device__ Magic magic(int d) {
    const int l = 32 - __clz(d - 1);
    const unsigned long long p = 1ull << (31 + l);
    return {static_cast<unsigned>((p + static_cast<unsigned>(d) - 1) / static_cast<unsigned>(d)),
            31 + l};
}

// floor(x / d) for 0 <= x < 2**31
__device__ __forceinline__ int fdiv(int x, Magic g) {
    return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(x)) * g.mul)
                            >> g.shift);
}

// any over s of x[s] & y[s], reading the S bytes of a type as words of W
template <typename W>
__device__ __forceinline__ bool any_and_w(const uint8_t* x, const uint8_t* y, int S) {
    const W* xw = reinterpret_cast<const W*>(x);
    const W* yw = reinterpret_cast<const W*>(y);
    unsigned acc = 0;
    for (int i = 0; i < S / static_cast<int>(sizeof(W)); ++i) {
        acc |= static_cast<unsigned>(xw[i] & yw[i]);
    }
    return acc != 0;
}

__device__ __forceinline__ bool any_and(const uint8_t* x, const uint8_t* y, int S, int word) {
    switch (word) {
        case 4: return any_and_w<uint32_t>(x, y, S);
        case 2: return any_and_w<uint16_t>(x, y, S);
        default: return any_and_w<uint8_t>(x, y, S);
    }
}

// om[s] = keep ? om[s] & fe[s] : 0, as words of W
template <typename W>
__device__ __forceinline__ void shrink_w(uint8_t* om, const uint8_t* fe, int S, bool keep) {
    W* ow = reinterpret_cast<W*>(om);
    const W* fw = reinterpret_cast<const W*>(fe);
    for (int i = 0; i < S / static_cast<int>(sizeof(W)); ++i) {
        ow[i] = keep ? static_cast<W>(ow[i] & fw[i]) : static_cast<W>(0);
    }
}

__device__ __forceinline__ void shrink(uint8_t* om, const uint8_t* fe, int S, int word, bool keep) {
    switch (word) {
        case 4: shrink_w<uint32_t>(om, fe, S, keep); break;
        case 2: shrink_w<uint16_t>(om, fe, S, keep); break;
        default: shrink_w<uint8_t>(om, fe, S, keep); break;
    }
}

// q[n, t] for this CTA's row, from the row's used values and the
// multipliers in shared memory
template <int R>
__device__ __forceinline__ int quotient(const Step& a, int t, int pn, const int* used_s,
                                        const int* vec_s, const Magic* mg_s) {
    int q = INT_BIG;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int v = vec_s[r];
        if (v > 0) {
            const int avail = wsub(a.alloc_rt[static_cast<long long>(r) * a.T + t], used_s[r]);
            q = min(q, avail < 0 ? -1 : fdiv(avail, mg_s[r]));
        }
    }
    q = max(-1, min(q, INT_BIG));
    if (a.pods_cap != nullptr) {
        const int v = vec_s[a.pods_i];
        if (v > 0) {
            const int avail = wsub(a.pods_cap[static_cast<long long>(pn) * a.T + t],
                                   used_s[a.pods_i]);
            q = min(q, avail < 0 ? -1 : min(fdiv(avail, mg_s[a.pods_i]), INT_BIG));
        }
    }
    return q;
}

// block max, valid in thread 0
__device__ __forceinline__ int block_max(int v, int* red_s) {
    v = __reduce_max_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) {
        red_s[threadIdx.x >> 5] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < WARPS; ++w) {
            v = max(v, red_s[w]);
        }
    }
    return v;
}

// The waterfall over a lane's N rows, run by its last CTA of launch 1. Each
// thread takes a contiguous chunk of rows; sums wrap in unsigned arithmetic,
// which is the plain version's int32 cumsum and sum modulo 2**32.
template <int R>
__device__ void waterfall(const Step& a, const int* vec_s) {
    __shared__ unsigned warp_s[WARPS];
    __shared__ unsigned msum_s[WARPS];
    const int N = a.N;
    const int rem = *a.rem;
    const int cap = *a.cap;
    const int* placed = a.claim_placed + *a.og * static_cast<long long>(N);
    const int per = (N + TILE_T - 1) / TILE_T;
    const int n0 = min(N, static_cast<int>(threadIdx.x) * per);
    const int n1 = min(N, n0 + per);

    unsigned sum = 0;
    for (int n = n0; n < n1; ++n) {
        const int qmax = __ldcg(&a.ws[1 + n]) - 1;
        int fill = max(0, min(min(qmax, wsub(cap, placed[n])), INT_BIG));
        fill = min(fill, rem);
        a.ws[1 + n] = fill;
        sum += static_cast<unsigned>(fill);
    }

    // exclusive prefix of the chunk sums over the CTA
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    unsigned inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) {
            inc += y;
        }
    }
    if (lane == 31) {
        warp_s[warp] = inc;
    }
    __syncthreads();
    unsigned before = inc - sum;
    for (int w = 0; w < warp; ++w) {
        before += warp_s[w];
    }

    unsigned msum = 0;
    for (int n = n0; n < n1; ++n) {
        const int fill = a.ws[1 + n];
        const int m = min(max(wsub(rem, static_cast<int>(before)), 0), fill);
        before += static_cast<unsigned>(fill);
        a.m[n] = m;
        a.ws[1 + n] = 0;
        msum += static_cast<unsigned>(m);
        if (m > 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                int* u = a.used + static_cast<long long>(n) * R + r;
                *u = wadd(*u, wmul(m, vec_s[r]));
            }
        }
    }
    msum = __reduce_add_sync(FULL, msum);
    if (lane == 0) {
        msum_s[warp] = msum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned total = 0;
        for (int w = 0; w < WARPS; ++w) {
            total += msum_s[w];
        }
        *a.rem_out = wsub(rem, static_cast<int>(total));
        a.ws[0] = 0;
    }
}

// The row-max mode's end of launch 1, run by a lane's last CTA: qmax[n] into
// m[n] for each of the lane's N rows, and the scratch row and ticket zeroed.
__device__ void rowmax_out(const Step& a) {
    for (int n = threadIdx.x; n < a.N; n += TILE_T) {
        a.m[n] = __ldcg(&a.ws[1 + n]) - 1;
        a.ws[1 + n] = 0;
    }
    if (threadIdx.x == 0) {
        a.ws[0] = 0;
    }
}

// Launch 1: grid (T tiles, N, L), one CTA per (type tile, row, lane). With
// ROWMAX it stops after the row max (the row-max mode above).
template <int R, bool ROWMAX>
__global__ void __launch_bounds__(TILE_T) open_claim_qmax_kernel(Step lanes) {
    const Step a = lane_view<R>(lanes, blockIdx.z);
    __shared__ int vec_s[R];
    __shared__ int used_s[R];
    __shared__ Magic mg_s[R];
    __shared__ int red_s[WARPS];
    __shared__ bool last_s;

    const int n = blockIdx.y;
    if (threadIdx.x < R) {
        const int v = a.vec[threadIdx.x];
        vec_s[threadIdx.x] = v;
        used_s[threadIdx.x] = a.used[static_cast<long long>(n) * R + threadIdx.x];
        mg_s[threadIdx.x] = magic(max(v, 1));
    }
    __syncthreads();

    int best = -1;
    if (a.active[n] != 0) {
        const int pn = max(a.nprov[n], 0);
        const uint8_t* plane = a.feas + static_cast<long long>(a.Pv == 1 ? 0 : pn) * a.T * a.S;
        const uint8_t* row = a.optmask + static_cast<long long>(n) * a.T * a.S;
        const int t = blockIdx.x * TILE_T + threadIdx.x;
        if (t < a.T && any_and(row + static_cast<long long>(t) * a.S,
                               plane + static_cast<long long>(t) * a.S, a.S, a.word)) {
            best = quotient<R>(a, t, pn, used_s, vec_s, mg_s);
        }
    }
    best = block_max(best, red_s);

    if (threadIdx.x == 0) {
        atomicMax(&a.ws[1 + n], best + 1);
        __threadfence();
        last_s = atomicAdd(reinterpret_cast<unsigned*>(a.ws), 1u) ==
                 gridDim.x * gridDim.y - 1;
    }
    __syncthreads();
    if (!last_s) {
        return;
    }
    __threadfence();
    if (ROWMAX) {
        rowmax_out(a);
    } else {
        waterfall<R>(a, vec_s);
    }
}

// Launch 2: grid (T tiles, N, L). Shrinks the option mask of placed rows.
template <int R>
__global__ void __launch_bounds__(TILE_T) open_claim_apply_kernel(Step lanes) {
    const Step a = lane_view<R>(lanes, blockIdx.z);
    __shared__ int vec_s[R];
    __shared__ int old_s[R];

    const int n = blockIdx.y;
    const int m = a.m[n];
    if (m <= 0) {
        return;
    }
    if (threadIdx.x < R) {
        const int v = a.vec[threadIdx.x];
        vec_s[threadIdx.x] = v;
        old_s[threadIdx.x] = wsub(a.used[static_cast<long long>(n) * R + threadIdx.x], wmul(m, v));
    }
    __syncthreads();
    const int t = blockIdx.x * TILE_T + threadIdx.x;
    if (t >= a.T) {
        return;
    }
    const int pn = max(a.nprov[n], 0);
    bool fit = a.active[n] != 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int v = vec_s[r];
        if (v > 0) {
            const int avail = wsub(a.alloc_rt[static_cast<long long>(r) * a.T + t], old_s[r]);
            fit = fit && static_cast<long long>(avail) >= static_cast<long long>(m) * v;
        }
    }
    if (a.pods_cap != nullptr && vec_s[a.pods_i] > 0) {
        const int avail = wsub(a.pods_cap[static_cast<long long>(pn) * a.T + t], old_s[a.pods_i]);
        fit = fit && static_cast<long long>(avail) >=
                         static_cast<long long>(m) * vec_s[a.pods_i];
    }
    const uint8_t* plane = a.feas + static_cast<long long>(a.Pv == 1 ? 0 : pn) * a.T * a.S;
    const long long o = (static_cast<long long>(n) * a.T + t) * a.S;
    shrink(a.optmask + o, plane + static_cast<long long>(t) * a.S, a.S, a.word, fit);
}

template <int R, bool ROWMAX>
cudaError_t launch_qmax(const Step& a, int L, cudaStream_t s) {
    const int tiles = (a.T + TILE_T - 1) / TILE_T;
    open_claim_qmax_kernel<R, ROWMAX><<<dim3(tiles, a.N, L), TILE_T, 0, s>>>(a);
    return cudaGetLastError();
}

template <int R>
cudaError_t launch_apply(const Step& a, int L, cudaStream_t s) {
    const int tiles = (a.T + TILE_T - 1) / TILE_T;
    open_claim_apply_kernel<R><<<dim3(tiles, a.N, L), TILE_T, 0, s>>>(a);
    return cudaGetLastError();
}

Step make_step(const void* alloc_rt, const void* vec, const void* cap, const void* feas,
               const void* og, const void* claim_placed, const void* pods_cap,
               const void* nprov, const void* active, const void* rem, void* used,
               void* optmask, void* m, void* rem_out, void* ws, int N, int T, int S, int Pv,
               int pods_i, int word, const long long* ls) {
    return Step{static_cast<const int*>(alloc_rt), static_cast<const int*>(vec),
                static_cast<const int*>(cap), static_cast<const uint8_t*>(feas),
                static_cast<const long long*>(og), static_cast<const int*>(claim_placed),
                static_cast<const int*>(pods_cap), static_cast<const int*>(nprov),
                static_cast<const uint8_t*>(active), static_cast<const int*>(rem),
                static_cast<int*>(used), static_cast<uint8_t*>(optmask), static_cast<int*>(m),
                static_cast<int*>(rem_out), static_cast<int*>(ws), N, T, S, Pv, pods_i, word,
                ls[0], ls[1], ls[2], ls[3], ls[4], ls[5], ls[6], ls[7], ls[8], ls[9]};
}

}  // namespace

#define KTP_STEP_ARGS                                                                      \
    const void *alloc_rt, const void *vec, const void *cap, const void *feas, const void *og, \
        const void *claim_placed, const void *pods_cap, const void *nprov,                 \
        const void *active, const void *rem, void *used, void *optmask, void *m,           \
        void *rem_out, void *ws, int N, int T, int S, int Pv, int R, int pods_i, int word, \
        int L, const long long *lane_strides
#define KTP_MAKE_STEP                                                                      \
    make_step(alloc_rt, vec, cap, feas, og, claim_placed, pods_cap, nprov, active, rem, used, \
              optmask, m, rem_out, ws, N, T, S, Pv, pods_i, word, lane_strides)
#define KTP_WIDTHS(X) \
    X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// Each returns the launch's CUDA error (0 = launched), or cudaErrorInvalidValue
// for a width outside 1..16. `lane_strides` is a host array of the 10 lane
// strides, in the order of Step's ls_* fields. The wrapper checks shapes,
// dtypes, layouts, strides and alignment before it calls.
extern "C" int open_claim_qmax_launch(KTP_STEP_ARGS, void* stream) {
    const Step a = KTP_MAKE_STEP;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (R) {
#define KTP_CASE(W) \
    case W:         \
        return static_cast<int>(launch_qmax<W, false>(a, L, s));
        KTP_WIDTHS(KTP_CASE)
#undef KTP_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Launch 1 in its row-max mode: writes qmax into `m`; rem, cap, og,
// claim_placed and rem_out are not read or written.
extern "C" int open_claim_rowmax_launch(KTP_STEP_ARGS, void* stream) {
    const Step a = KTP_MAKE_STEP;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (R) {
#define KTP_CASE(W) \
    case W:         \
        return static_cast<int>(launch_qmax<W, true>(a, L, s));
        KTP_WIDTHS(KTP_CASE)
#undef KTP_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int open_claim_apply_launch(KTP_STEP_ARGS, void* stream) {
    const Step a = KTP_MAKE_STEP;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (R) {
#define KTP_CASE(W) \
    case W:         \
        return static_cast<int>(launch_apply<W>(a, L, s));
        KTP_WIDTHS(KTP_CASE)
#undef KTP_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
