// Shift-MAC over a flat lattice: out[c, s] = sum_k coeffs[k, c, s] * x[s + off[k]]
// with x read as zero outside [0, n); x (n,), coeffs (K, C, n), out (C, n),
// 1 <= K <= 8, any C >= 1, n >= 1 and any integer offsets (|off| >= n
// included), fp32 and fp64, accumulated in ascending k for each (c, s).
//
// Replaces the Pallas TPU kernel rapidcfd_tpu/ops/pallas_gdia.py::_mac_pallas
// (dispatched by shift_mac_cols). The gdia Gauss operators reach it
// (mesh/gdia.py): gauss_mac3 (C = 3, the Gauss gradient) and gauss_mac1
// (C = 1, the divergence contraction). The TPU version staged a pre-shifted
// (K, n) copy of x because Mosaic cannot address unaligned 1-D slices in
// VMEM; here each thread reads x at the offsets, so that copy is gone.
//
// What bounds it on an H100. Each call moves (K*C + C + 1) * n values and
// does 2 FLOP per coefficient (0.5 FLOP/byte in fp32, 40x under the
// card's fp32 ridge; tensor cores do nothing here), so the bound is bytes:
// 0.94 us for C = 1 and 2.54 us for C = 3 at the pitzDaily x5 slice
// (n = 112000, K = 5, fp32, 3.35 TB/s). But an empty launch already takes
// about 0.9 us of device time there, and the whole call is one round trip
// to memory per thread. So what counts is that every load of a thread is in
// flight before its first multiply, with few instructions around them: on
// that card, reading the offsets' access pattern at run time (a switch per
// offset) cost as much as the 16-byte loads saved, and staging tiles
// through shared memory with TMA bulk copies on an mbarrier was slower than
// both (the barrier's set-up and the block barrier add to the one round
// trip).
//
// The kernels, 256 threads a block, chosen by the launcher (launch below):
//
// - mac_stencil (the lattice stencil; what the solvers' calls take):
//   specialised on (K, C) for the forms the paths use, (5, 1), (5, 3),
//   (7, 1) and (7, 3), for offsets ascending with -1, 0, 1 in the middle and
//   the others multiples of V (e.g. +-nx with nx % 4 == 0 in fp32), n % V
//   == 0 and 16-byte-aligned x, coeffs and out. Each thread owns V
//   consecutive cells (V = 4 in fp32, 2 in fp64): it reads each coefficient
//   row with one 16-byte load, x at the outer offsets with one aligned
//   16-byte load each, its own V cells once, and takes x at +-1 from the
//   adjacent lanes (__shfl_up/down_sync), the warp's edge lanes loading
//   their outer cell themselves; then the FMAs, and one 16-byte store per
//   output row. The coefficients are loaded first where they are most of
//   the bytes (C > 1), after x otherwise. 32-bit indices.
// - mac_generic (every other case: other K or C or offsets, n % V != 0, a
//   view with a storage offset that misaligns a base pointer): one cell per
//   thread, one bounded scalar load per offset, K and C read at run time;
//   32-bit indices where K*C*n < 2^31 and n < 2^30, 64-bit above that.
// - ref_kernel (entry points shift_mac_ref_*): the kernel as it was first
//   written, one thread per cell in 256-thread blocks, grid-stride with
//   64-bit indices, K and C known only at run time. Kept only to time the
//   kernels above against it in one call; shift_mac_cols never reaches it.
//
// Offsets are clamped to [-n, n] (any |off| >= n reads only zeros), so
// s + off never overflows the index type. A launch is one host call with
// one packed argument (Call), on the call's device and stream.

#include <cuda_runtime.h>

// one launch as the wrapper packs it (one argument keeps the host call
// short): device pointers, n, the host array of K offsets, the stream
struct Call {
    long long x, coeffs, out, n, offsets, stream;
    int K, C, device;
};

namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// baseline kernel, for comparison only
// ---------------------------------------------------------------------------

constexpr int kRefMaxBlocks = 132 * 32;

struct RefOffsets {
    long long off[kMaxK];
    int k;
};

template <typename T>
__global__ void ref_kernel(const T* __restrict__ x,
                           const T* __restrict__ coeffs,
                           T* __restrict__ out,
                           long long n, int C, RefOffsets o) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         s < n; s += stride) {
        T xv[kMaxK];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
            if (k < o.k) {
                const long long j = s + o.off[k];
                xv[k] = (j >= 0 && j < n) ? x[j] : T(0);
            }
        }
        for (int c = 0; c < C; ++c) {
            const T* cc = coeffs + (long long)c * n + s;
            T acc = cc[0] * xv[0];
#pragma unroll
            for (int k = 1; k < kMaxK; ++k) {
                if (k < o.k) {
                    acc = acc + cc[(long long)k * C * n] * xv[k];
                }
            }
            out[(long long)c * n + s] = acc;
        }
    }
}

template <typename T>
int launch_ref(const Call& c) {
    RefOffsets o;
    for (int k = 0; k < kMaxK; ++k) {
        o.off[k] = k < c.K ? ((const long long*)c.offsets)[k] : 0;
    }
    o.k = c.K;
    long long blocks = (c.n + kThreads - 1) / kThreads;
    if (blocks > kRefMaxBlocks) {
        blocks = kRefMaxBlocks;
    }
    ref_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)c.stream>>>(
        (const T*)c.x, (const T*)c.coeffs, (T*)c.out, c.n, c.C, o);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the kernels shift_mac_cols runs
// ---------------------------------------------------------------------------

template <typename I>
struct Offsets {
    I off[kMaxK];       // offsets clamped to [-n, n]
    int k;              // K and C, read by mac_generic
    int c;
};

template <typename T, int V>
__device__ __forceinline__ void load_pack(T (&r)[V], const T* p) {
    if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
    } else {
        const double2 q = __ldg(reinterpret_cast<const double2*>(p));
        r[0] = q.x; r[1] = q.y;
    }
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const T (&r)[V]) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
        *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
    }
}

// x at the K offsets of the lattice stencil, V-wide: the middle three from
// the own pack and the adjacent lanes, the others aligned pack loads
template <typename T, int V, int K>
__device__ __forceinline__ void stencil_x(T (&xv)[K][V], const T* x, int s0,
                                          int n, bool live,
                                          const Offsets<int>& p) {
    constexpr int mid = K / 2;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k >= mid - 1 && k <= mid + 1) {
            continue;
        }
        const int j = s0 + p.off[k];
        if (live && j >= 0 && j < n) {
            load_pack<T, V>(xv[k], x + j);
        } else {
#pragma unroll
            for (int i = 0; i < V; ++i) {
                xv[k][i] = T(0);
            }
        }
    }
    T own[V];
    if (live) {
        load_pack<T, V>(own, x + s0);
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            own[i] = T(0);
        }
    }
    // the warp's edge lanes read their outer neighbour themselves
    const T edge_prev = lane == 0 && live && s0 > 0 ? __ldg(x + s0 - 1) : T(0);
    const T edge_next = lane == 31 && live && s0 + V < n ? __ldg(x + s0 + V)
                                                         : T(0);
    T prev = __shfl_up_sync(0xffffffffu, own[V - 1], 1);
    T next = __shfl_down_sync(0xffffffffu, own[0], 1);
    if (lane == 0) {
        prev = edge_prev;
    }
    if (lane == 31) {
        next = edge_next;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
        xv[mid][i] = own[i];
        xv[mid - 1][i] = i > 0 ? own[i - 1] : prev;
        xv[mid + 1][i] = i + 1 < V ? own[i + 1] : next;
    }
}

template <typename T, int K, int C>
__global__ void __launch_bounds__(kThreads)
mac_stencil(const T* __restrict__ x, const T* __restrict__ coeffs,
            T* __restrict__ out, int n, Offsets<int> p) {
    static_assert(K >= 3 && K % 2 == 1 && C > 0, "a lattice stencil form");
    constexpr int V = 16 / sizeof(T);
    const int s0 = ((int)blockIdx.x * blockDim.x + threadIdx.x) * V;
    // a live thread's V cells all lie in [0, n); dead threads of a live
    // warp stay to the shuffles with zeros
    const bool live = s0 < n;

    // every global load before the first multiply: the coefficients first
    // where they are most of the bytes (C > 1), then x, else after x
    T cf[K][C][V];
    auto load_coeffs = [&]() {
        if (live) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    load_pack<T, V>(cf[k][c], coeffs + (k * C + c) * n + s0);
                }
            }
        }
    };
    if constexpr (C > 1) {
        load_coeffs();
    }
    T xv[K][V];
    stencil_x<T, V, K>(xv, x, s0, n, live, p);
    if constexpr (C == 1) {
        load_coeffs();
    }
    if (!live) {
        return;
    }

    // multiply-adds in ascending k, one V-wide store per output row
#pragma unroll
    for (int c = 0; c < C; ++c) {
        T acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
            acc[i] = cf[0][c][i] * xv[0][i];
        }
#pragma unroll
        for (int k = 1; k < K; ++k) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
                acc[i] = acc[i] + cf[k][c][i] * xv[k][i];
            }
        }
        store_pack<T, V>(out + c * n + s0, acc);
    }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
mac_generic(const T* __restrict__ x, const T* __restrict__ coeffs,
            T* __restrict__ out, I n, Offsets<I> p) {
    const I s = (I)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n) {
        return;
    }
    T xv[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
        if (k < p.k) {
            const I j = s + p.off[k];
            xv[k] = j >= 0 && j < n ? __ldg(x + j) : T(0);
        }
    }
    for (int c = 0; c < p.c; ++c) {
        T cc[kMaxK];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
            if (k < p.k) {
                cc[k] = __ldg(coeffs + ((I)k * p.c + c) * n + s);
            }
        }
        T acc = cc[0] * xv[0];
#pragma unroll
        for (int k = 1; k < kMaxK; ++k) {
            if (k < p.k) {
                acc = acc + cc[k] * xv[k];
            }
        }
        out[(I)c * n + s] = acc;
    }
}

// one launch of `kernel`, each thread owning V cells
template <typename I>
int launch_kernel(const void* kernel, const Call& c, int V) {
    const long long blocks = ((c.n + V - 1) / V + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) {
        return (int)cudaErrorInvalidConfiguration;
    }
    I n = (I)c.n;
    Offsets<I> p;
    for (int k = 0; k < kMaxK; ++k) {
        const long long o = k < c.K ? ((const long long*)c.offsets)[k] : 0;
        p.off[k] = (I)(o < -c.n ? -c.n : (o > c.n ? c.n : o));
    }
    p.k = c.K;
    p.c = c.C;
    void* args[] = {(void*)&c.x, (void*)&c.coeffs, (void*)&c.out, &n, &p};
    return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks),
                                 dim3(kThreads), args, 0,
                                 (cudaStream_t)c.stream);
}

// whether the offsets are the lattice stencil of stencil_x for V-wide packs
bool is_stencil(const Call& c, int V) {
    const long long* off = (const long long*)c.offsets;
    const int mid = c.K / 2;
    for (int k = 0; k < c.K; ++k) {
        const long long o = off[k] < -c.n ? -c.n
                                          : (off[k] > c.n ? c.n : off[k]);
        if (k < mid - 1 || k > mid + 1 ? o % V != 0 : off[k] != k - mid) {
            return false;
        }
    }
    return true;
}

template <typename T>
int launch(const Call& c) {
    constexpr int V = 16 / sizeof(T);
    if (c.K < 1 || c.K > kMaxK || c.C < 1 || c.n < 1) {
        return (int)cudaErrorInvalidValue;
    }
    if ((long long)c.K * c.C * c.n >= (1LL << 31) || c.n >= (1LL << 30)) {
        return launch_kernel<long long>(
            (const void*)mac_generic<T, long long>, c, 1);
    }
    const bool packs = (c.K == 5 || c.K == 7) && (c.C == 1 || c.C == 3)
        && c.n % V == 0 && ((c.x | c.coeffs | c.out) & 15) == 0
        && is_stencil(c, V);
    if (packs) {
        const void* kernel =
            c.K == 5 ? (c.C == 1 ? (const void*)mac_stencil<T, 5, 1>
                                 : (const void*)mac_stencil<T, 5, 3>)
                     : (c.C == 1 ? (const void*)mac_stencil<T, 7, 1>
                                 : (const void*)mac_stencil<T, 7, 3>);
        return launch_kernel<int>(kernel, c, V);
    }
    return launch_kernel<int>((const void*)mac_generic<T, int>, c, 1);
}

// on the call's device (the current one is restored after)
template <typename T>
int on_device(const Call* c, bool baseline) {
    int cur = 0;
    cudaError_t e = cudaGetDevice(&cur);
    if (e == cudaSuccess && cur != c->device) {
        e = cudaSetDevice(c->device);
    }
    if (e != cudaSuccess) {
        return (int)e;
    }
    int rc;
    if (!baseline) {
        rc = launch<T>(*c);
    } else if (c->K < 1 || c->K > kMaxK || c->C < 1 || c->n < 1) {
        rc = (int)cudaErrorInvalidValue;
    } else {
        rc = launch_ref<T>(*c);
    }
    if (cur != c->device) {
        const cudaError_t r = cudaSetDevice(cur);
        if (rc == 0) {
            rc = (int)r;
        }
    }
    return rc;
}

}  // namespace

// The kernel (what shift_mac_cols runs).
extern "C" int shift_mac_f32(const Call* c) {
    return on_device<float>(c, false);
}

extern "C" int shift_mac_f64(const Call* c) {
    return on_device<double>(c, false);
}

// The baseline kernel, for timing the kernel above against it.
extern "C" int shift_mac_ref_f32(const Call* c) {
    return on_device<float>(c, true);
}

extern "C" int shift_mac_ref_f64(const Call* c) {
    return on_device<double>(c, true);
}
