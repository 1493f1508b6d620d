// Shift-MAC over a flat lattice: out[c, s] = sum_k coeffs[k, c, s] * x[s + off[k]]
// with x read as zero outside [0, n).
//
// Replaces the Pallas TPU kernel rapidcfd_tpu/ops/pallas_gdia.py::_mac_pallas
// (dispatched by shift_mac_cols). The gdia Gauss operators (mesh/gdia.py
// gauss_mac3 / gauss_mac1) reach it: fvc.grad runs it three times per PISO
// step on a masked-lattice mesh.
//
// Design: one thread per cell slot s, grid-stride. Each thread loads the K
// shifted values of x straight from device memory (the bounds check gives
// the zero fill) and then accumulates all C rows in ascending k, the order of
// the Pallas kernel and of its plain version. The TPU version staged a
// pre-shifted (K, n) copy of x because Mosaic cannot address unaligned 1-D
// slices in VMEM; here the shifted reads of x hit L1/L2 (neighbouring
// threads read neighbouring addresses, the K streams overlap), so that copy
// is dropped.
//
// Bound: memory. Per call the kernel moves the K*C*n coefficients plus the
// C*n outputs plus one pass over x. At the pitzDaily x5 slice (n = 112000,
// K = 5, C = 3, fp32) that is 4*(15 + 3 + 1)*112000 bytes, about 8.5 MB,
// a few microseconds at 3.35 TB/s, so one call is bound by its launch.
// Offsets are passed by value in a fixed-size struct (K <= 8).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

struct Offsets {
    long long off[kMaxK];
    int k;
};

template <typename T>
__global__ void shift_mac_kernel(const T* __restrict__ x,
                                 const T* __restrict__ coeffs,
                                 T* __restrict__ out,
                                 long long n, int C, Offsets o) {
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
int launch(const void* x, const void* coeffs, void* out, long long n, int K,
           int C, const long long* offsets, void* stream) {
    if (K < 1 || K > kMaxK || C < 1 || n < 1) {
        return (int)cudaErrorInvalidValue;
    }
    Offsets o;
    for (int k = 0; k < kMaxK; ++k) {
        o.off[k] = k < K ? offsets[k] : 0;
    }
    o.k = K;
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) {
        blocks = kMaxBlocks;
    }
    shift_mac_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const T*)x, (const T*)coeffs, (T*)out, n, C, o);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shift_mac_f32(const void* x, const void* coeffs, void* out,
                             long long n, int K, int C,
                             const long long* offsets, void* stream) {
    return launch<float>(x, coeffs, out, n, K, C, offsets, stream);
}

extern "C" int shift_mac_f64(const void* x, const void* coeffs, void* out,
                             long long n, int K, int C,
                             const long long* offsets, void* stream) {
    return launch<double>(x, coeffs, out, n, K, C, offsets, stream);
}
