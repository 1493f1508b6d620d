// foamio — host parsers for the numeric payloads of OpenFOAM ascii files
// (the port's copy of native/foamio.cpp).
//
// Parsing points/faces/owner/neighbour and nonuniform field bodies is the
// dominant host cost of loading a large ascii case, so it is native here.
// utils/foamio_native.py builds this file with g++ at first use into
// rapidcfd_tpu_torch/_build/ and binds it with ctypes (a plain C ABI); the
// numpy parse in mesh/polymesh.py is its plain version.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse whitespace/paren-separated decimal scalars. Returns the count
// parsed (<= max_out), or -1 on malformed input.
long foam_parse_scalars(const char* s, long len, double* out,
                        long max_out) {
    const char* p = s;
    const char* end = s + len;
    long n = 0;
    while (p < end && n < max_out) {
        while (p < end && (std::isspace((unsigned char)*p) || *p == '(' ||
                           *p == ')'))
            ++p;
        if (p >= end) break;
        char* q = nullptr;
        double v = std::strtod(p, &q);
        if (q == p) return -1;
        out[n++] = v;
        p = q;
    }
    return n;
}

// Parse integer labels. Returns the count parsed, or -1 on malformed
// input.
long foam_parse_labels(const char* s, long len, long long* out,
                       long max_out) {
    const char* p = s;
    const char* end = s + len;
    long n = 0;
    while (p < end && n < max_out) {
        while (p < end && (std::isspace((unsigned char)*p) || *p == '(' ||
                           *p == ')'))
            ++p;
        if (p >= end) break;
        char* q = nullptr;
        long long v = std::strtoll(p, &q, 10);
        if (q == p) return -1;
        out[n++] = v;
        p = q;
    }
    return n;
}

// Parse a face list body: sequences of "k(a b c ... )". Fills sizes[i]
// (the vertex count of face i) and the flat vertex array. Returns the
// number of faces parsed, -1 on malformed input, or -2 when the flat
// array is full (the caller retries with a larger one).
long foam_parse_faces(const char* s, long len, long long* sizes,
                      long max_faces, long long* flat, long max_flat) {
    const char* p = s;
    const char* end = s + len;
    long nf = 0;
    long nflat = 0;
    while (p < end && nf < max_faces) {
        while (p < end && (std::isspace((unsigned char)*p) || *p == ')'))
            ++p;
        if (p >= end) break;
        char* q = nullptr;
        long long k = std::strtoll(p, &q, 10);
        if (q == p || k <= 0) return -1;
        p = q;
        while (p < end && std::isspace((unsigned char)*p)) ++p;
        if (p >= end || *p != '(') return -1;
        ++p;
        for (long long i = 0; i < k; ++i) {
            if (nflat >= max_flat) return -2;
            while (p < end && std::isspace((unsigned char)*p)) ++p;
            long long v = std::strtoll(p, &q, 10);
            if (q == p) return -1;
            flat[nflat++] = v;
            p = q;
        }
        while (p < end && std::isspace((unsigned char)*p)) ++p;
        if (p >= end || *p != ')') return -1;
        ++p;
        sizes[nf++] = k;
    }
    return nf;
}

}  // extern "C"
