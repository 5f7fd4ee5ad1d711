// audio_runtime — host-side audio ops of the service path, called through ctypes.
//
// The port's copy of the JAX package's native/audio_runtime.cpp, with the same C
// functions and arithmetic: PCM conversion, crossfade stitching and the
// voice-validation scan, bound by gonova_tts_tpu_torch/utils/native.py, which keeps
// numpy forms for a host where the library does not build. ops/_build.py compiles
// it with the host compiler (c++ -O3 -fPIC -shared -std=c++17) into build/.
//
// All functions are C ABI, operate on caller-owned buffers, and are thread-safe
// (no global state).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// float32 [-1,1] → int16 PCM with clipping. Returns n.
int64_t f32_to_i16(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        v = v > 1.0f ? 1.0f : (v < -1.0f ? -1.0f : v);
        out[i] = (int16_t)lrintf(v * 32767.0f);
    }
    return n;
}

// int16 PCM → float32 (libsndfile convention: divide by 32768).
int64_t i16_to_f32(const int16_t* in, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = (float)in[i] / 32768.0f;
    return n;
}

// Equal-power crossfade join: a (na) + b (nb) with `overlap` samples fused.
// out must hold na + nb - overlap. Returns output length, or -1 on bad args.
int64_t crossfade_join(const float* a, int64_t na, const float* b, int64_t nb,
                       int64_t overlap, float* out) {
    if (overlap < 0 || overlap > na || overlap > nb) return -1;
    int64_t head = na - overlap;
    std::memcpy(out, a, (size_t)head * sizeof(float));
    for (int64_t i = 0; i < overlap; ++i) {
        // sin^2 / cos^2 fades sum to 1 (matches audio/ola.py stitch()).
        // overlap==1: numpy linspace(0, pi/2, 1) == [0] => fade_out=1 (a wins),
        // matching audio/ola.py exactly — t=1.0 here would output b[0] instead.
        double t = overlap > 1 ? (double)i / (double)(overlap - 1) : 0.0;
        double fi = std::sin(t * M_PI / 2.0);
        double fo = std::cos(t * M_PI / 2.0);
        out[head + i] = (float)(a[head + i] * fo * fo + b[i] * fi * fi);
    }
    std::memcpy(out + na, b + overlap, (size_t)(nb - overlap) * sizeof(float));
    return na + nb - overlap;
}

// Validation scan in one pass: mean square energy, peak absolute value.
void audio_stats(const float* in, int64_t n, double* mean_sq, double* peak) {
    double acc = 0.0, pk = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double v = in[i];
        acc += v * v;
        double a = std::fabs(v);
        if (a > pk) pk = a;
    }
    *mean_sq = n > 0 ? acc / (double)n : 0.0;
    *peak = pk;
}

// Hann-windowed fade applied in place to the first / last `n_fade` samples
// (declick for chunk boundaries in the streaming send path).
void declick(float* buf, int64_t n, int64_t n_fade) {
    n_fade = std::min(n_fade, n / 2);
    for (int64_t i = 0; i < n_fade; ++i) {
        double w = 0.5 - 0.5 * std::cos(M_PI * (double)i / (double)n_fade);
        buf[i] *= (float)w;
        buf[n - 1 - i] *= (float)w;
    }
}

}  // extern "C"
