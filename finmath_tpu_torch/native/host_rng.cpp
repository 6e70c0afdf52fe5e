// Host-side random number generation for the CPU baseline legs.
//
// Native equivalent of the RNG machinery behind the reference's host
// Brownian-motion variants: finmath-lib's MersenneTwister (used by
// BrownianMotionFromMersenneRandomNumbers, the CPU leg of every benchmark,
// MonteCarloBlackScholesModelTest.java:78-91) and
// java.util.Random's 48-bit LCG + inverse-CDF normals
// (BrownianMotionJavaRandom.java:132-180).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// image). Normals come from the Acklam/AS241-style double-precision
// inverse normal CDF, matching finmath's
// NormalDistribution.inverseCumulativeDistribution approach.

#include <cstdint>
#include <cstddef>
#include <cmath>
#include <random>

namespace {

// Wichura's AS241 algorithm PPND16: double-precision inverse normal CDF.
double inverse_normal_cdf(double p) {
    if (p <= 0.0) return -HUGE_VAL;
    if (p >= 1.0) return HUGE_VAL;
    const double q = p - 0.5;
    double r;
    if (std::fabs(q) <= 0.425) {
        r = 0.180625 - q * q;
        return q *
            (((((((2.5090809287301226727e+3 * r + 3.3430575583588128105e+4) * r +
                   6.7265770927008700853e+4) * r + 4.5921953931549871457e+4) * r +
                 1.3731693765509461125e+4) * r + 1.9715909503065514427e+3) * r +
               1.3314166789178437745e+2) * r + 3.3871328727963666080e+0) /
            (((((((5.2264952788528545610e+3 * r + 2.8729085735721942674e+4) * r +
                   3.9307895800092710610e+4) * r + 2.1213794301586595867e+4) * r +
                 5.3941960214247511077e+3) * r + 6.8718700749205790830e+2) * r +
               4.2313330701600911252e+1) * r + 1.0);
    }
    r = (q < 0.0) ? p : 1.0 - p;
    r = std::sqrt(-std::log(r));
    double v;
    if (r <= 5.0) {
        r -= 1.6;
        v = (((((((7.74545014278341407640e-4 * r + 2.27238449892691845833e-2) * r +
                   2.41780725177450611770e-1) * r + 1.27045825245236838258e+0) * r +
                 3.64784832476320460504e+0) * r + 5.76949722146069140550e+0) * r +
               4.63033784615654529590e+0) * r + 1.42343711074968357734e+0) /
            (((((((1.05075007164441684324e-9 * r + 5.47593808499534494600e-4) * r +
                   1.51986665636164571966e-2) * r + 1.48103976427480074590e-1) * r +
                 6.89767334985100004550e-1) * r + 1.67638483018380384940e+0) * r +
               2.05319162663775882187e+0) * r + 1.0);
    } else {
        r -= 5.0;
        v = (((((((2.01033439929228813265e-7 * r + 2.71155556874348757815e-5) * r +
                   1.24266094738807843860e-3) * r + 2.65321895265761230930e-2) * r +
                 2.96560571828504891230e-1) * r + 1.78482653991729133580e+0) * r +
               5.46378491116411436990e+0) * r + 6.65790464350110377720e+0) /
            (((((((2.04426310338993978564e-15 * r + 1.42151175831644588870e-7) * r +
                   1.84631831751005468180e-5) * r + 7.86869131145613259100e-4) * r +
                 1.48753612908506148525e-2) * r + 1.36929880922735805310e-1) * r +
               5.99832206555887937690e-1) * r + 1.0);
    }
    return (q < 0.0) ? -v : v;
}

// java.util.Random's 48-bit LCG (BrownianMotionJavaRandom's generator).
struct JavaLcg {
    uint64_t state;
    explicit JavaLcg(uint64_t seed)
        : state((seed ^ 0x5DEECE66DULL) & ((1ULL << 48) - 1)) {}
    int32_t next(int bits) {
        state = (state * 0x5DEECE66DULL + 0xBULL) & ((1ULL << 48) - 1);
        return static_cast<int32_t>(state >> (48 - bits));
    }
    double next_double() {
        // sequence the two draws explicitly: as unsequenced '+' operands
        // the evaluation order — and therefore the stream — would be
        // compiler-dependent (java.util.Random draws the 26-bit word
        // first)
        const uint64_t hi = static_cast<uint64_t>(next(26)) << 27;
        const uint64_t lo = static_cast<uint64_t>(next(27));
        return (hi + lo) * 0x1.0p-53;
    }
};

// Commons-math3 MersenneTwister — the exact generator behind finmath-lib's
// net.finmath.randomnumbers.MersenneTwister (a thin wrapper around
// org.apache.commons.math3.random.MersenneTwister), which drives
// BrownianMotionFromMersenneRandomNumbers, the Brownian stream of EVERY
// reference benchmark leg (reference injects it with the device factory at
// LIBORMarketModelCalibrationTest.java:267 and
// LIBORMarketModelCalibrationATMTest.java:283). Differs from the canonical
// generator above in two ways, both load-bearing for bit-exactness:
//   1. seeding: a long seed becomes init_by_array with the TWO-word key
//      {(uint32)(seed >> 32), (uint32)seed} (commons-math3
//      MersenneTwister.setSeed(long) -> setSeed(int[])), not init_genrand;
//   2. nextDouble(): (next(26) << 26 | next(26)) * 2^-52 (commons-math3
//      BitsStreamGenerator.nextDouble()), not genrand_res53's 27+26 bits.
struct Cm3MersenneTwister {
    static constexpr int N = 624, M = 397;
    uint32_t mt_[N];
    int mti_;

    void init_genrand(uint32_t s) {
        mt_[0] = s;
        for (int i = 1; i < N; ++i)
            mt_[i] = 1812433253u * (mt_[i - 1] ^ (mt_[i - 1] >> 30)) + i;
        mti_ = N;
    }

    void init_by_array(const uint32_t* key, int key_length) {
        init_genrand(19650218u);
        int i = 1, j = 0;
        for (int k = (N > key_length ? N : key_length); k; --k) {
            mt_[i] = (mt_[i] ^ ((mt_[i - 1] ^ (mt_[i - 1] >> 30)) * 1664525u))
                     + key[j] + static_cast<uint32_t>(j);
            ++i; ++j;
            if (i >= N) { mt_[0] = mt_[N - 1]; i = 1; }
            if (j >= key_length) j = 0;
        }
        for (int k = N - 1; k; --k) {
            mt_[i] = (mt_[i] ^ ((mt_[i - 1] ^ (mt_[i - 1] >> 30)) * 1566083941u))
                     - static_cast<uint32_t>(i);
            ++i;
            if (i >= N) { mt_[0] = mt_[N - 1]; i = 1; }
        }
        mt_[0] = 0x80000000u;
    }

    explicit Cm3MersenneTwister(uint64_t seed) {
        const uint32_t key[2] = {static_cast<uint32_t>(seed >> 32),
                                 static_cast<uint32_t>(seed)};
        init_by_array(key, 2);
    }

    uint32_t next_word() {
        if (mti_ >= N) {
            uint32_t y;
            for (int k = 0; k < N - M; ++k) {
                y = (mt_[k] & 0x80000000u) | (mt_[k + 1] & 0x7fffffffu);
                mt_[k] = mt_[k + M] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
            }
            for (int k = N - M; k < N - 1; ++k) {
                y = (mt_[k] & 0x80000000u) | (mt_[k + 1] & 0x7fffffffu);
                mt_[k] = mt_[k + (M - N)] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
            }
            y = (mt_[N - 1] & 0x80000000u) | (mt_[0] & 0x7fffffffu);
            mt_[N - 1] = mt_[M - 1] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
            mti_ = 0;
        }
        uint32_t y = mt_[mti_++];
        y ^= y >> 11;
        y ^= (y << 7) & 0x9d2c5680u;
        y ^= (y << 15) & 0xefc60000u;
        y ^= y >> 18;
        return y;
    }

    double next_double() {
        // commons-math3 BitsStreamGenerator.nextDouble(): two 26-bit
        // draws (top bits of fresh words), 52-bit mantissa, scale 2^-52;
        // sequence the draws explicitly (C++ '|' is unsequenced)
        const uint64_t hi = static_cast<uint64_t>(next_word() >> 6) << 26;
        const uint64_t lo = static_cast<uint64_t>(next_word() >> 6);
        return static_cast<double>(hi | lo) * 0x1.0p-52;
    }
};

struct Generator {
    int algorithm;  // 0 = mt19937, 1 = java lcg, 2 = commons-math3 mt
    std::mt19937 mt;  // 32-bit MT19937: std::mt19937(seed) seeds exactly
                      // like the canonical init_genrand
    JavaLcg lcg;
    Cm3MersenneTwister cm3;
    Generator(int algo, uint64_t seed)
        : algorithm(algo), mt(static_cast<uint32_t>(seed)), lcg(seed),
          cm3(seed) {}
    double uniform() {
        if (algorithm == 1) return lcg.next_double();
        if (algorithm == 2) return cm3.next_double();
        // canonical genrand_res53: 53-bit uniform in [0, 1) from two
        // 32-bit outputs
        const double a = static_cast<double>(mt() >> 5);   // 27 bits
        const double b = static_cast<double>(mt() >> 6);   // 26 bits
        return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
    }
};

}  // namespace

extern "C" {

void* rng_create(int algorithm, uint64_t seed) {
    return new Generator(algorithm, seed);
}

void rng_destroy(void* gen) {
    delete static_cast<Generator*>(gen);
}

void rng_fill_uniform(void* gen, float* out, size_t n) {
    auto* g = static_cast<Generator*>(gen);
    for (size_t i = 0; i < n; ++i) out[i] = static_cast<float>(g->uniform());
}

// normals with the given standard deviation (ICDF method, like
// BrownianMotionJavaRandom: inverseCumulativeDistribution(uniform) * sqrt(dt))
void rng_fill_normal(void* gen, float* out, size_t n, double stddev) {
    auto* g = static_cast<Generator*>(gen);
    for (size_t i = 0; i < n; ++i) {
        // genrand_res53 is in [0, 1): the 2^-53-probability exact 0 would
        // map to -inf through the ICDF — clamp without perturbing any
        // other value of the canonical stream
        double u = g->uniform();
        if (u <= 0.0) u = 0x1.0p-54;
        out[i] = static_cast<float>(inverse_normal_cdf(u) * stddev);
    }
}

// double-precision variants: finmath generates Brownian increments in
// double (BrownianMotionFromMersenneRandomNumbers computes
// icdf(uniform) * sqrt(dt) in double; only the device factory casts to
// float) — the f64 stream is what bit-exact reconstruction consumes
void rng_fill_uniform_f64(void* gen, double* out, size_t n) {
    auto* g = static_cast<Generator*>(gen);
    for (size_t i = 0; i < n; ++i) out[i] = g->uniform();
}

void rng_fill_normal_f64(void* gen, double* out, size_t n, double stddev) {
    auto* g = static_cast<Generator*>(gen);
    for (size_t i = 0; i < n; ++i) {
        double u = g->uniform();
        if (u <= 0.0) u = 0x1.0p-54;
        out[i] = inverse_normal_cdf(u) * stddev;
    }
}

double rng_inverse_normal_cdf(double p) { return inverse_normal_cdf(p); }

}  // extern "C"
