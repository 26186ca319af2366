// Fused photometric augmentation over interleaved uint8 RGB — the native
// (C++) hot path of the training data loader.
//
// Behavioral contract: one call == the reference's torchvision ColorJitter
// (brightness / contrast / saturation / hue in a random order) followed by
// AdjustGamma, as re-implemented on PIL in nmrf_tpu_torch/data/transforms.py
// (parity target: reference nmrf/data/transforms.py:31-155).  The PIL
// pipeline costs 6+ full-image passes with an image allocation each
// (ImageEnhance degenerate images, an RGB->HSV->RGB mode-convert round
// trip, a float power per pixel); this does the whole chain in-place.
//
// Exactness vs PIL (empirically validated over exhaustive 2^24 RGB
// enumeration, see tests/test_native_photometric.py; this copy is held
// against the JAX package's in tests/test_torch_data.py):
//   * brightness / contrast / saturation: bit-exact.  PIL's
//     Image.blend(degenerate, img, f) is out = (int)(d + f*(v-d)) in
//     float32, clipped — reproduced here via 256- and 64Ki-entry LUTs.
//     Contrast's gray constant is int(mean(L) + 0.5) with L the ITU-R
//     601-2 luma PIL computes as (19595 R + 38470 G + 7471 B + 2^15) >> 16.
//   * hue: the RGB->HSV->RGB round trip matches PIL within +-1 on the H
//     channel for 0.17% of triples (PIL's convert.c float ordering is not
//     exactly recoverable); S/V are bit-exact and HSV->RGB matches PIL on
//     all but 2 of the 2^24 inputs.  Net fused-pipeline error vs the PIL
//     path is a few uint8 LSB on <1% of pixels — augmentation noise.
//   * gamma: the 256-entry LUT is computed by the CALLER with the exact
//     numpy expression from transforms._adjust_gamma, so it is bit-exact
//     by construction.
//
// Build: g++ -O3 -shared -fPIC (see nmrf_tpu_torch/native/__init__.py, which
// compiles on first use into nmrf_tpu_torch/_build/ and raises if the
// build fails).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint8_t clip8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : (uint8_t)v); }

// PIL RGB->L luma (convert.c L24 macro): rounded fixed-point 601-2.
inline int luma(uint8_t r, uint8_t g, uint8_t b) {
    return (19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16;
}

// PIL Image.blend(degenerate=d, image=v, factor=f): float32 truncation.
inline uint8_t blend1(int d, int v, float f) {
    return clip8((int)((float)d + f * (float)(v - d)));
}

// PIL convert.c RGB->HSV (float32 formulation; H within +-1 of PIL on
// 0.17% of inputs, S/V exact — validated by enumeration).
inline void rgb2hsv1(uint8_t r, uint8_t g, uint8_t b,
                     uint8_t* H, uint8_t* S, uint8_t* V) {
    uint8_t maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    uint8_t minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    *V = maxc;
    if (maxc == minc) { *H = 0; *S = 0; return; }
    float cr = (float)(maxc - minc);
    *S = (uint8_t)((255 * (maxc - minc)) / maxc);
    float rc = (float)(maxc - r) / cr;
    float gc = (float)(maxc - g) / cr;
    float bc = (float)(maxc - b) / cr;
    float h;
    if (r == maxc) h = bc - gc;
    else if (g == maxc) h = 2.0f + rc - bc;
    else h = 4.0f + gc - rc;
    h = h / 6.0f;
    if (h < 0.0f) h += 1.0f;
    int hi = (int)(h * 255.0f);
    *H = (uint8_t)(hi > 255 ? 255 : hi);
}

// PIL convert.c HSV->RGB (colorsys sextant form, half-up rounding —
// matches PIL on all but 2 of the 2^24 HSV triples).
inline void hsv2rgb1(uint8_t h8, uint8_t s8, uint8_t v8,
                     uint8_t* r, uint8_t* g, uint8_t* b) {
    if (s8 == 0) { *r = v8; *g = v8; *b = v8; return; }
    float hf = (float)h8 / 255.0f;
    float h6 = hf * 6.0f;
    int i = (int)h6;
    float f = h6 - (float)i;
    i %= 6;
    float s = (float)s8 / 255.0f;
    float v = (float)v8;
    uint8_t p = clip8((int)(v * (1.0f - s) + 0.5f));
    uint8_t q = clip8((int)(v * (1.0f - s * f) + 0.5f));
    uint8_t t = clip8((int)(v * (1.0f - s * (1.0f - f)) + 0.5f));
    switch (i) {
        case 0: *r = v8; *g = t;  *b = p;  break;
        case 1: *r = q;  *g = v8; *b = p;  break;
        case 2: *r = p;  *g = v8; *b = t;  break;
        case 3: *r = p;  *g = q;  *b = v8; break;
        case 4: *r = t;  *g = p;  *b = v8; break;
        default: *r = v8; *g = p; *b = q;  break;
    }
}

void apply_lut3(uint8_t* img, long long npix, const uint8_t* lut) {
    long long n = npix * 3;
    for (long long i = 0; i < n; ++i) img[i] = lut[img[i]];
}

}  // namespace

extern "C" {

// Test hooks (whole-image converts, interleaved u8 RGB / HSV).
void nmrf_rgb2hsv(const uint8_t* rgb, uint8_t* hsv, long long npix) {
    for (long long i = 0; i < npix; ++i)
        rgb2hsv1(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2],
                 &hsv[3 * i], &hsv[3 * i + 1], &hsv[3 * i + 2]);
}

void nmrf_hsv2rgb(const uint8_t* hsv, uint8_t* rgb, long long npix) {
    for (long long i = 0; i < npix; ++i)
        hsv2rgb1(hsv[3 * i], hsv[3 * i + 1], hsv[3 * i + 2],
                 &rgb[3 * i], &rgb[3 * i + 1], &rgb[3 * i + 2]);
}

// In-place fused pipeline.  ops[j] in {0 brightness, 1 contrast,
// 2 saturation, 3 hue}, applied in order; hue_shift is the integer H-channel
// offset int(round(hue_factor * 255)) from transforms._adjust_hue; gamma_lut
// (256 entries) applied last when has_gamma != 0.
void nmrf_photometric(uint8_t* img, long long npix,
                      const int32_t* ops, int n_ops,
                      float bf, float cf, float sf, int hue_shift,
                      const uint8_t* gamma_lut, int has_gamma) {
    for (int j = 0; j < n_ops; ++j) {
        switch (ops[j]) {
            case 0: {  // brightness: blend from black
                uint8_t lut[256];
                for (int v = 0; v < 256; ++v) lut[v] = blend1(0, v, bf);
                apply_lut3(img, npix, lut);
                break;
            }
            case 1: {  // contrast: blend from the mean-luma constant image
                unsigned long long sum = 0;
                for (long long i = 0; i < npix; ++i)
                    sum += luma(img[3 * i], img[3 * i + 1], img[3 * i + 2]);
                int m = (int)((double)sum / (double)npix + 0.5);
                uint8_t lut[256];
                for (int v = 0; v < 256; ++v) lut[v] = blend1(m, v, cf);
                apply_lut3(img, npix, lut);
                break;
            }
            case 2: {  // saturation: blend from the per-pixel luma image
                static_assert(sizeof(uint8_t) == 1, "");
                uint8_t* lut = new uint8_t[256 * 256];
                for (int d = 0; d < 256; ++d)
                    for (int v = 0; v < 256; ++v)
                        lut[d * 256 + v] = blend1(d, v, sf);
                for (long long i = 0; i < npix; ++i) {
                    uint8_t* px = img + 3 * i;
                    const uint8_t* row = lut + 256 * luma(px[0], px[1], px[2]);
                    px[0] = row[px[0]]; px[1] = row[px[1]]; px[2] = row[px[2]];
                }
                delete[] lut;
                break;
            }
            case 3: {  // hue: HSV round trip with H-channel rotation
                for (long long i = 0; i < npix; ++i) {
                    uint8_t* px = img + 3 * i;
                    uint8_t H, S, V;
                    rgb2hsv1(px[0], px[1], px[2], &H, &S, &V);
                    H = (uint8_t)(((int)H + hue_shift) & 255);
                    hsv2rgb1(H, S, V, &px[0], &px[1], &px[2]);
                }
                break;
            }
        }
    }
    if (has_gamma) apply_lut3(img, npix, gamma_lut);
}

}  // extern "C"
