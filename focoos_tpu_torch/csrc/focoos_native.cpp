// focoos-tpu native runtime kernels (host side): the port's copy of native/focoos_native.cpp.
//
// The reference delegates mask work to pycocotools' C extension and COCO
// evaluation to faster_coco_eval's C++ core; neither is a dependency of the
// port, so this module provides the native equivalents consumed
// via ctypes (focoos_tpu_torch/utils/native.py):
//   - COCO column-major RLE encode/decode
//   - dense mask-IoU matrices (the hot loop of instance-segmentation eval)
//   - bbox-IoU matrices with the COCO crowd convention
//
// Built at first use by focoos_tpu_torch/utils/native.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// COCO RLE: column-major runs, starting with a run of zeros.
// Returns the number of counts written, or -1 if max_counts is too small.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts_out, int max_counts) {
    int n = 0;
    uint8_t prev = 0;
    uint32_t run = 0;
    for (int x = 0; x < w; ++x) {
        for (int y = 0; y < h; ++y) {
            uint8_t v = mask[(size_t)y * w + x] ? 1 : 0;
            if (v == prev) {
                ++run;
            } else {
                if (n >= max_counts) return -1;
                counts_out[n++] = run;
                prev = v;
                run = 1;
            }
        }
    }
    if (n >= max_counts) return -1;
    counts_out[n++] = run;
    return n;
}

void rle_decode(const uint32_t* counts, int n, int h, int w, uint8_t* mask_out) {
    std::memset(mask_out, 0, (size_t)h * w);
    size_t pos = 0;
    uint8_t v = 0;
    for (int i = 0; i < n; ++i) {
        for (uint32_t j = 0; j < counts[i]; ++j) {
            if (pos >= (size_t)h * w) return;
            int x = (int)(pos / h);
            int y = (int)(pos % h);
            mask_out[(size_t)y * w + x] = v;
            ++pos;
        }
        v = 1 - v;
    }
}

// area of an RLE (sum of foreground runs)
uint64_t rle_area(const uint32_t* counts, int n) {
    uint64_t a = 0;
    for (int i = 1; i < n; i += 2) a += counts[i];
    return a;
}

// Dense-mask IoU matrix: masks_a [na, hw] uint8, masks_b [nb, hw] uint8,
// crowd [nb] uint8 (COCO convention: IoA for crowd gts). Output [na, nb].
void mask_iou_matrix(const uint8_t* masks_a, int na,
                     const uint8_t* masks_b, int nb,
                     long hw, const uint8_t* crowd, float* iou_out) {
    // precompute areas
    long* area_a = new long[na];
    long* area_b = new long[nb];
    for (int i = 0; i < na; ++i) {
        long s = 0;
        const uint8_t* m = masks_a + (size_t)i * hw;
        for (long k = 0; k < hw; ++k) s += m[k];
        area_a[i] = s;
    }
    for (int j = 0; j < nb; ++j) {
        long s = 0;
        const uint8_t* m = masks_b + (size_t)j * hw;
        for (long k = 0; k < hw; ++k) s += m[k];
        area_b[j] = s;
    }
    for (int i = 0; i < na; ++i) {
        const uint8_t* ma = masks_a + (size_t)i * hw;
        for (int j = 0; j < nb; ++j) {
            const uint8_t* mb = masks_b + (size_t)j * hw;
            long inter = 0;
            for (long k = 0; k < hw; ++k) inter += (ma[k] & mb[k]);
            double uni = crowd && crowd[j]
                             ? (double)area_a[i]
                             : (double)(area_a[i] + area_b[j] - inter);
            iou_out[(size_t)i * nb + j] = uni > 0 ? (float)(inter / uni) : 0.0f;
        }
    }
    delete[] area_a;
    delete[] area_b;
}

// bbox IoU matrix, xyxy, crowd convention on b.
void bbox_iou_matrix(const float* boxes_a, int na,
                     const float* boxes_b, int nb,
                     const uint8_t* crowd, float* iou_out) {
    for (int i = 0; i < na; ++i) {
        const float* a = boxes_a + (size_t)i * 4;
        float area_a = std::max(0.0f, a[2] - a[0]) * std::max(0.0f, a[3] - a[1]);
        for (int j = 0; j < nb; ++j) {
            const float* b = boxes_b + (size_t)j * 4;
            float area_b = std::max(0.0f, b[2] - b[0]) * std::max(0.0f, b[3] - b[1]);
            float iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
            float ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
            float inter = std::max(0.0f, iw) * std::max(0.0f, ih);
            float uni = crowd && crowd[j] ? area_a : area_a + area_b - inter;
            iou_out[(size_t)i * nb + j] = uni > 0 ? inter / uni : 0.0f;
        }
    }
}

}  // extern "C"
