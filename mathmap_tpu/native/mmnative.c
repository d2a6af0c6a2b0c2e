/* Native runtime support: pixel pack/unpack + PPM/PAM codecs.
 *
 * Reference analog: rwimg/ (C codecs returning 8-bit RGBA buffers) and the
 * render engine's 8-bit packing loop (SURVEY.md §1 layer 2, §2.1 render row
 * [unverified — reference mount empty, SURVEY.md §0]).
 *
 * Compiled at first use with the system C compiler and dlopen'd via ctypes
 * (mathmap_tpu/native/__init__.py) — the same runtime-compilation strategy
 * the reference uses for its filter code path (cgen.c), applied here to the
 * host-side IO hot loops. The device render path never touches this file.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* uint8 RGBA -> float32 RGBA in [0,1]; n = number of values (H*W*4).
 * A plain multiply — the old lazily-initialized LUT was an unsynchronized
 * data race under the threaded servers (ctypes releases the GIL), and a
 * multiply is as fast as an L1 table hit anyway. */
EXPORT void mm_u8_to_f32(const uint8_t *src, float *dst, int64_t n) {
    const float k = 1.0f / 255.0f;
    for (int64_t i = 0; i < n; i++) dst[i] = (float)src[i] * k;
}

/* float32 RGBA in [0,1] -> uint8 with clamp + round-to-nearest (the
 * reference's 8-bit packing semantics). */
EXPORT void mm_f32_to_u8(const float *src, uint8_t *dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        float v = src[i];
        if (v < 0.0f) v = 0.0f;
        if (v > 1.0f) v = 1.0f;
        dst[i] = (uint8_t)(v * 255.0f + 0.5f);
    }
}

/* Write a binary PAM (P7, RGBA) — fast frame dumps for animation batches.
 * Returns 0 on success. */
EXPORT int mm_write_pam(const char *path, const uint8_t *rgba, int width, int height) {
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    int hdr = fprintf(f,
            "P7\nWIDTH %d\nHEIGHT %d\nDEPTH 4\nMAXVAL 255\nTUPLTYPE RGB_ALPHA\nENDHDR\n",
            width, height);
    size_t n = (size_t)width * height * 4;
    size_t written = fwrite(rgba, 1, n, f);
    /* the buffered bytes only hit the disk at fclose — a full disk shows
     * up THERE, and ignoring it reported success for truncated files */
    int closed = fclose(f);
    return (hdr > 0 && written == n && closed == 0) ? 0 : -1;
}

/* Write a binary PPM (P6, RGB — alpha dropped). Returns 0 on success. */
EXPORT int mm_write_ppm(const char *path, const uint8_t *rgba, int width, int height) {
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    int hdr = fprintf(f, "P6\n%d %d\n255\n", width, height);
    size_t npix = (size_t)width * height;
    uint8_t *rgb = (uint8_t *)malloc(npix * 3);
    if (!rgb) {
        fclose(f);
        return -1;
    }
    for (size_t i = 0; i < npix; i++) {
        rgb[i * 3 + 0] = rgba[i * 4 + 0];
        rgb[i * 3 + 1] = rgba[i * 4 + 1];
        rgb[i * 3 + 2] = rgba[i * 4 + 2];
    }
    size_t written = fwrite(rgb, 1, npix * 3, f);
    free(rgb);
    int closed = fclose(f);
    return (hdr > 0 && written == npix * 3 && closed == 0) ? 0 : -1;
}

/* Read a binary PAM (P7 RGBA) or PPM (P6 RGB) into an RGBA buffer the
 * caller allocated with mm_read_header-reported dims. Returns 0 on ok. */
EXPORT int mm_read_header(const char *path, int *width, int *height, int *depth) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    char magic[3] = {0};
    if (fscanf(f, "%2s", magic) != 1) {
        fclose(f);
        return -1;
    }
    int ok = -1;
    /* dims must be positive and sane — a corrupt header must fail here
     * (falls back to Pillow) rather than crash the caller's allocation */
    const int DIM_MAX = 1 << 20;
    if (strcmp(magic, "P6") == 0) {
        int w, h, maxv;
        if (fscanf(f, "%d %d %d", &w, &h, &maxv) == 3
            && w > 0 && h > 0 && w <= DIM_MAX && h <= DIM_MAX
            && maxv == 255 /* 16-bit / low-maxval PPMs -> Pillow */) {
            *width = w; *height = h; *depth = 3;
            ok = 0;
        }
    } else if (strcmp(magic, "P7") == 0) {
        char line[256];
        int w = 0, h = 0, d = 0, maxv = 255;
        while (fgets(line, sizeof line, f)) {
            if (sscanf(line, "WIDTH %d", &w) == 1) continue;
            if (sscanf(line, "HEIGHT %d", &h) == 1) continue;
            if (sscanf(line, "DEPTH %d", &d) == 1) continue;
            if (sscanf(line, "MAXVAL %d", &maxv) == 1) continue;
            if (strncmp(line, "ENDHDR", 6) == 0) break;
        }
        if (w > 0 && h > 0 && w <= DIM_MAX && h <= DIM_MAX
            && (d == 3 || d == 4) && maxv == 255) {
            *width = w; *height = h; *depth = d;
            ok = 0;
        }
    }
    fclose(f);
    return ok;
}

EXPORT int mm_read_pixels(const char *path, uint8_t *rgba, int width, int height) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    char magic[3] = {0};
    if (fscanf(f, "%2s", magic) != 1) {
        fclose(f);
        return -1;
    }
    int depth = 0;
    if (strcmp(magic, "P6") == 0) {
        int w, h, maxv;
        if (fscanf(f, "%d %d %d", &w, &h, &maxv) != 3) {
            fclose(f);
            return -1;
        }
        fgetc(f); /* single whitespace after header */
        depth = 3;
    } else if (strcmp(magic, "P7") == 0) {
        char line[256];
        int d = 0;
        while (fgets(line, sizeof line, f)) {
            sscanf(line, "DEPTH %d", &d);
            if (strncmp(line, "ENDHDR", 6) == 0) break;
        }
        depth = d;
    } else {
        fclose(f);
        return -1;
    }
    size_t npix = (size_t)width * height;
    if (depth == 4) {
        size_t got = fread(rgba, 1, npix * 4, f);
        fclose(f);
        return got == npix * 4 ? 0 : -1;
    }
    uint8_t *rgb = (uint8_t *)malloc(npix * 3);
    if (!rgb) {
        fclose(f);
        return -1;
    }
    size_t got = fread(rgb, 1, npix * 3, f);
    fclose(f);
    if (got != npix * 3) {
        free(rgb);
        return -1;
    }
    for (size_t i = 0; i < npix; i++) {
        rgba[i * 4 + 0] = rgb[i * 3 + 0];
        rgba[i * 4 + 1] = rgb[i * 3 + 1];
        rgba[i * 4 + 2] = rgb[i * 3 + 2];
        rgba[i * 4 + 3] = 255;
    }
    free(rgb);
    return 0;
}
