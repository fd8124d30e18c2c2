/* Native host-I/O runtime for pi_sph_fluid_tpu_torch (a copy of the JAX
 * package's csrc/host_io.c).
 *
 * The GPU owns the physics; the host shell around it is latency-sensitive
 * plumbing, which the reference implements in C with pthreads
 * (pi_sph_fluid.c:414-470).  This library is the native equivalent of that
 * layer, loaded via ctypes (io/native.py) with pure-Python fallbacks:
 *
 *   - sysfs IIO accelerometer reads (MPU6050 gravity input,
 *     pi_sph_fluid.c:417-445): open/read/parse without Python overhead so a
 *     high-rate poll thread costs nothing.
 *   - 1-bpp page-packed framebuffer -> ANSI half-block terminal blit
 *     (the desktop display sink, replacing the SSD1306/SDL driver,
 *     pi_sph_fluid.c:466-470): one write() per frame, diff-free repaint.
 *   - hybrid sleep/spin pacing to a wall-clock deadline (REALTIME mode,
 *     pi_sph_fluid.c:694-701, without burning a core like the reference's
 *     pure spin).
 *
 * Build: io/native.py compiles it with gcc on first use into build/.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

/* ---------------- sysfs IIO (MPU6050) ---------------- */

/* Read one integer from a sysfs file; returns 0 on success. */
int sph_read_sysfs_int(const char *path, long *out) {
    FILE *f = fopen(path, "r");
    if (!f) return -1;
    long v;
    int ok = fscanf(f, "%ld", &v);
    fclose(f);
    if (ok != 1) return -2;
    *out = v;
    return 0;
}

/* Read the accelerometer x/y raw values and project to a screen-plane
 * gravity vector exactly like the reference (pi_sph_fluid.c:436-440):
 * gx = +y_raw/2^14 * g, gy = -x_raw/2^14 * g. */
int sph_read_gravity(const char *device_dir, float g_mag, float *gx, float *gy) {
    char path[512];
    long ax, ay;
    snprintf(path, sizeof path, "%s/in_accel_x_raw", device_dir);
    if (sph_read_sysfs_int(path, &ax)) return -1;
    snprintf(path, sizeof path, "%s/in_accel_y_raw", device_dir);
    if (sph_read_sysfs_int(path, &ay)) return -1;
    *gx = (float)ay / (float)(1 << 14) * g_mag;
    *gy = -(float)ax / (float)(1 << 14) * g_mag;
    return 0;
}

/* ---------------- framebuffer -> terminal ---------------- */

/* Render a page-packed 1-bpp framebuffer (byte (i/8)*cols + j holds bit
 * i%8, pi_sph_fluid.c:407-408) as unicode half-blocks into `out`
 * (caller-allocated).  Two pixel rows per text row.  Returns bytes
 * written, or -1 if out_cap is too small. */
long sph_blit_halfblocks(const uint8_t *fb, int rows, int cols,
                         char *out, long out_cap) {
    /* each cell is up to 3 bytes of UTF-8 + newline per row */
    static const char *glyph[4] = {" ", "\xe2\x96\x80", "\xe2\x96\x84", "\xe2\x96\x88"};
    long w = 0;
    for (int i = 0; i < rows; i += 2) {
        for (int j = 0; j < cols; j++) {
            int top = (fb[(i / 8) * cols + j] >> (i % 8)) & 1;
            int bot = (fb[((i + 1) / 8) * cols + j] >> ((i + 1) % 8)) & 1;
            const char *g = glyph[top | (bot << 1)];
            long n = (long)strlen(g);
            if (w + n + 1 >= out_cap) return -1;
            memcpy(out + w, g, n);
            w += n;
        }
        out[w++] = '\n';
    }
    return w;
}

/* ---------------- pacing ---------------- */

double sph_monotonic_s(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec / 1e9;
}

/* Sleep-then-spin to an absolute CLOCK_MONOTONIC deadline (seconds).
 * Sleeps until 200us before the deadline, then spins — the precision of
 * the reference's spin-wait (pi_sph_fluid.c:696-701) without pinning a
 * core for the whole interval.  Returns the overshoot in seconds. */
double sph_pace_until(double deadline_s) {
    const double spin_margin = 200e-6;
    double now = sph_monotonic_s();
    if (deadline_s - now > spin_margin) {
        double sleep_s = deadline_s - now - spin_margin;
        struct timespec req;
        req.tv_sec = (time_t)sleep_s;
        req.tv_nsec = (long)((sleep_s - (double)req.tv_sec) * 1e9);
        nanosleep(&req, NULL);
    }
    while ((now = sph_monotonic_s()) < deadline_s) {
        /* spin */
    }
    return now - deadline_s;
}
