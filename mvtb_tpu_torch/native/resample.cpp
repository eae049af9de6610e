// Native host-side resampler for the MONAI-pinned Spacing transform.
//
// Replaces scipy.ndimage.map_coordinates in the preprocessing hot path
// (mvtb_tpu_torch/data/preprocess.py::resample_to_spacing): each output voxel j is
// sampled at input coordinate M[:3,:3] @ j + M[:3,3] with order-0 (nearest)
// or order-1 (trilinear) interpolation and border clamping — exactly
// map_coordinates(order, mode="nearest") semantics, with all interpolation
// arithmetic in double (the scipy path casts the volume to float64 first).
//
// The reference has no native code (SURVEY.md 2.5); this exists because the
// host must decode+resample 240x240x155x4 volumes fast enough to feed the
// device (CacheDataset-style: once per cached sample).
//
// Build: g++ -O3 -march=native -shared -fPIC resample.cpp -o libmvtbnative.so
// (mvtb_tpu_torch/native/__init__.py builds on demand into build/).

#include <cmath>
#include <cstdint>

extern "C" {

// in:  (C, ix, iy, iz) float32, C-contiguous
// m:   row-major 3x4 matrix mapping output voxel -> input voxel coordinates
// out: (C, ox, oy, oz) float32, C-contiguous (pre-allocated)
// order: 0 = nearest, 1 = trilinear; both clamp coordinates to the border
void resample3d_f32(const float* in, int64_t C, int64_t ix, int64_t iy,
                    int64_t iz, const double* m, float* out, int64_t ox,
                    int64_t oy, int64_t oz, int order) {
    const int64_t in_stride_c = ix * iy * iz;
    const int64_t in_stride_x = iy * iz;
    const int64_t in_stride_y = iz;
    const int64_t out_stride_c = ox * oy * oz;

    for (int64_t jx = 0; jx < ox; ++jx) {
        for (int64_t jy = 0; jy < oy; ++jy) {
            // coordinate of (jx, jy, 0) plus the per-jz increment (column 2)
            double bx = m[0] * jx + m[1] * jy + m[3];
            double by = m[4] * jx + m[5] * jy + m[7];
            double bz = m[8] * jx + m[9] * jy + m[11];
            for (int64_t jz = 0; jz < oz; ++jz) {
                double cx = bx + m[2] * jz;
                double cy = by + m[6] * jz;
                double cz = bz + m[10] * jz;
                // border clamp (mode="nearest")
                if (cx < 0) cx = 0; else if (cx > ix - 1) cx = ix - 1;
                if (cy < 0) cy = 0; else if (cy > iy - 1) cy = iy - 1;
                if (cz < 0) cz = 0; else if (cz > iz - 1) cz = iz - 1;
                const int64_t o = jx * oy * oz + jy * oz + jz;

                if (order == 0) {
                    // scipy order-0 rounds half toward... np/scipy use
                    // floor(c + 0.5) for nearest (round-half-up)
                    int64_t nx = (int64_t)std::floor(cx + 0.5);
                    int64_t ny = (int64_t)std::floor(cy + 0.5);
                    int64_t nz = (int64_t)std::floor(cz + 0.5);
                    if (nx > ix - 1) nx = ix - 1;
                    if (ny > iy - 1) ny = iy - 1;
                    if (nz > iz - 1) nz = iz - 1;
                    const int64_t base = nx * in_stride_x + ny * in_stride_y + nz;
                    for (int64_t c = 0; c < C; ++c)
                        out[c * out_stride_c + o] = in[c * in_stride_c + base];
                } else {
                    int64_t x0 = (int64_t)std::floor(cx);
                    int64_t y0 = (int64_t)std::floor(cy);
                    int64_t z0 = (int64_t)std::floor(cz);
                    if (x0 > ix - 2) x0 = ix >= 2 ? ix - 2 : 0;
                    if (y0 > iy - 2) y0 = iy >= 2 ? iy - 2 : 0;
                    if (z0 > iz - 2) z0 = iz >= 2 ? iz - 2 : 0;
                    const double fx = cx - x0, fy = cy - y0, fz = cz - z0;
                    const int64_t x1 = (x0 + 1 < ix) ? x0 + 1 : x0;
                    const int64_t y1 = (y0 + 1 < iy) ? y0 + 1 : y0;
                    const int64_t z1 = (z0 + 1 < iz) ? z0 + 1 : z0;
                    const double w000 = (1 - fx) * (1 - fy) * (1 - fz);
                    const double w001 = (1 - fx) * (1 - fy) * fz;
                    const double w010 = (1 - fx) * fy * (1 - fz);
                    const double w011 = (1 - fx) * fy * fz;
                    const double w100 = fx * (1 - fy) * (1 - fz);
                    const double w101 = fx * (1 - fy) * fz;
                    const double w110 = fx * fy * (1 - fz);
                    const double w111 = fx * fy * fz;
                    for (int64_t c = 0; c < C; ++c) {
                        const float* p = in + c * in_stride_c;
                        const double v =
                            w000 * p[x0 * in_stride_x + y0 * in_stride_y + z0] +
                            w001 * p[x0 * in_stride_x + y0 * in_stride_y + z1] +
                            w010 * p[x0 * in_stride_x + y1 * in_stride_y + z0] +
                            w011 * p[x0 * in_stride_x + y1 * in_stride_y + z1] +
                            w100 * p[x1 * in_stride_x + y0 * in_stride_y + z0] +
                            w101 * p[x1 * in_stride_x + y0 * in_stride_y + z1] +
                            w110 * p[x1 * in_stride_x + y1 * in_stride_y + z0] +
                            w111 * p[x1 * in_stride_x + y1 * in_stride_y + z1];
                        out[c * out_stride_c + o] = (float)v;
                    }
                }
            }
        }
    }
}

}  // extern "C"
