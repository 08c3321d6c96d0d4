// Native runtime kernels for tuch_tpu: offscreen mesh rasterizer and image
// warping. Replaces the reference's OpenGL/EGL renderer (pyrender
// OffscreenRenderer, tuch/utils/renderer.py:43 -- TPU hosts have no GL) and
// the cv2/skimage crop chain in the data loader (tuch/utils/imutils.py:67).
//
// Build: g++ -O3 -march=native -shared -fPIC native.cpp -o libtuchviz.so
// Bound from Python via ctypes (tuch_tpu/viz/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// Rasterize a triangle mesh with a pinhole camera at the origin looking
// down +z (the SPIN/TUCH convention: vertices are in camera space after
// adding cam_t; y is down in image space).
//   verts:   (V, 3) float32, camera-space positions
//   faces:   (F, 3) int32
//   colors:  (V, 3) float32 per-vertex albedo in [0, 1]
//   out_rgb: (H, W, 3) float32 -- overwritten where mesh covers
//   out_mask:(H, W) float32 -- coverage in {0, 1}
//   f: focal length (pixels); cx, cy: principal point
//   Lambert shading with headlight + ambient.
void rasterize_mesh(const float* verts, int num_verts,
                    const int* faces, int num_faces,
                    const float* colors,
                    int height, int width,
                    float f, float cx, float cy,
                    float ambient,
                    float* out_rgb, float* out_mask) {
  const float INF = std::numeric_limits<float>::infinity();
  float* zbuf = new float[height * width];
  std::fill(zbuf, zbuf + height * width, INF);

  // Projected positions.
  float* px = new float[num_verts];
  float* py = new float[num_verts];
  for (int v = 0; v < num_verts; ++v) {
    float X = verts[3 * v], Y = verts[3 * v + 1], Z = verts[3 * v + 2];
    if (Z <= 1e-6f) { px[v] = -1e9f; py[v] = -1e9f; continue; }
    px[v] = f * X / Z + cx;
    py[v] = f * Y / Z + cy;
  }

  for (int t = 0; t < num_faces; ++t) {
    int i0 = faces[3 * t], i1 = faces[3 * t + 1], i2 = faces[3 * t + 2];
    // guard: a reduced vertex set paired with full-resolution faces must
    // skip, not read out of bounds (the numpy fallback raises instead)
    if (i0 < 0 || i0 >= num_verts || i1 < 0 || i1 >= num_verts ||
        i2 < 0 || i2 >= num_verts)
      continue;
    float x0 = px[i0], y0 = py[i0], z0 = verts[3 * i0 + 2];
    float x1 = px[i1], y1 = py[i1], z1 = verts[3 * i1 + 2];
    float x2 = px[i2], y2 = py[i2], z2 = verts[3 * i2 + 2];
    if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue;

    float minx = std::min({x0, x1, x2}), maxx = std::max({x0, x1, x2});
    float miny = std::min({y0, y1, y2}), maxy = std::max({y0, y1, y2});
    int ix0 = std::max(0, (int)std::floor(minx));
    int ix1 = std::min(width - 1, (int)std::ceil(maxx));
    int iy0 = std::max(0, (int)std::floor(miny));
    int iy1 = std::min(height - 1, (int)std::ceil(maxy));
    if (ix0 > ix1 || iy0 > iy1) continue;

    float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(denom) < 1e-12f) continue;
    float inv_denom = 1.0f / denom;

    // Geometric normal in camera space for Lambert shading.
    float e1x = verts[3 * i1] - verts[3 * i0];
    float e1y = verts[3 * i1 + 1] - verts[3 * i0 + 1];
    float e1z = verts[3 * i1 + 2] - verts[3 * i0 + 2];
    float e2x = verts[3 * i2] - verts[3 * i0];
    float e2y = verts[3 * i2 + 1] - verts[3 * i0 + 1];
    float e2z = verts[3 * i2 + 2] - verts[3 * i0 + 2];
    float nx = e1y * e2z - e1z * e2y;
    float ny = e1z * e2x - e1x * e2z;
    float nz = e1x * e2y - e1y * e2x;
    float nl = std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-12f;
    // headlight along -z (towards camera); two-sided shading
    float lambert = std::fabs(nz / nl);
    float shade = ambient + (1.0f - ambient) * lambert;

    // Perspective-correct interpolation uses 1/z weights.
    float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;

    for (int yy = iy0; yy <= iy1; ++yy) {
      for (int xx = ix0; xx <= ix1; ++xx) {
        float l0 = ((y1 - y2) * (xx - x2) + (x2 - x1) * (yy - y2))
                   * inv_denom;
        float l1 = ((y2 - y0) * (xx - x2) + (x0 - x2) * (yy - y2))
                   * inv_denom;
        float l2 = 1.0f - l0 - l1;
        if (l0 < 0 || l1 < 0 || l2 < 0) continue;
        float izp = l0 * iz0 + l1 * iz1 + l2 * iz2;
        float zp = 1.0f / izp;
        int idx = yy * width + xx;
        if (zp >= zbuf[idx]) continue;
        zbuf[idx] = zp;
        // perspective-correct color weights
        float w0 = l0 * iz0 * zp, w1 = l1 * iz1 * zp, w2 = l2 * iz2 * zp;
        for (int c = 0; c < 3; ++c) {
          float col = w0 * colors[3 * i0 + c] + w1 * colors[3 * i1 + c]
                    + w2 * colors[3 * i2 + c];
          out_rgb[3 * idx + c] = shade * col;
        }
        out_mask[idx] = 1.0f;
      }
    }
  }
  delete[] zbuf;
  delete[] px;
  delete[] py;
}

// Fused affine warp with bilinear sampling (float32 images, channels-last).
//   inv_t: 3x3 row-major matrix mapping OUTPUT pixel coords -> SOURCE
//   coords (pixel-center convention handled by caller).
void affine_warp_f32(const float* img, int in_h, int in_w, int channels,
                     const float* inv_t, int out_h, int out_w,
                     float* out) {
  for (int y = 0; y < out_h; ++y) {
    for (int x = 0; x < out_w; ++x) {
      float dx = x + 0.5f, dy = y + 0.5f;
      float sx = inv_t[0] * dx + inv_t[1] * dy + inv_t[2] - 0.5f;
      float sy = inv_t[3] * dx + inv_t[4] * dy + inv_t[5] - 0.5f;
      int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      float fx = sx - x0, fy = sy - y0;
      float* dst = out + (y * out_w + x) * channels;
      for (int c = 0; c < channels; ++c) dst[c] = 0.0f;
      for (int oy = 0; oy <= 1; ++oy) {
        int yy = y0 + oy;
        if (yy < 0 || yy >= in_h) continue;
        float wy = oy ? fy : 1.0f - fy;
        for (int ox = 0; ox <= 1; ++ox) {
          int xx = x0 + ox;
          if (xx < 0 || xx >= in_w) continue;
          float w = wy * (ox ? fx : 1.0f - fx);
          const float* src = img + (yy * in_w + xx) * channels;
          for (int c = 0; c < channels; ++c) dst[c] += w * src[c];
        }
      }
    }
  }
}

}  // extern "C"
