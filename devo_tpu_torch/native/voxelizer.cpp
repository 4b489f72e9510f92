// Native event-stream frontend.
//
// The port's own copy of devo_tpu/native/voxelizer.cpp: C++ for the
// host-side hot path of upstream DEVO's event pipeline
// (utils/event_utils.py): trilinear event->voxel splatting
// (event_utils.py:180-232, numba-jit upstream), the ms_to_idx index
// construction (:263-282), binary-search window offsets (:112-170), and the
// hot-pixel filter (:235-261). It voxelizes a live event stream at real-time
// rates where NumPy's np.add.at is the bottleneck.
//
// Exposed with a plain C ABI for ctypes binding (devo_tpu_torch/native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Trilinear splat of n events into a (bins, H, W) float32 voxel grid.
// x, y: pixel coords (float32, already rectified if rectify_map == null);
// t: microsecond timestamps (int64, ascending); p: polarity (int8, +-1/0-1);
// rectify_map: optional (H*W*2) float32 undistortion lookup applied to the
// integer raw coords before splatting.
void voxelize(const float* x, const float* y, const int64_t* t,
              const int8_t* p, int64_t n, int bins, int H, int W,
              const float* rectify_map, float* out) {
  std::memset(out, 0, sizeof(float) * bins * H * W);
  if (n == 0) return;
  const double t0 = static_cast<double>(t[0]);
  const double dur = std::max(static_cast<double>(t[n - 1]) - t0, 1e-9);
  const double tscale = (bins - 1) / dur;
  const int64_t plane = static_cast<int64_t>(H) * W;

  for (int64_t i = 0; i < n; ++i) {
    float xf = x[i], yf = y[i];
    if (rectify_map) {
      const int xi = static_cast<int>(x[i]);
      const int yi = static_cast<int>(y[i]);
      if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
      const float* r = rectify_map + 2 * (static_cast<int64_t>(yi) * W + xi);
      xf = r[0];
      yf = r[1];
    }
    const double tn = (static_cast<double>(t[i]) - t0) * tscale;
    const float pol = (p[i] > 0) ? 1.0f : -1.0f;

    const int x0 = static_cast<int>(std::floor(xf));
    const int y0 = static_cast<int>(std::floor(yf));
    const int b0 = static_cast<int>(std::floor(tn));
    const float wx = xf - x0, wy = yf - y0;
    const float wt = static_cast<float>(tn - b0);

    for (int dt = 0; dt < 2; ++dt) {
      const int b = b0 + dt;
      if (b < 0 || b >= bins) continue;
      const float wtb = pol * (dt ? wt : 1.0f - wt);
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= H) continue;
        const float wyy = wtb * (dy ? wy : 1.0f - wy);
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= W) continue;
          out[b * plane + static_cast<int64_t>(yy) * W + xx] +=
              wyy * (dx ? wx : 1.0f - wx);
        }
      }
    }
  }
}

// ms_to_idx[ms] = first index i with t[i] >= ms * 1000.
void ms_to_idx(const int64_t* t, int64_t n, int64_t n_ms, int64_t* out) {
  for (int64_t ms = 0; ms < n_ms; ++ms) {
    out[ms] = std::lower_bound(t, t + n, ms * 1000) - t;
  }
}

// First index >= t_start and first index >= t_end within t[0..n).
void window_offsets(const int64_t* t, int64_t n, int64_t t_start,
                    int64_t t_end, int64_t* lo, int64_t* hi) {
  *lo = std::lower_bound(t, t + n, t_start) - t;
  *hi = std::lower_bound(t, t + n, t_end) - t;
}

// Zero ELEMENTS whose |value| exceeds mean + num_stds * std of the raw
// signed voxel (reference event_utils.py:243-260 semantics: per-element
// threshold against signed flattened statistics; std unbiased like
// torch.std).
void remove_hot_pixels(float* vox, int bins, int H, int W, float num_stds) {
  const int64_t n = static_cast<int64_t>(bins) * H * W;
  if (n < 2) return;
  double sum = 0.0, sum2 = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    sum += vox[i];
    sum2 += static_cast<double>(vox[i]) * vox[i];
  }
  const double mean = sum / n;
  const double var =
      std::max((sum2 - sum * sum / n) / (n - 1), 0.0);  // ddof = 1
  const double thresh = mean + num_stds * std::sqrt(var);
  for (int64_t i = 0; i < n; ++i) {
    if (std::fabs(vox[i]) > thresh) vox[i] = 0.0f;
  }
}

// Fused int8 voxel-wire quantization: scale = max|v| / 127, out = rint(v /
// scale) clipped to [-127, 127]. One max pass + one fused quantize pass at
// memory speed — the NumPy equivalent in the engine's upload path
// (abs/max/rint/clip/astype) makes 4+ allocating passes over the ~6 MB
// frame voxel, which matters on the single-core bench host where quantize
// competes with step dispatch for the CPU (PERF_NOTES.md).
float quantize_i8(const float* v, int64_t n, int8_t* out) {
  float m = 0.0f;
  for (int64_t i = 0; i < n; ++i) m = std::max(m, std::fabs(v[i]));
  if (m <= 0.0f) {
    std::memset(out, 0, static_cast<size_t>(n));
    return 1.0f;
  }
  const float scale = m / 127.0f;
  const float inv = 127.0f / m;
  for (int64_t i = 0; i < n; ++i) {
    float q = std::nearbyint(v[i] * inv);
    q = std::min(std::max(q, -127.0f), 127.0f);
    out[i] = static_cast<int8_t>(q);
  }
  return scale;
}

}  // extern "C"
