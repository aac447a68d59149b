// Copied verbatim from masg_tpu/native/f0.cpp; built by masg_tpu_torch/audio/f0_native.py.
// DIO + StoneMask F0 estimation — native C++ implementation.
//
// Replaces the reference's pyworld (WORLD C++) dependency
// (preprocessor/preprocessor.py:196-201) for the offline feature path.
// Algorithmic mirror of masg_tpu/audio/f0.py (the behavioural reference,
// validated against synthetic signals); kept numerically equivalent so the
// Python and native paths are interchangeable (see tests/test_f0_native.py).
//
// C API (ctypes):
//   int dio_stonemask(const double* x, int n, int fs, double frame_period_ms,
//                     double* f0_out, int max_frames);
// returns the number of frames written, or -1 on error.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

namespace {

using cplx = std::complex<double>;

// ---------------------------------------------------------------------------
// iterative radix-2 FFT (sizes are powers of two by construction)
// ---------------------------------------------------------------------------
void fft_inplace(std::vector<cplx>& a, bool invert) {
  const int n = static_cast<int>(a.size());
  for (int i = 1, j = 0; i < n; i++) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (int len = 2; len <= n; len <<= 1) {
    const double ang = 2.0 * M_PI / len * (invert ? 1 : -1);
    const cplx wlen(std::cos(ang), std::sin(ang));
    for (int i = 0; i < n; i += len) {
      cplx w(1.0, 0.0);
      for (int j = 0; j < len / 2; j++) {
        cplx u = a[i + j];
        cplx v = a[i + j + len / 2] * w;
        a[i + j] = u + v;
        a[i + j + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (invert)
    for (auto& x : a) x /= n;
}

// zero-phase low-pass via FFT masking with a raised-cosine rolloff over one
// octave above the cutoff (mirror of _lowpass_fft in f0.py)
std::vector<double> lowpass_fft(const std::vector<double>& x, double fs,
                                double cutoff) {
  const int n = static_cast<int>(x.size());
  int nfft = 1;
  while (nfft < n + 1) nfft <<= 1;
  std::vector<cplx> buf(nfft, cplx(0, 0));
  for (int i = 0; i < n; i++) buf[i] = cplx(x[i], 0);
  fft_inplace(buf, false);
  // apply symmetric gain on the full spectrum (bins k and nfft-k share freq)
  for (int k = 0; k <= nfft / 2; k++) {
    const double freq = static_cast<double>(k) * fs / nfft;
    double gain;
    if (freq <= cutoff)
      gain = 1.0;
    else if (freq >= 2 * cutoff)
      gain = 0.0;
    else
      gain = 0.5 * (1.0 + std::cos(M_PI * (freq - cutoff) / cutoff));
    buf[k] *= gain;
    if (k > 0 && k < nfft / 2) buf[nfft - k] *= gain;
  }
  fft_inplace(buf, true);
  std::vector<double> out(n);
  for (int i = 0; i < n; i++) out[i] = buf[i].real();
  return out;
}

// sub-sample positions of negative- (or positive-) going zero crossings
std::vector<double> zero_crossings(const std::vector<double>& x, bool negative) {
  std::vector<double> events;
  for (size_t i = 0; i + 1 < x.size(); i++) {
    const bool hit = negative ? (x[i] > 0 && x[i + 1] <= 0)
                              : (x[i] < 0 && x[i + 1] >= 0);
    if (hit) {
      const double x0 = x[i], x1 = x[i + 1];
      const double frac = (x1 != x0) ? x0 / (x0 - x1) : 0.5;
      events.push_back(static_cast<double>(i) + frac);
    }
  }
  return events;
}

struct Series {
  std::vector<double> centers;  // seconds
  std::vector<double> f0s;      // Hz
};

Series interval_series(const std::vector<double>& events, double fs) {
  Series s;
  if (events.size() < 2) return s;
  s.centers.resize(events.size() - 1);
  s.f0s.resize(events.size() - 1);
  for (size_t i = 0; i + 1 < events.size(); i++) {
    const double interval = (events[i + 1] - events[i]) / fs;
    s.centers[i] = (events[i] + events[i + 1]) / 2.0 / fs;
    s.f0s[i] = 1.0 / interval;
  }
  return s;
}

// np.interp equivalent (clamped ends)
double interp1(const Series& s, double t) {
  const auto& xs = s.centers;
  const auto& ys = s.f0s;
  if (xs.empty()) return 0.0;
  if (t <= xs.front()) return ys.front();
  if (t >= xs.back()) return ys.back();
  const auto it = std::upper_bound(xs.begin(), xs.end(), t);
  const size_t hi = static_cast<size_t>(it - xs.begin());
  const size_t lo = hi - 1;
  const double w = (t - xs[lo]) / (xs[hi] - xs[lo]);
  return ys[lo] * (1 - w) + ys[hi] * w;
}

void band_candidate(const std::vector<double>& filtered, double fs,
                    const std::vector<double>& frame_times, double boundary_f0,
                    double f0_floor, double f0_ceil, std::vector<double>* cand,
                    std::vector<double>* dev) {
  const size_t nf = frame_times.size();
  cand->assign(nf, 0.0);
  dev->assign(nf, 1e30);

  std::vector<double> diff(filtered.size() > 0 ? filtered.size() - 1 : 0);
  for (size_t i = 0; i + 1 < filtered.size(); i++)
    diff[i] = filtered[i + 1] - filtered[i];

  Series series[4] = {
      interval_series(zero_crossings(filtered, true), fs),
      interval_series(zero_crossings(filtered, false), fs),
      interval_series(zero_crossings(diff, true), fs),
      interval_series(zero_crossings(diff, false), fs),
  };
  for (const auto& s : series)
    if (s.centers.size() < 2) return;  // band unusable

  for (size_t t = 0; t < nf; t++) {
    double vals[4];
    double mean = 0;
    for (int j = 0; j < 4; j++) {
      vals[j] = interp1(series[j], frame_times[t]);
      mean += vals[j];
    }
    mean /= 4.0;
    double var = 0;
    for (int j = 0; j < 4; j++) var += (vals[j] - mean) * (vals[j] - mean);
    const double std = std::sqrt(var / 4.0 + 1e-12);

    const bool ok = mean > boundary_f0 / 2.0 && mean < boundary_f0 * 2.0 &&
                    mean > f0_floor && mean < f0_ceil;
    if (ok) {
      (*cand)[t] = mean;
      (*dev)[t] = std / (mean + 1e-12);
    }
  }
}

// DIO-style contour fixing: neighbour agreement + short-run removal
void fix_contour(std::vector<double>* f0, double allowed_range) {
  const int n = static_cast<int>(f0->size());
  std::vector<char> keep(n, 0);
  for (int i = 0; i < n; i++) {
    if ((*f0)[i] <= 0) continue;
    for (int j : {i - 1, i + 1}) {
      if (j >= 0 && j < n && (*f0)[j] > 0 &&
          std::fabs((*f0)[i] - (*f0)[j]) / (*f0)[i] < allowed_range) {
        keep[i] = 1;
        break;
      }
    }
  }
  for (int i = 0; i < n; i++)
    if (!keep[i]) (*f0)[i] = 0.0;

  int run_start = -1;
  for (int i = 0; i <= n; i++) {
    const bool v = i < n && (*f0)[i] > 0;
    if (v && run_start < 0) {
      run_start = i;
    } else if (!v && run_start >= 0) {
      if (i - run_start < 3)
        for (int k = run_start; k < i; k++) (*f0)[k] = 0.0;
      run_start = -1;
    }
  }
}

std::vector<double> dio(const std::vector<double>& x_in, int fs,
                        double frame_period_ms, double f0_floor, double f0_ceil,
                        double channels_in_octave, double allowed_range,
                        std::vector<double>* times) {
  const int n_frames =
      static_cast<int>(x_in.size() / static_cast<double>(fs) * 1000.0 /
                       frame_period_ms) + 1;
  times->resize(n_frames);
  for (int i = 0; i < n_frames; i++)
    (*times)[i] = i * frame_period_ms / 1000.0;

  std::vector<double> x = x_in;
  if (!x.empty()) {
    double mean = 0;
    for (double v : x) mean += v;
    mean /= x.size();
    for (double& v : x) v -= mean;
  }

  const int n_bands = static_cast<int>(std::ceil(
                          std::log2(f0_ceil / f0_floor) * channels_in_octave)) + 1;

  std::vector<double> best_f0(n_frames, 0.0), best_dev(n_frames, 1e30);
  std::vector<double> cand, dev;
  for (int b = 0; b < n_bands; b++) {
    const double bf = f0_floor * std::pow(2.0, (b + 1) / channels_in_octave);
    const auto filtered = lowpass_fft(x, fs, bf);
    band_candidate(filtered, fs, *times, bf, f0_floor, f0_ceil, &cand, &dev);
    for (int t = 0; t < n_frames; t++) {
      if (dev[t] < best_dev[t]) {
        best_dev[t] = dev[t];
        best_f0[t] = cand[t];
      }
    }
  }
  std::vector<double> f0(n_frames, 0.0);
  for (int t = 0; t < n_frames; t++)
    if (best_dev[t] < allowed_range) f0[t] = best_f0[t];
  fix_contour(&f0, allowed_range);
  return f0;
}

// one StoneMask refinement pass: phase-difference instantaneous frequency,
// harmonic-power weighted (mirror of _refine_pass in f0.py)
void refine_pass(const std::vector<double>& x, int fs,
                 const std::vector<double>& times, std::vector<double>* f0) {
  const int n = static_cast<int>(x.size());
  for (size_t i = 0; i < f0->size(); i++) {
    const double f = (*f0)[i];
    if (f <= 0) continue;
    const int half = static_cast<int>(1.5 * fs / f);
    const int center = static_cast<int>(times[i] * fs);
    const int lo = center - half, hi = center + half;
    if (lo < 0 || hi + 1 >= n || hi - lo < 8) continue;
    const int seglen = hi - lo;

    int nfft = 1;
    while (nfft < seglen) nfft <<= 1;
    nfft <<= 1;  // 2 << ceil(log2(seglen)), matching the numpy reference

    std::vector<cplx> x1(nfft, cplx(0, 0)), x2(nfft, cplx(0, 0));
    for (int k = 0; k < seglen; k++) {
      // numpy-matching blackman window
      const double w =
          0.42 - 0.5 * std::cos(2.0 * M_PI * k / (seglen - 1)) +
          0.08 * std::cos(4.0 * M_PI * k / (seglen - 1));
      x1[k] = cplx(x[lo + k] * w, 0);
      x2[k] = cplx(x[lo + 1 + k] * w, 0);
    }
    fft_inplace(x1, false);
    fft_inplace(x2, false);

    double num = 0, den = 0;
    const int nbins = nfft / 2 + 1;
    for (int h = 1; h <= 3; h++) {
      const double target = f * h;
      const double bw = f * 0.3;
      const int k_lo = std::max(1, static_cast<int>((target - bw) * nfft / fs));
      const int k_hi =
          std::min(nbins - 1, static_cast<int>((target + bw) * nfft / fs) + 1);
      for (int k = k_lo; k <= k_hi; k++) {
        const double freq = static_cast<double>(k) * fs / nfft;
        if (freq <= target - bw || freq >= target + bw) continue;
        const cplx prod = x2[k] * std::conj(x1[k]);
        const double inst = std::atan2(prod.imag(), prod.real()) * fs /
                            (2.0 * M_PI);
        if (inst <= 0) continue;
        const double p = std::norm(x1[k]);  // |X1|^2
        num += (inst / h) * p;
        den += p;
      }
    }
    if (den > 0) {
      const double cand = num / den;
      if (std::fabs(cand - f) / f < 0.2) (*f0)[i] = cand;
    }
  }
}

}  // namespace

extern "C" {

int dio_stonemask(const double* x, int n, int fs, double frame_period_ms,
                  double* f0_out, int max_frames) {
  if (n <= 0 || fs <= 0 || frame_period_ms <= 0) return -1;
  std::vector<double> xv(x, x + n);
  std::vector<double> times;
  auto f0 = dio(xv, fs, frame_period_ms, 71.0, 800.0, 2.0, 0.1, &times);
  refine_pass(xv, fs, times, &f0);
  refine_pass(xv, fs, times, &f0);
  const int out_n = std::min<int>(static_cast<int>(f0.size()), max_frames);
  std::memcpy(f0_out, f0.data(), out_n * sizeof(double));
  return out_n;
}

int dio_only(const double* x, int n, int fs, double frame_period_ms,
             double* f0_out, int max_frames) {
  if (n <= 0 || fs <= 0 || frame_period_ms <= 0) return -1;
  std::vector<double> xv(x, x + n);
  std::vector<double> times;
  auto f0 = dio(xv, fs, frame_period_ms, 71.0, 800.0, 2.0, 0.1, &times);
  const int out_n = std::min<int>(static_cast<int>(f0.size()), max_frames);
  std::memcpy(f0_out, f0.data(), out_n * sizeof(double));
  return out_n;
}

}  // extern "C"
