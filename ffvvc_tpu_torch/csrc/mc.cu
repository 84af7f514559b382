// Motion-compensation put kernel for Hopper (sm_90a): every put of one
// frame_device_mc call in one launch.
//
// It replaces no TPU kernel: the JAX package's device MC is plain XLA
// (ffvvc_tpu/ops/mc_device.py, _mc_put_math under jit).  It was added because
// the port ran each put bucket (one reference plane, size, filter class,
// wrap and box flag) as its own chain of about 40 eager PyTorch operations,
// some 1,600 buckets an inter frame at 1080p, so the host's launches and not
// the card set the pace.  Built by ffvvc_tpu_torch/ops/_build.py beside
// filters.cu, with the same flags, and bound with ctypes like it: the
// launcher is extern "C", takes device pointers, ints and the cudaStream_t,
// allocates nothing, does not synchronise and returns cudaGetLastError().
//
// The integer math is that of ops/mc_device.py::_mc_put_math, bit for bit:
// the window's samples are gathered with horizontal wraparound, clamped to
// the block's box (the DMVR prefetch window) and to the picture; a copy is
// shifted left by 14 - bd, a horizontal or vertical pass is shifted right by
// bd - 8, and the vertical pass of a two-pass put by 6.
//
// The table (ops/mc_device.py::PutTable, one int32 upload a call):
//   planes  [P, 4]: the plane's device address (two words), W, H;
//   classes [C, 10]: one per block size (w, h), in job order: w, h, the
//           output tile tw x th (at most 16 x 16), tiles across, tiles a
//           job, jobs (units) a CUDA block, first job, jobs, first block;
//   jobs    [N, 8]: x, y, frac_x | frac_y << 8, plane | luma << 16 |
//           fclass << 17 | hf << 19 | vf << 21 | boxed << 23, wrap,
//           box x0 | x1 << 16, box y0 | y1 << 16 (inside the plane), and the
//           output offset in int32 elements (a job's h x w outputs follow
//           row by row).
// A CUDA block of 256 threads takes `upb` consecutive (job, tile) units of
// one class, tw * th threads each, so that 2x2 and 4x4 chroma jobs fill a
// block as a 16x16 luma tile does; it finds its class by a binary search
// over the classes' first blocks (a few dozen classes a call).  Each unit
// stages its window ((th + 7) x (tw + 7) samples at most) in shared memory
// straight from the 16-bit plane, runs the horizontal pass of a two-pass
// put into shared int32, then writes one output a thread.
//
// What bounds it: bytes.  A put reads its window once and writes four bytes
// an output, a few tens of MB a 1080p frame, tens of microseconds at the
// card's 3.35 TB/s; chip_smoke.py times it beside that bound.  The goal of
// the design is one launch and one upload a call, not the roofline: the
// operations it replaced cost the host about a millisecond a bucket.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 7;          // the luma filter's taps - 1
constexpr int kClassCols = 10;
constexpr int kJobCols = 8;

struct McPlane {
  const short* ptr;
  int W, H;
};

struct McArgs {
  const McPlane* planes;
  const int* classes;
  const int* jobs;
  const int* lf;      // luma filter banks [3, 16, 8]
  const int* cf;      // chroma filter banks [3, 32, 4]
  int* out;
  int n_classes, bd;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// sum over k < T of s[k * step] * f[k]
template <int T, typename S>
__device__ __forceinline__ int taps(const S* s, int step, const int (&f)[8]) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < T; ++k) acc += (int)s[k * step] * f[k];
  return acc;
}

__global__ void __launch_bounds__(kThreads) mc_put_kernel(const McArgs a) {
  extern __shared__ int smem[];
  // the class of this block: the last one whose first block is <= it
  int lo = 0, hi = a.n_classes - 1;
  while (lo < hi) {
    const int m = (lo + hi + 1) >> 1;
    if (a.classes[m * kClassCols + 9] <= (int)blockIdx.x)
      lo = m;
    else
      hi = m - 1;
  }
  const int* c = a.classes + lo * kClassCols;
  const int w = c[0], h = c[1], tw = c[2], th = c[3], tiles_x = c[4];
  const int tiles = c[5], upb = c[6], job0 = c[7], njobs = c[8];
  const int area = tw * th;
  const int slot = threadIdx.x / area, li = threadIdx.x - slot * area;
  const int u = ((int)blockIdx.x - c[9]) * upb + slot;
  const bool active = slot < upb && u < njobs * tiles;
  // per unit: its window (an even number of samples, so that the int32
  // rows of the horizontal pass that follow all windows stay aligned)
  const int pitch = tw + kHalo;
  const int win_n = ((th + kHalo) * pitch + 1) & ~1;
  short* win = reinterpret_cast<short*>(smem) + slot * win_n;
  int* mid = reinterpret_cast<int*>(reinterpret_cast<short*>(smem) +
                                    upb * win_n) + slot * (th + kHalo) * tw;

  int fclass = 0, luma = 0, cw = 0, ch = 0, ox = 0, oy = 0, off = 0;
  int fh[8], fv[8];
  if (active) {
    const int j = job0 + u / tiles, t = u % tiles;
    const int* r = a.jobs + (int64_t)j * kJobCols;
    const int x = r[0], y = r[1], frac = r[2], flags = r[3], wrap = r[4];
    const McPlane p = a.planes[flags & 0xffff];
    luma = (flags >> 16) & 1;
    fclass = (flags >> 17) & 3;
    const int hfi = (flags >> 19) & 3, vfi = (flags >> 21) & 3;
    const int fx = frac & 0xff, fy = (frac >> 8) & 0xff;
    const int ntaps = luma ? 8 : 4, eb = luma ? 3 : 1;
    const int* f0 = luma ? a.lf + (hfi * 16 + fx) * 8 : a.cf + (hfi * 32 + fx) * 4;
    const int* f1 = luma ? a.lf + (vfi * 16 + fy) * 8 : a.cf + (vfi * 32 + fy) * 4;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      fh[k] = k < ntaps ? f0[k] : 0;
      fv[k] = k < ntaps ? f1[k] : 0;
    }
    const int ty = t / tiles_x;
    ox = (t - ty * tiles_x) * tw;
    oy = ty * th;
    cw = min(tw, w - ox);
    ch = min(th, h - oy);
    off = r[7] + oy * w + ox;
    // the unboxed clamp is the picture; a box lies inside it
    int bx0 = 0, bx1 = p.W - 1, by0 = 0, by1 = p.H - 1;
    if ((flags >> 23) & 1) {
      bx0 = r[5] & 0xffff;
      bx1 = (r[5] >> 16) & 0xffff;
      by0 = r[6] & 0xffff;
      by1 = (r[6] >> 16) & 0xffff;
    }
    const int gw = cw + ((fclass & 1) ? ntaps - 1 : 0);
    const int gh = ch + ((fclass & 2) ? ntaps - 1 : 0);
    const int gx0 = x + ox - ((fclass & 1) ? eb : 0);
    const int gy0 = y + oy - ((fclass & 2) ? eb : 0);
    for (int i = li; i < gw * gh; i += area) {
      const int rr = i / gw, cc = i - rr * gw;
      int gx = gx0 + cc;
      if (wrap) gx = gx < 0 ? gx + wrap : (gx > p.W - 1 ? gx - wrap : gx);
      gx = clampi(gx, bx0, bx1);
      const int gy = clampi(gy0 + rr, by0, by1);
      win[rr * pitch + cc] = p.ptr[(int64_t)gy * p.W + gx];
    }
  }
  __syncthreads();
  if (active && fclass == 3) {
    // the horizontal pass of every window row
    const int gh = ch + (luma ? 7 : 3);
    for (int i = li; i < gh * cw; i += area) {
      const int rr = i / cw, cc = i - rr * cw;
      const short* s = win + rr * pitch + cc;
      mid[rr * tw + cc] =
          (luma ? taps<8>(s, 1, fh) : taps<4>(s, 1, fh)) >> (a.bd - 8);
    }
  }
  __syncthreads();
  const int rr = li / tw, cc = li - (li / tw) * tw;
  if (!active || rr >= ch || cc >= cw) return;
  const short* s = win + rr * pitch + cc;
  int v;
  if (fclass == 0) {
    v = (int)s[0] << (14 - a.bd);
  } else if (fclass == 1) {
    v = (luma ? taps<8>(s, 1, fh) : taps<4>(s, 1, fh)) >> (a.bd - 8);
  } else if (fclass == 2) {
    v = (luma ? taps<8>(s, pitch, fv) : taps<4>(s, pitch, fv)) >> (a.bd - 8);
  } else {
    const int* m = mid + rr * tw + cc;
    v = (luma ? taps<8>(m, tw, fv) : taps<4>(m, tw, fv)) >> 6;
  }
  a.out[off + rr * w + cc] = v;
}

}  // namespace

extern "C" {

// planes: [P] McPlane records, classes: [n_classes, 10], jobs: [N, 8] (see
// the note at the top), all in device memory; lf, cf: the int32 filter
// banks; out: int32, every job's outputs; n_blocks CUDA blocks; smem: the
// dynamic shared memory a block needs (the largest class's).
int ffvvc_mc_put(const void* planes, const void* classes, int n_classes,
                 const void* jobs, const void* lf, const void* cf, void* out,
                 int n_blocks, int smem, int bd, void* stream) {
  if (n_classes <= 0 || n_blocks <= 0 || smem <= 0 || smem > 48 * 1024 ||
      bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  McArgs a;
  a.planes = (const McPlane*)planes;
  a.classes = (const int*)classes;
  a.jobs = (const int*)jobs;
  a.lf = (const int*)lf;
  a.cf = (const int*)cf;
  a.out = (int*)out;
  a.n_classes = n_classes;
  a.bd = bd;
  mc_put_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
