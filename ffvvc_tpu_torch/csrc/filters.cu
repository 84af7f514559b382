// Post-recon filter kernels for Hopper (sm_90a): SAO, ALF and CC-ALF.
//
// Each kernel is the CUDA counterpart of one Pallas kernel of the JAX
// package, computed bit-exactly in int32 (see the note above each one).
// Built by ffvvc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every launcher is extern "C", takes device
// pointers, ints and the cudaStream_t to launch on, allocates nothing, does
// not synchronise and returns cudaGetLastError() of its launch.
//
// All three are elementwise stencils with table lookups: one thread per
// output sample, a 32x8 block of threads per 32x8 tile of samples.  They
// are bound by device-memory bytes, not arithmetic: each sample costs 2-3
// int32 reads and one write, and the tap reads of neighbouring threads hit
// the same lines in L1/L2.  The TPU kernels took per-pixel parameter maps
// (up to 48 [H, W] int32 planes for ALF); these kernels read the
// parameters per CTB or per 4x4 block and expand them in registers, so no
// per-pixel parameter plane ever exists in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

dim3 grid_for(int H, int W) {
  return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
}

// ---------------------------------------------------------------------------
// SAO.  Replaces ffvvc_tpu/ops/sao_device.py::_sao_pallas (body _sao_math)
// as the fused chain runs it through fused_device._sao_apply.
//
// prm: int32 [13, ch, cw] per-CTB parameters, rows
//   0 typ, 1 m1 (band position or EO class), 2..6 offs[0..4],
//   7 kl, 8 kr, 9 kt, 10 kb, 11 ax, 12 bx.
// The TPU version expands these to nine [H, W] maps and an edge-padded
// copy of the plane; here each thread finds its CTB from
// (y >> log2_cs_v, x >> log2_cs_h), builds its keep flag from the frame
// border descriptors, and clamps neighbour coordinates at the frame edge
// (the same values jnp.pad(mode="edge") supplies).
// ---------------------------------------------------------------------------

constexpr int kSaoBand = 1;
constexpr int kSaoEdge = 2;

__global__ void sao_kernel(const int* __restrict__ src,
                           int* __restrict__ dst, int H, int W,
                           const int* __restrict__ prm, int ch, int cw,
                           int log2_cs_v, int log2_cs_h, int shift,
                           int pix_max) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int nctb = ch * cw;
  const int ci = (y >> log2_cs_v) * cw + (x >> log2_cs_h);
  const int cen = src[y * W + x];
  const int typ = prm[ci];
  const int m1 = prm[nctb + ci];
  int delta = 0;
  if (typ == kSaoBand) {
    const int rel = ((cen >> shift) - m1) & 31;
    if (rel < 4) delta = prm[(2 + rel) * nctb + ci];
  } else if (typ == kSaoEdge) {
    // neighbours a, b of the EO class (0: horizontal, 1: vertical,
    // 2: 135 degrees, 3: 45 degrees)
    int ax_ = 0, ay = 0;
    if (m1 == 0) {
      ax_ = -1;
    } else if (m1 == 1) {
      ay = -1;
    } else if (m1 == 2) {
      ax_ = -1; ay = -1;
    } else {
      ax_ = 1; ay = -1;
    }
    const int ya = clampi(y + ay, 0, H - 1), xa = clampi(x + ax_, 0, W - 1);
    const int yb = clampi(y - ay, 0, H - 1), xb = clampi(x - ax_, 0, W - 1);
    const int d = 2 + sgn(cen - src[ya * W + xa]) + sgn(cen - src[yb * W + xb]);
    delta = prm[(2 + d) * nctb + ci];
  }
  const int out = clampi(cen + delta, 0, pix_max);
  const int x_loc = x & ((1 << log2_cs_h) - 1);
  const bool in_x = x_loc >= prm[11 * nctb + ci] && x_loc < prm[12 * nctb + ci];
  const bool keep = (x == 0 && prm[7 * nctb + ci] != 0) ||
                    (x == W - 1 && prm[8 * nctb + ci] != 0) ||
                    (y == 0 && prm[9 * nctb + ci] != 0 && in_x) ||
                    (y == H - 1 && prm[10 * nctb + ci] != 0 && in_x);
  dst[y * W + x] = keep ? cen : out;
}

// ---------------------------------------------------------------------------
// ALF.  Replaces ffvvc_tpu/ops/alf_device.py::_alf_pallas (body _alf_math)
// in its fused form fused_device._alf_filter_plane.
//
// The 7x7 (luma) or 5x5 (chroma) clipped diamond: for each slot s of the
// 12-bit mask, sum cf*(clip(v0-cur, +-cl) + clip(v1-cur, +-cl)) with v0/v1
// read from the edge-padded source P3 at the virtual-boundary-resolved
// rows rowsel[k][y], round with >>7 (>>10 on the two rows at the virtual
// boundary), add to cur and clip.  The TPU kernel read 48 [H, W] planes
// (tap samples, coefficients, clips); this one reads coefficients and
// clips per block (cf/cl: int32 [nby, nbx, 12], a 4x4 block for luma and a
// CTB for chroma, set/class gather and transpose already applied) and the
// taps straight from P3, whose rows neighbouring threads share in L1.
// ---------------------------------------------------------------------------

// (row plane a, dx a, row plane b, dx b) of slot s; row planes
// 0:+0 1:+1 2:-1 3:+2 4:-2 5:+3 6:-3 (alf_device._LUMA_TAPS).  A switch
// rather than a table so that, with the slot loop unrolled, every index
// folds to a constant and row[] stays in registers.
__device__ __forceinline__ void alf_tap(int s, int& ka, int& da, int& kb,
                                        int& db) {
  switch (s) {
    case 0: ka = 5; da = 0; kb = 6; db = 0; break;
    case 1: ka = 3; da = 1; kb = 4; db = -1; break;
    case 2: ka = 3; da = 0; kb = 4; db = 0; break;
    case 3: ka = 3; da = -1; kb = 4; db = 1; break;
    case 4: ka = 1; da = 2; kb = 2; db = -2; break;
    case 5: ka = 1; da = 1; kb = 2; db = -1; break;
    case 6: ka = 1; da = 0; kb = 2; db = 0; break;
    case 7: ka = 1; da = -1; kb = 2; db = 1; break;
    case 8: ka = 1; da = -2; kb = 2; db = 2; break;
    case 9: ka = 0; da = 3; kb = 0; db = -3; break;
    case 10: ka = 0; da = 2; kb = 0; db = -2; break;
    default: ka = 0; da = 1; kb = 0; db = -1; break;
  }
}

__global__ void alf_kernel(const int* __restrict__ cur,
                           const int* __restrict__ P3, int pw,
                           const int64_t* __restrict__ rowsel,
                           const int* __restrict__ vbsel,
                           const int* __restrict__ cf,
                           const int* __restrict__ cl, int nbx,
                           int blk_log2_h, int blk_log2_w, int slots,
                           int border, int pix_max, int H, int W,
                           int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int c0 = cur[y * W + x];
  const int blk = ((y >> blk_log2_h) * nbx + (x >> blk_log2_w)) * 12;
  int64_t row[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) row[k] = rowsel[(int64_t)k * H + y] * pw;
  const int xb = border + x;
  int acc = 0;
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    if (!((slots >> s) & 1)) continue;
    int ka, da, kb, db;
    alf_tap(s, ka, da, kb, db);
    const int v0 = P3[row[ka] + xb + da];
    const int v1 = P3[row[kb] + xb + db];
    const int c = cl[blk + s];
    acc += cf[blk + s] * (clampi(v0 - c0, -c, c) + clampi(v1 - c0, -c, c));
  }
  acc = vbsel[y] != 0 ? (acc + (1 << 9)) >> 10 : (acc + 64) >> 7;
  out[y * W + x] = clampi(c0 + acc, 0, pix_max);
}

// ---------------------------------------------------------------------------
// CC-ALF.  Replaces ffvvc_tpu/ops/alf_device.py::_cc_pallas (body _cc_math)
// in its fused form fused_device._cc_filter.
//
// A 7-tap luma-to-chroma correction sum cf_j*(v_j - cur_luma) over the
// edge-padded pre-ALF luma P3l at luma column (x << hs), rounded with
// (acc + 64) >> 7, clipped to [-half, half - 1], added to chroma and
// clipped.  Coefficients are read per chroma CTB (cf: int32 [ch, cw, 7])
// instead of the TPU kernel's seven [H, W] coefficient planes and seven
// gathered tap planes.
// ---------------------------------------------------------------------------

__global__ void cc_kernel(const int* __restrict__ dst,
                          const int* __restrict__ P3l, int pw,
                          const int64_t* __restrict__ rowsel,
                          const int* __restrict__ skip,
                          const int* __restrict__ cf, int cw, int log2_cs_v,
                          int log2_cs_h, int hs, int half, int pix_max,
                          int Hc, int Wc, int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wc || y >= Hc) return;
  int acc = 0;
  if (skip[y] == 0) {
    const int64_t r0 = rowsel[y] * pw;
    const int64_t r1 = rowsel[(int64_t)Hc + y] * pw;
    const int64_t r2 = rowsel[2 * (int64_t)Hc + y] * pw;
    const int64_t r3 = rowsel[3 * (int64_t)Hc + y] * pw;
    const int xl = 3 + (x << hs);  // ALF_BORDER_LUMA + luma column
    const int* c = cf + ((y >> log2_cs_v) * cw + (x >> log2_cs_h)) * 7;
    const int cur = P3l[r1 + xl];
    acc = c[0] * (P3l[r0 + xl] - cur) + c[1] * (P3l[r1 + xl - 1] - cur) +
          c[2] * (P3l[r1 + xl + 1] - cur) + c[3] * (P3l[r2 + xl - 1] - cur) +
          c[4] * (P3l[r2 + xl] - cur) + c[5] * (P3l[r2 + xl + 1] - cur) +
          c[6] * (P3l[r3 + xl] - cur);
  }
  acc = clampi((acc + 64) >> 7, -half, half - 1);
  out[y * Wc + x] = clampi(dst[y * Wc + x] + acc, 0, pix_max);
}

}  // namespace

extern "C" {

int ffvvc_sao(const void* src, void* dst, int H, int W, const void* prm,
              int ch, int cw, int log2_cs_v, int log2_cs_h, int shift,
              int pix_max, void* stream) {
  sao_kernel<<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
               (cudaStream_t)stream>>>(
      (const int*)src, (int*)dst, H, W, (const int*)prm, ch, cw, log2_cs_v,
      log2_cs_h, shift, pix_max);
  return (int)cudaGetLastError();
}

int ffvvc_alf(const void* cur, const void* P3, int pw, const void* rowsel,
              const void* vbsel, const void* cf, const void* cl, int nbx,
              int blk_log2_h, int blk_log2_w, int slots, int border,
              int pix_max, int H, int W, void* out, void* stream) {
  alf_kernel<<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
               (cudaStream_t)stream>>>(
      (const int*)cur, (const int*)P3, pw, (const int64_t*)rowsel,
      (const int*)vbsel, (const int*)cf, (const int*)cl, nbx, blk_log2_h,
      blk_log2_w, slots, border, pix_max, H, W, (int*)out);
  return (int)cudaGetLastError();
}

int ffvvc_cc(const void* dst, const void* P3l, int pw, const void* rowsel,
             const void* skip, const void* cf, int cw, int log2_cs_v,
             int log2_cs_h, int hs, int half, int pix_max, int Hc, int Wc,
             void* out, void* stream) {
  cc_kernel<<<grid_for(Hc, Wc), dim3(kBlockX, kBlockY), 0,
              (cudaStream_t)stream>>>(
      (const int*)dst, (const int*)P3l, pw, (const int64_t*)rowsel,
      (const int*)skip, (const int*)cf, cw, log2_cs_v, log2_cs_h, hs, half,
      pix_max, Hc, Wc, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
