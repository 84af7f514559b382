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
// Samples travel as 16-bit integers (the wire type of the fused chain) and
// are widened to int32 in shared memory and registers only.  SAO and ALF
// work on 64x16-sample tiles: a block of 16x16 threads stages its tile plus
// a halo into shared memory once, clamping coordinates at the picture edge
// (the values an edge-padded copy would hold, so no padded copy exists),
// and every thread then filters four neighbouring samples of one row, which
// it reads from the tile with 16-byte shared loads and writes with one
// 8-byte store.  Parameters are read per CTB or per 4x4 block, never per
// sample.  Pictures whose slices or tiles forbid filtering across their
// boundaries are covered per CTB: SAO keeps the samples of a CTB's border
// that its descriptor names, ALF and CC-ALF clamp their taps to the CTB
// where its edge word says so (template parameter EDGES, so that pictures
// without such boundaries pay nothing for it).  CC-ALF reads each luma
// sample at most twice and so takes it straight from device memory, both
// chroma planes in one launch.
//
// Every launcher also filters a slab: a band of picture rows, as the mesh
// (parallel/filters.py) cuts a picture.  A plane is then given by the
// picture row of its first output row (row0), the number of output rows
// (H), the picture's height (pic_h) and the picture rows [rlo, rhi] that
// its source buffer holds, the slab's halo included; the source pointer
// points at picture row row0 inside that buffer.  Rows are clamped to
// [rlo, rhi] where they are clamped to the picture otherwise, and
// everything that depends on the row (the CTB, the picture's bottom
// border, the virtual boundary) is computed from the picture row, so a
// slab's rows come out as a whole-picture launch computes them wherever
// the halo covers what they read.  Tiles stay on the picture's grid of
// 16-row bands (a tile's rows lie in one CTB row), the first and last
// band of a slab only in part.  row0 = 0, H = pic_h, rlo = 0,
// rhi = pic_h - 1 is the whole-picture launch.
//
// chip_smoke.py computes each kernel's bound and PERF.md has the times.
// The least time of SAO and CC-ALF is that of their bytes (2 in, 2 out per
// sample), of luma and chroma ALF that of their integer operations (a tap
// pair is subtract, clip, subtract, clip, add, multiply-add: about 100 a
// luma sample, half on each integer pipe).  None runs at its bound: measured
// on an H100, the time of each is set by the instructions it executes
// (address arithmetic, staging and SAO's divergent band and edge paths
// included) and, for ALF, by its shared-memory reads, not by device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;   // samples per tile row
constexpr int kTileH = 16;   // tile rows = threads along y
constexpr int kLane = 4;     // samples per thread along x
constexpr int kThreadsX = kTileW / kLane;
// column halo of the shared tile: 4 (not the 3 the widest filter needs) so
// that a thread's 16-byte shared loads stay aligned
constexpr int kPadX = 4;
constexpr int kPitch = kTileW + 2 * kPadX;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Stage picture rows [y0 - HY, y0 + kTileH + HY) x columns [x0 - kPadX,
// x0 + kTileW + kPadX) of a 16-bit plane into `tile` (int32, kPitch words a
// row), coordinates clamped to the picture (rows to [rlo, rhi], the rows
// the slab's buffer holds): the samples jnp.pad(mode="edge") supplies.
// src points at picture row row0.  A work item is four neighbouring samples:
// one 8-byte load where all four lie inside the picture (x0 and the
// picture's width are multiples of 4, so the address is aligned), clamped
// 2-byte loads at the left and right edge; one 16-byte shared store.
template <int HY>
__device__ __forceinline__ void stage_tile(const short* __restrict__ src,
                                           int row0, int rlo, int rhi, int W,
                                           int x0, int y0, int* tile) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  constexpr int groups = kPitch / 4;
  constexpr int n = (kTileH + 2 * HY) * groups;
  for (int i = tid; i < n; i += kThreadsX * kTileH) {
    const int r = i / groups, g = i - r * groups;
    const short* row =
        src + (int64_t)(clampi(y0 - HY + r, rlo, rhi) - row0) * W;
    const int gx = x0 - kPadX + 4 * g;
    int4 v;
    if (gx >= 0 && gx + 3 < W) {
      const uint2 q = *reinterpret_cast<const uint2*>(row + gx);
      v = make_int4((short)(q.x & 0xffff), (int)q.x >> 16,
                    (short)(q.y & 0xffff), (int)q.y >> 16);
    } else {
      v = make_int4(row[clampi(gx, 0, W - 1)], row[clampi(gx + 1, 0, W - 1)],
                    row[clampi(gx + 2, 0, W - 1)],
                    row[clampi(gx + 3, 0, W - 1)]);
    }
    *reinterpret_cast<int4*>(tile + r * kPitch + 4 * g) = v;
  }
}

// w[0..11] = the 12 tile words from column 4 * threadIdx.x of a tile row:
// w[4 + k + dx] is the sample at offset dx from the thread's k-th sample.
__device__ __forceinline__ void ld12(const int* row, int (&w)[12]) {
  const int4* p = reinterpret_cast<const int4*>(row);
  const int4 a = p[0], b = p[1], c = p[2];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
}

// only w[4..7]: the thread's own four columns
__device__ __forceinline__ void ld4(const int* row, int (&w)[12]) {
  const int4 b = reinterpret_cast<const int4*>(row)[1];
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// Per-CTB edge word of ALF and CC-ALF: a set bit says that no tap may be
// taken from beyond that side of the CTB (AlfFilter._edges of the golden
// model: the picture's border, or a slice or tile boundary that filtering
// must not cross); the tap's coordinate is clamped to the CTB instead.
constexpr int kEdgeLeft = 1, kEdgeTop = 2, kEdgeRight = 4, kEdgeBottom = 8;

__device__ __forceinline__ void store4(short* dst, const int (&o)[kLane]) {
  uint2 v;
  v.x = (uint32_t)(o[0] & 0xffff) | ((uint32_t)o[1] << 16);
  v.y = (uint32_t)(o[2] & 0xffff) | ((uint32_t)o[3] << 16);
  *reinterpret_cast<uint2*>(dst) = v;
}

// ---------------------------------------------------------------------------
// SAO.  Replaces ffvvc_tpu/ops/sao_device.py::_sao_pallas (body _sao_math)
// as the fused chain runs it through fused_device._sao_apply.
//
// prm: int32 [11, ch, cw] per-CTB parameters, rows
//   0 typ, 1 m1 (band position or EO class), 2..6 offs[0..4],
//   7..10 the samples of the CTB's border that stay as they are, as ranges
//   lo | hi << 16 in the CTB's own coordinates: the rows [lo, hi) of its
//   first column (7) and of its last column (8), the columns [lo, hi) of
//   its first row (9) and of its last row (10).  "Last" is the last inside
//   the picture.  This covers the picture's border and the restore regions
//   at slice and tile boundaries that filtering must not cross
//   (sao_device._rasterize_plane of the JAX package), corners included.
// The TPU version expands these to nine [H, W] maps and an edge-padded
// int32 copy of the plane.  Here all planes of a picture go through one
// launch (a block finds its plane from its index); a block copies the
// parameters of the at most four CTBs its tile touches into shared memory,
// the threads on the border of a CTB that keeps anything test their samples
// against its four ranges, and the edge classes read their two neighbours
// (unclamped at a CTB's edge: SAO reads across and then keeps) from the
// shared tile.
// ---------------------------------------------------------------------------

constexpr int kSaoBand = 1;
constexpr int kSaoEdge = 2;
constexpr int kSaoRows = 11;
constexpr int kMaxCtbCols = 4;   // kTileW / 16: the narrowest CTB is 16

struct SaoPlane {
  const short* src;   // picture row row0
  short* dst;         // H rows from picture row row0
  const int* prm;
  int H, W, ch, cw, log2_cs_v, log2_cs_h;
  int row0, pic_h, rlo, rhi;
  // the first tile's picture row (row0 down to a multiple of kTileH),
  // tiles in all and across, and floor(2^32 / tiles_x) + 1: the launcher
  // fills them in so that no thread divides
  int ty0, tiles, tiles_x;
  unsigned inv_tiles_x;
};

struct SaoArgs {
  SaoPlane p[3];
  int n, shift, pix_max;
};

__global__ void __launch_bounds__(kThreadsX * kTileH)
sao_kernel(const SaoArgs a) {
  __shared__ __align__(16) int tile[(kTileH + 2) * kPitch];
  __shared__ int s_prm[kMaxCtbCols][kSaoRows];
  // which plane, which tile (static indices keep the planes in the
  // parameter space)
  SaoPlane P = a.p[0];
  int b = blockIdx.x;
#pragma unroll
  for (int z = 1; z < 3; ++z) {
    if (z >= a.n || b < P.tiles) break;
    b -= P.tiles;
    P = a.p[z];
  }
  // b / tiles_x by the reciprocal: exact while b * tiles_x < 2^32
  const int by = (int)__umulhi((unsigned)b, P.inv_tiles_x);
  const int x0 = (b - by * P.tiles_x) * kTileW, y0 = P.ty0 + by * kTileH;
  stage_tile<1>(P.src, P.row0, P.rlo, P.rhi, P.W, x0, y0, tile);
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int cx0 = x0 >> P.log2_cs_h, cy = y0 >> P.log2_cs_v;
  if (tid < kMaxCtbCols * kSaoRows) {
    const int j = tid / kSaoRows, r = tid - j * kSaoRows;
    if (cx0 + j < P.cw)
      s_prm[j][r] = P.prm[(r * P.ch + cy) * P.cw + cx0 + j];
  }
  __syncthreads();
  const int x = x0 + kLane * threadIdx.x, y = y0 + threadIdx.y;
  if (x >= P.W || y < P.row0 || y >= P.row0 + P.H) return;
  const int* prm = s_prm[(x >> P.log2_cs_h) - cx0];
  // the thread's samples are mid[kPadX + k]
  const int* mid = tile + (threadIdx.y + 1) * kPitch + kLane * threadIdx.x;
  const int4 c4 = *reinterpret_cast<const int4*>(mid + kPadX);
  const int cen[kLane] = {c4.x, c4.y, c4.z, c4.w};
  const int typ = prm[0], m1 = prm[1];
  int delta[kLane] = {0, 0, 0, 0};
  if (typ == kSaoBand) {
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int rel = ((cen[k] >> a.shift) - m1) & 31;
      if (rel < 4) delta[k] = prm[2 + rel];
    }
  } else if (typ == kSaoEdge) {
    // first neighbour of the EO class (0: horizontal, 1: vertical, 2: 135
    // degrees, 3: 45 degrees) as an offset in the tile; the second lies
    // opposite.  One code path for all classes: the CTBs a warp spans
    // differ in class.
    const int ax_ = m1 == 1 ? 0 : m1 == 3 ? 1 : -1;
    const int off = (m1 == 0 ? 0 : -kPitch) + ax_;
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int c = cen[k];
      delta[k] = prm[4 + clampi(c - mid[kPadX + k + off], -1, 1) +
                     clampi(c - mid[kPadX + k - off], -1, 1)];
    }
  }
  int out[kLane];
#pragma unroll
  for (int k = 0; k < kLane; ++k)
    out[k] = clampi(cen[k] + delta[k], 0, a.pix_max);
  // the keep ranges: only threads on the border of a CTB that has one
  const unsigned kc0 = prm[7], kc1 = prm[8], kr0 = prm[9], kr1 = prm[10];
  if ((kc0 | kc1 | kr0 | kr1) != 0) {
    const int x_loc = x & ((1 << P.log2_cs_h) - 1);
    const int y_loc = y & ((1 << P.log2_cs_v) - 1);
    // the CTB's size inside the picture
    const int w = min(1 << P.log2_cs_h, P.W - (x - x_loc));
    const int h = min(1 << P.log2_cs_v, P.pic_h - (y - y_loc));
    const bool first_row = y_loc == 0, last_row = y_loc == h - 1;
    if (x_loc == 0 || x_loc + kLane == w || first_row || last_row) {
      auto in = [](int v, unsigned r) {
        return v >= (int)(r & 0xffff) && v < (int)(r >> 16);
      };
#pragma unroll
      for (int k = 0; k < kLane; ++k) {
        const int xk = x_loc + k;
        if ((xk == 0 && in(y_loc, kc0)) || (xk == w - 1 && in(y_loc, kc1)) ||
            (first_row && in(xk, kr0)) || (last_row && in(xk, kr1)))
          out[k] = cen[k];
      }
    }
  }
  store4(P.dst + (int64_t)(y - P.row0) * P.W + x, out);
}

// ---------------------------------------------------------------------------
// ALF.  Replaces ffvvc_tpu/ops/alf_device.py::_alf_pallas (body _alf_math)
// in its fused form fused_device._alf_filter_plane.
//
// The 7x7 (luma) or 5x5 (chroma) clipped diamond: for each slot s, sum
// cf*(clip(v0-cur, +-cl) + clip(v1-cur, +-cl)) over the two opposite taps
// v0/v1 of the slot, round with >>7 (>>10 on the two rows at the virtual
// boundary), add to cur and clip.  The TPU kernel read 48 [H, W] planes
// (tap samples, coefficients, clips).  Here:
//  * taps come from the shared tile; the virtual-boundary row substitution
//    is computed from y: with d = (y mod CTB height) - vb_pos, every tap row
//    offset is clamped to +-reach, reach = 0 for d in {-1, 0}, 1 for
//    {-2, 1}, 2 for {-3, 2}, else 3 (alf_device._vb_row_offsets: a
//    substituted row is always a nearer one), so the halo of 3 (luma) or 2
//    (chroma) rows suffices and no row table is read;
//  * luma coefficients are looked up by index: per 4x4 block the class ci
//    and transpose ti from the classification, per CTB the filter set, and
//    the [sets, 25, 12] coefficient and clip tables.  The transpose is a
//    permutation of the 12 slots, packed 4 bits a slot.  While the tile is
//    staged, four threads per 4x4 block of the tile gather the block's 12
//    coefficients and 12 clips, already permuted, into shared memory; every
//    thread then reads those of its block with six 16-byte loads;
//  * chroma reads its coefficients from the [sets, 12] tables by the per-CTB
//    set index: a block copies those of the at most four CTBs its tile
//    touches into shared memory as the same records; both chroma planes go
//    through one launch (blockIdx.z).
// A thread's four samples share one 4x4 block row, so coefficients are
// fetched once for four samples.
//  * EDGES (the per-stage entry point, alf_device._AlfRasterizer of the JAX
//    package): a per-CTB edge word [ch, cw] says on which sides the CTB's
//    window is clamped to the CTB itself.  A thread clamps its own tap
//    coordinates by the word of its own CTB (a tile spans up to four): the
//    row offsets, after the virtual-boundary reach, to the rows the CTB has
//    left above and below, and the columns by overwriting the words left of
//    the CTB's first column or right of its last in the rows it has loaded.
//    A clamped coordinate lies nearer to the thread's sample, so inside the
//    tile that is staged anyway.
// ---------------------------------------------------------------------------

constexpr int kAlfClasses = 25;
constexpr int kAlfSlots = 12;
constexpr int kSetWords = kAlfClasses * kAlfSlots;
constexpr int kBlkCols = kTileW / 4;   // 4x4 blocks across a tile
constexpr int kBlkRows = kTileH / 4;
// words of a block's record in shared memory: 12 coefficients, 12 clips,
// padded so that the 16-byte reads of eight neighbouring threads fall into
// different banks
constexpr int kCoefPitch = 28;
constexpr int kChromaCtbCols = kTileW / 16;   // the narrowest chroma CTB

// alf._TRANSPOSE_IDX, slot s in bits [4s, 4s + 4)
constexpr unsigned long long kPerm0 = 0xBA9876543210ull;
constexpr unsigned long long kPerm1 = 0x62037B518A49ull;
constexpr unsigned long long kPerm2 = 0xBA9456781230ull;
constexpr unsigned long long kPerm3 = 0x62015B734A89ull;

struct AlfPlane {
  const short* src;   // picture row row0
  short* out;         // H rows from picture row row0
  const int* set;   // int32 [ch, cw] filter set of each CTB
  const int* cf;    // luma int32 [sets, 25, 12]; chroma int32 [sets, 12]
  const int* cl;
};

struct AlfArgs {
  AlfPlane p[2];
  // luma: int32 class and transpose index of each 4x4 block of the output
  // rows, [(row0 + H - 1) / 4 - row0 / 4 + 1, W / 4]
  const int* ci;
  const int* ti;
  int H, W, cw, log2_cs_v, log2_cs_h, vb_pos, pix_max;
  int row0, pic_h, rlo, rhi, ty0;
};

// one slot: taps wa[. + DA] and wb[. + DB] around the thread's samples
template <int DA, int DB>
__device__ __forceinline__ void alf_slot(int cf, int cl, const int (&wa)[12],
                                         const int (&wb)[12],
                                         const int (&cur)[12],
                                         int (&acc)[kLane]) {
#pragma unroll
  for (int k = 0; k < kLane; ++k) {
    const int c0 = cur[4 + k];
    acc[k] += cf * (clampi(wa[4 + k + DA] - c0, -cl, cl) +
                    clampi(wb[4 + k + DB] - c0, -cl, cl));
  }
}

// columns beyond a clamped side of the thread's CTB take the value at the
// CTB's first (w[4]) or last (w[7]) column
__device__ __forceinline__ void clamp_cols(int (&w)[12], bool left,
                                           bool right) {
  if (left) w[1] = w[2] = w[3] = w[4];
  if (right) w[8] = w[9] = w[10] = w[7];
}

// edges: int32 [ch, cw] edge word of each CTB, read with EDGES only.  It is
// a parameter of its own, and the tap rows below are spelt out apart for
// EDGES, so that the instantiations without EDGES compile to what a kernel
// that knows no edge words would (752 instructions for luma on sm_90a).
template <bool LUMA, bool EDGES>
__global__ void __launch_bounds__(kThreadsX * kTileH)
alf_kernel(const AlfArgs a, const int* __restrict__ edges) {
  constexpr int HY = LUMA ? 3 : 2;
  __shared__ __align__(16) int tile[(kTileH + 2 * HY) * kPitch];
  __shared__ __align__(16) int
      s_coef[LUMA ? kBlkRows * kBlkCols * kCoefPitch
                  : kChromaCtbCols * 2 * kAlfSlots];
  __shared__ int s_edge[EDGES ? kChromaCtbCols : 1];
  const AlfPlane P = blockIdx.z ? a.p[1] : a.p[0];
  const int x0 = blockIdx.x * kTileW, y0 = a.ty0 + blockIdx.y * kTileH;
  stage_tile<HY>(P.src, a.row0, a.rlo, a.rhi, a.W, x0, y0, tile);
  // the tile's rows lie in one CTB row: a CTB is at least 16 high
  const int cx0 = x0 >> a.log2_cs_h, cy = y0 >> a.log2_cs_v;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if constexpr (LUMA) {
    // thread -> (4x4 block of the tile, a quarter of its slots)
    const int b = tid >> 2, s0 = 3 * (tid & 3);
    const int bx = (x0 >> 2) + (b & (kBlkCols - 1));
    const int by = (y0 >> 2) + b / kBlkCols;
    if (bx < (a.W >> 2) && by >= (a.row0 >> 2) &&
        by <= ((a.row0 + a.H - 1) >> 2)) {
      const int blk = (by - (a.row0 >> 2)) * (a.W >> 2) + bx;
      const int t = a.ti[blk];
      const unsigned long long perm =
          t == 0 ? kPerm0 : t == 1 ? kPerm1 : t == 2 ? kPerm2 : kPerm3;
      const int base =
          P.set[cy * a.cw + ((bx << 2) >> a.log2_cs_h)] * kSetWords +
          a.ci[blk] * kAlfSlots;
      int* rec = s_coef + b * kCoefPitch;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int s = s0 + k;
        const int i = base + (int)((perm >> (4 * s)) & 15);
        rec[s] = __ldg(P.cf + i);
        rec[kAlfSlots + s] = __ldg(P.cl + i);
      }
    }
  } else if (tid < kChromaCtbCols * 2 * kAlfSlots) {
    // thread -> (CTB column of the tile, word of its record)
    const int j = tid / (2 * kAlfSlots), r = tid - j * (2 * kAlfSlots);
    if (cx0 + j < a.cw) {
      const int base = P.set[cy * a.cw + cx0 + j] * kAlfSlots;
      s_coef[tid] = r < kAlfSlots ? __ldg(P.cf + base + r)
                                  : __ldg(P.cl + base + r - kAlfSlots);
    }
  }
  if constexpr (EDGES) {
    if (tid >= 128 && tid < 128 + kChromaCtbCols) {
      const int j = tid - 128;
      s_edge[j] = cx0 + j < a.cw ? edges[cy * a.cw + cx0 + j] : 0;
    }
  }
  __syncthreads();
  const int x = x0 + kLane * threadIdx.x, y = y0 + threadIdx.y;
  if (x >= a.W || y < a.row0 || y >= a.row0 + a.H) return;

  // coefficients and clips of the thread's four samples
  int cf[kAlfSlots], cl[kAlfSlots];
  {
    const int4* rec = reinterpret_cast<const int4*>(
        s_coef +
        (LUMA ? ((threadIdx.y >> 2) * kBlkCols + threadIdx.x) * kCoefPitch
              : ((x >> a.log2_cs_h) - cx0) * 2 * kAlfSlots));
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int4 f = rec[j], l = rec[3 + j];
      cf[4 * j] = f.x; cf[4 * j + 1] = f.y;
      cf[4 * j + 2] = f.z; cf[4 * j + 3] = f.w;
      cl[4 * j] = l.x; cl[4 * j + 1] = l.y;
      cl[4 * j + 2] = l.z; cl[4 * j + 3] = l.w;
    }
  }

  // tap rows: offsets +-1, +-2, +-3 clamped to the reach the virtual
  // boundary leaves
  const int d = (y & ((1 << a.log2_cs_v) - 1)) - a.vb_pos;
  const int reach = (d == -1 || d == 0) ? 0
                    : (d == -2 || d == 1) ? 1
                    : (d == -3 || d == 2) ? 2 : 3;
  const int* mid = tile + (threadIdx.y + HY) * kPitch + kLane * threadIdx.x;
  // rows the taps may reach below (d*) and above (u*) the sample, and
  // whether the thread's columns end at a clamped side of its CTB
  int reach_d = reach, reach_u = reach;
  bool left = false, right = false;
  if constexpr (EDGES) {
    const int e = s_edge[(x >> a.log2_cs_h) - cx0];
    const int x_loc = x & ((1 << a.log2_cs_h) - 1);
    const int y_loc = y & ((1 << a.log2_cs_v) - 1);
    const int w = min(1 << a.log2_cs_h, a.W - (x - x_loc));
    const int h = min(1 << a.log2_cs_v, a.pic_h - (y - y_loc));
    if (e & kEdgeTop) reach_u = min(reach, y_loc);
    if (e & kEdgeBottom) reach_d = min(reach, h - 1 - y_loc);
    left = (e & kEdgeLeft) && x_loc == 0;
    right = (e & kEdgeRight) && x_loc + kLane == w;
  }
  int d1, d2, d3, u1, u2, u3;
  if constexpr (EDGES) {
    d1 = min(1, reach_d) * kPitch; d2 = min(2, reach_d) * kPitch;
    d3 = min(3, reach_d) * kPitch;
    u1 = min(1, reach_u) * kPitch; u2 = min(2, reach_u) * kPitch;
    u3 = min(3, reach_u) * kPitch;
  } else {
    d1 = u1 = min(1, reach) * kPitch;
    d2 = u2 = min(2, reach) * kPitch;
    d3 = u3 = min(3, reach) * kPitch;
  }
  int cur[12], wa[12], wb[12];
  int acc[kLane] = {0, 0, 0, 0};
  ld12(mid, cur);
  if constexpr (EDGES) clamp_cols(cur, left, right);
  if constexpr (LUMA) {
    ld4(mid + d3, wa);
    ld4(mid - u3, wb);
    alf_slot<0, 0>(cf[0], cl[0], wa, wb, cur, acc);
  }
  ld12(mid + d2, wa);
  ld12(mid - u2, wb);
  if constexpr (EDGES) {
    clamp_cols(wa, left, right);
    clamp_cols(wb, left, right);
  }
  if constexpr (LUMA) {
    alf_slot<1, -1>(cf[1], cl[1], wa, wb, cur, acc);
    alf_slot<-1, 1>(cf[3], cl[3], wa, wb, cur, acc);
  }
  alf_slot<0, 0>(cf[2], cl[2], wa, wb, cur, acc);
  ld12(mid + d1, wa);
  ld12(mid - u1, wb);
  if constexpr (EDGES) {
    clamp_cols(wa, left, right);
    clamp_cols(wb, left, right);
  }
  if constexpr (LUMA) {
    alf_slot<2, -2>(cf[4], cl[4], wa, wb, cur, acc);
    alf_slot<-2, 2>(cf[8], cl[8], wa, wb, cur, acc);
  }
  alf_slot<1, -1>(cf[5], cl[5], wa, wb, cur, acc);
  alf_slot<0, 0>(cf[6], cl[6], wa, wb, cur, acc);
  alf_slot<-1, 1>(cf[7], cl[7], wa, wb, cur, acc);
  if constexpr (LUMA) alf_slot<3, -3>(cf[9], cl[9], cur, cur, cur, acc);
  alf_slot<2, -2>(cf[10], cl[10], cur, cur, cur, acc);
  alf_slot<1, -1>(cf[11], cl[11], cur, cur, cur, acc);

  int out[kLane];
#pragma unroll
  for (int k = 0; k < kLane; ++k) {
    const int r = reach == 0 ? (acc[k] + (1 << 9)) >> 10 : (acc[k] + 64) >> 7;
    out[k] = clampi(cur[4 + k] + r, 0, a.pix_max);
  }
  store4(P.out + (int64_t)(y - a.row0) * a.W + x, out);
}

// ---------------------------------------------------------------------------
// CC-ALF.  Replaces ffvvc_tpu/ops/alf_device.py::_cc_pallas (body _cc_math),
// in its fused form fused_device._cc_filter and, with EDGES, over the planes
// alf_device._AlfRasterizer._raster_cc builds.
//
// A 7-tap luma-to-chroma correction sum cf_j * (v_j - cur_luma) over the
// pre-ALF luma around luma column x << hs and row y << vs, rounded with
// (acc + 64) >> 7, clipped to [-half, half - 1], added to chroma and clipped.
// The TPU kernel read seven gathered tap planes and seven coefficient planes
// per chroma plane.  Here:
//  * Cb and Cr go through one launch, and one thread owns the same four
//    positions in both: the seven differences depend on the luma alone, so
//    they are computed once and multiplied into two coefficient sets;
//  * a thread owns four neighbouring chroma samples of a 64x16 tile and
//    reads the luma under them straight from device memory: of each of its
//    four luma rows the 4 << hs columns in one 16-byte (hs = 1) or 8-byte
//    load, of the two middle rows also the column before and, for hs = 0,
//    the column after; rows and these two columns clamp at the picture
//    edge.  Each luma row serves two chroma rows of the tile, the second
//    time from the L1.  (A luma tile staged in shared memory, as SAO and
//    ALF stage theirs, took 5.6 us for both 540x960 planes on an H100
//    against 3.3 us: a thread reads each luma sample at most twice, too few
//    times to pay for the staging and the barrier.)  The chroma comes with
//    one 8-byte load a plane and goes with one 8-byte store a plane;
//  * the tap rows come from the row number: with pos = (y mod CTB height)
//    << vs and d = pos - (CTB size - 4), rows r0..r3 = pos - 1, pos, pos + 1,
//    pos + 2; for d in {-2, 1} r3 = r2; for d in {-1, 0} all four are pos;
//    in 4:4:4 and 4:2:2 (vs = 0) the rows d in {0, 1} get no correction
//    (alf.py _filter_cc).  No row table is read;
//  * coefficients are taken by index: the per-CTB set of each plane
//    ([ch, cw]) into its [sets, 7] table; a block copies those of the at most
//    four CTBs its tile touches into shared memory;
//  * EDGES: rows and columns are clamped to the thread's luma CTB on the
//    sides its edge word names, after the row substitution.
// ---------------------------------------------------------------------------

constexpr int kCcTaps = 7;

struct CcArgs {
  const short* luma;       // pre-ALF luma, at picture row lrow0
  const short* dst[2];     // [Hc, Wc] chroma rows from picture row row0
  short* out[2];
  const int* set[2];       // int32 [ch, cw] coefficient set of each CTB
  const int* cf[2];        // int32 [sets, 7]
  const int* edges;        // EDGES: int32 [ch, cw] edge word of each CTB
  // H: the picture's luma rows; Hc: chroma output rows; the luma buffer
  // holds the picture's luma rows [lrlo, lrhi]
  int n, H, W, Hc, Wc, cw, log2_cs_v, log2_cs_h, half, pix_max;
  int row0, ty0, lrow0, lrlo, lrhi;
};

// w[4 + i] = row[lx + i] for the 4 << HS luma columns under a thread's four
// chroma samples, one 16-byte (HS = 1) or 8-byte (HS = 0) load; with SIDES
// also the column before (w[3]) and, for HS = 0, the column after (w[8]),
// clamped to the picture
template <int HS, bool SIDES>
__device__ __forceinline__ void cc_load_row(const short* __restrict__ row,
                                            int lx, int W, int (&w)[12]) {
  if constexpr (HS == 1) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + lx));
    w[4] = (short)(q.x & 0xffff); w[5] = (int)q.x >> 16;
    w[6] = (short)(q.y & 0xffff); w[7] = (int)q.y >> 16;
    w[8] = (short)(q.z & 0xffff); w[9] = (int)q.z >> 16;
    w[10] = (short)(q.w & 0xffff); w[11] = (int)q.w >> 16;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + lx));
    w[4] = (short)(q.x & 0xffff); w[5] = (int)q.x >> 16;
    w[6] = (short)(q.y & 0xffff); w[7] = (int)q.y >> 16;
    if constexpr (SIDES) w[8] = __ldg(row + min(lx + 4, W - 1));
  }
  if constexpr (SIDES) w[3] = __ldg(row + max(lx - 1, 0));
}

template <int HS, int VS, bool EDGES>
__global__ void __launch_bounds__(kThreadsX * kTileH)
cc_kernel(const CcArgs a) {
  const int x0 = blockIdx.x * kTileW;                    // chroma
  const int y0 = a.ty0 + blockIdx.y * kTileH;
  __shared__ int s_cf[2][kMaxCtbCols][kCcTaps + 1];
  __shared__ int s_edge[kMaxCtbCols];
  // the tile's rows lie in one CTB row: a chroma CTB is at least 16 high
  const int cx0 = x0 >> a.log2_cs_h, cy = y0 >> a.log2_cs_v;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if (tid < 2 * kMaxCtbCols * kCcTaps) {
    // thread -> (plane, CTB column of the tile, coefficient)
    const int p = tid / (kMaxCtbCols * kCcTaps);
    const int q = tid - p * (kMaxCtbCols * kCcTaps);
    const int j = q / kCcTaps, r = q - j * kCcTaps;
    if (p < a.n && cx0 + j < a.cw) {
      const int* set = p ? a.set[1] : a.set[0];
      const int* cf = p ? a.cf[1] : a.cf[0];
      s_cf[p][j][r] = __ldg(cf + set[cy * a.cw + cx0 + j] * kCcTaps + r);
    }
  }
  if constexpr (EDGES) {
    if (tid >= 128 && tid < 128 + kMaxCtbCols) {
      const int j = tid - 128;
      s_edge[j] = cx0 + j < a.cw ? a.edges[cy * a.cw + cx0 + j] : 0;
    }
  }
  __syncthreads();
  const int x = x0 + kLane * threadIdx.x, y = y0 + threadIdx.y;
  if (x >= a.Wc || y < a.row0 || y >= a.row0 + a.Hc) return;
  const int j = (x >> a.log2_cs_h) - cx0;
  const int y_loc = y & ((1 << a.log2_cs_v) - 1);
  const int pos = y_loc << VS;             // row within the luma CTB
  const int d = pos - (((1 << a.log2_cs_v) << VS) - 4);
  const bool flat = d == -1 || d == 0;
  const bool skip = VS == 0 && (d == 0 || d == 1);
  // rows above (up) and below (dn1, dn2) the luma row that the taps read
  int up = flat ? 0 : 1, dn1 = up;
  int dn2 = flat ? 0 : (d == -2 || d == 1) ? 1 : 2;
  bool left = false, right = false;
  if constexpr (EDGES) {
    const int e = s_edge[j];
    const int x_loc = x & ((1 << a.log2_cs_h) - 1);
    const int w = min(1 << a.log2_cs_h, a.Wc - (x - x_loc));
    // luma rows of the CTB inside the picture
    const int h = min((1 << a.log2_cs_v) << VS, a.H - ((y - y_loc) << VS));
    if (e & kEdgeTop) up = min(up, pos);
    if (e & kEdgeBottom) {
      dn1 = min(dn1, h - 1 - pos);
      dn2 = min(dn2, h - 1 - pos);
    }
    left = (e & kEdgeLeft) && x_loc == 0;
    // with hs = 1 the last tap column 2x + 1 is the CTB's last luma column
    right = HS == 0 && (e & kEdgeRight) && x_loc + kLane == w;
  }
  // w1[4 + (k << HS) + dx]: luma at offset dx from the thread's k-th sample
  int w0[12], w1[12], w2[12], w3[12];
  {
    const int lx = x << HS, ly = y << VS;
    auto row = [&](int r) {
      return a.luma + (int64_t)(clampi(r, a.lrlo, a.lrhi) - a.lrow0) * a.W;
    };
    cc_load_row<HS, false>(row(ly - up), lx, a.W, w0);
    cc_load_row<HS, true>(row(ly), lx, a.W, w1);
    cc_load_row<HS, true>(row(ly + dn1), lx, a.W, w2);
    cc_load_row<HS, false>(row(ly + dn2), lx, a.W, w3);
  }
  if constexpr (EDGES) {
    if (left) w1[3] = w1[4], w2[3] = w2[4];
    if (right) w1[8] = w1[7], w2[8] = w2[7];
  }
  int t[kLane][kCcTaps];
#pragma unroll
  for (int k = 0; k < kLane; ++k) {
    const int c = 4 + (k << HS), cur = w1[c];
    t[k][0] = w0[c] - cur;
    t[k][1] = w1[c - 1] - cur;
    t[k][2] = w1[c + 1] - cur;
    t[k][3] = w2[c - 1] - cur;
    t[k][4] = w2[c] - cur;
    t[k][5] = w2[c + 1] - cur;
    t[k][6] = w3[c] - cur;
  }
  const int64_t at = (int64_t)(y - a.row0) * a.Wc + x;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= a.n) break;
    const int* cf = s_cf[p][j];
    const uint2 q = *reinterpret_cast<const uint2*>(
        (p ? a.dst[1] : a.dst[0]) + at);
    const int chroma[kLane] = {(short)(q.x & 0xffff), (int)q.x >> 16,
                               (short)(q.y & 0xffff), (int)q.y >> 16};
    int out[kLane];
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      int acc = 0;
      if (!skip) {
#pragma unroll
        for (int i = 0; i < kCcTaps; ++i) acc += cf[i] * t[k][i];
      }
      acc = clampi((acc + 64) >> 7, -a.half, a.half - 1);
      out[k] = clampi(chroma[k] + acc, 0, a.pix_max);
    }
    store4((p ? a.out[1] : a.out[0]) + at, out);
  }
}

template <int HS, int VS>
int launch_cc(const CcArgs& a, cudaStream_t stream) {
  const dim3 grid(cdiv(a.Wc, kTileW), cdiv(a.row0 + a.Hc - a.ty0, kTileH));
  const dim3 block(kThreadsX, kTileH);
  if (a.edges)
    cc_kernel<HS, VS, true><<<grid, block, 0, stream>>>(a);
  else
    cc_kernel<HS, VS, false><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The rows of a plane, picture coordinates (see the note at the top):
// rows[0..3] = row0, H (output rows), pic_h, and the buffer's first
// picture row rlo; the buffer's last, rhi, follows from rows[4], the number
// of rows the buffer holds.  Returns false for rows that do not fit.
static bool slab_rows(const int* rows, int* row0, int* H, int* pic_h,
                      int* rlo, int* rhi) {
  *row0 = rows[0];
  *H = rows[1];
  *pic_h = rows[2];
  *rlo = max(rows[3], 0);
  *rhi = min(rows[3] + rows[4], *pic_h) - 1;
  return *H > 0 && *row0 >= *rlo && *row0 + *H - 1 <= *rhi;
}

// ptrs: [3n] (src at picture row row0, dst, prm [11, ch, cw]) of each
// plane; dims: [5n] (W, ch, cw, log2_cs_v, log2_cs_h) and rows: [5n] (see
// slab_rows) of each plane; all host arrays.
int ffvvc_sao(int n, const void* const* ptrs, const int* dims,
              const int* rows, int shift, int pix_max, void* stream) {
  SaoArgs a;
  a.n = n;
  a.shift = shift;
  a.pix_max = pix_max;
  int blocks = 0;
  for (int z = 0; z < n; ++z) {
    SaoPlane& p = a.p[z];
    p.src = (const short*)ptrs[3 * z];
    p.dst = (short*)ptrs[3 * z + 1];
    p.prm = (const int*)ptrs[3 * z + 2];
    p.W = dims[5 * z];
    p.ch = dims[5 * z + 1];
    p.cw = dims[5 * z + 2];
    p.log2_cs_v = dims[5 * z + 3];
    p.log2_cs_h = dims[5 * z + 4];
    if (!slab_rows(rows + 5 * z, &p.row0, &p.H, &p.pic_h, &p.rlo, &p.rhi))
      return (int)cudaErrorInvalidValue;
    p.ty0 = p.row0 & ~(kTileH - 1);
    p.tiles_x = cdiv(p.W, kTileW);
    p.tiles = p.tiles_x * cdiv(p.row0 + p.H - p.ty0, kTileH);
    if (p.W <= 0 || (int64_t)p.tiles * p.tiles_x >= (1ll << 32))
      return (int)cudaErrorInvalidValue;
    p.inv_tiles_x = (unsigned)((1ull << 32) / (unsigned)p.tiles_x) + 1u;
    blocks += p.tiles;
  }
  for (int z = n; z < 3; ++z) a.p[z] = a.p[0];
  sao_kernel<<<blocks, dim3(kThreadsX, kTileH), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

static bool alf_rows(AlfArgs& a, const int* rows) {
  if (!slab_rows(rows, &a.row0, &a.H, &a.pic_h, &a.rlo, &a.rhi)) return false;
  a.ty0 = a.row0 & ~(kTileH - 1);
  return true;
}

// src at picture row row0; rows: 5 ints (see slab_rows); edges: the
// per-CTB edge words, or null for a picture without clamped CTBs
int ffvvc_alf_luma(const void* src, void* out, const int* rows, int W,
                   const void* ci, const void* ti, const void* ctb_set,
                   int cw, const void* cf, const void* cl, const void* edges,
                   int log2_cs, int pix_max, void* stream) {
  AlfArgs a;
  a.p[0] = AlfPlane{(const short*)src, (short*)out, (const int*)ctb_set,
                    (const int*)cf, (const int*)cl};
  a.p[1] = a.p[0];
  a.ci = (const int*)ci;
  a.ti = (const int*)ti;
  if (!alf_rows(a, rows)) return (int)cudaErrorInvalidValue;
  a.W = W;
  a.cw = cw;
  a.log2_cs_v = a.log2_cs_h = log2_cs;
  a.vb_pos = (1 << log2_cs) - 4;   // alf.ALF_VB_POS_ABOVE_LUMA
  a.pix_max = pix_max;
  const dim3 grid(cdiv(W, kTileW), cdiv(a.row0 + a.H - a.ty0, kTileH), 1);
  const dim3 block(kThreadsX, kTileH);
  if (edges)
    alf_kernel<true, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        a, (const int*)edges);
  else
    alf_kernel<true, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        a, (const int*)edges);
  return (int)cudaGetLastError();
}

// ptrs: [5n] (src at picture row row0, out, set, cf, cl) of each chroma
// plane, a host array; rows: 5 ints for both planes (see slab_rows).
int ffvvc_alf_chroma(int n, const void* const* ptrs, const void* edges,
                     const int* rows, int W, int cw, int log2_cs_v,
                     int log2_cs_h, int pix_max, void* stream) {
  AlfArgs a;
  for (int z = 0; z < 2; ++z) {
    const void* const* q = ptrs + 5 * (z < n ? z : 0);
    a.p[z] = AlfPlane{(const short*)q[0], (short*)q[1], (const int*)q[2],
                      (const int*)q[3], (const int*)q[4]};
  }
  a.ci = a.ti = nullptr;
  if (!alf_rows(a, rows)) return (int)cudaErrorInvalidValue;
  a.W = W;
  a.cw = cw;
  a.log2_cs_v = log2_cs_v;
  a.log2_cs_h = log2_cs_h;
  a.vb_pos = (1 << log2_cs_v) - 2;   // alf.ALF_VB_POS_ABOVE_CHROMA
  a.pix_max = pix_max;
  const dim3 grid(cdiv(W, kTileW), cdiv(a.row0 + a.H - a.ty0, kTileH), n);
  const dim3 block(kThreadsX, kTileH);
  if (edges)
    alf_kernel<false, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        a, (const int*)edges);
  else
    alf_kernel<false, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        a, (const int*)edges);
  return (int)cudaGetLastError();
}

// ptrs: [4n] (dst at chroma picture row row0, out, set, cf) of each chroma
// plane, a host array; rows: 5 ints of the chroma rows (see slab_rows:
// rlo and the buffer's rows are not read), lrows: 5 of the luma rows under
// them (row0 << vs, Hc << vs) and of the luma buffer; luma at row row0 << vs;
// W, Wc the luma and chroma widths; CTBs of (1 << log2_cs_v) x
// (1 << log2_cs_h) chroma samples; (hs, vs) is (1, 1), (1, 0) or (0, 0).
int ffvvc_cc(int n, const void* const* ptrs, const void* luma,
             const void* edges, const int* rows, const int* lrows, int W,
             int Wc, int cw, int log2_cs_v, int log2_cs_h, int hs, int vs,
             int half, int pix_max, void* stream) {
  CcArgs a;
  for (int z = 0; z < 2; ++z) {
    const void* const* q = ptrs + 4 * (z < n ? z : 0);
    a.dst[z] = (const short*)q[0];
    a.out[z] = (short*)q[1];
    a.set[z] = (const int*)q[2];
    a.cf[z] = (const int*)q[3];
  }
  a.luma = (const short*)luma;
  a.edges = (const int*)edges;
  a.n = n;
  a.row0 = rows[0];
  a.Hc = rows[1];
  a.ty0 = a.row0 & ~(kTileH - 1);
  int luma_h;
  if (a.Hc <= 0 ||
      !slab_rows(lrows, &a.lrow0, &luma_h, &a.H, &a.lrlo, &a.lrhi) ||
      a.lrow0 != a.row0 << vs || luma_h != a.Hc << vs)
    return (int)cudaErrorInvalidValue;
  a.W = W;
  a.Wc = Wc;
  a.cw = cw;
  a.log2_cs_v = log2_cs_v;
  a.log2_cs_h = log2_cs_h;
  a.half = half;
  a.pix_max = pix_max;
  if (hs == 1 && vs == 1) return launch_cc<1, 1>(a, (cudaStream_t)stream);
  if (hs == 1 && vs == 0) return launch_cc<1, 0>(a, (cudaStream_t)stream);
  if (hs == 0 && vs == 0) return launch_cc<0, 0>(a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
