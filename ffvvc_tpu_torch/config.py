"""Decoder configuration of the port.

The fields of `ffvvc_tpu/config.py`'s DecoderConfig (reference analogue:
AVOptions on AVCodecContext, thread_count and the LOW_DELAY flag,
libavcodec/vvc/vvcdec.c:932-954) plus the torch device and the devices of
the mesh.
"""
from __future__ import annotations

import dataclasses

from .ops import resolve_device, resolve_mesh_devices

@dataclasses.dataclass
class DecoderConfig:
    # Number of frames decoded in flight (reference: VVC_MAX_DELAYED_FRAMES=16,
    # vvcdec.c:932; LOW_DELAY forces 1).
    max_delayed_frames: int = 16
    low_delay: bool = False

    # Host-side parse workers (CABAC entry points are batched across
    # tiles/WPP-rows/frames on host cores).
    parse_workers: int = 0  # 0 = auto

    # "cuda" runs the device half in PyTorch (the fused chain when
    # device_pipeline is set); "golden" runs the Python golden model on
    # the host: it switches native_cabac, native_parse and native_alf off.
    # "tpu", the JAX package's device half, is refused.
    backend: str = "cuda"
    # torch device of the fused filter chain, the per-stage device
    # filters, device MC and the batched inverse transform: "cuda" (raises
    # when CUDA is unavailable) or "cpu" (the kernels' plain PyTorch
    # versions; tests).
    device: str = "cuda"

    # Mesh for multi-device decode: (gop, tile) axes. (1, 1) = single chip.
    mesh_shape: tuple = (1, 1)
    # Devices of the mesh, gop-major; None: the visible cards cuda:0.. for a
    # CUDA `device`, `device` repeated otherwise.  A list may repeat one.
    mesh_devices: tuple | None = None

    # Single-device batched pixel pipeline: run the deferred filter chain
    # (residual-add / LMCS / deblock / SAO / ALF / CC-ALF) through the
    # mesh queue on ONE device — frames batch at drains (RPL-aware on
    # inter content), so the whole chain runs as a handful of batched
    # launches per drain instead of per-stage per-frame round trips.
    device_pipeline: bool = False

    # Emit per-stage timing.
    profile: bool = False

    # Output: if True, frames are returned in display (POC/bumping) order as
    # the reference does; if False, decode order.
    reorder_output: bool = True

    # Error latch (reference vvc_thread.c:605-617 / vvcdec.c:795-798): when
    # True, a frame that fails to parse or reconstruct is dropped and decode
    # continues at the next access unit instead of raising.
    error_resilient: bool = False

    # Native C CABAC engine + residual fast path (falls back to the Python
    # golden engine when the library can't be built/loaded).
    native_cabac: bool = True

    # Native C coding-tree parse core (whole-CTU syntax parse in one call;
    # native/vvc_parse.c). Falls back to the Python golden parse per slice
    # when the stream uses a tool the C core doesn't cover.
    native_parse: bool = True

    # Native C whole-frame ALF/CC-ALF pass (native/vvc_alf.c); falls back
    # to the Python golden pass when a referenced APS is unavailable.
    native_alf: bool = True

    # Run whole-frame SAO on `device` (per-CTB tables, all planes through
    # one launch of the CUDA kernel) instead of the host per-CTB path, also
    # on pictures with restore regions at slice and tile boundaries.  Off
    # by default: each per-stage filter uploads its planes and downloads
    # them again; device_pipeline keeps them on the device.
    device_sao: bool = False

    # Run whole-frame ALF/CC-ALF on `device` (per-CTB sets and edge words;
    # classification, one luma launch, one launch for both chroma planes,
    # one for both CC-ALF planes).  Same caveat as device_sao.
    device_alf: bool = False
    # Device deblocking (ops/deblock_device.py): batched segment math, one
    # pass per direction.  LADF streams fall back to the host filter.
    device_deblock: bool = False
    # Device LMCS inverse mapping (ops/lmcs_device.py): whole-plane LUT
    # gather gated per CTB by the slice's sh_lmcs_used_flag.
    device_lmcs: bool = False
    # Device inter MC (ops/mc_device.py): EVERY block shape batches on
    # device — regular blocks, GPM blends, affine (+PROF) and SbTMVP
    # subblock grids, and DMVR/BDOF (batched bilinear prefetch + 25-point
    # SAD refine, box-clamped puts, per-4x4 BDOF solve, TMVP col-grid
    # writeback) — with uni/bi/weighted finals incl. explicit weighted
    # prediction, BCW, LMCS forward mapping and horizontal wraparound.
    device_mc: bool = False
    # Device intra prediction (ops/intra_device.py): wavefront-batched
    # planar/DC/angular/MIP/CCLM prediction + residual add on `device` for
    # all-intra frames; inter frames, and frames the native planner
    # declines, use the native C walk.  The planes go up and come down
    # once a frame.
    device_intra: bool = False

    # Verify decoded pictures against decoded-picture-hash suffix SEI
    # (payload type 132, MD5) when present: a free end-to-end self-check
    # on streams that carry it.  Raises ValueError on mismatch.  Off by
    # default (costs an MD5 per frame; the reference decoder does not
    # verify it either).
    verify_picture_hash: bool = False

    # Intra-frame stage threads over GIL-releasing native calls (inter MC
    # CTUs; deblock row/column shards). 0 = auto (cpu count). GOP-parallel
    # worker processes force 1 to avoid oversubscription (pipeline.py).
    stage_threads: int = 0
    # Frame pipeline: overlap frame N's pixel stages (recon/LMCS/deblock/
    # SAO/ALF) with frame N+1's CABAC parse + MV derivation on a worker
    # thread — the TPU-host analogue of the reference's frame pipeline with
    # row-progress gating (vvc_thread.c:281-296, vvcdec.c:830-841).  The
    # inter MC of frame N+1 still waits for frame N's filtered pixels.
    # Disabled automatically under error_resilient (exception attribution).
    pipeline_frames: bool = True
    # Row-granular cross-frame progress (the host analogue of the
    # reference's row-progress listeners, vvc_thread.c:281-296): eligible
    # frames run their pixel stages as a rolling per-CTB-row pipeline
    # publishing filter-final rows, and a consumer frame's inter MC waits
    # per CTU row on just the reference rows it needs instead of the
    # whole reference frame.  Requires the native recon/deblock/SAO/ALF
    # row drivers; ineligible frames fall back to whole-frame passes.
    row_progress: bool = True
    # Frame-pipeline depth: how many frames' pixel stages may be queued
    # behind the parse before it blocks (the analogue of the reference's
    # deep frame contexts, vvcdec.c:830-841 / vvc_thread.c frame pipeline).
    # Inter frames still drain the whole queue before MC (reference
    # barrier); depth > 1 only runs ahead across consecutive intra frames.
    # Bounds per-frame memory (tabs + planes per in-flight frame); on the
    # 2-vCPU bench host depth > 1 is wall-clock neutral (GOP workers
    # already saturate the cores) — the headroom is for many-core hosts.
    pipeline_depth: int = 2

    def __post_init__(self):
        if self.backend == "tpu":
            raise ValueError("backend='tpu' runs the JAX device half; the "
                             "port's backend is 'cuda'")
        if self.backend not in ("cuda", "golden"):
            raise ValueError(f"unknown backend {self.backend!r} (cuda or "
                             "golden)")
        if self.backend == "golden":
            self.native_cabac = self.native_parse = self.native_alf = False
        resolve_device(self.device)
        if self.mesh_devices is not None:
            resolve_mesh_devices(self.mesh_devices, self.device)
