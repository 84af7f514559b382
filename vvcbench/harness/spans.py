"""Spans recorded from the benchmark's own files, around the port's layers.

`install` wraps the attributes of `ffvvc_tpu_torch` that the decoder looks
up at call time (its function-level imports of `ops.*` and the methods of
its classes), so the port is not edited.  Each span is kept in memory as
(name, thread id, start, end) on `time.perf_counter`, and, while the
profiler runs, is also a `torch.profiler.record_function` range, which
puts it on the device trace's clock.  Only the traced run installs them.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

# span name -> (module of the port, attribute path)
LAYERS = {
    "decoder.parse": ("ffvvc_tpu_torch.decoder", "VVCDecoder._parse_slice"),
    "decoder.itx": ("ffvvc_tpu_torch.ops.itx", "frame_device_residuals"),
    "decoder.recon": ("ffvvc_tpu_torch.native.recon",
                      "NativeRecon.reconstruct_ctus"),
    "decoder.recon_residuals": ("ffvvc_tpu_torch.native.recon",
                                "NativeRecon.residual_ctus"),
    "mc": ("ffvvc_tpu_torch.ops.mc_device", "frame_device_mc"),
    "fused": ("ffvvc_tpu_torch.ops.fused_device", "fused_frame_filters"),
    "fused.deblock_raster": ("ffvvc_tpu_torch.ops.fused_device",
                             "rasterize_deblock"),
    "fused.sao_tables": ("ffvvc_tpu_torch.ops.fused_device", "ctb_tables"),
    "fused.alf_params": ("ffvvc_tpu_torch.ops.fused_device",
                         "_alf_ctb_params"),
    "fused.to_device": ("ffvvc_tpu_torch.ops.fused_device", "to_device"),
    "fused.chain": ("ffvvc_tpu_torch.ops.fused_device", "chain"),
}
SEGMENT = "segment"


class Recorder:
    def __init__(self):
        self.spans = []            # (name, thread id, start, end)
        self.profiling = False
        self._undo = []

    @contextlib.contextmanager
    def span(self, name):
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function("vvcbench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append((name, threading.get_ident(), t0, t1))

    def busy_s(self, name):
        return sum(t1 - t0 for n, _, t0, t1 in self.spans if n == name)

    def count(self, name):
        return sum(1 for n, *_ in self.spans if n == name)

    def install(self):
        import importlib
        for name, (mod_name, path) in LAYERS.items():
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)

            @functools.wraps(fn)
            def wrapped(*a, _fn=fn, _name=name, **k):
                with self.span(_name):
                    return _fn(*a, **k)
            setattr(owner, attr, wrapped)
            self._undo.append((owner, attr, fn))

    def uninstall(self):
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)
