"""decoder.recon_ms: host recon (`native/recon.py`: `reconstruct_ctus`,
and `residual_ctus` where an inter frame defers its residual add to the
device), busy ms of the benchmark's spans a frame output."""

SPANS = ("decoder.recon", "decoder.recon_residuals")


def read(run):
    if not run.frames or not any(run.spans.count(s) for s in SPANS):
        return None
    return 1e3 * sum(run.spans.busy_s(s) for s in SPANS) / run.frames
