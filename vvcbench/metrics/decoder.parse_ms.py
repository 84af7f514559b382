"""decoder.parse_ms: host parse (`VVCDecoder._parse_slice`: the native C
coding-tree parse and the slice set-up around it), busy ms of the
benchmark's span a frame output."""


def read(run):
    if not run.frames or not run.spans.count("decoder.parse"):
        return None
    return 1e3 * run.spans.busy_s("decoder.parse") / run.frames
