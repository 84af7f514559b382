"""parse.tile_parallelism: how far the tiles of a slice parse at once: the
summed wall time of the port's `parse.tile` spans (one a tile entry
point's native parse, on the thread that parses it) over that of its
`parse.slice` spans (each slice's whole parse on the decoding thread), in
x.  Above 1 where the tiles' parses overlap on `parse_workers` threads.
Absent where the port has no `parse.tile` spans."""
from harness import port_spans


def read(run):
    spans = port_spans.window(run)
    if spans is None or not any(s.name == "parse.tile" for s in spans):
        return None
    slices = port_spans.wall_ms(spans, ("parse.slice",))
    if slices <= 0:
        return None
    return port_spans.wall_ms(spans, ("parse.tile",)) / slices
