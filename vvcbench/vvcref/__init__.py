"""vvcref: the benchmark's frozen reference decoder and stream forge.

A frozen copy of the golden model of `ffvvc_tpu_torch` (the NumPy half of
the port's host side, itself verified bit-exact against FFmpeg's VVC
decoder when it was written), taken at commit e2f5d5b, with every native
library cut out: NumPy and the standard library only.  It imports nothing
of `ffvvc_tpu_torch`, `ffvvc_tpu` or JAX and loads no shared object, so a
later change to the port cannot move the yardstick.  Each file's header
names its original and lists what changed.

    from vvcref.decoder import VVCDecoder
    frames = VVCDecoder().decode(annexb_bytes)     # output order
"""
