"""The benchmark's harness: cells by name, the segment forge, the frozen
reference, the timed window, spans, the device trace and the roofline
arithmetic.  It drives `ffvvc_tpu_torch` and imports neither JAX nor the
JAX package."""
