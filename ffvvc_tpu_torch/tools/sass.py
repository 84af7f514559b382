"""What the compiler made of the port's CUDA kernels: an opcode histogram.

    python -m ffvvc_tpu_torch.tools.sass [--top N]

Compiles csrc/filters.cu to a cubin with the code-generation flags of
`ops/_build.py`, disassembles it with the toolkit's cuobjdump and prints,
for each kernel, how many machine instructions it has and how many of each
opcode (static counts: an instruction inside a loop counts once).  Needs
nvcc and cuobjdump, no GPU.  It shows, for instance, whether a subtract and
a max were fused into one VIADDMNMX, and how much of a kernel is address
arithmetic rather than the filter's own operations.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import tempfile

from ..ops import _build

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")
_KERNEL = re.compile(r"\d+([a-z_]+_kernel)(?:I((?:L[bi]\d+E)+)E)?")
_TEMPLATE_ARG = re.compile(r"L[bi](\d+)E")


def kernel_name(mangled):
    """`alf_kernel<1,0>` from the mangled symbol (its bool and int template
    arguments); the symbol when it has no such part."""
    m = _KERNEL.search(mangled)
    if m is None:
        return mangled
    args = _TEMPLATE_ARG.findall(m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def opcode(mnemonic):
    """The opcode a mnemonic is counted under: its first part, and the
    second as well for IMAD, whose variants (IMAD.IADD, IMAD.MOV, ...) are
    adds and moves that run on the multiply-add pipe."""
    parts = mnemonic.split(".")
    if parts[0] == "IMAD" and len(parts) > 1 and not parts[1].isdigit():
        return "IMAD." + parts[1]
    return parts[0]


def histogram(sass):
    """{kernel: Counter of opcodes} from `cuobjdump -sass` text."""
    out = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)),
                                 collections.Counter())
            continue
        m = _INSTRUCTION.match(line)
        if m and cur is not None:
            cur[opcode(m.group(1))] += 1
    return out


def disassemble():
    """SASS text of csrc/filters.cu built for the port's target."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "filters.cubin")
        for cmd in ([nvcc, *flags, "-cubin", "-o", cubin, _build.SOURCE],
                    [cuobjdump, "-sass", cubin]):
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr}")
    return r.stdout


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=16,
                    help="opcodes to list per kernel")
    args = ap.parse_args(argv)
    for name, counts in histogram(disassemble()).items():
        print(f"{name}: {sum(counts.values())} instructions; "
              + ", ".join(f"{k} {n}" for k, n in counts.most_common(args.top)))


if __name__ == "__main__":
    main()
