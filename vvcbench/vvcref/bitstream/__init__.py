# Frozen copy of ffvvc_tpu_torch/bitstream/__init__.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none.
from .reader import BitReader, BitReaderError  # noqa: F401
from .writer import BitWriter  # noqa: F401
from .nal import (  # noqa: F401
    NalType, NalUnit, split_annexb, parse_nal, write_nal,
    remove_epb, insert_epb, is_vcl, is_idr, is_irap, is_rap,
)
