from .reader import BitReader, BitReaderError  # noqa: F401
from .writer import BitWriter  # noqa: F401
from .nal import (  # noqa: F401
    NalType, NalUnit, split_annexb, parse_nal, write_nal,
    remove_epb, insert_epb, is_vcl, is_idr, is_irap, is_rap,
)
