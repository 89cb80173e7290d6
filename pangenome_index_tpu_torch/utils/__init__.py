"""Host utilities of the port: the alphabet and the synthetic pangenome."""

from .alphabet import (
    BYTE_TO_CODE,
    CODE_TO_BYTE,
    COMP_CODE,
    NENDMARKER,
    NUC,
    SIGMA,
    decode_codes,
    encode_bytes,
)
