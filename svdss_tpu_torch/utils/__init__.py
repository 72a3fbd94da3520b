from .seq import (  # noqa: F401
    NT6_TABLE,
    NT16_STR,
    comp6,
    encode_nt6,
    decode_nt6,
    revcomp_str,
    revcomp_nt6,
    percentile,
)
