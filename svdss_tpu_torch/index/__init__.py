from .fmd import FMDIndex, BiInterval, build_index  # noqa: F401
