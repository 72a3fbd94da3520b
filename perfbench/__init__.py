"""The benchmark of the search stage of svdss_tpu_torch (see README.md)."""
