"""Observability helpers of cylon_tpu_torch (port of ``cylon_tpu/obs``):
so far the Misra-Gries sketch the skew split detects heavy keys with."""
