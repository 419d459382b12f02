"""Utilities of the port (ddnm_tpu/utils counterparts): observability."""
