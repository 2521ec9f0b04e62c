"""Utilities: request tracing (copy of atoma_infer_tpu/utils/tracing.py)."""
