"""Serving-side utilities of the port (Prometheus metrics). The HTTP layer
has not been ported yet (ROADMAP.md, Queue 1)."""
