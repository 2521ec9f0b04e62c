"""User-facing entrypoints: offline batch generation."""
