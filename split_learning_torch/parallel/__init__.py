"""Stage geometry and the single-device split pipeline."""
