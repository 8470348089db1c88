"""Port of ``repro.core``."""
