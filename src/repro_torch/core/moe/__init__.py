"""Port of ``repro.core.moe``."""
