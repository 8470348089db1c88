"""Port of ``repro.core.quant``."""
