"""Hardware constants of the port's roofline accounting."""
