"""Host-side fault tolerance of the port (``fault_tolerance``)."""
