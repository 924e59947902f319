"""Tools that drive the port end to end (the synthetic accuracy gate)."""
