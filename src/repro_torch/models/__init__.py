"""The model stack of the port (so far: the dense decoder LM)."""
