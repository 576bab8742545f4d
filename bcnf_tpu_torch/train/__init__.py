"""Training-side modules of the port (only the data load path so far)."""
