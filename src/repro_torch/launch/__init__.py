"""Launch drivers (the port of ``repro.launch``): the single-card
training loop."""
