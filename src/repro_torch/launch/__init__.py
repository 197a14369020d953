"""Launch drivers (the port of ``repro.launch``): the single-card
training loop (``train``), the cells (``cells``), the meshes (``mesh``),
each cell's placed step (``specs``) and the 512-way dry run
(``dryrun``)."""
