"""``repro_torch`` — the DAMOV reproduction ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package does the same
work for one NVIDIA H100 and imports nothing from it (nor jax).  Its
modules keep the reference's layout and names.  It holds the Table-3
roster (21 synthetic workloads drawn with numpy from the seed, and 24
captured ones from six kernel families: every Pallas kernel on that path
is a hand-written CUDA kernel under ``csrc/``, launched from a
:class:`~repro_torch.capture.launch.LaunchSpec` whose walked word trace is
byte-identical to the reference's), the Study layer over it, the result
store, and the serving scenarios.

Entry points run on the card (``device="cuda"``, the default) and raise
when there is none; ``device="cpu"`` runs the plain PyTorch versions.

    python -m repro_torch.suite --fast --check
"""
