"""``repro_torch.benchmarks`` — the port's benchmark driver (counterpart of
the reference's top-level ``benchmarks`` package, which imports ``repro``):

- ``paper_figures`` — every DAMOV figure, Table 3 and the §5 case studies
  as queries over one shared :class:`repro_torch.study.Study`;
- ``kernel_bench`` — the port's STREAM and bf16 flash kernels timed on the
  card beside their library calls and the H100's roof;
- ``run`` — ``python -m repro_torch.benchmarks.run``, one CSV section each.
"""
