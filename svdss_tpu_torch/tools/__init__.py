"""The scale harness: the wide path at the size it exists for.

Each module drives one of the port's genome-scale paths through its own
entry points and holds what the card gives against an exact host engine:

    giant_wide   wide anchor tables over a GRCh38-scale forward text (16 x
                 194 Mbp) -> build_device_anchor_wide -> _DeviceSearcher
                 (kernel K5 in parked-phase waves), against the wide host
                 oracle
    giant_fm     a two-strand FMD index past 2^31 symbols (8 x 200 Mbp) ->
                 DeviceFMDIndex.from_host (wide by size) -> kernel K2's
                 wide instantiation, against the native host engine and
                 the scalar oracle
    repeat_wide  a 1.2 Gbp genome with planted repeat families -> the wide
                 engine in waves with the heavy-k-mer resolver, against the
                 wide host oracle

Run each as ``python -m svdss_tpu_torch.tools.<name>``: on ``cuda`` unless
``--device cpu`` is given (the kernels' plain versions), raising without a
card otherwise. Genomes and reads come from the generators and seeds of
the JAX repo's tools (``tools/giant_wide.py``, ``tools/giant_validation.py``,
``tools/repeat_validation.py``), so a tool at a JAX tool's size describes
the same genome. Every stage's artifact is cached in ``--workdir`` under a
scheme stamp (``common.Workdir``), and the report is rewritten after every
stage, so a run can span several jobs.
"""
