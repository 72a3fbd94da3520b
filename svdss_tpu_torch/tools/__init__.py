"""The port's harness: the JAX repo's tools/ and bench.py on the card.

The scale tools drive one of the port's genome-scale paths each through
its own entry points and hold what the card gives against an exact host
engine:

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
    chr_scale    the JAX repo's tools/chr_scale.py: a simulated sample up
                 to genome scale through ``cli run`` (a child process),
                 scored against its planted SVs, optionally against the
                 host engines' outputs

The device tools measure the port's search on one card:

    bench        the JAX repo's bench.py: search reads/s of K3, K4 and K2
                 on its workload (100 Mbp, 4,096 x 10 kb reads), the 2 and
                 30 kb sweep, the parity check against the host engine
    profile      tools/profile_search.py and profile_anchor.py:
                 torch.profiler over one call of K2 (with K6), K3, K5, the
                 pool (K4) or the search stage; device time by kernel and
                 by launching op, busy share, the longest idle gaps
    gather_model tools/gather_model.py: ns a row of the card's gather over
                 the JAX grid and the port's table sizes
    lane_hist    tools/lane_hist.py: K3's per-lane finish rounds
    len_sweep    tools/len_sweep.py: K3 at 2, 10 and 30 kb over one upload
    step_cost    tools/step_cost.py: K2's marginal cost a step
    scaling_bench  tools/scaling_bench.py: the search stage in 1 and 2
                 processes (gloo), merged outputs identical
    genotype_eval  tools/genotype_eval.py: ``cli run``'s genotypes against
                 a planted diploid truth

Run each as ``python -m svdss_tpu_torch.tools.<name>``: on ``cuda`` unless
``--device cpu`` is given (the kernels' plain versions), raising without a
card otherwise. Genomes and reads come from the generators and seeds of
the JAX repo's tools (``tools/giant_wide.py``, ``tools/giant_validation.py``,
``tools/repeat_validation.py``), so a tool at a JAX tool's size describes
the same genome, and the device tools take bench.py's workload
(tools/bench.py ``make_genome``, ``make_reads``, ``build_anchor``, cached
under ``--workdir``, build/bench by default). The scale tools cache every
stage's artifact in ``--workdir`` under a scheme stamp
(``common.Workdir``), and rewrite the report after every stage, so a run
can span several jobs. The device tools print one JSON line last, with the
card's name and power limit (``common.card_info``); a CPU run writes "not
measured" for every device number (``common.device_number``).
"""
