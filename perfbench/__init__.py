"""The benchmark of longcalld_torch: one command runs one cell once
(``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  BENCHMARK.json at the repository root lists the cells;
each names a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``) and the limits of its correctness check
(``cells/<name>.json``); each per-layer metric is a reader of its own
(``metrics/<name>.py``).  The generator, the reference and the roofline
arithmetic live here and import nothing of the program."""
