"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 lamina_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to a configuration, a traffic mix, a
cell or a per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json`` — the published configuration under the
  source's own keys, the keys the port's ``ModelConfig`` shape reads
  from them (``port_fields``), the values the port runs where it departs
  from the source (``as_run``, each named in ``departures``), and what
  was assumed;
* ``traffic/<traffic>.json`` — the parameters of one closed-loop mix,
  read by the one generator in :mod:`lamina_bench.traffic`;
* ``cells/<workload>.json`` — the engine settings of one cell and the
  limits its correctness check holds the served tokens to;
* ``metrics/<metric>.py`` — a reader ``read(window)`` that returns the
  metric's value, or ``None`` where the run has nothing for it to read.
  A metric named ``<base>.<split>`` (one quantity reported under a name
  of its own by some cells) is read by ``metrics/<base>.py`` unless it
  has a reader of its own.

The plain reference (``reference/``) imports nothing of the program.
"""
