"""The port's benchmark harness: general code that the data files drive.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
with its plain reference in ``reference/<name>.py``), a traffic mix
(``traffic/<name>.json``, whose ``kind`` picks one of the loops in
``loops/``) and the limits of its correctness check
(``limits/<cell>.json``).  Each per-layer metric is a reader of its own,
``metrics/<metric>.py``.  All of them are found by name, so a later cell,
mix, configuration or metric is a new file and a new entry.
"""
