"""The port's bench drivers: counterparts of the reference's bench.py
(engine.py, with scripts/roofline.py's ``pipe`` row as ``--wire delta``),
scripts/bench_e2e.py (e2e.py), scripts/bench_scaling.py (scaling.py) and
scripts/bench_config5.py (config5.py), with their shared pieces in
common.py. Each runs as ``python3 -m nucleoatac_torch.bench.<module>``, on
the card unless ``--device cpu`` is given, and prints JSON lines."""
