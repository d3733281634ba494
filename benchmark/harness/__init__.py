"""The benchmark's machinery: the cell's files (spec), the set-up and the
timed window (window), the traced window (tracing) and the comparison
with the plain reference (checks).  `benchmark/run.py` drives them."""
