"""The benchmark of zpix_tpu_torch: one loader cell a run, driven by the
data files beside this module (``python3 benchmark/run.py --help``)."""
