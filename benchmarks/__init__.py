"""The PyTorch/CUDA port's benchmark: one cell a run, driven by the data
files beside this one (``python benchmarks/run.py --help``)."""
