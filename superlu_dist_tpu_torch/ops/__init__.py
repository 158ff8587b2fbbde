"""Device operations: the level-batched schedule and factor sweep
(batched.py), the dense front operations (dense_lu.py), the packed
merged triangular solve (trisolve.py) and the three hand-written CUDA
kernels with their plain PyTorch versions (panel_lu.py, ea_scatter.py,
lsum.py)."""
