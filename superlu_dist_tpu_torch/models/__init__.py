"""The expert driver (gssvx.py) and host iterative refinement
(refine.py)."""
