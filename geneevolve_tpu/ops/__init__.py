"""Hand-written GPU kernel (Pallas, Triton backend) for the dense engine's
meiosis (`meiosis_triton.py`). Its plain XLA formulation in `dense/` stays
as its oracle and as the path every other backend and the `--mesh` runs
take."""
