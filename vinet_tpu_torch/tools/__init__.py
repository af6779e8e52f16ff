"""Tools around the port: measurement of its kernels on a CUDA card
(``timing.py``, ``sweep_gemm.py``) and the released-weights runbook
(``validate_released.py``); nothing here runs on the model's path."""
