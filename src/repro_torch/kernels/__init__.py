"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and the device-dispatching wrappers (``ops.py``)."""
