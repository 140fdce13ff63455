"""Command-line front-ends of the PyTorch/CUDA port (``mref``, ``reffree``,
``check``), counterparts of ``cryo_ralib_tpu/cli``."""
