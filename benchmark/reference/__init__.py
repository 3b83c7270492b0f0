"""The plain fp32 PyTorch reference that decides ``correct``.

It imports nothing of ``prpe_tpu_torch`` (a test checks that) and takes
nothing the program made: the benchmark hands it the same seeded weights and
frames it hands the program, and it works out everything else again.
"""
